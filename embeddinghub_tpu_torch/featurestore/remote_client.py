"""Hosted-mode serving client (gRPC).

Rebuild of the reference client's hosted path
(``client/src/featureform/serving.py:200`` HostedClientImpl +
``client.py:331`` nearest): the same ``features`` / ``training_set`` /
``nearest`` surface as the in-process :class:`ServingClient`, but over
the Feature serving gRPC wire — works against this package's
``serving_grpc`` server or a reference serving endpoint.
"""

from __future__ import annotations

import grpc

from embeddinghub_tpu_torch.featurestore.proto import serving_pb2 as pb
from embeddinghub_tpu_torch.featurestore.proto import serving_pb2_grpc as pb_grpc
from embeddinghub_tpu_torch.featurestore.serving import Dataset
from embeddinghub_tpu_torch.featurestore.serving_grpc import from_value


def _split(ref) -> tuple[str, str]:
    if isinstance(ref, tuple):
        return ref
    if ":" in ref:
        name, variant = ref.split(":", 1)
        return name, variant
    return ref, "default"


class RemoteServingClient:
    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 8081,
        channel=None,
        insecure: bool = True,
        cert_path: str | None = None,
    ):
        from embeddinghub_tpu_torch.utils.channels import make_channel

        self._channel = channel or make_channel(
            host, port, insecure=insecure, cert_path=cert_path
        )
        self._stub = pb_grpc.FeatureStub(self._channel)

    def close(self):
        self._channel.close()

    def features(self, features, entities: dict, model: str | None = None):
        req = pb.FeatureServeRequest()
        for ref in features:
            name, variant = _split(ref)
            f = req.features.add()
            f.name, f.version = name, variant
        for ename, eval_ in entities.items():
            e = req.entities.add()
            e.name = ename
            e.values.append(str(eval_))
        if model:
            req.model.name = model
        row = self._stub.FeatureServe(req)
        return [
            from_value(vl.values[0]) if vl.values else None
            for vl in row.value_lists
        ]

    def nearest(self, name: str, variant: str, vector, k: int) -> list[str]:
        req = pb.NearestRequest()
        req.id.name, req.id.version = name, variant
        req.vector.value[:] = [float(v) for v in vector]
        req.k = k
        return list(self._stub.Nearest(req).entities)

    def training_set(self, name: str, variant: str = "default") -> Dataset:
        req = pb.TrainingDataRequest()
        req.id.name, req.id.version = name, variant
        rows = []
        for batch in self._stub.TrainingData(req):
            for r in batch.rows:
                rows.append(
                    ([from_value(v) for v in r.features], from_value(r.label))
                )
        return Dataset(rows)

    def source_data(self, name: str, variant: str = "default", limit: int = 0):
        req = pb.SourceDataRequest()
        req.id.name, req.id.version = name, variant
        req.limit = limit
        out = []
        for batch in self._stub.SourceData(req):
            for r in batch.rows:
                out.append([from_value(v) for v in r.rows])
        return out

    def train_test_split(
        self,
        name: str,
        variant: str = "default",
        test_size: float = 0.2,
        shuffle: bool = True,
        random_state: int = 0,
        batch_size: int = 256,
    ) -> tuple[list, list]:
        """Pull both splits through the bidi protocol; returns
        (train_rows, test_rows) of (features, label) tuples."""
        import queue as _q

        sendq: _q.Queue = _q.Queue()

        def req_iter():
            while True:
                item = sendq.get()
                if item is None:
                    return
                yield item

        init = pb.TrainTestSplitRequest()
        init.id.name, init.id.version = name, variant
        init.request_type = pb.RequestType.INITIALIZE
        init.test_size = test_size
        init.shuffle = shuffle
        init.random_state = random_state
        sendq.put(init)
        resp_iter = self._stub.TrainTestSplit(req_iter())
        first = next(resp_iter)
        assert first.initialized

        def drain(which) -> list:
            rows = []
            while True:
                req = pb.TrainTestSplitRequest()
                req.id.name = name
                req.request_type = which
                req.batch_size = batch_size
                sendq.put(req)
                resp = next(resp_iter)
                for r in resp.data.rows:
                    rows.append(
                        ([from_value(v) for v in r.features], from_value(r.label))
                    )
                if resp.iterator_done:
                    return rows

        train = drain(pb.RequestType.TRAINING)
        test = drain(pb.RequestType.TEST)
        sendq.put(None)
        return train, test
