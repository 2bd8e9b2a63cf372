"""Feature serving gRPC server.

Wire-compatible rebuild of the reference ``FeatureServer``
(``serving/serving.go:45``): FeatureServe / BatchFeatureServe /
TrainingData (server-stream) / TrainTestSplit (bidi) / SourceData /
Nearest over the in-process serving layer + TPU vector engine.

Run:  python -m embeddinghub_tpu_torch.featurestore.serving_grpc [host:port]
(reference SERVING_PORT default 8081, main.go env wiring).
"""

from __future__ import annotations

import random
import sys
import time
from concurrent import futures as cf

import grpc

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.metrics import METRICS
from embeddinghub_tpu_torch.featurestore.proto import serving_pb2 as pb
from embeddinghub_tpu_torch.featurestore.proto import serving_pb2_grpc as pb_grpc
from embeddinghub_tpu_torch.featurestore.serving import ServingClient

_CODE = {
    "NOT_FOUND": grpc.StatusCode.NOT_FOUND,
    "ALREADY_EXISTS": grpc.StatusCode.ALREADY_EXISTS,
    "FAILED_PRECONDITION": grpc.StatusCode.FAILED_PRECONDITION,
    "INVALID_ARGUMENT": grpc.StatusCode.INVALID_ARGUMENT,
    "ABORTED": grpc.StatusCode.ABORTED,
    "INTERNAL": grpc.StatusCode.INTERNAL,
}


def to_value(v) -> pb.Value:
    out = pb.Value()
    if isinstance(v, bool):
        out.bool_value = v
    elif isinstance(v, int):
        out.int64_value = v
    elif isinstance(v, float):
        out.double_value = v
    elif isinstance(v, (list, tuple)):
        out.vector32_value.value[:] = [float(x) for x in v]
    elif v is None:
        out.str_value = ""
    else:
        out.str_value = str(v)
    return out


def from_value(v: pb.Value):
    field = v.WhichOneof("value")
    if field is None:
        return None
    if field == "vector32_value":
        return list(v.vector32_value.value)
    return getattr(v, field)


class FeatureService(pb_grpc.FeatureServicer):
    def __init__(self, serving: ServingClient):
        self._serving = serving

    def _abort(self, context, e: fferr.FFError):
        context.abort(_CODE.get(e.code, grpc.StatusCode.INTERNAL), str(e))

    # ------------------------------------------------------------ online

    def FeatureServe(self, request, context):
        start = time.perf_counter()
        features = [(f.name, f.version or "default") for f in request.features]
        entities = {}
        for e in request.entities:
            vals = list(e.values) or ([e.value] if e.value else [])
            entities[e.name] = vals[0] if vals else ""
        try:
            values = self._serving.features(
                features, entities, model=request.model.name or None
            )
        except fferr.FFError as e:
            for f, v in features:
                METRICS.feature_error(f, v)
            self._abort(context, e)
        row = pb.FeatureRow()
        for (f, v), val in zip(features, values):
            vl = row.value_lists.add()
            vl.values.append(to_value(val))
            row.values.append(to_value(val))
            METRICS.feature_served(f, v, time.perf_counter() - start)
        return row

    def BatchFeatureServe(self, request, context):
        features = [(f.name, f.version or "default") for f in request.features]
        try:
            entity_sets = self._serving.batch_feature_entities(features)
        except fferr.FFError as e:
            self._abort(context, e)
        batch = pb.BatchFeatureRows()
        for entity, vals in entity_sets:
            r = batch.rows.add()
            r.entity.CopyFrom(to_value(entity))
            r.features.extend([to_value(v) for v in vals])
            if len(batch.rows) >= 256:
                yield batch
                batch = pb.BatchFeatureRows()
        if batch.rows:
            yield batch

    def Nearest(self, request, context):
        try:
            entities = self._serving.nearest(
                request.id.name,
                request.id.version or "default",
                list(request.vector.value),
                request.k,
            )
        except fferr.FFError as e:
            self._abort(context, e)
        return pb.NearestResponse(entities=entities)

    # ----------------------------------------------------------- offline

    def TrainingData(self, request, context):
        try:
            ds = self._serving.training_set(
                request.id.name,
                request.id.version or "default",
                model=request.model.name or None,
            )
        except fferr.FFError as e:
            self._abort(context, e)
        batch = pb.TrainingDataRows()
        n = 0
        for row in ds:
            r = batch.rows.add()
            r.features.extend([to_value(f) for f in row.features()])
            r.label.CopyFrom(to_value(row.label()))
            n += 1
            if len(batch.rows) >= 512:
                yield batch
                batch = pb.TrainingDataRows()
        if batch.rows:
            yield batch
        METRICS.training_rows(request.id.name, request.id.version, n)

    def TrainTestSplit(self, request_iterator, context):
        """Bidi split protocol (serving.go:125): INITIALIZE once, then
        TRAINING/TEST requests pull batches from each split.  A repeated
        INITIALIZE swaps in fresh iterators (positions reset — the
        reference replaces its provider iterators,
        handleSplitInitializeRequest serving.go:182); once both splits
        report exhausted the stream closes (serving.go:133-137)."""
        train, test = None, None
        train_pos, test_pos = 0, 0
        train_done, test_done = False, False
        for req in request_iterator:
            if req.request_type == pb.RequestType.INITIALIZE:
                train_pos, test_pos = 0, 0
                train_done, test_done = False, False
                try:
                    ds = self._serving.training_set(
                        req.id.name, req.id.version or "default"
                    )
                except fferr.FFError as e:
                    self._abort(context, e)
                rows = [(r.features(), r.label()) for r in ds]
                if req.shuffle:
                    random.Random(req.random_state or 0).shuffle(rows)
                n_total = len(rows)
                if req.test_size:
                    test_n = int(round(n_total * req.test_size))
                elif req.train_size:
                    test_n = n_total - int(round(n_total * req.train_size))
                else:
                    test_n = int(round(n_total * 0.2))
                train_n = (
                    int(round(n_total * req.train_size))
                    if req.train_size
                    else n_total - test_n
                )
                test = rows[:test_n]
                train = rows[test_n : test_n + train_n]
                resp = pb.BatchTrainTestSplitResponse(
                    request_type=pb.RequestType.INITIALIZE, initialized=True
                )
                yield resp
                continue
            want_train = req.request_type == pb.RequestType.TRAINING
            rows = train if want_train else test
            pos = train_pos if want_train else test_pos
            size = req.batch_size or 256
            chunk = rows[pos : pos + size] if rows else []
            resp = pb.BatchTrainTestSplitResponse(request_type=req.request_type)
            data = pb.TrainingDataRows()
            for feats, label in chunk:
                r = data.rows.add()
                r.features.extend([to_value(f) for f in feats])
                r.label.CopyFrom(to_value(label))
            resp.data.CopyFrom(data)
            new_pos = pos + len(chunk)
            resp.iterator_done = new_pos >= len(rows or [])
            if want_train:
                train_pos = new_pos
                train_done = resp.iterator_done
            else:
                test_pos = new_pos
                test_done = resp.iterator_done
            yield resp
            if train_done and test_done:
                return

    def TrainingDataColumns(self, request, context):
        from embeddinghub_tpu_torch.featurestore.resources import (
            ResourceID,
            ResourceType,
        )

        try:
            ts = self._serving.metadata.get(
                ResourceID(
                    ResourceType.TRAINING_SET_VARIANT,
                    request.id.name,
                    request.id.version or "default",
                )
            )
        except fferr.FFError as e:
            self._abort(context, e)
        resp = pb.TrainingColumns()
        resp.features.extend([f"{n}.{v}" for n, v in ts.features])
        resp.label = f"{ts.label[0]}.{ts.label[1]}"
        return resp

    def SourceColumns(self, request, context):
        from embeddinghub_tpu_torch.featurestore.resources import (
            ResourceID,
            ResourceType,
        )

        try:
            src = self._serving.metadata.get(
                ResourceID(
                    ResourceType.SOURCE_VARIANT,
                    request.id.name,
                    request.id.version or "default",
                )
            )
            offline = self._serving._provider(src.provider).as_offline_store()
            rows = offline.table_rows(src.name, src.variant)
        except fferr.FFError as e:
            self._abort(context, e)
        resp = pb.SourceDataColumns()
        resp.columns.extend(list(rows[0].keys()) if rows else [])
        return resp

    def GetResourceLocation(self, request, context):
        from embeddinghub_tpu_torch.featurestore.resources import (
            ResourceID,
            ResourceType,
        )

        try:
            src = self._serving.metadata.get(
                ResourceID(
                    ResourceType.SOURCE_VARIANT,
                    request.name,
                    request.variant or "default",
                )
            )
        except fferr.FFError as e:
            self._abort(context, e)
        return pb.ResourceLocation(
            location=f"sqlite://src__{src.name}__{src.variant}"
        )

    def SourceData(self, request, context):
        from embeddinghub_tpu_torch.featurestore.resources import (
            ResourceID,
            ResourceType,
        )

        try:
            src = self._serving.metadata.get(
                ResourceID(
                    ResourceType.SOURCE_VARIANT,
                    request.id.name,
                    request.id.version or "default",
                )
            )
            offline = self._serving._provider(src.provider).as_offline_store()
            rows = offline.table_rows(src.name, src.variant)
        except fferr.FFError as e:
            self._abort(context, e)
        limit = request.limit or len(rows)
        batch = pb.SourceDataRows()
        for row in rows[:limit]:
            r = batch.rows.add()
            r.rows.extend([to_value(v) for v in row.values()])
            if len(batch.rows) >= 512:
                yield batch
                batch = pb.SourceDataRows()
        if batch.rows:
            yield batch


def build_server(address: str, serving: ServingClient) -> grpc.Server:
    from embeddinghub_tpu_torch.featurestore.interceptors import make_server

    server = make_server(cf.ThreadPoolExecutor(max_workers=32))
    pb_grpc.add_FeatureServicer_to_server(FeatureService(serving), server)
    from embeddinghub_tpu_torch.utils.channels import add_server_port

    add_server_port(server, address)
    return server


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    address = argv[0] if argv else "0.0.0.0:8081"
    defs = argv[1] if len(argv) > 1 else None
    import embeddinghub_tpu_torch.featurestore as ff

    client = ff.Client()
    if defs:
        import runpy

        runpy.run_path(defs)  # definitions file registers resources
        client.apply()
    server = build_server(address, client)
    server.start()
    print(f"Serving listening on {address}", flush=True)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
