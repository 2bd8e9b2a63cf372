"""The port's feature-store wire against the JAX package's, in process.

Both packages apply the definitions of ``test_torch_featurestore.py`` to
the same seeded 4,096 x 32 rows (the JAX engine on CPU JAX, the port's with
``device="cpu"``) and serve them through their own ``serving_grpc`` and
``metadata_grpc`` servers on free ports.  The same requests go to both:
the serving RPCs, the compact ``Metadata`` service, the ff_metadata
``Metadata`` and ``Api`` services and the ``Tasks`` service.  Responses
must be equal protobufs once the wall-clock times are cleared (the two
applies ran at different times: timestamps, and the clock that prefixes
each task-run log line) and the engine vector store's ``device`` is taken
from its provider config (the port's registrar records it; the JAX
package's has none); ``Nearest`` keys may differ only at near ties; error
cases must give the same status codes.  (Log lines also lose the random
id of a transformation job.)  Then each
package's remote clients talk to the other's servers, and both dashboards
serve one metadata DB that the JAX package wrote.
"""

import json
import re
import urllib.request

import grpc
import numpy as np
import pytest

import embeddinghub_tpu.featurestore as ff_jax
import embeddinghub_tpu_torch.featurestore as ff_port
from embeddinghub_tpu.featurestore import dashboard as jax_dashboard
from embeddinghub_tpu.featurestore import metadata_grpc as jax_metadata_grpc
from embeddinghub_tpu.featurestore import remote_client as jax_remote
from embeddinghub_tpu.featurestore import serving_grpc as jax_serving_grpc
from embeddinghub_tpu.featurestore.providers.base import (
    reset_provider_cache as reset_jax_providers,
)
from embeddinghub_tpu_torch.featurestore import dashboard as port_dashboard
from embeddinghub_tpu_torch.featurestore import metadata_grpc as port_metadata_grpc
from embeddinghub_tpu_torch.featurestore import remote_client as port_remote
from embeddinghub_tpu_torch.featurestore import serving_grpc as port_serving_grpc
from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_grpc as mgrpc
from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_pb2 as mpb
from embeddinghub_tpu_torch.featurestore.proto import ff_scheduling_grpc as sgrpc
from embeddinghub_tpu_torch.featurestore.proto import ff_scheduling_pb2 as spb
from embeddinghub_tpu_torch.featurestore.proto import metadata_pb2 as cpb
from embeddinghub_tpu_torch.featurestore.proto import metadata_pb2_grpc as cgrpc
from embeddinghub_tpu_torch.featurestore.proto import serving_pb2 as pb
from embeddinghub_tpu_torch.featurestore.proto import serving_pb2_grpc as pb_grpc
from embeddinghub_tpu_torch.featurestore.providers.base import (
    reset_provider_cache as reset_port_providers,
)
from embeddinghub_tpu_torch.featurestore.resources import ResourceType
from embeddinghub_tpu_torch.service.spawn import free_ports

from _torch_parity import assert_ids_equal_off_ties
from test_torch_featurestore import D, _apply, _data


def _serve(serving_mod, metadata_mod, client):
    """Start a package's serving and metadata servers on free ports."""
    sp, mp = free_ports(2)
    serving = serving_mod.build_server(f"127.0.0.1:{sp}", client)
    metadata = metadata_mod.build_server(
        f"127.0.0.1:{mp}", client.metadata, client.coordinator, serving=client)
    serving.start()
    metadata.start()
    return (serving, metadata), sp, mp


class _Side:
    """One package's servers, and stubs on channels to them."""

    def __init__(self, client, servers, sp, mp):
        self.client, self.servers, self.sp, self.mp = client, servers, sp, mp
        self.channels = [grpc.insecure_channel(f"127.0.0.1:{p}") for p in (sp, mp)]
        self.serving = pb_grpc.FeatureStub(self.channels[0])
        self.compact = cgrpc.MetadataStub(self.channels[1])
        self.metadata = mgrpc.MetadataStub(self.channels[1])
        self.api = mgrpc.ApiStub(self.channels[1])
        self.tasks = sgrpc.TasksStub(self.channels[1])

    def close(self):
        for c in self.channels:
            c.close()
        for s in self.servers:
            s.stop(0)


@pytest.fixture(scope="module")
def sides():
    x, rows, queries = _data()
    jax_client = _apply(ff_jax, reset_jax_providers, rows)
    port_client = _apply(ff_port, reset_port_providers, rows, device="cpu")
    j = _Side(jax_client, *_serve(jax_serving_grpc, jax_metadata_grpc, jax_client))
    p = _Side(port_client, *_serve(port_serving_grpc, port_metadata_grpc, port_client))
    yield x, queries, j, p
    j.close()
    p.close()
    reset_jax_providers()
    reset_port_providers()


_LOG_CLOCK = re.compile(r"^\[\d\d:\d\d:\d\d\] ")
_JOB_ID = re.compile(r"\bjob [0-9a-f]{12}\b")  # a random uuid4 prefix


def _config_without_device(raw):
    config = json.loads(raw)
    config.pop("device", None)
    return json.dumps(config, sort_keys=True).encode()


def _clear_times(msg):
    """``msg`` with every ``google.protobuf.Timestamp`` in it cleared and
    the clock taken from its log lines, at any depth (wall-clock times of
    the two applies differ), as the random id of a transformation job; a
    provider's config loses its ``device``."""
    for field, value in list(msg.ListFields()):
        if field.name == "logs":
            value[:] = [_JOB_ID.sub("job <id>", _LOG_CLOCK.sub("", line))
                        for line in value]
        if field.name == "serialized_config" and value:
            msg.serialized_config = _config_without_device(value)
        if field.message_type is None:
            continue
        items = [value] if hasattr(value, "ListFields") else value
        if field.message_type.full_name == "google.protobuf.Timestamp":
            msg.ClearField(field.name)
            continue
        for item in items:
            if hasattr(item, "ListFields"):
                _clear_times(item)
    return msg


def _both(j, p, call):
    """``call(side)`` on both sides: the responses (a list for a stream),
    timestamps cleared, or the status code of the error."""
    out = []
    for side in (j, p):
        try:
            got = call(side)
            if not hasattr(got, "ListFields"):
                got = list(got)
                got = [_clear_times(m) for m in got]
            else:
                got = _clear_times(got)
        except grpc.RpcError as e:
            got = e.code()
        out.append(got)
    return out


def _feature_req(names, entity):
    req = pb.FeatureServeRequest()
    for n in names:
        f = req.features.add()
        f.name, f.version = n, "default"
    e = req.entities.add()
    e.name, e.value = "item", entity
    return req


def _nv(name, variant="default"):
    return mpb.NameVariant(name=name, variant=variant)


SERVING_CALLS = {
    "FeatureServe": lambda s: s.serving.FeatureServe(
        _feature_req(["score", "rank"], "i3")),
    "FeatureServe emb": lambda s: s.serving.FeatureServe(_feature_req(["emb"], "i7")),
    "FeatureServe clicked row": lambda s: s.serving.FeatureServe(
        _feature_req(["score", "score2", "rank"], "i0")),
    "BatchFeatureServe": lambda s: s.serving.BatchFeatureServe(pb.BatchFeatureServeRequest(
        features=[pb.FeatureID(name="score", version="default")])),
    "TrainingData": lambda s: s.serving.TrainingData(pb.TrainingDataRequest(
        id=pb.TrainingDataID(name="clicks", version="default"))),
    "TrainingDataColumns": lambda s: s.serving.TrainingDataColumns(
        pb.TrainingDataColumnsRequest(id=pb.TrainingDataID(name="clicks", version="default"))),
    "SourceColumns": lambda s: s.serving.SourceColumns(pb.SourceColumnRequest(
        id=pb.SourceID(name="ranked", version="default"))),
    "SourceData": lambda s: s.serving.SourceData(pb.SourceDataRequest(
        id=pb.SourceID(name="items", version="default"), limit=700)),
    "SourceData sql": lambda s: s.serving.SourceData(pb.SourceDataRequest(
        id=pb.SourceID(name="scaled", version="default"))),
    "GetResourceLocation": lambda s: s.serving.GetResourceLocation(
        pb.ResourceIdRequest(name="items", variant="default")),
    # errors: an unknown feature, a missing entity, a vector of the wrong
    # dims, an unknown training set and source
    "unknown feature": lambda s: s.serving.FeatureServe(_feature_req(["nope"], "i3")),
    "missing entity": lambda s: s.serving.FeatureServe(_feature_req(["score"], "zzz")),
    "score2 of an unclicked row": lambda s: s.serving.FeatureServe(
        _feature_req(["score2"], "i1")),
    "wrong dims": lambda s: s.serving.Nearest(pb.NearestRequest(
        id=pb.FeatureID(name="emb", version="default"),
        vector=pb.Vector32(value=[0.5] * (D - 3)), k=5)),
    "nearest of an unknown feature": lambda s: s.serving.Nearest(pb.NearestRequest(
        id=pb.FeatureID(name="nope", version="default"),
        vector=pb.Vector32(value=[0.5] * D), k=5)),
    "unknown training set": lambda s: s.serving.TrainingData(pb.TrainingDataRequest(
        id=pb.TrainingDataID(name="nope", version="default"))),
    "unknown source": lambda s: s.serving.SourceData(pb.SourceDataRequest(
        id=pb.SourceID(name="nope", version="default"))),
}


@pytest.mark.parametrize("name", SERVING_CALLS)
def test_serving_responses_equal(sides, name):
    _, _, j, p = sides
    want, got = _both(j, p, SERVING_CALLS[name])
    assert got == want
    if name[0].isupper():
        assert not isinstance(want, grpc.StatusCode), want
    else:
        assert isinstance(want, grpc.StatusCode), want


def test_train_test_split_equal(sides):
    """The bidi split: INITIALIZE, then every batch of both splits."""
    _, _, j, p = sides

    def split(side):
        reqs = [pb.TrainTestSplitRequest(
            id=pb.TrainingDataID(name="clicks", version="default"),
            request_type=pb.RequestType.INITIALIZE, test_size=0.25, shuffle=True,
            random_state=7)]
        for which in (pb.RequestType.TRAINING, pb.RequestType.TEST):
            reqs += [pb.TrainTestSplitRequest(
                id=pb.TrainingDataID(name="clicks"), request_type=which,
                batch_size=1024) for _ in range(4)]
        return side.serving.TrainTestSplit(iter(reqs))

    want, got = _both(j, p, split)
    assert got == want
    assert sum(len(r.data.rows) for r in want) == 4096


def test_nearest_keys_equal_off_ties(sides):
    x, queries, j, p = sides
    k = 10

    def keys(side):
        return np.array([[int(e[1:]) for e in side.serving.Nearest(pb.NearestRequest(
            id=pb.FeatureID(name="emb", version="default"),
            vector=pb.Vector32(value=q.tolist()), k=k)).entities] for q in queries])

    want, got = keys(j), keys(p)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    want_d = 1.0 - np.einsum("bkd,bd->bk", xn[want].astype(np.float64), qn)
    assert_ids_equal_off_ties(got, want, want_d, 1e-5)


def _compact_blob(blob):
    """A compact-service blob with its JSON payload's timestamps and a
    provider config's ``device`` dropped."""
    data = json.loads(blob.payload)
    data["data"].pop("created_at", None)
    data["data"].pop("updated_at", None)
    if isinstance(data["data"].get("config"), dict):
        data["data"]["config"].pop("device", None)
    out = cpb.ResourceBlob()
    out.CopyFrom(blob)
    out.payload = json.dumps(data, sort_keys=True).encode()
    return out


_TYPES = [t.value for t in ResourceType]


@pytest.mark.parametrize("rtype", _TYPES)
def test_compact_list_resources_equal(sides, rtype):
    _, _, j, p = sides
    want, got = _both(j, p, lambda s: s.compact.ListResources(cpb.TypeRef(type=rtype)))
    if isinstance(want, grpc.StatusCode):
        assert got == want
        return
    key = lambda b: (b.name, b.variant)  # noqa: E731 — a dict of the store: no order
    assert sorted(map(_compact_blob, got), key=key) == sorted(
        map(_compact_blob, want), key=key)


COMPACT_CALLS = {
    "GetResource": lambda s: s.compact.GetResource(cpb.ResourceRef(
        type=ResourceType.FEATURE_VARIANT.value, name="score", variant="default")),
    "GetResource training set": lambda s: s.compact.GetResource(cpb.ResourceRef(
        type=ResourceType.TRAINING_SET_VARIANT.value, name="clicks", variant="default")),
    "Search": lambda s: s.compact.Search(cpb.SearchQuery(q="score", limit=10)),
    "Search item": lambda s: s.compact.Search(cpb.SearchQuery(q="item")),
    "RunTasks": lambda s: s.compact.RunTasks(cpb.Empty()),
    "unknown resource": lambda s: s.compact.GetResource(cpb.ResourceRef(
        type=ResourceType.FEATURE_VARIANT.value, name="nope", variant="default")),
    "bad type": lambda s: s.compact.ListResources(cpb.TypeRef(type="NOPE")),
}


@pytest.mark.parametrize("name", COMPACT_CALLS)
def test_compact_metadata_equal(sides, name):
    _, _, j, p = sides
    want, got = _both(j, p, COMPACT_CALLS[name])
    if name.startswith("GetResource"):
        want, got = _compact_blob(want), _compact_blob(got)
    assert got == want
    assert isinstance(want, grpc.StatusCode) == name[0].islower(), want


def _stream(method, *reqs):
    return method(iter(reqs))


# the typed ff_metadata services: the same calls to Metadata and to Api
WIRE_CALLS = {
    "ListFeatures": lambda st: st.ListFeatures(mpb.ListRequest()),
    "ListLabels": lambda st: st.ListLabels(mpb.ListRequest()),
    "ListSources": lambda st: st.ListSources(mpb.ListRequest()),
    "ListTrainingSets": lambda st: st.ListTrainingSets(mpb.ListRequest()),
    "ListUsers": lambda st: st.ListUsers(mpb.ListRequest()),
    "ListProviders": lambda st: st.ListProviders(mpb.ListRequest()),
    "ListEntities": lambda st: st.ListEntities(mpb.ListRequest()),
    "ListModels": lambda st: st.ListModels(mpb.ListRequest()),
    "GetFeatureVariants": lambda st: _stream(
        st.GetFeatureVariants, mpb.NameVariantRequest(name_variant=_nv("emb")),
        mpb.NameVariantRequest(name_variant=_nv("score2"))),
    "GetSourceVariants": lambda st: _stream(
        st.GetSourceVariants, mpb.NameVariantRequest(name_variant=_nv("ranked")),
        mpb.NameVariantRequest(name_variant=_nv("scaled"))),
    "GetLabelVariants": lambda st: _stream(
        st.GetLabelVariants, mpb.NameVariantRequest(name_variant=_nv("clicked"))),
    "GetTrainingSetVariants": lambda st: _stream(
        st.GetTrainingSetVariants, mpb.NameVariantRequest(name_variant=_nv("clicks"))),
    "GetFeatures": lambda st: _stream(
        st.GetFeatures, mpb.NameRequest(name=mpb.Name(name="rank"))),
    "GetEntities": lambda st: _stream(
        st.GetEntities, mpb.NameRequest(name=mpb.Name(name="item"))),
    "GetUsers": lambda st: _stream(st.GetUsers, mpb.NameRequest(name=mpb.Name(name="ana"))),
    "GetProviders": lambda st: _stream(
        st.GetProviders, mpb.NameRequest(name=mpb.Name(name="vectors"))),
    "unknown feature variant": lambda st: _stream(
        st.GetFeatureVariants, mpb.NameVariantRequest(name_variant=_nv("nope"))),
}


@pytest.mark.parametrize("service", ["metadata", "api"])
@pytest.mark.parametrize("name", WIRE_CALLS)
def test_typed_metadata_equal(sides, service, name):
    _, _, j, p = sides
    want, got = _both(j, p, lambda s: WIRE_CALLS[name](getattr(s, service)))
    if name.startswith("List") and not isinstance(want, grpc.StatusCode):
        # a listing of the store's dict: no order
        want = sorted(want, key=lambda m: m.SerializeToString(deterministic=True))
        got = sorted(got, key=lambda m: m.SerializeToString(deterministic=True))
    assert got == want
    assert isinstance(want, grpc.StatusCode) == name[0].islower(), want


def test_typed_writes_equal(sides):
    """The same creates through both typed services, read back alike."""
    _, _, j, p = sides

    def create(side):
        side.metadata.CreateUser(mpb.UserRequest(user=mpb.User(name="wire-user")))
        side.api.CreateEntity(mpb.EntityRequest(entity=mpb.Entity(
            name="wire-entity", description="made over the wire")))
        return [*_stream(side.metadata.GetUsers,
                         mpb.NameRequest(name=mpb.Name(name="wire-user"))),
                *_stream(side.api.GetEntities,
                         mpb.NameRequest(name=mpb.Name(name="wire-entity")))]

    want, got = _both(j, p, create)
    assert got == want and len(want) == 2
    again = _both(j, p, lambda s: s.metadata.CreateUser(
        mpb.UserRequest(user=mpb.User(name="wire-user"))))
    assert again[0] == again[1]


def _task_ids(side):
    return sorted({r.task_id for r in side.client.coordinator.tasks.all_runs()})


def test_tasks_wire_equal(sides):
    _, _, j, p = sides
    ids = _task_ids(j)
    assert ids == _task_ids(p) and ids

    def runs(side):
        out = list(side.tasks.GetAllRuns(spb.Empty()))
        for i in ids:
            out.append(side.tasks.GetTaskByID(spb.TaskID(id=str(i))))
            out += list(side.tasks.GetRuns(spb.TaskID(id=str(i))))
            out.append(side.tasks.GetLatestRun(spb.TaskID(id=str(i))))
        out += list(side.tasks.GetUnfinishedRuns(spb.Empty()))
        return out

    want, got = _both(j, p, runs)
    assert got == want
    for call in (lambda s: s.tasks.GetTaskByID(spb.TaskID(id="99999")),
                 lambda s: s.tasks.GetRunMetadata(spb.TaskRunID(
                     runID=spb.RunID(id="99999"), taskID=spb.TaskID(id="1")))):
        want, got = _both(j, p, call)
        assert got == want == grpc.StatusCode.NOT_FOUND


def test_jax_clients_against_port_servers(sides):
    """The JAX package's remote clients get from the port's servers what
    they get from the JAX package's own."""
    _, queries, j, p = sides
    answers = []
    for side in (j, p):
        rc = jax_remote.RemoteServingClient(host="127.0.0.1", port=side.sp)
        mc = jax_metadata_grpc.RemoteMetadataClient(host="127.0.0.1", port=side.mp)
        try:
            answers.append(_remote_answers(rc, mc, queries))
        finally:
            rc.close()
            mc.close()
    assert answers[1] == answers[0]


def test_port_clients_against_jax_servers(sides):
    """The port's remote clients get from the JAX package's servers what
    they get from the port's own."""
    _, queries, j, p = sides
    answers = []
    for side in (p, j):
        rc = port_remote.RemoteServingClient(host="127.0.0.1", port=side.sp)
        mc = port_metadata_grpc.RemoteMetadataClient(host="127.0.0.1", port=side.mp)
        try:
            answers.append(_remote_answers(rc, mc, queries))
        finally:
            rc.close()
            mc.close()
    assert answers[1] == answers[0]


def _remote_answers(rc, mc, queries):
    """What a remote serving and metadata client read: features, nearest
    keys of fresh queries (no near ties), a training set, a split, source
    rows; resources by type, one by name, a search and a task summary."""
    from embeddinghub_tpu_torch.featurestore.resources import ResourceType as RT

    def plain(res):
        return (type(res).__name__, res.name, getattr(res, "variant", ""),
                res.status.value)

    return {
        "features": [rc.features(["score", "rank"], {"item": f"i{i}"}) for i in (0, 5, 9)],
        "nearest": [rc.nearest("emb", "default", q, 5) for q in queries[-4:]],
        "training set": sorted((tuple(r.features()), r.label())
                               for r in rc.training_set("clicks")),
        "split": rc.train_test_split("clicks", test_size=0.5, random_state=3),
        "source": rc.source_data("ranked", limit=50),
        "list": {t.name: sorted(map(plain, mc.list(RT(t.value))))
                 for t in (RT.FEATURE_VARIANT, RT.SOURCE_VARIANT, RT.PROVIDER)},
        "get": plain(mc.get(RT(RT.LABEL_VARIANT.value), "clicked", "default")),
        "search": mc.search("rank"),
        "tasks": mc.run_tasks(),
    }


@pytest.fixture(scope="module")
def jax_written_db(tmp_path_factory):
    """A sqlite metadata DB written by the JAX package's client (providers
    of their own names: the provider cache keeps ``sides``' by name)."""
    from embeddinghub_tpu.featurestore.metadata import MetadataStore, SqliteStorage

    path = tmp_path_factory.mktemp("meta") / "state.db"
    ff_jax.global_registrar().reset()
    client = ff_jax.Client(metadata=MetadataStore(SqliteStorage(str(path))))
    reg = client.registrar
    reg.register_user("ana")
    reg.register_sqlite_offline("dash_wh")
    reg.register_memory_online("dash_cache")
    reg.register_entity("user", description="a user")
    reg.register_primary_data("events", provider="dash_wh", location={"rows": [
        {"user_id": "u1", "clicks": 10}, {"user_id": "u2", "clicks": 20}]})
    reg.register_feature("clicks", source=("events", "default"), entity="user",
                         entity_column="user_id", value_column="clicks",
                         provider="dash_cache")
    reg.register_label("lbl", source=("events", "default"), entity="user",
                       entity_column="user_id", value_column="clicks")
    reg.register_training_set("m", label=("lbl", "default"),
                              features=[("clicks", "default")])
    client.apply()
    return str(path)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def test_dashboards_equal(jax_written_db):
    """``GET /`` serves the same page from both packages, and ``/data/<type>``
    the same JSON over one metadata DB (the JAX package wrote it, each
    package opens it)."""
    from embeddinghub_tpu.featurestore.metadata import MetadataStore as JaxStore
    from embeddinghub_tpu.featurestore.metadata import SqliteStorage as JaxSqlite
    from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore, SqliteStorage

    servers = [jax_dashboard.DashboardServer(JaxStore(JaxSqlite(jax_written_db)), port=0),
               port_dashboard.DashboardServer(
                   MetadataStore(SqliteStorage(jax_written_db)), port=0)]
    for s in servers:
        s.start()
    try:
        j, p = (s.port for s in servers)
        assert _get(p, "/") == _get(j, "/")
        assert b"<html" in _get(p, "/").lower()
        for kind in ("features", "sources", "labels", "training-sets", "entities",
                     "users", "providers", "models"):
            want = json.loads(_get(j, f"/data/{kind}"))
            assert json.loads(_get(p, f"/data/{kind}")) == want
        assert {f["name"] for f in json.loads(_get(p, "/data/features"))} == {"clicks"}
        assert json.loads(_get(p, "/data/features/clicks")) == json.loads(
            _get(j, "/data/features/clicks"))
        assert json.loads(_get(p, "/search?q=clicks")) == json.loads(
            _get(j, "/search?q=clicks"))
    finally:
        for s in servers:
            s.stop()


def test_api_stream_writes_equal(sides):
    """The Api service's streamed writes, read back alike (last of the
    tests on ``sides``: they append to the sources the calls above read)."""
    _, _, j, p = sides

    def write(side):
        side.api.WriteFeatures(iter([
            mpb.StreamingFeatureVariant(name="score2", variant="default",
                                        entity="w1", value="0.25"),
            mpb.StreamingFeatureVariant(name="score2", variant="default",
                                        entity="i0", value="-1.5")]))
        side.api.WriteLabels(iter([mpb.StreamingLabelVariant(
            name="clicked", variant="default", entity="w1", value="1")]))
        return [side.serving.FeatureServe(_feature_req(["score2"], e)) for e in ("w1", "i0")] + [
            *side.serving.SourceData(pb.SourceDataRequest(
                id=pb.SourceID(name="items", version="default")))][-1:]

    want, got = _both(j, p, write)
    assert got == want
    assert [r.values[0].double_value for r in want[:2]] == [0.25, -1.5]
    want, got = _both(j, p, lambda s: s.api.WriteFeatures(iter([
        mpb.StreamingFeatureVariant(name="nope", variant="default", entity="w1",
                                    value="1")])))
    assert got == want == grpc.StatusCode.NOT_FOUND
