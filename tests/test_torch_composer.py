"""The port's single-process composer (``python -m embeddinghub_tpu_torch.main``)
as a subprocess on the CPU, mirroring ``test_main_composer.py``.

Every server takes a free port (``service/spawn.ComposerProcess``), so
this file and ``test_main_composer.py`` may run at once.  The definitions
register the engine vector store with ``device="cpu"`` and the store
server runs with ``--device cpu``; ``--device cuda`` on a host without
CUDA must fail.  A metadata DB written by the JAX package's client opens
unchanged in the port's composer, and on SIGTERM the composer stops,
prints its kernel launches and exits 0.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from embeddinghub_tpu_torch.featurestore.resources import ResourceType, Status
from embeddinghub_tpu_torch.service.spawn import ComposerProcess, free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY_S = 60.0

DEFS = """
import embeddinghub_tpu_torch.featurestore as ff
reg = ff.global_registrar()
reg.register_sqlite_offline("wh")
reg.register_memory_online("cache")
reg.register_engine_vector_store("vec", device="cpu")
reg.register_entity("user")
reg.register_primary_data("events", provider="wh", location={"rows": [
    {"user_id": "u1", "clicks": 10, "vec": [1.0, 0.0]},
    {"user_id": "u2", "clicks": 20, "vec": [0.0, 1.0]},
]})
reg.register_feature("clicks", source=("events", "default"), entity="user",
                     entity_column="user_id", value_column="clicks",
                     provider="cache")
reg.register_embedding_feature("uvec", source=("events", "default"),
                               entity="user", entity_column="user_id",
                               value_column="vec", dims=2, provider="vec")
reg.register_label("lbl", source=("events", "default"), entity="user",
                   entity_column="user_id", value_column="clicks")
reg.register_training_set("m", label=("lbl", "default"),
                          features=[("clicks", "default")])
"""

_TYPES = (ResourceType.PROVIDER, ResourceType.ENTITY, ResourceType.SOURCE_VARIANT,
          ResourceType.FEATURE_VARIANT, ResourceType.LABEL_VARIANT,
          ResourceType.TRAINING_SET_VARIANT)


def _resources(mc):
    """``{type: [(name, variant, status)]}`` over the metadata gRPC."""
    return {t.name: sorted((r.name, getattr(r, "variant", ""), r.status.value)
                           for r in mc.list(t)) for t in _TYPES}


def _wait_ready(mc, want: int):
    """Poll until ``want`` resources exist and every one is READY; bounded."""
    deadline = time.monotonic() + READY_S
    while True:
        got = _resources(mc)
        flat = [r for rs in got.values() for r in rs]
        if len(flat) >= want and all(s == Status.READY.value for _, _, s in flat):
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"not READY within {READY_S:.0f} s: {got}")
        time.sleep(0.1)


@pytest.fixture(scope="module")
def composer(tmp_path_factory):
    from embeddinghub_tpu_torch.featurestore.metadata_grpc import RemoteMetadataClient

    defs = tmp_path_factory.mktemp("defs") / "defs.py"
    defs.write_text(DEFS)
    proc = ComposerProcess(tmp_path_factory.mktemp("store"), device="cpu", defs=defs,
                           start_timeout=90.0)
    try:
        mc = RemoteMetadataClient(host="127.0.0.1", port=proc.metadata_port)
        _wait_ready(mc, 9)
        mc.close()
        yield proc
    finally:
        proc.kill()


def test_store_surface(composer):
    from embeddinghub_tpu_torch.sdk.client import EmbeddingHubClient

    c = EmbeddingHubClient(host="127.0.0.1", port=composer.store_port)
    c.create_space("s", 3)
    c.set("s", "a", [1, 2, 3])
    c.set("s", "b", [1, 2, 4])
    c.set("s", "c", [-1, 0, 0])
    assert list(c.get("s", "a")) == [1, 2, 3]
    assert list(c.nearest_neighbor("s", 1, key="a")) == ["b"]
    c.close()


def test_remote_serving_client(composer):
    from embeddinghub_tpu_torch.featurestore.remote_client import RemoteServingClient

    rc = RemoteServingClient(host="127.0.0.1", port=composer.serving_port)
    assert rc.features(["clicks"], {"user": "u2"}) == [20]
    assert rc.nearest("uvec", "default", [0.9, 0.1], 1) == ["u1"]
    ds = rc.training_set("m")
    assert {(r.features()[0], r.label()) for r in ds} == {(10, 10), (20, 20)}
    rows = rc.source_data("events")
    assert len(rows) == 2
    train, test = rc.train_test_split("m", test_size=0.5)
    assert len(train) + len(test) == 2
    rc.close()


def test_dashboard_http(composer):
    from embeddinghub_tpu_torch.featurestore.remote_client import RemoteServingClient

    rc = RemoteServingClient(host="127.0.0.1", port=composer.serving_port)
    assert rc.features(["clicks"], {"user": "u1"}) == [10]
    rc.close()
    base = f"http://127.0.0.1:{composer.http_port}"
    with urllib.request.urlopen(f"{base}/data/features", timeout=10) as r:
        features = json.loads(r.read().decode())
    assert {f["name"] for f in features} == {"clicks", "uvec"}
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        metrics = r.read().decode()
    assert "embeddinghub_tpu_" in metrics  # the Prometheus namespace
    assert 'feature="clicks"' in metrics  # the FeatureServe above, counted


def test_jax_written_metadata_opens_and_sigterm(tmp_path):
    """A metadata DB the JAX package's client wrote lists the same
    resources, statuses and variants in the port's composer; SIGTERM then
    stops it with its kernel launches reported and exit code 0."""
    import embeddinghub_tpu.featurestore as ff_jax
    from embeddinghub_tpu.featurestore.metadata import MetadataStore, SqliteStorage
    from embeddinghub_tpu.featurestore.providers.base import reset_provider_cache
    from embeddinghub_tpu_torch.featurestore.metadata_grpc import RemoteMetadataClient

    db = tmp_path / "state.db"
    reset_provider_cache()
    ff_jax.global_registrar().reset()
    client = ff_jax.Client(metadata=MetadataStore(SqliteStorage(str(db))))
    exec(compile(DEFS.replace("embeddinghub_tpu_torch.", "embeddinghub_tpu.")
                 .replace(', device="cpu"', ""), "defs", "exec"))
    client.apply()
    want = {t.name: sorted((r.name, getattr(r, "variant", ""), r.status.value)
                           for r in client.metadata.list_type(t)) for t in _TYPES}
    reset_provider_cache()
    ff_jax.global_registrar().reset()
    assert sum(map(len, want.values())) == 9

    proc = ComposerProcess(tmp_path / "store", device="cpu", metadata_db=db,
                           start_timeout=90.0)
    try:
        mc = RemoteMetadataClient(host="127.0.0.1", port=proc.metadata_port)
        assert _resources(mc) == want
        mc.close()
        launches = proc.stop()
    finally:
        proc.kill()
    assert proc.proc.returncode == 0
    from embeddinghub_tpu_torch.ops import fused_topk

    assert set(launches) == set(fused_topk.LAUNCHES)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has CUDA: the "
                    "composer would start on it")
def test_device_cuda_refused_without_cuda(tmp_path):
    ports = free_ports(4)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "embeddinghub_tpu_torch.main", "--device", "cuda",
         "--store-port", str(ports[0]), "--serving-port", str(ports[1]),
         "--metadata-port", str(ports[2]), "--http-port", str(ports[3]),
         "--data-dir", str(tmp_path / "store")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "embeddinghub-tpu up" not in proc.stdout
