"""The port's feature store (``embeddinghub_tpu_torch.featurestore``)
against the JAX package's, on the same definitions and seeded data.

Both clients apply a sqlite source of 4,096 x 32 rows, an embedding
feature on the engine vector store (the JAX engine on CPU JAX, the port's
with ``device="cpu"``), a scalar feature on memory online, a label, a
training set, a SQL transformation and a DataFrame transformation run by
each package's own ``transform_worker`` subprocess.  Statuses, task runs,
served features, training-set rows and ``nearest`` keys must agree; keys
may differ only at near ties of the exact cosine distances.

The provider contract over the port's providers is in
``test_torch_featurestore_providers.py``.
"""

import numpy as np
import pytest

import embeddinghub_tpu.featurestore as ff_jax
import embeddinghub_tpu_torch.featurestore as ff_port
from embeddinghub_tpu.featurestore.providers.base import (
    reset_provider_cache as reset_jax_providers,
)
from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.providers.base import (
    reset_provider_cache as reset_port_providers,
)
from embeddinghub_tpu_torch.featurestore.resources import ResourceID, ResourceType

from _torch_parity import assert_ids_equal_off_ties

N, D, Q = 4096, 32, 64


def _data():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((N, D)).astype(np.float32)
    rows = [{"item_id": f"i{i}", "vec": x[i].tolist(),
             "score": round(float(rng.standard_normal()), 6),
             "clicked": int(i % 3 == 0), "ts": int(i % 7)}
            for i in range(N)]
    near = x[rng.integers(0, N, Q // 2)] + 0.05 * rng.standard_normal(
        (Q // 2, D)).astype(np.float32)
    fresh = rng.standard_normal((Q - Q // 2, D)).astype(np.float32)
    return x, rows, np.concatenate([near, fresh])


def _apply(ff, reset, rows, **vector_kw):
    """The same definitions through either package; returns the client."""
    reset()
    ff.global_registrar().reset()
    client = ff.Client()
    reg = client.registrar
    reg.register_user("ana")
    reg.set_default_owner("ana")
    reg.register_sqlite_offline("warehouse")
    reg.register_memory_online("cache")
    reg.register_engine_vector_store("vectors", **vector_kw)
    reg.register_entity("item")
    reg.register_primary_data("items", provider="warehouse", location={"rows": rows})
    reg.register_embedding_feature(
        "emb", source=("items", "default"), entity="item",
        entity_column="item_id", value_column="vec", dims=D, provider="vectors")
    reg.register_feature(
        "score", source=("items", "default"), entity="item",
        entity_column="item_id", value_column="score", timestamp_column="ts",
        provider="cache")

    @reg.sql_transformation(name="scaled", provider="warehouse",
                            inputs=[("items", "default")])
    def scaled():
        return ("SELECT item_id, score * 2 AS score2, ts "
                "FROM {{ items.default }} WHERE clicked = 1")

    @reg.df_transformation(name="ranked", provider="warehouse",
                           inputs=[("items", "default")], engine="subprocess")
    def ranked(items):
        return [{"item_id": r["item_id"], "rank": int(r["score"] * 100) % 5,
                 "ts": r["ts"]} for r in items]

    reg.register_feature(
        "score2", source=("scaled", "default"), entity="item",
        entity_column="item_id", value_column="score2", timestamp_column="ts",
        provider="cache")
    reg.register_feature(
        "rank", source=("ranked", "default"), entity="item",
        entity_column="item_id", value_column="rank", timestamp_column="ts",
        provider="cache")
    reg.register_label(
        "clicked", source=("items", "default"), entity="item",
        entity_column="item_id", value_column="clicked", timestamp_column="ts")
    reg.register_training_set(
        "clicks", label=("clicked", "default"),
        features=[("score", "default"), ("rank", "default")])
    client.apply()
    return client


def _statuses(client):
    return sorted((r.rtype.name, r.name, str(getattr(r, "variant", "")),
                   r.status.name) for r in client.metadata.all())


def _runs(client):
    tasks = client.coordinator.tasks
    out = []
    for r in tasks.all_runs():
        t = tasks.task(r.task_id)
        out.append((t.task_type, t.target.type.name, t.target.name,
                    t.target.variant, r.status.name))
    return sorted(out)


@pytest.fixture(scope="module")
def pair():
    x, rows, queries = _data()
    jax_client = _apply(ff_jax, reset_jax_providers, rows)
    port_client = _apply(ff_port, reset_port_providers, rows, device="cpu")
    yield x, queries, jax_client, port_client
    reset_jax_providers()
    reset_port_providers()


def test_statuses_and_task_runs(pair):
    _, _, j, p = pair
    assert _statuses(p) == _statuses(j)
    assert all(s[-1] == "READY" for s in _statuses(p)), _statuses(p)
    assert _runs(p) == _runs(j)
    task = p.coordinator.tasks.task_for_target(
        ResourceID(ResourceType.SOURCE_VARIANT, "ranked", "default"))
    logs = "\n".join(line for r in p.coordinator.tasks.runs_for_task(task.id)
                     for line in r.logs)
    assert "SubprocessEngine" in logs


def test_features_equal(pair):
    x, _, j, p = pair
    names = [("score", "default"), ("score2", "default"), ("rank", "default")]
    for i in (0, 3, 7, 1000, 4095):
        ent = {"item": f"i{i}"}
        if i % 3:  # score2 holds clicked rows only
            with pytest.raises(fferr.FFError):
                p.features(names, ent)
            names_i = [names[0], names[2]]
        else:
            names_i = names
        assert p.features(names_i, ent) == j.features(names_i, ent)
        got = p.features(["emb"], ent)[0]
        np.testing.assert_allclose(got, j.features(["emb"], ent)[0], rtol=1e-6)
        np.testing.assert_allclose(got, x[i], rtol=1e-6)


def test_training_sets_equal(pair):
    _, _, j, p = pair

    def rows(c):
        return sorted((tuple(r.features()), r.label())
                      for r in c.training_set("clicks"))

    want = rows(j)
    assert len(want) == N
    assert rows(p) == want


def test_nearest_keys_equal_off_ties(pair):
    x, queries, j, p = pair
    k = 10
    got = np.array([[int(s[1:]) for s in p.nearest("emb", "default", q, k)]
                    for q in queries])
    want = np.array([[int(s[1:]) for s in j.nearest("emb", "default", q, k)]
                     for q in queries])
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    want_d = 1.0 - np.einsum("bkd,bd->bk", xn[want].astype(np.float64), qn)
    assert_ids_equal_off_ties(got, want, want_d, 1e-5)
