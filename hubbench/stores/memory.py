"""``durability: memory``: an in-memory store, no WAL and no snapshot (the
read path of a loaded store)."""

from __future__ import annotations


def open_store(config: dict, traffic: dict, device):
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub
    from embeddinghub_tpu_torch.utils.config import Config

    hub_config = Config(engine=config["engine"],
                        hnsw_m=config.get("hnsw_m", 16),
                        hnsw_ef_construction=config.get("hnsw_ef_construction", 200),
                        hnsw_ef_search=traffic.get("ef") or 10)
    hub = EmbeddingHub.in_memory(engine=config["engine"], device=device, config=hub_config)
    version = hub.create_space("bench", config["dims"], config["metric"]).default_version()
    if "quant_guard" in config:
        version.index.quant_guard = bool(config["quant_guard"])
    return hub, version
