"""Provider health checks (reference ``health/health.go:19-64``: the
dashboard asks whether each registered provider is reachable)."""

from __future__ import annotations

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore
from embeddinghub_tpu_torch.featurestore.providers import base as provider_base
from embeddinghub_tpu_torch.featurestore.resources import ResourceType


def check_provider(metadata: MetadataStore, name: str) -> tuple[bool, str]:
    from embeddinghub_tpu_torch.featurestore.resources import ResourceID

    try:
        res = metadata.get(ResourceID(ResourceType.PROVIDER, name))
    except fferr.FFError as e:
        return False, str(e)
    try:
        provider = provider_base.get_provider(
            res.provider_type, res.config, cache_key=name
        )
        return bool(provider.check_health()), ""
    except Exception as e:  # noqa: BLE001 — any failure is "unhealthy"
        return False, str(e)


def check_all(metadata: MetadataStore) -> dict[str, dict]:
    out = {}
    for res in metadata.list_type(ResourceType.PROVIDER):
        healthy, err = check_provider(metadata, res.name)
        out[res.name] = {
            "type": res.provider_type,
            "healthy": healthy,
            "error": err,
        }
    return out
