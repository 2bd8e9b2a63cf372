"""Resource full-text search.

Rebuild of reference ``metadata/search/search.go`` (Meilisearch-backed
resource index) as a dependency-free in-process inverted index with
prefix matching and simple ranking, kept in sync via metadata watchers
(the reference backfills with ``search_loader``)."""

from __future__ import annotations

import re
import threading
from collections import defaultdict

from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore
from embeddinghub_tpu_torch.featurestore.resources import Resource

_TOKEN = re.compile(r"[a-z0-9]+")


def _tokens(text: str) -> list[str]:
    return _TOKEN.findall(text.lower())


class SearchIndex:
    def __init__(self, metadata: MetadataStore | None = None):
        self._lock = threading.Lock()
        self._postings: dict[str, set[str]] = defaultdict(set)
        self._docs: dict[str, dict] = {}
        if metadata is not None:
            for res in metadata.all():
                self.upsert(res)
            metadata.watch(self.upsert)

    def upsert(self, res: Resource) -> None:
        doc_id = res.rid().key()
        doc = {
            "id": doc_id,
            "type": res.rtype.value,
            "name": res.name,
            "variant": getattr(res, "variant", ""),
            "description": res.description,
            "owner": res.owner,
            "tags": list(res.tags),
        }
        text = " ".join(
            [res.name, getattr(res, "variant", ""), res.description, res.owner]
            + list(res.tags)
        )
        with self._lock:
            self._docs[doc_id] = doc
            for tok in _tokens(text):
                self._postings[tok].add(doc_id)

    def search(self, query: str, limit: int = 20) -> list[dict]:
        qtokens = _tokens(query)
        if not qtokens:
            return []
        with self._lock:
            scores: dict[str, int] = defaultdict(int)
            for qt in qtokens:
                # exact + prefix matches
                for tok, ids in self._postings.items():
                    if tok == qt:
                        for d in ids:
                            scores[d] += 2
                    elif tok.startswith(qt):
                        for d in ids:
                            scores[d] += 1
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
            return [self._docs[d] for d, _ in ranked[:limit]]
