"""The comparison that decides ``correct``: every answer the window produced,
held against the plain reference (``reference.py``) once the window has
closed and the program's state is freed.

A store key is the decimal string of the generated row it was written
with (``key_of``), so a returned key names a row of the reference's
copy of the data, and the reference scores it (``score_answers``).

- An answer's hits are its distinct keys whose reference score is at least
  the reference's k-th best for that query, less a rounding allowance
  (ann-benchmarks' rule, so that rows tied with the k-th count); its
  recall is hits / k.  ``miss_at_10`` is one less the mean recall over
  every answer.
- An answer is nearest first: ``misordered_share`` is the share of the
  adjacent pairs of every answer whose later key scores above the earlier
  one by more than the rounding the configuration states for the scores
  the program ranks by (``order_rounding``) and the same allowance.
"""

from __future__ import annotations

import numpy as np
import torch

from hubbench import reference

# A reference score within this share of another counts as tied with it:
# the two are summed in different orders (f32 rounding of a 128-term
# product is near 1e-7 relative).
TIE_SHARE = 1e-6


def key_of(rows: int) -> list[str]:
    """The store keys of rows ``0 .. rows - 1``."""
    return [str(j) for j in range(rows)]


def answer_rows(answers: list[list[str]], k: int) -> np.ndarray:
    """``[M, k]`` rows named by ``M`` answers' keys, in each answer's order:
    ``-1`` past an answer's end, for a key that names no row, and for a
    key the answer gave before."""
    flat = []
    for keys in answers:
        flat.extend(keys[:k])
        flat.extend(["-1"] * (k - min(len(keys), k)))
    try:
        ids = np.asarray(flat, dtype=np.str_).astype(np.int64)
    except ValueError:  # a key that is no row: parse one at a time
        ids = np.fromiter((int(s) if s.lstrip("-").isdigit() else -1 for s in flat),
                          dtype=np.int64, count=len(flat))
    ids = ids.reshape(len(answers), k)
    # a repeat: a slot whose id an earlier slot of the answer holds
    order = np.argsort(ids, axis=1, kind="stable")
    srt = np.take_along_axis(ids, order, axis=1)
    again = np.zeros_like(srt, dtype=bool)
    again[:, 1:] = srt[:, 1:] == srt[:, :-1]
    repeat = np.zeros_like(again)
    np.put_along_axis(repeat, order, again, axis=1)
    ids[repeat] = -1
    return ids


def score_answers(rows: torch.Tensor, pool: torch.Tensor, asked: np.ndarray,
                  got: np.ndarray, metric: str) -> torch.Tensor:
    """Reference scores ``[M, k]`` (higher is nearer, ``-inf`` for ``-1``)
    of ``M`` answers: ``asked [M]`` the pool index of each answer's query,
    ``got [M, k]`` its rows (``answer_rows``); ``rows`` and ``pool``
    prepared by ``reference.prepare``."""
    n = rows.shape[0]
    ids = torch.from_numpy(np.where(got < n, got, -1)).to(rows.device)
    idx = torch.from_numpy(asked).to(rows.device)
    return reference.scores_of(rows, pool[idx], ids, metric)


def _allowance(s: torch.Tensor) -> torch.Tensor:
    return TIE_SHARE * s.abs().clamp(min=1.0)


def hits(got_s: torch.Tensor, truth_scores: torch.Tensor, asked: np.ndarray) -> np.ndarray:
    """Hits ``[M]`` of ``M`` answers scored ``got_s`` (``score_answers``),
    against the reference's scores ``truth_scores [Q, k]`` of the pool."""
    kth = truth_scores[torch.from_numpy(asked).to(truth_scores.device), -1:]
    return (got_s >= kth - _allowance(kth)).sum(1).clamp(max=got_s.shape[1]).cpu().numpy()


def misordered_share(got_s: torch.Tensor, rounding: float) -> float:
    """The share of adjacent pairs of slots, both naming a row, whose later
    row scores above the earlier by more than ``rounding`` and the tie
    allowance; 0.0 where no answer has two rows."""
    a, b = got_s[:, :-1], got_s[:, 1:]
    both = torch.isfinite(a) & torch.isfinite(b)
    worse = b - a > rounding + _allowance(a)
    pairs = int(both.sum())
    return int((both & worse).sum()) / pairs if pairs else 0.0


def miss_rate(hit: np.ndarray, k: int) -> float:
    """One less the mean recall@k; 1.0 where nothing was answered."""
    return 1.0 - float(hit.sum()) / (k * hit.size) if hit.size else 1.0
