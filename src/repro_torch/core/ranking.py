"""Join-quality scoring head for ranked discovery.

Port of ``repro.core.ranking``.  Per candidate table:

  * ``containment`` — the per-table eligible-hit count from the §6.3 filter
    launch, clipped to the distinct-key count and normalised;
  * ``uniqueness`` — max column cardinality over table rows (``ProfileStore``);
  * ``similarity`` — matching min-hash sketch positions between the query
    key values and the table's value set.

``score = containment · (W_BASE + W_UNIQ·uniqueness + W_SIM·similarity)``,
all float32.  The device path is a handful of elementwise torch ops on the
index's device (the reference's jitted XLA launch); ``score_np`` is the
numpy oracle with the same op order.  The score never drives heap
membership: it only reorders and annotates the verified top-k.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import profiles

W_BASE = np.float32(0.25)
W_UNIQ = np.float32(0.55)
W_SIM = np.float32(0.20)


def _score(counts, n_keys, card_max, n_rows, t_sketch, q_sketch) -> torch.Tensor:
    """The scoring launch: float32 tensors on one device."""
    c = torch.minimum(counts, n_keys) / torch.clamp(n_keys, min=1.0)
    u = card_max / torch.clamp(n_rows, min=1.0)
    eq = (t_sketch == q_sketch[None, :]).to(torch.float32)
    s = eq.sum(dim=1) / float(profiles.SKETCH_K)
    return c * (float(W_BASE) + float(W_UNIQ) * u + float(W_SIM) * s)


def score_np(
    counts: np.ndarray,
    n_keys: int,
    card_max: np.ndarray,
    n_rows: np.ndarray,
    sketch_eq: np.ndarray,
) -> np.ndarray:
    """Numpy oracle for the scoring launch — same float32 op order."""
    nk = np.float32(n_keys)
    c = np.minimum(counts.astype(np.float32), nk) / np.maximum(
        nk, np.float32(1.0)
    )
    u = card_max.astype(np.float32) / np.maximum(
        n_rows.astype(np.float32), np.float32(1.0)
    )
    s = sketch_eq.astype(np.float32) / np.float32(profiles.SKETCH_K)
    return (c * (W_BASE + W_UNIQ * u + W_SIM * s)).astype(np.float32)


def query_sketch(index, distinct_keys: list[tuple]) -> np.ndarray:
    """Min-hash sketch of the query's key-value set (one per plan)."""
    uniq = list(dict.fromkeys(v for key in distinct_keys for v in key))
    if not uniq:
        return profiles.value_sketch(np.zeros(0, dtype=np.uint32))
    lanes = index.hash_values(uniq)
    return profiles.value_sketch(lanes[:, 0])


def quality_scores(
    index,
    table_ids: np.ndarray,
    counts: np.ndarray,
    n_keys: int,
    q_sketch: np.ndarray,
    stats=None,
) -> np.ndarray:
    """float32[n] join-quality scores for one batch of candidate tables:
    one scoring launch on the index's device over the batch."""
    n = int(np.asarray(table_ids).shape[0])
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    card_max, n_rows, sketch = index.profile_features(table_ids)
    dev = index.device

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)

    out = _score(
        f32(np.asarray(counts)[:n]),
        torch.tensor(float(n_keys), dtype=torch.float32, device=dev),
        f32(card_max),
        f32(n_rows),
        torch.from_numpy(sketch.astype(np.int64)).to(dev),
        torch.from_numpy(np.asarray(q_sketch).astype(np.int64)).to(dev),
    )
    if stats is not None:
        stats.ranking_launches += 1
    return out.cpu().numpy().astype(np.float32)
