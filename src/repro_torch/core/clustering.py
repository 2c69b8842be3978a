"""k-means alternative to SL-range binning (paper §VII-C).

The paper clusters iteration *execution profiles* with k-means and finds the
simple binning performs as well (runtime is a good proxy for the profile).
We implement Lloyd's algorithm over feature vectors (default: normalized
[SL, runtime]; optionally full stat vectors) and pick each cluster's medoid
as the representative, weighted by cluster population.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPoint, SeqPointSet


def _kmeans(x: np.ndarray, k: int, iters: int = 50,
            seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    # k-means++ init
    centers = [x[rng.randint(len(x))]]
    for _ in range(k - 1):
        d2 = np.min(
            [((x - c) ** 2).sum(axis=1) for c in centers], axis=0)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(len(x), p=p)])
    c = np.stack(centers)
    for _ in range(iters):
        assign = np.argmin(
            ((x[:, None] - c[None]) ** 2).sum(-1), axis=1)
        newc = np.stack([
            x[assign == j].mean(axis=0) if (assign == j).any() else c[j]
            for j in range(k)])
        if np.allclose(newc, c):
            break
        c = newc
    return np.argmin(((x[:, None] - c[None]) ** 2).sum(-1), axis=1)


def kmeans_seqpoints(log: EpochLog, k: int = 8, *,
                     stat_keys: Optional[List[str]] = None,
                     seed: int = 0) -> SeqPointSet:
    table = log.by_seq_len()
    feats = [table.seq_lens.astype(float), table.runtimes]
    if stat_keys:
        per_sl = {}
        for it in log.iterations:
            per_sl.setdefault(it.seq_len, []).append(
                [it.stats.get(s, 0.0) for s in stat_keys])
        extra = np.array([np.mean(per_sl[int(s)], axis=0)
                          for s in table.seq_lens])
        feats.extend(extra.T)
    x = np.stack(feats, axis=1)
    x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-12)

    k = min(k, table.num_unique)
    assign = _kmeans(x, k, seed=seed)
    points: List[SeqPoint] = []
    for j in range(k):
        mask = assign == j
        if not mask.any():
            continue
        counts = table.counts[mask]
        runtimes = table.runtimes[mask]
        sls = table.seq_lens[mask]
        center = x[mask].mean(axis=0)
        medoid = int(np.argmin(((x[mask] - center) ** 2).sum(-1)))
        points.append(SeqPoint(int(sls[medoid]), float(counts.sum()),
                               float(runtimes[medoid])))
    pred = float(sum(p.weight * p.runtime for p in points))
    actual = table.total_runtime
    return SeqPointSet(points, k=k, predicted=pred, actual=actual,
                       error=abs(pred - actual) / max(actual, 1e-12),
                       method="kmeans")
