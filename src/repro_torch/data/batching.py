"""Batch formation over variable-length sequences (numpy copy of
``repro.data.batching``'s epoch planner).

The paper's key mechanism (§IV-B1): a batch adopts the *maximum* SL of its
members and pads the rest, so per-iteration cost is keyed by that padded SL.
``granularity`` rounds batch SLs up to a multiple (real frameworks pad to
tile multiples; it also bounds the unique-SL count).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def pad_to(sl: int, granularity: int) -> int:
    return int(-(-sl // granularity) * granularity)


@dataclass
class BatchPlan:
    """The epoch's batch schedule: per-batch padded SL + member lengths."""

    padded_sls: np.ndarray          # (num_batches,)
    member_sls: List[np.ndarray]    # raw lengths per batch
    batch_size: int

    @property
    def num_batches(self) -> int:
        return len(self.padded_sls)

    def padding_waste(self) -> float:
        """Fraction of token slots that are padding."""
        total = sum(int(p) * self.batch_size for p in self.padded_sls)
        real = sum(int(m.sum()) for m in self.member_sls)
        return 1.0 - real / max(total, 1)


def plan_epoch(sls: np.ndarray, batch_size: int, *, granularity: int = 8,
               bucketed: bool = False, sort_first: bool = False,
               seed: int = 0) -> BatchPlan:
    """Form an epoch's batches from sample lengths.

    ``sort_first`` models DS2's sorted first epoch (paper §VI-D: the
    artifact that made `prior` accidentally accurate on DS2).
    ``bucketed`` groups similar SLs per batch (beyond-paper).
    """
    rng = np.random.RandomState(seed)
    order = np.argsort(sls, kind="stable") if (sort_first or bucketed) \
        else rng.permutation(len(sls))
    sls = np.asarray(sls)[order]
    n_full = len(sls) // batch_size * batch_size
    batches = sls[:n_full].reshape(-1, batch_size)
    if bucketed and not sort_first:
        # batches are SL-homogeneous; shuffle batch order for training
        batches = batches[rng.permutation(len(batches))]
    padded = np.array([pad_to(int(b.max()), granularity) for b in batches])
    return BatchPlan(padded_sls=padded,
                     member_sls=[b.copy() for b in batches],
                     batch_size=batch_size)
