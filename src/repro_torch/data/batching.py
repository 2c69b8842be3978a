"""Batch formation over variable-length sequences (numpy copy of
``repro.data.batching``).

The paper's key mechanism (§IV-B1): a batch adopts the *maximum* SL of its
members and pads the rest, so per-iteration cost is keyed by that padded SL.
``granularity`` rounds batch SLs up to a multiple (real frameworks pad to
tile multiples; it also bounds the unique-SL count).

The iterator is deterministic and checkpointable (``state()`` /
``restore``) for fault-tolerant training; for the same seed it yields the
reference's batches exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import SLDistribution, sample_tokens


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


@dataclass
class IteratorState:
    epoch: int
    batch_index: int
    seed: int


class DataIterator:
    """Deterministic, resumable iterator yielding (tokens, labels, seq_len).

    Data-parallel shards slice the batch dimension by (shard_id,
    num_shards); the SL schedule is identical across shards so all shards
    execute the same padded shapes in lockstep.
    """

    def __init__(self, dist: SLDistribution, *, samples_per_epoch: int,
                 batch_size: int, vocab_size: int, granularity: int = 8,
                 bucketed: bool = False, sort_first_epoch: bool = False,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1):
        if batch_size % num_shards:
            raise ValueError(f"batch {batch_size} does not split into "
                             f"{num_shards} shards")
        self.dist = dist
        self.samples_per_epoch = samples_per_epoch
        self.batch_size = batch_size
        self.vocab_size = vocab_size
        self.granularity = granularity
        self.bucketed = bucketed
        self.sort_first_epoch = sort_first_epoch
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._state = IteratorState(epoch=0, batch_index=0, seed=seed)
        self._plan: Optional[BatchPlan] = None

    # -- checkpointable state ------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"epoch": self._state.epoch,
                "batch_index": self._state.batch_index, "seed": self.seed}

    def restore(self, state: Dict[str, int]) -> None:
        self._state = IteratorState(**state)
        self.seed = state["seed"]
        self._plan = None

    # -- epoch plan ------------------------------------------------------
    def epoch_plan(self, epoch: Optional[int] = None) -> BatchPlan:
        epoch = self._state.epoch if epoch is None else epoch
        rng = np.random.RandomState((self.seed, epoch))
        sls = self.dist.sample(rng, self.samples_per_epoch)
        return plan_epoch(
            sls, self.batch_size, granularity=self.granularity,
            bucketed=self.bucketed,
            sort_first=(self.sort_first_epoch and epoch == 0),
            seed=self.seed + epoch)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        while True:
            if self._plan is None:
                self._plan = self.epoch_plan()
            plan = self._plan
            while self._state.batch_index < plan.num_batches:
                i = self._state.batch_index
                sl = int(plan.padded_sls[i])
                rng = np.random.RandomState(
                    (self.seed, self._state.epoch, i))
                bs_local = self.batch_size // self.num_shards
                toks = sample_tokens(rng, (self.batch_size, sl + 1),
                                     self.vocab_size)
                lens = plan.member_sls[i]
                mask = np.arange(sl + 1)[None, :] < lens[:, None] + 1
                toks = np.where(mask, toks, 0)
                labels = np.where(mask[:, 1:], toks[:, 1:], -1)
                lo = self.shard_id * bs_local
                # advance state BEFORE yielding so a checkpoint taken after
                # consuming this batch resumes at the next one
                self._state.batch_index += 1
                yield (toks[lo:lo + bs_local, :-1],
                       labels[lo:lo + bs_local], sl)
            self._state = IteratorState(self._state.epoch + 1, 0, self.seed)
            self._plan = None
