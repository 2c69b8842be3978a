"""Synthetic datasets with realistic sequence-length distributions.

Paper Fig. 7 shows the two characteristic shapes: LibriSpeech (DS2) — a
broad, right-skewed distribution of audio-frame counts; IWSLT (GNMT) — a
decaying distribution of sentence lengths. We model both plus generic
lognormal/uniform samplers, and a Zipf token sampler so embedding-gather
behavior is vocabulary-realistic (paper key obs. 6: keep vocabulary full
size).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np


@dataclass(frozen=True)
class SLDistribution:
    name: str
    sampler: Callable[[np.random.RandomState, int], np.ndarray]
    min_len: int
    max_len: int

    def sample(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        sls = self.sampler(rng, n)
        return np.clip(np.round(sls).astype(np.int64), self.min_len,
                       self.max_len)


def _librispeech(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Audio-frame counts: mixture of utterance lengths, right-skewed with a
    bulk around 12-16 s (paper Fig. 7a shape)."""
    bulk = rng.normal(loc=800, scale=280, size=int(n * 0.8))
    tail = rng.exponential(scale=320, size=n - int(n * 0.8)) + 900
    return np.concatenate([bulk, tail])


def _iwslt(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Sentence lengths (words): decaying lognormal (paper Fig. 7b shape)."""
    return rng.lognormal(mean=3.0, sigma=0.55, size=n)


LIBRISPEECH_LIKE = SLDistribution("librispeech-like", _librispeech, 40, 1700)
IWSLT_LIKE = SLDistribution("iwslt-like", _iwslt, 2, 128)


def lognormal(mean: float, sigma: float, min_len: int,
              max_len: int) -> SLDistribution:
    return SLDistribution(
        f"lognormal({mean},{sigma})",
        lambda rng, n: rng.lognormal(mean=mean, sigma=sigma, size=n),
        min_len, max_len)


def uniform(min_len: int, max_len: int) -> SLDistribution:
    return SLDistribution(
        f"uniform({min_len},{max_len})",
        lambda rng, n: rng.uniform(min_len, max_len, size=n),
        min_len, max_len)


# LM-style pretraining/sft mixtures for the assigned archs: document lengths
# up to the shape's seq_len (used by the Characterizer, DESIGN.md §2)
def lm_documents(max_len: int) -> SLDistribution:
    def sampler(rng: np.random.RandomState, n: int) -> np.ndarray:
        ln = rng.lognormal(mean=np.log(max_len * 0.18), sigma=0.9, size=n)
        return ln
    return SLDistribution(f"lm-docs(max={max_len})", sampler, 16, max_len)


DISTRIBUTIONS: Dict[str, SLDistribution] = {
    "librispeech": LIBRISPEECH_LIKE,
    "iwslt": IWSLT_LIKE,
}


def sample_tokens(rng: np.random.RandomState, shape, vocab_size: int,
                  zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-ish token ids in [0, vocab)."""
    n = int(np.prod(shape))
    ranks = rng.zipf(zipf_a, size=n).astype(np.int64)
    return (np.minimum(ranks, vocab_size) - 1).reshape(shape)
