"""Serve-side replica health for request hedging (a copy of
``repro.resilience.elastic.ReplicaSet``; failure domains and elastic
re-meshing come with the distribution slice)."""
from __future__ import annotations

from typing import Optional

import numpy as np


class ReplicaSet:
    """Health scores for ``n`` simulated serve replicas.

    The engine takes the healthiest replica as primary for each batch and
    hedges onto the next healthiest; a replica that loses a hedge race gets
    a strike (and is avoided until it behaves), one that wins or completes
    normally works a strike off.
    """

    def __init__(self, n: int):
        if n < 1:
            raise ValueError("need at least one replica")
        self.n = int(n)
        self._strikes = [0] * self.n

    def strikes(self, replica: int) -> int:
        return self._strikes[replica]

    def mark_slow(self, replica: int) -> None:
        self._strikes[replica] += 1

    def mark_ok(self, replica: int) -> None:
        self._strikes[replica] = max(0, self._strikes[replica] - 1)

    def pick_primary(self) -> int:
        return int(np.argmin(self._strikes))

    def pick_hedge(self, exclude: int) -> Optional[int]:
        cands = [(s, r) for r, s in enumerate(self._strikes) if r != exclude]
        return min(cands)[1] if cands else None
