"""Multi-host failure domains: peer-loss detection and elastic re-meshing
(a copy of ``repro.resilience.elastic``'s host logic).

A production SQNN run spans many hosts; a single lost peer must not kill the
job and discard the SeqPoint profile. This module models the failure domains
of a device mesh (which devices live together on which host), tracks peer
health from heartbeats, and — on a confirmed loss — rebuilds the mesh over
the survivors so training (and its EpochLog) continues.

Pieces, bottom-up:

* ``FailureDomains`` — maps the mesh's ``data`` axis onto simulated hosts
  (each host owns a contiguous slab of data-axis rows spanning the full
  model axis, the standard pod topology). ``surviving_mesh`` shrinks the
  data axis past a set of lost hosts and re-numbers the survivors.
* ``PeerHealthTracker`` — consecutive-missed-heartbeat counters; a host is
  *suspect* after one miss and *confirmed lost* after ``confirm_misses``
  consecutive misses, so one late heartbeat (``peer_slow``) never triggers
  a re-mesh.
* ``ClusterMonitor`` — the trainer's per-step pulse: consumes the
  ``peer_loss`` / ``peer_slow`` / ``mesh_partition`` fault points, feeds
  the tracker, emits ``peer_slow`` / ``peer_lost`` events, and raises
  ``PeerLossFault`` once a loss is confirmed (the trainer's tier-4 re-mesh
  arm catches it).
* ``ReplicaSet`` — serve-side replica health for request hedging: the
  engine picks the healthiest replica as primary and hedges onto the next
  healthiest when a batch runs long.
* ``reshard_state`` — derives a restored ``TrainState``'s specs on the
  shrunken mesh and counts its sharded leaves; one process holds every
  leaf, so placement stays as it is.

When no fault plan is armed and every host is healthy, ``pulse`` is a
single branch — the train loop pays nothing in production.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import MeshConfig, RunConfig
from repro_torch.dist.compression import leaf_groups
from repro_torch.dist.sharding import param_specs
from repro_torch.resilience import faults
from repro_torch.resilience.faults import FaultError


class ClusterFailure(RuntimeError):
    """The cluster cannot continue (no surviving hosts to re-mesh over)."""


class PeerLossFault(FaultError):
    """One or more peers are confirmed lost; the mesh must shrink."""

    def __init__(self, hosts: Iterable[int], tick: int):
        self.hosts = frozenset(int(h) for h in hosts)
        self.tick = int(tick)
        RuntimeError.__init__(
            self, f"peer(s) {sorted(self.hosts)} confirmed lost at tick "
                  f"{self.tick}")
        self.point = "peer_loss"
        self.index = self.tick


# --------------------------------------------------------------------------
# failure-domain model


@dataclass(frozen=True)
class FailureDomains:
    """Hosts as failure domains over a mesh's ``data`` axis.

    Each host owns ``data_extent / num_hosts`` contiguous data-axis rows
    (all model/pod columns), so losing a host removes whole data-parallel
    replicas — the layout elastic DP shrinking assumes.
    """

    mesh: MeshConfig
    num_hosts: int

    def __post_init__(self):
        if self.num_hosts < 1:
            raise ValueError("need at least one host")
        if self.data_extent % self.num_hosts != 0:
            raise ValueError(
                f"data axis extent {self.data_extent} not divisible by "
                f"{self.num_hosts} hosts")

    @classmethod
    def from_mesh(cls, mesh: MeshConfig,
                  num_hosts: Optional[int] = None) -> "FailureDomains":
        """Default: one host per data-axis row (finest failure granularity
        that still shrinks cleanly)."""
        if num_hosts is None:
            try:
                num_hosts = mesh.shape[mesh.axes.index("data")]
            except ValueError:
                num_hosts = 1
        return cls(mesh=mesh, num_hosts=num_hosts)

    # ------------------------------------------------------------------
    @property
    def _data_dim(self) -> Optional[int]:
        return self.mesh.axes.index("data") if "data" in self.mesh.axes \
            else None

    @property
    def data_extent(self) -> int:
        d = self._data_dim
        return self.mesh.shape[d] if d is not None else 1

    @property
    def rows_per_host(self) -> int:
        return self.data_extent // self.num_hosts

    @property
    def devices_per_host(self) -> int:
        return self.mesh.num_devices // self.num_hosts

    @property
    def hosts(self) -> Tuple[int, ...]:
        return tuple(range(self.num_hosts))

    def host_of(self, device: int) -> int:
        """Failure domain of a flat (row-major over ``mesh.shape``) device."""
        d = self._data_dim
        if d is None:
            return 0
        coord = np.unravel_index(int(device), self.mesh.shape)[d]
        return int(coord) // self.rows_per_host

    def devices_of(self, host: int) -> List[int]:
        """Flat device indices owned by ``host`` (row-major order)."""
        grid = np.arange(self.mesh.num_devices).reshape(self.mesh.shape)
        d = self._data_dim
        if d is None:
            return list(range(self.mesh.num_devices)) if host == 0 else []
        lo = host * self.rows_per_host
        sel = [slice(None)] * len(self.mesh.shape)
        sel[d] = slice(lo, lo + self.rows_per_host)
        return [int(x) for x in grid[tuple(sel)].reshape(-1)]

    def surviving_devices(self, lost: Iterable[int]) -> List[int]:
        dead = set(int(h) for h in lost)
        out: List[int] = []
        for h in self.hosts:
            if h not in dead:
                out.extend(self.devices_of(h))
        return out

    def surviving_mesh(self, lost: Iterable[int]
                       ) -> Tuple[MeshConfig, "FailureDomains"]:
        """Shrink the data axis past the lost hosts; survivors re-number.

        Raises ``ClusterFailure`` when nothing survives (or the mesh has no
        data axis to shrink).
        """
        dead = set(int(h) for h in lost) & set(self.hosts)
        survivors = self.num_hosts - len(dead)
        if survivors < 1:
            raise ClusterFailure(
                f"all {self.num_hosts} host(s) lost — nothing to re-mesh")
        if not dead:
            return self.mesh, self
        d = self._data_dim
        if d is None:
            raise ClusterFailure(
                f"mesh {self.mesh.shape} has no data axis to shrink past "
                f"lost host(s) {sorted(dead)}")
        shape = list(self.mesh.shape)
        shape[d] = survivors * self.rows_per_host
        new_mesh = MeshConfig(shape=tuple(shape), axes=self.mesh.axes)
        return new_mesh, FailureDomains(mesh=new_mesh, num_hosts=survivors)


# --------------------------------------------------------------------------
# heartbeat-based peer health


@dataclass(frozen=True)
class HealthVerdict:
    tick: int
    suspect: FrozenSet[int]          # missed < confirm_misses beats
    confirmed_lost: FrozenSet[int]   # missed >= confirm_misses beats


class PeerHealthTracker:
    """Consecutive-missed-heartbeat counters per host.

    ``observe(beats, tick)`` folds one heartbeat interval: hosts absent from
    ``beats`` accrue a miss, hosts present reset to zero. A host is suspect
    from its first miss and confirmed lost after ``confirm_misses``
    consecutive misses — one late beat never evicts a peer.
    """

    def __init__(self, hosts: Iterable[int], *, confirm_misses: int = 2):
        self.confirm_misses = max(1, int(confirm_misses))
        self._missed: Dict[int, int] = {int(h): 0 for h in hosts}

    @property
    def hosts(self) -> Tuple[int, ...]:
        return tuple(sorted(self._missed))

    def forget(self, hosts: Iterable[int]) -> None:
        for h in hosts:
            self._missed.pop(int(h), None)

    def observe(self, beats: Iterable[int], tick: int) -> HealthVerdict:
        beats = set(int(b) for b in beats)
        suspect, lost = set(), set()
        for h in self._missed:
            if h in beats:
                self._missed[h] = 0
                continue
            self._missed[h] += 1
            if self._missed[h] >= self.confirm_misses:
                lost.add(h)
            else:
                suspect.add(h)
        return HealthVerdict(tick=int(tick), suspect=frozenset(suspect),
                             confirmed_lost=frozenset(lost))


# --------------------------------------------------------------------------
# cluster monitor (the trainer's per-step pulse)


class ClusterMonitor:
    """Simulated multi-host cluster: failure domains + peer health, fed by
    the ``peer_loss`` / ``peer_slow`` / ``mesh_partition`` fault points.

    ``pulse(tick)`` is called once per training step. Healthy hosts beat
    every pulse; a host hit by ``peer_loss`` (or on the far side of a
    ``mesh_partition``) never beats again, and one hit by ``peer_slow``
    misses that single beat. Once the tracker confirms a loss the pulse
    raises ``PeerLossFault`` — the trainer's tier-4 re-mesh arm takes over.
    """

    def __init__(self, domains: FailureDomains, *, confirm_misses: int = 2):
        self.domains = domains
        self.confirm_misses = confirm_misses
        self.tracker = PeerHealthTracker(domains.hosts,
                                         confirm_misses=confirm_misses)
        self._dead: set = set()

    @classmethod
    def from_mesh(cls, mesh: MeshConfig, *,
                  num_hosts: Optional[int] = None,
                  confirm_misses: int = 2) -> "ClusterMonitor":
        return cls(FailureDomains.from_mesh(mesh, num_hosts),
                   confirm_misses=confirm_misses)

    # ------------------------------------------------------------------
    @property
    def hosts(self) -> Tuple[int, ...]:
        return self.domains.hosts

    @property
    def healthy_hosts(self) -> Tuple[int, ...]:
        return tuple(h for h in self.hosts if h not in self._dead)

    @property
    def dead_hosts(self) -> FrozenSet[int]:
        return frozenset(self._dead)

    def pulse(self, tick: int) -> None:
        """One heartbeat interval; raises ``PeerLossFault`` on confirmed
        loss. Free when no chaos plan is armed and every host is healthy."""
        if not faults.active() and not self._dead:
            return
        spec = faults.check("peer_loss", tick)
        if spec is not None:
            self._dead.add(int(spec.host))
        spec = faults.check("mesh_partition", tick)
        if spec is not None:
            far = {h for h in self.hosts if h >= int(spec.host)}
            self._dead |= far
            obs.event("mesh_partition", tick=tick, cut=int(spec.host),
                      far_side=sorted(far))
        slow: set = set()
        spec = faults.check("peer_slow", tick)
        if spec is not None and int(spec.host) in set(self.hosts):
            slow.add(int(spec.host))
        beats = set(self.hosts) - self._dead - slow
        verdict = self.tracker.observe(beats, tick)
        for h in sorted(verdict.suspect):
            obs.metrics.counter("cluster_missed_beats_total", host=h).inc()
            obs.event("peer_slow", host=h, tick=tick,
                      delay_s=float(spec.delay) if spec is not None else 0.0)
        obs.metrics.gauge("cluster_healthy_hosts").set(
            len(self.hosts) - len(self._dead))
        if verdict.confirmed_lost:
            raise PeerLossFault(verdict.confirmed_lost, tick)

    def after_loss(self, lost: Iterable[int]) -> "ClusterMonitor":
        """The monitor for the re-meshed cluster: survivors only, counters
        reset (the new mesh starts from a clean bill of health). ``lost``
        is unioned with every host already known dead, so a second failure
        confirmed mid-re-mesh is never resurrected."""
        _, domains = self.domains.surviving_mesh(set(lost) | self._dead)
        return ClusterMonitor(domains, confirm_misses=self.confirm_misses)


# --------------------------------------------------------------------------
# serve-side replica health (request hedging)


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


# --------------------------------------------------------------------------
# re-sharding a restored TrainState onto the shrunken mesh


def reshard_state(state, run: RunConfig):
    """Derive every parameter's sharding spec for ``run.mesh`` and return
    ``(state, n_sharded)``: the state as it is and how many of the
    reference's leaves are sharded.

    The port runs in one process that holds every leaf, which is the
    reference's own path when it owns too few devices to build the mesh
    (its CPU test runs): placement stays as it is. The count is the
    reference's: its leaves stack a layer stack's layers
    (``dist.compression.leaf_groups``), so a group of port tensors counts
    once if any of them is sharded. The port's count could fall short of
    the reference's only through the FSDP-on-a-stack departure
    (``param_specs``) on a leaf that is otherwise replicated; no arch has
    one, at the production threshold or at smoke size.
    """
    cfg = run.model
    specs = param_specs(state.params, cfg, run.mesh, fsdp=run.fsdp,
                        fsdp_over_pods=run.fsdp_over_pods,
                        moe_full_ep=run.moe_full_ep,
                        parallelism=run.parallelism)
    groups = leaf_groups(specs, len(cfg.pattern))
    n_sharded = sum(1 for names in groups.values()
                    if any(e is not None for n in names for e in specs[n]))
    return state, n_sharded
