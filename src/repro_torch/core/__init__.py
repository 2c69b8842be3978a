"""SeqPoint — selection, projection and the wallclock profiler (port)."""
from repro_torch.core.profile import EpochLog, IterationRecord, SLTable
from repro_torch.core.seqpoint import SeqPoint, SeqPointSet, select_seqpoints
from repro_torch.core.baselines import (
    ALL_BASELINES,
    frequent,
    median,
    prior,
    worst,
)
from repro_torch.core.clustering import kmeans_seqpoints
from repro_torch.core.characterize import (
    WallclockProvider,
    epoch_log_from_plan,
    profiling_cost,
    project_on_config,
)

__all__ = [
    "ALL_BASELINES", "EpochLog", "IterationRecord", "SLTable", "SeqPoint",
    "SeqPointSet", "WallclockProvider", "epoch_log_from_plan", "frequent",
    "kmeans_seqpoints", "median", "prior", "profiling_cost",
    "project_on_config", "select_seqpoints", "worst",
]
