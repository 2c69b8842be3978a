"""Machine models: the H100 the port runs on + paper-analog hardware configs.

A copy of ``repro.perfmodel.machine``'s ``MachineConfig`` with the same
field names and execution models. The paper evaluates SeqPoint's
architecture-independence across five hardware configs (Table II: GCLK, CU
count, L1/L2 caches); the analogs scale the analytic machine terms of
config #1 as the JAX package scales its own: GCLK/CU -> peak FLOP/s,
caches -> effective HBM bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class MachineConfig:
    name: str
    peak_flops: float          # per device, in the type the steps run in
    hbm_bw: float              # bytes/s per device
    ici_bw: float              # bytes/s per link
    chips: int = 1

    def step_time(self, flops: float, bytes_hbm: float,
                  bytes_coll: float) -> float:
        """Roofline-max execution model (per-device quantities)."""
        return max(flops / self.peak_flops, bytes_hbm / self.hbm_bw,
                   bytes_coll / self.ici_bw)

    def step_time_sum(self, flops: float, bytes_hbm: float,
                      bytes_coll: float) -> float:
        """Pessimistic no-overlap model; brackets the truth with step_time."""
        return (flops / self.peak_flops + bytes_hbm / self.hbm_bw
                + bytes_coll / self.ici_bw)


# NVIDIA's H100 SXM5 data sheet (H100 80GB HBM3, 700 W). GNMT's and DS2's
# steps run in float32 with TF32 off, so the peak is the float32 rate
# outside the tensor cores, 67 TFLOP/s; HBM3 3.35 TB/s; NVLink 4 900 GB/s
# over 18 links. With the bf16 tensor-core peak (989 TFLOP/s) every SL of
# both networks comes out bytes-bound and the compute configs' speedups
# collapse to 1.
H100_SXM = MachineConfig("h100-sxm5-fp32", peak_flops=67e12,
                         hbm_bw=3.35e12, ici_bw=50e9)

# Paper Table II analogs (#1 is the reference config).
PAPER_CONFIGS: Dict[str, MachineConfig] = {
    "config1": H100_SXM,
    # GCLK 1.6 GHz -> 852 MHz: compute scales, memory system unchanged
    "config2": MachineConfig("gclk-0.53x", peak_flops=67e12 * 852 / 1600,
                             hbm_bw=3.35e12, ici_bw=50e9),
    # 64 CU -> 16 CU analog: quarter the compute units
    "config3": MachineConfig("cores-0.25x", peak_flops=67e12 / 4,
                             hbm_bw=3.35e12, ici_bw=50e9),
    # L1 off analog: effective bandwidth for reuse-heavy ops drops
    "config4": MachineConfig("l1-off", peak_flops=67e12,
                             hbm_bw=3.35e12 * 0.6, ici_bw=50e9),
    # L2 off analog: bandwidth-bound everywhere
    "config5": MachineConfig("l2-off", peak_flops=67e12,
                             hbm_bw=3.35e12 * 0.35, ici_bw=50e9),
}
