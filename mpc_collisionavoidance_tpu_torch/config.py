"""Solver configuration (counterpart of the lane-engine part of
`mpc_collisionavoidance_tpu/config.py`).

`SolverConfig` holds the IPM schedule and backend of the lane engine.
`riccati` picks the IPM backend: "sweep" (eager iterations, one Riccati
sweep each; the production path) or "fused" (the whole fixed-sigma IPM in
one kernel).  The device of the solver's tensors picks kernels or plain
versions (the CUDA kernels for a CUDA device, their plain PyTorch versions
for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import check_schedule
from mpc_collisionavoidance_tpu_torch.solver.batch import LaneRTISolver


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    ipm_iters: int = 12
    ipm_tol: float = 1e-7
    riccati: str = "sweep"        # "sweep" | "fused" (whole-IPM kernel)
    centering: str = "fixed"      # "fixed" | "adaptive" | "mehrotra"
    mu0: object = 1.0             # initial barrier weight: float | "auto"
    extra_iters: int = 0          # stall-escalation budget: extra IPM
                                  # iterations run ONLY while some lane's
                                  # gap exceeds stall_tol
    stall_tol: Optional[float] = None  # escalation gate (None = dtype-
                                       # aware convergence tolerance)

    def __post_init__(self):
        check_schedule(self.riccati, self.centering, self.mu0,
                       self.extra_iters)

    def build(self, spec, *, device, dtype, capture=True):
        """Instantiate the lane engine for an OCPSpec on `device`/`dtype`
        (`capture`: `LaneRTISolver`'s)."""
        return LaneRTISolver(spec, **dataclasses.asdict(self),
                             device=device, dtype=dtype, capture=capture)


def production_engine() -> SolverConfig:
    """The production schedule, the same as the JAX package's
    `config.production_engine()` (`config.py:153-163`): adaptive centering,
    four fixed IPM iterations, then up to 24 escalation iterations while
    any lane's gap exceeds 3e-6; `mu0="auto"` (per-lane gradient-scaled,
    clipped to [1e-3, 1e6]); one tolerance, 3e-6, for both the status-0
    gate and the escalation target."""
    return SolverConfig(
        ipm_iters=4,
        ipm_tol=3e-6,
        extra_iters=24,
        stall_tol=3e-6,
        mu0="auto",
        centering="adaptive",
    )
