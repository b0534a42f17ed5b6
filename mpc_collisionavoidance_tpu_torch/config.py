"""Solver configuration (counterpart of the solver part of
`mpc_collisionavoidance_tpu/config.py`).

`SolverConfig` holds the engine, its IPM schedule and its backend.
`engine` picks the engine: "lane" (`LaneRTISolver`, the production tick,
the instance axis minor-most) or "instance" (`RTISolver`, the per-instance
engine with leading batch axes).  `riccati` picks the lane engine's IPM
backend: "sweep" (eager iterations, one Riccati sweep each; the production
path), "pscan" (the same with the parallel-scan Riccati) or "fused" (the
whole fixed-sigma IPM in one kernel).  `qp_backend`
picks the instance engine's QP engine: "riccati" or "dense" (full
condensing).  The device of the solver's tensors picks kernels or plain
versions (the CUDA kernels for a CUDA device, their plain PyTorch versions
for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import check_schedule
from mpc_collisionavoidance_tpu_torch.solver.batch import LaneRTISolver
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver


def require_device(device) -> torch.device:
    """`device` as a torch.device; raise ValueError for a CUDA device on a
    host that has none (an entry point never runs on the CPU instead)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"device '{device}': this host has no CUDA device "
                         "(torch.cuda.is_available() is False)")
    return device


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    engine: str = "lane"          # "lane" (throughput) | "instance"
    ipm_iters: int = 12
    ipm_tol: float = 1e-7
    riccati: str = "sweep"        # lane engine: "sweep" | "pscan" |
                                  # "fused" (whole-IPM kernel)
    qp_backend: str = "riccati"   # instance engine: "riccati" | "dense"
                                  # (full condensing, the qpOASES role)
    centering: str = "fixed"      # "fixed" | "adaptive" (lane engine) |
                                  # "mehrotra"
    mu0: object = 1.0             # initial barrier weight: float | "auto"
    extra_iters: int = 0          # lane engine: stall-escalation budget:
                                  # extra IPM iterations run ONLY while
                                  # some lane's gap exceeds stall_tol
    stall_tol: Optional[float] = None  # escalation gate (None = dtype-
                                       # aware convergence tolerance)

    def __post_init__(self):
        if self.engine not in ("lane", "instance"):
            raise ValueError(f"unknown engine '{self.engine}'")
        if self.qp_backend not in ("riccati", "dense"):
            raise ValueError(f"unknown qp_backend '{self.qp_backend}'")
        check_schedule(self.riccati, self.centering, self.mu0,
                       self.extra_iters)
        if self.engine == "instance":
            if self.centering == "adaptive":
                raise ValueError("adaptive centering is lane-engine-only; "
                                 "the instance engine supports "
                                 "fixed/mehrotra")
            if self.extra_iters:
                raise ValueError("stall escalation (extra_iters > 0) is "
                                 "lane-engine-only")
            if self.riccati != "sweep":
                raise ValueError(f"riccati='{self.riccati}' requires the "
                                 "lane engine")
            if self.qp_backend == "dense" and self.centering != "fixed":
                raise ValueError("mehrotra centering is implemented on the "
                                 "riccati QP backend only")
        elif self.qp_backend != "riccati":
            raise ValueError("the dense QP backend requires the instance "
                             "engine")

    def build(self, spec, *, device, dtype, capture=True):
        """Instantiate the configured engine for an OCPSpec on
        `device`/`dtype` (`capture`: `LaneRTISolver`'s; the instance
        engine runs op by op)."""
        if self.engine == "instance":
            return RTISolver(spec, ipm_iters=self.ipm_iters,
                             ipm_tol=self.ipm_tol,
                             qp_backend=self.qp_backend,
                             centering=self.centering, mu0=self.mu0,
                             device=device, dtype=dtype)
        return LaneRTISolver(spec, ipm_iters=self.ipm_iters,
                             ipm_tol=self.ipm_tol, riccati=self.riccati,
                             centering=self.centering, mu0=self.mu0,
                             extra_iters=self.extra_iters,
                             stall_tol=self.stall_tol, device=device,
                             dtype=dtype, capture=capture)


def production_engine() -> SolverConfig:
    """The production schedule, the same as the JAX package's
    `config.production_engine()` (`config.py:153-163`): the lane engine,
    adaptive centering, four fixed IPM iterations, then up to 24
    escalation iterations while any lane's gap exceeds 3e-6;
    `mu0="auto"` (per-lane gradient-scaled, clipped to [1e-3, 1e6]); one
    tolerance, 3e-6, for both the status-0 gate and the escalation
    target."""
    return SolverConfig(
        ipm_iters=4,
        ipm_tol=3e-6,
        extra_iters=24,
        stall_tol=3e-6,
        mu0="auto",
        centering="adaptive",
    )
