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

`FrameworkConfig` is the experiment config of the command line (`cli.py
run --config`): model, horizon and solver, to and from plain dicts (JSON).
A user's experiment JSON is shared with the JAX package:
`FrameworkConfig.from_dict` also reads every dict that the JAX
`FrameworkConfig.to_dict()` writes, which carries keys and backend names
that the port does not have:

    JAX key            JAX value                     port
    solver.riccati     "lax", "pallas",              "sweep" (the instance
                       "pallas_interpret"            engine: "lax" only)
                       "fused", "fused_interpret"    "fused"
                       "pscan"                       "pscan"
    solver.linearize   "lax", "pallas",              dropped (the device
                       "pallas_interpret"            picks kernel or plain)
    solver.dtype       "float32", "float64"          dropped (the command
                                                     picks it, as JAX's does)
    parallel           {"n_devices", "axis_name",    dropped (the port's
                        "batch_per_device"}          mesh spans every rank,
                                                     on one "dp" axis:
                                                     `parallel/`)

A dropped value is checked as JAX checks it, and a riccati name as
`SolverConfig` checks the port's (an unknown one, or another than "lax" on
the instance engine, raises JAX's message).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from mpc_collisionavoidance_tpu_torch.models import registry
from mpc_collisionavoidance_tpu_torch.ocp import builders
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
        if self.engine == "instance" and self.riccati != "sweep":
            raise ValueError(f"{self.riccati} riccati requires the lane "
                             "engine")
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
            if self.qp_backend == "dense" and self.centering != "fixed":
                raise ValueError("mehrotra centering is implemented on the "
                                 "riccati QP backend only")
        elif self.qp_backend != "riccati":
            raise ValueError("the dense QP backend requires the instance "
                             "engine")

    def build(self, spec, *, device, dtype, capture=True, group=None):
        """Instantiate the configured engine for an OCPSpec on
        `device`/`dtype`.  `capture`: both engines' switch (on a CUDA
        device each tick replays a captured graph; False runs it op by
        op).  `group`: `LaneRTISolver`'s; the instance engine takes none
        and is sharded by `parallel.make_sharded_batch_solver`."""
        if self.engine == "instance":
            if group is not None:
                raise ValueError("the instance engine takes no process "
                                 "group: shard its batch with parallel."
                                 "make_sharded_batch_solver")
            return RTISolver(spec, ipm_iters=self.ipm_iters,
                             ipm_tol=self.ipm_tol,
                             qp_backend=self.qp_backend,
                             centering=self.centering, mu0=self.mu0,
                             device=device, dtype=dtype, capture=capture)
        return LaneRTISolver(spec, ipm_iters=self.ipm_iters,
                             ipm_tol=self.ipm_tol, riccati=self.riccati,
                             centering=self.centering, mu0=self.mu0,
                             extra_iters=self.extra_iters,
                             stall_tol=self.stall_tol, device=device,
                             dtype=dtype, capture=capture, group=group)


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


# the JAX package's riccati backend names (its `config.py:60-63`) and the
# port's own, each onto the port's backend; the instance engine maps only
# "lax", so that SolverConfig refuses JAX's other names there
_RICCATI = {"lax": "sweep", "pallas": "sweep", "pallas_interpret": "sweep",
            "fused": "fused", "fused_interpret": "fused", "pscan": "pscan"}
_JAX_LINEARIZE = ("lax", "pallas", "pallas_interpret")
_JAX_DTYPES = ("float32", "float64")
_JAX_PARALLEL = ("n_devices", "axis_name", "batch_per_device")


def _solver_from_dict(d: Dict[str, Any]) -> SolverConfig:
    """A port `SolverConfig` from the port's or the JAX package's solver
    dict (the module docstring's table)."""
    d = dict(d)
    linearize = d.pop("linearize", "lax")
    if linearize not in _JAX_LINEARIZE:
        raise ValueError(f"unknown linearize backend '{linearize}'")
    if d.get("engine") == "instance" and linearize != "lax":
        raise ValueError("pallas linearize requires the lane engine")
    dtype = d.pop("dtype", "float32")
    if dtype not in _JAX_DTYPES:
        raise ValueError(f"unknown dtype '{dtype}'")
    if "riccati" in d:
        names = ({"lax": "sweep"} if d.get("engine") == "instance"
                 else _RICCATI)
        d["riccati"] = names.get(d["riccati"], d["riccati"])
    return SolverConfig(**d)


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """Top-level config: model + horizon + solver."""
    model: str = "usv_guidance_ca1"
    N: int = 100
    Tf: float = 5.0
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)

    def __post_init__(self):
        known = sorted(set(registry.names()) | set(builders.BUILDERS))
        if self.model not in known:
            raise ValueError(
                f"unknown model '{self.model}'; known: {known}")
        if self.N < 1 or self.Tf <= 0:
            raise ValueError(f"bad horizon N={self.N}, Tf={self.Tf}")

    def build_spec(self):
        return builders.build(self.model, Tf=self.Tf, N=self.N)

    def build_solver(self, *, device, dtype, capture=True):
        """Instantiate the configured solver engine for this OCP on
        `device`/`dtype` (`SolverConfig.build`, `capture` its switch)."""
        return self.solver.build(self.build_spec(), device=device,
                                 dtype=dtype, capture=capture)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FrameworkConfig":
        """From the port's `to_dict()` or the JAX package's (the module
        docstring's table)."""
        d = dict(d)
        if isinstance(d.get("solver"), dict):
            d["solver"] = _solver_from_dict(d["solver"])
        unknown = set(d.pop("parallel", None) or ()) - set(_JAX_PARALLEL)
        if unknown:
            raise ValueError(f"unknown parallel keys {sorted(unknown)}")
        return cls(**d)
