"""Model container: a continuous-time OCP model as pure functions + static data.

Counterpart of `mpc_collisionavoidance_tpu/models/base.py`.  `f` and `h`
are torch functions over tensors whose leading axis is the state/row axis
(components may be scalars or (N, L) lane tensors); Jacobians come from
`torch.func.jvp` on the CPU and from the CUDA form of the model
(`csrc/models/<name>.cuh`) on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

Array = np.ndarray
DynFn = Callable[..., object]  # f(x, u, p) -> xdot
ConFn = Callable[..., object]  # h(x, p) -> (nh,)


def _empty():
    return np.zeros((0,))


@dataclasses.dataclass(frozen=True)
class Model:
    """A continuous-time control model x' = f(x, u, p) with constraints h(x, p).

    Bounds follow the acados convention of index sets: `idxbx` selects the
    states boxed at the intermediate shooting nodes (stage 0 is pinned to
    the measured state by the solver).
    """

    name: str
    nx: int
    nu: int
    np_: int                      # number of runtime parameters (obstacle table)
    f: DynFn                      # continuous dynamics f(x, u, p) -> xdot
    x0: Array                     # default initial state
    state_names: Tuple[str, ...]
    control_names: Tuple[str, ...]
    # control box bounds (always present; +-inf when unbounded)
    lbu: Array = dataclasses.field(default_factory=_empty)
    ubu: Array = dataclasses.field(default_factory=_empty)
    idxbu: Array = dataclasses.field(default_factory=_empty)
    # state box bounds at intermediate stages
    lbx: Array = dataclasses.field(default_factory=_empty)
    ubx: Array = dataclasses.field(default_factory=_empty)
    idxbx: Array = dataclasses.field(default_factory=_empty)
    # nonlinear constraints h(x, p) with lh <= h <= uh
    h: Optional[ConFn] = None
    nh: int = 0
    lh: Array = dataclasses.field(default_factory=_empty)
    uh: Array = dataclasses.field(default_factory=_empty)
    # structural input sparsity: indices of (x, u) coordinates f reads and
    # of x coordinates h reads (None = dense).  Skipped Jacobian columns
    # are exact identity (states) or zero (controls / h columns).
    f_dep: Optional[Tuple[int, ...]] = None
    h_dep: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.state_names) != self.nx:
            raise ValueError(f"{self.name}: {len(self.state_names)} state "
                             f"names for nx={self.nx}")
        if len(self.control_names) != self.nu:
            raise ValueError(f"{self.name}: {len(self.control_names)} "
                             f"control names for nu={self.nu}")
        if self.x0.shape != (self.nx,):
            raise ValueError(f"{self.name}: x0 shape {self.x0.shape}")
        if self.h is not None and self.nh <= 0:
            raise ValueError(f"{self.name}: h given with nh={self.nh}")


@dataclasses.dataclass(frozen=True)
class TrackModel(Model):
    """A model whose f reads a track's curvature table (the race car on a
    curved track).  It carries the table itself, besides the interpolant
    that f closes over, so that the linearization kernel receives it as
    an argument: `kapparef` holds the uniform samples of kappa(s) over
    one lap of `track_length` (`utils/track.py`)."""

    kapparef: Optional[Array] = None
    track_length: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        if self.kapparef is None or self.kapparef.ndim != 1 or \
                self.track_length <= 0.0:
            raise ValueError(f"{self.name}: a curvature table (M,) and a "
                             f"positive track length are required")
        # the table's copies on devices, made at first use (not a field)
        object.__setattr__(self, "_tables", {})

    def kappa_table(self, device, dtype):
        """`kapparef` as a tensor on `device` in `dtype`, copied there once
        (a tick on the card reads it without a host-to-device copy)."""
        key = (str(device), dtype)
        if key not in self._tables:
            import torch
            self._tables[key] = torch.as_tensor(self.kapparef, dtype=dtype,
                                                device=device)
        return self._tables[key]
