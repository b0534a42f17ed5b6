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
