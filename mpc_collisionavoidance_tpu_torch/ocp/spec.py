"""Optimal-control-problem specification.

Carries the information content of the reference's per-variant
``acados_settings.py`` files (e.g. reference
scripts/usv_guidance_ca1/acados_settings.py:42-209): LINEAR_LS cost
selection matrices and weights, box bounds, nonlinear constraint softening
(zl/Zl/zu/Zu slack penalties with lsh/ush slack bounds), horizon and
discretization — as a plain frozen dataclass of numpy arrays.  A copy of
`mpc_collisionavoidance_tpu/ocp/spec.py` (pure numpy): the solver moves
the static blocks it needs to its device once, at construction.

acados semantics faithfully reproduced here:

- **cost scaling**: acados multiplies each path stage cost (including slack
  penalties) by the shooting-interval length dt = Tf/N and the terminal cost
  by 1.  The reference's commented-out ``unscale = N / Tf`` (reference
  scripts/usv_guidance_ca1/acados_settings.py:85-88) exists to cancel exactly
  that scaling and is *not* applied, so the effective weights are dt-scaled.
  `cost_scaling="dt"` reproduces this; `"none"` gives the raw discrete sum.
- **soft constraints**: a softened row i of h relaxes lh <= h <= uh to
  h + sl >= lh, h - su <= uh with slack bounds sl >= lsh, su >= ush and cost
  zl*sl + 0.5*Zl*sl^2 (+ upper analog).  With the flagship numbers
  (zl=zu=1, Zl=Zu=0, lsh=-0.2, ush=0; reference acados_settings.py:105-108,
  154-178) this is an exact-penalty band that starts charging 0.2 m *before*
  the constraint boundary — the 0.2 m "safety band" of
  src/nmpc_guidance_ca1.cpp:142.
- **stage applicability**: h and the intermediate box bounds apply at stages
  0..N-1 (no terminal h / terminal box is defined anywhere in the reference);
  stage 0's state is pinned (lbx0 = ubx0 = x0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mpc_collisionavoidance_tpu_torch.models.base import Model


@dataclasses.dataclass(frozen=True)
class LinearLSCost:
    """LINEAR_LS cost: 0.5*||Vx x + Vu u - yref||^2_W per path stage,
    0.5*||Vx_e x - yref_e||^2_We terminal."""

    Vx: np.ndarray      # (ny, nx)
    Vu: np.ndarray      # (ny, nu)
    W: np.ndarray       # (ny, ny)
    yref: np.ndarray    # (ny,) default reference
    Vx_e: np.ndarray    # (ny_e, nx)
    W_e: np.ndarray     # (ny_e, ny_e)
    yref_e: np.ndarray  # (ny_e,)

    @property
    def ny(self) -> int:
        return self.W.shape[0]

    @property
    def ny_e(self) -> int:
        return self.W_e.shape[0]


@dataclasses.dataclass(frozen=True)
class SoftPenalty:
    """Slack penalties for the softened h rows (acados zl/Zl/zu/Zu/lsh/ush)."""

    idxsh: np.ndarray  # indices of softened h rows, (ns,)
    zl: np.ndarray     # linear lower-slack weight, (ns,)
    Zl: np.ndarray     # quadratic lower-slack weight, (ns,)
    zu: np.ndarray
    Zu: np.ndarray
    lsh: np.ndarray    # lower bound on lower slack, (ns,)
    ush: np.ndarray    # lower bound on upper slack, (ns,)

    @property
    def ns(self) -> int:
        return len(self.idxsh)


@dataclasses.dataclass(frozen=True)
class SoftBoxPenalty:
    """Soft state-box rows (acados idxsbx/lsbx/usbx semantics, used by the
    reference's race_cars dev variant, scripts/race_cars/
    acados_settings_dev.py:32-85): row i softens state-box row idxsbx[i]
    (an index into model.idxbx), relaxing lbx <= x <= ubx with slacks
    bounded below by lsbx/usbx and penalized with zl/Zl/zu/Zu."""

    idxsbx: np.ndarray  # indices into model.idxbx, (nsbx,)
    zl: np.ndarray      # (nsbx,)
    Zl: np.ndarray
    zu: np.ndarray
    Zu: np.ndarray
    lsbx: np.ndarray    # lower bound on lower slack, (nsbx,)
    usbx: np.ndarray    # lower bound on upper slack, (nsbx,)

    @property
    def nsbx(self) -> int:
        return len(self.idxsbx)


@dataclasses.dataclass(frozen=True)
class OCPSpec:
    model: Model
    N: int                      # number of shooting intervals
    Tf: float                   # horizon length [s]
    cost: LinearLSCost
    soft: Optional[SoftPenalty] = None
    soft_bx: Optional[SoftBoxPenalty] = None
    cost_scaling: str = "dt"    # "dt" (acados default) or "none"
    integrator_steps: int = 1   # RK4 substeps per interval (acados default 1)

    @property
    def dt(self) -> float:
        return self.Tf / self.N

    @property
    def stage_scale(self) -> float:
        """Multiplier applied to path-stage cost (incl. slack penalties)."""
        return self.dt if self.cost_scaling == "dt" else 1.0

    def __post_init__(self):
        m = self.model
        assert self.cost.Vx.shape[1] == m.nx
        assert self.cost.Vu.shape[1] == m.nu
        if self.soft is not None:
            assert m.h is not None
            assert np.all(self.soft.idxsh < m.nh)
        if self.soft_bx is not None:
            assert np.all(self.soft_bx.idxsbx < len(np.atleast_1d(m.idxbx)))

    # ---- convenience: partition of h rows into hard and soft ----
    def hard_h_rows(self) -> np.ndarray:
        if self.model.h is None:
            return np.zeros((0,), dtype=np.int64)
        all_rows = np.arange(self.model.nh)
        if self.soft is None:
            return all_rows
        return np.setdiff1d(all_rows, self.soft.idxsh)
