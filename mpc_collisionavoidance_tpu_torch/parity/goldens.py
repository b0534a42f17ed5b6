"""Golden closed-loop trajectory fixtures, recomputed by the port
(counterpart of `mpc_collisionavoidance_tpu/parity/goldens.py`).

The committed float64 fixtures `tests/goldens/*.npz` were made by the JAX
package's per-instance engine at the full reference scale (N=100, the
reference scenarios), in the reference's solver-as-plant idiom (x0 <- the
stage-1 prediction).  Two families per variant:

- **converged-SQP** (`<name>.npz`): `sqp_iters` re-linearizations per
  tick — a property of the problem;
- **RTI-schedule** (`<name>__rti.npz`): one linearization, one QP and a
  full step per tick, warm-started — the production schedule.

This module reads them with numpy and recomputes their prefixes with the
port's `RTISolver` on a chosen device; it never writes them (they stay the
JAX package's to regenerate).
"""

import os
from typing import NamedTuple

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
from mpc_collisionavoidance_tpu_torch.utils import track as trk

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                          "tests", "goldens")

# variant -> (scenario factory name, ticks, sqp_iters).  `None` keeps the
# fixture's original hand-built inputs; "__race__" is the synthetic-track
# race car (special-cased below)
GOLDEN_RUNS = {
    "usv_guidance_ca1": ("guidance_ca1_default", 1000, 10),
    "usv_pf_ca": ("pf_ca_default", 1000, 10),
    "usv_guidance": (None, 600, 10),
    "usv_guidance2": (None, 600, 10),
    "usv_pf": ("pf_default", 600, 10),
    "usv_guidance_ca": ("guidance_ca_default", 600, 10),
    "usv_acados": ("acados_speed_default", 400, 10),
    "usv_low_level": ("low_level_default", 400, 10),
    "usv_position_control": ("position_control_default", 400, 10),
    "usv_guidance3": ("guidance3_default", 600, 10),
    "usv_guidance4": ("guidance4_default", 400, 10),
    "usv_guidance5": ("guidance5_default", 400, 10),
    "race_cars": ("__race__", 400, 10),
}

# variant -> (ticks, ipm_iters) of the RTI-schedule fixtures; scenario
# resolution is shared with GOLDEN_RUNS
RTI_GOLDEN_RUNS = {
    "usv_guidance_ca1": (1000, 18),
    "usv_pf_ca": (1000, 18),
    "usv_guidance": (400, 18),
    "usv_guidance2": (400, 18),
    "usv_pf": (400, 18),
    "usv_guidance_ca": (400, 18),
    "usv_acados": (400, 18),
    "usv_low_level": (400, 18),
    "usv_position_control": (400, 18),
    "usv_guidance3": (400, 18),
    "usv_guidance4": (400, 18),
    "usv_guidance5": (400, 18),
    "race_cars": (400, 18),
}

# per-variant solver options of BOTH fixture families: usv_position_control's
# 1e5-scale weights need Mehrotra with gradient-scaled mu0, usv_guidance_ca's
# hard rows Mehrotra; everything else uses the engine defaults
SOLVER_OPTS = {
    "usv_position_control": {"centering": "mehrotra", "mu0": "auto"},
    "usv_guidance_ca": {"centering": "mehrotra"},
}


class GoldenRun(NamedTuple):
    simX: np.ndarray    # (ticks, nx) measured state per tick
    simU: np.ndarray    # (ticks, nu) applied input per tick
    status: np.ndarray  # (ticks,)


def _scenario_inputs(name, spec, m):
    """Shared scenario resolution of both families, as numpy:
    (x0, params, lh, yref, yref_e); lh, yref, yref_e may be None."""
    factory, _, _ = GOLDEN_RUNS.get(name, (None, None, None))
    if factory == "__race__":
        # static inputs only: the receding progress reference is a
        # per-tick yref_fn (see _race_yref_fn)
        return np.asarray(m.x0, float), np.zeros(0), None, None, None
    if factory is not None:
        sc = getattr(scenarios, factory)()
        params = sc.params if np.size(sc.params) else np.zeros(m.np_)
        lh = sc.lh if np.size(sc.lh) else None
        yref = None if sc.yref is None else np.tile(
            np.asarray(sc.yref, float), (spec.N, 1))
        yref_e = None if sc.yref_e is None else np.asarray(sc.yref_e, float)
        return sc.x0, params, lh, yref, yref_e
    if name in ("usv_guidance", "usv_guidance2"):
        # the reference sims' start values (scripts/usv_guidance/main.py:
        # 87-108, scripts/usv_guidance2/main.py:88-120): u = 0.5, segment
        # (3,-5) -> (10,5), yref tracks (sin ak, cos ak)
        seg = np.array([3.0, -5.0, 10.0, 5.0])
        ak = float(np.arctan2(seg[3] - seg[1], seg[2] - seg[0]))
        ye0 = float(-(0.0 - seg[0]) * np.sin(ak)
                    + (0.0 - seg[1]) * np.cos(ak))
        if name == "usv_guidance":
            x0 = np.array([0, 0, 0, 0, 1.0, 0.5, 0, ye0, ak, 0.0])
        else:
            x0 = np.array([0, 0, 0, 0, 1.0, 0.5, 0, 0, ye0, ak, 0.0, 0.0])
        yvec = np.zeros(spec.cost.ny)
        yvec[3], yvec[4] = np.sin(ak), np.cos(ak)
        return (x0, np.zeros(0), None, np.tile(yvec, (spec.N, 1)),
                yvec[:m.nx].copy())
    x0 = np.asarray(m.x0, float)
    params = np.full(m.np_, 100.0) if m.np_ else np.zeros(0)
    return x0, params, None, None, None


def _build_spec(name: str):
    if name == "race_cars":
        return builders.build("race_cars", track=trk.make_synthetic_track())
    return builders.build(name)


def _race_yref_fn(spec):
    """The reference's receding progress reference: s ramps from the
    current s0 to s0 + 3 across the horizon each tick (reference
    scripts/race_cars/main.py:74-83)."""
    ny, nx, N = spec.cost.ny, spec.model.nx, spec.N

    def yref_fn(x):
        s0 = x[0]
        opts = dict(dtype=x.dtype, device=x.device)
        yref = torch.zeros((N, ny), **opts)
        yref[:, 0] = s0 + 3.0 * torch.arange(N, **opts) / N
        yref_e = torch.zeros(nx, **opts)
        yref_e[0] = s0 + 3.0
        return yref, yref_e

    return yref_fn


def _closed_loop(name, ticks, solver, advance):
    """The solver-as-plant loop of `name` for `ticks` ticks, float64;
    `advance(state, x, params, lh, yref, yref_e) -> (state, out)` is one
    tick of the schedule.  The per-tick records stay on the device until
    the end."""
    spec = solver.spec
    x0, params, lh, yref, yref_e = _scenario_inputs(name, spec, spec.model)
    yref_fn = _race_yref_fn(spec) if name == "race_cars" else None
    t = solver._tensor
    params, lh = t(params), None if lh is None else t(lh)
    yref = None if yref is None else t(yref)
    yref_e = None if yref_e is None else t(yref_e)
    st = solver.init_state(x0)
    x = t(x0)
    xs, us, stats = [], [], []
    for _ in range(ticks):
        yref_k, yref_e_k = (yref, yref_e) if yref_fn is None else yref_fn(x)
        st, out = advance(st, x, params, lh, yref_k, yref_e_k)
        xs.append(x)
        us.append(out.u0)
        stats.append(out.status)
        x = out.x1
    return GoldenRun(simX=torch.stack(xs).cpu().numpy(),
                     simU=torch.stack(us).cpu().numpy(),
                     status=torch.stack(stats).cpu().numpy())


def compute_golden(name: str, ticks: int, sqp_iters: int = 10, *,
                   device, capture: bool = True) -> GoldenRun:
    """The float64 converged-SQP closed loop of `name` on `device`:
    `sqp_iters` full-step SQP iterations per tick, 30 IPM iterations at
    tol 1e-10 (`capture`: `RTISolver`'s)."""
    solver = RTISolver(_build_spec(name), ipm_iters=30, ipm_tol=1e-10,
                       **SOLVER_OPTS.get(name, {}), device=device,
                       dtype=torch.float64, capture=capture)

    def advance(st, x, params, lh, yref, yref_e):
        return solver.solve_converged(st, x, params, lh, yref, yref_e,
                                      sqp_iters=sqp_iters)

    return _closed_loop(name, ticks, solver, advance)


def compute_golden_rti(name: str, ticks: int, ipm_iters: int = 18, *,
                       device, capture: bool = True) -> GoldenRun:
    """The float64 production RTI schedule of `name` on `device`: one
    linearization, one QP and a full step per tick, warm-started
    (`capture`: `RTISolver`'s)."""
    solver = RTISolver(_build_spec(name), ipm_iters=ipm_iters,
                       **SOLVER_OPTS.get(name, {}), device=device,
                       dtype=torch.float64, capture=capture)
    return _closed_loop(name, ticks, solver, solver.step_fn)


def golden_path(name: str, schedule: str = "sqp") -> str:
    suffix = "" if schedule == "sqp" else f"__{schedule}"
    return os.path.abspath(os.path.join(GOLDEN_DIR, f"{name}{suffix}.npz"))


def load_golden(name: str, schedule: str = "sqp") -> GoldenRun:
    with np.load(golden_path(name, schedule)) as z:
        return GoldenRun(simX=z["simX"], simU=z["simU"], status=z["status"])
