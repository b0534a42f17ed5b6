"""State carried across from the JAX package, as numpy only.

These take numpy arrays (for example a JAX `LaneQP._asdict()` or
`QPData._asdict()` mapped through `np.asarray`) and build the port's
tensors on a device and dtype: the lane engine's (`lane_*`) and the
per-instance engine's, whose shapes may carry leading batch axes, and the
guidance stack's mission, controller and fleet carries.
They never import jax, so the same QPs, LQRs, warm starts and
mid-mission states can be fed to both packages.
"""

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.guidance.controller import (
    GuidanceState, Measurements)
from mpc_collisionavoidance_tpu_torch.guidance.waypoints import MissionState
from mpc_collisionavoidance_tpu_torch.ops.ipm import QPData
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import LaneQP
from mpc_collisionavoidance_tpu_torch.ops.riccati import LQRData
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import LaneLQR
from mpc_collisionavoidance_tpu_torch.solver.batch import LaneState
from mpc_collisionavoidance_tpu_torch.sim.fleet import FleetState
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import SolverState


def _tensor(a, device, dtype):
    # a copy: arrays from jax are read-only
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def lane_state_from_numpy(xbar, ubar, *, device, dtype) -> LaneState:
    """xbar (nx, N+1, L), ubar (nu, N, L) -> LaneState."""
    return LaneState(xbar=_tensor(xbar, device, dtype),
                     ubar=_tensor(ubar, device, dtype))


def lane_qp_from_numpy(fields: dict, *, device, dtype) -> LaneQP:
    """A mapping of LaneQP field names to numpy arrays -> LaneQP, a
    partially condensed QP's 4-D cost blocks and `Dh`/`Ds` included.
    Fields that are None (or numpy's 0-d object array holding None) stay
    None."""
    out = {}
    for name in LaneQP._fields:
        v = fields.get(name)
        if v is not None and not (isinstance(v, np.ndarray)
                                  and v.dtype == object and v.ndim == 0
                                  and v.item() is None):
            out[name] = _tensor(v, device, dtype)
        else:
            out[name] = None
    missing = [n for n in LaneQP._fields
               if out[n] is None and n not in ("Dh", "Ds")]
    if missing:
        raise ValueError(f"lane_qp_from_numpy: missing fields {missing}")
    return LaneQP(**out)


def lane_lqr_from_numpy(A, B, c, Q, S, R, qx, qu, dx0, *, device,
                        dtype) -> LaneLQR:
    """The nine LaneLQR arrays (lane layout) -> LaneLQR."""
    return LaneLQR(*(_tensor(a, device, dtype)
                     for a in (A, B, c, Q, S, R, qx, qu, dx0)))


def solver_state_from_numpy(xbar, ubar, *, device, dtype) -> SolverState:
    """xbar (..., N+1, nx), ubar (..., N, nu) -> SolverState."""
    return SolverState(xbar=_tensor(xbar, device, dtype),
                       ubar=_tensor(ubar, device, dtype))


def qp_data_from_numpy(fields: dict, *, device, dtype) -> QPData:
    """A mapping of every QPData field name to a numpy array -> QPData."""
    missing = [n for n in QPData._fields if fields.get(n) is None]
    if missing:
        raise ValueError(f"qp_data_from_numpy: missing fields {missing}")
    return QPData(**{n: _tensor(fields[n], device, dtype)
                     for n in QPData._fields})


def lqr_data_from_numpy(A, B, c, Q, S, R, qx, qu, dx0, *, device,
                        dtype) -> LQRData:
    """The nine LQRData arrays (per-instance layout) -> LQRData."""
    return LQRData(*(_tensor(a, device, dtype)
                     for a in (A, B, c, Q, S, R, qx, qu, dx0)))


def mission_state_from_numpy(k, past_psied, active, *, device,
                             dtype) -> MissionState:
    """A mission carry (k int, past_psied, active bool; any batch shape)
    -> MissionState (k int32, past_psied in `dtype`, active bool)."""
    return MissionState(
        k=_tensor(k, device, torch.int32),
        past_psied=_tensor(past_psied, device, dtype),
        active=_tensor(active, device, torch.bool))


def guidance_state_from_numpy(mission, solver, psi_d_hold, r_d_hold, *,
                              device, dtype) -> GuidanceState:
    """A controller carry -> GuidanceState.  `mission`: the three mission
    arrays (k, past_psied, active), e.g. a JAX `MissionState` of numpy
    arrays; `solver`: the port's warm start of the controller's solver,
    from `solver_state_from_numpy` (RTISolver) or `lane_state_from_numpy`
    (LaneSolverAdapter, L = 1)."""
    return GuidanceState(
        mission=mission_state_from_numpy(*mission, device=device,
                                         dtype=dtype),
        solver=solver,
        psi_d_hold=_tensor(psi_d_hold, device, dtype),
        r_d_hold=_tensor(r_d_hold, device, dtype))


def fleet_state_from_numpy(mission_k, past_psied, active, xbar, ubar, meas,
                           *, device, dtype) -> FleetState:
    """A fleet carry -> FleetState: the (B,) mission arrays, the lane warm
    start xbar (nx, N+1, B), ubar (nu, N, B), and the five (B,)
    measurement arrays (u, v, nedx, nedy, psi)."""
    mission = mission_state_from_numpy(mission_k, past_psied, active,
                                       device=device, dtype=dtype)
    return FleetState(
        mission_k=mission.k, past_psied=mission.past_psied,
        active=mission.active,
        solver=lane_state_from_numpy(xbar, ubar, device=device, dtype=dtype),
        meas=Measurements(*(_tensor(m, device, dtype) for m in meas)))
