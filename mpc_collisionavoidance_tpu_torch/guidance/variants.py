"""Per-variant guidance node behavior: the non-CA1 guidance controllers
(counterpart of `mpc_collisionavoidance_tpu/guidance/variants.py`).

The reference builds five separate C++ nodes (nmpc_guidance .. guidance5,
SURVEY.md N10-N14) that differ only in how measurements pack into x0 and
which stage/state the published commands come from.  Here that variation is
a declarative IO table over ONE controller class, sharing the waypoint
manager with the flagship.  Behavior per node (all cited to
catkin_ws/src/nmpc_ca/src/):

- usv_guidance  (nmpc_guidance.cpp:256-317): packs pose + (sin, cos)psi +
  u, v + ye + ak + carried psid; publishes psi_d = x1[psid] (absolute —
  ak is a state of this model).
- usv_guidance2 (nmpc_guidance2.cpp:263-340): + r and carried rd;
  publishes psi_d = x2[psid] (stage TWO) and r_d = x1[rd].
- usv_guidance3 (nmpc_guidance3.cpp:266-332): course-angle model, carries
  rd only; publishes r_d = x1[rd] (no heading output).
- usv_guidance4 (nmpc_guidance4.cpp:243-287): 4-state error model with
  crab-angle chie packing; the INPUT is psi_e_d, so psi_d = u0 + ak
  wrapped; no command memory.
- usv_guidance5 (nmpc_guidance5.cpp:252-303): + carried psied state;
  psi_d = x1[psied] + ak wrapped, r_d = u0 (psi_e_d rate).
- usv_guidance_ca (nmpc_guidance_ca.cpp:256-341, SURVEY.md N15): the first
  CA guidance node — 9-state jerk-level model; psi_d = x[STAGE 2][psied]
  + ak wrapped (:319-322), command memory ALSO from stage 2 (:328);
  obstacle params stay at the builder's far-away default because the node
  never calls acados_update_params (default p = 100 from
  scripts/usv_guidance_ca/acados_settings.py:156); the psieddot state is
  packed from `past_psieddot`, which is initialized to 0 and never written
  after a solve (:169 vs :328) — so it is constant 0, reproduced here;
  psied memory is re-seeded to wrap(psi - ak) on a new mission (:361-366).

The world-layout nodes push a per-stage reference, so every variant runs
on the per-instance engine (`RTISolver`).
"""

import dataclasses
from typing import NamedTuple, Optional

import torch

from mpc_collisionavoidance_tpu_torch.config import require_device
from mpc_collisionavoidance_tpu_torch.guidance.controller import stack_last
from mpc_collisionavoidance_tpu_torch.guidance.nodes import stage_refs
from mpc_collisionavoidance_tpu_torch.guidance.waypoints import (
    MissionState, mission_init, waypoint_manager)
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import (RTISolver,
                                                             SolverState)
from mpc_collisionavoidance_tpu_torch.utils.angles import wrap_once


@dataclasses.dataclass(frozen=True)
class _IO:
    """How a variant packs x0 and extracts commands (indices into the
    model's state vector; see models/variants.py state_names)."""
    pose_layout: str          # "world" (nedx..ak states) | "error" (u,v,ye,chie..)
                              # | "error_ca" (error + NED pose, guidance_ca)
    mem_idx: tuple            # state indices carried across ticks
    heading_src: Optional[tuple]  # ("x", stage, idx, add_ak) | ("u", 0, idx, add_ak) | None
    rate_src: Optional[tuple]     # same encoding | None
    uses_r: bool = False      # packs the yaw-rate measurement
    mem_stage: int = 1        # stage the command memory is read from
    far_params: bool = False  # obstacle params at the 100.0 far sentinel
    seed_mem: bool = False    # mem[0] <- wrap(psi - ak) on mission seed


_TABLE = {
    "usv_guidance": _IO("world", (9,), ("x", 1, 9, False), None),
    "usv_guidance2": _IO("world", (10, 11), ("x", 2, 10, False),
                         ("x", 1, 11, False), uses_r=True),
    "usv_guidance3": _IO("world", (10,), None, ("x", 1, 10, False),
                         uses_r=True),
    "usv_guidance4": _IO("error", (), ("u", 0, 0, True), None),
    "usv_guidance5": _IO("error", (4,), ("x", 1, 4, True), ("u", 0, 0, False)),
    "usv_guidance_ca": _IO("error_ca", (4,), ("x", 2, 4, True), None,
                           mem_stage=2, far_params=True, seed_mem=True),
}


class VariantMeasurements(NamedTuple):
    """INS feedback incl. yaw rate (guidance2/3 subscribe to it)."""
    u: torch.Tensor
    v: torch.Tensor
    r: torch.Tensor
    nedx: torch.Tensor
    nedy: torch.Tensor
    psi: torch.Tensor


class VariantCommands(NamedTuple):
    psi_d: torch.Tensor     # NaN-free; holds previous when variant has none
    r_d: torch.Tensor
    u_d: torch.Tensor
    ye: torch.Tensor
    active: torch.Tensor
    solver_status: torch.Tensor


class VariantState(NamedTuple):
    mission: MissionState
    solver: SolverState
    memory: torch.Tensor    # (..., slots) carried command-state values
    psi_d_hold: torch.Tensor
    r_d_hold: torch.Tensor


class VariantGuidanceController:
    """Any of the table's guidance nodes, selected by model name."""

    def __init__(self, name: str, Tf: Optional[float] = None,
                 N: Optional[int] = None, ipm_iters: int = 10, *,
                 device="cuda", dtype=torch.float32):
        """Builds the model's OCP (builder defaults unless `Tf`/`N`) and an
        `RTISolver` with `ipm_iters` on `device` in `dtype` (a CUDA device
        on a host without one raises ValueError)."""
        if name not in _TABLE:
            raise ValueError(
                f"not a plain guidance variant: '{name}' "
                f"(known: {sorted(_TABLE)})")
        kw = {}
        if Tf is not None:
            kw["Tf"] = Tf
        if N is not None:
            kw["N"] = N
        self.name = name
        self.io = _TABLE[name]
        self.spec = builders.build(name, **kw)
        self.solver = RTISolver(self.spec, ipm_iters=ipm_iters,
                                device=require_device(device), dtype=dtype)
        self.device, self.dtype = self.solver.device, self.solver.dtype

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def _pack_x0(self, meas: VariantMeasurements, mem, ye, ak):
        io = self.io
        if io.pose_layout == "world":
            vals = [meas.nedx, meas.nedy, meas.psi,
                    torch.sin(meas.psi), torch.cos(meas.psi), meas.u, meas.v]
            if io.uses_r:
                vals.append(meas.r)
            vals += [ye, ak]
        else:
            # crab-angle error packing (nmpc_guidance4.cpp:229-246, same
            # chie convention as the flagship)
            u = torch.where(meas.u == 0.0, 0.001, meas.u)
            beta = torch.atan2(meas.v, u)
            chie = wrap_once(meas.psi + beta - ak)
            vals = [u, meas.v, ye, chie]
        zero = torch.zeros_like(meas.psi)
        if io.pose_layout == "error_ca":
            # guidance_ca appends (psied, xned, yned, psi, psieddot); psied
            # is the carried memory slot, psieddot is the constant-zero
            # quirk (nmpc_guidance_ca.cpp:271-275; see module docstring)
            vals += [zero, meas.nedx, meas.nedy, meas.psi]
        x0 = stack_last(vals + [zero] * (self.spec.model.nx - len(vals)))
        for slot, idx in enumerate(io.mem_idx):
            x0[..., idx] = mem[..., slot]
        return x0

    # ------------------------------------------------------------------
    def init_state(self, meas: VariantMeasurements, waypoints,
                   n_wp) -> VariantState:
        """The state takes the solver's dtype (the JAX method's `dtype`
        argument is dropped)."""
        meas = VariantMeasurements(*(self._tensor(m) for m in meas))
        mission = mission_init(self._tensor(waypoints), n_wp, meas.psi)
        mem = meas.psi.new_zeros(meas.psi.shape
                                 + (max(len(self.io.mem_idx), 1),))
        if self.io.seed_mem:
            # guidance_ca re-seeds past_psied = wrap(psi - ak) on a new
            # waypoint list (nmpc_guidance_ca.cpp:361-366)
            mem[..., 0] = mission.past_psied
        zero = torch.zeros_like(meas.psi)
        x0 = self._pack_x0(meas, mem, zero, zero)
        return VariantState(
            mission=mission, solver=self.solver.init_state(x0),
            memory=mem, psi_d_hold=meas.psi.clone(), r_d_hold=zero)

    # ------------------------------------------------------------------
    def tick(self, state: VariantState, meas: VariantMeasurements,
             waypoints, n_wp):
        io = self.io
        meas = VariantMeasurements(*(self._tensor(m) for m in meas))
        mission, frame = waypoint_manager(
            state.mission, self._tensor(waypoints), n_wp, meas.nedx,
            meas.nedy)

        x0 = self._pack_x0(meas, state.memory, frame.ye, frame.ak)
        # guidance_ca never updates its obstacle params, so they stay at
        # the builder default far sentinel (see module docstring)
        fill = 100.0 if io.far_params else 0.0
        params = torch.full((self.spec.model.np_,), fill, dtype=self.dtype,
                            device=self.device)
        if io.pose_layout == "world":
            # the nodes push the segment heading as (sin, cos) references
            # every tick (e.g. nmpc_guidance.cpp:235-236,276-277)
            ny, nx = self.spec.cost.ny, self.spec.model.nx
            yvec = frame.ak.new_zeros(frame.ak.shape + (ny,))
            yvec[..., 3] = torch.sin(frame.ak)
            yvec[..., 4] = torch.cos(frame.ak)
            yref, yref_e = stage_refs(yvec, self.spec.N, nx)
        else:
            yref = yref_e = None
        solver_state, out = self.solver.step_fn(state.solver, x0, params,
                                                yref=yref, yref_e=yref_e)

        def extract(src):
            kind, stage, idx, add_ak = src
            val = (out.xtraj[..., stage, idx] if kind == "x"
                   else out.u0[..., idx])
            return wrap_once(val + frame.ak) if add_ak else val

        active = mission.active
        psi_d = (extract(io.heading_src) if io.heading_src
                 else state.psi_d_hold)
        r_d = extract(io.rate_src) if io.rate_src else state.r_d_hold
        psi_d = torch.where(active, psi_d, state.psi_d_hold)
        r_d = torch.where(active, r_d, state.r_d_hold)

        # carried command memory <- memory-stage values of the memory
        # states (stage 1 for most nodes; guidance_ca reads stage 2,
        # nmpc_guidance_ca.cpp:319,328)
        mem = state.memory.clone()
        for slot, idx in enumerate(io.mem_idx):
            mem[..., slot] = torch.where(
                active, out.xtraj[..., io.mem_stage, idx],
                state.memory[..., slot])

        cmds = VariantCommands(psi_d=psi_d, r_d=r_d, u_d=frame.u_d,
                               ye=frame.ye, active=active,
                               solver_status=out.status)
        return VariantState(mission=mission, solver=solver_state, memory=mem,
                            psi_d_hold=psi_d, r_d_hold=r_d), cmds
