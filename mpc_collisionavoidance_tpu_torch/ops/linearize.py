"""SQP linearization of the per-instance engine: build the stage-structured
QP at a trajectory iterate (counterpart of
`mpc_collisionavoidance_tpu/ops/linearize.py`).

The preparation phase of SQP-RTI: the RK4 map and its Jacobians per stage,
the Gauss-Newton LINEAR_LS cost expansion, the constraint linearization,
and the hard/soft inequality row assembly.

Static row layout for hard inequalities (masked rows are zeroed so shapes
stay fixed):
    [ u-box lower | u-box upper | x-box lower | x-box upper |
      hard-h lower | hard-h upper ]
x-box rows are masked at stage 0 (state pinned, acados lbx0=ubx0).  Soft
rows: [ softened h rows | softened state-box rows ].

The dynamics and the h rows are linearized in the lane layout: the batch
of iterates is flattened onto the lane axis and handed to
`ops/linearize_lanes.linearize_lanes`, whose outputs (x_next, J, hbar, C)
are exactly the per-stage RK4 map, its Jacobian and the h-Jacobian — the
plain version on the CPU, K2 on a CUDA device (a `TrackModel` takes K2's
curved form).  Everything else is batched tensor algebra on the JAX
package's per-instance shapes with optional leading batch axes.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu_torch.ops.ipm import QPData
from mpc_collisionavoidance_tpu_torch.ops.lanes import from_lanes, to_lanes
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes)


class RowLayout(NamedTuple):
    """Static (numpy) description of the inequality rows."""

    E_u: np.ndarray        # (n_bu, nu) selection for control box
    lbu: np.ndarray
    ubu: np.ndarray
    E_x: np.ndarray        # (n_bx, nx) selection for HARD state-box rows
    lbx: np.ndarray
    ubx: np.ndarray
    hard_h: np.ndarray     # indices of hard h rows
    soft_h: np.ndarray     # indices of softened h rows
    E_xs: np.ndarray       # (n_sbx, nx) selection for SOFT state-box rows
    lbx_s: np.ndarray      # (n_sbx,)
    ubx_s: np.ndarray
    n_hard: int            # total hard rows per stage


def make_row_layout(spec: OCPSpec) -> RowLayout:
    m = spec.model
    idxbu = np.asarray(m.idxbu, dtype=np.int64).reshape(-1)
    idxbx = np.asarray(m.idxbx, dtype=np.int64).reshape(-1)
    lbx = np.asarray(m.lbx, float).reshape(-1)
    ubx = np.asarray(m.ubx, float).reshape(-1)
    E_u = np.eye(m.nu)[idxbu] if idxbu.size else np.zeros((0, m.nu))

    # soft state-box rows (acados idxsbx) leave the hard family
    sbx = (np.asarray(spec.soft_bx.idxsbx, dtype=np.int64)
           if spec.soft_bx is not None else np.zeros((0,), dtype=np.int64))
    hard_bx = np.setdiff1d(np.arange(idxbx.size), sbx)
    E_x_all = np.eye(m.nx)[idxbx] if idxbx.size else np.zeros((0, m.nx))

    hard_h = spec.hard_h_rows()
    soft_h = (np.asarray(spec.soft.idxsh, dtype=np.int64)
              if spec.soft is not None else np.zeros((0,), dtype=np.int64))
    E_x = E_x_all[hard_bx]
    return RowLayout(
        E_u=E_u, lbu=np.asarray(m.lbu, float).reshape(-1),
        ubu=np.asarray(m.ubu, float).reshape(-1),
        E_x=E_x, lbx=lbx[hard_bx], ubx=ubx[hard_bx],
        hard_h=hard_h, soft_h=soft_h,
        E_xs=E_x_all[sbx], lbx_s=lbx[sbx], ubx_s=ubx[sbx],
        n_hard=2 * E_u.shape[0] + 2 * E_x.shape[0] + 2 * hard_h.size,
    )


class QPBuilder:
    """`build_qp` for one (spec, layout) on one device and dtype: the
    static blocks are moved there once, at construction, so that a tick
    copies nothing from the host."""

    def __init__(self, spec: OCPSpec, layout: RowLayout, *, device, dtype):
        self.spec, self.layout = spec, layout
        self.device, self.dtype = torch.device(device), dtype
        m, cost, scale = spec.model, spec.cost, spec.stage_scale

        def dev(a):
            return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                                   device=self.device)

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64).reshape(-1),
                                   device=self.device)

        Vx, Vu, W = dev(cost.Vx), dev(cost.Vu), dev(cost.W)
        self.Vx, self.Vu, self.W = Vx, Vu, W
        self.Q_stage = scale * (Vx.T @ W @ Vx)
        self.R_stage = scale * (Vu.T @ W @ Vu)
        self.S_stage = scale * (Vu.T @ W @ Vx)
        self.Vx_e, self.W_e = dev(cost.Vx_e), dev(cost.W_e)
        self.Q_N = self.Vx_e.T @ self.W_e @ self.Vx_e
        self.yref = dev(cost.yref).expand(spec.N, cost.ny)
        self.yref_e = dev(cost.yref_e)
        self.E_u, self.E_x, self.E_xs = (dev(layout.E_u), dev(layout.E_x),
                                         dev(layout.E_xs))
        self.lbu, self.ubu = dev(layout.lbu), dev(layout.ubu)
        self.lbx, self.ubx = dev(layout.lbx), dev(layout.ubx)
        self.lbx_s, self.ubx_s = dev(layout.lbx_s), dev(layout.ubx_s)
        self.hh, self.sh = idx(layout.hard_h), idx(layout.soft_h)
        self.lh, self.uh = dev(m.lh).reshape(-1), dev(m.uh).reshape(-1)
        # soft-row slack costs and bounds: [softened h | softened x-box]
        parts = []
        if layout.soft_h.size:
            sp = spec.soft
            parts.append((scale * dev(sp.zl), scale * dev(sp.Zl),
                          scale * dev(sp.zu), scale * dev(sp.Zu),
                          dev(sp.lsh), dev(sp.ush)))
        if layout.E_xs.shape[0]:
            sb = spec.soft_bx
            parts.append((scale * dev(sb.zl), scale * dev(sb.Zl),
                          scale * dev(sb.zu), scale * dev(sb.Zu),
                          dev(sb.lsbx), dev(sb.usbx)))
        self.slack = tuple(
            torch.cat([p[i].reshape(-1) for p in parts]) if parts
            else torch.zeros(0, dtype=dtype, device=self.device)
            for i in range(6))
        self.inner = torch.arange(spec.N, device=self.device) > 0   # (N,)

    def __call__(self, xbar, ubar, x0, yref, yref_e, params, lh=None
                 ) -> QPData:
        """xbar (..., N+1, nx), ubar (..., N, nu), x0 (..., nx), yref
        (..., N, ny), yref_e (..., ny_e), params (..., np), lh (..., nh) or
        None (the model's lh).  Every output field carries xbar's batch
        axes."""
        spec, m = self.spec, self.spec.model
        N, nx, nu = spec.N, m.nx, m.nu
        batch = xbar.shape[:-2]
        opts = dict(dtype=self.dtype, device=self.device)

        def full(t, *shape):
            return t.expand(*batch, *shape)

        # ---- dynamics + constraint linearization, in the lane layout ----
        xs = xbar[..., :-1, :]
        x_next, J, hbar, C = linearize_lanes(
            to_lanes(xs.movedim(-1, -2), batch),             # (nx, N, L)
            to_lanes(ubar.movedim(-1, -2), batch),           # (nu, N, L)
            to_lanes(params.expand(*batch, params.shape[-1]), batch),
            model=m, dt=spec.dt, integrator_steps=spec.integrator_steps)
        # every returned field contiguous: a caller's copy of the QP (the
        # captured preparation's) then has its layout, and the feedback
        # computes the same bits on either
        J = from_lanes(J, batch)                         # (..., N, nx, nx+nu)
        A, B = J[..., :nx].contiguous(), J[..., nx:].contiguous()
        c = (from_lanes(x_next, batch).movedim(-2, -1)
             - xbar[..., 1:, :]).contiguous()
        hbar = from_lanes(hbar, batch).movedim(-2, -1)       # (..., N, nh)
        C = from_lanes(C, batch)                             # (..., N, nh, nx)

        # ---- Gauss-Newton LINEAR_LS cost ----
        scale = spec.stage_scale
        y = xs @ self.Vx.T + ubar @ self.Vu.T - yref         # (..., N, ny)
        Wy = scale * (y @ self.W.T)
        qx_path = Wy @ self.Vx                               # (..., N, nx)
        qu = Wy @ self.Vu                                    # (..., N, nu)
        r_e = xbar[..., -1, :] @ self.Vx_e.T - yref_e
        qx_N = (r_e @ self.W_e.T) @ self.Vx_e
        Q = torch.cat([full(self.Q_stage, N, nx, nx),
                       full(self.Q_N, 1, nx, nx)], dim=-3)
        qx = torch.cat([qx_path, qx_N.unsqueeze(-2)], dim=-2)
        # copies: a returned QP holds no view of the builder's blocks
        S = full(self.S_stage, N, nu, nx).clone()
        R = full(self.R_stage, N, nu, nu).clone()
        lh_full = self.lh if lh is None else lh              # (..., nh)
        uh_full = self.uh

        # ---- hard inequality rows ----
        n_bu, n_bx = self.E_u.shape[0], self.E_x.shape[0]
        mask = self.inner[:, None]                           # (N, 1)
        usel = ubar @ self.E_u.T                             # (..., N, n_bu)
        bu_lo_Gu = full(self.E_u, N, n_bu, nu)
        xsel = xs @ self.E_x.T                               # (..., N, n_bx)
        bx_lo_Gx = full(self.E_x, N, n_bx, nx) * mask[..., None].to(
            self.dtype)
        hh = self.hh
        C_hard = C.index_select(-2, hh)
        h_hard = hbar.index_select(-1, hh)
        zeros_Gx = torch.zeros(batch + (N, n_bu, nx), **opts)
        zeros_Gu = torch.zeros(batch + (N, n_bx + hh.numel(), nu), **opts)
        Gx = torch.cat([zeros_Gx, zeros_Gx, bx_lo_Gx, -bx_lo_Gx,
                        C_hard, -C_hard], dim=-2)
        Gu = torch.cat([bu_lo_Gu, -bu_lo_Gu, zeros_Gu, zeros_Gu], dim=-2)
        gl = torch.cat([
            self.lbu - usel, usel - self.ubu,
            torch.where(mask, self.lbx - xsel, -1.0),
            torch.where(mask, xsel - self.ubx, -1.0),
            lh_full.index_select(-1, hh).unsqueeze(-2) - h_hard,
            h_hard - uh_full.index_select(-1, hh)], dim=-1)

        # ---- soft rows: [ softened h rows | softened state-box rows ] ----
        sh = self.sh
        n_sh, n_sbx = sh.numel(), self.E_xs.shape[0]
        Cx = [C.index_select(-2, sh)]
        hofs = [hbar.index_select(-1, sh)]
        slh = [full(lh_full.index_select(-1, sh).unsqueeze(-2), N, n_sh)]
        suh = [full(uh_full.index_select(-1, sh), N, n_sh)]
        if n_sbx:
            # a softened box row is a soft row with constant Jacobian E_xs;
            # at stage 0 the state is pinned, so the row is zeroed there
            # with an O(1) slack band around 0 (the role of the gl = -1
            # masking of hard box rows above)
            mvec = mask.to(self.dtype)
            Cx.append(full(self.E_xs, N, n_sbx, nx) * mvec[..., None])
            hofs.append((xs @ self.E_xs.T) * mvec)
            slh.append(full(torch.where(mask, self.lbx_s, -1.0), N, n_sbx))
            suh.append(full(torch.where(mask, self.ubx_s, 1.0), N, n_sbx))
        zl, Zl, zu, Zu, lsh, ush = (full(v, v.shape[0]).clone()
                                    for v in self.slack)

        return QPData(
            A=A, B=B, c=c, dx0=x0 - xbar[..., 0, :],
            Q=Q, S=S, R=R, qx=qx, qu=qu,
            Gx=Gx, Gu=Gu, gl=gl,
            Cx=torch.cat(Cx, dim=-2), hofs=torch.cat(hofs, dim=-1),
            slh=torch.cat(slh, dim=-1), suh=torch.cat(suh, dim=-1),
            zl=zl, Zl=Zl, zu=zu, Zu=Zu, lsh=lsh, ush=ush,
        )


def build_qp(spec: OCPSpec, layout: RowLayout, xbar, ubar, x0, yref,
             yref_e, params, lh: Optional[torch.Tensor] = None) -> QPData:
    """The QP of `spec` linearized at (xbar, ubar) with the state pinned at
    x0 (see `QPBuilder.__call__` for the shapes), on xbar's device and
    dtype."""
    return QPBuilder(spec, layout, device=xbar.device, dtype=xbar.dtype)(
        xbar, ubar, x0, yref, yref_e, params, lh)
