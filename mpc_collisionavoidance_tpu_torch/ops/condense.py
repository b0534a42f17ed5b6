"""Full condensing: eliminate the state trajectory from a stage QP
(counterpart of `mpc_collisionavoidance_tpu/ops/condense.py`, the role of
acados' FULL_CONDENSING path).

Substituting the dynamics dx_{k+1} = A_k dx_k + B_k du_k + c_k, dx_0 = dx0
leaves the stacked controls w = vec(du) in R^{N*nu} as the only variable:
dx = M w + m, M lower block-triangular (the impulse response of the
linearized plant), m the free response.  The result is a dense
inequality-constrained QP with one (N*nu, N*nu) Hessian.

Layouts: the JAX package's per-instance shapes with optional leading batch
axes; every field of the `QPData` carries the same batch axes.
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.ops.ipm import QPData
from mpc_collisionavoidance_tpu_torch.ops.riccati import mv


class DenseQP(NamedTuple):
    """Condensed QP:  min 0.5 w'H w + g'w  over w in R^{nz}, subject to

        Ghat w + dg >= 0                          (hard rows, N*nI of them)
        slh <= Chat w + dc <= suh   (soft, slack-relaxed; N*nS rows)

    plus the soft-slack cost and bound data copied per row from the stage
    QP, and (M, m) to reconstruct the stage trajectories.
    """

    H: torch.Tensor      # (..., nz, nz)
    g: torch.Tensor      # (..., nz)
    Ghat: torch.Tensor   # (..., mI, nz) hard rows
    dg: torch.Tensor     # (..., mI)
    Chat: torch.Tensor   # (..., mS, nz) soft rows (value = Chat w + dc)
    dc: torch.Tensor     # (..., mS)
    slh: torch.Tensor    # (..., mS)
    suh: torch.Tensor    # (..., mS)
    zl: torch.Tensor     # (..., mS)
    Zl: torch.Tensor     # (..., mS)
    zu: torch.Tensor     # (..., mS)
    Zu: torch.Tensor     # (..., mS)
    lsh: torch.Tensor    # (..., mS)
    ush: torch.Tensor    # (..., mS)
    M: torch.Tensor      # (..., N+1, nx, nz) state sensitivity wrt w
    m: torch.Tensor      # (..., N+1, nx) free response


def condense(qp: QPData) -> DenseQP:
    """Condense a stage-structured `QPData` into a `DenseQP`."""
    N, nx, nu = qp.B.shape[-3:]
    batch = qp.B.shape[:-3]
    nz = N * nu
    opts = dict(dtype=qp.A.dtype, device=qp.A.device)

    # ---- state sensitivities: dx = M w + m ----
    # M_{k+1} = A_k M_k + B_k E_k,  E_k w = du_k;  m_{k+1} = A_k m_k + c_k
    Ms = [torch.zeros(batch + (nx, nz), **opts)]
    ms = [qp.dx0]
    for k in range(N):
        Ak = qp.A[..., k, :, :]
        BE = torch.zeros(batch + (nx, nz), **opts)
        BE[..., k * nu:(k + 1) * nu] = qp.B[..., k, :, :]
        Ms.append(Ak @ Ms[-1] + BE)
        ms.append(mv(Ak, ms[-1]) + qp.c[..., k, :])
    M = torch.stack(Ms, dim=-3)                          # (..., N+1, nx, nz)
    m = torch.stack(ms, dim=-2)                              # (..., N+1, nx)
    Mp, mp = M[..., :-1, :, :], m[..., :-1, :]               # path stages

    # ---- dense cost ----
    # J = 0.5 dx'Q dx + qx'dx + du'S dx + 0.5 du'R du + qu'du, dx = M w + m:
    # one contraction over (stage, state) for M'QM and M'(Qm + qx)
    QM = qp.Q @ M                                        # (..., N+1, nx, nz)
    M_flat = M.reshape(batch + ((N + 1) * nx, nz))
    H = M_flat.mT @ QM.reshape(batch + ((N + 1) * nx, nz))
    ESM = (qp.S @ Mp).reshape(batch + (nz, nz))              # rows = du slots
    H = H + ESM + ESM.mT
    H = H + _block_diag(qp.R)

    v = (mv(qp.Q, m) + qp.qx).reshape(batch + ((N + 1) * nx,))
    g = mv(M_flat.mT, v)
    g = g + (mv(qp.S, mp) + qp.qu).reshape(batch + (nz,))

    # ---- hard rows:  Gx dx + Gu du - gl >= 0  ->  Ghat w + dg >= 0 ----
    nI = qp.Gx.shape[-2]
    Ghat = (qp.Gx @ Mp + _block_rows(qp.Gu)).reshape(batch + (N * nI, nz))
    dg = (mv(qp.Gx, mp) - qp.gl).reshape(batch + (N * nI,))

    # ---- soft rows: value = hofs + Cx dx = Chat w + dc ----
    nS = qp.Cx.shape[-2]
    Chat = (qp.Cx @ Mp).reshape(batch + (N * nS, nz))
    dc = (qp.hofs + mv(qp.Cx, mp)).reshape(batch + (N * nS,))

    def tile(vec):
        return vec.unsqueeze(-2).expand(batch + (N, nS)).reshape(
            batch + (N * nS,))

    return DenseQP(
        H=H, g=g, Ghat=Ghat, dg=dg, Chat=Chat, dc=dc,
        slh=qp.slh.reshape(batch + (N * nS,)),
        suh=qp.suh.reshape(batch + (N * nS,)),
        zl=tile(qp.zl), Zl=tile(qp.Zl), zu=tile(qp.zu), Zu=tile(qp.Zu),
        lsh=tile(qp.lsh), ush=tile(qp.ush),
        M=M, m=m,
    )


def _block_diag(R):
    """(..., N, nu, nu) -> (..., N*nu, N*nu) block diagonal."""
    *batch, N, nu, _ = R.shape
    out = R.new_zeros(tuple(batch) + (N, N, nu, nu))
    idx = torch.arange(N, device=R.device)
    out[..., idx, idx, :, :] = R
    return out.transpose(-3, -2).reshape(tuple(batch) + (N * nu, N * nu))


def _block_rows(Gu):
    """Place each stage's Gu (..., N, r, nu) into its du_k column slot of
    w: (..., N, r, N*nu)."""
    *batch, N, r, nu = Gu.shape
    out = Gu.new_zeros(tuple(batch) + (N, N, r, nu))
    idx = torch.arange(N, device=Gu.device)
    out[..., idx, idx, :, :] = Gu
    return out.transpose(-3, -2).reshape(tuple(batch) + (N, r, N * nu))


def expand(dense: DenseQP, w, N: int, nu: int):
    """Recover the stage trajectories from the condensed solution w
    (..., nz): (dx (..., N+1, nx), du (..., N, nu))."""
    dx = mv(dense.M, w.unsqueeze(-2)) + dense.m
    du = w.reshape(w.shape[:-1] + (N, nu))
    return dx, du
