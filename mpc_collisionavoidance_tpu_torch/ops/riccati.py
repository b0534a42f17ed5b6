"""Stage-wise Riccati LQR solve of the per-instance engine (counterpart of
`mpc_collisionavoidance_tpu/ops/riccati.py`).

Each interior-point iteration of `ops/ipm.py` reduces to one
equality-constrained LQR

    min  sum_k 0.5 w_k' H_k w_k + g_k' w_k      (w_k = (dx_k, du_k))
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 = dx0,

solved by a backward gain recursion and a forward rollout.

Layouts: the JAX package's per-instance shapes with optional leading batch
axes, A (..., N, nx, nx) ... dx0 (..., nx); every field carries the same
batch axes.  One call is both the per-instance solve and its `jax.vmap`.

The device picks the path.  CPU tensors take `lqr_solve_plain`, a stage
loop of batched products.  CUDA tensors take the lane route: the batch is
flattened onto the lane axis (`(N, ., ., L)`, the instance minor-most) and
solved by `ops/riccati_lanes.lqr_solve_lanes`, which launches K1 — the
identical math (`mpc_collisionavoidance_tpu/ops/riccati_lanes.py`).  An
(nx, nu) that K1 has no instance for raises there; it never runs on the
CPU instead.
"""

import math
from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.ops import lanes as ln
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
    LaneLQR, lqr_solve_lanes)


class LQRData(NamedTuple):
    """Equality-constrained time-varying LQR problem (affine residual form)."""

    A: torch.Tensor    # (..., N, nx, nx)
    B: torch.Tensor    # (..., N, nx, nu)
    c: torch.Tensor    # (..., N, nx)  dynamics residual
    Q: torch.Tensor    # (..., N+1, nx, nx)  (terminal in last slot)
    S: torch.Tensor    # (..., N, nu, nx)  cross term d2/du dx
    R: torch.Tensor    # (..., N, nu, nu)
    qx: torch.Tensor   # (..., N+1, nx)
    qu: torch.Tensor   # (..., N, nu)
    dx0: torch.Tensor  # (..., nx)


def mv(M, v):
    """Batched matrix-vector product: (..., a, b) x (..., b) -> (..., a)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def cholesky(H):
    """Lower Cholesky factor of each matrix in H (..., n, n).  A matrix
    that is not positive definite gets a factor of NaNs, as JAX's
    `jnp.linalg.cholesky` returns, where `torch.linalg.cholesky` would
    raise for the whole batch."""
    Lf, info = torch.linalg.cholesky_ex(H)
    return torch.where((info != 0)[..., None, None], math.nan, Lf)


def lqr_solve(d: LQRData, reg: float = 0.0):
    """Solve the LQR problem; returns (dx (..., N+1, nx), du (..., N, nu)).

    `reg` adds Levenberg regularization to the control Hessian before the
    factorization (0 for parity with HPIPM on well-posed problems)."""
    if all(t.device.type == "cpu" for t in d):
        return lqr_solve_plain(d, reg)
    return _lqr_solve_lanes(d, reg)


def lqr_solve_plain(d: LQRData, reg: float = 0.0):
    """The backward recursion and forward rollout as a loop over the
    stages, each a few batched products (any device).  The stages are
    split once up front and the vectors kept as columns (..., n, 1), so
    that a stage costs few operator calls: the CPU tick is bound by
    their count."""
    N, nx = d.A.shape[-3], d.A.shape[-1]
    nu = d.B.shape[-1]
    eye_u = torch.eye(nu, dtype=d.B.dtype, device=d.B.device)
    As, Bs, Qs, Ss, Rs = (t.unbind(-3) for t in (d.A, d.B, d.Q, d.S, d.R))
    cs, qxs, qus = (t.unsqueeze(-1).unbind(-3) for t in (d.c, d.qx, d.qu))
    P, p = Qs[N], qxs[N]
    Ks, kffs = [None] * N, [None] * N
    for s in reversed(range(N)):
        A, B = As[s], Bs[s]
        Bt = B.mT
        PA = P @ A                                     # (..., nx, nx)
        PB = P @ B                                     # (..., nx, nu)
        Pc_p = P @ cs[s] + p                           # (..., nx, 1)
        Huu = Rs[s] + Bt @ PB + reg * eye_u
        Hux = Ss[s] + Bt @ PA                          # (..., nu, nx)
        hu = qus[s] + Bt @ Pc_p                        # (..., nu, 1)
        # one factorization and one solve for both the gain and the
        # feed-forward term
        sol = torch.cholesky_solve(torch.cat([Hux, hu], -1), cholesky(Huu))
        K, kff = -sol[..., :nx], -sol[..., nx:]
        P = Qs[s] + A.mT @ PA + Hux.mT @ K
        P = 0.5 * (P + P.mT)
        p = qxs[s] + A.mT @ Pc_p + Hux.mT @ kff
        Ks[s], kffs[s] = K, kff

    dx = d.dx0.unsqueeze(-1)
    dxs, dus = [], []
    for s in range(N):
        du = Ks[s] @ dx + kffs[s]
        dxs.append(dx)
        dus.append(du)
        dx = As[s] @ dx + Bs[s] @ du + cs[s]
    dxs.append(dx)
    return (torch.stack(dxs, dim=-3).squeeze(-1),
            torch.stack(dus, dim=-3).squeeze(-1))


def _lqr_solve_lanes(d: LQRData, reg):
    batch = d.dx0.shape[:-1]
    nu = d.B.shape[-1]
    R = d.R
    if reg:
        R = R + reg * torch.eye(nu, dtype=R.dtype, device=R.device)
    lanes = LaneLQR(*(ln.to_lanes(t, batch) for t in d._replace(R=R)))
    dx, du = lqr_solve_lanes(lanes)
    return ln.from_lanes(dx, batch), ln.from_lanes(du, batch)
