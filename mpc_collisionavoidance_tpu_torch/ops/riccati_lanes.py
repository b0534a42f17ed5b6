"""Lane-batched Riccati LQR solve (counterpart of
`mpc_collisionavoidance_tpu/ops/riccati_lanes.py`).

`lqr_solve_lanes_plain` is the plain PyTorch sweep: a Python loop over the
stages whose bodies are small lane-batched products.  `lqr_solve_lanes`
dispatches by device: CPU tensors take the plain sweep, CUDA tensors the
hand-written kernel `csrc/riccati_lanes.cu` (which raises for shapes it
has no instance for — there is no fallback).
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.kernels import riccati
from mpc_collisionavoidance_tpu_torch.ops import lanes as ln


class LaneLQR(NamedTuple):
    A: torch.Tensor    # (N, nx, nx, L)
    B: torch.Tensor    # (N, nx, nu, L)
    c: torch.Tensor    # (N, nx, L)
    Q: torch.Tensor    # (N+1, nx, nx, L)
    S: torch.Tensor    # (N, nu, nx, L)
    R: torch.Tensor    # (N, nu, nu, L)
    qx: torch.Tensor   # (N+1, nx, L)
    qu: torch.Tensor   # (N, nu, L)
    dx0: torch.Tensor  # (nx, L)


def lqr_solve_lanes_plain(d: LaneLQR):
    """Backward Riccati recursion + forward rollout.
    Returns (dx (N+1, nx, L), du (N, nu, L))."""
    N = d.A.shape[0]
    P, p = d.Q[N], d.qx[N]
    Ks, kffs = [None] * N, [None] * N
    for s in reversed(range(N)):
        A, B, c = d.A[s], d.B[s], d.c[s]
        PA = ln.mm(P, A)                     # (nx, nx, L)
        PB = ln.mm(P, B)                     # (nx, nu, L)
        Pc_p = ln.mv(P, c) + p               # (nx, L)
        Huu = d.R[s] + ln.mtm(B, PB)         # (nu, nu, L)
        Hux = d.S[s] + ln.mtm(B, PA)         # (nu, nx, L)
        hu = d.qu[s] + ln.mtv(B, Pc_p)       # (nu, L)
        Lf = ln.chol_factor(Huu)
        K = -ln.chol_solve_mat(Lf, Hux)      # (nu, nx, L)
        kff = -ln.chol_solve_vec(Lf, hu)     # (nu, L)
        P = ln.sym(d.Q[s] + ln.mtm(A, PA) + ln.mtm(Hux, K))
        p = d.qx[s] + ln.mtv(A, Pc_p) + ln.mtv(Hux, kff)
        Ks[s], kffs[s] = K, kff

    dx = d.dx0
    dxs, dus = [], []
    for s in range(N):
        du = ln.mv(Ks[s], dx) + kffs[s]
        dxs.append(dx)
        dus.append(du)
        dx = ln.mv(d.A[s], dx) + ln.mv(d.B[s], du) + d.c[s]
    dxs.append(dx)
    return torch.stack(dxs), torch.stack(dus)


def lqr_solve_lanes(d: LaneLQR):
    """Device dispatch: the plain sweep for CPU tensors, the CUDA kernel
    for CUDA tensors.  Returns (dx (N+1, nx, L), du (N, nu, L))."""
    if all(t.device.type == "cpu" for t in d):
        return lqr_solve_lanes_plain(d)
    return riccati.lqr_solve_lanes_cuda(*d)
