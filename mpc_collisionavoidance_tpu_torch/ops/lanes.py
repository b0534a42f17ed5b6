"""Lane-batched small-matrix algebra (counterpart of
`mpc_collisionavoidance_tpu/ops/lanes.py`, the helpers the Riccati sweep
and the lane IPM use).

Layout: the INSTANCE axis is minor-most — tensors are (m, n, L), or
(N, m, n, L) with a leading stage axis — so the lanes of one row are
contiguous.  On the card the kernels map one thread to one lane, and
neighbouring threads read neighbouring addresses.  The products here are
the plain PyTorch versions, written as `torch.einsum` over the tiny dims.
"""

import torch


def mm(A, B):
    """(m,k,L) @ (k,n,L) -> (m,n,L)."""
    return torch.einsum("ikl,kjl->ijl", A, B)


def mtm(A, B):
    """A^T @ B: (k,m,L),(k,n,L) -> (m,n,L)."""
    return torch.einsum("kil,kjl->ijl", A, B)


def mv(A, x):
    """(m,k,L) @ (k,L) -> (m,L)."""
    return torch.einsum("ikl,kl->il", A, x)


def mtv(A, x):
    """A^T @ x: (k,m,L),(k,L) -> (m,L)."""
    return torch.einsum("kil,kl->il", A, x)


def sym(A):
    return 0.5 * (A + A.transpose(0, 1))


def chol_factor(H):
    """Unrolled Cholesky of a tiny SPD matrix batch: H (n, n, L) -> list-of-
    lists lower factor with (L,) entries."""
    n = H.shape[0]
    Lf = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[i, j]
            for t in range(j):
                s = s - Lf[i][t] * Lf[j][t]
            if i == j:
                Lf[i][j] = torch.sqrt(s)
            else:
                Lf[i][j] = s / Lf[j][j]
    return Lf


def chol_solve_vec(Lf, b):
    """Solve (L L^T) x = b for b (n, L_lanes)."""
    n = len(Lf)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for t in range(i):
            s = s - Lf[i][t] * y[t]
        y[i] = s / Lf[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for t in range(i + 1, n):
            s = s - Lf[t][i] * x[t]
        x[i] = s / Lf[i][i]
    return torch.stack(x)


def chol_solve_mat(Lf, Bm):
    """Solve (L L^T) X = B for B (n, k, L_lanes) -> (n, k, L_lanes)."""
    cols = [chol_solve_vec(Lf, Bm[:, j, :]) for j in range(Bm.shape[1])]
    return torch.stack(cols, dim=1)


# ---- stage-batched variants: leading N stage axis, trailing L lane axis ----

def smv(A, x):
    """(N,m,k,L) @ (N,k,L) -> (N,m,L)."""
    return torch.einsum("nikl,nkl->nil", A, x)


def srows_mv(C, x):
    """Row values stagewise: (N,r,m,L),(N,m,L) -> (N,r,L)."""
    return torch.einsum("nrml,nml->nrl", C, x)


def srows_tv(C, v):
    """C^T v stagewise: (N,r,m,L),(N,r,L) -> (N,m,L)."""
    return torch.einsum("nrml,nrl->nml", C, v)


def sgram_rows(C, w):
    """sum_r w[.,r] C[.,r] C[.,r]^T stagewise: (N,r,m,L),(N,r,L) -> (N,m,m,L)."""
    return torch.einsum("nril,nrl,nrjl->nijl", C, w, C)
