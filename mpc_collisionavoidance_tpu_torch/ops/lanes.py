"""Lane-batched small-matrix algebra (counterpart of
`mpc_collisionavoidance_tpu/ops/lanes.py`, the helpers the Riccati sweep,
the lane IPM, partial condensing and the parallel-scan Riccati use).

Layout: the INSTANCE axis is minor-most — tensors are (m, n, L), or
(N, m, n, L) with a leading stage axis — so the lanes of one row are
contiguous.  On the card the kernels map one thread to one lane, and
neighbouring threads read neighbouring addresses.  The products here are
the plain PyTorch versions, written as `torch.einsum` over the tiny dims.
"""

import math

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


def transpose(A):
    """(m,n,L) -> (n,m,L)."""
    return A.transpose(0, 1)


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


def smtv(A, x):
    """A^T x stagewise: (N,k,m,L),(N,k,L) -> (N,m,L)."""
    return torch.einsum("nkml,nkl->nml", A, x)


def srows_mv(C, x):
    """Row values stagewise: (N,r,m,L),(N,m,L) -> (N,r,L)."""
    return torch.einsum("nrml,nml->nrl", C, x)


def srows_tv(C, v):
    """C^T v stagewise: (N,r,m,L),(N,r,L) -> (N,m,L)."""
    return torch.einsum("nrml,nrl->nml", C, v)


def sgram_rows(C, w):
    """sum_r w[.,r] C[.,r] C[.,r]^T stagewise: (N,r,m,L),(N,r,L) -> (N,m,m,L)."""
    return torch.einsum("nril,nrl,nrjl->nijl", C, w, C)


def sgram_cross(D, C, w):
    """sum_r w[.,r] D[.,r] C[.,r]^T stagewise: (N,r,m,L),(N,r,n,L),(N,r,L)
    -> (N,m,n,L).  The cross term of constraint-row grams when rows couple
    two variable blocks (partially condensed rows C dx + D du)."""
    return torch.einsum("nril,nrl,nrjl->nijl", D, w, C)


def ge_solve_mat(M, B):
    """Solve M X = B for a general (non-symmetric) tiny M: (..., n, n, L) x
    (..., n, k, L) -> (..., n, k, L), any leading axes batched.

    Gauss-Jordan elimination WITHOUT pivoting, as the JAX package's: callers
    pass well-conditioned systems (the parallel-scan Riccati's resolvents
    I + C J with C, J PSD have their spectrum in [1, inf)).  One column per
    step, three ops each over the whole batch (the pivot row's division,
    the rank-1 update of every row, the pivot row's write), so the op
    count is 3 n whatever the batch and k."""
    n = M.shape[-3]
    X = torch.cat([M, B], dim=-2)
    for col in range(n):
        prow = X[..., col:col + 1, :, :] / X[..., col:col + 1, col:col + 1, :]
        X = torch.addcmul(X, X[..., :, col:col + 1, :], prow, value=-1)
        X[..., col:col + 1, :, :] = prow
    return X[..., n:, :]


# ---- the per-instance engine's batch axes onto the lane axis ----

def to_lanes(t, batch):
    """(*batch, *rest) -> (*rest, L = prod(batch)), contiguous (batch axes
    of size 1 are broadcast)."""
    rest = t.shape[len(batch):]
    return t.expand(*batch, *rest).reshape(
        math.prod(batch), *rest).movedim(0, -1).contiguous()


def from_lanes(t, batch):
    """(*rest, L) -> (*batch, *rest)."""
    return t.movedim(-1, 0).reshape(*batch, *t.shape[:-1])
