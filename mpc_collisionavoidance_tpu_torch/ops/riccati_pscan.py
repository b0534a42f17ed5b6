"""Parallel-in-horizon Riccati: `lqr_solve_lanes` at O(log N) depth
(counterpart of `mpc_collisionavoidance_tpu/ops/riccati_pscan.py`).

The sequential sweep (`ops/riccati_lanes.py`) walks 2N dependent stages
per IPM iteration.  This module solves the same stagewise LQR with two
associative scans over the stage axis (the temporal parallelization of
Särkkä and García-Fernández for LQT):

1.  Each stage k becomes a conditional value function element
    e_k = (A, b, C, eta, J) (controls eliminated, `lqr_solve_pscan`'s
    leaves).  Adjacent elements combine associatively through the
    resolvents (I + C J)^-1 (`_combine`); a reverse scan with the terminal
    element appended gives every cost-to-go V_k(x) = x'J x / 2 - eta'x.
2.  The optimal policy makes the closed-loop dynamics affine,
    dx_{k+1} = M_k dx_k + m_k; a forward scan of their compositions gives
    the trajectory, and the controls follow stagewise.

`_scan` is `jax.lax.associative_scan`'s odd/even recursion written out, so
the combination tree is the JAX package's: ceil(log2(N+1)) levels down and
as many back, each level one batched combine over every (stage pair,
lane).  The resolvents are solved by `ops.lanes.ge_solve_mat` (elimination
without pivoting, batched over stages and lanes, three ops per column),
and every op is plain PyTorch with no host read, so the solve runs on
either device and inside a captured tick.  Needs R > 0 (true inside the
IPM: the barrier adds a positive diagonal to every bounded input).
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.ops import lanes as ln
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import LaneLQR


class _Elems(NamedTuple):
    A: torch.Tensor     # (K, nx, nx, L)
    b: torch.Tensor     # (K, nx, L)
    C: torch.Tensor     # (K, nx, nx, L)
    eta: torch.Tensor   # (K, nx, L)
    J: torch.Tensor     # (K, nx, nx, L)


def _mm(X, Y):
    """(K,a,b,L) @ (K,b,c,L) -> (K,a,c,L)."""
    return torch.einsum("kabl,kbcl->kacl", X, Y)


def _mv(X, v):
    """(K,a,b,L) @ (K,b,L) -> (K,a,L)."""
    return torch.einsum("kabl,kbl->kal", X, v)


def _combine(e_i: _Elems, e_j: _Elems) -> _Elems:
    """Associative combination of time-adjacent elements (e_i earlier),
    batched over the leading stage axis."""
    nx = e_i.A.shape[1]
    eye = torch.eye(nx, dtype=e_i.A.dtype,
                    device=e_i.A.device)[None, :, :, None]

    # Z1 = (I + C_i J_j)^-1 applied to [A_i | b_i + C_i eta_j | C_i]
    M1 = eye + _mm(e_i.C, e_j.J)
    Z1 = ln.ge_solve_mat(M1, torch.cat(
        [e_i.A, (e_i.b + _mv(e_i.C, e_j.eta))[:, :, None, :], e_i.C], dim=2))
    ZA, Zb, ZC = Z1[:, :, :nx], Z1[:, :, nx], Z1[:, :, nx + 1:]

    A = _mm(e_j.A, ZA)
    b = _mv(e_j.A, Zb) + e_j.b
    C = torch.einsum("kabl,kbcl,kdcl->kadl", e_j.A, ZC, e_j.A) + e_j.C

    # Z2 = (I + J_j C_i)^-1 applied to [eta_j - J_j b_i | J_j A_i]
    M2 = eye + _mm(e_j.J, e_i.C)
    Z2 = ln.ge_solve_mat(M2, torch.cat(
        [(e_j.eta - _mv(e_j.J, e_i.b))[:, :, None, :], _mm(e_j.J, e_i.A)],
        dim=2))
    Zeta, ZJ = Z2[:, :, 0], Z2[:, :, 1:]

    eta = torch.einsum("kbal,kbl->kal", e_i.A, Zeta) + e_i.eta
    J = torch.einsum("kbal,kbcl->kacl", e_i.A, ZJ) + e_i.J
    J = 0.5 * (J + J.transpose(1, 2))
    return _Elems(A=A, b=b, C=C, eta=eta, J=J)


class _Aff(NamedTuple):
    M: torch.Tensor     # (K, nx, nx, L)
    m: torch.Tensor     # (K, nx, L)


def _aff_combine(f, g):
    """Composition of the affine maps f (earlier) and g (later):
    x -> Mg (Mf x + mf) + mg."""
    return _Aff(_mm(g.M, f.M), _mv(g.M, f.m) + g.m)


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 0 (len(even) is len(odd) or
    one more)."""
    n = even.shape[0] + odd.shape[0]
    out = even.new_empty((n,) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def _scan(fn, elems):
    """Inclusive scan of the tuple of tensors `elems` along axis 0 with
    the associative `fn(earlier, later)`: `jax.lax.associative_scan`'s
    recursion (pairs combined, the reduced sequence scanned, the even
    positions filled from the odd ones)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    kind = type(elems)

    def cut(sl):
        return kind(*(e[sl] for e in elems))

    odd = _scan(fn, fn(cut(slice(0, -1, 2)), cut(slice(1, None, 2))))
    if n % 2 == 0:
        even = fn(kind(*(e[:-1] for e in odd)), cut(slice(2, None, 2)))
    else:
        even = fn(odd, cut(slice(2, None, 2)))
    even = kind(*(torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even)))
    return kind(*(_interleave(e, o) for e, o in zip(even, odd)))


def _stage_chol_solve(H, Bm):
    """H^-1 B stagewise for SPD H (N, n, n, L), B (N, n, k, L): the
    unrolled Cholesky with the stage axis moved behind the lanes (factor
    entries (L, N)), every column of B solved at once (`chol_solve_vec`
    works row by row, so its rows may be (k, L, N))."""
    Lf = ln.chol_factor(H.movedim(0, -1))                 # (n, n, L, N)
    return ln.chol_solve_vec(Lf, Bm.movedim(0, -1)).movedim(-1, 0)


def lqr_solve_pscan(d: LaneLQR):
    """Drop-in equivalent of `lqr_solve_lanes` (same LaneLQR input, same
    (dx (N+1, nx, L), du (N, nu, L)) output) at O(log N) sequential
    depth.  Needs R > 0."""
    N, nx, nu, L = d.B.shape[0], d.A.shape[1], d.B.shape[2], d.B.shape[-1]
    opts = dict(dtype=d.A.dtype, device=d.A.device)

    # ---- leaf elements: eliminate u from each stage ----
    Bt = d.B.transpose(1, 2)                            # (N, nu, nx, L)
    X = _stage_chol_solve(d.R, torch.cat(
        [d.S, d.qu[:, :, None, :], Bt], dim=2))
    RiS, Riqu, RiBt = X[:, :, :nx], X[:, :, nx], X[:, :, nx + 1:]
    At = d.A - _mm(d.B, RiS)
    bt = d.c - _mv(d.B, Riqu)
    Ct = _mm(d.B, RiBt)
    Jt = d.Q[:-1] - torch.einsum("kbal,kbcl->kacl", d.S, RiS)
    et = torch.einsum("kbal,kbl->kal", d.S, Riqu) - d.qx[:-1]

    # terminal element: pure state cost, no transition
    zA = torch.zeros((1, nx, nx, L), **opts)
    elems = _Elems(
        A=torch.cat([At, zA], dim=0),
        b=torch.cat([bt, torch.zeros((1, nx, L), **opts)], dim=0),
        C=torch.cat([Ct, zA], dim=0),
        eta=torch.cat([et, -d.qx[-1:]], dim=0),
        J=torch.cat([Jt, d.Q[-1:]], dim=0))

    # ---- reverse scan: suffix elements give the cost-to-go of every
    # stage (the flipped sequence is scanned, so the operator sees
    # (later accumulation, earlier element): swapped into _combine's
    # (earlier, later) order) ----
    flipped = _Elems(*(e.flip(0) for e in elems))
    suf = _Elems(*(e.flip(0) for e in _scan(
        lambda a, b: _combine(b, a), flipped)))
    # V_{k+1}(x) = x'J x / 2 - eta'x, k = 0..N-1
    Jv, ev = suf.J[1:], suf.eta[1:]

    # ---- per-stage feedback from the cost-to-go ----
    JnB = _mm(Jv, d.B)                                  # (N, nx, nu, L)
    Huu = d.R + torch.einsum("kbal,kbcl->kacl", d.B, JnB)
    Hux = d.S + torch.einsum("kbal,kbcl->kacl", d.B, _mm(Jv, d.A))
    hu = d.qu + torch.einsum("kbal,kbl->kal", d.B, _mv(Jv, d.c) - ev)
    X = _stage_chol_solve(Huu, torch.cat([Hux, hu[:, :, None, :]], dim=2))
    K, kff = X[:, :, :nx], X[:, :, nx]
    M = d.A - _mm(d.B, K)
    m = d.c - _mv(d.B, kff)

    # ---- forward scan: affine-map composition gives the trajectory ----
    Ms, ms = _scan(_aff_combine, _Aff(M, m))
    # dx_{k+1} = Ms_k dx0 + ms_k
    dx_rest = torch.einsum("kabl,bl->kal", Ms, d.dx0) + ms
    dx = torch.cat([d.dx0[None], dx_rest], dim=0)
    du = -(ln.smv(K, dx[:-1]) + kff)
    return dx, du
