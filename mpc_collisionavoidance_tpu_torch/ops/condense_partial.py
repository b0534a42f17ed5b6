"""Partial condensing of lane-batched stage QPs (counterpart of
`mpc_collisionavoidance_tpu/ops/condense_partial.py`; the HPIPM role of
the reference's `PARTIAL_CONDENSING_HPIPM`,
scripts/usv_guidance_ca1/acados_settings.py:190).

Groups of M consecutive shooting intervals are condensed into macro
stages before the IPM, so the Riccati recursion walks N/M stages with M nu
controls each instead of N stages with nu.  Given the full-resolution
:class:`LaneQP` of `solver/batch.py` (static 2-D cost blocks, state-only
rows) and a group size M dividing N, :func:`condense_lane_qp` returns an
equivalent LaneQP over G = N/M macro stages where

- the macro state is the group-start state dz_g = dx_{gM} and the macro
  control w_g stacks the group's M stage controls (j-major);
- the group's interior states are eliminated through the linearized
  dynamics: dx_{gM+j} = E_j dz + G_j w + e_j with E_0 = I, G_0 = 0,
  e_0 = 0 and E_{j+1} = A_j E_j, G_{j+1} = A_j G_j + B_j P_j,
  e_{j+1} = A_j e_j + c_j;
- the stage costs become stage/lane-varying dense (Qc', Sc', Rc') blocks
  (4-D; `ops/ipm_lanes.py` takes both forms);
- control boxes stay boxes (the macro index set is the stage set tiled);
- the interior stages' state boxes and every h row become general rows
  C' dz + D' w + offset in the hard and soft families, with the control
  coupling blocks `Dh`/`Ds`;
- the soft rows' slack weights are tiled j-major, row for row.

:func:`expand_solution` recovers the full-resolution trajectory from the
macro solution by the same (exact, linear) intra-group recursion.  Every
op is plain PyTorch with no host read: the condensing runs inside a
captured tick.
"""

from typing import NamedTuple, Tuple

import torch

from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import LaneQP, _index


# ---- group-batched tiny-matrix helpers (leading group axis, trailing
# lane axis) ----

def _gmm(X, Y):
    """(G,m,k,L) @ (G,k,n,L) -> (G,m,n,L)."""
    return torch.einsum("gmkl,gknl->gmnl", X, Y)


def _gtm(X, Y):
    """X^T Y: (G,k,m,L), (G,k,n,L) -> (G,m,n,L)."""
    return torch.einsum("gkml,gknl->gmnl", X, Y)


def _gmv(X, v):
    """(G,m,k,L) @ (G,k,L) -> (G,m,L)."""
    return torch.einsum("gmkl,gkl->gml", X, v)


def _gtv(X, v):
    """X^T v: (G,k,m,L), (G,k,L) -> (G,m,L)."""
    return torch.einsum("gkml,gkl->gml", X, v)


def _smm(Ms, Y):
    """static (m,k) @ (G,k,n,L) -> (G,m,n,L)."""
    return torch.einsum("mk,gknl->gmnl", Ms, Y)


def _smv(Ms, v):
    """static (m,k) @ (G,k,L) -> (G,m,L)."""
    return torch.einsum("mk,gkl->gml", Ms, v)


class CondenseAux(NamedTuple):
    """Full-resolution dynamics kept for :func:`expand_solution`."""
    A: torch.Tensor   # (G, M, nx, nx, L)
    B: torch.Tensor   # (G, M, nx, nu, L)
    c: torch.Tensor   # (G, M, nx, L)
    M: int
    nu: int


def condense_lane_qp(qp: LaneQP, M: int,
                     idxbu: Tuple[int, ...],
                     idxbx: Tuple[int, ...]):
    """Condense `qp` by group size M.  Returns (qp_macro, idxbu_macro,
    aux).  Requires the full-resolution form of
    `LaneRTISolver._build_qp`: static 2-D cost blocks and state-only
    rows."""
    N, nx, nu, L = qp.B.shape[0], qp.A.shape[1], qp.B.shape[2], qp.B.shape[-1]
    if N % M != 0:
        raise ValueError(f"group size {M} does not divide horizon {N}")
    if qp.Qc.ndim != 2 or qp.Dh is not None or qp.Ds is not None:
        raise ValueError("condense_lane_qp expects a full-resolution QP "
                         "(static cost blocks, state-only rows)")
    G = N // M
    nw = M * nu
    opts = dict(dtype=qp.A.dtype, device=qp.A.device)
    nbx = len(idxbx)
    nHh = qp.Ch.shape[1]
    nS = qp.Cs.shape[1]

    def grp(x):
        """(N, ...) -> (G, M, ...)."""
        return x.reshape((G, M) + tuple(x.shape[1:]))

    A, B, c = grp(qp.A), grp(qp.B), grp(qp.c)
    qx_p, qu = grp(qp.qx[:-1]), grp(qp.qu)
    Qc, Sc, Rc = qp.Qc, qp.Sc, qp.Rc

    # ---- intra-group transition chain ----
    E = torch.eye(nx, **opts)[None, :, :, None].expand(G, nx, nx, L)
    Gm = torch.zeros((G, nx, nw, L), **opts)
    e = torch.zeros((G, nx, L), **opts)

    Qg = torch.zeros((G, nx, nx, L), **opts)
    Sg = torch.zeros((G, nw, nx, L), **opts)
    Rg = torch.zeros((G, nw, nw, L), **opts)
    qxg = torch.zeros((G, nx, L), **opts)
    qug = torch.zeros((G, nw, L), **opts)

    Ch_parts, Dh_parts, hlo_parts, hhi_parts = [], [], [], []
    Cs_parts, Ds_parts, hofs_parts, slh_parts, suh_parts = [], [], [], [], []

    bx = _index(tuple(int(i) for i in idxbx), qp.A.device)
    if nbx:
        # global stage 0 (group 0, j = 0) is pinned by dx0: its box rows
        # are inactive in the full QP (xmask), so their rows are zeroed and
        # the builder's inactive band offsets (-1.0) kept
        mk = torch.ones((G, 1, 1, 1), **opts)
        mk[0] = 0.0

    for j in range(M):
        cols = slice(j * nu, (j + 1) * nu)
        # ---- cost contribution of stage j ----
        QE = _smm(Qc, E)                       # (G, nx, nx, L) = Q E_j
        QG = _smm(Qc, Gm)                      # (G, nx, nw, L) = Q G_j
        SE = _smm(Sc, E)                       # (G, nu, nx, L) = S E_j
        SG = _smm(Sc, Gm)                      # (G, nu, nw, L) = S G_j
        Qg = Qg + _gtm(E, QE)
        Sg = Sg + _gtm(Gm, QE)
        Sg[:, cols] += SE
        Rg = Rg + _gtm(Gm, QG)
        Rg[:, cols] += SG
        Rg[:, :, cols] += SG.transpose(1, 2)
        Rg[:, cols, cols] += Rc[None, :, :, None]
        gvec = qx_p[:, j] + _smv(Qc, e)        # (G, nx, L)
        qxg = qxg + _gtv(E, gvec)
        qug = qug + _gtv(Gm, gvec)
        qug[:, cols] += qu[:, j] + _smv(Sc, e)

        # ---- h rows of stage j (hard) ----
        if nHh:
            Chj = grp(qp.Ch)[:, j]             # (G, nHh, nx, L)
            Ch_parts.append(_gmm(Chj, E))
            Dh_parts.append(_gmm(Chj, Gm))
            corr = _gmv(Chj, e)                # (G, nHh, L)
            hlo_parts.append(grp(qp.hh_lo)[:, j] - corr)
            hhi_parts.append(grp(qp.hh_hi)[:, j] + corr)

        # ---- hard state-box rows of stage j -> general hard rows ----
        if nbx:
            Cxj = E[:, bx]                     # (G, nbx, nx, L)
            Dxj = Gm[:, bx]                    # (G, nbx, nw, L)
            corr = e[:, bx]                    # (G, nbx, L)
            if j == 0:
                Cxj = Cxj * mk
                Dxj = Dxj * mk
            Ch_parts.append(Cxj)
            Dh_parts.append(Dxj)
            hlo_parts.append(grp(qp.xb_lo)[:, j] - corr)
            hhi_parts.append(grp(qp.xb_hi)[:, j] + corr)

        # ---- soft rows of stage j ----
        if nS:
            Csj = grp(qp.Cs)[:, j]
            Cs_parts.append(_gmm(Csj, E))
            Ds_parts.append(_gmm(Csj, Gm))
            hofs_parts.append(grp(qp.hofs)[:, j] + _gmv(Csj, e))
            slh_parts.append(grp(qp.slh)[:, j])
            suh_parts.append(grp(qp.suh)[:, j])

        # ---- advance the chain: E_{j+1}, G_{j+1}, e_{j+1} ----
        Aj, Bj, cj = A[:, j], B[:, j], c[:, j]
        Gm = _gmm(Aj, Gm)
        Gm[:, :, cols] += Bj
        e = _gmv(Aj, e) + cj
        E = _gmm(Aj, E)

    # ---- macro dynamics & terminal (after the j = M-1 advance) ----
    qx_c = torch.cat([qxg, qp.qx[-1:]], dim=0)

    # ---- macro u-box: boxes stay boxes, j-major stacking ----
    idxbu_c = tuple(j * nu + int(i) for j in range(M) for i in idxbu)
    nbu = len(idxbu)
    ub_lo_c = grp(qp.ub_lo).reshape(G, M * nbu, L)
    ub_hi_c = grp(qp.ub_hi).reshape(G, M * nbu, L)

    def cat(parts, width=None):
        if not parts:
            shape = (G, 0, L) if width is None else (G, 0, width, L)
            return torch.zeros(shape, **opts)
        return torch.cat(parts, dim=1)

    def tile(z):
        return z.repeat(M, 1) if z.shape[0] else z

    qp_c = LaneQP(
        A=E, B=Gm, c=e, dx0=qp.dx0,
        Qc=Qg, QN=qp.QN, Sc=Sg, Rc=Rg, qx=qx_c, qu=qug,
        ub_lo=ub_lo_c, ub_hi=ub_hi_c,
        xb_lo=torch.zeros((G, 0, L), **opts),
        xb_hi=torch.zeros((G, 0, L), **opts),
        xmask=torch.ones((G, 1, 1), **opts),
        Ch=cat(Ch_parts, nx), hh_lo=cat(hlo_parts), hh_hi=cat(hhi_parts),
        Cs=cat(Cs_parts, nx), hofs=cat(hofs_parts), slh=cat(slh_parts),
        suh=cat(suh_parts),
        zl=tile(qp.zl), Zl=tile(qp.Zl), zu=tile(qp.zu), Zu=tile(qp.Zu),
        lsh=tile(qp.lsh), ush=tile(qp.ush),
        Dh=cat(Dh_parts, nw) if (nHh + nbx) else None,
        Ds=cat(Ds_parts, nw) if nS else None,
    )
    return qp_c, idxbu_c, CondenseAux(A=A, B=B, c=c, M=M, nu=nu)


def expand_solution(aux: CondenseAux, dx_c, du_c):
    """Macro solution -> full-resolution (dx (N+1, nx, L), du (N, nu, L)).

    dx_c: (G+1, nx, L) macro states (group starts and the terminal one);
    du_c: (G, M nu, L) stacked group controls (j-major).  Interior states
    come from the exact linear intra-group recursion; the group-start and
    terminal states are the macro solution's."""
    G, nx, L = aux.A.shape[0], aux.A.shape[2], aux.A.shape[-1]
    M, nu = aux.M, aux.nu
    w = du_c.reshape(G, M, nu, L)
    cur = dx_c[:-1]                            # (G, nx, L)
    stages = [cur]
    for j in range(M - 1):
        cur = _gmv(aux.A[:, j], cur) + _gmv(aux.B[:, j], w[:, j]) \
            + aux.c[:, j]
        stages.append(cur)
    dx_path = torch.stack(stages, dim=1).reshape(G * M, nx, L)
    dx = torch.cat([dx_path, dx_c[-1:]], dim=0)
    return dx, w.reshape(G * M, nu, L)
