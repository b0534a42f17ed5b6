"""Per-variant OCP builders (counterpart of
`mpc_collisionavoidance_tpu/ocp/builders.py`: all fourteen of its
builders).

The LINEAR_LS selection layout is identical across all variants: Vx stacks
the identity over the states, Vu appends one row per control (reference
scripts/usv_guidance_ca1/acados_settings.py:92-103).
"""

import numpy as np

from mpc_collisionavoidance_tpu_torch.models import registry, variants
from mpc_collisionavoidance_tpu_torch.ocp.spec import (LinearLSCost, OCPSpec,
                                                       SoftBoxPenalty,
                                                       SoftPenalty)


def _linear_ls(nx, nu, q_diag, r_diag, qe_diag, yref=None, yref_e=None):
    ny = nx + nu
    Vx = np.zeros((ny, nx))
    Vx[:nx, :nx] = np.eye(nx)
    Vu = np.zeros((ny, nu))
    Vu[nx:, :] = np.eye(nu)
    W = np.diag(np.concatenate([np.asarray(q_diag, float),
                                np.asarray(r_diag, float)]))
    Vx_e = np.eye(nx)
    W_e = np.diag(np.asarray(qe_diag, float))
    return LinearLSCost(
        Vx=Vx, Vu=Vu, W=W,
        yref=np.zeros(ny) if yref is None else np.asarray(yref, float),
        Vx_e=Vx_e, W_e=W_e,
        yref_e=np.zeros(nx) if yref_e is None else np.asarray(yref_e, float),
    )


def usv_guidance_ca1(Tf: float = 5.0, N: int = 100) -> OCPSpec:
    """Flagship OCP (reference scripts/usv_guidance_ca1/acados_settings.py).

    Q = diag(0,0,0.05,0.01,0,0,0,0), R = 0.2, Qe = diag(0,0,0.1,0.05,0,0,0,0)
    (:75-90); all 8 distance rows softened with zl = zu = 1, Zl = Zu = 0
    (:105-108), lsh = -0.2, ush = 0 (:154-178); |psied_dot| <= 0.5 (:118-120);
    Tf = 5, N = 100 (main.py:54-55).
    """
    m = registry.get("usv_guidance_ca1")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0, 0.05, 0.01, 0, 0, 0, 0],
        r_diag=[0.2],
        qe_diag=[0, 0, 0.1, 0.05, 0, 0, 0, 0],
    )
    soft = SoftPenalty(
        idxsh=np.arange(8),
        zl=np.ones(8), Zl=np.zeros(8),
        zu=np.ones(8), Zu=np.zeros(8),
        lsh=np.full(8, -0.2), ush=np.zeros(8),
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost, soft=soft)


def usv_pf_ca(Tf: float = 1.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_pf_ca/acados_settings.py:93-167 — hard distance
    constraints, full hydrodynamic model."""
    m = registry.get("usv_pf_ca")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0.3, 0.3, 80.0, 0, 0, 0.8, 0, 0, 0, 0, 0, 0.0001, 0.0001],
        r_diag=[0.0, 0.0],
        qe_diag=[0, 0.5, 0.5, 100.0, 0, 0, 1.0, 0, 0, 0, 0, 0, 0.0005, 0.0005],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost, soft=None)


def usv_pf(Tf: float = 1.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_pf/acados_settings.py:92-138."""
    m = registry.get("usv_pf")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0.3, 0.3, 80.0, 0, 0, 0.8, 0, 0, 0, 0, 0, 0.0001, 0.0001],
        r_diag=[0.0, 0.0],
        qe_diag=[0, 0.5, 0.5, 100.0, 0, 0, 1.0, 0, 0, 0, 0, 0, 0.0005, 0.0005],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def usv_acados(Tf: float = 1.0, N: int = 20) -> OCPSpec:
    """reference scripts/usv_acados/acados_settings.py:75-121."""
    m = registry.get("usv_acados")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[1e3, 1e-3, 1e3, 1e-1, 1e-1],
        r_diag=[1e-2, 1e-2],
        qe_diag=[5e3, 5e-3, 5e3, 5e-1, 5e-1],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def usv_low_level(Tf: float = 1.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_low_level/acados_settings.py:75-129; note the
    nonzero default yref (cospsi reference = 1)."""
    m = registry.get("usv_low_level")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0.1, 0.1, 0.1, 0, 0.0, 1e-7, 0.0],
        r_diag=[0.0, 0.0],
        qe_diag=[0, 0.05, 0.05, 0.1, 0, 0.0, 1e-6, 0.0],
        yref=[0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
        yref_e=[0, 0, 1, 0, 0, 0, 0, 0],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def usv_position_control(Tf: float = 1.0, N: int = 20) -> OCPSpec:
    """reference scripts/usv_position_control/acados_settings.py:76-121."""
    m = registry.get("usv_position_control")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[1e5, 1e5, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3],
        r_diag=[1e-2, 1e-2],
        qe_diag=[5e5, 5e5, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def usv_guidance_ca(Tf: float = 5.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_guidance_ca/acados_settings.py:75-120 —
    hard distance constraints (no idxsh), Q = diag(0,0,0.05,0.025,0,...)."""
    m = registry.get("usv_guidance_ca")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0, 0.05, 0.025, 0, 0, 0, 0, 0],
        r_diag=[0.0],
        qe_diag=[0, 0, 0.1, 0.05, 0, 0, 0, 0, 0],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost, soft=None)


def usv_guidance(Tf: float = 1.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_guidance/acados_settings.py:75-120."""
    m = registry.get("usv_guidance")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0, 0, 0.1, 0.1, 0, 0, 0.8, 0, 0],
        r_diag=[0.01],
        qe_diag=[0, 0, 0, 0.1, 0.1, 0, 0, 0.8, 0, 0],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def usv_guidance2(Tf: float = 1.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_guidance2/acados_settings.py:75-120."""
    m = registry.get("usv_guidance2")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0, 0, 0.05, 0.05, 0, 0, 0.02, 0.1, 0, 0.0, 0.0],
        r_diag=[0.0],
        qe_diag=[0, 0, 0, 0.1, 0.1, 0, 0, 0.03, 0.2, 0, 0.0, 0.0],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def usv_guidance3(Tf: float = 1.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_guidance3/acados_settings.py:75-120."""
    m = registry.get("usv_guidance3")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0, 0, 0.05, 0.05, 0, 0, 0.0, 0.07, 0, 0.1],
        r_diag=[0.03],
        qe_diag=[0, 0, 0, 0.1, 0.1, 0, 0, 0.0, 0.2, 0, 0.2],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def usv_guidance4(Tf: float = 1.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_guidance4/acados_settings.py:75-120."""
    m = registry.get("usv_guidance4")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0, 0.1, 0.3],
        r_diag=[0.2],
        qe_diag=[0, 0, 0.2, 0.5],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def usv_guidance5(Tf: float = 1.0, N: int = 100) -> OCPSpec:
    """reference scripts/usv_guidance5/acados_settings.py:75-120."""
    m = registry.get("usv_guidance5")
    cost = _linear_ls(
        m.nx, m.nu,
        q_diag=[0, 0, 0.1, 0.05, 0.0],
        r_diag=[0.01],
        qe_diag=[0, 0, 0.2, 0.1, 0.0],
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost)


def race_cars(Tf: float = 1.0, N: int = 50, track=None) -> OCPSpec:
    """reference scripts/race_cars/acados_settings.py:75-144 (upstream acados
    demo).  This variant DOES apply unscale = N/Tf to W and 1/unscale to W_e
    (:85-88), cancelling acados' dt cost scaling; we store the scaled W with
    cost_scaling="dt" to reproduce the same effective weights.  Softened rows
    idxsh = [0, 2] (a_long and track width n, :142); note it also uses 3 RK4
    substeps per interval (:155).

    `track`: a utils.track.Track — its curvature table enters the dynamics
    (the reference's kapparef_s bspline, bycicle_model.py:46-55).  None =
    straight track (kappa = 0)."""
    m = (registry.get("race_cars") if track is None
         else variants.race_cars(track=track))
    ny = m.nx + m.nu
    unscale = N / Tf
    Vx = np.zeros((ny, m.nx)); Vx[: m.nx, : m.nx] = np.eye(m.nx)
    Vu = np.zeros((ny, m.nu)); Vu[m.nx:, :] = np.eye(m.nu)
    Q = np.diag([1e-1, 1e-8, 1e-8, 1e-8, 1e-3, 5e-3])
    R = np.diag([1e-3, 5e-3])
    Qe = np.diag([5e0, 1e1, 1e-8, 1e-8, 5e-3, 2e-3])
    cost = LinearLSCost(
        Vx=Vx, Vu=Vu,
        W=unscale * np.block([[Q, np.zeros((m.nx, m.nu))],
                              [np.zeros((m.nu, m.nx)), R]]),
        yref=np.array([1.0, 0, 0, 0, 0, 0, 0, 0]),
        Vx_e=np.eye(m.nx), W_e=Qe / unscale, yref_e=np.zeros(m.nx),
    )
    soft = SoftPenalty(
        idxsh=np.array([0, 2]),
        zl=100 * np.ones(2), Zl=np.zeros(2),
        zu=100 * np.ones(2), Zu=np.zeros(2),
        lsh=np.zeros(2), ush=np.zeros(2),
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=cost, soft=soft,
                   integrator_steps=3)


def race_cars_dev(Tf: float = 1.0, N: int = 50, track=None) -> OCPSpec:
    """reference scripts/race_cars/acados_settings_dev.py:32-118 — the dev
    variant of the race-car OCP: ALL nh=5 h rows softened (idxsh=range(nh),
    :106), the track-width state bound softened too (nsbx=1, idxsbx=[0] into
    idxbx=[1], lsbx=usbx=0, :81-85), quadratic slack weights Zl=Zu=1 on top
    of zl=zu=100 (:66-70).  The reference drives it with SQP to
    convergence (:112-118); the lane engine runs it tick by tick.
    Cost/unscale identical to race_cars."""
    base = race_cars(Tf=Tf, N=N, track=track)
    m = base.model
    ns = m.nh
    soft = SoftPenalty(
        idxsh=np.arange(ns),
        zl=100 * np.ones(ns), Zl=np.ones(ns),
        zu=100 * np.ones(ns), Zu=np.ones(ns),
        lsh=np.zeros(ns), ush=np.zeros(ns),
    )
    soft_bx = SoftBoxPenalty(
        idxsbx=np.array([0]),
        zl=100 * np.ones(1), Zl=np.ones(1),
        zu=100 * np.ones(1), Zu=np.ones(1),
        lsbx=np.zeros(1), usbx=np.zeros(1),
    )
    return OCPSpec(model=m, N=N, Tf=Tf, cost=base.cost, soft=soft,
                   soft_bx=soft_bx, integrator_steps=base.integrator_steps)


BUILDERS = {
    "usv_guidance_ca1": usv_guidance_ca1,
    "usv_pf_ca": usv_pf_ca,
    "usv_pf": usv_pf,
    "usv_acados": usv_acados,
    "usv_low_level": usv_low_level,
    "usv_position_control": usv_position_control,
    "usv_guidance_ca": usv_guidance_ca,
    "usv_guidance": usv_guidance,
    "usv_guidance2": usv_guidance2,
    "usv_guidance3": usv_guidance3,
    "usv_guidance4": usv_guidance4,
    "usv_guidance5": usv_guidance5,
    "race_cars": race_cars,
    "race_cars_dev": race_cars_dev,
}


def build(name: str, **kw) -> OCPSpec:
    return BUILDERS[name](**kw)
