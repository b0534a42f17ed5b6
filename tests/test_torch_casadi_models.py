"""The port's CasADi transcriptions (`parity/casadi_models.py`), float64 on
the CPU: the torch binding against the port's production models
(`models/variants.py`) and against the JAX package's jnp binding of the
same text, at rtol = atol = 1e-12; the race car on the synthetic curved
track; the drag switch's two branches; batched calls against point-wise
ones; the import-gated casadi binding; and the transcription's
linearization in the CUDA kernel's layout, which `chip_smoke.py` holds
against the kernel, against the kernel's plain version here."""

import zlib

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.parity import casadi_models as jcm
from mpc_collisionavoidance_tpu_torch.kernels import linearize as klin
from mpc_collisionavoidance_tpu_torch.models import registry, variants
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes_plain)
from mpc_collisionavoidance_tpu_torch.parity import casadi_models as cm
from mpc_collisionavoidance_tpu_torch.utils import track as trk
from tests.torch_guidance import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-12)
POINTS = 25
NAMES = sorted(set(cm.VARIANTS))


def _points(name, salt=0):
    """POINTS random (x, u, p) of `name`'s model, state-first: x (nx,
    POINTS), u (nu, POINTS), p (np, POINTS); seeded by the name's CRC-32
    (stable across interpreters, unlike `hash`)."""
    m = registry.get(cm._registry_name(name))
    rng = np.random.default_rng(zlib.crc32(name.encode()) + salt)
    x = (np.asarray(m.x0, float)[:, None]
         + 0.8 * rng.standard_normal((m.nx, POINTS)))
    u = 0.5 * rng.standard_normal((m.nu, POINTS))
    p = 5.0 + rng.standard_normal((m.np_, POINTS))
    return m, x, u, p


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_variants_are_the_jax_packages():
    assert cm.VARIANTS == jcm.VARIANTS and len(cm.VARIANTS) == 14


@pytest.mark.parametrize("name", NAMES)
def test_numeric_f_matches_port_model(name):
    m, x, u, p = _points(name)
    f = cm.numeric_f(name)
    for i in range(POINTS):
        xi, ui, pi = _t(x[:, i]), _t(u[:, i]), _t(p[:, i])
        np.testing.assert_allclose(f(xi, ui, pi).numpy(),
                                   m.f(xi, ui, pi).numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_numeric_h_matches_port_model(name):
    m, x, u, p = _points(name, salt=1)
    h = cm.numeric_h(name)
    if m.h is None:
        assert h is None
        return
    assert h is not None
    for i in range(POINTS):
        xi, ui, pi = _t(x[:, i]), _t(u[:, i]), _t(p[:, i])
        np.testing.assert_allclose(h(xi, ui, pi).numpy(),
                                   m.h(xi, pi).numpy(), **TOL, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_numeric_matches_jax_transcription(name):
    """The torch binding against the JAX package's jnp binding of the same
    expressions, on the same numpy points (both state-first)."""
    m, x, u, p = _points(name, salt=2)
    np.testing.assert_allclose(
        cm.numeric_f(name)(_t(x), _t(u), _t(p)).numpy(),
        np.asarray(jcm.numeric_f(name)(x, u, p)), **TOL, err_msg=name)
    h, jh = cm.numeric_h(name), jcm.numeric_h(name)
    assert (h is None) == (jh is None)
    if h is not None:
        np.testing.assert_allclose(h(_t(x), _t(u), _t(p)).numpy(),
                                   np.asarray(jh(x, u, p)), **TOL,
                                   err_msg=name)


def test_race_cars_curved_track_matches_track_model():
    """kappa_fn from the synthetic track: the transcription against the
    race car built on that track, over arc lengths of several laps (the
    seam, negative s)."""
    track = trk.make_synthetic_track()
    m = variants.race_cars(track)
    f = cm.numeric_f("race_cars", kappa_fn=trk.make_kappa_fn(track))
    h = cm.numeric_h("race_cars", kappa_fn=trk.make_kappa_fn(track))
    rng = np.random.default_rng(zlib.crc32(b"race_cars_track"))
    x = np.asarray(m.x0, float)[:, None] + 0.3 * rng.standard_normal(
        (m.nx, POINTS))
    x[0] = rng.uniform(-1.5, 2.5, POINTS) * track.length
    x[0, 0] = 0.0
    u, p = 0.5 * rng.standard_normal((m.nu, POINTS)), np.zeros((0, POINTS))
    np.testing.assert_allclose(f(_t(x), _t(u), _t(p)).numpy(),
                               m.f(_t(x), _t(u), _t(p)).numpy(), **TOL)
    np.testing.assert_allclose(h(_t(x), _t(u), _t(p)).numpy(),
                               m.h(_t(x), _t(p)).numpy(), **TOL)
    # the curvature enters: the straight binding differs here
    assert not torch.allclose(cm.numeric_f("race_cars")(_t(x), _t(u), _t(p)),
                              f(_t(x), _t(u), _t(p)))


def test_piecewise_drag_branches_covered():
    """The if_else surge-drag switch at u > 1.25 must agree on both
    branches (reference scripts/usv_pf_ca/usv_model.py:137-138)."""
    m = registry.get("usv_acados")
    f = cm.numeric_f("usv_acados")
    outs = []
    for u_val in (0.5, 1.9):
        x = _t([u_val, 0.1, -0.05, 3.0, 2.0])
        u, p = _t([1.0, -1.0]), _t(np.zeros(0))
        outs.append(f(x, u, p))
        np.testing.assert_allclose(outs[-1].numpy(), m.f(x, u, p).numpy(),
                                   **TOL)
    assert outs[0].dtype == torch.float64


@pytest.mark.parametrize("name", NAMES)
def test_batched_matches_pointwise(name):
    """A call on a batch with trailing shape (N, L) = (5, 7), state-first
    as the kernel's xs (nx, N, L), with the parameters per lane (np, L),
    against one call per point."""
    m = registry.get(cm._registry_name(name))
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 3)
    N, L = 5, 7
    x = np.asarray(m.x0, float)[:, None, None] + 0.5 * rng.standard_normal(
        (m.nx, N, L))
    u = 0.5 * rng.standard_normal((m.nu, N, L))
    p = 5.0 + rng.standard_normal((m.np_, L))
    f, h = cm.numeric_f(name), cm.numeric_h(name)
    fb = f(_t(x), _t(u), _t(p))
    hb = None if h is None else h(_t(x), _t(u), _t(p))
    assert fb.shape == (m.nx, N, L) and fb.dtype == torch.float64
    for n in range(N):
        for lane in range(L):
            xi, ui, pi = _t(x[:, n, lane]), _t(u[:, n, lane]), _t(p[:, lane])
            np.testing.assert_allclose(fb[:, n, lane].numpy(),
                                       f(xi, ui, pi).numpy(), **TOL)
            if h is not None:
                np.testing.assert_allclose(hb[:, n, lane].numpy(),
                                           h(xi, ui, pi).numpy(), **TOL)


def test_binding_keeps_dtype_and_broadcasts_constants():
    """float32 in, float32 out; the race car's straight-track constant
    kap = 0.0 and the constant rows broadcast to the batch."""
    x = torch.zeros((6, 3, 2), dtype=torch.float32)
    x[3] = 1.0
    out = cm.numeric_f("race_cars")(x, torch.zeros((2, 3, 2)),
                                    torch.zeros(0))
    assert out.dtype == torch.float32 and out.shape == (6, 3, 2)
    out = cm.numeric_f("usv_guidance4")(torch.ones(4, 9, dtype=torch.float32),
                                        torch.ones(1, 9), torch.zeros(0))
    assert out.dtype == torch.float32 and out.shape == (4, 9)
    assert torch.equal(out[:2], torch.zeros(2, 9))


@pytest.mark.parametrize("name", NAMES)
def test_casadi_binding_importgated(name):
    """make_casadi_model_fn builds for every variant; calling it without
    casadi raises ImportError (with casadi, it returns the model's
    symbols)."""
    fn = cm.make_casadi_model_fn(name)
    try:
        import casadi  # noqa: F401
        has_casadi = True
    except ImportError:
        has_casadi = False
    if has_casadi:
        m = registry.get(cm._registry_name(name))
        x, u, p, f, h = fn()
        assert f.shape[0] == m.nx and (h is None) == (m.h is None)
    else:
        with pytest.raises(ImportError):
            fn()


FORMS = [*klin.CUDA_MODELS, *(f"{n}_track" for n in klin.TRACK_FORMS)]


@pytest.mark.parametrize("form", FORMS)
def test_linearize_lanes_matches_plain_kernel(form):
    """The transcription's linearization (what `chip_smoke.py` phase 22
    holds against the CUDA kernel) against the kernel's plain version on
    the CPU, at N=3, L=4, float64; the Jacobian columns outside the
    model's f_dep are exact identity (states) or zero (controls), and
    those of C outside h_dep exactly zero, as the kernel leaves them."""
    curved = form.endswith("_track")
    name = form[:-len("_track")] if curved else form
    track = trk.make_synthetic_track() if curved else None
    spec = builders.build(name, **({"track": track} if curved else {}))
    m = spec.model
    rng = np.random.default_rng(zlib.crc32(form.encode()))
    N, L = 3, 4
    xs = np.asarray(m.x0, float)[:, None, None] + 0.3 * rng.standard_normal(
        (m.nx, N, L))
    if name == "race_cars":
        xs[0] = rng.uniform(-1.5, 2.5, (N, L)) * trk.make_synthetic_track(
        ).length
        xs[3] = rng.uniform(0.2, 1.5, (N, L))
    args = [_t(xs), _t(0.3 * rng.standard_normal((m.nu, N, L))),
            _t(rng.uniform(2.0, 50.0, (m.np_, L)))]
    kw = dict(dt=spec.dt, integrator_steps=spec.integrator_steps)
    got = cm.linearize_lanes(
        name, *args, kappa_fn=trk.make_kappa_fn(track) if curved else None,
        **kw)
    want = linearize_lanes_plain(*args, model=m, **kw)
    for what, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                   err_msg=f"{form} {what}")
    J, C = got[1], got[3]
    for k in set(range(m.nx + m.nu)) - set(m.f_dep):
        col = torch.zeros(m.nx, dtype=J.dtype)
        if k < m.nx:
            col[k] = 1.0
        assert torch.equal(J[:, :, k, :], col[None, :, None].expand(
            N, m.nx, L)), (form, k)
    for k in set(range(m.nx)) - set(m.h_dep or ()):
        assert torch.equal(C[:, :, k, :], torch.zeros_like(C[:, :, k, :]))


def test_abs_kink_rule():
    """|.| differentiates as jnp.abs (+1 at 0), as both packages' models;
    an op set with `torch.abs` (CasADi's sign(0) = 0) differs from the
    models only where an argument of |.| is exactly 0 (here the sway v,
    with yaw rate r != 0: d rdot/d v holds Nrv |v|' r)."""

    class CasadiKinks(cm._TorchOps):
        fabs = staticmethod(torch.abs)

    m = registry.get("usv_acados")
    u, p = _t([1.0, -1.0]), _t(np.zeros(0))

    def casadi_f(x, u, p):
        return cm._EXPRS["usv_acados"](x, u, p,
                                       CasadiKinks(x.dtype, x.device))[0]

    def jac(f, x):
        return torch.func.jacfwd(lambda y: f(y, u, p))(x)

    for v in (0.0, 0.1):
        x = _t([0.8, v, -0.3, 3.0, 2.0])
        want = jac(m.f, x)
        assert torch.equal(jac(cm.numeric_f("usv_acados"), x), want)
        casadi = jac(casadi_f, x)
        if v:
            assert torch.equal(casadi, want)
        else:
            apart = (casadi - want).abs() > 1e-12
            assert apart[:, 1].any() and not apart[:, [0, 2, 3, 4]].any()
