"""The port's structural dependency probes (`ops/sparsity.py`) against the
models' declarations and the JAX package's probes, on the CPU.

Every port model's `f_dep`/`h_dep` (which the plain lane linearization
and the K2 forms use to skip tangents) must equal what `torch.func.jacfwd`
finds at the probe points, and what JAX's probes find on JAX's model; the
curved-track race car reads s and n through its curvature table and is
dense; and the sparse QP of the plain linearization equals the dense one
bitwise (a skipped tangent is exactly trivial, not approximately).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.models import variants as jvariants
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops import sparsity as jsparsity
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu.utils import track as jtrack
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.sparsity import (
    constraint_dependency, input_dependency)
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           to_lanes)
from mpc_collisionavoidance_tpu_torch.utils.track import make_synthetic_track


@pytest.mark.parametrize("name", sorted(builders.BUILDERS))
def test_declared_deps_match_probes(name):
    m = builders.build(name).model
    jm = jbuilders.build(name).model
    probed_f = input_dependency(m.f, m.nx, m.nu, m.np_)
    assert m.f_dep is not None, f"{name}: declare f_dep"
    assert tuple(m.f_dep) == probed_f, (name, m.f_dep, probed_f)
    assert probed_f == jsparsity.input_dependency(jm.f, jm.nx, jm.nu,
                                                  jm.np_)
    if m.nh:
        probed_h = constraint_dependency(m.h, m.nx, m.np_)
        assert m.h_dep is not None, f"{name}: declare h_dep"
        assert tuple(m.h_dep) == probed_h, (name, m.h_dep, probed_h)
        assert probed_h == jsparsity.constraint_dependency(jm.h, jm.nx,
                                                           jm.np_)
    else:
        assert constraint_dependency(None, m.nx, m.np_) == ()


def test_curved_race_car_is_dense():
    """On the curved track f reads s and n through the curvature table:
    the probes see them, as JAX's see them through its interpolant, and
    the model declares them."""
    m = builders.race_cars(track=make_synthetic_track()).model
    probed = input_dependency(m.f, m.nx, m.nu, m.np_)
    assert 0 in probed and 1 in probed
    assert probed == tuple(m.f_dep)
    jm = jvariants.race_cars(
        kappa_fn=jtrack.make_kappa_fn(jtrack.make_synthetic_track()))
    assert probed == jsparsity.input_dependency(jm.f, jm.nx, jm.nu, jm.np_)
    straight = builders.race_cars().model
    assert 0 not in input_dependency(straight.f, straight.nx, straight.nu,
                                     straight.np_)


def test_sparse_qp_bitwise_equals_dense():
    """The flagship's lane QP off a warm iterate, built by the plain
    linearization with the declared f_dep/h_dep and with none (every
    tangent): bitwise equal."""
    spec = builders.usv_guidance_ca1(Tf=1.0, N=10)
    sc = jscenarios.guidance_ca1_default()
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (4, 8)).copy()
    x0s[:, 2] += 0.3 * rng.standard_normal(4)
    xL = to_lanes(torch.as_tensor(x0s))
    pL = to_lanes(torch.as_tensor(np.broadcast_to(sc.params, (4, 16)).copy()))
    lhL = to_lanes(torch.as_tensor(np.broadcast_to(sc.lh, (4, 8)).copy()))
    qps = []
    for dense in (False, True):
        s = LaneRTISolver(spec, ipm_iters=5, device="cpu",
                          dtype=torch.float64)
        if dense:
            s.spec = dataclasses.replace(spec, model=dataclasses.replace(
                spec.model, f_dep=None, h_dep=None))
        st, out = s.step_fn(s.init_state(x0s), xL, pL, lhL)
        qps.append(s._build_qp(st, out.x1, pL, lhL))
    for field in ("A", "B", "c", "Ch", "Cs", "hofs", "qx", "qu"):
        assert torch.equal(getattr(qps[0], field), getattr(qps[1], field)), \
            field
