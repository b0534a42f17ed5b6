"""The comparison that decides `correct`, shown to fail.

On the CPU at a size a test run holds (a few lanes, a few ticks; the
program runs its plain PyTorch versions there): each runner runs as the
benchmark runs it, past the harness's look for a card, once sound and
once for each fault that its cell can have, planted underneath the timed
path: a tick that returns its state unchanged, half of the batch left
out (its lanes keep their old state), and an answer altered where it is
produced.  The sound run is correct and every faulty one is not.  The
control (the reference with its linearization rounded to TF32, in the
program's place) reads above each cell's limits, `feas` and `cost_gap`
both, and the fleet's guidance and plant.  The reference itself
agrees with the program's float64 solve run to convergence.
"""

import time

import numpy as np
import pytest
import torch

from port_bench.control import control_checks
from port_bench.runners import common
from port_bench.harness import Context, is_correct
from port_bench.reference.qp import OCP


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lane_fault(kind):
    """A fault of the lane engine's step (lane_loop, fleet_mission)."""
    def wrap(step_fn):
        def step(state, *args, **kw):
            prior = (state.xbar.clone(), state.ubar.clone())
            st, out = step_fn(state, *args, **kw)
            lanes = slice(None) if kind == "unchanged" else slice(0, None, 2)
            if kind == "altered":
                st.ubar[:, 0, :] += 0.05
            else:
                st.xbar[..., lanes].copy_(prior[0][..., lanes])
                st.ubar[..., lanes].copy_(prior[1][..., lanes])
            return st, out
        return step
    return wrap


def _instance_fault(kind):
    def wrap(step_fn):
        def step(state, *args):
            st, out = step_fn(state, *args)
            if kind == "unchanged":
                st = type(st)(state.xbar.clone(), state.ubar.clone())
            else:
                st.ubar[0] += 0.05
            return st, out._replace(x1=st.xbar[1], u0=st.ubar[0])
        return step
    return wrap


def _ctx(cell, batch, ticks, fault=None):
    ctx = Context(cell, 3_000_000_019, 1.0, 0, time.perf_counter(),
                  device="cpu")
    tr = ctx.traffic
    if "batch" in tr:
        tr["batch"] = batch
    tr["reset_every"] = ticks
    tr["check"] = dict(tr["check"], ticks=2, lanes=batch,
                       min_ticks_per_s=ticks)
    ctx.max_ticks = ticks
    ctx.fault = fault
    return ctx


CASES = [("hull.fleet.b512", 4, 3, _lane_fault,
          ("unchanged", "half", "altered")),
         ("flagship.fleet_mission.b512", 4, 3, _lane_fault,
          ("unchanged", "half", "altered")),
         ("hull.node.b1", 1, 3, _instance_fault, ("unchanged", "altered"))]


def _run(ctx):
    import importlib
    runner = importlib.import_module(
        f"port_bench.runners.{ctx.traffic['runner']}")
    res = runner.run(ctx)
    return res, is_correct(res.checks)


@pytest.mark.parametrize("cell,batch,ticks,factory,kinds", CASES,
                         ids=[c[0] for c in CASES])
def test_sound_run_correct_faults_not(cell, batch, ticks, factory, kinds):
    res, ok = _run(_ctx(cell, batch, ticks))
    assert ok, res.checks
    for kind in kinds:
        res, ok = _run(_ctx(cell, batch, ticks, factory(kind)))
        assert not ok, (kind, res.checks)


# the numbers the control fails at this size; at the cells' own size the
# hull fleet's control also fails `cost_gap` (3.4e-2 and more at 32 lanes
# x 4 ticks; 8.5e-3 over 4 lanes x 2 ticks, below its limit 1.5e-2)
CONTROL_FAILS = {"hull.fleet.b512": {"feas"},
                 "flagship.fleet_mission.b512": {"feas", "cost_gap",
                                                 "guidance", "plant"},
                 "hull.node.b1": {"feas", "cost_gap"}}


@pytest.mark.parametrize("cell,batch,ticks", [c[:3] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_control_reads_above_the_limits(cell, batch, ticks):
    ctx = _ctx(cell, batch, ticks)
    _run(ctx)
    checks = control_checks(ctx)
    assert not is_correct(checks), checks
    over = {n for n, v, lim in checks if v > lim}
    assert CONTROL_FAILS[cell] <= over, checks


@pytest.mark.parametrize("name", ["usv_guidance_ca1", "usv_pf_ca"])
def test_reference_optimum_is_the_programs_converged_solve(name):
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    from mpc_collisionavoidance_tpu_torch.solver.batch import LaneRTISolver
    f64 = torch.float64
    spec = builders.build(name)
    sc = (scenarios.guidance_ca1_default() if name == "usv_guidance_ca1"
          else scenarios.pf_ca_default())
    L, nx = 2, spec.model.nx
    rng = np.random.default_rng(0)
    x0 = np.tile(sc.x0, (L, 1))
    x0[:, 2 if nx == 8 else 6] += 0.3 * rng.standard_normal(L)
    p, lh = np.tile(sc.params, (L, 1)), np.tile(sc.lh, (L, 1))
    yref = np.tile(sc.yref if sc.yref is not None
                   else np.zeros(spec.cost.ny), (L, 1))
    solver = LaneRTISolver(spec, ipm_iters=40, ipm_tol=1e-10,
                           centering="mehrotra", device="cpu", dtype=f64)
    st = solver.init_state(x0)

    def lanes(a):
        return torch.as_tensor(a.T.copy(), dtype=f64)

    prior = dict(xbar=st.xbar.permute(2, 1, 0).clone(),
                 ubar=st.ubar.permute(2, 1, 0).clone(),
                 x0=torch.as_tensor(x0, dtype=f64),
                 p=torch.as_tensor(p, dtype=f64),
                 lh=torch.as_tensor(lh, dtype=f64),
                 yref=torch.as_tensor(yref, dtype=f64),
                 yref_e=torch.as_tensor(yref[:, :nx], dtype=f64))
    st, out = solver.step_fn(st, lanes(x0), lanes(p), lanes(lh),
                             yref=lanes(yref), yref_e=lanes(yref[:, :nx]))
    assert (out.status == 0).all()
    r = OCP(name, "cpu").judge(prior, dict(
        xbar=st.xbar.permute(2, 1, 0), ubar=st.ubar.permute(2, 1, 0)))
    assert bool(r["ref_ok"].all())
    assert float(r["feas"].max()) < 1e-12
    assert float(r["cost_gap"].max()) < 1e-8


@pytest.mark.parametrize("cell", ["hull.fleet.b512",
                                  "flagship.fleet_mission.b512"])
def test_seed_orders_the_fleets_work_and_keeps_it(cell):
    """Two seeds run the same lanes' inputs, tick by tick, in another
    order over the lanes."""
    seen = {}
    for seed in (3_000_000_019, 7):
        x0s = []

        def record(step_fn):
            def step(st, x0, *args, **kw):
                x0s.append(x0.T.clone().numpy())
                return step_fn(st, x0, *args, **kw)
            return step

        ctx = _ctx(cell, 4, 3, record)
        ctx.seed = seed
        res, ok = _run(ctx)
        assert ok, res.checks
        seen[seed] = (common.lane_order(seed, 4), x0s, res.e2e)
    (o1, a, e1), (o2, b, e2) = seen.values()
    assert not np.array_equal(o1, o2)
    assert e1["converged_frac"] == e2["converged_frac"]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert not np.array_equal(x, y)
        np.testing.assert_allclose(x[np.lexsort(x.T)], y[np.lexsort(y.T)],
                                   rtol=1e-6, atol=1e-9)
