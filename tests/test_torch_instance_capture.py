"""The per-instance engine's captured tick (`solver/sqp_rti.py::RTISolver`
on `solver/capture.py::TickGraphs`), what of it the CPU can hold: the
static state's key, the `capture` switch from every place that builds the
engine, the tick against JAX's jitted one in float64, and the contract
that what an entry returns belongs to its caller.

The CPU has no CUDA graphs, so `ReplayOnCPU` stands in for
`capture.Program`: the "capture" runs the tick once on the program's
static inputs and keeps its outputs, each "launch" runs it again and
writes the results into those same tensors, as a graph replay does.  A
solver on it runs the whole `TickGraphs` path (static inputs, binding,
keys, copies out) of the card.  The card's own tests are in
tests/test_torch_cuda.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver as JaxRTI
from mpc_collisionavoidance_tpu_torch import cli, config
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import Escalation
from mpc_collisionavoidance_tpu_torch.parity import goldens
from mpc_collisionavoidance_tpu_torch.rt import server
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver import capture, sqp_rti
from mpc_collisionavoidance_tpu_torch.solver.batch import LaneState
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import (RTISolver,
                                                             SolverState)

F64 = torch.float64


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny factorizations crawl under torch's intra-op pool on a
    loaded host: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return []


class ReplayOnCPU:
    """`capture.Program` on the CPU (see the module docstring)."""

    def __init__(self, fn, device, group=None, name=None):
        self.fn, self.device = fn, device
        self.outputs, writes = fn(Escalation(device, group))
        for dst, src in writes:
            dst.copy_(src)

    def launch(self):
        out, writes = self.fn(Escalation(self.device))
        for dst, src in zip(_leaves(self.outputs), _leaves(out)):
            dst.copy_(src)
        for dst, src in writes:
            dst.copy_(src)


@pytest.fixture
def replay_on_cpu(monkeypatch):
    """`emulate(solver)`: the solver's entries on `TickGraphs` with
    `ReplayOnCPU` programs."""
    monkeypatch.setattr(capture, "Program", ReplayOnCPU)

    def emulate(solver):
        solver._graphs = capture.TickGraphs(solver)
        return solver

    return emulate


def test_static_state_key_tells_batch_shapes_apart():
    """Per-instance states of batch (), (1,), (4,), (64,) that share nx,
    and a lane state whose width is that nx, get five static states: the
    lane width `xbar.shape[-1]` would give them one."""
    N, nx, nu = 10, 8, 1
    states = [SolverState(torch.zeros(b + (N + 1, nx)),
                          torch.zeros(b + (N, nu)))
              for b in ((), (1,), (4,), (64,))]
    states.append(LaneState(torch.zeros(nx, N + 1, nx),
                            torch.zeros(nu, N, nx)))
    assert len({s.xbar.shape[-1] for s in states}) == 1
    assert len({capture.state_key(s) for s in states}) == 5


class _Built(Exception):
    pass


@pytest.mark.parametrize("where", ["SolverConfig.build", "FrameworkConfig",
                                   "cli run --config", "cli race",
                                   "RTServer vmap", "goldens rti",
                                   "goldens sqp"])
@pytest.mark.parametrize("switch", [True, False])
def test_capture_switch_reaches_rtisolver(monkeypatch, tmp_path, where,
                                          switch):
    """Every place that builds the per-instance engine passes `capture`
    on (the CLI as `--eager`); the engine's construction is stopped there,
    so nothing runs."""
    seen = []

    def record(*args, **kw):
        seen.append(kw.get("capture", "not passed"))
        raise _Built

    for module in (config, server, goldens, sqp_rti):
        monkeypatch.setattr(module, "RTISolver", record)
    spec = builders.usv_guidance4(Tf=0.1, N=10)
    cfg = config.FrameworkConfig(model="usv_guidance4", N=10, Tf=0.1,
                                 solver=config.SolverConfig(
                                     engine="instance"))
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(cfg.to_dict()))
    eager = [] if switch else ["--eager"]
    calls = {
        "SolverConfig.build": lambda: cfg.solver.build(
            spec, device="cpu", dtype=F64, capture=switch),
        "FrameworkConfig": lambda: cfg.build_solver(
            device="cpu", dtype=F64, capture=switch),
        "cli run --config": lambda: cli.main(
            ["run", "--config", str(path), "--device", "cpu", *eager]),
        "cli race": lambda: cli.main(["race", "--device", "cpu", *eager]),
        "RTServer vmap": lambda: server.RTServer(
            str(tmp_path / "x.sock"), engine="vmap", device="cpu",
            capture=switch),
        "goldens rti": lambda: goldens.compute_golden_rti(
            "usv_guidance4", 1, device="cpu", capture=switch),
        "goldens sqp": lambda: goldens.compute_golden(
            "usv_guidance_ca1", 1, device="cpu", capture=switch),
    }
    with pytest.raises(_Built):
        calls[where]()
    assert seen == [switch]


def _flagship_case():
    """The flagship (N=20) at B=4, ye spread, with a per-instance,
    per-stage yref and yref_e; params and lh shared."""
    N = 20
    spec = builders.usv_guidance_ca1(Tf=1.0, N=N)
    sc = scenarios.guidance_ca1_default()
    rng = np.random.default_rng(0)
    x0 = np.broadcast_to(sc.x0, (4, 8)).copy()
    x0[:, 2] += np.linspace(-0.5, 0.5, 4)
    ny = spec.cost.ny
    yref = (np.broadcast_to(spec.cost.yref, (4, N, ny))
            + 0.05 * rng.standard_normal((4, N, ny)))
    yref_e = (np.broadcast_to(spec.cost.yref_e, (4, len(spec.cost.yref_e)))
              + 0.05 * rng.standard_normal((4, len(spec.cost.yref_e))))
    return ("usv_guidance_ca1", dict(Tf=1.0, N=N), x0, sc.params, sc.lh,
            yref, yref_e, (0, 0, None, None, 0, 0))


def _low_level_case():
    """usv_low_level (N=10), one vehicle, its node's per-stage reference:
    one stage row broadcast over the horizon (a view, as
    `guidance/low_level.py` passes it)."""
    N = 10
    spec = builders.usv_low_level(Tf=0.1, N=N)
    sc = scenarios.low_level_default()
    yref = torch.tensor(sc.yref, dtype=F64).expand(N, spec.cost.ny)
    return ("usv_low_level", dict(Tf=0.1, N=N), np.asarray(sc.x0, float),
            np.zeros(spec.model.np_), None, yref,
            np.asarray(sc.yref_e, float), None)


@pytest.mark.parametrize("case", ["flagship_b4", "low_level"])
@pytest.mark.parametrize("replay", [False, True])
def test_captured_solver_matches_jax_jitted_step(case, replay,
                                                 replay_on_cpu):
    """`RTISolver(capture=True)` on the CPU (op by op; `replay`: on
    `TickGraphs`) against JAX's jitted `RTISolver.step` (its vmap for the
    batch), float64, two warm-started ticks (x0 <- x1): atol 1e-10,
    identical status."""
    name, hz, x0, p, lh, yref, yref_e, axes = {
        "flagship_b4": _flagship_case, "low_level": _low_level_case}[case]()
    js = JaxRTI(jbuilders.build(name, **hz))
    solver = RTISolver(builders.build(name, **hz), device="cpu", dtype=F64,
                       capture=True)
    if replay:
        replay_on_cpu(solver)
    step = jax.jit(js.step_fn if axes is None
                   else jax.vmap(js.step_fn, in_axes=axes))
    init = (js.init_state if axes is None
            else jax.vmap(lambda x: js.init_state(x, dtype=jnp.float64)))
    jst = (init(jnp.asarray(x0), dtype=jnp.float64) if axes is None
           else init(jnp.asarray(x0)))
    st = solver.init_state(x0)
    x = np.asarray(x0, float)
    ty = torch.as_tensor(yref)
    yref = np.asarray(yref)
    for _ in range(2):
        jst, jout = step(jst, jnp.asarray(x), jnp.asarray(p),
                         None if lh is None else jnp.asarray(lh),
                         jnp.asarray(yref), jnp.asarray(yref_e))
        st, out = solver.step_fn(st, x, p, lh, ty, yref_e)
        for field in ("u0", "x1", "xtraj", "utraj", "qp_gap"):
            np.testing.assert_allclose(getattr(out, field).numpy(),
                                       np.asarray(getattr(jout, field)),
                                       rtol=0, atol=1e-10, err_msg=field)
        np.testing.assert_array_equal(out.status.numpy(),
                                      np.asarray(jout.status))
        x = np.asarray(jout.x1)
    if replay:
        assert {k[0] for k in solver._graphs.programs} == {"step"}


def _solver_storages(solver):
    """The storages of every tensor the solver holds: its own and its QP
    builder's, and its programs' static inputs and outputs and static
    states."""
    held = list(capture._held(solver))
    graphs = solver._graphs
    if graphs is not None:
        for program in graphs.programs.values():
            held += _leaves(program.inputs) + _leaves(program.outputs)
        for st in graphs.states.values():
            held += _leaves(st)
    return {t.untyped_storage().data_ptr() for t in held if t.numel()}


@pytest.mark.parametrize("replay", [False, True])
def test_entries_return_tensors_of_their_own(replay, replay_on_cpu):
    """Every tensor that step_fn, prepare_fn and feedback_fn return
    shares no storage with the solver's tensors, and the outputs kept
    from tick k are unchanged after tick k+1 (jit's fresh arrays)."""
    N = 8
    spec = builders.usv_guidance_ca1(Tf=0.5, N=N)
    sc = scenarios.guidance_ca1_default()
    solver = RTISolver(spec, ipm_iters=6, device="cpu", dtype=F64)
    if replay:
        replay_on_cpu(solver)
    st = solver.init_state(sc.x0)
    x = torch.tensor(sc.x0)
    returned = []
    st1, out1 = solver.step_fn(st, x, sc.params, sc.lh)
    kept = [t.clone() for t in _leaves((st1, out1))]
    qp = solver.prepare_fn(st1, sc.params, sc.lh)
    st2, out2 = solver.feedback_fn(st1, qp, out1.x1)
    st3, out3 = solver.step_fn(st2, out2.x1, sc.params, sc.lh)
    returned = _leaves((st1, out1, qp, st2, out2, st3, out3))
    assert all(torch.equal(a, b) for a, b in zip(_leaves((st1, out1)),
                                                 kept))
    own = _solver_storages(solver)
    assert not any(t.untyped_storage().data_ptr() in own for t in returned
                   if t.numel())
    if replay:
        assert {k[0] for k in solver._graphs.programs} == {
            "step", "prepare", "feedback"}


def test_two_states_in_turn_match_two_solvers(replay_on_cpu):
    """Two vehicles' states taking ticks in turn through one solver on
    `TickGraphs` (one static state between them), each through
    prepare_fn + feedback_fn on alternate ticks, equal two plain solvers'
    runs bitwise."""
    N = 8
    spec = builders.usv_guidance_ca1(Tf=0.5, N=N)
    sc = scenarios.guidance_ca1_default()
    shared = replay_on_cpu(RTISolver(spec, ipm_iters=6, device="cpu",
                                     dtype=F64))
    alone = [RTISolver(spec, ipm_iters=6, device="cpu", dtype=F64)
             for _ in range(2)]
    x0s = [np.asarray(sc.x0, float), np.asarray(sc.x0, float) + 0.3]
    runs = []
    for solvers in ((shared, shared), alone):
        sts = [s.init_state(x) for s, x in zip(solvers, x0s)]
        xs = [torch.tensor(x) for x in x0s]
        log = []
        for k in range(4):
            for i, s in enumerate(solvers):
                if k % 2:
                    qp = s.prepare_fn(sts[i], sc.params, sc.lh)
                    sts[i], out = s.feedback_fn(sts[i], qp, xs[i])
                else:
                    sts[i], out = s.step_fn(sts[i], xs[i], sc.params, sc.lh)
                xs[i] = out.x1
                log += _leaves(out)
        runs.append(log)
    assert len(shared._graphs.states) == 1
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_cuda_device_without_cuda_raises():
    """No fallback: a CUDA solver on a host without CUDA is an error."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(ValueError, match="CUDA"):
        RTISolver(builders.usv_guidance4(Tf=0.1, N=10), device="cuda",
                  dtype=F64)
