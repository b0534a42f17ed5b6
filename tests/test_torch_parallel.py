"""The port's scenario-parallel layer (`parallel/`) against the JAX
package's, on the CPU.

The port's side runs as two gloo ranks (`tests/torch_parallel_worker.py`
under `parallel.dryrun.launch`, one pair of processes for the module,
started once and read by every case); JAX's side runs in this process on
a 2-device sub-mesh of conftest's virtual CPU mesh.  Both take the same
global inputs (the worker's `*_inputs`), float64, at the flagship's test
size N=8, Tf=0.4.
"""

import concurrent.futures
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from mpc_collisionavoidance_tpu.guidance.controller import (
    Measurements as JaxMeas)
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.parallel import (
    fleet_metrics as jfleet_metrics, make_mesh as jmake_mesh,
    make_sharded_batch_solver as jsharded, shard_batch as jshard_batch)
from mpc_collisionavoidance_tpu.sim.fleet import FleetMissionEngine as JFleet
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JLane
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver as JRTI
from mpc_collisionavoidance_tpu_torch.config import SolverConfig
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import check_group
from mpc_collisionavoidance_tpu_torch.parallel import distributed, dryrun
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           to_lanes)
from tests.torch_parallel_worker import (ESC_KW, MISSION_TICKS, TF, N,
                                         batch_inputs, escalation_inputs,
                                         metric_inputs, mission_inputs)

WORKER = pathlib.Path(__file__).with_name("torch_parallel_worker.py")
F64 = torch.float64
RANKS = 2


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The two ranks' results, [rank0, rank1] dicts of arrays: the ranks
    start once, in the background, and the first case to read them
    waits (the launcher stops them after 240 s; each rank's process
    group times out after 120 s)."""
    out = tmp_path_factory.mktemp("parallel")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    run = pool.submit(dryrun.launch, RANKS, [str(WORKER), str(out)], 240)

    def results():
        code, text = run.result()
        assert code == 0, f"the ranks failed (exit {code}):\n{text}"
        return [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]

    yield results
    pool.shutdown()


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(n_devices=RANKS, devices=jax.devices("cpu"))


@pytest.fixture
def lone():
    """A test that may start a one-rank process group in this process;
    the group is destroyed after it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _cat(results, key, axis=0):
    return np.concatenate([r[key] for r in results], axis=axis)


def _lane_shard(mesh, x):
    """JAX's dryrun idiom: the minor-most lane axis sharded."""
    x = jnp.asarray(x)
    return jax.device_put(x, NamedSharding(
        mesh, P(*([None] * (x.ndim - 1) + ["dp"]))))


def test_escalation_predicate_is_reduced_over_the_mesh(port, jmesh):
    """The escalation tier (2 fixed IPM iterations + up to 12 escalation
    steps, adaptive) at L=16 with the lane axis over two ranks: within
    1e-12 of the port's one-process tick over the 16 lanes, with its
    escalation count on both ranks, and within 5e-6 of JAX's jitted tick
    on lane-sharded inputs, status identical.  Rank 1's lanes need more
    steps than rank 0's: a rank-local predicate stops rank 0 early and
    leaves its lanes elsewhere, which the mesh-wide one does not."""
    x0b, p, lh = escalation_inputs()
    jlane = JLane(jbuilders.usv_guidance_ca1(Tf=TF, N=N), **ESC_KW)
    jstate = jax.tree.map(lambda a: _lane_shard(jmesh, a),
                          jlane.init_state(x0b, dtype=jnp.float64))
    jstate, jout = jax.jit(jlane.step_fn)(
        jstate, _lane_shard(jmesh, np.moveaxis(x0b, 0, -1)),
        _lane_shard(jmesh, p), _lane_shard(jmesh, lh))

    one = LaneRTISolver(builders.usv_guidance_ca1(Tf=TF, N=N), **ESC_KW,
                        device="cpu", dtype=F64)
    st, o = one.step_fn(one.init_state(x0b), to_lanes(torch.as_tensor(x0b)),
                        p, lh)
    steps = int(one.last_esc_iters)
    res = port()
    for r in res:
        assert int(r["esc_steps"]) == steps
    for k, want, jwant in (("u0", o.u0, jout.u0), ("x1", o.x1, jout.x1),
                           ("gap", o.gap, jout.gap),
                           ("xbar", st.xbar, jstate.xbar),
                           ("ubar", st.ubar, jstate.ubar)):
        got = _cat(res, f"esc_{k}", axis=-1)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12,
                                   err_msg=k)
        np.testing.assert_allclose(got, np.asarray(jwant), rtol=0,
                                   atol=5e-6, err_msg=k)
    np.testing.assert_array_equal(_cat(res, "esc_status"), o.status.numpy())
    np.testing.assert_array_equal(_cat(res, "esc_status"),
                                  np.asarray(jout.status))
    # the inputs split the ranks: alone, rank 0 would stop early
    local = [int(r["local_steps"]) for r in res]
    assert local[0] < steps == local[1], (local, steps)
    moved = np.abs(res[0]["local_xbar"] - res[0]["esc_xbar"]).max()
    assert moved > 1e-6, moved


def test_sharded_batch_solver_matches_jax(port, jmesh):
    """`make_sharded_batch_solver` at B_global=16 on global DTensors
    (`shard_batch_global`, shape (16, 8) as JAX's test asserts) within
    1e-8 of JAX's sharded vmap step; both ranks' `fleet_metrics` equal,
    and equal to JAX's.  `shard_batch` refuses an uneven split, as JAX's
    device_put does."""
    x0s, params, lhs = batch_inputs()
    jsolver = JRTI(jbuilders.usv_guidance_ca1(Tf=TF, N=N), ipm_iters=4)
    states = jax.vmap(lambda x: jsolver.init_state(x, dtype=jnp.float64))(
        jnp.asarray(x0s))
    args = jshard_batch(jmesh, (states, *map(jnp.asarray,
                                             (x0s, params, lhs))))
    _, jouts = jsharded(jsolver, jmesh, donate=False)(*args)
    jfrac, jgmax = jfleet_metrics(jmesh, jouts.status, jouts.qp_gap)
    res = port()
    for r in res:
        assert r["uneven_refused"]      # a batch of 7 over two ranks
        assert tuple(r["global_shape"]) == (16, 8)
        assert tuple(r["batch_global_u0_shape"]) == (16, 1)
    for k in ("u0", "x1", "xtraj", "utraj", "qp_gap"):
        np.testing.assert_allclose(_cat(res, f"batch_{k}"),
                                   np.asarray(getattr(jouts, k)), rtol=0,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_array_equal(_cat(res, "batch_status"),
                                  np.asarray(jouts.status))
    np.testing.assert_array_equal(res[0]["batch_metrics"],
                                  res[1]["batch_metrics"])
    assert res[0]["batch_metrics"][0] == float(jfrac)
    np.testing.assert_allclose(res[0]["batch_metrics"][1], float(jgmax),
                               rtol=0, atol=1e-8)


def test_mission_tier_matches_jax(port, jmesh):
    """`dryrun_multichip`'s mission tier at 4 vehicles x 5 ticks, the
    vehicle axis over two ranks, against JAX's sharded FleetMissionEngine:
    track, cross-track error and heading command at 1e-6, identical
    status, activity and collision flags; the converged share (SUM),
    clearance and advance (MIN) as JAX's dryrun computes them, equal on
    both ranks."""
    meas0, wps, n_wp, field, valid = mission_inputs()

    def bshard(x):
        x = jnp.asarray(x)
        return jax.device_put(x, NamedSharding(
            jmesh, P(*(["dp"] + [None] * (x.ndim - 1)))))

    jfleet = JFleet(jbuilders.usv_guidance_ca1(Tf=TF, N=N), ipm_iters=10)
    wps_s, nwp_s = bshard(wps), bshard(n_wp)
    jlog = jax.jit(lambda m: jfleet.run(
        m, wps_s, nwp_s, jnp.asarray(field), jnp.asarray(valid),
        n_steps=MISSION_TICKS, dtype=jnp.float64))(
            JaxMeas(*(bshard(m) for m in meas0)))
    res = port()
    for k in ("pos", "ye", "psi_d"):
        np.testing.assert_allclose(_cat(res, f"mission_{k}", axis=1),
                                   np.asarray(getattr(jlog, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in ("active", "collision", "status"):
        np.testing.assert_array_equal(_cat(res, f"mission_{k}", axis=1),
                                      np.asarray(getattr(jlog, k)),
                                      err_msg=k)
    pos = np.asarray(jlog.pos)
    rows = field[valid]
    clear = (np.linalg.norm(pos[:, :, None, :] - rows[None, None, :, :2],
                            axis=-1) - rows[None, None, :, 2]).min()
    want = [float((np.asarray(jlog.status) == 0).mean()), clear,
            float(np.asarray(jlog.final.meas.nedy).min()) + 4.0]
    np.testing.assert_array_equal(res[0]["mission_metrics"],
                                  res[1]["mission_metrics"])
    np.testing.assert_allclose(res[0]["mission_metrics"], want, rtol=0,
                               atol=1e-6)


def test_fleet_metrics_match_jax_exactly(port, jmesh):
    """`fleet_metrics` (all-reduce SUM of the counts, MAX of the gap) on
    two ranks: equal on both, and exactly JAX's psum/pmax values."""
    st, gp = metric_inputs()
    jfrac, jgmax = jfleet_metrics(jmesh, *jshard_batch(
        jmesh, (jnp.asarray(st), jnp.asarray(gp))))
    for r in port():
        assert r["metrics"][0] == float(jfrac)
        assert r["metrics"][1] == float(jgmax)


def test_dryrun_tiers_pass_on_two_ranks(port):
    """`dryrun_multichip`'s four tiers and their gates at N=8 on two gloo
    ranks (a gate that fails fails the rank); every metric is a
    collective, so both ranks report the same."""
    res = port()
    np.testing.assert_array_equal(res[0]["dryrun"], res[1]["dryrun"])


def test_distributed_single_process(monkeypatch, lone):
    """A lone process: `init` is a no-op returning 0, the global mesh is
    a one-rank group of its own, and `per_process_batch` checks
    divisibility with JAX's message (tests/test_utils_config.py)."""
    assert distributed.init() == 0
    assert not dist.is_initialized()
    mesh = distributed.global_scenario_mesh(device="cpu")
    assert mesh.size() == 1 and mesh.device_type == "cpu"
    assert mesh.mesh_dim_names == ("dp",)
    assert distributed.init() == 0
    assert distributed.per_process_batch(64) == 64
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    assert distributed.per_process_batch(64) == 16
    with pytest.raises(ValueError, match="not divisible"):
        distributed.per_process_batch(7)


def test_one_rank_group_tick_equals_plain_tick(lone):
    """The escalation tier at L=16 with its predicate all-reduced over a
    lone process's one-rank gloo group equals the tick without a group
    bitwise, with the same escalation count (the CPU counterpart of
    chip_smoke phase 20(a)'s check on the card)."""
    x0b, p, lh = escalation_inputs()
    group = distributed.make_mesh(device="cpu").get_group()
    res = []
    for g in (None, group):
        solver = LaneRTISolver(builders.usv_guidance_ca1(Tf=TF, N=N),
                               **ESC_KW, device="cpu", dtype=F64, group=g)
        st, o = solver.step_fn(solver.init_state(x0b),
                               to_lanes(torch.as_tensor(x0b)), p, lh)
        res.append((o, st, int(solver.last_esc_iters)))
    (o, st, k), (og, stg, kg) = res
    assert kg == k > 0
    for a, b in zip((*o, *st), (*og, *stg)):
        assert torch.equal(a, b)


def _nccl_on_cpu():
    distributed.init("localhost:1", num_processes=2, process_id=0,
                     device="cpu", backend="nccl")


def _launcher_more_ranks_than_gpus():
    # NCCL, one GPU per rank: this host has none (the card's host one)
    dryrun.main(["--ranks", str(torch.cuda.device_count() + 1)])


def _mesh_of_another_device():
    # a CPU mesh's (gloo) group for a captured tick on the card
    check_group(distributed.make_mesh(device="cpu").get_group(),
                torch.device("cuda"), capture=True)


def _instance_engine_with_a_mesh():
    SolverConfig(engine="instance").build(
        builders.usv_guidance_ca1(Tf=TF, N=N), device="cpu", dtype=F64,
        group=distributed.make_mesh(device="cpu").get_group())


REFUSALS = {
    "nccl_on_cpu": (_nccl_on_cpu, "NCCL runs CUDA devices only"),
    "launcher_more_ranks_than_gpus": (
        _launcher_more_ranks_than_gpus,
        "no CUDA device|NCCL needs one GPU per rank"),
    "mesh_of_another_device": (_mesh_of_another_device, "needs NCCL"),
    "instance_engine_with_a_mesh": (_instance_engine_with_a_mesh,
                                    "instance engine takes no process "
                                    "group"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise(case, lone):
    """No fallback: each refusal raises ValueError."""
    call, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        call()
