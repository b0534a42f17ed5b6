"""The port's experiment CLI (`python -m mpc_collisionavoidance_tpu_torch`)
against the JAX package's (`python -m mpc_collisionavoidance_tpu`): both
`cli.main` run in this process on the CPU, stdout captured (JAX in float64
under the suite's x64 conftest, the port with `--device cpu`)."""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import cli as jcli
from mpc_collisionavoidance_tpu_torch import cli
from tests.torch_guidance import one_torch_thread  # noqa: F401

# the keys whose values are wall-clock times, not results
TIMES = ("compile_plus_run_s", "steady_run_s", "solves_per_s_closed_loop")


def _main(main, argv):
    """(exit code, stdout's lines) of `main(argv)`."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()


def _metrics(main, argv):
    rc, lines = _main(main, argv)
    assert rc == 0, lines
    return json.loads(lines[-1])


def _assert_metrics(got, want, atol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in TIMES:
            assert got[k] > 0, k
        elif isinstance(w, float):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=atol,
                                       err_msg=k)
        else:
            assert got[k] == w, k


def test_run_config_instance_matches_jax(tmp_path):
    """`run --config` on the per-instance engine (tests/test_cli.py:25-36's
    config) for 30 steps, float64: every metric within 1e-8 of JAX's, the
    same keys and schedule string."""
    cfg = {"model": "usv_guidance4", "N": 10, "Tf": 0.1,
           "solver": {"engine": "instance", "ipm_iters": 6}}
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(cfg))
    argv = ["run", "--config", str(path), "--steps", "30"]
    want = _metrics(jcli.main, argv + ["--platform", "cpu"])
    got = _metrics(cli.main, argv + ["--device", "cpu"])
    assert got["schedule"] == want["schedule"] == "fixed@6"
    assert got["finite"] is True and got["engine"] == "instance"
    _assert_metrics(got, want, atol=1e-8)


def test_run_lane_engine_uses_variant_defaults_matches_jax():
    """`run --model usv_acados` with no -N/--tf: the variant's own horizon
    (N=20, Tf=1) on the production lane engine in float32; the metrics
    within 5e-3 of JAX's (the float32 spread between the engines).  6
    steps, not the JAX suite's 40: the hull family's plain linearization
    takes ~0.5 s a tick on this CPU, and the CLI runs the loop twice."""
    _lane_engine_run_matches_jax(6)


@pytest.mark.slow
def test_run_lane_engine_40_steps_matches_jax():
    """The same at the JAX suite's depth, 40 steps (20 after the
    transient), where warm starts and escalation have run for longer."""
    _lane_engine_run_matches_jax(40)


def _lane_engine_run_matches_jax(steps):
    argv = ["run", "--model", "usv_acados", "--steps", str(steps)]
    want = _metrics(jcli.main, argv + ["--platform", "cpu"])
    got = _metrics(cli.main, argv + ["--device", "cpu"])
    assert got["N"] == 20 and got["Tf"] == 1.0 and got["steps"] == steps
    assert got["engine"] == "lane" and got["schedule"] == "adaptive@4+esc24"
    assert got["finite"] is True
    _assert_metrics(got, want, atol=5e-3)


def test_models_matches_jax():
    rc, want = _main(jcli.main, ["models"])
    assert rc == 0
    rc, got = _main(cli.main, ["models"])
    assert rc == 0
    assert len(got) == 13 and got == want


def test_run_rejects_unknown_model():
    with pytest.raises(ValueError, match="unknown model"):
        cli.main(["run", "--model", "usv_bogus", "--steps", "5",
                  "--device", "cpu"])


@pytest.mark.parametrize("argv", [["run", "--steps", "2"],
                                  ["race", "--steps", "2"],
                                  ["mission", "--steps", "2"]])
def test_commands_refuse_a_host_without_cuda(argv, monkeypatch):
    """The default device is cuda: without one each command raises the
    no-CUDA error, never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        cli.main(argv)


def _options(main, sub):
    """The option strings in `main([sub, "--help"])`'s help text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main([sub, "--help"])
    return set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w-]*)", buf.getvalue()))


# the port's own flags: the per-instance and lane ticks op by op instead
# of captured (JAX's jitted CLI has no such switch)
PORT_FLAGS = {"run": {"--eager"}, "race": {"--eager"}}


@pytest.mark.parametrize("sub", ["run", "race", "mission", "models"])
def test_flags_match_jax(sub):
    """Each subcommand takes JAX's flags, `--platform` as `--device`, and
    the port's `PORT_FLAGS` (JAX's `bench` runs its jax bench.py and is
    not ported)."""
    want = {"--device" if o == "--platform" else o
            for o in _options(jcli.main, sub)}
    assert _options(cli.main, sub) == want | PORT_FLAGS.get(sub, set())


@pytest.mark.slow
def test_cli_race(tmp_path):
    """`race` runs the curved-track race car and saves the track plot
    (tests/test_cli.py::test_cli_race on the port)."""
    out = _metrics(cli.main, ["race", "--steps", "120", "--device", "cpu",
                              "--plots", str(tmp_path / "race")])
    assert out["finite"] is True
    assert out["s_final"] > 0.3
    assert (tmp_path / "race_track.png").exists()


@pytest.mark.slow
def test_cli_mission_markers(tmp_path):
    """`mission --markers` (tests/test_viz.py::test_cli_mission_markers on
    the port): 30 frames written and read back."""
    from mpc_collisionavoidance_tpu_torch.utils import viz
    rc, lines = _main(cli.main, ["mission", "--steps", "120", "--stride",
                                 "4", "--device", "cpu", "--markers",
                                 str(tmp_path / "m.jsonl")])
    assert rc == 0
    assert json.loads(lines[0])["frames"] == 30
    assert len(viz.read_jsonl(str(tmp_path / "m.jsonl"))) == 30
