"""The benchmark's files against its contract: the manifest, the files it
names, the generators, and what a run may import.  CPU only; nothing here
needs a card."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from port_bench.runners import common
from port_bench.harness import CHECKOUT, ROOT, load_json
from port_bench.vendor.missions import random_missions

MAN = load_json(CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in MAN["workloads"]}
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_manifest_keys_and_names():
    assert list(MAN) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert MAN["paths"] == ["port_bench"]
    assert MAN["command"] == ["python3", "-m", "port_bench.run"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [c["name"] for c in MAN["configs"]] + list(CELLS) + [
        m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in CELLS.values()]:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in MAN["configs"]]
                 + [c["why"] for c in MAN["configs"]]
                 + [w["why"] for w in CELLS.values()]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(MAN)) < 64 * 1024


def test_bounds_and_budget():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in CELLS.values():
        assert w["chips"] == 1
        others = [m for m in MAN["end_to_end"]
                  if m["name"] != "setup_s" and _reports(m, w["name"])]
        assert others, w["name"]
    # a full check of 24 cells fits in the check's time
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_files_found_by_name():
    for c in MAN["configs"]:
        cfg = load_json(CHECKOUT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("port_bench/configs/")
    for name, w in CELLS.items():
        tr = load_json(ROOT / "traffic" / f"{w['traffic']}.json")
        assert (ROOT / "runners" / f"{tr['runner']}.py").exists()
        limits = load_json(ROOT / "limits" / f"{name}.json")
        assert all("limit" in v for v in limits.values())
    for m in MAN["per_layer"]:
        path = ROOT / "metrics" / f"{m['name']}.py"
        assert path.exists(), path
        assert "def read(" in path.read_text()


def test_layer_metrics_move_what_their_cells_report():
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert _reports(E2E[m["moves"]], cell), (m["name"], cell)


def test_layer_readers_read_nothing_from_nothing():
    import importlib.util
    for m in MAN["per_layer"]:
        spec = importlib.util.spec_from_file_location(
            "reader", ROOT / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.read({}) is None, m["name"]


def test_generators_repeat_for_a_seed():
    tr = load_json(ROOT / "traffic" / "fleet_closed_loop.json")
    a = common.path_starts(common.rng_of(2**31 + 7, 1), 40, tr["starts"])
    b = common.path_starts(common.rng_of(2**31 + 7, 1), 40, tr["starts"])
    c = common.path_starts(common.rng_of(2**31 + 8, 1), 40, tr["starts"])
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    obs = np.asarray(tr["starts"]["obstacles"]).reshape(-1, 2)
    d = np.hypot(a[:, 10, None] - obs[:, 0], a[:, 11, None] - obs[:, 1])
    assert d.min() >= tr["starts"]["clearance"]
    m1 = random_missions(30, common.rng_of(5, 2))
    m2 = random_missions(30, common.rng_of(5, 2))
    for x, y in zip(m1, m2):
        assert np.array_equal(x, y)
    wps, fields, valid, _ = m1
    assert valid.sum(1).min() >= 9
    legs = np.linalg.norm(np.diff(wps, axis=1), axis=-1)
    assert legs.min() >= 4.0 and legs.max() <= 8.0
    r = fields[..., 2][valid]
    assert r.min() >= 0.1 and r.max() <= 0.3


def _fresh(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import port_bench.reference.qp, "
            "port_bench.reference.guidance, port_bench.vendor.work, "
            "port_bench.vendor.missions; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    tops = out.stdout
    for bad in ("mpc_collisionavoidance_tpu", "jax"):
        assert f"'{bad}'" not in tops
    assert "'mpc_collisionavoidance_tpu_torch'" not in tops


def test_run_imports_no_jax():
    code = ("import sys, port_bench.run; "
            "from port_bench.harness import forbidden_modules; "
            "print(forbidden_modules(sys.modules))")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    from port_bench.harness import forbidden_modules
    assert forbidden_modules(["mpc_collisionavoidance_tpu_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "mpc_collisionavoidance_tpu"]) \
        == ["jax.numpy", "mpc_collisionavoidance_tpu"]


def test_a_run_without_a_card_fails():
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "hull.node.b1", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_beside_only_the_benchmark_fails(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "hull.node.b1", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_limits_lie_between_their_readings():
    for name in CELLS:
        for check, v in load_json(ROOT / "limits" / f"{name}.json").items():
            lo, hi = v.get("lower"), v.get("upper")
            if lo is not None:
                assert v["limit"] > lo, (name, check)
            if hi is not None:
                assert v["limit"] < hi, (name, check)
                assert not math.isinf(hi)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_name_their_files(cell):
    w = CELLS[cell]
    assert any(c["name"] == w["config"] for c in MAN["configs"])
    assert (ROOT / "traffic" / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_configs_state_what_runs(config):
    """Each engine of a configuration builds the OCP at its stated sizes;
    the lane engine is the port's production schedule."""
    from mpc_collisionavoidance_tpu_torch.config import production_engine
    cfg = load_json(ROOT / "configs" / f"{config}.json")
    assert cfg["name"] == config
    for kind in cfg["engines"]:
        spec, engine = common.spec_and_engine(cfg, kind)
        assert engine.engine == kind
    assert common.spec_and_engine(cfg, "lane")[1] == production_engine()
    with pytest.raises(SystemExit):
        common.spec_and_engine(dict(cfg, nx=cfg["nx"] + 1), "lane")
