"""Executable acados-parity runner for every OCP variant (counterpart of
`mpc_collisionavoidance_tpu/parity/run_acados_parity.py`).

Usage (the acados run needs a machine with acados_template + casadi):

    python -m mpc_collisionavoidance_tpu_torch.parity.run_acados_parity           # all
    python -m mpc_collisionavoidance_tpu_torch.parity.run_acados_parity usv_pf_ca --ticks 200

For each variant this
1. builds the OCPSpec (`ocp/builders.py`) and the matching AcadosOcpSolver
   through `parity/acados_oracle.build_acados_solver` fed by the casadi
   transcription in `parity/casadi_models.py`,
2. runs the reference's closed-loop experiment (solver-as-plant,
   x0 <- stage-1 prediction, reference scripts/usv_guidance_ca1/
   main.py:116-186) on BOTH stacks with identical scenario inputs and RTI
   schedule (one linearize + one QP per tick, both warm-started from the
   all-x0 trajectory), the port's on `RTISolver` in float64 on `--device`
   (default `cuda`), and
3. reports the max control/state deviation over the run against the
   BASELINE.md target of <1e-3 control-trajectory deviation.

Where acados is not installed, the runner exits with a clear message and
rc=2; the transcriptions themselves are still verified without it
(tests/test_torch_casadi_models.py, and `chip_smoke.py` against the CUDA
forms of the models).

**Fixtures.** `--emit-fixtures DIR` writes each variant's acados-side
closed-loop trajectory as `DIR/<variant>.npz` (the scenario's x0, params,
lh, yref, yref_e and the per-tick acados u0 and x1 as `ua`, `xa`), in the
JAX package's format: a fixture that either package writes is read
unchanged by the other's `replay_fixture`.  `--replay file.npz` (no acados
needed) re-runs the fixture's scenario through the port's `RTISolver` on
`--device` and prints one JSON line; it exits 0 when the control deviation
is within `--target`, else 1.  `record_fixture` writes the port's own
closed loop in the same format (the format's round trip without acados).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

# the replay's solver: the converged-SQP-equivalent closed loop that
# `run_variant` compares with (30 IPM iterations to 1e-10, float64)
REPLAY_SOLVER = dict(ipm_iters=30, ipm_tol=1e-10)


# per-variant closed-loop scenario: (x0, params, lh, yref, yref_e)
def _scenario(name, spec):
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    m = spec.model
    if name == "usv_guidance_ca1":
        sc = scenarios.guidance_ca1_default()
        return sc.x0, sc.params, sc.lh, None, None
    if name == "usv_guidance_ca":
        sc = scenarios.guidance_ca_default()
        return sc.x0, sc.params, sc.lh, None, None
    if name == "usv_pf_ca":
        sc = scenarios.pf_ca_default()
        yref = np.tile(sc.yref, (spec.N, 1))
        return sc.x0, sc.params, sc.lh, yref, sc.yref_e
    if name == "usv_pf":
        sc = scenarios.pf_default()
        yref = np.tile(sc.yref, (spec.N, 1))
        return sc.x0, sc.params, sc.lh, yref, sc.yref_e
    if name == "usv_acados":
        sc = scenarios.acados_speed_default()
        yref = np.tile(sc.yref, (spec.N, 1))
        return sc.x0, sc.params, sc.lh, yref, sc.yref_e
    # generic: start at the model x0, builder default references, far
    # obstacles if the model is parametric
    params = np.full(m.np_, 100.0) if m.np_ else np.zeros(0)
    lh = np.asarray(m.lh, float) if m.nh else None
    return np.asarray(m.x0, float), params, lh, None, None


def _inputs(name, spec):
    """`_scenario` with `run_variant`'s clean-up: lh None for a model with
    no rows, far obstacles for a parametric model with no table."""
    x0, params, lh, yref, yref_e = _scenario(name, spec)
    m = spec.model
    if m.nh == 0 or (lh is not None and np.size(lh) == 0):
        lh = None
    if m.np_ and np.size(params) == 0:
        params = np.full(m.np_, 100.0)
    return x0, params, lh, yref, yref_e


def _solver(spec, device, solver_opts=None):
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
    return RTISolver(spec, **REPLAY_SOLVER, **(solver_opts or {}),
                     device=device, dtype=torch.float64)


def _host(t):
    return t.detach().cpu().numpy().astype(float).reshape(-1)


def write_fixture(path, name, ticks, x0, params, lh, yref, yref_e, ua, xa):
    """Write a closed-loop trajectory as a fixture `.npz` (the keys of the
    JAX package's `--emit-fixtures`; an absent lh, yref or yref_e is an
    empty array)."""
    np.savez_compressed(
        path, variant=name, ticks=ticks,
        x0=np.asarray(x0, float),
        params=np.asarray(params, float).reshape(-1),
        lh=(np.zeros(0) if lh is None
            else np.asarray(lh, float).reshape(-1)),
        yref=(np.zeros((0, 0)) if yref is None
              else np.asarray(yref, float)),
        yref_e=(np.zeros(0) if yref_e is None
                else np.asarray(yref_e, float)),
        ua=np.asarray(ua), xa=np.asarray(xa))


def record_fixture(path, name, ticks, *, device="cuda", solver_opts=None):
    """Run the port's own closed loop (the replay's solver, float64 on
    `device`) on `name`'s scenario for `ticks` ticks and write it as a
    fixture at `path`: a replay of it must reproduce it, and the JAX
    package's `replay_fixture` reads it unchanged."""
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    spec = builders.build(name)
    x0, params, lh, yref, yref_e = _inputs(name, spec)
    ours = _solver(spec, device, solver_opts)
    st = ours.init_state(x0)
    x = np.asarray(x0, float)
    ua, xa = [], []
    for _ in range(ticks):
        st, out = ours.step(st, x, params, lh, yref=yref, yref_e=yref_e)
        ua.append(_host(out.u0))
        xa.append(_host(out.x1))
        x = xa[-1]
    write_fixture(path, name, ticks, x0, params, lh, yref, yref_e, ua, xa)
    return path


def run_variant(name, ticks=300, rtol=1e-3, verbose=True, emit_dir=None, *,
                device="cuda"):
    """Returns a result dict; raises ImportError where acados is absent.

    `emit_dir`: also write the acados-side closed-loop trajectory as an
    importable fixture `<emit_dir>/<name>.npz` (x0/params/lh/yref inputs
    + per-tick acados u0/x1), which `replay_fixture` of either package
    diffs its solver against without acados.
    """
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.parity.acados_oracle import (
        build_acados_solver)
    from mpc_collisionavoidance_tpu_torch.parity.casadi_models import (
        make_casadi_model_fn)

    spec = builders.build(name)
    x0, params, lh, yref, yref_e = _inputs(name, spec)
    N, m = spec.N, spec.model

    aca = build_acados_solver(spec, make_casadi_model_fn(name),
                              json_file=f"acados_ocp_{name}.json")

    ours = _solver(spec, device)
    st = ours.init_state(x0)

    # identical warm start on the acados side (all stages at x0)
    for j in range(N + 1):
        aca.set(j, "x", np.asarray(x0, float))

    yref_stage = (np.asarray(spec.cost.yref, float)
                  if yref is None else None)
    yref_term = (np.asarray(spec.cost.yref_e, float)
                 if yref_e is None else np.asarray(yref_e, float))

    dev_u, dev_x = 0.0, 0.0
    ua_trace, xa_trace = [], []
    xa = np.asarray(x0, float)
    xj = np.asarray(x0, float)
    for i in range(ticks):
        # ---- acados tick ----
        aca.set(0, "lbx", xa)
        aca.set(0, "ubx", xa)
        for j in range(N):
            aca.set(j, "yref",
                    yref_stage if yref is None else np.asarray(yref[j]))
            if m.np_:
                aca.set(j, "p", np.asarray(params, float))
            if lh is not None:
                aca.constraints_set(j, "lh", np.asarray(lh, float))
        aca.set(N, "yref", yref_term)
        if m.np_:
            aca.set(N, "p", np.asarray(params, float))
        status = aca.solve()
        if status != 0 and verbose:
            print(f"  [acados] status {status} at tick {i}", file=sys.stderr)
        ua = aca.get(0, "u")
        xa_next = aca.get(1, "x")
        ua_trace.append(np.asarray(ua, float).reshape(-1))
        xa_trace.append(np.asarray(xa_next, float).reshape(-1))

        # ---- our tick ----
        st, out = ours.step(st, xj, params, lh, yref=yref, yref_e=yref_e)
        uj = _host(out.u0)
        xj_next = _host(out.x1)

        dev_u = max(dev_u, float(np.max(np.abs(ua - uj))))
        dev_x = max(dev_x, float(np.max(np.abs(xa_next - xj_next))))

        xa, xj = xa_next, xj_next

    ok = dev_u < rtol
    if emit_dir is not None:
        os.makedirs(emit_dir, exist_ok=True)
        path = os.path.join(emit_dir, f"{name}.npz")
        write_fixture(path, name, ticks, x0, params, lh, yref, yref_e,
                      ua_trace, xa_trace)
        if verbose:
            print(f"  fixture -> {path}", file=sys.stderr)
    return {"variant": name, "ticks": ticks, "max_u_dev": dev_u,
            "max_x_dev": dev_x, "target": rtol, "ok": bool(ok)}


def replay_fixture(path, rtol=1e-3, ticks=None, solver_opts=None, *,
                   device="cuda"):
    """Diff the port's solver against a fixture; no acados needed.

    Loads `<name>.npz` written by `--emit-fixtures` (of either package) or
    `record_fixture`, re-runs the converged-SQP-equivalent closed loop
    (RTISolver ipm_iters=30, tol=1e-10, float64, on `device`: captured on
    a CUDA device, the main path; a CUDA device on a host without one
    raises ValueError) on the recorded scenario inputs, and returns the
    result dict with max |u| / |x1| deviation against the recorded
    trajectories.  Both stacks run solver-as-plant independently, so the
    deviation is the honest closed-loop divergence, the BASELINE.md <1e-3
    criterion."""
    from mpc_collisionavoidance_tpu_torch.ocp import builders

    with np.load(path, allow_pickle=False) as z:
        name = str(z["variant"])
        n_ticks = int(z["ticks"]) if ticks is None else min(
            int(z["ticks"]), ticks)
        x0 = z["x0"]
        params = z["params"]
        lh = z["lh"] if z["lh"].size else None
        yref = z["yref"] if z["yref"].size else None
        yref_e = z["yref_e"] if z["yref_e"].size else None
        ua, xa = z["ua"], z["xa"]

    spec = builders.build(name)
    ours = _solver(spec, device, solver_opts)
    st = ours.init_state(x0)
    xj = np.asarray(x0, float)
    dev_u, dev_x = 0.0, 0.0
    for i in range(n_ticks):
        st, out = ours.step(st, xj, params, lh, yref=yref, yref_e=yref_e)
        uj = _host(out.u0)
        xj_next = _host(out.x1)
        dev_u = max(dev_u, float(np.max(np.abs(ua[i] - uj))))
        dev_x = max(dev_x, float(np.max(np.abs(xa[i] - xj_next))))
        xj = xj_next
    return {"variant": name, "ticks": n_ticks, "max_u_dev": dev_u,
            "max_x_dev": dev_x, "target": rtol, "ok": bool(dev_u < rtol)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("variant", nargs="?", default="all")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--target", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="the device of the port's solver (default cuda; "
                         "cpu runs the plain versions of the kernels)")
    ap.add_argument("--emit-fixtures", metavar="DIR", default=None,
                    help="also write each variant's acados trajectory as "
                         "an importable fixture DIR/<variant>.npz, which "
                         "--replay diffs the solver against without "
                         "acados")
    ap.add_argument("--replay", metavar="NPZ", default=None,
                    help="no acados needed: diff the solver against a "
                         "previously emitted fixture")
    args = ap.parse_args(argv)

    if args.replay:
        res = replay_fixture(args.replay, rtol=args.target,
                             ticks=args.ticks, device=args.device)
        print(json.dumps(res))
        return 0 if res["ok"] else 1

    from mpc_collisionavoidance_tpu_torch.parity.acados_oracle import (
        acados_available)
    from mpc_collisionavoidance_tpu_torch.parity.casadi_models import VARIANTS

    names = [v for v in VARIANTS if v != "race_cars_dev"] \
        if args.variant == "all" else [args.variant]
    if not acados_available():
        print("acados_template/casadi not installed in this image; the "
              "casadi transcriptions are cross-checked by "
              "tests/test_casadi_models.py and behavior is pinned by "
              "tests/test_golden.py. Run this script on an acados machine "
              "for the direct <1e-3 comparison.", file=sys.stderr)
        return 2

    rc = 0
    for name in names:
        res = run_variant(name, ticks=args.ticks, rtol=args.target,
                          emit_dir=args.emit_fixtures, device=args.device)
        print(json.dumps(res))
        if not res["ok"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
