"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (`mpc_collisionavoidance_tpu_torch`) through
their hand-written CUDA kernels and exits non-zero if anything fails:
the production RTI tick of the flagship OCP `usv_guidance_ca1` (nx=8,
nu=1, N=100, 8 soft obstacle rows) and of the 14-state hull `usv_pf_ca`
(nx=14, nu=2, N=100, 5 state-box rows, 4 hard obstacle rows), and the
fused tick (`riccati="fused"`) of both.  Phases:

1. environment: torch, device, `nvidia-smi` name and power limit, nvcc,
   and the kernels' build (nvcc at first use, into build/torch_kernels/);
2. K1 (Riccati sweep) vs its plain PyTorch version on the card: random
   SPD LQRs at N=100, (nx, nu) in {(8, 1), (14, 2)}, L in {1, 130, 512},
   float32 (rtol 2e-4, atol 2e-5) and float64 (atol 1e-10);
3. K2 (fused linearization) vs its plain version on the card, for both
   model forms at N=100, L in {1, 512}, float32 (xn/hbar rtol 2e-5 atol
   2e-6, J/C rtol 2e-4 atol 2e-5) and float64 (atol 1e-10; the hull's J,
   whose stiff sway-drag entries are large, also rtol 1e-12);
4. K3 (fused whole IPM, 12 iterations) vs its plain version
   `fused_ipm_lanes_plain` on the card, on QPs from the solver's own
   `_build_qp` at each OCP's default scenario (ye perturbed): the flagship
   at L in {1, 130, 512}, the hull at L in {1, 512}; float64 dx/du atol
   1e-9, gap rtol 1e-9, identical status; float32 du atol 5e-3 (the
   float32 gap-floor ball) and status-0 shares within 0.02; one NaN lane
   -> status 2 in both;
5. the flagship production tick at B=512: float64 on the card vs the plain
   path on the CPU from the same inputs (u0/x1 atol 5e-6, identical
   status), then float32 on the card, with the kernels' launch counts for
   that tick (K1 >= 4, K2 = 1, K3 = 0);
6. a 30-tick warm-started float32 closed loop at B=512 (converged_frac of
   the last tick, gap < 1e-5, must exceed 0.9) and its median tick time;
7. B=1 latency: p50/p99 over 50 ticks against the 50 ms budget at 20 Hz;
8. the 1000-tick float32 flagship mission at B=512
   (mission_converged_frac > 0.9);
9. the hull production tick: float64 card vs CPU plain at B=130 on both
   sides (the CPU tick of the 14-state hull at B=512 takes too long), then
   float32 at B=512 with launch counts (K1 >= 4, K2 = 1, K3 = 0), a 30-tick
   closed loop (converged_frac > 0.9) and B=1 p50/p99 against the 10 ms
   budget at 100 Hz (printed, not gated);
10. the fused tick of both OCPs at B=512, float32: launch counts (K3 = 1,
    K2 = 1, K1 = 0), a 30-tick closed loop (converged_frac > 0.9 on the
    flagship; the hull's printed) and B=1 p50/p99;
11. the real-time server (`rt/server.py`, float32, 128 lanes, 2 ms
    window) over a Unix socket, every reply checked (seq echoed, status 0
    or 1, finite), the launches of every served tick counted on the solve
    thread and gated:
    - the flagship at N=100, Tf=5, production schedule (bench.py:413-419):
      the first served tick against `LaneRTISolver.step_fn` on the same
      rows on the card (atol 1e-6, same status); B=1 over 200 ticks and
      an 8-vehicle fleet over 100 lockstep ticks (client-timed p50/p99,
      the server's device time and its own overhead, printed, not gated);
      every tick K1 >= 4, K2 = 1, K3 = 0;
    - the flagship with `centering="mehrotra"`: at the production
      schedule (K1 even, 8..56 per tick) and at 8 fixed iterations (K1 =
      16 per tick), 20 ticks each;
    - the flagship with `riccati="fused"`, 20 ticks: K3 = 1, K2 = 1, K1 = 0;
    - the hull (N=100, Tf=1) over v2 frames with the scenario's yref and
      `rti_split`, 50 ticks: the joining tick in full, then feedback ticks
      (K1 >= 4, K2 = 0) each followed by a preparation (K2 = 1, K1 = 0);
    - `python -m mpc_collisionavoidance_tpu_torch.rt.server --device cuda`
      (the flagship, production schedule) as its own process, driven by
      the unchanged C++ client's `rt_demo` (built with g++ into build/) for
      the reference's 1000 ticks: exit 0 and final |ye| < 0.5.

Each main path is driven with every launch count set to 0 just before and
read just after.  Times come from CUDA events (the server's from the
client's clock).  The line before the last is a JSON object with one entry
per kernel (per model form for K2, per structure for K3); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
float32 matrix products run in full float32 (TF32 off, set below).
"""

import contextlib
import dataclasses
import json
import os
import pathlib
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
DEVICE = "cuda"
B = 512
HULL_CPU_B = 130
FLAGSHIP, HULL = "usv_guidance_ca1", "usv_pf_ca"
REPO = pathlib.Path(__file__).resolve().parent
SERVER_LANES = 128                  # the server's default --max-batch


def _tick_ms(fn, reps):
    """Median CUDA-event time of `fn()` over `reps` runs, after one
    warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _check_close(what, got, want, rtol, atol):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{what}[{i}]: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}[{i}]: non-finite kernel output")
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            err = float((g - w).abs().max())
            raise AssertionError(f"{what}[{i}]: max |err| {err:.3e} over "
                                 f"rtol {rtol}, atol {atol}")


def _sync():
    import torch
    torch.cuda.synchronize()


def _reset_counts():
    from mpc_collisionavoidance_tpu_torch.kernels import (ipm, linearize,
                                                          riccati)
    _sync()
    riccati.launches = linearize.launches = ipm.launches = 0


def _read_counts():
    _sync()
    return _launch_counts()


def _launch_counts():
    """The launch counters as they stand (host-side: a wrapper counts when
    it launches, so no sync is needed)."""
    from mpc_collisionavoidance_tpu_torch.kernels import (ipm, linearize,
                                                          riccati)
    return {"riccati_lanes": riccati.launches,
            "linearize_lanes": linearize.launches,
            "fused_ipm_lanes": ipm.launches}


def environment():
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import _build
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    # registers and spills of every kernel instance (ptxas -v)
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line or "spill" in line \
                or "Used" in line:
            print("  " + line.strip())
    return card


def _random_lqr(N, nx, nu, L, seed, dtype):
    """Random SPD LQR (the pattern of tests/test_riccati_pallas.py)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import LaneLQR
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape) * 0.3

    Qr = rng.standard_normal((N + 1, nx, nx, L)) * 0.2
    Q = (np.einsum("nikl,njkl->nijl", Qr, Qr)
         + 0.5 * np.eye(nx)[None, :, :, None])
    Rr = rng.standard_normal((N, nu, nu, L)) * 0.2
    R = (np.einsum("nikl,njkl->nijl", Rr, Rr)
         + 0.5 * np.eye(nu)[None, :, :, None])
    A = (0.9 * np.eye(nx)[None, :, :, None]
         + 0.05 * rng.standard_normal((N, nx, nx, L)))
    fields = (A, arr(N, nx, nu, L), arr(N, nx, L), Q, arr(N, nu, nx, L) * 0.1,
              R, arr(N + 1, nx, L), arr(N, nu, L), arr(nx, L))
    return LaneLQR(*(torch.as_tensor(f, dtype=dtype, device=DEVICE)
                     for f in fields))


def check_riccati():
    """K1 vs lqr_solve_lanes_plain on the card; returns (max float32
    error, max float64 error, kernel ms, plain ms) at the flagship shape."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import riccati
    from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
        lqr_solve_lanes_plain)
    N = 100
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for (nx, nu) in ((8, 1), (14, 2)):
        for L in (1, 130, 512):
            for dtype, rtol, atol in ((torch.float32, 2e-4, 2e-5),
                                      (torch.float64, 0.0, 1e-10)):
                d = _random_lqr(N, nx, nu, L, seed=nx * 1000 + L,
                                dtype=dtype)
                got = riccati.lqr_solve_lanes_cuda(*d)
                want = lqr_solve_lanes_plain(d)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst[dtype] = max(worst[dtype], err)
                print(f"K1 riccati nx={nx} nu={nu} L={L} "
                      f"{str(dtype)[6:]}: max|err| {err:.3e}")
                _check_close(f"K1 ({nx},{nu}) L={L} {dtype}", got, want,
                             rtol, atol)
    d = _random_lqr(N, 8, 1, B, seed=1, dtype=torch.float32)
    ms = _tick_ms(lambda: riccati.lqr_solve_lanes_cuda(*d), 50)
    plain_ms = _tick_ms(lambda: lqr_solve_lanes_plain(d), 5)
    print(f"K1 at N=100 nx=8 nu=1 L={B} float32: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return worst[torch.float32], worst[torch.float64], ms, plain_ms


def _linearize_inputs(name, m, N, L, rng):
    """Random points of the model's state space: the flagship's as in
    tests/test_linearize_pallas.py; the hull's around its operating range
    (surge 0.2-2 m/s across the 1.25 m/s drag switch, sway within
    +-0.3 m/s, thrusts -20..30, v = 0 exactly on lane 0, the kink of
    |v|)."""
    if name == FLAGSHIP:
        return (rng.normal(size=(m.nx, N, L)) * 0.5,
                rng.normal(size=(m.nu, N, L)) * 0.2,
                rng.uniform(2.0, 50.0, size=(m.np_, L)))
    xs = rng.normal(size=(m.nx, N, L)) * 0.5
    xs[3] = rng.uniform(0.2, 2.0, size=(N, L))
    xs[4] = rng.normal(size=(N, L)) * 0.1
    xs[4, :, 0] = 0.0
    xs[12:14] = rng.uniform(-20.0, 30.0, size=(2, N, L))
    return (xs, rng.normal(size=(m.nu, N, L)) * 5.0,
            rng.uniform(-10.0, 20.0, size=(m.np_, L)))


def check_linearize():
    """K2 vs linearize_lanes_plain on the card, per model form; returns
    {model: (max float32 error, max float64 error, kernel ms, plain ms)}
    (times at N=100, L=512, float32)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import linearize
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
        linearize_lanes_plain)
    tols32 = ((2e-5, 2e-6), (2e-4, 2e-5), (2e-5, 2e-6), (2e-4, 2e-5))
    result = {}
    for name in (FLAGSHIP, HULL):
        spec = builders.build(name)
        m = spec.model
        N = spec.N
        kw = dict(model=m, dt=spec.dt, integrator_steps=spec.integrator_steps)
        worst = {torch.float32: 0.0, torch.float64: 0.0}
        for L in (1, B):
            rng = np.random.default_rng(100 + L)
            inputs = _linearize_inputs(name, m, N, L, rng)
            for dtype in (torch.float32, torch.float64):
                args = [torch.as_tensor(a, dtype=dtype, device=DEVICE)
                        for a in inputs]
                got = linearize.linearize_lanes_cuda(*args, **kw)
                want = linearize_lanes_plain(*args, **kw)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst[dtype] = max(worst[dtype], err)
                print(f"K2 linearize {name} N={N} L={L} {str(dtype)[6:]}: "
                      f"max|err| {err:.3e}")
                for out, g, w, (rtol, atol) in zip(("xn", "J", "hbar", "C"),
                                                   got, want, tols32):
                    if dtype == torch.float64:
                        rtol = 1e-12 if (name, out) == (HULL, "J") else 0.0
                        atol = 1e-10
                    _check_close(f"K2 {name} {out} L={L} {dtype}", [g], [w],
                                 rtol, atol)
                if dtype == torch.float32 and L == B:
                    ms = _tick_ms(lambda: linearize.linearize_lanes_cuda(
                        *args, **kw), 50)
                    plain_ms = _tick_ms(lambda: linearize_lanes_plain(
                        *args, **kw), 5)
        print(f"K2 {name} at N={N} L={B} float32: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        result[name] = (worst[torch.float32], worst[torch.float64], ms,
                        plain_ms)
    return result


def _setup(name, Bn, dtype, device, config, seed=SEED):
    """Solver, warm start and lane inputs of the bench's workload
    (bench.py:107-127): the OCP's default scenario with ye perturbed by
    0.1 N(0, 1)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes
    spec = builders.build(name)
    if name == FLAGSHIP:
        sc, ye = scenarios.guidance_ca1_default(), 2
    else:
        sc, ye = scenarios.pf_ca_default(), 6
    m = spec.model
    solver = config.build(spec, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (Bn, m.nx)).copy()
    x0s[:, ye] += 0.1 * rng.standard_normal(Bn)

    def lanes(a):
        return to_lanes(torch.tensor(np.asarray(a), dtype=dtype)).to(device)

    state = solver.init_state(x0s)
    return (solver, state, lanes(x0s),
            lanes(np.broadcast_to(sc.params, (Bn, m.np_))),
            lanes(np.broadcast_to(sc.lh, (Bn, m.nh))))


def _production():
    from mpc_collisionavoidance_tpu_torch.config import production_engine
    return production_engine()


def _fused():
    from mpc_collisionavoidance_tpu_torch.config import SolverConfig
    return SolverConfig(riccati="fused")


def _check_output(out, Bn, what, nx, nu):
    import torch
    if tuple(out.u0.shape) != (nu, Bn) or tuple(out.x1.shape) != (nx, Bn):
        raise AssertionError(f"{what}: output shapes {tuple(out.u0.shape)}"
                             f", {tuple(out.x1.shape)}")
    for name in ("u0", "x1", "gap"):
        if not torch.isfinite(getattr(out, name)).all():
            raise AssertionError(f"{what}: non-finite {name}")


def _dims(name):
    return (8, 1) if name == FLAGSHIP else (14, 2)


def check_fused_ipm():
    """K3 vs fused_ipm_lanes_plain on the card; returns {model: (max
    float32 du error, max float64 error, kernel ms, plain ms)} (times at
    N=100, L=512, float32, 12 iterations)."""
    import torch

    from mpc_collisionavoidance_tpu_torch.kernels import ipm
    from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
        contiguous_qp, fused_ipm_lanes_plain, lane_status)
    iters, tol = 12, 1e-7
    result = {}
    for name, widths in ((FLAGSHIP, (1, 130, B)), (HULL, (1, B))):
        worst = {torch.float32: 0.0, torch.float64: 0.0}
        for L in widths:
            for dtype in (torch.float64, torch.float32):
                solver, st, x, p, lh = _setup(name, L, dtype, DEVICE,
                                              _fused(), seed=L)
                qp = contiguous_qp(solver._build_qp(st, x, p, lh))
                args = (qp, solver.idxbu, solver.idxbx)
                got = ipm.fused_ipm_lanes_cuda(*args, iters=iters)
                want = fused_ipm_lanes_plain(*args, iters=iters)
                torch.cuda.synchronize()
                s_got, s_want = (lane_status(*o, tol) for o in (got, want))
                err = _max_err(got[:2], want[:2])
                du_err = float((got[1] - want[1]).abs().max())
                gap_rel = float(((got[2] - want[2]).abs()
                                 / want[2].abs().clamp_min(1e-300)).max())
                share = [float((s == 0).double().mean())
                         for s in (s_got, s_want)]
                print(f"K3 fused IPM {name} L={L} {str(dtype)[6:]}: "
                      f"max|err| dx/du {err:.3e}, du {du_err:.3e}, gap rel "
                      f"{gap_rel:.3e}, status-0 {share[0]:.4f} vs "
                      f"{share[1]:.4f}, status identical "
                      f"{bool(torch.equal(s_got, s_want))}")
                if not all(torch.isfinite(g).all() for g in got):
                    raise AssertionError(f"K3 {name} L={L}: non-finite")
                if dtype == torch.float64:
                    worst[dtype] = max(worst[dtype], err)
                    _check_close(f"K3 {name} dx/du L={L} float64", got[:2],
                                 want[:2], 0.0, 1e-9)
                    _check_close(f"K3 {name} gap L={L} float64", got[2:3],
                                 want[2:3], 1e-9, 0.0)
                    if not torch.equal(s_got, s_want):
                        raise AssertionError(f"K3 {name} L={L} float64: "
                                             "status differs")
                else:
                    worst[dtype] = max(worst[dtype], du_err)
                    if du_err > 5e-3 or abs(share[0] - share[1]) > 0.02:
                        raise AssertionError(
                            f"K3 {name} L={L} float32: du err {du_err:.3e} "
                            f"(limit 5e-3), status-0 shares {share}")
                if L == B and dtype == torch.float32:
                    ms = _tick_ms(lambda: ipm.fused_ipm_lanes_cuda(
                        *args, iters=iters), 20)
                    plain_ms = _tick_ms(lambda: fused_ipm_lanes_plain(
                        *args, iters=iters), 2)
                    # one NaN lane: status 2 in both, the others untouched
                    bad = qp._replace(dx0=qp.dx0.clone())
                    bad.dx0[0, 7] = float("nan")
                    sb = [lane_status(*fn(bad, solver.idxbu, solver.idxbx,
                                          iters=iters), tol)
                          for fn in (ipm.fused_ipm_lanes_cuda,
                                     fused_ipm_lanes_plain)]
                    print(f"K3 {name} NaN lane 7: status {int(sb[0][7])} "
                          f"(kernel), {int(sb[1][7])} (plain)")
                    if int(sb[0][7]) != 2 or int(sb[1][7]) != 2 or \
                            not torch.equal(torch.cat([sb[0][:7],
                                                       sb[0][8:]]),
                                            torch.cat([s_got[:7],
                                                       s_got[8:]])):
                        raise AssertionError(f"K3 {name}: NaN lane not "
                                             "status 2, or it touched others")
        print(f"K3 {name} at N=100 L={B} float32, {iters} iterations: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        result[name] = (worst[torch.float32], worst[torch.float64], ms,
                        plain_ms)
    return result


def card_vs_cpu_tick(name, Bn):
    """One float64 production tick on the card vs the plain path on the
    CPU from the same inputs."""
    import torch
    solver, st, x, p, lh = _setup(name, Bn, torch.float64, DEVICE,
                                  _production())
    st, out = solver.step_fn(st, x, p, lh)
    solver_c, st_c, x_c, p_c, lh_c = _setup(name, Bn, torch.float64, "cpu",
                                            _production())
    t0 = time.perf_counter()
    st_c, out_c = solver_c.step_fn(st_c, x_c, p_c, lh_c)
    cpu_s = time.perf_counter() - t0
    _check_output(out, Bn, f"{name} float64 card tick", *_dims(name))
    du0 = float((out.u0.cpu() - out_c.u0).abs().max())
    dx1 = float((out.x1.cpu() - out_c.x1).abs().max())
    same_status = bool((out.status.cpu() == out_c.status).all())
    print(f"{name} tick B={Bn} float64, card vs CPU plain ({cpu_s:.1f} s): "
          f"max|du0| {du0:.3e}, max|dx1| {dx1:.3e}, status identical "
          f"{same_status}, status-0 "
          f"{float((out.status == 0).double().mean()):.3f}")
    if du0 > 5e-6 or dx1 > 5e-6 or not same_status:
        raise AssertionError(f"{name}: float64 card tick disagrees with the "
                             "CPU plain tick")


def main_path_tick(name, config, expect):
    """One float32 tick at B=512 with every launch count set to 0 just
    before and read just after; `expect(counts)` gates the counts."""
    import torch
    solver, st, x, p, lh = _setup(name, B, torch.float32, DEVICE, config)
    _reset_counts()
    st, out = solver.step_fn(st, x, p, lh)        # the main path
    counts = _read_counts()
    _check_output(out, B, f"{name} float32 card tick", *_dims(name))
    print(f"{name} {solver.riccati} tick B={B} float32: launches {counts}, "
          f"max gap {float(out.gap.max()):.3e}, status-0 "
          f"{float((out.status == 0).float().mean()):.3f}")
    if not expect(counts):
        raise AssertionError(f"{name} {solver.riccati} main path launch "
                             f"counts {counts}")
    return counts


def closed_loop(name, config, gate, ticks=30):
    """Warm-started closed loop at B=512, x0 <- x1."""
    import torch
    solver, st, x, p, lh = _setup(name, B, torch.float32, DEVICE, config)
    times = []
    for _ in range(ticks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st, out = solver.step_fn(st, x, p, lh)
        end.record()
        x = out.x1
        end.synchronize()
        times.append(start.elapsed_time(end))
    _check_output(out, B, f"{name} closed loop", *_dims(name))
    frac = float((out.gap < 1e-5).float().mean())
    tick_ms = float(np.median(times[2:]))
    print(f"{name} {solver.riccati} closed loop {ticks} ticks B={B} float32: "
          f"converged_frac {frac:.4f}, median tick {tick_ms:.3f} ms "
          f"({B / tick_ms * 1e3:.1f} solves/s), first tick "
          f"{times[0]:.3f} ms")
    if gate and frac <= 0.9:
        raise AssertionError(f"{name} closed loop converged_frac {frac} "
                             "<= 0.9")
    return tick_ms, frac


def latency_b1(name, config, budget_ms, ticks=50):
    """Single-vehicle tick latency (printed against the budget, not
    gated)."""
    import torch
    solver, st, x, p, lh = _setup(name, 1, torch.float32, DEVICE, config)
    for _ in range(3):                                 # warm-up
        st, out = solver.step_fn(st, x, p, lh)
        x = out.x1
    times = []
    for _ in range(ticks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st, out = solver.step_fn(st, x, p, lh)
        end.record()
        x = out.x1
        end.synchronize()
        times.append(start.elapsed_time(end))
    _check_output(out, 1, f"{name} B=1 latency", *_dims(name))
    p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
    print(f"{name} {solver.riccati} B=1 tick float32: p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms vs the {budget_ms:.0f} ms budget: "
          f"{'within' if p99 < budget_ms else 'OVER'}")
    return float(p50), float(p99)


def mission(ticks=1000):
    """The reference's 1000-tick flagship closed loop from a cold start."""
    import torch
    solver, st, x, p, lh = _setup(FLAGSHIP, B, torch.float32, DEVICE,
                                  _production())
    fracs, worst = [], []
    t0 = time.perf_counter()
    for _ in range(ticks):
        st, out = solver.step_fn(st, x, p, lh)
        x = out.x1
        fracs.append((out.gap < 1e-5).float().mean())
        worst.append(out.gap.max())
    fr = torch.stack(fracs).cpu().numpy()
    gmax = torch.stack(worst).cpu().numpy()
    wall = time.perf_counter() - t0
    if not np.all(np.isfinite(gmax)):
        raise AssertionError("mission: non-finite gaps")
    frac = float(fr.mean())
    print(f"mission {ticks} ticks B={B} float32: mission_converged_frac "
          f"{frac:.4f}, worst gap {gmax.max():.3e} at tick "
          f"{int(np.argmax(gmax))}, {wall:.1f} s "
          f"({B * ticks / wall:.1f} solves/s)")
    if frac <= 0.9:
        raise AssertionError(f"mission_converged_frac {frac} <= 0.9")
    return frac


# ---- phase 11: the real-time server ----

@contextlib.contextmanager
def _serving(**kw):
    """The port's RTServer on a Unix socket, warmed up, its event loop on
    a background thread; stopped (solve thread included) on exit."""
    import asyncio

    from mpc_collisionavoidance_tpu_torch.rt.server import RTServer
    tmp = tempfile.mkdtemp(prefix="nmpc_rt")
    server = RTServer(os.path.join(tmp, "rt.sock"), device=DEVICE,
                      max_batch=SERVER_LANES, batch_window_ms=2.0, **kw)
    server.warmup()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(60)
        yield server
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(300)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _count_phases(server):
    """Wrap the server's device phases (`_tick`, `_feedback`, `_prepare`)
    to record the launch counts of every call, read on the solve thread
    around it; returns {phase: [counts of each call]}."""
    calls = {}
    for phase in ("tick", "feedback", "prepare"):
        def run(*args, fn=getattr(server, "_" + phase),
                log=calls.setdefault(phase, [])):
            before = _launch_counts()
            out = fn(*args)
            after = _launch_counts()
            log.append({k: after[k] - before[k] for k in after})
            return out
        setattr(server, "_" + phase, run)
    return calls


def _served(label, drive, expect, **kw):
    """Serve `kw`'s configuration, run `drive(server)` with every launch
    count set to 0 just before and read just after, and gate each device
    phase call with `expect[phase]` (a phase not in `expect` must not
    run).  Returns (the run's launch counts, what `drive` returned)."""
    with _serving(**kw) as server:
        calls = _count_phases(server)
        _reset_counts()
        result = drive(server)
        server._executor.submit(int).result()   # a preparation in flight
        counts = _read_counts()
    for phase, got in calls.items():
        want = expect.get(phase)
        if got:
            per = {k: [c[k] for c in got] for k in got[0]}
            print(f"  {label}: {len(got)} {phase} calls, launches per call "
                  + ", ".join(f"{k} {min(v)}..{max(v)} (mean "
                              f"{np.mean(v):.2f})" for k, v in per.items()))
        if (want is None) != (not got) or not all(map(want or bool, got)):
            raise AssertionError(f"{label}: {phase} launch counts per call "
                                 f"{got[:4]} (of {len(got)})")
    print(f"  {label}: launches {counts}")
    return counts, result


def _connect(path):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(120)
    s.connect(path)
    return s


def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise AssertionError("the server closed the connection")
        buf += chunk
    return buf


def _checked(resp, seq):
    """A reply echoes its seq, has status 0 (converged) or 1 (not yet), and
    finite numbers."""
    if resp.seq != seq or resp.status not in (0, 1) \
            or not np.all(np.isfinite(np.r_[resp.u0, resp.x1])):
        raise AssertionError(f"bad reply to request {seq}: {resp}")
    return resp


def _send1(s, seq, x0, p, lh):
    from mpc_collisionavoidance_tpu_torch.rt import protocol
    s.sendall(protocol.pack_request(protocol.Request(
        seq=seq, x0=tuple(x0), p_obs=p, r_obs=lh)))


def _reply1(s, seq):
    from mpc_collisionavoidance_tpu_torch.rt import protocol
    return _checked(protocol.unpack_response(_recv(s, protocol.RESP_SIZE)),
                    seq)


def _solve2(s, seq, x0, p, lh, yref, model):
    from mpc_collisionavoidance_tpu_torch.rt import protocol
    s.sendall(protocol.pack_request2(protocol.Request2(
        seq=seq, model_id=protocol.MODEL_IDS[model], x0=tuple(x0), params=p,
        lh=lh, yref=yref)))
    hdr = _recv(s, protocol.RESP2_HDR_SIZE)
    nu, nx = struct.unpack(protocol.RESP2_HDR_FMT, hdr)[3:]
    return _checked(protocol.unpack_response2(hdr, _recv(s, 4 * (nu + nx))),
                    seq)


def _client_loop(path, ticks, solve, x0):
    """`ticks` closed-loop requests on one connection (the next x0 is the
    reply's x1); returns (the replies, client-timed request->reply ms)."""
    replies, ms = [], []
    with contextlib.closing(_connect(path)) as s:
        for seq in range(ticks):
            t0 = time.perf_counter()
            replies.append(solve(s, seq, x0))
            ms.append((time.perf_counter() - t0) * 1e3)
            x0 = replies[-1].x1
    return replies, ms


def _pcts(ms):
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def _build_rt_demo():
    """The unchanged C++ client's closed-loop demo, built with g++ into
    build/rt_client/ (no cmake: the card's host may lack it)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise AssertionError("g++ not found: the C++ client phase cannot "
                             "run")
    src, out = REPO / "rt_client", REPO / "build" / "rt_client"
    out.mkdir(parents=True, exist_ok=True)
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{src}",
                    str(src / "rt_demo.cpp"), str(src / "nmpc_rt_client.cpp"),
                    "-o", str(out / "rt_demo")], check=True, timeout=300)
    return out / "rt_demo"


def _run_rt_demo(demo, path, ticks):
    """`rt_demo <socket> <ticks>`: exit 0 and final |ye| < 0.5."""
    proc = subprocess.run([str(demo), path, str(ticks)], capture_output=True,
                          text=True, timeout=900)
    last = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"  rt_demo {ticks} ticks: exit {proc.returncode}, {last[0]}")
    if proc.returncode != 0 or "final_ye" not in proc.stdout:
        raise AssertionError(f"rt_demo failed: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    final_ye = float(proc.stdout.rsplit("final_ye", 1)[1])
    if abs(final_ye) >= 0.5:
        raise AssertionError(f"rt_demo final |ye| {abs(final_ye)} >= 0.5")


def _flagship_served(card, x0, p, lh, solve1):
    """The flagship production server: the first tick, B=1 and the fleet
    of 8.  Returns the first reply."""
    def drive(server):
        first = _client_loop(server.path, 1, solve1, x0)[0][0]
        warm = 5
        n0 = len(server.solve_ms)
        _, totals = _client_loop(server.path, 200, solve1, x0)
        solves = list(server.solve_ms)[n0:]
        if len(solves) != 200:
            raise AssertionError(f"B=1: {len(solves)} ticks for 200 requests")
        over = [t - s for t, s in zip(totals[warm:], solves[warm:])]
        b1, sv, ov = _pcts(totals[warm:]), _pcts(solves[warm:]), _pcts(over)
        print(f"served flagship B=1, 200 ticks: rt_b1_p50 {b1[0]:.3f} ms, "
              f"rt_b1_p99 {b1[1]:.3f} ms, rt_b1_solve_p50 {sv[0]:.3f} ms, "
              f"rt_b1_overhead_p50 {ov[0]:.3f} ms, rt_b1_overhead_p99 "
              f"{ov[1]:.3f} ms ({card})")
        xs, fleet = [x0] * 8, []
        n0 = len(server.solve_ms)
        with contextlib.ExitStack() as stack:
            socks = [stack.enter_context(contextlib.closing(
                _connect(server.path))) for _ in range(8)]
            for seq in range(100):
                t0 = time.perf_counter()
                for s, x in zip(socks, xs):
                    _send1(s, seq, x, p, lh)
                xs = [_reply1(s, seq).x1 for s in socks]
                fleet.append((time.perf_counter() - t0) * 1e3)
        f8 = _pcts(fleet[warm:])
        print(f"served flagship fleet of 8, 100 lockstep ticks: "
              f"rt_fleet8_p50 {f8[0]:.3f} ms, rt_fleet8_p99 {f8[1]:.3f} ms, "
              f"{len(server.solve_ms) - n0} server ticks ({card})")
        return first

    return _served("flagship sweep server", drive,
                   {"tick": _production_counts}, model=FLAGSHIP, N=100,
                   Tf=5.0, **_server_engine())


def _server_engine(**flags):
    """The server's engine arguments for the given CLI flags (unset ones:
    the production schedule)."""
    from mpc_collisionavoidance_tpu_torch.rt.server import resolve_engine_args
    return resolve_engine_args(**flags)


def server_vs_solver(first, x0, p, lh):
    """The first served tick of a lane (lane 0 of a fresh server, the other
    lanes parked) against `LaneRTISolver.step_fn` on the same packed rows
    on the card."""
    import torch

    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.solver.batch import LaneRTISolver
    spec = builders.build(FLAGSHIP, Tf=5.0, N=100)
    nx, ne = spec.model.nx, len(np.asarray(spec.cost.yref_e))
    solver = LaneRTISolver(spec, **_server_engine(), device=DEVICE,
                           dtype=torch.float32)
    L = SERVER_LANES
    rows = np.concatenate([
        np.zeros((L, nx), np.float32), np.full((L, len(p)), 100.0, np.float32),
        np.zeros((L, len(lh)), np.float32),
        np.broadcast_to(np.asarray(spec.cost.yref, np.float32),
                        (L, spec.cost.ny))], axis=1)
    rows[0, :nx + len(p) + len(lh)] = np.r_[x0, p, lh]
    d = torch.from_numpy(rows).to(DEVICE)
    xL, pL = d[:, :nx].T, d[:, nx:nx + len(p)].T
    lhL, yL = d[:, nx + len(p):nx + len(p) + len(lh)].T, \
        d[:, nx + len(p) + len(lh):].T
    _, out = solver.step_fn(solver.init_state(rows[:, :nx]), xL, pL, lhL,
                            yref=yL, yref_e=yL[:ne])
    err = max(abs(first.u0 - float(out.u0[0, 0])),
              float(np.abs(np.subtract(first.x1,
                                       out.x1[:, 0].cpu().numpy())).max()))
    same = first.status == int(out.status[0])
    print(f"served flagship first tick vs step_fn on the same rows: max "
          f"|err| u0/x1 {err:.3e}, status {first.status} vs "
          f"{int(out.status[0])}")
    if err > 1e-6 or not same:
        raise AssertionError("the server's reply differs from step_fn")


def _latency_drive(label, ticks, solve, x0, card):
    def drive(server):
        _, ms = _client_loop(server.path, ticks, solve, x0)
        p50, p99 = _pcts(ms[1:])
        print(f"served {label}, {ticks} ticks: request->reply p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms ({card})")
    return drive


def serving(card):
    """Phase 11: the port's RT server on the card.  Returns {(model,
    label): launch counts} of its main-path runs."""
    from mpc_collisionavoidance_tpu_torch.config import SolverConfig
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    sc = scenarios.guidance_ca1_default()
    x0, p, lh = (tuple(float(v) for v in np.asarray(a, np.float32))
                 for a in (sc.x0, sc.params, sc.lh))
    demo = _build_rt_demo()

    def solve1(s, seq, x):
        _send1(s, seq, x, p, lh)
        return _reply1(s, seq)

    counts = {}
    counts[(FLAGSHIP, "served sweep")], first = _flagship_served(
        card, x0, p, lh, solve1)
    server_vs_solver(first, x0, p, lh)

    def k1_per_iteration(iters):
        return lambda c: (c["riccati_lanes"] == 2 * iters
                          and c["linearize_lanes"] == 1
                          and c["fused_ipm_lanes"] == 0)

    def mehrotra_production(c):
        # 4 fixed + up to 24 escalation iterations, two sweeps each
        return (c["riccati_lanes"] % 2 == 0
                and 8 <= c["riccati_lanes"] <= 56
                and c["linearize_lanes"] == 1 and c["fused_ipm_lanes"] == 0)

    for label, flags, expect in (
            ("mehrotra", dict(centering="mehrotra"), mehrotra_production),
            ("mehrotra, 8 iterations",
             dict(centering="mehrotra", ipm_iters=8, extra_iters=0),
             k1_per_iteration(8))):
        counts[(FLAGSHIP, "served " + label)], _ = _served(
            f"flagship {label} server",
            _latency_drive(f"flagship {label}", 20, solve1, x0, card),
            {"tick": expect}, model=FLAGSHIP, N=100, Tf=5.0,
            **_server_engine(**flags))
    counts[(FLAGSHIP, "served fused")], _ = _served(
        "flagship fused server",
        _latency_drive("flagship fused", 20, solve1, x0, card),
        {"tick": _fused_counts}, model=FLAGSHIP, N=100, Tf=5.0,
        **dataclasses.asdict(SolverConfig(riccati="fused")))

    hsc = scenarios.pf_ca_default()
    hx0, hp, hlh, hy = (tuple(float(v) for v in np.asarray(a, np.float32))
                        for a in (hsc.x0, hsc.params, hsc.lh, hsc.yref))

    def solve2(s, seq, x):
        return _solve2(s, seq, x, hp, hlh, hy, HULL)

    def feedback(c):
        return (c["riccati_lanes"] >= 4 and c["linearize_lanes"] == 0
                and c["fused_ipm_lanes"] == 0)

    def prepare(c):
        return (c["linearize_lanes"] == 1 and c["riccati_lanes"] == 0
                and c["fused_ipm_lanes"] == 0)

    counts[(HULL, "served rti_split")], _ = _served(
        "hull v2 rti_split server",
        _latency_drive("hull v2 rti_split", 50, solve2, hx0, card),
        {"tick": _production_counts, "feedback": feedback,
         "prepare": prepare}, model=HULL, N=100, Tf=1.0, rti_split=True,
        **_server_engine())
    c = counts[(HULL, "served rti_split")]
    # one joining tick in full, 49 feedback ticks, 50 preparations
    if c["linearize_lanes"] != 51:
        raise AssertionError(f"hull rti_split: {c} (K2 = 1 joining tick + "
                             "50 preparations expected)")
    served_cli(demo)
    return counts


def served_cli(demo):
    """`python -m mpc_collisionavoidance_tpu_torch.rt.server --device cuda`
    in its own process (the entry point a deployment starts), driven by
    the C++ client's rt_demo for the reference's 1000 ticks, then
    terminated."""
    tmp = tempfile.mkdtemp(prefix="nmpc_cli")
    path = os.path.join(tmp, "rt.sock")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpc_collisionavoidance_tpu_torch.rt.server",
         path, "--device", DEVICE], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        while not os.path.exists(path):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError("the server process did not start: "
                                     f"{proc.communicate(timeout=60)[0]}")
            time.sleep(0.1)
        print(f"served from the command line: listening after "
              f"{time.perf_counter() - t0:.1f} s")
        _run_rt_demo(demo, path, 1000)
    finally:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(60)
        shutil.rmtree(tmp, ignore_errors=True)


def _production_counts(c):
    return (c["riccati_lanes"] >= 4 and c["linearize_lanes"] == 1
            and c["fused_ipm_lanes"] == 0)


def _fused_counts(c):
    return (c["fused_ipm_lanes"] == 1 and c["linearize_lanes"] == 1
            and c["riccati_lanes"] == 0)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = environment()
    k1_err32, k1_err64, k1_ms, k1_plain = check_riccati()
    k2 = check_linearize()
    k3 = check_fused_ipm()

    # the flagship production tick
    card_vs_cpu_tick(FLAGSHIP, B)
    counts = {(FLAGSHIP, "sweep"): main_path_tick(FLAGSHIP, _production(),
                                                  _production_counts)}
    closed_loop(FLAGSHIP, _production(), gate=True)
    latency_b1(FLAGSHIP, _production(), 50.0)
    mission()
    # the hull production tick
    card_vs_cpu_tick(HULL, HULL_CPU_B)
    counts[(HULL, "sweep")] = main_path_tick(HULL, _production(),
                                             _production_counts)
    closed_loop(HULL, _production(), gate=True)
    latency_b1(HULL, _production(), 10.0)
    # the fused tick of both OCPs
    for name in (FLAGSHIP, HULL):
        counts[(name, "fused")] = main_path_tick(name, _fused(),
                                                 _fused_counts)
        closed_loop(name, _fused(), gate=name == FLAGSHIP)
        latency_b1(name, _fused(), 50.0 if name == FLAGSHIP else 10.0)
    # the real-time server
    counts.update(serving(card))

    def launched(kernel, models=(FLAGSHIP, HULL)):
        return sum(c[kernel] for (m, _), c in counts.items() if m in models)

    pkg = "mpc_collisionavoidance_tpu_torch"
    kernels = [
        {"name": "riccati_lanes", "route": "cuda",
         "source": f"{pkg}/csrc/riccati_lanes.cu",
         "replaces": "mpc_collisionavoidance_tpu/kernels/riccati_pallas.py:215",
         "launches": launched("riccati_lanes"),
         "max_abs_err": max(k1_err32, k1_err64), "ms": k1_ms,
         "plain_ms": k1_plain}]
    for name in (FLAGSHIP, HULL):
        err32, err64, ms, plain_ms = k2[name]
        kernels.append(
            {"name": f"linearize_lanes[{name}]", "route": "cuda",
             "source": f"{pkg}/csrc/linearize_lanes.cu",
             "replaces": "mpc_collisionavoidance_tpu/kernels/linearize_pallas.py:151",
             "launches": launched("linearize_lanes", (name,)),
             "max_abs_err": max(err32, err64), "ms": ms,
             "plain_ms": plain_ms})
    for name in (FLAGSHIP, HULL):
        err32, err64, ms, plain_ms = k3[name]
        kernels.append(
            {"name": f"fused_ipm_lanes[{name}]", "route": "cuda",
             "source": f"{pkg}/csrc/ipm_lanes.cu",
             "replaces": "mpc_collisionavoidance_tpu/kernels/ipm_pallas.py:53",
             "launches": launched("fused_ipm_lanes", (name,)),
             "max_abs_err": max(err32, err64), "ms": ms,
             "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
