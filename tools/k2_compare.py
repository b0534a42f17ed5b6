"""Time K2, the fused linearization, of this checkout against other builds of
its C entries (`nmpc_linearize_<form>`), in one process on one card.

    python -m tools.k2_compare --extract COMMIT
    python -m tools.k2_compare [NAME=DIR ...] [--sweep TEAM ...]
                               [--forms FORM ...] [--json PATH]

`--extract COMMIT` (where the repository's history is, not on the card)
writes K2's sources of COMMIT (`linearize_lanes.cuh`, its units
`linearize_lanes_*.cu`, `dual.cuh` and `models/*.cuh`) into
build/k2_compare/src_COMMIT/ and exits; e.g. the design of one thread
per (stage, lane), as commit e2ac18b has it:

    python -m tools.k2_compare --extract e2ac18b
    python -m tools.k2_compare old=build/k2_compare/src_e2ac18b

A variant NAME=DIR compiles DIR's `linearize_lanes_*.cu` against DIR's
headers.  `--sweep` adds probe builds of the checkout's sources with every
instance at one team (`linearize_lanes.cuh`'s NMPC_K2_PROBE_*): TEAM is D
or `full` (D = |f_dep|, a team of one), with `s` appended for the RK4
state in shared memory (e.g. `2`, `3s`, `fulls`); each is named `dTEAM`.
Each build's units are compiled by their own nvcc processes, one per
core at a time (the flags of `kernels/_build.py`), into
build/k2_compare/NAME/; the checkout's own build is `repo`
(`kernels/_build.py`'s library, built first).

Printed per build: each K2 instance's registers and spill bytes (ptxas)
and a few SASS opcode counts (`cuobjdump -sass`: the instructions as
compiled, not as executed; MUFU, local loads and stores LDL/STL, CALL,
and the total).  Then the issue floor of back-to-back launches (the
lightest form at N = L = 1), and for every form (`--forms`: these only,
and the variants compile only their units) at its builder's N, on
`chip_smoke._linearize_inputs`, at L in {1, 128, 512} float32 and 512
float64: every build's xn, J, hbar and C held against `repo`'s (phase
3's tolerances: float32 J/C rtol 2e-4 atol 2e-5, xn/hbar rtol 2e-5 atol
2e-6; float64 atol 1e-10, the hydrodynamic J also rtol 1e-12), then all
timed in turns (the others, repo, repo, the others reversed: each
twice), CUDA events over 50 back-to-back launches of the C entry each
(`chip_smoke.launch_ms`) and over the same 50 launches replayed from one
CUDA graph (`graph_ms`: the device time, with no host issue between the
launches, of kernels shorter than the host's ~0.01 ms per call), beside
the bound (`chip_smoke.bound`, `chip_smoke.linearize_work`).  A sweep
build whose instance spills or whose launch fails is recorded and not
held.  Last, per instance, the sweep team with no spills that takes the
least device time: at L = 512 plus L = 1 in float (a batch's tick and a
single boat's, weighted alike), at L = 512 in double.  With --json the
tables go to PATH.  Needs a CUDA device (but --extract).
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import torch

import chip_smoke
from mpc_collisionavoidance_tpu_torch.kernels import _build, linearize

OUT = _build.REPO_ROOT / "build" / "k2_compare"
FORMS = [*linearize.CUDA_MODELS,
         *(f"{name}_track" for name in linearize.TRACK_FORMS)]
OPCODES = ("MUFU", "LDL", "STL", "CALL", "FFMA", "DFMA", "STG")
TOLS32 = {"xn": (2e-5, 2e-6), "J": (2e-4, 2e-5), "hbar": (2e-5, 2e-6),
          "C": (2e-4, 2e-5)}
# the variants' nvcc processes run at most one per core (a sweep starts
# ~150); the checkout's build, first, starts all of its own together
_SLOTS = threading.BoundedSemaphore(os.cpu_count() or 8)
_UNIT = re.compile(r"_\d+_linearize_lanes_(\w+?)_cu_")
_TYPE = re.compile(r"linearize_lanes_kernelI([fd])")


def extract(commit):
    """K2's sources of `commit` into build/k2_compare/src_<commit>/."""
    pkg = "mpc_collisionavoidance_tpu_torch/csrc/"
    names = subprocess.run(
        ["git", "ls-tree", "-r", "--name-only", commit, pkg], check=True,
        capture_output=True, text=True, cwd=_build.REPO_ROOT).stdout.split()
    out = OUT / f"src_{commit}"
    for name in names:
        rel = name[len(pkg):]
        if not (rel.startswith(("linearize_lanes", "models/"))
                or rel == "dual.cuh"):
            continue
        (out / rel).parent.mkdir(parents=True, exist_ok=True)
        (out / rel).write_bytes(subprocess.run(
            ["git", "show", f"{commit}:{name}"], check=True,
            capture_output=True, cwd=_build.REPO_ROOT).stdout)
    print(f"wrote {out}")


def sweep_defines(team):
    """The probe macros of a --sweep TEAM (nvcc splits a -D value at its
    commas, so the team goes as one macro per field)."""
    m = re.fullmatch(r"(\d+|full)(s?)", team)
    if m is None:
        raise SystemExit(f"k2_compare: bad --sweep team {team!r}")
    return (f"NMPC_K2_PROBE_D={99 if m[1] == 'full' else int(m[1])}",
            f"NMPC_K2_PROBE_SHARED={int(bool(m[2]))}")


def _nvcc(cmd):
    with _SLOTS:
        return subprocess.run(cmd, capture_output=True, text=True)


def build_variant(name, src_dir, defines=(), forms=FORMS):
    """Compile the K2 units of `src_dir` of `forms` (with -D `defines`)
    into build/k2_compare/<name>/ and link them; returns (library, ptxas
    log)."""
    src_dir = pathlib.Path(src_dir).resolve()
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    units = [src_dir / f"linearize_lanes_{form}.cu" for form in forms]
    objs = [out / (u.stem + ".o") for u in units]
    flags = [*_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I",
             str(src_dir)]
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        procs = list(pool.map(_nvcc, [
            [_build.find_nvcc(), *flags, "-c", "-o", str(o), str(u)]
            for u, o in zip(units, objs)]))
    for proc in procs:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               f"{proc.stderr[-4000:]}")
    lib = out / "libk2.so"
    proc = _nvcc([_build.find_nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                  str(lib), *map(str, objs)])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    for form in forms:
        entry = f"nmpc_linearize_{form}"
        getattr(dll, entry).argtypes = _build._ENTRIES[entry]
        getattr(dll, entry).restype = ctypes.c_int
    return dll, "".join(p.stdout + p.stderr for p in procs)


def _instance(fn):
    """(form, type) of a K2 kernel's mangled name, or None."""
    unit, typ = _UNIT.search(fn), _TYPE.search(fn)
    if unit is None or typ is None:
        return None
    return unit[1], "float" if typ[1] == "f" else "double"


def ptxas_table(log):
    """{(form, type): (registers, spill stores, spill loads)} of K2."""
    regs = chip_smoke.register_report(log)
    table = {}
    for fn, (stores, loads) in chip_smoke.spill_report(log).items():
        key = _instance(fn)
        if key is not None:
            table[key] = (regs.get(fn), stores, loads)
    return table


def sass_census(lib_path):
    """{(form, type): {opcode: count, "total": count}} of the K2 kernels in
    the library, from `cuobjdump -sass`."""
    dump = subprocess.run(
        [str(pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass",
         str(lib_path)], capture_output=True, text=True, check=True).stdout
    census, key = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            key = _instance(line)
            if key is not None:
                census[key] = dict.fromkeys((*OPCODES, "total"), 0)
        elif key and "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].split()
            op = words[1] if words[0].startswith("@") else words[0]
            census[key]["total"] += 1
            base = op.split(".")[0]
            if base in census[key]:
                census[key][base] += 1
    return census


def graph_ms(make_call, launches=50, reps=3):
    """Device time per call with no host issue between the launches:
    `launches` calls of the launcher `make_call()` builds, captured in one
    CUDA graph (the launcher made under capture launches on its stream),
    the median of `reps` replays after one; None if the capture fails."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            call = make_call()
            for _ in range(launches):
                call()
    except RuntimeError as e:
        print(f"graph capture failed: {e}")
        return None
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def _held(what, got, want, form, dtype):
    for out, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        if dtype == torch.float64:
            rtol = 1e-12 if (form != chip_smoke.FLAGSHIP
                             and out == "J") else 0.0
            atol = 1e-10
        else:
            rtol, atol = TOLS32[out]
        chip_smoke._check_close(f"{what} {out}", [g], [w], rtol, atol)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", metavar="NAME=DIR")
    ap.add_argument("--extract", metavar="COMMIT")
    ap.add_argument("--sweep", nargs="*", default=[], metavar="TEAM")
    ap.add_argument("--forms", nargs="*", default=None, metavar="FORM")
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    if args.extract:
        return extract(args.extract)
    if not torch.cuda.is_available():
        sys.exit("k2_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    jobs = {n: (p, ()) for n, p in (a.split("=", 1) for a in args.variants)}
    sweep = {f"d{team}": (_build.CSRC, sweep_defines(team))
             for team in args.sweep}
    jobs.update(sweep)
    libs = {"repo": _build.library()}
    logs = {"repo": (pathlib.Path(libs["repo"]._name).parent
                     / "nvcc.log").read_text()}
    forms = FORMS if args.forms is None else args.forms
    with concurrent.futures.ThreadPoolExecutor(len(jobs) or 1) as pool:
        futs = {n: pool.submit(build_variant, n, p, d, forms)
                for n, (p, d) in jobs.items()}
        for name, fut in futs.items():
            libs[name], logs[name] = fut.result()
    ptxas = {n: ptxas_table(log) for n, log in logs.items()}
    sass = {n: sass_census(lib._name) for n, lib in libs.items()}
    for name in libs:
        print(f"{name}:")
        for key in sorted(ptxas[name]):
            regs, st, ld = ptxas[name][key]
            ops = sass[name].get(key, {})
            print(f"  {key[0]} {key[1]}: {regs} registers, spill {st}/{ld} "
                  "bytes; SASS " + ", ".join(f"{op} {k}" for op, k in
                                             ops.items()))
    others = [n for n in libs if n != "repo"]
    order = [*others, "repo", "repo", *reversed(others)]
    # the issue floor of back-to-back C-entry calls: the lightest form (of
    # those compared) at one stage and one lane, a block of a few threads
    light = "usv_guidance4" if "usv_guidance4" in forms else forms[0]
    m = chip_smoke._spec(light).model
    tiny = [torch.zeros(shape, device="cuda") for shape in
            ((m.nx, 1, 1), (m.nu, 1, 1), (m.np_, 1))]
    floor = {n: chip_smoke.launch_ms(chip_smoke.linearize_launcher(
        lib, light, m, *tiny, 0.1, 1)[0]) for n, lib in libs.items()}
    print(f"launch floor ({light}, N=1, L=1): " + ", ".join(
        f"{n} {t:.4f} ms" for n, t in floor.items()))
    rows = []
    for form in forms:
        spec = chip_smoke._spec(form)
        m = spec.model
        N, steps = spec.N, spec.integrator_steps
        for L, dname in chip_smoke.K2_TIMED:
            dtype = getattr(torch, dname)
            tname = "float" if dname == "float32" else "double"
            rng = np.random.default_rng(100 + L)
            inputs = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in
                      chip_smoke._linearize_inputs(form, m, N, L, rng,
                                                   spec.dt)]
            runs, failed = {}, {}
            for n, lib in libs.items():
                try:
                    runs[n] = chip_smoke.linearize_launcher(
                        lib, form, m, *inputs, spec.dt, steps)
                    runs[n][0]()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    if n not in sweep:
                        raise
                    failed[n] = str(e)
                    runs.pop(n, None)
            want = runs["repo"][1]
            err = {n: chip_smoke._max_err(out, want)
                   for n, (_, out) in runs.items()}
            for n, (_, out) in runs.items():
                spills = ptxas[n].get((form, tname), (None, 0, 0))[1:]
                if n in sweep and spills != (0, 0):
                    continue
                _held(f"{n} {form} L={L} {dname}", out, want, form, dtype)
            ms = {n: [] for n in runs}
            graph = {n: [] for n in runs}
            for n in order:
                if n in runs:
                    ms[n].append(chip_smoke.launch_ms(runs[n][0]))
                    graph[n].append(graph_ms(
                        lambda: chip_smoke.linearize_launcher(
                            libs[n], form, m, *inputs, spec.dt, steps)[0]))
            item = inputs[0].element_size()
            bound_ms, by = chip_smoke.bound(
                *chip_smoke.linearize_work(form, m, N, L, steps, item), item)
            rows.append(dict(form=form, N=N, L=L, dtype=dname, ms=ms,
                             graph_ms=graph, failed=failed,
                             max_abs_err_vs_repo=err,
                             bound_ms=bound_ms, bound_by=by, card=card))
            print(f"K2 {form} N={N} L={L} {dname}: " + ", ".join(
                f"{n} {' / '.join(f'{t:.4f}' for t in ms[n])} ms (graph "
                f"{' / '.join(f'{t:.4f}' for t in graph[n] if t)})"
                for n in ms) + f"; bound {bound_ms:.5f} ms ({by})"
                + (f"; failed {sorted(failed)}" if failed else ""))
    best = {}
    device = {(r["form"], r["L"], r["dtype"]): {
        n: float(np.median(t)) for n, t in r["graph_ms"].items()
        if None not in t} for r in rows}
    for form in forms:
        for tname, dname in (("float", "float32"), ("double", "float64")):
            at512 = device[(form, chip_smoke.B, dname)]
            at1 = device.get((form, 1, dname), {}) if tname == "float" else {}
            score = {n: t + at1.get(n, 0.0) for n, t in at512.items()
                     if (tname == "double" or n in at1)
                     and ptxas[n].get((form, tname), (0, 1, 1))[1:] == (0, 0)}
            ok = {n: t for n, t in score.items() if n in sweep}
            if ok:
                fastest = min(ok, key=ok.get)
                best[f"{form} {tname}"] = (fastest, ok[fastest])
                print(f"best sweep team {form} {tname}: {fastest} "
                      f"{ok[fastest]:.4f} ms (repo "
                      f"{score.get('repo', float('nan')):.4f} ms)")
    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "shapes": rows, "best_sweep_team": best, "launch_floor": floor,
            "ptxas": {n: {" ".join(k): v for k, v in t.items()}
                      for n, t in ptxas.items()},
            "sass": {n: {" ".join(k): v for k, v in t.items()}
                     for n, t in sass.items()}}, indent=1))
        print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
