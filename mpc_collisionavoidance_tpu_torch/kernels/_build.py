"""Build and load the port's CUDA kernels; check and pass their wrappers'
arguments.

Every `csrc/*.cu` file is compiled at first use by its own `nvcc`
process, all started together, and the objects are linked into one shared
library with a plain C interface (no PyTorch headers):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu  (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o libnmpc_torch_kernels.so *.o

The library lands in `build/torch_kernels/<hash of sources>/` under the
repository root (git-ignored), next to the compiler's log (`nvcc.log`:
each file's command, wall time, and the register / spill report of every
kernel).  A build from the same sources is reused; one lock serializes
building and loading, so two threads (a server's solve thread and its
caller) never start nvcc twice.  Only sources inside
the repository are read; nvcc is found through `CUDA_HOME`,
`/usr/local/cuda/bin` or `PATH`, and a missing nvcc raises.
"""

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = CSRC.parent.parent
BUILD_ROOT = REPO_ROOT / "build" / "torch_kernels"
LIB_NAME = "libnmpc_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DBL = ctypes.c_double
_LINEARIZE_ARGS = [_INT, _INT, _INT, _DBL, _INT] + [_PTR] * 8
# a form that reads a curvature table: the table, its length M and the
# lap's arc length before the stream
_LINEARIZE_TRACK_ARGS = _LINEARIZE_ARGS[:-1] + [_PTR, _INT, _DBL, _PTR]

# C entry points: name -> argtypes.  Every launching entry returns
# cudaGetLastError() after its launch (0 = cudaSuccess) or a negative code
# for an argument it has no instance for.
_ENTRIES = {
    # (is_double, nx, nu, N, L, A, B, c, Q, S, R, qx, qu, dx0,
    #  dx, du, K, k, stream)
    "nmpc_riccati_lanes": [_INT] * 5 + [_PTR] * 14,
    # (design, is_double, nx, nu, N, L, A, ..., stream) as the above
    "nmpc_riccati_lanes_as": [_INT] * 6 + [_PTR] * 14,
    # (is_double, nx, nu, lanes out)
    "nmpc_riccati_lanes_cta_lanes": [_INT] * 3 + [ctypes.POINTER(_INT)],
    # (is_double, N, L, dt, integrator_steps, xs, ubar, params,
    #  xn, J, hbar, C, stream), one entry per model form
    **{f"nmpc_linearize_{name}": _LINEARIZE_ARGS for name in (
        "usv_guidance_ca1", "usv_pf_ca", "usv_pf", "usv_low_level",
        "usv_acados", "usv_position_control", "usv_guidance_ca",
        "usv_guidance", "usv_guidance2", "usv_guidance3", "usv_guidance4",
        "usv_guidance5", "race_cars")},
    # the same, then (table, M, track_length, stream)
    "nmpc_linearize_race_cars_track": _LINEARIZE_TRACK_ARGS,
    # (is_double, nx, nu, nbu, nbx, nHh, nS, N, L, iters, tau, sigma, mu0,
    #  idxbu, idxbx, pointer array, stream)
    "nmpc_fused_ipm_lanes": ([_INT] * 10 + [_DBL] * 3
                             + [ctypes.POINTER(_INT)] * 2
                             + [ctypes.POINTER(_PTR), _PTR]),
    # (nx, nu, nbu, nbx, nHh, nS, N) -> scratch slots per lane, or -1
    "nmpc_fused_ipm_scratch": [_INT] * 7,
    # csrc/graph.cu, the captured tick's joined graph (solver/capture.py):
    # (runtime out, driver out)
    "nmpc_cuda_versions": [ctypes.POINTER(_INT)] * 2,
    # (cudaError_t) -> its message
    "nmpc_cuda_error_string": [_INT],
    # (n, segments, conditional flags, pred, exec out, nodes out)
    "nmpc_graph_compose": [_INT, ctypes.POINTER(_PTR), ctypes.POINTER(_INT),
                           _PTR, ctypes.POINTER(_PTR),
                           ctypes.POINTER(ctypes.c_longlong)],
    # (exec, stream)
    "nmpc_graph_launch": [_PTR, _PTR],
    # (exec)
    "nmpc_graph_destroy": [_PTR],
    # csrc/stamp.cu, the tracer's device stamp (utils/profiling.py):
    # (ring, count, capacity, tag, stream)
    "nmpc_stamp": [_PTR, _PTR, ctypes.c_longlong, ctypes.c_longlong, _PTR],
}
_RESTYPES = {"nmpc_fused_ipm_scratch": ctypes.c_longlong,
             "nmpc_cuda_error_string": ctypes.c_char_p}
_LOCK = threading.RLock()


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def sources():
    """The .cu translation units and every header they may include."""
    cu = sorted(CSRC.glob("*.cu"))
    hdr = sorted(CSRC.rglob("*.cuh"))
    return cu, hdr


def source_hash() -> str:
    cu, hdr = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + hdr:
        h.update(str(path.relative_to(CSRC)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _timed_run(cmd):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc, time.perf_counter() - t0


def build() -> pathlib.Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path."""
    with _LOCK:
        return _build()


def _build() -> pathlib.Path:
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = sources()
    log = []
    # build in a temporary directory, then rename the library into place:
    # a concurrent or killed build never leaves a half-written library
    # under the final name
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs = [pathlib.Path(tmp_dir) / (p.stem + ".o") for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                 str(src)] for src, obj in zip(cu, objs)]
        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            results = list(pool.map(_timed_run, cmds))
        failed = []
        for cmd, (proc, seconds) in zip(cmds, results):
            log.append(f"{' '.join(cmd)}\n[{seconds:.1f} s, exit "
                       f"{proc.returncode}]\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(proc.stderr)
        if not failed:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                   *(str(o) for o in objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(proc.stderr)
    (out_dir / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + failed[0][-4000:])
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    with _LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check_inputs(what: str, tensors: dict, shapes: dict, dtypes) -> None:
    """Raise unless every tensor lies on the CUDA device of the first, has
    its dtype (one of `dtypes`), its expected shape and is contiguous."""
    ref_name, ref = next(iter(tensors.items()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{what}: {name} on {t.device}, expected the "
                             f"CUDA device of {ref_name} ({ref.device})")
        if t.dtype != ref.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, {ref_name} is "
                             f"{ref.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if ref.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {ref.dtype} not in {dtypes}")


def launch_args(device, *tensors):
    """ctypes pointers of `tensors`, then the current stream of `device`."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
    return (*(ctypes.c_void_p(t.data_ptr()) for t in tensors),
            ctypes.c_void_p(stream))


def check(code: int, what: str):
    """Raise if a C entry reported a launch error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed "
                           f"(code {code})")
