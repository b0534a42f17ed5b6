"""Build and load the port's CUDA kernels; check and pass their wrappers'
arguments.

Every `csrc/*.cu` file is compiled at first use, in one `nvcc` call, into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o libnmpc_torch_kernels.so csrc/*.cu

The library lands in `build/torch_kernels/<hash of sources>/` under the
repository root (git-ignored), next to the compiler's log
(`nvcc.log`, with the register / spill report of every kernel).  A build
from the same sources is reused.  Only sources inside the repository are
read; nvcc is found through `CUDA_HOME`, `/usr/local/cuda/bin` or `PATH`,
and a missing nvcc raises.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = CSRC.parent.parent
BUILD_ROOT = REPO_ROOT / "build" / "torch_kernels"
LIB_NAME = "libnmpc_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int

# C entry points: (name, argtypes).  Every entry returns cudaGetLastError()
# after its launch (0 = cudaSuccess) or a negative code for an argument it
# has no instance for.
_ENTRIES = {
    # (is_double, nx, nu, N, L, A, B, c, Q, S, R, qx, qu, dx0,
    #  dx, du, K, k, stream)
    "nmpc_riccati_lanes": [_INT] * 5 + [_PTR] * 14,
    # (is_double, N, L, dt, integrator_steps, xs, ubar, params,
    #  xn, J, hbar, C, stream)
    "nmpc_linearize_usv_guidance_ca1": (
        [_INT, _INT, _INT, ctypes.c_double, _INT] + [_PTR] * 8),
}


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


def build() -> pathlib.Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = sources()
    # compile to a temporary name, then rename: a concurrent or killed
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *(str(p) for p in cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
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
