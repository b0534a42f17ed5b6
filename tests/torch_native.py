"""Helpers of the native nodes' tests against the port
(`test_torch_guidance_node_cpp`, `test_torch_low_level_node_cpp`): the
cmake build of `rt_client/`, the C structs of the guidance node
(`nmpc_guidance_node.h`) and the low-level node (`nmpc_low_level_node.h`)
and their ctypes bindings, and a runner of the native demos."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

needs_toolchain = pytest.mark.skipif(
    shutil.which("cmake") is None or shutil.which("g++") is None,
    reason="native toolchain unavailable (cmake and g++)")


def cmake_build(build):
    """Configure and build every target of rt_client/ into `build`."""
    subprocess.run(["cmake", "-S", str(REPO / "rt_client"), "-B",
                    str(build), "-DCMAKE_BUILD_TYPE=Release"], check=True,
                   capture_output=True, timeout=300)
    subprocess.run(["cmake", "--build", str(build), "-j4"], check=True,
                   capture_output=True, timeout=600)
    return build


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return cmake_build(tmp_path_factory.mktemp("native_build"))


# ---- the guidance node (nmpc_guidance_node.h) ----

class GnMeas(ctypes.Structure):
    _fields_ = [("u", ctypes.c_float), ("v", ctypes.c_float),
                ("nedx", ctypes.c_float), ("nedy", ctypes.c_float),
                ("psi", ctypes.c_float)]


class GnCmds(ctypes.Structure):
    _fields_ = [("psi_d", ctypes.c_float), ("r_d", ctypes.c_float),
                ("u_d", ctypes.c_float), ("ye", ctypes.c_float),
                ("target", ctypes.c_float * 2),
                ("collision", ctypes.c_int),
                ("solver_status", ctypes.c_uint32),
                ("active", ctypes.c_int)]


def guidance_node_library(build):
    L = ctypes.CDLL(str(build / "libnmpc_guidance_node.so"))
    fp = ctypes.POINTER(ctypes.c_float)
    L.gn_create.restype = ctypes.c_void_p
    L.gn_create.argtypes = [fp, ctypes.c_int, ctypes.c_float]
    L.gn_destroy.argtypes = [ctypes.c_void_p]
    L.gn_obstacles.restype = ctypes.c_int
    L.gn_obstacles.argtypes = [ctypes.c_void_p, fp, ctypes.c_int,
                               ctypes.POINTER(GnMeas)]
    L.gn_pack.restype = ctypes.c_int
    L.gn_pack.argtypes = [ctypes.c_void_p, ctypes.POINTER(GnMeas),
                          ctypes.c_float * 8, ctypes.c_float * 16,
                          ctypes.c_float * 8, ctypes.POINTER(GnCmds)]
    L.gn_extract.argtypes = [ctypes.c_void_p, ctypes.c_float * 8,
                             ctypes.c_float, ctypes.POINTER(GnCmds)]
    return L


# ---- the low-level node (nmpc_low_level_node.h) ----

class LlMeas(ctypes.Structure):
    _fields_ = [("psi", ctypes.c_float), ("u", ctypes.c_float),
                ("v", ctypes.c_float), ("r", ctypes.c_float)]


class LlCmds(ctypes.Structure):
    _fields_ = [("t_port", ctypes.c_float), ("t_stbd", ctypes.c_float),
                ("e_u", ctypes.c_float), ("e_psi", ctypes.c_float),
                ("tx", ctypes.c_float), ("tz", ctypes.c_float),
                ("solver_status", ctypes.c_uint32)]


class LlNode(ctypes.Structure):
    _fields_ = [("past_t_port", ctypes.c_float),
                ("past_t_stbd", ctypes.c_float),
                ("have_cmd", ctypes.c_int), ("last", LlCmds)]


def low_level_node_library(path):
    """Bind the low-level node's C API and the client's connect/close from
    the shared library at `path` (cmake's links the client library; a
    g++ build compiles both sources into it)."""
    L = ctypes.CDLL(str(path))
    f8 = ctypes.c_float * 8
    L.ll_init.argtypes = [ctypes.POINTER(LlNode)]
    L.ll_pack_x0.argtypes = [ctypes.POINTER(LlNode),
                             ctypes.POINTER(LlMeas), f8]
    L.ll_pack_yref.argtypes = [ctypes.c_float, ctypes.c_float,
                               ctypes.c_float * 10]
    L.ll_extract.argtypes = [ctypes.POINTER(LlNode), f8, ctypes.c_uint32,
                             ctypes.POINTER(LlMeas), ctypes.c_float,
                             ctypes.c_float, ctypes.POINTER(LlCmds)]
    L.ll_tick.restype = ctypes.c_int
    L.ll_tick.argtypes = [ctypes.POINTER(LlNode), ctypes.c_void_p,
                          ctypes.c_uint32, ctypes.POINTER(LlMeas),
                          ctypes.c_float, ctypes.c_float,
                          ctypes.POINTER(LlCmds)]
    L.nmpc_rt_connect.restype = ctypes.c_void_p
    L.nmpc_rt_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    L.nmpc_rt_close.argtypes = [ctypes.c_void_p]
    return L


def run_demo(argv, timeout):
    """Run a native demo to its end; returns (exit code, its last stdout
    line, the whole output for a failure message)."""
    out = subprocess.run([str(a) for a in argv], capture_output=True,
                         text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    return out.returncode, (lines[-1] if lines else ""), (out.stdout,
                                                          out.stderr)
