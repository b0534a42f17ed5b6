"""K2's CUDA source run on the CPU, against the plain linearization.

`csrc/linearize_lanes.cuh`, its units `csrc/linearize_lanes_<model>.cu`,
`csrc/dual.cuh` and the model forms `csrc/models/*.cuh` are compiled with
g++ (ISO C++, `-pedantic-errors`:
an array of size 0 is an error, as it is for nvcc) against the stand-in
header of tests/torch_cuda_emulation.py (a std::thread per CUDA thread).
Each model's C entry is called as `kernels/linearize.py` calls it; its
xn, J, hbar and C are held against `linearize_lanes_plain`.  This checks
the forms and the kernel's indexing where no card exists, including the
models with no parameters and no constraint rows, whose params, hbar and
C are empty (null pointers here) and must be neither read nor written:
the hull family's and the guidance family's, in both precisions; and the
race car's curved-track form, whose entry also takes the curvature table.
"""

import ctypes

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu_torch.kernels import _build, linearize
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes_plain)
from mpc_collisionavoidance_tpu_torch.utils import track as trk
from tests import torch_cuda_emulation as emulation
from tests.torch_family import (FAMILY, GUIDANCE, guidance_point,
                                random_point)
from tests.torch_race import race_point, race_spec

N, L = 5, 3
# float32: the kernel-vs-reference tolerances of tests/test_torch_cuda.py
TOLS = {torch.float32: (2e-4, 2e-5), torch.float64: (1e-12, 1e-10)}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K2's C entries, built from the checkout's sources for the CPU."""
    headers = ["dual.cuh", *(f"models/{p.name}" for p in sorted(
        (_build.CSRC / "models").glob("*.cuh")))]
    forms = [*linearize.CUDA_MODELS,
             *(f"{name}_track" for name in linearize.TRACK_FORMS)]
    return emulation.build(tmp_path_factory.mktemp("k2_emulated"),
                           ["linearize_lanes.cuh", *headers],
                           [f"linearize_lanes_{form}.cu" for form in forms],
                           [f"nmpc_linearize_{form}" for form in forms])


def _spec(name):
    """The model's OCP at its builder's step, over N stages."""
    return builders.build(name, N=N, Tf=N * builders.build(name).dt)


def _inputs(name, seed):
    m = builders.build(name).model
    if name in FAMILY:
        return random_point(name, N, L, seed, dt=_spec(name).dt)
    if name in GUIDANCE:
        return guidance_point(name, N, L, seed)
    if name == "race_cars":
        return race_point(N, L, seed)
    rng = np.random.default_rng(seed)
    if name == "usv_pf_ca":
        x, u, _ = random_point("usv_pf", N, L, seed)
        return x, u, rng.uniform(-10.0, 20.0, size=(m.np_, L))
    return (rng.normal(size=(m.nx, N, L)) * 0.5,
            rng.normal(size=(m.nu, N, L)) * 0.2,
            rng.uniform(2.0, 50.0, size=(m.np_, L)))


def _run(lib, name, xs, ubar, params, dt, steps, track=None):
    """The C entry as kernels/linearize.py calls it, on CPU tensors; with
    a `track`, the entry of the form that reads its curvature table."""
    nx, nu, _, nh, _, _ = linearize.CUDA_MODELS[name]
    opts = dict(dtype=xs.dtype)
    out = (torch.empty(nx, N, L, **opts), torch.empty(N, nx, nx + nu, L,
                                                      **opts),
           torch.empty(nh, N, L, **opts), torch.empty(N, nh, nx, L, **opts))
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (xs, ubar, params, *out)]
    entry = f"nmpc_linearize_{name}"
    if track is not None:
        table = torch.as_tensor(track.kapparef, **opts)
        ptrs += [ctypes.c_void_p(table.data_ptr()), table.numel(),
                 track.length]
        entry += "_track"
    code = getattr(lib, entry)(int(xs.dtype == torch.float64), N, L,
                               dt / steps, steps, *ptrs, None)
    assert code == 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(linearize.CUDA_MODELS))
def test_emulated_kernel_matches_plain(emulated, name, dtype):
    spec = _spec(name)
    m = spec.model
    args = [torch.as_tensor(a, dtype=dtype) for a in _inputs(name, seed=4)]
    if m.np_ == 0:
        assert args[2].shape == (0, L)
    got = _run(emulated, name, *args, spec.dt, spec.integrator_steps)
    want = linearize_lanes_plain(*args, model=m, dt=spec.dt,
                                 integrator_steps=spec.integrator_steps)
    rtol, atol = TOLS[dtype]
    for what, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        assert g.shape == w.shape, what
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_curved_form_matches_plain(emulated, dtype):
    """race_cars on the synthetic curved track: the entry that takes the
    curvature table, on states whose arc length visits negative s, the
    seam, the second lap and the table's samples (lane 0), 3 substeps."""
    spec = race_spec("race_cars", True, N=N, Tf=N * 0.02)
    m = spec.model
    args = [torch.as_tensor(a, dtype=dtype) for a in race_point(N, L, 8)]
    track = trk.make_synthetic_track()
    got = _run(emulated, "race_cars", *args, spec.dt,
               spec.integrator_steps, track=track)
    want = linearize_lanes_plain(*args, model=m, dt=spec.dt,
                                 integrator_steps=spec.integrator_steps)
    rtol, atol = TOLS[dtype]
    for what, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=what)
