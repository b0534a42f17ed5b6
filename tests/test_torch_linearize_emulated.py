"""K2's CUDA source run on the CPU, against the plain linearization.

`csrc/linearize_lanes.cuh`, its units `csrc/linearize_lanes_<model>.cu`,
`csrc/dual.cuh` and the model forms `csrc/models/*.cuh` are compiled with
g++ (ISO C++, `-pedantic-errors`:
an array of size 0 is an error, as it is for nvcc) against the stand-in
header of tests/torch_cuda_emulation.py (a std::thread per CUDA thread,
one barrier per block).
Each model's C entry is called as `kernels/linearize.py` calls it; its
xn, J, hbar and C are held against `linearize_lanes_plain`.  This checks
the forms and the kernel's indexing where no card exists, including the
models with no parameters and no constraint rows, whose params, hbar and
C are empty (null pointers here) and must be neither read nor written:
the hull family's and the guidance family's, in both precisions; and the
race car's curved-track form, whose entry also takes the curvature table.

The kernel runs a team of threads per (stage, lane), each on a chunk of
the tangents (the teams each unit chooses).  At L = 1 and 37 the teams
and lanes are ragged across blocks of 128 threads; the outputs start as
NaN, so a value that no thread of a team writes shows.  Two probe builds
give every form one other team: one tangent per thread (the largest
teams, every constant column split between threads), and four tangents
per thread with the RK4 state in shared memory (a padded last chunk
wherever |f_dep| is not a multiple of 4: 5, 6, 7 and 9 tangents).
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
FORMS = [*linearize.CUDA_MODELS,
         *(f"{name}_track" for name in linearize.TRACK_FORMS)]
# the probe builds' teams: (D, RK4 state in shared memory)
PROBES = {"one_tangent": (1, 0), "padded_shared": (4, 1)}


def _build_k2(out, defines=()):
    headers = ["dual.cuh", *(f"models/{p.name}" for p in sorted(
        (_build.CSRC / "models").glob("*.cuh")))]
    return emulation.build(out, ["linearize_lanes.cuh", *headers],
                           [f"linearize_lanes_{form}.cu" for form in FORMS],
                           [f"nmpc_linearize_{form}" for form in FORMS],
                           defines)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K2's C entries, built from the checkout's sources for the CPU."""
    return _build_k2(tmp_path_factory.mktemp("k2_emulated"))


@pytest.fixture(scope="module", params=sorted(PROBES))
def probe(request, tmp_path_factory):
    """K2's C entries with every form at the probe's team."""
    d, shared = PROBES[request.param]
    return _build_k2(tmp_path_factory.mktemp(f"k2_{request.param}"),
                     [f"NMPC_K2_PROBE_D={d}",
                      f"NMPC_K2_PROBE_SHARED={shared}"])


def _spec(name):
    """The model's OCP at its builder's step, over N stages."""
    return builders.build(name, N=N, Tf=N * builders.build(name).dt)


def _inputs(name, seed, L=L):
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


def _run(lib, name, xs, ubar, params, dt, steps, track=None, fill=None):
    """The C entry as kernels/linearize.py calls it, on CPU tensors; with
    a `track`, the entry of the form that reads its curvature table.  The
    outputs start uninitialised, or filled with `fill`."""
    nx, nu, _, nh, _, _ = linearize.CUDA_MODELS[name]
    N, L = xs.shape[1:]
    opts = dict(dtype=xs.dtype)
    shapes = ((nx, N, L), (N, nx, nx + nu, L), (nh, N, L), (N, nh, nx, L))
    out = tuple(torch.empty(s, **opts) if fill is None
                else torch.full(s, fill, **opts) for s in shapes)
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


def _check_every_value(lib, form, dtype, width, seed):
    """The form's entry at L = `width` with NaN-filled outputs: no NaN is
    left, and every value agrees with the plain version."""
    curved = form.endswith("_track")
    name = form[:-len("_track")] if curved else form
    if curved:
        spec = race_spec(name, True, N=N, Tf=N * 0.02)
        inputs = race_point(N, width, seed)
    else:
        spec = _spec(name)
        inputs = _inputs(name, seed, L=width)
    m = spec.model
    args = [torch.as_tensor(a, dtype=dtype) for a in inputs]
    got = _run(lib, name, *args, spec.dt, spec.integrator_steps,
               track=trk.make_synthetic_track() if curved else None,
               fill=float("nan"))
    want = linearize_lanes_plain(*args, model=m, dt=spec.dt,
                                 integrator_steps=spec.integrator_steps)
    rtol, atol = TOLS[dtype]
    for what, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        assert not bool(g.isnan().any()), f"{what}: values left unwritten"
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [1, 37])
@pytest.mark.parametrize("form", FORMS)
def test_emulated_kernel_writes_every_value_at_ragged_widths(
        emulated, form, width, dtype):
    """Every form at its chosen teams, at L = 1 (a warp of teams of
    several stages) and L = 37 (teams and lanes ragged across blocks)."""
    _check_every_value(emulated, form, dtype, width, seed=5 + width)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", FORMS)
def test_emulated_probe_team_writes_every_value(probe, form, dtype):
    """Every form at the probe builds' teams, at L = 37."""
    _check_every_value(probe, form, dtype, 37, seed=11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_curved_form_refuses_a_table_beyond_shared_memory(
        emulated, dtype):
    """A curvature table that does not fit a block's shared memory beside
    the RK4 columns: the entry returns -3 and launches nothing."""
    opts = dict(dtype=dtype)
    xs, ubar = torch.zeros(6, N, 1, **opts), torch.zeros(2, N, 1, **opts)
    params = torch.zeros(0, 1, **opts)
    out = (torch.empty(6, N, 1, **opts), torch.empty(N, 6, 8, 1, **opts),
           torch.empty(5, N, 1, **opts), torch.empty(N, 5, 6, 1, **opts))
    M = 232448 // xs.element_size() + 1
    table = torch.zeros(M, **opts)
    code = emulated.nmpc_linearize_race_cars_track(
        int(dtype == torch.float64), N, 1, 0.01, 1,
        *(ctypes.c_void_p(t.data_ptr()) for t in (xs, ubar, params, *out)),
        ctypes.c_void_p(table.data_ptr()), M, 10.0, None)
    assert code == -3
