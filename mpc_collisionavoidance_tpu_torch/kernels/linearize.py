"""Wrapper of the CUDA fused linearization `csrc/linearize_lanes.cuh` (K2).

Replaces `mpc_collisionavoidance_tpu/kernels/linearize_pallas.py::
linearize_lanes_pallas`.  The kernel is model-specific: each model with a
CUDA form (`csrc/models/<name>.cuh`) has its own C entry, keyed here by
`model.name`, and the model's dimensions and f_dep/h_dep must match the
compiled form (the entry's unit is `csrc/linearize_lanes_<name>.cu`).  A
model that carries a curvature table (`models.base.TrackModel`, the race
car on a curved track) takes its name's form in `TRACK_FORMS` instead,
whose entry `nmpc_linearize_<name>_track` also receives the table; the
two forms of one name differ in f_dep.  A model with no CUDA form raises
`NotImplementedError`.
The wrapper takes CUDA tensors only; `ops.linearize_lanes.linearize_lanes`
sends CPU tensors to the plain version.  `launches` counts kernel launches.
"""

import ctypes

import torch

from mpc_collisionavoidance_tpu_torch.kernels import _build

# model name -> (nx, nu, np, nh, f_dep, h_dep) of its CUDA form, whose C
# entry is nmpc_linearize_<name>; h_dep is () for a model with no rows
CUDA_MODELS = {
    "usv_guidance_ca1": (8, 1, 16, 8, (0, 1, 3, 4, 7, 8), (5, 6)),
    "usv_pf_ca": (14, 2, 8, 4, (0, 3, 4, 5, 9, 12, 13, 14, 15), (10, 11)),
    "usv_pf": (14, 2, 0, 0, (0, 3, 4, 5, 9, 12, 13, 14, 15), ()),
    "usv_low_level": (8, 2, 0, 0, (0, 3, 4, 5, 6, 7, 8, 9), ()),
    "usv_acados": (5, 2, 0, 0, (0, 1, 2, 3, 4, 5, 6), ()),
    "usv_position_control": (8, 2, 0, 0, (2, 3, 4, 5, 6, 7, 8, 9), ()),
    "usv_guidance_ca": (9, 1, 16, 8, (0, 1, 3, 4, 7, 8, 9), (5, 6)),
    "usv_guidance": (10, 1, 0, 0, (2, 5, 6, 8, 9, 10), ()),
    "usv_guidance2": (12, 1, 0, 0, (2, 5, 6, 7, 9, 11, 12), ()),
    "usv_guidance3": (11, 1, 0, 0, (2, 5, 6, 7, 9, 10, 11), ()),
    "usv_guidance4": (4, 1, 0, 0, (0, 1, 3, 4), ()),
    "usv_guidance5": (5, 1, 0, 0, (0, 1, 3, 4, 5), ()),
    "race_cars": (6, 2, 0, 5, (2, 3, 4, 5, 6, 7), (1, 3, 4, 5)),
}
# model name -> the same, of its form that reads a curvature table, whose C
# entry is nmpc_linearize_<name>_track
TRACK_FORMS = {
    "race_cars": (6, 2, 0, 5, (0, 1, 2, 3, 4, 5, 6, 7), (1, 3, 4, 5)),
}
DTYPES = (torch.float32, torch.float64)

launches = 0


def linearize_lanes_cuda(xs, ubar, params, *, model, dt, integrator_steps=1):
    """xs (nx, N, L), ubar (nu, N, L), params (np, L) CUDA tensors ->
    (xn (nx, N, L), J (N, nx, nx+nu, L), hbar (nh, N, L),
    C (N, nh, nx, L))."""
    global launches
    curved = getattr(model, "kapparef", None) is not None
    forms = TRACK_FORMS if curved else CUDA_MODELS
    if model.name not in forms:
        raise NotImplementedError(
            f"linearize kernel: model {model.name} has no CUDA form "
            f"{'with a curvature table ' if curved else ''}(csrc/models/); "
            f"CUDA forms exist for {sorted(forms)}")
    nx, nu, np_, nh, f_dep, h_dep = forms[model.name]
    declared = (model.nx, model.nu, model.np_, model.nh,
                tuple(model.f_dep), tuple(model.h_dep or ()))
    if declared != (nx, nu, np_, nh, f_dep, h_dep):
        raise ValueError(f"linearize kernel: model {model.name} declares "
                         f"{declared}, its CUDA form is compiled for "
                         f"{(nx, nu, np_, nh, f_dep, h_dep)}")
    N, L = xs.shape[1], xs.shape[2]
    _build.check_inputs(
        "linearize kernel", dict(xs=xs, ubar=ubar, params=params),
        {"xs": (nx, N, L), "ubar": (nu, N, L), "params": (np_, L)}, DTYPES)
    if N < 1 or L < 1 or integrator_steps < 1:
        raise ValueError(f"linearize kernel: empty problem N={N}, L={L}, "
                         f"integrator_steps={integrator_steps}")

    lib = _build.library()
    opts = dict(dtype=xs.dtype, device=xs.device)
    xn = torch.empty((nx, N, L), **opts)
    J = torch.empty((N, nx, nx + nu, L), **opts)
    hbar = torch.empty((nh, N, L), **opts)
    C = torch.empty((N, nh, nx, L), **opts)
    # a model with no parameters or rows passes empty tensors (their
    # pointers may be null): its form never reads params, nor writes hbar, C
    *ptrs, stream = _build.launch_args(xs.device, xs, ubar, params, xn, J,
                                       hbar, C)
    if curved:
        table = model.kappa_table(xs.device, xs.dtype)
        entry = getattr(lib, f"nmpc_linearize_{model.name}_track")
        ptrs += [ctypes.c_void_p(table.data_ptr()), table.numel(),
                 float(model.track_length)]
    else:
        entry = getattr(lib, "nmpc_linearize_" + model.name)
    code = entry(int(xs.dtype == torch.float64), N, L, dt / integrator_steps,
                 integrator_steps, *ptrs, stream)
    _build.check(code, f"linearize_lanes[{model.name}]")
    launches += 1
    return xn, J, hbar, C
