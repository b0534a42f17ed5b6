"""Fused RTI linearization in the lane layout: the RK4 rollout, its
Jacobian and the constraint linearization at every (stage, lane).

Counterpart of the lax branch of `mpc_collisionavoidance_tpu/solver/
batch.py::_build_qp` (dynamics `:243-279`, constraints `:351-373`) and of
its Pallas kernel.  `linearize_lanes_plain` is the plain PyTorch version:
one rollout under `torch.func.jvp` per column in f_dep (and per column of
h in h_dep).  Skipped columns are exact identity (states f does not read)
or exact zeros (controls f does not read, states h does not read).
`linearize_lanes` dispatches by device: CPU tensors take the plain
version, CUDA tensors the kernel `csrc/linearize_lanes.cuh`.

Layouts: in  xs (nx, N, L), ubar (nu, N, L), params (np, L);
         out xn (nx, N, L), J (N, nx, nx+nu, L), hbar (nh, N, L),
             C (N, nh, nx, L) — J and C already in the IPM's layout.
"""

import torch

from mpc_collisionavoidance_tpu_torch.kernels import linearize


def linearize_lanes_plain(xs, ubar, params, *, model, dt,
                          integrator_steps=1):
    m = model
    nx, nu, nh = m.nx, m.nu, m.nh
    N, L = xs.shape[1], xs.shape[2]
    nxu = nx + nu
    h_step = dt / integrator_steps
    opts = dict(dtype=xs.dtype, device=xs.device)

    def F(xu):
        x, u = xu[:nx], xu[nx:]
        for _ in range(integrator_steps):
            k1 = m.f(x, u, params)
            k2 = m.f(x + 0.5 * h_step * k1, u, params)
            k3 = m.f(x + 0.5 * h_step * k2, u, params)
            k4 = m.f(x + h_step * k3, u, params)
            x = x + (h_step / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    xu = torch.cat([xs, ubar], dim=0)                  # (nxu, N, L)
    f_dep = range(nxu) if m.f_dep is None else m.f_dep
    J = torch.zeros((N, nx, nxu, L), **opts)
    for k in range(nx):
        if k not in f_dep:
            J[:, k, k, :] = 1.0                        # exact e_k column
    xn = F(xu)
    for k in f_dep:
        tangent = torch.zeros_like(xu)
        tangent[k] = 1.0
        _, col = torch.func.jvp(F, (xu,), (tangent,))  # (nx, N, L)
        J[:, :, k, :] = col.transpose(0, 1)

    if nh:
        def H(xv):
            return m.h(xv, params)

        h_dep = range(nx) if m.h_dep is None else m.h_dep
        hbar = H(xs)                                   # (nh, N, L)
        C = torch.zeros((N, nh, nx, L), **opts)
        for k in h_dep:
            tangent = torch.zeros_like(xs)
            tangent[k] = 1.0
            _, col = torch.func.jvp(H, (xs,), (tangent,))  # (nh, N, L)
            C[:, :, k, :] = col.transpose(0, 1)
    else:
        hbar = torch.zeros((0, N, L), **opts)
        C = torch.zeros((N, 0, nx, L), **opts)
    return xn, J, hbar, C


def linearize_lanes(xs, ubar, params, *, model, dt, integrator_steps=1):
    """Device dispatch: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (which raises for a model with no CUDA form)."""
    if all(t.device.type == "cpu" for t in (xs, ubar, params)):
        return linearize_lanes_plain(xs, ubar, params, model=model, dt=dt,
                                     integrator_steps=integrator_steps)
    return linearize.linearize_lanes_cuda(
        xs, ubar, params, model=model, dt=dt,
        integrator_steps=integrator_steps)
