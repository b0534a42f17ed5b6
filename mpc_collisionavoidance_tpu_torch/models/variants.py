"""OCP model variants in torch (counterpart of
`mpc_collisionavoidance_tpu/models/variants.py`).

Only the flagship `usv_guidance_ca1` is ported so far.  Its dynamics and
constraints are written over unpacked state components with broadcasting
only, so the same text runs on scalars or (N, L) lane tensors and under
`torch.func.jvp`.  The crab angle uses the native `torch.atan2`; the JAX
package's polynomial atan2 (`ops/kmath.py`) exists only to lower inside a
TPU kernel.  The CUDA form of the same model is
`csrc/models/usv_guidance_ca1.cuh`.
"""

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.models.base import Model


def _obstacle_distances(xp, yp, p, n_obs):
    """Euclidean distances from position (xp, yp) to `n_obs` obstacle centers.

    p holds (ox1, oy1, ox2, oy2, ...) like the acados parameter vector
    (reference scripts/usv_guidance_ca1/usv_model.py:133-140).
    """
    ds = []
    for i in range(n_obs):
        dx = xp - p[2 * i]
        dy = yp - p[2 * i + 1]
        ds.append(torch.sqrt(dx * dx + dy * dy))
    return torch.stack(ds)


def usv_guidance_ca1() -> Model:
    """FLAGSHIP: 8-state CA guidance model of the 2024 paper (reference
    scripts/usv_guidance_ca1/usv_model.py:60-199).

    x = (u, v, ye, chie, psied, xned, yned, psi); U = psied_dot in
    [-0.5, 0.5] rad/s; dynamics :117-128 with beta = atan2(v, u+0.001),
    psie = chie - beta, T1 = 1.0; 8 soft obstacle-distance constraints
    (:133-140, distance_min = 1.5 at :160, softened with lsh = -0.2 in
    acados_settings.py:154-178).
    """
    T1 = 1.0

    def f(x, u_ctl, p):
        u, v, _ye, chie, psied, _xn, _yn, psi = x
        beta = torch.atan2(v, u + 0.001)
        psie = chie - beta
        psie_rate = (psied - psie) / T1
        return torch.stack([
            torch.zeros_like(u),
            torch.zeros_like(u),
            u * torch.sin(psie) + v * torch.cos(psie),
            psie_rate,
            u_ctl[0],
            u * torch.cos(psi) - v * torch.sin(psi),
            u * torch.sin(psi) + v * torch.cos(psi),
            psie_rate,
        ])

    def h(x, p):
        return _obstacle_distances(x[5], x[6], p, 8)

    return Model(
        name="usv_guidance_ca1", nx=8, nu=1, np_=16, f=f,
        f_dep=(0, 1, 3, 4, 7, 8), h_dep=(5, 6),
        x0=np.zeros(8),
        state_names=("u", "v", "ye", "chie", "psied", "xned", "yned", "psi"),
        control_names=("Upsieddot",),
        lbu=np.array([-0.5]), ubu=np.array([0.5]), idxbu=np.array([0]),
        h=h, nh=8,
        lh=np.full(8, 1.5), uh=np.full(8, 1e6),
    )
