"""Closed-loop receding-horizon simulation engine (counterpart of
`mpc_collisionavoidance_tpu/sim/closed_loop.py`).

Reproduces the reference's offline experiment loop (reference
scripts/usv_guidance_ca1/main.py:116-186) as a loop over control ticks of
an instance-shaped solver (`RTISolver`, whose leading batch axes run a
batch of scenarios at once, or `LaneSolverAdapter`).

Plant models:
- ``"solver_prediction"`` (reference semantics): the next measured state is
  the solver's own stage-1 prediction, x0 <- solver.get(1, "x")
  (reference main.py:169-174) — the solver doubles as the simulator.
- ``"integrator"``: honest plant — integrate the model dynamics one tick
  with the applied input u0 (4 RK4 substeps), optionally with additive
  state disturbance.

Metrics mirror reference main.py:147-165: per-step heading error chie and
cross-track error ye, MAE/MSE accumulated after a 400-step transient and
normalized by 600 (main.py:202-205).
"""

from typing import NamedTuple, Optional

import torch

from mpc_collisionavoidance_tpu_torch.ops import integrators


class ClosedLoopResult(NamedTuple):
    simX: torch.Tensor      # (n_steps, ..., nx) measured state per tick
    simU: torch.Tensor      # (n_steps, ..., nu) applied input per tick
    status: torch.Tensor    # (n_steps, ...) solver status per tick
    psi_mae: torch.Tensor   # metrics (after the transient), reference names
    psi_mse: torch.Tensor
    ye_mae: torch.Tensor
    ye_mse: torch.Tensor
    final_state: NamedTuple


def run_closed_loop(solver,
                    x0,
                    params,
                    lh=None,
                    n_steps: int = 1000,
                    plant: str = "solver_prediction",
                    transient: int = 400,
                    metric_norm: float = 600.0,
                    err_idx=(3, 2),
                    disturbance: Optional[torch.Tensor] = None,
                    yref=None,
                    yref_e=None,
                    yref_fn=None) -> ClosedLoopResult:
    """Run the receding-horizon loop on the solver's device and dtype (the
    JAX function's `dtype` argument is dropped).

    `err_idx` selects (heading-error, cross-track-error) state indices for
    the metric accumulation (3 and 2 for the ca1 state layout, reference
    main.py:156-159).

    `yref_fn(x, k) -> (yref (N, ny), yref_e (nx,))` optionally recomputes
    the stage references every tick from the current measured state — the
    reference's receding progress reference (race car
    scripts/race_cars/main.py:74-83 ramps s from s0 to s0 + 3 across the
    horizon each tick).  Overrides `yref`/`yref_e`.

    `disturbance`: a constant (nx,) offset or a per-step (n_steps, nx)
    sequence added to the integrator plant's next state.
    """
    if plant not in ("solver_prediction", "integrator"):
        raise ValueError(f"unknown plant {plant!r}")
    spec = solver.spec

    def t(a):
        return torch.as_tensor(a, dtype=solver.dtype, device=solver.device)

    x = t(x0)
    params = t(params)
    state = solver.init_state(x)
    if plant == "integrator":
        plant_step = integrators.make_discrete_dynamics(
            spec.model.f, spec.dt, num_steps=4)
    if disturbance is not None:
        disturbance = t(disturbance)

    xs, us, statuses = [], [], []
    for k in range(n_steps):
        if yref_fn is not None:
            yref_k, yref_e_k = yref_fn(x, k)
        else:
            yref_k, yref_e_k = yref, yref_e
        state, out = solver.step_fn(state, x, params, lh, yref=yref_k,
                                    yref_e=yref_e_k)
        if plant == "solver_prediction":
            x_next = out.x1
        else:
            x_next = plant_step(x, out.u0, params)
            if disturbance is not None:
                d = disturbance if disturbance.ndim == 1 else disturbance[k]
                x_next = x_next + d
        xs.append(x)
        us.append(out.u0)
        statuses.append(out.status)
        x = x_next

    simX, simU, status = torch.stack(xs), torch.stack(us), torch.stack(statuses)
    mask = (torch.arange(n_steps, device=simX.device) > transient).to(
        simX.dtype).reshape((n_steps,) + (1,) * (simX.ndim - 2))
    psi_err, ye_err = simX[..., err_idx[0]], simX[..., err_idx[1]]
    return ClosedLoopResult(
        simX=simX, simU=simU, status=status,
        psi_mae=(psi_err.abs() * mask).sum(0) / metric_norm,
        psi_mse=(psi_err ** 2 * mask).sum(0) / metric_norm,
        ye_mae=(ye_err.abs() * mask).sum(0) / metric_norm,
        ye_mse=(ye_err ** 2 * mask).sum(0) / metric_norm,
        final_state=state)
