"""The committed golden closed loops (`tests/goldens/*.npz`, made by the
JAX package's per-instance engine) recomputed by the port's
`parity/goldens.py` on the CPU in float64, at atol 1e-6 (the JAX suite's
tests/test_golden.py).

Tier-1: the flagship's RTI-schedule fixture over its first 30 ticks and
its converged-SQP fixture over its first 3 (10 SQP iterations of 30 IPM
iterations per tick: 30 ticks take minutes on the CPU; the card runs the
30-tick prefixes, `chip_smoke.py` phase 16).  `slow`: every fixture of
both families over 150 ticks, as tests/test_golden.py does."""

import os

import numpy as np
import pytest

from mpc_collisionavoidance_tpu_torch.parity import goldens

PREFIX = 150        # the slow tier's prefix (tests/test_golden.py)
RTI_FAST = 30       # tier-1 prefixes of the flagship's fixtures
SQP_FAST = 3


def _check(got, ref, ticks, name):
    assert got.simX.shape == (ticks, ref.simX.shape[1])
    np.testing.assert_allclose(got.simU, ref.simU[:ticks], atol=1e-6,
                               rtol=0, err_msg=name)
    np.testing.assert_allclose(got.simX, ref.simX[:ticks], atol=1e-6,
                               rtol=0, err_msg=name)


def test_fixtures_are_the_jax_packages():
    """The port reads the JAX package's committed fixtures, with the same
    runs, schedules and options."""
    from mpc_collisionavoidance_tpu.parity import goldens as jgoldens
    assert goldens.GOLDEN_RUNS == jgoldens.GOLDEN_RUNS
    assert goldens.RTI_GOLDEN_RUNS == jgoldens.RTI_GOLDEN_RUNS
    assert goldens.SOLVER_OPTS == jgoldens.SOLVER_OPTS
    for name in goldens.GOLDEN_RUNS:
        for schedule in ("sqp", "rti"):
            path = goldens.golden_path(name, schedule)
            assert path == jgoldens.golden_path(name, schedule)
            assert os.path.exists(path), path


def test_scenario_inputs_match_jax():
    """Both families' inputs (x0, params, lh, yref, yref_e) per variant,
    and the race car's receding reference."""
    import jax.numpy as jnp
    import torch

    from mpc_collisionavoidance_tpu.parity import goldens as jgoldens
    for name in goldens.GOLDEN_RUNS:
        spec = goldens._build_spec(name)
        jspec = jgoldens._build_spec(name)
        got = goldens._scenario_inputs(name, spec, spec.model)
        want = jgoldens._scenario_inputs(name, jspec, jspec.model)
        for g, w in zip(got, want):
            assert (g is None) == (w is None), name
            if g is not None:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                              err_msg=name)
    spec, jspec = (goldens._build_spec("race_cars"),
                   jgoldens._build_spec("race_cars"))
    x = np.array([2.3, 0.1, 0.0, 0.5, 0.0, 0.0])
    got = goldens._race_yref_fn(spec)(torch.tensor(x))
    want = jgoldens._race_yref_fn(jspec)(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_golden_prefix_fast_flagship():
    """The flagship's RTI fixture over 30 ticks and its converged-SQP
    fixture over 3, on the CPU."""
    name = "usv_guidance_ca1"
    _check(goldens.compute_golden_rti(
        name, RTI_FAST, goldens.RTI_GOLDEN_RUNS[name][1], device="cpu"),
        goldens.load_golden(name, "rti"), RTI_FAST, name)
    _check(goldens.compute_golden(
        name, SQP_FAST, goldens.GOLDEN_RUNS[name][2], device="cpu"),
        goldens.load_golden(name), SQP_FAST, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(goldens.GOLDEN_RUNS))
def test_golden_prefix_regression(name):
    got = goldens.compute_golden(name, PREFIX, goldens.GOLDEN_RUNS[name][2],
                                 device="cpu")
    _check(got, goldens.load_golden(name), PREFIX, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(goldens.RTI_GOLDEN_RUNS))
def test_rti_golden_prefix_regression(name):
    got = goldens.compute_golden_rti(name, PREFIX,
                                     goldens.RTI_GOLDEN_RUNS[name][1],
                                     device="cpu")
    _check(got, goldens.load_golden(name, "rti"), PREFIX, name)
