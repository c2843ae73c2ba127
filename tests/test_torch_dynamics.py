"""The port's bicycle steps (``substep_closed_form``, ``substep_euler``,
``step``) against the JAX package's and against the Euler oracle of
``tests/test_dynamics.py`` (the literal float64 recurrence of
``tests/oracle.py``).

Tolerances: the closed form against the Euler recurrence as the JAX tests
hold it (3e-5 m, 1e-5 rad: the closed form sums 20 iterations exactly, the
recurrence rounds each); the port against JAX with the same float32 inputs
to 2e-6 m / rad (positions up to ~12 m, where a float32 ulp is 1e-6; XLA's
and torch's sin and cos differ in the last place), the Euler recurrences to
1e-5 (20 iterations of such differences).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hope_tpu.config import VehicleConfig as JVehicleConfig
from hope_tpu.dynamics import VehicleState as JState
from hope_tpu.dynamics import step as jstep
from hope_tpu.dynamics import substep_closed_form as jclosed
from hope_tpu.dynamics import substep_euler as jeuler
from hope_tpu_torch.config import VehicleConfig
from hope_tpu_torch.dynamics import VehicleState, step, substep_closed_form, substep_euler

from . import oracle

CFG, JCFG = VehicleConfig(), JVehicleConfig()
FIELDS = ("x", "y", "heading", "speed", "steer")


def states(rng, n):
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    th = rng.uniform(-np.pi, np.pi, n)
    cols = [v.astype(np.float32) for v in (x, y, th, np.zeros(n), np.zeros(n))]
    return (VehicleState(*map(torch.as_tensor, cols)), JState(*map(jnp.asarray, cols)))


def actions(rng, n, steer=0.75, speed=2.5):
    a = np.stack([rng.uniform(-steer, steer, n), rng.uniform(-speed, speed, n)], -1)
    return a.astype(np.float32)


def close(got: VehicleState, want, atol):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=atol, rtol=0, err_msg=f)


def test_substep_closed_form_matches_jax_and_euler():
    rng = np.random.default_rng(0)
    st, jst = states(rng, 64)
    a = actions(rng, 64)
    got = substep_closed_form(st, torch.as_tensor(a), CFG)
    close(got, jclosed(jst, jnp.asarray(a), JCFG), 2e-6)
    euler = substep_euler(st, torch.as_tensor(a), CFG)
    for f, atol in (("x", 3e-5), ("y", 3e-5), ("heading", 1e-5)):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(euler, f).numpy(), atol=atol)


def test_substep_euler_matches_jax():
    rng = np.random.default_rng(1)
    st, jst = states(rng, 32)
    a = actions(rng, 32)
    close(substep_euler(st, torch.as_tensor(a), CFG), jeuler(jst, jnp.asarray(a), JCFG), 1e-5)


def test_substep_matches_scalar_oracle():
    """20 random sub-steps against the float64 reference recurrence."""
    rng = np.random.default_rng(2)
    for _ in range(20):
        x0, y0, th0 = rng.uniform(-5, 5), rng.uniform(-5, 5), rng.uniform(-3, 3)
        steer, speed = rng.uniform(-0.75, 0.75), rng.uniform(-2.5, 2.5)
        want = oracle.euler_bicycle_step(x0, y0, th0, steer, speed, CFG.wheel_base, CFG.dt,
                                         CFG.euler_iters, 1)
        st = VehicleState(*(torch.tensor(v, dtype=torch.float32) for v in (x0, y0, th0, 0, 0)))
        got = substep_closed_form(st, torch.tensor([steer, speed], dtype=torch.float32), CFG)
        np.testing.assert_allclose([float(got.x), float(got.y)], want[:2], atol=3e-5)
        np.testing.assert_allclose(float(got.heading), want[2], atol=1e-5)


@pytest.mark.parametrize("exact", [True, False])
def test_step_matches_jax(exact):
    """A full control step (10 sub-steps), fused or chained, against JAX's;
    the fused one against the chained sub-steps as the JAX tests hold it."""
    rng = np.random.default_rng(3)
    st, jst = states(rng, 16)
    a = actions(rng, 16)
    got = step(st, torch.as_tensor(a), CFG, exact=exact)
    close(got, jstep(jst, jnp.asarray(a), JCFG, exact=exact), 2e-6 if exact else 1e-5)
    chained = st
    for _ in range(CFG.n_substep):
        chained = substep_closed_form(chained, torch.as_tensor(a), CFG)
    np.testing.assert_allclose(step(st, torch.as_tensor(a), CFG).x.numpy(), chained.x.numpy(),
                               atol=1e-5)


def test_straight_line_and_clipping():
    st = VehicleState(*(torch.tensor(v) for v in (0.0, 0.0, 0.5, 0.0, 0.0)))
    got = step(st, torch.tensor([0.0, 2.0]), CFG)
    dist = 2.0 * CFG.dt * CFG.n_substep
    np.testing.assert_allclose([float(got.x), float(got.y), float(got.heading)],
                               [dist * np.cos(0.5), dist * np.sin(0.5), 0.5], rtol=1e-6)
    clipped = substep_closed_form(st, torch.tensor([5.0, 99.0]), CFG)
    assert float(clipped.steer) == CFG.max_steer and float(clipped.speed) == CFG.max_speed
