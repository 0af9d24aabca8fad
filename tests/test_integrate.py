"""Stokes integration semantics (reference cell_backend.py:148-172)."""

import math

import jax.numpy as jnp
import numpy as np

from hipsc_abm.models import biology
from hipsc_abm.ops.integrate import stokes_integrate


def test_velocity_formula_and_units():
    # one cell, one force: new_x = x + dt * (F / (6 pi mu r_m)) * 1e6
    locs = jnp.array([[100.0, 100.0, 0.0]])
    radii = jnp.array([5.0])
    jkr = jnp.array([[2e-9, 0.0, 0.0]])
    mot = jnp.zeros((1, 3))
    size = jnp.array([1000.0, 1000.0, 0.0])
    out = stokes_integrate(locs, radii, jkr, mot, jnp.ones(1, bool), 10000.0, size, 180.0)
    friction = 6 * math.pi * 10000.0 * (5.0 / 1e6)
    want = 100.0 + 180.0 * (2e-9 / friction) * 1e6
    np.testing.assert_allclose(float(out[0, 0]), want, rtol=1e-6)
    assert float(out[0, 1]) == 100.0


def test_box_clamp_and_dead_slots():
    locs = jnp.array([[999.0, 1.0, 0.0], [50.0, 50.0, 0.0]])
    radii = jnp.array([5.0, 5.0])
    force = jnp.array([[1e-5, -1e-5, 0.0], [1e-5, 0.0, 0.0]])  # huge
    mot = jnp.zeros((2, 3))
    size = jnp.array([1000.0, 1000.0, 0.0])
    alive = jnp.array([True, False])
    out = stokes_integrate(locs, radii, force, mot, alive, 10000.0, size, 180.0)
    assert float(out[0, 0]) == 1000.0  # clamped to box
    assert float(out[0, 1]) == 0.0
    np.testing.assert_array_equal(np.asarray(out[1]), [50.0, 50.0, 0.0])  # dead: untouched


def test_zero_dt_final_substep_is_noop():
    locs = jnp.array([[10.0, 10.0, 0.0]])
    out = stokes_integrate(
        locs, jnp.array([5.0]), jnp.array([[1e-8, 0.0, 0.0]]), jnp.zeros((1, 3)),
        jnp.ones(1, bool), 10000.0, jnp.array([100.0, 100.0, 0.0]), 0.0,
    )
    np.testing.assert_array_equal(np.asarray(out), np.asarray(locs))


def test_random_vectors_unit_circle():
    import jax

    v = np.asarray(biology.random_vectors(jax.random.PRNGKey(0), 500, two_d=True))
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-5)
    assert (v[:, 2] == 0).all()
    assert abs(v[:, 0].mean()) < 0.1  # roughly isotropic

    v3 = np.asarray(biology.random_vectors(jax.random.PRNGKey(1), 500, two_d=False))
    # reference parameterization: x^2+y^2+z^2 = cos^2(phi)+sin^2(phi) = 1
    np.testing.assert_allclose(np.linalg.norm(v3, axis=1), 1.0, rtol=1e-5)


def test_normalize_rows_zero_safe():
    v = jnp.array([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0]])
    out = np.asarray(biology.normalize_rows(v))
    np.testing.assert_allclose(out[0], [0.6, 0.8, 0.0], rtol=1e-6)
    np.testing.assert_array_equal(out[1], [0.0, 0.0, 0.0])
