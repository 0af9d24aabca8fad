"""Spatial domain decomposition: stripe-local forces with ppermute halo
exchange must equal a global all-pairs computation (8-device CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hipsc_abm.models.params import BiologyParams
from hipsc_abm.ops.jkr import _pair_jkr
from hipsc_abm.parallel.domain import (
    domain_forces,
    make_stripe_mesh,
    partition_by_stripe,
)

requires_multi = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device CPU mesh"
)

BIO = BiologyParams()


def global_forces(locations, alive):
    """Oracle: all-pairs JKR forces within the search radius."""
    n = locations.shape[0]
    delta = locations[:, None, :] - locations[None, :, :]
    dist2 = (delta * delta).sum(-1)
    ok = (
        alive[:, None] & alive[None, :]
        & ~np.eye(n, dtype=bool)
        & (dist2 <= BIO.jkr_radius**2)
    )
    radii = jnp.full((n,), 5.0, jnp.float32)
    force, _ = _pair_jkr(
        jnp.asarray(locations)[:, None, :], jnp.asarray(locations)[None, :, :],
        radii[:, None], radii[None, :],
        BIO.adhesion_const, BIO.poisson, BIO.youngs, BIO.jkr_break_d,
    )
    return np.asarray(jnp.sum(jnp.where(jnp.asarray(ok)[..., None], force, 0.0), axis=1))


@requires_multi
@pytest.mark.slow
def test_halo_exchange_matches_global(rng):
    n_stripes, per_stripe = 8, 64
    box_x = 400.0
    n = 300
    locations = np.zeros((n, 3), np.float32)
    locations[:, 0] = rng.random(n) * box_x
    locations[:, 1] = rng.random(n) * 100.0
    alive = np.ones(n, bool)

    sloc, salive, sgid = partition_by_stripe(locations, alive, box_x, n_stripes, per_stripe)
    mesh = make_stripe_mesh(n_stripes)
    radii = np.full((n_stripes, per_stripe), 5.0, np.float32)

    forces = np.asarray(
        domain_forces(
            jnp.asarray(sloc), jnp.asarray(salive), jnp.asarray(radii),
            mesh, box_x, BIO,
        )
    )

    want = global_forces(locations, alive)
    for s in range(n_stripes):
        for p in range(per_stripe):
            gid = sgid[s, p]
            if gid < 0:
                np.testing.assert_allclose(forces[s, p], 0.0)
            else:
                np.testing.assert_allclose(
                    forces[s, p], want[gid], rtol=1e-4, atol=1e-14,
                    err_msg=f"stripe {s} slot {p} gid {gid}",
                )


@requires_multi
def test_halo_exchange_boundary_pairs(rng):
    """A pair straddling a stripe boundary interacts only via the halo."""
    n_stripes, per_stripe = 8, 8
    box_x = 160.0  # stripes 20 um wide; contact radius 10 um crosses edges
    locations = np.array([
        [19.0, 50.0, 0.0],   # stripe 0, right edge
        [21.0, 50.0, 0.0],   # stripe 1, left edge — 2 um apart: deep contact
    ], np.float32)
    alive = np.ones(2, bool)
    sloc, salive, sgid = partition_by_stripe(locations, alive, box_x, n_stripes, per_stripe)
    mesh = make_stripe_mesh(n_stripes)
    radii = np.full((n_stripes, per_stripe), 5.0, np.float32)
    forces = np.asarray(domain_forces(
        jnp.asarray(sloc), jnp.asarray(salive), jnp.asarray(radii), mesh, box_x, BIO))
    f0 = forces[0, 0]
    f1 = forces[1, 0]
    assert f0[0] < 0 and f1[0] > 0  # deep overlap: repulsion across the boundary
    np.testing.assert_allclose(f0, -f1, rtol=1e-5)
