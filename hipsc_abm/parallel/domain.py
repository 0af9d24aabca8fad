"""Spatial domain decomposition with halo exchange (shard_map).

The ABM analog of sequence parallelism (SURVEY.md §5.7): the box is split
into x-stripes, one per device; each device owns the agents resident in its
stripe and computes contact forces locally after receiving a one-interaction-
radius **halo** of boundary agents from its left/right neighbors via
``ppermute`` (ring exchange between neighbouring devices — the same communication structure as
ring attention, applied to space instead of sequence).

This module provides the decomposed force pipeline:

- ``stripe_of`` / ``partition_by_stripe``: stripe assignment and the
  stripe-major (n_stripes, per_stripe) slot layout;
- ``domain_forces``: shard_map body that ppermutes each stripe's boundary
  band to its neighbors and reduces contact forces over (local + halo)
  agents — validated against a global all-pairs oracle in
  ``tests/test_domain.py`` on the virtual 8-device CPU mesh.

The agent-sharded GSPMD path (``parallel.mesh``) remains the default
multi-chip engine (it reuses the fused single-chip step end-to-end); this
explicit decomposition is the scaling route for pod-scale populations where
replicating the grid is no longer feasible: communication per step is
O(boundary) instead of O(C).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from hipsc_abm.models.params import BiologyParams
from hipsc_abm.ops.jkr import _pair_jkr

STRIPE_AXIS = "stripes"


def make_stripe_mesh(n_devices: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n_devices]), (STRIPE_AXIS,))


def stripe_of(x: jnp.ndarray, box_x: float, n_stripes: int) -> jnp.ndarray:
    """Stripe index per agent from its x coordinate."""
    width = box_x / n_stripes
    return jnp.clip((x / width).astype(jnp.int32), 0, n_stripes - 1)


def partition_by_stripe(
    locations: np.ndarray,
    alive: np.ndarray,
    box_x: float,
    n_stripes: int,
    per_stripe: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side layout: pack agents into (n_stripes, per_stripe) slot blocks
    by stripe (padded; global slot ids retained for validation)."""
    stripes = np.clip(
        (locations[:, 0] / (box_x / n_stripes)).astype(int), 0, n_stripes - 1
    )
    out_loc = np.zeros((n_stripes, per_stripe, 3), np.float32)
    out_alive = np.zeros((n_stripes, per_stripe), bool)
    out_gid = np.full((n_stripes, per_stripe), -1, np.int32)
    for s in range(n_stripes):
        idx = np.where(alive & (stripes == s))[0]
        if len(idx) > per_stripe:
            raise ValueError(f"stripe {s} overflow: {len(idx)} > {per_stripe}")
        out_loc[s, : len(idx)] = locations[idx]
        out_alive[s, : len(idx)] = True
        out_gid[s, : len(idx)] = idx
    return out_loc, out_alive, out_gid


def _halo_mask(x: jnp.ndarray, alive: jnp.ndarray, lo: float, hi: float, band: float):
    """Boundary bands of a stripe: agents within `band` of its lo/hi edge."""
    left = alive & (x < lo + band)
    right = alive & (x >= hi - band)
    return left, right


def domain_forces(
    locations: jnp.ndarray,  # (n_stripes, per_stripe, 3) stripe-major layout
    alive: jnp.ndarray,  # (n_stripes, per_stripe)
    radii: jnp.ndarray,  # (n_stripes, per_stripe)
    mesh: Mesh,
    box_x: float,
    bio: BiologyParams,
) -> jnp.ndarray:
    """JKR contact forces under spatial decomposition.

    Each device holds one stripe; halos (agents within the interaction radius
    of a stripe edge) travel to the adjacent device by ``ppermute`` ring
    shifts; forces are then a local masked pair reduction over
    (own + left-halo + right-halo) agents. No global state anywhere.
    """
    n_stripes = mesh.devices.size
    per_stripe = locations.shape[1]
    width = box_x / n_stripes
    reach = bio.jkr_radius + 2.0 * bio.jkr_break_band
    if width < reach:
        raise ValueError(
            f"stripe width {width:.1f} um < interaction reach {reach:.1f} um: "
            "pairs spanning a whole stripe would be missed; use fewer stripes "
            "or a larger box"
        )

    def body(loc, alv, rad):
        # loc: (1, per_stripe, 3) — this device's stripe
        loc = loc[0]
        alv = alv[0]
        rad = rad[0]
        s = jax.lax.axis_index(STRIPE_AXIS)
        lo = s.astype(jnp.float32) * width
        hi = lo + width

        left_band, right_band = _halo_mask(loc[:, 0], alv, lo, hi, reach)

        # pack outgoing halos: (per_stripe, 5) = xyz, radius, valid
        def pack(mask):
            return jnp.concatenate(
                [loc, rad[:, None], mask.astype(jnp.float32)[:, None]], axis=1
            )

        right_neighbor = [(i, (i + 1) % n_stripes) for i in range(n_stripes)]
        left_neighbor = [(i, (i - 1) % n_stripes) for i in range(n_stripes)]
        # halo from the left neighbor = its right band shifted right
        halo_from_left = jax.lax.ppermute(pack(right_band), STRIPE_AXIS, right_neighbor)
        halo_from_right = jax.lax.ppermute(pack(left_band), STRIPE_AXIS, left_neighbor)

        # first/last stripes have no wrap-around neighbors (box, not torus):
        # zero the whole pack (which clears the validity lane)
        halo_from_left = jnp.where(s > 0, 1.0, 0.0) * halo_from_left
        halo_from_right = jnp.where(s < n_stripes - 1, 1.0, 0.0) * halo_from_right

        cand = jnp.concatenate([pack(alv), halo_from_left, halo_from_right], axis=0)
        cand_loc = cand[:, :3]
        cand_rad = cand[:, 3]
        cand_valid = cand[:, 4] > 0.0

        # local pair reduction (own rows x all candidates)
        delta = loc[:, None, :] - cand_loc[None, :, :]
        dist2 = jnp.sum(delta * delta, axis=-1)
        same = (
            jnp.arange(per_stripe)[:, None] == jnp.arange(cand.shape[0])[None, :]
        )
        in_radius = dist2 <= jnp.float32(bio.jkr_radius**2)
        pair_ok = alv[:, None] & cand_valid[None, :] & ~same & in_radius

        force, _ = _pair_jkr(
            loc[:, None, :], cand_loc[None, :, :], rad[:, None], cand_rad[None, :],
            bio.adhesion_const, bio.poisson, bio.youngs, bio.jkr_break_d,
        )
        out = jnp.sum(jnp.where(pair_ok[..., None], force, 0.0), axis=1)
        return out[None]

    spec = P(STRIPE_AXIS, None, None)
    spec2 = P(STRIPE_AXIS, None)
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(spec, spec2, spec2),
        out_specs=spec,
    )(locations, alive, radii)
