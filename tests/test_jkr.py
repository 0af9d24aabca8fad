"""JKR contact mechanics vs. an independent numpy oracle (SURVEY.md §4a),
plus bond-persistence semantics."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from hipsc_abm.models.params import BiologyParams
from hipsc_abm.ops import neighbors as nbr
from hipsc_abm.ops.jkr import BondState, jkr_substep

BIO = BiologyParams()


def oracle_pair_force(loc1, loc2, r1, r2, p=BIO):
    """Independent numpy implementation of the JKR pair law from the model
    spec: nondimensional overlap d against the cubic force polynomial, bond
    alive while d > break threshold. Locations um, force N."""
    vec = loc1 - loc2
    mag = float(np.linalg.norm(vec))
    overlap = (r1 + r2 - mag) / 1e6
    e_hat = 1.0 / (2.0 * (1.0 - p.poisson**2) / p.youngs)
    r_hat = 1.0 / (1e6 * (1.0 / r1 + 1.0 / r2))
    overlap_scale = ((math.pi * p.adhesion_const) / e_hat) ** (2 / 3) * r_hat ** (1 / 3)
    d = overlap / overlap_scale
    if d <= p.jkr_break_d:
        return np.zeros(3), False
    f = -0.0204 * d**3 + 0.4942 * d**2 + 1.0801 * d - 1.324
    magnitude = f * math.pi * p.adhesion_const * r_hat
    normal = vec / mag if mag > 0 else np.zeros(3)
    return magnitude * normal, True


import functools

import jax


@functools.lru_cache(maxsize=None)
def _jitted_substep(capacity):
    # bin size must cover the full force support: search radius + break band
    cell = BIO.jkr_radius + 2 * BIO.jkr_break_band + 0.5
    spec = nbr.GridSpec.from_box((100.0, 100.0, 0.0), cell, run_cap=capacity)

    from hipsc_abm.ops.jkr import pack_physics

    @jax.jit
    def run(locs, radii, alive, bonds):
        ids = jnp.arange(locs.shape[0], dtype=jnp.int32)  # slot == id here
        grid, pos, valid, _ = nbr.sorted_window(spec, locs, ids, alive)
        packed = pack_physics(locs, radii, ids, alive)
        return jkr_substep(
            bonds, packed, grid.order, pos, valid, BIO.jkr_radius,
            BIO.adhesion_const, BIO.poisson, BIO.youngs, BIO.jkr_break_d,
        )

    return run


def run_substep(locs, radii, alive, bonds=None, bond_cap=8):
    locs = jnp.asarray(locs, jnp.float32)
    C = locs.shape[0]
    if bonds is None:
        bonds = BondState.empty(C, bond_cap)
    forces, new_bonds, max_deg = _jitted_substep(C)(
        locs, jnp.asarray(radii, jnp.float32), jnp.asarray(alive), bonds
    )
    return np.asarray(forces), new_bonds, int(max_deg)


def test_pair_forces_match_oracle(rng):
    n = 12
    locs = np.zeros((n, 3), dtype=np.float32)
    locs[:, :2] = rng.random((n, 2)) * 25.0  # crowded 25x25 box
    radii = rng.uniform(3.6, 5.0, n).astype(np.float32)
    alive = np.ones(n, dtype=bool)

    forces, _, _ = run_substep(locs, radii, alive)

    want = np.zeros((n, 3))
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if np.linalg.norm(locs[i] - locs[j]) <= BIO.jkr_radius:
                f, _ = oracle_pair_force(locs[i], locs[j], radii[i], radii[j])
                want[i] += f
    np.testing.assert_allclose(forces, want, rtol=2e-4, atol=1e-16)


def test_forces_are_equal_and_opposite(rng):
    locs = np.array([[10.0, 10.0, 0.0], [17.0, 10.0, 0.0]], dtype=np.float32)
    radii = np.array([5.0, 5.0], dtype=np.float32)
    forces, _, _ = run_substep(locs, radii, np.ones(2, dtype=bool))
    np.testing.assert_allclose(forces[0], -forces[1], rtol=1e-6)
    assert forces[0][0] < 0  # overlapping (gap 7 < 10): repulsion pushes apart? no:
    # overlap = (10 - 7)/1e6 > 0 -> d > 0 -> f sign from polynomial


def test_adhesion_vs_repulsion_signs():
    # deep overlap -> repulsive (f > 0 pushes cells apart along loc1-loc2)
    close, _, _ = run_substep(
        np.array([[10.0, 10.0, 0.0], [12.0, 10.0, 0.0]], np.float32),
        np.array([5.0, 5.0], np.float32), np.ones(2, bool))
    assert close[0][0] < 0 and close[1][0] > 0  # cell0 pushed -x, cell1 +x

    # slight separation inside the search radius (radii 4.9 -> touching at
    # 9.8, probe at 9.9) -> adhesive pull together
    apart, _, _ = run_substep(
        np.array([[10.0, 10.0, 0.0], [19.9, 10.0, 0.0]], np.float32),
        np.array([4.9, 4.9], np.float32), np.ones(2, bool))
    assert apart[0][0] > 0 and apart[1][0] < 0


def test_bond_persists_beyond_search_radius():
    """A bond formed in contact persists when the pair drifts past the search
    radius but inside the break threshold (clear=False graph semantics)."""
    radii = np.array([5.0, 5.0], np.float32)
    alive = np.ones(2, bool)
    # contact: bond forms
    locs = np.array([[10.0, 10.0, 0.0], [19.0, 10.0, 0.0]], np.float32)
    _, bonds, _ = run_substep(locs, radii, alive)
    assert bool(bonds.mask[0].any()) and bool(bonds.mask[1].any())

    # drift to 10.2 um: outside search radius 10, inside break distance
    locs2 = np.array([[10.0, 10.0, 0.0], [20.2, 10.0, 0.0]], np.float32)
    forces_bonded, bonds2, _ = run_substep(locs2, radii, alive, bonds=bonds)
    assert bool(bonds2.mask[0].any())  # bond survived
    assert forces_bonded[0][0] > 0  # still pulling together

    # without the pre-existing bond, same configuration exerts no force
    forces_fresh, bonds3, _ = run_substep(locs2, radii, alive)
    np.testing.assert_allclose(forces_fresh, 0.0)
    assert not bool(bonds3.mask.any())


def test_bond_breaks_past_threshold():
    radii = np.array([5.0, 5.0], np.float32)
    alive = np.ones(2, bool)
    locs = np.array([[10.0, 10.0, 0.0], [19.0, 10.0, 0.0]], np.float32)
    _, bonds, _ = run_substep(locs, radii, alive)
    # far past break distance (~10.31 um for r=5)
    locs2 = np.array([[10.0, 10.0, 0.0], [21.0, 10.0, 0.0]], np.float32)
    forces, bonds2, _ = run_substep(locs2, radii, alive, bonds=bonds)
    np.testing.assert_allclose(forces, 0.0)
    assert not bool(bonds2.mask.any())


def test_no_double_count_for_bonded_contact():
    """A pair both bonded and inside the window must contribute once."""
    radii = np.array([5.0, 5.0], np.float32)
    alive = np.ones(2, bool)
    locs = np.array([[10.0, 10.0, 0.0], [17.0, 10.0, 0.0]], np.float32)
    _, bonds, _ = run_substep(locs, radii, alive)
    forces_again, bonds2, _ = run_substep(locs, radii, alive, bonds=bonds)
    want, _ = oracle_pair_force(locs[0], locs[1], 5.0, 5.0)
    np.testing.assert_allclose(forces_again[0], want, rtol=2e-4)
    assert int(bonds2.mask[0].sum()) == 1  # no duplicate bond entries


def test_degree_probe_and_dead_partner_self_clean(rng):
    n = 10
    locs = np.zeros((n, 3), dtype=np.float32)
    locs[:, :2] = 10.0 + rng.random((n, 2)) * 4.0  # everyone in contact
    radii = np.full(n, 5.0, np.float32)
    alive = np.ones(n, bool)
    _, bonds, max_deg = run_substep(locs, radii, alive, bond_cap=16)
    assert max_deg == n - 1

    # kill half; their ids vanish from every candidate window, so one more
    # substep self-cleans the bond state (dead ids are never recycled, so the
    # stale entries are inert in the interim)
    alive2 = alive.copy()
    alive2[n // 2:] = False
    forces, bonds2, _ = run_substep(locs, radii, alive2, bonds=bonds, bond_cap=16)
    partners = np.asarray(bonds2.partners)
    mask = np.asarray(bonds2.mask)
    assert not mask[n // 2:].any()
    assert (partners[mask] < n // 2).all()
    # and the dead agents exert no force on the living
    want = np.zeros((n, 3))
    for i in range(n // 2):
        for j in range(n // 2):
            if i != j and np.linalg.norm(locs[i] - locs[j]) <= BIO.jkr_radius:
                f, _ = oracle_pair_force(locs[i], locs[j], 5.0, 5.0)
                want[i] += f
    np.testing.assert_allclose(forces[: n // 2], want[: n // 2], rtol=2e-4, atol=1e-16)


@pytest.mark.parametrize("top_id", [2047, 2049, 65537, (1 << 24) - 2])
def test_bond_compaction_ids_exact(top_id):
    """First-k compaction of window candidates keeps partner ids exact at
    and past 2^11 (where a TF32 contraction would round them) up to the
    2^24 f32-lane limit, against a numpy reference."""
    from hipsc_abm.ops.jkr import window_mask_to_bonds

    rng = np.random.default_rng(top_id % 1000)
    C, W, K = 64, 24, 8
    cand = (top_id - rng.integers(0, 5000, (C, W))).astype(np.float32)
    mask = rng.random((C, W)) < 0.3
    bonds, degree = window_mask_to_bonds(jnp.asarray(cand), jnp.asarray(mask), K)
    partners, keep = np.asarray(bonds.partners), np.asarray(bonds.mask)
    for r in range(C):
        want = cand[r][mask[r]].astype(np.int64)[:K]
        np.testing.assert_array_equal(keep[r], np.arange(K) < len(want))
        np.testing.assert_array_equal(partners[r][:len(want)], want)
    assert int(degree) == int(mask.sum(1).max())
