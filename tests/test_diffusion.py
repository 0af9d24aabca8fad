"""FTCS diffusion vs an independent numpy oracle; sample/deposit coupling."""

import jax
import jax.numpy as jnp
import numpy as np

from hipsc_abm.ops import diffusion as dops


def numpy_ftcs(grid, dts, D, h2, cmax, degradation):
    """Independent oracle: clamp, ghost pad, per-subcycle sequential edge
    reflection then 5-point FTCS, final degradation."""
    g = np.clip(np.asarray(grid, dtype=np.float64), 0.0, cmax)
    base = np.pad(g, 1)
    for dt in dts:
        a = dt * D / h2
        b = 1 - 4 * a
        base[:, 0] = base[:, 1]
        base[:, -1] = base[:, -2]
        base[0, :] = base[1, :]
        base[-1, :] = base[-2, :]
        interior = base[1:-1, 1:-1].copy()
        lap = base[2:, 1:-1] + base[:-2, 1:-1] + base[1:-1, 2:] + base[1:-1, :-2]
        base[1:-1, 1:-1] = b * interior + a * lap
    return base[1:-1, 1:-1] * (1 - degradation)


def test_ftcs_matches_oracle(rng):
    grid = rng.random((20, 17)).astype(np.float32) * 3.0  # some above cmax
    dts = dops.diffusion_dts(1800.0, 6.0)
    got = np.asarray(jax.jit(
        lambda g: dops.ftcs_diffuse(g, jnp.asarray(dts), 2.0, 100.0, 2.0, 0.1)
    )(jnp.asarray(grid)))
    want = numpy_ftcs(grid, dts, 2.0, 100.0, 2.0, 0.1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_subcycle_schedule():
    dts = dops.diffusion_dts(1800.0, 7.0)
    # divmod(1800, 7) = (257, 1) -> 257 full + 1 remainder step
    assert len(dts) == 258
    np.testing.assert_allclose(dts[:-1], 7.0)
    np.testing.assert_allclose(dts[-1], 1.0, atol=1e-5)
    # exact division still appends a zero-length step (reference behavior)
    dts2 = dops.diffusion_dts(1800.0, 6.0)
    assert len(dts2) == 301 and dts2[-1] == 0.0


def test_diffusion_conserves_mass_without_degradation(rng):
    """Reflecting boundaries + no degradation => total mass is conserved."""
    grid = rng.random((16, 16)).astype(np.float32)
    dts = np.full((50,), 5.0, dtype=np.float32)
    out = np.asarray(dops.ftcs_diffuse(jnp.asarray(grid), jnp.asarray(dts),
                                       2.0, 100.0, 10.0, 0.0))
    np.testing.assert_allclose(out.sum(), grid.sum(), rtol=1e-4)
    assert out.std() < grid.std()  # smoothing


def test_sample_concentration_nearest_point():
    grid = jnp.arange(25, dtype=jnp.float32).reshape(5, 5)
    h = 10.0
    locs = jnp.array([
        [0.0, 0.0, 0.0],     # -> (0, 0)
        [14.9, 0.0, 0.0],    # -> (1, 0)  (nearest)
        [15.1, 21.0, 0.0],   # -> (2, 2)
        [40.0, 40.0, 0.0],   # -> (4, 4)
    ])
    vals = np.asarray(dops.sample_concentration(grid, locs, h))
    assert vals[0] == 0.0
    assert vals[1] == grid[1, 0]
    assert vals[2] == grid[2, 2]
    assert vals[3] == grid[4, 4]


def test_deposit_splits_among_nearby_points():
    grid = jnp.zeros((5, 5), dtype=jnp.float32)
    h = 10.0
    # near a lattice point: corners (0,0),(1,0),(0,1) are within h (strict <),
    # (1,1) at ~14 um is not -> 3 nearby points share the amount
    locs = jnp.array([[0.1, 0.1, 0.0]])
    out = np.asarray(dops.deposit_morphogen(grid, locs, jnp.array([3.0]), h))
    np.testing.assert_allclose(out[0, 0], 1.0)
    np.testing.assert_allclose(out[1, 0], 1.0)
    np.testing.assert_allclose(out[0, 1], 1.0)
    np.testing.assert_allclose(out.sum(), 3.0)

    # exactly at a lattice point: the other corners sit at exactly h, which
    # the strict inequality excludes -> everything lands on one point
    out = np.asarray(dops.deposit_morphogen(
        grid, jnp.array([[0.0, 0.0, 0.0]]), jnp.array([3.0]), h))
    np.testing.assert_allclose(out[0, 0], 3.0)
    np.testing.assert_allclose(out.sum(), 3.0)

    # centered in a cell: all 4 corners within h
    locs = jnp.array([[5.0, 5.0, 0.0]])
    out = np.asarray(dops.deposit_morphogen(grid, locs, jnp.array([4.0]), h))
    np.testing.assert_allclose(out[0:2, 0:2], 1.0)
    np.testing.assert_allclose(out.sum(), 4.0)


def test_deposit_out_of_bounds_dropped():
    grid = jnp.zeros((3, 3), dtype=jnp.float32)
    locs = jnp.array([[25.0, 25.0, 0.0]])  # corners at/beyond the last index
    out = np.asarray(dops.deposit_morphogen(grid, locs, jnp.array([1.0]), 10.0))
    assert np.isfinite(out).all()
    # the only in-bounds corner within radius is (2, 2) at distance ~7.07
    np.testing.assert_allclose(out.sum(), out[2, 2])


def test_stability_limit_helper():
    from hipsc_abm.models.params import DiffusionParams

    p = DiffusionParams(spat_res=10.0, diffuse_const=2.0)
    assert p.stability_limit() == 100.0 / 8.0
    assert p.diffuse_dt < p.stability_limit()


def test_field_coupled_pathway_drives_fate():
    """DiffusionParams.field_coupling: perceived FGF4 comes from the
    morphogen field at the cell's nearest diffusion point (the reference's
    ``get_concentration`` semantics, ``cell_methods.py:470-483``) — cell
    fate must respond to the field, and uptake must drain it."""
    from hipsc_abm.engine import HipscEngine
    from hipsc_abm.models.params import (
        DiffusionParams, ExperimentalParams, GeneralParams,
    )

    gen = GeneralParams(num_to_start=120, end_step=8, size=(600.0, 600.0, 0.0))
    xp = ExperimentalParams(num_gata6=0, dox_step=1)

    def run(initial, uptake=0.0):
        diff = DiffusionParams(spat_res=30.0, diffuse_dt=6.0, diffuse_const=2.0,
                               max_concentration=5.0, degradation=0.0,
                               release_amount=0.0, uptake_amount=uptake,
                               field_coupling=True)
        eng = HipscEngine(gen, xp, diff=diff, enable_diffusion=True)
        state = eng.init_state(seed=7)
        state = state._replace(gradients={
            "fgf4_values": jnp.full_like(state.gradients["fgf4_values"], initial)
        })
        for _ in range(4):
            state, _ = eng.safe_step(state)
        return state

    hi = run(4.0)
    lo = run(0.0)
    # saturated field -> perceived FGF4 = field-1 (=1 for BN_9) for most
    # cells; zero field -> perceived 0 exactly ((1+g)*0). ERK' = x1*x2, so
    # the ERK trajectory must differ between the two fields.
    assert not np.array_equal(
        np.asarray(hi.arrays["ERK"])[np.asarray(hi.alive)],
        np.asarray(lo.arrays["ERK"])[np.asarray(lo.alive)],
    )
    # zero field + multiplicative noise stays exactly zero-perceived: FGF4'
    # dynamics then never see x1, identical to a no-field run with FGF4=0
    drained = run(1.0, uptake=0.05)
    assert float(jnp.sum(drained.gradients["fgf4_values"])) < float(
        jnp.sum(run(1.0, uptake=0.0).gradients["fgf4_values"])
    )


def _deposit_case(seed=0, n=3000, shape=(40, 30), h=10.0):
    rng = np.random.default_rng(seed)
    locs = np.zeros((n, 3), np.float32)
    locs[:, 0] = rng.random(n) * shape[0] * h
    locs[:, 1] = rng.random(n) * shape[1] * h
    amounts = (rng.random(n) - 0.3).astype(np.float32)
    grid = rng.random(shape).astype(np.float32)
    return grid, locs, amounts, h


def test_deposit_bitwise_invariant_under_agent_permutation():
    """The deposit's per-point sums do not depend on agent order (a float
    scatter-add's do, through atomics on the GPU)."""
    grid, locs, amounts, h = _deposit_case()
    perm = np.random.default_rng(1).permutation(len(locs))
    a = np.asarray(dops.deposit_morphogen(jnp.asarray(grid), jnp.asarray(locs),
                                          jnp.asarray(amounts), h))
    b = np.asarray(dops.deposit_morphogen(jnp.asarray(grid), jnp.asarray(locs[perm]),
                                          jnp.asarray(amounts[perm]), h))
    np.testing.assert_array_equal(a, b)


def test_deposit_matches_float64_reference():
    """Against a float64 numpy deposit of the same rule: tolerance 1e-5 of
    the largest |value| — f32 sums of a few dozen O(1) shares per point."""
    grid, locs, amounts, h = _deposit_case(seed=2)
    got = np.asarray(dops.deposit_morphogen(jnp.asarray(grid), jnp.asarray(locs),
                                            jnp.asarray(amounts), h))
    want = grid.astype(np.float64)
    nx, ny = grid.shape
    for (x, y, _), amt in zip(locs.astype(np.float64), amounts.astype(np.float64)):
        bx, by = int(np.floor(x / h)), int(np.floor(y / h))
        pts = [(bx + dx, by + dy) for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1))
               if bx + dx < nx and by + dy < ny
               and np.hypot(x - (bx + dx) * h, y - (by + dy) * h) < h]
        for px, py in pts:
            want[px, py] += amt / len(pts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
