"""Biology phase semantics: death clocks, division slot allocation, FDS
pathway gating/truth table, differentiation, motility rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hipsc_abm.models import biology
from hipsc_abm.models.params import BiologyParams, ExperimentalParams

BIO = BiologyParams()
XP = ExperimentalParams()
KEY = jax.random.PRNGKey(7)

# jitted variants (params dataclasses are hashable statics); avoids the
# per-primitive eager dispatch cost on CPU test runs
death_j = jax.jit(biology.cell_death, static_argnums=(4, 5))
division_j = jax.jit(biology.cell_division, static_argnums=(4, 5))
pathway_j = jax.jit(biology.cell_pathway, static_argnums=(13, 14))
differentiate_j = jax.jit(biology.cell_differentiate, static_argnums=(7,))
diff_surround_j = jax.jit(biology.cell_diff_surround, static_argnums=(5,))
growth_j = jax.jit(biology.cell_growth, static_argnums=(4,))
stochastic_j = jax.jit(biology.cell_stochastic_update, static_argnums=(5, 6))
motility_j = jax.jit(biology.cell_motility, static_argnums=(13, 14, 15))


def no_neighbors(capacity, window=8):
    cand = jnp.zeros((capacity, window), dtype=jnp.int32)
    mask = jnp.zeros((capacity, window), dtype=bool)
    return cand, mask


# ---------------------------------------------------------------------------
# death
# ---------------------------------------------------------------------------


def test_death_counter_semantics():
    states = jnp.array([0, 0, 0, 1])
    counters = jnp.array([10, BIO.death_thresh - 1, 5, BIO.death_thresh - 1])
    alive = jnp.ones(4, bool)
    nbr_count = jnp.array([0, 1, 5, 0])  # lonely, lonely, crowded, lonely-but-diff

    new_counters, removed, num = death_j(
        states, counters, alive, nbr_count, XP.lonely_thresh, BIO.death_thresh
    )
    assert new_counters.tolist() == [11, BIO.death_thresh, 0, BIO.death_thresh - 1]
    assert removed.tolist() == [False, True, False, False]  # only pluripotent die
    assert int(num) == 1


def test_dead_slots_untouched():
    states = jnp.zeros(3, int)
    counters = jnp.array([5, 5, 5])
    alive = jnp.array([True, False, True])
    nbr_count = jnp.zeros(3, int)
    new_counters, removed, _ = death_j(
        states, counters, alive, nbr_count, XP.lonely_thresh, BIO.death_thresh
    )
    assert int(new_counters[1]) == 5 and not bool(removed[1])


# ---------------------------------------------------------------------------
# division
# ---------------------------------------------------------------------------


def make_arrays(capacity, **overrides):
    from hipsc_abm.engine import HIPSC_ARRAY_SPECS

    arrays = {}
    for name, (dtype, vec) in HIPSC_ARRAY_SPECS.items():
        shape = (capacity,) if vec is None else (capacity, vec)
        arrays[name] = jnp.zeros(shape, dtype=dtype)
    arrays["ids"] = jnp.arange(capacity, dtype=jnp.int32)
    arrays.update({k: jnp.asarray(v) for k, v in overrides.items()})
    return arrays


def test_division_mother_daughter_placement():
    C = 8
    arrays = make_arrays(
        C,
        locations=np.tile([[50.0, 50.0, 0.0]], (C, 1)).astype(np.float32),
        div_counters=np.array([BIO.pluri_div_thresh + 1, 0, 0, 0, 0, 0, 0, 0]),
        GATA6=np.array([1, 0, 0, 0, 0, 0, 0, 0]),
        radii=np.full(C, 5.0, np.float32),
    )
    alive = jnp.array([True, True, True, False, False, False, False, False])
    nbr_count = jnp.zeros(C, int)

    new_arrays, new_alive, daughters, num_added, deferred, _ = division_j(
        arrays, alive, nbr_count, KEY, BIO, two_d=True
    )
    assert int(num_added) == 1 and int(deferred) == 0
    d = int(np.argmax(np.asarray(daughters)))
    assert not bool(alive[d]) and bool(new_alive[d])  # daughter in a free slot
    # mother at +v, daughter at -v around the original location
    mother = np.asarray(new_arrays["locations"][0])
    daughter = np.asarray(new_arrays["locations"][d])
    sep = BIO.max_radius - BIO.min_radius
    np.testing.assert_allclose((mother + daughter) / 2, [50.0, 50.0, 0.0], atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(mother - daughter), 2 * sep, rtol=1e-5)
    # counters reset, attributes copied
    assert int(new_arrays["div_counters"][0]) == 0
    assert int(new_arrays["div_counters"][d]) == 0
    assert int(new_arrays["GATA6"][d]) == 1
    assert float(new_arrays["radii"][d]) == 5.0


def test_division_contact_inhibition_and_thresholds():
    C = 8
    arrays = make_arrays(
        C,
        div_counters=np.array([40, 40, 80, 80, 10, 0, 0, 0]),
        states=np.array([0, 0, 1, 1, 0, 0, 0, 0]),
    )
    alive = jnp.array([True] * 5 + [False] * 3)
    nbr_count = jnp.array([0, 0, 2, 6, 0, 0, 0, 0])  # slot 3 inhibited

    _, new_alive, daughters, num_added, _, _ = division_j(
        arrays, alive, nbr_count, KEY, BIO, two_d=True
    )
    # slots 0,1 (pluri >= 36) and 2 (diff >= 72, uncrowded) divide; 3 inhibited
    assert int(num_added) == 3
    assert int(jnp.sum(new_alive)) == 8


def test_division_deferred_when_full():
    C = 4
    arrays = make_arrays(C, div_counters=np.array([40, 40, 40, 40]))
    alive = jnp.ones(C, bool)
    _, new_alive, _, num_added, deferred, _ = division_j(
        arrays, alive, jnp.zeros(C, int), KEY, BIO, two_d=True
    )
    assert int(num_added) == 0 and int(deferred) == 4
    assert bool(jnp.all(new_alive))


def test_division_counter_stochastic_increment():
    C = 512
    arrays = make_arrays(C)
    alive = jnp.ones(C, bool)
    new_arrays, _, _, _, _, _ = division_j(
        arrays, alive, jnp.zeros(C, int), KEY, BIO, two_d=True
    )
    frac = float(jnp.mean(new_arrays["div_counters"]))
    assert 0.4 < frac < 0.6  # randint(0, 1) mean ~0.5


# ---------------------------------------------------------------------------
# pathway
# ---------------------------------------------------------------------------


def run_pathway(FGF4, FGFR, ERK, GATA6, NANOG, step, fds_counters=None, mask=None):
    n = len(FGF4)
    f = np.asarray(FGF4, np.float32)
    if mask is None:
        count = np.zeros(n, np.int32)
        sum_f = np.zeros(n, np.float32)
        sum_f2 = np.zeros(n, np.float32)
    else:
        m = np.asarray(mask)
        count = m.sum(axis=1).astype(np.int32)
        sum_f = (m * f[None, :]).sum(axis=1).astype(np.float32)
        sum_f2 = (m * (f * f)[None, :]).sum(axis=1).astype(np.float32)
    if fds_counters is None:
        fds_counters = np.zeros(n, int)
    return pathway_j(
        jnp.asarray(FGF4), jnp.asarray(FGFR), jnp.asarray(ERK),
        jnp.asarray(GATA6), jnp.asarray(NANOG), jnp.asarray(fds_counters),
        jnp.arange(n, dtype=jnp.int32), jnp.ones(n, bool), jnp.asarray(count),
        jnp.asarray(sum_f), jnp.asarray(sum_f2), KEY, jnp.asarray(step), XP, BIO,
    )


def test_pathway_inactive_before_dox():
    vals = run_pathway([1, 0], [1, 1], [1, 0], [0, 1], [1, 0], step=XP.dox_step - 1)
    assert vals[0].tolist() == [1, 0]  # FGF4 unchanged
    assert vals[5].tolist() == [0, 0]  # counters did not advance


def test_pathway_bn9_truth_table_zero_fgf4():
    """With FGF4 = 0 everywhere, perceived FGF4 is deterministically 0
    ((1+noise)*0 == 0), making the Boolean update exactly checkable."""
    # columns: FGFR(x2), ERK(x3), GATA6(x4), NANOG(x5)
    combos = [(x2, x3, x4, x5) for x2 in (0, 1) for x3 in (0, 1)
              for x4 in (0, 1) for x5 in (0, 1)]
    FGFR, ERK, GATA6, NANOG = map(np.array, zip(*combos))
    FGF4 = np.zeros(len(combos), int)
    nF, nR, nE, nG, nN, counters = run_pathway(FGF4, FGFR, ERK, GATA6, NANOG, XP.dox_step)
    for i, (x2, x3, x4, x5) in enumerate(combos):
        x1 = 0  # perceived
        assert int(nF[i]) == x5
        assert int(nR[i]) == (1 + x5 + x4 * x5) % 2
        assert int(nE[i]) == (x1 * x2) % 2
        assert int(nG[i]) == (x3 + x4 + x3 * x4 + x3 * x5 + x4 * x5 + x3 * x4 * x5) % 2
        assert int(nN[i]) == (x5 + x3 * x5 + x4 * x5 + x3 * x4 * x5) % 2
    assert counters.tolist() == [1] * len(combos)


def test_pathway_fds_thresh_gates_update():
    bio3 = BiologyParams(fds_thresh=3)
    n = 1
    z = jnp.zeros(n, jnp.float32)
    # counter 1 -> 1 % 3 != 0 -> no update even though NANOG=1 would flip FGF4
    out = biology.cell_pathway(
        jnp.array([0]), jnp.array([0]), jnp.array([0]), jnp.array([0]), jnp.array([1]),
        jnp.array([1]), jnp.arange(n, dtype=jnp.int32), jnp.ones(n, bool),
        jnp.zeros(n, jnp.int32), z, z, KEY, jnp.asarray(XP.dox_step), XP, bio3,
    )
    assert int(out[0][0]) == 0 and int(out[5][0]) == 2


def test_pathway_perceived_fgf4_uses_neighborhood_mean(rng):
    """All-high FGF4 neighborhood: perceived = floor(mean of (1+g)) clipped to
    field-1; statistically ~3/4 of draws floor to >= 1. Just assert it is a
    valid field element and the ERK rule consumed it."""
    n = 64
    cand = jnp.tile(jnp.arange(n, dtype=jnp.int32)[None, :], (n, 1))
    mask = ~jnp.eye(n, dtype=bool)
    nF, nR, nE, nG, nN, _ = run_pathway(
        np.ones(n, int), np.ones(n, int), np.zeros(n, int),
        np.zeros(n, int), np.zeros(n, int), XP.dox_step,
        mask=mask,
    )
    assert set(np.asarray(nE).tolist()) <= {0, 1}
    assert np.asarray(nE).mean() > 0.2  # x1=1 happens often -> ERK = x1*x2 = 1


# ---------------------------------------------------------------------------
# differentiate / diff_surround / growth / stochastic
# ---------------------------------------------------------------------------


def test_differentiate_trigger():
    GATA6 = jnp.array([1, 1, 0, 1])
    NANOG = jnp.array([0, 0, 1, 0])
    states = jnp.array([0, 0, 0, 1])
    counters = jnp.array([BIO.pluri_to_diff, 0, BIO.pluri_to_diff, BIO.pluri_to_diff])
    alive = jnp.ones(4, bool)
    ids = jnp.arange(4, dtype=jnp.int32)
    nN, nS, nC = differentiate_j(GATA6, NANOG, states, counters, ids, alive, KEY, BIO)
    assert int(nS[0]) == 1 and int(nN[0]) == 0  # triggered
    assert int(nS[1]) == 0  # counter too low (36 needed; 0 or 1 after increment)
    assert int(nS[2]) == 0  # NANOG high, not eligible
    assert int(nS[3]) == 1  # already differentiated, untouched


def test_diff_surround_induction():
    n = 8
    states = jnp.array([0, 1, 1, 1, 1, 1, 1, 0])
    num_diff = jnp.array([6, 0, 0, 0, 0, 0, 0, 0])  # agent 0 sees 6 diff nbrs
    GATA6 = jnp.zeros(n, int)
    NANOG = jnp.ones(n, int)
    nG, nN = diff_surround_j(
        GATA6, NANOG, states, jnp.ones(n, bool), num_diff, BIO
    )
    assert int(nG[0]) == BIO.field - 1 and int(nN[0]) == 0
    assert int(nG[7]) == 0 and int(nN[7]) == 1  # no neighbors -> unchanged


def test_growth_tracks_division_clock():
    radii = jnp.array([BIO.min_radius, BIO.max_radius, BIO.min_radius], dtype=jnp.float32)
    states = jnp.array([0, 0, 1])
    div_counters = jnp.array([18, 18, 36])
    new = growth_j(radii, states, div_counters, jnp.ones(3, bool), BIO)
    np.testing.assert_allclose(
        float(new[0]), BIO.pluri_growth * 18 + BIO.min_radius, rtol=1e-6
    )
    assert float(new[1]) == BIO.max_radius  # at max: no growth
    np.testing.assert_allclose(
        float(new[2]), BIO.diff_growth * 36 + BIO.min_radius, rtol=1e-6
    )


def test_stochastic_update_rate():
    n = 20000
    GATA6 = jnp.zeros(n, int)
    NANOG = jnp.zeros(n, int)
    nG, nN = stochastic_j(GATA6, NANOG, jnp.arange(n, dtype=jnp.int32),
                          jnp.ones(n, bool), KEY, BIO)
    rate = float(jnp.mean(nG))
    assert 0.005 < rate < 0.015  # ~GATA6_prob
    assert not bool(jnp.any(nN))  # NANOG branch disabled by default (as in ref)


# ---------------------------------------------------------------------------
# motility
# ---------------------------------------------------------------------------


def motility_setup(states, GATA6, NANOG, neighbor_of_0=None):
    n = len(states)
    locs = np.zeros((n, 3), np.float32)
    locs[:, 0] = np.arange(n) * 5.0
    mask = np.zeros((n, n), bool)
    if neighbor_of_0 is not None:
        mask[0, neighbor_of_0] = True
        mask[neighbor_of_0, 0] = True
    G = np.asarray(GATA6); N = np.asarray(NANOG); S = np.asarray(states)
    disp = locs[None, :, :] - locs[:, None, :]
    nanog_j = mask & (N[None, :] > G[None, :])
    diff_j = mask & (S[None, :] != 0)
    return (
        jnp.asarray(locs), jnp.asarray(GATA6), jnp.asarray(NANOG), jnp.asarray(states),
        jnp.zeros((n, 3), jnp.float32), jnp.arange(n, dtype=jnp.int32), jnp.ones(n, bool),
        jnp.asarray(mask.sum(axis=1).astype(np.int32)),
        jnp.asarray(nanog_j.sum(axis=1).astype(np.int32)),
        jnp.asarray((nanog_j[..., None] * disp).sum(axis=1).astype(np.float32)),
        jnp.asarray(diff_j.sum(axis=1).astype(np.int32)),
        jnp.asarray((diff_j[..., None] * disp).sum(axis=1).astype(np.float32)),
    )


def test_motility_crowded_cells_get_no_force():
    n = 8
    z3 = jnp.zeros((n, 3), jnp.float32)
    zi = jnp.zeros(n, jnp.int32)
    out = motility_j(
        jnp.zeros((n, 3), jnp.float32), jnp.zeros(n, int), jnp.ones(n, int),
        jnp.zeros(n, int), z3, jnp.arange(n, dtype=jnp.int32), jnp.ones(n, bool),
        jnp.full(n, 7, jnp.int32), zi, z3, zi, z3, KEY, XP, BIO, True,
    )
    np.testing.assert_allclose(np.asarray(out), 0.0)


def test_motility_differentiated_moves_away_from_nanog_high():
    # agent 0 differentiated at x=0; agent 1 NANOG-high at x=5
    args = motility_setup(states=[1, 0], GATA6=[0, 0], NANOG=[0, 1], neighbor_of_0=1)
    out = motility_j(*args, KEY, XP, BIO, True)
    f0 = np.asarray(out[0])
    assert f0[0] < 0  # away from the neighbor at +x
    np.testing.assert_allclose(np.linalg.norm(f0) <= BIO.motility_force * 1.001, True)


def test_motility_nanog_high_moves_toward_nanog_high():
    args = motility_setup(states=[0, 0], GATA6=[0, 0], NANOG=[1, 1], neighbor_of_0=1)
    out = motility_j(*args, KEY, XP, BIO, True)
    assert np.asarray(out[0])[0] > 0  # toward the neighbor at +x
    assert np.asarray(out[1])[0] < 0  # and vice versa


def test_motility_guye_bug_compat_random_direction():
    """Reference bug (cell_methods.py:287): GATA6-high cells under guye_move
    always move randomly. With the fix they move toward differentiated
    neighbors."""
    states = [0, 1]
    args = motility_setup(states=states, GATA6=[1, 0], NANOG=[0, 0], neighbor_of_0=1)
    out_bug = motility_j(*args, KEY, XP, BIO, True)
    # bug-compat: direction is the raw random unit vector (magnitude == force)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(out_bug[0])), BIO.motility_force, rtol=1e-5
    )
    bio_fixed = BiologyParams(guye_bug_compat=False)
    out_fixed = motility_j(*args, KEY, XP, bio_fixed, True)
    assert np.asarray(out_fixed[0])[0] > 0  # toward differentiated neighbor at +x


def test_motility_undecided_random_magnitude():
    args = motility_setup(states=[0, 0], GATA6=[0, 0], NANOG=[0, 0], neighbor_of_0=1)
    out = motility_j(*args, KEY, XP, BIO, True)
    for i in range(2):
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(out[i])), BIO.motility_force, rtol=1e-5
        )
