"""Fused-engine integration: invariants, determinism, capacity growth, and
bit-exact checkpoint/resume (SURVEY.md §4b-d)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hipsc_abm.engine import EngineConfig, HipscEngine
from hipsc_abm.models.params import BiologyParams, ExperimentalParams, GeneralParams


def small_engine(**kw):
    gen = GeneralParams(num_to_start=kw.pop("n", 200), end_step=5,
                        size=kw.pop("size", (400.0, 400.0, 0.0)))
    xp = ExperimentalParams(num_gata6=kw.pop("num_gata6", 20), dox_step=2)
    return HipscEngine(gen, xp, **kw)


def tree_equal(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_step_invariants():
    eng = small_engine()
    state = eng.init_state(seed=3)
    for _ in range(3):
        state, info = eng.safe_step(state)
        alive = np.asarray(state.alive)
        assert int(info.num_agents) == alive.sum()
        locs = np.asarray(state.arrays["locations"])[alive]
        assert (locs >= 0).all()
        assert (locs <= np.asarray(eng.gen.size)).all()
        assert (locs[:, 2] == 0).all()  # 2D space stays planar
        # forces zeroed at step end (reference cell_methods.py:436-439)
        assert not np.asarray(state.arrays["jkr_forces"]).any()
        assert not np.asarray(state.arrays["motility_forces"]).any()
        # states monotone valid
        states = np.asarray(state.arrays["states"])[alive]
        assert set(np.unique(states)) <= {0, 1}


def test_determinism_same_seed():
    eng1, eng2 = small_engine(), small_engine()
    s1, s2 = eng1.init_state(seed=11), eng2.init_state(seed=11)
    for _ in range(3):
        s1, _ = eng1.safe_step(s1)
        s2, _ = eng2.safe_step(s2)
    assert tree_equal(s1, s2)


def test_different_seed_differs():
    eng1, eng2 = small_engine(), small_engine()
    s1, s2 = eng1.init_state(seed=1), eng2.init_state(seed=2)
    s1, _ = eng1.safe_step(s1)
    s2, _ = eng2.safe_step(s2)
    assert not np.array_equal(
        np.asarray(s1.arrays["locations"]), np.asarray(s2.arrays["locations"])
    )


def test_capacity_growth_preserves_population():
    """A tiny capacity forces slot exhaustion; safe_step must double capacity
    and re-run so no division is silently dropped."""
    gen = GeneralParams(num_to_start=120, end_step=5, size=(300.0, 300.0, 0.0))
    xp = ExperimentalParams(num_gata6=0, dox_step=99)
    eng = HipscEngine(gen, xp)
    eng.cfg = dataclasses.replace(eng.cfg, capacity=128)  # only 8 free slots
    state = eng.init_state(seed=5)
    # force every cell past the division threshold and far from death
    state = state._replace(arrays={
        **state.arrays,
        "div_counters": jnp.full((128,), eng.bio.pluri_div_thresh, jnp.int32),
        "death_counters": jnp.zeros((128,), jnp.int32),
    })
    state, info = eng.safe_step(state)
    assert int(info.num_deferred) == 0  # growth handled it
    assert int(info.num_added) == 120  # every mother divided
    assert int(info.num_agents) == 240 - int(info.num_removed)
    assert eng.cfg.capacity >= 256  # growth actually happened


def test_bin_capacity_growth_is_exact():
    """Start with an absurdly small bin capacity: the first step must detect
    overflow, grow, and produce results identical to a roomy engine."""
    eng_small = small_engine()
    eng_big = small_engine()

    s_small = eng_small.init_state(seed=9)
    s_big = eng_big.init_state(seed=9)
    # shrink the caps *after* init_state (which auto-sizes them from data)
    eng_small.cfg = dataclasses.replace(
        eng_small.cfg,
        nbr_spec=dataclasses.replace(eng_small.cfg.nbr_spec, run_cap=1),
        jkr_spec=dataclasses.replace(eng_small.cfg.jkr_spec, run_cap=1),
        bond_cap=8,
    )
    s_small, _ = eng_small.safe_step(s_small)
    s_big, _ = eng_big.safe_step(s_big)
    # same physics regardless of internal capacity (windows only pad)
    np.testing.assert_allclose(
        np.asarray(s_small.arrays["locations"]),
        np.asarray(s_big.arrays["locations"]),
        atol=1e-5,
    )
    assert eng_small.cfg.nbr_spec.run_cap > 1


def test_checkpoint_resume_bit_exact(tmp_path):
    from hipsc_abm.utils.checkpoint import load_state, save_state

    eng = small_engine()
    state = eng.init_state(seed=21)
    for _ in range(2):
        state, _ = eng.safe_step(state)
    save_state(str(tmp_path / "ck.npz"), state, meta={"current_step": 2})

    # continue original
    cont = state
    for _ in range(2):
        cont, _ = eng.safe_step(cont)

    # resume from disk with a fresh engine, restoring the exact static
    # configuration (window widths feed RNG draw shapes)
    from hipsc_abm.engine import config_from_meta, config_to_meta

    eng2 = small_engine()
    restored, meta = load_state(str(tmp_path / "ck.npz"))
    assert meta["current_step"] == 2
    eng2.cfg = config_from_meta(config_to_meta(eng.cfg))
    assert eng2.cfg == eng.cfg
    assert tree_equal(restored, state)
    resumed = restored
    for _ in range(2):
        resumed, _ = eng2.safe_step(resumed)

    assert tree_equal(cont, resumed)


def test_dynamics_are_slot_layout_independent():
    """The same colony stored under a random slot permutation must evolve
    identically per agent (matched by stable id): randomness is id-keyed, the
    grid order is canonical (bin, id), and bonds store ids. This is the
    invariant the domain-decomposed engine builds on."""
    from hipsc_abm.ops.jkr import BondState

    eng = small_engine()
    s = eng.init_state(seed=17)
    perm = np.random.default_rng(0).permutation(s.capacity)
    s_perm = s._replace(
        arrays={k: v[perm] for k, v in s.arrays.items()},
        alive=s.alive[perm],
        bonds=BondState(partners=s.bonds.partners[perm], mask=s.bonds.mask[perm]),
    )

    for _ in range(3):
        s, _ = eng.safe_step(s)
        s_perm, _ = eng.safe_step(s_perm)

    def by_id(state):
        alive = np.asarray(state.alive)
        ids = np.asarray(state.arrays["ids"])[alive]
        order = np.argsort(ids)
        rows = {k: np.asarray(v)[alive][order] for k, v in state.arrays.items()}
        return ids[order], rows

    ids_a, rows_a = by_id(s)
    ids_b, rows_b = by_id(s_perm)
    np.testing.assert_array_equal(ids_a, ids_b)
    for name in rows_a:
        if rows_a[name].dtype.kind == "f":
            np.testing.assert_allclose(rows_a[name], rows_b[name], atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(rows_a[name], rows_b[name], err_msg=name)


def test_interleaved_states_across_growth():
    """Two live states on one engine: after one state triggers capacity
    growth, stepping the *other* (old-capacity) state must still work and
    produce the same result it would have before the growth — the grown
    config is a template, not a mutation of in-flight shapes."""
    # n chosen so 2*n0 exceeds the (256-aligned) initial capacity: every
    # agent dividing at once must overflow the free slots and defer
    eng = small_engine(n=300)
    a = eng.init_state(seed=13)
    b = eng.init_state(seed=14)
    b_expected, _ = eng.step(b)  # pre-growth reference result

    # force growth via state a (fill its division clocks at a tiny capacity)
    eng.cfg = dataclasses.replace(eng.cfg, capacity=a.capacity)
    a = a._replace(arrays={
        **a.arrays,
        "div_counters": jnp.full((a.capacity,), eng.bio.pluri_div_thresh, jnp.int32),
        "death_counters": jnp.zeros((a.capacity,), jnp.int32),
    })
    a, info = eng.safe_step(a)
    assert eng.cfg.capacity > b.capacity  # growth happened

    # the old-capacity state still steps, identically
    b_after, _ = eng.step(b)
    assert tree_equal(b_after, b_expected)


def test_three_d_space():
    eng = small_engine(size=(200.0, 200.0, 200.0), n=100, num_gata6=0)
    state = eng.init_state(seed=4)
    state, info = eng.safe_step(state)
    locs = np.asarray(state.arrays["locations"])[np.asarray(state.alive)]
    assert (locs[:, 2] >= 0).all() and (locs[:, 2] <= 200.0).all()
    assert np.ptp(locs[:, 2]) > 0  # motion uses all three dimensions


def test_population_extinction_ok():
    """All-lonely colony: everyone eventually dies; engine must handle an
    empty population without NaNs or crashes."""
    gen = GeneralParams(num_to_start=5, end_step=5, size=(4000.0, 4000.0, 0.0))
    xp = ExperimentalParams(num_gata6=0, dox_step=999, lonely_thresh=2)
    bio = BiologyParams(death_thresh=1)
    eng = HipscEngine(gen, xp, bio)
    state = eng.init_state(seed=8)
    # death counters start random in [0, death_thresh) = all 0; one step kills all
    for _ in range(3):
        state, info = eng.safe_step(state)
    assert int(info.num_agents) == 0
    assert np.isfinite(np.asarray(state.arrays["locations"])).all()


def _canon(state):
    alive = np.asarray(state.alive)
    ids = np.asarray(state.arrays["ids"])[alive]
    order = np.argsort(ids)
    out = {"ids": ids[order]}
    for k, v in state.arrays.items():
        if k != "ids":
            out[k] = np.asarray(v)[alive][order]
    return out


def test_run_steps_matches_safe_step_sequence():
    """run_steps(state, k) must be semantically identical to k safe_steps —
    the scan body IS hipsc_step; only the host boundary moves. Includes a
    capacity-growth event inside the block (blocks re-execute whole)."""
    gen = GeneralParams(num_to_start=300, end_step=20, size=(420.0, 420.0, 0.0))
    xp = ExperimentalParams(num_gata6=30, dox_step=2)

    eng_a = HipscEngine(gen, xp)
    eng_b = HipscEngine(gen, xp)
    # force a growth event inside the block: start with tight caps
    eng_b.cfg = dataclasses.replace(
        eng_b.cfg,
        nbr_spec=dataclasses.replace(eng_b.cfg.nbr_spec, run_cap=8),
    )
    eng_a.cfg = dataclasses.replace(
        eng_a.cfg,
        nbr_spec=dataclasses.replace(eng_a.cfg.nbr_spec, run_cap=8),
    )

    sa = eng_a.init_state(seed=7)
    sb = eng_b.init_state(seed=7)
    k = 6
    for _ in range(k):
        sa, info_a = eng_a.safe_step(sa)
    sb, infos = eng_b.run_steps(sb, k)

    # stacked probes: every field has a leading (k,) axis
    assert np.asarray(infos.num_agents).shape == (k,)
    assert int(infos.num_agents[-1]) == int(info_a.num_agents)

    a, b = _canon(sa), _canon(sb)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for key in ("GATA6", "NANOG", "states", "div_counters", "death_counters"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_array_equal(a["locations"], b["locations"])


@pytest.mark.parametrize("capacity", [1, 255, 256, 5000, 70000])
def test_engine_config_create_rounds_capacity(capacity):
    """EngineConfig.create rounds capacities up to the 256-slot quantum that
    capacity growth also uses, and caps div_cap at the capacity."""
    cfg = EngineConfig.create((400.0, 400.0, 0.0), capacity=capacity,
                              bio=BiologyParams())
    assert cfg.capacity % 256 == 0
    assert capacity <= cfg.capacity < capacity + 256
    assert 0 < cfg.div_cap <= cfg.capacity


def test_bond_cap_guard_raises_before_worker_kill_zone():
    """Growth past the guarded bond_cap (bond degree ~160 at ~21x reference
    density, where the step faulted the device worker on the accelerator
    the engine was first built for) must raise a loud framework error
    naming the limit, never grow silently."""
    gen = GeneralParams(num_to_start=220, end_step=3,
                        size=(400.0, 400.0, 0.0))
    xp = ExperimentalParams(num_gata6=0, dox_step=2)
    eng = HipscEngine(gen, xp)
    # a near-coincident packing: every cell inside every other's contact
    # radius -> contact degree ~219 -> demanded bond_cap > the guard
    locs = 200.0 + np.random.default_rng(0).random((220, 3)) * 0.5
    locs[:, 2] = 0.0
    state = eng.init_state(seed=0, locations=locs)
    with pytest.raises(RuntimeError, match="bond_cap|HIPSC_MAX_BOND_CAP"):
        for _ in range(4):
            state, _ = eng.safe_step(state)


def test_bond_cap_guard_env_override(monkeypatch):
    """HIPSC_MAX_BOND_CAP lifts the guard."""
    from hipsc_abm.engine import max_safe_bond_cap

    assert max_safe_bond_cap() == 128
    monkeypatch.setenv("HIPSC_MAX_BOND_CAP", "512")
    assert max_safe_bond_cap() == 512


def test_dense_pairs_matches_windowed():
    """The all-pairs physics path (EngineConfig.dense_pairs — zero gathers,
    for calibration-sized colonies) agrees with the windowed XLA path over
    several steps with division/death active: identical ids and bond SETS,
    positions to reduction-order tolerance."""
    eng_w = small_engine()
    eng_d = small_engine()
    eng_d.cfg = dataclasses.replace(eng_d.cfg, dense_pairs=True)

    sw = eng_w.init_state(seed=6)
    sd = eng_d.init_state(seed=6)
    for _ in range(4):
        sw, iw = eng_w.safe_step(sw)
        sd, idn = eng_d.safe_step(sd)
        assert int(iw.num_added) == int(idn.num_added)
        assert int(iw.jkr_max_degree) == int(idn.jkr_max_degree)

    a, b = _canon(sw), _canon(sd)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    np.testing.assert_allclose(a["locations"], b["locations"], atol=2e-4)
    for k in ("GATA6", "NANOG", "states", "div_counters", "death_counters"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # bond SETS are identical (id pairs), independent of slot/window order
    def bond_sets(state):
        alive = np.asarray(state.alive)
        ids = np.asarray(state.arrays["ids"])
        partners = np.asarray(state.bonds.partners)
        mask = np.asarray(state.bonds.mask)
        out = set()
        for i in np.nonzero(alive)[0]:
            for k in np.nonzero(mask[i])[0]:
                out.add((int(ids[i]), int(partners[i, k])))
        return out

    assert bond_sets(sw) == bond_sets(sd)


def test_config_from_meta_ignores_removed_kernel_keys():
    """Checkpoints written by older versions carry kernel options that are
    no longer EngineConfig fields; they load and the rest round-trips."""
    from hipsc_abm.engine import config_from_meta, config_to_meta

    cfg = small_engine().cfg
    meta = config_to_meta(cfg)
    meta.update(use_pallas=True, use_pallas_ftcs=True, pallas_block=128,
                pallas_interpret=False, jkr_span=512, nbr_span=512,
                pallas_chunk=256, uniform_radius=5.0, carry_window=False)
    assert config_from_meta(meta) == cfg
