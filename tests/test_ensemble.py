"""Ensemble engine: vmapped replicate colonies are bit-identical to solo
runs, shard collective-free over a mesh, grow capacities safely, and
support traced parameter sweeps (parallel.ensemble)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hipsc_abm.engine import HipscEngine
from hipsc_abm.models.params import ExperimentalParams, GeneralParams
from hipsc_abm.parallel.ensemble import EnsembleEngine


def make_engine(n=200, num_gata6=20, size=(400.0, 400.0, 0.0), **kw):
    gen = GeneralParams(num_to_start=n, end_step=5, size=size)
    xp_kw = kw.pop("xp", {})
    xp = ExperimentalParams(num_gata6=num_gata6, dox_step=2, **xp_kw)
    return HipscEngine(gen, xp, **kw)


def rows_by_id(state):
    """{agent id: concatenated row values} over alive slots (layout-free)."""
    alive = np.asarray(state.alive)
    ids = np.asarray(state.arrays["ids"])[alive]
    cols = []
    for name in sorted(state.arrays):
        a = np.asarray(state.arrays[name])[alive]
        cols.append(a.reshape(len(ids), -1).astype(np.float64))
    table = np.concatenate(cols, axis=1)
    order = np.argsort(ids)
    return ids[order], table[order]


def assert_states_equal(a, b):
    ia, ta = rows_by_id(a)
    ib, tb = rows_by_id(b)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(np.asarray(a.key), np.asarray(b.key))
    assert int(a.next_id) == int(b.next_id)


def test_replicates_bit_exact_vs_solo():
    """Each replicate of a vmapped ensemble step reproduces the same seed
    run solo, bit for bit (ints AND floats), across several steps with
    division/death/pathway active."""
    seeds = [3, 11, 42]
    ens = EnsembleEngine(make_engine())
    states = ens.init_states(seeds)

    solos = []
    for seed in seeds:
        eng = make_engine()
        s = eng.init_state(seed=seed)
        # pin the solo config to the ensemble's shared one so both sides
        # compile the exact same per-replicate program
        eng.cfg = ens.engine.cfg
        solos.append((eng, s))

    for _ in range(4):
        states, infos = ens.safe_step(states)
        for i, (eng, s) in enumerate(solos):
            s, info = eng.safe_step(s)
            solos[i] = (eng, s)
            assert int(np.asarray(infos.num_agents)[i]) == int(info.num_agents)

    for i, (eng, s) in enumerate(solos):
        assert_states_equal(EnsembleEngine.replicate(states, i), s)


def test_ensemble_growth_bit_exact_same_seed():
    """Capacity growth inside the ensemble (probes max-reduced across
    replicates, one shared config regrown, step re-executed) stays exact:
    identical-seed replicates remain bit-identical to the solo run through
    a growth event."""
    # shrink the slot headroom so early divisions exhaust free slots and
    # trip the capacity-doubling probe within a few steps
    ens_eng = make_engine(n=220, num_gata6=30, size=(220.0, 220.0, 0.0))
    ens_eng.cfg = dataclasses.replace(ens_eng.cfg, capacity=256)
    ens = EnsembleEngine(ens_eng)
    seeds = [7, 7, 7]
    states = ens.init_states(seeds)

    solo = make_engine(n=220, num_gata6=30, size=(220.0, 220.0, 0.0))
    solo.cfg = dataclasses.replace(solo.cfg, capacity=256)
    s = solo.init_state(seed=7)
    solo.cfg = ens.engine.cfg

    cap0 = states.alive.shape[1]
    grew = False
    for _ in range(6):
        states, _ = ens.safe_step(states)
        s, _ = solo.safe_step(s)
        grew = grew or states.alive.shape[1] != cap0
        # identical seeds must remain identical replicates
        assert_states_equal(EnsembleEngine.replicate(states, 0),
                            EnsembleEngine.replicate(states, 1))
    assert grew, "test workload never grew capacity — densify it"
    assert states.alive.shape[1] == s.capacity  # same growth decisions
    assert_states_equal(EnsembleEngine.replicate(states, 0), s)


def test_ensemble_sharded_over_mesh_no_collectives():
    """Replicate-DP: the replicate axis shards over the device mesh, the
    step partitions with zero collectives, and results match unsharded."""
    devs = jax.devices()
    assert len(devs) == 8
    mesh = jax.sharding.Mesh(np.asarray(devs), ("r",))

    ens = EnsembleEngine(make_engine())
    seeds = list(range(8))
    states = ens.init_states(seeds)
    sharded = EnsembleEngine.shard_states(states, mesh)

    out_plain, _ = ens.step(states)
    out_shard, _ = ens.step(sharded)

    # still sharded along the replicate axis after the step
    shard_spec = out_shard.alive.sharding
    assert shard_spec.is_equivalent_to(
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("r")),
        out_shard.alive.ndim,
    )
    for i in (0, 5):
        assert_states_equal(EnsembleEngine.replicate(out_plain, i),
                            EnsembleEngine.replicate(out_shard, i))

    # embarrassingly parallel: the compiled module moves zero bytes
    # between devices
    cfg = ens._cfg_for_states(states)
    hlo = ens._step_fn(cfg).lower(sharded).compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in hlo, f"unexpected collective {op} in ensemble step"


def test_parameter_sweep_matches_solo_param_values():
    """A dox_step/lonely_thresh sweep traced per replicate reproduces each
    parameter point's solo run bit for bit — one compile for the sweep."""
    sweep = {"dox_step": [1, 3, 100], "lonely_thresh": [2, 2, 3]}
    seeds = [5, 5, 5]
    ens = EnsembleEngine(make_engine(), sweep=sweep)
    states = ens.init_states(seeds)

    solos = []
    for i in range(3):
        eng = make_engine(xp={})
        eng.xp = dataclasses.replace(
            eng.xp, dox_step=sweep["dox_step"][i],
            lonely_thresh=sweep["lonely_thresh"][i],
        )
        s = eng.init_state(seed=5)
        eng.cfg = ens.engine.cfg
        solos.append((eng, s))

    for _ in range(4):
        states, _ = ens.safe_step(states)
        for i, (eng, s) in enumerate(solos):
            s, _ = eng.safe_step(s)
            solos[i] = (eng, s)

    # dox_step=1 vs dox_step=100 must actually diverge (the sweep is live)
    i0, t0 = rows_by_id(EnsembleEngine.replicate(states, 0))
    i2, t2 = rows_by_id(EnsembleEngine.replicate(states, 2))
    assert not (len(i0) == len(i2) and np.array_equal(t0, t2))

    for i, (eng, s) in enumerate(solos):
        assert_states_equal(EnsembleEngine.replicate(states, i), s)


def test_sweep_rejects_trace_time_parameters():
    with pytest.raises(ValueError, match="not sweepable"):
        EnsembleEngine(make_engine(), sweep={"guye_move": [0, 1]})
    with pytest.raises(ValueError, match="share one length"):
        EnsembleEngine(make_engine(),
                       sweep={"dox_step": [1, 2], "lonely_thresh": [2]})


def test_physics_parameter_sweep_matches_solo():
    """The continuous physics parameters are sweepable too (the traced-
    dataclass treatment calibrate.py relies on): an adhesion/motility
    dose-response sweep reproduces each point's solo run — ints bit-exact,
    floats to f32 rounding (a solo engine constant-folds the python-float
    parameter at compile time; the sweep computes with a traced f32
    scalar, so position arithmetic rounds differently by a few ulp)."""
    sweep = {"adhesion_const": [0.000107, 0.0003, 0.00005],
             "motility_force": [2e-9, 2e-9, 8e-9]}
    seeds = [5, 5, 5]
    ens = EnsembleEngine(make_engine(), sweep=sweep)
    states = ens.init_states(seeds)

    solos = []
    for i in range(3):
        eng = make_engine()
        eng.bio = dataclasses.replace(
            eng.bio, adhesion_const=sweep["adhesion_const"][i],
            motility_force=sweep["motility_force"][i],
        )
        s = eng.init_state(seed=5)
        eng.cfg = ens.engine.cfg
        solos.append((eng, s))

    for _ in range(3):
        states, _ = ens.safe_step(states)
        for i, (eng, s) in enumerate(solos):
            s, _ = eng.safe_step(s)
            solos[i] = (eng, s)

    # the dose actually matters: high-adhesion and high-motility replicates
    # must diverge from the base replicate (by far more than f32 rounding)
    i0, t0 = rows_by_id(EnsembleEngine.replicate(states, 0))
    i1, t1 = rows_by_id(EnsembleEngine.replicate(states, 1))
    assert len(i0) != len(i1) or np.abs(t0 - t1).max() > 1e-2

    for i, (eng, s) in enumerate(solos):
        rep = EnsembleEngine.replicate(states, i)
        ia, ta = rows_by_id(rep)
        ib, tb = rows_by_id(s)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(ta, tb, rtol=1e-5, atol=1e-4)
        # discrete state (fates, counters) must be IDENTICAL — compare the
        # int lanes of the id-sorted table exactly
        int_cols = []
        col = 0
        for name in sorted(rep.arrays):
            a = np.asarray(rep.arrays[name])
            width = 1 if a.ndim == 1 else a.shape[1]
            if a.dtype.kind == "i" and name != "ids":
                int_cols.extend(range(col, col + width))
            col += width
        np.testing.assert_array_equal(ta[:, int_cols], tb[:, int_cols])
