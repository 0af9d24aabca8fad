"""Multi-chip sharding on the virtual 8-device CPU mesh: the sharded fused
step must compile, execute, and agree with the single-device engine."""

import jax
import numpy as np
import pytest

from hipsc_abm.engine import HipscEngine
from hipsc_abm.models.params import ExperimentalParams, GeneralParams
from hipsc_abm.parallel.mesh import ShardedHipscEngine, make_mesh, shard_state


requires_multi = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device CPU mesh"
)


def params():
    gen = GeneralParams(num_to_start=200, end_step=3, size=(400.0, 400.0, 0.0))
    xp = ExperimentalParams(num_gata6=20, dox_step=2)
    return gen, xp


@requires_multi
def test_mesh_creation():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8


@requires_multi
def test_sharded_step_runs_and_stays_sharded():
    gen, xp = params()
    eng = ShardedHipscEngine(gen, xp, mesh=make_mesh(8))
    state = eng.init_state(seed=0)
    assert state.arrays["locations"].sharding.is_fully_replicated is False
    state, info = eng.safe_step(state)
    assert int(info.num_agents) > 0
    # outputs keep the agent sharding (no silent gather to one device)
    assert state.arrays["locations"].sharding.is_fully_replicated is False
    locs = np.asarray(state.arrays["locations"])[np.asarray(state.alive)]
    assert (locs >= 0).all() and (locs <= 400.0).all()


@requires_multi
def test_sharded_matches_single_device():
    """Same seed, same physics: the sharded step must be numerically
    equivalent to the single-device step (collectives only change layout)."""
    gen, xp = params()
    eng_s = ShardedHipscEngine(gen, xp, mesh=make_mesh(8))
    eng_1 = HipscEngine(gen, xp)
    import dataclasses

    eng_1.cfg = dataclasses.replace(eng_1.cfg, capacity=eng_s.cfg.capacity)

    s_sharded = eng_s.init_state(seed=17)
    s_single = eng_1.init_state(seed=17)
    for _ in range(2):
        s_sharded, _ = eng_s.safe_step(s_sharded)
        s_single, _ = eng_1.safe_step(s_single)

    np.testing.assert_array_equal(np.asarray(s_sharded.alive), np.asarray(s_single.alive))
    np.testing.assert_allclose(
        np.asarray(s_sharded.arrays["locations"]),
        np.asarray(s_single.arrays["locations"]),
        atol=1e-5,
    )
    for name in ("GATA6", "NANOG", "states", "div_counters"):
        np.testing.assert_array_equal(
            np.asarray(s_sharded.arrays[name]), np.asarray(s_single.arrays[name]),
            err_msg=name,
        )


@requires_multi
def test_sharded_capacity_growth():
    import dataclasses

    import jax.numpy as jnp

    gen = GeneralParams(num_to_start=120, end_step=3, size=(300.0, 300.0, 0.0))
    xp = ExperimentalParams(num_gata6=0, dox_step=99)
    eng = ShardedHipscEngine(gen, xp, mesh=make_mesh(8))
    eng.cfg = dataclasses.replace(eng.cfg, capacity=128)
    state = eng.init_state(seed=5)
    state = state._replace(arrays={
        **state.arrays,
        "div_counters": jnp.full((128,), eng.bio.pluri_div_thresh, jnp.int32),
        "death_counters": jnp.zeros((128,), jnp.int32),
    })
    state = shard_state(state, eng.mesh)
    state, info = eng.safe_step(state)
    assert int(info.num_added) == 120
    assert eng.cfg.capacity >= 256
