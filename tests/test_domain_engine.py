"""Domain-decomposed full step: equivalence with the single-chip engine on
the virtual 8-device CPU mesh, agent migration, and probe-driven growth.

The decomposition contract (see ``parallel/domain_engine.py``): identical
windows + identical id-keyed randomness => own-row dynamics bit-equal to
``HipscEngine``. Agents are compared BY ID — slot layouts differ by design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hipsc_abm.engine import HipscEngine
from hipsc_abm.models.params import ExperimentalParams, GeneralParams
from hipsc_abm.parallel.domain_engine import DomainHipscEngine

requires_multi = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device CPU mesh"
)


def by_id(state, capacity=None):
    """Extract {field: value} keyed by agent id from a CellState-like tuple."""
    alive = np.asarray(state.alive)
    ids = np.asarray(state.arrays["ids"])[alive]
    out = {"ids": ids}
    for k, v in state.arrays.items():
        if k == "ids":
            continue
        out[k] = np.asarray(v)[alive]
    order = np.argsort(ids)
    return {k: v[order] for k, v in out.items()}


def bond_sets(state):
    alive = np.asarray(state.alive)
    ids = np.asarray(state.arrays["ids"])[alive]
    partners = np.asarray(state.bonds.partners)[alive]
    mask = np.asarray(state.bonds.mask)[alive]
    return {
        int(i): frozenset(int(p) for p, m in zip(ps, ms) if m)
        for i, ps, ms in zip(ids, partners, mask)
    }


def make_engines(n=1200, gata6=120, box=1600.0, steps_dox=2, **dom_kwargs):
    gen = GeneralParams(num_to_start=n, end_step=8, size=(box, box, 0.0))
    xp = ExperimentalParams(num_gata6=gata6, dox_step=steps_dox)
    dom = DomainHipscEngine(gen, xp, **dom_kwargs)
    single = HipscEngine(gen, xp, cfg=dom.cfg.base)
    return dom, single


@requires_multi
def test_domain_step_runs():
    dom, _ = make_engines(n=800, gata6=80)
    state = dom.init_state(seed=3)
    n0 = int(jnp.sum(state.alive))
    state, info = dom.safe_step(state)
    assert int(info.num_agents) > 0
    assert int(info.num_agents) == n0 + int(info.num_added) - int(info.num_removed)
    # residency invariant: every own agent's bin column is inside its stripe
    cfg = dom.cfg
    cell = cfg.base.nbr_spec.cell_size
    locs = np.asarray(state.arrays["locations"])
    alive = np.asarray(state.alive)
    bounds = cfg.col_bounds
    for s in range(cfg.n_stripes):
        col = np.floor(locs[s, alive[s], 0] / cell).astype(int) + 1
        assert ((col >= bounds[s]) & (col < bounds[s + 1])).all(), f"stripe {s}"


@requires_multi
def test_domain_matches_single_engine_multistep():
    """Bit-for-ints, exactly-for-floats over a multi-step colony run with
    division + death + fate dynamics."""
    dom, single = make_engines()
    dstate = dom.init_state(seed=11)
    # byte-identical initial colony, flat layout
    sstate = single.init_state(seed=11)
    single.cfg = dom.cfg.base  # adopt the identical data-derived run caps

    for step in range(5):
        dstate, dinfo = dom.safe_step(dstate)
        sstate, sinfo = single.safe_step(sstate)
        assert int(dinfo.num_added) == int(sinfo.num_added), f"step {step}"
        assert int(dinfo.num_removed) == int(sinfo.num_removed), f"step {step}"

    a = by_id(dom.to_cell_state(dstate))
    b = by_id(sstate)
    assert a["ids"].shape == b["ids"].shape
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in ("GATA6", "NANOG", "states", "FGF4", "FGFR", "ERK",
              "death_counters", "diff_counters", "div_counters", "fds_counters"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # floats: identical windows + identical reduction shapes => bit-equal
    np.testing.assert_array_equal(a["locations"], b["locations"])
    np.testing.assert_array_equal(a["radii"], b["radii"])
    assert bond_sets(dom.to_cell_state(dstate)) == bond_sets(sstate)


@requires_multi
def test_domain_migration_rehomes_agents():
    """Agents that cross a stripe boundary are re-homed; the population is
    conserved and stays resident."""
    dom, single = make_engines(n=1000, gata6=100, box=1200.0)
    dstate = dom.init_state(seed=7)
    ids0 = set(np.asarray(dom.to_cell_state(dstate).arrays["ids"])[
        np.asarray(dom.to_cell_state(dstate).alive)
    ].tolist())
    migrated = 0
    cfg = dom.cfg
    cell = cfg.base.nbr_spec.cell_size
    bounds = cfg.col_bounds
    # remember initial stripe of each id
    def stripes_of(state):
        locs = np.asarray(state.arrays["locations"])
        alive = np.asarray(state.alive)
        res = {}
        for s in range(cfg.n_stripes):
            for i in np.asarray(state.arrays["ids"])[s][alive[s]]:
                res[int(i)] = s
        return res

    before = stripes_of(dstate)
    for _ in range(6):
        dstate, info = dom.safe_step(dstate)
        migrated = max(migrated, int(info.mig_out_max))
    after = stripes_of(dstate)
    moved = sum(1 for i in after if i in before and after[i] != before[i])
    assert moved > 0 or migrated > 0, "expected at least one migration in 6 steps"
    # residency invariant after migration
    locs = np.asarray(dstate.arrays["locations"])
    alive = np.asarray(dstate.alive)
    for s in range(cfg.n_stripes):
        col = np.floor(locs[s, alive[s], 0] / cell).astype(int) + 1
        assert ((col >= bounds[s]) & (col < bounds[s + 1])).all()


@requires_multi
def test_domain_probe_growth():
    """Undersized halo/migration caps are grown by safe_step, not silently
    truncated (the reference's adaptive doubling, simulation.py:217-221)."""
    dom, _ = make_engines(n=900, gata6=0, halo_cap=8, mig_cap=8)
    state = dom.init_state(seed=2)
    state, info = dom.safe_step(state)
    assert dom.cfg.halo_cap > 8
    assert int(info.bio_band_max) <= dom.cfg.halo_cap
    assert int(info.num_agents) > 0


@requires_multi
def test_domain_collectives_are_boundary_sized():
    """Compiled HLO moves O(boundary), not O(colony): every collective
    operand is bounded by the halo/migration caps, and the step's total
    collective bytes do NOT grow when the per-stripe population does."""
    import re

    def collective_bytes(dom, state):
        cfg = dom._cfg_for_state(state)
        sci, scf = dom._stripe_consts(cfg)
        lowered = dom._step_fn(cfg).lower(
            state.arrays, state.alive, state.bonds.partners, state.bonds.mask,
            state.gradients, state.key, state.step, state.next_id, sci, scf,
        )
        hlo = lowered.compile().as_text()
        band_bound = (cfg.halo_cap + cfg.mig_cap) * 64 * 4
        total = 0
        for m in re.finditer(
            r"= \w+\[([\d,]*)\][^=\n]*?"
            r"(collective-permute|all-gather|all-reduce)\(", hlo
        ):
            dims = [int(d) for d in m.group(1).split(",") if d]
            b = 4 * int(np.prod(dims)) if dims else 4
            assert b <= band_bound, f"oversized collective: {m.group(0)[:120]}"
            total += b
        assert total > 0, "expected explicit collectives in the HLO"
        return total

    dom, _ = make_engines(n=1200, gata6=120)
    state = dom.init_state(seed=1)
    small = collective_bytes(dom, state)

    dom2, _ = make_engines(n=1200, gata6=120, per_stripe=4 * dom.cfg.per_stripe)
    state2 = dom2.init_state(seed=1)
    big = collective_bytes(dom2, state2)
    # 4x the slots per stripe, identical communication volume
    assert big == small, (small, big)


@requires_multi
@pytest.mark.slow
def test_domain_diffusion_and_optional_phases_match_single():
    """Domain engine with morphogen diffusion (psum'd deposits) and the
    config-enabled optional phases agrees with the single-chip engine."""
    from hipsc_abm.models.params import DiffusionParams

    gen = GeneralParams(num_to_start=700, end_step=8, size=(1400.0, 1400.0, 0.0))
    xp = ExperimentalParams(num_gata6=70, dox_step=1)
    diff = DiffusionParams(spat_res=25.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1,
                           release_amount=0.02)
    flags = dict(enable_diffusion=True, enable_growth=True,
                 enable_stochastic=True, enable_diff_surround=True)
    dom = DomainHipscEngine(gen, xp, diff=diff, **flags)
    single = HipscEngine(gen, xp, diff=diff, cfg=dom.cfg.base)

    dstate = dom.init_state(seed=23)
    sstate = single.init_state(seed=23)
    single.cfg = dom.cfg.base

    for _ in range(3):
        dstate, _ = dom.safe_step(dstate)
        sstate, _ = single.safe_step(sstate)

    a = by_id(dom.to_cell_state(dstate))
    b = by_id(sstate)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in ("GATA6", "NANOG", "states", "div_counters"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["locations"], b["locations"])
    np.testing.assert_array_equal(a["radii"], b["radii"])  # growth active
    # gradients: deposit scatter order differs (per-stripe partials psum'd),
    # so compare to accumulation tolerance
    ga = np.asarray(dstate.gradients["fgf4_values"])
    gb = np.asarray(sstate.gradients["fgf4_values"])
    np.testing.assert_allclose(ga, gb, atol=1e-5)
    assert ga.max() > 0  # release actually happened


@requires_multi
@pytest.mark.slow
def test_domain_field_coupling_and_uptake_match_single():
    """Gradient->fate coupling (field-sampled perceived FGF4) and per-cell
    uptake agree between the domain engine and the single-chip engine: the
    lattice is replicated, locations are global, and the pathway noise is
    id-keyed, so the nearest-gridpoint sample is identical on every stripe."""
    from hipsc_abm.models.params import DiffusionParams

    gen = GeneralParams(num_to_start=700, end_step=8, size=(1400.0, 1400.0, 0.0))
    xp = ExperimentalParams(num_gata6=70, dox_step=1)
    diff = DiffusionParams(spat_res=25.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.05,
                           release_amount=0.02, uptake_amount=0.004,
                           field_coupling=True)
    dom = DomainHipscEngine(gen, xp, diff=diff, enable_diffusion=True)
    single = HipscEngine(gen, xp, diff=diff, cfg=dom.cfg.base)

    dstate = dom.init_state(seed=29)
    sstate = single.init_state(seed=29)
    single.cfg = dom.cfg.base

    for _ in range(3):
        dstate, _ = dom.safe_step(dstate)
        sstate, _ = single.safe_step(sstate)

    a = by_id(dom.to_cell_state(dstate))
    b = by_id(sstate)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["locations"], b["locations"])
    ga = np.asarray(dstate.gradients["fgf4_values"])
    gb = np.asarray(sstate.gradients["fgf4_values"])
    np.testing.assert_allclose(ga, gb, atol=1e-5)
    assert ga.max() > 0


@requires_multi
def test_domain_checkpoint_resume_bit_exact(tmp_path):
    """Mode-1 contract for the pod-scale engine (reference
    ``simulation.py:525-536``): interrupt -> checkpoint -> restore in a fresh
    driver -> continue == uninterrupted run, bit-exact by agent id, even
    though the re-partition may land agents in different slots."""
    dom, _ = make_engines(n=900, gata6=90, box=1500.0)
    state = dom.init_state(seed=11)
    for _ in range(3):
        state, _ = dom.safe_step(state)

    path = str(tmp_path / "dom_ckpt.npz")
    dom.save_checkpoint(path, state)

    # uninterrupted continuation
    for _ in range(3):
        state, _ = dom.safe_step(state)

    # fresh driver (default config differs until load adopts the saved one)
    gen = GeneralParams(num_to_start=900, end_step=8, size=(1500.0, 1500.0, 0.0))
    xp = ExperimentalParams(num_gata6=90, dox_step=2)
    dom2 = DomainHipscEngine(gen, xp)
    restored = dom2.load_checkpoint(path)
    assert dom2.cfg == dom.cfg
    for _ in range(3):
        restored, _ = dom2.safe_step(restored)

    a = by_id(dom.to_cell_state(state))
    b = by_id(dom2.to_cell_state(restored))
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bond_sets(dom.to_cell_state(state)) == bond_sets(
        dom2.to_cell_state(restored)
    )


@requires_multi
def test_domain_soak_20_steps_with_growth_events():
    """Long soak: 20 steps at colony density with
    deliberately undersized halo/migration/drift capacities, so the run must
    pass through several Verlet rebuilds, per-step migrations, and at least
    one probe-driven growth of halo_cap / mig_cap / drift_allowance — and
    still finish bit-exact against the single-chip engine."""
    gen = GeneralParams(num_to_start=1000, end_step=24, size=(1500.0, 1500.0, 0.0))
    xp = ExperimentalParams(num_gata6=100, dox_step=2)
    dom = DomainHipscEngine(
        gen, xp, halo_cap=64, mig_cap=8, drift_allowance=4.0,
    )
    single = HipscEngine(gen, xp, cfg=dom.cfg.base)

    dstate = dom.init_state(seed=5)
    sstate = single.init_state(seed=5)
    single.cfg = dom.cfg.base

    cfg0 = dom.cfg
    migrations = 0
    for _ in range(20):
        dstate, dinfo = dom.safe_step(dstate)
        sstate, _ = single.safe_step(sstate)
        migrations += int(dinfo.mig_out_max)

    assert migrations > 0, "soak never migrated an agent"
    grew = (
        dom.cfg.halo_cap > cfg0.halo_cap
        or dom.cfg.mig_cap > cfg0.mig_cap
        or dom.cfg.drift_allowance > cfg0.drift_allowance
        or dom.cfg.per_stripe > cfg0.per_stripe
    )
    assert grew, "undersized capacities never grew — soak too gentle"

    a = by_id(dom.to_cell_state(dstate))
    b = by_id(sstate)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bond_sets(dom.to_cell_state(dstate)) == bond_sets(sstate)


@requires_multi
def test_domain_mig_too_far_raises():
    """An agent teleported across an entire stripe cannot be delivered by a
    one-hop ring shift; safe_step must fail loudly (domain_engine mig_too_far
    probe), not silently drop the agent."""
    dom, _ = make_engines(n=800, gata6=0)
    state = dom.init_state(seed=3)
    # move one alive agent of stripe 0 into stripe 2+ territory
    locs = np.asarray(state.arrays["locations"]).copy()
    alive = np.asarray(state.alive)
    s0_rows = np.where(alive[0])[0]
    locs[0, s0_rows[0], 0] = 0.9 * 1600.0  # far right of the box
    state = state._replace(
        arrays={**state.arrays, "locations": jnp.asarray(locs)}
    )
    with pytest.raises(RuntimeError, match="crossed an entire stripe"):
        dom.safe_step(state)


@requires_multi
def test_domain_matches_single_engine_3d():
    """3D domain decomposition: x-stripes of y-z
    slabs, 9-run stencils per shard. Multi-step colony run with division and
    death must stay bit-exact against the single-chip engine, and migration
    must occur across slab boundaries."""
    gen = GeneralParams(num_to_start=900, end_step=8, size=(900.0, 300.0, 300.0))
    xp = ExperimentalParams(num_gata6=90, dox_step=2)
    dom = DomainHipscEngine(gen, xp, n_stripes=4)
    single = HipscEngine(gen, xp, cfg=dom.cfg.base)

    dstate = dom.init_state(seed=17)
    sstate = single.init_state(seed=17)
    single.cfg = dom.cfg.base

    migrations = 0
    for _ in range(4):
        dstate, dinfo = dom.safe_step(dstate)
        sstate, _ = single.safe_step(sstate)
        migrations += int(dinfo.mig_out_max)

    a = by_id(dom.to_cell_state(dstate))
    b = by_id(sstate)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bond_sets(dom.to_cell_state(dstate)) == bond_sets(sstate)
    assert migrations > 0


@requires_multi
def test_domain_run_steps_matches_safe_step_sequence():
    """DomainHipscEngine.run_steps(state, k) == k safe_steps, bit-exact —
    the scan body IS the sharded step; only the host boundary moves."""
    dom_a, _ = make_engines(n=800, gata6=80)
    dom_b, _ = make_engines(n=800, gata6=80)

    sa = dom_a.init_state(seed=5)
    sb = dom_b.init_state(seed=5)
    k = 4
    for _ in range(k):
        sa, info_a = dom_a.safe_step(sa)
    sb, infos = dom_b.run_steps(sb, k)

    assert np.asarray(infos.num_agents).shape == (k,)
    assert int(infos.num_agents[-1]) == int(info_a.num_agents)

    a = by_id(dom_a.to_cell_state(sa))
    b = by_id(dom_b.to_cell_state(sb))
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for key in ("GATA6", "NANOG", "states", "div_counters", "death_counters"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_array_equal(a["locations"], b["locations"])
    assert bond_sets(dom_a.to_cell_state(sa)) == bond_sets(
        dom_b.to_cell_state(sb))
