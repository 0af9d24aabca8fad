"""Full model lifecycle on the MULTI-CHIP domain engine, driven entirely from
the reference-compatible surface: the ``domain_tiles`` general.yaml extension
key routes ``CellSimulation`` onto ``DomainHipscEngine`` (tile-decomposed
steps, O(boundary) collectives) while every output, checkpoint, and CLI mode
behaves exactly as the single-chip lifecycle. The reference has no
multi-device mode at all — this is the pod-scale extension of its mode-0/1
contract (``simulation.py:496-549``)."""

import os

import jax
import numpy as np
import pytest
import yaml

requires_multi = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device CPU mesh"
)


def write_templates(tmp_path, domain_tiles, end_step=2, name_seed=0):
    tdir = tmp_path / "templates"
    tdir.mkdir(exist_ok=True)
    gen = {
        "num_to_start": 700, "cuda": False, "end_step": end_step,
        "size": [1500, 1500, 0], "output_values": True, "output_images": True,
        "record_initial_step": True, "image_quality": 100, "video_quality": 80,
        "fps": 5, "seed": name_seed,
    }
    if domain_tiles is not None:
        gen["domain_tiles"] = domain_tiles
    (tdir / "general.yaml").write_text(yaml.dump(gen))
    (tdir / "experimental.yaml").write_text(yaml.dump({
        "num_gata6": 70, "output_tda": True, "output_gradients": False,
        "group": 0, "dox_step": 1, "guye_move": True, "lonely_thresh": 2,
        "color_mode": True,
    }))


def by_id(state):
    alive = np.asarray(state.alive)
    ids = np.asarray(state.arrays["ids"])[alive]
    order = np.argsort(ids)
    out = {"ids": ids[order]}
    for k, v in state.arrays.items():
        if k != "ids":
            out[k] = np.asarray(v)[alive][order]
    return out


@requires_multi
@pytest.mark.slow
def test_domain_lifecycle_outputs_and_continuation(tmp_path, monkeypatch):
    from hipsc_abm.models.hipsc import CellSimulation

    write_templates(tmp_path, domain_tiles=[2, 2])
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()
    env = str(out) + os.sep

    sim = CellSimulation.start(env, argv=["-n", "dl", "-m", "0"])
    assert sim._is_domain and sim.engine.cfg.n_ty == 2
    base = os.path.join(env, "dl")
    assert sim.number_agents > 0
    for step in (0, 1, 2):
        assert os.path.isfile(os.path.join(base, "dl_values", f"dl_values_{step}.csv"))
        assert os.path.isfile(os.path.join(base, "dl_images", f"dl_image_{step}.png"))
    assert os.path.isfile(os.path.join(base, "dl_temp.pkl"))
    assert os.path.isfile(os.path.join(base, "dl_state.npz"))
    assert os.path.isfile(os.path.join(base, "dl_video.mp4"))

    # the npz carries the domain config for engine-level resume
    from hipsc_abm.utils.checkpoint import load_state

    _, meta = load_state(os.path.join(base, "dl_state.npz"))
    assert "domain_config" in meta and meta["domain_config"]["n_ty"] == 2

    # mode 1 continuation re-partitions from the pickle and keeps stepping
    sim2 = CellSimulation.start(env, argv=["-n", "dl", "-m", "1", "-fs", "4"])
    assert sim2.current_step == 4
    assert sim2._is_domain
    assert os.path.isfile(os.path.join(base, "dl_values", "dl_values_4.csv"))


@requires_multi
def test_domain_lifecycle_matches_single_chip(tmp_path, monkeypatch):
    """The tile-decomposed lifecycle produces the IDENTICAL colony to the
    single-chip lifecycle — same seed, same steps, bit-equal by agent id."""
    from hipsc_abm.models.hipsc import CellSimulation

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()
    env = str(out) + os.sep

    write_templates(tmp_path, domain_tiles=None, end_step=3)
    sim_s = CellSimulation.start(env, argv=["-n", "sc", "-m", "0"])
    write_templates(tmp_path, domain_tiles=[2, 2], end_step=3)
    sim_d = CellSimulation.start(env, argv=["-n", "dc", "-m", "0"])

    flat_d = sim_d.engine.to_cell_state(sim_d.state)
    a = by_id(sim_s.state)
    b = by_id(flat_d)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sim_s.number_agents == sim_d.number_agents


@requires_multi
def test_domain_lifecycle_npz_resume_without_pickle(tmp_path, monkeypatch):
    """A tile-decomposed production run with temp_pickle: false resumes in
    mode 1 from the npz checkpoint alone: the domain engine is rebuilt from
    the saved domain_config and the state re-partitioned."""
    from hipsc_abm.models.hipsc import CellSimulation

    write_templates(tmp_path, domain_tiles=[2, 2], end_step=2)
    import yaml as _yaml
    gpath = tmp_path / "templates" / "general.yaml"
    gen = _yaml.safe_load(gpath.read_text())
    gen["temp_pickle"] = False
    gpath.write_text(_yaml.dump(gen))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()
    env = str(out) + os.sep

    CellSimulation.start(env, argv=["-n", "dn", "-m", "0"])
    base = os.path.join(env, "dn")
    assert not os.path.isfile(os.path.join(base, "dn_temp.pkl"))
    assert os.path.isfile(os.path.join(base, "dn_state.npz"))

    sim = CellSimulation.start(env, argv=["-n", "dn", "-m", "1", "-fs", "4"])
    assert sim.current_step == 4
    assert sim._is_domain and sim.engine.cfg.n_ty == 2
    assert sim.number_agents > 0
    assert os.path.isfile(os.path.join(base, "dn_values", "dn_values_4.csv"))


@requires_multi
def test_domain_tiles_scalar_means_stripes(tmp_path, monkeypatch):
    """``domain_tiles: 2`` (an int) is 2 x-stripes."""
    from hipsc_abm.models.hipsc import CellSimulation

    write_templates(tmp_path, domain_tiles=2, end_step=1)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()
    sim = CellSimulation.start(str(out) + os.sep, argv=["-n", "ds", "-m", "0"])
    assert sim._is_domain
    assert sim.engine.cfg.n_stripes == 2 and sim.engine.cfg.n_ty == 1
    assert sim.number_agents > 0


@requires_multi
@pytest.mark.slow
def test_elastic_mode1_resume_across_decompositions(tmp_path, monkeypatch):
    """Editing ``domain_tiles`` in general.yaml between a ``temp_pickle:
    false`` run and its mode-1 continuation resumes ELASTICALLY (tiles ->
    stripes, domain -> single chip, single chip -> domain) and every variant
    stays bit-exact vs the uninterrupted run — the lost-pod-host / move-the-
    run recovery path at the CLI surface."""
    import yaml as _yaml

    from hipsc_abm.models.hipsc import CellSimulation

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()
    env = str(out) + os.sep

    def set_general(domain_tiles, end_step):
        write_templates(tmp_path, domain_tiles, end_step=end_step)
        gpath = tmp_path / "templates" / "general.yaml"
        gen = _yaml.safe_load(gpath.read_text())
        gen["temp_pickle"] = False
        gpath.write_text(_yaml.dump(gen))

    # uninterrupted reference to step 4 (domain == single chip is already
    # bit-exact by the equivalence suite, so one reference serves all)
    set_general([2, 2], end_step=4)
    ref_sim = CellSimulation.start(env, argv=["-n", "ref", "-m", "0"])
    ref = by_id(ref_sim.engine.to_cell_state(ref_sim.state))

    cases = [  # (name, tiles at mode 0, tiles at mode 1, resumed checks)
        ("e1", [2, 2], 2, lambda s: s.engine.cfg.n_stripes == 2
         and s.engine.cfg.n_ty == 1),
        ("e2", [2, 2], None, lambda s: not s._is_domain),
        ("e3", None, [2, 2], lambda s: s._is_domain
         and s.engine.cfg.n_ty == 2),
    ]
    for name, tiles0, tiles1, check in cases:
        set_general(tiles0, end_step=2)
        CellSimulation.start(env, argv=["-n", name, "-m", "0"])
        set_general(tiles1, end_step=2)
        sim = CellSimulation.start(env, argv=["-n", name, "-m", "1", "-fs", "4"])
        assert check(sim), name
        assert sim.current_step == 4, name
        final = sim.engine.to_cell_state(sim.state) if sim._is_domain else sim.state
        got = by_id(final)
        np.testing.assert_array_equal(ref["ids"], got["ids"], err_msg=name)
        for k in ref:
            np.testing.assert_array_equal(ref[k], got[k], err_msg=f"{name} {k}")


@requires_multi
@pytest.mark.slow
def test_elastic_chain_multi_hop_bit_exact(tmp_path):
    """A run checkpointed and elastically resumed across FOUR different
    decompositions — (2,2) tiles -> (4,2) tiles -> single chip -> (2,2)
    tiles — is bit-exact against the uninterrupted single-chip run.
    Elasticity composes: any checkpoint resumes anywhere, repeatedly."""
    import dataclasses

    from hipsc_abm.engine import HipscEngine, config_to_meta
    from hipsc_abm.models.params import ExperimentalParams, GeneralParams
    from hipsc_abm.parallel.domain_engine import (
        DomainHipscEngine,
        domain_config_from_meta,
    )
    from hipsc_abm.utils.checkpoint import load_state, save_state

    gen = GeneralParams(num_to_start=900, end_step=12,
                        size=(1500.0, 1500.0, 0.0))
    xp = ExperimentalParams(num_gata6=90, dox_step=2)

    dom0 = DomainHipscEngine(gen, xp, tiles=(2, 2))
    ref = HipscEngine(gen, xp, cfg=dom0.cfg.base)
    ref.cfg = dom0.cfg.base
    rstate = ref.init_state(seed=9)
    for _ in range(12):
        rstate, rinfo = ref.safe_step(rstate)

    d = dom0.init_state(seed=9)
    for _ in range(3):
        d, _ = dom0.safe_step(d)
    dom0.save_checkpoint(str(tmp_path / "ck1"), d)

    dom1 = DomainHipscEngine(gen, xp, tiles=(4, 2))
    d = dom1.load_checkpoint(str(tmp_path / "ck1"), elastic=True)
    for _ in range(3):
        d, _ = dom1.safe_step(d)
    dom1.save_checkpoint(str(tmp_path / "ck2"), d)

    flat, meta = load_state(str(tmp_path / "ck2"))
    cfg = domain_config_from_meta(meta["domain_config"]).base
    single = HipscEngine(gen, xp, cfg=cfg)
    single.cfg = dataclasses.replace(cfg, capacity=int(flat.alive.shape[0]))
    s = flat
    for _ in range(3):
        s, _ = single.safe_step(s)
    save_state(str(tmp_path / "ck3"), s,
               meta={"engine_config": config_to_meta(single.cfg)})

    dom2 = DomainHipscEngine(gen, xp, tiles=(2, 2))
    d = dom2.load_checkpoint(str(tmp_path / "ck3"), elastic=True)
    for _ in range(3):
        d, dinfo = dom2.safe_step(d)

    assert int(rinfo.num_agents) == int(dinfo.num_agents)
    a = by_id(rstate)
    b = by_id(dom2.to_cell_state(d))
    np.testing.assert_array_equal(a["ids"], b["ids"])
    np.testing.assert_array_equal(a["locations"], b["locations"])
    for k in ("GATA6", "NANOG", "states", "div_counters", "death_counters"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@requires_multi
def test_domain_lifecycle_output_interval_blocks(tmp_path, monkeypatch):
    """`output_interval: k` + `domain_tiles`: the multi-chip lifecycle runs
    device-resident blocks (DomainHipscEngine.run_steps) between outputs —
    same colony as per-step, outputs on block boundaries only."""
    from hipsc_abm.models.hipsc import CellSimulation

    write_templates(tmp_path, domain_tiles=[2, 2], end_step=4)
    gen_path = tmp_path / "templates" / "general.yaml"
    gen = yaml.safe_load(gen_path.read_text())
    gen["output_interval"] = 2
    gen["output_images"] = False
    gen_path.write_text(yaml.dump(gen))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()
    env = str(out) + os.sep

    sim = CellSimulation.start(env, argv=["-n", "db", "-m", "0"])
    assert sim._is_domain and sim.number_agents > 0
    vals = os.path.join(env, "db", "db_values")
    assert os.path.isfile(os.path.join(vals, "db_values_0.csv"))  # initials
    assert os.path.isfile(os.path.join(vals, "db_values_2.csv"))
    assert os.path.isfile(os.path.join(vals, "db_values_4.csv"))
    assert not os.path.isfile(os.path.join(vals, "db_values_3.csv"))
