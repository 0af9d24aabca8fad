"""Config-enabled subsystems end-to-end: morphogen diffusion (with gradient
CSV outputs and cell coupling), the reference's disabled biology methods, and
a distributional golden-run check (SURVEY.md §4c)."""

import os

import numpy as np
import yaml

from hipsc_abm.engine import HipscEngine
from hipsc_abm.models.params import (
    BiologyParams,
    DiffusionParams,
    ExperimentalParams,
    GeneralParams,
)


def test_engine_diffusion_and_release():
    gen = GeneralParams(num_to_start=100, end_step=3, size=(300.0, 300.0, 0.0))
    xp = ExperimentalParams(num_gata6=0, dox_step=99)
    diff = DiffusionParams(spat_res=10.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=5.0, degradation=0.05,
                           release_amount=0.1)
    eng = HipscEngine(gen, xp, diff=diff, enable_diffusion=True)
    state = eng.init_state(seed=2)
    assert "fgf4_values" in state.gradients
    assert state.gradients["fgf4_values"].shape == (31, 31)
    total0 = float(state.gradients["fgf4_values"].sum())
    for _ in range(3):
        state, _ = eng.safe_step(state)
    grid = np.asarray(state.gradients["fgf4_values"])
    assert np.isfinite(grid).all() and (grid >= 0).all()
    assert grid.sum() > total0  # NANOG-high cells secreted morphogen


def test_engine_optional_biology_phases():
    gen = GeneralParams(num_to_start=150, end_step=3, size=(250.0, 250.0, 0.0))
    xp = ExperimentalParams(num_gata6=20, dox_step=1)
    bio = BiologyParams()
    eng = HipscEngine(gen, xp, bio, enable_growth=True, enable_stochastic=True,
                      enable_diff_surround=True)
    state = eng.init_state(seed=6)
    # shrink some radii so growth has something to do
    state = state._replace(arrays={
        **state.arrays,
        "radii": state.arrays["radii"] * 0.8,
    })
    r0 = np.asarray(state.arrays["radii"]).copy()
    for _ in range(2):
        state, info = eng.safe_step(state)
    alive = np.asarray(state.alive)
    r1 = np.asarray(state.arrays["radii"])
    assert (r1[alive] >= r0[alive] - 1e-5).any()
    assert int(info.num_agents) > 0


def test_cell_simulation_diffusion_outputs(tmp_path, monkeypatch):
    tdir = tmp_path / "templates"
    tdir.mkdir()
    (tdir / "general.yaml").write_text(yaml.dump({
        "num_to_start": 60, "cuda": False, "end_step": 2,
        "size": [200, 200, 0], "output_values": False, "output_images": False,
        "record_initial_step": False, "image_quality": 100, "video_quality": 80,
        "fps": 5, "seed": 0,
    }))
    (tdir / "experimental.yaml").write_text(yaml.dump({
        "num_gata6": 6, "output_tda": False, "output_gradients": True,
        "group": 0, "dox_step": 1, "guye_move": True, "lonely_thresh": 2,
        "color_mode": True,
        "enable_diffusion": True, "spat_res": 10.0, "diffuse_dt": 6.0,
        "diffuse_const": 2.0, "max_concentration": 2.0, "degradation": 0.1,
        "release_amount": 0.05, "uptake_amount": 0.001, "field_coupling": True,
    }))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()

    from hipsc_abm.models.hipsc import CellSimulation

    sim = CellSimulation.start(str(out) + os.sep, argv=["-n", "dif", "-m", "0"])
    assert sim.enable_diffusion
    # the field_coupling extension key must reach the engine from the YAML
    # surface (gradient -> pathway uptake coupling, engine.py cell_pathway)
    assert sim.diffusion_params.field_coupling
    assert sim.engine.diff.field_coupling
    assert sim.engine.diff.uptake_amount == 0.001
    for step in (1, 2):
        path = out / "dif" / "dif_gradients" / "fgf4_values" / f"dif_fgf4_values_{step}.csv"
        assert path.is_file(), path
    grid = np.loadtxt(out / "dif" / "dif_gradients" / "fgf4_values" / "dif_fgf4_values_2.csv",
                      delimiter=",")
    assert grid.shape == (21, 21) and np.isfinite(grid).all()


def test_golden_run_distributional():
    """Seeded medium run: colony-level behavior matches the model's known
    dynamics — population grows (divisions dominate), differentiation begins
    only after dox induction, forces keep the colony inside the box."""
    gen = GeneralParams(num_to_start=400, end_step=12, size=(600.0, 600.0, 0.0))
    xp = ExperimentalParams(num_gata6=40, dox_step=6)
    eng = HipscEngine(gen, xp)
    state = eng.init_state(seed=13)

    n_diff_before_dox = None
    for step in range(1, 13):
        state, info = eng.safe_step(state)
        alive = np.asarray(state.alive)
        states = np.asarray(state.arrays["states"])[alive]
        if step == 5:
            n_diff_before_dox = (states == 1).sum()
    n = int(info.num_agents)
    assert n > 440  # net growth from 440 start
    # before dox, differentiation requires GATA6>NANOG which only the seeded
    # GATA6_high cells have; counters start < 36 so few/no flips before dox+
    assert n_diff_before_dox < 60
    states = np.asarray(state.arrays["states"])[np.asarray(state.alive)]
    locs = np.asarray(state.arrays["locations"])[np.asarray(state.alive)]
    assert (locs >= 0).all() and (locs[:, :2] <= 600.0).all()
    # GATA6-high seeded cells progress toward differentiation after dox
    assert (states == 1).sum() >= n_diff_before_dox


def test_three_d_cell_simulation(tmp_path, monkeypatch):
    """Full model class in a 3D box (engine auto-selects the XLA path)."""
    tdir = tmp_path / "templates"
    tdir.mkdir()
    (tdir / "general.yaml").write_text(yaml.dump({
        "num_to_start": 50, "cuda": False, "end_step": 2,
        "size": [150, 150, 150], "output_values": True, "output_images": True,
        "record_initial_step": False, "image_quality": 80, "video_quality": 60,
        "fps": 5, "seed": 0,
    }))
    (tdir / "experimental.yaml").write_text(yaml.dump({
        "num_gata6": 5, "output_tda": True, "output_gradients": False,
        "group": 0, "dox_step": 1, "guye_move": True, "lonely_thresh": 2,
        "color_mode": False,  # exercise the FDS color palette too
    }))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()

    from hipsc_abm.models.hipsc import CellSimulation

    sim = CellSimulation.start(str(out) + os.sep, argv=["-n", "d3", "-m", "0"])
    assert not sim.engine.cfg.two_d  # 3D box -> 9-run stencils
    locs = np.asarray(sim.locations)
    assert (locs[:, 2] >= 0).all() and (locs[:, 2] <= 150).all()
    assert np.ptp(locs[:, 2]) > 0  # motion uses z
    assert os.path.isfile(out / "d3" / "d3_images" / "d3_image_2.png")
