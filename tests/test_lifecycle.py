"""End-to-end lifecycle: mode 0 run with full outputs, mode 1 continuation,
mode 2 video, mode 3 zip (reference ``simulation.py:496-549``)."""

import os

import numpy as np
import pytest
import yaml


@pytest.fixture
def model_env(tmp_path, monkeypatch):
    tdir = tmp_path / "templates"
    tdir.mkdir()
    (tdir / "general.yaml").write_text(yaml.dump({
        "num_to_start": 80, "cuda": False, "end_step": 2,
        "size": [200, 200, 0], "output_values": True, "output_images": True,
        "record_initial_step": True, "image_quality": 100, "video_quality": 80,
        "fps": 5, "seed": 0,
    }))
    (tdir / "experimental.yaml").write_text(yaml.dump({
        "num_gata6": 8, "output_tda": True, "output_gradients": False,
        "group": 0, "dox_step": 1, "guye_move": True, "lonely_thresh": 2,
        "color_mode": True,
    }))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "outputs"
    out.mkdir()
    return str(out) + os.sep


def test_full_lifecycle(model_env):
    from hipsc_abm.models.hipsc import CellSimulation

    # --- mode 0: new simulation ---
    sim = CellSimulation.start(model_env, argv=["-n", "lc", "-m", "0"])
    base = os.path.join(model_env, "lc")
    assert sim.number_agents > 0
    for step in (0, 1, 2):
        assert os.path.isfile(os.path.join(base, "lc_values", f"lc_values_{step}.csv"))
        assert os.path.isfile(os.path.join(base, "lc_images", f"lc_image_{step}.png"))
    for group in ("red", "green", "all"):
        assert os.path.isfile(os.path.join(base, "lc_tda", group, f"lc_tda_{group}_2.csv"))
    assert os.path.isfile(os.path.join(base, "lc_temp.pkl"))
    assert os.path.isfile(os.path.join(base, "lc_state.npz"))
    assert os.path.isfile(os.path.join(base, "lc_data.csv"))
    assert os.path.isfile(os.path.join(base, "lc_video.mp4"))

    # values CSV has the nine reference columns
    with open(os.path.join(base, "lc_values", "lc_values_2.csv")) as f:
        header = f.readline().strip().split(",")
    assert header[:3] == ["locations[0]", "locations[1]", "locations[2]"]
    assert "GATA6" in header and "div_counters" in header

    n_after_2 = sim.number_agents

    # --- mode 1: continuation to step 4 ---
    sim2 = CellSimulation.start(model_env, argv=["-n", "lc", "-m", "1", "-fs", "4"])
    assert sim2.current_step == 4
    assert os.path.isfile(os.path.join(base, "lc_values", "lc_values_4.csv"))
    assert sim2.number_agents > 0

    # --- mode 2: images -> video (re-run) ---
    CellSimulation.start(model_env, argv=["-n", "lc", "-m", "2"])
    assert os.path.isfile(os.path.join(base, "lc_video.mp4"))

    # --- mode 3: zip ---
    CellSimulation.start(model_env, argv=["-n", "lc", "-m", "3"])
    assert os.path.isfile(os.path.join(model_env, "lc.zip"))


def test_resume_is_bit_exact(model_env, tmp_path):
    """Interrupted-and-resumed run == uninterrupted run (states identical)."""
    from hipsc_abm.models.hipsc import CellSimulation

    # uninterrupted 4 steps
    import yaml
    gen = yaml.safe_load(open("templates/general.yaml"))
    gen["end_step"] = 4
    open("templates/general.yaml", "w").write(yaml.dump(gen))
    sim_a = CellSimulation.start(model_env, argv=["-n", "a", "-m", "0"])

    # 2 steps, then resume to 4
    gen["end_step"] = 2
    open("templates/general.yaml", "w").write(yaml.dump(gen))
    CellSimulation.start(model_env, argv=["-n", "b", "-m", "0"])
    sim_b = CellSimulation.start(model_env, argv=["-n", "b", "-m", "1", "-fs", "4"])

    np.testing.assert_array_equal(
        np.asarray(sim_a.state.alive), np.asarray(sim_b.state.alive)
    )
    for name in sim_a.agent_array_names:
        np.testing.assert_array_equal(
            np.asarray(sim_a.state.arrays[name]),
            np.asarray(sim_b.state.arrays[name]),
            err_msg=name,
        )
    np.testing.assert_array_equal(np.asarray(sim_a.state.key), np.asarray(sim_b.state.key))


def test_resume_from_npz_without_pickle(model_env):
    """temp_pickle: false drops the reference's per-step pickle (the dominant
    host serialization cost at 500k+); mode 1 then resumes from the bit-exact
    npz state checkpoint and matches the uninterrupted run exactly."""
    from hipsc_abm.models.hipsc import CellSimulation

    gen = yaml.safe_load(open("templates/general.yaml"))
    gen["temp_pickle"] = False
    gen["end_step"] = 4
    open("templates/general.yaml", "w").write(yaml.dump(gen))
    sim_a = CellSimulation.start(model_env, argv=["-n", "np_a", "-m", "0"])

    gen["end_step"] = 2
    open("templates/general.yaml", "w").write(yaml.dump(gen))
    CellSimulation.start(model_env, argv=["-n", "np_b", "-m", "0"])
    base_b = os.path.join(model_env, "np_b")
    assert not os.path.isfile(os.path.join(base_b, "np_b_temp.pkl"))
    assert os.path.isfile(os.path.join(base_b, "np_b_state.npz"))

    sim_b = CellSimulation.start(model_env, argv=["-n", "np_b", "-m", "1", "-fs", "4"])
    np.testing.assert_array_equal(
        np.asarray(sim_a.state.alive), np.asarray(sim_b.state.alive)
    )
    for name in sim_a.agent_array_names:
        np.testing.assert_array_equal(
            np.asarray(sim_a.state.arrays[name]),
            np.asarray(sim_b.state.arrays[name]),
            err_msg=name,
        )
    np.testing.assert_array_equal(
        np.asarray(sim_a.state.key), np.asarray(sim_b.state.key)
    )


def test_output_interval_blocks_match_per_step(tmp_path, monkeypatch):
    """`output_interval: k` (device-resident run_steps blocks between
    outputs) must leave the colony bit-identical to the per-step loop;
    outputs land on block boundaries only."""
    import yaml as _yaml
    from hipsc_abm.models.hipsc import CellSimulation

    def env(sub, interval):
        root = tmp_path / sub
        (root / "templates").mkdir(parents=True)
        gen = {
            "num_to_start": 80, "cuda": False, "end_step": 6,
            "size": [200, 200, 0], "output_values": True,
            "output_images": False, "record_initial_step": True,
            "image_quality": 100, "video_quality": 80, "fps": 5, "seed": 0,
        }
        if interval > 1:
            gen["output_interval"] = interval
        (root / "templates" / "general.yaml").write_text(_yaml.dump(gen))
        (root / "templates" / "experimental.yaml").write_text(_yaml.dump({
            "num_gata6": 8, "output_tda": False, "output_gradients": False,
            "group": 0, "dox_step": 1, "guye_move": True,
            "lonely_thresh": 2, "color_mode": True,
        }))
        out = root / "outputs"
        out.mkdir()
        return root, str(out) + os.sep

    root_a, out_a = env("per_step", 1)
    monkeypatch.chdir(root_a)
    sim_a = CellSimulation.start(out_a, argv=["-n", "a", "-m", "0"])

    root_b, out_b = env("blocked", 3)
    monkeypatch.chdir(root_b)
    sim_b = CellSimulation.start(out_b, argv=["-n", "b", "-m", "0"])

    assert sim_a.number_agents == sim_b.number_agents
    na = sim_a.number_agents
    np.testing.assert_array_equal(
        np.asarray(sim_a.locations[:na]), np.asarray(sim_b.locations[:na]))
    np.testing.assert_array_equal(
        np.asarray(sim_a.NANOG[:na]), np.asarray(sim_b.NANOG[:na]))

    # per-step run wrote every step; the blocked run only block boundaries
    vals_b = os.path.join(out_b, "b", "b_values")
    assert os.path.isfile(os.path.join(vals_b, "b_values_0.csv"))  # initials
    assert os.path.isfile(os.path.join(vals_b, "b_values_3.csv"))
    assert os.path.isfile(os.path.join(vals_b, "b_values_6.csv"))
    assert not os.path.isfile(os.path.join(vals_b, "b_values_2.csv"))

    # the data CSV keeps its schema under blocks (the header is written on
    # file creation, not on the never-output step 1)
    with open(os.path.join(out_b, "b", "b_data.csv")) as f:
        header = f.readline().strip().split(",")
    assert header[:4] == ["Step Number", "Number Cells", "Step Time",
                          "Memory (MB)"]


_BLOCKED_RUN = r"""
import os, sys
for name in ("yaml", "cv2", "PIL", "imageio"):
    sys.modules[name] = None  # import raises ImportError
from hipsc_abm.models.hipsc import CellSimulation
sim = CellSimulation.start(sys.argv[1], argv=["-n", "nb", "-m", "0"])
print("AGENTS", sim.number_agents)
"""


def test_lifecycle_without_optional_packages(tmp_path):
    """The main path needs JAX, numpy and the standard library only: with
    PyYAML, cv2, PIL and imageio unimportable, a run still reads its
    templates, writes PNG frames and CSVs, and skips only the video."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tdir = tmp_path / "templates"
    tdir.mkdir()
    (tdir / "general.yaml").write_text(
        "num_to_start: 60\ncuda: false\nend_step: 2\nsize: [150, 150, 0]\n"
        "output_values: true\noutput_images: true\nrecord_initial_step: true\n"
        "image_quality: 64\nvideo_quality: 32\nfps: 5\nseed: 0\n")
    (tdir / "experimental.yaml").write_text(
        "num_gata6: 6\noutput_tda: true\noutput_gradients: false\ngroup: 0\n"
        "dox_step: 1\nguye_move: true\nlonely_thresh: 2\ncolor_mode: true\n")
    out = tmp_path / "outputs"
    out.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(out) + os.sep],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "AGENTS" in proc.stdout and "no video encoder" in proc.stdout
    base = out / "nb"
    png = (base / "nb_images" / "nb_image_2.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert (base / "nb_values" / "nb_values_2.csv").is_file()
    assert (base / "nb_tda" / "all" / "nb_tda_all_2.csv").is_file()
    assert not (base / "nb_video.mp4").exists()
