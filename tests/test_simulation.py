"""Framework layer: registration API, AgentGraph, generic get_neighbors,
output file formats."""

import csv
import os

import numpy as np
import pytest
import yaml

from hipsc_abm.simulation import AgentGraph, Simulation
from hipsc_abm.utils import io as io_utils


@pytest.fixture
def sim_env(tmp_path, monkeypatch):
    """Minimal templates + cwd so Simulation() constructs standalone."""
    tdir = tmp_path / "templates"
    tdir.mkdir()
    general = {
        "num_to_start": 40, "cuda": False, "end_step": 2,
        "size": [100, 100, 0], "output_values": True, "output_images": True,
        "record_initial_step": True, "image_quality": 120, "video_quality": 100,
        "fps": 5, "seed": 0,
    }
    (tdir / "general.yaml").write_text(yaml.dump(general))
    experimental = {
        "num_gata6": 4, "output_tda": True, "output_gradients": False,
        "group": 0, "dox_step": 1, "guye_move": True, "lonely_thresh": 2,
        "color_mode": True,
    }
    (tdir / "experimental.yaml").write_text(yaml.dump(experimental))
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.chdir(tmp_path)
    return str(out) + os.sep


# ---------------------------------------------------------------------------
# AgentGraph
# ---------------------------------------------------------------------------


def test_agent_graph_basic_ops():
    g = AgentGraph(5)
    g.add_edges([[0, 1], [1, 2], [3, 4]])
    assert g.num_neighbors(1) == 2
    assert sorted(g.neighbors(1)) == [0, 2]
    assert g.ecount() == 3 and g.vcount() == 5

    g.add_edges([[0, 1]])  # duplicate
    g.simplify()
    assert g.ecount() == 3

    g.delete_vertices([2])  # old 3,4 -> 2,3
    assert g.vcount() == 4
    assert sorted(map(tuple, g.get_edgelist().tolist())) == [(0, 1), (2, 3)]

    g.add_vertex()
    assert g.vcount() == 5
    g.delete_edges(None)
    assert g.ecount() == 0


# ---------------------------------------------------------------------------
# registration API
# ---------------------------------------------------------------------------


def test_agent_array_registration(sim_env):
    sim = Simulation("t", sim_env)
    sim.add_agents(10)
    sim.add_agents(5, agent_type="special")
    assert sim.number_agents == 15

    sim.agent_array("scores", func=lambda: 2.5)
    sim.agent_array("vecs", vector=3)
    sim.agent_array("labels", dtype=int)
    sim.agent_array("labels", agent_type="special", func=lambda: 7)
    assert sim.scores.shape == (15,) and (sim.scores == 2.5).all()
    assert sim.vecs.shape == (15, 3)
    assert (sim.labels[:10] == 0).all() and (sim.labels[10:] == 7).all()

    with pytest.raises(Exception):
        sim.agent_array("bad", override=np.zeros((3, 2)))

    sim.agent_graph("g")
    assert "g" in sim.graph_names and sim.g.vcount() == 15


def test_get_neighbors_matches_bruteforce(sim_env, rng):
    sim = Simulation("t", sim_env)
    sim.add_agents(60)
    locs = rng.random((60, 3)) * np.array([100.0, 100.0, 0.0])
    sim.agent_array("locations", override=locs)
    sim.agent_graph("g")

    sim.get_neighbors("g", 12.0)
    edges = {tuple(e) for e in sim.g.get_edgelist().tolist()}

    want = set()
    for i in range(60):
        for j in range(i + 1, 60):
            if np.linalg.norm(locs[i] - locs[j]) <= 12.0:
                want.add((i, j))
    assert edges == want

    # clear=False keeps old edges and dedups
    sim.get_neighbors("g", 12.0, clear=False)
    assert {tuple(e) for e in sim.g.get_edgelist().tolist()} == want


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------


def test_values_csv_format(tmp_path):
    arrays = {
        "locations": np.arange(6, dtype=float).reshape(2, 3),
        "states": np.array([0, 1]),
    }
    path = tmp_path / "v.csv"
    io_utils.write_values_csv(str(path), arrays, ["locations", "states"])
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["locations[0]", "locations[1]", "locations[2]", "states"]
    assert [float(x) for x in rows[1]] == [0.0, 1.0, 2.0, 0.0]
    assert len(rows) == 3


def test_hipsc_cell_colors_modes():
    states = np.array([1, 0, 0, 0, 0])
    gata6 = np.array([0, 1, 0, 1, 0])
    nanog = np.array([1, 0, 0, 1, 1])
    # color_mode=True: red / white (G>=N, G!=0) / green
    c = io_utils.hipsc_cell_colors(states, gata6, nanog, 2, True)
    assert tuple(c[0]) == (0, 0, 230)  # differentiated red
    assert tuple(c[1]) == (255, 255, 255)  # gata6 high white
    assert tuple(c[2]) == (32, 252, 22)  # both zero -> green (G==0 excluded)
    assert tuple(c[3]) == (255, 255, 255)  # equal nonzero -> white
    assert tuple(c[4]) == (32, 252, 22)
    # color_mode=False: FDS coloring with yellow/blue
    c = io_utils.hipsc_cell_colors(states, gata6, nanog, 2, False)
    assert tuple(c[0]) == (0, 0, 230)
    assert tuple(c[1]) == (255, 255, 255)
    assert tuple(c[2]) == (255, 50, 50)  # both zero -> blue
    assert tuple(c[3]) == (30, 255, 255)  # both max -> yellow
    assert tuple(c[4]) == (32, 252, 22)  # N>G -> green


def test_render_step_image_shape_and_flip():
    locs = np.array([[10.0, 5.0, 0.0]])
    radii = np.array([3.0])
    colors = np.array([[0, 0, 230]], dtype=np.uint8)
    img = io_utils.render_step_image(locs, radii, colors, (100.0, 50.0, 0.0), 200)
    assert img.shape == (100, 200, 3)
    # origin-bottom flip: the cell at y=5 um appears near the image bottom
    ys, xs = np.nonzero(img[:, :, 2] > 200)
    assert ys.mean() > 80  # bottom of a 100-row image
    assert abs(xs.mean() - 20) < 3


def test_data_csv_appends_and_headers(tmp_path):
    path = str(tmp_path / "d.csv")
    io_utils.append_data_csv(path, 1, 10, 0.5, 100.0, {"step_fused": 0.4})
    io_utils.append_data_csv(path, 2, 12, 0.6, 101.0, {"step_fused": 0.5})
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Step Number", "Number Cells", "Step Time", "Memory (MB)", "step_fused"]
    assert len(rows) == 3 and rows[2][0] == "2"


def test_natural_step_sort():
    files = ["x_image_2.png", "x_image_20.png", "x_image_3.png", "x_image_1.png"]
    assert io_utils.natural_step_sort(files) == [
        "x_image_1.png", "x_image_2.png", "x_image_3.png", "x_image_20.png",
    ]


def test_stamp_rasterizer_matches_loop_oracle():
    """The vectorized circle stamper reproduces the per-agent overdraw
    rasterizer byte-for-byte (uniform radii, the model default)."""
    from hipsc_abm.utils import io as io_utils

    rng = np.random.default_rng(9)
    n = 300
    locs = rng.random((n, 3)) * np.array([200.0, 200.0, 0.0])
    radii = np.full(n, 5.0)
    colors = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    kw = dict(size=(200.0, 200.0, 0.0), image_quality=400)
    img_stamp = io_utils.render_step_image(locs, radii, colors, method="stamp", **kw)
    img_loop = io_utils.render_step_image(locs, radii, colors, method="loop", **kw)
    np.testing.assert_array_equal(img_stamp, img_loop)
    if io_utils.HAVE_CV2:
        # cv2's ellipse edge rasterization differs by boundary pixels only
        img_cv2 = io_utils.render_step_image(locs, radii, colors, method="cv2", **kw)
        frac_diff = np.mean(np.any(img_stamp != img_cv2, axis=-1))
        assert frac_diff < 0.05, frac_diff


def test_async_output_pipeline_flush():
    """Submitted output tasks complete at flush; worker errors surface."""
    from hipsc_abm.utils import io as io_utils

    hits = []
    io_utils.submit_output(hits.append, 1)
    io_utils.submit_output(hits.append, 2)
    io_utils.flush_outputs()
    assert hits == [1, 2]

    def boom():
        raise RuntimeError("worker failure")

    io_utils.submit_output(boom)
    with pytest.raises(RuntimeError, match="worker failure"):
        io_utils.flush_outputs()
