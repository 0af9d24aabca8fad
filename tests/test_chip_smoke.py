"""``chip_smoke.py``: its check functions at small sizes on the CPU, the same
functions at the smoke run's sizes on a card (marked ``gpu``), and its
refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def small():
    """A 2,500-cell colony with diffusion after 3 steps: ids pass 2^11."""
    eng = cs.colony_engine(2500, diffusion=True)
    return eng, cs.stepped(eng, 3)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stdout


def test_default_experiment_small(tmp_path):
    out = cs.run_default_experiment(str(tmp_path), overrides={
        "num_to_start": 300, "size": [400, 400, 0], "end_step": 3,
        "dox_step": 1, "image_quality": 200, "video_quality": 100,
    })
    assert out["steps"] == 3 and out["agents_end"] > 0


def test_check_neighbors_small(small):
    eng, state = small
    s = cs._host(state)
    out = cs.check_neighbors(s.arrays["locations"], s.alive, eng.gen.size)
    assert out["pairs"] > 0


def test_check_contact_substep_small(small):
    eng, state = small
    out = cs.check_contact_substep(state, eng)
    assert out["agents"] > 2500


def test_check_dense_vs_windowed_small():
    out = cs.check_dense_vs_windowed(300, warmup=1)
    assert out["agents"] > 0


def test_check_bond_ids_small(small):
    eng, state = small
    out = cs.check_bond_ids(state, eng)
    assert out["max_partner_id"] > 1 << 11


def test_check_ftcs_small(small):
    eng, state = small
    out = cs.check_ftcs(np.asarray(state.gradients["fgf4_values"]), eng)
    assert out["subcycles"] > 1


def test_check_determinism_and_resume_small(small, tmp_path):
    eng, state = small
    cs.check_determinism(eng, 2)
    cs.check_resume(eng, state, str(tmp_path / "ck.npz"))


def test_check_gpu_vs_cpu_small():
    out = cs.check_gpu_vs_cpu(400, warmup=1)
    assert out["agents"] > 0


def test_check_four_cards_small():
    out = cs.check_four_cards(3000, steps=2)
    assert len(out["devices"]) == 4


def test_ftcs_f64_reflects_edges():
    """The float64 reference conserves mass before degradation (reflecting
    boundaries) and smooths a point source."""
    g = np.zeros((9, 9))
    g[4, 4] = 1.0
    out = cs.ftcs_f64(g, [6.0] * 10, 2.0, 100.0, 2.0, 0.0)
    np.testing.assert_allclose(out.sum(), 1.0, rtol=1e-12)
    assert out[4, 4] < 1.0 and out[3, 4] > 0


# --- the same checks at the smoke run's sizes, on a card ------------------


@pytest.fixture(scope="module")
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu)")


@pytest.fixture(scope="module")
def headline(gpu):
    r = cs.bench.time_full_model(cs.HEADLINE_SIZES[0])
    return r["engine"], r["state"]


@pytest.mark.gpu
def test_gpu_neighbors_100k(headline):
    eng, state = headline
    s = cs._host(state)
    cs.check_neighbors(s.arrays["locations"], s.alive, eng.gen.size)


@pytest.mark.gpu
def test_gpu_contact_and_bonds_100k(headline):
    eng, state = headline
    cs.check_contact_substep(state, eng)
    cs.check_bond_ids(state, eng)


@pytest.mark.gpu
def test_gpu_ftcs_and_determinism_100k(headline, tmp_path):
    eng, state = headline
    cs.check_ftcs(np.asarray(state.gradients["fgf4_values"]), eng)
    cs.check_determinism(eng, 3)
    cs.check_resume(eng, state, str(tmp_path / "ck.npz"))


@pytest.mark.gpu
def test_gpu_dense_and_cpu_agreement(gpu):
    cs.check_dense_vs_windowed(cs.DENSE_CELLS)
    cs.check_gpu_vs_cpu(cs.CPU_CELLS)
