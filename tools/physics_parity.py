"""Deterministic physics parity: our fused engine vs the ACTUAL reference.

Isolates the contact-mechanics pipeline (get_neighbors -> JKR pair law ->
persistent bond graph -> Stokes substep integration, reference
``cell_methods.py:387-439`` + ``cell_backend.py:66-172``) from every
stochastic phase: motility force zeroed, division/death/dox thresholds
pushed out of reach, identical initial positions injected into both sides.
With those knobs the step is a pure function of positions, so the two
implementations must track to f32/f64 accumulation error — any systematic
drift is a physics parity bug (this tool was written to hunt a measured
~1.25x effective-force displacement of the calibration landscape minimum).

Usage:
  python tools/physics_parity.py [n_cells] [steps] [side]      # compare
  python tools/physics_parity.py --reference <npz> n steps side # subprocess
"""

import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)

BIG = 10**6  # counters randomize in [0, thresh); 10^6 steps is out of reach


def reference_side(npz_path: str, n: int, steps: int, side: float) -> None:
    """Runs IN A CLEAN SUBPROCESS (the reference's C++/OpenMP kernels clash
    with an initialized XLA runtime). Drives the reference's own step-phase
    order (cell_simulation.py:85-123) with the stochastic phases disabled
    by instance-attribute override, recording locations after each step."""
    import tempfile

    import numpy as np

    sys.path.insert(0, os.path.join(_HERE, "reference_baseline"))
    from measure_reference import load_reference

    work = tempfile.mkdtemp(prefix="physpar_")
    tdir = os.path.join(work, "templates")
    os.makedirs(tdir)
    with open(os.path.join(tdir, "general.yaml"), "w") as f:
        f.write(
            f"num_to_start: {n}\ncuda: False\nend_step: {steps}\n"
            f"size: [{side}, {side}, 0]\noutput_values: False\n"
            "output_images: False\nrecord_initial_step: False\n"
            "image_quality: 100\nvideo_quality: 100\nfps: 10\n"
        )
    with open(os.path.join(tdir, "experimental.yaml"), "w") as f:
        f.write(
            f"num_gata6: {n // 10}\noutput_tda: False\n"
            "output_gradients: False\ngroup: 0\ndox_step: 5\nguye_move: True\n"
            "lonely_thresh: 2\ncolor_mode: True\n"
        )
    cell_simulation = load_reference()
    outdir = os.path.join(work, "out") + os.sep
    os.makedirs(os.path.join(outdir, "pp"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        sim = cell_simulation.CellSimulation("pp", outdir)
        sim.agent_initials()
    finally:
        os.chdir(cwd)

    # freeze the stochastic phases. The counters/thresholds are runtime
    # instance-attribute lookups, so overriding them is exact — but the
    # motility magnitude is NOT: cell_motility hardcodes a LOCAL
    # ``motility_force = 0.000000002`` (cell_methods.py:252), so the only
    # way to zero the reference's motility is to no-op the whole phase.
    sim.cell_motility = lambda: None
    sim.pluri_div_thresh = BIG
    sim.diff_div_thresh = BIG
    sim.death_thresh = BIG
    sim.dox_step = BIG
    if os.environ.get("PHYSPAR_STEP_DT"):
        sim.step_dt = float(os.environ["PHYSPAR_STEP_DT"])

    init = np.array(sim.locations, dtype=np.float64)
    per_step, bonds = [], []
    for step in range(1, steps + 1):
        sim.current_step = step
        # the reference's step-phase order, minus outputs
        sim.get_neighbors("neighbor_graph", 15)
        sim.cell_division()
        sim.cell_death()
        sim.cell_pathway()
        sim.cell_differentiate()
        sim.cell_motility()
        sim.apply_forces()
        per_step.append(np.array(sim.locations, dtype=np.float64))
        bonds.append(len(sim.jkr_graph.get_edgelist()))
    assert sim.number_agents == init.shape[0], "population changed"
    np.savez(npz_path, init=init, steps=np.stack(per_step),
             bonds=np.asarray(bonds))


def ours_side(init, steps: int, side: float):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import dataclasses

    import numpy as np

    from hipsc_abm.engine import HipscEngine
    from hipsc_abm.models.params import (
        BiologyParams,
        ExperimentalParams,
        GeneralParams,
    )

    n_total = init.shape[0]
    n_gata6 = n_total // 11  # reference: num_to_start + num_to_start//10
    gen = GeneralParams(num_to_start=n_total - n_gata6, end_step=steps + 1,
                        size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n_gata6, dox_step=BIG)
    bio = BiologyParams(motility_force=0.0, pluri_div_thresh=BIG,
                        diff_div_thresh=BIG, death_thresh=BIG)
    if os.environ.get("PHYSPAR_STEP_DT"):
        bio = dataclasses.replace(
            bio, step_dt=float(os.environ["PHYSPAR_STEP_DT"]))
    eng = HipscEngine(gen, xp, bio=bio)
    state = eng.init_state(seed=0, locations=init.astype(np.float32))
    per_step, bonds = [], []
    for _ in range(steps):
        state, info = eng.safe_step(state)
        assert int(info.num_agents) == n_total
        # the engine keeps agents grid-sorted; reference row i == our id i
        alive = np.asarray(state.alive)
        ids = np.asarray(state.arrays["ids"])[alive]
        loc = np.asarray(state.arrays["locations"])[alive].astype(np.float64)
        per_step.append(loc[np.argsort(ids)])
        bonds.append(int(np.asarray(state.bonds.mask).sum()) // 2)
    return per_step, bonds


def main():
    if sys.argv[1:2] == ["--reference"]:
        reference_side(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                       float(sys.argv[5]))
        return

    import numpy as np

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1100
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    side = float(sys.argv[3]) if len(sys.argv) > 3 else 300.0
    npz = "/tmp/physics_parity_ref.npz"
    subprocess.run(
        [sys.executable, "-u", os.path.abspath(__file__), "--reference",
         npz, str(n - n // 11), str(steps), str(side)],
        check=True, timeout=3600,
    )
    data = np.load(npz)
    init, ref_steps = data["init"], data["steps"]
    ref_bonds = data["bonds"]
    ours, our_bonds = ours_side(init, steps, side)

    def rg(loc):
        c = loc[:, :2].mean(axis=0)
        return float(np.sqrt(((loc[:, :2] - c) ** 2).sum(axis=1).mean()))

    report = {"n": int(init.shape[0]), "steps": steps, "side": side,
              "per_step": []}
    for s in range(steps):
        d = np.abs(ours[s] - ref_steps[s])
        report["per_step"].append({
            "step": s + 1,
            "max_abs_um": float(d.max()),
            "mean_abs_um": float(d.mean()),
            "rg_ref": rg(ref_steps[s]),
            "rg_ours": rg(ours[s]),
            "bonds_ref": int(ref_bonds[s]),
            "bonds_ours": int(our_bonds[s]),
        })
    report["rg_delta_ref"] = rg(ref_steps[-1]) - rg(init)
    report["rg_delta_ours"] = rg(ours[-1]) - rg(init)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
