"""Calibration showcase: recover force-scale parameters on the device from a
REFERENCE-generated colony.

The reference (ajin40/Python-hiPSC-ABM) has no calibration story at all —
its constants are hand-tuned (``cell_simulation.py:34-57``). This tool
demonstrates the capability a reference user cannot have: run the actual
reference code once, observe only its per-step radius-of-gyration time
course, then gradient-fit this framework's matching ``BiologyParams``
through the differentiable rollout until the simulated time course matches
— recovering the reference's hand-tuned constants from its own data.

Per docs/CALIBRATION.md, the force scales are NOT jointly identifiable from
compaction alone (measured compensating ridge), so the showcase fits them
the documented way: one force scale at a time, each started from a 3x-off
initial guess with the other held at truth.

Design choices measured before committing (tools-side sensitivity study):
at the reference's default density cells are ~28 um apart (contact range
~10 um), so Rg is nearly blind to adhesion — the showcase uses a DENSE
colony (1000 cells in a 300 um box, heavy contact) where both force scales
move the compaction delta 3-4x above seed noise at 3x parameter offsets.
And absolute Rg carries a ~Rg/sqrt(2N) random-placement offset that dwarfs
the per-step signal, so the fit matches the compaction CHANGE
(``delta_trajectory_squared_error``), which cancels the offset exactly.

Stages:
  --make-target   run the reference (clean subprocess: its C++/OpenMP
                  kernels clash with an initialized XLA runtime), compute
                  the Rg time course from its values CSVs, write
                  ``tools/calibration_target.json``.
  (default)       read the target and fit ``adhesion_const`` then
                  ``motility_force`` on the default JAX backend, reporting recovered values,
                  error vs the reference's true constants, and wall-clock.

Usage:
  python tools/calibration_showcase.py --make-target [n_cells] [steps]
  python tools/calibration_showcase.py [--replicates R] [--iters K]
"""

import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)

TARGET_PATH = os.path.join(_HERE, "calibration_target.json")

# the reference's hand-tuned truths (cell_methods.py:252, :347)
TRUE = {"adhesion_const": 0.000107, "motility_force": 2e-9}

# smooth contact gate shared by the observed and simulated coordination
# statistics (calibrate.soft_contact_count)
CONTACT_R = 10.0
CONTACT_W = 1.0


# ---------------------------------------------------------------------------
# target generation (reference side — NO jax in this process)
# ---------------------------------------------------------------------------


def make_target(n_cells: int, steps: int, side: float,
                runs: int = 5) -> dict:
    """Run the reference ``runs`` times and average the Rg trajectories —
    the reference's own seed-to-seed spread on the 10-step compaction delta
    is ~±0.5 um (measured), comparable to a 3x parameter offset's signal;
    averaging R replicate experiments shrinks it by sqrt(R)."""
    import csv
    import math
    import shutil
    import tempfile

    sys.path.insert(0, os.path.join(_HERE, "reference_baseline"))
    from measure_reference import load_reference

    work = tempfile.mkdtemp(prefix="caltarget_")
    tdir = os.path.join(work, "templates")
    os.makedirs(tdir)
    with open(os.path.join(tdir, "general.yaml"), "w") as f:
        f.write(
            f"num_to_start: {n_cells}\ncuda: False\nend_step: {steps}\n"
            f"size: [{side}, {side}, 0]\noutput_values: True\n"
            "output_images: False\nrecord_initial_step: False\n"
            "image_quality: 100\nvideo_quality: 100\nfps: 10\n"
        )
    with open(os.path.join(tdir, "experimental.yaml"), "w") as f:
        f.write(
            f"num_gata6: {n_cells // 10}\noutput_tda: False\n"
            "output_gradients: False\ngroup: 0\ndox_step: 5\nguye_move: True\n"
            "lonely_thresh: 2\ncolor_mode: True\n"
        )
    cell_simulation = load_reference()
    per_run = []
    cwd = os.getcwd()
    for r in range(runs):
        name = f"ref{r}"
        outdir = os.path.join(work, f"out{r}") + os.sep
        os.makedirs(os.path.join(outdir, name))
        os.chdir(work)
        try:
            sim = cell_simulation.CellSimulation(name, outdir)
            sim.agent_initials()
            sim.steps()
        finally:
            os.chdir(cwd)
        rgs, contacts = [], []
        for step in range(1, steps + 1):
            path = os.path.join(outdir, name, f"{name}_values",
                                f"{name}_values_{step}.csv")
            xs, ys = [], []
            with open(path) as f:
                for row in csv.DictReader(f):
                    xs.append(float(row["locations[0]"]))
                    ys.append(float(row["locations[1]"]))
            n = len(xs)
            cx, cy = sum(xs) / n, sum(ys) / n
            rgs.append(math.sqrt(sum(
                (x - cx) ** 2 + (y - cy) ** 2 for x, y in zip(xs, ys)) / n))
            # soft contact coordination, SAME smooth gate as the simulated
            # statistic (calibrate.soft_contact_count r=10, w=1) so the
            # observed and simulated courses compare without gate bias
            import numpy as _np

            loc = _np.stack([_np.asarray(xs), _np.asarray(ys)], axis=1)
            d = _np.sqrt(((loc[:, None, :] - loc[None, :, :]) ** 2)
                         .sum(-1) + 1e-12)
            gate = 1.0 / (1.0 + _np.exp(-(CONTACT_R - d) / CONTACT_W))
            _np.fill_diagonal(gate, 0.0)
            contacts.append(float(gate.sum(axis=1).mean()))
        per_run.append((rgs, contacts))
    shutil.rmtree(work, ignore_errors=True)
    mean_rgs = [sum(col) / runs for col in zip(*(r for r, _ in per_run))]
    mean_cts = [sum(col) / runs for col in zip(*(c for _, c in per_run))]
    return {"n_cells": n_cells, "steps": steps, "side": side, "runs": runs,
            "rg_trajectory_um": mean_rgs,
            "contact_trajectory": mean_cts,
            "contact_gate": {"r_um": CONTACT_R, "width_um": CONTACT_W},
            "rg_per_run_um": [r for r, _ in per_run],
            "contact_per_run": [c for _, c in per_run]}


# ---------------------------------------------------------------------------
# fitting (device side)
# ---------------------------------------------------------------------------


def fit_stage(target: dict, param: str, start_factor: float,
              replicates: int, iters: int, lr: float = 0.05,
              method: str = "grad") -> dict:
    import dataclasses

    import numpy as np

    from hipsc_abm.calibrate import (
        Calibrator,
        delta_trajectory_squared_error,
        radius_of_gyration,
    )
    from hipsc_abm.engine import HipscEngine
    from hipsc_abm.models.params import (
        BiologyParams,
        ExperimentalParams,
        GeneralParams,
    )
    from hipsc_abm.parallel.ensemble import EnsembleEngine

    n, side, steps = target["n_cells"], target["side"], target["steps"]
    gen = GeneralParams(num_to_start=n, end_step=steps + 1,
                        size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=5)
    bio = BiologyParams(**{param: TRUE[param] * start_factor})
    eng = HipscEngine(gen, xp, bio=bio)

    loss = delta_trajectory_squared_error(
        radius_of_gyration, np.asarray(target["rg_trajectory_um"],
                                       dtype=np.float32))
    cal = Calibrator(eng, [param], loss, horizon=steps)
    if replicates > 1:
        ens = EnsembleEngine(eng)
        state = ens.init_states(seeds=range(replicates))
    else:
        state = eng.init_state(seed=0)

    t0 = time.perf_counter()
    if method == "es":
        # forward-only antithetic ES with common random numbers: the
        # pathwise gradient through a 10-step contact rollout is noisy
        # (adam's effective step collapses ~7x); the smoothed ES gradient
        # with rank shaping is the robust estimator for this landscape
        res = cal.fit_es(state, iters=iters, popsize=16, sigma=0.3,
                         learning_rate=lr)
    else:
        res = cal.fit(state, iters=iters, learning_rate=lr)
    wall = time.perf_counter() - t0
    fitted = res.params[param]
    return {
        "param": param,
        "start": TRUE[param] * start_factor,
        "true": TRUE[param],
        "fitted": fitted,
        "recovery_error_pct": abs(fitted - TRUE[param]) / TRUE[param] * 100,
        "start_error_pct": abs(start_factor - 1.0) * 100,
        "loss_start": res.loss_history[0],
        "loss_best": res.best_loss,
        "iters": iters,
        "replicates": replicates,
        "method": method,
        "wall_s": round(wall, 1),
    }


def fit_joint(target: dict, start_factor: float, replicates: int,
              iters: int, lr: float = 0.1) -> dict:
    """Joint (adhesion_const, motility_force) fit from 3x-off starts on
    BOTH, against the two-observable delta course (Rg + soft contact
    coordination) — the second statistic breaks the measured compensating
    ridge that made the single-observable joint fit land 92%/21% off
    (docs/CALIBRATION.md)."""
    import numpy as np

    from hipsc_abm.calibrate import (
        Calibrator,
        ensemble_trajectory,
        multi_delta_trajectory_squared_error,
        radius_of_gyration,
        soft_contact_count,
    )
    from hipsc_abm.engine import HipscEngine
    from hipsc_abm.models.params import (
        BiologyParams,
        ExperimentalParams,
        GeneralParams,
    )
    from hipsc_abm.parallel.ensemble import EnsembleEngine

    n, side, steps = target["n_cells"], target["side"], target["steps"]
    gen = GeneralParams(num_to_start=n, end_step=steps + 1,
                        size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=5)
    bio = BiologyParams(**{p: TRUE[p] * start_factor for p in TRUE})
    eng = HipscEngine(gen, xp, bio=bio)

    # method of moments: the target is itself a multi-run AVERAGE course,
    # so match it with the replicate-MEAN simulated course (noise shrinks
    # by sqrt(R)) instead of averaging per-replicate losses (which floor
    # at single-seed noise and flatten the landscape around truth)
    loss = ensemble_trajectory(multi_delta_trajectory_squared_error([
        (radius_of_gyration,
         np.asarray(target["rg_trajectory_um"], np.float32)),
        (soft_contact_count(target["contact_gate"]["r_um"],
                            target["contact_gate"]["width_um"]),
         np.asarray(target["contact_trajectory"], np.float32)),
    ]))
    cal = Calibrator(eng, list(TRUE), loss, horizon=steps)
    if replicates > 1:
        ens = EnsembleEngine(eng)
        state = ens.init_states(seeds=range(replicates))
    else:
        state = eng.init_state(seed=0)

    t0 = time.perf_counter()
    res = cal.fit(state, iters=iters, learning_rate=lr, log_every=5)
    wall = time.perf_counter() - t0
    out = {"method": "grad-joint", "iters": iters, "replicates": replicates,
           "loss_start": res.loss_history[0], "loss_best": res.best_loss,
           "wall_s": round(wall, 1), "params": []}
    for p in TRUE:
        fitted = res.params[p]
        out["params"].append({
            "param": p, "start": TRUE[p] * start_factor, "true": TRUE[p],
            "fitted": fitted,
            "recovery_error_pct": abs(fitted - TRUE[p]) / TRUE[p] * 100,
        })
    return out


def main():
    if "--make-target" in sys.argv:
        args = [a for a in sys.argv[1:] if not a.startswith("--")]
        n = int(args[0]) if args else 1000
        steps = int(args[1]) if len(args) > 1 else 10
        side = float(args[2]) if len(args) > 2 else 300.0
        runs = int(args[3]) if len(args) > 3 else 5
        target = make_target(n, steps, side, runs=runs)
        with open(TARGET_PATH, "w") as f:
            json.dump(target, f, indent=1)
        print(json.dumps(target))
        return

    import jax  # noqa: F401 — the default backend

    with open(TARGET_PATH) as f:
        target = json.load(f)
    replicates = (int(sys.argv[sys.argv.index("--replicates") + 1])
                  if "--replicates" in sys.argv else 4)
    iters = (int(sys.argv[sys.argv.index("--iters") + 1])
             if "--iters" in sys.argv else 30)
    lr = (float(sys.argv[sys.argv.index("--lr") + 1])
          if "--lr" in sys.argv else 0.05)
    method = (sys.argv[sys.argv.index("--method") + 1]
              if "--method" in sys.argv else "grad")

    import jax as _jax

    results = {"backend": _jax.default_backend(), "method": method,
               "target": target["rg_trajectory_um"],
               "stages": []}
    if "--joint" in sys.argv:
        if "contact_trajectory" not in target:
            sys.exit("target lacks contact_trajectory — regenerate with "
                     "--make-target")
        stage = fit_joint(target, start_factor=3.0, replicates=replicates,
                          iters=iters, lr=lr)
        results["stages"].append(stage)
        print(json.dumps(stage), flush=True)
    else:
        for param in ("adhesion_const", "motility_force"):
            stage = fit_stage(target, param, start_factor=3.0,
                              replicates=replicates, iters=iters, lr=lr,
                              method=method)
            results["stages"].append(stage)
            print(json.dumps(stage), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
