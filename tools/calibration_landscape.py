"""Loss-landscape probe for the joint calibration showcase.

Evaluates the two-observable replicate-mean trajectory loss (the exact
objective ``tools/calibration_showcase.py --joint`` optimizes) on a factor
grid around the true constants — loss at truth is the model-mismatch /
seed-noise floor, the axis sweeps show curvature and any compensating
ridge. One vmapped population eval per grid: the whole probe is a single
compile + one device call.

Usage: python tools/calibration_landscape.py [--replicates 4] [--seed-base 0]

``--seed-base`` shifts the replicate seed set: rerunning the probe with a
disjoint set is the decisive test for whether a displaced minimum is
systematic (stays put) or the finite-replicate realization gap between
our ensemble mean and the reference's 20-run target mean (moves).
"""

import json
import sys
import time

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/tools")

import numpy as np

from calibration_showcase import TARGET_PATH, TRUE


def main():
    import jax
    import jax.numpy as jnp

    from hipsc_abm.calibrate import (
        Calibrator,
        _to_unconstrained,
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

    with open(TARGET_PATH) as f:
        target = json.load(f)
    replicates = (int(sys.argv[sys.argv.index("--replicates") + 1])
                  if "--replicates" in sys.argv else 4)
    seed_base = (int(sys.argv[sys.argv.index("--seed-base") + 1])
                 if "--seed-base" in sys.argv else 0)

    n, side, steps = target["n_cells"], target["side"], target["steps"]
    gen = GeneralParams(num_to_start=n, end_step=steps + 1,
                        size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=5)
    bio = BiologyParams(**TRUE)
    eng = HipscEngine(gen, xp, bio=bio)
    loss = ensemble_trajectory(multi_delta_trajectory_squared_error([
        (radius_of_gyration,
         np.asarray(target["rg_trajectory_um"], np.float32)),
        (soft_contact_count(target["contact_gate"]["r_um"],
                            target["contact_gate"]["width_um"]),
         np.asarray(target["contact_trajectory"], np.float32)),
    ]))
    names = list(TRUE)
    cal = Calibrator(eng, names, loss, horizon=steps)
    ens = EnsembleEngine(eng)
    state = cal.prepare(
        ens.init_states(seeds=range(seed_base, seed_base + replicates)))

    # factor grid: truth, the 3x start, each axis, and the diagonal
    factors = [0.33, 0.5, 0.75, 0.9, 1.0, 1.1, 1.25, 1.5, 2.0, 3.0]
    points = [("truth", 1.0, 1.0), ("start3x", 3.0, 3.0)]
    points += [(f"adh={f}", f, 1.0) for f in factors if f != 1.0]
    points += [(f"mot={f}", f_a, f) for f in factors if f != 1.0
               for f_a in (1.0,)]
    points += [(f"diag={f}", f, f) for f in (0.5, 1.5, 2.0)]

    cands = jnp.asarray([
        [_to_unconstrained(names[0], TRUE[names[0]] * fa),
         _to_unconstrained(names[1], TRUE[names[1]] * fm)]
        for (_, fa, fm) in points
    ], dtype=jnp.float32)

    t0 = time.perf_counter()
    (losses, _info), state = cal._eval_with_growth(1, cands, state)
    losses = np.asarray(jax.device_get(losses))
    wall = time.perf_counter() - t0

    out = {
        "backend": jax.default_backend(),
        "replicates": replicates,
        "seed_base": seed_base,
        "wall_s": round(wall, 1),
        "points": [
            {"label": lbl, "adh_factor": fa, "mot_factor": fm,
             "loss": float(l)}
            for (lbl, fa, fm), l in zip(points, losses)
        ],
    }
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
