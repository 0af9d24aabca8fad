"""Replicate study: R colonies, one vmapped program, mean +/- CI time courses.

The standard way ABM results are reported is an ensemble of stochastic
replicates with per-step summary statistics. With the reference that means
launching R separate processes and collating CSVs by hand; here the whole
study is ONE `EnsembleEngine` run — every replicate bit-identical to the
same seed run solo — and the summary lands in a single CSV:

    step, n_mean, n_sd, rog_mean, rog_sd, gata6_frac_mean, gata6_frac_sd

Run:  JAX_PLATFORMS=cpu PYTHONPATH=. python examples/replicate_study.py [R]
"""

import csv
import sys

import jax
import jax.numpy as jnp

from hipsc_abm.calibrate import gata6_high_fraction, radius_of_gyration
from hipsc_abm.engine import HipscEngine
from hipsc_abm.models.params import ExperimentalParams, GeneralParams
from hipsc_abm.parallel.ensemble import EnsembleEngine


def colony_stats(states):
    """(R,) per-replicate statistics from the stacked state, on-device."""
    n = jax.vmap(lambda s: jnp.sum(s.alive))(states)
    rog = jax.vmap(radius_of_gyration)(states)
    frac = jax.vmap(gata6_high_fraction)(states)
    return n, rog, frac


def main(R=8, steps=12, out_path="replicate_study.csv"):
    gen = GeneralParams(num_to_start=500, end_step=steps,
                        size=(650.0, 650.0, 0.0))
    xp = ExperimentalParams(num_gata6=50, dox_step=2)
    ens = EnsembleEngine(HipscEngine(gen, xp))
    states = ens.init_states(seeds=range(R))

    rows = []
    for step in range(1, steps + 1):
        states, infos = ens.safe_step(states)
        n, rog, frac = jax.jit(colony_stats)(states)
        row = [step]
        for v in (n.astype(jnp.float32), rog, frac):
            row += [float(jnp.mean(v)), float(jnp.std(v))]
        rows.append(row)
        print(f"step {step}: {row[1]:.1f}±{row[2]:.1f} cells, "
              f"RoG {row[3]:.1f}±{row[4]:.2f} um, "
              f"GATA6-high {row[5]:.3f}±{row[6]:.3f}", flush=True)

    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "n_mean", "n_sd", "rog_mean", "rog_sd",
                    "gata6_frac_mean", "gata6_frac_sd"])
        w.writerows(rows)
    print(f"wrote {out_path} ({R} replicates x {steps} steps)")
    return rows


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
