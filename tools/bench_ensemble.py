"""A/B: vmapped replicate ensemble vs sequential solo colonies.

Measures the EnsembleEngine claim (parallel/ensemble.py): R reference-scale
replicate colonies stepped as ONE vmapped program vs the same R colonies
stepped one-at-a-time through the single-colony engine (the reference's
one-process-per-replicate workflow, minus even its process overhead).

Usage:  PYTHONPATH=. python tools/bench_ensemble.py [R] [steps]
        (JAX_PLATFORMS=cpu for the CPU backend; default is the accelerator)

Prints per-step wall for both paths and the speedup. On an accelerator the
ensemble path is the right shape: R x 5k cells fills a device that a single
5k colony cannot. The accelerator side has not been measured yet.
"""

import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from hipsc_abm.engine import HipscEngine
from hipsc_abm.models.params import ExperimentalParams, GeneralParams
from hipsc_abm.parallel.ensemble import EnsembleEngine


def force(x):
    return float(jnp.sum(x.arrays["locations"]))


def main(R=16, steps=6):
    gen = GeneralParams(num_to_start=5000, end_step=200,
                        size=(2000.0, 2000.0, 0.0))
    xp = ExperimentalParams(num_gata6=500, dox_step=5)

    # --- ensemble path ------------------------------------------------------
    ens = EnsembleEngine(HipscEngine(gen, xp))
    states = ens.init_states(seeds=range(R))
    states, _ = ens.safe_step(states)  # warmup: compile + growth
    force(EnsembleEngine.replicate(states, 0))
    t0 = time.perf_counter()
    for _ in range(steps):
        states, _ = ens.step(states)
    force(EnsembleEngine.replicate(states, 0))
    t_ens = (time.perf_counter() - t0) / steps
    print(f"ensemble: {R} replicates x {steps} steps: "
          f"{t_ens * 1e3:.1f} ms/step ({t_ens * 1e3 / R:.2f} ms/replicate)")

    # --- sequential path ------------------------------------------------------
    solo = HipscEngine(gen, xp)
    solo_states = [solo.init_state(seed=s) for s in range(R)]
    # warm up EVERY replicate: the first pass settles any capacity/cap
    # growth (which changes the compiled shape), the repad pass brings all
    # replicates to the settled config so the timed loop never compiles
    for i in range(R):
        solo_states[i], _ = solo.safe_step(solo_states[i])
    solo_states = [HipscEngine.repad_state(s, solo.cfg) for s in solo_states]
    solo_states[0], _ = solo.step(solo_states[0])  # compile the settled shape
    force(solo_states[0])
    t0 = time.perf_counter()
    for _ in range(steps):
        for i in range(R):
            solo_states[i], _ = solo.step(solo_states[i])
    force(solo_states[0])
    t_solo = (time.perf_counter() - t0) / steps
    print(f"sequential: {R} solo colonies x {steps} steps: "
          f"{t_solo * 1e3:.1f} ms/step ({t_solo * 1e3 / R:.2f} ms/replicate)")
    print(f"ensemble speedup: {t_solo / t_ens:.2f}x "
          f"({jax.default_backend()} backend)")


if __name__ == "__main__":
    R = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    main(R, steps)
