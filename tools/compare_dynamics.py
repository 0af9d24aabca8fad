"""Live colony-dynamics cross-validation against the ACTUAL reference.

Runs the unmodified reference code (via tools/reference_baseline — its
numba kernels as C++/OpenMP equivalents) and this framework's engine on
the same configuration, and compares the per-step population trajectories.
RNG streams differ by design (PARITY.md "Documented divergences" #2), so
the comparison is distributional: the division/death dynamics must track
within a few percent at every step.

Usage: PYTHONPATH=. python tools/compare_dynamics.py [n_cells] [steps]
(CPU-only: the reference side is numpy/C++.)

Measured 2026-08-19 (1,000 cells, 30 steps, dox_step 5): reference final
population 1,414 and 1,429 over two of its own runs; ours 1,390 / 1,397 /
1,430 over three seeds — worst per-step deviation 3.0%, i.e. inside the
reference's own seed-to-seed spread. At the reference's default scale
(5,000 cells, 20 steps): worst per-step deviation 0.8% (final: ref 6,554
vs ours 6,533-6,572) — the 1/sqrt(N) shrinkage of identical distributions.
"""

import os
import re
import subprocess
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def ours_trajectory(n, steps, seed):
    from hipsc_abm.engine import HipscEngine
    from hipsc_abm.models.params import ExperimentalParams, GeneralParams

    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=steps,
                        size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=5)
    eng = HipscEngine(gen, xp)
    s = eng.init_state(seed=seed)
    counts = []
    for _ in range(steps):
        s, info = eng.safe_step(s)
        counts.append(int(info.num_agents))
    return counts


def reference_trajectory(n, steps):
    """Run the reference in a CLEAN subprocess: its C++/OpenMP kernels
    segfault when loaded into a process that already initialized the XLA
    CPU runtime (observed: two-runtime OpenMP clash at ~step 13)."""
    script = os.path.join(os.path.dirname(__file__), "reference_baseline",
                          "measure_reference.py")
    out = subprocess.run(
        [sys.executable, "-u", script, str(n), str(steps)],
        capture_output=True, text=True, timeout=3600, check=True,
    ).stdout
    ref = [int(m.group(1))
           for m in re.finditer(r"^step\s+\d+\s+agents\s+(\d+)", out, re.M)]
    assert len(ref) == steps, f"parsed {len(ref)} of {steps} steps"
    return ref


def main(n=1000, steps=30, seeds=(0, 1, 2)):
    ref = reference_trajectory(n, steps)
    print("reference:", " ".join(map(str, ref)))
    worst_overall = 0.0
    best_final = None
    for seed in seeds:
        mine = ours_trajectory(n, steps, seed)
        dev = max(abs(a - b) / b for a, b in zip(mine, ref))
        worst_overall = max(worst_overall, dev)
        if best_final is None or abs(mine[-1] - ref[-1]) < abs(best_final - ref[-1]):
            best_final = mine[-1]
        print(f"ours s{seed}: ", " ".join(map(str, mine)),
              f"  max step dev {dev*100:.1f}%")
    print(f"final populations: ref {ref[-1]}, ours(best) {best_final}; "
          f"worst per-step deviation across seeds {worst_overall*100:.1f}%")
    assert worst_overall < 0.05, "dynamics diverged beyond 5%"
    print("DYNAMICS MATCH (distributional, <5% at every step)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1000,
         int(sys.argv[2]) if len(sys.argv) > 2 else 30)
