"""Small-colony throughput: per-step ``safe_step`` dispatch against
device-resident k-step blocks (``HipscEngine.run_steps``).

Every ``safe_step`` fetches the step's overflow probes (one host round
trip); ``run_steps`` scans k steps on device and fetches the stacked probes
once per block. Slots and run caps are pre-sized (``bench.time_small_blocks``)
so no growth recompile lands inside the timed region.

Usage: ``python tools/bench_small.py [n_cells] [k]``.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main(n_cells=1000, k=50, steps=30):
    import jax

    from hipsc_abm.engine import HipscEngine
    from hipsc_abm.models.params import ExperimentalParams, GeneralParams

    side = 2000.0 * (n_cells / 5000.0) ** 0.5
    eng = HipscEngine(
        GeneralParams(num_to_start=n_cells, end_step=10_000,
                      size=(side, side, 0.0)),
        ExperimentalParams(num_gata6=n_cells // 10, dox_step=5))
    state = eng.init_state(seed=0)
    for _ in range(3):  # compile + cap convergence
        state, _ = eng.safe_step(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = eng.safe_step(state)
    jax.block_until_ready(state)
    per_step = steps / (time.perf_counter() - t0)
    print(f"device: {bench.device_info()}", flush=True)
    print(f"safe_step (per-step probes): {per_step:.1f} steps/s", flush=True)
    blocked = bench.time_small_blocks(n_cells, k)["steps_per_sec"]
    print(f"run_steps(k={k}) blocks:     {blocked:.1f} steps/s", flush=True)
    print(f"speedup: {blocked / per_step:.2f}x", flush=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    main(n, k)
