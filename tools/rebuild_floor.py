"""What the contact window's rebuilds cost inside one step.

Within a step the contact window is Verlet-cached (`engine._physics_scan_xla`:
the window rides the 11-substep scan carry; a `lax.cond` rebuilds it only
when drift crosses skin/2). This tool measures the in-scan rebuilds by
forcing the drift predicate off (`verlet_skin=1e6` at step build time —
physics goes stale after the first window, but the compute shape is
identical, which is what a timing bound needs), and prints the division
count per step: ~n/36 agents divide every step (division clocks uniform
over [0, 36), reference `cell_simulation.py:146`), so membership changes
at every step boundary and a window cannot be carried across steps.

Usage: python tools/rebuild_floor.py [n_cells]
"""
import dataclasses
import sys
import time

import jax

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from hipsc_abm.engine import HipscEngine, hipsc_step  # noqa: E402
from hipsc_abm.models.params import (  # noqa: E402
    ExperimentalParams, GeneralParams)


def timeit(name, fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / reps * 1000
    print(f"{name:52s} {ms:9.2f} ms", flush=True)
    return ms


def main(n=500_000):
    side = 2000.0 * (n / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n, end_step=10, size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n // 10, dox_step=5)
    eng = HipscEngine(gen, xp)
    s = eng.init_state(0)
    adds = []
    for _ in range(3):
        s, info = eng.safe_step(s)
        adds.append(int(info.num_added))
    cfg, bio = eng.cfg, eng.bio
    print(f"n={n}  capacity {cfg.capacity}  K {cfg.bond_cap}")
    print(f"divisions per step (probe num_added): {adds} "
          f"(expected ~n/36 = {n // 36}) — membership changes EVERY step, "
          "so a cross-step carried window is invalid at every entry")

    t_full = timeit(
        "full step (as-is: entry build + drift rebuilds)",
        jax.jit(lambda st: hipsc_step(
            st, cfg=cfg, gen=gen, xp=xp, bio=bio, diff=None)[0]), s)

    cfg_norb = dataclasses.replace(cfg, verlet_skin=1e6)
    t_norb = timeit(
        "full step, in-scan drift rebuilds forced OFF",
        jax.jit(lambda st: hipsc_step(
            st, cfg=cfg_norb, gen=gen, xp=xp, bio=bio, diff=None)[0]), s)

    print(f"\nin-scan (drift) rebuild cost actually paid: "
          f"{t_full - t_norb:+.1f} ms/step")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 500_000)
