"""Benchmark: full-model steps/sec on one GPU.

Headline workload: 100,000 cells at the reference's default colony density
(5k cells per 2000 um square -> an 8944 um box), running the complete fused
step — radius-15 neighbor search, division/death slot dynamics, FDS pathway
+ differentiation, motility, 11 physics substeps of JKR contact + Stokes
integration, and FTCS morphogen diffusion with per-cell release. The same
workload at 500,000 cells (the reference's own scale claim) and a 1k-cell
colony in device-resident ``run_steps`` blocks follow. No host outputs run
in the timed region.

Usage: ``python bench.py`` on a machine with a GPU. It exits non-zero when
JAX finds none (there is no CPU fallback: a CPU number is not a device
number). One JSON line is printed after each measurement; the last line
holds every result. Each line names the device (platform, device_kind,
count) and the card's name and power limit as ``nvidia-smi`` reports them.
Times are host-clock seconds around work that ends in
``jax.block_until_ready``; compilation and capacity growth are reported
separately as set-up seconds.

Baseline: the reference publishes no numbers (BASELINE.md), so
``vs_baseline`` divides by the MEASURED reference — the unmodified reference
code executed end-to-end with C++/OpenMP equivalents of its five numba
kernels (tools/reference_baseline/measure_reference.py), on a CPU host,
read from its own data CSV at 100k and 500k cells.
"""

import json
import subprocess
import sys
import time

# Steps/sec of the reference implementation on a CPU host (recorded
# constants, not re-measured with each run; see BASELINE.md).
REF_MEASURED_100K = 0.235
REF_MEASURED_500K = 0.033
REF_BASELINE_SOURCE = (
    "tools/reference_baseline/measure_reference.py (reference code + "
    "C++/OpenMP kernel equivalents), measured on a CPU host; see BASELINE.md"
)


def device_info() -> dict:
    """Platform, device_kind and count as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """``device_info()``, or exit non-zero when JAX found no GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        print(f"no GPU: JAX platform is {info['platform']!r}; measurements "
              "need a GPU", file=sys.stderr)
        sys.exit(2)
    return info


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit line, read by a child process
    that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def peak_bytes_in_use():
    """Device 0's peak bytes in use, or None where the backend keeps no
    memory statistics (the CPU)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


def reference_density_engine(n_cells: int):
    """The headline configuration: ``n_cells`` (+10% GATA6-high) at the
    reference's default density, with FTCS diffusion and per-cell release."""
    from hipsc_abm.engine import HipscEngine
    from hipsc_abm.models.params import (
        DiffusionParams,
        ExperimentalParams,
        GeneralParams,
    )

    side = 2000.0 * (n_cells / 5000.0) ** 0.5
    gen = GeneralParams(
        num_to_start=n_cells, end_step=200, size=(side, side, 0.0)
    )
    xp = ExperimentalParams(num_gata6=n_cells // 10, dox_step=5)
    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1,
                           release_amount=0.01)
    return HipscEngine(gen, xp, diff=diff, enable_diffusion=True)


def _steady_window(eng, run, tries: int = 3):
    """Seconds of ``run()`` (ending in ``block_until_ready``) in a steady
    window: each try first runs ``run()`` untimed, which compiles it for the
    engine's current capacities, then times it; a try in which a capacity
    grew (a recompile) is repeated. Untimed and grown runs count as set-up.
    Returns (result, seconds, set-up seconds, whether the last try grew)."""
    import jax

    setup_s = 0.0
    for _ in range(tries):
        cfg = eng.cfg
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        setup_s += time.perf_counter() - t0
        if eng.cfg != cfg:
            continue
        t0 = time.perf_counter()
        out = run()
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        if eng.cfg == cfg:
            return out, dt, setup_s, False
        setup_s += dt
    t0 = time.perf_counter()
    out = run()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0, setup_s, True


def time_full_model(n_cells: int, warmup_steps: int = 3, timed_steps: int = 8,
                    block: int = 8, seed: int = 0) -> dict:
    """Set-up (init, compile, capacity growth) then two timed windows:
    ``timed_steps`` host-driven ``safe_step``s (one probe fetch per step,
    the lifecycle's path) and one device-resident ``run_steps`` block, each
    after an untimed run that compiles it (``_steady_window``)."""
    import jax

    t0 = time.perf_counter()
    eng = reference_density_engine(n_cells)
    state = eng.init_state(seed=seed)
    for _ in range(warmup_steps):
        state, _ = eng.safe_step(state)
    jax.block_until_ready(state)
    setup_s = time.perf_counter() - t0

    def safe_steps():
        nonlocal state
        for _ in range(timed_steps):
            state, _ = eng.safe_step(state)
        return state

    def block_steps():
        nonlocal state
        state, infos = eng.run_steps(state, block)
        return state, infos

    _, step_s, grown_a, still_a = _steady_window(eng, safe_steps)
    (_, infos), block_s, grown_b, still_b = _steady_window(eng, block_steps)
    step_s /= timed_steps
    block_step_s = block_s / block
    return {
        "cells": n_cells,
        "agents_after": int(infos.num_agents[-1]),
        "capacity": int(state.capacity),
        "setup_s": setup_s + grown_a + grown_b,
        "safe_step_s": step_s,
        "safe_steps_per_sec": 1.0 / step_s,
        "run_steps_step_s": block_step_s,
        "run_steps_steps_per_sec": 1.0 / block_step_s,
        "growth_in_timed_window": still_a or still_b,
        "peak_bytes_in_use": peak_bytes_in_use(),
        "state": state,
        "engine": eng,
    }


def time_small_blocks(n_cells: int = 1000, k: int = 50, blocks: int = 2) -> dict:
    """A small colony in device-resident k-step blocks (one dispatch and one
    probe fetch per block), with slots and run caps pre-sized so no growth
    recompile lands in the timed window."""
    import jax

    from hipsc_abm.engine import EngineConfig, HipscEngine
    from hipsc_abm.models.params import ExperimentalParams, GeneralParams

    side = 2000.0 * (n_cells / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n_cells, end_step=10_000,
                        size=(side, side, 0.0))
    xp = ExperimentalParams(num_gata6=n_cells // 10, dox_step=5)
    eng = HipscEngine(gen, xp)
    cap = max(4 * eng.cfg.capacity, 2048)
    eng.cfg = EngineConfig.create(
        gen.size, capacity=cap, bio=eng.bio, nbr_run_cap=48, jkr_run_cap=48,
    )
    t0 = time.perf_counter()
    state = eng.init_state(seed=0)
    state, _ = eng.run_steps(state, k)  # compile
    state, _ = eng.run_steps(state, k)  # run-cap convergence
    jax.block_until_ready(state)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(blocks):
        state, _ = eng.run_steps(state, k)
    jax.block_until_ready(state)
    return {"cells": n_cells, "setup_s": setup_s,
            "steps_per_sec": blocks * k / (time.perf_counter() - t0)}


def main() -> None:
    dev = require_gpu()
    card = gpu_name_and_power_limit()
    out = {"device": dev, "nvidia_smi": card,
           "ref_baseline_steps_per_sec": {"100k": REF_MEASURED_100K,
                                          "500k": REF_MEASURED_500K},
           "ref_baseline_source": REF_BASELINE_SOURCE}

    def emit():
        print(json.dumps(out), flush=True)

    for n, ref, timed in ((100_000, REF_MEASURED_100K, 8),
                          (500_000, REF_MEASURED_500K, 4)):
        r = time_full_model(n, timed_steps=timed)
        r.pop("state")
        r.pop("engine")
        r["vs_baseline"] = r["safe_steps_per_sec"] / ref
        out[f"{n // 1000}k"] = r
        emit()
    out["1k_run_steps_blocks"] = time_small_blocks()
    emit()


if __name__ == "__main__":
    main()
