"""Per-layer device time of the fused step, from a ``jax.profiler`` trace.

    python tools/profile_step.py --cells 100000 500000 --steps 4 \
        --out chiprun_out/profile

For each size: the bench's reference-density configuration with diffusion
(``bench.reference_density_engine``) is warmed up (compile, capacity
growth), ``--steps`` raw steps are timed with the profiler off, then the
same number of steps is traced. Each device kernel in the trace is
attributed to the innermost step-phase scope (``engine._scoped`` names:
``contact``, ``bond_compaction``, ``window_rebuild``, ``bio_moments``,
``ftcs`` ...) through the ``op_name`` metadata of the HLO instruction the
kernel ran (or, for a fusion without a scope of its own, of the
instructions it fuses), and its device time is summed. Also reported: device busy and
idle share of the traced window and kernel launches per step per phase,
and three layers timed on their own (``time_isolated``).

``--compaction`` additionally times the two exact bond-compaction
formulations (int32 masked sum, f32 one-hot einsum at HIGHEST precision)
at the 100k state's window shape.

Needs a GPU for device times; on the CPU the same reduction runs over the
host's XLA op events (useful only to check the tool).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402

SCOPES = (
    "neighbor_grid", "sort_rows", "bio_moments", "division",
    "diffusion_deposit", "ftcs", "physics", "window_rebuild", "contact",
    "bond_compaction", "integrate",
)
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"(?:calls|to_apply|body|condition|branch_computations)="
                    r"\{?([%\w.\-, ]+)\}?")


def layer_of(op_name: str) -> str:
    """The innermost step-phase scope named in an ``op_name`` path."""
    parts = [p for p in op_name.split("/") if p in SCOPES]
    return parts[-1] if parts else "other"


def layer_map(hlo_text: str) -> dict:
    """HLO instruction name -> step-phase layer. An instruction's own
    ``op_name`` decides; one without a scope (a fusion, a loop) takes the
    most common layer among the instructions of the computations it calls."""
    own, calls, comp_instrs = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m and comp is not None:
            name = m.group(1)
            comp_instrs[comp].append(name)
            op = _OPNAME.search(line)
            own[name] = layer_of(op.group(1)) if op else "other"
            c = _CALLS.findall(line)
            calls[name] = [x.strip().lstrip("%") for grp in c for x in grp.split(",")
                           if x.strip()]
            continue
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            comp_instrs[comp] = []

    memo = {}

    def resolve(name, depth=0):
        if name in memo:
            return memo[name]
        layer = own.get(name, "other")
        if layer == "other" and depth < 8:
            votes = {}
            for callee in calls.get(name, ()):
                for inner in comp_instrs.get(callee, ()):
                    lyr = resolve(inner, depth + 1)
                    if lyr != "other":
                        votes[lyr] = votes.get(lyr, 0) + 1
            if votes:
                layer = max(votes, key=votes.get)
        memo[name] = layer
        return layer

    return {name: resolve(name) for name in own}


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xplane_path: str, layers: dict, module: str, steps: int,
                 window_ns: int) -> dict:
    """Sum device kernel time per layer over the traced window."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    kernel_layers = {re.sub(r"[.\-]", "_", k): v for k, v in layers.items()}
    per_layer, launches, intervals = {}, {}, []
    unmatched, stat_keys = {}, set()
    for plane in pd.planes:
        device = plane.name.startswith("/device:")
        if not device and not plane.name.startswith("/host:CPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats) if ev.stats else {}
                if device:
                    stat_keys.update(stats)
                op = stats.get("hlo_op")
                if op is None or stats.get("hlo_module") != module:
                    continue
                layer = layers.get(str(op))
                if layer is None:
                    # kernels replayed inside a command buffer (CUDA graph)
                    # carry the buffer's hlo_op; XLA names each kernel after
                    # its fusion instruction, with "." written as "_"
                    layer = kernel_layers.get(str(ev.name).split(".")[0])
                if layer is None:
                    layer = "other"
                    key = f"{op} | {ev.name} | {stats.get('tf_op')}"
                    u = unmatched.setdefault(key, [0, 0.0])
                    u[0] += 1
                    u[1] += ev.duration_ns / 1e6
                per_layer[layer] = per_layer.get(layer, 0.0) + ev.duration_ns
                launches[layer] = launches.get(layer, 0) + 1
                intervals.append((int(ev.start_ns), int(ev.start_ns + ev.duration_ns)))
    busy = _union_ns(intervals)
    top = sorted(unmatched.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "ms_per_step": {k: v / 1e6 / steps for k, v in sorted(per_layer.items())},
        "launches_per_step": {k: v / steps for k, v in sorted(launches.items())},
        "kernel_ms_per_step": sum(per_layer.values()) / 1e6 / steps,
        "busy_ms_per_step": busy / 1e6 / steps,
        "window_ms_per_step": window_ns / 1e6 / steps,
        "idle_share": 1.0 - busy / max(window_ns, 1),
        "unmatched_top": {k: v for k, v in top},
        "device_stat_keys": sorted(stat_keys),
    }


def profile_size(n_cells: int, steps: int, out_dir: str, keep: bool) -> dict:
    import jax

    eng = bench.reference_density_engine(n_cells)
    state = eng.init_state(seed=0)
    for _ in range(3):
        state, _ = eng.safe_step(state)
    cfg = eng._cfg_for_state(state)
    step = eng._step_fn(cfg)
    state, _ = step(state)
    jax.block_until_ready(state)

    t0 = time.perf_counter()
    s = state
    for _ in range(steps):
        s, _ = step(s)
    jax.block_until_ready(s)
    wall = (time.perf_counter() - t0) / steps

    trace_dir = os.path.join(out_dir, f"trace_{n_cells}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    s = state
    jax.profiler.start_trace(trace_dir)
    t0 = time.perf_counter_ns()
    for _ in range(steps):
        s, _ = step(s)
    jax.block_until_ready(s)
    window = time.perf_counter_ns() - t0
    jax.profiler.stop_trace()

    hlo = step.lower(state).compile().as_text()
    module = re.search(r"HloModule\s+([^\s,]+)", hlo).group(1)
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)[0]
    out = {"cells": n_cells, "agents": int(np.asarray(state.alive).sum()),
           "capacity": int(state.capacity), "untraced_step_ms": wall * 1e3,
           "peak_bytes_in_use": bench.peak_bytes_in_use()}
    out.update(reduce_trace(path, layer_map(hlo), module, steps, window))
    out["isolated"] = time_isolated(eng, state)
    if not keep:
        shutil.rmtree(trace_dir, ignore_errors=True)
    return out


def _time_call(fn, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def time_isolated(eng, state) -> dict:
    """Milliseconds per call of three layers jitted on their own at the
    state's shapes: one contact substep (``jkr_substep`` over a built
    window; the step runs 11), one full biology-moment reduction (the step
    runs three, two of them trimmed) and one step's FTCS subcycle scan."""
    import jax
    import jax.numpy as jnp

    from hipsc_abm.engine import diffusion_dts_cached, make_bio_moments_xla
    from hipsc_abm.ops import diffusion as diffusion_ops
    from hipsc_abm.ops import jkr as jkr_ops
    from hipsc_abm.ops import neighbors as nbr_ops

    cfg, bio, diff = eng._cfg_for_state(state), eng.bio, eng.diff
    loc, ids, alive = state.arrays["locations"], state.arrays["ids"], state.alive
    window = jax.jit(nbr_ops.sorted_window, static_argnums=0)
    out = {}

    grid, pos, valid, _ = window(cfg.jkr_spec, loc, ids, alive)
    packed = jkr_ops.pack_physics(loc, state.arrays["radii"], ids, alive)
    contact = jax.jit(lambda b, p: jkr_ops.jkr_substep(
        b, p, grid.order, pos, valid, bio.jkr_radius, bio.adhesion_const,
        bio.poisson, bio.youngs, bio.jkr_break_d))
    out["contact_substep_ms"] = _time_call(contact, state.bonds, packed)

    ngrid, npos, nvalid, _ = window(cfg.nbr_spec, loc, ids, alive)
    moments = jax.jit(lambda loc, g6, ng, st, al: make_bio_moments_xla(
        ngrid, npos, nvalid, loc, ids, al, bio.neighbor_radius)(
            loc, g6, ng, st, al, mode="full"))
    out["bio_moments_full_ms"] = _time_call(
        moments, loc, state.arrays["GATA6"], state.arrays["NANOG"],
        state.arrays["states"], alive)

    dts = jnp.asarray(diffusion_dts_cached(bio.step_dt, diff.diffuse_dt))
    ftcs = jax.jit(lambda g: diffusion_ops.ftcs_diffuse(
        g, dts, diff.diffuse_const, diff.spat_res2, diff.max_concentration,
        diff.degradation))
    out["ftcs_step_ms"] = _time_call(ftcs, state.gradients["fgf4_values"])
    return out


def time_compaction(n_cells: int, reps: int = 20) -> dict:
    """The two exact first-k compactions at a real window's shape."""
    import jax
    import jax.numpy as jnp

    from hipsc_abm.ops import jkr as jkr_ops
    from hipsc_abm.ops import neighbors as nbr_ops

    eng = bench.reference_density_engine(n_cells)
    state = eng.init_state(seed=0)
    for _ in range(3):
        state, _ = eng.safe_step(state)
    cfg = eng.cfg
    loc = state.arrays["locations"]
    grid, pos, valid, _ = jax.jit(nbr_ops.sorted_window, static_argnums=0)(
        cfg.jkr_spec, loc, state.arrays["ids"], state.alive)
    packed = jkr_ops.pack_physics(loc, state.arrays["radii"],
                                  state.arrays["ids"], state.alive)
    cand = jkr_ops.window_cand_ids(packed, grid.order, pos)
    d2 = jnp.sum((packed[grid.order][pos][..., :3] - loc[:, None, :]) ** 2, -1)
    mask = valid & (d2 <= eng.bio.jkr_radius ** 2)
    k = cfg.bond_cap

    def onehot(mask):
        dest = jnp.cumsum(mask, axis=1) - 1
        return (dest[:, :, None] == jnp.arange(k)[None, None, :]) & mask[:, :, None]

    @jax.jit
    def int_sum(cand, mask):
        return jnp.sum(jnp.where(onehot(mask), cand.astype(jnp.int32)[:, :, None], 0), axis=1)

    @jax.jit
    def einsum_highest(cand, mask):
        return jnp.einsum("cwk,cw->ck", onehot(mask).astype(jnp.float32), cand,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32).astype(jnp.int32)

    out = {"shape": list(cand.shape), "bond_cap": k}
    ref = None
    for name, fn in (("int32_masked_sum", int_sum), ("f32_einsum_highest", einsum_highest)):
        r = fn(cand, mask).block_until_ready()
        ref = r if ref is None else ref
        assert np.array_equal(np.asarray(r), np.asarray(ref)), name
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(cand, mask)
        r.block_until_ready()
        out[name + "_ms"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", type=int, nargs="+", default=[100_000, 500_000])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--out", default="chiprun_out/profile")
    p.add_argument("--keep-traces", action="store_true")
    p.add_argument("--compaction", action="store_true")
    args = p.parse_args()

    os.makedirs(args.out, exist_ok=True)
    dev = bench.device_info()
    result = {"device": dev}
    if dev["platform"] == "gpu":
        result["nvidia_smi"] = bench.gpu_name_and_power_limit()
    print(json.dumps(result), flush=True)
    for n in args.cells:
        r = profile_size(n, args.steps, args.out, args.keep_traces)
        result[str(n)] = r
        print(json.dumps(r), flush=True)
    if args.compaction:
        result["compaction"] = time_compaction(args.cells[0])
        print(json.dumps(result["compaction"]), flush=True)
    with open(os.path.join(args.out, "layers.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
