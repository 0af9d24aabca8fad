"""Smoke run of the hiPSC engine on one GPU, in one process that owns it.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the tile-decomposed
                                        # engine against one card, only

Phases (one card), in order; any failure raises and exits non-zero:

1. the device: ``jax.devices()``, the card's name and power limit from
   ``nvidia-smi``, the JAX version and the compile-cache directory. A
   platform other than ``gpu`` exits non-zero (there is no CPU fallback);
2. the main path through the normal entry point: the reference default
   experiment (5,000 cells in a 2000x2000 um box, every output on) through
   ``CellSimulation.start`` in a scratch copy of ``examples/templates``,
   cut to ``END_STEP`` steps with doxycycline inside that window;
3. the headline sizes on the engine API (bench.py's reference-density
   configuration with diffusion) at 100k and 500k cells: set-up seconds,
   timed ``safe_step`` and ``run_steps`` windows, peak device memory;
4. correctness checks (a)-(g) on the card, each with its tolerance.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The check functions take their sizes as arguments, so the tests run them at
small sizes on the CPU (``tests/test_chip_smoke.py``) and, marked ``gpu``,
at these sizes on a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

import bench
from hipsc_abm.engine import HipscEngine, config_from_meta, config_to_meta
from hipsc_abm.models.params import ExperimentalParams, GeneralParams
from hipsc_abm.ops import diffusion as diffusion_ops
from hipsc_abm.ops import jkr as jkr_ops
from hipsc_abm.ops import neighbors as nbr_ops

REPO = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(REPO, ".chip_smoke")  # listed in .gitignore
END_STEP = 10  # cut from the template's 192
DOX_STEP = 5  # moved from the template's 49 into the cut window
HEADLINE_SIZES = (100_000, 500_000)
DENSE_CELLS = 11_000  # capacity ~16k: the (C, C) dense-pairs arrays fit
CPU_CELLS = 20_000  # one step on the host CPU stays under a minute
FOUR_CARD_CELLS = 2_000_000


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _host(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _by_id(state) -> dict:
    """{field: alive values in agent-id order}: the layout-free form."""
    s = _host(state)
    alive = s.alive
    ids = s.arrays["ids"][alive]
    order = np.argsort(ids)
    out = {k: v[alive][order] for k, v in s.arrays.items()}
    bonds = np.where(s.bonds.mask, s.bonds.partners, -1)[alive][order]
    out["bond_sets"] = [frozenset(r[r >= 0].tolist()) for r in bonds]
    return out


_INT_FIELDS = ("ids", "FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states",
               "death_counters", "diff_counters", "div_counters",
               "fds_counters")


def assert_same_colony(a, b, label: str, loc_atol: float = 0.0,
                       loc_rtol: float = 0.0) -> float:
    """Same agents, bit-equal integer fields and bond sets; positions equal
    to ``loc_atol + loc_rtol * |x|`` (both 0.0: bit-exact). Returns the max
    position difference."""
    ca, cb = _by_id(a), _by_id(b)
    assert ca["ids"].shape == cb["ids"].shape, (
        f"{label}: {ca['ids'].shape[0]} vs {cb['ids'].shape[0]} agents")
    for k in _INT_FIELDS:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=f"{label}: {k}")
    assert ca["bond_sets"] == cb["bond_sets"], f"{label}: bond sets differ"
    la, lb = ca["locations"], cb["locations"]
    diff = float(np.max(np.abs(la - lb), initial=0.0))
    if loc_atol == 0.0 and loc_rtol == 0.0:
        np.testing.assert_array_equal(la, lb, err_msg=f"{label}: locations")
    else:
        np.testing.assert_allclose(la, lb, rtol=loc_rtol, atol=loc_atol,
                                   err_msg=f"{label}: locations")
    return diff


def assert_trees_bit_equal(a, b, label: str) -> None:
    import jax

    la, lb = jax.tree_util.tree_leaves(_host(a)), jax.tree_util.tree_leaves(_host(b))
    assert len(la) == len(lb), label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and np.array_equal(x, y), f"{label}: leaf {i}"


def colony_engine(n_cells: int, diffusion: bool = False) -> HipscEngine:
    """``n_cells`` (+10% GATA6-high) at the reference default density."""
    if diffusion:
        return bench.reference_density_engine(n_cells)
    side = 2000.0 * (n_cells / 5000.0) ** 0.5
    gen = GeneralParams(num_to_start=n_cells, end_step=200,
                        size=(side, side, 0.0))
    return HipscEngine(gen, ExperimentalParams(num_gata6=n_cells // 10,
                                               dox_step=5))


def data_sized_spec(spec, locations, alive):
    """``spec`` with its run cap sized from the live agents (the engine's
    own rule), so a one-off window cannot overflow."""
    import dataclasses

    from hipsc_abm.engine import _initial_run_cap

    live = np.asarray(locations)[np.asarray(alive)]
    return dataclasses.replace(spec, run_cap=_initial_run_cap(live, spec))


def stepped(eng: HipscEngine, steps: int, seed: int = 0):
    state = eng.init_state(seed=seed)
    for _ in range(steps):
        state, _ = eng.safe_step(state)
    return state


# ---------------------------------------------------------------------------
# phase 2: the reference default experiment through CellSimulation.start
# ---------------------------------------------------------------------------


def write_default_templates(tdir: str, end_step: int = END_STEP,
                            dox_step: int = DOX_STEP,
                            overrides: dict | None = None) -> dict:
    """Copy ``examples/templates`` into ``tdir`` with the cut step window,
    every output on, and diffusion on with the template's commented-out
    settings (the gradient CSVs are written only when diffusion runs)."""
    from hipsc_abm.utils.config import template_params

    src = os.path.join(REPO, "examples", "templates")
    os.makedirs(tdir, exist_ok=True)
    gen = template_params(os.path.join(src, "general.yaml"))
    exp = template_params(os.path.join(src, "experimental.yaml"))
    gen.update(end_step=end_step, output_values=True, output_images=True,
               record_initial_step=True)
    exp.update(dox_step=dox_step, output_tda=True, output_gradients=True,
               enable_diffusion=True, spat_res=10.0, diffuse_dt=6.0,
               diffuse_const=2.0, max_concentration=2.0, degradation=0.1)
    for key, value in (overrides or {}).items():
        (gen if key in gen else exp)[key] = value
    for name, keys in (("general.yaml", gen), ("experimental.yaml", exp)):
        with open(os.path.join(tdir, name), "w") as f:
            f.writelines(f"{k}: {json.dumps(v)}\n" for k, v in keys.items())
    return {**gen, **exp}


def run_default_experiment(workdir: str, overrides: dict | None = None) -> dict:
    """Run the cut default experiment in ``workdir`` (templates/, outputs/)
    and check its outputs and population. Returns a summary dict."""
    from hipsc_abm.models.hipsc import CellSimulation

    keys = write_default_templates(os.path.join(workdir, "templates"),
                                   overrides=overrides)
    out = os.path.join(workdir, "outputs") + os.sep
    os.makedirs(out, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        sim = CellSimulation.start(out, argv=["-n", "smoke", "-m", "0"])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    base = os.path.join(out, "smoke")
    end = keys["end_step"]
    for step in (0, end):
        for path in (f"smoke_values/smoke_values_{step}.csv",
                     f"smoke_images/smoke_image_{step}.png"):
            assert os.path.isfile(os.path.join(base, path)), path
    for split in ("red", "green", "all"):
        path = f"smoke_tda/{split}/smoke_tda_{split}_{end}.csv"
        assert os.path.isfile(os.path.join(base, path)), path
    grad = os.path.join(base, "smoke_gradients", "fgf4_values",
                        f"smoke_fgf4_values_{end}.csv")
    assert os.path.isfile(grad), grad
    assert np.isfinite(np.loadtxt(grad, delimiter=",")).all()
    with open(os.path.join(base, "smoke_data.csv")) as f:
        rows = f.read().strip().splitlines()
    assert len(rows) == end + 1, f"data CSV has {len(rows)} lines"
    n0 = keys["num_to_start"] + keys["num_gata6"]
    n = sim.number_agents
    assert n0 // 2 <= n <= 4 * n0, f"population {n} from {n0}"
    locs = np.asarray(sim.locations)[:n]
    size = np.asarray(keys["size"], float)
    assert np.isfinite(locs).all()
    assert (locs >= 0).all() and (locs <= size + 1e-3).all()
    return {"agents_start": n0, "agents_end": n, "steps": end,
            "wall_s": wall, "video": os.path.isfile(
                os.path.join(base, "smoke_video.mp4"))}


# ---------------------------------------------------------------------------
# (a) neighbour window vs brute force
# ---------------------------------------------------------------------------


def check_neighbors(locations: np.ndarray, alive: np.ndarray, size,
                    radius: float = 15.0, block: int = 512) -> dict:
    """The XLA neighbour window (``neighbors.neighbor_search``) against an
    O(n^2) brute force computed on the device in row blocks.

    Exact per-row neighbour counts are required, except where a pair's f32
    squared distance lies within 4 ulp of radius^2: there either side is a
    correct f32 answer, so such rows are bracketed between the brute counts
    at radius^2 (1 -/+ 1e-6). Every window neighbour must also be a distinct,
    alive, non-self agent within the radius."""
    import jax
    import jax.numpy as jnp

    locs = jnp.asarray(locations, jnp.float32)
    spec = data_sized_spec(nbr_ops.GridSpec.from_box(tuple(size), radius, 8),
                           locations, alive)
    alive = jnp.asarray(alive)
    search = jax.jit(nbr_ops.neighbor_search, static_argnums=(0, 3))
    cand, mask, max_run = search(spec, locs, alive, radius)
    assert int(max_run) <= spec.run_cap, "window overflowed its run cap"
    win_count = np.asarray(jnp.sum(mask, axis=1))

    cap = locs.shape[0]
    pad = (-cap) % block
    rows = jnp.pad(locs, ((0, pad), (0, 0)))
    r2 = jnp.float32(radius) ** 2

    @jax.jit
    def brute_counts(rows):
        def one(blk):
            i0, xs = blk
            delta = locs[None, :, :] - xs[:, None, :]
            d2 = jnp.sum(delta * delta, axis=-1)
            ok = alive[None, :] & (
                jnp.arange(cap)[None, :] != (i0 + jnp.arange(block))[:, None])
            return tuple(jnp.sum(ok & (d2 <= r2 * f), axis=1)
                         for f in (1.0 - 1e-6, 1.0, 1.0 + 1e-6))
        starts = jnp.arange(0, cap + pad, block)
        lo, ex, hi = jax.lax.map(one, (starts, rows.reshape(-1, block, 3)))
        return lo.reshape(-1)[:cap], ex.reshape(-1)[:cap], hi.reshape(-1)[:cap]

    lo, ex, hi = (np.asarray(x) for x in brute_counts(rows))
    al = np.asarray(alive)
    win_count = np.where(al, win_count, 0)
    lo, ex, hi = (np.where(al, x, 0) for x in (lo, ex, hi))
    assert ((lo <= win_count) & (win_count <= hi)).all(), "window misses pairs"
    boundary_rows = int(np.sum(win_count != ex))
    ambiguous = int(np.sum(lo != hi))
    assert boundary_rows <= ambiguous

    # every window neighbour is real: alive, in range, not self, distinct
    ci = np.asarray(cand)
    m = np.asarray(mask) & al[:, None]
    assert al[ci[m]].all()
    assert not (ci == np.arange(cap)[:, None])[m].any()
    srt = np.sort(np.where(m, ci, -1 - np.arange(ci.shape[1])[None, :]), axis=1)
    assert not (srt[:, 1:] == srt[:, :-1]).any(), "duplicate candidates"
    return {"agents": int(al.sum()), "pairs": int(win_count.sum()) // 2,
            "rows_at_radius_boundary": boundary_rows}


# ---------------------------------------------------------------------------
# (b) one physics substep vs the pair-force oracle; windowed vs dense
# ---------------------------------------------------------------------------


def jkr_forces_f64(locs: np.ndarray, radii: np.ndarray, radius: float, bio):
    """float64 JKR forces of every fresh contact (no prior bonds) — the
    pair law of ``tests/test_jkr.py``'s oracle, vectorised over the pairs
    a k-d tree finds. Returns (forces (n, 3), |f| sums (n,), ambiguous (n,)
    rows with a pair on an f32-rounding boundary, the force scale
    pi * adhesion * r_hat of the largest radius pair in N)."""
    import math

    from scipy.spatial import cKDTree

    i, j = cKDTree(locs).query_pairs(radius * (1 + 1e-5), output_type="ndarray").T
    vec = locs[i] - locs[j]
    mag = np.linalg.norm(vec, axis=1)
    r1, r2 = radii[i], radii[j]
    overlap = (r1 + r2 - mag) / 1e6
    e_hat = 1.0 / (2.0 * (1.0 - bio.poisson ** 2) / bio.youngs)
    r_hat = 1.0 / (1e6 * (1.0 / r1 + 1.0 / r2))
    scale = ((math.pi * bio.adhesion_const) / e_hat) ** (2 / 3) * r_hat ** (1 / 3)
    d = overlap / scale
    keep = (mag <= radius) & (d > bio.jkr_break_d)
    f = ((-0.0204 * d + 0.4942) * d + 1.0801) * d - 1.324
    fvec = np.where(keep, f * math.pi * bio.adhesion_const * r_hat, 0.0)[:, None] * (
        vec / mag[:, None])
    n = len(locs)
    forces = np.zeros((n, 3))
    np.add.at(forces, i, fvec)
    np.add.at(forces, j, -fvec)
    mags = np.zeros(n)
    np.add.at(mags, i, np.abs(fvec).sum(1))
    np.add.at(mags, j, np.abs(fvec).sum(1))
    edge = (np.abs(mag - radius) <= 1e-4 * radius) | (np.abs(d - bio.jkr_break_d) <= 1e-4)
    amb = np.zeros(n, bool)
    amb[i[edge]] = True
    amb[j[edge]] = True
    f_scale = math.pi * bio.adhesion_const * float(r_hat.max(initial=0.0))
    return forces, mags, amb, f_scale


def check_contact_substep(state, eng: HipscEngine) -> dict:
    """One contact substep of the engine's XLA path (``jkr_substep`` over a
    fresh window, empty bond set) against the float64 pair-force oracle.
    Tolerance per row: 1e-4 of the sum of the row's |pair force| components
    plus 1e-5 of the force scale pi * adhesion * r_hat. The nondimensional
    overlap d comes from an f32 distance (error ~1e-6 um against an
    overlap scale of ~0.9 um), so each pair force carries an absolute error
    of ~1e-6 of that scale, which dominates near the cubic's root; f32
    summation of a handful of terms adds ~1e-6 relative. Rows with a pair
    within 1e-4 of the search radius or the break threshold are excluded
    (f32 may classify them either way) and counted."""
    import jax
    import jax.numpy as jnp

    s = _host(state)
    alive = s.alive
    locs = s.arrays["locations"][alive].astype(np.float32)
    radii = s.arrays["radii"][alive].astype(np.float32)
    n = len(locs)
    bio = eng.bio
    spec = data_sized_spec(eng.cfg.jkr_spec, locs, np.ones(n, bool))
    ids = jnp.arange(n, dtype=jnp.int32)

    @jax.jit
    def substep(locs, radii):
        grid, pos, valid, max_run = nbr_ops.sorted_window(
            spec, locs, ids, jnp.ones((n,), bool))
        packed = jkr_ops.pack_physics(locs, radii, ids, jnp.ones((n,), bool))
        forces, _, _ = jkr_ops.jkr_substep(
            jkr_ops.BondState.empty(n, eng.cfg.bond_cap), packed, grid.order,
            pos, valid, bio.jkr_radius, bio.adhesion_const, bio.poisson,
            bio.youngs, bio.jkr_break_d)
        return forces, max_run

    got, max_run = substep(jnp.asarray(locs), jnp.asarray(radii))
    assert int(max_run) <= spec.run_cap, "contact window overflowed"
    got = np.asarray(got, np.float64)
    want, mags, amb, f_scale = jkr_forces_f64(
        locs.astype(np.float64), radii.astype(np.float64), bio.jkr_radius, bio)
    err = np.abs(got - want).max(axis=1)
    tol = 1e-4 * mags + 1e-5 * f_scale
    bad = (err > tol) & ~amb
    assert not bad.any(), (
        f"{int(bad.sum())} rows off the oracle; worst err/tol "
        f"{float(np.max(err[bad] / tol[bad]))}")
    return {"agents": n, "max_err_over_tol": float(np.max(err[~amb] / tol[~amb],
                                                         initial=0.0)),
            "max_err_over_force_scale": float(err[~amb].max(initial=0.0) / f_scale),
            "rows_excluded_at_boundary": int(amb.sum())}


def check_dense_vs_windowed(n_cells: int, warmup: int = 2, seed: int = 3) -> dict:
    """One full step from the same state through the windowed XLA physics
    and through ``dense_pairs`` (all pairs). Ids, integer fields and bond
    sets must match exactly; positions to 1e-3 um: the two paths sum a
    row's pair forces in different orders (slot order vs window order), a
    few f32 ulp per substep over 11 substeps."""
    import dataclasses

    eng = colony_engine(n_cells)
    state = stepped(eng, warmup, seed=seed)
    win, _ = eng.safe_step(state)
    dense = HipscEngine(eng.gen, eng.xp, cfg=dataclasses.replace(
        eng.cfg, dense_pairs=True))
    den, _ = dense.safe_step(state)
    diff = assert_same_colony(win, den, "dense vs windowed", loc_atol=1e-3)
    return {"agents": int(np.asarray(win.alive).sum()),
            "capacity": int(state.capacity), "max_pos_diff_um": diff}


# ---------------------------------------------------------------------------
# (c) bond partner ids are exact
# ---------------------------------------------------------------------------


def compact_bonds_reference(cand_ids: np.ndarray, mask: np.ndarray, k: int):
    """numpy first-k compaction of each row's masked candidate ids."""
    partners = np.zeros((cand_ids.shape[0], k), np.int64)
    keep = np.zeros((cand_ids.shape[0], k), bool)
    for r in range(cand_ids.shape[0]):
        sel = cand_ids[r][mask[r]][:k]
        partners[r, :len(sel)] = sel
        keep[r, :len(sel)] = True
    return partners, keep


def check_bond_ids(state, eng: HipscEngine) -> dict:
    """Every stored bond names an alive agent, bonds are symmetric (each is
    stored once per endpoint), and ids reach far past 2^11 (where TF32
    would start to corrupt them). Then the engine's compaction of a real
    window, on the device, equals the numpy reference exactly."""
    import jax
    import jax.numpy as jnp

    s = _host(state)
    alive = s.alive
    ids = s.arrays["ids"]
    alive_ids = set(ids[alive].tolist())
    rows, cols = np.nonzero(s.bonds.mask & alive[:, None])
    part = s.bonds.partners[rows, cols]
    assert set(part.tolist()) <= alive_ids, "bond names a dead/unknown agent"
    pairs = set(zip(ids[rows].tolist(), part.tolist()))
    assert all((b, a) in pairs for a, b in pairs), "bonds not symmetric"
    assert int(part.max(initial=0)) > 1 << 11, "ids never passed 2^11"

    cfg = eng.cfg
    spec = data_sized_spec(cfg.jkr_spec, s.arrays["locations"], alive)
    loc = jnp.asarray(s.arrays["locations"])
    grid, pos, valid, _ = jax.jit(nbr_ops.sorted_window, static_argnums=0)(
        spec, loc, jnp.asarray(ids), jnp.asarray(alive))
    packed = jkr_ops.pack_physics(loc, jnp.asarray(s.arrays["radii"]),
                                  jnp.asarray(ids), jnp.asarray(alive))
    cand = jkr_ops.window_cand_ids(packed, grid.order, pos)
    d2 = jnp.sum((packed[grid.order][pos][..., :3] - loc[:, None, :]) ** 2, -1)
    mask = valid & (d2 <= eng.bio.jkr_radius ** 2) & jnp.asarray(alive)[:, None]
    bonds, _ = jax.jit(jkr_ops.window_mask_to_bonds, static_argnums=2)(
        cand, mask, cfg.bond_cap)
    want_p, want_k = compact_bonds_reference(
        np.asarray(cand).astype(np.int64), np.asarray(mask), cfg.bond_cap)
    np.testing.assert_array_equal(np.asarray(bonds.mask), want_k)
    np.testing.assert_array_equal(
        np.where(want_k, np.asarray(bonds.partners), 0), np.where(want_k, want_p, 0))
    return {"bonds": len(pairs), "max_partner_id": int(part.max(initial=0))}


# ---------------------------------------------------------------------------
# (d) FTCS vs float64 numpy
# ---------------------------------------------------------------------------


def ftcs_f64(grid: np.ndarray, dts, diffuse_const, spat_res2, max_conc,
             degradation) -> np.ndarray:
    """float64 numpy FTCS with the reference's semantics: clamp, zero ghost
    ring, sequential edge reflection, 5-point stencil, degradation."""
    base = np.pad(np.clip(grid.astype(np.float64), 0.0, max_conc), 1)
    for dt in dts:
        a = float(dt) * diffuse_const / spat_res2
        base[:, 0] = base[:, 1]
        base[:, -1] = base[:, -2]
        base[0, :] = base[1, :]
        base[-1, :] = base[-2, :]
        lap = base[2:, 1:-1] + base[:-2, 1:-1] + base[1:-1, 2:] + base[1:-1, :-2]
        base[1:-1, 1:-1] = (1.0 - 4.0 * a) * base[1:-1, 1:-1] + a * lap
    return base[1:-1, 1:-1] * (1.0 - degradation)


def check_ftcs(grid: np.ndarray, eng: HipscEngine) -> dict:
    """``ftcs_diffuse`` on the device against ``ftcs_f64`` for one step's
    subcycles. Tolerance 1e-5 of max_concentration: each subcycle is a
    convex combination (a <= 1/4) rounded once in f32 (~6e-8 relative), so
    ~300 subcycles stay below ~2e-5 relative even if every rounding
    added up; clamped-to-zero borders add nothing."""
    import jax.numpy as jnp

    from hipsc_abm.engine import diffusion_dts_cached

    d = eng.diff
    dts = diffusion_dts_cached(eng.bio.step_dt, d.diffuse_dt)
    got = np.asarray(diffusion_ops.ftcs_diffuse(
        jnp.asarray(grid, jnp.float32), jnp.asarray(dts), d.diffuse_const,
        d.spat_res2, d.max_concentration, d.degradation))
    want = ftcs_f64(np.asarray(grid), dts, d.diffuse_const, d.spat_res2,
                    d.max_concentration, d.degradation)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * d.max_concentration, f"FTCS off by {err}"
    assert float(want.max()) > 0, "empty lattice: nothing was compared"
    return {"lattice": list(grid.shape), "subcycles": len(dts),
            "max_abs_err": err, "max_value": float(want.max())}


# ---------------------------------------------------------------------------
# (e) GPU vs CPU; (f) run-to-run determinism; (g) checkpoint/resume
# ---------------------------------------------------------------------------


def check_gpu_vs_cpu(n_cells: int, warmup: int = 2) -> dict:
    """One step from the same state on the default device and on the CPU
    device of this process. Ids, integer fields and bond sets must be
    identical (every discrete decision in one step reads the incoming
    positions, which are equal); positions within 1e-3 um: transcendental
    functions and reduction orders differ by ulps between backends, over
    11 substeps."""
    import jax

    eng = colony_engine(n_cells, diffusion=True)
    state = stepped(eng, warmup)
    on_dev, _ = eng.safe_step(state)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        eng_cpu = HipscEngine(eng.gen, eng.xp, diff=eng.diff, cfg=eng.cfg)
        on_cpu, _ = eng_cpu.safe_step(jax.device_put(state, cpu))
    assert next(iter(on_cpu.alive.devices())) == cpu
    diff = assert_same_colony(on_dev, on_cpu, "device vs cpu", loc_atol=1e-3)
    return {"agents": int(np.asarray(on_dev.alive).sum()),
            "device": str(next(iter(on_dev.alive.devices()))),
            "max_pos_diff_um": diff}


def check_determinism(eng: HipscEngine, steps: int, seed: int = 0) -> dict:
    """The same seed run twice through the same compiled steps gives the
    bit-identical colony (agents, integer fields, bonds, positions) and the
    bit-identical morphogen lattice. Compared by agent id: the second run
    may start from the first run's grown capacities, which leaves the
    dynamics unchanged but not the slot layout."""
    a = stepped(eng, steps, seed=seed)
    b = stepped(eng, steps, seed=seed)
    assert_same_colony(a, b, "same-seed rerun")
    for name in a.gradients:
        np.testing.assert_array_equal(np.asarray(a.gradients[name]),
                                      np.asarray(b.gradients[name]),
                                      err_msg=f"same-seed rerun: {name}")
    return {"steps": steps, "agents": int(np.asarray(a.alive).sum())}


def check_resume(eng: HipscEngine, state, path: str, steps: int = 2) -> dict:
    """Checkpoint to npz, continue ``steps`` steps; reload into a fresh
    engine with the saved configuration, continue; bit-identical."""
    from hipsc_abm.utils.checkpoint import load_state, save_state

    save_state(path, state, meta={"engine_config": config_to_meta(eng.cfg)})
    cont = state
    for _ in range(steps):
        cont, _ = eng.safe_step(cont)
    restored, meta = load_state(path)
    eng2 = HipscEngine(eng.gen, eng.xp, diff=eng.diff,
                       cfg=config_from_meta(meta["engine_config"]))
    assert_trees_bit_equal(restored, state, "reloaded checkpoint")
    for _ in range(steps):
        restored, _ = eng2.safe_step(restored)
    assert_trees_bit_equal(cont, restored, "resumed run")
    return {"steps": steps}


# ---------------------------------------------------------------------------
# four cards: the tile-decomposed engine against one card
# ---------------------------------------------------------------------------


def check_four_cards(n_cells: int, steps: int = 3, seed: int = 0) -> dict:
    """``DomainHipscEngine(tiles=(2, 2))`` over four devices against
    ``HipscEngine`` on device 0, same seed, ``steps`` steps, with diffusion.
    Agents, integer fields and bond sets must be bit-identical (the
    decomposition reproduces the single-device candidate order). Positions
    are compared to 1e-6 relative + 1e-6 um: on the GPU the per-tile
    programs are compiled for other shapes than the single-device one, and
    XLA may contract a multiply-add into an FMA in one and not the other,
    so a few coordinates differ by an ulp (measured on four H100s: 1 of
    6.8M coordinates, by 1.8e-7 um, after 3 steps) and such a difference
    spreads only by ulps over a few steps. The replicated morphogen lattice
    sums per-tile deposits with a psum, so it is compared to 1e-5 of
    max_concentration."""
    import jax

    from hipsc_abm.parallel.domain_engine import DomainHipscEngine

    devs = jax.devices()
    assert len(devs) >= 4, f"need 4 devices, have {len(devs)}"
    ref = bench.reference_density_engine(n_cells)
    dom = DomainHipscEngine(ref.gen, ref.xp, diff=ref.diff,
                            enable_diffusion=True, tiles=(2, 2))
    dstate = dom.init_state(seed=seed)
    single = HipscEngine(ref.gen, ref.xp, diff=ref.diff, cfg=dom.cfg.base)
    sstate = single.init_state(seed=seed)
    t0 = time.perf_counter()
    for _ in range(steps):
        sstate, _ = single.safe_step(sstate)
    jax.block_until_ready(sstate)
    single_s = time.perf_counter() - t0
    single_host = _host(sstate)
    del sstate
    t0 = time.perf_counter()
    for _ in range(steps):
        dstate, info = dom.safe_step(dstate)
    jax.block_until_ready(dstate)
    dom_s = time.perf_counter() - t0
    per_dev = {str(d) for leaf in jax.tree_util.tree_leaves(dstate.arrays)
               for d in leaf.devices()}
    assert len(per_dev) == 4, f"tile state lives on {sorted(per_dev)}"
    flat = dom.to_cell_state(dstate)
    la = _by_id(flat)["locations"]
    lb = _by_id(single_host)["locations"]
    not_bit_equal = int(np.sum(la != lb)) if la.shape == lb.shape else -1
    say(f"four cards: {not_bit_equal} of {la.size} coordinates not "
        "bit-equal to one card")
    diff = assert_same_colony(flat, single_host, "4 tiles vs 1 card",
                              loc_atol=1e-6, loc_rtol=1e-6)
    for name, g in single_host.gradients.items():
        gd = np.asarray(jax.device_get(dstate.gradients[name]))
        err = float(np.abs(gd - g).max())
        assert err <= 1e-5 * ref.diff.max_concentration, f"{name}: {err}"
        assert float(g.max()) > 0
    return {"agents": int(single_host.alive.sum()), "steps": steps,
            "devices": sorted(per_dev), "coords_not_bit_equal": not_bit_equal,
            "max_pos_diff_um": diff, "single_wall_s": single_s,
            "domain_wall_s": dom_s}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _phase(name: str, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    shown = {k: v for k, v in (out or {}).items()
             if k not in ("state", "engine")}
    say(f"PASS {name} ({time.perf_counter() - t0:.1f} s): {json.dumps(shown)}")
    return out


def run_one_card() -> None:
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    _phase("main path: default experiment via CellSimulation.start "
           f"(5000 cells, 2000x2000 um, all outputs, end_step {END_STEP}, "
           f"dox_step {DOX_STEP})", run_default_experiment,
           os.path.join(SCRATCH, "default"))

    runs = {}
    for n in HEADLINE_SIZES:
        runs[n] = _phase(f"headline {n} cells (setup, safe_step, run_steps)",
                         bench.time_full_model, n)
    eng100, s100 = runs[HEADLINE_SIZES[0]]["engine"], runs[HEADLINE_SIZES[0]]["state"]
    eng500, s500 = runs[HEADLINE_SIZES[1]]["engine"], runs[HEADLINE_SIZES[1]]["state"]

    h = _host(s100)
    _phase("(a) neighbour window == brute force at 100k", check_neighbors,
           h.arrays["locations"], h.alive, eng100.gen.size)
    _phase("(b) contact substep == f64 pair-force oracle at 100k",
           check_contact_substep, s100, eng100)
    _phase(f"(b) windowed == dense_pairs ({DENSE_CELLS} cells)",
           check_dense_vs_windowed, DENSE_CELLS)
    _phase("(c) bond partner ids exact at 100k", check_bond_ids, s100, eng100)
    _phase("(d) ftcs_diffuse == f64 numpy on the 500k lattice", check_ftcs,
           np.asarray(s500.gradients["fgf4_values"]), eng500)
    del runs, s500, eng500
    _phase(f"(e) device step == CPU step ({CPU_CELLS} cells)",
           check_gpu_vs_cpu, CPU_CELLS)
    _phase("(f) same seed twice: bit-identical at 100k with diffusion",
           check_determinism, eng100, 3)
    _phase("(g) checkpoint + resume bit-exact at 100k", check_resume, eng100,
           s100, os.path.join(SCRATCH, "ck.npz"))
    shutil.rmtree(SCRATCH, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-device tile decomposition "
                             "against one device")
    args = parser.parse_args(argv)

    import jax

    devs = jax.devices()
    dev = bench.device_info()
    say("jax.devices():", devs)
    say(f"platform={dev['platform']} device_kind={dev['kind']} "
        f"count={dev['count']}")
    if dev["platform"] != "gpu":
        say(f"FAIL: no GPU (platform {dev['platform']!r}); this smoke run "
            "has no CPU fallback")
        return 2
    from hipsc_abm.utils.config import ensure_compilation_cache

    ensure_compilation_cache()
    say("jax", jax.__version__, "compile cache:",
        jax.config.jax_compilation_cache_dir)
    say("nvidia-smi:", bench.gpu_name_and_power_limit())

    if args.four_cards:
        _phase(f"four cards: tiles (2, 2) vs one card at {FOUR_CARD_CELLS} "
               "cells", check_four_cards, FOUR_CARD_CELLS)
    else:
        run_one_card()
    say("peak_bytes_in_use (device 0):", bench.peak_bytes_in_use())
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
