"""The engine: a fused, jit-compiled simulation step over a fixed-capacity
struct-of-arrays state PyTree resident in device memory.

This replaces the reference's per-step driver
(``cell_simulation.py:77-126``) plus its entire L0/L1 compute tier: instead of
ten Python methods each bouncing between numpy, igraph and Numba/CUDA kernels
with host<->device copies on every call (``simulation.py:249-274``), the whole
step — neighbor search, division, death, FDS pathway, differentiation,
motility, 11 physics substeps of JKR contact + Stokes integration, and
optional morphogen diffusion — is one pure function ``step(state) -> state``
traced once by XLA. Dynamic population lives in an ``alive`` mask over
preallocated slots; the reference's adaptive-capacity retry loops
(``simulation.py:198-221,242-281``) become on-device overflow probes checked
by the host between steps, with exact re-execution after capacity doubling.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hipsc_abm.models import biology
from hipsc_abm.models.params import (
    BiologyParams,
    DiffusionParams,
    ExperimentalParams,
    GeneralParams,
)
from hipsc_abm.ops import diffusion as diffusion_ops
from hipsc_abm.ops import neighbors as nbr_ops
from hipsc_abm.ops import jkr as jkr_ops
from hipsc_abm.ops.integrate import stokes_integrate
from hipsc_abm.ops.jkr import (
    BondState,
    clear_bond_rows,
    pack_physics,
)
from hipsc_abm.ops.neighbors import GridSpec


class CellState(NamedTuple):
    """Complete simulation state as a PyTree (bit-exact checkpointable).

    ``arrays["ids"]`` holds stable, never-recycled agent ids: all randomness
    is id-keyed (``ops.rng``) and bonds store partner ids, so dynamics are
    independent of slot layout — the property the domain-decomposed engine
    relies on. ``next_id`` is the id the next daughter born will receive."""

    arrays: Dict[str, jnp.ndarray]  # per-agent slot arrays (SoA)
    alive: jnp.ndarray  # (C,) bool slot occupancy
    bonds: BondState  # persistent JKR bond graph
    gradients: Dict[str, jnp.ndarray]  # morphogen lattices
    key: jax.Array  # jax.random key threaded through all stochastic phases
    step: jnp.ndarray  # int32 current step counter
    next_id: jnp.ndarray  # int32 scalar: first unassigned agent id

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def num_agents(self) -> int:
        return int(jnp.sum(self.alive))


# per-agent arrays of the hiPSC model and their dtypes / vector widths
# (reference ``cell_simulation.py:136-149``; "ids" is engine-internal —
# stable agent identity for id-keyed RNG and the bond graph)
HIPSC_ARRAY_SPECS: Dict[str, Tuple[object, Optional[int]]] = {
    "ids": (jnp.int32, None),
    "locations": (jnp.float32, 3),
    "radii": (jnp.float32, None),
    "FGF4": (jnp.int32, None),
    "FGFR": (jnp.int32, None),
    "ERK": (jnp.int32, None),
    "GATA6": (jnp.int32, None),
    "NANOG": (jnp.int32, None),
    "states": (jnp.int32, None),
    "death_counters": (jnp.int32, None),
    "diff_counters": (jnp.int32, None),
    "div_counters": (jnp.int32, None),
    "fds_counters": (jnp.int32, None),
    "motility_forces": (jnp.float32, 3),
    "jkr_forces": (jnp.float32, 3),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape/capacity configuration (hashable; changing any field
    recompiles the step, mirroring the reference's Numba re-JIT on new
    capacities)."""

    capacity: int
    nbr_spec: GridSpec  # biology neighbor graph, radius 15
    jkr_spec: GridSpec  # contact graph, bin = 2 * max_radius + verlet_skin
    bond_cap: int
    two_d: bool
    # static cap on divisions per step (sizes the rank-compressed daughter
    # tables in biology.cell_division; grown on the num_dividing probe)
    div_cap: int = 0  # 0 -> derived from capacity in create()
    # Verlet skin (um): the contact window is built over bins of
    # (search radius + skin) from reference positions and reused across
    # physics substeps until any agent drifts more than skin/2 — then a
    # lax.cond rebuilds it. Contacts are always re-tested at the true radius
    # with current positions, so physics is exact; the skin only bounds how
    # long a window provably covers all true contacts (wider skin: fewer
    # rebuilds, wider windows). 14 um was chosen by a sweep on an earlier
    # accelerator and has not been swept on the GPU.
    verlet_skin: float = 14.0
    enable_growth: bool = False  # reference ships these disabled
    enable_stochastic: bool = False  # (cell_simulation.py:98-100);
    enable_diff_surround: bool = False  # config-enabled here
    enable_diffusion: bool = False
    # All-pairs O(C^2) physics (no neighbor window, no gathers) for SMALL
    # colonies (<= a few thousand slots), where the windowed path's
    # sorts and gathers cost more than the pairwise arithmetic — 110
    # sequential substeps per vmapped calibration rollout. See
    # engine._physics_scan_dense.
    dense_pairs: bool = False
    # bond band margin (um): when set, only pairs beyond (search radius -
    # margin) are stored in the persistent bond matrix — deeper pairs are
    # re-eligible by the fresh-contact distance test before they can cross
    # the radius, so their bond entry is redundant
    # (ops.jkr.jkr_substep_aligned). Must exceed one substep's max pair
    # separation change plus one division displacement (probed via
    # StepInfo.max_substep_move, grown on violation). Measured: at
    # reference colony densities the required safe margin (>= 2 division
    # displacements ~ 3 um) makes the band most of the contact annulus, so
    # banding does NOT shrink K in practice — default None = store the full
    # edge set (the reference's literal graph). Kept as an option for
    # low-density / no-division workloads where it halves bond bookkeeping.
    bond_band_margin: Optional[float] = None
    # Rematerialize each physics substep under reverse-mode AD
    # (``lax.scan(jax.checkpoint(substep))``): residuals for the 11-substep
    # scan are recomputed from the carry during the backward pass instead
    # of being saved per substep. Forward-only cost: none (checkpoint is
    # the identity outside AD). The calibration gradient path enables this
    # — measured at the showcase shape (capacity 1536, 32 vmapped
    # replicates) the saved windowed-substep residuals alone were
    # ~0.5 GB x 11+ HLO temps; remat trades that for ~2x the
    # substep FLOPs during the backward sweep.
    remat_substeps: bool = False

    @classmethod
    def create(
        cls,
        size: Tuple[float, float, float],
        capacity: int,
        bio: BiologyParams,
        nbr_run_cap: int = 16,
        jkr_run_cap: int = 16,
        bond_cap: int = 8,
        verlet_skin: float = 14.0,
        **flags,
    ) -> "EngineConfig":
        # capacities move in 256-slot steps (growth doubles, rounded up), so
        # a colony's life sees few distinct step shapes to compile
        capacity = _round_up(int(capacity), 256)
        nbr_spec = GridSpec.from_box(size, bio.neighbor_radius, nbr_run_cap)
        # bin size covers every force-active pair (fresh contacts within
        # jkr_radius AND persisted bonds out to + jkr_break_band, with 2x
        # margin for over-grown radii) plus the Verlet drift allowance
        jkr_spec = GridSpec.from_box(
            size, bio.jkr_radius + 2.0 * bio.jkr_break_band + verlet_skin, jkr_run_cap
        )
        for spec in (nbr_spec, jkr_spec):
            # flat bin ids must stay exact in f32 (< 2^24), like agent ids
            if nbr_ops.dead_sentinel(spec) >= (1 << 24):
                raise ValueError(
                    f"lattice of {spec.num_bins} bins exceeds the f32-exact "
                    "flat-id range (2^24); use a coarser bin size"
                )
        # expected dividers/step ~ capacity/72 (randomized clocks); 1/32 is
        # >2x headroom and keeps the per-array daughter gathers small (the
        # num_dividing probe grows it on overflow)
        flags.setdefault("div_cap", max(128, _round_up(int(capacity) // 32, 128)))
        flags["div_cap"] = min(int(flags["div_cap"]), int(capacity))
        return cls(
            capacity=int(capacity),
            nbr_spec=nbr_spec,
            jkr_spec=jkr_spec,
            bond_cap=int(bond_cap),
            two_d=size[2] == 0,
            verlet_skin=float(verlet_skin),
            **flags,
        )


class StepInfo(NamedTuple):
    """On-device per-step diagnostics; overflow probes drive host-side
    capacity doubling (the reference's retry loops, off the hot path)."""

    num_agents: jnp.ndarray
    num_added: jnp.ndarray
    num_removed: jnp.ndarray
    num_deferred: jnp.ndarray  # divisions deferred for lack of free slots
    num_dividing: jnp.ndarray  # division attempts (div_cap growth probe)
    nbr_max_in_bin: jnp.ndarray
    jkr_max_in_bin: jnp.ndarray
    jkr_max_degree: jnp.ndarray
    max_id: jnp.ndarray  # id high-water mark (ids must stay f32-exact < 2^24)
    max_substep_move: jnp.ndarray  # max per-agent move per physics substep (um)
    # (bond_band_margin probe: 2*move + division displacement must stay
    # inside the margin, else band storage could forget a live bond)


def make_bio_moments_xla(
    nbr_grid: nbr_ops.Grid,
    nbr_pos: jnp.ndarray,
    nbr_valid: jnp.ndarray,
    loc0: jnp.ndarray,
    ids0: jnp.ndarray,
    alive: jnp.ndarray,
    radius: float,
) -> "callable":
    """Windowed-gather neighborhood-moment reducer.

    Builds the step's neighbor graph ONCE from the build-time window (the
    reference builds ``neighbor_graph`` once at the top of the step,
    ``cell_simulation.py:90``) and returns ``bio_moments(curr_loc, f0, f1,
    f2, alive_now) -> (C, 16)`` computing, over the build-time neighborhood
    re-masked by current liveness: count, sum f0, sum f0^2, count/disp-sum of
    (f1 > f0) candidates, count/disp-sum of (f2 != 0) candidates. Columns:
    [0] count, [1] sum f0, [2] sum f0^2, [3] count(f1 > f0), [4:7] their
    displacement sum, [7] count(f2 != 0), [8:11] their displacement sum,
    [11:16] zero.

    Shared by the single-device engine and the domain-decomposed engine —
    the domain engine calls it on its local (own + halo) rows, where the
    identical window content makes the moment floats bit-equal."""
    capacity = loc0.shape[0]
    ids_f = ids0.astype(jnp.float32)
    base_pack = jnp.concatenate(
        [loc0, ids_f[:, None], alive.astype(jnp.float32)[:, None],
         jnp.zeros((capacity, 3), jnp.float32)],
        axis=1,
    )
    base_cand = base_pack[nbr_grid.order][nbr_pos]
    delta0 = base_cand[..., :3] - loc0[:, None, :]
    r15 = jnp.float32(radius)
    base_mask = (
        nbr_valid
        & (base_cand[..., 3] != ids_f[:, None])
        & (jnp.sum(delta0 * delta0, axis=-1) <= r15 * r15)
        & (base_cand[..., 4] > 0)
        & alive[:, None]
    )

    def bio_moments(curr_loc, f0, f1, f2, alive_now, mode="full"):
        pack = jnp.concatenate(
            [
                curr_loc,
                f0.astype(jnp.float32)[:, None],
                f1.astype(jnp.float32)[:, None],
                f2.astype(jnp.float32)[:, None],
                alive_now.astype(jnp.float32)[:, None],
                jnp.zeros((capacity, 1), jnp.float32),
            ],
            axis=1,
        )
        cand = pack[nbr_grid.order][nbr_pos]  # (C, W, 8)
        m = base_mask & (cand[..., 6] > 0)
        mf = m.astype(jnp.float32)
        count = jnp.sum(mf, axis=1, keepdims=True)
        # trim per mode: the class-filtered (C, W, 3) displacement reductions are the expensive lanes — skip them for
        # count-only and pathway calls
        if mode == "count":
            return jnp.concatenate(
                [count, jnp.zeros((capacity, 15), jnp.float32)], axis=1
            )
        cf0 = cand[..., 3]
        f0_sum = jnp.sum(mf * cf0, axis=1, keepdims=True)
        f0_sq = jnp.sum(mf * cf0 * cf0, axis=1, keepdims=True)
        if mode == "pathway":
            return jnp.concatenate(
                [count, f0_sum, f0_sq,
                 jnp.zeros((capacity, 13), jnp.float32)], axis=1
            )
        disp = cand[..., :3] - curr_loc[:, None, :]
        a = mf * (cand[..., 4] > cand[..., 3]).astype(jnp.float32)
        b = mf * (cand[..., 5] != 0).astype(jnp.float32)
        return jnp.concatenate(
            [
                count,
                f0_sum,
                f0_sq,
                jnp.sum(a, axis=1, keepdims=True),
                jnp.sum(a[..., None] * disp, axis=1),  # (C, 3)
                jnp.sum(b, axis=1, keepdims=True),
                jnp.sum(b[..., None] * disp, axis=1),  # (C, 3)
                jnp.zeros((capacity, 5), jnp.float32),
            ],
            axis=1,
        )

    return bio_moments


_F32_LANES = ("locations", "radii", "motility_forces", "jkr_forces")
_I32_LANES = ("ids", "FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states",
              "death_counters", "diff_counters", "div_counters", "fds_counters")


def _sort_state_rows(arrays, alive, bonds, order):
    """Move the whole per-agent state into ``order`` with ONE row gather of
    a single wide matrix instead of seventeen narrow ones. All lanes ride f32: ints (ids, FDS
    values, counters) are < 2^24 so the round-trip is exact; bond partners
    are ids with a -1 empty sentinel."""
    capacity = alive.shape[0]
    K = bonds.partners.shape[1]
    cols = [arrays[k].astype(jnp.float32).reshape(capacity, -1) for k in _F32_LANES]
    cols += [arrays[k].astype(jnp.float32)[:, None] for k in _I32_LANES]
    cols.append(alive.astype(jnp.float32)[:, None])
    cols.append(jnp.where(bonds.mask, bonds.partners, -1).astype(jnp.float32))
    packed = jnp.concatenate(cols, axis=1)[order]

    out = {}
    c = 0
    for k in _F32_LANES:
        w = arrays[k].shape[1] if arrays[k].ndim == 2 else 1
        v = packed[:, c:c + w]
        out[k] = v if arrays[k].ndim == 2 else v[:, 0]
        c += w
    for k in _I32_LANES:
        out[k] = packed[:, c].astype(jnp.int32)
        c += 1
    alive_s = packed[:, c] > 0.0
    c += 1
    bp = packed[:, c:c + K]
    bonds_s = BondState(
        partners=jnp.maximum(bp, 0).astype(jnp.int32), mask=bp >= 0
    )
    return out, alive_s, bonds_s


def max_safe_bond_cap() -> int:
    """Largest bond_cap capacity growth may reach. Past ~160 bonds per
    agent (~21x the reference colony density) the step crashed the device
    worker on the accelerator this engine was first built for; the limit is
    kept until it is measured on the GPU. No physical workload approaches
    this packing; growth past the limit raises a loud framework error
    instead (like the 2^24 id guard). HIPSC_MAX_BOND_CAP overrides it."""
    return int(os.environ.get("HIPSC_MAX_BOND_CAP", "128"))


_BOND_CAP_GUARD_MSG = (
    "contact degree {deg} requires bond_cap {need}, past the guarded limit "
    "of {limit}: ~160 bonds/agent is ~21x reference colony density, far "
    "outside any physical hiPSC workload — check force constants / box "
    "size. (The limit was set where the step faulted on the accelerator "
    "this engine was first built for and is not yet measured on the GPU.) "
    "Set HIPSC_MAX_BOND_CAP to override."
)


def _scoped(name: str, fn):
    """``fn`` traced under ``jax.named_scope(name)``: the step-phase names
    that per-layer trace reductions attribute device time to
    (``tools/profile_step.py``)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.named_scope(name):
            return fn(*args, **kwargs)

    return wrapped


def _physics_dts(bio: BiologyParams) -> np.ndarray:
    """Substep schedule: divmod(step_dt, move_dt) full substeps + remainder
    substep, which runs even when the remainder is zero and still updates the
    bond graph (reference ``cell_methods.py:394-399``)."""
    steps, last_dt = divmod(bio.step_dt, bio.move_dt)
    return np.array([bio.move_dt] * int(steps) + [last_dt], dtype=np.float32)


def hipsc_step(
    state: CellState,
    cfg: EngineConfig,
    gen: GeneralParams,
    xp: ExperimentalParams,
    bio: BiologyParams,
    diff: Optional[DiffusionParams],
) -> Tuple[CellState, "StepInfo"]:
    """One full simulation step — the fused equivalent of the loop body at
    reference ``cell_simulation.py:85-123``, in the same phase order."""
    arrays = dict(state.arrays)
    alive = state.alive
    bonds = state.bonds
    gradients = dict(state.gradients)
    current_step = state.step

    key = state.key
    key, k_div, k_path, k_diff, k_stoch, k_mot = jax.random.split(key, 6)

    size = jnp.asarray(gen.size, dtype=arrays["locations"].dtype)
    capacity = alive.shape[0]

    # --- get_neighbors("neighbor_graph", 15) ---
    # window built from pre-division positions/liveness: this IS the step's
    # neighbor graph (reference builds it once at the top of the step). The
    # biology phases consume only neighborhood *moments* (see models.biology);
    # `bio_moments(curr_loc, f0, f1, f2, alive_now)` returns a (C, 16) moment
    # table (count, sum f0, sum f0^2, class counts and displacement sums —
    # layout in make_bio_moments_xla) over the step's candidate window.
    # the step's state is SORTED-RESIDENT: the grid is built from the
    # incoming layout, then the WHOLE state moves into this step's canonical
    # (bin, id) order with one wide row gather. Every later phase reads and
    # writes sorted rows — no per-consumer pack sorts, no moment unsorts, and
    # division ranks are plain cumsums. The output state keeps this layout
    # (slot order is opaque to everything outside the engine; identity rides
    # the stable agent ids).
    nbr_grid = _scoped("neighbor_grid", nbr_ops.build_grid)(
        cfg.nbr_spec, arrays["locations"], arrays["ids"], alive
    )
    arrays, alive, bonds = _scoped("sort_rows", _sort_state_rows)(
        arrays, alive, bonds, nbr_grid.order)
    loc0 = arrays["locations"]
    # candidate windows in sorted space: rows ARE sorted positions now
    ident_grid = nbr_ops.Grid(
        order=jnp.arange(capacity, dtype=jnp.int32),
        sorted_flat=nbr_grid.sorted_flat,
        coords=nbr_ops._bin_coords(cfg.nbr_spec, loc0),
    )
    nbr_pos, nbr_valid, nbr_max_in_bin = _scoped(
        "neighbor_grid", nbr_ops.window_from_grid)(cfg.nbr_spec, ident_grid)
    with jax.named_scope("bio_moments"):
        bio_moments = make_bio_moments_xla(
            ident_grid, nbr_pos, nbr_valid, loc0, arrays["ids"], alive,
            bio.neighbor_radius,
        )
    bio_moments = _scoped("bio_moments", bio_moments)

    zero_i = jnp.zeros((capacity,), jnp.int32)
    m1 = bio_moments(loc0, zero_i, zero_i, zero_i, alive, mode="count")
    nbr_count = m1[:, 0].astype(jnp.int32)

    # --- cell_division ---
    # daughter ids are assigned by the mothers' canonical (bin, id) rank —
    # layout-independent, so the domain-decomposed engine assigns identically.
    # The state is already in canonical order here, so the rank is a cumsum.
    (
        arrays, alive, daughter_mask, num_added, num_deferred, num_dividing,
    ) = _scoped("division", biology.cell_division)(
        arrays, alive, nbr_count, k_div, bio, cfg.two_d,
        canon_order=None, next_id=state.next_id,
        div_cap=cfg.div_cap or cfg.capacity,
    )
    bonds = clear_bond_rows(bonds, daughter_mask)  # fresh graph vertices, no edges
    # daughters have no edges in the pre-division graph; their slots were dead
    # at grid-build time so they appear in no one's candidate window either
    nbr_count = jnp.where(daughter_mask, 0, nbr_count)

    # --- cell_death ---
    # (bonds of dead agents need no cleanup: dead ids never reappear in any
    # candidate window, so their entries are inert and drop at compaction)
    arrays["death_counters"], removed, num_removed = biology.cell_death(
        arrays["states"], arrays["death_counters"], alive, nbr_count,
        xp.lonely_thresh, bio.death_thresh,
    )
    alive = alive & ~removed

    # --- cell_pathway ---
    # neighborhood moments with post-death liveness and post-division
    # locations (deaths remove agents from everyone's neighborhood,
    # cell_methods.py:47; daughters have no edges in the step's graph)
    m2 = bio_moments(
        arrays["locations"], arrays["FGF4"], zero_i, zero_i, alive,
        mode="pathway",
    )
    count2 = m2[:, 0].astype(jnp.int32)
    # gradient -> fate coupling (DiffusionParams.field_coupling): perceived
    # FGF4 sampled from the step-incoming morphogen field at the cell's
    # nearest diffusion point (this step's secretion/diffusion runs below,
    # so the pathway sees the previous step's field — a well-defined order
    # that the domain engine reproduces on its replicated lattice)
    field_fgf4 = None
    if (cfg.enable_diffusion and diff is not None and diff.field_coupling
            and "fgf4_values" in gradients):
        field_fgf4 = diffusion_ops.sample_concentration(
            gradients["fgf4_values"], arrays["locations"], diff.spat_res
        )
    (
        arrays["FGF4"], arrays["FGFR"], arrays["ERK"],
        arrays["GATA6"], arrays["NANOG"], arrays["fds_counters"],
    ) = biology.cell_pathway(
        arrays["FGF4"], arrays["FGFR"], arrays["ERK"], arrays["GATA6"],
        arrays["NANOG"], arrays["fds_counters"], arrays["ids"], alive, count2,
        m2[:, 1], m2[:, 2], k_path, current_step, xp, bio,
        field_fgf4=field_fgf4,
    )

    # --- cell_differentiate ---
    arrays["NANOG"], arrays["states"], arrays["diff_counters"] = biology.cell_differentiate(
        arrays["GATA6"], arrays["NANOG"], arrays["states"], arrays["diff_counters"],
        arrays["ids"], alive, k_diff, bio,
    )

    # --- optional phases the reference ships disabled (cell_simulation.py:98-104) ---
    if cfg.enable_growth:
        arrays["radii"] = biology.cell_growth(
            arrays["radii"], arrays["states"], arrays["div_counters"], alive, bio
        )
    if cfg.enable_stochastic:
        arrays["GATA6"], arrays["NANOG"] = biology.cell_stochastic_update(
            arrays["GATA6"], arrays["NANOG"], arrays["ids"], alive, k_stoch, bio
        )
    if cfg.enable_diff_surround:
        m_ds = bio_moments(
            arrays["locations"], zero_i, zero_i, arrays["states"], alive,
            mode="motility",
        )
        arrays["GATA6"], arrays["NANOG"] = biology.cell_diff_surround(
            arrays["GATA6"], arrays["NANOG"], arrays["states"], alive,
            m_ds[:, 7].astype(jnp.int32), bio,
        )
    if cfg.enable_diffusion and diff is not None:
        np_dts = diffusion_dts_cached(bio.step_dt, diff.diffuse_dt)
        dts = jnp.asarray(np_dts)
        for gname in sorted(gradients):
            grid = gradients[gname]
            # the secretion/uptake rule is FGF4 biology — key it to the
            # FGF4 lattice (any other registered morphogen only diffuses)
            if gname == "fgf4_values" and (
                diff.release_amount > 0.0 or diff.uptake_amount > 0.0
            ):
                # NANOG-high cells secrete FGF4 (the coupling the reference
                # sketches via adjust_morphogens, cell_methods.py:485-521);
                # every alive cell consumes uptake_amount through the same
                # 4-point stencil (negative deposit; the lattice clamp at
                # >= 0 inside ftcs_diffuse bounds over-consumption)
                secreting = alive & (arrays["NANOG"] > arrays["GATA6"])
                amounts = jnp.where(secreting, diff.release_amount, 0.0)
                amounts = amounts - jnp.where(alive, diff.uptake_amount, 0.0)
                grid = _scoped("diffusion_deposit", diffusion_ops.deposit_morphogen)(
                    grid, arrays["locations"], amounts, diff.spat_res
                )
            gradients[gname] = _scoped("ftcs", diffusion_ops.ftcs_diffuse)(
                grid, dts, diff.diffuse_const, diff.spat_res2,
                diff.max_concentration, diff.degradation,
            )

    # --- cell_motility ---
    # post-fate candidate moments (current GATA6/NANOG/states and
    # post-division locations, as the reference's serial loop reads them at
    # motility time)
    m3 = bio_moments(
        arrays["locations"], arrays["GATA6"], arrays["NANOG"], arrays["states"],
        alive, mode="motility",
    )
    arrays["motility_forces"] = biology.cell_motility(
        arrays["locations"], arrays["GATA6"], arrays["NANOG"], arrays["states"],
        arrays["motility_forces"], arrays["ids"], alive, count2,
        m3[:, 3].astype(jnp.int32), m3[:, 4:7],
        m3[:, 7].astype(jnp.int32), m3[:, 8:11],
        k_mot, xp, bio, cfg.two_d,
    )

    # --- apply_forces: 11 physics substeps (cell_methods.py:386-439) ---
    # The contact window is Verlet-cached: built over (radius + break band +
    # skin) bins from reference positions, reused while max drift < skin/2
    # (lax.cond rebuild). Contacts are re-tested at the true radius with
    # current positions every substep, exactly as the reference's per-substep
    # get_neighbors does — the cache only changes how often we sort.
    dts = _physics_dts(bio)
    scan_fn = _physics_scan_dense if cfg.dense_pairs else _physics_scan_xla
    locations, bonds, j_bins, j_degs, max_move = _scoped("physics", scan_fn)(
        cfg, bio, arrays, alive, bonds, size, dts
    )
    arrays["locations"] = locations
    # reference leaves both force arrays zeroed after the step
    # (cell_methods.py:436-439)
    arrays["jkr_forces"] = jnp.zeros_like(arrays["jkr_forces"])
    arrays["motility_forces"] = jnp.zeros_like(arrays["motility_forces"])

    info = StepInfo(
        num_agents=jnp.sum(alive),
        num_added=num_added,
        num_removed=num_removed,
        num_deferred=num_deferred,
        num_dividing=num_dividing,
        nbr_max_in_bin=nbr_max_in_bin,
        jkr_max_in_bin=jnp.max(j_bins),
        jkr_max_degree=jnp.max(j_degs),
        max_id=jnp.max(jnp.where(alive, arrays["ids"], 0)),
        max_substep_move=max_move,
    )
    new_state = CellState(
        arrays=arrays,
        alive=alive,
        bonds=bonds,
        gradients=gradients,
        key=key,
        step=current_step + 1,
        next_id=state.next_id + num_added.astype(jnp.int32),
    )
    return new_state, info


def _physics_scan_dense(cfg, bio, arrays, alive, bonds, size, dts):
    """All-pairs physics for SMALL colonies: zero gathers, zero sorts.

    Vmapped calibration rollouts run 110 sequential substeps per member;
    below a few thousand slots the O(C^2) pairwise arithmetic (elementwise
    broadcasts only) is cheaper than the windowed path's sorts and (C, W, 8)
    gathers, and the persistent bond set rides a (C, C) mask across all
    substeps (id-list conversion only at scan entry/exit). Pair law is ``ops.jkr._pair_jkr`` — bit-identical
    eligibility/break semantics to the windowed paths; only the reduction
    ORDER over a row's partners differs (slot order vs window order), so
    cross-path agreement is allclose, not bit-exact
    (``tests/test_engine.py::test_dense_pairs_matches_windowed``)."""
    from hipsc_abm.ops.jkr import _pair_jkr, window_mask_to_bonds

    ids = arrays["ids"]
    radii = arrays["radii"]
    C = alive.shape[0]
    r = jnp.float32(bio.jkr_radius)
    store_radius = (None if cfg.bond_band_margin is None else
                    bio.jkr_radius - cfg.bond_band_margin)

    # persistent (C, C) bond mask from the (C, K) id lists (scan entry)
    bmask0 = jnp.any(
        (bonds.partners[:, :, None] == ids[None, None, :])
        & bonds.mask[:, :, None] & alive[None, None, :],
        axis=1,
    )
    not_self = ~jnp.eye(C, dtype=bool)
    pair_ok = alive[:, None] & alive[None, :] & not_self

    def substep(carry, dt):
        locations, bmask = carry
        delta = locations[None, :, :] - locations[:, None, :]
        dist2 = jnp.sum(delta * delta, axis=-1)
        eligible = pair_ok & ((dist2 <= r * r) | bmask)
        force, survive = _pair_jkr(
            locations[:, None, :], locations[None, :, :],
            radii[:, None], radii[None, :],
            bio.adhesion_const, bio.poisson, bio.youngs, bio.jkr_break_d,
        )
        keep = eligible & survive
        forces = jnp.sum(jnp.where(keep[..., None], force, 0.0), axis=1)
        if store_radius is not None:
            sr = jnp.float32(store_radius)
            stored = keep & (dist2 > sr * sr)
        else:
            stored = keep
        max_degree = jnp.max(jnp.sum(stored, axis=1)).astype(jnp.int32)
        new_loc = stokes_integrate(
            locations, radii, forces, arrays["motility_forces"],
            alive, bio.stokes, size, dt,
        )
        move2 = jnp.max(jnp.where(
            alive, jnp.sum((new_loc - locations) ** 2, axis=-1), 0.0))
        return (new_loc, stored), (max_degree, move2)

    if cfg.remat_substeps:
        substep = jax.checkpoint(substep)
    (locations, bmask), (j_degs, moves2) = jax.lax.scan(
        substep, (arrays["locations"], bmask0), jnp.asarray(dts)
    )
    bonds, _ = window_mask_to_bonds(
        jnp.broadcast_to(ids[None, :], (C, C)), bmask,
        bonds.partners.shape[1],
    )
    return (locations, bonds, jnp.zeros((1,), jnp.int32), j_degs,
            jnp.sqrt(jnp.max(moves2)))


def _physics_scan_xla(cfg, bio, arrays, alive, bonds, size, dts):
    """Physics substeps over the Verlet-cached candidate window (window
    gathers). The bond graph rides along in slot space with per-substep
    compaction."""

    ids = arrays["ids"]

    @functools.partial(_scoped, "window_rebuild")
    def build_window(locations):
        grid, pos, valid, max_run = nbr_ops.sorted_window(
            cfg.jkr_spec, locations, ids, alive
        )
        return (grid.order, pos, valid, max_run, locations)

    init_win = build_window(arrays["locations"])

    def substep(carry, dt):
        locations, bonds, win = carry
        drift2 = jnp.max(
            jnp.where(alive, jnp.sum((locations - win[4]) ** 2, axis=-1), 0.0)
        )
        win = jax.lax.cond(
            drift2 > (cfg.verlet_skin * 0.5) ** 2,
            build_window,
            lambda _: win,
            locations,
        )
        order, pos, valid, j_max_in_bin, _ = win
        packed = pack_physics(locations, arrays["radii"], ids, alive)
        jkr_forces, bonds, max_degree = _scoped("contact", jkr_ops.jkr_substep)(
            bonds, packed, order, pos, valid, bio.jkr_radius,
            bio.adhesion_const, bio.poisson, bio.youngs, bio.jkr_break_d,
            store_radius=(None if cfg.bond_band_margin is None else
                          bio.jkr_radius - cfg.bond_band_margin),
        )
        new_loc = _scoped("integrate", stokes_integrate)(
            locations, arrays["radii"], jkr_forces, arrays["motility_forces"],
            alive, bio.stokes, size, dt,
        )
        move2 = jnp.max(
            jnp.where(alive, jnp.sum((new_loc - locations) ** 2, axis=-1), 0.0)
        )
        return (new_loc, bonds, win), (j_max_in_bin, max_degree, move2)

    if cfg.remat_substeps:
        substep = jax.checkpoint(substep)
    (locations, bonds, _), (j_bins, j_degs, moves2) = jax.lax.scan(
        substep, (arrays["locations"], bonds, init_win), jnp.asarray(dts)
    )
    return locations, bonds, j_bins, j_degs, jnp.sqrt(jnp.max(moves2))


@functools.lru_cache(maxsize=32)
def diffusion_dts_cached(step_dt: float, diffuse_dt: float) -> np.ndarray:
    return diffusion_ops.diffusion_dts(step_dt, diffuse_dt)


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def _initial_run_cap(locations: np.ndarray, spec) -> int:
    """Max live agents in any 3-bin stencil run of `spec`, from data, with
    25% headroom (rounded to 8)."""
    locations = np.asarray(locations)
    coords = np.floor(locations / spec.cell_size).astype(np.int64) + 1
    dims = np.array([spec.nx, spec.ny, spec.nz])
    coords = np.clip(coords, 0, dims - 1)
    if spec.two_d:
        grid = np.zeros((spec.nx, spec.ny), dtype=np.int64)
        np.add.at(grid, (coords[:, 0], coords[:, 1]), 1)
        runs = grid[:, :-2] + grid[:, 1:-1] + grid[:, 2:]
    else:
        grid = np.zeros((spec.nx, spec.ny, spec.nz), dtype=np.int64)
        np.add.at(grid, (coords[:, 0], coords[:, 1], coords[:, 2]), 1)
        runs = grid[:, :, :-2] + grid[:, :, 1:-1] + grid[:, :, 2:]
    return max(8, _round_up(int(runs.max()) * 1.25, 8))


def config_to_meta(cfg: EngineConfig) -> dict:
    """EngineConfig as plain JSON-able dict (checkpoint metadata). Static
    window widths feed RNG draw shapes, so bit-exact resume requires
    restoring the exact configuration, not just re-deriving it from data."""
    d = dataclasses.asdict(cfg)
    return d


def config_from_meta(meta: dict) -> EngineConfig:
    """Inverse of ``config_to_meta``. Keys that are no longer fields (kernel
    options of checkpoints written by older versions) are ignored."""
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    meta = {k: v for k, v in meta.items() if k in fields}
    meta["nbr_spec"] = GridSpec(**meta["nbr_spec"])
    meta["jkr_spec"] = GridSpec(**meta["jkr_spec"])
    return EngineConfig(**meta)


class HipscEngine:
    """Host-side driver owning the jitted step and capacity management.

    The reference grows capacities with in-loop retries
    (``simulation.py:198-221, 242-281``) and grows populations by
    reallocating every array (``cell_methods.py:86-94``). Here all shapes are
    static inside jit; ``safe_step`` re-executes a step from its unmodified
    input state after doubling whichever static capacity overflowed, so
    results are never silently truncated.
    """

    def __init__(
        self,
        gen: GeneralParams,
        xp: ExperimentalParams,
        bio: Optional[BiologyParams] = None,
        diff: Optional[DiffusionParams] = None,
        cfg: Optional[EngineConfig] = None,
        enable_diffusion: bool = False,
        enable_growth: bool = False,
        enable_stochastic: bool = False,
        enable_diff_surround: bool = False,
    ):
        from hipsc_abm.utils.config import ensure_compilation_cache

        ensure_compilation_cache()
        self.gen = gen
        self.xp = xp
        self.bio = bio or BiologyParams()
        self.diff = diff
        if cfg is None:
            n0 = gen.num_to_start + xp.num_gata6
            # headroom for several steps of growth before a recompile
            capacity = max(_round_up(int(n0 * 1.3), 256), 256)
            cfg = EngineConfig.create(
                gen.size,
                capacity=capacity,
                bio=self.bio,
                enable_diffusion=enable_diffusion,
                enable_growth=enable_growth,
                enable_stochastic=enable_stochastic,
                enable_diff_surround=enable_diff_surround,
            )
        self.cfg = cfg
        self._compiled = {}

    # -- state construction -------------------------------------------------

    def init_state(self, seed: int = 0, locations: Optional[np.ndarray] = None) -> CellState:
        """Build the initial colony (reference ``agent_initials``,
        ``cell_simulation.py:128-157``): ``num_to_start`` default cells plus
        ``num_gata6`` GATA6-high cells, uniform-random locations in the box."""
        gen, xp, bio, cfg = self.gen, self.xp, self.bio, self.cfg
        n = gen.num_to_start + xp.num_gata6
        if n > cfg.capacity:
            raise ValueError(f"initial population {n} exceeds capacity {cfg.capacity}")
        C = cfg.capacity
        rng = np.random.default_rng(seed)

        arrays: Dict[str, np.ndarray] = {}
        for name, (dtype, vec) in HIPSC_ARRAY_SPECS.items():
            shape = (C,) if vec is None else (C, vec)
            arrays[name] = np.zeros(shape, dtype=dtype)

        if locations is None:
            locations = rng.random((n, 3)) * np.asarray(gen.size)
        arrays["ids"][:n] = np.arange(n, dtype=np.int32)
        arrays["locations"][:n] = locations
        arrays["radii"][:n] = bio.max_radius
        for fds in ("FGF4", "FGFR", "ERK", "NANOG"):
            arrays[fds][:n] = rng.integers(0, bio.field, n)
        arrays["death_counters"][:n] = rng.integers(0, bio.death_thresh, n)
        arrays["diff_counters"][:n] = rng.integers(0, bio.pluri_to_diff, n)
        arrays["div_counters"][:n] = rng.integers(0, bio.pluri_div_thresh, n)
        if bio.fds_thresh > 1:
            arrays["fds_counters"][:n] = rng.integers(0, bio.fds_thresh, n)
        # GATA6_high group overrides (cell_simulation.py:152-153)
        g0 = gen.num_to_start
        if xp.num_gata6 > 0:
            arrays["GATA6"][g0:n] = rng.integers(1, max(bio.field, 2), xp.num_gata6)
            arrays["NANOG"][g0:n] = 0

        alive = np.zeros((C,), dtype=bool)
        alive[:n] = True

        # size the static window capacities from the actual initial density
        # (smaller windows shrink every downstream windowed op; undersizing is
        # safe — safe_step grows on the on-device overflow probe)
        self.cfg = cfg = dataclasses.replace(
            cfg,
            nbr_spec=dataclasses.replace(
                cfg.nbr_spec,
                run_cap=_initial_run_cap(locations, cfg.nbr_spec),
            ),
            jkr_spec=dataclasses.replace(
                cfg.jkr_spec,
                run_cap=_initial_run_cap(locations, cfg.jkr_spec),
            ),
        )

        gradients: Dict[str, np.ndarray] = {}
        if cfg.enable_diffusion and self.diff is not None:
            nx, ny = self.diff.grid_size(gen.size)
            gradients["fgf4_values"] = np.zeros((nx, ny), dtype=np.float32)

        return CellState(
            arrays={k: jnp.asarray(v) for k, v in arrays.items()},
            alive=jnp.asarray(alive),
            bonds=BondState.empty(C, cfg.bond_cap),
            gradients={k: jnp.asarray(v) for k, v in gradients.items()},
            key=jax.random.PRNGKey(seed),
            step=jnp.asarray(1, dtype=jnp.int32),
            next_id=jnp.asarray(n, dtype=jnp.int32),
        )

    # -- stepping -----------------------------------------------------------

    def _step_key(self, cfg: EngineConfig):
        return (cfg, self.gen, self.xp, self.bio, self.diff)

    def _step_fn(self, cfg: EngineConfig):
        key = self._step_key(cfg)
        if key not in self._compiled:
            self._compiled[key] = jax.jit(
                functools.partial(
                    hipsc_step, cfg=cfg, gen=self.gen, xp=self.xp, bio=self.bio,
                    diff=self.diff,
                )
            )
        return self._compiled[key]

    def _cfg_for_state(self, state: CellState) -> EngineConfig:
        """A config whose static shapes match the given state. ``self.cfg``
        is only a template: stepping a state whose capacity/bond shape differs
        (e.g. an older state held across a growth event) must not recompile
        against mismatched shapes — derive a matching config instead."""
        cfg = self.cfg
        bond_cap = state.bonds.partners.shape[1]
        if cfg.capacity != state.capacity or cfg.bond_cap != bond_cap:
            cfg = dataclasses.replace(
                cfg, capacity=state.capacity, bond_cap=bond_cap)
        return cfg

    def step(self, state: CellState) -> Tuple[CellState, StepInfo]:
        """Raw jitted step (no overflow handling) — for benchmarking."""
        return self._step_fn(self._cfg_for_state(state))(state)

    def safe_step(self, state: CellState) -> Tuple[CellState, StepInfo]:
        """Step with exact capacity-overflow recovery.

        If any static capacity (bin occupancy, bond degree, free slots)
        overflowed, the result may have dropped neighbors/bonds/daughters;
        the step is re-executed from the same input state with the offending
        capacity doubled — the reference's adaptive doubling
        (``simulation.py:217-221,277-281``), amortized to O(log) recompiles.
        """
        for _ in range(16):
            cfg = self._cfg_for_state(state)
            new_state, info = self._step_fn(cfg)(state)
            # ONE batched device->host transfer for all probes: per-scalar
            # int(...) fetches each cost a full host round trip, and the
            # growth policy reads ~9 of them
            info = StepInfo(*jax.device_get(tuple(info)))
            if int(info.max_id) >= (1 << 24) - 1:
                # ids ride f32 pack lanes; past 2^24 they lose exactness.
                # 16.7M agents-ever is far beyond any published workload —
                # fail loudly rather than corrupt bond identity silently.
                raise RuntimeError(
                    "agent id space exhausted (2^24 agents ever created); "
                    "id recycling is not implemented"
                )
            grown_cfg = self._grown_cfg(cfg, info)
            if grown_cfg is None:
                return new_state, info
            # commit the grown config as the template for future states and
            # re-execute this step from its unmodified input
            self.cfg = grown_cfg
            state = self.repad_state(state, grown_cfg)
        raise RuntimeError("capacity growth failed to converge")

    # -- device-resident multi-step blocks -----------------------------------

    def _block_fn(self, cfg: EngineConfig, k: int):
        """jitted ``lax.scan`` of k full steps: ONE dispatch, ONE stacked
        probe fetch, zero host boundaries in between. Removes the per-step
        host round trip that caps small-colony throughput."""
        key = ("block", k, self._step_key(cfg))
        if key not in self._compiled:
            step = functools.partial(
                hipsc_step, cfg=cfg, gen=self.gen, xp=self.xp, bio=self.bio,
                diff=self.diff,
            )

            def block(state):
                return jax.lax.scan(lambda s, _: step(s), state, None, length=k)

            self._compiled[key] = jax.jit(block)
        return self._compiled[key]

    def run_steps(
        self, state: CellState, k: int
    ) -> Tuple[CellState, StepInfo]:
        """Run ``k`` full steps device-resident with exact overflow recovery.

        Semantics are identical to ``k`` calls of ``safe_step`` (the scan
        body IS ``hipsc_step``); only the host boundary moves — probes are
        stacked on device and fetched once per block. Overflow handling
        re-executes the WHOLE block from its unmodified input state after
        growing whichever capacity the block's worst-case probes demanded —
        ``safe_step``'s exactness argument verbatim, amortized over k.
        Returns the final state and the stacked per-step ``StepInfo``
        (every field has a leading (k,) axis)."""
        if k < 1:
            raise ValueError(f"run_steps needs k >= 1, got {k}")
        for _ in range(16):
            cfg = self._cfg_for_state(state)
            new_state, infos = self._block_fn(cfg, k)(state)
            infos = StepInfo(*jax.device_get(tuple(infos)))
            worst = StepInfo(*(np.max(np.asarray(f), axis=0) for f in infos))
            if int(worst.max_id) >= (1 << 24) - 1:
                raise RuntimeError(
                    "agent id space exhausted (2^24 agents ever created); "
                    "id recycling is not implemented"
                )
            grown_cfg = self._grown_cfg(cfg, worst)
            if grown_cfg is None:
                return new_state, infos
            self.cfg = grown_cfg
            state = self.repad_state(state, grown_cfg)
        raise RuntimeError("capacity growth failed to converge")

    def _grown_cfg(self, cfg: EngineConfig, info: StepInfo) -> Optional[EngineConfig]:
        """Pure growth policy: the (new) config demanded by the step's
        overflow probes, or None if nothing overflowed. Never mutates shared
        state — ``safe_step`` decides what to commit."""
        changed = False
        nbr_spec, jkr_spec, bond_cap, capacity = (
            cfg.nbr_spec, cfg.jkr_spec, cfg.bond_cap, cfg.capacity,
        )
        if int(info.nbr_max_in_bin) > nbr_spec.run_cap:
            nbr_spec = dataclasses.replace(
                nbr_spec, run_cap=_round_up(int(info.nbr_max_in_bin) * 2, 8)
            )
            changed = True
        if int(info.jkr_max_in_bin) > jkr_spec.run_cap:
            jkr_spec = dataclasses.replace(
                jkr_spec, run_cap=_round_up(int(info.jkr_max_in_bin) * 2, 8)
            )
            changed = True
        if int(info.jkr_max_degree) > bond_cap:
            bond_cap = _round_up(int(info.jkr_max_degree) * 2, 8)
            limit = max_safe_bond_cap()
            if bond_cap > limit:
                raise RuntimeError(_BOND_CAP_GUARD_MSG.format(
                    deg=int(info.jkr_max_degree), need=bond_cap, limit=limit))
            changed = True
        div_cap = cfg.div_cap
        if div_cap and int(info.num_dividing) > div_cap:
            # daughter-table overflow: grow the rank-compressed tables; the
            # re-execution reveals any true free-slot shortage separately
            div_cap = min(_round_up(int(info.num_dividing) * 2, 128), capacity)
            changed = True
        elif int(info.num_deferred) > 0:
            capacity = _round_up(capacity * 2, 256)
            changed = True
        margin = cfg.bond_band_margin
        if margin is not None:
            # band-storage safety: a stored-band pair must not be able to
            # cross the search radius between force evaluations (substep
            # motion twice, plus one division displacement per endpoint at
            # step boundaries)
            bio_disp = 2.0 * (self.bio.max_radius - self.bio.min_radius)
            required = 2.0 * float(info.max_substep_move) + bio_disp
            if required > margin:
                # margin == search radius degrades to full-edge-set storage
                new_margin = min(required * 1.5, self.bio.jkr_radius)
                if new_margin > margin:
                    margin = new_margin
                    changed = True
        if not changed:
            return None
        return dataclasses.replace(
            cfg, nbr_spec=nbr_spec, jkr_spec=jkr_spec, bond_cap=bond_cap,
            capacity=capacity,
            div_cap=min(div_cap, capacity) if div_cap else div_cap,
            bond_band_margin=margin,
        )

    @staticmethod
    def repad_state(state: CellState, cfg: EngineConfig) -> CellState:
        """Re-pad a state to a (larger) capacity / bond capacity."""
        C_old = state.capacity
        C = cfg.capacity
        K = cfg.bond_cap

        def pad_rows(a, rows):
            if rows == a.shape[0]:
                return a
            pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, pad)

        arrays = {k: pad_rows(v, C) for k, v in state.arrays.items()}
        alive = pad_rows(state.alive, C)
        partners = pad_rows(state.bonds.partners, C)
        mask = pad_rows(state.bonds.mask, C)
        if K != partners.shape[1]:
            if K < partners.shape[1]:
                raise ValueError("bond capacity cannot shrink")
            partners = jnp.pad(partners, ((0, 0), (0, K - partners.shape[1])))
            mask = jnp.pad(mask, ((0, 0), (0, K - mask.shape[1])))
        return CellState(
            arrays=arrays,
            alive=alive,
            bonds=BondState(partners=partners, mask=mask),
            gradients=state.gradients,
            key=state.key,
            step=state.step,
            next_id=state.next_id,
        )
