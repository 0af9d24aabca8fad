"""Domain-decomposed full simulation step (pod-scale multi-chip engine).

The single-chip engine (``hipsc_abm.engine``) runs the whole colony on one
device; the GSPMD agent-sharded engine (``parallel.mesh``) shards the slot
axis but still builds one *global* grid (O(C) collectives per window rebuild).
This module is the scalable route: **spatial domain decomposition with halo
exchange and agent migration**, the multi-chip generalization of the
reference's bin lattice (``/root/reference/ABM/simulation.py:190-223``,
SURVEY.md §5.7/§7 stage 7).

Decomposition
-------------
The box is split into an ``(n_tx, n_ty)`` **tile grid** over the
neighbor-lattice column/row axes (``tiles=(n_tx, 1)`` — the default — is the
pure x-stripe decomposition; in 3D a tile owns full-z pencils). Tile
``s = tx*n_ty + ty`` owns every agent whose radius-15 bin column lies in
``[col_bounds[tx], col_bounds[tx+1])`` and bin row in
``[row_bounds[ty], row_bounds[ty+1])``.

Bit-exactness rests on the canonical agent order (row-major flat bin id,
agent id): shifting bin coordinates by a tile's static offsets is
lexicographically monotone, so the local canonical order *is* the global
canonical order restricted to the local agent set. Two consequences:

- windows over local sorted rows contain byte-identical candidate sequences
  to the global windows whenever the halo covers the probe reach, making all
  biology moments and contact forces **bit-exact** against the single-chip
  engine (validated in ``tests/test_domain_engine.py`` and
  ``tests/test_domain_tiles.py``);
- daughter ids equal the single-chip assignment: for stripes the global
  divider rank is a scalar offset (stripes are contiguous ranges of the
  global order); for 2-D tiles — whose ranges interleave by column — the
  step exchanges per-column divider counts (O(columns) ints) and corrects
  each tile-local rank to its global rank per column.

Each device holds a ``(per_stripe,)`` block of own agent slots plus
``n_halo_blocks * halo_cap`` halo rows mirroring boundary agents of adjacent
tiles. All halo traffic is **dimension-ordered**: the y phase exchanges
boundary rows with the ty+-1 neighbors, then the x phase exchanges boundary
columns with the tx+-1 neighbors *including the just-received y-halo rows*,
so a diagonal tile's corner agents arrive in two hops with no explicit
corner channels. Per-tile grids are built by binning agents on the *global*
lattice (exact integer coords) and shifting by the tile's static offsets —
local bins are global bins.

Communication (all ``ppermute`` shifts between neighbouring devices;
O(boundary) bytes):
- one bio halo exchange at step start (membership = the single boundary bin
  column/row, frozen for the step) + two value-refresh re-sends (after
  division/death and after the fate updates) so moment consumers see the
  owner's current values through the frozen window;
- one contact-band exchange per physics substep and decomposed axis
  (positions of frozen halo members; full packs at Verlet rebuilds,
  scheduled by a psum'd global drift predicate — the same rebuild schedule
  as the single-chip engine);
- one migration exchange per decomposed axis at step end re-homing agents
  whose column/row left the tile (x hop then y hop — dimension-ordered
  routing delivers diagonal crossings), with free-slot allocation on the
  receiving device;
- O(1)/O(columns) scalars: dividing counts (daughter-id offsets), psum'd
  step diagnostics, and the psum'd morphogen deposit grid when diffusion is
  enabled.

Every static capacity (per-tile slots, halo rows, migration rows, bin run
occupancy, bond degree, drift allowance) has an on-device overflow probe;
``DomainHipscEngine.safe_step`` re-executes the step from its unmodified
input after growing whichever capacity tripped — the domain analog of the
reference's adaptive doubling loops (``simulation.py:198-221,242-281``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from hipsc_abm.engine import (
    CellState,
    EngineConfig,
    HIPSC_ARRAY_SPECS,
    HipscEngine,
    _physics_dts,
    _round_up,
    diffusion_dts_cached,
    make_bio_moments_xla,
)
from hipsc_abm.models import biology
from hipsc_abm.models.params import (
    BiologyParams,
    DiffusionParams,
    ExperimentalParams,
    GeneralParams,
)
from hipsc_abm.ops import diffusion as diffusion_ops
from hipsc_abm.ops import jkr as jkr_ops
from hipsc_abm.ops import neighbors as nbr_ops
from hipsc_abm.ops.integrate import stokes_integrate
from hipsc_abm.ops.jkr import BondState, clear_bond_rows, pack_physics

AXIS = "stripes"

# migration pack: per-agent arrays that travel when an agent is re-homed
# (motility/jkr forces are zeroed at step end and stay behind as zeros)
_MIG_FIELDS = (
    "ids", "locations", "radii", "FGF4", "FGFR", "ERK", "GATA6", "NANOG",
    "states", "death_counters", "diff_counters", "div_counters", "fds_counters",
)


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    """Static configuration of the decomposed engine (hashable; any change
    recompiles the sharded step)."""

    base: EngineConfig  # global lattice specs / bond_cap / verlet skin
    n_stripes: int  # TOTAL tile count S = n_tx * n_ty (flattened tile grid)
    per_stripe: int  # own agent slots per tile
    halo_cap: int  # halo rows per side
    mig_cap: int  # migration rows per side per step
    div_cap: int  # per-tile daughter-table size
    # max distance (um) an agent may drift outside its tile within one step
    # before re-homing; sizes the contact halo bands. Grown on the
    # drift_exceed probe.
    drift_allowance: float
    col_bounds: Tuple[int, ...]  # (n_tx+1,) nbr-lattice column partition
    nbr_nx_local: int  # uniform local-lattice column counts
    jkr_nx_local: int
    # 2-D tiling: n_ty y-tiles per x-stripe (tile s = tx * n_ty + ty). The
    # defaults keep the pure x-stripe configuration byte-identical, including
    # its local-lattice shapes (full global ny when n_ty == 1).
    n_ty: int = 1
    row_bounds: Tuple[int, ...] = ()  # (n_ty+1,) nbr-lattice row partition
    nbr_ny_local: int = 0  # uniform local-lattice row counts (n_ty > 1)
    jkr_ny_local: int = 0

    @property
    def n_tx(self) -> int:
        return self.n_stripes // self.n_ty

    @property
    def n_halo_blocks(self) -> int:
        """Halo block count: x-left/right for stripes; + y-down/up for tiles.
        Block order in the local slot layout: [y-down, y-up,] x-left,
        x-right — the y blocks exist only when the y axis is decomposed."""
        return 2 if self.n_ty == 1 else 4

    @property
    def local_capacity(self) -> int:
        return self.per_stripe + self.n_halo_blocks * self.halo_cap

    @property
    def nbr_spec_local(self) -> nbr_ops.GridSpec:
        if self.n_ty == 1:
            return dataclasses.replace(self.base.nbr_spec, nx=self.nbr_nx_local)
        return dataclasses.replace(
            self.base.nbr_spec, nx=self.nbr_nx_local, ny=self.nbr_ny_local
        )

    @property
    def jkr_spec_local(self) -> nbr_ops.GridSpec:
        if self.n_ty == 1:
            return dataclasses.replace(self.base.jkr_spec, nx=self.jkr_nx_local)
        return dataclasses.replace(
            self.base.jkr_spec, nx=self.jkr_nx_local, ny=self.jkr_ny_local
        )


class DomainState(NamedTuple):
    """Sharded state: per-agent arrays in stripe-major ``(S, P, ...)`` slot
    blocks; agents are resident in the stripe owning their bin column."""

    arrays: Dict[str, jnp.ndarray]  # (S, P[, d])
    alive: jnp.ndarray  # (S, P)
    bonds: BondState  # (S, P, K)
    gradients: Dict[str, jnp.ndarray]  # replicated morphogen lattices
    key: jax.Array
    step: jnp.ndarray
    next_id: jnp.ndarray


class DomainStepInfo(NamedTuple):
    """Psum/pmax-reduced step diagnostics; the overflow probes drive
    ``DomainHipscEngine.safe_step`` growth."""

    num_agents: jnp.ndarray
    num_added: jnp.ndarray
    num_removed: jnp.ndarray
    num_deferred: jnp.ndarray
    num_dividing: jnp.ndarray  # max per-stripe dividing count (div_cap probe)
    nbr_max_in_bin: jnp.ndarray
    jkr_max_in_bin: jnp.ndarray
    jkr_max_degree: jnp.ndarray
    max_id: jnp.ndarray
    bio_band_max: jnp.ndarray  # bio boundary-column occupancy (halo_cap probe)
    phys_band_max: jnp.ndarray  # contact band occupancy (halo_cap probe)
    mig_out_max: jnp.ndarray  # emigrants per side (mig_cap probe)
    mig_shortfall: jnp.ndarray  # immigrants without a free slot (per_stripe probe)
    mig_too_far: jnp.ndarray  # emigrants skipping a stripe (drift pathology)
    halo_miss: jnp.ndarray  # frozen halo members absent from a fresh band pack
    drift_exceed: jnp.ndarray  # max um outside own stripe (drift_allowance probe)
    max_substep_move: jnp.ndarray  # bond-band-margin probe (see engine.StepInfo)


# ---------------------------------------------------------------------------
# small device-side helpers
# ---------------------------------------------------------------------------


def _compact_idx(mask: jnp.ndarray, cap: int):
    """First-``cap`` compaction of a row mask: returns ``(idx (cap,), valid
    (cap,), count)`` where ``idx[r]`` is the r-th masked row. ``count`` is the
    true masked total (the overflow probe when it exceeds ``cap``)."""
    n = mask.shape[0]
    rank = jnp.cumsum(mask) - 1
    dest = jnp.where(mask & (rank < cap), rank, cap)
    idx = jnp.zeros((cap,), jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    valid = jnp.zeros((cap,), bool).at[dest].set(True, mode="drop")
    return idx, valid, jnp.sum(mask)


def _gather_pack(lanes, idx: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """(cap, L) f32 pack of the given 1-D/2-D lanes at ``idx`` rows; invalid
    rows are all-zero (their alive lane reads 0 = dead)."""
    cols = []
    for lane in lanes:
        g = lane[idx].astype(jnp.float32)
        cols.append(g[:, None] if g.ndim == 1 else g)
    pack = jnp.concatenate(cols, axis=1)
    return jnp.where(valid[:, None], pack, 0.0)


def _axis_exchange(
    pack_lo: jnp.ndarray, pack_hi: jnp.ndarray, n_tx: int, n_ty: int, axis: int
):
    """Send ``pack_lo`` to the axis- neighbor tile and ``pack_hi`` to the
    axis+ neighbor on the flattened (tx, ty) tile grid (tile index
    ``s = tx * n_ty + ty``; axis 0 = x with stride n_ty, axis 1 = y with
    stride 1). Returns ``(from_lo, from_hi)``; boundary tiles receive zeros
    (the box is not a torus — matching ``parallel.domain``'s edge
    handling). For the pure-stripe case (n_ty == 1, axis 0) this is exactly
    the left/right ring exchange."""
    stride = n_ty if axis == 0 else 1
    length = n_tx if axis == 0 else n_ty
    S = n_tx * n_ty

    def coord(s):
        return (s // n_ty) if axis == 0 else (s % n_ty)

    to_hi = [(s, s + stride) for s in range(S) if coord(s) < length - 1]
    to_lo = [(s, s - stride) for s in range(S) if coord(s) > 0]
    from_lo = jax.lax.ppermute(pack_hi, AXIS, to_hi)
    from_hi = jax.lax.ppermute(pack_lo, AXIS, to_lo)
    return from_lo, from_hi


def _local_flat(
    spec_local: nbr_ops.GridSpec,
    gcoords: jnp.ndarray,
    col_off: jnp.ndarray,
    row_off: jnp.ndarray,
    alive: jnp.ndarray,
):
    """Local flat bin ids from *global* integer bin coords shifted by the
    tile's column/row offsets (integer arithmetic — float re-binning against
    a shifted origin could disagree with global binning at bin edges). Rows
    outside the local lattice get the dead sentinel (they become invisible;
    the drift probe forces re-execution if an own row ever lands there).
    Returns ``(flat, local_coords)``.

    The shift is lexicographically monotone, so the local canonical
    (flat, id) sort order equals the global canonical order restricted to
    the local agent set — the property every bit-exactness claim rests on.
    Dimension-agnostic: in 2D ``nz == 1`` and the z coordinate is 0, so the
    3D formula reduces to the 2D one (matching the reference's 3x3x3 stencil
    treating 3D as first-class, ``backend.py:84-93``). For pure x-stripes
    ``row_off == 0`` and ``spec_local.ny`` is the global ny, which makes the
    y terms the identity."""
    cxl = gcoords[:, 0] - col_off
    cyl = gcoords[:, 1] - row_off
    in_range = (
        (cxl >= 0) & (cxl < spec_local.nx) & (cyl >= 0) & (cyl < spec_local.ny)
    )
    flat = (cxl * spec_local.ny + cyl) * spec_local.nz + gcoords[:, 2]
    flat = jnp.where(alive & in_range, flat, nbr_ops.dead_sentinel(spec_local))
    coords_l = jnp.stack(
        [
            jnp.clip(cxl, 0, spec_local.nx - 1),
            jnp.clip(cyl, 0, spec_local.ny - 1),
            gcoords[:, 2],
        ],
        axis=1,
    )
    return flat, coords_l


# ---------------------------------------------------------------------------
# the decomposed step (shard_map body)
# ---------------------------------------------------------------------------


def _domain_step_body(
    arrays,
    alive,
    partners,
    bmask,
    gradients,
    key,
    current_step,
    next_id,
    sci,
    scf,
    *,
    cfg: DomainConfig,
    gen: GeneralParams,
    xp: ExperimentalParams,
    bio: BiologyParams,
    diff: Optional[DiffusionParams],
):
    """One full decomposed step on one stripe (executes under shard_map).

    Mirrors ``engine.hipsc_step`` phase for phase (reference schedule
    ``cell_simulation.py:85-123``); every value a phase reads about a
    non-resident candidate comes from a halo exchange, so own-row results are
    bit-identical to the single-chip engine's."""
    S = cfg.n_stripes
    Tx, Ty = cfg.n_tx, cfg.n_ty
    P_own = cfg.per_stripe
    H = cfg.halo_cap
    C = cfg.local_capacity
    base = cfg.base
    two_d = base.two_d

    # squeeze the leading (1,) tile-block dim
    arrays = {k: v[0] for k, v in arrays.items()}
    alive = alive[0]
    partners = partners[0]
    bmask = bmask[0]
    sci = sci[0]  # (20,) int32 tile constants
    scf = scf[0]  # (4,) f32

    (ncl, nch, nrl, nrh, col_off_nbr, row_off_nbr, col_off_jkr, row_off_jkr,
     sl_fresh, sr_fresh, sd_fresh, su_fresh, recv_l_col, recv_r_col,
     recv_d_row, recv_u_row, prev_ncl, next_nch, prev_nrl, next_nrh) = [
        sci[i] for i in range(20)
    ]
    x_lo, x_hi, y_lo, y_hi = scf[0], scf[1], scf[2], scf[3]

    # --- local (own + halo) slot blocks -------------------------------------
    def pad_rows(a):
        return jnp.pad(a, [(0, C - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    arrays = {k: pad_rows(v) for k, v in arrays.items()}
    alive = pad_rows(alive)
    bonds = BondState(partners=pad_rows(partners), mask=pad_rows(bmask))
    owned = jnp.arange(C, dtype=jnp.int32) < P_own

    key, k_div, k_path, k_diff, k_stoch, k_mot = jax.random.split(key, 6)
    size = jnp.asarray(gen.size, dtype=arrays["locations"].dtype)

    # --- bio halo exchange A: frozen membership = the boundary bin column /
    # row. An own row in bin (c, r) probes bins (c+-1, r+-1), so the only
    # non-resident candidates are the adjacent tiles' single boundary
    # columns/rows plus the diagonal tiles' corner bins. The exchange is
    # dimension-ordered (y phase, then x phase forwarding the just-received
    # y-halo rows) so corners arrive in two hops; for pure x-stripes the y
    # phase is statically absent and this is the round-2 single exchange.
    gcoords0 = nbr_ops._bin_coords(base.nbr_spec, arrays["locations"][:P_own])
    col0 = gcoords0[:, 0]
    row0 = gcoords0[:, 1]
    alive_own = alive[:P_own]

    BIO_LANES = ("locations", "radii", "ids", "FGF4", "GATA6", "NANOG", "states")
    # x-band sources: own rows, plus (when the y axis is decomposed) the two
    # y-halo blocks — forwarding them delivers the diagonal corners
    x_src_n = P_own + (2 * H if Ty > 1 else 0)
    x_off = P_own + (2 * H if Ty > 1 else 0)  # first x halo block row

    def bio_band(idx, val, n_src):
        """Band pack gathered at frozen indices with *current* values; the
        alive lane carries current liveness so consumers drop mid-step
        deaths (and forwarded rows inherit the owner's liveness)."""
        lanes = [arrays[k][:n_src] for k in BIO_LANES]
        alv = val & alive[:n_src][idx]
        return jnp.concatenate(
            [_gather_pack(lanes, idx, val), alv.astype(jnp.float32)[:, None]],
            axis=1,
        )

    def bio_apply_block(pack, start):
        nonlocal arrays, alive
        c = 0
        for k in BIO_LANES:
            w = arrays[k].shape[1] if arrays[k].ndim == 2 else 1
            v = pack[:, c:c + w]
            if arrays[k].ndim == 1:
                v = v[:, 0]
            arrays[k] = jax.lax.dynamic_update_slice_in_dim(
                arrays[k], v.astype(arrays[k].dtype), start, axis=0
            )
            c += w
        alive = jax.lax.dynamic_update_slice_in_dim(
            alive, pack[:, c] > 0, start, axis=0
        )

    if Ty > 1:
        idxD, valD, cntD = _compact_idx(alive_own & (row0 == nrl), H)
        idxU, valU, cntU = _compact_idx(alive_own & (row0 == nrh - 1), H)

        def bio_exchange_y():
            fD, fU = _axis_exchange(
                bio_band(idxD, valD, P_own), bio_band(idxU, valU, P_own),
                Tx, Ty, axis=1,
            )
            bio_apply_block(fD, P_own)
            bio_apply_block(fU, P_own + H)

        # the x membership freezes AFTER the first y apply: it reads the
        # y-halo rows' coordinates to pick the forwarded corner rows
        bio_exchange_y()
        gx = nbr_ops._bin_coords(base.nbr_spec, arrays["locations"][:x_src_n])
        colx = gx[:, 0]
        alive_x = alive[:x_src_n]
        idxL, valL, cntL = _compact_idx(alive_x & (colx == ncl), H)
        idxR, valR, cntR = _compact_idx(alive_x & (colx == nch - 1), H)
        bio_band_max = jnp.maximum(
            jnp.maximum(cntL, cntR), jnp.maximum(cntD, cntU)
        )
    else:
        idxL, valL, cntL = _compact_idx(alive_own & (col0 == ncl), H)
        idxR, valR, cntR = _compact_idx(alive_own & (col0 == nch - 1), H)
        bio_band_max = jnp.maximum(cntL, cntR)

    def bio_exchange_x():
        fL, fR = _axis_exchange(
            bio_band(idxL, valL, x_src_n), bio_band(idxR, valR, x_src_n),
            Tx, Ty, axis=0,
        )
        bio_apply_block(fL, x_off)
        bio_apply_block(fR, x_off + H)

    def bio_refresh():
        """(Re-)send every frozen bio band with current values, y before x so
        forwarded corner rows carry this round's refreshed values."""
        if Ty > 1:
            bio_exchange_y()
        bio_exchange_x()

    bio_exchange_x()  # completes exchange A (the y phase already ran)

    # --- the step's neighbor graph (frozen window, like the single-chip
    # engine's build at the top of the step) --------------------------------
    loc0 = arrays["locations"]
    gcoords_all = nbr_ops._bin_coords(base.nbr_spec, loc0)
    nflat, ncoords = _local_flat(
        cfg.nbr_spec_local, gcoords_all, col_off_nbr, row_off_nbr, alive
    )
    nbr_grid = nbr_ops.grid_from_flat_coords(nflat, ncoords, arrays["ids"])
    nbr_pos, nbr_valid, nbr_max_in_bin = nbr_ops.window_from_grid(
        cfg.nbr_spec_local, nbr_grid
    )
    bio_moments = make_bio_moments_xla(
        nbr_grid, nbr_pos, nbr_valid, loc0, arrays["ids"], alive,
        bio.neighbor_radius,
    )

    zero_i = jnp.zeros((C,), jnp.int32)
    m1 = bio_moments(loc0, zero_i, zero_i, zero_i, alive, mode="count")
    nbr_count = m1[:, 0].astype(jnp.int32)

    # --- cell_division (globally consistent daughter ids) -------------------
    div_counters, dividing = biology.division_clock(
        arrays, alive, nbr_count, k_div, bio
    )
    dividing = dividing & owned
    nd_local = jnp.sum(dividing)
    s_idx = jax.lax.axis_index(AXIS)
    if Ty == 1:
        # stripes are contiguous ranges of the global canonical order, so the
        # global divider rank is (dividers in lower stripes) + local rank
        counts = jax.lax.all_gather(nd_local, AXIS)  # (S,) tiny
        rank_offset = jnp.sum(
            jnp.where(jnp.arange(S) < s_idx, counts, 0)
        ).astype(jnp.int32)
    else:
        # 2-D tiles interleave in the global canonical (cx, cy, cz, id)
        # order: all of column cx' < cx first, then — within my column cx —
        # the tiles of my x-range in ty order. Exchange per-column divider
        # counts (O(columns) ints) and turn them into a per-RANK offset
        # table: daughter id = next_id + off[rank] + rank, where off corrects
        # the tile-local canonical rank to the global one.
        NXC = cfg.nbr_nx_local
        cxl0 = jnp.clip(col0 - ncl, 0, NXC - 1)
        counts_col = jnp.zeros((NXC,), jnp.int32).at[
            jnp.where(dividing[:P_own], cxl0, NXC)
        ].add(1, mode="drop")
        gathered = jax.lax.all_gather(counts_col, AXIS).reshape(Tx, Ty, NXC)
        tx_i = s_idx // Ty
        ty_i = s_idx % Ty
        tile_tot = jnp.sum(gathered, axis=(1, 2))  # (Tx,)
        total_before_tx = jnp.sum(
            jnp.where(jnp.arange(Tx) < tx_i, tile_tot, 0)
        )
        mygroup = jnp.sum(
            jnp.where((jnp.arange(Tx) == tx_i)[:, None, None], gathered, 0),
            axis=0,
        )  # (Ty, NXC): per-column counts of my x-range, by ty
        colsum = jnp.sum(mygroup, axis=0)
        prefix_cols = jnp.cumsum(colsum) - colsum  # dividers in lower columns
        ty_prefix = jnp.sum(
            jnp.where((jnp.arange(Ty) < ty_i)[:, None], mygroup, 0), axis=0
        )  # dividers in my column, lower ty
        own_prefix = jnp.cumsum(counts_col) - counts_col
        off_col = (
            total_before_tx + prefix_cols + ty_prefix - own_prefix
        ).astype(jnp.int32)
        rank_own = biology.canonical_rank(dividing, nbr_grid.order)[:P_own]
        dest = jnp.where(
            dividing[:P_own] & (rank_own < cfg.div_cap), rank_own, cfg.div_cap
        )
        rank_offset = jnp.zeros((cfg.div_cap,), jnp.int32).at[dest].set(
            off_col[cxl0], mode="drop"
        )
    arrays, alive, daughter_mask, num_added, num_deferred = biology.division_apply(
        arrays, alive, div_counters, dividing, k_div, bio, two_d,
        canon_order=nbr_grid.order, next_id=next_id, div_cap=cfg.div_cap,
        allocatable=owned, rank_offset=rank_offset,
    )
    bonds = clear_bond_rows(bonds, daughter_mask)
    nbr_count = jnp.where(daughter_mask, 0, nbr_count)

    # --- cell_death ---
    death_counters, removed, _ = biology.cell_death(
        arrays["states"], arrays["death_counters"], alive, nbr_count,
        xp.lonely_thresh, bio.death_thresh,
    )
    removed = removed & owned
    arrays["death_counters"] = death_counters
    alive = alive & ~removed
    num_removed = jnp.sum(removed)

    # --- exchange B: refresh halo values (division moved mothers, deaths
    # changed liveness) through the frozen window ---------------------------
    bio_refresh()

    # --- cell_pathway ---
    m2 = bio_moments(arrays["locations"], arrays["FGF4"], zero_i, zero_i, alive,
                     mode="pathway")
    count2 = m2[:, 0].astype(jnp.int32)
    # field coupling: the lattice is replicated and locations are global, so
    # the nearest-gridpoint sample is local and bit-equal on every stripe
    # (including halo rows — same lattice, same location, id-keyed noise)
    field_fgf4 = None
    if (base.enable_diffusion and diff is not None and diff.field_coupling
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
    arrays["NANOG"], arrays["states"], arrays["diff_counters"] = (
        biology.cell_differentiate(
            arrays["GATA6"], arrays["NANOG"], arrays["states"],
            arrays["diff_counters"], arrays["ids"], alive, k_diff, bio,
        )
    )

    # --- optional phases (reference ships disabled, cell_simulation.py:98-104)
    if base.enable_growth:
        arrays["radii"] = biology.cell_growth(
            arrays["radii"], arrays["states"], arrays["div_counters"], alive, bio
        )
    if base.enable_stochastic:
        arrays["GATA6"], arrays["NANOG"] = biology.cell_stochastic_update(
            arrays["GATA6"], arrays["NANOG"], arrays["ids"], alive, k_stoch, bio
        )
    # exchange C: fate updates flow to neighbors before the moment reads
    bio_refresh()
    if base.enable_diff_surround:
        m_ds = bio_moments(
            arrays["locations"], zero_i, zero_i, arrays["states"], alive
        )
        arrays["GATA6"], arrays["NANOG"] = biology.cell_diff_surround(
            arrays["GATA6"], arrays["NANOG"], arrays["states"], alive,
            m_ds[:, 7].astype(jnp.int32), bio,
        )
        bio_refresh()

    # --- morphogen diffusion (replicated lattice, psum'd deposits) ----------
    if base.enable_diffusion and diff is not None:
        np_dts_d = diffusion_dts_cached(bio.step_dt, diff.diffuse_dt)
        dts_d = jnp.asarray(np_dts_d)
        new_gradients = {}
        for gname in sorted(gradients):
            grid_g = gradients[gname]
            # FGF4 biology stays keyed to the FGF4 lattice (see engine.py)
            if gname == "fgf4_values" and (
                diff.release_amount > 0.0 or diff.uptake_amount > 0.0
            ):
                secreting = alive & owned & (arrays["NANOG"] > arrays["GATA6"])
                amounts = jnp.where(secreting, diff.release_amount, 0.0)
                amounts = amounts - jnp.where(
                    alive & owned, diff.uptake_amount, 0.0
                )
                delta = diffusion_ops.deposit_morphogen(
                    jnp.zeros_like(grid_g), arrays["locations"], amounts,
                    diff.spat_res,
                )
                grid_g = grid_g + jax.lax.psum(delta, AXIS)
            # every device runs the identical subcycle loop on its replica
            new_gradients[gname] = diffusion_ops.ftcs_diffuse(
                grid_g, dts_d, diff.diffuse_const, diff.spat_res2,
                diff.max_concentration, diff.degradation,
            )
        gradients = new_gradients

    # --- cell_motility ---
    m3 = bio_moments(
        arrays["locations"], arrays["GATA6"], arrays["NANOG"], arrays["states"],
        alive,
    )
    arrays["motility_forces"] = biology.cell_motility(
        arrays["locations"], arrays["GATA6"], arrays["NANOG"], arrays["states"],
        arrays["motility_forces"], arrays["ids"], alive, count2,
        m3[:, 3].astype(jnp.int32), m3[:, 4:7],
        m3[:, 7].astype(jnp.int32), m3[:, 8:11],
        k_mot, xp, bio, two_d,
    )

    # --- apply_forces: 11 physics substeps with per-substep contact-band
    # exchange and Verlet rebuilds on the psum'd global drift ----------------
    (
        locations, bonds, jkr_max_in_bin, jkr_max_degree,
        phys_band_max, halo_miss, drift_exceed, max_substep_move,
    ) = _domain_physics(
        cfg, bio, arrays, alive, bonds, size,
        sl_fresh, sr_fresh, sd_fresh, su_fresh,
        recv_l_col, recv_r_col, recv_d_row, recv_u_row,
        col_off_jkr, row_off_jkr, x_lo, x_hi, y_lo, y_hi,
    )
    arrays["locations"] = locations
    arrays["jkr_forces"] = jnp.zeros_like(arrays["jkr_forces"])
    arrays["motility_forces"] = jnp.zeros_like(arrays["motility_forces"])

    # --- agent migration: re-home agents whose bin column/row left the tile
    # (dimension-ordered: x hop first, then y — a diagonal crossing is
    # delivered in two hops within the same step) ----------------------------
    (
        arrays, alive, bonds, mig_out_max, mig_shortfall, mig_too_far,
    ) = _migrate(
        cfg, base, arrays, alive, bonds, ncl, nch, prev_ncl, next_nch,
        axis=0,
    )
    if Ty > 1:
        (
            arrays, alive, bonds, migy_max, migy_short, migy_far,
        ) = _migrate(
            cfg, base, arrays, alive, bonds, nrl, nrh, prev_nrl, next_nrh,
            axis=1,
        )
        mig_out_max = jnp.maximum(mig_out_max, migy_max)
        mig_shortfall = mig_shortfall + migy_short
        mig_too_far = mig_too_far + migy_far

    # --- outputs -------------------------------------------------------------
    alive_own = alive[:P_own]
    own = {k: v[:P_own][None] for k, v in arrays.items()}
    info = DomainStepInfo(
        num_agents=jax.lax.psum(jnp.sum(alive_own), AXIS),
        num_added=jax.lax.psum(num_added, AXIS),
        num_removed=jax.lax.psum(num_removed, AXIS),
        num_deferred=jax.lax.psum(num_deferred, AXIS),
        num_dividing=jax.lax.pmax(nd_local, AXIS),
        nbr_max_in_bin=jax.lax.pmax(nbr_max_in_bin, AXIS),
        jkr_max_in_bin=jax.lax.pmax(jkr_max_in_bin, AXIS),
        jkr_max_degree=jax.lax.pmax(jkr_max_degree, AXIS),
        max_id=jax.lax.pmax(
            jnp.max(jnp.where(alive_own, arrays["ids"][:P_own], 0)), AXIS
        ),
        bio_band_max=jax.lax.pmax(bio_band_max, AXIS),
        phys_band_max=jax.lax.pmax(phys_band_max, AXIS),
        mig_out_max=jax.lax.pmax(mig_out_max, AXIS),
        mig_shortfall=jax.lax.psum(mig_shortfall, AXIS),
        mig_too_far=jax.lax.psum(mig_too_far, AXIS),
        halo_miss=jax.lax.psum(halo_miss, AXIS),
        drift_exceed=jax.lax.pmax(drift_exceed, AXIS),
        max_substep_move=jax.lax.pmax(max_substep_move, AXIS),
    )
    new_next_id = next_id + info.num_added.astype(jnp.int32)
    return (
        own,
        alive_own[None],
        bonds.partners[:P_own][None],
        bonds.mask[:P_own][None],
        gradients,
        key,
        current_step + 1,
        new_next_id,
        info,
    )


def _domain_physics(
    cfg: DomainConfig,
    bio: BiologyParams,
    arrays,
    alive,
    bonds: BondState,
    size,
    sl_fresh, sr_fresh, sd_fresh, su_fresh,
    recv_l_col, recv_r_col, recv_d_row, recv_u_row,
    col_off_jkr, row_off_jkr, x_lo, x_hi, y_lo, y_hi,
):
    """The 11 JKR+Stokes substeps under decomposition.

    Design: the contact window (local grid + per-row candidate windows) and
    the halo membership are frozen together at each Verlet rebuild; between
    rebuilds each substep exchanges the positions of the SAME frozen band
    rows (the sender carries its rebuild-time compaction indices in the scan,
    so refresh row h is by construction the agent behind halo row h — an O(H)
    gather), so every candidate an own row sees carries its owner's current
    position — making force sums bit-equal to the single-chip engine's (same
    candidates, same order, same rebuild schedule). The rebuild predicate is
    pmax'd, so every tile agrees on whether a given exchange carries a
    fresh-membership pack (rebuild) or a frozen-band refresh, and every
    ppermute stays unconditional.

    With a 2-D tile grid the exchange is dimension-ordered: the y phase runs
    first (adjacent ty tiles' boundary bands), then the x phase — whose send
    band includes the just-refreshed y-halo rows, so a diagonal tile's corner
    agents are forwarded in two hops. At a rebuild the receiver freezes only
    the fresh-pack rows inside its receive columns/rows — the fresh send band
    is one bin wider on each side, so a frozen member can never drift out of
    coverage within a window's lifetime (drift < skin/2 < one jkr bin);
    ownership is fixed during physics (migration runs at step end), so a
    frozen sender row always remains resident and alive for the window's
    lifetime. For pure x-stripes (n_ty == 1) the y phase is statically absent
    and the flow is the round-2 single ring exchange."""
    base = cfg.base
    Tx, Ty = cfg.n_tx, cfg.n_ty
    P_own = cfg.per_stripe
    H = cfg.halo_cap
    C = cfg.local_capacity
    spec_l = cfg.jkr_spec_local
    gspec = base.jkr_spec
    skin = base.verlet_skin

    mot = arrays["motility_forces"]
    dts = _physics_dts(bio)

    def jcol(x):
        c = jnp.floor(x / gspec.cell_size).astype(jnp.int32) + 1
        return jnp.clip(c, 0, gspec.nx - 1)

    def jrow(y):
        c = jnp.floor(y / gspec.cell_size).astype(jnp.int32) + 1
        return jnp.clip(c, 0, gspec.ny - 1)

    PK_LANES = 6  # x, y, z, radius, id, alive
    # x-phase sources: own rows plus (when the y axis is decomposed) the two
    # y-halo blocks, so corner rows get forwarded
    x_src_n = P_own + (2 * H if Ty > 1 else 0)
    x_blk = x_src_n  # first x halo block row (static)

    def fresh_y_idx(pk):
        """Fresh y-band membership (own rows near the tile's y boundaries) —
        frozen into the scan carry at each rebuild."""
        own_alive = pk[:P_own, 5] > 0.0
        rj = jrow(pk[:P_own, 1])
        idxD, valD, cntD = _compact_idx(own_alive & (rj <= sd_fresh), H)
        idxU, valU, cntU = _compact_idx(own_alive & (rj >= su_fresh), H)
        return (idxD, valD, idxU, valU), jnp.maximum(cntD, cntU)

    def fresh_x_idx(pk):
        """Fresh x-band membership over own + y-halo rows (one jkr column
        wider than the neighbor's receive columns)."""
        src_alive = pk[:x_src_n, 5] > 0.0
        cj = jcol(pk[:x_src_n, 0])
        idxL, valL, cntL = _compact_idx(src_alive & (cj <= sl_fresh), H)
        idxR, valR, cntR = _compact_idx(src_alive & (cj >= sr_fresh), H)
        return (idxL, valL, idxR, valR), jnp.maximum(cntL, cntR)

    def band_pack(pk, idx, val, n_src):
        return jnp.where(val[:, None], pk[:n_src][idx, :PK_LANES], 0.0)

    def apply_block(pk, start, recv, do_rebuild, keep):
        """Unconditionally update one (H,) halo block: at a rebuild the
        keep-filtered received pack REPLACES the block (filtered rows are
        zeroed in place, preserving the positional sender order the refresh
        path relies on); between rebuilds the received rows positionally
        refresh the frozen rows' positions."""
        fresh = jnp.where(keep[:, None], recv, 0.0)
        fresh = jnp.pad(fresh, ((0, 0), (0, pk.shape[1] - PK_LANES)))
        blk = pk[start:start + H]
        blk_alive = blk[:, 5] > 0.0
        refreshed = blk.at[:, :3].set(
            jnp.where(blk_alive[:, None], recv[:, :3], blk[:, :3])
        )
        return pk.at[start:start + H].set(
            jnp.where(do_rebuild, fresh, refreshed)
        )

    def _sel(do_rebuild, fresh, frozen):
        return jax.tree_util.tree_map(
            lambda f, o: jnp.where(do_rebuild, f, o), fresh, frozen
        )

    def exchange_and_update(pk, frz, do_rebuild):
        """Per-substep band exchange + halo update, both phases. Returns the
        updated pk, the (possibly re-frozen) membership carry, and the band
        occupancy probe (counted at rebuilds only)."""
        if Ty > 1:
            frz_y, frz_x = frz
            frz_y_f, cnt_y = fresh_y_idx(pk)
            frz_y = _sel(do_rebuild, frz_y_f, frz_y)
            fD, fU = _axis_exchange(
                band_pack(pk, frz_y[0], frz_y[1], P_own),
                band_pack(pk, frz_y[2], frz_y[3], P_own),
                Tx, Ty, axis=1,
            )
            keepD = jrow(fD[:, 1]) >= recv_d_row
            keepU = jrow(fU[:, 1]) <= recv_u_row
            pk = apply_block(pk, P_own, fD, do_rebuild, keepD)
            pk = apply_block(pk, P_own + H, fU, do_rebuild, keepU)
            # x membership reads the just-updated y-halo rows
            frz_x_f, cnt_x = fresh_x_idx(pk)
            frz_x = _sel(do_rebuild, frz_x_f, frz_x)
            fL, fR = _axis_exchange(
                band_pack(pk, frz_x[0], frz_x[1], x_src_n),
                band_pack(pk, frz_x[2], frz_x[3], x_src_n),
                Tx, Ty, axis=0,
            )
            rL, rR = jrow(fL[:, 1]), jrow(fR[:, 1])
            keepL = ((jcol(fL[:, 0]) >= recv_l_col)
                     & (rL >= recv_d_row) & (rL <= recv_u_row))
            keepR = ((jcol(fR[:, 0]) <= recv_r_col)
                     & (rR >= recv_d_row) & (rR <= recv_u_row))
            pk = apply_block(pk, x_blk, fL, do_rebuild, keepL)
            pk = apply_block(pk, x_blk + H, fR, do_rebuild, keepR)
            band_cnt = jnp.where(do_rebuild, jnp.maximum(cnt_y, cnt_x), 0)
            return pk, (frz_y, frz_x), band_cnt
        frz_f, cnt = fresh_x_idx(pk)
        frz = _sel(do_rebuild, frz_f, frz)
        fL, fR = _axis_exchange(
            band_pack(pk, frz[0], frz[1], P_own),
            band_pack(pk, frz[2], frz[3], P_own),
            Tx, Ty, axis=0,
        )
        keepL = jcol(fL[:, 0]) >= recv_l_col
        keepR = jcol(fR[:, 0]) <= recv_r_col
        pk = apply_block(pk, P_own, fL, do_rebuild, keepL)
        pk = apply_block(pk, P_own + H, fR, do_rebuild, keepR)
        return pk, frz, jnp.where(do_rebuild, cnt, 0)

    def rebuild_grid(pk):
        """Rebuild the local grid + candidate windows over the updated own +
        halo rows."""
        alive_now = pk[:, 5] > 0.0
        gc = nbr_ops._bin_coords(gspec, pk[:, :3])
        flat, coords_l = _local_flat(
            spec_l, gc, col_off_jkr, row_off_jkr, alive_now
        )
        grid = nbr_ops.grid_from_flat_coords(
            flat, coords_l, pk[:, 4].astype(jnp.int32)
        )
        pos, valid, max_run = nbr_ops.window_from_grid(spec_l, grid)
        return (grid.order, pos, valid, pk[:, :3]), max_run

    def drift_probe(pk, win):
        """pmax'd global drift predicate + out-of-tile distance probe."""
        own_alive = pk[:P_own, 5] > 0.0
        drift2 = jnp.max(
            jnp.where(
                own_alive,
                jnp.sum((pk[:P_own, :3] - win[-1][:P_own]) ** 2, axis=-1),
                0.0,
            )
        )
        g_drift2 = jax.lax.pmax(drift2, AXIS)
        x_own = pk[:P_own, 0]
        exceed = jnp.max(
            jnp.where(own_alive, jnp.maximum(x_lo - x_own, x_own - x_hi), 0.0)
        )
        if Ty > 1:
            y_own = pk[:P_own, 1]
            exceed = jnp.maximum(
                exceed,
                jnp.max(jnp.where(
                    own_alive, jnp.maximum(y_lo - y_own, y_own - y_hi), 0.0
                )),
            )
        return g_drift2 > (skin * 0.5) ** 2, exceed

    def integrate(pk, forces, dt):
        new_loc = stokes_integrate(
            pk[:, :3], pk[:, 3], forces, mot, pk[:, 5] > 0.0, bio.stokes,
            size, dt,
        )
        move2 = jnp.max(
            jnp.where(
                pk[:P_own, 5] > 0.0,
                jnp.sum((new_loc[:P_own] - pk[:P_own, :3]) ** 2, axis=-1),
                0.0,
            )
        )
        return pk.at[:, :3].set(new_loc), move2

    def zero_v():
        return jax.lax.pcast(jnp.zeros((), jnp.int32), (AXIS,), to="varying")

    # --- scan entry: unconditional build -------------------------------------
    pk0 = pack_physics(arrays["locations"], arrays["radii"], arrays["ids"], alive)

    def zeros_frz4():
        return (jnp.zeros((H,), jnp.int32), jnp.zeros((H,), bool),
                jnp.zeros((H,), jnp.int32), jnp.zeros((H,), bool))

    frz_init = (zeros_frz4(), zeros_frz4()) if Ty > 1 else zeros_frz4()
    pk0, frz0, band0 = exchange_and_update(pk0, frz_init, jnp.asarray(True))
    win0, max_run0 = rebuild_grid(pk0)

    store_radius = (None if base.bond_band_margin is None else
                    bio.jkr_radius - base.bond_band_margin)

    def substep(carry, dt):
        pk, bonds, win, frz = carry
        do_rebuild, exceed = drift_probe(pk, win)
        pk, frz, band_cnt = exchange_and_update(pk, frz, do_rebuild)
        win2, max_run = jax.lax.cond(
            do_rebuild, rebuild_grid, lambda _: (win, zero_v()), pk
        )
        order, pos, valid, _ = win2
        forces, bonds, max_degree = jkr_ops.jkr_substep(
            bonds, pk, order, pos, valid, bio.jkr_radius,
            bio.adhesion_const, bio.poisson, bio.youngs, bio.jkr_break_d,
            store_radius=store_radius,
        )
        pk, move2 = integrate(pk, forces, dt)
        return (pk, bonds, win2, frz), (
            max_run, max_degree, band_cnt, exceed, move2,
        )

    (pk, bonds, _, _), (runs, degs, bands, exceeds, moves2) = (
        jax.lax.scan(substep, (pk0, bonds, win0, frz0), jnp.asarray(dts))
    )
    return (
        pk[:, :3],
        bonds,
        jnp.maximum(jnp.max(runs), max_run0),
        jnp.max(degs),
        jnp.maximum(jnp.max(bands), band0),
        jnp.zeros((), jnp.int32),  # halo_miss: structurally zero (frozen
        # sender-side membership — a frozen member is always resent)
        jnp.max(exceeds),
        jnp.sqrt(jnp.max(moves2)),
    )


def _migrate(cfg, base, arrays, alive, bonds, ncl, nch, prev_ncl, next_nch,
             axis=0):
    """Re-home own agents whose nbr-lattice column (``axis=0``) or row
    (``axis=1``) left the tile: full-state packs ppermute to the adjacent
    tile along that axis and land in its free slots. Called once per
    decomposed axis, x first (dimension-ordered routing: a diagonal crossing
    is delivered in two hops). The single-chip engine has no analog (slots
    are global there); slot choice is layout-local and identity rides the
    agent id, so dynamics are unaffected."""
    P_own = cfg.per_stripe
    M = cfg.mig_cap
    C = cfg.local_capacity
    K = bonds.partners.shape[1]

    gcoords = nbr_ops._bin_coords(base.nbr_spec, arrays["locations"][:P_own])
    col = gcoords[:, axis]
    alive_own = alive[:P_own]
    out_left = alive_own & (col < ncl)
    out_right = alive_own & (col >= nch)
    # pathology probe: an emigrant skipping a tile cannot be delivered by
    # one ring shift; drift_allowance growth cannot fix that — safe_step raises
    too_far = jnp.sum(out_left & (col < prev_ncl)) + jnp.sum(
        out_right & (col >= next_nch)
    )

    idxL, valL, cntL = _compact_idx(out_left, M)
    idxR, valR, cntR = _compact_idx(out_right, M)
    mig_out_max = jnp.maximum(cntL, cntR)

    lanes = [arrays[k][:P_own] for k in _MIG_FIELDS]
    bond_lane = jnp.where(
        bonds.mask[:P_own], bonds.partners[:P_own], -1
    ).astype(jnp.float32)
    lanes.append(bond_lane)

    def build(idx, val):
        pack = _gather_pack(lanes, idx, val)
        return jnp.concatenate([pack, val.astype(jnp.float32)[:, None]], axis=1)

    from_left, from_right = _axis_exchange(
        build(idxL, valL), build(idxR, valR), cfg.n_tx, cfg.n_ty, axis
    )

    # clear emigrant slots, then place immigrants into free own slots
    alive_own = alive_own & ~(out_left | out_right)
    imm = jnp.concatenate([from_left, from_right], axis=0)  # (2M, L)
    imm_valid = imm[:, -1] > 0.0
    num_imm = jnp.sum(imm_valid)

    free = ~alive_own
    num_free = jnp.sum(free)
    free_rank = jnp.cumsum(free) - 1
    cap2 = 2 * M
    slot_of_rank = jnp.full((cap2,), C, jnp.int32).at[
        jnp.where(free & (free_rank < cap2), free_rank, cap2)
    ].set(jnp.arange(P_own, dtype=jnp.int32), mode="drop")
    imm_rank = jnp.cumsum(imm_valid) - 1
    placeable = imm_valid & (imm_rank < num_free)
    dest = jnp.where(
        placeable, slot_of_rank[jnp.clip(imm_rank, 0, cap2 - 1)], C
    ).astype(jnp.int32)
    mig_shortfall = num_imm - jnp.sum(placeable)

    c = 0
    for k in _MIG_FIELDS:
        arr = arrays[k]
        w = arr.shape[1] if arr.ndim == 2 else 1
        vals = imm[:, c:c + w]
        if arr.ndim == 1:
            arrays[k] = arr.at[dest].set(vals[:, 0].astype(arr.dtype), mode="drop")
        else:
            arrays[k] = arr.at[dest].set(vals.astype(arr.dtype), mode="drop")
        c += w
    bp = imm[:, c:c + K]
    c += K
    new_partners = bonds.partners.at[dest].set(
        jnp.maximum(bp, 0).astype(jnp.int32), mode="drop"
    )
    new_mask = bonds.mask.at[dest].set(bp >= 0, mode="drop")
    bonds = BondState(partners=new_partners, mask=new_mask)

    alive_new = jnp.concatenate([alive_own, jnp.zeros((C - P_own,), bool)])
    alive_new = alive_new.at[dest].set(True, mode="drop")
    return arrays, alive_new, bonds, mig_out_max, mig_shortfall, too_far


def domain_config_to_meta(cfg: DomainConfig) -> dict:
    """DomainConfig as a JSON-able dict (checkpoint metadata). Bit-exact
    resume needs the exact static configuration (probe caps feed RNG draw
    shapes and growth state), not one re-derived from data."""
    from hipsc_abm.engine import config_to_meta

    d = dataclasses.asdict(cfg)
    d["base"] = config_to_meta(cfg.base)
    d["col_bounds"] = list(cfg.col_bounds)
    d["row_bounds"] = list(cfg.row_bounds)
    return d


def domain_config_from_meta(meta: dict) -> DomainConfig:
    from hipsc_abm.engine import config_from_meta

    meta = dict(meta)
    meta["base"] = config_from_meta(meta["base"])
    meta["col_bounds"] = tuple(meta["col_bounds"])
    # tiling fields absent from pre-tiling checkpoints: stripe defaults
    meta.setdefault("n_ty", 1)
    meta["row_bounds"] = tuple(meta.get("row_bounds", ()))
    meta.setdefault("nbr_ny_local", 0)
    meta.setdefault("jkr_ny_local", 0)
    return DomainConfig(**meta)


# ---------------------------------------------------------------------------
# host-side driver
# ---------------------------------------------------------------------------


class DomainHipscEngine:
    """Host driver for the domain-decomposed engine: owns the column
    partition, the jitted shard_map step, and probe-driven capacity growth.

    Equivalent to ``HipscEngine`` for any colony (validated bit-for-ints /
    exactly-for-floats in ``tests/test_domain_engine.py``); communication per
    step is O(boundary band), not O(colony)."""

    def __init__(
        self,
        gen: GeneralParams,
        xp: ExperimentalParams,
        bio: Optional[BiologyParams] = None,
        diff: Optional[DiffusionParams] = None,
        mesh: Optional[Mesh] = None,
        n_stripes: Optional[int] = None,
        tiles: Optional[Tuple[int, int]] = None,
        per_stripe: Optional[int] = None,
        halo_cap: int = 256,
        mig_cap: int = 128,
        drift_allowance: float = 15.0,
        enable_diffusion: bool = False,
        enable_growth: bool = False,
        enable_stochastic: bool = False,
        enable_diff_surround: bool = False,
    ):
        self.gen = gen
        self.xp = xp
        self.bio = bio or BiologyParams()
        self.diff = diff
        if tiles is not None and n_stripes is not None:
            raise ValueError("pass either tiles=(n_tx, n_ty) or n_stripes")
        if mesh is None:
            n = (tiles[0] * tiles[1]) if tiles else (
                n_stripes or jax.device_count()
            )
            mesh = Mesh(np.array(jax.devices()[:n]), (AXIS,))
        self.mesh = mesh
        S = mesh.devices.size
        n_ty = tiles[1] if tiles else 1
        if S % n_ty != 0 or (tiles and tiles[0] * tiles[1] != S):
            raise ValueError(
                f"tiles {tiles} do not match the {S}-device mesh"
            )
        n0 = gen.num_to_start + xp.num_gata6
        capacity = max(_round_up(int(n0 * 1.3), 256), 256)
        base = EngineConfig.create(
            gen.size,
            capacity=capacity,  # informational; per-stripe caps rule below
            bio=self.bio,
            enable_diffusion=enable_diffusion,
            enable_growth=enable_growth,
            enable_stochastic=enable_stochastic,
            enable_diff_surround=enable_diff_surround,
        )
        if per_stripe is None:
            # worst-case imbalance headroom; the deferral/migration probes
            # grow it if a stripe ever packs denser
            per_stripe = max(_round_up(int(n0 / S * 2.0), 256), 256)
        self.cfg = self._make_cfg(
            base, S, per_stripe, halo_cap, mig_cap, drift_allowance, n_ty=n_ty
        )
        self._compiled = {}
        self._repl_jit = {}

    def _axis_partition(self, base, n_parts, axis_i, drift, kind, bounds=None):
        """Bin-boundary partition of one box axis with sizing checks; returns
        (bounds, nbr_n_local, jkr_n_local). ``bounds=None`` splits the box
        uniformly; an explicit (n_parts+1,) tuple (e.g. the quantile bounds
        of ``balanced_bounds``) is validated against the same width rules."""
        cell = base.nbr_spec.cell_size
        jcell = base.jkr_spec.cell_size
        size_a = self.gen.size[axis_i]
        lo, hi = 1, int(math.ceil(size_a / cell)) + 2
        if bounds is None:
            bounds = tuple(
                lo + round(i * (hi - lo) / n_parts) for i in range(n_parts + 1)
            )
        else:
            bounds = tuple(int(b) for b in bounds)
            if len(bounds) != n_parts + 1 or bounds[0] != lo or bounds[-1] != hi:
                raise ValueError(
                    f"explicit {kind} bounds must span [{lo}, {hi}]: {bounds}"
                )
        widths = [bounds[i + 1] - bounds[i] for i in range(n_parts)]
        if min(widths) < 3:
            raise ValueError(
                f"{kind} need >= 3 neighbor-bin {'columns' if axis_i == 0 else 'rows'}; "
                f"box {size_a} um / {n_parts} {kind} gives widths {widths}"
            )
        min_width_um = min(widths) * cell
        need = 2 * drift + 2 * jcell + cell
        if min_width_um <= need:
            raise ValueError(
                f"{kind} width {min_width_um:.0f} um must exceed "
                f"2*drift + 2*contact bins = {need:.0f} um; use fewer {kind}"
            )
        nbr_n_local = max(widths) + 4
        # local jkr lattice: cover [lo - drift, hi + drift] plus the two
        # receive bands and clip pads
        jkr_n_local = 0
        for s in range(n_parts):
            a_lo = (bounds[s] - 1) * cell
            a_hi = (bounds[s + 1] - 1) * cell
            lo_col = math.floor((a_lo - drift) / jcell) + 1 - 4
            hi_col = math.floor((a_hi + drift) / jcell) + 1 + 4
            jkr_n_local = max(jkr_n_local, hi_col - lo_col + 1)
        return bounds, int(nbr_n_local), int(jkr_n_local)

    def _make_cfg(
        self, base, S, per_stripe, halo_cap, mig_cap, drift, n_ty=1,
        col_bounds=None, row_bounds=None,
    ) -> DomainConfig:
        n_tx = S // n_ty
        xb, nbr_nx_local, jkr_nx_local = self._axis_partition(
            base, n_tx, 0, drift, "stripes", bounds=col_bounds
        )
        if n_ty > 1:
            yb, nbr_ny_local, jkr_ny_local = self._axis_partition(
                base, n_ty, 1, drift, "y-tiles", bounds=row_bounds
            )
        else:
            yb, nbr_ny_local, jkr_ny_local = (), 0, 0
        return DomainConfig(
            base=base,
            n_stripes=S,
            per_stripe=int(per_stripe),
            halo_cap=_round_up(int(halo_cap), 128),
            mig_cap=int(mig_cap),
            div_cap=max(128, _round_up(int(per_stripe) // 32, 128)),
            drift_allowance=float(drift),
            col_bounds=xb,
            nbr_nx_local=nbr_nx_local,
            jkr_nx_local=jkr_nx_local,
            n_ty=int(n_ty),
            row_bounds=yb,
            nbr_ny_local=nbr_ny_local,
            jkr_ny_local=jkr_ny_local,
        )

    def _stripe_consts(self, cfg: DomainConfig):
        """Per-tile static constants as (S, n) device arrays (each device
        reads its own row under shard_map). One set per decomposed axis; for
        pure x-stripes the y entries are benign full-range dummies (the y
        phase is statically absent from the compiled step)."""
        base = cfg.base
        cell = base.nbr_spec.cell_size
        jcell = base.jkr_spec.cell_size
        D = cfg.drift_allowance
        S, Ty = cfg.n_stripes, cfg.n_ty
        Tx = cfg.n_tx
        xb = cfg.col_bounds
        yb = cfg.row_bounds
        sci = np.zeros((S, 20), np.int32)
        scf = np.zeros((S, 4), np.float32)

        def cjk(x):
            return math.floor(x / jcell) + 1

        def axis_consts(lo_b, hi_b, prev_b, next_b):
            a_lo = (lo_b - 1) * cell
            a_hi = (hi_b - 1) * cell
            off_nbr = lo_b - 2
            off_jkr = cjk(a_lo - D) - 4
            # receive bins (freeze filter): everything my own rows can
            # probe given up-to-D out-of-tile drift, one bin of safety
            recv_lo = cjk(a_lo - D) - 2
            recv_hi = cjk(a_hi + D) + 2
            # fresh send bands: one bin wider than the adjacent tile's
            # receive bins so frozen members stay covered while drifting
            s_lo = cjk(a_lo + D) + 3  # lower neighbor's recv_hi + 1
            s_hi = cjk(a_hi - D) - 3  # upper neighbor's recv_lo - 1
            return (lo_b, hi_b, off_nbr, off_jkr, s_lo, s_hi,
                    recv_lo, recv_hi, prev_b, next_b, a_lo, a_hi)

        for tx in range(Tx):
            xc = axis_consts(
                xb[tx], xb[tx + 1],
                xb[tx - 1] if tx > 0 else 0,
                xb[tx + 2] if tx + 2 <= Tx else xb[Tx],
            )
            for ty in range(Ty):
                if Ty > 1:
                    yc = axis_consts(
                        yb[ty], yb[ty + 1],
                        yb[ty - 1] if ty > 0 else 0,
                        yb[ty + 2] if ty + 2 <= Ty else yb[Ty],
                    )
                else:
                    big = 1 << 20
                    yc = (0, big, 0, 0, 0, big, 0, big, 0, big, -1e30, 1e30)
                s = tx * Ty + ty
                sci[s] = [
                    xc[0], xc[1], yc[0], yc[1],  # ncl nch nrl nrh
                    xc[2], yc[2], xc[3], yc[3],  # nbr/jkr offsets
                    xc[4], xc[5], yc[4], yc[5],  # fresh send bands
                    xc[6], xc[7], yc[6], yc[7],  # receive bins
                    xc[8], xc[9], yc[8], yc[9],  # too-far bounds
                ]
                scf[s] = [xc[10], xc[11], yc[10], yc[11]]
        return jnp.asarray(sci), jnp.asarray(scf)

    # -- load balancing --------------------------------------------------------

    def _balanced_axis_bounds(self, vals_um, n_parts, axis_i, drift):
        """Equal-agent-count quantile bounds for one axis (bin-boundary
        integers), nudged to satisfy the minimum-width rules."""
        base = self.cfg.base
        cell = base.nbr_spec.cell_size
        jcell = base.jkr_spec.cell_size
        lo = 1
        hi = int(math.ceil(self.gen.size[axis_i] / cell)) + 2
        cols = np.clip(
            np.floor(np.asarray(vals_um) / cell).astype(np.int64) + 1, lo, hi - 1
        )
        qs = np.quantile(cols, np.linspace(0.0, 1.0, n_parts + 1)[1:-1])
        bounds = [lo] + [int(round(q)) + 1 for q in qs] + [hi]
        # enforce monotone bounds with the engine's minimum width (in bins):
        # > 2*drift + 2*contact bins of um, and >= 3 nbr columns
        min_bins = max(
            3, int(math.floor((2 * drift + 2 * jcell + cell) / cell)) + 1
        )
        if (hi - lo) < n_parts * min_bins:
            raise ValueError(
                f"axis {axis_i} has {hi - lo} bins; {n_parts} parts need "
                f">= {n_parts * min_bins}"
            )
        for i in range(1, n_parts):  # push up
            bounds[i] = max(bounds[i], bounds[i - 1] + min_bins)
        for i in range(n_parts - 1, 0, -1):  # pull back from the top
            bounds[i] = min(bounds[i], bounds[i + 1] - min_bins)
        return tuple(bounds)

    def rebalance(self, dstate: DomainState) -> DomainState:
        """Re-partition the tile grid at equal-agent-count quantiles of the
        CURRENT colony (x bounds by x-quantiles; the shared y bounds by
        global y-quantiles) and re-home every agent.

        Spatially uniform bounds waste per-tile slots on clustered colonies
        — the model's actual regime (colonies grow from seeded centers).
        Dynamics are partition-independent (the bit-exactness contract), so
        rebalancing at any step boundary leaves the trajectory unchanged
        (``tests/test_domain_tiles.py::test_rebalance_*``). Host-side; call
        sparingly (each new partition is a fresh compiled step)."""
        cfg = self.cfg
        cell_state = self._host_replicated(self.to_cell_state(dstate))
        locs = np.asarray(cell_state.arrays["locations"])
        alive = np.asarray(cell_state.alive)
        pts = locs[alive]
        if pts.shape[0] == 0:
            return dstate
        xb = self._balanced_axis_bounds(
            pts[:, 0], cfg.n_tx, 0, cfg.drift_allowance
        )
        yb = (
            self._balanced_axis_bounds(
                pts[:, 1], cfg.n_ty, 1, cfg.drift_allowance
            )
            if cfg.n_ty > 1 else None
        )
        self.cfg = self._make_cfg(
            cfg.base, cfg.n_stripes, cfg.per_stripe, cfg.halo_cap,
            cfg.mig_cap, cfg.drift_allowance, n_ty=cfg.n_ty,
            col_bounds=xb, row_bounds=yb,
        )
        self.cfg = dataclasses.replace(self.cfg, div_cap=cfg.div_cap)
        return self.from_cell_state(cell_state)

    # -- state construction ---------------------------------------------------

    def init_state(self, seed: int = 0, locations=None) -> DomainState:
        """Same colony as ``HipscEngine.init_state`` (identical RNG), laid out
        stripe-major by bin column."""
        helper = HipscEngine(
            self.gen, self.xp, bio=self.bio, diff=self.diff,
            cfg=self.cfg.base,
        )
        cell_state = helper.init_state(seed=seed, locations=locations)
        # adopt the data-driven run caps the helper derived
        self.cfg = dataclasses.replace(self.cfg, base=helper.cfg)
        return self.from_cell_state(cell_state)

    def from_cell_state(self, state: CellState) -> DomainState:
        """Partition a flat CellState into the tile-major layout."""
        state = self._host_replicated(state)  # host partitioner needs bytes
        cfg = self.cfg
        S, Pn = cfg.n_stripes, cfg.per_stripe
        Ty = cfg.n_ty
        K = state.bonds.partners.shape[1]
        locs = np.asarray(state.arrays["locations"])
        alive = np.asarray(state.alive)
        cell = cfg.base.nbr_spec.cell_size
        col = np.clip(
            np.floor(locs[:, 0] / cell).astype(np.int64) + 1,
            0, cfg.base.nbr_spec.nx - 1,
        )
        tx = np.clip(
            np.searchsorted(np.asarray(cfg.col_bounds[1:]), col, side="right"),
            0, cfg.n_tx - 1,
        )
        if Ty > 1:
            row = np.clip(
                np.floor(locs[:, 1] / cell).astype(np.int64) + 1,
                0, cfg.base.nbr_spec.ny - 1,
            )
            ty = np.clip(
                np.searchsorted(
                    np.asarray(cfg.row_bounds[1:]), row, side="right"
                ),
                0, Ty - 1,
            )
            stripe = tx * Ty + ty
        else:
            stripe = tx

        # a denser-than-headroom initial partition grows per_stripe up front
        # (the in-step mig_shortfall/deferral probes only cover growth DURING
        # a run)
        need = int(np.bincount(stripe[alive], minlength=S).max()) if alive.any() else 0
        if need > Pn:
            self.cfg = cfg = dataclasses.replace(
                cfg, per_stripe=_round_up(int(need * 1.5), 256)
            )
            Pn = cfg.per_stripe

        arrays = {
            k: np.zeros((S, Pn) + np.asarray(v).shape[1:], np.asarray(v).dtype)
            for k, v in state.arrays.items()
        }
        alive_out = np.zeros((S, Pn), bool)
        partners = np.zeros((S, Pn, K), np.int32)
        bmask = np.zeros((S, Pn, K), bool)
        src_p = np.asarray(state.bonds.partners)
        src_m = np.asarray(state.bonds.mask)
        for s in range(S):
            idx = np.where(alive & (stripe == s))[0]
            if len(idx) > Pn:
                raise ValueError(
                    f"stripe {s} holds {len(idx)} agents > per_stripe {Pn}"
                )
            n = len(idx)
            for k, v in state.arrays.items():
                arrays[k][s, :n] = np.asarray(v)[idx]
            alive_out[s, :n] = True
            partners[s, :n] = src_p[idx]
            bmask[s, :n] = src_m[idx]

        tile = P(AXIS)
        repl = P()
        return DomainState(
            arrays={k: self._to_global(v, tile) for k, v in arrays.items()},
            alive=self._to_global(alive_out, tile),
            bonds=BondState(
                partners=self._to_global(partners, tile),
                mask=self._to_global(bmask, tile),
            ),
            gradients={
                k: self._to_global(v, repl) for k, v in state.gradients.items()
            },
            key=self._to_global(state.key, repl),
            step=self._to_global(state.step, repl),
            next_id=self._to_global(state.next_id, repl),
        )

    def _host_replicated(self, tree):
        """A PyTree whose every leaf each process can read on the host. A
        cross-process (non-fully-addressable) leaf is resharded to fully
        replicated first — one collective gather per leaf, O(colony) per
        process by construction. This is what makes the rare full-colony
        host paths (drift-recovery re-partition, ``rebalance``, the flat
        parity checkpoint) work under multi-controller execution; the
        pod-scale steady-state paths (step, sharded checkpoints) never
        call it."""
        leaves = jax.tree_util.tree_leaves(tree)
        if all(getattr(l, "is_fully_addressable", True) for l in leaves):
            return tree
        # cache the jitted gather per tree structure: a fresh lambda per call
        # would never hit the jit cache, recompiling on every rebalance /
        # drift-recovery re-partition / flat checkpoint
        key = jax.tree_util.tree_structure(tree)
        fn = self._repl_jit.get(key)
        if fn is None:
            repl = jax.sharding.NamedSharding(self.mesh, P())
            shardings = jax.tree_util.tree_map(lambda _: repl, tree)
            fn = jax.jit(lambda x: x, out_shardings=shardings)
            self._repl_jit[key] = fn
        return fn(tree)

    def _to_global(self, value, spec) -> jax.Array:
        """A mesh-global array from a host value every process holds
        identically. Under multi-controller JAX (one process per host of a
        pod) each process contributes only the shards it addresses — this
        is what lets ``from_cell_state``/``load_checkpoint_sharded`` build a
        pod-wide DomainState without any process owning the whole colony's
        device memory. Single-process it is equivalent to a device_put."""
        a = np.asarray(value)
        sharding = jax.sharding.NamedSharding(self.mesh, spec)
        return jax.make_array_from_callback(a.shape, sharding, lambda i: a[i])

    def to_cell_state(self, dstate: DomainState, capacity: Optional[int] = None) -> CellState:
        """Flatten to a CellState (stripe-major slot order; agent identity is
        carried by ids, so compare engines by id, not slot)."""
        cfg = self.cfg
        S, Pn = cfg.n_stripes, cfg.per_stripe
        C = capacity or S * Pn
        arrays = {
            k: jnp.reshape(v, (S * Pn,) + v.shape[2:])[:C]
            for k, v in dstate.arrays.items()
        }
        return CellState(
            arrays=arrays,
            alive=jnp.reshape(dstate.alive, (S * Pn,))[:C],
            bonds=BondState(
                partners=jnp.reshape(dstate.bonds.partners, (S * Pn, -1))[:C],
                mask=jnp.reshape(dstate.bonds.mask, (S * Pn, -1))[:C],
            ),
            gradients=dict(dstate.gradients),
            key=dstate.key,
            step=dstate.step,
            next_id=dstate.next_id,
        )

    # -- checkpoint / resume ---------------------------------------------------
    #
    # The pod-scale analog of the reference's mode-1 contract
    # (``simulation.py:525-536``): a DomainState round-trips through the flat
    # CellState npz format plus the full DomainConfig as metadata. Dynamics
    # are layout-independent (id-keyed RNG, canonical-order windows), so the
    # re-partition on load — which may place agents in different slots than
    # the interrupted run held them in — yields bit-identical continuation
    # (validated by ``tests/test_domain_engine.py::
    # test_domain_checkpoint_resume_bit_exact``).

    def save_checkpoint(self, path: str, dstate: DomainState) -> None:
        from hipsc_abm.utils import checkpoint as ckpt

        ckpt.save_state(
            path, self._host_replicated(self.to_cell_state(dstate)),
            meta={"domain_config": domain_config_to_meta(self.cfg)},
        )

    def save_checkpoint_sharded(self, path: str, dstate: DomainState) -> None:
        """Per-tile checkpoint shards (``path/shard_{s}.npz`` + manifest) —
        the pod-scale save path: no O(colony) flatten; on a multi-host pod
        each host serializes only its local shards. Resume via
        ``load_checkpoint_sharded`` is bit-exact (layout-independent
        dynamics; re-partition on load)."""
        from hipsc_abm.utils import checkpoint as ckpt

        ckpt.save_domain_sharded(
            path, dstate,
            meta={"domain_config": domain_config_to_meta(self.cfg)},
        )

    def load_checkpoint_sharded(self, path: str, elastic: bool = False) -> DomainState:
        from hipsc_abm.utils import checkpoint as ckpt

        state, meta = ckpt.load_domain_sharded(path)
        return self._adopt_and_partition(state, meta, elastic=elastic)

    def write_values_sharded(
        self, dir_path: str, name: str, step: int, dstate: DomainState,
        order: Optional[Sequence[str]] = None,
    ) -> list:
        """Pod-scale value-CSV output: one ``{name}_values_{step}.shard{s}.csv``
        per tile, written by the process that addresses it (alive rows only,
        slot order, the parity ``name[i]`` headers, the native serialization
        tier per file) — no O(colony) gather anywhere. Merge into the
        reference's one-file format with ``utils.io.merge_sharded_values``
        wherever the single file is wanted. Returns the shard paths this
        process wrote. Closes docs/SCALING.md's "per-host output sharding"
        item."""
        from hipsc_abm.utils import checkpoint as ckpt
        from hipsc_abm.utils import io as io_utils

        os.makedirs(dir_path, exist_ok=True)
        S = int(dstate.alive.shape[0])
        order = list(order) if order is not None else sorted(dstate.arrays)
        alive_sh = ckpt._tile_shards(dstate.alive, S)
        leaf_sh = {k: ckpt._tile_shards(dstate.arrays[k], S) for k in order}
        written = []
        for s in sorted(alive_sh):
            mask = alive_sh[s]
            rows = {k: leaf_sh[k][s][mask] for k in order}
            path = os.path.join(
                dir_path, f"{name}_values_{step}.shard{s}.csv"
            )
            # atomic publish: a concurrent merge must never see a
            # half-written shard (same discipline as save_domain_sharded)
            io_utils.write_values_csv(path + ".tmp", rows, order)
            os.replace(path + ".tmp", path)
            written.append(path)
        return written

    def load_checkpoint(self, path: str, elastic: bool = False) -> DomainState:
        """Restore a DomainState; adopts the checkpoint's static configuration
        (capacities, probe caps, drift allowance) so resume is bit-exact.
        ``elastic=True`` instead resumes onto THIS engine's tiling (any
        device count — the recovery path when a pod host is lost): the
        checkpoint's base dynamics configuration is adopted, the
        decomposition is this engine's, and the result is still bit-exact
        because the dynamics are layout-independent (the same property the
        domain-vs-single-chip equivalence tests pin)."""
        from hipsc_abm.utils import checkpoint as ckpt

        state, meta = ckpt.load_state(path)
        return self._adopt_and_partition(state, meta, elastic=elastic)

    def _adopt_and_partition(
        self, state: CellState, meta: dict, elastic: bool = False
    ) -> DomainState:
        if elastic:
            # keep THIS engine's decomposition; adopt the checkpoint's
            # base dynamics config (bond width K must match the saved
            # partner matrix; caps/feature gates must match the run being
            # resumed). A flat single-chip checkpoint carries the base as
            # engine_config.
            from hipsc_abm.engine import config_from_meta

            if "domain_config" in meta:
                base = domain_config_from_meta(meta["domain_config"]).base
            elif "engine_config" in meta:
                base = config_from_meta(meta["engine_config"])
            else:
                base = None
            if base is not None:
                self.cfg = self._make_cfg(
                    base, self.cfg.n_stripes, self.cfg.per_stripe,
                    self.cfg.halo_cap, self.cfg.mig_cap,
                    self.cfg.drift_allowance, n_ty=self.cfg.n_ty,
                )
        elif "domain_config" in meta:
            cfg = domain_config_from_meta(meta["domain_config"])
            if cfg.n_stripes != self.mesh.devices.size:
                raise ValueError(
                    f"checkpoint has {cfg.n_stripes} stripes; mesh has "
                    f"{self.mesh.devices.size} devices (pass "
                    "elastic=True to re-partition onto this mesh)"
                )
            self.cfg = cfg
        return self.from_cell_state(state)

    # -- stepping --------------------------------------------------------------

    def _step_fn(self, cfg: DomainConfig):
        lkey = (cfg, self.gen, self.xp, self.bio, self.diff, self.mesh)
        if lkey not in self._compiled:
            body = functools.partial(
                _domain_step_body,
                cfg=cfg, gen=self.gen, xp=self.xp, bio=self.bio, diff=self.diff,
            )
            sharded = P(AXIS)
            repl = P()

            def specs_like(state_arrays):
                return jax.tree_util.tree_map(lambda _: sharded, state_arrays)

            def run(arrays, alive, partners, bmask, gradients, key, step, next_id,
                    sci, scf):
                in_specs = (
                    specs_like(arrays), sharded, sharded, sharded,
                    jax.tree_util.tree_map(lambda _: repl, gradients),
                    repl, repl, repl, sharded, sharded,
                )
                out_specs = (
                    specs_like(arrays), sharded, sharded, sharded,
                    jax.tree_util.tree_map(lambda _: repl, gradients),
                    repl, repl, repl,
                    DomainStepInfo(*([repl] * len(DomainStepInfo._fields))),
                )
                return shard_map(
                    body, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs,
                )(arrays, alive, partners, bmask, gradients, key, step, next_id,
                  sci, scf)

            self._compiled[lkey] = jax.jit(run)
        return self._compiled[lkey]

    def _global_consts(self, cfg: DomainConfig):
        # per-tile constants as mesh-global arrays (multi-controller: a
        # plain numpy jit argument cannot satisfy a mesh-spanning in_spec);
        # cached per config object so steady-state steps skip the transfer
        cached = getattr(self, "_consts_global", None)
        if cached is not None and cached[0] is cfg:
            return cached[1], cached[2]
        sci_np, scf_np = self._stripe_consts(cfg)
        sci = self._to_global(sci_np, P(AXIS))
        scf = self._to_global(scf_np, P(AXIS))
        self._consts_global = (cfg, sci, scf)
        return sci, scf

    def step(self, state: DomainState) -> Tuple[DomainState, DomainStepInfo]:
        cfg = self._cfg_for_state(state)
        sci, scf = self._global_consts(cfg)
        out = self._step_fn(cfg)(
            state.arrays, state.alive, state.bonds.partners, state.bonds.mask,
            state.gradients, state.key, state.step, state.next_id, sci, scf,
        )
        (arrays, alive, partners, bmask, gradients, key, step, next_id, info) = out
        new_state = DomainState(
            arrays=arrays, alive=alive,
            bonds=BondState(partners=partners, mask=bmask),
            gradients=gradients, key=key, step=step, next_id=next_id,
        )
        return new_state, info

    def _block_fn(self, cfg: DomainConfig, k: int):
        """jitted ``lax.scan`` of k full domain steps (scan OUTSIDE the
        shard_map: each iteration is one mesh-wide sharded step): one
        dispatch + one stacked probe fetch per block — the host-latency
        killer matters MOST here, where every fetch crosses the
        multi-controller boundary (see HipscEngine._block_fn)."""
        lkey = ("block", k, cfg, self.gen, self.xp, self.bio, self.diff,
                self.mesh)
        if lkey not in self._compiled:
            step_fn = self._step_fn(cfg)

            def run_block(arrays, alive, partners, bmask, gradients, key,
                          step, next_id, sci, scf):
                def body(carry, _):
                    (arrays, alive, partners, bmask, gradients, key, step,
                     next_id) = carry
                    out = step_fn(arrays, alive, partners, bmask, gradients,
                                  key, step, next_id, sci, scf)
                    return out[:8], out[8]

                carry0 = (arrays, alive, partners, bmask, gradients, key,
                          step, next_id)
                carry, infos = jax.lax.scan(body, carry0, None, length=k)
                return carry, infos

            self._compiled[lkey] = jax.jit(run_block)
        return self._compiled[lkey]

    def run_steps(
        self, state: DomainState, k: int
    ) -> Tuple[DomainState, DomainStepInfo]:
        """Run ``k`` domain steps device-resident with exact overflow
        recovery — semantics identical to ``k`` ``safe_step`` calls; the
        block re-executes WHOLE from its unmodified input after growth
        (the same exactness argument). Returned ``DomainStepInfo`` fields
        carry a leading (k,) axis."""
        if k < 1:
            raise ValueError(f"run_steps needs k >= 1, got {k}")
        for _ in range(16):
            cfg = self._cfg_for_state(state)
            sci, scf = self._global_consts(cfg)
            carry, infos = self._block_fn(cfg, k)(
                state.arrays, state.alive, state.bonds.partners,
                state.bonds.mask, state.gradients, state.key, state.step,
                state.next_id, sci, scf,
            )
            (arrays, alive, partners, bmask, gradients, key, step,
             next_id) = carry
            new_state = DomainState(
                arrays=arrays, alive=alive,
                bonds=BondState(partners=partners, mask=bmask),
                gradients=gradients, key=key, step=step, next_id=next_id,
            )
            infos = DomainStepInfo(*jax.device_get(tuple(infos)))
            worst = DomainStepInfo(
                *(np.max(np.asarray(f), axis=0) for f in infos))
            if int(worst.max_id) >= (1 << 24) - 1:
                raise RuntimeError("agent id space exhausted (2^24)")
            if int(worst.mig_too_far) > 0:
                raise RuntimeError(
                    "an agent crossed an entire stripe in one step; the "
                    "decomposition cannot deliver it — use fewer stripes"
                )
            try:
                grown = self._grown_cfg(cfg, worst)
            except ValueError:
                self.cfg = cfg
                flat = self.to_cell_state(state)
                self.cfg = self._grown_cfg(cfg, worst, drop_bounds=True)
                state = self.from_cell_state(flat)
                try:
                    state = self.rebalance(state)
                except ValueError:
                    pass  # keep the uniform partition
                continue
            if grown is None:
                return new_state, infos
            self.cfg = grown
            state = self.repad_state(state, grown)
        raise RuntimeError("capacity growth failed to converge")

    def _cfg_for_state(self, state: DomainState) -> DomainConfig:
        cfg = self.cfg
        Pn = state.alive.shape[1]
        K = state.bonds.partners.shape[2]
        if cfg.per_stripe != Pn or cfg.base.bond_cap != K:
            cfg = dataclasses.replace(
                cfg, per_stripe=Pn, base=dataclasses.replace(cfg.base, bond_cap=K)
            )
        return cfg

    def safe_step(self, state: DomainState) -> Tuple[DomainState, DomainStepInfo]:
        """Step with exact overflow recovery: any tripped probe grows its
        static capacity and re-executes from the unmodified input state."""
        for _ in range(16):
            new_state, info = self.step(state)
            # one batched transfer for all growth probes (see
            # HipscEngine.safe_step)
            info = DomainStepInfo(*jax.device_get(tuple(info)))
            if int(info.max_id) >= (1 << 24) - 1:
                raise RuntimeError("agent id space exhausted (2^24)")
            if int(info.mig_too_far) > 0:
                raise RuntimeError(
                    "an agent crossed an entire stripe in one step; the "
                    "decomposition cannot deliver it — use fewer stripes"
                )
            cfg_now = self._cfg_for_state(state)
            try:
                grown = self._grown_cfg(cfg_now, info)
            except ValueError:
                # a grown drift allowance can push the minimum tile width
                # past a tight (load-balanced) partition's narrowest tile:
                # re-derive the partition under the new constraints — first
                # uniform (always feasible if the box supports the grid at
                # the new drift; loud otherwise), then re-balance — and
                # re-home the colony into it
                self.cfg = cfg_now
                flat = self.to_cell_state(state)
                self.cfg = self._grown_cfg(cfg_now, info, drop_bounds=True)
                state = self.from_cell_state(flat)
                try:
                    state = self.rebalance(state)
                except ValueError:
                    pass  # keep the uniform partition
                continue
            if grown is None:
                return new_state, info
            self.cfg = grown
            state = self.repad_state(state, grown)
        raise RuntimeError("capacity growth failed to converge")

    def _grown_cfg(
        self, cfg: DomainConfig, info: DomainStepInfo, drop_bounds: bool = False
    ) -> Optional[DomainConfig]:
        changed = False
        base = cfg.base
        if int(info.nbr_max_in_bin) > base.nbr_spec.run_cap:
            base = dataclasses.replace(
                base,
                nbr_spec=dataclasses.replace(
                    base.nbr_spec,
                    run_cap=_round_up(int(info.nbr_max_in_bin) * 2, 8),
                ),
            )
            changed = True
        if int(info.jkr_max_in_bin) > base.jkr_spec.run_cap:
            base = dataclasses.replace(
                base,
                jkr_spec=dataclasses.replace(
                    base.jkr_spec,
                    run_cap=_round_up(int(info.jkr_max_in_bin) * 2, 8),
                ),
            )
            changed = True
        bond_cap = base.bond_cap
        if int(info.jkr_max_degree) > bond_cap:
            from hipsc_abm.engine import (
                _BOND_CAP_GUARD_MSG, max_safe_bond_cap)
            need = _round_up(int(info.jkr_max_degree) * 2, 8)
            limit = max_safe_bond_cap()
            if need > limit:
                # same guarded limit as the single-chip engine
                raise RuntimeError(_BOND_CAP_GUARD_MSG.format(
                    deg=int(info.jkr_max_degree), need=need, limit=limit))
            base = dataclasses.replace(base, bond_cap=need)
            changed = True
        per_stripe = cfg.per_stripe
        div_cap = cfg.div_cap
        if int(info.num_dividing) > div_cap:
            div_cap = min(_round_up(int(info.num_dividing) * 2, 128), per_stripe)
            changed = True
        elif int(info.num_deferred) > 0 or int(info.mig_shortfall) > 0:
            per_stripe = _round_up(per_stripe * 2, 256)
            changed = True
        halo_cap = cfg.halo_cap
        band_need = max(int(info.bio_band_max), int(info.phys_band_max))
        if band_need > halo_cap:
            halo_cap = _round_up(band_need * 2, 128)
            changed = True
        mig_cap = cfg.mig_cap
        if int(info.mig_out_max) > mig_cap:
            mig_cap = _round_up(int(info.mig_out_max) * 2, 8)
            changed = True
        drift = cfg.drift_allowance
        if float(info.drift_exceed) > drift or int(info.halo_miss) > 0:
            drift = drift * 2.0
            changed = True
        margin = base.bond_band_margin
        if margin is not None:
            bio_disp = 2.0 * (self.bio.max_radius - self.bio.min_radius)
            required = 2.0 * float(info.max_substep_move) + bio_disp
            if required > margin:
                new_margin = min(required * 1.5, self.bio.jkr_radius)
                if new_margin > margin:
                    base = dataclasses.replace(base, bond_band_margin=new_margin)
                    changed = True
        if not changed:
            return None
        # re-derive partition-dependent statics (bands depend on drift),
        # keeping the existing — possibly load-balanced — bounds unless the
        # caller asked for a fresh uniform partition (``drop_bounds``: the
        # grown drift rejected the custom bounds; safe_step re-homes)
        new = self._make_cfg(
            base, cfg.n_stripes, per_stripe, halo_cap, mig_cap, drift,
            n_ty=cfg.n_ty,
            col_bounds=None if drop_bounds else cfg.col_bounds,
            row_bounds=None if (drop_bounds or cfg.n_ty == 1) else cfg.row_bounds,
        )
        return dataclasses.replace(new, div_cap=div_cap)

    @staticmethod
    def repad_state(state: DomainState, cfg: DomainConfig) -> DomainState:
        """Pad a state to grown per-stripe / bond capacities."""
        Pn = cfg.per_stripe
        K = cfg.base.bond_cap

        def pad_axis1(a):
            if a.shape[1] == Pn:
                return a
            pad = [(0, 0), (0, Pn - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
            return jnp.pad(a, pad)

        partners = pad_axis1(state.bonds.partners)
        mask = pad_axis1(state.bonds.mask)
        if K != partners.shape[2]:
            if K < partners.shape[2]:
                raise ValueError("bond capacity cannot shrink")
            partners = jnp.pad(partners, ((0, 0), (0, 0), (0, K - partners.shape[2])))
            mask = jnp.pad(mask, ((0, 0), (0, 0), (0, K - mask.shape[2])))
        return DomainState(
            arrays={k: pad_axis1(v) for k, v in state.arrays.items()},
            alive=pad_axis1(state.alive),
            bonds=BondState(partners=partners, mask=mask),
            gradients=state.gradients,
            key=state.key,
            step=state.step,
            next_id=state.next_id,
        )
