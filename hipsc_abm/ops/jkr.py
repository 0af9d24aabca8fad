"""Johnson-Kendall-Roberts contact mechanics with persistent bonds.

Replaces the reference's ``calculate_jkr`` + ``jkr_forces_cpu/gpu``
(``cell_methods.py:342-384``, ``cell_backend.py:6-115``) and the igraph
``jkr_graph`` whose edges persist across physics substeps and simulation steps
(``get_neighbors(..., clear=False)``, ``simulation.py:286-288``).

Reference semantics reproduced exactly:
- each substep, pairs within ``2 * max_radius`` gain an edge (bond);
- forces are evaluated on all current edges; the cubic JKR polynomial applies
  while the nondimensional overlap ``d > -0.360562``, otherwise the bond
  breaks and exerts no force (``cell_backend.py:39,94``);
- a bond formed earlier persists even if the pair has drifted slightly beyond
  the search radius, until it crosses the break threshold.

Design: the edge list becomes a per-agent padded partner matrix
``(C, K)``; each undirected bond is stored once per endpoint, so per-agent
force accumulation is a row-wise masked reduction — no scatter-add, hence
deterministic (the reference's parallel ``+=`` at ``cell_backend.py:108-109``
is an accepted data race).

Gather discipline: all per-agent features consumed across a window —
position, radius, slot id, liveness — are packed into one 8-lane f32 row
(``pack_physics``). Each substep then costs exactly two row gathers (pack -> sorted order, sorted -> window). Slot ids
are exact in f32 up to 2^24 agents.

Per substep (single windowed pass — the caller sizes the window's bins to
``search radius + break band + Verlet skin`` so every force-active pair,
bonded or fresh, is provably inside the window):
1. a pair is force-eligible iff it is a fresh contact within the search
   radius OR already in the bond graph;
2. eligible pairs inside the break threshold exert force and form the next
   bond set; everything else breaks (bonds outside the window are already
   past the break distance and drop out automatically);
3. the surviving set is compacted back to the (C, K) partner matrix, with
   on-device overflow detection driving host-side capacity doubling.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

PACK_WIDTH = 8  # [x, y, z, radius, agent_id, alive, pad, pad]


class BondState(NamedTuple):
    """Persistent bonded-partner matrix for one graph.

    Partners are stored by **stable agent id**, not slot index: ids never get
    recycled (unlike slots, where a daughter can claim a just-died agent's
    slot), so a stale entry can never rebind to a different agent — it simply
    never matches any window candidate again and drops out at the next
    compaction. This also makes the bond state layout-independent (the
    domain-decomposed engine migrates agents between per-device slot blocks
    without touching bond contents)."""

    partners: jnp.ndarray  # (C, K) int32 partner agent ids
    mask: jnp.ndarray  # (C, K) bool

    @classmethod
    def empty(cls, capacity: int, bond_cap: int) -> "BondState":
        return cls(
            partners=jnp.zeros((capacity, bond_cap), dtype=jnp.int32),
            mask=jnp.zeros((capacity, bond_cap), dtype=bool),
        )

    def degree(self) -> jnp.ndarray:
        return jnp.sum(self.mask, axis=1).astype(jnp.int32)


def pack_physics(
    locations: jnp.ndarray,
    radii: jnp.ndarray,
    ids: jnp.ndarray,
    alive: jnp.ndarray,
) -> jnp.ndarray:
    """(C, 8) f32 feature rows for gather-efficient windowed physics.
    ``ids`` are the stable agent ids (exact in f32 below 2^24; the engine's
    overflow probe guards the bound)."""
    capacity = locations.shape[0]
    return jnp.concatenate(
        [
            locations.astype(jnp.float32),
            radii.astype(jnp.float32)[:, None],
            ids.astype(jnp.float32)[:, None],
            alive.astype(jnp.float32)[:, None],
            jnp.zeros((capacity, PACK_WIDTH - 6), dtype=jnp.float32),
        ],
        axis=1,
    )


def _pair_jkr(
    loc_i: jnp.ndarray,  # (..., 3) row agent locations
    loc_j: jnp.ndarray,  # (..., 3) partner locations
    rad_i: jnp.ndarray,  # (...,)
    rad_j: jnp.ndarray,  # (...,)
    adhesion_const: float,
    poisson: float,
    youngs: float,
    break_d: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pair JKR force on the row agent and bond-survival flag.

    Direct vectorization of the per-edge math in ``jkr_forces_cpu``
    (``cell_backend.py:73-113``); locations in um, forces in N.
    """
    # Guards below keep reverse-mode gradients finite on degenerate pairs
    # (self/padded slots: mag = 0 or r_hat = 0) without changing the primal
    # by a single bit: sqrt/pow inputs are replaced BEFORE the op (their
    # cotangents at 0 are inf, and 0 * inf = NaN even in a discarded
    # where-branch), and the cubic's argument is clamped only where the
    # unclamped value would overflow f32 anyway. This is what makes the
    # whole physics pipeline differentiable for ``calibrate.py``.
    vector = loc_i - loc_j
    mag2 = jnp.sum(vector * vector, axis=-1)
    mag_pos = mag2 > 0
    mag = jnp.where(mag_pos, jnp.sqrt(jnp.where(mag_pos, mag2, 1.0)), 0.0)
    overlap = (rad_i + rad_j - mag) / 1e6  # um -> m

    e_hat = 1.0 / (2.0 * (1.0 - poisson**2) / youngs)
    # == 1/(1e6 (1/r_i + 1/r_j)), written division-safe for garbage slots
    r_hat = (rad_i * rad_j) / (1e6 * jnp.maximum(rad_i + rad_j, 1e-12))  # um -> m
    r_pos = r_hat > 0
    safe_r = jnp.where(r_pos, r_hat, 1.0)
    overlap_ = jnp.where(
        r_pos,
        ((math.pi * adhesion_const) / e_hat) ** (2.0 / 3.0) * safe_r ** (1.0 / 3.0),
        0.0,
    )
    d = overlap / jnp.maximum(overlap_, 1e-30)

    alive_bond = d > break_d
    # physical pairs sit at |d| ~ 1; only degenerate slots (overlap_ == 0)
    # reach the clamp, and those overflowed the cubic before it existed
    d_f = jnp.clip(d, -1e8, 1e8)
    f = ((-0.0204 * d_f + 0.4942) * d_f + 1.0801) * d_f - 1.324
    jkr_force = f * math.pi * adhesion_const * r_hat  # N

    safe_mag = jnp.where(mag_pos, mag, 1.0)
    normal = jnp.where(mag_pos[..., None], vector / safe_mag[..., None], 0.0)
    force = jnp.where(alive_bond[..., None], jkr_force[..., None] * normal, 0.0)
    return force, alive_bond


def _is_bonded(bonds: BondState, cand_slot: jnp.ndarray) -> jnp.ndarray:
    """(C, W) membership of each window candidate in the row's bond list
    (single fused (C, W, K) broadcast compare)."""
    return jnp.any(
        (cand_slot[:, :, None] == bonds.partners[:, None, :]) & bonds.mask[:, None, :],
        axis=2,
    )


def _compact_bonds(
    partners_ext: jnp.ndarray,  # (C, K + W) candidate partner ids
    mask_ext: jnp.ndarray,  # (C, K + W)
    bond_cap: int,
) -> Tuple[BondState, jnp.ndarray]:
    """Compact a masked extended partner set to the first `bond_cap` entries
    per row. Returns the new BondState and the max row degree (overflow probe
    for host-side doubling, mirroring ``graph.max_neighbors`` growth at
    ``simulation.py:277-281``)."""
    k = min(bond_cap, partners_ext.shape[1])
    # first-k-masked compaction as a one-hot masked sum in int32: each output
    # element has at most one nonzero term, and integer addition is exact
    # (an f32 contraction may run in TF32 on the GPU, which keeps ids exact
    # only below 2^11)
    dest = jnp.cumsum(mask_ext, axis=1) - 1  # (C, T) rank among kept entries
    onehot = (dest[:, :, None] == jnp.arange(k)[None, None, :]) & mask_ext[:, :, None]
    new_partners = jnp.sum(
        jnp.where(onehot, partners_ext.astype(jnp.int32)[:, :, None], 0), axis=1
    )
    new_mask = jnp.any(onehot, axis=1)
    if k < bond_cap:  # window narrower than the bond capacity: pad
        pad = ((0, 0), (0, bond_cap - k))
        new_partners = jnp.pad(new_partners, pad)
        new_mask = jnp.pad(new_mask, pad)
    degree = jnp.sum(mask_ext, axis=1)
    return BondState(partners=new_partners, mask=new_mask), jnp.max(degree)


def window_cand_ids(
    packed: jnp.ndarray, order: jnp.ndarray, pos: jnp.ndarray
) -> jnp.ndarray:
    """(C, W) candidate agent ids of a window (only needed at bond conversion
    points, not in the per-substep hot path)."""
    return packed[order, 4][pos]


def bonds_to_window_mask(bonds: BondState, cand_id: jnp.ndarray) -> jnp.ndarray:
    """Align the persistent (C, K) bond set to a window: (C, W) bond mask."""
    return _is_bonded(bonds, cand_id)


def window_mask_to_bonds(
    cand_slot: jnp.ndarray, mask: jnp.ndarray, bond_cap: int
) -> Tuple[BondState, jnp.ndarray]:
    """Compact a window-aligned bond mask back to the (C, K) partner matrix.
    Returns (bonds, max row degree) — the overflow probe."""
    return _compact_bonds(cand_slot, mask, bond_cap)


def jkr_substep_aligned(
    bond_mask: jnp.ndarray,  # (C, W) bond set aligned to the current window
    packed: jnp.ndarray,  # (C, 8) pack_physics rows, slot order
    order: jnp.ndarray,  # (C,) grid sort order
    pos: jnp.ndarray,  # (C, W) candidate sorted positions
    valid: jnp.ndarray,  # (C, W) window validity
    radius: float,  # contact search radius (2 * max_radius)
    adhesion_const: float,
    poisson: float,
    youngs: float,
    break_d: float,
    store_radius: Optional[float] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One physics substep with the bond set held window-aligned.

    While the Verlet window is reused across substeps, the bond set is just a
    (C, W) mask over it: bond membership is the mask itself and the updated
    set is the ``keep`` mask — no partner-matrix compaction (top_k) or
    membership scan in the hot path. Conversions to/from the slot-space
    (C, K) matrix happen only at window rebuilds and scan boundaries
    (``bonds_to_window_mask`` / ``window_mask_to_bonds``).

    **Band storage** (``store_radius``): a stored bond only changes behavior
    for pairs beyond the search radius — inside it, fresh contact makes the
    pair eligible regardless. Pairs deeper than ``store_radius = radius -
    band_margin`` cannot drift past the search radius before the next force
    evaluation (band_margin bounds one substep's pair separation change plus
    one division displacement; the engine probes the bound), so only the
    outer band needs remembering. This shrinks the live bond matrix from
    mean contact degree (~6) to mean band degree (<2), halving the bond
    bookkeeping in the fused kernel. ``None`` stores the full edge set (the
    reference's literal graph).

    Returns ``(jkr_forces (C,3), new_bond_mask (stored set), max_degree
    (stored count probe))``; force-equivalent to the reference sequence
    [``get_neighbors(jkr_graph, 2*max_radius, clear=False)`` ->
    ``calculate_jkr`` -> edge deletion] at ``cell_methods.py:399-404``.
    """
    self_xyz = packed[:, :3]
    self_rad = packed[:, 3]
    row_alive = packed[:, 5] > 0.0
    self_id = packed[:, 4]

    # The window is guaranteed (by bin sizing: search radius + break band +
    # Verlet skin) to contain every force-active pair — fresh contacts within
    # the search radius AND persisted bonds out to the break distance. A
    # bonded pair outside the window is therefore already past the break
    # threshold and drops out of the state automatically, so one windowed
    # pass covers bond evaluation, bond breaking, and fresh-contact formation.
    sorted_pack = packed[order]
    cand = sorted_pack[pos]  # (C, W, 8) — the one wide window gather
    cand_xyz = cand[..., :3]
    cand_rad = cand[..., 3]
    cand_id = cand[..., 4]

    delta = cand_xyz - self_xyz[:, None, :]
    dist2 = jnp.sum(delta * delta, axis=-1)
    r = jnp.float32(radius)
    pair_ok = valid & (cand_id != self_id[:, None]) & row_alive[:, None]
    # force-eligible: fresh contact within the search radius, or an edge
    # already in the bond graph (clear=False persistence,
    # cell_methods.py:401 + simulation.py:286-288)
    eligible = pair_ok & ((dist2 <= r * r) | bond_mask)

    force, survive = _pair_jkr(
        self_xyz[:, None, :], cand_xyz, self_rad[:, None], cand_rad,
        adhesion_const, poisson, youngs, break_d,
    )
    keep = eligible & survive
    forces = jnp.sum(jnp.where(keep[..., None], force, 0.0), axis=1)
    if store_radius is not None:
        sr = jnp.float32(store_radius)
        stored = keep & (dist2 > sr * sr)
    else:
        stored = keep
    max_degree = jnp.max(jnp.sum(stored, axis=1))
    return forces, stored, max_degree


def jkr_substep(
    bonds: BondState,
    packed: jnp.ndarray,
    order: jnp.ndarray,
    pos: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float,
    adhesion_const: float,
    poisson: float,
    youngs: float,
    break_d: float,
    store_radius: Optional[float] = None,
) -> Tuple[jnp.ndarray, BondState, jnp.ndarray]:
    """Slot-space wrapper over ``jkr_substep_aligned``: converts the (C, K)
    bond matrix to a window mask, runs the substep, compacts back. Used by
    tests and one-shot callers; the engine's scan keeps the mask form."""
    cand_id = window_cand_ids(packed, order, pos)
    bond_mask = bonds_to_window_mask(bonds, cand_id)
    forces, stored, _ = jkr_substep_aligned(
        bond_mask, packed, order, pos, valid, radius,
        adhesion_const, poisson, youngs, break_d, store_radius,
    )
    with jax.named_scope("bond_compaction"):
        new_bonds, max_degree = window_mask_to_bonds(
            cand_id, stored, bonds.partners.shape[1]
        )
    return forces, new_bonds, max_degree


def clear_bond_rows(bonds: BondState, rows_to_clear: jnp.ndarray) -> BondState:
    """Empty the bond rows of given slots (daughters on division get fresh
    graph vertices with no edges — ``cell_methods.py:112-113``).

    Dead *partners* need no explicit cleanup (the reference's
    ``delete_vertices`` edge removal, ``cell_methods.py:47-48``): a dead
    agent's id never appears in any candidate window again, so its bonds
    exert no force and vanish at the next in-window compaction — and because
    ids are never recycled, the stale entry can't rebind to a new agent."""
    return BondState(
        partners=bonds.partners,
        mask=bonds.mask & ~rows_to_clear[:, None],
    )
