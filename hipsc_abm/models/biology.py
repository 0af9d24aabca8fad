"""hiPSC biology phases as pure, vectorized JAX functions.

Re-implements every method of the reference ``CellMethods`` mixin
(``cell_methods.py``), including the three methods the reference ships but
keeps commented out of its schedule (``cell_growth``, ``cell_stochastic_update``,
``cell_diff_surround`` — ``cell_simulation.py:98-100``).

The reference runs serial Python loops that read partially-updated state in
index order (e.g. ``cell_pathway`` reads neighbors' already-updated FGF4
values for lower indices). These functions use synchronous (parallel) update
semantics: every agent reads the pre-update state. This is a deliberate,
tested divergence — the update order of a serial loop over an unordered agent
set is not a meaningful part of the model.

All functions take the fixed-capacity slot arrays plus the padded neighbor
window (``cand_idx``, ``nbr_mask``) produced by ``ops.neighbors`` and return
updated arrays. Randomness is *id-keyed* (``ops.rng``): every draw is a pure
function of (step key, stable agent id, stream salt), so results are
bit-exactly reproducible on resume AND identical across slot layouts —
the property the domain-decomposed multi-chip engine relies on.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from hipsc_abm.models.params import BiologyParams, ExperimentalParams
from hipsc_abm.ops import rng


def random_vectors(key: jax.Array, n: int, two_d: bool, dtype=jnp.float32) -> jnp.ndarray:
    """Batch of the reference's ``random_vector`` (``simulation.py:473-486``):
    a point on the unit circle when the space is 2D (z = 0), else the
    reference's (cos(phi) cos(theta), cos(phi) sin(theta), sin(phi)) sphere
    parameterization — reproduced as-is, including its non-uniform density."""
    if two_d:
        theta = jax.random.uniform(key, (n,), dtype) * (2.0 * math.pi)
        return jnp.stack([jnp.cos(theta), jnp.sin(theta), jnp.zeros_like(theta)], axis=-1)
    k1, k2 = jax.random.split(key)
    theta = jax.random.uniform(k1, (n,), dtype) * (2.0 * math.pi)
    phi = jax.random.uniform(k2, (n,), dtype) * (2.0 * math.pi)
    radius = jnp.cos(phi)
    return jnp.stack(
        [radius * jnp.cos(theta), radius * jnp.sin(theta), jnp.sin(phi)], axis=-1
    )


def normalize_rows(v: jnp.ndarray) -> jnp.ndarray:
    """Safe row normalization (``normal_vector``, ``backend.py:186-196``).

    Written so reverse-mode gradients stay finite at v = 0: the sqrt input is
    guarded BEFORE the sqrt (its cotangent at 0 is inf, and an inf in the
    discarded where-branch still poisons the gradient as 0 * inf = NaN). The
    primal is bit-identical to ``v / ||v||`` with the zero rows zeroed."""
    mag2 = jnp.sum(v * v, axis=-1, keepdims=True)
    pos = mag2 > 0
    mag = jnp.sqrt(jnp.where(pos, mag2, 1.0))
    return jnp.where(pos, v / mag, 0.0)


# ---------------------------------------------------------------------------
# death / division (population dynamics over masked slots)
# ---------------------------------------------------------------------------


def cell_death(
    states: jnp.ndarray,
    death_counters: jnp.ndarray,
    alive: jnp.ndarray,
    nbr_count: jnp.ndarray,
    lonely_thresh: int,
    death_thresh: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """``cell_death`` (``cell_methods.py:11-52``): lonely pluripotent cells
    age a death counter; at threshold the slot is freed (np.delete over every
    array becomes a mask clear). Returns (counters, removal_mask, num_removed).
    """
    pluri = alive & (states == 0)
    lonely = nbr_count < lonely_thresh
    counters = jnp.where(pluri, jnp.where(lonely, death_counters + 1, 0), death_counters)
    remove = pluri & (counters >= death_thresh)
    return counters, remove, jnp.sum(remove)


def allocate_daughter_slots(
    dividing: jnp.ndarray,
    alive: jnp.ndarray,
    canon_order: jnp.ndarray,
    div_cap: int,
    allocatable: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Rank-compressed daughter-slot allocation.

    Replaces the reference's array-append growth (``cell_methods.py:86-94``).
    Mothers are ranked in the canonical (bin, id) order (layout-independent);
    the r-th mother claims the r-th free slot (slot order — slot choice is
    layout-local, identity is carried by ids). The mapping is materialized as
    two small ``(div_cap,)`` tables built with ONE capacity-sized scatter
    each, so the per-array daughter writes in ``cell_division`` touch only
    ``div_cap`` rows — a full-capacity ``.at[...].set`` per array costed
    ~16 ms x 15 arrays at 500k agents.

    Mothers beyond the free-slot supply or the static ``div_cap`` are
    deferred (their counters stay >= threshold; the host grows the
    overflowed capacity and re-executes). Returns ``(can_divide, rank,
    mother_of_rank, free_slot_of_rank, num_deferred)``; unused table rows
    hold the out-of-range sentinel ``capacity``.

    ``allocatable`` restricts which dead slots may receive daughters (the
    domain-decomposed engine excludes its halo rows); default: every slot.
    """
    capacity = alive.shape[0]
    rank = canonical_rank(dividing, canon_order)
    free = ~alive
    if allocatable is not None:
        free = free & allocatable
    num_free = jnp.sum(free)
    limit = jnp.minimum(num_free, div_cap)
    can_divide = dividing & (rank < limit)

    slots = jnp.arange(capacity, dtype=jnp.int32)
    mother_of_rank = jnp.full((div_cap,), capacity, dtype=jnp.int32).at[
        jnp.where(can_divide, rank, div_cap)
    ].set(slots, mode="drop")
    free_rank = jnp.cumsum(free) - 1
    free_slot_of_rank = jnp.full((div_cap,), capacity, dtype=jnp.int32).at[
        jnp.where(free & (free_rank < div_cap), free_rank, div_cap)
    ].set(slots, mode="drop")
    # free slots beyond the mother count must stay untouched
    num_can = jnp.sum(can_divide)
    r = jnp.arange(div_cap, dtype=jnp.int32)
    free_slot_of_rank = jnp.where(r < num_can, free_slot_of_rank, capacity)
    num_deferred = jnp.sum(dividing) - num_can
    return can_divide, rank, mother_of_rank, free_slot_of_rank, num_deferred


def canonical_rank(mask: jnp.ndarray, canon_order) -> jnp.ndarray:
    """Per-slot rank of the masked agents in the canonical (bin, id) order
    ``canon_order`` (a permutation of slots, e.g. ``Grid.order``). The rank is
    layout-independent — the same agent set gets the same ranks regardless of
    slot permutation or domain decomposition — which makes daughter-id
    assignment identical between the single-device and domain engines.
    ``None`` means the slots already ARE in canonical order (the sorted-
    resident engine): the rank is then a plain cumsum."""
    if canon_order is None:
        return jnp.cumsum(mask.astype(jnp.int32)) - 1
    m_srt = mask[canon_order].astype(jnp.int32)
    rank_srt = jnp.cumsum(m_srt) - 1
    return jnp.zeros_like(rank_srt).at[canon_order].set(rank_srt)


def division_clock(
    arrays: Dict[str, jnp.ndarray],
    alive: jnp.ndarray,
    nbr_count: jnp.ndarray,
    key: jax.Array,
    p: BiologyParams,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Division-decision half of ``cell_division`` (``cell_methods.py:54-83``):
    advance the stochastic clocks and decide who divides this step. Split from
    ``division_apply`` so the domain-decomposed engine can all-gather the
    per-stripe dividing counts (for globally consistent daughter ids) between
    the two. Returns ``(div_counters, dividing)``."""
    div_counters = arrays["div_counters"] + jnp.where(
        alive, rng.coin_flips(key, arrays["ids"], salt=0), 0
    )
    states = arrays["states"]
    pluri_div = (states == 0) & (div_counters >= p.pluri_div_thresh)
    diff_div = (
        (states != 0)
        & (div_counters >= p.diff_div_thresh)
        & (nbr_count < p.div_inhibit_neighbors)
    )
    dividing = alive & (pluri_div | diff_div)
    return div_counters, dividing


def division_apply(
    arrays: Dict[str, jnp.ndarray],
    alive: jnp.ndarray,
    div_counters: jnp.ndarray,
    dividing: jnp.ndarray,
    key: jax.Array,
    p: BiologyParams,
    two_d: bool,
    canon_order: jnp.ndarray,
    next_id: jnp.ndarray,
    div_cap: int,
    allocatable: Optional[jnp.ndarray] = None,
    rank_offset: jnp.ndarray | int = 0,
) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Daughter-creation half of ``cell_division`` (``cell_methods.py:86-117``).

    ``rank_offset`` shifts daughter ids: a daughter gets id ``next_id +
    rank_offset + local canonical rank``. The single-device engine passes 0;
    the domain engine passes the summed dividing counts of lower stripes, so
    ids equal the single-device assignment (global canonical rank) exactly.
    Returns (arrays, alive, daughter_mask, num_added, num_deferred).
    """
    capacity = alive.shape[0]
    ids = arrays["ids"]
    can_divide, _, mother_of_rank, write_slot, num_deferred = (
        allocate_daughter_slots(dividing, alive, canon_order, div_cap, allocatable)
    )

    # mother/daughter displacement (cell_methods.py:103-105): daughter copies
    # the mother's pre-displacement location, then moves -disp; mother +disp.
    disp = rng.unit_vectors(key, ids, two_d, salt=1).astype(
        arrays["locations"].dtype
    ) * (p.max_radius - p.min_radius)

    # out-of-range mother rows (unused ranks) gather clamped garbage, but
    # their write_slot is the capacity sentinel, so the write drops them
    new_arrays = {}
    for name, arr in arrays.items():
        if name == "locations":
            daughter_val = (arr - disp)[mother_of_rank]
            arr = arr.at[write_slot].set(daughter_val, mode="drop")
            arr = jnp.where(can_divide[:, None], arr + disp, arr)
        elif name == "div_counters":
            arr = div_counters.at[write_slot].set(0, mode="drop")
            arr = jnp.where(can_divide, 0, arr)
        elif name == "ids":
            daughter_ids = (
                next_id + rank_offset + jnp.arange(div_cap, dtype=jnp.int32)
            )
            arr = arr.at[write_slot].set(daughter_ids, mode="drop")
        else:
            arr = arr.at[write_slot].set(arr[mother_of_rank], mode="drop")
        new_arrays[name] = arr

    daughter_mask = jnp.zeros((capacity,), dtype=bool).at[write_slot].set(True, mode="drop")
    new_alive = alive | daughter_mask
    return new_arrays, new_alive, daughter_mask, jnp.sum(can_divide), num_deferred


def cell_division(
    arrays: Dict[str, jnp.ndarray],
    alive: jnp.ndarray,
    nbr_count: jnp.ndarray,
    key: jax.Array,
    p: BiologyParams,
    two_d: bool,
    canon_order: Optional[jnp.ndarray] = None,
    next_id: Optional[jnp.ndarray] = None,
    div_cap: Optional[int] = None,
) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """``cell_division`` (``cell_methods.py:54-117``).

    Stochastic division clocks; pluripotent cells divide at
    ``pluri_div_thresh``, differentiated at ``diff_div_thresh`` under contact
    inhibition. A daughter is a full copy of the mother's slot values written
    into a free slot; the pair is displaced +/- a random vector scaled by
    (max_radius - min_radius); both division counters reset. Daughters get
    fresh stable ids ``next_id + canonical rank of their mother`` — slot
    choice is layout-local, the id is not. Per-array daughter writes go
    through the rank-compressed ``(div_cap,)`` tables of
    ``allocate_daughter_slots`` (mothers past ``div_cap`` defer; the host
    grows it on the ``num_dividing`` probe).

    Returns (arrays, alive, daughter_mask, num_added, num_deferred,
    num_dividing).
    """
    capacity = alive.shape[0]
    if next_id is None:
        # max over ALL slot ids, not just alive ones: a dead slot keeps its
        # stale id until recycled, so this never reassigns a dead agent's id
        # (id-keyed RNG and stale bond entries rely on ids never recurring)
        next_id = jnp.max(arrays["ids"]) + 1
    if div_cap is None:
        div_cap = capacity

    div_counters, dividing = division_clock(arrays, alive, nbr_count, key, p)
    new_arrays, new_alive, daughter_mask, num_added, num_deferred = division_apply(
        arrays, alive, div_counters, dividing, key, p, two_d,
        canon_order, next_id, div_cap,
    )
    return (
        new_arrays, new_alive, daughter_mask, num_added,
        num_deferred, jnp.sum(dividing),
    )


# ---------------------------------------------------------------------------
# intracellular pathway / fate
# ---------------------------------------------------------------------------


def cell_pathway(
    FGF4: jnp.ndarray,
    FGFR: jnp.ndarray,
    ERK: jnp.ndarray,
    GATA6: jnp.ndarray,
    NANOG: jnp.ndarray,
    fds_counters: jnp.ndarray,
    ids: jnp.ndarray,
    alive: jnp.ndarray,
    nbr_count: jnp.ndarray,  # (C,) neighbors in the post-death graph
    nbr_FGF4_sum: jnp.ndarray,  # (C,) f32 sum of neighbors' FGF4
    nbr_FGF4_sq_sum: jnp.ndarray,  # (C,) f32 sum of neighbors' FGF4^2
    key: jax.Array,
    current_step: jnp.ndarray,
    xp: ExperimentalParams,
    p: BiologyParams,
    field_fgf4: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, ...]:
    """``cell_pathway`` (``cell_methods.py:176-228``): perceived FGF4 is the
    noisy mean over the closed neighborhood; the finite dynamical system
    (Boolean BN_9 for field=2, ternary polynomial otherwise) advances every
    ``fds_thresh`` steps, gated on doxycycline induction.

    Noise form: the reference draws one iid gaussian per neighborhood term,
    ``sum_j (1 + g_ij) F_j / n`` (``cell_methods.py:190-192``). A sum of
    independent gaussians scaled by F_j is itself gaussian, so this is
    *exactly* equal in distribution to ``(sum F + g sqrt(sum F^2)) / n`` with
    a single per-agent g ~ N(0,1) — and the per-agent draws are independent
    across agents in the reference too (it redraws per (agent, neighbor)
    visit). The moment form needs only two masked reductions over the
    neighborhood, which the windowed reduction supplies directly.

    ``field_fgf4`` (diffusion field coupling, ``DiffusionParams
    .field_coupling``): when given, perceived FGF4 is instead the morphogen
    concentration sampled at the cell's nearest diffusion point
    (``get_concentration`` semantics, reference ``cell_methods.py:470-483``)
    with the same multiplicative ``(1 + g)`` noise applied to the single
    term, floored and clamped identically.
    """
    active = alive & (current_step >= xp.dox_step)

    g = rng.normal(key, ids, salt=0)
    if field_fgf4 is not None:
        perceived = (1.0 + g) * field_fgf4.astype(jnp.float32)
    else:
        f_self = FGF4.astype(jnp.float32)
        n_closed = (nbr_count + 1).astype(jnp.float32)
        sum_f = nbr_FGF4_sum + f_self
        sum_f2 = nbr_FGF4_sq_sum + f_self * f_self
        perceived = (sum_f + g * jnp.sqrt(sum_f2)) / n_closed
    perceived = jnp.clip(jnp.floor(perceived), 0, p.field - 1).astype(jnp.int32)

    update = active & (fds_counters % p.fds_thresh == 0)

    x1, x2, x3, x4, x5 = perceived, FGFR, ERK, GATA6, NANOG
    if p.field == 2:
        # Boolean network BN_9 (cell_methods.py:212-216)
        nFGF4 = x5
        nFGFR = (1 + x5 + x4 * x5) % 2
        nERK = (x1 * x2) % 2
        nGATA6 = (x3 + x4 + x3 * x4 + x3 * x5 + x4 * x5 + x3 * x4 * x5) % 2
        nNANOG = (x5 + x3 * x5 + x4 * x5 + x3 * x4 * x5) % 2
    else:
        # ternary variant (cell_methods.py:219-225)
        nFGF4 = x5
        nFGFR = (x1 * x4 * ((2 * x1 + 1) * (2 * x4 + 1) + x1 * x4)) % 3
        nERK = x2 % 3
        nGATA6 = ((x4**2) * (x5 + 1) + (x5**2) * (x4 + 1) + 2 * x5 + 1) % 3
        nNANOG = (
            x5**2
            + x5 * (x5 + 1) * (x3 * (2 * x4**2 + 2 * x3 + 1) + x4 * (2 * x3**2 + 2 * x4 + 1))
            + (2 * x3**2 + 1) * (2 * x4**2 + 1)
        ) % 3

    FGF4 = jnp.where(update, nFGF4, FGF4)
    FGFR = jnp.where(update, nFGFR, FGFR)
    ERK = jnp.where(update, nERK, ERK)
    GATA6 = jnp.where(update, nGATA6, GATA6)
    NANOG = jnp.where(update, nNANOG, NANOG)
    fds_counters = jnp.where(active, fds_counters + 1, fds_counters)
    return FGF4, FGFR, ERK, GATA6, NANOG, fds_counters


def cell_differentiate(
    GATA6: jnp.ndarray,
    NANOG: jnp.ndarray,
    states: jnp.ndarray,
    diff_counters: jnp.ndarray,
    ids: jnp.ndarray,
    alive: jnp.ndarray,
    key: jax.Array,
    p: BiologyParams,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """``cell_differentiate`` (``cell_methods.py:230-244``)."""
    eligible = alive & (GATA6 > NANOG) & (states == 0)
    counters = diff_counters + jnp.where(eligible, rng.coin_flips(key, ids), 0)
    trigger = eligible & (counters >= p.pluri_to_diff)
    states = jnp.where(trigger, 1, states)
    NANOG = jnp.where(trigger, 0, NANOG)
    return NANOG, states, counters


def cell_diff_surround(
    GATA6: jnp.ndarray,
    NANOG: jnp.ndarray,
    states: jnp.ndarray,
    alive: jnp.ndarray,
    num_diff_neighbors: jnp.ndarray,  # (C,) differentiated-neighbor count
    p: BiologyParams,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``cell_diff_surround`` (``cell_methods.py:119-141``): >= 6 differentiated
    neighbors force a GATA6-low pluripotent cell to GATA6 high."""
    eligible = alive & (states == 0) & (GATA6 < NANOG)
    induce = eligible & (num_diff_neighbors >= p.diff_surround_neighbors)
    return jnp.where(induce, p.field - 1, GATA6), jnp.where(induce, 0, NANOG)


def cell_growth(
    radii: jnp.ndarray,
    states: jnp.ndarray,
    div_counters: jnp.ndarray,
    alive: jnp.ndarray,
    p: BiologyParams,
) -> jnp.ndarray:
    """``cell_growth`` (``cell_methods.py:143-158``): linear radius growth by
    state, re-derived from the division clock (no clamp, as in the reference)."""
    growing = alive & (radii < p.max_radius)
    dc = div_counters.astype(radii.dtype)
    target = jnp.where(
        states == 0, p.pluri_growth * dc + p.min_radius, p.diff_growth * dc + p.min_radius
    )
    return jnp.where(growing, target, radii)


def cell_stochastic_update(
    GATA6: jnp.ndarray,
    NANOG: jnp.ndarray,
    ids: jnp.ndarray,
    alive: jnp.ndarray,
    key: jax.Array,
    p: BiologyParams,
    nanog_too: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``cell_stochastic_update`` (``cell_methods.py:160-174``): random GATA6
    bump with probability ``GATA6_prob``. The NANOG branch is commented out in
    the reference; pass ``nanog_too=True`` to enable it."""
    bump_g = rng.uniform(key, ids, salt=0) < p.GATA6_prob
    GATA6 = jnp.where(alive & bump_g & (GATA6 != p.field - 1), GATA6 + 1, GATA6)
    if nanog_too:
        bump_n = rng.uniform(key, ids, salt=1) < p.NANOG_prob
        NANOG = jnp.where(alive & bump_n & (NANOG != p.field - 1), NANOG + 1, NANOG)
    return GATA6, NANOG


# ---------------------------------------------------------------------------
# motility
# ---------------------------------------------------------------------------


def cell_motility(
    locations: jnp.ndarray,
    GATA6: jnp.ndarray,
    NANOG: jnp.ndarray,
    states: jnp.ndarray,
    motility_forces: jnp.ndarray,
    ids: jnp.ndarray,
    alive: jnp.ndarray,
    nbr_count: jnp.ndarray,  # (C,) neighbors in the post-death graph
    cnt_nanog: jnp.ndarray,  # (C,) NANOG-high neighbor count
    sum_nanog_disp: jnp.ndarray,  # (C, 3) sum of (loc_j - loc_i), NANOG-high j
    cnt_diff: jnp.ndarray,  # (C,) differentiated neighbor count
    sum_diff_disp: jnp.ndarray,  # (C, 3) sum of (loc_j - loc_i), diff j
    key: jax.Array,
    xp: ExperimentalParams,
    p: BiologyParams,
    two_d: bool,
) -> jnp.ndarray:
    """``cell_motility`` (``cell_methods.py:246-340``).

    Cells with fewer than 6 neighbors get a motive force by type:
    - differentiated: away from NANOG-high neighbors (-0.8 normal + 0.2 random);
    - GATA6-high pluripotent under ``guye_move``: toward differentiated
      neighbors. NOTE the reference's guye branch tests the *self* state
      (``cell_methods.py:287``), so its GATA6-high cells always move randomly;
      ``p.guye_bug_compat`` (default True) reproduces that behavior exactly,
      False applies the evidently-intended neighbor-state rule;
    - GATA6-high pluripotent otherwise: away from NANOG-high neighbors;
    - NANOG-high pluripotent: toward NANOG-high neighbors;
    - undecided: random walk.
    """
    free_to_move = alive & (nbr_count < p.motility_crowd_neighbors)

    rand = rng.unit_vectors(key, ids, two_d).astype(locations.dtype)
    away_nanog = jnp.where(
        (cnt_nanog > 0)[:, None],
        normalize_rows(sum_nanog_disp) * -0.8 + rand * 0.2,
        rand,
    )
    toward_nanog = jnp.where(
        (cnt_nanog > 0)[:, None],
        normalize_rows(sum_nanog_disp) * 0.8 + rand * 0.2,
        rand,
    )
    toward_diff = jnp.where(
        (cnt_diff > 0)[:, None],
        normalize_rows(sum_diff_disp) * 0.8 + rand * 0.2,
        rand,
    )

    is_diff = states != 0
    gata6_high = GATA6 > NANOG
    nanog_high = GATA6 < NANOG

    if xp.guye_move:
        guye_dir = rand if p.guye_bug_compat else toward_diff
    else:
        guye_dir = away_nanog

    direction = jnp.where(
        is_diff[:, None],
        away_nanog,
        jnp.where(
            gata6_high[:, None],
            guye_dir,
            jnp.where(nanog_high[:, None], toward_nanog, rand),
        ),
    )
    force = jnp.where(free_to_move[:, None], direction * p.motility_force, 0.0)
    return motility_forces + force
