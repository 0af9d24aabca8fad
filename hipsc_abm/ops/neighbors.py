"""Sorted-uniform-grid fixed-radius neighbor engine.

Replaces the reference's bin/bucket machinery and Numba kernels:
- ``assign_bins`` + ``assign_bins_jit`` (reference ``simulation.py:190-223``,
  ``backend.py:31-50``): a scatter of agent indices into a dense
  ``(bx, by, bz, slot)`` array with a host-side adaptive-capacity retry loop.
- ``get_neighbors_cpu/gpu`` (reference ``backend.py:64-160``): a 27-bin
  candidate scan emitting a dynamic edge list into igraph, with a host-side
  ``max_neighbors`` doubling loop.

Design — no dynamic shapes, no per-bin tables:

1. Agents are sorted by row-major flat bin id (``argsort``; dead slots get a
   sentinel id and sort to the end).
2. The 3x3(x3) stencil around an agent's bin decomposes into **contiguous
   runs** of flat ids: with the last spatial axis minor in the flat id, the
   three bins ``(x+dx, y-1..y+1)`` are three *consecutive* ids, so the whole
   stencil is 3 runs (2D) or 9 runs (3D). Each run's members are one
   contiguous slice of the sorted order, located with two vectorized
   ``searchsorted`` probes per agent — O(C) work independent of lattice size
   (the reference's dense ``bins`` array is O(lattice x capacity)).
3. Candidates are gathered as a static ``(C, n_runs * run_cap)`` padded
   window with a validity mask. ``run_cap`` (max live agents in any 3-bin
   run) is sized from data; overflow is detected on-device and surfaced to
   the host, which doubles the static capacity and re-executes — the
   reference's adaptive doubling, amortized to O(log) recompiles per run.

Consumers (neighbor counting, FDS pathway means, motility sums, JKR forces)
operate directly on the padded window with masked reductions, so undirected
edges are seen once from each endpoint's row and per-agent accumulation needs
no scatter-add at all — deterministic by construction, unlike the reference's
racy ``prange`` ``+=`` (``cell_backend.py:108-109``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a uniform bin lattice for one search radius.

    Mirrors the reference geometry: bin edge length == search radius, a +1
    index offset and padded border bins so the stencil never wraps across a
    lattice edge for in-box agents (``simulation.py:202,210``).
    ``run_cap`` is the static max number of live agents in any contiguous
    3-bin stencil run (grown adaptively by the host on overflow).
    """

    cell_size: float
    nx: int
    ny: int
    nz: int
    two_d: bool
    run_cap: int

    @classmethod
    def from_box(
        cls,
        size: Tuple[float, float, float],
        radius: float,
        run_cap: int,
    ) -> "GridSpec":
        nx = int(math.ceil(size[0] / radius)) + 3
        ny = int(math.ceil(size[1] / radius)) + 3
        two_d = size[2] == 0
        nz = 1 if two_d else int(math.ceil(size[2] / radius)) + 3
        return cls(cell_size=float(radius), nx=nx, ny=ny, nz=nz, two_d=two_d,
                   run_cap=int(run_cap))

    @property
    def num_bins(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def run_offsets(self) -> Tuple[Tuple[int, ...], ...]:
        """Stencil decomposition into contiguous 3-bin runs: offsets in the
        major axes; the minor axis spans -1..+1 within each run."""
        if self.two_d:
            return tuple((dx,) for dx in (-1, 0, 1))
        return tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))

    @property
    def window(self) -> int:
        """Static candidate-window width W = n_runs * run_cap."""
        return len(self.run_offsets) * self.run_cap


class Grid(NamedTuple):
    """Built spatial index over one snapshot of agent locations."""

    order: jnp.ndarray  # (C,) agent slots sorted by flat bin id (dead last)
    sorted_flat: jnp.ndarray  # (C,) flat bin id per sorted position
    coords: jnp.ndarray  # (C, 3) per-agent integer bin coordinates


def _bin_coords(spec: GridSpec, locations: jnp.ndarray) -> jnp.ndarray:
    coords = jnp.floor(locations / spec.cell_size).astype(jnp.int32) + 1
    dims = jnp.array([spec.nx, spec.ny, spec.nz], dtype=jnp.int32)
    return jnp.clip(coords, 0, dims - 1)


def dead_sentinel(spec: GridSpec) -> int:
    """Flat id assigned to dead slots: beyond every live id AND beyond every
    stencil probe a live row can make (max probe = num_bins - 1 + max run
    offset + 2), so flat-id interval tests never match dead candidates."""
    reach = spec.ny if spec.two_d else (spec.ny + 1) * spec.nz
    return spec.num_bins + reach + 3


def flat_bin_ids(spec: GridSpec, locations: jnp.ndarray, alive: jnp.ndarray) -> jnp.ndarray:
    """Row-major flat bin id per agent; dead slots get the sentinel."""
    coords = _bin_coords(spec, locations)
    if spec.two_d:
        flat = coords[:, 0] * spec.ny + coords[:, 1]
    else:
        flat = (coords[:, 0] * spec.ny + coords[:, 1]) * spec.nz + coords[:, 2]
    return jnp.where(alive, flat, dead_sentinel(spec))


def build_grid(
    spec: GridSpec,
    locations: jnp.ndarray,
    ids: jnp.ndarray,
    alive: jnp.ndarray,
) -> Grid:
    """Sort agents into the **canonical (flat bin, agent id) order**
    (replaces ``assign_bins_jit``, ``backend.py:31-50``, without the dense
    bins array or the retry loop).

    The id tie-break makes the order a pure function of the agent *set*, not
    its slot layout: any permutation of slots — including the stripe-major
    layout of the domain-decomposed engine — yields the same sorted sequence
    of agents. Daughter-id assignment and windowed float summation order
    both inherit this layout independence.
    """
    capacity = locations.shape[0]
    flat = flat_bin_ids(spec, locations, alive)
    _, _, order = jax.lax.sort(
        (flat, ids.astype(jnp.int32), jnp.arange(capacity, dtype=jnp.int32)),
        num_keys=2,
    )
    return Grid(
        order=order.astype(jnp.int32),
        sorted_flat=flat[order],
        coords=_bin_coords(spec, locations),
    )


def grid_from_flat_coords(
    flat: jnp.ndarray,
    coords: jnp.ndarray,
    ids: jnp.ndarray,
) -> Grid:
    """Canonical (flat, id) sort from precomputed flat ids / bin coords.

    The domain-decomposed engine bins agents on the *global* lattice (exact
    integer coords) and then shifts the x-column by its stripe's static
    offset to index a small per-device local lattice — float re-binning
    against a shifted origin could disagree with the global binning by one
    ulp at bin edges, integer shifting cannot. Dead/out-of-range rows must
    already carry a sentinel flat id larger than every live probe."""
    capacity = flat.shape[0]
    _, _, order = jax.lax.sort(
        (flat, ids.astype(jnp.int32), jnp.arange(capacity, dtype=jnp.int32)),
        num_keys=2,
    )
    return Grid(order=order.astype(jnp.int32), sorted_flat=flat[order], coords=coords)


def window_from_grid(spec: GridSpec, grid: Grid):
    """Public candidate-window builder over an existing Grid: returns
    ``(pos, valid, max_run_count)`` of sorted positions (see
    ``sorted_window``)."""
    return _run_windows(spec, grid)


def _bin_table(spec: GridSpec, sorted_flat: jnp.ndarray) -> jnp.ndarray:
    """Bin-start table by histogram + exclusive cumsum: ``table[b]`` = number
    of live agents in bins < b = the sorted position where bin b starts. Two
    O(C) table gathers per run replace a binary search (``searchsorted``
    costs log2(C) rounds of gathers). The integer scatter-add is exact in
    any order."""
    counts_per_bin = jnp.zeros((spec.num_bins + 1,), dtype=jnp.int32).at[
        sorted_flat
    ].add(1, mode="drop")
    return jnp.cumsum(counts_per_bin) - counts_per_bin  # exclusive prefix sum


def _run_windows(spec: GridSpec, grid: Grid):
    """Shared stencil-run probe: per-agent sorted-position windows."""
    capacity = grid.order.shape[0]
    k = jnp.arange(spec.run_cap, dtype=jnp.int32)
    coords = grid.coords

    table = _bin_table(spec, grid.sorted_flat)

    starts = []
    counts = []
    for off in spec.run_offsets:
        if spec.two_d:
            lo = (coords[:, 0] + off[0]) * spec.ny + (coords[:, 1] - 1)
        else:
            lo = ((coords[:, 0] + off[0]) * spec.ny + (coords[:, 1] + off[1])) * spec.nz + (
                coords[:, 2] - 1
            )
        lo = jnp.clip(lo, 0, spec.num_bins - 3)  # garbage rows of dead agents
        start = table[lo]
        end = table[lo + 3]
        starts.append(start.astype(jnp.int32))
        counts.append((end - start).astype(jnp.int32))

    start = jnp.stack(starts, axis=1)  # (C, n_runs)
    count = jnp.stack(counts, axis=1)
    pos = start[:, :, None] + k[None, None, :]  # (C, n_runs, run_cap)
    valid = k[None, None, :] < count[:, :, None]

    W = len(spec.run_offsets) * spec.run_cap
    return (
        jnp.clip(pos, 0, capacity - 1).reshape(capacity, W),
        valid.reshape(capacity, W),
        jnp.max(count),
    )


def candidate_window(
    spec: GridSpec, grid: Grid
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gather the padded neighbor-candidate window for every agent slot.

    Returns ``(cand_idx, cand_valid, max_run_count)`` with shapes
    ((C, W), (C, W), ()): for each agent, the agent slots occupying the
    stencil bins (self included), a mask for the padded tails, and the
    on-device overflow probe. Dead agents never appear as candidates (their
    sentinel id is outside every query range); rows of dead agents contain
    garbage and must be masked by the consumer via the row's alive bit.
    """
    pos, valid, max_run = _run_windows(spec, grid)
    return grid.order[pos], valid, max_run


def sorted_window(
    spec: GridSpec,
    locations: jnp.ndarray,
    ids: jnp.ndarray,
    alive: jnp.ndarray,
) -> Tuple[Grid, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Candidate window expressed as *sorted positions* (gather-light).

    Returns ``(grid, pos, valid, max_run_count)`` where ``pos`` (C, W) indexes
    into sort-ordered arrays. Consumers gather a row-packed feature bundle
    once (``packed[grid.order]``) and then make a single (C, W) row gather
    instead of one per field (idx, locations, radii, alive).
    """
    grid = build_grid(spec, locations, ids, alive)
    pos, valid, max_run = _run_windows(spec, grid)
    return grid, pos, valid, max_run


def neighbor_mask(
    locations: jnp.ndarray,
    alive: jnp.ndarray,
    cand_idx: jnp.ndarray,
    cand_valid: jnp.ndarray,
    radius: float | jnp.ndarray,
) -> jnp.ndarray:
    """Mask of true neighbors within ``radius`` in the candidate window.

    Matches the reference predicate ``norm(loc_j - loc_i) <= distance``
    (``backend.py:143``) including the inclusive bound; excludes self-pairs
    (the reference's ``index < current`` dedup stores each undirected edge
    once — here each edge appears in both endpoints' rows, which is exactly
    igraph's adjacency view used by every consumer).
    """
    capacity = locations.shape[0]
    self_idx = jnp.arange(capacity, dtype=cand_idx.dtype)[:, None]
    delta = locations[cand_idx] - locations[:, None, :]
    dist2 = jnp.sum(delta * delta, axis=-1)
    r = jnp.asarray(radius, dtype=locations.dtype)
    mask = cand_valid & (cand_idx != self_idx) & (dist2 <= r * r)
    return mask & alive[:, None]


def num_neighbors(mask: jnp.ndarray) -> jnp.ndarray:
    """Per-agent neighbor count — ``Graph.num_neighbors`` (``backend.py:25-28``)."""
    return jnp.sum(mask, axis=1).astype(jnp.int32)


def neighbor_search(
    spec: GridSpec,
    locations: jnp.ndarray,
    alive: jnp.ndarray,
    radius: float | jnp.ndarray,
):
    """One-call equivalent of ``get_neighbors`` (``simulation.py:225-288``).

    Returns ``(cand_idx, mask, max_run_count)``: the padded window, the true
    neighbor mask, and the on-device occupancy probe the host uses to grow
    ``run_cap`` (the reference's adaptive doubling loops,
    ``simulation.py:217-221`` and ``:277-281``, moved off the hot path).
    """
    ids = jnp.arange(locations.shape[0], dtype=jnp.int32)  # host API: slot = id
    grid = build_grid(spec, locations, ids, alive)
    cand_idx, cand_valid, max_run = candidate_window(spec, grid)
    mask = neighbor_mask(locations, alive, cand_idx, cand_valid, radius)
    return cand_idx, mask, max_run


def brute_force_mask(
    locations: jnp.ndarray,
    alive: jnp.ndarray,
    radius: float,
) -> jnp.ndarray:
    """O(n^2) dense adjacency oracle for testing the grid engine."""
    delta = locations[:, None, :] - locations[None, :, :]
    dist2 = jnp.sum(delta * delta, axis=-1)
    n = locations.shape[0]
    eye = jnp.eye(n, dtype=bool)
    return (
        (dist2 <= radius * radius)
        & ~eye
        & alive[:, None]
        & alive[None, :]
    )
