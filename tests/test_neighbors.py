"""Neighbor engine vs. an O(n^2) brute-force oracle (SURVEY.md §4a)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hipsc_abm.ops import neighbors as nbr

search = functools.partial(jax.jit, static_argnums=(0, 3))(nbr.neighbor_search)


def dense_from_window(cand_idx, mask, capacity):
    """Convert the padded window representation to a dense adjacency matrix."""
    adj = np.zeros((capacity, capacity), dtype=bool)
    ci = np.asarray(cand_idx)
    m = np.asarray(mask)
    for i in range(capacity):
        adj[i, ci[i][m[i]]] = True
    return adj


@pytest.mark.parametrize("n,box,radius", [
    (50, (100.0, 100.0, 0.0), 15.0),
    (300, (200.0, 200.0, 0.0), 15.0),
    (200, (120.0, 90.0, 60.0), 10.0),  # 3D
    (64, (40.0, 40.0, 0.0), 25.0),  # dense: many per bin
])
def test_grid_matches_bruteforce(rng, n, box, radius):
    capacity = n + 16
    locs = np.zeros((capacity, 3), dtype=np.float32)
    locs[:n] = rng.random((n, 3)) * np.asarray(box)
    alive = np.zeros(capacity, dtype=bool)
    alive[:n] = True
    # garbage in dead slots must not affect results
    locs[n:] = rng.random((capacity - n, 3)) * np.asarray(box)

    # size the run capacity from the data like the host driver does (a run
    # spans 3 adjacent bins along the minor axis)
    coords = np.floor(locs[alive] / radius).astype(int)
    _, occupancy = np.unique(coords, axis=0, return_counts=True)
    spec = nbr.GridSpec.from_box(box, radius, run_cap=3 * int(occupancy.max()) + 2)
    cand_idx, mask, max_run = search(spec, jnp.asarray(locs), jnp.asarray(alive), radius)
    assert int(max_run) <= spec.run_cap  # no silent truncation in this test
    got = dense_from_window(cand_idx, mask, capacity)
    want = np.asarray(nbr.brute_force_mask(jnp.asarray(locs), jnp.asarray(alive), radius))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, got.T)  # undirected: symmetric adjacency


def test_window_excludes_dead_and_self(rng):
    n, capacity = 20, 32
    box = (50.0, 50.0, 0.0)
    locs = np.ones((capacity, 3), dtype=np.float32) * 25.0  # all stacked
    locs[:, 2] = 0.0
    alive = np.zeros(capacity, dtype=bool)
    alive[:n] = True
    spec = nbr.GridSpec.from_box(box, 10.0, run_cap=capacity)
    cand_idx, mask, _ = search(spec, jnp.asarray(locs), jnp.asarray(alive), 10.0)
    counts = np.asarray(nbr.num_neighbors(mask))
    assert (counts[:n] == n - 1).all()  # everyone neighbors everyone else
    assert (counts[n:] == 0).all()  # dead rows masked


def test_overflow_probe_reports_max_bin_occupancy(rng):
    n = 40
    box = (30.0, 30.0, 0.0)
    locs = np.full((n, 3), 5.0, dtype=np.float32)  # all in one bin
    locs[:, 2] = 0.0
    alive = np.ones(n, dtype=bool)
    spec = nbr.GridSpec.from_box(box, 10.0, run_cap=8)  # deliberately too small
    _, _, max_in_bin = search(spec, jnp.asarray(locs), jnp.asarray(alive), 10.0)
    assert int(max_in_bin) == n  # host would grow bin_cap and re-run


def test_inclusive_radius_boundary():
    # reference predicate is `<= distance` (backend.py:143)
    locs = np.array([[0.0, 0.0, 0.0], [15.0, 0.0, 0.0], [15.0001, 15.0, 0.0]], dtype=np.float32)
    alive = np.ones(3, dtype=bool)
    spec = nbr.GridSpec.from_box((40.0, 40.0, 0.0), 15.0, run_cap=8)
    _, mask, _ = search(spec, jnp.asarray(locs), jnp.asarray(alive), 15.0)
    counts = np.asarray(nbr.num_neighbors(mask))
    assert counts[0] >= 1  # the exactly-15 pair counts
    adj = dense_from_window(*_window(spec, locs, alive, 15.0), 3)
    assert adj[0, 1] and adj[1, 0]


def _window(spec, locs, alive, radius):
    cand_idx, mask, _ = search(spec, jnp.asarray(locs), jnp.asarray(alive), radius)
    return cand_idx, mask
