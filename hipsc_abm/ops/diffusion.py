"""FTCS morphogen diffusion on a 2D lattice, with cell coupling.

Replaces ``update_diffusion`` / ``update_diffusion_jit`` (reference
``cell_methods.py:441-468``, ``cell_backend.py:175-204``) and the gradient
sample/deposit helpers (``cell_methods.py:470-521``). The reference keeps the
feature disabled behind comments (``cell_simulation.py:60-75``); here it is a
first-class, config-enabled subsystem.

Reference semantics reproduced: clamp to [0, max_concentration], zero-padded
ghost ring, reflecting (Neumann) boundary copy applied edge-by-edge in order
(so corners take already-reflected values), subcycled 5-point Laplacian with a
short final substep when ``step_dt`` does not divide evenly, then uniform
degradation. The Python-side subcycle loop becomes a ``lax.scan`` over a
static dt schedule.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def diffusion_dts(step_dt: float, diffuse_dt: float) -> np.ndarray:
    """Static subcycle schedule: divmod(step_dt, diffuse_dt) full steps plus
    one remainder step (reference ``cell_methods.py:447-448`` — the extra step
    runs even when the remainder is zero)."""
    steps, last_dt = divmod(step_dt, diffuse_dt)
    return np.array([diffuse_dt] * int(steps) + [last_dt], dtype=np.float32)


def ftcs_subcycle(base: jnp.ndarray, a, b) -> jnp.ndarray:
    """One FTCS subcycle on the padded lattice: sequential edge reflection
    (the reference order, ``cell_backend.py:192-195`` — corners take
    already-reflected values), then the 5-point stencil with coefficients
    ``a = dt*D/h^2``, ``b = 1-4a``. Every update rebuilds the lattice with
    ``jnp.concatenate`` of static slices: exact data movement, no scatter."""
    base = jnp.concatenate([base[:, 1:2], base[:, 1:-1], base[:, -2:-1]], axis=1)
    base = jnp.concatenate([base[1:2, :], base[1:-1, :], base[-2:-1, :]], axis=0)
    interior = base[1:-1, 1:-1]
    temp = a * (base[2:, 1:-1] + base[:-2, 1:-1] + base[1:-1, 2:] + base[1:-1, :-2])
    new = b * interior + temp
    mid = jnp.concatenate([base[1:-1, :1], new, base[1:-1, -1:]], axis=1)
    return jnp.concatenate([base[:1, :], mid, base[-1:, :]], axis=0)


def ftcs_diffuse(
    gradient: jnp.ndarray,  # (nx, ny)
    dts: jnp.ndarray,  # (S,) subcycle dt schedule
    diffuse_const: float,
    spat_res2: float,
    max_concentration: float,
    degradation: float,
) -> jnp.ndarray:
    """One simulation step of subcycled FTCS diffusion + degradation."""
    gradient = jnp.clip(gradient, 0.0, max_concentration)
    base = jnp.pad(gradient, 1)

    def subcycle(base, dt):
        a = dt * diffuse_const / spat_res2
        return ftcs_subcycle(base, a, 1.0 - 4.0 * a), None

    base, _ = jax.lax.scan(subcycle, base, dts)
    return base[1:-1, 1:-1] * (1.0 - degradation)


def sample_concentration(
    gradient: jnp.ndarray,  # (nx, ny)
    locations: jnp.ndarray,  # (C, 3) um
    spat_res: float,
) -> jnp.ndarray:
    """Nearest-gridpoint concentration per agent (``get_concentration``,
    reference ``cell_methods.py:470-483``): idx = ceil(floor(2 x / h) / 2)."""
    half = jnp.floor(2.0 * locations[:, :2] / spat_res).astype(jnp.int32)
    idx = -((-half) // 2)  # integer ceil(half / 2)
    nx, ny = gradient.shape
    x = jnp.clip(idx[:, 0], 0, nx - 1)
    y = jnp.clip(idx[:, 1], 0, ny - 1)
    return gradient[x, y]


def deposit_morphogen(
    gradient: jnp.ndarray,  # (nx, ny)
    locations: jnp.ndarray,  # (C, 3) um
    amounts: jnp.ndarray,  # (C,) amount per agent (0 for inactive/dead)
    spat_res: float,
) -> jnp.ndarray:
    """Vectorized 4-point deposit (``adjust_morphogens``, reference
    ``cell_methods.py:485-521``): each agent splits its amount equally across
    the surrounding lattice points that lie within ``spat_res`` of it."""
    nx, ny = gradient.shape
    base = jnp.floor(locations[:, :2] / spat_res).astype(jnp.int32)  # (C, 2)

    corner_offsets = jnp.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=jnp.int32)
    points = base[:, None, :] + corner_offsets[None, :, :]  # (C, 4, 2)
    in_bounds = (points[..., 0] < nx) & (points[..., 1] < ny) & (points >= 0).all(-1)

    point_loc = points.astype(locations.dtype) * spat_res  # (C, 4, 2)
    delta = locations[:, None, :2] - point_loc
    dist = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
    nearby = in_bounds & (dist < spat_res)  # (C, 4)

    total_nearby = jnp.sum(nearby, axis=1)  # (C,)
    share = jnp.where(total_nearby > 0, amounts / jnp.maximum(total_nearby, 1), 0.0)
    contrib = jnp.where(nearby, share[:, None], 0.0)  # (C, 4)

    flat_idx = points[..., 0] * ny + points[..., 1]
    flat_idx = jnp.where(nearby, flat_idx, nx * ny)  # OOB sentinel -> dropped
    deposit = segment_sum_sorted(
        flat_idx.reshape(-1), contrib.reshape(-1), nx * ny)
    return gradient + deposit.reshape(nx, ny)


def segment_sum_sorted(keys: jnp.ndarray, vals: jnp.ndarray, n: int) -> jnp.ndarray:
    """Deterministic ``zeros(n).at[keys].add(vals)`` (keys outside [0, n)
    dropped). A float scatter-add runs as atomics on the GPU, whose order,
    and so whose rounding, varies from run to run. Here the (key, value)
    pairs are sorted, so each key's values are summed in an order fixed by
    the multiset alone (a segmented ``associative_scan``), and each sum is
    written once: bitwise invariant under any permutation of the inputs."""
    keys, vals = jax.lax.sort((keys, vals), num_keys=2)
    new_seg = jnp.concatenate([jnp.ones((1,), bool), keys[1:] != keys[:-1]])

    def seg_add(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va + vb)

    _, sums = jax.lax.associative_scan(seg_add, (new_seg, vals))
    seg_end = jnp.concatenate([keys[1:] != keys[:-1], jnp.ones((1,), bool)])
    out_idx = jnp.where(seg_end, keys, n)  # one write per key, rest dropped
    return jnp.zeros((n,), vals.dtype).at[out_idx].set(sums, mode="drop")
