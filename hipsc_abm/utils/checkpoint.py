"""Checkpoint / resume with a stable, bit-exact format.

Replaces the reference's every-step pickle of the whole Simulation object
(``temp``, ``simulation.py:290-298``; restore at ``simulation.py:525-536``).
Two improvements the SURVEY calls out (§5.4):

- the checkpoint is the state PyTree (all slot arrays + the ``jax.random``
  key + counters) serialized to ``npz`` — format-stable, not coupled to the
  Python object layout;
- the RNG key is part of the state, so resume is bit-exact (the reference's
  global ``random``/``np.random`` streams are not captured by its pickle).
"""

from __future__ import annotations

import io
import json
import os
from typing import Tuple

import jax
import numpy as np

from hipsc_abm.engine import CellState
from hipsc_abm.ops.jkr import BondState

_FORMAT_VERSION = 2  # v2: + arrays/ids, next_id (stable agent identity)


def save_state(path: str, state: CellState, meta: dict | None = None) -> None:
    """Serialize a CellState (device -> host -> npz) atomically."""
    payload = {}
    host = jax.device_get(state)
    for name, arr in host.arrays.items():
        payload[f"arrays/{name}"] = np.asarray(arr)
    payload["alive"] = np.asarray(host.alive)
    payload["bonds/partners"] = np.asarray(host.bonds.partners)
    payload["bonds/mask"] = np.asarray(host.bonds.mask)
    for name, grid in host.gradients.items():
        payload[f"gradients/{name}"] = np.asarray(grid)
    payload["key"] = np.asarray(host.key)
    payload["step"] = np.asarray(host.step)
    payload["next_id"] = np.asarray(host.next_id)
    payload["meta"] = np.frombuffer(
        json.dumps({"format_version": _FORMAT_VERSION, **(meta or {})}).encode(),
        dtype=np.uint8,
    )

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)


def load_state(path: str) -> Tuple[CellState, dict]:
    """Restore a CellState and its metadata from an npz checkpoint."""
    with np.load(path) as data:
        arrays = {}
        gradients = {}
        for key in data.files:
            if key.startswith("arrays/"):
                arrays[key.split("/", 1)[1]] = data[key]
            elif key.startswith("gradients/"):
                gradients[key.split("/", 1)[1]] = data[key]
        meta = json.loads(bytes(data["meta"]).decode()) if "meta" in data.files else {}
        state = CellState(
            arrays={k: jax.numpy.asarray(v) for k, v in arrays.items()},
            alive=jax.numpy.asarray(data["alive"]),
            bonds=BondState(
                partners=jax.numpy.asarray(data["bonds/partners"]),
                mask=jax.numpy.asarray(data["bonds/mask"]),
            ),
            gradients={k: jax.numpy.asarray(v) for k, v in gradients.items()},
            key=jax.numpy.asarray(data["key"]),
            step=jax.numpy.asarray(data["step"]),
            next_id=jax.numpy.asarray(data["next_id"]),
        )
    return state, meta


# ---------------------------------------------------------------------------
# sharded (per-tile) checkpoints for the domain engine
# ---------------------------------------------------------------------------
#
# ``DomainHipscEngine.save_checkpoint`` flattens to one CellState npz — fine
# on one host, O(colony) gather per save on a pod. The sharded format writes
# one npz PER TILE from that tile's own slot block, fetched shard-by-shard
# via ``addressable_shards`` (no global gather is ever materialized, and on
# a multi-host pod each process can only fetch — and therefore only writes —
# its local tiles; the directory is assumed shared, as for any pod-scale
# checkpoint format). Resume reassembles and re-partitions, which is
# bit-exact because dynamics are layout-independent (the same property the
# flat round-trip relies on). Multi-host behavior is design-validated only:
# this environment has a single process.


def _tile_shards(arr, n_tiles: int) -> dict:
    """tile index -> host array for every tile this process can address,
    fetched per device shard (leading axis = tile axis, no global gather)."""
    shards = getattr(arr, "addressable_shards", None)
    if shards is None:  # plain numpy input (already on host)
        a = np.asarray(arr)
        return {s: a[s] for s in range(n_tiles)}
    out: dict = {}
    for sh in shards:
        idx = sh.index[0] if sh.index else slice(None)
        start = 0 if idx.start is None else int(idx.start)
        data = np.asarray(sh.data)
        for off in range(data.shape[0]):
            out.setdefault(start + off, data[off])
    return out


def save_domain_sharded(path: str, dstate, meta: dict | None = None) -> None:
    """Write a DomainState as ``path/`` with ``shard_{s}.npz`` per tile and
    ``manifest.json``. Replicated leaves (gradients, key, step, next_id) and
    the metadata ride ``shard_0`` as a sidecar (written by whichever process
    addresses tile 0); the manifest is written by process 0."""
    S = int(dstate.alive.shape[0])
    os.makedirs(path, exist_ok=True)
    leaves = {("arrays", k): _tile_shards(v, S) for k, v in dstate.arrays.items()}
    leaves[("alive",)] = _tile_shards(dstate.alive, S)
    leaves[("bonds", "partners")] = _tile_shards(dstate.bonds.partners, S)
    leaves[("bonds", "mask")] = _tile_shards(dstate.bonds.mask, S)
    local_tiles = sorted(leaves[("alive",)])
    for s in local_tiles:
        payload = {}
        for key, per_tile in leaves.items():
            name = "arrays/" + key[1] if key[0] == "arrays" else "/".join(key)
            payload[name] = per_tile[s]
        if s == 0:
            for name, grid in dstate.gradients.items():
                payload[f"gradients/{name}"] = np.asarray(jax.device_get(grid))
            payload["key"] = np.asarray(jax.device_get(dstate.key))
            payload["step"] = np.asarray(jax.device_get(dstate.step))
            payload["next_id"] = np.asarray(jax.device_get(dstate.next_id))
        tmp = os.path.join(path, f"shard_{s}.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, os.path.join(path, f"shard_{s}.npz"))
    if jax.process_count() > 1:
        # manifest presence must imply ALL shards are complete: without a
        # barrier, process 0 can publish the manifest while another
        # process's shard write is still in flight — a crash in that
        # window leaves a manifest pointing at a torn checkpoint
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("save_domain_sharded_shards")
    if jax.process_index() == 0:
        manifest = {
            "format_version": _FORMAT_VERSION,
            "n_shards": S,
            **(meta or {}),
        }
        tmp = os.path.join(path, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, "manifest.json"))
    if jax.process_count() > 1:
        # ... and "save returned" must imply "checkpoint loadable": without
        # this second barrier a non-coordinator can return (and e.g.
        # immediately reload, or report success right before process 0
        # crashes) while the manifest is still unpublished
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("save_domain_sharded_manifest")


def load_domain_sharded(path: str) -> Tuple[CellState, dict]:
    """Reassemble a sharded domain checkpoint into a flat CellState (the
    caller re-partitions via ``DomainHipscEngine.from_cell_state``) plus the
    manifest metadata."""
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    S = int(meta["n_shards"])
    arrays_parts: dict = {}
    alive_parts = []
    partners_parts = []
    mask_parts = []
    gradients = {}
    key = step = next_id = None
    for s in range(S):
        with np.load(os.path.join(path, f"shard_{s}.npz")) as data:
            for k in data.files:
                if k.startswith("arrays/"):
                    arrays_parts.setdefault(k.split("/", 1)[1], []).append(data[k])
                elif k.startswith("gradients/"):
                    gradients[k.split("/", 1)[1]] = data[k]
            alive_parts.append(data["alive"])
            partners_parts.append(data["bonds/partners"])
            mask_parts.append(data["bonds/mask"])
            if s == 0:
                key = data["key"]
                step = data["step"]
                next_id = data["next_id"]
    state = CellState(
        arrays={
            k: jax.numpy.asarray(np.concatenate(v, axis=0))
            for k, v in arrays_parts.items()
        },
        alive=jax.numpy.asarray(np.concatenate(alive_parts, axis=0)),
        bonds=BondState(
            partners=jax.numpy.asarray(np.concatenate(partners_parts, axis=0)),
            mask=jax.numpy.asarray(np.concatenate(mask_parts, axis=0)),
        ),
        gradients={k: jax.numpy.asarray(v) for k, v in gradients.items()},
        key=jax.numpy.asarray(key),
        step=jax.numpy.asarray(step),
        next_id=jax.numpy.asarray(next_id),
    )
    return state, meta
