"""Agent-sharded fused step (GSPMD) — a correctness cross-check, NOT the
deployment path. **Use ``parallel.domain_engine.DomainHipscEngine`` for
multi-chip runs.**

This module shards the slot axis of every per-agent array over a 1-D
``jax.sharding.Mesh`` and lets XLA/GSPMD insert the collectives. Its value is
that it matches the single-device engine *exactly* with zero decomposition
code — a strong independent check on the domain engine — but its collectives
are O(colony) per window rebuild (the grid's global argsort and window
gathers all-gather across chips). That cost is structural to agent
sharding, which is why the spatial domain engine — O(boundary) collectives
— is the scalable route.

Multi-chip correctness is validated on a virtual 8-device CPU mesh
(``jax.config jax_num_cpu_devices``) — the standard way to test multi-device
code without the devices.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hipsc_abm.engine import CellState, HipscEngine, hipsc_step


AGENT_AXIS = "agents"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the agent-slot axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AGENT_AXIS,))


def state_shardings(state: CellState, mesh: Mesh) -> CellState:
    """PyTree of NamedShardings: agent-slot arrays sharded on axis 0,
    gradients / RNG key / step counter replicated."""
    sharded = NamedSharding(mesh, P(AGENT_AXIS))  # axis 0; rest replicated
    replicated = NamedSharding(mesh, P())

    return CellState(
        arrays={k: sharded for k in state.arrays},
        alive=sharded,
        bonds=type(state.bonds)(partners=sharded, mask=sharded),
        gradients={k: replicated for k in state.gradients},
        key=replicated,
        step=replicated,
        next_id=replicated,
    )


def shard_state(state: CellState, mesh: Mesh) -> CellState:
    """Place a state PyTree on the mesh with agent-slot sharding."""
    shardings = state_shardings(state, mesh)
    return jax.tree_util.tree_map(jax.device_put, state, shardings)


class ShardedHipscEngine(HipscEngine):
    """HipscEngine whose fused step runs sharded over a device mesh.

    **Correctness cross-check only** — O(colony) communication per window
    rebuild (see module docstring). Deploy multi-chip
    runs on ``parallel.domain_engine.DomainHipscEngine``.

    Capacity management (``safe_step`` growth) is inherited unchanged —
    re-padding preserves shardings via the jit output shardings.
    """

    def __init__(self, *args, mesh: Optional[Mesh] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh or make_mesh()
        # keep capacity divisible by the mesh for even sharding
        n = self.mesh.devices.size
        if self.cfg.capacity % n:
            import dataclasses

            cap = ((self.cfg.capacity + n - 1) // n) * n
            self.cfg = dataclasses.replace(self.cfg, capacity=cap)

    def _step_fn(self, cfg):
        key = (cfg, self.gen, self.xp, self.bio, self.diff, self.mesh)
        if key not in self._compiled:
            def run(state):
                return hipsc_step(
                    state, cfg=cfg, gen=self.gen, xp=self.xp, bio=self.bio,
                    diff=self.diff,
                )

            def compile_for(state):
                shardings = state_shardings(state, self.mesh)
                from hipsc_abm.engine import StepInfo

                info_shardings = StepInfo(*([NamedSharding(self.mesh, P())] * len(StepInfo._fields)))
                return jax.jit(
                    run,
                    in_shardings=(shardings,),
                    out_shardings=(shardings, info_shardings),
                )

            self._compiled[key] = _LazyShardedFn(compile_for)
        return self._compiled[key]

    def init_state(self, seed: int = 0, locations=None) -> CellState:
        state = super().init_state(seed=seed, locations=locations)
        return shard_state(state, self.mesh)


class _LazyShardedFn:
    """jit wrapper that builds shardings from the first state it sees."""

    def __init__(self, compile_for):
        self._compile_for = compile_for
        self._fn = None

    def __call__(self, state):
        if self._fn is None:
            self._fn = self._compile_for(state)
        return self._fn(state)
