"""Ensemble execution: R independent replicate colonies in ONE jitted step.

The reference runs exactly one colony per process (``run.py:6``); a
stochastic-replicate study — the standard way ABM results are reported —
means launching R sequential runs. Here ``engine.hipsc_step`` is a pure
function of the state PyTree, so R replicates stack along a leading axis
and run under ``jax.vmap`` as one compiled program: one dispatch, one
neighbor grid build per replicate fused into the same XLA module, and at
reference colony sizes (5k cells) far better accelerator-lane utilization
than any single colony can reach. (An accelerator claim specifically:
on the XLA CPU backend, which already multithreads one colony across all
cores, the batched step measures SLOWER than sequential replicates —
``tools/bench_ensemble.py``. The accelerator side is not yet measured.)

Replicates are embarrassingly parallel, which also makes this the
data-parallel axis for a device mesh: ``shard_states`` places the
replicate axis over the mesh and the jitted step partitions with ZERO
collectives (asserted in tests from the compiled HLO) — the
counterpart of launching the reference once per node, minus the N
processes, N Python runtimes, and N Numba JITs.

Two ensemble modes:

- **Replicates** (``init_states(seeds)``): identical parameters, different
  RNG streams. The estimator workflow (mean/CI over colonies).
- **Parameter sweeps** (``sweep=``): per-replicate values for the scalar
  parameters that the step consumes only arithmetically (whitelisted in
  ``SWEEPABLE``); the value becomes a traced per-replicate scalar, so ONE
  compile covers the whole sweep. Parameters that select Python control
  flow at trace time (``guye_move``, the enable_* flags) cannot be swept —
  vary them across separate ``EnsembleEngine`` instances instead.

Growth semantics: the capacity/cap probes of ``StepInfo`` are reduced with
``max`` over the replicate axis, and a single shared config grows for all
replicates (stacked states must stay uniform in shape). Re-execution from
the unmodified input state keeps results exact — and since dynamics are
layout- and capacity-independent (id-keyed RNG, see ``engine.CellState``),
every replicate remains bit-identical to the same seed run solo
(``tests/test_ensemble.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hipsc_abm.engine import (
    CellState,
    EngineConfig,
    HipscEngine,
    StepInfo,
    hipsc_step,
)

# Scalar parameters a sweep may vary per replicate: consumed by the traced
# step ONLY through arithmetic/comparison ops (never Python control flow),
# verified at the single consumption site of each —
#   xp.dox_step:        biology.cell_pathway  `current_step >= xp.dox_step`
#   xp.lonely_thresh:   biology.cell_death    `nbr_count < lonely_thresh`
#   bio.GATA6_prob:     biology.cell_stochastic_update  Bernoulli threshold
#   bio.NANOG_prob:     biology.cell_stochastic_update  Bernoulli threshold
# and the five continuous physics parameters (the same traced-dataclass
# treatment calibrate.py differentiates through; consumption sites in
# calibrate.DIFFERENTIABLE's comment) — this is the dose-response study
# surface: e.g. sweep adhesion_const across replicates in ONE compile.
# NOTE: static window sizing (bond-band support, engine.py:190-193) is
# derived from the BASE parameter values; sweep the force law around the
# base, not orders of magnitude past it, or re-base the engine.
# Each entry maps name -> which params object it lives on.
SWEEPABLE: Dict[str, str] = {
    "dox_step": "xp",
    "lonely_thresh": "xp",
    "GATA6_prob": "bio",
    "NANOG_prob": "bio",
    "adhesion_const": "bio",
    "poisson": "bio",
    "youngs": "bio",
    "stokes": "bio",
    "motility_force": "bio",
}


def _stack(states: Sequence[CellState]) -> CellState:
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


class EnsembleEngine:
    """Host-side driver for a stacked ensemble of replicate colonies.

    Wraps a :class:`HipscEngine` (whose config/params define every
    replicate) and mirrors its ``step`` / ``safe_step`` surface on stacked
    states with a leading replicate axis.
    """

    def __init__(self, engine: HipscEngine,
                 sweep: Optional[Dict[str, Sequence[float]]] = None):
        self.engine = engine
        self.sweep: Optional[Dict[str, jnp.ndarray]] = None
        self.n_replicates: Optional[int] = None
        if sweep:
            bad = sorted(set(sweep) - set(SWEEPABLE))
            if bad:
                raise ValueError(
                    f"not sweepable (trace-time parameters): {bad}; "
                    f"sweepable: {sorted(SWEEPABLE)}"
                )
            lens = {len(v) for v in sweep.values()}
            if len(lens) != 1:
                raise ValueError("sweep value lists must share one length")
            self.n_replicates = lens.pop()
            self.sweep = {
                k: jnp.asarray(np.asarray(v)) for k, v in sweep.items()
            }
        self._compiled = {}

    # -- construction --------------------------------------------------------

    def init_states(self, seeds: Sequence[int]) -> CellState:
        """Stacked initial colonies, one per seed (replicate axis first).

        With a sweep configured, ``len(seeds)`` must match the sweep length,
        and host-side initialization runs with each replicate's swept values
        substituted in. Today that substitution is pure future-proofing: no
        current ``SWEEPABLE`` entry is consumed by ``init_state`` (it seeds
        counters from the *division/death thresholds*, which are not
        sweepable) — but if ``SWEEPABLE`` ever gains such a field, per-
        replicate initialization is already correct.
        """
        if self.n_replicates is not None and len(seeds) != self.n_replicates:
            raise ValueError(
                f"{len(seeds)} seeds for a {self.n_replicates}-point sweep"
            )
        eng = self.engine
        states, run_caps = [], []
        base_xp, base_bio = eng.xp, eng.bio
        try:
            for i, seed in enumerate(seeds):
                if self.sweep:
                    over = {k: np.asarray(v)[i].item()
                            for k, v in self.sweep.items()}
                    eng.xp = _replace_fields(base_xp, over, "xp")
                    eng.bio = _replace_fields(base_bio, over, "bio")
                states.append(eng.init_state(seed=seed))
                run_caps.append(
                    (eng.cfg.nbr_spec.run_cap, eng.cfg.jkr_spec.run_cap)
                )
        finally:
            eng.xp, eng.bio = base_xp, base_bio
        # one shared config: window caps sized for the densest replicate
        nbr_cap = max(c for c, _ in run_caps)
        jkr_cap = max(c for _, c in run_caps)
        eng.cfg = dataclasses.replace(
            eng.cfg,
            nbr_spec=dataclasses.replace(eng.cfg.nbr_spec, run_cap=nbr_cap),
            jkr_spec=dataclasses.replace(eng.cfg.jkr_spec, run_cap=jkr_cap),
        )
        return _stack(states)

    @staticmethod
    def replicate(states: CellState, i: int) -> CellState:
        """Unstacked view of replicate ``i`` — feed to the existing output /
        checkpoint surfaces unchanged."""
        return jax.tree_util.tree_map(lambda x: x[i], states)

    @staticmethod
    def shard_states(states: CellState, mesh: jax.sharding.Mesh,
                     axis: str = "r") -> CellState:
        """Place the replicate axis over a device mesh (replicate-DP).

        The jitted step then partitions along it with no collectives — each
        device steps its replicates independently (SPMD without collectives).
        """
        spec = jax.sharding.PartitionSpec(axis)
        return jax.device_put(
            states, jax.sharding.NamedSharding(mesh, spec)
        )

    # -- stepping -------------------------------------------------------------

    def _step_fn(self, cfg: EngineConfig):
        eng = self.engine
        key = (cfg, eng.gen, eng.xp, eng.bio, eng.diff)
        if key not in self._compiled:
            if self.sweep is None:
                base = functools.partial(
                    hipsc_step, cfg=cfg, gen=eng.gen, xp=eng.xp,
                    bio=eng.bio, diff=eng.diff,
                )
                fn = jax.vmap(base)
            else:
                def swept(state, sweep_vals):
                    xp = _replace_fields(eng.xp, sweep_vals, "xp")
                    bio = _replace_fields(eng.bio, sweep_vals, "bio")
                    return hipsc_step(state, cfg=cfg, gen=eng.gen, xp=xp,
                                      bio=bio, diff=eng.diff)

                inner = jax.jit(jax.vmap(swept, in_axes=(0, 0)))
                sweep = self.sweep
                self._compiled[key] = lambda s: inner(s, sweep)
                return self._compiled[key]
            self._compiled[key] = jax.jit(fn)
        return self._compiled[key]

    def _cfg_for_states(self, states: CellState) -> EngineConfig:
        cfg = self.engine.cfg
        capacity = states.alive.shape[1]
        bond_cap = states.bonds.partners.shape[2]
        if cfg.capacity != capacity or cfg.bond_cap != bond_cap:
            cfg = dataclasses.replace(cfg, capacity=capacity, bond_cap=bond_cap)
        return cfg

    def step(self, states: CellState) -> Tuple[CellState, StepInfo]:
        """Raw vmapped step (no overflow handling) — for benchmarking.
        ``StepInfo`` fields have shape (R,)."""
        return self._step_fn(self._cfg_for_states(states))(states)

    def safe_step(self, states: CellState) -> Tuple[CellState, StepInfo]:
        """Step all replicates with exact capacity-overflow recovery.

        Mirrors :meth:`HipscEngine.safe_step`: probes reduce with ``max``
        over the replicate axis, the shared config grows once for all
        replicates, and the step re-executes from its unmodified input —
        no replicate is ever silently truncated.
        """
        eng = self.engine
        for _ in range(16):
            cfg = self._cfg_for_states(states)
            new_states, infos = self._step_fn(cfg)(states)
            infos = StepInfo(*jax.device_get(tuple(infos)))
            info_max = StepInfo(*(np.max(np.asarray(f), axis=0)
                                  for f in infos))
            if int(info_max.max_id) >= (1 << 24) - 1:
                raise RuntimeError(
                    "agent id space exhausted (2^24 agents ever created); "
                    "id recycling is not implemented"
                )
            grown_cfg = eng._grown_cfg(cfg, info_max)
            if grown_cfg is None:
                return new_states, infos
            eng.cfg = grown_cfg
            states = self.repad_states(states, grown_cfg)
        raise RuntimeError("capacity growth failed to converge")

    @staticmethod
    def repad_states(states: CellState, cfg: EngineConfig) -> CellState:
        """Re-pad every replicate to a (larger) capacity / bond capacity."""
        return jax.vmap(
            functools.partial(HipscEngine.repad_state, cfg=cfg)
        )(states)


def _replace_fields(params, values: Dict[str, object], owner: str):
    """Copy ``params`` with the swept fields that live on ``owner`` replaced.

    Used at trace time with tracer values: every sweepable field is consumed
    only arithmetically downstream (see ``SWEEPABLE``), so a frozen dataclass
    carrying tracers in those slots traces correctly. The dataclass is never
    used as a jit static argument on this path (it is closed over, not
    passed), so tracer fields never reach a hash."""
    mine = {k: v for k, v in values.items() if SWEEPABLE.get(k) == owner}
    return dataclasses.replace(params, **mine) if mine else params
