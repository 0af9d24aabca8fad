"""Simulation-based calibration: fit model parameters to observed statistics.

The reference framework has no calibration story at all — fitting its
biophysical constants (`cell_simulation.py:34-57`) to data means hand-tuning
across whole re-runs. Because this engine's step (``engine.hipsc_step``) is a
pure JAX function of the state PyTree, two strategies come almost
for free, and both are exposed here behind one small API:

1. **Gradient calibration** (:meth:`Calibrator.fit`): ``jax.grad`` straight
   through a multi-step simulation rollout. The contact mechanics, Stokes
   integration, motility forces, and morphogen diffusion are continuous in
   the :data:`DIFFERENTIABLE` parameters, so reverse-mode AD yields exact
   sensitivities of any colony statistic (the discrete fate/division events
   contribute zero — they act as a fixed control sequence around the
   differentiable physics). The NaN-safety rewrites this relies on live in
   ``ops/jkr.py`` / ``ops/integrate.py`` / ``models/biology.py`` (guarded
   sqrt/pow/div in masked branches — primal bit-identical). Rollouts are
   rematerialized per step (``jax.checkpoint``) so reverse-mode memory stays
   O(state), not O(horizon * state).

2. **Evolution-strategy calibration** (:meth:`Calibrator.fit_es`): for
   parameters whose effect is *purely* through discrete events (e.g. the
   Bernoulli fate probabilities, whose pathwise gradient is zero a.e.).
   Antithetic OpenAI-style ES with rank shaping; the whole population rolls
   out as ONE ``jax.vmap``-compiled program, and every candidate shares the
   id-keyed RNG stream (common random numbers), which cancels most sampling
   variance out of the fitness differences.

Both optimize in an unconstrained transform space (log for positive
parameters, logit for probabilities) and share growth-safe evaluation: the
capacity/cap overflow probes of every rollout are max-reduced and fed to the
engine's growth policy, exactly like ``HipscEngine.safe_step``.

Parameters enter the rollout as *traced* leaves of a rebuilt
``BiologyParams`` (the same frozen-dataclass-with-tracers pattern as
``parallel/ensemble.py`` sweeps), so one compile serves the entire fit; the
static window configuration stays derived from the concrete base parameters.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable, Dict, List, Sequence, Tuple

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

# BiologyParams floats consumed by the traced step ONLY through arithmetic,
# with a non-zero pathwise derivative (they scale/shape the continuous
# physics). Verified at the consumption sites:
#   adhesion_const, poisson, youngs : ops/jkr.py _pair_jkr (force law)
#   stokes                          : ops/integrate.py stokes_integrate
#   motility_force                  : models/biology.py cell_motility
DIFFERENTIABLE = frozenset(
    {"adhesion_const", "poisson", "youngs", "stokes", "motility_force"}
)

# Additionally searchable by ES: consumed arithmetically (traceable) but
# through a.e.-flat discrete events, so pathwise gradients are zero while
# finite parameter moves DO change the outcome.
#   GATA6_prob, NANOG_prob : biology.cell_stochastic_update Bernoulli gates
#   (a config-disabled reference method — requires enable_stochastic=True,
#   enforced in Calibrator.__init__)
SEARCHABLE = DIFFERENTIABLE | frozenset({"GATA6_prob", "NANOG_prob"})

# names that only have an effect behind an EngineConfig feature gate
_REQUIRES_FLAG = {"GATA6_prob": "enable_stochastic",
                  "NANOG_prob": "enable_stochastic"}

# unconstrained-space transform per parameter: positive -> log, (0,1) -> logit
_LOGIT = frozenset({"poisson", "GATA6_prob", "NANOG_prob"})


def _to_unconstrained(name: str, x: float) -> float:
    if name in _LOGIT:
        return math.log(x / (1.0 - x))
    return math.log(x)


def _from_unconstrained(name: str, t):
    if name in _LOGIT:
        return jax.nn.sigmoid(t)
    return jnp.exp(t)


# ---------------------------------------------------------------------------
# built-in colony statistics (loss building blocks)
# ---------------------------------------------------------------------------


def radius_of_gyration(state: CellState) -> jnp.ndarray:
    """RMS distance of alive cells from the colony's center of mass (um) —
    the standard compaction statistic for adhesion/motility calibration."""
    locs = state.arrays["locations"]
    alive = state.alive
    n = jnp.maximum(jnp.sum(alive), 1)
    com = jnp.sum(jnp.where(alive[:, None], locs, 0.0), axis=0) / n
    r2 = jnp.sum(jnp.where(alive, jnp.sum((locs - com) ** 2, axis=-1), 0.0)) / n
    return jnp.sqrt(r2)


def soft_contact_count(r_contact: float = 10.0, width: float = 1.0):
    """Statistic factory: differentiable mean contact coordination — for
    each alive cell, the sigmoid-smoothed number of alive neighbors within
    ``r_contact`` um (``sum_j sigmoid((r_contact - d_ij) / width)``),
    averaged over the colony.

    The second observable that breaks the (adhesion, motility)
    compensating ridge (docs/CALIBRATION.md): compaction (Rg) measures
    colony EXTENT, which both force scales move along the measured ridge;
    coordination measures local PACKING, which adhesion increases by
    pulling pairs into overlap while motility mostly rearranges singles.
    The smooth gate keeps the pathwise gradient alive (a hard count's
    derivative is zero a.e.); compute the TARGET from observed positions
    with the same ``r_contact``/``width`` so the comparison is unbiased.
    O(C^2) pairwise — the right trade at calibration-sized colonies.

    Squared distances come from the Gram identity
    ``d2[i,j] = |x_i|^2 + |x_j|^2 - 2 <x_i, x_j>`` (one (C, 3) x (3, C)
    matmul) rather than broadcasting a (C, C, 3) difference tensor, whose
    saved residual under a vmapped-replicate reverse-mode rollout is the
    dominant memory cost. The identity cancels terms of size |x|^2, so its
    f32 error scales with the distance from the origin: positions are
    centered on the colony first, and the matmul is pinned to full f32
    precision (an f32 matmul may otherwise run in TF32 on the GPU)."""

    def stat(state: CellState) -> jnp.ndarray:
        alive = state.alive
        n_alive = jnp.maximum(jnp.sum(alive), 1)
        locs = state.arrays["locations"]
        com = jnp.sum(jnp.where(alive[:, None], locs, 0.0), axis=0) / n_alive
        locs = locs - com
        sq = jnp.sum(locs * locs, axis=-1)
        gram = jnp.matmul(locs, locs.T, precision=jax.lax.Precision.HIGHEST)
        d2 = sq[:, None] + sq[None, :] - 2.0 * gram
        # guarded: exact-zero only on the masked diagonal; clamp the tiny
        # negative residue the Gram form can leave on near-coincident pairs
        d = jnp.sqrt(jnp.maximum(d2, 0.0) + 1e-12)
        gate = jax.nn.sigmoid((r_contact - d) / width)
        pair = alive[:, None] & alive[None, :]
        pair &= ~jnp.eye(alive.shape[0], dtype=bool)
        per_cell = jnp.sum(jnp.where(pair, gate, 0.0), axis=1)
        return jnp.sum(jnp.where(alive, per_cell, 0.0)) / n_alive

    return stat


def gata6_high_fraction(state: CellState) -> jnp.ndarray:
    """Fraction of alive cells with GATA6 > NANOG — the fate statistic the
    FDS probabilities control."""
    high = state.alive & (state.arrays["GATA6"] > state.arrays["NANOG"])
    return jnp.sum(high) / jnp.maximum(jnp.sum(state.alive), 1)


def squared_error(statistic: Callable[[CellState], jnp.ndarray],
                  target: float) -> Callable[[CellState], jnp.ndarray]:
    """Loss factory: ``(statistic(final_state) - target)**2``."""

    def loss(state: CellState) -> jnp.ndarray:
        return (statistic(state) - jnp.asarray(target)) ** 2

    return loss


@dataclasses.dataclass(frozen=True)
class TrajectoryLoss:
    """Loss over the whole rollout instead of the final state — the shape of
    real calibration data (a time COURSE of measurements, one per step).

    ``statistic`` maps each post-step state to an array of measurements;
    ``loss`` maps the stacked ``(horizon, ...)`` statistics to a scalar.
    The per-step states are never materialized on the host — only the
    statistics ride the scan carry."""

    statistic: Callable[[CellState], jnp.ndarray]
    loss: Callable[[jnp.ndarray], jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class EnsembleTrajectoryLoss(TrajectoryLoss):
    """Trajectory loss on the REPLICATE-MEAN statistic time course.

    The trajectory analog of :class:`EnsembleLoss`: with a stacked state,
    a plain :class:`TrajectoryLoss` averages per-replicate losses, which
    bottoms out at each replicate's OWN seed noise against the target —
    but an observed target that is itself a multi-run average (the
    calibration showcase's 5-run mean course) should be matched by the
    simulated replicate-MEAN course, whose noise shrinks by sqrt(R) and
    whose loss is exactly zero at a perfect fit. Wrap any trajectory loss
    with :func:`ensemble_trajectory`."""


def ensemble_trajectory(loss: TrajectoryLoss) -> EnsembleTrajectoryLoss:
    """Method-of-moments wrapper: apply ``loss`` to the replicate-mean
    statistic trajectory instead of averaging per-replicate losses."""
    return EnsembleTrajectoryLoss(statistic=loss.statistic, loss=loss.loss)


def trajectory_squared_error(statistic: Callable[[CellState], jnp.ndarray],
                             targets) -> TrajectoryLoss:
    """Mean squared error of a per-step statistic against an observed time
    course (``targets`` has shape ``(horizon,) + statistic shape``)."""
    targets = jnp.asarray(targets)

    def loss(stats: jnp.ndarray) -> jnp.ndarray:
        return jnp.mean((stats - targets) ** 2)

    return TrajectoryLoss(statistic, loss)


def delta_trajectory_squared_error(
        statistic: Callable[[CellState], jnp.ndarray],
        targets) -> TrajectoryLoss:
    """Mean squared error of the per-step CHANGE of a statistic against the
    observed time course's change (both anchored at their first entry).

    The right loss when the statistic has a nuisance offset the dynamics do
    not control — e.g. fitting compaction rate to a reference-generated
    colony: each replicate's initial radius of gyration varies by ~Rg/sqrt(2N)
    from random placement (and the observed colony's by the same), which can
    dwarf the per-step compaction signal. Differencing cancels the offset
    exactly, per replicate and in the target."""
    targets = jnp.asarray(targets)

    def loss(stats: jnp.ndarray) -> jnp.ndarray:
        return jnp.mean(((stats - stats[0]) - (targets - targets[0])) ** 2)

    return TrajectoryLoss(statistic, loss)


def multi_delta_trajectory_squared_error(observations, weights=None):
    """Joint delta-trajectory loss over SEVERAL statistics — the
    multi-observable objective that makes force scales jointly
    identifiable where one statistic has a compensating ridge
    (docs/CALIBRATION.md: (adhesion, motility) vs compaction alone).

    ``observations`` is a sequence of ``(statistic_fn, targets)`` pairs,
    each ``targets`` a (horizon,) observed time course. Each statistic
    contributes the MSE of its per-step CHANGE (anchored at the first
    entry, same nuisance-offset cancellation as
    :func:`delta_trajectory_squared_error`), normalized by the mean
    squared delta of its OWN target — a unit-free relative error, so a
    um-scale compaction course and a count-scale coordination course
    weigh equally. Pass explicit ``weights`` to override."""
    fns = [fn for fn, _ in observations]
    targets = jnp.stack(
        [jnp.asarray(t, jnp.float32) for _, t in observations], axis=1
    )  # (horizon, n_stats)
    tdelta = targets - targets[0]
    if weights is None:
        w = 1.0 / (jnp.mean(tdelta ** 2, axis=0) + 1e-12)
    else:
        w = jnp.asarray(weights, jnp.float32)

    def statistic(state: CellState) -> jnp.ndarray:
        return jnp.stack([fn(state) for fn in fns])  # (n_stats,)

    def loss(stats: jnp.ndarray) -> jnp.ndarray:  # (horizon, n_stats)
        d = (stats - stats[0]) - tdelta
        return jnp.sum(w * jnp.mean(d ** 2, axis=0))

    return TrajectoryLoss(statistic, loss)


@dataclasses.dataclass(frozen=True)
class EnsembleLoss:
    """Loss on the replicate-AVERAGED statistic (method of moments).

    With a stacked-replicate state, a plain ``loss_fn`` is applied per
    replicate and the losses are averaged — correct when each replicate has
    its own target, but against one scalar observation it bottoms out at
    the across-replicate variance of the statistic, drowning the parameter
    signal. ``EnsembleLoss`` instead averages ``statistic`` over the
    replicates first and applies ``loss`` to the mean, which is exactly
    zero at a perfect fit. On a flat (single-colony) state it degenerates
    to ``loss(statistic(final))``."""

    statistic: Callable[[CellState], jnp.ndarray]
    loss: Callable[[jnp.ndarray], jnp.ndarray]


def ensemble_squared_error(statistic: Callable[[CellState], jnp.ndarray],
                           target) -> EnsembleLoss:
    """``(mean over replicates of statistic(final) - target)**2``."""
    target = jnp.asarray(target)

    def loss(mean_stat: jnp.ndarray) -> jnp.ndarray:
        return jnp.sum((mean_stat - target) ** 2)

    return EnsembleLoss(statistic, loss)


@dataclasses.dataclass
class FitResult:
    """Outcome of a calibration run."""

    params: Dict[str, float]  # BEST-evaluated parameter values (model space)
    theta: np.ndarray  # best values in the unconstrained space (optimizers
    # overshoot; the lowest-loss iterate seen is the fit, not the last one)
    loss_history: List[float]  # loss at each iterate (gradient: per step;
    # ES: population mean per generation, plus one final entry — the
    # unperturbed loss of the returned parameters)
    n_evaluations: int  # rollouts executed (ES counts the population)

    @property
    def best_loss(self) -> float:
        return min(self.loss_history)


class Calibrator:
    """Fits selected ``BiologyParams`` fields of ``engine`` so that
    ``loss_fn(final_state)`` of a ``horizon``-step rollout is minimized.

    ``loss_fn`` maps the rollout's final :class:`CellState` to a scalar —
    compose one from the built-in statistics (:func:`radius_of_gyration`,
    :func:`gata6_high_fraction`, :func:`squared_error`) or write any JAX
    function of the state — or is a :class:`TrajectoryLoss` fitting a
    per-step time course (:func:`trajectory_squared_error`). The engine's
    current parameter values are the initial iterate. The wrapped engine's
    config is shared and may grow (capacity probes) during fitting, exactly
    like ``safe_step``.

    ``state`` may also be a STACKED ensemble of replicates
    (``EnsembleEngine.init_states``): the vmapped rollouts compile as one
    program and the fit minimizes the replicate-averaged objective — the
    mean of per-replicate losses for a plain ``loss_fn``, or, with an
    :class:`EnsembleLoss` (:func:`ensemble_squared_error`), the loss on
    the replicate-MEAN statistic, which removes the across-replicate
    variance floor a scalar target otherwise hits.
    """

    def __init__(self, engine: HipscEngine, param_names: Sequence[str],
                 loss_fn: Callable[[CellState], jnp.ndarray],
                 horizon: int = 4, remat: bool = True,
                 dense_pairs: Optional[bool] = None):
        bad = sorted(set(param_names) - SEARCHABLE)
        if bad:
            raise ValueError(
                f"not calibratable (static/trace-time parameters): {bad}; "
                f"searchable: {sorted(SEARCHABLE)}"
            )
        gated = sorted(
            n for n in param_names
            if n in _REQUIRES_FLAG
            and not getattr(engine.cfg, _REQUIRES_FLAG[n])
        )
        if gated:
            raise ValueError(
                f"{gated} only affect the simulation with "
                f"{sorted({_REQUIRES_FLAG[n] for n in gated})} set on the "
                "engine — the fit would see a constant loss"
            )
        if dense_pairs is None:
            # a vmapped population rollout runs 110 sequential substeps of
            # window sorts and gathers per member; all-pairs physics
            # removes every gather and won below a few thousand slots on
            # the accelerator this cut-over was first measured on
            # (engine._physics_scan_dense) — auto-select it there.
            dense_pairs = engine.cfg.capacity <= 4096
        if dense_pairs != engine.cfg.dense_pairs:
            engine.cfg = dataclasses.replace(
                engine.cfg, dense_pairs=bool(dense_pairs))
        self.engine = engine
        self.names: Tuple[str, ...] = tuple(param_names)
        self.loss_fn = loss_fn
        if int(horizon) < 1:
            raise ValueError("horizon must be >= 1")
        self.horizon = int(horizon)
        self.remat = bool(remat)
        self._compiled: dict = {}
        self._ens = None  # lazy EnsembleEngine for stacked-replicate fits

    # -- parameter-space plumbing -------------------------------------------

    def theta0(self) -> jnp.ndarray:
        """The engine's current parameter values in unconstrained space."""
        return jnp.asarray(
            [_to_unconstrained(n, getattr(self.engine.bio, n))
             for n in self.names],
            dtype=jnp.float32,
        )

    def params(self, theta) -> Dict[str, float]:
        """Unconstrained iterate -> model-space parameter dict."""
        return {
            n: float(_from_unconstrained(n, theta[i]))
            for i, n in enumerate(self.names)
        }

    def _bio_with(self, theta):
        """BiologyParams with the calibrated fields replaced by (traced)
        transforms of ``theta`` — same frozen-dataclass-carrying-tracers
        pattern as the ensemble sweep (closed over, never a static arg)."""
        over = {
            n: _from_unconstrained(n, theta[i]).astype(jnp.float32)
            for i, n in enumerate(self.names)
        }
        return dataclasses.replace(self.engine.bio, **over)

    # -- rollout --------------------------------------------------------------

    def _rollout(self, theta, state: CellState, cfg: EngineConfig):
        """Rollout loss; a stacked state (leading replicate axis, as built
        by ``EnsembleEngine.init_states``) fits the REPLICATE-AVERAGED loss
        — the statistically right objective for a stochastic model (each
        replicate contributes its own RNG stream; averaging shrinks the
        estimator variance of the observed statistic)."""
        if state.alive.ndim == 2:  # (R, C): stacked replicates
            outs, infos = jax.vmap(
                lambda s: self._rollout_single(theta, s, cfg)
            )(state)
            info_max = StepInfo(*(jnp.max(f, axis=0) for f in infos))
            if isinstance(self.loss_fn, (EnsembleLoss, EnsembleTrajectoryLoss)):
                # method of moments: loss on the replicate-mean statistic
                # (scalar final-state statistic, or the whole (horizon, ...)
                # trajectory for EnsembleTrajectoryLoss)
                return self.loss_fn.loss(jnp.mean(outs, axis=0)), info_max
            return jnp.mean(outs), info_max
        out, info = self._rollout_single(theta, state, cfg)
        if isinstance(self.loss_fn, (EnsembleLoss, EnsembleTrajectoryLoss)):
            out = self.loss_fn.loss(out)
        return out, info

    def _rollout_single(self, theta, state: CellState, cfg: EngineConfig):
        """Returns (loss, info) — except under an :class:`EnsembleLoss`,
        where it returns (statistic, info) so the caller can aggregate
        across replicates before applying the loss."""
        eng = self.engine
        bio = self._bio_with(theta)
        traj = isinstance(self.loss_fn, TrajectoryLoss)

        def body(s, _):
            s2, info = hipsc_step(
                s, cfg=cfg, gen=eng.gen, xp=eng.xp, bio=bio, diff=eng.diff
            )
            stat = self.loss_fn.statistic(s2) if traj else jnp.float32(0)
            return s2, (info, stat)

        if self.remat:
            body = jax.checkpoint(body)
        final, (infos, stats) = jax.lax.scan(
            body, state, None, length=self.horizon
        )
        info_max = StepInfo(*(jnp.max(f, axis=0) for f in infos))
        if isinstance(self.loss_fn, EnsembleTrajectoryLoss):
            out = stats  # (horizon, ...) — replicate-averaged by the caller
        elif traj:
            out = self.loss_fn.loss(stats)
        elif isinstance(self.loss_fn, EnsembleLoss):
            out = self.loss_fn.statistic(final)  # aggregated by the caller
        else:
            out = self.loss_fn(final)
        return out, info_max

    def _fns(self, cfg: EngineConfig):
        # key includes bio: the NON-calibrated fields are baked into the
        # trace by _bio_with (same contract as HipscEngine._step_fn)
        key = (cfg, self.engine.gen, self.engine.xp, self.engine.bio,
               self.engine.diff)
        if key not in self._compiled:
            # Reverse-mode rides the WINDOWED physics even when dense_pairs
            # is on: the dense path's per-substep (C, C[, 3]) intermediates
            # become saved residuals under value_and_grad — measured 38.6 GB
            # (device OOM) at capacity 1536 x 32 replicates, vs ~tens of MB of
            # (C, W, 8) window residuals. Forward-only evaluations (ES
            # populations, landscape probes) keep the dense path, where it
            # is the measured win (gather-free). The two paths agree
            # allclose (reduction order differs); each fit method uses only
            # one of them, so no fit ever mixes numerics mid-run.
            # remat_substeps: recompute physics-substep residuals from the
            # scan carry during the backward sweep — without it the
            # windowed substeps still save ~0.5 GB x 11 HLO temps at the
            # showcase shape (R=32), which with the step-level remat's own
            # buffers exceeded device memory.
            vg_cfg = dataclasses.replace(cfg, dense_pairs=False,
                                         remat_substeps=True)
            vg = jax.jit(
                jax.value_and_grad(
                    lambda t, s: self._rollout(t, s, vg_cfg), has_aux=True
                )
            )
            pop = jax.jit(
                jax.vmap(lambda t, s: self._rollout(t, s, cfg),
                         in_axes=(0, None))
            )
            self._compiled[key] = (vg, pop)
        return self._compiled[key]

    def _grow(self, state: CellState, info_max_host: StepInfo):
        """Apply the engine's growth policy to max-reduced rollout probes;
        returns the (possibly re-padded) state and whether anything grew."""
        eng = self.engine
        grown = eng._grown_cfg(eng.cfg, info_max_host)
        if grown is None:
            return state, False
        eng.cfg = grown
        if state.alive.ndim == 2:
            from hipsc_abm.parallel.ensemble import EnsembleEngine

            return EnsembleEngine.repad_states(state, grown), True
        return HipscEngine.repad_state(state, grown), True

    @staticmethod
    def _host_info(info) -> StepInfo:
        return StepInfo(*(np.max(np.asarray(f))
                          for f in jax.device_get(tuple(info))))

    def _eval_with_growth(self, which: int, theta_or_cands, state: CellState):
        """Evaluate the compiled rollout (``which``: 0 = value_and_grad,
        1 = population), growing the shared config and re-padding on any
        tripped overflow probe — one copy of the retry policy shared by
        ``fit`` and ``fit_es``. Returns ``(result, state)``."""
        for _attempt in range(8):
            fn = self._fns(self.engine.cfg)[which]
            result = fn(theta_or_cands, state)
            info_host = self._host_info(
                result[0][1] if which == 0 else result[1]
            )
            if int(info_host.max_id) >= (1 << 24) - 1:
                raise RuntimeError(
                    "agent id space exhausted (2^24 agents ever created)"
                )
            state, grew = self._grow(state, info_host)
            if not grew:
                return result, state
        raise RuntimeError("capacity growth failed to converge")

    def _reconcile(self, state: CellState) -> CellState:
        """Make the engine config and the state's static shapes agree in
        BOTH directions: a state from a grown run widens the config
        (capacity / bond width adopted, like the engines' ``_cfg_for_state``);
        a config grown past the state re-pads the state. The fit rollout
        then always traces with matching carry shapes."""
        eng = self.engine
        cfg = eng.cfg
        cap = int(state.alive.shape[-1])
        bond_k = int(state.bonds.partners.shape[-1])
        if cap > cfg.capacity or bond_k > cfg.bond_cap:
            new_cap = max(cap, cfg.capacity)
            cfg = dataclasses.replace(
                cfg, capacity=new_cap, bond_cap=max(bond_k, cfg.bond_cap))
            eng.cfg = cfg
        if cfg.capacity != cap or cfg.bond_cap != bond_k:
            if state.alive.ndim == 2:
                from hipsc_abm.parallel.ensemble import EnsembleEngine

                state = EnsembleEngine.repad_states(state, cfg)
            else:
                state = HipscEngine.repad_state(state, cfg)
        return state

    def prepare(self, state: CellState) -> CellState:
        """Growth preflight: run the horizon once through ``safe_step`` with
        the engine's nominal parameters so the shared config settles before
        compilation of the fit rollout (mid-fit growth still works — this
        just avoids paying extra rollout compiles for predictable growth)."""
        eng = self.engine
        state = self._reconcile(state)
        if state.alive.ndim == 2:  # stacked replicates: probe via ensemble
            from hipsc_abm.parallel.ensemble import EnsembleEngine

            if self._ens is None:
                self._ens = EnsembleEngine(eng)
            probe = state
            for _ in range(self.horizon):
                probe, _ = self._ens.safe_step(probe)
        else:
            probe = state
            for _ in range(self.horizon):
                probe, _ = eng.safe_step(probe)
        # the probe may have committed capacity OR bond-cap growth
        return self._reconcile(state)

    # -- gradient fitting -------------------------------------------------------

    def fit(self, state: CellState, iters: int = 40,
            optimizer=None, learning_rate: float = 0.05,
            log_every: int = 0) -> FitResult:
        """Gradient descent through the rollout (reverse-mode AD).

        Every name must be in :data:`DIFFERENTIABLE` — the Bernoulli fate
        probabilities have zero pathwise gradient and would silently not
        move; fit those with :meth:`fit_es`. ``log_every=k`` prints
        iteration/loss/current params to stderr every k iterations —
        long fits are otherwise silent for their whole wall time.
        """
        flat = sorted(set(self.names) - DIFFERENTIABLE)
        if flat:
            raise ValueError(
                f"zero pathwise gradient for {flat} (discrete-event "
                "parameters) — use fit_es for these"
            )
        if iters < 1:
            raise ValueError("iters must be >= 1")
        import optax

        opt = optimizer if optimizer is not None else optax.adam(learning_rate)
        state = self.prepare(state)
        theta = self.theta0()
        opt_state = opt.init(theta)
        history: List[float] = []
        best = (float("inf"), theta)
        n_evals = 0
        for it in range(iters):
            ((loss, _), grad), state = self._eval_with_growth(0, theta, state)
            n_evals += 1
            history.append(float(loss))
            if history[-1] < best[0]:
                best = (history[-1], theta)
            updates, opt_state = opt.update(grad, opt_state, theta)
            theta = optax.apply_updates(theta, updates)
            if log_every and (it + 1) % log_every == 0:
                print(f"calibrate.fit iter {it + 1}/{iters} "
                      f"loss {history[-1]:.6g} best {best[0]:.6g} "
                      f"params {self.params(theta)}",
                      file=sys.stderr, flush=True)
        return FitResult(self.params(best[1]), np.asarray(best[1]), history,
                         n_evals)

    # -- evolution-strategy fitting ---------------------------------------------

    def fit_es(self, state: CellState, iters: int = 30, popsize: int = 16,
               sigma: float = 0.1, optimizer=None,
               learning_rate: float = 0.05, seed: int = 0,
               log_every: int = 0) -> FitResult:
        """Antithetic evolution strategies (OpenAI-ES) with rank shaping.

        The population of ``popsize`` perturbed parameter vectors rolls out
        as one vmapped program from the SAME initial state and RNG stream
        (common random numbers), so fitness differences isolate the
        parameter effect. Works for every :data:`SEARCHABLE` name, including
        the discrete-event probabilities gradients cannot see.
        """
        if popsize < 2 or popsize % 2:
            raise ValueError("popsize must be even and >= 2 (antithetic)")
        if iters < 1:
            raise ValueError("iters must be >= 1")
        import optax

        opt = optimizer if optimizer is not None else optax.adam(learning_rate)
        state = self.prepare(state)
        theta = self.theta0()
        opt_state = opt.init(theta)
        key = jax.random.PRNGKey(seed)
        half = popsize // 2
        history: List[float] = []
        best = (float("inf"), theta)
        n_evals = 0
        for it in range(iters):
            key, sub = jax.random.split(key)
            eps = jax.random.normal(sub, (half, len(self.names)),
                                    dtype=theta.dtype)
            eps = jnp.concatenate([eps, -eps], axis=0)
            cands = theta[None, :] + sigma * eps
            (losses, _), state = self._eval_with_growth(1, cands, state)
            n_evals += popsize
            losses = np.asarray(jax.device_get(losses), dtype=np.float64)
            history.append(float(losses.mean()))
            if history[-1] < best[0]:
                best = (history[-1], theta)
            # centered-rank shaping (robust to loss scale/outliers)
            ranks = np.empty(popsize)
            ranks[np.argsort(losses)] = np.arange(popsize)
            shaped = ranks / (popsize - 1) - 0.5  # ascending with loss
            g_est = jnp.asarray(
                (shaped[:, None] * np.asarray(eps)).sum(0)
                / (half * sigma),
                dtype=theta.dtype,
            )
            updates, opt_state = opt.update(g_est, opt_state, theta)
            theta = optax.apply_updates(theta, updates)
            if log_every and (it + 1) % log_every == 0:
                print(f"calibrate.fit_es iter {it + 1}/{iters} "
                      f"mean-loss {history[-1]:.6g} "
                      f"params {self.params(theta)}",
                      file=sys.stderr, flush=True)
        # the loop only ever measured PERTURBED populations (a proxy);
        # evaluate the final and proxy-best iterates unperturbed and return
        # the verified winner (appended to the history)
        cands = jnp.stack([theta, best[1]])
        (final_losses, _), state = self._eval_with_growth(1, cands, state)
        n_evals += 2
        final_losses = np.asarray(jax.device_get(final_losses),
                                  dtype=np.float64)
        pick = int(np.argmin(final_losses))
        chosen = [theta, best[1]][pick]
        history.append(float(final_losses[pick]))
        return FitResult(self.params(chosen), np.asarray(chosen), history,
                         n_evals)
