"""Calibration module: gradients through the simulation + ES search.

The reference has no calibration capability to match; these tests pin down
the two properties the module rests on:

1. reverse-mode AD through a multi-step rollout is FINITE and agrees with
   central finite differences (the NaN-guard rewrites in ops/jkr.py,
   ops/integrate.py, models/biology.py are what make this true);
2. the fits actually recover planted parameters from colony statistics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hipsc_abm.calibrate import (
    Calibrator,
    gata6_high_fraction,
    radius_of_gyration,
    squared_error,
    trajectory_squared_error,
)
from hipsc_abm.engine import HipscEngine, hipsc_step
from hipsc_abm.models.params import ExperimentalParams, GeneralParams

GEN = GeneralParams(num_to_start=150, end_step=5, size=(300.0, 300.0, 0.0))
XP = ExperimentalParams(num_gata6=15, dox_step=1)


def _settled_engine(**kw):
    eng = HipscEngine(GEN, XP, **kw)
    state = eng.init_state(seed=0)
    state, _ = eng.safe_step(state)  # settle capacity growth
    return eng, state


def test_rollout_gradient_finite_and_matches_fd():
    eng, state = _settled_engine()
    base_bio = eng.bio
    names = ["adhesion_const", "motility_force"]

    def loss_fn(theta, s):
        bio = dataclasses.replace(
            base_bio, **{n: theta[i] for i, n in enumerate(names)}
        )
        for _ in range(2):
            s, _ = hipsc_step(s, cfg=eng.cfg, gen=eng.gen, xp=eng.xp,
                              bio=bio, diff=eng.diff)
        return radius_of_gyration(s)

    theta0 = jnp.asarray([getattr(base_bio, n) for n in names], jnp.float32)
    val, grad = jax.jit(jax.value_and_grad(loss_fn))(theta0, state)
    assert bool(jnp.all(jnp.isfinite(grad))), grad
    assert float(jnp.max(jnp.abs(grad))) > 0.0

    f = jax.jit(loss_fn)
    for i, n in enumerate(names):
        h = theta0[i] * 1e-3
        fd = (float(f(theta0.at[i].add(h), state))
              - float(f(theta0.at[i].add(-h), state))) / (2.0 * float(h))
        ad = float(grad[i])
        # f32 central differences over a 2-step colony rollout carry a few
        # percent of cancellation noise; the check is agreement, not equality
        assert abs(ad - fd) <= 0.15 * max(abs(ad), abs(fd)), (n, ad, fd)


@pytest.mark.slow
def test_gradient_fit_recovers_planted_adhesion():
    true_adh = 3.0e-4  # ~3x the reference default
    eng_t, st = _settled_engine()
    eng_t.bio = dataclasses.replace(eng_t.bio, adhesion_const=true_adh)
    for _ in range(3):
        st, _ = eng_t.safe_step(st)
    target = float(radius_of_gyration(st))

    eng, state = _settled_engine()
    cal = Calibrator(eng, ["adhesion_const"],
                     squared_error(radius_of_gyration, target), horizon=3)
    res = cal.fit(state, iters=25, learning_rate=0.15)
    # FitResult returns the best-evaluated iterate (Adam overshoots and
    # oscillates once the loss bottoms out)
    assert res.best_loss < 1e-2 * res.loss_history[0], res.loss_history
    fitted = res.params["adhesion_const"]
    assert abs(fitted - true_adh) < 0.35 * true_adh, fitted


def test_trajectory_fit_recovers_planted_adhesion():
    """Fitting a per-step TIME COURSE of the compaction statistic (the shape
    of real calibration data) recovers the planted parameter too."""
    true_adh = 3.0e-4
    eng_t, st = _settled_engine()
    eng_t.bio = dataclasses.replace(eng_t.bio, adhesion_const=true_adh)
    course = []
    for _ in range(3):
        st, _ = eng_t.safe_step(st)
        course.append(float(radius_of_gyration(st)))

    eng, state = _settled_engine()
    cal = Calibrator(
        eng, ["adhesion_const"],
        trajectory_squared_error(radius_of_gyration, course), horizon=3,
    )
    res = cal.fit(state, iters=20, learning_rate=0.15)
    assert res.best_loss < 5e-2 * res.loss_history[0], res.loss_history
    fitted = res.params["adhesion_const"]
    assert abs(fitted - true_adh) < 0.35 * true_adh, fitted


@pytest.mark.slow
def test_es_fit_moves_discrete_probability():
    true_p = 0.3
    eng_t, st = _settled_engine(enable_stochastic=True)
    eng_t.bio = dataclasses.replace(eng_t.bio, GATA6_prob=true_p)
    for _ in range(3):
        st, _ = eng_t.safe_step(st)
    target = float(gata6_high_fraction(st))

    eng, state = _settled_engine(enable_stochastic=True)
    assert eng.bio.GATA6_prob == 0.01  # start far from the planted value
    cal = Calibrator(eng, ["GATA6_prob"],
                     squared_error(gata6_high_fraction, target), horizon=3)
    res = cal.fit_es(state, iters=10, popsize=8, sigma=0.3,
                     learning_rate=0.3, seed=3)
    assert res.best_loss < 0.5 * res.loss_history[0], res.loss_history
    assert 0.05 < res.params["GATA6_prob"] < 0.7, res.params


@pytest.mark.slow
def test_replicate_averaged_fit():
    """A stacked ensemble of replicates fits the loss on the replicate-MEAN
    statistic (EnsembleLoss / method of moments) and recovers the planted
    parameter. A plain per-replicate loss against one scalar target would
    bottom out at the across-replicate variance instead — the reason
    EnsembleLoss exists."""
    from hipsc_abm.calibrate import ensemble_squared_error
    from hipsc_abm.parallel.ensemble import EnsembleEngine

    true_adh = 3.0e-4
    eng_t = HipscEngine(GEN, XP)
    eng_t.bio = dataclasses.replace(eng_t.bio, adhesion_const=true_adh)
    ens_t = EnsembleEngine(eng_t)
    st = ens_t.init_states(seeds=[0, 1, 2])
    for _ in range(3):
        st, _ = ens_t.safe_step(st)
    target = float(np.mean([
        float(radius_of_gyration(EnsembleEngine.replicate(st, i)))
        for i in range(3)
    ]))

    eng = HipscEngine(GEN, XP)
    cal = Calibrator(eng, ["adhesion_const"],
                     ensemble_squared_error(radius_of_gyration, target),
                     horizon=3)
    states = EnsembleEngine(eng).init_states(seeds=[0, 1, 2])
    res = cal.fit(states, iters=20, learning_rate=0.15)
    assert res.best_loss < 5e-2 * res.loss_history[0], res.loss_history
    fitted = res.params["adhesion_const"]
    assert abs(fitted - true_adh) < 0.35 * true_adh, fitted


@pytest.mark.slow
def test_es_on_stacked_replicates_compiles_and_improves():
    """fit_es over a stacked replicate state: the population vmap nests
    over the inner replicate vmap (popsize x R rollouts in one program)."""
    from hipsc_abm.calibrate import ensemble_squared_error
    from hipsc_abm.parallel.ensemble import EnsembleEngine

    eng, _ = _settled_engine(enable_stochastic=True)
    eng_t, st = _settled_engine(enable_stochastic=True)
    eng_t.bio = dataclasses.replace(eng_t.bio, GATA6_prob=0.3)
    for _ in range(2):
        st, _ = eng_t.safe_step(st)
    target = float(gata6_high_fraction(st))

    cal = Calibrator(eng, ["GATA6_prob"],
                     ensemble_squared_error(gata6_high_fraction, target),
                     horizon=2)
    states = EnsembleEngine(eng).init_states(seeds=[0, 1])
    res = cal.fit_es(states, iters=4, popsize=4, sigma=0.3,
                     learning_rate=0.3, seed=1)
    # 4 generations + the final unperturbed verification evaluation
    assert len(res.loss_history) == 5
    assert all(np.isfinite(res.loss_history))
    assert res.best_loss <= res.loss_history[0]


@pytest.mark.slow
def test_gradient_finite_through_full_model_with_diffusion():
    """Reverse-mode AD stays finite through the COMPLETE step: morphogen
    FTCS subcycles, 4-point secretion/uptake deposits, and the
    field->pathway coupling, on top of the physics."""
    from hipsc_abm.models.params import DiffusionParams

    diff = DiffusionParams(spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
                           max_concentration=2.0, degradation=0.1,
                           release_amount=0.01, uptake_amount=0.002,
                           field_coupling=True)
    eng = HipscEngine(GEN, XP, diff=diff, enable_diffusion=True)
    state = eng.init_state(seed=0)
    state, _ = eng.safe_step(state)

    cal = Calibrator(eng, ["adhesion_const", "stokes"],
                     squared_error(radius_of_gyration, 100.0), horizon=2)
    theta = cal.theta0()
    (loss, _), grad = cal._fns(eng.cfg)[0](theta, state)
    assert bool(jnp.isfinite(loss))
    assert bool(jnp.all(jnp.isfinite(grad))), grad


def test_rejects_unknown_and_gated_and_nondifferentiable_names():
    eng, state = _settled_engine()
    with pytest.raises(ValueError, match="not calibratable"):
        Calibrator(eng, ["max_radius"], radius_of_gyration)
    # gate enforcement: the Bernoulli probs do nothing without the flag
    with pytest.raises(ValueError, match="enable_stochastic"):
        Calibrator(eng, ["GATA6_prob"], radius_of_gyration)
    eng2, _ = _settled_engine(enable_stochastic=True)
    cal = Calibrator(eng2, ["GATA6_prob"], radius_of_gyration)
    with pytest.raises(ValueError, match="fit_es"):
        cal.fit(state, iters=1)
    with pytest.raises(ValueError, match="horizon"):
        Calibrator(eng, ["adhesion_const"], radius_of_gyration, horizon=0)
    cal2 = Calibrator(eng, ["adhesion_const"], radius_of_gyration)
    with pytest.raises(ValueError, match="iters"):
        cal2.fit(state, iters=0)
    with pytest.raises(ValueError, match="iters"):
        cal2.fit_es(state, iters=0, popsize=2)


@pytest.mark.slow
def test_sharded_replicate_fit_matches_unsharded():
    """Replicate-DP calibration: with the stacked-replicate state sharded
    over a device mesh (EnsembleEngine.shard_states), the jitted
    grad-through-rollout partitions under GSPMD and the fit is numerically
    identical to the unsharded run — pod-scale parameter fitting is the
    same one-line API."""
    import jax
    from hipsc_abm.calibrate import ensemble_squared_error
    from hipsc_abm.parallel.ensemble import EnsembleEngine

    if jax.device_count() < 4:
        pytest.skip("needs the virtual multi-device mesh")

    def run(shard):
        eng = HipscEngine(GEN, XP)
        cal = Calibrator(eng, ["adhesion_const"],
                         ensemble_squared_error(radius_of_gyration, 100.0),
                         horizon=2)
        states = EnsembleEngine(eng).init_states(seeds=range(4))
        states = cal.prepare(states)
        if shard:
            mesh = jax.sharding.Mesh(
                np.array(jax.devices()[:4]).reshape(4), ("r",)
            )
            states = EnsembleEngine.shard_states(states, mesh)
        return cal.fit(states, iters=3, learning_rate=0.1)

    res_flat = run(shard=False)
    res_shard = run(shard=True)
    np.testing.assert_allclose(
        res_shard.loss_history, res_flat.loss_history, rtol=1e-5
    )
    assert res_shard.params.keys() == res_flat.params.keys()


def test_nan_guards_do_not_change_the_primal():
    """The guarded sqrt/pow/div in ``ops/jkr._pair_jkr`` must be
    bit-identical to the direct (unguarded) formulation on every
    NON-degenerate pair, while staying finite — in value AND gradient — on
    the degenerate pairs (mag = 0 self-pairs, r_hat = 0 padded slots) that
    made the unguarded version NaN under reverse-mode AD."""
    import math

    from hipsc_abm.ops.jkr import _pair_jkr

    bio = HipscEngine(GEN, XP).bio
    adh, poi, yng, brk = (bio.adhesion_const, bio.poisson, bio.youngs,
                          bio.jkr_break_d)

    def unguarded(loc_i, loc_j, rad_i, rad_j):
        vector = loc_i - loc_j
        mag = jnp.sqrt(jnp.sum(vector * vector, axis=-1))
        overlap = (rad_i + rad_j - mag) / 1e6
        e_hat = 1.0 / (2.0 * (1.0 - poi**2) / yng)
        r_hat = (rad_i * rad_j) / (1e6 * jnp.maximum(rad_i + rad_j, 1e-12))
        overlap_ = ((math.pi * adh) / e_hat) ** (2 / 3) * r_hat ** (1 / 3)
        d = overlap / jnp.maximum(overlap_, 1e-30)
        alive = d > brk
        f = ((-0.0204 * d + 0.4942) * d + 1.0801) * d - 1.324
        jkr = f * math.pi * adh * r_hat
        safe_mag = jnp.where(mag > 0, mag, 1.0)
        normal = jnp.where((mag > 0)[..., None], vector / safe_mag[..., None], 0.0)
        return jnp.where(alive[..., None], jkr[..., None] * normal, 0.0), alive

    rng = np.random.default_rng(0)
    loc_i = jnp.asarray(rng.uniform(0, 100, (64, 3)), jnp.float32)
    loc_j = jnp.asarray(loc_i + rng.uniform(-9, 9, (64, 3)), jnp.float32)
    rad_i = jnp.asarray(rng.uniform(3.5, 5.0, 64), jnp.float32)
    rad_j = jnp.asarray(rng.uniform(3.5, 5.0, 64), jnp.float32)

    got, alive_g = _pair_jkr(loc_i, loc_j, rad_i, rad_j, adh, poi, yng, brk)
    want, alive_w = unguarded(loc_i, loc_j, rad_i, rad_j)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(alive_g), np.asarray(alive_w))

    # degenerate pairs: self (mag=0) and padded (rad=0) slots
    z = jnp.zeros((2, 3), jnp.float32)
    dl_i = jnp.asarray([[10.0, 10.0, 0.0], [10.0, 10.0, 0.0]], jnp.float32)
    dl_j = jnp.stack([dl_i[0], z[0]])  # self-pair; garbage-at-origin pair
    dr_i = jnp.asarray([4.0, 4.0], jnp.float32)
    dr_j = jnp.asarray([4.0, 0.0], jnp.float32)  # second partner is padded

    def total_force(params):
        a, s = params
        f, _ = _pair_jkr(dl_i, dl_j, dr_i, dr_j, a, poi, yng, brk)
        return jnp.sum(f * s)

    val, grads = jax.value_and_grad(total_force)((jnp.float32(adh),
                                                  jnp.float32(1.0)))
    assert bool(jnp.isfinite(val))
    assert all(bool(jnp.isfinite(g)) for g in grads), grads


def test_delta_trajectory_loss_cancels_offsets():
    """delta_trajectory_squared_error fits the CHANGE of the statistic: a
    constant offset between simulated and observed trajectories (e.g. each
    replicate's random-placement Rg offset, ~Rg/sqrt(2N)) contributes
    exactly zero loss, while a rate mismatch is penalized."""
    import jax.numpy as jnp

    from hipsc_abm.calibrate import delta_trajectory_squared_error

    targets = np.array([10.0, 11.0, 12.5], dtype=np.float32)
    tl = delta_trajectory_squared_error(lambda s: s, targets)
    # same deltas, +4 offset -> zero loss
    assert float(tl.loss(jnp.asarray([14.0, 15.0, 16.5]))) == 0.0
    # rate mismatch is seen even under an offset
    wrong = float(tl.loss(jnp.asarray([14.0, 14.5, 15.0])))
    assert wrong > 0.1


def test_soft_contact_count_matches_bruteforce():
    """The smooth coordination statistic equals the numpy brute force on
    alive rows (same gate), and a hard-count sanity bound holds."""
    from hipsc_abm.calibrate import soft_contact_count

    eng, state = _settled_engine()
    stat = soft_contact_count(10.0, 1.0)
    got = float(stat(state))

    alive = np.asarray(state.alive)
    locs = np.asarray(state.arrays["locations"])[alive]
    d = np.sqrt(((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1) + 1e-12)
    gate = 1.0 / (1.0 + np.exp(-(10.0 - d) / 1.0))
    np.fill_diagonal(gate, 0.0)
    want = gate.sum(axis=1).mean()
    # rtol: the statistic computes d2 via the Gram identity (one MXU
    # matmul; the broadcast (C, C, 3) form OOMs under vmapped reverse-mode
    # — see soft_contact_count), whose f32 cancellation |x|^2 - <x,x'>
    # costs ~1e-5 relative at 300 um coordinates; the gate's 1-um width
    # makes that ~1e-4 of a count — far below replicate noise.
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got > 0.0  # the settled 150-cell colony has real contacts


def test_multi_delta_loss_normalizes_and_cancels_offsets():
    """Each observable's contribution is unit-free (normalized by its own
    target delta scale) and constant offsets cancel exactly."""
    from hipsc_abm.calibrate import multi_delta_trajectory_squared_error

    t_rg = np.array([50.0, 49.0, 48.0], np.float32)       # um scale
    t_ct = np.array([0.10, 0.12, 0.14], np.float32)       # count scale
    tl = multi_delta_trajectory_squared_error(
        [(lambda s: None, t_rg), (lambda s: None, t_ct)])
    # simulated courses = targets + constant offsets -> loss ~0 (f32
    # rounding of the offset additions leaves ~1e-14)
    stats = np.stack([t_rg + 7.0, t_ct + 0.05], axis=1)
    assert float(tl.loss(jnp.asarray(stats))) < 1e-10
    # equal RELATIVE errors contribute equally despite a 500x unit gap
    s1 = np.stack([t_rg + np.array([0, 0.1, 0.2], np.float32),
                   t_ct], axis=1)
    s2 = np.stack([t_rg,
                   t_ct + np.array([0, 0.002, 0.004], np.float32)], axis=1)
    l1, l2 = float(tl.loss(jnp.asarray(s1))), float(tl.loss(jnp.asarray(s2)))
    assert l1 > 0 and l2 > 0
    np.testing.assert_allclose(l1, l2, rtol=0.05)


@pytest.mark.slow
def test_joint_force_fit_with_two_observables():
    """The measured (adhesion, motility) compensating ridge under a single
    compaction course (docs/CALIBRATION.md) breaks when a coordination
    course is observed too: a JOINT fit from off starts on BOTH recovers
    both planted scales."""
    from hipsc_abm.calibrate import (
        multi_delta_trajectory_squared_error,
        soft_contact_count,
    )

    true_adh, true_mot = 1.07e-4, 2e-9
    contact = soft_contact_count(10.0, 1.0)
    eng_t, st = _settled_engine()
    eng_t.bio = dataclasses.replace(
        eng_t.bio, adhesion_const=true_adh, motility_force=true_mot)
    rg_course, ct_course = [], []
    for _ in range(4):
        st, _ = eng_t.safe_step(st)
        rg_course.append(float(radius_of_gyration(st)))
        ct_course.append(float(contact(st)))

    eng, state = _settled_engine()
    eng.bio = dataclasses.replace(
        eng.bio, adhesion_const=true_adh * 2.5, motility_force=true_mot / 2.5)
    loss = multi_delta_trajectory_squared_error(
        [(radius_of_gyration, rg_course), (contact, ct_course)])
    cal = Calibrator(eng, ["adhesion_const", "motility_force"], loss,
                     horizon=4)
    res = cal.fit(state, iters=25, learning_rate=0.15)
    assert res.best_loss < 0.05 * res.loss_history[0], res.loss_history
    for name, true in (("adhesion_const", true_adh),
                       ("motility_force", true_mot)):
        fitted = res.params[name]
        assert abs(fitted - true) < 0.5 * true, (name, fitted)


def test_ensemble_trajectory_loss_on_replicate_mean():
    """ensemble_trajectory wraps a trajectory loss to score the replicate-
    MEAN statistic course (method of moments). With the target course set
    to the engine's own replicate-mean trajectory (same seeds), the loss at
    truth is exactly zero — while the plain per-replicate-averaged loss
    floors at the across-replicate variance. This gap is why the joint
    calibration showcase needs the wrapper: a multi-run-average target
    cannot be matched below single-seed noise by per-replicate losses."""
    from hipsc_abm.calibrate import ensemble_trajectory
    from hipsc_abm.parallel.ensemble import EnsembleEngine

    horizon, seeds = 3, [0, 1, 2]
    eng_t = HipscEngine(GEN, XP)
    ens_t = EnsembleEngine(eng_t)
    st = ens_t.init_states(seeds=seeds)
    courses = []
    for _ in range(horizon):
        st, _ = ens_t.safe_step(st)
        courses.append([
            float(radius_of_gyration(EnsembleEngine.replicate(st, i)))
            for i in range(len(seeds))
        ])
    course = np.asarray(courses, np.float32)  # (horizon, R)
    target_mean = course.mean(axis=1)

    def eval_loss(loss_fn):
        eng = HipscEngine(GEN, XP)
        cal = Calibrator(eng, ["adhesion_const"], loss_fn, horizon=horizon)
        state = cal.prepare(EnsembleEngine(eng).init_states(seeds=seeds))
        (val_info, _grad), _ = cal._eval_with_growth(0, cal.theta0(), state)
        return float(val_info[0])

    base = trajectory_squared_error(radius_of_gyration, target_mean)
    loss_mean = eval_loss(ensemble_trajectory(base))
    loss_per_rep = eval_loss(base)

    # the true per-replicate floor: mean squared deviation of each
    # replicate's course from the mean course
    floor = float(((course - target_mean[:, None]) ** 2).mean())
    assert loss_mean < 1e-6, loss_mean
    np.testing.assert_allclose(loss_per_rep, floor, rtol=1e-4)


def test_grad_path_never_traces_dense_physics():
    """Reverse-mode fits must ride the WINDOWED physics even when the
    engine auto-selected ``dense_pairs``: the dense path's per-substep
    (C, C[, 3]) intermediates become saved residuals under
    ``value_and_grad`` — measured 38.6 GB (an HBM OOM) at the showcase
    shape (capacity 1536 x 32 replicates). Forward-only population
    evaluations (ES, landscape probes) keep the dense path, where it is
    the measured throughput win."""
    import hipsc_abm.engine as engine_mod
    from hipsc_abm.calibrate import (
        Calibrator,
        radius_of_gyration,
        squared_error,
    )

    eng, state = _settled_engine()
    cal = Calibrator(eng, ["adhesion_const"],
                     squared_error(radius_of_gyration, 100.0), horizon=2)
    assert eng.cfg.dense_pairs  # auto-selected at this capacity

    calls = []
    real = engine_mod._physics_scan_dense

    def spy(*a, **kw):
        calls.append("dense")
        return real(*a, **kw)

    engine_mod._physics_scan_dense = spy
    try:
        vg, pop = cal._fns(eng.cfg)
        theta = cal.theta0()
        jax.make_jaxpr(lambda t, s: vg(t, s))(theta, state)
        assert calls == [], "value_and_grad traced the dense physics path"
        jax.make_jaxpr(lambda t, s: pop(t, s))(theta[None, :], state)
        assert calls, "population path should keep the dense physics"
    finally:
        engine_mod._physics_scan_dense = real


def test_remat_substeps_is_primal_identical_and_grad_equal():
    """``EngineConfig.remat_substeps`` (the calibration gradient path's
    memory lever: scan-of-checkpointed-substeps) must not change the
    computation — primal bit-identical, gradients equal to allclose — on
    both physics scan paths."""
    eng, state = _settled_engine()
    base = eng.bio

    def mkloss(cfg):
        def loss(theta, s):
            bio = dataclasses.replace(base, adhesion_const=theta[0])
            s, _ = hipsc_step(s, cfg=cfg, gen=eng.gen, xp=eng.xp, bio=bio,
                              diff=eng.diff)
            return radius_of_gyration(s)
        return loss

    theta = jnp.asarray([base.adhesion_const], jnp.float32)
    for dense in (False, True):
        cfg0 = dataclasses.replace(eng.cfg, dense_pairs=dense)
        cfg1 = dataclasses.replace(cfg0, remat_substeps=True)
        v0, g0 = jax.jit(jax.value_and_grad(mkloss(cfg0)))(theta, state)
        v1, g1 = jax.jit(jax.value_and_grad(mkloss(cfg1)))(theta, state)
        assert float(v0) == float(v1), ("primal changed", dense)
        np.testing.assert_allclose(np.asarray(g0), np.asarray(g1),
                                   rtol=1e-5)


def test_soft_contact_count_exact_far_from_origin():
    """A compact colony ~10^4 um from the origin: the Gram identity's
    |x|^2 terms would cancel away every f32 digit of a 10 um distance, so
    positions are centered first; the statistic must match brute force."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from hipsc_abm.calibrate import soft_contact_count

    rng = np.random.default_rng(0)
    n, cap = 200, 256
    locs = np.zeros((cap, 3), np.float32)
    locs[:n, :2] = 1.2e4 + rng.random((n, 2)) * 120.0
    locs[n:] = 7.0  # dead slots
    alive = np.arange(cap) < n
    state = SimpleNamespace(arrays={"locations": jnp.asarray(locs)},
                            alive=jnp.asarray(alive))
    got = float(soft_contact_count(10.0, 1.0)(state))
    lx = locs[:n].astype(np.float64)
    d = np.sqrt(((lx[:, None, :] - lx[None, :, :]) ** 2).sum(-1) + 1e-12)
    gate = 1.0 / (1.0 + np.exp(np.minimum(d - 10.0, 700.0)))
    np.fill_diagonal(gate, 0.0)
    np.testing.assert_allclose(got, gate.sum(axis=1).mean(), rtol=2e-4)
    assert got > 0.5
