"""Calibration demo: recover biophysical parameters from colony statistics.

Two workflows the reference framework cannot express at all:

1. GRADIENT calibration — ``jax.grad`` straight through a multi-step
   simulation rollout recovers the JKR adhesion constant from a single
   colony-compaction statistic (radius of gyration).
2. EVOLUTION-STRATEGY calibration — a vmapped population search recovers a
   Bernoulli fate probability, whose pathwise gradient is zero, from the
   GATA6-high fraction.

Run:  JAX_PLATFORMS=cpu PYTHONPATH=. python examples/calibrate.py
(or on the GPU by dropping JAX_PLATFORMS; calibration-sized colonies run
fine either way.)
"""

import dataclasses

from hipsc_abm.calibrate import (
    Calibrator,
    gata6_high_fraction,
    radius_of_gyration,
    squared_error,
)
from hipsc_abm.engine import HipscEngine
from hipsc_abm.models.params import ExperimentalParams, GeneralParams


def make_engine(**kw):
    gen = GeneralParams(num_to_start=400, end_step=8, size=(500.0, 500.0, 0.0))
    xp = ExperimentalParams(num_gata6=40, dox_step=1)
    return HipscEngine(gen, xp, **kw)


def synthetic_observation(statistic, steps=5, **bio_overrides):
    """Pretend lab data: run the model at 'true' parameters and measure."""
    eng = make_engine(**{k: v for k, v in bio_overrides.items()
                         if k == "enable_stochastic"})
    eng.bio = dataclasses.replace(
        eng.bio, **{k: v for k, v in bio_overrides.items()
                    if k != "enable_stochastic"}
    )
    state = eng.init_state(seed=7)
    for _ in range(steps):
        state, _ = eng.safe_step(state)
    return float(statistic(state))


def main():
    # ---- 1. gradient calibration of the adhesion constant -----------------
    true_adhesion = 2.5e-4  # vs the reference default 1.07e-4
    observed_rog = synthetic_observation(
        radius_of_gyration, adhesion_const=true_adhesion
    )
    print(f"observed radius of gyration: {observed_rog:.2f} um "
          f"(true adhesion_const = {true_adhesion:.3e})")

    eng = make_engine()
    cal = Calibrator(
        eng, ["adhesion_const"],
        squared_error(radius_of_gyration, observed_rog), horizon=5,
    )
    state = eng.init_state(seed=7)
    res = cal.fit(state, iters=30, learning_rate=0.15)
    print(f"gradient fit: loss {res.loss_history[0]:.3e} -> "
          f"{res.loss_history[-1]:.3e} in {res.n_evaluations} rollouts")
    print(f"  recovered adhesion_const = "
          f"{res.params['adhesion_const']:.3e}\n")

    # ---- 2. ES calibration of a discrete fate probability ------------------
    true_prob = 0.25
    observed_frac = synthetic_observation(
        gata6_high_fraction, GATA6_prob=true_prob, enable_stochastic=True
    )
    print(f"observed GATA6-high fraction: {observed_frac:.3f} "
          f"(true GATA6_prob = {true_prob})")

    eng2 = make_engine(enable_stochastic=True)
    cal2 = Calibrator(
        eng2, ["GATA6_prob"],
        squared_error(gata6_high_fraction, observed_frac), horizon=5,
    )
    state2 = eng2.init_state(seed=7)
    res2 = cal2.fit_es(state2, iters=15, popsize=16, sigma=0.25,
                       learning_rate=0.25, seed=0)
    print(f"ES fit: mean population loss {res2.loss_history[0]:.3e} -> "
          f"{res2.loss_history[-1]:.3e} in {res2.n_evaluations} rollouts")
    print(f"  recovered GATA6_prob = {res2.params['GATA6_prob']:.3f}")


if __name__ == "__main__":
    main()
