"""Long-running validation soaks (beyond the test suite's scale).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/soak.py 2d       # ~4 min
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/soak.py 3d       # ~2 min
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/soak.py elastic  # ~6 min

- ``2d``: 60 steps, (2,2) tiles vs single chip, 3,000 growing cells with
  diffusion + uptake + stochastic updates — ids/positions/fates bit-exact
  at every 10-step checkpoint, lattice within the documented 1e-5 deposit-
  accumulation tolerance; then 30 field-coupled steps (liveness).
- ``3d``: 40 steps, (4,2) tiles in a 3D box — same bit-exactness.
- ``elastic``: 40 steps resumed across four decompositions
  ((2,2) -> (4,2) -> single -> (2,2)) vs the uninterrupted run, bit-exact.

Needs >= 8 devices (the virtual CPU mesh counts)."""

import dataclasses
import os
import sys
import tempfile
import time

import jax

if jax.default_backend() == "cpu" and jax.device_count() < 8:
    raise SystemExit("run with JAX_PLATFORMS=cpu and "
                     "XLA_FLAGS=--xla_force_host_platform_device_count=8 "
                     "(or any >=8-device backend)")

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from hipsc_abm.engine import HipscEngine, config_to_meta
from hipsc_abm.models.params import (
    DiffusionParams,
    ExperimentalParams,
    GeneralParams,
)
from hipsc_abm.parallel.domain_engine import (
    DomainHipscEngine,
    domain_config_from_meta,
)
from hipsc_abm.utils.checkpoint import load_state, save_state


def _by_id(state):
    alive = np.asarray(state.alive)
    ids = np.asarray(state.arrays["ids"])[alive]
    order = np.argsort(ids)
    out = {"ids": ids[order]}
    for k, v in state.arrays.items():
        if k != "ids":
            out[k] = np.asarray(v)[alive][order]
    return out


def _assert_match(sstate, flat, step, check_lattice=True):
    a, b = _by_id(sstate), _by_id(flat)
    assert np.array_equal(a["ids"], b["ids"]), ("IDS", step)
    assert np.array_equal(a["locations"], b["locations"]), ("POS", step)
    for k in ("GATA6", "NANOG", "states", "div_counters", "death_counters"):
        assert np.array_equal(a[k], b[k]), (k, step)
    if check_lattice and sstate.gradients:
        g_s = np.asarray(sstate.gradients["fgf4_values"])
        g_d = np.asarray(flat.gradients["fgf4_values"])
        np.testing.assert_allclose(g_s, g_d, atol=1e-5)


def soak_domain(steps, tiles, gen, xp, diffusion):
    kw = dict(enable_stochastic=True)
    if diffusion:
        kw.update(diff=DiffusionParams(
            spat_res=20.0, diffuse_dt=6.0, diffuse_const=2.0,
            max_concentration=2.0, degradation=0.1, release_amount=0.01,
            uptake_amount=0.002, field_coupling=False),
            enable_diffusion=True)
    dom = DomainHipscEngine(gen, xp, tiles=tiles, **kw)
    dstate = dom.init_state(seed=5)
    single = HipscEngine(gen, xp, cfg=dom.cfg.base, **kw)
    single.cfg = dom.cfg.base
    sstate = single.init_state(seed=5)
    t0 = time.time()
    for step in range(1, steps + 1):
        sstate, sinfo = single.safe_step(sstate)
        dstate, dinfo = dom.safe_step(dstate)
        assert int(sinfo.num_agents) == int(dinfo.num_agents), step
        if step % 10 == 0:
            _assert_match(sstate, dom.to_cell_state(dstate), step,
                          check_lattice=diffusion)
            print(f"step {step}: {int(sinfo.num_agents)} agents bit-exact "
                  f"({time.time()-t0:.0f}s)", flush=True)
    print(f"SOAK OK: {steps} steps, tiles={tiles}")


def soak_elastic():
    gen = GeneralParams(num_to_start=2200, end_step=40,
                        size=(1100.0, 1100.0, 0.0))
    xp = ExperimentalParams(num_gata6=220, dox_step=3)
    tmp = tempfile.mkdtemp()

    dom0 = DomainHipscEngine(gen, xp, tiles=(2, 2))
    ref = HipscEngine(gen, xp, cfg=dom0.cfg.base)
    ref.cfg = dom0.cfg.base
    rstate = ref.init_state(seed=9)
    for _ in range(40):
        rstate, rinfo = ref.safe_step(rstate)

    d = dom0.init_state(seed=9)
    for _ in range(10):
        d, _ = dom0.safe_step(d)
    dom0.save_checkpoint(os.path.join(tmp, "ck1"), d)

    dom1 = DomainHipscEngine(gen, xp, tiles=(4, 2))
    d = dom1.load_checkpoint(os.path.join(tmp, "ck1"), elastic=True)
    for _ in range(10):
        d, _ = dom1.safe_step(d)
    dom1.save_checkpoint(os.path.join(tmp, "ck2"), d)

    flat, meta = load_state(os.path.join(tmp, "ck2"))
    cfg = domain_config_from_meta(meta["domain_config"]).base
    single = HipscEngine(gen, xp, cfg=cfg)
    single.cfg = dataclasses.replace(cfg, capacity=int(flat.alive.shape[0]))
    s = flat
    for _ in range(10):
        s, _ = single.safe_step(s)
    save_state(os.path.join(tmp, "ck3"), s,
               meta={"engine_config": config_to_meta(single.cfg)})

    dom2 = DomainHipscEngine(gen, xp, tiles=(2, 2))
    d = dom2.load_checkpoint(os.path.join(tmp, "ck3"), elastic=True)
    for _ in range(10):
        d, dinfo = dom2.safe_step(d)

    assert int(rinfo.num_agents) == int(dinfo.num_agents)
    _assert_match(rstate, dom2.to_cell_state(d), 40, check_lattice=False)
    print(f"ELASTIC CHAIN OK: 40 steps, {int(dinfo.num_agents)} agents "
          "bit-exact vs uninterrupted")


def main(mode):
    if mode == "2d":
        soak_domain(60, (2, 2),
                    GeneralParams(num_to_start=3000, end_step=60,
                                  size=(1100.0, 1100.0, 0.0)),
                    ExperimentalParams(num_gata6=300, dox_step=3),
                    diffusion=True)
    elif mode == "3d":
        soak_domain(40, (4, 2),
                    GeneralParams(num_to_start=2400, end_step=40,
                                  size=(1400.0, 700.0, 220.0)),
                    ExperimentalParams(num_gata6=240, dox_step=3),
                    diffusion=False)  # the morphogen lattice is 2D-only
    elif mode == "elastic":
        soak_elastic()
    else:
        raise SystemExit("mode must be one of: 2d, 3d, elastic")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "2d")
