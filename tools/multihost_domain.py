"""Multi-controller (multi-host) domain-engine validation payload.

Runs the multi-host execution model for real: N separate processes (one per
emulated host, 4 virtual CPU devices each) form one global JAX mesh via
``jax.distributed``; the domain engine steps the colony with its tile
shards spread across processes — ``from_cell_state`` materializes only the
addressable shards per process, collectives ride the gloo backend, and
the sharded checkpoint writes per-process shard files. Process 0 then
reassembles the checkpoint and compares the colony BIT-EXACTLY (by agent
id) against the single-chip engine's trajectory, which every process also
computes locally on its own device 0.

Usage (each process):
    python tools/multihost_domain.py <process_id> <num_processes> <port> <dir>

The pytest wrapper is ``tests/test_multiprocess.py``; it spawns two
processes and asserts the final "MULTIHOST OK" line. This is the
executable counterpart of the multi-host claims in docs/SCALING.md — the
same code path a real multi-host run takes (jax.distributed.initialize +
one mesh over all hosts' devices).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(pid: int, nproc: int, port: int, workdir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc
    assert jax.device_count() == 4 * nproc
    assert jax.local_device_count() == 4

    import numpy as np
    from jax.experimental import multihost_utils

    from hipsc_abm.engine import HipscEngine
    from hipsc_abm.models.params import ExperimentalParams, GeneralParams
    from hipsc_abm.parallel.domain_engine import DomainHipscEngine

    gen = GeneralParams(num_to_start=1000, end_step=6, size=(1400.0, 1400.0, 0.0))
    xp = ExperimentalParams(num_gata6=100, dox_step=2)

    # tile grid spanning BOTH processes: 4x2 tiles over 8 global devices
    dom = DomainHipscEngine(gen, xp, tiles=(2 * nproc, 2))
    dstate = dom.init_state(seed=11)

    # reference trajectory: the single-chip engine on this process's own
    # device 0 (every process computes it; determinism makes them agree)
    single = HipscEngine(gen, xp, cfg=dom.cfg.base)
    sstate = single.init_state(seed=11)
    single.cfg = dom.cfg.base

    for step in range(4):
        dstate, dinfo = dom.safe_step(dstate)
        sstate, sinfo = single.safe_step(sstate)
        assert int(dinfo.num_agents) == int(sinfo.num_agents), step
        assert int(dinfo.num_added) == int(sinfo.num_added), step
        assert int(dinfo.num_removed) == int(sinfo.num_removed), step
        print(f"proc {pid} step {step}: {int(dinfo.num_agents)} agents",
              flush=True)

    # pod-style checkpoint: each process writes only its addressable tiles
    ckpt_dir = os.path.join(workdir, "ck")
    dom.save_checkpoint_sharded(ckpt_dir, dstate)

    # pod-style value-CSV output: per-tile shards from addressable data only
    vals_dir = os.path.join(workdir, "vals")
    written = dom.write_values_sharded(vals_dir, "pod", 4, dstate)
    assert len(written) == dom.cfg.n_stripes // nproc  # this process's tiles
    multihost_utils.sync_global_devices("checkpoint written")
    if pid == 0:
        from hipsc_abm.utils import io as io_utils

        merged = io_utils.merge_sharded_values(vals_dir, "pod", 4,
                                               n_shards=dom.cfg.n_stripes)
        with open(merged) as f:
            n_rows = sum(1 for _ in f) - 1
        assert n_rows == int(dinfo.num_agents), (n_rows, int(dinfo.num_agents))
        print(f"proc 0 sharded values merged: {n_rows} rows", flush=True)

    # multi-host RESUME: every process reassembles the checkpoint from the
    # shared directory and re-materializes only its addressable shards,
    # then the resumed engine steps in lockstep with the original
    dom2 = DomainHipscEngine(gen, xp, tiles=(2 * nproc, 2))
    rstate = dom2.load_checkpoint_sharded(ckpt_dir)
    rstate, rinfo = dom2.safe_step(rstate)
    dstate, dinfo = dom.safe_step(dstate)
    assert int(rinfo.num_agents) == int(dinfo.num_agents)
    assert int(rinfo.num_added) == int(dinfo.num_added)
    print(f"proc {pid} resume step: {int(rinfo.num_agents)} agents", flush=True)

    # probe-driven growth across processes: undersized halo/migration caps
    # must grow via repad_state + recompile on the mesh-global arrays
    domg = DomainHipscEngine(gen, xp, tiles=(2 * nproc, 2), halo_cap=8,
                             mig_cap=8)
    gstate = domg.init_state(seed=11)
    gstate, ginfo = domg.safe_step(gstate)
    assert domg.cfg.halo_cap > 8, "growth path never tripped"
    assert int(ginfo.num_agents) > 0
    print(f"proc {pid} growth: halo_cap 8 -> {domg.cfg.halo_cap}", flush=True)

    # full-colony host path across processes: rebalance() gathers via a
    # replicate-reshard (collectives), re-partitions at quantile bounds,
    # and re-homes — then the new partition steps
    gstate = domg.rebalance(gstate)
    gstate, ginfo2 = domg.safe_step(gstate)
    assert int(ginfo2.num_agents) > 0
    print(f"proc {pid} rebalance + step ok", flush=True)

    if pid == 0:
        from hipsc_abm.utils import checkpoint as ckpt

        flat, _meta = ckpt.load_domain_sharded(ckpt_dir)

        def by_id(state):
            # both operands are flat CellStates: arrays are (C, ...)
            alive = np.asarray(state.alive)
            ids = np.asarray(state.arrays["ids"])[alive]
            order = np.argsort(ids)
            out = {"ids": ids[order]}
            for k, v in state.arrays.items():
                if k != "ids":
                    out[k] = np.asarray(v)[alive][order]
            return out

        a = by_id(flat)
        b = by_id(sstate)
        np.testing.assert_array_equal(a["ids"], b["ids"])
        for k in ("locations", "radii", "GATA6", "NANOG", "states",
                  "div_counters", "death_counters"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        print(f"MULTIHOST OK: {nproc} processes, {4 * nproc} devices, "
              f"{len(a['ids'])} agents bit-exact vs single chip", flush=True)

    multihost_utils.sync_global_devices("done")
    jax.distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
