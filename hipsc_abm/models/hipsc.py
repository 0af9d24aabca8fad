"""CellSimulation: the hiPSC colony model on the fused engine.

Mirrors the reference model assembly (``cell_simulation.py:10-157``): reads
``experimental.yaml``, exposes the same biology-constant attributes, seeds the
same initial colony through the framework registration API, and overrides
``steps()`` — but the per-step loop body is the single fused jitted
``hipsc_step`` instead of ten host methods. Output formats (step images with
both color modes, value CSVs, TDA splits, gradient CSVs, temp checkpoint,
data CSV, end-of-run video) match ``cell_simulation.py:77-126`` /
``cell_outputs.py``.
"""

from __future__ import annotations

import os
import time
import pickle
from typing import Dict, List, Optional

import jax
import numpy as np

from hipsc_abm.engine import CellState, EngineConfig, HIPSC_ARRAY_SPECS, HipscEngine
from hipsc_abm.models.params import BiologyParams, DiffusionParams, ExperimentalParams
from hipsc_abm.ops.jkr import BondState
from hipsc_abm.simulation import Simulation
from hipsc_abm.utils import io as io_utils
from hipsc_abm.utils.config import check_direct, template_params
from hipsc_abm.utils.profiling import record_block, record_time

OUTPUT_ARRAYS = [
    "locations", "FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states",
    "diff_counters", "div_counters",
]  # the nine arrays the reference CSVs each step (cell_simulation.py:118-119)


class CellSimulation(Simulation):
    """hiPSC colony simulation (NANOG/GATA6 fate, JKR contact mechanics)."""

    def __init__(self, name: str, output_path: str):
        super().__init__(name, output_path)

        # experimental template (cell_simulation.py:19-27)
        keys = template_params(self.templates_path + "experimental.yaml")
        self.num_gata6 = keys["num_gata6"]
        self.output_tda = keys["output_tda"]
        self.output_gradients = keys["output_gradients"]
        self.group = keys["group"]  # vestigial in the reference; kept for parity
        self.dox_step = keys["dox_step"]
        self.guye_move = keys["guye_move"]
        self.lonely_thresh = keys["lonely_thresh"]
        self.color_mode = keys["color_mode"]

        # additional output paths (cell_simulation.py:30-31)
        self.gradients_path = self.main_path + name + "_gradients" + self.separator
        self.tda_path = self.main_path + name + "_tda" + self.separator

        # biology constants exposed as attributes for parity
        # (cell_simulation.py:34-57); the single source of truth is the
        # BiologyParams dataclass
        self.biology_params = BiologyParams()
        bio = self.biology_params
        self.step_dt = bio.step_dt
        self.move_dt = bio.move_dt
        self.field = bio.field
        self.GATA6_prob = bio.GATA6_prob
        self.NANOG_prob = bio.NANOG_prob
        self.pluri_div_thresh = bio.pluri_div_thresh
        self.diff_div_thresh = bio.diff_div_thresh
        self.pluri_to_diff = bio.pluri_to_diff
        self.death_thresh = bio.death_thresh
        self.fds_thresh = bio.fds_thresh
        self.max_radius = bio.max_radius
        self.min_radius = bio.min_radius
        self.pluri_growth = bio.pluri_growth
        self.diff_growth = bio.diff_growth

        self.experimental_params = ExperimentalParams.from_dict(keys)
        # the three biology methods the reference ships commented out of its
        # schedule (cell_simulation.py:98-100) are config-enabled here
        self.enable_growth = bool(keys.get("enable_growth", False))
        self.enable_stochastic = bool(keys.get("enable_stochastic", False))
        self.enable_diff_surround = bool(keys.get("enable_diff_surround", False))
        # diffusion is config-enabled (the reference ships it commented out,
        # cell_simulation.py:60-75); optional keys in experimental.yaml
        self.enable_diffusion = bool(keys.get("enable_diffusion", False))
        self.diffusion_params = (
            DiffusionParams(
                spat_res=float(keys.get("spat_res", 10.0)),
                diffuse_dt=float(keys.get("diffuse_dt", 6.0)),
                diffuse_const=float(keys.get("diffuse_const", 2.0)),
                max_concentration=float(keys.get("max_concentration", 2.0)),
                degradation=float(keys.get("degradation", 0.1)),
                release_amount=float(keys.get("release_amount", 0.0)),
                uptake_amount=float(keys.get("uptake_amount", 0.0)),
                # gradient -> fate coupling: perceived FGF4 in the pathway
                # comes from the morphogen field at the cell's position
                # (reference get_concentration semantics) instead of the
                # neighbor count
                field_coupling=bool(keys.get("field_coupling", False)),
            )
            if self.enable_diffusion
            else None
        )

        self.engine: Optional[HipscEngine] = None
        self.state: Optional[CellState] = None

    # ------------------------------------------------------------------
    # initial conditions (cell_simulation.py:128-157)
    # ------------------------------------------------------------------

    def agent_initials(self):
        rng = self._np_rng
        self.add_agents(self.num_to_start)
        self.add_agents(self.num_gata6, agent_type="GATA6_high")

        self.agent_array("locations", override=rng.random((self.number_agents, 3)) * self.size)
        self.agent_array("radii", func=lambda: self.max_radius)
        self.agent_array("FGF4", dtype=int, func=lambda: rng.integers(0, self.field))
        self.agent_array("FGFR", dtype=int, func=lambda: rng.integers(0, self.field))
        self.agent_array("ERK", dtype=int, func=lambda: rng.integers(0, self.field))
        self.agent_array("GATA6", dtype=int)
        self.agent_array("NANOG", dtype=int, func=lambda: rng.integers(0, self.field))
        self.agent_array("states", dtype=int)
        self.agent_array("death_counters", dtype=int, func=lambda: rng.integers(0, self.death_thresh))
        self.agent_array("diff_counters", dtype=int, func=lambda: rng.integers(0, self.pluri_to_diff))
        self.agent_array("div_counters", dtype=int, func=lambda: rng.integers(0, self.pluri_div_thresh))
        self.agent_array("fds_counters", dtype=int,
                         func=(lambda: rng.integers(0, self.fds_thresh)) if self.fds_thresh > 1 else (lambda: 0))
        self.agent_array("motility_forces", vector=3)
        self.agent_array("jkr_forces", vector=3)

        self.agent_array("GATA6", agent_type="GATA6_high",
                         func=lambda: rng.integers(1, max(self.field, 2)))
        self.agent_array("NANOG", agent_type="GATA6_high", func=lambda: 0)

        self.agent_graph("neighbor_graph")
        self.agent_graph("jkr_graph")

    # ------------------------------------------------------------------
    # engine wiring
    # ------------------------------------------------------------------

    def _make_engine(self):
        flags = dict(
            enable_diffusion=self.enable_diffusion,
            enable_growth=self.enable_growth,
            enable_stochastic=self.enable_stochastic,
            enable_diff_surround=self.enable_diff_surround,
        )
        if getattr(self, "domain_tiles", None):
            # general.yaml extension key `domain_tiles`: the full lifecycle
            # (modes 0-3, outputs, checkpoints) on the multi-chip domain
            # engine — the reference has no such mode at all
            from hipsc_abm.parallel.domain_engine import DomainHipscEngine

            return DomainHipscEngine(
                self.general_params,
                self.experimental_params,
                self.biology_params,
                self.diffusion_params,
                tiles=self.domain_tiles,
                **flags,
            )
        return HipscEngine(
            self.general_params,
            self.experimental_params,
            self.biology_params,
            self.diffusion_params,
            **flags,
        )

    @property
    def _is_domain(self) -> bool:
        return getattr(self, "domain_tiles", None) is not None

    def build_state(self) -> None:
        """Pack the registered host arrays into the device state PyTree."""
        import dataclasses as _dc

        if self.engine is None:
            self.engine = self._make_engine()
        is_domain = self._is_domain
        cfg = self.engine.cfg.base if is_domain else self.engine.cfg
        n = self.number_agents
        if not is_domain and n > cfg.capacity:
            self.engine.cfg = cfg = _dc.replace(
                cfg, capacity=max(cfg.capacity, ((int(n * 1.5) + 127) // 128) * 128)
            )
        # for the domain engine the flat CellState below is only a staging
        # layout (from_cell_state re-partitions it tile-major); per-tile slot
        # capacities rule, not cfg.capacity
        C = max(cfg.capacity, ((n + 127) // 128) * 128) if is_domain else cfg.capacity

        arrays = {}
        for name, (dtype, vec) in HIPSC_ARRAY_SPECS.items():
            shape = (C,) if vec is None else (C, vec)
            host = np.zeros(shape, dtype=dtype)
            if name == "ids":  # engine-internal stable identity
                host[:n] = np.arange(n, dtype=np.int32)
            else:
                host[:n] = np.asarray(self.__dict__[name])
            arrays[name] = jax.numpy.asarray(host)
        alive = np.zeros((C,), dtype=bool)
        alive[:n] = True

        gradients: Dict[str, np.ndarray] = {}
        if cfg.enable_diffusion and self.diffusion_params is not None:
            nx, ny = self.diffusion_params.grid_size(tuple(self.size))
            gradients["fgf4_values"] = jax.numpy.zeros((nx, ny), dtype=jax.numpy.float32)
            self.gradient_names = ["fgf4_values"]

        self.state = CellState(
            arrays=arrays,
            alive=jax.numpy.asarray(alive),
            bonds=BondState.empty(C, cfg.bond_cap),
            gradients=gradients,
            key=jax.random.PRNGKey(self.seed),
            step=jax.numpy.asarray(self.beginning_step, dtype=jax.numpy.int32),
            next_id=jax.numpy.asarray(n, dtype=jax.numpy.int32),
        )
        if is_domain:
            self.state = self.engine.from_cell_state(self.state)

    def _sync_host(self) -> None:
        """Fetch the FULL device state to the host once per step and derive
        the compacted live-agent attribute surface (``self.locations`` etc.)
        from it. The host PyTree is cached for this step's checkpoint
        writers: without the cache, the temp pickle (``__getstate__``) and
        the npz checkpoint each re-fetched the whole state — two more
        ~100 MB device-to-host transfers per step, executed on the output
        worker where they contend with the next step's dispatch."""
        dev_state = self.state
        if self._is_domain:
            # flatten tile-major blocks; the cached host copy stays a
            # CellState so every checkpoint writer is engine-agnostic
            dev_state = self.engine.to_cell_state(dev_state)
        host_state = jax.tree_util.tree_map(
            np.asarray, jax.device_get(dev_state)
        )
        self._host_state = host_state
        alive = host_state.alive
        for name in self.agent_array_names:
            self.__dict__[name] = host_state.arrays[name][alive]
        self.number_agents = int(alive.sum())

    # ------------------------------------------------------------------
    # main loop (cell_simulation.py:77-126)
    # ------------------------------------------------------------------

    def steps(self):
        if self.state is None:
            self.build_state()
        assert self.engine is not None

        if self.record_initial_step:
            self.record_initials()

        # output_interval > 1 (optional general.yaml extension): run
        # device-resident k-step blocks (HipscEngine.run_steps — one
        # dispatch + one stacked probe fetch per block) between host
        # outputs. Per-step Added/Removed prints still come from the
        # stacked probes; outputs land on block boundaries. interval=1 is
        # the reference's output-every-step loop, unchanged.
        interval = getattr(self, "output_interval", 1)
        use_blocks = interval > 1 and hasattr(self.engine, "run_steps")

        step = self.beginning_step
        while step <= self.end_step:
            if not use_blocks:
                self.current_step = step
                self.info()

                # the fused device step: neighbors, division, death, pathway,
                # differentiation, (growth/stochastic/diff_surround/diffusion),
                # motility, 11 physics substeps
                self._host_state = None  # cache belongs to the previous step
                with record_block(self, "step_fused"):
                    self.state, info = self.engine.safe_step(self.state)
                    jax.block_until_ready(self.state.arrays["locations"])

                print("\tAdded " + str(int(info.num_added)) + " agents")
                print("\tRemoved " + str(int(info.num_removed)) + " agents")
                step += 1
            else:
                k = min(interval, self.end_step + 1 - step)
                n_before = self.number_agents
                self._host_state = None
                # the boundary row's 'Step Time' must include the device
                # block, not just the host output pipeline:
                # data() reads self.step_start, so anchor it BEFORE the
                # block — the recorded time is the whole k-step block wall
                # plus the boundary outputs
                self.step_start = time.perf_counter()
                with record_block(self, "step_fused"):
                    self.state, infos = self.engine.run_steps(self.state, k)
                    jax.block_until_ready(self.state.arrays["locations"])
                added = np.asarray(infos.num_added)
                removed = np.asarray(infos.num_removed)
                agents = np.asarray(infos.num_agents)
                for j in range(k):
                    self.current_step = step + j
                    print("Step: " + str(self.current_step))
                    print("Number of agents: "
                          + str(n_before if j == 0 else int(agents[j - 1])))
                    print("\tAdded " + str(int(added[j])) + " agents")
                    print("\tRemoved " + str(int(removed[j])) + " agents")
                step += k
                self.current_step = step - 1

            self._sync_host()

            self.step_image()
            self.step_values(arrays=OUTPUT_ARRAYS)
            if self.enable_diffusion:
                self.step_gradients()
            self.step_tda()
            self.temp()
            self.data()

        self.create_video()  # flushes the async output queue first

    # ------------------------------------------------------------------
    # outputs (cell_outputs.py)
    # ------------------------------------------------------------------

    @record_time
    def step_image(self, background=(0, 0, 0), origin_bottom=True):
        if self.output_images:
            check_direct(self.images_path)
            n = self.number_agents
            # snapshot references (the host arrays are rebound, never mutated
            # in place); render + encode run on the background writer so the
            # next device step overlaps the frame output
            states, gata6, nanog = self.states[:n], self.GATA6[:n], self.NANOG[:n]
            locations, radii = self.locations[:n], self.radii[:n]
            field, color_mode = self.field, self.color_mode
            size, quality = tuple(self.size), self.image_quality
            path = self.images_path + f"{self.name}_image_{self.current_step}.png"

            def render_and_save():
                colors = io_utils.hipsc_cell_colors(
                    np.asarray(states), np.asarray(gata6), np.asarray(nanog),
                    field, color_mode,
                )
                image = io_utils.render_step_image(
                    np.asarray(locations), np.asarray(radii), colors, size,
                    quality, background=background, origin_bottom=origin_bottom,
                )
                io_utils.save_image_png(path, image)

            io_utils.submit_output(render_and_save)

    @record_time
    def step_gradients(self):
        if self.output_gradients and self.state is not None:
            check_direct(self.gradients_path)
            host = getattr(self, "_host_state", None)
            # this step's cached host fetch when present (see _sync_host);
            # immutable jax arrays otherwise — either way a safe snapshot
            grads = (host or self.state).gradients
            path, name, step = self.gradients_path, self.name, self.current_step
            io_utils.submit_output(
                lambda: io_utils.write_gradient_csvs(
                    path, name, step,
                    {k: np.asarray(jax.device_get(v)) for k, v in grads.items()},
                )
            )

    @record_time
    def step_tda(self):
        if self.output_tda:
            check_direct(self.tda_path)
            n = self.number_agents
            locs, gata6, nanog = self.locations[:n], self.GATA6[:n], self.NANOG[:n]
            path, name, step = self.tda_path, self.name, self.current_step
            io_utils.submit_output(
                lambda: io_utils.write_tda_csvs(
                    path, name, step,
                    np.asarray(locs), np.asarray(gata6), np.asarray(nanog),
                )
            )

    @record_time
    def temp(self):
        """Checkpoint: pickle of the sim object (reference mechanism) with
        the device state swapped for a host PyTree, plus a format-stable npz
        of the state alone (bit-exact resume; SURVEY §5.4)."""
        from hipsc_abm.engine import config_to_meta
        from hipsc_abm.utils.checkpoint import save_state

        if getattr(self, "temp_pickle", True):
            super().temp.__wrapped__(self)  # the pickle, un-re-timed
        if self.state is not None:
            # prefer this step's cached host fetch (see _sync_host) so the
            # worker writes from host memory instead of re-pulling the state
            # from the device
            state = getattr(self, "_host_state", None)
            if state is None:
                state = self.state  # immutable PyTree: safe snapshot
                if self._is_domain:
                    state = self.engine.to_cell_state(state)
            path = os.path.join(self.main_path, f"{self.name}_state.npz")
            meta = {
                "current_step": self.current_step,
                "name": self.name,
            }
            if self._is_domain:
                from hipsc_abm.parallel.domain_engine import (
                    domain_config_to_meta,
                )

                meta["engine_config"] = config_to_meta(self.engine.cfg.base)
                meta["domain_config"] = domain_config_to_meta(self.engine.cfg)
            else:
                meta["engine_config"] = config_to_meta(self.engine.cfg)
            io_utils.submit_output(lambda: save_state(path, state, meta=meta))

    # ------------------------------------------------------------------
    # pickling (mode-1 continuation)
    # ------------------------------------------------------------------

    @classmethod
    def resume_from_npz(cls, name, output_dir):
        """Mode-1 resume without the per-step pickle (``temp_pickle: false``
        runs): rebuild the sim from the templates and restore the bit-exact
        npz state checkpoint. Assumes the templates are unchanged since the
        run started — the pickle path carries its own config and has no such
        assumption."""
        from hipsc_abm.engine import config_from_meta
        from hipsc_abm.utils.checkpoint import load_state

        sim = cls(name, output_dir)
        sim.agent_initials()  # registers the host array surface; the
        # resulting colony/rng draws are discarded by the npz restore below
        state, meta = load_state(
            os.path.join(sim.main_path, f"{name}_state.npz")
        )
        tiles_tmpl = sim.domain_tiles  # the template's CURRENT value
        if "domain_config" in meta:
            from hipsc_abm.parallel.domain_engine import (
                domain_config_from_meta,
            )

            cfgd = domain_config_from_meta(meta["domain_config"])
            ckpt_tiles = (cfgd.n_tx, cfgd.n_ty)
        else:
            cfgd, ckpt_tiles = None, None

        if tiles_tmpl == ckpt_tiles:
            # unchanged decomposition: adopt the checkpoint's exact static
            # configuration (probe caps feed growth state — bit-exact)
            sim.engine = sim._make_engine()
            if cfgd is not None:
                sim.engine.cfg = cfgd
                sim.state = sim.engine.from_cell_state(state)
            else:
                sim.engine.cfg = config_from_meta(meta["engine_config"])
                sim.state = state
        elif tiles_tmpl is not None:
            # ELASTIC resume: the template's domain_tiles changed since the
            # checkpoint (incl. single-chip -> domain) — re-partition onto
            # the new decomposition; bit-exact by layout independence
            sim.engine = sim._make_engine()
            sim.state = sim.engine._adopt_and_partition(
                state, meta, elastic=True
            )
        else:
            # domain checkpoint, domain_tiles removed: continue single-chip.
            # engine_config carries the base dynamics config; the capacity
            # must match the flat state's slot axis
            import dataclasses as _dcs

            sim.engine = sim._make_engine()
            sim.engine.cfg = _dcs.replace(
                config_from_meta(meta["engine_config"]),
                capacity=int(state.alive.shape[0]),
            )
            sim.state = state
        sim.current_step = int(meta["current_step"])
        sim._sync_host()
        return sim

    def __getstate__(self):
        from hipsc_abm.engine import config_to_meta

        state = super().__getstate__()
        state["engine"] = None  # holds jit caches; rebuilt lazily
        # the static config must survive: window widths feed RNG draw shapes,
        # so bit-exact resume needs the exact same EngineConfig
        if self.engine is None:
            state["_engine_cfg"] = None
        elif self._is_domain:
            from hipsc_abm.parallel.domain_engine import (
                domain_config_to_meta,
            )

            state["_engine_cfg"] = ("domain", domain_config_to_meta(self.engine.cfg))
        else:
            state["_engine_cfg"] = ("single", config_to_meta(self.engine.cfg))
        if self.state is not None:
            host = getattr(self, "_host_state", None)
            if host is None:  # no fetch cached for this step — pull one
                dev = self.state
                if self._is_domain:
                    dev = self.engine.to_cell_state(dev)
                host = jax.tree_util.tree_map(np.asarray, jax.device_get(dev))
            state["state"] = host  # always the flat CellState layout
        state["_host_state"] = None  # never persist the cache itself
        return state

    def __setstate__(self, state):
        from hipsc_abm.engine import config_from_meta

        cfg_meta = state.pop("_engine_cfg", None)
        super().__setstate__(state)
        if self.state is not None:
            self.state = jax.tree_util.tree_map(jax.numpy.asarray, self.state)
        self.engine = self._make_engine()
        if cfg_meta is not None:
            if isinstance(cfg_meta, tuple) and cfg_meta[0] == "domain":
                from hipsc_abm.parallel.domain_engine import (
                    domain_config_from_meta,
                )

                self.engine.cfg = domain_config_from_meta(cfg_meta[1])
            else:
                meta = cfg_meta[1] if isinstance(cfg_meta, tuple) else cfg_meta
                self.engine.cfg = config_from_meta(meta)
        elif self.state is not None and not self._is_domain:
            import dataclasses as _dc

            self.engine.cfg = _dc.replace(
                self.engine.cfg,
                capacity=self.state.alive.shape[0],
                bond_cap=self.state.bonds.partners.shape[1],
            )
        if self._is_domain and self.state is not None:
            # the pickle carries the flat layout; re-partition tile-major
            # (dynamics are layout-independent, so resume stays bit-exact)
            self.state = self.engine.from_cell_state(self.state)
