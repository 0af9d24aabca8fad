"""Framework layer: the ``Simulation`` base class (pythonabm-compatible API).

Re-implements the vendored pythonabm engine of the reference
(``simulation.py:11-549``) with the same public surface so user models port
unchanged:

- ``start()`` classmethod with modes 0 (new) / 1 (continue) / 2 (video) /
  3 (zip), accepting an optional output directory argument (the union of the
  two reference framework copies — SURVEY.md top note);
- registration API ``add_agents`` / ``agent_array`` / ``agent_graph``;
- ``get_neighbors(graph_name, distance, clear=True)`` fixed-radius search;
- output methods ``step_values`` / ``step_image`` / ``temp`` / ``data`` /
  ``create_video`` / ``info`` / ``record_initials`` and ``random_vector``;
- YAML templates (``general.yaml``) and ``paths.yaml`` read unchanged.

The compute path under ``get_neighbors`` is the device grid engine
(``ops.neighbors``) instead of Numba bin kernels + igraph; the adjacency is
exposed through ``AgentGraph`` with the igraph-ish accessors the reference
model layer uses (``num_neighbors``, ``neighbors``, ``get_edgelist``).
Subclasses with fully-fused device loops (see ``models.hipsc``) bypass this
host path entirely.
"""

from __future__ import annotations

import copy
import functools
import math
import os
import pickle
import shutil
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hipsc_abm.models.params import GeneralParams
from hipsc_abm.ops import neighbors as nbr_ops
from hipsc_abm.utils import cli, io as io_utils
from hipsc_abm.utils.config import check_direct, check_output_dir, template_params
from hipsc_abm.utils.profiling import record_time


class AgentGraph:
    """Host-side agent adjacency container (replaces the reference's
    ``Graph(igraph.Graph)``, ``backend.py:13-28``).

    Stores an undirected edge list plus the capacity counters the reference
    keeps for its doubling loops (kept for API parity; the engine sizes
    capacities from data instead)."""

    def __init__(self, num_vertices: int = 0):
        self.num_vertices = int(num_vertices)
        self.edges = np.zeros((0, 2), dtype=np.int64)
        self.max_neighbors = 1
        self.max_agents = 1
        self._adjacency: Optional[List[np.ndarray]] = None

    # -- construction ------------------------------------------------------

    def set_edges(self, edges: np.ndarray) -> None:
        self.edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self._adjacency = None

    def add_edges(self, edges: np.ndarray) -> None:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.edges = np.concatenate([self.edges, edges], axis=0)
        self._adjacency = None

    def delete_edges(self, indices=None) -> None:
        if indices is None:
            self.edges = np.zeros((0, 2), dtype=np.int64)
        else:
            self.edges = np.delete(self.edges, np.asarray(indices, dtype=np.int64), axis=0)
        self._adjacency = None

    def simplify(self) -> None:
        """Drop duplicate undirected edges (igraph ``simplify``)."""
        if len(self.edges) == 0:
            return
        lo = np.minimum(self.edges[:, 0], self.edges[:, 1])
        hi = np.maximum(self.edges[:, 0], self.edges[:, 1])
        self.edges = np.unique(np.stack([lo, hi], axis=1), axis=0)
        self._adjacency = None

    def add_vertex(self, n: int = 1) -> None:
        self.num_vertices += int(n)
        self._adjacency = None

    def delete_vertices(self, indices) -> None:
        """Remove vertices and reindex, dropping incident edges (igraph
        ``delete_vertices`` semantics)."""
        indices = np.unique(np.asarray(indices, dtype=np.int64))
        if len(indices) == 0:
            return
        keep = np.ones(self.num_vertices, dtype=bool)
        keep[indices] = False
        remap = np.cumsum(keep) - 1
        if len(self.edges):
            edge_ok = keep[self.edges[:, 0]] & keep[self.edges[:, 1]]
            self.edges = remap[self.edges[edge_ok]]
        self.num_vertices -= len(indices)
        self._adjacency = None

    # -- queries -----------------------------------------------------------

    def _build_adjacency(self) -> List[np.ndarray]:
        if self._adjacency is None:
            if len(self.edges) == 0:
                self._adjacency = [
                    np.empty(0, dtype=np.int64) for _ in range(self.num_vertices)
                ]
            else:
                src = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
                dst = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
                order = np.argsort(src, kind="stable")
                splits = np.searchsorted(
                    src[order], np.arange(1, self.num_vertices)
                )
                self._adjacency = np.split(dst[order], splits)
        return self._adjacency

    def neighbors(self, index: int) -> list:
        return self._build_adjacency()[index].tolist()

    def num_neighbors(self, index: int) -> int:
        return len(self._build_adjacency()[index])

    def get_edgelist(self) -> np.ndarray:
        return self.edges.copy()

    def vcount(self) -> int:
        return self.num_vertices

    def ecount(self) -> int:
        return len(self.edges)


@functools.lru_cache(maxsize=64)
def _jitted_search(spec: nbr_ops.GridSpec, radius: float):
    return jax.jit(functools.partial(nbr_ops.neighbor_search, spec, radius=radius))


class Simulation:
    """Base Simulation: agent container, neighbor engine, lifecycle, outputs."""

    def __init__(self, name: str, output_path: str):
        self.name = name
        self.separator = os.path.sep

        # paths (reference simulation.py:21-24)
        self.main_path = output_path + self.name + self.separator
        self.templates_path = os.path.abspath("templates") + self.separator
        if not os.path.isdir(self.templates_path):
            # fall back to packaged templates so the framework runs anywhere
            here = os.path.dirname(os.path.abspath(__file__))
            packaged = os.path.join(here, "..", "examples", "templates")
            self.templates_path = os.path.abspath(packaged) + self.separator
        self.images_path = self.main_path + name + "_images" + self.separator
        self.values_path = self.main_path + name + "_values" + self.separator

        # counters / registries (simulation.py:27-36)
        self.number_agents = 0
        self.current_step = 0
        self.beginning_step = 1
        self.agent_array_names: List[str] = []
        self.graph_names: List[str] = []
        self.method_times: Dict[str, float] = {}

        # general template parameters (simulation.py:52-62)
        keys = template_params(self.templates_path + "general.yaml")
        self.num_to_start = keys["num_to_start"]
        self.cuda = keys["cuda"]  # accepted, ignored by the engine
        self.end_step = keys["end_step"]
        self.size = np.array(keys["size"], dtype=float)
        self.output_values = keys["output_values"]
        self.output_images = keys["output_images"]
        self.record_initial_step = keys["record_initial_step"]
        self.image_quality = keys["image_quality"]
        self.video_quality = keys["video_quality"]
        self.fps = keys["fps"]
        self.seed = keys.get("seed", 0)  # optional extension (bit-exact runs)
        # optional extension: skip the reference's per-step pickle (the
        # dominant host serialization cost at 500k+); mode-1
        # resume then rides the bit-exact npz state checkpoint instead
        self.temp_pickle = bool(keys.get("temp_pickle", True))
        # optional extension: run the model on the multi-chip domain engine.
        # int N = N x-stripes; [n_tx, n_ty] = a 2-D tile grid. Absent/null =
        # single chip (the reference's only mode).
        tiles = keys.get("domain_tiles")
        if tiles is not None:
            tiles = (int(tiles), 1) if np.isscalar(tiles) else (
                int(tiles[0]), int(tiles[1])
            )
        self.domain_tiles = tiles
        # optional extension: output every N steps instead of every step.
        # N > 1 lets the model layer run device-resident k-step blocks
        # (HipscEngine.run_steps) between host outputs — one dispatch + one
        # probe fetch per block instead of per step. 1 (the default) is the
        # reference's output-every-step behavior.
        self.output_interval = max(1, int(keys.get("output_interval", 1)))
        self.general_params = GeneralParams.from_dict({**keys, "size": list(keys["size"])})

        self._np_rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------------
    # default model hooks (simulation.py:64-106)
    # ------------------------------------------------------------------

    def agent_initials(self):
        self.add_agents(self.num_to_start)
        self.agent_array(
            "locations",
            override=self._np_rng.random((self.number_agents, 3)) * self.size,
        )
        self.agent_array("radii", func=lambda: 5)

    def steps(self):
        if self.record_initial_step:
            self.record_initials()

        for self.current_step in range(self.beginning_step, self.end_step + 1):
            self.info()
            self.step_image()
            self.step_values()
            self.temp()
            self.data()

        self.create_video()

    # ------------------------------------------------------------------
    # registration API (simulation.py:108-188)
    # ------------------------------------------------------------------

    def add_agents(self, number: int, agent_type: Optional[str] = None) -> None:
        begin = self.number_agents
        self.number_agents += number
        if agent_type is not None:
            if not hasattr(self, "agent_types"):
                self.agent_types = {}
            self.agent_types[agent_type] = (begin, self.number_agents)

    def agent_array(
        self,
        array_name: str,
        agent_type: Optional[str] = None,
        dtype=float,
        vector: Optional[int] = None,
        func=None,
        override=None,
    ) -> None:
        if override is not None:
            if override.shape[0] != self.number_agents:
                raise Exception(
                    "Length of override array does not match number of agents in simulation!"
                )
            self.__dict__[array_name] = np.asarray(override)
            if array_name not in self.agent_array_names:
                self.agent_array_names.append(array_name)
        elif not hasattr(self, array_name):
            self.agent_array_names.append(array_name)
            size = self.number_agents if vector is None else (self.number_agents, vector)
            if dtype in (str, object):
                self.__dict__[array_name] = np.empty(size, dtype=object)
            else:
                self.__dict__[array_name] = np.zeros(size, dtype=dtype)

        if func is not None:
            if agent_type is None:
                begin, end = 0, self.number_agents
            else:
                begin, end = self.agent_types[agent_type]
            for i in range(begin, end):
                self.__dict__[array_name][i] = func()

    def agent_graph(self, graph_name: str) -> None:
        self.__dict__[graph_name] = AgentGraph(self.number_agents)
        self.graph_names.append(graph_name)

    # ------------------------------------------------------------------
    # neighbor engine (simulation.py:190-288), device grid under the hood
    # ------------------------------------------------------------------

    def _auto_run_cap(self, distance: float) -> int:
        """Size the per-run capacity (3 adjacent bins) from current agent
        density (replaces the reference's in-loop adaptive doubling)."""
        locs = np.asarray(self.locations[: self.number_agents])
        coords = np.floor(locs / distance).astype(np.int64)
        if len(coords) == 0:
            return 8
        _, counts = np.unique(coords, axis=0, return_counts=True)
        return max(8, int(math.ceil(counts.max() * 3 * 1.25 / 8.0) * 8))

    def get_neighbors(self, graph_name: str, distance: float, clear: bool = True):
        """Fixed-radius neighbor search into a host edge list (the reference's
        ``get_neighbors``, ``simulation.py:225-288``).

        This is the *host API parity surface*: it materializes a dense
        (agents, window) candidate mask on the host per call, so it is
        intended for model-layer code at reference scales (<=100k agents).
        The fused engines never call it — their neighbor consumption stays
        on-device as windowed moments (``engine.py`` ``bio_moments``), which
        is what runs at 500k+."""
        graph: AgentGraph = self.__dict__[graph_name]
        n = self.number_agents
        graph.num_vertices = n

        run_cap = max(self._auto_run_cap(distance), graph.max_agents)
        graph.max_agents = run_cap
        spec = nbr_ops.GridSpec.from_box(tuple(self.size), float(distance), run_cap)

        locs = jnp.asarray(np.asarray(self.locations[:n]), dtype=jnp.float32)
        alive = jnp.ones((n,), dtype=bool)
        cand_idx, mask, max_run = _jitted_search(spec, float(distance))(locs, alive)
        assert int(max_run) <= run_cap

        rows, cols = np.nonzero(np.asarray(mask))
        partners = np.asarray(cand_idx)[rows, cols]
        keep = rows < partners  # store each undirected edge once
        edges = np.stack([rows[keep], partners[keep]], axis=1)
        graph.max_neighbors = max(graph.max_neighbors, int(np.max(
            np.bincount(rows, minlength=1))) if len(rows) else 1)

        if clear:
            graph.set_edges(edges)
        else:
            graph.add_edges(edges)
            graph.simplify()
        return graph

    # ------------------------------------------------------------------
    # outputs / lifecycle (simulation.py:290-494)
    # ------------------------------------------------------------------

    @record_time
    def temp(self):
        # pickle.dumps of a 500k-agent sim is ~1-2.5 s (the largest
        # synchronous output cost at scale — round-3 production run), so
        # serialization ALSO moves to the background worker. A shallow clone
        # pins this step's attribute bindings: the step loop REBINDS host
        # arrays (never mutates them in place) and the device state PyTree is
        # immutable, so the clone stays a consistent snapshot while the next
        # step executes. (Mutable cosmetic state shared with the clone —
        # e.g. the method-times dict — may be torn by one step in the
        # checkpoint; all simulation state is rebind-only.)
        clone = copy.copy(self)
        path = self.main_path + f"{self.name}_temp.pkl"

        def write():
            with open(path, "wb") as file:
                file.write(pickle.dumps(clone, -1))

        io_utils.submit_output(write)

    @record_time
    def step_values(self, arrays: Optional[List[str]] = None):
        if self.output_values:
            if arrays is None:
                arrays = self.agent_array_names
            check_direct(self.values_path)
            path = self.values_path + f"{self.name}_values_{self.current_step}.csv"
            # snapshot references (host arrays are rebound, never mutated in
            # place); CSV formatting + write run on the background worker
            snap = {
                name: self.__dict__[name][: self.number_agents]
                for name in arrays
            }
            io_utils.submit_output(
                lambda: io_utils.write_values_csv(
                    path,
                    {k: np.asarray(v) for k, v in snap.items()},
                    list(arrays),
                )
            )

    @record_time
    def step_image(self, background=(0, 0, 0), origin_bottom=True):
        if self.output_images:
            check_direct(self.images_path)
            n = self.number_agents
            colors = np.tile(np.array([[255, 50, 50]], dtype=np.uint8), (n, 1))
            image = io_utils.render_step_image(
                np.asarray(self.locations[:n]),
                np.asarray(self.radii[:n]),
                colors,
                tuple(self.size),
                self.image_quality,
                background=background,
                origin_bottom=origin_bottom,
            )
            file_name = f"{self.name}_image_{self.current_step}.png"
            io_utils.save_image_png(self.images_path + file_name, image)

    def data(self):
        file_name = f"{self.name}_data.csv"
        step_time = time.perf_counter() - self.step_start
        io_utils.append_data_csv(
            self.main_path + file_name,
            self.current_step,
            self.number_agents,
            step_time,
            io_utils.process_memory_mb(),
            self.method_times,
        )

    def create_video(self):
        io_utils.flush_outputs()  # async frames must exist before assembly
        out = io_utils.create_video_from_images(
            self.images_path,
            self.main_path + f"{self.name}_video.mp4",
            self.video_quality,
            self.fps,
            progress=cli.progress_bar,
        )
        if out:
            print("\nCreating video...")
        print("\n\nDone!\n")

    def info(self):
        self.step_start = time.perf_counter()
        print("Step: " + str(self.current_step))
        print("Number of agents: " + str(self.number_agents))

    def random_vector(self) -> np.ndarray:
        """Random vector on the unit circle/sphere (``simulation.py:473-486``)."""
        theta = self._np_rng.random() * 2 * math.pi
        if self.size[2] == 0:
            return np.array([math.cos(theta), math.sin(theta), 0])
        phi = self._np_rng.random() * 2 * math.pi
        radius = math.cos(phi)
        return np.array([radius * math.cos(theta), radius * math.sin(theta), math.sin(phi)])

    def record_initials(self):
        if self.current_step == 0:
            self.step_values()
            self.step_image()

    @classmethod
    def resume_from_npz(cls, name: str, output_dir: str) -> "Simulation":
        """Mode-1 fallback when no ``_temp.pkl`` exists. The base framework
        has only the pickle mechanism (reference parity); models with an npz
        state checkpoint (``CellSimulation``) override this."""
        raise FileNotFoundError(
            f"no {name}_temp.pkl found and {cls.__name__} has no npz resume "
            "path — was the run made with temp_pickle: false on a model "
            "without a state checkpoint?"
        )

    # pickling: drop anything device-side or unpicklable
    _unpicklable = ("_np_rng_state_placeholder",)

    def __copy__(self):
        """The ``temp()`` snapshot clone. Without this, ``copy.copy`` routes
        through ``__getstate__``/``__setstate__`` (written for the resume
        pickle), which re-uploads the state PyTree to the device and rebuilds
        the engine — synchronously, on the step loop — exactly the cost
        ``temp()`` exists to move off-loop. The clone shares bindings (the
        step loop REBINDS host arrays, never mutates them in place) with two
        exceptions, both mutated in place on the live object while the
        background worker still holds the clone:

        - the numpy RNG (every draw advances it) is snapshotted eagerly;
        - the engine reference is shallow-copied (capacity growth rebinds
          ``engine.cfg`` on the shared engine object, and the checkpoint
          must carry THIS step's config — window widths feed RNG draw
          shapes, so bit-exact resume depends on it).
        """
        cls = self.__class__
        clone = cls.__new__(cls)
        clone.__dict__.update(self.__dict__)
        clone._np_rng = pickle.loads(pickle.dumps(self._np_rng))
        eng = clone.__dict__.get("engine")
        if eng is not None:
            eng_clone = type(eng).__new__(type(eng))
            eng_clone.__dict__.update(eng.__dict__)
            clone.engine = eng_clone
        # method_times is mutated IN PLACE on the live object every
        # record_time call; pickling a shared dict on the background worker
        # while the step loop writes it can raise "dictionary changed size
        # during iteration" — snapshot it (the same rule as the RNG: copy
        # anything the live object mutates in place rather than rebinds)
        clone.method_times = dict(self.method_times)
        return clone

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_np_rng"] = pickle.dumps(self._np_rng)
        return state

    def __setstate__(self, state):
        rng = state.pop("_np_rng", None)
        self.__dict__.update(state)
        self._np_rng = pickle.loads(rng) if isinstance(rng, bytes) else np.random.default_rng()

    # ------------------------------------------------------------------
    # entry point (simulation.py:496-549)
    # ------------------------------------------------------------------

    @classmethod
    def start(cls, output_dir: Optional[str] = None, argv: Optional[list] = None):
        """Configure/run the model in one of four modes. Accepts the output
        directory as an argument (as ``run.py`` calls it) or falls back to
        ``paths.yaml`` (as the vendored framework does)."""
        if output_dir is None:
            output_dir = check_output_dir()
        elif not output_dir.endswith(os.path.sep):
            output_dir += os.path.sep
        os.makedirs(output_dir, exist_ok=True)

        name, mode = cli.get_name_mode(argv)

        if mode == 0:
            name = cli.check_new_sim(name, output_dir)
            sim = cls(name, output_dir)
            # snapshot the model code into the output dir (simulation.py:513)
            try:
                shutil.copytree(
                    os.getcwd(),
                    sim.main_path + name + "_copy",
                    ignore=shutil.ignore_patterns("__pycache__", ".git", "outputs"),
                )
            except Exception:
                pass
            sim.agent_initials()
            sim.steps()
            return sim

        name = cli.check_previous_sim(name, output_dir)
        if mode == 1:
            file_name = output_dir + name + os.sep + name + "_temp.pkl"
            if os.path.isfile(file_name):
                with open(file_name, "rb") as file:
                    sim = pickle.load(file)
            else:
                # runs with temp_pickle: false checkpoint only the npz state
                sim = cls.resume_from_npz(name, output_dir)
            sim.beginning_step = sim.current_step + 1
            sim.end_step = cli.get_final_step(argv)
            sim.steps()
            return sim
        elif mode == 2:
            sim = cls(name, output_dir)
            sim.create_video()
            return sim
        elif mode == 3:
            print('Compressing "' + name + '" simulation...')
            shutil.make_archive(output_dir + name, "zip", root_dir=output_dir, base_dir=name)
            print("Done!")
            return None
        else:
            raise Exception(f"Unknown mode: {mode}")
