"""An accelerator-resident agent-based-model framework for hiPSC colony
patterning, built from scratch on JAX / XLA.

Re-implements the full capability surface of the reference CPU/CUDA framework
(ajin40/Python-hiPSC-ABM: a vendored `pythonabm` Simulation engine plus the
hiPSC NANOG/GATA6 biology model) as a device-resident design:

- One fused, jit-compiled pure function ``step(state, params) -> state`` over a
  fixed-capacity struct-of-arrays state PyTree resident in device memory. No host
  round-trips inside a step.
- Dynamic agent populations (division / death — reference
  ``cell_methods.py:11-117``) become masked slot allocation over preallocated
  capacity instead of ``np.delete`` / ``np.concatenate``.
- The igraph neighbor graphs (reference ``backend.py:13-28``) become a sorted
  uniform grid with padded candidate windows; the JKR bond graph becomes a
  persistent padded partner matrix.
- CPU ``prange`` / CUDA kernels (reference ``backend.py``, ``cell_backend.py``)
  become vectorized XLA programs.
- Multi-chip scaling via ``jax.sharding.Mesh`` + ``shard_map`` (spatial
  domain decomposition with halo collectives) instead of host<->device
  memcpy.

The public API mirrors the reference so existing template configs run
unchanged: ``Simulation`` base class with ``start()`` modes 0-3,
``add_agents`` / ``agent_array`` / ``agent_graph`` registration, YAML templates
(``general.yaml`` / ``experimental.yaml`` / ``paths.yaml``) and the CSV / PNG /
video / TDA output formats.
"""

__version__ = "0.1.0"

from hipsc_abm.models.params import (
    BiologyParams,
    DiffusionParams,
    ExperimentalParams,
    GeneralParams,
)
from hipsc_abm.engine import EngineConfig, CellState, HipscEngine

def __getattr__(name):  # lazy: avoid importing I/O deps for compute-only use
    if name == "Simulation":
        from hipsc_abm.simulation import Simulation
        return Simulation
    if name == "CellSimulation":
        from hipsc_abm.models.hipsc import CellSimulation
        return CellSimulation
    if name == "EnsembleEngine":
        from hipsc_abm.parallel.ensemble import EnsembleEngine
        return EnsembleEngine
    if name == "Calibrator":
        from hipsc_abm.calibrate import Calibrator
        return Calibrator
    raise AttributeError(name)

__all__ = [
    "BiologyParams",
    "DiffusionParams",
    "ExperimentalParams",
    "GeneralParams",
    "EngineConfig",
    "CellState",
    "HipscEngine",
    "Simulation",
    "CellSimulation",
    "EnsembleEngine",
    "Calibrator",
]
