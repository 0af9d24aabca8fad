"""Parameter dataclasses for the hiPSC model and the framework layer.

Mirrors the reference's three config surfaces:
- ``templates/general.yaml``  (reference ``simulation.py:52-62``)  -> GeneralParams
- ``templates/experimental.yaml`` (reference ``cell_simulation.py:19-27``) -> ExperimentalParams
- hardcoded biology constants (reference ``cell_simulation.py:34-57``) -> BiologyParams
- commented-out diffusion constants (reference ``cell_simulation.py:60-75``) -> DiffusionParams

All dataclasses are frozen/hashable so they can be closed over by jitted
functions as static configuration; changing a parameter triggers a single
recompile, which matches how the reference re-JITs Numba kernels on new
signatures.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GeneralParams:
    """Framework-level parameters, key-compatible with ``general.yaml``."""

    num_to_start: int = 5000
    cuda: bool = False  # accepted for template compatibility; the engine ignores it
    end_step: int = 192
    size: Tuple[float, float, float] = (2000.0, 2000.0, 0.0)
    output_values: bool = True
    output_images: bool = True
    record_initial_step: bool = True
    image_quality: int = 2000
    video_quality: int = 1000
    fps: float = 10.0

    @classmethod
    def from_dict(cls, keys: dict) -> "GeneralParams":
        return cls(
            num_to_start=int(keys["num_to_start"]),
            cuda=bool(keys["cuda"]),
            end_step=int(keys["end_step"]),
            size=tuple(float(v) for v in keys["size"]),
            output_values=bool(keys["output_values"]),
            output_images=bool(keys["output_images"]),
            record_initial_step=bool(keys["record_initial_step"]),
            image_quality=int(keys["image_quality"]),
            video_quality=int(keys["video_quality"]),
            fps=float(keys["fps"]),
        )

    @property
    def is_2d(self) -> bool:
        return self.size[2] == 0


@dataclasses.dataclass(frozen=True)
class ExperimentalParams:
    """Model-level parameters, key-compatible with ``experimental.yaml``."""

    num_gata6: int = 0
    output_tda: bool = True
    output_gradients: bool = True
    group: int = 0  # read but unused in the reference (vestigial); kept for parity
    dox_step: int = 49
    guye_move: bool = True
    lonely_thresh: int = 2
    color_mode: bool = True

    @classmethod
    def from_dict(cls, keys: dict) -> "ExperimentalParams":
        return cls(
            num_gata6=int(keys["num_gata6"]),
            output_tda=bool(keys["output_tda"]),
            output_gradients=bool(keys["output_gradients"]),
            group=int(keys["group"]),
            dox_step=int(keys["dox_step"]),
            guye_move=bool(keys["guye_move"]),
            lonely_thresh=int(keys["lonely_thresh"]),
            color_mode=bool(keys["color_mode"]),
        )


@dataclasses.dataclass(frozen=True)
class BiologyParams:
    """Hardcoded biology constants (reference ``cell_simulation.py:34-57`` and
    the force constants at ``cell_methods.py:252,347-349,392``)."""

    # temporal resolution
    step_dt: float = 1800.0  # seconds per simulation step
    move_dt: float = 180.0  # seconds per physics substep

    # finite dynamical system
    field: int = 2
    GATA6_prob: float = 0.01
    NANOG_prob: float = 0.01

    # rates in steps
    pluri_div_thresh: int = 36
    diff_div_thresh: int = 72
    pluri_to_diff: int = 36
    death_thresh: int = 144
    fds_thresh: int = 1

    # radii (um)
    max_radius: float = 5.0

    # crowd thresholds: contact inhibition of differentiated division
    # (cell_methods.py:78) and motility crowding (cell_methods.py:257)
    div_inhibit_neighbors: int = 6
    motility_crowd_neighbors: int = 6
    # diff_surround induction threshold (cell_methods.py:138)
    diff_surround_neighbors: int = 6

    # forces
    motility_force: float = 2e-9  # N (cell_methods.py:252)
    adhesion_const: float = 0.000107  # kg/s (cell_methods.py:347)
    poisson: float = 0.5  # (cell_methods.py:348)
    youngs: float = 1000.0  # Pa (cell_methods.py:349)
    stokes: float = 10000.0  # viscosity constant (cell_methods.py:392)
    jkr_break_d: float = -0.360562  # nondimensional bond-break overlap (cell_backend.py:39)

    # neighbor radius for the biology graph (cell_simulation.py:90)
    neighbor_radius: float = 15.0

    # replicate the reference's guye-movement branch exactly, including its
    # self-state test at cell_methods.py:287 (which makes GATA6-high cells
    # always move randomly under guye mode). Set False for the corrected rule.
    guye_bug_compat: bool = True

    @property
    def min_radius(self) -> float:
        # half the area of a max-radius cell in 2D (cell_simulation.py:55)
        return self.max_radius / math.sqrt(2.0)

    @property
    def pluri_growth(self) -> float:
        return (self.max_radius - self.min_radius) / self.pluri_div_thresh

    @property
    def diff_growth(self) -> float:
        return (self.max_radius - self.min_radius) / self.diff_div_thresh

    @property
    def jkr_radius(self) -> float:
        """Contact search radius: 2 * max_radius (cell_methods.py:401)."""
        return 2.0 * self.max_radius

    @property
    def jkr_break_band(self) -> float:
        """Width (um) of the separation band past touching in which an
        existing JKR bond still exerts force: |break_d| * overlap_scale for
        two max-radius cells. Bonded pairs farther apart than
        ``jkr_radius + jkr_break_band`` are guaranteed broken, which bounds
        the support of the whole force law (used to size contact windows)."""
        e_hat = 1.0 / (2.0 * (1.0 - self.poisson**2) / self.youngs)
        r_hat = self.max_radius / 2.0 / 1e6
        overlap_scale = ((math.pi * self.adhesion_const) / e_hat) ** (2.0 / 3.0) * r_hat ** (
            1.0 / 3.0
        )
        return -self.jkr_break_d * overlap_scale * 1e6


@dataclasses.dataclass(frozen=True)
class DiffusionParams:
    """Morphogen diffusion constants (reference ``cell_simulation.py:60-75``,
    commented out there; fully supported here and enabled via config).

    Units follow the reference's working set: space coordinates in um,
    ``spat_res`` in um, ``diffuse_const`` in um^2/s.
    """

    spat_res: float = 10.0  # um between diffusion points
    diffuse_dt: float = 6.0  # seconds per diffusion subcycle
    diffuse_const: float = 2.0  # um^2/s
    max_concentration: float = 2.0
    degradation: float = 0.1  # fraction degraded per simulation step
    # morphogen secreted per NANOG-high cell per step via the 4-point deposit
    # (the coupling the reference sketches in ``adjust_morphogens``,
    # ``cell_methods.py:485-521``); 0 disables release
    release_amount: float = 0.0
    # morphogen consumed per alive cell per step (uptake = negative deposit
    # through the same 4-point stencil; the lattice clamp at >= 0 bounds it)
    uptake_amount: float = 0.0
    # when True, perceived FGF4 in cell_pathway is sampled from the morphogen
    # field at the cell's nearest diffusion point (``get_concentration``
    # semantics, reference ``cell_methods.py:470-483``) instead of the
    # neighbor FGF4 mean — the gradient -> fate coupling of BASELINE config 2
    field_coupling: bool = False

    @property
    def spat_res2(self) -> float:
        return self.spat_res * self.spat_res

    def grid_size(self, size: Tuple[float, float, float]) -> Tuple[int, int]:
        """2D diffusion lattice dimensions: ceil(size/spat_res)+1
        (reference ``cell_simulation.py:69``)."""
        return (
            int(math.ceil(size[0] / self.spat_res)) + 1,
            int(math.ceil(size[1] / self.spat_res)) + 1,
        )

    def stability_limit(self) -> float:
        """FTCS stability bound dt <= h^2 / (4 D) for the 2D 5-point stencil."""
        return self.spat_res2 / (4.0 * self.diffuse_const)
