"""3D spheroid: the flagship hiPSC model in a 3D box, driven via the engine API.

The reference treats 3D as first-class (``size`` with z != 0 switches its
kernels to the 3x3x3 bin stencil, ``backend.py:84-93``) but never ships a 3D
experiment. This example runs the COMPLETE hiPSC model — radius-15 neighbor
search, division/death, FDS pathway + differentiation, motility, 11 JKR +
Stokes physics substeps — in 3D (9-run stencil kernels), seeded as an
over-packed ball that the contact mechanics relax outward while dox-induced
differentiation patterns the core.

Where ``minimal_abm.py`` shows the host-side framework surface and
``chemotaxis.py`` a custom fused device step, this shows the third entry
level from ``docs/API.md``: driving ``HipscEngine`` directly (pure state ->
state steps, overflow-safe via ``safe_step``) with host output only where
you ask for it — here, orthogonal x-y / x-z projections of the colony.

Run from this directory:  python spheroid_3d.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from hipsc_abm import ExperimentalParams, GeneralParams, HipscEngine
from hipsc_abm.utils.io import hipsc_cell_colors, render_step_image, save_image_png

BOX = 600.0  # um, cubic
BALL_RADIUS = 110.0  # seeding ball: over-packed so JKR relaxes it outward


def seed_ball(n: int, rng: np.random.Generator) -> np.ndarray:
    """n uniform points inside a ball of BALL_RADIUS at the box center."""
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    r = BALL_RADIUS * rng.random(n) ** (1.0 / 3.0)
    return (BOX / 2.0 + direction * r[:, None]).astype(np.float32)


def run(n_cells: int = 3000, n_gata6: int = 300, steps: int = 12,
        out_dir: str | None = None, seed: int = 0):
    """Run the 3D spheroid; returns (engine, final state, stats dict)."""
    gen = GeneralParams(num_to_start=n_cells, end_step=steps,
                        size=(BOX, BOX, BOX))
    xp = ExperimentalParams(num_gata6=n_gata6, dox_step=2, guye_move=False)
    eng = HipscEngine(gen, xp)
    rng = np.random.default_rng(seed)
    state = eng.init_state(seed=seed, locations=seed_ball(n_cells + n_gata6, rng))

    for _ in range(steps):
        state, info = eng.safe_step(state)

    host = {k: np.asarray(v) for k, v in state.arrays.items()}
    alive = np.asarray(state.alive)
    loc = host["locations"][alive]
    centered = loc - BOX / 2.0
    stats = {
        "population": int(alive.sum()),
        "differentiated": int(host["states"][alive].sum()),
        "mean_radius_um": float(np.linalg.norm(centered, axis=1).mean()),
        "z_extent_um": float(np.abs(centered[:, 2]).max()),
    }

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        colors = hipsc_cell_colors(host["states"][alive], host["GATA6"][alive],
                                   host["NANOG"][alive], field=2, color_mode=True)
        radii = host["radii"][alive]
        for name, cols in (("xy", (0, 1)), ("xz", (0, 2))):
            proj = loc[:, [cols[0], cols[1]]]
            img = render_step_image(proj, radii, colors, (BOX, BOX, 0.0),
                                    image_quality=800)
            save_image_png(os.path.join(out_dir, f"spheroid_{name}.png"), img)
    return eng, state, stats


if __name__ == "__main__":
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs_3d")
    _, _, stats = run(out_dir=out)
    print("3D spheroid after 12 steps:", stats)
    print(f"projections written to {out}/spheroid_{{xy,xz}}.png")
