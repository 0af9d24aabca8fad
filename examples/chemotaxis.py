"""Chemotaxis: a second custom model on the generic framework + ops library.

Where ``minimal_abm.py`` exercises the host-side registration/lifecycle
surface, this model shows the intended pattern for PERFORMANT custom
models: keep the per-step compute in one jit-compiled device function
built from the reusable device ops (``ops.diffusion`` FTCS lattice +
``sample_concentration``/``deposit_morphogen``), and use the framework for
agents, outputs, and lifecycle.

The model: foragers in a dish with an attractant source at the center.
Each step the attractant diffuses (subcycled FTCS, reflecting walls), every
agent senses the field at ±h around itself (nearest-gridpoint samples, the
reference's ``get_concentration`` semantics), climbs the gradient with a
noisy step, and consumes attractant where it stands (negative 4-point
deposit). Agents log how much they have eaten.

Run from this directory:  python chemotaxis.py -n forage -m 0
"""

import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from hipsc_abm import Simulation
from hipsc_abm.ops import diffusion as diff_ops
from hipsc_abm.utils.profiling import record_time

SPAT_RES = 10.0  # um between lattice points
DIFFUSE_CONST = 25.0  # um^2/s
DIFFUSE_DT = 0.2  # s per FTCS subcycle (stable: dt < h^2/(4 D))
SUBCYCLES = 30
MAX_C = 5.0
DEGRADATION = 0.02  # fraction lost per step
SOURCE_AMOUNT = 40.0  # attractant added at the center per step
SPEED = 4.0  # um per step along the sensed gradient
NOISE = 1.0  # um of isotropic jitter per step
EAT_RATE = 0.25  # fraction of the local concentration consumed per step


@functools.partial(jax.jit, static_argnames=("nx", "ny"))
def chemotaxis_step(field, locs, key, box, nx: int, ny: int):
    """One fused device step: source -> diffuse -> sense -> move -> eat.

    Returns (field', locs', eaten, key'). Pure function of its inputs —
    the host loop only rebinds arrays and writes outputs.
    """
    field = field.at[nx // 2, ny // 2].add(SOURCE_AMOUNT)
    dts = jnp.full((SUBCYCLES,), DIFFUSE_DT, jnp.float32)
    field = diff_ops.ftcs_diffuse(
        field, dts, DIFFUSE_CONST, SPAT_RES * SPAT_RES, MAX_C, DEGRADATION
    )

    # finite-difference sense: nearest-gridpoint samples at ±h per axis
    def sample(offset):
        return diff_ops.sample_concentration(field, locs + offset, SPAT_RES)

    h = SPAT_RES
    gx = sample(jnp.array([h, 0.0, 0.0])) - sample(jnp.array([-h, 0.0, 0.0]))
    gy = sample(jnp.array([0.0, h, 0.0])) - sample(jnp.array([0.0, -h, 0.0]))
    grad = jnp.stack([gx, gy, jnp.zeros_like(gx)], axis=1)
    norm = jnp.linalg.norm(grad, axis=1, keepdims=True)
    direction = jnp.where(norm > 0.0, grad / jnp.where(norm > 0, norm, 1.0), 0.0)

    key, sub = jax.random.split(key)
    jitter = NOISE * jax.random.normal(sub, locs.shape, locs.dtype)
    jitter = jitter.at[:, 2].set(0.0)
    locs = jnp.clip(locs + SPEED * direction + jitter, 0.0, box)

    # consume: a negative 4-point deposit, clipped at zero by ftcs's clamp
    local = diff_ops.sample_concentration(field, locs, SPAT_RES)
    eaten = EAT_RATE * local
    field = diff_ops.deposit_morphogen(field, locs, -eaten, SPAT_RES)
    field = jnp.maximum(field, 0.0)
    return field, locs, eaten, key


class Chemotaxis(Simulation):
    def agent_initials(self):
        self.add_agents(self.num_to_start)
        self.agent_array(
            "locations",
            override=self._np_rng.random((self.number_agents, 3))
            * np.array([*self.size[:2], 0.0]),
        )
        self.agent_array("radii", func=lambda: 3.0)
        self.agent_array("food", dtype=float)

        nx = int(self.size[0] / SPAT_RES) + 1
        ny = int(self.size[1] / SPAT_RES) + 1
        self.attractant = jnp.zeros((nx, ny), jnp.float32)
        self._key = jax.random.PRNGKey(getattr(self, "seed", 0) or 0)
        self._box = jnp.asarray([self.size[0], self.size[1], 0.0], jnp.float32)

    @record_time
    def forage(self):
        nx, ny = self.attractant.shape
        field, locs, eaten, self._key = chemotaxis_step(
            self.attractant,
            jnp.asarray(self.locations, jnp.float32),
            self._key,
            self._box,
            nx=nx,
            ny=ny,
        )
        self.attractant = field
        self.locations = np.asarray(locs)
        self.food = self.food + np.asarray(eaten)

    def steps(self):
        if self.record_initial_step:
            self.record_initials()
        for self.current_step in range(self.beginning_step, self.end_step + 1):
            self.info()
            self.forage()
            self.step_image()
            self.step_values()
            self.temp()
            self.data()
        self.create_video()


if __name__ == "__main__":
    Chemotaxis.start(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs")
    )
