"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without the devices: a forced 8-device
host (CPU) platform (see SURVEY.md §4e). The suite runs on the CPU unless
``JAX_PLATFORMS`` names platforms: the ``gpu``-marked tests need a card and
run with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
