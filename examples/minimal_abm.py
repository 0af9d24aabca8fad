"""A minimal custom agent-based model on the generic framework API.

Demonstrates that ``Simulation`` is a real framework (the pythonabm surface
the reference model layer builds on), not just the hiPSC model's plumbing:
register agents/arrays/graphs, query fixed-radius neighbors on the device grid
engine, and drive the standard lifecycle/outputs.

The model: random walkers that stop moving when crowded (>= 3 neighbors
within 20 um).

Run from this directory:  python minimal_abm.py -n walkers -m 0
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from hipsc_abm import Simulation
from hipsc_abm.utils.profiling import record_time


class RandomWalkers(Simulation):
    def agent_initials(self):
        self.add_agents(self.num_to_start)
        self.agent_array(
            "locations",
            override=self._np_rng.random((self.number_agents, 3)) * self.size,
        )
        self.agent_array("radii", func=lambda: 4.0)
        self.agent_array("stuck", dtype=int)
        self.agent_graph("crowd_graph")

    @record_time
    def move(self):
        self.get_neighbors("crowd_graph", 20.0)
        counts = np.array(
            [self.crowd_graph.num_neighbors(i) for i in range(self.number_agents)]
        )
        self.stuck = (counts >= 3).astype(int)
        free = self.stuck == 0
        steps = np.stack([self.random_vector() for _ in range(free.sum())]) * 5.0
        self.locations[free] = np.clip(self.locations[free] + steps, 0, self.size)

    def steps(self):
        if self.record_initial_step:
            self.record_initials()
        for self.current_step in range(self.beginning_step, self.end_step + 1):
            self.info()
            self.move()
            self.step_image()
            self.step_values()
            self.temp()
            self.data()
        self.create_video()


if __name__ == "__main__":
    RandomWalkers.start(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs")
    )
