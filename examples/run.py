"""Entry point — equivalent of the reference's ``run.py``.

Run from this directory (so ``templates/`` and ``paths.yaml`` resolve):

    python run.py -n my_sim -m 0            # new simulation
    python run.py -n my_sim -m 1 -fs 300    # continue to step 300
    python run.py -n my_sim -m 2            # images -> video
    python run.py -n my_sim -m 3            # zip outputs
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hipsc_abm import CellSimulation

if __name__ == "__main__":
    CellSimulation.start(os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs"))
