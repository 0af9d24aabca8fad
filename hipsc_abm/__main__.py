"""``python -m hipsc_abm -n <name> -m <mode>`` — CLI entry point.

Reads ``paths.yaml`` / ``templates/*.yaml`` from the current directory, like
the reference's ``run.py`` (modes: 0 new, 1 continue [-fs], 2 video, 3 zip).
"""

from hipsc_abm.models.hipsc import CellSimulation

if __name__ == "__main__":
    CellSimulation.start()
