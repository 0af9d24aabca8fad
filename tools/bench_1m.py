"""1,000,000-cell capability run on one device: twice the reference's
claimed maximum scale ("500,000+ cells", its README), with the same
workload as ``bench.py`` (reference colony density, forces + diffusion +
fate). Prints set-up seconds, step times and peak device memory.

Usage: ``python tools/bench_1m.py [n_cells]``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main(n_cells=1_000_000):
    r = bench.time_full_model(n_cells, timed_steps=4)
    r.pop("state")
    r.pop("engine")
    print(json.dumps({"device": bench.device_info(), **r}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)
