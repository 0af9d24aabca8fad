"""Measure the ACTUAL reference (ajin40/Python-hiPSC-ABM at /root/reference)
end-to-end, reading its own ``<name>_data.csv`` instrumentation
(``simulation.py:392-419``) — the measured baseline of ``bench.py``.

numba/python-igraph are not installable here, so the five @jit kernels run
through speed-representative C++/OpenMP implementations and igraph through a
numpy adjacency shim (tools/reference_baseline/shims.py); everything else —
the serial Python biology loops, the per-substep get_neighbors/jkr pipeline,
the framework layer — is the reference's own code, executed unmodified from
/root/reference.

Usage: python tools/reference_baseline/measure_reference.py [n_cells] [steps]
Prints per-step wall times and the mean steps/sec.
"""

import csv
import importlib.util
import os
import shutil
import sys
import tempfile
import types

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

import shims  # noqa: E402

REF = "/root/reference/ABM"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reference():
    shims.install()
    sys.path.insert(0, REF)
    backend = _load("backend", os.path.join(REF, "backend.py"))
    simulation = _load("simulation", os.path.join(REF, "simulation.py"))
    # the model layer imports the framework as the external pythonabm package
    # (SURVEY.md "dual framework copies") — alias the vendored snapshot
    pythonabm = types.ModuleType("pythonabm")
    pythonabm.backend = backend
    pythonabm.simulation = simulation
    pythonabm.Simulation = simulation.Simulation
    sys.modules["pythonabm"] = pythonabm
    sys.modules["pythonabm.backend"] = backend
    sys.modules["pythonabm.simulation"] = simulation
    cell_simulation = _load(
        "cell_simulation", os.path.join(REF, "cell_simulation.py")
    )
    return cell_simulation


def run(n_cells=1000, steps=10, with_outputs=False):
    work = tempfile.mkdtemp(prefix="refbase_")
    tdir = os.path.join(work, "templates")
    os.makedirs(tdir)
    with open(os.path.join(tdir, "general.yaml"), "w") as f:
        side = 2000.0 * (n_cells / 5000.0) ** 0.5  # reference default density
        f.write(
            f"num_to_start: {n_cells}\ncuda: False\nend_step: {steps}\n"
            f"size: [{side}, {side}, 0]\noutput_values: {with_outputs}\n"
            f"output_images: {with_outputs}\nrecord_initial_step: False\n"
            "image_quality: 2000\nvideo_quality: 1000\nfps: 10\n"
        )
    with open(os.path.join(tdir, "experimental.yaml"), "w") as f:
        f.write(
            f"num_gata6: {n_cells // 10}\noutput_tda: {with_outputs}\n"
            "output_gradients: False\ngroup: 0\ndox_step: 5\nguye_move: True\n"
            "lonely_thresh: 2\ncolor_mode: True\n"
        )
    outdir = os.path.join(work, "out") + os.sep
    os.makedirs(os.path.join(outdir, "ref"))

    cwd = os.getcwd()
    os.chdir(work)  # templates_path is CWD-relative (simulation.py:22)
    try:
        cell_simulation = load_reference()
        sim = cell_simulation.CellSimulation("ref", outdir)
        sim.agent_initials()
        # disable the pickle checkpoint (temp) to time compute + CSV only?
        # No: temp() is part of the reference's per-step loop; keep it.
        sim.steps()
    finally:
        os.chdir(cwd)

    rows = []
    with open(os.path.join(outdir, "ref", "ref_data.csv")) as f:
        for row in csv.DictReader(f):
            rows.append((int(row["Step Number"]), int(row["Number Cells"]),
                         float(row["Step Time"])))
    shutil.rmtree(work, ignore_errors=True)
    return rows


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    rows = run(n, steps)
    for step, agents, t in rows:
        print(f"step {step:4d}  agents {agents:7d}  {t*1000:9.1f} ms")
    times = [t for _, _, t in rows[1:]] or [t for _, _, t in rows]
    mean = sum(times) / len(times)
    print(f"\nmean step time {mean*1000:.1f} ms -> {1.0/mean:.3f} steps/sec "
          f"(n={n}, no outputs)")
