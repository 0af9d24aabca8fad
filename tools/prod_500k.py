"""500k end-to-end production run with FULL outputs (BASELINE.json config 5).

Runs the complete mode-0 lifecycle at 500,000 starting cells — value CSVs,
step PNGs, TDA splits, npz + pickle checkpoints, data CSV — through the
async output pipeline, then mode 2 (video assembly). Records wall clock and
the device-vs-output split in a summary printed at the end.

Usage: python tools/prod_500k.py [steps] [cells]
"""
import csv
import os
import shutil
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

STEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 12
CELLS = int(sys.argv[2]) if len(sys.argv) > 2 else 500_000
# HIPSC_TEMP_PICKLE=0 drops the per-step pickle (npz mode-1 resume instead)
TEMP_PICKLE = os.environ.get("HIPSC_TEMP_PICKLE", "1") != "0"
# HIPSC_OUTPUT_INTERVAL=k runs device-resident k-step blocks between outputs
OUTPUT_INTERVAL = int(os.environ.get("HIPSC_OUTPUT_INTERVAL", "1"))
ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    ".chip_smoke", "prod500k")
NAME = "p500"


def write_templates():
    side = round(2000.0 * (CELLS / 5000.0) ** 0.5, 1)
    os.makedirs(f"{ROOT}/templates", exist_ok=True)
    os.makedirs(f"{ROOT}/outputs", exist_ok=True)
    with open(f"{ROOT}/templates/general.yaml", "w") as f:
        f.write(f"""num_to_start: {CELLS}
cuda: false
end_step: {STEPS}
size: [{side}, {side}, 0]
output_values: true
output_images: true
record_initial_step: true
image_quality: 2000
video_quality: 1500
fps: 6
temp_pickle: {str(TEMP_PICKLE).lower()}
output_interval: {OUTPUT_INTERVAL}
""")
    with open(f"{ROOT}/templates/experimental.yaml", "w") as f:
        f.write(f"""num_gata6: {CELLS // 10}
output_tda: true
output_gradients: false
group: 0
dox_step: 4
guye_move: true
lonely_thresh: 6
color_mode: true
""")


def main():
    if os.path.isdir(f"{ROOT}/outputs/{NAME}"):
        shutil.rmtree(f"{ROOT}/outputs/{NAME}")
    write_templates()
    os.chdir(ROOT)
    from hipsc_abm.models.hipsc import CellSimulation

    t0 = time.perf_counter()
    sim = CellSimulation.start(f"{ROOT}/outputs/", argv=["-n", NAME, "-m", "0"])
    wall = time.perf_counter() - t0
    print(f"\nmode 0 wall: {wall:.1f} s for {STEPS} steps "
          f"({sim.number_agents} agents at end)")

    t1 = time.perf_counter()
    CellSimulation.start(f"{ROOT}/outputs/", argv=["-n", NAME, "-m", "2"])
    print(f"mode 2 (video) wall: {time.perf_counter() - t1:.1f} s")

    # per-step breakdown from the run's own data CSV
    with open(f"{ROOT}/outputs/{NAME}/{NAME}_data.csv") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        parts = {k: float(v) for k, v in r.items()
                 if k not in ("Step Number", "Number Cells", "Step Time",
                              "Memory (MB)") and v}
        top = sorted(parts.items(), key=lambda kv: -kv[1])[:4]
        print(f"step {r['Step Number']:>3} agents {r['Number Cells']:>7} "
              f"total {float(r['Step Time']):6.2f}s  "
              + "  ".join(f"{k}={v:.2f}" for k, v in top))
    out_dir = f"{ROOT}/outputs/{NAME}"
    for entry in sorted(os.listdir(out_dir)):
        p = os.path.join(out_dir, entry)
        sz = (sum(os.path.getsize(os.path.join(p, x)) for x in os.listdir(p))
              if os.path.isdir(p) else os.path.getsize(p))
        print(f"{entry:24s} {sz/1e6:10.1f} MB")


if __name__ == "__main__":
    main()
