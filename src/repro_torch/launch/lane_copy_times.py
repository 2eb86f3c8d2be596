"""A lane snapshot's host copy, with and without the reuse phase before it.

    PYTHONPATH=src python3 -m repro_torch.launch.lane_copy_times

Runs chip_smoke.py's lifecycle phase (chip_smoke.lifecycle_phase: its
bf16 lane-op times, lifecycle_times) in a fresh process three times:
alone, after chip_smoke's reuse phase (chip_smoke.reuse_phase, which
fills prefix tries with full-width host slabs and frees them), and
after the reuse phase again with glibc's heap trimming off and its mmap
threshold fixed (mallopt M_TRIM_THRESHOLD 1 GiB, M_MMAP_THRESHOLD
32 MiB, set before anything else runs). After the phases each run
copies a full-width bf16 lane row (serve.graphs.host_row_template, 36
layers, budget 512) three ways: into new numpy arrays (as extract
copies out of its staging buffer), into arrays touched before, and into
a new anonymous mapping (pages never touched). Prints each run's
extract times a lane (the device-to-host copy; within it the copy out
into new arrays, beside the copy into touched arrays), the three
copies, the reuse phase's capture lines and the card's name and power
limit, and exits non-zero if a run fails. Needs one CUDA card and the
repository's chip_smoke.py.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

# one run: the steps named in argv[1] ("mallopt", "reuse", then always
# the lifecycle phase), then the three copies; the last line is JSON
CHILD = """
import ctypes, json, mmap, sys
steps = sys.argv[1].split(",")
if "mallopt" in steps:
    libc = ctypes.CDLL("libc.so.6")
    assert libc.mallopt(-1, 1 << 30) == 1      # M_TRIM_THRESHOLD
    assert libc.mallopt(-3, 32 << 20) == 1     # M_MMAP_THRESHOLD
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.serve.graphs import host_row_template
build.library()
cs.log("card: " + cs.card_line())
with torch.no_grad():
    if "reuse" in steps:
        cs.reuse_phase(None)
    _, times = cs.lifecycle_phase()
row = host_row_template(get_config("trimkv-paper-4b"), 512)
leaves = [row["t"]] + [v for st in row["layers"] for v in st.values()]
nbytes = sum(a.nbytes for a in leaves)
held = [np.copy(a) for a in leaves]

def fresh_pages():
    buf = mmap.mmap(-1, nbytes)
    off = 0
    for a in leaves:
        dst = np.frombuffer(buf, a.dtype, a.size, off).reshape(a.shape)
        np.copyto(dst, a)
        off += a.nbytes
    del dst
    buf.close()

times["row_bytes"] = nbytes
times["new_arrays_ms"] = cs._median_ms(lambda: [np.copy(a) for a in leaves])
times["touched_ms"] = cs._median_ms(
    lambda: [np.copyto(b, a) for a, b in zip(leaves, held)])
times["fresh_pages_ms"] = cs._median_ms(fresh_pages)
print(json.dumps(times), flush=True)
"""

KEYS = ("d2h_ms", "copy_out_ms", "copy_into_ms", "new_arrays_ms",
        "touched_ms", "fresh_pages_ms", "h2d_install_ms", "row_bytes")


def run(steps: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, steps], cwd=ROOT,
        capture_output=True, text=True, timeout=1200,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    for line in proc.stdout.splitlines():
        if any(w in line for w in ("card:", "capture", "swap-out")):
            print(f"  [{steps}] {line}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{steps}: rc {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    rows = []
    for steps in ("lifecycle", "reuse", "mallopt,reuse"):
        times = run(steps)
        rows.append((steps, times))
        print(f"{steps}: " + ", ".join(f"{k} {times[k]}" for k in KEYS),
              flush=True)
    print(json.dumps([{"steps": s, **{k: t[k] for k in KEYS}}
                      for s, t in rows]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
