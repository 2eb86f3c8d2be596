"""Kernel times of two trees of the repository, in turns on one card.

    PYTHONPATH=src python3 -m repro_torch.launch.kernel_turns PARENT CHANGE

PARENT and CHANGE are roots of two checkouts (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory, and
this one). Each run imports that tree's chip_smoke.py in a fresh
process, builds the tree's kernels and runs its kernel phases (decode,
chunk, retention, capacity: every case held against the plain
versions, then the main-path timings; and, where the tree has it, the
hybrid kernel phase: the head-dim-256 variants and the RG-LRU scan), in
the order parent, change,
change, parent. Prints each run's kernel times and, per kernel, the
change's mean over the parent's mean; exits non-zero if a run fails.
Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path


# run in each tree's own interpreter with that tree's src on the path,
# so that the parent needs no copy of this script: import its
# chip_smoke, build its kernels, run its kernel phases and print
# {name: ms} as the last line
CHILD = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.kernels import build
build.library()
g = torch.Generator(device="cuda")
g.manual_seed(0)
with torch.no_grad():
    entries = [cs.decode_phase(g), *cs.chunk_phase(g), *cs.retention_phase(g)]
entries += cs.capacity_phase(g)
if hasattr(cs, "hybrid_kernel_phase"):
    with torch.no_grad():
        entries += cs.hybrid_kernel_phase(g)
print(json.dumps({e["name"]: e["ms"] for e in entries}), flush=True)
"""


def run(root: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(root)], cwd=root,
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: rc {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(parent: Path, change: Path) -> int:
    runs = []
    for label, root in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        ms = run(root)
        runs.append((label, ms))
        print(f"{label} ({root}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    names = [k for k in runs[1][1] if k in runs[0][1]]
    print("kernel: parent ms, change ms (mean of two runs each), change / "
          "parent")
    for k in names:
        p = sum(ms[k] for label, ms in runs if label == "parent") / 2
        c = sum(ms[k] for label, ms in runs if label == "change") / 2
        print(f"  {k:<26} {p:.4f} {c:.4f} {c / p:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve()))
