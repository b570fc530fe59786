#!/usr/bin/env python3
"""Time forms of a kernel against each other in one call on the card.

    python3 chip_forms.py flash|scan_bwd TREE [TREE ...]

Each TREE is the root of a copy of the repository, for example the parent
commit unpacked with ``git archive`` into the gitignored ``.checkout/``
and copies that differ in a few lines. The trees run in the order given,
each in a fresh process, through that tree's own ``chip_smoke.py`` phase
(``phase_flash_attention`` or ``phase_selective_scan_bwd``), which builds
the tree's kernel, holds it to the plain version with the tree's own
checks and times it. Give the trees in turns, parent, change, change,
parent, so that drift on the card falls on both sides. Prints one JSON
line a tree: each row's device ms, or where the tree's phase failed, its
exit code and the end of its output. Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys

PHASES = {"flash": ("prefill_attn", "phase_flash_attention"),
          "scan_bwd": ("mamba_scan", "phase_selective_scan_bwd")}

# the phase's arguments are the kernel package's modules of the same names;
# TF32 is off, as chip_smoke.py's main sets it
CHILD = """
import importlib, inspect, json, sys
tree, package, phase = sys.argv[1:]
sys.path[:0] = [tree + "/src", tree]
import chip_smoke, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
fn = getattr(chip_smoke, phase)
rows, worst = fn(*(importlib.import_module(f"repro_torch.kernels.{package}.{m}")
                   for m in inspect.signature(fn).parameters))
print(json.dumps({"max_abs_err": worst, "rows": [
    {"form": r.get("dtype", r.get("shape")), "ms": r["ms"]} for r in rows]}))
"""


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[1] not in PHASES:
        sys.exit(__doc__)
    package, phase = PHASES[sys.argv[1]]
    failed = 0
    for tree in sys.argv[2:]:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, tree, package, phase],
            capture_output=True, text=True)
        if proc.returncode:
            failed += 1
            out = {"rc": proc.returncode,
                   "tail": (proc.stdout + proc.stderr)[-2000:]}
        else:
            out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, **out}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
