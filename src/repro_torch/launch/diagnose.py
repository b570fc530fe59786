"""Collective breakdown of one dry-run cell: the top collectives by
weighted bytes, each with where in the port's code it was issued, so each
hypothesis about the collective term targets a named op.

Counterpart of ``repro.launch.diagnose``. The reference ranks the HLO's
collectives by trip-weighted bytes with their ``op_name``; the port runs
the cell once under ``launch.step_cost``'s counter (a fake group of 256
or 512 ranks, meta shards, as ``launch.dryrun`` does) and groups the
collectives it counted by kind, shape and the innermost frames of the
port's code that issued them (the model is functions, not modules, so
the frames take the place of a module path). The rows of all groups sum
to the cell's ``collective_bytes``.

    PYTHONPATH=src python -m repro_torch.launch.diagnose --arch X \
        --shape Y [--multi-pod] [-n 12]
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import ICI_BW, make_production_mesh
from repro_torch.launch.step_cost import StepCost

Row = Tuple[float, str, str, int, str]   # bytes, kind, shape, count, where


def collective_breakdown(cost: StepCost, top: int = 12
                         ) -> Tuple[List[Row], float]:
    """(the ``top`` rows by weighted bytes, the sum over all rows)."""
    groups = {}
    for c in cost.collectives:
        key = (c["kind"], f"{c['dtype']}{c['shape']}", c["where"])
        b, n = groups.get(key, (0.0, 0))
        groups[key] = (b + c["bytes"], n + 1)
    rows = sorted(((b, kind, shape, n, where) for (kind, shape, where),
                   (b, n) in groups.items()), reverse=True)
    return rows[:top], sum(r[0] for r in rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("-n", type=int, default=12)
    args = ap.parse_args(argv)
    dr.quiet()
    dr.init_fake_world(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    cost, *_ = dr.count_cell(args.arch, args.shape, mesh)
    rows, total = collective_breakdown(cost, args.n)
    print(f"total collective bytes/chip: {total:.3e} "
          f"(~{total / ICI_BW * 1e3:.1f} ms at {ICI_BW / 1e9:.0f} GB/s)")
    for b, kind, shape, n, where in rows:
        print(f"  {b:.3e} {kind:18s} x{n:5d} {shape[:48]:48s} {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
