"""The one-time knee sweep: a cell served at a few fixed rates.

    python3 bench/sweep.py --workload <cell> --rates 0.5,1,1.5,2 --seconds 30 [--seed n] [--out file]

For each rate the cell is built and set up anew and served for
``--seconds`` as ``run.py`` serves it (no trace, no reference check).
Per rate it prints the TTFT median and 90th percentile, the mean service
time (from the start of a request's call to its return), the server's
busy share and the mean wait for service (start minus due) in the first
and last thirds of the window. A backlog grows where the last third
waits more than the first by over two mean service times, or where the
server is busy over 90 % of the window; the knee is the highest rate at
which neither happens. The cell's rate (``cells/<cell>.json``) is set
once, by hand, at about a third of it: there a request's TTFT is mostly
its own service, and the queue does not multiply the host's drift into
the tail."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

_BENCH = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _BENCH]
for _p in (_BENCH.parent / "src", _BENCH.parent):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from bench import run as run_lib  # noqa: E402
from bench.metrics import percentile  # noqa: E402
from bench.spec import Spec  # noqa: E402


def summarize(rate: float, recs) -> dict:
    n = len(recs)
    service = [r["ret_s"] - r["start_s"] for r in recs]
    wait = [r["start_s"] - r["due_s"] for r in recs]
    third = max(1, n // 3)
    window = max(r["ret_s"] for r in recs)
    mean_s = sum(service) / n
    first, last = sum(wait[:third]) / third, sum(wait[-third:]) / third
    busy = sum(service) / window
    return {"rate_hz": rate, "requests": n,
            "failed": sum(not r["ok"] for r in recs),
            "ttft_p50_s": percentile([r["ttft_s"] for r in recs], 50),
            "ttft_p90_s": percentile([r["ttft_s"] for r in recs], 90),
            "service_mean_s": mean_s, "busy_share": busy,
            "wait_first_third_s": first, "wait_last_third_s": last,
            "sustained": busy <= 0.9 and last - first <= 2 * mean_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA device", file=sys.stderr)
        return 3
    spec = Spec()
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.set_num_threads(4)
    rows, per_rate = [], {}
    for rate in (float(r) for r in args.rates.split(",")):
        params = dict(spec.params(cell), rate_hz=rate)
        t0 = time.perf_counter()
        rig, _ = run_lib.prepare(spec, cell, args.seed, args.seconds, device,
                                 params)
        setup = time.perf_counter() - t0
        try:
            run = run_lib.serve(rig, False, setup, cell)
        finally:
            rig.close()
            del rig
            gc.collect()            # the rig's objects hold cycles
            torch.cuda.empty_cache()
        row = dict(summarize(rate, run.records), setup_s=setup)
        rows.append(row)
        per_rate[rate] = run.records
        print(json.dumps(row), flush=True)
    ok = [r["rate_hz"] for r in rows if r["sustained"]]
    print(json.dumps({"workload": args.workload, "knee_hz": max(ok) if ok
                      else None, "rates": rows}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "records": {
            str(k): v for k, v in per_rate.items()}}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
