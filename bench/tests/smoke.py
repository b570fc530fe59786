"""Smoke-size cells for the CPU tests: f32 OLMoE and DeepSeek-V2 shapes a
few layers deep, and one period of Jamba's hybrid (``data/``; its adapter
is test-local, ``jamba.py``), run by ``bench.run.main`` with the chip
check skipped."""
from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import torch

from bench.spec import BENCH_DIR, Spec

DATA = Path(__file__).resolve().parent / "data"
CELLS = ["olmoe-smoke.doc_reuse", "deepseek-smoke.doc_reuse",
         "jamba-smoke.doc_reuse"]


def spec(data: Path = DATA, metrics_dir: Path = BENCH_DIR / "metrics") -> Spec:
    return Spec(data / "bench.json", data_dir=data, root=data,
                metrics_dir=metrics_dir)


def run_cell(cell: str, seed: int = 3, trace: int = 0, seconds: float = 1.0,
             sp: Spec = None, extra: tuple = ()):
    """(exit code, the last stdout line as JSON or None, stdout, stderr).
    The module check is left to ``test_bench_modules``, which runs a cell
    in a process of its own."""
    from bench import run
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace), *extra],
                      device=torch.device("cpu"), spec=sp or spec(),
                      forbid=False)
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return rc, last, out.getvalue(), err.getvalue()
