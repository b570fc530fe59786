"""``tools/trace_cell.py`` on a smoke-size benchmark cell on the CPU: the
traced run with the port's tracer on reads the program's four per-layer
numbers and names the profile's gaps by its spans; a benchmark run never
turns the tracer on itself."""
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from bench.tests.smoke import run_cell, spec
from repro_torch.device import cap_test_threads
from repro_torch.runtime import trace
from tools import trace_cell

cap_test_threads()


@pytest.mark.parametrize("cell", ["olmoe-smoke.doc_reuse",
                                  "deepseek-smoke.doc_reuse"])
def test_traced_cell_reads_the_program(cell):
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = trace_cell.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                              "--seconds", "1"],
                             device=torch.device("cpu"), spec=spec(),
                             forbid=False)
    assert rc == 0 and not trace.ON
    lines = out.getvalue().strip().splitlines()
    prog = json.loads(lines[-1].removeprefix("program "))
    bench_line = json.loads(lines[-2])
    assert bench_line["correct"] is True
    for k in ("fetch_rescore_ms", "lane_write_ms", "h2d_mb"):
        assert prog[k] is not None and prog[k] > 0, k
    assert 0 < prog["fetch_covered"] <= 1
    # a hit-only window: every step's MoE stays on the device, and each
    # step makes one read (its tokens), which the CPU steps eagerly
    assert prog["moe_host_read_ms"] == 0.0
    c = prog["counters"]
    assert c["host_reads"] == c["decode.eager_steps"] > 0
    assert prog["wall_first_token_p50_s"] > 0
    assert prog["requests"] > 0


def test_a_benchmark_run_leaves_the_tracer_off():
    trace.take()
    for traced in (0, 1):
        rc, last, _, _ = run_cell("olmoe-smoke.doc_reuse", trace=traced)
        assert rc == 0 and last["correct"] is True
        assert not trace.ON and trace.take().spans == []
        if not traced:
            assert set(last) == {"correct", "attempted", "failed", "metrics",
                                 "device", "checks"}
