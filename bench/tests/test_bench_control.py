"""The control at smoke size: the reference on float8 operands, and KIVI
worked out in bfloat16, read as a program would be; each fails the
cell's limits where the sound program passes them."""
import json
import time

import pytest
import torch

from repro_torch.device import cap_test_threads

from bench import run as run_lib
from bench.tests import jamba
from bench.tests.smoke import CELLS, run_cell, spec

cap_test_threads()


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell, monkeypatch):
    jamba.install(monkeypatch)
    sp = spec()
    c = sp.cell(cell)
    rig, params = run_lib.prepare(sp, c, 5, 1.0, torch.device("cpu"))
    try:
        run = run_lib.serve(rig, False, time.perf_counter(), c)
        nums = run_lib.judge(rig, run, params, control=True)
    finally:
        rig.close()
    limits = params["limits"]
    assert all(nums[k] <= lim for k, lim in limits.items()), nums
    assert nums["control_prefill_err"] > limits["prefill_err"]
    assert nums["control_served_gap"] > limits["served_gap"]
    assert nums["control_logit_err_med"] > limits["logit_err_med"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_run_reports_not_correct(cell, monkeypatch):
    """``run.py --control 1`` judges the control by the run's own
    comparison and limits: its line says not correct, and every number
    compared is the control's."""
    jamba.install(monkeypatch)
    rc, last, out, err = run_cell(cell, seed=6, extra=("--control", "1"))
    assert rc == 0 and last is not None
    assert last["correct"] is False, err
    assert last["failed"] == 0
    assert any(c["value"] > c["limit"] for c in last["checks"].values())
    readings = next(json.loads(line.split(" ", 1)[1])
                    for line in out.splitlines()
                    if line.startswith("readings "))
    for k, c in last["checks"].items():
        assert c["value"] == readings["control_" + k]
