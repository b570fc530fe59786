"""One smoke-size cell end to end on the CPU: the last line has the
contract's shape, the checks pass on a sound program, and the traced run
reports the per-layer metrics its spans and counters give."""
import pytest

from repro_torch.device import cap_test_threads

from bench.tests import jamba
from bench.tests.smoke import CELLS, run_cell

cap_test_threads()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(cell, monkeypatch):
    jamba.install(monkeypatch)
    rc, last, _, err = run_cell(cell, seed=2 ** 31 + 11)
    assert rc == 0 and last is not None
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert last["correct"] is True, err
    assert last["failed"] == 0 and last["attempted"] == 12
    names = set(last["metrics"])
    assert {"ttft_p50_s", "ttft_p90_s", "setup_s"} <= names
    assert ("quality_mean" in names) == cell.endswith("doc_reuse")
    for m in last["metrics"].values():
        assert m["value"] > 0
    # every number compared, beside its limit, ends standard error
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


def test_traced_run_reports_span_metrics():
    rc, last, out, _ = run_cell("olmoe-smoke.doc_reuse", trace=1)
    assert rc == 0 and last["correct"] is True
    names = set(last["metrics"])
    assert {"engine_self_ms", "hit_rate_dram", "decode_step_ms", "mfu"} <= names
    assert "ttft_p50_s" not in names
    # the CPU has no device trace: those metrics are left out, never 0
    assert "idle_share" not in names and "kivi_dequant_roofline" not in names
    assert '"ssd_written_bytes"' in out


@pytest.mark.parametrize("answers", [True, False])
def test_set_up_seeds_every_document(answers):
    """Set-up inserts every document through the controller and leaves
    the window's counters empty; it works out the uncompressed answers
    only for a cell that reports ``quality_mean``."""
    import torch

    from bench import rig as rig_lib
    from bench.tests.smoke import spec

    sp = spec()
    c = sp.cell("olmoe-smoke.doc_reuse")
    rig = rig_lib.build(sp.config(c), c["config"], sp.mix(c), sp.params(c),
                        4, 1.0, torch.device("cpu"))
    try:
        rig_lib.set_up(rig, answers=answers)
        docs = [ctx.key for ctx in rig.traffic.contexts]
        assert rig.controller.counters["inserts"] == len(docs)
        assert set(rig.seed_entries) == set(docs)
        pairs = {(ctx.key, q.tobytes()) for ctx in rig.traffic.contexts
                 for q in ctx.probes}
        assert set(rig.ref_answers) == (pairs if answers else set())
        cap = rig.capture
        assert cap.prefill_lens == [] and cap.decode_ctx == []
    finally:
        rig.close()


def test_a_new_reader_reads_the_programs_spans(tmp_path, monkeypatch):
    """A reader added as a file of its own reads the program's own spans
    and counters (``Run.program``) from a traced run; a run with
    ``--trace 0`` never turns the program's tracer on."""
    import json
    import shutil

    from repro_torch.runtime import trace

    from bench.spec import BENCH_DIR, Spec
    from bench.tests.smoke import DATA

    mdir = tmp_path / "metrics"
    shutil.copytree(BENCH_DIR / "metrics", mdir)
    (mdir / "model_step_ms.py").write_text(
        "def read(run):\n"
        "    if run.program is None:\n"
        "        return None\n"
        "    steps = [s.dur_s for s in run.program.spans\n"
        "             if s.name == 'model.step']\n"
        "    return 1e3 * sum(steps) / len(steps) if steps else None\n")
    bench = json.loads((DATA / "bench.json").read_text())
    bench["per_layer"].append({"name": "model_step_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "model", "moves": "ttft_p50_s",
                               "workloads": ["olmoe-smoke.doc_reuse"]})
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    sp = Spec(tmp_path / "bench.json", data_dir=DATA, root=DATA,
              metrics_dir=mdir)
    rc, last, _, err = run_cell("olmoe-smoke.doc_reuse", trace=1, sp=sp)
    assert rc == 0 and last["correct"] is True, err
    assert last["metrics"]["model_step_ms"]["value"] > 0
    assert not trace.ON

    def refuse():
        raise AssertionError("the program's tracer turned on")
    monkeypatch.setattr(trace, "enable", refuse)
    rc, last, _, err = run_cell("olmoe-smoke.doc_reuse", trace=0, sp=sp)
    assert rc == 0 and last["correct"] is True, err
