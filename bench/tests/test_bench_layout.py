"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and entries, and edits no file that is
there: the harness finds each by its name."""
import json
import shutil

from repro_torch.device import cap_test_threads

from bench.spec import BENCH_DIR
from bench.tests.smoke import DATA, run_cell, spec

cap_test_threads()


def test_new_files_are_found_by_name(tmp_path):
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    mdir = tmp_path / "metrics"
    shutil.copytree(BENCH_DIR / "metrics", mdir)
    before = {p: p.read_bytes() for p in list(data.rglob("*")) if p.is_file()}
    before.update({p: p.read_bytes() for p in mdir.rglob("*.py")})
    # the new files
    hf = json.loads((data / "configs" / "olmoe-smoke.json").read_text())
    hf["num_experts"], hf["num_hidden_layers"] = 4, 1
    (data / "configs" / "olmoe-tiny.json").write_text(json.dumps(hf))
    mix = json.loads((data / "traffic" / "doc_reuse.json").read_text())
    mix["doc_lengths"] = [48, 40, 56]
    (data / "traffic" / "three_docs.json").write_text(json.dumps(mix))
    cell = "olmoe-tiny.three_docs"
    (data / "cells" / f"{cell}.json").write_text(json.dumps(
        {"rate_hz": 10.0, "check_requests": 4, "check_docs": 2,
         "limits": {"served_gap": 1e-3, "prefill_err": 1e-4,
                    "stored_mismatch": 0}}))
    (mdir / "requests_served.py").write_text(
        "def read(run):\n    return float(sum(r['ok'] for r in run.records))\n")
    # and new entries in BENCHMARK.json
    bench = json.loads((data / "bench.json").read_text())
    bench["configs"].append({"name": "olmoe-tiny", "source": "test",
                             "file": "configs/olmoe-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "olmoe-tiny",
                               "traffic": "three_docs", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][2]["workloads"].append(cell)
    bench["per_layer"].append({"name": "requests_served", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "ttft_p50_s",
                               "workloads": [cell]})
    (data / "bench.json").write_text(json.dumps(bench))

    sp = spec(data, mdir)
    rc, last, _, err = run_cell(cell, trace=1, sp=sp)
    assert rc == 0 and last["correct"] is True, err
    assert last["metrics"]["requests_served"]["value"] == 10.0
    rc, last, _, _ = run_cell(cell, trace=0, sp=sp)
    assert {"ttft_p50_s", "quality_mean", "setup_s"} <= set(last["metrics"])
    changed = [p for p, b in before.items() if p.name != "bench.json"
               and p.read_bytes() != b]
    assert changed == []
