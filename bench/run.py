"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's system from the seed (weights, documents, requests),
seeds and warms it (set-up), then offers the requests open-loop at their
due times for ``--seconds`` and serves every request due in the window to
completion, one at a time through ``ServingEngine.process``. TTFT is the
wall clock from a request's due time to the return of its call, which
ends at its first answer token (every request asks for one). The last
line of standard output is one JSON object; with ``--trace 1`` it holds
the per-layer metrics instead of the end-to-end ones, and the window
runs with the program's own tracer on (``repro_torch.runtime.trace``),
its spans and counters kept on ``Run.program`` for the readers. After
the window the plain reference judges what the program served
(``correct``).

``--control 1`` judges the control in the program's place by the same
limits (the reference on float8 operands, KIVI worked out in bfloat16;
``bench/reference/check.py``): a run that has to come out not correct.
The benchmark's own runs never pass it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

_BENCH = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _BENCH]
for _p in (_BENCH.parent / "src", _BENCH.parent):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from bench import rig as rig_lib  # noqa: E402
from bench.metrics import percentile  # noqa: E402
from bench.reference.check import run_checks  # noqa: E402
from bench.spec import Spec  # noqa: E402
from bench.tracing import Spans, reduce_profile  # noqa: E402
from repro_torch.runtime import trace as program_trace  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SPAN_NAMES = ["engine.process", "controller.fetch", "controller.insert",
              "storage.get", "storage.put", "compression.compress",
              "compression.decompress", "runner.prefill", "model.decode_step"]


@dataclasses.dataclass
class Run:
    cell: Dict
    hf: Dict
    mix: Dict
    records: List[Dict]
    setup_s: float
    window_s: float
    capture: Any
    spans: List = dataclasses.field(default_factory=list)
    span_reqs: set = dataclasses.field(default_factory=set)
    profile: Optional[Dict] = None
    profiled_reqs: set = dataclasses.field(default_factory=set)
    # the program's spans and counters of the window
    # (``repro_torch.runtime.trace.Records``): with --trace 1 only, and
    # None where the caller ran the program's tracer itself
    program: Any = None

    def ttfts(self) -> List[float]:
        """Every request due in the window; a failed one never answered."""
        return [r["ttft_s"] if r["ok"] else float("inf") for r in self.records]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def install_spans(rig: rig_lib.Rig, spans: Spans) -> None:
    ctrl = rig.controller
    spans.wrap(rig.engine, "process", "engine.process")
    spans.wrap(ctrl, "fetch", "controller.fetch")
    spans.wrap(ctrl, "insert", "controller.insert")
    for tier in ctrl.tiers.values():
        spans.wrap(tier, "get", "storage.get")
        spans.wrap(tier, "put", "storage.put")
    for m in ctrl.methods.values():
        spans.wrap(m, "compress", "compression.compress")
        spans.wrap(m, "decompress", "compression.decompress")
    spans.wrap(rig.runner, "prefill_entry", "runner.prefill",
               attrs=lambda out, toks: {"tokens": len(toks)})
    spans.wrap(rig.runner.model, "decode_step", "model.decode_step")


def serve(rig: rig_lib.Rig, trace: bool, setup_s: float, cell: Dict
          ) -> Run:
    """The measured window: requests at their due times, one in service
    at a time, every one served to completion."""
    from bench.reference.quality import score

    reqs, due = rig.traffic.requests, rig.traffic.due_s
    cap, dev = rig.capture, rig.device
    spans = Spans(sync=trace)
    n = len(reqs)
    prof_lo, prof_hi = n, n
    if trace:
        install_spans(rig, spans)
        prof_lo = int(n * 0.4)
        prof_hi = min(n, prof_lo + max(8, n // 6))
    prof, program = None, None
    records: List[Dict] = []
    # the program's tracer over the window, unless a caller runs it
    own_trace = trace and not program_trace.ON
    if own_trace:
        program_trace.enable()
    try:
        t0 = time.perf_counter()
        for i, req in enumerate(reqs):
            if i == prof_lo and trace:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            cap.req, cap.req_key, spans.req = i, req.context_key, i
            start = time.perf_counter()
            rec = {"due_s": float(due[i]), "start_s": start - t0,
                   "ok": False, "answer": [], "hit_tier": None,
                   "method": None, "error": None}
            try:
                out = rig.engine.process([req], skip_quality=True)
                res = out[0] if out else None
                if res is not None and res.answer:
                    rec.update(ok=True, answer=list(res.answer),
                               hit_tier=res.hit_tier, method=res.method,
                               rate=res.rate)
            except Exception as e:  # a failed request misses every limit
                rec["error"] = f"{type(e).__name__}: {e}"
            ret = time.perf_counter()
            rec["ret_s"] = ret - t0
            rec["ttft_s"] = ret - (t0 + due[i])
            records.append(rec)
            if prof is not None and i == prof_hi - 1:
                prof.__exit__(None, None, None)
    finally:
        if own_trace:
            program = program_trace.take()
            program_trace.disable()
    cap.req = cap.req_key = spans.req = None
    window_s = records[-1]["ret_s"] if records else 0.0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for i, (req, rec) in enumerate(zip(reqs, records)):
        ref = rig.ref_answers.get((req.context_key, req.question.tobytes()))
        if ref is None:
            rec["quality"] = None
        else:
            rec["quality"] = score(req.task_type, rec["answer"], ref) \
                if rec["ok"] else 0.0
    run = Run(cell, rig.hf, rig.traffic.mix, records, setup_s, window_s, cap,
              spans.spans,
              set(range(n)) - set(range(prof_lo, prof_hi)), program=program)
    if prof is not None:
        path = rig.ssd_root + ".trace.json"
        prof.export_chrome_trace(path)
        run.profile = reduce_profile(path, SPAN_NAMES
                                     + list(program_trace.SPANS))
        run.profiled_reqs = set(range(prof_lo, prof_hi))
        os.remove(path)
    return run


def checked_inputs(rig: rig_lib.Rig, run: Run, n_docs: int):
    """The checked requests and documents, as the reference takes them."""
    cap, reqs = rig.capture, rig.traffic.requests
    ctx = {c.key: c for c in rig.traffic.contexts}

    def state(e):
        return None if e is None else (e.method, e.arrays, e.meta)

    checked, docs = [], {}
    for i in sorted(cap.sampled):
        rec, r, req = run.records[i], cap.per_req.get(i, {}), reqs[i]
        if not rec["ok"]:
            continue
        logits = r.get("logits")
        c = {"req": i, "doc": req.context_key, "question": req.question,
             "served": rec["answer"][0], "stored": None,
             "logits": None if logits is None
             else logits[0, -1].float().cpu().numpy()}
        if rec["hit_tier"] is not None:
            c.update(stored=state(r.get("stored")), put=state(r.get("given")),
                     put_input=r.get("given_input"))
        else:
            c.update(put=state(r.get("put")), put_input=r.get("put_input"))
        checked.append(c)
        docs.setdefault(req.context_key, {"tokens": ctx[req.context_key].tokens,
                                          "entry": None})
    # the program's own uncompressed prefill of some documents: the
    # seeding prefill, or a miss's (what its insert compressed)
    longest = sorted(docs, key=lambda k: -len(docs[k]["tokens"]))
    for key in longest[:n_docs]:
        entry = rig.seed_entries.get(key)
        if entry is None:
            entry = next((c["put_input"] for c in checked
                          if c["doc"] == key and c["stored"] is None
                          and c.get("put_input") is not None), None)
        docs[key]["entry"] = entry
    return checked, docs


def judge(rig: rig_lib.Rig, run: Run, params: Dict, control: bool = False
          ) -> Dict[str, float]:
    """Frees the program's state and runs the plain reference over the
    checked requests; returns the correctness numbers."""
    checked, docs = checked_inputs(rig, run, int(params.get("check_docs", 4)))
    rig.engine_rig = None
    rig.runner = None
    gc.collect()
    if rig.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    p, cfg, adapter = rig.params, rig.cfg, rig.adapter
    with torch.no_grad():
        return run_checks(rig.hf, lambda i: adapter.layer_weights(p, cfg, i),
                          {k: p[k] for k in ("embed", "final_norm", "lm_head")},
                          checked, docs, control=control)


def prepare(spec: Spec, cell: Dict, seed: int, seconds: float,
            device: torch.device, params: Optional[Dict] = None):
    params = params or spec.params(cell)
    rig = rig_lib.build(spec.config(cell), cell["config"], spec.mix(cell),
                        params, seed, seconds, device)
    rig_lib.set_up(rig, answers=any(
        m["name"] == "quality_mean" for m in spec.metrics(cell, "end_to_end")))
    return rig, params


def device_info(device: torch.device, chips: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def metric_values(spec: Spec, cell: Dict, run: Run, kind: str) -> Dict:
    out = {}
    for m in spec.metrics(cell, kind):
        v = spec.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, device: Optional[torch.device] = None,
         spec: Optional[Spec] = None, forbid: bool = True) -> int:
    """The command line; ``device``, ``spec`` and ``forbid`` (the check of
    the loaded modules, which a test process that has loaded JAX for
    other tests cannot pass) are for the CPU tests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = spec or Spec()
    cell = spec.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    torch.set_num_threads(4)
    rig, params = prepare(spec, cell, args.seed, args.seconds, device)
    setup_s = time.perf_counter() - T_START
    try:
        run = serve(rig, bool(args.trace), setup_s, cell)
        dev = device_info(device, int(cell["chips"]))
        found = forbidden_modules() if forbid else []
        if found:
            print(f"loaded in the measuring process: {found}", file=sys.stderr)
            return 4
        kind = "per_layer" if args.trace else "end_to_end"
        metrics = metric_values(spec, cell, run, kind)
        ssd = rig.controller.tiers.get("ssd")
        stats = {
            "requests": len(run.records),
            "failed": sum(not r["ok"] for r in run.records),
            "ttft_samples": len(run.records),
            "ttft_p50_s": percentile(run.ttfts(), 50),
            "ttft_p90_s": percentile(run.ttfts(), 90),
            "service_mean_s": sum(r["ret_s"] - r["start_s"]
                                  for r in run.records)
            / max(1, len(run.records)),
            "busy_share": sum(r["ret_s"] - r["start_s"] for r in run.records)
            / max(run.window_s, 1e-9),
            "quality_mean": spec.reader("quality_mean")(run),
            "window_s": run.window_s,
            "late_start_s_max": max((r["start_s"] - r["due_s"]
                                     for r in run.records), default=0.0),
            "hits": {t: sum(str(r["hit_tier"]) == t for r in run.records)
                     for t in sorted({str(r["hit_tier"]) for r in run.records})},
            "methods": sorted({f"{r['method']}@{r.get('rate', 0):.4f}"
                               for r in run.records if r["ok"]}),
            "ssd_written_bytes": int(ssd.written_bytes) if ssd else 0,
            "controller": dict(rig.controller.counters),
            "errors": sorted({r["error"] for r in run.records if r["error"]}),
            "host_peak_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024,
        }
        print("stats " + json.dumps(stats, default=str), flush=True)
        if run.profile:
            dev["busy_s"] = run.profile["busy_s"]
            dev["window_s"] = run.profile["window_s"]
        nums = judge(rig, run, params, control=bool(args.control))
        print("readings " + json.dumps(nums), flush=True)
    finally:
        rig.close()
    limits = params["limits"]
    side = "control_" if args.control else ""
    checks = {k: {"value": nums[side + k], "limit": limits[k]}
              for k in limits}
    failed = sum(not r["ok"] for r in run.records)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    out = {"correct": correct, "attempted": len(run.records), "failed": failed,
           "metrics": metrics, "device": dev}
    if run.profile:
        out["breakdown"] = {
            "device_ops": [list(x) for x in run.profile["device_ops"][:10]],
            "idle_gaps": [list(x) for x in run.profile["idle_gaps"][:10]]}
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
