"""One cell's system under test, built from the seed, with the
benchmark's wrappers on the objects it built.

``Capture`` (on in every run) keeps what the correctness check and the
quality metric read: the tokens the program served, the stored entry a
checked request's fetch read back and the entry that tier had been
given, what each stored entry was compressed from, and the program's
uncompressed prefill of each document. It counts the tokens that the
window's prefills and decode steps processed. It copies nothing: it
holds references, and drops an entry's compress input when the entry is
gone."""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bench import adapters
from bench.traffic import generator
from bench.weights import make_params

N_LANES = 1          # one request in service at a time


class Capture:
    def __init__(self, sampled: set):
        self.sampled = sampled
        self.req: Optional[int] = None
        self.req_key: Optional[str] = None
        self.inputs: Dict[int, Any] = {}          # id(entry) -> compress input
        self.put_of: Dict[tuple, Any] = {}        # (tier, key) -> entry given
        self.per_req: Dict[int, Dict] = {}
        self.tokens = {"prefill": 0, "decode": 0, "decode_ctx": 0}
        self.prefill_lens: List[int] = []
        self.decode_ctx: List[int] = []

    def _remember(self, entry, kv) -> None:
        k = id(entry)
        self.inputs[k] = kv
        weakref.finalize(entry, self.inputs.pop, k, None)

    def rec(self) -> Optional[Dict]:
        if self.req is None or self.req not in self.sampled:
            return None
        return self.per_req.setdefault(self.req, {})

    def install(self, rig) -> None:
        ctrl = rig.controller
        for name, m in ctrl.methods.items():
            self._wrap_method(m)
        for tname, tier in ctrl.tiers.items():
            self._wrap_tier(tname, tier)
        runner = rig.engine.runner
        model = runner.model
        cap = self
        prefill = runner.prefill_entry

        def prefill_entry(ctx_tokens):
            kv = prefill(ctx_tokens)
            cap.prefill_lens.append(len(ctx_tokens))
            return kv
        runner.prefill_entry = prefill_entry
        decode = model.decode_step

        def decode_step(params, cache, cur_index, tokens, position=None):
            logits, cache = decode(params, cache, cur_index, tokens, position)
            ctx = position if position is not None else cur_index
            cap.decode_ctx.append(int(ctx.max()) + 1 if torch.is_tensor(ctx)
                                  else int(ctx) + 1)
            r = cap.rec()
            if r is not None:
                r["logits"] = logits
            return logits, cache
        object.__setattr__(model, "decode_step", decode_step)

    def _wrap_method(self, m) -> None:
        cap = self
        compress, decompress = m.compress, m.decompress

        def do_compress(kv, rate, *a, **k):
            entry = compress(kv, rate, *a, **k)
            cap._remember(entry, kv)
            return entry
        m.compress = do_compress

    def _wrap_tier(self, tname: str, tier) -> None:
        cap = self
        put, get, evict = tier.put, tier.get, tier.evict

        def do_put(key, entry):
            nb = put(key, entry)
            cap.put_of[(tname, key)] = entry
            r = cap.rec()
            if r is not None and key == cap.req_key and "put" not in r:
                r["put"] = entry
                r["put_input"] = cap.inputs.get(id(entry))
            return nb

        def do_get(key):
            entry = get(key)
            given = cap.put_of.get((tname, key))
            if given is not None and given is not entry \
                    and id(given) in cap.inputs:
                cap._remember(entry, cap.inputs[id(given)])
            r = cap.rec()
            if r is not None and key == cap.req_key and "stored" not in r:
                r["stored"], r["given"] = entry, given
                r["given_input"] = cap.inputs.get(id(given)) \
                    if given is not None else None
            return entry

        def do_evict(key):
            evict(key)
            cap.put_of.pop((tname, key), None)
        tier.put, tier.get, tier.evict = do_put, do_get, do_evict


@dataclasses.dataclass
class Rig:
    hf: Dict
    cfg: Any
    adapter: Any
    params: Dict
    runner: Any
    traffic: generator.Traffic
    engine_rig: Any
    capture: Capture
    ssd_root: str
    seed_entries: Dict[str, Dict]
    ref_answers: Dict[tuple, List[int]]
    device: torch.device

    @property
    def engine(self):
        return self.engine_rig.engine

    @property
    def controller(self):
        return self.engine_rig.controller

    def close(self) -> None:
        shutil.rmtree(self.ssd_root, ignore_errors=True)


def port_config(hf: Dict, name: str):
    adapter = adapters.load(hf["model_type"])
    cfg = adapter.port_config(dict(hf, name=name))
    return adapter, cfg


def pick_checked(traffic: generator.Traffic, n: int, seed: int) -> List[int]:
    """``n`` request ids drawn from the seed, the longest prompt among
    them."""
    lens = {c.key: len(c.tokens) for c in traffic.contexts}
    reqs = traffic.requests
    longest = max(range(len(reqs)),
                  key=lambda i: (lens[reqs[i].context_key]
                                 + len(reqs[i].question), -i))
    rng = generator.rng_for(seed, 2)
    rest = [i for i in rng.permutation(len(reqs)) if i != longest]
    return sorted([longest] + [int(i) for i in rest[:max(0, n - 1)]])


def build(hf: Dict, config_name: str, mix: Dict, cell: Dict, seed: int,
          seconds: float, device: torch.device) -> Rig:
    from repro_torch.models import Model
    from repro_torch.serving.baselines import build_engine
    from repro_torch.serving.runner import ModelRunner

    adapter, cfg = port_config(hf, config_name)
    params = make_params(cfg, seed, device,
                         dtype=getattr(torch, adapters.dtype_of(hf)))
    model = Model(cfg)
    runner = ModelRunner(model, params, capacity=generator.max_prompt(mix))
    traffic = generator.generate(mix, cfg.vocab_size, float(cell["rate_hz"]),
                                 seconds, seed)
    ssd_root = tempfile.mkdtemp(prefix="bench_ssd_",
                                dir=os.environ.get("TMPDIR") or None)
    engine_rig = build_engine(
        runner, traffic.contexts, full_cfg=cfg,
        n_active_params=model.active_param_count(), policy="adaptive",
        dram_entries=float(mix["dram_entries"]),
        ssd_entries=float(mix["ssd_entries"]), ssd_root=ssd_root,
        n_lanes=N_LANES)
    sampled = set(pick_checked(traffic, int(cell["check_requests"]), seed))
    capture = Capture(sampled)
    capture.install(engine_rig)
    return Rig(hf, cfg, adapter, params, runner, traffic, engine_rig, capture,
               ssd_root, {}, {}, device)


def set_up(rig: Rig, answers: bool) -> None:
    """Seed the hierarchy and warm the window's decode path on one entry;
    with ``answers`` also work out the uncompressed answers that
    ``quality_mean`` compares with."""
    runner, ctrl = rig.runner, rig.controller
    max_new = int(rig.traffic.mix["max_new_tokens"])
    for ctx in rig.traffic.contexts:
        kv = runner.prefill_entry(ctx.tokens)
        rig.seed_entries[ctx.key] = kv
        ctrl.insert(ctx.key, kv, ctx.task_type, now=0.0)
    first = rig.traffic.contexts[0]
    runner.generate_from_kvdata(rig.seed_entries[first.key], len(first.tokens),
                                first.probes[0], max_new)
    for ctx in rig.traffic.contexts if answers else ():
        kv = rig.seed_entries[ctx.key]
        for q in ctx.probes:
            rig.ref_answers[(ctx.key, q.tobytes())] = \
                runner.generate_from_kvdata(kv, len(ctx.tokens), q, max_new)
    if rig.device.type == "cuda":
        torch.cuda.synchronize()
    cap = rig.capture
    cap.prefill_lens.clear()
    cap.decode_ctx.clear()
