"""The benchmark's yardstick holds still for the configurations it
measures: the seeded weights, the plain reference's outputs and the FLOP
counts of the OLMoE and DeepSeek-V2 layouts, and the documents, due
times and picks of every traffic mix, equal numbers stored in
``data/pins.json``, which were taken before the harness learnt other
layer kinds and before a summarization question had two tokens (so the
pins read a question's first token only). Regenerate only with a change
that means to move them:

    PYTHONPATH=src python -m bench.tests.test_bench_pins
"""
import hashlib
import json

import numpy as np
import torch

from repro_torch.device import cap_test_threads

from bench import counts
from bench.reference.model import PlainLM
from bench.rig import port_config
from bench.spec import BENCH_DIR
from bench.tests.smoke import DATA
from bench.traffic import generator
from bench.weights import make_params

cap_test_threads()

PINS = DATA / "pins.json"
SMOKE = ["olmoe-smoke", "deepseek-smoke"]
FULL = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _smoke(name: str) -> dict:
    hf = json.loads((DATA / "configs" / f"{name}.json").read_text())
    adapter, cfg = port_config(hf, name)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        p = make_params(cfg, 2 ** 31 + 5, torch.device("cpu"), dtype=dtype)
        out[f"weights.{dtype}"] = _digest(_leaves(p))
    p = make_params(cfg, 7, torch.device("cpu"), dtype=torch.float32)
    toks = torch.as_tensor(np.random.RandomState(0).randint(8, 500, 150),
                           dtype=torch.long)
    q = torch.tensor([6, 9])
    for lowp in (False, True):
        lm = PlainLM(hf, lambda i: adapter.layer_weights(p, cfg, i),
                     {k: p[k] for k in ("embed", "final_norm", "lm_head")},
                     lowp=lowp)
        rows = lm.prefill(toks)
        tag = "lowp" if lowp else "f32"
        out[f"prefill.{tag}"] = _digest([rows[k] for k in sorted(rows)])
        out[f"all_logits.{tag}"] = _digest([lm.all_logits(toks[:40])])
        out[f"continue.{tag}"] = _digest([lm.continue_from(rows, q, 150)])
    return out


def _counts(hf: dict) -> dict:
    return {"prefill": [counts.prefill_flops(hf, n) for n in (1, 2, 37, 512,
                                                             3072)],
            "decode": [counts.decode_flops(hf, c) for c in (1, 48, 769,
                                                            3075)]}


def _traffic(mix: dict, vocab: int, rate: float, seed: int) -> dict:
    t = generator.generate(mix, vocab, rate, 51.0, seed)
    docs = hashlib.sha256()
    for c in t.contexts:
        docs.update(f"{c.key} {c.task_type} ".encode())
        docs.update(np.asarray(c.tokens, np.int64).tobytes())
    reqs = hashlib.sha256()
    for r, due in zip(t.requests, t.due_s):
        reqs.update(f"{r.context_key} {float(due)!r} "
                    f"{int(r.question[0])};".encode())
    return {"docs": docs.hexdigest(), "requests": reqs.hexdigest(),
            "n": len(t.requests)}


#: (mix file, vocabulary, rate) as the cells and the smoke cells run them
MIXES = [(BENCH_DIR / "traffic" / "doc_reuse_short.json", 50304, 1.5),
         (BENCH_DIR / "traffic" / "doc_reuse.json", 102400, 1.0),
         (DATA / "traffic" / "doc_reuse.json", 512, 12.0)]


def pins() -> dict:
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # one reduction order on any host
    try:
        out = {name: _smoke(name) for name in SMOKE}
    finally:
        torch.set_num_threads(threads)
    for name in SMOKE:
        hf = json.loads((DATA / "configs" / f"{name}.json").read_text())
        out[name]["counts"] = _counts(hf)
    for name in FULL:
        hf = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
        out[name] = {"counts": _counts(hf)}
    out["traffic"] = {
        f"{path.parent.parent.name}/{path.stem}.{seed}": _traffic(
            json.loads(path.read_text()), vocab, rate, seed)
        for path, vocab, rate in MIXES for seed in (3, 2 ** 31 + 5)}
    return out


def test_weights_reference_and_counts_hold_still():
    want = json.loads(PINS.read_text())
    got = json.loads(json.dumps(pins()))
    for name in want:
        for key in want[name]:
            assert got[name][key] == want[name][key], (name, key)


if __name__ == "__main__":
    PINS.write_text(json.dumps(pins(), indent=1) + "\n")
