"""The numbers that decide ``correct``, worked out by the plain reference
once the window has closed.

* ``logit_err_med`` and ``logit_err``: for each checked request, the
  reference's logits at its last question token against the logits the
  program's ``Model.decode_step`` returned there (which gave the served
  token): ||program - reference|| / ||reference||; the median over the
  checked requests (compared) and the largest (reported). A hit is
  followed from the program's own stored state (the reference decodes
  the stored entry itself and runs the question over its rows and, in a
  hybrid, its Mamba states); a miss from the reference's own prefill of
  the document. The largest is set by the few requests where bfloat16
  flips an expert choice; the median is the error that every request
  carries.
* ``served_gap``: by how much the served token's logit lies below the
  reference's best at the same place, widest over the checked requests,
  in logit units.
* ``prefill_err``: the start that a hit skips. The program's uncompressed
  prefill entry of each checked document against the reference's own:
  ||program - reference|| / ||reference|| a layer and an array (the
  attention rows, and each Mamba layer's ``ssm`` state and ``conv``
  window), the largest.
* ``stored_mismatch``: the stage that a hit skips. Elements of each
  checked stored entry that differ from a correct compression of what the
  program's compress was given (at the bits, groups and kept share that
  the entry records; token dropping passes the Mamba states whole and
  KIVI quantizes them), plus elements that differ between the entry a
  tier was given and the one it gave back. Exact: a correct program
  reads 0.

With ``control`` the same are read for the control: the reference on
float8 operands in the program's place (``logit_err*`` and
``prefill_err``: its logits and rows against the f32 ones, from the same
rows and question; ``served_gap``: run over each checked prompt, its
document and question whole, the f32 gap of the token it puts first at
every position; ``served_gap_served``, reported: the same at the served
positions alone), and KIVI worked out in bfloat16 (``stored_mismatch``).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from bench.reference import kivi
from bench.reference.model import PlainLM


def _count_diff(got: Dict, want: Dict) -> int:
    n = 0
    for k in set(got) | set(want):
        if k not in got or k not in want:
            n += int(np.prod(np.shape(got.get(k, want.get(k)))))
            continue
        a = torch.as_tensor(np.asarray(got[k])) if not torch.is_tensor(got[k]) \
            else got[k].cpu()
        b = torch.as_tensor(np.asarray(want[k])) if not torch.is_tensor(want[k]) \
            else want[k].cpu()
        if a.shape != b.shape:
            n += max(a.numel(), b.numel())
            continue
        n += int((a.to(torch.float64) != b.to(torch.float64)).sum())
    return n


def _rel_err(prog: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor]
             ) -> float:
    worst = 0.0
    for name, r in ref.items():
        p = torch.from_numpy(np.asarray(prog[name], np.float32)).to(r.device)
        p = p.reshape(r.shape)
        num = (p - r).flatten(1).norm(dim=1)
        den = r.flatten(1).norm(dim=1).clamp(min=1e-30)
        worst = max(worst, float((num / den).max()))
    return worst


def run_checks(hf: Dict, layer_weights, globals_: Dict, checked: List[Dict],
               docs: Dict[str, Dict], control: bool = False) -> Dict:
    """``checked``: one dict a checked request (``doc``, ``question``,
    ``served``, and for a hit ``stored`` = (method, arrays, meta)).
    ``docs``: doc key -> {"tokens", "entry" (the program's uncompressed
    prefill entry or None)}. Entries of ``checked`` may carry ``put`` (the
    entry the tier was given) and ``put_input`` (what compress was
    given)."""
    device = globals_["embed"].device
    sides = [("", PlainLM(hf, layer_weights, globals_))]
    if control:
        sides.append(("control_", PlainLM(hf, layer_weights, globals_,
                                          lowp=True)))
    out: Dict[str, float] = {}
    own: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {s: {} for s, _ in sides}
    need = {c["doc"] for c in checked if c.get("stored") is None}
    need |= {k for k, d in docs.items() if d.get("entry") is not None}
    for key in sorted(need):
        toks = torch.as_tensor(np.asarray(docs[key]["tokens"], np.int64),
                               device=device)
        for side, lm in sides:
            own[side][key] = lm.prefill(toks)
    # prefill_err
    errs = {side: 0.0 for side, _ in sides}
    for key, d in docs.items():
        if d.get("entry") is None:
            continue
        errs[""] = max(errs[""], _rel_err(d["entry"], own[""][key]))
        if control:
            errs["control_"] = max(errs["control_"], _rel_err(
                {k: v.cpu().numpy() for k, v in own["control_"][key].items()},
                own[""][key]))
    for side, _ in sides:
        out[f"{side}prefill_err"] = errs[side]
    # served_gap and logit_err
    gaps = {side: 0.0 for side, _ in sides}
    lerr: Dict[str, List[float]] = {side: [] for side, _ in sides}
    at_served = 0.0
    for c in checked:
        q = torch.as_tensor(np.asarray(c["question"], np.int64), device=device)
        first = len(docs[c["doc"]]["tokens"])
        if c.get("stored") is not None:
            method, arrays, meta = c["stored"]
            rows, _ = kivi.entry_kv(method, arrays, meta, device)
        ref_logits = None
        for side, lm in sides:
            r = rows if c.get("stored") is not None else own[side][c["doc"]]
            lg = lm.continue_from(r, q, first)
            if side == "":
                ref_logits = lg
                tok = int(c["served"])
                got = c.get("logits")
                if got is not None:
                    got = torch.as_tensor(got, dtype=torch.float32,
                                          device=lg.device)
                    lerr[""].append(float((got - lg).norm() / lg.norm()))
                gaps[side] = max(gaps[side],
                                 float(ref_logits.max() - ref_logits[tok]))
            else:
                lerr[side].append(float(
                    (lg - ref_logits).norm() / ref_logits.norm()))
                at_served = max(at_served, float(
                    ref_logits.max() - ref_logits[int(lg.argmax())]))
        if control:
            prompt = torch.cat([torch.as_tensor(np.asarray(
                docs[c["doc"]]["tokens"], np.int64), device=device), q])
            f32 = sides[0][1].all_logits(prompt)
            low = sides[1][1].all_logits(prompt).argmax(dim=-1)
            gap = f32.max(dim=-1).values - f32.gather(-1, low[:, None])[:, 0]
            gaps["control_"] = max(gaps["control_"], float(gap.max()))
            del f32
        c["ref_best"] = int(torch.argmax(ref_logits))
    for side, _ in sides:
        out[f"{side}served_gap"] = gaps[side]
        out[f"{side}logit_err"] = max(lerr[side], default=0.0)
        out[f"{side}logit_err_med"] = statistics.median(lerr[side]) \
            if lerr[side] else 0.0
    if control:
        out["control_served_gap_served"] = at_served
    # stored_mismatch
    miss = {side: 0 for side, _ in sides}
    for c in checked:
        if c.get("put") is not None and c.get("stored") is not None:
            miss[""] += _count_diff(c["stored"][1], c["put"][1])
        if c.get("put") is None or c.get("put_input") is None:
            continue
        method, arrays, meta = c["put"]
        want = kivi.expected_arrays(method, c["put_input"], meta, device)
        miss[""] += _count_diff(arrays, want)
        if control and method in ("kivi", "drop_kivi"):
            inner = meta if method == "kivi" else meta["kivi"]
            src = c["put_input"]
            if method == "drop_kivi":
                idx, pos = kivi.kept_rows(src, meta["keep"], 4)
                src = kivi.keep_tokens(src, idx)
            low = kivi.kivi_payload(src, inner, device, arith=torch.bfloat16)
            miss["control_"] += _count_diff(
                {k: v for k, v in arrays.items() if k in low}, low)
    for side, _ in sides:
        out[f"{side}stored_mismatch"] = float(miss[side])
    return out
