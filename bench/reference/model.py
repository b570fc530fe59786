"""Plain f32 forward of a decoder whose layers mix attention or Mamba-1
with a dense or routed-expert FFN, from the model's ``config.json`` keys
and one dict of weights a layer: grouped-query (OLMoE) or multi-head
latent (DeepSeek-V2) attention, and Jamba's Mamba/attention hybrid.

Every layer computes ``x += mixer(rms(x, ln1)); x += ffn(rms(x, ln2))``.
Layer ``i``'s kinds come from the configuration (``layer_kinds``):

* mixer: attention where ``i % attn_layer_period == attn_layer_offset``,
  Mamba elsewhere; attention in every layer without those keys;
* FFN: routed experts where ``i % expert_layer_period ==
  expert_layer_offset``, a dense gated MLP elsewhere; without those
  keys, dense in the first ``first_k_dense_replace`` layers (and off
  ``moe_layer_freq``), experts in the others.

Keys that switch the published form (each a departure a configuration
can state and list in ``reduced``):

* ``rope_theta``: attention rotates q and k by halves (RoPE) only where
  the configuration gives it (Jamba has no positional encoding);
  ``rope_scaling`` is refused unless ``rope_scaling_applied`` is false;
* ``qk_norm``: ``"per_head"`` normalises q and k per head (a
  head_dim-wide weight); absent, no QK-norm;
* ``norm_topk_prob``: true renormalises the top-k router weights; absent
  or false, each expert is weighted by its softmax probability;
* ``mamba_inner_norms``: Jamba's RMS norms on the selective parameters
  (dt, B, C: weights ``dt_norm``, ``b_norm``, ``c_norm``); true unless
  the configuration says false.

The router's softmax runs over its weight's full width, the published
expert count; only experts below ``experts_gate.shape[0]`` (those held
on this chip) add their part, as a chip of an expert-parallel
deployment computes its own share of the layer.

No cache, no batching, no kernel: a sequence is run whole, or its new
tokens after the rows and states it is given. A Mamba layer runs its
selective scan one token at a time.

``lowp`` runs every matrix product on float8 (e4m3) operands, each
tensor scaled by its largest magnitude, and accumulates in f32: the
control for a model served in bfloat16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

F8_MAX = 448.0
STATE = ("ssm", "conv")     # a Mamba layer's stored arrays


def _q8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def layer_kinds(hf: Dict) -> List[Tuple[str, str]]:
    """(mixer, ffn) of each layer: ``"attention"`` or ``"mamba"``, and
    ``"experts"`` or ``"dense"``."""
    out = []
    for i in range(int(hf["num_hidden_layers"])):
        mixer = "attention"
        if "attn_layer_period" in hf and (
                i % int(hf["attn_layer_period"])
                != int(hf["attn_layer_offset"])):
            mixer = "mamba"
        if "expert_layer_period" in hf:
            experts = (i % int(hf["expert_layer_period"])
                       == int(hf["expert_layer_offset"]))
        else:
            experts = (i >= int(hf.get("first_k_dense_replace", 0))
                       and i % int(hf.get("moe_layer_freq", 1)) == 0)
        out.append((mixer, "experts" if experts else "dense"))
    return out


class PlainLM:
    def __init__(self, hf: Dict, layer_weights: Callable[[int], Dict],
                 globals_: Dict[str, torch.Tensor], lowp: bool = False):
        self.hf = hf
        self.layer_weights = layer_weights
        self.g = globals_
        self.lowp = lowp
        self.mla = bool(hf.get("kv_lora_rank"))
        self.eps = float(hf["rms_norm_eps"])
        if hf.get("rope_scaling") and hf.get("rope_scaling_applied", True):
            raise ValueError("plain RoPE only: rope_scaling_applied has to "
                             "be false")
        self.theta = None if hf.get("rope_theta") is None \
            else float(hf["rope_theta"])
        self.qk_norm = hf.get("qk_norm")
        if self.qk_norm not in (None, False, "per_head"):
            raise ValueError(f"no plain QK-norm {self.qk_norm!r}")
        self.renorm = bool(hf.get("norm_topk_prob", False))
        self.inner_norms = bool(hf.get("mamba_inner_norms", True))
        self.n_layers = int(hf["num_hidden_layers"])
        self.h = int(hf["num_attention_heads"])
        self.top_k = int(hf["num_experts_per_tok"])
        self.kinds = layer_kinds(hf)
        # each layer's index among the layers of its mixer's kind: its
        # row in the stored (L_kind, ...) arrays
        seen: Dict[str, int] = {}
        self.slot = []
        for mixer, _ in self.kinds:
            self.slot.append(seen.get(mixer, 0))
            seen[mixer] = self.slot[-1] + 1

    # -- primitives ------------------------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(torch.float32), b.to(torch.float32)
        if self.lowp:
            a, b = _q8(a), _q8(b)
        return a @ b

    def rms(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) \
            * w.to(torch.float32)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (S, H, D) rotated by halves at positions ``pos`` (S,)."""
        d = x.shape[-1]
        inv = 1.0 / (self.theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                 device=x.device) / d))
        ang = pos.to(torch.float32)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def mlp(self, x, gate, up, down):
        return self.mm(torch.nn.functional.silu(self.mm(x, gate))
                       * self.mm(x, up), down)

    def attend(self, q, k, v, n_prefix: int) -> torch.Tensor:
        """q (S, H, dq), k (T, H, dq), v (T, H, dv), T = n_prefix + S:
        query i sees every prefix row and new rows up to its own."""
        s, t = q.shape[0], k.shape[0]
        qh, kh, vh = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
        sc = self.bmm(qh, kh.transpose(1, 2)) / math.sqrt(q.shape[-1])
        qi = torch.arange(s, device=q.device)[:, None] + n_prefix
        kj = torch.arange(t, device=q.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        return self.bmm(torch.softmax(sc, dim=-1), vh).transpose(0, 1)

    def bmm(self, a, b):
        if self.lowp:
            a, b = _q8(a), _q8(b)
        return torch.bmm(a, b)

    # -- a layer -----------------------------------------------------------
    def attention(self, w, h, pos, cache: Optional[Dict]) -> Tuple[
            torch.Tensor, Dict[str, torch.Tensor]]:
        """h (S, d) at positions ``pos``; ``cache`` the layer's rows before
        them (or None). Returns the output and this layer's new rows in
        the stored layout."""
        s, nh = h.shape[0], self.h
        n_prefix = 0 if cache is None else next(iter(cache.values())).shape[0]
        if not self.mla:
            hd = self.hf["hidden_size"] // nh
            kvh = self.hf["num_key_value_heads"]
            q = self.mm(h, w["wq"]).reshape(s, nh, hd)
            k = self.mm(h, w["wk"]).reshape(s, kvh, hd)
            v = self.mm(h, w["wv"]).reshape(s, kvh, hd)
            if self.qk_norm:
                q, k = self.rms(q, w["q_norm"]), self.rms(k, w["k_norm"])
            if self.theta is not None:
                q, k = self.rope(q, pos), self.rope(k, pos)
            rows = {"k": k.reshape(s, -1), "v": v.reshape(s, -1)}
            if cache is not None:
                k = torch.cat([cache["k"].reshape(-1, kvh, hd), k])
                v = torch.cat([cache["v"].reshape(-1, kvh, hd), v])
            rep = nh // kvh
            out = self.attend(q, k.repeat_interleave(rep, 1),
                              v.repeat_interleave(rep, 1), n_prefix)
            return self.mm(out.reshape(s, -1), w["wo"]), rows
        nope, rd = self.hf["qk_nope_head_dim"], self.hf["qk_rope_head_dim"]
        vd, r = self.hf["v_head_dim"], self.hf["kv_lora_rank"]
        q = self.mm(h, w["wq"]).reshape(s, nh, nope + rd)
        q_nope, q_rope = q[..., :nope], self.rope(q[..., nope:], pos)
        ckv = self.rms(self.mm(h, w["w_dkv"]), w["kv_norm"])
        kr = self.rope(self.mm(h, w["w_kr"])[:, None, :], pos)[:, 0]
        rows = {"ckv": ckv, "krope": kr}
        if cache is not None:
            ckv = torch.cat([cache["ckv"], ckv])
            kr = torch.cat([cache["krope"], kr])
        t = ckv.shape[0]
        k_nope = self.mm(ckv, w["w_uk"]).reshape(t, nh, nope)
        v = self.mm(ckv, w["w_uv"]).reshape(t, nh, vd)
        k = torch.cat([k_nope, kr[:, None, :].expand(t, nh, rd)], dim=-1)
        out = self.attend(torch.cat([q_nope, q_rope], dim=-1), k, v, n_prefix)
        return self.mm(out.reshape(s, -1), w["wo"]), rows

    def mamba(self, w, h, state: Optional[Dict]) -> Tuple[
            torch.Tensor, Dict[str, torch.Tensor]]:
        """Mamba-1 over h (S, d), after ``state`` (``ssm`` (d_in, n), the
        scan's state, and ``conv`` (c - 1, d_in), the last rows of
        ``xs`` before these) or from zeros. Weights: ``in_proj`` (d,
        2 d_in) giving [xs, z], ``conv_w`` (c, d_in) and ``conv_b``,
        ``x_proj`` (d_in, r + 2n) giving [dt, B, C], ``dt_proj`` (r,
        d_in) and ``dt_bias``, ``a_log`` (d_in, n), ``d_skip`` (d_in,),
        ``out_proj`` (d_in, d). Returns the output and the final state."""
        f32 = torch.float32
        s = h.shape[0]
        c, d_in = w["conv_w"].shape
        r, n = w["dt_proj"].shape[0], w["a_log"].shape[-1]
        xz = self.mm(h, w["in_proj"])
        xs, z = xz[:, :d_in], xz[:, d_in:]
        prev = torch.zeros((c - 1, d_in), dtype=f32, device=h.device) \
            if state is None else state["conv"].to(f32)
        padded = torch.cat([prev, xs])                   # (S + c - 1, d_in)
        conv = sum(padded[j:j + s] * w["conv_w"][j].to(f32) for j in range(c))
        xc = torch.nn.functional.silu(conv + w["conv_b"].to(f32))
        proj = self.mm(xc, w["x_proj"])
        dt, b_sel, c_sel = proj[:, :r], proj[:, r:r + n], proj[:, r + n:]
        if self.inner_norms:
            dt = self.rms(dt, w["dt_norm"])
            b_sel, c_sel = self.rms(b_sel, w["b_norm"]), \
                self.rms(c_sel, w["c_norm"])
        dt = torch.nn.functional.softplus(self.mm(dt, w["dt_proj"])
                                          + w["dt_bias"].to(f32))
        a = -torch.exp(w["a_log"].to(f32))                   # (d_in, n)
        hs = torch.zeros((d_in, n), dtype=f32, device=h.device) \
            if state is None else state["ssm"].to(f32)
        ys = []
        for t in range(s):
            hs = torch.exp(dt[t, :, None] * a) * hs \
                + dt[t, :, None] * b_sel[t][None, :] * xc[t][:, None]
            ys.append((hs * c_sel[t][None, :]).sum(-1))
        y = torch.stack(ys) + w["d_skip"].to(f32) * xc
        out = self.mm(y * torch.nn.functional.silu(z), w["out_proj"])
        return out, {"ssm": hs, "conv": padded[s:]}

    def ffn(self, w, h) -> torch.Tensor:
        if "dense_gate" in w:
            return self.mlp(h, w["dense_gate"], w["dense_up"], w["dense_down"])
        probs = torch.softmax(self.mm(h, w["router"]), dim=-1)
        top_w, top_i = torch.topk(probs, self.top_k, dim=-1)
        if self.renorm:
            top_w = top_w / top_w.sum(-1, keepdim=True)
        held = w["experts_gate"].shape[0]
        out = torch.zeros_like(h)
        for e in torch.unique(top_i).tolist():
            if e >= held:               # on another chip of the deployment
                continue
            tok, slot = torch.nonzero(top_i == e, as_tuple=True)
            y = self.mlp(h[tok], w["experts_gate"][e], w["experts_up"][e],
                         w["experts_down"][e])
            out.index_add_(0, tok, y * top_w[tok, slot][:, None])
        if "shared_gate" in w:
            out = out + self.mlp(h, w["shared_gate"], w["shared_up"],
                                 w["shared_down"])
        return out

    def layer(self, i: int, x, pos, cache=None):
        """Layer ``i`` over x (S, d); ``cache`` this layer's stored rows
        (attention) or state (Mamba) before x, or None. Returns x and the
        layer's new rows or final state."""
        w = self.layer_weights(i)
        mixer, ffn = self.kinds[i]
        if ("dense_gate" in w) != (ffn == "dense"):
            raise ValueError(f"layer {i}: the weights hold no {ffn} FFN")
        h = self.rms(x, w["ln1"])
        if mixer == "mamba":
            a, rows = self.mamba(w, h, cache)
        else:
            a, rows = self.attention(w, h, pos, cache)
        x = x + a
        return x + self.ffn(w, self.rms(x, w["ln2"])), rows

    def _cache(self, rows: Dict[str, torch.Tensor], i: int) -> Dict:
        """Layer ``i``'s part of the stored (L_kind, ...) arrays."""
        state = self.kinds[i][0] == "mamba"
        return {k: v[self.slot[i]] for k, v in rows.items()
                if (k in STATE) == state}

    # -- whole passes ------------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.g["embed"][tokens].to(torch.float32)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(self.rms(x, self.g["final_norm"]), self.g["lm_head"])

    def prefill(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """What every layer stores for ``tokens``: the (L_attn, S, F) rows
        of the attention layers and the (L_mamba, ...) final states of
        the Mamba layers."""
        x = self.embed(tokens)
        pos = torch.arange(tokens.shape[0], device=x.device)
        per: Dict[str, List[torch.Tensor]] = {}
        for i in range(self.n_layers):
            x, rows = self.layer(i, x, pos)
            for k, v in rows.items():
                per.setdefault(k, []).append(v)
        return {k: torch.stack(v) for k, v in per.items()}

    def all_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(S, V) logits at every position of ``tokens``, run whole."""
        x = self.embed(tokens)
        pos = torch.arange(tokens.shape[0], device=x.device)
        for i in range(self.n_layers):
            x, _ = self.layer(i, x, pos)
        return self.logits(x)

    def continue_from(self, rows: Dict[str, torch.Tensor], tokens: torch.Tensor,
                      first_pos: int) -> torch.Tensor:
        """Logits of the last of ``tokens``, run after the stored rows and
        states ``rows`` (as ``prefill`` gives them) at positions
        first_pos, first_pos + 1, ..."""
        x = self.embed(tokens)
        pos = torch.arange(first_pos, first_pos + tokens.shape[0],
                           device=x.device)
        for i in range(self.n_layers):
            x, _ = self.layer(i, x, pos, self._cache(rows, i))
        return self.logits(x[-1:])[0]
