"""Plain f32 forward of a routed-expert transformer with grouped-query
(OLMoE) or multi-head latent (DeepSeek-V2) attention, from the model's
``config.json`` keys and one dict of weights a layer.

It follows the published architectures with the port's departures, which
the configuration files list: the top-k router weights renormalised
(``norm_topk_prob``), OLMoE's QK-norm per head, DeepSeek's plain RoPE
(no YaRN) and halves rotated. No cache, no batching, no kernel: a
sequence is run whole, or its new tokens against rows it is given.

``lowp`` runs every matrix product on float8 (e4m3) operands, each
tensor scaled by its largest magnitude, and accumulates in f32: the
control for a model served in bfloat16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

F8_MAX = 448.0


def _q8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class PlainLM:
    def __init__(self, hf: Dict, layer_weights: Callable[[int], Dict],
                 globals_: Dict[str, torch.Tensor], lowp: bool = False):
        self.hf = hf
        self.layer_weights = layer_weights
        self.g = globals_
        self.lowp = lowp
        self.mla = bool(hf.get("kv_lora_rank"))
        self.eps = float(hf["rms_norm_eps"])
        self.theta = float(hf["rope_theta"])
        if hf.get("rope_scaling") and hf.get("rope_scaling_applied", True):
            raise ValueError("plain RoPE only: rope_scaling_applied has to "
                             "be false")
        self.n_layers = int(hf["num_hidden_layers"])
        self.h = int(hf["num_attention_heads"])
        self.top_k = int(hf["num_experts_per_tok"])

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
            q, k = self.rms(q, w["q_norm"]), self.rms(k, w["k_norm"])
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

    def ffn(self, w, h) -> torch.Tensor:
        if "dense_gate" in w:
            return self.mlp(h, w["dense_gate"], w["dense_up"], w["dense_down"])
        probs = torch.softmax(self.mm(h, w["router"]), dim=-1)
        top_w, top_i = torch.topk(probs, self.top_k, dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in torch.unique(top_i).tolist():
            tok, slot = torch.nonzero(top_i == e, as_tuple=True)
            y = self.mlp(h[tok], w["experts_gate"][e], w["experts_up"][e],
                         w["experts_down"][e])
            out.index_add_(0, tok, y * top_w[tok, slot][:, None])
        if "shared_gate" in w:
            out = out + self.mlp(h, w["shared_gate"], w["shared_up"],
                                 w["shared_down"])
        return out

    def layer(self, i: int, x, pos, cache=None):
        w = self.layer_weights(i)
        a, rows = self.attention(w, self.rms(x, w["ln1"]), pos, cache)
        x = x + a
        return x + self.ffn(w, self.rms(x, w["ln2"])), rows

    # -- whole passes ------------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.g["embed"][tokens].to(torch.float32)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(self.rms(x, self.g["final_norm"]), self.g["lm_head"])

    def prefill(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The (L, S, F) rows every layer stores for ``tokens``."""
        x = self.embed(tokens)
        pos = torch.arange(tokens.shape[0], device=x.device)
        per = []
        for i in range(self.n_layers):
            x, rows = self.layer(i, x, pos)
            per.append(rows)
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}

    def all_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(S, V) logits at every position of ``tokens``, run whole."""
        x = self.embed(tokens)
        pos = torch.arange(tokens.shape[0], device=x.device)
        for i in range(self.n_layers):
            x, _ = self.layer(i, x, pos)
        return self.logits(x)

    def continue_from(self, rows: Dict[str, torch.Tensor], tokens: torch.Tensor,
                      first_pos: int) -> torch.Tensor:
        """Logits of the last of ``tokens``, run after the stored rows
        ``rows`` (L, T, F) at positions first_pos, first_pos + 1, ..."""
        x = self.embed(tokens)
        pos = torch.arange(first_pos, first_pos + tokens.shape[0],
                           device=x.device)
        for i in range(self.n_layers):
            x, _ = self.layer(i, x, pos, {k: v[i] for k, v in rows.items()})
        return self.logits(x[-1:])[0]
