"""Operation and byte counts from shapes: a model's FLOPs per token, and
the bytes a KIVI kernel call must move.

Model FLOPs count every matrix product the port runs for a token, at 2
per multiply-add, layer by layer as ``reference.model.layer_kinds``
gives each layer's kinds: on an attention layer its projections and its
scores against the rows it sees (a prefill counts the causal half of its
score matrix; a decode step attends to ``ctx`` rows, its own included);
on a Mamba layer ``in_proj``, ``x_proj``, ``dt_proj`` and ``out_proj``,
and in a decode step the two contractions the port runs as products
there, the conv window against its kernel and the state against C; a
dense gated MLP, or the router over the published experts, the k routed
experts a token reaches and the shared ones; then the output head.
Multi-head latent attention is counted in the form the port runs it:
decompressed (per-head K and V from the latent) in a prefill, absorbed
(q through W_uk, the output through W_uv) in a decode step. Where a chip
holds a share of the experts (``num_experts`` or ``n_routed_experts``
held, ``PUBLISHED_EXPERTS`` published), the routed experts' work is
scaled by held / published: the share of a token's k picks that land
here. The embedding lookup, norms, softmax, the scan's recurrence and
other elementwise work count nothing."""
from __future__ import annotations

from typing import Dict, Iterable

from bench.reference.model import layer_kinds

BF16_PEAK = 989e12        # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
HBM_BPS = 3.35e12         # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
#: the key that states the published expert count where fewer are held
PUBLISHED_EXPERTS = "num_experts_published"


def _ffn_per_token(hf: Dict, kind: str) -> float:
    d = hf["hidden_size"]
    if kind == "dense":
        return 3 * d * hf["intermediate_size"]
    if "moe_intermediate_size" in hf:              # deepseek_v2
        ff, held = hf["moe_intermediate_size"], hf["n_routed_experts"]
        shared = hf["n_shared_experts"] * ff
    else:                                          # olmoe, jamba
        ff, held, shared = hf["intermediate_size"], hf["num_experts"], 0
    e = hf.get(PUBLISHED_EXPERTS, held)
    k = hf["num_experts_per_tok"]
    return d * e + k * 3 * d * ff * held / e + 3 * d * shared


def _mamba_per_token(hf: Dict, decode: bool) -> float:
    d, n, c = hf["hidden_size"], hf["mamba_d_state"], hf["mamba_d_conv"]
    d_in, r = hf["mamba_expand"] * d, hf["mamba_dt_rank"]
    proj = d * 2 * d_in + d_in * (r + 2 * n) + r * d_in + d_in * d
    return proj + (c * d_in + d_in * n if decode else 0)


def _attn_proj_per_token(hf: Dict, decode: bool) -> float:
    d, h = hf["hidden_size"], hf["num_attention_heads"]
    if "kv_lora_rank" not in hf:
        hd = d // h
        kv = hf["num_key_value_heads"]
        return d * h * hd + 2 * d * kv * hd + h * hd * d
    n, rd = hf["qk_nope_head_dim"], hf["qk_rope_head_dim"]
    vd, r = hf["v_head_dim"], hf["kv_lora_rank"]
    common = d * h * (n + rd) + d * r + d * rd + h * vd * d
    # prefill: K_nope and V from the latent for every token; decode: q
    # folded through W_uk and the output through W_uv, once a query
    return common + (h * n * r + h * r * vd)


def _attn_rows_per_pair(hf: Dict, decode: bool) -> float:
    """multiply-adds of one query against one visible row, all heads."""
    h = hf["num_attention_heads"]
    if "kv_lora_rank" not in hf:
        hd = hf["hidden_size"] // h
        return 2 * h * hd
    if decode:                      # scores on the latent and rope, P·latent
        return h * (2 * hf["kv_lora_rank"] + hf["qk_rope_head_dim"])
    return h * (hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]
                + hf["v_head_dim"])


def _n_attention(hf: Dict) -> int:
    return sum(mixer == "attention" for mixer, _ in layer_kinds(hf))


def _dense_per_token(hf: Dict, decode: bool) -> float:
    """Every product a token runs outside the scores: each layer's mixer
    projections and FFN, and the head."""
    total = hf["hidden_size"] * hf["vocab_size"]
    for mixer, ffn in layer_kinds(hf):
        total += _ffn_per_token(hf, ffn) + (
            _attn_proj_per_token(hf, decode) if mixer == "attention"
            else _mamba_per_token(hf, decode))
    return total


def prefill_flops(hf: Dict, n: int) -> float:
    """A prefill of ``n`` tokens (the head only on the last, as the
    port's prefill takes it)."""
    per = _dense_per_token(hf, False) - hf["hidden_size"] * hf["vocab_size"]
    pairs = n * (n + 1) / 2
    return 2 * (n * per + hf["hidden_size"] * hf["vocab_size"]
                + _n_attention(hf) * pairs * _attn_rows_per_pair(hf, False))


def decode_flops(hf: Dict, ctx: int) -> float:
    """One token decoded against ``ctx`` visible rows."""
    return 2 * (_dense_per_token(hf, True) + _n_attention(hf) * ctx
                * _attn_rows_per_pair(hf, True))


def window_flops(hf: Dict, prefill_lens: Iterable[int],
                 decode_ctx: Iterable[int]) -> float:
    return (sum(prefill_flops(hf, n) for n in prefill_lens)
            + sum(decode_flops(hf, c) for c in decode_ctx))


def kivi_bytes(n_elements: int, bits: int, group: int) -> float:
    """Bytes a KIVI quantize or dequantize call moves at least: the f32
    matrix once, its codes once and a scale and a zero (f32) a group."""
    return n_elements * 4 + n_elements * bits / 8 + 2 * (n_elements // group) * 4
