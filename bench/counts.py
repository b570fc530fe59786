"""Operation and byte counts from shapes: a model's FLOPs per token, and
the bytes a KIVI kernel call must move.

Model FLOPs count every matrix product the port runs for a token, at 2
per multiply-add: the attention and FFN projections, the router, the k
routed experts a token reaches (and the shared ones), the output head,
and attention against the rows it sees. A prefill counts the causal half
of its score matrix; a decode step attends to ``ctx`` rows (its own
included). Multi-head latent attention is counted in the form the port
runs it: decompressed (per-head K and V from the latent) in a prefill,
absorbed (q through W_uk, the output through W_uv) in a decode step.
The embedding lookup, norms, softmax and other elementwise work count
nothing."""
from __future__ import annotations

from typing import Dict, Iterable

BF16_PEAK = 989e12        # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
HBM_BPS = 3.35e12         # H100 SXM HBM3 bytes/s (NVIDIA data sheet)


def _ffn_per_token(hf: Dict, layer: int) -> float:
    d = hf["hidden_size"]
    if "kv_lora_rank" in hf:                       # deepseek_v2
        if layer < hf["first_k_dense_replace"]:
            return 3 * d * hf["intermediate_size"]
        ff, e = hf["moe_intermediate_size"], hf["n_routed_experts"]
        shared = hf["n_shared_experts"] * ff
    else:                                          # olmoe
        ff, e, shared = hf["intermediate_size"], hf["num_experts"], 0
    k = hf["num_experts_per_tok"]
    return d * e + k * 3 * d * ff + 3 * d * shared


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


def _dense_per_token(hf: Dict, decode: bool) -> float:
    layers = hf["num_hidden_layers"]
    return (sum(_ffn_per_token(hf, i) for i in range(layers))
            + layers * _attn_proj_per_token(hf, decode)
            + hf["hidden_size"] * hf["vocab_size"])


def prefill_flops(hf: Dict, n: int) -> float:
    """A prefill of ``n`` tokens (the head only on the last, as the
    port's prefill takes it)."""
    per = _dense_per_token(hf, False) - hf["hidden_size"] * hf["vocab_size"]
    pairs = n * (n + 1) / 2
    return 2 * (n * per + hf["hidden_size"] * hf["vocab_size"]
                + hf["num_hidden_layers"] * pairs
                * _attn_rows_per_pair(hf, False))


def decode_flops(hf: Dict, ctx: int) -> float:
    """One token decoded against ``ctx`` visible rows."""
    return 2 * (_dense_per_token(hf, True) + hf["num_hidden_layers"] * ctx
                * _attn_rows_per_pair(hf, True))


def window_flops(hf: Dict, prefill_lens: Iterable[int],
                 decode_ctx: Iterable[int]) -> float:
    return (sum(prefill_flops(hf, n) for n in prefill_lens)
            + sum(decode_flops(hf, c) for c in decode_ctx))


def kivi_bytes(n_elements: int, bits: int, group: int) -> float:
    """Bytes a KIVI quantize or dequantize call moves at least: the f32
    matrix once, its codes once and a scale and a zero (f32) a group."""
    return n_elements * 4 + n_elements * bits / 8 + 2 * (n_elements // group) * 4
