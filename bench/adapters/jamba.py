"""Jamba (``model_type`` jamba): Mamba-1 layers with one grouped-query
attention layer a period, and routed experts on every
``expert_layer_period``-th layer from ``expert_layer_offset``, a dense
gated MLP on the others.

The published form, each key read as the source states it: experts at
their offset, the top-k router weights as the softmax gives them unless
``norm_topk_prob`` says otherwise, RMS norms on dt, B and C unless
``mamba_inner_norms`` is false, and no positional encoding unless the
configuration gives ``rope_theta``. Where the chip holds fewer experts
than were published (``num_experts`` below ``num_experts_published``),
the router keeps the published width and the port computes the held
experts only."""
from __future__ import annotations

from bench.adapters import common_weights, dtype_of
from bench.counts import PUBLISHED_EXPERTS


def port_config(hf: dict):
    from repro_torch.configs.base import (FFNKind, LayerKind, ModelConfig,
                                          MoEConfig, SSMConfig)

    d, h = hf["hidden_size"], hf["num_attention_heads"]
    rope = hf.get("rope_theta")
    held = int(hf["num_experts"])
    published = int(hf.get(PUBLISHED_EXPERTS, held))
    if held > published:
        raise ValueError(f"{held} experts held of {published} published")
    if hf.get("mamba_proj_bias") or not hf.get("mamba_conv_bias", True) \
            or hf.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's Mamba layer has a conv bias, no "
                         "projection bias, and SiLU")
    return ModelConfig(
        name=hf.get("name", "jamba"), family="hybrid",
        n_layers=hf["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=hf["num_key_value_heads"], head_dim=d // h,
        d_ff=hf["intermediate_size"], vocab_size=hf["vocab_size"],
        primary_kind=LayerKind.MAMBA, attn_period=hf["attn_layer_period"],
        attn_offset=hf["attn_layer_offset"], ffn_kind=FFNKind.MOE,
        rope_theta=float(rope or 10000.0),
        rotary_pct=1.0 if rope is not None else 0.0,
        norm_eps=float(hf["rms_norm_eps"]),
        tie_embeddings=bool(hf["tie_word_embeddings"]),
        dtype=dtype_of(hf), param_dtype=dtype_of(hf),
        moe=MoEConfig(n_routed_experts=published,
                      n_held_experts=0 if held == published else held,
                      top_k=hf["num_experts_per_tok"],
                      expert_d_ff=hf["intermediate_size"],
                      moe_every=hf["expert_layer_period"],
                      moe_offset=hf["expert_layer_offset"],
                      renormalize=bool(hf.get("norm_topk_prob", False))),
        ssm=SSMConfig(d_state=hf["mamba_d_state"], d_conv=hf["mamba_d_conv"],
                      expand=hf["mamba_expand"], dt_rank=hf["mamba_dt_rank"],
                      inner_norms=bool(hf.get("mamba_inner_norms", True))))


def layer_weights(params, cfg, i: int) -> dict:
    w = common_weights(params, cfg, i)
    if "mamba" in w:
        w.update(w.pop("mamba"))      # the port's names are the reference's
    else:
        a = w.pop("attn")
        w.update(wq=a["wq"], wk=a["wk"], wv=a["wv"], wo=a["wo"])
    return w
