"""A test-local adapter for Jamba (``model_type`` jamba), the Mamba /
attention hybrid with routed experts, at smoke size. The tests install
it in place of ``adapters.load``'s module lookup, so the harness takes
the hybrid with no file of ``bench/adapters`` added.

The port runs Jamba's layers with three departures the configuration
has to state: experts on the even layers (no expert offset), the top-k
router weights renormalised, and no RMS norms on dt, B and C. Attention
takes no RoPE unless the configuration gives ``rope_theta``."""
from __future__ import annotations

from bench import adapters
from bench.adapters import common_weights, dtype_of


def port_config(hf: dict):
    from repro_torch.configs.base import (FFNKind, LayerKind, ModelConfig,
                                          MoEConfig, SSMConfig)

    if int(hf["expert_layer_offset"]) != 0:
        raise ValueError("the port places experts at offset 0")
    if not hf.get("norm_topk_prob") or hf.get("mamba_inner_norms", True):
        raise ValueError("the port renormalises the top-k weights and has "
                         "no inner norms: the configuration says so")
    d, h = hf["hidden_size"], hf["num_attention_heads"]
    rope = hf.get("rope_theta")
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
        moe=MoEConfig(n_routed_experts=hf["num_experts"], top_k=hf[
            "num_experts_per_tok"], expert_d_ff=hf["intermediate_size"],
            moe_every=hf["expert_layer_period"]),
        ssm=SSMConfig(d_state=hf["mamba_d_state"], d_conv=hf["mamba_d_conv"],
                      expand=hf["mamba_expand"], dt_rank=hf["mamba_dt_rank"]))


def layer_weights(params, cfg, i: int) -> dict:
    w = common_weights(params, cfg, i)
    if "mamba" in w:
        w.update(w.pop("mamba"))      # the port's names are the reference's
    else:
        a = w.pop("attn")
        w.update(wq=a["wq"], wk=a["wk"], wv=a["wv"], wo=a["wo"])
    return w


def install(monkeypatch) -> None:
    """Let ``adapters.load`` find this module for ``model_type`` jamba."""
    import sys
    load = adapters.load
    monkeypatch.setattr(adapters, "load", lambda t: sys.modules[__name__]
                        if t == "jamba" else load(t))
