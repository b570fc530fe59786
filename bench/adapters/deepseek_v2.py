"""DeepSeek-V2 (``model_type`` deepseek_v2): multi-head latent attention
without q compression, dense leading layers, then routed and shared
experts."""
from __future__ import annotations

from bench.adapters import common_weights, dtype_of


def port_config(hf: dict):
    from repro_torch.configs.base import (AttnKind, FFNKind, MLAConfig,
                                          ModelConfig, MoEConfig)

    if hf.get("q_lora_rank"):
        raise ValueError("the port runs MLA without q compression only")
    if hf.get("rope_scaling") and hf.get("rope_scaling_applied", True):
        raise ValueError("the port has no YaRN: a config with rope_scaling "
                         "states rope_scaling_applied false")
    return ModelConfig(
        name=hf.get("name", "deepseek_v2"), family="moe",
        n_layers=hf["num_hidden_layers"], d_model=hf["hidden_size"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_key_value_heads"],
        d_ff=hf["moe_intermediate_size"], vocab_size=hf["vocab_size"],
        attn_kind=AttnKind.MLA, ffn_kind=FFNKind.MOE,
        rope_theta=float(hf["rope_theta"]), norm_eps=float(hf["rms_norm_eps"]),
        tie_embeddings=bool(hf["tie_word_embeddings"]),
        dtype=dtype_of(hf), param_dtype=dtype_of(hf),
        mla=MLAConfig(kv_lora_rank=hf["kv_lora_rank"],
                      qk_nope_head_dim=hf["qk_nope_head_dim"],
                      qk_rope_head_dim=hf["qk_rope_head_dim"],
                      v_head_dim=hf["v_head_dim"], q_lora_rank=0),
        moe=MoEConfig(n_routed_experts=hf["n_routed_experts"],
                      n_shared_experts=hf["n_shared_experts"],
                      top_k=hf["num_experts_per_tok"],
                      expert_d_ff=hf["moe_intermediate_size"],
                      first_k_dense=hf["first_k_dense_replace"],
                      dense_d_ff=hf["intermediate_size"],
                      moe_every=hf["moe_layer_freq"]))


def layer_weights(params, cfg, i: int) -> dict:
    w = common_weights(params, cfg, i)
    a = w.pop("attn")
    w.update(wq=a["wq"], w_dkv=a["w_dkv"], w_kr=a["w_kr"], w_uk=a["w_uk"],
             w_uv=a["w_uv"], wo=a["wo"], kv_norm=a["kv_norm"])
    return w
