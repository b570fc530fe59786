"""OLMoE (``model_type`` olmoe): grouped-query attention with QK-norm and
a routed-expert FFN in every layer."""
from __future__ import annotations

from bench.adapters import common_weights, dtype_of


def port_config(hf: dict):
    from repro_torch.configs.base import FFNKind, ModelConfig, MoEConfig

    return ModelConfig(
        name=hf.get("name", "olmoe"), family="moe",
        n_layers=hf["num_hidden_layers"], d_model=hf["hidden_size"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_key_value_heads"],
        d_ff=hf["intermediate_size"], vocab_size=hf["vocab_size"],
        ffn_kind=FFNKind.MOE, qk_norm=True,
        rope_theta=float(hf["rope_theta"]), norm_eps=float(hf["rms_norm_eps"]),
        tie_embeddings=bool(hf["tie_word_embeddings"]),
        dtype=dtype_of(hf), param_dtype=dtype_of(hf),
        moe=MoEConfig(n_routed_experts=hf["num_experts"], n_shared_experts=0,
                      top_k=hf["num_experts_per_tok"],
                      expert_d_ff=hf["intermediate_size"], moe_every=1))


def layer_weights(params, cfg, i: int) -> dict:
    w = common_weights(params, cfg, i)
    a = w.pop("attn")
    w.update(wq=a["wq"], wk=a["wk"], wv=a["wv"], wo=a["wo"],
             q_norm=a["q_norm"], k_norm=a["k_norm"])
    return w
