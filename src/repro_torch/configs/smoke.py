"""Reduced-config smoke variants of every registered architecture.

Same family / layer pattern / attention kind / FFN kind, tiny dims: the
smoke variant of jamba still interleaves mamba+attn at 1:7 with MoE every
2nd layer, deepseek still runs MLA + shared/routed experts with a dense
first layer — only the widths, depths, expert counts and vocab shrink so a
forward/train step runs on CPU in milliseconds.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    AttnKind, FFNKind, LayerKind, MLAConfig, ModelConfig, MoEConfig, SSMConfig,
)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    head_dim = 16
    n_heads = 4
    # preserve the GQA ratio (rounded, >=1)
    ratio = max(1, round(cfg.n_heads / max(1, cfg.n_kv_heads)))
    n_kv = max(1, n_heads // ratio)

    if cfg.attn_period > 1:
        n_layers = cfg.attn_period  # one full hybrid period
    elif cfg.moe is not None and cfg.moe.first_k_dense > 0:
        n_layers = cfg.moe.first_k_dense + 2
    else:
        n_layers = 2

    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            n_routed_experts=min(8, cfg.moe.n_routed_experts),
            n_shared_experts=min(1, cfg.moe.n_shared_experts),
            top_k=min(2, cfg.moe.top_k),
            expert_d_ff=32,
            first_k_dense=cfg.moe.first_k_dense,
            dense_d_ff=128 if cfg.moe.dense_d_ff else 0,
            moe_every=cfg.moe.moe_every,
        )
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=0)
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(d_state=8, d_conv=4, expand=2)

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        n_enc_layers=2 if cfg.is_encoder_decoder else 0,
        d_model=n_heads * head_dim,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=0 if cfg.ffn_kind == FFNKind.NONE else 128,
        vocab_size=512,
        n_patches=8 if cfg.n_patches else 0,
        n_frames=16 if cfg.n_frames else 0,
        moe=moe,
        mla=mla,
        ssm=ssm,
        dtype="float32",
        param_dtype="float32",
    )
