"""Architecture registry. ``get_config("qwen3-1.7b")`` / ``--arch qwen3-1.7b``."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (public re-exports)
    AttnKind, FFNKind, LayerKind, MLAConfig, ModelConfig, MoEConfig,
    SHAPES, SSMConfig, ShapeConfig, get_shape, shape_applicable,
)
from repro_torch.configs import (
    adaptcache_8b,
    deepseek_v2_lite_16b,
    falcon_mamba_7b,
    internvl2_1b,
    jamba_1_5_large_398b,
    minicpm_2b,
    olmoe_1b_7b,
    qwen3_1_7b,
    seamless_m4t_large_v2,
    smollm_135m,
    stablelm_3b,
)
from repro_torch.configs.smoke import smoke_variant

_MODULES = (
    stablelm_3b, minicpm_2b, smollm_135m, qwen3_1_7b, internvl2_1b,
    deepseek_v2_lite_16b, olmoe_1b_7b, falcon_mamba_7b,
    seamless_m4t_large_v2, jamba_1_5_large_398b, adaptcache_8b,
)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The ten assigned architectures (the dry-run matrix); adaptcache-8b is the
# paper's own model, exercised by the paper-validation benchmarks instead.
ASSIGNED: List[str] = [m.CONFIG.name for m in _MODULES[:-1]]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name.endswith("-smoke"):
        name, smoke = name[:-len("-smoke")], True
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    cfg = REGISTRY[name]
    return smoke_variant(cfg) if smoke else cfg


def list_configs() -> List[str]:
    return sorted(REGISTRY)
