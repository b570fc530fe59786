"""Roofline analysis of a dry-run cell on the H100.

Counterpart of ``repro.launch.roofline``. Terms (seconds, PER CARD — the
step counter counts one rank's ops on its local shapes, so its
quantities are already per card):

    compute    = matmul FLOPs / peak_FLOP/s
    memory     = analytic HBM bytes / HBM_bw
    collective = collective_bytes / link_bw

FLOPs and collective bytes come from ``launch.step_cost`` (the reference's
HLO walker has no counterpart: there is no HLO); the constants are
``launch.mesh``'s H100 ones.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for train cells,
2·N(+KV reads) for serving cells — the useful-compute yardstick; the ratio
MODEL_FLOPS / counted FLOPs exposes remat/dispatch overhead.
``model_flops``, ``analytic_hbm_bytes`` and ``analytic_peak_bytes`` are the
reference's formulas, line for line: pure Python over the configs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops: float                 # per chip (the step counter, local shapes)
    hbm_bytes: float             # per chip (the analytic data-plane model)
    collective_bytes: float      # per chip (the step counter, weighted)
    collective_detail: Dict[str, float]
    model_flops_per_chip: float
    peak_memory_bytes: Optional[float] = None   # the counter's live peak
    hlo_mem_bytes: Optional[float] = None   # the counter's raw op bytes

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline-optimistic step time: overlapped => max of terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops_per_chip / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:  # simcheck: ignore[units]
        """Fraction of the compute roofline achieved at the optimistic step
        time: (useful flops / step_time) / peak."""
        if self.step_time <= 0:
            return 0.0
        return (self.model_flops_per_chip / self.step_time) / PEAK_FLOPS_BF16

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips, "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "collective_detail": self.collective_detail,
            "model_flops_per_chip": self.model_flops_per_chip,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_bytes": self.peak_memory_bytes,
            "hlo_mem_bytes": self.hlo_mem_bytes,
        }


def _attn_layer_counts(cfg: ModelConfig):
    from repro_torch.configs.base import AttnKind, LayerKind
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k == LayerKind.ATTN)
    n_mamba = sum(1 for k in kinds if k == LayerKind.MAMBA)
    return n_attn, n_mamba


def model_flops(cfg: ModelConfig, shape: ShapeConfig, n_params: int,
                n_active: int) -> float:
    """Global USEFUL FLOPs for one step of this cell: the 6·N·D / 2·N·D
    dense term PLUS the attention quadratic term (causal-optimal, i.e. the
    lower triangle only, no remat recompute) and the SSM scan einsums —
    the yardstick an ideal implementation would execute."""
    from repro_torch.configs.base import AttnKind
    b, s = shape.global_batch, shape.seq_len
    tokens = b * s
    n_attn, n_mamba = _attn_layer_counts(cfg)
    h = cfg.n_heads
    hd = cfg.resolved_head_dim
    if cfg.attn_kind == AttnKind.MLA and cfg.mla is not None:
        qk_dim = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        pv_dim = cfg.mla.v_head_dim
        r = cfg.mla.kv_lora_rank
    else:
        qk_dim = pv_dim = hd
        r = 0

    # per-attn-layer forward attention flops (causal half)
    attn_fwd = 2.0 * b * (s * s / 2) * h * (qk_dim + pv_dim)
    # per-mamba-layer forward scan einsum flops
    ssm_fwd = 0.0
    if cfg.ssm is not None:
        ssm_fwd = 6.0 * tokens * cfg.d_inner * cfg.ssm.d_state

    if shape.kind == "train":
        return (6.0 * n_active * tokens
                + 3.0 * n_attn * attn_fwd + 3.0 * n_mamba * ssm_fwd)
    if shape.kind == "prefill":
        return (2.0 * n_active * tokens
                + n_attn * attn_fwd + n_mamba * ssm_fwd)
    # decode: one token/seq; attention over the full cached context
    if cfg.attn_kind == AttnKind.MLA:
        attn_dec = 4.0 * b * s * h * r          # absorbed-form scores+values
    else:
        attn_dec = 4.0 * b * s * h * hd
    ssm_dec = (6.0 * b * cfg.d_inner * cfg.ssm.d_state
               if cfg.ssm is not None else 0.0)
    return (2.0 * n_active * b + n_attn * attn_dec + n_mamba * ssm_dec)


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, n_params: int,
                       n_active: int, n_chips: int, kv_bits: int = 16,
                       opt_bytes_per_param: float = 8.0) -> float:
    """First-order per-card HBM traffic of one step of a fused data plane
    (flash attention keeps S*S scores on chip; chunked CE never spills
    full logits). The step counter's byte count reflects eager op
    boundaries and over-counts what fused kernels move, so the memory term
    uses this model (the reference's formulas).

    Components (global, then / n_chips):
      weights   train: fwd read + bwd read + grad w + param rw + opt rw
                serve: one read of active params
      acts      ~10 x L x B x S x d x 2B  (saved carries + flash q/k/v/out
                traffic + recompute reads, bf16)
      kv        decode: full cached KV read per step (at kv_bits) + write
      logits    chunked CE: one write+read per pass at f32
      moe       expert weights touched once per pass even if lightly used
    """
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    p_bytes = 2.0 * n_params                      # bf16 resident weights
    act_unit = b * s * d * 2.0

    if shape.kind == "train":
        weights = 3.0 * p_bytes + 2.0 * p_bytes \
            + 2.0 * opt_bytes_per_param * n_params
        acts = 10.0 * L * act_unit
        # chunked CE streams the logits matrix once per pass (fwd + bwd
        # recompute), f32; only one chunk is ever resident.
        logits = 2.0 * b * s * cfg.vocab_size * 4.0
        total = weights + acts + logits
    elif shape.kind == "prefill":
        weights = p_bytes
        acts = 6.0 * L * act_unit
        kv_write = b * s * cfg.kv_bytes_per_token()
        total = weights + acts + kv_write
    else:
        weights = 2.0 * n_active                  # one bf16 read of active
        kv = b * s * cfg.kv_bytes_per_token() * (kv_bits / 16.0)
        ssm_state = 0.0
        if cfg.ssm is not None:
            _, n_mamba = _attn_layer_counts(cfg)
            ssm_state = 2.0 * n_mamba * b * cfg.d_inner \
                * (cfg.ssm.d_state * 4.0 + cfg.ssm.d_conv * 2.0)
        total = weights + kv + ssm_state
    return total / n_chips


def analytic_peak_bytes(cfg: ModelConfig, shape: ShapeConfig, n_params: int,
                        n_chips: int, args_bytes: float,
                        loss_chunk: int = 512) -> float:
    """Per-card HBM peak estimate: exact argument bytes (the sum of the
    rank's local shards) plus the analytic activation working set (saved
    remat carries + one layer's transient + one logits chunk); the
    fits-HBM column uses this model, as the reference's does."""
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    L = cfg.n_layers
    act_unit = b * s * d * 2.0 / n_chips
    if shape.kind == "train":
        carries = L * act_unit                    # remat boundaries
        # flash chunk scores (f32) per chip: B_loc x H x qc x S
        h = cfg.n_heads
        scores = b * h * 512.0 * min(s, 4096) * 4.0 / n_chips
        logits_chunk = b * loss_chunk * cfg.vocab_size * 4.0 / n_chips
        grads = 2.0 * n_params / n_chips          # bf16 grad shard
        return args_bytes + carries + 4.0 * act_unit + scores \
            + logits_chunk + grads
    if shape.kind == "prefill":
        carries = L * act_unit
        h = cfg.n_heads
        scores = b * h * 512.0 * min(s, 32768) * 4.0 / n_chips
        return args_bytes + carries + 4.0 * act_unit + scores
    return args_bytes + 64e6                      # decode: KV is the args


def analyze(arch: str, shape: ShapeConfig, mesh_name: str, n_chips: int,
            cost, cfg: ModelConfig, n_params: int, n_active: int,
            kv_bits: int = 16, opt_bytes_per_param: float = 8.0
            ) -> Roofline:
    """The cell's roofline from one rank's ``step_cost.StepCost``: FLOPs
    and collective bytes counted, the memory term from the analytic
    data-plane model (``analytic_hbm_bytes``), the counter's raw op bytes
    kept as ``hlo_mem_bytes`` and its live peak as ``peak_memory_bytes``."""
    mf = model_flops(cfg, shape, n_params, n_active) / n_chips
    hbm = analytic_hbm_bytes(cfg, shape, n_params, n_active, n_chips,
                             kv_bits=kv_bits,
                             opt_bytes_per_param=opt_bytes_per_param)
    return Roofline(arch, shape.name, mesh_name, n_chips, cost.flops,
                    hbm, cost.collective_bytes, dict(cost.collective_detail),
                    mf, cost.live_peak_bytes, cost.mem_bytes)
