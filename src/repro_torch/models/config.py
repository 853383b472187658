"""Unified model configuration covering all assigned architecture families.

A single ``ModelConfig`` describes dense/MoE transformers (GQA/SWA/MLA),
encoder-decoder (whisper), SSM (xLSTM), VLM backbones (phi-3-vision) and
hybrid SSM+attention (zamba2).  Configs are plain dataclasses so they can be
hashed into recording fingerprints (repro.core.attest).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0     # always-on shared experts (deepseek)
    top_k: int = 2
    expert_d_ff: int = 0            # per-expert hidden size
    capacity_factor: float = 1.25   # dispatch capacity (train); serve uses exact top-k
    group_size: int = 1024          # dispatch group (memory ~ T*g*topk*cf)
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64             # mamba2 N (per-head SSM state)
    num_heads: int = 0              # mamba2 heads (0 -> derived d_inner//head_dim)
    head_dim: int = 64              # mamba2 P
    expand: int = 2                 # d_inner = expand * d_model
    chunk: int = 256                # SSD chunk length
    conv_width: int = 4             # depthwise conv width (stubbed as pointwise mix)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_at: Tuple[int, ...] = ()  # layer indices using sLSTM blocks
    proj_factor_m: float = 2.0      # mLSTM up-projection factor
    proj_factor_s: float = 1.3334   # sLSTM ffn factor
    chunk: int = 256                # mLSTM chunkwise-parallel chunk length


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 0
    encoder_seq: int = 1500         # whisper: fixed #frames after conv frontend (stub)


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    num_image_tokens: int = 576     # CLIP patch embeds prepended (stub frontend)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | audio | ssm | vlm | hybrid
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0               # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 512
    max_seq: int = 8192

    # attention flavor
    attention: str = "gqa"          # gqa | mla | none (ssm)
    sliding_window: int = 0         # 0 -> full attention; >0 -> SWA window
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    mlp_bias: bool = False
    parallel_block: bool = False    # command-r: attn & ffn in parallel off one norm
    logit_scale: float = 1.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu (gated) | gelu (whisper: non-gated)

    # sub-configs (None if unused)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    mla: Optional[MLAConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None

    # hybrid (zamba2): shared attention block applied every `shared_every` ssm layers
    shared_every: int = 0
    dense_first_layer_d_ff: int = 0  # deepseek: layer 0 is dense with this d_ff

    dtype: str = "bfloat16"
    kv_quant: bool = False          # int8 KV cache (per-token/head scales)

    # ---- derived ----
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def is_subquadratic(self) -> bool:
        """True if long-context (500k) decode is feasible (not full attention)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decode path

    def fingerprint(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # Analytic parameter count (for 6ND MODEL_FLOPS and checkpoint planning).
    def param_count(self, active_only: bool = False) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, Hkv, hd = self.num_heads, self.num_kv_heads, self.hd()
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D

        def attn_params() -> int:
            if self.attention == "mla":
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = D * H * qk                                     # W_q
                p += D * (m.kv_lora_rank + m.qk_rope_head_dim)     # W_dkv (+rope k)
                p += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                p += H * m.v_head_dim * D                          # W_o
                return p
            return D * H * hd + 2 * D * Hkv * hd + H * hd * D

        def mlp_params(ff: int) -> int:
            mult = 3 if self.act == "silu" else 2  # gated vs plain
            return mult * D * ff

        def moe_params(active: bool) -> int:
            m = self.moe
            e = (m.top_k if active else m.num_experts) + m.num_shared_experts
            return e * mlp_params(m.expert_d_ff) // 1 + D * m.num_experts  # + router

        if self.family == "ssm" and self.xlstm is not None:
            x = self.xlstm
            d_in_m = int(D * x.proj_factor_m)
            n_s = len(x.slstm_at)
            n_m = L - n_s
            # mLSTM: up (z & x paths) + full qkv proj on inner + gates + down
            per_m = 2 * D * d_in_m + 3 * d_in_m * d_in_m + 2 * D * H + \
                d_in_m + d_in_m * D
            d_h = D // max(H, 1)
            per_s = 4 * D * D + 4 * H * d_h * d_h + \
                3 * int(D * x.proj_factor_s) * D + D
            total += n_m * per_m + n_s * per_s
            total += D  # final norm
            return total

        if self.family == "hybrid" and self.ssm is not None:
            s = self.ssm
            d_in = s.expand * D
            nh = s.num_heads or d_in // s.head_dim
            per_ssm = D * (2 * d_in + 2 * nh * s.state_dim + nh) + d_in * D + d_in
            n_shared = 1 if self.shared_every else 0
            shared = attn_params() + mlp_params(F) if n_shared else 0
            total += self.num_layers * per_ssm + shared
            total += D
            return total

        per_layer_dense = attn_params() + mlp_params(F)
        if self.family == "moe" and self.moe is not None:
            n_moe = L - (1 if self.dense_first_layer_d_ff else 0)
            moe_part = attn_params() + moe_params(active_only)
            total += n_moe * moe_part
            if self.dense_first_layer_d_ff:
                total += attn_params() + mlp_params(self.dense_first_layer_d_ff)
        elif self.family == "audio" and self.encdec is not None:
            enc = self.encdec.num_encoder_layers * (attn_params() + mlp_params(F))
            dec = L * (2 * attn_params() + mlp_params(F))  # self + cross attn
            total += enc + dec
        else:
            total += L * per_layer_dense
        total += D  # final norm
        return total
