"""Assigned input shapes, abstract input specs for every (arch x shape)
cell, and the smoke shrink shared by the port's tests and launchers.

Counterpart of ``repro.configs.common``: ``ShapeCell``, ``SHAPES``,
``cell_applicable`` and ``smoke_shrink`` are the reference's; its
``input_specs`` builds ``jax.ShapeDtypeStruct`` stand-ins, the port's
builds meta tensors (as ``models/model.py:abstract_params`` does), with
the decode caches from ``init_cache(..., device="meta")``.

Shapes (per assignment; identical across the 10 LM-family archs):
    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> serve prefill
    decode_32k   seq 32,768  global_batch 128   -> serve decode (1 tok)
    long_500k    seq 524,288 global_batch 1     -> serve decode; sub-quadratic
                                                   archs only
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if runnable, else a skip reason."""
    if shape == "long_500k" and not cfg.is_subquadratic():
        return "pure full-attention arch: 500k context requires sub-quadratic attention"
    return None


def _tok(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape: str,
                batch_override: int = 0, seq_override: int = 0) -> Dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cell = SHAPES[shape]
    B = batch_override or cell.batch
    S = seq_override or cell.seq
    bf = L.torch_dtype(cfg.dtype)

    if cell.kind in ("train", "prefill"):
        batch = {"tokens": _tok(B, S), "labels": _tok(B, S)}
        if cfg.family == "audio":
            batch["frames"] = torch.empty(
                (B, cfg.encdec.encoder_seq, cfg.d_model), dtype=bf,
                device="meta")
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.empty(
                (B, cfg.vlm.num_image_tokens, cfg.d_model), dtype=bf,
                device="meta")
        if cell.kind == "prefill":
            batch.pop("labels")
        return batch

    # decode: one new token against a cache of length S
    enc_S = cfg.encdec.encoder_seq if cfg.family == "audio" else 0
    caches = M.init_cache(cfg, B, S, enc_S=enc_S, device="meta")
    return {
        "tokens": _tok(B),
        "pos": _tok(B),
        "caches": caches,
    }


def smoke_shrink(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, 2), d_model=64,
        num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
        head_dim=16, d_ff=128, vocab_size=256, max_seq=256,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), expert_d_ff=64)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=8, head_dim=8, chunk=16)
    if cfg.xlstm is not None:
        small["num_layers"] = 6
        small["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_at=(3,), chunk=16)
    if cfg.mla is not None:
        small["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)
        small["num_layers"] = 3
    if cfg.encdec is not None:
        small["encdec"] = dataclasses.replace(
            cfg.encdec, num_encoder_layers=2, encoder_seq=24)
    if cfg.vlm is not None:
        small["vlm"] = dataclasses.replace(cfg.vlm, num_image_tokens=8)
    if cfg.family == "hybrid":
        small["num_layers"] = 4
        small["shared_every"] = 2
    if cfg.dense_first_layer_d_ff:
        small["dense_first_layer_d_ff"] = 128
    small["name"] = cfg.name + "-smoke"
    small.update(over)
    return dataclasses.replace(cfg, **small)
