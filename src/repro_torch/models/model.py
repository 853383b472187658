"""Stage-structured model: the dense stage.

Counterpart of ``repro/models/model.py``.  A model is a list of stages;
where the reference scans each stage over params stacked on a leading
axis, the port keeps a stage as an ``nn.ModuleList`` of blocks and loops
over it.  Caches keep the reference's layout: one dict per stage with a
leading layer axis when the stage has more than one block.

Only the ``dense`` family is ported; the others raise
``NotImplementedError`` (ROADMAP Queue 1, item 11).  Int8 serving weights
(the reference's ``_maybe_dequant``) wait for ``serving/quant.py``
(Queue 1, item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec


@dataclasses.dataclass(frozen=True)
class StageDef:
    kind: str
    n: int


# --------------------------------------------------------------- stages ----
def build_stages(cfg: ModelConfig) -> List[StageDef]:
    if cfg.family == "moe" and cfg.attention == "mla":
        return [StageDef("mla_dense", 1), StageDef("mla_moe", cfg.num_layers - 1)]
    if cfg.family == "moe":
        return [StageDef("moe", cfg.num_layers)]
    if cfg.family == "audio":
        return [StageDef("enc", cfg.encdec.num_encoder_layers),
                StageDef("dec", cfg.num_layers)]
    if cfg.family == "ssm":  # xlstm: groups of 6 (sLSTM at in-group index 3)
        assert cfg.num_layers % 6 == 0
        return [StageDef("xlstm_group", cfg.num_layers // 6)]
    if cfg.family == "hybrid":  # zamba2: groups of (shared_every mamba + shared attn)
        return [StageDef("zamba_group", cfg.num_layers // cfg.shared_every)]
    return [StageDef("dense", cfg.num_layers)]


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch ports the dense family only; '{cfg.name}' is "
            f"family '{cfg.family}' (ROADMAP Queue 1, item 11)")


def _block_schema(cfg: ModelConfig, kind: str):
    assert kind == "dense", kind
    nrm = lambda: L.norm_schema(cfg.d_model, cfg.norm)
    s = {"ln1": nrm(), "attn": L.gqa_schema(cfg)}
    if not cfg.parallel_block:
        s["ln2"] = nrm()
    s["mlp"] = L.mlp_schema(cfg)
    return s


def model_schema(cfg: ModelConfig):
    """The reference's schema with each stage as a list of per-block
    schemas instead of one stacked schema."""
    _require_dense(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    s: Dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "fsdp"), D ** -0.5),
        "final_norm": L.norm_schema(D, cfg.norm),
        "stages": [[_block_schema(cfg, st.kind) for _ in range(st.n)]
                   for st in build_stages(cfg)],
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((D, V), ("fsdp", "vocab"), D ** -0.5)
    return s


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random params from the schema's scales, drawn on ``device`` from a
    seeded ``torch.Generator``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return L.to_module(L.materialize(model_schema(cfg), gen, cfg.dtype,
                                     device))


# -------------------------------------------------------------- forward ----
def _block_forward(kind, p, h, cfg):
    """Full-sequence forward for one dense block -> (h, {'k','v'})."""
    hn = L.apply_norm(p["ln1"], h, cfg.norm)
    a, (k, v) = L.gqa_attention(p["attn"], hn, cfg)
    if cfg.parallel_block:
        h = h + a + L.apply_mlp(p["mlp"], hn, cfg)
    else:
        h = h + a
        hn2 = L.apply_norm(p["ln2"], h, cfg.norm)
        h = h + L.apply_mlp(p["mlp"], hn2, cfg)
    return h, {"k": k, "v": v}


def _stack(xs: list):
    return xs[0] if len(xs) == 1 else torch.stack(xs)


def forward(params, cfg: ModelConfig, batch: Dict[str, Any],
            collect_cache: bool = False):
    """Full-sequence forward -> (logits [B,S,V], aux_loss[, kv_stacks]).
    With ``collect_cache`` each stage's K/V ({'k','v'} with a leading
    layer axis when the stage has several blocks) is returned for
    ``assemble_caches``."""
    _require_dense(cfg)
    h = F.embedding(batch["tokens"], params["embed"])
    kv_stacks = []
    for st, blocks in zip(build_stages(cfg), params["stages"]):
        ks, vs = [], []
        for p in blocks:
            h, kv = _block_forward(st.kind, p, h, cfg)
            if collect_cache:
                ks.append(kv["k"])
                vs.append(kv["v"])
        if collect_cache:
            kv_stacks.append({"k": _stack(ks), "v": _stack(vs)})
    h = L.apply_norm(params["final_norm"], h, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", h, head) * cfg.logit_scale
    if collect_cache:
        return logits, 0.0, kv_stacks
    return logits, 0.0


# --------------------------------------------------------------- decode ----
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Cache per stage (leading layer axis when the stage has n > 1)."""
    _require_dense(cfg)
    device = resolve_device(device)
    dt = L.torch_dtype(cfg.dtype)
    Hkv, hd = cfg.num_kv_heads, cfg.hd()
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len

    def kv(n):
        shape = (batch, W, Hkv, hd) if n == 1 else (n, batch, W, Hkv, hd)
        z = lambda shp, t: torch.zeros(shp, dtype=t, device=device)
        if cfg.kv_quant:
            sshape = shape[:-1] + (1,)
            return {"k": z(shape, torch.int8), "k_s": z(sshape, torch.float32),
                    "v": z(shape, torch.int8), "v_s": z(sshape, torch.float32)}
        return {"k": z(shape, dt), "v": z(shape, dt)}

    return [kv(st.n) for st in build_stages(cfg)]


def cache_axes(cfg: ModelConfig):
    """Logical axes mirroring ``init_cache`` (the reference's names)."""
    _require_dense(cfg)
    kv = ("batch", "kv_seq", "kv_heads", "head_dim")
    names = ("k", "k_s", "v", "v_s") if cfg.kv_quant else ("k", "v")
    return [{name: kv if s.n == 1 else ("stack",) + kv for name in names}
            for s in build_stages(cfg)]


def _block_decode(kind, p, h, cache, pos, cfg):
    """Single-token decode for one dense block.  h [B,1,D]; ``cache`` is
    the block's cache, updated in place."""
    hn = L.apply_norm(p["ln1"], h, cfg.norm)
    a, cache = L.gqa_decode(p["attn"], hn, cfg, cache, pos)
    if cfg.parallel_block:
        h = h + a + L.apply_mlp(p["mlp"], hn, cfg)
    else:
        h = h + a
        hn2 = L.apply_norm(p["ln2"], h, cfg.norm)
        h = h + L.apply_mlp(p["mlp"], hn2, cfg)
    return h, cache


def decode_step(params, cfg: ModelConfig, tokens, pos, caches):
    """tokens [B], pos [B] -> (logits [B,V], caches).  The caches are
    updated in place and returned."""
    _require_dense(cfg)
    h = F.embedding(tokens[:, None], params["embed"])
    for st, blocks, cache in zip(build_stages(cfg), params["stages"], caches):
        for i, p in enumerate(blocks):
            layer = cache if st.n == 1 else {k: c[i] for k, c in cache.items()}
            h, _ = _block_decode(st.kind, p, h, layer, pos, cfg)
    h = L.apply_norm(params["final_norm"], h, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (h[:, 0] @ head) * cfg.logit_scale
    return logits, caches


def _pad_kv(kv, cache_len, window):
    """kv [..., S, H, hd] -> cache [..., W, H, hd] (ring layout for SWA)."""
    S = kv.shape[-3]
    if window and S >= window:
        tail = kv[..., S - window:, :, :]
        return torch.roll(tail, S % window, dims=-3)
    W = min(cache_len, window) if window else cache_len
    return F.pad(kv, (0, 0, 0, 0, 0, W - S))


def assemble_caches(cfg: ModelConfig, kv_stacks, cache_len: int,
                    seq_len: int):
    """Turn ``forward(collect_cache=True)`` outputs into decode caches."""
    _require_dense(cfg)
    W = cfg.sliding_window
    caches = []
    for kvs in kv_stacks:
        k, v = kvs["k"], kvs["v"]
        if cfg.kv_quant:
            kq, ks = L.kv_quantize(k)
            vq, vs = L.kv_quantize(v)
            caches.append({"k": _pad_kv(kq, cache_len, W),
                           "k_s": _pad_kv(ks, cache_len, W),
                           "v": _pad_kv(vq, cache_len, W),
                           "v_s": _pad_kv(vs, cache_len, W)})
        else:
            caches.append({"k": _pad_kv(k, cache_len, W),
                           "v": _pad_kv(v, cache_len, W)})
    return caches


def prefill(params, cfg: ModelConfig, batch, cache_len: int):
    """Full-sequence forward + populated decode caches ->
    (logits [B,S,V], caches)."""
    logits, _aux, kv_stacks = forward(params, cfg, batch, collect_cache=True)
    S = batch["tokens"].shape[1]
    caches = assemble_caches(cfg, kv_stacks, max(cache_len, S), S)
    return logits, caches


__all__ = ["ModelConfig", "StageDef", "build_stages", "model_schema",
           "init_params", "forward", "decode_step", "init_cache",
           "cache_axes", "prefill", "assemble_caches"]
