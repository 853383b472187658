"""Core layers: schemas, norms, RoPE, attention (GQA and MLA), MLP.

Counterpart of ``repro/models/layers.py``.  Params are
described by ``ParamSpec`` schemas and materialized into a ``ParamTree``
module, so ``p["wq"]`` and ``"bq" in p`` read as in the reference.

Unlike the reference, whose model runs pure-JAX attention and norms, the
port's model runs its hand-written kernels: ``apply_norm`` (rmsnorm),
``chunked_attention`` and ``decode_attention`` call the custom ops of
``repro_torch.kernels``, which launch the CUDA kernels on CUDA tensors and
take their plain versions on CPU tensors.  The large projections stay
``torch.einsum`` (the reference left them to XLA).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import masked_softmax
from repro_torch.sharding import constrain, grad_like, is_dtensor


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    scale: float = 0.02          # init std; 0.0 -> zeros; -1.0 -> ones
    dtype: Optional[str] = None  # None -> model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class ParamTree(nn.Module):
    """A nested dict of parameters as a module (``p[name]``, ``name in p``);
    lists of blocks are ``nn.ModuleList``s.  Parameters do not require
    grad, so a served forward records nothing for a backward; training
    differentiates its own fp32 master tree (``training/steps.py``)."""

    def __init__(self, entries: dict):
        super().__init__()
        self._names = tuple(entries)
        for name, v in entries.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(
                    v, requires_grad=False))
            else:
                self.add_module(name, v)

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._names

    def keys(self):
        return self._names


def to_module(tree):
    """Nested dicts/lists of tensors -> ParamTree / nn.ModuleList."""
    if isinstance(tree, dict):
        return ParamTree({k: to_module(v) for k, v in tree.items()})
    if isinstance(tree, list):
        return nn.ModuleList(to_module(v) for v in tree)
    return tree


def to_tree(module):
    """``to_module``'s inverse: a ParamTree as the nested dicts/lists of
    plain tensors it holds (the same storage), the form in which a
    recorded step takes its params as inputs."""
    if isinstance(module, ParamTree):
        return {k: to_tree(module[k]) for k in module.keys()}
    if isinstance(module, nn.ModuleList):
        return [to_tree(m) for m in module]
    return module.detach()


def zeros_like_schema(schema, default_dtype: str, device):
    """Zeros of a schema's shapes and dtypes, as nested dicts/lists."""
    if isinstance(schema, dict):
        return {k: zeros_like_schema(v, default_dtype, device)
                for k, v in schema.items()}
    if isinstance(schema, list):
        return [zeros_like_schema(v, default_dtype, device) for v in schema]
    return torch.zeros(schema.shape, dtype=torch_dtype(
        schema.dtype or default_dtype), device=device)


def materialize(schema, generator: torch.Generator, default_dtype: str,
                device):
    """Random tensors for a schema, drawn in schema order from
    ``generator`` (which must live on ``device``)."""
    if isinstance(schema, dict):
        return {k: materialize(v, generator, default_dtype, device)
                for k, v in schema.items()}
    if isinstance(schema, list):
        return [materialize(v, generator, default_dtype, device)
                for v in schema]
    dt = torch_dtype(schema.dtype or default_dtype)
    if schema.scale == 0.0:
        return torch.zeros(schema.shape, dtype=dt, device=device)
    if schema.scale == -1.0:
        return torch.ones(schema.shape, dtype=dt, device=device)
    t = torch.randn(schema.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (t * schema.scale).to(dt)


# ---------------------------------------------------------------- norms ----
def norm_schema(d, kind="rmsnorm"):
    s = {"scale": ParamSpec((d,), ("norm",), -1.0, "float32")}
    if kind == "layernorm":
        s["bias"] = ParamSpec((d,), ("norm",), 0.0, "float32")
    return s


def apply_norm(p, x, kind="rmsnorm", eps=1e-5):
    if kind == "rmsnorm":
        return K.rmsnorm(x, p["scale"], eps)
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope(x, pos, theta):
    """x: [..., S, H, hd]; pos: broadcastable to [..., S].  Rotates the two
    halves of the vector (not interleaved pairs), in fp32."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos[..., None].float() * freq                     # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      rules=None):
    """q [B,Sq,H,hd]; k,v [B,Sk,Hkv,hd]; q at q_offset+i, k at j.  The
    reference scans query chunks in pure JAX; here the flash kernel does
    the whole thing (plain version on CPU).  The reference repeats K/V to
    H heads before it constrains them; the kernel takes GQA as it is, so
    K/V are constrained by their own ``kv_heads`` (the kernel's sharding
    strategy splits heads only where both split alike)."""
    if rules is not None:
        q = constrain(q, ("batch", None, "heads", "head_dim"), rules)
        k, v = (constrain(t, ("batch", None, "kv_heads", "head_dim"), rules)
                for t in (k, v))
    return K.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos, *, window=0,
                     k_scale=None, v_scale=None):
    """q [B,1,H,hd]; caches [B,W,Hkv,hd]; pos [B] current absolute position
    (valid slots are ``<= pos``).  The dense form and the sliding-window
    ring run the decode kernel; with ``k_scale``/``v_scale`` ([B,W,Hkv,1])
    the caches hold int8 values and the kernel's int8 form runs.

    The ring (``slot = p % W``, W <= window) holds the last W positions,
    and once the ring has wrapped every slot is one of them.  Attention
    does not depend on the order of the keys, so the ring is the dense
    form over its first ``min(pos + 1, W)`` slots."""
    B, _, H, hd = q.shape
    W = k_cache.shape[1]
    if window and W > window:
        raise ValueError(f"decode_attention: a ring of {W} slots exceeds the "
                         f"window of {window}")
    lengths = pos + 1
    if window:
        lengths = torch.clamp_max(lengths, W)
    lengths = lengths.to(torch.int32)
    if k_scale is not None:
        o = K.decode_attention_int8(q[:, 0].contiguous(), k_cache, v_cache,
                                    lengths, k_scale, v_scale)
    else:
        o = K.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                               lengths)
    return o.reshape(B, 1, H, hd)


def gqa_schema(cfg):
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    s = {
        "wq": ParamSpec((D, H, hd), ("fsdp", "heads", "head_dim"), D ** -0.5),
        "wk": ParamSpec((D, Hkv, hd), ("fsdp", "kv_heads", "head_dim"), D ** -0.5),
        "wv": ParamSpec((D, Hkv, hd), ("fsdp", "kv_heads", "head_dim"), D ** -0.5),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "fsdp"), (H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), 0.0)
        s["bk"] = ParamSpec((Hkv, hd), ("kv_heads", "head_dim"), 0.0)
        s["bv"] = ParamSpec((Hkv, hd), ("kv_heads", "head_dim"), 0.0)
    return s


def head_proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)``.  Under DTensor a weight whose
    heads no mesh dim splits (kv_heads 2 over a model axis of 16, or
    rules that split no heads) is gathered whole and the product runs on
    each rank's rows of ``x`` (``_local_proj``): DTensor would split the
    product's columns (h·k) over such a mesh dim and could not unflatten
    them into heads."""
    if is_dtensor(w) and not any(p.is_shard(1) for p in w.placements):
        return _local_proj("bsd,dhk->bshk", x, w,
                           tuple(x.shape[:2]) + tuple(w.shape[1:]))
    return torch.einsum("bsd,dhk->bshk", x, w)


def out_proj(o, w):
    """``einsum("bshk,hkd->bsd", o, w)``; under DTensor with ``w``'s
    heads split by no mesh dim, on each rank's rows (``head_proj``)."""
    if is_dtensor(w) and not any(p.is_shard(0) for p in w.placements):
        return _local_proj("bshk,hkd->bsd", o, w,
                           tuple(o.shape[:2]) + tuple(w.shape[2:]))
    return torch.einsum("bshk,hkd->bsd", o, w)


def _local_proj(eq, x, w, shape):
    """``einsum(eq, x, w)`` on local shards: ``x`` keeps its batch and
    sequence splits (any other split, or a partial sum, is resolved
    first), ``w`` is whole on every rank, and the output is split as
    ``x``'s rows (``sharding.rows_local``)."""
    from repro_torch import sharding as SH
    xl, pl = SH.rows_local(x)
    return SH.from_rows(torch.einsum(eq, xl, SH.whole_local(w, pl)),
                        w.device_mesh, pl, shape)


def gqa_qkv(p, x, cfg, pos):
    q = head_proj(x, p["wq"])
    k = head_proj(x, p["wk"])
    v = head_proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.rope_theta:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def gqa_attention(p, x, cfg, *, causal=True, cross_kv=None, rules=None):
    """Full-sequence (prefill) GQA self-attention, or cross-attention over
    the given ``cross_kv = (k, v)`` -> (out, (k, v)).  Under ``cross_kv``
    the query takes ``bq`` but no rope, K and V are used as they are
    (the caller projected them, with no ``bk``/``bv``, as the reference
    does) and attention is bidirectional."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None]
    if cross_kv is not None:
        q = head_proj(x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        k, v = cross_kv
        causal = False
    else:
        q, k, v = gqa_qkv(p, x, cfg, pos)
    o = chunked_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                          rules=rules)
    return out_proj(o, p["wo"]), (k, v)


def kv_quantize(t):
    """t [..., Hkv, hd] -> (int8, f32 scale [..., Hkv, 1])."""
    f = t.float()
    s = f.abs().amax(-1, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.round(f / s).clamp(-127, 127).to(torch.int8), s


def write_slots(cache, bidx, slot, val) -> None:
    """cache[bidx[b], slot[b]] = val[b] for every row b (bidx: the rows in
    order), IN PLACE.  A DTensor cache whose batch and slot dims every
    rank holds whole (always on one card) takes ``index_put_`` into its
    local shard, ``val`` placed as the cache's other dims are; one split
    over batch or slots takes ``masked_write``, which DTensor runs under
    any split."""
    if not is_dtensor(cache):
        cache.index_put_((bidx, slot), val)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.device_mesh
    split = [isinstance(p, Shard) and mesh.size(i) > 1
             for i, p in enumerate(cache.placements)]
    if any(s and p.dim < 2 for s, p in zip(split, cache.placements)):
        masked_write(cache, slot, val)
        return
    want = [Shard(p.dim - 1) if s else Replicate()
            for s, p in zip(split, cache.placements)]
    if not is_dtensor(val):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if is_dtensor(slot):
        slot = slot.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    cache.to_local().index_put_(
        (bidx, slot), val.redistribute(mesh, want).to_local().to(cache.dtype))


def masked_write(cache, slot, val) -> None:
    """cache[b, slot[b]] = val[b] for every row b, IN PLACE, as one
    elementwise select over the whole cache (reads and writes every slot:
    what a cache split over batch or slots pays a decode step)."""
    hit = torch.arange(cache.shape[1], device=slot.device)[None] \
        == slot[:, None]
    hit = hit.reshape(hit.shape + (1,) * (cache.ndim - 2))
    cache.copy_(torch.where(hit, val[:, None].to(cache.dtype), cache))


def gqa_decode(p, x, cfg, cache, pos):
    """x [B,1,D]; cache {'k','v'[, 'k_s','v_s']} of one layer -> (out,
    cache).  The new K/V row is written into the cache tensors IN PLACE
    (the reference donates the caches and scatters with ``.at[].set``):
    rows past a sequence's committed position are never read, which is
    also what makes rollback-by-not-applying sound."""
    q, k, v = gqa_qkv(p, x, cfg, pos[:, None])
    W = cache["k"].shape[1]
    slot = (pos % W if cfg.sliding_window else pos).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    if cfg.kv_quant:
        kq, ks = kv_quantize(k[:, 0])
        vq, vs = kv_quantize(v[:, 0])
        for name, val in (("k", kq), ("k_s", ks), ("v", vq), ("v_s", vs)):
            write_slots(cache[name], bidx, slot, val)
        o = decode_attention(q, cache["k"], cache["v"], pos,
                             window=cfg.sliding_window,
                             k_scale=cache["k_s"], v_scale=cache["v_s"])
    else:
        write_slots(cache["k"], bidx, slot, k[:, 0])
        write_slots(cache["v"], bidx, slot, v[:, 0])
        o = decode_attention(q, cache["k"], cache["v"], pos,
                             window=cfg.sliding_window)
    return out_proj(o, p["wo"]), cache


# ------------------------------------------------------------------ MLA ----
def mla_schema(cfg):
    D, H = cfg.d_model, cfg.num_heads
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamSpec((D, H, qk), ("fsdp", "heads", "head_dim"), D ** -0.5),
        "w_dkv": ParamSpec((D, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("fsdp", "kv_lora"), D ** -0.5),
        "kv_norm": norm_schema(m.kv_lora_rank),
        "w_uk": ParamSpec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                          ("kv_lora", "heads", "head_dim"),
                          m.kv_lora_rank ** -0.5),
        "w_uv": ParamSpec((m.kv_lora_rank, H, m.v_head_dim),
                          ("kv_lora", "heads", "head_dim"),
                          m.kv_lora_rank ** -0.5),
        "wo": ParamSpec((H, m.v_head_dim, D), ("heads", "head_dim", "fsdp"),
                        (H * m.v_head_dim) ** -0.5),
    }


def _mla_latent(p, x, cfg, pos):
    """x [B,S,D] -> (normed latent c_kv [B,S,R], roped k_rope [B,S,rope])."""
    R = cfg.mla.kv_lora_rank
    ckr = grad_like(torch.einsum("bsd,dr->bsr", x, p["w_dkv"]))
    c_kv = apply_norm(p["kv_norm"], ckr[..., :R].contiguous())
    k_rope = rope(ckr[..., R:][:, :, None, :], pos, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_q(p, x, cfg, pos):
    m = cfg.mla
    q = head_proj(x, p["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, rope(q_rope, pos, cfg.rope_theta)


def mla_attention(p, x, cfg, rules=None):
    """Prefill: decompress the latent to per-head K/V and run the flash
    kernel at hd = nope + rope, hd_v = v_head_dim -> (out, (c_kv, k_rope))."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None]
    q_nope, q_rope = _mla_q(p, x, cfg, pos)
    c_kv, k_rope = _mla_latent(p, x, cfg, pos)
    k_nope = head_proj(c_kv, p["w_uk"])
    v = head_proj(c_kv, p["w_uv"])
    H = cfg.num_heads
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, -1)], -1)
    o = chunked_attention(torch.cat([q_nope, q_rope], -1), k, v, causal=True,
                          rules=rules)
    return out_proj(o, p["wo"]), (c_kv, k_rope)


def mla_decode(p, x, cfg, cache_c, cache_kr, pos):
    """The reference's absorbed-matrices decode: scores and values in the
    latent space, fp32 scores, plain PyTorch (the reference runs it outside
    any Pallas kernel).  The new latent row is written into ``cache_c`` and
    ``cache_kr`` IN PLACE -> (out [B,1,D], cache_c, cache_kr)."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None])
    c_kv, k_rope = _mla_latent(p, x, cfg, pos[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    write_slots(cache_c, bidx, pos.long(), c_kv[:, 0])
    write_slots(cache_kr, bidx, pos.long(), k_rope[:, 0])
    # absorb W_uk into q: q_lat [B,H,R]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["w_uk"])
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), cache_c.float())
    s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(),
                         cache_kr.float())
    s = s * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    valid = torch.arange(cache_c.shape[1], device=x.device)[None] \
        <= pos[:, None]
    a = masked_softmax(s, valid[:, None])
    ctx = torch.einsum("bhs,bsr->bhr", a.to(cache_c.dtype).float(),
                       cache_c.float()).to(x.dtype)
    o = torch.einsum("bhr,rhk->bhk", ctx, p["w_uv"])
    out = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None]
    return out, cache_c, cache_kr


# ------------------------------------------------------------------ MLP ----
def mlp_schema(cfg, d_ff=None):
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    s = {"w2": ParamSpec((F_, D), ("ffn", "fsdp"), F_ ** -0.5)}
    if cfg.act == "silu":
        s["w1"] = ParamSpec((D, F_), ("fsdp", "ffn"), D ** -0.5)
        s["w3"] = ParamSpec((D, F_), ("fsdp", "ffn"), D ** -0.5)
    else:
        s["w1"] = ParamSpec((D, F_), ("fsdp", "ffn"), D ** -0.5)
        if cfg.mlp_bias:
            s["b1"] = ParamSpec((F_,), ("ffn",), 0.0)
            s["b2"] = ParamSpec((D,), ("norm",), 0.0)
    return s


def apply_mlp(p, x, cfg, rules=None):
    cst = (lambda t: constrain(t, ("batch", None, "ffn"), rules)) \
        if (rules is not None and x.ndim == 3) else (lambda t: t)
    if "w3" in p:
        h = cst(F.silu(x @ p["w1"])) * cst(x @ p["w3"])
    else:
        h = x @ p["w1"]
        if "b1" in p:       # an fp32 bias keeps a bf16 stream bf16
            h = h + p["b1"].to(h.dtype)
        h = cst(F.gelu(h, approximate="tanh"))   # jax.nn.gelu's default
    y = h @ p["w2"]
    if "b2" in p:
        y = y + p["b2"].to(y.dtype)
    return y
