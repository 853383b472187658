"""Core layers of the dense model: schemas, norms, RoPE, attention, MLP.

Counterpart of ``repro/models/layers.py`` (dense subset).  Params are
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
    grad: the port serves, it does not train yet."""

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
def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q [B,Sq,H,hd]; k,v [B,Sk,Hkv,hd]; q at q_offset+i, k at j.  The
    reference scans query chunks in pure JAX; here the flash kernel does
    the whole thing (plain version on CPU)."""
    return K.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos, *, window=0,
                     k_scale=None, v_scale=None):
    """q [B,1,H,hd]; caches [B,W,Hkv,hd]; pos [B] current absolute position
    (valid slots are ``<= pos``).  The dense form runs the decode kernel;
    the SWA ring and int8 forms have no kernel yet and run only on CPU."""
    B, _, H, hd = q.shape
    lengths = (pos + 1).to(torch.int32)
    if window or k_scale is not None:
        if q.device.type != "cpu":
            raise NotImplementedError(
                "decode_attention: the sliding-window ring and int8-cache "
                "forms have no CUDA kernel yet (ROADMAP Queue 2, item 2)")
        o = K.decode_attention_plain(q[:, 0], k_cache, v_cache, lengths,
                                     window=window, k_scale=k_scale,
                                     v_scale=v_scale)
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


def gqa_qkv(p, x, cfg, pos):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.rope_theta:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def gqa_attention(p, x, cfg, *, causal=True):
    """Full-sequence (prefill) GQA self-attention -> (out, (k, v))."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None]
    q, k, v = gqa_qkv(p, x, cfg, pos)
    o = chunked_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), (k, v)


def kv_quantize(t):
    """t [..., Hkv, hd] -> (int8, f32 scale [..., Hkv, 1])."""
    f = t.float()
    s = f.abs().amax(-1, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.round(f / s).clamp(-127, 127).to(torch.int8), s


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
            cache[name].index_put_((bidx, slot), val)
        o = decode_attention(q, cache["k"], cache["v"], pos,
                             window=cfg.sliding_window,
                             k_scale=cache["k_s"], v_scale=cache["v_s"])
    else:
        cache["k"].index_put_((bidx, slot), k[:, 0])
        cache["v"].index_put_((bidx, slot), v[:, 0])
        o = decode_attention(q, cache["k"], cache["v"], pos,
                             window=cfg.sliding_window)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


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


def apply_mlp(p, x, cfg):
    if "w3" in p:
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = x @ p["w1"]
        if "b1" in p:
            h = h + p["b1"]
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    y = h @ p["w2"]
    if "b2" in p:
        y = y + p["b2"]
    return y
