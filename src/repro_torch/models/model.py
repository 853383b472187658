"""Stage-structured model: the dense, moe (GQA + MoE, mixtral), MLA
(deepseek: ``mla_dense``, ``mla_moe``), hybrid (zamba2), ssm (xLSTM),
audio (whisper: ``enc``, ``dec``) and vlm (phi-3-vision: the dense stage
behind an image prefix) stages.

Counterpart of ``repro/models/model.py``.  A model is a list of stages;
where the reference scans each stage over params stacked on a leading
axis, the port keeps a stage as an ``nn.ModuleList`` of blocks and loops
over it, and does the same for the blocks the reference stacks a second
time inside a group (zamba2's ``mambas``, xLSTM's ``m``).  Caches keep the
reference's layout leaf for leaf: one dict per stage with a leading layer
(group) axis when the stage has more than one block, and a second stacked
axis for the in-group blocks (``[n_groups, 6, B, ...]``).  Decode updates
the caches in place.

The audio family runs its encoder over precomputed frames ``[B, enc_S,
D]`` (the conv frontend is a stub in the reference too) and caches each
decoder block's cross-attention K/V (``xk``, ``xv``) at prefill; the vlm
family puts ``image_embeds @ img_proj`` before the text, so its decode
positions count the image prefix.  Int8 serving weights
(``serving/quant.py``: ``{"q", "s"}`` leaves) are dequantized by
``_maybe_dequant`` one block at a time inside the loop over blocks, and
the top-level leaves (embed, head, zamba2's shared block) once a call,
as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.serving import quant as Q


def _maybe_dequant(p):
    """Dequantize int8 serving weights ({'q','s'} leaves) -- inside the
    loop over blocks, so only one layer's weights are bf16 at a time
    (``serving/quant.py``); a tree without them is returned as it is."""
    return Q.dequantize(p) if Q.has_quantized(p) else p


def _dequant_top(params):
    """The top-level leaves dequantized, the stages left as they are."""
    return {k: params[k] if k == "stages" else _maybe_dequant(params[k])
            for k in params.keys()}


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


MLA_KINDS = ("mla_dense", "mla_moe")    # deepseek: MLA attention
MOE_KINDS = ("moe", "mla_moe")          # routed experts in place of the MLP
XLSTM_ORDER = (0, 1, 2, None, 3, 4)   # None: the sLSTM (in-group index 3)


def _block_schema(cfg: ModelConfig, kind: str):
    nrm = lambda: L.norm_schema(cfg.d_model, cfg.norm)
    if kind in MOE_KINDS:
        attn = L.mla_schema(cfg) if kind in MLA_KINDS else L.gqa_schema(cfg)
        return {"ln1": nrm(), "attn": attn, "ln2": nrm(),
                "moe": MOE.moe_schema(cfg)}
    if kind == "mla_dense":
        return {"ln1": nrm(), "attn": L.mla_schema(cfg), "ln2": nrm(),
                "mlp": L.mlp_schema(cfg, cfg.dense_first_layer_d_ff
                                    or cfg.d_ff)}
    if kind == "zamba_group":
        return {"mambas": [{"ln1": nrm(), "mamba": SSM.mamba2_schema(cfg)}
                           for _ in range(cfg.shared_every)]}
    if kind == "xlstm_group":
        return {"m": [{"ln1": nrm(), "cell": XL.mlstm_schema(cfg)}
                      for _ in range(5)],
                "s": {"ln1": nrm(), "cell": XL.slstm_schema(cfg)}}
    if kind == "dec":
        return {"ln1": nrm(), "attn": L.gqa_schema(cfg),
                "lnx": nrm(), "xattn": L.gqa_schema(cfg),
                "ln2": nrm(), "mlp": L.mlp_schema(cfg)}
    assert kind in ("dense", "enc"), kind
    s = {"ln1": nrm(), "attn": L.gqa_schema(cfg)}
    if not cfg.parallel_block:
        s["ln2"] = nrm()
    s["mlp"] = L.mlp_schema(cfg)
    return s


def model_schema(cfg: ModelConfig):
    """The reference's schema with each stage as a list of per-block
    schemas instead of one stacked schema (and lists for the blocks stacked
    inside a group)."""
    D, V = cfg.d_model, cfg.vocab_size
    s: Dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "fsdp"), D ** -0.5),
        "final_norm": L.norm_schema(D, cfg.norm),
        "stages": [[_block_schema(cfg, st.kind) for _ in range(st.n)]
                   for st in build_stages(cfg)],
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((D, V), ("fsdp", "vocab"), D ** -0.5)
    if cfg.family == "hybrid":  # zamba2 shared attention block (per group)
        s["shared"] = {"ln1": L.norm_schema(D, cfg.norm),
                       "attn": L.gqa_schema(cfg),
                       "ln2": L.norm_schema(D, cfg.norm),
                       "mlp": L.mlp_schema(cfg)}
    if cfg.family == "audio":
        s["enc_pos"] = ParamSpec((cfg.encdec.encoder_seq, D),
                                 ("seq", "fsdp"), 0.02)
        s["dec_pos"] = ParamSpec((cfg.max_seq, D), ("seq", "fsdp"), 0.02)
    if cfg.family == "vlm":
        s["img_proj"] = ParamSpec((D, D), ("fsdp", None), D ** -0.5)
    return s


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random params from the schema's scales, drawn on ``device`` from a
    seeded ``torch.Generator``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return L.to_module(L.materialize(model_schema(cfg), gen, cfg.dtype,
                                     device))


def schema_map(fn, schema):
    """``fn`` of every ParamSpec of a model schema, in its structure."""
    return pytree.tree_map(fn, schema,
                           is_leaf=lambda x: isinstance(x, ParamSpec))


def abstract_params(cfg: ModelConfig):
    """The params' shapes and dtypes as meta tensors, in the port's
    structure (the reference's ``jax.ShapeDtypeStruct`` tree): no memory
    is allocated."""
    return schema_map(lambda sp: torch.empty(
        sp.shape, dtype=L.torch_dtype(sp.dtype or cfg.dtype), device="meta"),
        model_schema(cfg))


def param_axes(cfg: ModelConfig):
    """The logical axis names of every param, in the port's structure (a
    per-block stage carries no ``stack`` axis)."""
    return schema_map(lambda sp: sp.axes, model_schema(cfg))


# -------------------------------------------------------------- forward ----
def _tree_stack(trees: list):
    """Stack a list of like cache trees leaf by leaf on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _whole_seq(h, rules):
    """A sublayer's input as the sublayer works on it.  Under the train
    rules the residual stream is split on ``seq`` (the reference's
    Megatron-style constraint); inside a sublayer the reference's
    constraints split heads and ffn instead, and the sequence is whole:
    gathered on entry (and its gradient split again on the way back), so
    that DTensor can flatten batch and sequence into a product's rows."""
    return SH.constrain(h, ("batch", None, None), rules)


def _norm_in(p_norm, h, cfg, rules):
    """A sublayer's normed input: normed on the residual's split, then
    whole on ``seq`` (``_whole_seq``)."""
    return _whole_seq(L.apply_norm(p_norm, h, cfg.norm), rules)


def _sub_out(y, rules):
    """A sublayer's output as the residual takes it: its partial sums over
    the split heads or ffn reduced onto the ``seq`` split (Megatron's
    reduce-scatter).  Explicit, so that its gradient comes back whole on
    ``seq`` (DTensor's backward of a partial-to-split redistribution is a
    gather): a product whose gradient arrives split on ``seq`` would
    flatten it into strided shards."""
    return SH.constrain(y, ("batch", "seq", None), rules)


def _cross_attention(p, h, enc_out, cfg, rules=None):
    """A ``dec`` block's cross-attention over the encoder's output ->
    (out, (xk, xv)).  The reference projects the encoder's K/V with no
    bk/bv (ROADMAP Queue 3)."""
    hx = _norm_in(p["lnx"], h, cfg, rules)
    xk = L.head_proj(enc_out, p["xattn"]["wk"])
    xv = L.head_proj(enc_out, p["xattn"]["wv"])
    return L.gqa_attention(p["xattn"], hx, cfg, cross_kv=(xk, xv),
                           rules=rules)


def _cross_decode(p, h, cache, cfg):
    """A ``dec`` block's cross-attention at decode, over every encoder
    frame of its cache; the reference's query takes no bq here, though
    its prefill adds it (ROADMAP Queue 3)."""
    hx = L.apply_norm(p["lnx"], h, cfg.norm)
    q = L.head_proj(hx, p["xattn"]["wq"])
    xk = cache["xk"]
    pos = torch.full((h.shape[0],), xk.shape[1] - 1, dtype=torch.int32,
                     device=h.device)
    o = L.decode_attention(q, xk, cache["xv"], pos)
    return L.out_proj(o, p["xattn"]["wo"])


def _block_forward(kind, p, h, cfg, shared=None, enc_out=None, rules=None):
    """Full-sequence forward for one block -> (h, aux_loss, cache_out).
    A ``dec`` block cross-attends to ``enc_out``.  Under ``rules`` the
    residual stream leaves the block as ("batch", "seq", None)."""
    h, aux, cache_out = _block_body(kind, p, h, cfg, shared, enc_out, rules)
    return SH.constrain(h, ("batch", "seq", None), rules), aux, cache_out


def _block_body(kind, p, h, cfg, shared, enc_out, rules):
    p = _maybe_dequant(p)
    if kind == "zamba_group":
        states = []
        for pm in p["mambas"]:
            y, st = SSM.mamba2_forward(pm["mamba"],
                                       _norm_in(pm["ln1"], h, cfg, rules),
                                       cfg, rules)
            states.append(st)
            h = h + _sub_out(y, rules)
        a, (k, v) = L.gqa_attention(shared["attn"],
                                    _norm_in(shared["ln1"], h, cfg, rules),
                                    cfg, rules=rules)
        h = h + _sub_out(a, rules)
        h = h + _sub_out(L.apply_mlp(shared["mlp"],
                                     _norm_in(shared["ln2"], h, cfg, rules),
                                     cfg, rules), rules)
        return h, 0.0, {"mamba": _tree_stack(states),
                        "attn": {"k": k, "v": v}}
    if kind == "xlstm_group":
        m_states, s_state = [], None
        for idx in XLSTM_ORDER:
            if idx is None:
                y, s_state = XL.slstm_forward(
                    p["s"]["cell"], _norm_in(p["s"]["ln1"], h, cfg, rules),
                    cfg, rules)
            else:
                pm = p["m"][idx]
                y, (C, n) = XL.mlstm_forward(
                    pm["cell"], _norm_in(pm["ln1"], h, cfg, rules), cfg,
                    rules)
                m_states.append({"C": C, "n": n})
            h = h + _sub_out(y, rules)
        return h, 0.0, {"m": _tree_stack(m_states),
                        "s": dict(zip(("h", "c", "n", "m"), s_state))}
    hn = _norm_in(p["ln1"], h, cfg, rules)
    if kind in MLA_KINDS:
        a, (c_kv, k_rope) = L.mla_attention(p["attn"], hn, cfg, rules)
        cache_out = {"c": c_kv, "kr": k_rope}
    else:
        a, (k, v) = L.gqa_attention(p["attn"], hn, cfg,
                                    causal=kind != "enc", rules=rules)
        cache_out = {"k": k, "v": v}
    if cfg.parallel_block:
        return (h + _sub_out(a, rules)
                + _sub_out(L.apply_mlp(p["mlp"], hn, cfg, rules), rules),
                0.0, cache_out)
    h = h + _sub_out(a, rules)
    if kind == "dec":
        a, (xk, xv) = _cross_attention(p, h, enc_out, cfg, rules)
        h = h + _sub_out(a, rules)
        cache_out.update(xk=xk, xv=xv)
    hn2 = _norm_in(p["ln2"], h, cfg, rules)
    aux = 0.0
    if kind in MOE_KINDS:
        m, aux = MOE.apply_moe(p["moe"], hn2, cfg, rules=rules)
    else:
        m = L.apply_mlp(p["mlp"], hn2, cfg, rules)
    return h + _sub_out(m, rules), aux, cache_out


# aten's matrix products: what the reference's "dots" policy saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)
REMAT = ("none", "full", "dots", "minimal")


def _save_dots(ctx, op, *args, **kwargs):
    P = ckpt.CheckpointPolicy
    return P.MUST_SAVE if op in _DOTS else P.PREFER_RECOMPUTE


def _save_all(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE


def _remat_block(remat: str):
    """``_block_forward`` under the reference's ``_remat_policy``: each
    block runs in ``torch.utils.checkpoint`` (non-reentrant).  "full"
    saves nothing inside the block and recomputes it in the backward
    (``nothing_saveable``); "dots" saves the matrix products' outputs and
    recomputes the rest (``dots_with_no_batch_dims_saveable``); "minimal"
    saves everything (``everything_saveable``); "none" runs plainly.  All
    four give the same loss and gradients."""
    if remat == "none":
        return _block_forward
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    policy = {"full": None, "dots": _save_dots, "minimal": _save_all}[remat]
    context_fn = ckpt.noop_context_fn if policy is None else \
        (lambda: ckpt.create_selective_checkpoint_contexts(policy))

    def block(*args):
        return ckpt.checkpoint(_block_forward, *args, use_reentrant=False,
                               context_fn=context_fn)
    return block


def _lookup_table(embed, rules):
    """The embedding table as the lookup reads it: under ``rules`` whole
    over the vocab (gathered from its ``vocab`` split), since DTensor's
    vocab-parallel lookup leaves a masked partial sum that it cannot
    reduce once the tokens are split on ``batch`` too."""
    return SH.constrain(embed, (None, "fsdp"), rules)


def forward(params, cfg: ModelConfig, batch: Dict[str, Any],
            collect_cache: bool = False, remat: str = "none", rules=None):
    """Full-sequence forward -> (logits [B,S,V], aux_loss[, kv_stacks]).

    batch: tokens [B,S]; audio adds frames [B,enc_S,D]; vlm adds image
    embeds [B,n_img,D] put before the text (their rows are dropped before
    the head).  With ``collect_cache`` each stage's K/V or final
    recurrent states (with a leading layer axis when the stage has
    several blocks) are returned for ``assemble_caches``.  ``remat``
    (``REMAT``) checkpoints each block as the reference's ``jax.checkpoint``
    of its scan body does (``_remat_block``).  ``rules`` (``sharding.py``)
    constrains the activations at the reference's sites; on plain tensors
    it changes nothing."""
    block_forward = _remat_block(remat)
    params = _dequant_top(params)
    h = F.embedding(batch["tokens"], _lookup_table(params["embed"], rules))
    h = SH.constrain(h, ("batch", "seq", None), rules)
    n_img = 0
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = batch["image_embeds"].to(h.dtype) @ params["img_proj"]
        h = torch.cat([img, h], 1)
        n_img = img.shape[1]
    enc_out = None
    if cfg.family == "audio":
        h_dec = h + params["dec_pos"][:h.shape[1]].to(h.dtype)
        enc_out = batch["frames"].to(h.dtype) + params["enc_pos"].to(h.dtype)
        h = enc_out                 # the first stage is the encoder
    shared = params["shared"] if "shared" in params else None
    kv_stacks = []
    aux_total = 0.0
    for st, blocks in zip(build_stages(cfg), params["stages"]):
        if st.kind == "dec":        # the encoder's output feeds cross-attn
            enc_out, h = h, h_dec
        outs = []
        for p in blocks:
            h, aux, out = block_forward(st.kind, p, h, cfg, shared, enc_out,
                                        rules)
            aux_total = aux_total + aux
            if collect_cache:
                outs.append(out)
        if collect_cache:
            kv_stacks.append(outs[0] if len(outs) == 1 else _tree_stack(outs))
    h = L.apply_norm(params["final_norm"], _whole_seq(h, rules), cfg.norm)
    if n_img:
        h = h[:, n_img:]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", h, head) * cfg.logit_scale
    logits = SH.constrain(logits, ("batch", "seq", "vocab"), rules)
    if collect_cache:
        return logits, aux_total, kv_stacks
    return logits, aux_total


# --------------------------------------------------------------- decode ----
def _stack_state(state, n: int):
    """``state`` repeated on a new leading axis of n (itself when n == 1)."""
    return state if n == 1 else _tree_stack([state] * n)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_S: int = 0,
               device="cuda"):
    """Cache per stage (leading layer axis when the stage has n > 1).  A
    ``dec`` stage adds its cross-attention K/V over ``enc_S`` encoder
    frames, stacked on the layer axis even when n == 1, as the
    reference's are."""
    device = resolve_device(device)
    dt = L.torch_dtype(cfg.dtype)
    Hkv, hd = cfg.num_kv_heads, cfg.hd()
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len

    def kv(n, w=W):
        shape = (batch, w, Hkv, hd) if n == 1 else (n, batch, w, Hkv, hd)
        z = lambda shp, t: torch.zeros(shp, dtype=t, device=device)
        if cfg.kv_quant:
            sshape = shape[:-1] + (1,)
            return {"k": z(shape, torch.int8), "k_s": z(sshape, torch.float32),
                    "v": z(shape, torch.int8), "v_s": z(sshape, torch.float32)}
        return {"k": z(shape, dt), "v": z(shape, dt)}

    caches = []
    for st in build_stages(cfg):
        if st.kind == "zamba_group":
            m = SSM.mamba2_init_state(cfg, batch, dt, device)
            caches.append({
                "mamba": _stack_state(_stack_state(m, cfg.shared_every), st.n),
                "attn": kv(st.n, w=cache_len)})
        elif st.kind == "xlstm_group":
            caches.append({
                "m": _stack_state(_stack_state(
                    XL.mlstm_init_state(cfg, batch, device), 5), st.n),
                "s": _stack_state(XL.slstm_init_state(cfg, batch, device),
                                  st.n)})
        elif st.kind in MLA_KINDS:
            m = cfg.mla
            pre = () if st.n == 1 else (st.n,)
            caches.append({
                "c": torch.zeros(pre + (batch, cache_len, m.kv_lora_rank),
                                 dtype=dt, device=device),
                "kr": torch.zeros(pre + (batch, cache_len,
                                         m.qk_rope_head_dim),
                                  dtype=dt, device=device)})
        elif st.kind == "dec":
            c = kv(st.n)
            xshape = (st.n, batch, enc_S, Hkv, hd)
            c["xk"] = torch.zeros(xshape, dtype=dt, device=device)
            c["xv"] = torch.zeros(xshape, dtype=dt, device=device)
            caches.append(c)
        else:
            caches.append(kv(st.n))
    return caches


def cache_axes(cfg: ModelConfig):
    """Logical axes mirroring ``init_cache`` (the reference's names)."""
    kv = ("batch", "kv_seq", "kv_heads", "head_dim")
    names = ("k", "k_s", "v", "v_s") if cfg.kv_quant else ("k", "v")
    kv_entry = lambda pre: {name: pre + kv for name in names}
    axes = []
    for s in build_stages(cfg):
        pre = () if s.n == 1 else ("stack",)
        if s.kind == "zamba_group":
            m = pre + (None,)
            axes.append({"mamba": {"ssm": m + ("batch", "ssm_heads", None,
                                               None),
                                   "conv": {"x": m + ("batch", None,
                                                      "ssm_inner"),
                                            "bc": m + ("batch", None, None)}},
                         "attn": kv_entry(pre)})
        elif s.kind == "xlstm_group":
            axes.append({"m": {"C": pre + (None, "batch", "ssm_heads", None,
                                           None),
                               "n": pre + (None, "batch", "ssm_heads", None)},
                         "s": {k: pre + ("batch", "ssm_heads", None)
                               for k in ("h", "c", "n", "m")}})
        elif s.kind in MLA_KINDS:
            axes.append({"c": pre + ("batch", "kv_seq", "kv_lora"),
                         "kr": pre + ("batch", "kv_seq", None)})
        elif s.kind == "dec":
            axes.append(dict(kv_entry(pre), xk=pre + kv, xv=pre + kv))
        else:
            axes.append(kv_entry(pre))
    return axes


def _index(tree, i: int):
    """The i-th slice (a view) of every leaf of a cache tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _assign(dst, src) -> None:
    """Write the leaves of ``src`` into the cache views ``dst`` in place."""
    if isinstance(dst, dict):
        for k in dst:
            _assign(dst[k], src[k])
    else:
        dst.copy_(src)


def _block_decode(kind, p, h, cache, pos, cfg, shared=None, rules=None):
    """Single-token decode for one block.  h [B,1,D]; ``cache`` is the
    block's cache, updated in place."""
    p = _maybe_dequant(p)
    if kind == "zamba_group":
        for i, pm in enumerate(p["mambas"]):
            ci = _index(cache["mamba"], i)
            hn = L.apply_norm(pm["ln1"], h, cfg.norm)
            y, new = SSM.mamba2_decode(pm["mamba"], hn, cfg, ci)
            _assign(ci, new)
            h = h + y
        hn = L.apply_norm(shared["ln1"], h, cfg.norm)
        a, _ = L.gqa_decode(shared["attn"], hn, cfg, cache["attn"], pos)
        h = h + a
        hn = L.apply_norm(shared["ln2"], h, cfg.norm)
        return h + L.apply_mlp(shared["mlp"], hn, cfg, rules)
    if kind == "xlstm_group":
        for idx in XLSTM_ORDER:
            if idx is None:
                hn = L.apply_norm(p["s"]["ln1"], h, cfg.norm)
                y, new = XL.slstm_decode(p["s"]["cell"], hn, cfg, cache["s"])
                _assign(cache["s"], new)
            else:
                ci = _index(cache["m"], idx)
                hn = L.apply_norm(p["m"][idx]["ln1"], h, cfg.norm)
                y, new = XL.mlstm_decode(p["m"][idx]["cell"], hn, cfg, ci)
                _assign(ci, new)
            h = h + y
        return h
    hn = L.apply_norm(p["ln1"], h, cfg.norm)
    if kind in MLA_KINDS:
        a, _, _ = L.mla_decode(p["attn"], hn, cfg, cache["c"], cache["kr"],
                               pos)
    else:
        a, _ = L.gqa_decode(p["attn"], hn, cfg, cache, pos)
    if cfg.parallel_block:
        return h + a + L.apply_mlp(p["mlp"], hn, cfg, rules)
    h = h + a
    if kind == "dec":
        h = h + _cross_decode(p, h, cache, cfg)
    hn2 = L.apply_norm(p["ln2"], h, cfg.norm)
    if kind in MOE_KINDS:
        return h + MOE.apply_moe(p["moe"], hn2, cfg)[0]
    return h + L.apply_mlp(p["mlp"], hn2, cfg, rules)


def decode_step(params, cfg: ModelConfig, tokens, pos, caches, rules=None):
    """tokens [B], pos [B] -> (logits [B,V], caches).  The caches are
    updated in place and returned; ``rules`` as in ``forward``."""
    params = _dequant_top(params)
    h = F.embedding(tokens[:, None], _lookup_table(params["embed"], rules))
    if cfg.family == "audio":
        # a lookup, as the tokens' (DTensor indexes a split pos no other way
        # in torch 2.11)
        h = h + F.embedding(pos.long()[:, None],
                            params["dec_pos"]).to(h.dtype)
    shared = params["shared"] if "shared" in params else None
    for st, blocks, cache in zip(build_stages(cfg), params["stages"], caches):
        if st.kind == "enc":        # the encoder does not run at decode
            continue
        for i, p in enumerate(blocks):
            layer = cache if st.n == 1 else _index(cache, i)
            h = _block_decode(st.kind, p, h, layer, pos, cfg, shared, rules)
    h = L.apply_norm(params["final_norm"], h, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (h[:, 0] @ head) * cfg.logit_scale
    return SH.constrain(logits, ("batch", "vocab"), rules), caches


def _pad_kv(kv, cache_len, window):
    """kv [..., S, H, hd] -> cache [..., W, H, hd] (ring layout for SWA)."""
    S = kv.shape[-3]
    if window and S >= window:
        tail = kv[..., S - window:, :, :]
        return torch.roll(tail, S % window, dims=-3)
    W = min(cache_len, window) if window else cache_len
    if W < S:   # F.pad would crop; the reference's jnp.pad raises
        raise ValueError(f"a cache of {W} slots is shorter than the {S} "
                         f"positions it must hold")
    return SH.pad(kv, (0, 0, 0, 0, 0, W - S))


def assemble_caches(cfg: ModelConfig, kv_stacks, cache_len: int,
                    seq_len: int):
    """Turn ``forward(collect_cache=True)`` outputs into decode caches:
    K/V padded to the cache length, recurrent states as they are."""
    W = cfg.sliding_window

    def kv_assemble(k, v):
        if cfg.kv_quant:
            kq, ks = L.kv_quantize(k)
            vq, vs = L.kv_quantize(v)
            return {"k": _pad_kv(kq, cache_len, W),
                    "k_s": _pad_kv(ks, cache_len, W),
                    "v": _pad_kv(vq, cache_len, W),
                    "v_s": _pad_kv(vs, cache_len, W)}
        return {"k": _pad_kv(k, cache_len, W), "v": _pad_kv(v, cache_len, W)}

    caches = []
    for st, kvs in zip(build_stages(cfg), kv_stacks):
        if st.kind == "zamba_group":
            caches.append({"mamba": kvs["mamba"],
                           "attn": kv_assemble(kvs["attn"]["k"],
                                               kvs["attn"]["v"])})
        elif st.kind == "xlstm_group":
            caches.append(kvs)
        elif st.kind in MLA_KINDS:   # [.., S, R] -> [.., W, R]
            caches.append({name: SH.pad(t, (0, 0, 0,
                                            cache_len - t.shape[-2]))
                           for name, t in kvs.items()})
        elif st.kind == "dec":
            caches.append(dict(kv_assemble(kvs["k"], kvs["v"]),
                               xk=kvs["xk"], xv=kvs["xv"]))
        else:
            caches.append(kv_assemble(kvs["k"], kvs["v"]))
    return caches


def prefill(params, cfg: ModelConfig, batch, cache_len: int, rules=None):
    """Full-sequence forward + populated decode caches ->
    (logits [B,S,V], caches)."""
    logits, _aux, kv_stacks = forward(params, cfg, batch, collect_cache=True,
                                      rules=rules)
    S = batch["tokens"].shape[1]
    if cfg.family == "vlm" and "image_embeds" in batch:
        S += batch["image_embeds"].shape[1]   # the image prefix is cached
    caches = assemble_caches(cfg, kv_stacks, max(cache_len, S), S)
    return logits, caches


__all__ = ["ModelConfig", "StageDef", "build_stages", "model_schema",
           "init_params", "abstract_params", "param_axes", "forward", "decode_step", "init_cache",
           "cache_axes", "prefill", "assemble_caches"]
