"""Step factories: train_step, prefill_step, decode_step and the fused
k-step decode.

Counterpart of ``repro/training/steps.py``.  The reference jits these; the
port runs them eagerly, so the fused decode's ``lax.scan`` over k is a
Python loop here.  Every step keeps its outputs on the device of its
inputs: nothing is read back to the host inside a step.

Every factory takes the reference's ``rules`` (``sharding.rules_for``) as
a keyword.  With ``rules=None``, or on plain tensors, a step runs on
plain tensors alone.  With rules and params (or a train state, or
caches) that are DTensors, placed by ``sharding.shardings_for`` /
``runtime.elastic.reshard_state``, the step runs under their mesh
(``sharding.set_mesh``):
the batch, tokens and positions, which every rank holds whole, become
DTensors split on ``batch``, the model constrains its activations at the
reference's sites, every custom op runs its kernel on the local shards
(its registered sharding strategy), and the step returns its metrics,
tokens and logits as whole plain tensors, while the state and the caches
stay DTensors.

A train step differentiates the loss with ``torch.autograd`` through the
custom ops' registered backwards: on the card ``rmsnorm``,
``flash_attention``, the two chunk scans (``mamba_chunk_scan``,
``mlstm_chunk_scan``) and ``moe_gmm`` launch their backward kernels, so
every family trains: dense, vlm, audio, hybrid, ssm and moe (the
routing, dispatch and combine of ``models/moe.py`` differentiate in plain
PyTorch around ``moe_gmm``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_update


def _mesh_scope(tree, rules):
    """(mesh, context): the mesh of ``tree``'s DTensors under ``rules``
    and ``set_mesh`` of it, or (None, a no-op context)."""
    mesh = SH.mesh_of(tree) if rules is not None else None
    return mesh, (SH.set_mesh(mesh) if mesh is not None
                  else contextlib.nullcontext())


def _placed(tree, mesh, rules):
    """The plain tensors of a batch (or tokens, positions) on the mesh."""
    if mesh is None:
        return tree
    return pytree.tree_map(lambda t: SH.to_mesh(t, mesh, rules), tree)


def _plain(tree, mesh):
    return tree if mesh is None else SH.to_plain(tree)


def _whole_vocab(logits, rules):
    """Logits [B, V] whole over the vocab on every rank before the argmax
    (DTensor's argmax over a split vocab fails on a batch it cannot
    split, as a long context's batch of 1)."""
    return SH.constrain(logits, ("batch", None), rules)


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """fp32 CE over the vocab + z-loss; labels == -100 are masked."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    mask = labels >= 0
    lab = torch.where(mask, labels, 0).long()
    if SH.is_dtensor(logits):
        # gather's backward makes a zero tensor of the global shape on
        # every rank (DTensor: the whole [B, S, V] logits); a select by
        # a mask keeps each rank at its shard, with the same values
        vocab = torch.arange(logits.shape[-1], device=lab.device)
        gold = torch.where(vocab == lab[..., None], logits, 0.0).sum(-1)
    else:
        gold = logits.gather(-1, lab[..., None])[..., 0]
    ce = (lse - gold) * mask
    zl = z_loss * lse.square() * mask
    denom = torch.clamp_min(mask.sum(), 1)
    return (ce + zl).sum() / denom


def make_loss_fn(cfg: ModelConfig, remat: str = "full",
                 aux_coef: float = 0.01, *, rules=None):
    """loss_fn(master, batch) -> (loss, {"ce", "aux"}): the fp32 master
    leaves of more than one dim are cast to ``cfg.dtype`` (norm scales and
    biases stay fp32, as in the reference)."""
    dt = L.torch_dtype(cfg.dtype)

    def loss_fn(master_params, batch):
        params = pytree.tree_map(
            lambda p: p.to(dt) if p.dtype == torch.float32 and p.ndim > 1
            else p, master_params)
        logits, aux = M.forward(params, cfg, batch, remat=remat, rules=rules)
        # the gold logit's gather over a vocab split leaves DTensor a
        # masked partial sum it cannot reduce once the labels are split
        # on batch too: the CE reads whole rows of the vocab
        logits = SH.constrain(logits, ("batch", "seq", None), rules)
        ce = cross_entropy(logits, batch["labels"])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + aux_coef * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: AdamWConfig = AdamWConfig(),
                    remat: str = "full",
                    grad_transform: Optional[Callable] = None, *,
                    rules=None):
    """train_step(state, batch) -> (state', metrics): value and grad of
    the loss over ``state["master"]``, the optional ``grad_transform``
    (e.g. int8 error feedback, whose buffer rides in ``state["ef"]``),
    then AdamW, which updates the state's tensors in place
    (``optimizer.py``)."""
    loss_fn = make_loss_fn(cfg, remat, rules=rules)

    def train_step(state, batch):
        mesh, scope = _mesh_scope(state["master"], rules)
        with scope:
            new_state, metrics = _step(state, _placed(batch, mesh, rules))
        return new_state, _plain(metrics, mesh)

    def _step(state, batch):
        flat, spec = pytree.tree_flatten(state["master"])
        leaves = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, parts = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = pytree.tree_unflatten(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)], spec)
        if grad_transform is not None:
            grads, state = grad_transform(grads, state)
        new_state, om = adamw_update(opt, state, grads)
        if grad_transform is not None and "ef" in state:
            new_state["ef"] = state["ef"]
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return new_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, *, rules=None):
    def prefill_step(params, batch):
        mesh, scope = _mesh_scope(params, rules)
        with scope:
            logits, caches = M.prefill(params, cfg,
                                       _placed(batch, mesh, rules),
                                       cache_len, rules=rules)
            last = _whole_vocab(logits[:, -1], rules)
            next_tok = last.argmax(-1).to(torch.int32)
            out = {"next_tokens": next_tok, "last_logits": last}
        return _plain(out, mesh), caches
    return prefill_step


def make_batched_prefill_step(cfg: ModelConfig, cache_len: int, *,
                              rules=None):
    """Grouped-admission prefill (serving): right-padded prompts share ONE
    dispatch; each row's next token is read at its true last position
    (causal attention makes it independent of the padding).  Sound for
    attention families because decode masks cache rows >= pos."""
    def batched_prefill_step(params, tokens, lengths):
        mesh, scope = _mesh_scope(params, rules)
        with scope:
            logits, caches = M.prefill(
                params, cfg, {"tokens": _placed(tokens, mesh, rules)},
                cache_len, rules=rules)
            rows = torch.arange(tokens.shape[0], device=tokens.device)
            last = logits[rows, lengths.long() - 1]
            next_tok = last.argmax(-1).to(torch.int32)
            out = {"next_tokens": next_tok, "last_logits": last}
        return _plain(out, mesh), caches
    return batched_prefill_step


def make_decode_step(cfg: ModelConfig, sample: str = "greedy", *,
                     rules=None):
    """One decode step -> (next tokens, logits, caches); greedy, as the
    reference (its ``sample`` takes no other value)."""
    if sample != "greedy":
        raise ValueError(f"sample {sample!r}: only 'greedy' is defined")

    def decode_step(params, tokens, pos, caches):
        mesh, scope = _mesh_scope(params, rules)
        with scope:
            logits, caches = M.decode_step(
                params, cfg, *_placed((tokens, pos), mesh, rules), caches,
                rules=rules)
            logits = _whole_vocab(logits, rules)
            next_tok = logits.argmax(-1).to(torch.int32)
        return (*_plain((next_tok, logits), mesh), caches)
    return decode_step


def make_fused_decode_step(cfg: ModelConfig, k: int, eos_id: int = 2, *,
                           rules=None):
    """Deferral: k decode steps per host dispatch (the paper's batched
    register-access commit).  The EOS 'poll' runs on the device: finished
    rows are frozen (token and position held) and the host receives one
    commit with (tokens [B,k], pos, done)."""
    def fused(params, tokens, pos, caches):
        mesh, scope = _mesh_scope(params, rules)
        with scope:
            tokens, pos = _placed((tokens, pos), mesh, rules)
            done = torch.zeros(tokens.shape, dtype=torch.bool,
                               device=tokens.device)
            seq = []
            for _ in range(k):
                logits, caches = M.decode_step(params, cfg, tokens, pos,
                                               caches, rules=rules)
                nxt = logits.argmax(-1).to(torch.int32)
                nxt = torch.where(done, tokens, nxt)   # freeze finished seqs
                done = done | (nxt == eos_id)
                pos = torch.where(done, pos, pos + 1)
                tokens = nxt
                seq.append(nxt)
            out = {"tokens": torch.stack(seq, 1), "pos": pos, "done": done}
        return _plain(out, mesh), caches
    return fused


def abstract_train_state(cfg: ModelConfig):
    """The train state's shapes and dtypes, as meta tensors (the
    reference's ``jax.ShapeDtypeStruct`` tree): no memory is allocated."""
    schema = M.model_schema(cfg)
    f32 = lambda: M.schema_map(lambda sp: torch.empty(
        sp.shape, dtype=torch.float32, device="meta"), schema)
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "master": f32(), "m": f32(), "v": f32()}


def train_state_axes(cfg: ModelConfig):
    """The logical axis names of every state leaf (the reference's
    ``param_axes`` per tree); a per-block stage carries no ``stack``
    axis."""
    axes = M.param_axes(cfg)
    return {"step": (), "master": axes, "m": axes, "v": axes}
