"""Step factories: train_step, prefill_step, decode_step and the fused
k-step decode.

Counterpart of ``repro/training/steps.py``.  The reference jits these; the
port runs them eagerly, so the fused decode's ``lax.scan`` over k is a
Python loop here.  Every step keeps its outputs on the device of its
inputs: nothing is read back to the host inside a step.  The reference's
``rules`` (sharding) argument waits for ``sharding.py`` (ROADMAP Queue 1,
item 15) and is dropped.

A train step differentiates the loss with ``torch.autograd`` through the
custom ops' registered backwards: on the card ``rmsnorm``,
``flash_attention``, the two chunk scans (``mamba_chunk_scan``,
``mlstm_chunk_scan``) and ``moe_gmm`` launch their backward kernels, so
every family trains: dense, vlm, audio, hybrid, ssm and moe (the
routing, dispatch and combine of ``models/moe.py`` differentiate in plain
PyTorch around ``moe_gmm``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_update


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """fp32 CE over the vocab + z-loss; labels == -100 are masked."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    mask = labels >= 0
    lab = torch.where(mask, labels, 0).long()
    gold = logits.gather(-1, lab[..., None])[..., 0]
    ce = (lse - gold) * mask
    zl = z_loss * lse.square() * mask
    denom = torch.clamp_min(mask.sum(), 1)
    return (ce + zl).sum() / denom


def make_loss_fn(cfg: ModelConfig, remat: str = "full",
                 aux_coef: float = 0.01):
    """loss_fn(master, batch) -> (loss, {"ce", "aux"}): the fp32 master
    leaves of more than one dim are cast to ``cfg.dtype`` (norm scales and
    biases stay fp32, as in the reference)."""
    dt = L.torch_dtype(cfg.dtype)

    def loss_fn(master_params, batch):
        params = pytree.tree_map(
            lambda p: p.to(dt) if p.dtype == torch.float32 and p.ndim > 1
            else p, master_params)
        logits, aux = M.forward(params, cfg, batch, remat=remat)
        ce = cross_entropy(logits, batch["labels"])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + aux_coef * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: AdamWConfig = AdamWConfig(),
                    remat: str = "full",
                    grad_transform: Optional[Callable] = None):
    """train_step(state, batch) -> (state', metrics): value and grad of
    the loss over ``state["master"]``, the optional ``grad_transform``
    (e.g. int8 error feedback, whose buffer rides in ``state["ef"]``),
    then AdamW, which updates the state's tensors in place
    (``optimizer.py``)."""
    loss_fn = make_loss_fn(cfg, remat)

    def train_step(state, batch):
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


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        logits, caches = M.prefill(params, cfg, batch, cache_len)
        last = logits[:, -1]
        next_tok = last.argmax(-1).to(torch.int32)
        return {"next_tokens": next_tok, "last_logits": last}, caches
    return prefill_step


def make_batched_prefill_step(cfg: ModelConfig, cache_len: int):
    """Grouped-admission prefill (serving): right-padded prompts share ONE
    dispatch; each row's next token is read at its true last position
    (causal attention makes it independent of the padding).  Sound for
    attention families because decode masks cache rows >= pos."""
    def batched_prefill_step(params, tokens, lengths):
        logits, caches = M.prefill(params, cfg, {"tokens": tokens}, cache_len)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        last = logits[rows, lengths.long() - 1]
        next_tok = last.argmax(-1).to(torch.int32)
        return {"next_tokens": next_tok, "last_logits": last}, caches
    return batched_prefill_step


def make_decode_step(cfg: ModelConfig, sample: str = "greedy"):
    """One decode step -> (next tokens, logits, caches); greedy, as the
    reference (its ``sample`` takes no other value)."""
    if sample != "greedy":
        raise ValueError(f"sample {sample!r}: only 'greedy' is defined")

    def decode_step(params, tokens, pos, caches):
        logits, caches = M.decode_step(params, cfg, tokens, pos, caches)
        next_tok = logits.argmax(-1).to(torch.int32)
        return next_tok, logits, caches
    return decode_step


def make_fused_decode_step(cfg: ModelConfig, k: int, eos_id: int = 2):
    """Deferral: k decode steps per host dispatch (the paper's batched
    register-access commit).  The EOS 'poll' runs on the device: finished
    rows are frozen (token and position held) and the host receives one
    commit with (tokens [B,k], pos, done)."""
    def fused(params, tokens, pos, caches):
        done = torch.zeros(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
        seq = []
        for _ in range(k):
            logits, caches = M.decode_step(params, cfg, tokens, pos, caches)
            nxt = logits.argmax(-1).to(torch.int32)
            nxt = torch.where(done, tokens, nxt)       # freeze finished seqs
            done = done | (nxt == eos_id)
            pos = torch.where(done, pos, pos + 1)
            tokens = nxt
            seq.append(nxt)
        return {"tokens": torch.stack(seq, 1), "pos": pos, "done": done}, caches
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
