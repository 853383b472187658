"""Serving step factories: prefill, batched prefill, fused k-step decode.

Counterpart of the serving half of ``repro/training/steps.py`` (training
steps come later).  The reference jits these; the port runs them eagerly,
so the fused decode's ``lax.scan`` over k is a Python loop here.  Every
step keeps its outputs on the device of its inputs: nothing is read back
to the host inside a step.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


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
