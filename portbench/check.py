"""Whether what the timed path served is right: the comparison with the
plain reference that decides ``correct``.

Once the window has closed, a sample drawn from the seed of the requests
that finished in it (the longest, one of every slot that finished any,
then others until ``check_tokens`` served tokens) is run through the
reference: one causal float32 pass over each prompt and its served tokens.  For every served
token the gap by which its reference logit lies below the reference's best
at that position is read.  Served greedily, every gap of a sound run is
rounding.  ``mean_gap``, the mean over the sample's served tokens, is held
to the cell's limit (``limits/<cell>.json``); ``max_gap``, the widest, is
reported beside it.  The widest gap of sound bf16 runs and of the int8
control lie within 3x of each other, so it cannot be given a limit that
the control fails and sound runs pass; the mean separates them (PERF.md)."""
from __future__ import annotations

import numpy as np
import torch


def sample(finished: list, seed: int, check_tokens: int) -> list:
    """finished: [(prompt, served tokens, slot)] -> the sample to compare,
    [(prompt, served tokens)]: the longest request, then one request of
    every slot that finished any (so no row of the decode batch goes
    unread), then others, each in an order drawn from the seed, until
    ``check_tokens`` served tokens."""
    if not finished:
        return []
    order = np.random.default_rng([seed & ((1 << 64) - 1), 7]).permutation(
        len(finished)).tolist()
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    picked, slots = [longest], {finished[longest][2]}
    for i in order:
        if finished[i][2] not in slots:
            slots.add(finished[i][2])
            picked.append(i)
    n = sum(len(finished[i][1]) for i in picked)
    rest = set(range(len(finished))) - set(picked)
    for i in order:
        if n >= check_tokens:
            break
        if i in rest:
            picked.append(i)
            n += len(finished[i][1])
    return [finished[i][:2] for i in picked]


def reference_logits(ref, weights: dict, conf: dict, prompt, served):
    """The reference's float32 logits at the positions that chose each
    served token: [len(served), V]."""
    tokens = list(prompt) + list(served[:-1])
    return ref.logits(weights, conf, tokens, len(prompt) - 1, len(prompt))


def gaps(logits: torch.Tensor, chosen) -> torch.Tensor:
    """Per position: best logit minus the chosen token's logit."""
    idx = torch.as_tensor(list(chosen), device=logits.device).long()
    return logits.max(-1).values - logits.gather(1, idx[:, None])[:, 0]


class Gaps:
    """Running mean and widest gap, and how many tokens were not the
    reference's first choice."""

    def __init__(self):
        self.total, self.widest, self.tokens, self.off = 0.0, 0.0, 0, 0

    def add(self, g: torch.Tensor) -> None:
        self.total += float(g.double().sum())
        self.widest = max(self.widest, float(g.max()))
        self.tokens += g.numel()
        self.off += int((g > 0).sum())

    def readings(self) -> dict:
        return {"mean_gap": self.total / max(self.tokens, 1),
                "max_gap": self.widest, "tokens": self.tokens,
                "not_first": self.off}


def compare(ref, weights: dict, conf: dict, picked: list,
            choose=None) -> dict:
    """The gaps of the served tokens of the sample under the reference, or
    with ``choose(prompt, served)`` of the tokens it puts first at the same
    positions."""
    acc = Gaps()
    for prompt, served in picked:
        lg = reference_logits(ref, weights, conf, prompt, served)
        acc.add(gaps(lg, served if choose is None else choose(prompt, served)))
        del lg
    return dict(acc.readings(), requests=len(picked))
