"""AdamW with fp32 master weights.

Counterpart of ``repro/training/optimizer.py``: the same schedule, state
and update.  The state may be DTensors sharded as the parameters are
(``runtime.elastic.reshard_state``): every update runs on the local
shards, and the grad norm that the clip reads sums the squares of every
shard of every leaf (DTensor reduces the partial sums), never of this
rank's shards alone.

The state is ``{"step", "master", "m", "v"}``: an int32 step and three
fp32 trees shaped like the port's parameter tree (nested dicts and lists
of tensors, ``layers.to_tree``).  Where the reference returns a new state,
``adamw_update`` updates ``master``, ``m`` and ``v`` in place under
``torch.no_grad()`` and returns a new dict holding the same tensors: at
qwen2.5-3b's 3.09 B parameters the three trees hold 37 GB, and a second
copy would not fit beside the activations on one 80 GB card.  The grads
are read, never written.  Unlike the reference's, an update reads its
grad norm, lr and step to the host once (one sync a step).  The update is
four in-place ops per leaf, not ``torch._foreach_*``; on DTensors each op
runs on the local shard, a grad whose placements differ from its leaf's
being redistributed to them first (a ``Partial`` one reduced).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch import nn
from torch.utils import _pytree as pytree

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``, in fp32 on
    ``step``'s device (a tensor or an int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * torch.clamp_max((step + 1) / cfg.warmup_steps, 1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params) -> Dict[str, Any]:
    """The state for ``params`` (a ``ParamTree`` module or a tree of
    tensors): fp32 copies as the master weights, zero moments."""
    if isinstance(params, nn.Module):
        params = L.to_tree(params)
    master = pytree.tree_map(
        lambda p: p.detach().to(torch.float32, copy=True), params)
    zeros = lambda: pytree.tree_map(torch.zeros_like, master)
    device = pytree.tree_leaves(master)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "master": master, "m": zeros(), "v": zeros()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, summed as the
    reference does (each leaf's squares, then the leaves in order).  Not
    ``torch.linalg.vector_norm``: on the CPU its fp32 accumulation is 5%
    low over qwen2.5-3b's 311 M-element embedding grad, where ``sum``'s
    cascade stays within 1e-8."""
    return sum(x.float().square().sum()
               for x in pytree.tree_leaves(tree)).sqrt()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, state, grads):
    """-> (new state, {"grad_norm", "lr"}).  ``master``, ``m`` and ``v``
    are updated in place (module docstring); the step count is new.

    The reference's update, with the clip folded into the moments' weights:
    m = b1 m + (1 - b1) s g, v = b2 v + (1 - b2) s^2 g^2 and p = p (1 - lr
    wd) - lr / bc1 m / (sqrt(v / bc2) + eps).  The step's scalars (grad
    norm, lr, step) are read to the host once, so each leaf's update is
    four in-place passes with plain-number weights and one temporary the
    leaf's size: about half the memory traffic of the reference's form op
    by op, whose on-device scalars also keep PyTorch off its vectorized
    kernels.  ``torch._foreach_*`` over all leaves at once would hold a
    temporary the size of the whole master tree."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    lr_t = lr_at(cfg, step)
    scalars = torch.stack([gnorm, lr_t, step.to(torch.float32)])
    if hasattr(scalars, "full_tensor"):     # a DTensor state
        scalars = scalars.full_tensor()
    gn, lr, n = scalars.tolist()
    s = min(1.0, cfg.grad_clip / max(gn, 1e-9))
    bc1, bc2 = 1 - cfg.b1 ** n, 1 - cfg.b2 ** n
    for p, g, m, v in zip(pytree.tree_leaves(state["master"]),
                          pytree.tree_leaves(grads),
                          pytree.tree_leaves(state["m"]),
                          pytree.tree_leaves(state["v"])):
        g = g.float()
        m.mul_(cfg.b1).add_(g, alpha=(1 - cfg.b1) * s)
        v.mul_(cfg.b2).addcmul_(g, g, value=(1 - cfg.b2) * s * s)
        denom = v.div(bc2).sqrt_().add_(cfg.eps)
        p.mul_(1 - lr * cfg.weight_decay).addcdiv_(m, denom, value=-lr / bc1)
    new = {"step": step, "master": state["master"], "m": state["m"],
           "v": state["v"]}
    return new, {"grad_norm": gnorm, "lr": lr_t}


__all__ = ["AdamWConfig", "lr_at", "init_opt_state", "global_norm",
           "adamw_update"]
