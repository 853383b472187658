"""End-to-end training launcher (runs on this host's devices).

Counterpart of ``repro/launch/train.py``, with the same flags and defaults
(``--smoke`` is on unless the code is changed, as in the reference) and
``--device``, which every launcher of the port takes:

    python -m repro_torch.launch.train --arch qwen2.5-3b --device cpu \\
        --steps 4
    python -m repro_torch.launch.train --arch qwen2.5-3b --steps 50 \\
        --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    python -m repro_torch.launch.train --arch zamba2-1.2b --steps 4
    python -m repro_torch.launch.train --arch xlstm-350m --device cpu
    python -m repro_torch.launch.train --arch deepseek-v2-lite-16b --steps 4
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --device cpu --steps 3

Every family trains: dense, vlm, audio, hybrid (zamba2-1.2b, through the
Mamba2 scan's backward kernel), ssm (xlstm-350m, through the mLSTM
scan's) and moe (deepseek-v2-lite-16b and mixtral-8x22b, through
``moe_gmm``'s backward kernel, and for deepseek's MLA the flash backward
at hd 192, hd_v 128).  At full size deepseek's AdamW state does not fit
one H100; ``train`` takes it at full width and cut depth:

    train(dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=4), steps=3)

Wires together: data pipeline -> train step (eager; the custom ops'
backward kernels on the card) -> AdamW -> async checkpoints -> elastic
restore.  Where ``torch.distributed.run`` started more than one rank,
``main`` builds ``make_host_mesh(model=1)`` over them (NCCL on the card,
gloo with ``--device cpu``) and ``rules_for("train", ...)``, as the
reference's launcher does; the state is placed on the mesh by
``reshard_state``, so N ranks train data-parallel, each on its share of
every batch.  One rank trains on plain tensors: a mesh of one would give
the same numbers at DTensor's host cost on every op, where the
reference's mesh of one costs nothing.  ``train`` is the same loop for a
config the caller gives (full width and depth included), on the mesh it
is given or, without one, on plain tensors.  A checkpoint holds the
reference's layout and the data cursor of the last batch trained on, so
``--resume`` continues with the next batch, on a mesh of any shape
(``runtime.checkpoint.restore_on_mesh``).  Rank 0 prints and writes the
checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models import model as M
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.checkpoint import (CheckpointStore,
                                            from_reference_layout,
                                            restore_on_mesh,
                                            to_reference_layout)
from repro_torch.runtime.elastic import reshard_state
from repro_torch.sharding import rules_for
from repro_torch.training import steps as ST
from repro_torch.training.grad_compress import make_ef_int8_transform
from repro_torch.training.optimizer import AdamWConfig, init_opt_state


@dataclasses.dataclass
class TrainRun:
    final_loss: float
    state: Dict[str, Any]
    metrics: List[Dict[str, torch.Tensor]]   # each step's, on the device
    step_ms: List[float]    # the wall ms a step of each log line's span


def train(cfg, *, steps: int = 50, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, remat: str = "none", grad_compress: bool = False,
          ckpt_dir: str = "", ckpt_every: int = 20, resume: bool = False,
          log_every: int = 10, device="cuda", mesh=None) -> TrainRun:
    """Train ``cfg`` on ``SyntheticLM`` batches from AdamW's state over
    weights drawn from seed 0 on ``device``, printing the reference's log
    lines.  With ``mesh`` (a ``DeviceMesh`` on ``device``'s type) the
    state is placed on it under ``rules_for("train", ...)`` and the step
    takes those rules."""
    device = resolve_device(device)
    opt = AdamWConfig(lr=lr, warmup_steps=10, decay_steps=steps)
    gt = make_ef_int8_transform() if grad_compress else None
    rules = None if mesh is None else \
        rules_for("train", tuple(mesh.mesh_dim_names))
    train_step = ST.make_train_step(cfg, opt, remat=remat, grad_transform=gt,
                                    rules=rules)
    lead = mesh is None or dist.get_rank() == 0   # prints, writes

    store = CheckpointStore(ckpt_dir) if ckpt_dir else None
    data = SyntheticLM(cfg.vocab_size, batch, seq)
    start_step = 0
    if store and resume and store.latest_step() is not None:
        if mesh is None:
            state_np, manifest = store.restore(to_reference_layout(
                ST.abstract_train_state(cfg), host=False))
            state = from_reference_layout(cfg, state_np, device)
        else:
            state, manifest = restore_on_mesh(store, cfg, mesh)
        data.restore(manifest["extra"])
        start_step = manifest["step"]
        if lead:
            n = 1 if mesh is None else mesh.size()
            print(f"resumed from step {start_step} on {n} devices")
    else:   # the bf16 weights are dropped: each step casts the master
        state = init_opt_state(M.init_params(cfg, 0, device=device))
        if mesh is not None:
            state = reshard_state(state, ST.train_state_axes(cfg), mesh)

    loader = Prefetcher(data)
    history: List[Dict[str, torch.Tensor]] = []
    step_ms: List[float] = []
    try:
        t0 = time.time()
        for step in range(start_step, steps):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in loader.next_batch().items()}
            state, metrics = train_step(state, b)
            history.append(metrics)
            if (step + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                step_ms.append((time.time() - t0) / log_every * 1000)
                if lead:
                    print(f"step {step+1:5d} loss {m['loss']:.4f} "
                          f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                          f"({step_ms[-1]:.0f} ms/step)", flush=True)
                t0 = time.time()
            if store and (step + 1) % ckpt_every == 0:
                snap = to_reference_layout(state)    # every rank gathers
                if lead:
                    store.async_save(snap, step + 1, extra_meta=loader.meta())
        if store:
            snap = to_reference_layout(state)
            if lead:
                store.wait()
                store.save(snap, steps, extra_meta=loader.meta())
    finally:
        loader.close()
    if not history:
        raise ValueError(f"nothing to train: step {start_step} of {steps}")
    final = float(history[-1]["loss"])
    if lead:
        print(f"done: final loss {final:.4f}", flush=True)
    return TrainRun(final, state, history, step_ms)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_shrink(cfg)
    started = not dist.is_initialized()
    ranks = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", "1"))
    mesh = make_host_mesh(model=1, device=args.device) if ranks > 1 else None
    try:
        return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     lr=args.lr, remat=args.remat,
                     grad_compress=args.grad_compress,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     resume=args.resume, log_every=args.log_every,
                     device=args.device, mesh=mesh).final_loss
    finally:
        if started and dist.is_initialized():   # the world it started
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
