"""The rank programs of ``tests/test_torch_distributed.py``: one world of
4 gloo ranks on the CPU, started by ``mp.spawn`` over a ``FileStore`` (no
TCP port), runs a list of jobs in order and rank 0 writes each job's
results with ``torch.save``.  Every rank runs the port's plain versions;
no rank imports JAX (the tests hold the results against the reference in
the pytest process, or in a JAX subprocess where a mesh is needed).

    python tests/torch_dist_ranks.py OUTDIR JOB [JOB ...]

``OUTDIR/inputs.pt`` holds what the jobs need from the test (params, the
batch); ``OUTDIR/<job>.pt`` is what a job leaves.  Jobs:

    strategies        every custom op under every strategy row, on a 2 x 2
                      and a 1 x 4 mesh, against the op on whole tensors
    train:ARCH:MODE   one train step on a 2 x 2 mesh under rules_for(MODE)
    serve:ARCH        prefill + two fused decode blocks under the serve
                      rules on a 2 x 2 mesh
    shards            each rank's local shard of tuple-mapped leaves
    psum              compressed_psum over a 4 x 1 mesh's data axis
    elastic           a reference checkpoint restored onto 2 x 2, a step
"""
from __future__ import annotations

import os
import sys
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _tree_map(fn, tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(fn, tree)


# ---------------------------------------------------------- strategies --
def _op_inputs(name: str, g: torch.Generator):
    """Small inputs of every custom op (the positional schema args)."""
    r = lambda *s: torch.randn(*s, generator=g)
    B, S, H, Hkv, hd = 4, 8, 4, 2, 16
    if name in ("rmsnorm", "rmsnorm_backward"):
        x, scale = r(4, 8, 16), r(16).abs() + 0.5
        return (x, scale, 1e-5) if name == "rmsnorm" else \
            (x, scale, r(4, 8, 16), 1e-5)
    if name in ("flash_attention", "flash_attention_backward"):
        q, k, v = r(B, S, H, hd), r(B, S, Hkv, hd), r(B, S, Hkv, hd)
        if name == "flash_attention":
            return (q, k, v, True, 0, hd ** -0.5, 0)
        out = torch.ops.repro_torch.flash_attention(q, k, v, True, 0,
                                                    hd ** -0.5, 0)
        return (q, k, v, out, r(*out.shape), True, 0, hd ** -0.5, 0)
    if name in ("decode_attention", "decode_attention_int8"):
        q = r(B, H, hd)
        lengths = torch.tensor([12, 5, 9, 1], dtype=torch.int32)
        if name == "decode_attention":
            return (q, r(B, 12, Hkv, hd), r(B, 12, Hkv, hd), lengths,
                    hd ** -0.5)
        kq = torch.randint(-127, 128, (B, 12, Hkv, hd), generator=g,
                           dtype=torch.int8)
        vq = torch.randint(-127, 128, (B, 12, Hkv, hd), generator=g,
                           dtype=torch.int8)
        return (q, kq, vq, lengths, r(B, 12, Hkv, 1).abs() / 127,
                r(B, 12, Hkv, 1).abs() / 127, hd ** -0.5)
    if name in ("moe_gmm", "moe_gmm_backward"):
        x, w = r(4, 6, 16), r(4, 16, 8)
        return (x, w) if name == "moe_gmm" else (x, w, r(4, 6, 8))
    Bn, nc, Q, nh, P, N = 4, 2, 8, 4, 8, 8
    cum = -torch.rand(Bn, nc, Q, nh, generator=g).cumsum(2)
    if name in ("mamba_chunk_scan", "mamba_chunk_scan_backward"):
        args = (r(Bn, nc, Q, nh, P), r(Bn, nc, Q, N), r(Bn, nc, Q, N), cum)
        if name == "mamba_chunk_scan":
            return args
        return args + (r(Bn, nc, Q, nh, P), r(Bn, nh, P, N))
    q, k, v = (r(Bn, nc, Q, nh, P) for _ in range(3))
    li = r(Bn, nc, Q, nh)
    if name == "mlstm_chunk_scan":
        return (q, k, v, cum, li)
    y, C, n = torch.ops.repro_torch.mlstm_chunk_scan(q, k, v, cum, li)
    return (q, k, v, cum, li, y, r(*y.shape), r(*C.shape), r(*n.shape))


class _Spec:
    """What a strategy function reads of a DTensorSpec."""

    def __init__(self, t, mesh):
        self.shape, self.ndim, self.mesh = t.shape, t.ndim, mesh
        self.placements = ()


AUTOGRAD = {"rmsnorm": (0, 1), "flash_attention": (0, 1, 2),
            "moe_gmm": (0, 1), "mamba_chunk_scan": (0, 1, 2, 3),
            "mlstm_chunk_scan": (0, 1, 2, 3, 4)}
# the attention ops and the dim of q's heads in their arguments; under the
# model's specs a model axis that Hkv does not divide splits q's heads
# and leaves K/V (and anything else) whole
GQA_OPS = {"flash_attention": 2, "flash_attention_backward": 2,
           "decode_attention": 1, "decode_attention_int8": 1}
# leaves whose spec under train_zero on 2 x 2 maps a dim to a tuple of
# mesh axes (fsdp -> ("data", "model")), and a dim mapped to one axis
SHARD_CASES = {"tuple": ((8, 6), ("fsdp", "vocab")),
               "tuple_3d": ((4, 8, 2), (None, "fsdp", None)),
               "one_axis": ((4, 6), ("batch", None))}


def _run_strategies(rank, meshes):
    """Every (op, mesh, mesh dim, row): inputs placed by the row on that
    mesh dim (Replicate on the other), the op on the DTensors, its
    whole result against the op on whole tensors; the five forwards with
    a backward also through autograd."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import _sharding
    R = Replicate()
    out = {}
    for name, fn in _sharding.strategies():
        op = getattr(torch.ops.repro_torch, name).default
        g = torch.Generator().manual_seed(0)
        args = _op_inputs(name, g)
        want = op(*args)
        want = want if isinstance(want, tuple) else (want,)
        for mname, mesh in meshes.items():
            specs = [_Spec(a, mesh) if isinstance(a, torch.Tensor) else a
                     for a in args]
            rows = fn(*specs)
            for ri, (outs, ins) in enumerate(rows):
                for d in range(mesh.ndim):
                    if mesh.size(d) == 1 and ri < len(rows) - 1:
                        continue
                    shardable = all(
                        p is None or not hasattr(p, "dim")
                        or a.shape[p.dim] >= mesh.size(d)
                        for a, p in zip(args, ins))
                    if not shardable:
                        continue
                    place = lambda p: [p if i == d else R
                                       for i in range(mesh.ndim)]
                    dargs = [distribute_tensor(a, mesh, place(p))
                             if isinstance(a, torch.Tensor) else a
                             for a, p in zip(args, ins)]
                    got = op(*dargs)
                    got = got if isinstance(got, tuple) else (got,)
                    picked = all(tuple(o.placements) == tuple(place(p))
                                 for o, p in zip(got, outs))
                    err = max(_excess(o.full_tensor(), w)
                              for o, w in zip(got, want))
                    case = f"{name}/{mname}/dim{d}/row{ri}"
                    out[case] = {"err": err, "picked": picked,
                                 "dtype": str(want[0].dtype)}
                    if name in AUTOGRAD and ri < len(rows) - 1:
                        out[case + "/grad"] = _grad_err(
                            op, args, dargs, AUTOGRAD[name], g)
            if name in GQA_OPS and mname == "1x4":
                # q's heads split over the model axis of 4, the rest whole
                hq = GQA_OPS[name]
                dargs = [distribute_tensor(
                    a, mesh, [R, Shard(hq) if i == 0 else R])
                    if isinstance(a, torch.Tensor) else a
                    for i, a in enumerate(args)]
                got = op(*dargs)
                got = got if isinstance(got, tuple) else (got,)
                out[f"{name}/1x4/gqa"] = {
                    "err": max(_excess(o.full_tensor(), w)
                               for o, w in zip(got, want)),
                    "picked": False, "dtype": str(want[0].dtype)}
    return out


def _grad_err(op, args, dargs, which, g):
    """The excess (``_excess``) of the gradients of sum(out * w) through
    autograd, DTensor inputs against whole ones."""
    def grads(a):
        leaves = [t.detach().clone().requires_grad_()
                  if i in which else t for i, t in enumerate(a)]
        outs = op(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o * w).sum() for o, w in zip(outs, ws))
        gs = torch.autograd.grad(loss, [leaves[i] for i in which])
        return [t.full_tensor() if hasattr(t, "full_tensor") else t
                for t in gs]
    full = op(*args)
    full = full if isinstance(full, tuple) else (full,)
    ws = [torch.randn(o.shape, generator=g) for o in full]
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        got = grads(dargs)
    return max(_excess(a, b) for a, b in zip(got, grads(args)))


def _excess(got, want) -> float:
    """max of |got - want| - tol |want| over the elements: at most tol
    where allclose(got, want, atol=tol, rtol=tol) holds (kernels
    .TOLERANCE's convention)."""
    from repro_torch.kernels import TOLERANCE
    tol = TOLERANCE.get(want.dtype, TOLERANCE[torch.float32])
    got, want = got.float(), want.float()
    return float(((got - want).abs() - tol * want.abs()).max())


# --------------------------------------------------------- model jobs --
def _place(tree, axes, mesh, rules):
    from torch.distributed.tensor import distribute_tensor
    from torch.utils import _pytree as pytree

    from repro_torch.sharding import shardings_for
    sh = shardings_for(axes, tree, mesh, rules)
    return pytree.tree_map(lambda t, p: distribute_tensor(t, mesh, list(p)),
                           tree, sh,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))


def _train(inputs, mesh, arch, mode):
    from repro_torch.runtime.checkpoint import to_reference_layout
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding import rules_for
    from repro_torch.training import optimizer as TO
    from repro_torch.training import steps as ST
    cfg = inputs["cfgs"][arch]
    state = reshard_state(TO.init_opt_state(inputs["params"][arch]),
                          ST.train_state_axes(cfg), mesh, mode)
    rules = rules_for(mode, ("data", "model"))
    step = ST.make_train_step(cfg, TO.AdamWConfig(**inputs["opt"]),
                              remat="none", rules=rules)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"][arch].items()}
    placed = [tuple(p.placements) for p in
              torch.utils._pytree.tree_leaves(state["master"])]
    new, m = step(state, batch)
    return {"metrics": {k: v.numpy() for k, v in m.items()},
            "state": _tree_map(lambda t: t.numpy(), to_reference_layout(new)),
            "sharded": sum(any(type(p).__name__ == "Shard" for p in pl)
                           for pl in placed)}


def _serve(inputs, mesh, arch):
    from repro_torch.models import model as M
    from repro_torch.sharding import rules_for
    from repro_torch.training import steps as ST
    cfg = inputs["cfgs"][arch]
    rules = rules_for("serve", ("data", "model"))
    params = _place(inputs["params"][arch], M.param_axes(cfg), mesh, rules)
    tokens = torch.from_numpy(inputs["prompts"][arch])
    B, S = tokens.shape
    pre = ST.make_prefill_step(cfg, inputs["cache_len"], rules=rules)
    fused = ST.make_fused_decode_step(cfg, inputs["block_k"], rules=rules)
    o, caches = pre(params, {"tokens": tokens})
    pos = torch.full((B,), S, dtype=torch.int32)
    f1, caches = fused(params, o["next_tokens"], pos, caches)
    f2, caches = fused(params, f1["tokens"][:, -1], f1["pos"], caches)
    return torch.cat([o["next_tokens"][:, None], f1["tokens"],
                      f2["tokens"]], 1).numpy()


def _shards(mesh):
    """Each rank's local shard of leaves whose spec maps a dim to a tuple
    of mesh axes (train_zero's fsdp), and of a plain 2-D split."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import placements, rules_for, spec
    rules = rules_for("train_zero", ("data", "model"))
    ms = {"data": 2, "model": 2}
    out = {}
    for name, (shape, axes) in SHARD_CASES.items():
        sp = spec(axes, rules, shape, ms)
        full = torch.arange(torch.Size(shape).numel(),
                            dtype=torch.float32).reshape(shape)
        d = distribute_tensor(full, mesh, list(placements(sp, mesh)))
        out[name] = {"spec": sp, "local": d.to_local().numpy()}
    return out


# cache placements of ``write_slots`` on (mesh, placements): batch and
# slots whole (heads split, or slots split over a mesh dim of one) take
# index_put_ into the local shard; a batch or slot split takes the mask
SLOT_CASES = {"heads_split": ("2x2", ("R", 2)), "whole": ("2x2", ("R", "R")),
              "slots_on_one": ("4x1", ("R", 1)),
              "batch_slots_split": ("2x2", (0, 1))}


def _slots(meshes):
    """Each SLOT_CASES cache [4, 8, 4, 2] written at a slot per row by
    ``write_slots`` -> {case: (the whole cache after, masked_write
    called)}."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import layers as L
    from repro_torch.sharding import set_mesh
    g = torch.Generator().manual_seed(7)
    cache = torch.randn(4, 8, 4, 2, generator=g)
    val = torch.randn(4, 4, 2, generator=g)
    slot = torch.tensor([5, 0, 7, 3])
    bidx = torch.arange(4)
    masked = L.masked_write
    out = {}
    for name, (mesh, pl) in SLOT_CASES.items():
        mesh = meshes[mesh]
        pl = [Replicate() if p == "R" else Shard(p) for p in pl]
        dc = distribute_tensor(cache.clone(), mesh, pl)
        dv = distribute_tensor(val, mesh, [Replicate(), Replicate()])
        calls = []
        L.masked_write = lambda *a: (calls.append(1), masked(*a))
        try:
            with set_mesh(mesh):
                L.write_slots(dc, bidx, slot, dv)
        finally:
            L.masked_write = masked
        out[name] = (dc.full_tensor().numpy(), bool(calls))
    return out


def _psum(mesh):
    from repro_torch.training.grad_compress import compressed_psum
    rank = dist.get_rank()
    x = torch.linspace(-1.0, 1.0, 4096).reshape(64, 64)
    g = torch.Generator().manual_seed(100 + rank)
    xr = torch.randn(64, 64, generator=g) * (rank + 1)
    xs = torch.linspace(-1.0, 1.0, 35).reshape(5, 7)
    every = [torch.empty_like(xr) for _ in range(WORLD)]
    dist.all_gather(every, xr)
    return {"same": compressed_psum(x, mesh, "data").numpy(),
            "per_rank": compressed_psum(xr, mesh, "data").numpy(),
            "per_rank_x": torch.stack(every).numpy(),
            "odd": compressed_psum(xs, mesh, "data").numpy()}


def _elastic(inputs):
    from repro_torch.runtime.checkpoint import (CheckpointStore,
                                                restore_on_mesh)
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.sharding import rules_for
    from repro_torch.training import optimizer as TO
    from repro_torch.training import steps as ST
    cfg = inputs["elastic_cfg"]
    mesh = make_elastic_mesh(prefer_model=2, device="cpu")     # 2 x 2
    state, manifest = restore_on_mesh(CheckpointStore(inputs["ckpt_dir"]),
                                      cfg, mesh)
    step = ST.make_train_step(cfg, TO.AdamWConfig(**inputs["opt"]),
                              remat="none",
                              rules=rules_for("train", ("data", "model")))
    batch = {k: torch.from_numpy(v) for k, v in
             inputs["elastic_batch"].items()}
    _, m = step(state, batch)
    return {"step": manifest["step"], "mesh": tuple(mesh.mesh.shape),
            "metrics": {k: v.numpy() for k, v in m.items()}}


# ---------------------------------------------------------------- ranks --
def _rank(rank: int, outdir: str, jobs) -> None:
    sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(outdir, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import make_mesh
        inputs = torch.load(os.path.join(outdir, "inputs.pt"),
                            weights_only=False)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        for job in jobs:
            kind, *rest = job.split(":")
            if kind == "strategies":
                res = _run_strategies(rank, {
                    "2x2": mesh,
                    "1x4": make_mesh((1, 4), ("data", "model"), "cpu")})
            elif kind == "train":
                res = _train(inputs, mesh, *rest)
            elif kind == "serve":
                res = _serve(inputs, mesh, *rest)
            elif kind == "shards":
                res = _shards(mesh)
                every = [None] * WORLD
                dist.all_gather_object(every, res)
                res = every
            elif kind == "slots":
                res = _slots({"2x2": mesh, "4x1": make_mesh(
                    (4, 1), ("data", "model"), "cpu")})
            elif kind == "psum":
                res = _psum(make_mesh((4, 1), ("data", "model"), "cpu"))
            elif kind == "elastic":
                res = _elastic(inputs)
            else:
                raise ValueError(job)
            if rank == 0:
                torch.save(res, os.path.join(outdir,
                                             job.replace(":", "_") + ".pt"))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main(argv) -> None:
    outdir, jobs = argv[0], argv[1:]
    mp.spawn(_rank, args=(outdir, jobs), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main(sys.argv[1:])
