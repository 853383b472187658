"""Dry run: every (arch x shape) cell traced on the production meshes.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for the 16x16 and 2x16x16 meshes over fake XLA
devices; the port starts a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``, imported only when a
cell runs), builds ``launch/mesh.py:make_production_mesh`` on it, places
the cell's params, train state, batch and caches as DTensors by
``sharding.shardings_for`` under ``rules_for``, each local shard a fake
tensor (``FakeTensorMode``: nothing is allocated), and traces one call of
the step under ``analysis/cost.py``'s ``CostMode``.  Tracing takes the
place of lowering and compiling.  Per cell it writes one JSON record:

* per-rank flops, HBM bytes (``hlo``: the ``"fused"`` count, the
  reference's ``"spmd"``; ``hlo_eager``: the ``"eager"`` one) and
  collective wire bytes, counted on rank 0's local shards;
* per-rank memory, the counterpart of XLA's ``memory_analysis()``:
  ``arg_bytes`` the rank's input shards, ``out_bytes`` its outputs,
  ``alias_bytes`` the outputs whose storage is a donated input's (the
  train state, ``donate (0,)``; the decode caches, ``(3,)``),
  ``temp_bytes`` the peak of live storage the step allocated (autograd's
  saved tensors included) less its fresh outputs; ``bytes_per_device``
  and ``resident_bytes`` as the reference forms them;
* the roofline at the H100's rates (``analysis/roofline.py``).

The record keeps the reference's keys where the meaning carries over;
``t_lower_s`` is the trace time.  XLA's own keys are left out:
``xla_flops_per_dev`` (XLA's cost analysis), ``t_compile_s`` (there is no
compile) and ``hlo_text_len`` (there is no HLO text).  A skipped cell
carries the reference's reason; an error is caught per cell and written
into its record, and ``main`` returns 1 if any cell erred.

    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k \\
        --mesh multi --layers 2          # on the card (fake CUDA tensors)
    python -m repro_torch.launch.dryrun --device cpu   # the whole grid

``--layers`` cuts every model's depth (its width stays), for a quick
check; the cells then count that depth's work.  Cells run mesh by mesh
(one fake world each), arch by arch within a mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.analysis import cost as cost_an
from repro_torch.analysis import roofline as rf
from repro_torch.configs import (ARCHS, SHAPES, cell_applicable, get_config,
                                 input_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.sharding import (mesh_shape_of, placements, rules_for,
                                  shardings_for, spec)
from repro_torch.training import steps as ST

MESHES = {False: ("16x16", 256), True: ("2x16x16", 512)}


def batch_axes(cfg, batch):
    ax = {}
    for k in batch:
        if k in ("tokens", "labels"):
            ax[k] = ("batch", "seq")
        else:
            ax[k] = ("batch", None, None)
    return ax


def start_fake_world(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (one that exists already is ended first): collectives cost nothing and
    move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and all(hasattr(p, "is_shard") for p in x)


def _local_shape(shape, pl, mesh):
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            local[p.dim] = -(-local[p.dim] // n)    # rank 0's shard
    return local


def place(abstract, placements_tree, mesh, device):
    """DTensors of ``abstract``'s shapes and dtypes (meta tensors) at
    ``placements_tree``, each local shard a fresh tensor on ``device``
    (under ``FakeTensorMode``: a fake one)."""
    from torch.distributed.tensor import DTensor
    flat, tdef = pytree.tree_flatten(abstract)
    pls = pytree.tree_flatten(placements_tree, is_leaf=_is_placements)[0]
    assert len(flat) == len(pls), (len(flat), len(pls))
    out = []
    for t, pl in zip(flat, pls):
        local = torch.empty(_local_shape(t.shape, pl, mesh), dtype=t.dtype,
                            device=device)
        out.append(DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride()))
    return pytree.tree_unflatten(out, tdef)


def build_cell(cfg, shape_name, mesh, overrides, device):
    """-> (fn, args, donate), the args DTensors over fake local shards."""
    cell = SHAPES[shape_name]
    mode = overrides.get("rules_mode") or \
        ("train" if cell.kind == "train" else "serve")
    rules = rules_for(mode, mesh.mesh_dim_names,
                      fsdp=overrides.get("fsdp", True))
    placed = lambda axes, tree: place(
        tree, shardings_for(axes, tree, mesh, rules), mesh, device)

    if cell.kind == "train":
        fn = ST.make_train_step(cfg, remat=overrides.get("remat", "full"),
                                rules=rules)
        state = ST.abstract_train_state(cfg)
        batch = input_specs(cfg, shape_name)
        return (fn, (placed(ST.train_state_axes(cfg), state),
                     placed(batch_axes(cfg, batch), batch)), (0,))

    params = M.abstract_params(cfg)
    p_axes = M.param_axes(cfg)
    if overrides.get("quant"):
        from repro_torch.serving.quant import (abstract_quantized,
                                               quantized_axes)
        p_axes = quantized_axes(p_axes, params)
        params = abstract_quantized(params)
    params = placed(p_axes, params)
    if cell.kind == "prefill":
        fn = ST.make_prefill_step(cfg, cache_len=cell.seq, rules=rules)
        batch = input_specs(cfg, shape_name)
        return fn, (params, placed(batch_axes(cfg, batch), batch)), ()

    # decode
    fn = ST.make_decode_step(cfg, rules=rules)
    specs_ = input_specs(cfg, shape_name)
    tok_axes = ("batch",)
    ms = mesh_shape_of(mesh)
    vec = lambda t: place(t, placements(spec(tok_axes, rules, tuple(t.shape),
                                             ms), mesh), mesh, device)
    return (fn, (params, vec(specs_["tokens"]), vec(specs_["pos"]),
                 placed(M.cache_axes(cfg), specs_["caches"])), (3,))


def run_cell(arch, shape_name, multi_pod, overrides=None, device="cuda",
             cfg=None):
    """One cell's record; ``cfg`` in place of ``get_config(arch)`` (a
    smoke config, in the tests)."""
    overrides = overrides or {}
    cfg = cfg or get_config(arch)
    for k, v in overrides.get("cfg", {}).items():
        cfg = dataclasses.replace(cfg, **{k: v})
    cell = SHAPES[shape_name]
    mesh_name, n = MESHES[bool(multi_pod)]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "num_chips": n}
    skip = cell_applicable(cfg, shape_name)
    if skip:
        rec.update(status="skip", reason=skip)
        return rec
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        start_fake_world(n)
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device=torch.device(device).type)
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args, donate = build_cell(cfg, shape_name, mesh, overrides,
                                          device)
        # the step runs outside the mode: its inputs are fake and every op
        # on them stays fake, while DTensor's own index arithmetic (its
        # strided shards' offsets) runs on real tensors as it must
        tr = cost_an.trace(fn, args, num_devices=n, mode="fused")
        t_lower = time.time() - t0
        arg_b = cost_an.tree_bytes(args)
        out_b = cost_an.tree_bytes(tr.out)
        alias_b = sum(cost_an.shared_bytes(tr.out, args[i]) for i in donate)
        temp_b = max(tr.peak_bytes - tr.fresh_out_bytes, 0)
        cost = tr.costs["fused"].as_dict()
        mf = rf.analytic_model_flops(cfg, cell.kind, cell.batch, cell.seq)
        roof = rf.from_hlo(cost, mf, n)
        rec.update(
            status="ok", device=str(torch.device(device)),
            torch_version=torch.__version__, t_lower_s=round(t_lower, 2),
            bytes_per_device=int(arg_b + temp_b + out_b - alias_b),
            resident_bytes=int(arg_b + out_b - alias_b),
            arg_bytes=int(arg_b), temp_bytes=int(temp_b),
            out_bytes=int(out_b), alias_bytes=int(alias_b),
            hlo=cost, hlo_eager=tr.costs["eager"].as_dict(),
            roofline=roof.as_dict(), model_flops_total=mf)
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--rules", default="", help="override rules mode, e.g. train_zero")
    ap.add_argument("--serve-quant", action="store_true",
                    help="int8 weight quantization for serve cells")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for decode cells")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="the device of the fake local shards")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every model to this many layers (full width; "
                         "0: full depth)")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = {"remat": args.remat, "fsdp": not args.no_fsdp,
                 "rules_mode": args.rules or None,
                 "quant": args.serve_quant,
                 "cfg": {**({"kv_quant": True} if args.kv_quant else {}),
                         **({"num_layers": args.layers} if args.layers
                            else {})}}
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_err = 0
    try:
        for mp in meshes:       # one fake world a mesh
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, mp, overrides, args.device)
                    tag = f"-{args.tag}" if args.tag else ""
                    name = f"{arch}_{shape}_{rec['mesh']}{tag}.json"
                    with open(os.path.join(args.out, name), "w") as f:
                        json.dump(rec, f, indent=1)
                    s = rec["status"]
                    n_ok += s == "ok"
                    n_skip += s == "skip"
                    n_err += s == "error"
                    if s == "ok":
                        r = rec["roofline"]
                        print(f"[{s:5s}] {arch:22s} {shape:12s} {rec['mesh']:8s} "
                              f"mem/dev={rec['bytes_per_device']/2**30:6.2f}GiB "
                              f"Tc={r['t_compute_s']:.3e} Tm={r['t_memory_s']:.3e} "
                              f"Tcoll={r['t_collective_s']:.3e} dom={r['dominant']:10s} "
                              f"trace={rec['t_lower_s']:.0f}s", flush=True)
                    else:
                        print(f"[{s:5s}] {arch:22s} {shape:12s} {rec['mesh']:8s} "
                              f"{rec.get('reason', rec.get('error', ''))[:100]}",
                              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done: ok={n_ok} skip={n_skip} error={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
