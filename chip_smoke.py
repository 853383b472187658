#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases build,kernels

Phases, each of which raises (exit code != 0) when it fails:

  gpu      the card's name and power limit, from nvidia-smi;
  build    the CUDA kernels built from src/repro_torch/csrc with nvcc;
  kernels  each kernel against its plain PyTorch version on the card, in
           bf16 and fp32, at ``kernels.TOLERANCE``, with its device time,
           the plain version's, one library call's as a yardstick, and the
           least time the card could take (bytes or operations at the
           H100's peak rates); then faults planted in the kernels' inputs
           (a length one short, a window one long) must be rejected;
  parity   qwen2.5-3b at full width, 2 layers, fp32: prefill and one
           fused decode block on the card (kernels) against the same
           weights on the CPU (plain versions);
  serve    qwen2.5-3b at full width (36 layers, bf16, random weights from
           a seed) through ``build_engine``: 8 requests, speculation on
           and off; the token streams must agree and the kernel launch
           counts must be the exact multiples the model implies;
  profile  where one decode block of the full model spends its time:
           wall time, device busy time under torch.profiler, idle share.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's ``src/repro_torch`` beside it, the script exits non-zero
before printing either.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("gpu", "build", "kernels", "parity", "serve", "profile")

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s and peak ops/s by type
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50e6


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing --
def device_ms(fn, args_list, replays=5):
    """Mean device time of one ``fn(*args)``: one call per entry of
    ``args_list`` captured once in a CUDA graph (so host overhead does not
    count), the graph replayed ``replays`` times between CUDA events."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for a in args_list:
            fn(*a)
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(args_list))


def cold_copies(make, nbytes):
    """Enough independent copies of a call's inputs that cycling through
    them reads each from device memory, not from the 50 MB L2."""
    n = min(64, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(n)]


def bound(nbytes, ops, dtype_name):
    """(least ms the card could take, which of the two bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases --
def phase_gpu(state):
    import torch
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    log(r.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def phase_build(state):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"build: {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")


def _agree(got, want, tol):
    """(kernel within atol = rtol = tol of its plain version, max |err|)."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    return ok and math.isfinite(err), err


def _check(name, got, want, tol):
    ok, err = _agree(got, want, tol)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max |err| {err} > tol {tol}")
    return err


def _reject(name, got, want, tol):
    """A planted fault must fail the check that the kernel passes."""
    ok, err = _agree(got, want, tol)
    if ok:
        raise AssertionError(f"{name}: tolerance {tol} did not reject a "
                             f"planted fault (max |err| {err})")
    log(f"kernels: planted fault {name}: rejected, max |err| {err:.3g} "
        f"against tol {tol}")


def phase_kernels(state):
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, dt: torch.randn(*shape, generator=gen, device=dev,
                                           dtype=torch.float32).to(dt)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    tols = {name: K.TOLERANCE[dt] for name, dt in dts.items()}
    rows = state["kernel_rows"] = {}

    def record(kernel, case, main, err, args_list, run, plain, library,
               nbytes, ops, dname):
        ms = device_ms(run, args_list)
        plain_ms = device_ms(plain, args_list)
        lib_ms = device_ms(library, args_list) if library else None
        b_ms, b_by = bound(nbytes, ops, dname)
        log(f"kernels: {kernel:16s} {case:38s} err {err:.3g}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
            f"{b_ms:.4f} ms ({b_by})")
        if main:
            rows[kernel] = dict(case=case, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=b_by)

    # rmsnorm [4*512, 2048], the prefill rows of 4 requests of 512 tokens
    R, D = 4 * 512, 2048
    for dname, dt in dts.items():
        esz = torch.finfo(dt).bits // 8

        def make(dt=dt):
            return (randn(R, D, dt=dt),
                    torch.randn(D, generator=gen, device=dev) * 0.1 + 1.0)
        args_list = cold_copies(make, R * D * esz)
        x, sc = args_list[0]
        err = _check(f"rmsnorm {dname}", K.rmsnorm(x, sc),
                     K.rmsnorm_plain(x, sc), tols[dname])
        weights = {sc.data_ptr(): sc.to(dt) for _, sc in args_list}
        lib = lambda x, sc, w=weights: F.rms_norm(x, (D,), w[sc.data_ptr()],
                                                  1e-5)
        record("rmsnorm", f"[{R},{D}] {dname}", dname == "bfloat16", err,
               args_list, K.rmsnorm, K.rmsnorm_plain, lib,
               2 * R * D * esz + 4 * D, 4 * R * D, "float32")

    # flash attention: q [1,S,16,128] vs k/v [1,S,2,128]
    H, Hkv, hd = 16, 2, 128
    for S, window in ((37, 0), (512, 0), (512, 128)):
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8

            def make(dt=dt, S=S):
                return (randn(1, S, H, hd, dt=dt), randn(1, S, Hkv, hd, dt=dt),
                        randn(1, S, Hkv, hd, dt=dt))
            args_list = cold_copies(make, (2 * S * H + 2 * S * Hkv) * hd * esz)
            q, k, v = args_list[0]
            run = lambda q, k, v, w=window: K.flash_attention(
                q, k, v, causal=True, window=w)
            plain = lambda q, k, v, w=window: K.flash_attention_plain(
                q, k, v, causal=True, window=w)
            err = _check(f"flash S={S} window={window} {dname}", run(q, k, v),
                         plain(q, k, v), tols[dname])
            if window:
                _reject(f"flash S={S} window {window}+1 {dname}",
                        K.flash_attention(q, k, v, causal=True,
                                          window=window + 1),
                        plain(q, k, v), tols[dname])
            i = torch.arange(S)
            vis = i[:, None] >= i[None, :]
            if window:
                vis &= i[:, None] - i[None, :] < window
                mask = vis.to(dev)
                lib = lambda q, k, v, m=mask: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=m, enable_gqa=True)
            else:
                lib = lambda q, k, v: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True)
            pairs = int(vis.sum())
            record("flash_attention",
                   f"S={S} causal window={window} {dname}",
                   (S, window, dname) == (512, 0, "bfloat16"), err, args_list,
                   run, plain, lib, (2 * S * H + 2 * S * Hkv) * hd * esz,
                   4 * hd * H * pairs, dname)

    # decode attention: q [4,16,128] vs caches [4,1024,2,128]
    B, W = 4, 1024
    lens_host = torch.randint(1, W + 1, (B,), generator=torch.Generator()
                              .manual_seed(0), dtype=torch.int32)
    lens = lens_host.to(dev)
    for dname, dt in dts.items():
        esz = torch.finfo(dt).bits // 8

        def make(dt=dt):
            return (randn(B, H, hd, dt=dt), randn(B, W, Hkv, hd, dt=dt),
                    randn(B, W, Hkv, hd, dt=dt), lens.clone())
        args_list = cold_copies(make, 2 * B * W * Hkv * hd * esz)
        q, kc, vc, ln = args_list[0]
        err = _check(f"decode {dname}", K.decode_attention(q, kc, vc, ln),
                     K.decode_attention_plain(q, kc, vc, ln), tols[dname])
        if dname == "float32":
            _reject(f"decode lengths-1 {dname}",
                    K.decode_attention(q, kc, vc, (ln - 1).clamp_min(1)),
                    K.decode_attention_plain(q, kc, vc, ln), tols[dname])
        valid = (torch.arange(W, device=dev)[None] < lens[:, None])

        def lib(q, kc, vc, ln, m=valid[:, None, None, :]):
            return F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=m, enable_gqa=True)
        n_valid = int(lens_host.sum())
        record("decode_attention",
               f"B={B} W={W} lengths={lens_host.tolist()} {dname}",
               dname == "bfloat16", err, args_list, K.decode_attention,
               K.decode_attention_plain, lib,
               (2 * B * H * hd + 2 * n_valid * Hkv * hd) * esz + 4 * B,
               4 * hd * H * n_valid, dname)

    # the other head dims and group sizes the kernels take (smoke widths)
    for (Bx, Sq, Sk, Hx, Hk, hdx, causal, win) in (
            (2, 13, 13, 4, 2, 16, True, 0), (2, 64, 64, 4, 4, 64, True, 0),
            (1, 32, 96, 8, 2, 32, True, 0), (2, 70, 70, 4, 1, 32, True, 24),
            (1, 40, 40, 2, 2, 128, False, 0)):
        for dname, dt in dts.items():
            q = randn(Bx, Sq, Hx, hdx, dt=dt)
            k, v = randn(Bx, Sk, Hk, hdx, dt=dt), randn(Bx, Sk, Hk, hdx, dt=dt)
            err = _check(f"flash {q.shape} {k.shape} {dname}",
                         K.flash_attention(q, k, v, causal=causal, window=win),
                         K.flash_attention_plain(q, k, v, causal=causal,
                                                 window=win), tols[dname])
            qd = randn(Bx, Hx, hdx, dt=dt)
            ln = torch.randint(1, Sk + 1, (Bx,), device=dev, dtype=torch.int32,
                               generator=gen)
            err_d = _check(f"decode {qd.shape} {k.shape} {dname}",
                           K.decode_attention(qd, k, v, ln),
                           K.decode_attention_plain(qd, k, v, ln), tols[dname])
            log(f"kernels: extra hd={hdx} G={Hx // Hk} {dname}: flash err "
                f"{err:.3g}, decode err {err_d:.3g}")
    torch.cuda.synchronize()


def phase_parity(state):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.cache import cache_leaves
    from repro_torch.training import steps as ST

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2,
                              dtype="float32")
    cpu_params = M.init_params(cfg, seed=0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to("cuda")
    cache_len, k = 128, 8
    rng = np.random.default_rng(1)
    lens = [37, 21]
    toks = rng.integers(3, cfg.vocab_size, (2, max(lens))).astype("int32")
    toks[1, lens[1]:] = 0
    prefill = ST.make_batched_prefill_step(cfg, cache_len)
    fused = ST.make_fused_decode_step(cfg, k=k)
    res = {}
    for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        t = torch.as_tensor(toks, device=dev)
        ln = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        out, caches = prefill(params, t, ln)
        logits, _ = M.forward(params, cfg, {"tokens": t})
        pos = ln.clone()
        step_logits, _ = M.decode_step(params, cfg, out["next_tokens"], pos,
                                       copy.deepcopy(caches))
        blk, caches = fused(params, out["next_tokens"], pos, caches)
        res[dev] = dict(logits=logits.cpu(), step=step_logits.cpu(),
                        caches=[c.cpu() for c in cache_leaves(caches)],
                        first=out["next_tokens"].cpu(),
                        **{n: blk[n].cpu() for n in ("tokens", "pos", "done")})
    g, c = res["cuda"], res["cpu"]
    for name in ("logits", "step"):
        err = (g[name] - c[name]).abs().max().item()
        assert torch.allclose(g[name], c[name], atol=1e-3, rtol=1e-3), \
            f"parity: {name} differ, max |err| {err}"
        log(f"parity: {name} {tuple(g[name].shape)} max |err| {err:.3g}")
    cerr = max((a - b).abs().max().item()
               for a, b in zip(g["caches"], c["caches"]))
    assert cerr <= 1e-3, f"parity: caches differ by {cerr}"
    for name in ("first", "tokens", "pos", "done"):
        assert torch.equal(g[name], c[name]), \
            f"parity: {name} differ: {g[name].tolist()} vs {c[name].tolist()}"
    log(f"parity: caches max |err| {cerr:.3g}; next tokens, fused-block "
        f"tokens/pos/done equal: {g['tokens'].tolist()}")


def phase_serve(state):
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import model as M

    cfg = get_config("qwen2.5-3b")
    L, block_k, max_new = cfg.num_layers, 8, 32
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve: {cfg.name} {n_params / 1e9:.3f} B params ({cfg.dtype}) "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(3, cfg.vocab_size,
                                          int(rng.integers(16, 201)))))
               for _ in range(8)]
    runs = {}
    for speculate in (True, False):
        eng = build_engine(cfg, n_slots=4, cache_len=1024, block_k=block_k,
                           pipeline_depth=4, params=params, device="cuda",
                           speculate=speculate)
        for p in prompts:
            eng.submit(p, max_new)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in K.KERNELS}
        st = eng.stats
        ntok = sum(len(v) for v in outs.values())
        mode = "spec" if speculate else "sync"
        log(f"serve[{mode}]: {ntok} tokens in {dt:.3f} s "
            f"({ntok / dt:.1f} tok/s); stats {dict(st)}; launches {launches}")
        pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
        assert launches["flash_attention"] == L * pd, launches
        assert launches["decode_attention"] == L * block_k * bd, launches
        assert launches["rmsnorm"] == (2 * L + 1) * (pd + block_k * bd), \
            launches
        for rid, toks in outs.items():
            assert 1 <= len(toks) <= max_new, (rid, len(toks))
            assert all(0 <= t < cfg.vocab_size for t in toks), rid
            assert len(toks) == max_new or toks[-1] == 2, (rid, toks)
        runs[mode] = (outs, launches, dt, ntok, dict(st))
    assert runs["spec"][0] == runs["sync"][0], \
        "serve: speculative and synchronous token streams differ"
    assert runs["spec"][4]["host_syncs"] < runs["sync"][4]["host_syncs"]
    state["launches"] = runs["spec"][1]
    state["params"] = params
    log("serve: speculative and synchronous token streams are identical")


def phase_profile(state):
    """Where one fused decode block's time goes at full width: host clock
    around a synchronous block, and torch.profiler's device kernels for
    the same block (busy = union of kernel intervals)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import model as M

    cfg = get_config("qwen2.5-3b")
    params = state.get("params")
    if params is None:
        params = M.init_params(cfg, seed=0, device="cuda")
    eng = build_engine(cfg, n_slots=4, cache_len=1024, block_k=8,
                       params=params, device="cuda", speculate=False)
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(list(map(int, rng.integers(3, cfg.vocab_size, 128))), 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_block()                   # admission: one batched prefill
    torch.cuda.synchronize()
    log(f"profile: prefill 4x128 + first block: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall")
    eng.step_block()                   # warm
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step_block()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = min(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step_block()
        torch.cuda.synchronize()
    kern = sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in kern:
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + (cur_e - cur_s if cur_e is not None else 0)) / 1e3
    log(f"profile: one 8-step decode block, 4 slots: {wall:.2f} ms wall "
        f"(best of {walls}); device busy {busy:.2f} ms over {len(kern)} "
        f"kernels; device idle share {1 - busy / wall:.3f}")
    by_dev = prof.key_averages().table(sort_by="self_device_time_total",
                                       row_limit=8, max_name_column_width=40)
    by_cpu = prof.key_averages().table(sort_by="self_cpu_time_total",
                                       row_limit=8, max_name_column_width=40)
    log("profile: top by device time\n" + by_dev)
    log("profile: top by host time\n" + by_cpu)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False

    state = {}
    t_all = time.perf_counter()
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            globals()[f"phase_{name}"](state)
            log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    log(f"all phases: {time.perf_counter() - t_all:.1f} s")

    from repro_torch import kernels as K
    if "kernels" in phases and "serve" in phases:
        summary = []
        for k in K.KERNELS:
            mod = sys.modules[k.__module__]
            row = state["kernel_rows"][k.__name__]
            summary.append({
                "name": k.__name__, "route": "cuda", "source": mod.SOURCE,
                "replaces": mod.REPLACES,
                "launches": state["launches"][k.__name__],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "case": row["case"]})
        print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
