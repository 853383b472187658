#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases build,kernels

Phases, each of which raises (exit code != 0) when it fails:

  gpu      the card's name and power limit, from nvidia-smi;
  build    the CUDA kernels built from src/repro_torch/csrc with nvcc, and
           ptxas's registers, shared memory and spills for the attention
           kernels, moe_gmm, rmsnorm and the scans (which must not spill);
  kernels  each kernel against its plain PyTorch version on the card, in
           bf16 and fp32, at ``kernels.TOLERANCE``, with its device time,
           the plain version's, one library call's as a yardstick where
           one exists, and the least time the card could take (bytes or
           operations at the H100's peak rates), at the shapes qwen2.5-3b,
           zamba2-1.2b, xlstm-350m and deepseek-v2-lite-16b give it (and
           one mixtral-8x22b expert product; decode attention also at
           starcoder2-7b's group of 9 and mixtral-8x22b's of 6); the
           attention kernels over every head-dim pair, group size, ragged
           length and split boundary they take; moe_gmm at every row tile's edges (R = 1,
           8, 9, 64, 65) and at a D off the ring's step; rmsnorm on both
           of its paths; the scans at six (B, Q, nc) cases with bf16 and
           fp32 inputs; the HMMA count of the flash, moe_gmm and scan
           kernels' SASS; then faults planted in the kernels' inputs or
           plans (a length one short, a window one long, the causal tile
           skip one tile short, the last split of a decode dropped, the
           scan state not carried across a chunk boundary, a causal mask
           one off, a scan's kernel chunk reading the wrong chunk's
           entering state, a scan's bf16 splits cut to their first part,
           cum not rebased across caller chunks, the scale taken from
           hd_v, a decode group's last head dropped (G = 9 and 6), the
           last D tile left out of an expert product, an expert
           reading its neighbour's weights, a stale tile in moe_gmm's
           ring, its last 8-row group dropped, its plan one work item
           short, an rmsnorm row summed over its first warp's share) must
           be rejected;
  parity   qwen2.5-3b (2 layers), zamba2-1.2b (2 groups, 12 Mamba2
           layers), xlstm-350m (1 group, 6 layers) and deepseek-v2-lite-16b
           (one MLA dense layer and one MLA MoE layer) at full width in
           fp32: prefill, its caches, one decode step and one fused decode
           block on the card (kernels) against the same weights on the CPU
           (plain versions);
  serve    each model at full width and depth (bf16, random weights from
           a seed) through ``build_engine``: 8 requests (and a ninth of
           300 tokens for the recurrent models, so that a prefill scans
           two chunks, or of 256 for deepseek), qwen2.5-3b and deepseek
           with speculation on and off (the token streams must agree), the
           recurrent models and starcoder2-7b (G = 9, sliding window) once
           (speculation is forced off for the recurrent ones); the kernel
           launch counts must be the exact multiples each model implies;
  prefill  where one 300-token prefill of zamba2-1.2b and xlstm-350m
           spends its time: wall time, device busy time, idle share, each
           custom kernel's device time and launches; then each scan alone
           at every case (public wrappers only, so a parent tree runs
           this phase as it is; timed once a run, the kernels phase
           reports the same times);
  profile  where one decode block of qwen2.5-3b, zamba2-1.2b and
           deepseek-v2-lite-16b (or those of --profile-archs) spends its
           time: wall time, device busy time under torch.profiler, idle
           share, and each custom kernel's device time and launches;
  replay   record -> sign -> replay of qwen2.5-3b at full width: prefill
           and the fused decode block recorded (``torch.export``, params as
           inputs) and signed by the record launcher's code, every tampered
           form refused before ``torch.export.load``, 8 prompts of 128
           tokens served live, replayed eagerly and replayed through the
           decode block's CUDA graph (identical tokens, host syncs and
           launches), and one decode block profiled under the graph beside
           live.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's ``src/repro_torch`` beside it, the script exits non-zero
before printing either.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("gpu", "build", "kernels", "parity", "serve", "prefill", "profile",
          "replay")

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
    """(least ms the card could take, which of the two bounds it).
    ``ops`` counts operations at ``dtype_name``'s peak, or is a dict
    {dtype name: count} for work whose products run at different peaks."""
    if not isinstance(ops, dict):
        ops = {dtype_name: ops}
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS_S[d] for d, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases --
def _card(state):
    """The card's name and power limit as nvidia-smi prints them."""
    if "card" not in state:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True)
        state["card"] = r.stdout.strip().splitlines()[0]
    return state["card"]


def phase_gpu(state):
    import torch
    log(_card(state))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def _toolkit_tool(name):
    from repro_torch.kernels import _build
    path = shutil.which(name)
    if path is None:
        cand = Path(_build._nvcc()).parent / name
        path = str(cand) if cand.exists() else None
    return path


def _kernel_names(mangled):
    """{mangled: 'name<args>'} by cu++filt where the toolkit has it."""
    names = dict.fromkeys(mangled)
    filt = _toolkit_tool("cu++filt")
    if filt and mangled:
        out = subprocess.run([filt], input="\n".join(mangled),
                             capture_output=True, text=True).stdout
        for m, d in zip(mangled, out.splitlines()):
            d = d[:d.find(">(") + 1] if ">(" in d else d
            d = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|"
                       r"\(int\)", "", d)
            names[m] = d if ">" in d else d.split("(")[0]
    return {m: n or m for m, n in names.items()}


PTXAS_KEYS = ("flash_attention", "decode_attention", "moe_gmm", "rmsnorm",
              "mamba_scan", "mlstm_scan")


def _ptxas_report(text, keys=PTXAS_KEYS):
    """ptxas -v's registers, static shared memory and spills for every
    kernel entry whose name holds one of ``keys``."""
    rows, cur = {}, None
    for line in text.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            cur = hit.group(1) if any(k in hit.group(1) for k in keys) \
                else None
            if cur:
                rows[cur] = {}
            continue
        if cur is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit:
            rows[cur]["spills"] = (int(hit.group(1)), int(hit.group(2)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            rows[cur]["registers"] = int(hit.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[cur]["smem"] = int(smem.group(1)) if smem else 0
    names = _kernel_names(list(rows))
    return {names[m]: r for m, r in rows.items()}


def phase_build(state):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"build: {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    report = _ptxas_report(_build.ptxas_log(path).read_text())
    missing = [k for k in PTXAS_KEYS if not any(k in n for n in report)]
    assert not missing, f"build: no ptxas report for {missing}"
    for name, r in sorted(report.items()):
        log(f"build: ptxas {name}: {r.get('registers')} registers, "
            f"{r.get('smem')} B static shared memory, spill stores/loads "
            f"{r.get('spills')} B (dynamic shared memory is set at launch)")
    spilled = {n: r.get("spills") for n, r in report.items()
               if "_scan_" in n and r.get("spills") != (0, 0)}
    assert not spilled, f"build: the scan kernels spill: {spilled}"


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
               nbytes, ops, dname, ms=None):
        ms = device_ms(run, args_list) if ms is None else ms
        plain_ms = device_ms(plain, args_list)
        lib_ms = device_ms(library, args_list) if library else None
        b_ms, b_by = bound(nbytes, ops, dname)
        lib_txt = "none (no single PyTorch call computes this)" \
            if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"kernels: {kernel:16s} {case:38s} err {err:.3g}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib_txt}  "
            f"bound {b_ms:.4f} ms ({b_by})")
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
    _rmsnorm_kernels(randn, record, tols)

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

    # q/k/v of the same shapes, bidirectional: every block walks all 8 K
    # tiles, so against the causal case it shows what the longest query
    # tile's walk costs
    def make(S=512):
        return (randn(1, S, H, hd, dt=torch.bfloat16),
                randn(1, S, Hkv, hd, dt=torch.bfloat16),
                randn(1, S, Hkv, hd, dt=torch.bfloat16))
    args_list = cold_copies(make, (2 * 512 * H + 2 * 512 * Hkv) * hd * 2)
    run = lambda q, k, v: K.flash_attention(q, k, v, causal=False)
    plain = lambda q, k, v: K.flash_attention_plain(q, k, v, causal=False)
    err = _check("flash S=512 bidirectional bfloat16", run(*args_list[0]),
                 plain(*args_list[0]), tols["bfloat16"])
    lib = lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True)
    record("flash_attention", "S=512 bidirectional bfloat16", False, err,
           args_list, run, plain, lib, (2 * 512 * H + 2 * 512 * Hkv) * hd * 2,
           4 * hd * H * 512 * 512, "bfloat16")

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

    # the shapes the recurrent models add: rmsnorm at the widths of the
    # Mamba2 inner norm, the mLSTM and the sLSTM over a 300-token prefill
    for D in (4096, 2048, 1024):
        def make(D=D):
            return (randn(300, D, dt=torch.bfloat16),
                    torch.randn(D, generator=gen, device=dev) * 0.1 + 1.0)
        args_list = cold_copies(make, 300 * D * 2)
        x, sc = args_list[0]
        err = _check(f"rmsnorm [300,{D}]", K.rmsnorm(x, sc),
                     K.rmsnorm_plain(x, sc), tols["bfloat16"])
        weights = {sc.data_ptr(): sc.to(torch.bfloat16) for _, sc in args_list}
        lib = lambda x, sc, w=weights, D=D: F.rms_norm(
            x, (D,), w[sc.data_ptr()], 1e-5)
        record("rmsnorm", f"[300,{D}] bfloat16", False, err, args_list,
               K.rmsnorm, K.rmsnorm_plain, lib, 2 * 300 * D * 2 + 4 * D,
               4 * 300 * D, "float32")

    # zamba2's shared attention: 32 query and 32 KV heads of 64 (G = 1)
    Hz, hdz, Sz = 32, 64, 300
    for dname, dt in dts.items():
        esz = torch.finfo(dt).bits // 8

        def make(dt=dt):
            return tuple(randn(1, Sz, Hz, hdz, dt=dt) for _ in range(3))
        args_list = cold_copies(make, 4 * Sz * Hz * hdz * esz)
        q, k, v = args_list[0]
        run = lambda q, k, v: K.flash_attention(q, k, v, causal=True)
        plain = lambda q, k, v: K.flash_attention_plain(q, k, v, causal=True)
        err = _check(f"flash zamba2 S={Sz} {dname}", run(q, k, v),
                     plain(q, k, v), tols[dname])
        lib = lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)
        record("flash_attention", f"zamba2 S={Sz} H=32 G=1 hd=64 {dname}",
               False, err, args_list, run, plain, lib,
               4 * Sz * Hz * hdz * esz, 4 * hdz * Hz * Sz * (Sz + 1) // 2,
               dname)

        def make(dt=dt):
            return (randn(B, Hz, hdz, dt=dt), randn(B, W, Hz, hdz, dt=dt),
                    randn(B, W, Hz, hdz, dt=dt), lens.clone())
        args_list = cold_copies(make, 2 * B * W * Hz * hdz * esz)
        q, kc, vc, ln = args_list[0]
        err = _check(f"decode zamba2 {dname}", K.decode_attention(q, kc, vc, ln),
                     K.decode_attention_plain(q, kc, vc, ln), tols[dname])

        def lib(q, kc, vc, ln, m=valid[:, None, None, :]):
            return F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=m)
        record("decode_attention",
               f"zamba2 B={B} W={W} H=32 G=1 hd=64 {dname}", False, err,
               args_list, K.decode_attention, K.decode_attention_plain, lib,
               (2 * B * Hz * hdz + 2 * n_valid * Hz * hdz) * esz + 4 * B,
               4 * hdz * Hz * n_valid, dname)

    # the groups that do not divide the block: starcoder2-7b's 36 query
    # heads over 4 KV heads (G = 9) and mixtral-8x22b's 48 over 8 (G = 6)
    for arch, Hg, Hkg in (("starcoder2-7b", 36, 4), ("mixtral-8x22b", 48, 8)):
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8

            def make(dt=dt, Hg=Hg, Hkg=Hkg):
                return (randn(B, Hg, hd, dt=dt), randn(B, W, Hkg, hd, dt=dt),
                        randn(B, W, Hkg, hd, dt=dt), lens.clone())
            args_list = cold_copies(make, 2 * B * W * Hkg * hd * esz)
            q, kc, vc, ln = args_list[0]
            G = Hg // Hkg
            err = _check(f"decode {arch} G={G} {dname}",
                         K.decode_attention(q, kc, vc, ln),
                         K.decode_attention_plain(q, kc, vc, ln), tols[dname])

            def lib(q, kc, vc, ln, m=valid[:, None, None, :]):
                return F.scaled_dot_product_attention(
                    q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=m, enable_gqa=True)
            record("decode_attention",
                   f"{arch} B={B} W={W} H={Hg} G={G} hd={hd} {dname}", False,
                   err, args_list, K.decode_attention,
                   K.decode_attention_plain, lib,
                   (2 * B * Hg * hd + 2 * n_valid * Hkg * hd) * esz + 4 * B,
                   4 * hd * Hg * n_valid, dname)

    _attention_sweep(randn, tols, dev)
    _scan_kernels(randn, record, _scan_times(randn, state))
    _moe_kernels(randn, record, tols)
    torch.cuda.synchronize()


def _rmsnorm_kernels(randn, record, tols):
    """rmsnorm at a decode step's [4, 2048] (the shape qwen2.5-3b launches
    73 times a token) in both dtypes and at [2048, 8192] in fp32 (the
    widest row of the configs, 32 KB), all on the block path (rows over
    2 KB), with its planted fault: a row summed over its first warp's
    share alone."""
    import importlib
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")

    dev = torch.device("cuda")
    for (R, D), dname, dt in (((4, 2048), "bfloat16", torch.bfloat16),
                              ((4, 2048), "float32", torch.float32),
                              ((2048, 8192), "float32", torch.float32)):
        esz = torch.finfo(dt).bits // 8

        def make(R=R, D=D, dt=dt):
            return (randn(R, D, dt=dt),
                    randn(D, dt=torch.float32) * 0.1 + 1.0)
        args_list = cold_copies(make, R * D * esz)
        x, sc = args_list[0]
        want = K.rmsnorm_plain(x, sc)
        err = _check(f"rmsnorm [{R},{D}] {dname}", K.rmsnorm(x, sc), want,
                     tols[dname])
        plan = RN.plan_rmsnorm(R, D, esz, _build.sm_count(dev))
        if not plan.per_warp:
            _reject(f"rmsnorm [{R},{D}] {dname} {plan} summed over the "
                    f"first warp's share", RN._launch(
                        x, sc, 1e-5, fault=RN.FAULT_FIRST_WARP_ONLY),
                    want, tols[dname])
        weights = {sc.data_ptr(): sc.to(dt) for _, sc in args_list}
        lib = lambda x, sc, w=weights, D=D: F.rms_norm(
            x, (D,), w[sc.data_ptr()], 1e-5)
        record("rmsnorm", f"[{R},{D}] {dname}", False, err, args_list,
               K.rmsnorm, K.rmsnorm_plain, lib, 2 * R * D * esz + 4 * D,
               4 * R * D, "float32")
        del args_list, x, sc


def _sass_mma_counts(keys=("flash_attention", "moe_gmm", "mlstm_scan",
                           "mamba_scan")):
    """HMMA/HGMMA instructions in the SASS of each kernel whose name holds
    one of ``keys``, by cuobjdump where the toolkit has it (None where it
    does not)."""
    from repro_torch.kernels import _build
    tool = _toolkit_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            cur = hit.group(1) if any(k in hit.group(1) for k in keys) \
                else None
            if cur:
                counts[cur] = 0
        elif cur and re.search(r"\bH(G)?MMA\b", line):
            counts[cur] += 1
    names = _kernel_names(list(counts))
    return {names[m]: n for m, n in counts.items()}


# the attention kernels' sweep: every (hd, hd_v) pair and group size G at
# ragged lengths around the 16-row warp tile and the 64-key tile
FLASH_SWEEP_S = (1, 15, 16, 17, 63, 64, 65, 300, 512)
FLASH_SWEEP_G = (1, 2, 8, 16)
DECODE_SWEEP_W = (64, 1024, 4096)


def _decode_sweep_lengths(W, chunk):
    """1, a split boundary - 1, the boundary, boundary + 1 and W."""
    return sorted({1, max(1, chunk - 1), min(W, chunk), min(W, chunk + 1), W})


def _attention_sweep(randn, tols, dev):
    """Both attention kernels against their plain versions over the shapes
    they take; then the two planted faults of their redesign."""
    import importlib
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    DA = importlib.import_module("repro_torch.kernels.decode_attention")

    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    worst, n = {}, 0
    for dname, dt in dts.items():
        tol = tols[dname]
        for hd, hd_v in FA.HEAD_DIM_PAIRS:
            for G in FLASH_SWEEP_G:
                for S in FLASH_SWEEP_S:
                    q = randn(1, S, G, hd, dt=dt)
                    k, v = randn(1, S, 1, hd, dt=dt), randn(1, S, 1, hd_v, dt=dt)
                    err = _check(f"flash sweep hd={hd}/{hd_v} G={G} S={S} "
                                 f"{dname}", K.flash_attention(q, k, v),
                                 K.flash_attention_plain(q, k, v), tol)
                    worst[("flash", dname)] = max(worst.get(("flash", dname),
                                                            0.0), err)
                    n += 1
        for (B, Sq, Sk, H, Hkv, hd, window) in (
                (4, 65, 65, 8, 2, 64, 0), (1, 37, 300, 16, 2, 128, 0),
                (2, 300, 300, 8, 1, 64, 24), (1, 512, 512, 16, 2, 128, 128),
                (1, 100, 100, 16, 1, 192, 24)):
            hd_v = 128 if hd == 192 else hd
            q = randn(B, Sq, H, hd, dt=dt)
            k, v = randn(B, Sk, Hkv, hd, dt=dt), randn(B, Sk, Hkv, hd_v, dt=dt)
            err = _check(f"flash B={B} Sq={Sq} Sk={Sk} hd={hd} window={window} "
                         f"{dname}", K.flash_attention(q, k, v, window=window),
                         K.flash_attention_plain(q, k, v, window=window), tol)
            worst[("flash", dname)] = max(worst[("flash", dname)], err)
            n += 1
        sm = _build.sm_count(dev)
        for hd in FA.HEAD_DIMS:
            for G in DA.GROUP_SIZES:
                for W in DECODE_SWEEP_W:
                    for B in (1, 4):
                        plan = DA.plan_splits(B, 2, W, sm)
                        lens = _decode_sweep_lengths(W, plan.chunk)
                        sets = [[x] for x in lens] if B == 1 else \
                            [[lens[0], lens[-3], lens[-2], lens[-1]]]
                        q = randn(B, 2 * G, hd, dt=dt)
                        kc, vc = randn(B, W, 2, hd, dt=dt), randn(B, W, 2, hd,
                                                                  dt=dt)
                        for ls in sets:
                            ln = torch.tensor(ls, dtype=torch.int32,
                                              device=dev)
                            err = _check(
                                f"decode sweep hd={hd} G={G} W={W} B={B} "
                                f"lengths={ls} {plan} {dname}",
                                K.decode_attention(q, kc, vc, ln),
                                K.decode_attention_plain(q, kc, vc, ln), tol)
                            worst[("decode", dname)] = max(
                                worst.get(("decode", dname), 0.0), err)
                            n += 1
    log(f"kernels: attention sweep: {n} cases agree; max |err| "
        + ", ".join(f"{k} {d} {e:.3g}" for (k, d), e in sorted(worst.items())))

    # planted: the causal tile skip one tile short (q [1,512,16,128])
    for dname, dt in dts.items():
        q = randn(1, 512, 16, 128, dt=dt)
        k, v = randn(1, 512, 2, 128, dt=dt), randn(1, 512, 2, 128, dt=dt)
        want = K.flash_attention_plain(q, k, v)
        _reject(f"flash S=512 causal tile skip one tile short {dname}",
                FA._launch(q, k, v, True, 0, 128 ** -0.5, 0, short_tiles=1),
                want, tols[dname])
    # planted: the last split's partial state dropped, at lengths = its
    # first slot (B 4, W 1024: 16 splits of 64, lengths 961)
    plan = DA.plan_splits(4, 2, 1024, _build.sm_count(dev))
    ln = torch.full((4,), (plan.splits - 1) * plan.chunk + 1,
                    dtype=torch.int32, device=dev)
    for dname, dt in dts.items():
        q = randn(4, 16, 128, dt=dt)
        kc, vc = randn(4, 1024, 2, 128, dt=dt), randn(4, 1024, 2, 128, dt=dt)
        want = K.decode_attention_plain(q, kc, vc, ln)
        _check(f"decode {plan} lengths {int(ln[0])} {dname}",
               K.decode_attention(q, kc, vc, ln), want, tols[dname])
        if dname == "float32":  # bf16 cannot see one slot among 961
            _reject(f"decode last split dropped {plan} lengths "
                    f"{int(ln[0])} {dname}",
                    DA._launch(q, kc, vc, ln, 128 ** -0.5,
                               DA.SplitPlan(plan.splits - 1, plan.chunk)),
                    want, tols[dname])

    # planted: a group's last head dropped (what the truncating DV of the
    # kernel before groups of 6 and 9 left unwritten), at starcoder2-7b's
    # and mixtral-8x22b's groups
    for Hg, Hkg in ((36, 4), (48, 8)):
        ln = torch.tensor([1, 300, 777, 1024], dtype=torch.int32, device=dev)
        for dname, dt in dts.items():
            q = randn(4, Hg, 128, dt=dt)
            kc, vc = randn(4, 1024, Hkg, 128, dt=dt), randn(4, 1024, Hkg, 128,
                                                            dt=dt)
            want = K.decode_attention_plain(q, kc, vc, ln)
            _check(f"decode G={Hg // Hkg} lengths {ln.tolist()} {dname}",
                   DA._launch(q, kc, vc, ln, 128 ** -0.5), want, tols[dname])
            _reject(f"decode G={Hg // Hkg} last head dropped {dname}",
                    DA._launch(q, kc, vc, ln, 128 ** -0.5,
                               fault=DA.FAULT_DROP_LAST_HEAD),
                    want, tols[dname])

    counts = _sass_mma_counts()
    if counts is None:
        log("kernels: cuobjdump not found: no SASS count")
    else:
        for name, c in sorted(counts.items()):
            log(f"kernels: SASS {name}: {c} HMMA/HGMMA instructions")
        for key in ("flash_attention_mma", "moe_gmm_mma", "moe_gmm_wgmma"):
            mma = {k: c for k, c in counts.items() if key in k}
            assert mma and all(mma.values()), \
                f"kernels: the bf16 {key} kernels hold no HMMA: {counts}"
        # the scans' bf16 products: every scan kernel (the SSD's: C B^T
        # and the state update, then the carried term)
        for key in ("mlstm_scan_chunk_kernel", "mlstm_scan_out_kernel",
                    "mamba_scan_chunk_kernel", "mamba_scan_out_kernel"):
            mma = {k: c for k, c in counts.items()
                   if key in k and "bfloat16" in k}
            assert mma and all(mma.values()), \
                f"kernels: the bf16 {key} holds no HMMA: {counts}"


# the chunk scans' cases (B, Q, nc): zamba2-1.2b's and xlstm-350m's
# Q = pick_chunk(S, 256) for prompts of 128, 300, 1024 and 257 (prime)
# tokens, two 300-token requests at once, and 320 tokens (two chunks of
# 160, kernel chunks across a caller chunk's edge)
SCAN_CASES = ((1, 128, 1), (1, 150, 2), (1, 256, 4), (1, 1, 257),
              (2, 150, 2), (1, 160, 2))
SCAN_MAIN = (1, 150, 2)


def _scan_inputs(randn, which, B, Q, nc, dt):
    """The scans' inputs at full width with ``dt`` for B/C (SSD) or q, k,
    v (mLSTM); xbar, cum, cumf and li are fp32."""
    import torch
    rn = lambda *shape: randn(*shape, dt=torch.float32)
    if which == "mamba":                 # zamba2: 64 heads, P = N = 64
        return (rn(B, nc, Q, 64, 64) * 0.5, (rn(B, nc, Q, 64) * 0.5).to(dt),
                (rn(B, nc, Q, 64) * 0.5).to(dt),
                torch.cumsum(-rn(B, nc, Q, 64).abs() * 0.1, 2))
    nh, dh = 4, 512                      # xlstm-350m: 4 heads of 512
    return (*((rn(B, nc, Q, nh, dh) * dh ** -0.25).to(dt) for _ in range(2)),
            rn(B, nc, Q, nh, dh).to(dt),
            torch.cumsum(-rn(B, nc, Q, nh).abs() * 0.2, 2),
            torch.clamp_max(rn(B, nc, Q, nh), 8.0))


def _scan_bytes(which, B, Q, nc, esz):
    """Bytes one scan call must move: each input read once, y and the
    final state written once."""
    rows = B * nc * Q
    if which == "mamba":
        nh, P, N = 64, 64, 64
        return 8 * rows * nh * P + 2 * esz * rows * N + 4 * rows * nh \
            + 4 * B * nh * P * N
    nh, dh = 4, 512
    return 3 * esz * rows * nh * dh + 8 * rows * nh + 4 * rows * nh * dh \
        + 4 * B * nh * dh * (dh + 1)


def _scan_ops(which, B, Q, nc, esz, parts):
    """{dtype name: operations} of one scan call: the multiply-adds of the
    chunked form at the caller's Q, each at the peak of the fastest way
    that meets the fp32 limit.  With fp32 inputs every product is fp32.
    With bf16 inputs a product of two bf16 operands (C Bᵀ, q kᵀ) is exact
    at the bf16 peak; one with an fp32 operand (the state, x̄, the decayed
    scores) costs ``parts`` bf16 products (the split); the SSD's
    (C Bᵀ ⊙ decay) x̄ stays fp32, since its split fails the limit."""
    rows, pairs = B * nc * Q, B * nc * Q * (Q + 1) // 2
    if which == "mamba":
        nh, P, N = 64, 64, 64
        exact, fp32 = 2 * pairs * N, 2 * pairs * nh * P
        split = 2 * 2 * rows * nh * P * N           # carried term, state
    else:
        nh, dh = 4, 512
        exact, fp32 = 2 * nh * pairs * dh, 2 * nh * pairs   # q kᵀ, row sums
        split = 2 * nh * (pairs * dh + 2 * rows * dh * dh + rows * dh)
    if esz == 4:
        return {"float32": exact + fp32 + split}
    return {"bfloat16": exact + parts * split, "float32": fp32}


def _scan_kernels(randn, record, times):
    """The two chunk scans at SCAN_CASES, with bf16 and with fp32 inputs,
    against their plain versions at the fp32 tolerance (both compute and
    return fp32); then the faults planted that a scan must not pass: the
    state not carried at a caller chunk's boundary and a causal mask one
    off (every case, bf16 inputs), and those of the staged design (kernels/
    mamba_scan.py FAULT_*): a kernel chunk reading the state entering the
    chunk before it (at (150, 2)), each bf16 split's parts but the first
    dropped (bf16 at (150, 2)), and cum not rebased across caller chunks
    (at (1, 257)).  No single PyTorch call computes either scan."""
    import importlib
    import torch
    from repro_torch import kernels as K
    MS = importlib.import_module("repro_torch.kernels.mamba_scan")
    ML = importlib.import_module("repro_torch.kernels.mlstm")

    tol = K.TOLERANCE[torch.float32]
    scans = {"mamba": (K.mamba_chunk_scan, K.mamba_chunk_scan_plain,
                       MS._launch),
             "mlstm": (K.mlstm_chunk_scan, K.mlstm_chunk_scan_plain,
                       ML._launch)}
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for which, (kernel, plain, launch) in scans.items():
        for (B, Q, nc) in SCAN_CASES:
            for dname, dt in dts.items():
                esz = torch.finfo(dt).bits // 8
                nbytes = _scan_bytes(which, B, Q, nc, esz)
                ops = _scan_ops(which, B, Q, nc, esz, MS.SPLIT_PARTS)

                def make(which=which, B=B, Q=Q, nc=nc, dt=dt):
                    return _scan_inputs(randn, which, B, Q, nc, dt)
                args_list = cold_copies(make, nbytes) if nc <= 16 \
                    else [make(), make()]
                a = args_list[0]
                name = f"{which} B={B} Q={Q} nc={nc} {dname}"
                got = kernel(*a)
                want = plain(*a)
                err = max(_check(f"{name} {part}", g, w, tol)
                          for part, g, w in zip(("y", "C", "n"), got, want))
                assert all(torch.equal(g, h) for g, h in zip(got, kernel(*a))), \
                    f"{name}: two runs differ"
                if nc > 1 and dname == "bfloat16":
                    parts = [kernel(*(t[:, c:c + 1].contiguous()
                                      for t in a))[0] for c in range(nc)]
                    _reject(f"{name} state not carried", torch.cat(parts, 1),
                            want[0], tol)
                if dname == "bfloat16":
                    _reject(f"{name} causal mask one off", got[0],
                            plain(*a, diagonal=-1)[0], tol)
                faults = []
                if (B, Q, nc) == SCAN_MAIN:
                    faults.append(("kernel chunk reads the state entering "
                                   "the chunk before", MS.FAULT_WRONG_STATE))
                    if dname == "bfloat16":
                        faults.append(("each split's parts but the first "
                                       "dropped", MS.FAULT_SPLIT_LOW))
                if (B, Q, nc) == (1, 1, 257):
                    faults.append(("cum not rebased across caller chunks",
                                   MS.FAULT_NO_REBASE))
                for label, fault in faults:
                    _reject(f"{name} {label}", launch(*a, fault=fault)[0],
                            want[0], tol)
                record(f"{which}_chunk_scan",
                       f"{'zamba2 nh=64 P=64 N=64' if which == 'mamba' else 'xlstm nh=4 dh=512'} "
                       f"B={B} Q={Q} nc={nc} {dname}",
                       (B, Q, nc) == SCAN_MAIN and dname == "bfloat16", err,
                       args_list, kernel, plain, None, nbytes, ops, dname,
                       ms=times[(which, B, Q, nc, dname)])
                del args_list, a, got, want


def _moe_kernels(randn, record, tols):
    """The kernels the moe family adds.  moe_gmm at deepseek-v2-lite-16b's
    expert products (E 64, D 2048, F 1408): a decode step's C = 6 for w1/w3
    and for w2, the C = 12 and 16 of a prefill bucket of 65 to 128 tokens
    (the kernel's 16-row tile), and a 256-token prefill's C = 32; the
    edges of the row tiles (R = 1, 8, 9, 64, 65) and a D of 1400, off the
    ring's 64-deep step; one mixtral-8x22b product (E 8, C 320, D 6144, F
    16384; bf16); and ragged cases.  Every call reads all of w whatever C
    is, so bytes bound it up to mixtral's; the yardstick is ``torch.bmm``.
    Planted faults at the decode shape in fp32: the last 64-deep D tile
    left out, and each expert reading the next one's weights; in bf16, at
    the decode shape (the mma.sync kernel) and at C = 12 (the wgmma
    kernel): every w stage of the ring holding the step before's tile
    (what a stage consumed one step early holds) and the plan one work
    item short; at C = 12 also the last 8-row group dropped.
    Then rmsnorm at MLA's kv_norm width of 512, over a decode step's 4
    rows and a 512-token prefill's; then the flash kernel at MLA's head
    dims (q, k 192 = 128 + 64 rope, v 128, 16 heads), causal at S = 256
    and 37, with the scale taken from hd_v as the planted fault."""
    import importlib
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    MG = importlib.import_module("repro_torch.kernels.moe_gmm")

    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = (("deepseek decode w1/w3", 64, 6, 2048, 1408, dts),
             ("deepseek decode w2", 64, 6, 1408, 2048, dts),
             *((f"deepseek prefill C={C} {w}", 64, C, D, F_, dts)
               for C in (12, 16)
               for w, D, F_ in (("w1/w3", 2048, 1408), ("w2", 1408, 2048))),
             ("deepseek prefill T=256 w1/w3", 64, 32, 2048, 1408, dts),
             *((f"deepseek w1/w3 R={R}", 64, R, 2048, 1408, dts)
               for R in (1, 8, 9, 64, 65)),
             ("D off the ring's step", 64, 6, 1400, 1408, dts),
             ("mixtral C=320", 8, 320, 6144, 16384,
              {"bfloat16": torch.bfloat16}),
             ("ragged", 3, 37, 200, 72, dts),
             ("unaligned rows", 3, 5, 131, 67, dts))
    for label, E, C, D, F_, dtypes in cases:
        for dname, dt in dtypes.items():
            esz = torch.finfo(dt).bits // 8
            nbytes = (E * C * D + E * D * F_ + E * C * F_) * esz

            def make(E=E, C=C, D=D, F_=F_, dt=dt):
                return ((randn(E, C, D, dt=torch.float32) * D ** -0.5).to(dt),
                        randn(E, D, F_, dt=dt))
            args_list = cold_copies(make, nbytes)
            x, w = args_list[0]
            name = f"moe_gmm {label} {dname}"
            err = _check(name, K.moe_gmm(x, w), K.moe_gmm_plain(x, w),
                         tols[dname])
            if (label, dname) == ("deepseek decode w1/w3", "float32"):
                want = K.moe_gmm_plain(x, w)
                _reject(f"{name} last D tile left out",
                        K.moe_gmm(x[..., :-64].contiguous(),
                                  w[:, :-64].contiguous()), want, tols[dname])
                _reject(f"{name} expert e reads e+1's weights",
                        K.moe_gmm(x, torch.roll(w, -1, 0)), want, tols[dname])
            if (label, dname) == ("deepseek decode w1/w3", "bfloat16"):
                want = K.moe_gmm_plain(x, w)
                _reject(f"{name} ring stage holds the step before's tile",
                        MG._launch(x, w, fault=MG.FAULT_STALE_TILE), want,
                        tols[dname])
                plan = MG.plan_gmm(E, C, D, F_, _build.sm_count(x.device))
                _reject(f"{name} {plan} one work item short",
                        MG._launch(x, w, plan._replace(items=plan.items - 1)),
                        want, tols[dname])
            if (label, dname) == ("deepseek prefill C=12 w1/w3", "bfloat16"):
                want = K.moe_gmm_plain(x, w)
                _reject(f"{name} last 8-row group dropped",
                        MG._launch(x, w, fault=MG.FAULT_DROP_ROW_GROUP),
                        want, tols[dname])
                _reject(f"{name} ring stage holds the step before's tile",
                        MG._launch(x, w, fault=MG.FAULT_STALE_TILE), want,
                        tols[dname])
                plan = MG.plan_gmm(E, C, D, F_, _build.sm_count(x.device))
                _reject(f"{name} {plan} one work item short",
                        MG._launch(x, w, plan._replace(items=plan.items - 1)),
                        want, tols[dname])
            record("moe_gmm", f"{label} [{E},{C},{D}]x[{E},{D},{F_}] {dname}",
                   (label, dname) == ("deepseek decode w1/w3", "bfloat16"),
                   err, args_list, K.moe_gmm, K.moe_gmm_plain, torch.bmm,
                   nbytes, 2 * E * C * D * F_, dname)
            del args_list, x, w

    D = 512
    for R in (4, 512):
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8

            def make(R=R, dt=dt):
                return (randn(R, D, dt=dt),
                        randn(D, dt=torch.float32) * 0.1 + 1.0)
            args_list = cold_copies(make, R * D * esz)
            x, sc = args_list[0]
            err = _check(f"rmsnorm kv_norm [{R},{D}] {dname}",
                         K.rmsnorm(x, sc), K.rmsnorm_plain(x, sc),
                         tols[dname])
            weights = {sc.data_ptr(): sc.to(dt) for _, sc in args_list}
            lib = lambda x, sc, w=weights: F.rms_norm(
                x, (D,), w[sc.data_ptr()], 1e-5)
            record("rmsnorm", f"kv_norm [{R},{D}] {dname}", False, err,
                   args_list, K.rmsnorm, K.rmsnorm_plain, lib,
                   2 * R * D * esz + 4 * D, 4 * R * D, "float32")

    H, hd, hd_v = 16, 192, 128
    for S in (256, 37):
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8

            def make(S=S, dt=dt):
                return (randn(1, S, H, hd, dt=dt), randn(1, S, H, hd, dt=dt),
                        randn(1, S, H, hd_v, dt=dt))
            nbytes = S * H * (2 * hd + 2 * hd_v) * esz
            args_list = cold_copies(make, nbytes)
            q, k, v = args_list[0]
            run = lambda q, k, v: K.flash_attention(q, k, v, causal=True)
            plain = lambda q, k, v: K.flash_attention_plain(q, k, v,
                                                            causal=True)
            want = plain(q, k, v)
            err = _check(f"flash MLA S={S} {dname}", run(q, k, v), want,
                         tols[dname])
            _reject(f"flash MLA S={S} scale from hd_v {dname}",
                    K.flash_attention(q, k, v, causal=True,
                                      scale=hd_v ** -0.5), want, tols[dname])
            lib = lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True)
            record("flash_attention",
                   f"MLA S={S} H=16 hd=192 hd_v=128 causal {dname}", False,
                   err, args_list, run, plain, lib, nbytes,
                   2 * (hd + hd_v) * H * S * (S + 1) // 2, dname)


@contextlib.contextmanager
def _routes_recorded(store):
    """Record the top-k expert indices (on the CPU) of every MoE layer
    run inside the block."""
    from repro_torch.models import moe as MOE
    route = MOE.route

    def recording(p, xt, cfg):
        out = route(p, xt, cfg)
        store.append(out[2].cpu())
        return out
    MOE.route = recording
    try:
        yield store
    finally:
        MOE.route = route


def _parity(cfg, toks, lens=None, cache_len=128, k=8):
    """``cfg`` at full width, fp32: prefill (batched with ``lens``, else
    per request), its caches, one decode step and one fused block on the
    card (kernels) against the same weights on the CPU (plain versions)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.cache import cache_leaves
    from repro_torch.training import steps as ST

    cpu_params = M.init_params(cfg, seed=0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to("cuda")
    fused = ST.make_fused_decode_step(cfg, k=k)
    res, routes = {}, {}
    for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        t = torch.as_tensor(toks, device=dev)
        with _routes_recorded(routes.setdefault(dev, [])):
            if lens is None:
                out, caches = ST.make_prefill_step(cfg, cache_len)(
                    params, {"tokens": t})
                pos = torch.full((t.shape[0],), t.shape[1],
                                 dtype=torch.int32, device=dev)
            else:
                pos = torch.as_tensor(lens, dtype=torch.int32, device=dev)
                out, caches = ST.make_batched_prefill_step(cfg, cache_len)(
                    params, t, pos)
        prefilled = [c.to("cpu", copy=True) for c in cache_leaves(caches)]
        logits, _ = M.forward(params, cfg, {"tokens": t})
        step_logits, _ = M.decode_step(params, cfg, out["next_tokens"],
                                       pos.clone(), copy.deepcopy(caches))
        blk, caches = fused(params, out["next_tokens"], pos, caches)
        res[dev] = dict(logits=logits.cpu(), step=step_logits.cpu(),
                        prefilled=prefilled,
                        caches=[c.cpu() for c in cache_leaves(caches)],
                        first=out["next_tokens"].cpu(),
                        **{n: blk[n].cpu() for n in ("tokens", "pos", "done")})
    g, c = res["cuda"], res["cpu"]
    if cfg.moe is not None:  # the MoE layers' top-k experts of every token
        assert routes["cpu"] and len(routes["cuda"]) == len(routes["cpu"]), \
            f"parity {cfg.name}: MoE routings not recorded " \
            f"({len(routes['cuda'])} on the card, {len(routes['cpu'])} on " \
            f"the CPU)"
        differ = sum(int((a != b).any(-1).sum())
                     for a, b in zip(routes["cuda"], routes["cpu"]))
        total = sum(a[..., 0].numel() for a in routes["cpu"])
        log(f"parity {cfg.name}: prefill top-k routings that differ between "
            f"card and CPU: {differ} of {total} (token, MoE layer) pairs")
    for name in ("logits", "step"):
        err = (g[name] - c[name]).abs().max().item()
        assert torch.allclose(g[name], c[name], atol=1e-3, rtol=1e-3), \
            f"parity {cfg.name}: {name} differ, max |err| {err}"
        log(f"parity {cfg.name}: {name} {tuple(g[name].shape)} max |err| "
            f"{err:.3g}")
    for name in ("prefilled", "caches"):
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(g[name], c[name])]
        assert all(torch.allclose(a.float(), b.float(), atol=1e-3, rtol=1e-3)
                   for a, b in zip(g[name], c[name])), \
            f"parity {cfg.name}: {name} differ by up to {max(errs)}"
        log(f"parity {cfg.name}: {name} ({len(errs)} leaves) max |err| "
            f"{max(errs):.3g}")
    for name in ("first", "tokens", "pos", "done"):
        assert torch.equal(g[name], c[name]), \
            f"parity {cfg.name}: {name} differ: {g[name].tolist()} vs " \
            f"{c[name].tolist()}"
    log(f"parity {cfg.name}: next tokens, fused-block tokens/pos/done "
        f"equal: {g['tokens'].tolist()}")


def phase_parity(state):
    """qwen2.5-3b with 2 layers and the batched prefill;
    zamba2-1.2b with 2 groups (12 Mamba2 layers, 2 shared-attention
    applications) and xlstm-350m with 1 group (5 mLSTM + 1 sLSTM), each
    prefilling two 300-token prompts (two chunks of 150);
    deepseek-v2-lite-16b with 2 layers and the batched prefill."""
    import numpy as np
    from repro_torch.configs import get_config

    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2,
                              dtype="float32")
    lens = [37, 21]
    toks = rng.integers(3, cfg.vocab_size, (2, max(lens))).astype("int32")
    toks[1, lens[1]:] = 0
    _parity(cfg, toks, lens)
    for arch, layers in (("zamba2-1.2b", 12), ("xlstm-350m", 6)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        toks = rng.integers(3, cfg.vocab_size, (2, 300)).astype("int32")
        _parity(cfg, toks, cache_len=512)
    # deepseek-v2-lite-16b: one mla_dense and one mla_moe layer; two
    # prompts of 256 and 200 padded to 256 give T = 512, two MoE groups
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), num_layers=2,
                              dtype="float32")
    lens = [256, 200]
    toks = rng.integers(3, cfg.vocab_size, (2, max(lens))).astype("int32")
    toks[1, lens[1]:] = 0
    _parity(cfg, toks, lens, cache_len=512)


def _serve(cfg, params, prompts, max_new, block_k, speculate=True):
    """One engine run; returns (outputs, launches, seconds, tokens,
    stats) after checking every token and every stream's end."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch.serve import build_engine

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
    st = dict(eng.stats)
    ntok = sum(len(v) for v in outs.values())
    log(f"serve {cfg.name}[{'spec' if eng.speculate else 'sync'}]: {ntok} "
        f"tokens in {dt:.3f} s ({ntok / dt:.1f} tok/s); stats {st}; "
        f"launches {launches}")
    assert len(outs) == len(prompts)
    for rid, toks in outs.items():
        assert 1 <= len(toks) <= max_new, (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks), rid
        assert len(toks) == max_new or toks[-1] == 2, (rid, toks)
    return outs, launches, dt, ntok, st


def _prompts(cfg, n, seed, extra=(), longest=200):
    """n prompts of 16 to ``longest`` tokens, then one of each length in
    ``extra``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    draw = lambda length: list(map(int, rng.integers(3, cfg.vocab_size,
                                                     length)))
    return [draw(int(rng.integers(16, longest + 1))) for _ in range(n)] + \
        [draw(length) for length in extra]


def _init_params(cfg):
    import torch
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve: {cfg.name} {n_params / 1e9:.3f} B params ({cfg.dtype}) "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s")
    return params


def phase_serve(state):
    from repro_torch.configs import get_config

    block_k, max_new = 8, 32
    cfg = get_config("qwen2.5-3b")
    L = cfg.num_layers
    params = _init_params(cfg)
    prompts = _prompts(cfg, 8, 0)
    runs = {}
    for speculate in (True, False):
        outs, launches, dt, ntok, st = _serve(cfg, params, prompts, max_new,
                                              block_k, speculate)
        pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
        assert launches["flash_attention"] == L * pd, launches
        assert launches["decode_attention"] == L * block_k * bd, launches
        assert launches["rmsnorm"] == (2 * L + 1) * (pd + block_k * bd), \
            launches
        assert launches["moe_gmm"] == 0, launches
        runs[speculate] = (outs, launches, st)
    assert runs[True][0] == runs[False][0], \
        "serve: speculative and synchronous token streams differ"
    assert runs[True][2]["host_syncs"] < runs[False][2]["host_syncs"]
    log("serve: speculative and synchronous token streams are identical")
    state["launches"] = dict(runs[True][1])
    state["params"] = {cfg.name: params}
    _serve_starcoder2(block_k, max_new)

    # the recurrent families: per-request prefill, speculation forced off;
    # a 300-token prompt puts a two-chunk scan on the path
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        cfg = get_config(arch)
        L = cfg.num_layers
        params = _init_params(cfg)
        outs, launches, dt, ntok, st = _serve(
            cfg, params, _prompts(cfg, 8, 1, extra=(300,)), max_new, block_k)
        pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
        assert st.get("spec_blocks", 0) == 0 and pd == 9, st
        steps = pd + block_k * bd
        if cfg.family == "hybrid":
            groups = L // cfg.shared_every
            want = {"mamba_chunk_scan": L * pd, "flash_attention": groups * pd,
                    "decode_attention": groups * block_k * bd,
                    "rmsnorm": (2 * L + 2 * groups + 1) * steps,
                    "mlstm_chunk_scan": 0, "moe_gmm": 0}
        else:
            n_m = L - len(cfg.xlstm.slstm_at)
            want = {"mlstm_chunk_scan": n_m * pd, "rmsnorm": (2 * L + 1) * steps,
                    "flash_attention": 0, "decode_attention": 0,
                    "mamba_chunk_scan": 0, "moe_gmm": 0}
        assert launches == want, (launches, want)
        kernel = "mamba_chunk_scan" if cfg.family == "hybrid" \
            else "mlstm_chunk_scan"
        state["launches"][kernel] = launches[kernel]
        state["params"][cfg.name] = params
        log(f"serve {cfg.name}: launches equal {want}")

    _serve_deepseek(state, block_k, max_new)


def _serve_starcoder2(block_k, max_new):
    """starcoder2-7b at full width and depth: 36 query heads over 4 KV
    heads, a group of 9, through the decode kernel; the sliding window of
    4096 and W = min(1024, 4096) = 1024 slots, so the ring does not wrap
    here (the wrap is held on the card at smoke width by
    tests/test_torch_cuda.py).  Per-request prefill (the ring needs true
    lengths), speculation on.  Its weights are freed afterwards."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("starcoder2-7b")
    L = cfg.num_layers
    params = _init_params(cfg)
    outs, launches, dt, ntok, st = _serve(cfg, params, _prompts(cfg, 8, 3),
                                          max_new, block_k)
    pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
    steps = pd + block_k * bd
    want = {"flash_attention": L * pd, "decode_attention": L * block_k * bd,
            "rmsnorm": (2 * L + 1) * steps, "moe_gmm": 0,
            "mamba_chunk_scan": 0, "mlstm_chunk_scan": 0}
    assert pd == 8 and launches == want, (st, launches, want)
    log(f"serve {cfg.name}: G = {cfg.num_heads // cfg.num_kv_heads}, "
        f"{ntok / dt:.1f} tok/s; launches equal {want}")
    del params
    torch.cuda.empty_cache()


def _serve_deepseek(state, block_k, max_new):
    """deepseek-v2-lite-16b at full width and depth: batched prefill,
    speculation on and then off.  The prompts are 8 of 16-64 tokens and
    one of 256: every prefill bucket then holds at most 4 x 64 tokens or
    exactly 256, so no MoE group breaks the reference's rule that the
    tokens of a dispatch be a multiple of the group of 256 (three prompts
    of 65-128 tokens would: ROADMAP Queue 3)."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("deepseek-v2-lite-16b")
    L = cfg.num_layers
    params = _init_params(cfg)
    prompts = _prompts(cfg, 8, 2, extra=(256,), longest=64)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for speculate in (True, False):
        outs, launches, dt, ntok, st = _serve(cfg, params, prompts, max_new,
                                              block_k, speculate)
        pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
        steps = pd + block_k * bd
        want = {"flash_attention": L * pd, "rmsnorm": (3 * L + 1) * steps,
                "moe_gmm": 3 * (L - 1) * steps, "decode_attention": 0,
                "mamba_chunk_scan": 0, "mlstm_chunk_scan": 0}
        assert launches == want, (launches, want)
        log(f"serve {cfg.name}: launches equal {want}")
        runs[speculate] = (outs, launches, st)
    assert runs[True][0] == runs[False][0], \
        f"serve {cfg.name}: speculative and synchronous token streams differ"
    assert runs[True][2]["host_syncs"] < runs[False][2]["host_syncs"]
    log(f"serve {cfg.name}: speculative and synchronous token streams are "
        f"identical")
    log(f"serve: device memory with four models' weights resident: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB while serving "
        f"{cfg.name}")
    state["launches"]["moe_gmm"] = runs[True][1]["moe_gmm"]
    state["params"][cfg.name] = params


def _device_busy(prof):
    """(ms of the union of the profiled CUDA kernels' intervals, how many
    kernels)."""
    from torch.autograd import DeviceType
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
    return busy, len(kern)


def _custom_kernel_ms(prof):
    """[(wrapper, device ms, CUDA kernels)] for each custom kernel: its
    device intervals, by its source's stem in the CUDA kernel's name
    (csrc/moe_gmm.cu: moe_gmm_mma_kernel, csrc/mlstm_scan.cu:
    mlstm_scan_chunk_kernel and mlstm_scan_out_kernel, ...)."""
    from torch.autograd import DeviceType
    from repro_torch import kernels as K
    out = []
    for k in K.KERNELS:
        stem = Path(sys.modules[k.__module__].SOURCE).stem
        ts = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and stem in e.name]
        out.append((k.__name__, sum(ts) / 1e3, len(ts)))
    return out


def _profile(cfg, params, eng=None, label=""):
    """Where one fused decode block's time goes at full width: host clock
    around a synchronous block, and torch.profiler's device kernels for
    the same block (busy = union of kernel intervals).  ``eng`` is the
    live engine unless given (it must serve 4 slots, cache 1024, block_k
    8, no speculation); returns (wall ms, device busy ms)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import build_engine

    if eng is None:
        eng = build_engine(cfg, n_slots=4, cache_len=1024, block_k=8,
                           params=params, device="cuda", speculate=False)
    name = cfg.name + label
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(list(map(int, rng.integers(3, cfg.vocab_size, 128))), 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_block()                   # admission: the prefills
    torch.cuda.synchronize()
    log(f"profile {name}: prefill 4x128 + first block: "
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
    busy, n_kern = _device_busy(prof)
    log(f"profile {name}: one 8-step decode block, 4 slots: {wall:.2f} "
        f"ms wall (best of {walls}); device busy {busy:.2f} ms over "
        f"{n_kern} kernels ({n_kern / 8:.0f} per step); device idle "
        f"share {1 - busy / wall:.3f}")
    for kname, ms, n in _custom_kernel_ms(prof):
        log(f"profile {name}: {kname} {ms:.4f} ms of device time per "
            f"block over {n} CUDA kernels ({ms * 1e3 / max(n, 1):.2f} us "
            f"each; {ms / busy:.4f} of device busy)")
    by_dev = prof.key_averages().table(sort_by="self_device_time_total",
                                       row_limit=8, max_name_column_width=40)
    by_cpu = prof.key_averages().table(sort_by="self_cpu_time_total",
                                       row_limit=8, max_name_column_width=40)
    log(f"profile {name}: top by device time\n" + by_dev)
    log(f"profile {name}: top by host time\n" + by_cpu)
    return wall, busy


PROFILE_ARCHS = ("qwen2.5-3b", "zamba2-1.2b", "deepseek-v2-lite-16b")
PREFILL_ARCHS = ("zamba2-1.2b", "xlstm-350m")
PREFILL_TOKENS = 300


def _prefill_profile(cfg, params, S=PREFILL_TOKENS):
    """Where one request's prefill of S tokens spends its time at full
    width (the prefill step the Engine runs for a recurrent model): host
    clock around a synchronous prefill (best of three), torch.profiler's
    device kernels for one more (busy = union of kernel intervals), each
    custom kernel's device ms, and the wrappers' launch counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    from repro_torch.training import steps as ST

    step = ST.make_prefill_step(cfg, 1024)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(3, cfg.vocab_size, (1, S))
                           .astype("int32"), device="cuda")
    step(params, {"tokens": toks})      # warm
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in K.KERNELS}
    busy, n_kern = _device_busy(prof)
    wall = min(walls)
    log(f"prefill {cfg.name}: one request of {S} tokens: {wall:.2f} ms wall "
        f"(best of {[round(w, 2) for w in walls]}); device busy {busy:.2f} "
        f"ms over {n_kern} kernels; device idle share {1 - busy / wall:.3f}")
    for name, ms, n in _custom_kernel_ms(prof):
        if n:
            log(f"prefill {cfg.name}: {name} {ms:.4f} ms of device time over "
                f"{launches[name]} launches ({n} CUDA kernels; "
                f"{ms / busy:.4f} of device busy)")


def _scan_times(randn, state):
    """Each scan's device ms alone at SCAN_CASES with bf16 and fp32
    inputs, through the public wrappers only (so a parent tree runs it as
    it is): {(which, B, Q, nc, dtype name): ms}, measured once a run and
    kept in ``state`` for the kernels and prefill phases."""
    import torch
    from repro_torch import kernels as K
    if "scan_ms" in state:
        return state["scan_ms"]
    times = state["scan_ms"] = {}
    for which, kernel in (("mamba", K.mamba_chunk_scan),
                          ("mlstm", K.mlstm_chunk_scan)):
        for (B, Q, nc) in SCAN_CASES:
            for dname, dt in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
                nbytes = _scan_bytes(which, B, Q, nc, 2 if dname ==
                                     "bfloat16" else 4)
                make = lambda: _scan_inputs(randn, which, B, Q, nc, dt)
                args = cold_copies(make, nbytes) if nc <= 16 \
                    else [make(), make()]
                times[(which, B, Q, nc, dname)] = device_ms(kernel, args)
                del args
    return times


def phase_prefill(state):
    """zamba2-1.2b and xlstm-350m prefilling one request of 300 tokens
    (the scans' main path), then each scan alone at every case."""
    import torch
    from repro_torch.configs import get_config
    for arch in PREFILL_ARCHS:
        cfg = get_config(arch)
        params = state.get("params", {}).get(arch)
        _prefill_profile(cfg, params if params is not None
                         else _init_params(cfg))
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = _scan_times(lambda *shape, dt: torch.randn(
        *shape, generator=gen, device="cuda", dtype=torch.float32).to(dt),
        state)
    for (which, B, Q, nc, dname), ms in times.items():
        log(f"prefill: {which}_chunk_scan B={B} Q={Q} nc={nc} {dname}: "
            f"kernel {ms:.4f} ms")


def phase_profile(state):
    from repro_torch.configs import get_config
    for arch in state.get("profile_archs", PROFILE_ARCHS):
        cfg = get_config(arch)
        params = state.get("params", {}).get(arch)
        _profile(cfg, params if params is not None else _init_params(cfg))


REPLAY_KEY = b"chip-smoke-signing-key"


@contextlib.contextmanager
def _export_loads_counted():
    """Count the calls of torch.export.load while the block runs."""
    import torch
    real, calls = torch.export.load, [0]

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    torch.export.load = counted
    try:
        yield calls
    finally:
        torch.export.load = real


def _replay_tampers(blob, key):
    """Every tampered form of the recording ``blob`` is refused before
    torch.export.load is reached: a flipped payload byte, a changed
    manifest, a changed signature, the wrong key, a payload re-signed
    without its fingerprint (TamperedRecordingError), and the manifest
    re-signed with another topology (TopologyMismatchError)."""
    from repro_torch.core.attest import (TamperedRecordingError,
                                         TopologyMismatchError, fingerprint)
    from repro_torch.core.recording import Recording
    from repro_torch.core.replay import Replayer

    rec = Recording.from_bytes(blob, key)
    flip = bytearray(rec.payload)
    flip[len(flip) // 2] ^= 0x5A
    sig = ("0" if rec.signature[0] != "0" else "1") + rec.signature[1:]
    resigned = Recording(dict(rec.manifest), bytes(flip), rec.trees)
    cases = {
        "payload byte flipped": (Recording(
            rec.manifest, bytes(flip), rec.trees, rec.signature).to_bytes(),
            key, TamperedRecordingError),
        "manifest changed": (Recording(
            dict(rec.manifest, static={**rec.manifest["static"],
                                       "cache_len": 9999}),
            rec.payload, rec.trees, rec.signature).to_bytes(), key,
            TamperedRecordingError),
        "signature changed": (Recording(
            rec.manifest, rec.payload, rec.trees, sig).to_bytes(), key,
            TamperedRecordingError),
        "wrong key": (blob, key + b"!", TamperedRecordingError),
        "payload re-signed, fingerprint stale": (
            resigned.sign_with(key).to_bytes(), key, TamperedRecordingError),
        "re-signed for another topology": (Recording(
            dict(rec.manifest, topology=fingerprint(["another card"], 1)),
            rec.payload, rec.trees).sign_with(key).to_bytes(), key,
            TopologyMismatchError),
    }
    with _export_loads_counted() as loads:
        for label, (bad, k, err) in cases.items():
            rp = Replayer(key=k, device="cuda")
            try:
                rp.load(bad)
            except err as e:
                log(f"replay: tampered ({label}): {type(e).__name__}: {e}")
            else:
                raise AssertionError(f"replay: tampered ({label}) loaded")
            assert rp.stats["rejected"] == 1 and loads[0] == 0, \
                (label, rp.stats, loads)
    log(f"replay: {len(cases)} tampered recordings refused, "
        f"torch.export.load reached {loads[0]} times")


def _replay_serve(label, eng, prompts, max_new, rp=None):
    """Serve ``prompts`` on ``eng``: (outputs, stats, wrapper launches,
    graph replays) after checking every stream's end."""
    import torch
    from repro_torch import kernels as K
    for p in prompts:
        eng.submit(p, max_new)
    torch.cuda.synchronize()
    K.reset_launches()
    replays0 = rp.stats["graph_replays"] if rp is not None else 0
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    replays = (rp.stats["graph_replays"] if rp is not None else 0) - replays0
    st, launches = dict(eng.stats), K.launch_counts()
    ntok = sum(len(v) for v in outs.values())
    log(f"replay: serve {label} [{eng.channel.kind}]: {ntok} tokens in "
        f"{dt:.3f} s ({ntok / dt:.1f} tok/s); stats {st}; wrapper launches "
        f"{launches}; graph replays {replays}")
    for rid, toks in outs.items():
        assert len(toks) == max_new or toks[-1] == 2, (rid, toks)
    return outs, st, launches, replays


def phase_replay(state):
    """Record -> sign -> replay at full width: qwen2.5-3b's prefill (batch
    1, seq 128) and fused decode block (4 slots, cache 1024, block_k 8)
    recorded with the record launcher's code, signed, saved, verified and
    loaded; the tampered forms refused before load; 8 prompts of 128
    tokens served live, replayed eagerly and replayed through the decode
    block's CUDA graph, with identical tokens and host syncs; one decode
    block profiled under the graph beside live."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.api.workload import recording_name
    from repro_torch.configs import get_config
    from repro_torch.core.channel import LiveChannel, ReplayChannel
    from repro_torch.core.replay import Replayer
    from repro_torch.launch.record import record_kinds
    from repro_torch.launch.serve import stream_kwargs
    from repro_torch.models import layers as Lyr
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    from repro_torch.training import steps as ST

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen2.5-3b")
    L, block_k, seq, max_new = cfg.num_layers, 8, 128, 32
    log(f"replay: {cfg.name} at full width on {_card(state)}")
    params = state.get("params", {}).get(cfg.name)
    params = params if params is not None else _init_params(cfg)
    kw = dict(n_slots=4, cache_len=1024, block_k=block_k, eos_id=2,
              speculate=True, pipeline_depth=4, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        recs = record_kinds(cfg, out=d, key=REPLAY_KEY, cache_len=1024,
                            block_k=block_k, batch=4, seq=seq, params=params,
                            device="cuda")
        log(f"replay: recorded and signed both kinds in "
            f"{time.perf_counter() - t0:.2f} s")
        for kind, (path, rec) in recs.items():
            m = rec.manifest
            log(f"replay: {kind}: record_wall_s {m['record_wall_s']:.2f}, "
                f"payload {len(rec.payload) / 1e6:.2f} MB, "
                f"{len(m['inputs'])} inputs, arg_bytes "
                f"{m['memory']['arg_bytes'] / 1e6:.1f} MB, out_bytes "
                f"{m['memory']['out_bytes'] / 1e6:.3f} MB")
        blob = Path(recs["decode"][0]).read_bytes()
        _replay_tampers(blob, REPLAY_KEY)
        t0 = time.perf_counter()
        with _export_loads_counted() as loads:
            rp = Replayer(key=REPLAY_KEY, device="cuda")
            pre = rp.load(os.path.join(d, recording_name(cfg.name,
                                                         "prefill")))
            dec = rp.load(os.path.join(d, recording_name(cfg.name,
                                                         "decode")))
        assert loads[0] == 2, loads
        log(f"replay: verify + load of both: "
            f"{time.perf_counter() - t0:.2f} s")
    channel = ReplayChannel(rp, pre, dec)
    assert channel.fixed_prompt_len == seq, channel.fixed_prompt_len
    tree = Lyr.to_tree(params)
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(3, cfg.vocab_size, seq)))
               for _ in range(8)]

    # (a) live, through the same per-request prefill the recording pins
    live = Engine(params, channel=LiveChannel(
        ST.make_prefill_step(cfg, 1024),
        ST.make_fused_decode_step(cfg, k=block_k)),
        **stream_kwargs(cfg, **kw))
    runs = {"live": _replay_serve("live", live, prompts, max_new)}
    # (b) replayed eagerly (not warmed)
    runs["eager"] = _replay_serve("replay eager", Engine(
        tree, channel=channel, **stream_kwargs(cfg, **kw)), prompts,
        max_new, rp)
    # (c) warmed: the decode block captured as a CUDA graph by its first
    # execute, which reads the params in place and copies only tokens,
    # positions and caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rp.warm(dec)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    zeros = torch.zeros(4, dtype=torch.int32, device="cuda")
    caches = M.init_cache(cfg, 4, 1024, device="cuda")
    torch.cuda.empty_cache()            # the zeros warm ran on
    mem0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    rp.execute(dec, tree, zeros, zeros.clone(), caches)
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t0
    graph_bytes = (torch.cuda.memory_allocated() - mem0[0],
                   torch.cuda.memory_reserved() - mem0[1])
    del caches
    per_replay = rp.captured_launches(dec)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in torch.utils._pytree.tree_leaves(tree))
    log(f"replay: warm of the decode block {t_warm:.2f} s, capture and "
        f"first replay {t_cap:.2f} s; the graph keeps "
        f"{graph_bytes[0] / 1e6:.1f} MB allocated (its own inputs and "
        f"outputs) and {graph_bytes[1] / 1e6:.1f} MB more reserved (its "
        f"pool, less what the allocator held free) beside "
        f"{param_bytes / 1e6:.1f} MB of params it reads in place; one "
        f"replay launches {per_replay}")
    assert rp.stats["captures"] == 1, rp.stats
    assert max(graph_bytes) < param_bytes / 4, (graph_bytes, param_bytes)
    assert per_replay == {"decode_attention": L * block_k,
                          "rmsnorm": (2 * L + 1) * block_k}, per_replay
    runs["graph"] = _replay_serve("replay graph", Engine(
        tree, channel=channel, **stream_kwargs(cfg, **kw)), prompts,
        max_new, rp)
    for label in ("eager", "graph"):
        assert runs[label][0] == runs["live"][0], \
            f"replay: {label} tokens differ from live"
        assert runs[label][1]["host_syncs"] == runs["live"][1]["host_syncs"], \
            (label, runs[label][1], runs["live"][1])
    # launches: every kernel through its wrapper live and eager; under the
    # graph the decode blocks' only through their replays
    for label, (outs, st, launches, replays) in runs.items():
        pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
        if label == "graph":
            assert replays == bd, (replays, bd)
            for k, n in per_replay.items():
                launches[k] += n * replays
        want = {"flash_attention": L * pd,
                "decode_attention": L * block_k * bd,
                "rmsnorm": (2 * L + 1) * (pd + block_k * bd), "moe_gmm": 0,
                "mamba_chunk_scan": 0, "mlstm_chunk_scan": 0}
        assert launches == want, (label, launches, want)
    log("replay: live, eager replay and graph replay give identical tokens "
        "and host syncs; launches equal the formulas")

    # one synchronous decode block, live and under the graph
    live_wall, live_busy = _profile(cfg, params, label=" live")
    eng = Engine(tree, channel=channel, **stream_kwargs(
        cfg, **dict(kw, speculate=False)))
    g_wall, g_busy = _profile(cfg, params, eng=eng, label=" graph replay")
    log(f"replay: decode block wall {live_wall:.2f} -> {g_wall:.2f} ms, "
        f"device busy {live_busy:.2f} -> {g_busy:.2f} ms, idle share "
        f"{1 - live_busy / live_wall:.3f} -> {1 - g_busy / g_wall:.3f} "
        f"(live -> graph replay)")
    assert rp.stats["captures"] == 1, rp.stats
    log(f"replay: replayer stats {rp.stats}; peak memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; all figures "
        f"of this phase on {_card(state)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--profile-archs", default=",".join(PROFILE_ARCHS),
                    help="the models the profile phase decodes")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
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

    state = {"profile_archs": [a for a in args.profile_archs.split(",") if a]}
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
