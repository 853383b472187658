#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases build,kernels

Phases, each of which raises (exit code != 0) when it fails:

  gpu      the card's name and power limit, from nvidia-smi;
  build    the CUDA kernels built from src/repro_torch/csrc with nvcc, and
           ptxas's registers, shared memory and spills for the attention
           kernels, moe_gmm, rmsnorm, the scans and their backwards
           (which must not spill);
  kernels  each kernel against its plain PyTorch version on the card, in
           bf16 and fp32, at ``kernels.TOLERANCE``, with its device time,
           the plain version's, one library call's as a yardstick where
           one exists, and the least time the card could take (bytes or
           operations at the H100's peak rates), at the shapes qwen2.5-3b,
           zamba2-1.2b, xlstm-350m and deepseek-v2-lite-16b give it (and
           one mixtral-8x22b expert product; decode attention also at
           starcoder2-7b's group of 9 and mixtral-8x22b's of 6; both
           attention kernels at the shapes whisper-large-v3 and
           phi-3-vision-4.2b give them: hd 96, 1,500 encoder frames,
           cross-attention with Sq != Sk, a 1,500-slot cross cache); the
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
           last D tile left out of an expert product, the ragged last
           split of a 1,500-slot cache dropped, an expert
           reading its neighbour's weights, a stale tile in moe_gmm's
           ring, its last 8-row group dropped, its plan one work item
           short, an rmsnorm row summed over its first warp's share) must
           be rejected; the five backward kernels (rmsnorm's at the train
           step's [1024, 2048], two launches by ``plan_rmsnorm_backward``:
           a block per SM over groups of rows, then the partial rows
           summed in column tiles; flash's, two launches by
           ``plan_flash_backward`` with wgmma at hd 64 to 128 and launch
           B's walk of the group split over a cluster of blocks, at its q
           [8,128,16,128], at zamba2-1.2b's shared attention
           [8,128,32,64] (G = 1), at phi-3-vision's and whisper's
           shapes and at deepseek's MLA train step (q, k [8,128,16,192],
           v [8,128,16,128]); moe_gmm's, two launches (dx, dw) by
           ``plan_gmm_backward`` (warp-specialised TMA kernels, dy resident
           in dw where R <= 128), at deepseek-v2-lite-16b's train row (x
           [64,128,2048] @ w [64,2048,1408], and w2's) and mixtral-8x22b's
           [8,320,6144] @ [8,6144,16384], each launch's device ms, and the
           cp.async kernel (rows not 16-byte aligned) at the train row; the two scans' at
           zamba2-1.2b's and xlstm-350m's train step rows [8,1,128,...]
           and at the 300-token prompt's [1,2,150,...]) against their
           plain versions in both dtypes, timed beside the library's
           backward where there is one, with their planted faults (a
           row's sums over its first warp's share; launch A one K tile
           short; a scan chunk reading the state cotangent of the chunk
           after it; the SSD's sum of dB over its head groups without the
           last; the mLSTM's sums of dg's column tiles and of its scores'
           d tiles without the last, and of <dC'_out, C'_in>'s state
           tiles without the last (with forget gates near 1); a scan
           backward's bf16 splits cut to one part; moe_gmm's launch dx
           with each w stage holding the step before's F tile, its
           launch dw without R's last 8-row group, and with a block's
           later units keeping its first unit's resident dy tile), the
           scans' two runs bit-equal, each scan backward's device time by
           launch; the decode kernel's int8-cache form at qwen2.5-3b's,
           starcoder2-7b's, zamba2-1.2b's and phi-3-vision's decode
           shapes (int8 caches [4,1024,Hkv,hd], fp32 scales) in bf16 and
           fp32 q, over drawn and full lengths and the ring, with its
           planted fault (the V scales ignored), its bound in bytes and
           SDPA over bf16 caches of the same shape beside it; kernel and
           library times are medians of MEDIAN_OF;
  train    training through the backward kernels: (a) qwen2.5-3b cut to 2
           layers at full width, one fp32 train step on the card against
           the CPU (loss, grad norm, every master leaf); (c) the same
           model, 3 steps + an async checkpoint + 3 steps against the
           checkpoint restored and stepped 3 times (atol 1e-5); (b) one
           fp32 forward + backward of qwen2.5-3b at full width and depth,
           then launch/train.py's ``train`` in bf16 for 6 steps at its
           default batch 8 and seq 128 (finite losses, every master leaf
           moved, step 1 against the fp32 pass, launches 73 + 73 rmsnorm
           and 36 + 36 flash a step), ms per step, tokens/s, peak memory
           and one more step profiled, with the device ms of its custom
           backward kernels by family; (d) zamba2-1.2b and xlstm-350m:
           one fp32 step at phase parity's group of 6 layers (seq 128,
           two kernel chunks) on the card against the CPU, then
           ``train`` in bf16 at full width and depth for 3 steps at batch
           8, seq 128 (finite losses, every master leaf moved, 36 + 36
           SSD scans and 20 + 20 mLSTM scans a step), ms per step,
           tokens/s, peak memory and one more step profiled; (e)
           deepseek-v2-lite-16b (moe: MLA and routed experts): one fp32
           step at full width and 2 layers (seq 128, batch 2) on the card
           against the CPU, then ``train`` in bf16 at full width and 4
           layers for 3 steps at batch 8, seq 128 (13 + 13 rmsnorm, 4 + 4
           flash at hd 192 / hd_v 128 and 9 + 9 moe_gmm a step), ms per
           step, tokens/s, peak memory and one more step profiled;
  mesh     sharding on a DeviceMesh of the one card: (a)
           ``make_host_mesh(model=1)``, a world of one over NCCL (gloo for
           CPU tensors), its descriptor; (b) qwen2.5-3b at full width and
           2 layers, bf16 with fp32 masters, batch 8, seq 128: 2 train
           steps on the state placed by ``reshard_state`` under
           ``rules_for("train")`` (DTensors) and the same 2 on plain
           tensors, loss, grad norm and every master equal to the bit,
           the launches of rmsnorm, flash and their backwards equal and
           the plain versions called 0 times, then a steady step of each
           timed (wall, device busy, idle share); (c) qwen2.5-3b,
           deepseek-v2-lite-16b (2 layers), zamba2-1.2b and xlstm-350m
           (one group each) at full width from seed 0, DTensor params
           under ``rules_for("serve")``: a prefill and one fused decode
           block with the plain path's greedy tokens and launches equal
           to ``_serve_launches`` in both; (d) ``compressed_psum`` over
           NCCL against gloo's on the CPU (1e-6); (e) (b)'s state saved
           by ``CheckpointStore``, restored onto the mesh and stepped,
           equal to the bit to (b)'s next step; (f) a ``Workload`` given
           the mesh records a manifest naming it under the keys of one
           given none; (g) each of the 12 custom ops on DTensors at
           main-path shapes launches its kernel once, its plain version
           never, with the plain-tensor result to the bit; (h) the device
           time of ``masked_write`` (a cache split over batch or slots)
           against ``index_put_`` for one K or V slot write;
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
  replay   record -> sign -> replay of qwen2.5-3b at full width, cut to
           ``REPLAY_LAYERS`` layers (as in phases registry and fleet):
           prefill
           and the fused decode block recorded (``torch.export``, params as
           inputs) through a wifi ``RecordingSession`` with all passes and
           signed by the record launcher's code (each session report
           printed; the session's host seconds naive and with all
           passes), every tampered form refused before
           ``torch.export.load``, 8 prompts of 128 tokens served live,
           replayed eagerly, replayed through the decode block's CUDA
           graph, and live and under the graph again with every dispatch
           billed to a wifi emulator (identical tokens, host syncs and
           launches; the two billing logs equal), and one decode block
           profiled under the graph beside live;
  int8     int8 serving through the API: (a) qwen2.5-3b at full width
           and depth quantized on the card (``serving.quant``), bytes and
           time; (b) served with ``kv_quant`` through the Engine (4 slots,
           cache 1024, block_k 8, 8 prompts, 32 new tokens), speculation
           on and off: identical streams, the int8 decode form launched L
           block_k a block and the bf16 form and the plain version never,
           peak memory beside phase serve's bf16 server; (c) full width,
           2 layers, card against CPU: fp32 with int8 caches (1e-3) and
           bf16 with int8 weights and caches (2e-2 of the largest logit);
           (d) the int8 step recorded, signed, verified and replayed at
           REPLAY_LAYERS: live, eager and graph tokens identical, a bf16
           tree refused, the decode block under the graph beside phase
           replay's bf16 block; (e) starcoder2-7b at full width, 4 layers,
           int8 caches (G = 9, the window form) through the Engine;
  registry record -> publish -> fetch -> verify -> replay of qwen2.5-3b at
           full width and phase replay's depth: phase replay's recordings (recorded here when
           that phase did not run) published through a cloud
           ``Workspace`` into a file-backed registry, a fresh TEE
           ``Workspace`` booting ``wl.engine()`` from it over emulated
           wifi (chunked fetch, HMAC and inclusion proof verified, both
           programs preloaded, warmed and captured as CUDA graphs) and
           serving phase replay's 8 prompts with its live tokens and host
           syncs, launches equal to the formulas; a tampered chunk and a
           validly signed swap (split view) refused with 0 loads; quotes
           of ``attested_replay`` and ``Replayer.quote`` verified offline,
           perturbed ones rejected; the three scenarios of
           ``BENCH_registry.json`` (cold record on miss, warm hit, delta
           re-record) on cody-mnist at its published config over wifi and
           cellular, with its three acceptance flags; and the three
           ported examples (``repro_torch.examples``) run on the card;
  fleet    fleet-scale replay serving: a 2-replica qwen2.5-3b fleet at
           full width and phase replay's depth booted from a file-backed registry (phase
           replay's recordings, recorded here when it did not run)
           through two regional read-replicas, each replica with its own
           client and wifi span (fetch, HMAC and proof verified, load,
           warm, both programs captured), serving ~35 open-loop arrivals
           with live's tokens and launches equal to the formulas (per
           replica boot host seconds, boot_virtual_s and the virtual-
           clock latencies printed as model output); qwen2.5-3b and
           xlstm-350m at full width through one Scheduler (serve
           --streams' path) with BENCH_multitenant.json's two flags;
           BENCH_fleet.json's scenario at its smoke shapes (its flags, a
           schema check, arrivals, served counts, ticks and balancer
           counts equal to the file's); BENCH_fanout.json's campaign
           through launch/fanout.py's code path (its flags, and round
           trips, speculation hits, ticks and virtual seconds at 24
           pinned jobs equal to the file's);
  session  the CODY recording session: cody-mnist's prefill (published
           config, cache 64, block_k 4, batch 1, seq 16) exported once;
           the record-side ablation (naive, +deferral, +speculation,
           +metasync) on wifi and cellular at 32 jobs, each stack's round
           trips equal to ``BENCH_recording.json``'s, virtual time
           strictly falling, all passes >= 90% below naive, every payload
           the local record's; the replay-side ablation (plan compaction
           over wifi) equal to ``BENCH_replay.json``'s; the session-made
           recording verified and replayed on the card, bit-identical to
           live execution, with 2 L + 1 rmsnorm and L flash launches.
           Emulated seconds are the link model's output, not measured;
  families the audio and vlm families: whisper-large-v3 (2 + 2 layers)
           and phi-3-vision-4.2b (2 layers) in fp32 at full width on the
           card against the CPU (prefill with frames [2, 1500, 1280] or
           576 image embeds, caches, a decode step, a fused block), then
           each at full width and ``FAMILY_LAYERS`` layers (whisper: as
           many encoder layers) in bf16 from seed 0: whisper's batch of
           2 prefilled at prompts of 16 and 48 decoder tokens (cache
           1,536), phi-3-vision's 4 requests of 576 + 128 rows
           prefilled one at a time (cache 1024); 32 tokens decoded in
           fused blocks of 8 equal to a step-by-step decode_step loop's;
           launches equal to the formulas (whisper: no rmsnorm); one
           prefill and one decode block timed (wall, device busy, idle
           share); the prefill step recorded, signed, verified, loaded
           and replayed under its CUDA graph with live's tokens;
  native   BENCH_replay.json's native rows: the six archs of the
           reference's replay_native.main (qwen2.5-3b, starcoder2-7b,
           mixtral-8x22b, xlstm-350m, zamba2-1.2b, whisper-large-v3) at
           its shapes (smoke configs, tokens [1, 32] of ones, frames of
           ones, cache 64): the live prefill step against its recording
           replayed on the warmed fast path (a CUDA graph), timed
           interleaved, best of 7 x 30 calls; every row must hold
           replay_not_slower_than_native at the bench's 5%.  Nothing is
           written to BENCH_replay.json;
  dryrun   the dry run and the cost analysis (``analysis/``): (a)
           ``python -m repro_torch.launch.dryrun`` in two subprocesses
           over fake process groups, qwen2.5-3b at full width and
           ``DRYRUN_LAYERS`` layer(s), train_4k on 2 x 16 x 16 and
           decode_32k on 16 x 16 (fake CUDA tensors: nothing allocated),
           each cell's line printed and its status ``ok``; (b) the
           qwen2.5-3b prefill at full depth, 4 requests of 512 tokens, run
           for real on the card: ``analysis.cost.trace``'s roofline (the
           "fused" byte count; the "eager" one beside it) against the
           step's device busy time, which must be at least 0.95 of the
           roofline's step time, and its analysed temp + out bytes
           against ``max_memory_allocated`` less ``memory_allocated``
           (within 10%); (c) every kernel row of phase kernels in the same
           call: ``analysis/cost.py``'s formula of its custom op, run on
           the row's inputs, must give the row's bytes and operations.

The line before the last is a JSON summary of the kernels (the backward
kernels with their launches in phase train, the decode kernel's int8 form
with its launches in phase int8); the last line
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
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
PHASES = ("gpu", "build", "kernels", "train", "mesh", "parity", "serve",
          "prefill", "profile", "replay", "int8", "registry", "fleet",
          "session", "families", "native", "dryrun")

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s and peak ops/s by type
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
L2_BYTES = 50e6


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing --
# the kernels phase times each kernel and its library call as the median
# of this many measurements (one graph capture, each measurement its own
# ``replays`` replays between events): a single one read the flash
# backward's SDPA at half its time once
MEDIAN_OF = 5


def device_ms(fn, args_list, replays=5, repeats=1):
    """Mean device time of one ``fn(*args)``: one call per entry of
    ``args_list`` captured once in a CUDA graph (so host overhead does not
    count), the graph replayed ``replays`` times between CUDA events; with
    ``repeats`` > 1 the median of that many such measurements."""
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
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (replays * len(args_list)))
    return statistics.median(times)


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
              "mamba_scan", "mlstm_scan", "mamba_bwd", "mlstm_bwd", "gmm_bwd")


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
               if ("_scan_" in n or n.startswith(("mamba_bwd", "mlstm_bwd",
                                                  "gmm_bwd")))
               and r.get("spills") != (0, 0)}
    assert not spilled, \
        f"build: the scan or moe_gmm backward kernels spill: {spilled}"


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
               nbytes, ops, dname, ms=None, library_minus=None,
               no_library="no single PyTorch call computes this"):
        """... ``library_minus``: a call whose time the library's
        includes and the kernel's does not (a backward's forward);
        ``no_library``: why there is no library time.  The kernel and the
        library: medians of MEDIAN_OF measurements (the scans' ``ms``,
        from ``_scan_times``, too)."""
        ms = device_ms(run, args_list, repeats=MEDIAN_OF) if ms is None \
            else ms
        plain_ms = device_ms(plain, args_list)
        lib_ms = device_ms(library, args_list, repeats=MEDIAN_OF) \
            if library else None
        if library_minus is not None:
            lib_ms -= device_ms(library_minus, args_list, repeats=MEDIAN_OF)
        b_ms, b_by = bound(nbytes, ops, dname)
        lib_txt = f"none ({no_library})" if lib_ms is None \
            else f"{lib_ms:.4f} ms"
        log(f"kernels: {kernel:16s} {case:38s} err {err:.3g}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib_txt}  "
            f"bound {b_ms:.4f} ms ({b_by}); kernel and library medians of "
            f"{MEDIAN_OF}")
        row = dict(case=case, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        state.setdefault("kernel_costs", []).append(_formula_of(
            kernel, case, run, args_list[0], nbytes, ops, dname))
        if main:
            rows[kernel] = row
        return row

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
    _backward_kernels(randn, record, tols, state)
    _gmm_backward_kernels(randn, record, tols)
    _scan_backward_kernels(randn, record)

    _attention_rows(randn, record, tols, state)
    _int8_decode_rows(randn, record, tols)

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

    _attention_sweep(randn, tols, dev)
    _scan_kernels(randn, record, _scan_times(randn, state))
    _moe_kernels(randn, record, tols)
    torch.cuda.synchronize()


def _formula_of(kernel, case, run, args, nbytes, ops, dname):
    """What ``analysis/cost.py``'s formula counts for one call of ``run``
    on a kernel row's inputs (its custom ops' bytes and operations by
    dtype) beside the row's own ``nbytes`` / ``ops``, for phase dryrun."""
    import torch
    from repro_torch.analysis import cost as C
    want_ops = ops if isinstance(ops, dict) else {dname: ops}
    try:
        c = C.analyze(run, args)
        torch.cuda.synchronize()
        got = (sum(v["bytes"] for v in c["custom_ops"].values()),
               c["flops_by_dtype"], sorted(c["custom_ops"]))
    except Exception as e:   # reported by phase dryrun, not here
        got = (None, None, f"{type(e).__name__}: {e}")
    return dict(kernel=kernel, case=case, want_bytes=nbytes,
                want_ops={k: float(v) for k, v in want_ops.items()},
                got_bytes=got[0], got_ops=got[1], ops_seen=got[2])


class FlashRow(NamedTuple):
    """One shape the flash kernel is checked, faulted and timed at."""
    label: str
    B: int
    Sq: int
    Sk: int
    H: int
    Hkv: int
    hd: int
    causal: bool = True
    window: int = 0
    role: str = ""       # "main": the kernel's row of the kernels line;
    #                      "families": a sub-row, launched in phase families;
    #                      "moe": a sub-row, launched in phase train's (e)
    faults: tuple = ()   # planted, must fail: "window+1", "short_tiles"
    hd_v: int = 0        # v's head dim where it is not hd (MLA)

    @property
    def dv(self):
        return self.hd_v or self.hd

    @property
    def key(self):
        return attention_key("flash_attention",
                             (self.B, self.Sq, self.H, self.hd),
                             (self.B, self.Sk, self.Hkv, self.hd))


class DecodeRow(NamedTuple):
    """One shape the decode kernel is checked, faulted and timed at."""
    label: str
    B: int
    H: int
    Hkv: int
    W: int
    hd: int
    length: int = 0      # every row's length; 0: drawn (RANDOM_LENGTHS)
    role: str = ""
    faults: tuple = ()   # "lengths-1", "drop_head", "ragged_split"

    @property
    def key(self):
        return attention_key("decode_attention", (self.B, self.H, self.hd),
                             (self.B, self.W, self.Hkv, self.hd))


FLASH_ROWS = (
    FlashRow("qwen2.5-3b S=37", 1, 37, 37, 16, 2, 128),
    FlashRow("qwen2.5-3b S=512", 1, 512, 512, 16, 2, 128, role="main"),
    FlashRow("qwen2.5-3b S=512", 1, 512, 512, 16, 2, 128, window=128,
             faults=("window+1",)),
    # every query tile walks all 8 K tiles: against the causal case it
    # shows what the longest query tile's walk costs
    FlashRow("qwen2.5-3b S=512", 1, 512, 512, 16, 2, 128, causal=False),
    FlashRow("zamba2 shared attention", 1, 300, 300, 32, 32, 64),
    FlashRow("phi-3 prefill, 576 image + 128 text rows", 1, 704, 704, 32, 32,
             96, role="families", faults=("short_tiles",)),
    FlashRow("whisper encoder", 2, 1500, 1500, 20, 20, 64, causal=False,
             role="families"),
    FlashRow("whisper cross", 2, 48, 1500, 20, 20, 64, causal=False,
             role="families"))
DECODE_ROWS = (
    DecodeRow("qwen2.5-3b", 4, 16, 2, 1024, 128, role="main",
              faults=("lengths-1",)),
    DecodeRow("zamba2 shared attention", 4, 32, 32, 1024, 64),
    # the groups that do not divide the block
    DecodeRow("starcoder2-7b", 4, 36, 4, 1024, 128),
    DecodeRow("mixtral-8x22b", 4, 48, 8, 1024, 128),
    DecodeRow("phi-3 decode", 4, 32, 32, 1024, 96, length=720,
              role="families", faults=("drop_head", "ragged_split")),
    DecodeRow("whisper cross decode", 2, 20, 20, 1500, 64, length=1500,
              role="families", faults=("drop_head", "ragged_split")))
# (W, B) of the rows whose lengths are drawn, from 1 to W (seed 0)
RANDOM_LENGTHS = (1024, 4)


def attention_key(kernel, q_shape, k_shape):
    """The key launches are counted under by shape: the kernel's name and
    its wrapper's ``by_shape`` key."""
    return kernel, (tuple(q_shape), tuple(k_shape))


def _attention_rows(randn, record, tols, state):
    """Both attention kernels at FLASH_ROWS and DECODE_ROWS, each against
    its plain version, timed beside it, SDPA and its bound, in bf16 and
    fp32, with each row's planted faults; the rows of role "families" go
    to ``state["family_kernel_rows"]`` under their ``attention_key``."""
    import importlib
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    DA = importlib.import_module("repro_torch.kernels.decode_attention")
    dev = torch.device("cuda")
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    family = state["family_kernel_rows"] = {}
    for r in FLASH_ROWS:
        off = r.Sk - r.Sq
        i, j = torch.arange(r.Sq)[:, None] + off, torch.arange(r.Sk)[None]
        vis = (i >= j) if r.causal else torch.ones(r.Sq, r.Sk, dtype=bool)
        if r.window:
            vis &= i - j < r.window
        pairs = r.B * int(vis.sum())
        mask = vis.to(dev)
        kind = f"causal window {r.window}" if r.window else \
            "causal" if r.causal else "bidirectional"
        run = lambda q, k, v, r=r: K.flash_attention(
            q, k, v, causal=r.causal, window=r.window)
        plain = lambda q, k, v, r=r: K.flash_attention_plain(
            q, k, v, causal=r.causal, window=r.window)
        if r.causal and not r.window and not off:
            lib = lambda q, k, v, r=r: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=r.H != r.Hkv)
        else:
            lib = lambda q, k, v, r=r, m=None if vis.all() else mask: \
                F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=m, enable_gqa=r.H != r.Hkv)
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8
            nbytes = (2 * r.Sq * r.H + 2 * r.Sk * r.Hkv) * r.B * r.hd * esz

            def make(r=r, dt=dt):
                return (randn(r.B, r.Sq, r.H, r.hd, dt=dt),
                        randn(r.B, r.Sk, r.Hkv, r.hd, dt=dt),
                        randn(r.B, r.Sk, r.Hkv, r.hd, dt=dt))
            args_list = cold_copies(make, nbytes)
            q, k, v = args_list[0]
            case = (f"{r.label}: q {list(q.shape)} k {list(k.shape)} "
                    f"{kind} {dname}")
            want = plain(q, k, v)
            err = _check(f"flash {case}", run(q, k, v), want, tols[dname])
            if "window+1" in r.faults:
                _reject(f"flash {case}, window + 1", K.flash_attention(
                    q, k, v, causal=True, window=r.window + 1), want,
                    tols[dname])
            if "short_tiles" in r.faults:
                _reject(f"flash {case}, causal tile skip one tile short",
                        FA._launch(q, k, v, True, 0, r.hd ** -0.5, off,
                                   short_tiles=1), want, tols[dname])
            row = record("flash_attention", case,
                         r.role == "main" and dname == "bfloat16", err,
                         args_list, run, plain, lib, nbytes,
                         4 * r.hd * r.H * pairs, dname)
            if r.role == "families" and dname == "bfloat16":
                family[r.key] = row
            del args_list, q, k, v, want

    W0, B0 = RANDOM_LENGTHS
    lens0 = torch.randint(1, W0 + 1, (B0,), generator=torch.Generator()
                          .manual_seed(0), dtype=torch.int32)
    for r in DECODE_ROWS:
        lens = torch.full((r.B,), r.length, dtype=torch.int32) if r.length \
            else lens0
        assert r.length or (r.W, r.B) == RANDOM_LENGTHS, r
        n_valid = int(lens.sum())
        lens = lens.to(dev)
        valid = torch.arange(r.W, device=dev)[None] < lens[:, None]

        def lib(q, kc, vc, ln, m=valid[:, None, None, :], r=r):
            return F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=m, enable_gqa=r.H != r.Hkv)
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8
            nbytes = (2 * r.B * r.H * r.hd + 2 * n_valid * r.Hkv * r.hd) \
                * esz + 4 * r.B

            def make(r=r, dt=dt, lens=lens):
                return (randn(r.B, r.H, r.hd, dt=dt),
                        randn(r.B, r.W, r.Hkv, r.hd, dt=dt),
                        randn(r.B, r.W, r.Hkv, r.hd, dt=dt), lens.clone())
            args_list = cold_copies(make, 2 * r.B * r.W * r.Hkv * r.hd * esz)
            q, kc, vc, ln = args_list[0]
            case = (f"{r.label}: q {list(q.shape)} caches {list(kc.shape)} "
                    f"G={r.H // r.Hkv} lengths {lens.tolist()} {dname}")
            want = K.decode_attention_plain(q, kc, vc, ln)
            err = _check(f"decode {case}", K.decode_attention(q, kc, vc, ln),
                         want, tols[dname])
            if "lengths-1" in r.faults and dname == "float32":
                _reject(f"decode {case}, lengths - 1", K.decode_attention(
                    q, kc, vc, (ln - 1).clamp_min(1)), want, tols[dname])
            if "drop_head" in r.faults:
                _reject(f"decode {case}, the group's last head dropped",
                        DA._launch(q, kc, vc, ln, r.hd ** -0.5,
                                   fault=DA.FAULT_DROP_LAST_HEAD),
                        want, tols[dname])
            plan = DA.plan_splits(r.B, r.Hkv, r.W, _build.sm_count(dev))
            if "ragged_split" in r.faults and dname == "float32" and \
                    r.W % plan.chunk and r.length == r.W:
                _reject(f"decode {case}, the ragged last split of {plan} "
                        f"dropped", DA._launch(
                            q, kc, vc, ln, r.hd ** -0.5,
                            DA.SplitPlan(plan.splits - 1, plan.chunk)),
                        want, tols[dname])
            row = record("decode_attention", case,
                         r.role == "main" and dname == "bfloat16", err,
                         args_list, K.decode_attention,
                         K.decode_attention_plain, lib, nbytes,
                         4 * r.hd * r.H * n_valid, dname)
            if r.role == "families" and dname == "bfloat16":
                family[r.key] = row
            del args_list, q, kc, vc, ln, want


# the decode kernel's int8-cache form: qwen2.5-3b's row (the main one),
# starcoder2-7b's group of 9, zamba2-1.2b's shared attention (hd 64, G 1)
# and phi-3-vision's hd 96
INT8_DECODE_ROWS = (
    DecodeRow("qwen2.5-3b int8", 4, 16, 2, 1024, 128, role="main"),
    DecodeRow("starcoder2-7b int8", 4, 36, 4, 1024, 128),
    DecodeRow("zamba2 shared attention int8", 4, 32, 32, 1024, 64),
    DecodeRow("phi-3 decode int8", 4, 32, 32, 1024, 96))


def _int8_decode_rows(randn, record, tols):
    """The int8-cache form at INT8_DECODE_ROWS in bf16 and fp32 q, against
    its plain version over lengths drawn from 1 to W (seed 0: they cut a
    32-row tile), over lengths that reach the end, and over the ring
    (positions past W, the lengths clamped by ``layers.decode_attention``);
    its planted fault (the V scales ignored) must fail.  Timed beside its
    plain version and its bound in bytes (int8 K/V rows, fp32 scales, q
    and out); no PyTorch call reads int8 caches, so the library column is
    none, and SDPA's time over bf16 caches of the same shape stands beside
    it for context."""
    import importlib
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.models import layers as Lyr
    DA = importlib.import_module("repro_torch.kernels.decode_attention")
    dev = torch.device("cuda")
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    W0, B0 = RANDOM_LENGTHS
    lens0 = torch.randint(1, W0 + 1, (B0,), generator=torch.Generator()
                          .manual_seed(0), dtype=torch.int32)
    run = lambda q, kq, vq, ln, ks, vs: K.decode_attention_int8(
        q, kq, vq, ln, ks, vs)
    plain = lambda q, kq, vq, ln, ks, vs: K.decode_attention_plain(
        q, kq, vq, ln, k_scale=ks, v_scale=vs)
    for r in INT8_DECODE_ROWS:
        assert (r.W, r.B) == RANDOM_LENGTHS, r
        n_valid = int(lens0.sum())
        lens = lens0.to(dev)
        valid = torch.arange(r.W, device=dev)[None] < lens[:, None]

        def sdpa(q, kc, vc, ln, m=valid[:, None, None, :], r=r):
            return F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=m, enable_gqa=r.H != r.Hkv)
        cache_bytes = r.B * r.W * r.Hkv * (2 * r.hd + 8)
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8
            nbytes = 2 * r.B * r.H * r.hd * esz + \
                n_valid * r.Hkv * (2 * r.hd + 2 * 4) + 4 * r.B

            def make(r=r, dt=dt, lens=lens):
                kq, ks = Lyr.kv_quantize(randn(r.B, r.W, r.Hkv, r.hd,
                                               dt=torch.float32))
                vq, vs = Lyr.kv_quantize(randn(r.B, r.W, r.Hkv, r.hd,
                                               dt=torch.float32))
                return (randn(r.B, r.H, r.hd, dt=dt), kq, vq, lens.clone(),
                        ks, vs)
            args_list = cold_copies(make, cache_bytes)
            q, kq, vq, ln, ks, vs = args_list[0]
            case = (f"{r.label}: q {list(q.shape)} int8 caches "
                    f"{list(kq.shape)} G={r.H // r.Hkv} lengths "
                    f"{lens.tolist()} {dname}")
            want = plain(q, kq, vq, ln, ks, vs)
            err = _check(f"decode {case}", run(q, kq, vq, ln, ks, vs), want,
                         tols[dname])
            full = torch.full_like(ln, r.W)
            _check(f"decode {case}, lengths {r.W}",
                   run(q, kq, vq, full, ks, vs),
                   plain(q, kq, vq, full, ks, vs), tols[dname])
            pos = torch.tensor([r.W + 37, 2 * r.W + 5, r.W - 1, 100],
                               dtype=torch.int32, device=dev)[:r.B]
            _check(f"decode {case}, the ring at positions {pos.tolist()}",
                   Lyr.decode_attention(q[:, None], kq, vq, pos, window=r.W,
                                        k_scale=ks, v_scale=vs)[:, 0],
                   K.decode_attention_plain(q, kq, vq, pos + 1, window=r.W,
                                            k_scale=ks, v_scale=vs),
                   tols[dname])
            _reject(f"decode {case}, the V scales ignored",
                    DA._launch(q, kq, vq, ln, r.hd ** -0.5, k_scale=ks,
                               v_scale=vs, fault=DA.FAULT_IGNORE_V_SCALE),
                    want, tols[dname])
            row = record("decode_attention_int8", case,
                         r.role == "main" and dname == "bfloat16", err,
                         args_list, run, plain, None, nbytes,
                         4 * r.hd * r.H * n_valid, dname,
                         no_library="no single PyTorch call reads int8 "
                                    "caches")
            del args_list, q, kq, vq, ln, ks, vs, want

            def make16(r=r, dt=dt, lens=lens):
                return (randn(r.B, r.H, r.hd, dt=dt),
                        randn(r.B, r.W, r.Hkv, r.hd, dt=torch.bfloat16),
                        randn(r.B, r.W, r.Hkv, r.hd, dt=torch.bfloat16),
                        lens.clone())
            args16 = cold_copies(make16, 2 * r.B * r.W * r.Hkv * r.hd * 2)
            if dt == torch.float32:   # SDPA takes one dtype
                args16 = [(q.bfloat16(), kc, vc, ln)
                          for q, kc, vc, ln in args16]
            row["sdpa_bf16_ms"] = device_ms(sdpa, args16, repeats=MEDIAN_OF)
            log(f"kernels: decode_attention_int8 {r.label} {dname}: SDPA over "
                f"bf16 caches of the same shape {row['sdpa_bf16_ms']:.4f} ms "
                f"(for context; median of {MEDIAN_OF}) beside the int8 "
                f"kernel's {row['ms']:.4f} ms")
            del args16


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


BWD_RMSNORM_ROWS = ((8 * 128, 2048),)   # qwen2.5-3b's train step rows
BWD_FLASH_ROWS = (
    FlashRow("qwen2.5-3b train step", 8, 128, 128, 16, 2, 128, role="main",
             faults=("short_tiles",)),
    # G = 1 at hd 64: 6 runs a train step
    FlashRow("zamba2 shared attention train step", 8, 128, 128, 32, 32, 64),
    FlashRow("phi-3, 576 image + 128 text rows", 1, 704, 704, 32, 32, 96),
    FlashRow("whisper encoder", 2, 1500, 1500, 20, 20, 64, causal=False),
    # MLA (hd 192 = 128 + 64 rope, hd_v 128, G = 1): deepseek-v2-lite-16b's
    # train step, one run a layer in phase train's (e)
    FlashRow("deepseek MLA train step", 8, 128, 128, 16, 16, 192,
             role="moe", faults=("short_tiles",), hd_v=128))


def _backward_kernels(randn, record, tols, state):
    """The two backward kernels against their plain versions in bf16 and
    fp32, timed beside the plain version, the library's backward (its
    forward + backward through autograd less its forward) and the bound:
    rmsnorm's at BWD_RMSNORM_ROWS (bytes: x, g read, dx written; ~12
    flops an element), flash's at BWD_FLASH_ROWS (five products over the
    visible pairs, 2.5 times the forward's at hd_v = hd: S, dQ and dK over
    hd, dP and dV over hd_v); with the planted faults (a row's sums over
    its first warp's share; launch A one K tile short).  The MLA row is
    kept in ``state["moe_kernel_rows"]``."""
    import importlib
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def leaves_of(*ts):
        return [t.detach().requires_grad_() for t in ts]

    for R, D in BWD_RMSNORM_ROWS:
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8

            def make(R=R, D=D, dt=dt):
                return (randn(R, D, dt=dt),
                        randn(D, dt=torch.float32) * 0.1 + 1.0,
                        randn(R, D, dt=dt))
            args_list = cold_copies(make, 2 * R * D * esz)
            x, sc, g = args_list[0]
            want = K.rmsnorm_backward_plain(x, sc, g)
            got = K.rmsnorm_backward(x, sc, g)
            case = f"[{R},{D}] {dname}"
            err = max(_check(f"rmsnorm_backward {case} {name}", a, b,
                             tols[dname])
                      for name, a, b in zip(("dx", "dscale"), got, want))
            _reject(f"rmsnorm_backward {case}, a row's sums over its first "
                    f"warp's share", RN._launch_backward(
                        x, sc, g, 1e-5, fault=RN.FAULT_FIRST_WARP_ONLY)[0],
                    want[0], tols[dname])
            weights = {sc.data_ptr(): sc.to(dt) for _, sc, _ in args_list}

            def lib_fwd(x, sc, g, w=weights, D=D):
                xr, wr = leaves_of(x, w[sc.data_ptr()])
                return F.rms_norm(xr, (D,), wr, 1e-5), (xr, wr)

            def lib(x, sc, g):
                y, ins = lib_fwd(x, sc, g)
                return torch.autograd.grad(y, ins, g)
            record("rmsnorm_backward", case, dname == "bfloat16", err,
                   args_list, K.rmsnorm_backward, K.rmsnorm_backward_plain,
                   lib, 3 * R * D * esz + 8 * D, 12 * R * D, "float32",
                   library_minus=lib_fwd)
            del args_list, x, sc, g, want, got

    for r in BWD_FLASH_ROWS:
        off = r.Sk - r.Sq
        i, j = torch.arange(r.Sq)[:, None] + off, torch.arange(r.Sk)[None]
        vis = (i >= j) if r.causal else torch.ones(r.Sq, r.Sk, dtype=bool)
        if r.window:
            vis &= i - j < r.window
        pairs = r.B * int(vis.sum())
        kw = dict(causal=r.causal, window=r.window)
        kind = "causal" if r.causal else "bidirectional"
        run = lambda q, k, v, o, do, kw=kw: K.flash_attention_backward(
            q, k, v, o, do, **kw)
        plain = lambda q, k, v, o, do, kw=kw: \
            K.flash_attention_backward_plain(q, k, v, o, do, **kw)

        def lib_fwd(q, k, v, o, do, r=r):
            qr, kr, vr = leaves_of(q, k, v)
            y = F.scaled_dot_product_attention(
                qr.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2),
                is_causal=r.causal, enable_gqa=r.H != r.Hkv)
            return y, (qr, kr, vr)

        def lib(q, k, v, o, do, lib_fwd=lib_fwd):
            y, ins = lib_fwd(q, k, v, o, do)
            return torch.autograd.grad(y, ins, do.transpose(1, 2))
        for dname, dt in dts.items():
            esz = torch.finfo(dt).bits // 8
            # q, out, dout, dq and k, v, dk, dv each moved once
            nbytes = 2 * (r.Sq * r.H + r.Sk * r.Hkv) * r.B * (r.hd + r.dv) \
                * esz

            def make(r=r, dt=dt, kw=kw):
                q, k, v = (randn(r.B, r.Sq, r.H, r.hd, dt=dt),
                           randn(r.B, r.Sk, r.Hkv, r.hd, dt=dt),
                           randn(r.B, r.Sk, r.Hkv, r.dv, dt=dt))
                return (q, k, v, K.flash_attention(q, k, v, **kw),
                        randn(r.B, r.Sq, r.H, r.dv, dt=dt))
            args_list = cold_copies(make, nbytes)
            q, k, v, o, do = args_list[0]
            vs = f" v {list(v.shape)}" if r.hd_v else ""
            case = (f"{r.label}: q {list(q.shape)} k {list(k.shape)}{vs} "
                    f"{kind} {dname}")
            want = plain(q, k, v, o, do)
            err = max(_check(f"flash_attention_backward {case} {name}", a,
                             b, tols[dname])
                      for name, a, b in zip(("dq", "dk", "dv"),
                                            run(q, k, v, o, do), want))
            if "short_tiles" in r.faults:
                bad = FA._launch_backward(q, k, v, o, do, r.causal, r.window,
                                          r.hd ** -0.5, off, short_tiles=1)
                _reject(f"flash_attention_backward {case}, launch A one K "
                        f"tile short", torch.cat([t.flatten() for t in bad]),
                        torch.cat([t.flatten() for t in want]), tols[dname])
            row = record("flash_attention_backward", case,
                         r.role == "main" and dname == "bfloat16", err,
                         args_list, run, plain, lib, nbytes,
                         2 * (3 * r.hd + 2 * r.dv) * r.H * pairs, dname,
                         library_minus=lib_fwd)
            if r.role == "moe" and dname == "bfloat16":
                state.setdefault("moe_kernel_rows", {})[
                    "flash_attention_backward"] = row
            del args_list, q, k, v, o, do, want


# moe_gmm's backward (E, R, D, F): deepseek-v2-lite-16b's train row (batch
# 8 x seq 128: four groups of 256 tokens, C = 32, so R = 128 rows an
# expert) for w1/w3 (the kernels line's row) and for w2; mixtral-8x22b's
# (E 8, C 320; bf16)
BWD_GMM_ROWS = (("deepseek train w1/w3", 64, 128, 2048, 1408),
                ("deepseek train w2", 64, 128, 1408, 2048),
                ("mixtral train", 8, 320, 6144, 16384))


def _gmm_backward_kernels(randn, record, tols):
    """moe_gmm's backward against its plain version in bf16 and fp32 at
    BWD_GMM_ROWS (mixtral: bf16), timed beside the plain version, the
    library's two ``torch.bmm`` calls (dy wᵀ and xᵀ dy) and the bound
    (bytes: x, w, dy read once, dx, dw written once; 4 E R D F
    operations), with each launch's device ms (dx, dw); at the first row
    in bf16 the cp.async kernel (``_plan_backward(tma=False)``, which rows
    that are not 16-byte aligned take) checked and timed beside it; and,
    at the first row in both dtypes, the planted faults: launch dx with
    each w stage holding the step before's F tile, launch dw with R's last
    8-row group left out of the sum, and (bf16: the TMA kernel with dy
    resident) launch dw with a block's later units keeping its first
    unit's dy tile."""
    import importlib
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    MG = importlib.import_module("repro_torch.kernels.moe_gmm")
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def lib(x, w, dy):
        return torch.bmm(dy, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2),
                                                           dy)
    for i, (label, E, R, D, F_) in enumerate(BWD_GMM_ROWS):
        for dname, dt in dts.items():
            if E == 8 and dname == "float32":
                continue
            esz = torch.finfo(dt).bits // 8
            nbytes = (2 * E * R * D + 2 * E * D * F_ + E * R * F_) * esz

            def make(E=E, R=R, D=D, F_=F_, dt=dt):
                return ((randn(E, R, D, dt=torch.float32) * D ** -0.5).to(dt),
                        randn(E, D, F_, dt=dt), randn(E, R, F_, dt=dt))
            args_list = cold_copies(make, nbytes)
            x, w, dy = args_list[0]
            case = f"{label}: x [{E},{R},{D}] w [{E},{D},{F_}] {dname}"
            want = K.moe_gmm_backward_plain(x, w, dy)
            err = max(_check(f"moe_gmm_backward {case} {name}", a, b,
                             tols[dname])
                      for name, a, b in zip(("dx", "dw"),
                                            K.moe_gmm_backward(x, w, dy),
                                            want))
            if i == 0:
                _reject(f"moe_gmm_backward {case}, launch dx's w stages "
                        f"holding the step before's F tile",
                        MG._launch_backward(
                            x, w, dy, fault=MG.FAULT_STALE_TILE)[0],
                        want[0], tols[dname])
                _reject(f"moe_gmm_backward {case}, launch dw without R's "
                        f"last 8-row group",
                        MG._launch_backward(
                            x, w, dy, fault=MG.FAULT_DROP_ROW_GROUP)[1],
                        want[1], tols[dname])
                if dname == "bfloat16":
                    _reject(f"moe_gmm_backward {case}, launch dw with a "
                            f"block's later units keeping its first unit's "
                            f"resident dy tile",
                            MG._launch_backward(
                                x, w, dy, fault=MG.FAULT_STALE_RESIDENT)[1],
                            want[1], tols[dname])
            record("moe_gmm_backward", case, i == 0 and dname == "bfloat16",
                   err, args_list, K.moe_gmm_backward,
                   K.moe_gmm_backward_plain, lib, nbytes,
                   4 * E * R * D * F_, dname)
            split = _launch_split(K.moe_gmm_backward, args_list)
            plan = MG.plan_gmm_backward(E, R, D, F_, _build.sm_count(x.device))
            log(f"kernels: moe_gmm_backward {case} (tma {plan.tma}, dy "
                f"resident {plan.resident}) device ms by launch: "
                + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
            if i == 0 and dname == "bfloat16":
                cpa = MG._plan_backward(E, R, D, F_,
                                        _build.sm_count(x.device), False)
                run = lambda x, w, dy: MG._launch_backward(x, w, dy, cpa)
                err = max(_check(f"moe_gmm_backward {case} cp.async {n}", a,
                                 b, tols[dname])
                          for n, a, b in zip(("dx", "dw"), run(x, w, dy),
                                             want))
                log(f"kernels: moe_gmm_backward {case} by the cp.async "
                    f"kernel: err {err:.3g}, "
                    f"{device_ms(run, args_list, repeats=MEDIAN_OF):.4f} ms "
                    f"(median of {MEDIAN_OF}); by launch: " + ", ".join(
                        f"{k} {v:.4f}"
                        for k, v in _launch_split(run, args_list).items()))
            del args_list, x, w, dy, want


# the scan backwards' cases (B, Q, nc): a train step's rows (batch 8 of
# seq 128: one caller chunk, two kernel chunks) and the 300-token prompt's
# two chunks of 150
BWD_SCAN_CASES = ((8, 128, 1), (1, 150, 2))


def _scan_backward_bytes(which, B, Q, nc, esz):
    """Bytes one backward run must move: the forward's inputs, y (mLSTM),
    the cotangents of y and the final state read once, the gradients
    written once."""
    rows = B * nc * Q
    if which == "mamba":
        nh, P, N = 64, 64, 64
        return 12 * rows * nh * P + 4 * esz * rows * N + 8 * rows * nh \
            + 4 * B * nh * P * N
    nh, dh = 4, 512
    return 6 * esz * rows * nh * dh + 16 * rows * nh + 8 * rows * nh * dh \
        + 4 * B * nh * dh * (dh + 1)


def _least_ops(count, B, S):
    """The operations ``count(chunks, pairs)`` of a scan over B rows of S
    = nc·Q steps cut into chunks of L rows (the last shorter), at the L
    from 1 (the recurrent form) to the kernel's 64 whose work takes the
    least time at the peaks.  Every such cut computes the same scan (the
    kernel's own plan regroups the caller's chunks), so the least work of
    any of them bounds it: fewer rows a chunk means fewer causal pairs,
    more a chunk fewer products with a state a chunk."""
    def at(L):
        full, rest = divmod(S, L)
        return count(B * (full + (rest > 0)),
                     B * (full * L * (L + 1) + rest * (rest + 1)) // 2)
    return min((at(L) for L in range(1, 65)),
               key=lambda ops: sum(n / PEAK_OPS_S[d] for d, n in ops.items()))


def _scan_backward_ops(which, B, Q, nc, esz, parts):
    """{dtype name: operations} of one backward run, its multiply-adds at
    the least-work chunking (``_least_ops``): per row the state passes
    (recomputed forward, reverse) and the products with a state (SSD: dx̄,
    dB, dC; mLSTM: dq, dk, dv), per chunk the state's part of dg (fp32,
    elementwise), and the intra-chunk products over the causal pairs.
    With fp32 inputs every product is three TF32 products (3xTF32, the
    kernels' fp32 path).  With bf16 inputs C Bᵀ and q
    kᵀ are exact at the bf16 peak, a product with one fp32 operand costs
    ``parts`` bf16 products (the split) and one of two fp32 operands
    parts·(parts + 1)/2 (its cross terms down to the same order): SSD
    dy x̄ᵀ, the intra-chunk dx̄, and the states' dB and dC; mLSTM the
    intra-chunk dv and the state's dq."""
    rows = B * nc * Q
    if which == "mamba":
        nh, P, N = 64, 64, 64

        def count(chunks, pairs):     # exact, one fp32 operand, two, dots
            return (2 * pairs * N,
                    2 * (3 * rows * nh * P * N + 2 * pairs * nh * N),
                    2 * (2 * rows * nh * P * N + 2 * pairs * nh * P),
                    2 * chunks * nh * P * N)
    else:
        nh, dh = 4, 512

        def count(chunks, pairs):
            return (2 * nh * pairs * dh,
                    2 * nh * (3 * rows * dh * (dh + 1) + rows * dh * dh
                              + 3 * pairs * dh),
                    2 * nh * (rows * dh * (dh + 1) + pairs * dh),
                    2 * nh * chunks * dh * (dh + 1))

    def ops(chunks, pairs):
        exact, one, two, dots = count(chunks, pairs)
        if esz == 4:
            return {"tfloat32": 3 * (exact + one + two), "float32": dots}
        return {"bfloat16": exact + parts * one
                + parts * (parts + 1) // 2 * two, "float32": dots}
    return _least_ops(ops, B, nc * Q)


def _launch_split(fn, args_list):
    """{CUDA kernel: device ms a call} of ``fn(*args)``, one call for each
    cold copy in ``args_list``, under torch.profiler (the device's
    activity only); the kernels PyTorch launches around the custom ones
    (the wrapper's rebase and its adjoint) summed as "torch glue"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args_list:
            fn(*a)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        hit = re.search(r"(\w+_bwd_\w+(<[^>]*>)?)", e.name)
        name = hit.group(1) if hit else "torch glue"
        out[name] = out.get(name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3
    return {k: v / len(args_list) for k, v in out.items()}


def _scan_backward_kernels(randn, record):
    """The two scan backwards at BWD_SCAN_CASES, with bf16 and fp32 B, C
    (SSD) or q, k, v (mLSTM), against their plain versions on the same
    inputs and cotangents (the final state's nonzero); fp32 gradients at
    ``TOLERANCE`` of the largest reference value (dB, dC and dcum sum
    the 64 heads' or the rows' terms, of up to ~5e3, in another order),
    the bf16 ones at the bf16 limit; two runs bit-equal; the planted
    faults rejected (the chunk's state cotangent read from the chunk
    after it; the SSD's sum of dB over its head groups without the last;
    the mLSTM's sums of dg's column tiles and of its scores' d tiles
    without the last; with bf16 inputs every split cut to one part; and
    ``_scan_backward_slow_forget``); each call's device time by launch
    (``_launch_split``).  No single PyTorch call computes a scan's
    gradient."""
    import importlib
    import torch
    from repro_torch import kernels as K
    MS = importlib.import_module("repro_torch.kernels.mamba_scan")
    ML = importlib.import_module("repro_torch.kernels.mlstm")
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    f32 = torch.float32
    for which in ("mamba", "mlstm"):
        if which == "mamba":
            fwd, run, plain = (K.mamba_chunk_scan, K.mamba_chunk_scan_backward,
                               K.mamba_chunk_scan_backward_plain)
            launch, names = MS._launch_backward, ("dx", "dB", "dC", "dcum")
            faults = (("the state cotangent read from the chunk after",
                       MS.FAULT_WRONG_COTANGENT),
                      ("dB's sum of the head groups without its last",
                       MS.FAULT_DROP_GROUP),
                      ("every split cut to its first part",
                       MS.FAULT_ONE_PART))
            width = "zamba2 nh=64 P=64 N=64"
        else:
            fwd, run, plain = (K.mlstm_chunk_scan, K.mlstm_chunk_scan_backward,
                               K.mlstm_chunk_scan_backward_plain)
            launch, names = ML._launch_backward, ("dq", "dk", "dv", "dcumf",
                                                  "dli")
            faults = (("the state cotangent read from the chunk after",
                       ML.FAULT_WRONG_COTANGENT),
                      ("dg's column tiles without the last",
                       ML.FAULT_DROP_TILE),
                      ("the d tiles' scores summed without the last",
                       ML.FAULT_ROWS_DROP_TILE),
                      ("every split cut to its first part",
                       ML.FAULT_ONE_PART))
            width = "xlstm nh=4 dh=512"
        for (B, Q, nc) in BWD_SCAN_CASES:
            for dname, dt in dts.items():
                esz = torch.finfo(dt).bits // 8
                nbytes = _scan_backward_bytes(which, B, Q, nc, esz)

                def make(which=which, B=B, Q=Q, nc=nc, dt=dt, fwd=fwd):
                    ins = _scan_inputs(randn, which, B, Q, nc, dt)
                    outs = fwd(*ins)
                    cots = tuple(randn(*o.shape, dt=f32) for o in outs)
                    return (*ins, outs[0], *cots) if which == "mlstm" \
                        else (*ins, *cots)
                args_list = cold_copies(make, nbytes)
                a = args_list[0]
                case = f"{width} B={B} Q={Q} nc={nc} {dname}"
                got, want = run(*a), plain(*a)
                tol = K.TOLERANCE[dt]
                # fp32: atol tol * max |w|, rtol tol
                scales = [max(1.0, float(w.float().abs().max()))
                          if esz == 4 else 1.0 for w in want]
                err = 0.0
                for nm, g, w, sc in zip(names, got, want, scales):
                    assert g.dtype == w.dtype, (case, nm, g.dtype, w.dtype)
                    _check(f"{which} backward {case} {nm}", g.float() / sc,
                           w.float() / sc, tol)
                    err = max(err, float((g.float() - w.float()).abs().max()))
                assert all(torch.equal(g, h) for g, h in zip(got, run(*a))), \
                    f"{which} backward {case}: two runs differ"
                # a fault must fail the scaled check of one gradient, the
                # check each gradient of the kernel passed just above
                flat = lambda ts, scales=scales: torch.cat(
                    [t.float().flatten() / sc for t, sc in zip(ts, scales)])
                for label, fault in faults:
                    if fault == MS.FAULT_ONE_PART and esz == 4:
                        continue            # fp32 inputs split nothing
                    _reject(f"{which} backward {case}, {label}",
                            flat(launch(*a, fault=fault)), flat(want), tol)
                if which == "mlstm" and (B, Q, nc) == BWD_SCAN_CASES[0]:
                    _scan_backward_slow_forget(randn, dt, tol)
                split = _launch_split(run, args_list)
                log(f"kernels: {which} backward {case} by launch: " +
                    "; ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
                record(f"{which}_chunk_scan_backward", case,
                       (B, Q, nc) == BWD_SCAN_CASES[0] and dname == "bfloat16",
                       err, args_list, run, plain, None, nbytes,
                       _scan_backward_ops(which, B, Q, nc, esz,
                                          MS.BACKWARD_PARTS), dname)
                del args_list, a, got, want


def _scan_backward_slow_forget(randn, dt, tol):
    """The mLSTM backward at a train step's rows with forget gates near 1
    (cumf a hundredth of ``_scan_inputs``'): the state's cotangent term
    e^{gl} <dC'_out, C'_in> of dg then counts (at the usual gates e^{gl}
    is ~e^-10), so the check must reject the sum of its state tiles
    without the last tile."""
    import importlib
    import torch
    from repro_torch import kernels as K
    ML = importlib.import_module("repro_torch.kernels.mlstm")
    q, k, v, cumf, li = _scan_inputs(randn, "mlstm", 8, 128, 1, dt)
    cumf = cumf * 0.01
    outs = K.mlstm_chunk_scan(q, k, v, cumf, li)
    a = (q, k, v, cumf, li, outs[0],
         *(randn(*o.shape, dt=torch.float32) for o in outs))
    want = K.mlstm_chunk_scan_backward_plain(*a)
    scales = [max(1.0, float(w.float().abs().max()))
              if dt == torch.float32 else 1.0 for w in want]
    flat = lambda ts: torch.cat(
        [t.float().flatten() / sc for t, sc in zip(ts, scales)])
    case = f"xlstm nh=4 dh=512 B=8 Q=128 nc=1 slow forget {dt}"
    err = _check(f"mlstm backward {case}", flat(K.mlstm_chunk_scan_backward(
        *a)), flat(want), tol)
    log(f"kernels: mlstm backward {case}: err {err:.3g}")
    _reject(f"mlstm backward {case}, <dC'_out, C'_in> without its last "
            f"state tile", flat(ML._launch_backward(
                *a, fault=ML.FAULT_STATE_DROP_TILE)), flat(want), tol)


def _sass_mma_counts(keys=("flash_attention", "moe_gmm", "mlstm_scan",
                           "mamba_scan", "mlstm_bwd", "mamba_bwd",
                           "gmm_bwd")):
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
        for key in ("flash_attention_mma", "moe_gmm_mma", "moe_gmm_wgmma",
                    "gmm_bwd_wgmma", "gmm_bwd_tma"):
            mma = {k: c for k, c in counts.items() if key in k}
            assert mma and all(mma.values()), \
                f"kernels: the bf16 {key} kernels hold no HMMA: {counts}"
        # the scans' bf16 products: every scan kernel (the SSD's: C B^T
        # and the state update, then the carried term)
        for key in ("mlstm_scan_chunk_kernel", "mlstm_scan_out_kernel",
                    "mamba_scan_chunk_kernel", "mamba_scan_out_kernel",
                    "mlstm_bwd_pass_kernel", "mlstm_bwd_rows_kernel",
                    "mlstm_bwd_out_kernel", "mamba_bwd_pass_kernel",
                    "mamba_bwd_chunk_kernel"):
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
    chunked form at the least-work chunking (``_least_ops``), each at the
    peak of the fastest way that meets the fp32 limit.  With fp32 inputs
    every product is fp32.  With bf16 inputs a product of two bf16
    operands (C Bᵀ, q kᵀ) is exact at the bf16 peak; one with an fp32
    operand (the state, x̄, the decayed scores) costs ``parts`` bf16
    products (the split); the SSD's (C Bᵀ ⊙ decay) x̄ stays fp32, since
    its split fails the limit."""
    rows = B * nc * Q

    def ops(chunks, pairs):
        if which == "mamba":
            nh, P, N = 64, 64, 64
            exact, fp32 = 2 * pairs * N, 2 * pairs * nh * P
            split = 2 * 2 * rows * nh * P * N       # carried term, state
        else:
            nh, dh = 4, 512
            exact, fp32 = 2 * nh * pairs * dh, 2 * nh * pairs  # q kᵀ, sums
            split = 2 * nh * (pairs * dh + 2 * rows * dh * dh + rows * dh)
        if esz == 4:
            return {"float32": exact + fp32 + split}
        return {"bfloat16": exact + parts * split, "float32": fp32}
    return _least_ops(ops, B, nc * Q)


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


def _parity(cfg, toks, lens=None, cache_len=128, k=8, extra=None):
    """``cfg`` at full width, fp32: prefill (batched with ``lens``, else
    per request), its caches, one decode step and one fused block on the
    card (kernels) against the same weights on the CPU (plain versions).
    ``extra`` holds the batch's other inputs (numpy: whisper's frames,
    phi-3-vision's image embeds, whose rows count in the positions)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.cache import cache_leaves
    from repro_torch.training import steps as ST

    cpu_params = M.init_params(cfg, seed=0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to("cuda")
    fused = ST.make_fused_decode_step(cfg, k=k)
    res, routes = {}, {}
    extra = extra or {}
    n_img = extra["image_embeds"].shape[1] if "image_embeds" in extra else 0
    for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        t = torch.as_tensor(toks, device=dev)
        batch = {"tokens": t, **{name: torch.as_tensor(a, device=dev)
                                 for name, a in extra.items()}}
        with _routes_recorded(routes.setdefault(dev, [])):
            if lens is None:
                out, caches = ST.make_prefill_step(cfg, cache_len)(
                    params, batch)
                pos = torch.full((t.shape[0],), t.shape[1] + n_img,
                                 dtype=torch.int32, device=dev)
            else:
                pos = torch.as_tensor(lens, dtype=torch.int32, device=dev)
                out, caches = ST.make_batched_prefill_step(cfg, cache_len)(
                    params, t, pos)
        prefilled = [c.to("cpu", copy=True) for c in cache_leaves(caches)]
        logits, _ = M.forward(params, cfg, batch)
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


def _serve(cfg, params, prompts, max_new, block_k, speculate=True,
           int8=False):
    """One engine run; returns (outputs, launches, seconds, tokens,
    stats) after checking every token and every stream's end; ``int8``
    counts the int8 forms' launches too."""
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
    launches = K.launch_counts(K.KERNELS + (K.INT8_KERNELS if int8 else ()))
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
    base = _serving_base()
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
    state["serve_memory"] = _serving_memory("serve", cfg, params, base)
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


def _param_bytes(params):
    """Bytes of a ParamTree's (or a tree's) tensors: int8 values and fp32
    scales where it is quantized."""
    import torch
    from repro_torch.models import layers as Lyr
    tree = Lyr.to_tree(params) if isinstance(params, torch.nn.Module) \
        else params
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree))


def _serving_base():
    """Device bytes allocated before a serve, the peak reset."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _serving_memory(label, cfg, params, base):
    """(resident param GB, GB the serves allocated above what was resident
    before them at their peak), logged."""
    import torch
    torch.cuda.synchronize()
    resident = _param_bytes(params) / 1e9
    working = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"{label} {cfg.name}: params resident {resident:.3f} GB; peak "
        f"device memory above what was resident before the serves "
        f"{working:.3f} GB (caches, activations, dequantized blocks); "
        f"the server's own {resident + working:.3f} GB")
    return resident, working


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
    mlstm_scan_chunk_kernel and mlstm_scan_out_kernel, ...); the decode
    kernel's int8 form by its int8 cache type (``signed char``) in it."""
    from torch.autograd import DeviceType
    from repro_torch import kernels as K
    out = []
    for k in K.KERNELS + K.INT8_KERNELS:
        stem = Path(sys.modules[k.__module__].SOURCE).stem
        int8 = k in K.INT8_KERNELS
        ts = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and stem in e.name
              and ("signed char" in e.name) == int8]
        out.append((k.__name__, sum(ts) / 1e3, len(ts)))
    return out


def _timed(label, fn):
    """Wall ms of one synchronised ``fn()`` (best of three, after one to
    warm) and torch.profiler's device busy ms (the union of the CUDA
    kernels' intervals) for one more call, logged under ``label`` with
    each custom kernel's device ms and wrapper launches in that call:
    (wall ms, busy ms, the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = K.launch_counts(K.KERNELS + K.INT8_KERNELS)
    busy, n_kern = _device_busy(prof)
    wall = min(walls)
    log(f"{label}: {wall:.2f} ms wall (best of "
        f"{[round(w, 2) for w in walls]}); device busy {busy:.2f} ms over "
        f"{n_kern} kernels; device idle share {1 - busy / wall:.3f}")
    for name, ms, n in _custom_kernel_ms(prof):
        if n:
            log(f"{label}: {name} {ms:.4f} ms of device time over "
                f"{launches[name]} wrapper launches ({n} CUDA kernels, "
                f"{ms * 1e3 / n:.2f} us each; {ms / busy:.4f} of device "
                f"busy)")
    return wall, busy, prof


def _profile(cfg, params, eng=None, label=""):
    """Where one fused decode block's time goes at full width
    (``_timed``), with the profile's top ops by device and host time.
    ``eng`` is the live engine unless given (it must serve 4 slots, cache
    1024, block_k 8, no speculation); returns (wall ms, device busy ms)."""
    import numpy as np
    import torch
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
    wall, busy, prof = _timed(
        f"profile {name}: one 8-step decode block, 4 slots", eng.step_block)
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
    width (the prefill step the Engine runs for a recurrent model), as
    ``_timed`` measures it."""
    import numpy as np
    import torch
    from repro_torch.training import steps as ST

    step = ST.make_prefill_step(cfg, 1024)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(3, cfg.vocab_size, (1, S))
                           .astype("int32"), device="cuda")
    _timed(f"prefill {cfg.name}: one request of {S} tokens",
           lambda: step(params, {"tokens": toks}))


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
                times[(which, B, Q, nc, dname)] = device_ms(
                    kernel, args, repeats=MEDIAN_OF)
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
# qwen2.5-3b's depth in phases replay, registry and fleet: exporting,
# recording and loading its programs take host time in proportion to the
# depth (36 layers: 75 s to record the decode block and 45-57 s for each
# of its four loads, a third of the script; at 4 layers phases replay and
# int8 still spent ~115 s recording, with the script at 1,125 s of its
# 1,200)
REPLAY_LAYERS = 2


def _replay_model(state):
    """qwen2.5-3b at full width cut to ``REPLAY_LAYERS`` layers, and its
    weights from seed 0, drawn once for the three phases that share its
    recordings and live tokens."""
    if "replay_model" not in state:
        from repro_torch.configs import get_config
        cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                                  num_layers=REPLAY_LAYERS)
        state["replay_model"] = cfg, _init_params(cfg)
    return state["replay_model"]


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


def _replay_serve(label, eng, prompts, max_new, rp=None, kernels=None):
    """Serve ``prompts`` on ``eng``: (outputs, stats, wrapper launches of
    ``kernels`` (``K.KERNELS`` unless given), graph replays) after
    checking every stream's end."""
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
    st, launches = dict(eng.stats), K.launch_counts(kernels or K.KERNELS)
    ntok = sum(len(v) for v in outs.values())
    log(f"replay: serve {label} [{eng.channel.kind}]: {ntok} tokens in "
        f"{dt:.3f} s ({ntok / dt:.1f} tok/s); stats {st}; wrapper launches "
        f"{launches}; graph replays {replays}")
    for rid, toks in outs.items():
        assert len(toks) == max_new or toks[-1] == 2, (rid, toks)
    return outs, st, launches, replays


def _replay_prompts(cfg, seq=128, n=8):
    """The prompts phases replay and registry serve (seed 4)."""
    import numpy as np
    rng = np.random.default_rng(4)
    return [list(map(int, rng.integers(3, cfg.vocab_size, seq)))
            for _ in range(n)]


def phase_replay(state):
    """Record -> sign -> replay at full width (``REPLAY_LAYERS`` layers):
    qwen2.5-3b's prefill (batch 1, seq 128) and fused decode block (4
    slots, cache 1024, block_k 8) recorded with the record launcher's code
    through a wifi ``RecordingSession`` with all passes, signed, saved,
    verified and loaded; the session's host seconds naive and with all
    passes; the tampered forms refused before load; 8 prompts of 128 tokens
    served live, replayed eagerly and replayed through the decode block's
    CUDA graph, then live and under the graph again, each dispatch billed
    to a wifi emulator through a ``NetemBilledChannel``, with identical
    tokens and host syncs and identical billing logs; one decode block
    profiled under the graph beside live."""
    import tempfile
    import torch
    from repro_torch.api.workload import format_session_report, recording_name
    from repro_torch.core.channel import (LiveChannel, NetemBilledChannel,
                                          ReplayChannel)
    from repro_torch.core.netem import WIFI, NetworkEmulator
    from repro_torch.core.recording import Recording
    from repro_torch.core.replay import Replayer
    from repro_torch.launch.record import record_kinds
    from repro_torch.launch.serve import stream_kwargs
    from repro_torch.models import layers as Lyr
    from repro_torch.models import model as M
    from repro_torch.record import RecordingSession
    from repro_torch.serving.engine import Engine
    from repro_torch.training import steps as ST

    torch.cuda.reset_peak_memory_stats()
    cfg, params = _replay_model(state)
    L, block_k, seq, max_new = cfg.num_layers, 8, 128, 32
    log(f"replay: {cfg.name} at full width, {L} layers, on {_card(state)}")
    kw = dict(n_slots=4, cache_len=1024, block_k=block_k, eos_id=2,
              speculate=True, pipeline_depth=4, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        recs = record_kinds(cfg, out=d, key=REPLAY_KEY, cache_len=1024,
                            block_k=block_k, batch=4, seq=seq, params=params,
                            device="cuda", net="wifi", passes="all")
        log(f"replay: recorded and signed both kinds through wifi "
            f"sessions in {time.perf_counter() - t0:.2f} s")
        state["replay_recs"] = {k: rec for k, (_p, rec) in recs.items()}
        for kind, (path, rec) in recs.items():
            m = rec.manifest
            log(f"replay: {kind}: record_wall_s {m['record_wall_s']:.2f}, "
                f"payload {len(rec.payload) / 1e6:.2f} MB, "
                f"{len(m['inputs'])} inputs, arg_bytes "
                f"{m['memory']['arg_bytes'] / 1e6:.1f} MB, out_bytes "
                f"{m['memory']['out_bytes'] / 1e6:.3f} MB")
            log(f"replay: {kind}: "
                f"{format_session_report(m['record_session'])} (emulated)")
            assert m["record_session"]["net"] == "wifi", m["record_session"]
            # the session's own host cost at full width, naive and all
            # passes, over a copy of this artifact
            for passes in ("none", "all"):
                s = RecordingSession.for_profile(WIFI, passes=passes)
                t1 = time.perf_counter()
                s.finalize(Recording(dict(m), rec.payload, rec.trees))
                r = s.report()
                log(f"replay: {kind}: session {passes:4s} host "
                    f"{time.perf_counter() - t1:.3f} s for {r['jobs']} "
                    f"jobs; emulated {r['virtual_time_s']} s, "
                    f"{r['blocking_round_trips']} blocking RTs, "
                    f"{(r['bytes_sent'] + r['bytes_received']) / 1e6:.3f} MB")
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
    prompts = _replay_prompts(cfg, seq)

    # (a) live, through the same per-request prefill the recording pins
    live = Engine(params, channel=LiveChannel(
        ST.make_prefill_step(cfg, 1024),
        ST.make_fused_decode_step(cfg, k=block_k)),
        **stream_kwargs(cfg, **kw))
    runs = {"live": _replay_serve("live", live, prompts, max_new)}
    state["replay_live"] = runs["live"]
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
    # the same two ways again, every dispatch, commit and drain billed to
    # an emulated wifi link (the reference's "identical across live and
    # replay channels")
    billed = {}
    for label, inner, p in (
            ("billed live", LiveChannel(
                ST.make_prefill_step(cfg, 1024),
                ST.make_fused_decode_step(cfg, k=block_k)), params),
            ("billed graph", channel, tree)):
        em = NetworkEmulator(WIFI)
        eng = Engine(p, channel=NetemBilledChannel(inner, em), netem=em,
                     **stream_kwargs(cfg, **kw))
        runs[label] = _replay_serve(label, eng, prompts, max_new,
                                    rp if "graph" in label else None)
        billed[label] = (eng.channel.log, em.snapshot())
        log(f"replay: {label}: emulated wifi link {em.virtual_time_s:.6f} s "
            f"(model output, not measured), {em.snapshot()}")
    assert billed["billed live"] == billed["billed graph"], \
        "replay: billing logs differ across live and replay channels"
    for label in ("eager", "graph", "billed live", "billed graph"):
        assert runs[label][0] == runs["live"][0], \
            f"replay: {label} tokens differ from live"
        assert runs[label][1]["host_syncs"] == runs["live"][1]["host_syncs"], \
            (label, runs[label][1], runs["live"][1])
    # launches: every kernel through its wrapper live and eager; under the
    # graph the decode blocks' only through their replays
    for label, (outs, st, launches, replays) in runs.items():
        pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
        if "graph" in label:
            assert replays == bd, (replays, bd)
            for k, n in per_replay.items():
                launches[k] += n * replays
        want = {"flash_attention": L * pd,
                "decode_attention": L * block_k * bd,
                "rmsnorm": (2 * L + 1) * (pd + block_k * bd), "moe_gmm": 0,
                "mamba_chunk_scan": 0, "mlstm_chunk_scan": 0}
        assert launches == want, (label, launches, want)
    log("replay: live, eager replay, graph replay and both billed serves "
        "give identical tokens and host syncs; the billing logs are equal; "
        "launches equal the formulas")

    # one synchronous decode block, live and under the graph
    live_wall, live_busy = _profile(cfg, params, label=" live")
    eng = Engine(tree, channel=channel, **stream_kwargs(
        cfg, **dict(kw, speculate=False)))
    g_wall, g_busy = _profile(cfg, params, eng=eng, label=" graph replay")
    state["replay_block"] = g_wall, g_busy
    log(f"replay: decode block wall {live_wall:.2f} -> {g_wall:.2f} ms, "
        f"device busy {live_busy:.2f} -> {g_busy:.2f} ms, idle share "
        f"{1 - live_busy / live_wall:.3f} -> {1 - g_busy / g_wall:.3f} "
        f"(live -> graph replay)")
    assert rp.stats["captures"] == 1, rp.stats
    log(f"replay: replayer stats {rp.stats}; peak memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; all figures "
        f"of this phase on {_card(state)}")


INT8_PARITY_LAYERS = 2


def _int8_parity(label, cfg, cpu_params, toks, rel_tol):
    """The card's int8 prefill (per-request step), one decode step and one
    fused block of 8 against the port's CPU path on the same params, both
    decoding from the CPU's first tokens (in bf16 the two prefills' argmax
    may differ among near-equal logits): logits within ``rel_tol`` of the
    CPU's largest |logit| (fp32: atol = rtol = ``rel_tol`` as phase
    parity), int8 cache values at most one step apart, and in fp32 the
    block's tokens equal."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.cache import cache_leaves
    from repro_torch.training import steps as ST

    gpu_params = copy.deepcopy(cpu_params).to("cuda")
    fused = ST.make_fused_decode_step(cfg, k=8)
    res, first = {}, None
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        t = torch.as_tensor(toks, device=dev)
        out, caches = ST.make_prefill_step(cfg, 128)(params, {"tokens": t})
        prefilled = [c.to("cpu", copy=True) for c in cache_leaves(caches)]
        if first is None:
            first = out["next_tokens"].cpu()
        same_first = torch.equal(out["next_tokens"].cpu(), first)
        nxt = first.to(dev)
        pos = torch.full((t.shape[0],), t.shape[1], dtype=torch.int32,
                         device=dev)
        step, _ = M.decode_step(params, cfg, nxt, pos.clone(),
                                copy.deepcopy(caches))
        blk, caches = fused(params, nxt, pos, caches)
        res[dev] = dict(prefill=out["last_logits"].float().cpu(),
                        step=step.float().cpu(), tokens=blk["tokens"].cpu(),
                        prefilled=prefilled,
                        caches=[c.cpu() for c in cache_leaves(caches)])
    del gpu_params
    g, c = res["cuda"], res["cpu"]
    fp32 = cfg.dtype == "float32"
    for name in ("prefill", "step"):
        err = (g[name] - c[name]).abs().max().item()
        scale = c[name].abs().max().item()
        ok = torch.allclose(g[name], c[name], atol=rel_tol, rtol=rel_tol) \
            if fp32 else err <= rel_tol * scale
        assert ok, f"int8 parity {label}: {name} logits differ by {err} " \
            f"(largest |logit| {scale})"
        log(f"int8 parity {label}: {name} logits {tuple(g[name].shape)} max "
            f"|err| {err:.3g} (largest |logit| {scale:.3g})")
    # the prefill's caches (in bf16 the blocks' tokens may part, and then
    # their cache rows), and in fp32 the block's caches too: at most one
    # step apart in fp32 (bf16 K/V differ by a few ulps between cuBLAS and
    # the CPU's products, an ulp being about one int8 step near a row's
    # largest value, so bf16 is logged only)
    for name in ("prefilled", "caches") if fp32 else ("prefilled",):
        n_int8 = n_diff = worst = 0
        for a, b in zip(g[name], c[name]):
            if a.dtype == torch.int8:
                d = (a.int() - b.int()).abs()
                n_int8 += d.numel()
                n_diff += int((d > 0).sum())
                worst = max(worst, int(d.max()))
        assert n_int8 and (worst <= 1 or not fp32), \
            (name, n_int8, n_diff, worst)
        which = "prefill's" if name == "prefilled" else "fused block's"
        log(f"int8 parity {label}: {n_diff} of {n_int8} int8 values of the "
            f"{which} caches differ between card and CPU, by at most {worst}")
    same = int((g["tokens"] == c["tokens"]).all(-1).sum())
    if fp32:
        assert same_first and torch.equal(g["tokens"], c["tokens"]), \
            (same_first, g["tokens"].tolist(), c["tokens"].tolist())
    log(f"int8 parity {label}: the card's prefill chose the CPU's first "
        f"tokens: {same_first}; fused-block tokens equal on {same} of "
        f"{g['tokens'].shape[0]} rows: {g['tokens'].tolist()}")


def phase_int8(state):
    """Int8 serving on the card, through the API (no command-line switch):
    (a) qwen2.5-3b at full width and depth quantized by ``quantize_params``
    on the card; (b) that tree served with ``kv_quant`` through the Engine
    (4 slots, cache 1024, block_k 8, 8 prompts, 32 new tokens),
    speculation on and off, with identical streams, launches equal to the
    formulas (the int8 decode form L * block_k a block, the bf16 form and
    the CPU's plain version never) and peak memory beside phase serve's
    bf16 server; (c) the card against the CPU at full width and 2 layers,
    fp32 with int8 caches and bf16 with int8 weights and caches; (d) the
    int8 step recorded, signed, verified and replayed at
    ``REPLAY_LAYERS`` layers, live, eagerly and under the decode block's
    CUDA graph with identical tokens, a bf16 tree refused, the block's
    wall and busy ms under the graph beside phase replay's bf16 block;
    (e) starcoder2-7b at full width and 4 layers with int8 caches (G = 9,
    the window form) through the Engine."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.api.workload import recording_name
    from repro_torch.configs import get_config
    from repro_torch.core.channel import LiveChannel, ReplayChannel
    from repro_torch.core.replay import ReplayArgumentError, Replayer
    from repro_torch.launch.record import record_kinds
    from repro_torch.launch.serve import stream_kwargs
    from repro_torch.models import layers as Lyr
    from repro_torch.models import model as M
    from repro_torch.serving import quant as Q
    from repro_torch.serving.engine import Engine
    from repro_torch.training import steps as ST
    DA = sys.modules["repro_torch.kernels.decode_attention"]
    counted = K.KERNELS + K.INT8_KERNELS
    block_k, max_new = 8, 32

    # (a) quantize on the card
    cfg = get_config("qwen2.5-3b")
    L = cfg.num_layers
    params = state.get("params", {}).get(cfg.name)
    if params is None:
        params = _init_params(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pq = Q.quantize_params(params)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    n_q = sum(t.dtype == torch.int8 for t in pq.parameters())
    log(f"int8 (a): {cfg.name} quantized on the card in {t_q:.3f} s: "
        f"{n_q} int8 leaves; params {_param_bytes(params) / 1e9:.3f} GB in "
        f"bf16 -> {_param_bytes(pq) / 1e9:.3f} GB int8 + scales and the "
        f"leaves left bf16, on {_card(state)}")

    # (b) served with int8 caches; the CPU's plain version never runs
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    prompts = _prompts(cfg, 8, 0)
    plain_calls = [0]
    real_plain = DA.decode_attention_plain

    def counted_plain(q, *a, **kw):
        plain_calls[0] += q.device.type != "cpu"
        return real_plain(q, *a, **kw)
    DA.decode_attention_plain = counted_plain
    runs = {}
    try:
        base = _serving_base()
        for speculate in (True, False):
            outs, launches, dt, ntok, st = _serve(cfgq, pq, prompts, max_new,
                                                  block_k, speculate,
                                                  int8=True)
            pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
            want = dict.fromkeys(launches, 0)
            want.update(flash_attention=L * pd,
                        decode_attention_int8=L * block_k * bd,
                        rmsnorm=(2 * L + 1) * (pd + block_k * bd))
            assert launches == want, (launches, want)
            runs[speculate] = (outs, launches, st, ntok / dt)
        memory = _serving_memory("int8 (b)", cfgq, pq, base)
    finally:
        DA.decode_attention_plain = real_plain
    assert plain_calls[0] == 0, plain_calls
    assert runs[True][0] == runs[False][0], \
        "int8: speculative and synchronous token streams differ"
    assert runs[True][2]["host_syncs"] < runs[False][2]["host_syncs"]
    state["int8_launches"] = dict(runs[True][1])
    bf16 = state.get("serve_memory")
    log(f"int8 (b): speculative and synchronous streams identical; launches "
        f"equal the formulas ({runs[True][1]}); the plain version ran on "
        f"the card {plain_calls[0]} times; {runs[True][3]:.1f} tok/s "
        f"(spec); server memory {sum(memory):.3f} GB int8"
        + (f" against {sum(bf16):.3f} GB for phase serve's bf16 server "
           f"({bf16[0]:.3f} GB params + {bf16[1]:.3f} GB)" if bf16 else ""))
    del pq
    torch.cuda.empty_cache()

    t_part = time.perf_counter()
    log(f"int8 (a), (b): {t_part - t0:.1f} s")

    # (c) the card against the CPU at full width and 2 layers
    rng = np.random.default_rng(7)
    small = dataclasses.replace(cfgq, num_layers=INT8_PARITY_LAYERS)
    toks = rng.integers(3, cfg.vocab_size, (2, 37)).astype("int32")
    f32 = dataclasses.replace(small, dtype="float32")
    _int8_parity("fp32, int8 caches", f32,
                 M.init_params(f32, seed=0, device="cpu"), toks, 1e-3)
    _int8_parity("bf16, int8 weights and caches", small,
                 Q.quantize_params(M.init_params(small, seed=0,
                                                 device="cpu")),
                 toks, K.TOLERANCE[torch.bfloat16])

    log(f"int8 (c): {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # (d) record -> sign -> verify -> replay at REPLAY_LAYERS layers
    rcfg, rparams = _replay_model(state)
    rcfg = dataclasses.replace(rcfg, kv_quant=True)
    RL, seq = rcfg.num_layers, 128
    rq = Q.quantize_params(rparams)
    kw = dict(n_slots=4, cache_len=1024, block_k=block_k, eos_id=2,
              speculate=True, pipeline_depth=4, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        recs = record_kinds(rcfg, out=d, key=REPLAY_KEY, cache_len=1024,
                            block_k=block_k, batch=4, seq=seq, params=rq,
                            device="cuda")
        t_rec = time.perf_counter() - t0
        inputs = recs["decode"][1].manifest["inputs"]
        dtypes = sorted({i["dtype"] for i in inputs})
        t0 = time.perf_counter()
        rp = Replayer(key=REPLAY_KEY, device="cuda")
        pre = rp.load(os.path.join(d, recording_name(rcfg.name, "prefill")))
        dec = rp.load(os.path.join(d, recording_name(rcfg.name, "decode")))
        t_load = time.perf_counter() - t0
    log(f"int8 (d): {rcfg.name} at {RL} layers: both kinds recorded and "
        f"signed in {t_rec:.2f} s (decode record_wall_s "
        f"{recs['decode'][1].manifest['record_wall_s']:.2f}), verified and "
        f"loaded in {t_load:.2f} s; the decode step takes {len(inputs)} "
        f"inputs of dtypes {dtypes}")
    assert "int8" in dtypes, dtypes
    channel = ReplayChannel(rp, pre, dec)
    tree = Lyr.to_tree(rq)
    prompts = _replay_prompts(rcfg, seq)
    live = Engine(rq, channel=LiveChannel(
        ST.make_prefill_step(rcfg, 1024),
        ST.make_fused_decode_step(rcfg, k=block_k)),
        **stream_kwargs(rcfg, **kw))
    runs = {"live": _replay_serve("int8 live", live, prompts, max_new,
                                  kernels=counted)}
    runs["eager"] = _replay_serve("int8 replay eager", Engine(
        tree, channel=channel, **stream_kwargs(rcfg, **kw)), prompts,
        max_new, rp, kernels=counted)
    rp.warm(dec)
    zeros = torch.zeros(4, dtype=torch.int32, device="cuda")
    rp.execute(dec, tree, zeros, zeros.clone(),
               M.init_cache(rcfg, 4, 1024, device="cuda"))
    per_replay = rp.captured_launches(dec)
    assert per_replay == {"decode_attention_int8": RL * block_k,
                          "rmsnorm": (2 * RL + 1) * block_k}, per_replay
    runs["graph"] = _replay_serve("int8 replay graph", Engine(
        tree, channel=channel, **stream_kwargs(rcfg, **kw)), prompts,
        max_new, rp, kernels=counted)
    for label in ("eager", "graph"):
        assert runs[label][0] == runs["live"][0], \
            f"int8: {label} replay tokens differ from live"
    for label, (outs, st, launches, replays) in runs.items():
        pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
        if label == "graph":
            assert replays == bd, (replays, bd)
            for k, n in per_replay.items():
                launches[k] += n * replays
        want = dict.fromkeys(launches, 0)
        want.update(flash_attention=RL * pd,
                    decode_attention_int8=RL * block_k * bd,
                    rmsnorm=(2 * RL + 1) * (pd + block_k * bd))
        assert launches == want, (label, launches, want)
    try:
        rp.execute(dec, Lyr.to_tree(rparams), zeros, zeros.clone(),
                   M.init_cache(rcfg, 4, 1024, device="cuda"))
    except ReplayArgumentError as e:
        log(f"int8 (d): a bf16 tree refused by the int8 recording: "
            f"{str(e)[:160]}")
    else:
        raise AssertionError("int8: the int8 recording took a bf16 tree")
    log("int8 (d): live, eager replay and graph replay give identical "
        "tokens; launches equal the formulas (one graph replay launches "
        f"{per_replay})")
    eng = Engine(tree, channel=channel, **stream_kwargs(
        rcfg, **dict(kw, speculate=False)))
    g_wall, g_busy = _profile(rcfg, rq, eng=eng, label=" int8 graph replay")
    bf16 = state.get("replay_block")
    log(f"int8 (d): int8 decode block under the graph {g_wall:.2f} ms wall, "
        f"{g_busy:.2f} ms device busy"
        + (f"; phase replay's bf16 block {bf16[0]:.2f} ms wall, "
           f"{bf16[1]:.2f} ms busy" if bf16 else "")
        + f" (8 steps, 4 slots, {RL} layers, on {_card(state)})")
    del rq, tree, live, eng, channel, rp
    torch.cuda.empty_cache()
    log(f"int8 (d): {time.perf_counter() - t_part:.1f} s")

    # (e) starcoder2-7b with int8 caches: G = 9, the window form
    scfg = dataclasses.replace(get_config("starcoder2-7b"), num_layers=4,
                               kv_quant=True)
    SL = scfg.num_layers
    sparams = _init_params(scfg)
    outs, launches, dt, ntok, st = _serve(scfg, sparams, _prompts(scfg, 8, 3),
                                          max_new, block_k, int8=True)
    pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention=SL * pd,
                decode_attention_int8=SL * block_k * bd,
                rmsnorm=(2 * SL + 1) * (pd + block_k * bd))
    assert launches == want, (launches, want)
    assert {(q, k) for q, k in K.decode_attention_int8.by_shape} == \
        {((4, 36, 128), (4, 1024, 4, 128))}, K.decode_attention_int8.by_shape
    log(f"int8 (e): {scfg.name} at {SL} layers, G = 9, window "
        f"{scfg.sliding_window}, int8 caches: launches equal {want}")
    del sparams
    torch.cuda.empty_cache()


REGISTRY_BENCH_KEY = b"registry-bench-key"
# the reference bench's shapes (benchmarks/registry_bench.py)
REGISTRY_SHAPES = dict(cache_len=64, block_k=4, batch=1, prefill_batch=1,
                       seq=16)


@contextlib.contextmanager
def _wall_of(owner, name, into):
    """Append the wall seconds of each call of ``owner.name`` (ended by a
    device synchronise) to ``into[name]`` while the block runs."""
    import torch
    real = getattr(owner, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            into.setdefault(name, []).append(time.perf_counter() - t0)
    setattr(owner, name, timed)
    try:
        yield into
    finally:
        setattr(owner, name, real)


def _registry_scenarios(profile, reg_key, rec, key, device="cuda"):
    """The three scenarios of the reference's registry bench
    (``benchmarks/registry_bench.py``) through the port's ``Workspace``,
    on one signed recording: a cold fetch that records on miss (single-
    flight, the record cost read off the manifest), a warm hit from a new
    device, and a delta re-record (the manifest changed, the payload
    not) refetched by the warm device.  Returns the rows, emulated
    seconds unrounded (link model output)."""
    from repro_torch.api import Workspace
    from repro_torch.core.recording import Recording
    ws = Workspace(registry=":memory:", key=key, net=profile.name,
                   device=device)
    rows = []
    net = ws.fresh_netem()
    cold = ws.new_client(netem=net)
    calls = []
    blob = cold.fetch(reg_key, record_fn=lambda: calls.append(1) or rec)
    rows.append({"scenario": "cold_record", "net": profile.name,
                 "time_s": net.virtual_time_s,
                 "recording_round_trips":
                     cold.stats["recording_round_trips"],
                 "record_calls": len(calls),
                 "bytes_received": net.bytes_received})
    net = ws.fresh_netem()
    warm = ws.new_client(netem=net)
    assert warm.fetch(reg_key) == blob
    rows.append({"scenario": "warm_hit", "net": profile.name,
                 "time_s": net.virtual_time_s,
                 "recording_round_trips":
                     warm.stats["recording_round_trips"],
                 "record_calls": 0, "bytes_received": net.bytes_received})
    full = ws.service.publish(reg_key + "/fullbase", rec)
    tweaked = Recording(dict(rec.manifest, static=dict(
        rec.manifest.get("static", {}), revision=2)), rec.payload,
        rec.trees).sign_with(key)
    delta = ws.service.publish(reg_key, tweaked)
    mark = net.checkpoint()
    warm.fetch(reg_key)         # holds v1's chunks: pulls the delta only
    d = net.delta(mark)
    rows.append({"scenario": "delta_rerecord", "net": profile.name,
                 "time_s": d["time_s"], "recording_round_trips": 0,
                 "record_calls": 0, "bytes_received": d["bytes_received"],
                 "publish_wire_bytes": delta["wire_bytes"],
                 "full_publish_wire_bytes": full["wire_bytes"],
                 "chunks_reused": delta["chunks_reused"]})
    return rows


def _registry_flags(rows):
    """``BENCH_registry.json``'s acceptance flags over one link's rows."""
    by = {r["scenario"]: r for r in rows}
    cold, warm, delta = (by[k] for k in ("cold_record", "warm_hit",
                                         "delta_rerecord"))
    return {"warm_zero_recording_rts": warm["recording_round_trips"] == 0,
            "warm_reduction_ge_80pct": warm["time_s"] <= 0.2 * cold["time_s"],
            "delta_wire_lt_full": delta["publish_wire_bytes"]
            < delta["full_publish_wire_bytes"]}


def _tee_boot_refused(label, root, cfg, shapes, params, err):
    """A fresh TEE workspace over the registry at ``root`` refuses to boot
    with ``err`` before ``torch.export.load`` is reached."""
    from repro_torch.api import Workspace
    tee = Workspace(registry=root, key=REPLAY_KEY, net="wifi",
                    device="cuda")
    with _export_loads_counted() as loads:
        try:
            tee.workload(cfg, **shapes).engine(params=params)
        except err as e:
            log(f"registry: {label}: refused, {type(e).__name__}: {e}")
        else:
            raise AssertionError(f"registry: {label}: the TEE booted")
    assert loads[0] == 0, (label, loads)


def _run_examples(names):
    """Run ``repro_torch.examples.<name>`` for each name on the card, as
    subprocesses started together; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}"], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in names}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            tail = "\n".join(out.strip().splitlines()[-4:])
            log(f"registry: example {name}: exit {proc.returncode} "
                f"{time.perf_counter() - t0:.1f} s after the start\n{tail}")
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_registry(state):
    """record -> publish -> fetch -> verify -> replay at full width and
    ``REPLAY_LAYERS`` layers: phase ``replay``'s qwen2.5-3b recordings (recorded here when that phase did
    not run) published through a cloud ``Workspace`` into a file-backed
    registry, a fresh TEE ``Workspace`` booting ``wl.engine()`` from it
    over emulated wifi (chunked fetch, HMAC and inclusion proof verified,
    preload, warm; both programs captured as CUDA graphs) and serving
    phase ``replay``'s 8 prompts with its live tokens and host syncs and
    launches equal to the formulas; a tampered chunk and a validly
    signed swap refused with 0 loads; attested quotes verified offline,
    a perturbed one rejected; ``BENCH_registry.json``'s three scenarios
    on cody-mnist (published config) over wifi and cellular with their
    flags; the three ported examples run on the card."""
    import tempfile
    import torch
    from repro_torch.api import Workspace
    from repro_torch.attest import KeySchedule, verify_quote
    from repro_torch.configs import get_config
    from repro_torch.core.attest import (QuoteVerificationError,
                                         SplitViewError,
                                         TamperedRecordingError)
    from repro_torch.core.channel import LiveChannel
    from repro_torch.core.netem import CELLULAR, WIFI
    from repro_torch.core.replay import Replayer
    from repro_torch.launch.record import record_kinds
    from repro_torch.launch.serve import stream_kwargs
    from repro_torch.models import model as M
    from repro_torch.registry import RegistryClient, recording_to_parts
    from repro_torch.serving.engine import Engine
    from repro_torch.training import steps as ST

    cfg, params = _replay_model(state)
    L, block_k, seq, max_new = cfg.num_layers, 8, 128, 32
    shapes = dict(cache_len=1024, block_k=block_k, batch=4, prefill_batch=1,
                  seq=seq)
    log(f"registry: {cfg.name} at full width, {L} layers, on {_card(state)}")
    prompts = _replay_prompts(cfg, seq)
    recs = state.get("replay_recs")
    if recs is None:
        with tempfile.TemporaryDirectory() as d:
            made = record_kinds(cfg, out=d, key=REPLAY_KEY, cache_len=1024,
                                block_k=block_k, batch=4, seq=seq,
                                params=params, device="cuda", net="wifi",
                                passes="all")
        recs = {k: rec for k, (_p, rec) in made.items()}
    live = state.get("replay_live")
    if live is None:
        live = _replay_serve("live", Engine(params, channel=LiveChannel(
            ST.make_prefill_step(cfg, 1024),
            ST.make_fused_decode_step(cfg, k=block_k)), **stream_kwargs(
                cfg, n_slots=4, cache_len=1024, block_k=block_k, eos_id=2,
                device="cuda")), prompts, max_new)

    with tempfile.TemporaryDirectory() as root:
        # cloud role: publish the signed recordings
        cloud = Workspace(registry=root, key=REPLAY_KEY, net="wifi",
                          device="cuda")
        cwl = cloud.workload(cfg, **shapes)
        for kind in ("prefill", "decode"):
            t0 = time.perf_counter()
            pub = cwl.publish(recs[kind])
            assert pub["key"] == cwl.key(kind), (pub["key"], cwl.key(kind))
            log(f"registry: published {kind} as {pub['key']} "
                f"v{pub['version']}: {pub['full_bytes'] / 1e6:.3f} MB in "
                f"{pub['chunks_new']} chunks, {pub['wire_bytes'] / 1e6:.3f} "
                f"MB delta wire, log index {pub['log_index']}; host "
                f"{time.perf_counter() - t0:.2f} s")

        # TEE role: a fresh workspace with the same key boots from it
        tee = Workspace(registry=root, key=REPLAY_KEY, net="wifi",
                        device="cuda")
        twl = tee.workload(cfg, **shapes)
        pre, dec = twl.key("prefill"), twl.key("decode")
        walls = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _export_loads_counted() as loads, \
                _wall_of(RegistryClient, "fetch", walls), \
                _wall_of(Replayer, "load", walls), \
                _wall_of(Replayer, "warm", walls):
            eng = twl.engine(params=params)
        boot = time.perf_counter() - t0
        assert loads[0] == 2, loads
        rp = eng.channel.replayer
        net, cs = tee.netem.snapshot(), dict(tee.client.stats)
        assert cs["verified_fetches"] == cs["proofs_verified"] == 2, cs
        log(f"registry: TEE boot {boot:.2f} s: fetched "
            f"{net['bytes_received'] / 1e6:.3f} MB, {net['round_trips']} "
            f"blocking RTs, {net['time_s']:.6f} s on the emulated wifi link "
            f"(link model output, not measured); host: fetch (chunks read, "
            f"HMAC and proofs verified) {sum(walls['fetch']):.2f} s, "
            f"verify + load {sum(walls['load']):.2f} s, warm "
            f"{sum(walls['warm']):.2f} s; client {cs}")
        # the warmed programs are captured at their first execute: do it
        # here, on the engine's params, so the serve replays graphs only
        zeros = torch.zeros(4, dtype=torch.int32, device="cuda")
        caches = M.init_cache(cfg, 4, 1024, device="cuda")
        tokens = {"tokens": torch.zeros((1, seq), dtype=torch.int32,
                                        device="cuda")}
        t0 = time.perf_counter()
        rp.execute(pre, eng.params, tokens)
        rp.execute(dec, eng.params, zeros, zeros.clone(), caches)
        torch.cuda.synchronize()
        t_cap = time.perf_counter() - t0
        del caches
        per = {pre: rp.captured_launches(pre), dec: rp.captured_launches(dec)}
        captured = rp.stats["captures"] == 2
        log(f"registry: warm + capture {sum(walls['warm']) + t_cap:.2f} s "
            f"(capture and first replay of both {t_cap:.2f} s); prefill "
            f"captured: {captured}; one replay launches {per}")
        assert captured, rp.stats
        assert per == {pre: {"flash_attention": L, "rmsnorm": 2 * L + 1},
                       dec: {"decode_attention": L * block_k,
                             "rmsnorm": (2 * L + 1) * block_k}}, per
        outs, st, launches, replays = _replay_serve(
            "registry graph", eng, prompts, max_new, rp)
        assert outs == live[0], "registry: tokens differ from live"
        assert st["host_syncs"] == live[1]["host_syncs"], (st, live[1])
        pd, bd = st["prefill_dispatches"], st["blocks_dispatched"]
        assert replays == pd + bd and rp.stats["captures"] == 2, \
            (replays, pd, bd, rp.stats)
        for name, n in ((pre, pd), (dec, bd)):
            for k, c in per[name].items():
                launches[k] += c * n
        want = {"flash_attention": L * pd,
                "decode_attention": L * block_k * bd,
                "rmsnorm": (2 * L + 1) * (pd + block_k * bd), "moe_gmm": 0,
                "mamba_chunk_scan": 0, "mlstm_chunk_scan": 0}
        assert launches == want, (launches, want)
        log(f"registry: served from the registry with live's tokens and "
            f"{st['host_syncs']} host syncs; launches {launches} (the "
            f"formulas; {pd} prefill and {bd} decode graph replays)")

        # attacks: a tampered chunk, a validly signed swap (split view)
        dkey = cwl.key("decode")
        c = next(c for c in cloud.store.entry(dkey)["chunks"]
                 if c["part"].startswith("payload/"))
        path = Path(root, "chunks", c["d"][:2], c["d"])
        good = path.read_bytes()
        path.write_bytes(good[:len(good) // 2] +
                         bytes([good[len(good) // 2] ^ 0x5A]) +
                         good[len(good) // 2 + 1:])
        try:
            _tee_boot_refused("tampered chunk", root, cfg, shapes, params,
                              TamperedRecordingError)
        finally:
            path.write_bytes(good)
        meta, parts = cloud.store.entry(dkey)["meta"], cloud.store.get(dkey)
        cloud.store.put(dkey, recording_to_parts(
            recs["prefill"], cloud.store.chunk_size), meta=meta)
        try:
            _tee_boot_refused("validly signed swap (split view)", root, cfg,
                              shapes, params, SplitViewError)
        finally:
            cloud.store.put(dkey, parts, meta=meta)

        # attestation: quotes verified offline, a perturbed one rejected
        offline = KeySchedule(REPLAY_KEY)
        rep, quote, bundle = twl.attested_replay("decode")
        rq = rp.quote(tee.keys, dec, head=bundle["head"])
        for label, q in (("attested_replay", quote), ("Replayer", rq)):
            v = verify_quote(q, head=bundle["head"], keys=offline,
                             leaf=bundle["leaf"], proof=bundle["path"],
                             leaf_index=bundle["index"])
            assert v["ok"] and v["inclusion_checked"], v
            bad = dict(q, exec_fingerprint=q["exec_fingerprint"][::-1])
            try:
                verify_quote(bad, head=bundle["head"], keys=offline)
            except QuoteVerificationError:
                pass
            else:
                raise AssertionError(f"registry: perturbed {label} quote "
                                     "verified")
            log(f"registry: {label} quote verified offline (inclusion "
                f"checked, log size {v['log_size']}); the perturbed quote "
                f"rejected")
        log(f"registry: attested plan replay {rep['dispatches']} "
            f"dispatches, {rep['virtual_time_s']} emulated s (link model "
            f"output)")
        del eng, rp

    # BENCH_registry.json's scenarios on cody-mnist at its published config
    mcfg = get_config("cody-mnist")
    mws = Workspace(key=REGISTRY_BENCH_KEY, net="wifi", device="cuda")
    mwl = mws.workload(mcfg, **REGISTRY_SHAPES)
    rec = mwl.record("prefill").sign_with(REGISTRY_BENCH_KEY)
    ref = {r["scenario"]: r for r in json.loads(
        (ROOT / "BENCH_registry.json").read_text())["rows"]}
    log(f"registry: cody-mnist prefill recorded: record_wall_s "
        f"{rec.manifest['record_wall_s']:.3f} (measured), record_virtual_s "
        f"{rec.manifest['record_virtual_s']} (link model output)")
    for profile in (WIFI, CELLULAR):
        rows = _registry_scenarios(profile, mwl.key("prefill"), rec,
                                   REGISTRY_BENCH_KEY)
        for r in rows:
            note = (f"; reference (wifi, smoke artifact) {ref[r['scenario']]}"
                    if profile is WIFI else "")
            log(f"registry: scenario {r} (emulated){note}")
        flags = _registry_flags(rows)
        log(f"registry: {profile.name} flags {flags}")
        assert all(flags.values()), (profile.name, flags, rows)

    _run_examples(("quickstart", "secure_inference",
                   "serve_continuous_batching"))
    log(f"registry: all figures of this phase on {_card(state)}")


# BENCH_fleet.json's scenario (the reference's benchmarks/fleet_bench.py,
# quick): smoke tenants, shapes, policies, replicas, regions, traffic
FLEET_BENCH_ARCHS = ("qwen2.5-3b", "xlstm-350m")
FLEET_BENCH_SHAPES = dict(cache_len=64, block_k=4, batch=2, seq=8)
FLEET_BENCH_POLICIES = ("round_robin", "least_loaded", "cache_affinity")
# BENCH_fanout.json's campaign (benchmarks/fanout_bench.py, quick)
FANOUT_JOBS = 24
FANOUT_SHAPES = dict(cache_len=64, block_k=4, batch=1, prefill_batch=1)
FANOUT_SEQS = (8, 16, 24, 32)
FANOUT_LADDER = (1, 2, 4, 8)


def _fleet_registry(state, cfg, params, shapes):
    """Part 1: a 2-replica qwen2.5-3b fleet at full width (``REPLAY_LAYERS``
    layers) booted from a file-backed registry over two regional
    read-replicas, serving open-loop traffic with live's tokens and launches equal to the
    formulas."""
    import tempfile
    import torch
    from repro_torch import kernels as K
    from repro_torch.api import Workspace
    from repro_torch.core.channel import LiveChannel
    from repro_torch.core.replay import Replayer
    from repro_torch.fleet import OpenLoopTraffic, TenantMix
    from repro_torch.launch.record import record_kinds
    from repro_torch.launch.serve import stream_kwargs
    from repro_torch.models import model as M
    from repro_torch.obs.schema import (check_fleet_stats,
                                        check_workspace_report)
    from repro_torch.registry import RegistryClient
    from repro_torch.serving.engine import Engine
    from repro_torch.training import steps as ST

    L, block_k, seq = cfg.num_layers, shapes["block_k"], shapes["seq"]
    slots, cache_len = shapes["batch"], shapes["cache_len"]
    recs = state.get("replay_recs")
    if recs is None:
        with tempfile.TemporaryDirectory() as d:
            made = record_kinds(cfg, out=d, key=REPLAY_KEY,
                                cache_len=cache_len, block_k=block_k,
                                batch=slots, seq=seq,
                                params=params, device="cuda", net="wifi",
                                passes="all")
        recs = {k: rec for k, (_p, rec) in made.items()}
    arrivals = OpenLoopTraffic(
        [TenantMix(cfg.name, 12.0, prompt_len=seq, max_new=(8, 32),
                   vocab=256)], seed=0, burst_every_s=1.0, burst_len_s=0.25,
        burst_x=4.0).generate(1.5)
    with tempfile.TemporaryDirectory() as root:
        cloud = Workspace(registry=root, key=REPLAY_KEY, net="wifi",
                          device="cuda")
        cwl = cloud.workload(cfg, **shapes)
        for kind in ("prefill", "decode"):
            assert cwl.publish(recs[kind])["key"] == cwl.key(kind)
        ws = Workspace(registry=root, key=REPLAY_KEY, net="wifi",
                       device="cuda")
        wl = ws.workload(cfg, **shapes)
        wl._params[0] = params        # the replicas share these weights
        pre, dec = wl.key("prefill"), wl.key("decode")
        clients, new_client = [], ws.new_client

        def spy(*a, **k):
            clients.append(new_client(*a, **k))
            return clients[-1]
        ws.new_client = spy
        walls = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _export_loads_counted() as loads, \
                _wall_of(RegistryClient, "fetch", walls), \
                _wall_of(Replayer, "load", walls), \
                _wall_of(Replayer, "warm", walls):
            pool, _ = ws.fleet([wl], replicas=2, regions=2,
                               policy="least_loaded", tick_s=0.02)
        del ws.new_client
        boot = time.perf_counter() - t0
        assert loads[0] == 4, loads
        assert len(clients) == 2 and clients[0] is not clients[1]
        assert ws.report()["registry_client"] == {}   # shared: never made
        # capture both programs on each replica's params before serving
        for i, r in enumerate(pool.replicas):
            ex = r.scheduler.streams[cfg.name]
            rp = ex.channel.replayer
            zeros = torch.zeros(slots, dtype=torch.int32, device="cuda")
            caches = M.init_cache(cfg, slots, cache_len, device="cuda")
            tokens = {"tokens": torch.zeros((1, seq), dtype=torch.int32,
                                            device="cuda")}
            t1 = time.perf_counter()
            rp.execute(pre, ex.params, tokens)
            rp.execute(dec, ex.params, zeros, zeros.clone(), caches)
            torch.cuda.synchronize()
            t_cap = time.perf_counter() - t1
            del caches
            cs, net = dict(clients[i].stats), r.netem.snapshot()
            assert cs["registry_hits"] == cs["verified_fetches"] == \
                cs["proofs_verified"] == 2, cs
            assert cs.get("recording_round_trips", 0) == 0, cs
            assert net["time_s"] == r.boot_virtual_s > 0, (net, r)
            assert rp.stats["captures"] == 2, rp.stats
            log(f"fleet: replica {r.name} (region r{r.region}) boot host: "
                f"fetch (chunks, HMAC, proofs) "
                f"{sum(walls['fetch'][2 * i:2 * i + 2]):.2f} s, verify + "
                f"load {sum(walls['load'][2 * i:2 * i + 2]):.2f} s, warm + "
                f"capture {sum(walls['warm'][2 * i:2 * i + 2]) + t_cap:.2f} "
                f"s; boot_virtual_s {r.boot_virtual_s} (link model output: "
                f"{net['bytes_received'] / 1e6:.3f} MB over emulated wifi); "
                f"client {cs}")
        log(f"fleet: 2 replicas booted in {boot:.2f} s of host time; "
            f"{len(arrivals)} open-loop arrivals over 1.5 s of the virtual "
            f"clock")
        per = {n: pool.replicas[0].scheduler.streams[cfg.name].channel
               .replayer.captured_launches(n) for n in (pre, dec)}
        assert per == {pre: {"flash_attention": L, "rmsnorm": 2 * L + 1},
                       dec: {"decode_attention": L * block_k,
                             "rmsnorm": (2 * L + 1) * block_k}}, per
        replays0 = [r.scheduler.streams[cfg.name].channel.replayer.stats[
            "graph_replays"] for r in pool.replicas]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        outs = pool.run(arrivals)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = K.launch_counts()
        stats = check_fleet_stats(pool.stats())
        ntok = sum(len(v) for v in outs.values())
        assert len(outs) == len(arrivals) and not pool.failed, stats
        assert all(r.served > 0 for r in pool.replicas), stats
        pd = bd = 0
        for r, r0 in zip(pool.replicas, replays0):
            st = r.scheduler.streams[cfg.name].stats
            rp = r.scheduler.streams[cfg.name].channel.replayer
            assert rp.stats["graph_replays"] - r0 == \
                st["prefill_dispatches"] + st["blocks_dispatched"], \
                (rp.stats, dict(st))
            assert rp.stats["captures"] == 2, rp.stats
            pd += st["prefill_dispatches"]
            bd += st["blocks_dispatched"]
        for name, n in ((pre, pd), (dec, bd)):
            for k, c in per[name].items():
                launches[k] += c * n
        want = {"flash_attention": L * pd,
                "decode_attention": L * block_k * bd,
                "rmsnorm": (2 * L + 1) * (pd + block_k * bd), "moe_gmm": 0,
                "mamba_chunk_scan": 0, "mlstm_chunk_scan": 0}
        assert launches == want, (launches, want)
        q = ws.metrics.quantiles("fleet_request_latency_s",
                                 pool=pool.name, tenant=cfg.name)
        log(f"fleet: served {len(outs)} of {len(arrivals)} arrivals, {ntok} "
            f"tokens in {dt:.3f} s on the card ({ntok / dt:.1f} tok/s), "
            f"{stats['ticks']} ticks; per replica served "
            f"{[r.served for r in pool.replicas]}; latency quantiles "
            f"{q} (the fleet's virtual clock, not a measured time); peak "
            f"memory allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB; launches {launches} (the formulas; {pd} prefill and {bd} "
            f"decode graph replays)")
        check_workspace_report(ws.report())
        log(f"fleet: pool {json.dumps(stats)}")

        # every request served alone through the live path, same params
        live = Engine(params, channel=LiveChannel(
            ST.make_prefill_step(cfg, cache_len),
            ST.make_fused_decode_step(cfg, k=block_k)), **stream_kwargs(
                cfg, n_slots=slots, cache_len=cache_len, block_k=block_k,
                eos_id=2, device="cuda"))
        rids = {a.gid: live.submit(list(a.prompt), a.max_new)
                for a in arrivals}
        t0 = time.perf_counter()
        solo = live.run()
        torch.cuda.synchronize()
        log(f"fleet: the same {len(rids)} requests live in "
            f"{time.perf_counter() - t0:.2f} s")
        assert {g: solo[r] for g, r in rids.items()} == outs, \
            "fleet: tokens differ from live"
        log("fleet: every request's tokens equal the live path's")
        del pool, ws, wl, live, clients
    torch.cuda.empty_cache()


def _fleet_multitenant():
    """Part 2: qwen2.5-3b and xlstm-350m at full width through one
    Scheduler (serve --streams' path), against each served alone:
    BENCH_multitenant.json's two flags; launches equal the formulas."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch.serve import serve_multi

    block_k, max_new, requests = 8, 16, 4
    K.reset_launches()
    torch.cuda.synchronize()
    outs, sched, wls, dt = serve_multi(
        ["qwen2.5-3b", "xlstm-350m"], requests=requests, max_new=max_new,
        prompt_lens=(16, 65), n_slots=4, cache_len=128, block_k=block_k,
        device="cuda")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    want = dict.fromkeys(launches, 0)
    rows = {}
    for i, (name, wl) in enumerate(wls.items()):
        cfg, ex = wl.cfg, sched.streams[name]
        L = cfg.num_layers
        pd, bd = ex.stats["prefill_dispatches"], ex.stats["blocks_dispatched"]
        want["rmsnorm"] += (2 * L + 1) * (pd + block_k * bd)
        if cfg.family == "ssm":
            want["mlstm_chunk_scan"] += (L - len(cfg.xlstm.slstm_at)) * pd
        else:
            want["flash_attention"] += L * pd
            want["decode_attention"] += L * block_k * bd
        eng = wl.engine(seed=i)
        rids = {rid: eng.submit(req.prompt, req.max_new)
                for rid, req in ex.requests.items()}
        t0 = time.perf_counter()
        solo = eng.run()
        torch.cuda.synchronize()
        solo_dt = time.perf_counter() - t0
        solo = {rid: solo[r] for rid, r in rids.items()}
        toks = sum(len(v) for v in outs[name].values())
        rows[name] = {
            "bit_exact_vs_solo": solo == outs[name],
            "syncs_per_token": (
                ex.stats["host_syncs"] / toks, eng.stats["host_syncs"]
                / sum(len(v) for v in solo.values()))}
        log(f"fleet: multi-tenant {name}: {len(ex.requests)} requests of "
            f"{sorted(len(r.prompt) for r in ex.requests.values())} tokens, "
            f"{toks} served; stats {dict(ex.stats)}; alone {solo_dt:.2f} s, "
            f"{dict(eng.stats)}")
    flags = {"bit_exact_vs_solo": all(r["bit_exact_vs_solo"]
                                      for r in rows.values()),
             "frontier_only_syncs": all(
                 m <= s for m, s in (r["syncs_per_token"]
                                     for r in rows.values()))}
    ntok = sum(len(v) for per in outs.values() for v in per.values())
    log(f"fleet: multi-tenant serve {ntok} tokens in {dt:.3f} s "
        f"({ntok / dt:.1f} tok/s); frontier {dict(sched.frontier.stats)}; "
        f"launches {launches}; flags {flags}")
    assert all(flags.values()), (flags, rows)
    assert launches == want, (launches, want)
    del outs, sched, wls
    torch.cuda.empty_cache()


def _digest(outputs):
    import hashlib
    blob = json.dumps({str(g): list(t) for g, t in sorted(outputs.items())},
                      sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def fleet_bench_scenario(device="cuda", seed=0):
    """BENCH_fleet.json's scenario through the port's ``Workspace``: a
    cold replica that records on miss, then one warm 3-replica fleet per
    placement policy over 2 regions on the same arrivals, and every
    arrival served alone; returns the bench's result dict (the
    reference's keys and flags)."""
    from repro_torch.api import Workspace
    from repro_torch.fleet import OpenLoopTraffic, TenantMix

    horizon_s, tick_s, n_slots = 1.5, 0.02, FLEET_BENCH_SHAPES["batch"]
    t_wall = time.time()
    ws = Workspace(registry=":memory:", key=b"fleet-bench", net="wifi",
                   device=device)
    wls = [ws.workload(a, **FLEET_BENCH_SHAPES) for a in FLEET_BENCH_ARCHS]
    tenants = [wl.cfg.name for wl in wls]
    traffic = OpenLoopTraffic(
        [TenantMix(wl.cfg.name, rate, prompt_len=FLEET_BENCH_SHAPES["seq"],
                   max_new=(4, 12), vocab=min(wl.cfg.vocab_size, 256))
         for wl, rate in zip(wls, (10.0, 6.0))], seed=seed,
        burst_every_s=1.0, burst_len_s=0.25, burst_x=4.0)
    arrivals = traffic.generate(horizon_s)
    cold, _ = ws.fleet(wls, replicas=1, policy="round_robin",
                       record_on_miss=True, name="cold", tick_s=tick_s,
                       seed=seed)
    cold_boot_s = cold.replicas[0].boot_virtual_s
    rows, digests, warm_boots = [], {}, []
    for policy in FLEET_BENCH_POLICIES:
        pool, _ = ws.fleet(wls, replicas=3, policy=policy, regions=2,
                           name=policy, tick_s=tick_s,
                           pending_limit=2 * n_slots, queue_limit=512,
                           seed=seed)
        warm_boots.extend(r.boot_virtual_s for r in pool.replicas)
        t0 = time.time()
        outputs = pool.run(list(arrivals))
        wall = time.time() - t0
        digests[policy] = _digest(outputs)
        per_tenant = {t: {
            "served": sum(1 for a in arrivals
                          if a.tenant == t and a.gid in outputs),
            "latency_quantiles": ws.metrics.quantiles(
                "fleet_request_latency_s", pool=policy, tenant=t)
            or {"p50": 0.0, "p99": 0.0, "p999": 0.0}} for t in tenants}
        rows.append({"policy": policy, "per_tenant": per_tenant,
                     "pool": pool.stats(), "outputs_digest": digests[policy],
                     "wall_s": round(wall, 3)})
        del pool
    solo = {}
    for i, wl in enumerate(wls):
        eng = wl.engine(seed=seed + i)
        for a in arrivals:
            if a.tenant == wl.cfg.name:
                rid = eng.submit(list(a.prompt), a.max_new)
                solo[a.gid] = list(eng.run()[rid])
    solo_digest = _digest(solo)
    warm_boot_s = max(warm_boots)
    reduction = 100.0 * (1.0 - warm_boot_s / cold_boot_s) \
        if cold_boot_s > 0 else 0.0
    return {
        "tenants": tenants,
        "shapes": {"cache_len": FLEET_BENCH_SHAPES["cache_len"],
                   "block_k": FLEET_BENCH_SHAPES["block_k"],
                   "n_slots": n_slots, "seq": FLEET_BENCH_SHAPES["seq"]},
        "traffic": {"seed": seed, "horizon_s": horizon_s,
                    "burst_every_s": 1.0, "burst_len_s": 0.25,
                    "burst_x": 4.0, "arrivals": len(arrivals),
                    "rates_rps": [m.rate_rps for m in traffic.mixes]},
        "policies": rows,
        "solo_digest": solo_digest,
        "registry_boot": {
            "cold_boot_virtual_s": round(cold_boot_s, 4),
            "warm_boot_virtual_s": round(warm_boot_s, 4),
            "reduction_pct": round(reduction, 2)},
        "bit_exact_vs_solo": all(d == solo_digest for d in digests.values()),
        "warm_boot_cheaper_than_cold": warm_boot_s < cold_boot_s,
        "warm_boot_reduction_ge_80pct": reduction >= 80.0,
        "wall_s": round(time.time() - t_wall, 1),
    }


def fleet_bench_deterministic(result):
    """What BENCH_fleet.json fixes through the traffic and the tick
    clock alone: arrivals, and per policy the served counts, ticks and
    the balancer's counts."""
    return {"arrivals": result["traffic"]["arrivals"], "policies": {
        row["policy"]: {
            "served": {t: v["served"] for t, v in row["per_tenant"].items()},
            "ticks": row["pool"]["ticks"],
            "balancer": row["pool"]["balancer"],
            "replicas_served": [r["served"] for r in row["pool"]["replicas"]]}
        for row in result["policies"]}}


def fanout_bench_campaign(device="cuda"):
    """BENCH_fanout.json's campaign through ``launch/fanout.py``'s code
    path (``run_campaign``): cody-mnist's 5 variants at 24 jobs over
    wifi, serially with a cold speculator, then over 1, 2, 4 and 8
    devices with the shared history, every rung on the same exports;
    returns the bench's summary (its keys and flags)."""
    from repro_torch.launch.fanout import run_campaign

    artifacts = {}
    kw = dict(nets=("wifi",), seqs=FANOUT_SEQS, kinds=("prefill", "decode"),
              key=b"fanout-bench-key", jobs=FANOUT_JOBS, smoke=True,
              device=device, artifacts=artifacts, **FANOUT_SHAPES)
    serial = run_campaign("cody-mnist", devices=1, share_history=False,
                          name="fanout-d1-cold", **kw)
    s_stats = serial.stats()
    serial_s = s_stats["sum_record_virtual_s"]

    def strip_cost(m):
        return {k: v for k, v in m.items()
                if k not in ("record_virtual_s", "record_session")}
    ladder, bit_exact = [], True
    for devices in FANOUT_LADDER:
        c = run_campaign("cody-mnist", devices=devices, share_history=True,
                         name=f"fanout-d{devices}", **kw)
        for key, rec in c.recordings.items():
            base = serial.recordings[key]
            bit_exact &= (rec.payload == base.payload
                          and rec.trees == base.trees
                          and strip_cost(rec.manifest)
                          == strip_cost(base.manifest))
        st = c.stats()
        ladder.append({"devices": devices,
                       "virtual_time_s": st["virtual_time_s"],
                       "recorded": st["recorded"],
                       "publishes": st["publishes"],
                       "spec_hit_rate": st["speculation"]["hit_rate"],
                       "blocking_rts": sum(d["blocking_round_trips"]
                                           for d in st["per_device"]),
                       "campaign": st})
    times = [r["virtual_time_s"] for r in ladder]
    by_dev = {r["devices"]: r for r in ladder}
    reduction4 = 1.0 - by_dev[4]["virtual_time_s"] / serial_s
    cold_hit = s_stats["speculation"]["hit_rate"]
    shared_hit = by_dev[4]["spec_hit_rate"]
    return {
        "net": "wifi", "variants": len(FANOUT_SEQS) + 1, "jobs": FANOUT_JOBS,
        "serial": {"sessions": s_stats["recorded"],
                   "virtual_time_s": round(serial_s, 6),
                   "blocking_rts": sum(d["blocking_round_trips"]
                                       for d in s_stats["per_device"]),
                   "campaign": s_stats},
        "device_ladder": ladder,
        "reduction_at_4_devices_pct": round(100.0 * reduction4, 2),
        "monotone_virtual_time": all(a > b for a, b in zip(times,
                                                           times[1:])),
        "fanout_reduction_ge_70pct": reduction4 >= 0.70,
        "bit_exact_vs_serial": bit_exact,
        "shared_spec_hit_ge_cold": shared_hit >= cold_hit,
    }


def fanout_bench_deterministic(result):
    """What the pinned job count fixes: per rung (and the serial run)
    the blocking round trips, speculation predicts and hits, ticks and
    the virtual seconds."""
    def fields(c):
        return {"blocking_rts": sum(d["blocking_round_trips"]
                                    for d in c["per_device"]),
                "predicts": c["speculation"]["predicts"],
                "hits": c["speculation"]["hits"], "ticks": c["ticks"],
                "virtual_time_s": c["virtual_time_s"],
                "sum_record_virtual_s": c["sum_record_virtual_s"]}
    return {"serial": fields(result["serial"]["campaign"]),
            "ladder": {r["devices"]: fields(r["campaign"])
                       for r in result["device_ladder"]}}


def phase_fleet(state):
    """Fleet-scale replay serving: (1) a 2-replica qwen2.5-3b fleet at
    full width (``REPLAY_LAYERS`` layers) booted from a file-backed
    registry over 2 regional read-replicas (each replica its own client
    and wifi span: fetch, verify, load, warm, both programs captured),
    serving ~30 open-loop arrivals
    with live's tokens and launches equal to the formulas; (2) qwen2.5-3b
    and xlstm-350m at full width through one Scheduler (serve --streams)
    with BENCH_multitenant.json's flags; (3) BENCH_fleet.json's scenario
    at its shapes, its flags and its deterministic fields; (4)
    BENCH_fanout.json's campaign through launch/fanout.py's code path,
    its flags and the fields its pinned job count fixes."""
    import tempfile
    import torch
    from repro_torch.obs.schema import check_bench_file

    cfg, params = _replay_model(state)
    shapes = dict(cache_len=1024, block_k=8, batch=4, prefill_batch=1,
                  seq=128)
    log(f"fleet: {cfg.name} at full width, {cfg.num_layers} layers, on "
        f"{_card(state)}")
    _fleet_registry(state, cfg, params, shapes)
    _fleet_multitenant()

    t0 = time.perf_counter()
    result = fleet_bench_scenario()
    ref = json.loads((ROOT / "BENCH_fleet.json").read_text())
    with tempfile.TemporaryDirectory() as d:
        path = Path(d, "BENCH_fleet.json")
        path.write_text(json.dumps(result, indent=2))
        log(f"fleet: BENCH_fleet scenario: {check_bench_file(str(path))}")
    got, want = (fleet_bench_deterministic(r) for r in (result, ref))
    flags = {k: result[k] for k in ("bit_exact_vs_solo",
                                    "warm_boot_cheaper_than_cold",
                                    "warm_boot_reduction_ge_80pct")}
    for row, rrow in zip(result["policies"], ref["policies"]):
        log(f"fleet: BENCH_fleet {row['policy']}: latency quantiles "
            f"{ {t: v['latency_quantiles'] for t, v in row['per_tenant'].items()} } "
            f"(virtual clock; the file's "
            f"{ {t: v['latency_quantiles'] for t, v in rrow['per_tenant'].items()} }), "
            f"wall {row['wall_s']} s")
    log(f"fleet: BENCH_fleet registry boot {result['registry_boot']} "
        f"(link model output; the file's {ref['registry_boot']}); flags "
        f"{flags}; deterministic fields {got}; in "
        f"{time.perf_counter() - t0:.1f} s")
    assert all(flags.values()), flags
    assert got == want, (got, want)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    result = fanout_bench_campaign()
    ref = json.loads((ROOT / "BENCH_fanout.json").read_text())
    flags = {k: result[k] for k in ("monotone_virtual_time",
                                    "fanout_reduction_ge_70pct",
                                    "bit_exact_vs_serial",
                                    "shared_spec_hit_ge_cold")}
    got, want = (fanout_bench_deterministic(r) for r in (result, ref))
    log(f"fleet: BENCH_fanout campaign: flags {flags}; reduction at 4 "
        f"devices {result['reduction_at_4_devices_pct']}% (emulated); "
        f"fields {got}; in {time.perf_counter() - t0:.1f} s")
    assert all(flags.values()), flags
    assert got == want, (got, want)
    log(f"fleet: all figures of this phase on {_card(state)}")


SESSION_KEY = b"chip-smoke-session-key"
# the reference bench's shapes (benchmarks/recording_ablation_bench.py)
SESSION_SHAPES = dict(cache_len=64, block_k=4, batch=1, seq=16)
SESSION_JOBS = 32
SESSION_STACKS = (("naive", ()), ("+deferral", ("deferral",)),
                  ("+speculation", ("deferral", "speculation")),
                  ("+metasync", ("deferral", "speculation", "metasync")))
REPLAY_STACKS = (("naive", ()), ("+dead-elim", ("dead",)),
                 ("+poll-collapse", ("dead", "poll")),
                 ("+coalesce", ("dead", "poll", "coalesce")))


def _bench_rows(name, *path):
    """The rows of the reference's BENCH file ``name`` by stack (read
    only: the gates the port's session must meet)."""
    rows = json.loads((ROOT / name).read_text())
    for key in path:
        rows = rows[key]
    return {r["stack"]: r for r in rows if r.get("net", "wifi") == "wifi"}


def phase_session(state):
    """The CODY recording session on the card: cody-mnist's prefill
    (published config) exported once, the record-side ablation (naive,
    +deferral, +speculation, +metasync on wifi and cellular at 32 jobs)
    over copies of that artifact, the replay-side ablation (plan
    compaction over wifi), and the session-made recording verified and
    replayed on the card, bit-identical to live execution."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.api.workload import (build_step, format_session_report,
                                          static_meta_for)
    from repro_torch.configs import get_config
    from repro_torch.core.netem import CELLULAR, WIFI, NetworkEmulator
    from repro_torch.core.recorder import compile_artifact
    from repro_torch.core.recording import Recording
    from repro_torch.core.replay import Replayer
    from repro_torch.core.replay_passes import PlanExecutor, plan_for
    from repro_torch.models import layers as Lyr
    from repro_torch.models import model as M
    from repro_torch.record import (REPLAY_CONSUMED_SITES, CloudDryrun,
                                    RecordingSession)

    def copy_of(rec):
        return Recording(dict(rec.manifest), rec.payload, rec.trees)

    cfg = get_config("cody-mnist")
    L = cfg.num_layers
    log(f"session: {cfg.name} at full width ({cfg.d_model} wide, {L} "
        f"layers, {cfg.dtype}), prefill at {SESSION_SHAPES}, "
        f"{SESSION_JOBS} jobs, on {_card(state)}")
    params = M.init_params(cfg, seed=0, device="cuda")
    tree = Lyr.to_tree(params)
    fn, args, donate = build_step(cfg, "prefill", params=tree,
                                  device="cuda", **SESSION_SHAPES)
    t0 = time.perf_counter()
    base = compile_artifact(f"{cfg.name}_prefill", fn, args,
                            donate_argnums=donate,
                            config_fingerprint=cfg.fingerprint(),
                            static_meta=static_meta_for("prefill",
                                                        **SESSION_SHAPES))
    log(f"session: exported once in {time.perf_counter() - t0:.2f} s, "
        f"payload {len(base.payload)} bytes, memory {base.manifest['memory']}")
    local = RecordingSession.local(cloud=CloudDryrun(jobs=SESSION_JOBS)) \
        .finalize(copy_of(base))
    assert local.manifest["record_virtual_s"] == 0.0, local.manifest

    # record side: the four stacks on two links over one artifact
    rows = _bench_rows("BENCH_recording.json", "rows")
    signed = None
    for profile in (WIFI, CELLULAR):
        times = []
        for label, passes in SESSION_STACKS:
            s = RecordingSession.for_profile(
                profile, passes=passes, cloud=CloudDryrun(jobs=SESSION_JOBS))
            t0 = time.perf_counter()
            rec = s.finalize(copy_of(base))
            host_s = time.perf_counter() - t0
            rep = rec.manifest["record_session"]
            spec = rep["per_pass"].get("speculation", {})
            want = rows[label]
            got = (rep["blocking_round_trips"], rep["async_round_trips"],
                   int(spec.get("spec_commits", 0)),
                   int(spec.get("mispredicts", 0)), rep["jobs"])
            assert got == (want["blocking_rts"], want["async_rts"],
                           want["spec_commits"], want["mispredicts"],
                           want["jobs"]), (profile.name, label, got, want)
            assert rec.payload == local.payload and rec.trees == local.trees
            assert rec.manifest["exec_fingerprint"] == \
                local.manifest["exec_fingerprint"]
            blob = copy_of(rec).sign_with(SESSION_KEY).to_bytes()
            Recording.from_bytes(blob, SESSION_KEY)     # verifies
            if profile is WIFI and label == "+metasync":
                signed = blob
            times.append(rep["virtual_time_s"])
            mb = (rep["bytes_sent"] + rep["bytes_received"]) / 1e6
            ref = (f"; reference (wifi, smoke) {want['wire_MB']} MB, "
                   f"{want['virtual_time_s']} s" if profile is WIFI else "")
            log(f"session: record {profile.name:8s} {label:13s} "
                f"{got[0]:3d} blocking / {got[1]:3d} async RTs, "
                f"{got[2]} spec commits, {got[3]} mispredicts; emulated "
                f"{mb:.3f} MB, {rep['virtual_time_s']} s{ref}; host "
                f"{host_s:.3f} s")
        assert all(a > b for a, b in zip(times, times[1:])), times
        cut = 1 - times[-1] / times[0]
        assert cut >= 0.90, (profile.name, times)
        log(f"session: record {profile.name}: emulated virtual time "
            f"{times} s, all passes {100 * cut:.2f}% below naive")
    log("session: " + format_session_report(
        Recording.from_bytes(signed, SESSION_KEY).manifest["record_session"]))

    # replay side: the compacted plans, priced over wifi
    rows = _bench_rows("BENCH_replay.json", "ablation", "rows")
    witness = None
    for label, passes in REPLAY_STACKS:
        ex = PlanExecutor(netem=NetworkEmulator(WIFI))
        rep = ex.run(plan_for(local, passes, jobs=SESSION_JOBS))
        want = rows[label]
        got = (rep["blocking_round_trips"], rep["dispatches"],
               rep["collapsed_spins"])
        assert got == (want["blocking_rts"], want["dispatches"],
                       want["collapsed_spins"]), (label, got, want)
        w = (ex.write_log(), ex.consumed_log(REPLAY_CONSUMED_SITES))
        witness = witness or w
        assert w == witness, label
        log(f"session: replay plan {label:15s} {got[0]:3d} blocking RTs, "
            f"{got[1]:3d} dispatches, {got[2]:2d} collapsed spins; "
            f"emulated {rep['virtual_time_s']} s (reference "
            f"{want['plan_virtual_s']} s)")

    # the session-made recording, verified and replayed on the card
    rp = Replayer(key=SESSION_KEY, device="cuda")
    name = rp.load(signed)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (1, 16),
                                     dtype=torch.int32, device="cuda")}
    torch.cuda.synchronize()
    K.reset_launches()
    got = rp.execute(name, tree, batch)
    torch.cuda.synchronize()
    replayed = K.launch_counts()
    K.reset_launches()
    want = fn(tree, batch)
    torch.cuda.synchronize()
    live = K.launch_counts()
    flat, spec = torch.utils._pytree.tree_flatten(got)
    wflat, wspec = torch.utils._pytree.tree_flatten(want)
    assert spec == wspec, (spec, wspec)
    for a, b in zip(flat, wflat):
        assert a.dtype == b.dtype and a.shape == b.shape and \
            torch.equal(a, b), "session: replay differs from live"
    formula = {"rmsnorm": 2 * L + 1, "flash_attention": L}
    for counts in (replayed, live):
        assert {k: counts[k] for k in formula} == formula, (counts, formula)
    log(f"session: the wifi all-passes recording verified and replayed on "
        f"the card: {len(flat)} outputs bit-identical to live; launches "
        f"{ {k: replayed[k] for k in formula} } (2 L + 1 and L)")


FAMILY_KEY = b"chip-smoke-families-key"
# the families' depth at full width in bf16 (whisper: as many encoder
# layers): recording and loading the prefill and the step-by-step decode
# loop take host time in proportion to it
FAMILY_LAYERS = 4
# the families' serving shapes: batch rows, prompt lengths (decoder
# tokens; phi-3-vision's follow its 576 image rows), cache, block, tokens
FAMILY_RUNS = {
    "whisper-large-v3": dict(batch=2, prompts=(16, 48), cache_len=1536,
                             block_k=8, max_new=32),
    "phi-3-vision-4.2b": dict(batch=4, prompts=(128,), cache_len=1024,
                              block_k=8, max_new=32),
}


def _cut_depth(cfg, layers, **kw):
    """``cfg`` cut to ``layers`` layers (an encoder-decoder's encoder
    too), other fields replaced by ``kw``."""
    if cfg.family == "audio":
        kw["encdec"] = dataclasses.replace(cfg.encdec,
                                           num_encoder_layers=layers)
    return dataclasses.replace(cfg, num_layers=layers, **kw)


def _family_extra(cfg, B, rng):
    """The batch's other inputs, numpy fp32 from ``rng``: whisper's
    encoder frames [B, 1500, D] or phi-3-vision's image embeds
    [B, 576, D]."""
    import numpy as np
    if cfg.family == "audio":
        shape, name = (B, cfg.encdec.encoder_seq, cfg.d_model), "frames"
    else:
        shape, name = (B, cfg.vlm.num_image_tokens, cfg.d_model), \
            "image_embeds"
    return {name: rng.standard_normal(shape).astype(np.float32)}


def _family_launches(cfg, prefills, steps):
    """The kernel launches of ``prefills`` prefills and ``steps`` decode
    steps of an audio or vlm model: whisper's encoder (bidirectional),
    decoder and cross-attention flash per prefill, the decoder's self- and
    cross-attention decode per step, no rmsnorm (layernorm stays plain);
    phi-3-vision the dense model's."""
    L = cfg.num_layers
    if cfg.family == "audio":
        return {"flash_attention": (cfg.encdec.num_encoder_layers + 2 * L)
                * prefills, "decode_attention": 2 * L * steps,
                "rmsnorm": 0, "moe_gmm": 0, "mamba_chunk_scan": 0,
                "mlstm_chunk_scan": 0}
    return {"flash_attention": L * prefills, "decode_attention": L * steps,
            "rmsnorm": (2 * L + 1) * (prefills + steps), "moe_gmm": 0,
            "mamba_chunk_scan": 0, "mlstm_chunk_scan": 0}


def _family_decode(cfg, params, fused, out, caches, pos0, max_new, block_k):
    """The fused decode's tokens [B, max_new] from ``out``'s first token,
    and a step-by-step ``decode_step`` loop's on a copy of the caches
    (rows freeze at EOS as the fused step freezes them)."""
    import torch
    from repro_torch.models import model as M
    step_caches = copy.deepcopy(caches)
    tok, B = out["next_tokens"], out["next_tokens"].shape[0]
    pos = torch.full((B,), pos0, dtype=torch.int32, device="cuda")
    blocks = []
    for _ in range(max_new // block_k):
        o, caches = fused(params, tok, pos, caches)
        blocks.append(o["tokens"])
        tok, pos = o["tokens"][:, -1], o["pos"]
    tok = out["next_tokens"]
    pos = torch.full((B,), pos0, dtype=torch.int32, device="cuda")
    done = torch.zeros(B, dtype=torch.bool, device="cuda")
    steps = []
    for _ in range(max_new):
        logits, step_caches = M.decode_step(params, cfg, tok, pos,
                                            step_caches)
        nxt = torch.where(done, tok, logits.argmax(-1).to(torch.int32))
        done = done | (nxt == 2)
        pos = torch.where(done, pos, pos + 1)
        tok = nxt
        steps.append(nxt)
    return torch.cat(blocks, 1), torch.stack(steps, 1), caches


def _prefill_rows(cfg, prefill, params, batch):
    """The batch's rows prefilled one at a time, as a server admits
    requests, and their outputs and caches stacked into one batch (each
    cache leaf along its ``batch`` axis of ``model.cache_axes``)."""
    import torch
    from repro_torch.models import model as M
    parts = [prefill(params, {n: t[i:i + 1] for n, t in batch.items()})
             for i in range(batch["tokens"].shape[0])]
    out = {k: torch.cat([o[k] for o, _ in parts]) for k in parts[0][0]}

    def cat(ax, leaves):
        if isinstance(ax, dict):
            return {k: cat(ax[k], [t[k] for t in leaves]) for k in ax}
        return torch.cat(leaves, ax.index("batch"))
    caches = [cat(ax, [c[i] for _, c in parts])
              for i, ax in enumerate(M.cache_axes(cfg))]
    return out, caches


def _family_shape_launches(cfg, S, B, steps):
    """{attention_key: launches} that one prompt-length run of
    ``_family_serve`` must make: whisper's encoder, decoder and cross
    flash per layer of one batched prefill and its self- and
    cross-attention decode per layer and step; phi-3-vision's flash per
    layer of each request's prefill and its decode per layer and step."""
    L, hd = cfg.num_layers, cfg.hd()
    H, Hkv, cache = cfg.num_heads, cfg.num_kv_heads, FAMILY_RUNS[cfg.name]
    W = cache["cache_len"]
    if cfg.family == "audio":
        E = cfg.encdec.encoder_seq
        q, qe, qd = (B, S, H, hd), (B, E, H, hd), (B, H, hd)
        return {
            attention_key("flash_attention", qe, qe):
                cfg.encdec.num_encoder_layers,
            attention_key("flash_attention", q, (B, S, Hkv, hd)): L,
            attention_key("flash_attention", q, (B, E, Hkv, hd)): L,
            attention_key("decode_attention", qd, (B, W, Hkv, hd)): L * steps,
            attention_key("decode_attention", qd, (B, E, Hkv, hd)):
                L * steps}
    S += cfg.vlm.num_image_tokens
    return {
        attention_key("flash_attention", (1, S, H, hd), (1, S, Hkv, hd)):
            L * B,
        attention_key("decode_attention", (B, H, hd), (B, W, Hkv, hd)):
            L * steps}


def _family_serve(state, arch):
    """One model of the family at full width and ``FAMILY_LAYERS`` layers
    (bf16, weights from seed 0): per prompt length, prefill the batch, decode max_new
    tokens in fused blocks and step by step (equal tokens), launches
    equal to the formulas; one prefill and one decode block timed;
    record -> sign -> replay of the prefill step (warmed: captured as a
    CUDA graph) with live's outputs.  Its weights are freed after."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.recorder import record
    from repro_torch.core.replay import Replayer
    from repro_torch.models import layers as Lyr
    from repro_torch.training import steps as ST

    run = FAMILY_RUNS[arch]
    cfg = _cut_depth(get_config(arch), FAMILY_LAYERS)
    B, cache_len, block_k, max_new = (run["batch"], run["cache_len"],
                                      run["block_k"], run["max_new"])
    params = _init_params(cfg)
    prefill = ST.make_prefill_step(cfg, cache_len)
    fused = ST.make_fused_decode_step(cfg, k=block_k)
    rng = np.random.default_rng(5)
    extra = _family_extra(cfg, B, rng)
    n_img = cfg.vlm.num_image_tokens if cfg.family == "vlm" else 0
    batches = {}
    for S in run["prompts"]:
        toks = rng.integers(3, cfg.vocab_size, (B, S)).astype("int32")
        batch = {"tokens": torch.as_tensor(toks, device="cuda"),
                 **{n: torch.as_tensor(a, device="cuda").to(torch.bfloat16)
                    for n, a in extra.items()}}
        batches[S] = batch
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        # whisper prefills its batch in one call, phi-3-vision one request
        # at a time
        out, caches = prefill(params, batch) if cfg.family == "audio" \
            else _prefill_rows(cfg, prefill, params, batch)
        fused_toks, step_toks, caches = _family_decode(
            cfg, params, fused, out, caches, S + n_img, max_new, block_k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = K.launch_counts()
        # the step loop's launches: max_new more decode steps
        prefills = 1 if cfg.family == "audio" else B
        want = _family_launches(cfg, prefills, 2 * max_new)
        assert launches == want, (arch, S, launches, want)
        assert torch.equal(fused_toks, step_toks), \
            f"families {arch}: fused and step-by-step tokens differ " \
            f"({fused_toks.tolist()} vs {step_toks.tolist()})"
        # each attention launch by its shapes, against the shapes the
        # model gives the kernels (the table rows among them)
        by_shape = {attention_key(k.__name__, *key): n
                    for k in (K.flash_attention, K.decode_attention)
                    for key, n in k.by_shape.items()}
        assert by_shape == _family_shape_launches(cfg, S, B, 2 * max_new), \
            (arch, S, by_shape)
        log(f"families: {arch} batch {B} prompt {S} (+{n_img} image rows): "
            f"prefill, {max_new} tokens in fused blocks of {block_k} and "
            f"step by step in {dt:.2f} s; tokens equal "
            f"{fused_toks[:, :8].tolist()}...; launches equal {want}; "
            f"attention launches by (q, k) shape {list(by_shape.values())} "
            f"at {[key for _, key in by_shape]}")
        shapes = state.setdefault("family_shape_launches", {})
        for key, n in by_shape.items():
            shapes[key] = shapes.get(key, 0) + n
    S = run["prompts"][-1]
    batch = batches[S]

    # one prefill (phi-3-vision: one request, 576 + 128 rows) and one
    # fused decode block of the batch
    one = {n: t[:1] for n, t in batch.items()} if cfg.family == "vlm" \
        else batch
    rows = one["tokens"].shape[0]
    _timed(f"families: {arch} one prefill of {rows} x {S + n_img} tokens",
           lambda: prefill(params, one))
    out, caches = prefill(params, batch)    # (the batch in one call here)
    pos = torch.full((B,), S + n_img, dtype=torch.int32, device="cuda")
    _timed(f"families: {arch} one decode block of {block_k} steps, {B} "
           f"rows, cache {cache_len}",
           lambda: fused(params, out["next_tokens"], pos, caches))

    # record -> sign -> replay of the prefill step at full width
    tree = Lyr.to_tree(params)
    want, _ = prefill(params, batch)
    t0 = time.perf_counter()
    rec = record(f"{arch}:prefill", prefill, (tree, batch))
    blob = rec.sign_with(FAMILY_KEY).to_bytes()
    t_rec = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp = Replayer(key=FAMILY_KEY, device="cuda")
    name = rp.load(blob)
    t_load = time.perf_counter() - t0
    rp.warm(name)
    got, _ = rp.execute(name, tree, batch)
    torch.cuda.synchronize()
    assert rp.stats["captures"] == 1, rp.stats
    assert torch.equal(got["next_tokens"], want["next_tokens"]), \
        f"families {arch}: replayed prefill tokens differ from live"
    err = (got["last_logits"].float() - want["last_logits"].float()) \
        .abs().max().item()
    per_replay = rp.captured_launches(name)
    assert per_replay == {k: n for k, n in _family_launches(cfg, 1, 0)
                          .items() if n}, per_replay
    # the batch was built tokens first; its leaves are recorded sorted
    shapes = [i["shape"] for i in rec.manifest["inputs"][-len(batch):]]
    assert shapes == [list(batch[n].shape) for n in sorted(batch)], shapes
    log(f"families: {arch}: prefill recorded and signed in {t_rec:.2f} s "
        f"({len(rec.payload) / 1e6:.2f} MB, {len(rec.manifest['inputs'])} "
        f"inputs, the batch's last in JAX's order: {shapes}), verified and "
        f"loaded in {t_load:.2f} s; the replay under its CUDA graph gives "
        f"live's next tokens {got['next_tokens'].tolist()}, last logits "
        f"max |err| {err:.3g}; one replay launches {per_replay}")
    del params, tree, rp, caches, out
    torch.cuda.empty_cache()


def phase_families(state):
    """The audio and vlm families: whisper-large-v3 and phi-3-vision-4.2b
    in fp32 at 2 layers (whisper: 2 + 2) on the card against the CPU,
    then each at full width and ``FAMILY_LAYERS`` layers in bf16
    (``_family_serve``)."""
    import numpy as np
    from repro_torch.configs import get_config

    rng = np.random.default_rng(6)
    cfg = _cut_depth(get_config("whisper-large-v3"), 2, dtype="float32")
    toks = rng.integers(3, cfg.vocab_size, (2, 48)).astype("int32")
    _parity(cfg, toks, cache_len=1536, extra=_family_extra(cfg, 2, rng))
    cfg = _cut_depth(get_config("phi-3-vision-4.2b"), 2, dtype="float32")
    toks = rng.integers(3, cfg.vocab_size, (2, 128)).astype("int32")
    _parity(cfg, toks, cache_len=1024, extra=_family_extra(cfg, 2, rng))
    for arch in FAMILY_RUNS:
        _family_serve(state, arch)
    shapes = state["family_shape_launches"]
    idle = [r.label for r in FLASH_ROWS + DECODE_ROWS
            if r.role == "families" and not shapes.get(r.key)]
    assert not idle, f"families: no launch at the kernel rows {idle}"


# BENCH_replay.json's native rows: the six archs of the reference's
# benchmarks/replay_native.py main() at its shapes, and its tolerance
NATIVE_ARCHS = ("qwen2.5-3b", "starcoder2-7b", "mixtral-8x22b", "xlstm-350m",
                "zamba2-1.2b", "whisper-large-v3")
NATIVE_KEY = b"replay-bench-key"
STEADY_TOL = 1.05


def _steady_pair(fn_a, fn_b, iters=30, repeats=7):
    """Best of ``repeats`` block-averaged seconds per call of two
    callables, interleaved a/b per round, each block of ``iters`` calls
    ended by a synchronise (the reference's ``_steady_pair``)."""
    import torch
    best_a = best_b = float("inf")
    for _ in range(repeats):
        for fn, which in ((fn_a, "a"), (fn_b, "b")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            if which == "a":
                best_a = min(best_a, dt)
            else:
                best_b = min(best_b, dt)
    return best_a, best_b


def _native_row(arch):
    """The reference bench's ``bench_arch`` on the card: the smoke
    config's prefill step (tokens [1, 32] of ones, frames of ones,
    cache 64), native = the live step (eager PyTorch with the port's
    kernels; its launch is the first call, there is no compile), replay =
    record -> sign -> load -> warm -> execute (its launch ends with the
    first replay, the CUDA graph's capture)."""
    import torch
    from repro_torch.configs import get_config, smoke_shrink
    from repro_torch.core.recorder import record
    from repro_torch.core.replay import Replayer
    from repro_torch.models import layers as Lyr
    from repro_torch.models import model as M
    from repro_torch.training import steps as ST

    cfg = smoke_shrink(get_config(arch))
    params = M.init_params(cfg, seed=0, device="cuda")
    tree = Lyr.to_tree(params)
    batch = {"tokens": torch.ones((1, 32), dtype=torch.int32, device="cuda")}
    if cfg.family == "audio":
        batch["frames"] = torch.ones((1, cfg.encdec.encoder_seq, cfg.d_model),
                                     dtype=torch.bfloat16, device="cuda")
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.ones(
            (1, cfg.vlm.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device="cuda")
    fn = ST.make_prefill_step(cfg, cache_len=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live, _ = fn(params, batch)
    torch.cuda.synchronize()
    native_launch = time.perf_counter() - t0
    rec = record(f"{arch}:prefill", fn, (tree, batch))
    blob = rec.sign_with(NATIVE_KEY).to_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rp = Replayer(key=NATIVE_KEY, device="cuda")
    name = rp.load(blob)
    rp.warm(name)
    out, _ = rp.execute(name, tree, batch)
    torch.cuda.synchronize()
    replay_launch = time.perf_counter() - t0
    assert torch.equal(out["next_tokens"], live["next_tokens"]), arch
    native_steady, replay_steady = _steady_pair(
        lambda: fn(params, batch), lambda: rp.execute(name, tree, batch))
    return {"arch": arch,
            "native_launch_ms": round(native_launch * 1e3, 1),
            "replay_launch_ms": round(replay_launch * 1e3, 1),
            "launch_speedup": round(native_launch / replay_launch, 2),
            "native_steady_ms": round(native_steady * 1e3, 3),
            "replay_steady_ms": round(replay_steady * 1e3, 3),
            "steady_ratio": round(replay_steady / native_steady, 3),
            "fast_hits": rp.stats["fast_hits"],
            "slow_validations": rp.stats["slow_validations"],
            "replay_not_slower_than_native":
                replay_steady <= native_steady * STEADY_TOL}


def phase_native(state):
    """BENCH_replay.json's native rows on the card, the six archs of the
    reference's ``replay_native.main(quick=False)``; every row must hold
    ``replay_not_slower_than_native`` at the bench's 5%.  Nothing is
    written: the committed BENCH_replay.json stays as it is."""
    import torch
    rows = []
    for arch in NATIVE_ARCHS:
        row = _native_row(arch)
        log(f"native: {json.dumps(row)}")
        rows.append(row)
        torch.cuda.empty_cache()
    slow = [r["arch"] for r in rows if not r["replay_not_slower_than_native"]]
    log(f"native: replay_not_slower_than_native {not slow} over "
        f"{len(rows)} archs (tolerance {STEADY_TOL}); launch_speedup "
        f"{[r['launch_speedup'] for r in rows]} (printed, not gated); on "
        f"{_card(state)}")
    assert not slow, f"native: replay slower than native for {slow}"


TRAIN_ARCH = "qwen2.5-3b"
TRAIN_SHAPES = dict(steps=6, batch=8, seq=128)   # launch/train.py's defaults
TRAIN_SMALL = dict(num_layers=2, batch=2, seq=64)
TRAIN_OPT = dict(warmup_steps=1, decay_steps=10)
# (d) the recurrent families: the parity step at phase parity's group (6
# layers: zamba2's 6 Mamba2 layers and its shared block, xlstm's 5 mLSTM
# and 1 sLSTM) and seq 128 (two kernel chunks a row), then train() at
# full depth for 3 steps at launch/train.py's batch and seq
TRAIN_RECURRENT = ("zamba2-1.2b", "xlstm-350m")
TRAIN_RECURRENT_SMALL = dict(num_layers=6, batch=2, seq=128)
TRAIN_RECURRENT_SHAPES = dict(steps=3, batch=8, seq=128)
# (e) the moe family: deepseek-v2-lite-16b's parity step at full width and
# 2 layers (1 mla_dense + 1 mla_moe, 1.09 B params; T = 256 is one
# group), then train() at full width and 4 layers for 3 steps at
# launch/train.py's batch and seq.  At full depth its AdamW state (15.7 B
# params, ~250 GB) does not fit one card; 4 layers are 2.25 B.
TRAIN_MOE = "deepseek-v2-lite-16b"
TRAIN_MOE_SMALL = dict(num_layers=2, batch=2, seq=128)
TRAIN_MOE_SHAPES = dict(num_layers=4, steps=3, batch=8, seq=128)


def _train_launches(cfg):
    """The backward kernel runs of one train step (remat "none": one for
    every forward launch): dense, rmsnorm's 2 L + 1 and flash's L; hybrid,
    2 L + 2 (L / shared_every) + 1 rmsnorm, a flash per shared block and
    an SSD scan per layer; ssm, 2 L + 1 rmsnorm and an mLSTM scan per
    layer but the sLSTM ones; moe, from ``models/model.py:build_stages``:
    every layer's ln1 and ln2, MLA's kv_norm a layer
    (``models/layers.py:_mla_latent``) and the final norm, so 3 L + 1
    rmsnorm with MLA (deepseek) and 2 L + 1 without (mixtral), a flash a
    layer (``mla_attention`` or ``attention``), and three moe_gmm a routed
    layer (``models/moe.py:apply_moe``: w1, w3, w2; deepseek's first
    layer is dense)."""
    from repro_torch.models import model as M
    L_ = cfg.num_layers
    want = dict.fromkeys(("rmsnorm_backward", "flash_attention_backward",
                          "mamba_chunk_scan_backward",
                          "mlstm_chunk_scan_backward", "moe_gmm_backward"),
                         0)
    if cfg.family == "moe":
        stages = M.build_stages(cfg)
        mla = sum(st.n for st in stages if st.kind in M.MLA_KINDS)
        routed = sum(st.n for st in stages if st.kind in M.MOE_KINDS)
        want.update(rmsnorm_backward=2 * L_ + mla + 1,
                    flash_attention_backward=L_,
                    moe_gmm_backward=3 * routed)
    elif cfg.family == "hybrid":
        shared = L_ // cfg.shared_every
        want.update(rmsnorm_backward=2 * L_ + 2 * shared + 1,
                    flash_attention_backward=shared,
                    mamba_chunk_scan_backward=L_)
    elif cfg.family == "ssm":
        want.update(rmsnorm_backward=2 * L_ + 1, mlstm_chunk_scan_backward=(
            L_ - sum(i < L_ for i in cfg.xlstm.slstm_at)))
    else:
        want.update(rmsnorm_backward=2 * L_ + 1, flash_attention_backward=L_)
    return want


def _grads_resolved(state):
    """Per master leaf, the elements whose first-step gradient (m / (1 -
    b1)) is at least 1e-6: Adam's first step moves the others by lr * g /
    (|g| + 1e-8), which rounding of g alone decides."""
    import torch
    return [m.abs() / (1 - 0.9) >= 1e-6
            for m in torch.utils._pytree.tree_leaves(state["m"])]


def _train_parity(arch=TRAIN_ARCH, small=TRAIN_SMALL, part="(a)"):
    """(a) one fp32 train step of qwen2.5-3b cut to 2 layers at full width
    on the card (its backward kernels) against the same step on the CPU
    (plain versions), same params and batch; (d) the same for ``arch`` at
    ``small``."""
    import dataclasses as dc
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.training import steps as ST
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    cfg = dc.replace(get_config(arch), num_layers=small["num_layers"],
                     dtype="float32")
    tree = L.to_tree(M.init_params(cfg, 0, device="cuda"))
    batch = SyntheticLM(cfg.vocab_size, small["batch"],
                        small["seq"]).next_batch()
    step = ST.make_train_step(cfg, AdamWConfig(**TRAIN_OPT), remat="none")
    got = {}
    for dev in ("cpu", "cuda"):
        state = init_opt_state(pytree.tree_map(lambda t: t.to(dev), tree))
        K.reset_launches()
        t0 = time.perf_counter()
        got[dev] = step(state, {k: torch.from_numpy(v).to(dev)
                                for k, v in batch.items()})
        torch.cuda.synchronize()
        log(f"train: {part} {cfg.name} {cfg.num_layers} layers fp32 step on "
            f"{dev} in {time.perf_counter() - t0:.2f} s; backward launches "
            f"{K.launch_counts(K.BACKWARD_KERNELS)}")
    (sc, mc), (sg, mg) = got["cpu"], got["cuda"]
    assert K.launch_counts(K.BACKWARD_KERNELS) == _train_launches(cfg), \
        K.launch_counts(K.BACKWARD_KERNELS)
    rel = {k: abs(float(mc[k]) - float(mg[k])) / abs(float(mc[k]))
           for k in ("loss", "grad_norm")}
    lr = float(mc["lr"])
    worst = worst_free = 0.0
    for a, b, ok in zip(pytree.tree_leaves(sc["master"]),
                        pytree.tree_leaves(sg["master"]),
                        _grads_resolved(sc)):
        d = (a - b.cpu()).abs()
        ok = ok.cpu()
        worst = max(worst, float(d[ok].max()) if ok.any() else 0.0)
        worst_free = max(worst_free, float(d[~ok].max()) if (~ok).any()
                         else 0.0)
    log(f"train: {part} card vs CPU: loss {float(mg['loss'])!r} vs "
        f"{float(mc['loss'])!r} (rel {rel['loss']:.3g}), grad_norm "
        f"{float(mg['grad_norm'])!r} vs {float(mc['grad_norm'])!r} (rel "
        f"{rel['grad_norm']:.3g}); master max |diff| {worst:.3g} where the "
        f"gradient is resolved, {worst_free:.3g} elsewhere (lr {lr:.3g})")
    # limits: 1e-4 relative for the two scalars and 1e-5 on the resolved
    # master elements (fp32 sums in other orders on the two devices;
    # measured: loss equal, masters 1.2e-7 apart); the rest within Adam's
    # step bound
    assert rel["loss"] <= 1e-4 and rel["grad_norm"] <= 1e-4, rel
    assert worst <= 1e-5 and worst_free <= 2 * lr + 1e-5, (worst, worst_free)
    return cfg, tree, sg


def _train_resume(cfg, tree):
    """(c) the same 2-layer fp32 model on the card: 3 steps, a checkpoint
    (async, through the reference's layout), 3 more steps; the checkpoint
    restored and stepped 3 times must equal the 6 at atol 1e-5."""
    import tempfile
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime import checkpoint as CK
    from repro_torch.training import steps as ST
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    step = ST.make_train_step(cfg, AdamWConfig(warmup_steps=2, decay_steps=8),
                              remat="none")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SMALL["batch"],
                       TRAIN_SMALL["seq"])

    def run(state, n):
        for _ in range(n):
            state, _ = step(state, {k: torch.from_numpy(v).cuda()
                                    for k, v in data.next_batch().items()})
        return state

    with tempfile.TemporaryDirectory() as d:
        store = CK.CheckpointStore(d)
        t0 = time.perf_counter()
        state = run(init_opt_state(tree), 3)
        # stacked on the card, copied to the host once by async_save
        store.async_save(CK.to_reference_layout(state, host=False), 3,
                         extra_meta=data.meta())
        state = run(state, 3)
        store.wait()
        t1 = time.perf_counter()
        restored, manifest = store.restore(CK.to_reference_layout(
            ST.abstract_train_state(cfg), host=False))
        data.restore(manifest["extra"])
        resumed = run(CK.from_reference_layout(cfg, restored, "cuda"), 3)
        torch.cuda.synchronize()
        worst = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(pytree.tree_leaves(state),
                                    pytree.tree_leaves(resumed)))
        log(f"train: (c) 3 + checkpoint + 3 steps against 6: max |diff| "
            f"{worst:.3g} over {len(pytree.tree_leaves(state))} leaves; "
            f"{store.stats['bytes_written'] / 1e9:.2f} GB written; "
            f"{t1 - t0:.1f} s for 6 steps and the save, "
            f"{time.perf_counter() - t1:.1f} s to restore and step 3")
        assert int(resumed["step"]) == 6 and worst <= 1e-5, worst


def _train_profile(step, state, batch):
    """One more train step under torch.profiler, the device's activity
    only (busy time needs no host events, and recording and parsing those
    of a recurrent step's ~50,000 kernels is slow): (device busy ms, CUDA
    kernels, {kind: device ms}, the six heaviest kernels, {custom backward
    family: (device ms, kernels)}) with the kernels sorted into the custom
    forwards, the custom backwards, matrix products and the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    busy, n_kern = _device_busy(prof)
    kinds = {"custom backward": ("flash_bwd", "rmsnorm_bwd", "mamba_bwd",
                                 "mlstm_bwd", "gmm_bwd"),
             "custom forward": ("flash_attention_mma", "rmsnorm_warp",
                                "rmsnorm_block", "mamba_scan_",
                                "mlstm_scan_", "moe_gmm_"),
             "matrix products": ("nvjet", "gemm", "xmma", "cutlass")}
    ms = dict.fromkeys(list(kinds) + ["other"], 0.0)
    by_name, backward = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + t
        kind = next((k for k, keys in kinds.items()
                     if any(x in e.name for x in keys)), "other")
        ms[kind] += t
        family = next((x for x in kinds["custom backward"] if x in e.name),
                      None)
        if family:
            t0, n = backward.get(family, (0.0, 0))
            backward[family] = (t0 + t, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return busy, n_kern, ms, top, backward


def _train_checked(state, cfg, steps, B, S, init, part):
    """launch/train.py's ``train`` of ``cfg`` in bf16 on the card, from
    the weights of seed 0 (``init``: the same, on the host), for ``steps``
    at batch B, seq S: finite losses, every master leaf moved, one backward
    run per forward launch of each kernel with a backward and as many as
    ``_train_launches`` says; ms per step, tokens/s and peak memory; then
    one more step profiled.  -> (run, steady ms a step, peak GB, device
    busy ms, backward launches)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch import kernels as K
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import train
    from repro_torch.training import steps as ST
    from repro_torch.training.optimizer import AdamWConfig

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train(cfg, steps=steps, batch=B, seq=S, remat="none", log_every=1,
                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    fwd, bwd = K.launch_counts(), K.launch_counts(K.BACKWARD_KERNELS)
    assert bwd == {k: n * steps for k, n in _train_launches(cfg).items()}, \
        bwd
    fwd_of = {k: fwd[k[:-len("_backward")]] for k in bwd}
    assert fwd_of == bwd, (fwd, bwd)     # one forward launch per backward
    losses = [float(mt["loss"]) for mt in run.metrics]
    gnorms = [float(mt["grad_norm"]) for mt in run.metrics]
    assert all(map(math.isfinite, losses + gnorms)), (losses, gnorms)
    changed = [not torch.equal(a, b.cuda().float()) for a, b in zip(
        pytree.tree_leaves(run.state["master"]), init)]
    assert all(changed), f"{changed.count(False)} master leaves unchanged"
    steady = run.step_ms[1:]
    ms = sum(steady) / len(steady)
    per_step = ", ".join(f"{k[:-len('_backward')]} {fwd_of[k] // steps} + "
                         f"backward {n // steps}" for k, n in bwd.items() if n)
    log(f"train: {part} {cfg.name} "
        f"{sum(t.numel() for t in init) / 1e9:.3f} B params, bf16, batch "
        f"{B} seq {S}: {steps} steps in {wall:.2f} s; step ms "
        f"{[round(x, 1) for x in run.step_ms]} (steady {ms:.1f} ms/step, "
        f"{B * S * 1000 / ms:.0f} training tokens/s); peak {peak:.2f} GB; "
        f"every master leaf moved; losses {losses}; launches per step: "
        f"{per_step}; on {_card(state)}")

    step = ST.make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=10,
                                               decay_steps=steps),
                              remat="none")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             SyntheticLM(cfg.vocab_size, B, S).next_batch().items()}
    t0 = time.perf_counter()
    busy, n_kern, kinds, top, backward = _train_profile(step, run.state,
                                                        batch)
    log(f"train: {part} {cfg.name} one more step profiled (in "
        f"{time.perf_counter() - t0:.1f} s): device busy "
        f"{busy:.2f} ms over {n_kern} kernels against {ms:.1f} ms wall "
        f"(idle share {1 - busy / ms:.3f}); device ms by kind "
        f"{ {k: round(v, 2) for k, v in kinds.items()} }; top kernels "
        f"{[(n[:60], round(t, 2)) for n, t in top]}")
    log(f"train: {part} {cfg.name} custom backward device ms "
        f"{kinds['custom backward']:.4f} a step: " + ", ".join(
            f"{f} {t:.4f} ms over {n} kernels" for f, (t, n) in
            sorted(backward.items())))
    return run, ms, peak, busy, bwd, kinds["custom backward"]


def _train_full(state):
    """(b) qwen2.5-3b at full width and depth: one fp32 forward + backward
    (no optimizer) from the weights of seed 0, freed; then
    launch/train.py's ``train`` in bf16, which draws the same weights, for
    6 steps at its default batch and seq (``_train_checked``); its first
    step against the fp32 pass."""
    import dataclasses as dc
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.training import steps as ST
    from repro_torch.training.optimizer import global_norm

    cfg = get_config(TRAIN_ARCH)
    steps, B, S = (TRAIN_SHAPES[k] for k in ("steps", "batch", "seq"))
    data = SyntheticLM(cfg.vocab_size, B, S)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.next_batch().items()}
    params = L.to_tree(M.init_params(cfg, 0, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().float().requires_grad_() for p in flat]
    loss32, _ = ST.make_loss_fn(dc.replace(cfg, dtype="float32"), "none")(
        pytree.tree_unflatten(leaves, spec), batch)
    gnorm32 = float(global_norm(torch.autograd.grad(loss32, leaves)))
    loss32 = float(loss32.detach())
    log(f"train: (b) fp32 forward + backward at full depth: loss "
        f"{loss32!r} grad_norm {gnorm32!r} in "
        f"{time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    init = [p.to("cpu") for p in flat]    # to check that every leaf moves
    del leaves, params, flat, batch
    torch.cuda.empty_cache()

    run, ms, peak, busy, bwd, bwd_ms = _train_checked(state, cfg, steps, B,
                                                      S, init, "(b)")
    loss1, gnorm1 = (float(run.metrics[0][k]) for k in ("loss", "grad_norm"))
    d_loss = abs(loss1 - loss32) / loss32
    d_gn = abs(gnorm1 - gnorm32) / gnorm32
    log(f"train: (b) step 1 bf16 against the fp32 pass: loss {loss1!r} vs "
        f"{loss32!r} (rel {d_loss:.3g}), grad_norm {gnorm1!r} vs "
        f"{gnorm32!r} (rel {d_gn:.3g})")
    # measured: rel 1.6e-5 (loss) and 3.6e-5 (grad norm); the limits
    # leave room for bf16 rounding that differs from run to run of data
    assert d_loss <= 1e-3 and d_gn <= 1e-2, (d_loss, d_gn)
    state.setdefault("train_launches", {}).update(
        rmsnorm_backward=bwd["rmsnorm_backward"],
        flash_attention_backward=bwd["flash_attention_backward"])
    state["train"] = dict(ms=ms, peak_gb=peak, tok_s=B * S * 1000 / ms,
                          busy_ms=busy, custom_backward_ms=bwd_ms)


def _train_recurrent(state, arch):
    """(d) ``arch`` (zamba2-1.2b or xlstm-350m): the fp32 parity step at
    TRAIN_RECURRENT_SMALL, then launch/train.py's ``train`` in bf16 at full
    width and depth for TRAIN_RECURRENT_SHAPES (``_train_checked``: one
    scan launch per scan layer a step, forward and backward)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    _train_parity(arch, TRAIN_RECURRENT_SMALL, "(d)")
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    steps, B, S = (TRAIN_RECURRENT_SHAPES[k] for k in ("steps", "batch",
                                                        "seq"))
    init = [p.to("cpu") for p in pytree.tree_leaves(
        L.to_tree(M.init_params(cfg, 0, device="cuda")))]
    torch.cuda.empty_cache()
    run, ms, peak, busy, bwd, _ = _train_checked(state, cfg, steps, B, S,
                                                 init, "(d)")
    scan = "mamba_chunk_scan_backward" if cfg.family == "hybrid" else \
        "mlstm_chunk_scan_backward"
    state.setdefault("train_launches", {})[scan] = bwd[scan]
    state.setdefault("train_recurrent", {})[arch] = dict(
        ms=ms, peak_gb=peak, tok_s=B * S * 1000 / ms, busy_ms=busy)
    del run, init
    torch.cuda.empty_cache()


def _train_moe(state):
    """(e) deepseek-v2-lite-16b: the fp32 parity step at TRAIN_MOE_SMALL,
    then launch/train.py's ``train`` in bf16 at full width and
    TRAIN_MOE_SHAPES' depth (``_train_checked``: a moe_gmm backward run
    per moe_gmm launch, a flash backward at (hd 192, hd_v 128) a layer)."""
    import dataclasses as dc
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    _train_parity(TRAIN_MOE, TRAIN_MOE_SMALL, "(e)")
    torch.cuda.empty_cache()
    layers, steps, B, S = (TRAIN_MOE_SHAPES[k] for k in ("num_layers",
                                                          "steps", "batch",
                                                          "seq"))
    cfg = dc.replace(get_config(TRAIN_MOE), num_layers=layers)
    init = [p.to("cpu") for p in pytree.tree_leaves(
        L.to_tree(M.init_params(cfg, 0, device="cuda")))]
    torch.cuda.empty_cache()
    run, ms, peak, busy, bwd, bwd_ms = _train_checked(state, cfg, steps, B,
                                                      S, init, "(e)")
    state["moe_train_launches"] = dict(bwd)
    state.setdefault("train_launches", {})["moe_gmm_backward"] = \
        bwd["moe_gmm_backward"]
    state["train_moe"] = dict(ms=ms, peak_gb=peak, tok_s=B * S * 1000 / ms,
                              busy_ms=busy, custom_backward_ms=bwd_ms)
    del run, init
    torch.cuda.empty_cache()


def phase_train(state):
    import torch
    cfg, tree, _ = _train_parity()
    _train_resume(cfg, tree)
    del tree
    torch.cuda.empty_cache()
    _train_full(state)
    torch.cuda.empty_cache()
    for arch in TRAIN_RECURRENT:
        _train_recurrent(state, arch)
    _train_moe(state)


# ------------------------------------------------------------------- mesh --
MESH_TRAIN = dict(num_layers=2, batch=8, seq=128, steps=2)
# phase mesh's serving models at full width: the dense and moe ones at 2
# layers, the hybrid and ssm ones at one group (zamba2: 6 Mamba2 layers and
# the shared block; xlstm: 5 mLSTM blocks and the sLSTM one)
MESH_SERVE = {"qwen2.5-3b": 2, "deepseek-v2-lite-16b": 2, "zamba2-1.2b": 6,
              "xlstm-350m": 6}
MESH_SERVE_SHAPES = dict(batch=4, seq=16, cache_len=64, block_k=8)
# the plain versions of every custom op, each counted while phase mesh
# runs: on the card none may run
PLAIN_FNS = {"rmsnorm": ("rmsnorm_plain", "rmsnorm_backward_plain"),
             "flash_attention": ("flash_attention_plain",
                                 "flash_attention_backward_plain"),
             "decode_attention": ("decode_attention_plain",),
             "moe_gmm": ("moe_gmm_plain", "moe_gmm_backward_plain"),
             "mamba_scan": ("mamba_chunk_scan_plain",
                            "mamba_chunk_scan_backward_plain"),
             "mlstm": ("mlstm_chunk_scan_plain",
                       "mlstm_chunk_scan_backward_plain")}


@contextlib.contextmanager
def plain_calls():
    """{plain function: calls} of the kernel modules' plain versions while
    the block runs (each wrapped in a counter, restored after)."""
    calls = {}
    saved = []
    for mod_name, names in PLAIN_FNS.items():
        mod = sys.modules[f"repro_torch.kernels.{mod_name}"]
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _counts():
    """The launches of the forward and backward wrappers."""
    from repro_torch import kernels as K
    return {**K.launch_counts(), **K.launch_counts(K.BACKWARD_KERNELS)}


def _mesh_train(mesh, cfg, card):
    """(b) and (e): ``cfg`` in its dtype with fp32 masters, MESH_TRAIN's
    steps on the state placed by ``reshard_state`` under the train rules
    and the same steps on plain tensors: loss, grad norm and every master
    equal to the bit, the launches equal and the plain versions never run
    on the card; the state saved with ``CheckpointStore``, restored onto
    the mesh (``restore_on_mesh``) and stepped once more, equal to the
    sharded state's next step to the bit; then each run's steady step
    timed (wall, device busy, idle share) on ``card`` -> {run: (wall ms,
    busy ms)}."""
    import tempfile
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch import kernels as K
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.runtime import checkpoint as CK
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding import rules_for
    from repro_torch.training import steps as ST
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    device = "cuda"
    B, S, n = (MESH_TRAIN[k] for k in ("batch", "seq", "steps"))
    data = SyntheticLM(cfg.vocab_size, B, S)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in
                data.next_batch().items()} for _ in range(n + 3)]
    opt = AdamWConfig(warmup_steps=1, decay_steps=10)
    rules = rules_for("train", tuple(mesh.mesh_dim_names))
    plain = init_opt_state(M.init_params(cfg, 0, device=device))
    sharded = reshard_state(pytree.tree_map(torch.clone, plain),
                            ST.train_state_axes(cfg), mesh)
    runs = {}
    with plain_calls() as calls:
        for label, state, step in (
                ("sharded", sharded, ST.make_train_step(
                    cfg, opt, remat="none", rules=rules)),
                ("plain", plain, ST.make_train_step(cfg, opt,
                                                    remat="none"))):
            K.reset_launches()
            calls.clear()
            metrics = []
            t0 = time.perf_counter()
            for b in batches[:n]:
                state, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
            runs[label] = dict(state=state, step=step, metrics=metrics,
                               launches=_counts(),
                               plain_calls=dict(calls),
                               s=time.perf_counter() - t0)
    sh, pl = runs["sharded"], runs["plain"]
    masters = [(a.full_tensor(), b) for a, b in zip(
        pytree.tree_leaves(sh["state"]["master"]),
        pytree.tree_leaves(pl["state"]["master"]))]
    equal = sum(torch.equal(a, b) for a, b in masters)
    log(f"mesh: (b) {cfg.name} {cfg.num_layers} layers, {cfg.dtype} with "
        f"fp32 masters, batch {B} seq {S}, {n} steps: sharded "
        f"{sh['metrics']} vs plain {pl['metrics']}; {equal} of "
        f"{len(masters)} masters equal to the bit; launches sharded "
        f"{ {k: v for k, v in sh['launches'].items() if v} } plain "
        f"{ {k: v for k, v in pl['launches'].items() if v} }; plain "
        f"versions called {sh['plain_calls']}; {sh['s']:.2f} s sharded, "
        f"{pl['s']:.2f} s plain (first steps)")
    assert sh["metrics"] == pl["metrics"], (sh["metrics"], pl["metrics"])
    assert equal == len(masters), f"{len(masters) - equal} masters differ"
    assert sh["launches"] == pl["launches"], (sh["launches"], pl["launches"])
    assert sh["launches"]["rmsnorm_backward"] > 0 and \
        sh["launches"]["flash_attention_backward"] > 0, sh["launches"]
    assert not sh["plain_calls"], sh["plain_calls"]

    # (e) save, restore onto the mesh, one more step against the state's
    with tempfile.TemporaryDirectory() as d:
        store = CK.CheckpointStore(d)
        store.save(CK.to_reference_layout(sh["state"]), n)
        restored, manifest = CK.restore_on_mesh(store, cfg, mesh)
    assert manifest["step"] == n
    r_state, r_m = sh["step"](restored, batches[n])
    s_state, s_m = sh["step"](sh["state"], batches[n])
    same = [torch.equal(a.full_tensor(), b.full_tensor()) for a, b in zip(
        pytree.tree_leaves(r_state["master"]),
        pytree.tree_leaves(s_state["master"]))]
    log(f"mesh: (e) checkpoint of step {n} restored onto the mesh, step "
        f"{n + 1}: loss {float(r_m['loss'])!r} vs {float(s_m['loss'])!r}, "
        f"grad_norm {float(r_m['grad_norm'])!r} vs "
        f"{float(s_m['grad_norm'])!r}; {sum(same)} of {len(same)} masters "
        f"equal to the bit")
    assert float(r_m["loss"]) == float(s_m["loss"]) and \
        float(r_m["grad_norm"]) == float(s_m["grad_norm"]) and all(same)
    del restored, r_state
    times = {}
    for label, run, state in (("sharded", sh, s_state),
                              ("plain", pl, pl["state"])):
        step, b = run["step"], batches[n + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        busy, n_kern, *_ = _train_profile(step, state, batches[n + 2])
        log(f"mesh: (b) {label} train step: {wall:.1f} ms wall, device "
            f"busy {busy:.2f} ms over {n_kern} kernels, idle share "
            f"{1 - busy / wall:.3f}; on {card}")
        times[label] = (wall, busy)
    return times


def _serve_launches(cfg, steps):
    """The forward launches of one prefill and ``steps`` decode steps of
    phase mesh's serving models: per call ln1 and ln2 a layer and the
    final norm (MLA adds kv_norm a layer; a Mamba2 or xLSTM block's ln1
    and its cell's norm, zamba2's shared block two more); the prefill's
    flash a (shared) attention layer and a scan a Mamba2 / mLSTM layer;
    a decode step's decode_attention a GQA layer (MLA decodes in plain
    PyTorch); three moe_gmm a routed layer a call."""
    from repro_torch.models import model as M
    L_, calls = cfg.num_layers, 1 + steps
    out = dict.fromkeys(("rmsnorm", "flash_attention", "decode_attention",
                         "moe_gmm", "mamba_chunk_scan", "mlstm_chunk_scan"),
                        0)
    if cfg.family == "moe":
        stages = M.build_stages(cfg)
        routed = sum(st.n for st in stages if st.kind in M.MOE_KINDS)
        out.update(rmsnorm=(3 * L_ + 1) * calls, flash_attention=L_,
                   moe_gmm=3 * routed * calls)
    elif cfg.family == "hybrid":
        shared = L_ // cfg.shared_every
        out.update(rmsnorm=(2 * L_ + 2 * shared + 1) * calls,
                   flash_attention=shared, decode_attention=shared * steps,
                   mamba_chunk_scan=L_)
    elif cfg.family == "ssm":
        out.update(rmsnorm=(2 * L_ + 1) * calls, mlstm_chunk_scan=(
            L_ - sum(i < L_ for i in cfg.xlstm.slstm_at)))
    else:
        out.update(rmsnorm=(2 * L_ + 1) * calls, flash_attention=L_,
                   decode_attention=L_ * steps)
    return out


def _mesh_serve(mesh, cfg):
    """(c) ``cfg`` from the weights of seed 0, as DTensors placed under the
    serve rules and as plain tensors: a prefill and one fused decode block
    each, identical greedy tokens, launches equal to ``_serve_launches``
    in both, the plain versions never run on the card."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import kernels as K
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.sharding import rules_for, shardings_for
    from repro_torch.training import steps as ST

    device = "cuda"
    B, S, cache, k = (MESH_SERVE_SHAPES[x] for x in ("batch", "seq",
                                                      "cache_len",
                                                      "block_k"))
    rules = rules_for("serve", tuple(mesh.mesh_dim_names))
    params = L.to_tree(M.init_params(cfg, 0, device=device))
    placed = pytree.tree_map(
        lambda t, p: distribute_tensor(t, mesh, list(p)), params,
        shardings_for(M.param_axes(cfg), params, mesh, rules),
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab_size, (B, S))).to(device)
    out = {}
    with plain_calls() as calls:
        for label, p, r in (("sharded", placed, rules),
                            ("plain", params, None)):
            K.reset_launches()
            calls.clear()
            t0 = time.perf_counter()
            o, caches = ST.make_prefill_step(cfg, cache, rules=r)(
                p, {"tokens": tokens})
            f, caches = ST.make_fused_decode_step(cfg, k, rules=r)(
                p, o["next_tokens"], torch.full((B,), S, dtype=torch.int32,
                                                device=device), caches)
            toks = torch.cat([o["next_tokens"][:, None], f["tokens"]], 1)
            out[label] = (toks.cpu(), _counts(), dict(calls),
                          time.perf_counter() - t0)
    (ts, ls, cs, s_s), (tp, lp, _, s_p) = out["sharded"], out["plain"]
    want = _serve_launches(cfg, k)
    log(f"mesh: (c) {cfg.name} {cfg.num_layers} layers, serve rules: "
        f"prefill of {B} x {S} and a fused block of {k}: tokens identical "
        f"{torch.equal(ts, tp)}; launches {ls}; {s_s:.2f} s sharded, "
        f"{s_p:.2f} s plain")
    assert torch.equal(ts, tp), (ts, tp)
    assert {x: ls[x] for x in want} == want, (ls, want)
    assert {x: lp[x] for x in want} == want, (lp, want)
    assert not cs, cs


def _mesh_psum(mesh):
    """(d) ``compressed_psum`` over the mesh's data axis against the same
    x through a CPU (gloo) mesh of the same world."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.grad_compress import compressed_psum
    x = torch.linspace(-1.0, 1.0, 4096).reshape(64, 64)
    got = compressed_psum(x.cuda(), mesh, "data").cpu()
    cpu = make_mesh(tuple(mesh.mesh.shape), mesh.mesh_dim_names, "cpu")
    want = compressed_psum(x, cpu, "data")
    err = float((got - want).abs().max())
    log(f"mesh: (d) compressed_psum over {mesh.device_type} against the "
        f"CPU's: max |diff| {err:.3g}, against x times the world: "
        f"{float((got - x * mesh.size()).abs().max()):.3g}")
    assert err <= 1e-6, err


def _mesh_record(mesh):
    """(f) a ``Workload`` given the mesh records a manifest that names it,
    under the keys of a ``Workload`` given none."""
    from repro_torch.api import Workspace
    from repro_torch.core.recorder import mesh_descriptor
    ws = Workspace(device="cuda")
    shapes = dict(cache_len=32, block_k=4, batch=1, seq=8)
    with_mesh = ws.workload("cody-mnist", mesh=mesh, **shapes)
    without = ws.workload("cody-mnist", **shapes)
    rec = with_mesh.record("prefill")
    want = {"shape": [1] * mesh.ndim, "axes": list(mesh.mesh_dim_names)}
    log(f"mesh: (f) recorded under the mesh: manifest mesh "
        f"{rec.manifest['mesh']}; keys {with_mesh.key('prefill')} / "
        f"{with_mesh.key('decode')}")
    assert rec.manifest["mesh"] == mesh_descriptor(mesh) == want
    assert rec.manifest["mesh"] == mesh_descriptor()
    assert all(with_mesh.key(k) == without.key(k)
               for k in ("prefill", "decode"))
    assert with_mesh._key_of(rec) == with_mesh.key("prefill")


def _op_args(name, randn, device):
    """Inputs of the custom op ``name`` at shapes of the main path
    (bf16 where the models pass bf16; the scans' at ``_scan_inputs``'s
    full width, one kernel chunk)."""
    import torch
    bf = torch.bfloat16
    ops = torch.ops.repro_torch
    if name.startswith("rmsnorm"):
        x, sc = randn(2, 128, 2048, dt=bf), randn(2048) * 0.1 + 1.0
        return (x, sc, 1e-5) if name == "rmsnorm" else \
            (x, sc, randn(2, 128, 2048, dt=bf), 1e-5)
    if name.startswith("flash"):
        q, k, v = (randn(2, 128, h, 128, dt=bf) for h in (16, 2, 2))
        if name == "flash_attention":
            return (q, k, v, True, 0, 128 ** -0.5, 0)
        out = ops.flash_attention(q, k, v, True, 0, 128 ** -0.5, 0)
        return (q, k, v, out, randn(*out.shape, dt=bf), True, 0,
                128 ** -0.5, 0)
    if name.startswith("decode"):
        q = randn(4, 16, 128, dt=bf)
        lengths = torch.tensor([685, 560, 630, 193], dtype=torch.int32,
                               device=device)
        if name == "decode_attention":
            return (q, randn(4, 1024, 2, 128, dt=bf),
                    randn(4, 1024, 2, 128, dt=bf), lengths, 128 ** -0.5)
        i8 = lambda: (randn(4, 1024, 2, 128) * 40).round().clamp(
            -127, 127).to(torch.int8)
        sc = lambda: randn(4, 1024, 2, 1).abs() / 127
        return (q, i8(), i8(), lengths, sc(), sc(), 128 ** -0.5)
    if name.startswith("moe_gmm"):
        x, w = randn(8, 32, 2048, dt=bf), randn(8, 2048, 1408, dt=bf) * 0.02
        return (x, w) if name == "moe_gmm" else \
            (x, w, randn(8, 32, 1408, dt=bf))
    which = "mamba" if name.startswith("mamba") else "mlstm"
    args = _scan_inputs(randn, which, 1, 128, 1, bf)
    if name in ("mamba_chunk_scan", "mlstm_chunk_scan"):
        return args
    outs = getattr(ops, name[:-len("_backward")])(*args)
    if which == "mamba":
        return args + tuple(randn(*o.shape) for o in outs)
    return args + (outs[0],) + tuple(randn(*o.shape) for o in outs)


def _mesh_ops(mesh):
    """(g) each of the 12 custom ops called on DTensors on the mesh: its
    wrapper launches its kernel once (and its plain version never runs)
    on the card, and the result equals the op on plain tensors to the
    bit."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch import kernels as K
    from repro_torch.kernels import _sharding
    device = "cuda"
    g = torch.Generator(device=device).manual_seed(0)
    randn = lambda *s, dt=torch.float32: torch.randn(
        *s, generator=g, device=device).to(dt)
    wrappers = {k.__name__: k for k in
                K.KERNELS + K.INT8_KERNELS + K.BACKWARD_KERNELS}
    rows = []
    for name, _ in _sharding.strategies():
        op = getattr(torch.ops.repro_torch, name).default
        args = _op_args(name, randn, device)
        want = op(*args)
        want = want if isinstance(want, tuple) else (want,)
        dargs = [distribute_tensor(a, mesh, [Replicate()] * mesh.ndim)
                 if isinstance(a, torch.Tensor) else a for a in args]
        K.reset_launches()
        with plain_calls() as calls:
            got = op(*dargs)
        got = got if isinstance(got, tuple) else (got,)
        same = all(torch.equal(a.full_tensor(), b)
                   for a, b in zip(got, want))
        rows.append((name, wrappers[name].launches, dict(calls), same))
    log(f"mesh: (g) the custom ops on DTensors: {rows}")
    assert all(r[3] for r in rows), rows
    assert all(r[1] == 1 and not r[2] for r in rows), rows


def _mesh_slots(card):
    """(h) what a cache split over batch or slots pays a decode step:
    ``masked_write`` (a select over every slot) against ``index_put_``
    of one slot a row, on a bf16 cache at the decode kernel's row (batch
    4, 1,024 slots, 2 KV heads of 128), the same result -> the two
    device times (ms)."""
    import torch
    from repro_torch.models.layers import masked_write
    g = torch.Generator(device="cuda").manual_seed(0)
    cache = torch.randn(4, 1024, 2, 128, generator=g, device="cuda").to(
        torch.bfloat16)
    val = torch.randn(4, 2, 128, generator=g, device="cuda").to(cache.dtype)
    slot = torch.tensor([685, 560, 630, 193], device="cuda")
    bidx = torch.arange(4, device="cuda")
    a, b = cache.clone(), cache.clone()
    masked_write(a, slot, val)
    b.index_put_((bidx, slot), val)
    assert torch.equal(a, b)
    ms = {"masked": device_ms(masked_write, [(a, slot, val)] * 8,
                              repeats=MEDIAN_OF) / 8,
          "index_put": device_ms(lambda c, s, v: c.index_put_((bidx, s), v),
                                 [(b, slot, val)] * 8, repeats=MEDIAN_OF) / 8}
    log(f"mesh: (h) one K or V slot write a layer, cache "
        f"{tuple(cache.shape)} bf16: masked_write {ms['masked']!r} ms, "
        f"index_put_ {ms['index_put']!r} ms; on {card}")
    return ms


def mesh_checks(card):
    """Phase mesh's checks on the card named ``card`` (its name and power
    limit): (a) ``make_host_mesh(model=1)`` over a world of one, then
    (b)-(h) -> (b)'s step times and (h)'s write times."""
    import dataclasses as dc
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.recorder import mesh_descriptor
    from repro_torch.launch.mesh import make_host_mesh

    started = not dist.is_initialized()
    t0 = time.perf_counter()
    mesh = make_host_mesh(model=1, device="cuda")
    log(f"mesh: (a) make_host_mesh(model=1) on cuda: "
        f"{mesh_descriptor(mesh)} over {dist.get_backend()} in "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        train_cfg = dc.replace(get_config(TRAIN_ARCH),
                               num_layers=MESH_TRAIN["num_layers"])
        times = _mesh_train(mesh, train_cfg, card)
        for a, n in MESH_SERVE.items():
            _mesh_serve(mesh, dc.replace(get_config(a), num_layers=n))
        _mesh_psum(mesh)
        _mesh_record(mesh)
        _mesh_ops(mesh)
        times["slot_write"] = _mesh_slots(card)
    finally:
        if started:     # later phases run with no process group, as before
            dist.destroy_process_group()
    return times


def phase_mesh(state):
    state["mesh_times"] = mesh_checks(_card(state))


# ------------------------------------------------------------- dryrun --
DRYRUN_CELLS = (("train_4k", "multi"), ("decode_32k", "single"))
DRYRUN_LAYERS = 1          # the dry run's qwen2.5-3b: full width, 1 layer
DRYRUN_PREFILL = (4, 512)  # (b): requests x tokens of the real prefill


def _dryrun_cells(out_dir):
    """(a): one ``launch.dryrun`` subprocess a cell, started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for shape, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", "qwen2.5-3b", "--shape", shape, "--mesh", mesh,
               "--layers", str(DRYRUN_LAYERS), "--out", str(out_dir)]
        procs.append((shape, mesh, subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _dryrun_prefill(state):
    """(b): the roofline of a real qwen2.5-3b prefill against its device
    busy time and its peak memory."""
    import torch
    from repro_torch.analysis import cost as C
    from repro_torch.analysis import roofline as RF
    from repro_torch.configs import get_config
    from repro_torch.models import layers as Lyr
    from repro_torch.models import model as M
    from repro_torch.training import steps as ST
    cfg = get_config("qwen2.5-3b")
    B, S = DRYRUN_PREFILL
    params = Lyr.to_tree(M.init_params(cfg, seed=0, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     device="cuda", dtype=torch.int32,
                                     generator=gen)}
    fn = ST.make_prefill_step(cfg, cache_len=S)
    fn(params, batch)                # warm: cuBLAS handles and workspaces
    torch.cuda.synchronize()
    tr = C.trace(fn, (params, batch), mode="fused")
    torch.cuda.synchronize()
    fused, eager = (tr.costs[m].as_dict() for m in ("fused", "eager"))
    analysed = tr.peak_bytes - tr.fresh_out_bytes + C.tree_bytes(tr.out)
    tr = None
    mf = RF.analytic_model_flops(cfg, "prefill", B, S)
    roof = RF.from_hlo(fused, mf, 1)
    roof_eager = RF.from_hlo(eager, mf, 1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(params, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - before
    del out
    wall, busy, _ = _timed(f"dryrun: qwen2.5-3b prefill {B} x {S} "
                           f"({cfg.num_layers} layers)",
                           lambda: fn(params, batch))
    share = roof.step_time * 1e3 / busy
    log(f"dryrun: prefill {B} x {S} roofline (fused bytes): step "
        f"{roof.step_time * 1e3:.4f} ms = max(compute "
        f"{roof.t_compute * 1e3:.4f}, memory {roof.t_memory * 1e3:.4f}) ms, "
        f"{roof.dominant}; flops {fused['flops']:.6g} "
        f"{ {k: float(v) for k, v in fused['flops_by_dtype'].items()} }, "
        f"bytes fused {fused['hbm_bytes']:.6g}, eager "
        f"{eager['hbm_bytes']:.6g} (memory "
        f"{roof_eager.t_memory * 1e3:.4f} ms); measured device busy "
        f"{busy:.4f} ms, wall {wall:.4f} ms: roofline / busy {share:.4f} "
        f"({_card(state)})")
    log(f"dryrun: prefill {B} x {S} memory: analysed temp + out "
        f"{analysed} bytes, measured max_memory_allocated - "
        f"memory_allocated {measured} bytes "
        f"(ratio {analysed / measured:.4f})")
    state["dryrun_prefill"] = dict(roofline=roof.as_dict(), busy_ms=busy,
                                   analysed_bytes=analysed,
                                   measured_bytes=measured)
    if busy < 0.95 * roof.step_time * 1e3:
        raise RuntimeError(f"dryrun: device busy {busy:.4f} ms is below 0.95 "
                           f"of the roofline's {roof.step_time * 1e3:.4f} ms:"
                           " a count is too high")
    if abs(analysed - measured) > 0.10 * measured:
        raise RuntimeError(f"dryrun: analysed temp + out {analysed} bytes "
                           f"is more than 10% from the measured {measured}")


def _dryrun_formulas(state):
    """(c): each kernel row's bytes and operations against cost.py's."""
    rows = state.get("kernel_costs", [])
    if not rows:
        log("dryrun: no kernel rows in this call (phase kernels did not "
            "run): formulas not checked")
        return
    bad = []
    for r in rows:
        same = r["got_bytes"] == r["want_bytes"] and r["got_ops"] is not \
            None and set(r["got_ops"]) == set(r["want_ops"]) and all(
                math.isclose(r["got_ops"][k], v, rel_tol=1e-12)
                for k, v in r["want_ops"].items())
        if not same:
            bad.append(r)
            log(f"dryrun: formula differs: {r}")
    log(f"dryrun: cost.py's formulas equal {len(rows) - len(bad)} of "
        f"{len(rows)} kernel rows' bytes and operations")
    if bad:
        raise RuntimeError(f"dryrun: {len(bad)} kernel rows differ from "
                           f"cost.py's formulas")


def phase_dryrun(state):
    import tempfile
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    t0 = time.perf_counter()
    procs = _dryrun_cells(out_dir)
    try:
        _dryrun_prefill(state)
        _dryrun_formulas(state)
        log(f"dryrun: (b) and (c) in {time.perf_counter() - t0:.1f} s")
        for shape, mesh, p in procs:
            stdout, stderr = p.communicate(timeout=600)
            log(f"dryrun: (a) {shape} on {mesh} ended at "
                f"{time.perf_counter() - t0:.1f} s")
            for line in stdout.splitlines():
                log(f"dryrun: {line}")
            if p.returncode != 0:
                raise RuntimeError(f"dryrun: {shape} on {mesh} exited "
                                   f"{p.returncode}: {stderr[-3000:]}")
            mesh_name = "2x16x16" if mesh == "multi" else "16x16"
            rec = json.loads((out_dir / f"qwen2.5-3b_{shape}_{mesh_name}"
                              ".json").read_text())
            if rec["status"] != "ok":
                raise RuntimeError(f"dryrun: {shape} on {mesh_name}: "
                                   f"{rec.get('error')}")
            log(f"dryrun: {shape} {mesh_name}: per rank flops "
                f"{rec['hlo']['flops']:.6g}, HBM bytes "
                f"{rec['hlo']['hbm_bytes']:.6g}, wire bytes "
                f"{rec['hlo']['coll_bytes']:.6g}, memory "
                f"{rec['bytes_per_device']} bytes, trace "
                f"{rec['t_lower_s']} s; roofline {rec['roofline']}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


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
        # the decode kernel's int8-cache form, with its launches in phase
        # int8's qwen2.5-3b serve
        for k in K.INT8_KERNELS if "int8" in phases else ():
            mod = sys.modules[k.__module__]
            row = state["kernel_rows"][k.__name__]
            summary.append({
                "name": k.__name__, "route": "cuda",
                "source": mod.INT8_SOURCE, "replaces": mod.REPLACES,
                "launches": state["int8_launches"][k.__name__],
                **{key: row[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "case", "sdpa_bf16_ms")}})
        # the backward kernels at the train step's shapes, with their
        # launches in phase train
        for k in K.BACKWARD_KERNELS if "train" in phases else ():
            mod = sys.modules[k.__module__]
            row = state["kernel_rows"][k.__name__]
            summary.append({
                "name": k.__name__, "route": "cuda",
                "source": mod.BACKWARD_SOURCE, "replaces": mod.REPLACES,
                "launches": state["train_launches"][k.__name__],
                **{key: row[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "case")}})
        # the flash backward at MLA's (192, 128), with its launches in
        # phase train's (e)
        modules = {k.__name__: sys.modules[k.__module__]
                   for k in K.BACKWARD_KERNELS}
        for kernel, row in (state.get("moe_kernel_rows", {}).items()
                            if "train" in phases else ()):
            mod = modules[kernel]
            summary.append({
                "name": kernel, "route": "cuda",
                "source": mod.BACKWARD_SOURCE, "replaces": mod.REPLACES,
                "launches": state["moe_train_launches"][kernel],
                **{key: row[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "case")}})
        # the attention kernels at the audio and vlm families' shapes,
        # with their launches at those shapes in phase families
        shapes = state.get("family_shape_launches", {})
        for (kernel, shape), row in state["family_kernel_rows"].items():
            if (kernel, shape) not in shapes:
                continue
            mod = sys.modules[f"repro_torch.kernels.{kernel}"]
            summary.append({
                "name": kernel, "route": "cuda", "source": mod.SOURCE,
                "replaces": mod.REPLACES, "launches": shapes[kernel, shape],
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "case")}})
        print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
