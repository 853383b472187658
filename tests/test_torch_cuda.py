"""The port's CUDA path, on the card only (skipped without one).

This file imports torch and the port, never JAX, so it runs as it is on
a machine with a card and no JAX:

    python -m pytest -q tests/test_torch_cuda.py

Each kernel against its plain version, the wrappers' refusals, the
smoke engines on the card against the same engines on the CPU, and a
registry boot on the card against live serving.  The tests
that the tolerances reject planted faults also run on the CPU, where the
wrappers take their plain versions.
"""
import copy
import dataclasses
import importlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.core.attest import (TamperedRecordingError,  # noqa: E402
                                     TopologyMismatchError)
from repro_torch.api import Workspace  # noqa: E402
from repro_torch.api.workload import recording_name  # noqa: E402
from repro_torch.core.channel import LiveChannel, ReplayChannel  # noqa: E402
from repro_torch.core.replay import Replayer  # noqa: E402
from repro_torch.launch.record import record_kinds  # noqa: E402
from repro_torch.launch.serve import build_engine, stream_kwargs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import MLAConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.training import steps as ST  # noqa: E402

TOL = K.TOLERANCE
FA = importlib.import_module("repro_torch.kernels.flash_attention")
DA = importlib.import_module("repro_torch.kernels.decode_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *s, dt=torch.float32: torch.randn(
        *s, generator=g, device=dev).to(dt)


def _close(a, b, tol):
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal,window", [
    (2, 37, 37, 8, 2, 64, True, 0), (1, 13, 45, 4, 4, 16, True, 0),
    (2, 100, 100, 16, 2, 128, True, 32), (1, 64, 64, 4, 1, 32, False, 0),
])
def test_kernels_match_plain(cuda, dt, B, Sq, Sk, H, Hkv, hd, causal,
                             window):
    rn = _randn(cuda, 0)
    K.reset_launches()
    x, s = rn(B, Sq, H * hd, dt=dt), rn(H * hd) * 0.1 + 1.0
    _close(K.rmsnorm(x, s), K.rmsnorm_plain(x, s), TOL[dt])
    q, k, v = rn(B, Sq, H, hd, dt=dt), rn(B, Sk, Hkv, hd, dt=dt), \
        rn(B, Sk, Hkv, hd, dt=dt)
    _close(K.flash_attention(q, k, v, causal=causal, window=window),
           K.flash_attention_plain(q, k, v, causal=causal, window=window),
           TOL[dt])
    lens = torch.randint(1, Sk + 1, (B,), dtype=torch.int32, device=cuda)
    qd = q[:, 0].contiguous()
    _close(K.decode_attention(qd, k, v, lens),
           K.decode_attention_plain(qd, k, v, lens), TOL[dt])
    torch.cuda.synchronize()
    assert [f.launches for f in K.KERNELS] == [1, 1, 1, 0, 0, 0]
    assert K.flash_attention.by_shape == {(q.shape, k.shape): 1}
    assert K.decode_attention.by_shape == {(qd.shape, k.shape): 1}


def _agree(a, b, tol):
    return torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_tolerance_rejects_planted_faults(request, device, dt):
    """At the main path's shapes, a window one too long fails the check
    in both dtypes and a length one short fails it in fp32 (in bf16 one
    dropped slot among ~600 is within rounding)."""
    dev = request.getfixturevalue("cuda") if device == "cuda" \
        else torch.device("cpu")
    rn = _randn(dev, 2)
    q, k, v = rn(1, 512, 16, 128, dt=dt), rn(1, 512, 2, 128, dt=dt), \
        rn(1, 512, 2, 128, dt=dt)
    want = K.flash_attention_plain(q, k, v, window=128)
    assert _agree(K.flash_attention(q, k, v, window=128), want, TOL[dt])
    assert not _agree(K.flash_attention(q, k, v, window=129), want, TOL[dt])
    lens = torch.tensor([685, 560, 630, 193], dtype=torch.int32, device=dev)
    q, kc, vc = rn(4, 16, 128, dt=dt), rn(4, 1024, 2, 128, dt=dt), \
        rn(4, 1024, 2, 128, dt=dt)
    want = K.decode_attention_plain(q, kc, vc, lens)
    assert _agree(K.decode_attention(q, kc, vc, lens), want, TOL[dt])
    if dt == torch.float32:
        assert not _agree(K.decode_attention(q, kc, vc, lens - 1), want,
                          TOL[dt])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rn = _randn(cuda, 1)
    q, kv = rn(1, 8, 4, 48), rn(1, 8, 2, 48)
    with pytest.raises(ValueError, match="hd=48"):
        K.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="dtype"):
        K.rmsnorm(rn(4, 64, dt=torch.float16), rn(64))
    with pytest.raises(ValueError, match="contiguous"):
        K.rmsnorm(rn(64, 4).T, rn(64))
    with pytest.raises(ValueError, match="16-byte"):
        K.rmsnorm(rn(65)[1:].view(8, 8), rn(8))
    with pytest.raises(ValueError, match="wider"):
        K.rmsnorm(rn(1, 8192 + 8), rn(8192 + 8))
    # the int8-cache form launches its kernel, which agrees with its plain
    # version; the sliding-window ring runs the dense kernel; a group of
    # 7, which no config has, is refused (groups of 6 and 9, mixtral's and
    # starcoder2-7b's, are instantiated)
    q, kc = rn(2, 1, 4, 16), rn(2, 8, 2, 16)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    kq, ks = L.kv_quantize(kc)
    K.reset_launches()
    _close(L.decode_attention(q, kq, kq, pos, k_scale=ks, v_scale=ks)[:, 0],
           K.decode_attention_plain(q[:, 0], kq, kq, pos + 1, k_scale=ks,
                                    v_scale=ks), TOL[torch.float32])
    assert K.decode_attention_int8.launches == 1
    assert K.decode_attention.launches == 0
    with pytest.raises(ValueError, match="scales"):
        K.decode_attention_int8(q[:, 0], kq, kq, pos + 1, ks[:, :4], ks)
    L.decode_attention(q, kc, kc, pos, window=8)
    lens = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="H=14"):
        K.decode_attention(rn(2, 14, 16), kc, kc, lens)


def _int8_cache_inputs(rn, B, H, Hkv, W, hd, dt):
    kq, ks = L.kv_quantize(rn(B, W, Hkv, hd))
    vq, vs = L.kv_quantize(rn(B, W, Hkv, hd))
    return rn(B, H, hd, dt=dt), kq, vq, ks, vs


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
@pytest.mark.parametrize("G", DA.GROUP_SIZES)
def test_int8_decode_kernel_matches_plain(cuda, dt, hd, G):
    """The int8-cache form at every head dim and group size, fp32 and bf16
    q, over lengths that cut a 32-row tile and that reach the end, and
    over a ring (its lengths clamped to W); the planted fault (V scales
    ignored) fails the check."""
    rn = _randn(cuda, hd + G)
    B, Hkv, W = 3, 2, 160
    q, kq, vq, ks, vs = _int8_cache_inputs(rn, B, G * Hkv, Hkv, W, hd, dt)
    K.reset_launches()
    for lens in ([160, 45, 1], [33, 160, 97]):
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        want = K.decode_attention_plain(q, kq, vq, ln, k_scale=ks, v_scale=vs)
        _close(K.decode_attention_int8(q, kq, vq, ln, ks, vs), want, TOL[dt])
        assert not _agree(DA._launch(q, kq, vq, ln, hd ** -0.5, k_scale=ks,
                                     v_scale=vs,
                                     fault=DA.FAULT_IGNORE_V_SCALE),
                          want, TOL[dt])
    # the ring: positions past W wrap, the layer clamps the lengths to W
    pos = torch.tensor([W + 37, W - 1, 20], dtype=torch.int32, device=cuda)
    got = L.decode_attention(q[:, None], kq, vq, pos, window=W, k_scale=ks,
                             v_scale=vs)[:, 0]
    want = K.decode_attention_plain(q, kq, vq, pos + 1, window=W,
                                    k_scale=ks, v_scale=vs)
    _close(got, want, TOL[dt])
    torch.cuda.synchronize()
    assert K.decode_attention_int8.launches == 3
    assert K.decode_attention_int8.by_shape == {(q.shape, kq.shape): 3}
    assert K.decode_attention.launches == 0


def test_int8_decode_kernel_under_a_cuda_graph(cuda):
    """The int8 form captures under a CUDA graph (scratch per call, the
    shared arrival counters) and replays with new inputs copied in, at
    qwen2.5-3b's decode shape, beside a bf16 call on the same stream."""
    rn = _randn(cuda, 3)
    B, H, Hkv, W, hd = 4, 16, 2, 1024, 128
    q, kq, vq, ks, vs = _int8_cache_inputs(rn, B, H, Hkv, W, hd,
                                           torch.bfloat16)
    kc, vc = rn(B, W, Hkv, hd, dt=torch.bfloat16), \
        rn(B, W, Hkv, hd, dt=torch.bfloat16)
    ln = torch.tensor([1024, 700, 33, 5], dtype=torch.int32, device=cuda)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        K.decode_attention_int8(q, kq, vq, ln, ks, vs)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = K.decode_attention_int8(q, kq, vq, ln, ks, vs)
        out16 = K.decode_attention(q, kc, vc, ln)
    for seed in (4, 5):
        rn2 = _randn(cuda, seed)
        q2, kq2, vq2, ks2, vs2 = _int8_cache_inputs(rn2, B, H, Hkv, W, hd,
                                                    torch.bfloat16)
        for dst, src in ((q, q2), (kq, kq2), (vq, vq2), (ks, ks2),
                         (vs, vs2)):
            dst.copy_(src)
        ln.copy_(torch.tensor([seed * 100, 1024, 64, 31], dtype=torch.int32))
        g.replay()
        torch.cuda.synchronize()
        _close(out, K.decode_attention_plain(q, kq, vq, ln, k_scale=ks,
                                             v_scale=vs),
               TOL[torch.bfloat16])
        _close(out16, K.decode_attention_plain(q, kc, vc, ln),
               TOL[torch.bfloat16])


@pytest.mark.parametrize("arch", ["cody-mnist", "qwen2.5-3b",
                                  "starcoder2-7b"])
def test_smoke_engine_on_card_matches_cpu(cuda, arch):
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    cache_len, max_new = 64, 12
    if cfg.sliding_window:
        # the longest request decodes past the ring's W slots, so the card
        # decodes positions after the wrap
        W = min(cache_len, cfg.sliding_window)
        max_new = W + 8 - 13
        assert 13 + max_new > W + 4 and 13 + max_new <= cache_len
    outs, stats = [], []
    # Module.to moves in place: the card gets its own copy
    for dev, p in (("cpu", params), ("cuda", copy.deepcopy(params).to(cuda))):
        K.reset_launches()
        eng = build_engine(cfg, n_slots=2, cache_len=cache_len, block_k=4,
                           params=p, device=dev)
        g = torch.Generator().manual_seed(5)
        for n in (5, 9, 13):
            eng.submit(torch.randint(3, cfg.vocab_size, (n,),
                                     generator=g).tolist(), max_new)
        outs.append(eng.run())
        stats.append(dict(eng.stats))
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    L_, st = cfg.num_layers, stats[1]
    assert K.flash_attention.launches == L_ * st["prefill_dispatches"]
    assert K.decode_attention.launches == L_ * 4 * st["blocks_dispatched"]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_live_channel_puts_host_inputs_on_the_params_device(request, device):
    """A LiveChannel built without a device serves params on either."""
    dev = request.getfixturevalue("cuda") if device == "cuda" \
        else torch.device("cpu")
    cfg = smoke_shrink(get_config("cody-mnist"), dtype="float32")
    params = M.init_params(cfg, seed=0, device=dev)
    ch = LiveChannel(ST.make_prefill_step(cfg, 32),
                     ST.make_fused_decode_step(cfg, k=4),
                     ST.make_batched_prefill_step(cfg, 32))
    out, caches = ch.batched_prefill(params, np.array([[5, 6, 7]], np.int32),
                                     np.array([3], np.int32))
    assert out["next_tokens"].device.type == dev.type
    blk, _ = ch.decode_block(params, out["next_tokens"].cpu().numpy(),
                             np.array([3], np.int32), caches)
    assert blk["tokens"].device.type == dev.type
    assert blk["tokens"].shape == (1, 4)


# the chunk-scan shapes of zamba2-1.2b and xlstm-350m: (Q, nc) for prompts
# of 128, 300 and 1024 tokens and a prime length of 257
SCAN_CASES = [(128, 1), (150, 2), (256, 4), (1, 257)]
SCANS = {"mamba": (K.mamba_chunk_scan, K.mamba_chunk_scan_plain),
         "mlstm": (K.mlstm_chunk_scan, K.mlstm_chunk_scan_plain)}


def _scan_inputs(dev, which, Q, nc):
    rn = _randn(dev, 3)
    bf16 = torch.bfloat16
    if which == "mamba":                 # nh = P = N = 64
        return (rn(1, nc, Q, 64, 64) * 0.5, (rn(1, nc, Q, 64) * 0.5).to(bf16),
                (rn(1, nc, Q, 64) * 0.5).to(bf16),
                torch.cumsum(-rn(1, nc, Q, 64).abs() * 0.1, 2))
    return (*((rn(1, nc, Q, 4, 512) * 512 ** -0.25).to(bf16)  # nh 4, dh 512
              for _ in range(2)), rn(1, nc, Q, 4, 512).to(bf16),
            torch.cumsum(-rn(1, nc, Q, 4).abs() * 0.2, 2),
            torch.clamp_max(rn(1, nc, Q, 4), 8.0))


@pytest.mark.parametrize("Q,nc", SCAN_CASES)
@pytest.mark.parametrize("which", sorted(SCANS))
def test_scans_match_plain(cuda, which, Q, nc):
    """Outputs and final states, all fp32, at the fp32 tolerance."""
    kernel, plain = SCANS[which]
    a = _scan_inputs(cuda, which, Q, nc)
    before = kernel.launches
    got = kernel(*a)
    torch.cuda.synchronize()
    for g, w in zip(got, plain(*a)):
        assert g.dtype == torch.float32
        _close(g, w, TOL[torch.float32])
    assert kernel.launches == before + 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("which", sorted(SCANS))
def test_scan_tolerance_rejects_planted_faults(request, device, which):
    """At two chunks of 150, the state dropped at the chunk boundary and
    a causal mask one off each fail the check the scan passes."""
    dev = request.getfixturevalue("cuda") if device == "cuda" \
        else torch.device("cpu")
    kernel, plain = SCANS[which]
    a = _scan_inputs(dev, which, 150, 2)
    tol = TOL[torch.float32]
    want = plain(*a)[0]
    got = kernel(*a)[0]
    assert _agree(got, want, tol)
    fresh = torch.cat([kernel(*(t[:, c:c + 1].contiguous() for t in a))[0]
                       for c in range(2)], 1)
    assert not _agree(fresh, want, tol)
    assert not _agree(got, plain(*a, diagonal=-1)[0], tol)


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a = _scan_inputs(cuda, "mamba", 4, 2)
    with pytest.raises(ValueError, match="N=65"):
        K.mamba_chunk_scan(a[0], *(torch.cat([t, t[..., :1]], -1)
                                   for t in a[1:3]), a[3])
    with pytest.raises(ValueError, match="dtypes"):
        K.mamba_chunk_scan(a[0].to(torch.bfloat16), *a[1:])
    for shape, what in (((1, 1, 257, 1, 16), "Q=257"),
                        ((1, 1, 4, 1, 520), "dh=520")):
        q = _randn(cuda, 4)(*shape)
        g = q[..., 0].contiguous()
        with pytest.raises(ValueError, match=what):
            K.mlstm_chunk_scan(q, q, q, g, g)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_smoke_engine_on_card_matches_cpu(cuda, arch):
    """Per-request prefill through the scan kernels, speculation off:
    the card's tokens and stats equal the CPU's, and every prefill
    launched one scan per recurrent layer."""
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    outs, stats = [], []
    for dev, p in (("cpu", params), ("cuda", copy.deepcopy(params).to(cuda))):
        K.reset_launches()
        eng = build_engine(cfg, n_slots=2, cache_len=64, block_k=4,
                           params=p, device=dev)
        g = torch.Generator().manual_seed(5)
        for n in (5, 17, 32):                 # one chunk, 17 of 1, two of 16
            eng.submit(torch.randint(3, cfg.vocab_size, (n,),
                                     generator=g).tolist(), 12)
        outs.append(eng.run())
        stats.append(dict(eng.stats))
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    pd = stats[1]["prefill_dispatches"]
    if cfg.family == "hybrid":
        assert K.mamba_chunk_scan.launches == cfg.num_layers * pd
    else:
        assert K.mlstm_chunk_scan.launches == 5 * (cfg.num_layers // 6) * pd


# moe_gmm at deepseek-v2-lite-16b's shapes (E = 64, D = 2048, F = 1408):
# decode (C = 6) for w1/w3 and w2, a prefill bucket of 65 to 128 tokens
# (C = 12 or 16: the 16-row tile), a 256-token prefill (C = 32); the
# edges of the bf16 kernel's row tiles (R = 1, 8, 9, 64, 65) and a D of
# 1400, off its ring's step; and ragged ones (C, D, F not multiples of
# the tiles; rows not 16-byte aligned; more rows than one row tile)
GMM_CASES = [(64, 6, 2048, 1408), (64, 6, 1408, 2048),
             (64, 12, 2048, 1408), (64, 12, 1408, 2048),
             (64, 16, 2048, 1408), (64, 16, 1408, 2048), (64, 32, 2048, 1408),
             (64, 1, 2048, 1408), (64, 8, 2048, 1408), (64, 9, 2048, 1408),
             (64, 64, 2048, 1408), (64, 65, 2048, 1408), (64, 6, 1400, 1408),
             (3, 37, 200, 72), (3, 5, 131, 67), (2, 150, 96, 64)]


def _gmm_inputs(dev, E, C, D, F, dt, seed=5):
    rn = _randn(dev, seed)
    return (rn(E, C, D) * D ** -0.5).to(dt), rn(E, D, F, dt=dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", GMM_CASES)
def test_moe_gmm_matches_plain(cuda, dt, E, C, D, F):
    x, w = _gmm_inputs(cuda, E, C, D, F, dt)
    before = K.moe_gmm.launches
    got = K.moe_gmm(x, w)
    again = K.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (E, C, F)
    _close(got, K.moe_gmm_plain(x, w), TOL[dt])
    assert torch.equal(got, again)            # fixed order, no atomics
    assert K.moe_gmm.launches == before + 2


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [4, 512])
def test_rmsnorm_at_kv_norm_width_matches_plain(cuda, dt, rows):
    """MLA's kv_norm at width 512: a decode step's 4 rows and a 512-token
    prefill's (64 threads a row in bf16, 128 in fp32)."""
    rn = _randn(cuda, 7)
    x, s = rn(rows, 512, dt=dt), rn(512) * 0.1 + 1.0
    before = K.rmsnorm.launches
    got = K.rmsnorm(x, s)
    torch.cuda.synchronize()
    _close(got, K.rmsnorm_plain(x, s), TOL[dt])
    assert K.rmsnorm.launches == before + 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_moe_gmm_tolerance_rejects_planted_faults(request, device):
    """In fp32, the last 64-deep D tile left out of the sum and expert e
    reading expert e+1's weights each fail the check the kernel passes:
    at a deepseek decode shape on the card, at a narrower one on the CPU
    (the plain version's fp32 copy of w would take ~1.5 GB there)."""
    dev = request.getfixturevalue("cuda") if device == "cuda" \
        else torch.device("cpu")
    shape = (64, 6, 2048, 1408) if device == "cuda" else (8, 6, 256, 128)
    x, w = _gmm_inputs(dev, *shape, torch.float32)
    tol = TOL[torch.float32]
    want = K.moe_gmm_plain(x, w)
    assert _agree(K.moe_gmm(x, w), want, tol)
    short = K.moe_gmm(x[..., :-64].contiguous(), w[:, :-64].contiguous())
    assert not _agree(short, want, tol)
    assert not _agree(K.moe_gmm(x, torch.roll(w, -1, 0)), want, tol)


@pytest.mark.parametrize("C", [6, 12])
def test_moe_gmm_tolerance_rejects_the_redesigns_planted_faults(cuda, C):
    """bf16, at the decode shape (the mma.sync kernel) and at C = 12 (the
    wgmma kernel): every w stage of the ring holding the step before's
    tile (what a stage consumed one step early holds), the plan one work
    item short, and the last 8-row group of R dropped each fail the check
    that the kernel passes."""
    MG = importlib.import_module("repro_torch.kernels.moe_gmm")
    tol = TOL[torch.bfloat16]
    x, w = _gmm_inputs(cuda, 64, C, 2048, 1408, torch.bfloat16)
    want = K.moe_gmm_plain(x, w)
    plan = MG.plan_gmm(64, C, 2048, 1408, _build.sm_count(cuda))
    assert _agree(MG._launch(x, w, plan), want, tol)
    assert not _agree(MG._launch(x, w, fault=MG.FAULT_STALE_TILE), want, tol)
    assert not _agree(MG._launch(x, w, plan._replace(items=plan.items - 1)),
                      want, tol)
    assert not _agree(MG._launch(x, w, fault=MG.FAULT_DROP_ROW_GROUP), want,
                      tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 4, 300, 2048])
@pytest.mark.parametrize("D", [1024, 2048, 4096, 8192])
def test_rmsnorm_widths_and_rows_match_plain(cuda, dt, rows, D):
    """Both paths of the kernel (a warp per row up to 2 KB, a block per
    row above) at the widths of the configs, from a decode step's rows to
    a prefill's; one launch each."""
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    rn = _randn(cuda, 9)
    x, s = rn(rows, D, dt=dt), rn(D) * 0.1 + 1.0
    before = K.rmsnorm.launches
    got = K.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert K.rmsnorm.launches == before + 1
    _close(got, K.rmsnorm_plain(x, s), TOL[dt])
    assert torch.equal(got, K.rmsnorm(x, s))
    plan = RN.plan_rmsnorm(rows, D, x.element_size(), _build.sm_count(cuda))
    assert plan.per_warp == (D * x.element_size() <= RN.WARP_ROW_BYTES)


@pytest.mark.parametrize("rows,D", [(4, 2048), (2048, 8192)])
def test_rmsnorm_tolerance_rejects_its_planted_fault(cuda, rows, D):
    """fp32 rows held by a block: the sum of squares taken over the first
    warp's share of a row alone fails the check."""
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    rn = _randn(cuda, 10)
    x, s = rn(rows, D), rn(D) * 0.1 + 1.0
    want = K.rmsnorm_plain(x, s)
    assert not RN.plan_rmsnorm(rows, D, 4, _build.sm_count(cuda)).per_warp
    assert _agree(RN._launch(x, s, 1e-5), want, TOL[torch.float32])
    assert not _agree(RN._launch(x, s, 1e-5,
                                 fault=RN.FAULT_FIRST_WARP_ONLY),
                      want, TOL[torch.float32])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [256, 37])
def test_flash_at_mla_head_dims_matches_plain(cuda, dt, S):
    """MLA prefill: q, k at hd 192 (128 + 64 rope), v at hd_v 128, 16
    heads; the scale is 192 ** -0.5, and one taken from hd_v fails."""
    rn = _randn(cuda, 6)
    q, k, v = rn(1, S, 16, 192, dt=dt), rn(1, S, 16, 192, dt=dt), \
        rn(1, S, 16, 128, dt=dt)
    got = K.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.shape == (1, S, 16, 128)
    want = K.flash_attention_plain(q, k, v, causal=True)
    _close(got, want, TOL[dt])
    assert not _agree(K.flash_attention(q, k, v, causal=True,
                                        scale=128 ** -0.5), want, TOL[dt])


def test_moe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rn = _randn(cuda, 7)
    x, w = rn(2, 4, 16), rn(2, 16, 8)
    with pytest.raises(ValueError, match="dtypes"):
        K.moe_gmm(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        K.moe_gmm(x, rn(2, 12, 8))
    with pytest.raises(ValueError, match="contiguous"):
        K.moe_gmm(x, rn(2, 8, 16).transpose(1, 2))
    q = rn(1, 8, 2, 192)
    with pytest.raises(ValueError, match="hd=192, hd_v=192"):
        K.flash_attention(q, q, q)


def test_deepseek_smoke_engine_on_card_matches_cpu(cuda):
    """The moe family through the serving stack at smoke widths, with MLA
    head dims the flash kernel takes (hd 32 = 16 + 16 rope, hd_v 32):
    batched prefill and speculation on, the card's tokens and stats equal
    the CPU's, and every prefill dispatch and decode step launched one
    moe_gmm per expert product."""
    cfg = smoke_shrink(get_config("deepseek-v2-lite-16b"), dtype="float32")
    cfg = dataclasses.replace(cfg, mla=MLAConfig(
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
        v_head_dim=32))
    params = M.init_params(cfg, seed=0, device="cpu")
    outs, stats = [], []
    for dev, p in (("cpu", params), ("cuda", copy.deepcopy(params).to(cuda))):
        K.reset_launches()
        eng = build_engine(cfg, n_slots=2, cache_len=64, block_k=4,
                           params=p, device=dev)
        g = torch.Generator().manual_seed(5)
        for n in (5, 9, 13, 30):
            eng.submit(torch.randint(3, cfg.vocab_size, (n,),
                                     generator=g).tolist(), 12)
        outs.append(eng.run())
        stats.append(dict(eng.stats))
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    steps = stats[1]["prefill_dispatches"] + 4 * stats[1]["blocks_dispatched"]
    assert K.moe_gmm.launches == 3 * (cfg.num_layers - 1) * steps
    assert K.flash_attention.launches == \
        cfg.num_layers * stats[1]["prefill_dispatches"]
    assert K.decode_attention.launches == 0


# the redesigned attention kernels: lengths around the 16-row warp tile
# and the 64-key tile (flash), and around a split boundary (decode)
FLASH_SWEEP_S = [1, 15, 16, 17, 63, 64, 65, 300, 512]
FLASH_SWEEP_G = [1, 2, 8, 16]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,hd_v", FA.HEAD_DIM_PAIRS)
def test_flash_sweep_matches_plain(cuda, dt, hd, hd_v):
    """Causal, Sq = Sk, every group size at every length of the sweep."""
    rn = _randn(cuda, 8)
    for G in FLASH_SWEEP_G:
        for S in FLASH_SWEEP_S:
            q = rn(1, S, G, hd, dt=dt)
            k, v = rn(1, S, 1, hd, dt=dt), rn(1, S, 1, hd_v, dt=dt)
            _close(K.flash_attention(q, k, v),
                   K.flash_attention_plain(q, k, v), TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,window", [
    (4, 65, 65, 8, 2, 64, 0),           # B = 4
    (1, 37, 300, 16, 2, 128, 0),        # Sq < Sk: q_offset = 263
    (2, 300, 300, 8, 1, 64, 24), (1, 512, 512, 16, 2, 128, 24),
    (1, 512, 512, 16, 2, 128, 128), (4, 100, 100, 16, 1, 192, 128)])
def test_flash_batches_offsets_and_windows_match_plain(cuda, dt, B, Sq, Sk,
                                                       H, Hkv, hd, window):
    rn = _randn(cuda, 9)
    hd_v = 128 if hd == 192 else hd
    q, k, v = rn(B, Sq, H, hd, dt=dt), rn(B, Sk, Hkv, hd, dt=dt), \
        rn(B, Sk, Hkv, hd_v, dt=dt)
    _close(K.flash_attention(q, k, v, window=window),
           K.flash_attention_plain(q, k, v, window=window), TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_decode_sweep_matches_plain(cuda, dt, hd):
    """Every group size, W in {64, 1024, 4096}, B in {1, 4}, lengths 1,
    a split boundary - 1, the boundary, boundary + 1 and W; a second
    call gives the same bits (the merge runs in split order)."""
    rn = _randn(cuda, 10)
    for G in DA.GROUP_SIZES:
        for W in (64, 1024, 4096):
            for B in (1, 4):
                plan = DA.plan_splits(B, 2, W, _build.sm_count(cuda))
                c = plan.chunk
                lens = sorted({1, max(1, c - 1), min(W, c), min(W, c + 1), W})
                sets = [[x] for x in lens] if B == 1 else \
                    [[lens[0], lens[-3], lens[-2], lens[-1]]]
                q = rn(B, 2 * G, hd, dt=dt)
                kc, vc = rn(B, W, 2, hd, dt=dt), rn(B, W, 2, hd, dt=dt)
                for ls in sets:
                    ln = torch.tensor(ls, dtype=torch.int32, device=cuda)
                    got = K.decode_attention(q, kc, vc, ln)
                    _close(got, K.decode_attention_plain(q, kc, vc, ln),
                           TOL[dt])
                    assert torch.equal(got, K.decode_attention(q, kc, vc, ln))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_tolerance_rejects_the_redesigns_planted_faults(cuda, dt):
    """At the main path's shapes: the causal tile skip one tile short
    fails the check in both dtypes; the last split's partial state
    dropped, at lengths that put one slot in it, fails it in fp32 (in
    bf16 one slot among 961 is within rounding)."""
    rn = _randn(cuda, 12)
    q, k, v = rn(1, 512, 16, 128, dt=dt), rn(1, 512, 2, 128, dt=dt), \
        rn(1, 512, 2, 128, dt=dt)
    want = K.flash_attention_plain(q, k, v)
    assert _agree(FA._launch(q, k, v, True, 0, 128 ** -0.5, 0), want, TOL[dt])
    assert not _agree(FA._launch(q, k, v, True, 0, 128 ** -0.5, 0,
                                 short_tiles=1), want, TOL[dt])
    plan = DA.plan_splits(4, 2, 1024, _build.sm_count(cuda))
    assert plan.splits * 4 * 2 >= 128
    ln = torch.full((4,), (plan.splits - 1) * plan.chunk + 1,
                    dtype=torch.int32, device=cuda)
    q, kc, vc = rn(4, 16, 128, dt=dt), rn(4, 1024, 2, 128, dt=dt), \
        rn(4, 1024, 2, 128, dt=dt)
    want = K.decode_attention_plain(q, kc, vc, ln)
    assert _agree(DA._launch(q, kc, vc, ln, 128 ** -0.5), want, TOL[dt])
    if dt == torch.float32:
        short = DA.SplitPlan(plan.splits - 1, plan.chunk)
        assert not _agree(DA._launch(q, kc, vc, ln, 128 ** -0.5, short),
                          want, TOL[dt])


# the shapes the audio and vlm families give the attention kernels:
# phi-3-vision's head dim 96 (G = 1) and whisper's 1,500 encoder frames
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,hd,causal", [
    (1, 704, 704, 4, 96, True),          # phi-3 prefill: 576 image + 128
    (2, 1500, 1500, 4, 64, False),       # whisper encoder, bidirectional
    (2, 48, 1500, 20, 64, False),        # whisper cross-attention
    (1, 100, 100, 2, 96, False)])
def test_flash_at_the_families_shapes_matches_plain(cuda, dt, B, Sq, Sk, H,
                                                    hd, causal):
    """... and, not causal, q_offset does not matter (the cross-attention
    takes the default Sk - Sq, the reference's chunked_attention 0)."""
    rn = _randn(cuda, 15)
    q, k, v = rn(B, Sq, H, hd, dt=dt), rn(B, Sk, H, hd, dt=dt), \
        rn(B, Sk, H, hd, dt=dt)
    got = K.flash_attention(q, k, v, causal=causal)
    _close(got, K.flash_attention_plain(q, k, v, causal=causal), TOL[dt])
    if not causal:
        assert torch.equal(got, K.flash_attention(q, k, v, causal=False,
                                                  q_offset=0))
    if causal:   # planted: the causal tile skip one tile short
        assert not _agree(FA._launch(q, k, v, True, 0, hd ** -0.5, 0,
                                     short_tiles=1),
                          K.flash_attention_plain(q, k, v), TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,W,hd,lens", [
    (4, 36, 4, 1024, 128, [1, 300, 777, 1024]),   # starcoder2-7b: G = 9
    (4, 48, 8, 1024, 128, [1, 300, 777, 1024]),   # mixtral-8x22b: G = 6
    (4, 32, 32, 1024, 96, [1, 577, 704, 1024]),   # phi-3: 576 image + text
    (2, 20, 20, 1500, 64, [1500, 1500]),          # whisper's cross cache
    (2, 20, 20, 1500, 64, [1409, 1499])])         # ... its ragged last split
def test_decode_groups_of_9_and_6_match_plain(cuda, dt, B, H, Hkv, W, hd,
                                              lens):
    """starcoder2-7b's group of 9 and mixtral-8x22b's of 6 at hd 128, which
    do not divide the kernel's block, and the families' G = 1 at hd 96
    and over W = 1,500, which is no multiple of the split (its last chunk
    is ragged).  The last head dropped (what the truncating DV of the
    kernel before them left unwritten) fails, and in fp32 so does the
    last split's partial dropped where that split is ragged."""
    rn = _randn(cuda, 14)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q, kc, vc = rn(B, H, hd, dt=dt), rn(B, W, Hkv, hd, dt=dt), \
        rn(B, W, Hkv, hd, dt=dt)
    want = K.decode_attention_plain(q, kc, vc, ln)
    got = K.decode_attention(q, kc, vc, ln)
    _close(got, want, TOL[dt])
    assert torch.equal(got, K.decode_attention(q, kc, vc, ln))
    assert not _agree(DA._launch(q, kc, vc, ln, hd ** -0.5,
                                 fault=DA.FAULT_DROP_LAST_HEAD), want, TOL[dt])
    plan = DA.plan_splits(B, Hkv, W, _build.sm_count(cuda))
    if dt == torch.float32 and W % plan.chunk and max(lens) == W:
        short = DA.SplitPlan(plan.splits - 1, plan.chunk)
        assert not _agree(DA._launch(q, kc, vc, ln, hd ** -0.5, short),
                          want, TOL[dt])


KEY = b"card-replay-key"


def _served(eng, vocab, n=3, max_new=24):
    g = torch.Generator().manual_seed(9)
    for _ in range(n):
        eng.submit(torch.randint(3, vocab, (eng.fixed_prompt_len,),
                                 generator=g).tolist(), max_new)
    return eng.run(), dict(eng.stats)


def _replay_engine(cfg, params, d, dev):
    """An unwarmed replay Engine over the recordings in ``d``, built as
    phase ``replay`` of chip_smoke.py builds it."""
    rp = Replayer(key=KEY, device=dev)
    pre, dec = (rp.load(os.path.join(d, recording_name(cfg.name, kind)))
                for kind in ("prefill", "decode"))
    return Engine(L.to_tree(params), channel=ReplayChannel(rp, pre, dec),
                  **stream_kwargs(cfg, n_slots=2, cache_len=64, block_k=4,
                                  eos_id=2, pipeline_depth=4, device=dev))


@pytest.mark.parametrize("arch", ["cody-mnist", "qwen2.5-3b"])
def test_smoke_replay_on_card_matches_cpu(cuda, arch, tmp_path):
    """Recorded and replayed at smoke width on each device: the card's
    tokens equal the CPU's, eagerly and through the decode block's CUDA
    graph, with up to 4 blocks in flight (each block's outputs are read
    after later replays).  The graph reads the caller's params in place
    (captured once, though each Engine takes its own tree of them), and
    replays right after an eager decode_attention outgrew the counter
    buffer it was captured on."""
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    runs = {}
    for dev, p in (("cpu", params), ("cuda", copy.deepcopy(params).to(cuda))):
        d = str(tmp_path / dev)
        record_kinds(cfg, out=d, key=KEY, cache_len=64, block_k=4, batch=2,
                     seq=8, params=p, device=dev)
        runs[dev, "eager"] = _served(_replay_engine(cfg, p, d, dev),
                                     cfg.vocab_size)
    eng = build_engine(cfg, n_slots=2, cache_len=64, block_k=4, params=p,
                       device=cuda, recordings_dir=d, key=KEY,
                       pipeline_depth=4)
    runs["cuda", "graph"] = _served(eng, cfg.vocab_size)
    rp = eng.channel.replayer
    assert rp.stats["captures"] == 1
    assert rp.stats["graph_replays"] == \
        runs["cuda", "graph"][1]["blocks_dispatched"]
    here = torch.zeros(1, device=cuda).device       # with its index
    before = DA._counters(here, 0).numel()
    B, rn = before // 8 + 1, _randn(cuda, 15)
    K.decode_attention(rn(B, 8, 64), rn(B, 32, 8, 64), rn(B, 32, 8, 64),
                       torch.full((B,), 32, dtype=torch.int32, device=cuda))
    assert DA._counters(here, 0).numel() > before
    again = Engine(L.to_tree(p), channel=eng.channel, **stream_kwargs(
        cfg, n_slots=2, cache_len=64, block_k=4, eos_id=2, pipeline_depth=4,
        device=cuda))
    runs["cuda", "graph again"] = _served(again, cfg.vocab_size)
    assert rp.stats["captures"] == 1
    assert runs["cuda", "graph"][1]["spec_blocks"] > 0
    assert runs["cuda", "eager"] == runs["cpu", "eager"]
    assert runs["cuda", "graph"] == runs["cuda", "eager"]
    assert runs["cuda", "graph again"] == runs["cuda", "eager"]


def test_tampered_recordings_are_refused_on_the_card(cuda, tmp_path,
                                                     monkeypatch):
    cfg = smoke_shrink(get_config("cody-mnist"), dtype="float32")
    recs = {dev: record_kinds(cfg, ("decode",), out=str(tmp_path / dev),
                              key=KEY, cache_len=32, block_k=2, batch=2,
                              seq=8, device=dev)["decode"][0]
            for dev in ("cpu", "cuda")}
    blob = open(recs["cuda"], "rb").read()

    def refuse(*a, **k):
        raise AssertionError("torch.export.load reached")
    monkeypatch.setattr(torch.export, "load", refuse)
    for off in (10, len(blob) // 2, len(blob) - 20):
        bad = bytearray(blob)
        bad[off] ^= 0x5A
        with pytest.raises(TamperedRecordingError):
            Replayer(key=KEY, device=cuda).load(bytes(bad))
    with pytest.raises(TamperedRecordingError):
        Replayer(key=b"wrong", device=cuda).load(blob)
    with pytest.raises(TopologyMismatchError):      # made on the CPU
        Replayer(key=KEY, device=cuda).load(recs["cpu"])


REG_SHAPES = dict(cache_len=64, block_k=4, batch=2, prefill_batch=1, seq=8)


def _published(cfg, root, dev):
    """cody-mnist smoke recorded on ``dev`` by a cloud workspace and
    published into the registry at ``root``."""
    cloud = Workspace(registry=root, key=KEY, net="wifi", device=dev)
    wl = cloud.workload(cfg, **REG_SHAPES)
    for kind in ("prefill", "decode"):
        wl.publish(wl.record(kind))
    return cloud, wl


def test_registry_boot_on_the_card_matches_live(cuda, tmp_path):
    """A fresh TEE workspace boots ``wl.engine()`` from the registry
    (fetch, HMAC and proofs verified, preload, warm): both programs are
    captured as CUDA graphs at their first execute, and the tokens and
    host syncs equal live serving's with the same per-request prefill."""
    cfg = smoke_shrink(get_config("cody-mnist"), dtype="float32")
    root = str(tmp_path / "reg")
    _published(cfg, root, cuda)
    tee = Workspace(registry=root, key=KEY, net="wifi", device=cuda)
    twl = tee.workload(cfg, **REG_SHAPES)
    params = twl.params(0)
    eng = twl.engine(params=params)
    got = _served(eng, cfg.vocab_size)
    rp = eng.channel.replayer
    assert rp.stats["captures"] == 2
    assert rp.stats["graph_replays"] == \
        got[1]["prefill_dispatches"] + got[1]["blocks_dispatched"]
    assert tee.client.stats["proofs_verified"] == 2
    live = twl.engine(params=params, channel=LiveChannel(
        ST.make_prefill_step(cfg, 64), ST.make_fused_decode_step(cfg, k=4),
        fixed_prompt_len=REG_SHAPES["seq"]))
    want = _served(live, cfg.vocab_size)
    assert got[0] == want[0]
    assert got[1]["host_syncs"] == want[1]["host_syncs"]


def test_a_tampered_registry_chunk_is_refused_before_load(cuda, tmp_path,
                                                          monkeypatch):
    cfg = smoke_shrink(get_config("cody-mnist"), dtype="float32")
    root = tmp_path / "reg"
    cloud, wl = _published(cfg, str(root), cuda)
    c = [c for c in cloud.store.entry(wl.key("decode"))["chunks"]
         if c["part"].startswith("payload/")][-1]
    path = root / "chunks" / c["d"][:2] / c["d"]
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x5A
    path.write_bytes(bytes(blob))

    def refuse(*a, **k):
        raise AssertionError("torch.export.load reached")
    monkeypatch.setattr(torch.export, "load", refuse)
    tee = Workspace(registry=str(root), key=KEY, net="wifi", device=cuda)
    with pytest.raises(TamperedRecordingError):
        tee.workload(cfg, **REG_SHAPES).engine()


def _pool_stats_sans_boot(pool):
    """Pool stats less every key naming ``boot`` (a registry replica's
    boot bills its fetched bytes, and an export on the card is not the
    CPU's byte for byte)."""
    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items() if "boot" not in k}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj
    return strip(pool.stats())


@pytest.mark.parametrize("source", ["live", "registry"])
def test_smoke_fleet_on_card_matches_cpu(cuda, source, tmp_path):
    """A 2-replica qwen2.5-3b smoke fleet on the card (live steps, or
    booted from a registry: each replica its own client and Replayer,
    both programs captured as CUDA graphs over the shared params) serves
    open-loop traffic with the tokens and pool stats of the same fleet on
    the CPU with the same weights."""
    from repro_torch.fleet import OpenLoopTraffic, TenantMix
    cfg = smoke_shrink(get_config("qwen2.5-3b"), dtype="float32")
    spaces = {}
    for dev in (cuda, torch.device("cpu")):
        if source == "registry":     # each device replays its own export
            root = str(tmp_path / dev.type)
            _published(cfg, root, dev)
            spaces[dev.type] = Workspace(registry=root, key=KEY, net="wifi",
                                         device=dev)
        else:
            spaces[dev.type] = Workspace(net="wifi", device=dev)
    cpu = spaces["cpu"].workload(cfg, **REG_SHAPES)
    wl = spaces["cuda"].workload(cfg, **REG_SHAPES)
    wl._params[0] = copy.deepcopy(cpu.params(0)).to(cuda)
    arrivals = OpenLoopTraffic(
        [TenantMix(cfg.name, 10.0, prompt_len=REG_SHAPES["seq"],
                   max_new=(4, 12), vocab=cfg.vocab_size)], seed=3,
        burst_every_s=1.0, burst_len_s=0.25, burst_x=4.0).generate(1.0)
    got = []
    for w in (wl, cpu):
        pool, _ = w.ws.fleet([w], replicas=2, policy="least_loaded",
                             name="card")
        got.append((pool, pool.run(arrivals)))
    (pool, outs), (cpool, couts) = got
    assert len(outs) == len(arrivals) and not pool.failed
    assert outs == couts
    assert _pool_stats_sans_boot(pool) == _pool_stats_sans_boot(cpool)
    assert all(r.served > 0 for r in pool.replicas)
    if source == "registry":
        for r in pool.replicas:
            ex = r.scheduler.streams[cfg.name]
            rp = ex.channel.replayer
            assert rp.stats["captures"] == 2
            assert rp.stats["graph_replays"] == \
                ex.stats["prefill_dispatches"] + ex.stats["blocks_dispatched"]
        assert len({id(r.scheduler.streams[cfg.name].channel.replayer)
                    for r in pool.replicas}) == 2


# ---------------------------------------------------------- backwards ----
# (100, 2048): fewer rows than SMs (a row a block); (1029, 2048): rows
# that do not divide the plan's 8 a block (the last block's 5 rows in
# groups of 4 and 1)
RMS_BWD_CASES = [(4, 2048), (1024, 2048), (300, 96), (300, 3072), (16, 8192),
                 (100, 2048), (1029, 2048)]
FLASH_BWD_CASES = [  # B, Sq, Sk, H, Hkv, hd, causal, window, q_offset
    (2, 128, 128, 16, 2, 128, True, 0, None),
    (1, 70, 90, 4, 1, 96, True, 24, None),
    (2, 40, 40, 4, 4, 64, False, 0, None),
    # the qwen2.5-3b train step (G = 8 in 4 splits of 2) and zamba2-1.2b's
    # shared attention (G = 1)
    (8, 128, 128, 16, 2, 128, True, 0, None),
    (8, 128, 128, 32, 32, 64, True, 0, None),
    # G = 3 in 2 splits, the last of one head
    (8, 128, 128, 12, 4, 64, True, 0, None)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D", RMS_BWD_CASES)
def test_rmsnorm_backward_matches_plain(cuda, dt, rows, D):
    """Both gradients against the plain backward; one counted run (two
    launches); identical bits on a second run (no atomics)."""
    rn = _randn(cuda, 11)
    x, s, g = rn(rows, D, dt=dt), rn(D) * 0.1 + 1.0, rn(rows, D, dt=dt)
    before = K.rmsnorm_backward.launches
    dx, ds = K.rmsnorm_backward(x, s, g)
    torch.cuda.synchronize()
    assert K.rmsnorm_backward.launches == before + 1
    wdx, wds = K.rmsnorm_backward_plain(x, s, g)
    assert dx.dtype == dt and ds.dtype == torch.float32
    _close(dx, wdx, TOL[dt])
    # dscale sums `rows` terms of x's rounding: relative, by the sum's size
    _close(ds / rows ** 0.5, wds / rows ** 0.5, TOL[dt])
    dx2, ds2 = K.rmsnorm_backward(x, s, g)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_backward_matches_plain(cuda, dt, case):
    B, Sq, Sk, H, Hkv, hd, causal, window, q_offset = case
    rn = _randn(cuda, 12)
    q, k, v = rn(B, Sq, H, hd, dt=dt), rn(B, Sk, Hkv, hd, dt=dt), \
        rn(B, Sk, Hkv, hd, dt=dt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = K.flash_attention(q, k, v, **kw)
    dout = rn(B, Sq, H, hd, dt=dt)
    before = K.flash_attention_backward.launches
    got = K.flash_attention_backward(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert K.flash_attention_backward.launches == before + 1
    want = K.flash_attention_backward_plain(q, k, v, out, dout, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dt
        _close(a, b, TOL[dt])
    again = K.flash_attention_backward(q, k, v, out, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_flash_backward_sweep_matches_plain(cuda, dt, hd):
    """Every head dim at ragged tiles (37 rows, 70 keys), a group of 4, a
    cross shape (13 queries over 100 keys, bidirectional), an explicit
    q_offset with a window, and end-aligned causal Sq < Sk."""
    rn = _randn(cuda, 15)
    for B, Sq, Sk, H, Hkv, causal, window, q_offset in (
            (2, 37, 37, 4, 1, True, 0, None), (1, 70, 70, 8, 2, True, 0, None),
            (2, 13, 100, 4, 4, False, 0, None), (1, 40, 90, 4, 2, True, 16, 45),
            (1, 20, 130, 2, 2, True, 0, None)):
        q, k, v = rn(B, Sq, H, hd, dt=dt), rn(B, Sk, Hkv, hd, dt=dt), \
            rn(B, Sk, Hkv, hd, dt=dt)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out = K.flash_attention(q, k, v, **kw)
        dout = rn(B, Sq, H, hd, dt=dt)
        got = K.flash_attention_backward(q, k, v, out, dout, **kw)
        want = K.flash_attention_backward_plain(q, k, v, out, dout, **kw)
        for a, b in zip(got, want):
            _close(a, b, TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_backward_every_split_matches_plain(cuda, dt):
    """qwen2.5-3b's train step under every split of its group of 8 (1, 2,
    4 and 8 blocks, a cluster each; 3 splits of 3, 3 and 2 heads): each
    within the limit, each bit-equal on a second run."""
    rn = _randn(cuda, 16)
    q, k, v = rn(8, 128, 16, 128, dt=dt), rn(8, 128, 2, 128, dt=dt), \
        rn(8, 128, 2, 128, dt=dt)
    out = K.flash_attention(q, k, v)
    dout = rn(8, 128, 16, 128, dt=dt)
    want = K.flash_attention_backward_plain(q, k, v, out, dout)
    for hp in (8, 4, 3, 2, 1):
        plan = FA.FlashBackwardPlan(hp, -(-8 // hp))
        got = FA._launch_backward(q, k, v, out, dout, True, 0, 128 ** -0.5,
                                  0, plan=plan)
        for a, b in zip(got, want):
            _close(a, b, TOL[dt])
        again = FA._launch_backward(q, k, v, out, dout, True, 0,
                                    128 ** -0.5, 0, plan=plan)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), plan


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_every_group_matches_plain(cuda, dt):
    """[1024, 2048] by blocks of 1 to 16 rows in groups of 1 to 8 (the
    partial rows 1,024 down to 64; the ring within 128 KB): each within
    the limit."""
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    rn = _randn(cuda, 17)
    x, s, g = rn(1024, 2048, dt=dt), rn(2048) * 0.1 + 1.0, \
        rn(1024, 2048, dt=dt)
    wdx, wds = K.rmsnorm_backward_plain(x, s, g)
    groups = ((1, 1), (2, 2), (8, 2), (8, 4), (16, 4)) + (
        ((8, 8), (16, 8)) if dt == torch.bfloat16 else ())
    for chunk, group in groups:
        plan = RN.NormBackwardPlan(256, 1024 // chunk, chunk, group, 16)
        dx, ds = RN._launch_backward(x, s, g, 1e-5, plan=plan)
        _close(dx, wdx, TOL[dt])
        _close(ds / 32, wds / 32, TOL[dt])


def test_backward_tolerance_rejects_planted_faults(cuda):
    """One K tile short in the flash backward's launch A, and an rmsnorm
    row's sums over its first warp's share, fail the checks."""
    FA_ = importlib.import_module("repro_torch.kernels.flash_attention")
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    rn = _randn(cuda, 13)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = rn(2, 128, 16, 128, dt=dt), rn(2, 128, 2, 128, dt=dt), \
            rn(2, 128, 2, 128, dt=dt)
        out = K.flash_attention(q, k, v)
        dout = rn(2, 128, 16, 128, dt=dt)
        scale = 128 ** -0.5
        want = K.flash_attention_backward_plain(q, k, v, out, dout)
        bad = FA_._launch_backward(q, k, v, out, dout, True, 0, scale, 0,
                                   short_tiles=1)
        assert not all(_agree(a, b, TOL[dt]) for a, b in zip(bad, want))
        x, s, g = rn(64, 2048, dt=dt), rn(2048) * 0.1 + 1.0, \
            rn(64, 2048, dt=dt)
        wdx, _ = K.rmsnorm_backward_plain(x, s, g)
        dx, _ = RN._launch_backward(x, s, g, 1e-5,
                                    fault=RN.FAULT_FIRST_WARP_ONLY)
        assert not _agree(dx, wdx, TOL[dt])


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rn = _randn(cuda, 14)
    q, k, v = rn(1, 8, 4, 192), rn(1, 8, 4, 192), rn(1, 8, 4, 64)
    with pytest.raises(ValueError, match="not in"):
        K.flash_attention_backward(q, k, v, rn(1, 8, 4, 64), rn(1, 8, 4, 64))
    # (192, 128) with a group of 2: launch B splits only where hd_v = hd
    q, k, v = rn(1, 8, 4, 192), rn(1, 8, 2, 192), rn(1, 8, 2, 128)
    plan = FA.FlashBackwardPlan(1, 2)
    with pytest.raises(ValueError, match="only where hd_v = hd"):
        FA._launch_backward(q, k, v, rn(1, 8, 4, 128), rn(1, 8, 4, 128),
                            True, 0, 192 ** -0.5, 0, plan=plan)
    with pytest.raises(ValueError, match="shapes"):
        K.moe_gmm_backward(rn(2, 4, 8), rn(2, 8, 16), rn(2, 4, 8))
    with pytest.raises(ValueError, match="dtypes"):
        K.moe_gmm_backward(rn(2, 4, 8), rn(2, 8, 16),
                           rn(2, 4, 16, dt=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 8"):
        K.rmsnorm_backward(rn(4, 8 * 1024 + 8), rn(8 * 1024 + 8),
                           rn(4, 8 * 1024 + 8))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi-3-vision-4.2b",
                                  "whisper-large-v3"])
def test_smoke_train_step_on_card_matches_cpu(cuda, arch):
    """One fp32 train step of the smoke config on the card (both backward
    kernels) against the same step on the CPU (plain versions)."""
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, cfg.encdec.encoder_seq, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (2, cfg.vlm.num_image_tokens, cfg.d_model), np.float32)
    params = L.to_tree(M.init_params(cfg, 0, device="cpu"))
    step = ST.make_train_step(cfg, AdamWConfig(warmup_steps=1,
                                               decay_steps=10), remat="none")
    got = {}
    for dev in ("cpu", cuda):
        state = init_opt_state(
            torch.utils._pytree.tree_map(lambda t: t.to(dev), params))
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        K.reset_launches()
        got[str(dev)] = step(state, b)
    (s_cpu, m_cpu), (s_gpu, m_gpu) = got["cpu"], got["cuda"]
    assert K.rmsnorm_backward.launches > 0 or cfg.norm != "rmsnorm"
    assert K.flash_attention_backward.launches > 0
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(m_cpu[key]) - float(m_gpu[key])) <= \
            1e-4 * (1 + abs(float(m_cpu[key]))), key
    for a, b in zip(torch.utils._pytree.tree_leaves(s_cpu["master"]),
                    torch.utils._pytree.tree_leaves(s_gpu["master"])):
        _close(a, b.cpu(), 1e-4)


# ------------------------------------------------ the moe family's train --
# (E, R, D, F): deepseek-v2-lite-16b's train row (batch 8 x seq 128: four
# groups of C = 32), both expert products; mixtral-8x22b's row (E 8, C
# 320); a 256-token group's R = 32; ragged ones; aligned ones with dw
# streamed over two M tiles of dx (R = 200) and with dy resident over
# ragged D and F tiles
GMM_BWD_CASES = [(64, 128, 2048, 1408), (64, 128, 1408, 2048),
                 (8, 320, 6144, 16384), (64, 32, 2048, 1408), (3, 37, 200, 72),
                 (3, 5, 131, 67), (2, 150, 96, 300), (2, 200, 256, 512),
                 (2, 64, 136, 264)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,R,D,F", GMM_BWD_CASES)
def test_moe_gmm_backward_matches_plain(cuda, dt, E, R, D, F):
    """dx and dw against the plain backward; one counted run (two
    launches); identical bits on a second run (no atomics)."""
    rn = _randn(cuda, 21)
    x, w, dy = rn(E, R, D, dt=dt) * D ** -0.5, rn(E, D, F, dt=dt), \
        rn(E, R, F, dt=dt)
    x = x.to(dt)
    before = K.moe_gmm_backward.launches
    dx, dw = K.moe_gmm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert K.moe_gmm_backward.launches == before + 1
    wdx, wdw = K.moe_gmm_backward_plain(x, w, dy)
    assert dx.dtype == dw.dtype == dt
    _close(dx, wdx, TOL[dt])
    _close(dw, wdw, TOL[dt])
    dx2, dw2 = K.moe_gmm_backward(x, w, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("E,R,D,F", GMM_BWD_CASES)
def test_moe_gmm_backward_cp_async_path_matches_plain(cuda, E, R, D, F):
    """The cp.async kernel, which bf16 rows that are not 16-byte aligned
    take, forced at every case (where the plan takes the TMA kernels as
    well): within the limit and bit-equal on a second run."""
    MG = importlib.import_module("repro_torch.kernels.moe_gmm")
    rn = _randn(cuda, 21)
    dt = torch.bfloat16
    x, w, dy = (rn(E, R, D) * D ** -0.5).to(dt), rn(E, D, F, dt=dt), \
        rn(E, R, F, dt=dt)
    plan = MG._plan_backward(E, R, D, F, _build.sm_count(cuda), False)
    assert not plan.tma and not plan.resident
    assert MG.plan_gmm_backward(E, R, D, F, _build.sm_count(cuda)).tma == \
        (D % 8 == 0 and F % 8 == 0)
    got = MG._launch_backward(x, w, dy, plan)
    for a, b in zip(got, K.moe_gmm_backward_plain(x, w, dy)):
        _close(a, b, TOL[dt])
    assert all(torch.equal(a, b) for a, b in
               zip(got, MG._launch_backward(x, w, dy, plan)))


def test_moe_gmm_backward_takes_views_at_odd_offsets(cuda):
    """Contiguous views whose bases are not 16-byte aligned (the TMA
    kernels read aligned bases only, so the wrapper copies them) give the
    plain backward."""
    rn = _randn(cuda, 24)
    E, R, D, F = 2, 64, 256, 264
    dt = torch.bfloat16
    flat = rn(E * R * D + 1, dt=dt) * D ** -0.5
    x = flat[1:].view(E, R, D)
    w, dy = rn(E, D, F, dt=dt), rn(E * R * F + 3, dt=dt)[3:].view(E, R, F)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16 and x.is_contiguous()
    for a, b in zip(K.moe_gmm_backward(x, w, dy),
                    K.moe_gmm_backward_plain(x, w, dy)):
        _close(a, b, TOL[dt])


def test_moe_gmm_backward_tolerance_rejects_a_stale_resident_tile(cuda):
    """At deepseek's train row, where dw keeps dy's [128 x 256] tile
    resident for each unit of D tiles: a block's later units keeping its
    first unit's tile fails the check that dw passes; dx is untouched."""
    MG = importlib.import_module("repro_torch.kernels.moe_gmm")
    rn = _randn(cuda, 22)
    dt = torch.bfloat16
    x, w, dy = (rn(64, 128, 2048) * 2048 ** -0.5).to(dt), \
        rn(64, 2048, 1408, dt=dt), rn(64, 128, 1408, dt=dt)
    assert MG.plan_gmm_backward(64, 128, 2048, 1408,
                                _build.sm_count(cuda)).resident
    wdx, wdw = K.moe_gmm_backward_plain(x, w, dy)
    dx, dw = MG._launch_backward(x, w, dy, fault=MG.FAULT_STALE_RESIDENT)
    assert _agree(dx, wdx, TOL[dt]) and not _agree(dw, wdw, TOL[dt])
    dx, dw = MG._launch_backward(x, w, dy)
    assert _agree(dx, wdx, TOL[dt]) and _agree(dw, wdw, TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_moe_gmm_backward_tolerance_rejects_planted_faults(cuda, dt):
    """At deepseek's train row: launch dx with each w stage holding the
    step before's F tile, launch dw with R's last 8-row group left out of
    the sum; each fails the check its gradient passes."""
    MG = importlib.import_module("repro_torch.kernels.moe_gmm")
    rn = _randn(cuda, 22)
    x, w, dy = (rn(64, 128, 2048) * 2048 ** -0.5).to(dt), \
        rn(64, 2048, 1408, dt=dt), rn(64, 128, 1408, dt=dt)
    wdx, wdw = K.moe_gmm_backward_plain(x, w, dy)
    dx, dw = MG._launch_backward(x, w, dy, fault=MG.FAULT_STALE_TILE)
    assert not _agree(dx, wdx, TOL[dt]) and _agree(dw, wdw, TOL[dt])
    dx, dw = MG._launch_backward(x, w, dy, fault=MG.FAULT_DROP_ROW_GROUP)
    assert _agree(dx, wdx, TOL[dt]) and not _agree(dw, wdw, TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,causal", [(8, 128, True), (1, 37, True),
                                        (1, 256, True), (2, 70, False)])
def test_flash_backward_at_mla_head_dims_matches_plain(cuda, dt, B, S,
                                                       causal):
    """MLA's (hd 192, hd_v 128) at deepseek's train row [8,128,16,...],
    a ragged prompt, a 256-token prefill and bidirectional rows: dq, dk
    and dv within the limit, bit-equal on a second run, and launch A one K
    tile short rejected."""
    rn = _randn(cuda, 23)
    q, k, v = rn(B, S, 16, 192, dt=dt), rn(B, S, 16, 192, dt=dt), \
        rn(B, S, 16, 128, dt=dt)
    out = K.flash_attention(q, k, v, causal=causal)
    dout = rn(B, S, 16, 128, dt=dt)
    got = K.flash_attention_backward(q, k, v, out, dout, causal=causal)
    want = K.flash_attention_backward_plain(q, k, v, out, dout,
                                            causal=causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dt
        _close(a, b, TOL[dt])
    again = K.flash_attention_backward(q, k, v, out, dout, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if S > 64 and causal:
        bad = FA._launch_backward(q, k, v, out, dout, causal, 0,
                                  192 ** -0.5, 0, short_tiles=1)
        assert not all(_agree(a, b, TOL[dt]) for a, b in zip(bad, want))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_moe_smoke_train_step_on_card(cuda, arch):
    """One fp32 train step of the smoke config on the card against the
    same step on the CPU, with one moe_gmm_backward run per moe_gmm
    launch (three a MoE layer) and one flash backward a layer; deepseek's
    MLA at its own head dims (hd 192 = 128 + 64 rope, hd_v 128), which the
    kernels take where the smoke config's 24 / 16 they do not."""
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=MLAConfig(
            kv_lora_rank=32, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 128))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    params = L.to_tree(M.init_params(cfg, 0, device="cpu"))
    step = ST.make_train_step(cfg, AdamWConfig(warmup_steps=1,
                                               decay_steps=10), remat="none")
    moe_layers = sum(s.n for s in M.build_stages(cfg) if s.kind in M.MOE_KINDS)
    got = {}
    for dev in ("cpu", cuda):
        state = init_opt_state(
            torch.utils._pytree.tree_map(lambda t: t.to(dev), params))
        K.reset_launches()
        got[str(dev)] = step(state, {k: torch.as_tensor(v, device=dev)
                                     for k, v in batch.items()})
    torch.cuda.synchronize()
    assert K.moe_gmm.launches == K.moe_gmm_backward.launches \
        == 3 * moe_layers
    assert K.flash_attention_backward.launches == cfg.num_layers
    (s_cpu, m_cpu), (s_gpu, m_gpu) = got["cpu"], got["cuda"]
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(m_cpu[key]) - float(m_gpu[key])) <= \
            1e-4 * (1 + abs(float(m_cpu[key]))), key
    # Adam's first step moves an element whose gradient is below fp32's
    # resolution by a rounding-decided fraction of lr: those are held to
    # the step's bound only
    lr = float(m_cpu["lr"])
    for a, b, m in zip(torch.utils._pytree.tree_leaves(s_cpu["master"]),
                       torch.utils._pytree.tree_leaves(s_gpu["master"]),
                       torch.utils._pytree.tree_leaves(s_cpu["m"])):
        ok = m.abs() / (1 - 0.9) >= 1e-6
        _close(a[ok], b.cpu()[ok], 1e-4)
        assert torch.all((a - b.cpu()).abs()[~ok] <= 2 * lr + 1e-4)


# ------------------------------------------------------ scan backwards ----
# (B, Q, nc): a train step's rows of zamba2-1.2b and xlstm-350m (batch 8 of
# seq 128), the 300-token prompt's two chunks of 150, 70 chunks of one
# row (kernel chunks of 64 and 6 across the caller chunks), 200 rows (four
# kernel chunks, the last of 8: the middle ones have a nonzero entering
# state and a nonzero leaving cotangent), three full kernel chunks across
# two caller chunks of 96, and one row
SCAN_BWD_CASES = [(8, 128, 1), (1, 150, 2), (2, 1, 70), (1, 200, 1),
                  (2, 96, 2), (1, 1, 1)]
SCAN_BWDS = {"mamba": (K.mamba_chunk_scan_backward,
                       K.mamba_chunk_scan_backward_plain),
             "mlstm": (K.mlstm_chunk_scan_backward,
                       K.mlstm_chunk_scan_backward_plain)}


def _scan_bwd_args(dev, which, B, Q, nc, dt, decay=1.0):
    """The forward's inputs at full width with ``dt`` for B, C or q, k, v,
    y (mLSTM) and nonzero cotangents of every output; ``decay`` scales the
    mLSTM's log forget gates."""
    rn = _randn(dev, 21)
    if which == "mamba":                 # nh = P = N = 64
        ins = (rn(B, nc, Q, 64, 64) * 0.5, (rn(B, nc, Q, 64) * 0.5).to(dt),
               (rn(B, nc, Q, 64) * 0.5).to(dt),
               torch.cumsum(-rn(B, nc, Q, 64).abs() * 0.1, 2))
        outs = K.mamba_chunk_scan(*ins)
        return (*ins, *(rn(*o.shape) for o in outs))
    ins = (*((rn(B, nc, Q, 4, 512) * 512 ** -0.25).to(dt)  # nh 4, dh 512
             for _ in range(2)), rn(B, nc, Q, 4, 512).to(dt),
           torch.cumsum(-rn(B, nc, Q, 4).abs() * 0.2, 2) * decay,
           torch.clamp_max(rn(B, nc, Q, 4), 8.0))
    outs = K.mlstm_chunk_scan(*ins)
    return (*ins, outs[0], *(rn(*o.shape) for o in outs))


def _close_scaled(a, b, tol):
    """atol tol times the largest |b| (at least 1), rtol tol: a scan's
    gradients sum up to 64 heads' or 300 rows' terms of up to ~5e3 in
    another order than the plain version."""
    scale = max(1.0, float(b.float().abs().max()))
    _close(a.float() / scale, b.float() / scale, tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Q,nc", SCAN_BWD_CASES)
@pytest.mark.parametrize("which", sorted(SCAN_BWDS))
def test_scan_backwards_match_plain(cuda, which, B, Q, nc, dt):
    """Every gradient against the plain backward, in its input's dtype;
    one counted run; identical bits on a second run (no atomics)."""
    run, plain = SCAN_BWDS[which]
    a = _scan_bwd_args(cuda, which, B, Q, nc, dt)
    before = run.launches
    got = run(*a)
    torch.cuda.synchronize()
    assert run.launches == before + 1
    for g, w in zip(got, plain(*a)):
        assert g.dtype == w.dtype
        if dt == torch.float32:
            _close_scaled(g, w, TOL[dt])
        else:
            _close(g, w, TOL[dt])
    again = run(*a)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", sorted(SCAN_BWDS))
def test_scan_backwards_take_rows_off_16_bytes(cuda, which, dt):
    """Widths whose rows are not whole 16-byte pieces (the mLSTM's dh 36,
    the SSD's P 6 and N 12; the forwards refuse some of them, so y comes
    from the plain forward) take the kernels' plain loads: every gradient
    against the plain backward, three kernel chunks."""
    rn = _randn(cuda, 23)
    B, nc, Q = 1, 2, 80
    if which == "mamba":
        a = (rn(B, nc, Q, 3, 6) * 0.5, (rn(B, nc, Q, 12) * 0.5).to(dt),
             (rn(B, nc, Q, 12) * 0.5).to(dt),
             torch.cumsum(-rn(B, nc, Q, 3).abs() * 0.1, 2),
             rn(B, nc, Q, 3, 6), rn(B, 3, 6, 12))
    else:
        ins = (*((rn(B, nc, Q, 2, 36) * 36 ** -0.25).to(dt)
                 for _ in range(2)), rn(B, nc, Q, 2, 36).to(dt),
               torch.cumsum(-rn(B, nc, Q, 2).abs() * 0.2, 2),
               torch.clamp_max(rn(B, nc, Q, 2), 8.0))
        y = K.mlstm_chunk_scan_plain(*ins)[0]
        a = (*ins, y, rn(*y.shape), rn(B, 2, 36, 36), rn(B, 2, 36))
    run, plain = SCAN_BWDS[which]
    for g, w in zip(run(*a), plain(*a)):
        assert g.dtype == w.dtype
        if dt == torch.float32:
            _close_scaled(g, w, TOL[dt])
        else:
            _close(g, w, TOL[dt])


@pytest.mark.parametrize("which", sorted(SCAN_BWDS))
def test_scan_backward_tolerance_rejects_planted_faults(cuda, which):
    """At a train step's rows (two kernel chunks): a chunk reading the
    state cotangent of the chunk after it; the SSD's sum of dB over the
    head groups without its last group; the mLSTM's sum of dg's column
    tiles without its last, and its sum of the d tiles' scores without the
    last; with bf16 inputs every split cut to one part; and, with the
    mLSTM's forget gates near 1 (where e^{gl} <dC'_out, C'_in> counts),
    the sum of that term's state tiles without the last: each fails the
    check the kernel passes."""
    mod = importlib.import_module(
        f"repro_torch.kernels.{'mamba_scan' if which == 'mamba' else 'mlstm'}")
    _, plain = SCAN_BWDS[which]
    cases = [(dt, 1.0) for dt in (torch.float32, torch.bfloat16)]
    if which == "mlstm":
        cases += [(dt, 0.01) for dt in (torch.float32, torch.bfloat16)]
    for dt, decay in cases:
        a = _scan_bwd_args(cuda, which, 8, 128, 1, dt, decay)
        ref = plain(*a)
        # each gradient scaled as test_scan_backwards_match_plain holds it
        # (fp32: by its largest |reference|, at least 1): the check passes
        # iff every gradient passes its own
        scales = [max(1.0, float(w.float().abs().max()))
                  if dt == torch.float32 else 1.0 for w in ref]
        flat = lambda ts: torch.cat([t.float().flatten() / s
                                     for t, s in zip(ts, scales)])
        want = flat(ref)
        assert _agree(flat(mod._launch_backward(*a)), want, TOL[dt])
        if decay != 1.0:
            faults = [mod.FAULT_STATE_DROP_TILE]
        elif which == "mamba":
            faults = [mod.FAULT_WRONG_COTANGENT, mod.FAULT_DROP_GROUP]
        else:
            faults = [mod.FAULT_WRONG_COTANGENT, mod.FAULT_DROP_TILE,
                      mod.FAULT_ROWS_DROP_TILE]
        if dt == torch.bfloat16 and decay == 1.0:
            faults.append(mod.FAULT_ONE_PART)
        for fault in faults:
            assert not _agree(flat(mod._launch_backward(*a, fault=fault)),
                              want, TOL[dt]), fault


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_smoke_train_steps_on_card(cuda, arch):
    """One fp32 train step of the smoke config on the card (the scan's
    backward kernel) against the same step on the CPU, its master
    elements whose first-step gradient is resolved (|g| >= 1e-6) at 1e-4
    and the rest within Adam's step bound; then one bf16 step on the card
    (the launcher's dtype): finite, one scan backward per scan layer."""
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 80))   # two kernel chunks
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    params = L.to_tree(M.init_params(cfg, 0, device="cpu"))
    opt = AdamWConfig(warmup_steps=1, decay_steps=10)
    step = ST.make_train_step(cfg, opt, remat="none")
    got = {}
    for dev in ("cpu", cuda):
        state = init_opt_state(
            torch.utils._pytree.tree_map(lambda t: t.to(dev), params))
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        K.reset_launches()
        got[str(dev)] = step(state, b)
    (s_cpu, m_cpu), (s_gpu, m_gpu) = got["cpu"], got["cuda"]
    scan = "mamba_chunk_scan" if cfg.family == "hybrid" else \
        "mlstm_chunk_scan"
    n_scan = K.launch_counts()[scan]
    assert n_scan > 0 and \
        K.launch_counts(K.BACKWARD_KERNELS)[scan + "_backward"] == n_scan
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(m_cpu[key]) - float(m_gpu[key])) <= \
            1e-4 * (1 + abs(float(m_cpu[key]))), key
    lr = float(m_cpu["lr"])
    for a, b, m in zip(torch.utils._pytree.tree_leaves(s_cpu["master"]),
                       torch.utils._pytree.tree_leaves(s_gpu["master"]),
                       torch.utils._pytree.tree_leaves(s_cpu["m"])):
        ok = m.abs() / (1 - 0.9) >= 1e-6
        _close(a[ok], b.cpu()[ok], 1e-4)
        assert torch.all((a - b.cpu()).abs()[~ok] <= 2 * lr + 1e-4)
    bcfg = smoke_shrink(get_config(arch))              # bf16
    state = init_opt_state(L.to_tree(M.init_params(bcfg, 0, device=cuda)))
    K.reset_launches()
    _, m = ST.make_train_step(bcfg, opt, remat="none")(
        state, {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()})
    assert math.isfinite(float(m["loss"])) and \
        math.isfinite(float(m["grad_norm"]))
    assert K.launch_counts(K.BACKWARD_KERNELS)[scan + "_backward"] == n_scan
