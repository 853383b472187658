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
    before = [f.launches for f in K.KERNELS]
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
    assert [f.launches - b for f, b in zip(K.KERNELS, before)] == \
        [1, 1, 1, 0, 0, 0]


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
    # the int8-cache form has no kernel; the sliding-window ring runs the
    # dense kernel; a group of 7, which no config has, is refused (groups
    # of 6 and 9, mixtral's and starcoder2-7b's, are instantiated)
    q, kc = rn(2, 1, 4, 16), rn(2, 8, 2, 16)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    scale = torch.ones(2, 8, 2, 1, device=cuda)
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        L.decode_attention(q, kc, kc, pos, k_scale=scale, v_scale=scale)
    L.decode_attention(q, kc, kc, pos, window=8)
    lens = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="H=14"):
        K.decode_attention(rn(2, 14, 16), kc, kc, lens)


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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv", [(36, 4), (48, 8)])
def test_decode_groups_of_9_and_6_match_plain(cuda, dt, H, Hkv):
    """starcoder2-7b's group of 9 and mixtral-8x22b's of 6 at hd 128, which
    do not divide the kernel's block; the last head dropped (what the
    truncating DV of the kernel before them left unwritten) fails."""
    rn = _randn(cuda, 14)
    lens = torch.tensor([1, 300, 777, 1024], dtype=torch.int32, device=cuda)
    q, kc, vc = rn(4, H, 128, dt=dt), rn(4, 1024, Hkv, 128, dt=dt), \
        rn(4, 1024, Hkv, 128, dt=dt)
    want = K.decode_attention_plain(q, kc, vc, lens)
    assert _agree(K.decode_attention(q, kc, vc, lens), want, TOL[dt])
    assert not _agree(DA._launch(q, kc, vc, lens, 128 ** -0.5,
                                 fault=DA.FAULT_DROP_LAST_HEAD), want, TOL[dt])


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
