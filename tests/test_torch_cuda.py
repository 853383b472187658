"""The port's CUDA path, on the card only (skipped without one).

This file imports torch and the port, never JAX, so it runs as it is on
a machine with a card and no JAX:

    python -m pytest -q tests/test_torch_cuda.py

Each kernel against its plain version, the wrappers' refusals, and the
smoke engines on the card against the same engines on the CPU.  The test
that the tolerances reject planted faults also runs on the CPU, where the
wrappers take their plain versions.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core.channel import LiveChannel  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import steps as ST  # noqa: E402

TOL = K.TOLERANCE


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
    assert [f.launches - b for f, b in zip(K.KERNELS, before)] == [1, 1, 1]


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
    q, kc = rn(2, 1, 4, 16), rn(2, 8, 2, 16)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        L.decode_attention(q, kc, kc, pos, window=4)


@pytest.mark.parametrize("arch", ["cody-mnist", "qwen2.5-3b"])
def test_smoke_engine_on_card_matches_cpu(cuda, arch):
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    outs, stats = [], []
    # Module.to moves in place: the card gets its own copy
    for dev, p in (("cpu", params), ("cuda", copy.deepcopy(params).to(cuda))):
        K.reset_launches()
        eng = build_engine(cfg, n_slots=2, cache_len=64, block_k=4,
                           params=p, device=dev)
        g = torch.Generator().manual_seed(5)
        for n in (5, 9, 13):
            eng.submit(torch.randint(3, cfg.vocab_size, (n,),
                                     generator=g).tolist(), 12)
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
