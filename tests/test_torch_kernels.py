"""The port's kernels against the reference: each plain version against
``repro.kernels.ref`` and the Pallas kernel (interpret mode on CPU), and
against the model-path function of ``repro.models.layers`` it replaces.
Inputs come from numpy seeds and go to both frameworks; tolerances are
those of ``tests/test_kernels.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 0.03, "bfloat16": 0.08}


def _pair(rng, shape, dt, scale=1.0):
    """The same values as a jax array and a torch tensor (bf16 rounding
    of one fp32 draw is identical in both)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(DT[dt][0]), torch.from_numpy(x).to(DT[dt][1])


def _close(a, b, tol):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


FLASH_CASES = [
    # B, Sq, Sk, H, Hkv, hd, causal, window, dtype   (tests/test_kernels.py)
    (2, 128, 128, 4, 4, 64, True, 0, "float32"),
    (2, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
    (1, 64, 256, 8, 2, 64, True, 0, "bfloat16"),    # q offset (cached)
    (2, 256, 256, 4, 1, 32, True, 64, "bfloat16"),  # SWA + MQA
    (1, 128, 128, 2, 2, 128, False, 0, "float32"),  # bidirectional
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_vs_ref_and_pallas(case):
    B, Sq, Sk, H, Hkv, hd, causal, window, dt = case
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (B, Sq, H, hd), dt)
    kj, kt = _pair(rng, (B, Sk, Hkv, hd), dt)
    vj, vt = _pair(rng, (B, Sk, Hkv, hd), dt)
    got = K.flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, ref.flash_attention(qj, kj, vj, causal=causal, window=window),
           TOL[dt])
    _close(got, ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                    blk_q=64, blk_k=64), TOL[dt])


@pytest.mark.parametrize("Sq,Sk,window", [(13, 13, 0), (37, 37, 16),
                                          (5, 29, 0)])
def test_flash_plain_ragged_vs_ref(Sq, Sk, window):
    """Lengths the Pallas kernel's tiling refuses (the port's per-request
    prefill sends exact prompt lengths)."""
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (2, Sq, 4, 16), "float32")
    kj, kt = _pair(rng, (2, Sk, 2, 16), "float32")
    vj, vt = _pair(rng, (2, Sk, 2, 16), "float32")
    _close(K.flash_attention_plain(qt, kt, vt, window=window),
           ref.flash_attention(qj, kj, vj, window=window), 1e-5)


@pytest.mark.parametrize("dt,window", [("bfloat16", 0), ("float32", 0),
                                       ("float32", 24)])
def test_flash_plain_vs_model_chunked_attention(dt, window):
    rng = np.random.default_rng(2)
    B, S, H, Hkv, hd = 2, 96, 4, 2, 32
    qj, qt = _pair(rng, (B, S, H, hd), dt)
    kj, kt = _pair(rng, (B, S, Hkv, hd), dt)
    vj, vt = _pair(rng, (B, S, Hkv, hd), dt)
    want = JL.chunked_attention(qj, kj, vj, causal=True, window=window,
                                chunk=32)
    tol = 1e-5 if dt == "float32" else TOL[dt]
    _close(K.flash_attention_plain(qt, kt, vt, window=window), want, tol)


@pytest.mark.parametrize("Sq,Sk", [(48, 200), (200, 48), (1, 1500)])
def test_flash_plain_cross_attention_ignores_q_offset(Sq, Sk):
    """Not causal and with no window, the query's offset masks nothing:
    whisper's cross-attention takes the port's default q_offset (Sk - Sq)
    where the reference's chunked_attention takes 0."""
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (2, Sq, 4, 16), "float32")
    kj, kt = _pair(rng, (2, Sk, 4, 16), "float32")
    vj, vt = _pair(rng, (2, Sk, 4, 16), "float32")
    got = K.flash_attention_plain(qt, kt, vt, causal=False)
    assert torch.equal(got, K.flash_attention_plain(qt, kt, vt, causal=False,
                                                    q_offset=0))
    assert torch.equal(got, K.flash_attention(qt, kt, vt, causal=False,
                                              q_offset=0))
    _close(got, JL.chunked_attention(qj, kj, vj, causal=False), 1e-5)
    _close(got, ref.flash_attention(qj, kj, vj, causal=False), 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_at_whisper_frames(causal):
    """Sq = Sk = 1,500 (whisper's encoder frames: no multiple of the
    kernel's 64-key tile, and more than the reference's 1,024-row query
    chunk, so its scan pads the last chunk)."""
    rng = np.random.default_rng(8)
    qj, qt = _pair(rng, (1, 1500, 2, 16), "float32")
    kj, kt = _pair(rng, (1, 1500, 2, 16), "float32")
    vj, vt = _pair(rng, (1, 1500, 2, 16), "float32")
    got = K.flash_attention_plain(qt, kt, vt, causal=causal)
    _close(got, JL.chunked_attention(qj, kj, vj, causal=causal), 1e-5)
    _close(got, ref.flash_attention(qj, kj, vj, causal=causal), 1e-5)


@pytest.mark.parametrize("lens", [[1500, 1500], [1409, 1]])
def test_decode_plain_over_whisper_cross_cache(lens):
    """W = 1,500 (whisper's cross cache, G = 1): the plain version, the
    kernel's split algorithm over its plan (the last chunk ragged) and the
    reference's ref and layers.decode_attention agree."""
    from repro_torch.kernels.decode_attention import (decode_attention_split,
                                                      plan_splits)
    rng = np.random.default_rng(9)
    qj, qt = _pair(rng, (2, 4, 64), "float32")
    kj, kt = _pair(rng, (2, 1500, 4, 64), "float32")
    vj, vt = _pair(rng, (2, 1500, 4, 64), "float32")
    ln = np.array(lens, np.int32)
    got = K.decode_attention_plain(qt, kt, vt, torch.from_numpy(ln))
    plan = plan_splits(2, 20, 1500, 132)    # whisper's 20 heads, an H100
    assert plan.splits * plan.chunk > 1500 > (plan.splits - 1) * plan.chunk
    _close(decode_attention_split(qt, kt, vt, torch.from_numpy(ln), plan),
           got, 1e-5)
    _close(got, ref.decode_attention(qj, kj, vj, jnp.asarray(ln)), 1e-5)
    want = JL.decode_attention(qj[:, None], kj, vj, jnp.asarray(ln - 1))
    _close(got, np.asarray(want)[:, 0], 1e-5)


@pytest.mark.parametrize("B,H,Hkv,hd,W,dt", [
    (2, 8, 2, 64, 256, "bfloat16"),
    (3, 4, 4, 128, 512, "float32"),
    (1, 16, 1, 64, 128, "bfloat16"),
])
def test_decode_plain_vs_ref_and_pallas(B, H, Hkv, hd, W, dt):
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, (B, H, hd), dt)
    kj, kt = _pair(rng, (B, W, Hkv, hd), dt)
    vj, vt = _pair(rng, (B, W, Hkv, hd), dt)
    lens = rng.integers(1, W + 1, B).astype(np.int32)
    got = K.decode_attention_plain(qt, kt, vt, torch.from_numpy(lens))
    _close(got, ref.decode_attention(qj, kj, vj, jnp.asarray(lens)), TOL[dt])
    _close(got, ops.decode_attention(qj, kj, vj, jnp.asarray(lens),
                                     blk_w=128), TOL[dt])


@pytest.mark.parametrize("window,quant", [(0, False), (16, False),
                                          (0, True), (16, True)])
def test_decode_plain_vs_model_decode_attention(window, quant):
    """Dense, SWA ring and int8-cache forms of layers.decode_attention."""
    rng = np.random.default_rng(4)
    B, H, Hkv, hd, W = 3, 8, 2, 32, 48
    qj, qt = _pair(rng, (B, 1, H, hd), "float32")
    kj, kt = _pair(rng, (B, W, Hkv, hd), "float32")
    vj, vt = _pair(rng, (B, W, Hkv, hd), "float32")
    pos = np.array([5, 47, 90], np.int32)   # 90 wraps the ring
    kw = {}
    if quant:
        kq, ks = JL.kv_quantize(kj)
        vq, vs = JL.kv_quantize(vj)
        kj, vj = kq, vq
        kt = torch.from_numpy(np.array(kq))
        vt = torch.from_numpy(np.array(vq))
        kw = dict(k_scale=ks, v_scale=vs)
    want = JL.decode_attention(qj, kj, vj, jnp.asarray(pos), window=window,
                               **kw)
    got = K.decode_attention_plain(
        qt[:, 0], kt, vt, torch.from_numpy(pos + 1), window=window,
        **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()})
    _close(got, np.asarray(want)[:, 0], 1e-4)


@pytest.mark.parametrize("shape,dt", [
    ((4, 37, 256), "bfloat16"), ((128, 512), "float32"),
    ((2, 3, 5, 128), "bfloat16"),
])
def test_rmsnorm_plain_vs_ref_and_pallas(shape, dt):
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng, shape, dt)
    s = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    got = K.rmsnorm_plain(xt, torch.from_numpy(s))
    assert got.dtype == xt.dtype
    _close(got, ref.rmsnorm(xj, jnp.asarray(s)), 0.03)
    _close(got, ops.rmsnorm(xj, jnp.asarray(s)), 0.03)
    _close(got, JL.apply_norm({"scale": jnp.asarray(s)}, xj), 0.03)


def test_custom_ops_take_the_plain_version_on_cpu():
    """On a CPU tensor each registered op returns exactly the plain
    result and launches nothing (the attention wrappers' per-shape counts,
    emptied by ``reset_launches``, stay empty)."""
    rng = np.random.default_rng(6)
    K.flash_attention.by_shape[((1, 2, 3, 4), (1, 2, 3, 4))] += 1
    K.decode_attention.by_shape[((1, 3, 4), (1, 2, 3, 4))] += 2
    K.reset_launches()
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    assert torch.equal(K.rmsnorm(x, s, 1e-5), K.rmsnorm_plain(x, s, 1e-5))
    q = torch.from_numpy(rng.standard_normal((2, 13, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 13, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 13, 2, 16)).astype(np.float32))
    assert torch.equal(K.flash_attention(q, k, v, window=4),
                       K.flash_attention_plain(q, k, v, window=4))
    lens = torch.tensor([3, 13], dtype=torch.int32)
    assert torch.equal(K.decode_attention(q[:, 0], k, v, lens),
                       K.decode_attention_plain(q[:, 0], k, v, lens))
    xb = torch.from_numpy(rng.standard_normal((1, 2, 5, 3, 8))
                          .astype(np.float32))
    bc = torch.from_numpy(rng.standard_normal((1, 2, 5, 4)).astype(np.float32))
    cum = -torch.rand(1, 2, 5, 3).cumsum(2)
    for got, want in zip(K.mamba_chunk_scan(xb, bc, bc, cum),
                         K.mamba_chunk_scan_plain(xb, bc, bc, cum)):
        assert torch.equal(got, want)
    for got, want in zip(K.mlstm_chunk_scan(xb, xb, xb, cum, cum),
                         K.mlstm_chunk_scan_plain(xb, xb, xb, cum, cum)):
        assert torch.equal(got, want)
    xe = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32))
    we = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32))
    assert torch.equal(K.moe_gmm(xe, we), K.moe_gmm_plain(xe, we))
    assert [f.launches for f in K.KERNELS] == [0] * 6
    assert not K.flash_attention.by_shape
    assert not K.decode_attention.by_shape


def test_ops_are_registered_with_fake_impls():
    """Each kernel is one opaque torch.library op with a meta
    implementation (what torch.export needs to keep it as one node)."""
    meta = torch.device("meta")
    x = torch.empty(3, 64, device=meta)
    assert torch.ops.repro_torch.rmsnorm(x, torch.empty(64, device=meta),
                                         1e-5).shape == (3, 64)
    q = torch.empty(1, 7, 4, 16, device=meta)
    kv = torch.empty(1, 7, 2, 16, device=meta)
    assert torch.ops.repro_torch.flash_attention(
        q, kv, kv, True, 0, 0.25, 0).shape == q.shape
    assert torch.ops.repro_torch.flash_attention(
        q, kv, kv[..., :8], True, 0, 0.25, 0).shape == (1, 7, 4, 8)
    lens = torch.empty(1, dtype=torch.int32, device=meta)
    assert torch.ops.repro_torch.decode_attention(
        q[:, 0], kv, kv, lens, 0.25).shape == (1, 4, 16)
    xb = torch.empty(2, 3, 5, 4, 8, device=meta)
    bc, cum = torch.empty(2, 3, 5, 6, device=meta), \
        torch.empty(2, 3, 5, 4, device=meta)
    y, st = torch.ops.repro_torch.mamba_chunk_scan(xb, bc, bc, cum)
    assert y.shape == xb.shape and st.shape == (2, 4, 8, 6)
    y, C, n = torch.ops.repro_torch.mlstm_chunk_scan(xb, xb, xb, cum, cum)
    assert y.shape == xb.shape and C.shape == (2, 4, 8, 8) \
        and n.shape == (2, 4, 8) and C.dtype == torch.float32
    assert torch.ops.repro_torch.moe_gmm(
        torch.empty(3, 5, 16, device=meta),
        torch.empty(3, 16, 8, device=meta)).shape == (3, 5, 8)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.library_path().name.startswith("libkernels-")
