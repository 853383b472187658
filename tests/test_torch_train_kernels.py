"""The backward kernels' plain versions against ``jax.grad`` of the
reference's pure-JAX ``apply_norm`` and ``chunked_attention``
(``repro/models/layers.py:69``, ``:103``) and ``jax.vjp`` of its chunk
chains (``repro/kernels/ref.py:mamba_chunk``, ``:mlstm_chunk``, looped
over the chunks) at fp32 ``allclose`` 1e-5; the custom ops' registered
autograd on the CPU (gradcheck in fp64, and against autograd through the
plain forwards); and the serving exports, whose op nodes the
registration must leave as they were."""
import collections
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JREF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core.recorder import compile_artifact  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import steps as ST  # noqa: E402

TOL = 1e-5


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


# kind, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset
CASES = [
    ("rmsnorm", 3, 7, 0, 0, 0, 64, False, 0, 0),
    ("rmsnorm", 2, 5, 0, 0, 0, 96, False, 0, 0),
    ("causal G=1 hd=16", 2, 12, 12, 4, 4, 16, True, 0, 0),
    ("causal G=2 hd=64", 2, 12, 12, 4, 2, 64, True, 0, 0),
    ("causal G=8 hd=96", 1, 9, 9, 8, 1, 96, True, 0, 0),
    ("window G=2 hd=16", 2, 20, 20, 4, 2, 16, True, 5, 0),
    ("bidirectional G=1 hd=64", 2, 10, 14, 2, 2, 64, False, 0, 0),
    ("q_offset G=2 hd=16", 2, 6, 15, 4, 2, 16, True, 0, 9),
    ("q_offset window G=8 hd=16", 1, 6, 15, 8, 1, 16, True, 4, 9),
]


# the chunk scans: kind, B, nc, Q.  Q = 150 puts a caller chunk's edge
# inside a kernel chunk of 64 rows (kernels/mamba_scan.py:plan_scan), Q =
# 1 a kernel chunk of one row; every case carries a nonzero cotangent of
# the final state, and the mLSTM's |den| lies on both sides of 1 (the
# kink of max(|den|, 1)) wherever there are enough rows.
SCAN_CASES = [(f"{kind} nc={nc} Q={Q}", B, nc, Q)
              for kind in ("mamba", "mlstm")
              for B, nc, Q in ((2, 1, 1), (1, 2, 1), (1, 1, 64), (1, 2, 64),
                               (1, 1, 150), (1, 2, 150))]


def _scan_inputs(kind, B, nc, Q, rng, nh=2, width=8, N=6):
    """numpy inputs of a scan and the cotangents of its outputs (fp32)."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    decay = lambda: np.cumsum(-0.3 * rng.random((B, nc, Q, nh)), 2).astype(
        np.float32)
    if kind == "mamba":
        ins = (f32(B, nc, Q, nh, width), f32(B, nc, Q, N), f32(B, nc, Q, N),
               decay())
        return ins, (f32(B, nc, Q, nh, width), f32(B, nh, width, N))
    ins = (0.5 * f32(B, nc, Q, nh, width), 0.5 * f32(B, nc, Q, nh, width),
           f32(B, nc, Q, nh, width), decay(), f32(B, nc, Q, nh))
    return ins, (f32(B, nc, Q, nh, width), f32(B, nh, width, width),
                 f32(B, nh, width))


def _jax_scan(kind, *ins):
    """The reference's chunk chain over the chunks: (y, final state...)."""
    nc = ins[0].shape[1]
    chunk = JREF.mamba_chunk if kind == "mamba" else JREF.mlstm_chunk
    B, nh, w = ins[0].shape[0], ins[0].shape[3], ins[0].shape[4]
    state = (jnp.zeros((B, nh, w, ins[1].shape[-1])),) if kind == "mamba" \
        else (jnp.zeros((B, nh, w, w)), jnp.zeros((B, nh, w)))
    ys = []
    for c in range(nc):
        y, *state = chunk(*(t[:, c] for t in ins), *state)
        ys.append(y)
    return (jnp.stack(ys, 1), *state)


def _scan_backward_matches_jax_vjp(case):
    kind, B, nc, Q = case
    kind = kind.split()[0]
    ins, cot = _scan_inputs(kind, B, nc, Q, np.random.default_rng(nc * Q))
    want = jax.jit(lambda ins, cot: jax.vjp(
        lambda *a: _jax_scan(kind, *a), *ins)[1](cot))(ins, cot)
    t = [torch.from_numpy(a) for a in ins]
    dt = [torch.from_numpy(a) for a in cot]
    if kind == "mamba":
        got = K.mamba_chunk_scan_backward_plain(*t, *dt)
    else:
        y = K.mlstm_chunk_scan_plain(*t)[0]
        got = K.mlstm_chunk_scan_backward_plain(*t, y, *dt)
        # |den| on both sides of 1: with v = 1, y = den / max(|den|, 1)
        den = K.mlstm_chunk_scan_plain(t[0], t[1], torch.ones_like(t[2]),
                                       *t[3:])[0].abs().numpy()
        if nc * Q >= 64:
            assert (den < 0.999).any() and (den > 1 - 1e-6).any()
    # atol 1e-5 of the largest value (rtol 1e-5): each gradient sums up
    # to 300 rows' terms of up to ~100, and the two packages round those
    # sums in other orders (measured: at most 1.1e-4 apart where the
    # largest is 124, each as far from a float64 run as the other)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        _close(a / scale, np.asarray(b) / scale)


@pytest.mark.parametrize("case", CASES + SCAN_CASES,
                         ids=[c[0] for c in CASES + SCAN_CASES])
def test_backward_plain_matches_jax_grad(case):
    if case[0].startswith(("mamba", "mlstm")):
        return _scan_backward_matches_jax_vjp(case)
    kind, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset = case
    rng = np.random.default_rng(len(kind) + hd)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    if kind == "rmsnorm":
        x, g, scale = f32(B, Sq, hd), f32(B, Sq, hd), \
            1.0 + 0.1 * f32(hd)
        _, vjp = jax.vjp(lambda x, s: JL.apply_norm({"scale": s}, x),
                         jnp.asarray(x), jnp.asarray(scale))
        jdx, jds = vjp(jnp.asarray(g))
        dx, ds = K.rmsnorm_backward_plain(
            torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(g))
        _close(dx, jdx)
        _close(ds, jds)
        return
    q, k, v = f32(B, Sq, H, hd), f32(B, Sk, Hkv, hd), f32(B, Sk, Hkv, hd)
    dout = f32(B, Sq, H, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, vjp = jax.vjp(lambda q, k, v: JL.chunked_attention(q, k, v, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = K.flash_attention_plain(tq, tk, tv, **kw)
    got = K.flash_attention_backward_plain(tq, tk, tv, out, tdo, **kw)
    for a, b in zip(got, want):
        _close(a, b)


def test_custom_ops_gradcheck_in_fp64():
    """The registered autograd of both ops (the plain versions compute
    in fp64 for fp64 inputs)."""
    gen = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64,
                                requires_grad=True)
    x, s = rn(3, 4, 16), rn(16)
    assert torch.autograd.gradcheck(lambda x, s: K.rmsnorm(x, s), (x, s))
    for causal, window, q_offset, G in ((True, 0, None, 1),
                                        (True, 3, None, 2),
                                        (False, 0, None, 4),
                                        (True, 0, 2, 2)):
        q, k, v = rn(2, 5, 4, 8), rn(2, 7, 4 // G, 8), rn(2, 7, 4 // G, 8)
        assert torch.autograd.gradcheck(
            lambda q, k, v: K.flash_attention(q, k, v, causal=causal,
                                              window=window,
                                              q_offset=q_offset), (q, k, v))


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
@pytest.mark.parametrize("nc,Q", [(2, 3), (1, 70)])
def test_scan_ops_gradcheck_in_fp64(kind, nc, Q):
    """The registered autograd of both chunk scans, every output's
    cotangent in play; Q = 70 spans two kernel chunks.  There the whole
    Jacobian (one forward per input element, one backward per output
    element) takes minutes, so gradcheck's fast mode holds a random
    projection of it, uᵀ J v, against finite differences."""
    gen = torch.Generator().manual_seed(nc * Q)
    rn = lambda *s, scale=1.0: (scale * torch.randn(
        *s, generator=gen, dtype=torch.float64)).requires_grad_()
    decay = lambda *s: torch.cumsum(-0.3 * torch.rand(
        *s, generator=gen, dtype=torch.float64), 2).requires_grad_()
    if kind == "mamba":
        ins = (rn(1, nc, Q, 2, 2), rn(1, nc, Q, 3), rn(1, nc, Q, 3),
               decay(1, nc, Q, 2))
        op = K.mamba_chunk_scan
    else:
        ins = (rn(1, nc, Q, 2, 3, scale=0.5), rn(1, nc, Q, 2, 3, scale=0.5),
               rn(1, nc, Q, 2, 3), decay(1, nc, Q, 2), rn(1, nc, Q, 2))
        op = K.mlstm_chunk_scan
    assert torch.autograd.gradcheck(op, ins, fast_mode=nc * Q > 64)


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_scan_op_grads_equal_autograd_of_the_plain_forward(kind, dt):
    """Both scans at two caller chunks of 40 (three kernel chunks, one
    across the caller chunks' edge), with B, C or q, k, v in ``dt`` and
    the final state's cotangents in play: the op's gradients against
    autograd through the plain forward, at 1e-5 of the largest value in
    fp32 (the same sums in another order) and 2e-2 in bf16 (the
    gradients of bf16 inputs are rounded to bf16)."""
    tol = TOL if dt == torch.float32 else 2e-2
    gen = torch.Generator().manual_seed(2)
    rn = lambda *s, dt=torch.float32: torch.randn(
        *s, generator=gen).to(dt).requires_grad_()
    decay = torch.cumsum(-0.3 * torch.rand(2, 2, 40, 3, generator=gen), 2)
    if kind == "mamba":
        ins = (rn(2, 2, 40, 3, 8), rn(2, 2, 40, 5, dt=dt),
               rn(2, 2, 40, 5, dt=dt), decay.requires_grad_())
        op, plain = K.mamba_chunk_scan, K.mamba_chunk_scan_plain
    else:
        ins = (rn(2, 2, 40, 3, 8, dt=dt), rn(2, 2, 40, 3, 8, dt=dt),
               rn(2, 2, 40, 3, 8, dt=dt), decay.requires_grad_(),
               rn(2, 2, 40, 3))
        op, plain = K.mlstm_chunk_scan, K.mlstm_chunk_scan_plain
    outs = op(*ins)
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    got = torch.autograd.grad(outs, ins, cots)
    want = torch.autograd.grad(plain(*ins), ins, cots)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        scale = max(1.0, float(b.float().abs().max()))
        _close(a.float() / scale, b.float() / scale, tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_custom_op_grads_equal_autograd_of_the_plain_forward(dt):
    """fp32: the ops' gradients equal autograd through the plain
    forwards at 1e-5.  bf16 (the trained dtype): the op's explicit
    backward takes rowsum(dout * out) of the rounded output where
    autograd takes the fp32 P's, so it agrees within a bf16 step."""
    tol = TOL if dt == torch.float32 else 2e-2
    gen = torch.Generator().manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=gen).to(dt).requires_grad_()
    x, s = rn(2, 6, 32), torch.randn(32, generator=gen).requires_grad_()
    g = torch.randn(2, 6, 32, generator=gen).to(dt)
    got = torch.autograd.grad(K.rmsnorm(x, s), (x, s), g)
    want = torch.autograd.grad(K.rmsnorm_plain(x, s), (x, s), g)
    for a, b in zip(got, want):
        _close(a.float(), b.float(), tol)
    q, k, v = rn(2, 9, 8, 16), rn(2, 9, 2, 16), rn(2, 9, 2, 16)
    dout = torch.randn(2, 9, 8, 16, generator=gen).to(dt)
    got = torch.autograd.grad(K.flash_attention(q, k, v, window=4),
                              (q, k, v), dout)
    want = torch.autograd.grad(K.flash_attention_plain(q, k, v, window=4),
                               (q, k, v), dout)
    for a, b in zip(got, want):
        _close(a.float(), b.float(), tol)


def test_serving_forward_records_nothing_for_a_backward():
    """Serving params do not require grad, so a served forward under grad
    mode builds no graph."""
    cfg = smoke_shrink(get_config("qwen2.5-3b"), dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    logits, _ = M.forward(params, cfg, {"tokens": torch.zeros(
        1, 6, dtype=torch.int32)})
    assert logits.grad_fn is None


def test_serving_exports_keep_their_op_nodes():
    """``torch.export`` of cody-mnist's prefill and fused decode steps and
    of zamba2-1.2b's and xlstm-350m's prefill: the same ``repro_torch`` op
    nodes as before the backwards were registered (counted on the trees
    before each registration), and no backward node."""
    cfg = smoke_shrink(get_config("cody-mnist"), dtype="float32")
    tree = L.to_tree(M.init_params(cfg, 0, device="cpu"))
    toks = torch.zeros(2, 8, dtype=torch.int32)
    progs = {
        "prefill": compile_artifact("prefill", ST.make_prefill_step(cfg, 32),
                                    (tree, {"tokens": toks})),
        "decode": compile_artifact(
            "decode", ST.make_fused_decode_step(cfg, 4),
            (tree, torch.zeros(2, dtype=torch.int32),
             torch.full((2,), 8, dtype=torch.int32),
             M.init_cache(cfg, 2, 32, device="cpu")))}
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        rc = smoke_shrink(get_config(arch), dtype="float32")
        progs[arch] = compile_artifact(
            "prefill", ST.make_prefill_step(rc, 32),
            (L.to_tree(M.init_params(rc, 0, device="cpu")),
             {"tokens": torch.zeros(1, 8, dtype=torch.int32)}))
    want = {"prefill": ({"repro_torch.rmsnorm.default": 5,
                         "repro_torch.flash_attention.default": 2}, 171),
            "decode": ({"repro_torch.rmsnorm.default": 20,
                        "repro_torch.decode_attention.default": 8}, 732),
            "zamba2-1.2b": ({"repro_torch.rmsnorm.default": 13,
                             "repro_torch.mamba_chunk_scan.default": 4,
                             "repro_torch.flash_attention.default": 2}, 575),
            "xlstm-350m": ({"repro_torch.rmsnorm.default": 13,
                            "repro_torch.mlstm_chunk_scan.default": 5}, 523)}
    for name, rec in progs.items():
        ep = torch.export.load(io.BytesIO(rec.payload))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        ops = collections.Counter(t for t in targets if "repro_torch" in t)
        assert (dict(ops), len(ep.graph.nodes)) == want[name]
        assert not [t for t in targets if "backward" in t]
