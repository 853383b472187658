"""The backward kernels' plain versions against ``jax.grad`` of the
reference's pure-JAX ``apply_norm`` and ``chunked_attention``
(``repro/models/layers.py:69``, ``:103``) at fp32 ``allclose`` 1e-5; the
custom ops' registered autograd on the CPU (gradcheck in fp64, and
against autograd through the plain forwards); and the serving exports,
whose op nodes the registration must leave as they were."""
import collections
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_plain_matches_jax_grad(case):
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
    """``torch.export`` of cody-mnist's prefill and fused decode steps:
    the same ``repro_torch`` op nodes as before the backwards were
    registered (counted on that tree), and no backward node."""
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
    want = {"prefill": ({"repro_torch.rmsnorm.default": 5,
                         "repro_torch.flash_attention.default": 2}, 171),
            "decode": ({"repro_torch.rmsnorm.default": 20,
                        "repro_torch.decode_attention.default": 8}, 732)}
    for name, rec in progs.items():
        ep = torch.export.load(io.BytesIO(rec.payload))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        ops = collections.Counter(t for t in targets if "repro_torch" in t)
        assert (dict(ops), len(ep.graph.nodes)) == want[name]
        assert not [t for t in targets if "backward" in t]
