"""The moe family's gradients on the CPU against the JAX reference, in
fp32: ``moe_gmm_backward_plain`` and the autograd registered on
``moe_gmm`` against ``jax.vjp`` of the reference's ``moe_gmm``
(``repro/kernels/ref.py:95``, the function its Pallas kernel computes) at
ragged shapes; ``flash_attention_backward_plain`` at MLA's head dims
(the smoke model's hd 24, hd_v 16 and deepseek's 192, 128) against
``jax.vjp`` of ``repro/models/layers.py:chunked_attention``; and the
gradients of ``apply_moe`` under capacity overflow, where the (token, k)
pairs past an expert's capacity are dropped: both packages give those
pairs no expert gradient.  The limit is 1e-5 (atol = rtol) of the
largest value: each gradient sums up to a few hundred products, which the
two frameworks round in other orders.  The whole train step of both moe
archs is held to the reference's in ``tests/test_torch_train.py``."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")
TOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    """atol = rtol = tol of the largest value of b."""
    a, b = _np(a), _np(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a / scale, b / scale, atol=tol, rtol=tol)


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (E, R, D, F): R the capacity rows (6: a decode-sized group, 30, 128: the
# train row's), D and F off the kernels' 64- and 256-wide tiles
GMM_CASES = [(3, 6, 40, 72), (4, 30, 100, 56), (2, 128, 136, 24),
             (5, 1, 8, 8)]


@pytest.mark.parametrize("E,R,D,F", GMM_CASES)
def test_moe_gmm_backward_plain_matches_jax_vjp(E, R, D, F):
    """dx = dy wᵀ and dw = xᵀ dy against jax.vjp of the reference's
    moe_gmm; the op's registered autograd (the CPU takes the plain
    backward) gives the same bits."""
    rng = np.random.default_rng(E * R + D)
    x, w, dy = _f32(rng, (E, R, D), D ** -0.5), _f32(rng, (E, D, F)), \
        _f32(rng, (E, R, F))
    y, vjp = jax.vjp(JREF.moe_gmm, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    dx, dw = K.moe_gmm_backward_plain(*map(torch.from_numpy, (x, w, dy)))
    assert dx.shape == (E, R, D) and dw.shape == (E, D, F)
    _close(dx, jdx)
    _close(dw, jdw)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = K.moe_gmm(xt, wt)
    _close(out, y)
    gx, gw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dy))
    assert torch.equal(gx, dx) and torch.equal(gw, dw)
    assert K.moe_gmm_backward(*map(torch.from_numpy, (x, w, dy)))[1].equal(dw)


def test_moe_gmm_gradcheck_in_fp64():
    """The registered autograd against finite differences (the plain
    versions compute in fp64 for fp64 inputs)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 7, generator=gen, dtype=torch.float64)
    w = torch.randn(2, 7, 3, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        K.moe_gmm, (x.requires_grad_(), w.requires_grad_()))


# (hd, hd_v, B, S, H, causal): the smoke MLA's head dims and deepseek's
MLA_CASES = [(24, 16, 2, 37, 4, True), (192, 128, 1, 37, 2, True),
             (192, 128, 1, 20, 2, False)]


@pytest.mark.parametrize("hd,hd_v,B,S,H,causal", MLA_CASES)
def test_flash_backward_plain_at_mla_head_dims_matches_jax_vjp(
        hd, hd_v, B, S, H, causal):
    """dq, dk (hd) and dv (hd_v) against jax.vjp of chunked_attention,
    whose scale is hd ** -0.5 of the query's head dim; the op's autograd
    gives the plain backward's bits, and the bf16 kernel's decomposition
    (``flash_attention_backward_staged``) the same gradients."""
    rng = np.random.default_rng(hd + S)
    q, k = _f32(rng, (B, S, H, hd)), _f32(rng, (B, S, H, hd))
    v, dout = _f32(rng, (B, S, H, hd_v)), _f32(rng, (B, S, H, hd_v))
    jout, vjp = jax.vjp(
        lambda q, k, v: JL.chunked_attention(q, k, v, causal=causal,
                                             chunk=16),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dout))
    out = K.flash_attention_plain(qt, kt, vt, causal=causal)
    _close(out, jout)
    got = K.flash_attention_backward_plain(qt, kt, vt, out, dt,
                                           causal=causal)
    for a, b, width in zip(got, want, (hd, hd, hd_v)):
        assert a.shape[-1] == width
        _close(a, b)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    auto = torch.autograd.grad(K.flash_attention(*leaves, causal=causal),
                               leaves, dt)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))
    staged = FA.flash_attention_backward_staged(qt, kt, vt, out, dt,
                                                causal=causal)
    for a, b in zip(staged, want):
        _close(a, b)


def _overflow_setup(arch):
    """fp32 smoke configs of ``arch`` at capacity factor 0.5, the
    reference's MoE layer params, and a batch of T = 256 tokens (one
    group)."""
    over = dict(capacity_factor=0.5)
    jcfg = jax_smoke_shrink(jax_get_config(arch), dtype="float32")
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **over))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))
    mode = "expert" if cfg.moe.num_experts >= 16 else "ffn"
    jp = JL.materialize(JMOE.moe_schema(jcfg, mode), jax.random.PRNGKey(7),
                        "float32")
    x = _f32(np.random.default_rng(11), (2, 128, cfg.d_model))
    return jcfg, cfg, jp, x


def _grads_both(jcfg, cfg, jp, x, gy):
    """The gradients of sum(y gy) + 0.01 aux over the layer's params and
    x, in the reference (jax.grad) and in the port (autograd through
    moe_gmm's registered backward): ({name: (port, reference)}, x's)."""
    def jloss(p, x):
        y, aux = JMOE.apply_moe(p, x, jcfg)
        return (y * gy).sum() + 0.01 * aux
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    names = sorted(jp)
    leaves = [torch.from_numpy(np.array(jp[n])).requires_grad_()
              for n in names]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = TMOE.apply_moe(dict(zip(names, leaves)), xt, cfg)
    loss = (y * torch.from_numpy(gy)).sum() + 0.01 * aux
    grads = torch.autograd.grad(loss, leaves + [xt])
    return ({n: (g, jgp[n]) for n, g in zip(names, grads)},
            (grads[-1], jgx))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_dropped_pairs_get_no_expert_gradient_in_both(arch):
    """Capacity factor 0.5: half of the (token, k) pairs of a group of 256
    overflow their expert and are dropped (the reference's moe.py:68-75).
    Every gradient of the layer equals the reference's; and a cotangent
    on the rows of the tokens whose every pair was dropped reaches no
    expert weight: w1, w3 and w2 get exact zeros in both packages."""
    jcfg, cfg, jp, x = _overflow_setup(arch)
    m = cfg.moe
    xt = torch.from_numpy(x).reshape(1, 256, cfg.d_model)
    _, _, top_i = TMOE.route({"router": torch.from_numpy(
        np.array(jp["router"]))}, xt, cfg)
    onehot = torch.nn.functional.one_hot(top_i, m.num_experts).float()
    pos = torch.cumsum(onehot.reshape(1, -1, m.num_experts), 1).reshape(
        onehot.shape) - onehot
    C = TMOE._capacity(256, m.top_k, m.num_experts, m.capacity_factor)
    kept = ((pos < C) * onehot).sum((-1, -2))[0]        # pairs kept a token
    assert int(kept.sum()) < 256 * m.top_k               # pairs were dropped
    all_dropped = (kept == 0).numpy()
    assert all_dropped.any()

    rng = np.random.default_rng(12)
    grads, (gx, jgx) = _grads_both(jcfg, cfg, jp, x,
                                   _f32(rng, x.shape))
    for name, (g, jg) in grads.items():
        _close(g, jg)
    _close(gx, jgx)

    gy = _f32(rng, x.shape).reshape(256, -1)
    gy[~all_dropped] = 0.0
    grads, _ = _grads_both(jcfg, cfg, jp, x, gy.reshape(x.shape))
    for name in ("w1", "w3", "w2"):
        g, jg = grads[name]
        assert not torch.any(g) and not np.any(np.asarray(jg)), name


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_moe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,layers", [("deepseek-v2-lite-16b", 4),
                                         ("mixtral-8x22b", 2)])
def test_train_step_runs_the_backwards_chip_smoke_counts(arch, layers):
    """``chip_smoke.py:_train_launches``, which phase train holds the
    card's launch counters to, against the backward ops one CPU train step
    of the smoke config dispatches: 3 L + 1 rmsnorm with MLA, a flash a
    layer, three moe_gmm a routed layer, each once per forward call."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    from repro_torch.training import optimizer as TO
    from repro_torch.training import steps as TST

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if name.startswith("repro_torch."):
                self.ops[name.split(".")[1]] += 1
            return func(*args, **(kwargs or {}))

    cfg = dataclasses.replace(smoke_shrink(get_config(arch),
                                           dtype="float32"),
                              num_layers=layers)
    tree = TL.to_tree(TM.init_params(cfg, 0, device="cpu"))
    step = TST.make_train_step(cfg, TO.AdamWConfig(warmup_steps=1,
                                                   decay_steps=10),
                               remat="none")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    with Count() as count:
        step(TO.init_opt_state(tree), batch)
    want = _chip_smoke()._train_launches(cfg)
    got = {f"{k}_backward": count.ops[f"{k}_backward"]
           for k in ("rmsnorm", "flash_attention", "mamba_chunk_scan",
                     "mlstm_chunk_scan", "moe_gmm")}
    assert got == want
    for k in ("rmsnorm", "flash_attention", "moe_gmm"):
        assert count.ops[k] == count.ops[f"{k}_backward"], k
