"""The port's moe family (deepseek: MLA + routed/shared experts; mixtral:
GQA + routed experts) against the JAX reference, in fp32 at smoke widths.

The same numpy-seeded inputs and the reference's own parameters (carried
over by ``params_from_jax``) go through both packages.  The limit is
1e-4 (atol = rtol): the two frameworks sum in different orders, and the
routing (top-k, capacity, drops) is discrete, so agreement to rounding
also shows that every token went to the same experts and slots.
``moe_gmm`` in bf16 is held to 2e-2, one bf16 step at |y| in [1, 2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import \
    cache_batch_axes_for as jax_cache_batch_axes_for  # noqa: E402
from repro.sharding import rules_for  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cache import cache_leaves  # noqa: E402
from repro_torch.serving.engine import cache_batch_axes_for  # noqa: E402
from repro_torch.training import steps as TST  # noqa: E402

TOL = 1e-4
CACHE_LEN = 48
ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x22b"]
jax_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
jax_decode_step = jax.jit(JM.decode_step, static_argnums=(1,))
jax_apply_moe = jax.jit(JMOE.apply_moe, static_argnums=(2,))
jax_mla_attention = jax.jit(JL.mla_attention, static_argnums=(2,))
jax_mla_decode = jax.jit(JL.mla_decode, static_argnums=(2,))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _pair(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _cfgs(arch, **over):
    return (jax_smoke_shrink(jax_get_config(arch), dtype="float32", **over),
            smoke_shrink(get_config(arch), dtype="float32", **over))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, cfg = _cfgs(request.param)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


# ---------------------------------------------------------------- kernels --
@pytest.mark.parametrize("E,C,D,F,dt", [
    (4, 256, 128, 256, "bfloat16"), (2, 128, 256, 128, "float32"),  # as
    (8, 6, 256, 128, "float32"),     # tests/test_kernels.py; decode-like C
])
def test_moe_gmm_plain_vs_pallas_and_ref(E, C, D, F, dt):
    rng = np.random.default_rng(C)
    xj, xt = _pair(rng, (E, C, D), D ** -0.5)
    wj, wt = _pair(rng, (E, D, F))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dt == "bfloat16" \
        else (jnp.float32, torch.float32)
    xj, wj, xt, wt = xj.astype(jdt), wj.astype(jdt), xt.to(tdt), wt.to(tdt)
    got = K.moe_gmm_plain(xt, wt)
    assert got.dtype == tdt and got.shape == (E, C, F)
    tol = 2e-2 if dt == "bfloat16" else TOL
    _close(got, ref.moe_gmm(xj, wj), tol)
    _close(got, ops.moe_gmm(xj, wj), tol)
    assert torch.equal(K.moe_gmm(xt, wt), got)      # CPU: the plain version


def test_flash_plain_at_mla_head_dims_vs_chunked_attention():
    """hd 24 = 16 + 8 rope against hd_v 16 (the smoke MLA); the scale is
    hd ** -0.5 of the query's head dim."""
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (2, 37, 4, 24))
    kj, kt = _pair(rng, (2, 37, 4, 24))
    vj, vt = _pair(rng, (2, 37, 4, 16))
    got = K.flash_attention_plain(qt, kt, vt, causal=True)
    assert got.shape == (2, 37, 4, 16)
    _close(got, JL.chunked_attention(qj, kj, vj, causal=True, chunk=16))
    assert torch.equal(K.flash_attention(qt, kt, vt, causal=True), got)


# ------------------------------------------------------------- MoE layer --
MOE_CASES = [(1, 4, {}), (1, 64, {}), (2, 128, {}), (2, 256, {}),
             (2, 128, {"capacity_factor": 0.5})]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S,moe_over", MOE_CASES)
def test_apply_moe_vs_reference(arch, B, S, moe_over):
    """T = B·S of 4, 64, 256 and 512 (two groups of 256 for deepseek), and
    a capacity small enough that tokens are certainly dropped."""
    jcfg, cfg = _cfgs(arch)
    if moe_over:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_over))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
        m, g = cfg.moe, min(cfg.moe.group_size, B * S)
        C = TMOE._capacity(g, m.top_k, m.num_experts, m.capacity_factor)
        assert m.num_experts * C < g * m.top_k      # drops by pigeonhole
    mode = "expert" if cfg.moe.num_experts >= 16 else "ffn"
    jp = JL.materialize(JMOE.moe_schema(jcfg, mode), jax.random.PRNGKey(3),
                        "float32")
    xj, xt = _pair(np.random.default_rng(S), (B, S, cfg.d_model))
    yj, auxj = jax_apply_moe(jp, xj, jcfg)
    yt, auxt = TMOE.apply_moe(_tree_to_torch(jp), xt, cfg)
    _close(yt, yj)
    _close(auxt, auxj)


@pytest.mark.parametrize("arch", ARCHS)
def test_group_not_dividing_the_tokens_raises_in_both(arch):
    """The reference asserts T % g == 0 (moe.py:59); three prompts of 128
    (T = 384) against deepseek's group of 256 fail in both packages.
    mixtral's group is 1024, so 384 tokens are one group there."""
    jcfg, cfg = _cfgs(arch)
    mode = "expert" if cfg.moe.num_experts >= 16 else "ffn"
    jp = JL.materialize(JMOE.moe_schema(jcfg, mode), jax.random.PRNGKey(3),
                        "float32")
    xj, xt = _pair(np.random.default_rng(0), (3, 128, cfg.d_model))
    if cfg.moe.group_size == 256:
        with pytest.raises(AssertionError, match="tokens 384 not divisible"):
            JMOE.apply_moe(jp, xj, jcfg)
        with pytest.raises(ValueError, match="tokens 384 not divisible"):
            TMOE.apply_moe(_tree_to_torch(jp), xt, cfg)
    else:
        _close(TMOE.apply_moe(_tree_to_torch(jp), xt, cfg)[0],
               jax_apply_moe(jp, xj, jcfg)[0])


# -------------------------------------------------------------------- MLA --
@pytest.mark.parametrize("S", [5, 19])
def test_mla_attention_and_decode_vs_reference(S):
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    jp = JL.materialize(JL.mla_schema(jcfg), jax.random.PRNGKey(4),
                        "float32")
    tp = _tree_to_torch(jp)
    xj, xt = _pair(np.random.default_rng(S), (2, S, cfg.d_model))
    oj, (cj, krj) = jax_mla_attention(jp, xj, jcfg)
    ot, (ct, krt) = TL.mla_attention(tp, xt, cfg)
    for a, b in ((ot, oj), (ct, cj), (krt, krj)):
        _close(a, b)
    W = 32
    pad = lambda t: np.pad(np.asarray(t), ((0, 0), (0, W - S), (0, 0)))
    cache_j = [jnp.asarray(pad(cj)), jnp.asarray(pad(krj))]
    cache_t = [torch.from_numpy(pad(cj)), torch.from_numpy(pad(krj))]
    for step in range(3):
        xj, xt = _pair(np.random.default_rng(50 + step), (2, 1, cfg.d_model))
        pos = np.array([S + step, S - 2 + step], np.int32)
        oj, *cache_j = jax_mla_decode(jp, xj, jcfg, *cache_j,
                                      jnp.asarray(pos))
        ot, *cache_t = TL.mla_decode(tp, xt, cfg, *cache_t,
                                     torch.from_numpy(pos))
        _close(ot, oj)
    for a, b in zip(cache_t, cache_j):
        _close(a, b)


# ------------------------------------------------------------------ model --
def test_params_carry_over_stacked_experts(setup):
    """A stacked [n,E,D,F] expert leaf un-stacks to per-block [E,D,F]; the
    router stays fp32."""
    jcfg, cfg, jp, tp = setup
    n_ref = sum(x.size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    jstage = jp["stages"][-1]["moe"]
    blocks = tp["stages"][-1]
    assert np.asarray(jstage["w1"]).ndim == 4 and len(blocks) > 1
    for i, blk in enumerate(blocks):
        _close(blk["moe"]["w1"], np.asarray(jstage["w1"])[i], 0)
        _close(blk["moe"]["w2"], np.asarray(jstage["w2"])[i], 0)
    assert blocks[0]["moe"]["router"].dtype == torch.float32
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    tb = params_from_jax(bf16, jax.tree.map(np.asarray, jp), device="cpu")
    assert tb["stages"][-1][0]["moe"]["router"].dtype == torch.float32
    assert tb["stages"][-1][0]["moe"]["w1"].dtype == torch.bfloat16


@pytest.mark.parametrize("S", [13, 32])
def test_prefill_logits_aux_and_caches(setup, S):
    jcfg, cfg, jp, tp = setup
    toks = np.random.default_rng(S).integers(3, cfg.vocab_size, (2, S),
                                             dtype=np.int32)
    jl, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                        CACHE_LEN)
    _close(tl, jl)
    _, jaux = jax.jit(JM.forward, static_argnums=(1,))(
        jp, jcfg, {"tokens": jnp.asarray(toks)})
    fl, taux = TM.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(fl, tl)
    _close(taux, jaux)
    assert [tuple(c.shape) for c in cache_leaves(tc)] == \
        [tuple(c.shape) for c in jax.tree.leaves(jc)]
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_decode_steps_logits_and_caches(setup):
    jcfg, cfg, jp, tp = setup
    toks = np.random.default_rng(1).integers(3, cfg.vocab_size, (2, 9),
                                             dtype=np.int32)
    _, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    _, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                       CACHE_LEN)
    tok, pos = toks[:, -1], np.full(2, 9, np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for step in range(6):
        jl, jc = jax_decode_step(jp, jcfg, jtok, jnp.asarray(pos + step), jc)
        tl, tc = TM.decode_step(tp, cfg, ttok, torch.from_numpy(pos + step),
                                tc)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_fused_decode_step(setup):
    jcfg, cfg, jp, tp = setup
    toks = np.random.default_rng(2).integers(3, cfg.vocab_size, (3, 7),
                                             dtype=np.int32)
    jout, jc = jax.jit(JST.make_prefill_step(jcfg, None, CACHE_LEN))(
        jp, {"tokens": jnp.asarray(toks)})
    tout, tc = TST.make_prefill_step(cfg, CACHE_LEN)(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tout["next_tokens"].numpy(),
                                  np.asarray(jout["next_tokens"]))
    eos = int(np.asarray(jout["next_tokens"])[0])   # exercise the freeze
    first, pos = np.array(jout["next_tokens"]), np.full(3, 7, np.int32)
    jo, jc = jax.jit(JST.make_fused_decode_step(jcfg, None, k=5, eos_id=eos))(
        jp, jnp.asarray(first), jnp.asarray(pos), jc)
    to, tc = TST.make_fused_decode_step(cfg, k=5, eos_id=eos)(
        tp, torch.from_numpy(first), torch.from_numpy(pos), tc)
    for name in ("tokens", "pos", "done"):
        np.testing.assert_array_equal(to[name].numpy(), np.asarray(jo[name]))
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_axes_match_reference(arch, smoke):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if smoke:
        cfg, jcfg = smoke_shrink(cfg), jax_smoke_shrink(jcfg)
    assert cache_batch_axes_for(cfg) == jax_cache_batch_axes_for(jcfg)
    init = cache_leaves(TM.init_cache(cfg, 3, 8, device="meta"))
    assert all(c.shape[ax] == 3
               for c, ax in zip(init, cache_batch_axes_for(cfg)))


# ---------------------------------------------------------------- serving --
@pytest.mark.parametrize("speculate,depth", [(True, 4), (False, 1)])
def test_deepseek_engine_matches_jax_engine(speculate, depth):
    """Batched (grouped, right-padded) prefill and the fused decode through
    the whole serving stack, the JAX side built as
    tests/test_torch_serving.py builds it: the same tokens, host syncs and
    speculation counts.  Padding and bucket neighbours share the MoE
    groups in both, so the tokens agree only if the port routes and drops
    exactly as the reference does."""
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    block_k, n_slots, cache_len = 4, 2, 96
    rules = rules_for("serve", make_host_mesh(model=1).axis_names)
    jeng = JaxEngine(
        jp, jax.jit(JST.make_prefill_step(jcfg, rules, cache_len)),
        jax.jit(JST.make_fused_decode_step(jcfg, rules, k=block_k, eos_id=2),
                donate_argnums=(3,)),
        n_slots=n_slots, cache_len=cache_len, block_k=block_k, eos_id=2,
        init_caches_fn=lambda: JM.init_cache(jcfg, n_slots, cache_len),
        cache_batch_axes=jax_cache_batch_axes_for(jcfg), speculate=speculate,
        pipeline_depth=depth,
        batched_prefill_fn=jax.jit(
            JST.make_batched_prefill_step(jcfg, rules, cache_len)))
    eng = serve.build_engine(cfg, n_slots=n_slots, cache_len=cache_len,
                             block_k=block_k, params=tp, device="cpu",
                             speculate=speculate, pipeline_depth=depth)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(3, cfg.vocab_size, n)))
               for n in (12, 5, 17, 9, 30)]
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p, 14)
    assert eng.run() == jeng.run()
    stats = ("host_syncs", "spec_blocks", "sync_blocks", "mispredicts",
             "blocks_dispatched", "prefill_dispatches", "retired")
    assert {k: eng.stats[k] for k in stats} == \
        {k: jeng.stats[k] for k in stats}
    assert eng.spec.stats == jeng.spec.stats
