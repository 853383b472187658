"""The port's recurrent families (zamba2: Mamba2 + shared attention;
xLSTM: mLSTM + sLSTM) against the JAX reference, in fp32 at smoke widths.

The same numpy-seeded inputs go through both packages.  The limit is
1e-4 (atol = rtol): the reference sums the chunk states with an
``associative_scan``, the port carries them chunk by chunk, so the sums
are taken in a different order.  Prompt lengths 12, 17 and 32 at the
smoke chunk of 16 give Q = 12 (one chunk), Q = 1 (17 chunks) and nc = 2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.core.channel import LiveChannel as JaxLiveChannel  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.serve import stream_kwargs as jax_stream_kwargs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models import xlstm as JXL  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import \
    cache_batch_axes_for as jax_cache_batch_axes_for  # noqa: E402
from repro.sharding import rules_for  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models import xlstm as TXL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cache import cache_leaves  # noqa: E402
from repro_torch.serving.engine import cache_batch_axes_for  # noqa: E402
from repro_torch.training import steps as TST  # noqa: E402

TOL = 1e-4
# xLSTM's full-model prefill logits: its smoke model amplifies each layer's
# fp32 rounding about threefold per layer.  Layer by layer the port's
# outputs are as close to a float64 run as the reference's own (both
# 1.5e-5 relative), but after six layers one logit of 8704 at S = 17
# differs by 1.2e-4 (the reference's fp32 logits are 7.3e-5 from its
# float64 ones there, and its jit and eager runs differ by 6.0e-5).
XLSTM_LOGITS_TOL = 2e-4
CACHE_LEN = 48
ARCHS = ["zamba2-1.2b", "xlstm-350m"]
PLENS = [12, 17, 32]
jax_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
jax_decode_step = jax.jit(JM.decode_step, static_argnums=(1,))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _pair(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = jax_smoke_shrink(jax_get_config(arch), dtype="float32")
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


# ---------------------------------------------------------------- kernels --
@pytest.mark.parametrize("B,nc,Q", [(1, 3, 1), (2, 1, 12), (1, 2, 16),
                                    (1, 1, 37)])
def test_mamba_scan_plain_vs_pallas_and_ref(B, nc, Q):
    rng = np.random.default_rng(Q)
    nh, P, N = 3, 8, 8
    xj, xt = _pair(rng, (B, nc, Q, nh, P), 0.5)
    bj, bt = _pair(rng, (B, nc, Q, N), 0.5)
    cj, ct = _pair(rng, (B, nc, Q, N), 0.5)
    da = -np.abs(rng.standard_normal((B, nc, Q, nh))).astype(np.float32) * .1
    cum = np.cumsum(da, axis=2)
    y, st = K.mamba_chunk_scan_plain(xt, bt, ct, torch.from_numpy(cum))
    assert y.dtype == st.dtype == torch.float32
    y_k, st_k = ops.mamba_chunk_scan(xj, bj, cj, jnp.asarray(cum))
    _close(y, y_k)
    _close(st, st_k)
    h = jnp.zeros((B, nh, P, N))
    for c in range(nc):
        y_c, h = ref.mamba_chunk(xj[:, c], bj[:, c], cj[:, c],
                                 jnp.asarray(cum[:, c]), h)
        _close(y[:, c], y_c)
    _close(st, h)


@pytest.mark.parametrize("B,nc,Q", [(1, 3, 1), (2, 1, 12), (1, 2, 16),
                                    (1, 1, 37)])
def test_mlstm_scan_plain_vs_pallas_and_ref(B, nc, Q):
    rng = np.random.default_rng(Q)
    nh, dh = 2, 16
    qj, qt = _pair(rng, (B, nc, Q, nh, dh), 0.3)
    kj, kt = _pair(rng, (B, nc, Q, nh, dh), 0.3)
    vj, vt = _pair(rng, (B, nc, Q, nh, dh), 0.3)
    lf = -np.abs(rng.standard_normal((B, nc, Q, nh))).astype(np.float32) * .2
    cumf = np.cumsum(lf, axis=2)
    li = np.minimum(rng.standard_normal((B, nc, Q, nh)), 2.0).astype(
        np.float32)
    y, C, n = K.mlstm_chunk_scan_plain(qt, kt, vt, torch.from_numpy(cumf),
                                       torch.from_numpy(li))
    _close(y, ops.mlstm_chunk_scan(qj, kj, vj, jnp.asarray(cumf),
                                   jnp.asarray(li)))
    hh, nn = jnp.zeros((B, nh, dh, dh)), jnp.zeros((B, nh, dh))
    for c in range(nc):
        y_c, hh, nn = ref.mlstm_chunk(qj[:, c], kj[:, c], vj[:, c],
                                      jnp.asarray(cumf[:, c]),
                                      jnp.asarray(li[:, c]), hh, nn)
        _close(y[:, c], y_c)
    _close(C, hh)
    _close(n, nn)


@pytest.mark.parametrize("S", PLENS)
def test_mamba2_forward_and_decode_vs_reference(S):
    jcfg = jax_smoke_shrink(jax_get_config("zamba2-1.2b"), dtype="float32")
    cfg = smoke_shrink(get_config("zamba2-1.2b"), dtype="float32")
    jp = JL.materialize(JSSM.mamba2_schema(jcfg), jax.random.PRNGKey(1),
                        "float32")
    tp = _tree_to_torch(jp)
    xj, xt = _pair(np.random.default_rng(S), (2, S, cfg.d_model))
    yj, sj = jax.jit(JSSM.mamba2_forward, static_argnums=(2,))(jp, xj, jcfg)
    yt, s_t = TSSM.mamba2_forward(tp, xt, cfg)
    _close(yt, yj)
    for a, b in zip(cache_leaves(s_t), jax.tree.leaves(sj)):
        _close(a, b)
    jdec = jax.jit(JSSM.mamba2_decode, static_argnums=(2,))
    for step in range(3):
        xj, xt = _pair(np.random.default_rng(100 + step), (2, 1, cfg.d_model))
        yj, sj = jdec(jp, xj, jcfg, sj)
        yt, s_t = TSSM.mamba2_decode(tp, xt, cfg, s_t)
        _close(yt, yj)
    for a, b in zip(cache_leaves(s_t), jax.tree.leaves(sj)):
        _close(a, b)


@pytest.mark.parametrize("S", PLENS)
def test_xlstm_cells_forward_and_decode_vs_reference(S):
    jcfg = jax_smoke_shrink(jax_get_config("xlstm-350m"), dtype="float32")
    cfg = smoke_shrink(get_config("xlstm-350m"), dtype="float32")
    key = jax.random.PRNGKey(2)
    for schema, fwd, dec, jfwd, jdec in (
            (JXL.mlstm_schema, TXL.mlstm_forward, TXL.mlstm_decode,
             JXL.mlstm_forward, JXL.mlstm_decode),
            (JXL.slstm_schema, TXL.slstm_forward, TXL.slstm_decode,
             JXL.slstm_forward, JXL.slstm_decode)):
        jp = JL.materialize(schema(jcfg), key, "float32")
        tp = _tree_to_torch(jp)
        jfwd = jax.jit(jfwd, static_argnums=(2,))
        jdec = jax.jit(jdec, static_argnums=(2,))
        xj, xt = _pair(np.random.default_rng(S), (2, S, cfg.d_model))
        yj, sj = jfwd(jp, xj, jcfg)
        yt, s_t = fwd(tp, xt, cfg)
        _close(yt, yj)
        for a, b in zip(s_t, sj):
            _close(a, b)
        names = ("C", "n") if len(s_t) == 2 else ("h", "c", "n", "m")
        sj, s_t = dict(zip(names, sj)), dict(zip(names, s_t))
        for step in range(3):
            xj, xt = _pair(np.random.default_rng(100 + step),
                           (2, 1, cfg.d_model))
            yj, sj = jdec(jp, xj, jcfg, sj)
            yt, s_t = dec(tp, xt, cfg, s_t)
            _close(yt, yj)
        for name in names:
            _close(s_t[name], sj[name])


# ------------------------------------------------------------------ model --
def test_params_carry_over_nested_stacks(setup):
    jcfg, cfg, jp, tp = setup
    n_ref = sum(x.size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    g = len(tp["stages"][0]) - 1          # the last group
    if cfg.family == "hybrid":
        inner = np.asarray(jp["stages"][0]["mambas"]["mamba"]["w_x"])
        _close(tp["stages"][0][g]["mambas"][1]["mamba"]["w_x"],
               inner[g, 1], 0)
        _close(tp["shared"]["attn"]["wq"],
               np.asarray(jp["shared"]["attn"]["wq"]), 0)
    else:
        inner = np.asarray(jp["stages"][0]["m"]["cell"]["wq"])
        want = inner[g, 3] if inner.ndim == 4 else inner[3]
        _close(tp["stages"][0][g]["m"][3]["cell"]["wq"], want, 0)
        _close(tp["stages"][0][g]["s"]["cell"]["r_gates"],
               np.asarray(jp["stages"][0]["s"]["cell"]["r_gates"]), 0)


@pytest.mark.parametrize("S", PLENS)
def test_prefill_logits_and_caches(setup, S):
    jcfg, cfg, jp, tp = setup
    toks = np.random.default_rng(S).integers(3, cfg.vocab_size, (2, S),
                                             dtype=np.int32)
    jl, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                        CACHE_LEN)
    tol = XLSTM_LOGITS_TOL if cfg.family == "ssm" else TOL
    _close(tl, jl, tol)
    assert torch.equal(
        TM.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})[0], tl)
    assert [tuple(c.shape) for c in cache_leaves(tc)] == \
        [tuple(c.shape) for c in jax.tree.leaves(jc)]
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_decode_steps_logits_and_caches(setup):
    jcfg, cfg, jp, tp = setup
    toks = np.random.default_rng(1).integers(3, cfg.vocab_size, (2, 17),
                                             dtype=np.int32)
    _, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    _, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                       CACHE_LEN)
    tok = toks[:, -1]
    pos = np.full(2, 17, np.int32)
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
    toks = np.random.default_rng(2).integers(3, cfg.vocab_size, (3, 32),
                                             dtype=np.int32)
    jout, jc = jax.jit(JST.make_prefill_step(jcfg, None, CACHE_LEN))(
        jp, {"tokens": jnp.asarray(toks)})
    tout, tc = TST.make_prefill_step(cfg, CACHE_LEN)(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tout["next_tokens"].numpy(),
                                  np.asarray(jout["next_tokens"]))
    eos = int(np.asarray(jout["next_tokens"])[0])   # exercise the freeze
    first, pos = np.array(jout["next_tokens"]), np.full(3, 32, np.int32)
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
def test_engine_matches_jax_engine(setup):
    """Per-request prefill and the fused decode through the whole serving
    stack, with the JAX side built as tests/test_serving_multitenant.py
    builds it: the same tokens and the same host-sync counts."""
    jcfg, cfg, jp, tp = setup
    block_k, n_slots, cache_len = 4, 2, 96
    rules = rules_for("serve", make_host_mesh(model=1).axis_names)
    channel = JaxLiveChannel(
        jax.jit(JST.make_prefill_step(jcfg, rules, cache_len)),
        jax.jit(JST.make_fused_decode_step(jcfg, rules, k=block_k, eos_id=2),
                donate_argnums=(3,)))
    jeng = JaxEngine(jp, channel=channel, **jax_stream_kwargs(
        jcfg, n_slots=n_slots, cache_len=cache_len, block_k=block_k,
        eos_id=2, pipeline_depth=4))
    eng = serve.build_engine(cfg, n_slots=n_slots, cache_len=cache_len,
                             block_k=block_k, params=tp, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(3, cfg.vocab_size, n)))
               for n in (12, 17, 5, 32, 9)]
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p, 10)
    assert eng.run() == jeng.run()
    stats = ("host_syncs", "spec_blocks", "sync_blocks", "blocks_dispatched",
             "prefill_dispatches", "retired")
    assert {k: eng.stats[k] for k in stats} == \
        {k: jeng.stats[k] for k in stats}
    assert eng.stats["spec_blocks"] == 0 and eng.stats["prefill_dispatches"] \
        == len(prompts)



@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_conv_tail_raises_in_both(S):
    """A fault of the reference that the port keeps (ROADMAP Queue 3):
    ``mamba2_forward`` keeps ``xs_raw[:, -(K - 1):]`` as the conv tail for
    decode (``repro/models/ssm.py:83-84``, ``repro_torch/models/ssm.py:84``),
    which holds S rows, not K - 1 = 3, for a prompt of 1 or 2 tokens.
    Scattering it into the slot caches raises for 2 tokens in both
    packages alike; 1 token's row broadcasts over the 3 slots in both, so
    both serve the same (wrongly conditioned) tokens."""
    jcfg = jax_smoke_shrink(jax_get_config("zamba2-1.2b"), dtype="float32")
    cfg = smoke_shrink(get_config("zamba2-1.2b"), dtype="float32")
    assert cfg.ssm.conv_width - 1 == 3
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    block_k, n_slots, cache_len = 4, 2, 32
    rules = rules_for("serve", make_host_mesh(model=1).axis_names)
    channel = JaxLiveChannel(
        jax.jit(JST.make_prefill_step(jcfg, rules, cache_len)),
        jax.jit(JST.make_fused_decode_step(jcfg, rules, k=block_k, eos_id=2),
                donate_argnums=(3,)))
    jeng = JaxEngine(jp, channel=channel, **jax_stream_kwargs(
        jcfg, n_slots=n_slots, cache_len=cache_len, block_k=block_k,
        eos_id=2, pipeline_depth=4))
    eng = serve.build_engine(cfg, n_slots=n_slots, cache_len=cache_len,
                             block_k=block_k, params=tp, device="cpu")
    for e in (jeng, eng):
        e.submit([5, 6][:S], 4)
    if S == 1:
        assert eng.run() == jeng.run()
        return
    with pytest.raises(ValueError, match=r"\(2, 2, 1, 2, 16\).*"
                                         r"\(2, 2, 1, 3, 16\)"):
        jeng.run()
    with pytest.raises(RuntimeError, match=r"shape mismatch.*\[2, 2, 1, 2, "
                                           r"16\].*\[2, 2, 1, 3, 16\]"):
        eng.run()
