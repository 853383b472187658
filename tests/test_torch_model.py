"""The port's dense model and serving steps against the JAX reference, in
fp32 at smoke widths, on the same parameters (carried over from the
reference's ``init_params`` by ``params_from_jax``) and the same
numpy-seeded prompts."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro_torch.configs import ARCHS, get_config, smoke_shrink  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cache import cache_leaves  # noqa: E402
from repro_torch.training import steps as TST  # noqa: E402

TOL = 1e-4
CACHE_LEN = 48
# the reference, jitted (cfg and cache_len are static)
jax_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
jax_decode_step = jax.jit(JM.decode_step, static_argnums=(1,))
SMOKE = ["qwen2.5-3b", "cody-mnist"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=SMOKE)
def setup(request):
    arch = request.param
    jcfg = jax_smoke_shrink(jax_get_config(arch), dtype="float32")
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("name", sorted(ARCHS) + ["cody-mnist"])
def test_config_fingerprints_match_reference(name):
    assert get_config(name) == get_config(name)
    assert get_config(name).fingerprint() == jax_get_config(name).fingerprint()
    assert smoke_shrink(get_config(name)).fingerprint() == \
        jax_smoke_shrink(jax_get_config(name)).fingerprint()


def test_params_carry_over(setup):
    jcfg, cfg, jp, tp = setup
    n_ref = sum(x.size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    blk = tp["stages"][0][1]
    _close(blk["attn"]["wq"], np.asarray(jp["stages"][0]["attn"]["wq"])[1], 0)
    assert not any(p.requires_grad for p in tp.parameters())


def test_prefill_logits_and_caches(setup):
    jcfg, cfg, jp, tp = setup
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, (2, 13),
                                             dtype=np.int32)
    jl, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                        CACHE_LEN)
    _close(tl, jl)
    assert [c.shape for c in cache_leaves(tc)] == \
        [tuple(c.shape) for c in jax.tree.leaves(jc)]
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_decode_steps_logits_and_greedy_tokens(setup):
    jcfg, cfg, jp, tp = setup
    toks = np.random.default_rng(1).integers(3, cfg.vocab_size, (2, 9),
                                             dtype=np.int32)
    _, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    _, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                       CACHE_LEN)
    tok = toks[:, -1]
    pos = np.full(2, 9, np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for step in range(8):
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
    rng = np.random.default_rng(2)
    toks = rng.integers(3, cfg.vocab_size, (3, 7), dtype=np.int32)
    jout, jc = JST.make_prefill_step(jcfg, None, CACHE_LEN)(
        jp, {"tokens": jnp.asarray(toks)})
    tout, tc = TST.make_prefill_step(cfg, CACHE_LEN)(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tout["next_tokens"].numpy(),
                                  np.asarray(jout["next_tokens"]))
    _close(tout["last_logits"], jout["last_logits"])
    # eos at a token the first row emits, to exercise the device-side freeze
    eos = int(np.asarray(jout["next_tokens"])[0])
    first, pos = np.array(jout["next_tokens"]), np.full(3, 7, np.int32)
    jf = JST.make_fused_decode_step(jcfg, None, k=6, eos_id=eos)
    tf = TST.make_fused_decode_step(cfg, k=6, eos_id=eos)
    jo, _ = jf(jp, jnp.asarray(first), jnp.asarray(pos), jc)
    to, _ = tf(tp, torch.from_numpy(first), torch.from_numpy(pos), tc)
    for name in ("tokens", "pos", "done"):
        np.testing.assert_array_equal(to[name].numpy(), np.asarray(jo[name]))


def test_batched_prefill_matches_per_request(setup):
    jcfg, cfg, jp, tp = setup
    rng = np.random.default_rng(3)
    lens = np.array([5, 11, 8], np.int32)
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, cfg.vocab_size, n)
    tb, tcb = TST.make_batched_prefill_step(cfg, CACHE_LEN)(
        tp, torch.from_numpy(toks), torch.from_numpy(lens))
    jb, _ = JST.make_batched_prefill_step(jcfg, None, CACHE_LEN)(
        jp, jnp.asarray(toks), jnp.asarray(lens))
    np.testing.assert_array_equal(tb["next_tokens"].numpy(),
                                  np.asarray(jb["next_tokens"]))
    single = TST.make_prefill_step(cfg, CACHE_LEN)
    for i, n in enumerate(lens):
        one, c1 = single(tp, {"tokens": torch.from_numpy(toks[i:i + 1, :n])})
        assert int(one["next_tokens"][0]) == int(tb["next_tokens"][i])
        _close(one["last_logits"][0], tb["last_logits"][i])
        for a, b in zip(cache_leaves(c1), cache_leaves(tcb)):
            _close(a[:, :1, :n], b[:, i:i + 1, :n])   # rows past n are inert


@pytest.mark.parametrize("arch,over,plen", [
    ("starcoder2-7b", {}, 40),                    # SWA ring (window 32)
    ("command-r-35b", {}, 13),                    # parallel block, layernorm
    ("qwen2.5-3b", {"kv_quant": True}, 13),       # int8 KV cache
    ("qwen2.5-3b", {"act": "gelu", "mlp_bias": True}, 13),
])
def test_dense_variants_prefill_and_decode(arch, over, plen):
    """The other forms of the dense stage, on the CPU path."""
    jcfg = jax_smoke_shrink(jax_get_config(arch), dtype="float32", **over)
    cfg = smoke_shrink(get_config(arch), dtype="float32", **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(3, cfg.vocab_size, (2, plen),
                                             dtype=np.int32)
    jl, jc = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                        CACHE_LEN)
    _close(tl, jl)
    tok = np.array(np.argmax(np.asarray(jl)[:, -1], -1), np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for step in range(6):
        pos = np.full(2, plen + step, np.int32)
        jl, jc = jax_decode_step(jp, jcfg, jtok, jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tp, cfg, ttok, torch.from_numpy(pos), tc)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a.float(), np.asarray(b, np.float32))


def test_other_families_raise():
    for name in ("mixtral-8x22b", "xlstm-350m", "zamba2-1.2b",
                 "whisper-large-v3", "phi-3-vision-4.2b"):
        with pytest.raises(NotImplementedError, match="Queue 1"):
            TM.model_schema(smoke_shrink(get_config(name)))


def test_init_params_is_seeded_and_scaled():
    cfg = dataclasses.replace(smoke_shrink(get_config("qwen2.5-3b")),
                              dtype="float32")
    a = TM.init_params(cfg, seed=3, device="cpu")
    b = TM.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    D = cfg.d_model
    assert abs(a["embed"].std().item() - D ** -0.5) < 0.1 * D ** -0.5
    assert torch.equal(a["final_norm"]["scale"], torch.ones(D))
    assert a["stages"][0][0]["attn"]["bq"].abs().sum() == 0


def test_cuda_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = smoke_shrink(get_config("cody-mnist"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(cfg, 2, 16)
