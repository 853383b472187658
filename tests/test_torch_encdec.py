"""The audio family (whisper-large-v3: an encoder over precomputed frames,
a decoder with cross-attention) in the port against the JAX reference,
in fp32 at smoke width, on the same parameters (carried over by
``params_from_jax``) and the batches of ``tests/test_models.py:_batch``:
forward, prefill and decode logits, prefill + decode against forward,
greedy tokens over fused decode blocks, the reference's cross-attention
biases, the parameter count, and the recorded prefill step's meta."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.core.recorder import compile_artifact as jax_compile  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core.recorder import compile_artifact  # noqa: E402
from repro_torch.core.replay import ReplayArgumentError, Replayer  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cache import cache_leaves  # noqa: E402
from repro_torch.training import steps as TST  # noqa: E402
from test_models import _batch  # noqa: E402

ARCH = "whisper-large-v3"
TOL = 1e-4
CACHE_LEN = 48
KEY = b"encdec-test-key"
jax_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
jax_decode_step = jax.jit(JM.decode_step, static_argnums=(1,))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _port_batch(batch):
    """The reference's batch as the port's tensors (bf16 frames widened
    exactly to fp32, which both models cast them to)."""
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int32 if k == "tokens" else np.float32)) for k, v in batch.items()}


def _models(seed=0, **over):
    jcfg = jax_smoke_shrink(jax_get_config(ARCH), dtype="float32", **over)
    cfg = smoke_shrink(get_config(ARCH), dtype="float32", **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg, jp = _models()
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = _batch(jcfg, with_labels=False)
    return jcfg, cfg, jp, tp, batch


def test_schema_and_params_carry_over(setup):
    jcfg, cfg, jp, tp, _ = setup
    assert [s.kind for s in TM.build_stages(cfg)] == ["enc", "dec"]
    assert sum(p.numel() for p in tp.parameters()) == \
        sum(x.size for x in jax.tree.leaves(jp))
    dec = tp["stages"][1][1]
    _close(dec["xattn"]["wk"], np.asarray(jp["stages"][1]["xattn"]["wk"])[1],
           0)
    _close(dec["lnx"]["bias"], np.asarray(jp["stages"][1]["lnx"]["bias"])[1],
           0)
    _close(tp["enc_pos"], jp["enc_pos"], 0)
    _close(tp["dec_pos"], jp["dec_pos"], 0)


def test_forward_logits(setup):
    jcfg, cfg, jp, tp, batch = setup
    jl, _ = JM.forward(jp, jcfg, batch)
    tl, _ = TM.forward(tp, cfg, _port_batch(batch))
    assert tl.shape == (2, 32, cfg.vocab_size)
    _close(tl, jl)


def test_prefill_logits_and_caches(setup):
    jcfg, cfg, jp, tp, batch = setup
    jl, jc = jax_prefill(jp, jcfg, batch, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, _port_batch(batch), CACHE_LEN)
    _close(tl, jl)
    assert [tuple(c.shape) for c in cache_leaves(tc)] == \
        [tuple(c.shape) for c in jax.tree.leaves(jc)]
    assert sorted(tc[1]) == ["k", "v", "xk", "xv"]
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_decode_steps_logits_and_greedy_tokens(setup):
    """Six decode steps from the prefill: the encoder's cache passes
    through untouched, each step reads dec_pos[pos] and the cross cache."""
    jcfg, cfg, jp, tp, batch = setup
    batch = dict(batch, tokens=batch["tokens"][:, :9])
    jl, jc = jax_prefill(jp, jcfg, batch, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, _port_batch(batch), CACHE_LEN)
    enc = [c.clone() for c in cache_leaves(tc[0])]
    tok = np.array(np.argmax(np.asarray(jl)[:, -1], -1), np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for step in range(6):
        pos = np.full(2, 9 + step, np.int32)
        jl, jc = jax_decode_step(jp, jcfg, jtok, jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tp, cfg, ttok, torch.from_numpy(pos), tc)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)
    assert all(torch.equal(a, b) for a, b in zip(enc, cache_leaves(tc[0])))


def test_prefill_decode_matches_forward(setup):
    """As ``tests/test_models.py:test_prefill_decode_matches_forward``:
    the logits of token S after prefilling S tokens are the full
    forward's at S, here at fp32 ``allclose`` in both packages."""
    jcfg, cfg, jp, tp, batch = setup
    S = 32
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, S + 1), 0,
                              cfg.vocab_size)
    full = dict(batch, tokens=toks)
    pre = dict(batch, tokens=toks[:, :S])
    ref = np.asarray(JM.forward(jp, jcfg, full)[0])[:, S]
    tfull, _ = TM.forward(tp, cfg, _port_batch(full))
    _close(tfull[:, S], ref)
    _, caches = TM.prefill(tp, cfg, _port_batch(pre), cache_len=64)
    pos = torch.full((2,), S, dtype=torch.int32)
    got, _ = TM.decode_step(tp, cfg, torch.from_numpy(np.array(
        toks[:, S], np.int32)), pos, caches)
    _close(got, ref)


def test_fused_decode_blocks_greedy_tokens(setup):
    """The prefill step and two fused decode blocks of 4: tokens,
    positions and done flags equal the reference's, and the caches."""
    jcfg, cfg, jp, tp, batch = setup
    batch = dict(batch, tokens=batch["tokens"][:, :7])
    jout, jc = JST.make_prefill_step(jcfg, None, CACHE_LEN)(jp, batch)
    tout, tc = TST.make_prefill_step(cfg, CACHE_LEN)(tp, _port_batch(batch))
    np.testing.assert_array_equal(tout["next_tokens"].numpy(),
                                  np.asarray(jout["next_tokens"]))
    _close(tout["last_logits"], jout["last_logits"])
    jf = jax.jit(JST.make_fused_decode_step(jcfg, None, k=4))
    tf = TST.make_fused_decode_step(cfg, k=4)
    jtok, jpos = jout["next_tokens"], jnp.full((2,), 7, jnp.int32)
    ttok, tpos = tout["next_tokens"], torch.full((2,), 7, dtype=torch.int32)
    for _ in range(2):
        jo, jc = jf(jp, jtok, jpos, jc)
        to, tc = tf(tp, ttok, tpos, tc)
        for name in ("tokens", "pos", "done"):
            np.testing.assert_array_equal(to[name].numpy(),
                                          np.asarray(jo[name]))
        jtok, jpos = jo["tokens"][:, -1], jo["pos"]
        ttok, tpos = to["tokens"][:, -1], to["pos"]
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_cross_attention_biases_as_the_reference_applies_them():
    """Nonzero xattn biases in both packages: the reference adds bq to
    the cross query at prefill but not at decode, and never applies
    bk/bv to the cross K/V; the port mirrors that (ROADMAP Queue 3), so
    prefill and decode logits agree, and bq moves the prefill's."""
    jcfg, cfg, jp = _models(seed=3)
    rng = np.random.default_rng(5)
    jp = jax.tree.map(lambda x: x, jp)
    xattn = dict(jp["stages"][1]["xattn"])
    for name in ("bq", "bk", "bv"):
        xattn[name] = jnp.asarray(rng.standard_normal(
            xattn[name].shape).astype(np.float32))
    stages = list(jp["stages"])
    stages[1] = dict(stages[1], xattn=xattn)
    jp = dict(jp, stages=stages)
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["stages"][1][0]["xattn"]["bq"].abs().sum() > 0
    batch = dict(_batch(jcfg, with_labels=False))
    batch["tokens"] = batch["tokens"][:, :9]
    jl, jc = jax_prefill(jp, jcfg, batch, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, _port_batch(batch), CACHE_LEN)
    _close(tl, jl)
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)
    tok = np.array(np.argmax(np.asarray(jl)[:, -1], -1), np.int32)
    pos = np.full(2, 9, np.int32)
    jd, _ = jax_decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc)
    td, _ = TM.decode_step(tp, cfg, torch.from_numpy(tok),
                           torch.from_numpy(pos), tc)
    _close(td, jd)
    # bq reaches the prefill's cross query: zeroing it moves the logits
    for blk in tp["stages"][1]:
        blk["xattn"]["bq"].zero_()
    tl0, _ = TM.prefill(tp, cfg, _port_batch(batch), CACHE_LEN)
    assert (tl0 - tl).abs().max() > 1e-3


def test_frames_longer_than_the_cache():
    """Encoder frames outnumbering the cache: the reference's prefill
    raises (its jnp.pad of the encoder's K/V gets a negative width) and
    so does the port's; at a cache that holds the frames both decode the
    same logits."""
    jcfg, cfg, jp = _models(seed=1)
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = dict(_batch(jcfg, with_labels=False))
    batch["tokens"] = batch["tokens"][:, :8]
    assert cfg.encdec.encoder_seq == 24
    with pytest.raises(ValueError, match="negative"):
        JM.prefill(jp, jcfg, batch, cache_len=16)
    with pytest.raises(ValueError, match="shorter than the 24 positions"):
        TM.prefill(tp, cfg, _port_batch(batch), cache_len=16)
    _, tc = TM.prefill(tp, cfg, _port_batch(batch), cache_len=24)
    assert tc[0]["k"].shape[2] == 24 and tc[1]["xk"].shape[2] == 24
    jl, jc = jax_prefill(jp, jcfg, batch, 24)
    tok = np.array(np.argmax(np.asarray(jl)[:, -1], -1), np.int32)
    for step in range(4):
        pos = np.full(2, 8 + step, np.int32)
        jl, jc = jax_decode_step(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc)
        _close(tl, jl)
        tok = np.array(np.argmax(np.asarray(jl), -1), np.int32)


def test_init_cache_and_cache_axes_as_the_reference():
    jcfg, cfg, _ = _models()
    jc = JM.init_cache(jcfg, 3, 40, enc_S=24)
    tc = TM.init_cache(cfg, 3, 40, enc_S=24, device="meta")
    assert [tuple(c.shape) for c in cache_leaves(tc)] == \
        [tuple(c.shape) for c in jax.tree.leaves(jc)]
    assert cache_leaves(TM.cache_axes(cfg)) == \
        jax.tree.leaves(JM.cache_axes(jcfg),
                        is_leaf=lambda x: isinstance(x, tuple))
    # one decoder layer: the reference stacks xk / xv on it all the same
    one = dataclasses.replace(cfg, num_layers=1)
    c1 = TM.init_cache(one, 2, 16, enc_S=24, device="meta")[1]
    assert c1["k"].shape == (2, 16, 2, 16) and \
        c1["xk"].shape == (1, 2, 24, 2, 16)


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
def test_param_count_is_the_references(arch):
    """``param_count()`` equals the reference's; the schema's count
    exceeds it by what the analytic count leaves out: every norm's scale
    (and layernorm's bias), the attention and MLP biases, and the audio
    family's learned positions or the vlm family's image projection."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    D, H, Hkv, hd, F_ = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.hd(), cfg.d_ff)
    numel = lambda sp: int(np.prod(sp.shape))
    total = sum(map(numel, jax.tree.leaves(
        TM.model_schema(cfg), is_leaf=lambda x: isinstance(x, L.ParamSpec))))
    norm = D * (2 if cfg.norm == "layernorm" else 1)
    attn_b = (H + 2 * Hkv) * hd if cfg.qkv_bias else 0
    mlp_b = F_ + D if cfg.mlp_bias else 0
    if cfg.family == "audio":
        n_enc, n_dec = cfg.encdec.num_encoder_layers, cfg.num_layers
        extra = (n_enc * (2 * norm + attn_b + mlp_b)
                 + n_dec * (3 * norm + 2 * attn_b + mlp_b)
                 + norm - D + (cfg.encdec.encoder_seq + cfg.max_seq) * D)
    else:
        extra = cfg.num_layers * (2 * norm + attn_b + mlp_b) + norm - D \
            + D * D
    assert total - cfg.param_count() == extra


def test_recorded_prefill_meta_and_batch_order_as_the_reference(setup):
    """whisper's prefill step recorded by both packages on the same
    inputs: the name, the batch's leaves in JAX's sorted-key order
    (frames before tokens, though the port's caller built tokens first)
    and the params' elements and dtypes; the replay gives live's
    outputs, and frames of another shape raise ReplayArgumentError."""
    jcfg, cfg, jp, tp, batch = setup
    name = f"{ARCH}:prefill"
    jbatch = {"frames": jnp.asarray(np.asarray(batch["frames"], np.float32)),
              "tokens": batch["tokens"][:, :8]}
    jrec = jax_compile(name, JST.make_prefill_step(jcfg, None, CACHE_LEN),
                       (jp, jbatch))
    pb = _port_batch(jbatch)
    tbatch = {"tokens": pb["tokens"], "frames": pb["frames"]}
    tree = L.to_tree(tp)
    step = TST.make_prefill_step(cfg, CACHE_LEN)
    rec = compile_artifact(name, step, (tree, tbatch))
    jm, tm = jrec.manifest, rec.manifest
    assert tm["name"] == jm["name"] == name
    n_params = len(jax.tree.leaves(jp))
    assert tm["inputs"][-2:] == jm["inputs"][n_params:] == [
        {"shape": [2, 24, 64], "dtype": "float32"},
        {"shape": [2, 8], "dtype": "int32"}]
    size = lambda ins: sum(int(np.prod(i["shape"])) for i in ins)
    assert size(tm["inputs"][:-2]) == size(jm["inputs"][:n_params])
    assert {i["dtype"] for i in tm["inputs"][:-2]} == \
        {i["dtype"] for i in jm["inputs"][:n_params]}
    assert tm["donate"] == jm["donate"] == []
    rp = Replayer(key=KEY, device="cpu")
    rp.load(rec.sign_with(KEY).to_bytes())
    # validated before the first call pins the program to the fast path
    with pytest.raises(ReplayArgumentError, match="float32\\[2, 23, 64\\]"):
        rp.execute(name, tree, dict(tbatch, frames=tbatch["frames"][:, 1:]))
    want, wc = step(tree, tbatch)
    got, gc = rp.execute(name, tree, tbatch)
    assert torch.equal(got["last_logits"], want["last_logits"])
    assert all(torch.equal(a, b) for a, b in
               zip(cache_leaves(gc), cache_leaves(wc)))
