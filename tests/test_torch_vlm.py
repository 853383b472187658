"""The vlm family (phi-3-vision-4.2b: the dense stage behind a prefix of
projected image embeddings) in the port against the JAX reference, in
fp32 at smoke width, on the same parameters (carried over by
``params_from_jax``) and the batches of ``tests/test_models.py:_batch``:
forward, prefill and decode logits with decode positions offset by the
image prefix, prefill + decode against forward, greedy tokens over fused
decode blocks; at the smoke head dim 16 and at phi-3's 96."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cache import cache_leaves  # noqa: E402
from repro_torch.training import steps as TST  # noqa: E402
from test_models import _batch  # noqa: E402

ARCH = "phi-3-vision-4.2b"
TOL = 1e-4
CACHE_LEN = 48
jax_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
jax_decode_step = jax.jit(JM.decode_step, static_argnums=(1,))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _port_batch(batch):
    """The reference's batch as the port's tensors (bf16 image embeds
    widened exactly to fp32, which both models cast them to)."""
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int32 if k == "tokens" else np.float32)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=[16, 96], ids=["hd16", "hd96"])
def setup(request):
    over = {"head_dim": request.param}
    jcfg = jax_smoke_shrink(jax_get_config(ARCH), dtype="float32", **over)
    cfg = smoke_shrink(get_config(ARCH), dtype="float32", **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp, _batch(jcfg, with_labels=False)


def test_schema_and_params_carry_over(setup):
    jcfg, cfg, jp, tp, _ = setup
    assert [s.kind for s in TM.build_stages(cfg)] == ["dense"]
    assert sum(p.numel() for p in tp.parameters()) == \
        sum(x.size for x in jax.tree.leaves(jp))
    _close(tp["img_proj"], jp["img_proj"], 0)
    assert tp["stages"][0][0]["attn"]["wq"].shape[-1] == cfg.hd()


def test_forward_logits_drop_the_image_rows(setup):
    jcfg, cfg, jp, tp, batch = setup
    jl, _ = JM.forward(jp, jcfg, batch)
    tl, _ = TM.forward(tp, cfg, _port_batch(batch))
    assert tl.shape == (2, 32, cfg.vocab_size)
    _close(tl, jl)


def test_text_only_batch(setup):
    """Without image embeds the vlm family is the dense model."""
    jcfg, cfg, jp, tp, batch = setup
    text = {"tokens": batch["tokens"][:, :11]}
    jl, jc = jax_prefill(jp, jcfg, text, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, _port_batch(text), CACHE_LEN)
    _close(tl, jl)
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_prefill_caches_hold_the_image_prefix(setup):
    jcfg, cfg, jp, tp, batch = setup
    jl, jc = jax_prefill(jp, jcfg, batch, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, _port_batch(batch), CACHE_LEN)
    _close(tl, jl)
    n_img = cfg.vlm.num_image_tokens
    # 8 image rows + 32 text rows, padded to the cache's 48
    assert tc[0]["k"].shape == (2, 2, CACHE_LEN, 2, cfg.hd())
    assert tc[0]["k"][:, :, n_img + 32:].abs().sum() == 0
    assert [tuple(c.shape) for c in cache_leaves(tc)] == \
        [tuple(c.shape) for c in jax.tree.leaves(jc)]
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_decode_steps_at_offset_positions(setup):
    """Decode positions count the image prefix (pos = n_img + text
    position, as in ``tests/test_models.py``): logits and greedy tokens
    of six steps equal the reference's."""
    jcfg, cfg, jp, tp, batch = setup
    batch = dict(batch, tokens=batch["tokens"][:, :9])
    n_img = cfg.vlm.num_image_tokens
    jl, jc = jax_prefill(jp, jcfg, batch, CACHE_LEN)
    tl, tc = TM.prefill(tp, cfg, _port_batch(batch), CACHE_LEN)
    tok = np.array(np.argmax(np.asarray(jl)[:, -1], -1), np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for step in range(6):
        pos = np.full(2, n_img + 9 + step, np.int32)
        jl, jc = jax_decode_step(jp, jcfg, jtok, jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tp, cfg, ttok, torch.from_numpy(pos), tc)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for a, b in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


def test_prefill_decode_matches_forward(setup):
    """As ``tests/test_models.py:test_prefill_decode_matches_forward``,
    at fp32 ``allclose``: token S decoded at position S + n_img after
    prefilling S tokens behind the image gives the full forward's
    logits at S."""
    jcfg, cfg, jp, tp, batch = setup
    S = 32
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, S + 1), 0,
                              cfg.vocab_size)
    full = dict(batch, tokens=toks)
    ref = np.asarray(JM.forward(jp, jcfg, full)[0])[:, S]
    tfull, _ = TM.forward(tp, cfg, _port_batch(full))
    _close(tfull[:, S], ref)
    _, caches = TM.prefill(tp, cfg, _port_batch(dict(batch,
                                                     tokens=toks[:, :S])),
                           cache_len=64)
    pos = torch.full((2,), S + cfg.vlm.num_image_tokens, dtype=torch.int32)
    got, _ = TM.decode_step(tp, cfg, torch.from_numpy(np.array(
        toks[:, S], np.int32)), pos, caches)
    _close(got, ref)


def test_fused_decode_blocks_greedy_tokens(setup):
    """The prefill step and two fused decode blocks of 4 from position
    n_img + 7: tokens, positions, done flags and caches equal the
    reference's."""
    jcfg, cfg, jp, tp, batch = setup
    batch = dict(batch, tokens=batch["tokens"][:, :7])
    jout, jc = JST.make_prefill_step(jcfg, None, CACHE_LEN)(jp, batch)
    tout, tc = TST.make_prefill_step(cfg, CACHE_LEN)(tp, _port_batch(batch))
    np.testing.assert_array_equal(tout["next_tokens"].numpy(),
                                  np.asarray(jout["next_tokens"]))
    _close(tout["last_logits"], jout["last_logits"])
    start = cfg.vlm.num_image_tokens + 7
    jf = jax.jit(JST.make_fused_decode_step(jcfg, None, k=4))
    tf = TST.make_fused_decode_step(cfg, k=4)
    jtok, jpos = jout["next_tokens"], jnp.full((2,), start, jnp.int32)
    ttok, tpos = tout["next_tokens"], torch.full((2,), start,
                                                 dtype=torch.int32)
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
