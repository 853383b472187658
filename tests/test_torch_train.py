"""The port's training against the JAX reference on the CPU, in fp32 at
smoke widths, on the same params (``params_from_jax``) and numpy-seeded
batches: one ``make_train_step`` step (loss, ce, aux, grad norm, lr and
every updated master, m and v leaf at ``allclose`` 1e-5, but for the
master elements whose gradient is below fp32's resolution:
``_assert_states_equal``), the four remat modes (grads at 1e-5),
``cross_entropy``, ``lr_at``, ``adamw_update``, the int8 error-feedback
transform, and the ``train`` launcher's final loss."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.grad_compress import make_ef_int8_transform as jax_ef  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core import metasync  # noqa: E402
from repro_torch.data.pipeline import Prefetcher  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.checkpoint import to_reference_layout  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import steps as TST  # noqa: E402
from repro_torch.training.grad_compress import make_ef_int8_transform  # noqa: E402

TOL = 1e-5
OPT = dict(warmup_steps=1, decay_steps=10)
tree_leaves = torch.utils._pytree.tree_leaves


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _batch(cfg, seed=0, B=2, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    b["labels"][0, :3] = -100                 # masked labels
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.vlm.num_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def _setup(arch, **over):
    jcfg = jax_smoke_shrink(jax_get_config(arch), dtype="float32", **over)
    cfg = smoke_shrink(get_config(arch), dtype="float32", **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = L.to_tree(params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu"))
    return jcfg, cfg, jp, tp


def _by_path(jtree):
    return {jax.tree_util.keystr(kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _assert_states_equal(jstate, state, lr):
    """Every leaf of the port's state (in the reference's layout) against
    the reference's, by path, at ``TOL``; a master element whose gradient
    is below 1e-6 is held only to Adam's step bound.  Adam's first step
    moves an element by lr * g / (|g| + eps): where the true gradient is
    0 or near it (whisper's key bias, which softmax cancels, qwen's key
    bias on the dims rope barely turns) both packages get fp32 rounding
    of 1e-10 to 1e-8, of the size of eps, and each moves the element by a
    different fraction of lr.  Measured on these batches: 45 such
    elements in all three configs, |g| <= 1.4e-8, |difference| <= 3.7e-5
    (lr 3e-4); every other element agrees within 1e-5."""
    mine = metasync._paths(to_reference_layout(state))
    theirs = _by_path(jstate)
    assert list(mine) == list(theirs)
    for path, x in theirs.items():
        x, y = np.asarray(x), mine[path].numpy()
        if not path.startswith("['master']"):
            _close(y, x)
            continue
        g = np.abs(np.asarray(theirs["['m']" + path[10:]])) / (1 - 0.9)
        ok = g >= 1e-6
        _close(y[ok], x[ok])
        assert np.all(np.abs(y - x)[~ok] <= 2 * lr + TOL), path


@pytest.fixture(scope="module")
def qwen():
    return _setup("qwen2.5-3b")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi-3-vision-4.2b",
                                  "whisper-large-v3", "zamba2-1.2b",
                                  "xlstm-350m", "deepseek-v2-lite-16b",
                                  "mixtral-8x22b"])
def test_train_step_matches_reference(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    batch = _batch(cfg)
    jstep = jax.jit(JST.make_train_step(jcfg, None, JO.AdamWConfig(**OPT),
                                        remat="none"))
    jstate, jm = jstep(JO.init_opt_state(jp),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    step = TST.make_train_step(cfg, TO.AdamWConfig(**OPT), remat="none")
    state, m = step(TO.init_opt_state(tp),
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        _close(m[key], jm[key])
    assert int(state["step"]) == int(jstate["step"]) == 1
    _assert_states_equal(jstate, state, float(jm["lr"]))


def test_remat_modes_agree_with_each_other_and_the_reference(qwen):
    jcfg, cfg, jp, tp = qwen
    batch = _batch(cfg, seed=1)
    jloss = JST.make_loss_fn(jcfg, None, remat="full")
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    flat, spec = torch.utils._pytree.tree_flatten(tp)
    got = {}
    for remat in ("none", "full", "dots", "minimal"):
        leaves = [p.detach().requires_grad_() for p in flat]
        loss, _ = TST.make_loss_fn(cfg, remat)(
            torch.utils._pytree.tree_unflatten(leaves, spec), tb)
        got[remat] = (loss, torch.autograd.grad(loss, leaves))
    loss0, grads0 = got["none"]
    for remat, (loss, grads) in got.items():
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), remat
    _close(loss0, jl)
    mine = metasync._paths(to_reference_layout(
        torch.utils._pytree.tree_unflatten(list(grads0), spec)))
    for path, g in _by_path(jg).items():
        _close(mine[path], g)


def test_remat_rejects_unknown_mode(qwen):
    _, cfg, _, tp = qwen
    with pytest.raises(ValueError, match="remat"):
        TST.make_loss_fn(cfg, "sometimes")(tp, {
            k: torch.from_numpy(v) for k, v in _batch(cfg).items()})


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:] = -100
    for z in (1e-4, 0.0):
        _close(TST.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), z),
               JST.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z))
    all_masked = np.full((2, 3), -100, np.int32)
    _close(TST.cross_entropy(torch.from_numpy(logits[:2, :3]),
                             torch.from_numpy(all_masked)),
           JST.cross_entropy(jnp.asarray(logits[:2, :3]),
                             jnp.asarray(all_masked)))


def test_lr_schedule_matches_reference():
    for kw in (dict(warmup_steps=10, decay_steps=100),
               dict(warmup_steps=1, decay_steps=1, lr=1e-3),
               dict(warmup_steps=30, decay_steps=20, min_lr_ratio=0.0)):
        steps = np.arange(121, dtype=np.int32)
        _close(TO.lr_at(TO.AdamWConfig(**kw), torch.from_numpy(steps)),
               JO.lr_at(JO.AdamWConfig(**kw), jnp.asarray(steps)))


def test_adamw_update_matches_reference():
    """Three updates of a random tree, the clip active on the first (its
    norm is far above 1), in place in the port."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 2)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=5)
    jstate = JO.init_opt_state(jax.tree.map(jnp.asarray, params))
    state = TO.init_opt_state(jax.tree.map(torch.from_numpy, params))
    for i in range(3):
        g = jax.tree.map(lambda p: (10.0 ** (1 - i) * rng.standard_normal(
            p.shape)).astype(np.float32), params)
        jstate, jm = JO.adamw_update(JO.AdamWConfig(**cfg), jstate,
                                     jax.tree.map(jnp.asarray, g))
        master = state["master"]
        state, m = TO.adamw_update(TO.AdamWConfig(**cfg), state,
                                   jax.tree.map(torch.from_numpy, g))
        assert state["master"] is master     # updated in place
        _close(m["grad_norm"], jm["grad_norm"])
        _close(m["lr"], jm["lr"])
        for k in ("master", "m", "v"):
            for a, b in zip(jax.tree.leaves(jstate[k]),
                            jax.tree.leaves(jax.tree.map(
                                lambda t: t.numpy(), state[k]))):
                _close(b, a)


def test_ef_int8_transform_matches_reference():
    rng = np.random.default_rng(5)
    grads = {"w": rng.standard_normal((64, 3)).astype(np.float32),
             "b": {"c": (1e-3 * rng.standard_normal(9)).astype(np.float32)}}
    jt, tt = jax_ef(), make_ef_int8_transform()
    jstate, state = {}, {}
    for _ in range(3):
        jg, jstate = jt(jax.tree.map(jnp.asarray, grads), jstate)
        tg, state = tt(jax.tree.map(torch.from_numpy, grads), state)
        for k in ("w",):
            _close(tg[k], jg[k])
        _close(tg["b"]["c"], jg["b"]["c"])
        _close(state["ef"]["w"], jstate["ef"]["w"])
        _close(state["ef"]["b"]["c"], jstate["ef"]["b"]["c"])
    # error feedback: the averaged update converges to the true gradient
    g = {"w": torch.full((128,), 0.001)}
    total, st = torch.zeros(128), {}
    for _ in range(64):
        dg, st = tt(g, st)
        total += dg["w"]
    torch.testing.assert_close(total / 64, g["w"], rtol=0.05, atol=0)


def test_train_step_with_grad_compress_carries_the_residual(qwen):
    """With the int8 transform the step updates from the decompressed
    grads and carries the residual in state["ef"], as the reference's
    step does.  The transform is held to the reference's on the same
    grads above; a whole step is not compared with the reference's at
    1e-5, since grads that differ by fp32 rounding put an element on the
    other side of an int8 rounding boundary now and then, which moves it
    by a whole quantization step."""
    _, cfg, _, tp = qwen
    opt = TO.AdamWConfig(**OPT)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=4).items()}
    flat, spec = torch.utils._pytree.tree_flatten(tp)
    leaves = [p.detach().requires_grad_() for p in flat]
    loss, _ = TST.make_loss_fn(cfg, "none")(
        torch.utils._pytree.tree_unflatten(leaves, spec), tb)
    grads = torch.utils._pytree.tree_unflatten(
        list(torch.autograd.grad(loss, leaves)), spec)
    dg, ef_state = make_ef_int8_transform()(grads, {})
    want, wm = TO.adamw_update(opt, TO.init_opt_state(tp), dg)
    step = TST.make_train_step(cfg, opt, remat="none",
                               grad_transform=make_ef_int8_transform())
    state, m = step(TO.init_opt_state(tp), tb)
    assert torch.equal(m["grad_norm"], wm["grad_norm"])
    for k in ("master", "m", "v", "ef"):
        src = ef_state if k == "ef" else want
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(state[k]), tree_leaves(src[k]))), k


def test_abstract_state_and_axes(qwen):
    _, cfg, _, tp = qwen
    abstract = TST.abstract_train_state(cfg)
    state = TO.init_opt_state(tp)
    for a, b in zip(tree_leaves(abstract), tree_leaves(state)):
        assert a.device.type == "meta" and a.shape == b.shape \
            and a.dtype == b.dtype
    axes = TST.train_state_axes(cfg)
    assert axes["step"] == ()
    assert axes["master"]["stages"][0][1]["attn"]["wq"] == \
        ("fsdp", "heads", "head_dim")


def test_decode_step_is_one_fused_step(qwen):
    from repro_torch.models import model as TM
    _, cfg, _, tp = qwen
    toks = torch.tensor([5, 9], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    c1 = TM.init_cache(cfg, 2, 16, device="cpu")
    c2 = TM.init_cache(cfg, 2, 16, device="cpu")
    nxt, logits, _ = TST.make_decode_step(cfg)(tp, toks, pos, c1)
    fused, _ = TST.make_fused_decode_step(cfg, 1)(tp, toks, pos, c2)
    assert torch.equal(nxt, fused["tokens"][:, 0])
    assert torch.equal(nxt, logits.argmax(-1).to(torch.int32))


def test_launcher_final_loss_matches_reference(monkeypatch, capsys):
    """``main`` of both launchers at smoke (bf16, the launchers' dtype)
    for 4 steps, from the reference's params and its batches in order
    (the reference's prefetcher drops batches while its first step
    compiles, ROADMAP Queue 3, so it is given the port's).  The two
    bf16 paths round differently: measured, the final losses differed by
    8.7e-5 of 6.07 after 4 steps (1.2e-4 after 8) and single steps' by up
    to 6e-4; the check allows 2e-3."""
    from repro.launch import train as JT
    from repro_torch.launch import train as TT
    from repro_torch.models import model as TM
    jcfg = jax_smoke_shrink(jax_get_config("qwen2.5-3b"))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    monkeypatch.setattr(JT, "Prefetcher", Prefetcher)
    monkeypatch.setattr(TM, "init_params", lambda cfg, seed, device: (
        params_from_jax(cfg, jax.tree.map(np.asarray, jp), device=device)))
    flags = ["--steps", "4", "--log-every", "2"]
    want = JT.main(flags)
    got = TT.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     4 loss" in out and "done: final loss" in out
    assert abs(got - want) < 2e-3, (got, want)


def test_launcher_resume_continues_with_the_next_batch(tmp_path, capsys):
    """6 steps with a checkpoint at 3; a second run resumed from step 3
    ends where the first did (the checkpoint holds the cursor of the
    last batch trained on, not the prefetch thread's)."""
    from repro_torch.launch import train as TT
    flags = ["--steps", "6", "--log-every", "3", "--device", "cpu",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    first = TT.main(flags)
    (tmp_path / "manifest_00000006.json").unlink()
    again = TT.main(flags + ["--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert again == first
