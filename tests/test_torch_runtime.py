"""The port's data pipeline, straggler monitor and checkpoints against the
JAX reference: the same batches for the same seed and cursor, the same
straggler flags for the same latencies, and, for the same fp32 train
state, the reference's manifest and chunk hashes byte for byte; a
checkpoint that either package writes restores in the other, and 3 steps
+ checkpoint + 3 steps equal 6 steps."""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.runtime.straggler import DispatchMonitor as JMonitor  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro.training.optimizer import init_opt_state as jax_init  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core import metasync  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import checkpoint as CK  # noqa: E402
from repro_torch.runtime.straggler import DispatchMonitor  # noqa: E402
from repro_torch.training import steps as TST  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            init_opt_state)

leaves = torch.utils._pytree.tree_leaves


def _configs(arch, **over):
    return (jax_smoke_shrink(jax_get_config(arch), dtype="float32", **over),
            smoke_shrink(get_config(arch), dtype="float32", **over))


def _states(arch, **over):
    """The reference's fp32 train state and the port's from the same
    params."""
    jcfg, cfg = _configs(arch, **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jax_init(jp), init_opt_state(tp)


# ---------------------------------------------------------------- data ----
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 1), (7, 1000)])
def test_synthetic_batches_are_the_references(seed, step):
    ref, port = JD.SyntheticLM(100, 2, 8, seed=seed), \
        TD.SyntheticLM(100, 2, 8, seed=seed)
    for d in (ref, port):
        d.restore({"cursor_step": step, "cursor_seed": seed})
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert ref.meta() == port.meta() == {"cursor_step": step + 3,
                                         "cursor_seed": seed}


def test_token_file_batches_are_the_references(tmp_path):
    path = tmp_path / "toks.u32"
    np.arange(1000, dtype=np.uint32).tofile(path)
    ref, port = JD.TokenFile(str(path), 3, 40, offset=5), \
        TD.TokenFile(str(path), 3, 40, offset=5)
    for _ in range(9):    # wraps around the end of the file
        a, b = ref.next_batch(), port.next_batch()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        assert ref.meta() == port.meta()
    port.restore({"cursor_pos": 123})
    assert port.meta() == {"cursor_pos": 123}
    np.testing.assert_array_equal(port.next_batch()["tokens"][0, :3],
                                  [123, 124, 125])


def test_prefetcher_steal_and_cursor():
    pf = TD.Prefetcher(TD.SyntheticLM(100, 2, 8), depth=2)
    b = pf.next_batch()
    assert b["tokens"].shape == (2, 8)
    assert pf.meta() == {"cursor_step": 1, "cursor_seed": 0}
    time.sleep(0.05)
    stolen = pf.steal()
    assert stolen is None or stolen["tokens"].shape == (2, 8)
    pf.close()


def test_slow_consumer_gets_every_batch_where_the_reference_drops():
    """The reference's worker draws a new batch each time its put times
    out on a full queue; the port's keeps the batch it drew."""
    want = TD.SyntheticLM(100, 2, 8, seed=5)
    want = [want.next_batch()["tokens"] for _ in range(4)]
    got = {}
    for name, mod in (("ref", JD), ("port", TD)):
        src = mod.SyntheticLM(100, 2, 8, seed=5)
        pf = mod.Prefetcher(src, depth=1)
        time.sleep(0.5)                  # ~5 timed-out puts
        got[name] = [pf.next_batch()["tokens"] for _ in range(4)]
        pf.close()
    for a, b in zip(got["port"], want):
        np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, b) for a, b in zip(got["ref"], want))


# ----------------------------------------------------------- straggler ----
def test_dispatch_monitor_flags_are_the_references():
    rng = np.random.default_rng(4)
    lat = np.abs(rng.normal(0.01, 0.003, 300))
    lat[rng.integers(0, 300, 12)] *= 20
    streams = rng.integers(0, 3, 300)
    ref, port = JMonitor(factor=3.0, min_samples=3), \
        DispatchMonitor(factor=3.0, min_samples=3)
    for s, x in zip(streams, lat):
        assert ref.observe(f"s{s}", float(x)) == port.observe(f"s{s}",
                                                              float(x))
    assert dict(ref.flagged) == dict(port.flagged) and port.flagged
    assert ref.ewma == port.ewma and dict(ref.count) == dict(port.count)
    mon = DispatchMonitor(factor=2.0, min_samples=1)
    mon.observe("s1", 0.001)
    mon.observe("s1", 0.001)
    called = []
    out = mon.timed("s1", lambda: time.sleep(0.05) or "slow",
                    backup=lambda: called.append(1) or "backup")
    assert out == "backup" and called


# ---------------------------------------------------------- checkpoint ----
def test_checkpoint_roundtrip_dedup_async_and_gc(tmp_path):
    _, cfg, _, state = _states("qwen2.5-3b")
    store = CK.CheckpointStore(str(tmp_path))
    store.save(CK.to_reference_layout(state), step=1,
               extra_meta={"cursor_step": 5})
    w1 = store.stats["chunks_written"]
    store.save(CK.to_reference_layout(state), step=2)   # all chunks dedup
    assert store.stats["chunks_written"] == w1
    assert store.stats["chunks_deduped"] >= w1
    like = CK.to_reference_layout(TST.abstract_train_state(cfg), host=False)
    restored, manifest = store.restore(like, step=1)
    assert manifest["extra"] == {"cursor_step": 5} and manifest["step"] == 1
    back = CK.from_reference_layout(cfg, restored, "cpu")
    for a, b in zip(leaves(state), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # async: the snapshot is taken before the caller changes the state
    state["master"]["final_norm"]["scale"].add_(1.0)
    store.async_save(CK.to_reference_layout(state), step=3)
    state["master"]["final_norm"]["scale"].add_(1.0)
    store.wait()
    assert store.latest_step() == 3
    got = CK.from_reference_layout(cfg, store.restore(like)[0], "cpu")
    torch.testing.assert_close(got["master"]["final_norm"]["scale"],
                               state["master"]["final_norm"]["scale"] - 1.0)
    store.gc(keep_last=1)
    assert store.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["chunks", "manifest_00000003.json"]
    store.restore(like, step=3)


def test_checkpoint_of_bf16_params_async(tmp_path):
    """A tree of serving params (bf16 leaves, per-block lists) through
    async_save, as the reference's own test saves xlstm's params."""
    cfg = smoke_shrink(get_config("xlstm-350m"))
    params = L.to_tree(TM.init_params(cfg, 0, device="cpu"))
    store = CK.CheckpointStore(str(tmp_path))
    store.async_save(CK.to_reference_layout({"params": params}), step=3)
    store.wait()
    assert store.latest_step() == 3


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b",
                                  "whisper-large-v3"])
def test_checkpoint_bytes_are_the_references_and_restore_across(tmp_path,
                                                                 arch):
    """Same fp32 state: the manifest's bytes and every chunk's name
    (its hash) equal the reference's; each package restores the other's
    checkpoint leaf for leaf."""
    jcfg, cfg, jstate, state = _states(arch)
    a, b = tmp_path / "ref", tmp_path / "port"
    JStore(str(a)).save(jstate, 3, extra_meta={"cursor_step": 4})
    CK.CheckpointStore(str(b)).save(CK.to_reference_layout(state), 3,
                                    extra_meta={"cursor_step": 4})
    ma = (a / "manifest_00000003.json").read_bytes()
    assert ma == (b / "manifest_00000003.json").read_bytes()
    assert json.loads(ma)["data"]
    assert sorted(os.listdir(a / "chunks")) == sorted(os.listdir(b / "chunks"))
    like = CK.to_reference_layout(TST.abstract_train_state(cfg), host=False)
    mine = CK.from_reference_layout(
        cfg, CK.CheckpointStore(str(a)).restore(like)[0], "cpu")
    for x, y in zip(leaves(mine), leaves(state)):
        assert torch.equal(x, y)
    theirs, _ = JStore(str(b)).restore(JST.abstract_train_state(jcfg))
    for x, y in zip(jax.tree.leaves(theirs), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_train_resume_equals_continuous(tmp_path):
    """The port's counterpart of the reference's invariant: crash+restore
    at step 3 gives the final state of 6 uninterrupted steps (data cursor
    included), at atol 1e-5."""
    _, cfg = _configs("qwen2.5-3b", num_layers=1, d_model=32, d_ff=64,
                      vocab_size=64)
    step_fn = TST.make_train_step(cfg, AdamWConfig(warmup_steps=2,
                                                   decay_steps=8),
                                  remat="none")
    params = L.to_tree(TM.init_params(cfg, 0, device="cpu"))

    def run(n, state=None, data=None):
        data = data or TD.SyntheticLM(cfg.vocab_size, 2, 16)
        state = state or init_opt_state(params)
        for _ in range(n):
            b = {k: torch.from_numpy(v) for k, v in data.next_batch().items()}
            state, _ = step_fn(state, b)
        return state, data

    s_cont, _ = run(6)
    s3, data3 = run(3)
    store = CK.CheckpointStore(str(tmp_path))
    store.save(CK.to_reference_layout(s3), step=3, extra_meta=data3.meta())
    restored, manifest = store.restore(
        CK.to_reference_layout(TST.abstract_train_state(cfg), host=False))
    data_r = TD.SyntheticLM(cfg.vocab_size, 2, 16)
    data_r.restore(manifest["extra"])
    s_res, _ = run(3, CK.from_reference_layout(cfg, restored, "cpu"), data_r)
    assert int(s_res["step"]) == 6
    for a, b in zip(leaves(s_cont), leaves(s_res)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-5)


def test_reference_step_continues_from_a_port_checkpoint(tmp_path):
    """A port checkpoint taken after one port step restores into the
    reference, whose next step equals the port's next step (fp32,
    1e-5)."""
    jcfg, cfg, jstate, state = _states("qwen2.5-3b", num_layers=1,
                                       d_model=32, d_ff=64, vocab_size=64)
    opt = AdamWConfig(warmup_steps=2, decay_steps=8)
    step = TST.make_train_step(cfg, opt, remat="none")
    data = TD.SyntheticLM(cfg.vocab_size, 2, 16)
    b0, b1 = data.next_batch(), data.next_batch()
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in b0.items()})
    store = CK.CheckpointStore(str(tmp_path))
    store.save(CK.to_reference_layout(state), step=1)
    jst, _ = JStore(str(tmp_path)).restore(JST.abstract_train_state(jcfg))
    jstep = jax.jit(JST.make_train_step(jcfg, None, opt, remat="none"))
    jst, jm = jstep(jax.tree.map(jnp.asarray, jst),
                    {k: jnp.asarray(v) for k, v in b1.items()})
    state, m = step(state, {k: torch.from_numpy(v) for k, v in b1.items()})
    assert abs(float(jm["loss"]) - float(m["loss"])) < 1e-5
    mine = metasync._paths(CK.to_reference_layout(state))
    theirs = {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in
              jax.tree_util.tree_flatten_with_path(jst)[0]}
    assert list(mine) == list(theirs)
    # a master element whose gradients stayed below 1e-6 moves by a
    # fraction of lr that fp32 rounding decides (test_torch_train.py:
    # _assert_states_equal): held to the two steps' bound, 2 (lr1 + lr2)
    bound = 2 * 2 * float(jm["lr"]) + 1e-5
    for path, x in theirs.items():
        y = mine[path].numpy()
        ok = np.ones(x.shape, bool)
        if path.startswith("['master']"):
            ok = np.abs(theirs["['m']" + path[10:]]) / (1 - 0.9) >= 1e-6
        np.testing.assert_allclose(y[ok], x[ok], atol=1e-5, rtol=1e-5)
        assert np.all(np.abs(y - x)[~ok] <= bound), path
