"""The port's serving stack (Engine -> Scheduler -> StreamExecutor ->
CommitFrontier over a LiveChannel) against the JAX Engine on the CPU: the
same params and prompts give the same tokens and the same host-sync and
speculation counts; billed to an emulated link (``netem=``, and each
dispatch through a ``NetemBilledChannel``), the same netem totals and
billing log."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.core import netem as JN  # noqa: E402
from repro.core.channel import LiveChannel as JaxLiveChannel  # noqa: E402
from repro.core.channel import \
    NetemBilledChannel as JaxBilledChannel  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import \
    cache_batch_axes_for as jax_cache_batch_axes_for  # noqa: E402
from repro.sharding import rules_for  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core import netem as N  # noqa: E402
from repro_torch.core.channel import NetemBilledChannel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import cache_batch_axes_for  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCK_K, CACHE_LEN, N_SLOTS = 4, 96, 2
STATS = ("host_syncs", "spec_blocks", "sync_blocks", "mispredicts",
         "blocks_dispatched", "prefill_dispatches", "retired")


def _jax_engine(cfg, params, *, speculate, depth, netem=None, bill=False):
    """Built as tests/test_serving_pipeline.py builds it; ``bill`` wraps
    its live channel in a NetemBilledChannel on ``netem``."""
    rules = rules_for("serve", make_host_mesh(model=1).axis_names)
    channel = JaxLiveChannel(
        jax.jit(JST.make_prefill_step(cfg, rules, CACHE_LEN)),
        jax.jit(JST.make_fused_decode_step(cfg, rules, k=BLOCK_K, eos_id=2),
                donate_argnums=(3,)),
        jax.jit(JST.make_batched_prefill_step(cfg, rules, CACHE_LEN)))
    if bill:
        channel = JaxBilledChannel(channel, netem)
    return JaxEngine(
        params, channel=channel, netem=netem,
        n_slots=N_SLOTS, cache_len=CACHE_LEN, block_k=BLOCK_K, eos_id=2,
        init_caches_fn=lambda: JM.init_cache(cfg, N_SLOTS, CACHE_LEN),
        cache_batch_axes=jax_cache_batch_axes_for(cfg), speculate=speculate,
        pipeline_depth=depth)


def _submit(eng, vocab, n=5, max_new=14, seed=7):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        plen = int(rng.integers(4, 12))
        eng.submit(list(rng.integers(3, vocab, plen)), max_new)


@pytest.fixture(scope="module", params=["cody-mnist", "qwen2.5-3b"])
def models(request):
    arch = request.param
    jcfg = jax_smoke_shrink(jax_get_config(arch), dtype="float32")
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def test_cache_batch_axes_match_reference(models):
    jcfg, cfg, _, _ = models
    assert cache_batch_axes_for(cfg) == jax_cache_batch_axes_for(jcfg)


@pytest.mark.parametrize("speculate,depth", [(True, 4), (False, 1)])
def test_engine_matches_jax_engine(models, speculate, depth):
    jcfg, cfg, jp, tp = models
    jeng = _jax_engine(jcfg, jp, speculate=speculate, depth=depth)
    _submit(jeng, cfg.vocab_size)
    want = jeng.run()
    eng = serve.build_engine(cfg, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                             block_k=BLOCK_K, params=tp, device="cpu",
                             speculate=speculate, pipeline_depth=depth)
    _submit(eng, cfg.vocab_size)
    assert eng.run() == want
    assert {k: eng.stats[k] for k in STATS} == \
        {k: jeng.stats[k] for k in STATS}
    assert eng.spec.stats == jeng.spec.stats
    for req in eng.requests.values():
        assert req.done and req.committed == len(req.generated)


@pytest.mark.parametrize("bill", [True, False], ids=["billed", "netem"])
@pytest.mark.parametrize("profile,speculate,depth",
                         [("wifi", True, 4), ("cellular", False, 1)])
def test_netem_billed_engine_matches_jax_engine(models, profile, speculate,
                                                depth, bill):
    """The round trips the engine bills (synchronous prefills, commits,
    frontier drains) and, billed, each step dispatch: equal netem totals
    and an equal billing log, beside equal tokens and host syncs."""
    jcfg, cfg, jp, tp = models
    jem = JN.NetworkEmulator(JN.PROFILES[profile])
    jeng = _jax_engine(jcfg, jp, speculate=speculate, depth=depth,
                       netem=jem, bill=bill)
    _submit(jeng, cfg.vocab_size)
    want = jeng.run()
    em = N.NetworkEmulator(N.PROFILES[profile])
    eng = serve.build_engine(cfg, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                             block_k=BLOCK_K, params=tp, device="cpu",
                             speculate=speculate, pipeline_depth=depth,
                             netem=em, bill_dispatches=bill)
    _submit(eng, cfg.vocab_size)
    assert eng.run() == want
    assert {k: eng.stats[k] for k in STATS} == \
        {k: jeng.stats[k] for k in STATS}
    assert em.snapshot() == jem.snapshot()
    assert em.round_trips > 0
    assert isinstance(eng.channel, NetemBilledChannel) == bill
    if bill:
        assert eng.channel.log == jeng.channel.log
        assert em.async_trips >= len(eng.channel.log)


def test_spec_and_sync_streams_identical(models):
    _, cfg, _, tp = models
    outs, syncs = [], []
    for speculate, depth in ((False, 1), (True, 4), (True, 2)):
        eng = serve.build_engine(cfg, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                                 block_k=BLOCK_K, params=tp, device="cpu",
                                 speculate=speculate, pipeline_depth=depth)
        _submit(eng, cfg.vocab_size, n=6, max_new=17, seed=11)
        outs.append(eng.run())
        syncs.append(eng.stats["host_syncs"])
    assert outs[0] == outs[1] == outs[2]
    assert syncs[1] < syncs[0]


@pytest.mark.parametrize("arch", ["cody-mnist", "zamba2-1.2b",
                                  "xlstm-350m", "deepseek-v2-lite-16b"])
def test_serve_cli_on_cpu(capsys, arch):
    outs, eng = serve.main(["--arch", arch, "--smoke", "--device",
                            "cpu", "--requests", "3", "--max-new", "6",
                            "--cache-len", "32", "--block-k", "4"])
    assert len(outs) == 3 and all(1 <= len(v) <= 6 for v in outs.values())
    assert "engine stats" in capsys.readouterr().out
    if arch in ("zamba2-1.2b", "xlstm-350m"):   # recurrent: per-request
        # prefill, no spec
        assert eng.stats["spec_blocks"] == 0
        assert eng.stats["prefill_dispatches"] == 3


def test_serve_cli_bills_the_net(capsys):
    outs, eng = serve.main(["--arch", "cody-mnist", "--smoke", "--device",
                            "cpu", "--requests", "2", "--max-new", "5",
                            "--cache-len", "32", "--block-k", "4",
                            "--net", "cellular"])
    assert len(outs) == 2
    assert "net (cellular, emulated)" in capsys.readouterr().out
    assert eng.scheduler.netem.round_trips >= eng.stats["host_syncs"] > 0


def test_build_engine_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = smoke_shrink(get_config("cody-mnist"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_engine(cfg, n_slots=2, cache_len=32, block_k=4)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
