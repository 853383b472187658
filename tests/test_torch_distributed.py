"""The port's sharding on several ranks, against the JAX reference, on the
CPU: worlds of 4 gloo ranks (``tests/torch_dist_ranks.py``) run the
port's plain versions on 2 x 2, 1 x 4 and 4 x 1 meshes, the reference
runs in this process (one device) or, where it needs a mesh, in a JAX
subprocess on 4 XLA CPU devices, and the launcher runs under
``torch.distributed.run``.  Every world, the JAX subprocess and the
launchers start together once for the module (``runs``), each with a
time limit, so a hung collective fails its tests instead of stalling
the suite.

What is held: each custom op's strategies (every row, on 2 x 2 and 1 x 4,
the GQA case Hkv = 2 over a model axis of 4 among them) give the op's
whole result at ``kernels.TOLERANCE``, through autograd too; a train step
of the four families on 2 x 2 under ``rules_for("train")`` (and
``train_zero`` on qwen) equals the unsharded port's and the reference's
at fp32 1e-5 (``test_torch_train.py``'s exception for sub-resolution
masters); prefill plus two fused decode blocks under the serve rules
give the unsharded port's and the reference's greedy tokens; each rank's
local shard of a tuple-mapped leaf is the reference's
``devices_indices_map`` slice; ``compressed_psum`` over 4 ranks equals
the reference's within 1e-6; a reference checkpoint restored onto 2 x 2
takes the reference's elastic step; and 2 ranks of the launcher give the
1-rank launcher's losses."""
import json
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as RANKS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.runtime.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.kernels import _sharding  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.checkpoint import (from_reference_layout,  # noqa: E402
                                            to_reference_layout)
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import steps as TST  # noqa: E402
from test_torch_train import (OPT, _assert_states_equal, _batch,  # noqa: E402
                              _close)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("qwen2.5-3b", "deepseek-v2-lite-16b", "zamba2-1.2b",
            "xlstm-350m")
TRAIN = [(a, "train") for a in FAMILIES] + [("qwen2.5-3b", "train_zero")]
CACHE_LEN, BLOCK_K = 32, 4
TIMEOUT = 400     # seconds for every process of the module
# the worlds, started together; each runs its jobs in order
WORLDS = (["strategies", "shards", "slots", "psum", "elastic"],
          [f"train:{a}:{m}" for a, m in TRAIN[:2]] + [
              f"train:{a}:{m}" for a, m in TRAIN[4:]],
          [f"train:{a}:{m}" for a, m in TRAIN[2:4]],
          [f"serve:{a}" for a in FAMILIES])
_ELASTIC_OVER = dict(num_layers=1, d_model=32, d_ff=64, vocab_size=64)

_JAX_MESH = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[1])
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import get_config, smoke_shrink
from repro.runtime.checkpoint import CheckpointStore
from repro.runtime.elastic import make_elastic_mesh, reshard_state
from repro.sharding import rules_for
from repro.training import steps as ST
from repro.training.grad_compress import compressed_psum
from repro.training.optimizer import AdamWConfig
out, cases = sys.argv[2], json.loads(sys.argv[3])
res = {}
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
for name, (shape, sp) in cases.items():
    sp = [tuple(e) if isinstance(e, list) else e for e in sp]
    idx = NamedSharding(mesh, P(*sp)).devices_indices_map(tuple(shape))
    full = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    for r, d in enumerate(jax.devices()):
        res[f"shard_{name}_{r}"] = full[idx[d]]
m4 = compat.make_mesh((4,), ("data",))
with compat.set_mesh(m4):
    res["psum_same"] = np.asarray(compressed_psum(
        jnp.linspace(-1.0, 1.0, 4096).reshape(64, 64), m4, "data"))
    res["psum_odd"] = np.asarray(compressed_psum(
        jnp.linspace(-1.0, 1.0, 35).reshape(5, 7), m4, "data"))
cfg = smoke_shrink(get_config("qwen2.5-3b"), dtype="float32",
                   **json.loads(sys.argv[5]))
store = CheckpointStore(sys.argv[4])
state_np, _ = store.restore(ST.abstract_train_state(cfg))
emesh = make_elastic_mesh(prefer_model=2)
state = reshard_state(state_np, ST.train_state_axes(cfg), emesh)
step = ST.make_train_step(cfg, rules_for("train", emesh.axis_names),
                          AdamWConfig(warmup_steps=1, decay_steps=10),
                          remat="none")
batch = {k: jnp.asarray(v) for k, v in np.load(sys.argv[6]).items()}
with compat.set_mesh(emesh):
    _, m = jax.jit(step)(state, batch)
res["elastic_loss"] = np.asarray(m["loss"])
res["elastic_mesh"] = np.asarray(emesh.devices.shape)
np.savez(out, **res)
"""


def _setup(arch, **over):
    """(reference cfg, reference params, port cfg, port params) at fp32
    smoke widths: the port's seeded params, and the same values in the
    reference's layout (``to_reference_layout``) as the reference's."""
    jcfg = jax_smoke_shrink(jax_get_config(arch), dtype="float32", **over)
    cfg = smoke_shrink(get_config(arch), dtype="float32", **over)
    tp = L.to_tree(TM.init_params(cfg, 0, device="cpu"))
    return jcfg, jax.tree.map(jnp.asarray, to_reference_layout(tp)), cfg, tp


def _launcher(extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, *extra, "-m", "repro_torch.launch.train",
         "--device", "cpu", "--steps", "3", "--log-every", "1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _train_expected(jcfg, jp, cfg, tp, batch):
    """(the reference's state and metrics, the unsharded port's state in
    the reference's layout and its metrics) of one train step."""
    jstep = jax.jit(JST.make_train_step(jcfg, None, JO.AdamWConfig(**OPT),
                                        remat="none"))
    jstate, jm = jstep(JO.init_opt_state(jp),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    step = TST.make_train_step(cfg, TO.AdamWConfig(**OPT), remat="none")
    state, m = step(TO.init_opt_state(tp),
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    return jstate, jm, to_reference_layout(state), m


def _serve_tokens(pre, fused, params, prompts, as_array):
    """The next token of a prefill, then two fused decode blocks."""
    B, S = prompts.shape
    o, caches = pre(params, {"tokens": as_array(prompts)})
    pos = as_array(np.full((B,), S, np.int32))
    f1, caches = fused(params, o["next_tokens"], pos, caches)
    f2, caches = fused(params, f1["tokens"][:, -1], f1["pos"], caches)
    return np.concatenate([np.asarray(o["next_tokens"])[:, None],
                           np.asarray(f1["tokens"]),
                           np.asarray(f2["tokens"])], 1)


def _serve_expected(jcfg, jp, cfg, tp, prompts):
    """(the reference's tokens, the unsharded port's)."""
    ref = _serve_tokens(
        jax.jit(JST.make_prefill_step(jcfg, None, CACHE_LEN)),
        jax.jit(JST.make_fused_decode_step(jcfg, None, k=BLOCK_K)),
        jp, prompts.astype(np.int32), jnp.asarray)
    plain = _serve_tokens(TST.make_prefill_step(cfg, CACHE_LEN),
                          TST.make_fused_decode_step(cfg, k=BLOCK_K),
                          tp, prompts, torch.from_numpy)
    return ref, plain


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every world, the JAX subprocess and the two launchers;
    compute the reference's and the unsharded port's results while they
    run; wait for all of them.  -> the processes' (returncode, stdout,
    stderr tail), the expected results, the inputs and the paths."""
    root = tmp_path_factory.mktemp("dist")
    inputs = {"opt": OPT, "cache_len": CACHE_LEN, "block_k": BLOCK_K,
              "cfgs": {}, "params": {}, "batch": {}, "prompts": {}}
    refs = {}
    rng = np.random.default_rng(0)
    for arch in FAMILIES:
        jcfg, jp, cfg, tp = _setup(arch)
        inputs["cfgs"][arch], inputs["params"][arch] = cfg, tp
        inputs["batch"][arch] = _batch(cfg)
        inputs["prompts"][arch] = rng.integers(
            3, cfg.vocab_size, (4, 8)).astype(np.int64)
        refs[arch] = (jcfg, jp)
    _, ejp, ecfg, _ = _setup("qwen2.5-3b", **_ELASTIC_OVER)
    ckpt = root / "ckpt"
    JaxStore(str(ckpt)).save(JO.init_opt_state(ejp), step=1)
    ebatch = _batch(ecfg, seed=3, B=4, S=16)
    np.savez(root / "elastic_batch.npz", **ebatch)
    inputs.update(elastic_cfg=ecfg, ckpt_dir=str(ckpt), elastic_batch=ebatch)

    procs = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for i, jobs in enumerate(WORLDS):
        d = root / f"world{i}"
        d.mkdir()
        torch.save(inputs, d / "inputs.pt")
        procs[f"world{i}"] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"),
             str(d), *jobs], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    cases = {n: (list(shape), None) for n, (shape, _) in
             RANKS.SHARD_CASES.items()}
    from repro_torch import sharding as SH
    for n, (shape, axes) in RANKS.SHARD_CASES.items():
        cases[n] = (list(shape), SH.spec(axes, SH.rules_for(
            "train_zero", ("data", "model")), shape,
            {"data": 2, "model": 2}))
    procs["jax"] = subprocess.Popen(
        [sys.executable, "-c", _JAX_MESH, str(ROOT / "src"),
         str(root / "jax_mesh.npz"), json.dumps(cases), str(ckpt),
         json.dumps(_ELASTIC_OVER), str(root / "elastic_batch.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["launcher2"] = _launcher(["-m", "torch.distributed.run",
                                    "--standalone", "--nproc-per-node", "2"])
    procs["launcher1"] = _launcher([])
    with ThreadPoolExecutor(4) as pool:    # XLA compiles off the GIL
        futures = {(kind, arch): pool.submit(
            fn, *refs[arch], inputs["cfgs"][arch], inputs["params"][arch],
            inputs[key][arch])
            for kind, fn, key in (("train", _train_expected, "batch"),
                                  ("serve", _serve_expected, "prompts"))
            for arch in FAMILIES}
        expected = {k: f.result() for k, f in futures.items()}
    done = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            err += f"\n{name}: timed out after {TIMEOUT} s"
        done[name] = (p.returncode, out, err[-4000:])
    return {"root": root, "procs": done, "expected": expected,
            "inputs": inputs}


def _result(runs, world, job):
    code, _, err = runs["procs"][f"world{world}"]
    path = runs["root"] / f"world{world}" / (job.replace(":", "_") + ".pt")
    assert code == 0 and path.exists(), err
    return torch.load(path, weights_only=False)


def _world_of(job):
    return next(i for i, jobs in enumerate(WORLDS) if job in jobs)


# ----------------------------------------------------------- strategies --
@pytest.mark.parametrize("name", [n for n, _ in _sharding.strategies()])
def test_every_strategy_row_gives_the_whole_result(runs, name):
    """Each row, on each mesh dim of 2 x 2 and 1 x 4 that can hold it, is
    the row DTensor picks for inputs placed by it (its output placements
    come out), and the result is the op's on whole tensors at
    ``kernels.TOLERANCE`` (atol = rtol); the five forwards with a
    backward also through autograd; the GQA cases (q's heads split over
    whole K/V, Hkv 2 over a model axis of 4) give the whole result."""
    res = _result(runs, 0, "strategies")
    mine = {k: v for k, v in res.items() if k.split("/")[0] == name}
    assert any("/1x4/" in k for k in mine) and any("/2x2/" in k for k in mine)
    rows = {k.split("/")[3] for k in mine if "/2x2/" in k}
    assert len(rows) >= 2, mine         # a split row and the replicate row
    for case, v in mine.items():
        if case.endswith("/grad"):
            assert v <= 1e-4, (case, v)
            continue
        tol = 2e-2 if v["dtype"] == "torch.bfloat16" else 1e-4
        assert v["err"] <= tol, (case, v)
        assert v["picked"] or "/gqa" in case, (case, v)
    if name in RANKS.AUTOGRAD:
        assert any(k.endswith("/grad") for k in mine)
    if name in RANKS.GQA_OPS:
        assert any("/gqa" in k for k in mine)


# -------------------------------------------------------------- train --
@pytest.mark.parametrize("arch,mode", TRAIN, ids=[f"{a}-{m}" for a, m in TRAIN])
def test_train_step_on_a_2x2_mesh_equals_reference(runs, arch, mode):
    got = _result(runs, _world_of(f"train:{arch}:{mode}"),
                  f"train:{arch}:{mode}")
    assert got["sharded"] > 0        # the state really is split
    cfg = runs["inputs"]["cfgs"][arch]
    jstate, jm, plain, m = runs["expected"][("train", arch)]
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        _close(got["metrics"][key], jm[key])
        _close(got["metrics"][key], m[key])
    state = from_reference_layout(cfg, got["state"], "cpu")
    _assert_states_equal(jstate, state, float(jm["lr"]))
    # and the unsharded port's state, held the same way
    _assert_states_equal(jax.tree.map(np.asarray, plain), state,
                         float(jm["lr"]))


# -------------------------------------------------------------- serve --
@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_rules_give_the_unsharded_and_reference_tokens(runs, arch):
    got = _result(runs, 3, f"serve:{arch}")
    ref, plain = runs["expected"][("serve", arch)]
    B = runs["inputs"]["prompts"][arch].shape[0]
    assert got.shape == (B, 1 + 2 * BLOCK_K)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------ shards, psum --
def _jax_mesh(runs):
    code, _, err = runs["procs"]["jax"]
    assert code == 0, err
    return np.load(runs["root"] / "jax_mesh.npz")


@pytest.mark.parametrize("case", list(RANKS.SHARD_CASES))
def test_local_shards_are_the_reference_device_slices(runs, case):
    """Rank r of the 2 x 2 mesh holds what device r of the reference's
    ``Mesh(devices.reshape(2, 2), ("data", "model"))`` holds."""
    every = _result(runs, 0, "shards")
    ref = _jax_mesh(runs)
    for r, res in enumerate(every):
        np.testing.assert_array_equal(res[case]["local"],
                                      ref[f"shard_{case}_{r}"])
    if case.startswith("tuple"):
        assert any(isinstance(e, tuple) for e in every[0][case]["spec"])


@pytest.mark.parametrize("case", list(RANKS.SLOT_CASES))
def test_write_slots_on_a_dtensor_cache(runs, case):
    """``write_slots`` into a DTensor cache equals ``index_put_`` on the
    whole cache; a cache whose batch and slot dims every rank holds whole
    (a slot split over a mesh dim of one included) is written in its
    local shard, one split over them through the mask."""
    got, masked = _result(runs, _world_of("slots"), "slots")[case]
    g = torch.Generator().manual_seed(7)
    want = torch.randn(4, 8, 4, 2, generator=g)
    want[torch.arange(4), torch.tensor([5, 0, 7, 3])] = \
        torch.randn(4, 4, 2, generator=g)
    np.testing.assert_array_equal(got, want.numpy())
    assert masked == (case == "batch_slots_split")


def test_compressed_psum_equals_reference(runs):
    got = _result(runs, 0, "psum")
    ref = _jax_mesh(runs)
    x = np.linspace(-1.0, 1.0, 4096, dtype=np.float32).reshape(64, 64)
    np.testing.assert_allclose(got["same"], ref["psum_same"], atol=1e-6,
                               rtol=0)
    assert np.abs(got["same"] - 4 * x).max() < 0.03   # tests/test_runtime.py
    np.testing.assert_allclose(got["odd"], ref["psum_odd"], atol=1e-6,
                               rtol=0)
    assert got["odd"].shape == (5, 7)


def test_compressed_psum_of_different_inputs_is_their_sum(runs):
    """x differs on every rank: the result is the exact sum within the
    two quantizations' bound (half a step of each rank's scale, then half
    a step of the requantized sum's)."""
    got = _result(runs, 0, "psum")
    xs = got["per_rank_x"]
    exact = xs.sum(0)
    s1 = sum(np.abs(x).max() / 127 for x in xs) / 2
    s2 = np.abs(exact).max() * 1.01 / 127 / 2
    assert np.abs(got["per_rank"] - exact).max() <= s1 + s2 + 1e-5


def test_elastic_restore_of_a_reference_checkpoint(runs):
    """Saved by the reference's CheckpointStore on one device, restored by
    the port onto 2 x 2 (``restore_on_mesh``): its step's loss is the
    reference's elastic step's (restored onto its own 2 x 2 mesh)."""
    got = _result(runs, 0, "elastic")
    ref = _jax_mesh(runs)
    assert got["step"] == 1 and list(ref["elastic_mesh"]) == [2, 2]
    assert got["mesh"] == (2, 2)
    _close(got["metrics"]["loss"], ref["elastic_loss"])


# ----------------------------------------------------------- launcher --
def _losses(out):
    return [float(v) for v in re.findall(r"loss (\d+\.\d+)", out)]


def _gnorms(out):
    return [float(v) for v in re.findall(r"gnorm (\d+\.\d+)", out)]


def test_launcher_on_two_ranks_matches_one(runs):
    """``torch.distributed.run --nproc-per-node 2`` of the launcher takes
    3 steps data-parallel on gloo (DTensors); rank 0 alone prints.  One
    rank trains on plain tensors.  The launcher prints the loss to 4
    decimals and the grad norm to 3, of the bf16 smoke config, where a
    half batch rounds differently from a whole one.  Measured: step 1's
    printed loss and grad norm equal, later steps' within one printed
    digit.  Step 1 (the same params and global batch) is held to one
    printed digit, later steps to three.  For scale: the launcher at
    ``--batch 4``, from the same params, printed a step-1 loss and grad
    norm 0.03 and 0.46 away from ``--batch 8``'s."""
    (c2, out2, err2), (c1, out1, err1) = (runs["procs"]["launcher2"],
                                          runs["procs"]["launcher1"])
    assert c2 == 0, err2
    assert c1 == 0, err1
    l2, l1 = _losses(out2), _losses(out1)
    n2, n1 = _gnorms(out2), _gnorms(out1)
    assert len(l1) == 4 and len(l2) == 4, (out1, out2)  # 3 steps + done
    assert len(n1) == 3 and len(n2) == 3, (out1, out2)
    assert out2.count("step     1 loss") == 1           # rank 0 prints
    np.testing.assert_allclose(l2[:1], l1[:1], atol=1.5e-4, rtol=0)
    np.testing.assert_allclose(n2[:1], n1[:1], atol=1.5e-3, rtol=0)
    np.testing.assert_allclose(l2, l1, atol=3.5e-4, rtol=0)
    np.testing.assert_allclose(n2, n1, atol=3.5e-3, rtol=0)
