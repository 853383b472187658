"""Record -> sign -> replay in the port, against the JAX reference on the
CPU: fingerprints, signatures and the recording framing byte for byte,
the tamper matrix with ``torch.export.load`` made to fail if reached, the
Replayer's semantics and counters, and end to end for cody-mnist and
qwen2.5-3b at smoke width: replayed tokens equal to the port's live
Engine and to the JAX package's replay Engine (the other families are in
``tests/test_torch_replay_families.py``)."""
import copy
import io
import json
import os
import pathlib
import pickle
import random
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Workspace  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.core import attest as JA  # noqa: E402
from repro.core.recorder import compile_artifact as jax_compile  # noqa: E402
from repro.core.recording import Recording as JaxRecording  # noqa: E402
from repro.core.replay import Replayer as JaxReplayer  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.api.workload import (build_step, recording_name,  # noqa: E402
                                      static_meta_for)
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core import _msgpack  # noqa: E402
from repro_torch.core import attest as A  # noqa: E402
from repro_torch.core.channel import (LiveChannel,  # noqa: E402
                                      NetemBilledChannel, ReplayChannel)
from repro_torch.core.netem import WIFI, NetworkEmulator  # noqa: E402
from repro_torch.core.recorder import compile_artifact  # noqa: E402
from repro_torch.core.recording import Recording  # noqa: E402
from repro_torch.core.replay import ReplayArgumentError, Replayer  # noqa: E402
from repro_torch.launch import record as record_cli  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.training import steps as ST  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = b"replay-test-key"
BLOCK_K, CACHE_LEN, N_SLOTS, SEQ = 4, 32, 2, 8
STATS = ("host_syncs", "spec_blocks", "sync_blocks", "mispredicts",
         "blocks_dispatched", "prefill_dispatches", "retired")


@pytest.fixture
def no_export_load(monkeypatch):
    """torch.export.load fails if a test's bytes ever reach it."""
    def refuse(*a, **k):
        raise AssertionError("torch.export.load reached")
    monkeypatch.setattr(torch.export, "load", refuse)


# ------------------------------------------------------------ attest ----
PARTS = [b"raw bytes", {"b": [1, 2.5, None], "a": "x"}, [True, "s", -3],
         "str", 0, 1.25, None, {"nested": {"z": 1, "y": [b"".hex()]}}]


@pytest.mark.parametrize("part", PARTS, ids=lambda p: type(p).__name__)
def test_canonical_fingerprint_and_sign_equal_the_reference(part):
    assert A.canonical(part) == JA.canonical(part)
    assert A.fingerprint(part, "tail", 7) == JA.fingerprint(part, "tail", 7)
    blob = A.canonical(part)
    assert A.sign(blob, KEY) == JA.sign(blob, KEY)
    assert A.verify(blob, JA.sign(blob, KEY), KEY)
    assert not A.verify(blob, JA.sign(blob, KEY), b"other")


def test_fingerprint_keeps_the_strict_type_error():
    for bad in (object(), {1, 2}, np.float32(1.0)):
        with pytest.raises(TypeError, match="no canonical encoding"):
            A.fingerprint(bad)
        with pytest.raises(TypeError):
            JA.fingerprint(bad)


def test_error_hierarchy_matches_the_reference():
    for name in ("TamperedRecordingError", "UnverifiedRecordingError",
                 "TopologyMismatchError", "AttestationError",
                 "SplitViewError", "QuoteVerificationError",
                 "FutureEpochError", "RotatedKeyError"):
        mine, ref = getattr(A, name), getattr(JA, name)
        assert [c.__name__ for c in mine.__mro__] == \
            [c.__name__ for c in ref.__mro__], name


# ----------------------------------------------------------- msgpack ----
INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
             -2**31 - 1, -2**63]


def _random_manifest(rng, depth=0):
    kind = rng.randrange(9 if depth < 3 else 6)
    if kind == 0:
        return rng.choice(INT_EDGES)
    if kind == 1:
        return rng.uniform(-1, 1) * 10.0 ** rng.randrange(-300, 300)
    if kind == 2:
        n, at = rng.choice([0, 1, 31, 32, 255, 256, 70000]), rng.randrange(5)
        return ("abé漢\x00" * (n // 5 + 2))[at:at + n]
    if kind == 3:
        n = rng.choice([0, 3, 255, 256, 65536])
        return rng.randbytes(n)
    if kind == 4:
        return rng.choice([True, False, None])
    if kind == 5:
        return rng.randrange(-2**63, 2**64)
    if kind == 6:
        return [_random_manifest(rng, depth + 1)
                for _ in range(rng.choice([0, 3, 15, 16, 17]))]
    return {f"k{i}{rng.choice('xy')}": _random_manifest(rng, depth + 1)
            for i in range(rng.choice([0, 2, 15, 16, 17]))}


def test_msgpack_subset_matches_msgpack_over_random_manifests():
    rng = random.Random(0)
    for i in range(200):
        obj = {"manifest": _random_manifest(rng), "n": i}
        want = msgpack.packb(obj, use_bin_type=True)
        assert _msgpack.packb(obj) == want, i
        assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False), i
    for x in (float("inf"), -0.0, 5e-324):
        assert _msgpack.packb(x) == msgpack.packb(x, use_bin_type=True)


def test_msgpack_subset_refuses_what_it_does_not_frame():
    with pytest.raises(TypeError):
        _msgpack.packb({"x": object()})
    with pytest.raises(OverflowError):
        _msgpack.packb(2**64)
    packed = _msgpack.packb({"a": [1, 2]})
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(packed + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(packed[:-1])
    with pytest.raises(ValueError, match="map key"):
        _msgpack.unpackb(msgpack.packb({1: 2}))


# --------------------------------------------------------- recording ----
def _fields():
    manifest = {"name": "t", "static": {"cache_len": 64, "backend": "torch"},
                "inputs": [{"shape": [4, 4], "dtype": "float32"}],
                "cost": {}, "memory": {"arg_bytes": 64, "temp_bytes": None,
                                       "out_bytes": 64}, "ratio": 0.5}
    return manifest, b"\x01\x02" * 700, json.dumps(["in", "out"]).encode()


def test_recording_bytes_equal_the_reference_and_verify_across():
    manifest, payload, trees = _fields()
    mine = Recording(copy.deepcopy(manifest), payload, trees).sign_with(KEY)
    ref = JaxRecording(copy.deepcopy(manifest), payload, trees).sign_with(KEY)
    assert mine.signature == ref.signature
    assert mine.to_bytes() == ref.to_bytes()
    assert JaxRecording.from_bytes(mine.to_bytes(), KEY).manifest == manifest
    assert Recording.from_bytes(ref.to_bytes(), KEY).payload == payload


def _flip_mid_byte(b: bytes) -> bytes:
    ba = bytearray(b)
    ba[len(ba) // 2] ^= 0x5A
    return bytes(ba)


def test_recording_tamper_matrix(no_export_load):
    """A change to any section surfaces as TamperedRecordingError, through
    Recording.from_bytes and through a Replayer, before any load."""
    manifest, payload, trees = _fields()
    rec = Recording(manifest, payload, trees).sign_with(KEY)
    assert Recording.from_bytes(rec.to_bytes(), KEY).manifest == rec.manifest
    mutations = {
        "manifest": lambda r: r.manifest.__setitem__(
            "static", {"cache_len": 9999}),
        "payload": lambda r: setattr(r, "payload", _flip_mid_byte(r.payload)),
        "trees": lambda r: setattr(r, "trees", _flip_mid_byte(r.trees)),
        "signature": lambda r: setattr(
            r, "signature",
            ("0" if r.signature[0] != "0" else "1") + r.signature[1:]),
    }
    for section, mutate in mutations.items():
        tampered = Recording(dict(rec.manifest), rec.payload, rec.trees,
                             rec.signature)
        mutate(tampered)
        with pytest.raises(A.TamperedRecordingError):
            Recording.from_bytes(tampered.to_bytes(), KEY)
        rp = Replayer(key=KEY, device="cpu")
        with pytest.raises(A.TamperedRecordingError):
            rp.load(tampered.to_bytes())
        assert rp.stats["rejected"] == 1, section


def test_unsigned_loads_need_an_explicit_opt_in():
    manifest, payload, trees = _fields()
    blob = Recording(manifest, payload, trees).sign_with(KEY).to_bytes()
    with pytest.raises(A.UnverifiedRecordingError):
        Recording.from_bytes(blob)
    with pytest.raises(A.UnverifiedRecordingError):
        Replayer(device="cpu")
    assert Recording.from_bytes(blob, allow_unsigned=True).payload == payload


# ---------------------------------------------------------- replayer ----
def _torch_fn(x):
    return torch.tanh(x) * 2.0


def _jax_fn(x):
    return jnp.tanh(x) * 2.0


def _recorded(n, name="t"):
    return compile_artifact(name, _torch_fn, (torch.zeros(n),))


def test_record_replay_roundtrip_and_tamper(monkeypatch):
    rec = _recorded(8)
    assert rec.manifest["inputs"] == [{"shape": [8], "dtype": "float32"}]
    assert rec.manifest["static"] == {"backend": "torch"}
    assert rec.manifest["memory"] == {"arg_bytes": 32, "temp_bytes": None,
                                      "out_bytes": 32}
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.codyrec")
        rec.save(p, KEY)
        rp = Replayer(key=KEY, device="cpu")
        rp.load(p)
        x = torch.linspace(-1, 1, 8)
        torch.testing.assert_close(rp.execute("t", x), _torch_fn(x))
        blob = open(p, "rb").read()
    monkeypatch.setattr(torch.export, "load", lambda *a, **k: (_ for _ in (
        )).throw(AssertionError("torch.export.load reached")))
    with pytest.raises(A.TamperedRecordingError):
        Replayer(key=b"wrong", device="cpu").load(blob)
    for off in (10, len(blob) // 2, len(blob) - 20):
        b2 = bytearray(blob)
        b2[off] ^= 0x5A
        with pytest.raises(A.TamperedRecordingError):
            Replayer(key=KEY, device="cpu").load(bytes(b2))


def test_topology_mismatch_is_refused_before_load(no_export_load):
    rec = _recorded(4)
    rec.manifest["topology"] = A.fingerprint(["NVIDIA H100 80GB HBM3"], 1)
    rp = Replayer(key=KEY, device="cpu")
    with pytest.raises(A.TopologyMismatchError):
        rp.load(rec.sign_with(KEY).to_bytes())
    assert rp.stats["rejected"] == 1


def test_argument_mismatch_names_the_first_differing_leaf():
    rec = compile_artifact("two", lambda x, y: x + y.sum(),
                           (torch.zeros(4), torch.zeros(2, 3)))
    rp = Replayer(key=KEY, device="cpu")
    rp.load(rec.sign_with(KEY).to_bytes())
    with pytest.raises(ReplayArgumentError,
                       match=r"first mismatch at leaf 1: got float32\[2, 4\]"
                             r", recorded float32\[2, 3\]"):
        rp.execute("two", torch.zeros(4), torch.zeros(2, 4))
    with pytest.raises(ReplayArgumentError, match="2 leaves, got 1"):
        rp.execute("two", torch.zeros(4))


def test_reordered_params_are_refused_on_every_path():
    """A params dict with the recorded keys in another order (two weights
    of one shape, as qwen's q and o projections are) raises before the
    program runs: on the validated call, on the pinned fast path, and
    after warm."""
    def step(p, x):
        return x @ p["wq"] + 2 * (x @ p["wo"])
    p = {"wq": torch.eye(2), "wo": torch.ones(2, 2)}
    rp = Replayer(key=KEY, device="cpu")
    rp.load(compile_artifact("p", step, (p, torch.zeros(1, 2)))
            .sign_with(KEY).to_bytes())
    x = torch.tensor([[1.0, 2.0]])
    swapped = {"wo": p["wq"], "wq": p["wo"]}
    for _ in range(2):
        torch.testing.assert_close(rp.execute("p", p, x), step(p, x))
        with pytest.raises(ReplayArgumentError,
                           match=r"args\[0\]: keys \['wo', 'wq'\], "
                                 r"recorded \['wq', 'wo'\]"):
            rp.execute("p", swapped, x)
        rp.warm("p")
    assert rp.stats["fast_hits"] > 0
    with pytest.raises(ReplayArgumentError, match=r"args\[0\]: got list"):
        rp.execute("p", [p["wq"], p["wo"]], x)


def test_fast_path_pin_and_stats_equal_the_reference():
    """The same call sequence on both replayers: one validated call pins
    the sole variant, a second variant under the name drops the pin, and
    warm runs every variant; the counters agree."""
    ports, refs = Replayer(key=KEY, device="cpu"), JaxReplayer(key=KEY)
    blobs = {}
    for n in (4, 8):
        blobs[n] = (_recorded(n).sign_with(KEY).to_bytes(),
                    jax_compile("t", _jax_fn, (jax.ShapeDtypeStruct(
                        (n,), jnp.float32),)).sign_with(KEY).to_bytes())

    def both(fn):
        return fn(ports, torch), fn(refs, jnp)

    both(lambda rp, _: rp.load(blobs[4][0 if rp is ports else 1]))
    for _ in range(3):
        got, want = both(lambda rp, xp: rp.execute("t", xp.ones(4)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert "t" in ports._fast
    both(lambda rp, _: rp.load(blobs[8][0 if rp is ports else 1]))
    assert "t" not in ports._fast
    for n in (4, 8, 4):
        both(lambda rp, xp: rp.execute("t", xp.ones(n)))
    with pytest.raises(ReplayArgumentError):
        ports.manifest("t")
    assert ports.manifest("t", (((8,), "float32"),))["inputs"][0]["shape"] == [8]
    both(lambda rp, _: rp.warm("t"))
    assert {k: ports.stats[k] for k in refs.stats} == refs.stats
    assert ports.stats["graph_replays"] == 0 and "t" in ports
    assert ports.preload([]) == []


def test_replayer_is_minimal():
    """The replayer imports no model, config, training or serving code."""
    import repro_torch.core.replay as rp
    src = open(rp.__file__).read()
    for forbidden in ("repro_torch.models", "repro_torch.configs",
                      "repro_torch.training", "repro_torch.serving"):
        assert forbidden not in src


def test_a_step_that_closes_over_tensors_is_refused():
    w = torch.ones(4)
    with pytest.raises(ValueError, match="closes over tensors"):
        compile_artifact("c", lambda x: x * w, (torch.zeros(4),))


# ------------------------------------------------------- end to end ----
def _jax_and_port(arch):
    jcfg = jax_smoke_shrink(jax_get_config(arch), dtype="float32")
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _prompts(vocab, n=3, seed=7):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(3, vocab, SEQ))) for _ in range(n)]


def _serve(eng, prompts, max_new=10):
    for p in prompts:
        eng.submit(p, max_new)
    outs = eng.run()
    return outs, {k: eng.stats.get(k, 0) for k in STATS}


@pytest.fixture(scope="module", params=["cody-mnist", "qwen2.5-3b"])
def recorded(request, tmp_path_factory):
    arch = request.param
    jcfg, cfg, jp, tp = _jax_and_port(arch)
    d = str(tmp_path_factory.mktemp(f"recs-{arch}"))
    recs = record_cli.record_kinds(cfg, out=d, key=KEY, cache_len=CACHE_LEN,
                                   block_k=BLOCK_K, batch=N_SLOTS, seq=SEQ,
                                   params=tp, device="cpu")
    return arch, jcfg, cfg, jp, tp, d, recs


def test_recordings_carry_no_parameter(recorded, monkeypatch):
    """No weight in the payload, though the params served as the export's
    example inputs: no parameter's bytes occur in it, the program's
    state_dict and constants are empty, every param is an input, and it
    loads without full unpickling (torch.load's weights_only=False
    fallback and pickle.loads fail here)."""
    _, _, cfg, _, tp, d, recs = recorded
    real_load = torch.load

    def weights_only(*a, **k):
        assert k.get("weights_only", True), "weights_only=False fallback"
        return real_load(*a, **k)
    monkeypatch.setattr(torch, "load", weights_only)
    monkeypatch.setattr(pickle, "loads", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("pickle.loads reached")))
    n_params = sum(1 for _ in tp.parameters())
    for kind, (path, rec) in recs.items():
        ep = torch.export.load(io.BytesIO(rec.payload))
        assert ep.state_dict == {} and ep.constants == {}, kind
        assert len(rec.manifest["inputs"]) > n_params
        for name, p in tp.named_parameters():
            if p.numel() >= 64:
                assert p.detach().numpy().tobytes() not in rec.payload, name
        # nor the recorder's source paths: the bytes do not depend on
        # where the checkout lives
        assert str(ROOT).encode() not in rec.payload
        assert rec.manifest["static"]["backend"] == "torch"
        assert rec.manifest["torch_version"] == torch.__version__
        assert rec.manifest["static"] == dict(static_meta_for(
            kind, cache_len=CACHE_LEN, block_k=BLOCK_K,
            batch=1 if kind == "prefill" else N_SLOTS, seq=SEQ),
            backend="torch")
        assert rec.manifest["donate"] == ([3] if kind == "decode" else [])
        Replayer(key=KEY, device="cpu").load(path)


def test_prefill_logits_bitwise_equal_live(recorded):
    _, _, cfg, _, tp, d, _ = recorded
    rp = Replayer(key=KEY, device="cpu")
    pre = rp.load(os.path.join(d, recording_name(cfg.name, "prefill")))
    batch = {"tokens": torch.as_tensor([_prompts(cfg.vocab_size, 1)[0]],
                                       dtype=torch.int32)}
    tree = L.to_tree(tp)
    want, want_c = ST.make_prefill_step(cfg, CACHE_LEN)(tree, batch)
    got, got_c = rp.execute(pre, tree, batch)
    assert torch.equal(got["last_logits"], want["last_logits"])
    assert torch.equal(got["next_tokens"], want["next_tokens"])
    for a, b in zip(torch.utils._pytree.tree_leaves(got_c),
                    torch.utils._pytree.tree_leaves(want_c)):
        assert torch.equal(a, b)


def test_decode_block_replays_in_place_on_separate_caches(recorded):
    """Live and replay start from separate copies of the same caches;
    the replay updates its caches in place and returns them."""
    _, _, cfg, _, tp, d, _ = recorded
    rp = Replayer(key=KEY, device="cpu")
    dec = rp.load(os.path.join(d, recording_name(cfg.name, "decode")))
    g = torch.Generator().manual_seed(3)
    caches = M.init_cache(cfg, N_SLOTS, CACHE_LEN, device="cpu")
    for leaf in torch.utils._pytree.tree_leaves(caches):
        leaf.normal_(generator=g)
    mine = copy.deepcopy(caches)
    toks = torch.tensor([5, 9], dtype=torch.int32)
    pos = torch.tensor([3, 6], dtype=torch.int32)
    tree = L.to_tree(tp)
    want, want_c = ST.make_fused_decode_step(cfg, k=BLOCK_K)(
        tree, toks, pos, caches)
    got, got_c = rp.execute(dec, tree, toks, pos, mine)
    for k in ("tokens", "pos", "done"):
        assert torch.equal(got[k], want[k]), k
    for a, b, c in zip(torch.utils._pytree.tree_leaves(got_c),
                       torch.utils._pytree.tree_leaves(want_c),
                       torch.utils._pytree.tree_leaves(mine)):
        assert a is c and torch.equal(a, b)


def test_replay_engine_equals_live_and_the_jax_replay_engine(recorded):
    arch, jcfg, cfg, jp, tp, d, _ = recorded
    prompts = _prompts(cfg.vocab_size)
    live = serve.build_engine(cfg, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                              block_k=BLOCK_K, params=tp, device="cpu")
    replay = serve.build_engine(cfg, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                                block_k=BLOCK_K, params=tp, device="cpu",
                                recordings_dir=d, key=KEY)
    assert isinstance(replay.channel, ReplayChannel)
    assert replay.fixed_prompt_len == SEQ and live.fixed_prompt_len is None
    want, want_st = _serve(live, prompts)
    got, got_st = _serve(replay, prompts)
    # live admits the prompts in one batched prefill, replay one by one
    assert got == want
    assert {k: v for k, v in got_st.items() if k != "prefill_dispatches"} \
        == {k: v for k, v in want_st.items() if k != "prefill_dispatches"}
    assert got_st["prefill_dispatches"] == len(prompts)
    rstats = replay.channel.replayer.stats
    assert rstats["executions"] == 1 + got_st["prefill_dispatches"] + \
        got_st["blocks_dispatched"]        # warm, then every dispatch

    # the JAX package's flat-file replay on the same params
    ws = Workspace(key=KEY)
    wl = ws.workload(jcfg, cache_len=CACHE_LEN, block_k=BLOCK_K,
                     batch=N_SLOTS, prefill_batch=1, seq=SEQ)
    with tempfile.TemporaryDirectory() as jd:
        for kind in ("prefill", "decode"):
            wl.compile(kind).save(os.path.join(
                jd, recording_name(jcfg.name, kind)), KEY)
        jeng = wl.engine(params=jp, recordings_dir=jd)
        jwant, jst = _serve(jeng, prompts)
    assert got == jwant
    assert got_st["host_syncs"] == jst["host_syncs"]


def test_billed_live_and_replay_channels_log_the_same(recorded):
    """Every dispatch billed to an emulated wifi link: a live and a
    replay channel give the same tokens, host syncs, billing log and
    netem totals (the reference's "identical across live and replay
    channels"); the launcher's sessions annotated both recordings."""
    _, _, cfg, _, tp, d, recs = recorded
    for _path, rec in recs.values():
        rs = rec.manifest["record_session"]
        assert rs["net"] == "local" and rs["jobs"] > 0
        assert rec.manifest["record_virtual_s"] == rs["virtual_time_s"]
    rp = Replayer(key=KEY, device="cpu")
    pre, dec = (rp.load(os.path.join(d, recording_name(cfg.name, kind)))
                for kind in ("prefill", "decode"))
    kw = serve.stream_kwargs(cfg, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                             block_k=BLOCK_K, eos_id=2, device="cpu")
    runs = []
    for inner, params in (
            (LiveChannel(ST.make_prefill_step(cfg, CACHE_LEN),
                         ST.make_fused_decode_step(cfg, k=BLOCK_K)), tp),
            (ReplayChannel(rp, pre, dec), L.to_tree(tp))):
        em = NetworkEmulator(WIFI)
        eng = Engine(params, channel=NetemBilledChannel(inner, em),
                     netem=em, **kw)
        outs, st = _serve(eng, _prompts(cfg.vocab_size))
        runs.append((outs, st, eng.channel.log, em.snapshot()))
    assert runs[0] == runs[1]
    assert runs[0][2] and runs[0][3]["async_trips"] >= len(runs[0][2])


def test_launchers_round_trip_on_the_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        done = record_cli.main(["--arch", "cody-mnist", "--smoke",
                                "--device", "cpu", "--out", d, "--key", "k2",
                                "--cache-len", "32", "--block-k", "4",
                                "--batch", "2", "--seq", "8"])
        assert sorted(done) == ["decode", "prefill"]
        # the flat files, and the registry the launcher publishes into by
        # default (as the reference's does)
        assert sorted(os.listdir(d)) == ["cody-mnist_decode.codyrec",
                                         "cody-mnist_prefill.codyrec",
                                         "registry"]
        outs, eng = serve.main(["--arch", "cody-mnist", "--smoke",
                                "--device", "cpu", "--requests", "3",
                                "--max-new", "6", "--slots", "2",
                                "--cache-len", "32", "--block-k", "4",
                                "--from-recordings", d, "--key", "k2"])
        assert len(outs) == 3 and all(len(v) <= 6 for v in outs.values())
        assert eng.channel.kind == "signed-replay"
        with pytest.raises(A.TamperedRecordingError):
            serve.main(["--arch", "cody-mnist", "--smoke", "--device", "cpu",
                        "--cache-len", "32", "--block-k", "4", "--slots",
                        "2", "--from-recordings", d, "--key", "wrong"])
    out = capsys.readouterr().out
    assert "recorded decode" in out and "signed-replay channel" in out


def test_build_step_takes_the_params_tree_or_zeros():
    cfg = smoke_shrink(get_config("cody-mnist"), dtype="float32")
    fn, args, donate = build_step(cfg, "decode", cache_len=16, block_k=2,
                                  batch=2, device="cpu")
    assert donate == (3,) and args[1].dtype == torch.int32
    leaves = torch.utils._pytree.tree_leaves(args[0])
    assert leaves and all(not x.any() for x in leaves)
    tp = M.init_params(cfg, seed=0, device="cpu")
    _, args2, donate2 = build_step(cfg, "prefill", cache_len=16, seq=5,
                                   params=tp, device="cpu")
    assert donate2 == () and args2[1]["tokens"].shape == (1, 5)
    assert torch.utils._pytree.tree_structure(args2[0]) == \
        torch.utils._pytree.tree_structure(args[0])
