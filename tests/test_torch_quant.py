"""Int8 serving in the port against the JAX reference, on the CPU at smoke
size: int8 weights (``serving/quant.py``: ``quantize_params``,
``dequantize``, ``abstract_quantized``, ``quantized_axes``) bit for bit
on the same numpy-seeded weights, a quantized tree carried over by
``params_from_jax``, prefill + decode with int8 weights and int8 KV caches
close to the reference's for the dense, sliding-window, hybrid and audio
families, the reference's own accuracy bounds in the port, the decode
kernel's int8 form (its plain version and its split algorithm), and the
int8 model served, recorded and replayed.

The widths are the smoke configs' with d_model 128, d_ff 256 and head_dim
32, so that the attention and MLP weights pass ``QUANT_MIN_SIZE`` (2^14
elements) and some leaves stay bf16."""
import dataclasses
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import quant as JQ  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.api.workload import recording_name  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core.replay import ReplayArgumentError, Replayer  # noqa: E402
from repro_torch.launch import record as record_cli  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402
from repro_torch.serving import quant as TQ  # noqa: E402
from repro_torch.serving.cache import cache_leaves  # noqa: E402

WIDE = dict(d_model=128, d_ff=256, head_dim=32)
# int8 weights and caches served in bf16 against the reference: the
# largest |logit| difference over the largest |logit| (the kernels' bf16
# tolerance, K.TOLERANCE[bfloat16])
BF16_REL = 2e-2
CACHE_LEN = 48
KEY = b"quant-test-key"
DA = importlib.import_module("repro_torch.kernels.decode_attention")
jax_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
jax_decode_step = jax.jit(JM.decode_step, static_argnums=(1,))


def _cfgs(arch, **over):
    return (jax_smoke_shrink(jax_get_config(arch), **over),
            smoke_shrink(get_config(arch), **over))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """(leaves, spec) of a ParamTree or nested dicts/lists."""
    if isinstance(tree, torch.nn.Module):
        tree = L.to_tree(tree)
    return pytree.tree_flatten(tree)


@pytest.fixture(scope="module", params=["qwen2.5-3b", "deepseek-v2-lite-16b",
                                        "zamba2-1.2b", "whisper-large-v3"])
def quantized(request):
    """(jcfg, cfg, reference bf16 params, reference quantized params,
    the port's bf16 params carried over, the reference's quantized tree
    carried over)."""
    over = dict(WIDE)
    if request.param == "deepseek-v2-lite-16b":
        # 16 experts: the reference names the expert axes as the port's
        # schema does from 16 up (its "expert" shard mode; below 16 it
        # shards the ffn axis, which the port has not ported)
        moe = jax_smoke_shrink(jax_get_config(request.param)).moe
        over["moe"] = dataclasses.replace(moe, num_experts=16)
    jcfg, cfg = _cfgs(request.param, **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jq = JQ.quantize_params(jp)
    tp = params_from_jax(cfg, _np_tree(jp), device="cpu")
    tq_ref = params_from_jax(cfg, _np_tree(jq), device="cpu")
    return jcfg, cfg, jp, jq, tp, tq_ref


def test_quantize_params_equals_the_reference(quantized):
    """The port's int8 values and scales equal the reference's bit for bit,
    leaf for leaf; deepseek's expert weights are 3-D."""
    jcfg, cfg, jp, jq, tp, tq_ref = quantized
    got, spec = _flat(TQ.quantize_params(tp))
    want, want_spec = _flat(tq_ref)
    assert spec == want_spec
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    int8 = [a for a in got if a.dtype == torch.int8]
    assert int8 and any(a.dtype == torch.bfloat16 for a in got)
    if cfg.moe is not None:
        assert any(a.dim() == 3 for a in int8)
    n_ref = sum(isinstance(x, dict) and set(x) == {"q", "s"} for x in
                jax.tree.leaves(jq, is_leaf=lambda x: isinstance(x, dict)
                                and set(x) == {"q", "s"}))
    assert n_ref > 0
    # a quantized tree is left as it is; a dict tree gives a dict tree
    again, _ = _flat(TQ.quantize_params(TQ.quantize_params(tp)))
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert isinstance(TQ.quantize_params(L.to_tree(tp)), dict)


def test_params_from_jax_carries_a_quantized_tree(quantized):
    jcfg, cfg, jp, jq, tp, tq_ref = quantized
    blk, jblk = tq_ref["stages"][-1][-1], jq["stages"][-1]
    leaf = "attn" if "attn" in blk else "mambas"
    q = blk["attn"]["wq"] if leaf == "attn" else \
        blk["mambas"][-1]["mamba"]["w_z"]
    jleaf = jblk["attn"]["wq"] if leaf == "attn" else \
        jblk["mambas"]["mamba"]["w_z"]
    assert q["q"].dtype == torch.int8 and q["s"].dtype == torch.float32
    n = len(tq_ref["stages"][-1])
    idx = (n - 1,) if n > 1 else ()
    if leaf == "mambas":
        idx += (len(blk["mambas"]) - 1,)
    np.testing.assert_array_equal(q["q"].numpy(), np.asarray(jleaf["q"])[idx])
    np.testing.assert_array_equal(q["s"].numpy(), np.asarray(jleaf["s"])[idx])


def test_dequantize_equals_the_reference(quantized):
    jcfg, cfg, jp, jq, tp, tq_ref = quantized
    got, spec = _flat(TQ.dequantize(tq_ref))
    want, want_spec = _flat(params_from_jax(
        cfg, _np_tree(JQ.dequantize(jq)), device="cpu"))
    assert spec == want_spec
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _unstacked_axes(schema, ref, n_stacks=0):
    """The reference's (quantized) axes tree in the port's structure: each
    list of the port's schema is a stack of the reference's (unless it
    holds one block), whose leading "stack" axis is dropped."""
    if isinstance(schema, ParamSpec):
        strip = lambda ax: ax[n_stacks:]
        if isinstance(ref, dict):
            assert all(ax[:n_stacks] == ("stack",) * n_stacks
                       for ax in ref.values()), ref
            return {k: strip(ax) for k, ax in ref.items()}
        assert ref[:n_stacks] == ("stack",) * n_stacks, ref
        return strip(ref)
    if isinstance(schema, list):
        return [_unstacked_axes(s, ref, n_stacks + (len(schema) > 1))
                for s in schema]
    if "stages" in schema:
        return {k: [_unstacked_axes(s, r) for s, r in zip(schema[k], ref[k])]
                if k == "stages" else _unstacked_axes(schema[k], ref[k])
                for k in schema}
    return {k: _unstacked_axes(s, ref[k], n_stacks)
            for k, s in schema.items()}


def test_abstract_quantized_and_axes_equal_the_reference(quantized):
    """The abstract quantized tree has the quantized tree's shapes and
    dtypes (as meta tensors), and its axes are the reference's less the
    stack axes the port does not keep."""
    jcfg, cfg, jp, jq, tp, tq_ref = quantized
    ab = TQ.abstract_quantized(TM.abstract_params(cfg))
    got, spec = pytree.tree_flatten(ab)
    want, want_spec = _flat(tq_ref)
    assert spec == want_spec
    assert all(a.device.type == "meta" and a.shape == b.shape
               and a.dtype == b.dtype for a, b in zip(got, want))
    axes = TQ.quantized_axes(TM.param_axes(cfg), TM.abstract_params(cfg))
    jaxes = JQ.quantized_axes(JM.param_axes(jcfg), JM.abstract_params(jcfg))
    assert axes == _unstacked_axes(TM.model_schema(cfg), jaxes)


def _frames(cfg, B, seed=3):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, cfg.encdec.encoder_seq, cfg.d_model))
    return f.astype(np.float32)


@pytest.mark.parametrize("arch,plen,tol", [
    ("qwen2.5-3b", 13, BF16_REL),          # dense
    ("starcoder2-7b", 40, BF16_REL),       # sliding window 32: the ring wraps
    # hybrid, the shared block's attention: the bf16 model without int8
    # already differs from the reference by up to 2.9e-2 of its largest
    # logit at these seeds (its Mamba2 blocks run in bf16 in another order)
    ("zamba2-1.2b", 13, 2 * BF16_REL),
    ("whisper-large-v3", 13, BF16_REL),    # audio: the decoder's self-cache
])
def test_int8_weights_and_caches_close_to_the_reference(arch, plen, tol):
    """Prefill + 6 decode steps in bf16 with int8 weights and int8 caches,
    the same tokens fed to both (the reference's greedy ones): every step's
    logits within ``tol`` of the reference's largest."""
    jcfg, cfg = _cfgs(arch, kv_quant=True, **WIDE)
    jq = JQ.quantize_params(JM.init_params(jcfg, jax.random.PRNGKey(2)))
    tq = params_from_jax(cfg, _np_tree(jq), device="cpu")
    assert any(a.dtype == torch.int8 for a in _flat(tq)[0])
    B = 2
    toks = np.random.default_rng(4).integers(3, cfg.vocab_size, (B, plen),
                                             dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "audio":
        f = _frames(cfg, B)
        jb["frames"] = jnp.asarray(f).astype(jnp.bfloat16)
        tb["frames"] = torch.from_numpy(f).to(torch.bfloat16)

    def rel(t, j):
        j = np.asarray(j, np.float32)
        return np.abs(t.float().numpy() - j).max() / np.abs(j).max()
    jl, jc = jax_prefill(jq, jcfg, jb, CACHE_LEN)
    tl, tc = TM.prefill(tq, cfg, tb, CACHE_LEN)
    errs = [rel(tl, jl)]
    assert any(c.dtype == torch.int8 for c in cache_leaves(tc))
    assert [tuple(c.shape) for c in cache_leaves(tc)] == \
        [tuple(c.shape) for c in jax.tree.leaves(jc)]
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for step in range(6):
        pos = np.full(B, plen + step, np.int32)
        jl, jc = jax_decode_step(jq, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                                 jc)
        tl, tc = TM.decode_step(tq, cfg, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc)
        errs.append(rel(tl, jl))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert max(errs) < tol, errs


@pytest.mark.parametrize("over", [{}, WIDE])
def test_reference_bounds_hold_in_the_port(over):
    """``tests/test_models.py``'s bounds, in the port: an int8 KV cache
    stays within 10% of bf16 attention (qwen2-72b), int8 weights within
    15% (qwen2.5-3b)."""
    cfg = smoke_shrink(get_config("qwen2-72b"), **over)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    params = TM.init_params(cfg, seed=1, device="cpu")
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S + 1), dtype=np.int32))
    ref = TM.forward(params, cfg, {"tokens": toks})[0][:, S].float()
    _, caches = TM.prefill(params, cfgq, {"tokens": toks[:, :S]}, 64)
    got, _ = TM.decode_step(params, cfgq, toks[:, S],
                            torch.full((B,), S, dtype=torch.int32), caches)
    rel = (ref - got.float()).abs().max() / (ref.abs().max() + 1e-9)
    assert rel < 0.1, rel

    cfg = smoke_shrink(get_config("qwen2.5-3b"), **over)
    params = TM.init_params(cfg, seed=1, device="cpu")
    pq = TQ.quantize_params(params)
    assert TQ.has_quantized(pq) and not TQ.has_quantized(params)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 16), dtype=np.int32))
    ref = TM.forward(params, cfg, {"tokens": toks})[0].float()
    got = TM.forward(pq, cfg, {"tokens": toks})[0].float()
    rel = (ref - got).abs().max() / (ref.abs().max() + 1e-9)
    assert rel < 0.15, rel


def _int8_caches(B, W, Hkv, hd, seed):
    g = torch.Generator().manual_seed(seed)
    kq, ks = L.kv_quantize(torch.randn(B, W, Hkv, hd, generator=g))
    vq, vs = L.kv_quantize(torch.randn(B, W, Hkv, hd, generator=g))
    return kq, vq, ks, vs


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("B,H,Hkv,W,hd", [(2, 4, 2, 40, 16), (3, 9, 1, 64, 32),
                                          (2, 6, 2, 96, 64)])
def test_decode_attention_int8_equals_the_reference(B, H, Hkv, W, hd, window):
    """The int8 form's op (its plain version on the CPU) against the
    reference's ``decode_attention`` with k_scale / v_scale in fp32, over
    the dense cache and the ring (lengths clamped to W, as
    ``layers.decode_attention`` does); the planted fault (V scales
    ignored) fails the check."""
    if window:
        W = window
    kq, vq, ks, vs = _int8_caches(B, W, Hkv, hd, seed=B + W)
    q = torch.randn(B, H, hd, generator=torch.Generator().manual_seed(W))
    pos = torch.tensor([W - 1, W // 3, W + 17][:B], dtype=torch.int32)
    if not window:
        pos = pos.clamp_max(W - 1)
    want = JL.decode_attention(
        jnp.asarray(q.numpy())[:, None], jnp.asarray(kq.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(pos.numpy()), window=window,
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    want = np.asarray(want)[:, 0]
    got = L.decode_attention(q[:, None], kq, vq, pos, window=window,
                             k_scale=ks, v_scale=vs)[:, 0]
    tol = K.TOLERANCE[torch.float32]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    lengths = (pos + 1).clamp_max(W)
    fault = K.decode_attention_int8(q, kq, vq, lengths, ks,
                                    torch.ones_like(vs))
    assert not np.allclose(fault.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [32, 64])
def test_split_algorithm_int8_equals_plain(chunk):
    """The kernel's algorithm with int8 caches (each split's partial with
    its K scales in the scores and ``p * v_scale`` on V, ``l`` unscaled,
    merged in split order) equals the plain version, and a merge whose l
    carried the V scales would not."""
    B, H, Hkv, W, hd = 3, 8, 2, 128, 32
    kq, vq, ks, vs = _int8_caches(B, W, Hkv, hd, seed=7)
    q = torch.randn(B, H, hd, generator=torch.Generator().manual_seed(8))
    lengths = torch.tensor([128, 33, 70], dtype=torch.int32)
    plan = DA.SplitPlan(-(-W // chunk), chunk)
    want = K.decode_attention_plain(q, kq, vq, lengths, k_scale=ks,
                                    v_scale=vs)
    got = DA.decode_attention_split(q, kq, vq, lengths, plan, k_scale=ks,
                                    v_scale=vs)
    tol = K.TOLERANCE[torch.float32]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    # the V scales folded into V before the product: the same function
    vf = vq.float() * vs
    same = DA.decode_attention_split(q, kq, vf, lengths, plan, k_scale=ks)
    torch.testing.assert_close(same, want, atol=tol, rtol=tol)


def _served(cfg, params, speculate):
    eng = serve.build_engine(cfg, n_slots=2, cache_len=64, block_k=4,
                             params=params, device="cpu", speculate=speculate)
    rng = np.random.default_rng(9)
    for n in (5, 9, 13, 7):
        eng.submit(list(map(int, rng.integers(3, cfg.vocab_size, n))), 20)
    return eng.run(), dict(eng.stats)


def test_engine_over_the_int8_tree_spec_equals_sync():
    """The Engine serves the quantized tree with int8 caches; speculative
    and synchronous runs give the same tokens."""
    cfg = smoke_shrink(get_config("qwen2.5-3b"), kv_quant=True, **WIDE)
    pq = TQ.quantize_params(TM.init_params(cfg, seed=0, device="cpu"))
    spec, st_spec = _served(cfg, pq, True)
    sync, st_sync = _served(cfg, pq, False)
    assert spec == sync
    assert st_spec.get("spec_blocks", 0) > 0, st_spec
    assert st_sync.get("spec_blocks", 0) == 0, st_sync
    assert all(1 <= len(t) <= 20 for t in spec.values())


def test_record_replay_of_the_int8_step(tmp_path):
    """The int8 step recorded with the quantized tree and int8 caches as
    inputs, signed, verified and replayed through the Engine gives the
    live tokens; the recording refuses a bf16 tree."""
    cfg = smoke_shrink(get_config("qwen2.5-3b"), kv_quant=True, **WIDE)
    params = TM.init_params(cfg, seed=0, device="cpu")
    pq = TQ.quantize_params(params)
    d = str(tmp_path)
    recs = record_cli.record_kinds(cfg, out=d, key=KEY, cache_len=64,
                                   block_k=4, batch=2, seq=8, params=pq,
                                   device="cpu")
    dtypes = {i["dtype"] for i in recs["decode"][1].manifest["inputs"]}
    assert {"int8", "float32", "bfloat16"} <= dtypes, dtypes
    # replay pins the prompt length to the recorded prefill's seq
    eng = serve.build_engine(cfg, n_slots=2, cache_len=64, block_k=4,
                             params=pq, device="cpu", recordings_dir=d,
                             key=KEY)
    assert eng.channel.kind == "signed-replay"
    live_eng = serve.build_engine(cfg, n_slots=2, cache_len=64, block_k=4,
                                  params=pq, device="cpu")
    rng = np.random.default_rng(10)
    prompts = [list(map(int, rng.integers(3, cfg.vocab_size, 8)))
               for _ in range(3)]
    outs = []
    for e in (live_eng, eng):
        for p in prompts:
            e.submit(p, 10)
        outs.append(e.run())
    assert outs[0] == outs[1]

    rp = Replayer(key=KEY, device="cpu")
    dec = rp.load(os.path.join(d, recording_name(cfg.name, "decode")))
    zeros = torch.zeros(2, dtype=torch.int32)
    caches = TM.init_cache(cfg, 2, 64, device="cpu")
    rp.execute(dec, L.to_tree(pq), zeros, zeros.clone(), caches)
    with pytest.raises(ReplayArgumentError):
        rp.execute(dec, L.to_tree(params), zeros, zeros.clone(),
                   TM.init_cache(cfg, 2, 64, device="cpu"))
