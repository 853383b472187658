"""The port's per-rank cost analysis (``analysis/cost.py``), its H100
roofline (``analysis/roofline.py``) and its shape cells
(``configs/common.py``) against the reference's ``analysis/hlo.py``,
``analysis/roofline.py`` and ``configs/common.py``, on the CPU.

The multi-rank counts (DTensor over a fake process group) and the dry-run
launcher are ``test_torch_dryrun.py``."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.tree_util import keystr as jkeystr  # noqa: E402
from jax.tree_util import tree_flatten_with_path as jflat  # noqa: E402
from torch.utils._pytree import keystr as tkeystr  # noqa: E402
from torch.utils._pytree import tree_flatten_with_path as tflat  # noqa: E402

from repro.analysis import hlo as JH  # noqa: E402
from repro.analysis import roofline as JR  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import cell_applicable as j_cell_applicable  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.configs import smoke_shrink as j_smoke_shrink  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import steps as JST  # noqa: E402
from repro_torch.analysis import cost as C  # noqa: E402
from repro_torch.analysis import roofline as RF  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, cell_applicable,  # noqa: E402
                                 get_config, input_specs, smoke_shrink)
from repro_torch.core.recorder import compile_artifact  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import steps as ST  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard
    library at its top): its kernels phase's byte and operation counts
    are the closed forms the scans' formulas are held to."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------- copies of the reference --
@pytest.mark.parametrize("n", (1, 2, 4, 16))
@pytest.mark.parametrize("kind", C.COLLECTIVES)
def test_wire_bytes_equal_the_reference(kind, n):
    assert C.COLLECTIVES == JH.COLLECTIVES
    for in_b, out_b in ((1000.0, 3000.0), (4096.0, 256.0), (0.0, 8.0)):
        assert C._wire_bytes(kind, in_b, out_b, n) == \
            JH._wire_bytes(kind, in_b, out_b, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for cell in SHAPES.values():
        for kind in KINDS:
            assert RF.analytic_model_flops(cfg, kind, cell.batch, cell.seq) \
                == JR.analytic_model_flops(jcfg, kind, cell.batch, cell.seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_cell_applicable_equal_the_reference(arch):
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}
    for shape in SHAPES:
        assert cell_applicable(get_config(arch), shape) == \
            j_cell_applicable(jget_config(arch), shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    """Leaf for leaf by key path (the port's caches keep the reference's
    layout), shapes and dtypes; meta tensors, nothing allocated."""
    for shape in SHAPES:
        want = {jkeystr(p): (tuple(v.shape), str(v.dtype))
                for p, v in jflat(j_input_specs(jget_config(arch), shape))[0]}
        got = {tkeystr(p): (tuple(v.shape),
                            str(v.dtype).removeprefix("torch."))
               for p, v in tflat(input_specs(get_config(arch), shape))[0]}
        assert got == want, (arch, shape)
        assert all(v.device.type == "meta" for v in
                   torch.utils._pytree.tree_leaves(
                       input_specs(get_config(arch), shape)))


def test_roofline_equals_the_reference_at_its_constants(monkeypatch):
    """The same cost dict gives the reference's ``as_dict`` once its
    three constants are substituted (every flop at one peak, one link
    level); at the H100's own, an fp32 step is priced at the fp32 peak."""
    cost = {"flops": 3.2e15, "hbm_bytes": 7.5e11, "coll_bytes": 4.2e10}
    want = JR.from_hlo(cost, 1.1e18, 256).as_dict()
    at_h100 = RF.from_hlo(cost, 1.1e18, 256)
    monkeypatch.setattr(RF, "PEAK_OPS_S", {"bfloat16": JR.PEAK_FLOPS})
    monkeypatch.setattr(RF, "PEAK_FLOPS", JR.PEAK_FLOPS)
    monkeypatch.setattr(RF, "HBM_BW", JR.HBM_BW)
    monkeypatch.setattr(RF, "LINK_BW", {"network": JR.ICI_BW})
    assert RF.from_hlo(cost, 1.1e18, 256).as_dict() == want
    manifest = {"cost": {"flops": 2e12, "bytes accessed": 3e9}}
    assert RF.from_recording_manifest(manifest, 1e12).as_dict() == \
        JR.from_recording_manifest(manifest, 1e12).as_dict()
    monkeypatch.undo()
    assert at_h100.t_compute == 3.2e15 / 989e12
    assert at_h100.t_memory == 7.5e11 / 3.35e12
    assert at_h100.t_collective == 4.2e10 / 50e9
    fp32 = RF.from_hlo(dict(cost, flops_by_dtype={"float32": 3.2e15},
                            coll_by_link={"nvlink": 4.2e10}), 1.1e18, 256)
    assert fp32.t_compute == 3.2e15 / 67e12
    assert fp32.t_collective == 4.2e10 / 450e9
    assert RF.link_of(range(8)) == "nvlink"
    assert RF.link_of(range(0, 256, 16)) == "network"


# ------------------------------------------------------------ dispatched --
def test_matmul_stack_flops_equal_the_reference_scan():
    """The counterpart of ``test_analyzer_scan_equals_unrolled_flops``:
    the port's loop over 4 layers counts what the reference counts of
    its ``lax.scan`` over the same layers (trip count corrected)."""
    Ln, D, B = 4, 64, 32

    def f_scan(ws, x):
        h, _ = jax.lax.scan(lambda h, w: (jnp.dot(h, w), ()), x, ws)
        return h.sum()
    ws = jax.ShapeDtypeStruct((Ln, D, D), jnp.float32)
    x = jax.ShapeDtypeStruct((B, D), jnp.float32)
    ref = JH.analyze(jax.jit(f_scan).lower(ws, x).compile().as_text())

    def f(ws, x):
        for w in ws:
            x = x @ w
        return x.sum()
    got = C.analyze(f, (list(torch.randn(Ln, D, D)), torch.randn(B, D)))
    assert got["flops"] == ref["flops"] == Ln * 2 * B * D * D
    assert got["flops_by_dtype"] == {"float32": Ln * 2 * B * D * D}


def _smoke_params(cfg):
    return L.to_tree(M.init_params(cfg, seed=0, device="cpu"))


def test_smoke_prefill_counts_the_reference_products():
    """qwen2.5-3b smoke prefill (B 2, S 64): the reference's HLO counts
    the dense attention products (2 · 2·B·H·S²·hd · L) where the port's
    kernel is a custom op; less those, and less the custom ops' own
    count, the two agree to the flop: 27,262,976 − 4,194,304 =
    23,068,672.  The flash op counts the causal pairs only."""
    B, S = 2, 64
    jcfg = j_smoke_shrink(jget_config("qwen2.5-3b"))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    ref = JH.analyze(jax.jit(JST.make_prefill_step(jcfg, None, cache_len=S))
                     .lower(JM.abstract_params(jcfg), batch).compile()
                     .as_text())
    cfg = smoke_shrink(get_config("qwen2.5-3b"))
    H, hd, Ln = cfg.num_heads, cfg.hd(), cfg.num_layers
    got = C.analyze(ST.make_prefill_step(cfg, cache_len=S),
                    (_smoke_params(cfg),
                     {"tokens": torch.zeros(B, S, dtype=torch.int32)}))
    dense_attn = 2 * 2 * B * H * S * S * hd * Ln
    custom = {k: v["flops"] for k, v in got["custom_ops"].items()}
    assert set(custom) == {"rmsnorm", "flash_attention"}
    assert ref["flops"] == 27_262_976 and dense_attn == 4_194_304
    assert got["flops"] - sum(custom.values()) == \
        ref["flops"] - dense_attn == 23_068_672
    assert custom["flash_attention"] == \
        4 * hd * H * B * Ln * S * (S + 1) // 2


def test_fused_mode_counts_int8_weights_at_their_source():
    """A product whose weight is dequantized on the way in (int8 times a
    per-column scale, as ``serving/quant.py`` stores it) reads the int8
    bytes in the ``"fused"`` mode; the ``"eager"`` mode counts every op's
    tensors, the bf16 copy and the product's operands included."""
    x = torch.randn(4, 64).to(torch.bfloat16)
    q = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    s = torch.rand(1, 32)

    def f(x, q, s):
        return x @ (q.to(torch.bfloat16) * s.to(torch.bfloat16))
    fused = C.analyze(f, (x, q, s), mode="fused")
    eager = C.analyze(f, (x, q, s), mode="eager")
    assert fused["flops"] == eager["flops"] == 2 * 4 * 64 * 32
    assert fused["hbm_bytes"] == 4 * 64 * 2 + 64 * 32 + 4 * 32 * 2
    w, sb = 64 * 32 * 2, 32 * 2
    assert eager["hbm_bytes"] == (64 * 32 + w) + (32 * 4 + sb) + \
        (w + sb + w) + (4 * 64 * 2 + w + 4 * 32 * 2)
    with pytest.raises(ValueError, match="mode"):
        C.Counter(mode="final")


# ------------------------------------------------- custom op closed forms --
def _visible(Sq, Sk, causal, window, off):
    i = np.arange(Sq)[:, None] + off
    j = np.arange(Sk)[None]
    vis = (i >= j) if causal else np.ones((Sq, Sk), bool)
    if window:
        vis &= i - j < window
    return int(vis.sum())


def _meta(*shape, dt=torch.bfloat16):
    return torch.empty(shape, dtype=dt, device="meta")


def _closed_forms():
    """{op: (args, ({dtype: ops}, bytes of the inputs read and the
    outputs written))}, each written out from the shapes."""
    cs = _chip_smoke()
    bf, f32 = torch.bfloat16, torch.float32
    B, Sq, Sk, H, Hkv, hd, hdv, W = 2, 37, 40, 8, 2, 32, 16, 64
    pairs = B * _visible(Sq, Sk, True, 24, Sk - Sq)
    q, k, v = _meta(B, Sq, H, hd), _meta(B, Sk, Hkv, hd), _meta(B, Sk, Hkv, hdv)
    lens = torch.tensor([5, 64, 100], dtype=torch.int32)    # 100 > W: W
    n_valid = 5 + 64 + 64
    qd = _meta(3, H, hd)
    kc, vc = _meta(3, W, Hkv, hd, dt=torch.int8), _meta(3, W, Hkv, hd,
                                                        dt=torch.int8)
    ks, vs = _meta(3, W, Hkv, 1, dt=f32), _meta(3, W, Hkv, 1, dt=f32)
    R, D = 48, 128
    E, Cc, Dm, F = 4, 6, 64, 40
    mamba = dict(B=1, Q=150, nc=2)
    mam = (_meta(1, 2, 150, 64, 64, dt=f32), _meta(1, 2, 150, 64),
           _meta(1, 2, 150, 64), _meta(1, 2, 150, 64, dt=f32))
    mls = (_meta(1, 2, 150, 4, 512), _meta(1, 2, 150, 4, 512),
           _meta(1, 2, 150, 4, 512), _meta(1, 2, 150, 4, dt=f32),
           _meta(1, 2, 150, 4, dt=f32))
    return {
        "rmsnorm": ((_meta(R, D), _meta(D, dt=f32), 1e-5),
                    ({"float32": 4 * R * D}, 2 * R * D * 2 + 4 * D)),
        "rmsnorm_backward": ((_meta(R, D), _meta(D, dt=f32), _meta(R, D),
                              1e-5),
                             ({"float32": 12 * R * D}, 3 * R * D * 2 + 8 * D)),
        "flash_attention": ((q, k, v, True, 24, 0.1, Sk - Sq),
                            ({"bfloat16": 2 * (hd + hdv) * H * pairs},
                             B * (Sq * H * (hd + hdv)
                                  + Sk * Hkv * (hd + hdv)) * 2)),
        "flash_attention_backward": (
            (q, k, v, _meta(B, Sq, H, hdv), _meta(B, Sq, H, hdv), True, 24,
             0.1, Sk - Sq),
            ({"bfloat16": 2 * (3 * hd + 2 * hdv) * H * pairs},
             2 * (Sq * H + Sk * Hkv) * B * (hd + hdv) * 2)),
        "decode_attention": (
            (qd, _meta(3, W, Hkv, hd), _meta(3, W, Hkv, hd), lens, 0.1),
            ({"bfloat16": 4 * hd * H * n_valid},
             (2 * 3 * H * hd + 2 * n_valid * Hkv * hd) * 2 + 4 * 3)),
        "decode_attention_int8": (
            (qd, kc, vc, lens, ks, vs, 0.1),
            ({"bfloat16": 4 * hd * H * n_valid},
             2 * 3 * H * hd * 2 + n_valid * Hkv * (2 * hd + 2 * 4) + 4 * 3)),
        "moe_gmm": ((_meta(E, Cc, Dm), _meta(E, Dm, F)),
                    ({"bfloat16": 2 * E * Cc * Dm * F},
                     (E * Cc * Dm + E * Dm * F + E * Cc * F) * 2)),
        "moe_gmm_backward": (
            (_meta(E, Cc, Dm), _meta(E, Dm, F), _meta(E, Cc, F)),
            ({"bfloat16": 4 * E * Cc * Dm * F},
             (2 * E * Cc * Dm + 2 * E * Dm * F + E * Cc * F) * 2)),
        "mamba_chunk_scan": (
            mam, (cs._scan_ops("mamba", *mamba.values(), 2, 3),
                  cs._scan_bytes("mamba", *mamba.values(), 2))),
        "mamba_chunk_scan_backward": (
            mam + (_meta(1, 2, 150, 64, 64, dt=f32),
                   _meta(1, 64, 64, 64, dt=f32)),
            (cs._scan_backward_ops("mamba", *mamba.values(), 2, 2),
             cs._scan_backward_bytes("mamba", *mamba.values(), 2))),
        "mlstm_chunk_scan": (
            mls, (cs._scan_ops("mlstm", *mamba.values(), 2, 3),
                  cs._scan_bytes("mlstm", *mamba.values(), 2))),
        "mlstm_chunk_scan_backward": (
            mls + (_meta(1, 2, 150, 4, 512, dt=f32),
                   _meta(1, 2, 150, 4, 512, dt=f32),
                   _meta(1, 4, 512, 512, dt=f32), _meta(1, 4, 512, dt=f32)),
            (cs._scan_backward_ops("mlstm", *mamba.values(), 2, 2),
             cs._scan_backward_bytes("mlstm", *mamba.values(), 2))),
    }


# the outputs of each op at the closed forms' shapes (their bytes count)
def _outputs(name, args):
    f32 = torch.float32
    fake = {
        "rmsnorm": lambda x, sc, e: _meta(*x.shape, dt=x.dtype),
        "rmsnorm_backward": lambda x, sc, g, e: (_meta(*x.shape, dt=x.dtype),
                                                 _meta(*sc.shape, dt=f32)),
        "flash_attention": lambda q, k, v, *a: _meta(*q.shape[:-1],
                                                     v.shape[-1]),
        "flash_attention_backward": lambda q, k, v, o, do, *a: (
            _meta(*q.shape), _meta(*k.shape), _meta(*v.shape)),
        "decode_attention": lambda q, *a: _meta(*q.shape),
        "decode_attention_int8": lambda q, *a: _meta(*q.shape),
        "moe_gmm": lambda x, w: _meta(*x.shape[:2], w.shape[2]),
        "moe_gmm_backward": lambda x, w, dy: (_meta(*x.shape),
                                              _meta(*w.shape)),
        "mamba_chunk_scan": lambda xb, Bc, Cc, cum: (
            _meta(*xb.shape, dt=f32), _meta(1, 64, 64, 64, dt=f32)),
        "mamba_chunk_scan_backward": lambda xb, Bc, Cc, cum, dy, ds: (
            _meta(*xb.shape, dt=f32), _meta(*Bc.shape, dt=Bc.dtype),
            _meta(*Cc.shape, dt=Cc.dtype), _meta(*cum.shape, dt=f32)),
        "mlstm_chunk_scan": lambda q, k, v, cf, li: (
            _meta(*q.shape, dt=f32), _meta(1, 4, 512, 512, dt=f32),
            _meta(1, 4, 512, dt=f32)),
        "mlstm_chunk_scan_backward": lambda q, k, v, cf, li, *a: (
            _meta(*q.shape), _meta(*k.shape), _meta(*v.shape),
            _meta(*cf.shape, dt=f32), _meta(*li.shape, dt=f32)),
    }
    return fake[name](*args)


def test_every_custom_op_has_a_formula():
    assert set(C.CUSTOM) == {
        n for n in dir(torch.ops.repro_torch)
        if isinstance(getattr(torch.ops.repro_torch, n),
                      torch._ops.OpOverloadPacket)} == set(_closed_forms())
    assert len(C.CUSTOM) == 12


@pytest.mark.parametrize("name", sorted(C.CUSTOM))
def test_custom_op_formula_matches_its_closed_form(name):
    """Each formula against the closed form written from its shapes (the
    scans' against ``chip_smoke.py``'s ``_scan_*`` counts at zamba2's and
    xlstm's widths); a decode counts each row's lengths, at most W."""
    args, (ops, nbytes) = _closed_forms()[name]
    func = getattr(torch.ops.repro_torch, name).default
    got_ops, got_bytes = C.custom_op_cost(func, args, {},
                                          _outputs(name, args))
    assert got_ops == ops and got_bytes == nbytes, name


def test_decode_formula_reads_the_whole_cache_when_lengths_are_fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(3, 8, 32)
        kc = torch.empty(3, 64, 2, 32)
        lens = torch.empty(3, dtype=torch.int32)
    func = torch.ops.repro_torch.decode_attention.default
    ops, _ = C.custom_op_cost(func, (q, kc, kc, lens, 0.1), {}, q)
    assert ops == {"float32": 4 * 32 * 8 * 3 * 64}


# --------------------------------------------- smoke steps of each family --
FAMILIES = {"qwen2.5-3b": {"rmsnorm", "flash_attention"},
            "zamba2-1.2b": {"rmsnorm", "flash_attention", "mamba_chunk_scan"},
            "xlstm-350m": {"rmsnorm", "mlstm_chunk_scan"},
            "deepseek-v2-lite-16b": {"rmsnorm", "flash_attention",
                                     "moe_gmm"}}
DECODE_OPS = {"qwen2.5-3b": {"rmsnorm", "decode_attention"},
              "zamba2-1.2b": {"rmsnorm", "decode_attention"},
              "xlstm-350m": {"rmsnorm"},
              "deepseek-v2-lite-16b": {"rmsnorm", "moe_gmm"}}


def _step_of(cfg, kind, B, S, pos):
    params = _smoke_params(cfg)
    if kind == "train":
        from repro_torch.training.optimizer import init_opt_state
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         dtype=torch.int32),
                 "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                         dtype=torch.int32)}
        return ST.make_train_step(cfg), (init_opt_state(params), batch)
    if kind == "prefill":
        return ST.make_prefill_step(cfg, cache_len=S), (
            params, {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                             dtype=torch.int32)})
    caches = M.init_cache(cfg, B, S, device="cpu")
    return ST.make_decode_step(cfg), (
        params, torch.ones(B, dtype=torch.int32),
        torch.full((B,), pos, dtype=torch.int32), caches)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_smoke_steps_count_every_custom_op(arch, kind):
    """Every custom op a smoke step of each family runs counts non-zero
    flops and bytes, and the step counts at least the analytic model
    flops of its kind, batch and length (a decode's length: the cache's
    filled rows, pos + 1, which is what the kernel reads), but for the
    hybrid decode (see below)."""
    cfg = smoke_shrink(get_config(arch))
    B, S, pos = 2, 64, 20
    fn, args = _step_of(cfg, kind, B, S, pos)
    got = C.analyze(fn, args)
    ops = got["custom_ops"]
    want = DECODE_OPS[arch] if kind == "decode" else FAMILIES[arch]
    if kind == "train":
        want = want | {f"{n}_backward" for n in want}
    assert set(ops) == want, (arch, kind, sorted(ops))
    assert all(v["flops"] > 0 and v["bytes"] > 0 for v in ops.values()), ops
    length = pos + 1 if kind == "decode" else S
    if (cfg.family, kind) != ("hybrid", "decode"):
        # a hybrid decode reaches no step's count: its analytic budget
        # prices every Mamba2 parameter at 2 flops a token (the conv, A,
        # D, dt and norm ones too, which no product reads); the
        # reference's own count of this step is 868,352 of its 908,544
        assert got["flops"] >= RF.analytic_model_flops(cfg, kind, B, length)
    assert got["hbm_bytes"] > 0


# ---------------------------------------------------------- exported --
def test_recorded_manifest_cost_equals_the_dispatched_count():
    """``compile_artifact`` writes the exported program's cost into the
    manifest (the keys ``from_recording_manifest`` reads): the same flops
    and eager bytes as ``analyze`` of the same smoke step, and the
    roofline of the manifest prices them by dtype.  ``memory`` is as
    before."""
    cfg = smoke_shrink(get_config("qwen2.5-3b"))
    fn = ST.make_prefill_step(cfg, cache_len=64)
    args = (_smoke_params(cfg),
            {"tokens": torch.zeros(2, 64, dtype=torch.int32)})
    rec = compile_artifact("prefill", fn, args)
    want = C.analyze(fn, args)
    cost = rec.manifest["cost"]
    assert cost["flops"] == want["flops"] > 0
    assert cost["bytes accessed"] == want["hbm_bytes"] > 0
    assert cost["flops_by_dtype"] == want["flops_by_dtype"]
    assert set(rec.manifest["memory"]) == {"arg_bytes", "temp_bytes",
                                           "out_bytes"}
    assert rec.manifest["memory"]["temp_bytes"] is None
    roof = RF.from_recording_manifest(rec.manifest, 1.0)
    assert roof.t_compute == RF.compute_time(want["flops_by_dtype"])
    assert roof.t_memory == want["hbm_bytes"] / RF.HBM_BW


def test_trace_follows_the_storage_a_step_allocates():
    """``peak_bytes``: the most storage the call held at once (a
    temporary freed before the output is made counts while it lives),
    ``fresh_out_bytes``: the output's."""
    def f(x):
        t = x * 2                 # 4 KiB, freed after the sum
        u = t.sum(0)              # 256 B
        del t
        return u + 1              # 256 B, the output
    tr = C.trace(f, (torch.zeros(16, 64),))
    assert tr.peak_bytes == 16 * 64 * 4 + 64 * 4
    assert tr.fresh_out_bytes == 64 * 4
    assert C.tree_bytes(tr.out) == 64 * 4
