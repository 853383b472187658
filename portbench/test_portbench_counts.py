"""The frozen arithmetic against hand-worked values, and the per-layer
readers on a made-up window."""
from __future__ import annotations

import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest

from portbench import tracing
from portbench.harness import as_run
from portbench.counts import flops, kernels, peaks

BENCH = Path(__file__).resolve().parent


def _module(path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decode_attention_by_hand():
    # rows of 1 and 2 valid keys, H 2, Hkv 1, hd = hdv = 4
    f, b = kernels.decode_attention([1, 2], 2, 1, 4, 4)
    assert f == 2 * 8 * 2 * 3
    assert b == 2 * 2 * 4 * 2 + 2 * 2 * 4 * 2 + 4 * 2 + 3 * 1 * 8 * 2


def test_flash_attention_by_hand():
    assert kernels.visible_pairs(3, 3) == 6
    assert kernels.visible_pairs(3, 3, causal=False) == 9
    f, b = kernels.flash_attention(1, 3, 3, 1, 1, 2, 2)
    assert f == 2 * 4 * 6 and b == 2 * (3 * 2 + 3 * 4 + 3 * 2)


def test_moe_by_hand():
    f, b = kernels.moe_gmm(2, 3, 4, 5)
    assert f == 240 and b == 2 * 2 * (12 + 20 + 15)
    # deepseek: 16 decode rows -> 6 a group; a 256-token prefill -> 32
    assert kernels.moe_capacity(16, 6, 64, 1.25) == 6
    assert kernels.moe_capacity(256, 6, 64, 1.25) == 32
    assert kernels.moe_rows(512, 256, 6, 64, 1.25) == 64


def test_peaks():
    assert peaks.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_by_hand():
    sh = {"layers": 2, "heads": 3, "qk_dim": 4, "v_dim": 5,
          "body_params": 100, "head_params": 10}
    assert flops.decode_token(sh, 7) == 2 * 110 + 2 * 2 * 3 * 9 * 7
    assert flops.prefill(sh, 4) == 2 * 100 * 4 + 2 * 10 + 2 * 2 * 3 * 9 * 10


@pytest.mark.parametrize("name", ["qwen2.5-3b-12l", "deepseek-v2-lite-16b-8l"])
def test_reference_sizes_match_the_port(name):
    """The reference's parameter count against the port's own
    (``ModelConfig.param_count``): embedding and final norm aside, the
    same weights a token meets."""
    conf = as_run(json.loads((BENCH / "configs" / f"{name}.json").read_text()))
    ref = _module(BENCH / "reference" / f"{conf['model_type']}.py")
    cfg = _module(BENCH / "adapters" / f"{conf['model_type']}.py").port_config(conf)
    sh = ref.shapes(conf)
    embed = 0 if conf["tie_word_embeddings"] else conf["vocab_size"] * conf["hidden_size"]
    assert sh["body_params"] + sh["head_params"] + embed + conf["hidden_size"] == \
        cfg.param_count(active_only=True)


def _ctx(**kw):
    base = dict(on_card=True, window_s=2.0, decode_ctx=[], prefill_lens=[],
                block_pos=[], stats={}, trace=None, mix={"block_k": 2, "slots": 2},
                shapes={"layers": 1, "heads": 2, "kv_heads": 1, "qk_dim": 4,
                        "v_dim": 4, "flash_kv_heads": 1, "body_params": 10,
                        "head_params": 0, "moe_layers": 0},
                record_s=3.0, boot_s=4.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _read(name, ctx):
    return _module(BENCH / "metrics" / f"{name}.py").read(ctx)


def test_readers_on_a_made_up_window():
    trace = {"busy_s": 0.5, "window_s": 2.0, "kernels": 3,
             "by_kernel": {"decode_attention_kernel": 1e-9 * 4,
                           "decode_attention_kernel[int8]": 5.0},
             "by_span": {"portbench.decode_block": 0.3},
             "calls": {"portbench.decode_block": 3},
             "idle_by_host": {"portbench.prefill": 0.5, "portbench.validate": 0.2,
                              "portbench.decode_block": 0.1,
                              "portbench.wait": 0.7}}
    # idle under the prefill's dispatch, and under the decode's stepping
    assert _read("idle_share.prefill", _ctx(trace=trace)) == pytest.approx(25.0)
    assert _read("idle_share.decode", _ctx(trace=trace)) == pytest.approx(15.0)
    assert _read("decode_block_ms", _ctx(trace=trace)) == pytest.approx(100.0)
    assert _read("prefill_ms", _ctx(trace=trace)) is None
    assert _read("serve.host_syncs_per_block",
                 _ctx(stats={"host_syncs": 3, "blocks_dispatched": 12})) == 0.25
    # one block of two rows at positions 0 and 1, two steps: lengths 1, 2
    # then 2, 3; int8 kernels are not this kernel's time
    ctx = _ctx(trace=trace, block_pos=[np.array([0, 1])])
    least = sum(peaks.least_seconds(*kernels.decode_attention(L, 2, 1, 4, 4))
                for L in ([1, 2], [2, 3]))
    assert _read("decode_attention_roofline", ctx) == pytest.approx(
        100 * least / 4e-9)
    assert _read("mfu.decode", _ctx(decode_ctx=[3])) == pytest.approx(
        100 * flops.decode_token(_ctx().shapes, 3) / (2.0 * peaks.BF16_FLOPS))
    assert _read("mfu.decode", _ctx(decode_ctx=[3], on_card=False)) is None
    assert _read("moe_gmm_roofline", _ctx(trace=trace)) is None
    assert _read("record_s", _ctx()) == 3.0 and _read("boot_s", _ctx()) == 4.0


def test_short_kernel_names():
    assert tracing.short_name(
        "void (anonymous namespace)::decode_attention_kernel<__nv_bfloat16, "
        "signed char>(x)") == "(anonymous namespace)::decode_attention_kernel[int8]"
    assert tracing.short_name("nvjet_tst_64x8") == "nvjet_tst_64x8"


def test_idle_attributed_to_the_innermost_host_span():
    spans = [(0, 10, "portbench.step_block"), (2, 5, "portbench.prefill")]
    assert tracing._innermost(spans) == [
        (0, 2, "portbench.step_block"), (2, 5, "portbench.prefill"),
        (5, 10, "portbench.step_block")]
    assert tracing._union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
