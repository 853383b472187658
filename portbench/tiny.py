"""A checkout-shaped folder for rehearsing the harness on the CPU at a tiny
size: ``BENCHMARK.json`` with tiny cells, and a copy of the benchmark's
folder with a tiny configuration of each model type, a tiny traffic mix and
a limit for each cell.  The tests use it; nothing the card runs does."""
from __future__ import annotations

import contextlib
import json
import shutil
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent

QWEN2 = {
    "name": "tiny-qwen2", "model_type": "qwen2", "hidden_size": 64,
    "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 256,
    "max_position_embeddings": 256, "rms_norm_eps": 1e-5,
    "rope_theta": 1000000.0, "tie_word_embeddings": True,
    "use_sliding_window": False, "torch_dtype": "bfloat16"}

DEEPSEEK_V2 = {
    "name": "tiny-deepseek-v2", "model_type": "deepseek_v2",
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 4, "num_hidden_layers": 3, "vocab_size": 256,
    "max_position_embeddings": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000,
    "tie_word_embeddings": False, "kv_lora_rank": 32, "q_lora_rank": None,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "n_routed_experts": 4, "n_shared_experts": 1, "num_experts_per_tok": 2,
    "moe_intermediate_size": 32, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "norm_topk_prob": True, "scoring_func": "softmax",
    "topk_method": "greedy", "routed_scaling_factor": 1, "rope_scaling": None,
    "moe_group_size": 256, "moe_capacity_factor": 1.25,
    "torch_dtype": "bfloat16"}

MIX = {"name": "tinychat", "arrivals": {"rate": 20.0, "strata": 4},
       "prompt_len": 8, "max_new": {"median": 6, "sigma": 0.5, "strata": 4},
       "slots": 3, "cache_len": 48, "block_k": 4, "pipeline_depth": 4,
       "speculate": True, "eos_id": -1, "warmup_s": 0.5}

# mean gaps of sound tiny runs on the CPU are rounding (bf16 program,
# float32 reference), under 0.002; one wrong token among ~25 adds ~0.1
MEAN_GAP = 0.02


@contextlib.contextmanager
def one_thread():
    """Torch's CPU work on one thread: the test run shares the machine's
    cores among its workers, and a tiny model runs fastest on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def make(root: Path) -> dict:
    """Write the tiny checkout under ``root``; returns its spec."""
    root = Path(root)
    bench = root / BENCH.name
    for sub in ("metrics", "reference", "adapters", "counts"):
        shutil.copytree(BENCH / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for conf in (QWEN2, DEEPSEEK_V2):
        f = f"{BENCH.name}/configs/{conf['name']}.json"
        (root / f).write_text(json.dumps(conf))
        spec["configs"].append({"name": conf["name"], "source": "tiny",
                                "file": f, "reduced": [], "why": "tiny"})
        cell = f"{conf['name']}.{MIX['name']}"
        spec["workloads"].append({"name": cell, "config": conf["name"],
                                  "traffic": MIX["name"], "chips": 1,
                                  "why": "tiny"})
        (bench / "limits" / f"{cell}.json").write_text(
            json.dumps({"mean_gap": MEAN_GAP, "check_tokens": 24}))
    (bench / "traffic" / f"{MIX['name']}.json").write_text(json.dumps(MIX))
    names = {c["name"] for c in spec["workloads"]}
    for m in spec["per_layer"] + spec["end_to_end"]:
        m["workloads"] = sorted(names)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return spec
