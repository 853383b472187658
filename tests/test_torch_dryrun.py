"""The dry-run launcher (``launch/dryrun.py``) and per-rank counting under
DTensor, on the CPU: one subprocess starts a fake process group (as the
launcher does; the test workers keep theirs free), counts a product on a
fake 16 x 16 mesh and a 4 x 2 one, and runs smoke cells of the dry run on
the 16 x 16 production mesh, the counterpart of
``tests/test_system.py::test_dryrun_mini_multidevice``."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.analysis import cost as C
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh, make_production_mesh

out_path, cli_dir = sys.argv[1], sys.argv[2]
res = {}


def dt(mesh, shape, placements, dtype=torch.bfloat16):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    with FakeTensorMode(allow_non_fake_inputs=True):
        t = torch.empty(local, dtype=dtype)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


# x [256, 2048] @ w [2048, 11008] on a fake 16 x 16 ("data", "model") mesh,
# then the product gathered over model: a first and a repeated call
D.start_fake_world(256)
mesh = make_production_mesh(device="cpu")
x = dt(mesh, (256, 2048), [Shard(0), Replicate()])
w = dt(mesh, (2048, 11008), [Replicate(), Shard(1)])
f = lambda x, w: (x @ w).redistribute(mesh, [Shard(0), Replicate()])
res["matmul"] = [C.analyze(f, (x, w), 256) for _ in range(2)]

# smoke cells of the dry run on the 16 x 16 mesh
smoke = lambda a: smoke_shrink(get_config(a), vocab_size=512)
res["cells"] = [
    D.run_cell("qwen2.5-3b", "train_4k", False, {}, "cpu", smoke("qwen2.5-3b")),
    D.run_cell("zamba2-1.2b", "train_4k", False, {}, "cpu",
               smoke("zamba2-1.2b")),
    D.run_cell("qwen2.5-3b", "decode_32k", False,
               {"quant": True, "cfg": {"kv_quant": True}}, "cpu",
               smoke("qwen2.5-3b")),
    D.run_cell("qwen2.5-3b", "long_500k", False, {}, "cpu",
               smoke("qwen2.5-3b"))]

# a 4 x 2 mesh: a product with no replicated work, per rank x 8
D.start_fake_world(8)
mesh = make_mesh((4, 2), ("data", "model"), "cpu")
x = dt(mesh, (64, 32), [Shard(0), Replicate()], torch.float32)
w = dt(mesh, (32, 48), [Replicate(), Shard(1)], torch.float32)
with FakeTensorMode():
    xs, ws = torch.empty(64, 32), torch.empty(32, 48)
res["mesh4x2"] = C.analyze(lambda x, w: x @ w, (x, w), 8)["flops"]
res["whole"] = C.analyze(lambda x, w: x @ w, (xs, ws))["flops"]

# the launcher's main: a skipped cell and one that errs (rules unknown)
res["main_rc"] = D.main(["--arch", "qwen2.5-3b",
                         "--shape", "long_500k,train_4k", "--mesh", "single",
                         "--rules", "bogus", "--device", "cpu",
                         "--out", cli_dir])
res["world_left"] = dist.is_initialized()
json.dump(res, open(out_path, "w"))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    out, cli = d / "res.json", d / "cli"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(out), str(cli)],
                       env=env, capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(out.read_text()), cli, r.stdout


def test_fake_mesh_product_counts_one_ranks_work(run):
    """Per rank: the local [16, 2048] @ [2048, 688] product and one
    all-gather of the [16, 688] shard into [256, 688] (ring: 352,256 ×
    15/16 wire bytes), the same on the first call, when DTensor's
    sharding propagation runs the global-shape product, and on a repeated
    one."""
    first, again = run[0]["matmul"]
    for c in (first, again):
        assert c["flops"] == 2 * 16 * 2048 * 688 == 45_088_768
        assert c["coll"] == {"all-gather": 330_240.0}
        assert c["coll_count"] == {"all-gather": 1}
        assert c["coll_by_link"] == {"network": 330_240.0}
    assert first == again


def test_mesh_4x2_per_rank_count_times_8_is_the_whole(run):
    res = run[0]
    assert res["mesh4x2"] * 8 == res["whole"] == 2 * 64 * 32 * 48


def _reference_record_keys():
    """The keys of an ``ok`` record of the reference's ``run_cell``, read
    from ``src/repro/launch/dryrun.py``."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", "") == "rec" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
                "update" and any(k.arg == "status" and getattr(
                    k.value, "value", "") == "ok" for k in node.keywords):
            keys |= {k.arg for k in node.keywords}
    return keys


XLA_ONLY = {"xla_flops_per_dev", "t_compile_s", "hlo_text_len"}


@pytest.mark.parametrize("i", range(3), ids=["qwen-train", "zamba2-train",
                                             "qwen-decode-int8"])
def test_smoke_cells_run_on_the_production_mesh(run, i):
    rec = run[0]["cells"][i]
    assert rec["status"] == "ok", rec.get("trace", rec)
    want = _reference_record_keys() - XLA_ONLY
    assert "bytes_per_device" in want and "t_lower_s" in want
    assert want <= set(rec) and not XLA_ONLY & set(rec)
    assert rec["mesh"] == "16x16" and rec["num_chips"] == 256
    assert rec["hlo"]["flops"] > 0 and rec["bytes_per_device"] > 0
    assert rec["bytes_per_device"] == rec["arg_bytes"] + rec["temp_bytes"] \
        + rec["out_bytes"] - rec["alias_bytes"]
    assert rec["resident_bytes"] == rec["arg_bytes"] + rec["out_bytes"] \
        - rec["alias_bytes"]
    # the donated train state, or the decode caches, come back in place
    assert rec["alias_bytes"] > 0
    assert rec["roofline"]["flops_per_chip"] == rec["hlo"]["flops"]
    assert set(rec["roofline"]) >= {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "dominant"}
    assert rec["hlo"]["coll_bytes"] > 0          # FSDP / TP collectives
    ops = rec["hlo"]["custom_ops"]
    assert all(v["flops"] > 0 and v["bytes"] > 0 for v in ops.values())
    if i == 2:
        assert "decode_attention_int8" in ops


def test_a_full_attention_long_context_cell_is_skipped(run):
    from repro.configs import cell_applicable, get_config
    rec = run[0]["cells"][3]
    assert rec["status"] == "skip"
    assert rec["reason"] == cell_applicable(get_config("qwen2.5-3b"),
                                            "long_500k")


def test_main_records_every_cell_and_fails_on_an_error(run):
    res, cli, stdout = run
    assert res["main_rc"] == 1 and not res["world_left"]
    skip = json.loads((cli / "qwen2.5-3b_long_500k_16x16.json").read_text())
    err = json.loads((cli / "qwen2.5-3b_train_4k_16x16.json").read_text())
    assert skip["status"] == "skip"
    assert err["status"] == "error" and "unknown mode" in err["error"]
    assert "done: ok=0 skip=1 error=1" in stdout
