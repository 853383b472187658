"""Record -> sign -> replay for the hybrid and ssm families at smoke width
on the CPU: zamba2-1.2b and xlstm-350m recorded through the record
launcher's code and served through a ``ReplayChannel`` give the port's
live Engine's tokens and host syncs, and the prefill's last logits bit
for bit (``check_replay_equals_live``, shared with the moe family's
``tests/test_torch_replay_moe.py``; cody-mnist and qwen2.5-3b, against
the JAX replay Engine too, are in ``tests/test_torch_record_replay.py``)."""
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.workload import recording_name  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core.replay import Replayer  # noqa: E402
from repro_torch.launch import record as record_cli  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import steps as ST  # noqa: E402

KEY = b"replay-families-key"
BLOCK_K, CACHE_LEN, N_SLOTS, SEQ = 4, 32, 2, 8
STATS = ("host_syncs", "spec_blocks", "sync_blocks", "mispredicts",
         "blocks_dispatched", "retired")


def check_replay_equals_live(arch, tmp_path):
    cfg = smoke_shrink(get_config(arch), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    d = str(tmp_path)
    recs = record_cli.record_kinds(cfg, out=d, key=KEY, cache_len=CACHE_LEN,
                                   block_k=BLOCK_K, batch=N_SLOTS, seq=SEQ,
                                   params=params, device="cpu")
    for kind, (_, rec) in recs.items():
        ep = torch.export.load(io.BytesIO(rec.payload))
        assert ep.state_dict == {} and ep.constants == {}, kind

    # the prefill step, live and replayed, bit for bit
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(3, cfg.vocab_size, SEQ)))
               for _ in range(3)]
    rp = Replayer(key=KEY, device="cpu")
    pre = rp.load(os.path.join(d, recording_name(cfg.name, "prefill")))
    tree = L.to_tree(params)
    batch = {"tokens": torch.tensor([prompts[0]], dtype=torch.int32)}
    want, _ = ST.make_prefill_step(cfg, CACHE_LEN)(tree, batch)
    got, _ = rp.execute(pre, tree, batch)
    assert torch.equal(got["last_logits"], want["last_logits"])

    outs, stats = [], []
    for rec_dir in ("", d):
        eng = serve.build_engine(cfg, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                                 block_k=BLOCK_K, params=params,
                                 device="cpu", recordings_dir=rec_dir,
                                 key=KEY)
        for p in prompts:
            eng.submit(p, 10)
        outs.append(eng.run())
        stats.append({k: eng.stats.get(k, 0) for k in STATS})
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    assert eng.channel.kind == "signed-replay"


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_replay_engine_equals_live(arch, tmp_path):
    check_replay_equals_live(arch, tmp_path)
