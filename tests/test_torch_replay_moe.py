"""Record -> sign -> replay for the moe family (deepseek-v2-lite-16b: MLA
and routed experts) at smoke width on the CPU: the replayed Engine gives
the live Engine's tokens and host syncs, and the prefill's last logits
bit for bit (the check of ``tests/test_torch_replay_families.py``)."""
import pytest

pytest.importorskip("torch")

from test_torch_replay_families import check_replay_equals_live  # noqa: E402


def test_replay_engine_equals_live(tmp_path):
    check_replay_equals_live("deepseek-v2-lite-16b", tmp_path)
