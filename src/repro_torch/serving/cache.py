"""Slot-based KV cache management for continuous batching.

The allocation table (slot -> request, lengths, positions) is pure
METASTATE (repro.core.metasync): it is what crosses hosts, what rollback
restores, and what checkpoints inline — KV pages themselves never travel
(paper §5).  Stale cache rows beyond a sequence's committed position are
harmless by construction (decode masks on ``pos``), which is what makes
metastate-only rollback sound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SlotTable:
    """Metastate: the engine's 'page table'."""
    n_slots: int

    def __post_init__(self):
        self.request_id = np.full(self.n_slots, -1, np.int64)
        self.pos = np.zeros(self.n_slots, np.int32)        # next write slot
        self.committed_pos = np.zeros(self.n_slots, np.int32)
        self.done = np.ones(self.n_slots, bool)            # free == done

    # -- metastate dict for metasync / checkpoints --
    def meta(self) -> Dict[str, np.ndarray]:
        return {"request_id": self.request_id.copy(),
                "pos": self.pos.copy(),
                "committed_pos": self.committed_pos.copy(),
                "done": self.done.copy()}

    def restore(self, meta: Dict[str, np.ndarray]):
        self.request_id = np.array(meta["request_id"])
        self.pos = np.array(meta["pos"])
        self.committed_pos = np.array(meta["committed_pos"])
        self.done = np.array(meta["done"])

    def free_slots(self) -> List[int]:
        return np.flatnonzero(self.done).tolist()

    def active_mask(self) -> np.ndarray:
        """Boolean mask of occupied slots (vectorized hot-path helper)."""
        return ~self.done

    def alloc(self, request_id: int, prompt_len: int) -> Optional[int]:
        free = np.flatnonzero(self.done)
        if free.size == 0:
            return None
        s = int(free[0])
        self.request_id[s] = request_id
        self.pos[s] = prompt_len
        self.committed_pos[s] = prompt_len
        self.done[s] = False
        return s

    def release(self, slot: int):
        self.request_id[slot] = -1
        self.done[slot] = True
        self.pos[slot] = 0
        self.committed_pos[slot] = 0


def cache_leaves(tree) -> list:
    """Leaves of a cache tree (lists of dicts) in the reference's order:
    list order, then sorted dict keys, as ``jax.tree.leaves`` walks them.
    Tuples are leaves, so this also walks ``model.cache_axes``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in cache_leaves(t)]
    return [tree]
