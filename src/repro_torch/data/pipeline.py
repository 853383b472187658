"""Data pipeline: deterministic synthetic stream + memmap token files.

Counterpart of ``repro/data/pipeline.py`` (numpy only): for the same seed
and cursor the batches are the reference's, element for element.

The cursor is METASTATE (a handful of ints) — checkpoints inline it, and
restart resumes the exact batch sequence (replay-deterministic, which the
CODY rollback path relies on).  A prefetch thread keeps batches ahead;
work-stealing hook for straggling hosts.

Two differences from the reference, both repairs (ROADMAP Queue 3): its
``Prefetcher`` worker draws a new batch each time its ``put`` times out on
a full queue, so a consumer slower than 0.1 s a batch loses batches, and
which ones depends on timing; here the worker holds the batch it drew
until there is room, so the consumer sees the source's batches in order.
And the source's cursor runs ahead of the consumer by the batches in
flight, so a checkpoint of it skips them on resume; ``Prefetcher.meta``
is the cursor just after the last batch handed out.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np


class SyntheticLM:
    """Deterministic token stream: batch contents are a pure function of
    (seed, step) — restartable from the cursor alone."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.step = 0

    def meta(self) -> Dict[str, int]:
        return {"cursor_step": self.step, "cursor_seed": self.seed}

    def restore(self, meta: Dict[str, int]):
        self.step = int(meta["cursor_step"])
        self.seed = int(meta["cursor_seed"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ self.step)
        toks = rng.integers(3, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TokenFile:
    """Memmap-backed contiguous token corpus (one u32 per token)."""

    def __init__(self, path: str, batch: int, seq: int, offset: int = 0):
        self.arr = np.memmap(path, dtype=np.uint32, mode="r")
        self.batch, self.seq = batch, seq
        self.pos = offset

    def meta(self):
        return {"cursor_pos": self.pos}

    def restore(self, meta):
        self.pos = int(meta["cursor_pos"])

    def next_batch(self):
        need = self.batch * (self.seq + 1)
        if self.pos + need > len(self.arr):
            self.pos = 0
        flat = np.asarray(self.arr[self.pos:self.pos + need], dtype=np.int32)
        self.pos += need
        toks = flat.reshape(self.batch, self.seq + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Prefetch thread (``depth`` batches ahead) with a steal() hook for
    straggler mitigation (a slow host can hand its slice to a peer)."""

    def __init__(self, source, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._cursor = source.meta()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        item = None
        while not self._stop.is_set():
            if item is None:   # a batch and the cursor just after it
                item = (self.source.next_batch(), self.source.meta())
            try:
                self.q.put(item, timeout=0.1)
                item = None
            except queue.Full:
                continue

    def next_batch(self):
        batch, self._cursor = self.q.get()
        return batch

    def meta(self) -> Dict[str, int]:
        """The source's cursor just after the last batch handed out: what
        a checkpoint holds to resume with the next one."""
        return dict(self._cursor)

    def steal(self):
        """Give away the prefetched batch (straggler work-stealing)."""
        try:
            return self.q.get_nowait()[0]
        except queue.Empty:
            return None

    def close(self):
        self._stop.set()
        self._t.join(timeout=1.0)


__all__ = ["SyntheticLM", "TokenFile", "Prefetcher"]
