"""ExecutionChannel — the transport seam between serving and the device.

Counterpart of ``repro/core/channel.py``.  The serving stack (scheduler /
stream executors / commit frontier) is transport-agnostic: a channel
exposes the three step kinds it dispatches — ``prefill``,
``batched_prefill`` (optional capability) and ``decode_block``.  Two
transports share the interface:

  * ``LiveChannel``   — the step functions run eagerly (the cloud / record
                        role);
  * ``ReplayChannel`` — signed recordings through a ``Replayer`` (the
                        paper's in-TEE mode).  Trust boundary: this module
                        imports no model, kernel or step code, so a replay
                        channel reaches decode with nothing but verified
                        programs in the TCB.

``NetemBilledChannel`` comes with the port of ``core/netem.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class ChannelCapabilityError(NotImplementedError):
    """The channel does not implement the requested step kind."""


class ExecutionChannel:
    """Transport endpoint executing serving steps in program order.

    ``kind`` names the transport; ``fixed_prompt_len`` is non-None when
    the transport only accepts one prefill shape (recorded executables);
    ``supports_batched_prefill`` gates grouped right-padded admission.
    """

    kind = "abstract"

    @property
    def fixed_prompt_len(self) -> Optional[int]:
        return None

    @property
    def supports_batched_prefill(self) -> bool:
        return False

    def prefill(self, params, batch):
        raise ChannelCapabilityError(f"{self.kind}: prefill")

    def batched_prefill(self, params, tokens, lengths):
        raise ChannelCapabilityError(f"{self.kind}: batched_prefill")

    def decode_block(self, params, tokens, pos, caches):
        raise ChannelCapabilityError(f"{self.kind}: decode_block")


class LiveChannel(ExecutionChannel):
    """Live transport: wraps already-built step callables.  Host inputs
    (numpy arrays from the executor's metastate) are copied to the device
    the params live on, as a jitted call does in the reference; device
    tensors chained from the previous block pass through untouched.
    Anything with the step signatures works, which lets tests inject
    wrapped steps unchanged."""

    kind = "live"

    def __init__(self, prefill_fn: Callable, decode_fn: Callable,
                 batched_prefill_fn: Optional[Callable] = None,
                 fixed_prompt_len: Optional[int] = None):
        self._prefill = prefill_fn
        self._decode = decode_fn
        self._batched_prefill = batched_prefill_fn
        self._fixed_prompt_len = fixed_prompt_len

    @staticmethod
    def _put(params, x) -> torch.Tensor:
        return torch.as_tensor(x, device=next(params.parameters()).device)

    @property
    def fixed_prompt_len(self) -> Optional[int]:
        return self._fixed_prompt_len

    @property
    def supports_batched_prefill(self) -> bool:
        return self._batched_prefill is not None

    def prefill(self, params, batch):
        return self._prefill(params, {k: self._put(params, v)
                                      for k, v in batch.items()})

    def batched_prefill(self, params, tokens, lengths):
        if self._batched_prefill is None:
            raise ChannelCapabilityError(f"{self.kind}: batched_prefill")
        return self._batched_prefill(params, self._put(params, tokens),
                                     self._put(params, lengths))

    def decode_block(self, params, tokens, pos, caches):
        return self._decode(params, self._put(params, tokens),
                            self._put(params, pos), caches)


class ReplayChannel(ExecutionChannel):
    """Signed-replay transport: executes verified recordings only.

    Holds a ``Replayer`` plus the logical names of the prefill and decode
    recordings.  The prefill shape is pinned by the recording (``seq`` in
    the manifest's static meta); batched prefill is structurally
    unsupported, since a recorded program has exactly the shapes it was
    recorded with.  Host inputs are copied to the replayer's device, as
    ``LiveChannel`` copies them to the params'; the params are the
    nested dicts/lists of tensors the recorded step takes.
    """

    kind = "signed-replay"

    def __init__(self, replayer, prefill_name: str, decode_name: str):
        self._rp = replayer
        self._pre = prefill_name
        self._dec = decode_name

    @property
    def replayer(self):
        return self._rp

    @property
    def fixed_prompt_len(self) -> Optional[int]:
        # several prefill shape variants may share the logical name; the
        # prompt length is only "fixed" when every variant agrees
        seqs = {m.get("static", {}).get("seq")
                for m in self._rp.manifests(self._pre)}
        if len(seqs) == 1:
            seq = seqs.pop()
            return int(seq) if seq else None
        return None

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self._rp.device)

    def prefill(self, params, batch):
        return self._rp.execute(self._pre, params,
                                {k: self._put(v) for k, v in batch.items()})

    def decode_block(self, params, tokens, pos, caches):
        return self._rp.execute(self._dec, params, self._put(tokens),
                                self._put(pos), caches)
