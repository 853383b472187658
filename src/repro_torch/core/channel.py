"""ExecutionChannel — the transport seam between serving and the device.

Counterpart of ``repro/core/channel.py``.  The serving stack (scheduler /
stream executors / commit frontier) is transport-agnostic: a channel
exposes the three step kinds it dispatches — ``prefill``,
``batched_prefill`` (optional capability) and ``decode_block``.  This
slice ports the live transport, ``LiveChannel``; the signed-replay
transport (``ReplayChannel``) comes with record/replay.
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
