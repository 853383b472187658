"""repro_torch.record — the CODY distributed recording session
(counterpart of ``repro/record``).

Models the paper's two-party record phase: a ``DeviceProxy`` (GPU
hardware: executes committed op batches, holds readbacks, mirrors synced
state) and a ``CloudDryrun`` (GPU software: the ``torch.export`` stack
+ register-access interaction plan) collaborate through a
``RecordingSession`` over a ``NetworkEmulator``, with the paper's three
record-time optimizations — deferral (§4.1+4.3), speculation (§4.2),
metastate-only sync (§5) — composed as stackable interceptor passes.
"""
from repro_torch.record.cloud import REPLAY_CONSUMED_SITES, CloudDryrun
from repro_torch.record.device import DeviceProxy, FlakyRegisterDevice
from repro_torch.record.fanout import (DeviceSlot, RecordCampaign,
                                 SpeculationHistoryStore, VariantSpec)
from repro_torch.record.session import (PASS_NAMES, DeferralPass, MetasyncPass,
                                  RecordingSession, SessionReusedError,
                                  SpeculationPass, WireLink, resolve_passes)

__all__ = [
    "CloudDryrun", "DeviceProxy", "FlakyRegisterDevice", "RecordingSession",
    "SessionReusedError", "DeferralPass", "SpeculationPass", "MetasyncPass",
    "WireLink", "PASS_NAMES", "resolve_passes", "REPLAY_CONSUMED_SITES",
    "RecordCampaign", "DeviceSlot", "SpeculationHistoryStore", "VariantSpec",
]
