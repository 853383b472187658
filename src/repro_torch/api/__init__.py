"""repro_torch.api — the one public way to drive the CODY lifecycle
(counterpart of ``repro/api``).

Record CPU/GPU interactions once in a trustworthy environment, then
replay them inside the TEE, as a fluent API; the ``repro_torch.launch``
launchers are argument parsing over it:

    from repro_torch.api import Workspace

    ws = Workspace(registry="reg", key=b"secret", net="wifi")
    wl = ws.workload("qwen2.5-3b", cache_len=128, block_k=8, batch=4)

    rec = wl.record("prefill")       # distributed RecordingSession (cloud)
    wl.publish(rec)                  # sign + delta-publish into the registry
    blob = wl.fetch("prefill")       # chunked fetch, verified before load
    eng = wl.engine()                # TEE serve: warmed ReplayChannel
    ws.report()                      # netem + registry + session accounting

    workspace.py  Workspace — owns the store/service/client, the emulated
                  link, the signing key schedule, the device and the
                  default pass stacks; builds workloads, sessions,
                  campaigns and multi-tenant schedulers.
    workload.py   Workload — one (arch, shapes): derives the canonical
                  registry key once (``registry.key_for``) and exposes
                  compile/record/publish/fetch/replay/channel/engine;
                  plus the step-building helpers the launchers share.

Trust boundaries: ``record``/``compile`` run in the cloud role (model
code + exporter in the TCB); ``publish`` signs what crosses into the
registry; ``fetch`` verifies the HMAC and the transparency log before
``torch.export.load``; ``channel``/``engine`` in registry mode execute
only verified recordings.
"""
from repro_torch.api.workload import (KINDS, Workload, build_step,
                                      format_session_report, recording_name,
                                      static_meta_for, stream_kwargs)
from repro_torch.api.workspace import Workspace

__all__ = [
    "KINDS", "Workload", "Workspace", "build_step",
    "format_session_report", "recording_name", "static_meta_for",
    "stream_kwargs",
]
