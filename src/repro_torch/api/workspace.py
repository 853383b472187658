"""Workspace — the one place the store/service/client/netem/signing-key
wiring lives.

Counterpart of ``repro/api/workspace.py``.  A ``Workspace`` owns
everything a lifecycle needs that is NOT specific to one workload: the
registry (content-addressed store + single-flight record-on-miss service
+ verify-before-load client), the emulated device<->cloud link, the
signing key schedule, the default record/replay pass stacks, and the
device the port runs on (CUDA unless the caller asks for the CPU).
``workload()`` binds a model/shape tuple to it; ``scheduler()`` serves
several workloads concurrently; ``campaign()`` fans records out across
devices; ``report()`` aggregates link, registry, session and attestation
accounting.  ``fleet()`` needs the port of ``repro/fleet`` (ROADMAP
Queue 1, item 10) and raises until then.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.api.workload import KINDS, Workload, channel_params
from repro_torch.attest import EpochKey, KeySchedule
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.core.attest import RotatedKeyError
from repro_torch.core.netem import PROFILES, NetProfile, NetworkEmulator
from repro_torch.obs.metrics import Metrics
from repro_torch.obs.trace import NULL, Tracer
from repro_torch.record import (CloudDryrun, DeviceSlot, RecordCampaign,
                                RecordingSession, VariantSpec)
from repro_torch.registry import (RecordingStore, RegistryClient,
                                  RegistryReadReplica, RegistryService)
from repro_torch.serving.scheduler import Scheduler

_Net = Union[None, str, NetProfile, NetworkEmulator]


def _resolve_net(net: _Net) -> Optional[NetworkEmulator]:
    """``net`` can be a profile name from ``repro_torch.core.netem.
    PROFILES`` ("local"/"wifi"/"cellular", or "none"), a ``NetProfile``,
    an existing ``NetworkEmulator`` (shared billing with a caller), or
    None."""
    if net is None or net == "none":
        return None
    if isinstance(net, NetworkEmulator):
        return net
    if isinstance(net, NetProfile):
        return NetworkEmulator(net)
    if net not in PROFILES:
        raise ValueError(f"unknown net profile {net!r}; "
                         f"valid: none|{'|'.join(sorted(PROFILES))}")
    return NetworkEmulator(PROFILES[net])


class Workspace:
    """``Workspace(registry=..., key=..., net="wifi")`` — the lifecycle
    root.  ``registry`` is a filesystem root, ``":memory:"`` for an
    in-process store, or None for live-only serving; ``key`` signs and
    verifies every recording that crosses the registry boundary;
    ``device`` is where workloads record, replay and serve."""

    def __init__(self, registry: Union[None, str, bool] = None, *,
                 key: Union[bytes, KeySchedule, EpochKey] = b"",
                 net: _Net = None,
                 record_passes="all", replay_passes="all",
                 trace: Union[bool, Tracer] = False,
                 store_cache_bytes: int = 8 << 20, device="cuda"):
        if registry is False or registry == "":
            registry = None       # falsy spellings of "no registry"
        # the workspace owns the attestation key schedule (per-epoch
        # signing-key rotation).  ``key`` accepts the raw root secret, a
        # shared KeySchedule, or an EpochKey credential — but NEVER a
        # rotated-away epoch's key: a stale credential must fail loudly
        # at construction, not produce unverifiable signatures later.
        if isinstance(key, EpochKey):
            if key.stale:
                raise RotatedKeyError(
                    f"epoch-{key.epoch} key was rotated away (schedule is "
                    f"at epoch {key.schedule.epoch}); build the Workspace "
                    "from the KeySchedule or the current epoch's key")
            self.keys: Optional[KeySchedule] = key.schedule
            key = key.schedule.root
        elif isinstance(key, KeySchedule):
            self.keys = key
            key = key.root
        else:
            self.keys = KeySchedule(key) if key else None
        if registry is not None and not key:
            raise ValueError(
                "Workspace with a registry requires the signing key: "
                "recordings are verified before any load, so an unkeyed "
                "registry workspace could never fetch safely")
        self.key = key
        self.device = torch.device(device)
        self.quotes = []          # replay attestation quotes emitted
        self.registry = registry
        self.netem = _resolve_net(net)
        self.record_passes = record_passes
        self.replay_passes = replay_passes
        self.workloads = []
        self.schedulers = []
        self.campaigns = []
        self.store_cache_bytes = store_cache_bytes
        self.metrics = Metrics()
        # trace=True builds a Tracer on the workspace link's virtual clock
        # (constant 0 base when there is no link); trace=False leaves the
        # falsy NULL tracer so every traced() call site is one check
        if isinstance(trace, Tracer):
            self.tracer = trace
        elif trace:
            net_ref = self.netem
            self.tracer = Tracer(
                clock=(lambda: net_ref.virtual_time_s)
                if net_ref is not None else None)
        else:
            self.tracer = NULL
        self._store: Optional[RecordingStore] = None
        self._service: Optional[RegistryService] = None
        self._client: Optional[RegistryClient] = None
        self._read_replicas: dict = {}     # region -> RegistryReadReplica

    # ------------------------------------------------------------- wiring --
    @property
    def has_registry(self) -> bool:
        return self.registry is not None

    @property
    def profile(self) -> Optional[NetProfile]:
        return self.netem.profile if self.netem is not None else None

    def fresh_netem(self) -> Optional[NetworkEmulator]:
        """A new emulator on the workspace's profile — for callers that
        need an isolated billing span (e.g. per-scenario runs)."""
        return NetworkEmulator(self.profile) if self.netem is not None \
            else None

    @property
    def store(self) -> RecordingStore:
        if not self.has_registry:
            raise RuntimeError("Workspace has no registry configured; "
                               "pass registry=<root> (or ':memory:')")
        if self._store is None:
            root = None if self.registry in (True, ":memory:") \
                else self.registry
            self._store = RecordingStore(
                root, key=self.key, cache_bytes=self.store_cache_bytes,
                metrics=self.metrics)
        return self._store

    @property
    def service(self) -> RegistryService:
        """Cloud side: fetch-by-key + single-flight record-on-miss over
        the workspace link profile + delta publishing."""
        if self._service is None:
            self._service = RegistryService(
                self.store, signing_key=self.key,
                record_profile=self.profile,
                record_passes=self.record_passes, tracer=self.tracer,
                keys=self.keys)
        return self._service

    @property
    def client(self) -> RegistryClient:
        """Device side: chunked resumable netem-billed fetch, verified
        before any load."""
        if self._client is None:
            self._client = self.new_client()
        return self._client

    @property
    def registry_client(self) -> Optional[RegistryClient]:
        """The shared client if one has been created, else None — for
        callers that only want to read its stats."""
        return self._client

    def new_client(self, netem: Optional[NetworkEmulator] = None, *,
                   region: Optional[str] = None,
                   verify_proofs: bool = True) -> RegistryClient:
        """A fresh, fully independent client (its own ``stats`` and chunk
        LRU) against this workspace's service, optionally on its own
        emulator.  With ``region`` it reads through that region's
        read-replica; ``verify_proofs=False`` opts out of transparency-
        log proof verification."""
        svc = self.read_replica(region) if region is not None \
            else self.service
        return RegistryClient(svc,
                              netem=netem if netem is not None
                              else self.netem, key=self.key,
                              tracer=self.tracer, keys=self.keys,
                              verify_proofs=verify_proofs)

    def read_replica(self, region: str) -> RegistryReadReplica:
        """The (memoized) read-replica for ``region``: a regional chunk
        cache over the primary service."""
        if region not in self._read_replicas:
            self._read_replicas[region] = RegistryReadReplica(
                self.service, region=region, metrics=self.metrics)
        return self._read_replicas[region]

    # -------------------------------------------------------- attestation --
    def rotate_epoch(self) -> int:
        """Advance the signing-key schedule one epoch.  Heads and quotes
        signed from now on carry the new epoch; everything published in
        older epochs stays verifiable."""
        if self.keys is None:
            raise ValueError("Workspace has no key schedule to rotate "
                             "(construct with key=...)")
        return self.keys.rotate()

    # ------------------------------------------------------------- record --
    def session(self, passes=None, jobs: Optional[int] = None
                ) -> RecordingSession:
        """One two-party recording session over the workspace's link
        profile (in-process degenerate when the workspace has no net).
        Sessions are single-use: one per recording."""
        passes = self.record_passes if passes is None else passes
        cloud = CloudDryrun(jobs=jobs) if jobs is not None else None
        if self.netem is not None:
            return RecordingSession.for_profile(self.profile, passes=passes,
                                                cloud=cloud,
                                                tracer=self.tracer)
        return RecordingSession.local(passes=passes, cloud=cloud,
                                      tracer=self.tracer)

    def campaign(self, items, *, devices: int = 2, nets=None,
                 hw_class: str = "edge-gpu", share_history: bool = True,
                 passes=None, jobs: Optional[int] = None,
                 tick_s: float = 0.02, name: Optional[str] = None,
                 publish: Optional[bool] = None,
                 artifacts: Optional[dict] = None,
                 max_ticks: int = 500_000) -> RecordCampaign:
        """Multi-device record fan-out: a ``RecordCampaign`` over this
        workspace's registry and link profile.

        ``items`` are ``Workload``s (expanded over every kind),
        ``(Workload, kind)`` pairs, or prepared ``VariantSpec``s.  Each of
        the ``devices`` slots gets its OWN emulator on the workspace
        profile, or round-robin over ``nets``.  ``publish`` defaults to
        whether the workspace has a registry: claimed variants then go
        through the service's multi-variant lease and publish
        incrementally.  The campaign is returned un-run; call ``.run()``."""
        variants = []
        for it in items:
            if isinstance(it, VariantSpec):
                variants.append(it)
                continue
            wl, kinds = (it if isinstance(it, tuple) else (it, None))
            for kind in ([kinds] if isinstance(kinds, str)
                         else (kinds or KINDS)):
                variants.append(VariantSpec(
                    wl.key(kind),
                    (lambda w=wl, k=kind: w.compile(k)),
                    label=f"{wl.cfg.name}/{kind}/"
                          f"b{wl.static_meta(kind)['batch']}"
                          f"s{wl.seq if kind == 'prefill' else '-'}"))
        net_specs = list(nets) if nets else [None]
        slots = []
        for i in range(devices):
            spec = net_specs[i % len(net_specs)]
            netem = self.fresh_netem() if spec is None \
                else _resolve_net(spec)
            slots.append(DeviceSlot(f"dev{i}", netem, hw_class=hw_class))
        if publish is None:
            publish = self.has_registry
        c = RecordCampaign(
            variants, slots, share_history=share_history,
            artifacts=artifacts,
            passes=self.record_passes if passes is None else passes,
            jobs=jobs, tick_s=tick_s,
            name=name if name is not None
            else f"campaign{len(self.campaigns)}",
            tracer=self.tracer, metrics=self.metrics,
            service=self.service if publish else None,
            max_ticks=max_ticks)
        self.campaigns.append(c)
        return c

    # ---------------------------------------------------------- workloads --
    def workload(self, arch, *, shapes: Optional[dict] = None,
                 smoke: bool = True, **shape_overrides) -> Workload:
        """Bind a model to this workspace.  ``arch`` is a config name
        (smoke-shrunk by default) or an already-built ``ModelConfig``;
        shape kwargs (``cache_len``, ``block_k``, ``batch``,
        ``prefill_batch``, ``seq``, ``eos_id``) come from ``shapes`` or
        directly as keyword overrides."""
        cfg = arch
        if isinstance(arch, str):
            cfg = get_config(arch)
            if smoke:
                cfg = smoke_shrink(cfg)
        kw = dict(shapes or {})
        kw.update(shape_overrides)
        wl = Workload(self, cfg, **kw)
        self.workloads.append(wl)
        return wl

    def scheduler(self, streams, *, n_slots: int = 4, cache_len: int = 128,
                  block_k: int = 8, eos_id: int = 2, smoke: bool = True,
                  speculate: bool = True, pipeline_depth: int = 4,
                  max_live_slots=None, stall_limit=None, seed: int = 0):
        """Multi-tenant serving: one ``Scheduler``, one stream per entry
        of ``streams``, each with its own channel, params (seeded
        ``seed + i``), slots, and caches.  An entry is an arch name —
        shaped by the ``n_slots``/``cache_len``/``block_k``/``eos_id``/
        ``smoke`` kwargs — or a prepared ``Workload``, which KEEPS its
        own shapes.  Returns ``(scheduler, {name: workload})``."""
        sched = Scheduler(netem=self.netem, max_live_slots=max_live_slots,
                          stall_limit=stall_limit, tracer=self.tracer,
                          metrics=self.metrics)
        self.schedulers.append(sched)
        out = {}
        for i, s in enumerate(streams):
            wl = s if isinstance(s, Workload) else self.workload(
                s, smoke=smoke, batch=n_slots, cache_len=cache_len,
                block_k=block_k, eos_id=eos_id)
            ch = wl.channel()
            sched.add_stream(wl.cfg.name, ch,
                             channel_params(ch, wl.params(seed + i)),
                             **wl.stream_kwargs(speculate=speculate,
                                                pipeline_depth=pipeline_depth))
            out[wl.cfg.name] = wl
        return sched, out

    def fleet(self, streams, **kw):
        """Fleet-scale serving (``repro/api/workspace.py:fleet``) needs
        ``fleet/pool.py``, which the port has not reached yet."""
        raise NotImplementedError(
            "Workspace.fleet needs repro_torch.fleet (ROADMAP Queue 1, "
            "item 10: fleet/{pool,balancer,traffic}.py)")

    # ----------------------------------------------------------- reporting --
    def report(self) -> dict:
        """Aggregate accounting: the link emulator's totals, registry
        client/service stats, every record-session report made through
        this workspace's workloads, the metrics registry snapshot, each
        scheduler's public stats, campaigns, the store and attestation.
        The shape is pinned by ``repro_torch.obs.schema.
        check_workspace_report``; ``fleet`` stays an empty list until
        the port has ``Workspace.fleet``."""
        return {
            "net": self.netem.snapshot() if self.netem is not None else None,
            "registry_client": dict(self._client.stats)
            if self._client is not None else {},
            "registry_service": dict(self._service.stats)
            if self._service is not None else {},
            "sessions": [dict(rep, workload=wl.cfg.name, kind=kind)
                         for wl in self.workloads
                         for kind, rep in wl.sessions],
            "replays": [dict(rep, workload=wl.cfg.name, kind=kind)
                        for wl in self.workloads
                        for kind, rep in wl.replays],
            "replayer_stats": self._replayer_stats(),
            "metrics": self.metrics.snapshot(),
            "schedulers": [s.stats() for s in self.schedulers],
            "fleet": [],
            "campaigns": [c.stats() for c in self.campaigns],
            "registry_store": self._registry_store_stats(),
            "attest": self._attest_stats(),
        }

    def _attest_stats(self) -> dict:
        """Attestation accounting: key-schedule epoch, transparency-log
        head, client proof verifications, quotes emitted."""
        cl = self._client.stats if self._client is not None else {}
        return {
            "epoch": self.keys.epoch if self.keys is not None else None,
            "log_size": self._service.log.size
            if self._service is not None else 0,
            "root": self._service.log.root()
            if self._service is not None else None,
            "quotes": len(self.quotes),
            "proofs_verified": int(cl.get("proofs_verified", 0)),
            "proof_bytes": int(cl.get("proof_bytes", 0)),
        }

    def _registry_store_stats(self) -> dict:
        """Store-level accounting (chunk reads, LRU cache counters) plus
        each regional read-replica's summary."""
        base = self._store.summary() if self._store is not None else \
            {"chunk_reads": 0, "puts": 0, "gets": 0, "cache": None}
        base["read_replicas"] = [
            self._read_replicas[r].summary()
            for r in sorted(self._read_replicas)]
        return base

    def _replayer_stats(self) -> dict:
        """Summed Replayer counters across every workload."""
        totals: dict = {}
        for wl in self.workloads:
            for k, v in wl.replayer_stats().items():
                totals[k] = totals.get(k, 0) + v
        return totals


__all__ = ["Workspace"]
