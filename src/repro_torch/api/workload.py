"""Workload — one (arch, shapes) driven through the full lifecycle.

Counterpart of ``repro/api/workload.py``.  A ``Workload`` derives the
canonical registry identity ONCE (``registry.key_for`` over the static
meta a manifest records, the config fingerprint and the mesh) and
exposes every lifecycle stage as a method: ``compile`` / ``record``
(cloud role), ``publish`` / ``fetch`` (registry), ``replay`` /
``attested_replay`` (priced plan replay, signed quotes) and ``channel``
/ ``engine`` (serving: live steps, flat recordings, or verified registry
replay).  The step-building and static-meta helpers the launchers share
live here as module functions.

A workload's mesh is the ``DeviceMesh`` it is given, or none, which is
described as the reference's host mesh on one device
(``core.recorder.mesh_descriptor``, [1, 1], as a 1 x 1 mesh is too):
every manifest records it and every key fingerprints it, which makes
``_key_of`` (the key a recording's own manifest implies) agree with
``key`` (the key a workload derives from its shapes) for the port's
recordings.  With a mesh the steps take the reference's serve rules
(``sharding.rules_for("serve", ...)``), which place nothing on plain
tensors and constrain DTensor params on that mesh; without one no
process group is started and the steps take no rules.  A recording's
static meta names the backend that exported it (``recorded_static``), so
the port's keys never equal the reference's XLA ones.  Entry points run
on the workspace's device (``Workspace(device=...)``, CUDA unless the
caller asks for the CPU).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.attest import fingerprint
from repro_torch.core.channel import (LiveChannel, NetemBilledChannel,
                                      ReplayChannel)
from repro_torch.core.recorder import (compile_artifact, mesh_descriptor,
                                       record, recorded_static,
                                       topology_fingerprint)
from repro_torch.core.recording import Recording
from repro_torch.core.replay import Replayer
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.registry import key_arch, key_for
from repro_torch.serving.engine import Engine, cache_batch_axes_for
from repro_torch.sharding import rules_for
from repro_torch.training import steps as ST

KINDS = ("prefill", "decode")


def static_meta_for(kind: str, *, cache_len: int, block_k: int, batch: int,
                    seq: int, eos_id: int = 2) -> dict:
    """The shape/static description that parameterizes ``build_step``.
    ``seq`` shapes prefill only; a non-default ``eos_id`` is baked into
    the fused decode program and so enters decode's description."""
    static = {"kind": kind, "cache_len": cache_len, "block_k": block_k,
              "batch": batch}
    if kind == "prefill":
        static["seq"] = seq
    elif eos_id != 2:
        static["eos_id"] = eos_id
    return static


def build_step(cfg, kind: str, *, cache_len: int, block_k: int = 8,
               batch: int = 1, seq: int = 32, eos_id: int = 2, params=None,
               device="cuda", rules=None):
    """(step, example inputs, donated argnums) for one kind.  The step
    takes the params as its first input, as the nested dicts/lists of
    tensors ``layers.to_tree`` gives; the example inputs are real tensors
    on ``device``: the caller's params (a ParamTree or such a tree), or
    zeros of the schema's shapes, and zeros for the rest.  Decode donates
    the caches (argument 3): it updates them in place and returns them."""
    device = resolve_device(device)
    if params is None:
        tree = L.zeros_like_schema(M.model_schema(cfg), cfg.dtype, device)
    elif isinstance(params, torch.nn.Module):
        tree = L.to_tree(params)
    else:
        tree = params
    if kind == "prefill":
        fn = ST.make_prefill_step(cfg, cache_len, rules=rules)
        tokens = torch.zeros((batch, seq), dtype=torch.int32, device=device)
        return fn, (tree, {"tokens": tokens}), ()
    if kind == "decode":
        fn = ST.make_fused_decode_step(cfg, k=block_k, eos_id=eos_id,
                                       rules=rules)
        caches = M.init_cache(cfg, batch, cache_len, device=device)
        zeros = torch.zeros((batch,), dtype=torch.int32, device=device)
        return fn, (tree, zeros, zeros.clone(), caches), (3,)
    raise ValueError(kind)


def recording_name(arch: str, kind: str, extra: str = "") -> str:
    """Flat on-disk filename for a recording (identity normalization is
    shared with the registry via ``key_arch``)."""
    return f"{key_arch(arch)}_{kind}{('_' + extra) if extra else ''}.codyrec"


def stream_kwargs(cfg, *, n_slots: int, cache_len: int, block_k: int,
                  eos_id: int, speculate: bool = True,
                  pipeline_depth: int = 4, device="cuda") -> dict:
    """Per-stream policy for ``Scheduler.add_stream`` derived from the
    model family: recurrent state is not position-indexed, so dropped
    pipeline tails cannot be re-executed against an already-advanced
    state — metastate-only rollback is unsound there and speculation is
    forced off."""
    if cfg.family in ("ssm", "hybrid"):
        speculate = False
    return dict(n_slots=n_slots, cache_len=cache_len, block_k=block_k,
                eos_id=eos_id,
                init_caches_fn=lambda: M.init_cache(cfg, n_slots, cache_len,
                                                    device=device),
                cache_batch_axes=cache_batch_axes_for(cfg),
                speculate=speculate, pipeline_depth=pipeline_depth)


def channel_params(channel, params):
    """The params as ``channel`` takes them: a replay channel runs
    recorded programs, whose first input is the nested dicts/lists of
    tensors ``layers.to_tree`` gives; a live one takes the ParamTree."""
    inner = channel.inner if isinstance(channel, NetemBilledChannel) \
        else channel
    if isinstance(inner, ReplayChannel) and \
            isinstance(params, torch.nn.Module):
        return L.to_tree(params)
    return params


def format_session_report(rep: dict) -> str:
    """One-line summary of a RecordingSession report."""
    mb = (rep["bytes_sent"] + rep["bytes_received"]) / 1e6
    passes = "+".join(rep["passes"]) or "naive"
    return (f"session[{rep['net']}|{passes}]: "
            f"{rep['virtual_time_s']:.2f}s virtual, "
            f"{rep['blocking_round_trips']} blocking / "
            f"{rep['async_round_trips']} async RTs, {mb:.2f} MB, "
            f"{rep['jobs']} jobs")


class Workload:
    """One workload's lifecycle handle.  Built by ``Workspace.workload``;
    holds the model config, the device, and the shape tuple
    (``cache_len``, ``block_k``, ``batch`` = decode batch = serving
    slots, ``prefill_batch``, ``seq`` = prefill prompt length) that —
    together with the config and mesh fingerprints — IS the recording
    identity."""

    def __init__(self, workspace, cfg, *, cache_len: int = 128,
                 block_k: int = 8, batch: int = 4, prefill_batch: int = 1,
                 seq: int = 32, eos_id: int = 2, mesh=None):
        self.ws = workspace
        self.cfg = cfg
        self.device = workspace.device
        self.cache_len = cache_len
        self.block_k = block_k
        self.batch = batch
        self.prefill_batch = prefill_batch
        self.seq = seq
        self.eos_id = eos_id
        self.device_mesh = mesh
        self.rules = None if mesh is None else \
            rules_for("serve", tuple(mesh.mesh_dim_names))
        self.mesh = mesh_descriptor(mesh)
        self.mesh_fp = fingerprint(self.mesh)
        self.config_fp = cfg.fingerprint()
        # the canonical identity, derived once per kind and never re-derived
        self._keys = {k: key_for(cfg.name, k,
                                 {**recorded_static(self.static_meta(k)),
                                  "config_fp": self.config_fp},
                                 self.mesh_fp) for k in KINDS}
        self.sessions = []        # (kind, session report) per record()
        self.replays = []         # (kind, executor report) per replay()
        self.replayers = []       # every Replayer built for this workload
        self._live: Optional[LiveChannel] = None
        self._params = {}         # seed -> initialized params

    # ------------------------------------------------------------ identity --
    def static_meta(self, kind: str) -> dict:
        batch = self.prefill_batch if kind == "prefill" else self.batch
        return static_meta_for(kind, cache_len=self.cache_len,
                               block_k=self.block_k, batch=batch,
                               seq=self.seq, eos_id=self.eos_id)

    def key(self, kind: str) -> str:
        """The registry key this workload records under, publishes under,
        fetches by, and caches replay programs under."""
        return self._keys[kind]

    def step(self, kind: str, params=None):
        """(step, example inputs, donated argnums) on the workspace's
        device; ``params`` serve as the example inputs where given, else
        zeros of the schema do (only shapes and dtypes enter a
        recording)."""
        static = self.static_meta(kind)
        return build_step(self.cfg, kind, cache_len=self.cache_len,
                          block_k=self.block_k, batch=static["batch"],
                          seq=self.seq, eos_id=self.eos_id, params=params,
                          device=self.device, rules=self.rules)

    def params(self, seed: int = 0):
        """Initialized model params on the workspace's device, memoized
        per seed (so solo engines and scheduler streams built from one
        workload share tensors)."""
        if seed not in self._params:
            self._params[seed] = M.init_params(self.cfg, seed=seed,
                                               device=self.device)
        return self._params[seed]

    # -------------------------------------------------------------- record --
    def compile(self, kind: str = "prefill") -> Recording:
        """Cloud dryrun only: export + serialize, no session protocol.
        Use with ``record(artifact=...)`` to amortize ONE export across
        several session variants."""
        fn, args, donate = self.step(kind)
        return compile_artifact(self.key(kind), fn, args,
                                donate_argnums=donate, mesh=self.device_mesh,
                                config_fingerprint=self.config_fp,
                                static_meta=self.static_meta(kind))

    def record(self, kind: str = "prefill", *, passes=None,
               artifact: Optional[Recording] = None,
               jobs: Optional[int] = None, params=None) -> Recording:
        """The paper's record phase: a distributed ``RecordingSession``
        (device proxy + cloud dryrun) over the workspace's link profile,
        with the optimization passes stacked in canonical order.  Returns
        the Recording with session accounting annotated into its manifest
        (``record_virtual_s`` / ``record_session``); the session report is
        also appended to ``self.sessions`` for ``report()``.  ``params``
        serve as the export's example inputs where given."""
        session = self.ws.session(passes=passes, jobs=jobs)
        if artifact is not None:
            # the artifact knows what it is — label the session by ITS
            # kind, not the (defaulted) argument
            kind = artifact.manifest.get("static", {}).get("kind", kind)
            rec = session.finalize(Recording(dict(artifact.manifest),
                                             artifact.payload,
                                             artifact.trees))
        else:
            fn, args, donate = self.step(kind, params)
            rec = record(self.key(kind), fn, args, donate_argnums=donate,
                         config_fingerprint=self.config_fp,
                         static_meta=self.static_meta(kind), session=session,
                         mesh=self.device_mesh)
        self.sessions.append((kind, session.report()))
        return rec

    def variants(self, *, seqs=None, kinds=KINDS):
        """Campaign work-list for this workload's shape variants:
        ``(Workload, kind)`` items covering every prefill ``seq`` bucket
        in ``seqs`` (sibling workloads sharing every other shape) plus
        the seq-independent kinds — feed to ``Workspace.campaign``.
        ``seqs=None`` keeps just this workload's own seq."""
        items = []
        for kind in kinds:
            if kind != "prefill":
                items.append((self, kind))
                continue
            for s in (seqs if seqs is not None else [self.seq]):
                wl = self if s == self.seq else self.ws.workload(
                    self.cfg, cache_len=self.cache_len,
                    block_k=self.block_k, batch=self.batch,
                    prefill_batch=self.prefill_batch, seq=s,
                    eos_id=self.eos_id)
                items.append((wl, "prefill"))
        return items

    # -------------------------------------------------------------- replay --
    def replay(self, kind: str = "prefill", *, passes=None,
               artifact: Optional[Recording] = None,
               jobs: Optional[int] = None) -> dict:
        """Replay-side interaction-plan execution: compact the recording's
        plan with the replay passes (``None`` -> the workspace default)
        and play it through a ``PlanExecutor`` over a fresh emulator on
        the workspace's link profile — the priced counterpart of
        ``record()``.  Returns the executor report (also appended to
        ``self.replays`` for ``report()``)."""
        from repro_torch.core.replay_passes import PlanExecutor, plan_for
        rec = artifact if artifact is not None else self.compile(kind)
        kind = rec.manifest.get("static", {}).get("kind", kind)
        passes = self.ws.replay_passes if passes is None else passes
        plan = plan_for(rec, passes, jobs=jobs)
        rep = PlanExecutor(netem=self.ws.fresh_netem(),
                           tracer=self.ws.tracer).run(plan)
        self.replays.append((kind, rep))
        return rep

    def attested_replay(self, kind: str = "prefill", *, passes=None,
                        jobs: Optional[int] = None,
                        record_on_miss: bool = False):
        """The end-to-end attested lifecycle leg: proof-verified registry
        fetch (inclusion + consistency against the signed root), verified
        replay-plan execution, and a signed QUOTE binding what ran to
        what was published.  Returns ``(report, quote, proof_bundle)`` —
        the quote + bundle verify offline via
        ``repro_torch.attest.verifier.verify_quote`` with no model or
        registry imports on the verifier side."""
        from repro_torch.core.replay_passes import (PlanExecutor,
                                                    verified_plan)
        reg_key = self.key(kind)
        record_fn = self._record_fn(kind, reg_key) if record_on_miss \
            else None
        blob = self.ws.client.fetch(reg_key, record_fn=record_fn)
        passes = self.ws.replay_passes if passes is None else passes
        plan, _rec = verified_plan(blob, self.ws.key, passes, jobs=jobs)
        ex = PlanExecutor(netem=self.ws.fresh_netem(), tracer=self.ws.tracer)
        rep = ex.run(plan)
        self.replays.append((kind, rep))
        head = self.ws.service.signed_head()
        quote = ex.quote(self.ws.keys, recording_key=reg_key, head=head)
        bundle = self.ws.service.proof_for(reg_key)
        self.ws.quotes.append(quote)
        return rep, quote, bundle

    # ------------------------------------------------------------ registry --
    def publish(self, rec: Recording, key: Optional[str] = None) -> dict:
        """Publish into the workspace registry under the canonical key
        (derived from the recording's own static meta), signing with the
        workspace key if the recording is unsigned.  Returns the
        service's wire stats (delta-published)."""
        if not rec.signature:
            rec.sign_with(self.ws.key)
        return self.ws.service.publish(key or self._key_of(rec), rec)

    def _key_of(self, rec: Recording) -> str:
        """Canonical registry key recomputed from the recording's OWN
        identity — static meta, config/mesh fingerprints, and (when the
        recording's name is itself a canonical key) its arch — NOT this
        workload's shapes, so publishing a foreign recording files it
        under its own identity instead of silently shadowing this one."""
        static = rec.manifest.get("static") or {}
        kind = static.get("kind")
        mesh = rec.manifest.get("mesh")
        name = rec.manifest.get("name", "")
        if kind not in KINDS or mesh is None:
            return name
        parts = name.split("/")
        arch = parts[0] if len(parts) == 3 and parts[1] == kind \
            else self.cfg.name
        return key_for(arch, kind,
                       {**static,
                        "config_fp": rec.manifest.get("config_fingerprint",
                                                      "")},
                       fingerprint(mesh))

    def _record_fn(self, kind: str, reg_key: str):
        """Record-on-miss closure: the service's single-flight lease
        supplies the session, so the miss records through the service's
        configured link profile with THIS workload's exact shapes (zeros
        as the export's example inputs)."""
        static = self.static_meta(kind)

        def record_fn(session=None):
            fn, args, donate = self.step(kind)
            return record(reg_key, fn, args, donate_argnums=donate,
                          config_fingerprint=self.config_fp,
                          static_meta=static, session=session,
                          mesh=self.device_mesh)
        return record_fn

    def fetch(self, kind: str = "prefill", *, record_on_miss: bool = False,
              interrupt_after: Optional[int] = None) -> bytes:
        """Chunked/resumable fetch of this workload's recording; the
        returned bytes are HMAC- and proof-verified BEFORE they can reach
        ``torch.export.load``.  ``record_on_miss`` records through the
        service's single-flight lease."""
        reg_key = self.key(kind)
        record_fn = self._record_fn(kind, reg_key) if record_on_miss else None
        return self.ws.client.fetch(reg_key, record_fn=record_fn,
                                    interrupt_after=interrupt_after)

    # ------------------------------------------------------------- serving --
    def _usable(self, meta: dict, static: dict, topo: str) -> bool:
        """An alternate published shape of this workload is substitutable
        iff the engine-visible shapes agree (prefill seq may differ: the
        engine adapts via fixed_prompt_len; decode ignores seq; a
        non-default eos_id is baked into the decode program) AND it was
        recorded for this exact model config and hardware topology — a
        foreign-host or differently-sized recording would only fail later
        with TopologyMismatch/ReplayArgumentError."""
        static_meta = meta.get("static", {})
        return (all(static_meta.get(f) == static[f]
                    for f in ("batch", "cache_len", "block_k"))
                and static_meta.get("eos_id") == static.get("eos_id")
                and meta.get("config_fingerprint", "") == self.config_fp
                and meta.get("topology", "") == topo)

    def _registry_channel(self, record_on_miss: bool,
                          client=None) -> ReplayChannel:
        """Boot a ReplayChannel from the workspace registry: fetch-by-key
        (chunked, resumable, netem-billed), verify, preload + warm — a
        replica boots from a registry hit without re-exporting.  On miss,
        an alternate published shape is substituted when usable, else
        ``record_on_miss`` records through the single-flight lease.

        ``client`` selects WHICH RegistryClient boots the channel (its
        own netem span and stats); None keeps the workspace's shared
        one."""
        store, service = self.ws.store, self.ws.service
        topo = topology_fingerprint(self.device)
        items = []
        for kind in KINDS:
            static = self.static_meta(kind)
            reg_key = self.key(kind)
            record_fn = None
            if not service.has(reg_key):
                found = [(store.entry(fk)["meta"], fk) for fk in
                         store.find(f"{key_arch(self.cfg.name)}/{kind}/")]
                found = [(meta.get("published_s", 0.0), fk)
                         for meta, fk in found
                         if self._usable(meta, static, topo)]
                if found:
                    # most recently published alternate wins — find()
                    # sorts by key hash, which would make it arbitrary
                    reg_key = max(found)[1]
                elif record_on_miss:
                    record_fn = self._record_fn(kind, reg_key)
            items.append((reg_key, record_fn))
        rp = Replayer(key=self.ws.key, device=self.device)
        self.replayers.append(rp)
        if client is None:
            client = self.ws.client
        return client.into_channel(rp, items[0], items[1], warm=True)

    def _live_channel(self) -> LiveChannel:
        """Live transport, memoized: every engine/scheduler built from
        this workload shares the same step functions."""
        if self._live is None:
            cfg = self.cfg
            # grouped right-padded admission: attention families only
            # (decode masks rows >= pos; recurrent state is not
            # position-indexed), and SWA ring layout needs true lengths
            batched = None
            if cfg.family in ("dense", "moe") and not cfg.sliding_window:
                batched = ST.make_batched_prefill_step(cfg, self.cache_len)
            self._live = LiveChannel(
                ST.make_prefill_step(cfg, self.cache_len),
                ST.make_fused_decode_step(cfg, k=self.block_k,
                                          eos_id=self.eos_id), batched)
        return self._live

    def channel(self, *, recordings_dir: str = "",
                record_on_miss: bool = False,
                bill_dispatches: bool = False, client=None):
        """The ExecutionChannel this workload serves through: verified
        registry replay when the workspace has a registry, flat-file
        replay when ``recordings_dir`` is given, live steps otherwise.
        ``bill_dispatches`` wraps with the netem-billed transport;
        ``client`` boots the registry channel through a specific
        ``RegistryClient`` instead of the shared workspace client."""
        if recordings_dir and self.ws.has_registry:
            raise ValueError(
                "both a workspace registry and recordings_dir were given; "
                "recordings come from exactly one source — use a registry-"
                "less Workspace for flat-file replay")
        if client is not None and not self.ws.has_registry:
            raise ValueError("channel(client=...) requires a workspace "
                             "registry: only registry channels fetch")
        if self.ws.has_registry:
            ch = self._registry_channel(record_on_miss, client=client)
        elif recordings_dir:
            rp = Replayer(key=self.ws.key, device=self.device)
            self.replayers.append(rp)
            pre, dec = (rp.load(os.path.join(
                recordings_dir, recording_name(self.cfg.name, kind)))
                for kind in KINDS)
            rp.warm(dec)    # decode joins the pipeline with no cold start
            ch = ReplayChannel(rp, pre, dec)
        else:
            ch = self._live_channel()
        if bill_dispatches:
            ch = NetemBilledChannel(ch, self.ws.netem)
        return ch

    def stream_kwargs(self, *, speculate: bool = True,
                      pipeline_depth: int = 4) -> dict:
        return stream_kwargs(self.cfg, n_slots=self.batch,
                             cache_len=self.cache_len, block_k=self.block_k,
                             eos_id=self.eos_id, speculate=speculate,
                             pipeline_depth=pipeline_depth,
                             device=self.device)

    def engine(self, params=None, *, seed: int = 0, channel=None,
               recordings_dir: str = "", record_on_miss: bool = False,
               bill_dispatches: bool = False, speculate: bool = True,
               pipeline_depth: int = 4) -> Engine:
        """One-stream serving behind the classic ``Engine`` facade,
        wired through this workload's channel and the workspace netem.
        ``params`` (a ParamTree, or the tree a replay channel takes)
        default to ``self.params(seed)``."""
        if channel is None:
            channel = self.channel(recordings_dir=recordings_dir,
                                   record_on_miss=record_on_miss,
                                   bill_dispatches=bill_dispatches)
        if params is None:
            params = self.params(seed)
        eng = Engine(channel_params(channel, params), channel=channel,
                     netem=self.ws.netem, tracer=self.ws.tracer,
                     **self.stream_kwargs(speculate=speculate,
                                          pipeline_depth=pipeline_depth))
        eng.registry_client = self.ws.registry_client
        return eng

    # ----------------------------------------------------------- reporting --
    def replayer_stats(self) -> dict:
        """Summed counters over every Replayer this workload built —
        the fast-path hit/validation split the serving report surfaces."""
        totals: dict = {}
        for rp in self.replayers:
            for k, v in rp.stats.items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def report(self) -> dict:
        return {"arch": self.cfg.name,
                "keys": dict(self._keys),
                "sessions": [dict(rep, kind=kind)
                             for kind, rep in self.sessions],
                "replays": [dict(rep, kind=kind)
                            for kind, rep in self.replays],
                "replayer_stats": self.replayer_stats()}


__all__ = ["KINDS", "Workload", "static_meta_for", "build_step",
           "recording_name", "stream_kwargs", "channel_params",
           "format_session_report"]
