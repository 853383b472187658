"""ReplicaPool — N replay-serving replicas behind one LoadBalancer on a
deterministic tick clock.

A ``Replica`` wraps one ``Scheduler`` (its own channels, params, caches,
netem billing span — nothing shared with its siblings except the
registry it booted from).  The pool advances a virtual tick clock: each
tick injects due arrivals into the balancer, dispatches placements, lets
every ready replica with work step one scheduler round, then collects
completions — a finished request's latency is (collect clock − arrival
time), observed into ``repro_torch.obs.metrics`` per tenant.  Because both the
traffic and the tick loop are deterministic, the whole fleet run is
replayable byte-for-byte.

Elasticity:
  * scale-up — front-end queue depth at/above ``queue_high`` for
    ``sustain_ticks`` consecutive ticks boots a new replica via the
    factory; it becomes ready ``boot_ticks`` later (a FIXED policy knob,
    not the measured boot time, so the serving timeline never depends on
    nondeterministic executable payload sizes).
  * drain-then-retire — a replica idle for ``idle_ticks`` stops
    accepting (drains), finishes what it holds, then retires; the
    balancer drops its affinity pins so tenants re-pin.
  * migration — ``migrate(tenant, src, dst)`` preempts the tenant's
    active requests on ``src`` (committed tails survive), releases its
    queue, and ``adopt()``s everything on ``dst``; deterministic decode
    resumes each stream bit-exactly (the preempt/resume invariant the
    serving tests already pin, now across replicas).

Counterpart of ``repro/fleet/pool.py``.  The pool steps its replicas
one after another from one host thread, each on the current CUDA stream:
the decode-attention kernel's arrival counters are one buffer per device,
so two replicas must never launch it on two streams at once.
"""
from __future__ import annotations

import collections
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.balancer import LoadBalancer
from repro_torch.fleet.traffic import Arrival


class Replica:
    """One serving replica: a Scheduler plus fleet-side bookkeeping.

    ``boot_virtual_s`` is the netem-billed virtual time its boot cost
    (registry fetch + warm-up on its OWN emulator span) — reported, never
    fed back into the tick clock.  ``pending_limit`` bounds outstanding
    requests (slot pressure admission: the balancer's ``can_accept``)."""

    def __init__(self, name: str, scheduler, *, netem=None,
                 boot_virtual_s: float = 0.0, region: int = 0,
                 pending_limit: int = 8, validate_every: int = 1):
        self.name = name
        self.scheduler = scheduler
        self.netem = netem
        self.boot_virtual_s = boot_virtual_s
        self.region = region
        self.pending_limit = pending_limit
        self.validate_every = validate_every
        self.ready_at = 0.0
        self.draining = False
        self.retired = False
        self.served = 0
        self.stats = collections.Counter()
        self._open: Dict[Tuple[str, int], int] = {}  # (tenant, rid) -> gid
        self._outstanding = 0

    # ------------------------------------------------------------- states --
    def ready(self, clock: float) -> bool:
        return not self.retired and self.ready_at <= clock

    def tenants(self) -> Tuple[str, ...]:
        return tuple(self.scheduler.streams)

    def can_accept(self, tenant: str) -> bool:
        return (not self.draining and not self.retired
                and tenant in self.scheduler.streams
                and self._outstanding < self.pending_limit)

    def load(self) -> int:
        return self._outstanding

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # -------------------------------------------------------------- serve --
    def submit(self, arrival: Arrival) -> int:
        rid = self.scheduler.submit(arrival.tenant, list(arrival.prompt),
                                    arrival.max_new)
        self._open[(arrival.tenant, rid)] = arrival.gid
        self._outstanding += 1
        self.stats["submitted"] += 1
        return rid

    def step(self) -> int:
        self.stats["ticks_stepped"] += 1
        return self.scheduler.step(validate_every=self.validate_every)

    def collect_done(self) -> List[Tuple[int, str, List[int], bool]]:
        """Newly finished requests as (gid, tenant, tokens, failed)."""
        done = []
        for (tenant, rid), gid in list(self._open.items()):
            req = self.scheduler.streams[tenant].requests.get(rid)
            if req is not None and req.done:
                done.append((gid, tenant, list(req.generated), req.failed))
                del self._open[(tenant, rid)]
                self._outstanding -= 1
                self.served += 1
        return done

    def finish(self):
        """Final frontier drains so every in-flight tail commits."""
        for ex in self.scheduler.streams.values():
            self.scheduler.frontier.drain(ex)

    # ---------------------------------------------------------- migration --
    def release(self, tenant: str) -> List[Tuple[int, object]]:
        """Preempt + hand over every open request of ``tenant`` as
        (gid, Request) pairs — committed tails included — for another
        replica to ``adopt()``."""
        ex = self.scheduler.streams[tenant]
        if ex.slots.active_mask().any():
            self.scheduler.preempt(tenant)
        released = []
        for req in ex.release_pending():
            gid = self._open.pop((tenant, req.rid))
            self._outstanding -= 1
            released.append((gid, req))
        self.stats["released"] += len(released)
        return released

    def adopt(self, tenant: str, gid: int, req) -> int:
        rid = self.scheduler.streams[tenant].adopt(req)
        self._open[(tenant, rid)] = gid
        self._outstanding += 1
        self.stats["adopted"] += 1
        return rid

    # ---------------------------------------------------------- reporting --
    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "region": self.region,
            "boot_virtual_s": round(self.boot_virtual_s, 6),
            "ready_at": round(self.ready_at, 9),
            "draining": self.draining,
            "retired": self.retired,
            "served": self.served,
            "outstanding": self._outstanding,
        }


class ReplicaPool:
    """The fleet: replicas from ``factory(idx)`` behind one balancer.

    ``factory`` builds a fully booted ``Replica`` (``Workspace.fleet``
    supplies one that boots warm from the registry on its own netem
    span).  ``run(arrivals)`` simulates open-loop serving to completion
    and returns ``{gid: tokens}``."""

    def __init__(self, factory: Callable[[int], Replica], *,
                 replicas: int = 2, policy: str = "round_robin",
                 balancer: Optional[LoadBalancer] = None,
                 name: str = "fleet", tick_s: float = 0.02,
                 queue_limit: Optional[int] = None,
                 autoscale: bool = False, queue_high: int = 8,
                 sustain_ticks: int = 5, idle_ticks: int = 50,
                 boot_ticks: int = 10, min_replicas: int = 1,
                 max_replicas: int = 8, metrics=None,
                 labels: Optional[dict] = None, max_ticks: int = 500_000):
        self.factory = factory
        self.name = name
        self.tick_s = tick_s
        self.balancer = balancer if balancer is not None else \
            LoadBalancer(policy, queue_limit=queue_limit)
        self.autoscale = autoscale
        self.queue_high = queue_high
        self.sustain_ticks = sustain_ticks
        self.idle_ticks = idle_ticks
        self.boot_ticks = boot_ticks
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.metrics = metrics
        self.labels = dict(labels or {})
        self.max_ticks = max_ticks
        self.replicas: List[Replica] = []
        self._idx = 0
        self._idle: Dict[str, int] = {}
        for _ in range(replicas):
            self._add_replica(ready_at=0.0)
        self.clock = 0.0
        self.ticks = 0
        self.outputs: Dict[int, List[int]] = {}
        self.failed: set = set()
        self.latency: Dict[int, float] = {}
        self.counters = collections.Counter()
        self._arrival_t: Dict[int, float] = {}
        self._sustain = 0

    # ----------------------------------------------------------- replicas --
    def _add_replica(self, *, ready_at: float) -> Replica:
        r = self.factory(self._idx)
        self._idx += 1
        r.ready_at = ready_at
        self.replicas.append(r)
        self._idle[r.name] = 0
        return r

    def replica(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(name)

    def _alive(self) -> List[Replica]:
        return [r for r in self.replicas if not r.retired]

    # ---------------------------------------------------------- migration --
    def migrate(self, tenant: str, src_name: str, dst_name: str) -> int:
        """Move every open request of ``tenant`` from ``src`` to ``dst``
        (preempt → release → adopt); returns how many moved."""
        src, dst = self.replica(src_name), self.replica(dst_name)
        released = src.release(tenant)
        for gid, req in released:
            dst.adopt(tenant, gid, req)
        self.counters["migrations"] += 1
        self.counters["migrated_requests"] += len(released)
        return len(released)

    def drain(self, name: str):
        """Stop placing on a replica; it finishes its work then retires."""
        self.replica(name).draining = True

    # --------------------------------------------------------------- loop --
    def _inject(self, arrivals: Sequence[Arrival], i: int) -> int:
        while i < len(arrivals) and arrivals[i].t <= self.clock:
            a = arrivals[i]
            i += 1
            if self.balancer.offer(a):
                self._arrival_t[a.gid] = a.t
        return i

    def _collect(self, r: Replica):
        for gid, tenant, tokens, fail in r.collect_done():
            self.outputs[gid] = tokens
            lat = self.clock - self._arrival_t[gid]
            self.latency[gid] = lat
            if fail:
                self.failed.add(gid)
                continue
            if self.metrics is not None:
                self.metrics.histogram("fleet_request_latency_s",
                                       tenant=tenant,
                                       **self.labels).observe(lat)
                self.metrics.counter("fleet_requests_served", tenant=tenant,
                                     **self.labels).inc()

    def _can_scale_up(self) -> bool:
        return self.autoscale and len(self._alive()) < self.max_replicas

    def _autoscale_tick(self):
        if self.balancer.queue_depth() >= self.queue_high:
            self._sustain += 1
        else:
            self._sustain = 0
        if self._sustain >= self.sustain_ticks and self._can_scale_up():
            self._add_replica(
                ready_at=self.clock + self.boot_ticks * self.tick_s)
            self.counters["scale_ups"] += 1
            self._sustain = 0
        # drain-then-retire on sustained idleness
        for r in self._alive():
            if not r.ready(self.clock) or r.has_work() or \
                    self.balancer.queue_depth():
                self._idle[r.name] = 0
                continue
            self._idle[r.name] += 1
            non_draining = [x for x in self._alive() if not x.draining]
            if not r.draining and self._idle[r.name] >= self.idle_ticks \
                    and len(non_draining) > self.min_replicas:
                r.draining = True
        for r in self._alive():
            if r.draining and not r.has_work() and r.load() == 0:
                r.retired = True
                self.balancer.forget(r.name)
                self.counters["retired"] += 1

    def _fast_forward(self, arrivals: Sequence[Arrival], i: int):
        """Nothing stepped this tick: jump the clock (on the tick grid) to
        the next event instead of spinning — unless the queue is waiting
        on a sustain-triggered scale-up, which counts real ticks."""
        booting = [r.ready_at for r in self._alive()
                   if r.ready_at > self.clock]
        targets = list(booting)
        if i < len(arrivals):
            targets.append(arrivals[i].t)
        if self.balancer.queue_depth():
            if booting:
                t = min(targets)
            elif self._can_scale_up():
                return           # tick normally; sustain fires the scale-up
            else:
                stuck = sorted({a.tenant for a in self.balancer.queue})
                raise RuntimeError(
                    f"fleet '{self.name}' deadlocked: queued tenants "
                    f"{stuck} have no replica that can ever accept them")
        elif targets:
            t = min(targets)
        else:
            return
        if t > self.clock:
            n = math.ceil((t - self.clock) / self.tick_s - 1e-9)
            self.clock += n * self.tick_s
            self.counters["ticks_skipped"] += n

    def run(self, arrivals: Sequence[Arrival]) -> Dict[int, List[int]]:
        """Serve an arrival list to completion; returns {gid: tokens}
        (rejected arrivals never appear)."""
        arrivals = sorted(arrivals, key=lambda a: (a.t, a.gid))
        self.counters["arrivals"] += len(arrivals)
        i = 0
        while True:
            i = self._inject(arrivals, i)
            if i >= len(arrivals) and not self.balancer.queue_depth() and \
                    not any(r.has_work() for r in self._alive()):
                break
            ready = [r for r in self.replicas if r.ready(self.clock)]
            self.balancer.dispatch(ready)
            stepped = 0
            for r in ready:
                if r.has_work():
                    r.step()
                    stepped += 1
            self.clock += self.tick_s
            self.ticks += 1
            for r in ready:
                self._collect(r)
            if self.autoscale:
                self._autoscale_tick()
            if not stepped:
                self._fast_forward(arrivals, i)
            if self.ticks > self.max_ticks:
                raise RuntimeError(
                    f"fleet '{self.name}' exceeded max_ticks="
                    f"{self.max_ticks} (queue="
                    f"{self.balancer.queue_depth()}, served="
                    f"{len(self.outputs)})")
        for r in self._alive():
            r.finish()
            self._collect(r)
        return self.outputs

    # ---------------------------------------------------------- reporting --
    def stats(self) -> dict:
        """Pool accounting; shape pinned by
        ``repro_torch.obs.schema.check_fleet_stats``."""
        return {
            "name": self.name,
            "policy": self.balancer.policy,
            "tick_s": self.tick_s,
            "ticks": self.ticks,
            "virtual_time_s": round(self.clock, 9),
            "arrivals": int(self.counters["arrivals"]),
            "served": len(self.outputs),
            "failed": len(self.failed),
            "migrations": int(self.counters["migrations"]),
            "balancer": self.balancer.snapshot(),
            "autoscale": {
                "enabled": self.autoscale,
                "scale_ups": int(self.counters["scale_ups"]),
                "retired": int(self.counters["retired"]),
            },
            "replicas": [r.snapshot() for r in self.replicas],
        }


__all__ = ["Replica", "ReplicaPool"]
