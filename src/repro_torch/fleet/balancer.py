"""LoadBalancer — front-end placement + admission control for a replica
fleet.

The balancer owns the front-end queue: every arrival is ``offer()``-ed,
admission control rejects on queue pressure (an open-loop generator does
not stop arriving because the fleet is full — shedding load is the only
way to protect the tail of admitted requests), and ``dispatch()`` places
queued arrivals onto replicas that can accept them.

Placement policies (``POLICIES``):
  * ``round_robin``   — rotate a cursor over ready replicas; the baseline.
  * ``least_loaded``  — place on the replica with the fewest outstanding
    requests (ties broken by name for determinism).
  * ``cache_affinity``— pin each tenant (= recording key) to one replica
    so its executable/weights/KV working set stays hot; first placement
    is least-loaded, after that sticky.  An arrival whose pinned replica
    is full WAITS rather than spilling — that queueing-vs-locality trade
    is exactly what the policy comparison in ``BENCH_fleet.json`` shows.

Everything is deterministic: FIFO-with-skip scan order, name-tiebroken
argmins, no randomness.  Counterpart of ``repro/fleet/balancer.py``.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

from repro_torch.fleet.traffic import Arrival

POLICIES = ("round_robin", "least_loaded", "cache_affinity")


class LoadBalancer:
    def __init__(self, policy: str = "round_robin", *,
                 queue_limit: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy '{policy}', "
                             f"expected one of {POLICIES}")
        self.policy = policy
        self.queue_limit = queue_limit
        self.queue: collections.deque = collections.deque()
        self.stats = collections.Counter()
        self._rr_cursor = 0
        self._affinity: Dict[str, str] = {}   # tenant -> replica name

    # ---------------------------------------------------------- admission --
    def offer(self, arrival: Arrival) -> bool:
        """Admission control at the front door: reject when the front-end
        queue is at its limit (load shedding), else enqueue."""
        self.stats["offered"] += 1
        if self.queue_limit is not None and \
                len(self.queue) >= self.queue_limit:
            self.stats["rejected"] += 1
            return False
        self.queue.append(arrival)
        if len(self.queue) > self.stats["queue_hwm"]:
            self.stats["queue_hwm"] = len(self.queue)
        return True

    def queue_depth(self) -> int:
        return len(self.queue)

    # ---------------------------------------------------------- placement --
    def _pick(self, arrival: Arrival, candidates: List) -> Optional[object]:
        """Choose a replica among those that can accept this arrival."""
        if not candidates:
            return None
        if self.policy == "round_robin":
            pick = candidates[self._rr_cursor % len(candidates)]
            self._rr_cursor += 1
            return pick
        if self.policy == "least_loaded":
            return min(candidates, key=lambda r: (r.load(), r.name))
        # cache_affinity: sticky tenant -> replica pin
        pinned = self._affinity.get(arrival.tenant)
        if pinned is not None:
            for r in candidates:
                if r.name == pinned:
                    return r
            return None   # pinned replica exists but is full/absent: wait
        pick = min(candidates, key=lambda r: (r.load(), r.name))
        self._affinity[arrival.tenant] = pick.name
        return pick

    def forget(self, replica_name: str):
        """Drop affinity pins to a retired replica so its tenants re-pin."""
        for tenant in [t for t, n in self._affinity.items()
                       if n == replica_name]:
            del self._affinity[tenant]

    def dispatch(self, replicas: Sequence) -> List[tuple]:
        """Place queued arrivals onto replicas: FIFO with skip — an
        arrival that no replica can accept right now stays queued (head-of-
        line arrivals for a full tenant must not block other tenants).
        Returns the ``(arrival, replica)`` placements made this call."""
        placements = []
        still: collections.deque = collections.deque()
        while self.queue:
            arrival = self.queue.popleft()
            live = [r for r in replicas if r.can_accept(arrival.tenant)]
            # pinned-policy arrivals only consider their pin (handled in
            # _pick); others take any accepting replica
            pick = self._pick(arrival, live)
            if pick is None:
                still.append(arrival)
                continue
            pick.submit(arrival)
            placements.append((arrival, pick))
            self.stats["placed"] += 1
        self.queue = still
        return placements

    # ---------------------------------------------------------- reporting --
    def snapshot(self) -> dict:
        return {
            "policy": self.policy,
            "queue_limit": self.queue_limit,
            "queue_depth": len(self.queue),
            "offered": int(self.stats["offered"]),
            "placed": int(self.stats["placed"]),
            "rejected": int(self.stats["rejected"]),
            "queue_hwm": int(self.stats["queue_hwm"]),
        }


__all__ = ["LoadBalancer", "POLICIES"]
