"""Network emulator (the paper's NetEm setup, §7.2): a virtual-time model
of the cloud<->client link, so the record-phase ablation reproduces
Fig. 7 / Table 1 quantitatively on any host.  Counterpart of
``repro/core/netem.py``, pure Python and identical in behaviour.  It
never sleeps: ``virtual_time_s`` is the link model's output, not a
measured time.

WiFi-like:     RTT 20 ms, BW 80 Mbps
cellular-like: RTT 50 ms, BW 40 Mbps
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NetProfile:
    name: str
    rtt_s: float
    bw_bytes_s: float


WIFI = NetProfile("wifi", 0.020, 80e6 / 8)
CELLULAR = NetProfile("cellular", 0.050, 40e6 / 8)
LOCAL = NetProfile("local", 2e-6, 10e9)  # same-SoC reference

# the one name -> profile registry every CLI/bench resolves --net through
PROFILES = {p.name: p for p in (LOCAL, WIFI, CELLULAR)}


class NetworkEmulator:
    def __init__(self, profile: NetProfile):
        self.profile = profile
        self.reset()

    def reset(self):
        self.virtual_time_s = 0.0
        self.round_trips = 0          # BLOCKING round trips (paper Table 1)
        self.async_trips = 0          # speculative commits: wire, no stall
        self.bytes_sent = 0
        self.bytes_received = 0
        self.collapsed_spins = 0      # poll spin trips folded into waits

    def round_trip(self, send_bytes: int = 64, recv_bytes: int = 64):
        """One synchronous request/response over the link."""
        self.round_trips += 1
        self.bytes_sent += send_bytes
        self.bytes_received += recv_bytes
        self.virtual_time_s += self.profile.rtt_s + \
            (send_bytes + recv_bytes) / self.profile.bw_bytes_s

    def async_trip(self, send_bytes: int = 256, recv_bytes: int = 64):
        """Asynchronous commit: consumes bandwidth but hides the RTT."""
        self.async_trips += 1
        self.bytes_sent += send_bytes
        self.bytes_received += recv_bytes
        self.virtual_time_s += (send_bytes + recv_bytes) / self.profile.bw_bytes_s

    def collapse_spins(self, n: int):
        """A compacted replay plan folded ``n`` poll spin trips into an
        enclosing completion wait.  The wait's own dispatch is billed
        normally by its commit; this only tracks the trips that did NOT
        cross the wire, so compacted-plan billing spans stay auditable
        against the naive plan (replay-pass ablation)."""
        self.collapsed_spins += int(n)

    def one_way(self, nbytes: int, direction: str = "send"):
        """One streamed transfer.  ``direction`` is from the client's point
        of view: 'send' = client->cloud (upload), 'recv' = cloud->client
        (download, e.g. a registry chunk fetch)."""
        if direction == "send":
            self.bytes_sent += nbytes
        elif direction == "recv":
            self.bytes_received += nbytes
        else:
            raise ValueError(f"direction must be send|recv, got {direction!r}")
        self.virtual_time_s += self.profile.rtt_s / 2 + \
            nbytes / self.profile.bw_bytes_s

    def one_way_recv(self, nbytes: int):
        self.one_way(nbytes, direction="recv")

    ACK_BYTES = 64

    def transfer(self, nbytes: int, chunk_size: int = 65536,
                 direction: str = "recv") -> int:
        """Chunked bulk transfer (registry fetch/publish billing): one
        blocking round trip to set the stream up, then a pipelined flow —
        bandwidth is paid for every byte, the RTT only once, and each chunk
        is acked asynchronously (``ACK_BYTES`` in the opposite direction).
        Returns the number of chunks billed."""
        if nbytes <= 0:
            return 0
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        chunks = -(-nbytes // chunk_size)          # ceil division
        ack_bytes = self.ACK_BYTES * chunks
        if direction == "recv":
            self.bytes_received += nbytes
            self.bytes_sent += ack_bytes
        elif direction == "send":
            self.bytes_sent += nbytes
            self.bytes_received += ack_bytes
        else:
            raise ValueError(f"direction must be send|recv, got {direction!r}")
        self.round_trips += 1
        self.virtual_time_s += self.profile.rtt_s + \
            (nbytes + ack_bytes) / self.profile.bw_bytes_s
        return chunks

    def snapshot(self) -> dict:
        """Public counter snapshot: the ``checkpoint()`` shape (so
        ``async_trips``/``collapsed_spins`` are never dropped) plus a
        combined ``bytes`` total for quick display."""
        d = self.checkpoint()
        d["bytes"] = d["bytes_sent"] + d["bytes_received"]
        return d

    # -- span accounting ---------------------------------------------------
    # ``reset()`` is a global zeroing — unusable by nested consumers (a
    # session pass, registry billing) that need to measure their OWN span
    # of an emulator shared with everyone else.  checkpoint()/delta() are
    # non-destructive: take a mark, do work, subtract.
    def checkpoint(self) -> dict:
        """Full counter snapshot; pass to ``delta()`` to measure a span
        without clobbering global totals."""
        return {"time_s": self.virtual_time_s,
                "round_trips": self.round_trips,
                "async_trips": self.async_trips,
                "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received,
                "collapsed_spins": self.collapsed_spins}

    def delta(self, mark: dict) -> dict:
        """Counters accumulated since ``mark`` (a ``checkpoint()`` result).
        Leaves every global total untouched; spans may nest or overlap
        freely."""
        now = self.checkpoint()
        return {k: now[k] - mark.get(k, 0) for k in now}
