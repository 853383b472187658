"""Virtual-time tracing — the evidence layer for every headline number.

Every claim this repro makes (95% fewer recording delays, replay 25%
faster than native, frontier-only host syncs) is an *attribution* claim
about where round trips and virtual time go.  The ``Tracer`` turns the
scattered counters into one timeline: spans and instant events stamped
on the **deterministic virtual clock** (``NetworkEmulator.virtual_time_s``
— wall time rides along as secondary metadata), exported as Chrome
trace-event JSON that Perfetto / ``chrome://tracing`` loads directly.

Design constraints, in order:

  * **Deterministic.**  Two traced runs of the same workload produce
    byte-identical traces once wall timestamps are stripped
    (``to_json(strip_wall=True)``) — the replay-side analogue of the
    bit-exactness flags the benchmarks pin.  Nothing in here calls a
    nondeterministic source except ``time.time()`` for the secondary
    wall fields.
  * **Zero-cost when off.**  ``NULL`` (a falsy ``NullTracer``) is what
    every component holds by default; call sites guard hot paths with
    ``if tracer:`` or the ``traced()`` helper.  Tracing never mutates an
    emulator, a session, or a stats counter — it only *reads* the
    virtual clock — so all accounting is bit-identical whether tracing
    is on, off, or absent.
  * **Multi-clock.**  Components that own their own emulator (a record
    session, a replay plan executor) enter a ``clock_scope(netem)``:
    their events are stamped by *that* emulator's virtual clock, rebased
    onto the trace's high-water mark so consecutive sessions lay out
    end-to-end instead of piling up at t=0.

Event vocabulary (Chrome trace phases): ``X`` complete spans (duration =
virtual time elapsed inside), ``i`` instants, ``C`` counter samples.
Tracks (one Perfetto thread lane each): ``record``, ``replay``,
``registry``, ``serve.<stream>``, ``sched``.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, List, Optional


class _NullSpan:
    """Reusable no-op context manager (the body still runs)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Falsy do-nothing tracer: ``if tracer:`` guards make tracing
    provably zero-cost when off.  Every component defaults to ``NULL``
    so call sites never need None checks."""

    __slots__ = ()
    events: tuple = ()

    def __bool__(self) -> bool:
        return False

    def now(self) -> float:
        return 0.0

    def span(self, name, track="main", **args):
        return _NULL_SPAN

    def clock_scope(self, netem):
        return _NULL_SPAN

    def instant(self, name, track="main", **args) -> None:
        pass

    def counter(self, name, value, track="main") -> None:
        pass

    def mark(self) -> int:
        return 0


NULL = NullTracer()


def traced(tracer, name, track="main", **args):
    """One-line guard helper: a real span when tracing is on, the shared
    null context manager when off — so hot paths pay one truthiness
    check and nothing else."""
    return tracer.span(name, track, **args) if tracer else _NULL_SPAN


class Tracer:
    """Deterministic virtual-time span/event recorder.

    ``clock`` is a zero-arg callable returning the current virtual time
    in seconds (typically ``lambda: netem.virtual_time_s``); omitted, the
    base clock is a constant 0 — spans still nest and count, with wall
    time as the only moving timestamp (kept out of the deterministic
    export).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.events: List[dict] = []
        self._clocks: List[Callable[[], float]] = [
            clock if clock is not None else (lambda: 0.0)]
        self._hwm = 0.0                 # latest virtual timestamp emitted
        self._t0_wall = time.time()

    def __bool__(self) -> bool:
        return True

    # --------------------------------------------------------------- time --
    def now(self) -> float:
        return float(self._clocks[-1]())

    @contextlib.contextmanager
    def clock_scope(self, netem):
        """Stamp events inside this scope with ``netem``'s virtual clock,
        rebased onto the trace high-water mark (sessions with private
        emulators lay out sequentially instead of overlapping at 0).
        ``netem=None`` is a no-op scope."""
        if netem is None:
            yield self
            return
        base = max(self.now(), self._hwm) - float(netem.virtual_time_s)
        self._clocks.append(lambda: base + float(netem.virtual_time_s))
        try:
            yield self
        finally:
            self._clocks.pop()

    # ------------------------------------------------------------- events --
    def _emit(self, ev: dict) -> None:
        end = ev["ts"] + ev.get("dur", 0.0)
        if end > self._hwm:
            self._hwm = end
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, track: str = "main", **args):
        """A complete span: virtual-time begin/duration measured around
        the body; wall time recorded as secondary metadata."""
        t0 = self.now()
        w0 = time.time()
        try:
            yield self
        finally:
            self._emit({"name": name, "ph": "X", "track": track,
                        "ts": t0, "dur": self.now() - t0,
                        "wall_s": w0 - self._t0_wall,
                        "wall_dur_s": time.time() - w0,
                        "args": args})

    def instant(self, name: str, track: str = "main", **args) -> None:
        self._emit({"name": name, "ph": "i", "track": track,
                    "ts": self.now(),
                    "wall_s": time.time() - self._t0_wall,
                    "args": args})

    def counter(self, name: str, value, track: str = "main") -> None:
        self._emit({"name": name, "ph": "C", "track": track,
                    "ts": self.now(), "value": float(value),
                    "wall_s": time.time() - self._t0_wall,
                    "args": {}})

    def mark(self) -> int:
        """Event-index bookmark; pass as ``since=`` to scope analysis to
        everything recorded after it (per-scenario attribution)."""
        return len(self.events)

    # ----------------------------------------------------------- analysis --
    def spans(self, track: Optional[str] = None, since: int = 0
              ) -> List[dict]:
        return [e for e in self.events[since:]
                if e["ph"] == "X" and (track is None or e["track"] == track)]

    def attributed_s(self, track: Optional[str] = None, since: int = 0
                     ) -> float:
        """Virtual time covered by named spans on ``track``: the measure
        of the union of their ``[ts, ts+dur)`` intervals, so nested and
        overlapping spans never double-count.  Comparing this against a
        session's ``virtual_time_s`` answers "how much of the bill is
        attributed to a named phase?"."""
        ivals = sorted((e["ts"], e["ts"] + e["dur"])
                       for e in self.spans(track, since) if e["dur"] > 0)
        total, end = 0.0, float("-inf")
        for lo, hi in ivals:
            if lo > end:
                total += hi - lo
                end = hi
            elif hi > end:
                total += hi - end
                end = hi
        return total

    def summary(self, top: Optional[int] = None, since: int = 0
                ) -> List[dict]:
        """Per-(track, name) span totals, sorted by virtual time spent —
        the "where did the time go" table."""
        agg: dict = {}
        for e in self.spans(since=since):
            row = agg.setdefault((e["track"], e["name"]),
                                 {"track": e["track"], "name": e["name"],
                                  "count": 0, "virtual_s": 0.0,
                                  "wall_s": 0.0})
            row["count"] += 1
            row["virtual_s"] += e["dur"]
            row["wall_s"] += e["wall_dur_s"]
        rows = sorted(agg.values(),
                      key=lambda r: (-r["virtual_s"], r["track"], r["name"]))
        for r in rows:
            r["virtual_s"] = round(r["virtual_s"], 6)
            r["wall_s"] = round(r["wall_s"], 6)
        return rows[:top] if top is not None else rows

    def format_summary(self, top: int = 15, since: int = 0) -> str:
        rows = self.summary(top=top, since=since)
        if not rows:
            return "(no spans recorded)"
        w = max(len(f"{r['track']}/{r['name']}") for r in rows)
        lines = [f"{'span'.ljust(w)}  {'count':>6}  {'virtual_s':>10}  "
                 f"{'wall_s':>8}"]
        for r in rows:
            lines.append(f"{(r['track'] + '/' + r['name']).ljust(w)}  "
                         f"{r['count']:>6}  {r['virtual_s']:>10.4f}  "
                         f"{r['wall_s']:>8.3f}")
        return "\n".join(lines)

    # ------------------------------------------------------------- export --
    def chrome_trace(self, strip_wall: bool = False) -> dict:
        """Chrome trace-event / Perfetto-loadable JSON object.  Virtual
        seconds become microseconds (``ts``/``dur``); wall timestamps ride
        in ``args`` unless ``strip_wall`` (the determinism test strips
        them and demands byte-identical output across runs)."""
        tids: dict = {}
        out: List[dict] = []
        for ev in self.events:
            tid = tids.setdefault(ev["track"], len(tids) + 1)
            e = {"name": ev["name"], "ph": ev["ph"], "pid": 0, "tid": tid,
                 "cat": ev["track"], "ts": round(ev["ts"] * 1e6, 3),
                 "args": dict(ev["args"])}
            if ev["ph"] == "X":
                e["dur"] = round(ev["dur"] * 1e6, 3)
            elif ev["ph"] == "i":
                e["s"] = "t"
            elif ev["ph"] == "C":
                e["args"] = {"value": ev["value"]}
            if not strip_wall:
                e["args"]["wall_s"] = round(ev["wall_s"], 6)
                if "wall_dur_s" in ev:
                    e["args"]["wall_dur_s"] = round(ev["wall_dur_s"], 6)
            out.append(e)
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": track}}
                for track, tid in sorted(tids.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms",
                "metadata": {"clock": "virtual"}}

    def to_json(self, strip_wall: bool = False) -> str:
        return json.dumps(self.chrome_trace(strip_wall=strip_wall),
                          sort_keys=True, separators=(",", ":"))

    def dump(self, path: str, strip_wall: bool = False) -> str:
        with open(path, "w") as f:
            f.write(self.to_json(strip_wall=strip_wall))
        return path


__all__ = ["Tracer", "NullTracer", "NULL", "traced"]
