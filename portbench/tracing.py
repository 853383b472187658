"""What a traced window's profile says: device time by kernel, by the
harness span that launched it, the device's busy time, and where the host
was while the device idled.

The harness labels its own calls with ``record_function``: the window
(``portbench.window``), each ``step_block`` and ``validate``, the client
bookkeeping (``portbench.client``), the wait for the next arrival
(``portbench.wait``), and inside ``step_block`` each replayed
prefill and decode block (``portbench.prefill``,
``portbench.decode_block``).  A device operation belongs to the span in
which its launch (the CUDA runtime call with the same correlation id) was
made.  Only these summaries are kept, never the whole trace."""
from __future__ import annotations

import bisect
import collections

from torch.autograd import DeviceType

PREFIX = "portbench."
WINDOW = PREFIX + "window"
LAUNCH_SPANS = (PREFIX + "prefill", PREFIX + "decode_block")


def short_name(name: str) -> str:
    """A kernel's name without its return type and template arguments;
    the int8-cache form of a kernel (``signed char`` among its template
    arguments) is marked ``[int8]``."""
    tag = "[int8]" if "signed char" in name else ""
    name = name.removeprefix("void ")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut][:96] + tag


def _union(intervals):
    """Merged, sorted, disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(spans):
    """Nested host spans -> [(start, end, label)] of the innermost label
    in force, covering the spans' union."""
    points = sorted({t for s, e, _ in spans for t in (s, e)})
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out, stack, j = [], [], 0
    for a, b in zip(points, points[1:]):
        while j < len(spans) and spans[j][0] <= a:
            stack.append(spans[j])
            j += 1
        stack = [s for s in stack if s[1] > a]
        if stack:
            inner = min(stack, key=lambda s: s[1] - s[0])
            out.append((a, b, inner[2]))
    return out


def summarize(prof) -> dict:
    events = prof.profiler.kineto_results.events()
    kernels, launches, spans, window = [], {}, [], None
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # the device-side copies of the harness's own labels are no work
            if not name.startswith(PREFIX):
                kernels.append((ev.start_ns(), ev.end_ns(), name,
                                ev.correlation_id()))
        elif name == WINDOW:
            window = (ev.start_ns(), ev.end_ns())
        elif name.startswith(PREFIX):
            spans.append((ev.start_ns(), ev.end_ns(), name))
        elif name.startswith("cu") and ev.correlation_id():
            launches[ev.correlation_id()] = ev.start_ns()
    if window is None:
        raise RuntimeError("the profile holds no portbench.window span")
    w0, w1 = window
    kernels = [k for k in kernels if k[1] > w0 and k[0] < w1]
    busy = _union((max(s, w0), min(e, w1)) for s, e, _, _ in kernels)
    busy_ns = sum(e - s for s, e in busy)

    by_kernel = collections.Counter()
    for s, e, name, _ in kernels:
        by_kernel[short_name(name)] += (e - s) / 1e9

    # device time and calls per launching span
    launch_spans = sorted((s, e, n) for s, e, n in spans if n in LAUNCH_SPANS)
    starts = [s for s, _, _ in launch_spans]
    span_dev = collections.Counter()
    for s, e, name, corr in kernels:
        t = launches.get(corr)
        label = "other"
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and launch_spans[i][1] >= t:
                label = launch_spans[i][2]
        span_dev[label] += (e - s) / 1e9
    calls = collections.Counter(n for s, e, n in spans if w0 <= s < w1)

    # idle time by what the host was doing
    host = _innermost([(max(s, w0), min(e, w1), n) for s, e, n in spans
                       if e > w0 and s < w1])
    idle = collections.Counter()
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    j = 0
    for a, b in gaps:
        while j < len(host) and host[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(host) and host[k][0] < b:
            o = min(b, host[k][1]) - max(a, host[k][0])
            if o > 0:
                idle[host[k][2]] += o / 1e9
                covered += o
            k += 1
        if (b - a) - covered > 0:
            idle["none"] += ((b - a) - covered) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "kernels": len(kernels), "by_kernel": dict(by_kernel),
            "by_span": dict(span_dev),
            "calls": dict(calls), "idle_by_host": dict(idle),
            "launches_seen": len(launches)}


def device_seconds(summary: dict, include, exclude=()) -> float:
    """Device seconds of the kernels whose name holds every string of
    ``include`` and none of ``exclude``."""
    return sum(t for name, t in summary["by_kernel"].items()
               if all(s in name for s in include)
               and not any(s in name for s in exclude))


def breakdown(summary: dict) -> dict:
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:10]]
    return {"device_ops": top(summary["by_kernel"]),
            "idle_gaps": top(summary["idle_by_host"])}
