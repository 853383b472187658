"""prefill_ms: device milliseconds per replayed prefill in the traced
window: the device time launched from ``portbench.prefill`` spans, over
those spans."""


def read(ctx):
    if ctx.trace is None:
        return None
    n = ctx.trace["calls"].get("portbench.prefill", 0)
    if not n:
        return None
    return 1e3 * ctx.trace["by_span"].get("portbench.prefill", 0.0) / n
