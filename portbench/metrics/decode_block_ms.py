"""decode_block_ms: device milliseconds per replayed decode block in the
traced window: the device time of every operation launched from the
harness's ``portbench.decode_block`` spans (the graph replay and the
replayer's copies in and out), over those spans."""


def read(ctx):
    if ctx.trace is None:
        return None
    n = ctx.trace["calls"].get("portbench.decode_block", 0)
    if not n:
        return None
    return 1e3 * ctx.trace["by_span"].get("portbench.decode_block", 0.0) / n
