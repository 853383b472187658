"""serve.host_syncs_per_block: the engine's host<->device syncs per decode
block dispatched in the window (``Engine.stats``)."""


def read(ctx):
    blocks = ctx.stats.get("blocks_dispatched", 0)
    if not blocks:
        return None
    return ctx.stats.get("host_syncs", 0) / blocks
