"""mfu.decode: model FLOPs of the decode tokens committed in the window
(``counts/flops.py``: every weight a token meets, attention over its keys)
over the window's seconds times the card's bf16 peak, in percent."""
from portbench.counts import flops, peaks


def read(ctx):
    if not ctx.on_card or not ctx.decode_ctx:
        return None
    total = sum(flops.decode_token(ctx.shapes, c) for c in ctx.decode_ctx)
    return 100.0 * total / (ctx.window_s * peaks.BF16_FLOPS)
