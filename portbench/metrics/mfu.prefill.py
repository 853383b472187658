"""mfu.prefill: model FLOPs of the prefills run in the window (causal, the
next token's logits only) over the window's seconds times the card's bf16
peak, in percent."""
from portbench.counts import flops, peaks


def read(ctx):
    if not ctx.on_card or not ctx.prefill_lens:
        return None
    total = sum(flops.prefill(ctx.shapes, s) for s in ctx.prefill_lens)
    return 100.0 * total / (ctx.window_s * peaks.BF16_FLOPS)
