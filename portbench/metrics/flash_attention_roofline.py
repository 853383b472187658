"""flash_attention_roofline: the least time of the window's
``flash_attention`` calls over their device time, in percent.

Work is counted from the op's inputs: one causal call per layer per
prefill, batch 1, over the prompt; query and key widths from the model
(MLA's prefill decompresses K to nope + rope and V to v_head_dim, over all
heads).  Time is the device time of the forward kernels
``flash_attention_*_kernel`` in the traced window."""
from portbench import tracing
from portbench.counts import kernels, peaks

KERNEL = ("flash_attention_",)
EXCLUDE = ("bwd",)


def read(ctx):
    if ctx.trace is None or not ctx.prefill_lens:
        return None
    t = tracing.device_seconds(ctx.trace, KERNEL, EXCLUDE)
    if t <= 0:
        return None
    sh = ctx.shapes
    least = sum(peaks.least_seconds(*kernels.flash_attention(
        1, s, s, sh["heads"], sh["flash_kv_heads"], sh["qk_dim"], sh["v_dim"]))
        for s in ctx.prefill_lens)
    return 100.0 * least * sh["layers"] / t
