"""decode_attention_roofline: the least time of the window's
``decode_attention`` calls over their device time, in percent.

Work is counted from the op's inputs as the cell drives them: one call per
attention layer per decode step, over every row of the decode batch, each
row reading its valid cache length (its position at that step, plus one).
Time is the device time of the kernels named ``decode_attention_kernel``
(bf16 caches) in the traced window."""
from portbench import tracing
from portbench.counts import kernels, peaks

KERNEL = ("decode_attention_kernel",)
EXCLUDE = ("[int8]",)


def read(ctx):
    if ctx.trace is None or not ctx.block_pos:
        return None
    t = tracing.device_seconds(ctx.trace, KERNEL, EXCLUDE)
    if t <= 0:
        return None
    sh, k = ctx.shapes, ctx.mix["block_k"]
    least = 0.0
    for pos in ctx.block_pos:
        for j in range(k):
            f, b = kernels.decode_attention(
                (pos + j + 1).tolist(), sh["heads"], sh["kv_heads"],
                sh["qk_dim"], sh["v_dim"])
            least += peaks.least_seconds(f, b)
    return 100.0 * least * sh["layers"] / t
