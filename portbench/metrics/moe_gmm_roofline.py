"""moe_gmm_roofline: the least time of the window's ``moe_gmm`` calls over
their device time, in percent.

Work is counted from the op's inputs as the cell drives them: per MoE layer
three grouped products (w1, w3: D -> Fe; w2: Fe -> D) over every expert's
rows, C rows per token group (``counts/kernels.py:moe_rows``): a decode
step's group is the decode batch, a prefill's the prompt in groups of the
configuration's ``moe_group_size``.  Time is the device time of the kernels
named ``moe_gmm_*`` in the traced window."""
from portbench import tracing
from portbench.counts import kernels, peaks

KERNEL = ("moe_gmm_",)


def _layer(sh, tokens):
    rows = kernels.moe_rows(tokens, sh["group_size"], sh["top_k"],
                            sh["experts"], sh["capacity_factor"])
    up = kernels.moe_gmm(sh["experts"], rows, sh["hidden"], sh["expert_ff"])
    down = kernels.moe_gmm(sh["experts"], rows, sh["expert_ff"], sh["hidden"])
    return 2 * peaks.least_seconds(*up) + peaks.least_seconds(*down)


def read(ctx):
    sh = ctx.shapes
    if ctx.trace is None or not sh.get("moe_layers"):
        return None
    t = tracing.device_seconds(ctx.trace, KERNEL)
    if t <= 0:
        return None
    steps = len(ctx.block_pos) * ctx.mix["block_k"]
    least = steps * _layer(sh, ctx.mix["slots"])
    least += sum(_layer(sh, s) for s in ctx.prefill_lens)
    return 100.0 * least * sh["moe_layers"] / t
