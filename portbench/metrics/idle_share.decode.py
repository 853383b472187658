"""idle_share.decode: the share of the traced window, in percent, in which
no operation ran on the device while the host was stepping the decode
(inside ``step_block`` or ``validate`` and outside a prefill): dispatch,
the frontier's drains, the scheduler's bookkeeping."""

SPANS = ("portbench.step_block", "portbench.decode_block",
         "portbench.validate")


def read(ctx):
    if ctx.trace is None or not ctx.trace["kernels"]:
        return None
    idle = sum(ctx.trace["idle_by_host"].get(s, 0.0) for s in SPANS)
    return 100.0 * idle / ctx.trace["window_s"]
