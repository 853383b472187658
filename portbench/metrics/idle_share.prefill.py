"""idle_share.prefill: the share of the traced window, in percent, in which
no operation ran on the device while the host was inside a replayed
prefill (``portbench.prefill``): the eager prefill's dispatch, which an
admitted request waits for."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["kernels"]:
        return None
    idle = ctx.trace["idle_by_host"].get("portbench.prefill", 0.0)
    return 100.0 * idle / ctx.trace["window_s"]
