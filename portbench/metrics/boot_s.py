"""boot_s: seconds to verify, load and warm the cell's two recordings
(``Workload.channel``), the harness's timer around it."""


def read(ctx):
    return ctx.boot_s
