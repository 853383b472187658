"""record_s: seconds the cell's two recordings took to record (the sum of
their manifests' ``record_wall_s``), read from the recording cache: what a
cloud pays once per code, shape and card."""


def read(ctx):
    return ctx.record_s
