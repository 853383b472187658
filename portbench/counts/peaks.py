"""Published peaks of one NVIDIA H100 (SXM, 80 GB HBM3): NVIDIA's data
sheet, dense rates without sparsity, at the full 700 W power limit.  The
same numbers as the port's ``analysis/roofline.py`` (PEAK_OPS_S, HBM_BW),
frozen here."""
BF16_FLOPS = 989e12     # FLOP/s, bfloat16 / float16 on the tensor cores
HBM_BYTES = 3.35e12     # bytes/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: the larger of its
    compute bound and its memory bound."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
