"""Hand-written Hopper kernels of the port, each beside its plain version.

``rmsnorm``, ``flash_attention`` and ``decode_attention`` are
``torch.library`` custom ops: a CUDA tensor launches the kernel built from
``csrc/`` (``_build``), a CPU tensor takes the plain PyTorch version.
Each wrapper counts its kernel launches in ``.launches``.
"""
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

KERNELS = (rmsnorm, flash_attention, decode_attention)

# atol = rtol of a kernel against its plain version on the same inputs.
# The largest differences measured on an H100 were 1.6e-6 in fp32 and one
# bf16 ulp (0.0156 at |x| in [2, 4)) in bf16; these leave headroom.  The
# fp32 limit rejects a mask one slot off (lengths - 1, window + 1); the
# bf16 one rejects a window one off but not one dropped slot among ~600.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["rmsnorm", "rmsnorm_plain", "flash_attention",
           "flash_attention_plain", "decode_attention",
           "decode_attention_plain", "KERNELS", "TOLERANCE",
           "reset_launches"]
