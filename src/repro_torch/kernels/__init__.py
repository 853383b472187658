"""Hand-written Hopper kernels of the port, each beside its plain version.

``rmsnorm``, ``flash_attention``, ``decode_attention``,
``mamba_chunk_scan``, ``mlstm_chunk_scan`` and ``moe_gmm`` are
``torch.library`` custom ops: a CUDA tensor launches the kernel built from
``csrc/`` (``_build``), a CPU tensor takes the plain PyTorch version.
Each wrapper counts its kernel launches in ``.launches``; the two
attention wrappers count them by their inputs' shapes in ``.by_shape``
as well.  ``rmsnorm``, ``flash_attention``, the two chunk scans and
``moe_gmm`` have a registered autograd whose backward is a kernel too
(``rmsnorm_backward``, ``flash_attention_backward``: two launches a run;
``mamba_chunk_scan_backward``: three; ``mlstm_chunk_scan_backward``:
five; ``moe_gmm_backward``: two, dx then dw; each run counted once).
``decode_attention_int8`` is the decode kernel's int8-cache form, a
custom op of its own whose launches are counted apart (``INT8_KERNELS``).
"""
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_plain,
    flash_attention_plain)
from repro_torch.kernels.mamba_scan import (
    mamba_chunk_scan, mamba_chunk_scan_backward,
    mamba_chunk_scan_backward_plain, mamba_chunk_scan_plain)
from repro_torch.kernels.mlstm import (mlstm_chunk_scan,
                                       mlstm_chunk_scan_backward,
                                       mlstm_chunk_scan_backward_plain,
                                       mlstm_chunk_scan_plain)
from repro_torch.kernels.moe_gmm import (moe_gmm, moe_gmm_backward,
                                         moe_gmm_backward_plain,
                                         moe_gmm_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_backward,
                                         rmsnorm_backward_plain,
                                         rmsnorm_plain)

KERNELS = (rmsnorm, flash_attention, decode_attention, mamba_chunk_scan,
           mlstm_chunk_scan, moe_gmm)
# the other forms of a kernel of KERNELS (int8 caches), counted apart
INT8_KERNELS = (decode_attention_int8,)
# the gradients of the kernels a train step runs (dense: the first two;
# hybrid: the first three; ssm: rmsnorm's and the mLSTM scan's; moe: the
# first two and moe_gmm's)
BACKWARD_KERNELS = (rmsnorm_backward, flash_attention_backward,
                    mamba_chunk_scan_backward, mlstm_chunk_scan_backward,
                    moe_gmm_backward)

# atol = rtol of a kernel against its plain version on the same inputs.
# The largest differences measured on an H100 were 1.6e-6 in fp32 and one
# bf16 ulp (0.0156 at |x| in [2, 4)) in bf16; these leave headroom.  The
# fp32 limit rejects a mask one slot off (lengths - 1, window + 1); the
# bf16 one rejects a window one off but not one dropped slot among ~600.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def reset_launches() -> None:
    for k in KERNELS + INT8_KERNELS + BACKWARD_KERNELS:
        k.launches = 0
    for k in (flash_attention, decode_attention, decode_attention_int8):
        k.by_shape.clear()


def launch_counts(kernels=KERNELS) -> dict:
    """{kernel name: launches so far} of every forward wrapper (or of
    ``kernels``)."""
    return {k.__name__: k.launches for k in kernels}


__all__ = ["rmsnorm", "rmsnorm_plain", "flash_attention",
           "flash_attention_plain", "decode_attention",
           "decode_attention_plain", "decode_attention_int8",
           "mamba_chunk_scan", "mamba_chunk_scan_plain", "mlstm_chunk_scan",
           "mlstm_chunk_scan_plain", "moe_gmm", "moe_gmm_plain",
           "rmsnorm_backward", "rmsnorm_backward_plain",
           "flash_attention_backward", "flash_attention_backward_plain",
           "mamba_chunk_scan_backward", "mamba_chunk_scan_backward_plain",
           "mlstm_chunk_scan_backward", "mlstm_chunk_scan_backward_plain",
           "moe_gmm_backward", "moe_gmm_backward_plain",
           "KERNELS", "INT8_KERNELS", "BACKWARD_KERNELS", "TOLERANCE",
           "reset_launches", "launch_counts"]
