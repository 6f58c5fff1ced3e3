"""Published peaks of one NVIDIA H100 SXM and the least time for a piece
of work.  Frozen copy of ``exsr_torch/ops/kernels/measure.py``'s
``bound_ms`` and its rates, so that the yardstick does not move with the
program."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM published rates (dense)
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
BF16_FLOPS = 989e12            # bf16 tensor cores

PEAK_FLOPS = {'float32': FP32_FLOPS, 'bfloat16': BF16_FLOPS}


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """The least time for the work, ``(ms, 'bytes' or 'operations')``:
    the larger of the bytes over the memory rate and the operations over
    the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                      else 'operations')
