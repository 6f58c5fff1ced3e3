"""The stage-4 epilogue kernel's share of its roofline, %: the least
time of one launch at the cell's shapes (bytes for bf16, operations for
fp32; ``benchmark.counts.kernels.stage4``) over its mean time in the
trace."""
from benchmark.counts.peaks import PEAK_FLOPS, bound_ms
from benchmark.metrics.common import kernel_us


def read(ctx):
    counts = ctx['counts']
    if 'stage4' not in counts:
        return None
    us, n = kernel_us(ctx, ('stage4_kernel', 'stage4_fma_kernel'))
    if not n:
        return None
    bound, _ = bound_ms(*counts['stage4'], PEAK_FLOPS[counts['dtype']])
    return 100.0 * bound * 1e3 / (us / n)
