"""The CEM filter kernels' share of their roofline, %: the least time of
each ``sepfilter_edge``, ``sepfilter_down`` and ``sepfilter_up`` launch
at the cell's shapes, summed over the traced launches, over their summed
time in the trace."""
from benchmark.metrics.common import cem_launches


def read(ctx):
    seen = cem_launches(ctx).values()
    if not seen:
        return None
    return 100.0 * sum(n * b * 1e3 for n, _, b in seen) / \
        sum(us for _, us, _ in seen)
