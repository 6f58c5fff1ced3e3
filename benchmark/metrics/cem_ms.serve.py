"""Device ms a request in the CEM's filter kernels: the mean time of a
``sepfilter_edge``, ``_down`` and ``_up`` launch in the trace, times the
launches of one forward (2, 1, 1)."""
from benchmark.metrics.common import cem_launches


def read(ctx):
    seen = cem_launches(ctx)
    if not seen:
        return None
    per_req = {k: len(v) for k, v in ctx['counts']['cem'].items()}
    return sum(us / n * per_req[k] for k, (n, us, _) in seen.items()) / 1e3
