"""Device ms a request in kernels other than the port's own (the
generator's cuDNN convolutions and PyTorch's elementwise, copy and
padding kernels)."""
from benchmark.metrics.common import OWN, base_name


def read(ctx):
    us = sum(e - s for n, s, e in ctx['trace'].kernels()
             if base_name(n) not in OWN)
    return us / 1e3 / ctx['requests'] if us else None
