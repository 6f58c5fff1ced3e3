"""Kernel launches a request, counted in the trace."""


def read(ctx):
    n = len(ctx['trace'].kernels())
    return n / ctx['requests'] if n else None
