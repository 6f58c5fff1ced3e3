"""Device ms of the traced iteration in the parameter gradients: the
program's `exsr.backward` spans (the D and G losses' `.backward`), from
their CUDA events."""
from benchmark.spans import span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx, {'exsr.backward'})
