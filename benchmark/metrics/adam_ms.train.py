"""Device ms of the traced iteration in the parameters' Adam updates:
the program's `exsr.adam` spans, from their CUDA events."""
from benchmark.spans import span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx, {'exsr.adam'})
