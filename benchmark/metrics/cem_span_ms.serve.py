"""Device ms a request in the CEM: the program's `exsr.cem` spans (the
replicate pre-pad, and the combine with its filters and the crop), from
their CUDA events."""
from benchmark.spans import span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx, {'exsr.cem'})
