"""Device ms a request in the generator: the program's `exsr.generator`
spans (its call inside the CEM wrapper), from their CUDA events."""
from benchmark.spans import span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx, {'exsr.generator'})
