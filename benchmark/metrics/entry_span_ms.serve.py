"""Device ms a request in the entry point: the `exsr.sweep` and
`exsr.forward` spans less the generator and CEM spans nested in them (the
sweep's repeat, concatenation and padding, the upload, the clamp, and the
device's wait for the host at the request's start), from their CUDA
events."""
from benchmark.spans import span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx, {'exsr.sweep', 'exsr.forward'})
