"""Device ms of the traced iteration in the MAP loop: the program's
`exsr.map_loop` spans whole (the generator's forwards and input gradients
and Z's Adam steps, D step and G step), from their CUDA events."""
from benchmark.spans import span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx, {'exsr.map_loop'}, whole=True)
