"""Idle device ms a request while the entry point holds the host: the
traced gaps with no device activity whose innermost program range at
their middle is `exsr.sweep` or `exsr.forward`."""
from benchmark.spans import idle_ms_per_request

ENTRY = ('exsr.sweep', 'exsr.forward')


def read(ctx):
    return idle_ms_per_request(ctx, lambda names: bool(names) and
                               names[-1] in ENTRY)
