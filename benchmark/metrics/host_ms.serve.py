"""Host time of the entry point, ms a request: the benchmark's span from
the call into ``bucketed_sweep`` until it returns, before the
synchronize, averaged over the run's untraced requests."""


def read(ctx):
    spans = ctx.get('host_ms')
    return sum(spans) / len(spans) if spans else None
