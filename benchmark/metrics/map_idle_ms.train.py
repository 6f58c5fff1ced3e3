"""Idle device ms of the traced iteration inside the MAP loop: the traced
gaps with no device activity whose middle lies in an `exsr.map_loop`
range, at any depth."""
from benchmark.spans import idle_ms_per_request


def read(ctx):
    return idle_ms_per_request(ctx, lambda names: 'exsr.map_loop' in names)
