"""Share of the generated HR pixels that the entry point hands back, %:
the program's `px.returned` (outputs, images x H x W) over `px.generated`
(the generator's rows, bucket padding included, x the pre-padded H x
W)."""
from benchmark.spans import counter_ratio_pct


def read(ctx):
    return counter_ratio_pct(ctx, 'px.returned', 'px.generated')
