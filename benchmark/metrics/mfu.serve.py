"""The whole forward's share of the chip's peak, %: the generator's
model operations at the batch that runs (``bucketed_sweep``'s bucket) and
the pre-padded size, counted as direct convolutions from the
configuration, over the traced window's time per request and the trunk
dtype's peak (989 TFLOP/s bf16, 67 fp32)."""
from benchmark.metrics.common import peak_pct as read  # noqa: F401
