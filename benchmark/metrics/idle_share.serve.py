"""Share of the traced requests' window with no kernel, copy or fill
running on the device, %: one minus the union of their intervals over
the window."""
from benchmark.metrics.common import idle_pct as read  # noqa: F401
