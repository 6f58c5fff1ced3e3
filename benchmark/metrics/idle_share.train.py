"""Share of the traced iteration with no kernel, copy or fill running on
the device, %: one minus the union of its device intervals over its
``bench.iteration`` range, from the top of the loop to the synchronize
that ends it.  The profiler's host-side recording slows the host in that
iteration, so the share reads above an untraced iteration's."""
from benchmark.metrics.common import idle_pct as read  # noqa: F401
