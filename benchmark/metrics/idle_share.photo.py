"""Share of the traced requests' window with no device activity, %, in
the cells of one photo a request: read as ``idle_share.serve`` reads
it."""
from benchmark.metrics.common import same_as

read = same_as('idle_share.serve')
