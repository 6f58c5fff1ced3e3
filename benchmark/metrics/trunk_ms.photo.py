"""Device ms a request in kernels other than the port's own, in the
cells of one photo a request: read as ``trunk_ms.serve`` reads it."""
from benchmark.metrics.common import same_as

read = same_as('trunk_ms.serve')
