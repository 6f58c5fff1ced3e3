"""Host time of the entry point, ms a request, in the cells of one photo
a request: read as ``host_ms.serve`` reads it."""
from benchmark.metrics.common import same_as

read = same_as('host_ms.serve')
