"""Device ms a request in the CEM's filter kernels, in the cells of one
photo a request: read as ``cem_ms.serve`` reads it."""
from benchmark.metrics.common import same_as

read = same_as('cem_ms.serve')
