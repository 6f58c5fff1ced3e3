"""Kernel launches a request, in the cells of one photo a request: read
as ``launches_per_req.serve`` reads it."""
from benchmark.metrics.common import same_as

read = same_as('launches_per_req.serve')
