"""`generator_span_ms.serve`, in the cells of one photo a request."""
from benchmark.metrics.common import same_as

read = same_as('generator_span_ms.serve')
