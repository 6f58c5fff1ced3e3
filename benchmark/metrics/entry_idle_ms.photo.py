"""`entry_idle_ms.serve`, in the cells of one photo a request."""
from benchmark.metrics.common import same_as

read = same_as('entry_idle_ms.serve')
