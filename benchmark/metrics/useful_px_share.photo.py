"""`useful_px_share.serve`, in the cells of one photo a request."""
from benchmark.metrics.common import same_as

read = same_as('useful_px_share.serve')
