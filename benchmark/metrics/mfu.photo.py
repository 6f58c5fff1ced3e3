"""The whole forward's share of the chip's peak, %, in the cells of one
photo a request: read as ``mfu.serve`` reads it."""
from benchmark.metrics.common import same_as

read = same_as('mfu.serve')
