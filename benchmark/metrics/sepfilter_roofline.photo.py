"""The CEM filter kernels' share of their roofline, %, in the cells of
one photo a request: read as ``sepfilter_roofline`` reads it."""
from benchmark.metrics.common import same_as

read = same_as('sepfilter_roofline')
