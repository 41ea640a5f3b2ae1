"""idle_share.lsa_pool: % of the window of the cells that batch from a pool
of rays in which the device ran nothing."""
from benchmark.metrics._common import idle_share as read
