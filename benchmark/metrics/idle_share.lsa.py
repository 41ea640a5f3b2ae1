"""idle_share.lsa: % of the LSA window in which the device ran nothing."""
from benchmark.metrics._common import idle_share as read
