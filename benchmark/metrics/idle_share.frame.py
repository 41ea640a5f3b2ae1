"""idle_share.frame: % of the frame window in which the device ran nothing."""
from benchmark.metrics._common import idle_share as read
