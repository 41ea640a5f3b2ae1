"""idle_share.render: % of the test-view window in which the device ran nothing."""
from benchmark.metrics._common import idle_share as read
