"""mfu.render: % of the card's peak that the test views' model operations
(the points their rays need, counted by the reference) take over the
window."""
from benchmark.metrics._common import mfu as read
