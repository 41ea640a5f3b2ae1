"""mfu.frame: % of the card's peak that the frames' model operations (the
filled sample slots, counted by the reference) take over the window."""
from benchmark.metrics._common import mfu as read
