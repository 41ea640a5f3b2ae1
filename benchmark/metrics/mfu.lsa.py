"""mfu.lsa: % of the card's peak that the LSA steps' model operations (forward
and backward of every sampled point) take over the window."""
from benchmark.metrics._common import mfu as read
