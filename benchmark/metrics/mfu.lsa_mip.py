"""mfu.lsa_mip: % of the card's peak that mip-NeRF's LSA steps' model
operations (forward and backward of every sample of both levels) take over
the window."""
from benchmark.metrics._common import mfu as read  # noqa: F401
