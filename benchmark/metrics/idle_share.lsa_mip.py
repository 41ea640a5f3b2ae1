"""idle_share.lsa_mip: % of mip-NeRF's LSA window in which the device ran
nothing."""
from benchmark.metrics._common import idle_share as read  # noqa: F401
