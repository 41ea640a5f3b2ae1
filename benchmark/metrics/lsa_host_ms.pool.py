"""lsa_host_ms.pool: lsa_host_ms in the cells that batch from a pool of rays;
the median leaves out the call that holds the pool's reshuffle."""
from benchmark.metrics.lsa_host_ms import read  # noqa: F401
