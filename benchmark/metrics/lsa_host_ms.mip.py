"""lsa_host_ms.mip: lsa_host_ms in mip-NeRF's LSA cells: median ms of the
window's calls from the span ``nnc.lsa.call``'s start to its
``nnc.lsa.steps``' (the batches, their packing, the draws and the upload,
before the replay)."""
from benchmark.metrics.lsa_host_ms import read  # noqa: F401
