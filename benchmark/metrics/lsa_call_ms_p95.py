"""lsa_call_ms_p95: the 95th percentile of the window's LSA calls' wall ms,
from batches to losses read back (``tune_lsa_scales(stats=)``; the calls
that captured nothing)."""
from benchmark import harness


def read(ctx):
    calls = ctx["counts"].get("calls_s")
    return 1e3 * harness.quantile(calls, 0.95) if calls else None
