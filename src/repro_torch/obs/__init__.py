"""Host-side observability: the fault-lifecycle event log and the registry
of fused-dispatch fallbacks."""
