"""Fault manager: host ms a step in ``FaultManager.scan_step`` (the scan of
one row-block of PEs), timed by the harness's wrapper of the instance's
method, averaged over the window's steps."""


def read(rec, metric):
    scan = [s["scan_s"] for s in rec.get("steps") or () if s["scan_s"] is not None]
    return 1e3 * sum(scan) / len(scan) if scan else None
