"""Host-side registry of fused-dispatch fallbacks.

A fallback (a ``dispatch="fused"`` call that runs the two-pass engine instead
of the kernel) depends only on dtypes, never on values.  It is recorded here:
a process-wide counter keyed on ``(site, reason)`` plus a one-time
``warnings.warn`` per key, so a silently degraded fused context is visible
the first time it runs.  Eager PyTorch records every call, so the counts are
calls, not traces.
"""
from __future__ import annotations

import warnings

_FALLBACKS: dict[tuple[str, str], int] = {}
_WARNED: set[tuple[str, str]] = set()


def record_site_fallback(site: str, reason: str) -> None:
    """Count a fused→twopass call for ``site`` and warn once per
    (site, reason)."""
    key = (site, reason)
    _FALLBACKS[key] = _FALLBACKS.get(key, 0) + 1
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(
            f"FTContext dispatch='fused' fell back to twopass at site "
            f"'{site}' ({reason}); the protected path is paying the "
            f"two-pass tax here",
            RuntimeWarning,
            stacklevel=3,
        )


def site_fallback_total() -> dict[tuple[str, str], int]:
    """Snapshot of the ``site_fallback_total{site,reason}`` counters."""
    return dict(_FALLBACKS)


def fallback_summary() -> dict[str, int]:
    """Flat ``{"site/reason": count}`` view for the metrics exporter."""
    return {f"{site}/{reason}": n for (site, reason), n in sorted(_FALLBACKS.items())}


def reset_site_fallbacks() -> None:
    """Clear counters and the warned-once set (tests)."""
    _FALLBACKS.clear()
    _WARNED.clear()
