"""Device-side time-series telemetry: the :class:`SeriesBuffer` ring.

A ``SeriesBuffer`` holds fixed-capacity ring buffers, one per named channel,
on the device, and a write cursor.  :meth:`SeriesBuffer.record` appends one
row to every channel; the serving step loop records one scalar row per step
(``ServerConfig(series=True)``).

  * **no host sync on the write path**: every channel is a 4-byte dtype (the
    reference's int32 counts and float32 fractions) and a view of one packed
    int32 ring, so a row is one host buffer copied to the device in one
    asynchronous copy (pinned memory on a card); the cursor is a host int;
  * **one read**: :meth:`harvest` copies the ring to the host;
  * **ring semantics**: past ``capacity`` writes the oldest rows are
    overwritten; ``harvest`` returns only rows still resident, in order.

The persisted artifact (:func:`save_series` / :func:`load_series`) is one
``.npz``: one array per channel, first axis = time, plus a JSON ``__meta__``
blob (step offset, channel names, run labels), the series half of what
``python -m repro_torch.obs.replay`` joins with the event JSONL.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

_WORD = {torch.int32: np.int32, torch.float32: np.float32}


class SeriesBuffer:
    """Fixed-capacity multi-channel ring buffer on a device.

    ``data[name]`` has shape ``(capacity, *row_shape)`` and the channel's
    dtype (int32 or float32), a view of the packed ring; ``written`` is the
    number of rows ever recorded."""

    def __init__(self, ring: torch.Tensor, layout: dict[str, tuple[int, tuple[int, ...], torch.dtype]]):
        self._ring = ring
        self._layout = layout  # name -> (word offset, row shape, dtype)
        self.written = 0
        self.data = {
            k: ring[:, off:off + math.prod(shape)].view(dtype).reshape(ring.shape[0], *shape)
            for k, (off, shape, dtype) in layout.items()
        }

    @classmethod
    def create(cls, capacity: int, spec: dict[str, tuple[tuple[int, ...], torch.dtype]],
               *, device="cpu") -> "SeriesBuffer":
        """Allocate a zeroed buffer: ``spec`` maps channel name to
        ``(row_shape, dtype)``, e.g. ``{"tokens": ((), torch.int32)}``."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        layout, off = {}, 0
        for k in sorted(spec):
            shape, dtype = tuple(spec[k][0]), spec[k][1]
            if dtype not in _WORD:
                raise ValueError(f"series channel {k!r}: dtype {dtype} is not int32 or float32")
            layout[k] = (off, shape, dtype)
            off += math.prod(shape)
        return cls(torch.zeros((capacity, off), dtype=torch.int32, device=device), layout)

    @property
    def capacity(self) -> int:
        return self._ring.shape[0]

    def record(self, values: dict) -> "SeriesBuffer":
        """Append one row per channel (in place; returns the buffer).
        ``values`` must name exactly the buffer's channels.  Each value is
        cast to its channel's dtype on the host (a Python float to float32
        rounds to nearest, as the reference's device cast does)."""
        if set(values) != set(self._layout):
            raise ValueError(
                f"series channels mismatch: buffer has {sorted(self._layout)}, "
                f"record got {sorted(values)}"
            )
        row = np.zeros(self._ring.shape[1], np.int32)
        for k, (off, shape, dtype) in self._layout.items():
            v = np.asarray(values[k], _WORD[dtype]).reshape(-1)
            row[off:off + v.size] = v.view(np.int32)
        host = torch.from_numpy(row)
        dev = self._ring.device
        if dev.type == "cuda":
            host = host.pin_memory()
        self._ring[self.written % self.capacity].copy_(host, non_blocking=dev.type == "cuda")
        self.written += 1
        return self

    def harvest(self, start: int = 0) -> dict[str, np.ndarray]:
        """Rows ``[start, written)`` in write order, as host arrays (the one
        device-to-host read).  Rows older than ``written - capacity`` have
        been overwritten and raise."""
        end = self.written
        if start > end:
            raise ValueError(f"harvest start {start} is past cursor {end}")
        if end - start > self.capacity:
            raise ValueError(
                f"rows [{start}, {end}) exceed ring capacity {self.capacity}; "
                f"oldest resident row is {end - self.capacity}"
            )
        ring = self._ring.cpu().numpy()[np.arange(start, end) % self.capacity]
        return {
            k: ring[:, off:off + math.prod(shape)].view(_WORD[dtype]).reshape(len(ring), *shape)
            for k, (off, shape, dtype) in sorted(self._layout.items())
        }


def record_step(buf: SeriesBuffer, values: dict) -> SeriesBuffer:
    """Host-loop entry point: append one row (values are host scalars)."""
    return buf.record(values)


# --------------------------------------------------------------------------- #
# artifact I/O (the replay CLI's series half)
# --------------------------------------------------------------------------- #
def save_series(path: str, series: dict[str, np.ndarray], meta: dict | None = None) -> str:
    """Persist harvested series as one ``.npz``: an array per channel (first
    axis = time) plus a JSON ``__meta__`` blob.  Returns the path written
    (``.npz`` appended when missing)."""
    arrays = {k: np.asarray(v) for k, v in series.items()}
    lengths = {v.shape[0] for v in arrays.values()}
    if len(lengths) > 1:
        raise ValueError(f"channel lengths differ: { {k: v.shape[0] for k, v in arrays.items()} }")
    meta = dict(meta or {})
    meta.setdefault("channels", sorted(arrays))
    meta.setdefault("length", lengths.pop() if lengths else 0)
    path = path if path.endswith(".npz") else path + ".npz"
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.asarray(json.dumps(meta)), **arrays)
    return path


def load_series(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Load a :func:`save_series` artifact -> (channel dict, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z else {}
        series = {k: z[k] for k in z.files if k != "__meta__"}
    return series, meta
