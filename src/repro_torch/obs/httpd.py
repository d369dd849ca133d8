"""Opt-in stdlib-only HTTP ``/metrics`` scrape endpoint.

A :class:`MetricsServer` runs next to the serving loop: a ``http.server.ThreadingHTTPServer`` on a daemon thread
whose ``GET /metrics`` (or ``/``) returns whatever the supplied callable
renders — the same Prometheus text (gauges + latency histograms) that
:func:`~repro_torch.obs.export.write_metrics_out` writes to ``PATH.prom``,
but scraped live.  No client
library, no third-party dependency: the container's Python is enough.

The supplier runs on the scrape thread; keep it read-only over host-side
state (``ServingMetrics.summary()`` + ``latency_lists()`` are — they never
touch the device).  Supplier exceptions become a 500 with the error text,
so a broken exporter is visible in the scrape rather than silent.

    srv = MetricsServer(lambda: prometheus_text(metrics.summary()))
    port = srv.start()            # port=0 picks a free one
    ...
    srv.stop()
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Background ``/metrics`` endpoint over a text supplier callable."""

    def __init__(self, supplier: Callable[[], str], *,
                 host: str = "127.0.0.1", port: int = 0):
        self._supplier = supplier
        self._host = host
        self._port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """The bound port (the OS choice when constructed with port=0)."""
        if self._httpd is None:
            raise RuntimeError("MetricsServer not started")
        return self._httpd.server_address[1]

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port
        supplier = self._supplier

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler naming)
                path = self.path.split("?", 1)[0].rstrip("/") or "/metrics"
                if path != "/metrics":
                    self.send_error(404, "only /metrics is served")
                    return
                try:
                    body = supplier().encode()
                except Exception as exc:  # surface exporter bugs in the scrape
                    body = f"# supplier error: {exc}\n".encode()
                    self.send_response(500)
                else:
                    self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet: scrapes are not stdout news
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-httpd",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
