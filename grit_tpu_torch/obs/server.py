"""The workload's ``/metrics`` server.

Counterpart of the workload side of ``grit_tpu/obs/server.py``: a port
workload serves its own registry (:data:`grit_tpu_torch.obs.metrics.REGISTRY`)
when ``GRIT_WORKLOAD_METRICS_PORT`` is set, so the dump's, the place
loop's and the codec's metrics are scrapeable during the blackout, when
only this process has them, on ``/metrics`` (prometheus text). The
reference's debug and manager endpoints (thread stacks, CPU profile,
version) and its periodic sampler are not ported.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from grit_tpu_torch.api import config
from grit_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger(__name__)


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self) -> None:  # noqa: N802 - http.server API
        if urlparse(self.path).path != "/metrics":
            self.send_response(404)
            self.end_headers()
            return
        data = REGISTRY.render().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args: object) -> None:  # quiet
        return


def start_metrics_server(port: int) -> ThreadingHTTPServer:
    """Serve ``/metrics`` on every interface's ``port`` from a daemon
    thread. Returns the server (``.shutdown()`` stops it)."""
    srv = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
    threading.Thread(target=srv.serve_forever, name="grit-metrics",
                     daemon=True).start()
    return srv


_workload_lock = threading.Lock()
_workload_srv: ThreadingHTTPServer | None = None


def start_workload_metrics_server() -> ThreadingHTTPServer | None:
    """The workload's ``/metrics`` on ``GRIT_WORKLOAD_METRICS_PORT``: one
    server a process (a second call returns the first), nothing at port
    0 (the default), and never a raise — a busy port logs and the
    metrics stay process-local."""
    global _workload_srv
    port = config.WORKLOAD_METRICS_PORT.get_int()
    if port <= 0:
        return None
    with _workload_lock:
        if _workload_srv is not None:
            return _workload_srv
        try:
            _workload_srv = start_metrics_server(port)
        except OSError as exc:
            log.warning("workload metrics server on port %d failed: %s "
                        "(metrics stay process-local)", port, exc)
            return None
        return _workload_srv
