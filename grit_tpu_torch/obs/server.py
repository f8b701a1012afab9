"""The workload's metrics and debug HTTP server.

Counterpart of ``grit_tpu/obs/server.py``: a port workload serves its own
registry (:data:`grit_tpu_torch.obs.metrics.REGISTRY`) when
``GRIT_WORKLOAD_METRICS_PORT`` is set, so the dump's, the place loop's,
the codec's and the progress tracker's metrics are scrapeable during the
blackout, when only this process has them. Endpoints, the reference's:

- ``/metrics`` — prometheus text exposition of the registry
- ``/debug/threadz`` — every thread's stack
- ``/debug/pprof/profile?seconds=N`` — a sampled CPU profile in
  collapsed-stack format (only when ``profiling=True``)
- ``/version`` — the build stamp (:mod:`grit_tpu_torch.version`)

The workload's server starts the periodic sampler beside it
(:mod:`grit_tpu_torch.obs.sampler`), so the progress and codec gauges
stay fresh between events.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from grit_tpu_torch.api import config
from grit_tpu_torch.obs.metrics import REGISTRY, Registry, render_threadz

log = logging.getLogger(__name__)


def start_metrics_server(
    port: int, host: str = "0.0.0.0", registry: Registry | None = None,
    *, profiling: bool = False,
) -> ThreadingHTTPServer:
    """Serve the endpoints above on ``host:port`` from a daemon thread.
    Returns the server (``.server_address[1]`` is the bound port when
    ``port`` is 0; ``.shutdown()`` stops it)."""
    reg = registry or REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def _text(self, code: int, body: str,
                  content_type: str = "text/plain") -> None:
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:  # noqa: N802 - http.server API
            url = urlparse(self.path)
            if url.path == "/metrics":
                self._text(200, reg.render(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/debug/threadz":
                self._text(200, render_threadz())
            elif url.path == "/debug/pprof/profile" and profiling:
                from grit_tpu_torch.obs.profile import (  # noqa: PLC0415
                    sample_profile,
                )

                try:
                    seconds = float(
                        (parse_qs(url.query).get("seconds") or ["5"])[0])
                except ValueError:
                    self._text(400, "bad seconds\n")
                    return
                self._text(200, sample_profile(seconds))
            elif url.path == "/version":
                from grit_tpu_torch.version import (  # noqa: PLC0415
                    version_string,
                )

                self._text(200, version_string() + "\n")
            else:
                self.send_response(404)
                self.end_headers()

        def log_message(self, *args: object) -> None:  # quiet
            return

    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, name="grit-metrics",
                     daemon=True).start()
    return srv


_workload_lock = threading.Lock()
_workload_srv: ThreadingHTTPServer | None = None


def start_workload_metrics_server() -> ThreadingHTTPServer | None:
    """The workload's server on ``GRIT_WORKLOAD_METRICS_PORT``, and the
    sampler beside it: one server a process (a second call returns the
    first), nothing at port 0 (the default), and never a raise — a busy
    port logs and the metrics stay process-local."""
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
    from grit_tpu_torch.obs import sampler  # noqa: PLC0415

    sampler.start()
    return _workload_srv
