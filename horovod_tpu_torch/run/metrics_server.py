"""Prometheus ``/metrics`` endpoint on the ``http_kv`` server machinery.

The port's copy of ``horovod_tpu/run/metrics_server.py``.

Serves the process-wide :mod:`horovod_tpu_torch.timeline.metrics` registry as
text exposition format 0.0.4 (plus ``/metrics.json`` for the snapshot
dict and ``/healthz`` for liveness probes).  Started by ``hvd.init()``
when ``HOROVOD_METRICS_PORT`` is set (>= 0; 0 binds an ephemeral port --
read it back from ``global_state().metrics_server.port``).

Auth is HMAC-*optional*, unlike :class:`~horovod_tpu_torch.run.http_kv.
RendezvousServer` where it is mandatory: the endpoint is read-only
aggregate telemetry, and Prometheus scrapers cannot sign requests.  Pass
``secret_key=`` to require the same ``X-Hvd-Sig``/``X-Hvd-Ts`` scheme as
the KV plane when the port is exposed beyond loopback.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .http_kv import MAX_SKEW_S, SIG_HEADER, TS_HEADER, _signable
from .secret import check_digest


class MetricsServer:
    """Threaded read-only HTTP server over the metrics registry."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 secret_key: Optional[str] = None):
        secret = secret_key

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _verify(self) -> bool:
                if secret is None:
                    return True
                import time
                sig = self.headers.get(SIG_HEADER, "")
                ts = self.headers.get(TS_HEADER, "")
                try:
                    skew = abs(time.time() - float(ts))
                except ValueError:
                    return False
                if skew > MAX_SKEW_S:
                    return False
                return check_digest(
                    secret, _signable(self.command, self.path, ts, b""),
                    sig)

            def _reply(self, code: int, body: bytes = b"",
                       ctype: str = "text/plain") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/healthz":
                    # Liveness must answer WITHOUT a signature even when
                    # HMAC auth is armed: kubelet/LB probes cannot sign,
                    # and the reply ("ok") carries no telemetry.  The
                    # data endpoints below stay protected.
                    return self._reply(200, b"ok\n")
                if not self._verify():
                    return self._reply(403)
                from ..timeline import metrics as _metrics
                try:
                    if path in ("/", "/metrics"):
                        return self._reply(
                            200, _metrics.render_prometheus().encode(),
                            _metrics.CONTENT_TYPE)
                    if path == "/metrics.json":
                        body = json.dumps(
                            _metrics.metrics_snapshot()).encode()
                        return self._reply(200, body, "application/json")
                except Exception as e:  # a bad collector must not 404
                    return self._reply(
                        500, f"metrics render failed: {e}\n".encode())
                self._reply(404)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="hvd-torch-metrics")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
