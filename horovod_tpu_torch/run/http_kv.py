"""HMAC-signed HTTP KV store: the rendezvous plane.

The port's copy of ``horovod_tpu/run/http_kv.py`` (reference:
``horovod/runner/http/http_server.py``, ``RendezvousServer``, a threaded
HTTP KV store used by Gloo rendezvous and elastic worker registration, +
``http_client.py``).  The elastic driver publishes the membership
document (epoch, rendezvous port, rank assignment) under a key; workers
on other hosts poll it over HTTP instead of a shared-filesystem
assignment file, and publish their heartbeats there.  Every request is HMAC-signed with
the per-job secret (``run/secret.py``); unsigned or mis-signed requests
get 403.

Wire format: ``PUT/GET/DELETE /kv/<scope>/<key>``; the ``X-Hvd-Sig``
header signs ``method\\npath\\ntimestamp\\nbody`` and the ``X-Hvd-Ts``
timestamp must be within ``MAX_SKEW_S`` of the server clock, bounding the
replay window.  Auth failures raise :class:`RendezvousAuthError` (NOT a
``ConnectionError``): a wrong per-job secret is a configuration bug that
must surface loudly, while connection errors mean the driver is
down/restarting and are retried by callers.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.request import Request, urlopen
from urllib.error import HTTPError, URLError

from .retry import RetryPolicy, call_with_retries
from .secret import check_digest, compute_digest

SIG_HEADER = "X-Hvd-Sig"
TS_HEADER = "X-Hvd-Ts"
MAX_SKEW_S = 60.0


class RendezvousAuthError(RuntimeError):
    """Signature rejected (wrong or missing per-job secret)."""


def _signable(method: str, path: str, ts: str, body: bytes) -> bytes:
    return (method.encode() + b"\n" + path.encode() + b"\n" + ts.encode()
            + b"\n" + body)


class RendezvousServer:
    """Threaded KV store over HTTP; values are opaque bytes."""

    def __init__(self, secret_key: str, host: str = "127.0.0.1",
                 port: int = 0):
        # Default loopback: the local driver hands workers 127.0.0.1.
        # Multi-host deployments pass host="0.0.0.0" explicitly.
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        # Monotonic deadline before which every request gets 503: the
        # chaos harness uses this to simulate a driver outage that the
        # client-side retry policy must ride out.
        self._blackout_until = 0.0
        server = self
        store, lock, secret = self._store, self._lock, secret_key

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _blacked_out(self) -> bool:
                import time
                return time.monotonic() < server._blackout_until

            def _verify(self, body: bytes) -> bool:
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
                    secret,
                    _signable(self.command, self.path, ts, body), sig)

            def _reply(self, code: int, body: bytes = b"") -> None:
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self._blacked_out():
                    return self._reply(503)
                if not self._verify(b""):
                    return self._reply(403)
                if self.path == "/time":
                    # NTP-style clock reference for the trace plane
                    # (timeline/sync.py): the instant the reply is built
                    # is the server-clock sample; signed like every
                    # other KV request.
                    import time
                    return self._reply(200, repr(time.time()).encode())
                with lock:
                    val = store.get(self.path)
                self._reply(200, val) if val is not None else self._reply(404)

            def do_PUT(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self._blacked_out():
                    return self._reply(503)
                if not self._verify(body):
                    return self._reply(403)
                with lock:
                    store[self.path] = body
                self._reply(200)

            def do_DELETE(self):
                if self._blacked_out():
                    return self._reply(503)
                if not self._verify(b""):
                    return self._reply(403)
                with lock:
                    store.pop(self.path, None)
                self._reply(200)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="hvd-torch-rendezvous")
        self._thread.start()

    def blackout(self, secs: float) -> None:
        """Refuse every request with 503 for ``secs`` seconds (fault
        injection: simulated driver outage)."""
        import time
        self._blackout_until = time.monotonic() + max(0.0, secs)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


class KVClient:
    """Signing client for :class:`RendezvousServer`."""

    def __init__(self, addr: str, port: int, secret_key: str,
                 timeout_s: float = 10.0,
                 retry_policy: Optional[RetryPolicy] = None):
        self.base = f"http://{addr}:{port}"
        self.secret_key = secret_key
        self.timeout_s = timeout_s
        # One env-tuned policy for every KV caller (workers, driver
        # heartbeats, notify): HOROVOD_KV_RETRIES / HOROVOD_KV_BACKOFF_MS.
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy.from_env())

    @classmethod
    def from_url(cls, url: str, secret_key: str,
                 timeout_s: float = 10.0,
                 retry_policy: Optional[RetryPolicy] = None) -> "KVClient":
        """``http://host:port`` -> client."""
        hostport = url.split("//", 1)[1].rstrip("/")
        host, _, port = hostport.rpartition(":")
        return cls(host, int(port), secret_key, timeout_s,
                   retry_policy=retry_policy)

    def _request(self, method: str, path: str,
                 body: bytes = b"") -> Tuple[int, bytes]:
        import time
        from ..elastic import chaos as _chaos
        if _chaos.kv_blackout_active():
            raise ConnectionError(
                f"rendezvous {method} {path}: chaos KV blackout")
        ts = repr(time.time())
        sig = compute_digest(self.secret_key,
                             _signable(method, path, ts, body))
        req = Request(self.base + path, data=body if method == "PUT" else
                      None, method=method,
                      headers={SIG_HEADER: sig, TS_HEADER: ts})
        try:
            with urlopen(req, timeout=self.timeout_s) as resp:
                return resp.status, resp.read()
        except HTTPError as e:
            return e.code, b""
        except (URLError, TimeoutError, OSError) as e:
            # Normalize every transport failure to ConnectionError so
            # callers' "driver down/restarting, retry" handling sees one
            # type (urllib raises URLError/TimeoutError, not
            # ConnectionError).
            raise ConnectionError(
                f"rendezvous {method} {path}: {e}") from e

    def _check(self, op: str, code: int) -> None:
        if code == 403:
            raise RendezvousAuthError(
                f"rendezvous {op} rejected (403): per-job secret mismatch "
                f"or >={MAX_SKEW_S:.0f}s clock skew -- check "
                "HVD_TPU_SECRET_KEY and NTP on every host")
        if code != 200:
            raise ConnectionError(f"rendezvous {op} -> HTTP {code}")

    def _retrying(self, fn, describe: str):
        # RendezvousAuthError subclasses RuntimeError, not
        # ConnectionError, so a bad secret surfaces on the first attempt;
        # transport failures (already normalized to ConnectionError by
        # _request) and non-200 statuses burn the backoff budget.
        return call_with_retries(fn, policy=self.retry_policy,
                                 retry_on=(ConnectionError,),
                                 no_retry=(RendezvousAuthError,),
                                 describe=describe)

    def put(self, scope: str, key: str, value: bytes) -> None:
        def _once() -> None:
            code, _ = self._request("PUT", f"/kv/{scope}/{key}", value)
            self._check(f"PUT {scope}/{key}", code)
        self._retrying(_once, f"kv PUT {scope}/{key}")

    def get(self, scope: str, key: str) -> Optional[bytes]:
        def _once() -> Optional[bytes]:
            code, body = self._request("GET", f"/kv/{scope}/{key}")
            if code == 200:
                return body
            if code == 404:
                return None
            self._check(f"GET {scope}/{key}", code)
        return self._retrying(_once, f"kv GET {scope}/{key}")

    def delete(self, scope: str, key: str) -> None:
        def _once() -> None:
            code, _ = self._request("DELETE", f"/kv/{scope}/{key}")
            self._check(f"DELETE {scope}/{key}", code)
        self._retrying(_once, f"kv DELETE {scope}/{key}")

    # -- chunked bulk transfer (KV-page streaming) -------------------------
    #
    # A prompt's K/V pages are megabytes; one PUT of the whole payload
    # ties a request thread up for the full transfer and makes a mid-
    # stream failure all-or-nothing.  put_large splits the value into
    # fixed-size parts at ``<key>.part<i>`` and writes a tiny manifest
    # at ``<key>`` LAST, so a reader either sees no manifest (write in
    # flight or dead) or a complete, hash-verified object -- the same
    # commit-point discipline as the membership document.  Each part
    # PUT/GET rides the client's RetryPolicy independently, so a driver
    # blackout in the middle of a stream is survived per-chunk.

    MANIFEST_MAGIC = "HVDL1"
    CHUNK_BYTES = 1 << 20

    def put_large(self, scope: str, key: str, value: bytes,
                  chunk_bytes: int = 0) -> int:
        """Chunked binary-safe PUT; returns the number of parts."""
        import hashlib
        import json
        cb = int(chunk_bytes) or self.CHUNK_BYTES
        parts = max(1, -(-len(value) // cb))  # ceil; empty value = 1 part
        for i in range(parts):
            self.put(scope, f"{key}.part{i}", value[i * cb:(i + 1) * cb])
        manifest = json.dumps({
            "v": self.MANIFEST_MAGIC, "parts": parts,
            "bytes": len(value), "chunk_bytes": cb,
            "sha256": hashlib.sha256(value).hexdigest()},
            sort_keys=True).encode()
        self.put(scope, key, manifest)
        return parts

    def get_large(self, scope: str, key: str) -> Optional[bytes]:
        """Chunked GET: None until the manifest commits; a committed
        manifest whose parts are missing, short, or hash-mismatched
        raises ``ValueError`` (torn or corrupted object)."""
        import hashlib
        import json
        raw = self.get(scope, key)
        if raw is None:
            return None
        try:
            m = json.loads(raw)
            ok = m.get("v") == self.MANIFEST_MAGIC
        except (ValueError, AttributeError):
            ok = False
        if not ok:
            raise ValueError(
                f"kv {scope}/{key}: not a chunked-object manifest")
        chunks = []
        for i in range(int(m["parts"])):
            part = self.get(scope, f"{key}.part{i}")
            if part is None:
                raise ValueError(
                    f"kv {scope}/{key}: manifest committed but part {i} "
                    f"of {m['parts']} is missing")
            chunks.append(part)
        value = b"".join(chunks)
        if len(value) != int(m["bytes"]):
            raise ValueError(
                f"kv {scope}/{key}: reassembled {len(value)} byte(s), "
                f"manifest promises {m['bytes']}")
        if hashlib.sha256(value).hexdigest() != m["sha256"]:
            raise ValueError(
                f"kv {scope}/{key}: content hash mismatch after "
                "reassembly")
        return value

    def delete_large(self, scope: str, key: str) -> None:
        """Delete manifest FIRST (readers stop seeing the object), then
        the parts."""
        import json
        raw = self.get(scope, key)
        parts = 0
        if raw is not None:
            try:
                m = json.loads(raw)
                if m.get("v") == self.MANIFEST_MAGIC:
                    parts = int(m["parts"])
            except (ValueError, AttributeError):
                parts = 0
        self.delete(scope, key)
        for i in range(parts):
            self.delete(scope, f"{key}.part{i}")

    def server_time(self) -> float:
        """The KV server's wall clock (seconds since the epoch), for
        NTP-style offset estimation (the trace plane).  Retried
        like every other KV call; auth failures surface immediately."""
        def _once() -> float:
            code, body = self._request("GET", "/time")
            self._check("GET /time", code)
            return float(body)
        return self._retrying(_once, "kv GET /time")
