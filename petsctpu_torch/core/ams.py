"""AMS: live in-run object publishing ("ALICE Memory Snooper").

Counterpart of petsctpu/core/ams.py (reference: src/sys/ams/pams.c,
PetscObjectAMSPublish, which exposes live object state over a socket so
that an external monitor can watch a running solve): a daemon-thread
HTTP endpoint on localhost of this process serving JSON snapshots of
the published objects and the log summary (core/logging.log_view).

    from petsctpu_torch.core import ams
    ams.publish("solver", lambda: {"its": int(res.its)})
    url = ams.start()           # http://127.0.0.1:<port>
    ...
    GET /        -> JSON {name: value} of every published object
    GET /log     -> text of core/logging.log_view()

`publish` accepts a value or a zero-arg callable (sampled per
request). `stop()` shuts the server down (also at interpreter exit).
"""

from __future__ import annotations

import json
import threading

_REGISTRY: dict = {}
_SERVER = None
_THREAD = None


def publish(name: str, value) -> None:
    """PetscObjectAMSPublish analog: register a value or a zero-arg
    callable sampled at each snapshot request."""
    _REGISTRY[str(name)] = value


def unpublish(name: str) -> None:
    _REGISTRY.pop(str(name), None)


def _snapshot() -> dict:
    out = {}
    for k, v in list(_REGISTRY.items()):
        try:
            out[k] = v() if callable(v) else v
        except Exception as ex:         # a dead publisher must not
            out[k] = f"<error: {ex!r}>"  # take the snooper down
    return out


def start(port: int = 0, host: str = "127.0.0.1") -> str:
    """Start the snooper (idempotent); returns its URL."""
    global _SERVER, _THREAD
    if _SERVER is not None:
        return f"http://{_SERVER.server_address[0]}:{_SERVER.server_address[1]}"
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/log"):
                from petsctpu_torch.core import logging as plog
                body = plog.log_view().encode()
                ctype = "text/plain"
            else:
                body = json.dumps(_snapshot(), default=str).encode()
                ctype = "application/json"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):      # silence request logging
            pass

    _SERVER = HTTPServer((host, port), Handler)
    _THREAD = threading.Thread(target=_SERVER.serve_forever,
                               daemon=True)
    _THREAD.start()
    import atexit
    atexit.register(stop)
    return f"http://{_SERVER.server_address[0]}:{_SERVER.server_address[1]}"


def stop() -> None:
    global _SERVER, _THREAD
    if _SERVER is not None:
        _SERVER.shutdown()
        _SERVER.server_close()
        _SERVER = None
        _THREAD = None
