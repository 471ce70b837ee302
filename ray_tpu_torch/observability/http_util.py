"""Shared JSON-over-HTTP plumbing for the dashboards.

One route-table server used by both the in-process dashboard
(observability/dashboard.py) and the process-tier head
(observability/dashboard_head.py): unknown path -> 404, handler
exception -> 500 with an error JSON, everything else -> 200.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Tuple
from urllib.parse import parse_qs, urlparse

Route = Callable[[Dict], Tuple[bytes, str]]  # query -> (body, ctype)


def start_json_server(routes: Dict[str, Route], host: str = "127.0.0.1",
                      port: int = 0) -> ThreadingHTTPServer:
    """Serve a route table on a daemon thread. Caller owns shutdown():
    server.shutdown(); server.server_close()."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            parsed = urlparse(self.path)
            path = parsed.path.rstrip("/") or "/"
            fn = routes.get(path)
            if fn is None:
                self.send_response(404)
                self.end_headers()
                return
            try:
                body, ctype = fn(parse_qs(parsed.query))
                code = 200
            except Exception as e:  # noqa: BLE001 — surface as 500
                body = json.dumps({"error": repr(e)}).encode()
                ctype = "application/json"
                code = 500
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(
        target=server.serve_forever, daemon=True,
        name=f"json-http-{server.server_address[1]}").start()
    return server
