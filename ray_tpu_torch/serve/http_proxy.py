"""HTTP ingress for serve (reference: python/ray/serve/http_proxy.py).

The reference runs a uvicorn/starlette proxy actor per node; here a
stdlib ThreadingHTTPServer inside the proxy actor routes
``route_prefix`` → deployment handle. JSON in/JSON out.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import ray_tpu_torch


class HTTPProxy:
    """Actor hosting the HTTP server; resolves routes via the controller."""

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 0):
        from ray_tpu_torch.serve.handle import ControllerRef, RayServeHandle

        self._controller = ControllerRef(controller)
        self._handles: Dict[str, RayServeHandle] = {}
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def _dispatch(self, body: Optional[bytes]):
                routes = proxy._controller.call("get_routes")
                path = self.path.split("?")[0]
                name = routes.get(path)
                if name is None:
                    for prefix, n in routes.items():
                        if prefix != "/" and path.startswith(prefix):
                            name = n
                            break
                if name is None:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b'{"error": "no route"}')
                    return
                if name not in proxy._handles:
                    proxy._handles[name] = RayServeHandle(
                        proxy._controller, name)
                try:
                    payload = json.loads(body) if body else None
                except json.JSONDecodeError:
                    payload = body.decode()
                from ray_tpu_torch.exceptions import RetryLaterError

                try:
                    args = (payload,) if payload is not None else ()
                    result = ray_tpu_torch.get(
                        [proxy._handles[name].remote(*args)])[0]
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(json.dumps(result).encode())
                except RetryLaterError as e:
                    # backpressure (every replica shedding) or a
                    # draining replica's shed: 503 + Retry-After, the
                    # HTTP spelling of the typed hint (reference:
                    # Serve proxy returning 503 on backpressure).
                    # A replica-raised shed arrives as the dual
                    # RayTaskError(RetryLaterError); the hint then
                    # lives on the cause.
                    hint = getattr(e, "retry_after_s", None)
                    if hint is None:
                        hint = getattr(getattr(e, "cause", None),
                                       "retry_after_s", 0.05)
                    self.send_response(503)
                    self.send_header("Retry-After",
                                     f"{max(hint, 0.05):.3f}")
                    self.end_headers()
                    self.wfile.write(json.dumps(
                        {"error": str(e),
                         "retry_after_s": hint}).encode())
                except Exception as e:  # noqa: BLE001
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(json.dumps(
                        {"error": str(e)}).encode())

            def do_GET(self):
                self._dispatch(None)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                self._dispatch(self.rfile.read(length) if length else None)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def address(self) -> str:
        return f"http://127.0.0.1:{self._port}"

    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        self._server.shutdown()


def start_http_proxy(controller, host: str = "127.0.0.1", port: int = 0):
    proxy = ray_tpu_torch.remote(HTTPProxy).remote(controller, host, port)
    return proxy
