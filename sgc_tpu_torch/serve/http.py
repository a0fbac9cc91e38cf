"""Zero-dependency HTTP JSON endpoint around an InferenceEngine (the
counterpart of sgc_tpu/serve/http.py):

    POST /predict          {"node_ids": [1, 2, 3]}   -> {"predictions": [...]}
    POST /predict_logits   {"node_ids": [...]}       -> {"logits": [[...], ...]}
    POST /predict_batch    {"batches": [[...], ...]} -> {"predictions": [[...], ...]}
    GET  /healthz                                     -> {"status": "ok", ...}

``/predict_batch`` runs the batches through the engine's pipelined
dispatch (``predict_logits_stream``, depth 2, outputs equal to the
blocking path's) and argmaxes each output as the stream yields it, so
no request holds every batch's logits at once. Like the reference it
caps neither the number nor the size of the batches (ROADMAP queue 3).

stdlib ``http.server`` only: requests are handled on threads
(``ThreadingHTTPServer``) with inference serialized behind one lock (the
engine's stats, slots and sampling generator are not thread-safe).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from sgc_tpu_torch.serve.engine import InferenceEngine


def make_handler(engine: InferenceEngine):
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                # under the lock: percentile_ms reads the latency deque,
                # which a concurrent predict would be appending to
                with lock:
                    payload = {
                        "status": "ok",
                        "mode": engine._mode,
                        "requests": engine.stats.requests,
                        "mean_latency_ms": round(
                            engine.stats.mean_latency_ms, 3),
                        "p50_ms": round(engine.stats.percentile_ms(50), 3),
                        "p99_ms": round(engine.stats.percentile_ms(99), 3),
                    }
                self._send(200, payload)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def _do_post_batch(self, req) -> None:
            batches = req.get("batches")
            if not isinstance(batches, list) or not all(
                    isinstance(b, list) for b in batches):
                self._send(400, {"error": "batches must be a list of lists"})
                return
            with lock:
                preds = [np.argmax(o, axis=1).tolist() if len(o) else []
                         for o in engine.predict_logits_stream(batches,
                                                               depth=2)]
            self._send(200, {"predictions": preds})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/predict_batch":
                    self._do_post_batch(req)
                    return
                ids = req.get("node_ids")
                if not isinstance(ids, list):
                    self._send(400, {"error": "node_ids must be a list"})
                    return
                if self.path == "/predict":
                    with lock:
                        preds = engine.predict(ids)
                    self._send(200, {"predictions": preds.tolist()})
                elif self.path == "/predict_logits":
                    with lock:
                        logits = engine.predict_logits(ids)
                    self._send(200, {"logits": logits.tolist()})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # serving must not crash the process
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 8787,
          blocking: bool = False):
    """Create the HTTP server; serve requests when ``blocking=True``.

    With ``blocking=False`` (the default) the server is bound but not
    serving: callers read ``server.server_address`` (useful with
    ``port=0``) and run ``server.serve_forever()`` themselves, e.g. in a
    thread.
    """
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    if blocking:
        server.serve_forever()
    return server
