"""Minimal inference server for the coupled LSTM-ODE model.

Serves the trained classifier + fitted ODE behind a small HTTP endpoint —
the framework's deployment surface (the reference had none; its "serving"
was re-running scripts). The model compiles once at startup; requests run
the same fused coupled-rollout program used everywhere else.

Endpoints (JSON):
  GET  /health            -> {"status": "ok", "model": {...}}
  POST /predict           -> {"probs": [[p_open, p_closed], ...],
                              "pred_binary": [...], "pred_three": [...],
                              "final_state": [[A, P, F], ...]}
      body: {"windows": [[[...]]]}  # (N, T, C) nested lists
      optional: {"trajectories": true} to include full (N, S, 3) rollouts

Start: ``python -m eegflow.cli.main serve --port 8799``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from eegflow.couple.rollout import CoupledModel, predict_batch


class InferenceServer:
    def __init__(self, model: CoupledModel, batch_size: int = 1024):
        self.model = model
        self.batch_size = batch_size
        self._lock = threading.Lock()

    def warmup(self, seq_len: int = 256) -> None:
        """Compile the rollout for one batch shape before serving."""
        dummy = np.zeros((1, seq_len, self.model.model_cfg.input_size), np.float32)
        predict_batch(self.model, dummy, batch_size=self.batch_size)

    def predict(self, windows: np.ndarray, with_trajectories: bool = False) -> dict:
        with self._lock:  # one compiled program, serialized device access
            res = predict_batch(self.model, windows.astype(np.float32),
                                batch_size=self.batch_size)
        out = {
            "probs": res["probs"].tolist(),
            "pred_binary": res["pred_binary"].tolist(),
            "pred_three": res["pred_three"].tolist(),
            "final_state": res["final_state"].tolist(),
        }
        if with_trajectories:
            out["trajectories"] = res["trajectories"].tolist()
        return out

    def handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    cfg = server.model.model_cfg
                    self._send(200, {"status": "ok", "model": {
                        "input_size": cfg.input_size,
                        "hidden_size": cfg.resolved_hidden(),
                        "num_layers": cfg.num_layers,
                        "coupling_strength": server.model.coupling.coupling_strength,
                    }})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    windows = np.asarray(payload["windows"], np.float32)
                    if windows.ndim != 3:
                        raise ValueError(
                            f"windows must be (N, T, C); got shape {windows.shape}"
                        )
                    if windows.shape[2] != server.model.model_cfg.input_size:
                        raise ValueError(
                            f"expected {server.model.model_cfg.input_size} channels,"
                            f" got {windows.shape[2]}"
                        )
                    out = server.predict(
                        windows, bool(payload.get("trajectories", False))
                    )
                    self._send(200, out)
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})

        return Handler


def serve(
    model: CoupledModel,
    host: str = "127.0.0.1",
    port: int = 8799,
    warmup_seq_len: Optional[int] = 256,
) -> ThreadingHTTPServer:
    """Create (and return) the HTTP server; caller runs serve_forever().

    The socket binds immediately and the warmup compile runs in a background
    thread, so /health responds while jit compiles (liveness vs readiness);
    an early /predict simply blocks on its own compile.
    """
    from eegflow.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    inference = InferenceServer(model)
    httpd = ThreadingHTTPServer((host, port), inference.handler_class())
    if warmup_seq_len:
        threading.Thread(
            target=inference.warmup, args=(warmup_seq_len,), daemon=True
        ).start()
    return httpd
