"""Stdlib HTTP front-end for the inference engine (counterpart of
`ecamp_tpu/serve/http_server.py`; same endpoints and 400/500 split).

Endpoints:
  GET  /healthz          -> {"status": "ok"}
  GET  /stats            -> engine latency/throughput stats
  POST /predict          -> body {"image": <base64 of an image file>}
                            or  {"images": [<b64>, ...]}
                            response {"predictions": [{"probs": [...],
                            "labels": {...}}, ...]} (classification), or
                            [{"area_fraction": f, "bbox_xyxy": [...]}, ...]
                            per mask channel (segmentation),
                            {"boxes": [[x1, y1, x2, y2, conf, cls_conf,
                            cls], ...] or null} (detection), or
                            {"embedding": [...]} (embedding, unit L2 norm)

Requests are decoded and preprocessed on the host (`data/transforms.py::
EvalTransform` — the reference test path's Resize/CenterCrop/Normalize),
then single images go through a `MicroBatcher` so concurrent clients share
device calls; detection bypasses it, as its outputs are per-image lists.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


def _decode_image(b64: str, transform) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    return transform(img)


def _jsonable(x):
    """Numpy arrays and scalars (and lists of them, None included) as JSON
    values."""
    if isinstance(x, np.ndarray):
        return [_jsonable(v) for v in x.tolist()] if x.ndim else float(x)
    if isinstance(x, (np.floating, np.integer)):
        return float(x)
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def _summarize_mask(mask: np.ndarray, threshold: float = 0.5) -> dict:
    """Masks are too large for JSON round-trips at serving granularity;
    return the binarized area fraction + bounding box per channel (clients
    needing the full mask use the batch CLI). Multi-channel masks (RIGA
    dual disc/cup) summarize every channel."""
    def one(m2d: np.ndarray) -> dict:
        binm = m2d > threshold
        ys, xs = np.nonzero(binm)
        box = ([int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]
               if len(xs) else None)
        return {"area_fraction": float(binm.mean()), "bbox_xyxy": box}

    if mask.ndim == 3 and mask.shape[-1] > 1:
        return {"channels": [one(mask[..., i])
                             for i in range(mask.shape[-1])]}
    return one(mask[..., 0] if mask.ndim == 3 else mask)


class PredictionService:
    """Binds an engine, preprocessing and response shaping for one task
    ('classification', 'segmentation', 'detection' or 'embedding')."""

    def __init__(self, engine, img_size: int = 224, mean: float = 0.4722,
                 std: float = 0.3028, micro_batch: bool = True,
                 class_names=None, task: str = "classification"):
        from ..data.transforms import EvalTransform
        from .engine import MicroBatcher

        if task not in ("classification", "segmentation", "detection",
                        "embedding"):
            raise ValueError(f"no service for task {task!r}")
        self.engine = engine
        self.task = task
        self.transform = EvalTransform(img_size, mean, std)
        self.class_names = class_names
        self.batcher = (MicroBatcher(engine)
                        if micro_batch and task != "detection" else None)

    def decode(self, images_b64) -> np.ndarray:
        """Host-side decode+preprocess; raises on malformed input (400)."""
        return np.stack([_decode_image(b, self.transform)
                         for b in images_b64])

    def predict(self, xs: np.ndarray):
        if self.batcher is not None and len(xs) == 1:
            outs = [self.batcher.submit(xs[0]).result(timeout=120)]
        else:
            outs = list(self.engine(xs))
        return [self._shape(o) for o in outs]

    def _shape(self, out):
        if self.task == "segmentation":
            return _summarize_mask(np.asarray(out))
        if self.task == "detection":
            return {"boxes": _jsonable(out)}
        if self.task == "embedding":
            return {"embedding": _jsonable(out)}
        r = {"probs": out.tolist()}
        if self.class_names:
            r["labels"] = {n: float(p) for n, p in zip(self.class_names, out)}
        return r

    def close(self):
        if self.batcher is not None:
            self.batcher.close()


def make_handler(service: PredictionService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._send(200, {"status": "ok"})
            if self.path == "/stats":
                return self._send(200, service.engine.stats())
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                return self._send(404, {"error": "not found"})
            # Malformed requests are the client's fault (400); anything
            # else (engine crash, OOM, device failure) is a 500 whose
            # detail stays in the server log, not the response body.
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                b64s = req.get("images") or [req["image"]]
            except Exception as e:
                return self._send(400, {"error": f"bad request: {e}"})
            try:
                xs = service.decode(b64s)
            except Exception as e:
                return self._send(400, {"error": f"bad image: {e}"})
            try:
                return self._send(200, {"predictions": service.predict(xs)})
            except Exception as e:
                traceback.print_exc()
                return self._send(500, {"error": type(e).__name__})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(service: PredictionService, host: str = "127.0.0.1",
          port: int = 8000, background: bool = False
          ) -> Optional[ThreadingHTTPServer]:
    """Serve HTTP. background=True returns the running server (call its
    `shutdown()` and `server_close()`, then `service.close()`)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    print(f"serving {service.task} on http://{host}:{port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    return None
