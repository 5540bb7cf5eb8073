"""Serving host: dynamic-batching HTTP inference for CLIP towers on the card.

The port of declip_tpu/tools/serve.py. One model, resident on one device
(CUDA unless ``--device`` asks for the CPU); every self-attention of both
towers runs through the Hopper kernel (ops/flash_attention.py) on CUDA.

- **power-of-two batch buckets**: requests are coalesced and padded to
  ``1, 2, 4, ... --max-batch`` rows, so the towers see a bounded set of
  shapes;
- **dynamic batching**: HTTP handler threads only enqueue; a single compute
  thread drains the queue (up to ``--max-batch`` rows, waiting at most
  ``--max-wait-ms`` to coalesce), which also keeps all device work on one
  thread;
- **model source**: a live experiment config, from its newest
  ``checkpoints/ckpt*.pth.tar`` or, if there is none, from seeded random
  weights (``--config``); or the ``torch.export`` artifacts of
  ``python -m declip_tpu_torch.tools.convert --export-serving``
  (``--exported DIR``), the counterpart of the JAX package's
  ``--stablehlo``. An artifact calls K1's registered operator, so serving
  it launches K1 on the card too, and it runs on the device it was
  exported on. Inference computes in float32;
- **int8**: ``--int8`` serves the live model with every Dense product in
  int8 (``ops/quant.py``). An artifact is quantized when it is exported
  (``convert --export-serving --quantize int8``), so ``--int8`` with
  ``--exported`` is an error, as ``--int8`` with ``--stablehlo`` is in the
  JAX package. ``--stablehlo`` is refused: the port cannot run StableHLO.

Endpoints (JSON over HTTP, stdlib server — no framework dependency):

- ``POST /v1/encode_text``  ``{"texts": [...]}`` or ``{"tokens": [[...]]}``
- ``POST /v1/encode_image`` ``{"arrays": [[[...]]]}`` (preprocessed
  ``[H, W, 3]`` float rows) or ``{"images_b64": [...]}`` (encoded image
  files; decoded + ONECROP-preprocessed server-side)
- both accept ``"normalize": true`` for unit-norm embeddings
- ``GET /healthz``, ``GET /stats``

Usage::

    python -m declip_tpu_torch.tools.serve --config experiments/.../config.yaml
    python -m declip_tpu_torch.tools.serve --config ... --int8
    python -m declip_tpu_torch.tools.serve --exported <dir from convert>
    python -m declip_tpu_torch.tools.serve --config ... --device cpu
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np
import torch

from declip_tpu_torch.ops.quant import int8_inference

__all__ = ["Batcher", "ServingHost", "main"]


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class _Item:
    __slots__ = ("rows", "event", "result", "error", "t_enq")

    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.t_enq = time.perf_counter()


class Batcher:
    """Coalesce per-request rows into bucketed batches on one compute thread.

    ``runners`` maps a kind ("image"/"text") to a callable taking a padded
    ``[bucket, ...]`` array and returning ``[bucket, dim]`` embeddings.
    """

    def __init__(self, runners: Dict[str, Callable[[np.ndarray], np.ndarray]],
                 max_batch: int = 64, max_wait_ms: float = 5.0):
        self.runners = runners
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._cond = threading.Condition()
        self._queues: Dict[str, deque] = {k: deque() for k in runners}
        self._stop = threading.Event()
        self.stats = {
            "requests": 0, "rows": 0, "batches": 0, "padded_rows": 0,
            "errors": 0,
        }
        self._lat: deque = deque(maxlen=512)  # seconds, per request

    # ---- request side (any thread) ----

    def submit(self, kind: str, rows: np.ndarray,
               timeout: float = 120.0) -> np.ndarray:
        if kind not in self._queues:
            raise KeyError(f"no runner for kind {kind!r}")
        n = int(rows.shape[0])
        if n < 1:
            raise ValueError("empty request")
        if n > self.max_batch:
            raise ValueError(
                f"request rows {n} > max_batch {self.max_batch}; split it")
        item = _Item(rows)
        with self._cond:
            self._queues[kind].append(item)
            self.stats["requests"] += 1
            self.stats["rows"] += n
            self._cond.notify_all()
        if not item.event.wait(timeout):
            raise TimeoutError(f"inference timed out after {timeout}s")
        self._lat.append(time.perf_counter() - item.t_enq)
        if item.error is not None:
            raise item.error
        return item.result

    # ---- compute side (single thread) ----

    def run_forever(self, stop: Optional[threading.Event] = None) -> None:
        stop = stop or self._stop
        while not stop.is_set():
            batch = self._collect(stop)
            if batch is None:
                continue
            kind, items = batch
            self._execute(kind, items)
        # drain: fail anything still queued so submitters unblock
        with self._cond:
            leftovers = [(k, i) for k, q in self._queues.items() for i in q]
            for q in self._queues.values():
                q.clear()
        for _, item in leftovers:
            item.error = RuntimeError("server shutting down")
            item.event.set()

    def shutdown(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    def _collect(self, stop: threading.Event):
        """Wait for work, then give later arrivals max_wait to coalesce."""
        with self._cond:
            while not any(self._queues.values()):
                if stop.is_set():
                    return None
                self._cond.wait(0.05)
            deadline = time.perf_counter() + self.max_wait
            while True:
                kind = max(self._queues,
                           key=lambda k: sum(i.rows.shape[0]
                                             for i in self._queues[k]))
                pending = sum(i.rows.shape[0] for i in self._queues[kind])
                remaining = deadline - time.perf_counter()
                if pending >= self.max_batch or remaining <= 0:
                    break
                self._cond.wait(remaining)
            items, total = [], 0
            q = self._queues[kind]
            while q and total + q[0].rows.shape[0] <= self.max_batch:
                item = q.popleft()
                items.append(item)
                total += item.rows.shape[0]
            return kind, items

    def _execute(self, kind: str, items) -> None:
        rows = np.concatenate([i.rows for i in items], axis=0)
        n = rows.shape[0]
        b = _bucket(n, self.max_batch)
        if b > n:
            pad = np.zeros((b - n,) + rows.shape[1:], rows.dtype)
            rows = np.concatenate([rows, pad], axis=0)
        try:
            out = np.asarray(self.runners[kind](rows))[:n]
        except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
            self.stats["errors"] += len(items)
            for item in items:
                item.error = e
                item.event.set()
            return
        self.stats["batches"] += 1
        self.stats["padded_rows"] += b - n
        off = 0
        for item in items:
            k = item.rows.shape[0]
            item.result = out[off:off + k]
            off += k
            item.event.set()

    def latency_ms(self) -> Dict[str, float]:
        if not self._lat:
            return {"p50": 0.0, "p95": 0.0}
        arr = np.sort(np.asarray(self._lat))
        return {"p50": round(float(arr[len(arr) // 2]) * 1e3, 2),
                "p95": round(float(arr[int(len(arr) * 0.95) - 1]) * 1e3, 2)}


class ServingHost:
    """Batcher + preprocessing + HTTP front end over one model."""

    def __init__(self, runners: Dict[str, Callable], tokenizer=None,
                 preprocess=None, max_batch: int = 64,
                 max_wait_ms: float = 5.0, meta: Optional[dict] = None,
                 model: Optional[torch.nn.Module] = None):
        self.batcher = Batcher(runners, max_batch, max_wait_ms)
        self.tokenizer = tokenizer
        self.preprocess = preprocess  # PIL.Image -> [H, W, 3] float array
        self.meta = dict(meta or {})
        self.model = model
        self._httpd: Optional[ThreadingHTTPServer] = None

    # ---- constructors ----

    @classmethod
    def from_config(cls, config_path: str, device: str = "cuda",
                    bpe_path: Optional[str] = None, int8: bool = False,
                    **kw) -> "ServingHost":
        """Serve the experiment's model (newest checkpoint, else seeded
        random weights) on ``device``; with ``int8`` every Dense product
        runs in int8 (ops/quant.py)."""
        from declip_tpu_torch.tools._common import load_eval_model, resolve_device

        device = resolve_device(device)
        model = load_eval_model(config_path, device)
        # the int8 context holds on the thread that enters it: the compute
        # thread enters it at each call
        quant = int8_inference if int8 else contextlib.nullcontext

        def run(tower, rows: np.ndarray) -> np.ndarray:
            with torch.inference_mode(), quant():
                out = tower(torch.from_numpy(rows).to(device))
            return out.float().cpu().numpy()

        runners = {
            "image": lambda rows: run(model.encode_image,
                                      rows.astype(np.float32)),
            "text": lambda rows: run(model.encode_text,
                                     rows.astype(np.int64)),
        }
        return cls._host(runners, model.visual.input_resolution, bpe_path,
                         {"source": config_path, "device": str(device),
                          "int8": int8}, model=model, **kw)

    @classmethod
    def from_exported(cls, artifact_dir: str, device: str = "cuda",
                      bpe_path: Optional[str] = None,
                      **kw) -> "ServingHost":
        """Serve the ``torch.export`` artifacts in ``artifact_dir``
        (``encode_image.pt2``, ``encode_text.pt2``; either may be absent)
        on ``device``, the device they were exported on. The input
        resolution is read from the image artifact's input spec."""
        from declip_tpu_torch.tools._common import resolve_device
        from declip_tpu_torch.tools.convert import ARTIFACTS

        device = resolve_device(device)
        runners: Dict[str, Callable] = {}
        res = 224
        for kind, fname in ARTIFACTS.items():
            path = os.path.join(artifact_dir, fname)
            if not os.path.exists(path):
                continue
            program = torch.export.load(path)
            (spec,) = [n.meta["val"] for n in program.graph.find_nodes(
                op="placeholder") if n.name in
                program.graph_signature.user_inputs]
            if spec.device.type != device.type:
                raise ValueError(
                    f"{path} was exported on {spec.device.type}; serve it "
                    f"there, or export again with --device {device.type}")
            if kind == "image":
                res = int(spec.shape[1])
            module = program.module()
            dtype = np.float32 if kind == "image" else np.int64

            def run(rows: np.ndarray, module=module,
                    dtype=dtype) -> np.ndarray:
                with torch.no_grad():
                    out = module(torch.from_numpy(rows.astype(dtype))
                                 .to(device))
                return out.float().cpu().numpy()

            runners[kind] = run
        if not runners:
            raise FileNotFoundError(
                f"no {' or '.join(ARTIFACTS.values())} under "
                f"{artifact_dir!r} (write them with python -m "
                f"declip_tpu_torch.tools.convert --export-serving)")
        return cls._host(runners, res, bpe_path,
                         {"source": artifact_dir, "device": str(device)},
                         **kw)

    @classmethod
    def _host(cls, runners, res: int, bpe_path: Optional[str], meta: dict,
              **kw) -> "ServingHost":
        from declip_tpu_torch.data.transforms import build_common_augmentation
        from declip_tpu_torch.tokenizer import get_tokenizer

        onecrop = {224: "ONECROP", 256: "ONECROP256",
                   384: "ONECROP384"}.get(res)
        preprocess = (build_common_augmentation(onecrop)
                      if onecrop else None)
        return cls(runners, tokenizer=get_tokenizer(bpe_path),
                   preprocess=preprocess,
                   meta={**meta, "input_resolution": res}, **kw)

    # ---- request handling (called from HTTP handler threads) ----

    def encode_text(self, body: dict) -> dict:
        if "tokens" in body:
            toks = np.asarray(body["tokens"], np.int32)
            if toks.ndim != 2:
                raise ValueError("'tokens' must be [n, context] ints")
        elif "texts" in body:
            if self.tokenizer is None:
                raise ValueError("no tokenizer on this host; send 'tokens'")
            texts = list(body["texts"])
            if not texts:
                raise ValueError("'texts' is empty")
            toks = np.asarray(self.tokenizer.tokenize(texts), np.int32)
        else:
            raise ValueError("need 'texts' or 'tokens'")
        emb = self.batcher.submit("text", toks)
        return self._emit(emb, body)

    def encode_image(self, body: dict) -> dict:
        if "arrays" in body:
            rows = np.asarray(body["arrays"], np.float32)
            if rows.ndim == 3:
                rows = rows[None]
            if rows.ndim != 4 or rows.shape[-1] != 3:
                raise ValueError("'arrays' must be [n, H, W, 3] floats")
        elif "images_b64" in body:
            if self.preprocess is None:
                raise ValueError(
                    "no preprocess pipeline on this host; send 'arrays'")
            from PIL import Image
            imgs = []
            for b64 in body["images_b64"]:
                img = Image.open(
                    io.BytesIO(base64.b64decode(b64))).convert("RGB")
                imgs.append(np.asarray(self.preprocess(img), np.float32))
            if not imgs:
                raise ValueError("'images_b64' is empty")
            rows = np.stack(imgs)
        else:
            raise ValueError("need 'arrays' or 'images_b64'")
        emb = self.batcher.submit("image", rows)
        return self._emit(emb, body)

    @staticmethod
    def _emit(emb: np.ndarray, body: dict) -> dict:
        emb = np.asarray(emb, np.float32)
        if body.get("normalize"):
            emb = emb / np.maximum(
                np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        return {"embeddings": emb.tolist(), "dim": int(emb.shape[-1]),
                "batch": int(emb.shape[0])}

    def stats(self) -> dict:
        s = dict(self.batcher.stats)
        s["latency_ms"] = self.batcher.latency_ms()
        if s["batches"]:
            s["mean_rows_per_batch"] = round(s["rows"] / s["batches"], 2)
        s.update(self.meta)
        return s

    # ---- server lifecycle ----

    def start_http(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the HTTP front end on a daemon thread; returns the port."""
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    def serve_forever(self) -> None:
        """Run the compute loop on the CALLING thread (keep it the main
        thread in production — see module docstring)."""
        try:
            self.batcher.run_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self.batcher.shutdown()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None


def _make_handler(hostobj: ServingHost):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet; /stats has the counters
            pass

        def _reply(self, code: int, payload: dict):
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "device": hostobj.meta.get("device"),
                                  "kinds": sorted(hostobj.batcher.runners)})
            elif self.path == "/stats":
                self._reply(200, hostobj.stats())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/v1/encode_text":
                    self._reply(200, hostobj.encode_text(body))
                elif self.path == "/v1/encode_image":
                    self._reply(200, hostobj.encode_image(body))
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            except (ValueError, KeyError) as e:
                self._reply(400, {"error": str(e)})
            except TimeoutError as e:
                self._reply(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--config", help="experiment config (live model)")
    src.add_argument("--exported",
                     help="directory from python -m "
                          "declip_tpu_torch.tools.convert --export-serving")
    src.add_argument("--stablehlo",
                     help="refused: the port serves torch.export artifacts "
                          "(--exported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--int8", action="store_true",
                    help="int8 Dense products (ops/quant.py; live model "
                         "only). Slower than fp32 on an H100 today: "
                         "1.5-4.0x its wall time a call")
    ap.add_argument("--bpe", default=os.environ.get("DECLIP_BPE_PATH"),
                    help="BPE merges for server-side tokenization")
    args = ap.parse_args(argv)
    if args.stablehlo:
        ap.error("--stablehlo: the PyTorch port cannot run StableHLO; "
                 "export with python -m declip_tpu_torch.tools.convert "
                 "--export-serving and serve with --exported DIR")

    kw = {"device": args.device, "bpe_path": args.bpe,
          "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms}
    if args.config:
        host = ServingHost.from_config(args.config, int8=args.int8, **kw)
    else:
        if args.int8:
            ap.error("--int8 applies to --config; quantized artifacts come "
                     "from convert --export-serving --quantize int8")
        host = ServingHost.from_exported(args.exported, **kw)
    port = host.start_http(args.host, args.port)
    print(f"serving on {args.host}:{port} ({host.meta['device']}, "
          f"kinds: {sorted(host.batcher.runners)})", flush=True)
    host.serve_forever()


if __name__ == "__main__":
    main()
