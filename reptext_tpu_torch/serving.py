"""Serving layer: coalescing request queue + worker + HTTP JSON API (PyTorch).

Counterpart of ``reptext_tpu/serving.py``:

- :class:`GenerationWorker`: one background thread drains a request queue
  through one resident pipeline. It is the only thread that touches the
  card. Queued requests with the same signature (mode, steps, guidance
  scale, number of text lines, resolution, pre-encoded prompt shape) are
  coalesced onto the batch axis of one sampler call
  (``pipeline.generate_batch``), up to ``max_batch``; a lone request runs
  through ``pipeline.__call__``. Requests with a resolution run on a view of
  the pipeline at that size (``with_resolution``: the same modules). When a
  batch runs out of device memory the cap of its resolution is halved, the
  cache is emptied and the same requests run again under the smaller cap; a
  cooldown of successful rounds doubles it back.
- :class:`GenerationServer`: a stdlib HTTP server with ``POST /generate``
  (JSON: prompt, text lines, seed, steps, ... -> a base64 PNG),
  ``GET /healthz`` and ``GET /metrics`` (the ``utils.metrics`` snapshot:
  request counters, batch sizes, queue depth, latency percentiles). Handler
  threads only enqueue and wait.

Unlike the JAX worker, a batch is not padded to a power of two: XLA pads so
that it compiles one graph per bucket, while an eager sampler compiles
nothing and would pay for every padded row in full. There is no IP-Adapter
in the port, so a request that carries an image prompt fails as the JAX
worker's does without an attached adapter. A request must carry
``prompt_embeds`` and ``pooled_embeds`` both or neither.
"""

from __future__ import annotations

import base64
import gc
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from reptext_tpu_torch.utils.metrics import Metrics, default_metrics

NO_ADAPTER = "ip_adapter_images given but no adapter attached"


@dataclass
class GenerationRequest:
    prompt: str
    lines: List[Dict[str, Any]]            # [{text, position, color?, font_size?}]
    seed: int = 42
    num_steps: Optional[int] = None
    guidance_scale: Optional[float] = None
    width: Optional[int] = None            # resolution bucket (x16; default cfg)
    height: Optional[int] = None
    mode: str = "txt2img"                  # "txt2img" | "inpaint"
    image_b64: Optional[str] = None        # inpaint: base64 PNG input image
    mask_b64: Optional[str] = None         # inpaint: base64 PNG white-on-black mask
    negative_prompt: Optional[str] = None  # inpaint true-CFG negative
    ip_image_b64: Optional[str] = None     # image prompt (IP-Adapter: not ported)
    ip_scale: float = 1.0
    # pre-encoded prompt ([S_txt, D] and [D] arrays), both or neither; a
    # batch coalesces only requests that carry them with each other
    prompt_embeds: Optional[np.ndarray] = None
    pooled_embeds: Optional[np.ndarray] = None
    _done: threading.Event = field(default_factory=threading.Event)
    _result: Optional[np.ndarray] = None
    _error: Optional[str] = None

    def __post_init__(self):
        if self.prompt_embeds is not None and self.pooled_embeds is None:
            raise ValueError("prompt_embeds given without pooled_embeds: pass both or neither")
        if self.pooled_embeds is not None and self.prompt_embeds is None:
            raise ValueError("pooled_embeds given without prompt_embeds: pass both or neither")


def _pad_rows(rows: List[np.ndarray], width: Optional[int] = None) -> np.ndarray:
    """[B, width] int64 ids: each row right-padded with 0 (the pad id of both
    vendored tokenizers' models and of the demo ids) to ``width`` (default
    the longest row)."""
    width = width or max(max(r.shape[0] for r in rows), 1)
    out = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


def _decode_png(b64: str, mode: str, size) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return np.asarray(img.convert(mode).resize(size), np.uint8)


class GenerationWorker:
    """Drains a queue through a resident pipeline on a worker thread,
    coalescing compatible requests into batched sampler calls."""

    def __init__(self, pipeline, tokenizer=None, max_queue: int = 64,
                 max_batch: int = 4, batch_window_s: float = 0.0,
                 metrics: Optional[Metrics] = None, inpaint_pipeline=None):
        self.pipeline = pipeline
        self.inpaint_pipeline = inpaint_pipeline
        self.tokenizer = tokenizer  # callable(prompt) -> (clip_ids, t5_ids)
        self.requests: "queue.Queue[GenerationRequest]" = queue.Queue(max_queue)
        self.max_batch = max(1, max_batch)
        self.batch_window_s = batch_window_s
        # device-OOM degradation state: the coalescing cap is shrunk per
        # resolution bucket (OOM is resolution-dependent), never globally,
        # and restored by doubling after a cooldown of successful rounds.
        self._oom_caps: Dict = {}     # (w, h) -> shrunken cap
        self._oom_success: Dict = {}  # (w, h) -> consecutive OK batches
        self.oom_restore_after = 8    # successful rounds before cap doubles
        self.metrics = metrics if metrics is not None else default_metrics
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._pending: List[GenerationRequest] = []  # worker-thread only
        self._res_pipelines: Dict = {}               # (h, w) -> pipeline view
        self.completed = 0
        self.failed = 0
        self.batches = 0

    def start(self):
        self._thread.start()
        return self

    def warmup(self, text: str = "Hi", position=(16, 16),
               prompt_embeds=None, pooled_embeds=None) -> float:
        """Run one dummy request before accepting traffic; returns seconds
        (the first request pays for cuBLAS's and the kernels' first use)."""
        req = GenerationRequest(
            prompt="warmup", lines=[{"text": text, "position": list(position)}],
            prompt_embeds=prompt_embeds, pooled_embeds=pooled_embeds,
        )
        t0 = time.time()
        self.submit(req)
        req._done.wait()
        if req._error:
            raise RuntimeError(f"warmup failed: {req._error}")
        return time.time() - t0

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def submit(self, req: GenerationRequest) -> GenerationRequest:
        self.requests.put(req, block=False)
        self.metrics.inc("serving.requests_submitted")
        return req

    def conditions(self, req: GenerationRequest, width: int, height: int):
        """The request's text lines rendered into glyph conditions at
        ``width`` x ``height`` (``conditioning.build_conditions``)."""
        from reptext_tpu_torch.conditioning import TextLine, build_conditions

        lines = [TextLine(l["text"], tuple(l["position"]),
                          tuple(l.get("color", (255, 255, 255))),
                          font_size=l.get("font_size"))
                 for l in req.lines]
        return build_conditions(lines, width, height)

    # ----------------------------------------------------------- internals

    @staticmethod
    def _signature(req: GenerationRequest):
        # pre-encoded and prompt-string requests never coalesce (mixing
        # would tokenize the embed-carriers' placeholder prompt)
        pe_shape = (None if req.prompt_embeds is None
                    else tuple(np.asarray(req.prompt_embeds).shape))
        return (req.mode, req.num_steps, req.guidance_scale, len(req.lines),
                req.width, req.height, pe_shape)

    @staticmethod
    def _res_key(req: GenerationRequest):
        return (req.width, req.height)

    def _cap_for(self, req: GenerationRequest) -> int:
        """Effective coalescing cap: configured max_batch, tightened by any
        live OOM shrink for this request's resolution bucket."""
        return min(self.max_batch,
                   self._oom_caps.get(self._res_key(req), self.max_batch))

    def _note_batch_ok(self, req: GenerationRequest) -> None:
        """Cooldown-based cap restore: after `oom_restore_after` successful
        rounds at a shrunken cap, double it; drop the entry once it reaches
        the configured max_batch again."""
        key = self._res_key(req)
        if key not in self._oom_caps:
            return
        self._oom_success[key] = self._oom_success.get(key, 0) + 1
        if self._oom_success[key] >= self.oom_restore_after:
            self._oom_success[key] = 0
            self._oom_caps[key] *= 2
            if self._oom_caps[key] >= self.max_batch:
                del self._oom_caps[key]
                self._oom_success.pop(key, None)

    def _pipeline_for(self, req: GenerationRequest):
        """Resolution-bucket routing: one pipeline view per (height, width),
        all sharing the resident modules (``with_resolution``)."""
        if req.width is None and req.height is None:
            return self.pipeline
        cfg = self.pipeline.pipe_cfg
        key = (int(req.height or cfg.height), int(req.width or cfg.width))
        if key not in self._res_pipelines:
            self._res_pipelines[key] = self.pipeline.with_resolution(*key)
        return self._res_pipelines[key]

    def _tokenize(self, prompt: str):
        if self.tokenizer is not None:
            return self.tokenizer(prompt)
        from reptext_tpu_torch.cli import _tokenize

        return _tokenize(prompt, self.pipeline.clip.config, self.pipeline.t5.config, None,
                         self.pipeline.pipe_cfg.max_sequence_length)

    def _collect_batch(self) -> List[GenerationRequest]:
        """Pop one request (blocking briefly), then gather every queued
        request with the same signature, up to the cap. Non-matching
        requests stay pending in arrival order."""
        if not self._pending:
            try:
                self._pending.append(self.requests.get(timeout=0.2))
            except queue.Empty:
                return []
        if self.batch_window_s > 0:
            time.sleep(self.batch_window_s)  # linger: let a burst arrive
        while True:
            try:
                self._pending.append(self.requests.get_nowait())
            except queue.Empty:
                break
        lead = self._pending[0]
        sig = self._signature(lead)
        cap = self._cap_for(lead)
        batch, rest = [], []
        for r in self._pending:
            if len(batch) < cap and self._signature(r) == sig:
                batch.append(r)
            else:
                rest.append(r)
        self._pending = rest
        return batch

    def _run_single(self, req: GenerationRequest) -> None:
        """A lone txt2img request through ``__call__``."""
        if req.ip_image_b64:
            raise ValueError(NO_ADAPTER)
        pipe = self._pipeline_for(req)
        cfg = pipe.pipe_cfg
        conds = self.conditions(req, cfg.width, cfg.height)
        if req.prompt_embeds is not None:
            prompt_kwargs = {"prompt_embeds": torch.as_tensor(req.prompt_embeds)[None],
                             "pooled_embeds": torch.as_tensor(req.pooled_embeds)[None]}
        else:
            clip_ids, t5_ids = self._tokenize(req.prompt)
            prompt_kwargs = {"clip_ids": clip_ids, "t5_ids": t5_ids}
        images = pipe(conds, seed=req.seed, num_inference_steps=req.num_steps,
                      guidance_scale=req.guidance_scale, **prompt_kwargs)
        req._result = np.asarray(images[0])

    def _run_batch(self, batch: List[GenerationRequest]) -> None:
        """B same-signature txt2img requests in one ``generate_batch`` call."""
        pipe = self._pipeline_for(batch[0])  # resolution is in the signature
        cfg = pipe.pipe_cfg
        conds_list = [self.conditions(req, cfg.width, cfg.height) for req in batch]
        if batch[0].prompt_embeds is not None:   # the signature makes it all or none
            kwargs = {"prompt_embeds": torch.as_tensor(np.stack([r.prompt_embeds
                                                                 for r in batch])),
                      "pooled_embeds": torch.as_tensor(np.stack([r.pooled_embeds
                                                                 for r in batch]))}
        else:
            ids = [self._tokenize(req.prompt) for req in batch]
            kwargs = {"clip_ids": _pad_rows([np.asarray(c)[0] for c, _ in ids]),
                      "t5_ids": _pad_rows([np.asarray(t)[0] for _, t in ids])}
        lead = batch[0]
        images = pipe.generate_batch(
            conds_list, seeds=[r.seed for r in batch], num_inference_steps=lead.num_steps,
            guidance_scale=lead.guidance_scale,
            ip_adapter_images=[r.ip_image_b64 for r in batch], **kwargs)
        for i, req in enumerate(batch):
            req._result = np.asarray(images[i])

    def _inpaint_inputs(self, req: GenerationRequest, cfg):
        """(conditions, image, mask, (clip, t5), (negative clip, t5)) of one
        inpaint request at the inpaint pipeline's size."""
        from reptext_tpu_torch.pipelines.inpaint import DEFAULT_NEGATIVE_PROMPT

        if not req.image_b64 or not req.mask_b64:
            raise ValueError("inpaint requires image_b64 and mask_b64 (PNG)")
        size = (cfg.width, cfg.height)
        return (self.conditions(req, cfg.width, cfg.height),
                _decode_png(req.image_b64, "RGB", size), _decode_png(req.mask_b64, "L", size),
                self._tokenize(req.prompt),
                self._tokenize(req.negative_prompt or DEFAULT_NEGATIVE_PROMPT))

    def _run_inpaint(self, batch: List[GenerationRequest]) -> None:
        """Text inpainting: a lone request through ``__call__``, B
        same-signature requests in one dual-ControlNet true-CFG
        ``generate_batch`` call."""
        if self.inpaint_pipeline is None:
            raise RuntimeError("server was started without an inpaint pipeline "
                               "(cli: --serve-inpaint)")
        pipe = self.inpaint_pipeline
        inputs = [self._inpaint_inputs(req, pipe.pipe_cfg) for req in batch]
        # true CFG concatenates [negative; positive] T5 embeds: one length for both
        t5_width = max(np.asarray(ids[1]).shape[1] for x in inputs for ids in x[3:])
        clip = _pad_rows([np.asarray(x[3][0])[0] for x in inputs])
        t5 = _pad_rows([np.asarray(x[3][1])[0] for x in inputs], t5_width)
        neg_clip = _pad_rows([np.asarray(x[4][0])[0] for x in inputs])
        neg_t5 = _pad_rows([np.asarray(x[4][1])[0] for x in inputs], t5_width)
        lead = batch[0]
        kw = dict(clip_ids=clip, t5_ids=t5, negative_clip_ids=neg_clip, negative_t5_ids=neg_t5,
                  num_inference_steps=lead.num_steps, guidance_scale=lead.guidance_scale)
        if len(batch) == 1:
            conds, image, mask = inputs[0][:3]
            out = pipe(conds, image=image, mask=mask, seed=lead.seed, **kw)
        else:
            out = pipe.generate_batch([x[0] for x in inputs], [x[1] for x in inputs],
                                      [x[2] for x in inputs], seeds=[r.seed for r in batch],
                                      **kw)
        for i, req in enumerate(batch):
            req._result = np.asarray(out[i])

    @staticmethod
    def _is_oom(e: Exception) -> bool:
        """Device memory exhaustion: torch's OutOfMemoryError, or an error
        whose text says so."""
        if isinstance(e, torch.OutOfMemoryError):
            return True
        msg = f"{type(e).__name__}: {e}"
        return any(s in msg for s in (
            "RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
            "Attempting to allocate", "OOM",
        ))

    def _process_once(self) -> int:
        """One scheduling round: collect a batch, run it, resolve futures.
        Returns the number of requests served (0 if the queue was idle or
        the batch was put back after running out of memory)."""
        batch = self._collect_batch()
        if not batch:
            return 0
        t0 = time.perf_counter()
        failure = None
        try:
            with torch.inference_mode():
                if batch[0].mode == "inpaint":
                    self._run_inpaint(batch)
                elif len(batch) == 1:
                    self._run_single(batch[0])
                else:
                    self._run_batch(batch)
        except Exception as e:  # noqa: BLE001 — reported to the client
            failure = (self._is_oom(e), f"{type(e).__name__}: {e}")
        if failure is None:
            self.completed += len(batch)
            self.batches += 1
            self._note_batch_ok(batch[0])
            self.metrics.inc("serving.requests_completed", len(batch))
            self.metrics.inc("serving.batches")
            self.metrics.observe("serving.batch_size", float(len(batch)))
            self.metrics.observe("serving.generate_s", time.perf_counter() - t0)
        else:
            oom, msg = failure
            if oom:
                # outside the except: the traceback no longer pins the
                # failed attempt's tensors, so their memory can be returned
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
            if oom and len(batch) > 1:
                # shrink the coalescing cap for THIS resolution bucket to half
                # the failed batch and retry the same requests next round (no
                # request fails or resolves; they re-batch under the smaller
                # cap); _note_batch_ok restores the cap after a cooldown
                key = self._res_key(batch[0])
                self._oom_caps[key] = max(1, len(batch) // 2)
                self._oom_success[key] = 0
                self._pending = batch + self._pending
                self.metrics.inc("serving.oom_batch_splits")
                self.metrics.set("serving.max_batch", float(self._cap_for(batch[0])))
                self.metrics.set("serving.queue_depth",
                                 self.requests.qsize() + len(self._pending))
                return 0
            for req in batch:
                req._error = msg
            self.failed += len(batch)
            self.metrics.inc("serving.requests_failed", len(batch))
            if oom:
                self.metrics.inc("serving.oom_failures")
        self.metrics.set("serving.queue_depth", self.requests.qsize() + len(self._pending))
        for req in batch:
            req._done.set()
        return len(batch)

    def _loop(self):
        device = getattr(self.pipeline, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)   # a card other than cuda:0
        while not self._stop.is_set():
            self._process_once()


def _png_b64(image: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _make_handler(worker: GenerationWorker, timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "completed": worker.completed,
                    "failed": worker.failed,
                    "queued": worker.requests.qsize(),
                })
            elif self.path == "/metrics":
                self._json(200, worker.metrics.snapshot())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                mode = payload.get("mode", "txt2img")
                if mode not in ("txt2img", "inpaint"):
                    self._json(400, {"error": f"unknown mode {mode!r}"})
                    return
                req = GenerationRequest(
                    prompt=payload["prompt"],
                    lines=payload.get("lines", []),
                    seed=int(payload.get("seed", 42)),
                    num_steps=payload.get("num_steps"),
                    guidance_scale=payload.get("guidance_scale"),
                    width=payload.get("width"),
                    height=payload.get("height"),
                    mode=mode,
                    image_b64=payload.get("image_png_base64"),
                    mask_b64=payload.get("mask_png_base64"),
                    negative_prompt=payload.get("negative_prompt"),
                    ip_image_b64=payload.get("ip_image_png_base64"),
                    ip_scale=float(payload.get("ip_scale", 1.0)),
                )
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                worker.submit(req)
            except queue.Full:
                self._json(503, {"error": "queue full"})
                return
            if not req._done.wait(timeout=timeout_s):
                self._json(504, {"error": "generation timed out"})
                return
            if req._error:
                self._json(500, {"error": req._error})
                return
            self._json(200, {"image_png_base64": _png_b64(req._result),
                             "shape": list(req._result.shape)})

    return Handler


class GenerationServer:
    """HTTP front over a GenerationWorker. ``serve_forever`` blocks."""

    def __init__(self, pipeline, host: str = "127.0.0.1", port: int = 8470,
                 tokenizer=None, request_timeout_s: float = 600.0,
                 warmup: bool = False, max_batch: int = 4,
                 batch_window_s: float = 0.0, inpaint_pipeline=None,
                 metrics: Optional[Metrics] = None):
        self.worker = GenerationWorker(
            pipeline, tokenizer, max_batch=max_batch, batch_window_s=batch_window_s,
            metrics=metrics, inpaint_pipeline=inpaint_pipeline,
        ).start()
        if warmup:
            self.worker.warmup()
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.worker, request_timeout_s)
        )

    @property
    def address(self):
        return self.httpd.server_address

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.worker.stop()
