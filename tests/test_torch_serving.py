"""The port's serving layer (``reptext_tpu_torch/serving.py``): every test of
tests/test_serving.py on the port's HTTP server and worker over the tiny
pipeline on the CPU (float32), plus what the port adds.

- The JAX worker pads each batch to a power of two so that XLA compiles one
  graph per bucket; the port coalesces the requests that are there (an eager
  sampler would pay for every padded row), so batch sizes here count real
  requests: three queued requests run as a batch of 3, not 4.
- No IP-Adapter is ported: a request with an image prompt fails as the JAX
  worker's does without an attached adapter.
- A request carries ``prompt_embeds`` and ``pooled_embeds`` both or neither.
- A request gives the same image alone (``__call__``) and in a batch
  (``generate_batch``): latents within 5e-4 on the CPU in float32, for
  txt2img and inpainting.
- The samplers' per-image [N, B, S, F] conditions against the JAX samplers
  over the same stub models (1e-5, as tests/test_torch_velocity_cache.py).
"""

import base64
import dataclasses
import http.client
import io
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.serving import NO_ADAPTER, GenerationRequest, GenerationServer, GenerationWorker
from reptext_tpu_torch.utils.metrics import Metrics

from torch_port_util import port_config, port_configs_of

H = W = 64
CFGS = dict(flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
            vae_cfg=VAEConfig().tiny(), clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny())
PIPE_CFG = PipelineConfig(height=H, width=W, num_inference_steps=2,
                          controlnet_conditioning_step=1, true_guidance_scale=2.0)
BATCH_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def server():
    pipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), device="cpu", seed=0,
                                      **port_configs_of(CFGS))
    srv = GenerationServer(pipe, host="127.0.0.1", port=0, request_timeout_s=600)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    t.join(timeout=30)


@pytest.fixture(scope="module")
def inpaint_pipe(server):
    return FluxRepTextInpaintPipeline.from_pipeline(server.worker.pipeline, seed=7)


def _request(server, method, path, payload=None):
    host, port = server.address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=600)
    body = json.dumps(payload) if payload is not None else None
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _png_b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _inpaint_inputs():
    img = np.random.default_rng(0).integers(0, 255, (H, W, 3), np.uint8).astype(np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[16:48, 16:48] = 255
    return img, mask


LINES1 = [{"text": "Hi", "position": [8, 16]}]
LINES2 = [{"text": "Yo", "position": [4, 8]}]


# ------------------------------------------------ tests/test_serving.py, mirrored


def test_healthz(server):
    status, data = _request(server, "GET", "/healthz")
    assert status == 200 and data["ok"] is True


def test_generate_roundtrip(server):
    status, data = _request(server, "POST", "/generate", {
        "prompt": "a neon sign",
        "lines": [{"text": "Hi", "position": [8, 16], "font_size": 24}],
        "seed": 7,
    })
    assert status == 200, data
    png = base64.b64decode(data["image_png_base64"])
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert data["shape"] == [H, W, 3]


def test_bad_request(server):
    status, data = _request(server, "POST", "/generate", {"lines": []})
    assert status == 400
    status, _ = _request(server, "POST", "/nope", {})
    assert status == 404


def test_metrics_endpoint(server):
    status, data = _request(server, "GET", "/metrics")
    assert status == 200
    assert "counters" in data and "timings" in data and "gauges" in data
    # the earlier generate test must have been counted
    assert data["counters"].get("serving.requests_completed", 0) >= 1


def test_worker_coalesces_same_signature_batch(server):
    """Queued same-signature requests are served by ONE batched call, at
    their real count (3: the JAX worker would pad to a bucket of 4)."""
    m = Metrics()
    worker = GenerationWorker(server.worker.pipeline, max_batch=4, metrics=m)
    calls = []
    real = worker.pipeline.generate_batch

    class Spy:
        def __getattr__(self, name):
            return getattr(server.worker.pipeline, name)

        def generate_batch(self, conds, **kw):
            calls.append(len(conds))
            return real(conds, **kw)

    worker.pipeline = Spy()
    reqs = [GenerationRequest(prompt=f"sign {i}", lines=LINES1 if i % 2 else LINES2,
                              seed=3 + i) for i in range(3)]
    for r in reqs:
        worker.submit(r)
    assert worker._process_once() == 3
    assert worker.batches == 1 and worker.completed == 3 and calls == [3]
    assert all(r._error is None for r in reqs), [r._error for r in reqs]
    assert all(r._result.shape == (H, W, 3) for r in reqs)
    assert not (reqs[0]._result == reqs[1]._result).all()  # distinct seeds/conds
    assert m.snapshot()["timings"]["serving.batch_size"]["max_s"] == 3.0


def test_worker_splits_mismatched_signatures(server):
    """Different (steps, guidance, n_lines) must NOT coalesce."""
    worker = GenerationWorker(server.worker.pipeline, max_batch=4, metrics=Metrics())
    r1 = GenerationRequest(prompt="a", lines=LINES1)
    r2 = GenerationRequest(prompt="b", lines=LINES1, num_steps=1)
    worker.submit(r1)
    worker.submit(r2)
    assert worker._process_once() == 1  # only r1's signature batch
    assert r1._done.is_set() and not r2._done.is_set()
    assert worker._process_once() == 1  # r2 follows
    assert r2._done.is_set() and r2._error is None


def test_unknown_mode_rejected(server):
    status, data = _request(server, "POST", "/generate", {"prompt": "x", "mode": "video"})
    assert status == 400 and "mode" in data["error"]


def test_inpaint_request_roundtrip(server, inpaint_pipe):
    """Served inpaint: dual-ControlNet CFG request through the worker."""
    worker = GenerationWorker(server.worker.pipeline, inpaint_pipeline=inpaint_pipe)
    img, mask = _inpaint_inputs()
    req = GenerationRequest(prompt="a sign", lines=LINES1, mode="inpaint",
                            image_b64=_png_b64(img), mask_b64=_png_b64(mask))
    worker.submit(req)
    assert worker._process_once() == 1
    assert req._error is None, req._error
    assert req._result.shape == (H, W, 3)


def test_resolution_bucket_roundtrip(server):
    """Per-request resolution rides a bucket pipeline sharing the resident modules."""
    status, data = _request(server, "POST", "/generate", {
        "prompt": "a sign",
        "lines": [{"text": "Hi", "position": [8, 16], "font_size": 20}],
        "width": 80,
    })
    assert status == 200, data
    assert data["shape"] == [H, 80, 3]
    view = server.worker._res_pipelines[(H, 80)]
    base = server.worker.pipeline
    assert view.pipe_cfg.width == 80 and base.pipe_cfg.width == W
    assert all(getattr(view, m) is getattr(base, m) for m in ("flux", "controlnet", "vae",
                                                              "clip", "t5"))


def test_resolution_must_be_multiple_of_16(server):
    status, data = _request(server, "POST", "/generate", {
        "prompt": "a sign", "lines": LINES1, "width": 50,
    })
    assert status == 500 and "x16" in data["error"]


OOM_ERRORS = {
    "text": lambda: RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 12345 bytes"),
    "type": lambda: torch.OutOfMemoryError("CUDA error: 20.00 GiB requested"),
}


@pytest.mark.parametrize("kind", sorted(OOM_ERRORS))
def test_oom_batch_splits_and_requests_survive(server, kind):
    """A batch that runs out of device memory (torch.OutOfMemoryError by its
    type, or an error whose text says so) shrinks the coalescing cap and the
    same requests complete under the smaller cap: no request fails."""
    real = server.worker.pipeline

    class OOMBatchPipeline:
        pipe_cfg = real.pipe_cfg
        clip = real.clip
        t5 = real.t5

        def generate_batch(self, *a, **k):
            raise OOM_ERRORS[kind]()

        def __call__(self, *a, **k):
            return real(*a, **k)

    m = Metrics()
    worker = GenerationWorker(OOMBatchPipeline(), max_batch=4, metrics=m)
    r1 = GenerationRequest(prompt="a", lines=LINES1)
    r2 = GenerationRequest(prompt="b", lines=LINES2)
    worker.submit(r1)
    worker.submit(r2)
    assert worker._process_once() == 0          # OOM -> split, nothing resolves
    assert worker.max_batch == 4                # configured cap untouched
    assert worker._cap_for(r1) == 1             # shrunk only for this bucket
    assert not r1._done.is_set() and not r2._done.is_set()
    assert worker._process_once() == 1          # retried serially
    assert worker._process_once() == 1
    assert r1._error is None and r2._error is None, (r1._error, r2._error)
    assert r1._result.shape == (H, W, 3) and r2._result.shape == (H, W, 3)
    assert m.snapshot()["counters"]["serving.oom_batch_splits"] == 1
    assert worker.failed == 0


def test_oom_cap_is_per_resolution_and_restores(server):
    """The OOM shrink only caps the failing resolution bucket, and a cooldown
    of successful rounds doubles the cap back up to the configured max."""
    worker = GenerationWorker(server.worker.pipeline, max_batch=4)
    worker.oom_restore_after = 2
    r_small = GenerationRequest(prompt="a", lines=LINES1)
    r_big = GenerationRequest(prompt="a", lines=LINES1, width=W, height=H)
    key = worker._res_key(r_small)
    worker._oom_caps[key] = 1
    worker._oom_success[key] = 0
    assert worker._cap_for(r_small) == 1
    assert worker._cap_for(r_big) == 4          # other bucket unaffected
    worker._note_batch_ok(r_small)
    worker._note_batch_ok(r_small)              # cooldown reached -> cap 2
    assert worker._cap_for(r_small) == 2
    worker._note_batch_ok(r_small)
    worker._note_batch_ok(r_small)              # cap 4 == configured -> drop
    assert worker._cap_for(r_small) == 4
    assert key not in worker._oom_caps


@pytest.mark.parametrize("kind", sorted(OOM_ERRORS))
def test_oom_single_request_fails_cleanly(server, kind):
    real = server.worker.pipeline

    class OOMPipeline:
        pipe_cfg = real.pipe_cfg
        clip = real.clip
        t5 = real.t5

        def __call__(self, *a, **k):
            raise OOM_ERRORS[kind]()

    m = Metrics()
    worker = GenerationWorker(OOMPipeline(), max_batch=2, metrics=m)
    req = GenerationRequest(prompt="a", lines=LINES1)
    worker.submit(req)
    assert worker._process_once() == 1
    assert req._done.is_set() and req._error
    assert ("RESOURCE_EXHAUSTED" if kind == "text" else "OutOfMemoryError") in req._error
    assert m.snapshot()["counters"]["serving.oom_failures"] == 1


def test_inpaint_without_pipeline_errors(server):
    worker = GenerationWorker(server.worker.pipeline)  # no inpaint pipeline
    req = GenerationRequest(prompt="a", lines=[], mode="inpaint",
                            image_b64="eA==", mask_b64="eA==")
    worker.submit(req)
    worker._process_once()
    assert req._error and "inpaint pipeline" in req._error


def test_ip_adapter_request_fails_as_without_an_adapter(server):
    """An image-prompt request coalesces with a plain one as in the JAX
    worker, and the batch fails as the JAX worker's does when no adapter is
    attached (the port has none); a lone one fails the same way."""
    from PIL import Image

    style = np.random.default_rng(0).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(style).save(buf, format="PNG")
    ip_b64 = base64.b64encode(buf.getvalue()).decode()
    worker = GenerationWorker(server.worker.pipeline, max_batch=4, metrics=Metrics())
    r1 = GenerationRequest(prompt="sign A", lines=LINES1, seed=3, ip_image_b64=ip_b64,
                           ip_scale=0.8)
    r2 = GenerationRequest(prompt="sign B", lines=LINES2, seed=9)
    worker.submit(r1)
    worker.submit(r2)
    assert worker._process_once() == 2       # one coalesced batch
    assert r1._error and r2._error and NO_ADAPTER in r1._error and NO_ADAPTER in r2._error
    r3 = GenerationRequest(prompt="sign C", lines=LINES1, ip_image_b64=ip_b64)
    worker.submit(r3)
    assert worker._process_once() == 1 and NO_ADAPTER in r3._error
    assert worker.failed == 3 and worker.completed == 0


def test_worker_coalesces_inpaint_batch(server, inpaint_pipe):
    """Two queued same-signature INPAINT requests are served by ONE batched
    dual-ControlNet CFG sampler call."""
    m = Metrics()
    worker = GenerationWorker(server.worker.pipeline, max_batch=4, metrics=m,
                              inpaint_pipeline=inpaint_pipe)
    img, mask = _inpaint_inputs()
    r1 = GenerationRequest(prompt="sign A", lines=LINES1, mode="inpaint",
                           image_b64=_png_b64(img), mask_b64=_png_b64(mask), seed=3)
    r2 = GenerationRequest(prompt="sign B", lines=LINES2, mode="inpaint",
                           image_b64=_png_b64(img), mask_b64=_png_b64(mask), seed=9)
    worker.submit(r1)
    worker.submit(r2)
    assert worker._process_once() == 2
    assert worker.batches == 1 and worker.completed == 2
    assert r1._error is None and r2._error is None, (r1._error, r2._error)
    assert r1._result.shape == (H, W, 3) and r2._result.shape == (H, W, 3)
    assert not (r1._result == r2._result).all()  # distinct seeds/conds


# -------------------------------------------------------- what the port adds


def test_embeds_pair_is_checked():
    x = np.zeros((4, 8), np.float32)
    with pytest.raises(ValueError, match="pooled_embeds"):
        GenerationRequest(prompt="a", lines=LINES1, prompt_embeds=x)
    with pytest.raises(ValueError, match="prompt_embeds"):
        GenerationRequest(prompt="a", lines=LINES1, pooled_embeds=x[0])


def _conditions(worker, lines):
    return worker.conditions(GenerationRequest(prompt="", lines=lines), W, H)


def test_generate_batch_rows_equal_single_calls(server):
    """Each row of generate_batch (its own conditions, prompt and seed) equals
    __call__ with that seed."""
    pipe, worker = server.worker.pipeline, server.worker
    conds = [_conditions(worker, lines) for lines in (LINES1, LINES2, LINES1)]
    ids = [worker._tokenize(p) for p in ("sign A", "sign B", "sign C")]
    seeds = [3, 9, 11]
    both = pipe.generate_batch(conds, clip_ids=np.concatenate([c for c, _ in ids]),
                               t5_ids=np.concatenate([t for _, t in ids]), seeds=seeds,
                               output_type="latent")
    for i in range(3):
        one = pipe(conds[i], clip_ids=ids[i][0], t5_ids=ids[i][1], seed=seeds[i],
                   output_type="latent")
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(), **BATCH_TOL)
    assert not torch.allclose(both[0], both[2])   # same conditions, other prompt and seed


def test_inpaint_generate_batch_rows_equal_single_calls(server, inpaint_pipe):
    worker = server.worker
    img, mask = _inpaint_inputs()
    images, masks = [img, img[::-1].copy()], [mask, mask.T.copy()]
    conds = [_conditions(worker, lines) for lines in (LINES1, LINES2)]
    ids = [worker._tokenize(p) for p in ("sign A", "sign B")]
    neg = worker._tokenize("bad quality")
    seeds = [3, 9]
    both = inpaint_pipe.generate_batch(
        conds, images, masks, clip_ids=np.concatenate([c for c, _ in ids]),
        t5_ids=np.concatenate([t for _, t in ids]),
        negative_clip_ids=np.concatenate([neg[0]] * 2),
        negative_t5_ids=np.concatenate([neg[1]] * 2), seeds=seeds, output_type="latent")
    for i in range(2):
        one = inpaint_pipe(conds[i], image=images[i], mask=masks[i], clip_ids=ids[i][0],
                           t5_ids=ids[i][1], negative_clip_ids=neg[0], negative_t5_ids=neg[1],
                           seed=seeds[i], output_type="latent")
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(), **BATCH_TOL)


def test_served_batch_equals_served_alone(server):
    """The same requests through the worker coalesced and one at a time."""
    results = {}
    for cap in (4, 1):
        worker = GenerationWorker(server.worker.pipeline, max_batch=cap, metrics=Metrics())
        reqs = [GenerationRequest(prompt=f"sign {i}", lines=LINES1, seed=20 + i)
                for i in range(2)]
        for r in reqs:
            worker.submit(r)
        while not all(r._done.is_set() for r in reqs):
            worker._process_once()
        assert worker.batches == (1 if cap == 4 else 2) and worker.failed == 0
        results[cap] = [r._result for r in reqs]
    for a, b in zip(results[4], results[1]):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_pre_encoded_requests_coalesce(server):
    """Requests with prompt_embeds/pooled_embeds batch with each other (not
    with prompt strings) and equal the same embeds served alone."""
    pipe = server.worker.pipeline
    seq, pooled = pipe.encode_prompt(*server.worker._tokenize("a sign"))
    kw = dict(prompt_embeds=seq[0].numpy(), pooled_embeds=pooled[0].numpy())
    worker = GenerationWorker(pipe, max_batch=4, metrics=Metrics())
    reqs = [GenerationRequest(prompt="", lines=LINES1, seed=s, **kw) for s in (1, 2)]
    plain = GenerationRequest(prompt="a sign", lines=LINES1, seed=1)
    for r in reqs + [plain]:
        worker.submit(r)
    assert worker._process_once() == 2 and worker._process_once() == 1
    assert all(r._error is None for r in reqs + [plain])
    alone = GenerationRequest(prompt="", lines=LINES1, seed=1, **kw)
    worker.submit(alone)
    assert worker._process_once() == 1
    assert np.abs(alone._result.astype(int) - reqs[0]._result.astype(int)).max() <= 1
    assert np.abs(plain._result.astype(int) - reqs[0]._result.astype(int)).max() <= 1


def test_concurrent_clients(server):
    """Twelve client threads post at once, with a short switch interval: every
    request is answered, and the counters add up to the requests."""
    m = Metrics()
    worker, old_metrics = server.worker, server.worker.metrics
    worker.metrics = m
    statuses = []
    lock = threading.Lock()

    def client(i):
        status, data = _request(server, "POST", "/generate", {
            "prompt": f"sign {i}", "lines": LINES1 if i % 2 else LINES2, "seed": i,
            "num_steps": 1})
        with lock:
            statuses.append((status, data.get("shape")))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        worker.metrics = old_metrics
    assert statuses == [(200, [H, W, 3])] * 12
    snap = m.snapshot()
    assert snap["counters"]["serving.requests_completed"] == 12
    sizes = snap["timings"]["serving.batch_size"]
    assert sizes["mean_s"] * sizes["count"] == 12 and sizes["max_s"] <= 4


def test_cli_serve_on_the_cpu():
    """--mode serve --tiny --device cpu: the CLI's server answers /generate
    and /healthz, with the inpaint pipeline beside it."""
    from reptext_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["--mode", "serve", "--tiny", "--device", "cpu", "--random-weights", "--size", "64",
         "--steps", "1", "--controlnet-step", "1", "--port", "0", "--max-batch", "2",
         "--serve-inpaint"])
    srv = cli.build_server(args)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        assert srv.worker.inpaint_pipeline.inpaint_controlnet is not None
        assert srv.worker.inpaint_pipeline.flux is srv.worker.pipeline.flux
        status, data = _request(srv, "POST", "/generate", {"prompt": "a sign", "lines": LINES1})
        assert status == 200 and data["shape"] == [64, 64, 3], data
        img, mask = _inpaint_inputs()
        status, data = _request(srv, "POST", "/generate", {
            "prompt": "a sign", "lines": LINES1, "mode": "inpaint",
            "image_png_base64": _png_b64(img), "mask_png_base64": _png_b64(mask)})
        assert status == 200 and data["shape"] == [64, 64, 3], data
        status, data = _request(srv, "GET", "/healthz")
        assert status == 200 and data["completed"] == 2
    finally:
        srv.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


# ------------------------------------------- per-image conditions in the samplers

B, S, C, S_TXT, INNER, F, N_LINES = 3, 16, 8, 4, 8, 12, 2


def _stub_flux(x, ctx, pooled, t, img_ids, txt_ids, guidance,
               controlnet_block_samples=None, controlnet_single_block_samples=None, xp=torch):
    out = -0.3 * x + 0.1 * xp.sin(t)[:, None, None] + 0.05 * ctx.mean(axis=(1, 2))[:, None, None]
    for stacks in (controlnet_block_samples, controlnet_single_block_samples):
        stacks = () if stacks is None else stacks if isinstance(stacks, tuple) else (stacks,)
        for stack in stacks:
            out = out + 0.01 * stack.sum(axis=0)[..., :C]
    return out


def _stub_cn(layers, hidden, cond, ctx, pooled, t, img_ids, txt_ids, guidance, scale,
             xp=torch):
    """Residuals that depend on each row's own condition tokens and latents."""
    r = (cond[..., :INNER] + 0.5 * hidden[..., :INNER]) * scale
    return (xp.stack([r * (k + 1) for k in range(layers[0])]),
            xp.stack([-r * (k + 1) for k in range(layers[1])]))


def _sampler_args():
    r = np.random.default_rng(1)
    return dict(
        latents=r.standard_normal((B, S, C)).astype(np.float32),
        cond_tokens=r.standard_normal((N_LINES, B, S, F)).astype(np.float32),
        token_masks=(r.random((N_LINES, B, S, 1)) > 0.5).astype(np.float32),
        inpaint_cond=r.standard_normal((B, S, F)).astype(np.float32),
        ctx=r.standard_normal((2 * B, S_TXT, 6)).astype(np.float32),   # [neg; pos]
        pooled=r.standard_normal((2 * B, 5)).astype(np.float32),
        txt_ids=np.zeros((S_TXT, 3), np.float32), img_ids=np.zeros((S, 3), np.float32))


def _port_sample(kind, cfg, a):
    from reptext_tpu_torch.sampling.flow_match import build_schedule
    from reptext_tpu_torch.sampling.sampler import make_txt2img_sampler
    from reptext_tpu_torch.sampling.sampler_inpaint import make_inpaint_sampler

    t = {k: torch.from_numpy(v) for k, v in a.items()}
    schedule = build_schedule(cfg.num_inference_steps, cfg.image_seq_len)
    rt = lambda *x: _stub_cn((2, 3), *x)           # noqa: E731
    b = t["latents"].shape[0]
    if kind == "txt2img":
        sample = make_txt2img_sampler(_stub_flux, rt, schedule, cfg)
        return sample(t["latents"], t["cond_tokens"], t["token_masks"], t["ctx"][b:],
                      t["pooled"][b:], t["txt_ids"], t["img_ids"], None).numpy()
    inp = lambda *x: _stub_cn((1, 2), *x)          # noqa: E731
    sample = make_inpaint_sampler(_stub_flux, rt, inp, schedule, cfg)
    return sample(t["latents"], t["cond_tokens"], t["token_masks"], t["inpaint_cond"],
                  t["ctx"], t["pooled"], t["txt_ids"], t["img_ids"], None).numpy()


@pytest.mark.parametrize("kind", ["txt2img", "inpaint"])
def test_per_image_conditions_match_the_jax_sampler(kind):
    from reptext_tpu.sampling.flow_match import build_schedule as j_build_schedule
    from reptext_tpu.sampling.sampler import make_txt2img_sampler as j_txt2img
    from reptext_tpu.sampling.sampler_inpaint import make_inpaint_sampler as j_inpaint

    jcfg = PipelineConfig(height=32, width=32, num_inference_steps=4,
                          controlnet_conditioning_step=3, true_guidance_scale=2.5)
    cfg = port_config(jcfg)
    a = _sampler_args()
    got = _port_sample(kind, cfg, a)
    jsched = j_build_schedule(4, jcfg.image_seq_len)
    j = {k: jnp.asarray(v) for k, v in a.items()}

    def jflux(p, x, ctx, pooled, t, iid, tid, g, br, sr):
        return _stub_flux(x, ctx, pooled, t, iid, tid, g, br, sr, xp=jnp)

    def jcn(layers):
        return lambda p, *x: _stub_cn(layers, *x, xp=jnp)

    if kind == "txt2img":
        want = jax.jit(j_txt2img(jflux, jcn((2, 3)), jsched, jcfg))(
            None, None, j["latents"], j["cond_tokens"], j["token_masks"], j["ctx"][B:],
            j["pooled"][B:], j["txt_ids"], j["img_ids"], None)
    else:
        want = jax.jit(j_inpaint(jflux, jcn((2, 3)), jcn((1, 2)), jsched, jcfg, 4, 4))(
            None, None, None, j["latents"], j["cond_tokens"], j["token_masks"],
            j["inpaint_cond"], j["ctx"], j["pooled"], j["txt_ids"], j["img_ids"], None)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    # row i of the per-image batch is image i run alone on its shared conditions
    for i in range(B):
        one = dict(a, latents=a["latents"][i:i + 1], cond_tokens=a["cond_tokens"][:, i],
                   token_masks=a["token_masks"][:, i], inpaint_cond=a["inpaint_cond"][i:i + 1],
                   ctx=a["ctx"][[i, B + i]], pooled=a["pooled"][[i, B + i]])
        np.testing.assert_allclose(got[i:i + 1], _port_sample(kind, cfg, one),
                                   rtol=1e-5, atol=1e-5)


def test_with_resolution_checks_and_shares(server):
    pipe = server.worker.pipeline
    with pytest.raises(ValueError, match="x16"):
        pipe.with_resolution(64, 50)
    assert pipe.with_resolution(H, W) is pipe
    view = pipe.with_resolution(96, 128)
    assert (view.pipe_cfg.height, view.pipe_cfg.width) == (96, 128)
    assert view.flux is pipe.flux and dataclasses.replace(view.pipe_cfg, height=H,
                                                          width=W) == pipe.pipe_cfg


def test_serve_defaults_to_the_card():
    """--mode serve without --device cpu builds on CUDA and raises on a host
    without a card, before it binds a port."""
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device the server builds on it")
    from reptext_tpu_torch import cli

    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--mode", "serve", "--tiny", "--random-weights", "--port", "0"])
