"""End-to-end trained-weights fidelity demo on the port: train the VAE, FLUX and
the ControlNet from scratch on synthetic glyph data, sample through the
production pipeline and score the text with the OCR judge.

Counterpart of ``examples/overfit_e2e.py``, with its protocol, its flags and
its JSON keys:

  1. train a small AutoencoderKL on the demo images (recon MSE + 1e-6 KL);
  2. train a small FLUX (2 + 4 blocks, 4 heads x 64) and the RepText
     ControlNet (1 + 2) jointly (``sampling.train_controlnet.
     make_joint_train_step``: the region-weighted rectified-flow loss) to
     overfit K fixed (text render, conditioning) pairs at 128^2;
  3. sample each pair through ``FluxRepTextPipeline.__call__`` at a fixed
     seed;
  4. score the text-region crops with the committed OCR judge
     (``benchmarks/ocr_judge.npz``), trained against random weights, and with
     the edge metrics of ``eval/glyph_fidelity.py``.

Both optimizers are Adam with optax's ``cosine_decay_schedule`` (alpha 0.1
for the VAE, 0.05 for the flow), evaluated at the update's count from 0. The
whole run is fp32 (``create(..., dtype=torch.float32)``, as the JAX demo's
pipeline defaults to float32): the attention kernels take fp32 tensors and
run their products on bf16 operands (``ops/flash_attention.py``); matrix
products elsewhere run in full fp32 (``torch.backends.cuda.matmul.allow_tf32``
False, PyTorch's default, which the JSON records) and the convolutions in
TF32 (PyTorch's default for its convolution library, which
``chip_smoke.py``'s demo phase prints). The T5 ids are the prompt's 4 words and EOS, unpadded (5 tokens, as the
JAX CLI's fallback makes them), and CLIP's 16: the joint sequence is 64 image
+ 5 text tokens.

The conditions are rendered with the port's ``conditioning/`` where Pillow
and a font exist, and otherwise read from ``tests/fixtures/
overfit_conditions_128.npz`` (``tests/record_conditions_fixture.py``), which
holds every set this script draws (the 16 train words at seed 7, the 8
holdout words at seed 23, the corpus-scaling pool of ``synth_corpus(96)``).

Run on the card (the JAX defaults: 2500 VAE steps, 6000 flow steps, 20 sample
steps):
    python -m reptext_tpu_torch.examples.overfit_e2e --holdout --params-cache DIR
A wiring check on the CPU:
    python -m reptext_tpu_torch.examples.overfit_e2e --device cpu \\
        --steps-vae 2 --steps-flux 2 --steps-sample 2 --output results/overfit.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reptext_tpu_torch.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)

SIZE = 128

# The overfit set: Arabic, Latin and digits, all inside the OCR judge's
# charset, short enough for a 128 px canvas at a legible font size.
WORDS = ["مرحبا", "نور", "CAFE", "STOP", "سوق", "2026", "بحر", "HI"]
# --holdout: train on a larger pool, also score words the model never saw.
TRAIN_WORDS = WORDS + ["ليل", "GOLD", "شمس", "1987", "MARK", "درب", "فن", "WAVE"]
HOLDOUT_WORDS = ["سلام", "TAXI", "قمر", "404", "نهر", "OK", "باب", "Fox"]
PROMPT = "a sign with text"
TRAIN_SEED, HOLDOUT_SEED = 7, 23
CORPUS_HOLDOUT = 32
CORPUS_MAX = 64        # the largest --corpus-scale point the fixture holds

_PKG = Path(__file__).resolve().parent.parent
DEFAULT_OUTPUT = str(_PKG / "benchmarks" / "overfit_e2e.json")
FIXTURE = str(_PKG.parent / "tests" / "fixtures" / "overfit_conditions_128.npz")
# the fixture's arrays of one sample
LINE_ARRAYS = ("glyph_image", "canny_image", "position_mask", "region_mask")


def synth_corpus(n: int, seed: int = 5) -> List[str]:
    """n unique synthetic words (Arabic, upper, lower or digits, 2-5
    characters) for the corpus-scaling protocol, drawn as the JAX function
    draws them; one pool is sliced, so holdout and training words are
    disjoint."""
    from reptext_tpu_torch.eval.ocr import ARABIC, DIGITS, LATIN, LATIN_LOWER

    rng = np.random.default_rng(seed)
    pools = [ARABIC, LATIN, LATIN_LOWER, DIGITS]
    words: List[str] = []
    seen = set()
    while len(words) < n:
        pool = pools[int(rng.integers(len(pools)))]
        w = "".join(rng.choice(list(pool)) for _ in range(int(rng.integers(2, 6))))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def demo_flux_cfg() -> FluxConfig:
    """Small but non-trivial geometry: 2 + 4 blocks, 4 heads x 64 = 256 inner."""
    return dataclasses.replace(FluxConfig().tiny(), attention_head_dim=64,
                               axes_dims_rope=(8, 28, 28))


def demo_cn_cfg() -> ControlNetConfig:
    return dataclasses.replace(ControlNetConfig().tiny(), attention_head_dim=64,
                               axes_dims_rope=(8, 28, 28))


def demo_vae_cfg() -> VAEConfig:
    """More capacity than the tests' tiny VAE: its reconstruction bounds OCR."""
    return dataclasses.replace(VAEConfig().tiny(), block_out_channels=(32, 64, 64, 64),
                               norm_num_groups=8)


# ---------------------------------------------------------------- the data


def _placements(words: Sequence[str], size: int, seed: int):
    """(font_size, (x, y), colour, background) of each word, drawn as
    ``build_overfit_set`` draws them."""
    rnd = np.random.default_rng(seed)
    out = []
    for text in words:
        font_size = max(12, int(size * (0.28 if len(text) <= 4 else 0.23)))
        x_hi = max(5, size - int(0.62 * font_size * len(text)))
        y_hi = max(9, size - int(1.6 * font_size))
        x = int(rnd.integers(4, x_hi))
        y = int(rnd.integers(8, y_hi))
        color = tuple(int(v) for v in rnd.integers(170, 256, 3))
        bg = tuple(int(v) for v in rnd.integers(0, 90, 3))
        out.append((font_size, (x, y), color, bg))
    return out


def _sample(text: str, conds, bg) -> Dict:
    canvas = conds.glyph_canvas
    target = np.empty_like(canvas)
    target[:] = np.asarray(bg, np.uint8)
    ink = (canvas > 0).any(axis=-1)
    target[ink] = canvas[ink]
    return {"text": text, "conds": conds, "target": target}


def render_overfit_set(size: int, words: Sequence[str], seed: int,
                       font_path: Optional[str] = None) -> List[Dict]:
    """The samples rendered by the conditioning frontend (Pillow and a font)."""
    from reptext_tpu_torch.conditioning import TextLine, build_conditions

    samples = []
    for text, (font_size, pos, color, bg) in zip(words, _placements(words, size, seed)):
        conds = build_conditions([TextLine(text, pos, color, font_size=font_size)],
                                 size, size, font_path=font_path, font_size=font_size)
        samples.append(_sample(text, conds, bg))
    return samples


def fixture_overfit_set(size: int, words: Sequence[str], seed: int,
                        path: str = FIXTURE) -> List[Dict]:
    """The samples from the recorded fixture: the set recorded at ``seed``
    whose words begin with ``words`` (a set's first k samples are drawn as a
    set of k words draws them)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    for name in sorted({k.split(".")[0] for k in data if "." in k}):
        got = [str(w) for w in data[f"{name}.words"]]
        if (int(data[f"{name}.seed"]) == seed and int(data[f"{name}.size"]) == size
                and got[:len(words)] == list(words)):
            break
    else:
        raise FileNotFoundError(f"{path} holds no set of {len(words)} words at seed {seed}, "
                                f"{size}^2 beginning {list(words)[:3]}")
    samples = []
    for i, text in enumerate(words):
        key = f"{name}.{i}"
        line = types.SimpleNamespace(**{a: data[f"{key}.{a}"] for a in LINE_ARRAYS},
                                     bbox=tuple(int(v) for v in data[f"{key}.bbox"]))
        conds = types.SimpleNamespace(lines=[line], glyph_canvas=data[f"{key}.glyph_canvas"],
                                      width=size, height=size, num_lines=1)
        samples.append(_sample(text, conds, tuple(int(v) for v in data[f"{key}.bg"])))
    return samples


def conditions_source() -> str:
    """'render' where Pillow and a font exist, else 'fixture' (with why)."""
    try:
        from reptext_tpu_torch.conditioning import default_font_path

        default_font_path()
    except (ImportError, FileNotFoundError) as e:
        return f"fixture ({type(e).__name__}: {e})"
    return "render"


def build_overfit_set(size: int = SIZE, font_path: Optional[str] = None,
                      words: Optional[List[str]] = None, seed: int = TRAIN_SEED) -> List[Dict]:
    """K fixed (text, conditions, target image) samples, deterministic:
    rendered where a font exists, else read from the fixture."""
    words = list(WORDS if words is None else words)
    if font_path is not None or conditions_source() == "render":
        return render_overfit_set(size, words, seed, font_path)
    return fixture_overfit_set(size, words, seed)


# ----------------------------------------------------------------- VAE stage


def vae_pool(samples: List[Dict]) -> np.ndarray:
    """Every image the pipeline VAE-encodes: targets, canny conditions,
    position masks, glyph canvases; uint8 [N, H, W, 3]."""
    pool = []
    for s in samples:
        lc = s["conds"].lines[0]
        pool.extend([s["target"], lc.canny_image,
                     np.repeat(lc.position_mask[:, :, None], 3, axis=2),
                     s["conds"].glyph_canvas])
    return np.stack(pool)


def vae_loss(vae, imgs: torch.Tensor, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mse + 1e-6 kl, mse) of one posterior sample z = mean + exp(logvar /
    2) noise; images NCHW in [-1, 1]."""
    mean, logvar = vae.encode_moments(imgs)
    z = mean + torch.exp(0.5 * logvar) * noise
    rec = vae.decode(z)
    mse = torch.mean((rec - imgs) ** 2)
    kl = -0.5 * torch.mean(1 + logvar - mean ** 2 - torch.exp(logvar))
    return mse + 1e-6 * kl, mse


def adam_cosine(params, lr: float, steps: int, alpha: float):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with optax's
    ``cosine_decay_schedule(lr, max(steps, 1), alpha)``, evaluated at the
    update's count from 0: (optimizer, scheduler), the scheduler stepped after
    each update."""
    from reptext_tpu_torch.eval.ocr import cosine_decay

    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    decay = max(steps, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: cosine_decay(s, decay, alpha))
    return opt, sched


def train_vae(vae, samples: List[Dict], steps: int, lr: float = 2e-3, batch: int = 8,
              seed: int = 0) -> Tuple[float, List[float]]:
    """Train the AutoencoderKL in place on :func:`vae_pool` (batches of
    ``batch`` drawn with replacement, one posterior sample each). Returns the
    reconstruction PSNR over the whole pool (posterior mean; [-1, 1] range,
    peak 2) and the recon MSE at every step."""
    from reptext_tpu_torch.utils.image import preprocess_images

    device = next(vae.parameters()).device
    data = torch.from_numpy(preprocess_images(vae_pool(samples))).permute(0, 3, 1, 2)
    data = data.contiguous().to(device)
    n = data.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    vae.requires_grad_(True)
    opt, sched = adam_cosine(vae.parameters(), lr, steps, 0.1)
    mses = []
    for i in range(steps):
        idx = torch.randint(0, n, (min(batch, n),), generator=gen, device=device)
        imgs = data[idx]
        mean_shape = (imgs.shape[0], vae.config.latent_channels,
                      imgs.shape[2] // vae.config.scale_factor,
                      imgs.shape[3] // vae.config.scale_factor)
        noise = torch.randn(mean_shape, generator=gen, device=device)
        opt.zero_grad(set_to_none=True)
        loss, mse = vae_loss(vae, imgs, noise)
        loss.backward()
        opt.step()
        sched.step()
        mses.append(mse.detach())
        if i % 200 == 0 or i == steps - 1:
            print(f"vae step {i}: recon_mse={float(mses[-1]):.5f}", flush=True)
    vae.requires_grad_(False)
    with torch.no_grad():
        sq = 0.0
        for c in range(0, n, 16):
            chunk = data[c:c + 16]
            rec = vae.decode(vae.encode_moments(chunk)[0])
            sq += float(((rec - chunk) ** 2).sum())
    full_mse = sq / data.numel()
    psnr = 10.0 * math.log10(4.0 / max(full_mse, 1e-12))
    return psnr, [float(m) for m in torch.stack(mses).tolist()] if mses else []


# ---------------------------------------------------------------- flow stage


def prompt_ids(pipe) -> Tuple[np.ndarray, np.ndarray]:
    """The demo prompt's ids: CLIP's 16, and T5's 4 words + EOS unpadded (the
    JAX CLI's fallback length; the port's CRC32 values)."""
    from reptext_tpu_torch.cli import _tokenize

    return _tokenize(PROMPT, pipe.clip.config, pipe.t5.config, None,
                     t5_length=len(PROMPT.split()[:16]) + 1)


def precompute_batch(pipe, samples: List[Dict], seed: int = 11) -> Dict:
    """One fixed full-batch training dict through the production condition
    path: packed target latents (one posterior sample each), condition
    tokens, token masks, the OCR fields, the prompt's embeddings; every
    tensor a plain (not inference-mode) tensor on the pipeline's device."""
    from reptext_tpu_torch.eval.ocr import CHAR_TO_ID, MAX_LABEL
    from reptext_tpu_torch.ops.latents import pack_latents, prepare_latent_image_ids
    from reptext_tpu_torch.sampling.ocr_loss import aspect_box, glyph_ink_bbox

    cfg, dev = pipe.pipe_cfg, pipe.device
    cond_l, mask_l, x0_l = [], [], []
    for i, s in enumerate(samples):
        g_cond, g_img = (torch.Generator(device=dev).manual_seed(int(v)) for v in
                         np.random.SeedSequence([seed, i]).generate_state(2))
        ct, tm = pipe.prepare_control_tokens(s["conds"], g_cond)
        cond_l.append(ct[0].clone())
        mask_l.append(tm[0].clone())
        with torch.inference_mode():
            lat = pipe._encode_scaled(pipe._images(s["target"]), g_img)
        x0_l.append(pack_latents(lat)[0].clone())
    clip_ids, t5_ids = prompt_ids(pipe)
    prompt_embeds, pooled = pipe.encode_prompt(clip_ids, t5_ids)
    b = len(samples)
    guidance = (torch.full((b,), cfg.guidance_scale, dtype=torch.float32, device=dev)
                if pipe.flux.config.guidance_embeds else None)
    ocr_boxes = np.zeros((b, 4), np.float32)
    ocr_labels = np.zeros((b, MAX_LABEL), np.int64)
    ocr_paddings = np.ones((b, MAX_LABEL), np.float32)
    for i, s in enumerate(samples):
        bbox = glyph_ink_bbox(s["conds"].glyph_canvas)
        ocr_boxes[i] = (aspect_box(bbox, cfg.height, cfg.width) if bbox
                        else np.asarray([0, 0, 1, 1], np.float32))
        ids = [CHAR_TO_ID[c] for c in s["text"] if c in CHAR_TO_ID][:MAX_LABEL]
        ocr_labels[i, :len(ids)] = ids
        ocr_paddings[i, :len(ids)] = 0.0
    return {
        "x0": torch.stack(x0_l),
        "cond_tokens": torch.stack(cond_l),
        "token_mask": torch.stack(mask_l),
        "ocr_boxes": torch.from_numpy(ocr_boxes).to(dev),
        "ocr_labels": torch.from_numpy(ocr_labels).to(dev),
        "ocr_paddings": torch.from_numpy(ocr_paddings).to(dev),
        "prompt_embeds": prompt_embeds.clone().expand(b, *prompt_embeds.shape[1:]).clone(),
        "pooled": pooled.clone().expand(b, *pooled.shape[1:]).clone(),
        "img_ids": prepare_latent_image_ids(cfg.latent_height, cfg.latent_width, dev),
        "txt_ids": torch.zeros((prompt_embeds.shape[1], 3), device=dev),
        "guidance": guidance,
        "clip_ids": clip_ids, "t5_ids": t5_ids,
    }


def train_flow(pipe, batch: Dict, steps: int, lr: float = 2e-3, seed: int = 1,
               ocr_loss_weight: float = 0.0, judge=None) -> List[float]:
    """Train FLUX and the ControlNet jointly, in place, to overfit the fixed
    batch (``make_joint_train_step``, text-region weight 2). With
    ``ocr_loss_weight`` > 0 the OCR CTC term runs through the frozen,
    already-trained VAE decoder and ``judge``. Returns the loss of every
    step."""
    from reptext_tpu_torch.sampling.train_controlnet import make_joint_train_step

    flux, cn = pipe.flux, pipe.controlnet
    flux.requires_grad_(True)
    cn.requires_grad_(True)
    opt, sched = adam_cosine(list(flux.parameters()) + list(cn.parameters()), lr, steps, 0.05)
    perceptual, frozen = None, ()
    if ocr_loss_weight > 0.0:
        perceptual = {"decode": pipe.decode_images, "judge": judge, "weight": ocr_loss_weight}
        frozen = (pipe.vae, judge)
    step = make_joint_train_step(flux, cn, opt, text_loss_weight=2.0, perceptual=perceptual)
    tbatch = {k: v for k, v in batch.items() if k not in ("clip_ids", "t5_ids")}
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    losses = []
    for i in range(steps):
        losses.append(step(tbatch, gen, *frozen))
        sched.step()
        if i % 500 == 0 or i == steps - 1:
            print(f"flow step {i}: loss={float(losses[-1]):.5f}", flush=True)
    flux.requires_grad_(False).zero_grad(set_to_none=True)
    cn.requires_grad_(False).zero_grad(set_to_none=True)
    return torch.stack(losses).tolist() if losses else []


# ----------------------------------------------------------------- eval stage


def launch_counts() -> Dict[str, int]:
    """Launches of the attention kernels so far: K1, K2, K3 (forward), K4."""
    from reptext_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.flash_attention_rope.launches, "K2": fa.flash_attention.launches,
            "K3": fa.flash_attention_streaming.launches,
            "K4": fa.flash_attention_backward.launches}


def forward_launches() -> int:
    counts = launch_counts()
    return counts["K1"] + counts["K2"] + counts["K3"]


def sample_and_score(pipe, samples: List[Dict], batch: Dict, steps_sample: int,
                     judge) -> Dict:
    """Sample every pair at a fixed seed (1000 + i); OCR char accuracy and
    edge metrics of the text-region crops. Also the sampler's ms per step
    (``timings``: the device synchronised at stage boundaries) and the
    forward attention launches of the whole call."""
    from reptext_tpu_torch.eval import ocr as ocr_judge
    from reptext_tpu_torch.eval.glyph_fidelity import score_region

    images, crops, texts, ious = [], [], [], []
    sample_s, launches0 = 0.0, forward_launches()
    for i, s in enumerate(samples):
        timings: Dict[str, float] = {}
        img = pipe(s["conds"], prompt_embeds=batch["prompt_embeds"][:1],
                   pooled_embeds=batch["pooled"][:1], seed=1000 + i,
                   num_inference_steps=steps_sample, timings=timings)[0]
        sample_s += timings["sample"]
        images.append(np.asarray(img))
        lc = s["conds"].lines[0]
        x0, y0, x1, y1 = lc.bbox
        crops.append(images[-1][y0:y1, x0:x1])
        texts.append(s["text"])
        ious.append(score_region(crops[-1], lc)["edge_iou"])
    acc = (ocr_judge.char_accuracy(crops, texts, judge) if judge is not None
           else float("nan"))
    return {"char_accuracy": acc, "mean_edge_iou": float(np.mean(ious)), "images": images,
            "sample_ms_per_step": 1e3 * sample_s / max(len(samples) * steps_sample, 1),
            "attention_launches": forward_launches() - launches0}


# ------------------------------------------------------------ the protocol


def device_info(device: torch.device) -> Tuple[str, Optional[str]]:
    """(device name, power limit from nvidia-smi) of ``device``."""
    if device.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        limit = smi[device.index or 0].split(",")[-1].strip()
    except (OSError, subprocess.CalledProcessError, IndexError):
        limit = None
    return name, limit


def precision_settings() -> Dict[str, object]:
    """The fp32 matrix products' precision this run takes."""
    return {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def build_pipeline(size: int, steps_sample: int, device):
    """The demo pipeline, fp32, seeded random weights (seed 0), the ControlNet
    on every sampling step."""
    from reptext_tpu_torch.pipelines import FluxRepTextPipeline

    pipe_cfg = PipelineConfig(height=size, width=size, num_inference_steps=steps_sample,
                              controlnet_conditioning_step=steps_sample)
    return FluxRepTextPipeline.create(
        demo_flux_cfg(), demo_cn_cfg(), demo_vae_cfg(), pipe_cfg, clip_cfg=CLIPConfig().tiny(),
        t5_cfg=T5Config().tiny(), seed=0, device=device, dtype=torch.float32)


def load_judge(device):
    from reptext_tpu_torch.eval import ocr as ocr_judge

    try:
        return ocr_judge.load_judge_ensemble(device=device)
    except FileNotFoundError:
        print("      (no OCR judge weights; char accuracy skipped)")
        return None


def snapshot(*modules) -> List[Dict[str, torch.Tensor]]:
    return [{k: v.clone() for k, v in m.state_dict().items()} for m in modules]


def _write(path: str, out: Dict) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out, indent=1))


def run_corpus_scaling(args) -> int:
    """Generalization against corpus size: train on K synthetic words for each
    K in --corpus-scale, score a fixed 32-word holdout each time. One pool of
    unique words is sliced (holdout first); the VAE is trained once on the
    largest corpus and shared; FLUX and the ControlNet restart from the same
    random weights for every K."""
    from reptext_tpu_torch.io.checkpoint import save_pipeline_params

    t_start = time.time()
    device = torch.device(args.device)
    ks = sorted({int(k) for k in args.corpus_scale.split(",")})
    pool = synth_corpus(max(ks) + CORPUS_HOLDOUT)
    holdout_words, train_pool = pool[:CORPUS_HOLDOUT], pool[CORPUS_HOLDOUT:]
    holdout_samples = build_overfit_set(args.size, words=holdout_words, seed=HOLDOUT_SEED)
    samples_max = build_overfit_set(args.size, words=train_pool[:max(ks)])
    pipe = build_pipeline(args.size, args.steps_sample, device)
    print(f"[1/3] training shared VAE on K={max(ks)} corpus ({args.steps_vae} steps)...",
          flush=True)
    psnr, _ = train_vae(pipe.vae, samples_max, args.steps_vae)
    print(f"      recon PSNR {psnr:.1f} dB", flush=True)
    random_state = snapshot(pipe.flux, pipe.controlnet)
    judge = load_judge(device)
    hold_batch = precompute_batch(pipe, holdout_samples)
    res_rand = sample_and_score(pipe, holdout_samples, hold_batch, args.steps_sample, judge)
    curve = []
    for k in ks:
        samples = samples_max[:k]
        print(f"[2/3] K={k}: joint FLUX+CN training ({args.steps_flux} steps, full batch {k})...",
              flush=True)
        pipe.flux.load_state_dict(random_state[0])
        pipe.controlnet.load_state_dict(random_state[1])
        batch = precompute_batch(pipe, samples)
        train_flow(pipe, batch, args.steps_flux, seed=args.train_seed)
        res_tr = sample_and_score(pipe, samples[:16], batch, args.steps_sample, judge)
        res_ho = sample_and_score(pipe, holdout_samples, batch, args.steps_sample, judge)
        row = {"corpus_size": k,
               "char_accuracy_train_subset16": round(res_tr["char_accuracy"], 4),
               "char_accuracy_holdout32": round(res_ho["char_accuracy"], 4),
               "mean_edge_iou_holdout": round(res_ho["mean_edge_iou"], 4)}
        curve.append(row)
        print(f"      {row}", flush=True)
        # written after every K: a late failure keeps the measured rows
        _write(args.output, {"protocol": "corpus scaling (PARTIAL — run in progress)",
                             "corpus_scaling": curve})
        if args.params_cache:
            save_pipeline_params({"vae": pipe.vae, "flux": pipe.flux,
                                  "controlnet": pipe.controlnet}, f"{args.params_cache}_k{k}")
    last = curve[-1]
    name, limit = device_info(device)
    out = {
        "protocol": ("corpus scaling: train K in %s synthetic words, eval a FIXED disjoint "
                     "32-word holdout, %d^2, %d sample steps, %d flux steps/K, shared VAE"
                     % (ks, args.size, args.steps_sample, args.steps_flux)),
        "vae_recon_psnr_db": round(psnr, 2),
        "train_steps_vae": args.steps_vae,
        "train_steps_flux": args.steps_flux,
        "train_seed": args.train_seed,
        "corpus_scaling": curve,
        "char_accuracy_trained": last["char_accuracy_train_subset16"],
        "char_accuracy_holdout": last["char_accuracy_holdout32"],
        "char_accuracy_random": round(res_rand["char_accuracy"], 4),
        "mean_edge_iou_holdout": last["mean_edge_iou_holdout"],
        "mean_edge_iou_random": round(res_rand["mean_edge_iou"], 4),
        "holdout_words": holdout_words,
        "wall_s": round(time.time() - t_start, 1),
        "device": name,
        "power_limit": limit,
        "precision": precision_settings(),
    }
    _write(args.output, out)
    print(json.dumps(out, indent=1))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps-vae", type=int, default=2500)
    ap.add_argument("--steps-flux", type=int, default=6000)
    ap.add_argument("--steps-sample", type=int, default=20)
    ap.add_argument("--train-seed", type=int, default=1,
                    help="flow-training generator seed (A/B replication)")
    ap.add_argument("--ocr-loss-weight", type=float, default=0.0,
                    help="the OCR CTC term during joint training (A/B: compare char "
                         "accuracy at equal, sub-saturation step counts)")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--output", default=DEFAULT_OUTPUT)
    ap.add_argument("--params-cache", default=None,
                    help="directory: save the trained modules there (or reuse them if "
                         "present) so that re-scoring skips training")
    ap.add_argument("--holdout", action="store_true",
                    help="train on TRAIN_WORDS (16), also score HOLDOUT_WORDS (8), which "
                         "the model never saw")
    ap.add_argument("--corpus-scale", default=None, metavar="K1,K2,...",
                    help="corpus-scaling protocol: train on K synthetic words per point, "
                         f"score a fixed 32-word holdout (K <= {CORPUS_MAX} off the fixture)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the models run (cuda unless the CPU is asked for)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.corpus_scale:
        return run_corpus_scaling(args)
    run(args)
    return 0


def run(args) -> Tuple[Dict, object]:
    """The demo's protocol (train or reuse, then sample and score); writes the
    JSON (and the sample grid where Pillow is there) and returns it with the
    pipeline, which holds the random FLUX and ControlNet again at the end."""
    from reptext_tpu_torch.io.checkpoint import load_pipeline_params, save_pipeline_params
    from reptext_tpu_torch.utils.profiling import SpanRecorder

    t_start = time.time()
    device = torch.device(args.device)
    stages: Dict[str, float] = {}   # wall seconds per stage, the device synchronised
    clock = SpanRecorder(stages, device)
    with clock.stage("setup"):
        train_words = TRAIN_WORDS if args.holdout else WORDS
        print(f"conditions: {conditions_source()}", flush=True)
        samples = build_overfit_set(args.size, words=train_words)
        holdout_samples = (build_overfit_set(args.size, words=HOLDOUT_WORDS, seed=HOLDOUT_SEED)
                           if args.holdout else None)
        pipe = build_pipeline(args.size, args.steps_sample, device)

    cached = bool(args.params_cache) and os.path.isfile(
        os.path.join(args.params_cache, "flux.safetensors"))
    flow_losses: List[float] = []
    if cached:
        with clock.stage("load"):
            print(f"[1-3/4] reusing trained params from {args.params_cache}", flush=True)
            saved = load_pipeline_params(args.params_cache, ("vae", "flux", "controlnet"))
            pipe.vae.load_state_dict(saved["vae"])
            # cache reuse skips VAE training: keep the PSNR measured before, if any
            psnr = None
            if os.path.isfile(args.output):
                prev = json.load(open(args.output)).get("vae_recon_psnr_db")
                if isinstance(prev, (int, float)) and math.isfinite(prev):
                    psnr = float(prev)
            random_state = snapshot(pipe.flux, pipe.controlnet)
            batch = precompute_batch(pipe, samples)
            pipe.flux.load_state_dict(saved["flux"])
            pipe.controlnet.load_state_dict(saved["controlnet"])
    else:
        with clock.stage("train_vae"):
            print(f"[1/4] training VAE ({args.steps_vae} steps)...", flush=True)
            psnr, _ = train_vae(pipe.vae, samples, args.steps_vae)
            print(f"      recon PSNR {psnr:.1f} dB", flush=True)
        with clock.stage("batch"):
            print("[2/4] building the fixed training batch (production cond path)...",
                  flush=True)
            batch = precompute_batch(pipe, samples)
            # control: random FLUX and ControlNet with the same trained VAE
            random_state = snapshot(pipe.flux, pipe.controlnet)
        with clock.stage("train_flow"):
            print(f"[3/4] joint FLUX+CN training ({args.steps_flux} steps)...", flush=True)
            judge_train = None
            if args.ocr_loss_weight > 0.0:
                from reptext_tpu_torch.eval.ocr import load_judge as load_one

                judge_train = load_one(device=device)
            before = launch_counts()
            flow_losses = train_flow(pipe, batch, args.steps_flux, seed=args.train_seed,
                                     ocr_loss_weight=args.ocr_loss_weight, judge=judge_train)
            flow_launches = {k: n - before[k] for k, n in launch_counts().items()}
        if args.params_cache:
            with clock.stage("save"):
                save_pipeline_params({"vae": pipe.vae, "flux": pipe.flux,
                                      "controlnet": pipe.controlnet}, args.params_cache)
                print(f"      saved trained params to {args.params_cache}", flush=True)

    with clock.stage("sample_and_score"):
        print("[4/4] sampling + scoring (trained vs random)...", flush=True)
        judge = load_judge(device)
        res_trained = sample_and_score(pipe, samples, batch, args.steps_sample, judge)
        res_holdout = (sample_and_score(pipe, holdout_samples, batch, args.steps_sample, judge)
                       if holdout_samples is not None else None)
        pipe.flux.load_state_dict(random_state[0])
        pipe.controlnet.load_state_dict(random_state[1])
        res_random = sample_and_score(pipe, samples, batch, args.steps_sample, judge)

    n_images = len(samples) * 2 + (len(holdout_samples) if holdout_samples else 0)
    name, limit = device_info(device)
    timing = {"stages_s": {k: round(v, 3) for k, v in stages.items()},
              "sample_ms_per_step_trained": res_trained["sample_ms_per_step"],
              "attention_forward_launches_per_image": res_trained["attention_launches"]
              / len(samples),
              "images_sampled": n_images}
    if flow_losses:
        timing.update({
            "flow_ms_per_step": 1e3 * stages["train_flow"] / len(flow_losses),
            "flow_launches_per_step": {k: flow_launches[k] / len(flow_losses)
                                       for k in ("K2", "K4")},
            "flow_loss_first": flow_losses[0], "flow_loss_last": flow_losses[-1],
            "flow_losses_finite": bool(np.isfinite(flow_losses).all())})
    out = {
        "protocol": ("held-out generalization, train K=%d / eval %d unseen words, %d^2, "
                     "%d sample steps" % (len(samples), len(holdout_samples), args.size,
                                          args.steps_sample)) if args.holdout else
                    ("overfit-memorization, K=%d pairs, %d^2, %d sample steps"
                     % (len(samples), args.size, args.steps_sample)),
        "vae_recon_psnr_db": None if psnr is None else round(psnr, 2),
        "train_steps_vae": args.steps_vae,
        "train_steps_flux": args.steps_flux,
        "ocr_loss_weight": args.ocr_loss_weight,
        "train_seed": args.train_seed,
        "char_accuracy_trained": round(res_trained["char_accuracy"], 4),
        "char_accuracy_random": round(res_random["char_accuracy"], 4),
        "mean_edge_iou_trained": round(res_trained["mean_edge_iou"], 4),
        "mean_edge_iou_random": round(res_random["mean_edge_iou"], 4),
        **({"char_accuracy_holdout": round(res_holdout["char_accuracy"], 4),
            "mean_edge_iou_holdout": round(res_holdout["mean_edge_iou"], 4),
            "holdout_words": HOLDOUT_WORDS} if res_holdout is not None else {}),
        "words": train_words,
        "wall_s": round(time.time() - t_start, 1),
        "device": name,
        "power_limit": limit,
        "precision": precision_settings(),
        "timing": timing,
    }
    _write(args.output, out)
    print(json.dumps(out, indent=1))

    try:  # sample grid: row 0 targets, row 1 trained, row 2 random
        from PIL import Image

        rows = [np.concatenate([s["target"] for s in samples], axis=1),
                np.concatenate(res_trained["images"], axis=1),
                np.concatenate(res_random["images"], axis=1)]
        png = str(Path(args.output).with_suffix(".png"))
        Image.fromarray(np.concatenate(rows, axis=0)).save(png)
        print(f"wrote {png}")
    except Exception as e:  # noqa: BLE001 (the grid is optional, as in the JAX demo)
        print(f"grid save skipped: {e}")
    return out, pipe



if __name__ == "__main__":
    sys.exit(main())
