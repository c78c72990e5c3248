"""Command line of the PyTorch port: txt2img, text inpainting, serving and ControlNet training.

Usage (converted checkpoints: ``python -m reptext_tpu_torch.io.convert_cli``;
or seeded random weights):
    python -m reptext_tpu_torch.cli --checkpoint-dir ~/ckpts/converted-torch \
        --text "مرحبا" --position 370 200 --prompt "a street sign in city" \
        --size 1024 --steps 30 --output results/result.png
    python -m reptext_tpu_torch.cli --mode serve --checkpoint-dir ~/ckpts/converted-torch \
        --port 8470 --max-batch 4 --batch-window 0.05 --serve-inpaint
    python -m reptext_tpu_torch.cli --text "مرحبا" --position 370 200 \
        --size 1024 --steps 30 --random-weights --output results/result.png
    python -m reptext_tpu_torch.cli --mode inpaint --image photo.jpg --mask mask.png \
        --text "مرحبا" --position 370 200 --true-guidance-scale 3.5 \
        --random-weights --output results/edited.png
    python -m reptext_tpu_torch.cli --mode train --random-weights --tiny --device cpu \
        --size 64 --train-steps 3 --batch-size 2 [--ocr-loss-weight 0.3] [--corpus-dir DIR]
    torchrun --nproc-per-node 2 -m reptext_tpu_torch.cli --shard sp2 --sp-backend ring \
        --text "مرحبا" --position 740 400 --size 2048 --random-weights
    torchrun --nproc-per-node 2 -m reptext_tpu_torch.cli --mode inpaint --shard sp2 \
        --image photo.jpg --mask mask.png --text "مرحبا" --position 370 200 --random-weights
    python -m reptext_tpu_torch.cli --text "مرحبا" --position 370 200 --random-weights \
        --init-image photo.png --strength 0.6 --sigmas 1.0,0.75,0.5,0.25

``--device`` (``cuda``, the default, or ``cpu``) says where the modules
live, as ``JAX_PLATFORMS`` does for the JAX CLI: bf16 on the card, float32 on
the CPU; without a card ``cuda`` raises. ``--tiny`` is a geometry flag only:
the tiny test geometry's head dim of 32 is not one the attention kernels
take, so it runs with ``--device cpu``. The flags keep the JAX
CLI's names and defaults (``reptext_tpu/cli.py``). ``--checkpoint-dir`` loads
the port's converted checkpoint (``io/checkpoint.py``; a JAX orbax directory
does not load): its ``configs.json`` geometry wins over the defaults unless
``--tiny`` is given, and prompts are tokenized by the vendored CLIP BPE and
SentencePiece tokenizers from its ``tokenizer*/`` files. Without those files
prompts become deterministic demo token ids (a stable CRC32 hash per word;
T5 ids padded to the 512-token budget). ``--mode serve`` answers ``POST
/generate``, ``GET /healthz`` and ``GET /metrics`` (``serving.py``), coalescing
compatible requests onto the batch axis of one sampler call.
Inpainting resizes the image so that its long side is at most 1536 and both
sides are multiples of 64 (``reptext_tpu_torch.utils.image.resize_to_multiple``)
and the mask to match; the negative prompt defaults to the reference's.
:func:`build_pipeline`, :func:`generate`, :func:`generate_inpaint` and
:func:`train` are the parts of :func:`main`, for in-process callers.
Training checkpoints every block (``remat``), which the JAX CLI does not: the
full geometry needs it to fit one card. ``--ocr-loss-weight > 0`` adds the
OCR text-perceptual term (the VAE decoder with gradients, its blocks
checkpointed too, and the frozen judge of ``--ocr-judge``, by default
``benchmarks/ocr_judge.npz`` beside the package); ``--corpus-dir`` trains on
an annotated photo corpus (``data_disk.py``). ``--shard spN`` (txt2img and inpaint)
shards the image tokens over N ranks, one process per card started by
``torchrun --nproc-per-node N`` (gloo processes on the CPU with ``--device
cpu``); every rank builds the same seeded pipeline, and rank 0 writes the
images. Without N ranks it raises. ``--shard DPxTP``/``auto``, and serving
and training under ``--shard``, are not ported yet. The generation flags of
the JAX CLI are here (``--color``, ``--no-shape``, ``--prompt-suffix``,
``--prompt-2``, ``--timesteps``/``--sigmas``, ``--init-image``/``--strength``
for txt2img, ``--control-guidance-start``/``-end``), and the adapters':
``--controlnet-mode`` (a union ControlNet's conditioning type, also in
training), ``--lora``/``--lora-scale`` (merged into ``--checkpoint-dir``'s
transformer at load time, ``io/lora.py``), ``--ip-adapter-dir`` (the
converter's ``ip_adapter/`` directory; without it a txt2img image prompt
attaches an untrained, no-op adapter), ``--ip-adapter-image`` and
``--ip-adapter-scale``; a server started with ``--ip-adapter-dir`` serves
image prompts. ``--weight-dtype fp8`` stores FLUX's and the ControlNets'
block stacks in fp8 (``io/quantize.py``; with ``--random-weights`` they are
drawn in fp8 directly, no bf16 copy of them is made), and a checkpoint
converted with ``convert_cli --dtype fp8`` is detected and loaded so;
``--vae-tiling auto|on|off`` tiles the VAE (``ops/vae_tiling.py``), auto
meaning on for fp8 weights at full geometry. As in the JAX CLI, training
with fp8 weights and ``--lora`` on an fp8-stored checkpoint are refused, and
the IP-Adapter is attached before the stacks are quantized (an fp8-stored
checkpoint cannot take one: convert it with ``--dtype keep`` or ``bf16``).
"""

from __future__ import annotations

import argparse
import functools
import os
import re
import sys
import zlib
from typing import Tuple

import numpy as np

# the JAX CLI's default --prompt-suffix (the reference driver's prompt style)
PROMPT_SUFFIX = ", filmfotos, film grain, reversal film photography"


def contains_cjk(text: str) -> bool:
    return re.search(r"[一-鿿]", text) is not None


def build_prompt(prompt: str, texts, suffix: str = "") -> str:
    """Quote non-CJK render text into the prompt (reference: infer.py:108-112);
    a copy of ``reptext_tpu/cli.py::build_prompt``."""
    for t in texts:
        if not contains_cjk(t):
            prompt += f", '{t}'"
    return prompt + suffix


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="RepText txt2img, inpainting and training, PyTorch + CUDA port")
    p.add_argument("--mode", choices=["txt2img", "inpaint", "serve", "train"],
                   default="txt2img")
    p.add_argument("--text", action="append",
                   help="txt2img/inpaint: text line to render (repeatable, required)")
    p.add_argument("--position", action="append", nargs=2, type=int,
                   metavar=("X", "Y"), help="txt2img/inpaint: top-left position per text line")
    p.add_argument("--color", action="append", nargs=3, type=int, metavar=("R", "G", "B"),
                   default=None, help="text colour per line (repeatable; default white)")
    p.add_argument("--prompt", default="a street sign in city")
    p.add_argument("--prompt-2", default=None,
                   help="separate prompt for the T5 encoder (CLIP still sees --prompt); "
                        "default: the same as --prompt")
    p.add_argument("--prompt-suffix", default=PROMPT_SUFFIX)
    p.add_argument("--size", type=int, default=1024,
                   help="square image size (inpaint: the image's own, resized)")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--timesteps", default=None, metavar="T1,T2,...",
                   help="custom model-facing timestep grid in (0,1000] (overrides --steps)")
    p.add_argument("--sigmas", default=None, metavar="S1,S2,...",
                   help="custom base sigma ladder in (0,1] (overrides --steps; mutually "
                        "exclusive with --timesteps)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--guidance-scale", type=float, default=3.5)
    p.add_argument("--controlnet-scale", type=float, default=1.0)
    p.add_argument("--controlnet-step", type=int, default=30,
                   help="ControlNet active for the first N steps")
    p.add_argument("--control-guidance-start", type=float, default=0.0,
                   help="step fraction at which the ControlNet turns on")
    p.add_argument("--control-guidance-end", type=float, default=1.0,
                   help="step fraction at which the ControlNet turns off")
    p.add_argument("--controlnet-mode", type=int, default=None,
                   help="union-mode conditioning-type index (required when the loaded "
                        "ControlNet is a union model)")
    p.add_argument("--velocity-cache-interval", type=int, default=1,
                   help="run the transformer every k-th step after warmup, "
                        "reusing the last velocity between (1 = off)")
    p.add_argument("--velocity-cache-warmup", type=int, default=8,
                   help="full model steps before velocity caching kicks in")
    p.add_argument("--velocity-cache-mode",
                   choices=["reuse", "linear", "adaptive", "adaptive-linear"], default="reuse",
                   help="skipped-step velocity: repeat the last computed, or first-order "
                        "extrapolation over sigma; adaptive* replaces the fixed interval "
                        "with the latent-drift trigger")
    p.add_argument("--velocity-cache-threshold", type=float, default=0.05,
                   help="adaptive modes: skip while the latents' relative L1 drift since "
                        "the last computed step is below this")
    p.add_argument("--velocity-cache-max-skip", type=int, default=3,
                   help="adaptive modes: max consecutive skipped steps")
    p.add_argument("--num-images", type=int, default=1,
                   help="images per prompt, txt2img and inpaint (one batched sampler call; "
                        "siblings saved as <output>_K.png)")
    p.add_argument("--image", default=None,
                   help="inpaint: input image path (resized to x64 dims)")
    p.add_argument("--init-image", default=None, metavar="PATH",
                   help="txt2img: img2img init image (paired with --strength; noise blended "
                        "at the matching schedule point)")
    p.add_argument("--strength", type=float, default=1.0,
                   help="img2img denoise strength in (0, 1]; 1.0 = pure txt2img")
    p.add_argument("--mask", default=None, help="inpaint: white-on-black mask image path")
    p.add_argument("--negative-prompt", default=None,
                   help="inpaint: CFG negative prompt (default: the reference's)")
    p.add_argument("--true-guidance-scale", type=float, default=1.0,
                   help="inpaint: true CFG scale over the negative prompt")
    p.add_argument("--font", default=None, help="TTF font path")
    p.add_argument("--font-size", type=int, default=80)
    p.add_argument("--no-shape", action="store_true",
                   help="disable Arabic shaping (the reference's raw behaviour)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="the port's converted checkpoint (python -m "
                        "reptext_tpu_torch.io.convert_cli ... --out DIR)")
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random weights (demo; without --checkpoint-dir)")
    p.add_argument("--lora", action="append", default=None, metavar="PATH",
                   help="LoRA safetensors (diffusers FLUX naming) merged into the transformer "
                        "at load time; repeatable")
    p.add_argument("--lora-scale", action="append", type=float, default=None, metavar="S",
                   help="merge scale for the matching --lora (default 1.0 each)")
    p.add_argument("--ip-adapter-image", default=None, metavar="PATH",
                   help="image-prompt (FLUX IP-Adapter) reference image")
    p.add_argument("--ip-adapter-scale", type=float, default=1.0)
    p.add_argument("--ip-adapter-dir", default=None, metavar="DIR",
                   help="the converter's ip_adapter/ directory (convert_cli --ip-adapter); "
                        "without it the adapter is untrained (an exact no-op)")
    p.add_argument("--weight-dtype", choices=["bf16", "fp8"], default="bf16",
                   help="fp8 = weight-only fp8-e4m3 storage of the transformer/ControlNet "
                        "block stacks (half their memory; the products stay bf16)")
    p.add_argument("--vae-tiling", choices=["auto", "on", "off"], default="auto",
                   help="tiled VAE encode/decode (bounded VAE activation memory); auto = on "
                        "whenever fp8 weights are used at full geometry")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model geometry (demo and tests; with --device cpu)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the modules run: cuda (bf16, the default) or cpu (float32)")
    p.add_argument("--output", default="results/result.png")
    p.add_argument("--host", default="127.0.0.1", help="serve: bind host")
    p.add_argument("--port", type=int, default=8470, help="serve: bind port")
    p.add_argument("--warmup", action="store_true",
                   help="serve: run one request before accepting traffic")
    p.add_argument("--max-batch", type=int, default=4,
                   help="serve: max coalesced requests per sampler call")
    p.add_argument("--batch-window", type=float, default=0.0,
                   help="serve: seconds to linger for burst coalescing")
    p.add_argument("--serve-inpaint", action="store_true",
                   help="serve: also build the inpaint pipeline (POST /generate with "
                        "mode=inpaint)")
    p.add_argument("--train-steps", type=int, default=100, help="train: optimization steps")
    p.add_argument("--batch-size", type=int, default=2, help="train: samples per step")
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--text-loss-weight", type=float, default=2.0,
                   help="train: extra loss weight inside text-region tokens")
    p.add_argument("--ocr-loss-weight", type=float, default=0.0,
                   help="train: OCR text-perceptual loss weight (0 = off)")
    p.add_argument("--ocr-judge", default=None, metavar="NPZ",
                   help="train: OCR judge weights (default benchmarks/ocr_judge.npz)")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="train: steps between restore points")
    p.add_argument("--train-dir", default=None,
                   help="train: directory for restore points and controlnet_final.pt "
                        "(omit for in-memory restore points)")
    p.add_argument("--corpus-dir", default=None,
                   help="train on an annotated photo corpus (annotations.jsonl + images)")
    p.add_argument("--shard", default=None, metavar="spN",
                   help="txt2img and inpaint: shard the image tokens over N ranks, one process "
                        "per card under torchrun --nproc-per-node N (DPxTP and auto: not "
                        "ported yet)")
    p.add_argument("--sp-backend", choices=["ring", "ulysses"], default="ring",
                   help="sequence-parallel attention for --shard spN: the K/V ring, or the "
                        "ulysses all-to-all head swap (needs heads %% N == 0)")
    return p


def pipeline_config(args, height=None, width=None):
    """The ``PipelineConfig`` of the flags at ``height`` x ``width`` (default
    ``--size`` square)."""
    from reptext_tpu_torch.configs import PipelineConfig

    return PipelineConfig(
        height=height or args.size, width=width or args.size, num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        controlnet_conditioning_scale=args.controlnet_scale,
        controlnet_conditioning_step=args.controlnet_step,
        control_mode=args.controlnet_mode,
        control_guidance_start=args.control_guidance_start,
        control_guidance_end=args.control_guidance_end,
        true_guidance_scale=args.true_guidance_scale,
        velocity_cache_interval=args.velocity_cache_interval,
        velocity_cache_warmup=args.velocity_cache_warmup,
        velocity_cache_mode=args.velocity_cache_mode,
        velocity_cache_threshold=args.velocity_cache_threshold,
        velocity_cache_max_skip=args.velocity_cache_max_skip,
    )


def make_configs(args, height=None, width=None):
    """(flux, controlnet, vae, clip, t5, pipeline) configs for the flags: the
    geometry that ``--checkpoint-dir``'s configs.json records wins over the
    defaults unless ``--tiny`` is given."""
    from reptext_tpu_torch.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig

    cfgs = [FluxConfig(), ControlNetConfig(), VAEConfig(), CLIPConfig(), T5Config()]
    if args.tiny:
        cfgs = [c.tiny() for c in cfgs]
    elif args.checkpoint_dir:
        from reptext_tpu_torch.io.checkpoint import load_saved_configs

        saved = load_saved_configs(args.checkpoint_dir)
        cfgs = [saved.get(name, c) for name, c in zip(("flux", "controlnet", "vae", "clip", "t5"),
                                                       cfgs)]
    return (*cfgs, pipeline_config(args, height, width))


def load_inpaint_inputs(image_path: str, mask_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(image uint8 [H, W, 3], mask uint8 [H, W]): the image resized to x64
    sides (long side at most 1536), the mask resized to match."""
    from PIL import Image

    from reptext_tpu_torch.utils.image import resize_to_multiple

    image = resize_to_multiple(np.asarray(Image.open(image_path).convert("RGB"), np.uint8))
    h, w = image.shape[:2]
    mask = np.asarray(Image.open(mask_path).convert("L").resize((w, h)), np.uint8)
    return image, mask


def build_pipeline(args, height=None, width=None):
    """The pipeline the flags describe on ``--device`` (bf16 on the CUDA
    device, float32 on the CPU): the weights of ``--checkpoint-dir``, mapped
    from its files into modules built on the meta device, or seeded random
    ones. ``--mode inpaint`` adds the inpaint ControlNet to the same modules
    (:func:`add_inpaint`). Then ``--weight-dtype`` and ``--vae-tiling``
    (:func:`deploy`)."""
    import torch

    from reptext_tpu_torch.io.quantize import is_quantized
    from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline

    params = None
    if args.checkpoint_dir:
        from reptext_tpu_torch.io.checkpoint import load_pipeline_params

        params = load_pipeline_params(args.checkpoint_dir,
                                      ("flux", "controlnet", "vae", "clip", "t5"))
        missing = sorted({"flux", "controlnet", "vae", "clip", "t5"} - set(params))
        if missing:
            raise SystemExit(f"--checkpoint-dir {args.checkpoint_dir} lacks {missing}")
    elif not args.random_weights:
        raise SystemExit("pass --checkpoint-dir or --random-weights")
    flux_cfg, cn_cfg, vae_cfg, clip_cfg, t5_cfg, pipe_cfg = make_configs(args, height, width)
    pre_quantized = params is not None and any(is_quantized(params[n])
                                               for n in ("flux", "controlnet"))
    fp8 = args.weight_dtype == "fp8" or pre_quantized
    if args.lora:
        if pre_quantized:
            raise SystemExit("--lora cannot merge into an fp8-stored checkpoint; bake it at "
                             "conversion time (convert_cli --lora) or convert with --dtype "
                             "keep/bf16")
        merge_loras(args, params, flux_cfg)
    if args.mode == "train" and fp8:
        raise SystemExit("training needs dense weights: convert with --dtype keep/bf16 and drop "
                         "--weight-dtype fp8")
    ip = (args.mode == "serve" and args.ip_adapter_dir) or (
        args.mode == "txt2img" and args.ip_adapter_image)
    if ip and pre_quantized:
        raise SystemExit("the IP-Adapter is attached before the block stacks are quantized, and "
                         "this checkpoint stores them in fp8: convert it with --dtype keep/bf16")
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    pipeline = FluxRepTextPipeline.create(
        flux_cfg, cn_cfg, vae_cfg, pipe_cfg, params=params, clip_cfg=clip_cfg, t5_cfg=t5_cfg,
        seed=args.seed, device=args.device, dtype=dtype, remat=args.mode == "train",
        weight_quant=fp8 and params is None and not ip)
    if ip:
        attach_ip_adapter(args, pipeline)
    if args.mode == "inpaint":
        pipeline = add_inpaint(args, pipeline)
    return deploy(args, pipeline, fp8)


def deploy(args, pipeline, fp8: bool):
    """``pipeline`` quantized when ``fp8`` (``--weight-dtype fp8`` or an
    fp8-stored checkpoint; a no-op for what is stored so already) and tiled
    as ``--vae-tiling`` says: on, off, or auto = on for fp8 at full
    geometry."""
    if fp8:
        pipeline.quantize_weights()
    if args.vae_tiling == "on" or (args.vae_tiling == "auto" and fp8 and not args.tiny):
        pipeline.enable_vae_tiling()
    return pipeline


def merge_loras(args, params, flux_cfg) -> None:
    """``--lora``/``--lora-scale``: each LoRA merged into ``params["flux"]``
    (the checkpoint's transformer state, in place) at its scale, 1.0 where
    none is given; the JAX CLI's errors."""
    if params is None or "flux" not in params:
        raise SystemExit("--lora requires --checkpoint-dir with a flux component")
    from reptext_tpu_torch.io.convert import load_safetensors_state
    from reptext_tpu_torch.io.lora import apply_lora

    scales = list(args.lora_scale or [])
    if len(scales) > len(args.lora):
        raise SystemExit("more --lora-scale values than --lora paths")
    scales += [1.0] * (len(args.lora) - len(scales))
    for path, scale in zip(args.lora, scales):
        apply_lora(params["flux"], load_safetensors_state(path, dtype=None), scale=scale,
                   head_dim=flux_cfg.attention_head_dim)
        print(f"merged LoRA {path} (scale {scale})")


def attach_ip_adapter(args, pipeline):
    """The IP-Adapter on ``pipeline``: ``--ip-adapter-dir``'s weights and
    geometry (its configs.json, else the checkpoint's), or an untrained one
    (``--tiny``: the tiny vision tower)."""
    from reptext_tpu_torch.configs import CLIPVisionConfig
    from reptext_tpu_torch.io.checkpoint import load_pipeline_params, load_saved_configs

    saved = load_saved_configs(args.checkpoint_dir) if args.checkpoint_dir else {}
    params = None
    if args.ip_adapter_dir:
        saved = {**saved, **load_saved_configs(args.ip_adapter_dir)}
        params = load_pipeline_params(args.ip_adapter_dir, ("vision", "proj", "blocks", "flux"))
    default = CLIPVisionConfig().tiny() if args.tiny else CLIPVisionConfig()
    return pipeline.attach_ip_adapter(vision_cfg=saved.get("clip_vision", default),
                                      ip_cfg=saved.get("ip_adapter"), params=params,
                                      seed=args.seed)


def load_ip_image(path: str) -> np.ndarray:
    """``--ip-adapter-image`` as uint8 [H, W, 3]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def add_inpaint(args, pipeline):
    """An inpaint pipeline over ``pipeline``'s modules plus the inpaint
    ControlNet: ``--checkpoint-dir``'s when it holds one (its configs.json
    geometry unless ``--tiny``), else seeded random weights."""
    from reptext_tpu_torch.io.checkpoint import component_path
    from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline

    cfg = params = None
    if args.checkpoint_dir and os.path.isfile(component_path(args.checkpoint_dir,
                                                             "inpaint_controlnet")):
        from reptext_tpu_torch.io.checkpoint import load_pipeline_params, load_saved_configs

        params = load_pipeline_params(args.checkpoint_dir,
                                      ("inpaint_controlnet",))["inpaint_controlnet"]
        if not args.tiny:
            cfg = load_saved_configs(args.checkpoint_dir).get("inpaint_controlnet")
    return FluxRepTextInpaintPipeline.from_pipeline(pipeline, cfg, params, seed=args.seed + 7)


def demo_token_ids(prompt: str, clip_cfg, t5_cfg, t5_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic demo ids: CRC32 per word, CLIP ids ending in EOS, T5 ids
    ending in </s> (1) and padded with 0 to ``t5_length``."""
    words = prompt.split()[:16]
    crc = [zlib.crc32(w.encode("utf-8")) for w in words]
    clip = [h % (clip_cfg.vocab_size - 2) + 1 for h in crc] + [clip_cfg.eos_token_id]
    clip = clip[:clip_cfg.max_position_embeddings]
    clip += [0] * (min(16, clip_cfg.max_position_embeddings) - len(clip))
    t5 = [h % (t5_cfg.vocab_size - 2) + 2 for h in crc] + [1]
    t5 += [0] * (t5_length - len(t5))
    return np.asarray([clip], np.int64), np.asarray([t5], np.int64)


@functools.lru_cache(maxsize=4)
def _tokenizers(clip_dir: str, spm_path: str):
    """The vendored tokenizers of one checkpoint directory, read once (a
    server tokenizes every request)."""
    from reptext_tpu_torch.text import CLIPBPETokenizer, SentencePieceUnigram

    return CLIPBPETokenizer.from_dir(clip_dir), SentencePieceUnigram.from_file(spm_path)


def _tokenize(prompt: str, clip_cfg, t5_cfg, checkpoint_dir, t5_length: int = 512
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(clip ids [1, 77], t5 ids [1, t5_length]) from the vendored tokenizers
    when ``checkpoint_dir`` holds ``tokenizer/vocab.json`` and
    ``tokenizer_2/spiece.model``, else :func:`demo_token_ids`. The JAX CLI's
    fallback hashes words with Python's salted ``hash()`` and pads no T5 ids;
    the port's is stable across processes."""
    if checkpoint_dir:
        clip_dir = os.path.join(checkpoint_dir, "tokenizer")
        spm = os.path.join(checkpoint_dir, "tokenizer_2", "spiece.model")
        if os.path.isfile(os.path.join(clip_dir, "vocab.json")) and os.path.isfile(spm):
            clip_tok, t5_tok = _tokenizers(os.path.abspath(clip_dir), os.path.abspath(spm))
            clip = clip_tok.encode(prompt, max_length=clip_cfg.max_position_embeddings)
            t5 = t5_tok.encode(prompt, max_length=t5_length, add_eos=True, pad_to_max=True)
            return np.asarray([clip], np.int64), np.asarray([t5], np.int64)
    return demo_token_ids(prompt, clip_cfg, t5_cfg, t5_length)


def _prompt_ids(args, pipeline, prompt: str) -> Tuple[np.ndarray, np.ndarray]:
    return _tokenize(prompt, pipeline.clip.config, pipeline.t5.config, args.checkpoint_dir,
                     pipeline.pipe_cfg.max_sequence_length)


def request_ids(args, pipeline) -> Tuple[np.ndarray, np.ndarray]:
    """(CLIP ids, T5 ids) of the request: ``--prompt`` with the render text
    quoted in and ``--prompt-suffix``; T5's from ``--prompt-2`` when given."""
    clip_ids, t5_ids = _prompt_ids(args, pipeline, build_prompt(args.prompt, args.text,
                                                                args.prompt_suffix))
    if args.prompt_2 is not None:
        _, t5_ids = _prompt_ids(args, pipeline, build_prompt(args.prompt_2, args.text,
                                                             args.prompt_suffix))
    return clip_ids, t5_ids


def schedule_kwargs(args) -> dict:
    """``timesteps=`` or ``sigmas=`` of ``--timesteps``/``--sigmas`` (comma lists;
    the pipeline refuses both at once)."""
    kw = {}
    if args.timesteps:
        kw["timesteps"] = [float(t) for t in args.timesteps.split(",")]
    if args.sigmas:
        kw["sigmas"] = [float(s) for s in args.sigmas.split(",")]
    return kw


def load_init_image(path: str, width: int, height: int) -> np.ndarray:
    """``--init-image`` as uint8 [1, height, width, 3]."""
    from PIL import Image

    init = Image.open(path).convert("RGB").resize((width, height))
    return np.asarray(init, np.uint8)[None]


def generate(args, pipeline, conditions, timings=None, output_type: str = "np",
             init_image=None):
    """One txt2img request: uint8 images [num_images, H, W, 3] (or
    ``output_type``); img2img from ``init_image`` at ``--strength``."""
    clip_ids, t5_ids = request_ids(args, pipeline)
    img2img = {} if init_image is None else dict(init_image=init_image, strength=args.strength)
    if args.ip_adapter_image:
        img2img.update(ip_adapter_image=load_ip_image(args.ip_adapter_image),
                       ip_adapter_scale=args.ip_adapter_scale)
    return pipeline(conditions, clip_ids=clip_ids, t5_ids=t5_ids, seed=args.seed,
                    num_images=args.num_images, num_inference_steps=args.steps,
                    guidance_scale=args.guidance_scale, output_type=output_type,
                    timings=timings, **schedule_kwargs(args), **img2img)


def generate_inpaint(args, pipeline, conditions, image: np.ndarray, mask: np.ndarray,
                     timings=None, output_type: str = "np"):
    """One inpaint request on ``image`` (uint8 [H, W, 3] at the pipeline's
    size) under ``mask``: uint8 images [num_images, H, W, 3] (or ``output_type``)."""
    from reptext_tpu_torch.text import pad_to_common_length
    from reptext_tpu_torch.pipelines.inpaint import DEFAULT_NEGATIVE_PROMPT

    clip_ids, t5_ids = request_ids(args, pipeline)
    neg_clip, neg_t5 = _prompt_ids(args, pipeline, args.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
    # true CFG concatenates [negative; positive] embeds: one sequence length
    t5_ids, neg_t5 = pad_to_common_length(t5_ids, neg_t5)
    clip_ids, neg_clip = pad_to_common_length(clip_ids, neg_clip)
    return pipeline(conditions, image=image, mask=mask, clip_ids=clip_ids, t5_ids=t5_ids,
                    negative_clip_ids=neg_clip, negative_t5_ids=neg_t5, seed=args.seed,
                    num_images=args.num_images, num_inference_steps=args.steps,
                    guidance_scale=args.guidance_scale,
                    true_guidance_scale=args.true_guidance_scale, output_type=output_type,
                    timings=timings, **schedule_kwargs(args))


def train(args, pipeline, dataset=None, on_event=None):
    """ControlNet training (``--mode train``): warm start from the base, AdamW,
    ``GlyphTextDataset`` batches (``DiskImageTextDataset`` with
    ``--corpus-dir``, or ``dataset``) through a ``PrefetchLoader`` and the
    ``ElasticTrainer``; with ``--ocr-loss-weight > 0`` the step adds the OCR
    term through the pipeline's differentiable decode and the frozen judge.
    Returns the trainer (its ``losses``)."""
    import torch

    from reptext_tpu_torch.data import GlyphTextDataset, PrefetchLoader
    from reptext_tpu_torch.sampling.elastic import ElasticTrainer
    from reptext_tpu_torch.sampling.train_controlnet import (
        bind_frozen_base, init_controlnet_training, make_controlnet_train_step,
    )

    cn_cfg = pipeline.controlnet.config
    if cn_cfg.union and args.controlnet_mode is None:
        # a union checkpoint trains on one conditioning type, as it samples
        raise SystemExit("training a union-mode ControlNet requires --controlnet-mode")
    controlnet, optimizer = init_controlnet_training(
        pipeline.flux, pipeline.controlnet, cn_cfg.num_layers, cn_cfg.num_single_layers,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay)
    # the checkpoint's tokenizers, when it has them, tokenize the training prompts too
    tokenize = functools.partial(_prompt_ids, args, pipeline)
    if dataset is None and args.corpus_dir:
        from reptext_tpu_torch.data_disk import DiskImageTextDataset

        dataset = DiskImageTextDataset(pipeline, args.corpus_dir, batch_size=args.batch_size,
                                       font_path=args.font, seed=args.seed, tokenize=tokenize)
    elif dataset is None:
        dataset = GlyphTextDataset(pipeline, batch_size=args.batch_size, font_path=args.font,
                                   seed=args.seed, tokenize=tokenize)
    perceptual, frozen = None, ()
    if args.ocr_loss_weight > 0.0:
        from reptext_tpu_torch.eval.ocr import load_judge

        judge = load_judge(args.ocr_judge, pipeline.device)
        perceptual = {"decode": pipeline.decode_images, "judge": judge,
                      "weight": args.ocr_loss_weight}
        frozen = (pipeline.vae, judge)
    step = make_controlnet_train_step(controlnet, optimizer,
                                      text_loss_weight=args.text_loss_weight,
                                      perceptual=perceptual, control_mode=args.controlnet_mode)
    loader = PrefetchLoader(dataset.batch, depth=2)  # host build overlaps the device step
    trainer = ElasticTrainer(
        bind_frozen_base(step, pipeline.flux, *frozen), loader,
        state={"controlnet": controlnet, "optimizer": optimizer}, device=pipeline.device,
        checkpoint_dir=args.train_dir, checkpoint_every=args.checkpoint_every,
        on_event=on_event or (lambda kind, info: print(f"[{kind}] {info}", flush=True)))
    try:
        losses = trainer.run(args.train_steps, seed=args.seed)
    finally:
        loader.close()
    k = max(1, min(10, len(losses) // 4))
    print(f"trained {args.train_steps} steps: loss(first {k} mean)={np.mean(losses[:k]):.4f} "
          f"-> loss(last {k} mean)={np.mean(losses[-k:]):.4f}", flush=True)
    if args.train_dir:
        out = os.path.join(args.train_dir, "controlnet_final.pt")
        torch.save(controlnet.state_dict(), out)
        print(f"saved the trained ControlNet to {out}")
    return trainer


def build_server(args):
    """The ``--mode serve`` server (not yet serving): a ``GenerationServer``
    over the pipeline of the flags at ``--size`` and, with
    ``--serve-inpaint``, the inpaint pipeline over the same modules;
    prompts through :func:`_tokenize`."""
    from reptext_tpu_torch.serving import GenerationServer

    pipeline = build_pipeline(args)
    inpaint = None
    if args.serve_inpaint:
        # over the served pipeline's (quantized) modules; only a dense inpaint
        # ControlNet is quantized here
        inpaint = add_inpaint(args, pipeline)
        if pipeline.flux.weight_quant:
            inpaint.quantize_weights()
    clip_cfg, t5_cfg = pipeline.clip.config, pipeline.t5.config
    t5_length = pipeline.pipe_cfg.max_sequence_length

    def tokenizer(prompt):
        return _tokenize(prompt, clip_cfg, t5_cfg, args.checkpoint_dir, t5_length)

    return GenerationServer(pipeline, host=args.host, port=args.port, tokenizer=tokenizer,
                            warmup=args.warmup, max_batch=args.max_batch,
                            batch_window_s=args.batch_window, inpaint_pipeline=inpaint)


def sp_group(args):
    """The SP group of ``--shard spN`` (txt2img and inpaint): this job's N ranks."""
    spec = args.shard.lower()
    if args.mode not in ("txt2img", "inpaint"):
        raise SystemExit(f"--shard is not ported yet for --mode {args.mode}")
    if not spec.startswith("sp") or (spec[2:] and not spec[2:].isdigit()):
        raise SystemExit(f"--shard {args.shard}: only spN is ported yet (DPxTP and auto are "
                         "not ported yet)")
    from reptext_tpu_torch.parallel import make_sp_group

    n = int(spec[2:]) if spec[2:] else int(os.environ.get("WORLD_SIZE", "1"))
    return make_sp_group(n, args.device)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    group = sp_group(args) if args.shard else None
    if args.mode == "serve":
        server = build_server(args)
        host, port = server.address[:2]
        print(f"serving on http://{host}:{port} (POST /generate, GET /healthz, GET /metrics)",
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
        return 0
    if args.mode == "train":
        train(args, build_pipeline(args))
        return 0
    if not args.text or not args.position:
        parser.error(f"{args.mode} needs --text and --position")
    if len(args.text) != len(args.position):
        parser.error("--text and --position counts must match")
    colors = args.color or [(255, 255, 255)] * len(args.text)
    if len(colors) != len(args.text):
        parser.error("--color count must match --text")
    if args.timesteps and args.sigmas:
        parser.error("--timesteps and --sigmas are mutually exclusive")
    inpaint = args.mode == "inpaint"
    if inpaint and (args.image is None or args.mask is None):
        parser.error("--mode inpaint requires --image and --mask")
    if args.init_image and not inpaint and args.strength >= 1.0:
        parser.error("--init-image does nothing at --strength 1.0; pass --strength < 1.0 "
                     "(fraction of the schedule to re-noise)")

    from reptext_tpu_torch.conditioning import TextLine, build_conditions

    height = width = args.size
    if inpaint:
        image, mask = load_inpaint_inputs(args.image, args.mask)
        height, width = image.shape[:2]
    pipeline = build_pipeline(args, height, width)
    if group is not None:
        pipeline.shard_for_sp(group, args.sp_backend)
    lines = [TextLine(t, tuple(p), tuple(c), font_size=args.font_size)
             for t, p, c in zip(args.text, args.position, colors)]
    conditions = build_conditions(lines, width, height, font_path=args.font,
                                  font_size=args.font_size, shape_text=not args.no_shape)
    if inpaint:
        images = generate_inpaint(args, pipeline, conditions, image, mask)
    else:
        init = (load_init_image(args.init_image, width, height) if args.init_image
                else None)
        images = generate(args, pipeline, conditions, init_image=init)

    if group is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        if group.rank != 0:
            return 0
    from PIL import Image

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    root, ext = os.path.splitext(args.output)
    for k, im in enumerate(images):
        path = args.output if k == 0 else f"{root}_{k}{ext or '.png'}"
        Image.fromarray(im).save(path)
        print(f"saved {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
