"""Host-side arithmetic of a request, worked out again for the reference.

Token ids of the prompt, the FlowMatch schedule, the posterior and noise
generators of a request seed, the antialiased mask resize, 2x2 latent
packing and the uint8 image conversions. Each follows the published
pipeline (diffusers' FLUX pipelines, RepText's ``infer.py``) and imports
nothing of the program.
"""

from __future__ import annotations

import math
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

PROMPT_SUFFIX = ", filmfotos, film grain, reversal film photography"


def quoted_prompt(prompt: str, texts: Sequence[str], suffix: str = PROMPT_SUFFIX) -> str:
    """RepText's prompt: every render text that is not CJK quoted in, then the suffix."""
    for t in texts:
        if not any("一" <= ch <= "鿿" for ch in t):
            prompt += f", '{t}'"
    return prompt + suffix


def token_ids(prompt: str, clip_vocab: int, clip_eos: int, clip_max: int, t5_vocab: int,
              t5_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stable ids for a prompt without a tokenizer file: CRC32 of each of the
    first 16 words; CLIP ids end in EOS and are padded with 0 to 16 (or cut at
    ``clip_max``), T5 ids end in 1 (</s>) and are padded with 0 to ``t5_length``."""
    crc = [zlib.crc32(w.encode("utf-8")) for w in prompt.split()[:16]]
    clip = ([h % (clip_vocab - 2) + 1 for h in crc] + [clip_eos])[:clip_max]
    clip += [0] * (min(16, clip_max) - len(clip))
    t5 = [h % (t5_vocab - 2) + 2 for h in crc] + [1]
    t5 += [0] * (t5_length - len(t5))
    return np.asarray([clip], np.int64), np.asarray([t5], np.int64)


def schedule(steps: int, image_seq_len: int, base_seq: int = 256, max_seq: int = 4096,
             base_shift: float = 0.5, max_shift: float = 1.16) -> Tuple[np.ndarray, np.ndarray]:
    """FLUX's FlowMatch Euler schedule with dynamic shifting: (sigmas [N + 1]
    with a trailing 0, model timesteps [N] = sigma * 1000), float32."""
    m = (max_shift - base_shift) / (max_seq - base_seq)
    mu = image_seq_len * m + (base_shift - m * base_seq)
    base = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    shifted = np.array([math.exp(mu) / (math.exp(mu) + (1 / s - 1)) for s in base])
    return (np.concatenate([shifted, [0.0]]).astype(np.float32),
            (shifted * 1000.0).astype(np.float32))


def generators(seed: int, device) -> List[torch.Generator]:
    """The request's four generators, seeded from one SeedSequence as the
    deployment seeds them: latent noise, condition posterior, glyph
    posterior, and the inpainting posterior (which txt2img leaves unused)."""
    states = np.random.SeedSequence(seed).generate_state(4)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in states]


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of an antialiased linear resize: half-pixel
    centres, a triangle kernel widened by the shrink factor, rows summing to 1."""
    inv = n_in / n_out
    centres = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(centres[:, None] - np.arange(n_in, dtype=np.float64)[None, :]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    return w / w.sum(axis=1, keepdims=True)


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w = img.shape[-2:]
    wh = torch.from_numpy(linear_resize_matrix(h, out_h)).float().to(img.device)
    ww = torch.from_numpy(linear_resize_matrix(w, out_w)).float().to(img.device)
    return wh @ img.float() @ ww.T


def ink_mask(glyph_canvas: np.ndarray, h: int, w: int) -> np.ndarray:
    """Latent-grid {0, 1} mask of the glyph canvas's ink, float64 on the host."""
    ink = (np.asarray(glyph_canvas) > 0).any(axis=-1).astype(np.float64)
    m = linear_resize_matrix(ink.shape[0], h) @ ink @ linear_resize_matrix(ink.shape[1], w).T
    return (m > 0).astype(np.float32)


def pack(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H/2 * W/2, 4C], features (c, dy, dx)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(
        b, (h // 2) * (w // 2), 4 * c)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, f = x.shape
    return x.reshape(b, h // 2, w // 2, f // 4, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
        b, f // 4, h, w)


def image_ids(h: int, w: int, device) -> torch.Tensor:
    """(0, row, col) ids of the (h/2) x (w/2) token grid."""
    rows, cols = torch.meshgrid(torch.arange(h // 2, device=device, dtype=torch.float32),
                                torch.arange(w // 2, device=device, dtype=torch.float32),
                                indexing="ij")
    return torch.stack([torch.zeros_like(rows), rows, cols], -1).reshape(-1, 3)


def to_unit(images: np.ndarray, device) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 NCHW in [-1, 1]."""
    x = torch.from_numpy(np.asarray(images, np.float32) / 255.0 * 2.0 - 1.0)
    return x.to(device).permute(0, 3, 1, 2)


def to_uint8(pixels: torch.Tensor) -> np.ndarray:
    """float NCHW in about [-1, 1] -> uint8 NHWC."""
    x = pixels.permute(0, 2, 3, 1).float().cpu().numpy()
    return (np.clip(x / 2.0 + 0.5, 0.0, 1.0) * 255.0).round().astype(np.uint8)
