"""OCR judge: a small CTC conv recognizer for glyph-accuracy scoring (PyTorch).

Counterpart of ``reptext_tpu/eval/ocr.py``. The judge reads a grayscale text
crop of 48 x 256 pixels and gives 64 frames of class logits (class 0 is the
CTC blank, class i + 1 is ``CHARSET[i]``). Its frozen weights are the JAX
package's, ``benchmarks/ocr_judge.npz`` (a Flax tree with the charset they
were trained for), read by :func:`load_judge` into an :class:`OCRJudge`.

The module is NCHW: images [B, 1, 48, 256] -> logits [B, 64, K]. The host
code (rendering, crop canonicalisation, augmentation, batches, greedy CTC
decoding, the edit distance) is a numpy and PIL copy of the JAX package's;
``prepare_crop`` keeps its [48, 256, 1] layout. Flax pads its stride-2
convolutions ``SAME``, which is asymmetric (0 before, 1 after on an even
input), so every convolution here pads explicitly by that rule.
"""

from __future__ import annotations

import copy
import glob
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

# Class 0 is the CTC blank; class i+1 maps to CHARSET[i].
ARABIC = "ءآأؤإئابةتثجحخدذرزسشصضطظعغفقكلمنهوىي"
LATIN = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
LATIN_LOWER = "abcdefghijklmnopqrstuvwxyz"
DIGITS = "0123456789"
CHARSET = ARABIC + LATIN + LATIN_LOWER + DIGITS
CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHARSET)}

IMG_H, IMG_W = 48, 256   # judge input geometry
FRAMES = 64              # output time steps (IMG_W / 4)
MAX_LABEL = 24

# (features, (stride_h, stride_w)) of the four 3x3 convolutions
_CONVS = ((64, (2, 2)), (128, (2, 2)), (160, (2, 1)), (224, (2, 1)))


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding (lo, hi) of one axis (``lax.padtype_to_pads``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class OCRJudge(nn.Module):
    """Column-wise conv encoder -> per-frame class logits (CTC head).

    Four 3x3 convolutions (64, 128, 160, 224 features; strides (2, 2), (2, 2),
    (2, 1), (2, 1)), a mean over the height, 1-D convolutions of width 5 and
    3 over the frames, then Dense 192 and Dense to the classes. Submodule
    names are the Flax tree's (``Conv_0`` .. ``Conv_5``, ``Dense_0``,
    ``Dense_1``), so ``load_jax_params`` carries the JAX weights over.
    """

    def __init__(self, num_classes: int = len(CHARSET) + 1, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cin = 1
        for i, (feat, _) in enumerate(_CONVS):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, feat, 3, **kw))
            cin = feat
        self.Conv_4 = nn.Conv1d(cin, 224, 5, **kw)
        self.Conv_5 = nn.Conv1d(224, 224, 3, **kw)
        self.Dense_0 = nn.Linear(224, 192, **kw)
        self.Dense_1 = nn.Linear(192, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 1, 48, 256] -> logits [B, 64, K]."""
        x = x.to(self.Conv_0.weight.dtype)
        for i, (_, (sh, sw)) in enumerate(_CONVS):
            h_lo, h_hi = same_pads(x.shape[2], 3, sh)
            w_lo, w_hi = same_pads(x.shape[3], 3, sw)
            x = F.relu(F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)),
                                getattr(self, f"Conv_{i}").weight,
                                getattr(self, f"Conv_{i}").bias, stride=(sh, sw)))
        x = x.mean(dim=2)                                  # [B, 224, W/4]
        x = F.relu(F.conv1d(F.pad(x, same_pads(x.shape[2], 5, 1)),
                            self.Conv_4.weight, self.Conv_4.bias))
        x = F.relu(F.conv1d(F.pad(x, same_pads(x.shape[2], 3, 1)),
                            self.Conv_5.weight, self.Conv_5.bias))
        x = F.relu(self.Dense_0(x.transpose(1, 2)))
        return self.Dense_1(x)


# ----------------------------------------------------------------- rendering


def _font(size: int, font_path: Optional[str] = None):
    from PIL import ImageFont

    from reptext_tpu_torch.conditioning import default_font_path

    return ImageFont.truetype(font_path or default_font_path(), size)


def render_word(text: str, font_size: int = 40, font_path: Optional[str] = None,
                pad: int = 4) -> np.ndarray:
    """Render ``text`` (shaped + bidi'd) white-on-black, tightly cropped.

    Returns a float32 [h, w] image in [0, 1].
    """
    from PIL import Image, ImageDraw

    from reptext_tpu_torch.conditioning import prepare_display_text

    display = prepare_display_text(text)
    font = _font(font_size, font_path)
    canvas_w, canvas_h = 20 * font_size, 3 * font_size
    img = Image.new("L", (canvas_w, canvas_h), 0)
    draw = ImageDraw.Draw(img)
    pos = (font_size // 2, font_size // 2)
    draw.text(pos, display, font=font, fill=255)
    x0, y0, x1, y1 = (int(v) for v in draw.textbbox(pos, display, font=font))
    x0, y0 = max(x0 - pad, 0), max(y0 - pad, 0)
    x1, y1 = min(x1 + pad, canvas_w), min(y1 + pad, canvas_h)
    arr = np.asarray(img, np.float32)[y0:y1, x0:x1] / 255.0
    if arr.size == 0:
        arr = np.zeros((IMG_H, IMG_W), np.float32)
    return arr


def _resize_box(g: np.ndarray) -> np.ndarray:
    """Aspect-preserving resize of a [h, w] grayscale image into the
    IMG_H x IMG_W box (left-aligned, padded with the border's median), values
    scaled to [0, 1]."""
    from PIL import Image

    h, w = g.shape
    if h == 0 or w == 0:
        return np.zeros((IMG_H, IMG_W), np.float32)
    scale = min(IMG_H / h, IMG_W / w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    peak = float(g.max())
    img = Image.fromarray(
        np.clip(g * (255.0 if peak <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    ).resize((nw, nh), Image.BILINEAR)
    small = np.asarray(img, np.float32) / 255.0
    # a black pad band would read as ink on inverted or low-contrast crops
    border = np.concatenate([small[0, :], small[-1, :], small[:, 0], small[:, -1]])
    out = np.full((IMG_H, IMG_W), float(np.median(border)), np.float32)
    out[:nh, :nw] = small
    return out


def _standardize(g: np.ndarray) -> np.ndarray:
    return (g - g.mean()) / (g.std() + 1e-5)


def _canonicalize(g: np.ndarray, pad_frac: float = 0.18) -> np.ndarray:
    """Crop to the ink bounding box, then add a background margin of
    ``pad_frac`` of the ink height: the judge is scale-sensitive, so train and
    eval crops share one tightness.

    Ink: deviation from the border-median background above 25 % of the crop's
    peak deviation. Flat crops come back unchanged.
    """
    h, w = g.shape
    if h < 4 or w < 4:
        return g
    border = np.concatenate([g[0, :], g[-1, :], g[:, 0], g[:, -1]])
    bg = float(np.median(border))
    dev = np.abs(g - bg)
    peak = float(dev.max())
    if peak <= 1e-6:
        return g
    ink = dev > 0.25 * peak
    rows = np.flatnonzero(ink.any(axis=1))
    cols = np.flatnonzero(ink.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return g
    y0, y1 = rows[0], rows[-1] + 1
    x0, x1 = cols[0], cols[-1] + 1
    tight = g[y0:y1, x0:x1]
    ph = max(2, int(round(pad_frac * (y1 - y0))))
    pw = ph
    out = np.full((y1 - y0 + 2 * ph, x1 - x0 + 2 * pw), bg, np.float32)
    out[ph:ph + y1 - y0, pw:pw + x1 - x0] = tight
    return out


def prepare_crop(region: np.ndarray) -> np.ndarray:
    """An image crop ([h, w] or [h, w, 3]) -> judge input [IMG_H, IMG_W, 1]:
    grayscale, :func:`_canonicalize`, :func:`_resize_box`, standardised.
    Polarity is left as it is (the judge was trained polarity-invariant)."""
    g = region.astype(np.float32)
    if g.ndim == 3:
        g = g.mean(axis=-1)
    return _standardize(_resize_box(_canonicalize(g)))[:, :, None]


def _augment(img: np.ndarray, rng: np.random.Generator, harsh: bool = False) -> np.ndarray:
    """Train-time augmentation: background level, contrast, polarity, blur,
    noise; ``harsh`` draws the tail (low contrast, strong blur and noise)."""
    from scipy import ndimage

    if harsh:
        ink = rng.uniform(0.5, 0.72)
        bg = rng.uniform(0.22, 0.35)
    else:
        ink = rng.uniform(0.5, 1.0)
        bg = rng.uniform(0.0, 0.35)
    out = bg + img * (ink - bg)
    if rng.random() < 0.5:
        out = 1.0 - out                              # polarity flip
    if harsh or rng.random() < 0.6:
        lo, hi = (0.5, 0.8) if harsh else (0.2, 0.8)
        out = ndimage.gaussian_filter(out, rng.uniform(lo, hi))
    lo_n = 0.04 if harsh else 0.01
    out = out + rng.normal(0.0, rng.uniform(lo_n, 0.07), out.shape)
    return out.astype(np.float32)


def random_word(rng: np.random.Generator) -> str:
    """A word of a uniformly drawn script and length (labels are
    case-sensitive), sometimes a two-word phrase."""
    script = rng.choice(["ar", "lat", "low", "dig", "mix"],
                        p=[0.33, 0.17, 0.17, 0.2, 0.13])
    n = int(rng.integers(2, 10))
    if script == "ar":
        pool = ARABIC
    elif script == "lat":
        pool = LATIN
    elif script == "low":
        pool = LATIN_LOWER
    elif script == "dig":
        pool = DIGITS
    else:
        pool = LATIN + LATIN_LOWER + DIGITS
    word = "".join(rng.choice(list(pool)) for _ in range(n))
    if script in ("lat", "low") and rng.random() < 0.3:
        word = word[:1].upper() + word[1:].lower()       # Titlecase shapes
    if rng.random() < 0.2:                               # two-word phrase
        second = "".join(
            rng.choice(list(pool)) for _ in range(int(rng.integers(2, 7))))
        word = f"{word} {second}"
    return word


# visually confusable groups under blur and noise, oversampled in training
CONFUSION_GROUPS = ["O0QDG", "Il1J", "B8", "S5s", "Z2z", "6Gb", "coCO",
                    "uvUV", "xXkK", "pPqg"]


def confusion_word(rng: np.random.Generator) -> str:
    """A word built from one or two confusion groups (hard-pair practice)."""
    groups = [CONFUSION_GROUPS[int(rng.integers(len(CONFUSION_GROUPS)))]]
    if rng.random() < 0.4:
        groups.append(CONFUSION_GROUPS[int(rng.integers(len(CONFUSION_GROUPS)))])
    pool = "".join(groups)
    n = int(rng.integers(3, 9))
    return "".join(rng.choice(list(pool)) for _ in range(n))


class RenderCache:
    """Pre-rendered (canonicalised, resized, not augmented) word pool: the
    TrueType render dominates a batch's cost, so training renders once."""

    def __init__(self, n_words: int, rng: np.random.Generator,
                 font_path: Optional[str] = None,
                 words: Optional[Sequence[str]] = None,
                 confusion_frac: float = 0.15):
        self.images: List[np.ndarray] = []
        self.texts: List[str] = []
        for i in range(n_words):
            if words is not None:
                text = words[i % len(words)]
            elif rng.random() < confusion_frac:
                text = confusion_word(rng)
            else:
                text = random_word(rng)
            size = int(rng.integers(24, 56))
            self.images.append(_resize_box(_canonicalize(
                render_word(text, font_size=size, font_path=font_path))))
            self.texts.append(text)


def make_batch(rng: np.random.Generator, batch_size: int, font_path: Optional[str] = None,
               words: Optional[Sequence[str]] = None, cache: Optional[RenderCache] = None,
               harsh_frac: float = 0.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Synthetic labeled batch: (images [B, 48, 256, 1], labels [B, L],
    label_paddings [B, L], texts). With a ``RenderCache`` the words come from
    its pool and only the augmentation runs per step; ``harsh_frac`` of the
    samples draw the harsh augmentation tail."""
    images = np.zeros((batch_size, IMG_H, IMG_W, 1), np.float32)
    labels = np.zeros((batch_size, MAX_LABEL), np.int32)
    paddings = np.ones((batch_size, MAX_LABEL), np.float32)
    texts = []
    for b in range(batch_size):
        if cache is not None:
            j = int(rng.integers(len(cache.texts)))
            text, img = cache.texts[j], cache.images[j]
        else:
            text = (words[int(rng.integers(len(words)))] if words
                    else random_word(rng))
            size = int(rng.integers(24, 56))
            img = _resize_box(_canonicalize(
                render_word(text, font_size=size, font_path=font_path)))
        images[b] = _standardize(_augment(
            img, rng, harsh=rng.random() < harsh_frac))[:, :, None]
        # case-sensitive labels; spaces and characters outside the charset are dropped
        ids = label_ids(text)
        labels[b, : len(ids)] = ids
        paddings[b, : len(ids)] = 0.0
        texts.append(text)
    return images, labels, paddings, texts


def label_ids(text: str) -> List[int]:
    """The CTC label of ``text``: case-sensitive class ids of its characters
    in the charset, at most ``MAX_LABEL``."""
    return [CHAR_TO_ID[c] for c in text if c in CHAR_TO_ID][:MAX_LABEL]


def to_nchw(images: np.ndarray, device=None) -> torch.Tensor:
    """[B, 48, 256, 1] numpy crops -> a float32 [B, 1, 48, 256] tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(images, np.float32).transpose(0, 3, 1, 2))).to(device)


# ------------------------------------------------------------------ training


# log(0) of an unreachable CTC state: finite, so that a logsumexp over
# unreachable states only has a gradient of 0 (with -inf it would be NaN)
_LOG_ZERO = -1e30


def ctc_losses(logits: torch.Tensor, labels: torch.Tensor,
               label_paddings: torch.Tensor) -> torch.Tensor:
    """Per-sample CTC loss of raw logits [B, T, K] against left-packed labels
    [B, L] (0-padded; ``label_paddings`` 1.0 at a pad), blank 0, every frame
    valid: ``optax.ctc_loss`` without logit paddings. Every label that fits
    the frames gives the same value; an empty label gives -log P(all blank).

    The alpha recursion in log space over the T frames, in plain PyTorch, so
    that the backward is products, sums over fixed axes and elementwise ops,
    and repeats bit for bit on the card (``F.ctc_loss``'s CUDA backward adds
    with atomics). The extended label (a blank around every character) has
    2L + 1 states; each state's log-probabilities are picked from the
    frames' by a one-hot product (``gather``'s backward would scatter-add),
    and the two final states of each sample are read through a mask.
    """
    log_probs = torch.log_softmax(logits.float(), dim=-1)                 # [B, T, K]
    b, frames, classes = log_probs.shape
    dev = log_probs.device
    lengths = (1.0 - label_paddings.float()).sum(dim=-1).round().long()  # [B]
    n_states = 2 * labels.shape[1] + 1
    ext = torch.zeros((b, n_states), dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    onehot = (ext[:, :, None] == torch.arange(classes, device=dev)).float()  # [B, S, K]
    picked = (log_probs[:, :, None, :] * onehot[:, None]).sum(dim=-1)        # [B, T, S]
    state = torch.arange(n_states, device=dev)
    # a character state may be entered from the one two back unless it repeats it
    skip = torch.zeros((b, n_states), dtype=torch.bool, device=dev)
    skip[:, 3::2] = ext[:, 3::2] != ext[:, 1:-2:2]
    log_zero = torch.tensor(_LOG_ZERO, device=dev)
    alpha = torch.where(state < 2, picked[:, 0], log_zero)
    pad1 = torch.full((b, 1), _LOG_ZERO, device=dev)
    pad2 = torch.full((b, 2), _LOG_ZERO, device=dev)
    for t in range(1, frames):
        from_prev = torch.cat([pad1, alpha[:, :-1]], dim=1)
        from_skip = torch.where(skip, torch.cat([pad2, alpha[:, :-2]], dim=1), log_zero)
        alpha = torch.logsumexp(torch.stack([alpha, from_prev, from_skip]), dim=0) + picked[:, t]
    final = (state == 2 * lengths[:, None]) | (state == 2 * lengths[:, None] - 1)
    return -torch.logsumexp(torch.where(final, alpha, log_zero), dim=1)


def cosine_decay(step: int, decay_steps: int, alpha: float) -> float:
    """``optax.cosine_decay_schedule``'s factor at ``step``."""
    frac = min(step, decay_steps) / decay_steps
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha


def make_judge_train_step(judge: OCRJudge, steps: int, lr: float = 1e-3,
                          ema_decay: float = 0.999):
    """``(step, ema)``: ``step(images, labels, paddings) -> loss`` is one Adam
    update of ``judge`` (b1 0.9, b2 0.999, eps 1e-8; the learning rate decays
    along a cosine to 0.05 of itself over ``steps``) on the batch's mean CTC
    loss, then the EMA update of ``ema``, a frozen copy of the judge; images
    are NCHW [B, 1, 48, 256]."""
    judge.requires_grad_(True)
    ema = copy.deepcopy(judge).requires_grad_(False)
    opt = torch.optim.Adam(judge.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: cosine_decay(s, steps, 0.05))

    def step(images: torch.Tensor, labels: torch.Tensor, paddings: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = ctc_losses(judge(images), labels, paddings).mean()
        loss.backward()
        opt.step()
        sched.step()
        with torch.no_grad():
            for e, p in zip(ema.parameters(), judge.parameters()):
                e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
        return loss.detach()

    return step, ema


def train_judge(steps: int = 3000, batch_size: int = 32, lr: float = 1e-3, seed: int = 0,
                font_path: Optional[str] = None, log_every: int = 200,
                words: Optional[Sequence[str]] = None, confusion_frac: float = 0.15,
                harsh_frac: float = 0.3, device="cuda") -> OCRJudge:
    """Train a judge on synthetic renders; returns its EMA copy (the frozen
    weights). ``harsh_frac`` of the samples draw the harsh augmentation tail."""
    rng = np.random.default_rng(seed)
    cache = RenderCache(6144 if words is not None else 12288, rng, font_path,
                        words=words, confusion_frac=confusion_frac)
    torch.manual_seed(seed)
    judge = OCRJudge(device=device)
    step, ema = make_judge_train_step(judge, steps, lr)
    for i in range(steps):
        images, labels, paddings, _ = make_batch(rng, batch_size, font_path, cache=cache,
                                                 harsh_frac=harsh_frac)
        loss = step(to_nchw(images, device), torch.from_numpy(labels).to(device),
                    torch.from_numpy(paddings).to(device))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"ocr-judge step {i}: ctc_loss={float(loss):.4f}", flush=True)
    return ema


# ----------------------------------------------------------------- inference


def decode_logits(logits) -> List[str]:
    """Greedy CTC decode: argmax per frame, collapse repeats, drop blanks."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    ids = np.asarray(logits).argmax(axis=-1)  # [B, T]
    out = []
    for row in ids:
        chars, prev = [], 0
        for k in row:
            if k != prev and k != 0:
                chars.append(CHARSET[k - 1])
            prev = k
        out.append("".join(chars))
    return out


def _edit_distance(a: str, b: str) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


Judges = Union[OCRJudge, Sequence[OCRJudge]]


@torch.no_grad()
def char_accuracy(regions: Sequence[np.ndarray], texts: Sequence[str], judge: Judges) -> float:
    """Mean per-sample character accuracy, 1 - editdist / len(label) floored
    at 0, of raw crops ([h, w] or [h, w, 3]) against their texts.

    Both polarities of every crop are decoded and the better one scored; per
    polarity the logits are averaged over the crop and its +-1 px vertical
    shifts (edge-padded). ``judge`` may be a list (an ensemble): each
    member's averaged logits become probabilities, and the members'
    probabilities are averaged before decoding. Runs on the judge's device.
    """
    members = list(judge) if isinstance(judge, (list, tuple)) else [judge]
    crops = np.stack([prepare_crop(r) for r in regions])

    def vshift(x, k):
        idx = np.clip(np.arange(x.shape[1]) + k, 0, x.shape[1] - 1)
        return x[:, idx]

    # horizontal shifts move every CTC frame boundary and smear the average
    variants = [crops, vshift(crops, 1), vshift(crops, -1)]
    both = np.concatenate([v * sgn for sgn in (1.0, -1.0) for v in variants])
    k = len(variants)
    n = len(regions)
    probs = None
    for m in members:
        logits = m(to_nchw(both, next(m.parameters()).device)).float().cpu().numpy()
        pos = logits[: k * n].reshape(k, n, *logits.shape[1:]).mean(axis=0)
        neg = logits[k * n:].reshape(k, n, *logits.shape[1:]).mean(axis=0)
        lg = np.concatenate([pos, neg], axis=0)
        lg = lg - lg.max(axis=-1, keepdims=True)
        p_ = np.exp(lg)
        p_ /= p_.sum(axis=-1, keepdims=True)
        probs = p_ if probs is None else probs + p_
    decoded = decode_logits(probs)
    accs = []
    for i, want in enumerate(texts):
        want_ids = "".join(c for c in want if c in CHAR_TO_ID)
        best = 0.0
        for got in (decoded[i], decoded[n + i]):
            d = _edit_distance(got, want_ids)
            best = max(best, 1.0 - d / max(len(want_ids), 1))
        accs.append(max(0.0, best))
    return float(np.mean(accs)) if accs else 0.0


# --------------------------------------------------------------- persistence

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    os.pardir, "benchmarks", "ocr_judge.npz",
)


def _flax_leaf(name: str, p: torch.Tensor) -> Tuple[str, np.ndarray]:
    """A judge parameter -> (its Flax path, the array in Flax layout)."""
    mod, leaf = name.rsplit(".", 1)
    a = p.detach().float().cpu().numpy()
    if leaf == "bias":
        return f"params/{mod}/bias", a
    layout = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[a.ndim]
    return f"params/{mod}/kernel", np.ascontiguousarray(a.transpose(layout))


def save_judge(judge: OCRJudge, path: str) -> None:
    """Write the judge as the JAX package writes it: its Flax tree, flattened
    to ``/``-joined keys, and the charset it was trained for."""
    flat = dict(_flax_leaf(n, p) for n, p in judge.named_parameters())
    flat["__charset__"] = np.array([ord(c) for c in CHARSET], np.int32)
    np.savez_compressed(path, **flat)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def load_judge(path: Optional[str] = None, device="cuda") -> OCRJudge:
    """A frozen :class:`OCRJudge` (float32) on ``device`` from a judge
    ``.npz`` (``benchmarks/ocr_judge.npz`` by default); weights trained for
    another charset are refused."""
    from reptext_tpu_torch.io.from_jax import load_jax_params

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() is "
                           "False; pass device='cpu' to load on the CPU")
    path = path or os.path.abspath(DEFAULT_WEIGHTS)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    stored = flat.pop("__charset__", None)
    if stored is not None:
        stored_charset = "".join(chr(int(c)) for c in stored)
        if stored_charset != CHARSET:
            raise ValueError(
                f"judge weights at {path} were trained for a different "
                f"charset ({len(stored_charset)} classes vs "
                f"{len(CHARSET)} current); retrain the judge")
    judge = OCRJudge(device=device, dtype=torch.float32)
    load_jax_params(judge, _unflatten(flat))
    return judge.eval().requires_grad_(False)


def load_judge_ensemble(paths: Optional[Sequence[str]] = None, device="cuda") -> List[OCRJudge]:
    """A committee of judges for scoring (``char_accuracy`` averages their
    probabilities): ``benchmarks/ocr_judge.npz`` and every sibling
    ``ocr_judge_m*.npz`` by default (none is committed, so one judge)."""
    if paths is None:
        base = os.path.abspath(DEFAULT_WEIGHTS)
        paths = [base] + sorted(
            glob.glob(os.path.join(os.path.dirname(base), "ocr_judge_m*.npz")))
    return [load_judge(p, device) for p in paths]
