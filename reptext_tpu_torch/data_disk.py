"""On-disk image/text corpus loader for ControlNet training (PyTorch).

Counterpart of ``reptext_tpu/data_disk.py``: the batch contract of
``GlyphTextDataset`` (so ``PrefetchLoader``, ``ElasticTrainer`` and the OCR
perceptual term work unchanged), with the corpus photo as the training
target instead of a synthetic composite.

Corpus layout (one directory):

    corpus/
      annotations.jsonl      one JSON record per line:
        {"image": "imgs/0001.jpg",            # path relative to corpus dir
         "prompt": "a neon sign on a night street",
         "lines": [{"text": "قهوة", "position": [320, 400],
                    "font_size": 96, "color": [255, 40, 40]}, ...]}
      imgs/...               referenced images (PNG/JPEG, any size,
                             resized to the training resolution)

Semantics, as in the JAX package:

- step-indexed determinism: sample k of the global stream is record
  ``perm_epoch[k mod n]``, ``perm_epoch`` a permutation drawn from
  ``random.Random((seed << 20) ^ epoch)``, so a batch depends on (seed, step)
  alone and a rollback replays it;
- one line per visit: a multi-line record gives one line per epoch visit,
  drawn from (seed, epoch, offset);
- data-parallel sharding: ``shard=(index, count)`` interleaves the records
  before the epoch permutation;
- annotation coordinates and font sizes are in the source image's pixels and
  are rescaled to the training size (the image's size is read from its
  header alone); images are resized with PIL's bilinear filter and the last
  64 are cached.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from reptext_tpu_torch.data import GlyphTextDataset

_DEFAULT_COLOR = (255, 255, 255)


def load_annotations(corpus_dir: str) -> list:
    """Read and validate annotations.jsonl; returns the record list."""
    path = os.path.join(corpus_dir, "annotations.jsonl")
    records = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "image" not in rec or "lines" not in rec or not rec["lines"]:
                raise ValueError(f"{path}:{ln}: record needs 'image' and non-empty 'lines'")
            for entry in rec["lines"]:
                if "text" not in entry or "position" not in entry:
                    raise ValueError(f"{path}:{ln}: line needs 'text' and 'position'")
            records.append(rec)
    if not records:
        raise ValueError(f"{path}: empty corpus")
    return records


class DiskImageTextDataset(GlyphTextDataset):
    """Step-indexed training batches from an annotated photo corpus; the same
    contract as ``GlyphTextDataset.batch``."""

    def __init__(self, pipeline, corpus_dir: str, batch_size: int = 2, tokenize=None,
                 font_path: Optional[str] = None, seed: int = 0,
                 shard: Tuple[int, int] = (0, 1)):
        super().__init__(pipeline, batch_size=batch_size, tokenize=tokenize,
                         font_path=font_path, seed=seed)
        self.corpus_dir = os.path.abspath(corpus_dir)
        index, count = shard
        if not (0 <= index < count):
            raise ValueError(f"bad shard {shard}")
        records = load_annotations(self.corpus_dir)
        self.records = records[index::count]
        if not self.records:
            raise ValueError(f"shard {index}/{count} of {len(records)} records is empty")
        self._image_cache: Dict[str, np.ndarray] = {}
        self._cache_limit = 64
        self._perm_cache: Dict[int, list] = {}
        self._size_cache: Dict[str, Tuple[int, int]] = {}

    # ------------------------------------------------------------ indexing

    def _epoch_perm(self, epoch: int) -> Sequence[int]:
        # the current epoch's permutation and the one before it are kept: a
        # batch may straddle an epoch boundary
        if epoch not in self._perm_cache:
            order = list(range(len(self.records)))
            random.Random((self.seed << 20) ^ epoch).shuffle(order)
            self._perm_cache = {k: v for k, v in self._perm_cache.items() if k >= epoch - 1}
            self._perm_cache[epoch] = order
        return self._perm_cache[epoch]

    def _image_size(self, path: str) -> Tuple[int, int]:
        """(width, height) of the source image, from its header, memoized."""
        if path not in self._size_cache:
            from PIL import Image

            with Image.open(path) as im:
                self._size_cache[path] = im.size
        return self._size_cache[path]

    def sample_spec(self, step: int, index: int) -> Dict:
        k = step * self.batch_size + index
        n = len(self.records)
        epoch, offset = divmod(k, n)
        rec = self.records[self._epoch_perm(epoch)[offset]]
        lines = rec["lines"]
        pick = random.Random((self.seed << 28) ^ (epoch << 8) ^ (offset & 0xFF)
                             ).randrange(len(lines))
        entry = lines[pick]
        cfg = self.pipe.pipe_cfg
        path = os.path.join(self.corpus_dir, rec["image"])
        # positions and font sizes rescale with the image, or the conditions,
        # the target and the OCR box point at another region of the photo
        src_w, src_h = self._image_size(path)
        sx, sy = cfg.width / src_w, cfg.height / src_h
        x, y = entry["position"]
        default_fs = max(16, int(src_h / 8))
        return {
            "text": entry["text"],
            "position": (int(round(x * sx)), int(round(y * sy))),
            "font_size": max(8, int(round(float(entry.get("font_size", default_fs))
                                          * (sx + sy) / 2.0))),
            "color": tuple(entry.get("color", _DEFAULT_COLOR)),
            "prompt": rec.get("prompt", ""),
            "image_path": path,
        }

    # ------------------------------------------------------------- images

    def _load_image(self, path: str) -> np.ndarray:
        cached = self._image_cache.get(path)
        if cached is not None:
            return cached
        from PIL import Image

        cfg = self.pipe.pipe_cfg
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB").resize((cfg.width, cfg.height), Image.BILINEAR),
                             np.uint8)
        if len(self._image_cache) >= self._cache_limit:
            self._image_cache.pop(next(iter(self._image_cache)))
        self._image_cache[path] = img
        return img

    def _target_image(self, conds, spec: Dict) -> np.ndarray:
        return self._load_image(spec["image_path"])
