"""A cell at the port's tiny test geometry, on the CPU in float32: the
harness driven end to end without a chip (the benchmark's own tests)."""

from __future__ import annotations

import copy
import os

import numpy as np

from portbench import manifest

FLUX = {"num_layers": 2, "num_single_layers": 4, "attention_head_dim": 32,
        "num_attention_heads": 4, "joint_attention_dim": 32, "pooled_projection_dim": 32,
        "axes_dims_rope": [8, 12, 12], "time_embed_dim": 32}
CN = dict(FLUX, num_layers=1, num_single_layers=2)
VAE = {"block_out_channels": [8, 16, 16, 16], "layers_per_block": 1, "norm_num_groups": 4}
CLIP = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 64, "num_layers": 2,
        "num_heads": 2, "max_position_embeddings": 16, "eos_token_id": 255}
T5 = {"vocab_size": 256, "d_model": 32, "d_kv": 8, "d_ff": 64, "num_layers": 2, "num_heads": 4}


def conditions(rng, h: int, w: int) -> dict:
    """One text line's arrays: a box of ink, its edges, the position and region masks."""
    glyph = np.zeros((h, w, 3), np.uint8)
    glyph[h // 3:h // 2, w // 4:3 * w // 4] = 255
    canny = np.zeros((h, w, 3), np.uint8)
    canny[h // 3, w // 4:3 * w // 4] = canny[h // 2, w // 4:3 * w // 4] = 255
    pos = np.zeros((h, w), np.uint8)
    pos[h // 3 - 2:h // 2 + 2, w // 4 - 2:3 * w // 4 + 2] = 255
    canny = np.maximum(canny, (rng.random((h, w, 1)) > 0.97).astype(np.uint8) * 255)
    return {"canny_image": canny, "position_mask": pos, "region_mask": pos.copy(),
            "glyph_canvas": glyph}


def write_data(path: str, names, h: int = 64, w: int = 64) -> None:
    rng = np.random.default_rng(0)
    arrays = {}
    for name in names:
        for k, v in conditions(rng, h, w).items():
            arrays[f"{name}.{k}"] = v
        arrays[f"{name}.text"] = np.asarray("Hello" if name != "arabic" else "مرحبا")
        arrays[f"{name}.position"] = np.asarray([w // 4, h // 3], np.int32)
    np.savez(path, **arrays)


def spec(cell: str, data_dir: str, steps: int = 2) -> dict:
    """The cell's spec from the manifest with the tiny geometry in float32,
    its data written under ``data_dir``."""
    s = copy.deepcopy(manifest.resolve(cell))
    cfg = s["config"]
    cfg["dtype"] = "float32"
    cfg["reference"] = dict(cfg["reference"], matmul="fp32")
    cfg["pipeline"]["max_sequence_length"] = 32
    for group, tiny in (("flux", FLUX), ("controlnet", CN), ("vae", VAE), ("clip", CLIP),
                        ("t5", T5)):
        cfg[group].update(tiny)
    mix = s["traffic"]
    mix.update(steps=steps, controlnet_steps=steps, warmup_steps=1)
    names = sorted(set(mix["requests"]))
    write_data(os.path.join(data_dir, mix["data"]), names)
    return s
