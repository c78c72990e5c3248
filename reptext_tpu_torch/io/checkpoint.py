"""The port's converted-checkpoint directory (``--checkpoint-dir``).

Written by ``io/convert_cli.py``; per component one file, all optional:

- ``flux.safetensors``, ``controlnet.safetensors``,
  ``inpaint_controlnet.safetensors``, ``vae.safetensors``,
  ``clip.safetensors``, ``t5.safetensors``: the module's own ``state_dict``
  (its parameter names, torch layout, the RoPE permutation folded in), so
  loading is ``load_state_dict(..., assign=True)`` on the mapped file with no
  transposes;
- ``configs.json``: each component's geometry, in the JAX converter's format,
  so that either package reads the other's;
- ``LAYOUT_VERSION``: the parameter layout (2: the RoPE deinterleave folded
  into the q/k weights), as in ``reptext_tpu/io/checkpoint.py``;
- ``tokenizer/`` (CLIP's vocab.json, merges.txt) and
  ``tokenizer_2/spiece.model`` (T5) for the vendored tokenizers.

The JAX package stores its components as orbax directories; orbax needs JAX,
so such a directory does not load into the port: convert the original
safetensors again with ``python -m reptext_tpu_torch.io.convert_cli``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from reptext_tpu_torch.io.safetensors import load_file

COMPONENTS = ("flux", "controlnet", "inpaint_controlnet", "vae", "clip", "t5")

# Param-layout version written into every checkpoint directory: 2 = the RoPE
# deinterleave permutation folded into converted q/k kernels and qk-norm
# scales; 1 = the interleaved channel order before the fold, which loads
# cleanly but silently produces wrong attention.
LAYOUT_VERSION = 2
_LAYOUT_FILE = "LAYOUT_VERSION"


def checkpoint_layout_version(directory: str) -> int:
    """Layout version recorded in ``directory`` (1 if no marker: pre-fold)."""
    path = os.path.join(os.path.abspath(directory), _LAYOUT_FILE)
    if not os.path.isfile(path):
        return 1
    with open(path) as f:
        return int(f.read().strip())


def load_saved_configs(directory: str) -> Dict[str, Any]:
    """Rebuild config dataclasses from a converter-written ``configs.json``.

    The converter records each component's checkpoint-derived geometry
    (depths, guidance embeds, extra condition channels) so that loaders build
    the exact model the weights were trained with instead of library
    defaults. Returns {} when the directory has no configs.json; unknown
    component names (``clip_vision``: the IP-Adapter, not ported yet) and
    fields are ignored.
    """
    path = os.path.join(os.path.abspath(directory), "configs.json")
    if not os.path.isfile(path):
        return {}
    from reptext_tpu_torch.configs import (
        CLIPConfig,
        ControlNetConfig,
        FluxConfig,
        T5Config,
        VAEConfig,
    )

    classes = {
        "flux": FluxConfig,
        "controlnet": ControlNetConfig,
        "inpaint_controlnet": ControlNetConfig,
        "vae": VAEConfig,
        "clip": CLIPConfig,
        "t5": T5Config,
    }
    with open(path) as f:
        raw = json.load(f)
    out: Dict[str, Any] = {}
    for name, d in raw.items():
        cls = classes.get(name)
        if cls is None or not isinstance(d, dict):
            continue
        fields = {fld.name for fld in dataclasses.fields(cls)}
        out[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in d.items() if k in fields})
    return out


def component_path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), f"{name}.safetensors")


def load_pipeline_params(directory: str, components: Optional[tuple] = None
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{component: state dict of CPU tensors mapped from its file} for every
    component file under ``directory``.

    Refuses a directory whose recorded param layout differs from
    LAYOUT_VERSION (its q/k channels would rotate the wrong pairs), and a
    JAX orbax checkpoint (component directories where the port's files
    belong).
    """
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    orbax = [n for n in components or COMPONENTS
             if os.path.isdir(os.path.join(directory, n))
             and not os.path.isfile(component_path(directory, n))]
    if orbax:
        raise ValueError(
            f"{directory} holds {', '.join(orbax)} as directories: a JAX (orbax) checkpoint, "
            "which needs JAX to read. Convert the original safetensors for the port with "
            "python -m reptext_tpu_torch.io.convert_cli --pipeline-dir ... --out DIR")
    version = checkpoint_layout_version(directory)
    if version != LAYOUT_VERSION:
        raise ValueError(
            f"checkpoint {directory} has param layout v{version}, current is "
            f"v{LAYOUT_VERSION} (RoPE half-split permutation folded into q/k weights). "
            "Loading it would silently corrupt attention: delete it and run "
            "python -m reptext_tpu_torch.io.convert_cli on the original safetensors.")
    out = {name: load_file(component_path(directory, name))
           for name in components or COMPONENTS
           if os.path.isfile(component_path(directory, name))}
    if not out:
        raise FileNotFoundError(f"no component checkpoints under {directory}")
    return out
