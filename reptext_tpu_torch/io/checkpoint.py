"""The port's converted-checkpoint directory (``--checkpoint-dir``).

Written by ``io/convert_cli.py``; per component one file, all optional:

- ``flux.safetensors``, ``controlnet.safetensors``,
  ``inpaint_controlnet.safetensors``, ``vae.safetensors``,
  ``clip.safetensors``, ``t5.safetensors``: the module's own ``state_dict``
  (its parameter names, torch layout, the RoPE permutation folded in), so
  loading is ``load_state_dict(..., assign=True)`` on the mapped file with no
  transposes; written with ``--dtype fp8``, FLUX's and the ControlNets' files
  hold their block stacks' ``kernel_q8``/``kernel_scale`` pairs
  (``io/quantize.py``), and ``pipelines/txt2img.py::build_module`` then builds
  the module with ``weight_quant`` before taking the state over;
- ``configs.json``: each component's geometry, in the JAX converter's format,
  so that either package reads the other's;
- ``LAYOUT_VERSION``: the parameter layout (2: the RoPE deinterleave folded
  into the q/k weights), as in ``reptext_tpu/io/checkpoint.py``;
- ``tokenizer/`` (CLIP's vocab.json, merges.txt) and
  ``tokenizer_2/spiece.model`` (T5) for the vendored tokenizers;
- ``ip_adapter/`` (``convert_cli --ip-adapter``): ``proj``, ``blocks`` and
  ``vision.safetensors`` with their own ``configs.json`` and
  ``LAYOUT_VERSION``, the directory that ``--ip-adapter-dir`` names.

:func:`convert_and_cache` converts HF safetensors components into such a
directory from Python, as ``convert_cli`` does from the command line (the
counterpart of ``reptext_tpu/io/checkpoint.py::convert_and_cache``, which
caches them as orbax). :func:`save_pipeline_params` writes trained modules in this layout (the
component files and ``LAYOUT_VERSION``), in their own dtypes (fp32 stays
fp32), as ``reptext_tpu/io/checkpoint.py::save_pipeline_params`` does for the
JAX package (``examples/overfit_e2e.py --params-cache``).

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

from reptext_tpu_torch.io.safetensors import load_file, save_file

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
    defaults (``clip_vision`` and ``ip_adapter``: the IP-Adapter directory's).
    Returns {} when the directory has no configs.json; unknown component
    names and fields are ignored.
    """
    path = os.path.join(os.path.abspath(directory), "configs.json")
    if not os.path.isfile(path):
        return {}
    from reptext_tpu_torch.configs import (
        CLIPConfig,
        CLIPVisionConfig,
        ControlNetConfig,
        FluxConfig,
        IPAdapterConfig,
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
        "clip_vision": CLIPVisionConfig,
        "ip_adapter": IPAdapterConfig,
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


def save_pipeline_params(params: Dict[str, Any], directory: str) -> None:
    """Save each component, a module or its state dict, as
    ``directory/<component>.safetensors`` (from any device, dtypes kept), and
    the layout version: the directory
    :func:`load_pipeline_params` reads and ``build_module`` takes over."""
    os.makedirs(directory, exist_ok=True)
    for name, state in params.items():
        if isinstance(state, torch.nn.Module):
            state = state.state_dict()
        save_file({k: v.detach() for k, v in state.items()}, component_path(directory, name))
    with open(os.path.join(os.path.abspath(directory), _LAYOUT_FILE), "w") as f:
        f.write(f"{LAYOUT_VERSION}\n")


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


def convert_and_cache(hf_dirs: Dict[str, str], configs: Dict[str, Any],
                      cache_dir: str) -> Dict[str, Any]:
    """Convert HF safetensors checkpoints and write them as the port's
    checkpoint directory: ``cache_dir/<component>.safetensors`` (the module
    state, as ``convert_cli`` writes it, in the files' dtypes read as fp32),
    ``configs.json`` with each component's geometry and ``LAYOUT_VERSION``;
    ``--checkpoint-dir`` and :func:`load_pipeline_params` read it back.

    ``hf_dirs`` maps a component name (``COMPONENTS``) to a safetensors file
    or shard directory, ``configs`` the same name to its config dataclass.
    Returns the converted trees ({component: Flax-named tree of tensors}), as
    the JAX function returns its converters' trees."""
    from reptext_tpu_torch.io import convert as C
    from reptext_tpu_torch.io.convert_cli import module_state

    converters = {
        "flux": C.convert_flux_transformer,
        "controlnet": C.convert_controlnet,
        "inpaint_controlnet": C.convert_controlnet,
        "vae": C.convert_vae,
        "clip": C.convert_clip,
        "t5": C.convert_t5,
    }
    params = {}
    for name, path in hf_dirs.items():
        params[name] = converters[name](C.load_safetensors_state(path), configs[name])
        save_pipeline_params({name: module_state(name, params[name], configs[name])}, cache_dir)
    saved_path = os.path.join(os.path.abspath(cache_dir), "configs.json")
    saved = {}
    if os.path.isfile(saved_path):
        with open(saved_path) as f:
            saved = json.load(f)
    saved.update({name: dataclasses.asdict(configs[name]) for name in hf_dirs})
    with open(saved_path, "w") as f:
        json.dump(saved, f, indent=1, sort_keys=True)
    return params
