"""Multi-ControlNet composition (PyTorch): summed residuals of several ControlNets.

Counterpart of ``reptext_tpu/models/multi_controlnet.py`` (reference
``FluxMultiControlNetModel``): each net runs on its own conditioning, its
residual stacks are masked by its optional token mask, gated by its
optional step-fraction window (a 0/1 multiply, as the JAX composite's), then
spread onto the base model's injection slots (the ceil-interval rule) before
the sum, so nets of different depths compose. A union entry takes its mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import inject_index


@dataclasses.dataclass(frozen=True)
class ControlNetEntry:
    """One ControlNet and its call configuration."""

    model: RepTextControlNet
    conditioning_scale: float = 1.0
    # union-mode nets take a mode index per call (reference :294-301)
    uses_mode: bool = False
    # per-net step-fraction window (diffusers control_guidance_start/end:
    # active iff i/T >= start and (i+1)/T <= end), applied when the call
    # receives step_index/num_steps
    guidance_start: float = 0.0
    guidance_end: float = 1.0


def spread_residuals(samples: torch.Tensor, num_layers: int) -> torch.Tensor:
    """[n, ...] residuals onto [num_layers, ...] injection slots
    (``samples[min(i // ceil(L / n), n - 1)]``)."""
    if samples.shape[0] == num_layers:
        return samples
    idx = torch.as_tensor(inject_index(samples.shape[0], num_layers), device=samples.device)
    return samples[idx]


class MultiControlNet:
    """Compose N ControlNets; a call returns summed, base-depth residuals."""

    def __init__(self, entries: Sequence[ControlNetEntry], base_num_layers: int,
                 base_num_single_layers: int):
        if not entries:
            raise ValueError("MultiControlNet needs at least one entry")
        self.entries = tuple(entries)
        self.base_num_layers = base_num_layers
        self.base_num_single_layers = base_num_single_layers

    def __call__(self, hidden_states: torch.Tensor, conds: Sequence[torch.Tensor],
                 encoder_hidden_states: torch.Tensor, pooled_projections: torch.Tensor,
                 timestep: torch.Tensor, img_ids: torch.Tensor, txt_ids: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None,
                 token_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
                 modes: Optional[Sequence[Optional[torch.Tensor]]] = None,
                 step_index: Optional[int] = None, num_steps: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``conds``, ``token_masks`` ([S, 1] or None) and ``modes`` per
        entry; with ``step_index``/``num_steps`` each entry's residuals are
        gated by its (guidance_start, guidance_end) window."""
        if len(conds) != len(self.entries):
            raise ValueError("conds count must match entries")
        masks = token_masks or [None] * len(self.entries)
        modes = modes or [None] * len(self.entries)
        block_sum = single_sum = None
        for entry, cond, mask, mode in zip(self.entries, conds, masks, modes):
            kw = {"mode": mode} if entry.uses_mode else {}
            block, single = entry.model(hidden_states, cond, encoder_hidden_states,
                                        pooled_projections, timestep, img_ids, txt_ids,
                                        guidance, entry.conditioning_scale, **kw)
            if mask is not None:
                block = block * mask.to(block.dtype)
                single = single * mask.to(single.dtype)
            if step_index is not None and num_steps is not None and (
                    entry.guidance_start > 0.0 or entry.guidance_end < 1.0):
                keep = float(step_index / num_steps >= entry.guidance_start
                             and (step_index + 1) / num_steps <= entry.guidance_end)
                block = block * torch.tensor(keep, dtype=block.dtype, device=block.device)
                single = single * torch.tensor(keep, dtype=single.dtype, device=single.device)
            block = spread_residuals(block, self.base_num_layers)
            single = spread_residuals(single, self.base_num_single_layers)
            block_sum = block if block_sum is None else block_sum + block
            single_sum = single if single_sum is None else single_sum + single
        return block_sum, single_sum
