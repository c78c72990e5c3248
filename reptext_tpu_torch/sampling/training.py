"""Flow-matching training of the base transformer alone (PyTorch).

Counterpart of ``reptext_tpu/sampling/training.py``: the conditional
rectified-flow objective FLUX is trained with (velocity target u = noise - x0
at x_t = (1 - t) x0 + t noise, logit-normal t) and one optimizer step over
the transformer's parameters. The ControlNet recipe is
``sampling/train_controlnet.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from reptext_tpu_torch.models.flux import FluxTransformer2D

Batch = Dict[str, Optional[torch.Tensor]]


def flow_match_loss(flux: FluxTransformer2D, batch: Batch,
                    generator: Optional[torch.Generator] = None,
                    t: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conditional flow-matching MSE.

    batch: ``x0`` (packed clean latents [B, S, C]), ``prompt_embeds``,
    ``pooled``, ``txt_ids``, ``img_ids``, ``guidance`` (or None). ``t`` [B]
    and ``noise`` are drawn from ``generator`` unless both are given.
    """
    x0 = batch["x0"].float()
    if t is None or noise is None:
        t = torch.sigmoid(torch.randn((x0.shape[0],), generator=generator, device=x0.device))
        noise = torch.randn(x0.shape, generator=generator, device=x0.device)
    t, noise = t.to(x0.device, torch.float32), noise.to(x0.device, torch.float32)
    t_b = t[:, None, None]
    x_t = (1.0 - t_b) * x0 + t_b * noise
    target = noise - x0
    pred = flux(x_t, batch["prompt_embeds"], batch["pooled"], t, batch["img_ids"],
                batch["txt_ids"], batch.get("guidance"))
    return ((pred.float() - target) ** 2).mean()


def make_train_step(flux: FluxTransformer2D, optimizer: torch.optim.Optimizer) -> Callable:
    """Returns ``step(batch, generator) -> loss``: one update of ``optimizer``
    (over the transformer's parameters) in place; ``loss`` is detached."""

    def step(batch: Batch, generator: Optional[torch.Generator]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = flow_match_loss(flux, batch, generator)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
