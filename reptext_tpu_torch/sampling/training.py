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


def make_train_step(flux: FluxTransformer2D, optimizer: torch.optim.Optimizer,
                    mesh=None) -> Callable:
    """Returns ``step(batch, generator) -> loss``: one update of ``optimizer``
    (over the transformer's parameters) in place; ``loss`` is detached.
    Under a (dp, tp) ``mesh`` ``flux`` is the rank's trainable tensor-parallel
    copy and ``batch`` the whole batch: t and the noise are drawn for it, the
    rank takes its rows, and its mean (equal rows a rank) is 1/dp of the
    whole batch's, so the partial gradients and losses are summed over dp
    (the JAX step leaves the shardings to the call site)."""
    from reptext_tpu_torch.parallel.partition import all_reduce_grads, shard_batch
    from reptext_tpu_torch.sampling.train_controlnet import draw_t_noise

    def step(batch: Batch, generator: Optional[torch.Generator]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if mesh is None or mesh.dp == 1:
            loss = flow_match_loss(flux, batch, generator)
            loss.backward()
        else:
            dp = mesh.dp_group
            t, noise = draw_t_noise(batch["x0"].float(), generator)
            loss = flow_match_loss(flux, shard_batch(batch, mesh), t=dp.shard(t, 0),
                                   noise=dp.shard(noise, 0)) / mesh.dp
            loss.backward()
            all_reduce_grads([p for g in optimizer.param_groups for p in g["params"]], dp)
            loss = dp.all_reduce_sum(loss)
        optimizer.step()
        return loss.detach()

    return step
