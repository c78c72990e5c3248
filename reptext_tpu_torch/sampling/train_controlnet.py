"""ControlNet training recipe: frozen base FLUX, trainable RepText ControlNet (PyTorch).

Counterpart of ``reptext_tpu/sampling/train_controlnet.py``:

- :func:`controlnet_flow_match_loss`: rectified-flow velocity MSE through the
  frozen base with ControlNet residual injection, the residuals multiplied by
  the per-token text-region mask as the sampler does, and the velocity error
  weighted ``1 + text_loss_weight * mask`` (normalised, so a weight of 0 is
  the plain mean);
- the OCR text-perceptual term (``perceptual``): x0 = x_t - t * v from the
  predicted velocity, the frozen VAE decoder with gradients, a crop at the
  known text box, the frozen OCR judge and CTC against the known label,
  ramped by (1 - t) per sample (``sampling/ocr_loss.py``);
- :func:`make_controlnet_train_step`: gradients w.r.t. the ControlNet's
  parameters only; the base is an argument of the step and never enters the
  optimizer; :func:`bind_frozen_base` binds it, and the perceptual term's
  frozen VAE and judge, for ``ElasticTrainer``;
- :func:`make_joint_train_step`: one optimizer over the base and the
  ControlNet (full fine-tuning);
- :func:`init_controlnet_training`: warm start (``params_from_transformer``)
  and AdamW with weight decay on the Linear weights (the Flax ``kernel``
  leaves) only.

Modules and the optimizer are updated in place (PyTorch idiom) where the JAX
step returns new trees. A frozen module (the base in the ControlNet step, the
VAE and the judge in both) must hold no parameter that requires a gradient:
the steps raise otherwise.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from reptext_tpu_torch.io.from_jax import flax_leaf_kinds
from reptext_tpu_torch.models.controlnet import RepTextControlNet, params_from_transformer
from reptext_tpu_torch.models.flux import FluxTransformer2D

Batch = Dict[str, Optional[torch.Tensor]]


def controlnet_flow_match_loss(flux: FluxTransformer2D, controlnet: RepTextControlNet,
                               batch: Batch, generator: Optional[torch.Generator] = None,
                               t: Optional[torch.Tensor] = None,
                               noise: Optional[torch.Tensor] = None,
                               text_loss_weight: float = 2.0,
                               conditioning_scale: float = 1.0,
                               perceptual: Optional[dict] = None,
                               control_mode: Optional[int] = None) -> torch.Tensor:
    """Region-weighted conditional flow-matching MSE with ControlNet injection.

    batch: ``x0`` [B, S, C] packed clean latents, ``cond_tokens`` [B, S, F],
    ``token_mask`` [B, S, 1], ``prompt_embeds`` [B, S_txt, D_joint],
    ``pooled`` [B, D_pool], ``img_ids`` [S, 3], ``txt_ids`` [S_txt, 3],
    ``guidance`` [B] or None. ``t`` [B] and ``noise`` (like x0) are drawn from
    ``generator`` unless both are given (the parity tests pass JAX's draws).

    ``perceptual`` adds the OCR text-perceptual term: a dict ``{"decode":
    fn(x0_packed) -> images [B, 3, H, W], "judge": OCRJudge, "weight":
    float}`` (``decode`` is the pipeline's differentiable
    :meth:`~reptext_tpu_torch.pipelines.txt2img.FluxRepTextPipeline.decode_images`);
    the batch then carries ``ocr_boxes`` [B, 4], ``ocr_labels`` [B, L] and
    ``ocr_paddings`` [B, L] (``data.py`` makes them). A weight of 0 leaves
    the term out.
    """
    x0 = batch["x0"].float()
    if t is None or noise is None:
        # logit-normal timesteps (the SD3/FLUX recipe) and Gaussian noise
        t = torch.sigmoid(torch.randn((x0.shape[0],), generator=generator, device=x0.device))
        noise = torch.randn(x0.shape, generator=generator, device=x0.device)
    t, noise = t.to(x0.device, torch.float32), noise.to(x0.device, torch.float32)
    t_b = t[:, None, None]
    x_t = (1.0 - t_b) * x0 + t_b * noise
    target = noise - x0
    mask = batch["token_mask"].float()

    mode_kw = {}
    if controlnet.config.union:
        # a union net trains on one conditioning type, as it samples (the JAX
        # CLI's cn_apply)
        if control_mode is None:
            raise ValueError("training a union-mode ControlNet requires a control mode")
        mode_kw["mode"] = torch.full((x0.shape[0],), control_mode, dtype=torch.long,
                                     device=x0.device)
    block_res, single_res = controlnet(
        x_t, batch["cond_tokens"], batch["prompt_embeds"], batch["pooled"], t,
        batch["img_ids"], batch["txt_ids"], batch.get("guidance"), conditioning_scale,
        **mode_kw)
    # regional masking exactly as the sampler applies it ([L, B, S, D] stacks)
    block_res = block_res * mask[None].to(block_res.dtype)
    single_res = single_res * mask[None].to(single_res.dtype)
    pred = flux(x_t, batch["prompt_embeds"], batch["pooled"], t, batch["img_ids"],
                batch["txt_ids"], batch.get("guidance"),
                controlnet_block_samples=block_res,
                controlnet_single_block_samples=single_res)

    err = (pred.float() - target) ** 2
    w = 1.0 + text_loss_weight * mask
    loss = (err * w).sum() / (w.sum() * x0.shape[-1])
    if perceptual is not None and perceptual.get("weight", 0.0) > 0.0:
        loss = loss + perceptual["weight"] * perceptual_term(perceptual, batch, x_t, t, pred)
    return loss


def perceptual_term(perceptual: dict, batch: Batch, x_t: torch.Tensor, t: torch.Tensor,
                    pred: torch.Tensor) -> torch.Tensor:
    """The OCR term of one step, unweighted: CTC of the judge on the decode of
    x0 = x_t - t * v at the batch's boxes, each sample ramped by (1 - t)."""
    from reptext_tpu_torch.sampling.ocr_loss import ocr_ctc_loss

    x0_pred = x_t - t[:, None, None] * pred.float()
    images = perceptual["decode"](x0_pred)
    return ocr_ctc_loss(images, batch["ocr_boxes"], batch["ocr_labels"],
                        batch["ocr_paddings"], perceptual["judge"], sample_weights=1.0 - t)


def check_frozen(modules: Iterable[Optional[torch.nn.Module]], what: str = "module"):
    """Raise if a frozen module holds a parameter that requires a gradient."""
    for m in modules:
        if m is not None and any(p.requires_grad for p in m.parameters()):
            raise ValueError(f"the {what} {type(m).__name__} must be frozen "
                             "(requires_grad_(False))")


def make_controlnet_train_step(controlnet: RepTextControlNet, optimizer: torch.optim.Optimizer,
                               text_loss_weight: float = 2.0, conditioning_scale: float = 1.0,
                               perceptual: Optional[dict] = None,
                               control_mode: Optional[int] = None) -> Callable:
    """Returns ``step(flux, batch, generator, *frozen) -> loss``: one optimizer
    update of the ControlNet, in place; ``loss`` is the detached scalar.

    The frozen base is an argument, not a closure, as in the JAX step;
    ``frozen`` are the other frozen modules the step runs through (the
    perceptual term's VAE and judge, as the JAX step's trailing trees). None
    of them, nor ``perceptual["judge"]``, may hold a parameter that requires
    a gradient: the step raises otherwise, so they can never receive
    gradients or enter the optimizer. ``control_mode``: the mode of a union
    ControlNet (required by one).
    """

    def step(flux: FluxTransformer2D, batch: Batch, generator: Optional[torch.Generator],
             *frozen: torch.nn.Module) -> torch.Tensor:
        check_frozen([flux], "base transformer")
        check_frozen([*frozen, (perceptual or {}).get("judge")])
        return _update(optimizer, flux, controlnet, batch, generator, text_loss_weight,
                       conditioning_scale, perceptual, control_mode)

    return step


def make_joint_train_step(flux: FluxTransformer2D, controlnet: RepTextControlNet,
                          optimizer: torch.optim.Optimizer, text_loss_weight: float = 2.0,
                          conditioning_scale: float = 1.0,
                          perceptual: Optional[dict] = None,
                          control_mode: Optional[int] = None) -> Callable:
    """Full-model training: the same region-weighted loss with gradients
    through both the base and the ControlNet, one ``optimizer`` over both.
    Returns ``step(batch, generator, *frozen) -> loss`` (the ElasticTrainer
    signature when nothing else is frozen); ``frozen`` and
    ``perceptual["judge"]`` are checked as in the ControlNet step."""

    def step(batch: Batch, generator: Optional[torch.Generator],
             *frozen: torch.nn.Module) -> torch.Tensor:
        check_frozen([*frozen, (perceptual or {}).get("judge")])
        return _update(optimizer, flux, controlnet, batch, generator, text_loss_weight,
                       conditioning_scale, perceptual, control_mode)

    return step


def loss_and_backward(flux: FluxTransformer2D, controlnet: RepTextControlNet, batch: Batch,
                      generator: Optional[torch.Generator] = None, **loss_kw) -> torch.Tensor:
    """:func:`controlnet_flow_match_loss` of ``batch`` (``loss_kw`` are its
    keywords) and its backward into the parameters' ``.grad``; returns the
    detached loss. With the OCR term on, both run under
    ``ocr_loss.deterministic_convolutions``, so the step repeats bit for bit
    on the card."""
    from reptext_tpu_torch.sampling.ocr_loss import deterministic_convolutions

    perceptual = loss_kw.get("perceptual")
    ocr = perceptual is not None and perceptual.get("weight", 0.0) > 0.0
    with deterministic_convolutions() if ocr else contextlib.nullcontext():
        loss = controlnet_flow_match_loss(flux, controlnet, batch, generator, **loss_kw)
        loss.backward()
    return loss.detach()


def _update(optimizer, flux, controlnet, batch, generator, text_loss_weight,
            conditioning_scale, perceptual, control_mode) -> torch.Tensor:
    """One optimizer update on the loss of ``batch``; returns the detached loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_and_backward(flux, controlnet, batch, generator,
                             text_loss_weight=text_loss_weight,
                             conditioning_scale=conditioning_scale,
                             perceptual=perceptual, control_mode=control_mode)
    optimizer.step()
    return loss


def bind_frozen_base(step: Callable, flux: FluxTransformer2D, *frozen: torch.nn.Module
                     ) -> Callable:
    """Adapt a ControlNet train step to the ElasticTrainer signature
    ``(batch, generator) -> loss``; ``frozen`` (the perceptual term's VAE and
    judge) are passed after the generator, as the JAX step's trailing trees."""

    @functools.wraps(step)
    def bound(batch: Batch, generator: Optional[torch.Generator]) -> torch.Tensor:
        return step(flux, batch, generator, *frozen)

    return bound


def decay_param_groups(controlnet: torch.nn.Module, weight_decay: float) -> list:
    """AdamW parameter groups: ``weight_decay`` on the Flax ``kernel`` leaves
    (Linear weights), none on norm scales and biases (the JAX decay mask)."""
    kinds = flax_leaf_kinds(controlnet)
    params = dict(controlnet.named_parameters())
    decay = [p for n, p in params.items() if kinds[n] == "kernel"]
    rest = [p for n, p in params.items() if kinds[n] != "kernel"]
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": rest, "weight_decay": 0.0}]


def init_controlnet_training(flux: FluxTransformer2D, controlnet: RepTextControlNet,
                             num_layers: int, num_single_layers: int,
                             optimizer: Optional[torch.optim.Optimizer] = None,
                             learning_rate: float = 1e-5, weight_decay: float = 0.0
                             ) -> Tuple[RepTextControlNet, torch.optim.Optimizer]:
    """Warm-start ``controlnet`` from ``flux`` in place, make it trainable,
    freeze the base, and build AdamW (b1 0.9, b2 0.999, eps 1e-8).

    ``weight_decay == 0`` means no decay at all. This departs from the JAX
    package, whose ``optax.adamw(learning_rate)`` then applies optax's default
    weight decay of 1e-4 to every leaf, norm scales and biases included. Adam's
    moments are kept in the parameters' dtype, as optax keeps them.
    """
    params_from_transformer(flux, controlnet, num_layers, num_single_layers)
    flux.requires_grad_(False)
    controlnet.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.AdamW(decay_param_groups(controlnet, weight_decay),
                                      lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return controlnet, optimizer
