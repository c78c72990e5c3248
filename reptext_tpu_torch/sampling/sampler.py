"""RepText txt2img denoising loop (PyTorch).

Counterpart of ``reptext_tpu/sampling/sampler.py::make_txt2img_sampler``. The
JAX ``lax.scan`` becomes a Python loop over the FlowMatch Euler steps; each
step:

- runs the ControlNet on the text lines stacked on the batch axis
  (line-major: line j, image i at index j * B + i), only on steps where
  :func:`cn_active_mask` allows it (the step gate intersected with the
  ``control_guidance_start/end`` window); gated-off steps skip it entirely;
- multiplies each line's residuals by its regional token mask and sums over
  lines;
- runs the FLUX base with the residuals injected index-on-read (and the
  IP-Adapter's image-prompt tokens, ``flux_extra``, when given);
- advances the float32 latents by one Euler update.

Under a request's span recorder (``utils/profiling.py``; the pipelines'
``timings=``) each step is a ``step`` span holding a ``controlnet`` span and a
``flux`` span; otherwise the loop reads the recorder once per call and pays
one ``is None`` check per step and per model call.

``sample(..., start_step, num_steps)`` runs a chunk of the schedule, the JAX
``sample.chunked``: img2img starts past step 0, and a callback runs between
chunks. The ControlNet gate reads the absolute step; the velocity cache's
registers start empty in every chunk and its first step always runs, as the
JAX scan's ``local == 0`` forces it.

A union ControlNet (``config.num_mode`` set) gets ``PipelineConfig.control_mode``
as its mode on every row (the JAX pipelines' ``cn_apply``); without one the
sampler raises, as they do.

The timestep is built in the compute dtype, so it is rounded to bf16 before
the embedding, as in the JAX sampler. The velocity cache
(``PipelineConfig.velocity_cache_*``) is :func:`velocity_cache_select`, shared
with the inpaint sampler: a skipped step runs no model and reuses or
extrapolates the last computed velocities. In the adaptive modes the drift
ratio is read on the host, one device sync per step, where the JAX scan
decides inside the graph.

:func:`make_sp_txt2img_sampler` is the sequence-parallel loop: the counterpart
of the JAX ``shard_map`` over the whole scan, every rank running the loop on
its token shard; the attention exchange inside the blocks is the only
communication per step, besides the adaptive cache's mean over the group.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from reptext_tpu_torch.configs import PipelineConfig
from reptext_tpu_torch.parallel.group import SPGroup
from reptext_tpu_torch.parallel.sequence import JOINT_SP_ATTENTION, sp_context
from reptext_tpu_torch.sampling.flow_match import FlowMatchSchedule
from reptext_tpu_torch.utils.profiling import active_recorder, span


def controlnet_mode(controlnet: torch.nn.Module, pipe_cfg: PipelineConfig, batch: int,
                    device) -> dict:
    """The ControlNet's ``mode`` keyword for a batch of ``batch`` rows: empty
    for a net that is not union; for a union net ``control_mode`` on every
    row, which must be set."""
    if not getattr(getattr(controlnet, "config", None), "union", False):
        return {}
    if pipe_cfg.control_mode is None:
        raise ValueError("union-mode ControlNet loaded; set PipelineConfig.control_mode "
                         "(CLI: --controlnet-mode)")
    return {"mode": torch.full((batch,), pipe_cfg.control_mode, dtype=torch.long, device=device)}


def cn_active_mask(pipe_cfg: PipelineConfig, num_steps: int, gate_step: int) -> List[bool]:
    """Per-step ControlNet on/off: i < gate_step and i/T >= start and (i+1)/T <= end."""
    idx = np.arange(num_steps)
    keep = ((idx / num_steps >= pipe_cfg.control_guidance_start)
            & ((idx + 1) / num_steps <= pipe_cfg.control_guidance_end))
    return [bool(x) for x in (idx < gate_step) & keep]


def velocity_cache_settings(pipe_cfg: PipelineConfig) -> dict:
    """The cache's keyword settings, read as the JAX samplers read them, and
    ``enabled`` (an interval above 1 or an adaptive mode)."""
    mode = pipe_cfg.velocity_cache_mode
    if mode not in ("reuse", "linear", "adaptive", "adaptive-linear"):
        raise ValueError(f"unknown velocity cache mode {mode!r} "
                         "(reuse|linear|adaptive|adaptive-linear)")
    kw = dict(vc_adaptive=mode in ("adaptive", "adaptive-linear"),
              vc_linear=mode in ("linear", "adaptive-linear"),
              vc_warmup=max(pipe_cfg.velocity_cache_warmup, 1),
              vc_interval=max(pipe_cfg.velocity_cache_interval, 1),
              vc_threshold=float(pipe_cfg.velocity_cache_threshold),
              vc_max_skip=max(int(pipe_cfg.velocity_cache_max_skip), 1))
    return dict(kw, enabled=kw["vc_interval"] > 1 or kw["vc_adaptive"])


# (v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips): the last two computed
# velocities (None before the first), the float32 sigmas they were computed
# at (0.0 before), the latents at the last computed step, consecutive skips
CacheRegs = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], np.float32, np.float32,
                  Optional[torch.Tensor], int]


def empty_cache_regs() -> CacheRegs:
    return None, None, np.float32(0.0), np.float32(0.0), None, 0


def velocity_cache_select(compute_fn: Callable[[], torch.Tensor], regs: CacheRegs,
                          lat: torch.Tensor, sig_i: np.float32, i: int, always: bool, *,
                          vc_adaptive: bool, vc_linear: bool, vc_warmup: int, vc_interval: int,
                          vc_threshold: float, vc_max_skip: int,
                          signal_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                          decide: Optional[Callable[[Callable[[], bool]], bool]] = None
                          ) -> Tuple[torch.Tensor, CacheRegs]:
    """Twin of ``_velocity_cache_select``: run ``compute_fn`` or skip it.

    Adaptive: run while the latents' relative L1 drift since the last
    computed step (max over the batch) reaches ``vc_threshold``, or after
    ``vc_max_skip`` skips; else every ``vc_interval``-th step after warmup.
    ``always`` forces a run. ``signal_mean`` (an SP group's mean) turns the
    shard's per-image drift and reference means into the global ones before
    the host decides, so every rank takes the same branch, as the JAX
    sampler's ``pmean`` does. ``decide`` (``decide_on_rank0`` over a mesh's
    ranks) gives every rank rank 0's answer to the adaptive question. A
    skipped step reuses the last computed velocity
    or, linear, extrapolates over sigma from the last two; extrapolated
    values never enter the registers. Returns ``(velocity, regs)``.
    """
    v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips = regs
    if vc_adaptive:
        ref_lat = torch.zeros_like(lat) if lat_ref is None else lat_ref
        drift = (lat - ref_lat).abs().mean(dim=(1, 2))
        ref = ref_lat.abs().mean(dim=(1, 2))
        if signal_mean is not None:     # equal shards: the mean of shard means
            drift, ref = signal_mean(drift), signal_mean(ref)
        rel = float((drift / (ref + 1e-8)).max())     # the host sync of this mode
        ask = lambda: always or rel >= vc_threshold or skips >= vc_max_skip   # noqa: E731
        run = ask() if decide is None else decide(ask)
    else:
        run = always or (i - vc_warmup) % vc_interval == 0
    if run:
        v = compute_fn()
        return v, (v, v_prev, sig_i, s_prev, lat.float(), 0)
    if v_prev is None:
        raise RuntimeError("the velocity cache skipped a step before any was computed")
    v = v_prev
    if vc_linear:
        # first-order extrapolation over sigma; reuse until two computes exist
        # (the empty register's sigma is 0, real schedule sigmas are > 0)
        ds = np.float32(s_prev - s_prev2)
        if abs(ds) > 1e-8 and s_prev2 > 0.0:
            v = v_prev + (v_prev - v_prev2) * float(np.float32(1.0) / ds * (sig_i - s_prev))
    return v, (v_prev, v_prev2, s_prev, s_prev2, lat_ref, skips + 1)


def chunk_steps(num_steps: int, start_step: int, chunk: Optional[int]) -> range:
    """The absolute steps of a chunk of ``chunk`` steps (None: to the end)
    from ``start_step``, checked against the schedule's ``num_steps``."""
    stop = num_steps if chunk is None else start_step + chunk
    if not 0 <= start_step < stop <= num_steps:
        raise ValueError(f"chunk of steps [{start_step}, {stop}) is not inside the "
                         f"schedule's {num_steps} steps")
    return range(start_step, stop)


def make_txt2img_sampler(flux: torch.nn.Module, controlnet: torch.nn.Module,
                         schedule: FlowMatchSchedule, pipe_cfg: PipelineConfig,
                         compute_dtype: torch.dtype = torch.float32,
                         signal_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                         decide: Optional[Callable[[Callable[[], bool]], bool]] = None
                         ) -> Callable:
    """Build ``sample(latents, cond_tokens, token_masks, prompt_embeds,
    pooled_embeds, txt_ids, img_ids, guidance, start_step=0, num_steps=None,
    flux_extra=None) -> latents``.

    latents: [B, S, C] packed (float32 out); cond_tokens [N, S, F] and
    token_masks [N, S, 1] are shared by the B images, or [N, B, S, F] and
    [N, B, S, 1] carry one condition set per image (serving's coalesced
    batch of requests), tiled line-major as the ControlNet's batch is.
    ``start_step``/``num_steps``: the chunk of the schedule to run (None: to
    its end). ``signal_mean`` and ``decide``: see :func:`velocity_cache_select`.
    ``flux_extra``: keywords for every FLUX call (the IP-Adapter's
    ``ip_tokens`` and ``ip_scale``).
    """
    vc = velocity_cache_settings(pipe_cfg)
    vc_enabled = vc.pop("enabled")
    vc.update(signal_mean=signal_mean, decide=decide)
    total = schedule.num_steps
    cn_active = cn_active_mask(pipe_cfg, total,
                               min(pipe_cfg.controlnet_conditioning_step, total))
    cond_scale = pipe_cfg.controlnet_conditioning_scale

    def sample(latents: torch.Tensor, cond_tokens: torch.Tensor, token_masks: torch.Tensor,
               prompt_embeds: torch.Tensor, pooled_embeds: torch.Tensor,
               txt_ids: torch.Tensor, img_ids: torch.Tensor,
               guidance: Optional[torch.Tensor], start_step: int = 0,
               num_steps: Optional[int] = None,
               flux_extra: Optional[dict] = None) -> torch.Tensor:
        steps = chunk_steps(schedule.num_steps, start_step, num_steps)
        b = latents.shape[0]
        n_lines = cond_tokens.shape[0]
        mode_kw = controlnet_mode(controlnet, pipe_cfg, n_lines * b, latents.device)
        extra = flux_extra or {}
        ctx = prompt_embeds.to(compute_dtype)
        pooled = pooled_embeds.to(compute_dtype)
        if cond_tokens.ndim == 4:
            # line j, image i at j * B + i, as x_model.repeat(n_lines) tiles them
            cond = cond_tokens.reshape(n_lines * b, *cond_tokens.shape[2:]).to(compute_dtype)
            masks = token_masks                                  # [N, B, S, 1]
        else:
            cond = cond_tokens.repeat_interleave(b, dim=0).to(compute_dtype)
            masks = token_masks[:, None, :, :]                  # [N, 1, S, 1]
        ctx_nb = ctx.repeat(n_lines, 1, 1)
        pooled_nb = pooled.repeat(n_lines, 1)
        guidance_nb = None if guidance is None else guidance.repeat(n_lines)

        def mask_and_sum(res: torch.Tensor) -> torch.Tensor:
            l, _, s, d = res.shape
            res = res.reshape(l, n_lines, b, s, d)
            return (res * masks.to(res.dtype)).sum(dim=1)

        lat = latents.float()
        regs = empty_cache_regs()
        rec = active_recorder()
        for i in steps:
            with span(rec, "step"):
                t_i = float(np.float32(schedule.timesteps[i]) / np.float32(1000.0))
                t_b = torch.full((b,), t_i, dtype=compute_dtype, device=lat.device)
                x_model = lat.to(compute_dtype)

                def compute_velocity() -> torch.Tensor:
                    block_res = single_res = None
                    if cn_active[i]:
                        with span(rec, "controlnet"):
                            block, single = controlnet(
                                x_model.repeat(n_lines, 1, 1), cond, ctx_nb, pooled_nb,
                                t_b.repeat(n_lines), img_ids, txt_ids, guidance_nb, cond_scale,
                                **mode_kw)
                        block_res, single_res = mask_and_sum(block), mask_and_sum(single)
                    with span(rec, "flux"):
                        v = flux(x_model, ctx, pooled, t_b, img_ids, txt_ids, guidance,
                                 controlnet_block_samples=block_res,
                                 controlnet_single_block_samples=single_res, **extra)
                    return v.float()

                if vc_enabled:
                    always = i < vc["vc_warmup"] or i >= total - 1 or i == steps.start
                    velocity, regs = velocity_cache_select(
                        compute_velocity, regs, lat, schedule.sigmas[i], i, always, **vc)
                else:
                    velocity = compute_velocity()
                lat = schedule.step(lat, velocity, i)
        return lat

    return sample


def make_sp_txt2img_sampler(flux: torch.nn.Module, controlnet: torch.nn.Module,
                            schedule: FlowMatchSchedule, pipe_cfg: PipelineConfig,
                            group: SPGroup, backend: str,
                            compute_dtype: torch.dtype = torch.float32) -> Callable:
    """The txt2img loop with the image tokens sharded over ``group``.

    ``backend`` ('ring' or 'ulysses') is the SP attention of both models'
    blocks (what the JAX sampler's clones carry in their
    ``attention_backend``). The
    returned ``sample`` takes the same global tensors as
    :func:`make_txt2img_sampler`'s on every rank, and its chunk arguments,
    runs the loop on the rank's shard of the latents, conditions, token
    masks and ``img_ids`` under the group's SP context (every other op is per
    token), and returns the gathered latents on every rank. Rank-4 [N, B, S,
    F] conditions and masks shard on dim 2, as the JAX ``_specs`` do. The
    IP-Adapter's tokens (``flux_extra``) are whole on every rank: the ip
    attention of a rank's image queries needs no exchange.
    """
    if backend not in JOINT_SP_ATTENTION:
        raise ValueError(f"the SP sampler needs the backend ring|ulysses, got {backend!r}")
    base = make_txt2img_sampler(flux, controlnet, schedule, pipe_cfg, compute_dtype,
                                signal_mean=group.all_reduce_mean)

    def sample(latents: torch.Tensor, cond_tokens: torch.Tensor, token_masks: torch.Tensor,
               prompt_embeds: torch.Tensor, pooled_embeds: torch.Tensor,
               txt_ids: torch.Tensor, img_ids: torch.Tensor,
               guidance: Optional[torch.Tensor], start_step: int = 0,
               num_steps: Optional[int] = None,
               flux_extra: Optional[dict] = None) -> torch.Tensor:
        with sp_context(group, backend):
            lat = base(group.shard(latents, 1), shard_tokens(group, cond_tokens),
                       shard_tokens(group, token_masks), prompt_embeds, pooled_embeds, txt_ids,
                       group.shard(img_ids, 0), guidance, start_step, num_steps, flux_extra)
        return group.all_gather(lat, 1)

    return sample


def shard_tokens(group: SPGroup, x: torch.Tensor) -> torch.Tensor:
    """This rank's token shard of [N, S, F] (dim 1) or [N, B, S, F] (dim 2)
    conditions and masks."""
    return group.shard(x, x.ndim - 2)
