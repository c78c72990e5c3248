"""FlowMatch Euler schedule with FLUX dynamic time shifting (numpy/PyTorch).

Counterpart of ``reptext_tpu/sampling/flow_match.py``: sigmas =
linspace(1, 1/N, N), or a caller's ladder, exponentially mu-shifted, with a
trailing 0; model-facing timesteps are sigma * 1000 (or a caller's grid), and
models receive t/1000.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def calculate_shift(image_seq_len: int, base_seq_len: int = 256, max_seq_len: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.16) -> float:
    """Linear interpolation of the log-shift mu in image sequence length."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def time_shift(mu: float, sigma: float, t):
    """Exponential time shift: t -> e^mu / (e^mu + (1/t - 1)^sigma)."""
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """sigmas has length N+1 (trailing 0.0); timesteps = sigmas[:-1] * 1000."""

    sigmas: np.ndarray
    timesteps: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def step(self, latents: torch.Tensor, velocity: torch.Tensor, i: int) -> torch.Tensor:
        """One Euler step in float32."""
        dt = float(np.float32(self.sigmas[i + 1]) - np.float32(self.sigmas[i]))
        return latents.float() + dt * velocity.float()

    def scale_noise(self, sample: torch.Tensor, noise: torch.Tensor, i: int) -> torch.Tensor:
        """Forward process at step i: sigma*noise + (1-sigma)*sample."""
        sigma = float(self.sigmas[i])
        return sigma * noise + (1.0 - sigma) * sample


def build_schedule(num_steps: int, image_seq_len: int, base_image_seq_len: int = 256,
                   max_image_seq_len: int = 4096, base_shift: float = 0.5,
                   max_shift: float = 1.16, use_dynamic_shifting: bool = True,
                   shift: float = 3.0, timesteps=None, sigmas=None) -> FlowMatchSchedule:
    """The FLUX FlowMatch Euler schedule (dynamic shift, or static ``shift``).

    At most one custom schedule, each overriding ``num_steps`` with its
    length: ``sigmas``, a base ladder in (0, 1] that replaces the linspace and
    is still shifted; or ``timesteps``, model-facing values in (0, 1000] whose
    ``t/1000`` are shifted into the Euler sigmas while the stored timesteps
    stay the caller's, as the JAX package keeps them.
    """
    if timesteps is not None and sigmas is not None:
        raise ValueError("Only one of `timesteps` or `sigmas` can be passed. "
                         "Please choose one to set custom values")
    provided_timesteps = None
    if timesteps is not None:
        provided_timesteps = np.asarray(timesteps, dtype=np.float64)
        if provided_timesteps.ndim != 1 or len(provided_timesteps) == 0:
            raise ValueError("timesteps must be a non-empty 1D sequence")
        if (provided_timesteps <= 0).any() or (provided_timesteps > 1000).any():
            raise ValueError("timesteps must lie in (0, 1000]")
        base = provided_timesteps / 1000.0
    elif sigmas is not None:
        base = np.asarray(sigmas, dtype=np.float64)
        if base.ndim != 1 or len(base) == 0:
            raise ValueError("sigmas must be a non-empty 1D sequence")
        if (base <= 0).any() or (base > 1).any():
            raise ValueError("sigmas must lie in (0, 1]")
    else:
        base = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if use_dynamic_shifting:
        mu = calculate_shift(image_seq_len, base_image_seq_len, max_image_seq_len,
                             base_shift, max_shift)
        shifted = np.array([time_shift(mu, 1.0, s) for s in base])
    else:
        shifted = shift * base / (1 + (shift - 1) * base)
    if provided_timesteps is not None:
        out_timesteps = provided_timesteps.astype(np.float32)
    else:
        out_timesteps = (shifted * 1000.0).astype(np.float32)
    sigmas_out = np.concatenate([shifted, [0.0]]).astype(np.float32)
    return FlowMatchSchedule(sigmas=sigmas_out, timesteps=out_timesteps)
