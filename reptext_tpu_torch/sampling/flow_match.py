"""FlowMatch Euler schedule with FLUX dynamic time shifting (numpy/PyTorch).

Counterpart of ``reptext_tpu/sampling/flow_match.py`` for the linspace
schedule the txt2img slice uses: sigmas = linspace(1, 1/N, N), exponentially
mu-shifted, with a trailing 0; model-facing timesteps are sigma * 1000, and
models receive t/1000. Custom ``timesteps``/``sigmas`` are not ported yet.
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


def build_schedule(num_steps: int, image_seq_len: int, base_image_seq_len: int = 256,
                   max_image_seq_len: int = 4096, base_shift: float = 0.5,
                   max_shift: float = 1.16, use_dynamic_shifting: bool = True,
                   shift: float = 3.0) -> FlowMatchSchedule:
    """The FLUX FlowMatch Euler schedule (dynamic shift, or static ``shift``)."""
    base = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if use_dynamic_shifting:
        mu = calculate_shift(image_seq_len, base_image_seq_len, max_image_seq_len,
                             base_shift, max_shift)
        shifted = np.array([time_shift(mu, 1.0, s) for s in base])
    else:
        shifted = shift * base / (1 + (shift - 1) * base)
    timesteps = (shifted * 1000.0).astype(np.float32)
    sigmas = np.concatenate([shifted, [0.0]]).astype(np.float32)
    return FlowMatchSchedule(sigmas=sigmas, timesteps=timesteps)
