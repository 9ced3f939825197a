"""The DDPM training-time noise schedule (view_neti_tpu/schedulers/ddpm.py).

The diffusers DDPMScheduler config the reference loads from the SD repo:
scaled_linear betas 0.00085 -> 0.012 over 1000 steps, epsilon or
v-prediction targets. The cumulative product is taken in float64 and cast
to float32, as there.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class DDPMSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    alphas_cumprod: torch.Tensor = field(init=False, repr=False,
                                         compare=False)

    def __post_init__(self):
        n = self.num_train_timesteps
        if self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                                n, dtype=np.float64) ** 2
        elif self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end, n,
                                dtype=np.float64)
        else:
            raise NotImplementedError(self.beta_schedule)
        acp = torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))
        object.__setattr__(self, "alphas_cumprod", acp)

    def _coeffs(self, timesteps: torch.Tensor, ndim: int):
        if self.alphas_cumprod.device != timesteps.device:
            # moved once, so that later steps copy nothing from the host
            object.__setattr__(self, "alphas_cumprod",
                               self.alphas_cumprod.to(timesteps.device))
        acp = self.alphas_cumprod[timesteps]
        shape = (-1,) + (1,) * (ndim - 1)
        return (torch.sqrt(acp).reshape(shape),
                torch.sqrt(1.0 - acp).reshape(shape))

    def add_noise(self, samples: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps."""
        sqrt_acp, sqrt_1m = self._coeffs(timesteps, samples.dim())
        return sqrt_acp * samples + sqrt_1m * noise

    def get_velocity(self, samples: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """v_t = sqrt(acp_t) eps - sqrt(1 - acp_t) x_0."""
        sqrt_acp, sqrt_1m = self._coeffs(timesteps, samples.dim())
        return sqrt_acp * noise - sqrt_1m * samples

    def target(self, samples: torch.Tensor, noise: torch.Tensor,
               timesteps: torch.Tensor) -> torch.Tensor:
        """The training target per prediction_type."""
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            return self.get_velocity(samples, noise, timesteps)
        raise ValueError(f"Unknown prediction type {self.prediction_type}")
