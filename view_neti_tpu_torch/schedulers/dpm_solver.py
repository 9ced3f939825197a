"""DPM-Solver++ (2M) multistep scheduler (view_neti_tpu/schedulers/dpm_solver.py).

Config parity with the diffusers DPMSolverMultistepScheduler the reference
uses for inference: dpmsolver++, solver order 2, lower_order_final,
scaled_linear betas 0.00085 -> 0.012, epsilon or v prediction. The
coefficient tables are float64 cast to float32, and every scalar
coefficient is formed in float32 in the JAX package's order. The step
index is a host integer, so the first/second-order choice is a Python
branch. Nothing here reads the card: the coefficients are host floats
fixed by the step count, which a CUDA graph of the denoise loop holds as
constants (inference/pipeline.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DPMSolverSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "epsilon"
    solver_order: int = 2
    lower_order_final: bool = True
    alphas_cumprod: np.ndarray = field(init=False, repr=False, default=None)

    def __post_init__(self):
        betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                            self.num_train_timesteps, dtype=np.float64) ** 2
        object.__setattr__(self, "alphas_cumprod", np.cumprod(1.0 - betas))

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """diffusers linspace spacing: linspace(0, N-1, n+1).round()[::-1][:-1]."""
        t = np.linspace(0, self.num_train_timesteps - 1,
                        num_inference_steps + 1).round()[::-1][:-1]
        return t.astype(np.int64)

    def coefficients(self, timesteps: np.ndarray) -> Dict[str, np.ndarray]:
        """Per-step float32 (alpha, sigma, lambda), length n+1; index n is
        the final state t=0 (diffusers' convention)."""
        acp = self.alphas_cumprod
        ts = list(timesteps) + [0]
        alpha = np.sqrt(np.asarray([acp[t] for t in ts], np.float64))
        sigma = np.sqrt(1.0 - np.asarray([acp[t] for t in ts], np.float64))
        sigma = np.maximum(sigma, 1e-12)
        lam = np.log(alpha) - np.log(sigma)
        return {"alpha": alpha.astype(np.float32),
                "sigma": sigma.astype(np.float32),
                "lambda": lam.astype(np.float32)}

    def to_x0(self, model_output: torch.Tensor, sample: torch.Tensor,
              alpha_t: np.float32, sigma_t: np.float32) -> torch.Tensor:
        if self.prediction_type == "epsilon":
            return (sample - float(sigma_t) * model_output) / float(alpha_t)
        if self.prediction_type == "v_prediction":
            return float(alpha_t) * sample - float(sigma_t) * model_output
        raise ValueError(self.prediction_type)

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             x0_prev: torch.Tensor, coeffs: Dict[str, np.ndarray],
             num_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One solver step at host index i. Returns (new_sample, x0); the
        caller threads x0 as x0_prev."""
        alpha, sigma, lam = coeffs["alpha"], coeffs["sigma"], coeffs["lambda"]
        x0 = self.to_x0(model_output, sample, alpha[i], sigma[i])
        use_first = self.solver_order == 1 or i == 0
        # diffusers' final-step first-order fallback applies only to short
        # schedules (fewer than 15 steps)
        if self.lower_order_final and num_steps < 15 and i == num_steps - 1:
            use_first = True
        h = lam[i + 1] - lam[i]
        ratio = float(sigma[i + 1] / sigma[i])
        c = alpha[i + 1] * (np.exp(-h) - np.float32(1.0))
        if use_first:
            # DPM-Solver++(1): x' = (s'/s) x - a'(e^{-h} - 1) x0
            return ratio * sample - float(c) * x0, x0
        # DPM-Solver++(2M) with the previous x0
        r0 = (lam[i] - lam[i - 1]) / h
        d1 = (x0 - x0_prev) / float(r0)
        c2 = np.float32(0.5) * alpha[i + 1] * (np.exp(-h) - np.float32(1.0))
        return ratio * sample - float(c) * x0 - float(c2) * d1, x0
