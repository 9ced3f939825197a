"""The noise schedules of Stable Diffusion in plain PyTorch and numpy:
the DDPM training target (scaled-linear betas 0.00085 -> 0.012 over 1000
steps; epsilon or v prediction) and the DPM-Solver++ (2M) sampler of
diffusers' DPMSolverMultistepScheduler with linspace timestep spacing,
written from the published formulas (Lu et al. 2022, DPM-Solver++)."""
from __future__ import annotations

import math

import numpy as np
import torch

T = 1000


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, T,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def noised_and_target(x0, noise, t, prediction: str):
    """(x_t, the training target) at integer timesteps t (B,)."""
    acp = torch.as_tensor(alphas_cumprod().astype(np.float32),
                          device=x0.device)[t]
    a = acp.sqrt().reshape(-1, 1, 1, 1)
    s = (1 - acp).sqrt().reshape(-1, 1, 1, 1)
    xt = a * x0 + s * noise
    if prediction == "epsilon":
        return xt, noise
    if prediction == "v_prediction":
        return xt, a * noise - s * x0
    raise ValueError(prediction)


def dpm_timesteps(n: int) -> np.ndarray:
    return np.linspace(0, T - 1, n + 1).round()[::-1][:-1].astype(np.int64)


def dpm_sample(model, x, n: int, prediction: str) -> torch.Tensor:
    """Run DPM-Solver++ 2M for n steps from x; model(x, t) is the guided
    prediction (epsilon or v) at the float timestep t."""
    ts = dpm_timesteps(n)
    acp = alphas_cumprod()
    alpha = np.sqrt([acp[t] for t in list(ts) + [0]])
    sigma = np.maximum(np.sqrt([1 - acp[t] for t in list(ts) + [0]]), 1e-12)
    lam = np.log(alpha) - np.log(sigma)
    alpha, sigma, lam = (a.tolist() for a in (alpha, sigma, lam))
    x0_prev = None
    for i, t in enumerate(ts):
        out = model(x, float(t))
        x0 = ((x - sigma[i] * out) / alpha[i] if prediction == "epsilon"
              else alpha[i] * x - sigma[i] * out)
        h = lam[i + 1] - lam[i]
        x = sigma[i + 1] / sigma[i] * x - alpha[i + 1] * math.expm1(-h) * x0
        if i > 0 and not (n < 15 and i == n - 1):
            r = (lam[i] - lam[i - 1]) / h
            x = x - 0.5 * alpha[i + 1] * math.expm1(-h) * (x0 - x0_prev) / r
        x0_prev = x0
    return x


def split_cfg(out: torch.Tensor, scale: float) -> torch.Tensor:
    """The guided prediction of a batch [unconditional; conditional]."""
    u, c = out.chunk(2)
    return u + scale * (c - u)


