"""Stable Diffusion denoise pipeline with per-timestep NeTI contexts
(view_neti_tpu/inference/pipeline.py).

CFG runs fused into the batch (the unconditional half first), contexts are
stacked (T, 16, B, L, D) and indexed by step, DPM-Solver++ steps the
latents, and the VAE decodes straight to uint8. The denoise loop is a
Python loop over host step indices; on the card the whole loop is one CUDA
graph per input signature (utils/graphs.py), the counterpart of the JAX
package's jitted fori_loop, and so is the decode (its `_decode_jit`):
a sampling run replays two graphs. The scheduler's coefficients are host
floats fixed by the step count, so the graph holds them as constants.

Entry points (`generate`, `generate_batch`) run on the card: with
device=None they use CUDA and raise if no card is present.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
from view_neti_tpu_torch.utils.device import resolve_device
from view_neti_tpu_torch.utils.graphs import Graphed
from view_neti_tpu_torch.utils.profiling import span


def make_denoise_fn(unet, schedule: DPMSolverSchedule,
                    num_inference_steps: int, guidance_scale: float = 7.5,
                    compute_dtype: torch.dtype = torch.float32,
                    graph: bool = True, log=None):
    """Returns fn(latents0, context, context_bypass, uncond_ctx) -> latents.

      latents0: (N, h, w, 4) initial noise
      context / context_bypass: (T, 16, C, L, D) per-step conditioning for
        C prompts; the N latents are cam-major, N // C seeds per prompt
      uncond_ctx: (1, L, D) negative-prompt hidden states

    On the card, with graph on (the default), the loop of every call after
    the first with the same signature is one CUDA graph replay
    (utils/graphs.Graphed, `fn.captures`); log(message) hears of each
    graph after the first, a ragged last batch's. graph=False, or CPU
    tensors, run the loop eagerly.
    """
    timesteps = schedule.set_timesteps(num_inference_steps)
    coeffs = schedule.coefficients(timesteps)
    ts = torch.as_tensor(timesteps.astype("float32"))
    # the timesteps on each device, staged before any capture: a copy from
    # pageable host memory cannot be captured
    staged = {}
    do_cfg = guidance_scale > 1.0

    @torch.no_grad()
    def denoise(latents, context, context_bypass, uncond_ctx):
        N = latents.shape[0]
        n_layers, n_ctx = context.shape[1], context.shape[2]
        if N % n_ctx:
            raise ValueError(f"{N} latents do not split over {n_ctx} prompts")
        reps = N // n_ctx              # seeds per prompt
        uncond = uncond_ctx[None, :1].to(compute_dtype).expand(
            (n_layers, N) + tuple(uncond_ctx.shape[1:]))
        lat = latents.float()
        x0_prev = torch.zeros_like(lat)
        if lat.device not in staged:
            staged[lat.device] = ts.to(lat.device)
        ts_dev = staged[lat.device]
        for i in range(num_inference_steps):
            t = ts_dev[i].expand(N)
            # cam-major batch layout: [cam0 x reps, cam1 x reps, ...]
            ctx = context[i].repeat_interleave(reps, dim=1).to(compute_dtype)
            ctx_b = context_bypass[i].repeat_interleave(reps, dim=1).to(
                compute_dtype)
            if do_cfg:
                eps2 = unet(torch.cat([lat, lat]).to(compute_dtype),
                            torch.cat([t, t]), torch.cat([uncond, ctx], 1),
                            torch.cat([uncond, ctx_b], 1))
                eps_u, eps_c = eps2.float().chunk(2)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            else:
                eps = unet(lat.to(compute_dtype), t, ctx, ctx_b).float()
            lat, x0_prev = schedule.step(eps, i, lat, x0_prev, coeffs,
                                         num_inference_steps)
        return lat

    return Graphed(denoise, f"denoise loop ({num_inference_steps} steps)",
                   enabled=graph, log=log)


def make_decode_fn(vae, graph: bool = True, log=None):
    """fn(latents) -> uint8 images, decode_to_uint8 as one CUDA graph
    replay per call on the card after the first with the same shape (the
    JAX package's _decode_jit); eager with graph=False or on the CPU."""
    return Graphed(lambda latents: decode_to_uint8(vae, latents), "decode",
                   enabled=graph, log=log)


@torch.no_grad()
def decode_to_uint8(vae, latents: torch.Tensor) -> torch.Tensor:
    """VAE decode and uint8 quantization on the device: clip(x/2 + .5) to
    [0, 1], then round(x * 255) half-to-even (jnp.round's rule)."""
    img = vae.decode(latents)
    img = torch.clamp(img.float() / 2 + 0.5, 0, 1)
    return torch.round(img * 255).to(torch.uint8)


def initial_latents(seeds: Sequence[int], h: int, w: int,
                    device: torch.device) -> torch.Tensor:
    """(S, h, w, 4) fp32 noise, one torch.Generator per seed, so seed s gives
    the same latents whatever batch it is in."""
    return torch.stack([
        torch.randn((h, w, 4), device=device,
                    generator=torch.Generator(device).manual_seed(int(s)))
        for s in seeds])


def generate(unet, vae, schedule: DPMSolverSchedule, context, context_bypass,
             uncond_ctx, height: int, width: int, seeds,
             num_inference_steps: int = 30, guidance_scale: float = 7.5,
             compute_dtype: torch.dtype = torch.float32, denoise_fn=None,
             as_numpy: bool = True, device=None, decode_fn=None):
    """Text-to-image generation for one prompt: (S, H, W, 3) uint8 images,
    one per seed (a numpy array, or the device tensor with
    as_numpy=False)."""
    out = generate_batch(unet, vae, schedule, context, context_bypass,
                         uncond_ctx, height, width, seeds,
                         num_inference_steps, guidance_scale, compute_dtype,
                         denoise_fn, as_numpy=False, device=device,
                         decode_fn=decode_fn)[0]
    return out.cpu().numpy() if as_numpy else out


def generate_batch(unet, vae, schedule: DPMSolverSchedule, contexts,
                   contexts_bypass, uncond_ctx, height: int, width: int,
                   seeds, num_inference_steps: int = 30,
                   guidance_scale: float = 7.5,
                   compute_dtype: torch.dtype = torch.float32,
                   denoise_fn=None, as_numpy: bool = True, device=None,
                   decode_fn=None):
    """Batched multi-prompt generation: contexts (T, 16, C, L, D) carry C
    prompts; all C x len(seeds) images denoise in one loop. Returns
    (C, S, H, W, 3) uint8. Seed s gives the same initial latents for every
    prompt (the reference's per-view reseeding). A caller that generates
    more than once passes the denoise_fn and decode_fn it keeps
    (make_denoise_fn, make_decode_fn), so that their graphs are captured
    once and replayed. Spans (utils/profiling.span): "render.latents",
    "render.denoise" and "render.decode"."""
    device = resolve_device(device)
    if denoise_fn is None:
        denoise_fn = make_denoise_fn(unet, schedule, num_inference_steps,
                                     guidance_scale, compute_dtype)
    C, S = contexts.shape[2], len(seeds)
    scale = 2 ** (len(vae.config.channel_mults) - 1)
    with span("render.latents"):
        lat0 = initial_latents(seeds, height // scale, width // scale, device)
        lat0 = lat0.repeat(C, 1, 1, 1)      # cam-major: [c0s0, c0s1, ...]
    with span("render.denoise"):
        latents = denoise_fn(lat0, contexts.to(device),
                             contexts_bypass.to(device),
                             uncond_ctx.to(device))
    with span("render.decode"):
        imgs = (decode_fn or functools.partial(decode_to_uint8, vae))(
            latents.to(compute_dtype))
        imgs = imgs.reshape((C, S) + tuple(imgs.shape[1:]))
    return imgs.cpu().numpy() if as_numpy else imgs


@torch.no_grad()
def encode_uncond(clip, tokenizer, negative_prompt: str = "",
                  max_length: Optional[int] = None) -> torch.Tensor:
    """Negative-prompt hidden states through the plain CLIP path, (1, L, D)."""
    L = max_length or clip.config.max_position_embeddings
    device = clip.text_model.embeddings.token_embedding.weight.device
    ids = tokenizer(negative_prompt or "", padding="max_length",
                    truncation=True, max_length=L).input_ids
    return clip(torch.as_tensor(ids, dtype=torch.long, device=device))[0]
