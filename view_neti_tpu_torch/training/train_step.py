"""The textual-inversion train step (view_neti_tpu/training/train_step.py).

One call is one optimizer step over one fused batch (the Coach's
fuse_accumulation layout: train_batch_size x gradient_accumulation_steps
samples): VAE-encode the pixels under no_grad (or sample latents from
cached posterior moments), noise them at per-sample timesteps, compute the
16-layer NeTI text conditioning in one folded pass, predict with the UNet,
take the fp32 MSE, backpropagate to the mappers only and step the sliced
AdamW. The gradient reaches the mappers only through the UNet's
cross-attention K/V, so every attention call after the first runs K1
forward and K2/K3 backward (ops/flash_attention.py), and the fused VAE
encode runs K4.

With `augment`, the batch's pixels are uint8 base images that the step
augments on the card first (ops/device_augment.py, the shipped preset 7);
with `cache_pixels`, the batch carries only int64 indices into a cache on
the card that the models object holds (`models.pixel_cache`: uint8 bases,
or the latent cache's fp32 posterior moments), and the step gathers its
rows before it augments or samples.

JAX draws every random number inside its step from one key; torch's
generator never gives JAX's bits, so the port takes them as data: a
StepDraws record that `sample_step_draws` fills from a torch.Generator and
that the tests fill with JAX's own draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from view_neti_tpu_torch.constants import NUM_UNET_LAYERS
from view_neti_tpu_torch.models.neti_mapper import (NestedDropoutDraws,
                                                    sample_nested_dropout)
from view_neti_tpu_torch.ops.device_augment import (AugmentDraws,
                                                    AugmentSpec,
                                                    augment_batch,
                                                    sample_augment_draws)
from view_neti_tpu_torch.training.optim import SlicedAdamW
from view_neti_tpu_torch.training.text_forward import (neti_text_conditioning,
                                                       object_groups)


@dataclass
class TrainBatch:
    """One fused batch.

    pixel_values: images (B, H, W, 3) in [-1, 1]; for a step built with
      augment, uint8 base images (B, H, W, 3); with from_moments, VAE
      posterior moments (B, h, w, 8); with cache_pixels, (B,) int64 rows of
      models.pixel_cache;
    input_ids: (B, L); input_ids_placeholder_object / _view: (B,) the
      placeholder id of each prompt, -1 where absent;
    object_idx: which object mapper conditions the batch: an int, or for
      mode 3's fused batch a (G,) int64 tensor on the host, one index per
      group of B / G contiguous samples (text_forward.py).
    """
    pixel_values: torch.Tensor
    input_ids: torch.Tensor
    input_ids_placeholder_object: torch.Tensor
    input_ids_placeholder_view: torch.Tensor
    object_idx: Union[int, torch.Tensor] = 0


@dataclass
class StepDraws:
    """The random numbers of one step.

    vae_eps: (B, h, w, 4) standard normal, the posterior sample's noise;
    noise: (B, h, w, 4) standard normal fp32, the diffusion noise;
    timesteps: (B,) integers in [0, num_train_timesteps);
    dropout: nested-dropout draws per mapper key ("object", "view") for its
      16 * B rows (for a grouped batch, the object rows group by group:
      text_forward.neti_text_conditioning), or None for no dropout;
    augment: the augmentation's draws, for a step built with augment.
    """
    vae_eps: torch.Tensor
    noise: torch.Tensor
    timesteps: torch.Tensor
    dropout: Optional[Dict[str, NestedDropoutDraws]] = None
    augment: Optional[AugmentDraws] = None


def pixel_shape(models, batch: TrainBatch) -> Tuple[int, ...]:
    """The shape of the batch's pixels (or moments), looked up in the
    pixel cache when the batch holds its row indices."""
    pv = batch.pixel_values
    if pv.dim() == 1:
        return (pv.shape[0],) + tuple(models.pixel_cache.shape[1:])
    return tuple(pv.shape)


def latent_shape(models, batch: TrainBatch, from_moments: bool = False
                 ) -> Tuple[int, int, int, int]:
    """The (B, h, w, 4) latent shape of a batch."""
    B, H, W, C = pixel_shape(models, batch)
    if from_moments:
        return B, H, W, C // 2
    f = 2 ** (len(models.vae.config.channel_mults) - 1)
    return B, H // f, W // f, models.vae.config.latent_channels


def sample_step_draws(generator: torch.Generator, models, batch: TrainBatch,
                      from_moments: bool = False,
                      augment: Optional[AugmentSpec] = None,
                      batch_size: Optional[int] = None) -> StepDraws:
    """Draw a step's random numbers on the generator's device: normals for
    the posterior sample and the noise, uniform integer timesteps,
    nested-dropout draws for every mapper that uses it, and with `augment`
    the augmentation's draws. Nothing is read back to the host.
    batch_size: the whole fused batch's, where `batch` holds one rank's
    rows of it; the draws are the whole batch's (parallel/dist.py
    shard_draws keeps the rank's), so that a row's numbers do not depend on
    the number of ranks."""
    device = generator.device
    shape = latent_shape(models, batch, from_moments)
    if batch_size is not None:
        shape = (batch_size,) + shape[1:]
    B = shape[0]
    vae_eps = torch.randn(shape, generator=generator, device=device)
    noise = torch.randn(shape, generator=generator, device=device)
    timesteps = torch.randint(0, models.schedule.num_train_timesteps, (B,),
                              generator=generator, device=device)
    text = models.text
    groups = object_groups(batch.object_idx)
    first = groups[0] if groups else int(batch.object_idx)
    mappers = {"object": text.obj_mappers[first] if text.obj_mappers
               else None,
               "view": text.view_mapper}
    dropout = {key: sample_nested_dropout(generator, NUM_UNET_LAYERS * B,
                                          m.hidden_dim, m.nested_dropout_prob,
                                          device)
               for key, m in mappers.items()
               if m is not None and m.use_nested_dropout and not m.is_ti}
    aug = None
    if augment is not None:
        _, H, W, _ = pixel_shape(models, batch)
        aug = sample_augment_draws(generator, augment, B, H, W)
    return StepDraws(vae_eps, noise, timesteps, dropout or None, aug)


def gather_pixels(models, batch: TrainBatch) -> torch.Tensor:
    """The batch's pixels (or moments): its own, or the cache rows its
    indices name."""
    pv = batch.pixel_values
    return models.pixel_cache[pv] if pv.dim() == 1 else pv


@torch.no_grad()
def encode_latents(models, batch: TrainBatch, draws: StepDraws,
                   compute_dtype: torch.dtype, from_moments: bool = False,
                   augment: Optional[AugmentSpec] = None) -> torch.Tensor:
    """fp32 latents (B, h, w, 4) sampled from the posterior of the pixels
    (the frozen VAE encode, K4 on the card; with `augment` the uint8 bases
    are augmented first) or of cached moments."""
    pixels = gather_pixels(models, batch)
    if from_moments:
        mean, logvar = pixels.float().chunk(2, dim=-1)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        latents = ((mean + std * draws.vae_eps.float())
                   * models.vae.config.scaling_factor)
    else:
        if augment is not None:
            pixels = augment_batch(augment, draws.augment, pixels)
        latents = models.vae.encode_sample(pixels.to(compute_dtype),
                                           draws.vae_eps)
    return latents.float()


def diffusion_loss(models, batch: TrainBatch, draws: StepDraws,
                   latents: torch.Tensor, compute_dtype: torch.dtype
                   ) -> torch.Tensor:
    """The fp32 MSE between the UNet's prediction on the noised latents and
    the schedule's target, differentiable in the mappers."""
    schedule = models.schedule
    noisy = schedule.add_noise(latents, draws.noise, draws.timesteps)
    target = schedule.target(latents, draws.noise, draws.timesteps)
    ctx, ctx_b = neti_text_conditioning(
        models.text, batch.input_ids, batch.input_ids_placeholder_object,
        batch.input_ids_placeholder_view, draws.timesteps,
        object_idx=batch.object_idx, train=True, draws=draws.dropout)
    pred = models.unet(noisy.to(compute_dtype), draws.timesteps,
                       ctx.to(compute_dtype), ctx_b.to(compute_dtype))
    return torch.mean((pred.float() - target.float()) ** 2)


def make_train_step(optimizer: SlicedAdamW,
                    compute_dtype: torch.dtype = torch.float32,
                    from_moments: bool = False,
                    augment: Optional[AugmentSpec] = None,
                    cache_pixels: bool = False,
                    accumulation_steps: int = 1,
                    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                    = None) -> Callable:
    """Build the train step around `optimizer` (training/optim.py).

    from_moments: batch.pixel_values holds VAE posterior moments (the
    latent cache); the step samples latents from them and skips the
    encoder. augment: batch.pixel_values holds uint8 base images, which the
    step augments on the card (ops/device_augment.py) before the encode.
    cache_pixels: batch.pixel_values holds (B,) int64 rows of
    models.pixel_cache, the bases or moments on the card.
    accumulation_steps k > 1: each call is one micro-batch; the gradients
    of k calls accumulate, each scaled by 1/k, and every k-th call steps
    the optimizer once on their mean (optax.MultiSteps in the JAX package).
    reduce: under data parallelism, called with the step's loss between the
    backward and the optimizer step (on every k-th call): it averages the
    mappers' gradients over the ranks and returns the mean loss, which the
    step returns (parallel/dist.py all_reduce_step_).

    Returns step(models, batch, draws) -> {"total_loss": fp32 scalar}, with
    models the builder's BuiltModels (text, unet, vae, schedule,
    pixel_cache). The mappers' gradients stay in their .grad after the
    step.
    """
    if augment is not None and from_moments:
        raise ValueError("device augmentation and the latent cache are "
                         "mutually exclusive")
    if cache_pixels and augment is None and not from_moments:
        raise ValueError("cache_pixels requires device augmentation or "
                         "the latent cache")
    micro = [0]

    def step(models, batch: TrainBatch, draws: StepDraws):
        latents = encode_latents(models, batch, draws, compute_dtype,
                                 from_moments, augment)
        loss = diffusion_loss(models, batch, draws, latents, compute_dtype)
        if micro[0] == 0:
            optimizer.zero_grad()
        (loss / accumulation_steps if accumulation_steps > 1
         else loss).backward()
        micro[0] = (micro[0] + 1) % accumulation_steps
        loss = loss.detach()
        if micro[0] == 0:
            if reduce is not None:
                loss = reduce(loss)
            optimizer.step()
        return {"total_loss": loss}

    return step
