"""The UNet's ResNet convs through the fused conv (UNetConfig.fuse_conv, the
inference paths' switch) against the JAX package, on the CPU.

The JAX UNet with fuse_conv=True runs its Pallas kernel in interpret mode,
the port's UNet the kernel's plain version (CPU tensors); the tree is
carried across with weight_port.from_jax_unet and loaded strictly. Also
here: fused against unfused in the port (fp32 and bf16), the state_dict,
the refusal under grad, the default paths that keep the UNet unfused, and
chip_smoke.py's K4 rows of the fused-UNet serving path against what the
full-width UNet launches.
"""
import collections
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from view_neti_tpu.models.unet import UNet2DCondition as JUNet
from view_neti_tpu.models.unet import tiny_unet_config as j_tiny_unet
from view_neti_tpu.ops import fused_conv as jfc

from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.models import unet as unet_mod
from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                             sd15_unet_config,
                                             sd21_unet_config,
                                             tiny_unet_config)
from view_neti_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
from view_neti_tpu_torch.ops import fused_conv as tfc
from view_neti_tpu_torch.training import builder
from view_neti_tpu_torch.training.coach import Coach

from test_torch_port_coach import make_tree, tiny_cfg
from test_torch_port_models import _random_params

B, L = 2, 5
# fused against unfused in bf16: K4 rounds once from fp32 sums, where
# GroupNorm, SiLU, the conv and the time-embedding add each round to bf16;
# the two differ by such roundings carried through 22 blocks. The limit on
# the relative RMS of the difference of the UNet's outputs
BF16_REL_LIMIT = 5e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's parallel regions spend most
    of their time waiting for cores; on one thread they do not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX UNet with fuse_conv=True on random parameters and inputs:
    (params, inputs, output, the kernel's calls in its trace). The param
    tree is the unfused module's (the same either way). Its kernel wrapper
    is jitted per shape, so that the 44 calls of a forward trace the
    interpret-mode kernel once for each of their shapes; jit changes
    nothing in what it computes."""
    jcfg = j_tiny_unet(use_flash_attention=False)
    D = jcfg.cross_attention_dim
    shapes = jax.eval_shape(
        JUNet(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,)), jnp.zeros((16, 1, L, D)), jnp.zeros((16, 1, L, D)))
    params = _random_params(shapes["params"], seed=21)
    rng = np.random.RandomState(21)
    inputs = (rng.randn(B, 8, 8, 4).astype(np.float32),
              np.array([17.0, 503.0], np.float32),
              rng.randn(16, B, L, D).astype(np.float32),
              rng.randn(16, B, L, D).astype(np.float32))
    kernel = jax.jit(jfc.fused_affine_silu_conv3x3,
                     static_argnames=("out_dtype", "interpret"))
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return kernel(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfc, "fused_affine_silu_conv3x3", counted)
        fused = JUNet(dataclasses.replace(jcfg, fuse_conv=True))
        out = jax.jit(fused.apply)({"params": params}, *inputs)
    return params, inputs, np.asarray(out), calls[0]


def _port(params, fuse, dtype=torch.float32):
    unet = UNet2DCondition(tiny_unet_config(fuse_conv=fuse))
    unet.load_state_dict(twp.from_jax_unet(params), strict=True)
    builder.cast_compute_dtype_(unet, dtype)
    return unet.eval().requires_grad_(False)


def _run(unet, inputs):
    with torch.no_grad():
        return unet(*(torch.from_numpy(x) for x in inputs))


def test_fused_unet_matches_jax_fused(jax_run):
    """B = 2, fp32: the JAX UNet's 44 fused sections (the Pallas kernel in
    interpret mode; at B = 2 JAX's `fusable` gate fuses every tiny one)
    against the port's through the plain K4."""
    params, inputs, want, calls = jax_run
    assert calls == 44
    got = _run(_port(params, True), inputs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def _rel(got, want):
    return ((got.float() - want.float()).square().mean().sqrt()
            / want.float().square().mean().sqrt()).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matches_unfused(jax_run, dtype, monkeypatch):
    """The port's UNet with and without fuse_conv on the same weights: fp32
    within 2e-4; bf16 within BF16_REL_LIMIT of the unfused output's RMS, a
    limit that the last block's conv2 without its residual exceeds."""
    params, inputs, _, _ = jax_run
    dt = getattr(torch, dtype)
    unfused = _port(params, False, dt)
    fused = copy.copy(unfused)
    fused.config = dataclasses.replace(unfused.config, fuse_conv=True)
    want, got = _run(unfused, inputs), _run(fused, inputs)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
        return
    assert _rel(got, want) <= BF16_REL_LIMIT
    plain = tfc.fused_affine_silu_conv3x3
    seen = [0]

    def dropped_last_residual(*args, **kwargs):
        if kwargs.get("residual") is not None:
            seen[0] += 1
            if seen[0] == 22:
                kwargs["residual"] = None
        return plain(*args, **kwargs)

    monkeypatch.setattr(unet_mod, "fused_affine_silu_conv3x3",
                        dropped_last_residual)
    fault = _run(fused, inputs)
    assert seen[0] == 22
    assert _rel(fault, want) > BF16_REL_LIMIT


@pytest.mark.parametrize("make", [sd15_unet_config, sd21_unet_config,
                                  tiny_unet_config])
def test_state_dict_is_the_same_fused_or_not(make, jax_run):
    """The switch changes no parameter: the same diffusers keys and shapes
    at full width, and a state_dict loads strictly either way."""
    with torch.device("meta"):
        shapes = [{k: v.shape for k, v in UNet2DCondition(
            make(fuse_conv=fuse)).state_dict().items()}
            for fuse in (False, True)]
    assert shapes[0] == shapes[1] and "up_blocks.0.resnets.0.conv1.weight" \
        in shapes[0]
    if make is tiny_unet_config:
        params = jax_run[0]
        for src, dst in ((True, False), (False, True)):
            sd = _port(params, src).state_dict()
            UNet2DCondition(tiny_unet_config(fuse_conv=dst)).load_state_dict(
                sd, strict=True)


def test_fused_unet_is_forward_only(jax_run):
    """The kernel refuses inputs that require grad while grad mode is on:
    the fused UNet raises where a context needs a gradient (the train
    step's), and runs under no_grad."""
    params, inputs, _, _ = jax_run
    fused = _port(params, True)
    lat, t, ctx, byp = (torch.from_numpy(x) for x in inputs)
    ctx.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused(lat, t, ctx, byp)
    with torch.no_grad():
        assert torch.isfinite(fused(lat, t, ctx, byp)).all()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("dtu"))


def test_default_paths_keep_the_unet_unfused(tree, tmp_path):
    """fuse_for_inference fuses the VAE alone unless given a UNet; given a
    view of the UNet (a shallow copy) it fuses the view alone, on the same
    parameters. The Coach with fuse_conv on (the card's default) fuses the
    VAE for training and for its inference view (validation, offline
    inference, mode 3, the folders path) and keeps the UNet unfused, as
    the JAX Coach does."""
    g = torch.Generator().manual_seed(0)
    unet = builder._make(UNet2DCondition, tiny_unet_config(), "cpu", g,
                         torch.float32)
    vae = builder._make(AutoencoderKL, tiny_vae_config(), "cpu", g,
                        torch.float32)
    assert builder.fuse_for_inference(vae) is vae
    assert vae.config.fuse_conv and not unet.config.fuse_conv
    view = copy.copy(unet)
    builder.fuse_for_inference(vae, unet=view)
    assert view.config.fuse_conv and not unet.config.fuse_conv
    assert view.conv_in.weight is unet.conv_in.weight
    assert view.state_dict().keys() == unet.state_dict().keys()

    rect, cal = tree
    coach = Coach(decode(RunConfig, tiny_cfg(rect, tmp_path / "on",
                                             fuse_conv=True)),
                  arch=builder.tiny_arch(), calibration_dir=str(cal),
                  device="cpu")
    assert coach.fuse_conv is True
    assert coach.built.vae.config.fuse_conv is True
    assert coach.built.unet.config.fuse_conv is False
    inf_unet, inf_vae = coach.infer_frozen()
    assert inf_vae.config.fuse_conv is True
    assert inf_unet is coach.built.unet and not inf_unet.config.fuse_conv


def _launched_shapes(monkeypatch):
    """Every fused section of an SD-1.5 UNet forward at the serving shapes
    (B = 6 at 72x96 latents), traced on the meta device: {(B, H, W, Cin,
    Cout, epilogue): count}."""
    seen = collections.Counter()

    def record(x, a, b, kernel, bias=None, add_bc=None, residual=None,
               out_dtype=None):
        epi = (" +t" if add_bc is not None
               else " +res" if residual is not None else "")
        seen[tuple(x.shape) + (kernel.shape[3], epi)] += 1
        return torch.empty(x.shape[:3] + (kernel.shape[3],), dtype=out_dtype,
                           device=x.device)

    monkeypatch.setattr(unet_mod, "fused_affine_silu_conv3x3", record)
    monkeypatch.setattr(unet_mod, "multi_head_attention",
                        lambda q, k, v: torch.empty_like(q))
    with torch.device("meta"):
        unet = UNet2DCondition(sd15_unet_config(fuse_conv=True))
        unet(torch.empty(chip_smoke.BATCH, chip_smoke.HEIGHT // 8,
                         chip_smoke.WIDTH // 8, 4),
             torch.empty(chip_smoke.BATCH), torch.empty(6, 77, 768))
    return seen


def test_chip_smokes_unet_rows_are_the_fused_forwards(monkeypatch):
    """chip_smoke.py's K4 rows of the fused-UNet serving path are the 18
    shapes an SD-1.5 forward launches, 44 launches a forward, each on the
    Hopper design; the path's counts by design in k4_shapes (the fused
    forwards and the decode) are the launch checks' (path_k4)."""
    steps = 7
    rows = chip_smoke.unet_k4_shapes(steps)
    got = {r[:6]: r[6]["serve_fused_unet"] // steps for r in rows}
    assert len(rows) == len(got) == 18
    assert got == _launched_shapes(monkeypatch)
    assert sum(got.values()) == chip_smoke.K4_UNET_SM90 == 44
    assert {tfc.conv_design(r[3], r[4]) for r in rows} == {"sm90"}
    assert all(set(r[6]) == {"serve_fused_unet"} for r in rows)
    split = chip_smoke.conv_split_by_path(chip_smoke.k4_shapes(steps),
                                          tfc.conv_design)
    want = chip_smoke.path_k4(steps)
    assert split["serve_fused_unet"] == chip_smoke.capture_record(
        want["serve_fused_unet"]) == {"K4": 44 * steps + 29,
                                      "K4 sm90": 44 * steps + 28,
                                      "K4 mma_sync": 1}
    assert want["serve"] == chip_smoke.k4(decodes=1)
    assert chip_smoke.k4_unet(2) == {"K4": 88, "K4 sm90": 88,
                                     "K4 mma_sync": 0}
