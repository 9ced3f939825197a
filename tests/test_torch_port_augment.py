"""The port's augmentation on the card's path (ops/device_augment.py) against
the JAX package's, on the CPU in fp32.

JAX draws the augmentation's random numbers from a key inside its step; the
port takes them as data. These tests derive the port's AugmentDraws from a
JAX key exactly as the JAX code splits it (augment_batch :415, augment_one
:401, _color_jitter :141, _gaussian_blur :183, _affine_warp :279, and JAX's
own _sample_crop_box for the box), so both sides augment with the same
numbers. The train step with augment=preset 7 and the uint8 pixel cache is
held against JAX's make_train_step(augment=..., cache_pixels=True) over two
steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from view_neti_tpu.data import augment as jaug
from view_neti_tpu.ops import device_augment as jda
from view_neti_tpu.training.train_step import make_train_step as j_make_step
from view_neti_tpu.training import optim as joptim

from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.data import augment as taug
from view_neti_tpu_torch.ops import device_augment as tda
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import optim as toptim
from view_neti_tpu_torch.training import train_step as tts

import test_torch_port_train as base


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's 8-thread parallel regions
    spend most of their time waiting for cores; on one thread they do
    not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x).copy())
    return t.to(dtype) if dtype is not None else t


def _t_spec(jspec) -> tda.AugmentSpec:
    return tda.AugmentSpec(**dataclasses.asdict(jspec))


def draws_from_jax_key(jspec, key, B, H, W) -> tda.AugmentDraws:
    """The draws JAX's augment_batch(spec, key, imgs) uses, per sample."""
    fields = {f.name: [] for f in dataclasses.fields(tda.AugmentDraws)}
    b_, c_, s_, h_ = jspec.jitter_strength
    for key_b in jax.random.split(key, B):
        kj, kg, kb, kw = jax.random.split(key_b, 4)
        kgj, kbj, kc, ks, kh, kp = jax.random.split(kj, 6)
        uni = jax.random.uniform
        fields["brightness"].append(uni(kbj, (), minval=max(0.0, 1 - b_),
                                        maxval=1 + b_))
        fields["contrast"].append(uni(kc, (), minval=max(0.0, 1 - c_),
                                      maxval=1 + c_))
        fields["saturation"].append(uni(ks, (), minval=max(0.0, 1 - s_),
                                        maxval=1 + s_))
        fields["hue"].append(uni(kh, (), minval=-h_, maxval=h_))
        fields["jitter_order"].append(jax.random.permutation(kgj, 4))
        fields["jitter_applied"].append(uni(kp) < jspec.jitter_p)
        fields["gray_applied"].append(uni(kg) < jspec.gray_p)
        kbp, kbs = jax.random.split(kb)
        fields["blur_sigma"].append(uni(kbs, (), minval=jspec.blur_sigma[0],
                                        maxval=jspec.blur_sigma[1]))
        fields["blur_applied"].append(uni(kbp) < jspec.blur_p)
        kr, krp, ka, kar, ki, kjj, kf = jax.random.split(kw, 7)
        theta = jnp.float32(0.0)
        if jspec.rot_p > 0:
            theta = uni(kr, (), minval=-jspec.rot_degrees,
                        maxval=jspec.rot_degrees) * (jnp.pi / 180.0)
            theta = jnp.where(uni(krp) < jspec.rot_p, theta, 0.0)
        fields["theta"].append(theta)
        if jspec.crop_p > 0:
            i, j, bh, bw = jda._sample_crop_box(ka, kar, ki, kjj, H, W,
                                                jspec)
            if jspec.crop_p < 1.0:
                on = uni(jax.random.fold_in(ka, 1)) < jspec.crop_p
                bh, bw = jnp.where(on, bh, H), jnp.where(on, bw, W)
                i, j = jnp.where(on, i, 0.0), jnp.where(on, j, 0.0)
        else:
            i = j = jnp.float32(0.0)
            bh, bw = jnp.float32(H), jnp.float32(W)
        for name, v in (("crop_i", i), ("crop_j", j), ("crop_h", bh),
                        ("crop_w", bw)):
            fields[name].append(v)
        fields["flip"].append(uni(kf) < jspec.flip_p if jspec.flip_p > 0
                              else jnp.bool_(False))
    out = {}
    for name, vals in fields.items():
        arr = np.stack([np.asarray(v) for v in vals])
        if arr.dtype == np.bool_:
            out[name] = _t(arr)
        elif name == "jitter_order":
            out[name] = _t(arr, torch.int64)
        else:
            out[name] = _t(arr.astype(np.float32))
    return tda.AugmentDraws(**out)


def test_presets_and_specs_match_jax():
    assert taug.AUGMENTATION_PRESETS == jaug.AUGMENTATION_PRESETS
    for key in range(1, 9):
        for flip in (0.0, 0.5):
            j = jda.from_augmentation_key(key, flip)
            t = tda.from_augmentation_key(key, flip)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tda.from_augmentation_key(0) is None
    assert jda.from_augmentation_key(0) is None
    assert (dataclasses.asdict(tda.from_augmentation_key(0, 0.5))
            == dataclasses.asdict(jda.from_augmentation_key(0, 0.5)))
    with pytest.raises(ValueError):
        tda.from_augmentation_key(9)


FLIP_ONLY = jda.AugmentSpec(flip_p=0.5)


@pytest.mark.parametrize("H,W", [(24, 32), (48, 64)])
@pytest.mark.parametrize("spec_name", ["preset7", "preset1", "preset6",
                                       "flip"])
def test_augment_batch_matches_jax(spec_name, H, W):
    """The same function on the same draws: max abs <= 1e-5 on [-1, 1]
    (fp32 on both sides; the sums of the luma and of the blur weights may
    round in another order)."""
    jspec = (FLIP_ONLY if spec_name == "flip"
             else jda.from_augmentation_key(int(spec_name[-1])))
    B = 4
    rng = np.random.RandomState(H + W + len(spec_name))
    imgs = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    # every op fires on some samples: find a key whose draws apply each of
    # the spec's ops at least once and skip it on at least one sample
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        draws = draws_from_jax_key(jspec, key, B, H, W)
        flags = [draws.flip] if spec_name == "flip" else [
            draws.jitter_applied, draws.theta != 0]
        if all(0 < int(f.sum()) < B for f in flags):
            break
    want = np.asarray(jda.augment_batch(jspec, key, jnp.asarray(imgs)))
    got = tda.augment_batch(_t_spec(jspec), draws, _t(imgs))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the draws were not all no-ops
    plain = imgs.astype(np.float32) / 255.0 * 2 - 1
    assert np.abs(want - plain).max() > 0.05


def test_augment_is_identity_without_ops_and_flips_exactly():
    """A spec that only flips, with every sample flipped, mirrors the
    uint8 input exactly; with none flipped it returns the input."""
    imgs = _t(np.random.RandomState(1).randint(0, 256, (3, 8, 12, 3))
              .astype(np.uint8))
    spec = tda.AugmentSpec(flip_p=1.0)
    draws = tda.sample_augment_draws(torch.Generator().manual_seed(0),
                                     spec, 3, 8, 12)
    assert bool(draws.flip.all())
    plain = imgs.float() / 255.0 * 2 - 1
    torch.testing.assert_close(tda.augment_batch(spec, draws, imgs),
                               plain.flip(2), atol=1e-6, rtol=0)
    draws.flip[:] = False
    torch.testing.assert_close(tda.augment_batch(spec, draws, imgs), plain,
                               atol=1e-6, rtol=0)


# ------------------------------------------------ the port's sampler ----

def _port_boxes(spec, H, W, n=2000, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [x.numpy() for x in tda.sample_crop_box(g, spec, n, H, W)]


def test_port_sampler_preset7_aspect_stays_in_ratio_bounds():
    """tests/test_device_augment.py's crop-box rules, on the port's own
    sampler over 2000 draws."""
    spec = tda.from_augmentation_key(7)
    H, W = 384, 512
    i, j, bh, bw = _port_boxes(spec, H, W)
    ratio = bw / bh
    r0, r1 = spec.crop_ratio
    assert (ratio >= r0 - 1e-4).all() and (ratio <= r1 + 1e-4).all()
    assert (bw <= W + 1e-3).all() and (bh <= H + 1e-3).all()
    assert (i >= -1e-3).all() and (j >= -1e-3).all()
    assert (i + bh <= H + 1e-3).all() and (j + bw <= W + 1e-3).all()


def test_port_sampler_fallback_clamps_aspect_to_ratio_edge():
    spec = tda.AugmentSpec(crop_p=1.0, crop_scale=(0.7, 1.3),
                           crop_ratio=(3 / 4, 4 / 3))
    i, j, bh, bw = _port_boxes(spec, 512, 64, n=100)
    assert np.allclose(bw / bh, 3 / 4, atol=1e-4)
    assert np.allclose(bw, 64.0, atol=1e-3)
    assert np.allclose(i, (512.0 - bh) * 0.5, atol=1e-3)
    assert np.allclose(j, 0.0, atol=1e-3)


def test_port_sampler_in_bounds_draws_keep_aspect_spread():
    spec = tda.AugmentSpec(crop_p=1.0, crop_scale=(0.3, 0.7),
                           crop_ratio=(3 / 4, 4 / 3))
    _, _, bh, bw = _port_boxes(spec, 384, 512)
    ratio = bw / bh
    assert ratio.std() > 0.05
    assert (ratio > 0.8).any() and (ratio < 1.25).any()


def test_port_draws_follow_the_spec_rates():
    """Preset 7 over 2000 samples: jitter applied at 0.75, blur at 0.2,
    rotation at 0.75 within |theta| <= 10 degrees, no grayscale, no flip,
    each op order a permutation (5 binomial standard deviations)."""
    n = 2000
    spec = tda.from_augmentation_key(7)
    d = tda.sample_augment_draws(torch.Generator().manual_seed(3), spec, n,
                                 384, 512)
    for flag, p in ((d.jitter_applied, 0.75), (d.blur_applied, 0.2),
                    (d.theta != 0, 0.75)):
        assert abs(flag.float().mean().item() - p) <= 5 * (p * (1 - p) / n
                                                           ) ** 0.5
    assert not d.gray_applied.any() and not d.flip.any()
    assert d.theta.abs().max().item() <= np.radians(10) + 1e-6
    assert (d.jitter_order.sort(dim=1).values
            == torch.arange(4)).all()
    assert 0.96 <= d.brightness.min().item() and d.brightness.max() <= 1.04
    assert (d.blur_sigma >= 0.1).all() and (d.blur_sigma <= 0.2).all()


# ---------------------------------------------- the augmented step ----

IMG_H, IMG_W, N_BASES = 16, 32, 5


@pytest.fixture(scope="module")
def augmented_trajectories(tmp_path_factory):
    """Both stacks (built as tests/test_torch_port_train.py builds them),
    two steps each of the preset-7 step over a uint8 base cache indexed
    by the batch."""
    jb, tb, jbatch, tbatch, B = base.build_both_stacks(tmp_path_factory)
    rng = np.random.RandomState(7)
    bases = rng.randint(0, 256, (N_BASES, IMG_H, IMG_W, 3)).astype(np.uint8)
    idx = np.array([3, 0][:B] + [1] * max(0, B - 2), np.int32)
    jspec = jda.from_augmentation_key(7)
    frozen = dataclasses.replace(jb.frozen, pixel_cache=jnp.asarray(bases))
    jbatch = dataclasses.replace(jbatch, pixel_values=jnp.asarray(idx))
    # a pass-through transformation ahead of the sliced AdamW keeps each
    # step's gradients in the optimizer state, as in test_torch_port_train
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    sched = joptim.make_lr_schedule("constant", base.LR, 0, 10)
    jopt = optax.chain(record, joptim.sliced_adamw(sched))
    jstep = jax.jit(j_make_step(jopt, augment=jspec, cache_pixels=True))
    trainable = jb.trainable
    jstate = jopt.init(trainable)

    tb.pixel_cache = _t(bases)
    tbatch = dataclasses.replace(tbatch, pixel_values=_t(idx, torch.int64))
    tstep = tts.make_train_step(
        toptim.SlicedAdamW(tbuilder.trainable_groups(tb),
                           toptim.make_lr_schedule("constant", base.LR, 0,
                                                   10)),
        augment=_t_spec(jspec), cache_pixels=True)
    out = {"jax": [], "port": []}
    text = jb.frozen.text
    for s in range(2):
        key = jax.random.PRNGKey(200 + s)
        r_vae, r_noise, r_t, _, r_aug = jax.random.split(key, 5)
        lat = (B, IMG_H // 2, IMG_W // 2, 4)
        draws = tts.StepDraws(
            vae_eps=_t(jax.random.normal(r_vae, lat, jnp.float32)),
            noise=_t(jax.random.normal(r_noise, lat, jnp.float32)),
            timesteps=_t(jax.random.randint(r_t, (B,), 0, 1000), torch.int64),
            augment=draws_from_jax_key(jspec, r_aug, B, IMG_H, IMG_W))
        trainable, jstate, metrics = jstep(trainable, jstate, frozen,
                                           jbatch, key)
        consts = (base._np(text.obj_constants),
                  base._np(text.view_constants))
        jp = twp.from_jax_trainable(base._np(trainable), *consts)
        jg = twp.from_jax_trainable(base._np(jstate[0]), *consts)
        out["jax"].append(dict(
            loss=float(metrics["total_loss"]),
            grads={"object": jg["object"][0], "view": jg["view"]},
            params={"object": jp["object"][0], "view": jp["view"]}))
        loss = tstep(tb, tbatch, draws)["total_loss"]
        named = {"object": tb.text.obj_mappers[0],
                 "view": tb.text.view_mapper}
        out["port"].append(dict(
            loss=float(loss),
            params={k: {n: p.detach().clone()
                        for n, p in m.named_parameters()}
                    for k, m in named.items()}))
    return out


def test_augmented_cached_step_losses_match_jax(augmented_trajectories):
    """The fp32 losses of both steps: 1e-4 relative, the tolerance of
    tests/test_torch_port_train.py's step."""
    out = augmented_trajectories
    for j, t in zip(out["jax"], out["port"]):
        assert np.isfinite(t["loss"])
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)


def test_augmented_cached_step_parameters_match_jax(augmented_trajectories):
    """The mapper parameters after each step, at the rule of
    tests/test_torch_port_train.py: within 2e-2 lr where |g| > 1e-3 max|g|
    at every step so far (AdamW's first update is about -lr sign(g), which
    rounding can flip where g is tiny), elsewhere within 2 lr per step."""
    out = augmented_trajectories
    for s in range(2):
        for key in ("object", "view"):
            for name, got in out["port"][s]["params"][key].items():
                want = out["jax"][s]["params"][key][name].numpy()
                big = np.ones(want.shape, bool)
                for k in range(s + 1):
                    g = np.abs(out["jax"][k]["grads"][key][name].numpy())
                    big &= g > 1e-3 * g.max()
                diff = np.abs(got.numpy() - want)
                assert big.mean() > 0.5, (key, name)
                assert diff[big].max() <= 2e-2 * base.LR, (key, name)
                assert diff.max() <= 2 * base.LR * (s + 1) + 1e-6, (key,
                                                                    name)


def test_step_rejects_invalid_augment_combinations():
    opt = toptim.SlicedAdamW(
        {"view": [[torch.nn.Parameter(torch.zeros(2))]]}, lambda s: 1e-3)
    with pytest.raises(ValueError):
        tts.make_train_step(opt, from_moments=True,
                            augment=tda.from_augmentation_key(7))
    with pytest.raises(ValueError):
        tts.make_train_step(opt, cache_pixels=True)
