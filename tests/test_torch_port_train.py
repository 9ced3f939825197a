"""The training slice of view_neti_tpu_torch against the JAX package, on the
CPU in fp32.

Inputs come from numpy with a seed. The flash-attention backward's plain
version is held against the Pallas backward (jax.grad through the
custom_vjp, in interpret mode); the VAE encode, the nested dropout, the
DDPM schedule and the sliced AdamW against their JAX counterparts; and the
whole mode-2 train step, on a tiny stack built by the JAX package and
carried across with weight_port, against the JAX make_train_step fed the
same draws (derived from its key the way its step splits it). The kernels
themselves (K1-K4) need the card: test_torch_port_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from view_neti_tpu.config import RunConfig as JRunConfig, decode
from view_neti_tpu.data import dtu as jdtu
from view_neti_tpu.models.vae import AutoencoderKL as JVAE
from view_neti_tpu.models.vae import tiny_vae_config as j_tiny_vae
from view_neti_tpu.ops import flash_attention as jfa
from view_neti_tpu.schedulers.ddpm import DDPMSchedule as JDDPM
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok
from view_neti_tpu.training import builder as jbuilder
from view_neti_tpu.training import optim as joptim
from view_neti_tpu.training.train_step import TrainBatch as JBatch
from view_neti_tpu.training.train_step import make_train_step as j_make_step

from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
from view_neti_tpu_torch.models import neti_mapper as tnm
from view_neti_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
from view_neti_tpu_torch.ops import flash_attention as tfa
from view_neti_tpu_torch.ops.attention import multi_head_attention
from view_neti_tpu_torch.schedulers.ddpm import DDPMSchedule
from view_neti_tpu_torch.tokenizer import FallbackTokenizer
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import optim as toptim
from view_neti_tpu_torch.training import train_step as tts


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's 8-thread parallel regions
    spend most of their time waiting for cores; on one thread they do
    not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------- flash attention bwd ----

def _attention_inputs(B, Lq, Lk, H, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((B, Lq, H, d), (B, Lk, H, d), (B, Lk, H, d),
                          (B, Lq, H, d))]


# an odd Lq (the TPU wrapper pads q to 128), Lk = 77 (cross-attention,
# masked keys past 77 in the padded kv), a ragged self-attention, and the
# head dims of SD-1.5's first two levels
@pytest.mark.parametrize("Lq,Lk,d", [(133, 77, 40), (67, 77, 80),
                                     (133, 133, 80)])
def test_flash_attention_bwd_ref_matches_pallas_backward(Lq, Lk, d):
    """fp32 on both sides, the same recomputation in another summation
    order: 2e-5 absolute on gradients of size <= 1."""
    q, k, v, do = _attention_inputs(1, Lq, Lk, 2, d, seed=Lq + Lk + d)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, interpret=True) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_ref(tq, tk, tv)
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("need", ["qkv", "kv"])
def test_flash_attention_function_gradients(need):
    """FlashAttention.apply's backward (the plain version on a CPU tensor)
    against flash_attention_bwd_ref (exactly: the same function) and
    against autograd through the plain forward (1e-5: softmax's own
    backward sums in another order). With q frozen, as at the UNet's first
    cross-attention, q gets no gradient."""
    arrays = _attention_inputs(2, 37, 77, 2, 40, seed=5)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    leaves = [t.clone().requires_grad_(name in need)
              for name, t in zip("qkv", (q, k, v))]
    (multi_head_attention(*leaves) * do).sum().backward()
    o, lse = tfa.flash_attention_ref(q, k, v)
    ref = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (tfa.flash_attention_ref(*plain)[0] * do).sum().backward()
    for name, leaf, r, p in zip("qkv", leaves, ref, plain):
        if name not in need:
            assert leaf.grad is None
            continue
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)
        torch.testing.assert_close(leaf.grad, p.grad, rtol=0, atol=1e-5)


@pytest.mark.parametrize("Lq,Lk", [(37, 77), (64, 64)])
def test_backward_wrappers_take_the_plain_version_on_the_cpu(Lq, Lk):
    """K2's and K3's wrappers on CPU tensors: the plain version, exactly
    flash_attention_bwd_ref's (dq) and (dk, dv)."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _attention_inputs(2, Lq, Lk, 3, 16, seed=Lq))
    o, lse = tfa.flash_attention_ref(q, k, v)
    delta = tfa.attention_delta(o, do)
    assert delta.shape == (2, 3, Lq)
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    got = (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
           *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------- VAE encode ----

def _random_vae_params(shapes, seed):
    """Kernels N(0, 1/fan_in), biases 0.1 N(0, 1), norm scales 1 + 0.1 N."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
                continue
            if name == "kernel":
                v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
            elif name == "scale":
                v = 1 + 0.1 * rng.randn(*leaf.shape)
            else:
                v = 0.1 * rng.randn(*leaf.shape)
            out[name] = v.astype(np.float32)
        return out
    return fill(shapes)


@pytest.mark.parametrize("fuse", [False, True])
def test_vae_encode_matches_jax(fuse):
    """moments, encode_sample with JAX's own eps (drawn from the key as its
    encode_sample draws it) and encode_mode, fp32: 2e-4. The JAX encoder
    runs unfused; with fuse=True the port runs every section through the
    fused conv's plain version (which test_torch_port_ops holds against the
    Pallas kernel)."""
    jvae = JVAE(j_tiny_vae())
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(1))
    params = _random_vae_params(shapes["params"], seed=11)
    tvae = AutoencoderKL(tiny_vae_config(fuse_conv=fuse))
    tvae.load_state_dict(twp.from_jax_vae(params, num_blocks=2), strict=True)
    tvae.requires_grad_(False)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 16, 12, 3)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    variables = {"params": params}
    key = jax.random.PRNGKey(3)
    jmom = jvae.apply(variables, x, method=JVAE.moments)
    eps = jax.random.normal(key, jmom.shape[:-1] + (4,), jmom.dtype)
    want = {"moments": jmom,
            "sample": jvae.apply(variables, x, key,
                                 method=JVAE.encode_sample),
            "mode": jvae.apply(variables, x, method=JVAE.encode_mode)}
    with torch.no_grad():
        got = {"moments": tvae.moments(tx),
               "sample": tvae.encode_sample(tx, torch.tensor(
                   np.asarray(eps))),
               "mode": tvae.encode_mode(tx)}
    assert got["moments"].shape == (2, 8, 6, 8)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=2e-4, rtol=2e-4, err_msg=name)


# ------------------------------------------------------ nested dropout ----

def test_nested_dropout_with_fed_draws_matches_the_formula():
    """The JAX mapper's train-time rule (neti_mapper.py:257-261):
    where(apply, h * (pos < idx), h), exactly."""
    rng = np.random.RandomState(2)
    h = rng.randn(40, 24).astype(np.float32)
    apply = rng.rand(40) < 0.5
    idx = rng.randint(0, 24, 40)
    pos = np.arange(24)[None, :]
    want = np.where(apply[:, None], h * (pos < idx[:, None]), h)
    got = tnm.nested_dropout(torch.from_numpy(h),
                             (torch.from_numpy(apply),
                              torch.from_numpy(idx)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mapper_applies_fed_dropout_draws_in_training():
    """The draws reach the mapper's hidden vector: dropping nothing leaves
    the output as without draws, dropping everything equals the mapper
    truncated at 0, and the draws take the place of truncation_idx."""
    m = tnm.NeTIMapper("object", output_dim=16, arch_mlp_hidden_dims=24,
                       arch_view_net=15, normalize_output=False)
    m.reset_parameters_(torch.Generator().manual_seed(0))
    t = torch.tensor([10.0, 500.0, 990.0])
    layer = torch.tensor([0.0, 7.0, 15.0])
    none = (torch.zeros(3, dtype=torch.bool), torch.zeros(3,
                                                          dtype=torch.long))
    every = (torch.ones(3, dtype=torch.bool), torch.zeros(3,
                                                          dtype=torch.long))
    with torch.no_grad():
        plain = m(t, layer).word_embedding
        cut = m(t, layer, truncation_idx=0).word_embedding
        torch.testing.assert_close(
            m(t, layer, truncation_idx=0, dropout=none).word_embedding,
            plain, rtol=0, atol=0)
        torch.testing.assert_close(m(t, layer, dropout=every).word_embedding,
                                   cut, rtol=0, atol=0)


def test_port_nested_dropout_draws_are_bernoulli_and_uniform():
    """Within 5 binomial standard deviations: the share of dropped rows
    around 0.5, and each of the 64 cut positions around N / 64."""
    N, dim = 64_000, 64
    apply, idx = tnm.sample_nested_dropout(torch.Generator().manual_seed(1),
                                           N, dim, 0.5)
    assert apply.dtype == torch.bool and idx.shape == (N,)
    assert abs(apply.float().mean().item() - 0.5) <= 5 * (0.25 / N) ** 0.5
    counts = torch.bincount(idx, minlength=dim)
    assert counts.numel() == dim and int(idx.min()) >= 0
    p = 1 / dim
    sd = (N * p * (1 - p)) ** 0.5
    assert (counts.float() - N * p).abs().max().item() <= 5 * sd


# ----------------------------------------------------------- schedule ----

@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_ddpm_schedule_matches_jax(pred):
    j, t = JDDPM(prediction_type=pred), DDPMSchedule(prediction_type=pred)
    np.testing.assert_array_equal(t.alphas_cumprod.numpy(),
                                  j.alphas_cumprod)
    rng = np.random.RandomState(6)
    x0 = rng.randn(3, 4, 5, 4).astype(np.float32)
    eps = rng.randn(3, 4, 5, 4).astype(np.float32)
    ts = np.array([0, 517, 999])
    tx0, teps, tts_ = (torch.from_numpy(a) for a in (x0, eps, ts))
    for fn in ("add_noise", "get_velocity", "target"):
        want = getattr(j, fn)(jnp.asarray(x0), jnp.asarray(eps),
                              jnp.asarray(ts))
        got = getattr(t, fn)(tx0, teps, tts_)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6, err_msg=fn)


# ---------------------------------------------------------- optimizer ----

@pytest.mark.parametrize("kind", ["constant_with_warmup", "cosine"])
def test_lr_schedule_matches_jax(kind):
    j = joptim.make_lr_schedule(kind, 0.02, 3, 10)
    t = toptim.make_lr_schedule(kind, 0.02, 3, 10)
    for step in range(12):
        assert abs(t(step) - float(j(jnp.asarray(step)))) <= 1e-8


def test_sliced_adamw_matches_jax_over_three_steps():
    """A mode-3-style bank of two object slices and a view mapper. Step 2
    leaves slice 1 without gradient, step 3 slice 0 and the view mapper:
    those get no moment decay, no weight decay and no count, and the bank's
    learning rate follows its largest count. fp32 on both sides: 1e-6."""
    rng = np.random.RandomState(8)
    shapes = {"object": {"w": (2, 5, 3), "b": (2, 3)}, "view": {"w": (4, 4)}}
    params = {k: {n: rng.randn(*s).astype(np.float32) for n, s in v.items()}
              for k, v in shapes.items()}
    grads = []
    for step in range(3):
        g = {k: {n: rng.randn(*s).astype(np.float32) for n, s in v.items()}
             for k, v in shapes.items()}
        if step == 1:
            for n in g["object"]:
                g["object"][n][1] = 0
        if step == 2:
            for n in g["object"]:
                g["object"][n][0] = 0
            g["view"]["w"][:] = 0
        grads.append(g)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    jopt = joptim.sliced_adamw(
        joptim.make_lr_schedule("constant_with_warmup", 0.05, 2, 10), **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)

    # the port keeps the bank as one module per slice: one leaf per slice
    bank = {n: [torch.nn.Parameter(torch.from_numpy(a[i].copy()))
                for i in range(2)] for n, a in params["object"].items()}
    view = torch.nn.Parameter(torch.from_numpy(params["view"]["w"].copy()))
    slices = {"object": [[bank["w"][i], bank["b"][i]] for i in range(2)],
              "view": [[view]]}
    topt = toptim.SlicedAdamW(
        slices, toptim.make_lr_schedule("constant_with_warmup", 0.05, 2, 10),
        **kw)
    for g in grads:
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.zero_grad()
        for n in ("w", "b"):
            for i in range(2):
                bank[n][i].grad = torch.from_numpy(g["object"][n][i].copy())
        view.grad = torch.from_numpy(g["view"]["w"].copy())
        topt.step()
        for n in ("w", "b"):
            got = torch.stack([p.detach() for p in bank[n]]).numpy()
            np.testing.assert_allclose(got, np.asarray(jparams["object"][n]),
                                       atol=1e-6, rtol=0)
        np.testing.assert_allclose(view.detach().numpy(),
                                   np.asarray(jparams["view"]["w"]),
                                   atol=1e-6, rtol=0)
    assert topt.counts == {"object": [2, 2], "view": [2]}


def test_make_optimizer_reads_the_config():
    """scaled lr = base x accumulation x batch x processes, the frozen keys
    of the mode stay out."""
    p = [[torch.nn.Parameter(torch.zeros(2))]]
    cfg = OptimConfig(train_batch_size=9, gradient_accumulation_steps=3)
    opt = toptim.make_optimizer({"object": p, "view": p}, cfg, mode=5)
    assert opt.learning_rate(1) == pytest.approx(
        joptim.scaled_learning_rate(1e-3, True, 9, 3, 1))
    assert list(opt.counts) == ["object"]
    assert toptim.trainable_mask_keys(1) == jbuilder.trainable_mask_keys(1)


# ------------------------------------------------------ the whole step ----

MODEL = dict(arch_view_net=15, arch_view_disable_tl=False,
             word_embedding_dim=32, normalize_view_mapper_output=True,
             output_bypass_alpha_view=5.0, pe_sigma_exp_key=2,
             use_nested_dropout=False)
B, IMG, LR, STEPS = 2, 16, 1e-3, 3


def build_both_stacks(tmp_path_factory):
    """The tiny mode-2 stack built by the JAX package and the port's, with
    the JAX weights carried across, and one batch for each: (JAX built
    models, port built models, JAX batch, port batch, batch size)."""
    cal = tmp_path_factory.mktemp("cal")
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        m = rng.randn(3, 4) * 100
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r) for r in m))
    view_tokens = [jdtu.dtu_cam_params_to_token(
        rng.randn(3, 4).astype(np.float32) * 100, i)
        for i in jdtu.dtu_get_train_idxs(6)]
    jcfg = decode(JRunConfig, {"learnable_mode": 2, "model": MODEL,
                               "data": {"camera_representation": "dtu-12d",
                                        "dtu_subset": 6}})
    jb = jbuilder.build_models(jcfg, JTok(base_vocab_size=512), view_tokens,
                               ["<skull>"], arch=jbuilder.tiny_arch(),
                               calibration_dir=str(cal))
    tb = tbuilder.build_models(
        RunConfig(learnable_mode=2, model=ModelConfig(**MODEL)),
        FallbackTokenizer(base_vocab_size=512), view_tokens, ["<skull>"],
        arch=tbuilder.tiny_arch(), calibration_dir=str(cal), device="cpu")
    fz, text = jb.frozen, jb.frozen.text
    tb.text.clip.load_state_dict(twp.from_jax_clip_text(
        _np(text.clip_vars["params"]), num_layers=2), strict=True)
    tb.unet.load_state_dict(twp.from_jax_unet(_np(fz.unet_vars["params"])),
                            strict=True)
    tb.vae.load_state_dict(twp.from_jax_vae(_np(fz.vae_vars["params"]),
                                            num_blocks=2), strict=True)
    sds = twp.from_jax_trainable(_np(jb.trainable), _np(text.obj_constants),
                                 _np(text.view_constants))
    tb.text.obj_mappers[0].load_state_dict(sds["object"][0], strict=True)
    tb.text.view_mapper.load_state_dict(sds["view"], strict=True)
    tb.text.obj_norm_scales = torch.tensor(np.array(text.obj_norm_scales))
    tb.text.view_norm_scale = torch.tensor(float(text.view_norm_scale))

    # the batch of bench.py's layout: BOS, view token, filler, object token
    view_id = jb.placeholder_view_token_ids[0]
    obj_id = jb.placeholder_object_token_ids[0]
    tok = jb.tokenizer
    ids = np.full((B, 16), tok.eos_token_id, np.int64)
    ids[:, 0] = tok.bos_token_id
    ids[:, 1] = view_id
    ids[:, 2:7] = 100
    ids[:, 7] = obj_id
    pixels = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    jbatch = JBatch(pixel_values=jnp.asarray(pixels),
                    input_ids=jnp.asarray(ids, jnp.int32),
                    input_ids_placeholder_object=jnp.full((B,), obj_id,
                                                          jnp.int32),
                    input_ids_placeholder_view=jnp.full((B,), view_id,
                                                        jnp.int32),
                    object_idx=jnp.asarray(0, jnp.int32))
    tbatch = tts.TrainBatch(
        pixel_values=torch.from_numpy(pixels),
        input_ids=torch.from_numpy(ids),
        input_ids_placeholder_object=torch.full((B,), obj_id),
        input_ids_placeholder_view=torch.full((B,), view_id))
    return jb, tb, jbatch, tbatch, B


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """Both stacks, three steps each from the same weights and draws: the
    loss, the mapper gradients and the mapper parameters after each."""
    jb, tb, jbatch, tbatch, B = build_both_stacks(tmp_path_factory)
    text = jb.frozen.text
    sds = twp.from_jax_trainable(_np(jb.trainable), _np(text.obj_constants),
                                 _np(text.view_constants))

    # JAX: a pass-through transformation ahead of the sliced AdamW keeps
    # each step's gradients in the optimizer state
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    sched = joptim.make_lr_schedule("constant", LR, 0, 10)
    jstep = jax.jit(j_make_step(optax.chain(record,
                                            joptim.sliced_adamw(sched))))
    trainable = jb.trainable
    jstate = optax.chain(record, joptim.sliced_adamw(sched)).init(trainable)
    groups = tbuilder.trainable_groups(tb)
    tstep = tts.make_train_step(toptim.SlicedAdamW(
        groups, toptim.make_lr_schedule("constant", LR, 0, 10)))
    named = {"object": tb.text.obj_mappers[0], "view": tb.text.view_mapper}

    out = {"jax": [], "port": []}
    for s in range(STEPS):
        key = jax.random.PRNGKey(100 + s)
        # the draws of view_neti_tpu/training/train_step.py:129-154
        r_vae, r_noise, r_t, _, _ = jax.random.split(key, 5)
        lat_shape = (B, IMG // 2, IMG // 2, 4)
        draws = tts.StepDraws(
            vae_eps=torch.tensor(np.asarray(
                jax.random.normal(r_vae, lat_shape, jnp.float32))),
            noise=torch.tensor(np.asarray(
                jax.random.normal(r_noise, lat_shape, jnp.float32))),
            timesteps=torch.tensor(np.asarray(
                jax.random.randint(r_t, (B,), 0, 1000)).astype(np.int64)))
        trainable, jstate, metrics = jstep(trainable, jstate, jb.frozen,
                                           jbatch, key)
        jgrads = twp.from_jax_trainable(_np(jstate[0]),
                                        _np(text.obj_constants),
                                        _np(text.view_constants))
        jparams = twp.from_jax_trainable(_np(trainable),
                                         _np(text.obj_constants),
                                         _np(text.view_constants))
        out["jax"].append(dict(
            loss=float(metrics["total_loss"]),
            grads={"object": jgrads["object"][0], "view": jgrads["view"]},
            params={"object": jparams["object"][0], "view": jparams["view"]}))
        loss = tstep(tb, tbatch, draws)["total_loss"]
        out["port"].append(dict(
            loss=float(loss),
            grads={k: {n: p.grad.clone() for n, p in m.named_parameters()}
                   for k, m in named.items()},
            params={k: {n: p.detach().clone()
                        for n, p in m.named_parameters()}
                    for k, m in named.items()}))
    start = {"object": sds["object"][0], "view": sds["view"]}
    return out, start


def test_train_step_loss_matches_jax(trajectories):
    """The fp32 MSE of each of the three steps: 1e-4 relative (the UNet
    and CLIP in fp32, summation order differs)."""
    out, _ = trajectories
    for j, t in zip(out["jax"], out["port"]):
        assert np.isfinite(t["loss"])
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)


def test_train_step_mapper_gradients_match_jax(trajectories):
    """Every mapper parameter's gradient at every step, element-wise within
    1e-3 of the tensor's largest |gradient|: the gradient has passed back
    through the UNet's attention backward and CLIP in fp32."""
    out, _ = trajectories
    for j, t in zip(out["jax"], out["port"]):
        for key in ("object", "view"):
            for name, got in t["grads"][key].items():
                want = j["grads"][key][name].numpy()
                scale = np.abs(want).max()
                assert scale > 0, (key, name)
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-3 * scale,
                                           err_msg=f"{key}.{name}")


@pytest.mark.parametrize("after", [1, 3])
def test_train_step_parameters_match_jax(trajectories, after):
    """The mapper parameters after 1 and 3 steps. AdamW's first update is
    about -lr sign(g), and where |g| is tiny rounding can flip that sign,
    so the update is held to 2e-2 lr only where |g| > 1e-3 max|g| at every
    step so far; elsewhere to the sign-flip bound of 2 lr per step."""
    out, start = trajectories
    for key in ("object", "view"):
        for name, p0 in start[key].items():
            if name in ("fourier_w", "neti_w"):
                continue
            want = out["jax"][after - 1]["params"][key][name].numpy()
            got = out["port"][after - 1]["params"][key][name].numpy()
            big = np.ones(want.shape, bool)
            for s in range(after):
                g = np.abs(out["jax"][s]["grads"][key][name].numpy())
                big &= g > 1e-3 * g.max()
            diff = np.abs(got - want)
            assert big.mean() > 0.5, (key, name)
            assert diff[big].max() <= 2e-2 * LR, (key, name, diff[big].max())
            assert diff.max() <= 2 * LR * after + 1e-6, (key, name)
            # the parameters moved by about lr per step
            moved = np.abs(got - p0.numpy())[big]
            assert np.median(moved) > 0.5 * LR, (key, name)


def test_sample_step_draws_shapes():
    """The port's own draws for a mode-2 batch: latent-shaped normals,
    timesteps in [0, 1000), and no dropout draws when nested dropout is
    off."""
    models = tbuilder.build_models(
        RunConfig(learnable_mode=0, model=ModelConfig(word_embedding_dim=32)),
        FallbackTokenizer(base_vocab_size=512), [], ["<thing>"],
        arch=tbuilder.tiny_arch(), device="cpu")
    batch = tts.TrainBatch(pixel_values=torch.zeros(3, 16, 24, 3),
                           input_ids=torch.zeros(3, 16, dtype=torch.long),
                           input_ids_placeholder_object=torch.zeros(3),
                           input_ids_placeholder_view=torch.zeros(3))
    d = tts.sample_step_draws(torch.Generator().manual_seed(0), models,
                              batch)
    assert d.vae_eps.shape == d.noise.shape == (3, 8, 12, 4)
    assert d.timesteps.shape == (3,)
    assert 0 <= int(d.timesteps.min()) and int(d.timesteps.max()) < 1000
    # the object mapper uses nested dropout by default: 16 x 3 rows
    apply, idx = d.dropout["object"]
    assert apply.shape == idx.shape == (48,)
    assert int(idx.max()) < models.text.obj_mappers[0].hidden_dim


def test_gradient_checkpointing_leaves_the_gradients_unchanged():
    """with_gradient_checkpointing recomputes the UNet's ResNet blocks and
    the CLIP layers in the backward: the same seeded stack and draws give
    the same loss and mapper gradients (fp32 on the CPU, where the
    recomputation repeats the forward's arithmetic: 1e-6)."""
    def loss_and_grads(arch):
        models = tbuilder.build_models(
            RunConfig(learnable_mode=0,
                      model=ModelConfig(word_embedding_dim=32)),
            FallbackTokenizer(base_vocab_size=512), [], ["<thing>"],
            arch=arch, device="cpu")
        groups = tbuilder.trainable_groups(models)
        obj_id = models.placeholder_object_token_ids[0]
        ids = torch.full((2, 16), 3, dtype=torch.long)
        ids[:, 4] = obj_id
        batch = tts.TrainBatch(
            pixel_values=torch.from_numpy(np.random.RandomState(1).uniform(
                -1, 1, (2, 16, 16, 3)).astype(np.float32)),
            input_ids=ids,
            input_ids_placeholder_object=torch.full((2,), obj_id),
            input_ids_placeholder_view=torch.full((2,), -1))
        draws = tts.sample_step_draws(torch.Generator().manual_seed(2),
                                      models, batch)
        latents = tts.encode_latents(models, batch, draws, torch.float32)
        loss = tts.diffusion_loss(models, batch, draws, latents,
                                  torch.float32)
        loss.backward()
        return loss.item(), [p.grad for p in groups["object"][0]]

    plain = loss_and_grads(tbuilder.tiny_arch())
    remat = loss_and_grads(tbuilder.with_gradient_checkpointing(
        tbuilder.tiny_arch()))
    assert plain[0] == pytest.approx(remat[0], rel=1e-6)
    assert any(g.abs().sum() > 0 for g in plain[1])
    for a, b in zip(plain[1], remat[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
