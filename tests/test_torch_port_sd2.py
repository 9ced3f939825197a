"""The SD-2.x family in the port against the JAX package, on the CPU at a
tiny width: the pieces that SD-1.5 lacks and mode 3's shipped recipe
(input_configs/train_m3.yaml, stabilityai/stable-diffusion-2-1) runs
through: a UNet with linear proj_in/proj_out and a fixed head dim, a GELU
CLIP and the v-prediction target. The tiny architecture is built from the
JAX package's own config classes (its tiny_arch has none of these) and
the port's counterparts; the port holds the JAX weights through
weight_port. The UNet forward, the text conditioning, one train step and
load_sd_weights on SD-2.x's linear projection keys are held against JAX.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from view_neti_tpu import weight_port as jwp
from view_neti_tpu.config import RunConfig as JRunConfig
from view_neti_tpu.config import decode as jdecode
from view_neti_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from view_neti_tpu.models.clip_text import NeTICLIPTextEncoder as JCLIP
from view_neti_tpu.models.unet import UNet2DCondition as JUNet
from view_neti_tpu.models.unet import tiny_unet_config as j_tiny_unet
from view_neti_tpu.models.vae import AutoencoderKL as JVAE
from view_neti_tpu.models.vae import tiny_vae_config as j_tiny_vae
from view_neti_tpu.schedulers.ddpm import DDPMSchedule as JDDPM
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok
from view_neti_tpu.training import builder as jbuilder
from view_neti_tpu.training import optim as joptim
from view_neti_tpu.training.text_forward import TextModels as JTextModels
from view_neti_tpu.training.text_forward import \
    neti_text_conditioning as j_conditioning
from view_neti_tpu.training.train_step import FrozenModels as JFrozen
from view_neti_tpu.training.train_step import TrainBatch as JBatch
from view_neti_tpu.training.train_step import make_train_step as j_make_step

from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.data import dtu as tdtu
from view_neti_tpu_torch.models.clip_text import CLIPTextConfig
from view_neti_tpu_torch.models.unet import tiny_unet_config
from view_neti_tpu_torch.models.vae import tiny_vae_config
from view_neti_tpu_torch.tokenizer import FallbackTokenizer
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training import optim as toptim
from view_neti_tpu_torch.training import train_step as tts
from view_neti_tpu_torch.training.text_forward import neti_text_conditioning
from view_neti_tpu_torch.utils import safetensors_io

TEXT = dict(vocab_size=512, vocab_headroom=128, hidden_size=32, num_layers=2,
            num_heads=2, intermediate_size=64, max_position_embeddings=16,
            hidden_act="gelu")
UNET = dict(cross_attention_dim=32, num_attention_heads=None,
            attention_head_dim=8, use_linear_projection=True)
MODEL = dict(arch_view_net=15, arch_view_disable_tl=False,
             word_embedding_dim=32, normalize_view_mapper_output=True,
             output_bypass_alpha_view=5.0, pe_sigma_exp_key=2,
             use_nested_dropout=False)
B, IMG, LR = 2, 16, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's 8-thread parallel regions
    spend most of their time waiting for cores; on one thread they do
    not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_arch():
    """The JAX side's arch; its UNet attends in plain jnp (the Pallas
    kernel's interpret mode only costs compile time here: its plain
    counterpart is held against it in tests/test_torch_port_ops.py)."""
    return jbuilder.SDArch(
        text=JCLIPConfig(**TEXT),
        unet=j_tiny_unet(use_flash_attention=False, **UNET),
        vae=j_tiny_vae(), prediction_type="v_prediction")


def port_arch():
    return tbuilder.SDArch(text=CLIPTextConfig(**TEXT),
                           unet=tiny_unet_config(**UNET),
                           vae=tiny_vae_config(),
                           prediction_type="v_prediction")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """The tiny SD-2.x mode-2 stack built by the port from a seed, the JAX
    package's stack holding its weights (the UNet, VAE and CLIP through the
    JAX package's own weight_port.port_*, the mappers through
    to_jax_trainable, the mapper definitions traced, nothing initialised
    or compiled: tests/test_torch_port_validate.py::_jax_stack's way), and
    one batch for each."""
    cal = tmp_path_factory.mktemp("cal")
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))
    views = [tdtu.dtu_cam_params_to_token(
        rng.randn(3, 4).astype(np.float32) * 100, i)
        for i in tdtu.dtu_get_train_idxs(3)]
    data = {"learnable_mode": 2, "model": MODEL,
            "data": {"camera_representation": "dtu-12d", "dtu_subset": 3}}
    tb = tbuilder.build_models(decode(RunConfig, data),
                               FallbackTokenizer(base_vocab_size=512), views,
                               ["<skull>"], arch=port_arch(),
                               calibration_dir=str(cal), device="cpu")
    assert tb.schedule.prediction_type == "v_prediction"

    def sd(module):
        return {k: v.detach().numpy() for k, v in module.state_dict().items()}

    reports = [jwp.PortReport(n) for n in ("unet", "vae", "clip")]
    unet_p = jwp.port_unet(sd(tb.unet), use_linear_projection=True,
                           report=reports[0])
    vae_p = jwp.port_vae(sd(tb.vae), num_blocks=2, report=reports[1])
    clip_p = jwp.port_clip_text(sd(tb.text.clip), num_layers=2,
                                vocab_headroom=0, report=reports[2])
    assert all(not r.missing and not r.unconsumed for r in reports), [
        r.summary() for r in reports]
    trainable, obj_c, view_c = twp.to_jax_trainable(
        [tb.text.obj_mappers[0].state_dict()],
        tb.text.view_mapper.state_dict())
    jcfg = jdecode(JRunConfig, data)
    arch = jax_arch()
    jtok = JTok(base_vocab_size=512)
    jtok.model_max_length = 16
    jtok.add_tokens(views + ["<skull>"])
    assert jtok.convert_tokens_to_ids(views + ["<skull>"]) == \
        tb.placeholder_token_ids
    defs = {}
    m = jcfg.model

    def trace(kind, num_cond, **kw):
        def init():
            defs[kind], params, consts = jbuilder._init_mapper(
                jcfg, kind, arch, num_cond, **kw)
            return params, consts
        jax.eval_shape(init)

    trace("object", 0, normalize=m.normalize_object_mapper_output,
          output_bypass=m.output_bypass_object,
          bypass_unconstrained=m.bypass_unconstrained_object,
          alpha=m.output_bypass_alpha_object)
    trace("view", 12, normalize=m.normalize_view_mapper_output,
          output_bypass=m.output_bypass_view,
          bypass_unconstrained=m.bypass_unconstrained_view,
          alpha=m.output_bypass_alpha_view, num_view_tokens=len(views))
    table = tb.view_table
    text = JTextModels(
        clip=JCLIP(arch.text), clip_vars={"params": clip_p},
        obj_mapper=defs["object"], obj_constants=obj_c,
        view_mapper=defs["view"], view_constants=view_c,
        view_table_ids=jnp.asarray(table.token_ids),
        view_table_params=jnp.asarray(table.params_scaled()),
        obj_norm_scales=jnp.asarray(tb.text.obj_norm_scales.numpy()),
        view_norm_scale=jnp.asarray(float(tb.text.view_norm_scale)))
    frozen = JFrozen(text=text, unet=JUNet(arch.unet),
                     unet_vars={"params": unet_p}, vae=JVAE(arch.vae),
                     vae_vars={"params": vae_p},
                     schedule=JDDPM(prediction_type=arch.prediction_type))
    jb = SimpleNamespace(frozen=frozen, trainable=trainable)

    tok = tb.tokenizer
    obj_id = tb.placeholder_object_token_ids[0]
    ids = np.full((B, 16), tok.eos_token_id, np.int64)
    ids[:, 0] = tok.bos_token_id
    ids[:, 1] = tb.placeholder_view_token_ids[:B]
    ids[:, 2:7] = 100
    ids[:, 7] = obj_id
    pixels = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    obj = np.full(B, obj_id)
    jbatch = JBatch(pixel_values=jnp.asarray(pixels),
                    input_ids=jnp.asarray(ids, jnp.int32),
                    input_ids_placeholder_object=jnp.asarray(obj, jnp.int32),
                    input_ids_placeholder_view=jnp.asarray(ids[:, 1],
                                                           jnp.int32),
                    object_idx=jnp.asarray(0, jnp.int32))
    tbatch = tts.TrainBatch(
        pixel_values=torch.from_numpy(pixels),
        input_ids=torch.from_numpy(ids),
        input_ids_placeholder_object=torch.from_numpy(obj),
        input_ids_placeholder_view=torch.from_numpy(ids[:, 1].copy()))
    return jb, tb, jbatch, tbatch


def test_sd2_unet_forward_matches_jax(stacks):
    """Linear projections, 4 / 8 / 8 / 8 heads of width 8, 16 distinct
    per-layer contexts: the fp32 outputs to 2e-4, as
    tests/test_torch_port_models.py holds SD-1.5's."""
    jb, tb, _, _ = stacks
    assert tb.unet.down_blocks[0].attentions[0].proj_in.weight.dim() == 2
    rng = np.random.RandomState(1)
    lat = rng.randn(B, 8, 8, 4).astype(np.float32)
    t = np.array([17.0, 903.0], np.float32)
    ctx = rng.randn(16, B, 5, 32).astype(np.float32)
    byp = rng.randn(16, B, 5, 32).astype(np.float32)
    fz = jb.frozen
    want = jax.jit(fz.unet.apply)(fz.unet_vars, lat, t, ctx, byp)
    with torch.no_grad():
        got = tb.unet(*(torch.from_numpy(a) for a in (lat, t, ctx, byp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_sd2_text_conditioning_matches_jax(stacks):
    """The 16-layer conditioning through the GELU CLIP with the view and
    object mappers: context and bypass context to 1e-4 (fp32, another
    summation order in CLIP)."""
    jb, tb, jbatch, tbatch = stacks
    ts = np.array([3, 811], np.int64)
    want = jax.jit(lambda text, tr, b, t: j_conditioning(
        text, tr, b.input_ids, b.input_ids_placeholder_object,
        b.input_ids_placeholder_view, t, object_idx=b.object_idx))(
        jb.frozen.text, jb.trainable, jbatch, jnp.asarray(ts))
    got = neti_text_conditioning(
        tb.text, tbatch.input_ids, tbatch.input_ids_placeholder_object,
        tbatch.input_ids_placeholder_view, torch.from_numpy(ts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_sd2_train_step_matches_jax(stacks):
    """One v-prediction train step with JAX's draws: the loss to 1e-4
    relative and every mapper gradient within 1e-3 of its tensor's
    largest |gradient| (tests/test_torch_port_train.py's limits)."""
    jb, tb, jbatch, tbatch = stacks
    text = jb.frozen.text
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    sched = joptim.make_lr_schedule("constant", LR, 0, 10)
    chain = optax.chain(record, joptim.sliced_adamw(sched))
    key = jax.random.PRNGKey(11)
    _, state, metrics = jax.jit(j_make_step(chain))(
        jb.trainable, chain.init(jb.trainable), jb.frozen, jbatch, key)
    r_vae, r_noise, r_t, _, _ = jax.random.split(key, 5)
    shape = (B, IMG // 2, IMG // 2, 4)
    draws = tts.StepDraws(
        vae_eps=torch.tensor(np.asarray(
            jax.random.normal(r_vae, shape, jnp.float32))),
        noise=torch.tensor(np.asarray(
            jax.random.normal(r_noise, shape, jnp.float32))),
        timesteps=torch.tensor(np.asarray(
            jax.random.randint(r_t, (B,), 0, 1000)).astype(np.int64)))
    step = tts.make_train_step(toptim.SlicedAdamW(
        tbuilder.trainable_groups(tb),
        toptim.make_lr_schedule("constant", LR, 0, 10)))
    loss = float(step(tb, tbatch, draws)["total_loss"])
    assert np.isfinite(loss)
    assert loss == pytest.approx(float(metrics["total_loss"]), rel=1e-4)
    grads = twp.from_jax_trainable(_np(state[0]), _np(text.obj_constants),
                                   _np(text.view_constants))
    for mapper, want in ((tb.text.obj_mappers[0], grads["object"][0]),
                         (tb.text.view_mapper, grads["view"])):
        for name, p in mapper.named_parameters():
            w = want[name].numpy()
            scale = np.abs(w).max()
            assert scale > 0, name
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                       atol=1e-3 * scale, err_msg=name)


def test_sd2_weights_load_with_linear_projections(stacks, tmp_path):
    """An SD-2.x directory (the UNet's proj_in/proj_out as Linear (out,
    in) weights, the GELU CLIP without its headroom rows): the port's
    load_sd_weights returns every tensor as written, and the JAX package's
    loader reads the same trees the JAX stack holds, exactly."""
    jb, tb, _, _ = stacks
    files = {"unet": (tb.unet, "unet/diffusion_pytorch_model.safetensors"),
             "vae": (tb.vae, "vae/diffusion_pytorch_model.safetensors"),
             "clip": (tb.text.clip, "text_encoder/model.safetensors")}
    table = "text_model.embeddings.token_embedding.weight"
    written = {}
    for name, (module, rel) in files.items():
        sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
        if name == "clip":
            sd[table] = sd[table][:TEXT["vocab_size"]].clone()
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        safetensors_io.save_file(sd, tmp_path / rel)
        written[name] = sd
    proj = [k for k in written["unet"] if k.endswith("proj_in.weight")]
    assert proj and all(written["unet"][k].dim() == 2 for k in proj)
    sds = twp.load_sd_weights(tmp_path, text_layers=2,
                              use_linear_projection=True, vocab_headroom=128,
                              vae_blocks=2)
    for name, sd in written.items():
        assert sds[name].keys() == sd.keys(), name
        for k, v in sd.items():
            got = sds[name][k]
            if name == "clip" and k == table:
                got = got[:TEXT["vocab_size"]]
            assert torch.equal(got, v), (name, k)
    # the JAX package's loader on the same directory gives the JAX stack's
    # trees (those of the port's weights) leaf for leaf
    ported = jwp.load_sd_weights(tmp_path, text_layers=2,
                                 use_linear_projection=True,
                                 vocab_headroom=128, strict=False,
                                 log=lambda m: None)
    fz = jb.frozen
    for name, tree in (("unet", fz.unet_vars["params"]),
                       ("vae", fz.vae_vars["params"]),
                       ("clip", fz.text.clip_vars["params"])):
        got = jwp.merge_ported(
            jax.tree_util.tree_map(np.zeros_like, _np(tree)), ported[name],
            label=name, strict=name != "vae")
        flat_w = jax.tree_util.tree_leaves_with_path(_np(tree))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_g) == len(flat_w), name
        for path, w in flat_w:
            g = np.asarray(flat_g[path])
            if "token_embedding" in str(path):
                # the file holds the base vocabulary; the loader pads the
                # headroom with zero rows, the stack holds placeholders
                g, w = g[:TEXT["vocab_size"]], w[:TEXT["vocab_size"]]
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {path}")
