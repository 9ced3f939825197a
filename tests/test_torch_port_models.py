"""view_neti_tpu_torch models against the JAX package's models.

Each JAX module gets parameters drawn with numpy from a seed; the tree is
carried across with view_neti_tpu_torch.weight_port.from_jax_* and loaded
strictly into the port's module; both run on the same numpy inputs and
are compared in fp32. Also here: the weight-port round trip, the
full-width state_dict keys, the scheduler, and the pure-Python copies
(tokenizer, config, camera tokens).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from view_neti_tpu import weight_port as jwp
from view_neti_tpu.config import ModelConfig as JModelConfig
from view_neti_tpu.data import dtu as jdtu
from view_neti_tpu.models import view_tokens as jvt
from view_neti_tpu.models.clip_text import NeTICLIPTextEncoder as JCLIP
from view_neti_tpu.models.neti_mapper import NeTIMapper as JMapper
from view_neti_tpu.models.unet import UNet2DCondition as JUNet
from view_neti_tpu.models.unet import tiny_unet_config as j_tiny_unet
from view_neti_tpu.models.vae import AutoencoderKL as JVAE
from view_neti_tpu.models.vae import tiny_vae_config as j_tiny_vae
from view_neti_tpu.schedulers.dpm_solver import DPMSolverSchedule as JDPM
from view_neti_tpu.tokenizer import ClipBPETokenizer as JBPE
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok
from view_neti_tpu.training import builder as jbuilder
from view_neti_tpu.utils.types import PESigmas as JPESigmas

from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import ModelConfig as TModelConfig
from view_neti_tpu_torch.data import dtu as tdtu
from view_neti_tpu_torch.models import view_tokens as tvt
from view_neti_tpu_torch.models.clip_text import (NeTICLIPTextEncoder,
                                                  sd15_text_config,
                                                  sd21_text_config)
from view_neti_tpu_torch.models.neti_mapper import NeTIMapper
from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                             sd15_unet_config,
                                             tiny_unet_config)
from view_neti_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from view_neti_tpu_torch.models.vae import tiny_vae_config
from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
from view_neti_tpu_torch.tokenizer import ClipBPETokenizer as TBPE
from view_neti_tpu_torch.tokenizer import FallbackTokenizer as TTok
from view_neti_tpu_torch.tokenizer import _bytes_to_unicode
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.utils.types import PESigmas

INVENTORY = Path(__file__).parent / "fixtures" / "key_inventory"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's 8-thread parallel regions
    spend most of their time waiting for cores; on one thread they do
    not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_params(shapes, seed):
    """Fill a tree of ShapeDtypeStructs with numpy draws: kernels
    N(0, 1/fan_in), biases and norm offsets N(0, 0.1^2), norm scales
    1 + N(0, 0.1^2), embedding tables N(0, 0.02^2)."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
                continue
            shape = leaf.shape
            if name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                v = rng.randn(*shape) / np.sqrt(fan_in)
            elif name == "scale":
                v = 1 + 0.1 * rng.randn(*shape)
            elif name == "bias":
                v = 0.1 * rng.randn(*shape)
            else:
                v = 0.02 * rng.randn(*shape)
            out[name] = v.astype(np.float32)
        return out
    return fill(shapes)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


# --------------------------------------------------------------- UNet ----

def _unet_pair(lp):
    jcfg = j_tiny_unet(use_flash_attention=False, use_linear_projection=lp)
    junet = JUNet(jcfg)
    L, D = 5, jcfg.cross_attention_dim
    shapes = jax.eval_shape(
        junet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,)), jnp.zeros((16, 1, L, D)), jnp.zeros((16, 1, L, D)))
    params = _random_params(shapes["params"], seed=10 + lp)
    tunet = _load(UNet2DCondition(tiny_unet_config(use_linear_projection=lp)),
                  twp.from_jax_unet(params, use_linear_projection=lp))
    return junet, params, tunet


@pytest.mark.parametrize("lp", [False, True])
def test_unet_matches_jax(lp):
    """16 distinct per-layer contexts and a distinct bypass stack: any
    layer-order or K/V-source mismatch breaks parity."""
    junet, params, tunet = _unet_pair(lp)
    rng = np.random.RandomState(0)
    B, L, D = 2, 5, 32
    lat = rng.randn(B, 8, 8, 4).astype(np.float32)
    t = np.array([17.0, 503.0], np.float32)
    ctx = rng.randn(16, B, L, D).astype(np.float32)
    byp = rng.randn(16, B, L, D).astype(np.float32)
    want = jax.jit(junet.apply)({"params": params}, lat, t, ctx, byp)
    got = tunet(torch.from_numpy(lat), torch.from_numpy(t),
                torch.from_numpy(ctx), torch.from_numpy(byp))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------- VAE ----

def test_vae_decode_matches_jax_fused():
    """fuse_conv=True on both sides: the JAX decoder runs the Pallas kernel
    in interpret mode, the port's its plain version (a CPU tensor)."""
    jcfg = dataclasses.replace(j_tiny_vae(), fuse_conv=True)
    jvae = JVAE(jcfg)
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(1))
    params = _random_params(shapes["params"], seed=3)
    tvae = _load(AutoencoderKL(tiny_vae_config(fuse_conv=True)),
                 twp.from_jax_vae(params, num_blocks=2))
    z = np.random.RandomState(1).randn(2, 4, 6, 4).astype(np.float32)
    want = jvae.apply({"params": params}, jnp.asarray(z),
                      method=JVAE.decode)
    got = tvae.decode(torch.from_numpy(z))
    assert got.shape == (2, 8, 12, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# --------------------------------------------------------------- CLIP ----

def test_clip_matches_jax_with_placeholder_and_bypass():
    tcfg_j = jbuilder.tiny_arch().text
    jclip = JCLIP(tcfg_j)
    B, L, D = 3, tcfg_j.max_position_embeddings, tcfg_j.hidden_size
    shapes = jax.eval_shape(jclip.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, L), jnp.int32))
    params = _random_params(shapes["params"], seed=5)
    tclip = _load(NeTICLIPTextEncoder(tbuilder.tiny_arch().text),
                  twp.from_jax_clip_text(params, num_layers=2))

    rng = np.random.RandomState(2)
    ids = np.full((B, L), 511, np.int32)          # EOT/pad = highest id
    ids[:, 0] = 510                               # BOS
    ids[:, 1:8] = rng.randint(0, 500, (B, 7))
    ids[0, 3] = ids[1, 5] = 512                   # object placeholder
    ids[0, 1] = ids[2, 2] = 513                   # view placeholder
    ph_obj = np.array([512, 512, -1], np.int32)
    ph_view = np.array([513, -1, 513], np.int32)
    vecs = [rng.randn(B, D).astype(np.float32) for _ in range(4)]
    kw = dict(alpha_obj=0.2, alpha_view=5.0, unconstrained_obj=False,
              unconstrained_view=True)
    want = jclip.apply({"params": params}, jnp.asarray(ids),
                       word_obj=vecs[0], bypass_obj=vecs[1],
                       ph_obj_ids=jnp.asarray(ph_obj), word_view=vecs[2],
                       bypass_view=vecs[3], ph_view_ids=jnp.asarray(ph_view),
                       **kw)
    tv = [torch.from_numpy(v) for v in vecs]
    got = tclip(torch.from_numpy(ids.astype(np.int64)), word_obj=tv[0],
                bypass_obj=tv[1], ph_obj_ids=torch.from_numpy(ph_obj),
                word_view=tv[2], bypass_view=tv[3],
                ph_view_ids=torch.from_numpy(ph_view), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------- mappers ----

_SIGMAS = dict(sigma_t=0.2, sigma_l=2.0, sigma_theta=1.0, sigma_phi=1.0,
               sigma_r=1.0, sigma_dtu12=0.5)
_MAPPERS = {
    "view_arch15_dtu12": dict(embedding_type="view", arch_view_net=15,
                              arch_view_disable_tl=False,
                              num_view_cond_dims=12, normalize_output=True,
                              output_bypass_alpha=5.0),
    "object_arch15": dict(embedding_type="object", arch_view_net=15,
                          normalize_output=True),
    "object_legacy_pe1": dict(embedding_type="object", arch_view_net=0,
                              use_positional_encoding=1,
                              normalize_output=True),
}


@pytest.mark.parametrize("name", sorted(_MAPPERS))
def test_mapper_matches_jax(name):
    kw = dict(_MAPPERS[name], output_dim=32)
    jm = JMapper(pe_sigmas=JPESigmas(**_SIGMAS), **kw)
    B = 6
    rng = np.random.RandomState(7)
    t = rng.uniform(0, 999, B).astype(np.float32)
    layer = rng.randint(0, 16, B).astype(np.float32)
    view = (rng.uniform(-1, 1, (B, 12)).astype(np.float32)
            if kw["embedding_type"] == "view" else None)
    rows = np.zeros(B, np.int32) if view is not None else None
    variables = _tree_np(jm.init({"params": jax.random.PRNGKey(1)}, t, layer,
                                 view_params=view, view_rows=rows))
    tm = _load(NeTIMapper(pe_sigmas=PESigmas(**_SIGMAS), **kw),
               twp.from_jax_mapper(variables["params"],
                                   variables.get("constants")))
    scale = np.float32(0.37)
    for trunc in (None, 10):
        want = jm.apply(variables, t, layer, view_params=view,
                        view_rows=rows, truncation_idx=trunc,
                        norm_scale=jnp.asarray(scale))
        got = tm(torch.from_numpy(t), torch.from_numpy(layer),
                 view_params=None if view is None else torch.from_numpy(view),
                 truncation_idx=trunc, norm_scale=torch.tensor(scale))
        np.testing.assert_allclose(got.word_embedding.numpy(),
                                   np.asarray(want.word_embedding),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.bypass_output.numpy(),
                                   np.asarray(want.bypass_output),
                                   rtol=1e-5, atol=1e-5)
        assert got.bypass_unconstrained == want.bypass_unconstrained
        assert got.output_bypass_alpha == want.output_bypass_alpha


# --------------------------------------------------- weight-port trips ----

def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k],
                                          err_msg=f"{path}/{k}")


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("lp", [False, True])
def test_weight_port_round_trip_unet(lp):
    _, params, _ = _unet_pair(lp)
    report = jwp.PortReport("unet")
    back = jwp.port_unet(_np_sd(twp.from_jax_unet(
        params, use_linear_projection=lp)), report=report,
        use_linear_projection=lp)
    assert not report.missing and not report.unconsumed
    _assert_trees_equal(back, params)


def test_weight_port_round_trip_vae_and_clip():
    jvae = JVAE(j_tiny_vae())
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(1))
    params = _random_params(shapes["params"], seed=4)
    back = jwp.port_vae(_np_sd(twp.from_jax_vae(params, num_blocks=2)),
                        num_blocks=2)
    _assert_trees_equal(back, params)

    jclip = JCLIP(jbuilder.tiny_arch().text)
    shapes = jax.eval_shape(jclip.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16), jnp.int32))
    params = _random_params(shapes["params"], seed=6)
    # the port keeps the headroom rows in the table: no rows to add back
    back = jwp.port_clip_text(_np_sd(twp.from_jax_clip_text(
        params, num_layers=2)), num_layers=2, vocab_headroom=0)
    _assert_trees_equal(back, params)


def test_weight_port_refuses_partial_trees():
    _, params, _ = _unet_pair(False)
    params = dict(params)
    del params["conv_out"]
    with pytest.raises(KeyError):
        twp.from_jax_unet(params)


# -------------------------------------------------- full-width key sets ----

def _inventory(name):
    return set((INVENTORY / f"{name}.txt").read_text().split())


@pytest.mark.parametrize("name,factory", [
    ("unet_sd", lambda: UNet2DCondition(sd15_unet_config())),
    ("vae_sd", lambda: AutoencoderKL(VAEConfig())),
    ("text_sd15", lambda: NeTICLIPTextEncoder(sd15_text_config())),
    ("text_sd21", lambda: NeTICLIPTextEncoder(sd21_text_config())),
])
def test_full_width_state_dict_keys_match_inventory(name, factory):
    with torch.device("meta"):
        module = factory()
    sd = module.state_dict()
    assert set(sd) == _inventory(name)
    if name.startswith("text"):
        cfg = module.config
        assert sd["text_model.embeddings.token_embedding.weight"].shape == (
            cfg.vocab_size + cfg.vocab_headroom, cfg.hidden_size)


# ----------------------------------------------------------- scheduler ----

@pytest.mark.parametrize("steps", [30, 10])
def test_dpm_solver_matches_jax(steps):
    js, ts_ = JDPM(), DPMSolverSchedule()
    np.testing.assert_array_equal(ts_.set_timesteps(steps),
                                  js.set_timesteps(steps))
    tc = ts_.coefficients(ts_.set_timesteps(steps))
    jc = js.coefficients(js.set_timesteps(steps))
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k])
    rng = np.random.RandomState(steps)
    sample = rng.randn(2, 4, 3, 4).astype(np.float32)
    jx, tx = jnp.asarray(sample), torch.from_numpy(sample)
    jprev, tprev = jnp.zeros_like(jx), torch.zeros_like(tx)
    for i in range(steps):
        eps = rng.randn(*sample.shape).astype(np.float32)
        jx, jprev = js.step(jnp.asarray(eps), i, jx, jprev, jc, steps)
        tx, tprev = ts_.step(torch.from_numpy(eps), i, tx, tprev, tc, steps)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i}")


# ------------------------------------------------- pure-Python copies ----

def _toy_bpe_dir(tmp_path):
    """A miniature CLIP BPE vocab.json/merges.txt: every byte symbol, a few
    merges ("cat", "photo"), the two specials."""
    vocab = {}
    for s in _bytes_to_unicode().values():
        vocab[s] = len(vocab)
        vocab[s + "</w>"] = len(vocab)
    merges = [("c", "a"), ("ca", "t</w>"), ("p", "h"), ("ph", "o"),
              ("pho", "t"), ("phot", "o</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(p) for p in merges))
    return tmp_path


@pytest.mark.parametrize("kind", ["fallback", "bpe"])
def test_tokenizer_ids_match_jax(kind, tmp_path):
    if kind == "bpe":
        path = _toy_bpe_dir(tmp_path)
        jt, tt = JBPE.from_dir(path), TBPE.from_dir(path)
    else:
        jt, tt = JTok(base_vocab_size=512), TTok(base_vocab_size=512)
    for tok in (jt, tt):
        tok.add_tokens(["<view_a>", "<skull>"])
    for text in ("<view_a>. A photo of a <skull>", "a photo of a dog!",
                 "Oil painting of <skull>   in 3 moons", ""):
        for kw in ({}, {"padding": "max_length", "truncation": True,
                        "max_length": 16}):
            np.testing.assert_array_equal(tt(text, **kw).input_ids,
                                          jt(text, **kw).input_ids)
    assert tt.convert_tokens_to_ids(["<skull>", "dog"]) == \
        jt.convert_tokens_to_ids(["<skull>", "dog"])


@pytest.mark.parametrize("keys", [(0, 0, 0), (2, 1, 1), (5, 3, 0)])
def test_config_sigma_resolution_matches_jax(keys):
    e, t, l = keys
    kw = dict(pe_sigma_exp_key=e, pe_t_exp_key=t, pe_l_exp_key=l)
    assert (dataclasses.asdict(TModelConfig(**kw).pe_sigmas)
            == dataclasses.asdict(JModelConfig(**kw).pe_sigmas))


def test_view_token_table_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    for i in range(1, 11):
        m = rng.randn(3, 4) * 100
        (tmp_path / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r) for r in m))
    cams = [rng.randn(3, 4).astype(np.float32) * 100 for _ in range(4)]
    jtoks = [jdtu.dtu_cam_params_to_token(c, i) for i, c in enumerate(cams)]
    ttoks = [tdtu.dtu_cam_params_to_token(c, i) for i, c in enumerate(cams)]
    assert jtoks == ttoks
    ids = list(range(600, 604))
    jt = jvt.build_view_token_table(jtoks, ids, calibration_dir=tmp_path)
    tt = tvt.build_view_token_table(ttoks, ids, calibration_dir=tmp_path)
    np.testing.assert_array_equal(tt.params_scaled(), jt.params_scaled())
    np.testing.assert_array_equal(tt.token_ids, jt.token_ids)
    # a novel view token at inference: appended without re-fitting bounds
    novel = rng.randn(3, 4).astype(np.float32) * 300
    jt2 = jt.extend([jdtu.dtu_cam_params_to_token(novel, 99)], [700])
    tt2 = tt.extend([tdtu.dtu_cam_params_to_token(novel, 99)], [700])
    np.testing.assert_array_equal(tt2.params_scaled(), jt2.params_scaled())
    np.testing.assert_array_equal(tt2.token_ids, jt2.token_ids)
    assert tdtu.dtu_get_train_idxs(6) == jdtu.dtu_get_train_idxs(6)
