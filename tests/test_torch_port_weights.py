"""SD weights and reference view mappers read from disk, on the CPU.

The port's safetensors reader and writer against the safetensors package;
a tiny stack (builder.tiny_arch) written in the diffusers layout and loaded
by the port's load_sd_weights and by the JAX package's load_sd_weights +
merge_ported, the UNet, VAE and CLIP of both then run on the same inputs;
strictness and the lax mode; the Coach loading a weights directory; and a
reference torch view mapper (.pt) imported by the port's Coach and by the
JAX package's maybe_import_view_mapper.
"""
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from view_neti_tpu import weight_port as jwp
from view_neti_tpu.checkpoint import CheckpointHandler as JCheckpoint
from view_neti_tpu.config import RunConfig as JRunConfig
from view_neti_tpu.config import decode as jdecode
from view_neti_tpu.models.clip_text import NeTICLIPTextEncoder as JCLIP
from view_neti_tpu.models.unet import UNet2DCondition as JUNet
from view_neti_tpu.models.vae import AutoencoderKL as JVAE
from view_neti_tpu.torch_interop import \
    maybe_import_view_mapper as j_maybe_import
from view_neti_tpu.training import builder as jbuilder

from view_neti_tpu_torch import weight_port as twp
from view_neti_tpu_torch.config import RunConfig, decode
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.data.dtu import dtu_get_train_idxs
from view_neti_tpu_torch.models.clip_text import NeTICLIPTextEncoder
from view_neti_tpu_torch.models.unet import UNet2DCondition
from view_neti_tpu_torch.models.vae import AutoencoderKL
from view_neti_tpu_torch.training import builder as tbuilder
from view_neti_tpu_torch.training.coach import Coach
from view_neti_tpu_torch.utils import safetensors_io

from test_torch_interop import WORD_DIM, _save_ref_view_ckpt, _TorchRefMapper

ARCH = tbuilder.tiny_arch()
FILES = {"unet": "unet/diffusion_pytorch_model.safetensors",
         "vae": "vae/diffusion_pytorch_model.bin",
         "clip": "text_encoder/model.safetensors"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's 8-thread parallel regions
    spend most of their time waiting for cores; on one thread they do
    not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- safetensors ----

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 5, generator=g),
            "h": torch.randn(7, generator=g).half(),
            "b": torch.randn(2, 3, generator=g).bfloat16(),
            "i64": torch.arange(5), "i32": torch.arange(3, dtype=torch.int32),
            "empty": torch.zeros(0, 4), "scalar": torch.tensor(2.5)}


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    """Each side reads the other's file to the bit, in every dtype the
    port supports, with the header's metadata skipped."""
    st = pytest.importorskip("safetensors.torch")
    want = _tensors()
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "pkg.safetensors"
    safetensors_io.save_file(want, ours, metadata={"format": "pt"})
    st.save_file(want, str(theirs), metadata={"format": "pt"})
    for got in (st.load_file(str(ours)), safetensors_io.load_file(theirs)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    path = tmp_path / "f64.safetensors"
    st.save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(path))
    with pytest.raises(ValueError, match="F64"):
        safetensors_io.load_file(path)
    with pytest.raises(ValueError, match="float64"):
        safetensors_io.save_file({"x": torch.zeros(2, dtype=torch.float64)},
                                 tmp_path / "x.safetensors")


# ------------------------------------------------------- tiny stack ----

def _modules():
    return (UNet2DCondition(ARCH.unet), AutoencoderKL(ARCH.vae),
            NeTICLIPTextEncoder(ARCH.text))


def _fill(module, seed):
    """Every parameter from a seeded draw: weights ~ N(0, 1/fan_in), the
    rest ~ 1 + N(0, 0.1) (norm scales) or N(0, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g)
                        / np.sqrt(p[0].numel()))
            else:
                base = 1.0 if "norm" in name and "weight" in name else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
    return module.eval()


def write_stack(root: Path, seed: int = 0):
    """A tiny stack in the diffusers layout: the UNet and the CLIP as
    .safetensors (the CLIP table without its headroom rows, with the
    position_ids buffer transformers saves), the VAE as a torch .bin."""
    unet, vae, clip = (_fill(m, seed + i) for i, m in enumerate(_modules()))
    sds = {"unet": unet.state_dict(), "vae": vae.state_dict(),
           "clip": dict(clip.state_dict())}
    key = "text_model.embeddings.token_embedding.weight"
    sds["clip"][key] = sds["clip"][key][:ARCH.text.vocab_size].clone()
    sds["clip"]["text_model.embeddings.position_ids"] = torch.arange(
        ARCH.text.max_position_embeddings)[None]
    for name, rel in FILES.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        if rel.endswith(".bin"):
            torch.save(sds[name], root / rel)
        else:
            safetensors_io.save_file(sds[name], root / rel)
    return sds


def _load_port(root, **kw):
    return twp.load_sd_weights(root, text_layers=2, vocab_headroom=128,
                               vae_blocks=2, **kw)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    return root, write_stack(root)


def test_stack_loads_as_in_jax(stack):
    """The port's loaded modules and the JAX package's (load_sd_weights +
    merge_ported onto the init tree) give the same UNet, VAE decode and
    CLIP outputs to 2e-4."""
    root, _ = stack
    logs = []
    sds = _load_port(root, log=logs.append)
    assert len(logs) == 3 and all("MISSING" not in m for m in logs)
    unet, vae, clip = _modules()
    for module, name in ((unet, "unet"), (vae, "vae"), (clip, "clip")):
        module.load_state_dict(sds[name], strict=True)
        module.eval()
    # the JAX package: its loader (its VAE table has four blocks, so it
    # runs lax and merge_ported holds it to the tiny tree) onto init shapes
    jarch = jbuilder.tiny_arch()
    ported = jwp.load_sd_weights(root, text_layers=2, vocab_headroom=128,
                                 strict=False, log=lambda m: None)
    ju, jv, jc = JUNet(jarch.unet), JVAE(jarch.vae), JCLIP(jarch.text)
    key = jax.random.PRNGKey(0)
    ctx = jnp.zeros((16, 1, 5, 32))
    shapes = {
        "unet": jax.eval_shape(ju.init, key, jnp.zeros((1, 8, 8, 4)),
                               jnp.zeros((1,)), ctx, ctx),
        "vae": jax.eval_shape(jv.init, key, jnp.zeros((1, 8, 8, 3)), key),
        "clip": jax.eval_shape(jc.init, key, jnp.zeros((1, 16), jnp.int32))}
    params = {
        name: jwp.merge_ported(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes[name]["params"]),
            ported[name], label=name, strict=True)
        for name in shapes}

    rng = np.random.RandomState(1)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([17.0, 503.0], np.float32)
    c = rng.randn(16, 2, 5, 32).astype(np.float32)
    cb = rng.randn(16, 2, 5, 32).astype(np.float32)
    z = rng.randn(2, 4, 6, 4).astype(np.float32)
    ids = rng.randint(0, 512, (2, 16)).astype(np.int32)
    want = {
        "unet": jax.jit(ju.apply)({"params": params["unet"]}, lat, t, c, cb),
        "vae": jax.jit(lambda p, x: jv.apply(p, x, method=JVAE.decode))(
            {"params": params["vae"]}, z),
        "clip": jax.jit(jc.apply)({"params": params["clip"]}, ids)[0]}
    with torch.no_grad():
        got = {"unet": unet(*(torch.from_numpy(a) for a in (lat, t, c, cb))),
               "vae": vae.decode(torch.from_numpy(z)),
               "clip": clip(torch.from_numpy(ids.astype(np.int64)))[0]}
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def _rewrite(root, name, edit):
    path = root / FILES[name]
    sd = dict(twp.load_state_dict(path))
    edit(sd)
    if path.suffix == ".bin":
        torch.save(sd, path)
    else:
        safetensors_io.save_file({k: v.clone() for k, v in sd.items()},
                                 path)


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_a_faulty_file_raises_unless_lax(stack, tmp_path, fault):
    """A key missing from the UNet file or a key the VAE file holds beyond
    the table raises; strict=False logs it and loads the rest."""
    root = tmp_path / "sd"
    shutil.copytree(stack[0], root)
    if fault == "missing":
        _rewrite(root, "unet", lambda sd: sd.pop("conv_in.weight"))
        want = "MISSING 1 expected keys"
    else:
        _rewrite(root, "vae", lambda sd: sd.update(
            {"decoder.extra.weight": torch.zeros(3)}))
        want = "1 checkpoint keys unconsumed"
    with pytest.raises(KeyError, match=want):
        _load_port(root, log=lambda m: None)
    logs = []
    sds = _load_port(root, strict=False, log=logs.append)
    assert any(want in m for m in logs)
    assert "decoder.extra.weight" not in sds["vae"]


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """The six dtu_subset-6 cameras at 64x48 and 64 calibration files."""
    root = tmp_path_factory.mktemp("dtu")
    rect, cal = root / "Rectified" / "scan114", root / "Calibration" / "cal18"
    rect.mkdir(parents=True)
    cal.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(1, 65):
        (cal / f"pos_{i:03d}.txt").write_text(
            "\n".join(" ".join(f"{x:.4f}" for x in r)
                      for r in rng.randn(3, 4) * 100))
    for i in dtu_get_train_idxs(6):
        image_io.write_png(rect / f"rect_{i + 1:03d}_3_r5000.png",
                           rng.randint(0, 255, (48, 64, 3), np.uint8))
    return rect, cal


def _cfg(rect, exp, **model):
    return {
        "learnable_mode": model.pop("mode", 2),
        "model": dict({"arch_view_net": 15, "arch_view_disable_tl": False,
                       "word_embedding_dim": 32,
                       "normalize_view_mapper_output": True,
                       "pe_sigma_exp_key": 2}, **model),
        "data": {"camera_representation": "dtu-12d", "dtu_subset": 6,
                 "dtu_preprocess_key": -1, "repeats": 2,
                 "train_data_dir": str(rect), "resolution": 16,
                 "placeholder_object_token": "<skull>"},
        "log": {"exp_dir": str(exp), "save_dataset_images": False,
                "report_to": "none"},
        "optim": {"mixed_precision": "no", "max_train_steps": 1,
                  "gradient_accumulation_steps": 1},
    }


def test_coach_loads_a_weights_directory(stack, scan, tmp_path):
    """Coach(weights_dir=...): every loaded parameter equals the file's,
    the placeholders' rows come from the loaded super-category rows, and
    the view mapper's target norm from the loaded table."""
    root, sds = stack
    rect, cal = scan
    coach = Coach(decode(RunConfig, _cfg(rect, tmp_path)), arch=ARCH,
                  calibration_dir=str(cal), weights_dir=str(root),
                  device="cpu")
    built = coach.built
    for name, module in (("unet", built.unet), ("vae", built.vae),
                         ("clip", built.text.clip)):
        got = module.state_dict()
        for k, v in sds[name].items():
            if k.endswith("position_ids"):
                continue
            want_k = v if k in got and got[k].shape == v.shape else None
            if want_k is None:          # the token table: headroom added
                assert torch.equal(got[k][:v.shape[0]], v), k
            else:
                assert torch.equal(got[k], want_k), k
    table = built.text.clip.text_model.embeddings.token_embedding.weight
    sup = coach.tokenizer.encode("view", add_special_tokens=False)[0]
    for i in built.placeholder_view_token_ids:
        assert torch.equal(table[i], table[sup])
    assert built.target_norm_view == pytest.approx(
        float(torch.linalg.norm(sds["clip"][
            "text_model.embeddings.token_embedding.weight"][sup])))
    assert float(built.text.view_norm_scale) == pytest.approx(
        built.target_norm_view)
    log = (tmp_path / "logs" / "log.txt").read_text()
    assert "unet: ported" in log and "loaded pretrained weights" in log


def test_coach_lax_weights_log_what_they_skip(stack, scan, tmp_path,
                                              monkeypatch):
    root = tmp_path / "sd"
    shutil.copytree(stack[0], root)
    _rewrite(root, "unet", lambda sd: sd.pop("conv_in.bias"))
    rect, cal = scan
    with pytest.raises(KeyError, match="MISSING"):
        Coach(decode(RunConfig, _cfg(rect, tmp_path / "strict")),
              arch=ARCH, calibration_dir=str(cal), weights_dir=str(root),
              device="cpu")
    monkeypatch.setenv("VIEW_NETI_LAX_WEIGHTS", "1")
    Coach(decode(RunConfig, _cfg(rect, tmp_path / "lax")), arch=ARCH,
          calibration_dir=str(cal), weights_dir=str(root), device="cpu")
    log = (tmp_path / "lax" / "logs" / "log.txt").read_text()
    assert "MISSING 1 expected keys" in log
    assert "KEPT FROM RANDOM INIT" in log and "conv_in.bias" in log


# ----------------------------------------------- reference view mapper ----

def test_torch_view_mapper_imports_as_in_jax(scan, tmp_path):
    """A reference-shaped mapper-steps-N_view.pt (pickled encoder, no
    encoder.w in the state_dict): a mode-5 port Coach pointed at it and
    the JAX package's maybe_import_view_mapper give the same mapper output
    to 1e-6."""
    rect, cal = scan
    mirror = _TorchRefMapper(14, WORD_DIM * 2, seed=11,
                             sigmas=[0.03, 2.0] + [0.5] * 12)
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        _save_ref_view_ckpt(tmp_path / sub / "mapper-steps-50_view.pt",
                            mirror)
    data = _cfg(rect, tmp_path / "exp", mode=5, arch_mlp_hidden_dims=64,
                normalize_view_mapper_output=False,
                pretrained_view_mapper=str(
                    tmp_path / "port" / "mapper-steps-50_view.pt"))
    coach = Coach(decode(RunConfig, data), arch=ARCH,
                  calibration_dir=str(cal), device="cpu")
    assert (tmp_path / "port" / "mapper-steps-50_view.msgpack").exists()
    assert "imported torch view mapper" in (
        tmp_path / "exp" / "logs" / "log.txt").read_text()

    _, payload = JCheckpoint.load_mapper(
        j_maybe_import(tmp_path / "jax" / "mapper-steps-50_view.pt"))
    entry = payload["mappers"]["view"]
    jcfg = jdecode(JRunConfig, data)
    m = jcfg.model
    holder = {}

    def init():
        holder["m"], p, c = jbuilder._init_mapper(
            jcfg, "view", jbuilder.tiny_arch(), 12,
            normalize=m.normalize_view_mapper_output,
            output_bypass=m.output_bypass_view,
            bypass_unconstrained=m.bypass_unconstrained_view,
            alpha=m.output_bypass_alpha_view, num_view_tokens=6)
        return p, c

    jax.eval_shape(init)
    t = np.linspace(0, 990, 5).astype(np.float32)
    layer = (np.arange(5) % 16).astype(np.float32)
    cam = np.random.RandomState(1).uniform(-1, 1, (5, 12)).astype(np.float32)
    want = holder["m"].apply(
        {"params": entry["params"], "constants": entry["constants"]},
        jnp.asarray(t), jnp.asarray(layer), view_params=jnp.asarray(cam),
        view_rows=jnp.zeros(5, jnp.int32))
    with torch.no_grad():
        got = coach.built.text.view_mapper(
            torch.from_numpy(t), torch.from_numpy(layer),
            view_params=torch.from_numpy(cam))
    for name in ("word_embedding", "bypass_output"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_torch_artifacts_import_as_in_jax(tmp_path):
    """import_torch_artifacts on a reference view mapper and learned
    embeddings: the port's msgpack files hold the JAX package's mapper
    trees and rows exactly, and their config decodes in the port."""
    from view_neti_tpu.torch_interop import \
        import_torch_artifacts as j_import
    from view_neti_tpu_torch.checkpoint import CheckpointHandler
    from view_neti_tpu_torch.torch_interop import import_torch_artifacts
    mirror = _TorchRefMapper(14, WORD_DIM * 2, seed=4,
                             sigmas=[0.03, 2.0] + [0.5] * 12)
    view = tmp_path / "mapper-steps-300_view.pt"
    _save_ref_view_ckpt(view, mirror)
    embeds = tmp_path / "learned_embeds-steps-300.bin"
    g = torch.Generator().manual_seed(1)
    torch.save({"<skull>": torch.randn(WORD_DIM, generator=g),
                "<view_x>": torch.randn(WORD_DIM, generator=g)}, embeds)
    got = import_torch_artifacts(tmp_path / "port", view, embeds_path=embeds)
    want = j_import(tmp_path / "jax", view, embeds_path=embeds)
    assert [p.name for p in got] == [p.name for p in want] == [
        "mapper-steps-300_view.msgpack", "learned_embeds-steps-300.msgpack"]
    mine, ref = (CheckpointHandler.load_raw(p) for p in (got[0], want[0]))
    for part in ("params", "constants"):
        flat = twp._leaves(mine["mappers"]["view"][part])
        assert flat.keys() == twp._leaves(ref["mappers"]["view"][part]).keys()
        for k, v in twp._leaves(ref["mappers"]["view"][part]).items():
            np.testing.assert_array_equal(flat[k], v, err_msg=str(k))
    assert mine["view_tokens"] == ref["view_tokens"] == []
    cfg, _ = CheckpointHandler.load_mapper(got[0])
    assert cfg.model.arch_view_net == 15
    rows, ref_rows = (CheckpointHandler.load_learned_embeds(p)
                      for p in (got[1], want[1]))
    assert rows.keys() == ref_rows.keys()
    for k in rows:
        np.testing.assert_array_equal(rows[k], ref_rows[k])
