"""The export side of the port's torch_interop against the JAX package's
(view_neti_tpu/torch_interop.py:339-527), on the same msgpack files:
arch-15 view mappers (Fourier encoders of the DTU, phi and theta-phi
cameras), a bank of two object mappers, a legacy PE-1 object mapper (the
NeTI encoder), a PE-0 mapper (the basic encoder) and learned embeddings.
The payloads are equal key for key and tensor for tensor, each package
re-imports the other's export bit for bit, and the command line writes the
same files."""
import zipfile

import numpy as np
import pytest
import torch

from view_neti_tpu import torch_interop as jinterop
from view_neti_tpu.checkpoint import CheckpointHandler as JHandler
from view_neti_tpu.config import RunConfig as JRunConfig
from view_neti_tpu.config import decode as jdecode
from view_neti_tpu_torch import export_torch
from view_neti_tpu_torch import torch_interop as tinterop

W = 32      # word embedding width
H = 48      # mapper hidden width


def mapper_tree(seed, pe_in=64, legacy=False):
    """A mapper's parameters in the checkpoint files' (JAX) layout."""
    r = np.random.RandomState(seed)

    def dense(i, o):
        return {"kernel": r.randn(i, o).astype(np.float32),
                "bias": r.randn(o).astype(np.float32)}

    def ln(n):
        return {"scale": r.randn(n).astype(np.float32),
                "bias": r.randn(n).astype(np.float32)}

    tree = {"net_dense0": dense(pe_in, H), "net_ln0": ln(H),
            "net_dense1": dense(H, H), "net_ln1": ln(H),
            "output_layer": dense(H, 2 * W)}
    if legacy:
        tree["input_layer"] = dense(2048, pe_in)
    return tree


def cfg(camera="dtu-12d", mode=2, **data):
    return jdecode(JRunConfig, {
        "learnable_mode": mode,
        "model": {"arch_view_net": 15, "word_embedding_dim": W,
                  "pe_sigmas": {"sigma_t": 0.03, "sigma_l": 2.0,
                                "sigma_phi": 1.5, "sigma_theta": 0.7,
                                "sigma_dtu12": 0.5}},
        "data": dict({"camera_representation": camera}, **data)})


VIEWS = {"dtu": ("dtu-12d", 14), "phi": ("spherical", 3),
         "theta-phi": ("spherical", 4)}


def write_view(tmp_path, kind):
    camera, nfeats = VIEWS[kind]
    r = np.random.RandomState(nfeats)
    constants = {"fourier_w": r.randn(32, nfeats).astype(np.float32)}
    h = JHandler(cfg(camera), ["<view_0_0_1>"], [500], [], [], tmp_path)
    return h.save_mapper({"view": mapper_tree(nfeats)}, None, constants,
                         None, "mapper-steps-300.msgpack")[0]


OBJECTS = {
    "bank": dict(tokens=["<skull>", "<house>"], legacy=False,
                 constants={"fourier_w": np.random.RandomState(5).randn(
                     32, 2).astype(np.float32)}),
    "neti": dict(tokens=["<teapot>"], legacy=True,
                 constants={"neti_w": np.random.RandomState(6).randn(
                     1024, 2).astype(np.float32)}),
    "basic": dict(tokens=["<cup>"], legacy=False, constants=None),
}


def write_objects(tmp_path, kind):
    spec = OBJECTS[kind]
    toks = spec["tokens"]
    trees = [mapper_tree(10 + i, legacy=spec["legacy"])
             for i in range(len(toks))]
    bank = {k: {leaf: np.stack([t[k][leaf] for t in trees])
                for leaf in trees[0][k]} for k in trees[0]}
    c = cfg(mode=3 if len(toks) > 1 else 2,
            placeholder_object_tokens=toks,
            super_category_object_tokens=["object"] * len(toks))
    h = JHandler(c, [], [], toks, list(range(501, 501 + len(toks))),
                 tmp_path)
    return h.save_mapper({"object": bank}, spec["constants"], None, None,
                         "mapper-steps-900.msgpack")[0]


def write_embeds(tmp_path):
    from flax import serialization
    rows = {t: np.random.RandomState(i).randn(W).astype(np.float32)
            for i, t in enumerate(("<view_0_0_1>", "<skull>"))}
    p = tmp_path / "learned_embeds-steps-300.msgpack"
    p.write_bytes(serialization.msgpack_serialize(rows))
    return p, rows


ENCODER_ATTRS = ("sigmas", "dim", "normalize", "w", "sigma_t", "sigma_l",
                 "num_w", "normalized_timesteps", "normalized_unet_layers")


def assert_payloads_equal(got, want):
    assert set(got) == set(want)
    assert got["cfg"] == want["cfg"]
    assert list(got["mappers"]) == list(want["mappers"])
    for key, e in want["mappers"].items():
        g = got["mappers"][key]
        assert g["placeholder_object_token"] == e["placeholder_object_token"]
        assert list(g["state_dict"]) == list(e["state_dict"])
        for k, v in e["state_dict"].items():
            assert g["state_dict"][k].dtype == v.dtype
            assert torch.equal(g["state_dict"][k], v), k
        ge, we = g["encoder"], e["encoder"]
        assert type(ge).__name__ == type(we).__name__
        assert type(ge).__module__ == "models.positional_encoding"
        for a in ENCODER_ATTRS:
            assert hasattr(ge, a) == hasattr(we, a), a
            if hasattr(we, a):
                x, y = getattr(ge, a), getattr(we, a)
                assert (torch.equal(x, y) if isinstance(y, torch.Tensor)
                        else x == y), a


def assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("kind", sorted(VIEWS))
def test_view_export_equals_jax(tmp_path, kind):
    path = write_view(tmp_path, kind)
    got = tinterop.export_mapper_checkpoint(path, "view")
    want = jinterop.export_mapper_checkpoint(path, "view")
    assert_payloads_equal(got, want)
    enc = got["mappers"]["dummy_key"]["encoder"]
    nfeats = VIEWS[kind][1]
    assert len(enc.sigmas) == nfeats and enc.dim == 64
    assert "encoder.w" not in got["mappers"]["dummy_key"]["state_dict"]


@pytest.mark.parametrize("kind", sorted(OBJECTS))
def test_object_export_equals_jax(tmp_path, kind):
    path = write_objects(tmp_path, kind)
    got = tinterop.export_mapper_checkpoint(path, "object")
    want = jinterop.export_mapper_checkpoint(path, "object")
    assert_payloads_equal(got, want)
    assert sorted(e["placeholder_object_token"]
                  for e in got["mappers"].values()) == sorted(
        OBJECTS[kind]["tokens"])


def test_learned_embeds_export_equals_jax(tmp_path):
    path, rows = write_embeds(tmp_path)
    got = tinterop.export_learned_embeds(path)
    want = jinterop.export_learned_embeds(path)
    assert list(got) == list(want) == sorted(rows)
    for t in rows:
        assert torch.equal(got[t], want[t])


def _files(tmp_path):
    return dict(view_path=write_view(tmp_path, "phi"),
                object_path=write_objects(tmp_path, "bank"),
                embeds_path=write_embeds(tmp_path)[0])


def test_each_package_reimports_the_others_export(tmp_path):
    """The port's .pt/.bin through the JAX importer and the JAX package's
    through the port's: the trees of the original msgpack files, bit for
    bit."""
    files = _files(tmp_path)
    ours = tinterop.export_torch_artifacts(tmp_path / "port", **files)
    theirs = jinterop.export_torch_artifacts(tmp_path / "jax", **files)
    assert [p.name for p in ours] == [p.name for p in theirs] == [
        "mapper-steps-300_view.pt", "mapper-steps-900_object.pt",
        "learned_embeds-steps-300.bin"]
    orig_view = tinterop.CheckpointHandler.load_raw(files["view_path"])
    orig_obj = tinterop.CheckpointHandler.load_raw(files["object_path"])
    for exported, importer in ((ours, jinterop), (theirs, tinterop)):
        view = importer.convert_mapper_checkpoint(exported[0], "view")
        assert_trees_equal(view["mappers"]["view"]["params"],
                           orig_view["mappers"]["view"]["params"])
        assert_trees_equal(view["mappers"]["view"]["constants"],
                           orig_view["mappers"]["view"]["constants"])
        obj = importer.convert_mapper_checkpoint(exported[1], "object")
        for tok in ("<skull>", "<house>"):
            assert_trees_equal(obj["mappers"][tok]["params"],
                               orig_obj["mappers"][tok]["params"])
        embeds = importer.convert_learned_embeds(exported[2])
        want = tinterop.CheckpointHandler.load_learned_embeds(
            files["embeds_path"])
        for t in want:
            np.testing.assert_array_equal(embeds[t], want[t])
    # the pickle names the reference's class path
    with zipfile.ZipFile(ours[0]) as z:
        pkl = next(n for n in z.namelist() if n.endswith("data.pkl"))
        assert b"models.positional_encoding" in z.read(pkl)


def test_export_cli_writes_what_the_library_writes(tmp_path, capsys):
    files = _files(tmp_path)
    written = export_torch.main([
        "--out", str(tmp_path / "cli"), "--view", str(files["view_path"]),
        "--object", str(files["object_path"]), "--embeds",
        str(files["embeds_path"]), "--iteration", "7"])
    assert [p.name for p in written] == [
        "mapper-steps-7_view.pt", "mapper-steps-7_object.pt",
        "learned_embeds-steps-7.bin"]
    assert "wrote" in capsys.readouterr().out
    for p, kind in zip(written[:2], ("view", "object")):
        assert_payloads_equal(
            tinterop.load_torch_checkpoint(p),
            jinterop.export_mapper_checkpoint(files[f"{kind}_path"], kind))
    with pytest.raises(SystemExit):
        export_torch.main(["--out", str(tmp_path / "none")])
