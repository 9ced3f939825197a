"""GroupNorm in view_neti_tpu_torch/ops/norm.py: the plain chain on CPU
tensors, the kernels' arithmetic in plain PyTorch (the statistics, the
normalize and group_norm_backward_ref) against autograd of the plain
chain, and on the card the hand-written kernels K5 (csrc/group_norm.cu)
against them.

The CPU tests run everywhere. The tests that need a CUDA device carry the
`cuda` marker and skip without a card. The file imports torch, numpy, the
port and the benchmark's kernel groups only; tests/conftest.py imports
JAX, so on a machine without JAX run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_group_norm.py -q
"""
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.trace import group_of
from view_neti_tpu_torch.ops import norm as tn
from view_neti_tpu_torch.utils import graphs

KERNEL_SOURCE = (Path(tn.__file__).resolve().parents[1] / "csrc"
                 / "group_norm.cu")


def _rand(shape, seed, dtype=torch.float32, dev="cpu", scale=2.0,
          shift=0.5):
    rng = np.random.RandomState(seed)
    t = torch.from_numpy((rng.randn(*shape) * scale + shift)
                         .astype(np.float32))
    return t.to(dev).to(dtype)


def _params(C, seed, dev="cpu"):
    rng = np.random.RandomState(seed + 1000)
    w = torch.from_numpy((1 + 0.3 * rng.randn(C)).astype(np.float32))
    b = torch.from_numpy((0.2 * rng.randn(C)).astype(np.float32))
    return w.to(dev), b.to(dev)


def _ulp_at_scale(ref):
    """One step of ref's dtype at the magnitude of its largest element."""
    m = ref.float().abs().max().item()
    bits = {torch.bfloat16: 8, torch.float32: 24}[ref.dtype]
    return 2.0 ** (math.floor(math.log2(m)) - bits + 1)


def _grads(fn, x0, w0, b0, g, params_grad):
    x = x0.clone().requires_grad_(True)
    w = w0.clone().requires_grad_(params_grad)
    b = b0.clone().requires_grad_(params_grad)
    y = fn(x, w, b)
    y.backward(g)
    return y.detach(), x.grad, w.grad, b.grad


# ---------------------------------------------------------------- CPU ----

@pytest.mark.parametrize("params_grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("cg", [4, 10, 40, 80])
def test_function_plain_path_matches_the_autograd_chain(cg, silu, dtype,
                                                        params_grad):
    """GroupNormFunction's arithmetic in plain PyTorch (_stats_fold_ref,
    _apply_ref, group_norm_backward_ref) against autograd of the plain
    chain: the forward and the fold bit for bit; the backward's dx within
    1e-5 of its scale in fp32 and within one ulp at its scale in bf16,
    whether or not the parameters need a gradient; where they do, dgamma
    and dbeta (fp32) within 1e-5."""
    G = 3
    C = G * cg
    x0 = _rand((2, 5, 6, C), cg, dtype)
    w0, b0 = _params(C, cg)
    g = _rand((2, 5, 6, C), cg + 1, dtype, scale=1.0, shift=0.0)
    want = _grads(lambda x, w, b: tn.group_norm_ref(x, G, w, b, 1e-5, silu),
                  x0, w0, b0, g, params_grad)
    a, b, stats = tn._stats_fold_ref(x0, G, w0, b0, 1e-5)
    assert torch.equal(tn._apply_ref(x0, a, b, silu), want[0])
    ra, rb = tn.group_norm_fold_ref(x0, G, w0, b0, 1e-5)
    assert torch.equal(a, ra) and torch.equal(b, rb)
    got = tn.group_norm_backward_ref(g, x0, w0, a, b, stats, G, 1e-5, silu)
    if dtype == torch.float32:
        tol = 1e-5 * want[1].abs().max().item()
        torch.testing.assert_close(got[0], want[1], rtol=1e-5, atol=tol)
    else:
        assert ((got[0].float() - want[1].float()).abs().max().item()
                <= _ulp_at_scale(want[1]))
    for have, ref in zip(got[1:], want[2:]):
        if not params_grad:
            assert ref is None
            continue
        torch.testing.assert_close(have, ref, rtol=1e-5,
                                   atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_on_cpu_is_the_plain_chain(dtype, silu):
    """On a CPU tensor the module's forward and fold are group_norm_ref and
    group_norm_fold_ref bit for bit, and launch nothing."""
    gn = tn.GroupNorm(4, 32, eps=1e-6)
    w, b = _params(32, 3)
    gn.load_state_dict({"weight": w, "bias": b})
    x = _rand((2, 4, 5, 32), 3, dtype)
    before = tn.group_norm.launches
    with torch.no_grad():
        assert torch.equal(gn(x, silu=silu),
                           tn.group_norm_ref(x, 4, w, b, 1e-6, silu))
        ga, gb = gn(x, fold=True)
    ra, rb = tn.group_norm_fold_ref(x, 4, w, b, 1e-6)
    assert torch.equal(ga, ra) and torch.equal(gb, rb)
    assert tn.group_norm.launches == before


def _parent_forward(self, x, fold=False, silu=False):
    """The module's forward at the parent commit (ops/norm.py), with the
    call sites' F.silu after it."""
    B, C = x.shape[0], x.shape[-1]
    G = self.num_groups
    x32 = x.reshape(B, -1, G, C // G).float()
    mean = x32.mean(dim=(1, 3), keepdim=True)
    mean2 = x32.square().mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    a = torch.rsqrt(var + self.eps) * self.weight.float().reshape(
        1, 1, G, C // G)
    b = self.bias.float().reshape(1, 1, G, C // G) - mean * a
    a, b = a.reshape(B, C), b.reshape(B, C)
    if fold:
        return a, b
    y = x.reshape(B, -1, C).float() * a[:, None, :] + b[:, None, :]
    y = y.reshape(x.shape).to(x.dtype)
    return F.silu(y) if silu else y


def test_unet_and_vae_forwards_on_cpu_equal_the_parents(monkeypatch):
    """The tiny UNet and VAE in fp32 on the CPU give bit for bit what they
    gave with the parent commit's GroupNorm and its call sites' F.silu."""
    from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                                 tiny_unet_config)
    from view_neti_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
    from view_neti_tpu_torch.training import builder
    g = torch.Generator("cpu").manual_seed(0)
    unet = builder._make(UNet2DCondition, tiny_unet_config(), "cpu", g,
                         torch.float32)
    vae = builder._make(AutoencoderKL, tiny_vae_config(), "cpu", g,
                        torch.float32)
    lat = _rand((2, 16, 16, 4), 7, scale=1.0, shift=0.0)
    t = torch.tensor([999.0, 400.0])
    ctx = _rand((2, 16, 32), 8, scale=1.0, shift=0.0)
    img = _rand((1, 32, 32, 3), 9, scale=0.5, shift=0.0)

    def run():
        with torch.no_grad():
            return (unet(lat, t, ctx), vae.decode(lat),
                    vae.encode_mode(img))

    now = run()
    monkeypatch.setattr(tn.GroupNorm, "forward", _parent_forward)
    parent = run()
    for have, want in zip(now, parent):
        assert torch.equal(have, want)


def _kernel_names():
    return re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(",
                      KERNEL_SOURCE.read_text())


def test_every_k5_kernel_is_filed_under_reduction_norm():
    """The benchmark's breakdown (benchmark/trace.py::group_of) files each
    of K5's kernels, under its bare name and as the profiler names a
    template instantiation, under reduction/norm, not under cuDNN."""
    names = _kernel_names()
    assert len(names) == 6 and all("norm" in n for n in names)
    for n in names:
        for shown in (n, f"void (anonymous namespace)::{n}<__nv_bfloat16, 8, "
                         f"true>(__nv_bfloat16 const*, float const*, float "
                         f"const*, __nv_bfloat16*, (anonymous namespace)::"
                         f"Grid)"):
            assert group_of(shown) == "reduction/norm", shown


def test_launch_counts_list_k5():
    """K5 is a key of launch_counts, set, replayed and reset with the
    rest."""
    saved = graphs.launch_counts()
    try:
        graphs.set_launch_counts({"K5": 3})
        assert tn.group_norm.launches == 3
        got = graphs.launch_counts()
        assert list(got)[:5] == ["K1", "K2", "K3", "K4", "K5"]
        assert got["K5"] == 3

        class _Graph:
            def replay(self):
                pass

        cap = graphs.Capture(_Graph(), [], [], None, {"K5": 122}, 0.0, 0)
        graphs.Graphed(lambda x: x, "step").replay(cap)
        assert graphs.launch_counts()["K5"] == 125
        assert graphs.launch_counts(reset=True)["K5"] == 0
        assert tn.group_norm.launches == 0
    finally:
        graphs.set_launch_counts(saved)


# the paths' extremes: the UNet's lowest level (6x8 at batch 9, 9x12 at
# batch 4 and 6) and its top level, the decoder's 576x768 level at batch 2
# and 3, the encoder's 384x512 at batch 9; the tiny configs
PLAN_SHAPES = [(9, 48, 1280), (9, 48, 2560), (6, 108, 2560), (4, 108, 1280),
               (6, 6912, 320), (9, 3072, 960), (3, 442368, 128),
               (2, 442368, 256), (9, 196608, 128), (2, 256, 16), (1, 9, 24)]


@pytest.mark.parametrize("B,P,C", PLAN_SHAPES)
@pytest.mark.parametrize("vec", [8, 4, 1])
def test_norm_plan_covers_the_shape_and_fills_the_card(B, P, C, vec):
    """norm_plan's blocks tile every pixel and channel once (the kernels'
    my_column) and number TARGET_BLOCKS within a factor where the shape has
    the rows for it, never more than 1.25x."""
    tx, ty, rows, nchunks = tn.norm_plan(B, P, C, vec)
    ncols = C // vec
    assert 0 < tx <= 32 and tx * ty <= tn.THREADS and ty >= 1
    assert rows % ty == 0 and rows * nchunks >= P > rows * (nchunks - 1)
    ctiles = -(-ncols // tx)
    assert ctiles * tx >= ncols > (ctiles - 1) * tx
    blocks = ctiles * nchunks * B
    assert blocks <= 1.25 * tn.TARGET_BLOCKS or nchunks == 1
    if P * B * ctiles >= 2 * ty * tn.TARGET_BLOCKS:
        assert blocks >= 0.5 * tn.TARGET_BLOCKS


# ------------------------------------- chip_smoke's K5 tables, on meta ----

def _trace_sites(module, run):
    """(H, W, C, kind, eps, x needs grad) of every GroupNorm call of run(),
    in order; kind "fold", "silu" or "norm"."""
    from view_neti_tpu_torch.ops.norm import GroupNorm
    calls = []

    def hook(mod, args, kwargs, out):
        x = args[0]
        kind = ("fold" if kwargs.get("fold") else
                "silu" if kwargs.get("silu") else "norm")
        calls.append((*x.shape[1:4], kind, mod.eps, x.requires_grad))

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in module.modules() if isinstance(m, GroupNorm)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return calls


@pytest.fixture
def meta_kernels(monkeypatch):
    """The models' kernels as shape-only stand-ins, so a full-size forward
    traces on the meta device: attention keeps q's shape and carries k's
    and v's gradient, K4 is its plain version."""
    from view_neti_tpu_torch.models import unet as um
    from view_neti_tpu_torch.models import vae as vm
    from view_neti_tpu_torch.ops import fused_conv as fc
    monkeypatch.setattr(um, "multi_head_attention",
                        lambda q, k, v: q + 0 * (k.sum() + v.sum()))
    for mod in (um, vm):
        monkeypatch.setattr(mod, "fused_affine_silu_conv3x3",
                            fc.fused_affine_silu_conv3x3_ref)


def _meta_unet(arch):
    from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                                 sd15_unet_config,
                                                 sd21_unet_config)
    cfg = {"sd15": sd15_unet_config, "sd21": sd21_unet_config}[arch]()
    with torch.device("meta"):
        return UNet2DCondition(cfg).requires_grad_(False)


@pytest.mark.parametrize("arch,h,w", [("sd15", 72, 96), ("sd15", 48, 64),
                                      ("sd15", 64, 64), ("sd21", 72, 96),
                                      ("sd21", 48, 64)])
def test_unet_norm_sites_are_the_unets_groupnorms(meta_kernels, arch, h, w):
    """chip_smoke.unet_norm_sites, which K5's launch checks (61 a forward,
    58 a train step's backward) and its shapes on the paths come from, is
    the full-size UNet's GroupNorms in order: shape, SiLU, eps, and whether
    a backward from a context that needs a gradient passes through it."""
    import chip_smoke
    unet = _meta_unet(arch)
    D = unet.config.cross_attention_dim
    ctx = torch.empty(2, 77, D, device="meta", requires_grad=True)
    got = _trace_sites(unet, lambda: unet(
        torch.empty(2, h, w, 4, device="meta"),
        torch.empty(2, device="meta"), ctx))
    want = [site[:6] for site in chip_smoke.unet_norm_sites(h, w)]
    assert got == want
    assert len(got) == chip_smoke.K5_SITES["forward"] == 61
    assert sum(g for *_, g in got) == chip_smoke.K5_SITES["backward"] == 58


def test_fused_unet_norm_sites_fold_at_every_resnet(meta_kernels):
    """With UNetConfig.fuse_conv every ResNet norm is a fold feeding K4
    and the other norms stay: unet_norm_sites' resnet flag."""
    import chip_smoke
    unet = _meta_unet("sd15")
    unet.config = dataclasses.replace(unet.config, fuse_conv=True)
    with torch.no_grad():
        got = _trace_sites(unet, lambda: unet(
            torch.empty(6, 72, 96, 4, device="meta"),
            torch.empty(6, device="meta"),
            torch.empty(6, 77, 768, device="meta")))
    want = [(H, W, C, "fold" if resnet else kind, eps, False)
            for H, W, C, kind, eps, _, resnet
            in chip_smoke.unet_norm_sites(72, 96)]
    assert got == want and sum(k == "fold" for *_, k, _, _ in got) == 44


@pytest.mark.parametrize("what,h,w", [("decode", 72, 96), ("decode", 64, 64),
                                      ("encode", 384, 512),
                                      ("encode", 512, 512)])
def test_vae_norm_sites_are_the_vaes_groupnorms(meta_kernels, what, h, w):
    """chip_smoke.vae_norm_sites is the fused VAE's GroupNorms at the
    paths' sizes: a fold before each K4 section and the attention norm,
    30 a decode and 22 an encode, eps 1e-6."""
    import chip_smoke
    from view_neti_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig(fuse_conv=True)).requires_grad_(False)
    fn, C = (vae.decode, 4) if what == "decode" else (vae.encode_mode, 3)
    with torch.no_grad():
        got = _trace_sites(vae, lambda: fn(
            torch.empty(1, h, w, C, device="meta")))
    assert {eps for *_, eps, _ in got} == {1e-6}
    want = chip_smoke.vae_norm_sites(what, h, w)
    assert sorted(site[:4] for site in got) == sorted(want)
    assert len(got) == chip_smoke.K5_SITES[what]


def test_k5_shapes_give_every_paths_launch_checks():
    """k5_shapes' launches on each path are path_k5's (what phase_kernels
    checks before it runs a kernel): a path's UNet forwards are
    attention_shapes' K1 launches over 32 and its backwards K2's over 30,
    its encodes and decodes path_codecs'; a train step 141, a serving run
    30 forwards and a decode."""
    import chip_smoke
    shapes = chip_smoke.k5_shapes()
    want = chip_smoke.path_k5()
    assert chip_smoke.k5_split_by_path(shapes) == want
    assert set(want) == set(chip_smoke.REPORT_PATHS)
    k1, k2 = {}, {}
    for row in chip_smoke.attention_shapes(chip_smoke.SERVE_STEPS):
        for key, acc in (("K1", k1), ("K2", k2)):
            for p, n in row["per_run"].get(key, {}).items():
                acc[p] = acc.get(p, 0) + n
    codecs = chip_smoke.path_codecs()
    for p, counts in want.items():
        enc, dec = codecs.get(p, (0, 0))
        fwd = k1[p] // 32 if p != "serve_fused_unet" else k1["serve"] // 32
        assert counts == chip_smoke.k5(fwd, k2.get(p, 0) // 30, enc, dec), p
    assert want["train"] == chip_smoke.k5(1, 1, 1) == {"K5": 141}
    assert want["serve"] == {"K5": 30 * 61 + 30}
    assert chip_smoke.SD15_STEP["K5"] == 141
    kinds = {r["kind"] for r in shapes}
    assert kinds == set(chip_smoke.K5_PASSES)
    heaviest = chip_smoke.k5_heaviest(shapes)
    assert {k: (r["B"], r["H"], r["W"], r["C"], r["kind"])
            for k, r in heaviest.items()} == {
        "fold": (3, 576, 768, 256, "fold"),
        "forward": (6, 72, 96, 960, "silu"),
        "backward": (9, 64, 64, 960, "backward silu")}


def _k5_row(shape, kind, ms, per_run, B=9, H=48, W=64, C=960):
    return dict(shape=shape, B=B, H=H, W=W, C=C, kind=kind, eps=1e-5,
                per_run=per_run, max_abs_err=1e-3, err_of_limit=0.5,
                control_of_limit=50.0, controls={"chunk": 50.0},
                ms=ms, plain_ms=5 * ms, bound_ms=0.8 * ms, bound_by="bytes",
                share_of_bound=0.8)


def test_kernel_report_lists_k5():
    """The kernels line ends with K5's entry where phase_kernels measured
    it: its launches from each path's "K5" count, its worst check and
    weakest control, the heaviest shape of each kind and of all, and its
    sums over each path that runs it."""
    import chip_smoke
    rows = [_k5_row("fold", "fold", 0.3, {"serve": 1}, 3, 576, 768, 256),
            _k5_row("silu", "silu", 0.2, {"serve": 30, "train": 1}),
            _k5_row("bwd", "backward silu", 0.25, {"train": 1})]
    rows[1]["err_of_limit"] = 0.9
    rows[2]["control_of_limit"] = 20.0
    rows[0].update(graph_ms=0.28, host_us=12.0)
    launches = {"serve": {**chip_smoke.unet_k1(30),
                          **chip_smoke.k5(30, decodes=1)},
                "train": dict(chip_smoke.SD15_STEP)}
    others = [dict(shape="s", design=d, per_run={"train": 1},
                   max_abs_err=1e-3, err_of_limit=0.1, control_of_limit=3.0,
                   ms=1.0, plain_ms=2.0, library_ms=1.5, bound_ms=0.5,
                   bound_by="bytes", share_of_bound=0.5)
              for d in ("sm90", "mma_sync")]
    kernels = {key: others for key in ("K1", "K2", "K3", "K4")}
    report = chip_smoke.kernel_report(kernels, launches, "H100, 700 W")
    assert "group_norm" not in [e["name"] for e in report]
    report = chip_smoke.kernel_report(dict(kernels, K5=rows), launches,
                                      "H100, 700 W")
    assert len(report) == 9
    entry = report[-1]
    assert entry["name"] == "group_norm"
    assert entry["source"] == "view_neti_tpu_torch/csrc/group_norm.cu"
    assert entry["launches_by_path"] == {"serve": 1860, "train": 141}
    assert entry["launches"] == 2001
    assert entry["err_of_limit"] == 0.9 and entry["control_of_limit"] == 20.0
    assert entry["shape"] == "fold" and entry["ms"] == 0.3
    assert entry["by_kind"]["fold"]["graph_ms"] == 0.28
    assert set(entry["by_kind"]) == {"fold", "forward", "backward"}
    assert entry["serve_path_ms"] == pytest.approx(0.3 + 30 * 0.2)
    assert entry["train_path_ms"] == pytest.approx(0.2 + 0.25)
    assert entry["train_path_plain_ms"] == pytest.approx(5 * 0.45)
    assert entry["train_path_share_of_bound"] == pytest.approx(0.8)
    assert "validate_path_ms" not in entry


# ------------------------------------------------------------- the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _levels(B, H, W, chans):
    return [(B, H, W, c) for c in chans]


# every GroupNorm shape of the four cells' paths (G 32): the UNet's four
# levels at render batch 6 (SD-1.5) and 4 (SD-2.1) and train batch 9 with
# each level's channel counts (the up blocks' concatenations included),
# the decoder at 576x768 and its lower levels at batch 3, the encoder at
# 384x512 and its lower levels at batch 9
UNET_CHANNELS = ((320, 640, 960), (320, 640, 960, 1280, 1920),
                 (640, 1280, 1920, 2560), (1280, 2560))
PATH_SHAPES = (
    [s for B, (H, W) in ((6, (72, 96)), (4, (72, 96)), (9, (48, 64)))
     for lvl, chans in enumerate(UNET_CHANNELS)
     for s in _levels(B, H >> lvl, W >> lvl, chans)]
    + _levels(3, 576, 768, (128, 256)) + _levels(3, 288, 384, (256, 512))
    + _levels(3, 144, 192, (512,)) + _levels(3, 72, 96, (512,))
    + _levels(9, 384, 512, (128,)) + _levels(9, 192, 256, (128, 256))
    + _levels(9, 96, 128, (256, 512)) + _levels(9, 48, 64, (512,)))


def _k5(x, w, b, eps, silu):
    before = tn.group_norm.launches
    out, a, bb, stats = tn._forward_kernels(x, 32, w, b, eps, silu,
                                            apply=True)
    torch.cuda.synchronize()
    assert tn.group_norm.launches == before + 1
    return out, a, bb, stats


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C", PATH_SHAPES)
def test_k5_forward_matches_plain_at_the_path_shapes(dev, B, H, W, C):
    """At every path shape: K5's affine within 2e-5 of the plain fold's
    (the sums run in another order), its statistics the plain ones', its
    normalize, with and without the SiLU, bit for bit the plain chain's
    on K5's affine, and its fold the same affine."""
    x = _rand((B, H, W, C), C + H, torch.bfloat16, dev)
    w, b = _params(C, C, dev)
    eps = 1e-6 if C in (128, 256, 512) else 1e-5
    ra, rb, rstats = tn._stats_fold_ref(x, 32, w, b, eps)
    for silu in (False, True):
        out, a, bb, stats = _k5(x, w, b, eps, silu)
        torch.testing.assert_close(a, ra, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(bb, rb, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(stats, rstats, rtol=2e-5, atol=2e-5)
        assert torch.equal(out, tn._apply_ref(x, a, bb, silu))
        del out
    fa, fb = tn.group_norm_fold(x, 32, w, b, eps)
    assert torch.equal(fa, a) and torch.equal(fb, bb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C,G", [(torch.float32, 64, 8),
                                       (torch.float32, 6, 3),
                                       (torch.bfloat16, 36, 3),
                                       (torch.bfloat16, 16, 4)])
def test_k5_other_widths_and_fp32(dev, dtype, C, G):
    """fp32 activations (16-byte and one-element loads), a bf16 width that
    is not a multiple of 8 (one-element loads) and the tiny VAE's C/G 4:
    the output within two bf16 ulps at its scale of the plain chain's (its
    affine differs in the last fp32 bits, which can flip the rounding of
    the normalize and, through the SiLU, of its output), or 1e-5 of it in
    fp32."""
    x = _rand((3, 7, 9, C), C, dtype, dev)
    w, b = _params(C, C, dev)
    for silu in (False, True):
        got = tn.group_norm(x, G, w, b, 1e-5, silu)
        want = tn.group_norm_ref(x, G, w, b, 1e-5, silu)
        tol = (2 * _ulp_at_scale(want) if dtype == torch.bfloat16
               else 1e-5 * want.abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol


# the train step's UNet shapes at batch 9 (its four levels, the largest
# and a concatenated channel count each)
BWD_SHAPES = [(9, 48, 64, 320), (9, 48, 64, 960), (9, 24, 32, 1920),
              (9, 12, 16, 2560), (9, 6, 8, 1280), (9, 6, 8, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("params_grad", [False, True])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("B,H,W,C", BWD_SHAPES)
def test_k5_backward_matches_autograd_of_plain(dev, B, H, W, C, silu,
                                               params_grad):
    """K5's backward against autograd of the plain chain on the card: dx
    within two ulps at its scale (K5's affine differs from the plain one
    in the last fp32 bits, which can flip a rounding of the normalize that
    the SiLU's derivative reads), dgamma and dbeta within 1e-4; and
    against its plain version in its own arithmetic on its own statistics
    within one ulp."""
    x0 = _rand((B, H, W, C), C, torch.bfloat16, dev)
    w0, b0 = _params(C, C, dev)
    g = _rand((B, H, W, C), C + 1, torch.bfloat16, dev, scale=1.0, shift=0.0)
    before = tn.group_norm.launches
    got = _grads(lambda x, w, b: tn.group_norm(x, 32, w, b, 1e-5, silu),
                 x0, w0, b0, g, params_grad)
    torch.cuda.synchronize()
    assert tn.group_norm.launches == before + 2
    want = _grads(lambda x, w, b: tn.group_norm_ref(x, 32, w, b, 1e-5, silu),
                  x0, w0, b0, g, params_grad)
    assert ((got[1].float() - want[1].float()).abs().max().item()
            <= 2 * _ulp_at_scale(want[1]))
    for have, ref in zip(got[2:], want[2:]):
        if not params_grad:
            assert have is None and ref is None
            continue
        torch.testing.assert_close(have, ref, rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())
    _, a, b, stats = tn._forward_kernels(x0, 32, w0, b0, 1e-5, silu,
                                         apply=False)
    dx, dgamma, dbeta = tn._backward_kernels(g, x0, w0, a, b, stats, 32,
                                             1e-5, silu, True, True)
    rdx, rdgamma, rdbeta = tn.group_norm_backward_ref(g, x0, w0, a, b, stats,
                                                      32, 1e-5, silu)
    assert ((dx.float() - rdx.float()).abs().max().item()
            <= _ulp_at_scale(rdx))
    torch.testing.assert_close(dgamma, rdgamma, rtol=1e-5,
                               atol=1e-5 * rdgamma.abs().max().item())
    torch.testing.assert_close(dbeta, rdbeta, rtol=1e-5,
                               atol=1e-5 * rdbeta.abs().max().item())


@pytest.mark.cuda
def test_k5_is_deterministic(dev):
    """No float atomics: two runs of the forward and the backward at the
    decoder's and the train step's largest shapes are bit-equal."""
    for shape, silu in (((3, 576, 768, 128), False), ((9, 48, 64, 960), True)):
        x = _rand(shape, 1, torch.bfloat16, dev).requires_grad_(True)
        w, b = _params(shape[-1], 1, dev)
        g = _rand(shape, 2, torch.bfloat16, dev, scale=1.0, shift=0.0)
        runs = []
        for _ in range(2):
            y = tn.group_norm(x, 32, w, b, 1e-6, silu)
            dx, = torch.autograd.grad(y, x, g)
            runs.append((y, dx, *tn.group_norm_fold(x.detach(), 32, w, b,
                                                    1e-6)))
        for u, v in zip(*runs):
            assert torch.equal(u, v)


@pytest.mark.cuda
def test_k5_graph_replay_equals_eager(dev):
    """Forward and backward captured in a CUDA graph (utils/graphs.py):
    every replay bit-equal to the eager call, and K5's two launches a call
    counted on every replay."""
    x = _rand((9, 24, 32, 1920), 3, torch.bfloat16, dev)
    w, b = _params(1920, 3, dev)
    g = _rand(x.shape, 4, torch.bfloat16, dev, scale=1.0, shift=0.0)

    def step(x, g):
        x = x.detach().requires_grad_(True)
        y = tn.group_norm(x, 32, w, b, 1e-5, silu=True)
        dx, = torch.autograd.grad(y, x, g)
        return y, dx

    want = step(x, g)
    graphed = graphs.Graphed(step, "group_norm")
    before = tn.group_norm.launches
    outs = [graphed(x, g) for _ in range(4)]
    torch.cuda.synchronize()
    assert tn.group_norm.launches == before + 2 * 4
    for y, dx in outs:
        assert torch.equal(y, want[0]) and torch.equal(dx, want[1])


def _count_sites(module, calls):
    from view_neti_tpu_torch.ops.norm import GroupNorm

    def hook(mod, args, kwargs, out):
        if kwargs.get("fold"):
            calls.append(("fold", False))
        else:
            calls.append(("norm", out.requires_grad))
    return [m.register_forward_hook(hook, with_kwargs=True)
            for m in module.modules() if isinstance(m, GroupNorm)]


@pytest.mark.cuda
def test_every_groupnorm_of_tiny_unet_and_vae_launches_k5(dev, monkeypatch):
    """A tiny bf16 UNet forward and backward and VAE encode and decode,
    fused and unfused: K5 launches once at every GroupNorm site (a forward
    or a fold) and once more at every site the backward passes through,
    and the plain chain never runs on the card."""
    from view_neti_tpu_torch.models.unet import (UNet2DCondition,
                                                 tiny_unet_config)
    from view_neti_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
    from view_neti_tpu_torch.training import builder

    def refuse(*args, **kwargs):
        raise AssertionError("the plain GroupNorm chain ran on the card")

    monkeypatch.setattr(tn, "group_norm_ref", refuse)
    monkeypatch.setattr(tn, "group_norm_fold_ref", refuse)
    monkeypatch.setattr(tn, "_stats_fold_ref", refuse)
    gen = torch.Generator(dev).manual_seed(0)
    unet = builder._make(UNet2DCondition, tiny_unet_config(), dev, gen,
                         torch.bfloat16)
    vae = builder._make(AutoencoderKL, tiny_vae_config(), dev, gen,
                        torch.bfloat16)
    calls = []
    hooks = _count_sites(unet, calls) + _count_sites(vae, calls)
    try:
        lat = _rand((3, 16, 16, 4), 7, dev=dev, scale=1.0, shift=0.0)
        t = torch.tensor([999.0, 500.0, 20.0], device=dev)
        ctx = _rand((3, 16, 32), 8, dev=dev, scale=1.0,
                    shift=0.0).requires_grad_(True)
        before = tn.group_norm.launches
        out = unet(lat, t, ctx)
        n_fwd = tn.group_norm.launches - before
        assert n_fwd == len(calls) > 0
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        n_bwd = sum(grad for _, grad in calls)
        assert 0 < n_bwd < len(calls)
        assert tn.group_norm.launches - before == n_fwd + n_bwd
        assert bool(torch.isfinite(ctx.grad).all())

        img = _rand((2, 32, 32, 3), 9, dev=dev, scale=0.5, shift=0.0)
        for fuse in (False, True):
            vae.config = dataclasses.replace(vae.config, fuse_conv=fuse)
            calls.clear()
            before = tn.group_norm.launches
            with torch.no_grad():
                z = vae.encode_mode(img.bfloat16())
                rec = vae.decode(z)
            torch.cuda.synchronize()
            kinds = {kind for kind, _ in calls}
            assert kinds == ({"fold", "norm"} if fuse else {"norm"})
            assert tn.group_norm.launches - before == len(calls) > 0
            assert bool(torch.isfinite(rec.float()).all())
    finally:
        for h in hooks:
            h.remove()


@pytest.mark.cuda
def test_k5_refuses_what_it_does_not_take(dev):
    """A dtype other than bf16 and fp32, a group count that does not divide
    C, more than 256 channels a group and a fold with inputs that require
    grad under grad mode raise; nothing falls back to the plain chain."""
    w, b = _params(64, 0, dev)
    x = _rand((2, 4, 4, 64), 0, torch.float16, dev)
    with pytest.raises(ValueError, match="bf16 and fp32"):
        tn.group_norm(x, 8, w, b, 1e-5)
    with pytest.raises(ValueError, match="whole number"):
        tn.group_norm(x.bfloat16(), 5, w, b, 1e-5)
    w2, b2 = _params(512, 0, dev)
    with pytest.raises(ValueError, match="at most 256"):
        tn.group_norm(_rand((1, 2, 2, 512), 0, torch.bfloat16, dev), 1,
                      w2, b2, 1e-5)
    with pytest.raises(RuntimeError, match="forward-only"):
        tn.group_norm_fold(x.bfloat16().requires_grad_(True), 8, w, b, 1e-5)
