"""K4's Hopper design (csrc/fused_conv_sm90.cu) on the CPU: which shapes of
the paths it takes (ops/fused_conv.py::conv_design), the launch counts and
checks, spill check, profile groups and kernels line that follow K4's two
designs, and what the source holds. The kernel itself runs only on the card
(tests/test_torch_port_kernels.py -k conv, chip_smoke.py); its plain version
is held here against the Pallas kernel in interpret mode at the new
design's tile edges.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from view_neti_tpu.ops import fused_conv as jfc

from view_neti_tpu_torch.ops import build
from view_neti_tpu_torch.ops import fused_conv as tfc
from view_neti_tpu_torch.tools import conv_variants
from view_neti_tpu_torch.utils import graphs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's parallel regions spend most
    of their time waiting for cores; on one thread they do not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# vae_k4_shapes in its order: three decoders of 11 sections (serving, the
# sweep, the renders), then two encoders of 11 (the train step, the folder
# path's 512x512 one); the fused UNet's rows are
# tests/test_torch_port_unet_fused.py's
KINDS = ("serve decode", "sweep decode", "render decode", "train encode",
         "folders encode")


def _kinds():
    shapes = chip_smoke.vae_k4_shapes()
    kinds = [k for k in KINDS for _ in range(11)]
    assert len(kinds) == len(shapes)
    return list(zip(kinds, shapes))


# each kind's path and the decodes or encodes of that kind it runs
UNIT = {"serve decode": ("serve", 1),
        "sweep decode": ("inference", chip_smoke.INFER_CAMS),
        "render decode": ("validate", 1), "train encode": ("train", 1),
        "folders encode": ("folders", 2 * (chip_smoke.FOLDERS_WARM
                                           + chip_smoke.FOLDERS_STEPS))}


@pytest.mark.parametrize("kind", KINDS)
def test_conv_design_on_every_path_shape(kind):
    """Every ResNet conv (Cout 128 to 512) takes the Hopper design; the
    decoder's conv_out (128 -> 3) and the encoder's last conv (512 -> 8)
    stay on the mma.sync design: 28 of a decode's 29 launches and 20 of an
    encode's 21 on the Hopper design."""
    rows = [s for k, s in _kinds() if k == kind]
    per_design = {"sm90": 0, "mma_sync": 0}
    for _, _, _, ci, co, _, per_run in rows:
        want = "sm90" if co > 16 else "mma_sync"
        assert tfc.conv_design(ci, co) == want, (ci, co)
        # the section's launches a decode or an encode: its launches on a
        # path that runs the kind, over that path's runs of it
        path, runs = UNIT[kind]
        per_design[want] += per_run[path] // runs
    sm90 = chip_smoke.K4_SM90["encode" if "encode" in kind else "decode"]
    total = 21 if "encode" in kind else 29
    assert per_design == {"sm90": sm90, "mma_sync": total - sm90}
    assert (sm90, total) in ((20, 21), (28, 29))


@pytest.mark.parametrize("Co,want", [(3, "mma_sync"), (8, "mma_sync"),
                                     (16, "mma_sync"), (17, "sm90"),
                                     (24, "sm90"), (128, "sm90"),
                                     (512, "sm90")])
@pytest.mark.parametrize("Ci", [8, 72, 512])
def test_conv_design_at_its_cout_edges(Ci, Co, want):
    assert tfc.conv_design(Ci, Co) == want


def test_launch_checks_agree_with_conv_design_on_every_path():
    """What phase_kernels checks before it runs a kernel: conv_design over
    k4_shapes gives every path's K4 counts of the launch checks (k4 of the
    path's encodes and decodes, and the fused-UNet serving path's UNet
    forwards)."""
    split = chip_smoke.conv_split_by_path(chip_smoke.k4_shapes(),
                                          tfc.conv_design)
    codecs = chip_smoke.path_codecs()
    assert sorted(split) == sorted(codecs)
    want = chip_smoke.path_k4()
    for path, (enc, dec) in codecs.items():
        assert split[path] == chip_smoke.capture_record(want[path]), path
        if path != "serve_fused_unet":
            assert want[path] == chip_smoke.k4(enc, dec), path
    assert chip_smoke.k4(2, 3) == {"K4": 129, "K4 sm90": 124,
                                   "K4 mma_sync": 5}
    assert set(chip_smoke.k4().values()) == {0}
    assert {k: chip_smoke.SD15_STEP[k] for k in ("K4", "K4 sm90",
                                                 "K4 mma_sync")} == {
        "K4": 21, "K4 sm90": 20, "K4 mma_sync": 1}


@pytest.fixture
def saved_counts():
    """The launch counters as they were, restored after the test."""
    saved = graphs.launch_counts()
    yield
    graphs.set_launch_counts(saved)


def test_launch_counts_split_k4_by_design(saved_counts):
    """K4's launches by design are keys of launch_counts, set, replayed
    and reset with the rest."""
    graphs.set_launch_counts({"K4": 29, "K4 sm90": 28, "K4 mma_sync": 1})
    assert tfc.fused_affine_silu_conv3x3.launches == 29
    assert tfc.fused_affine_silu_conv3x3.designs == {"sm90": 28,
                                                     "mma_sync": 1}
    got = graphs.launch_counts()
    assert list(got)[-2:] == ["K4 sm90", "K4 mma_sync"]
    cap = graphs.Capture(_Graph(), [], [], None,
                         chip_smoke.capture_record(chip_smoke.k4(0, 1)),
                         0.0, 0)
    graphs.Graphed(lambda x: x, "decode").replay(cap)
    got = graphs.launch_counts()
    assert {k: got[k] for k in ("K4", "K4 sm90", "K4 mma_sync")} == {
        "K4": 58, "K4 sm90": 56, "K4 mma_sync": 2}
    assert graphs.launch_counts(reset=True) == dict.fromkeys(got, 0)
    assert tfc.fused_affine_silu_conv3x3.designs == {"sm90": 0,
                                                     "mma_sync": 0}


class _Graph:
    """A CUDA graph's stand-in: replay launches nothing."""
    def replay(self):
        pass


def test_cpu_tensors_take_the_plain_version_and_count_no_design(
        saved_counts):
    """On the CPU K4's wrapper is the plain version: no launch, no design
    counted, at a Hopper shape and a narrow one; the entry that forces a
    design refuses CPU tensors."""
    rng = np.random.RandomState(5)
    before = graphs.launch_counts()
    for co in (24, 8):
        x = torch.from_numpy(rng.randn(1, 9, 35, 16).astype(np.float32))
        ab = torch.ones(1, 16)
        w = torch.from_numpy(
            (rng.randn(3, 3, 16, co) * 0.1).astype(np.float32))
        got = tfc.fused_affine_silu_conv3x3(x, ab, ab, w)
        assert torch.equal(got, tfc.fused_affine_silu_conv3x3_ref(x, ab, ab,
                                                                  w))
    assert graphs.launch_counts() == before
    for design in ("sm90", "mma_sync"):
        with pytest.raises(ValueError, match="cpu"):
            tfc._fused_affine_silu_conv3x3_design(design, x.bfloat16(), ab,
                                                  ab, w.bfloat16())


# the name ptxas reports for the Hopper design's instantiation (a bool
# template argument mangles as Lb1E) and the mma.sync design's
SM90_SYMBOL = ("_ZN59_GLOBAL__N__0c3f2a1b_18_fused_conv_sm90_cu_5d1e7c2a22"
               "fused_conv_kernel_sm90ILi8ELi128ELi4ELb1ELi1EEEv14CUtensor"
               "Map_stS1_S1_8ConvArgsiii")
MMA_SYMBOL = ("_ZN59_GLOBAL__N__7a1b2c3d_13_fused_conv_cu_1a2b3c4d17fused_"
              "conv_kernelILi4ELi128ELi2ELi4ELi2EEEvN12_GLOBAL__N_18ConvArgs"
              "Eii")


def _log(symbol, regs=230, spill=0):
    return "\n".join([
        f"ptxas info    : Compiling entry function '{symbol}' for 'sm_90a'",
        f"ptxas info    : Function properties for {symbol}",
        f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes "
        f"spill loads",
        f"ptxas info    : Used {regs} registers, used 16 barriers"])


def test_spill_check_reads_the_conv_sm90_instantiation(capsys):
    """check_path_spills counts and prints the Hopper design's
    instantiation beside the mma.sync design's, all its template
    arguments, and fails on a spill in it; the build holds one more path
    instantiation."""
    usage = chip_smoke.ptxas_usage({"fused_conv_sm90": _log(SM90_SYMBOL),
                                    "fused_conv": _log(MMA_SYMBOL, 128)})
    assert chip_smoke.check_path_spills(usage) == 2
    out = capsys.readouterr().out
    assert ("build fused_conv_sm90: fused_conv_kernel_sm90<8, 128, 4, 1, "
            "1>: 230 registers, 0 bytes spill") in out
    assert ("build fused_conv: fused_conv_kernel<4, 128, 2, 4, 2>: 128 "
            "registers, 0 bytes spill") in out
    with pytest.raises(RuntimeError, match="spills 8 bytes"):
        chip_smoke.check_path_spills(chip_smoke.ptxas_usage(
            {"fused_conv_sm90": _log(SM90_SYMBOL, spill=8)}))
    assert chip_smoke.K4_SM90_INSTANTIATIONS == 1


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::fused_conv_kernel_sm90<8, 128, 4, true, 1>"
    "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous namespace)"
    "::ConvArgs, int, int, int)",
    "void (anonymous namespace)::fused_conv_kernel<4, 128, 2, 4, 2>("
    "(anonymous namespace)::ConvArgs, int, int)"])
def test_profiles_group_both_conv_designs_as_k4(name):
    assert chip_smoke.kernel_group(name) == "K4 fused_conv"


def test_the_source_holds_wgmma_tma_and_mbarriers_and_no_library():
    """The Hopper design is a kernel source built for sm_90a from the repo:
    its source and the csrc headers it includes hold the warpgroup
    products with A from registers at N = 128, the TMA tensor copies (3-d
    weights, 4-d halo and residual) on mbarriers, and no CUTLASS, cuDNN or
    cuBLAS call."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "fused_conv_sm90" in build.KERNEL_SOURCES
    sources = build._sources("fused_conv_sm90")
    assert {p.name for p in sources} == {"fused_conv_sm90.cu",
                                         "sm90_tiles.cuh", "mma_tiles.cuh"}
    text = "".join(p.read_text() for p in sources)
    for ptx in ("wgmma.mma_async", "wgmma.fence", "wgmma.commit_group",
                "cp.async.bulk.tensor.3d", "cp.async.bulk.tensor.4d",
                "mbarrier.try_wait", "mbarrier.arrive.expect_tx",
                "ldmatrix", "mul.rn.bf16x2", "ex2.approx", "rcp.approx"):
        assert ptx in text, ptx
    assert ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in
            text)
    cu = sources[0].read_text()
    assert "__grid_constant__ const CUtensorMap" in cu
    assert "wgmma_rs_mn<BN>" in cu and "constexpr int kThreads = 256;" in cu
    for lib in ("cutlass", "cudnn", "cublas", "cute::"):
        assert lib not in text.lower(), lib
    assert not re.search(r"#include\s*[<\"](cutlass|cute|cudnn|cublas)",
                         text)
    # both libraries report the chunk the wrapper and the control assume
    assert "int fused_conv_sm90_cin_chunk() { return kCH; }" in cu
    assert tfc.CONV_ENTRIES["sm90"] == (
        "fused_conv_sm90", "fused_affine_silu_conv3x3_sm90_bf16",
        "fused_conv_sm90_cin_chunk")


@pytest.mark.parametrize("name", list(conv_variants.VARIANTS))
def test_each_conv_variant_replaces_its_text_once(name):
    """tools/conv_variants.py rebuilds a library with one text replaced:
    the text must stand once in today's source, the Hopper design's
    launch-line variants name a launch_conv the source's templates take,
    and the kept launch line is the one the C entry runs."""
    lib, old, new = conv_variants.VARIANTS[name]
    src = (build.CSRC / f"{lib}.cu").read_text()
    assert src.count(old) == 1 and old != new
    assert conv_variants.library_of(name) == lib
    if old == conv_variants.SM90_LAUNCH:
        assert re.fullmatch(r"launch_conv<[48], (128|256), [2-5], "
                            r"(true|false), [12]>\(p, x, w, w_cols, B, "
                            r"s\)", new)
    assert ("return " + conv_variants.SM90_LAUNCH) in (
        build.CSRC / "fused_conv_sm90.cu").read_text()


def _row(design, shape, ms, per_run):
    row = dict(shape=shape, design=design, per_run=per_run,
               max_abs_err=1e-2, err_of_limit=0.3, control_of_limit=5.0,
               ms=ms, plain_ms=6 * ms, library_ms=1.5 * ms,
               bound_ms=0.4 * ms, bound_by="operations",
               share_of_bound=0.4, graph_ms=0.95 * ms, host_us=30.0)
    if design == "sm90":
        row.update(mma_sync_ms=2 * ms, mma_sync_max_abs_err=1e-2,
                   mma_sync_err_of_limit=0.28, mma_sync_graph_ms=1.9 * ms,
                   mma_sync_host_us=25.0)
    return row


def test_kernel_report_and_conv_paths_list_k4_by_design():
    """The kernels line holds K4's two designs, each with its launches
    from each path's counted run; the mma.sync entry carries its time
    beside the Hopper design's at the wide shapes. The conv paths line sums
    K4 over a path as run, eagerly and graphed, with the mma.sync design
    everywhere, the library and the bound."""
    attention = [_row("sm90", "B6 Lq6912", 1.3, {"serve": 150}),
                 _row("mma_sync", "B6 Lq6912 Lk77", 0.1, {"serve": 150})]
    for r in attention:
        r["lse_err"] = 1e-6
    attention[0]["mma_sync_lse_err"] = 1e-6
    k4_rows = [_row("sm90", "B3 288x384 512->256", 1.7, {"serve": 1}),
               _row("sm90", "B9 384x512 128->128", 1.3, {"train": 2}),
               _row("mma_sync", "B3 576x768 128->3", 0.8, {"serve": 1})]
    kernels = {"K1": attention, "K2": attention, "K3": attention,
               "K4": k4_rows}
    launches = {"serve": {**chip_smoke.unet_k1(60), **chip_smoke.unet_bwd(0),
                          **chip_smoke.k4(0, 2)},
                "train": dict(chip_smoke.SD15_STEP)}
    report = chip_smoke.kernel_report(kernels, launches, "H100, 700 W")
    by_name = {e["name"]: e for e in report}
    assert list(by_name)[-2:] == ["fused_affine_silu_conv3x3_sm90",
                                  "fused_affine_silu_conv3x3"]
    sm90, mma = (by_name["fused_affine_silu_conv3x3_sm90"],
                 by_name["fused_affine_silu_conv3x3"])
    assert sm90["source"] == "view_neti_tpu_torch/csrc/fused_conv_sm90.cu"
    assert mma["source"] == "view_neti_tpu_torch/csrc/fused_conv.cu"
    assert sm90["replaces"] == mma["replaces"] == (
        "view_neti_tpu/ops/fused_conv.py:176")
    assert sm90["launches_by_path"] == {"serve": 56, "train": 20}
    assert mma["launches_by_path"] == {"serve": 2, "train": 1}
    assert sm90["ms"] == 1.7 and sm90["mma_sync_ms"] == 3.4
    assert sm90["graph_ms"] == pytest.approx(0.95 * 1.7)
    # the mma.sync entry: its time beside the Hopper design at the heaviest
    # wide shape, its path sums over the narrow shape it runs
    assert mma["ms"] == 3.4 and mma["shape"] == "B3 288x384 512->256"
    assert mma["serve_path_ms"] == pytest.approx(0.8)
    for e in report:
        assert {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(e)
    paths = chip_smoke.conv_paths(k4_rows)
    assert paths["serve"]["k4_ms"] == pytest.approx(1.7 + 0.8)
    assert paths["serve"]["k4_mma_sync_ms"] == pytest.approx(3.4 + 0.8)
    assert paths["serve"]["k4_graph_ms"] == pytest.approx(0.95 * 2.5)
    assert paths["serve"]["k4_mma_sync_graph_ms"] == pytest.approx(
        1.9 * 1.7 + 0.95 * 0.8)
    assert paths["train"]["k4_ms"] == pytest.approx(2 * 1.3)
    assert paths["train"]["library_ms"] == pytest.approx(2 * 1.5 * 1.3)
    assert paths["train"]["bound_ms"] == pytest.approx(2 * 0.4 * 1.3)
    assert paths["validate"]["k4_ms"] == 0
    # a Hopper shape whose mma.sync time was not taken leaves its path's
    # all-mma.sync sums unknown, and no other path's
    untimed = {k: v for k, v in k4_rows[1].items()
               if k not in ("mma_sync_ms", "mma_sync_graph_ms",
                            "mma_sync_host_us")}
    paths = chip_smoke.conv_paths([k4_rows[0], untimed, k4_rows[2]])
    assert paths["train"]["k4_mma_sync_ms"] is None
    assert paths["train"]["k4_mma_sync_graph_ms"] is None
    assert paths["train"]["k4_ms"] == pytest.approx(2 * 1.3)
    assert paths["serve"]["k4_mma_sync_ms"] == pytest.approx(3.4 + 0.8)


def _conv_inputs(rng, B, H, W, Ci, Co):
    return dict(
        x=rng.randn(B, H, W, Ci).astype(np.float32),
        a=(1 + 0.5 * rng.randn(B, Ci)).astype(np.float32),
        b=(0.2 * rng.randn(B, Ci)).astype(np.float32),
        kernel=(rng.randn(3, 3, Ci, Co) * (9 * Ci) ** -0.5).astype(
            np.float32),
        bias=(0.1 * rng.randn(Co)).astype(np.float32),
        add_bc=rng.randn(B, Co).astype(np.float32),
        residual=rng.randn(B, H, W, Co).astype(np.float32))


# the Hopper design's tile edges: H and W across its 8 x 32 pixel tiles
# and neither a multiple of them, Cin 72 (a ragged 64-channel chunk), Cout
# 136 (a ragged 128-channel tile with a ragged second 64-channel box), with
# residual and add_bc; fp32 (the same arithmetic in another order, 1e-5)
# and bf16 (the kernel's rounding order; bf16 products summed in another
# order differ by a few bf16 ulps, 2e-2)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_plain_conv_matches_pallas_at_the_sm90_tile_edges(dtype, tol):
    inp = _conv_inputs(np.random.RandomState(20), 2, 9, 35, 72, 136)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    cast = ("x", "kernel", "bias", "residual")
    want = jfc.fused_affine_silu_conv3x3(
        **{k: jnp.asarray(v, jdt if k in cast else jnp.float32)
           for k, v in inp.items()}, interpret=True)
    got = tfc.fused_affine_silu_conv3x3_ref(
        **{k: torch.from_numpy(v).to(tdt if k in cast else torch.float32)
           for k, v in inp.items()})
    assert got.dtype == tdt and got.shape == (2, 9, 35, 136)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
