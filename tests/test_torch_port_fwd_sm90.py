"""K1's Hopper design (csrc/flash_attention_fwd_sm90.cu) on the CPU: which
shapes of the paths it takes (ops/flash_attention.py::fwd_design), the
bound chip_smoke.py holds every attention kernel to (the exponentials
counted), the report and launch checks that follow K1's two designs, and
what the source holds. The kernel itself runs only on the card
(tests/test_torch_port_kernels.py, chip_smoke.py); its plain version is
held against the Pallas kernel in interpret mode here and in
tests/test_torch_port_ops.py.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from view_neti_tpu.ops import flash_attention as jfa

from view_neti_tpu_torch.ops import build
from view_neti_tpu_torch.ops import flash_attention as tfa
from view_neti_tpu_torch.tools import fwd_short_variants
from view_neti_tpu_torch.utils import graphs

# the bound's exponential rate: an H100 SXM's 132 SMs at its 1980 MHz
# clocks.max.sm, chip_smoke.py's default until it reads the card
H100_EXP_RATE = 16 * 132 * 1980e6
# the names ptxas reports for each bucket's instantiation of the long-key
# and the short-key kernel
SM90_SYMBOL = ("_ZN60_GLOBAL__N__ffcd4624_27_flash_attention_fwd_sm90_cu_"
               "3b2fb43b21flash_fwd_kernel_sm90ILi{}EEEv14CUtensorMap_stS1_"
               "S1_S1_Pfiiif")
SM90_SHORT_SYMBOL = ("_ZN60_GLOBAL__N__ffcd4624_27_flash_attention_fwd_sm90_"
                     "cu_3b2fb43b27flash_fwd_kernel_sm90_shortILi{}EEEv14CUtens"
                     "orMap_stS1_S1_S1_Pfiiiiif")
SM90_BUCKETS = (48, 64, 80, 160)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's parallel regions spend most
    of their time waiting for cores; on one thread they do not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PATH_KINDS = ("serve", "train", "sweep", "m3 train", "m3 sweep", "m3 render",
              "folders train", "tp serve", "tp train")


def _kinds():
    """chip_smoke.attention_shapes in its order, each with its kind."""
    shapes = chip_smoke.attention_shapes(30)
    kinds = [k for k in ("serve", "sweep", "render", "train", "m3 train",
                         "m3 sweep", "m3 render", "folders train",
                         "tp serve", "tp train") for _ in range(8)]
    assert len(kinds) == len(shapes)
    return list(zip(kinds, shapes))


@pytest.mark.parametrize("kind", PATH_KINDS)
def test_fwd_design_on_every_path_shape(kind):
    """Every attention of the paths takes the Hopper design: the
    self-attentions at head dims 40, 64, 80 and 160 (its long-key kernel
    above 80 keys), the 77-key cross-attentions and SD-2.1's 48- and
    64-key mid-block attentions (its short-key kernel)."""
    rows = [s for k, s in _kinds() if k == kind]
    assert rows
    for s in rows:
        assert s["d"] in (40, 64, 80, 160), s
        assert tfa.fwd_design(s["d"], s["Lk"]) == "sm90", s


# each kind's UNet forward and the Hopper design's launches in it that
# chip_smoke.py's launch checks expect
FORWARD_SM90 = {"serve": chip_smoke.SD15_SM90,
                "sweep": chip_smoke.SD15_SM90,
                "render": chip_smoke.SD15_SM90,
                "train": chip_smoke.SD15_SM90,
                "m3 train": chip_smoke.M3_SM90["train"],
                "m3 sweep": chip_smoke.M3_SM90["sweep"],
                "m3 render": chip_smoke.M3_SM90["render"],
                "folders train": chip_smoke.SD15_SM90,
                "tp serve": chip_smoke.SD15_SM90,
                "tp train": chip_smoke.SD15_SM90}


@pytest.mark.parametrize("kind", list(FORWARD_SM90))
def test_forward_split_is_fwd_designs(kind):
    """A UNet forward's 32 K1 launches at a kind's shapes (each level's
    self-attention and 77-key cross-attention, 5 of each at the first
    three levels and 1 at the mid block), split by fwd_design: the split
    chip_smoke.py's launch checks hold every path's counted run to (all 32
    on the Hopper design, SD-1.5 and SD-2.1 alike)."""
    rows = [s for k, s in _kinds() if k == kind]
    per_design = {"sm90": 0, "mma_sync": 0}
    for i, s in enumerate(rows):
        per_design[tfa.fwd_design(s["d"], s["Lk"])] += (5, 5, 5, 1)[i // 2]
    sm90 = FORWARD_SM90[kind]
    assert sm90 == 32
    assert per_design == {"sm90": sm90, "mma_sync": 32 - sm90}
    assert chip_smoke.unet_k1(3, sm90) == {
        "K1": 96, "K1 sm90": 3 * sm90, "K1 mma_sync": 3 * (32 - sm90)}


def test_unet_k1_and_add_counts_build_the_launch_checks():
    """An SD-1.5 train step's expected launches, and a resumed mode-3
    run's: train steps, sweeps and renders at their own splits."""
    assert chip_smoke.SD15_STEP == {"K1": 32, "K1 sm90": 32,
                                    "K1 mma_sync": 0,
                                    **chip_smoke.unet_bwd(1), "K4": 21,
                                    "K4 sm90": 20, "K4 mma_sync": 1}
    got = chip_smoke.add_counts(
        {"K1": 32, "K1 sm90": 32, "K1 mma_sync": 0, "K4": 21},
        chip_smoke.unet_k1(2, chip_smoke.M3_SM90["sweep"]), {"K4": 29})
    assert got == {"K1": 96, "K1 sm90": 96, "K1 mma_sync": 0, "K4": 50}


# the Hopper design takes the buckets 48, 64, 80 and 160 (32 < d <= 80,
# 144 < d <= 160) at any key count; Lk picks its kernel, not the design
@pytest.mark.parametrize("d,Lk,want", [
    (40, 81, "sm90"), (40, 80, "sm90"), (33, 6912, "sm90"),
    (48, 129, "sm90"), (56, 108, "sm90"), (64, 6912, "sm90"),
    (32, 6912, "mma_sync"), (72, 6912, "sm90"), (8, 4096, "mma_sync"),
    (160, 432, "sm90"), (256, 300, "mma_sync"), (264, 300, "mma_sync"),
    (72, 80, "sm90"), (72, 81, "sm90"), (80, 80, "sm90"), (80, 81, "sm90"),
    (88, 80, "mma_sync"), (88, 81, "mma_sync"), (144, 80, "mma_sync"),
    (144, 81, "mma_sync"), (145, 80, "sm90"), (145, 81, "sm90"),
    (160, 80, "sm90"), (160, 81, "sm90"), (168, 80, "mma_sync"),
    (168, 81, "mma_sync")])
def test_fwd_design_at_the_bucket_and_key_edges(d, Lk, want):
    assert tfa.fwd_design(d, Lk) == want


def test_the_sm90_source_is_built_with_wgmma_and_tma_and_no_cutlass():
    """The library is one of the kernel sources; the source and the csrc
    headers it includes hold the warpgroup products (S over 64, 80 and 128
    keys from shared memory, P V at N = 48, 64, 80 and 160 from registers)
    and the TMA copies, and no CUTLASS or CuTe header."""
    assert "flash_attention_fwd_sm90" in build.KERNEL_SOURCES
    assert "-gencode" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    sources = build._sources("flash_attention_fwd_sm90")
    assert {p.name for p in sources} == {"flash_attention_fwd_sm90.cu",
                                          "sm90_tiles.cuh", "mma_tiles.cuh"}
    text = "".join(p.read_text() for p in sources)
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier",
                "setmaxnreg", "wgmma.fence", "bar.sync"):
        assert ptx in text, ptx
    for shape in ("m64n64k16", "m64n80k16", "m64n128k16", "m64n48k16",
                  "m64n160k16"):
        assert f"wgmma.mma_async.sync.aligned.{shape}.f32.bf16.bf16" in (
            text), shape
    assert not re.search(r"#include\s*[<\"](cutlass|cute)", text)
    cu = sources[0].read_text()
    for kernel in ("flash_fwd_kernel_sm90(", "flash_fwd_kernel_sm90_short("):
        assert kernel in cu, kernel
    assert "__grid_constant__ const CUtensorMap" in cu
    assert "cudaGetDriverEntryPoint" in cu
    assert "-lcuda" not in build.NVCC_FLAGS


@pytest.mark.parametrize("B,H,d,L,ms,by", [
    # SD-1.5 serving's heaviest K1: the exponentials bind
    (6, 8, 40, 6912, 0.548, "exponentials"),
    # SD-2.1 at mode 3: the tensor cores bind
    (4, 5, 64, 6912, 0.2473, "operations")])
def test_bound_counts_the_exponentials(B, H, d, L, ms, by):
    """K1's bound: max(4 B H L^2 d / 989 TFLOP/s, its bytes / 3.35 TB/s,
    B H L^2 exponentials / (16 x 132 SMs x 1980 MHz))."""
    nbytes = 2.0 * 4 * B * L * H * d + 4.0 * B * H * L
    assert chip_smoke.EXP_RATE == H100_EXP_RATE
    got, got_by = chip_smoke.bound(4.0 * B * H * L * L * d, nbytes,
                                   float(B * H * L * L))
    assert got_by == by
    assert got == pytest.approx(ms, rel=2e-3)
    # without the exponentials, d = 40 falls back to its operations
    assert chip_smoke.bound(4.0 * B * H * L * L * d, nbytes)[1] == (
        "operations")
    assert chip_smoke.exp_rate(132, 1980) == H100_EXP_RATE


def test_bound_reads_bytes_when_they_bind():
    """The 77-key cross-attention: q and o dominate."""
    B, H, d, Lq, Lk = 6, 8, 40, 6912, 77
    nbytes = 2.0 * (2 * B * Lq * H * d + 2 * B * Lk * H * d)
    ms, by = chip_smoke.bound(4.0 * B * H * Lq * Lk * d, nbytes,
                              float(B * H * Lq * Lk))
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def _log(buckets, symbols=(SM90_SYMBOL,)):
    """A ptxas -v log of the Hopper library: one entry per bucket and
    kernel."""
    lines = []
    for dp, symbol in ((dp, sy) for sy in symbols for dp in buckets):
        name = symbol.format(dp)
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                  "spill loads",
                  "ptxas info    : Used 168 registers, used 16 barriers"]
    return "\n".join(lines)


def test_spill_check_reads_the_sm90_instantiations(capsys):
    """check_path_spills counts and prints the four buckets of both
    kernels of the Hopper design (their first template argument), and
    fails on a spill in either."""
    usage = chip_smoke.ptxas_usage({"flash_attention_fwd_sm90": _log(
        SM90_BUCKETS, (SM90_SYMBOL, SM90_SHORT_SYMBOL))})
    assert chip_smoke.check_path_spills(usage) == 8
    out = capsys.readouterr().out
    for dp in SM90_BUCKETS:
        for kernel in ("flash_fwd_kernel_sm90", "flash_fwd_kernel_sm90_short"):
            assert f"{kernel}<{dp}>: 168 registers, 0 bytes spill" in out
    for symbol in (SM90_SYMBOL, SM90_SHORT_SYMBOL):
        spilled = _log((160,), (symbol,)).replace(
            "0 bytes spill stores", "8 bytes spill stores")
        with pytest.raises(RuntimeError, match="spills 8 bytes"):
            chip_smoke.check_path_spills(chip_smoke.ptxas_usage(
                {"flash_attention_fwd_sm90": spilled}))


def test_profiles_group_the_sm90_kernel_as_k1():
    demangled = ("void (anonymous namespace)::flash_fwd_kernel_sm90<48>("
                 "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                 "CUtensorMap_st, float*, int, int, int, float)")
    assert chip_smoke.kernel_group(demangled) == "K1 flash_attention_fwd"


def test_profiles_group_the_short_key_kernel_as_k1():
    demangled = ("void (anonymous namespace)::flash_fwd_kernel_sm90_short"
                 "<160>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                 "CUtensorMap_st, float*, int, int, int, int, int, float)")
    assert chip_smoke.kernel_group(demangled) == "K1 flash_attention_fwd"


def _row(design, shape, ms, per_run):
    row = dict(shape=shape, design=design, per_run=per_run,
               max_abs_err=1e-3, err_of_limit=0.2, control_of_limit=3.0,
               ms=ms, plain_ms=10 * ms, library_ms=0.9 * ms,
               bound_ms=0.4 * ms, bound_by="exponentials",
               share_of_bound=0.4)
    if design == "sm90":
        row.update(mma_sync_ms=1.4 * ms, mma_sync_max_abs_err=2e-3,
                   mma_sync_err_of_limit=0.3, mma_sync_lse_err=1e-6,
                   graph_ms=0.9 * ms, mma_sync_graph_ms=1.3 * ms,
                   host_us=50.0, mma_sync_host_us=45.0)
    return row


_REPORT_KEYS = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}


def test_kernel_report_lists_each_k1_design():
    """The kernels line holds K1's two designs apart, each with the keys
    the contract asks for and its launches from each path's counted run
    (launch_counts' "K1 sm90" and "K1 mma_sync"), the bench's and the
    coach trace's included. Every path shape on the Hopper design: its
    entry carries the mma.sync design's ms at its heaviest shape, and the
    mma.sync entry, at 0 launches, its check and times beside it at the
    same inputs."""
    other = [dict(_row(design, "s", 1.0, {"train": 30}),
                  bound_by="operations") for design in ("sm90", "mma_sync")]
    kernels = {"K1": [_row("sm90", "B6 Lq6912", 1.3, {"serve": 150}),
                      _row("sm90", "B6 Lq6912 Lk77", 0.1, {"serve": 150})],
               "K2": other, "K3": other, "K4": other}
    launches = {
        "serve": {**chip_smoke.unet_k1(60), **chip_smoke.unet_bwd(0),
                  "K4": 58},
        "train": {k: 7 * v for k, v in chip_smoke.SD15_STEP.items()},
        "coach_trace": {k: 14 * v for k, v in chip_smoke.SD15_STEP.items()},
        "bench": {**chip_smoke.unet_k1(10, chip_smoke.M3_SM90["train"]),
                  "K2": 1, "K2 sm90": 1, "K3": 1, "K3 mma_sync": 1,
                  "K4": 1}}
    report = chip_smoke.kernel_report(kernels, launches, "H100, 700 W")
    names = [e["name"] for e in report]
    assert names == ["flash_attention_fwd_sm90", "flash_attention_fwd",
                     "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv_sm90",
                     "flash_attention_bwd_dkv", "fused_affine_silu_conv3x3_sm90",
                     "fused_affine_silu_conv3x3"]
    for e in report:
        assert _REPORT_KEYS <= set(e)
    sm90, mma = report[0], report[1]
    assert sm90["source"].endswith("csrc/flash_attention_fwd_sm90.cu")
    assert sm90["launches_by_path"] == {"serve": 1920, "train": 224,
                                        "coach_trace": 448, "bench": 320}
    assert mma["launches_by_path"] == {"serve": 0, "train": 0,
                                       "coach_trace": 0, "bench": 0}
    assert sm90["launches"] == 2912 and mma["launches"] == 0
    assert sm90["ms"] == 1.3 and sm90["mma_sync_ms"] == pytest.approx(1.82)
    assert sm90["serve_path_ms"] == pytest.approx(150 * 1.4)
    # the mma.sync design's own numbers at the same inputs
    assert mma["ms"] == pytest.approx(1.82) and "mma_sync_ms" not in mma
    assert mma["max_abs_err"] == 2e-3 and mma["err_of_limit"] == 0.3
    assert mma["plain_ms"] == sm90["plain_ms"]
    assert mma["library_ms"] == sm90["library_ms"]
    assert mma["bound_ms"] == sm90["bound_ms"]
    assert mma["share_of_bound"] == pytest.approx(0.52 / 1.82)
    # its path sums cover the shapes it runs: none on the serving path
    assert "serve_path_ms" not in mma
    # every train step's K2 launch on the Hopper design, and K3's but its
    # 48 x 77 mid-block cross-attention
    assert report[2]["launches_by_path"] == {"serve": 0, "train": 210,
                                            "coach_trace": 420, "bench": 1}
    assert report[2]["launches"] == 631
    assert report[5]["launches_by_path"] == {"serve": 0, "train": 7,
                                            "coach_trace": 14, "bench": 1}


def test_kernel_report_keeps_a_shape_left_on_mma_sync():
    """A shape fwd_design left on the mma.sync design (its own rows) and
    the mma.sync design measured beside the Hopper one both count in the
    mma.sync entry; its heaviest shape is the heaviest of either."""
    kernels = {"K1": [_row("sm90", "B6 Lq6912", 1.3, {"serve": 150}),
                      _row("mma_sync", "B9 Lq48", 0.05, {"mode3": 6})]}
    for key in ("K2", "K3", "K4"):
        kernels[key] = [_row(design, "s", 1.0, {"train": 30})
                        for design in ("sm90", "mma_sync")]
    launches = {"serve": {**chip_smoke.unet_k1(60), **chip_smoke.unet_bwd(0),
                          "K4": 58},
                "mode3": {"K1": 96, "K1 sm90": 90, "K1 mma_sync": 6,
                          **chip_smoke.unet_bwd(0), "K4": 0}}
    report = chip_smoke.kernel_report(kernels, launches, "H100, 700 W")
    sm90, mma = report[0], report[1]
    assert mma["launches_by_path"] == {"serve": 0, "mode3": 6}
    assert sm90["launches_by_path"] == {"serve": 1920, "mode3": 90}
    assert mma["ms"] == pytest.approx(1.82) and mma["shape"] == "B6 Lq6912"
    assert mma["mode3_path_ms"] == pytest.approx(6 * 0.05)
    assert "mode3_path_ms" not in sm90
    for e in report:
        assert _REPORT_KEYS <= set(e)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """On the CPU flash_attention is the plain version: no launch, no
    design counted; the mma.sync entry for the card refuses CPU tensors."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 130, 2, 40).astype(np.float32))
               for _ in range(3))
    before = graphs.launch_counts()
    o, lse = tfa.flash_attention(q, k, v)
    ro, rlse = tfa.flash_attention_ref(q, k, v)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert graphs.launch_counts() == before
    with pytest.raises(ValueError, match="cpu"):
        tfa._flash_attention_mma_sync(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16())


@pytest.fixture
def saved_counts():
    """The launch counters as they were, restored after the test."""
    saved = graphs.launch_counts()
    yield
    graphs.set_launch_counts(saved)


def test_launch_counts_split_k1_by_design_and_reset_together(saved_counts):
    """K1's launches by design are keys of launch_counts beside K1-K4,
    and its reset clears them with the rest."""
    graphs.set_launch_counts({"K1": 7, "K1 sm90": 3, "K1 mma_sync": 4,
                              "K4": 2})
    assert tfa.flash_attention.launches == 7
    assert tfa.flash_attention.designs == {"sm90": 3, "mma_sync": 4}
    got = graphs.launch_counts()
    assert list(got) == ["K1", "K2", "K3", "K4", "K1 sm90", "K1 mma_sync",
                         "K2 sm90", "K2 mma_sync", "K3 sm90", "K3 mma_sync",
                         "K4 sm90", "K4 mma_sync"]
    assert {k: got[k] for k in ("K1", "K1 sm90", "K1 mma_sync", "K4")} == {
        "K1": 7, "K1 sm90": 3, "K1 mma_sync": 4, "K4": 2}
    assert graphs.launch_counts(reset=True) == dict.fromkeys(got, 0)
    assert tfa.flash_attention.designs == {"sm90": 0, "mma_sync": 0}


def test_capture_record_keeps_only_the_counts_a_capture_moved():
    """A capture keeps the counts it moved (utils/graphs.py: after - before,
    zeros left out), so a forward whose 32 K1 launches all take the Hopper
    design records no "K1 mma_sync": the launch checks of the denoise and
    train-step graphs compare against capture_record of the counts."""
    before = {k: 0 for k in graphs.launch_counts()}
    after = dict(before, **chip_smoke.unet_k1(30))
    kept = {k: after[k] - before[k] for k in before if after[k] != before[k]}
    assert kept == chip_smoke.capture_record(chip_smoke.unet_k1(30)) == {
        "K1": 960, "K1 sm90": 960}
    assert chip_smoke.capture_record(chip_smoke.SD15_STEP) == {
        "K1": 32, "K1 sm90": 32, "K2": 30, "K2 sm90": 30, "K3": 31,
        "K3 sm90": 30, "K3 mma_sync": 1, "K4": 21, "K4 sm90": 20,
        "K4 mma_sync": 1}


class _Graph:
    """A CUDA graph's stand-in: replay launches nothing."""
    def replay(self):
        pass


def test_a_replay_adds_its_capture_record_by_design(saved_counts):
    """Every replay adds the capture's record, K1's designs included, and
    leaves the counters the record does not name."""
    graphs.launch_counts(reset=True)
    graphs.set_launch_counts({"K2": 1})
    cap = graphs.Capture(_Graph(), [], [], None,
                         {"K1": 32, "K1 sm90": 5, "K1 mma_sync": 27}, 0.0,
                         0)
    g = graphs.Graphed(lambda x: x, "loop")
    g.replay(cap)
    g.replay(cap)
    assert cap.replays == 2
    assert graphs.launch_counts() == {"K1": 64, "K2": 1, "K3": 0, "K4": 0,
                                      "K1 sm90": 10, "K1 mma_sync": 54,
                                      "K2 sm90": 0, "K2 mma_sync": 0,
                                      "K3 sm90": 0, "K3 mma_sync": 0,
                                      "K4 sm90": 0, "K4 mma_sync": 0}


# the Hopper design's tile edges: queries past one 128-row block, keys
# across one and two 128-key tiles (the last one ragged), and its new
# kernels' edges: the short-key kernel's one 80-key tile (77, 48 and a
# single key), the long-key kernel's first key past it, the 64-key tiles
# of bucket 160, and the 64-column chunks of buckets 80 and 160
@pytest.mark.parametrize("Lq,Lk,d", [
    (129, 81, 40), (130, 257, 64), (129, 77, 80), (63, 81, 80),
    (130, 48, 160), (65, 1, 40), (200, 129, 160)])
def test_k1_plain_matches_pallas_at_the_sm90_tile_edges(Lq, Lk, d):
    """The plain version the card's kernels are held to, against the
    Pallas kernel in interpret mode on the same numpy inputs, to 1e-5
    absolute and relative: both compute in fp32, in other orders."""
    rng = np.random.RandomState(Lq + Lk)
    q = rng.randn(1, Lq, 2, d).astype(np.float32)
    k = rng.randn(1, Lk, 2, d).astype(np.float32)
    v = rng.randn(1, Lk, 2, d).astype(np.float32)
    o, _ = tfa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", [*fwd_short_variants.VARIANTS, "split"])
def test_short_variants_patch_the_kernel_source(name):
    """tools/fwd_short_variants.py rebuilds the short-key kernel with text
    replaced: every replacement finds its text in the source exactly once
    and changes it, and the split build adds its clock64 marks and the
    entry that reads them."""
    src = (build.CSRC / "flash_attention_fwd_sm90.cu").read_text()
    subs = (fwd_short_variants._split_variant() if name == "split"
            else fwd_short_variants.VARIANTS[name])
    out = fwd_short_variants.patched(src, subs, name)
    assert out != src
    if name == "split":
        assert out.count("clock64()") == 7
        assert "int short_split_read(void* dst)" in out
    # a text found twice (or not at all) is refused
    with pytest.raises(RuntimeError, match="not in the source once"):
        fwd_short_variants.patched(src + subs[0][0], subs[:1], name)
