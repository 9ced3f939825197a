"""K2's and K3's Hopper design (csrc/flash_attention_bwd_dq_sm90.cu,
csrc/flash_attention_bwd_dkv_sm90.cu) on the CPU: which shapes of the paths
it takes (ops/flash_attention.py::bwd_design), the launch checks, spill
check, profile groups and kernels line that follow K2's and K3's two
designs, and what the sources hold. The kernels themselves run only on the
card (tests/test_torch_port_kernels.py -k bwd_sm90, chip_smoke.py); their
plain version is held here against the Pallas backward in interpret mode
at the new design's tile edges.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from view_neti_tpu.ops import flash_attention as jfa

from view_neti_tpu_torch.ops import build
from view_neti_tpu_torch.ops import flash_attention as tfa
from view_neti_tpu_torch.utils import graphs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the other test workers, torch's parallel regions spend most
    of their time waiting for cores; on one thread they do not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KINDS = ("serve", "sweep", "render", "train", "m3 train", "m3 sweep",
         "m3 render", "folders train", "tp serve", "tp train")


def _kinds():
    """chip_smoke.attention_shapes in its order, each with its kind."""
    shapes = chip_smoke.attention_shapes(30)
    kinds = [k for k in KINDS for _ in range(8)]
    assert len(kinds) == len(shapes)
    return list(zip(kinds, shapes))


# the path shapes bwd_design keeps on the mma.sync design, by kind: K2 at
# SD-2.1's 48 x 48 mid block, K3 at SD-1.5's 48 x 77 mid-block
# cross-attention (384x512 training: the train step and the tp ranks')
KEPT = {"m3 train": {("K2", 48, 48, 64)}, "train": {("K3", 48, 77, 160)},
        "tp train": {("K3", 48, 77, 160)}}


@pytest.mark.parametrize("kind", KINDS)
def test_bwd_design_on_every_path_shape(kind):
    """The Hopper design takes every attention shape of the paths (the
    self-attentions at head dims 40, 64, 80 and 160, the 77-key
    cross-attentions and the 48- and 64-key mid blocks) but the two shapes
    where the card measured a kernel's Hopper design slower, which stay on
    the mma.sync design for that kernel."""
    rows = [s for k, s in _kinds() if k == kind]
    assert rows
    kept = set()
    for s in rows:
        assert s["d"] in (40, 64, 80, 160), s
        assert tfa.bwd_design(s["d"], s["Lk"]) == "sm90", s
        for key, kernel in chip_smoke.BWD_KERNELS.items():
            if tfa.bwd_design(s["d"], s["Lk"], s["Lq"], kernel) != "sm90":
                kept.add((key, s["Lq"], s["Lk"], s["d"]))
    assert kept == KEPT.get(kind, set())


def test_bwd_design_keeps_the_measured_slower_shapes_on_mma_sync():
    """The static rule: a (kernel, head-dim bucket, Lq, Lk) of
    BWD_MMA_SYNC_SHAPES takes the mma.sync design for that kernel only,
    at any head dim of the bucket; the neighbouring shapes, the other
    kernel and a call that names no kernel take the Hopper design."""
    assert tfa.BWD_MMA_SYNC_SHAPES == {("dq", 64, 48, 48),
                                       ("dkv", 160, 48, 77)}
    for d, Lk, Lq, kernel, want in (
            (64, 48, 48, "dq", "mma_sync"), (56, 48, 48, "dq", "mma_sync"),
            (64, 48, 48, "dkv", "sm90"), (64, 48, 64, "dq", "sm90"),
            (64, 77, 48, "dq", "sm90"), (40, 48, 48, "dq", "sm90"),
            (160, 77, 48, "dkv", "mma_sync"), (152, 77, 48, "dkv",
                                               "mma_sync"),
            (160, 77, 48, "dq", "sm90"), (160, 77, 64, "dkv", "sm90"),
            (160, 48, 48, "dkv", "sm90"), (128, 77, 48, "dkv", "mma_sync"),
            (64, 48, None, None, "sm90"), (160, 77, None, None, "sm90")):
        assert tfa.bwd_design(d, Lk, Lq, kernel) == want, (d, Lk, Lq,
                                                            kernel)
    assert [tfa.head_dim_bucket(d) for d in (8, 33, 48, 49, 64, 65, 80, 81,
                                             145, 160, 161)] == [
        8, 48, 48, 64, 64, 80, 80, 81, 160, 160, 161]


# the edges of the Hopper design's buckets (48 and 64: 33..64; 80: 65..80;
# 160: 145..160) at the key counts of the short-key shapes and past them
@pytest.mark.parametrize("d", [32, 33, 40, 48, 49, 64, 65, 80, 81, 144, 145,
                               160, 161])
@pytest.mark.parametrize("Lk", [48, 77, 80, 81])
def test_bwd_design_at_the_bucket_and_key_edges(d, Lk):
    want = "sm90" if 32 < d <= 80 or 144 < d <= 160 else "mma_sync"
    assert tfa.bwd_design(d, Lk) == want
    # the same rule as K1's, whatever the key count, and for each kernel
    # at 200 queries
    assert tfa.bwd_design(d, Lk) == tfa.fwd_design(d, Lk)
    assert tfa.bwd_design(d, Lk, 200, "dq") == want
    assert tfa.bwd_design(d, Lk, 200, "dkv") == want


# K3's key rows a block, by design and head dim: 64 in the Hopper design at
# bucket 160 (a dV and a dK warpgroup share a block's keys), else 128; the
# split policy counts its blocks with it
@pytest.mark.parametrize("design,d,tile", [
    ("sm90", 40, 128), ("sm90", 64, 128), ("sm90", 80, 128),
    ("sm90", 160, 64), ("mma_sync", 160, 128), ("mma_sync", 40, 128)])
def test_dkv_key_tile_by_design_and_head_dim(design, d, tile):
    assert tfa.dkv_key_tile(design, d) == tile
    # at B9 H8 on 132 SMs: 256 keys are 4 x 72 = 288 blocks of 64 (two
    # waves: no split) or 144 of 128 (two splits); 77 keys 144 blocks of 64
    # (two splits) or 72 of 128 (four)
    assert tfa.dkv_splits(9, 8, 256, 256, 132, tile) == (
        1 if tile == 64 else 2)
    assert tfa.dkv_splits(9, 8, 3072, 77, 132, tile) == (
        2 if tile == 64 else 4)


# each train kind's steps a run in attention_shapes, and its split: every
# launch on the Hopper design but the kept shapes'
TRAIN_KINDS = {"train": (1, chip_smoke.SD15_BWD_SM90),
               "m3 train": (2 * (chip_smoke.M3_WARM + chip_smoke.M3_STEPS),
                            chip_smoke.M3_BWD_SM90),
               "folders train": (2 * (chip_smoke.FOLDERS_WARM
                                      + chip_smoke.FOLDERS_STEPS),
                                 chip_smoke.FOLDERS_BWD_SM90),
               "tp train": (chip_smoke.TP_WARM + chip_smoke.TP_STEPS,
                            chip_smoke.SD15_BWD_SM90)}


@pytest.mark.parametrize("kind", list(TRAIN_KINDS))
def test_a_train_steps_split_is_bwd_designs(kind):
    """A train step's 30 K2 and 31 K3 launches at a kind's shapes, split
    by bwd_design: all on the Hopper design but one on SD-1.5 at 384x512
    (K3's 48 x 77 mid-block cross-attention) and one on SD-2.1 (K2's 48 x
    48 mid block): the split the launch checks hold every path to."""
    rows = [s for k, s in _kinds() if k == kind]
    path = next(iter(rows[0]["per_run"]["K2"]))
    steps, sm90 = TRAIN_KINDS[kind]
    got = {key: {"sm90": 0, "mma_sync": 0} for key in ("K2", "K3")}
    for s in rows:
        for key, kernel in chip_smoke.BWD_KERNELS.items():
            got[key][tfa.bwd_design(s["d"], s["Lk"], s["Lq"], kernel)] += (
                s["per_run"][key][path] // steps)
    assert got == {"K2": {"sm90": sm90["K2"], "mma_sync": 30 - sm90["K2"]},
                   "K3": {"sm90": sm90["K3"], "mma_sync": 31 - sm90["K3"]}}
    assert sm90 == {"train": {"K2": 30, "K3": 30},
                    "m3 train": {"K2": 29, "K3": 31},
                    "folders train": {"K2": 30, "K3": 31},
                    "tp train": {"K2": 30, "K3": 30}}[kind]


def test_launch_checks_agree_with_bwd_design_on_every_path():
    """What phase_kernels checks before it runs a kernel: bwd_design over
    attention_shapes gives every training path's counts of the launch
    checks (unet_bwd), and the paths that do not train run no backward."""
    split = chip_smoke.bwd_split_by_path(chip_smoke.attention_shapes(30),
                                         tfa.bwd_design)
    want = chip_smoke.train_paths_bwd()
    assert sorted(split) == sorted(want)
    for path, counts in want.items():
        assert split[path] == chip_smoke.capture_record(counts), path
    assert chip_smoke.unet_bwd(2, chip_smoke.M3_BWD_SM90) == {
        "K2": 60, "K2 sm90": 58, "K2 mma_sync": 2, "K3": 62, "K3 sm90": 62,
        "K3 mma_sync": 0}
    # a split that kept some shapes on the mma.sync design counts them
    assert chip_smoke.unet_bwd(3, {"K2": 26, "K3": 27}) == {
        "K2": 90, "K2 sm90": 78, "K2 mma_sync": 12, "K3": 93, "K3 sm90": 81,
        "K3 mma_sync": 12}
    assert set(chip_smoke.unet_bwd(0).values()) == {0}
    assert chip_smoke.SD15_STEP == {
        "K1": 32, "K1 sm90": 32, "K1 mma_sync": 0, "K2": 30, "K2 sm90": 30,
        "K2 mma_sync": 0, "K3": 31, "K3 sm90": 30, "K3 mma_sync": 1,
        "K4": 21, "K4 sm90": 20, "K4 mma_sync": 1}


# the names ptxas reports for each bucket's instantiation of the two
# kernels
DQ_SYMBOL = ("_ZN63_GLOBAL__N__7d77d2f2_30_flash_attention_bwd_dq_sm90_cu_"
             "3b2fb43b24flash_bwd_dq_kernel_sm90ILi{}EEEv14CUtensorMap_stS1_"
             "S1_S1_S1_PKfS3_iiiff")
DQ_SHORT_SYMBOL = DQ_SYMBOL.replace(
    "24flash_bwd_dq_kernel_sm90I", "30flash_bwd_dq_kernel_sm90_shortI"
).replace("S3_iiiff", "S3_iiiiiff")
DKV_SYMBOL = ("_ZN64_GLOBAL__N__685698f7_31_flash_attention_bwd_dkv_sm90_cu_"
              "6bf9000c25flash_bwd_dkv_kernel_sm90ILi{}EEEv14CUtensorMap_st"
              "S1_S1_S1_S1_S1_PKfS3_Pfiiiiiff")


def _log(symbol, buckets=(48, 64), regs=168, spill=0):
    lines = []
    for dp in buckets:
        name = symbol.format(dp)
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {spill} bytes spill stores, 0 "
                  f"bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    return "\n".join(lines)


def test_spill_check_reads_the_bwd_sm90_instantiations(capsys):
    """check_path_spills counts and prints the four buckets of both Hopper
    kernels and the two of K2's short-key kernel (their first template
    argument), and fails on a spill in any; the build holds 2 x 4 + 2 path
    instantiations of them."""
    usage = chip_smoke.ptxas_usage({
        "flash_attention_bwd_dq_sm90": "\n".join((
            _log(DQ_SYMBOL, (48, 64, 80, 160)),
            _log(DQ_SHORT_SYMBOL, (48, 64)))),
        "flash_attention_bwd_dkv_sm90": _log(DKV_SYMBOL, (48, 64, 80, 160))})
    assert chip_smoke.check_path_spills(usage) == 10
    out = capsys.readouterr().out
    for dp in (48, 64):
        assert (f"build flash_attention_bwd_dq_sm90: "
                f"flash_bwd_dq_kernel_sm90_short<{dp}>: 168 registers, 0 "
                f"bytes spill") in out
    for dp in (48, 64, 80, 160):
        for lib, kernel in (("flash_attention_bwd_dq_sm90",
                             "flash_bwd_dq_kernel_sm90"),
                            ("flash_attention_bwd_dkv_sm90",
                             "flash_bwd_dkv_kernel_sm90")):
            assert (f"build {lib}: {kernel}<{dp}>: 168 registers, 0 bytes "
                    f"spill") in out
    for lib, symbol in (("flash_attention_bwd_dq_sm90", DQ_SYMBOL),
                        ("flash_attention_bwd_dkv_sm90", DKV_SYMBOL)):
        for dp in (64, 80, 160):
            with pytest.raises(RuntimeError, match="spills 8 bytes"):
                chip_smoke.check_path_spills(chip_smoke.ptxas_usage(
                    {lib: _log(symbol, (dp,), spill=8)}))
    with pytest.raises(RuntimeError, match="spills 8 bytes"):
        chip_smoke.check_path_spills(chip_smoke.ptxas_usage(
            {"flash_attention_bwd_dq_sm90": _log(DQ_SHORT_SYMBOL, (48,),
                                                 spill=8)}))
    assert chip_smoke.BWD_SM90_BUCKETS == (48, 64, 80, 160)
    assert chip_smoke.BWD_SM90_SHORT_BUCKETS == (48, 64)


def test_a_serialised_wgmma_fails_the_build_check():
    """ptxas's notes that it serialised warpgroup products (C7512: too few
    registers; C7520: a divergent path) fail chip_smoke's build check; its
    other notes (C7519, an injected warpgroup.arrive) do not."""
    ok = ("ptxas info    : (C7519) warpgroup.arrive is injected in around "
          "line 453 by compiler to allow use of registers in GMMA in "
          "function 'f'")
    chip_smoke.check_wgmma_pipelined({"flash_attention_bwd_dkv_sm90": ok})
    bad = ("ptxas info    : (C7512) Potential Performance Loss: "
           "wgmma.mma_async instructions are serialized due to insufficient "
           "register resources for the function 'f'")
    with pytest.raises(RuntimeError, match="serialised wgmma"):
        chip_smoke.check_wgmma_pipelined(
            {"flash_attention_bwd_dkv_sm90": ok + "\n" + bad})


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_bwd_dq_kernel_sm90<48>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, int, int, int, float, "
     "float)", "K2 flash_attention_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel_sm90<64>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float*, "
     "int, int, int, int, int, float, float)", "K3 flash_attention_bwd_dkv"),
    ("dkv_reduce::flash_bwd_dkv_reduce_kernel(float const*, "
     "__nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int, "
     "mma_tiles::Strides, mma_tiles::Strides, float)",
     "K3 flash_attention_bwd_dkv")])
def test_profiles_group_the_bwd_sm90_kernels(name, group):
    assert chip_smoke.kernel_group(name) == group


def test_the_sources_hold_wgmma_tma_and_setmaxnreg_and_no_atomics():
    """Each Hopper library is a kernel source built for sm_90a from the
    repo; its source and the csrc headers it includes hold the warpgroup
    products, the TMA copies and setmaxnreg, and no CUTLASS, no atomics and
    no global reductions. K2 hands its producer warpgroup's registers to
    its consumers with setmaxnreg; K3 has no producer (two warpgroups of
    up to 255 registers a thread, one warp of them loading the stages; at
    bucket 160 one accumulates dV and the other dK). Both carry head dims
    above 64 as 64-column chunks, loaded and stored a box a chunk."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for lib, kernel in (("flash_attention_bwd_dq_sm90",
                         "flash_bwd_dq_kernel_sm90("),
                        ("flash_attention_bwd_dkv_sm90",
                         "flash_bwd_dkv_kernel_sm90(")):
        assert lib in build.KERNEL_SOURCES
        sources = build._sources(lib)
        names = {p.name for p in sources}
        assert {f"{lib}.cu", "sm90_tiles.cuh", "mma_tiles.cuh"} <= names
        text = "".join(p.read_text() for p in sources)
        for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "setmaxnreg",
                    "mbarrier", "wgmma.fence", "bar.sync"):
            assert ptx in text, (lib, ptx)
        for shape in ("m64n64k16", "m64n48k16", "m64n80k16", "m64n160k16"):
            assert (f"wgmma.mma_async.sync.aligned.{shape}.f32.bf16.bf16"
                    in text), (lib, shape)
        assert "cutlass" not in text.lower() and "atomicAdd" not in text
        # PTX reductions and atomics: red.global, atom.global, atom.shared
        assert not re.search(r"\b(red|atom)\.(global|shared)", text), lib
        cu = sources[0].read_text()
        assert kernel in cu
        assert "__grid_constant__ const CUtensorMap" in cu
        assert ("setmaxnreg_inc<" in cu) == (lib == "flash_attention_bwd_dq_sm90")
        assert ("constexpr int kThreads = 256;" in cu) == (
            lib == "flash_attention_bwd_dkv_sm90")
        assert "tma_load_chunks<T::kChunks>" in cu
        assert "tma_store_chunks<T::kChunks>" in cu
        assert "static_assert(DP == 48 || DP == 64 || DP == 80 || DP == 160" \
            in cu
        for dp in (48, 64, 80, 160):
            assert re.search(rf"launch(_bucket)?<{dp}>\(a, s\)", cu), (lib,
                                                                      dp)
        assert not re.search(r"#include\s*[<\"](cutlass|cute)", cu)
    # K3 at bucket 160: a dV and a dK warpgroup over one 64-key tile, the
    # same code in both; K2 there: 32-key stages (wgmma.m64n32k16)
    dkv = (build.CSRC / "flash_attention_bwd_dkv_sm90.cu").read_text()
    for piece in ("consume<DP, T::kRole>(x, wg)",
                  "kRole = DP > 128 ? kOne : kBoth",
                  "kBK = kRole == kOne ? kWgRows : 2 * kWgRows"):
        assert piece in dkv, piece
    dq = (build.CSRC / "flash_attention_bwd_dq_sm90.cu").read_text()
    assert "kBK = DP > 128 ? 32 : 64" in dq
    # K2 up to 80 keys at buckets 48 and 64: the persistent short-key
    # kernel, its dq tiles stored in turns
    for piece in ("flash_bwd_dq_kernel_sm90_short(",
                  "if (a.Lk <= ShortTiles<DP>::kKeys) return launch_short",
                  "tma_store_wait_read<T::kOBufs - 1>()"):
        assert piece in dq, piece
    assert ("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16"
            in (build.CSRC / "sm90_tiles.cuh").read_text())
    # K3's lse and delta rows reach the stage by cp.async on its barrier
    assert "cp.async.mbarrier.arrive" in (
        build.CSRC / "sm90_tiles.cuh").read_text()
    assert "dkv_reduce.cuh" in {
        p.name for p in build._sources("flash_attention_bwd_dkv_sm90")}


def test_cpu_tensors_take_the_plain_version_and_count_no_design():
    """On the CPU K2's and K3's wrappers are the plain backward: no launch,
    no design counted; the mma.sync entries for the card refuse CPU
    tensors."""
    rng = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(rng.randn(1, L, 2, 40).astype(np.float32))
                   for L in (130, 200, 200, 130))
    o, lse = tfa.flash_attention_ref(q, k, v)
    delta = tfa.attention_delta(o, do)
    assert tfa.bwd_design(40, 200) == "sm90"
    before = graphs.launch_counts()
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    want = tfa._bwd_plain(q, k, v, do, lse, delta)
    for got, w in zip((dq, dk, dv), want):
        assert torch.equal(got, w)
    assert graphs.launch_counts() == before
    for fn in (tfa._flash_attention_bwd_dq_mma_sync,
               tfa._flash_attention_bwd_dkv_mma_sync):
        with pytest.raises(ValueError, match="cpu"):
            fn(*(t.bfloat16() for t in (q, k, v, do)), lse, delta)


@pytest.fixture
def saved_counts():
    """The launch counters as they were, restored after the test."""
    saved = graphs.launch_counts()
    yield
    graphs.set_launch_counts(saved)


def test_launch_counts_split_k2_and_k3_by_design(saved_counts):
    """K2's and K3's launches by design are keys of launch_counts, set,
    replayed and reset with the rest."""
    graphs.set_launch_counts({"K2": 5, "K2 sm90": 2, "K2 mma_sync": 3,
                              "K3 sm90": 4})
    assert tfa.flash_attention_bwd_dq.designs == {"sm90": 2, "mma_sync": 3}
    assert tfa.flash_attention_bwd_dkv.designs["sm90"] == 4
    got = graphs.launch_counts()
    assert {k: got[k] for k in ("K2", "K2 sm90", "K2 mma_sync",
                                "K3 sm90")} == {
        "K2": 5, "K2 sm90": 2, "K2 mma_sync": 3, "K3 sm90": 4}
    assert graphs.launch_counts(reset=True) == dict.fromkeys(got, 0)
    assert tfa.flash_attention_bwd_dkv.designs == {"sm90": 0, "mma_sync": 0}


def _row(design, shape, ms, per_run):
    row = dict(shape=shape, design=design, per_run=per_run,
               max_abs_err=1e-3, err_of_limit=0.2, control_of_limit=3.0,
               ms=ms, plain_ms=10 * ms, library_ms=0.8 * ms,
               bound_ms=0.3 * ms, bound_by="operations",
               share_of_bound=0.3)
    if design == "sm90":
        row.update(mma_sync_ms=2 * ms, mma_sync_max_abs_err=2e-3,
                   mma_sync_err_of_limit=0.3, graph_ms=0.9 * ms,
                   mma_sync_graph_ms=1.9 * ms, host_us=40.0,
                   mma_sync_host_us=30.0)
    return row


def test_kernel_report_and_pair_list_k2_and_k3_by_design():
    """The kernels line holds K2 and K3 by design, each with its launches
    from each path's counted run; the mma.sync entries carry their time
    beside the Hopper design's at its shapes. The backward pair's line sums
    both over a path as run and with the mma.sync design everywhere."""
    k1 = [_row("sm90", "B6 Lq6912", 1.3, {"serve": 150})]
    k1[0].update(lse_err=1e-6, mma_sync_lse_err=1e-6)
    bwd = {key: [_row("sm90", "B9 Lq3072", 1.0, {"train": 4}),
                 _row("mma_sync", "B9 Lq3072 Lk77", 0.1, {"train": n})]
           for key, n in (("K2", 26), ("K3", 27))}
    kernels = {"K1": k1, **bwd,
               "K4": [_row("sm90", "s", 1.0, {"train": 20}),
                      _row("mma_sync", "s8", 0.1, {"train": 1})]}
    # runs in which some shapes kept the mma.sync design (4 of each a step)
    launches = {"train": {**chip_smoke.unet_k1(3),
                          **chip_smoke.unet_bwd(3, {"K2": 4, "K3": 4}),
                          **chip_smoke.k4(encodes=3)},
                "mode3": {**chip_smoke.unet_k1(1),
                          **chip_smoke.unet_bwd(1, {"K2": 14, "K3": 14}),
                          **chip_smoke.k4(encodes=1)}}
    report = chip_smoke.kernel_report(kernels, launches, "H100, 700 W")
    by_name = {e["name"]: e for e in report}
    assert list(by_name) == [
        "flash_attention_fwd_sm90", "flash_attention_fwd",
        "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv_sm90", "flash_attention_bwd_dkv",
        "fused_affine_silu_conv3x3_sm90", "fused_affine_silu_conv3x3"]
    for e in report:
        assert {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(e)
    dq, dq_mma = (by_name["flash_attention_bwd_dq_sm90"],
                  by_name["flash_attention_bwd_dq"])
    assert dq["source"].endswith("csrc/flash_attention_bwd_dq_sm90.cu")
    assert dq["replaces"] == "view_neti_tpu/ops/flash_attention.py:160"
    assert dq["launches_by_path"] == {"train": 12, "mode3": 14}
    assert dq_mma["launches_by_path"] == {"train": 78, "mode3": 16}
    assert by_name["flash_attention_bwd_dkv"]["launches_by_path"] == {
        "train": 81, "mode3": 17}
    assert dq["ms"] == 1.0 and dq["mma_sync_ms"] == 2.0
    # the mma.sync entry: its own shapes and its time beside the Hopper one
    assert dq_mma["ms"] == 2.0 and dq_mma["err_of_limit"] == 0.3
    assert dq_mma["train_path_ms"] == pytest.approx(26 * 0.1)
    pair = chip_smoke.bwd_pair(kernels)["train"]
    assert pair["designs"] == {"K2": {"sm90": 4, "mma_sync": 26},
                               "K3": {"sm90": 4, "mma_sync": 27}}
    assert pair["pair_ms"] == pytest.approx(2 * (4 * 1.0) + 0.1 * (26 + 27))
    assert pair["pair_mma_sync_ms"] == pytest.approx(
        2 * (4 * 2.0) + 0.1 * (26 + 27))
    assert pair["sdpa_backward_ms"] == pytest.approx(0.8 * 4 + 0.08 * 27)
    # a Hopper shape not timed on the mma.sync design: the all-mma.sync
    # sums of its paths are unknown
    bwd["K2"][0] = {k: v for k, v in bwd["K2"][0].items()
                    if k != "mma_sync_ms"}
    pair = chip_smoke.bwd_pair(kernels)["train"]
    assert pair["k2_mma_sync_ms"] is None and pair["pair_mma_sync_ms"] is None
    assert pair["k3_mma_sync_ms"] == pytest.approx(4 * 2.0 + 0.1 * 27)
    assert pair["pair_ms"] == pytest.approx(2 * (4 * 1.0) + 0.1 * (26 + 27))


# the Hopper design's tile edges: the first key past the 80-key edge,
# queries and keys across K2's 128-query blocks and 64-key stages and K3's
# 128-key blocks and 64-query stages, the ragged last tile of each
@pytest.mark.parametrize("Lq,Lk,d", [(63, 81, 40), (129, 200, 64),
                                     (200, 129, 40), (65, 129, 64)])
def test_plain_backward_matches_pallas_vjp_at_the_sm90_tile_edges(Lq, Lk,
                                                                   d):
    """The plain backward the card's kernels are held to, against jax.vjp
    of the Pallas flash attention in interpret mode on the same numpy
    inputs, to 1e-5 absolute and relative: both compute in fp32, in other
    orders."""
    rng = np.random.RandomState(Lq + Lk + d)
    q, do = (rng.randn(1, Lq, 2, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, Lk, 2, d).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_ref(tq, tk, tv)
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, interpret=True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# the Hopper design's new tile edges: buckets 80 and 160 past 80 keys
# (64-key K2 stages, 32 at 160; 128-key K3 blocks, 64 at 160) with ragged
# queries, and up to 80 keys at every bucket (K2's short-key kernel at 48
# and 64: one 80-key tile of the mid blocks' 48 and the cross-attention's
# 77 keys, or a full one); one head, to keep the interpreted kernels short
@pytest.mark.parametrize("Lq,Lk,d", [
    (63, 81, 80), (200, 129, 80), (130, 81, 160), (65, 129, 160),
    (70, 48, 40), (130, 77, 40), (200, 80, 40),
    (130, 48, 64), (200, 77, 64), (70, 80, 64),
    (200, 48, 80), (70, 77, 80), (130, 80, 80),
    (48, 48, 160), (70, 77, 160), (200, 80, 160)])
def test_plain_backward_matches_pallas_vjp_at_the_wide_and_short_edges(
        Lq, Lk, d):
    """As the test above, at the tile edges of the buckets 80 and 160 and
    of the short-key shapes, to the same 1e-5."""
    rng = np.random.RandomState(Lq + Lk + d)
    q, do = (rng.randn(1, Lq, 1, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, Lk, 1, d).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_ref(tq, tk, tv)
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, interpret=True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
