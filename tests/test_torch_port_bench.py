"""python -m view_neti_tpu_torch.bench on the CPU, at the miniature width
(BENCH_TINY=1), against the JAX package's bench.py.

Each of the five modes prints one JSON line with the JAX bench's metric
name for the same environment; the raw mode's synthetic inputs and the end
to end modes' scans are the JAX bench's recipe, restated here with numpy
and the JAX package's DTU helpers; each kernel's FLOP formula equals
FlopCounterMode's count of the textbook computation; refused switches and
an unknown mode give the error line and exit 1. The card's numbers (mfu)
come only from chip_smoke.py's bench phase.
"""
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bench as jbench
from view_neti_tpu.data import dtu as jdtu
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok

from view_neti_tpu_torch import bench
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.models.unet import UNet2DCondition, tiny_unet_config
from view_neti_tpu_torch.ops import flop_count
from view_neti_tpu_torch.ops.flash_attention import flash_attention
from view_neti_tpu_torch.ops.fused_conv import fused_affine_silu_conv3x3
from view_neti_tpu_torch.ops.norm import group_norm_fold
from view_neti_tpu_torch.tokenizer import FallbackTokenizer

MODES = {
    "raw": {"BENCH_E2E": "0", "BENCH_STEPS": "2"},
    "coach_mode2": {"BENCH_STEPS": "4"},
    "coach_mode3": {"BENCH_MODE": "3", "BENCH_STEPS": "4"},
    "serving": {"BENCH_INFER": "1", "BENCH_INFER_STEPS": "2"},
    "sweep": {"BENCH_VAL": "1"},
}
KEYS = {"metric", "value", "unit", "vs_baseline", "device",
        "flops_per_image", "tflops_per_sec"}
UNITS = {"raw": "imgs/sec/chip", "coach_mode2": "imgs/sec/chip",
         "coach_mode3": "imgs/sec/chip", "serving": "sec/image",
         "sweep": "seconds"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny modes run thousands of small ops. Beside the other test
    workers, torch's 8-thread parallel regions spend most of their time
    waiting for cores; on one thread they do not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_bench_env(monkeypatch):
    """The JAX bench's _metric_name reads os.environ: start each test
    without the BENCH_* variables of the calling shell."""
    for name in list(os.environ):
        if name.startswith("BENCH_"):
            monkeypatch.delenv(name)


def run_bench(capsys, env, device="cpu"):
    """(exit code, the one stdout line parsed)."""
    rc = bench.main([], env=env, device=device)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_prints_one_line(mode, capsys, monkeypatch):
    env = dict(MODES[mode], BENCH_TINY="1")
    rc, rec = run_bench(capsys, env)
    assert rc == 0, rec
    assert KEYS <= set(rec) and "mfu" not in rec, rec
    assert rec["device"] == "cpu" and rec["unit"] == UNITS[mode]
    for key in ("value", "vs_baseline", "flops_per_image", "tflops_per_sec"):
        assert math.isfinite(rec[key]) and rec[key] > 0, (key, rec)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert rec["metric"] == jbench._metric_name()


# ------------------------------------------------------------ recipes ----

@pytest.mark.parametrize("augmented", [False, True])
def test_raw_recipe_equals_the_jax_benchs(augmented, tmp_path):
    """bench.py:164-218 from RandomState(0): the six view tokens, the 64
    calibration files, then the batch."""
    B, H, W, L, view_id, obj_id = 3, 8, 12, 77, 49410, 49411
    rng = np.random.RandomState(0)
    tokens = bench.synthetic_view_tokens(rng)
    bench.write_calibration(rng, str(tmp_path))
    got = bench.raw_batch(rng, B, H, W, L, FallbackTokenizer(), view_id,
                          obj_id, augmented)

    want_rng = np.random.RandomState(0)
    assert tokens == [jdtu.dtu_cam_params_to_token(
        want_rng.randn(3, 4).astype(np.float32) * 100, i)
        for i in jdtu.dtu_get_train_idxs(6)]
    assert sorted(os.listdir(tmp_path)) == [f"pos_{i:03d}.txt"
                                            for i in range(1, 65)]
    for i in range(1, 65):
        m = want_rng.randn(3, 4) * 100
        assert (tmp_path / f"pos_{i:03d}.txt").read_text() == "\n".join(
            " ".join(f"{x:.4f}" for x in r) for r in m)
    tok = JTok()
    ids = np.full((B, L), tok.eos_token_id, np.int32)
    ids[:, 0] = tok.bos_token_id
    ids[:, 1] = view_id
    ids[:, 2:7] = 100
    ids[:, 7] = obj_id
    pixels = (want_rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
              if augmented else
              want_rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32))
    np.testing.assert_array_equal(got["input_ids"], ids)
    np.testing.assert_array_equal(got["pixel_values"], pixels)
    assert got["pixel_values"].dtype == pixels.dtype
    np.testing.assert_array_equal(got["input_ids_placeholder_view"],
                                  np.full((B,), view_id))
    np.testing.assert_array_equal(got["input_ids_placeholder_object"],
                                  np.full((B,), obj_id))


@pytest.mark.parametrize("scans", [["scan114"], ["scan110", "scan118"]])
def test_scans_equal_the_jax_benchs(scans, tmp_path):
    """bench.py:375-392: the calibration files, then each scan's
    dtu_subset-6 images in RandomState order, at the tiny size."""
    rect, cal = bench.write_scans(str(tmp_path), np.random.RandomState(0),
                                  scans, (48, 64))
    want_rng = np.random.RandomState(0)
    for i in range(1, 65):
        m = want_rng.randn(3, 4) * 100
        with open(os.path.join(cal, f"pos_{i:03d}.txt")) as f:
            assert f.read() == "\n".join(" ".join(f"{x:.4f}" for x in r)
                                         for r in m)
    for s in scans:
        assert len(os.listdir(os.path.join(rect, s))) == 6
        for i in jdtu.dtu_get_train_idxs(6):
            img = image_io.read_rgb(
                os.path.join(rect, s, f"rect_{i + 1:03d}_3_r5000.png"))
            np.testing.assert_array_equal(
                img, want_rng.randint(0, 255, (48, 64, 3), np.uint8))


# ------------------------------------------------------------- flops ----

def _count(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 8), (1, 2, 24, 77, 40),
                                   (2, 1, 9, 5, 64)])
def test_attention_flops_are_the_textbook_counts(shape):
    """K1's formula is the forward of softmax(s Q Kᵀ) V, K2's the backward
    to Q alone (dP, dQ), K2 + K3 the whole backward (dP, dQ, dK, dV)."""
    B, H, Lq, Lk, d = shape
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, L, d, generator=g, requires_grad=True)
               for L in (Lq, Lk, Lk))
    do = torch.randn(B, H, Lq, d, generator=g)

    def attend():
        return torch.softmax(d ** -0.5 * q @ k.transpose(-1, -2), -1) @ v

    flops = flop_count.attention_flops(B, H, Lq, Lk, d)
    assert _count(attend) == flops
    o = attend()
    assert _count(lambda: torch.autograd.grad(o, q, do,
                                              retain_graph=True)) == flops
    assert _count(lambda: torch.autograd.grad(o, (q, k, v), do)) == 2 * flops
    # the port's plain version, the CPU's path of K1, counts the same
    ql, kl, vl = (t.detach().transpose(1, 2) for t in (q, k, v))
    assert flop_count.count_flops(flash_attention, ql, kl, vl) == {
        "aten": flops}


@pytest.mark.parametrize("shape", [(2, 8, 12, 32, 16), (1, 6, 6, 16, 40)])
def test_conv3x3_flops_are_the_textbook_count(shape):
    """K4's formula is the count of conv2d(SiLU(GroupNorm(x))), 3x3,
    padding 1, with its bias, through autograd; the port's plain version
    of K4 counts the same."""
    B, H, W, Cin, Cout = shape
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, Cin, H, W, generator=g, requires_grad=True)
    weight = torch.randn(Cout, Cin, 3, 3, generator=g)
    bias = torch.randn(Cout, generator=g)
    norm = torch.nn.GroupNorm(4, Cin)
    flops = flop_count.conv3x3_flops(B, H, W, Cin, Cout)
    assert _count(lambda: F.conv2d(F.silu(norm(x)), weight, bias,
                                   padding=1)) == flops
    xh = x.detach().permute(0, 2, 3, 1).contiguous()
    a, b = group_norm_fold(xh, 4, norm.weight.detach(), norm.bias.detach(),
                           norm.eps)
    kernel = weight.permute(2, 3, 1, 0).contiguous()
    assert flop_count.count_flops(fused_affine_silu_conv3x3, xh, a, b,
                                  kernel, bias) == {"aten": flops}


def test_count_holds_no_recompute():
    """With gradient checkpointing on, the count switches it off for the
    call: the same FLOPs as the UNet without it, fewer than FlopCounterMode
    sees with the second forward."""
    g = torch.Generator().manual_seed(0)
    counts = {}
    for remat in (False, True):
        torch.manual_seed(0)
        unet = UNet2DCondition(tiny_unet_config(
            gradient_checkpointing=remat))
        lat = torch.randn(1, 8, 8, 4, generator=g)
        ctx = torch.randn(1, 16, 32, generator=g, requires_grad=True)

        def step():
            unet(lat, torch.tensor([10.0]), ctx).square().mean().backward()

        counts[remat] = (flop_count.count_flops(
            step, recompute_modules=(unet,))["aten"], _count(step))
        assert unet.config.gradient_checkpointing == remat
    assert counts[True][0] == counts[False][0] == counts[False][1]
    assert counts[True][1] > counts[True][0]


def test_kernel_flops_context_is_single():
    with flop_count.KernelFlops() as kf:
        assert flop_count.KernelFlops.active is kf
        with pytest.raises(RuntimeError, match="already open"):
            flop_count.KernelFlops().__enter__()
    assert flop_count.KernelFlops.active is None


# ----------------------------------------------------------- failures ----

@pytest.mark.parametrize("env,named", [
    ({"BENCH_FLASH": "0"}, "BENCH_FLASH"),
    ({"BENCH_FUSECONV": "0"}, "BENCH_FUSECONV"),
    ({"BENCH_FUSE_UNET": "1", "BENCH_FLASH": "0", "BENCH_INFER": "1"},
     "BENCH_FLASH"),
    ({"BENCH_CHECK_FLASH": "1", "BENCH_E2E": "0"}, "BENCH_CHECK_FLASH"),
    ({"BENCH_MODE": "4"}, "BENCH_MODE"),
])
def test_refused_switches_and_unknown_mode(env, named, capsys, monkeypatch):
    env = dict(env, BENCH_TINY="1")
    rc, rec = run_bench(capsys, env)
    assert rc == 1
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert rec == {"metric": jbench._metric_name(), "value": 0.0,
                   "unit": "error", "vs_baseline": 0.0,
                   "error": rec["error"]}
    assert named in rec["error"]


@pytest.mark.parametrize("mode", ["serving", "sweep", "raw"])
def test_fuse_unet_switch_fuses_the_unet_where_the_vae_is(mode, capsys,
                                                         monkeypatch):
    """BENCH_FUSE_UNET=1 builds the fused UNet in the serving and sweep
    modes wherever they fuse the VAE (the card; forced here, the plain K4
    on CPU tensors), and not without the switch; the raw train step never
    fuses it (its UNet is differentiated), as the JAX bench reads the
    switch only in those two modes. The model FLOPs are the same either
    way; on the CPU without forcing, nothing is fused."""
    stacks = []
    stack = bench._stack

    def kept(*args, **kwargs):
        out = stack(*args, **kwargs)
        stacks.append(out[0])
        return out

    monkeypatch.setattr(bench, "_stack", kept)
    env = dict(MODES[mode], BENCH_TINY="1")
    if mode == "raw":
        env["BENCH_STEPS"] = "1"
    recs = {}
    for forced, switch in ((True, "1"), (True, "0"), (False, "1")):
        monkeypatch.setattr(bench, "fuses", lambda device: forced)
        rc, recs[forced, switch] = run_bench(
            capsys, dict(env, BENCH_FUSE_UNET=switch))
        assert rc == 0, recs[forced, switch]
        built = stacks[-1]
        assert built.vae.config.fuse_conv is forced
        assert built.unet.config.fuse_conv is (
            forced and switch == "1" and mode != "raw")
    flops = {k: r["flops_per_image"] for k, r in recs.items()}
    assert len(set(flops.values())) == 1, flops


def test_no_card_is_an_error(capsys, monkeypatch):
    """On the card by default: without one the bench fails, and does not
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, rec = run_bench(capsys, {"BENCH_TINY": "1", "BENCH_INFER": "1"},
                        device=None)
    assert rc == 1 and rec["unit"] == "error" and "CUDA" in rec["error"]


def test_sync_after_marks_the_step():
    """SyncAfter stamps the host clock once, after the call that reaches
    its step, and keeps the last call's arguments."""
    class Coach:
        device = torch.device("cpu")
        global_step = 1

        def __init__(self):
            self.window_step = lambda *a: sum(a)
            self.window_step.enabled = True

    coach = Coach()
    timer = bench.SyncAfter(coach, 3)
    assert coach.window_step is timer and timer.enabled
    assert coach.window_step(1, 2) == 3 and timer.at is None
    assert coach.window_step(4, 5) == 9 and timer.at is not None
    at = timer.at
    coach.window_step(6, 7)
    assert timer.at == at and timer.args == (6, 7)
