"""The reference, the configuration files and the counts, on the CPU.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests -q
"""
from __future__ import annotations

import io
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, readers
from benchmark.drivers import common
from benchmark.reference import prec
from benchmark.reference import stack as ref_stack
from benchmark.tests import tiny
from benchmark.trace import TraceData

HERE = Path(__file__).resolve().parents[1]
CONFIGS = ["sd21", "sd15"]


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_config_widths_are_the_builders(name):
    from view_neti_tpu_torch.training import builder
    cfg = config(name)
    rm = cfg["recipe_model"]
    assert common.program_arch(cfg) == builder.resolve_arch(
        rm["pretrained_model_name_or_path"], rm["word_embedding_dim"])


@pytest.mark.parametrize("name", CONFIGS)
def test_mapper_group_is_the_recipes(name):
    from view_neti_tpu_torch.config import ModelConfig
    cfg = config(name)
    m = ModelConfig(**cfg["recipe_model"])
    g = cfg["mapper"]
    assert (m.pe_sigmas.sigma_t, m.pe_sigmas.sigma_l,
            m.pe_sigmas.sigma_dtu12) == (g["sigma_t"], g["sigma_l"],
                                         g["sigma_dtu12"])
    assert m.arch_mlp_hidden_dims == g["object_hidden"]
    assert m.arch_view_net == 15 and g["view_hidden"] == 64
    assert (m.output_bypass_alpha_object, m.output_bypass_alpha_view) == (
        g["alpha_object"], g["alpha_view"])
    assert not (m.use_nested_dropout or m.bypass_unconstrained_object
                or m.bypass_unconstrained_view)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_parameters_are_the_programs(name):
    from view_neti_tpu_torch.models.clip_text import NeTICLIPTextEncoder
    from view_neti_tpu_torch.models.unet import UNet2DCondition
    from view_neti_tpu_torch.models.vae import AutoencoderKL
    cfg = config(name)
    arch = common.program_arch(cfg)
    shapes = ref_stack.param_shapes(cfg)
    with torch.device("meta"):
        prog = {"unet": UNet2DCondition(arch.unet),
                "vae": AutoencoderKL(arch.vae),
                "text": NeTICLIPTextEncoder(arch.text)}
    for group, module in prog.items():
        assert {n: tuple(p.shape) for n, p in module.named_parameters()} \
            == shapes[group], group


def _tiny_program(tmp_path):
    import numpy as np
    from view_neti_tpu_torch.config import RunConfig, decode
    from view_neti_tpu_torch.data import dtu
    from view_neti_tpu_torch.tokenizer import FallbackTokenizer
    from view_neti_tpu_torch.training import builder
    cal = str(tmp_path / "cal")
    common.write_calibration(np.random.default_rng(1), cal, 64)
    lookup, _ = dtu.dtu_generate_dset_cam_tokens_params(calibration_dir=cal)
    cfg = tiny.tiny_config()
    arch = common.program_arch(cfg)
    run_cfg = decode(RunConfig, {"learnable_mode": 2,
                                 "model": cfg["recipe_model"],
                                 "data": {"camera_representation":
                                          "dtu-12d"}})
    tok = FallbackTokenizer(base_vocab_size=arch.text.vocab_size)
    built = builder.build_models(run_cfg, tok, [lookup[0], lookup[1]],
                                 ["<object>"], arch=arch,
                                 calibration_dir=cal, device="cpu")
    return cfg, built, run_cfg, tok


def test_tiny_mappers_and_models_load_both_ways(tmp_path):
    cfg, built, run_cfg, tok = _tiny_program(tmp_path)
    shapes = ref_stack.param_shapes(cfg)
    for group, module in common.program_modules(built).items():
        assert {n: tuple(p.shape) for n, p in module.named_parameters()} \
            == shapes[group], group


def test_reference_unet_and_decode_are_the_programs_in_float32(tmp_path):
    cfg, built, run_cfg, tok = _tiny_program(tmp_path)
    common.load_program_weights(built, cfg, 5, "cpu", run_cfg, tok)
    ref = ref_stack.build(cfg, "cpu")
    from benchmark import weights as w
    shapes = ref_stack.param_shapes(cfg)
    for group, module in ref.modules().items():
        w.load_into(module, w.draw_group(shapes[group], 5, group, "cpu"),
                    group)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 16, 4, generator=g)
    t = torch.tensor([10.0, 700.0])
    ctx = torch.randn(16, 2, 16, 32, generator=g)
    ctxb = torch.randn(16, 2, 16, 32, generator=g)
    with torch.no_grad():
        a = built.unet(x, t, ctx, ctxb)
        b = ref.unet(x, t, ctx, ctxb)
        assert common.rel_gap(a, b) < 1e-5
        z = torch.randn(2, 8, 8, 4, generator=g)
        assert common.rel_gap(built.vae.decode(z), ref.vae.decode(z)) < 1e-5


def _attn(B=2, H=3, Lq=10, Lk=7, d=8, grad=(True, True)):
    q = torch.zeros(B, Lq, H, d, device="meta", requires_grad=grad[0])
    k = torch.zeros(B, Lk, H, d, device="meta", requires_grad=grad[1])
    v = torch.zeros(B, Lk, H, d, device="meta", requires_grad=grad[1])
    return q, k, v


@pytest.mark.parametrize("grad", [(False, False), (False, True),
                                  (True, True)])
def test_attention_flops_are_the_closed_forms(grad):
    q, k, v = _attn(grad=grad)
    with prec.Recorder() as rec, FlopCounterMode(display=False) as fc:
        out = prec.attention(q, k, v)
        if any(grad):
            out.sum().backward()
    c = rec.attention[0]
    want = flops.attention_fwd(c)["flops"]
    if any(grad):
        want += flops.attention_bwd(c)["flops"]
    assert fc.get_total_flops() == want == 2 * 2 * 3 * 10 * 7 * 8 * (
        2 + (1 if grad[0] else 0) + (3 if grad[1] else 0))


def test_conv_flops_are_the_closed_form():
    c = dict(B=2, H=5, W=6, Cin=4, Cout=7, residual=False)
    x = torch.zeros(2, 4, 5, 6, device="meta")
    wgt = torch.zeros(7, 4, 3, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(x, wgt, padding=1)
    assert fc.get_total_flops() == flops.conv3x3(c)["flops"]


def test_unit_work_counts_the_tiny_stacks_calls():
    cfg = tiny.tiny_config()
    t = tiny.tiny_traffic()
    work = flops.unit_work("coach", cfg, t["tiny_train"])
    a = flops.attention_bound(work)
    # one UNet forward: 16 self- and 16 cross-attentions; no gradient
    # reaches the first block's self-attention, nor the first
    # cross-attention's queries
    assert a["launches"] == {"K1": 32, "K2": 30, "K3": 31}
    assert flops.conv_bound(work)["launches"]["K4"] == 2 * 2 * 2 + 2 * 2 + 1
    r = flops.unit_work("render", cfg, t["tiny_render"])
    assert flops.attention_bound(r)["launches"]["K1"] == 32 * 2
    assert r["flops"] > 0 and work["flops"] > 0


def _run_with(ops, units=2):
    cfg = tiny.tiny_config()
    work = flops.unit_work("render", cfg, tiny.tiny_traffic()["tiny_render"])
    data = TraceData(ops=ops, spans=[], window=(0.0, 1e6), units=units)
    return type("Run", (), {"trace": data, "work": work})()


def test_roofline_reads_nothing_without_its_kernels():
    run = _run_with([("some_gemm_kernel", 0.0, 10.0)] * 200)
    assert readers.attention_roofline(run) is None
    assert readers.conv_roofline(run) is None


def test_roofline_reads_nothing_with_too_few_launches():
    run = _run_with([("flash_fwd_kernel_sm90", 0.0, 10.0)] * 63)
    assert readers.attention_roofline(run) is None


def test_roofline_at_the_bound_reads_100():
    run = _run_with([])
    b = flops.attention_bound(run.work)
    n = b["launches"]["K1"] * 2
    each = b["bound_s"] * 2 / n * 1e6
    run.trace.ops = [("flash_fwd_kernel_sm90", i * each, (i + 1) * each)
                     for i in range(n)]
    assert readers.attention_roofline(run) == pytest.approx(100.0)


def test_control_fails_and_program_passes_tiny(tmp_path):
    """The control: the reference on float8 operands in the program's
    place fails a limit that the program meets (tiny cells, CPU)."""
    from benchmark import control
    root = tiny.make_root(tmp_path)
    for cell in ("tiny.train", "tiny.render"):
        buf = io.StringIO()
        assert control.main(["--workload", cell, "--seeds", "11",
                             "--seconds", "0.5"], root=str(root),
                            device="cpu", out_stream=buf) == 0
        line = json.loads(buf.getvalue().splitlines()[-1])
        lim = tiny.LIMITS[cell]
        assert all(line["program"][k] <= v for k, v in lim.items()), line
        assert any(line["control"][k] > v for k, v in lim.items()), line


@pytest.mark.cuda
def test_cells_on_the_card_pass_and_their_control_fails():
    """Each cell of BENCHMARK.json at its own size on the card, one seed:
    the program meets every limit, the float8 control misses one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import control
    root = HERE.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        buf = io.StringIO()
        assert control.main(["--workload", cell["name"], "--seeds", "5",
                             "--seconds", "1"], root=str(root),
                            out_stream=buf) == 0
        line = json.loads(buf.getvalue().splitlines()[-1])
        lim = json.loads((HERE / "limits" / f"{cell['name']}.json")
                         .read_text())["limits"]
        assert all(line["program"][k] <= v for k, v in lim.items()), line
        assert any(line["control"][k] > v for k, v in lim.items()), line
