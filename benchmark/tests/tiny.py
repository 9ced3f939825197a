"""A checkout in miniature for the benchmark's CPU tests: BENCHMARK.json
with two tiny cells, their configuration, traffic mixes and limits, and a
copy of the metric readers, under a directory of the test's own."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def tiny_config() -> dict:
    cfg = json.loads((HERE / "configs" / "sd21.json").read_text())
    cfg.update(name="tiny", reduced=["text", "unet", "vae"])
    cfg["text"].update(vocab_size=512, hidden_size=32, num_layers=2,
                       num_heads=2, intermediate_size=64,
                       max_position_embeddings=16)
    cfg["unet"].update(block_out_channels=[32, 64, 64, 64],
                       cross_attention_dim=32, attention_head_dim=16,
                       norm_groups=8)
    cfg["vae"].update(base_channels=16, channel_mults=[1, 2], norm_groups=4)
    cfg["recipe_model"]["word_embedding_dim"] = 32
    return cfg


def tiny_traffic() -> dict:
    train = json.loads((HERE / "traffic" / "train_mode2.json").read_text())
    train["recipe"]["data"]["dtu_preprocess_key"] = -1
    train["scan"].update(height=96, width=128)
    train.update(train_size=[48, 64], warmup_steps=4, trace_steps=4)
    render = json.loads((HERE / "traffic" / "render_dtu.json").read_text())
    render.update(steps=2, height=32, width=32, seeds=[0, 1],
                  warmup_views=1, trace_views=2, check_views=1,
                  check_seeds=1, check_pool=2)
    return {"tiny_train": train, "tiny_render": render}


# the tiny cells' limits: a few times what the program reads there on the
# CPU (loss 1.2e-4, gradients 0.008, change 0.015; conditioning 0.007,
# latents 0.04, decode 0.37 levels)
LIMITS = {"tiny.train": {"loss_gap": 0.005, "grad_gap": 0.06,
                         "change_gap": 0.06, "bases_max_diff": 0},
          "tiny.render": {"cond_gap": 0.03, "latent_gap": 0.15,
                          "decode_mean_levels": 1.5}}


def make_root(tmp: Path, limits=None) -> Path:
    """The miniature checkout; returns its root."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"] = [{"name": "tiny", "source": "tests",
                         "file": "benchmark/configs/tiny.json",
                         "reduced": ["text", "unet", "vae"],
                         "why": "a miniature for the CPU tests"}]
    bench["workloads"] = [
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "tiny train"},
        {"name": "tiny.render", "config": "tiny", "traffic": "tiny_render",
         "chips": 1, "why": "tiny render"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "train" if any(".train" in w for w in m["workloads"]) \
                else "render"
            m["workloads"] = [f"tiny.{kind}"]
    d = tmp / "benchmark"
    (d / "configs").mkdir(parents=True)
    (d / "traffic").mkdir()
    (d / "limits").mkdir()
    shutil.copytree(HERE / "metrics", d / "metrics")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (d / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    for name, t in tiny_traffic().items():
        (d / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, lim in (limits or LIMITS).items():
        (d / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": lim}))
    return tmp
