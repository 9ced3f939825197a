"""The rendering traffic: DTU novel views, one view a request, closed loop.

Set-up writes the calibration files under TMPDIR, builds the program's
stack with the view tokens of every camera and one object token, loads
the run's weights, routes the VAE decode through the fused conv as the
program's inference paths do, and makes the graphed denoise loop and
decode (pipeline.make_denoise_fn, make_decode_fn). A request is one view:
PromptManager.embed_prompts on "<view>. A photo of a <object>" (every
timestep and UNet layer), then pipeline.generate_batch over the cell's
seeds with the benchmark's own denoise and decode wrappers around the
program's, then the images' copy to the host as uint8. The views cycle
through the eval cameras from an offset drawn from the seed. Set-up warms
up `warmup_views` views (the eager call, then the capture); the window
runs views until `seconds` have passed at a view's end (traced:
`trace_views` views, with a synchronize after each stage).

The check: `check_views` views drawn from the seed among the first
`check_pool` of the window keep the program's conditioning, and of
`check_seeds` of their seeds (drawn too) the final latents and images. After the window the reference works out the
conditioning and the whole denoise loop in float32 from the same weights,
prompt and initial noise, and decodes the program's final latents.
"""
from __future__ import annotations

import gc
import os
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.reference import neti, prec, sched


def run(ctx) -> Dict:
    from view_neti_tpu_torch.config import RunConfig, decode
    from view_neti_tpu_torch.data import dtu
    from view_neti_tpu_torch.inference import pipeline
    from view_neti_tpu_torch.inference.prompt_manager import PromptManager
    from view_neti_tpu_torch.schedulers.dpm_solver import DPMSolverSchedule
    from view_neti_tpu_torch.tokenizer import FallbackTokenizer
    from view_neti_tpu_torch.training import builder

    cfg, t, device = ctx.config, ctx.traffic, ctx.device
    marks = [("start", time.perf_counter())]
    rng = np.random.default_rng([int(ctx.seed), 2])
    cal = os.path.join(ctx.tmpdir, "cal18")
    cams = common.write_calibration(rng, cal, t["calibration_cams"])
    lookup, _ = dtu.dtu_generate_dset_cam_tokens_params(calibration_dir=cal)
    view_tokens = [lookup[i] for i in sorted(lookup)]
    run_cfg = decode(RunConfig, {
        "learnable_mode": 2, "seed": int(ctx.seed),
        "model": dict(cfg["recipe_model"]),
        "data": {"camera_representation": "dtu-12d",
                 "super_category_object_token": t["super_object"],
                 "super_category_view_token": t["super_view"]},
        "optim": {"mixed_precision": "bf16"}})
    arch = common.program_arch(cfg)
    dtype = torch.bfloat16
    tok = FallbackTokenizer(base_vocab_size=arch.text.vocab_size)
    built = builder.build_models(run_cfg, tok, view_tokens,
                                 [t["object_token"]], arch=arch,
                                 compute_dtype=dtype, calibration_dir=cal,
                                 device=device)
    common.sync(device)
    marks.append(("build", time.perf_counter()))
    common.load_program_weights(built, cfg, ctx.seed, device, run_cfg, tok)
    common.sync(device)
    marks.append(("weights", time.perf_counter()))
    if torch.device(device).type == "cuda":
        builder.fuse_for_inference(built.vae)
    sch = DPMSolverSchedule(prediction_type=cfg["prediction_type"])
    n_steps, H, W = t["steps"], t["height"], t["width"]
    pm = PromptManager(tok, built.text, sch.set_timesteps(n_steps),
                       built.placeholder_view_token_ids,
                       built.placeholder_object_token_ids, dtype=dtype)
    uncond = pipeline.encode_uncond(built.text.clip, tok,
                                    t["negative_prompt"])
    denoise = pipeline.make_denoise_fn(built.unet, sch, n_steps,
                                       t["guidance"], dtype)
    decode_fn = pipeline.make_decode_fn(built.vae)
    spans = common.Spans()
    traced = ctx.trace is not None
    last = {}

    def denoise_w(*args):
        with spans("bench.denoise", sync=traced):
            last["lat0"] = args[0]
            last["lat"] = denoise(*args)
        return last["lat"]

    def decode_w(z):
        with spans("bench.decode", sync=traced):
            return decode_fn(z)

    cams_eval = t["cams"]
    start = int(rng.integers(len(cams_eval)))

    def prompt_of(i):
        return t["prompt"].format(view=lookup[cams_eval[i % len(cams_eval)]],
                                  object=t["object_token"])

    def view(i):
        with spans("bench.prompt", sync=traced):
            ctx_, ctx_b = pm.embed_prompts([prompt_of(i)])
        imgs = pipeline.generate_batch(
            built.unet, built.vae, sch, ctx_, ctx_b, uncond, H, W,
            t["seeds"], n_steps, t["guidance"], dtype, denoise_fn=denoise_w,
            as_numpy=False, device=device, decode_fn=decode_w)
        with spans("bench.copy"):
            host = imgs.cpu()
        return ctx_, ctx_b, host

    marks.append(("stack", time.perf_counter()))
    for i in range(t["warmup_views"]):
        view(start + i)
        common.sync(device)
        marks.append((f"warmup_view{i}", time.perf_counter()))
    pool = t["check_pool"]
    picks = sorted(rng.choice(pool, t["check_views"], replace=False)
                   .tolist())
    sidx = {v: sorted(rng.choice(len(t["seeds"]), t["check_seeds"],
                                 replace=False).tolist()) for v in picks}
    kept, failed, n = {}, 0, 0
    common.sync(device)
    if traced:
        ctx.trace.start()
    t0 = time.perf_counter()
    while True:
        c, cb, host = view(start + t["warmup_views"] + n)
        ok = (host.dtype == torch.uint8
              and tuple(host.shape) == (1, len(t["seeds"]), H, W, 3))
        failed += not ok
        if n in picks:
            si = sidx[n]
            kept[n] = dict(prompt=prompt_of(start + t["warmup_views"] + n),
                           seeds=si, ctx=c.cpu(), ctx_b=cb.cpu(),
                           lat0=last["lat0"][si].cpu(),
                           lat=last["lat"][si].cpu(), images=host[0][si])
        n += 1
        if traced and n >= t["trace_views"]:
            break
        if not traced and n >= pool and time.perf_counter() - t0 >= \
                ctx.seconds:
            break
    common.sync(device)
    t1 = time.perf_counter()
    if traced:
        ctx.trace.stop()
    common.note_phases(marks + [("window_open", t0)])
    out = SimpleNamespace(t0=t0, t1=t1, steps=n, views=n,
                          images=n * len(t["seeds"]), attempted=n,
                          failed=failed, n_steps=n_steps)
    out.peak_bytes = ctx.read_peak()
    views_tok = list(view_tokens)
    out.keep = dict(
        views=kept, picks=picks,
        uncond_ids=tok(t["negative_prompt"], padding="max_length",
                       truncation=True,
                       max_length=arch.text.max_position_embeddings
                       ).input_ids,
        ids=dict(obj=tok.convert_tokens_to_ids(t["object_token"]),
                 obj_super=tok.encode(t["super_object"],
                                      add_special_tokens=False)[0],
                 view=tok.convert_tokens_to_ids(views_tok),
                 view_super=tok.encode(t["super_view"],
                                       add_special_tokens=False)[0]),
        view_cams=sorted(lookup),
        prompt_ids={k: tok([v["prompt"]], padding="max_length",
                           truncation=True,
                           max_length=arch.text.max_position_embeddings
                           ).input_ids for k, v in kept.items()})
    out.cams = cams
    del built, pm, denoise, decode_fn, uncond, last
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _ids(x, device):
    return torch.as_tensor(np.asarray(x, np.int64).reshape(1, -1),
                           device=device)


def reference_views(ctx, out, mode: str = "fp32", reuse=None) -> Dict:
    """For each kept view: the reference's conditioning, its final latents
    from the same initial noise and its decode of the program's final
    latents. reuse: an earlier result of the same weights and prompts,
    whose conditioning and latents are kept (only the decode of the
    program's latents is worked out again)."""
    cfg, t, device, k = ctx.config, ctx.traffic, ctx.device, out.keep
    stack, cond = common.reference_conditioner(
        cfg, ctx.seed, device, k["ids"], out.cams, k["view_cams"])
    ts = sched.dpm_timesteps(out.n_steps)
    res = {}
    with torch.no_grad(), prec.use(mode):
        if reuse is not None:
            for v, kept in k["views"].items():
                img = stack.vae.decode_uint8(
                    kept["lat"].to(device).to(torch.bfloat16).float())
                res[v] = dict(reuse[v], img_decode=img.cpu())
            return res
        unc = neti.uncond_context(stack.text, _ids(k["uncond_ids"], device))
        unc16 = unc[None].expand(16, *unc.shape)
        for v, kept in k["views"].items():
            ids = _ids(k["prompt_ids"][v], device)
            cs, cbs = [], []
            for tt in ts:
                c, cb = neti.conditioning(cond, ids, torch.tensor(
                    [float(tt)], device=device))
                cs.append(c)
                cbs.append(cb)
            S = kept["lat0"].shape[0]
            lat0 = kept["lat0"].to(device).float()

            def model(x, tstep, i=[0]):
                j = i[0]
                i[0] += 1
                c = torch.cat([unc16.expand(16, S, *unc.shape[1:]),
                               cs[j].expand(16, S, *cs[j].shape[2:])], 1)
                cb = torch.cat([unc16.expand(16, S, *unc.shape[1:]),
                                cbs[j].expand(16, S, *cbs[j].shape[2:])], 1)
                tv = torch.full((2 * S,), tstep, device=device)
                return sched.split_cfg(stack.unet(torch.cat([x, x]), tv, c,
                                                  cb), t["guidance"])

            lat = sched.dpm_sample(model, lat0, out.n_steps,
                                   stack.prediction)
            prog_lat = kept["lat"].to(device)
            img_ref = stack.vae.decode_uint8(
                prog_lat.to(torch.bfloat16).float())
            img_e2e = stack.vae.decode_uint8(lat)
            res[v] = dict(ctx=torch.stack(cs)[:, :, 0].cpu(),
                          ctx_b=torch.stack(cbs)[:, :, 0].cpu(),
                          lat=lat.cpu(), img_decode=img_ref.cpu(),
                          img_e2e=img_e2e.cpu())
    return res


reference = reference_views


def as_program(ctx, out, ref: Dict):
    """The run's record with the reference's outputs in the program's
    place (the control): its conditioning, latents and images."""
    views = {v: dict(kept, ctx=ref[v]["ctx"][:, :, None],
                     ctx_b=ref[v]["ctx_b"][:, :, None], lat=ref[v]["lat"],
                     images=ref[v]["img_e2e"])
             for v, kept in out.keep["views"].items()}
    return SimpleNamespace(**{**vars(out),
                              "keep": dict(out.keep, views=views)})


def readings(ctx, out, ref: Dict) -> Dict[str, float]:
    worst = {}
    for v, kept in out.keep["views"].items():
        r = ref[v]
        pc = kept["ctx"][:, :, 0].float()
        pcb = kept["ctx_b"][:, :, 0].float()
        img = kept["images"].int()
        d_dec = (img - r["img_decode"].int()).abs().float()
        d_e2e = (img - r["img_e2e"].int()).abs().float()
        vals = {
            "cond_gap": max(common.rel_gap(pc, r["ctx"]),
                            common.rel_gap(pcb, r["ctx_b"])),
            "latent_gap": common.rel_gap(kept["lat"].float(), r["lat"]),
            "decode_mean_levels": float(d_dec.mean()),
            "decode_max_levels": float(d_dec.max()),
            "image_mean_levels": float(d_e2e.mean())}
        for name, x in vals.items():
            worst[name] = max(worst.get(name, 0.0), x)
    return worst
