"""Model FLOPs and the bounds of the hand-written kernels' calls, from the
reference's shapes.

`unit_work(kind, cfg, traffic, ...)` runs the reference once on the
`meta` device at the cell's shapes, for one unit of work (one optimizer
step of the train traffic, one view of the render traffic), under
torch's FlopCounterMode: 2 FLOPs a multiply-add of every matrix product
and convolution, the backward where the step runs one, no recomputation
(the reference recomputes nothing). It also records each attention call
and each norm + SiLU + 3x3 convolution section, the work that the port's
kernels K1-K3 and K4 stand in for, whose bounds these functions give
against the published peaks of one H100 SXM:

  989e12 FLOP/s dense bf16 on the tensor cores and 3.35e12 bytes/s of HBM,
  both at the card's full power limit of 700 W.

A bound is the larger of FLOPs / peak FLOP/s and bytes / peak bytes/s,
with every input read once and every output written once (bf16 operands,
fp32 statistics). It is the same whatever kernel does the work.
"""
from __future__ import annotations

from typing import Dict

import torch

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16, 700 W
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
BF16, F32 = 2, 4


def attention_fwd(c: Dict) -> Dict[str, float]:
    """S = Q Kᵀ and O = P V; reads Q, K, V, writes O and the log-sum-exp."""
    B, H, Lq, Lk, d = c["B"], c["H"], c["Lq"], c["Lk"], c["d"]
    flops = 4 * B * H * Lq * Lk * d
    nbytes = BF16 * B * H * d * (2 * Lq + 2 * Lk) + F32 * B * H * Lq
    return {"flops": flops, "bytes": nbytes}


def attention_bwd(c: Dict) -> Dict[str, float]:
    """dP = dO Vᵀ always; dQ = dS K when Q needs a gradient; dV = Pᵀ dO
    and dK = dSᵀ Q when K or V does. Reads Q, K, V, O, dO, the
    log-sum-exp and rowsum(dO O); writes the gradients it makes."""
    B, H, Lq, Lk, d = c["B"], c["H"], c["Lq"], c["Lk"], c["d"]
    unit = 2 * B * H * Lq * Lk * d
    flops = unit * (1 + (1 if c["dq"] else 0) + (2 if c["dkv"] else 0))
    reads = BF16 * B * H * d * (3 * Lq + 2 * Lk) + 2 * F32 * B * H * Lq
    writes = BF16 * B * H * d * ((Lq if c["dq"] else 0)
                                 + (2 * Lk if c["dkv"] else 0))
    return {"flops": flops, "bytes": reads + writes}


def conv3x3(c: Dict) -> Dict[str, float]:
    """The 3x3 convolution at stride 1 of a norm + SiLU section: reads the
    input, the weights, the per-(batch, channel) affine and the residual,
    writes the output."""
    B, H, W, ci, co = c["B"], c["H"], c["W"], c["Cin"], c["Cout"]
    flops = 2 * 9 * B * H * W * ci * co
    nbytes = (BF16 * (B * H * W * ci + 9 * ci * co + B * H * W * co
                      * (2 if c["residual"] else 1))
              + F32 * (2 * B * ci + co))
    return {"flops": flops, "bytes": nbytes}


def bound_s(work: Dict[str, float]) -> float:
    return max(work["flops"] / PEAK_FLOPS, work["bytes"] / PEAK_BYTES)


def _meta_stack(cfg):
    from benchmark.reference import stack as ref_stack
    return ref_stack.build(cfg, "meta")


def _conditioner(stack, cfg, n_views: int = 64):
    from benchmark.reference import neti
    m = cfg["mapper"]
    V = n_views
    return neti.Conditioner(
        text=stack.text, obj_mapper=stack.object_mapper,
        view_mapper=stack.view_mapper, obj_norm=1.0, view_norm=1.0,
        obj_id=cfg["text"]["vocab_size"],
        view_ids=torch.arange(V, device="meta") + cfg["text"]["vocab_size"]
        + 1,
        view_params=torch.zeros(V, 12, device="meta"),
        alpha_obj=m["alpha_object"], alpha_view=m["alpha_view"])


def unit_work(kind: str, cfg: Dict, traffic: Dict) -> Dict:
    """{"flops": model FLOPs of one unit, "attention": [calls],
    "conv": [sections]} for kind "coach" (one optimizer step) or "render"
    (one view), at the traffic's sizes."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import neti, prec, sched
    stack = _meta_stack(cfg)
    cond = _conditioner(stack, cfg)
    L = cfg["text"]["max_position_embeddings"]
    ids_row = torch.zeros(1, L, dtype=torch.long, device="meta")
    total = 0.0
    with prec.Recorder() as rec:
        if kind == "coach":
            o = traffic["recipe"]["optim"]
            B = o["train_batch_size"] * o["gradient_accumulation_steps"]
            H, W = traffic["train_size"]
            for p in list(stack.object_mapper.parameters()) + list(
                    stack.view_mapper.parameters()):
                p.requires_grad_(True)
            f = 2 ** (len(cfg["vae"]["channel_mults"]) - 1)
            with FlopCounterMode(display=False) as fc:
                with torch.no_grad(), rec.at("vae"):
                    lat = stack.vae.encode_sample(
                        torch.zeros(B, H, W, 3, device="meta"),
                        torch.zeros(B, H // f, W // f, 4, device="meta"))
                t = torch.zeros(B, dtype=torch.long, device="meta")
                xt, target = sched.noised_and_target(lat, lat, t,
                                                     stack.prediction)
                c, cb = neti.conditioning(cond, ids_row.expand(B, L), t,
                                          block=16 * B)
                loss = ((stack.unet(xt, t.float(), c, cb) - target)
                        ** 2).mean()
                loss.backward()
            total = fc.get_total_flops()
        elif kind == "render":
            S = len(traffic["seeds"])
            n = traffic["steps"]
            H, W = traffic["height"], traffic["width"]
            f = 2 ** (len(cfg["vae"]["channel_mults"]) - 1)
            D = cfg["text"]["hidden_size"]
            with torch.no_grad():
                with FlopCounterMode(display=False) as fc:
                    neti.conditioning(cond, ids_row.expand(n, L),
                                      torch.zeros(n, device="meta"),
                                      block=16 * n)
                    with rec.at("vae"):
                        stack.vae.decode(torch.zeros(
                            S, H // f, W // f, 4, device="meta"))
                total = fc.get_total_flops()
                # the n denoising steps run the same UNet call: count one
                first = len(rec.attention), len(rec.conv)
                ctx = torch.zeros(16, 2 * S, L, D, device="meta")
                with FlopCounterMode(display=False) as fc:
                    stack.unet(torch.zeros(2 * S, H // f, W // f, 4,
                                           device="meta"),
                               torch.zeros(2 * S, device="meta"), ctx, ctx)
                total += n * fc.get_total_flops()
                rec.attention += rec.attention[first[0]:] * (n - 1)
                rec.conv += rec.conv[first[1]:] * (n - 1)
        else:
            raise ValueError(kind)
    return {"flops": float(total), "attention": rec.attention,
            "conv": rec.conv}


def attention_bound(work: Dict) -> Dict:
    """The attention calls of a unit that K1-K3 stand in for, the UNet's
    (the VAE's one-head attention is plain PyTorch in the port): the bound
    of their forward and backward work in seconds, and how many launches
    of each kernel they take at the least."""
    calls = [c for c in work["attention"] if c["where"] == "unet"]
    s = sum(bound_s(attention_fwd(c)) for c in calls)
    s += sum(bound_s(attention_bwd(c)) for c in calls
             if c["dq"] or c["dkv"])
    return {"bound_s": s, "launches": {
        "K1": len(calls), "K2": sum(1 for c in calls if c["dq"]),
        "K3": sum(1 for c in calls if c["dkv"])}}


def conv_bound(work: Dict) -> Dict:
    """The VAE's norm + SiLU + 3x3 conv sections of a unit, which K4 runs:
    their bound in seconds and their number."""
    calls = [c for c in work["conv"] if c["where"] == "vae"]
    return {"bound_s": sum(bound_s(conv3x3(c)) for c in calls),
            "launches": {"K4": len(calls)}}
