"""Device time of a torch.profiler trace, as the profile_* scripts read
it, and the MoE FFN's stages timed apart."""
from __future__ import annotations

import argparse
import dataclasses

import torch
from torch.autograd import DeviceType

from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.models import blocks


def device_kernels(events):
    """The CUDA kernels of a trace's ``key_averages()``, by device time
    (largest first), their summed self time in ms and their launch
    count. Only kernels are summed: an operator's own row repeats its
    kernels' time."""
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return kernels, busy, sum(e.count for e in kernels)


# the architectures the profiles build: those without a cross-attention
# memory (their prompts are tokens alone)
PROFILE_ARCHS = tuple(a for a in PORTED_ARCHS
                      if get_config(a).family in ("dense", "moe"))


def add_arch_args(ap: argparse.ArgumentParser):
    ap.add_argument("--arch", choices=PROFILE_ARCHS,
                    default="trimkv-paper-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (mixtral-8x7b "
                         "at full width needs ~94 GB in bf16 whole: "
                         "--layers 8 takes ~24 GB)")


def arch_config(args):
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def graph_ms(fn, iters: int = 50) -> float:
    """Device ms of one fn() replayed as a CUDA graph: the mean over
    iters replays between two CUDA events (no host launch in it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def moe_stage_ms(ffn, cfg, x) -> dict:
    """One MoE layer's FFN over x [..., d] (a decode step's [B, 1, d] or
    a chunk's [B, C, d]) split into its stages, each replayed alone as a
    CUDA graph: router (float32 logits, softmax, top-k), dispatch
    (queue positions, keep mask, gather into the experts' slots),
    experts (three batched matmuls over [E, n_groups * cap, d]) and
    combine (gather back, weight, sum), and the whole moe_apply (the
    aux besides). Their shapes are static, so the times do not depend
    on the routing. Returns {stage: ms}."""
    xf = x.reshape(-1, x.shape[-1])
    k = cfg.experts_per_token
    _, top_idx, top_vals = blocks.moe_route(ffn.router, xf, k)
    keep, slot, xin = blocks.moe_dispatch(ffn, xf, top_idx, cfg)
    eo = blocks.moe_experts(ffn, xin)
    stages = {
        "router": lambda: blocks.moe_route(ffn.router, xf, k),
        "dispatch": lambda: blocks.moe_dispatch(ffn, xf, top_idx, cfg),
        "experts": lambda: blocks.moe_experts(ffn, xin),
        "combine": lambda: blocks.moe_combine(eo, keep, slot, top_vals,
                                              x.dtype),
        "moe_apply": lambda: blocks.moe_apply(ffn, x, cfg),
    }
    return {name: graph_ms(fn) for name, fn in stages.items()}


def print_moe_stages(model, cfg, shape, label, n_calls: int):
    """Print layer 0's FFN stages (moe_stage_ms) over a random input of
    ``shape`` (bf16 N(0, 1), through norm2 as the block feeds it), each
    times n_calls (the layers a step or chunk calls it in)."""
    g = torch.Generator(device=model.device)
    g.manual_seed(0)
    x = torch.randn(shape, generator=g, device=model.device).to(
        model.embed.dtype)
    blk = model.layers[0]
    x = blocks.rmsnorm_apply(blk.norm2.scale, x, cfg.norm_eps)
    ms = moe_stage_ms(blk.ffn, cfg, x)
    S = x.numel() // x.shape[-1]
    group, n_groups, cap = blocks.moe_capacity(cfg, S)
    print(f"{label}: MoE FFN over {S} tokens ({n_groups} group(s) of "
          f"{group}, capacity {cap} a group, {cfg.num_experts} experts, top "
          f"{cfg.experts_per_token}), one layer / x {n_calls}:")
    for name, t in ms.items():
        print(f"  {name:10s} {t:9.4f} ms  {t * n_calls:9.3f} ms")
