"""One-shot batched generation under a KV budget, on the PyTorch port.

Mirrors the one-shot (non-stream) mode of the JAX package's serving
launcher: random weights from --seed, a synthetic "copy" batch, one
Engine.generate, then the decode rate and the first row of ids.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --budget 32 --prompt-len 64 --max-new 16

--device defaults to cuda (the hand-written kernels); without a card it
fails rather than fall back to the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.data.synthetic import make_batch
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED_ARCHS, default="trimkv-paper-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (CUDA kernels) or cpu (plain PyTorch)")
    ap.add_argument("--policy", default="trimkv")
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--chunked", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=2048,
                    help="chunk width for --chunked prefill (the tail chunk "
                         "is padded to this width and masked)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = T.init_params(cfg, seed=args.seed, device=args.device)
    T.init_gate_params(model, cfg, seed=args.seed + 1)
    eng = build_engine(cfg, model, device=args.device, budget=args.budget,
                       policy=args.policy, prefill_chunk=args.prefill_chunk)
    tokens, _, _ = make_batch("copy", args.seed, args.batch,
                              args.prompt_len, cfg.vocab_size)
    out = eng.generate(tokens, args.max_new, chunked=args.chunked)
    print(f"device={eng.device} policy={args.policy} budget={args.budget} "
          f"prefill {out['prefill_tok_per_sec']:.1f} tok/s, "
          f"decode {out['tok_per_sec']:.1f} tok/s "
          f"({out['decode_sec']:.2f}s for {args.max_new} steps)")
    print("first row ids:", out["ids"][0][:16])


if __name__ == "__main__":
    main()
