"""Training launcher: distil the retention gates of a frozen model.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --device cpu --steps 3 --batch 2 --seq 64 --capacity-M 16

Without ``--device cpu`` it runs on the CUDA card, where L_cap goes
through the capacity-loss kernels; ``--smoke`` picks the reduced
config. ``--ckpt PATH`` writes the gates in the JAX package's
checkpoint format.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import (PORTED_ARCHS, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED_ARCHS,
                    default="trimkv-paper-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config runnable on CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--capacity-M", type=int, default=32)
    ap.add_argument("--task", default="mixed",
                    choices=("copy", "arithmetic", "multisession",
                             "procedural", "mixed"))
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    train_cfg = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                            capacity_M=args.capacity_M,
                            total_steps=args.steps)
    tasks = (("copy", "arithmetic", "multisession", "procedural")
             if args.task == "mixed" else (args.task,))
    data_cfg = DataConfig(batch=args.batch, seq_len=args.seq, tasks=tasks)
    _, history = train_loop(cfg, train_cfg, data_cfg, device=args.device,
                            steps=args.steps, ckpt_path=args.ckpt)
    print(f"done: {len(history)} logged steps, "
          f"final loss {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
