"""Batching / packing pipeline over the synthetic task generators.

Copied from ``repro/data/pipeline.py`` (numpy only). Deterministic,
seedable iterator of numpy batches with next-token labels.
Distillation training needs only (tokens, labels); eviction benchmarks
additionally use the answer spans for exact scoring.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.data.synthetic import make_batch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    tasks: Sequence[str] = ("copy", "arithmetic", "multisession",
                            "procedural")
    batch: int = 8
    seq_len: int = 512
    vocab: int = 512
    seed: int = 0


def batches(cfg: DataConfig) -> Iterator[dict]:
    """Infinite stream; round-robins tasks; labels[t] is the target for
    position t (i.e. token t+1 supervision already aligned by the task
    generators). Also emits standard LM next-token labels for the NTP
    distillation loss."""
    step = 0
    while True:
        task = cfg.tasks[step % len(cfg.tasks)]
        tokens, labels, spans = make_batch(task, cfg.seed + step,
                                           cfg.batch, cfg.seq_len,
                                           cfg.vocab)
        lm_labels = np.concatenate(
            [tokens[:, 1:], np.full((cfg.batch, 1), -1, np.int32)], axis=1)
        yield {"task": task, "tokens": tokens, "labels": labels,
               "lm_labels": lm_labels, "spans": spans, "step": step}
        step += 1
