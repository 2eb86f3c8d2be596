"""Synthetic verifiable long-context tasks (offline stand-ins for
OpenR1-Math / LongProc / LongMemEval), copied from
``repro/data/synthetic.py`` (numpy only) so the port imports nothing
from the JAX package.

Each generator emits (tokens, labels, answer_span) with ground truth, so
benchmarks can score eviction policies exactly. Vocabulary layout:
  0..9        digits
  10..19      operators / separators
  20..        "filler" words (uniform noise)
Specials: BOS=1, SEP=2 inside the reserved band.
"""
from __future__ import annotations

import numpy as np

BOS, SEP, EQ, PAD = 10, 11, 12, 13
FILLER_START = 20


def _rng(seed):
    return np.random.RandomState(seed)


def copy_task(seed: int, seq_len: int, vocab: int, key_len: int = 16):
    """Early key, long filler, model must reproduce the key at the end.
    The paper's needle-style recall: tests whether eviction keeps the
    early 'needle' tokens."""
    r = _rng(seed)
    key = r.randint(FILLER_START, vocab, size=key_len)
    filler_len = seq_len - 2 * key_len - 3
    filler = r.randint(FILLER_START, vocab, size=filler_len)
    prompt = np.concatenate([[BOS], key, [SEP], filler, [EQ]])
    tokens = np.concatenate([prompt, key, [SEP]])[:seq_len]
    labels = np.full(len(tokens), -1, np.int32)
    ans_start = len(prompt)
    labels[ans_start - 1: ans_start + key_len - 1] = key  # predict key
    return tokens.astype(np.int32), labels, (ans_start, ans_start + key_len)


def arithmetic_chain(seed: int, seq_len: int, vocab: int, n_steps: int = 8):
    """Running-sum chain-of-thought mod 10 with distractor text between
    steps; final answer depends on ALL intermediate steps (long-horizon:
    recent-attention heuristics evict early steps)."""
    r = _rng(seed)
    total = 0
    pieces = [[BOS]]
    per_step = max((seq_len - 4 - n_steps * 4) // n_steps, 4)
    for _ in range(n_steps):
        x = int(r.randint(0, 10))
        total = (total + x) % 10
        pieces.append([x, EQ, total])
        pieces.append(list(r.randint(FILLER_START, vocab, size=per_step)))
    pieces.append([SEP])
    tokens = np.concatenate(pieces)[:seq_len - 2]
    tokens = np.concatenate([tokens, [EQ, total]])
    labels = np.full(len(tokens), -1, np.int32)
    labels[-2] = total                      # predict final total after EQ
    return tokens.astype(np.int32), labels, (len(tokens) - 1, len(tokens))


def multi_session_recall(seed: int, seq_len: int, vocab: int,
                         n_facts: int = 4):
    """LongMemEval-style: facts stated in separate 'sessions' separated by
    chatter; query asks for one early fact."""
    r = _rng(seed)
    facts = r.randint(FILLER_START, vocab, size=(n_facts, 2))  # (slot, val)
    per_sess = max((seq_len - n_facts * 6 - 6) // n_facts, 4)
    pieces = [[BOS]]
    for i in range(n_facts):
        pieces.append([SEP, facts[i, 0], EQ, facts[i, 1]])
        pieces.append(list(r.randint(FILLER_START, vocab, size=per_sess)))
    q = int(r.randint(0, n_facts))
    pieces.append([SEP, facts[q, 0], EQ])
    tokens = np.concatenate(pieces)[:seq_len - 1]
    tokens = np.concatenate([tokens, [facts[q, 1]]])
    labels = np.full(len(tokens), -1, np.int32)
    labels[-2] = facts[q, 1]
    return tokens.astype(np.int32), labels, (len(tokens) - 1, len(tokens))


def procedural_trace(seed: int, seq_len: int, vocab: int, n_items: int = 6):
    """LongProc-style: a list of (tag, value) rows given up front, then
    the model must emit values in tag order — long structured output."""
    r = _rng(seed)
    tags = r.permutation(np.arange(FILLER_START,
                                   FILLER_START + n_items))
    vals = r.randint(0, 10, size=n_items)
    rows = []
    for tg, vl in zip(tags, vals):
        rows.extend([tg, EQ, vl, SEP])
    order = np.sort(tags)
    out = []
    val_by_tag = dict(zip(tags.tolist(), vals.tolist()))
    for tg in order:
        out.extend([tg, EQ, val_by_tag[int(tg)]])
    body = np.asarray([BOS] + rows + [SEP], np.int32)
    answer = np.asarray(out, np.int32)
    filler_len = max(seq_len - len(body) - len(answer), 0)
    filler = r.randint(FILLER_START, vocab, size=filler_len)
    tokens = np.concatenate([body[:-1], filler, [SEP], answer])[:seq_len]
    labels = np.full(len(tokens), -1, np.int32)
    astart = len(tokens) - len(answer)
    labels[astart - 1:-1] = tokens[astart:]
    return tokens.astype(np.int32), labels, (astart, len(tokens))


TASKS = {
    "copy": copy_task,
    "arithmetic": arithmetic_chain,
    "multisession": multi_session_recall,
    "procedural": procedural_trace,
}


def make_batch(task: str, seed: int, batch: int, seq_len: int, vocab: int):
    """Returns (tokens [B,T], labels [B,T], spans list)."""
    toks, labs, spans = [], [], []
    fn = TASKS[task]
    for b in range(batch):
        t, l, s = fn(seed * 1000 + b, seq_len, vocab)
        if len(t) < seq_len:
            t = np.concatenate([t, np.full(seq_len - len(t), PAD)])
            l = np.concatenate([l, np.full(seq_len - len(l), -1)])
        toks.append(t[:seq_len])
        labs.append(l[:seq_len])
        spans.append(s)
    return (np.stack(toks).astype(np.int32),
            np.stack(labs).astype(np.int32), spans)
