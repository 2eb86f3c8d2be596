"""Step programs over static buffers, captured as CUDA graphs: the
port's counterpart of the JAX package's ``jax.jit`` + ``lax.scan``.

The JAX package runs every serving loop as one scanned device program.
Here each loop body is a *step program*: a function that reads and
writes only tensors allocated before it first runs (the decode state of
B lanes and a few input/output buffers). On the card the first run of a
program executes it eagerly on the engine's capture stream (the warm-up
``torch.cuda.graph`` needs: the kernel library loads, the kernels'
shared-memory attributes are set, cached constants are made) and then
captures it; every later run is one replay. On the CPU, or with
``ServeConfig.fused=False``, a program is an eager call of the same
function.

``LanePrograms`` holds, for one batch of B lanes, the static state and
the programs over it:

- ``chunk``: one prefill chunk [B, C] with per-lane real counts
  n_valid [B] on the device, so one graph serves every tail and every
  ragged admission grid (rows with 0 are frozen);
- ``decode``: one lock-step decode step (Engine.generate and teacher
  forcing), with its logits, greedy token and top-two margin;
  ``decode_sampled`` draws the token at serve.temperature from the
  threefry key ``key`` [2] instead, advancing it in place (its margin is
  that of the perturbed scores it took the argmax of);
- ``segment``: one step of a masked scheduler segment (per-lane active,
  emission count, max_new, eos and health flags);
- ``mixed`` and ``mixed_first``: one interleaved step (a decode
  sub-step and a chunk sub-step), without and with the first-token
  logits of lanes that finish their prompt (which take their request's
  key from ``gkeys``); the host picks the variant per step from its
  finish grid, where the JAX package's lax.cond picks on the device.

A cross-memory family (vlm, encdec) adds the memory's static buffers
(the packed front-end inputs ``mem`` [B, S, feat] float32, ``mem_len``
[B] and the lanes to install, ``mem_mask`` [B]) and the ``memory``
program: the front end (vision projection or encoder) over ``mem`` and
install_memory into the lanes of ``mem_mask``, in place. Phased
admission and the one-shot programs run it before their first chunk,
an interleaved dispatch before its first mixed step, as the JAX
package installs before its scan (a lane is frozen until its first
chunk, so an earlier install changes nothing it reads).

Speculative decoding (``serve.spec_k`` > 0, greedy only) adds three
more, over the drafter history ``hist`` [B, SPEC_HISTORY] and ids /
emitted buffers widened to W * (spec_k + 1) columns:

- ``spec_segment``: one verify round (transformer.spec_segment_step:
  phase A scores the spec_k + 1 positions over a static scratch cache,
  one per cache shape, phase B replays the accepted ones into the
  static state in place);
- ``spec_mixed`` and ``spec_mixed_first``: one verify round plus one
  chunk sub-step, without and with the first-token logits.

Each of the segment and mixed programs has a sampled twin (the name
with ``_sampled`` appended) that draws per lane at serve.temperature
from the lanes' key chains ``keys`` [B, 2]; the caller picks greedy or
sampled per dispatch, as it does for ``decode``. Sampling is threefry
(core.prng) on key tensors, so a graph captures it like any other
elementwise work and no generator state is involved.

Lane surgery runs outside the graphs, as reset and scrub do: ``extract``
copies chosen lanes' rows, carried tokens and keys to the host (through
one reused pinned staging buffer on the card, one synchronize, then
into ordinary host memory), ``install`` copies host rows (snapshots or
prefix-cache slabs) into chosen lanes, in place, so the captured
programs read the installed rows on their next replay, and ``resume``
installs rows with their tokens and keys. ``admit`` (phased admission)
installs prefix-cache hits before its chunk replays and extracts the
lanes it captures between them. (The JAX package
moves all B lanes, lane-aligned, and installs the chosen ones with a
mask, which keeps its programs shard-local under a mesh; here only the
chosen lanes' rows move.)

Capture rules the programs follow. Nothing in them copies to or from
the host or synchronizes. ``cache_topm_merge`` builds new cache tensors,
so the chunk sub-step copies its result back into the static state:
every tensor a captured kernel reads keeps its address across replays
(the tensor-core chunk kernel bakes its TMA descriptors' addresses in
at capture). All outputs are static buffers allocated outside the
graphs, so the graphs of one engine share one memory pool safely: each
replay writes only scratch of its own and those buffers, and replays
never overlap (one stream).

``kernels.ops.LAUNCHES`` counts the wrappers' Python calls, and a
replay makes none: a captured program records, at capture, the
launches its capture made, takes them back off the counts (a capture
launches nothing), and adds them again on each replay. The warm-up run
is a real step and counts as one.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.blocks import CACHE_LEAVES

# rows of LanePrograms.io, the per-lane carries a dispatch uploads once
# and the segment / mixed programs update in place (the last two: the
# speculative programs' committed tokens and live rounds)
(IO_ACTIVE, IO_EMITTED, IO_MAX_NEW, IO_EOS, IO_OK, IO_STEP, IO_ACC_TOK,
 IO_ACC_ROUNDS) = range(8)


class GraphPool:
    """One memory pool, capture stream and set of counters per engine."""

    def __init__(self, device):
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device=device)
        self.bytes = 0        # reserved for graph captures (the pool)
        self.captures = 0
        self.replays = 0


class StepProgram:
    """A step function over static tensors, run eagerly (pool None) or
    captured on its first run and replayed after (see the module
    docstring)."""

    def __init__(self, name: str, fn, pool: GraphPool | None):
        self.name = name
        self.fn = fn
        self.pool = pool
        self.graph = None
        self.launches = {}

    def run(self):
        if self.pool is None:
            self.fn()
            return
        if self.graph is None:
            self._warm_up_and_capture()
            return
        self.graph.replay()
        self.pool.replays += 1
        for k, n in self.launches.items():
            ops.LAUNCHES[k] += n

    def _warm_up_and_capture(self):
        pool = self.pool
        main = torch.cuda.current_stream(pool.device)
        pool.stream.wait_stream(main)
        with torch.cuda.stream(pool.stream):
            self.fn()                       # the warm-up: a real step
        main.wait_stream(pool.stream)
        before = dict(ops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # a CUDAGraph that the cycle collector frees mid-capture destroys
        # its graph there, which invalidates this capture (a dropped
        # engine's programs form reference cycles): collect first, and
        # not during the capture
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool.handle,
                                  stream=pool.stream):
                reserved = torch.cuda.memory_reserved(pool.device)
                self.fn()
                pool.bytes += (torch.cuda.memory_reserved(pool.device)
                               - reserved)
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: ops.LAUNCHES[k] - before[k] for k in before
                         if ops.LAUNCHES[k] != before[k]}
        ops.LAUNCHES.update(before)
        pool.captures += 1
        self.graph = graph


def host_dtype(dtype: torch.dtype):
    """The numpy dtype a state leaf of ``dtype`` travels to the host as:
    bfloat16 as its int16 bit patterns (numpy has no bfloat16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _to_host(t):
    """A host tensor -> numpy, bfloat16 as int16 bits (shares memory)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_host(a, dtype):
    """numpy (bfloat16 as int16 bits) -> a CPU tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(dtype) if dtype == torch.bfloat16 else t


def host_row_template(cfg, budget: int):
    """One lane's snapshot state with unwritten numpy leaves: the shapes
    and host dtypes extract gives a lane of this config (its spec, for
    serve.store.state_spec)."""
    from repro_torch.models.transformer import init_decode_state
    meta = init_decode_state(cfg, 1, budget, "meta")
    return {"t": np.empty((1,), host_dtype(meta["t"].dtype)),
            "layers": [{k: np.empty(tuple(v.shape), host_dtype(v.dtype))
                        for k, v in st.items()} for st in meta["layers"]]}


def copy_state(dst, src):
    """Copy a decode state's leaves into the static state ``dst``."""
    dst["t"].copy_(src["t"])
    for d, s in zip(dst["layers"], src["layers"]):
        for k, v in d.items():
            if s[k] is not v:
                v.copy_(s[k])


class LanePrograms:
    """The static decode state of B lanes and the step programs over
    it. ``state`` (a decode state of B lanes) is adopted, not copied:
    the programs update it in place. ``steps`` is the longest dispatch
    (default serve.decode_segment). ``pool`` None runs every program
    eagerly: the engine's eager serving path and the model-level loops
    (transformer.decode_segment_loop, mixed_step_loop) drive the same
    programs so."""

    def __init__(self, model, cfg, serve, policy, state,
                 pool: GraphPool | None, steps: int | None = None):
        self.model, self.cfg = model, cfg
        self.serve, self.policy = serve, policy
        self.pool = pool
        self.temperature = serve.temperature
        self.state = state
        self.batch = B = int(state["t"].shape[0])
        dev = self.model.device
        C = self.serve.prefill_chunk
        W = self.serve.decode_segment if steps is None else steps
        # lock-step decode (generate / teacher forcing); logits and
        # margin are also the last step's of a segment or mixed dispatch
        self.tok = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.logits = torch.zeros((B, self.cfg.padded_vocab),
                                  dtype=torch.float32, device=dev)
        self.margin = torch.zeros((B,), dtype=torch.float32, device=dev)
        # threefry keys: the lock-step chain [2], the lanes' chains
        # [B, 2] and the keys lanes finishing their prompt take [B, 2]
        self.key = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.keys = torch.zeros((B, 2), dtype=torch.int64, device=dev)
        self.gkeys = torch.zeros((B, 2), dtype=torch.int64, device=dev)
        # one chunk: tokens, real counts, the carried last hidden state
        self.ctok = torch.zeros((B, C), dtype=torch.int64, device=dev)
        self.cnv = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.h_last = torch.zeros((B, self.cfg.d_model),
                                  dtype=self.model.embed.dtype, device=dev)
        # scheduler segments: per-lane carries, the mixed steps' chunk
        # schedule, and the segment's emissions (spec_k + 1 columns a
        # step under speculative decoding)
        self.spec_k = serve.spec_k
        Cs = self.spec_k + 1
        self.io = torch.zeros((8, B), dtype=torch.int32, device=dev)
        self.grid = torch.zeros((W, B, C), dtype=torch.int64, device=dev)
        self.gnv = torch.zeros((W, B), dtype=torch.int32, device=dev)
        self.gfin = torch.zeros((W, B), dtype=torch.bool, device=dev)
        self.ids = torch.zeros((B, W * Cs), dtype=torch.int64, device=dev)
        self.emitted = torch.zeros((B, W * Cs), dtype=torch.bool,
                                   device=dev)
        # speculative decoding: the drafter history, and one scratch
        # cache per cache shape, which phase A of every layer reuses
        # (made at a speculative program's first run, its warm-up, so it
        # is a static buffer of the captured graph)
        self.hist = torch.full((B, T.SPEC_HISTORY), -1, dtype=torch.int64,
                               device=dev)
        # a cross family's memory: the packed front-end inputs at the
        # state's slab length S, their lengths, the lanes to install
        self.mem_key = T.MEM_KEYS.get(cfg.family)
        self.mem = self.mem_len = self.mem_mask = self.slab_len = None
        if self.mem_key is not None:
            S, feat = T.memory_shape(cfg)
            self.slab_len = S = next((st["xk"].shape[2]
                                      for st in state["layers"]
                                      if "xk" in st), S)
            self.mem = torch.zeros((B, S, feat), dtype=torch.float32,
                                   device=dev)
            self.mem_len = torch.zeros((B,), dtype=torch.int32, device=dev)
            self.mem_mask = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.scratch = None
        self.programs = {}
        self._staging = None      # extract's pinned host rows, made once

    # ------------------------------------------------------------ programs

    def program(self, name: str) -> StepProgram:
        prog = self.programs.get(name)
        if prog is None:
            fn = {"chunk": self._chunk,
                  "memory": self._install_memory,
                  "decode": lambda: self._decode(False),
                  "decode_sampled": lambda: self._decode(True),
                  "segment": lambda: self._segment(False),
                  "segment_sampled": lambda: self._segment(True),
                  "mixed": lambda: self._mixed(False, False),
                  "mixed_sampled": lambda: self._mixed(False, True),
                  "mixed_first": lambda: self._mixed(True, False),
                  "mixed_first_sampled": lambda: self._mixed(True, True),
                  "spec_segment": self._spec_segment,
                  "spec_mixed": lambda: self._spec_mixed(False),
                  "spec_mixed_first": lambda: self._spec_mixed(True),
                  }[name]
            prog = self.programs[name] = StepProgram(name, fn, self.pool)
        return prog

    def _install_memory(self):
        """The memory of the lanes in ``mem_mask``: the front end over the
        static ``mem`` and install_memory, in place."""
        memory, mem_len = T.memory_from_inputs(
            self.model, self.cfg, {self.mem_key: self.mem,
                                   "mem_len": self.mem_len})
        T.install_memory(self.model, self.cfg, self.state, memory, mem_len,
                         lanes_mask=self.mem_mask)

    def _chunk(self):
        new, h = T._prefill_chunk_step(self.model, self.cfg, self.ctok,
                                       self.state, self.policy, self.serve,
                                       n_valid=self.cnv)
        copy_state(self.state, new)
        self.h_last.copy_(torch.where((self.cnv > 0)[:, None], h,
                                      self.h_last))

    def _decode(self, sampled: bool):
        new, logits = T.decode_step(self.model, self.cfg, self.state,
                                    self.tok, self.policy)
        self.state["t"].copy_(new["t"])
        self.logits.copy_(logits)
        tok, key, scores = T.sample_token(logits, self.key,
                                          greedy=not sampled,
                                          temperature=self.temperature)
        self.margin.copy_(T.top2_margin(scores))
        self.tok.copy_(tok)
        if sampled:
            self.key.copy_(key)

    def _carries(self):
        io = self.io
        return (io[IO_ACTIVE] != 0, io[IO_EMITTED], io[IO_MAX_NEW],
                io[IO_EOS], io[IO_OK] != 0, io[IO_STEP, :1].long())

    def _commit(self, cols, emitted_tok, emit, tok, keys, active,
                n_emitted, ok):
        """Write one step's results into the static buffers: its emitted
        tokens [B, k] and flags [B, k] into the columns ``cols`` [k]."""
        io = self.io
        self.ids.index_copy_(1, cols, emitted_tok)
        self.emitted.index_copy_(1, cols, emit)
        self.tok.copy_(tok)
        self.keys.copy_(keys)
        io[IO_ACTIVE].copy_(active)
        io[IO_EMITTED].copy_(n_emitted)
        io[IO_OK].copy_(ok)
        io[IO_STEP, :1].add_(1)

    def _segment(self, sampled: bool):
        active, n_emitted, max_new, eos, ok, j = self._carries()
        tok = self.tok
        new, ntok, keys, n_emitted, done, ok, logits = T.segment_step(
            self.model, self.cfg, self.state, tok, self.keys, active,
            n_emitted, max_new, eos, ok, self.policy, greedy=not sampled,
            temperature=self.temperature)
        self.state["t"].copy_(new["t"])
        self.logits.copy_(logits)
        self._commit(j, tok[:, None], active[:, None], ntok, keys,
                     active & ~done, n_emitted, ok)

    def _mixed(self, finishing: bool, sampled: bool):
        active, n_emitted, max_new, eos, ok, j = self._carries()
        tok = self.tok
        ctoks = self.grid.index_select(0, j)[0]
        nv = self.gnv.index_select(0, j)[0]
        fin = self.gfin.index_select(0, j)[0]
        new, ntok, keys, nactive, n_emitted, ok, emit, logits = T.mixed_step(
            self.model, self.cfg, self.state, tok, self.keys, active,
            n_emitted, max_new, eos, ok, ctoks, nv, fin, self.gkeys,
            self.policy, self.serve, finishing=finishing,
            greedy=not sampled, temperature=self.temperature)
        copy_state(self.state, new)
        self.logits.copy_(logits)
        self._commit(j, tok[:, None], emit[:, None], ntok, keys, nactive,
                     n_emitted, ok)

    def _spec_cols(self, j):
        Cs = self.spec_k + 1
        return j * Cs + torch.arange(Cs, device=j.device)

    def _scratch(self):
        if self.scratch is None:
            self.scratch = {}
            for st in self.state["layers"]:
                key = tuple(st["pos"].shape)
                if key not in self.scratch:
                    self.scratch[key] = {k: torch.empty_like(st[k])
                                         for k in CACHE_LEAVES}
        return self.scratch

    def _spec_segment(self):
        active, n_emitted, max_new, eos, ok, j = self._carries()
        io = self.io
        (new, tok, hist, nactive, n_emitted, ok, acc_tok, acc_rounds, fed,
         emitted) = T.spec_segment_step(
            self.model, self.cfg, self.state, self.tok, self.hist, active,
            n_emitted, max_new, eos, ok, io[IO_ACC_TOK], io[IO_ACC_ROUNDS],
            self.spec_k, self.policy, scratch=self._scratch())
        self.state["t"].copy_(new["t"])
        self.hist.copy_(hist)
        io[IO_ACC_TOK].copy_(acc_tok)
        io[IO_ACC_ROUNDS].copy_(acc_rounds)
        self._commit(self._spec_cols(j), fed, emitted, tok, self.keys,
                     nactive, n_emitted, ok)

    def _spec_mixed(self, finishing: bool):
        active, n_emitted, max_new, eos, ok, j = self._carries()
        io = self.io
        ctoks = self.grid.index_select(0, j)[0]
        nv = self.gnv.index_select(0, j)[0]
        fin = self.gfin.index_select(0, j)[0]
        (new, tok, keys, hist, nactive, n_emitted, ok, acc_tok, acc_rounds,
         fed, emitted) = T.spec_mixed_step(
            self.model, self.cfg, self.state, self.tok, self.keys,
            self.hist, active, n_emitted, max_new, eos, ok, io[IO_ACC_TOK],
            io[IO_ACC_ROUNDS], ctoks, nv, fin, self.gkeys, self.spec_k,
            self.policy, self.serve, finishing=finishing,
            scratch=self._scratch())
        copy_state(self.state, new)
        self.hist.copy_(hist)
        io[IO_ACC_TOK].copy_(acc_tok)
        io[IO_ACC_ROUNDS].copy_(acc_rounds)
        self._commit(self._spec_cols(j), fed, emitted, tok, keys, nactive,
                     n_emitted, ok)

    def release(self):
        """Drop the captured programs (their closures hold this object in
        a reference cycle), so that the state, buffers and graphs are
        freed as soon as the last reference to it goes."""
        self.programs.clear()
        self.scratch = self._staging = None

    # ------------------------------------------------------- lock-step use

    def fresh(self):
        """Reset the static state (and carries) to a fresh state's values,
        as Engine.fresh_state builds them."""
        mask = torch.ones((self.batch,), dtype=torch.bool,
                          device=self.tok.device)
        self.scrub(mask)
        self.tok.zero_()
        self.key.zero_()
        self.keys.zero_()
        self.gkeys.zero_()
        self.io.zero_()
        self.h_last.zero_()
        self.hist.fill_(-1)

    def prefill_chunks(self, chunks, n_valid, capture=None):
        """Run the chunk program over chunks [n, B, C] with real counts
        n_valid [n, B] (numpy): one replay per chunk, from a zero carried
        hidden state. Chunks in which no lane has a token are skipped
        (they change nothing). capture ([B] ints, numpy, or None): the
        prefix cache's boundary snapshots, lane l's rows extracted right
        after its capture[l]-th chunk (0 = none). Returns (the carried
        last hidden state [B, d], a view of the static buffer; {lane:
        its snapshot row, as extract gives it})."""
        prog = self.program("chunk")
        chunks = torch.as_tensor(chunks, device=self.ctok.device)
        nv_dev = torch.as_tensor(n_valid, dtype=torch.int32,
                                 device=self.cnv.device)
        self.h_last.zero_()
        snaps = {}
        for i in range(chunks.shape[0]):
            if n_valid[i].any():
                self.ctok.copy_(chunks[i])
                self.cnv.copy_(nv_dev[i])
                prog.run()
            if capture is not None:
                lanes = [int(l) for l in np.flatnonzero(capture == i + 1)]
                if lanes:
                    snaps.update((lane, row) for lane, (row, _, _) in
                                 zip(lanes, self.extract(lanes)))
        return self.h_last, snaps

    def install_memory(self, mem, mem_len, lane_mask):
        """Upload a cross family's packed front-end inputs (mem
        [B, S, feat], mem_len [B], numpy or tensors) and run the memory
        program: the lanes of lane_mask ([B] bool) take their memory,
        the others keep theirs bit-identically."""
        self.mem.copy_(torch.as_tensor(mem, dtype=torch.float32))
        self.mem_len.copy_(torch.as_tensor(mem_len, dtype=torch.int32))
        self.mem_mask.copy_(torch.as_tensor(lane_mask))
        self.program("memory").run()

    def admit(self, chunks, n_valid, lane_mask, new_keys=None, hits=None,
              capture=None, memory=None):
        """Phased admission: prefill the ragged chunk grid (chunks
        [n, B, C], n_valid [n, B], numpy; lanes not admitted ride as
        all-zero rows and stay frozen) straight into the lanes of
        lane_mask ([B] bool, numpy), which are reset, set their carried
        token to the greedy token of their prompt's last hidden state
        and their key chain to new_keys ([B, 2], numpy; None keeps the
        keys). The JAX package prefills a fresh sub-state and installs
        its rows; into a reset lane that gives the same tokens and slot
        positions (a reset slot's stale K/V bytes are never read).

        Prefix cache: ``hits`` ({lane: slab row}) are installed into
        their lanes first, each slab's clock at its prefix boundary, so
        the grid's rows for those lanes hold only the suffix chunks;
        ``capture`` ([B] ints) takes the lanes' boundary snapshots
        between chunk replays (prefill_chunks). The JAX package's fresh
        rows for the lanes without a hit are the reset lanes here, so
        only the hit lanes' rows move. ``memory`` ((mem, mem_len), a cross
        family's packed inputs) is installed into the admitted lanes
        before the first chunk, inside the admission. Returns the
        captured rows ({lane: row})."""
        if hits:
            self.install(list(hits), list(hits.values()))
        if memory is not None:
            self.install_memory(*memory, lane_mask)
        h_last, snaps = self.prefill_chunks(chunks, n_valid, capture)
        first = torch.argmax(T.compute_logits(self.model, self.cfg, h_last),
                             dim=-1)
        mask = torch.as_tensor(lane_mask, device=self.tok.device)
        self.tok.copy_(torch.where(mask, first, self.tok))
        if new_keys is not None:
            keys = torch.as_tensor(np.asarray(new_keys, np.int64),
                                   device=self.keys.device)
            self.keys.copy_(torch.where(mask[:, None], keys, self.keys))
        return snaps

    def decode(self, tok, sampled: bool = False):
        """One lock-step decode step feeding tok [B] (device). Returns
        (next token: greedy, or sampled from ``key``; the top-two
        margin; logits): views of the static buffers, valid until the
        next step."""
        self.tok.copy_(tok)
        self.program("decode_sampled" if sampled else "decode").run()
        return self.tok, self.margin, self.logits

    # ----------------------------------------------------------- lane ops

    def reset(self, mask):
        """Retire the lanes in mask ([B] bool on the device), in place
        (transformer.reset_lanes)."""
        T.reset_lanes(self.state, mask)

    def scrub(self, mask):
        """reset plus zeroed K/V in the lanes of mask, in place
        (transformer.scrub_lanes)."""
        T.scrub_lanes(self.state, mask)

    def extract(self, lanes):
        """Copy the lanes ``lanes`` (host ints) to the host: their rows of
        every state leaf (transformer.extract_lanes, then one
        device-to-host copy per leaf), carried tokens and keys, then one
        synchronize. On the card the copies land in a pinned staging
        buffer of B lanes, made at the first extract and reused, and
        each lane's rows are then copied out into ordinary host memory,
        so a snapshot the store keeps pins no page-locked memory.
        Returns one (row, tok, key) per lane: row a state of batch 1
        with numpy leaves (bfloat16 as int16 bits), tok an int32 scalar,
        key [2] uint32."""
        pin = self.tok.device.type == "cuda"
        sub = T.extract_lanes(self.state, lanes)
        flat = [sub["t"]] + [v for st in sub["layers"] for v in st.values()]
        flat += [self.tok, self.keys]
        if pin:
            if self._staging is None or any(
                    b.dtype != v.dtype or b.shape[1:] != v.shape[1:]
                    for b, v in zip(self._staging, flat)):
                self._staging = [torch.empty((self.batch, *v.shape[1:]),
                                             dtype=v.dtype, pin_memory=True)
                                 for v in flat]
            host = [buf[:len(v)].copy_(v, non_blocking=True)
                    for buf, v in zip(self._staging, flat)]
            torch.cuda.current_stream(self.tok.device).synchronize()
        else:
            host = flat
        toks, keys = host[-2], host[-1]
        out = []
        for i, lane in enumerate(lanes):
            rows = iter([_to_host(v[i:i + 1]).copy() for v in host[:-2]])
            row = {"t": next(rows),
                   "layers": [{k: next(rows) for k in st}
                              for st in sub["layers"]]}
            out.append((row, np.int32(toks[lane]),
                        keys[lane].numpy().astype(np.uint32)))
        return out

    def install(self, lanes, rows, sync: bool = True):
        """Install host rows into lanes ``lanes`` (host ints): rows[i] (a
        batch-1 state with numpy leaves, as extract gives: a snapshot or
        a prefix-cache slab, its clock included) replaces every leaf's
        row of lanes[i] IN PLACE (transformer.insert_lanes). Carried
        tokens and keys are left alone. With ``sync``, one synchronize at
        the end, so the host buffers may be freed."""
        dev = self.tok.device
        nb = dev.type == "cuda"

        def stack(leaves, dtype):
            return torch.cat([_from_host(a, dtype).to(dev, non_blocking=nb)
                              for a in leaves])

        sub = {"t": stack([r["t"] for r in rows], self.state["t"].dtype),
               "layers": [{k: stack([r["layers"][i][k] for r in rows],
                                    v.dtype) for k, v in st.items()}
                          for i, st in enumerate(self.state["layers"])]}
        T.insert_lanes(self.state, sub, lanes)
        if nb and sync:
            torch.cuda.current_stream(dev).synchronize()

    def resume(self, lanes, rows, toks, keys):
        """Install snapshots into lanes ``lanes`` (host ints): their rows
        (install), and the lanes' carried tokens and keys become toks[i]
        and keys[i] ([2] uint32). One synchronize at the end, so the host
        buffers may be freed."""
        dev = self.tok.device
        self.install(lanes, rows, sync=False)
        idx = torch.as_tensor(lanes, dtype=torch.long, device=dev)
        self.tok.index_copy_(0, idx, torch.as_tensor(
            np.asarray(toks, np.int64), device=dev))
        self.keys.index_copy_(0, idx, torch.as_tensor(
            np.asarray(keys, np.int64).reshape(-1, 2), device=dev))
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    def upload_carries(self, active, n_emitted, max_new, eos, hist=None):
        """Refresh the per-lane carries before a dispatch (one host copy):
        the host's active / n_emitted / max_new / eos, ok all True, the
        step counter and the acceptance counters at 0, and (speculative
        dispatches) the drafter history hist [B, SPEC_HISTORY]."""
        B = self.batch
        host = torch.zeros((8, B), dtype=torch.int32)
        for row, v in ((IO_ACTIVE, active), (IO_EMITTED, n_emitted),
                       (IO_MAX_NEW, max_new), (IO_EOS, eos)):
            host[row] = torch.as_tensor(v).to(torch.int32)
        host[IO_OK] = 1
        self.io.copy_(host)
        if hist is not None:
            self.hist.copy_(torch.as_tensor(np.asarray(hist, np.int64)))

    def results(self, n_steps: int, n_run: int | None = None,
                spec: bool = False):
        """A dispatch's results as new tensors on the device: (tok, keys
        [B, 2], active [B] bool, n_emitted [B], ids [B, n], emitted
        [B, n] bool, ok [B] bool) with n = n_steps, or with ``spec``
        n = n_steps * (spec_k + 1) and (hist, acc_tok [B], acc_rounds
        [B]) appended. Only the first n_run (default n_steps) steps ran;
        the rest read as the identity steps of a masked bucket tail: no
        emission, the final carried token."""
        n_run = n_steps if n_run is None else n_run
        cols = self.spec_k + 1 if spec else 1
        io = self.io
        ids = self.ids[:, :n_steps * cols].clone()
        emitted = self.emitted[:, :n_steps * cols].clone()
        ids[:, n_run * cols:] = self.tok[:, None]
        emitted[:, n_run * cols:] = False
        out = (self.tok.clone(), self.keys.clone(), io[IO_ACTIVE] != 0,
               io[IO_EMITTED].clone(), ids, emitted, io[IO_OK] != 0)
        if spec:
            out += (self.hist.clone(), io[IO_ACC_TOK].clone(),
                    io[IO_ACC_ROUNDS].clone())
        return out

    def download(self, n_steps: int, spec: bool = False):
        """The dispatch's results on the host: (active [B] bool,
        n_emitted [B], ok [B] bool, ids [B, n], emitted [B, n]) as numpy
        arrays (one sync); with ``spec`` (n = n_steps * (spec_k + 1))
        also hist, acc_tok and acc_rounds."""
        out = [x.cpu().numpy() for x in self.results(n_steps, spec=spec)]
        return (out[2], out[3], out[6], out[4], out[5], *out[7:])

    def _variant(self, base: str, greedy: bool, spec: bool) -> str:
        """The program of ``base`` ("segment", "mixed" or "mixed_first")
        that a dispatch runs: its speculative twin with ``spec`` (greedy
        only), else its sampled twin unless ``greedy``, else itself."""
        if spec:
            return "spec_" + base
        return base + ("" if greedy or self.temperature == 0.0
                       else "_sampled")

    def run_segment(self, n_real: int, greedy: bool = True,
                    spec: bool = False):
        """n_real replays of the segment program (see _variant: with
        ``spec`` one verify round a replay); the carries (and, with
        ``spec``, hist) must have been uploaded."""
        prog = self.program(self._variant("segment", greedy, spec))
        for _ in range(n_real):
            prog.run()

    def run_mixed(self, chunks, nv, finish, new_keys=None,
                  greedy: bool = True, spec: bool = False, memory=None):
        """The mixed programs (see _variant) over a schedule of d steps:
        chunks [d, B, C], nv [d, B], finish [d, B] (numpy,
        d <= decode_segment) and the keys of the lanes finishing their
        prompt in it, new_keys [B, 2] (numpy; None: zeros); one replay
        per step, the variant with first-token logits where some lane
        finishes. ``memory`` ((mem, mem_len, install), a cross family's
        packed inputs and the lanes whose first prompt chunk is in this
        schedule, numpy) is installed into those lanes before the first
        step (install_memory)."""
        d = chunks.shape[0]
        if memory is not None and memory[2].any():
            self.install_memory(*memory)
        self.grid[:d].copy_(torch.as_tensor(chunks))
        self.gnv[:d].copy_(torch.as_tensor(nv))
        self.gfin[:d].copy_(torch.as_tensor(finish))
        if new_keys is None:
            self.gkeys.zero_()
        else:
            self.gkeys.copy_(torch.as_tensor(np.asarray(new_keys,
                                                        np.int64)))
        for j in range(d):
            self.program(self._variant(
                "mixed_first" if finish[j].any() else "mixed", greedy,
                spec)).run()
