"""Planted faults against chip_smoke.py's limits for the attention and
capacity-loss kernels: a sound build must stay within every limit, and
each planted fault must exceed one.

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults --lanes

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults --policies

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults --lifecycle

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults --reuse

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults --cross

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults --moe

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults --hybrid

    PYTHONPATH=src python3 -m repro_torch.launch.planted_faults --ssm

Needs one CUDA card and the repository's chip_smoke.py. For the sources
as they are and for each fault in FAULTS (one textual change to a
kernel source), LANE_FAULTS (one to the lane layer; --lanes runs the
sound build and these alone), POLICY_FAULTS (one to the eviction
policies' attention aux; --policies runs the sound build and these
alone), LIFECYCLE_FAULTS (one to the sampling, snapshot, resume or
quarantine path; --lifecycle runs the sound build and these alone) and
REUSE_FAULTS (one to the prefix cache or speculative decoding; --reuse
runs the sound build and these alone) and CROSS_FAULTS (one to the head
dim 64 tensor-core kernels or the cross lanes' reset; --cross runs the
sound build and these alone) and MOE_FAULTS (one to the MoE FFN's
routing or to the lanes under the no-drop MoE stream; --moe runs the
sound build and these alone) and HYBRID_FAULTS (one to the RG-LRU scan
kernel, the head-dim-256 P.V or a recurrent lane's reset; --hybrid runs
the sound build and these alone) and SSM_FAULTS (one to the selective
scan kernel or a mamba lane's reset; --ssm runs the sound build and
these alone) it
copies src/repro_torch and chip_smoke.py into a temporary directory,
applies the change, and runs,
in a fresh process that builds that copy's kernels, the chip_smoke
phases that the fault touches, with every limit lifted. Each bf16 case
gives its row-relative error (chip_smoke.row_errors), each float32 case
its largest |error| / (1 + |value|) against chip_smoke.TOL (the test
chip_smoke's check applies), each capacity case its readings against
chip_smoke.CAP_TOL (the gradient's error relative to its largest entry,
and a second launch's difference, which must be 0; a capacity check
with no limit, such as S_{M-1} == M at the tie, reads inf when it
raises), the bf16 serving parity its logit gap, the stream phase (its
bf16 run at full width and its float32 run at 2 layers) per admission
mode the counts of requests and counters that broke its rules (limit
0; inf when the phase raised), its one-shot margin reading (against
chip_smoke.MARGIN_TOL) and its graphs-against-eager counts and logit
gap, the serve phase its graphs-against-eager counts and logit gap
(against chip_smoke.GRAPH_LOGIT_TOL), the policy phase per policy its
graphs-against-eager counts, logit and aux gaps and its aux counts
(chip_smoke.aux_violations, limit 0), the float32 stream under H2O
and R-KV the stream phase's readings, and the lifecycle phase
(chip_smoke.lifecycle_phase, both dtypes, each through swap, park and
quarantine as well) its counts of requests, leaves and
counters that broke its rules (limit 0; inf when it raised) and its
one-shot margin readings (against chip_smoke.SAMPLED_MARGIN_TOL), and
the reuse phase (chip_smoke.reuse_phase, computing its spec_k 0
baseline itself) its counts (limit 0; inf when it raised), the cross
kernel phase (chip_smoke.cross_kernel_phase) its row-relative and
float32 errors, and the cross lanes (chip_smoke.cross_lanes_float32,
both families) their counts (limit 0; inf when they raised), and
moe_apply against its op-by-op reference (chip_smoke.moe_apply_phase)
its counts (limit 0), and the no-drop granite stream
(chip_smoke.moe_stream) its counts (limit 0) and its one-shot margin
reading (against CROSS_MARGIN_STEPS bf16 steps); the script prints
every reading beside its limit, the largest reading of the sound build
per kind, and exits non-zero unless the sound build stays within every
limit and each fault exceeds at least one.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
CSRC = "src/repro_torch/kernels/csrc"

# name, file, text, replacement, phases read
FAULTS = [
    ("retention: key tile 0 skipped by q tiles from row 1024",
     "retention_attention_tc.cu", "const int t_begin = j_begin / BN;",
     "const int t_begin = j_begin / BN + (r0 >= 1024);", ("retention",)),
    ("retention: key tile 0 skipped by q tiles from row 128",
     "retention_attention_tc.cu", "const int t_begin = j_begin / BN;",
     "const int t_begin = j_begin / BN + (r0 >= 128);",
     ("retention", "parity")),
    ("chunk: cache tile 0 never loaded", "chunk_attention_tc.cu",
     "if (vis[t]) list[n++] = t;", "if (vis[t] && t != 0) list[n++] = t;",
     ("chunk", "parity")),
    ("chunk: probs written as 0", "chunk_attention_tc.cu",
     "if (key < M) rows[r][key] = p[4 * j + 2 * r + e];",
     "if (key < M) rows[r][key] = 0.f;", ("chunk",)),
    ("chunk: probs not rescaled by exp2(m_tile - m_final)",
     "chunk_attention_tc.cu",
     "const float sc = fast_exp2(mrow[r][t] - st.m[r]) * inv;",
     "const float sc = inv;", ("chunk",)),
    ("both: O not rescaled across key tiles", "hopper_flash.cuh",
     "for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];",
     "for (int i = 0; i < D / 2; ++i) o[i] *= 1.f;", ("chunk", "retention")),
    ("decode: split 1's partial left out of the combine",
     "decode_attention.cu",
     "      if (s < n_split) x = fmaf(sm.wgt[s * G + g], part[s], x);",
     "      if (s < n_split && s != 1) x = fmaf(sm.wgt[s * G + g], part[s], "
     "x);", ("decode",)),
    ("decode: split 0 not rescaled by exp(m_s - m)", "decode_attention.cu",
     "      const float w = ls[s] > 0.f ? expf(ms[s] - m) : 0.f;",
     "      const float w = ls[s] > 0.f ? (s == 0 ? 1.f : expf(ms[s] - m)) "
     ": 0.f;", ("decode",)),
    ("chunk f32: the last chunk-key tile skipped", "chunk_attention.cu",
     "if (s_flag[t] & VISIBLE) s_list[n++] = t;",
     "if ((s_flag[t] & VISIBLE) && t != n_tiles - 1) s_list[n++] = t;",
     ("chunk",)),
    ("chunk f32: no per-element mask on a partly visible cache tile",
     "chunk_attention.cu", "const bool edge = !(s_flag[t] & WHOLE);",
     "const bool edge = !(s_flag[t] & WHOLE) && t >= n_mt;", ("chunk",)),
    ("capacity bwd: the carry of the block after the diagonal left out",
     "capacity_loss.cu",
     "acc = fmaf(exp2f(d0 * lb2), fmaf(d0, a, bq), acc);",
     "acc = fmaf(rb == wt + 1 ? 1.f : exp2f(d0 * lb2), fmaf(d0, a, bq), "
     "acc);", ("capacity",)),
    ("capacity bwd: group 1's partial dropped from the reduction",
     "capacity_loss.cu",
     "for (int q = 0; q < n_groups; ++q) x += part_s[q][half][c];",
     "for (int q = 0; q < n_groups; ++q) x += q == 1 ? 0.f : "
     "part_s[q][half][c];", ("capacity",)),
    ("capacity fwd: tile 1's partial left out of the fixed-order sum",
     "capacity_loss.cu",
     "for (int ii = v; ii <= last; ii += SUM_WARPS) s += p[(long)ii * Tp];",
     "for (int ii = v; ii <= last; ii += SUM_WARPS) s += ii == 1 ? 0.f : "
     "p[(long)ii * Tp];", ("capacity",)),
    ("capacity fwd: the carry of the block after the diagonal left out",
     "capacity_loss.cu",
     "cv = exp2f((float)(rbq * K - i) * lv[k]);",
     "cv = rbq == iq / K + w + 1 ? 1.f : "
     "exp2f((float)(rbq * K - i) * lv[k]);", ("capacity",)),
    ("capacity fwd: the diagonal blocks' sums not added", "capacity_loss.cu",
     "if (m == 0) x[e] += D[(h * RB + rr) * K + 4 * tx + e];",
     "if (m < 0) x[e] += D[(h * RB + rr) * K + 4 * tx + e];",
     ("capacity",)),
]
# faults in the lane layer and the step programs (file under
# src/repro_torch), caught by the stream phase (chip_smoke.stream_phase,
# bf16 at full width and float32 at 2 layers) or the serve phase's
# graphs against eager: python3 -m repro_torch.launch.planted_faults
# --lanes runs the sound build and these alone
LANE_FAULTS = [
    ("lanes: an inactive lane not frozen (the active mask dropped from "
     "cache_insert)", "core/cache.py",
     "        write = write & active[:, None]\n", "        write = write\n",
     ("stream",)),
    ("lanes: the graph's carry buffer not refreshed before a dispatch's "
     "replays", "serve/graphs.py", "        self.io.copy_(host)\n",
     "        del host\n", ("stream",)),
    ("graphs: the chunk program's copy-back leaves beta out",
     "serve/graphs.py", "            if s[k] is not v:\n",
     "            if s[k] is not v and k != \"beta\":\n", ("serve",)),
    # graph-only: the eager program reads the new tensor, the captured
    # one the buffer it was captured with (kept alive, so it reads the
    # first chunk's counts on every replay)
    ("graphs: the chunk program's n_valid buffer replaced, not refreshed",
     "serve/graphs.py", "                self.cnv.copy_(nv_dev[i])\n",
     "                self.__dict__.setdefault(\"_held\", []).append("
     "self.cnv)\n"
     "                self.cnv = nv_dev[i].clone()\n", ("serve", "stream")),
]
# faults in the policies' attention aux (file under src/repro_torch),
# caught by the policy phase (chip_smoke.policy_phase; the dense block
# refuses an aux that is not written in place) or the float32 stream
# under H2O and R-KV ("stream-policies"): --policies runs the sound
# build and these alone
POLICY_FAULTS = [
    ("policies: H2O's decode_update ignores active (an inactive lane's "
     "aux grows)", "core/policies.py",
     "        return _accumulate(cache, probs_kv, active)\n\n\n"
     "@dataclasses.dataclass(frozen=True)\nclass SnapKV",
     "        return _accumulate(cache, probs_kv, None)\n\n\n"
     "@dataclasses.dataclass(frozen=True)\nclass SnapKV",
     ("stream-policies",)),
    ("blocks: incoming_aux dropped (p_new unused)", "models/blocks.py",
     "incoming_score=inc, incoming_aux=aux_new,",
     "incoming_score=inc, incoming_aux=None,", ("policy",)),
    ("policies: decode_update rebinds aux instead of writing it in place",
     "core/policies.py",
     "    cache[\"aux\"].add_(_lane_probs(probs_kv, active))\n",
     "    cache[\"aux\"] = cache[\"aux\"] + _lane_probs(probs_kv, active)\n",
     ("policy",)),
]
# faults in the sampling, snapshot, resume and quarantine path (file
# under src/repro_torch), caught by the lifecycle phase
# (chip_smoke.lifecycle_phase), run here in float32 and in bfloat16,
# each dtype through swap, park and quarantine, so that the bfloat16
# limit has readings on both sides: --lifecycle runs the sound build
# and these alone
LIFECYCLE_FAULTS = [
    # graph-only: the eager programs read the new tensors, the captured
    # ones the buffers they were captured with (kept alive)
    ("lifecycle: insert_lanes (the resume's install) rebinds the state's "
     "leaves instead of writing them in place", "models/transformer.py",
     "            v.index_copy_(0, idx, sub[k])\n",
     "            globals().setdefault(\"_HELD\", []).append(v)\n"
     "            st[k] = v.index_copy(0, idx, sub[k])\n", ("lifecycle",)),
    ("lifecycle: resume drops the lane's key (a sampled stream goes on "
     "from a stale key)", "serve/graphs.py",
     "        self.keys.index_copy_(0, idx, torch.as_tensor(\n"
     "            np.asarray(keys, np.int64).reshape(-1, 2), device=dev))\n",
     "", ("lifecycle",)),
    ("lifecycle: verify_snapshot always passes (a flipped bit revives)",
     "serve/store.py",
     "    return crc == snap.crc and meta_crc == snap.meta_crc",
     "    return True", ("lifecycle",)),
    ("lifecycle: quarantine resets the lane without zeroing its K/V",
     "serve/scheduler.py",
     "        self.lanes.scrub(torch.as_tensor(mask, "
     "device=self.lanes.tok.device))",
     "        self.lanes.reset(torch.as_tensor(mask, "
     "device=self.lanes.tok.device))", ("lifecycle",)),
    ("lifecycle: lanes draw over [B, Vp] from lane 0's key (the one-shot "
     "layout) instead of each from its own", "models/transformer.py",
     "    return prng.categorical_rows(sub, logits / temperature), new_keys",
     "    return prng.categorical(sub[0], logits / temperature), new_keys",
     ("lifecycle",)),
]
# faults in the prefix cache and speculative decoding (file under
# src/repro_torch), caught by the reuse phase (chip_smoke.reuse_phase):
# --reuse runs the sound build and these alone
REUSE_FAULTS = [
    ("reuse: phase A of a verify round writes the durable cache (no "
     "scratch copy)", "models/blocks.py",
     "    if scratch is None:\n"
     "        scratch = {k: state[k].clone() for k in scratch_leaves(state)}\n"
     "    else:\n"
     "        for k in scratch_leaves(state):\n"
     "            scratch[k].copy_(state[k])\n"
     "    scratch = {**scratch, **_memory(state)}\n",
     "    scratch = state\n", ("reuse",)),
    ("reuse: cache_replay commits one position too many",
     "core/cache.py", "        mask = live & (j < n_commit)\n",
     "        mask = live & (j <= n_commit)\n", ("reuse",)),
    ("reuse: a hit installs its slab without its clock",
     "serve/graphs.py",
     "        sub = {\"t\": stack([r[\"t\"] for r in rows], "
     "self.state[\"t\"].dtype),",
     "        sub = {\"t\": stack([r[\"t\"] * 0 for r in rows], "
     "self.state[\"t\"].dtype),", ("reuse",)),
    ("reuse: the capture is taken one chunk late", "serve/scheduler.py",
     "                    caps[i] = (cap_tokens // C - d1, key)",
     "                    caps[i] = (cap_tokens // C - d1 + 1, key)",
     ("reuse",)),
]
# faults in the cross-memory families' paths: the D-64 tensor-core
# kernels (read by chip_smoke.cross_kernel_phase) and the lane reset
# (read by chip_smoke.cross_lanes_float32); --cross runs the sound build
# and these alone
CROSS_FAULTS = [
    ("cross: the D-64 kernels rescale only half the head dim of the P.V "
     "accumulator", "hopper_flash.cuh",
     "for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];",
     "for (int i = 0; i < (D == 64 ? D / 4 : D / 2); ++i) "
     "o[i] *= alpha[(i >> 1) & 1];", ("cross-kernels",)),
    ("cross: a reset leaves mem_len unchanged (the next occupant reads "
     "the old memory)", "core/cache.py",
     "\"conv\": 0.0, \"mem_len\": 0}", "\"conv\": 0.0}", ("cross",)),
]
# faults in the MoE FFN's routing (models/blocks.py, read by
# chip_smoke.moe_apply_phase: moe_apply against the JAX package's
# op-by-op form on the card) and two lane faults read by the no-drop
# granite stream ("moe-stream": chip_smoke.moe_stream(no_drop=True),
# its ids against one-shot runs under CROSS_MARGIN_STEPS); --moe runs
# the sound build and these alone
MOE_FAULTS = [
    ("moe: the top-k probabilities are not renormalised", "models/blocks.py",
     "    return probs, top_idx, top_vals / top_vals.sum(dim=-1, "
     "keepdim=True)", "    return probs, top_idx, top_vals", ("moe",)),
    ("moe: one cumsum over each token's k choices in token order (not "
     "column by column)", "models/blocks.py",
     "    cols = top_idx.reshape(n_groups, g, k).transpose(1, 2)   # [n,k,g]"
     "\n    cols = cols.reshape(n_groups, 1, k * g)\n"
     "    experts = torch.arange(E, device=top_idx.device)[None, :, None]\n"
     "    pos = torch.cumsum(cols == experts, dim=-1, dtype=torch.int32) - 1"
     "\n    pos = pos.gather(1, cols)[:, 0]                           # "
     "[n,k*g]\n    return pos.reshape(n_groups, k, g).transpose(1, 2)"
     ".reshape(S, k)",
     "    cols = top_idx.reshape(n_groups, 1, g * k)\n"
     "    experts = torch.arange(E, device=top_idx.device)[None, :, None]\n"
     "    pos = torch.cumsum(cols == experts, dim=-1, dtype=torch.int32) - 1"
     "\n    pos = pos.gather(1, cols)[:, 0]\n    return pos.reshape(S, k)",
     ("moe",)),
    ("moe lanes: an inactive lane not frozen (the active mask dropped "
     "from cache_insert)", "core/cache.py",
     "        write = write & active[:, None]\n", "        write = write\n",
     ("moe-stream",)),
    ("moe lanes: the chunk program's n_valid buffer replaced, not "
     "refreshed", "serve/graphs.py",
     "                self.cnv.copy_(nv_dev[i])\n",
     "                self.__dict__.setdefault(\"_held\", []).append("
     "self.cnv)\n"
     "                self.cnv = nv_dev[i].clone()\n", ("moe-stream",)),
]
# faults in the hybrid family's paths: the RG-LRU scan kernel's start
# and its carry between chunks (read by chip_smoke.scan_kernel_phase),
# the head-dim-256 tensor-core P.V (read by the rest of
# chip_smoke.hybrid_kernel_phase),
# and the lane reset of a recurrent state (read by the bf16 hybrid
# stream's one-shot margin); --hybrid runs the sound build and these
HYBRID_FAULTS = [
    ("hybrid: the scan kernel starts every lane from h = 0, not h0",
     "rg_lru_scan.cu", "  float h = live ? h0[(long)blockIdx.y * W + w] : 0.f;",
     "  float h = live ? 0.f * h0[(long)blockIdx.y * W + w] : 0.f;",
     ("hybrid-kernels",)),
    ("hybrid: the scan kernel gives each chunk the carry after its own "
     "map, not before it (the carry between chunks one chunk late)",
     "rg_lru_scan.cu",
     "    if (k == s) cin = h;\n    h = __fmaf_rn(agg_a[k][c], h, "
     "agg_b[k][c]);",
     "    h = __fmaf_rn(agg_a[k][c], h, agg_b[k][c]);\n"
     "    if (k == s) cin = h;", ("hybrid-kernels",)),
    ("hybrid: the D-256 P.V reads V's columns 0-127 into both halves of O",
     "hopper_flash.cuh",
     "wgmma_rs(hi, pa[kk], desc_mnmajor(v_s + 2 * box + kk * 16 * 128, "
     "box));",
     "wgmma_rs(hi, pa[kk], desc_mnmajor(v_s + kk * 16 * 128, box));",
     ("hybrid-kernels",)),
    ("hybrid: a lane reset leaves a recurrent layer's h and conv (the next "
     "request starts from the last one's recurrence)", "core/cache.py",
     "\"aux\": 0.0, \"h\": 0.0,\n                    \"conv\": 0.0, ",
     "\"aux\": 0.0,\n                    ", ("hybrid-stream",)),
]
# faults in the ssm family's paths: the selective scan kernel's start and
# its padded steps (read by chip_smoke.ssm_kernel_phase), and the lane
# reset of a mamba state (read by the bf16 ssm stream); --ssm runs the
# sound build and these
SSM_FAULTS = [
    ("ssm: the selective scan kernel starts every lane from h = 0, not h0",
     "selective_scan.cu", "    h[s] = live ? __ldg(h0 + st + s) : 0.f;",
     "    h[s] = live ? 0.f * __ldg(h0 + st + s) : 0.f;", ("ssm-kernels",)),
    ("ssm: the selective scan kernel's padded steps (past n_valid) update "
     "h as real ones", "selective_scan.cu",
     "    h[s] = valid ? hn : h[s];", "    h[s] = hn;", ("ssm-kernels",)),
    ("ssm: a lane reset leaves a mamba layer's h (the next request starts "
     "from the last one's state)", "core/cache.py",
     "\"aux\": 0.0, \"h\": 0.0,", "\"aux\": 0.0,", ("ssm-stream",)),
]
SOUND = ("decode", "chunk", "retention", "capacity", "parity", "stream",
         "serve", "policy", "stream-policies", "lifecycle", "reuse",
         "cross-kernels", "cross", "moe", "moe-stream", "hybrid-kernels",
         "hybrid-stream", "ssm-kernels", "ssm-stream")


def child(phases):
    """Run chip_smoke's phases with the limits lifted; print the
    readings as JSON on the last line."""
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from repro_torch.kernels import build

    build.library()
    readings = []

    def record(name, got, want, kinds=("out", "probs")):
        errs = []
        for g, w, kind in zip(got, want, kinds):
            a, r = cs.row_errors(g, w)
            readings.append({"case": name, "kind": kind, "reading": r,
                             "limit": cs.ROW_TOL[kind]})
            errs.append(a)
        return max(errs)

    def record_f32(name, got, want, dtype):
        worst = 0.0
        for g_, w in zip(got, want):
            g_, w = g_.float(), w.float()
            worst = max(worst, ((g_ - w).abs() / (1 + w.abs())).max().item()
                        if torch.isfinite(g_).all() else math.inf)
        readings.append({"case": name, "kind": "float32", "reading": worst,
                         "limit": cs.TOL[dtype]})
        return worst

    def record_capacity(name, errs):
        for kind, limit in cs.CAP_TOL.items():
            readings.append({"case": f"capacity {name}", "kind": kind,
                             "reading": errs[kind], "limit": limit})

    def record_graphs(name, found):
        for kind, n in found.items():
            readings.append({
                "case": f"{name} graphs vs eager", "kind": kind,
                "reading": float(n), "limit":
                    cs.GRAPH_LOGIT_TOL if kind.endswith("gap") else 0.0})

    def record_aux(name, violations):
        for kind, n in violations.items():
            readings.append({"case": name, "kind": kind,
                             "reading": float(n), "limit": 0.0})

    cs.check_rows = record
    cs.check = record_f32
    cs.check_capacity = record_capacity
    cs.check_graphs = record_graphs
    cs.check_aux = record_aux
    g = torch.Generator(device="cuda")
    with torch.no_grad():
        for name in ("decode", "chunk", "retention"):
            if name in phases:
                g.manual_seed(0)      # the same inputs in every run
                getattr(cs, f"{name}_phase")(g)
                torch.cuda.empty_cache()
    if "capacity" in phases:          # autograd runs in it
        g.manual_seed(0)
        try:
            cs.capacity_phase(g)
        except AssertionError as e:   # a check with no limit to lift
            print(f"capacity: {e}")
            readings.append({"case": "capacity phase", "kind": "raised",
                             "reading": math.inf, "limit": 0.0})
    if "serve" in phases or "policy" in phases:
        with torch.no_grad():
            cfg, model = cs.full_width_model()
            if "serve" in phases:
                cs.serve_phase(cfg, model)
            if "policy" in phases:
                try:
                    cs.policy_phase(cfg, model)
                # a check with no limit, a fault the block refuses, or
                # one that breaks a later replay (its readings so far
                # are kept)
                except (AssertionError, RuntimeError) as e:
                    print(f"policy: {str(e).splitlines()[0]}")
                    readings.append({"case": "policy phase",
                                     "kind": "raised", "reading": math.inf,
                                     "limit": 0.0})
                    if not isinstance(e, AssertionError):
                        # the card's context may be lost: report what
                        # was read, and skip the teardown that would
                        # touch it
                        print(json.dumps(readings), flush=True)
                        os._exit(0)
            del model
        torch.cuda.empty_cache()
    if "stream" in phases or "stream-policies" in phases:
        def record_stream(name, violations, margin=0.0, tol=math.inf):
            for kind, n in violations.items():
                readings.append({"case": f"stream {name}", "kind": kind,
                                 "reading": float(n), "limit": 0.0})
            if tol < math.inf:
                readings.append({"case": f"stream {name}", "kind": "margin",
                                 "reading": margin, "limit": tol})

        cs.check_stream = record_stream
        runs = ((("bfloat16",), ("float32", 2, 6)) if "stream" in phases
                else ())
        if "stream-policies" in phases:
            runs += (("float32", 2, 6, "h2o"), ("float32", 2, 6, "rkv"))
        for args in runs:
            try:
                with torch.no_grad():
                    cs.stream_phase(*args)
            except (AssertionError, RuntimeError, NotImplementedError) as e:
                print(f"stream {args}: {e}")
                readings.append({"case": f"stream {args} phase",
                                 "kind": "raised", "reading": math.inf,
                                 "limit": 0.0})
            torch.cuda.empty_cache()
    if "lifecycle" in phases:
        def record_lifecycle(name, violations, margin=0.0, tol=math.inf):
            for kind, n in violations.items():
                readings.append({"case": f"lifecycle {name}", "kind": kind,
                                 "reading": float(n), "limit": 0.0})
            if tol < math.inf:
                readings.append({"case": f"lifecycle {name}",
                                 "kind": "margin", "reading": margin,
                                 "limit": tol})

        cs.check_lifecycle = record_lifecycle
        try:
            with torch.no_grad():
                cs.lifecycle_phase(("float32", "bfloat16"),
                                   paths=("float32", "bfloat16"))
        except (AssertionError, RuntimeError, ValueError) as e:
            print(f"lifecycle: {str(e).splitlines()[0]}")
            readings.append({"case": "lifecycle phase", "kind": "raised",
                             "reading": math.inf, "limit": 0.0})
            if isinstance(e, RuntimeError):
                print(json.dumps(readings), flush=True)
                os._exit(0)
        torch.cuda.empty_cache()
    if "reuse" in phases:
        def record_reuse(name, violations):
            for kind, n in violations.items():
                readings.append({"case": f"reuse {name}", "kind": kind,
                                 "reading": float(n), "limit": 0.0})

        cs.check_reuse = record_reuse
        try:
            with torch.no_grad():
                cs.reuse_phase(None)
        except (AssertionError, RuntimeError, ValueError, KeyError,
                IndexError) as e:
            print(f"reuse: {str(e).splitlines()[0]}")
            readings.append({"case": "reuse phase", "kind": "raised",
                             "reading": math.inf, "limit": 0.0})
            if isinstance(e, RuntimeError):
                print(json.dumps(readings), flush=True)
                os._exit(0)
        torch.cuda.empty_cache()
    if "cross-kernels" in phases:
        g.manual_seed(0)
        with torch.no_grad():
            cs.cross_kernel_phase(g)
        torch.cuda.empty_cache()
    if "cross" in phases:
        def record_cross(name, violations):
            for kind, n in violations.items():
                readings.append({"case": f"cross {name}", "kind": kind,
                                 "reading": float(n), "limit": 0.0})

        cs.check_cross = record_cross
        for arch in ("seamless-m4t-large-v2", "llama-3.2-vision-90b"):
            try:
                with torch.no_grad():
                    cs.cross_lanes_float32(*cs.cross_float32_model(arch))
            except (AssertionError, RuntimeError) as e:
                print(f"cross: {str(e).splitlines()[0]}")
                readings.append({"case": f"cross {arch}", "kind": "raised",
                                 "reading": math.inf, "limit": 0.0})
            torch.cuda.empty_cache()
    if "moe" in phases:
        def record_moe(name, violations):
            for kind, n in violations.items():
                readings.append({"case": f"moe {name}", "kind": kind,
                                 "reading": float(n), "limit": 0.0})

        cs.check_moe = record_moe
        cs.moe_apply_phase()
        torch.cuda.empty_cache()
    if "moe-stream" in phases:
        def record_moe_stream(name, violations, margin=0.0, tol=math.inf):
            for kind, n in violations.items():
                readings.append({"case": f"stream {name}", "kind": kind,
                                 "reading": float(n), "limit": 0.0})
            readings.append({"case": f"stream {name}", "kind": "margin",
                             "reading": margin, "limit": tol})

        cs.check_stream = record_moe_stream
        try:
            with torch.no_grad():
                cfg, model = cs.moe_model("granite-moe-3b-a800m")
                cs.moe_stream(cfg, model, modes=("phased",), no_drop=True)
        except (AssertionError, RuntimeError) as e:
            print(f"stream moe: {str(e).splitlines()[0]}")
            readings.append({"case": "stream moe phase", "kind": "raised",
                             "reading": math.inf, "limit": 0.0})
            if not isinstance(e, AssertionError):
                # the card's context may be lost: report what was read
                print(json.dumps(readings), flush=True)
                os._exit(0)
        torch.cuda.empty_cache()
    if "hybrid-kernels" in phases:
        g.manual_seed(0)
        try:
            with torch.no_grad():
                cs.hybrid_kernel_phase(g)
        except AssertionError as e:   # a padded scan step that moved h,
            # or two launches that differ
            print(f"hybrid kernels: {str(e).splitlines()[0]}")
            readings.append({"case": "hybrid kernel phase", "kind": "raised",
                             "reading": math.inf, "limit": 0.0})
        torch.cuda.empty_cache()
    if "hybrid-stream" in phases:
        def record_hybrid_stream(name, violations, margin=0.0,
                                 tol=math.inf):
            for kind, n in violations.items():
                readings.append({"case": f"stream {name}", "kind": kind,
                                 "reading": float(n), "limit": 0.0})
            readings.append({"case": f"stream {name}", "kind": "margin",
                             "reading": margin, "limit": tol})

        cs.check_stream = record_hybrid_stream
        cs.check_hybrid = lambda name, violations: record_aux(
            f"hybrid {name}", violations)
        try:
            with torch.no_grad():
                cs.hybrid_stream(*cs.hybrid_model())
        except (AssertionError, RuntimeError) as e:
            print(f"stream hybrid: {str(e).splitlines()[0]}")
            readings.append({"case": "stream hybrid phase", "kind": "raised",
                             "reading": math.inf, "limit": 0.0})
            if not isinstance(e, AssertionError):
                print(json.dumps(readings), flush=True)
                os._exit(0)
        torch.cuda.empty_cache()
    if "ssm-kernels" in phases:
        cs.check_ssm = lambda name, violations: record_aux(
            f"ssm {name}", violations)
        g.manual_seed(0)
        with torch.no_grad():
            cs.ssm_kernel_phase(g)
        torch.cuda.empty_cache()
    if "ssm-stream" in phases:
        def record_ssm_stream(name, violations, margin=0.0, tol=math.inf):
            for kind, n in violations.items():
                readings.append({"case": f"stream {name}", "kind": kind,
                                 "reading": float(n), "limit": 0.0})
            readings.append({"case": f"stream {name}", "kind": "margin",
                             "reading": margin, "limit": tol})

        cs.check_stream = record_ssm_stream
        cs.check_ssm = lambda name, violations: record_aux(
            f"ssm {name}", violations)
        try:
            with torch.no_grad():
                cfg, model = cs.ssm_model()
                cs.hybrid_stream(cfg, model, label="ssm",
                                 prompt_hi=cs.SSM_SHAPE["P"], new_hi=64,
                                 check=cs.check_ssm)
        except (AssertionError, RuntimeError) as e:
            print(f"stream ssm: {str(e).splitlines()[0]}")
            readings.append({"case": "stream ssm phase", "kind": "raised",
                             "reading": math.inf, "limit": 0.0})
            if not isinstance(e, AssertionError):
                print(json.dumps(readings), flush=True)
                os._exit(0)
        torch.cuda.empty_cache()
    if "parity" in phases:
        limit, cs.BF16_LOGIT_TOL = cs.BF16_LOGIT_TOL, math.inf
        try:
            _, par = cs.parity_phase("bfloat16")
            gaps = {m: r["kernels vs cpu"] for m, r in par.items()}
        except AssertionError as e:     # non-finite logits
            print(f"parity bfloat16: {e}")
            gaps = {"run": math.inf}
        for mode, gap in gaps.items():
            readings.append({"case": f"parity bfloat16 {mode}",
                             "kind": "logits", "reading": gap,
                             "limit": limit})
    print(json.dumps(readings), flush=True)


def run(fault, phases):
    """Readings of one build: the sources as they are (fault None) or
    with one fault planted."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shutil.copytree(ROOT / "src" / "repro_torch",
                        tmp / "src" / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        if fault is not None:
            _, name, text, new, _ = fault
            src = (tmp / "src" / "repro_torch" / name if "/" in name
                   else tmp / CSRC / name)
            body = src.read_text()
            if body.count(text) != 1:
                raise RuntimeError(f"{name}: the text to change is not "
                                   f"there exactly once: {text!r}")
            src.write_text(body.replace(text, new))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.planted_faults",
             "--child", ",".join(phases)], cwd=tmp, capture_output=True,
            text=True, timeout=1500,
            env={**os.environ, "PYTHONPATH": str(tmp / "src")})
    if proc.returncode != 0:
        raise RuntimeError(f"run failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]), [x for x in lines if x.startswith(
        ("parity", "capacity:", "stream", "serve", "policy", "Table",
         "lifecycle", "reuse", "cross", "  moe_apply", "moe stream",
         "  one-shot comparison", "ssm"))]


def main(only: str | None = None) -> int:
    """only: None (every fault), "--lanes", "--policies", "--lifecycle",
    "--reuse", "--cross", "--moe", "--hybrid" or "--ssm"."""
    ok = True
    faults, sound = {
        None: (FAULTS + LANE_FAULTS + POLICY_FAULTS + LIFECYCLE_FAULTS
               + REUSE_FAULTS + CROSS_FAULTS + MOE_FAULTS + HYBRID_FAULTS
               + SSM_FAULTS, SOUND),
        "--lanes": (LANE_FAULTS, ("stream", "serve")),
        "--policies": (POLICY_FAULTS, ("policy", "stream-policies")),
        "--lifecycle": (LIFECYCLE_FAULTS, ("lifecycle",)),
        "--reuse": (REUSE_FAULTS, ("reuse",)),
        "--cross": (CROSS_FAULTS, ("cross-kernels", "cross")),
        "--moe": (MOE_FAULTS, ("moe", "moe-stream")),
        "--hybrid": (HYBRID_FAULTS, ("hybrid-kernels", "hybrid-stream")),
        "--ssm": (SSM_FAULTS, ("ssm-kernels", "ssm-stream")),
    }[only]
    for fault in [None, *faults]:
        title = "sound build" if fault is None else f"fault: {fault[0]}"
        readings, parity = run(fault, sound if fault is None else fault[4])
        over = [r for r in readings if not r["reading"] <= r["limit"]]
        print(f"{title}: {len(over)} of {len(readings)} readings beyond "
              f"their limit", flush=True)
        for line in parity:
            print("  " + line)
        for r in readings:
            flag = "  BEYOND" if r in over else ""
            print(f"  {r['case']:<60} {r['kind']:<6} {r['reading']:.3e} "
                  f"(limit {r['limit']:g}){flag}", flush=True)
        if fault is None:
            for kind in sorted({r["kind"] for r in readings}):
                worst = max(r["reading"] for r in readings
                            if r["kind"] == kind)
                print(f"  largest sound reading, {kind}: {worst:.3e}")
            ok &= not over
        else:
            ok &= bool(over)
    print("planted faults: " + ("every fault caught, the sound build within"
                                " every limit" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2].split(","))
    else:
        sys.exit(main(sys.argv[1] if sys.argv[1:] else None))
