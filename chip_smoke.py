#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # every phase; needs one CUDA card

Phases (any failure exits non-zero):

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit (``nvidia-smi``);
2. build: every kernel in ``src/repro_torch/kernels/csrc`` compiled with
   nvcc for sm_90a;
3. kernels against their plain PyTorch versions, on the card, at the
   full-width llama3.2-1b shapes of the main path (RSA GEMM in all three
   residency modes, paged decode and paged prefill attention, and the two
   cascade-decode phases: decode-lse and shared-prefix) plus ragged and
   f32 cases; each maximum error is held to a stated tolerance.  WS and IS
   are one function run by one kernel (``csrc/rsa_psum.cu``), and OS runs
   on it as a single chunk: at every GEMM shape of phases 3, 6, 7 and 8
   the WS and IS outputs must be bitwise equal, and a second run (WS, and
   OS) bitwise equal to the first (one line per shape; the rest of phase
   8's prefill shapes are counted in one line).  The split-KV decode kernel
   also runs three timed bf16 cases through decode and decode-lse (lengths
   across split boundaries, a lane ending inside the first split, one lane
   of 8192 rows), each line with its plan (splits, CTAs).  Prefill and
   the shared-prefix phase run one tensor-core kernel: each line prints
   its split-KV plan (splits, CTAs, width), the timed prefill line
   SDPA over K/V gathered beforehand with the causal-offset mask as a
   yardstick, and both kernels also run one untimed bf16 case at hd 128;
   the kernel, plain-version and (where one exists) library-call times are
   device times between CUDA events, L2 flushed before every run, with a
   spin kernel holding the card until the host has queued the whole run;
4. the main path: ``serve_continuous`` serving llama3.2-1b at full width
   (16 layers, d=2048, bf16, random weights from a seed) with continuous
   batching, chunked paged prefill and paged decode; every request must
   finish, the KV pool must end leak-free, every kernel must have launched
   and no plain version may have run.  The logits of one chunk-prefill step
   and one decode step are held against the same steps under
   ``execute="torch"`` (the plain versions);
5. the cascade path: the same model served with the prefix cache and
   cascade decode (``prefix_cache=True, shared_prefix_decode=True``) on 24
   requests that open with one 384-token system prompt.  The first is
   served alone, so its pages are in the trie, then the other 23 arrive
   together; each of them must hit, some decode steps must run the two
   cascade kernels (16 launches each per step), no plain version may run,
   the pool must audit clean with the trie's pins and be whole after the
   trie is cleared, and the logits of one cascade decode step are held
   against the same step under ``execute="torch"``;
6. the deepseek-v3 path: ``deepseek-v3-671b`` at its published widths
   (d=7168, 128 heads, absorbed MLA with kv_lora_rank 512, 256 routed
   experts top-8 plus one shared, vocab 129280, bf16, random weights from
   seed 0), depth cut to one dense layer and one MoE layer, served with
   continuous batching, chunked paged prefill and paged decode; every
   request must finish leak-free, the MLA kernels must launch once per
   layer per model step, every GEMM site but the f32 router (pinned to the
   plain product, as in the reference) must run on the RSA kernel with
   every expert and head bank as one launch, and no plain version may
   run.  The logits of one chunk-prefill step and one decode step are held
   against the plain versions, and every 2-D GEMM shape the path launched
   is held against its plain version and timed.
7. the training path: ``train_main`` trains llama3.2-1b at full width
   (optimized profile: attention through the flash-attention kernels) in
   f32 for 4 steps of batch 2 x 1024 tokens, every GEMM and its dx/dw on
   the RSA kernel; the loss must fall, the driver must not restart, no
   plain version may run, the final checkpoint must restore leaf for leaf,
   and step 1's loss and grad norm must match the same step from the same
   init on the plain versions (1e-5 / 1e-4 relative).  It reports each
   kernel's launches per step, step time, tokens/s and the model-FLOPs
   share of the card's f32 peak.
8. the rwkv6-1.6b path: ``serve_continuous`` serving rwkv6-1.6b at its
   published widths (24 layers, d=2048, 32 heads x 64, ff 7168, vocab
   65536, untied; no depth cut; bf16, random weights from seed 0) with the
   reference's optimized profile (``ssm_impl="pallas"``: the WKV scan in
   the hand-written kernel) on the dense slot layout: whole-prompt prefill
   per admission, one decode of every slot per step.  Every request must
   finish leak-free, every model call must launch the WKV kernel once per
   layer and the RSA GEMM 241 times (10 sites x 24 layers + the
   unembedding), every plan line must say ``@kernel`` and no plain version
   may run.  A batched prefill and a decode step are held against the
   plain versions, and decode logits after t streamed tokens against one
   prefill of the prompt plus those tokens (5% of the largest logit).
9. the self-adaptive paths.  Path A (``launch/selfadaptive_gemm.py``, the
   reference's ``examples/selfadaptive_gemm.py``) trains a raw-encoding
   ADAPTNET-TPU on the card (60 000 samples, 8 epochs), asks the ADAPTNETX
   kernel for the tile of each of the first 10 synthetic Table-IV GEMMs
   and runs each through the RSA GEMM in f32: one ADAPTNETX launch per
   layer; each layer's logits against the plain version (the reference's
   rtol = atol = 1e-5), its pick against the host twin ``logits_np``, its
   GEMM against the plain GEMM, and its query's time beside its GEMM's
   (L2 flushed) with the query's share of the two.
   Path B trains a logbucket net over llama3.2-1b's serving shapes on the
   card (30 000 samples, 5 epochs), saves it and serves llama3.2-1b at
   full width (bf16, phase 4's weights) through ``serve_continuous(...,
   dispatcher="adaptnet")`` on 8 requests: every request must finish
   leak-free, the net must decide sites (fallbacks exactly the shapes
   past its range), every plan line must say ``@kernel`` and no plain
   version may run; a chunk-prefill and a decode step under the net's
   plan are held against the plain versions (5%).  The card trains its
   own nets (it has no JAX), so its picks show plumbing and agreement
   with the host twin, not quality on the H100.
10. the speculative path.  (a) phase 4's model, weights and trace served
   through ``serve_continuous(..., spec_draft="self", spec_k=4)``: every
   request must finish with its 32 tokens, both page pools must end whole,
   more than one token must commit a verify step, no plain version may
   run, every verify call must launch the prefill kernel 16 times and the
   RSA GEMM 113 times, every draft round the decode kernel 16 times (the
   launches of each model call are counted around it), and every plan
   line must say ``@kernel``.  One verify step (S = 8, C = 5, chunks 1-5
   at kv offsets off the page boundaries up to 545) is held against the
   same step under ``execute="torch"`` and its row 0 against the decode
   step of the same pending token (5% of the largest logit); the verify
   GEMM shapes (M = 40) against their plain versions, timed.  Reported,
   not gated: how many requests emit phase 4's tokens, with each other
   one's first differing position and phase 4's top-2 gap there; decode
   tok/s beside phase 4's, the accept rate, tokens a verify step, and
   a kernel-time estimate of one spec step beside its wall.  (b) The
   reference's test pair (``tests/test_spec_decode.py``) on the card in
   f32: reduced llama3.2-1b (hd 16) on its ``_requests(3)`` trace, plain
   and with ``spec_k=3`` drafting by ``self``, by reduced ``gemma-2b``
   and by ``self`` from a 4-page draft pool; every run's tokens must equal
   the plain run's, apart from positions where the plain run's top-2 gap
   is within 1e-4 of its largest logit (printed as near-ties); the gemma
   draft must be rejected somewhere, the starved pool must preempt draft
   lanes, no plain version may run and every pool must end whole.
11. the SAGAR path (``launch/sagar.py``, the paper's own model): the
   paper's 2^14-MAC instance (32 x 32 cells, 108 classes), 400 000
   log-uniform workloads (seed 42) labelled on the host by the copied
   cost model (EDP oracle), the raw ADAPTNET at its published widths (E =
   16, H = 128) trained on the card for 20 epochs and gated on the
   reference's test gates (accuracy >= 0.80, geomean relative EDP <=
   1.02); the 2^12 and 2^13 instances (75 and 90 classes) at 60 000
   samples and 8 epochs; Fig. 7e on a 60 000-sample 2^14 set (seed 11:
   kNN, logistic regression and the plain MLP on the card, the random
   forest on the host), gated on ADAPTNET beating logistic regression by
   more than 0.05; one batched ADAPTNETX launch per Table-IV workload
   (6 launches of 13-72 queries) with the 2^14 net, its logits against
   the plain version (rtol = atol = 1e-5) and every pick equal to the
   host twin's, each batch timed beside its bound; and
   ``SaraDispatcher.gemm`` at 512x512x512 and 128x8000x128 (f32) and
   8x2048x2048 (bf16), each call one RSA launch and no plain call, its
   registry record the dispatcher's recommendation, its output against
   the plain GEMM at phase 3's tolerance.  Relative EDP and cycles are
   cost-model numbers for the paper's 28 nm array, not measurements.
12. observability and fault tolerance on the main path: phase 4's
   ``serve_continuous`` call three times.  (a) With ``trace_out`` (under
   ``build/``, copied to ``chiprun_out/``) and ``sanitize=True``: 16/16
   requests with phase 4's tokens bitwise, no poison hit, generation
   fault or leak, ``validate_trace`` finds no problem and nothing was
   dropped, every request has one submit and one finish, the dispatch
   events number ``dispatch_records``, no plain version runs; it prints
   the counters, the events, the export's bytes and each step phase's
   mean host ms over decode, prefill and mixed steps.  (b) With the
   reference's chaos smoke odds (``ChaosConfig(seed=0, pool_oom_p=0.15,
   poison_p=0.15, stall_p=0.1, preempt_p=0.1)``) under the sanitizer:
   every request ends exactly once, at least one fault is injected and
   contained, every poisoned page is trapped on its own lane, nothing
   leaks, and every finished request that was never force-preempted
   emits phase 4's tokens bitwise (any survivor that differs is printed
   with its first difference and phase 4's top-2 gap there).  (c) Served
   with ``snapshot_every=8`` and killed after step 20; a fresh engine
   from the same configs (weights from the seed) restores step 16 and
   finishes: all 16 requests emit phase 4's tokens bitwise; it prints the
   snapshot's bytes and the seconds to save and to restore, and deletes
   the snapshots.
13. every attention family on every KV layout, bf16, random weights from
   seeds, at published widths: (a) qwen2-moe-a2.7b (24 layers, q/k/v
   biases, 60 -> 64 experts top-4 plus 4 shared) and (b) gemma-2b (18
   layers, MQA at hd 256), no depth cut, 12 requests of 64-512 tokens,
   paged with chunks of 64; (c) deepseek-coder-33b and command-r-plus-104b
   cut to 2 layers (the cut printed), 4 requests; (d) phase 4's weights
   and trace on the dense layout with bucketed prefill (the blockwise
   attention route) and paged with the buckets scattered into pages;
   (e) seamless-m4t-medium (12 + 12 layers, the optimized profile: the
   encoder and a prefill's self and cross attention on the flash
   forward), 8
   requests with seeded source features at src_len 128; (f) internvl2-76b
   cut to 2 layers, 4 requests with seeded patch embeddings.  On every
   path: every request finishes, the pool ends leak-free, each paged
   kernel launches once a layer and model call where the layout runs it,
   the flash forward once an encoder, a self-attention and a
   cross-attention layer a prefill, every GEMM site but the f32 router runs on the RSA kernel with
   each expert bank one launch, no plain version runs, and one prefill
   and one decode step are within 5% of the plain versions' largest logit
   (MoE routing replayed; both decode the plain run's tokens).  (d)
   prints how many requests emit phase 4's tokens (not gated), a dense
   decode call's wall and the blockwise route's device time a layer; each
   path's two most launched GEMM shapes are held against the plain
   version and timed.
14. the recurrent families end to end.  (a) zamba2-7b at its published
   widths with no depth cut (81 slots: 68 Mamba2 layers in 13 groups of
   5, each followed by the one weight-shared attention + MLP block, then
   3 more; d=3584, shared attention 32 x 112, vocab 32000, tied; bf16,
   random weights from seed 0) on the dense slot layout, 8 slots, 8
   requests of 64, 128, ..., 512 tokens, 16 new tokens: phase 13's gates,
   228 GEMM launches a model call (2 x 68 + 7 x 13 + the unembedding), the
   decode call's wall beside its kernels' device time (torch.profiler)
   and the device time of its SSD scans and blockwise attention; a
   batched prefill and a decode step against the plain versions in f32
   (5%) and bf16 (5%, or where bf16 rounding grown through 81 slots
   passes that, no further than the plain bf16 run is from the plain f32
   run, as phase 8), the gate that held printed.  (b) zamba2-7b trained
   at full width with a depth cut to 13 slots (printed), and (c)
   rwkv6-1.6b trained uncut, both through ``train_main`` (optimized
   profile: the shared block on the flash kernels at hd 112; the WKV
   kernel forward, its backward through the plain scan), f32, 4 steps of
   2 x 1024 (lr 1e-3; rwkv6 1e-4, where 1e-3 makes its random-weight
   loss rise): a falling loss, 0 restarts, 0 plain calls, each kernel's
   launches a step as expected, step 1's loss and grad norm within 1e-5 /
   1e-4 of the same step on the plain versions; rwkv6's grad norm, where
   the f32 rounding grown through its 24 layers passes 1e-4, no further
   from the plain run's than a control run with the kernel GEMMs and the
   plain WKV scan is (the gate that held printed), and 1e-5 / 1e-4 at 2
   layers of the same widths.
15. the other families trained (optimized profile: attention on the flash
   kernels; f32, 4 steps of 2 x 1024 tokens at the step builder's default
   lr 3e-4, random weights from seed 0): (a) gemma-2b at its published widths cut to 6 of 18 layers
   (MQA at hd 256: the f32 flash kernels on CTA pairs), (b)
   qwen2-moe-a2.7b cut to 1 of 24 layers (60 -> 64 experts top-4 and 4
   shared: each expert bank's dx and dw as one bank launch each), through
   ``train_main`` with its checkpoints, the final tree restored once, (c)
   seamless-m4t-medium uncut (12 + 12 layers; 128 seeded source frames:
   the bidirectional encoder and the cross attention through the flash
   forward and backward), (d) deepseek-v3-671b (expanded MLA, one dense and
   one MoE layer) and internvl2-76b (vlm, seeded patch rows) at the reduced
   preset, since one layer of either at published widths passes f32
   AdamW's bytes on 80 GB (printed from 15a's measured bytes a
   parameter).  a, c and d step ``build_train_step``'s step under a
   ``TrainDriver`` that writes no checkpoint.  Gates, as phase 14 but
   for the first: the loss falls on step 0's batch (after the four steps
   below step 1's: each step draws new random tokens, whose loss spreads
   by more than four steps move it; at lr 1e-3 seamless overshoots that
   batch), 0 restarts, 0 plain calls, each kernel's launches a step
   as counted from the model's layers, step 1's loss and grad norm within
   1e-5 / 1e-4 of the same step on the plain versions, a MoE model's aux
   metrics finite and within 1e-5 of the plain step's, and 15b's restored
   tree leaf for leaf the trained one.
16. the step tooling (``launch/profile.py``, ``launch/dryrun.py``,
   ``launch/roofline.py``) and the wave baseline.  (a) ``profile_cell`` on
   llama3.2-1b at full width with the optimized profile, batch 1 of each
   of ``train_4k`` (f32, the f32 CUDA-core peak; if one 4096-token
   sequence runs out of memory, the measured peak is printed and phase
   7's 2 x 1024 profiled instead, under that name), ``prefill_32k`` (bf16
   on a fresh cache: the flash forward) and ``decode_32k`` (bf16, one
   token against a cache filled to 32767 seeded rows): one warm-up, 3
   timed steps, one under ``torch.profiler``.  Each prints the step's
   wall, the profiled step's kernel device time and wall and the idle
   share between those two, the model FLOPs
   and compulsory bytes, ``roofline_fraction`` and ``bound_attainment``,
   the peak memory and the top 5 kernels; gates: the RSA GEMM launched
   (and the flash kernels for train and prefill), each of those kernel
   families with device time in the profiled step, no plain version run,
   no share above 1.05, the idle share in [0, 1], a finite output.  (b)
   ``dryrun --device meta`` over all 40 cells, each status printed: every
   cell "ok" with its estimates or "skipped" with the reference's reason
   or its memory estimate.  (c) ``serve_waves`` serving full-width llama3.2-1b in bf16,
   2 waves of 4 prompts of 32 tokens, 32 new tokens each, greedy: every
   GEMM on the kernel, prefill and decode tok/s printed.  The phase
   fails past its 90 s budget.
17. the reference's example drivers on the card, through the port's
   counterparts (``examples/torch/*.py``, each ``main`` called in this
   process) and its linter.  (a) saralint (``repro_torch.analysis``) over
   ``src/repro_torch``: 0 errors, 0 warnings, every suppression with a
   reason.  (b) ``quickstart.py``, all four parts at their defaults (the
   cost model's Fig. 3; ADAPTNET trained on the card, 30 000 samples, 4
   epochs; ``SaraDispatcher.gemm`` at 512x512x512 and 128x8000x128 f32
   on the RSA kernel, each against ``matmul``; reduced llama trained 15
   steps through ``train_main``).  (c) ``serve_requests.py`` at its
   defaults (reduced llama at d = 256, 4 layers, f32; 12 mixed-length
   requests on 4 slots, sampled): every request finishes with its tokens,
   the pool ends leak-free.  (d) ``train_lm.py --preset 100m`` (131M
   parameters, f32) for 20 steps with ``--inject-failure``: the loss
   falls (here and in (b): the mean of the last 5 steps below the mean
   of the first 5, as each step draws a new random batch), exactly one
   restart, which resumes from the step-10 checkpoint (every step runs
   once).  Gates: (b)-(d) each launch the RSA
   GEMM kernel, (c) the paged decode and prefill kernels, no plain
   version runs; the phase fails past its 60 s budget.
18. the distribution layer (``parallel/``, ``launch/mesh.py``): the
   sharded FSDP / ZeRO-3 train step of llama3.2-1b at full width (16
   layers, d 2048, vocab 128256), f32, ``tp_strategy="dp_all"``, phase
   7's batch (2 x 1024), 5 steps (18d: the first) from one seeded init
   on one seeded batch a step.  (a) The unsharded step, (b) the sharded
   step on a (1, 1) mesh over an NCCL group of one rank: its losses and
   every parameter equal (a)'s bit for bit, its RSA GEMM and flash launch
   counts equal (a)'s with no plain call; both step times (median of
   steps 2-5) and the sharded path's overhead printed.  (c)
   ``quantized_psum_tree`` over that group on a step's gradients: each
   sum is the int8 round trip of the gradient (its codes, at the second
   scale) and each residual the gradient less its first round trip,
   exactly.  (d) Two ranks on the one card, a (2, 1) mesh over gloo with
   CUDA tensors (NCCL refuses two ranks on one card;
   ``scripts/probe_ranks.py``), each a row of the batch, one step: its
   loss within 1e-5 and grad norm within 1e-4 of (a)'s step 1 (phase 7's
   gates), and each leaf's weights after it within the larger of 1e-4 of
   the leaf's largest magnitude and 2e-3 of its travel from the init
   (``tests/test_torch_train_sharded.py``'s rule) at 99.5% of the leaf's
   elements at least: AdamW's first update is about lr times the sign of
   each gradient entry, so an entry whose terms cancel, which the two
   ranks sum in another order, can move by up to 2 lr the other way (the
   zero-centred norm weights hold most of them); a leaf reduced wrongly
   moves the other way at a large share of its entries.  Each rank's
   launches are (a)'s a step, no plain call.  (e) The entry point users
   launch, ``torchrun --standalone --nproc-per-node 1 -m
   repro_torch.launch.train --device cuda --optimized`` (3 steps of the
   reduced llama3.2-1b; the mesh branch of ``train_main`` over an NCCL
   group from torchrun's environment) against ``train_main`` on one
   device: the same printed losses, the final checkpoints bit for bit,
   every GEMM site on the kernel.  (f) Megatron tensor parallelism: the
   same two rank processes, after (d)'s step, on a (1, 2) mesh under
   ``tp_strategy="tp"`` (``parallel/tp.py``), each rank its half of the
   heads, FFN columns and vocab rows over the whole batch, one step: its
   loss and grad norm against (a)'s step 1 with (d)'s gates, each rank's
   blocks of each leaf within (d)'s rule at ``P18_LEAF_SHARE``, no plain
   call, RSA GEMM and flash launches on each rank; each rank's step
   seconds, peak memory, launch counts and local GEMM shapes printed.
   The sharded step gathers a layer at a time inside its remat'd bodies
   and writes its update into the rank's blocks (``parallel/fsdp.py``):
   (d), (f) and (g) print each rank's high-water of gathered bytes and
   the bytes its collectives moved in the step (``sharding.METER``), and
   the peak memory a rank of (d) and of (f) is gated at
   ``P18_PEAK_SAVING_GB`` below what the whole-tree step took there
   (``P18_PEAK_BEFORE_GB``).  The phase fails past its 240 s budget.

Phase 3 also holds the paged MLA kernel (decode over ragged lengths
0-545, prefill of a 64-row chunk at ragged starts, each with its plan and,
in bf16, beside SDPA over the latents gathered beforehand; a forced split
count run twice, bitwise; one timed lane of 4096 rows) and the bank GEMM (the
expert banks, E = 256, and the MLA head banks, E = 128 views of W_UK /
W_UV) against their plain versions at phase 6's shapes, and the three
flash-attention kernels (forward, dq, dk/dv; f32, and bf16 with all
three on the tensor cores, run twice and bitwise)
and every training GEMM
(forward, dx and dw of each site, f32) at phase 7's shapes and at the
local shapes of 18f's ranks (with the flash kernels over a rank's
heads), and the WKV
kernel (prefill, ragged with decays down to -e, the chunk-1 decode, the
state carry) and the linear-attention kernel at phase 8's widths, and the
ADAPTNETX kernel (75, 108 and 135 classes; the reference's ids, ids past
the table, a batch of 64; each line with its plan and the timer's floor;
under one query and the batch every forced plan bitwise the plan's, and
each query alone bitwise its row of the batch) beside the host twin's
time per query, and the prefill kernel at phase 10's verify shape (S = 8,
C = 5, chunks 1-5 at kv offsets off the page boundaries), timed beside
its bound and the SDPA yardstick, and phase 13's shapes: qwen2-moe's
expert banks, the decode and prefill kernels at gemma-2b's (G = 8, hd
256) and qwen2-moe's (G = 1, hd 128) widths and the bidirectional flash
kernels (bf16, the forward and its gradients) at seamless-m4t-medium's
encoder shape, each run to run bitwise,
timed beside its bound and yardstick, and phase 14's: zamba2-7b's
serving GEMMs (bf16 at M = 8 and 512, ``ssm.in_proj``'s ragged N =
14576 among them) and training GEMMs (f32 forward, dx and dw at 2 x 1024
tokens), the three flash kernels at its shared block's shape (B = 2, S =
1024, 32 / 32 heads, hd 112, causal, f32, run to run bitwise) and the
WKV kernel at 14c's training forward (B = 2, S = 1024), each timed
beside its plain version, its bound and ``matmul`` / SDPA, and phase
15's: the three flash kernels at gemma-2b's training shape (B = 2, S =
1024, 8 / 1 heads, hd 256, causal; f32 and bf16, the bf16 gradients held
to 2e-2) and at deepseek-v3's expanded-MLA training shape (B = 1, S =
1024, 128 heads, hd 192 / hd_v 128, causal, f32; all three on CTA pairs
that split the head dim in halves), all three run to run bitwise, and the
bank GEMM's dx and dw at 15b's expert banks (E = 64, M = 172, f32, the
transposes read in place) against the plain version and ``torch.bmm``,
each timed beside its bound.

After phase 9 one line per mode gives the worst kernel / library-call
factor over the run's timed GEMM shapes, with its shape.  The lines
before the last are the JSON kernel table, then the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``.  The
full report is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the H100's peaks (dense bf16 tensor cores, f32 CUDA cores, HBM3 bytes/s),
# read from repro_torch.core.hw.H100 in main() once src/ is on the path
PEAK_BF16_FLOPS = PEAK_F32_FLOPS = PEAK_BYTES = None
F32_EPS = 2.0 ** -24
BF16_EPS = 2.0 ** -8
PAGED_TPU = {"paged_decode": "src/repro/kernels/paged_attn.py:104",
             "paged_prefill": "src/repro/kernels/paged_attn.py:278",
             "paged_decode_lse": "src/repro/kernels/paged_attn.py:413",
             "paged_prefix": "src/repro/kernels/paged_attn.py:517"}
RSA_TPU = "src/repro/kernels/rsa_gemm.py:64"
# each mode's pallas_call in the reference; the port runs all three modes
# in one kernel, rsa_psum.cu (OS as a single block_k chunk over K)
RSA_TPU_BY_MODE = {"OS": RSA_TPU, "WS": "src/repro/kernels/rsa_gemm.py:96",
                   "IS": "src/repro/kernels/rsa_gemm.py:113"}
RSA_SRC = "src/repro_torch/kernels/csrc/rsa_psum.cu"
MLA_TPU = {"paged_mla_decode": "src/repro/kernels/paged_attn.py:189",
           "paged_mla_prefill": "src/repro/kernels/paged_attn.py:578"}
# phase 3's bf16 flash case: the tensor-core forward, dq and dk/dv at phase
# 7's attention shape
P3_BF16 = "llama bf16"
FLASH_TPU = {"flash_fwd": "src/repro/kernels/flash_attn.py:123",
             "flash_dq": "src/repro/kernels/flash_attn.py:265",
             "flash_dkv": "src/repro/kernels/flash_attn.py:282"}
LINEAR_TPU = {"wkv_bshk": "src/repro/kernels/linear_attn.py:106",
              "linear_attn": "src/repro/kernels/linear_attn.py:141"}
ADAPTNETX_TPU = "src/repro/kernels/adaptnetx.py:31"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 1024, 4     # phase 7's batch and steps
SA_SAMPLES, SA_EPOCHS, SA_LAYERS = 60_000, 8, 10   # phase 9, path A
SB_SAMPLES, SB_EPOCHS = 30_000, 5                  # phase 9, path B
SB_REQUESTS, SB_GEN = 8, 16
# phase 10: speculative decoding, spec_k draft tokens a lane and step; the
# verify shape's kv offsets and chunk lengths (phases 3 and 10a)
SPEC_K = 4
VERIFY_STARTS = [540, 3, 100, 17, 250, 400, 61, 129]
VERIFY_CHUNKS = [5, 1, 3, 5, 2, 5, 4, 5]
# phase 11: the SAGAR path; Fig. 8's size for the 2^14 net, the
# reference's tests' size for 2^12, 2^13 and Fig. 7e; SaraDispatcher.gemm
# at quickstart's two f32 shapes and the main path's bf16 decode shape
SG_SAMPLES, SG_EPOCHS = 400_000, 20
SG_SMALL_SAMPLES, SG_SMALL_EPOCHS = 60_000, 8
SG_GEMMS = ((512, 512, 512, "float32"), (128, 8000, 128, "float32"),
            (8, 2048, 2048, "bfloat16"))
# phase 13: the paths' slots and the encdec source length; phase 3's flash
# case at seamless's encoder shape
P13_SLOTS, P13_SRC = 8, 128
P13_FLASH = "seamless encoder"
P13_KEYS = {}     # each phase 13 path's GEMM launches by (.., M, K, N, mode)
# phase 14: zamba2-7b served (8 slots, 8 requests of 64, 128, ..., 512
# tokens, 16 new tokens each) and trained (depth cut to 13 slots: 2 groups
# of 5 Mamba layers and the shared block, then 1 Mamba layer), rwkv6-1.6b
# trained uncut; phase 3's flash case at the shared block's shape
P14_SLOTS, P14_GEN, P14_LENS = 8, 16, tuple(range(64, 513, 64))
P14_TRAIN_SLOTS = 13
P14_FLASH = "zamba2 hd 112"
P14_KEYS = {}     # each phase 14 path's GEMM launches by (M, K, N, mode)
# phase 15: the other families trained, f32, phase 7's batch and steps:
# (key, arch, depth cut, preset, lr); 15c's seeded source frames; phase
# 3's flash cases at gemma-2b's and the expanded MLA's widths
# (each at the step builder's default lr, 3e-4: at 1e-3 seamless's four
# steps overshoot step 0's batch)
P15_RUNS = (("15a", "gemma-2b", 6, "full", 3e-4),
            ("15b", "qwen2-moe-a2.7b", 1, "full", 3e-4),
            ("15c", "seamless-m4t-medium", None, "full", 3e-4),
            ("15d deepseek", "deepseek-v3-671b", None, "reduced", 3e-4),
            ("15d internvl2", "internvl2-76b", None, "reduced", 3e-4))
P15_SRC = 128
P15_FLASH = {"gemma": "gemma hd 256", "gemma bf16": "gemma hd 256 bf16",
             "mla": "deepseek MLA 192/128"}
P15_KEYS = {}     # each phase 15 run's GEMM launches by ([E,] M, K, N, mode)
# phase 16: the step tooling on llama3.2-1b's cells (optimized profile,
# batch 1 of each shape's length), the dry-run's meta sweep and the wave
# baseline (full-width llama, bf16: waves of prompts, greedy)
P16_CELLS = ("train_4k", "prefill_32k", "decode_32k")
P16_WAVES = dict(batch=4, prompt_len=32, gen=32, waves=2)
P16_BUDGET_S = 90.0
# phase 17: the example drivers; train_lm's largest preset, 20 steps with
# the simulated preemption at step 10 (its checkpoint interval)
P17_TRAIN = ("--preset", "100m", "--steps", "20", "--inject-failure")
P17_BUDGET_S = 60.0
# phase 18: the sharded train step (phase 7's batch) on one rank over
# NCCL and on two ranks of the one card over gloo (step 1 alone, the step
# whose weights it gates); the train entry point under torchrun
P18_STEPS, P18_LR = 5, 1e-3          # (a) and (b)
P18_RANK_STEPS = 1                   # (d)
# (d)'s floor on each leaf's share of elements within the rule: the
# zero-centred norm weights hold the entries whose gradient terms cancel
# (layers/ln2 at 99.84-99.93% on an H100 80GB HBM3 at 700 W)
P18_LEAF_SHARE = 0.995
# (d)'s and (f)'s peak memory a rank under the whole-tree step (runs PG-PK
# and QA-QD, H100 80GB HBM3 at 700 W), and the least saving of the
# per-layer gather with the update in place
P18_PEAK_BEFORE_GB = {"d": 20.8, "f": 20.9}
P18_PEAK_SAVING_GB = 5.0
P18_BUDGET_S = 240.0
P18_RANK_DEADLINE_S = 200.0
# (e): launch.train's flags (its default batch and length, 3 steps)
P18_MAIN_ARGS = ("--optimized", "--steps", "3", "--batch", "8", "--seq",
                 "128")
P18_MAIN_DEADLINE_S = 180.0
# (d)'s and (f)'s ranks on the one card: (d) a (2, 1) mesh, (f) a (1, 2)
# mesh under Megatron tp, each rank half the heads, FFN columns and vocab
P18_RANKS = 2
P18F_FLASH = "18f tp llama local heads"
# (g): the recurrent families under Megatron tp on the same ranks' (1, 2)
# mesh, full width, depth cut: (key, arch, layer slots); rwkv6 4 of 24
# layers, zamba2 7 of 81 slots (six Mamba2 blocks, one pass of the shared
# block)
P18G_RUNS = (("rwkv6", "rwkv6-1.6b", 4), ("zamba2", "zamba2-7b", 7))
P18G_FLASH = "18g tp zamba2 local heads"


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


class Timer:
    """Median device time of a callable, with the L2 cache flushed before
    every timed run (the main path meets every weight cold).

    The host stays off the clock: before each run a spin kernel
    (``torch.cuda._sleep``) holds the card while the host queues the start
    event, the callable's launches and the end event, so the events bracket
    device work only.  The spin lasts twice the callable's host time, at
    least 1 ms; a run whose queuing outlasted its spin is thrown away and
    the spin doubled."""

    def __init__(self, torch, reps: int = 15):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 100)
        a, b = self._events()
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = cycles / a.elapsed_time(b)

    def _events(self):
        return (self.torch.cuda.Event(enable_timing=True),
                self.torch.cuda.Event(enable_timing=True))

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = max(1.0, 2.0 * host_ms)
        times = []
        for _ in range(4 * self.reps):
            self.flush.zero_()
            torch.cuda._sleep(int(spin_ms * self.cycles_per_ms))
            a, b = self._events()
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            b.synchronize()
            if queued_ms >= spin_ms:
                spin_ms *= 2.0
                continue
            times.append(a.elapsed_time(b))
            if len(times) == self.reps:
                return statistics.median(times)
        raise RuntimeError(f"timer: the host never got ahead of the card "
                           f"({len(times)} of {self.reps} runs kept)")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_cases(cfg):
    """(site, M, K, N, b_transposed, out_f32) of every main-path GEMM at
    decode (M = slots) and prefill (M = slots * chunk)."""
    d, q, kv, ff, V = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                       cfg.vocab_size)
    out = []
    for phase, M in (("decode", 8), ("prefill", 512)):
        out += [(f"{phase} q/o", M, d, q, False, False),
                (f"{phase} k/v", M, d, kv, False, False),
                (f"{phase} gate/up", M, d, ff, False, False),
                (f"{phase} down", M, ff, d, False, False)]
    out.append(("unembed", 8, d, V, True, True))
    return out


def gemm_tolerance(torch, a, b, plain, mode, bk, out_f32):
    """Kernel vs plain: both sum in f32 in different orders, bounded by
    K * 2^-24 * max(|a| @ |b|); a bf16 output adds one bf16 rounding per
    block_k chunk (one in OS) of max |plain|."""
    K = a.shape[1]
    mag = (a.abs().float() @ b.abs().float()).max().item()
    tol = K * F32_EPS * mag
    if not out_f32:
        chunks = 1 if mode == 0 else -(-K // bk)
        tol += (chunks + 1) * BF16_EPS * plain.abs().max().item()
    return tol


def psum_bitwise(torch, run, what, rec=None, quiet=False):
    """WS and IS are one function and one kernel (``csrc/rsa_psum.cu``):
    ``run(mode)`` on the same inputs must give bitwise equal outputs in the
    two modes, and a second WS run the same bits as the first; OS (the same
    kernel with one chunk, its splits fixed up in order) must give the same
    bits twice too.  Logs one line (unless ``quiet`` and all hold), stores
    them in ``rec``, returns whether all hold."""
    ws, is_, again = run(1), run(2), run(1)
    os_a, os_b = run(0), run(0)
    torch.cuda.synchronize()
    eq, rerun = torch.equal(ws, is_), torch.equal(ws, again)
    os_rerun = torch.equal(os_a, os_b)
    if rec is not None:
        rec.update(ws_is_bitwise=eq, run_to_run_bitwise=rerun and os_rerun,
                   os_run_to_run_bitwise=os_rerun)
    good = eq and rerun and os_rerun
    if not (quiet and good):
        log(f"    {what}: WS == IS bitwise {eq}, run to run bitwise "
            f"{rerun} (OS {os_rerun}) {'ok' if good else 'FAIL'}")
    del ws, is_, again, os_a, os_b
    return good


def mode_summary(report):
    """Per mode, the worst kernel / library-call factor over every timed
    GEMM and bank shape of the run, with its shape."""
    worst = {}
    for part in ("gemm", "bank", "train_gemm", "ds_gemm", "rwkv_gemm",
                 "p14_gemm", "p14_train_gemm", "p15_bank"):
        for rec in report.get(part, []):
            if not rec.get("ms") or not rec.get("library_ms"):
                continue
            x = rec["ms"] / rec["library_ms"]
            if x > worst.get(rec["mode"], {}).get("factor", 0.0):
                shape = (f"{rec['E']}x(" if "E" in rec else "") + \
                    f"{rec['M']}x{rec['K']}x{rec['N']}" + \
                    (")" if "E" in rec else "")
                worst[rec["mode"]] = {
                    "factor": x, "part": part, "shape": shape,
                    "ms": rec["ms"], "library_ms": rec["library_ms"]}
    report["gemm_mode_summary"] = worst
    for mode in ("OS", "WS", "IS"):
        if mode in worst:
            w = worst[mode]
            log(f"  rsa_gemm {mode}: worst kernel/library {w['factor']:.2f}x"
                f" at {w['part']} {w['shape']} (kernel {w['ms']:.4f} ms, "
                f"library {w['library_ms']:.4f} ms)")


def check_gemms(torch, report, timer, cfg, dispatcher):
    from repro_torch.core.hw import DATAFLOW_NAMES
    from repro_torch.dispatch.executor import _clamped_blocks
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ok = True

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [(site, M, K, N, bt, of, torch.bfloat16, True)
             for site, M, K, N, bt, of in gemm_cases(cfg)]
    # ragged shapes, the transposed form, and f32 operands
    cases += [("ragged f32", 130, 200, 72, False, True, torch.float32, False),
              ("ragged bf16", 37, 1000, 300, False, False, torch.bfloat16,
               False),
              ("ragged bf16 B^T", 37, 1000, 300, True, False, torch.bfloat16,
               False),
              ("f32 q/o", 8, cfg.d_model, cfg.q_dim, False, True,
               torch.float32, False)]
    for site, M, K, N, bt, out_f32, dt, main in cases:
        a = rand((M, K), dt)
        stored = rand((N, K) if bt else (K, N), dt) * (1.0 / math.sqrt(K))
        b = stored.t() if bt else stored     # B^T: a view, as embed.t()
        odt = torch.float32 if out_f32 else dt
        cfg_t = dispatcher.recommend(M, K, N)
        bm, bn, bk = _clamped_blocks(cfg_t, M, K, N)
        if not main:
            bk = 256 if K > 256 else 128
        for mode in (0, 1, 2):
            def kernel():
                return ops.rsa_gemm(a, b, block_m=bm, block_n=bn, block_k=bk,
                                    mode=mode, out_dtype=odt)
            out = kernel()
            plain = rsa_gemm_plain(a, b, block_k=bk, mode=mode,
                                   out_dtype=odt)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            tol = gemm_tolerance(torch, a, b, plain, mode, bk, out_f32)
            good = err <= tol and math.isfinite(err)
            ok &= good
            rec = {"site": site, "M": M, "K": K, "N": N,
                   "dtype": str(dt).split(".")[-1],
                   "out": str(odt).split(".")[-1], "b_transposed": bt,
                   "bk": bk, "mode": DATAFLOW_NAMES[mode],
                   "recommended": main and mode == cfg_t.mode,
                   "max_abs_err": err, "tol": tol, "ok": good}
            if main:
                # every mode at every main-path shape: kernel, plain and
                # bound; the library call once per shape (mode-free)
                rec["ms"] = timer(kernel)
                rec["plain_ms"] = timer(lambda: rsa_gemm_plain(
                    a, b, block_k=bk, mode=mode, out_dtype=odt))
                if mode == 0:
                    library_ms = timer(lambda: torch.matmul(a, b))
                rec["library_ms"] = library_ms
                nbytes = (M * K + K * N) * a.element_size() + \
                    M * N * out.element_size()
                t_bytes = nbytes / PEAK_BYTES * 1e3
                t_ops = 2.0 * M * N * K / PEAK_BF16_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else \
                    "operations"
                rec["key"] = (M, K, N, mode)
            report["gemm"].append(rec)
            log(f"  rsa_gemm {site:<16} {M}x{K}x{N} {rec['mode']} bk={bk} "
                f"{rec['dtype']}->{rec['out']}{' B^T' if bt else ''}: "
                f"max_abs_err {err:.3e} (tol {tol:.3e}) "
                f"{'ok' if good else 'FAIL'}"
                + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f}"
                   f" ms matmul {rec['library_ms']:.4f} ms bound "
                   f"{rec['bound_ms']:.4f} ms" if main else "")
                + ("  [main path]" if rec["recommended"] else ""))
        ok &= psum_bitwise(torch, lambda mode: ops.rsa_gemm(
            a, b, block_m=bm, block_n=bn, block_k=bk, mode=mode,
            out_dtype=odt), f"{site} {M}x{K}x{N}", rec)
    return ok


def paged_inputs(torch, gen, S, KVH, G, hd, bs, lengths, dtype, width=None):
    """Random arena + per-lane tables over disjoint pages (dead columns
    repeat the last live id; a length-0 lane gets an all-zero row), the
    tables ``width`` columns wide (default: the longest lane's pages)."""
    W = width or max(1, max(-(-n // bs) for n in lengths))
    tables = torch.zeros((S, W), dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        nblk = -(-n // bs)
        if nblk:
            tables[i, :nblk] = torch.arange(nxt, nxt + nblk)
            tables[i, nblk:] = nxt + nblk - 1
            nxt += nblk
    NB = nxt + 1
    ka = torch.randn((NB, bs, KVH, hd), generator=gen, device="cuda")
    va = torch.randn((NB, bs, KVH, hd), generator=gen, device="cuda")
    return (ka.to(dtype), va.to(dtype), tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def attn_bound_ms(kv_rows, KVH, hd, io_bytes, flops):
    nbytes = kv_rows * KVH * 2 * hd * 2 + io_bytes
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def plan_text(plan) -> str:
    """One line of an ``_attn_plan``: splits x units = CTAs, width."""
    return (f"{plan['splits']} splits x {plan['units']} = "
            f"{plan['splits'] * plan['units']} CTAs, width {plan['width']}")


def check_paged(torch, report, timer, cfg):
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attn import (
        _attn_plan, _decode_plan, paged_decode_lse_plain,
        paged_decode_plain, paged_decode_lse_cuda,
        paged_prefill_plain)
    from repro_torch.launch.bench_decode import (gathered_sdpa,
                                                 gathered_sdpa_prefill)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    KVH, H, hd, bs = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    # decode: ragged lengths incl. 0, page boundaries and the main path's
    # longest context (max_len 545); prefill: ragged starts/chunks incl. an
    # empty lane, chunk 64 (the main path's)
    dec_lengths = [0, 1, 15, 16, 17, 200, 400, 545]
    starts = [0, 0, 64, 100, 0, 448, 0, 10]
    chunks = [64, 10, 64, 37, 0, 64, 1, 64]
    for dt, cap, timed in ((torch.bfloat16, 0.0, True),
                           (torch.float32, 0.0, False),
                           (torch.bfloat16, 30.0, False)):
        ka, va, tables, lens = paged_inputs(torch, gen, 8, KVH, G, hd, bs,
                                            dec_lengths, dt)
        q = torch.randn((8, H, hd), generator=gen, device="cuda").to(dt)
        out = ops.paged_attention(q, ka, va, tables, lens, logit_cap=cap)
        plain = paged_decode_plain(q, ka, va, tables, lens, scale=scale,
                                   logit_cap=cap)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        # bf16: the kernel rounds p to bf16 before p @ V (as the TPU kernel
        # does), the plain version keeps f32 p: ~2^-8 relative on values of
        # size ~|v| <= 5; f32: summation order only
        tol = 5 * 2 * BF16_EPS if dt == torch.bfloat16 else 1e-5
        good = err <= tol and math.isfinite(err)
        ok &= good
        rec = {"kernel": "paged_decode", "dtype": str(dt).split(".")[-1],
               "softcap": cap, "lengths": dec_lengths, "max_abs_err": err,
               "tol": tol, "ok": good}
        if timed:
            rec["ms"] = timer(lambda: ops.paged_attention(
                q, ka, va, tables, lens))
            rec["plain_ms"] = timer(lambda: paged_decode_plain(
                q, ka, va, tables, lens, scale=scale))
            rows = sum(-(-n // bs) * bs for n in dec_lengths)
            flops = 2.0 * H * 2 * hd * sum(dec_lengths)
            rec["bound_ms"], rec["bound_by"] = attn_bound_ms(
                rows, KVH, hd, 2 * q.numel() * 2, flops)
            # no PyTorch call reads K/V through a page table: SDPA over the
            # same K/V gathered contiguous beforehand is a yardstick only
            rec["library_ms"] = None
            rec["sdpa_gathered_ms"] = timer(gathered_sdpa(
                q, ka, va, tables, lens, scale))
            rec["plan"] = _decode_plan(8, KVH, G, tables.shape[1], bs, hd,
                                       hd, 2, sms)._asdict()
        report["paged"].append(rec)
        log(f"  paged_decode  {rec['dtype']} cap={cap}: max_abs_err "
            f"{err:.3e} (tol {tol:.1e}) {'ok' if good else 'FAIL'}"
            + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms"
               f" bound {rec['bound_ms']:.4f} ms, SDPA over K/V gathered "
               f"beforehand {rec['sdpa_gathered_ms']:.4f} ms; plan "
               f"{rec['plan']['splits']} splits, "
               f"{rec['plan']['splits'] * rec['plan']['units']} CTAs"
               if timed else ""))

        lengths = [s + c for s, c in zip(starts, chunks)]
        ka, va, tables, lens = paged_inputs(torch, gen, 8, KVH, G, hd, bs,
                                            lengths, dt)
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        C = 64
        q = torch.randn((8, C, H, hd), generator=gen, device="cuda").to(dt)
        out = ops.paged_prefill_attention(q, ka, va, tables, st, lens,
                                          logit_cap=cap)
        plain = paged_prefill_plain(q, ka, va, tables, st, lens,
                                    scale=scale, logit_cap=cap)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        good = err <= tol and math.isfinite(err)
        ok &= good
        rec = {"kernel": "paged_prefill", "dtype": str(dt).split(".")[-1],
               "softcap": cap, "starts": starts, "chunks": chunks,
               "max_abs_err": err, "tol": tol, "ok": good}
        if timed:
            rec["ms"] = timer(lambda: ops.paged_prefill_attention(
                q, ka, va, tables, st, lens))
            rec["plain_ms"] = timer(lambda: paged_prefill_plain(
                q, ka, va, tables, st, lens, scale=scale))
            rows = sum(-(-n // bs) * bs for n in lengths)
            pairs = sum(min(s + r + 1, s + c) for s, c in zip(starts, chunks)
                        for r in range(c))
            flops = 2.0 * H * 2 * hd * pairs
            rec["bound_ms"], rec["bound_by"] = attn_bound_ms(
                rows, KVH, hd, 2 * q.numel() * 2, flops)
            # as for decode: SDPA over K/V gathered beforehand, masked to
            # the lengths and the causal offset, is a yardstick only
            rec["library_ms"] = None
            rec["sdpa_gathered_ms"] = timer(gathered_sdpa_prefill(
                q, ka, va, tables, st, lens, scale))
        rec["plan"] = _attn_plan(8, C * G, KVH, tables.shape[1], bs, hd, hd,
                                 q.element_size(), sms,
                                 prefill=True)._asdict()
        report["paged"].append(rec)
        log(f"  paged_prefill {rec['dtype']} cap={cap}: max_abs_err "
            f"{err:.3e} (tol {tol:.1e}) {'ok' if good else 'FAIL'}; plan "
            f"{plan_text(rec['plan'])}"
            + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms"
               f" bound {rec['bound_ms']:.4f} ms, SDPA over K/V gathered "
               f"beforehand {rec['sdpa_gathered_ms']:.4f} ms"
               if timed else ""))

    # hd 128 (the registry's qwen2-moe, deepseek-coder, command-r-plus),
    # bf16, untimed: the kernel's 128-wide form at the same chunks
    ka, va, tables, lens = paged_inputs(torch, gen, 8, KVH, G, 128, bs,
                                        lengths, torch.bfloat16)
    q = torch.randn((8, 64, H, 128), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    out = ops.paged_prefill_attention(q, ka, va, tables, st, lens)
    plain = paged_prefill_plain(q, ka, va, tables, st, lens,
                                scale=128 ** -0.5)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    tol = 5 * 2 * BF16_EPS
    good = err <= tol and math.isfinite(err)
    ok &= good
    plan = _attn_plan(8, 64 * G, KVH, tables.shape[1], bs, 128, 128, 2, sms,
                      prefill=True)
    report["paged"].append({
        "kernel": "paged_prefill", "case": "hd 128", "dtype": "bfloat16",
        "starts": starts, "chunks": chunks, "max_abs_err": err, "tol": tol,
        "ok": good, "plan": plan._asdict()})
    log(f"  paged_prefill bf16 hd 128: max_abs_err {err:.3e} (tol "
        f"{tol:.1e}) {'ok' if good else 'FAIL'}; plan "
        f"{plan_text(plan._asdict())}")

    # phase 10's verify shape: C = spec_k + 1 = 5 rows a lane, chunks 1-5
    # at kv offsets off the page and 64-row tile boundaries (lengths to
    # 545), bf16, timed beside its bound and the SDPA yardstick
    C = SPEC_K + 1
    lengths = [s + c for s, c in zip(VERIFY_STARTS, VERIFY_CHUNKS)]
    ka, va, tables, lens = paged_inputs(torch, gen, 8, KVH, G, hd, bs,
                                        lengths, torch.bfloat16)
    st = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device="cuda")
    q = torch.randn((8, C, H, hd), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    a = (q, ka, va, tables, st, lens)
    out = ops.paged_prefill_attention(*a)
    plain = paged_prefill_plain(*a, scale=scale)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    good = err <= tol and math.isfinite(err)
    ok &= good
    plan = _attn_plan(8, C * G, KVH, tables.shape[1], bs, hd, hd, 2, sms,
                      prefill=True)
    rows = sum(-(-n // bs) * bs for n in lengths)
    pairs = sum(s + r + 1 for s, c in zip(VERIFY_STARTS, VERIFY_CHUNKS)
                for r in range(c))
    bound, by = attn_bound_ms(rows, KVH, hd, 2 * q.numel() * 2,
                              2.0 * H * 2 * hd * pairs)
    rec = {"kernel": "paged_prefill", "case": "spec verify",
           "dtype": "bfloat16", "starts": VERIFY_STARTS,
           "chunks": VERIFY_CHUNKS, "max_abs_err": err, "tol": tol,
           "ok": good, "plan": plan._asdict(),
           "case_ms": timer(lambda: ops.paged_prefill_attention(*a)),
           "plain_ms": timer(lambda: paged_prefill_plain(
               *a, scale=scale)),
           "sdpa_gathered_ms": timer(gathered_sdpa_prefill(*a, scale)),
           "bound_ms": bound, "bound_by": by}
    report["paged"].append(rec)
    log(f"  paged_prefill bf16 spec verify (S=8, C={C}, chunks "
        f"{VERIFY_CHUNKS}, lengths to {max(lengths)}): max_abs_err "
        f"{err:.3e} (tol {tol:.1e}) {'ok' if good else 'FAIL'}; plan "
        f"{plan_text(plan._asdict())}  kernel {rec['case_ms']:.4f} ms "
        f"plain {rec['plain_ms']:.4f} ms bound {bound:.5f} ms ({by}), SDPA "
        f"over K/V gathered beforehand {rec['sdpa_gathered_ms']:.4f} ms")

    # the split-KV plan's edges, bf16, through decode and decode-lse: lengths
    # on and across the split boundaries (8 pages, 128 rows, a split here),
    # one lane ending inside the first split, one lane of 8192 rows
    tol = 5 * 2 * BF16_EPS
    for case, lengths in (
            ("split boundaries", [127, 128, 129, 255, 256, 257, 383, 545]),
            ("inside the first split", [3, 300, 545, 411, 250, 129, 64, 500]),
            ("long context", [8192])):
        S = len(lengths)
        ka, va, tables, lens = paged_inputs(torch, gen, S, KVH, G, hd, bs,
                                            lengths, torch.bfloat16)
        q = torch.randn((S, H, hd), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        a = (q, ka, va, tables, lens)
        plan = _decode_plan(S, KVH, G, tables.shape[1], bs, hd, hd, 2, sms)
        out = ops.paged_attention(*a)
        o, m, l = paged_decode_lse_cuda(*a, scale=scale)
        wo, wm, wl = paged_decode_lse_plain(*a, scale=scale)
        plain = paged_decode_plain(*a, scale=scale)
        torch.cuda.synchronize()
        err = max((out.float() - plain.float()).abs().max().item(),
                  (o.float() - wo.float()).abs().max().item())
        m_err = ((m - wm).abs() / (1 + wm.abs())).max().item()
        l_err = ((l - wl).abs() / (1 + wl)).max().item()
        good = (err <= tol and m_err <= 1e-4 and l_err <= 1e-4
                and math.isfinite(err))
        ok &= good
        rows = sum(-(-n // bs) * bs for n in lengths)
        bound, by = attn_bound_ms(rows, KVH, hd, 2 * q.numel() * 2,
                                  2.0 * H * 2 * hd * sum(lengths))
        rec = {"kernel": "paged_decode", "case": case, "dtype": "bfloat16",
               "lengths": lengths, "max_abs_err": err, "tol": tol,
               "m_rel_err": m_err, "l_rel_err": l_err, "ml_tol": 1e-4,
               "ok": good, "plan": plan._asdict(),
               "case_ms": timer(lambda: ops.paged_attention(*a)),
               "lse_ms": timer(lambda: paged_decode_lse_cuda(*a,
                                                             scale=scale)),
               "plain_ms": timer(lambda: paged_decode_plain(
                   *a, scale=scale)),
               "sdpa_gathered_ms": timer(gathered_sdpa(*a, scale)),
               "bound_ms": bound, "bound_by": by}
        report["paged"].append(rec)
        log(f"  paged_decode  bf16 {case} (S={S}, W={tables.shape[1]}): "
            f"max_abs_err {err:.3e} (tol {tol:.1e}), lse m/l rel err "
            f"{m_err:.1e}/{l_err:.1e} (tol 1e-4) {'ok' if good else 'FAIL'}"
            f"  plan {plan.splits} splits x {plan.units} = {plan.ctas} CTAs"
            f" of {plan.warps} warps: kernel {rec['case_ms']:.4f} ms "
            f"(lse {rec['lse_ms']:.4f}) plain {rec['plain_ms']:.4f} ms "
            f"SDPA over K/V gathered beforehand "
            f"{rec['sdpa_gathered_ms']:.4f} ms bound {bound:.5f} ms")
    return ok


def cascade_inputs(torch, gen, dtype, KVH, G, hd, bs):
    """The cascade kernels at full width: 8 lanes, a 24-page (384-row)
    shared prefix padded to 32 with the last id, one lane outside the
    group (lane 6), ragged unique lengths including 0.  Also returns each
    lane's full table (prefix pages, then its own) for the one-pass
    comparison."""
    S, P = 8, 24
    prefix_lens = [P * bs] * S
    prefix_lens[6] = 0
    ulens = [0, 1, 15, 16, 17, 100, 128, 129]
    uw = max(-(-n // bs) for n in ulens)
    nxt, utables, full = P, [], []
    for s in range(S):
        n = -(-ulens[s] // bs)
        own = list(range(nxt, nxt + n))
        nxt += n
        row = own or [0]
        utables.append(row + [row[-1]] * (uw - len(row)))
        full.append(list(range(prefix_lens[s] // bs)) + own)
    W = max(len(r) for r in full)
    full = [r + [r[-1]] * (W - len(r)) for r in full]
    i32 = dict(dtype=torch.int32, device="cuda")
    k = torch.randn((nxt + 1, bs, KVH, hd), generator=gen, device="cuda")
    v = torch.randn((nxt + 1, bs, KVH, hd), generator=gen, device="cuda")
    return dict(
        q=torch.randn((S, KVH * G, hd), generator=gen,
                      device="cuda").to(dtype),
        k=k.to(dtype), v=v.to(dtype),
        prefix_pages=torch.tensor(list(range(P)) + [P - 1] * 8, **i32),
        prefix_lens=torch.tensor(prefix_lens, **i32),
        utables=torch.tensor(utables, **i32),
        ulens=torch.tensor(ulens, **i32),
        full=torch.tensor(full, **i32),
        lens=torch.tensor([a + b for a, b in zip(prefix_lens, ulens)],
                          **i32),
        plens=prefix_lens, ulens_list=ulens)


def check_cascade(torch, report, timer, cfg):
    """Both cascade kernels against their plain versions: o within the
    attention tolerance, (m, l) within 1e-4 relative (f32 summation
    order), and the empty rows (a lane of unique length 0, the lane
    outside the group) exactly (0, -1e30, 0); then ops.shared_paged_
    attention (kernels + merge) against ops.paged_attention (kernel) over
    the full tables."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attn import (
        NEG, _attn_plan, paged_decode_lse_plain, paged_decode_lse_cuda,
        paged_prefix_cuda, paged_prefix_plain)
    from repro_torch.launch.bench_decode import gathered_sdpa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    KVH, H, hd, bs = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for dt, cap, timed in ((torch.bfloat16, 0.0, True),
                           (torch.float32, 0.0, False),
                           (torch.bfloat16, 30.0, False),
                           (torch.float32, 30.0, False)):
        x = cascade_inputs(torch, gen, dt, KVH, G, hd, bs)
        a = (x["q"], x["k"], x["v"])
        tol = 5 * 2 * BF16_EPS if dt == torch.bfloat16 else 1e-5
        phases = (
            ("paged_prefix", 6,
             lambda: paged_prefix_cuda(*a, x["prefix_pages"],
                                       x["prefix_lens"], scale=scale,
                                       logit_cap=cap),
             lambda: paged_prefix_plain(
                 *a, x["prefix_pages"], x["prefix_lens"], scale=scale,
                 logit_cap=cap),
             # rows the prefix phase needs: the longest prefix, read once
             max(x["plens"]), sum(x["plens"])),
            ("paged_decode_lse", 0,
             lambda: paged_decode_lse_cuda(*a, x["utables"], x["ulens"],
                                           scale=scale, logit_cap=cap),
             lambda: paged_decode_lse_plain(
                 *a, x["utables"], x["ulens"], scale=scale, logit_cap=cap),
             sum(-(-n // bs) * bs for n in x["ulens_list"]),
             sum(x["ulens_list"])))
        for name, empty_lane, kernel, plain_fn, rows, pairs in phases:
            got, want = kernel(), plain_fn()
            torch.cuda.synchronize()
            err = (got[0].float() - want[0].float()).abs().max().item()
            m_err = ((got[1] - want[1]).abs() / (1 + want[1].abs())) \
                .max().item()
            l_err = ((got[2] - want[2]).abs() / (1 + want[2])).max().item()
            empty = bool((got[0][empty_lane] == 0).all()
                         and (got[1][empty_lane] == NEG).all()
                         and (got[2][empty_lane] == 0).all())
            good = (err <= tol and m_err <= 1e-4 and l_err <= 1e-4
                    and empty and math.isfinite(err))
            ok &= good
            rec = {"kernel": name, "dtype": str(dt).split(".")[-1],
                   "softcap": cap, "prefix_lens": x["plens"],
                   "unique_lens": x["ulens_list"], "max_abs_err": err,
                   "tol": tol, "m_rel_err": m_err, "l_rel_err": l_err,
                   "ml_tol": 1e-4, "empty_lane_exact": empty, "ok": good}
            if timed:
                rec["ms"] = timer(kernel)
                rec["plain_ms"] = timer(plain_fn)
                io = 2 * x["q"].numel() * 2 + 2 * x["q"].shape[0] * H * 4
                flops = 2.0 * H * 2 * hd * pairs
                rec["bound_ms"], rec["bound_by"] = attn_bound_ms(
                    rows, KVH, hd, io, flops)
                rec["library_ms"] = None
                if name == "paged_decode_lse":   # a yardstick only
                    rec["sdpa_gathered_ms"] = timer(gathered_sdpa(
                        *a, x["utables"], x["ulens"], scale))
            if name == "paged_prefix":
                rec["plan"] = _attn_plan(
                    1, x["q"].shape[0] * G, KVH, x["prefix_pages"].shape[0],
                    bs, hd, hd, x["q"].element_size(), sms)._asdict()
            report["paged"].append(rec)
            log(f"  {name:<16} {rec['dtype']} cap={cap}: max_abs_err "
                f"{err:.3e} (tol {tol:.1e}), m/l rel err {m_err:.1e}/"
                f"{l_err:.1e} (tol 1e-4), empty lane "
                f"{'exact' if empty else 'WRONG'} "
                f"{'ok' if good else 'FAIL'}"
                + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f}"
                   f" ms bound {rec['bound_ms']:.5f} ms" if timed else "")
                + (f", SDPA over K/V gathered beforehand "
                   f"{rec['sdpa_gathered_ms']:.4f} ms"
                   if "sdpa_gathered_ms" in rec else "")
                + (f"; plan {plan_text(rec['plan'])}" if "plan" in rec
                   else ""))
        cascade = ops.shared_paged_attention(
            *a, x["utables"], x["ulens"], x["prefix_pages"],
            x["prefix_lens"], logit_cap=cap)
        whole = ops.paged_attention(*a, x["full"], x["lens"], logit_cap=cap)
        torch.cuda.synchronize()
        err = (cascade.float() - whole.float()).abs().max().item()
        good = err <= tol and math.isfinite(err) and cascade.dtype == dt
        ok &= good
        report["paged"].append({
            "kernel": "shared_paged_attention vs paged_attention",
            "dtype": str(dt).split(".")[-1], "softcap": cap,
            "max_abs_err": err, "tol": tol, "ok": good})
        log(f"  cascade (prefix + lse + merge) vs one paged decode over the "
            f"full tables, {str(dt).split('.')[-1]} cap={cap}: max_abs_err "
            f"{err:.3e} (tol {tol:.1e}) {'ok' if good else 'FAIL'}")

    # hd 128, bf16, untimed: the prefix kernel's 128-wide form
    x = cascade_inputs(torch, gen, torch.bfloat16, KVH, G, 128, bs)
    a = (x["q"], x["k"], x["v"], x["prefix_pages"], x["prefix_lens"])
    got = paged_prefix_cuda(*a, scale=128 ** -0.5)
    want = paged_prefix_plain(*a, scale=128 ** -0.5)
    torch.cuda.synchronize()
    tol = 5 * 2 * BF16_EPS
    err = (got[0].float() - want[0].float()).abs().max().item()
    m_err = ((got[1] - want[1]).abs() / (1 + want[1].abs())).max().item()
    l_err = ((got[2] - want[2]).abs() / (1 + want[2])).max().item()
    empty = bool((got[0][6] == 0).all() and (got[1][6] == NEG).all()
                 and (got[2][6] == 0).all())
    good = (err <= tol and m_err <= 1e-4 and l_err <= 1e-4 and empty
            and math.isfinite(err))
    ok &= good
    plan = _attn_plan(1, x["q"].shape[0] * G, KVH,
                      x["prefix_pages"].shape[0], bs, 128, 128, 2, sms)
    report["paged"].append({
        "kernel": "paged_prefix", "case": "hd 128", "dtype": "bfloat16",
        "prefix_lens": x["plens"], "max_abs_err": err, "tol": tol,
        "m_rel_err": m_err, "l_rel_err": l_err, "ml_tol": 1e-4,
        "empty_lane_exact": empty, "ok": good, "plan": plan._asdict()})
    log(f"  paged_prefix     bf16 hd 128: max_abs_err {err:.3e} (tol "
        f"{tol:.1e}), m/l rel err {m_err:.1e}/{l_err:.1e} (tol 1e-4), empty "
        f"lane {'exact' if empty else 'WRONG'} {'ok' if good else 'FAIL'}; "
        f"plan {plan_text(plan._asdict())}")
    return ok


def bank_cases(dcfg):
    """(site, E, M, K, N, head_view) of every bank GEMM on phase 6's path:
    the expert banks (E = 256 at M = 8 slots x capacity 4, at decode and
    prefill alike) and the MLA head banks (E = 128 heads at M = 8 decode
    rows and 8 x 64 prefill rows), whose weights are strided views of
    W_UK / W_UV."""
    from repro_torch.models.moe import padded_num_experts, row_capacity
    m, H, d = dcfg.mla, dcfg.num_heads, dcfg.d_model
    E, f = padded_num_experts(dcfg), dcfg.moe.d_ff_expert
    out = []
    for M in sorted({DS_SLOTS * row_capacity(1, dcfg),     # decode rows
                     DS_SLOTS * row_capacity(64, dcfg)}):  # chunk rows
        out += [("moe.expert.gate/up", E, M, d, f, False),
                ("moe.expert.down", E, M, f, d, False)]
    for M in (DS_SLOTS, DS_SLOTS * 64):
        out += [("layer.mla.q_absorb", H, M, m.qk_nope_head_dim,
                 m.kv_lora_rank, True),
                ("layer.mla.v_mix", H, M, m.kv_lora_rank, m.v_head_dim,
                 True)]
    return out


def check_banks(torch, report, timer, dcfg, dispatcher, cases=None,
                path="6"):
    """The bank GEMM (one launch per bank) against its plain version at
    every bank shape of phase 6 (or the given ``cases`` of phase ``path``),
    in every mode, bf16 (timed, with ``torch.bmm`` as the library
    yardstick) and, for phase 6, f32 at one expert and one head shape;
    tolerance as the 2-D GEMM's, per bank member."""
    from repro_torch.core.hw import DATAFLOW_NAMES
    from repro_torch.dispatch.executor import _clamped_blocks
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    ok = True
    if cases is None:
        cases = [c + (torch.bfloat16, True) for c in bank_cases(dcfg)]
        ex, hd = cases[0], cases[-4]
        cases += [("f32 expert (E=16)", 16) + ex[2:6]
                  + (torch.float32, False),
                  ("f32 q_absorb",) + hd[1:6] + (torch.float32, False)]
    else:
        cases = [c + (torch.bfloat16, True) for c in cases]
    for site, E, M, K, N, view, dt, timed in cases:
        a = torch.randn((E, M, K), generator=gen, device="cuda").to(dt)
        if view:                   # W (N, E*K) read as (E, K, N), in place
            w = (torch.randn((N, E * K), generator=gen, device="cuda")
                 * (1.0 / math.sqrt(K))).to(dt)
            b = w.reshape(N, E, K).permute(1, 2, 0)
        else:
            b = torch.empty((E, K, N), dtype=dt, device="cuda")
            for e in range(E):     # one member at a time: no 15 GB f32 draw
                b[e] = torch.randn((K, N), generator=gen, device="cuda") \
                    * (1.0 / math.sqrt(K))
        cfg_t = dispatcher.recommend(M, K, N)
        bk = _clamped_blocks(cfg_t, M, K, N)[2]
        library_ms = None
        for mode in (0, 1, 2):
            def kernel():
                return ops.rsa_gemm(a, b, block_k=bk, mode=mode)
            out = kernel()
            plain = rsa_gemm_plain(a, b, block_k=bk, mode=mode)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            K_mag = max((a[e:e + 32].abs().float() @
                         b[e:e + 32].abs().float()).max().item()
                        for e in range(0, E, 32))
            tol = K * F32_EPS * K_mag
            if dt == torch.bfloat16:
                chunks = 1 if mode == 0 else -(-K // bk)
                tol += (chunks + 1) * BF16_EPS * plain.abs().max().item()
            good = err <= tol and math.isfinite(err)
            ok &= good
            rec = {"site": site, "path": path, "E": E, "M": M, "K": K,
                   "N": N, "dtype": str(dt).split(".")[-1], "head_view": view,
                   "bk": bk, "mode": DATAFLOW_NAMES[mode],
                   "recommended": timed and mode == cfg_t.mode,
                   "max_abs_err": err, "tol": tol, "ok": good}
            if rec["recommended"]:
                rec["ms"] = timer(kernel)
                rec["plain_ms"] = timer(lambda: rsa_gemm_plain(
                    a, b, block_k=bk, mode=mode))
                rec["library_ms"] = library_ms = timer(
                    lambda: torch.bmm(a, b))
                nbytes = (E * M * K + E * K * N + E * M * N) * 2
                t_bytes = nbytes / PEAK_BYTES * 1e3
                t_ops = 2.0 * E * M * N * K / PEAK_BF16_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else \
                    "operations"
                rec["key"] = (E, M, K, N, mode)
            report["bank"].append(rec)
            log(f"  rsa_gemm bank {site:<20} {E}x({M}x{K}x{N}) "
                f"{rec['mode']} bk={bk} {rec['dtype']}"
                f"{' view' if view else ''}: max_abs_err {err:.3e} (tol "
                f"{tol:.3e}) {'ok' if good else 'FAIL'}"
                + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f}"
                   f" ms bmm {library_ms:.4f} ms bound {rec['bound_ms']:.4f}"
                   f" ms  [phase {path} path]" if rec["recommended"] else ""))
        ok &= psum_bitwise(torch, lambda mode: ops.rsa_gemm(
            a, b, block_k=bk, mode=mode), f"bank {site} {E}x({M}x{K}x{N})",
            rec)
        del a, b
        torch.cuda.empty_cache()
    return ok


def mla_inputs(torch, gen, lengths, r, rd, bs, dtype):
    """Random latent arenas + per-lane tables over disjoint pages (dead
    columns repeat the last live id; a length-0 lane gets an all-zero
    row)."""
    S = len(lengths)
    W = max(1, max(-(-n // bs) for n in lengths))
    tables = torch.zeros((S, W), dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        nblk = -(-n // bs)
        if nblk:
            tables[i, :nblk] = torch.arange(nxt, nxt + nblk)
            tables[i, nblk:] = nxt + nblk - 1
            nxt += nblk
    ckv = torch.randn((nxt + 1, bs, r), generator=gen, device="cuda")
    kr = torch.randn((nxt + 1, bs, rd), generator=gen, device="cuda")
    return (ckv.to(dtype), kr.to(dtype), tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def mla_bound_ms(rows, r, rd, io_bytes, flops):
    """Least time: each live latent row read once (c_kv and k_rope, bf16),
    q in and o_lat out once; or the score + mix FLOPs at the bf16 peak."""
    t_bytes = (rows * (r + rd) * 2 + io_bytes) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def mla_plan_text(plan) -> str:
    """One line of an ``_mla_plan``: splits x units = CTAs of rows, dv."""
    return (f"{plan['splits']} splits x {plan['units']} = "
            f"{plan['splits'] * plan['units']} CTAs of {plan['rows']} rows, "
            f"dv {plan['dv']}")


def check_mla(torch, report, timer, dcfg):
    """Both MLA kernels against their plain versions at full width (8
    lanes, 128 heads, r = 512, rd = 64, pages of 16, scale 1/sqrt(192)):
    decode over ragged lengths 0-545 (a length-0 lane, page boundaries),
    prefill of a 64-row chunk at ragged starts with an empty lane, each
    with its plan; in bf16 (timed, beside SDPA over the latents gathered
    beforehand, with the SDPA backends that refuse these widths) a forced
    split count run twice, bitwise, and one timed lane of 4096 rows."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_mla import (
        _mla_plan, paged_mla_decode_plain, paged_mla_decode_cuda,
        paged_mla_prefill_plain)
    from repro_torch.launch.bench_mla import gathered_mla_sdpa, sdpa_backends
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    m, H, bs, S = dcfg.mla, dcfg.num_heads, 16, 8
    r, rd = m.kv_lora_rank, m.qk_rope_head_dim
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(qk)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    dec_lengths = [0, 1, 15, 16, 17, 200, 400, 545]
    starts = [0, 0, 64, 100, 0, 448, 0, 10]
    chunks = [64, 10, 64, 37, 0, 64, 1, 64]
    C = 64

    def yardstick(rec, sdpa):
        """SDPA over latents gathered beforehand, with the backends that
        take these widths; None where every backend refuses."""
        rec["library_ms"] = None
        rec["sdpa_backends"] = sdpa_backends(sdpa)
        try:
            rec["sdpa_gathered_ms"] = timer(sdpa)
        except RuntimeError as e:
            rec["sdpa_gathered_ms"] = None
            log(f"  SDPA refused the MLA widths: {str(e).splitlines()[0]}")
        refused = [b for b, v in rec["sdpa_backends"].items() if v != "ok"]
        return (f", SDPA over latents gathered beforehand "
                + (f"{rec['sdpa_gathered_ms']:.4f} ms"
                   if rec["sdpa_gathered_ms"] is not None else "None")
                + f" (refused by {', '.join(refused) or 'none'})")

    for dt, timed in ((torch.bfloat16, True), (torch.float32, False)):
        # bf16: p rounded to bf16 before p @ c_kv (as the TPU kernel does)
        # against the plain version's f32 p, on outputs |o| <~ 5, plus the
        # output's own bf16 rounding; f32: 576-term score sums and the
        # softmax in another order, ~sqrt(576) * 2^-24 on partial sums ~30
        tol = 5 * 2 * BF16_EPS if dt == torch.bfloat16 else 1e-4
        ckv, kr, tables, lens = mla_inputs(torch, gen, dec_lengths, r, rd,
                                           bs, dt)
        qa = torch.randn((S, H, r), generator=gen, device="cuda").to(dt)
        qr = torch.randn((S, H, rd), generator=gen, device="cuda").to(dt)
        plan = _mla_plan(S, H, tables.shape[1], bs, r, rd, qa.element_size(),
                         sms)

        def dec():
            return ops.mla_paged_attention(qa, qr, ckv, kr, tables, lens,
                                           qk_dim=qk)

        def dec_plain():
            return paged_mla_decode_plain(qa, qr, ckv, kr, tables, lens,
                                          scale=scale)
        out, plain = dec(), dec_plain()
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        empty = bool((out[0] == 0).all())
        good = err <= tol and math.isfinite(err) and empty
        ok &= good
        rec = {"kernel": "paged_mla_decode", "dtype": str(dt).split(".")[-1],
               "lengths": dec_lengths, "max_abs_err": err, "tol": tol,
               "empty_lane_zero": empty, "plan": plan._asdict(), "ok": good}
        extra = ""
        if timed:
            rec["ms"] = timer(dec)
            rec["plain_ms"] = timer(dec_plain)
            rows = sum(-(-n // bs) * bs for n in dec_lengths)
            flops = 2.0 * H * (r + rd + r) * sum(dec_lengths)
            io = (qa.numel() + qr.numel() + out.numel()) * 2
            rec["bound_ms"], rec["bound_by"] = mla_bound_ms(rows, r, rd, io,
                                                            flops)
            extra = yardstick(rec, gathered_mla_sdpa(qa, qr, ckv, kr, tables,
                                                     lens, scale))
            # a forced split count: the ordered merge, bitwise run to run
            forced = _mla_plan(S, H, tables.shape[1], bs, r, rd, 2, sms,
                               splits=3)
            a = (qa, qr, ckv, kr, tables, lens)
            f1 = paged_mla_decode_cuda(*a, scale=scale, plan=forced)
            f2 = paged_mla_decode_cuda(*a, scale=scale, plan=forced)
            torch.cuda.synchronize()
            f_err = (f1.float() - plain.float()).abs().max().item()
            bitwise = bool(torch.equal(f1, f2))
            f_good = bitwise and f_err <= tol and bool((f1[0] == 0).all())
            ok &= f_good
            rec["forced_splits"] = {"plan": forced._asdict(),
                                    "max_abs_err": f_err,
                                    "run_to_run_bitwise": bitwise,
                                    "ok": f_good}
        report["mla"].append(rec)
        log(f"  paged_mla_decode  {rec['dtype']}: max_abs_err {err:.3e} "
            f"(tol {tol:.1e}), length-0 lane {'zero' if empty else 'WRONG'}"
            f" {'ok' if good else 'FAIL'}; plan {mla_plan_text(rec['plan'])}"
            + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms"
               f" bound {rec['bound_ms']:.4f} ms" + extra if timed else ""))
        if timed:
            f = rec["forced_splits"]
            log(f"  paged_mla_decode  bf16 forced "
                f"{mla_plan_text(f['plan'])}: max_abs_err "
                f"{f['max_abs_err']:.3e}, run to run bitwise "
                f"{f['run_to_run_bitwise']} {'ok' if f['ok'] else 'FAIL'}")

        lengths = [a + b for a, b in zip(starts, chunks)]
        ckv, kr, tables, lens = mla_inputs(torch, gen, lengths, r, rd, bs,
                                           dt)
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        qa = torch.randn((S, C, H, r), generator=gen, device="cuda").to(dt)
        qr = torch.randn((S, C, H, rd), generator=gen, device="cuda").to(dt)
        plan = _mla_plan(S, C * H, tables.shape[1], bs, r, rd,
                         qa.element_size(), sms)

        def pre():
            return ops.mla_paged_prefill_attention(qa, qr, ckv, kr, tables,
                                                   st, lens, qk_dim=qk)

        def pre_plain():
            return paged_mla_prefill_plain(
                qa, qr, ckv, kr, tables, st, lens, scale=scale)
        out, plain = pre(), pre_plain()
        torch.cuda.synchronize()
        live = torch.arange(C, device="cuda")[None, :] < \
            torch.tensor(chunks, device="cuda")[:, None]
        err = (out.float() - plain.float()).abs()[live].max().item()
        empty = bool((out[4] == 0).all())
        good = err <= tol and math.isfinite(err) and empty
        ok &= good
        rec = {"kernel": "paged_mla_prefill", "dtype": str(dt).split(".")[-1],
               "starts": starts, "chunks": chunks, "max_abs_err": err,
               "tol": tol, "empty_lane_zero": empty, "plan": plan._asdict(),
               "ok": good}
        extra = ""
        if timed:
            rec["ms"] = timer(pre)
            rec["plain_ms"] = timer(pre_plain)
            rows = sum(-(-n // bs) * bs for n in lengths)
            # each live chunk row against its causal columns
            pairs = sum(s + c + 1 for s, n in zip(starts, chunks)
                        for c in range(n))
            flops = 2.0 * H * (r + rd + r) * pairs
            io = (qa.numel() + qr.numel() + out.numel()) * 2
            rec["bound_ms"], rec["bound_by"] = mla_bound_ms(rows, r, rd, io,
                                                            flops)
            extra = yardstick(rec, gathered_mla_sdpa(qa, qr, ckv, kr, tables,
                                                     lens, scale, st))
        report["mla"].append(rec)
        log(f"  paged_mla_prefill {rec['dtype']}: max_abs_err {err:.3e} "
            f"(tol {tol:.1e}), empty lane {'zero' if empty else 'WRONG'} "
            f"{'ok' if good else 'FAIL'}; plan {mla_plan_text(rec['plan'])}"
            + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms"
               f" bound {rec['bound_ms']:.4f} ms" + extra if timed else ""))

    # one lane of 4096 rows, bf16: the split plan of a long context
    tol = 5 * 2 * BF16_EPS
    ckv, kr, tables, lens = mla_inputs(torch, gen, [4096], r, rd, bs,
                                       torch.bfloat16)
    qa = torch.randn((1, H, r), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    qr = torch.randn((1, H, rd), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    a = (qa, qr, ckv, kr, tables, lens)
    plan = _mla_plan(1, H, tables.shape[1], bs, r, rd, 2, sms)
    out = ops.mla_paged_attention(*a, qk_dim=qk)
    plain = paged_mla_decode_plain(*a, scale=scale)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    good = err <= tol and math.isfinite(err)
    ok &= good
    bound, by = mla_bound_ms(4096, r, rd, (qa.numel() + qr.numel() +
                                           out.numel()) * 2,
                             2.0 * H * (r + rd + r) * 4096)
    rec = {"kernel": "paged_mla_decode", "case": "one lane of 4096",
           "dtype": "bfloat16", "lengths": [4096], "max_abs_err": err,
           "tol": tol, "ok": good, "plan": plan._asdict(),
           "case_ms": timer(lambda: ops.mla_paged_attention(*a, qk_dim=qk)),
           "plain_ms": timer(lambda: paged_mla_decode_plain(
               *a, scale=scale)),
           "bound_ms": bound, "bound_by": by}
    extra = yardstick(rec, gathered_mla_sdpa(*a, scale))
    report["mla"].append(rec)
    log(f"  paged_mla_decode  bf16 one lane of 4096: max_abs_err {err:.3e}"
        f" (tol {tol:.1e}) {'ok' if good else 'FAIL'}; plan "
        f"{mla_plan_text(rec['plan'])}  kernel {rec['case_ms']:.4f} ms "
        f"plain {rec['plain_ms']:.4f} ms bound {bound:.4f} ms" + extra)
    return ok


def bound_ms(nbytes, flops, peak):
    """(least time, what bounds it): bytes over the memory rate against
    operations over ``peak``."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_flash(torch, report, timer, cfg):
    """The three flash-attention kernels against their plain versions at
    phase 7's attention shape (B = 2, S = 1024, 32 / 8 heads, hd = 64,
    causal, f32), a ragged length (Sq = Skv = 1000), kv rows past every
    query (Sq = 500, Skv = 1000: their dk/dv must be exactly 0), the
    bidirectional form, bf16 (the tensor-core forward, dq and dk/dv) with
    its gradients, and a group of G = 8 (32 / 4
    heads: 8 dk/dv partials a kv head).  The backward kernels are held
    alone: both versions get the kernel forward's lse and delta.  In the
    main, bf16 and G = 8 cases all three kernels run twice and must give
    the same bits; each case logs its plan (``_flash_plan``), and the
    build's registers, spills and SASS FFMA / LDS / HMMA counts of each
    flash kernel are logged first.
    Tolerances are the reference's for its kernel: 2e-6 absolute + 2e-6
    relative (f32 forward), 2e-2 (bf16, its gradients too), 3e-5
    absolute + 1e-3 relative (f32 gradients); lse at 2e-6 in both.  Every case is timed against the plain versions and
    ``scaled_dot_product_attention`` (GQA, forward; its backward through
    autograd computes dq, dk and dv at once), a yardstick the port never
    calls; the main case is the kernel table's."""
    from repro_torch.kernels import _build
    from repro_torch.launch.bench_flash import build_report
    H0, KVH0, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    ok = True
    report["flash_build"] = build_report(_build.build_all())
    for line in report["flash_build"]:
        log(f"  {line}")
    for case in (
            ("main", TRAIN_B, TRAIN_S, TRAIN_S, True, f32, H0, KVH0),
            ("ragged", 2, 1000, 1000, True, f32, H0, KVH0),
            ("kv past every query", 1, 500, 1000, True, f32, H0, KVH0),
            ("bidirectional", TRAIN_B, TRAIN_S, TRAIN_S, False, f32, H0,
             KVH0),
            (P3_BF16, TRAIN_B, TRAIN_S, TRAIN_S, True, bf16, H0, KVH0),
            ("G = 8", TRAIN_B, TRAIN_S, TRAIN_S, True, f32, H0, H0 // 8)):
        rec, good = flash_case(torch, timer, gen, *case, hd, grads=True,
                               twice=case[0] == P3_BF16)
        ok &= good
        rec["main"] = case[0] == "main"
        report["flash"].append(rec)
    torch.cuda.empty_cache()
    return ok


def flash_case(torch, timer, gen, name, B, Sq, Skv, causal, dt, H, KVH,
               hd, hd_v=None, grads=None, twice=False):
    """One case of ``check_flash``: the three kernels against their plain
    versions (the backward pair alone, from the kernel forward's lse and
    delta; f32 unless ``grads``), its plan, each kernel timed beside its
    plain version, SDPA and its bound.  ``hd_v`` (default hd) is v's and
    o's width; ``twice`` runs all three kernels twice and holds the
    second run to the first's bits.  Returns (record, ok)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (
        _call_plan, _half_cols, flash_dkv_cuda, flash_dkv_plain,
        flash_dq_cuda, flash_dq_plain, flash_fwd_cuda, flash_fwd_plain)
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    hd_v = hd_v or hd
    grads = dt == f32 if grads is None else grads
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, Skv, KVH, hd), generator=gen,
                    device="cuda").to(dt)
    v = torch.randn((B, Skv, KVH, hd_v), generator=gen,
                    device="cuda").to(dt)
    plan = _call_plan(q, k, v)
    bq, bk = min(512, Sq), min(512, Skv)
    blocks = dict(causal=causal, scale=scale, bq=bq, bk=bk)
    o, lse = flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
    po, plse = flash_fwd_plain(q, k, v, **blocks)
    rt = 2e-6 if dt == f32 else 2e-2
    res = {"fwd o": (o, po, rt, rt), "fwd lse": (lse, plse, 2e-6, 2e-6)}
    if grads:
        # the reference's gradient tolerance in f32; in bf16 its bf16
        # forward tolerance (ds and the products round to bf16)
        ga, gr = (3e-5, 1e-3) if dt == f32 else (2e-2, 2e-2)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        stats = (q, k, v, do, lse, delta)
        dq = flash_dq_cuda(*stats, causal=causal, scale=scale)
        dk, dv = flash_dkv_cuda(*stats, causal=causal, scale=scale)
        pdq = flash_dq_plain(*stats, **blocks)
        pdk, pdv = flash_dkv_plain(*stats, **blocks)
        res.update({"dq": (dq, pdq, ga, gr), "dk": (dk, pdk, ga, gr),
                    "dv": (dv, pdv, ga, gr)})
    torch.cuda.synchronize()
    errs, good = {}, True
    for key, (got, want, atol, rtol) in res.items():
        diff = (got.float() - want.float()).abs()
        errs[key] = diff.max().item()
        good &= bool((diff <= atol + rtol * want.float().abs()).all()) \
            and math.isfinite(errs[key])
    zeros = None
    if Skv > Sq and causal:
        zeros = bool((dk[:, Sq:] == 0).all() and (dv[:, Sq:] == 0).all())
        good &= zeros
    bitwise = None
    if name in ("main", "G = 8", P14_FLASH) or twice:
        dq2 = flash_dq_cuda(*stats, causal=causal, scale=scale)
        dk2, dv2 = flash_dkv_cuda(*stats, causal=causal, scale=scale)
        o2, lse2 = flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
        bitwise = bool(torch.equal(dq, dq2) and torch.equal(dk, dk2)
                       and torch.equal(dv, dv2) and torch.equal(o, o2)
                       and torch.equal(lse, lse2))
        good &= bitwise
    rec = {"case": name, "B": B, "Sq": Sq, "Skv": Skv, "H": H,
           "KVH": KVH, "hd": hd, "hd_v": hd_v, "causal": causal,
           "dtype": str(dt).split(".")[-1], "plan": plan._asdict(),
           "max_abs_err": errs,
           "tol": {k: (a, r) for k, (_, _, a, r) in res.items()},
           "past_rows_zero": zeros, "run_to_run_bitwise": bitwise,
           "ok": good}
    log(f"  flash {name:<20} B={B} Sq={Sq} Skv={Skv} H={H}/{KVH} "
        f"hd={hd}/{hd_v} "
        f"{rec['dtype']} {'causal' if causal else 'full'}: max_abs_err "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + (f"; dk/dv past every query {'0' if zeros else 'NONZERO'}"
           if zeros is not None else "")
        + (f"; o, lse, dq, dk/dv run to run bitwise {bitwise}"
           if bitwise is not None else "") + f" {'ok' if good else 'FAIL'}")
    wide_f32 = plan.slices > 1 and dt == f32  # all three on CTA pairs
    hk, hv = _half_cols(hd), _half_cols(hd_v)
    pair = (f"each in CTA pairs of {hk} + {hd - hk} / {hv} + {hd_v - hv} "
            f"columns of hd / hd_v, 32-row tiles" if wide_f32 else
            f"{plan.slices} column slice(s)")
    log(f"    plan: forward {plan.fwd_rows} query rows a CTA, "
        f"{plan.fwd_stages} ring stage(s); dq {plan.dq_rows} query rows a "
        f"CTA, {plan.dq_stages} ring stage(s); dk/dv {plan.dkv_rows} kv "
        f"rows a CTA, {plan.dkv_stages} ring stage(s), {plan.heads} "
        f"head(s) a CTA, {plan.parts} partial(s) a kv head; {pair}")
    pairs = B * H * sum(min(r + 1, Skv) if causal else Skv
                        for r in range(Sq))
    es = q.element_size()
    qb, kb, vb = q.numel() * es, k.numel() * es, v.numel() * es
    ob = qb // hd * hd_v                     # o, do
    st = 4 * B * H * Sq                      # one f32 per query row
    peak = PEAK_F32_FLOPS if dt == f32 else PEAK_BF16_FLOPS
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(grads)
                  for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    try:
        out = sdpa()
    except TypeError:                # a torch without enable_gqa
        G = H // KVH
        kt, vt = (t.detach().repeat_interleave(G, dim=1)
                  .requires_grad_(grads) for t in (kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        out = sdpa()
        rec["library"] = "sdpa over k/v expanded to H heads"
    # operations a (query, key) pair: s = q.k and p v in the forward; s,
    # dp = do.v and ds k in dq; s, dv, dp and dk in dk/dv
    timed = {"flash_fwd": (
        lambda: flash_fwd_cuda(q, k, v, causal=causal, scale=scale),
        lambda: flash_fwd_plain(q, k, v, **blocks), sdpa,
        bound_ms(qb + kb + vb + ob + st, 2 * (hd + hd_v) * pairs, peak),
        errs["fwd o"])}
    if grads:
        gout = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), gout,
                                       retain_graph=True)
        timed["flash_dq"] = (
            lambda: flash_dq_cuda(*stats, causal=causal, scale=scale),
            lambda: flash_dq_plain(*stats, **blocks), sdpa_bwd,
            bound_ms(2 * qb + ob + kb + vb + 2 * st,
                     2 * (2 * hd + hd_v) * pairs, peak),
            errs["dq"])
        timed["flash_dkv"] = (
            lambda: flash_dkv_cuda(*stats, causal=causal, scale=scale),
            lambda: flash_dkv_plain(*stats, **blocks), sdpa_bwd,
            bound_ms(qb + ob + 2 * kb + 2 * vb + 2 * st,
                     4 * (hd + hd_v) * pairs, peak),
            max(errs["dk"], errs["dv"]))
    rec["timed"] = {}
    for kname, (kern, plain_fn, lib, (b_ms, b_by), err) in \
            timed.items():
        t = {"ms": timer(kern), "plain_ms": timer(plain_fn),
             "library_ms": timer(lib), "bound_ms": b_ms,
             "bound_by": b_by, "max_abs_err": err}
        rec["timed"][kname] = t
        log(f"    {kname:<9} kernel {t['ms']:.4f} ms plain "
            f"{t['plain_ms']:.4f} ms sdpa {t['library_ms']:.4f} ms "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    del qt, kt, vt, out
    return rec, good


def train_gemm_cases(cfg, sites=None):
    """(site, pass, M, K, N, a_transposed, b_transposed) of every GEMM of
    phase 7's train step (or of ``sites``, (name, K, N) each): each
    site's forward, dx = dy @ w^T and dw = x^T @ dy, at M = batch x seq
    (the unembedding at one loss chunk, tied: w is embed^T)."""
    d, q, kv, ff, V = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                       cfg.vocab_size)
    M = TRAIN_B * TRAIN_S
    if sites is None:
        sites = (("q/o", d, q), ("k/v", d, kv), ("gate/up", d, ff),
                 ("down", ff, d))
    out = []
    for site, m, k, n, tied in (
            *((name, M, k, n, False) for name, k, n in sites),
            ("unembed", TRAIN_B * min(cfg.loss_chunk, TRAIN_S), d, V,
             cfg.tie_embeddings)):
        out += [(site, "fwd", m, k, n, False, tied),
                (site, "dx", m, n, k, False, not tied),
                (site, "dw", k, m, n, True, False)]
    return out


def check_train_gemms(torch, report, cfg, dispatcher, cases=None,
                      key="train_gemm"):
    """Every GEMM of the train step in f32 (phase 7's, or ``cases``,
    recorded under ``report[key]``), its recommended mode and
    blocks, in the layouts the step hands the kernel (dx reads w^T in
    place, dw reads x^T in place), against its plain version within the
    f32 summation bound; timed (5 runs, L2 flushed) beside the plain
    version and ``torch.matmul``, bound by the f32 CUDA-core peak."""
    from repro_torch.core.hw import DATAFLOW_NAMES
    from repro_torch.dispatch.executor import _clamped_blocks
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda, rsa_gemm_plain
    timer = Timer(torch, reps=5)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    ok = True
    for site, pas, M, K, N, at, bt in cases or train_gemm_cases(cfg):
        a = torch.randn((K, M) if at else (M, K), generator=gen,
                        device="cuda")
        a = a.t() if at else a
        b = torch.randn((N, K) if bt else (K, N), generator=gen,
                        device="cuda") * (1.0 / math.sqrt(K))
        b = b.t() if bt else b
        c = dispatcher.recommend(M, K, N)
        _, _, bk = _clamped_blocks(c, M, K, N)
        mode = c.mode

        def kernel():
            return rsa_gemm_cuda(a, b, block_k=bk, mode=mode)
        out = kernel()
        plain = rsa_gemm_plain(a, b, block_k=bk, mode=mode)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        tol = gemm_tolerance(torch, a, b, plain, mode, bk, True)
        good = err <= tol and math.isfinite(err)
        ok &= good
        b_ms, b_by = bound_ms(4.0 * (M * K + K * N + M * N),
                              2.0 * M * N * K, PEAK_F32_FLOPS)
        rec = {"site": site, "pass": pas, "M": M, "K": K, "N": N,
               "a_transposed": at, "b_transposed": bt, "bk": bk,
               "mode": DATAFLOW_NAMES[mode], "max_abs_err": err, "tol": tol,
               "ok": good, "ms": timer(kernel),
               "plain_ms": timer(lambda: rsa_gemm_plain(a, b, block_k=bk,
                                                        mode=mode)),
               "library_ms": timer(lambda: torch.matmul(a, b)),
               "bound_ms": b_ms, "bound_by": b_by, "key": (M, K, N, mode)}
        report[key].append(rec)
        log(f"  rsa_gemm train {site:<8} {pas:<3} {M}x{K}x{N} {rec['mode']} "
            f"bk={bk} f32{' A^T' if at else ''}{' B^T' if bt else ''}: "
            f"max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if good else 'FAIL'}  kernel {rec['ms']:.4f} ms plain "
            f"{rec['plain_ms']:.4f} ms matmul {rec['library_ms']:.4f} ms "
            f"bound {rec['bound_ms']:.4f} ms")
        ok &= psum_bitwise(torch, lambda m: rsa_gemm_cuda(
            a, b, block_k=bk, mode=m), f"train {site} {pas} {M}x{K}x{N}",
            rec)
        del a, b, out, plain
    torch.cuda.empty_cache()
    return ok


def wkv_ops(B, H, K, V, S, chunk):
    """f32 operations of the chunked scan on this data, per (b, h) and
    chunk of lc rows (the last chunk's real rows only): the inter-chunk
    product 2 lc K V; the decay block, 5 K per pair j < t (a subtraction,
    an exp, two products and a sum); A @ v, 2 V a pair; the bonus
    diagonal 3 K + 2 V a row; the cumsum and the two decays, 7 lc K; the
    state update 2 lc K V + 3 K V."""
    ops = 0
    for c0 in range(0, S, chunk):
        lc = min(chunk, S - c0)
        pairs = lc * (lc - 1) // 2
        ops += (2 * lc * K * V + 5 * pairs * K + 2 * pairs * V
                + lc * (3 * K + 2 * V) + 7 * lc * K + 2 * lc * K * V
                + 3 * K * V)
    return B * H * ops


def wkv_bytes(B, H, K, V, S, es):
    """Each input read once and each output written once: r, k, logw, v, u
    and o in the operands' type, state0 and the final state in f32."""
    return (3 * B * S * H * K + 2 * B * S * H * V + H * K) * es + \
        2 * B * H * K * V * 4


def wkv_tolerance(want):
    """f32 dot products summed in another order than the plain version's:
    1e-5 of the output's largest magnitude, at least 1e-5."""
    return 1e-5 * max(1.0, want.abs().max().item())


def check_wkv(torch, report, timer, rcfg):
    """The WKV kernel against its plain version at phase 8's shapes (H =
    32, K = V = 64): the full-width prefill (B = 1, S = 512, chunk 64,
    nonzero state0), a ragged S = 100 padded to the chunk with decays drawn
    over the model's whole clip range (-exp(U(-12, 1)), down to -e: a
    64-row cumsum reaches ~ -174, whose negation overflows exp), the decode
    step (B = 8 slots, S = 1, chunk 1), a one-chunk prefill (B = 1, S =
    64), phase 14c's training forward (B = 2, S = 1024), and the state
    carry ([0:256] then [256:512] with the carried
    state equals one pass); and the linear-attention kernel at BH = 64, S =
    1024, K = V = 64, after one call of its entry point ``ops.linear_attn``
    with the counts at 0 (it is on no model path).  Each line prints the
    call's plan (``_wkv_plan``); each case is timed against its plain
    version (no single PyTorch call computes this recurrence: no library
    time).  The prefill then runs under every forced chunked plan (chain
    folded or launched, V whole or in tiles of 16),
    each within tolerance and bitwise equal to itself run to run."""
    from repro_torch import dispatch
    from repro_torch.kernels import ops
    from repro_torch.kernels.linear_attn import (_wkv_plan,
                                                 linear_attn_plain,
                                                 wkv_bshk_cuda)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plan_str(p):
        if p.variant == "decode":
            return (f"decode, {p.vt} columns a CTA x {p.vsplit} = {p.ctas}"
                    f" CTAs")
        return (f"{p.n} chunks, chain {p.chain}, V tile {p.vt} x "
                f"{p.vsplit} = {p.ctas} inter CTAs")
    H, K = rcfg.d_model // rcfg.ssm.head_dim, rcfg.ssm.head_dim
    V = K
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(B, S, strong):
        if strong:
            lw = -torch.exp(torch.rand((B, S, H, K), generator=gen,
                                       device="cuda") * 13.0 - 12.0)
        else:
            lw = -torch.exp(rn(B, S, H, K) * 0.5 - 2.0)
        return (rn(B, S, H, K), rn(B, S, H, K), rn(B, S, H, V), lw,
                rn(H, K) * 0.1, rn(B, H, K, V) * 0.3)

    def run(args, chunk, mode):
        with dispatch.use(execute=mode):
            return ops.wkv_attention(*args, chunk=chunk)

    ok = True
    for name, B, S, chunk, strong in (
            ("prefill", 1, 512, 64, False),
            ("ragged", 1, 100, 64, True),
            ("decode", 8, 1, 1, False),
            ("one chunk", 1, 64, 64, False),
            ("train", TRAIN_B, TRAIN_S, 64, False)):
        args = inputs(B, S, strong)
        plan = _wkv_plan(B, -(-S // chunk) * chunk, H, K, V, chunk, sms)
        o, sf = run(args, chunk, "kernel")
        po, psf = run(args, chunk, "torch")
        torch.cuda.synchronize()
        err = max((o - po).abs().max().item(), (sf - psf).abs().max().item())
        tol = max(wkv_tolerance(po), wkv_tolerance(psf))
        finite = bool(torch.isfinite(o).all() and torch.isfinite(sf).all())
        good = finite and err <= tol
        ok &= good
        b_ms, b_by = bound_ms(wkv_bytes(B, H, K, V, S, 4),
                              wkv_ops(B, H, K, V, S, chunk), PEAK_F32_FLOPS)
        rec = {"kernel": "wkv_bshk", "case": name, "B": B, "S": S, "H": H,
               "K": K, "V": V, "chunk": chunk, "strong_decays": strong,
               "plan": plan._asdict(),
               "max_abs_err": err, "tol": tol, "finite": finite, "ok": good,
               "ms": timer(lambda: run(args, chunk, "kernel")),
               "plain_ms": timer(lambda: run(args, chunk, "torch")),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        report["wkv"].append(rec)
        log(f"  wkv_bshk {name:<9} B={B} S={S} H={H} K={K} V={V} chunk="
            f"{chunk}{' decays to -e' if strong else ''}: max_abs_err "
            f"{err:.3e} (tol {tol:.3e}) {'ok' if good else 'FAIL'}  kernel "
            f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by})\n    plan: {plan_str(plan)}")
        if name == "prefill":
            forced = [_wkv_plan(B, S, H, K, V, chunk, sms, variant="chunked",
                                chain=c, vt=vt)
                      for c in ("fold", "launch") for vt in (V, 16)]
            po, psf = run(args, chunk, "torch")
            tol = max(wkv_tolerance(po), wkv_tolerance(psf))
            n_ok = 0
            for p in forced:
                a1 = wkv_bshk_cuda(*args, chunk=chunk, plan=p)
                a2 = wkv_bshk_cuda(*args, chunk=chunk, plan=p)
                torch.cuda.synchronize()
                e = max((a1[0] - po).abs().max().item(),
                        (a1[1] - psf).abs().max().item())
                n_ok += e <= tol and all(torch.equal(x, y)
                                         for x, y in zip(a1, a2))
            good = n_ok == len(forced)
            ok &= good
            rec["forced_plans_ok"] = f"{n_ok} of {len(forced)}"
            log(f"    forced plans (chain folded / launched, V tile {V} / "
                f"16): within tol and run to run "
                f"bitwise at {n_ok} of {len(forced)} "
                f"{'ok' if good else 'FAIL'}")

    # the state carry: two halves through the kernel equal one pass
    r, k, v, lw, u, s0 = inputs(1, 512, False)
    o, sf = run((r, k, v, lw, u, s0), 64, "kernel")
    oa, sa = run((r[:, :256], k[:, :256], v[:, :256], lw[:, :256], u, s0),
                 64, "kernel")
    ob, sb = run((r[:, 256:], k[:, 256:], v[:, 256:], lw[:, 256:], u, sa),
                 64, "kernel")
    torch.cuda.synchronize()
    err = max((torch.cat([oa, ob], 1) - o).abs().max().item(),
              (sb - sf).abs().max().item())
    tol = max(wkv_tolerance(o), wkv_tolerance(sf))
    good = err <= tol
    ok &= good
    report["wkv"].append({"kernel": "wkv_bshk", "case": "state carry",
                          "max_abs_err": err, "tol": tol, "ok": good})
    log(f"  wkv_bshk state carry [0:256] + [256:512] vs one pass: max_abs_err"
        f" {err:.3e} (tol {tol:.3e}) {'ok' if good else 'FAIL'}")

    # linear attention: its entry point once with the counts at 0, then
    # held against its plain version
    BH, S = 64, 1024
    la = (rn(BH, S, K) * 0.5, rn(BH, S, K) * 0.5, rn(BH, S, V),
          -torch.exp(rn(BH, S, K) * 0.5 - 3.0), rn(BH, K) * 0.1)
    ops.reset_counts()
    o = ops.linear_attn(*la, chunk=64)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["linear_attn"]
    want = linear_attn_plain(*la, chunk=64)
    torch.cuda.synchronize()
    err = (o - want).abs().max().item()
    tol = wkv_tolerance(want)
    good = err <= tol and bool(torch.isfinite(o).all()) and launches == 1
    ok &= good
    # r, k, logw, v, o and a u row per BH row; no state in or out
    b_ms, b_by = bound_ms((3 * BH * S * K + 2 * BH * S * V + BH * K) * 4,
                          wkv_ops(BH, 1, K, V, S, 64), PEAK_F32_FLOPS)
    plan = _wkv_plan(BH, S, 1, K, V, 64, sms)
    rec = {"kernel": "linear_attn", "case": "main", "BH": BH, "S": S,
           "K": K, "V": V, "chunk": 64, "entry_point_launches": launches,
           "plan": plan._asdict(),
           "max_abs_err": err, "tol": tol, "ok": good,
           "ms": timer(lambda: ops.linear_attn(*la, chunk=64)),
           "plain_ms": timer(lambda: linear_attn_plain(*la, chunk=64)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    report["wkv"].append(rec)
    log(f"  linear_attn BH={BH} S={S} K={K} V={V} chunk=64 (ops.linear_attn"
        f" launched it {launches} time): max_abs_err {err:.3e} (tol "
        f"{tol:.3e}) {'ok' if good else 'FAIL'}  kernel {rec['ms']:.4f} ms "
        f"plain {rec['plain_ms']:.4f} ms bound {b_ms:.4f} ms ({b_by})\n"
        f"    plan: {plan_str(plan)}")
    return ok


def adaptnetx_bound(p, B):
    """(bound ms, what bounds it) of B queries: the weights read once,
    each query's three embedding rows, ids and logits; 2 x (3E x H + H x
    C) f32 operations a query."""
    E, (H, C) = p["emb_m"].shape[1], p["w2"].shape
    nbytes = 4 * (3 * E * H + H + H * C + C) + B * 4 * (3 * E + 3 + C)
    return bound_ms(nbytes, B * 2.0 * (3 * E * H + H * C), PEAK_F32_FLOPS)


def adaptnetx_close(got, want) -> bool:
    """The reference's own tolerance for its kernel (``assert_allclose``
    with rtol = atol = 1e-5): f32 sums of 48 and 128 terms in another
    order."""
    return bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())


def check_adaptnetx(torch, report, timer):
    """The ADAPTNETX kernel against its plain version at 75, 108 and 135
    classes (the reference's tests' and the port's tile space): the
    reference's kernel-test ids, ids past the table and negative
    (clamped), and a batch of 64 queries; tolerance the reference's own
    (``adaptnetx_close``).  Each case is timed, kernel and plain, through
    ``ops.adaptnetx_recommend``; the host twin ``logits_np`` is timed per
    query on the host clock beside it, as context (what the serving
    dispatcher pays per cache miss), and each kernel time beside the
    timer's floor (one launch adding 1 to one element).  No single
    PyTorch call computes this function: no library time.  Each line
    prints the plan (``_adaptnetx_plan``); under the one query and the
    batch every forced plan (``VARIANTS``) must give the plan's logits
    bitwise, and each of the 64 queries alone its row of the batch."""
    from repro_torch import dispatch
    from repro_torch.core.adaptnet import (AdaptNetConfig, init_params,
                                           logits_np)
    from repro_torch.kernels import ops
    from repro_torch.kernels.adaptnetx import (OPERANDS, VARIANTS,
                                               _adaptnetx_plan,
                                               adaptnetx_cuda)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    ok = True
    one = torch.zeros(1, device="cuda")
    floor = report["adaptnetx_floor_ms"] = timer(lambda: one.add_(1.0))
    log(f"  adaptnetx: timer floor (one launch adding 1 to one element) "
        f"{floor:.4f} ms")
    for C in (75, 108, 135):
        p = init_params(gen, AdaptNetConfig(num_classes=C))
        # nonzero biases, so a bias the kernel dropped would show
        p["b1"] = torch.randn(p["b1"].shape, generator=gen,
                              device="cuda") * 0.1
        p["b2"] = torch.randn(p["b2"].shape, generator=gen,
                              device="cuda") * 0.1
        host = {k: v.cpu().numpy() for k, v in p.items()}
        batch = torch.randint(-10, 12_000, (64, 3), generator=gen,
                              device="cuda", dtype=torch.int32)
        for name, ids in (("[1,1,1]", [1, 1, 1]),
                          ("[9999,5000,1]", [9999, 5000, 1]),
                          ("[123,4567,8910]", [123, 4567, 8910]),
                          ("past the table", [20_000, -3, 10_001]),
                          ("batch 64", batch)):
            ids = torch.as_tensor(ids, dtype=torch.int32, device="cuda")
            B = 1 if ids.dim() == 1 else ids.shape[0]

            def run(mode):
                with dispatch.use(execute=mode):
                    return ops.adaptnetx_recommend(ids, p)
            got, want = run("kernel"), run("torch")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            good = adaptnetx_close(got, want) and got.shape == want.shape \
                and bool(torch.isfinite(got).all())
            ok &= good
            ids_np = ids.reshape(-1, 3).cpu().numpy()
            logits_np(host, ids_np[:1])
            t0 = time.perf_counter()
            for row in ids_np:
                logits_np(host, row[None])
            host_ms = (time.perf_counter() - t0) * 1e3 / B
            b_ms, b_by = adaptnetx_bound(p, B)
            plan = _adaptnetx_plan(B, 16, 128, C)
            rec = {"kernel": "adaptnetx", "C": C, "case": name, "B": B,
                   "max_abs_err": err, "tol": "1e-5 + 1e-5 |plain|",
                   "ok": good,
                   "plan": dict(plan._asdict(), combine=plan.combine),
                   "ms": timer(lambda: run("kernel")),
                   "plain_ms": timer(lambda: run("torch")),
                   "floor_ms": floor,
                   "host_logits_np_ms_per_query": host_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            report["adaptnetx"].append(rec)
            log(f"  adaptnetx C={C} {name:<16} B={B}: max_abs_err {err:.3e}"
                f" (tol 1e-5 + 1e-5 |plain|) {'ok' if good else 'FAIL'}  "
                f"kernel {rec['ms']:.4f} ms (floor {floor:.4f}, net "
                f"{rec['ms'] - floor:.4f}) plain {rec['plain_ms']:.4f} ms "
                f"bound {b_ms:.6f} ms ({b_by}); host logits_np {host_ms:.4f} ms "
                f"a query (host clock)\n    plan: {adaptnetx_plan_str(plan)}")
            if name not in ("[123,4567,8910]", "batch 64"):
                continue
            # forced plans, bitwise the plan's; each query alone = its row
            q2 = ids.reshape(-1, 3).contiguous()
            t = [p[k] for k in OPERANDS]
            ref = adaptnetx_cuda(q2, *t)
            same, n = 0, 0
            for _, kw in VARIANTS:
                try:
                    forced = _adaptnetx_plan(B, 16, 128, C, **kw)
                except ValueError:
                    continue
                n += 1
                same += torch.equal(adaptnetx_cuda(q2, *t, plan=forced), ref)
            alone = sum(torch.equal(adaptnetx_cuda(q2[b:b + 1], *t)[0],
                                    ref[b]) for b in range(B))
            good = same == n and alone == B
            ok &= good
            rec.update(forced_plans_bitwise=f"{same} of {n}",
                       alone_equals_batch=f"{alone} of {B}")
            log(f"    forced plans bitwise the plan's at {same} of {n}; "
                f"each query alone bitwise its row at {alone} of {B} "
                f"{'ok' if good else 'FAIL'}")
    return ok


def adaptnetx_plan_str(p) -> str:
    return (f"{p.tiles} tiles of {p.qt} queries x {p.ctiles} of {p.ct} "
            f"classes, {p.groups} CTAs a tile x {p.chunks} chunks of 32 "
            f"units, combine {p.combine}, {p.stages} stages = {p.ctas} CTAs,"
            f" {p.smem} B shared")


def p13_paged_case(torch, gen, H, KVH, hd, lengths, starts, chunks, sms,
                   timer, tag):
    """The decode and prefill kernels at one arch's serving widths (bf16):
    decode over ``lengths``, a 64-row chunk prefill at ``starts`` /
    ``chunks``; each against its plain version, twice for run-to-run
    bits, timed beside its plain version, its bound and SDPA over K/V
    gathered beforehand (a yardstick: no PyTorch call reads a page
    table)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attn import (
        _attn_plan, _decode_plan, paged_decode_plain,
        paged_prefill_plain)
    from repro_torch.launch.bench_decode import (gathered_sdpa,
                                                 gathered_sdpa_prefill)
    bs, G, scale = 16, H // KVH, 1.0 / math.sqrt(hd)
    tol = 5 * 2 * BF16_EPS
    recs = []
    ka, va, tables, lens = paged_inputs(torch, gen, len(lengths), KVH, G,
                                        hd, bs, lengths, torch.bfloat16)
    q = torch.randn((len(lengths), H, hd), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    a = (q, ka, va, tables, lens)
    rows = sum(-(-n // bs) * bs for n in lengths)
    bound, by = attn_bound_ms(rows, KVH, hd, 2 * q.numel() * 2,
                              2.0 * H * 2 * hd * sum(lengths))
    plan = _decode_plan(len(lengths), KVH, G, tables.shape[1], bs, hd, hd, 2,
                        sms)
    recs.append(("paged_decode", a, lambda *x: ops.paged_attention(*x),
                 lambda *x: paged_decode_plain(*x, scale=scale),
                 gathered_sdpa(*a, scale), bound, by,
                 f"{plan.splits} splits x {plan.units} = {plan.ctas} CTAs",
                 {"lengths": lengths}))
    plens = [s + c for s, c in zip(starts, chunks)]
    ka, va, tables, lens = paged_inputs(torch, gen, len(plens), KVH, G, hd,
                                        bs, plens, torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    q = torch.randn((len(plens), 64, H, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    a = (q, ka, va, tables, st, lens)
    rows = sum(-(-n // bs) * bs for n in plens)
    pairs = sum(min(s + r + 1, s + c) for s, c in zip(starts, chunks)
                for r in range(c))
    bound, by = attn_bound_ms(rows, KVH, hd, 2 * q.numel() * 2,
                              2.0 * H * 2 * hd * pairs)
    plan = _attn_plan(len(plens), 64 * G, KVH, tables.shape[1], bs, hd, hd,
                      2, sms, prefill=True)
    recs.append(("paged_prefill", a,
                 lambda *x: ops.paged_prefill_attention(*x),
                 lambda *x: paged_prefill_plain(*x, scale=scale),
                 gathered_sdpa_prefill(*a, scale), bound, by,
                 plan_text(plan._asdict()),
                 {"starts": starts, "chunks": chunks}))
    out, ok = [], True
    for kernel, a, run, plain_fn, sdpa, bound, by, plan, shape in recs:
        got, again, want = run(*a), run(*a), plain_fn(*a)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        bitwise = bool(torch.equal(got, again))
        good = err <= tol and math.isfinite(err) and bitwise
        ok &= good
        rec = {"kernel": kernel, "case": tag, "dtype": "bfloat16", "H": H,
               "KVH": KVH, "hd": hd, **shape, "max_abs_err": err,
               "tol": tol, "run_to_run_bitwise": bitwise, "ok": good,
               "plan": plan, "ms": timer(lambda: run(*a)),
               "plain_ms": timer(lambda: plain_fn(*a)),
               "sdpa_gathered_ms": timer(sdpa), "library_ms": None,
               "bound_ms": bound, "bound_by": by}
        out.append(rec)
        log(f"  {kernel:<13} bf16 {tag} (H={H}/{KVH}, hd={hd}): max_abs_err "
            f"{err:.3e} (tol {tol:.1e}), run to run bitwise {bitwise} "
            f"{'ok' if good else 'FAIL'}; plan {plan}  kernel "
            f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms bound "
            f"{bound:.5f} ms ({by}), SDPA over K/V gathered beforehand "
            f"{rec['sdpa_gathered_ms']:.4f} ms")
    return ok, out


def p13_bank_cases():
    """qwen2-moe-a2.7b's expert banks on phase 13a's path: 64 padded
    experts, M = 8 slots x the row capacity of a decode row (4) and of a
    64-token chunk (6), gate / up (2048 -> 1408) and down (1408 -> 2048)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.moe import padded_num_experts, row_capacity
    cfg = get_arch("qwen2-moe-a2.7b")
    E, d, f = padded_num_experts(cfg), cfg.d_model, cfg.moe.d_ff_expert
    out = []
    for M in sorted({P13_SLOTS * row_capacity(1, cfg),
                     P13_SLOTS * row_capacity(64, cfg)}):
        out += [("qwen2 moe.expert.gate/up", E, M, d, f, False),
                ("qwen2 moe.expert.down", E, M, f, d, False)]
    return out


def check_p13_kernels(torch, report, timer, dispatcher):
    """Phase 13's kernel shapes: the bank GEMM at qwen2-moe's expert
    banks; the decode and prefill kernels at gemma-2b's (G = 8, hd 256)
    and qwen2-moe's (G = 1, hd 128) serving widths (8 lanes, lengths and
    chunks off the page boundaries up to phase 13's 528 rows); the flash
    kernels, bidirectional, at seamless-m4t-medium's encoder shape (B = 1,
    S = 128, 16 heads x 64, bf16: the tensor-core forward, dq and dk/dv)
    against their plain versions (2e-2, the reference's
    bf16 tolerance; lse 2e-6), run twice and bitwise, beside
    ``scaled_dot_product_attention``."""
    ok = check_banks(torch, report, timer, None, dispatcher,
                     cases=p13_bank_cases(), path="13a")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = [64, 77, 130, 255, 300, 401, 512, 528]
    starts = [0, 64, 128, 192, 256, 17, 333, 448]
    chunks = [64, 64, 40, 64, 17, 64, 1, 64]
    for tag, H, KVH, hd in (("gemma-2b", 8, 1, 256),
                            ("qwen2-moe-a2.7b", 16, 16, 128)):
        good, recs = p13_paged_case(torch, gen, H, KVH, hd, lengths, starts,
                                    chunks, sms, timer, tag)
        ok &= good
        report["paged"] += recs
    rec, good = flash_case(torch, timer, gen, P13_FLASH, 1, P13_SRC,
                           P13_SRC, False, torch.bfloat16, 16, 16, 64,
                           grads=True, twice=True)
    report["p13_flash"] = rec
    return ok and good


def p14_sites(zcfg):
    """(name, K, N) of zamba2's projection GEMMs: the Mamba block's two,
    the shared block's attention (q, k, v and o are all d x 32 x 112 = d x
    d) and its MLP."""
    from repro_torch.models.ssm import mamba_dims
    d = zcfg.d_model
    d_inner, H, _, N = mamba_dims(zcfg)
    return (("in_proj", d, 2 * d_inner + 2 * N + H),
            ("out_proj", d_inner, d), ("q/k/v/o", d, zcfg.q_dim),
            ("gate/up", d, zcfg.d_ff), ("down", zcfg.d_ff, d))


def check_p14_kernels(torch, report, timer, dispatcher):
    """Phase 14's shapes: zamba2-7b's serving GEMMs (bf16 at M = 8, a
    decode step of 8 slots, and M = 512, the longest prompt's prefill; the
    unembedding at M = 8 and at M = 1, a prefill's last row), among them
    ``ssm.in_proj``'s ragged N = 14576, and its training GEMMs (f32,
    forward, dx and dw at 14b's 2 x 1024 tokens), each against its plain
    version and timed beside ``torch.matmul`` and its bound; and the three
    flash kernels at its shared block's training shape (B = 2, S = 1024, 32
    / 32 heads, hd 112, causal, f32), run to run bitwise, timed beside
    SDPA."""
    from repro_torch.configs.registry import get_arch
    zcfg = get_arch("zamba2-7b")
    d, V = zcfg.d_model, zcfg.vocab_size
    sites = p14_sites(zcfg)
    keys = {(M, K, N, dispatcher.recommend(M, K, N).mode)
            for M in (P14_SLOTS, max(P14_LENS)) for _, K, N in sites}
    keys |= {(M, d, V, dispatcher.recommend(M, d, V).mode)
             for M in (1, P14_SLOTS)}
    log("  zamba2-7b serving GEMMs, kernel vs plain (bf16)")
    ok, report["p14_gemm"] = check_gemm_keys(torch, timer, keys, dispatcher,
                                             V)
    log(f"  zamba2-7b training GEMMs (f32, {TRAIN_B} x {TRAIN_S} tokens)")
    report["p14_train_gemm"] = []
    ok &= check_train_gemms(torch, report, zcfg, dispatcher,
                            cases=train_gemm_cases(zcfg, sites),
                            key="p14_train_gemm")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    rec, good = flash_case(torch, timer, gen, P14_FLASH, TRAIN_B, TRAIN_S,
                           TRAIN_S, True, torch.float32, zcfg.num_heads,
                           zcfg.num_kv_heads, zcfg.head_dim)
    report["p14_flash"] = rec
    torch.cuda.empty_cache()
    return ok and good


def p15_bank_cases():
    """(site, E, M, K, N) of qwen2-moe-a2.7b's expert banks in 15b's train
    step: 64 padded experts, M = 2 rows x ``row_capacity(1024)`` = 172
    slots, gate / up (2048 -> 1408) and down (1408 -> 2048)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.moe import padded_num_experts, row_capacity
    cfg = get_arch("qwen2-moe-a2.7b")
    E, d, f = padded_num_experts(cfg), cfg.d_model, cfg.moe.d_ff_expert
    M = TRAIN_B * row_capacity(TRAIN_S, cfg)
    return (("gate/up", E, M, d, f), ("down", E, M, f, d))


def check_p15_bank_grads(torch, report, timer, dispatcher):
    """The bank GEMM's gradient at 15b's shapes, f32: for each bank (E, M,
    K, N) its dx = dy @ w^T, one bank launch of (E, M, N) x (E, N, K) with
    w^T read in place, and its dw = x^T @ dy, one of (E, K, M) x (E, M, N)
    with x^T read in place, each with its recommended tile, against the
    plain version within the f32 summation bound (K x 2^-24 x |a| @ |b|)
    and run to run bitwise; timed (L2 flushed) beside the plain version
    and ``torch.bmm``, bound by the f32 CUDA-core peak."""
    from repro_torch.core.hw import DATAFLOW_NAMES
    from repro_torch.dispatch.executor import _clamped_blocks
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda, rsa_gemm_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    ok = True
    report["p15_bank"] = []
    for site, E, M, K, N in p15_bank_cases():
        x = torch.randn((E, M, K), generator=gen, device="cuda")
        w = torch.randn((E, K, N), generator=gen, device="cuda") \
            / math.sqrt(K)
        dy = torch.randn((E, M, N), generator=gen, device="cuda")
        for pas, a, b in (("dx", dy, w.transpose(1, 2)),
                          ("dw", x.transpose(1, 2), dy)):
            m, k, n = a.shape[1], a.shape[2], b.shape[2]
            c = dispatcher.recommend(m, k, n)
            bk, mode = _clamped_blocks(c, m, k, n)[2], c.mode

            def kernel():
                return rsa_gemm_cuda(a, b, block_k=bk, mode=mode)
            out = kernel()
            again = kernel()
            plain = rsa_gemm_plain(a, b, block_k=bk, mode=mode)
            torch.cuda.synchronize()
            err = (out - plain).abs().max().item()
            tol = k * F32_EPS * max(
                (a[e:e + 16].abs() @ b[e:e + 16].abs()).max().item()
                for e in range(0, E, 16))
            bitwise = bool(torch.equal(out, again))
            good = err <= tol and math.isfinite(err) and bitwise
            ok &= good
            b_ms, b_by = bound_ms(4.0 * E * (m * k + k * n + m * n),
                                  2.0 * E * m * n * k, PEAK_F32_FLOPS)
            rec = {"site": site, "pass": pas, "E": E, "M": m, "K": k,
                   "N": n, "bk": bk, "mode": DATAFLOW_NAMES[mode],
                   "max_abs_err": err, "tol": tol,
                   "run_to_run_bitwise": bitwise, "ok": good,
                   "ms": timer(kernel),
                   "plain_ms": timer(lambda: rsa_gemm_plain(
                       a, b, block_k=bk, mode=mode)),
                   "library_ms": timer(lambda: torch.bmm(a, b)),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "key": (E, m, k, n, mode)}
            report["p15_bank"].append(rec)
            log(f"  rsa_gemm bank {pas} qwen2 {site:<7} {E}x({m}x{k}x{n}) "
                f"{rec['mode']} bk={bk} f32 "
                f"{'B^T' if pas == 'dx' else 'A^T'}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e}), run to run bitwise {bitwise} "
                f"{'ok' if good else 'FAIL'}  kernel {rec['ms']:.4f} ms "
                f"plain {rec['plain_ms']:.4f} ms bmm "
                f"{rec['library_ms']:.4f} ms bound {b_ms:.4f} ms")
            del out, again, plain
        del x, w, dy
        torch.cuda.empty_cache()
    return ok


def check_p15_kernels(torch, report, timer, dispatcher):
    """Phase 15's shapes: the three flash kernels at gemma-2b's training
    shape (B = 2, S = 1024, 8 / 1 heads, hd 256: f32 on CTA pairs,
    causal) in f32 and bf16 and at deepseek-v3's expanded-MLA training
    shape (B = 1, S = 1024, 128 heads, hd 192 / hd_v 128, causal, f32),
    each against its plain version and run to run bitwise, timed beside
    SDPA and its bound (5 timed runs: the plain versions loop over
    blocks); and the bank GEMM's dx / dw at 15b's shapes."""
    from repro_torch.configs.registry import get_arch
    timer = Timer(torch, reps=5)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    g = get_arch("gemma-2b")
    m = get_arch("deepseek-v3-671b").mla
    report["p15_flash"] = []
    ok = True
    for name, B, H, KVH, hd, hd_v, dt in (
            (P15_FLASH["gemma"], TRAIN_B, g.num_heads, g.num_kv_heads,
             g.head_dim, g.head_dim, torch.float32),
            (P15_FLASH["gemma bf16"], TRAIN_B, g.num_heads, g.num_kv_heads,
             g.head_dim, g.head_dim, torch.bfloat16),
            (P15_FLASH["mla"], 1, 128, 128,
             m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim,
             torch.float32)):
        rec, good = flash_case(torch, timer, gen, name, B, TRAIN_S, TRAIN_S,
                               True, dt, H, KVH, hd, hd_v, grads=True,
                               twice=True)
        report["p15_flash"].append(rec)
        ok &= good
        torch.cuda.empty_cache()
    ok &= check_p15_bank_grads(torch, report, timer, dispatcher)
    return ok


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(torch, report):
    from repro_torch import dispatch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.launch.serve import serve_continuous

    ops.reset_counts()
    t0 = time.time()
    outputs, engine = serve_continuous(
        arch="llama3.2-1b", preset="full", num_requests=16, num_slots=8,
        prompt_len=512, min_prompt_len=64, gen=32, temperature=0.0,
        top_k=0, seed=0, execute="auto", prefill_chunk=64, block_size=16,
        clock="wall", device="cuda", log=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    gemm_keys = dict(rsa_gemm_cuda.launches_by_key)
    L = engine.cfg.num_layers
    s = engine.summary()
    done = [r for r in engine.requests.values() if r.outcome == "done"]
    engine.pool.check()
    ok = (len(done) == 16 and all(len(v) == 32 for v in outputs.values())
          and engine.pool.num_free == engine.pool.num_blocks
          and counts["rsa_gemm"] > 0 and counts["paged_decode"] > 0
          and counts["paged_prefill"] > 0 and counts["plain_calls"] == 0)
    prefill_steps = counts["paged_prefill"] // L
    decode_steps = counts["paged_decode"] // L
    steps = prefill_steps + decode_steps
    report["main_path"] = {
        "requests": 16, "completed": len(done), "wall_s": wall,
        "counts": counts, "gemm_launches_by_shape": {
            f"{k[0]}x{k[1]}x{k[2]}:{k[3]}": v for k, v in gemm_keys.items()},
        "prefill_steps": prefill_steps, "decode_steps": decode_steps,
        "gemm_launches_per_model_step": counts["rsa_gemm"] / max(steps, 1),
        "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"],
        "decode_tok_s": s["decode_tok_s"], "prefill_tok_s": s["prefill_tok_s"],
        "decode_wall_s": engine.metrics.decode_s,
        "prefill_wall_s": engine.metrics.prefill_s,
        "sara_cache_hit_rate": s["sara_cache_hit_rate"],
        "gemm_plan": engine.gemm_plan, "plan_changes": engine.plan_changes,
        "ran_plan_changes": engine.ran_plan_changes,
        "pool_leak_free": engine.pool.num_free == engine.pool.num_blocks,
        # phase 10a serves the same trace speculatively
        "tokens": {rid: v.tolist() for rid, v in outputs.items()}}
    log(f"  served {len(done)}/16 requests in {wall:.2f} s "
        f"({engine.steps} engine steps: {prefill_steps} chunk-prefill, "
        f"{decode_steps} decode model calls)")
    log(f"  launches: {json.dumps(counts)}")
    log(f"  launches per model step: rsa_gemm "
        f"{counts['rsa_gemm'] / max(steps, 1):.1f} (16 layers x 7 + unembed "
        f"= 113), paged_prefill {counts['paged_prefill'] / max(prefill_steps, 1):.1f}"
        f" per chunk-prefill step, paged_decode "
        f"{counts['paged_decode'] / max(decode_steps, 1):.1f} per decode step"
        f" (16 each)")
    log(f"  ttft p50 {s['ttft_p50_s']:.4f} s p99 {s['ttft_p99_s']:.4f} s, "
        f"decode {s['decode_tok_s']:.1f} tok/s, prefill "
        f"{s['prefill_tok_s']:.1f} tok/s, sara_cache_hit_rate "
        f"{s['sara_cache_hit_rate']:.4f}, plan_changes (recommendation) "
        f"{engine.plan_changes}, ran_plan_changes (on the card) "
        f"{engine.ran_plan_changes}")
    log("  gemm plan (recommendation, then what the kernel ran):")
    for site, desc in engine.gemm_plan.items():
        log(f"    {site:<16} {desc}")
    if not ok:
        log(f"  MAIN PATH FAIL: completed {len(done)}, free "
            f"{engine.pool.num_free}/{engine.pool.num_blocks}, "
            f"counts {counts}")

    # one chunk-prefill step and one decode step, kernels vs plain versions
    import numpy as np
    model, params, cfg = engine.model, engine.params, engine.cfg
    rng = np.random.default_rng(7)
    S, C, bs = 8, 64, 16
    W = -(-(C + 1) // bs)
    tables = torch.arange(S * W, dtype=torch.int32,
                          device="cuda").reshape(S, W)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (S, C)),
                           device="cuda")
    chunk = torch.as_tensor([64, 64, 40, 17, 64, 1, 33, 64],
                            dtype=torch.int32, device="cuda")
    kv0 = torch.zeros(S, dtype=torch.int32, device="cuda")
    res = {}
    nxt = None
    for mode in ("torch", "kernel"):
        arena = model.init_paged_arena(S * W + 1, bs)
        with torch.no_grad(), dispatch.use(execute=mode):
            pl, _ = model.paged_prefill_step(params, toks, arena, tables, kv0,
                                             chunk)
            if nxt is None:          # both paths decode the same tokens
                nxt = pl.argmax(-1)[:, None]
            dl, _ = model.paged_decode_step(
                params, nxt, arena, tables, chunk,
                torch.ones(S, dtype=torch.int32, device="cuda"))
        res[mode] = (pl, dl)
    torch.cuda.synchronize()
    # bf16 through 16 layers: each path rounds at different points (the
    # attention kernels round p to bf16); hold the difference to 5% of the
    # logits' largest magnitude
    good = True
    for i, name in ((0, "prefill"), (1, "decode")):
        ref = res["torch"][i]
        err = (res["kernel"][i] - ref).abs().max().item()
        tol = 0.05 * ref.abs().max().item()
        agree = (res["kernel"][i].argmax(-1) == ref.argmax(-1)).float().mean()
        g = err <= tol and math.isfinite(err)
        good &= g
        report["main_path"][f"{name}_logits_max_abs_err"] = err
        report["main_path"][f"{name}_logits_tol"] = tol
        report["main_path"][f"{name}_greedy_agreement"] = agree.item()
        log(f"  {name} step logits, kernels vs plain: max_abs_err {err:.4e} "
            f"(tol {tol:.4e}) {'ok' if g else 'FAIL'}; greedy agreement "
            f"{agree.item():.3f}")
    ok &= good
    return ok, gemm_keys, counts


# ---------------------------------------------------------------------------
# phase 5: the cascade path
# ---------------------------------------------------------------------------

SYSTEM_LEN, SUFFIX_LO, SUFFIX_HI, CASCADE_GEN = 384, 16, 128, 32


def cascade_path(torch, report):
    import numpy as np
    from repro_torch import dispatch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    cfg = get_arch("llama3.2-1b")
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_LEN).astype(np.int32)
    reqs = []
    for i in range(24):
        n = int(rng.integers(SUFFIX_LO, SUFFIX_HI + 1))
        p = np.concatenate([system, rng.integers(0, cfg.vocab_size, n)])
        reqs.append(Request(rid=f"req-{i}", prompt=p.astype(np.int32),
                            max_new_tokens=CASCADE_GEN))
    engine = ServingEngine(cfg, EngineConfig(
        num_slots=8, max_len=SYSTEM_LEN + SUFFIX_HI + CASCADE_GEN + 1,
        block_size=16, prefill_chunk=64, temperature=0.0, seed=0,
        clock="wall", execute="auto", prefix_cache=True,
        shared_prefix_decode=True), device="cuda")
    L = cfg.num_layers
    ops.reset_counts()
    t0 = time.time()
    engine.run(reqs[:1])             # the system prompt's pages enter the trie
    for r in reqs[1:]:
        r.arrival_time = engine.now()
    engine.run(reqs[1:])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    gemm_keys = dict(rsa_gemm_cuda.launches_by_key)
    s = engine.summary()
    done = [r for r in engine.requests.values() if r.outcome == "done"]
    audit = engine.pool.audit_leaks(engine.prefix_cache.pages())
    trie_pages = len(engine.prefix_cache.pages())
    engine.prefix_cache.clear()
    engine.pool.check()
    whole = engine.pool.num_free == engine.pool.num_blocks
    cascade_steps = engine.shared_prefix_steps
    decode_steps = s["decode_steps"]
    ok = (len(done) == 24
          and all(len(r.generated) == CASCADE_GEN for r in done)
          and s["prefix_cache_hits"] == 23 and cascade_steps > 0
          and counts["paged_prefix"] == L * cascade_steps
          and counts["paged_decode_lse"] == L * cascade_steps
          and counts["paged_decode"] == L * (decode_steps - cascade_steps)
          and counts["rsa_gemm"] > 0 and counts["paged_prefill"] > 0
          and counts["plain_calls"] == 0 and whole)
    res = report["cascade_path"] = {
        "requests": 24, "completed": len(done), "wall_s": wall,
        "counts": counts, "decode_steps": decode_steps,
        "cascade_steps": cascade_steps,
        "cascade_lanes": engine.shared_prefix_lanes,
        "prefill_steps": counts["paged_prefill"] // L,
        "prefix_cache_hits": s["prefix_cache_hits"],
        "prefix_cache_hit_rate": s["prefix_cache_hit_rate"],
        "cache_hit_tokens": s["cache_hit_tokens"],
        "kv_cow_copies": s["kv_cow_copies"],
        "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"],
        "decode_tok_s": s["decode_tok_s"], "prefill_tok_s": s["prefill_tok_s"],
        "decode_wall_s": engine.metrics.decode_s,
        "prefill_wall_s": engine.metrics.prefill_s,
        "leak_audit": audit, "trie_pages": trie_pages, "pool_whole": whole}
    log(f"  served {len(done)}/24 requests in {wall:.2f} s ({engine.steps} "
        f"engine steps: {res['prefill_steps']} chunk-prefill, "
        f"{decode_steps} decode model calls, {cascade_steps} of them "
        f"cascade, {engine.shared_prefix_lanes} group lanes in all)")
    log(f"  prefix cache: {s['prefix_cache_hits']} hits / "
        f"{s['prefix_cache_misses']} misses (hit rate "
        f"{s['prefix_cache_hit_rate']:.4f}), {s['cache_hit_tokens']} prompt "
        f"tokens not recomputed, {s['kv_cow_copies']} copy-on-write copies")
    log(f"  launches: {json.dumps(counts)}")
    log(f"  per cascade step: paged_prefix "
        f"{counts['paged_prefix'] / max(cascade_steps, 1):.1f}, "
        f"paged_decode_lse "
        f"{counts['paged_decode_lse'] / max(cascade_steps, 1):.1f} "
        f"({L} each, one per layer)")
    log(f"  ttft p50 {s['ttft_p50_s']:.4f} s p99 {s['ttft_p99_s']:.4f} s, "
        f"decode {s['decode_tok_s']:.1f} tok/s, prefill "
        f"{s['prefill_tok_s']:.1f} tok/s")
    log(f"  leak audit with the trie's {trie_pages} pins: {audit}; pool "
        f"whole after clear: {whole}")
    if not ok:
        log(f"  CASCADE PATH FAIL: completed {len(done)}, hits "
            f"{s['prefix_cache_hits']}, cascade steps {cascade_steps}, "
            f"decode steps {decode_steps}, counts {counts}, whole {whole}")

    # one cascade decode step, kernels vs plain versions, on a random
    # arena: lanes 0-6 share 24 pages, lane 7 is outside the group
    model, params = engine.model, engine.params
    bs, P, S = 16, 24, 8
    own = [int(rng.integers(SUFFIX_LO, SUFFIX_HI + 1)) for _ in range(S)]
    kv = [SYSTEM_LEN + n for n in own]
    nxt, full = P, []
    for n in own:
        k = -(-(n + 1) // bs)           # covers the pending row too
        full.append(list(range(P)) + list(range(nxt, nxt + k)))
        nxt += k
    W = max(len(r) for r in full)
    full = [r + [r[-1]] * (W - len(r)) for r in full]
    plens = [SYSTEM_LEN] * (S - 1) + [0]
    ul = [kv[i] + 1 - plens[i] for i in range(S)]
    uw = max(len(full[i]) - plens[i] // bs for i in range(S))
    utab = []
    for i in range(S):
        row = full[i][plens[i] // bs:][:uw]
        utab.append(row + [row[-1]] * (uw - len(row)))
    i32 = dict(dtype=torch.int32, device="cuda")
    ops_in = [torch.tensor(a, **i32) for a in (
        full, kv, [1] * S, list(range(P)) + [P - 1] * 8, plens, utab, ul)]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (S, 1)),
                           device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    arena0 = model.init_paged_arena(nxt + 1, bs)
    for leaf in arena0.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    res_l = {}
    for mode, step in (("torch", "cascade"), ("kernel", "cascade"),
                       ("kernel", "decode")):
        arena = {n: a.clone() for n, a in arena0.items()}
        with torch.no_grad(), dispatch.use(execute=mode):
            if step == "cascade":
                res_l[mode, step], _ = model.paged_shared_decode_step(
                    params, toks, arena, *ops_in)
            else:          # the same step without the cascade: full tables
                res_l[mode, step], _ = model.paged_decode_step(
                    params, toks, arena, *ops_in[:3])
    torch.cuda.synchronize()
    # bf16 through 16 layers, as phase 4: 5% of the largest logit.  The
    # second line shows that the split into two phases changes no lane's
    # math beyond rounding: the kernels' cascade step against their plain
    # decode step over the lanes' full tables
    good = True
    for (a, b), what in (((("kernel", "cascade"), ("torch", "cascade")),
                          "kernels vs plain"),
                         ((("kernel", "cascade"), ("kernel", "decode")),
                          "cascade vs plain decode, kernels")):
        ref = res_l[b]
        err = (res_l[a] - ref).abs().max().item()
        tol = 0.05 * ref.abs().max().item()
        agree = (res_l[a].argmax(-1) == ref.argmax(-1)).float().mean().item()
        g = err <= tol and math.isfinite(err)
        good &= g
        tag = "cascade" if b[0] == "torch" else "cascade_vs_decode"
        res.update({f"{tag}_logits_max_abs_err": err,
                    f"{tag}_logits_tol": tol,
                    f"{tag}_greedy_agreement": agree})
        log(f"  cascade decode step logits, {what}: max_abs_err {err:.4e} "
            f"(tol {tol:.4e}) {'ok' if g else 'FAIL'}; greedy agreement "
            f"{agree:.3f}")
    return ok and good, counts, gemm_keys


# ---------------------------------------------------------------------------
# phase 6: deepseek-v3 (absorbed MLA + MoE) at full width
# ---------------------------------------------------------------------------

DS_REQUESTS, DS_SLOTS, DS_GEN, DS_LO, DS_HI = 12, 8, 16, 64, 512


def deepseek_cfg():
    """deepseek-v3-671b at its published widths, depth cut to one dense
    layer then one MoE layer (the split ``reduced()`` keeps): ~28 GB of
    bf16 weights."""
    from repro_torch.configs.registry import get_arch
    return get_arch("deepseek-v3-671b").replace(num_layers=2,
                                                first_dense_layers=1)


def check_gemm_keys(torch, timer, keys, dispatcher, vocab, quick=None):
    """Each 2-D GEMM shape a path launched, (M, K, N, mode): the kernel
    against its plain version (bf16; the unembedding with f32 output) at
    the recommended block_k, and timed beside the plain version,
    ``torch.matmul`` and its bound.  With ``quick`` (a ``Timer``) only the
    kernel is timed, by ``quick``, and only a failed check is logged."""
    from repro_torch.core.hw import DATAFLOW_NAMES
    from repro_torch.dispatch.executor import _clamped_blocks
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out_recs, ok = [], True
    for key in sorted(keys):
        M, K, N, mode = key
        bk = _clamped_blocks(dispatcher.recommend(M, K, N), M, K, N)[2]
        odt = torch.float32 if N == vocab else torch.bfloat16
        a = torch.randn((M, K), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        b = (torch.randn((K, N), generator=gen, device="cuda")
             * (1.0 / math.sqrt(K))).to(torch.bfloat16)

        def kernel():
            return ops.rsa_gemm(a, b, block_k=bk, mode=mode, out_dtype=odt)
        out = kernel()
        plain = rsa_gemm_plain(a, b, block_k=bk, mode=mode, out_dtype=odt)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        tol = gemm_tolerance(torch, a, b, plain, mode, bk,
                             odt == torch.float32)
        good = err <= tol and math.isfinite(err)
        ok &= good
        nbytes = (M * K + K * N) * 2 + M * N * out.element_size()
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2.0 * M * N * K / PEAK_BF16_FLOPS * 1e3
        rec = {"M": M, "K": K, "N": N, "mode": DATAFLOW_NAMES[mode],
               "bk": bk, "out": str(odt).split(".")[-1], "key": key,
               "max_abs_err": err, "tol": tol, "ok": good}
        ok &= psum_bitwise(torch, lambda m: ops.rsa_gemm(
            a, b, block_k=bk, mode=m, out_dtype=odt), f"{M}x{K}x{N}", rec,
            quiet=quick is not None)
        if quick is not None:
            rec["ms"] = quick(kernel)
            out_recs.append(rec)
            if not good:
                log(f"  rsa_gemm {M}x{K}x{N} {rec['mode']} bk={bk}: "
                    f"max_abs_err {err:.3e} (tol {tol:.3e}) FAIL")
            del a, b
            continue
        rec.update(
            ms=timer(kernel),
            plain_ms=timer(lambda: rsa_gemm_plain(
                a, b, block_k=bk, mode=mode, out_dtype=odt)),
            library_ms=timer(lambda: torch.matmul(a, b)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        out_recs.append(rec)
        log(f"  rsa_gemm {M}x{K}x{N} {rec['mode']} bk={bk} bf16->"
            f"{rec['out']}: max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if good else 'FAIL'}  kernel {rec['ms']:.4f} ms plain "
            f"{rec['plain_ms']:.4f} ms matmul {rec['library_ms']:.4f} ms "
            f"bound {rec['bound_ms']:.4f} ms")
        del a, b
    return ok, out_recs


class RoutingReplay:
    """Stands in for ``models.moe.route`` in phase 6's logits check.

    The MoE router's top-k is discontinuous: bf16 rounding that differs by
    an ulp between the kernels and the plain versions can flip a near-tie
    expert choice, which replaces a token's whole expert output and, where
    an expert is over capacity, shifts which other tokens of the row are
    dropped.  So the check runs the plain step first ("record"), then the
    kernels free ("compare": the share of tokens whose top-k set agrees
    with the plain run is counted), then the kernels with the plain run's
    expert choices ("replay", gates recomputed from the kernel run's own
    probabilities), which holds the kernels' arithmetic to the plain
    versions' with the decision fixed."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route
        self.mode, self.calls, self.i = "record", [], 0
        self.agree = self.tokens = 0

    def __call__(self, params, x, cfg):
        top, g = self.route(params, x, cfg)
        if self.mode == "record":
            self.calls.append(top)
            return top, g
        want = self.calls[self.i]
        self.i = (self.i + 1) % len(self.calls)
        if self.mode == "compare":
            same = (top.sort(-1).values == want.sort(-1).values).all(-1)
            self.agree += int(same.sum().item())
            self.tokens += same.numel()
            return top, g
        return want, self.moe.gates(self.moe.router_probs(params, x, cfg),
                                    want)


def deepseek_path(torch, report, timer, dispatcher):
    import numpy as np
    from repro_torch import dispatch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.models.moe import padded_num_experts
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    cfg = deepseek_cfg()
    L, V = cfg.num_layers, cfg.vocab_size
    t0 = time.time()
    engine = ServingEngine(cfg, EngineConfig(
        num_slots=DS_SLOTS, max_len=DS_HI + DS_GEN + 1, block_size=16,
        prefill_chunk=64, temperature=0.0, seed=0, clock="wall",
        execute="auto"), device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in _leaves(engine.params)) / 1e9
    rng = np.random.default_rng(0)
    reqs = [Request(rid=f"req-{i}", prompt=rng.integers(
        0, V, int(rng.integers(DS_LO, DS_HI + 1))).astype(np.int32),
        max_new_tokens=DS_GEN) for i in range(DS_REQUESTS)]
    ops.reset_counts()
    t0 = time.time()
    outputs = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    gemm_keys = dict(rsa_gemm_cuda.launches_by_key)
    s = engine.summary()
    done = [r for r in engine.requests.values() if r.outcome == "done"]
    engine.pool.check()
    decode_steps = s["decode_steps"]
    steps = sum(n for k, n in gemm_keys.items() if len(k) == 4 and
                k[2] == V)                   # one unembedding per model call
    prefill_steps = steps - decode_steps
    E_pad = padded_num_experts(cfg)
    banks = {k: n for k, n in gemm_keys.items() if len(k) == 5}
    expert = sum(n for k, n in banks.items() if k[0] == E_pad)
    heads = sum(n for k, n in banks.items() if k[0] == cfg.num_heads)
    plan_ok = all(desc.endswith("@torch") == (site == "moe.router")
                  for site, desc in engine.gemm_plan.items())
    ok = (len(done) == DS_REQUESTS
          and all(len(v) == DS_GEN for v in outputs.values())
          and engine.pool.num_free == engine.pool.num_blocks
          and decode_steps > 0 and prefill_steps > 0
          and counts["paged_mla_decode"] == L * decode_steps
          and counts["paged_mla_prefill"] == L * prefill_steps
          and expert == 3 * (L - cfg.first_dense_layers) * steps
          and heads == 2 * L * steps
          and counts["paged_decode"] == counts["paged_prefill"] == 0
          and counts["plain_calls"] == 0 and plan_ok)
    res = report["deepseek_path"] = {
        "config": {"d_model": cfg.d_model, "num_layers": L,
                   "first_dense_layers": cfg.first_dense_layers,
                   "num_heads": cfg.num_heads, "mla": vars(cfg.mla),
                   "moe": vars(cfg.moe), "experts_padded": E_pad,
                   "d_ff": cfg.d_ff, "vocab": V},
        "weights_gb": weights_gb, "init_s": init_s,
        "requests": DS_REQUESTS, "completed": len(done), "wall_s": wall,
        "counts": counts, "gemm_launches_by_shape": {
            "x".join(str(v) for v in k[:-1]) + f":{k[-1]}": n
            for k, n in gemm_keys.items()},
        "prefill_steps": prefill_steps, "decode_steps": decode_steps,
        "bank_launches": {"expert": expert, "head": heads},
        "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"],
        "decode_tok_s": s["decode_tok_s"], "prefill_tok_s": s["prefill_tok_s"],
        "decode_wall_s": engine.metrics.decode_s,
        "prefill_wall_s": engine.metrics.prefill_s,
        "gemm_plan": engine.gemm_plan,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "pool_leak_free": engine.pool.num_free == engine.pool.num_blocks}
    log(f"  {weights_gb:.2f} GB of bf16 weights (seed 0) initialised in "
        f"{init_s:.1f} s")
    log(f"  served {len(done)}/{DS_REQUESTS} requests in {wall:.2f} s "
        f"({engine.steps} engine steps: {prefill_steps} chunk-prefill, "
        f"{decode_steps} decode model calls)")
    log(f"  launches: {json.dumps(counts)}")
    log(f"  per model step: paged_mla_decode "
        f"{counts['paged_mla_decode'] / max(decode_steps, 1):.1f} per decode"
        f" step, paged_mla_prefill "
        f"{counts['paged_mla_prefill'] / max(prefill_steps, 1):.1f} per "
        f"chunk-prefill step ({L} each); expert-bank launches "
        f"{expert / max(steps, 1):.1f} (3), head-bank "
        f"{heads / max(steps, 1):.1f} ({2 * L}), all rsa_gemm "
        f"{counts['rsa_gemm'] / max(steps, 1):.1f}")
    log(f"  ttft p50 {s['ttft_p50_s']:.4f} s p99 {s['ttft_p99_s']:.4f} s, "
        f"decode {s['decode_tok_s']:.1f} tok/s, prefill "
        f"{s['prefill_tok_s']:.1f} tok/s")
    log("  gemm plan (recommendation, then what the kernel ran):")
    for site, desc in engine.gemm_plan.items():
        log(f"    {site:<20} {desc}")
    if not ok:
        log(f"  DEEPSEEK PATH FAIL: completed {len(done)}, free "
            f"{engine.pool.num_free}/{engine.pool.num_blocks}, steps "
            f"{prefill_steps}+{decode_steps}, banks {expert}/{heads}, "
            f"plan ok {plan_ok}, counts {counts}")

    # one chunk-prefill step and one decode step, kernels vs plain versions
    model, params = engine.model, engine.params
    S, C, bs = DS_SLOTS, 64, 16
    W = -(-(C + 1) // bs)
    tables = torch.arange(S * W, dtype=torch.int32,
                          device="cuda").reshape(S, W)
    toks = torch.as_tensor(rng.integers(0, V, (S, C)), device="cuda")
    chunk = torch.as_tensor([64, 64, 40, 17, 64, 1, 33, 64],
                            dtype=torch.int32, device="cuda")
    kv0 = torch.zeros(S, dtype=torch.int32, device="cuda")
    from repro_torch.models import moe
    replay = RoutingReplay(moe)
    out, nxt = {}, None
    moe.route = replay
    try:
        for mode, execute in (("record", "torch"), ("compare", "kernel"),
                              ("replay", "kernel")):
            replay.mode = mode
            arena = model.init_paged_arena(S * W + 1, bs)
            with torch.no_grad(), dispatch.use(execute=execute):
                pl, _ = model.paged_prefill_step(params, toks, arena, tables,
                                                 kv0, chunk)
                if nxt is None:
                    nxt = pl.argmax(-1)[:, None]
                dl, _ = model.paged_decode_step(
                    params, nxt, arena, tables, chunk,
                    torch.ones(S, dtype=torch.int32, device="cuda"))
            out[mode] = (pl, dl)
    finally:
        moe.route = replay.route
    torch.cuda.synchronize()
    # bf16 through 2 layers, as phases 4-5: 5% of the largest logit, with
    # the routing decision fixed (RoutingReplay); the free run's error and
    # its routing agreement are reported beside it
    good = True
    res["routing_agreement"] = replay.agree / max(replay.tokens, 1)
    log(f"  routing: {replay.agree}/{replay.tokens} tokens chose the same "
        f"top-{cfg.moe.experts_per_token} experts on the kernels as on the "
        f"plain versions")
    for i, name in ((0, "prefill"), (1, "decode")):
        ref = out["record"][i]
        err = (out["replay"][i] - ref).abs().max().item()
        free = (out["compare"][i] - ref).abs().max().item()
        tol = 0.05 * ref.abs().max().item()
        agree = (out["replay"][i].argmax(-1) == ref.argmax(-1)).float() \
            .mean().item()
        g = err <= tol and math.isfinite(err)
        good &= g
        res.update({f"{name}_logits_max_abs_err": err,
                    f"{name}_logits_tol": tol,
                    f"{name}_logits_free_routing_max_abs_err": free,
                    f"{name}_greedy_agreement": agree})
        log(f"  {name} step logits, kernels vs plain (same routing): "
            f"max_abs_err {err:.4e} (tol {tol:.4e}) {'ok' if g else 'FAIL'};"
            f" greedy agreement {agree:.3f}; free routing: max_abs_err "
            f"{free:.4e}")
    del engine, model, params, out
    torch.cuda.empty_cache()

    log("  the path's 2-D GEMM shapes, kernel vs plain (bf16):")
    g_ok, recs = check_gemm_keys(
        torch, timer, [k for k in gemm_keys if len(k) == 4], dispatcher, V)
    report["ds_gemm"] = recs
    return ok and good and g_ok, counts, gemm_keys


# ---------------------------------------------------------------------------
# phase 7: the training path
# ---------------------------------------------------------------------------

def _state_leaves(tree):
    """Leaves of nested dicts and named tuples, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _state_leaves(tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _state_leaves(v)
    else:
        yield tree


def train_path(torch, report):
    """``train_main`` on full-width llama3.2-1b (optimized profile), f32,
    batch 2 x 1024, 4 steps, every kernel launched and counted; then the
    checkpoint round trip, and a second ``train_main`` from the same init
    and data for one step on the plain versions (``execute="torch"``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.launch.steps import ShapeSpec, model_flops_estimate
    from repro_torch.launch.train import train_main

    cfg = get_arch("llama3.2-1b", optimized=True)
    ckpt = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.time()
    params, history, driver = train_main(
        override_cfg=cfg, preset="full", steps=TRAIN_STEPS,
        global_batch=TRAIN_B, seq_len=TRAIN_S, checkpoint_dir=str(ckpt),
        checkpoint_every=10 * TRAIN_STEPS, lr=1e-3, log_every=1, seed=0,
        execute="kernel", device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    keys = dict(rsa_gemm_cuda.launches_by_key)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        opt_state_dtype="float32")
    flops = model_flops_estimate(cfg32, params, ShapeSpec(
        "train", TRAIN_S, TRAIN_B, "train"))
    losses = [h["loss"] for h in history]
    step_s = [e.seconds for e in driver.events]
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    chunks = -(-TRAIN_S // cfg.loss_chunk)      # loss chunks a step
    # under remat each forward GEMM runs twice (forward, recompute) and
    # has two gradient GEMMs; each layer's flash forward runs twice
    expect = {"rsa_gemm": 4 * (7 * cfg.num_layers + chunks),
              "flash_fwd": 2 * cfg.num_layers, "flash_dq": cfg.num_layers,
              "flash_dkv": cfg.num_layers}

    # the final checkpoint, restored and compared leaf for leaf
    state = {"params": params, "opt": driver.opt_state}
    t1 = time.time()
    latest, restored, _ = CheckpointManager(ckpt).restore(state)
    ckpt_same = all(torch.equal(a, b) for a, b in zip(
        _state_leaves(restored), _state_leaves(state)))
    n_leaves = sum(1 for _ in _state_leaves(state))
    restore_s = time.time() - t1
    del state, restored, params, driver.opt_state
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # a second run from the same init and data, one step, on the plain
    # versions
    ops.reset_counts()
    _, plain_hist, plain_driver = train_main(
        override_cfg=cfg, preset="full", steps=1, global_batch=TRAIN_B,
        seq_len=TRAIN_S, checkpoint_dir=str(ckpt), checkpoint_every=10,
        lr=1e-3, log_every=0, seed=0, execute="torch", device="cuda")
    plain_loss = plain_hist[0]["loss"]
    plain_gn = plain_hist[0]["grad_norm"]
    plain_counts = ops.launch_counts()
    del plain_driver
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    loss_err = abs(history[0]["loss"] - plain_loss) / abs(plain_loss)
    gn_err = abs(history[0]["grad_norm"] - plain_gn) / abs(plain_gn)
    med = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    tokens_per_step = TRAIN_B * TRAIN_S
    finite = all(math.isfinite(x) for x in losses)
    ok = (driver.restarts == 0 and finite and losses[-1] < losses[0]
          and len(history) == TRAIN_STEPS and counts["plain_calls"] == 0
          and all(counts[k] > 0 for k in expect) and ckpt_same
          and latest == TRAIN_STEPS and loss_err <= 1e-5 and gn_err <= 1e-4
          and plain_counts["plain_calls"] > 0
          and sum(v for k, v in plain_counts.items()
                  if k != "plain_calls") == 0)
    report["train_path"] = {
        "arch": cfg.name, "dtype": "float32", "batch": TRAIN_B,
        "seq": TRAIN_S, "steps": TRAIN_STEPS, "wall_s": wall,
        "losses": losses, "grad_norms": [h["grad_norm"] for h in history],
        "restarts": driver.restarts, "counts": counts,
        "launches_per_step": per_step, "expected_per_step": expect,
        "gemm_launches_by_shape": {
            f"{k[0]}x{k[1]}x{k[2]}:{k[3]}": v for k, v in keys.items()},
        "step_s": step_s, "median_step_s": med,
        "tokens_per_s": tokens_per_step / med,
        "model_flops_per_step": flops,
        "model_flops_share_f32_peak": flops / med / PEAK_F32_FLOPS,
        "peak_memory_gb": peak_gb, "checkpoint_step": latest,
        "checkpoint_leaves": n_leaves, "checkpoint_identical": ckpt_same,
        "checkpoint_restore_s": restore_s,
        "plain_step1_loss": plain_loss, "plain_step1_grad_norm": plain_gn,
        "step1_loss_rel_err": loss_err, "step1_grad_norm_rel_err": gn_err,
        "plain_counts": plain_counts}
    log(f"  trained {len(history)} steps in {wall:.2f} s (wall, with two "
        f"checkpoints), restarts {driver.restarts}, losses "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"  launches: {json.dumps(counts)}")
    log("  launches per step: " + ", ".join(
        f"{k} {per_step[k]:.1f} (expected {v})" for k, v in expect.items())
        + f", plain_calls {counts['plain_calls']}")
    log(f"  step {1e3 * med:.1f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{tokens_per_step / med:.1f} tokens/s, model FLOPs "
        f"{flops / 1e12:.2f} TFLOP a step = "
        f"{100 * flops / med / PEAK_F32_FLOPS:.2f}% of the f32 CUDA-core "
        f"peak (67 TFLOP/s); peak memory {peak_gb:.1f} GB")
    log(f"  checkpoint: step {latest}, {n_leaves} leaves restored "
        f"{'identical' if ckpt_same else 'DIFFERENT'} in {restore_s:.1f} s")
    log(f"  step 1 vs plain versions: loss {history[0]['loss']:.6f} vs "
        f"{plain_loss:.6f} (rel {loss_err:.2e}, tol 1e-5), grad_norm "
        f"{history[0]['grad_norm']:.6f} vs {plain_gn:.6f} (rel "
        f"{gn_err:.2e}, tol 1e-4)")
    if not ok:
        log("  TRAIN PATH FAIL")
    return ok, counts, keys


def train_breakdown(report, keys, counts):
    """Kernel time of one train step, estimated as each GEMM shape's and
    flash kernel's phase-3 time times its launches a step, beside the
    measured step time."""
    tp = report["train_path"]
    gemm = {r["key"]: r["ms"] for r in report["train_gemm"]}
    flash = next(r for r in report["flash"] if r["main"])["timed"]
    est = {"gemm": sum(gemm.get(k, 0.0) * n for k, n in keys.items())
           / TRAIN_STEPS,
           **{k: flash[k]["ms"] * counts[k] / TRAIN_STEPS for k in flash}}
    untimed = sorted(f"{k[0]}x{k[1]}x{k[2]}:{k[3]}" for k in keys
                     if k not in gemm)
    step_ms = 1e3 * tp["median_step_s"]
    total = sum(est.values())
    tp["kernel_ms_per_step_est"] = est
    tp["kernel_share_est"] = total / step_ms
    tp["untimed_gemm_shapes"] = untimed
    log(f"  per step: {step_ms:.1f} ms wall, {total:.1f} ms of it in kernels"
        f" (estimate, {100 * total / step_ms:.0f}%): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in est.items())
        + (f"; untimed GEMM shapes {untimed}" if untimed else ""))


# ---------------------------------------------------------------------------
# phase 8: rwkv6-1.6b (RWKV6, recurrent state) at full width
# ---------------------------------------------------------------------------

RW_REQUESTS, RW_SLOTS, RW_GEN, RW_LO, RW_HI = 16, 8, 32, 64, 512
RW_GEMM_SITES = 10                   # GEMM sites of one RWKV6 block


def rwkv_path(torch, report, timer, dispatcher):
    """``serve_continuous`` on rwkv6-1.6b at its published widths (24
    layers, d = 2048, 32 heads x 64, ff 7168, vocab 65536, untied), no
    depth cut, bf16, the reference's optimized profile (``ssm_impl=
    "pallas"``: the WKV kernel), the dense slot layout, 8 slots; 16
    requests of 64-512 tokens, 32 greedy new tokens, random weights from
    seed 0.  Then a batched prefill and a decode step against the plain
    versions, streaming against batch, and the path's GEMM shapes timed."""
    import numpy as np
    from repro_torch import dispatch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.linear_attn import wkv_bshk_cuda
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.launch.serve import serve_continuous

    cfg = get_arch("rwkv6-1.6b", optimized=True)
    L, V = cfg.num_layers, cfg.vocab_size
    per_call = RW_GEMM_SITES * L + 1           # + the unembedding
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.time()
    outputs, engine = serve_continuous(
        arch=cfg.name, preset="full", override_cfg=cfg,
        num_requests=RW_REQUESTS, num_slots=RW_SLOTS, prompt_len=RW_HI,
        min_prompt_len=RW_LO, gen=RW_GEN, temperature=0.0, top_k=0, seed=0,
        execute="auto", clock="wall", device="cuda", log=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    gemm_keys = dict(rsa_gemm_cuda.launches_by_key)
    # a decode step scans with chunk 1, a prefill (64-512 tokens) with 64
    by_chunk = dict(wkv_bshk_cuda.launches_by_chunk)
    wkv = {"decode": by_chunk.get(1, 0),
           "prefill": sum(n for c, n in by_chunk.items() if c > 1)}
    s = engine.summary()
    done = [r for r in engine.requests.values() if r.outcome == "done"]
    engine.pool.check()
    # one unembedding a model call: M = 1 at a prefill (the last row), M =
    # the slots at a decode step
    prefills = sum(n for k, n in gemm_keys.items() if k[2] == V and k[0] == 1)
    decodes = sum(n for k, n in gemm_keys.items()
                  if k[2] == V and k[0] == RW_SLOTS)
    calls = prefills + decodes
    weights_gb = sum(t.numel() * t.element_size()
                     for t in _leaves(engine.params)) / 1e9
    plan_ok = bool(engine.gemm_plan) and all(
        "@kernel" in d for d in engine.gemm_plan.values())
    others = sum(n for k, n in counts.items()
                 if k not in ("rsa_gemm", "wkv_bshk", "plain_calls"))
    leak_free = engine.pool.num_free == engine.pool.num_blocks
    ok = (len(done) == RW_REQUESTS
          and all(len(v) == RW_GEN for v in outputs.values()) and leak_free
          and cfg.ssm_impl == "pallas" and engine.kv_layout == "dense"
          and prefills == RW_REQUESTS and decodes == s["decode_steps"] > 0
          and counts["wkv_bshk"] == L * calls
          and wkv == {"decode": L * decodes, "prefill": L * prefills}
          and counts["rsa_gemm"] == per_call * calls
          and counts["plain_calls"] == 0 and others == 0 and plan_ok)
    lens = [r.prompt_len for r in engine.requests.values()]
    res = report["rwkv_path"] = {
        "config": {"d_model": cfg.d_model, "num_layers": L,
                   "heads": cfg.d_model // cfg.ssm.head_dim,
                   "head_dim": cfg.ssm.head_dim, "d_ff": cfg.d_ff,
                   "vocab": V, "ssm_impl": cfg.ssm_impl,
                   "chunk": cfg.ssm.chunk},
        "weights_gb": weights_gb, "requests": RW_REQUESTS,
        "completed": len(done), "wall_s": wall, "prompt_lens": lens,
        "counts": counts, "gemm_launches_by_shape": {
            f"{k[0]}x{k[1]}x{k[2]}:{k[3]}": v for k, v in gemm_keys.items()},
        "prefill_steps": prefills, "decode_steps": decodes,
        "wkv_launches": wkv, "wkv_launches_by_chunk": by_chunk,
        "launches_per_call": {"wkv_bshk": counts["wkv_bshk"] / max(calls, 1),
                              "rsa_gemm": counts["rsa_gemm"]
                              / max(calls, 1)},
        "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"],
        "decode_tok_s": s["decode_tok_s"], "prefill_tok_s": s["prefill_tok_s"],
        "decode_wall_s": engine.metrics.decode_s,
        "prefill_wall_s": engine.metrics.prefill_s,
        "kv_layout": engine.kv_layout, "gemm_plan": engine.gemm_plan,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "pool_leak_free": leak_free}
    log(f"  {weights_gb:.2f} GB of bf16 weights (seed 0), ssm_impl "
        f"{cfg.ssm_impl!r}, kv_layout {engine.kv_layout!r}")
    log(f"  served {len(done)}/{RW_REQUESTS} requests in {wall:.2f} s "
        f"({engine.steps} engine steps: {prefills} prefill, {decodes} decode"
        f" model calls), pool leak-free {leak_free}")
    log(f"  launches: {json.dumps(counts)}; wkv_bshk by chunk "
        f"{json.dumps(by_chunk)}: {wkv['prefill']} in prefill calls "
        f"({L} x {prefills}), {wkv['decode']} in decode steps ({L} x "
        f"{decodes})")
    log(f"  launches per model call: wkv_bshk "
        f"{counts['wkv_bshk'] / max(calls, 1):.1f} ({L}), rsa_gemm "
        f"{counts['rsa_gemm'] / max(calls, 1):.1f} ({RW_GEMM_SITES} x {L} + "
        f"unembed = {per_call}), plain_calls {counts['plain_calls']}")
    log(f"  ttft p50 {s['ttft_p50_s']:.4f} s p99 {s['ttft_p99_s']:.4f} s, "
        f"decode {s['decode_tok_s']:.1f} tok/s, prefill "
        f"{s['prefill_tok_s']:.1f} tok/s, peak memory "
        f"{res['peak_mem_gb']:.1f} GB")
    log("  gemm plan (recommendation, then what the kernel ran):")
    for site, desc in engine.gemm_plan.items():
        log(f"    {site:<16} {desc}")
    if not ok:
        log(f"  RWKV PATH FAIL: completed {len(done)}, leak-free "
            f"{leak_free}, calls {prefills}+{decodes}, plan ok {plan_ok}, "
            f"counts {counts}, wkv_bshk {wkv}")

    # a batched prefill (8 prompts of 100 tokens: a ragged second chunk)
    # and one decode step, kernels vs plain versions, with each call's
    # launches; in bf16 as served, then with the same weights in f32
    from repro_torch.models.api import build_model
    model, params = engine.model, engine.params
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, V, (RW_SLOTS, 100)),
                           device="cuda")
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params32 = _map_tree(params, lambda t: t.float())
    out, nxt, launches = {}, None, {}
    for dt, m, p in (("bf16", model, params),
                     ("f32", build_model(cfg32, "cuda"), params32)):
        for mode in ("torch", "kernel"):
            with torch.no_grad(), dispatch.use(execute=mode):
                ops.reset_counts()
                pl, cache = m.prefill(p, {"tokens": toks},
                                      m.init_cache(RW_SLOTS))
                torch.cuda.synchronize()
                c_pre = ops.launch_counts()
                if nxt is None:      # every run decodes the same tokens
                    nxt = pl.argmax(-1)[:, None]
                ops.reset_counts()
                dl, _ = m.decode_step(p, nxt, cache)
                torch.cuda.synchronize()
                c_dec = ops.launch_counts()
            out[dt, mode] = (pl, dl)
            launches[dt, mode] = (c_pre, c_dec)
    del params32
    good = all(c["wkv_bshk"] == L and c["rsa_gemm"] == per_call
               and c["plain_calls"] == 0
               for key in (("bf16", "kernel"), ("f32", "kernel"))
               for c in launches[key])
    c_pre, c_dec = launches["bf16", "kernel"]
    res["check_launches"] = {"prefill": c_pre, "decode": c_dec}
    log(f"  one prefill call: wkv_bshk {c_pre['wkv_bshk']}, rsa_gemm "
        f"{c_pre['rsa_gemm']}; one decode step: wkv_bshk "
        f"{c_dec['wkv_bshk']}, rsa_gemm {c_dec['rsa_gemm']} "
        f"({'ok' if good else 'FAIL'})")
    # Held to 5% of the logits' largest magnitude, as phases 4-6, in f32.
    # Through this random-weight 24-layer stack the one-ulp rounding flips
    # of the two paths' bf16 GEMM outputs grow past 5%, and the plain bf16
    # run itself lands further from the plain f32 run than from the
    # kernels (both printed below), so in bf16 the kernels are held to
    # that floor: no further from the plain bf16 run than the plain bf16
    # run is from the plain f32 run.
    for i, name in ((0, "prefill"), (1, "decode")):
        def diff(a, b):
            return (out[a][i] - out[b][i]).abs().max().item()
        err = diff(("f32", "kernel"), ("f32", "torch"))
        tol = 0.05 * out["f32", "torch"][i].abs().max().item()
        err16 = diff(("bf16", "kernel"), ("bf16", "torch"))
        floor16 = diff(("bf16", "torch"), ("f32", "torch"))
        agree = {dt: (out[dt, "kernel"][i].argmax(-1) ==
                      out[dt, "torch"][i].argmax(-1)).float().mean().item()
                 for dt in ("bf16", "f32")}
        g = err <= tol and math.isfinite(err) and err16 <= floor16 and \
            math.isfinite(err16)
        good &= g
        res.update({f"{name}_logits_f32_max_abs_err": err,
                    f"{name}_logits_f32_tol": tol,
                    f"{name}_logits_bf16_max_abs_err": err16,
                    f"{name}_logits_bf16_plain_vs_f32": floor16,
                    f"{name}_greedy_agreement": agree})
        log(f"  {name} logits, kernels vs plain: f32 max_abs_err {err:.4e} "
            f"(tol {tol:.4e}), bf16 {err16:.4e} (bf16 plain vs f32 plain "
            f"{floor16:.4e}) {'ok' if g else 'FAIL'}; greedy agreement "
            f"f32 {agree['f32']:.3f}, bf16 {agree['bf16']:.3f}")
    del out

    # streaming equals batch: decode logits after t streamed tokens (chunk
    # 1 from the carried state) against one prefill of the prompt plus
    # those tokens (chunks of 64)
    prompt = torch.as_tensor(rng.integers(0, V, (1, 200)), device="cuda")
    worst = []
    with torch.no_grad(), dispatch.use(execute="kernel"):
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      model.init_cache(1))
        seq = prompt
        for _ in range(4):
            nxt = logits.argmax(-1)[:, None]
            seq = torch.cat([seq, nxt], 1)
            logits, cache = model.decode_step(params, nxt, cache)
            batch, _ = model.prefill(params, {"tokens": seq},
                                     model.init_cache(1))
            worst.append(((logits - batch).abs().max().item(),
                          0.05 * batch.abs().max().item()))
    g = all(e <= t and math.isfinite(e) for e, t in worst)
    good &= g
    res["streaming_vs_batch"] = worst
    log("  streaming vs batch (decode after t tokens vs one prefill of "
        "prompt + t): " + ", ".join(f"t={i + 1} {e:.4e} (tol {t:.4e})"
                                    for i, (e, t) in enumerate(worst))
        + f" {'ok' if g else 'FAIL'}")
    del engine, model, params, cache
    torch.cuda.empty_cache()

    # the path's GEMM shapes, every one held against its plain version:
    # the decode shapes (M = 8), and for each prefill (K, N, mode) its
    # largest and smallest M, timed beside the plain version and matmul;
    # the other prefill shapes timed as the kernel alone
    pre = [k for k in gemm_keys if k[0] != RW_SLOTS]
    ms_of = {}
    for M, K, N, mode in pre:
        ms_of.setdefault((K, N, mode), []).append(M)
    full = {k for k in gemm_keys if k[0] == RW_SLOTS} | {
        (f(ms), *knm) for knm, ms in ms_of.items() for f in (min, max)}
    log("  the path's GEMM shapes, kernel vs plain (bf16): decode, and each "
        "prefill (K, N, mode) at its largest and smallest M")
    g_ok, recs = check_gemm_keys(torch, timer, full, dispatcher, V)
    report["rwkv_gemm"] = recs
    q_ok, q_recs = check_gemm_keys(torch, timer, set(pre) - full, dispatcher,
                                   V, quick=Timer(torch, reps=5))
    report["rwkv_prefill_gemm"] = q_recs
    pre_ms = {r["key"]: r["ms"] for r in recs + q_recs if r["M"] != RW_SLOTS}
    if q_recs:
        w = max(q_recs, key=lambda r: r["max_abs_err"] / r["tol"])
        bitwise = sum(r["ws_is_bitwise"] and r["run_to_run_bitwise"]
                      for r in q_recs)
        log(f"  the other {len(q_recs)} prefill GEMM shapes, kernel vs "
            f"plain: {sum(r['ok'] for r in q_recs)} ok, worst max_abs_err "
            f"{w['max_abs_err']:.3e} (tol {w['tol']:.3e}, {w['M']}x{w['K']}"
            f"x{w['N']} {w['mode']}) {'ok' if q_ok else 'FAIL'}; kernel "
            f"timed (median of 5); WS == IS and run to run bitwise at "
            f"{bitwise} of {len(q_recs)}")
    return ok and good and g_ok and q_ok, counts, gemm_keys, pre_ms


def rwkv_breakdown(report, gemm_keys, counts, pre_ms):
    """Phase 8's kernel time, estimated as in ``deepseek_breakdown``: each
    GEMM shape's time times its launches, and the WKV kernel's phase-3
    time (decode: per launch; prefill: per 64-row chunk of the S = 512
    case, times each prompt's chunks), beside the wall time of the model
    calls."""
    rp = report["rwkv_path"]
    L = rp["config"]["num_layers"]
    timed = {r["key"]: r["ms"] for r in report["rwkv_gemm"]}
    timed.update(pre_ms)
    wkv = {r["case"]: r for r in report["wkv"]
           if r["kernel"] == "wkv_bshk" and "ms" in r}
    est = {"decode": 0.0, "prefill": 0.0}
    for key, n in gemm_keys.items():
        est["decode" if key[0] == RW_SLOTS else "prefill"] += \
            timed.get(key, 0.0) * n
    est["decode"] += wkv["decode"]["ms"] * L * rp["decode_steps"]
    per_chunk = wkv["prefill"]["ms"] / (wkv["prefill"]["S"] //
                                        wkv["prefill"]["chunk"])
    est["prefill"] += per_chunk * L * sum(-(-n // 64)
                                          for n in rp["prompt_lens"])
    out = {}
    for phase in ("decode", "prefill"):
        wall_ms = rp[f"{phase}_wall_s"] * 1e3
        n = max(rp[f"{phase}_steps"], 1)
        out[phase] = {"steps": rp[f"{phase}_steps"],
                      "wall_ms_per_step": wall_ms / n,
                      "kernel_ms_per_step_est": est[phase] / n,
                      "kernel_share_est": est[phase] / wall_ms}
        log(f"  {phase}: {wall_ms / n:.2f} ms per call (wall), "
            f"{est[phase] / n:.2f} ms of it in kernels (estimate, "
            f"{100 * est[phase] / wall_ms:.0f}%)")
    rp["time_breakdown"] = out


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def deepseek_breakdown(report, gemm_keys, counts):
    """Phase 6's kernel time, estimated as in ``time_breakdown``: each GEMM
    shape's time (2-D shapes timed after the run, banks and MLA in phase 3)
    times its launches, beside the wall time of the model calls."""
    mp = report["deepseek_path"]
    from repro_torch.models.moe import row_capacity
    V, E_pad = mp["config"]["vocab"], mp["config"]["experts_padded"]
    cfg = deepseek_cfg()
    m_dec, m_pre = (DS_SLOTS * row_capacity(1, cfg),
                    DS_SLOTS * row_capacity(64, cfg))
    timed = {r["key"]: r["ms"] for r in report["ds_gemm"]}
    timed.update({r["key"]: r["ms"] for r in report["bank"]
                  if r.get("recommended")})
    mla = {r["kernel"]: r["ms"] for r in report["mla"] if "ms" in r}
    est = {"decode": 0.0, "prefill": 0.0}
    steps = {p: mp[f"{p}_steps"] for p in est}
    for key, n in gemm_keys.items():
        ms = timed.get(key, 0.0)
        expert = len(key) == 5 and key[0] == E_pad
        if (len(key) == 4 and key[2] == V) or (expert and m_dec == m_pre):
            # the same shape at decode and prefill: split by model calls
            per = n / (steps["decode"] + steps["prefill"])
            est["decode"] += ms * per * steps["decode"]
            est["prefill"] += ms * per * steps["prefill"]
        else:
            M = key[1] if len(key) == 5 else key[0]
            dec = M == (m_dec if expert else DS_SLOTS)
            est["decode" if dec else "prefill"] += ms * n
    est["decode"] += mla["paged_mla_decode"] * counts["paged_mla_decode"]
    est["prefill"] += mla["paged_mla_prefill"] * counts["paged_mla_prefill"]
    out = {}
    for phase in ("decode", "prefill"):
        wall_ms = mp[f"{phase}_wall_s"] * 1e3
        n = max(steps[phase], 1)
        out[phase] = {"steps": steps[phase], "wall_ms_per_step": wall_ms / n,
                      "kernel_ms_per_step_est": est[phase] / n,
                      "kernel_share_est": est[phase] / wall_ms}
        log(f"  {phase}: {wall_ms / n:.2f} ms per step (wall), "
            f"{est[phase] / n:.2f} ms of it in kernels (estimate, "
            f"{100 * est[phase] / wall_ms:.0f}%)")
    mp["time_breakdown"] = out


def time_breakdown(report, path, gemm_keys, counts):
    """Kernel time a path spent (``report[path]``: phase 4's main path or
    phase 5's cascade path), estimated as each kernel's median time at its
    main-path shape (phase 3, L2 cold) times its launches, beside the wall
    time of the model calls (host work included)."""
    mp = report[path]
    timed = {r["key"]: r["ms"] for r in report["gemm"] if r.get("recommended")}
    attn = {r["kernel"]: r["ms"] for r in report["paged"] if "ms" in r}
    unembed = [k for k in timed if k[2] > 100000]
    est = {"decode": 0.0, "prefill": 0.0}
    for key, n in gemm_keys.items():
        if key in unembed:
            continue
        est["decode" if key[0] == 8 else "prefill"] += timed.get(key, 0.0) * n
    for k in unembed:
        est["decode"] += timed[k] * mp["decode_steps"]
        est["prefill"] += timed[k] * mp["prefill_steps"]
    for name in ("paged_decode", "paged_prefix", "paged_decode_lse"):
        est["decode"] += attn[name] * counts[name]
    est["prefill"] += attn["paged_prefill"] * counts["paged_prefill"]
    out = {}
    for phase in ("decode", "prefill"):
        steps = mp[f"{phase}_steps"]
        wall_ms = mp[f"{phase}_wall_s"] * 1e3
        out[phase] = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
                      "kernel_ms_per_step_est": est[phase] / steps,
                      "kernel_share_est": est[phase] / wall_ms}
        log(f"  {phase}: {wall_ms / steps:.2f} ms per step (wall), "
            f"{est[phase] / steps:.2f} ms of it in kernels (estimate, "
            f"{100 * est[phase] / wall_ms:.0f}%)")
    mp["time_breakdown"] = out


# ---------------------------------------------------------------------------
# phase 9: the self-adaptive paths (ADAPTNET trained and served)
# ---------------------------------------------------------------------------

def top2_gap(logits) -> float:
    top = logits.topk(2).values
    return (top[0] - top[1]).item()


def selfadaptive_gemm_path(torch, report, timer):
    """Path A: ``launch.selfadaptive_gemm.run`` as a user runs it, with
    the counts at 0 just before; then each layer's ADAPTNETX logits
    against the plain version, its pick against the host twin, its GEMM
    against the plain GEMM, and (after the counts are read) its query
    and its GEMM timed by ``timer`` (L2 flushed), with the query's share
    of the two.  Returns (ok, counts)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.adaptnetx import OPERANDS, adaptnetx_plain
    from repro_torch.kernels.rsa_gemm import rsa_gemm_plain
    from repro_torch.launch.selfadaptive_gemm import run

    ops.reset_counts()
    t0 = time.time()
    res = run(n_samples=SA_SAMPLES, epochs=SA_EPOCHS, layers=SA_LAYERS,
              seed=0, device="cuda", log=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    ok = (counts["adaptnetx"] == SA_LAYERS and counts["plain_calls"] == 0
          and counts["rsa_gemm"] > 0)
    p = res["params"]
    layers = []
    for r in res["layers"]:
        want = adaptnetx_plain(r["ids"][None], *(p[k] for k in OPERANDS))[0]
        plain = rsa_gemm_plain(r["a"], r["b"], block_k=r["cfg"].block_k,
                               mode=r["cfg"].mode)
        torch.cuda.synchronize()
        err = (r["logits"] - want).abs().max().item()
        gap = top2_gap(want)
        pick_ok = r["cid"] == r["host_cid"] or \
            gap <= 2e-5 * (1 + want.abs().max().item())
        g_err = (r["out"] - plain).abs().max().item()
        g_tol = gemm_tolerance(torch, r["a"], r["b"], plain, r["cfg"].mode,
                               r["cfg"].block_k, True)
        good = adaptnetx_close(r["logits"], want) and pick_ok and \
            g_err <= g_tol
        ok &= good
        cfg = r["cfg"]
        q_ms = timer(lambda: ops.adaptnetx_recommend(r["ids"], p))
        g_ms = timer(lambda: ops.rsa_gemm(
            r["a"], r["b"], block_m=cfg.block_m, block_n=cfg.block_n,
            block_k=cfg.block_k, mode=cfg.mode))
        layers.append({"name": r["name"], "M": r["M"], "K": r["K"],
                       "N": r["N"], "tile": cfg.describe(),
                       "class": r["cid"], "host_class": r["host_cid"],
                       "top2_gap": gap, "logits_max_abs_err": err,
                       "gemm_max_abs_err": g_err, "gemm_tol": g_tol,
                       "gemm_ms": r["ms"], "query_timer_ms": q_ms,
                       "gemm_timer_ms": g_ms,
                       "query_share": q_ms / (q_ms + g_ms), "ok": good})
        log(f"  A {r['name']:>4} {r['M']}x{r['K']}x{r['N']}: ADAPTNETX "
            f"class {r['cid']} [{cfg.describe()}], host twin "
            f"{r['host_cid']}; logits err {err:.2e} (tol 1e-5 + 1e-5 "
            f"|plain|); f32 GEMM "
            f"err {g_err:.2e} (tol {g_tol:.2e}) {r['ms']:.4f} ms "
            f"{'ok' if good else 'FAIL'}\n"
            f"      L2 cold: query {q_ms:.4f} ms, GEMM {g_ms:.4f} ms, the "
            f"query {100 * q_ms / (q_ms + g_ms):.1f}% of the two")
    report["selfadaptive_gemm"] = {
        "samples": SA_SAMPLES, "epochs": SA_EPOCHS, "wall_s": wall,
        "test_accuracy": res["accuracy"],
        "geomean_rel_time_tpu_model": res["geomean_rel_time"],
        "counts": counts, "layers": layers}
    log(f"  A: trained in-run, test accuracy {res['accuracy']:.4f} "
        f"(TPU cost model's geomean pick/best {res['geomean_rel_time']:.4f},"
        f" a TPU-model number); {counts['adaptnetx']} ADAPTNETX launches "
        f"(expected {SA_LAYERS}), {counts['rsa_gemm']} RSA GEMM launches, "
        f"plain_calls {counts['plain_calls']}; {wall:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    return ok, counts


def adaptnet_serving_path(torch, report):
    """Path B: a logbucket net trained on the card over llama3.2-1b's
    serving shapes and saved; llama3.2-1b served at full width (bf16,
    phase 4's weights: seed 0) through ``serve_continuous(...,
    dispatcher="adaptnet")`` with it; then a chunk-prefill and a decode
    step under the net's plan against the plain versions (5%, as phase
    4)."""
    import numpy as np
    from repro_torch import dispatch
    from repro_torch.core.adaptnet import trained_max_dim
    from repro_torch.core.sara import SaraDispatcher
    from repro_torch.dispatch.executor import _clamped_blocks
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import _launch_plan
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.launch.train_adaptnet import (save_adaptnet,
                                                   serving_gemm_shapes,
                                                   train_serving_adaptnet)

    t0 = time.time()
    params, info = train_serving_adaptnet(
        SB_SAMPLES, SB_EPOCHS, shapes=serving_gemm_shapes(("llama3.2-1b",)),
        seed=0, log=False, device="cuda")
    ckpt = ROOT / "build" / "chip_smoke_adaptnet"
    shutil.rmtree(ckpt, ignore_errors=True)
    save_adaptnet(str(ckpt), params, info)
    train_s = time.time() - t0
    ops.reset_counts()
    t1 = time.time()
    outputs, engine = serve_continuous(
        arch="llama3.2-1b", preset="full", num_requests=SB_REQUESTS,
        num_slots=8, prompt_len=512, min_prompt_len=64, gen=SB_GEN,
        temperature=0.0, top_k=0, seed=0, execute="auto", prefill_chunk=64,
        block_size=16, clock="wall", device="cuda", dispatcher="adaptnet",
        adaptnet_ckpt=str(ckpt), log=False)
    torch.cuda.synchronize()
    wall = time.time() - t1
    counts = ops.launch_counts()
    shutil.rmtree(ckpt, ignore_errors=True)
    s = engine.summary()
    done = [r for r in engine.requests.values() if r.outcome == "done"]
    engine.pool.check()
    disp = engine.dispatcher
    dim_max = trained_max_dim(disp.adaptnet_params)
    recs = [r for sc in engine.registry.scopes()
            for r in engine.registry.sites(sc).values()]
    fallback = {(r.m, r.k, r.n) for r in recs if r.source == "oracle_fallback"}
    past = {(r.m, r.k, r.n) for r in recs if max(r.m, r.k, r.n) > dim_max}
    oracle = SaraDispatcher()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def oracle_tile(r):
        c = oracle.recommend(r.m, r.k, r.n)
        return _clamped_blocks(c, r.m, r.k, r.n) + (c.mode,)
    # recommendations unlike the oracle's, and plans the card ran unlike the
    # one the oracle's block_k and mode would have run (llama3.2-1b has no
    # bank: E = 1; its forward GEMMs read x row-major, bf16)
    differ = sum(r.executed() != oracle_tile(r) for r in recs)
    ran_differ = sum(r.ran_plan() != _launch_plan(
        1, r.m, r.k, r.n, oracle_tile(r)[2], oracle_tile(r)[3],
        torch.bfloat16, sms)[1] for r in recs)
    ok = (len(done) == SB_REQUESTS
          and all(len(v) == SB_GEN for v in outputs.values())
          and engine.pool.num_free == engine.pool.num_blocks
          and disp.mode == "adaptnet" and s["rec_adaptnet_sites"] > 0
          and fallback == past and all(r.backend == "kernel" for r in recs)
          and all("@kernel" in d for d in engine.gemm_plan.values())
          and counts["plain_calls"] == 0 and counts["rsa_gemm"] > 0
          and counts["paged_decode"] > 0 and counts["paged_prefill"] > 0)
    main = report.get("main_path", {})
    res = report["adaptnet_serving"] = {
        "train_samples": SB_SAMPLES, "train_epochs": SB_EPOCHS,
        "train_s": train_s, "net_accuracy": info["accuracy"],
        "geomean_rel_time_tpu_model": info["geomean_rel_time"],
        "dim_max": dim_max, "requests": SB_REQUESTS,
        "completed": len(done), "wall_s": wall, "counts": counts,
        "rec_adaptnet_sites": s["rec_adaptnet_sites"],
        "rec_oracle_sites": s["rec_oracle_sites"],
        "rec_fallback_sites": s["rec_fallback_sites"],
        "executed_sites": len(recs),
        "sites_recommended_unlike_oracle": differ,
        "sites_ran_unlike_oracle": ran_differ,
        "source_info": disp.source_info(),
        "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"],
        "decode_tok_s": s["decode_tok_s"],
        "main_path_ttft_p50_s": main.get("ttft_p50_s"),
        "main_path_decode_tok_s": main.get("decode_tok_s"),
        "gemm_plan": engine.gemm_plan,
        "pool_leak_free": engine.pool.num_free == engine.pool.num_blocks}
    log(f"  B: net trained in-run in {train_s:.1f} s (test accuracy "
        f"{info['accuracy']:.4f}, dim_max {dim_max}); served "
        f"{len(done)}/{SB_REQUESTS} in {wall:.2f} s, mode {disp.mode}, "
        f"rec_adaptnet_sites {s['rec_adaptnet_sites']}, rec_fallback_sites "
        f"{s['rec_fallback_sites']} (shapes past dim_max: {len(past)}), "
        f"plain_calls {counts['plain_calls']} {'ok' if ok else 'FAIL'}")
    log(f"  B: {differ} of {len(recs)} executed sites recommended unlike "
        f"the oracle, {ran_differ} ran a plan unlike the oracle's on the "
        f"card; ttft p50 {s['ttft_p50_s']:.4f} s, decode "
        f"{s['decode_tok_s']:.1f} tok/s (phase 4, oracle, 16 requests of "
        f"32 tokens: {main.get('ttft_p50_s', float('nan')):.4f} s, "
        f"{main.get('decode_tok_s', float('nan')):.1f} tok/s; context only)")
    log("  gemm plan (adaptnet; recommendation, then what the kernel ran):")
    for site, desc in engine.gemm_plan.items():
        log(f"    {site:<16} {desc}")

    # one chunk-prefill and one decode step under the net's plan, kernels
    # against the plain versions, as phase 4
    model, wts, cfg = engine.model, engine.params, engine.cfg
    rng = np.random.default_rng(7)
    S, C, bs = 8, 64, 16
    W = -(-(C + 1) // bs)
    tables = torch.arange(S * W, dtype=torch.int32,
                          device="cuda").reshape(S, W)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (S, C)),
                           device="cuda")
    chunk = torch.as_tensor([64, 64, 40, 17, 64, 1, 33, 64],
                            dtype=torch.int32, device="cuda")
    kv0 = torch.zeros(S, dtype=torch.int32, device="cuda")
    out = {}
    nxt = None
    for mode in ("torch", "kernel"):
        arena = model.init_paged_arena(S * W + 1, bs)
        with torch.no_grad(), dispatch.use(disp, execute=mode):
            pl, _ = model.paged_prefill_step(wts, toks, arena, tables, kv0,
                                             chunk)
            if nxt is None:
                nxt = pl.argmax(-1)[:, None]
            dl, _ = model.paged_decode_step(
                wts, nxt, arena, tables, chunk,
                torch.ones(S, dtype=torch.int32, device="cuda"))
        out[mode] = (pl, dl)
    torch.cuda.synchronize()
    for i, name in ((0, "prefill"), (1, "decode")):
        want = out["torch"][i]
        err = (out["kernel"][i] - want).abs().max().item()
        tol = 0.05 * want.abs().max().item()
        g = err <= tol and math.isfinite(err)
        ok &= g
        res[f"{name}_logits_max_abs_err"] = err
        res[f"{name}_logits_tol"] = tol
        log(f"  B: {name} step logits under the adaptnet plan, kernels vs "
            f"plain: max_abs_err {err:.4e} (tol {tol:.4e}) "
            f"{'ok' if g else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 10: speculative decoding
# ---------------------------------------------------------------------------

SPEC_CALLS = ("paged_verify_step", "paged_decode_step", "paged_prefill_step")


def context_logits(torch, model, params, tokens, bs, chunk=64):
    """f32 logits (V,) after one lane's ``tokens`` through the model's
    chunked prefill on a fresh arena: what greedy decode picks the next
    token from."""
    import numpy as np
    n, dev = len(tokens), params["embed"].device
    pages = -(-n // bs)
    arena = model.init_paged_arena(pages + 1, bs)
    tables = torch.arange(pages, dtype=torch.int32, device=dev)[None]
    t = torch.as_tensor(np.asarray(tokens, np.int32), device=dev)[None]
    i32 = dict(dtype=torch.int32, device=dev)
    with torch.no_grad():
        for p0 in range(0, n, chunk):
            c = min(chunk, n - p0)
            logits, _ = model.paged_prefill_step(
                params, t[:, p0:p0 + c], arena, tables,
                torch.tensor([p0], **i32), torch.tensor([c], **i32))
    return logits[0]


def first_difference(torch, model, params, prompt, want, got, bs):
    """The first position where ``got`` leaves ``want`` (None where they
    agree), the top-2 gap of the model's logits there after ``prompt`` and
    ``want``'s tokens before it, and the largest logit's magnitude."""
    p = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if p is None:
        return None, 0.0, 0.0
    logits = context_logits(torch, model, params,
                            list(prompt) + list(want[:p]), bs)
    return p, top2_gap(logits), logits.abs().max().item()


class CallLaunches:
    """Counts, for every call of the model's paged steps while it is
    installed, the kernel launches that call made (``ops.launch_counts``
    before and after): the phase's per-call launch gates.  ``model`` of a
    call is the ``Model`` it ran on (the target's or the draft's)."""

    KEYS = ("rsa_gemm", "paged_prefill", "paged_decode", "plain_calls")

    def __init__(self):
        from repro_torch.models.api import Model
        self.cls, self.calls = Model, []
        self.orig = {n: getattr(Model, n) for n in SPEC_CALLS}

    def __enter__(self):
        from repro_torch.kernels import ops

        def wrap(name, fn):
            def run(model, *a, **k):
                before = ops.launch_counts()
                out = fn(model, *a, **k)
                after = ops.launch_counts()
                self.calls.append((name, id(model), {
                    key: after[key] - before[key] for key in self.KEYS}))
                return out
            return run
        for name, fn in self.orig.items():
            setattr(self.cls, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)

    def of(self, name, model=None):
        return [d for n, m, d in self.calls
                if n == name and (model is None or m == id(model))]


def spec_path(torch, report, timer, dispatcher):
    """10a: phase 4's trace served with ``spec_draft="self", spec_k=4``."""
    import numpy as np
    from repro_torch import dispatch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.launch.serve import serve_continuous

    smi = nvidia_smi_line()
    ops.reset_counts()
    t0 = time.time()
    with CallLaunches() as calls:
        outputs, engine = serve_continuous(
            arch="llama3.2-1b", preset="full", num_requests=16, num_slots=8,
            prompt_len=512, min_prompt_len=64, gen=32, temperature=0.0,
            top_k=0, seed=0, execute="auto", prefill_chunk=64,
            block_size=16, clock="wall", device="cuda", log=False,
            spec_draft="self", spec_k=SPEC_K)
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    gemm_keys = dict(rsa_gemm_cuda.launches_by_key)
    cfg, L = engine.cfg, engine.cfg.num_layers
    s = engine.summary()
    done = [r for r in engine.requests.values() if r.outcome == "done"]
    engine.pool.check()
    engine.spec.check()
    whole = (engine.pool.num_free == engine.pool.num_blocks
             and engine.spec.live_pages() == 0)
    verify = calls.of("paged_verify_step")
    drafts = calls.of("paged_decode_step", engine.spec.model)
    catchup = calls.of("paged_prefill_step", engine.spec.model)
    prefill = calls.of("paged_prefill_step", engine.model)
    n_gemm = 7 * L + 1
    per_call = {"verify": (verify, "paged_prefill"),
                "draft round": (drafts, "paged_decode"),
                "draft catch-up": (catchup, "paged_prefill"),
                "target prefill": (prefill, "paged_prefill")}
    launch_ok = (len(verify) == s["spec_steps"] > 0
                 and len(drafts) % SPEC_K == 0 and len(drafts) > 0
                 and len(calls.of("paged_decode_step", engine.model)) == 0)
    for what, (cs, attn) in per_call.items():
        launch_ok &= all(
            d["rsa_gemm"] == n_gemm and d[attn] == L and d["plain_calls"] == 0
            and sum(d.values()) == n_gemm + L for d in cs)
    launch_ok &= (counts["plain_calls"] == 0
                  and counts["paged_decode"] == L * len(drafts)
                  and counts["paged_prefill"] == L * (
                      len(verify) + len(catchup) + len(prefill)))
    plans = dict(engine.gemm_plan)
    plans.update({f"spec_draft {n}": d for n, d in
                  engine.registry.plan("spec_draft").items()})
    at_kernel = all("@kernel" in d for d in plans.values())
    ok = (len(done) == 16 and all(len(v) == 32 for v in outputs.values())
          and whole and s["spec_steps"] > 0
          and s["spec_accepted_per_step"] > 1.0 and launch_ok and at_kernel)
    steps = s["spec_steps"]
    # lanes a verify step served (no lane stalls under full reservation)
    lane_steps = round(sum(engine.metrics.slot_occupancy) * 8)
    per_lane = (s["spec_accepted_tokens"] + s["spec_bonus_tokens"]) / \
        max(lane_steps, 1)
    res = report["spec_path"] = {
        "requests": 16, "completed": len(done), "wall_s": wall,
        "counts": counts, "spec_steps": steps,
        "verify_calls": len(verify), "draft_rounds": len(drafts),
        "draft_catchup_calls": len(catchup),
        "target_prefill_calls": len(prefill),
        "spec_drafted_tokens": s["spec_drafted_tokens"],
        "spec_accepted_tokens": s["spec_accepted_tokens"],
        "spec_bonus_tokens": s["spec_bonus_tokens"],
        "spec_accept_rate": s["spec_accept_rate"],
        "spec_accepted_per_step": s["spec_accepted_per_step"],
        "lane_steps": lane_steps, "committed_per_lane_step": per_lane,
        "stalls": s["stalls"],
        "spec_draft_preempts": s["spec_draft_preempts"],
        "decode_tok_s": s["decode_tok_s"], "ttft_p50_s": s["ttft_p50_s"],
        "decode_wall_s": engine.metrics.decode_s,
        "prefill_wall_s": engine.metrics.prefill_s,
        "launches_per_call_ok": launch_ok, "plans_at_kernel": at_kernel,
        "gemm_plan": engine.gemm_plan, "pools_whole": whole,
        "kv_draft_leaked_blocks": s["kv_draft_leaked_blocks"]}
    log(f"  served {len(done)}/16 requests in {wall:.2f} s: {steps} spec "
        f"steps ({len(verify)} verify calls, {len(drafts)} draft rounds, "
        f"{len(catchup)} draft catch-up chunks), {len(prefill)} target "
        f"chunk-prefill calls")
    log(f"  launches: {json.dumps(counts)}")
    for what, (cs, attn) in per_call.items():
        seen = sorted({(d["rsa_gemm"], d[attn]) for d in cs})
        log(f"  per {what} call: (rsa_gemm, {attn}) {seen} over {len(cs)} "
            f"calls (expected [({n_gemm}, {L})])")
    log(f"  every plan line @kernel: {at_kernel}; pools whole (target "
        f"{engine.pool.num_free}/{engine.pool.num_blocks} free, draft "
        f"{engine.spec.live_pages()} pages live): {whole}")
    log(f"  spec: {s['spec_drafted_tokens']} drafted, "
        f"{s['spec_accepted_tokens']} accepted (rate "
        f"{s['spec_accept_rate']:.4f}), {s['spec_bonus_tokens']} bonus, "
        f"{s['spec_accepted_per_step']:.4f} committed a verify step "
        f"({per_lane:.4f} a lane over {lane_steps} lane-steps, "
        f"{s['stalls']} stalls), {s['spec_draft_preempts']} draft "
        f"preemptions  [{smi}]")
    log(f"  decode {s['decode_tok_s']:.1f} tok/s with spec against phase "
        f"4's {report['main_path']['decode_tok_s']:.1f} tok/s (the same "
        f"trace and weights); ttft p50 {s['ttft_p50_s']:.4f} s  [{smi}]")
    if not ok:
        log(f"  SPEC PATH FAIL: completed {len(done)}, whole {whole}, "
            f"launches {launch_ok}, plans {at_kernel}, summary "
            f"{ {k: v for k, v in s.items() if k.startswith('spec')} }")

    # reported, not gated: how many requests emit phase 4's tokens (the
    # kernels round bf16 differently at the verify shape), and for each
    # that does not, its first differing position and phase 4's top-2
    # gap there (the kernels' prefill over phase 4's context)
    want = report["main_path"]["tokens"]
    same, diffs = 0, {}
    for rid, got in outputs.items():
        p, gap, top = first_difference(
            torch, engine.model, engine.params, engine.requests[rid].prompt,
            want[rid], got.tolist(), 16)
        if p is None:
            same += 1
        else:
            diffs[rid] = {"position": p, "top2_gap": gap, "max_logit": top}
            log(f"    {rid}: first differs from phase 4 at token {p}, "
                f"phase 4's top-2 gap there {gap:.4e} (largest logit "
                f"{top:.3f})")
    res.update(equal_to_phase4=same, differing=diffs)
    log(f"  {same}/16 requests emit phase 4's tokens")

    # one verify step (S = 8, C = 5, ragged chunks, kv offsets off the
    # page boundaries up to 545) on a random arena: the kernels against
    # the plain versions, and its row 0 against the decode step of the
    # same pending token over a copy of the same arena; the decode step's
    # kernels against its plain versions give the bf16 noise of this
    # arena beside them
    model, params = engine.model, engine.params
    bs, S, C = 16, 8, SPEC_K + 1
    lengths = [s0 + c for s0, c in zip(VERIFY_STARTS, VERIFY_CHUNKS)]
    nxt, rows = 0, []
    for n in lengths:
        k = -(-n // bs)
        rows.append(list(range(nxt, nxt + k)))
        nxt += k
    W = max(len(r) for r in rows)
    rows = [r + [r[-1]] * (W - len(r)) for r in rows]
    i32 = dict(dtype=torch.int32, device="cuda")
    tables = torch.tensor(rows, **i32)
    kv = torch.tensor(VERIFY_STARTS, **i32)
    clens = torch.tensor(VERIFY_CHUNKS, **i32)
    rng = np.random.default_rng(10)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (S, C)),
                           device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    arena0 = model.init_paged_arena(nxt + 1, bs)
    for leaf in arena0.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    out = {}
    for mode, step in (("torch", "verify"), ("kernel", "verify"),
                       ("torch", "decode"), ("kernel", "decode")):
        arena = {n: a.clone() for n, a in arena0.items()}
        with torch.no_grad(), dispatch.use(execute=mode):
            if step == "verify":
                out[mode, step], _ = model.paged_verify_step(
                    params, toks, arena, tables, kv, clens)
            else:
                out[mode, step], _ = model.paged_decode_step(
                    params, toks[:, :1], arena, tables, kv,
                    torch.ones(S, **i32))
    torch.cuda.synchronize()
    valid = (torch.arange(C, device="cuda")[None] < clens[:, None])
    good = True
    for a, b, what, tag in (
            (out["kernel", "verify"][valid], out["torch", "verify"][valid],
             "kernels vs plain", "verify"),
            (out["kernel", "verify"][:, 0], out["kernel", "decode"],
             "row 0 vs the decode step, kernels", "verify_row0_vs_decode"),
            (out["kernel", "decode"], out["torch", "decode"],
             "(the decode step, kernels vs plain)", "decode")):
        err = (a - b).abs().max().item()
        tol = 0.05 * b.abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        g = err <= tol and math.isfinite(err)
        good &= g
        res.update({f"{tag}_logits_max_abs_err": err,
                    f"{tag}_logits_tol": tol,
                    f"{tag}_greedy_agreement": agree})
        log(f"  {'verify step logits, ' if tag != 'decode' else ''}"
            f"{what}: max_abs_err {err:.4e} (tol "
            f"{tol:.4e}) {'ok' if g else 'FAIL'}; greedy agreement "
            f"{agree:.3f}")

    # the verify step's GEMM shapes (M = 8 x 5 = 40), against their plain
    # versions and timed beside torch.matmul and their bounds
    keys40 = {k: n for k, n in gemm_keys.items() if k[0] == S * C}
    g_ok, res_gemm = check_gemm_keys(torch, timer, keys40, dispatcher,
                                     cfg.vocab_size)
    report["spec_gemm"] = res_gemm
    return ok and good and g_ok, counts, gemm_keys


def spec_breakdown(report, gemm_keys):
    """Kernel time of one spec step, estimated from the phase 3 times at
    its shapes (L2 cold): the verify (16 prefill launches at the verify
    shape and its 113 GEMMs at M = 40), SPEC_K draft rounds (16 decode
    launches at S = 8 and 113 GEMMs at M = 8 each) and the draft
    catch-up chunks averaged over the steps (the phase 4 prefill shape),
    beside the wall of a spec step (draft and verify, host included)."""
    sp, smi = report["spec_path"], nvidia_smi_line()
    timed = {r["key"]: r["ms"] for r in report["gemm"] if r.get("recommended")}
    timed.update({r["key"]: r["ms"] for r in report["spec_gemm"]})
    attn = {r["kernel"]: r["ms"] for r in report["paged"] if "ms" in r}
    verify_attn = next(r["case_ms"] for r in report["paged"]
                       if r.get("case") == "spec verify")
    missing = [k for k in gemm_keys if k not in timed]
    steps = sp["spec_steps"]

    def gemm_ms(m, calls):
        return sum(timed.get(k, 0.0) * n for k, n in gemm_keys.items()
                   if k[0] == m) / max(calls, 1)
    verify = 16 * verify_attn + gemm_ms(40, sp["verify_calls"])
    draft = SPEC_K * (16 * attn["paged_decode"]
                      + gemm_ms(8, sp["draft_rounds"]))
    catchup = sp["draft_catchup_calls"] * (
        16 * attn["paged_prefill"] + sum(
            timed.get(k, 0.0) * n for k, n in gemm_keys.items()
            if k[0] == 512) / max(sp["draft_catchup_calls"]
                                  + sp["target_prefill_calls"], 1)) / steps
    wall = sp["decode_wall_s"] * 1e3 / steps
    est = verify + draft + catchup
    sp["time_breakdown"] = {
        "wall_ms_per_spec_step": wall, "verify_kernel_ms_est": verify,
        "draft_rounds_kernel_ms_est": draft,
        "catchup_kernel_ms_per_step_est": catchup,
        "kernel_ms_per_spec_step_est": est, "kernel_share_est": est / wall,
        "untimed_gemm_keys": [list(k) for k in missing]}
    log(f"  spec step: {wall:.2f} ms (wall: draft + verify), kernels "
        f"{est:.2f} ms of it (estimate, {100 * est / wall:.0f}%): verify "
        f"{verify:.3f} (16 x {verify_attn:.4f} ms prefill at C=5 + GEMMs at "
        f"M=40), {SPEC_K} draft rounds {draft:.3f} (16 x "
        f"{attn['paged_decode']:.4f} ms decode at S=8 + GEMMs at M=8 each),"
        f" catch-up {catchup:.3f} a step  [{smi}]"
        + (f"; untimed GEMM shapes {missing}" if missing else ""))


SPEC_B_RUNS = (("self", dict(spec_draft="self")),
               ("gemma-2b", dict(spec_draft="gemma-2b")),
               ("self, 4 draft pages", dict(spec_draft="self",
                                            spec_draft_blocks=4)))


def spec_reduced(torch, report):
    """10b: the reference's test pair on the card in f32: reduced
    llama3.2-1b on ``tests/test_spec_decode.py``'s ``_requests(3)``
    trace, plain, then with ``spec_k=3`` drafting by ``self``, by reduced
    ``gemma-2b``, and by ``self`` from a 4-page draft pool."""
    import numpy as np
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    smi = nvidia_smi_line()
    cfg = get_arch("llama3.2-1b").reduced()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, 12).astype(np.int32) for _ in range(3)]
    common = dict(num_slots=2, max_len=40, block_size=8, kv_layout="paged",
                  prefill_chunk=8, temperature=0.0, seed=0, clock="steps",
                  execute="auto")

    def serve(**kw):
        engine = ServingEngine(cfg, EngineConfig(**common, **kw),
                               device="cuda")
        ops.reset_counts()
        out = engine.run([Request(f"r{i}", p.copy(), 8)
                          for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        engine.pool.check()
        whole = engine.pool.num_free == engine.pool.num_blocks
        if engine.spec is not None:
            engine.spec.check()
            whole &= engine.spec.live_pages() == 0
        ran = (counts["plain_calls"] == 0 and counts["rsa_gemm"] > 0
               and counts["paged_prefill"] > 0
               and counts["paged_decode"] > 0)
        return out, engine, counts, whole and ran

    base, plain_eng, counts, ok = serve()
    res = report["spec_reduced"] = {"plain": {"counts": counts, "ok": ok}}
    log(f"  plain: {counts['paged_prefill']} prefill / "
        f"{counts['paged_decode']} decode launches, plain_calls "
        f"{counts['plain_calls']}, pool whole {ok}")
    for name, kw in SPEC_B_RUNS:
        out, engine, counts, good = serve(spec_k=3, **kw)
        s = engine.summary()
        near = []
        for rid, got in out.items():
            p, gap, top = first_difference(
                torch, plain_eng.model, plain_eng.params,
                engine.requests[rid].prompt, base[rid].tolist(),
                got.tolist(), 8)
            if p is None:
                continue
            tie = gap <= 1e-4 * top
            good &= tie
            near.append({"rid": rid, "position": p, "top2_gap": gap,
                         "tol": 1e-4 * top, "near_tie": tie})
            log(f"    {rid}: differs from plain at token {p}, plain top-2 "
                f"gap {gap:.3e} (tol {1e-4 * top:.3e}): "
                f"{'near-tie' if tie else 'FAIL'}")
        if kw["spec_draft"] == "gemma-2b":
            good &= s["spec_drafted_tokens"] > s["spec_accepted_tokens"]
        if "spec_draft_blocks" in kw:
            good &= s["spec_draft_preempts"] > 0
        good &= s["spec_steps"] > 0
        res[name] = {"counts": counts, "near_ties": near, "ok": good, **{
            k: s[k] for k in s if k.startswith("spec_")}}
        ok &= good
        log(f"  {name}: tokens equal plain at {3 - len(near)}/3 requests "
            f"(+{len(near)} near-ties), {s['spec_steps']} verify steps, "
            f"{s['spec_drafted_tokens']} drafted / "
            f"{s['spec_accepted_tokens']} accepted, "
            f"{s['spec_accepted_per_step']:.3f} committed a step, "
            f"{s['spec_draft_preempts']} draft preemptions, launches "
            f"{counts['paged_prefill']} prefill / {counts['paged_decode']} "
            f"decode, plain_calls {counts['plain_calls']}, pools whole "
            f"{engine.pool.num_free == engine.pool.num_blocks and engine.spec.live_pages() == 0}"
            f" {'ok' if good else 'FAIL'}  [{smi}]")
    return ok


# ---------------------------------------------------------------------------
# phase 11: the paper's SAGAR model (launch/sagar.py)
# ---------------------------------------------------------------------------

def sagar_instance(r, paper: bool):
    """One Fig. 8 line of ``launch.sagar.adaptnet_on``'s result."""
    geo = r["geomean_rel_edp"]
    log(f"  2^{r['p']} MACs ({r['num_classes']} classes): "
        f"{len(r['train'].labels) + len(r['test'].labels)} workloads "
        f"labelled on the host in {r['generate_s']:.1f} s "
        f"({r['distinct_labels']} distinct labels); trained on the card in "
        f"{r['train_s']:.1f} s; test accuracy {r['accuracy']:.4f}"
        + (" (paper: 95%)" if paper else "")
        + f", geomean relative EDP {geo:.5f} = {100 / geo:.2f}% of the "
        f"oracle (model" + ("; paper: 99.93%)" if paper else ")")
        + f", median {r['median_rel_edp']:.5f}")
    return {"p": r["p"], "classes": r["num_classes"],
            "samples": len(r["train"].labels) + len(r["test"].labels),
            "generate_s": r["generate_s"], "train_s": r["train_s"],
            "distinct_labels": r["distinct_labels"],
            "test_accuracy": r["accuracy"], "geomean_rel_edp_model": geo,
            "median_rel_edp_model": r["median_rel_edp"]}


def sagar_path(torch, report, timer):
    """Phase 11: ``launch/sagar.py``'s parts as a user runs them, on the
    card: the 2^14 net at Fig. 8's size (gated on the reference's test
    gates), 2^12 and 2^13 at 60 000 samples, Fig. 7e on a 60 000-sample
    set (seed 11), one batched ADAPTNETX launch per Table-IV workload
    with the 2^14 net, and ``SaraDispatcher.gemm`` at quickstart's two
    f32 shapes and the main path's bf16 decode shape.  The counts are 0
    from the first part on and read after the last launch of the path;
    the comparisons with the plain versions and the timings follow.
    Returns ok; the counts stay in ``report["sagar"]``."""
    import numpy as np
    from repro_torch import dispatch
    from repro_torch.core.hw import DATAFLOW_NAMES
    from repro_torch.core.sara import SaraDispatcher
    from repro_torch.kernels import ops
    from repro_torch.kernels.adaptnetx import (OPERANDS, _adaptnetx_plan,
                                               adaptnetx_plain)
    from repro_torch.kernels.rsa_gemm import rsa_gemm_plain
    from repro_torch.launch import sagar as S

    dev = torch.device("cuda", torch.cuda.current_device())
    res = report["sagar"] = {}
    ok = True
    ops.reset_counts()
    f3 = res["fig3_model"] = S.fig3(log=False)
    log(f"  Fig. 3 (model cycles): monolithic 128x128 "
        f"{f3['monolithic_cycles']:.0f}, distributed 16 x 32x32 "
        f"{f3['distributed_cycles']:.0f} "
        f"({f3['distributed_reads'] / f3['monolithic_reads']:.1f}x the "
        f"reads), RSA best {f3['rsa_best_cycles']:.0f}")
    big = S.adaptnet_on(14, SG_SAMPLES, SG_EPOCHS, 42, dev)
    r = sagar_instance(big, True)
    good = r["test_accuracy"] >= 0.80 and r["geomean_rel_edp_model"] <= 1.02
    ok &= good
    log(f"    gates: accuracy >= 0.80 and geomean relative EDP <= 1.02 "
        f"(the reference's tests/test_adaptnet.py) {'ok' if good else 'FAIL'}"
        f"  [{SG_EPOCHS} epochs]")
    res["instances"] = [r]
    for p in (12, 13):
        res["instances"].append(sagar_instance(
            S.adaptnet_on(p, SG_SMALL_SAMPLES, SG_SMALL_EPOCHS, 42, dev),
            False))
    small = S.adaptnet_on(14, SG_SMALL_SAMPLES, SG_SMALL_EPOCHS, 11, dev)
    rows = S.fig7e(small["train"], small["test"], small, dev)
    res["fig7e"] = [{"name": x["name"], "accuracy": x["accuracy"],
                     "train_s": x["train_s"]} for x in rows]
    for x in rows:
        log(f"  {x['name']} {x['accuracy']:.4f}, trained in "
            f"{x['train_s']:.1f} s")
    acc = {x["name"]: x["accuracy"] for x in rows}
    margin = acc["fig7e.ADAPTNET.accuracy"] - acc["fig7e.LogReg.accuracy"]
    good = margin > 0.05
    ok &= good
    log(f"    ADAPTNET above LogReg by {margin:.4f} (> 0.05, the "
        f"reference's gate) {'ok' if good else 'FAIL'}")

    # the path's launches: one ADAPTNETX query a workload, then each GEMM
    p = big["result"].params
    wl = S.adaptnetx_workloads(p, big["inst"], dev)
    d = SaraDispatcher()
    gemms = []
    for M, K, N, dt in SG_GEMMS:
        dt = getattr(torch, dt)
        reg = dispatch.SiteRegistry()
        before = ops.launch_counts()
        with dispatch.use(registry=reg):
            g = S.sara_gemms(dev, [(M, K, N)], dt, dispatcher=d)[0]
        after = ops.launch_counts()
        g.update(dtype=dt, rec=reg.sites("_")["sara.gemm"],
                 launched={k: after[k] - before[k] for k in after})
        gemms.append(g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    good = (counts["adaptnetx"] == len(wl) and
            counts["rsa_gemm"] == len(gemms) and counts["plain_calls"] == 0)
    ok &= good
    log(f"  launches on the path: adaptnetx {counts['adaptnetx']} (expected "
        f"{len(wl)}), rsa_gemm {counts['rsa_gemm']} (expected {len(gemms)}),"
        f" plain_calls {counts['plain_calls']} {'ok' if good else 'FAIL'}")

    wrecs = []
    for w in wl:
        t = [p[k] for k in OPERANDS]
        want = adaptnetx_plain(w["ids"].to(torch.int32), *t)
        torch.cuda.synchronize()
        err = (w["logits"] - want).abs().max().item()
        same = int(np.sum(w["picks"] == w["host_picks"]))
        good = adaptnetx_close(w["logits"], want) and same == w["B"]
        ok &= good
        b_ms, b_by = adaptnetx_bound(p, w["B"])
        plan = _adaptnetx_plan(w["B"], p["emb_m"].shape[1], *p["w2"].shape)
        rec = {"workload": w["name"], "B": w["B"], "max_abs_err": err,
               "picks_equal_host_twin": f"{same} of {w['B']}",
               "oracle_share": w["oracle_share"],
               "geomean_rel_edp_model": w["geomean_rel_edp"],
               "ms": timer(lambda: ops.adaptnetx_recommend(w["ids"], p)),
               "plain_ms": timer(lambda: adaptnetx_plain(
                   w["ids"].to(torch.int32), *t)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "plan": adaptnetx_plan_str(plan), "ok": good}
        wrecs.append(rec)
        log(f"  adaptnetx {w['name']:<12} B={w['B']:>3}: max_abs_err "
            f"{err:.2e} (tol 1e-5 + 1e-5 |plain|), picks equal the host twin"
            f" at {same} of {w['B']}, oracle's pick at "
            f"{100 * w['oracle_share']:.1f}%, geomean relative EDP "
            f"{w['geomean_rel_edp']:.5f} (model) {'ok' if good else 'FAIL'}"
            f"\n    kernel {rec['ms']:.4f} ms a batched query (floor "
            f"{report['adaptnetx_floor_ms']:.4f}) plain {rec['plain_ms']:.4f}"
            f" ms bound {b_ms:.6f} ms ({b_by}); plan: {rec['plan']}")
    res["adaptnetx"] = wrecs

    grecs = []
    for g in gemms:
        x, w, rec = g["x"], g["w"], g["rec"]
        M, K, N = g["M"], g["K"], g["N"]
        f32 = g["dtype"] == torch.float32
        plain = rsa_gemm_plain(x, w, block_k=rec.block_k, mode=rec.mode)
        torch.cuda.synchronize()
        err = (g["out"].float() - plain.float()).abs().max().item()
        tol = gemm_tolerance(torch, x, w, plain, rec.mode, rec.block_k, f32)
        good = (err <= tol and math.isfinite(err)
                and g["launched"]["rsa_gemm"] == 1
                and g["launched"]["plain_calls"] == 0
                and rec.cfg == d.recommend(M, K, N) and rec.backend == "kernel")
        ok &= good
        nbytes = (M * K + K * N + M * N) * x.element_size()
        b_ms, b_by = bound_ms(nbytes, 2.0 * M * N * K,
                              PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
        grec = {"M": M, "K": K, "N": N, "dtype": str(g["dtype"]).split(".")[-1],
                "mode": DATAFLOW_NAMES[rec.mode], "bk": rec.block_k,
                "recommendation": rec.describe(), "launched": g["launched"],
                "max_abs_err": err, "tol": tol,
                "ms": timer(lambda: d.gemm(x, w)),
                "plain_ms": timer(lambda: rsa_gemm_plain(
                    x, w, block_k=rec.block_k, mode=rec.mode)),
                "library_ms": timer(lambda: torch.matmul(x, w)),
                "bound_ms": b_ms, "bound_by": b_by, "ok": good}
        grecs.append(grec)
        log(f"  SaraDispatcher.gemm {M}x{K}x{N} {grec['dtype']}: "
            f"{rec.describe()}; {g['launched']['rsa_gemm']} RSA launch, "
            f"{g['launched']['plain_calls']} plain calls; max_abs_err "
            f"{err:.3e} (tol {tol:.3e}) {'ok' if good else 'FAIL'}  kernel "
            f"{grec['ms']:.4f} ms plain {grec['plain_ms']:.4f} ms matmul "
            f"{grec['library_ms']:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    res["gemms"] = grecs
    res["counts"] = counts
    return ok


# ---------------------------------------------------------------------------
# phase 12: observability and fault tolerance on the main path
# ---------------------------------------------------------------------------

# phase 4's serve_continuous call, which every part of phase 12 repeats
MAIN_SERVE = dict(arch="llama3.2-1b", preset="full", num_requests=16,
                  num_slots=8, prompt_len=512, min_prompt_len=64, gen=32,
                  temperature=0.0, top_k=0, seed=0, execute="auto",
                  prefill_chunk=64, block_size=16, clock="wall",
                  device="cuda", log=False)
CHAOS_SMOKE = dict(seed=0, pool_oom_p=0.15, poison_p=0.15, stall_p=0.1,
                   preempt_p=0.1)   # the reference's --smoke --chaos odds
CHAOS_LIGHT = dict(CHAOS_SMOKE, pool_oom_p=0.02, poison_p=0.02)
SNAPSHOT_EVERY, KILL_AT = 8, 20


def phase_breakdown(engine):
    """Each step phase's mean host ms over the steps that ran only decode,
    only a prefill chunk, or both (from the timeline's slices; the phases
    around model calls time the launches' issue, ``sync`` the wait)."""
    from repro_torch.obs.trace import STEP_PHASES
    steps = {}
    for e in engine.obs.events("step"):
        if e.ph == "X":
            st = steps.setdefault(e.args["step"], {})
            st[e.name] = st.get(e.name, 0.0) + e.dur
    out = {}
    for kind in ("decode", "prefill", "mixed"):
        sts = [st for st in steps.values()
               if ("paged_decode" in st, "prefill_chunk" in st) ==
               {"decode": (True, False), "prefill": (False, True),
                "mixed": (True, True)}[kind]]
        if sts:
            names = [n for n in STEP_PHASES + ("engine_step",)
                     if any(n in st for st in sts)]
            out[kind] = {"steps": len(sts), **{
                n: 1e3 * sum(st.get(n, 0.0) for st in sts) / len(sts)
                for n in names}}
    return out


def request_events(engine, name):
    from collections import Counter
    return Counter(e.args["rid"] for e in engine.obs.events("request")
                   if e.name == name)


def obs_path(torch, report):
    """12a: phase 4's serve with a trace and the sanitizer; 12b: with the
    reference's chaos smoke odds; 12c: killed after step 20 and resumed
    from its last snapshot by a fresh engine."""
    import dataclasses
    import gc

    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.obs import REQUIRED_CATEGORIES, validate_trace
    from repro_torch.serving import ChaosConfig, ServingEngine
    want = report["main_path"]["tokens"]
    rids = set(want)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    rep = report["phase12"] = {}
    smi = nvidia_smi_line()
    ok = True

    # -- 12a: trace + sanitize -------------------------------------------
    trace = build / "chip_smoke_trace.json"
    ops.reset_counts()
    t0 = time.time()
    out, eng = serve_continuous(**MAIN_SERVE, trace_out=str(trace),
                                sanitize=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    s = eng.summary()
    doc = json.loads(trace.read_text())
    problems = validate_trace(doc, REQUIRED_CATEGORIES)
    submits, roots = request_events(eng, "submit"), request_events(
        eng, "request")
    one_each = (set(submits) == set(roots) == rids
                and all(submits[r] == roots[r] == 1 for r in rids))
    ndisp = len(eng.obs.events("dispatch"))
    same = sum(np.array_equal(out[r], np.asarray(want[r])) for r in rids)
    done = sum(r.outcome == "done" for r in eng.requests.values())
    leak_free = (s["kv_leaked_tables"] == 0 and s["kv_leaked_refs"] == 0
                 and eng.pool.num_free == eng.pool.num_blocks)
    nbytes = trace.stat().st_size + trace.with_suffix(".jsonl").stat().st_size
    good = (done == 16 and same == 16 and s["kv_poison_hits"] == 0
            and s["kv_generation_faults"] == 0 and leak_free
            and problems == [] and doc["otherData"]["dropped_events"] == 0
            and one_each and ndisp == eng.obs.counters["dispatch_records"]
            and counts["plain_calls"] == 0 and counts["paged_decode"] > 0
            and counts["paged_prefill"] > 0)
    ok &= good
    breakdown = phase_breakdown(eng)
    rep["a"] = {"wall_s": wall, "completed": done, "same_tokens": same,
                "counters": dict(eng.obs.counters),
                "gauges": dict(eng.obs.gauges), "events": len(eng.obs),
                "dropped": eng.obs.dropped, "export_bytes": nbytes,
                "trace_problems": problems, "dispatch_events": ndisp,
                "one_submit_one_finish": one_each, "counts": counts,
                "engine_steps": eng.steps, "breakdown_ms": breakdown,
                "kv_poison_fills": s["kv_poison_fills"],
                "kv_sanitize_checks": s["kv_sanitize_checks"], "ok": good}
    shutil.copy(trace, out_dir / trace.name)
    log(f"  12a trace + sanitize: {done}/16 requests in {wall:.2f} s "
        f"({eng.steps} engine steps), {same}/16 emit phase 4's tokens, "
        f"poison hits {s['kv_poison_hits']}, generation faults "
        f"{s['kv_generation_faults']}, {s['kv_poison_fills']} pages "
        f"poisoned on free, {s['kv_sanitize_checks']} sanitizer checks, "
        f"leak-free {leak_free}, plain_calls {counts['plain_calls']}")
    log(f"      trace: {len(eng.obs)} events ({eng.obs.dropped} dropped), "
        f"export {nbytes} bytes (chiprun_out/{trace.name} opens in "
        f"ui.perfetto.dev), validate_trace problems {len(problems)}, one "
        f"submit and one finish a request {one_each}, dispatch events "
        f"{ndisp} = dispatch_records "
        f"{eng.obs.counters['dispatch_records']} "
        f"{'ok' if good else 'FAIL'}")
    log(f"      counters {json.dumps(eng.obs.counters)}")
    for kind, b in breakdown.items():
        log(f"      {kind} steps ({b['steps']}), mean host ms a step: " +
            ", ".join(f"{n} {v:.3f}" for n, v in b.items() if n != "steps")
            + f"  [{smi}]")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # -- 12b: chaos, at the reference's smoke odds, and at the smoke's
    # stall and preemption odds with OOM and poison at 0.02 (at the smoke
    # odds every request of this trace fails: the second run has
    # survivors to hold to phase 4's tokens) ------------------------------
    for name, key, odds in (("12b", "b", CHAOS_SMOKE),
                            ("12b'", "b_light", CHAOS_LIGHT)):
        ops.reset_counts()
        t0 = time.time()
        out, eng = serve_continuous(
            **MAIN_SERVE, sanitize=True, chaos=ChaosConfig(**odds),
            trace_out=str(build / "chip_smoke_chaos.json"))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = ops.launch_counts()
        s = eng.summary()
        faults = eng.obs.events("fault")
        kind_rids = {}
        for e in faults:
            if e.name == "fault":
                kind_rids.setdefault(e.args["kind"], []).append(
                    e.args["rid"])
        contained = {e.args["rid"] for e in faults
                     if e.name == "contained"}
        poisoned = set(kind_rids.get("poison", []))
        preempted = set(kind_rids.get("preempt", []))
        outcomes = {r.rid: r.outcome for r in eng.requests.values()}
        terminal = (all(outcomes.values()) and set(outcomes) == rids
                    and eng.req_spans.closed == 16
                    and eng.req_spans.open_requests() == {})
        poison_own = (poisoned <= contained
                      and all(outcomes[r] == "failed" for r in poisoned)
                      and s["kv_poison_hits"] == s["chaos_poison_injected"])
        leak_free = (s["kv_leaked_tables"] == 0
                     and s["kv_leaked_refs"] == 0
                     and eng.pool.num_free == eng.pool.num_blocks)
        survivors = sorted(r for r, o in outcomes.items() if o == "done")
        plain_same = [r for r in survivors if r not in preempted
                      and np.array_equal(out[r], np.asarray(want[r]))]
        plain_survivors = [r for r in survivors if r not in preempted]
        good = (terminal and s["faults_injected"] >= 1
                and s["faults_contained"] >= 1 and poison_own
                and leak_free and len(plain_same) == len(plain_survivors)
                and counts["plain_calls"] == 0)
        ok &= good
        diffs = {}
        for r in survivors:
            if not np.array_equal(out[r], np.asarray(want[r])):
                p, gap, top = first_difference(
                    torch, eng.model, eng.params, eng.requests[r].prompt,
                    want[r], out[r].tolist(), 16)
                diffs[r] = {"position": p, "top2_gap": gap,
                            "max_logit": top,
                            "force_preempted": r in preempted}
        rep[key] = {"odds": odds, "wall_s": wall, "outcomes": outcomes,
                    "injected": {k: len(v) for k, v in kind_rids.items()},
                    "summary": {k: v for k, v in s.items()
                                if k.startswith(("chaos_", "faults_",
                                                 "requests_", "kv_poison",
                                                 "engine_step", "preempt"))},
                    "contained": sorted(contained),
                    "poisoned": sorted(poisoned),
                    "force_preempted": sorted(preempted),
                    "survivors": survivors,
                    "plain_survivors_same": len(plain_same),
                    "plain_survivors": len(plain_survivors),
                    "differences": diffs, "counts": counts, "ok": good}
        log(f"  {name} chaos {odds}: outcomes "
            f"{sorted(outcomes.values())} in {wall:.2f} s, every request "
            f"terminal once {terminal}; injected {rep[key]['injected']} "
            f"({s['faults_injected']}), contained {s['faults_contained']}, "
            f"step retries {s['engine_step_retries']}, poison hits "
            f"{s['kv_poison_hits']} each on its own lane {poison_own}, "
            f"leak-free {leak_free}, plain_calls {counts['plain_calls']}")
        log(f"      {len(plain_same)}/{len(plain_survivors)} survivors "
            f"never force-preempted emit phase 4's tokens; force-preempted "
            f"survivors {sorted(preempted & set(survivors))} "
            f"{'ok' if good else 'FAIL'}")
        for r, d in diffs.items():
            tag = " (force-preempted)" if d["force_preempted"] else ""
            log(f"      {r}{tag}: first differs from phase 4 at token "
                f"{d['position']}, phase 4's top-2 gap there "
                f"{d['top2_gap']:.4e} (largest logit {d['max_logit']:.2f})")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # -- 12c: kill and resume ----------------------------------------------
    snap = build / "chip_smoke_snapshot"
    shutil.rmtree(snap, ignore_errors=True)
    ops.reset_counts()
    t0 = time.time()
    first, victim = serve_continuous(
        **MAIN_SERVE, snapshot_dir=str(snap), snapshot_every=SNAPSHOT_EVERY,
        stop_after=KILL_AT)
    torch.cuda.synchronize()
    victim_s = time.time() - t0
    nsnap = victim.summary()["engine_snapshots"]
    last = KILL_AT // SNAPSHOT_EVERY * SNAPSHOT_EVERY
    snap_bytes = sum(f.stat().st_size
                     for f in (snap / f"step_{last:08d}").iterdir())
    done_before = {r.rid for r in victim.requests.values()
                   if r.outcome == "done"}
    # the seconds of one save, into a directory of its own
    t0 = time.time()
    victim.snapshot(str(build / "chip_smoke_snapshot_timed"))
    save_s = time.time() - t0
    shutil.rmtree(build / "chip_smoke_snapshot_timed", ignore_errors=True)
    # the fresh engine takes the victim's configs (it only restores: no
    # snapshots of its own) and draws the weights from the seed again
    cfg, ecfg = victim.cfg, dataclasses.replace(victim.ecfg,
                                                snapshot_every=0)
    del victim
    gc.collect()
    torch.cuda.empty_cache()
    fresh = ServingEngine(cfg, ecfg, device="cuda")
    t0 = time.time()
    step = fresh.restore()
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    restored = set(fresh.requests)
    while fresh.step():
        pass
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    got = {r: np.asarray(first[r]) for r in rids}
    got.update({r.rid: np.asarray(r.generated, np.int32)
                for r in fresh.requests.values()})
    same = sum(np.array_equal(got[r], np.asarray(want[r])) for r in rids)
    covered = rids <= restored | done_before
    fresh.pool.check()
    good = (step == last and nsnap == KILL_AT // SNAPSHOT_EVERY
            and covered and same == 16
            and all(r.outcome == "done" for r in fresh.requests.values())
            and fresh.pool.num_free == fresh.pool.num_blocks
            and counts["plain_calls"] == 0)
    ok &= good
    rep["c"] = {"killed_at": KILL_AT, "snapshots": nsnap, "restored_step":
                step, "restored_requests": len(restored),
                "done_before_snapshot": len(done_before & (rids -
                                                           restored)),
                "snapshot_bytes": snap_bytes, "save_s": save_s,
                "restore_s": restore_s, "victim_s": victim_s,
                "same_tokens": same, "counts": counts, "ok": good}
    log(f"  12c kill and resume: killed after step {KILL_AT} ({nsnap} "
        f"snapshots, every {SNAPSHOT_EVERY}), a fresh engine restored step "
        f"{step} ({len(restored)} live requests) and finished: {same}/16 "
        f"emit phase 4's tokens; snapshot {snap_bytes} bytes, save "
        f"{save_s:.3f} s, restore {restore_s:.3f} s, plain_calls "
        f"{counts['plain_calls']} {'ok' if good else 'FAIL'}  [{smi}]")
    shutil.rmtree(snap, ignore_errors=True)
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase 13: every attention family on every KV layout
# ---------------------------------------------------------------------------

def p13_cfg(arch, layers=None, optimized=False):
    """A registry arch at its published widths (bf16), optionally cut in
    depth."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch, optimized=optimized)
    return cfg.replace(num_layers=layers) if layers else cfg


def p13_requests(cfg, n, lo, hi, gen, seed):
    """n requests of lo-hi random tokens from ``seed``; a vlm request
    carries seeded patch embeddings, an encdec request seeded source
    features of ``P13_SRC`` frames."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    out = []
    for i in range(n):
        p = rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
        extras = None
        if cfg.family == "vlm":
            extras = {"patch_embeds": rng.standard_normal(
                (1, fe.num_tokens, fe.feature_dim)).astype(np.float32)}
        elif cfg.family == "encdec":
            extras = {"src_features": rng.standard_normal(
                (1, P13_SRC, fe.feature_dim)).astype(np.float32)}
        out.append(Request(rid=f"req-{i}", prompt=p.astype(np.int32),
                           max_new_tokens=gen, extras=extras))
    return out


def p13_serve(torch, key, cfg, reqs, cut=None, **ecfg):
    """Serve ``reqs`` on the card and hold the path to phase 13's gates:
    every request done, the pool leak-free, 0 plain calls, every plan line
    on the RSA kernel but the f32 router, each expert bank one launch a
    layer and model call, the paged decode / prefill kernels once a layer
    and model call where the layout runs them (none on the dense layout
    or in a bucketed prefill), the flash forward once an encoder layer, a
    decoder layer's cross-attention and, in a bucketed prefill, a decoder
    layer's self-attention a prefill under the optimized profile.  Returns (ok, record, engine, launches by GEMM key)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.models.moe import padded_num_experts
    from repro_torch.serving import EngineConfig, ServingEngine
    ecfg = dict(dict(num_slots=P13_SLOTS, block_size=16, temperature=0.0,
                     seed=0, clock="wall", execute="auto"), **ecfg)
    ecfg.setdefault("max_len", max(r.prompt_len for r in reqs)
                    + reqs[0].max_new_tokens + 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine = ServingEngine(cfg, EngineConfig(**ecfg), device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in _leaves(engine.params)) / 1e9
    ops.reset_counts()
    t0 = time.time()
    outputs = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    keys = dict(rsa_gemm_cuda.launches_by_key)
    L, V = cfg.num_layers, cfg.vocab_size
    engine.pool.check()
    done = [r for r in engine.requests.values() if r.outcome == "done"]
    leak_free = engine.pool.num_free == engine.pool.num_blocks
    D = engine.metrics.decode_steps
    calls = sum(n for k, n in keys.items() if len(k) == 4 and k[2] == V)
    P = calls - D
    paged = engine.kv_layout == "paged"
    flash = 0
    if cfg.attn_impl == "pallas" and cfg.family not in ("ssm", "hybrid"):
        if cfg.family == "encdec":         # the encoder, the cross-attention
            flash += cfg.encoder_layers + L
        if not engine.prefill_chunk and cfg.attention_type == "gqa":
            flash += L                     # a whole prompt's self-attention
    want = {"paged_decode": L * D if paged else 0,
            "paged_prefill": (L * P if paged and engine.prefill_chunk
                              else 0),
            "flash_fwd": flash * P}
    banks = {k: n for k, n in keys.items() if len(k) == 5}
    expert = None
    if cfg.moe is not None:
        E = padded_num_experts(cfg)
        expert = sum(n for k, n in banks.items() if k[0] == E)
        want["expert banks"] = 3 * (L - cfg.first_dense_layers) * calls
    got = {k: counts[k] for k in ("paged_decode", "paged_prefill",
                                  "flash_fwd")}
    if expert is not None:
        got["expert banks"] = expert
    plan_ok = all(("@kernel" in desc) == (site != "moe.router")
                  for site, desc in engine.gemm_plan.items())
    ok = (len(done) == len(reqs) and leak_free and got == want
          and counts["plain_calls"] == 0 and counts["rsa_gemm"] > 0
          and D > 0 and P > 0 and plan_ok
          and all(len(v) == r.max_new_tokens
                  for r, v in zip(reqs, outputs.values())))
    s = engine.summary()
    rec = {"arch": cfg.name, "num_layers": L, "cut": cut, "vocab": V,
           "kv_layout": engine.kv_layout,
           "prefill_chunk": engine.prefill_chunk,
           "attn_impl": cfg.attn_impl, "weights_gb": weights_gb,
           "init_s": init_s, "requests": len(reqs), "completed": len(done),
           "wall_s": wall, "prefill_calls": P, "decode_steps": D,
           "counts": counts, "want": want, "got": got, "plan_ok": plan_ok,
           "pool_leak_free": leak_free, "decode_tok_s": s["decode_tok_s"],
           "ttft_p50_s": s["ttft_p50_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "gemm_launches_by_shape": {
               "x".join(str(v) for v in k[:-1]) + f":{k[-1]}": n
               for k, n in keys.items()},
           "tokens": {rid: v.tolist() for rid, v in outputs.items()}}
    layout = (f"{engine.kv_layout}, "
              + (f"chunks of {engine.prefill_chunk}" if engine.prefill_chunk
                 else "whole-prompt prefill"
                 if cfg.family in ("ssm", "hybrid") else "bucketed prefill"))
    if cut:
        log(f"  {key}: depth cut {cut}")
    log(f"  {key}: {cfg.name} {weights_gb:.2f} GB bf16 ({layout}, attn_impl "
        f"{cfg.attn_impl}); served {len(done)}/{len(reqs)} requests in "
        f"{wall:.2f} s ({P} prefill calls, {D} decode steps), pool "
        f"leak-free {leak_free}, plain_calls {counts['plain_calls']}, every "
        f"plan line @kernel but the router {plan_ok}; launches "
        + ", ".join(f"{k} {got[k]} (expected {want[k]})" for k in want)
        + f", rsa_gemm {counts['rsa_gemm']}; decode {s['decode_tok_s']:.1f} "
        f"tok/s, ttft p50 {s['ttft_p50_s']:.3f} s, peak "
        f"{rec['peak_mem_gb']:.1f} GB {'ok' if ok else 'FAIL'}")
    if not ok:
        log(f"    {key} FAIL: completed {len(done)}, counts {counts}, plan "
            f"{engine.gemm_plan}")
    return ok, rec, engine, keys


def p13_inputs(torch, cfg, rng, S, n):
    """One step's inputs for S lanes of n tokens, on the card (vlm patch
    embeddings and encdec source features included)."""
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (S, n)), device="cuda")}
    fe, cdt = cfg.frontend, torch.bfloat16
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (S, fe.num_tokens, fe.feature_dim)), device="cuda").to(cdt)
    elif cfg.family == "encdec":
        batch["src_features"] = torch.as_tensor(rng.standard_normal(
            (S, P13_SRC, fe.feature_dim)), device="cuda").to(cdt)
    return batch


def p13_step(torch, engine, kind, batch, S, nxt=None):
    """One prefill and one decode step of ``engine``'s model on ``batch``
    under the ambient execution mode, from fresh KV storage.  ``kind``:
    "chunked" (paged_prefill_step, 64 rows a lane, ragged), "bucketed" (a
    padded batch prefill through the dense cache, scattered into pages
    lane by lane, then paged_decode_step) or "dense" (prefill and
    decode_step on the dense cache).  The decode step takes ``nxt`` (S,
    1), or the prefill's greedy tokens.  Returns ((S, V) prefill logits,
    (S, V) decode logits, the decoded tokens)."""
    from repro_torch.models.attention import KVCache
    model, params, cfg = engine.model, engine.params, engine.cfg
    bs = 16
    toks = batch["tokens"]
    C = toks.shape[1]
    length = C - 7                            # 7 rows of bucket padding
    fe_rows = cfg.frontend.num_tokens if cfg.family == "vlm" else 0
    rows = -(-(C + fe_rows + 1) // bs) * bs
    W = rows // bs
    tables = torch.arange(S * W, dtype=torch.int32,
                          device="cuda").reshape(S, W)
    ones = torch.ones(S, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        if kind == "chunked":
            chunk = torch.tensor([64, 64, 40, 17, 64, 1, 33, 64][:S],
                                 dtype=torch.int32, device="cuda")
            arena = model.init_paged_arena(S * W + 1, bs)
            kv0 = torch.zeros(S, dtype=torch.int32, device="cuda")
            pl, _ = model.paged_prefill_step(params, toks, arena, tables,
                                             kv0, chunk)
            nxt = pl.argmax(-1)[:, None] if nxt is None else nxt
            dl, _ = model.paged_decode_step(params, nxt, arena, tables,
                                            chunk, ones)
            return pl, dl, nxt
        src = P13_SRC if cfg.family == "encdec" else 0
        cache = model.init_cache(S, rows, src)
        pl, cache = model.prefill(params, batch, cache, length)
        nxt = pl.argmax(-1)[:, None] if nxt is None else nxt
        if kind == "dense":
            dl, _ = model.decode_step(params, nxt, cache)
            return pl, dl, nxt
        arena = model.init_paged_arena(S * W + 1, bs)
        lc = cache["layers"]
        for b in range(S):
            model.paged_prefill_write(
                arena, KVCache(lc.k[:, b:b + 1], lc.v[:, b:b + 1],
                               lc.length[:, b:b + 1]), tables[b])
        state = {k: cache[k] for k in ("cross_k", "cross_v") if k in cache}
        kv = torch.full((S,), length + fe_rows, dtype=torch.int32,
                        device="cuda")
        dl, _ = model.paged_decode_step(params, nxt, arena, tables, kv, ones,
                                        state)
        return pl, dl, nxt


def p13_logits(torch, key, engine, kind, S=4, n=64):
    """One prefill and one decode step on the kernels against the same
    steps under ``execute="torch"`` (the plain versions), bf16: 5% of the
    plain logits' largest magnitude, as phases 4-6; both decode the plain
    run's greedy tokens.  A MoE model replays the plain run's expert
    choices (RoutingReplay), as phase 6."""
    import numpy as np
    from repro_torch import dispatch
    from repro_torch.models import moe
    batch = p13_inputs(torch, engine.cfg, np.random.default_rng(7), S, n)
    replay = RoutingReplay(moe) if engine.cfg.moe is not None else None
    runs = (("record", "torch"), ("replay", "kernel")) if replay else \
        (("plain", "torch"), ("kernel", "kernel"))
    out, nxt = {}, None
    if replay:
        moe.route = replay
    try:
        for mode, execute in runs:
            if replay:
                replay.mode = mode
            with dispatch.use(execute=execute):
                *out[execute], nxt = p13_step(torch, engine, kind, batch, S,
                                              nxt)
    finally:
        if replay:
            moe.route = replay.route
    torch.cuda.synchronize()
    ok, rec = True, {}
    for i, name in ((0, "prefill"), (1, "decode")):
        ref = out["torch"][i]
        err = (out["kernel"][i] - ref).abs().max().item()
        tol = 0.05 * ref.abs().max().item()
        agree = (out["kernel"][i].argmax(-1) == ref.argmax(-1)).float() \
            .mean().item()
        good = err <= tol and math.isfinite(err)
        ok &= good
        rec.update({f"{name}_logits_max_abs_err": err,
                    f"{name}_logits_tol": tol,
                    f"{name}_greedy_agreement": agree})
        log(f"    {key} {name} step logits ({kind}), kernels vs plain"
            f"{' (same routing)' if replay else ''}: max_abs_err {err:.4e} "
            f"(tol {tol:.4e}) {'ok' if good else 'FAIL'}; greedy agreement "
            f"{agree:.3f}")
    return ok, rec


def p13_path(torch, report, key, cfg, reqs, kind, cut=None, S=4, **ecfg):
    ok, rec, engine, keys = p13_serve(torch, key, cfg, reqs, cut=cut, **ecfg)
    good, lrec = p13_logits(torch, key, engine, kind, S=S)
    rec.update(lrec)
    report["p13"][key] = rec
    P13_KEYS[key] = keys
    del engine
    torch.cuda.empty_cache()
    return ok and good


def p13_dense_decode_time(torch, report, engine, timer):
    """13d (i): one dense decode call's wall time (host clock to the
    device synchronisation) beside the blockwise route's device time for
    one layer's attention at that call's shape (8 lanes over the slot
    caches, each lane at its own length)."""
    from repro_torch.models.attention import multihead_attention
    cfg, c = engine.cfg, engine._cache
    S, T = c["layers"].k.shape[1], c["layers"].k.shape[2]
    lens = torch.tensor([64, 130, 200, 280, 350, 420, 500, T - 1],
                        device="cuda")[:S]
    q = torch.randn((S, 1, cfg.num_heads, cfg.head_dim), device="cuda") \
        .to(torch.bfloat16)
    k, v = c["layers"].k[0], c["layers"].v[0]
    attn_ms = timer(lambda: multihead_attention(
        q, k, v, causal=True, q_offset=lens - 1, kv_len=lens,
        chunk=cfg.attn_chunk))
    toks = torch.zeros((S, 1), dtype=torch.int64, device="cuda")
    walls = []
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            engine.model.decode_step(engine.params, toks, c)
            torch.cuda.synchronize()
            walls.append((time.time() - t0) * 1e3)
    rec = {"decode_call_wall_ms": statistics.median(walls),
           "blockwise_attention_ms_a_layer": attn_ms,
           "layers": cfg.num_layers, "lanes": S, "cache_rows": T}
    log(f"    13d dense decode call: wall {rec['decode_call_wall_ms']:.2f} ms "
        f"(median of 5); the blockwise route's attention "
        f"{attn_ms:.4f} ms a layer on the card (x{cfg.num_layers} layers = "
        f"{attn_ms * cfg.num_layers:.3f} ms) over {S} lanes x {T} cache rows")
    return rec


def p13_llama(torch, report, timer):
    """13d: phase 4's weights and trace on the dense layout with bucketed
    prefill, then paged with buckets scattered into pages."""
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    base = report["main_path"]["tokens"]
    ok = True
    for tag, layout in (("13d(i)", "dense"), ("13d(ii)", "paged")):
        ops.reset_counts()
        t0 = time.time()
        outputs, engine = serve_continuous(
            arch="llama3.2-1b", preset="full", num_requests=16, num_slots=8,
            prompt_len=512, min_prompt_len=64, gen=32, temperature=0.0,
            top_k=0, seed=0, execute="auto", kv_layout=layout,
            prefill_chunk=None, block_size=16, clock="wall", device="cuda",
            log=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = ops.launch_counts()
        keys = dict(rsa_gemm_cuda.launches_by_key)
        L, V = engine.cfg.num_layers, engine.cfg.vocab_size
        D = engine.metrics.decode_steps
        calls = sum(n for k, n in keys.items() if len(k) == 4 and k[2] == V)
        engine.pool.check()
        done = sum(r.outcome == "done" for r in engine.requests.values())
        leak_free = engine.pool.num_free == engine.pool.num_blocks
        want = L * D if layout == "paged" else 0
        plan_ok = all("@kernel" in d for d in engine.gemm_plan.values())
        same = sum(outputs[rid].tolist() == base[rid] for rid in base)
        good = (done == 16 and leak_free and counts["plain_calls"] == 0
                and counts["paged_decode"] == want and plan_ok
                and counts["paged_prefill"] == 0 and calls > D > 0)
        ok &= good
        rec = {"kv_layout": layout, "prefill_chunk": None, "wall_s": wall,
               "vocab": V,
               "completed": done, "pool_leak_free": leak_free,
               "prefill_calls": calls - D, "decode_steps": D,
               "counts": counts, "same_tokens_as_phase4": same,
               "decode_tok_s": engine.summary()["decode_tok_s"],
               "gemm_launches_by_shape": {
                   "x".join(str(v) for v in k[:-1]) + f":{k[-1]}": n
                   for k, n in keys.items()}}
        log(f"  {tag}: llama3.2-1b {layout} layout, bucketed prefill: served "
            f"{done}/16 in {wall:.2f} s ({calls - D} prefill calls, {D} "
            f"decode steps), leak-free {leak_free}, plain_calls "
            f"{counts['plain_calls']}, paged_decode {counts['paged_decode']}"
            f" (expected {want}), paged_prefill {counts['paged_prefill']} "
            f"(expected 0), rsa_gemm {counts['rsa_gemm']}, every plan line "
            f"@kernel {plan_ok}; {same}/16 requests emit phase 4's tokens "
            f"(not gated: the route's attention sums in another order in "
            f"bf16); decode {rec['decode_tok_s']:.1f} tok/s "
            f"{'ok' if good else 'FAIL'}")
        if layout == "dense":
            rec.update(p13_dense_decode_time(torch, report, engine, timer))
        g, lrec = p13_logits(torch, tag, engine,
                             "dense" if layout == "dense" else "bucketed")
        ok &= g
        rec.update(lrec)
        report["p13"][tag] = rec
        P13_KEYS[tag] = keys
        del engine
        torch.cuda.empty_cache()
    return ok


def p13_all(torch, report, timer):
    """Phase 13's six paths; each model is freed before the next."""
    report["p13"] = {}
    ok = True
    t = time.time()
    cfg = p13_cfg("qwen2-moe-a2.7b")
    ok &= p13_path(torch, report, "13a", cfg, p13_requests(
        cfg, 12, 64, 512, 16, seed=0), "chunked", S=8, prefill_chunk=64)
    cfg = p13_cfg("gemma-2b")
    ok &= p13_path(torch, report, "13b", cfg, p13_requests(
        cfg, 12, 64, 512, 16, seed=0), "chunked", S=8, prefill_chunk=64)
    for key, arch, full in (("13c deepseek-coder-33b", "deepseek-coder-33b",
                             62),
                            ("13c command-r-plus-104b",
                             "command-r-plus-104b", 64)):
        cfg = p13_cfg(arch, layers=2)
        ok &= p13_path(torch, report, key, cfg, p13_requests(
            cfg, 4, 64, 512, 16, seed=1), "chunked", cut=f"{full} -> 2",
            num_slots=4, prefill_chunk=64)
    ok &= p13_llama(torch, report, timer)
    cfg = p13_cfg("seamless-m4t-medium", optimized=True)
    ok &= p13_path(torch, report, "13e", cfg, p13_requests(
        cfg, 8, 32, 128, 16, seed=2), "bucketed", src_len=P13_SRC,
        prefill_chunk=None)
    cfg = p13_cfg("internvl2-76b", layers=2)
    ok &= p13_path(torch, report, "13f", cfg, p13_requests(
        cfg, 4, 32, 128, 16, seed=3), "bucketed", cut="80 -> 2",
        num_slots=4, prefill_chunk=None)
    report["phase13_s"] = time.time() - t
    return ok


def p13_gemms(torch, report, timer, dispatcher):
    """Each phase 13 path's two most launched 2-D GEMM shapes against the
    plain version, timed beside ``torch.matmul`` and the bound (the kernel
    table's phase 13 GEMM entries)."""
    ok = True
    report["p13_gemm"] = []
    for key, keys in P13_KEYS.items():
        top = sorted((k for k in keys if len(k) == 4),
                     key=lambda k: -keys[k])[:2]
        good, recs = check_gemm_keys(torch, timer, top, dispatcher,
                                     report["p13"][key]["vocab"])
        ok &= good
        for rec in recs:
            rec["path"] = key
        report["p13_gemm"] += recs
    return ok


# ---------------------------------------------------------------------------
# phase 14: the recurrent families end to end
# ---------------------------------------------------------------------------

def p14_serve(torch, report, timer):
    """14a: ``zamba2-7b`` at its published widths with no depth cut (81
    slots: 68 Mamba2 layers in 13 groups of 5, each group followed by the
    one shared attention + MLP block, then 3 more Mamba layers), bf16,
    random weights from seed 0, on the dense slot layout (its only one), 8
    slots, 8 requests of 64, 128, ..., 512 tokens and 16 greedy new
    tokens each.  Phase 13's gates (every request done, the pool
    leak-free, 0 plain calls, every plan line on the kernel, no paged
    kernel), 228 GEMM launches a model call (2 x 68 + 7 x 13 + the
    unembedding); then one decode call's wall beside the device time of
    its SSD scans and blockwise attention, and the logits check."""
    import numpy as np
    from repro_torch.models.transformer import hybrid_layout
    from repro_torch.serving import Request
    cfg = p13_cfg("zamba2-7b", optimized=True)
    n_m, n_groups, _, _ = hybrid_layout(cfg)
    rng = np.random.default_rng(14)
    reqs = [Request(rid=f"req-{i}", max_new_tokens=P14_GEN,
                    prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32)) for i, n in enumerate(P14_LENS)]
    ok, rec, engine, keys = p13_serve(torch, "14a", cfg, reqs,
                                      num_slots=P14_SLOTS)
    per_call = 2 * n_m + 7 * n_groups + 1
    calls = rec["prefill_calls"] + rec["decode_steps"]
    good = (engine.kv_layout == "dense" and rec["prefill_calls"] == len(reqs)
            and rec["counts"]["rsa_gemm"] == per_call * calls)
    rec.update(layout=hybrid_layout(cfg), gemm_per_call_expected=per_call,
               gemm_per_call=rec["counts"]["rsa_gemm"] / max(calls, 1),
               prompt_lens=list(P14_LENS))
    log(f"  14a: {n_m} Mamba layers in {n_groups} groups + the shared block"
        f" (no depth cut); rsa_gemm launches a model call "
        f"{rec['gemm_per_call']:.1f} (2 x {n_m} + 7 x {n_groups} + 1 = "
        f"{per_call}) over {calls} calls {'ok' if good else 'FAIL'}")
    log("  14a gemm plan (recommendation, then what the kernel ran):")
    for site, desc in engine.gemm_plan.items():
        log(f"    {site:<16} {desc}")
    rec["decode_time"] = p14_decode_time(torch, engine, timer)
    lgood, lrec = p14_logits(torch, engine)
    rec.update(lrec)
    report["p14"]["14a"] = rec
    P14_KEYS["14a"] = keys
    del engine
    torch.cuda.empty_cache()
    return ok and good and lgood


def p14_decode_time(torch, engine, timer):
    """One decode call of the served engine's 8 slots: its wall (host
    clock to the device synchronisation, median of 5), the device time its
    kernels took (``torch.profiler``'s kernel events; "not measured" where
    it records none) and so the card's idle share of the call.  Beside it,
    isolated timings on random inputs, each multiplied by its count in a
    call: one SSD scan at the call's shape (8 lanes, one 1-row chunk from a
    carried state) times the 68 Mamba layers, and one shared-block
    attention over the slot caches (the blockwise route, each lane at its
    own length) times the 13 calls."""
    from repro_torch.models.attention import multihead_attention
    from repro_torch.models.ssm import _ssd_chunked, mamba_dims
    from repro_torch.models.transformer import hybrid_layout
    cfg, c = engine.cfg, engine._cache
    n_m, n_groups, _, _ = hybrid_layout(cfg)
    S, T = c["attn"].k.shape[1], c["attn"].k.shape[2]
    toks = torch.zeros((S, 1), dtype=torch.int64, device="cuda")
    walls = []
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            engine.model.decode_step(engine.params, toks, c)
            torch.cuda.synchronize()
            walls.append((time.time() - t0) * 1e3)
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.launch.roofline import kernel_events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.model.decode_step(engine.params, toks, c)
            torch.cuda.synchronize()
        # the kernels' own events only (launch/roofline.py)
        busy = sum(us for _, us in kernel_events(prof)) / 1e3 or None
    d_inner, H, P, N = mamba_dims(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    xh, Bm, Cm = rn(S, 1, H, P), rn(S, 1, N), rn(S, 1, N)
    loga, h = -torch.rand((S, 1, H), generator=gen, device="cuda"), \
        rn(S, H, P, N) * 0.1
    ssd_ms = timer(lambda: _ssd_chunked(xh, Bm, Cm, loga, h, cfg.ssm.chunk))
    lens = torch.tensor([64, 130, 200, 280, 350, 420, 500, T - 1],
                        device="cuda")[:S]
    q = rn(S, 1, cfg.num_heads, cfg.head_dim).to(torch.bfloat16)
    attn_ms = timer(lambda: multihead_attention(
        q, c["attn"].k[0], c["attn"].v[0], causal=True, q_offset=lens - 1,
        kv_len=lens, chunk=cfg.attn_chunk))
    wall = statistics.median(walls)
    rec = {"decode_call_wall_ms": wall, "device_busy_ms": busy,
           "device_idle_share": None if busy is None else 1 - busy / wall,
           "ssd_ms_a_layer": ssd_ms, "ssd_ms_a_call": ssd_ms * n_m,
           "blockwise_attention_ms_a_call": attn_ms,
           "attention_ms_a_step": attn_ms * n_groups, "lanes": S,
           "cache_rows": T}
    log(f"    14a decode call: wall {wall:.2f} ms (median of 5), kernels "
        + ("not measured" if busy is None else
           f"{busy:.2f} ms on the card (torch.profiler; idle "
           f"{100 * rec['device_idle_share']:.0f}% of the wall)")
        + f"; timed alone on random inputs: the SSD scan {ssd_ms:.4f} ms "
        f"a layer (x{n_m} = {ssd_ms * n_m:.3f} ms), the blockwise attention"
        f" {attn_ms:.4f} ms a call (x{n_groups} = {attn_ms * n_groups:.3f} "
        f"ms) over {S} lanes x {T} cache rows")
    return rec


def p14_logits(torch, engine, S=4, n=64):
    """One batched prefill (S lanes of n tokens, exact length) and one
    decode step of the served model on the kernels against the same steps
    on the plain versions, in bf16 as served and with the same weights in
    f32; every run decodes the plain bf16 run's greedy tokens.  Gates:
    f32, 5% of the plain logits' largest magnitude (phases 4-8); bf16, 5%
    (phase 13's gate) or, where the bf16 rounding flips grown through 81
    slots pass that, no further from the plain bf16 run than the plain
    bf16 run is from the plain f32 run (phase 8's gate); which one held is
    printed."""
    import numpy as np
    from repro_torch import dispatch
    from repro_torch.models.api import build_model
    cfg, model, params = engine.cfg, engine.model, engine.params
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (S, n)), device="cuda")
    out, nxt = {}, None
    for dt in ("bf16", "f32"):
        m, p = (model, params) if dt == "bf16" else \
            (build_model(cfg32, "cuda"), _map_tree(params,
                                                   lambda t: t.float()))
        for mode in ("torch", "kernel"):
            with torch.no_grad(), dispatch.use(execute=mode):
                pl, cache = m.prefill(p, {"tokens": toks},
                                      m.init_cache(S, n + 1))
                nxt = pl.argmax(-1)[:, None] if nxt is None else nxt
                dl, _ = m.decode_step(p, nxt, cache)
            out[dt, mode] = (pl, dl)
            del cache
        del p
    torch.cuda.synchronize()
    ok, rec = True, {}
    for i, name in ((0, "prefill"), (1, "decode")):
        def diff(a, b):
            return (out[a][i] - out[b][i]).abs().max().item()
        err = diff(("f32", "kernel"), ("f32", "torch"))
        tol = 0.05 * out["f32", "torch"][i].abs().max().item()
        err16 = diff(("bf16", "kernel"), ("bf16", "torch"))
        tol16 = 0.05 * out["bf16", "torch"][i].abs().max().item()
        floor16 = diff(("bf16", "torch"), ("f32", "torch"))
        gate = ("5%" if err16 <= tol16 else
                "plain bf16 vs f32" if err16 <= floor16 else "none")
        agree = (out["bf16", "kernel"][i].argmax(-1) ==
                 out["bf16", "torch"][i].argmax(-1)).float().mean().item()
        good = (err <= tol and math.isfinite(err) and gate != "none"
                and math.isfinite(err16))
        ok &= good
        rec.update({f"{name}_logits_f32_max_abs_err": err,
                    f"{name}_logits_f32_tol": tol,
                    f"{name}_logits_bf16_max_abs_err": err16,
                    f"{name}_logits_bf16_tol_5pct": tol16,
                    f"{name}_logits_bf16_plain_vs_f32": floor16,
                    f"{name}_logits_bf16_gate": gate,
                    f"{name}_greedy_agreement": agree})
        log(f"    14a {name} logits, kernels vs plain: f32 max_abs_err "
            f"{err:.4e} (tol {tol:.4e}); bf16 {err16:.4e} (5% {tol16:.4e}, "
            f"plain bf16 vs plain f32 {floor16:.4e}; gate held: {gate}) "
            f"{'ok' if good else 'FAIL'}; bf16 greedy agreement {agree:.3f}")
    return ok, rec


def p14_train(torch, report, key, arch, layers=None, lr=1e-3):
    """14b / 14c: ``train_main`` on ``arch`` (optimized profile) at its
    published widths, f32, 4 steps of 2 x 1024 tokens at ``lr``, ``layers``
    slots when a depth cut is given (printed); every kernel counted.
    Gates, as phase 7: a falling loss, no restart, no plain call, each
    kernel's launches a step as expected (under remat each forward GEMM
    runs twice and has its dx and dw; the flash forward or the WKV kernel
    runs twice a block, its backward once for flash and never for WKV: the
    WKV backward recomputes through the plain scan, which counts nothing),
    and step 1's loss and grad norm within 1e-5 / 1e-4 relative of the
    same step from the same init and batch on the plain versions.  rwkv6
    also holds phase 7's gate at 2 layers of the same widths, and its
    24-layer step 1 runs again in ``launch/probe_grad.py`` (a process of
    its own, since it widens f32 to f64 there) on the kernels, on the plain
    versions and on the plain versions in f64.  Through 24 random-weight
    layers the gradient grows ~34x and so does any rounding: the plain
    f32 step's own grad norm lies further than 1e-4 from the f64 step's,
    so where two f32 runs differ by more than 1e-4 the kernel run is held
    against the f64 step instead: its grad norm and its whole gradient no
    further from it than twice the plain f32 run's distances (two f32 runs
    that differ only in rounding lie at different distances; a fault in an
    f32 kernel lies orders of magnitude further), and the probed kernel
    step the trained one to 1e-5.  The gate that held is printed."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, _batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.launch.steps import _dispatch_ctx, build_train_step
    from repro_torch.launch.train import train_main
    from repro_torch.models.transformer import hybrid_layout
    cfg = get_arch(arch, optimized=True)
    cfg32 = cfg.replace(num_layers=layers or cfg.num_layers,
                        param_dtype="float32", compute_dtype="float32",
                        opt_state_dtype="float32")
    if layers:
        log(f"  {key}: depth cut {cfg.num_layers} -> {layers} slots "
            f"({hybrid_layout(cfg32)[0]} Mamba layers in "
            f"{hybrid_layout(cfg32)[1]} groups + the shared block), full "
            f"width")
    ckpt = ROOT / "build" / f"chip_smoke_train_{key}"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.time()
    params, history, driver = train_main(
        override_cfg=cfg, preset="full", steps=TRAIN_STEPS,
        global_batch=TRAIN_B, seq_len=TRAIN_S, checkpoint_dir=str(ckpt),
        checkpoint_every=10 * TRAIN_STEPS, lr=lr, log_every=1, seed=0,
        execute="kernel", device="cuda", num_layers=layers)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    keys = dict(rsa_gemm_cuda.launches_by_key)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in _leaves(params))
    restarts = driver.restarts
    step_s = [e.seconds for e in driver.events]
    del params, driver
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    chunks = -(-TRAIN_S // cfg.loss_chunk)
    if cfg.family == "hybrid":
        n_m, n_groups, _, _ = hybrid_layout(cfg32)
        expect = {"rsa_gemm": 4 * (2 * n_m + 7 * n_groups + chunks),
                  "flash_fwd": 2 * n_groups, "flash_dq": n_groups,
                  "flash_dkv": n_groups}
    else:
        L = cfg32.num_layers
        expect = {"rsa_gemm": 4 * (RW_GEMM_SITES * L + chunks),
                  "wkv_bshk": 2 * L}
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}

    # the same first step on the plain versions (and rwkv6's control),
    # from the same init and the same batch (the loader's step 0)
    batch = {"tokens": torch.from_numpy(_batch(DataConfig(
        cfg32.vocab_size, TRAIN_S, TRAIN_B, seed=0), 0)["tokens"])
        .to("cuda")}

    def first_step(execute, scfg):
        model, step_fn, opt = build_train_step(scfg, lr=lr, device="cuda")
        p0 = model.init(0)
        ops.reset_counts()
        with _dispatch_ctx("train_step", execute):
            _, _, met = step_fn(p0, opt.init(p0), batch)
        out = (float(met["loss"]), float(met["grad_norm"]),
               ops.launch_counts())
        del p0, met, model, step_fn
        torch.cuda.empty_cache()
        return out
    plain_loss, plain_gn, plain_counts = first_step("torch", cfg32)
    probe = shallow = None
    if cfg.family == "ssm":
        # the same widths at 2 layers, where nothing has grown: phase 7's
        # gate, kernels against plain
        c2 = cfg32.replace(num_layers=2)
        (kl, kg, _), (pl, pg, _) = (first_step(e, c2)
                                    for e in ("kernel", "torch"))
        shallow = (abs(kl - pl) / abs(pl), abs(kg - pg) / abs(pg), pg)
        probe = p14_probe(key, arch, layers)

    losses = [h["loss"] for h in history]
    loss_err = abs(history[0]["loss"] - plain_loss) / abs(plain_loss)
    gn_err = abs(history[0]["grad_norm"] - plain_gn) / abs(plain_gn)
    vs64 = None
    if probe is not None:
        gn64 = probe["grad_norm"]["f64"]
        vs64 = {n: (abs(probe["grad_norm"][n] - gn64) / gn64,
                    probe["vs_f64"]["whole"][n]) for n in ("kernel", "plain")}
        vs64["tie"] = abs(probe["grad_norm"]["kernel"]
                          - history[0]["grad_norm"]) / plain_gn
    gn_gate = ("1e-4" if gn_err <= 1e-4 else "f64" if vs64 is not None
               and vs64["tie"] <= 1e-5
               and all(vs64["kernel"][i] <= 2 * vs64["plain"][i]
                       for i in (0, 1)) else "none")
    med = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    ok = (restarts == 0 and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and len(history) == TRAIN_STEPS
          and counts["plain_calls"] == 0
          and all(counts[k] == TRAIN_STEPS * v for k, v in expect.items())
          and loss_err <= 1e-5 and gn_gate != "none"
          and (shallow is None or (shallow[0] <= 1e-5
                                   and shallow[1] <= 1e-4))
          and plain_counts["plain_calls"] > 0
          and sum(v for k, v in plain_counts.items()
                  if k != "plain_calls") == 0)
    report["p14"][key] = {
        "arch": cfg.name, "num_layers": cfg32.num_layers,
        "cut": layers, "params": n_params, "dtype": "float32",
        "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
        "wall_s": wall, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in history],
        "restarts": restarts, "counts": counts,
        "launches_per_step": per_step, "expected_per_step": expect,
        "gemm_launches_by_shape": {
            f"{k[0]}x{k[1]}x{k[2]}:{k[3]}": v for k, v in keys.items()},
        "step_s": step_s, "median_step_s": med,
        "tokens_per_s": TRAIN_B * TRAIN_S / med, "peak_memory_gb": peak_gb,
        "lr": lr, "plain_step1_loss": plain_loss,
        "plain_step1_grad_norm": plain_gn, "step1_loss_rel_err": loss_err,
        "step1_grad_norm_rel_err": gn_err,
        "vs_f64": vs64, "grad_norm_gate": gn_gate,
        "two_layers": None if shallow is None else dict(zip(
            ("loss_rel_err", "grad_norm_rel_err", "plain_grad_norm"),
            shallow)),
        "plain_counts": plain_counts, "ok": ok}
    P14_KEYS[key] = keys
    log(f"  {key}: {arch} {n_params / 1e9:.3f} B parameters, f32, lr "
        f"{lr:g}, trained {len(history)} steps in {wall:.2f} s (wall, two "
        f"checkpoints), restarts {restarts}, losses "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"  {key}: launches per step: " + ", ".join(
        f"{k} {per_step[k]:.1f} (expected {v})" for k, v in expect.items())
        + f", plain_calls {counts['plain_calls']}")
    log(f"  {key}: step {1e3 * med:.1f} ms (median of steps 2-{TRAIN_STEPS})"
        f", {TRAIN_B * TRAIN_S / med:.1f} tokens/s; peak memory "
        f"{peak_gb:.1f} GB")
    log(f"  {key}: step 1 vs plain versions: loss {history[0]['loss']:.6f} "
        f"vs {plain_loss:.6f} (rel {loss_err:.2e}, tol 1e-5), grad_norm "
        f"{history[0]['grad_norm']:.6f} vs {plain_gn:.6f} (rel "
        f"{gn_err:.2e}, tol 1e-4"
        + ("" if vs64 is None else
           f"; from the f64 step: kernel grad_norm rel "
           f"{vs64['kernel'][0]:.2e}, gradient rel {vs64['kernel'][1]:.2e};"
           f" plain f32 {vs64['plain'][0]:.2e}, {vs64['plain'][1]:.2e} "
           f"(kernel tol 2x plain); probed kernel step vs trained "
           f"{vs64['tie']:.2e} (tol 1e-5)") + f"; gate held: {gn_gate})"
        + ("" if shallow is None else
           f"; at 2 layers of the same widths: loss rel {shallow[0]:.2e}, "
           f"grad_norm rel {shallow[1]:.2e} (tol 1e-5 / 1e-4; the plain "
           f"grad norm {shallow[2]:.4f} there, {plain_gn:.4f} at "
           f"{cfg32.num_layers} layers)")
        + f" {'ok' if ok else 'FAIL'}")
    return ok


def p14_probe(key, arch, layers):
    """``launch/probe_grad.py`` on ``arch`` at phase 7's batch: step 1 on
    the kernels, on the plain versions and on the plain versions in f64,
    in a process of its own; its record, or None where it failed."""
    out = ROOT / "build" / f"chip_smoke_{key}_probe_grad.json"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.probe_grad",
           "--arch", arch, "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
           "--lrs", "", "--runs", "kernel,plain,f64", "--out", str(out)]
    if layers:
        cmd += ["--layers", str(layers)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.time()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    for line in run.stdout.splitlines():
        if line.strip() and not line.startswith("    layer"):
            log(f"    {key} probe_grad: {line.strip()}")
    log(f"  {key}: probe_grad exit {run.returncode} in "
        f"{time.time() - t0:.1f} s")
    if run.returncode or not out.exists():
        log(run.stderr[-4000:])
        return None
    return json.loads(out.read_text())


def p14_all(torch, report, timer):
    """Phase 14: 14a zamba2-7b served uncut, 14b zamba2-7b trained at
    full width cut to 13 slots, 14c rwkv6-1.6b trained uncut."""
    t0 = time.time()
    report["p14"] = {}
    ok = p14_serve(torch, report, timer)
    ok &= p14_train(torch, report, "14b", "zamba2-7b", P14_TRAIN_SLOTS)
    # rwkv6's random-weight gradient grows ~34x from 2 to 24 layers, and
    # at phase 7's lr of 1e-3 its loss rises on the plain versions too
    # (launch/probe_grad.py); at 1e-4 it falls
    ok &= p14_train(torch, report, "14c", "rwkv6-1.6b", lr=1e-4)
    report["phase14_s"] = time.time() - t0
    return ok


class _NoCheckpoint:
    """Stands in for a ``TrainDriver``'s checkpoint manager where phase 15
    writes no checkpoint (all its runs but 15b): a step that raised would
    have nothing to restore, so it fails the run."""

    def save(self, *args, **kwargs):
        pass

    def wait(self):
        pass

    def restore(self, *args, **kwargs):
        raise RuntimeError("phase 15 keeps no checkpoint to restore from")


def p15_expected(cfg):
    """Each kernel's launches in one train step of ``cfg`` (optimized
    profile, every layer under remat): a GEMM whose input and weight both
    take gradients runs its forward twice (forward, recompute) and its dx
    and dw once; a frontend GEMM over the input features has no dx and is
    not recomputed (proj, proj1); a loss chunk's unembedding is
    checkpointed, 4 launches; an expert bank counts like a 2-D GEMM; the
    router is pinned to the plain product.  Every attention call (each
    decoder layer's self attention, an encdec model's encoder layers and
    cross attention) runs the flash forward twice and its backward
    once."""
    from repro_torch.models.transformer import num_dense_layers
    r = 2 if cfg.remat else 1
    full = r + 2
    attn = 6 if cfg.attention_type == "mla" else 4     # MLA: q/kv down, q/k/v
    mlp = 3                                            # up, out
    L = cfg.num_layers
    if cfg.family == "encdec":
        sites = 7 * cfg.encoder_layers + (attn + 4 + mlp) * L  # + cross 4
        calls = cfg.encoder_layers + 2 * L
        front = 2                                       # proj: fwd, dw
    else:
        nd = num_dense_layers(cfg)
        moe = 3 + (3 if cfg.moe and cfg.moe.num_shared_experts else 0)
        sites = (attn + mlp) * nd + (attn + (moe if cfg.moe else mlp)) * \
            (L - nd)
        calls = L
        front = 2 + 3 if cfg.family == "vlm" else 0     # proj1, proj2
    chunks = -(-TRAIN_S // cfg.loss_chunk)
    return {"rsa_gemm": full * sites + front + 4 * chunks,
            "flash_fwd": r * calls, "flash_dq": calls, "flash_dkv": calls}


def published_params(cfg, dense_layers=0, moe_layers=0):
    """Parameters of ``cfg`` at its published widths with the given numbers
    of dense-MLP and MoE layers and its embeddings (untied: both), counted
    from the shapes ``models/transformer.py::init_params`` draws."""
    from repro_torch.models.moe import padded_num_experts
    d, H = cfg.d_model, cfg.num_heads
    if cfg.attention_type == "mla":
        m = cfg.mla
        attn = (d * m.q_lora_rank + m.q_lora_rank
                + m.q_lora_rank * H * (m.qk_nope_head_dim
                                       + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * d)
    else:
        attn = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
    dense = 2 * d + attn + 3 * d * cfg.d_ff
    moe = 0
    if cfg.moe is not None:
        E, f = padded_num_experts(cfg), cfg.moe.d_ff_expert
        moe = 2 * d + attn + d * E + 3 * E * d * f + \
            3 * d * f * cfg.moe.num_shared_experts
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d
    return emb + dense_layers * dense + moe_layers * moe


def p15_train(torch, report, key, arch, layers, preset, lr):
    """One phase 15 run: ``arch`` (optimized profile) at its published
    widths cut to ``layers`` (or the reduced preset), f32, 4 steps of 2 x
    1024 tokens (with seeded ``patch_embeds`` of the frontend's rows, or
    128 seeded ``src_features`` frames) at ``lr``, every kernel counted.
    15b trains through ``train_main`` (the driver with its checkpoints)
    and restores its final tree once; the others through a
    ``TrainDriver`` over ``build_train_step``'s step with no checkpoint.
    Gates, as phase 14 but for the first: the loss falls on step 0's batch
    (its loss after the four steps below step 1's; each step draws a new
    batch of random tokens, whose loss spreads by more than four steps
    move it), no restart, no plain call, each
    kernel's launches a step as ``p15_expected`` counts them, step 1's
    loss and grad norm within 1e-5 / 1e-4 relative of the same step from
    the same init and batch on the plain versions (and a MoE model's aux
    metrics within 1e-5 of theirs, finite), 15b's restored tree leaf for
    leaf the trained one."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, _batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.launch.steps import (ShapeSpec, _dispatch_ctx,
                                          build_train_step,
                                          model_flops_estimate)
    from repro_torch.launch.train import train_main
    from repro_torch.models.api import build_model
    from repro_torch.runtime.driver import DriverConfig, TrainDriver
    base = get_arch(arch, optimized=True)
    cfg = base.reduced() if preset == "reduced" else base
    cfg = cfg.replace(num_layers=layers or cfg.num_layers,
                      param_dtype="float32", compute_dtype="float32",
                      opt_state_dtype="float32")
    feats = {"vlm": ("patch_embeds", cfg.frontend.num_tokens),
             "encdec": ("src_features", P15_SRC)}.get(cfg.family)
    dcfg = DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)

    def make_batch(step):
        b = {"tokens": torch.from_numpy(_batch(dcfg, step)["tokens"])
             .to("cuda")}
        if feats:
            g = torch.Generator(device="cuda")
            g.manual_seed(1000 + step)
            b[feats[0]] = torch.randn(
                (TRAIN_B, feats[1], cfg.frontend.feature_dim), generator=g,
                device="cuda")
        return b

    log(f"  {key}: {arch} " + (
        f"depth cut {base.num_layers} -> {cfg.num_layers} layers, published"
        f" widths" if layers else "no depth cut, published widths"
        if preset == "full" else "the reduced preset")
        + (f", {feats[1]} seeded {feats[0]} rows" if feats else ""))
    ckpt = ROOT / "build" / f"chip_smoke_train_{key.replace(' ', '_')}"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.time()
    if key == "15b":
        params, history, driver = train_main(
            override_cfg=base, preset=preset, steps=TRAIN_STEPS,
            global_batch=TRAIN_B, seq_len=TRAIN_S, checkpoint_dir=str(ckpt),
            checkpoint_every=10 * TRAIN_STEPS, lr=lr, log_every=1, seed=0,
            execute="kernel", device="cuda", num_layers=layers)
        opt_state = driver.opt_state
        model = build_model(cfg, "cuda")
    else:
        model, step_fn, opt = build_train_step(cfg, lr=lr, device="cuda")
        params = model.init(0)

        def step(p, o, b):
            with _dispatch_ctx("train_step", "kernel"):
                return step_fn(p, o, b)

        driver = TrainDriver(DriverConfig(checkpoint_dir=str(ckpt)),
                             train_step=step, make_batch=make_batch)
        driver.ckpt = _NoCheckpoint()
        params, opt_state, history = driver.run(
            params, opt.init(params), start_step=0, num_steps=TRAIN_STEPS)
        del step_fn, opt
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    keys = dict(rsa_gemm_cuda.launches_by_key)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad(), _dispatch_ctx("eval", "kernel"):
        after0 = float(model.loss(params, make_batch(0))[0])
    del model
    n_params = sum(t.numel() for t in _leaves(params))
    flops = model_flops_estimate(cfg, params, ShapeSpec(
        "train", TRAIN_S, TRAIN_B, "train"),
        src_len=feats[1] if feats else None)
    restarts = driver.restarts
    step_s = [e.seconds for e in driver.events]
    ckpt_same = None
    if key == "15b":
        state = {"params": params, "opt": opt_state}
        latest, restored, _ = CheckpointManager(ckpt).restore(state)
        ckpt_same = latest == TRAIN_STEPS and all(
            torch.equal(a, b) for a, b in zip(_state_leaves(restored),
                                              _state_leaves(state)))
        del state, restored
    del params, opt_state, driver
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # the same first step on the plain versions, same init and batch
    model, step_fn, opt = build_train_step(cfg, lr=lr, device="cuda")
    p0 = model.init(0)
    ops.reset_counts()
    with _dispatch_ctx("train_step", "torch"):
        _, _, met = step_fn(p0, opt.init(p0), make_batch(0))
    plain = {k: float(v) for k, v in met.items()}
    plain_counts = ops.launch_counts()
    del p0, met, model, step_fn, opt
    torch.cuda.empty_cache()

    expect = p15_expected(cfg)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    losses = [h["loss"] for h in history]
    h0 = history[0]
    loss_err = abs(h0["loss"] - plain["loss"]) / abs(plain["loss"])
    gn_err = abs(h0["grad_norm"] - plain["grad_norm"]) / \
        abs(plain["grad_norm"])
    aux = None
    if cfg.moe is not None:
        aux = {k: (h0[k], plain[k], abs(h0[k] - plain[k]) /
                   max(1.0, abs(plain[k])))
               for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")}
    med = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    ok = (restarts == 0 and all(math.isfinite(x) for x in losses)
          and after0 < losses[0] and len(history) == TRAIN_STEPS
          and counts["plain_calls"] == 0
          and all(counts[k] == TRAIN_STEPS * v for k, v in expect.items())
          and loss_err <= 1e-5 and gn_err <= 1e-4
          and (aux is None or all(math.isfinite(a) and e <= 1e-5
                                  for a, _, e in aux.values()))
          and ckpt_same is not False
          and plain_counts["plain_calls"] > 0
          and sum(v for k, v in plain_counts.items()
                  if k != "plain_calls") == 0)
    report["p15"][key] = {
        "arch": cfg.name, "preset": preset, "num_layers": cfg.num_layers,
        "cut": layers, "params": n_params, "dtype": "float32",
        "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
        "features": feats, "wall_s": wall, "losses": losses,
        "step0_batch_loss_after": after0,
        "grad_norms": [h["grad_norm"] for h in history],
        "restarts": restarts, "counts": counts,
        "launches_per_step": per_step, "expected_per_step": expect,
        "gemm_launches_by_shape": {
            "x".join(map(str, k[:-1])) + f":{k[-1]}": v
            for k, v in keys.items()},
        "step_s": step_s, "median_step_s": med,
        "tokens_per_s": TRAIN_B * TRAIN_S / med,
        "model_flops_per_step": flops,
        "model_flops_share_f32_peak": flops / med / PEAK_F32_FLOPS,
        "peak_memory_gb": peak_gb, "lr": lr,
        "plain_step1": plain, "step1_loss_rel_err": loss_err,
        "step1_grad_norm_rel_err": gn_err, "aux_vs_plain": aux,
        "checkpoint_restored_identical": ckpt_same,
        "plain_counts": plain_counts, "ok": ok}
    P15_KEYS[key] = keys
    log(f"  {key}: {n_params:,} parameters, f32, lr {lr:g}, "
        f"trained {len(history)} steps in {wall:.2f} s (wall"
        f"{', two checkpoints' if key == '15b' else ', no checkpoint'}), "
        f"restarts {restarts}, losses " + " ".join(f"{x:.4f}" for x in losses)
        + f"; step 0's batch {losses[0]:.4f} -> {after0:.4f} after them")
    log(f"  {key}: launches per step: " + ", ".join(
        f"{k} {per_step[k]:.1f} (expected {v})" for k, v in expect.items())
        + f", plain_calls {counts['plain_calls']}")
    log(f"  {key}: step {1e3 * med:.1f} ms (median of steps 2-{TRAIN_STEPS})"
        f", {TRAIN_B * TRAIN_S / med:.1f} tokens/s, model FLOPs "
        f"{flops / 1e12:.4g} TFLOP a step = "
        f"{100 * flops / med / PEAK_F32_FLOPS:.3g}% of the f32 peak; peak "
        f"memory {peak_gb:.1f} GB ({1e9 * peak_gb / n_params:.1f} B a "
        f"parameter)")
    log(f"  {key}: step 1 vs plain versions: loss {h0['loss']:.6f} vs "
        f"{plain['loss']:.6f} (rel {loss_err:.2e}, tol 1e-5), grad_norm "
        f"{h0['grad_norm']:.6f} vs {plain['grad_norm']:.6f} (rel "
        f"{gn_err:.2e}, tol 1e-4)"
        + ("" if aux is None else "; aux " + ", ".join(
            f"{k} {a:.6g} vs {b:.6g} (rel {e:.1e})"
            for k, (a, b, e) in aux.items()) + " (tol 1e-5)")
        + ("" if ckpt_same is None else
           f"; final checkpoint restored "
           f"{'identical' if ckpt_same else 'DIFFERENT'}")
        + f" {'ok' if ok else 'FAIL'}")
    return ok


def p15_all(torch, report):
    """Phase 15: 15a gemma-2b cut to 6 layers, 15b qwen2-moe-a2.7b cut to
    1 layer, 15c seamless-m4t-medium uncut, 15d deepseek-v3-671b and
    internvl2-76b at the reduced preset (their published widths do not
    fit f32 AdamW on one card: printed)."""
    t0 = time.time()
    report["p15"] = {}
    ok = True
    for run in P15_RUNS:
        if run[0] == "15d deepseek":
            ok &= p15_fit_note(report)
        ok &= p15_train(torch, report, *run)
        torch.cuda.empty_cache()
    report["phase15_s"] = time.time() - t0
    return ok


def p15_fit_note(report):
    """Why 15d runs the reduced preset: the parameters of one layer at
    the published widths, beside 15a's measured bytes a parameter."""
    from repro_torch.configs.registry import get_arch
    a = report["p15"]["15a"]
    per = 1e9 * a["peak_memory_gb"] / a["params"]
    ds, iv = get_arch("deepseek-v3-671b"), get_arch("internvl2-76b")
    note = {"bytes_per_param_15a": per,
            "deepseek_dense_layer_and_embeddings": published_params(ds, 1),
            "deepseek_moe_layer_alone": published_params(ds, 0, 1)
            - published_params(ds),
            "internvl2_layer_and_embeddings": published_params(iv, 1)}
    report["p15"]["fit"] = note
    log(f"  15d: at published widths deepseek-v3-671b's one dense layer and "
        f"two embeddings hold {note['deepseek_dense_layer_and_embeddings'] / 1e9:.2f}"
        f" B parameters and one MoE layer alone "
        f"{note['deepseek_moe_layer_alone'] / 1e9:.2f} B; internvl2-76b's "
        f"one layer and embeddings {note['internvl2_layer_and_embeddings'] / 1e9:.2f}"
        f" B; at 15a's {per:.1f} B a parameter of f32 AdamW training "
        f"neither fits the card's 80 GB, so both run the reduced preset")
    return True


def p14_table(report):
    """Phase 14's kernel-table entries: zamba2's serving GEMM shapes with
    their launches in 14a, its training GEMMs and the flash kernels at hd
    112 with their launches in 14b (the WKV kernel's training case is
    among the WKV entries, with 14c's launches)."""
    out = []
    for rec in report["p14_gemm"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm[14a zamba2 {rec['M']}x{rec['K']}x{rec['N']} "
                 f"{rec['mode']}]", P14_KEYS["14a"].get(rec["key"], 0)))
    for rec in report["p14_train_gemm"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm[14b train {rec['site']} {rec['pass']} "
                 f"{rec['M']}x{rec['K']}x{rec['N']} {rec['mode']} f32]",
            P14_KEYS["14b"].get(rec["key"], 0)))
    f = report["p14_flash"]
    for name, t in f["timed"].items():
        out.append({
            "name": f"{name}[14b zamba2 B={f['B']} S={f['Sq']} "
                    f"H={f['H']}/{f['KVH']} hd={f['hd']} f32]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": FLASH_TPU[name],
            "launches": report["p14"]["14b"]["counts"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return out


def p15_table(report):
    """Phase 15's kernel-table entries: the three flash kernels at gemma-2b's
    hd 256 (f32) with 15a's launches and at the expanded MLA's 192 / 128
    with 15d deepseek's (the same kernels at its reduced widths: no path
    trains MLA at published widths on one card), and the bank GEMM's dx
    and dw at qwen2-moe's expert banks with 15b's launches of each
    shape."""
    out = []
    runs = {P15_FLASH["gemma"]: "15a", P15_FLASH["mla"]: "15d deepseek"}
    for rec in report["p15_flash"]:
        if rec["case"] not in runs:
            continue
        for name, t in rec["timed"].items():
            out.append({
                "name": f"{name}[{rec['case']} B={rec['B']} S={rec['Sq']} "
                        f"H={rec['H']}/{rec['KVH']} f32; launches of "
                        f"{runs[rec['case']]}]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
                "replaces": FLASH_TPU[name],
                "launches": report["p15"][runs[rec["case"]]]["counts"][name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for rec in report["p15_bank"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm_bank[15b {rec['pass']} {rec['site']} "
                 f"{rec['E']}x({rec['M']}x{rec['K']}x{rec['N']}) "
                 f"{rec['mode']} f32]", P15_KEYS["15b"].get(rec["key"], 0)))
    return out


def gemm_entry(rec, name, launches):
    """A kernel-table entry of one timed GEMM shape: every mode from
    rsa_psum.cu, each against its own pallas_call."""
    return {"name": name, "route": "cuda", "source": RSA_SRC,
            "replaces": RSA_TPU_BY_MODE[rec["mode"]], "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}


P13_PAGED = {"gemma-2b": "13b", "qwen2-moe-a2.7b": "13a"}


def bf16_flash_entries(rec, counts):
    """Kernel-table entries of the bf16 forward, dq and dk/dv of one
    ``flash_case`` record: the tensor-core kernels.  The forward's
    launches are 13e's (``counts``: seamless serves in bf16, the one path
    that runs it); no path launches the bf16 dq or dk/dv (training is
    f32), so their count is 0."""
    out = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        t = rec["timed"][name]
        fwd = name == "flash_fwd"
        out.append({
            "name": f"{name}[{rec['case']} B={rec['B']} S={rec['Sq']} "
                    f"H={rec['H']}/{rec['KVH']} hd={rec['hd']} "
                    f"{'causal' if rec['causal'] else 'bidirectional'}"
                    f"{'' if 'bf16' in rec['case'] else ' bf16'} on the "
                    f"tensor cores; "
                    f"{'launches of 13e' if fwd else 'no path launches it'}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": FLASH_TPU[name],
            "launches": counts["flash_fwd"] if fwd else 0,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return out


def p13_table(report):
    """Phase 13's kernel-table entries: the decode and prefill kernels at
    gemma-2b's and qwen2-moe's widths (launches of 13b / 13a), qwen2's
    expert banks (13a), the bf16 flash forward, dq and dk/dv at seamless's
    encoder shape (13e's forward launches), beside them phase 3's bf16
    flash cases at phase 7's and gemma-2b's shapes, and each path's two
    most launched GEMM shapes."""
    out = []
    p13, keys = report["p13"], P13_KEYS
    for rec in report["paged"]:
        path = P13_PAGED.get(rec.get("case"))
        if path is None:
            continue
        out.append({
            "name": f"{rec['kernel']}[{path} {rec['case']} S=8 G="
                    f"{rec['H'] // rec['KVH']} hd={rec['hd']}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": PAGED_TPU[rec["kernel"]],
            "launches": p13[path]["counts"][rec["kernel"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    for rec in report["bank"]:
        if rec.get("recommended") and rec["path"] == "13a":
            out.append(gemm_entry(
                rec, f"rsa_gemm_bank[13a {rec['site']} {rec['E']}x("
                     f"{rec['M']}x{rec['K']}x{rec['N']}) {rec['mode']}]",
                keys["13a"].get(rec["key"], 0)))
    for rec in [report["p13_flash"]] + [
            r for r in report["flash"] + report["p15_flash"]
            if r["case"] in (P3_BF16, P15_FLASH["gemma bf16"])]:
        out += bf16_flash_entries(rec, p13["13e"]["counts"])
    for rec in report["p13_gemm"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm[{rec['path']} {rec['M']}x{rec['K']}x{rec['N']} "
                 f"{rec['mode']}]", keys[rec["path"]].get(rec["key"], 0)))
    return out


# ---------------------------------------------------------------------------
# phase 16: the step tooling and the wave baseline
# ---------------------------------------------------------------------------

def p16_cell(torch, shape):
    """``profile_cell`` on one llama3.2-1b cell at full width (optimized
    profile), batch 1 of the shape's length.  A train_4k step that runs
    out of memory prints the measured peak and profiles phase 7's 2 x
    1024 instead, under that name.  Returns (the cell's record, its
    gates held)."""
    from repro_torch.launch.profile import profile_cell
    kw = dict(top=5, device="cuda", optimized=True, steps=3)
    torch.cuda.empty_cache()
    oom_gb = None
    try:
        out = profile_cell("llama3.2-1b", shape, {}, batch=1, **kw)
    except torch.cuda.OutOfMemoryError:
        if shape != "train_4k":
            raise
        oom_gb = torch.cuda.max_memory_allocated() / 1e9
    if oom_gb is not None:
        torch.cuda.empty_cache()
        log(f"    {shape}: out of memory at 1 x 4096 (peak {oom_gb:.2f} GB "
            f"measured); profiling phase 7's {TRAIN_B} x {TRAIN_S} instead")
        out = profile_cell("llama3.2-1b", shape, {}, batch=TRAIN_B,
                           seq_len=TRAIN_S, **kw)
    t = out["terms"]
    ran = f"{shape} ({out['batch']} x {out['seq_len']})"
    L = out["launches"]
    want = ["rsa_gemm"] + {"train": ["flash_fwd", "flash_dq", "flash_dkv"],
                           "prefill": ["flash_fwd"]}.get(out["kind"], [])
    busy_ms = 1e3 * t.busy_s
    fam_ms = {r["kernel"]: r["device_ms"] for r in out["by_kernel"]
              if r["family"]}
    shares = {"roofline_fraction": t.roofline_fraction,
              "bound_attainment": t.bound_attainment}
    gates = {
        "kernels launched": all(L[k] > 0 for k in want),
        "no plain version": L["plain_calls"] == 0,
        "device time of each": all(fam_ms.get(k, 0.0) > 0 for k in want),
        "shares <= 1.05": all(v <= 1.05 for v in shares.values()),
        "idle share in [0, 1]": 0.0 <= t.idle_share <= 1.0,
        "finite": out["finite"]}
    ok = all(gates.values())
    log(f"  16 {ran}, {out['compute_dtype']} (peak "
        f"{out['peak_flops'] / 1e12:.0f} TFLOP/s): step {1e3 * t.step_s:.3f}"
        f" ms wall (median of {len(out['step_walls_s'])}), {busy_ms:.3f} ms "
        f"of kernels in a profiled step of {1e3 * t.profiled_s:.3f} ms "
        f"(torch.profiler), idle {100 * t.idle_share:.1f}%; "
        f"build {out['build_s']:.2f} s; peak memory "
        f"{out['peak_memory_bytes'] / 1e9:.2f} GB")
    log(f"    model FLOPs {t.model_flops:.4e}, compulsory bytes "
        f"{t.model_min_bytes:.4e}: ideal compute {1e3 * t.ideal_compute_s:.3f}"
        f" ms, memory {1e3 * t.ideal_memory_s:.3f} ms ({t.dominant}); "
        f"roofline_fraction {t.roofline_fraction:.4f}, bound_attainment "
        f"{t.bound_attainment:.4f}")
    log("    launches a step: " + ", ".join(
        f"{k} {v}" for k, v in L.items() if v))
    for r in out["rows"]:
        log(f"    {r['device_ms']:10.4f} ms {100 * r['share']:5.1f}% "
            f"x{r['launches']:<5d} {r['kernel'][:100]}")
    log("    gates: " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                                  for k, v in gates.items()))
    rec = {k: v for k, v in out.items() if k != "terms"}
    rec.update(ran=ran, out_of_memory_peak_gb=oom_gb, gates=gates,
               roofline=t.to_dict())
    return rec, ok


def p16_all(torch, report):
    """Phase 16: (a) ``profile_cell`` on llama3.2-1b's train_4k,
    prefill_32k and decode_32k; (b) the dry-run's meta sweep over all 40
    cells; (c) the wave baseline, ``serve_waves`` on full-width llama in
    bf16."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import serve_waves
    t0 = time.time()
    rep = report["p16"] = {"cells": {}}
    ok = True
    for shape in P16_CELLS:
        rec, good = p16_cell(torch, shape)
        rep["cells"][shape] = rec
        ok &= good
    torch.cuda.empty_cache()

    log("  16b dry-run, --device meta, every arch x shape (estimates only):")
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    rc = dryrun.main(["--device", "meta", "--out", str(out_dir)])
    recs = [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]
    status = {f"{r['arch']} x {r['shape']}": r["status"] for r in recs}
    rep["meta_sweep"] = {"rc": rc, "status": status}
    n_ok = sum(v == "ok" for v in status.values())
    log(f"    rc {rc}: {len(recs)} cells, {n_ok} ok, "
        f"{len(recs) - n_ok} skipped")
    ok &= rc == 0 and len(recs) == 40 and all(
        v in ("ok", "skipped") for v in status.values())

    kw = dict(P16_WAVES, temperature=0.0)
    log(f"  16c wave baseline: llama3.2-1b full width, bf16, {kw['waves']} "
        f"waves of {kw['batch']} prompts x {kw['prompt_len']} tokens, "
        f"{kw['gen']} new tokens each, greedy")
    torch.cuda.synchronize()
    ops.reset_counts()
    outs, stats = serve_waves("llama3.2-1b", preset="full", device="cuda",
                              execute="kernel", log=False, **kw)
    counts = ops.launch_counts()
    pre = stats["prefill_tokens"] / stats["prefill_s"]
    dec = stats["decode_tokens"] / stats["decode_s"]
    shapes_ok = all(o.shape == (kw["batch"], kw["gen"]) for o in outs)
    good = (counts["rsa_gemm"] > 0 and counts["plain_calls"] == 0
            and shapes_ok and len(outs) == kw["waves"])
    ok &= good
    rep["waves"] = {**stats, "prefill_tok_s": pre, "decode_tok_s": dec,
                    "launches": counts, "ok": good}
    log(f"    prefill {pre:,.1f} tok/s, decode {dec:,.1f} tok/s (host clock "
        f"to a device sync); launches {counts['rsa_gemm']} RSA GEMM, "
        f"{counts['plain_calls']} plain calls: "
        + ("ok" if good else "FAIL"))
    rep["seconds"] = report["phase16_s"] = time.time() - t0
    within = rep["seconds"] <= P16_BUDGET_S
    ok &= within
    log(f"  phase 16 took {rep['seconds']:.1f} s (budget {P16_BUDGET_S:.0f} "
        f"s: {'within' if within else 'OVER'})")
    if not ok:
        log("  PHASE 16 FAIL")
    return ok


# ---------------------------------------------------------------------------
# phase 17: the example drivers and the linter
# ---------------------------------------------------------------------------

def example(name):
    """``examples/torch/<name>.py`` loaded as a module (its ``main`` not
    run)."""
    import importlib.util
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def falls(losses, n=5) -> bool:
    """The loss falls: the mean of the last ``n`` steps' below the mean of
    the first ``n`` (each step draws a new random batch, whose loss
    spreads by more than a few steps move it)."""
    return all(map(math.isfinite, losses)) and \
        statistics.mean(losses[-n:]) < statistics.mean(losses[:n])


def p17_driver(torch, rep, key, run):
    """Run one driver with the launch counts zeroed around it; returns
    (its result, its launches, its seconds)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_counts()
    t = time.time()
    out = run()
    torch.cuda.synchronize()
    sec = time.time() - t
    counts = ops.launch_counts()
    rep[key] = {"seconds": sec, "launches": {k: v for k, v in counts.items()
                                             if v}}
    return out, counts, sec


def p17_paged_check(torch, out):
    """The paged decode and prefill kernels at serve_requests' own widths
    (H 4 over KVH 2, so G = 2; hd 64; f32), slots, page size, table width
    and prefill chunk, over the lengths of the trace it served: decode at
    each request's first and last step, and with idle (length-0) lanes;
    prefill of each prompt in one chunk from 0, four lanes at a time and
    two with two idle lanes (the engine's two prefills a step).  Each
    against its plain version at check_paged's f32 tolerance.  No earlier
    phase runs G = 2."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attn import (
        paged_decode_plain, paged_prefill_plain)
    cfg, eng, reqs = out["cfg"], out["engine"], out["requests"]
    S, C = eng.ecfg.num_slots, eng.prefill_chunk
    bs, W = eng.ecfg.block_size, eng._max_blocks_per_slot
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G, scale, tol = H // KVH, 1.0 / math.sqrt(hd), 1e-5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    plens = [r.prompt_len for r in reqs]
    ends = [r.prompt_len + r.max_new_tokens for r in reqs]
    groups = [range(i, min(i + S, len(reqs))) for i in range(0, len(reqs), S)]
    cases = [("paged_decode", [plens[i] + 1 for i in g]) for g in groups]
    cases += [("paged_decode", [ends[i] for i in g]) for g in groups]
    cases += [("paged_decode", ends[:2] + [0] * (S - 2))]
    cases += [("paged_prefill", [plens[i] for i in g]) for g in groups]
    cases += [("paged_prefill", plens[-2:] + [0] * (S - 2))]
    errs, ok = [], True
    for kernel, lengths in cases:
        lengths = lengths + [0] * (S - len(lengths))
        ka, va, tables, lens = paged_inputs(torch, gen, S, KVH, G, hd, bs,
                                            lengths, torch.float32, width=W)
        if kernel == "paged_decode":
            q = torch.randn((S, H, hd), generator=gen, device="cuda")
            got = ops.paged_attention(q, ka, va, tables, lens)
            want = paged_decode_plain(q, ka, va, tables, lens,
                                      scale=scale)
        else:
            q = torch.randn((S, C, H, hd), generator=gen, device="cuda")
            st = torch.zeros_like(lens)
            got = ops.paged_prefill_attention(q, ka, va, tables, st, lens)
            want = paged_prefill_plain(q, ka, va, tables, st, lens,
                                       scale=scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        good = err <= tol and math.isfinite(err)
        ok &= good
        errs.append({"kernel": kernel, "lengths": lengths,
                     "max_abs_err": err, "ok": good})
    rec = {"H": H, "KVH": KVH, "G": G, "hd": hd, "dtype": "float32",
           "slots": S, "block_size": bs, "width": W, "chunk": C, "tol": tol,
           "cases": errs, "ok": ok}
    for kernel in ("paged_decode", "paged_prefill"):
        mine = [c for c in errs if c["kernel"] == kernel]
        log(f"    {kernel} at serve_requests' widths (H={H}/{KVH}, G={G}, "
            f"hd={hd}, f32, {S} lanes, pages of {bs}, {W} columns"
            + (f", chunk {C}" if kernel == "paged_prefill" else "")
            + f"), {len(mine)} cases: max_abs_err "
            f"{max(c['max_abs_err'] for c in mine):.3e} (tol {tol:.0e}) "
            + ("ok" if all(c["ok"] for c in mine) else "FAIL"))
    return ok, rec


def p17_all(torch, report):
    """Phase 17: (a) saralint over the port; (b) quickstart, all four
    parts; (c) serve_requests at its defaults; (d) train_lm at its 100m
    preset with the simulated preemption."""
    from repro_torch.analysis import run_paths
    from repro_torch.analysis.core import render_report
    t0 = time.time()
    rep = report["p17"] = {}
    ok = True

    findings = run_paths([str(ROOT / "src" / "repro_torch")])
    active = [f for f in findings if not f.suppressed]
    supp = [f for f in findings if f.suppressed]
    good = not active and all(f.suppress_reason for f in supp)
    ok &= good
    summary = render_report(findings).splitlines()[-1]
    rep["saralint"] = {"active": [f.render() for f in active],
                       "suppressed": len(supp), "ok": good}
    log(f"  17a {summary}: {'ok' if good else 'FAIL'}")
    for f in active:
        log(f"    {f.render()}")

    log("  17b examples/torch/quickstart.py (all four parts, defaults):")
    ckpt = ROOT / "build" / "chip_smoke_quickstart"
    shutil.rmtree(ckpt, ignore_errors=True)
    qs = example("quickstart")
    out, counts, sec = p17_driver(torch, rep, "quickstart",
                                  lambda: qs.main(["--ckpt", str(ckpt)]))
    shutil.rmtree(ckpt, ignore_errors=True)
    _, history, driver = out["part4"]
    losses = [h["loss"] for h in history]
    gemm_ok = all(r["max_abs_err"] <= 16 * F32_EPS * r["K"]
                  for r in out["part3"])
    good = (counts["rsa_gemm"] > 0 and counts["plain_calls"] == 0
            and gemm_ok and driver.restarts == 0 and len(losses) == 15
            and falls(losses) and math.isfinite(out["part2"].test_accuracy))
    ok &= good
    rep["quickstart"].update(
        part1=out["part1"], accuracy=out["part2"].test_accuracy,
        part3=[{k: (v.describe() if k == "cfg" else v) for k, v in r.items()}
               for r in out["part3"]],
        losses=losses, ok=good)
    log(f"    {sec:.1f} s; ADAPTNET accuracy "
        f"{out['part2'].test_accuracy:.4f}; GEMM errors vs matmul "
        + ", ".join(f"{r['M']}x{r['K']}x{r['N']} {r['max_abs_err']:.3e}"
                    for r in out["part3"])
        + f" (<= 16 eps K); loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"mean of the first / last 5 steps "
        f"{statistics.mean(losses[:5]):.4f} / "
        f"{statistics.mean(losses[-5:]):.4f}; "
        f"launches {rep['quickstart']['launches']}: "
        + ("ok" if good else "FAIL"))

    log("  17c examples/torch/serve_requests.py (defaults):")
    sr = example("serve_requests")
    out, counts, sec = p17_driver(torch, rep, "serve_requests",
                                  lambda: sr.main([]))
    eng, reqs = out["engine"], out["requests"]
    eng.pool.check()
    done = [r for r in eng.requests.values() if r.outcome == "done"]
    good = (len(done) == len(reqs) == 12
            and all(len(out["outputs"][r.rid]) == r.max_new_tokens
                    for r in reqs)
            and eng.pool.num_free == eng.pool.num_blocks
            and eng.kv_layout == "paged"
            and counts["rsa_gemm"] > 0 and counts["paged_decode"] > 0
            and counts["paged_prefill"] > 0 and counts["plain_calls"] == 0)
    log(f"    {sec:.1f} s; {len(done)}/{len(reqs)} requests, pool "
        f"{eng.pool.num_free}/{eng.pool.num_blocks} free; launches "
        f"{rep['serve_requests']['launches']}: " + ("ok" if good else "FAIL"))
    # the launches above were read before these comparisons ran
    paged_ok, paged = p17_paged_check(torch, out)
    good &= paged_ok
    ok &= good
    rep["serve_requests"].update(
        completed=len(done), tokens=sum(len(v) for v in out["outputs"].values()),
        leak_free=eng.pool.num_free == eng.pool.num_blocks,
        gemm_plan=eng.gemm_plan, paged_vs_plain=paged, ok=good)

    log(f"  17d examples/torch/train_lm.py {' '.join(P17_TRAIN)}:")
    ckpt = ROOT / "build" / "chip_smoke_train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    tl = example("train_lm")
    out, counts, sec = p17_driver(
        torch, rep, "train_lm",
        lambda: tl.main([*P17_TRAIN, "--ckpt", str(ckpt)]))
    steps = int(P17_TRAIN[P17_TRAIN.index("--steps") + 1])
    history, driver = out["history"], out["driver"]
    losses = [h["loss"] for h in history]
    n_params = sum(t.numel() for t in _leaves(out["params"]))
    good = (out["fired"] == [steps // 2] and driver.restarts == 1
            and [h["step"] for h in history] == list(range(steps))
            and falls(losses)
            and counts["rsa_gemm"] > 0 and counts["plain_calls"] == 0)
    ok &= good
    rep["train_lm"].update(params=n_params, fired=out["fired"],
                           restarts=driver.restarts,
                           steps=[h["step"] for h in history],
                           losses=losses, ok=good)
    log(f"    {sec:.1f} s; {n_params:,} parameters; preemption at step "
        f"{out['fired']}, {driver.restarts} restart, {len(history)} steps "
        f"run, {history[0]['step']}..{history[-1]['step']} (each once: "
        f"resumed from the step-{steps // 2} checkpoint); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first / "
        f"last 5 steps {statistics.mean(losses[:5]):.4f} / "
        f"{statistics.mean(losses[-5:]):.4f}; "
        f"{driver.straggler_report()}; launches "
        f"{rep['train_lm']['launches']}: " + ("ok" if good else "FAIL"))
    shutil.rmtree(ckpt, ignore_errors=True)

    rep["seconds"] = report["phase17_s"] = time.time() - t0
    within = rep["seconds"] <= P17_BUDGET_S
    ok &= within
    log(f"  phase 17 took {rep['seconds']:.1f} s (budget {P17_BUDGET_S:.0f} "
        f"s: {'within' if within else 'OVER'})")
    if not ok:
        log("  PHASE 17 FAIL")
    return ok


# ---------------------------------------------------------------------------
# phase 18: the distribution layer
# ---------------------------------------------------------------------------

def p18_cfg():
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("llama3.2-1b", optimized=True, global_batch=TRAIN_B,
                   devices=1)
    return cfg.replace(param_dtype="float32", compute_dtype="float32",
                       opt_state_dtype="float32", tp_strategy="dp_all")


def p18_tokens(cfg, step):
    """Phase 18's global batch of a step: the data pipeline's rows."""
    from repro_torch.data.pipeline import DataConfig, _batch
    return _batch(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0),
                  step)["tokens"]


def p18_steps(torch, step_fn, params, opt_state, cfg, rows, mesh=None,
              after_first=None, steps=P18_STEPS):
    """``steps`` steps on ``rows`` of each step's batch, calling
    ``after_first(params)`` after step 1 (off the clock); (params, opt
    state, losses, grad norms, step seconds, launch counts)."""
    from repro_torch import dispatch
    from repro_torch.kernels import ops
    from repro_torch.parallel.hints import use_mesh
    losses, norms, secs = [], [], []
    torch.cuda.synchronize()
    ops.reset_counts()
    with dispatch.use(execute="kernel"), use_mesh(mesh):
        for s in range(steps):
            toks = torch.from_numpy(p18_tokens(cfg, s)[rows]).cuda()
            t0 = time.time()
            params, opt_state, m = step_fn(params, opt_state,
                                           {"tokens": toks})
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if s == 0 and after_first is not None:
                after_first(params)
    return params, opt_state, losses, norms, secs, ops.launch_counts()


def p18_compare(torch, params, specs, mesh, want_path):
    """This rank's blocks against the unsharded step's weights after step
    1 (saved by the parent at ``want_path``, read through a memory map):
    each leaf's count of elements within the larger of 1e-4 of its
    largest magnitude and 2e-3 of its travel from the init (the rule
    tests/test_torch_train_sharded.py holds each leaf to), and its
    largest difference."""
    from repro_torch.parallel.sharding import _flat_with_path, shard_leaf
    want = torch.load(want_path, mmap=True)
    fs = dict(_flat_with_path(specs))
    out = {}
    for path, t in _flat_with_path(params):
        w = shard_leaf(want["params"][path].to(t.device), fs[path], mesh)
        diff = (t - w).abs()
        tol = max(1e-4 * want["max"][path], 2e-3 * want["travel"][path])
        out[path] = {"within": int((diff <= tol).sum()),
                     "max_diff": float(diff.max()), "n": diff.numel()}
        del w, diff
    return out


def p18_save_first(torch, params, init, path) -> int:
    """Save the weights after step 1 for the ranks' ``p18_compare``
    (each leaf, its largest magnitude and its travel from ``init``);
    returns the count of leaves."""
    from repro_torch.parallel.sharding import _flat_with_path
    flat, flat0 = dict(_flat_with_path(params)), dict(_flat_with_path(init))
    torch.save({"params": {k: t.cpu() for k, t in flat.items()},
                "max": {k: float(t.abs().max()) for k, t in flat.items()},
                "travel": {k: float((t - flat0[k]).abs().max())
                           for k, t in flat.items()}}, path)
    return len(flat)


def p18g_one_device(torch, key, cfg, want_path):
    """18g's one-device step 1 of ``cfg`` in this process, from
    ``init(0)`` on phase 18's batch: its weights saved for the ranks
    (``p18g_want``), its loss, grad norm, wall, launches and peak memory;
    the step freed before it returns."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.modules import param_count
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, step, opt = build_train_step(cfg, P18_LR, "cuda")
    init = model.init(0)
    saved = {}
    params, opt_state, losses, norms, secs, counts = p18_steps(
        torch, step, init, opt.init(init), cfg, slice(0, TRAIN_B),
        after_first=lambda p: saved.update(leaves=p18_save_first(
            torch, p, init, p18g_want(want_path, key))),
        steps=P18_RANK_STEPS)
    rec = {"arch": cfg.name, "num_layers": cfg.num_layers,
           "params": param_count(init), "losses": losses,
           "grad_norms": norms, "step_s": secs, "counts": counts,
           "leaves": saved["leaves"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, opt_state, init, model, step, opt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"    18g {key} one device: {cfg.name} cut to {cfg.num_layers} "
        f"slots, {rec['params'] / 1e9:.3f} B parameters: step 1 loss "
        f"{losses[0]:.6f}, grad norm {norms[0]:.4f}, "
        f"{1e3 * secs[0]:.1f} ms, peak memory {rec['peak_memory_gb']:.1f} "
        f"GB; launches " + ", ".join(f"{k} {v}" for k, v in counts.items()
                                     if v))
    return rec


def p18_rank_main(rank: int, world: int, store: str, out: str,
                  want_path: str) -> int:
    """One rank of 18d, then of 18f and 18g, over gloo with CUDA tensors on
    device 0: 18d the sharded step on a (world, 1) mesh, a row of the batch
    each; 18f the Megatron tp step on a (1, world) mesh, the whole batch
    each; 18g the same for each of ``P18G_RUNS`` (the weights after its
    one-device step 1 beside ``want_path``, ``p18g_want``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.parallel.sharding import (METER, local_batch_rows,
                                               shard_tree)
    t0 = time.time()
    init_distributed("cuda", rank=rank, world_size=world, store_path=store,
                     backend="gloo", timeout_s=120)
    group_s = time.time() - t0

    def run(cfg, mesh, want):
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        model, step, opt, (ps, _) = build_train_step(
            cfg, P18_LR, "cuda", mesh=mesh, global_batch=TRAIN_B)
        params = shard_tree(model.init(0), ps, mesh)
        opt_state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0, n, over = local_batch_rows(TRAIN_B, cfg, mesh)
        setup = time.time() - t0
        first, meter = {}, {}

        def after_first(p):
            meter.update(gathered_high_gb=METER.high / 1e9,
                         moved_gb=METER.moved / 1e9)
            first.update(p18_compare(torch, p, ps, mesh, want))
        METER.reset()
        params, opt_state, losses, norms, secs, counts = p18_steps(
            torch, step, params, opt_state, cfg, slice(r0, r0 + n), mesh,
            after_first, P18_RANK_STEPS)
        keys = [[list(k), v] for k, v in
                sorted(rsa_gemm_cuda.launches_by_key.items())]
        del params, opt_state, model, step, opt
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return {"rank": rank, "rows": [r0, n], "over": list(over),
                "losses": losses, "grad_norms": norms, "step_s": secs,
                "counts": counts, "gemm_keys": keys, "setup_s": setup,
                "leaves": first, **meter,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    rec = run(p18_cfg(), make_host_mesh(world, 1, "cuda"), want_path)
    rec["setup_s"] += group_s
    tp_mesh = make_host_mesh(1, world, "cuda")
    rec["tp"] = run(p18_cfg().replace(tp_strategy="tp"), tp_mesh,
                    want_path)
    rec["tp_g"] = {key: run(p18g_cfg(arch, layers), tp_mesh,
                            p18g_want(want_path, key))
                   for key, arch, layers in P18G_RUNS}
    Path(out).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def p18f_local_cfg():
    """Phase 18's llama3.2-1b as one rank of 18f's (1, 2) tp mesh computes
    it: its share of the heads, kv heads, FFN columns and vocab rows."""
    cfg = p18_cfg()
    m = P18_RANKS
    return cfg.replace(num_heads=cfg.num_heads // m,
                       num_kv_heads=cfg.num_kv_heads // m,
                       d_ff=cfg.d_ff // m, vocab_size=cfg.vocab_size // m)


def check_p18f_kernels(torch, report, timer, dispatcher):
    """The kernels of 18f's path at the local shapes a rank gives them
    (f32): every training GEMM's forward, dx and dw (the column blocks
    N / 2, the row blocks K / 2, the unembedding's vocab block; each of
    the 11 shapes of 18f's step) and the three flash kernels over a
    rank's heads, against their plain versions."""
    lcfg = p18f_local_cfg()
    log(f"  18f's local shapes (llama3.2-1b on a (1, {P18_RANKS}) tp mesh, "
        f"a rank's {lcfg.num_heads}/{lcfg.num_kv_heads} heads, "
        f"{lcfg.d_ff} FFN columns, {lcfg.vocab_size} vocab rows), f32")
    report["p18f_gemm"] = []
    # o's dw, (q / 2) x M x d, is a shape of its own once q / 2 != d
    cases = train_gemm_cases(lcfg) + [
        ("o", "dw", lcfg.q_dim, TRAIN_B * TRAIN_S, lcfg.d_model, True,
         False)]
    ok = check_train_gemms(torch, report, lcfg, dispatcher, cases=cases,
                           key="p18f_gemm")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    rec, good = flash_case(torch, timer, gen, P18F_FLASH, TRAIN_B, TRAIN_S,
                           TRAIN_S, True, torch.float32, lcfg.num_heads,
                           lcfg.num_kv_heads, lcfg.head_dim)
    report["p18f_flash"] = rec
    torch.cuda.empty_cache()
    return ok and good


def p18g_cfg(arch, layers):
    """18g's config of ``arch``: the optimized profile (the WKV and flash
    kernels), full width cut to ``layers`` slots, f32, Megatron tp."""
    from repro_torch.configs.registry import get_arch
    return get_arch(arch, optimized=True).replace(
        num_layers=layers, param_dtype="float32", compute_dtype="float32",
        opt_state_dtype="float32", tp_strategy="tp")


def p18g_want(want_path, key):
    """Where the parent saves 18g's ``key`` one-device weights after step
    1, beside 18d's."""
    return str(Path(want_path).with_name(f"p18g_{key}_want.pt"))


def p18g_local_sites():
    """(run key, site, K, N) of the GEMMs whose shape a rank of 18g's (1,
    2) mesh cuts: rwkv6's time-mix r / k / v / g column blocks, o's rows
    and the channel mix (``w_ck``'s columns, ``w_cv``'s rows and the whole
    gate ``w_cr``); zamba2's ``in_proj`` over the rank's columns of the
    packed [z | x | B | C | dt] (its heads' z, x and dt, all of B and C)
    and ``out_proj``'s rows."""
    from repro_torch.models.ssm import mamba_dims
    m = P18_RANKS
    out = []
    for key, arch, layers in P18G_RUNS:
        cfg = p18g_cfg(arch, layers)
        d = cfg.d_model
        if key == "rwkv6":
            out += [(key, "r/k/v/g", d, d // m), (key, "o", d // m, d),
                    (key, "ck", d, cfg.d_ff // m),
                    (key, "cv", cfg.d_ff // m, d), (key, "cr", d, d)]
        else:
            d_inner, H, _, N = mamba_dims(cfg)
            out += [(key, "in_proj", d, 2 * d_inner // m + 2 * N + H // m),
                    (key, "out_proj", d_inner // m, d)]
    return out


def check_p18g_kernels(torch, report, timer, dispatcher):
    """The kernels of 18g's path at the local shapes a rank of the (1, 2)
    mesh gives them (f32): the WKV forward on a rank's 16 of rwkv6's 32
    heads (B = 2, S = 1024, K = V = 64, chunk 64), the three flash kernels
    over a rank's 16 of zamba2's shared block's 32 heads of hd 112, and
    the forward, dx and dw of each GEMM whose shape the rank cuts
    (``p18g_local_sites``), each against its plain version (and the
    GEMMs beside ``torch.matmul``)."""
    from repro_torch import dispatch
    from repro_torch.kernels import ops
    from repro_torch.kernels.linear_attn import _wkv_plan
    m = P18_RANKS
    rcfg, zcfg = (p18g_cfg(arch, layers) for _, arch, layers in P18G_RUNS)
    log(f"  18g's local shapes (a rank of a (1, {m}) tp mesh: rwkv6's "
        f"{rcfg.d_model // rcfg.ssm.head_dim // m} heads, zamba2's "
        f"{zcfg.num_heads // m} shared-block heads and its Mamba2 columns)"
        f", f32")
    report["p18g_gemm"] = []
    ok = True
    for key, cfg in (("rwkv6", rcfg), ("zamba2", zcfg)):
        sites = [(n, k, nn) for run, n, k, nn in p18g_local_sites()
                 if run == key]
        cases = [c for c in train_gemm_cases(cfg, sites)
                 if c[0] != "unembed"]
        n0 = len(report["p18g_gemm"])
        ok &= check_train_gemms(torch, report, cfg, dispatcher, cases=cases,
                                key="p18g_gemm")
        for rec in report["p18g_gemm"][n0:]:
            rec["run"] = key
    # the WKV forward on a rank's heads
    H, K = rcfg.d_model // rcfg.ssm.head_dim // m, rcfg.ssm.head_dim
    B, S, chunk = TRAIN_B, TRAIN_S, rcfg.ssm.chunk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    args = (rn(B, S, H, K), rn(B, S, H, K), rn(B, S, H, K),
            -torch.exp(rn(B, S, H, K) * 0.5 - 2.0), rn(H, K) * 0.1,
            torch.zeros((B, H, K, K), device="cuda"))

    def run(mode):
        with dispatch.use(execute=mode):
            return ops.wkv_attention(*args, chunk=chunk)
    o, sf = run("kernel")
    po, psf = run("torch")
    torch.cuda.synchronize()
    err = max((o - po).abs().max().item(), (sf - psf).abs().max().item())
    tol = max(wkv_tolerance(po), wkv_tolerance(psf))
    good = err <= tol and bool(torch.isfinite(o).all())
    ok &= good
    b_ms, b_by = bound_ms(wkv_bytes(B, H, K, K, S, 4),
                          wkv_ops(B, H, K, K, S, chunk), PEAK_F32_FLOPS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rec = {"kernel": "wkv_bshk", "case": "18g tp", "B": B, "S": S, "H": H,
           "K": K, "V": K, "chunk": chunk,
           "plan": _wkv_plan(B, S, H, K, K, chunk, sms)._asdict(),
           "max_abs_err": err, "tol": tol, "ok": good,
           "ms": timer(lambda: run("kernel")),
           "plain_ms": timer(lambda: run("torch")),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    report["p18g_wkv"] = rec
    log(f"  wkv_bshk 18g tp B={B} S={S} H={H} K=V={K} chunk={chunk} (a "
        f"rank's heads, zero state0): max_abs_err {err:.3e} (tol {tol:.3e})"
        f" {'ok' if good else 'FAIL'}  kernel {rec['ms']:.4f} ms plain "
        f"{rec['plain_ms']:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    del args, o, sf, po, psf
    rec, good = flash_case(torch, timer, gen, P18G_FLASH, TRAIN_B, TRAIN_S,
                           TRAIN_S, True, torch.float32, zcfg.num_heads // m,
                           zcfg.num_kv_heads // m, zcfg.head_dim)
    report["p18g_flash"] = rec
    torch.cuda.empty_cache()
    return ok and good


def p18_table(report):
    """18f's and 18g's kernel-table entries: the RSA GEMM at each local
    training shape, the flash kernels over a rank's heads (llama's,
    zamba2's shared block's) and the WKV kernel on a rank's heads, with
    rank 0's launches in its step."""
    tp = report.get("p18", {}).get("tp", {})
    if not tp.get("ranks"):
        return []
    r0 = tp["ranks"][0]
    keys = {tuple(k): v for k, v in r0["gemm_keys"]}
    out = [gemm_entry(rec, f"rsa_gemm[18f tp {rec['site']} {rec['pass']} "
                           f"{rec['M']}x{rec['K']}x{rec['N']} {rec['mode']} "
                           f"f32]", keys.get(tuple(rec["key"]), 0))
           for rec in report["p18f_gemm"]]
    out += flash_entries(report["p18f_flash"], "18f tp", r0["counts"])
    g0 = {k: v["ranks"][0] for k, v in report["p18"]["tp_g"].items()}
    for rec in report["p18g_gemm"]:
        keys = {tuple(k): v for k, v in g0[rec["run"]]["gemm_keys"]}
        out.append(gemm_entry(
            rec, f"rsa_gemm[18g tp {rec['run']} {rec['site']} {rec['pass']}"
                 f" {rec['M']}x{rec['K']}x{rec['N']} {rec['mode']} f32]",
            keys.get(tuple(rec["key"]), 0)))
    w = report["p18g_wkv"]
    out.append({
        "name": f"wkv_bshk[18g tp rwkv6 B={w['B']} S={w['S']} H={w['H']} "
                f"chunk {w['chunk']}, a rank's heads]",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/linear_attn.cu",
        "replaces": LINEAR_TPU["wkv_bshk"],
        "launches": g0["rwkv6"]["counts"]["wkv_bshk"],
        "max_abs_err": w["max_abs_err"], "ms": w["ms"],
        "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"], "library_ms": None})
    out += flash_entries(report["p18g_flash"],
                         f"18g tp zamba2 hd {report['p18g_flash']['hd']}",
                         g0["zamba2"]["counts"])
    return out


def flash_entries(rec, what, counts):
    """Kernel-table entries of a ``flash_case`` record over a rank's
    heads, each with its launches in ``counts`` (rank 0's step)."""
    return [{"name": f"{name}[{what} B={rec['B']} S={rec['Sq']} H="
                     f"{rec['H']}/{rec['KVH']} f32, a rank's heads]",
             "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
             "replaces": FLASH_TPU[name], "launches": counts[name],
             "max_abs_err": t["max_abs_err"], "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
            for name, t in rec["timed"].items()]


def p18_tp(rep, recs, losses, norms, counts, n_want):
    """18f's gates, from the ranks' records: the Megatron tp step 1 of
    full-width llama3.2-1b on a (1, 2) mesh (each rank its heads, FFN
    columns and vocab rows, the whole batch) against (a)'s step 1: its
    loss within 1e-5 and grad norm within 1e-4 (phase 7's gates), each
    rank's blocks of each leaf within (d)'s rule at ``P18_LEAF_SHARE`` of
    the leaf's elements, no plain call, and RSA GEMM and flash launches on
    each rank."""
    log(f"  18f Megatron tp on a (1, {P18_RANKS}) mesh over gloo: each rank "
        f"its heads, FFN columns and vocab rows, the whole batch")
    if recs is None:
        rep["tp"] = {"ok": False}
        log("    the ranks failed (18d): FAIL")
        return False
    tps = [r["tp"] for r in recs]
    loss_err = max(abs(t["losses"][0] - losses[0]) / abs(losses[0])
                   for t in tps)
    gn_err = max(abs(t["grad_norms"][0] - norms[0]) / abs(norms[0])
                 for t in tps)
    share = {k: sum(t["leaves"][k]["within"] for t in tps)
             / sum(t["leaves"][k]["n"] for t in tps)
             for k in tps[0]["leaves"]}
    worst = min((v, k) for k, v in share.items())
    max_diff = max(v["max_diff"] for t in tps for v in t["leaves"].values())
    kernels = ("rsa_gemm", "flash_fwd", "flash_dq", "flash_dkv")
    launched = all(t["counts"][k] > 0 for t in tps for k in kernels)
    plain = sum(t["counts"]["plain_calls"] for t in tps)
    # each rank runs (a)'s launches a step, each on its local shapes
    as_a = all(t["counts"][k] * P18_STEPS == counts[k] * P18_RANK_STEPS
               for t in tps for k in kernels)
    peak = max(t["peak_memory_gb"] for t in tps)
    peak_cap = P18_PEAK_BEFORE_GB["f"] - P18_PEAK_SAVING_GB
    good = (loss_err <= 1e-5 and gn_err <= 1e-4 and launched and plain == 0
            and worst[0] >= P18_LEAF_SHARE and peak <= peak_cap
            and {len(t["leaves"]) for t in tps} == {n_want})
    shapes = sorted({tuple(k[-4:-1]) for k, _ in tps[0]["gemm_keys"]})
    rep["tp"] = {"mesh": [1, P18_RANKS], "ranks": tps,
                 "step1_loss_rel_err": loss_err,
                 "step1_grad_norm_rel_err": gn_err, "leaf_share": share,
                 "weights_worst_leaf": list(worst),
                 "weights_max_diff": max_diff, "launches_as_a": as_a,
                 "peak_memory_gb": peak, "peak_memory_cap_gb": peak_cap,
                 "gemm_shapes": shapes, "ok": good}
    log(f"    step 1's loss {tps[0]['losses'][0]:.6f} (rel {loss_err:.2e}, "
        f"tol 1e-5), grad norm {tps[0]['grad_norms'][0]:.4f} (rel "
        f"{gn_err:.2e}, tol 1e-4); weights after step 1, each of "
        f"{len(share)} leaves within (d)'s rule at the least "
        f"{100 * worst[0]:.3f}% ({worst[1]}; tol "
        f"{100 * P18_LEAF_SHARE:.1f}%), largest difference {max_diff:.2e}; "
        f"{plain} plain calls; peak memory {peak:.2f} GB a rank (cap "
        f"{peak_cap:.1f}: {P18_PEAK_BEFORE_GB['f']} GB less "
        f"{P18_PEAK_SAVING_GB:g})")
    for t in tps:
        c = t["counts"]
        log(f"    rank {t['rank']}: step 1 {1e3 * t['step_s'][0]:.1f} ms, "
            f"setup {t['setup_s']:.1f} s, peak memory "
            f"{t['peak_memory_gb']:.2f} GB, gathered high-water "
            f"{t['gathered_high_gb']:.3f} GB, collectives moved "
            f"{t['moved_gb']:.3f} GB; launches {c['rsa_gemm']} RSA "
            f"GEMM, {c['flash_fwd']} / {c['flash_dq']} / {c['flash_dkv']} "
            f"flash fwd / dq / dk-dv ({'(a)' if as_a else 'NOT (a)'}'s a "
            f"step)")
    log(f"    local GEMM shapes (M x K x N) of rank 0: "
        f"{', '.join('x'.join(map(str, k)) for k in shapes)}: "
        + ("ok" if good else "FAIL"))
    return good


def p18_tpg(rep, recs, ones, local_gemms):
    """18g's gates, from the ranks' records: each of ``P18G_RUNS`` (full
    width, depth cut, f32) one step under Megatron tp on the (1, 2) mesh,
    each rank its recurrent heads, FFN / d_ff columns and vocab rows, the
    whole batch, against its one-device step 1 (``ones``): the loss
    within 2e-4 relative, each rank's blocks of each leaf within (d)'s
    rule at ``P18_LEAF_SHARE`` of the leaf's elements, each rank's
    launches of every kernel of the run the one-device step's (the same
    calls at the local shapes: each of phase 3's local GEMM shapes in
    ``local_gemms`` launched on rank 0), no plain call."""
    log(f"  18g the recurrent families under Megatron tp on the (1, "
        f"{P18_RANKS}) mesh: each rank its heads, columns and vocab rows, "
        f"the whole batch")
    if recs is None:
        rep["tp_g"] = {"ok": False}
        log("    the ranks failed (18d): FAIL")
        return False
    ok = True
    rep["tp_g"] = {}
    for key, _, _ in P18G_RUNS:
        one, tps = ones[key], [r["tp_g"][key] for r in recs]
        loss_err = max(abs(t["losses"][0] - one["losses"][0])
                       / abs(one["losses"][0]) for t in tps)
        gn_err = max(abs(t["grad_norms"][0] - one["grad_norms"][0])
                     / abs(one["grad_norms"][0]) for t in tps)
        share = {k: sum(t["leaves"][k]["within"] for t in tps)
                 / sum(t["leaves"][k]["n"] for t in tps)
                 for k in tps[0]["leaves"]}
        worst = min((v, k) for k, v in share.items())
        max_diff = max(v["max_diff"] for t in tps
                       for v in t["leaves"].values())
        kernels = ("rsa_gemm", "wkv_bshk") if key == "rwkv6" else \
            ("rsa_gemm", "flash_fwd", "flash_dq", "flash_dkv")
        launched = all(t["counts"][k] > 0 for t in tps for k in kernels)
        as_one = all(t["counts"][k] == one["counts"][k]
                     for t in tps for k in kernels)
        plain = sum(t["counts"]["plain_calls"] for t in tps) + \
            one["counts"]["plain_calls"]
        keys = {tuple(k): v for k, v in tps[0]["gemm_keys"]}
        local = [r for r in local_gemms if r["run"] == key]
        seen = sum(keys.get(tuple(r["key"]), 0) > 0 for r in local)
        good = (loss_err <= 2e-4 and launched and as_one and plain == 0
                and worst[0] >= P18_LEAF_SHARE and seen == len(local)
                and {len(t["leaves"]) for t in tps} == {one["leaves"]})
        ok &= good
        rep["tp_g"][key] = {
            "mesh": [1, P18_RANKS], "one_device": one, "ranks": tps,
            "step1_loss_rel_err": loss_err,
            "step1_grad_norm_rel_err": gn_err, "leaf_share": share,
            "weights_worst_leaf": list(worst), "weights_max_diff": max_diff,
            "launches_as_one_device": as_one,
            "local_gemm_shapes_launched": f"{seen} of {len(local)}",
            "gemm_shapes": sorted({tuple(k[-4:-1])
                                   for k, _ in tps[0]["gemm_keys"]}),
            "ok": good}
        log(f"    {key} ({one['arch']}, {one['num_layers']} slots): step 1's "
            f"loss {tps[0]['losses'][0]:.6f} (rel {loss_err:.2e}, tol 2e-4)"
            f", grad norm {tps[0]['grad_norms'][0]:.4f} (rel {gn_err:.2e}, "
            f"not gated: scripts/probe_tp_grad.py); "
            f"weights after step 1, each of {len(share)} leaves within (d)'s"
            f" rule at the least {100 * worst[0]:.3f}% ({worst[1]}; tol "
            f"{100 * P18_LEAF_SHARE:.1f}%), largest difference "
            f"{max_diff:.2e}; phase 3's local GEMM shapes launched: {seen} "
            f"of {len(local)}; {plain} plain calls")
        for t in tps:
            c = t["counts"]
            log(f"    {key} rank {t['rank']}: step 1 "
                f"{1e3 * t['step_s'][0]:.1f} ms (one device "
                f"{1e3 * one['step_s'][0]:.1f}), setup {t['setup_s']:.1f} s,"
                f" peak memory {t['peak_memory_gb']:.2f} GB (one device "
                f"{one['peak_memory_gb']:.2f}), gathered high-water "
                f"{t['gathered_high_gb']:.3f} GB, collectives moved "
                f"{t['moved_gb']:.3f} GB; launches "
                + ", ".join(f"{k} {c[k]}" for k in kernels)
                + f" ({'the one-device step' if as_one else 'NOT one-device'}"
                f"'s): " + ("ok" if good else "FAIL"))
    return ok


def p18_entry(rep, args):
    """18e: the entry point users launch, ``torchrun --standalone
    --nproc-per-node 1 -m repro_torch.launch.train --device cuda``
    (``train_main``'s mesh branch: the NCCL group from torchrun's
    environment and its ``LOCAL_RANK`` device, the loader's rows, the
    driver's failure all-reduce, ``save_sharded``'s gather), against
    ``train_main`` on one device in this process: the printed losses
    equal, the final checkpoints (parameters and AdamW state) bit for
    bit, every GEMM site on the kernel."""
    import re
    import signal

    import numpy as np

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train_main
    args = list(args)
    steps = int(args[args.index("--steps") + 1])
    batch = int(args[args.index("--batch") + 1])
    seq = int(args[args.index("--seq") + 1])
    log(f"  18e the entry point: torchrun --standalone --nproc-per-node 1 -m "
        f"repro_torch.launch.train --device cuda {' '.join(args)}, against "
        f"train_main on one device")
    one = ROOT / "build" / "p18e_one"
    ran = ROOT / "build" / "p18e_torchrun"
    for d in (one, ran):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.time()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
         "--device", "cuda", *args, "--ckpt", str(ran)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        text = proc.communicate(timeout=P18_MAIN_DEADLINE_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text = proc.communicate()[0] + "\n(killed at the deadline)"
    wall = time.time() - t0
    # this process: no process group, no torchrun environment
    cfg = get_arch("llama3.2-1b", optimized=True, global_batch=batch,
                   devices=1)
    _, history, _ = train_main(
        override_cfg=cfg, steps=steps, global_batch=batch, seq_len=seq,
        checkpoint_dir=str(one), log_every=10, device="cuda")
    printed = re.findall(r"step +(\d+) loss (\S+)", text)
    want = [(str(h["step"]), f"{h['loss']:.4f}")
            for h in history[::10] + history[-1:]]
    mesh_line = "{'data': 1, 'model': 1} ranks of cuda" in text
    sites = re.search(r"dispatch: (\d+) GEMM sites executed \((.*)\)", text)
    on_kernel = bool(sites) and sites.group(2) == \
        f"{{'kernel': {sites.group(1)}}}"
    same = False
    if proc.returncode == 0:
        sa, fa, _ = load_checkpoint(ran)
        sb, fb, _ = load_checkpoint(one)
        same = sa == sb == steps and sorted(fa) == sorted(fb) and all(
            np.array_equal(fa[k], fb[k]) for k in fb)
    good = (proc.returncode == 0 and mesh_line and on_kernel
            and printed == want and same)
    rep["entry_point"] = {"returncode": proc.returncode, "wall_s": wall,
                          "printed_losses": printed, "one_device": want,
                          "mesh": mesh_line, "on_kernel": on_kernel,
                          "checkpoints_equal": same, "ok": good}
    log(f"    {wall:.1f} s with torchrun's start; exit {proc.returncode}; "
        f"over a (1, 1) mesh of cuda {mesh_line}; GEMM sites "
        f"{sites.group(0) if sites else 'not printed'}; losses "
        f"{' '.join(v for _, v in printed)} (one device "
        f"{' '.join(v for _, v in want)}); step-{steps} checkpoints "
        f"{'bit for bit' if same else 'DIFFERENT'}: "
        + ("ok" if good else "FAIL"))
    if not good:
        log("    " + text[-3000:].replace("\n", "\n    "))
    for d in (one, ran):
        shutil.rmtree(d, ignore_errors=True)
    return good


def p18_all(torch, report):
    """Phase 18: (a) the unsharded step, (b) the sharded step over an
    NCCL group of one rank, (c) ``quantized_psum_tree`` over it, (d) two
    ranks on the one card over gloo, (f) the same ranks under Megatron tp
    (``p18_tp``), (g) the recurrent families under it (``p18_tpg``, their
    one-device steps run here first), (e) the train entry point under
    torchrun."""
    import torch.distributed as dist
    from repro_torch import dispatch
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel.collectives import (_dequant, _quant,
                                                  quantized_psum_tree)
    from repro_torch.parallel.sharding import gather_tree, shard_tree
    t0 = time.time()
    rep = report["p18"] = {}
    ok = True
    cfg = p18_cfg()
    every = slice(0, TRAIN_B)

    log(f"  18a unsharded step: {cfg.name} full width, f32, dp_all profile, "
        f"{P18_STEPS} steps of {TRAIN_B} x {TRAIN_S}")
    model, step, opt = build_train_step(cfg, P18_LR, "cuda")
    init = model.init(0)
    # 18d's ranks read the weights after step 1 through a memory map
    want_path = ROOT / "build" / "p18_want.pt"
    saved = {}
    params, _, losses, norms, secs, counts = p18_steps(
        torch, step, init, opt.init(init), cfg, every,
        after_first=lambda p: saved.update(
            leaves=p18_save_first(torch, p, init, want_path)))
    n_want = saved["leaves"]
    del init
    want = {"losses": losses, "grad_norms": norms, "step_s": secs,
            "counts": counts}
    torch.cuda.empty_cache()
    med = statistics.median(secs[1:])
    log(f"    losses {' '.join(f'{x:.6f}' for x in losses)}; step "
        f"{1e3 * med:.1f} ms (median of steps 2-{P18_STEPS}); launches "
        f"{counts['rsa_gemm']} RSA GEMM, {counts['flash_fwd']} / "
        f"{counts['flash_dq']} / {counts['flash_dkv']} flash fwd / dq / "
        f"dk-dv, {counts['plain_calls']} plain calls")

    log("  18b sharded step on a (1, 1) mesh over an NCCL group of one rank")
    store = ROOT / "build" / "p18_store"
    store.unlink(missing_ok=True)
    init_distributed("cuda", rank=0, world_size=1, store_path=str(store),
                     timeout_s=120)
    try:
        mesh = make_host_mesh(1, 1)
        smodel, sstep, sopt, (ps, _) = build_train_step(
            cfg, P18_LR, "cuda", mesh=mesh, global_batch=TRAIN_B)
        local = shard_tree(smodel.init(0), ps, mesh)
        local, _, slosses, snorms, ssecs, scounts = p18_steps(
            torch, sstep, local, sopt.init(local), cfg, every, mesh)
        full = gather_tree(local, ps, mesh)
        del local
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(full), tree_leaves(params)))
        del full, params
        torch.cuda.empty_cache()
        smed = statistics.median(ssecs[1:])
        kernels = ("rsa_gemm", "flash_fwd", "flash_dq", "flash_dkv")
        counts_same = all(scounts[k] == counts[k] > 0 for k in kernels)
        good = (same and slosses == losses and snorms == norms
                and counts_same and scounts["plain_calls"] == 0
                and counts["plain_calls"] == 0)
        ok &= good
        rep["world1"] = {
            "backend": dist.get_backend(), "mesh": [1, 1],
            "losses": slosses, "grad_norms": snorms, "step_s": ssecs,
            "counts": scounts, "bitwise_params": same,
            "losses_equal": slosses == losses, "counts_equal": counts_same,
            "median_step_s": smed, "unsharded_median_step_s": med,
            "overhead": smed / med - 1.0, "ok": good}
        rep["unsharded"] = want
        log(f"    losses {' '.join(f'{x:.6f}' for x in slosses)} "
            f"({'equal' if slosses == losses else 'DIFFERENT'}); params "
            f"{'bit for bit' if same else 'DIFFERENT'}; launches "
            f"{scounts['rsa_gemm']} / {scounts['flash_fwd']} / "
            f"{scounts['flash_dq']} / {scounts['flash_dkv']} "
            f"({'equal' if counts_same else 'DIFFERENT'}), "
            f"{scounts['plain_calls']} plain calls; step {1e3 * smed:.1f} ms "
            f"against {1e3 * med:.1f} ms unsharded: overhead "
            f"{100 * (smed / med - 1):+.2f}%: " + ("ok" if good else "FAIL"))

        log("  18c quantized_psum_tree over the group on a step's gradients")
        # step 0's gradient, from the init on step 0's batch
        leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                          smodel.init(0))
        toks = torch.from_numpy(p18_tokens(cfg, 0)).cuda()
        with torch.enable_grad(), dispatch.use(execute="kernel"):
            loss, _ = smodel.loss(leaves, {"tokens": toks})
            loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        del leaves, loss
        torch.cuda.synchronize()
        t1 = time.time()
        sums, errs = quantized_psum_tree(grads, None, 1)
        torch.cuda.synchronize()
        q_s = time.time() - t1
        exact = True
        n_el = 0
        for g, o, e in zip(tree_leaves(grads), tree_leaves(sums),
                           tree_leaves(errs)):
            s1 = torch.clamp(g.abs().max(), min=1e-20) / 127.0
            q = _quant(g, s1)
            s2 = torch.clamp(_dequant(q, s1).abs().max(), min=1e-20) / 127.0
            exact &= bool(torch.equal(o, _dequant(q, s2)))
            exact &= bool(torch.equal(e, g - _dequant(q, s1)))
            n_el += g.numel()
        del grads, sums, errs, g, o, e, q
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ok &= exact
        rep["quantized_psum"] = {"elements": n_el, "seconds": q_s,
                                 "exact": exact}
        log(f"    {n_el:,} gradient elements in {q_s:.3f} s: sums the int8 "
            f"round trips and residuals the differences "
            + ("exactly: ok" if exact else "NOT exactly: FAIL"))
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)

    log(f"  18g's one-device steps (step 1 each, the weights saved for the "
        f"ranks): " + ", ".join(f"{arch} cut to {layers} slots"
                               for _, arch, layers in P18G_RUNS))
    ones = {key: p18g_one_device(torch, key, p18g_cfg(arch, layers),
                                 want_path)
            for key, arch, layers in P18G_RUNS}
    ok &= all(o["counts"]["plain_calls"] == 0 for o in ones.values())

    world = P18_RANKS
    log(f"  18d {world} ranks on the one card: a ({world}, 1) mesh over gloo "
        f"with CUDA tensors, a row of the batch each; then 18f and 18g, the "
        f"same ranks on a (1, {world}) mesh under Megatron tp")
    store = ROOT / "build" / "p18_store2"
    store.unlink(missing_ok=True)
    outs = [ROOT / "build" / f"p18_rank{r}.json" for r in range(world)]
    for o in outs:
        o.unlink(missing_ok=True)
    t2 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--p18-rank", str(r),
         str(world), str(store), str(outs[r]), str(want_path)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(
                1.0, P18_RANK_DEADLINE_S - (time.time() - t2)))[0])
    except subprocess.TimeoutExpired:
        logs.append("deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    store.unlink(missing_ok=True)
    want_path.unlink(missing_ok=True)
    for key, _, _ in P18G_RUNS:
        Path(p18g_want(want_path, key)).unlink(missing_ok=True)
    wall2 = time.time() - t2
    recs = [json.loads(o.read_text()) if o.exists() else None for o in outs]
    good = ran = all(p.returncode == 0 for p in procs) and all(recs)
    if good:
        loss1_err = max(abs(r["losses"][0] - losses[0]) / abs(losses[0])
                        for r in recs)
        gn1_err = max(abs(r["grad_norms"][0] - norms[0]) / abs(norms[0])
                      for r in recs)
        # each leaf's share of its elements within the rule, over both
        # ranks' blocks; the least is gated
        share = {k: sum(r["leaves"][k]["within"] for r in recs)
                 / sum(r["leaves"][k]["n"] for r in recs)
                 for k in recs[0]["leaves"]}
        worst = min((v, k) for k, v in share.items())
        max_diff = max(v["max_diff"] for r in recs
                       for v in r["leaves"].values())
        n_leaves = {len(r["leaves"]) for r in recs}
        # each rank launches (a)'s kernels a step
        counts_same = all(r["counts"][k] * P18_STEPS ==
                          counts[k] * P18_RANK_STEPS for r in recs
                          for k in ("rsa_gemm", "flash_fwd", "flash_dq",
                                    "flash_dkv"))
        plain = sum(r["counts"]["plain_calls"] for r in recs)
        peak = max(r["peak_memory_gb"] for r in recs)
        peak_cap = P18_PEAK_BEFORE_GB["d"] - P18_PEAK_SAVING_GB
        good = (loss1_err <= 1e-5 and gn1_err <= 1e-4
                and worst[0] >= P18_LEAF_SHARE and n_leaves == {n_want}
                and counts_same and plain == 0 and peak <= peak_cap)
        rep["world2"] = {"backend": "gloo", "mesh": [world, 1],
                         "ranks": recs, "wall_s": wall2,
                         "step1_loss_rel_err": loss1_err,
                         "step1_grad_norm_rel_err": gn1_err,
                         "leaf_share": share,
                         "weights_worst_leaf": list(worst),
                         "weights_max_diff": max_diff,
                         "counts_equal": counts_same,
                         "peak_memory_gb": peak,
                         "peak_memory_cap_gb": peak_cap,
                         "step1_s": recs[0]["step_s"][0], "ok": good}
        log(f"    {wall2:.1f} s with the ranks' start; step 1's loss "
            f"{recs[0]['losses'][0]:.6f} (rel {loss1_err:.2e}, tol 1e-5), "
            f"grad norm {recs[0]['grad_norms'][0]:.4f} (rel {gn1_err:.2e}, "
            f"tol 1e-4); weights after step 1, each of {len(share)} leaves: "
            f"the share of its elements within the larger of 1e-4 of its "
            f"largest and 2e-3 of its travel, the least {100 * worst[0]:.3f}"
            f"% ({worst[1]}; tol {100 * P18_LEAF_SHARE:.1f}%), "
            f"{sum(v == 1.0 for v in share.values())} of them whole; largest "
            f"difference {max_diff:.2e} (lr {P18_LR:g}); each rank's "
            f"launches {recs[0]['counts']['rsa_gemm']} / "
            f"{recs[0]['counts']['flash_fwd']} / "
            f"{recs[0]['counts']['flash_dq']} / "
            f"{recs[0]['counts']['flash_dkv']} "
            f"({'(a)' if counts_same else 'NOT (a)'}'s a step), {plain} "
            f"plain calls; step 1 {1e3 * recs[0]['step_s'][0]:.1f} ms (rank "
            f"0, the first step); peak memory {peak:.2f} GB a rank (cap "
            f"{peak_cap:.1f}: {P18_PEAK_BEFORE_GB['d']} GB less "
            f"{P18_PEAK_SAVING_GB:g}): " + ("ok" if good else "FAIL"))
        for r in recs:
            log(f"    rank {r['rank']}: peak memory "
                f"{r['peak_memory_gb']:.2f} GB, gathered high-water "
                f"{r['gathered_high_gb']:.3f} GB, collectives moved "
                f"{r['moved_gb']:.3f} GB in step 1, step 1 "
                f"{1e3 * r['step_s'][0]:.1f} ms")
    else:
        rep["world2"] = {"returncodes": [p.returncode for p in procs],
                         "logs": [lg[-4000:] for lg in logs], "ok": False}
        log(f"    the ranks failed: return codes "
            f"{[p.returncode for p in procs]}")
        for lg in logs:
            log("    " + lg[-2000:].replace("\n", "\n    "))
    ok &= good
    ok &= p18_tp(rep, recs if ran else None, losses, norms, counts, n_want)
    ok &= p18_tpg(rep, recs if ran else None, ones,
                  report.get("p18g_gemm", []))
    ok &= p18_entry(rep, P18_MAIN_ARGS)
    rep["seconds"] = report["phase18_s"] = time.time() - t0
    within = rep["seconds"] <= P18_BUDGET_S
    ok &= within
    log(f"  phase 18 took {rep['seconds']:.1f} s (budget {P18_BUDGET_S:.0f} "
        f"s: {'within' if within else 'OVER'})")
    if not ok:
        log("  PHASE 18 FAIL")
    return ok


def kernel_table(report, gemm_keys, counts, ds_keys, train_keys, rw_keys,
                 sp_counts, sp_keys):
    """The JSON kernel line: one entry per kernel and main-path shape.
    ``counts`` holds each kernel's launches on the path that runs it
    (phase 4 for the GEMM, decode and prefill, phase 5 for the cascade
    kernels, phase 6 for the MLA kernels, phase 7 for the flash kernels,
    phase 8 for the WKV kernel, the one entry-point call of phase 3 for
    linear attention, phase 9's path A for ADAPTNETX); ``ds_keys`` phase
    6's GEMM launches by shape (its 2-D shapes and its banks),
    ``train_keys`` phase 7's, ``rw_keys`` phase 8's; ``sp_counts`` and
    ``sp_keys`` phase 10a's (the verify shape's prefill, the draft rounds'
    decode and the verify GEMMs at M = 40 get entries of their own)."""
    out = []
    sp = report["spec_path"]
    vrec = next(r for r in report["paged"] if r.get("case") == "spec verify")
    drec = next(r for r in report["paged"]
                if r["kernel"] == "paged_decode" and "ms" in r)
    for name, rec, launches, ms in (
            (f"paged_prefill[spec verify S=8 C={SPEC_K + 1}]", vrec,
             16 * sp["verify_calls"], vrec["case_ms"]),
            ("paged_decode[spec draft S=8]", drec, sp_counts["paged_decode"],
             drec["ms"])):
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": PAGED_TPU[rec["kernel"]], "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": ms,
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    for rec in report["spec_gemm"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm[spec verify {rec['M']}x{rec['K']}x{rec['N']} "
                 f"{rec['mode']}]", sp_keys.get(rec["key"], 0)))
    # ADAPTNETX at path A's shape: one query over the port's 135 classes
    ax = [r for r in report["adaptnetx"] if r["C"] == 135]
    one = next(r for r in ax if r["case"] == "[123,4567,8910]")
    path_a = max(lay["logits_max_abs_err"]
                 for lay in report["selfadaptive_gemm"]["layers"])
    out.append({
        "name": "adaptnetx[C=135 B=1]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adaptnetx.cu",
        "replaces": ADAPTNETX_TPU, "launches": counts["adaptnetx"],
        "max_abs_err": max([r["max_abs_err"] for r in ax] + [path_a]),
        "ms": one["ms"], "plain_ms": one["plain_ms"],
        "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
        "library_ms": None})
    # phase 11: the batched ADAPTNETX query of the bert workload (C = 108,
    # B = 72) and each SaraDispatcher.gemm shape
    sg = report["sagar"]
    bert = next(r for r in sg["adaptnetx"] if r["workload"] == "bert_base")
    out.append({
        "name": f"adaptnetx[C=108 B={bert['B']} sagar]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adaptnetx.cu",
        "replaces": ADAPTNETX_TPU, "launches": sg["counts"]["adaptnetx"],
        "max_abs_err": max(r["max_abs_err"] for r in sg["adaptnetx"]),
        "ms": bert["ms"], "plain_ms": bert["plain_ms"],
        "bound_ms": bert["bound_ms"], "bound_by": bert["bound_by"],
        "library_ms": None})
    for rec in sg["gemms"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm[sara.gemm {rec['M']}x{rec['K']}x{rec['N']} "
                 f"{rec['mode']} {rec['dtype']}]",
            rec["launched"]["rsa_gemm"]))
    launches = dict(report["rwkv_path"]["wkv_launches"],
                    main=counts["linear_attn"],
                    train=report["p14"]["14c"]["counts"]["wkv_bshk"])
    for rec in report["wkv"]:
        if "ms" not in rec or rec["case"] not in launches:
            continue
        shape = (f"B={rec['B']} S={rec['S']}" if "B" in rec else
                 f"BH={rec['BH']} S={rec['S']}")
        out.append({
            "name": f"{rec['kernel']}[{rec['case']} {shape} chunk "
                    f"{rec['chunk']}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/linear_attn.cu",
            "replaces": LINEAR_TPU[rec["kernel"]],
            "launches": launches[rec["case"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    for rec in report["rwkv_gemm"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm[rwkv6 {rec['M']}x{rec['K']}x{rec['N']} "
                 f"{rec['mode']}]", rw_keys.get(rec["key"], 0)))
    for rec in report["flash"]:
        if not rec["main"]:
            continue
        for name, t in rec["timed"].items():
            out.append({
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
                "replaces": FLASH_TPU[name], "launches": counts[name],
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]})
    for rec in report["train_gemm"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm[train {rec['site']} {rec['pass']} {rec['M']}x"
                 f"{rec['K']}x{rec['N']} {rec['mode']} f32]",
            train_keys.get(rec["key"], 0)))
    for rec in report["ds_gemm"]:
        out.append(gemm_entry(
            rec, f"rsa_gemm[deepseek {rec['M']}x{rec['K']}x{rec['N']} "
                 f"{rec['mode']}]", ds_keys.get(rec["key"], 0)))
    for rec in report["bank"]:
        if rec.get("recommended") and rec["path"] == "6":
            out.append(gemm_entry(
                rec, f"rsa_gemm_bank[{rec['site']} {rec['E']}x({rec['M']}x"
                     f"{rec['K']}x{rec['N']}) {rec['mode']}]",
                ds_keys.get(rec["key"], 0)))
    for rec in report["mla"]:
        if "ms" not in rec:
            continue
        out.append({
            "name": rec["kernel"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_mla.cu",
            "replaces": MLA_TPU[rec["kernel"]],
            "launches": counts[rec["kernel"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    for rec in report["gemm"]:
        if rec.get("recommended"):
            out.append(gemm_entry(
                rec, f"rsa_gemm[{rec['site']} {rec['M']}x{rec['K']}x"
                     f"{rec['N']} {rec['mode']}]",
                gemm_keys.get(rec["key"], 0)))
    out += p13_table(report)
    out += p14_table(report)
    out += p15_table(report)
    out += p18_table(report)
    for rec in report["paged"]:
        if "ms" not in rec or rec.get("case") in P13_PAGED:
            continue
        out.append({
            "name": rec["kernel"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": PAGED_TPU[rec["kernel"]],
            "launches": counts[rec["kernel"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        log("chip_smoke: src/repro_torch not found beside this script; run "
            "it from a checkout of the repository")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES
    from repro_torch.core.hw import H100
    PEAK_BF16_FLOPS, PEAK_F32_FLOPS = H100.peak_bf16_flops, \
        H100.peak_f32_flops
    PEAK_BYTES = H100.hbm_bw
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this smoke "
            "test needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"gemm": [], "paged": [], "bank": [], "mla": [], "flash": [],
              "train_gemm": [], "wkv": [], "rwkv_gemm": [], "adaptnetx": []}
    t_start = time.time()

    log("== 1. environment")
    smi = nvidia_smi_line()
    nvcc_path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_v = subprocess.run([nvcc_path, "--version"], capture_output=True,
                            text=True).stdout.strip().splitlines()
    report["env"] = {"python": sys.version.split()[0],
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "nvcc": nvcc_v[-1] if nvcc_v else "not found",
                     "device": torch.cuda.get_device_name(0),
                     "nvidia_smi": smi}
    for k, v in report["env"].items():
        log(f"  {k}: {v}")

    log("== 2. build")
    from repro_torch.kernels import _build
    paths = _build.build_all()
    report["build_s"] = _build.build_seconds
    log(f"  built in {_build.build_seconds:.1f} s: "
        f"{', '.join(p.name for p in paths.values())}")
    for p in paths.values():
        logf = p.with_suffix(".log")
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {p.stem.split('-')[0]}: {line.strip()}")

    log("== 3. kernels against their plain versions (tolerances stated)")
    from repro_torch import dispatch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.sara import SaraDispatcher
    cfg = get_arch("llama3.2-1b")
    dcfg = deepseek_cfg()
    dispatcher = SaraDispatcher()
    timer = Timer(torch)
    with dispatch.use(execute="kernel"):
        ok = check_gemms(torch, report, timer, cfg, dispatcher)
        ok &= check_paged(torch, report, timer, cfg)
        ok &= check_cascade(torch, report, timer, cfg)
        ok &= check_mla(torch, report, timer, dcfg)
        ok &= check_banks(torch, report, timer, dcfg, dispatcher)
        ok &= check_flash(torch, report, timer, cfg)
        ok &= check_train_gemms(torch, report, cfg, dispatcher)
        ok &= check_wkv(torch, report, timer, get_arch("rwkv6-1.6b"))
        ok &= check_adaptnetx(torch, report, timer)
        ok &= check_p13_kernels(torch, report, timer, dispatcher)
        ok &= check_p14_kernels(torch, report, timer, dispatcher)
        ok &= check_p15_kernels(torch, report, timer, dispatcher)
        ok &= check_p18f_kernels(torch, report, timer, dispatcher)
        ok &= check_p18g_kernels(torch, report, timer, dispatcher)
    torch.cuda.empty_cache()
    log(f"  kernels {'ok' if ok else 'FAIL'} "
        f"({time.time() - t_start:.1f} s so far)")

    log("== 4. main path: llama3.2-1b full width, continuous batching")
    mp_ok, gemm_keys, counts = main_path(torch, report)
    ok &= mp_ok
    time_breakdown(report, "main_path", gemm_keys, counts)

    log("== 5. cascade path: prefix cache + cascade decode, llama3.2-1b full "
        "width")
    cp_ok, cp_counts, cp_keys = cascade_path(torch, report)
    ok &= cp_ok
    time_breakdown(report, "cascade_path", cp_keys, cp_counts)
    torch.cuda.empty_cache()

    log("== 6. deepseek-v3 path: absorbed MLA + MoE at full width, depth "
        "cut to 1 dense + 1 MoE layer")
    ds_ok, ds_counts, ds_keys = deepseek_path(torch, report, timer,
                                              dispatcher)
    ok &= ds_ok
    deepseek_breakdown(report, ds_keys, ds_counts)
    torch.cuda.empty_cache()

    log("== 7. training path: llama3.2-1b full width, f32, flash attention,"
        f" {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens")
    tr_ok, tr_counts, tr_keys = train_path(torch, report)
    ok &= tr_ok
    train_breakdown(report, tr_keys, tr_counts)
    torch.cuda.empty_cache()

    log("== 8. rwkv6-1.6b path: RWKV6 at full width (no depth cut), WKV "
        "kernel, dense slot layout")
    rw_ok, rw_counts, rw_keys, rw_pre = rwkv_path(torch, report, timer,
                                                 dispatcher)
    ok &= rw_ok
    rwkv_breakdown(report, rw_keys, rw_counts, rw_pre)
    torch.cuda.empty_cache()

    log("== 9. self-adaptive paths: (A) ADAPTNET-TPU trained, ADAPTNETX "
        "picks each GEMM's tile; (B) adaptnet-mode serving, llama3.2-1b full "
        "width")
    t9 = time.time()
    sa_ok, sa_counts = selfadaptive_gemm_path(torch, report, timer)
    ok &= sa_ok
    ok &= adaptnet_serving_path(torch, report)
    report["phase9_s"] = time.time() - t9
    log(f"  phase 9 took {report['phase9_s']:.1f} s")
    torch.cuda.empty_cache()

    log(f"== 10. speculative decoding: (a) llama3.2-1b full width, self "
        f"draft, k = {SPEC_K}; (b) the reference's test pair, reduced, f32")
    t10 = time.time()
    sp_ok, sp_counts, sp_keys = spec_path(torch, report, timer, dispatcher)
    ok &= sp_ok
    spec_breakdown(report, sp_keys)
    ok &= spec_reduced(torch, report)
    report["phase10_s"] = time.time() - t10
    log(f"  phase 10 took {report['phase10_s']:.1f} s")
    torch.cuda.empty_cache()

    log("== 11. the SAGAR path: ADAPTNET on the paper's RSA configuration "
        "space (2^12-2^14 MACs), Fig. 7e, ADAPTNETX on the Table-IV "
        "workloads, SaraDispatcher.gemm")
    t11 = time.time()
    ok &= sagar_path(torch, report, timer)
    report["phase11_s"] = time.time() - t11
    log(f"  phase 11 took {report['phase11_s']:.1f} s")
    torch.cuda.empty_cache()

    log("== 12. observability and fault tolerance on the main path: (a) "
        "trace + sanitizer, (b) chaos, (c) kill and resume")
    t12 = time.time()
    ok &= obs_path(torch, report)
    report["phase12_s"] = time.time() - t12
    log(f"  phase 12 took {report['phase12_s']:.1f} s")
    torch.cuda.empty_cache()

    log("== 13. every attention family on every KV layout: (a) qwen2-moe-"
        "a2.7b, (b) gemma-2b, (c) deepseek-coder-33b and command-r-plus-104b"
        " (2 layers each), paged with chunks of 64; (d) llama3.2-1b dense "
        "and paged with bucketed prefill; (e) seamless-m4t-medium (encdec, "
        "flash encoder); (f) internvl2-76b (vlm, 2 layers), bucketed prefill"
        " and paged decode")
    ok &= p13_all(torch, report, timer)
    ok &= p13_gemms(torch, report, timer, dispatcher)
    log(f"  phase 13 took {report['phase13_s']:.1f} s")
    torch.cuda.empty_cache()

    log(f"== 14. the recurrent families: (a) zamba2-7b served at full width "
        f"(81 slots, no depth cut), dense slot layout; (b) zamba2-7b trained"
        f", cut to {P14_TRAIN_SLOTS} slots; (c) rwkv6-1.6b trained, no cut")
    ok &= p14_all(torch, report, timer)
    log(f"  phase 14 took {report['phase14_s']:.1f} s")
    torch.cuda.empty_cache()

    log(f"== 15. the other families trained, f32, {TRAIN_STEPS} steps of "
        f"{TRAIN_B} x {TRAIN_S} tokens: (a) gemma-2b cut to 6 layers (hd "
        f"256), (b) qwen2-moe-a2.7b cut to 1 layer, (c) seamless-m4t-medium"
        f" uncut, (d) deepseek-v3-671b and internvl2-76b at the reduced "
        f"preset")
    ok &= p15_all(torch, report)
    log(f"  phase 15 took {report['phase15_s']:.1f} s")
    torch.cuda.empty_cache()

    log("== 16. the step tooling: profile_cell on llama3.2-1b's train_4k, "
        "prefill_32k and decode_32k (full width, optimized profile, batch 1)"
        "; the dry-run's meta sweep; the wave baseline")
    ok &= p16_all(torch, report)
    torch.cuda.empty_cache()

    log("== 17. the example drivers: saralint over the port; quickstart, "
        "serve_requests and train_lm (100m, a simulated preemption) through "
        "examples/torch")
    ok &= p17_all(torch, report)
    torch.cuda.empty_cache()

    log(f"== 18. the distribution layer: llama3.2-1b's sharded train step "
        f"at full width, f32, dp_all, {P18_STEPS} steps of {TRAIN_B} x "
        f"{TRAIN_S}: (a) unsharded, (b) a (1, 1) mesh over NCCL, (c) "
        f"quantized_psum_tree over it, (d) 2 ranks on the one card over "
        f"gloo, (e) the train entry point under torchrun, (f) Megatron tp "
        f"on a (1, 2) mesh, (g) rwkv6-1.6b (4 of 24 layers) and zamba2-7b "
        f"(7 of 81 slots) under it at full width")
    ok &= p18_all(torch, report)
    log("== the RSA GEMM's modes against their library calls")
    mode_summary(report)
    la = next(r for r in report["wkv"] if r["kernel"] == "linear_attn")
    counts = dict(counts, paged_decode_lse=cp_counts["paged_decode_lse"],
                  paged_prefix=cp_counts["paged_prefix"],
                  paged_mla_decode=ds_counts["paged_mla_decode"],
                  paged_mla_prefill=ds_counts["paged_mla_prefill"],
                  flash_fwd=tr_counts["flash_fwd"],
                  flash_dq=tr_counts["flash_dq"],
                  flash_dkv=tr_counts["flash_dkv"],
                  wkv_bshk=rw_counts["wkv_bshk"],
                  linear_attn=la["entry_point_launches"],
                  adaptnetx=sa_counts["adaptnetx"])

    report["ok"] = bool(ok)
    report["seconds"] = time.time() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    if not ok:
        log(f"chip_smoke: FAILED after {report['seconds']:.1f} s")
        return 1
    log(f"== done in {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernel_table(report, gemm_keys, counts,
                                              ds_keys, tr_keys, rw_keys,
                                              sp_counts, sp_keys)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 7 and sys.argv[1] == "--p18-rank":
        sys.exit(p18_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                               *sys.argv[4:7]))
    sys.exit(main())
