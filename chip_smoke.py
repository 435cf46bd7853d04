#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n-tables 20000] [--seed 0]
    python3 chip_smoke.py --only families_mesh[,serve_mesh,long_mesh,...]   # mesh phases alone

Phases, each printing one JSON line:

1. environment — the card, ``torch.version.cuda``, nvcc's release, and the
   seconds the kernel build took (one nvcc per source, all four in
   parallel), then each library's ``ptxas`` registers and spills;
2. kernels — each hand-written kernel runs on the card at the shapes its
   path gives it at scale and is held against its plain PyTorch version on
   the same inputs: B.2 gather_filter_table_counts (512 and 128 bits, a
   lane prefix, and the main path's shapes: q = 30, a block-diagonal q =
   240, q = 300, no elig), B.1 filter_table_counts (its headline shapes,
   then at 128 bits the same main-path shapes, 'any' over one and two query
   tiles, phantom columns past n_queries, padding rows with seg = -1; table
   and key counts), B.3 xash_superkey (the corpus's values and rows, then
   edge inputs at 128/256/512 bits under all 8 combinations of the ablation
   flags: one character repeated over the full width, all 37 characters,
   codes above 37, empty cells inside rows, n not a multiple of the block,
   the main path's query-key shape [30, 3, 48], widths of 20 and 80 bytes,
   and more picks than the kernel keeps in registers), B.4
   filter_match and B.5 filter_count exactly (integer outputs: max_abs_err
   must be 0) at 512 and 128 bits, then at every combination of the edge
   shapes ``EDGE_N`` x ``EDGE_Q`` x ``EDGE_LANES`` (with all-ones and zero
   rows, an all-zero and an all-ones query) and B.4 with n·q past 2^31;
   B.6 flash_attention at qwen1.5-0.5b's prefill shape
   [4, 2048, 16, 64] in bf16, causal and with a 512 window, ragged
   S = T = 1,000, strided views of one fused QKV projection, d 128 with
   dv 64, S != T (max_abs_err < 2e-2), and at [2, 512, 2, d 128, dv 64] in
   f32 (< 1e-5); B.2 over the 1-, 2-, 3-, 5-, 7- and 13-lane prefixes
   of its 16-lane store beside 4, 8 and 16, exactly (the ``lanes`` line
   reports them); B.6 at MLA's head dims, [2, 512, 4, d 192, dv 128] and
   [2, 512, 4, d 24, dv 16], and at [2, 512, 4, d 20, dv 12] (padded to
   multiples of 8 by the wrapper), causal and windowed, bf16 and f32, then
   non-causal at the families' ragged lengths — whisper's encoder (S = T =
   1500, d 64, H 8), llama-3.2-vision's cross-attention (S 512 and 2048 ×
   T = 1601 patches, d 128, H 32) and whisper's cross-attention (S 256 × T
   1500) — with ``ptxas``'s report of the d-192 kernels (the
   ``flash_edge`` line).
   CUDA-event times of kernel and plain version, the bound
   (the least time the card could take: the larger of bytes over 3.35 TB/s
   and the operations this run's data needs over the peak rate of their
   type — 67 T op/s for 32-bit integer and float32, 989 TFLOP/s for bf16
   tensor cores; ``flash_work``, ``gather_bytes``, ``counts_work``,
   ``match_work``, ``count_work`` and ``xash_work`` count them), and for B.6
   the time of ``scaled_dot_product_attention`` on the same inputs
   (``library_ms``; the port never calls it); then the ``flash_grad`` line:
   B.6 under autograd (the forward kernel with its row log-sum-exp, then
   the backward kernels of ``flash_attention_bwd.cu`` through
   ``flash_attention_backward``) at qwen1.5-0.5b's training shape [8,
   2048, 16, 64], MLA's d 192 / dv 128 and whisper's non-causal S 256 × T
   1500, then at its edges (``FLASH_GRAD_EDGE``: a window, T = 1601, rows
   that admit no key, fused-QKV views, d 100), bf16 and f32: dq, dk and dv
   against the backward's plain version on the card and against autograd
   through the plain forward, on float32 copies (‖Δ‖/‖ref‖ <= 1e-2 /
   1e-5), finite, three calls bit-equal, one launch of each kernel per
   autograd call, with the forward's, the backward's (bound:
   ``flash_bwd_work``), the plain backward's and SDPA's backward and
   forward + backward times (``kernel_to_library``: the backward's over
   SDPA's), the backward's ``ptxas`` report (and any "serialized" line);
   the backward's row of the ``kernels`` line (its first shape, bf16;
   ``launches`` from the train path);
3. main path — ``synthetic.make_corpus`` → ``MateSession.build`` (default
   ``DiscoveryConfig``: 128 bits, rank='quality', profile gate on, backend
   resolved on CUDA to 'fused-gather') → ``discover`` on ground-truth
   queries and one ``discover_many`` group, every result held identical
   under 'fused-gather', 'fused', 'pallas' and 'numpy' and against the
   brute-force oracle, then one §5.4 ``update_cell`` and one more
   ``discover``; the ``main_path`` line gives histograms of the shapes
   of its B.2 and B.4 launches (candidate rows, query keys, lanes) and of
   its B.3 launches (rows, cells per row, lanes);
4. ops path — ``ops.filter_count`` over the session's superkeys against the
   ground-truth queries' keys, equal to the column sums of the match matrix
   (``ops.filter_match_auto`` on the 'pallas' backend, kernel B.4), then
   B.5 timed at that shape beside its plain version and its bound; and the
   C.5 wrappers: ``ops.superkey`` (B.3) over those keys, equal to the
   index's key superkeys, ``ops.xash_values`` (B.3) over the lake's unique
   values, equal to the build's value lanes, ``ops.filter_match`` (B.4)
   over the superkeys × the keys, summing to the B.5 counts, each timed
   beside its plain version on the same CUDA inputs;
5. lanes — ``plan_and_count`` at ``filter_lanes`` 1, 2, 3 (the 128-bit
   session) and 5 (a 256-bit session of the same lake) under
   'fused-gather', for the ground-truth group (B.2) and the mixed group
   (demoted to B.4), exactly equal to 'numpy'; ``discover_many`` likewise
   for the ground-truth group at every prefix and the mixed group at 5;
6. fd — ``MateSession.discover_fds`` on the smoke lake (each ground-truth
   query given a second dependent value for its key 2) and on the
   planted-FD lakes at 128/256/512 bits, under 'fused-gather', 'fused' and
   'numpy', signals off and on: identical verdicts, equal to a brute-force
   oracle;
7. routed — the routed lake on the same lake:
   ``MateSession.build(distributed=True, n_shards=4)`` at 128 bits beside a
   single-host session built from the same corpus; ``discover`` of the
   ground-truth queries under 'fused-gather', 'fused', 'pallas' and
   'numpy', ``discover_many`` of the ground-truth and the mixed group (past
   the fused kernels' table cap: kernel B.4 once per shard, timed), the FD
   queries of phase 6 and a 16-request ``DiscoveryEngine`` stream, every
   answer equal to the single-host session's and timed beside it; the
   routed accounting (``route_bytes_merged`` = Σ shard launches × tables ×
   4) checked; ``build_index(n_shards=4)`` byte-identical to the
   single-host build; the mesh mode: 2 ranks spawned on the one card over
   gloo, each building the routed session across the group (B.3 on its
   value block, ``all_gather``) and launching B.2 (B.4 past the cap) over
   its own shard on the card, the all-reduced counts equal to host-routed;
   then an ``update_cell`` on shard 1 that moves that shard's epoch and
   store only;
8. serving tier — a ``DiscoveryEngine`` and then an
   ``AsyncDiscoveryEngine`` on a ManualClock over a 512-bit session of the
   lake that degrades to 128 bits: 64 requests in bursts (shed, degraded,
   result- and bound-cache hits, deadline flushes), every answer equal to
   a cold ``discover``, B.2 probing 16 and 4 lanes of the 16-lane store;
   then a spike of 24 mixed queries alone on a fresh engine (16 admitted,
   8 degraded), timed per group;
9. serve — full-width qwen1.5-0.5b (24 layers, random weights from
   ``--seed``) serves 8 requests (prompts of 512–2048 tokens drawn from
   ``--seed``, 32 new tokens each) in slot batches of 4, twice (greedy: the
   tokens must repeat), holds prefill and decode against the full forward
   at 1, 2, 6, 12 and 24 layers of the same weights (all logits finite;
   prefill within 0.05 of max|logit| at every depth, decode at 1 and 2
   layers, the reference test's depth), beside the gap that one weight
   moved by one bf16 ulp makes in the forward at that depth, then runs the
   port's ``launch.serve.main`` at its defaults;
10. families — the other LM families at their published widths, one at a
   time (``FAMILIES``: qwen2-moe 24 of 24 layers, mamba2 48 of 48,
   llama-3.2-vision 40 of 40, whisper 6 + 6, jamba 8 of 32 — one block —
   and deepseek-v3 4 of 61 with its MTP module built; depth cut only where
   one card cannot hold the weights), random weights from ``--seed``: 4
   requests in one slot group of 4 (prompts of 512–2048 tokens for
   qwen2-moe, 64–256 for whisper, 256–1024 for the rest, the longest a
   multiple of 64 so that MoE's 256-token groups divide B·S), 16 new
   tokens, generated twice (greedy must repeat) with the stub frontends'
   frames / patches; B.6 launches per prefill held to the table; every
   logit of one more prefill and decode step finite; prefill/decode
   consistency on the first 1 and 2 layers or blocks (``family_cut``,
   ``family_consistency``); then ``launch.serve.main`` at full width for
   qwen2-moe and with ``--smoke`` for all six;
11. train — ``repro_torch.launch.train.main`` at full-width qwen1.5-0.5b
   (``TRAIN_ARGV``: [8, 2048] ``TokenPipeline`` batches, AdamW, remat,
   chunked CE, random weights from ``--seed``), ``TRAIN_STEPS`` steps with a
   checkpoint at ``TRAIN_RESUME_AT``, then the same command resumed from
   it, then ``TRAIN_FALL_STEPS`` steps from a step-0 checkpoint of the same
   draw with its attention projections rescaled (``conditioned``): every
   parameter leaf with a finite, nonzero gradient after step 1, the first
   loss within 0.5 of ln(vocab), 2 B.6 launches per attention layer per
   step (the forward and the remat recompute), the resumed losses equal to
   the uninterrupted run's within 1e-3, the conditioned run's loss falling
   by ``TRAIN_LOSS_FALL``; then one float32 step at 2 layers through B.6
   against the same step with the plain attention (loss and
   attention-weight gradients within 1e-3); then 3 steps under each of the
   block's other remat policies (``transformer.REMAT_POLICY`` 'dots' and
   'none') from the conditioned draw, with that run's settings and
   batches: losses and gradient norms equal to its first 3 steps' within
   1e-6, B.6 launches 2 / 1 per attention layer a step; in every step of
   every run one backward launch per attention layer; ms per step,
   tokens/s, peak GB (per policy too), the gradient norms and the
   attention backward's share of the step;
11b. train_mesh — ``launch.train``'s ``--mesh 2x2`` run (its rank body,
   ``_rank``) at qwen1.5-0.5b's published widths, cut to 6 of its 24
   layers (``--layers``, as ``families`` cuts jamba and deepseek-v3)
   (``TRAIN_MESH``: 4 gloo ranks on the one card, FSDP over 'data' with
   each block's weights gathered inside the block, tensor parallel over
   'model', [8, 512] batches, 4 steps, a checkpoint every 2), then in the
   same ranks the same run under sequence parallelism
   (``layers.SEQ_SHARD``), beside ``--mesh 1x1`` (in a process of its
   own beside the lake's draw), all from one step-0 checkpoint of the
   driver's draw with its attention projections rescaled, then ``--mesh
   1x1`` resumed from the mesh run's step-2 checkpoint; with int8 moments
   (replicated, each updated whole), 2 steps at 1x1 from a step-0
   checkpoint of the same draw (beside the lake's draw too) and, in the
   same ranks, 2x2 resumed from its step-1 checkpoint for the last step:
   parameters and moments on the card on every rank, 2 B.6 launches per
   rank, layer and step at [4, 512, 8, 64] in the three mesh runs, the
   first step's loss and gradient norm of each within 2e-2 of 1x1's same
   step, the sequence-parallel losses and the resumed losses within 2e-2
   of the mesh run's, the int8 moments after the last step within 2e-2 of
   1x1's (their gap in quantisation steps printed); ms per step, tokens/s,
   peak GB, the
   most gathered weights alive at once, the collectives by kind and their
   share per rank and run; its ranks are those of 11d–11f (one spawn,
   below; ``launch.train.run``'s own spawn for ``--mesh`` is driven by
   the CPU tests only);
11c. pipeline — ``train.pipeline.pipeline_loss_fn`` at full-width
   qwen1.5-0.5b over 2 gloo ranks (one stage of 12 layers each), [8, 512]
   in 4 microbatches, ``loss.backward()`` on both: the loss within 1e-2 of
   the un-pipelined chunked CE on the same weights, every gradient finite
   and every used leaf's nonzero, 96 B.6 launches per rank;
11d. serve_mesh — prefill and decode over a mesh: qwen1.5-0.5b at 2x2 (its
   16 KV heads split over 'model') and starcoder2-3b at 1x4 (its 2 KV heads
   leave the cache's slots split over 'model', merged by flash-decoding),
   both at their published widths cut to 6 layers, 4 gloo ranks on the
   one card, weights from ``--seed`` with the attention projections
   rescaled, one configuration after the other: 4 prompts of 512 tokens
   and 16 decode steps of the 1x1 run's greedy tokens, every step's logits
   within 0.05 of max|logit| of the 1x1 run in this process, B.6 launches
   per rank per prefill equal to the layers kept, every cache leaf on
   cuda:0 at its local shape; qwen1.5-0.5b's prefill once more under
   sequence parallelism and 4 decode steps from its cache, held the same
   way; prefill and decode ms per rank and the collectives' share
   printed;
11e. families_mesh — tensor and expert parallelism for every family
   beside the dense decoders (``FAMILIES_MESH``), each at its published
   widths cut to the fewest layers that hold every kind of its sublayers:
   qwen2-moe 1 MoE layer at 2x2 (30 of 60 experts a rank),
   llama-3.2-vision a [self, cross] block at 2x2, whisper whole (6 + 6) at
   2x2, deepseek-v3 1 dense + 1 MoE layer with its MTP module at 1x4 (64 of
   256 experts and 32 of 128 heads a rank), mamba2 2 layers at 2x2 (32 of
   64 SSM heads a rank, 2176 conv channels against 2048 of x), jamba one
   block of (SSM, MLP) and (attention, MoE) at 1x4 (4 of 16 experts and 2
   of 8 KV heads a rank); the 1x1 runs in a process of their own first,
   then 4 gloo ranks on the card, one group after another, each rank
   drawing its shards leaf by leaf (deepseek-v3's ranks in turns): 4
   prompts of 128 tokens (mamba2: 512, past its 256-token SSD chunk) and 8
   decode steps of the 1x1 run's greedy tokens in float32 (the bf16 draw's
   values) within 0.05 of max|logit|, then in bf16 3 training steps of [4,
   128] ([4, 512]; deepseek-v3: one forward and backward, no AdamW) with
   the first step's loss and gradient norm within 2e-2 of 1x1's, B.6
   launches per rank per prefill as planned, every cache leaf (the SSM's
   'h' and 'conv' too) at its shard's shape, E/M experts a rank; jamba's
   prefill once more and one gradient step under sequence parallelism,
   held the same way; per rank the draw, prefill, decode and step times,
   the collectives' share and peak GB printed, and the card's memory in
   use by every process beside each 1x1 run;
11f. long_mesh — serving at a batch the data axis does not divide
   (``LONG_MESH``): h2o-danube (2 of 24 layers) and jamba (one block of
   (SSM, MLP) and (attention, MoE)) at their published widths on the 2x2
   grid, batch 1, so every rank holds the row (the reference's
   replication): a prompt of 128 tokens into a cache of 524,288 slots
   (h2o-danube's 4096-slot ring), the slots past it filled from a seeded
   draw at the prefill's own K/V scale as if the prompt had run to
   position 524,280 (``long_fill``; the ring in its pos % 4096 layout,
   the SSM state as the prefill left it), then 8 decode steps of the 1x1
   run's greedy tokens, float32, within 0.05 of max|logit| of 1x1 (run
   in the families' side process after theirs); B.6 launches per rank
   per prefill 2 / 1, every cache leaf at its shard's shape; each decode
   step's collectives by kind, per rank the decode ms and the card's
   memory in use, the 1x1 run's beside them; 11b's runs and 11d's, 11e's
   and 11f's groups run in one spawn of 4 ranks (``mesh_phase``, with
   ``--only`` too when several are asked for), which start and warm up
   once, and the timeline gives the four phases' seconds together;
11g. dryrun — ``repro_torch.launch.dryrun``'s ``main`` (qwen1.5-0.5b's four
   shapes at 16x16, its prefill_32k and train_4k with ``seq_shard=true``
   and its train_4k with ``remat_policy`` 'dots' and 'none' and with
   ``state_dtype=int8``, qwen3-32b's train_4k at both meshes; train_4k and
   decode_32k of qwen2-moe, whisper, llama-3.2-vision, deepseek-v3, mamba2
   and jamba at 16x16, deepseek-v3's train_4k at 2x16x16, and the
   long_500k cells of mamba2, h2o-danube and jamba, whose batch of 1 the
   16 data ranks do not divide: their cache argument bytes printed beside
   their K/V shards' 1.47 MB and 33.6 MB a device) and
   ``repro_torch.launch.dryrun_mate``'s (filter_1g, broadcast, the sharded
   build on 4 gloo ranks on the card) in subprocesses, the tracing ones
   started before the kernel build at a lower priority, ``dryrun_mate``
   right after it (they run on the host while the build runs and phase 1
   draws the lake) and collected here: each cell rank 0's program traced
   on fake CUDA tensors at the production mesh, no kernel launched, the
   build byte-identical; per cell the planned FLOPs per device, argument /
   temp GB and collective MB by kind (plans for an H100 cluster, not
   timings), the train_4k cells' temp GB beside those of the whole-tree
   gather;
12. driver — ``repro_torch.launch.discovery.main`` in this process at the
   same lake (its tables reused from phase 1's draw, copied before any
   planting) with ``DRIVER_ARGV``: 4 mixed queries of 20 rows, FDs, the
   serving caches, a 4-shard routed lake, the build across 2 spawned ranks
   and the row filter over a 2x2 grid of ranks (``--mesh 2x2``: the rows
   over 'data', replicated over 'model'; gloo on the one card); its
   printed lines parsed and held (engine sets identical, routed
   bit-identical, every request served and replayed from the cache, the
   2-rank build byte-identical, each of the 4 filter ranks' counts equal
   to ``ops.filter_hits_table_counts`` on the card for the same keys);
13. conformance — ``tests/test_conformance.py``'s scenario on the card:
   every backend of the port's registry × 128/256/512 bits exactly equal to
   'numpy' on ``discover_batched``, ``discover_many``, ``plan_and_count`` +
   ``score_from_counts`` and ``discover_fds``, fused backends with no match
   matrix;
14. examples — each ``examples/torch_*.py`` twin at its defaults on the
   card, exit 0, its lines equal to its ``--device cpu`` run's (times,
   rates, sampled tokens, losses and backend names masked).

Launch counters are zeroed just before each path's own calls (3–14) and
read just after; index builds of paths 5, 6, 8 and 12, their references and
their checks (numpy backends, full-width runs, cold ``discover``s, the serve
and families phases' consistency checks and finite-logit prefills, the
examples' CPU reruns) run outside those
windows (the driver's and the examples' own builds are part of their runs
and are counted).  Each kernel must
have launched on its path.  Then the ``kernels`` summary line (each
kernel's ``launches`` on its own path — the main path for B.1–B.4, the ops
path for B.5, the serve path for B.6 (the families, train, train_mesh,
pipeline, serve_mesh, families_mesh and long_mesh paths beside it; the
mesh phases' spawned ranks report their own launches) — and
``launches_by_path``, every
path's own count; the driver's spawned ranks report their launches in the
``driver`` line), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any mismatch
raises and the script exits non-zero without the last line.  It needs a
CUDA device and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT32_OPS_PER_S = 67e12  # H100 SXM 32-bit peak outside the tensor cores
FP32_FLOPS_PER_S = 67e12  # the same units on float32
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores

# kernel phase: the main path's shapes at the device-store budget
LOG_STORE = 25  # 2^25 rows x 16 lanes = a 2 GiB superkey store
LOG_N = 20  # candidate rows per launch
N_KEYS = 256  # query keys per launch
N_TABLES = 8192  # tables per launch (the fused kernels' cap)
REPS = 10  # timed launches per kernel
# main path: planted ground-truth queries, and one discover_many group
N_TRUTH = 4
GROUP = 8
# B.6 shapes, all causal: (B, S, T, H, d, dv, window, dtype, tolerance,
# q/k/v as views of one fused [B, S, 3·H·d] projection, the row
# log-sum-exp written too as under autograd)
FLASH_SHAPES = [
    (4, 2048, 2048, 16, 64, 64, 0, torch.bfloat16, 2e-2, False, False),  # qwen1.5-0.5b prefill
    (8, 2048, 2048, 16, 64, 64, 0, torch.bfloat16, 2e-2, False, True),  # its training forward
    (4, 2048, 2048, 16, 64, 64, 512, torch.bfloat16, 2e-2, False, False),
    (2, 512, 512, 2, 128, 64, 0, torch.float32, 1e-5, False, False),
    (4, 1000, 1000, 16, 64, 64, 0, torch.bfloat16, 2e-2, False, False),  # ragged
    (4, 2048, 2048, 16, 64, 64, 0, torch.bfloat16, 2e-2, True, False),  # fused projection
    (4, 2048, 2048, 16, 128, 64, 0, torch.bfloat16, 2e-2, False, False),
    (4, 2048, 1000, 16, 64, 64, 0, torch.bfloat16, 2e-2, False, False),  # S != T
    # S = T an odd multiple of 64 and a window that is no multiple of 128:
    # the last 128-row item's second warpgroup holds no row, the window's
    # edges fall inside items
    (4, 1088, 1088, 16, 64, 64, 192, torch.bfloat16, 2e-2, False, False),
]
# B.2 shapes of the main path at scale, 128 bits: (label, keys, elig kind)
GATHER_MAIN_SHAPES = [
    ("q=30 (one discover)", 30, "random"),
    ("q=240 block-diagonal, 8 blocks (one discover_many group)", 240, "block-diagonal"),
    ("q=300 (two query tiles)", 300, "random"),
    ("q=256 elig=None", 256, None),
]
# B.4 and B.5 edge shapes, every combination held exactly: rows, queries
# (one tile, its ragged edge, two tiles) and lanes
EDGE_N = (1, 31, 257, (1 << LOG_N) + 3)
EDGE_Q = (1, 7, 9, 30, 240, 256, 257, 300)
EDGE_LANES = (4, 8, 16)
BIG_MATCH = ((1 << 23) + 5, 257)  # B.4 rows and queries with n·q past 2^31
# lane prefixes (not multiples of 4 take B.2's word-by-word copies): of the
# kernel phase's 16-lane store, and of the main lake's 128- and 256-bit
# sessions through plan_and_count / discover_many
KERNEL_LANES = (1, 2, 3, 4, 5, 7, 8, 13, 16)
SESSION_LANES = {128: (1, 2, 3), 256: (5,)}
MIXED_MANY_LANES = (5,)  # the mixed group's discover_many (demoted to B.4)
# B.6 at MLA's head dims: (B, S, H, d, dv), each causal with these windows,
# in both dtypes with their tolerances
FLASH_EDGE = [(2, 512, 4, 192, 128), (2, 512, 4, 24, 16), (2, 512, 4, 20, 12)]
FLASH_EDGE_WINDOWS = (0, 128)
FLASH_EDGE_DTYPES = ((torch.bfloat16, 2e-2), (torch.float32, 1e-5))
# B.6 non-causal, the families' calls: (B, S, T, H, d) with dv = d — whisper's
# encoder (S = T = 1500 frames), llama-3.2-vision's cross-attention (T =
# 1601 patches, S = the prompt), whisper's cross-attention (T = 1500)
FLASH_NONCAUSAL = [(2, 1500, 1500, 8, 64), (2, 512, 1601, 32, 128), (2, 2048, 1601, 32, 128),
                   (2, 256, 1500, 8, 64)]
# their tolerances: a kernel that let in the last tile's zero-filled keys
# past T (score 0, V 0) would scale every row by sum/(sum + n_pad), 1.4% at
# T 1500 and 2.3% at T 1601.  With that fault planted the bf16 max_abs_err
# read 0.0029-0.0117 and the mean |err| / mean |plain| 0.014-0.023; the
# sound kernel reads one bf16 ulp (0.00098) and 4.5e-6 (one H100).  So bf16
# is held at 2.5e-3 and the mean at FLASH_NONCAUSAL_MEAN_REL
FLASH_NONCAUSAL_DTYPES = ((torch.bfloat16, 2.5e-3), (torch.float32, 1e-5))
FLASH_NONCAUSAL_MEAN_REL = 1e-3
# B.6 under autograd (the flash_grad line): (B, S, T, H, d, dv, causal) —
# qwen1.5-0.5b's training shape, MLA's head dims, whisper's cross-attention
# (non-causal, T = 1500 frames); dq, dk, dv held by ‖Δ‖/‖ref‖ against
# autograd through the plain version on float32 copies
FLASH_GRAD = [(8, 2048, 2048, 16, 64, 64, True), (2, 2048, 2048, 16, 192, 128, True),
              (2, 256, 1500, 8, 64, 64, False)]
# and its edges: (label, B, S, T, H, d, dv, causal, window, fused) — a
# window; llama-3.2-vision's cross-attention (T = 1601, which no tile width
# divides); a causal window over S > T, whose rows past T + window - 1 admit
# no key (zero gradients there, no NaN); q, k, v as strided views of one
# fused [B, S, 3, H, d] projection; a d the bf16 kernels pad (100)
FLASH_GRAD_EDGE = [
    ("window", 2, 2048, 2048, 16, 64, 64, True, 512, False),
    ("cross", 2, 512, 1601, 32, 128, 128, False, 0, False),
    ("rows without a key", 2, 512, 128, 8, 64, 64, True, 64, False),
    ("fused-qkv views", 2, 2048, 2048, 16, 64, 64, True, 0, True),
    ("d=100", 2, 1024, 1024, 8, 100, 100, True, 0, False),
]
FLASH_GRAD_DTYPES = ((torch.bfloat16, 1e-2), (torch.float32, 1e-5))
GRAD_REPS = 10  # timed backward calls
# the discovery serving tier: a 512-bit session that degrades to 128 bits,
# driven on a ManualClock by bursts of requests (their sizes sum to
# SERVING_REQUESTS) drawn with a Zipf skew from the ground-truth and mixed
# queries; a burst smaller than the window waits for its deadline
SERVING_BITS, SERVING_DEGRADE_BITS = 512, 128
SERVING_BURSTS = (36, 3, 9, 8, 5, 3)
SERVING_REQUESTS = sum(SERVING_BURSTS)
SERVING_WINDOW, SERVING_MAX_QUEUE, SERVING_CACHE, SERVING_FLUSH_AFTER = 8, 16, 32, 0.5
# then a spike of mixed queries alone, on a fresh engine: max_queue
# admitted, a window past it degraded (mixed groups run B.4, not B.2)
MIXED_SPIKE = SERVING_MAX_QUEUE + SERVING_WINDOW
# FD phase: the planted-FD lakes (tests/test_fd.py's construction)
FD_SEEDS = (0, 1, 2)
FD_BACKENDS = ("fused-gather", "fused", "numpy")
# the routed lake: shards of the session, backends held against the
# single-host session, the serving stream, the mesh sub-phase's ranks
ROUTED_SHARDS = 4
ROUTED_BACKENDS = ("fused-gather", "fused", "pallas", "numpy")
ROUTED_STREAM = 16
MESH_RANKS = 2
MESH_TIMEOUT_S = 300.0
# serve phase
SERVE_ARCH = "qwen1.5-0.5b"
# driver phase: ``launch.discovery.main`` at the smoke's lake with these
# flags, beside ``--n-tables`` and ``--seed`` (sizes from PERF.md §4)
DRIVER_ARGV = ["--queries", "4", "--rows", "20", "--fds", "--result-cache", "32",
               "--bound-cache", "32", "--route-shards", "4", "--build-mesh", "2", "--mesh", "2x2"]
# the parent's launches: B.2 (discover, FD, routed shards), B.3 (builds and
# query keys), B.4 (the mixed serving group and routed shards past the
# table cap); the 2-rank filter's B.4 runs in the ranks
DRIVER_KERNELS = ("gather_filter_table_counts", "xash_superkey", "filter_match")
# conformance phase: tests/test_conformance.py's lake and k
CONFORMANCE_LAKE = dict(n_tables=30, corpus_seed=3, n_queries=2, n_rows=8, key_width=2,
                        query_seed=5)
CONFORMANCE_K, CONFORMANCE_FD_SEED = 5, 3
# examples phase: each twin and text its card run must print
EXAMPLE_EXPECT = {
    "torch_quickstart": ("filter backend: fused-gather [resolved from platform]", "precision="),
    "torch_async_serving": ("served 60/60", "pump_errors=0", "after insert_table: from_cache=False"),
    "torch_distributed_discovery": ("(impl=fused)", "most candidate-dense tables"),
    "torch_serve_batched": ("8 requests, 128 new tokens", "(CUDA, reduced config)",
                            "discovery: 6/6 requests served", "backend=fused-gather"),
    "torch_enrich_and_train": ("(backend=fused-gather)", "[2] enriched 3 -> 5 cols", "[3] done: loss"),
}
# B.1 (the distributed twin's fused shard impl), B.2, B.3, B.6 (serve_batched)
EXAMPLE_KERNELS = ("filter_table_counts", "gather_filter_table_counts", "xash_superkey",
                   "flash_attention")
SERVE_REQUESTS, SERVE_BATCH, SERVE_NEW, SERVE_MAX_SEQ = 8, 4, 32, 2080
PROMPT_MIN, PROMPT_MAX = 512, 2048
CONSIST_B, CONSIST_S = 2, 512  # decode-consistency check
CONSIST_DEPTHS = (1, 2, 6, 12, 24)  # of qwen1.5-0.5b's 24 layers
# families phase: (arch, layers kept, prompt lengths, B.6 launches per
# prefill at that depth); widths are never cut, depth only where one card
# cannot hold the weights
FAMILIES = [
    ("qwen2-moe-a2.7b", 24, (512, 2048), 24),
    ("mamba2-1.3b", 48, (256, 1024), 0),
    ("llama-3.2-vision-11b", 40, (256, 1024), 40),  # 32 self + 8 cross (T = 1601)
    ("whisper-base", 6, (64, 256), 18),  # 6 encoder + 6 self + 6 cross (T = 1500)
    ("jamba-v0.1-52b", 8, (256, 1024), 1),  # one block: 7 SSM + 1 attention, 4 MoE
    ("deepseek-v3-671b", 4, (256, 1024), 4),  # 3 dense + 1 MoE layer, MTP built
]
FAMILY_REQUESTS, FAMILY_NEW = 4, 16  # one slot group of 4
FAMILY_CONSIST_B, FAMILY_CONSIST_S = 2, 127  # B·S and B·(S + 1) within MoE's grouping
# the first whole block's float32 prefill/decode consistency, in max|logit|:
# a fault in the decode path would show in float32 as in bf16, at the size
# the bf16 bound (0.05) is there to catch; rounding shrinks with precision.
# A fifth of the bf16 bound: the VLM's 5-layer block read 0.143 in bf16 and
# 0.0013 in float32 (one H100), its float32 one-ulp move printed beside
FAMILY_F32_BOUND = 1e-2
# train phase: launch.train.main at full-width qwen1.5-0.5b, as users run
# it, a checkpoint at TRAIN_RESUME_AT and a resume from it (the resumed
# losses match within TRAIN_RESUME_REL); then TRAIN_FALL_STEPS steps from
# the same draw with its attention projections rescaled, whose loss must
# fall by TRAIN_LOSS_FALL (PERF.md §6's prediction); the 2-layer float32
# step through B.6 matches the plain attention's within TRAIN_PARITY_TOL
TRAIN_SEQ, TRAIN_BATCH = 2048, 8
TRAIN_ARGV = ["--arch", SERVE_ARCH, "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH)]
TRAIN_STEPS, TRAIN_RESUME_AT, TRAIN_FALL_STEPS = 9, 5, 20
TRAIN_LOSS_FALL = 0.1
TRAIN_RESUME_REL = 1e-3
TRAIN_PARITY_LAYERS, TRAIN_PARITY_TOL = 2, 1e-3
# the block's other remat policies (``transformer.REMAT_POLICY``): their
# first TRAIN_POLICY_STEPS steps from the conditioned run's draw, its
# settings and batches; losses and gradient norms held against that run's
# ('full') within TRAIN_POLICY_REL (only what a block keeps for its
# backward changes, so they are expected equal); B.6 launches per step
# TRAIN_POLICY_B6 per attention layer
TRAIN_POLICY_STEPS, TRAIN_POLICY_REL = 3, 1e-6
TRAIN_POLICY_B6 = {"dots": 2, "none": 1}
# training over a mesh (phase 11b): qwen1.5-0.5b at its published widths,
# cut to TRAIN_MESH_LAYERS of its 24 layers (``--layers``), over gloo ranks
# on the one card, its first step and a 1x1 resume of its step-2
# checkpoint held against --mesh 1x1 within TRAIN_MESH_REL (bf16)
TRAIN_MESH, TRAIN_MESH_SEQ, TRAIN_MESH_BATCH, TRAIN_MESH_STEPS, TRAIN_MESH_CKPT = "2x2", 512, 8, 4, 2
TRAIN_MESH_LAYERS = 6
TRAIN_MESH_REL = 2e-2
TRAIN_MESH_TIMEOUT_S = 600.0
# int8 moments over the mesh (``--state-dtype int8``: replicated, each
# updated whole from the gathered gradient): a 1x1 run of
# TRAIN_MESH_INT8_STEPS from a step-0 checkpoint of the same conditioned
# draw with int8 moments, saving after every step; the 2x2 run resumes its
# step-1 checkpoint and takes the last step, saving it
TRAIN_MESH_INT8_STEPS = 2
# printed beside what the run measures: each rank's peak GB in the plain
# 2x2 run and the dry train_4k cells' temp GB as this script measured them
# on an H100 when every leaf was gathered once a step ('whole_tree'), and
# the range predicted for one block at a time (PERF.md §6)
TRAIN_MESH_PEAK_GB = {"whole_tree": 2.795, "predicted": (2.62, 2.72)}
DRY_TEMP_GB = {"qwen3-32b__train_4k__16x16": {"whole_tree": 61.61, "predicted": (53.6, 57.6)},
               "qwen3-32b__train_4k__2x16x16": {"whole_tree": 33.56, "predicted": (25.6, 29.6)},
               "qwen1.5-0.5b__train_4k__16x16": {"whole_tree": 6.01, "predicted": (5.9, 6.0)}}
# GPipe (phase 11c): 2 stages x 1 data rank, [8, 512], 4 microbatches; the
# loss within PIPE_TOL (absolute, bf16) of the un-pipelined chunked CE
PIPE_STAGES, PIPE_SEQ, PIPE_BATCH, PIPE_MICRO, PIPE_TOL = 2, 512, 8, 4, 1e-2
# serving over a mesh (phase 11d): full-width dense decoders on 4 gloo ranks
# on the one card, prefill and every decode step of the 1x1 run's greedy
# tokens held within SERVE_MESH_TOL of max|logit| of the 1x1 run on the same
# weights (tests/test_models.py's serving bound); qwen1.5's 16 KV heads
# split over 'model', starcoder2's 2 leave the cache's slots split
SERVE_MESH = (("qwen1.5-0.5b", {"data": 2, "model": 2}), ("starcoder2-3b", {"data": 1, "model": 4}))
# the mesh phases (11b, 11d, 11e, 11f): one spawn of MESH_SERVING_RANKS ranks takes
# the training runs and every serving group, one after the other
MESH_PHASES, MESH_SERVING_RANKS = ("train_mesh", "serve_mesh", "families_mesh", "long_mesh"), 4
SERVE_MESH_B, SERVE_MESH_S, SERVE_MESH_NEW, SERVE_MESH_TOL = 4, 512, 16, 0.05
SERVE_MESH_LAYERS = 6  # of qwen1.5-0.5b's 24 and starcoder2-3b's 30, their widths whole
# served once more under sequence parallelism (``layers.SEQ_SHARD``): the
# prefill's residual stream split over 'model', then SERVE_MESH_SP_NEW of
# the greedy decode steps from its cache, held the same way
SERVE_MESH_SP, SERVE_MESH_SP_NEW = ("qwen1.5-0.5b",), 4
# the families over a mesh (phase 11e): each at its published widths, cut
# to the fewest layers that hold every kind of its sublayers
# (``family_mesh_cfg``), one group after the other on 4 gloo ranks on the
# one card; serving in float32 (FMESH_B prompts of ``fmesh_seq`` tokens,
# FMESH_NEW decode steps of the 1x1 run's greedy tokens) held within
# SERVE_MESH_TOL of max|logit|, training in bf16 (FMESH_STEPS steps of
# [FMESH_B, fmesh_seq]: B/D·S = 256 tokens, whole MoE dispatch groups) its
# first step's loss and gradient norm within TRAIN_MESH_REL, both against
# 1x1 in a process of its own on the same draw.  Serving is compared in
# float32 because the MoE routing is chaotic in bf16: a near tie of the
# router flips an expert (decode steps fill a capacity of 1 per expert) and
# moves the logits by up to ~0.2 of max|logit| at 2 layers, where the mesh
# and 1x1 differ only by bf16 rounding (PERF.md §6)
FAMILIES_MESH = (
    ("qwen2-moe-a2.7b", {"data": 2, "model": 2}),  # 30 of 60 experts a rank
    ("llama-3.2-vision-11b", {"data": 2, "model": 2}),
    ("whisper-base", {"data": 2, "model": 2}),
    ("deepseek-v3-671b", {"data": 1, "model": 4}),  # 64 of 256 experts and 32 of 128 heads a rank
    ("mamba2-1.3b", {"data": 2, "model": 2}),  # 32 of 64 SSM heads, 2176 conv channels against 2048 of x
    ("jamba-v0.1-52b", {"data": 1, "model": 4}),  # 4 of 16 experts, 2 of 8 KV heads, 2056 conv channels
)
FMESH_B, FMESH_S, FMESH_NEW, FMESH_STEPS = 4, 128, 8, 3
# mamba2's prompts cross its 256-token SSD chunk, so that the state carried
# between chunks (split over heads) is used
FMESH_SEQ = {"mamba2-1.3b": 512}
# deepseek-v3's cut holds 14.6 B parameters (29.3 GB in bf16; its one MoE
# layer's experts 22.5 GB): its ranks draw one after the other (one whole
# leaf, up to 15 GB in float32, at a time), and its training check is one
# forward and backward without AdamW, whose float32 moments would not fit
# beside four ranks' shards and gradients
FMESH_TURNS = ("deepseek-v3-671b",)
FMESH_NO_OPT = ("deepseek-v3-671b",)
FMESH_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}  # the spawned processes': less fragmentation
# the groups that also prefill (float32, no decode step) and take a bf16
# gradient step under sequence parallelism, held against 1x1 as the
# group's own are
FMESH_SP = ("jamba-v0.1-52b",)
# the long-context groups (phase 11f): batch 1, which the 2x2 grid's 2 data
# ranks do not divide, so every rank holds the row and the cache's batch dim
# is whole (the reference's replication): a prompt of FMESH_S tokens into a
# cache of LONG_SLOTS slots (h2o-danube's 4096-slot ring), the slots past it
# filled as if the prompt had run to LONG_SLOTS - FMESH_NEW (``long_fill``,
# in chunks of LONG_CHUNK slots), then FMESH_NEW decode steps of the 1x1
# run's greedy tokens, in float32, held against 1x1 within LONG_MESH_TOL of
# max|logit| (the float32 gap is a few 1e-6; a query's attention spreads
# over every filled slot, so a fault in the merge moves the logits far less
# than SERVE_MESH_TOL would see); h2o-danube at its published widths cut to
# LONG_LAYERS of its 24 layers, jamba cut as ``family_mesh_cfg`` cuts it
LONG_MESH = (("h2o-danube-3-4b", {"data": 2, "model": 2}), ("jamba-v0.1-52b", {"data": 2, "model": 2}))
LONG_SLOTS, LONG_CHUNK, LONG_LAYERS, LONG_MESH_TOL = 524288, 1024, 2, 1e-4
# the dry run (phase 11g): each process's entry point, the argvs its
# ``main`` is called with one after the other, and the status expected of
# each cell they write ('error:<item>': an error record naming it); mamba2's and
# jamba's cells trace in processes of their own, beside the others; the
# module switches' cells (sequence parallelism, the remat policies) in the
# first process, the int8 train cell after deepseek-v3's decode (the two
# processes that ended first in earlier runs), h2o-danube's long_500k after
# llama-3.2-vision's cells, jamba's in jamba's process
DRYRUN_CALLS = (
    ("repro_torch.launch.dryrun", [
        ["--arch", "qwen1.5-0.5b"],
        ["--arch", "qwen1.5-0.5b", "--shape", "prefill_32k,train_4k", "--variant", "sp", "--set", "seq_shard=true"],
        ["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--variant", "dots", "--set", "remat_policy=dots"],
        ["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--variant", "none", "--set", "remat_policy=none"]],
     {"qwen1.5-0.5b__train_4k__16x16": "ok", "qwen1.5-0.5b__prefill_32k__16x16": "ok",
      "qwen1.5-0.5b__decode_32k__16x16": "ok", "qwen1.5-0.5b__long_500k__16x16": "skipped",
      "qwen1.5-0.5b__prefill_32k__16x16__sp": "ok", "qwen1.5-0.5b__train_4k__16x16__sp": "ok",
      "qwen1.5-0.5b__train_4k__16x16__dots": "ok", "qwen1.5-0.5b__train_4k__16x16__none": "ok"}),
    ("repro_torch.launch.dryrun", [["--arch", "qwen3-32b", "--shape", "train_4k", "--both-meshes"]],
     {"qwen3-32b__train_4k__16x16": "ok", "qwen3-32b__train_4k__2x16x16": "ok"}),
    ("repro_torch.launch.dryrun", [["--arch", "qwen2-moe-a2.7b,whisper-base", "--shape", "train_4k,decode_32k"]],
     {"qwen2-moe-a2.7b__train_4k__16x16": "ok", "qwen2-moe-a2.7b__decode_32k__16x16": "ok",
      "whisper-base__train_4k__16x16": "ok", "whisper-base__decode_32k__16x16": "ok"}),
    ("repro_torch.launch.dryrun", [["--arch", "llama-3.2-vision-11b", "--shape", "train_4k,decode_32k"],
                                   ["--arch", "h2o-danube-3-4b", "--shape", "long_500k"]],
     {"llama-3.2-vision-11b__train_4k__16x16": "ok", "llama-3.2-vision-11b__decode_32k__16x16": "ok",
      "h2o-danube-3-4b__long_500k__16x16": "ok"}),
    ("repro_torch.launch.dryrun", [["--arch", "mamba2-1.3b", "--shape", "train_4k,decode_32k,long_500k"]],
     {"mamba2-1.3b__train_4k__16x16": "ok", "mamba2-1.3b__decode_32k__16x16": "ok",
      "mamba2-1.3b__long_500k__16x16": "ok"}),
    ("repro_torch.launch.dryrun", [["--arch", "jamba-v0.1-52b", "--shape", "train_4k,decode_32k,long_500k"]],
     {"jamba-v0.1-52b__train_4k__16x16": "ok", "jamba-v0.1-52b__decode_32k__16x16": "ok",
      "jamba-v0.1-52b__long_500k__16x16": "ok"}),
    ("repro_torch.launch.dryrun", [["--arch", "deepseek-v3-671b", "--shape", "train_4k"]],
     {"deepseek-v3-671b__train_4k__16x16": "ok"}),
    ("repro_torch.launch.dryrun", [["--arch", "deepseek-v3-671b", "--shape", "train_4k", "--multi-pod"]],
     {"deepseek-v3-671b__train_4k__2x16x16": "ok"}),
    ("repro_torch.launch.dryrun", [["--arch", "deepseek-v3-671b", "--shape", "decode_32k"],
                                   ["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--variant", "int8", "--set",
                                    "state_dtype=int8"]],
     {"deepseek-v3-671b__decode_32k__16x16": "ok", "qwen1.5-0.5b__train_4k__16x16__int8": "ok"}),
    ("repro_torch.launch.dryrun_mate", [["--shape", "filter_1g", "--impl", "broadcast", "--build-shards", "4"]],
     {"mate-filter__filter_1g-broadcast__16x16": "ok", "mate-filter__filter_1g-broadcast__2x16x16": "ok"}),
)
DRYRUN_TIMEOUT_S = 600
# the long_500k cells' K/V bytes a device: layers × slots (h2o-danube's
# 4096-slot ring, jamba's 524,288) × 8 KV heads × head dim × K and V × bf16,
# over the 256 devices their slots split over; printed beside each cell's
# cache argument bytes (its arguments less the parameter shards and the token)
DRY_LONG_KV_BYTES = {"h2o-danube-3-4b__long_500k__16x16": 24 * 4096 * 8 * 120 * 2 * 2 // 256,
                     "jamba-v0.1-52b__long_500k__16x16": 4 * 524288 * 8 * 128 * 2 * 2 // 256}
DRYRUN_NICE = 10  # the tracing processes' priority: below the lake's draw and the build


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sass_count(lib, mnemonic: str) -> dict[str, int] | None:
    """Instructions named ``mnemonic`` in each kernel of a built library
    (``cuobjdump -sass``), for the kernels that have any; None without
    cuobjdump."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, fn = collections.Counter(), None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
        elif fn and mnemonic in ln:
            counts[fn] += 1
    return dict(counts)


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` calls (warmed)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n_bytes: float, n_ops: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0 or torch.equal(a, b):
        return 0
    a, b, step = a.reshape(-1), b.reshape(-1), 1 << 26
    return max(int((a[i:i + step].long() - b[i:i + step].long()).abs().max().item())
               for i in range(0, a.numel(), step))


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version at main-path scale
# ---------------------------------------------------------------------------

def make_filter_inputs(rng, dev, n_store, lanes, n, q, n_tables):
    """A superkey store with realistic popcount (each bit set with p = 1/16:
    32 of 512 bits, the order of a 6–8-cell row at 4 ones per value), CSR
    candidate offsets grouped by table, query keys planted as bit subsets of
    candidate rows, and a 1-in-4 eligibility matrix."""
    raw = torch.from_numpy(
        rng.integers(0, 2**32, size=(n_store, lanes), dtype=np.uint32).view(np.int32)
    ).to(dev)
    store = raw & raw.roll(1, 0) & raw.roll(2, 0) & raw.roll(3, 0)
    del raw
    seg = torch.from_numpy(np.sort(rng.integers(0, n_tables, size=n)).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.integers(0, n_store, size=n).astype(np.int32)).to(dev)
    query = make_queries(rng, store, rows, q)
    elig = make_elig(rng, dev, n, q, "random")
    return store, rows, query, elig, seg


def make_queries(rng, store, rows, q):
    """q query keys, each a random bit subset of a candidate row."""
    pick = torch.from_numpy(rng.integers(0, rows.shape[0], size=q)).to(store.device)
    keep = torch.from_numpy(
        rng.integers(0, 2**32, size=(q, store.shape[1]), dtype=np.uint32).view(np.int32)
    ).to(store.device)
    return (store[rows[pick].long()] & keep & keep.roll(1, 0)).contiguous()


def make_elig(rng, dev, n, q, kind, blocks: int = 8):
    """bool[n, q]: 1-in-4 eligible ("random"), or that within ``blocks``
    diagonal blocks and none outside them ("block-diagonal": the rows of
    each query of a ``discover_many`` group are eligible only for its keys)."""
    elig = torch.from_numpy(rng.integers(0, 4, size=(n, q), dtype=np.uint8) == 0).to(dev)
    if kind == "block-diagonal":
        row_blk = torch.arange(n, device=dev) * blocks // n
        key_blk = torch.arange(q, device=dev) * blocks // q
        elig &= row_blk[:, None] == key_blk[None, :]
    return elig


def flash_pairs(s, t, window, causal: bool = True) -> int:
    """Admissible (query i, key j) pairs of one head: j < t, j <= i when
    causal, i - j < window when window > 0."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(b, s, t, h, d, dv, window, elem, causal: bool = True) -> tuple[int, int]:
    """(bytes, FLOPs) of one flash call: q, k, v read once and out written
    once; 2·d + 2·dv FLOPs per admissible pair (``flash_pairs``), counted
    for this shape."""
    pairs = flash_pairs(s, t, window, causal)
    return b * h * (s * d + t * d + t * dv + s * dv) * elem, b * h * pairs * 2 * (d + dv)


def flash_bwd_work(b, s, t, h, d, dv, window, elem, causal: bool = True) -> tuple[int, int]:
    """(bytes, FLOPs) of one attention backward (``flash_attention_backward``):
    q, k, v and dout read once, dq, dk and dv written once; per admissible
    pair 2·(3·d + 2·dv) FLOPs — the scores recomputed (2·d), dV += Pᵀ·dO
    (2·dv), dP = dO·Vᵀ (2·dv), dQ = dS·K (2·d), dK = dSᵀ·Q (2·d)."""
    pairs = flash_pairs(s, t, window, causal)
    return (b * h * (2 * s * d + 2 * t * d + 2 * t * dv + s * dv) * elem,
            b * h * pairs * 2 * (3 * d + 2 * dv))


def gather_bytes(rows, store_stride: int, lanes: int, q: int, n_tables: int,
                 has_elig: bool) -> int:
    """Bytes one B.2 launch must move: each row offset, table id and elig
    row read once, each distinct 32-byte sector of the store that the
    candidates' probed lanes touch read once (a sector is the least a gather
    reads), the query keys read and the counts written once."""
    n = rows.shape[0]
    start = rows.long() * store_stride * 4
    first, last = start // 32, (start + lanes * 4 - 1) // 32
    # a row's sectors first..last; past its last, `first` stands in (counted already)
    spans = [torch.where(first + k <= last, first + k, first)
             for k in range(int((last - first).max()) + 1 if n else 0)]
    n_sectors = int(torch.unique(torch.cat(spans)).numel()) if n else 0
    return n * 4 + 32 * n_sectors + (n * q if has_elig else 0) + n * 4 + q * lanes * 4 + n_tables * 4


def counts_work(n: int, lanes: int, n_queries: int, q: int, n_tables: int, elig, seg) -> tuple[int, int]:
    """(bytes, operations) of one B.1 launch: each row's lanes, its table id
    and its elig bytes for the real queries read once, the real query keys
    read once, the table counts and the q key counts written once; one test
    per (row, real query) pair that needs one: the row is not padding
    (seg >= 0) and the pair is eligible."""
    live = seg >= 0
    if elig is None:
        pairs = int(live.sum()) * n_queries
    else:
        pairs = int((elig[:, :n_queries] & live[:, None]).sum())
    nbytes = (n * lanes * 4 + n * 4 + (n * n_queries if elig is not None else 0)
              + n_queries * lanes * 4 + n_tables * 4 + q * 4)
    return nbytes, pairs


def match_work(n: int, lanes: int, q: int) -> tuple[int, int]:
    """(bytes, operations) of one B.4 launch: the rows and the queries read
    once, the n x q int8 matrix written once; one test per (row, query)."""
    return n * lanes * 4 + q * lanes * 4 + n * q, n * q


def count_work(n: int, lanes: int, q: int) -> tuple[int, int]:
    """(bytes, operations) of one B.5 launch: the rows and the queries read
    once, the q int32 counts written once; one test per (row, query)."""
    return n * lanes * 4 + q * lanes * 4 + q * 4, n * q


def edge_rows(rng, dev, n: int, lanes: int) -> torch.Tensor:
    """int32[n, lanes] rows of realistic popcount (as ``make_filter_inputs``)
    with all-ones rows (i % 97 == 5) and zero rows (i % 89 == 3)."""
    raw = rng.integers(0, 2**32, size=(n + 3, lanes), dtype=np.uint32)
    rows = torch.from_numpy((raw[:-3] & raw[1:-2] & raw[2:-1] & raw[3:]).view(np.int32)).to(dev)
    i = torch.arange(n, device=dev)
    rows[i % 97 == 5] = -1
    rows[i % 89 == 3] = 0
    return rows


def edge_queries(rng, rows: torch.Tensor, q: int) -> torch.Tensor:
    """q query keys, each a random bit subset of a row, with an all-zero
    query at q // 2 (q >= 2) and an all-ones one last (q >= 3)."""
    pick = torch.from_numpy(rng.integers(0, rows.shape[0], size=q)).to(rows.device)
    keep = torch.from_numpy(
        rng.integers(0, 2**32, size=(q, rows.shape[1]), dtype=np.uint32).view(np.int32)
    ).to(rows.device)
    qs = rows[pick] & keep & keep.roll(1, 0)
    if q >= 2:
        qs[q // 2] = 0
    if q >= 3:
        qs[-1] = -1
    return qs.contiguous()


def xash_work(enc: torch.Tensor, cfg) -> tuple[int, int]:
    """(bytes, operations) of one B.3 launch: the encoded cells read once and
    the lanes written once; one test per byte, two counter updates per
    character of the alphabet, and one score per (present character, pick)
    of each cell — a pick for each of the min(present, n_char_bits) chosen."""
    n_rows, max_len = enc.shape[0], enc.shape[-1]
    codes = enc.reshape(-1, max_len).long().clamp(max=38)  # 38: outside the alphabet
    cnt = torch.zeros(codes.shape[0], 39, dtype=torch.int64, device=enc.device)
    cnt.scatter_add_(1, codes, torch.ones_like(codes))
    present = (cnt[:, 1:38] > 0).sum(dim=1)
    n_chars = int(cnt[:, 1:38].sum().item())
    picks = int((present * present.clamp(max=cfg.n_char_bits)).sum().item())
    return enc.numel() + n_rows * cfg.lanes * 4, enc.numel() + 2 * n_chars + picks


def xash_edge_inputs(rng, uniq: np.ndarray, n: int, max_len: int) -> np.ndarray:
    """uint8[n, 3, max_len] rows of the corpus's values, with edge cells: one
    character repeated over the full width, all 37 characters (shuffled),
    random codes 0..255 over the full width (codes above 37, zeros inside),
    empty first, middle or last cells, and whole empty rows."""
    from repro_torch.core import encoding

    a = encoding.ALPHABET_SIZE
    enc = np.zeros((n, 3, max_len), dtype=np.uint8)
    w = min(max_len, uniq.shape[1])
    enc[:, :, :w] = uniq[rng.integers(0, uniq.shape[0], size=n * 3)].reshape(n, 3, -1)[:, :, :w]
    for i in range(a):  # rows 0..36: char i + 1 over the whole width, in each column
        enc[i, i % 3] = i + 1
    for i in range(a, a + 12):  # all 37 characters
        enc[i, i % 3] = 0
        perm = rng.permutation(a) + 1
        enc[i, i % 3, :min(a, max_len)] = perm[:max_len]
    enc[a + 12:a + 40, 1] = rng.integers(0, 256, size=(28, max_len))  # codes above 37
    enc[::5, 1] = 0  # empty middle cells
    enc[3::7, 0] = 0
    enc[3::7, 2] = 0  # only the middle cell
    enc[11::13] = 0  # empty rows
    return enc


def ptxas_entries(log: str, needle: str) -> dict[str, list[str]]:
    """``ptxas -v`` lines (registers, stack, spills) of each entry function
    whose mangled name holds ``needle``."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1) if needle in m.group(1) else None
            if fn:
                out[fn] = []
        elif fn and ("registers" in ln or "spill" in ln):
            out[fn].append(ln.strip())
    return out


def flash_tc_smem(dp: int, dvp: int) -> int:
    """Dynamic shared memory of one bf16 flash block (``TcTile::kSmem``): the
    1024-byte alignment slack, two Q buffers of 128 rows, the ring of 64-key
    K/V stages (4, or 3 where 4 do not fit in 227 KB) and the mbarriers (two
    per Q buffer, two per stage)."""
    def smem(stages):
        return 1024 + 2 * 128 * dp * 2 + stages * 64 * (dp + dvp) * 2 + (4 + 2 * stages) * 8
    return smem(4) if smem(4) <= 232448 else smem(3)


def flash_edge_phase(seed) -> None:
    """B.6 at MLA's head dims (d 192 and the reduced 24) and at d 20 / dv
    12, causal and windowed, in bf16 (the tensor maps zero-fill d and dv to
    the tile widths; d 20 / dv 12 are zero-padded to multiples of 8 by the
    wrapper first) and f32, against the plain version; then non-causal at
    the families' ragged lengths, S = T and S != T (``FLASH_NONCAUSAL``);
    SDPA timed beside each."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_kernel as flk

    dev = torch.device("cuda")
    checks = []

    def check(qkv, t, causal, window, dtype, tol, shape, mean_rel_tol=None):
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in qkv)
        call = lambda: flk.flash_attention(*qkv, causal=causal, window=window)
        plain = lambda: flk.flash_attention_plain(*qkv, causal=causal, window=window)
        got, want = call().float(), plain().float()
        err = float((got - want).abs().max().item())
        mean_rel = float((got - want).abs().mean() / want.abs().mean())
        del got, want
        if not err < tol:
            raise AssertionError(f"flash_attention {shape}: max_abs_err {err} >= {tol}")
        if mean_rel_tol is not None and not mean_rel < mean_rel_tol:
            raise AssertionError(f"flash_attention {shape}: mean |err| / mean |plain| {mean_rel}"
                                 f" >= {mean_rel_tol}")
        b, s, h, d = qkv[0].shape
        if window:
            mask = flk._admissible(s, t, causal, window, dev)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        else:
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        nbytes, flops = flash_work(b, s, t, h, d, qkv[2].shape[3], window, qkv[0].element_size(), causal)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
        checks.append({"shape": shape, "max_abs_err": err, "tolerance": tol, "mean_rel_err": mean_rel,
                       "mean_rel_tolerance": mean_rel_tol, "ms": cuda_ms(call, REPS),
                       "plain_ms": cuda_ms(plain, 1), "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": cuda_ms(sdpa, REPS)})

    for b, s, h, d, dv in FLASH_EDGE:
        for dtype, tol in FLASH_EDGE_DTYPES:
            gen = torch.Generator(device=dev).manual_seed(seed + d)
            qkv = [torch.randn(b, s, h, e, generator=gen, device=dev).to(dtype) for e in (d, d, dv)]
            for window in FLASH_EDGE_WINDOWS:
                check(qkv, s, True, window, dtype, tol,
                      f"[{b},{s},{h},d={d},dv={dv}] {str(dtype)[6:]} causal window={window}")
            del qkv
    for b, s, t, h, d in FLASH_NONCAUSAL:
        for dtype, tol in FLASH_NONCAUSAL_DTYPES:
            gen = torch.Generator(device=dev).manual_seed(seed + s + t)
            qkv = [torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype) for n in (s, t, t)]
            check(qkv, t, False, 0, dtype, tol, f"[{b},S={s},T={t},{h},d={d}] {str(dtype)[6:]} non-causal",
                  FLASH_NONCAUSAL_MEAN_REL)
            del qkv
    torch.cuda.empty_cache()
    log = _build.build_log.get("flash_attention")
    emit({"phase": "flash_edge", "checks": checks,
          "ptxas_d192": None if log is None else ptxas_entries(log, "flash_tc_kernelILi192E"),
          "dynamic_smem_bytes_d192": {"dv<=64": flash_tc_smem(192, 64), "dv<=128": flash_tc_smem(192, 128)}})


def flash_grad_phase(seed) -> dict:
    """B.6 under autograd (``flash_attention`` through ``_FlashAttention``:
    the forward kernel with its row log-sum-exp, then the backward kernels,
    ``flash_attention_backward``) at the ``FLASH_GRAD`` shapes and the
    ``FLASH_GRAD_EDGE`` edges, in bf16 and f32.  Held, by ‖Δ‖/‖ref‖ within
    the dtype's tolerance: dq, dk and dv against the plain version on the
    card (``flash_attention_backward_plain`` on float32 copies of the same
    inputs and residuals) and against torch autograd through the plain
    forward; every gradient finite; one forward and one backward launch
    per autograd call; three calls on the same inputs bit-equal; zero dq on
    the rows that admit no key.  CUDA-event times of the forward, the
    backward, the plain backward, and ``scaled_dot_product_attention``'s
    backward alone and forward + backward on the same inputs; the
    backward's bound from ``flash_bwd_work``.  Returns the backward's row
    of the kernels line (the first shape, bf16)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_kernel as flk

    dev = torch.device("cuda")
    checks, row = [], None
    shapes = [("causal" if c else "non-causal", b, s, t, h, d, dv, c, 0, False)
              for b, s, t, h, d, dv, c in FLASH_GRAD] + FLASH_GRAD_EDGE
    for label, b, s, t, h, d, dv, causal, window, fused in shapes:
        for dtype, tol in FLASH_GRAD_DTYPES:
            gen = torch.Generator(device=dev).manual_seed(seed + s + d)
            if fused:  # q, k, v: strided views of one [B, S, 3, H, d] projection
                qkv = torch.randn(b, s, 3, h, d, generator=gen, device=dev).to(dtype).requires_grad_(True)
                leaves = qkv.unbind(2)
            else:
                leaves = [torch.randn(b, n, h, e, generator=gen, device=dev).to(dtype).requires_grad_(True)
                          for n, e in ((s, d), (t, d), (t, dv))]
            do = torch.randn(b, s, h, dv, generator=gen, device=dev).to(dtype)
            shape = f"[{b},S={s},T={t},{h},d={d},dv={dv}] {str(dtype)[6:]} {label} window={window}"
            before = (flk.flash_attention.launches, flk.flash_attention_backward.launches)
            flk.flash_attention(*leaves, causal=causal, window=window).backward(do)
            launched = (flk.flash_attention.launches - before[0],
                        flk.flash_attention_backward.launches - before[1])
            got = list(qkv.grad.unbind(2)) if fused else [x.grad for x in leaves]
            q, k, v = (x.detach() for x in leaves)
            with torch.no_grad():
                out, lse = flk._forward(q, k, v, causal, window, True)
            call = lambda: flk.flash_attention_backward(q, k, v, out, lse, do, causal=causal, window=window)
            again = [call(), call()]
            bit_equal = all(torch.equal(a, g) for rep in again for a, g in zip(rep, got))
            plain_call = lambda: flk.flash_attention_backward_plain(
                q.float(), k.float(), v.float(), out.float(), lse, do.float(), causal=causal, window=window)
            plain = plain_call()
            ref = [x.float().requires_grad_(True) for x in (q, k, v)]
            flk.flash_attention_plain(*ref, causal=causal, window=window).backward(do.float())
            names = ("dq", "dk", "dv")
            rel = {n: float((g.float() - p).norm() / p.norm()) for n, g, p in zip(names, got, plain)}
            rel_autograd = {n: float((g.float() - r.grad).norm() / r.grad.norm())
                            for n, g, r in zip(names, got, ref)}
            err = max(float((g.float() - p).abs().max()) for g, p in zip(got, plain))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            empty_rows = t + window - 1 if causal and window and s > t + window - 1 else None
            zero_rows = None if empty_rows is None else bool((got[0][:, empty_rows:] == 0).all())
            del ref, again
            failed = [what for what, ok in (
                ("dtype", all(g.dtype == dtype for g in got)), ("finite", finite), ("bit_equal", bit_equal),
                ("launches", launched == (1, 1)), ("zero_rows", zero_rows is not False),
                ("plain", max(rel.values()) <= tol), ("autograd", max(rel_autograd.values()) <= tol)) if not ok]

            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            mask = flk._admissible(s, t, causal, window, dev) if window or (causal and s != t) else None
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)
            sdpa_out = sdpa()
            nbytes, flops = flash_bwd_work(b, s, t, h, d, dv, window, q.element_size(), causal)
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
            check = {
                "shape": shape, "rel_err": rel, "rel_err_autograd": rel_autograd, "max_abs_err": err,
                "tolerance": tol, "finite": finite, "bit_equal": bit_equal, "launches": launched,
                "zero_rows_without_key": zero_rows,
                "forward_ms": cuda_ms(lambda: flk.flash_attention(q, k, v, causal=causal, window=window), REPS),
                "backward_ms": cuda_ms(call, GRAD_REPS),
                "backward_bound_ms": b_ms, "backward_bound_by": b_by,
                "plain_backward_ms": cuda_ms(plain_call, 1),
                "sdpa_bwd_ms": cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True),
                                       GRAD_REPS),
                "sdpa_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), GRAD_REPS)}
            check["kernel_to_library"] = check["backward_ms"] / check["sdpa_bwd_ms"]
            checks.append(check)
            if row is None:
                row = {"name": "flash_attention_backward", "route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                       "replaces": "src/repro/kernels/flash_kernel.py:101 (its backward, which the Pallas kernel"
                                   " lacks: the reference differentiates src/repro/models/layers.py:234 _sdpa_flash)",
                       "launches": 0, "max_abs_err": err, "max_abs_diff": err, "ms": check["backward_ms"],
                       "plain_ms": check["plain_backward_ms"], "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": check["sdpa_bwd_ms"], "shape": shape}
            if failed:
                emit({"phase": "flash_grad", "checks": checks, "failed": failed})
                raise AssertionError(f"flash_attention backward {shape}: {failed} ({check})")
            del leaves, got, plain, q, k, v, out, lse, do, qt, kt, vt, dot, sdpa_out
            if fused:
                del qkv
            torch.cuda.empty_cache()
    log = _build.build_log.get("flash_attention_bwd")
    emit({"phase": "flash_grad", "gpu": nvidia_smi(), "checks": checks,
          "ptxas": None if log is None else ptxas_entries(log, "_kernel"),
          "serialized": None if log is None else [ln.strip() for ln in log.splitlines() if "serialized" in ln]})
    return row


def flash_forward_checks(seed, record) -> None:
    """B.6 flash_attention at the serving path's prefill shape, its training
    forward (with the row log-sum-exp), then the window, the f32 dv != d
    shape and the bf16 edge shapes (``FLASH_SHAPES``), each held against the
    plain version and timed beside SDPA on the same inputs; ``record`` takes
    each row as ``kernel_phase``'s does."""
    from repro_torch.kernels import flash_kernel as flk

    dev = torch.device("cuda")
    for b, s, t, h, d, dv, window, dtype, tol, fused, lse in FLASH_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(seed)
        if fused:  # q, k, v: strided views of one [B, S, 3·H·d] projection
            qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=dev).to(dtype)
            qkv = [qkv[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3)]
        else:
            qkv = [torch.randn(b, n, h, e, generator=gen, device=dev, dtype=torch.float32).to(dtype)
                   for n, e in ((s, d), (t, d), (t, dv))]
        call = lambda: flk._forward(*qkv, True, window, lse)  # noqa: E731
        if lse:  # the output and the row log-sum-exp, against the plain version's
            (got, got_lse), (want, want_lse) = call(), flk.flash_attention_plain_lse(
                *qkv, causal=True, window=window)
            lse_err = float((got_lse - want_lse).abs().max().item())
        else:
            got, lse_err = flk.flash_attention(*qkv, causal=True, window=window), 0.0
            want = flk.flash_attention_plain(*qkv, causal=True, window=window)
        err = max(float((got.float() - want.float()).abs().max().item()), lse_err)
        ms = cuda_ms(call, REPS)
        plain_ms = cuda_ms(lambda: flk.flash_attention_plain(*qkv, causal=True, window=window), 1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in qkv)
        if window:
            mask = flk._admissible(s, t, True, window, dev)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        else:
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_err = float((sdpa().transpose(1, 2).float() - want.float()).abs().max().item())
        library_ms = cuda_ms(sdpa, REPS)
        nbytes, flops = flash_work(b, s, t, h, d, dv, window, qkv[0].element_size())
        if lse:  # the row log-sum-exp, float32 [B, H, S], written once
            nbytes += b * h * s * 4
        rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
        record("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_kernel.py:101", err, tol, ms, plain_ms, nbytes, flops,
               f"[{b},S={s},T={t},{h},d={d},dv={dv}] {str(dtype)[6:]} causal window={window}"
               f"{' fused-qkv views' if fused else ''}{' with lse' if lse else ''}"
               f" (sdpa max_abs_err {lib_err:.3g})",
               rate, library_ms)
        del qkv, got, want, qt, kt, vt
    torch.cuda.empty_cache()


def flash_phase(seed) -> None:
    """B.6's forward alone (``--only flash``): ``flash_forward_checks`` then
    ``flash_edge_phase``, its rows in a ``flash`` line."""
    checks = []

    def record(name, source, replaces, err, tol, ms, plain_ms, nbytes, nops, shape, ops_per_s, library_ms):
        b_ms, b_by = bound(nbytes, nops, ops_per_s)
        checks.append({"shape": shape, "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                       "kernel_to_library": ms / library_ms})
        if not err <= tol:
            emit({"phase": "flash", "checks": checks})
            raise AssertionError(f"{name} {shape}: kernel disagrees with its plain version "
                                 f"(max_abs_err={err}, tolerance {tol})")

    flash_forward_checks(seed, record)
    emit({"phase": "flash", "gpu": nvidia_smi(), "checks": checks})
    flash_edge_phase(seed)


def kernel_phase(seed, corpus) -> tuple[dict[str, dict], list[dict]]:
    from repro_torch.core import encoding, xash
    from repro_torch.kernels import filter_kernel as fk
    from repro_torch.kernels import xash_kernel as xk

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n, q, tb = 1 << LOG_N, N_KEYS, N_TABLES
    results: dict[str, dict] = {}
    checks: list[dict] = []

    def record(name, source, replaces, err, tol, ms, plain_ms, nbytes, nops, shape,
               ops_per_s=INT32_OPS_PER_S, library_ms=None):
        b_ms, b_by = bound(nbytes, nops, ops_per_s)
        checks.append({"kernel": name, "shape": shape, "max_abs_err": err, "tolerance": tol,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": library_ms,
                       "kernel_to_library": None if library_ms is None else ms / library_ms})
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: kernel disagrees with its plain version "
                                 f"(max_abs_err={err}, tolerance {tol})")
        if name not in results:  # the first shape of each kernel is its headline row
            results[name] = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": err, "max_abs_diff": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms, "shape": shape,
            }

    flash_forward_checks(seed, record)
    flash_edge_phase(seed)

    store16, rows, query16, elig, seg = make_filter_inputs(
        rng, dev, 1 << LOG_STORE, 16, n, q, tb
    )
    torch.cuda.synchronize()

    # B.2 gather_filter_table_counts: 512-bit store, then 128-bit store, then
    # the lane-prefix degrade (4 lanes probed over the 16-lane store), then
    # the main path's shapes on the 128-bit store
    store4 = store16[:, :4].contiguous()
    query4 = query16[:, :4].contiguous()
    gather_cases = [("512-bit", store16, query16, elig), ("128-bit", store4, query4, elig),
                    ("4 of 16 lanes", store16, query4, elig)]
    main_shapes = []  # (label, query keys, elig) at 128 bits, for B.2 and B.1
    for label, keys, kind in GATHER_MAIN_SHAPES:
        qs = query4 if keys == q else make_queries(rng, store4, rows, keys)
        el = None if kind is None else make_elig(rng, dev, n, keys, kind)
        main_shapes.append((label, qs, el))
        gather_cases.append((f"128-bit {label}", store4, qs, el))
    for label, st, qs, el in gather_cases:
        lanes, keys = qs.shape[1], qs.shape[0]
        got = fk.gather_filter_table_counts(rows, st, qs, el, seg, n_tables=tb)
        want = fk.gather_filter_table_counts_plain(rows, st, qs, el, seg, tb, keys)
        ms = cuda_ms(lambda: fk.gather_filter_table_counts(rows, st, qs, el, seg, n_tables=tb), REPS)
        plain_ms = cuda_ms(lambda: fk.gather_filter_table_counts_plain(rows, st, qs, el, seg, tb, keys), 1)
        nbytes = gather_bytes(rows, st.shape[1], lanes, keys, tb, el is not None)
        nops = int(el.sum()) if el is not None else n * keys  # pairs that need a test
        record("gather_filter_table_counts", "src/repro_torch/kernels/csrc/filter_counts.cu",
               "src/repro/kernels/filter_kernel.py:447", max_abs_err(got, want), 0, ms, plain_ms,
               nbytes, nops, f"{label} store [{st.shape[0]},{st.shape[1]}], n={n}, q={keys}, tables={tb}")
    del gather_cases

    # B.2 over lane prefixes of the 16-lane store, exactly: those that are
    # not multiples of 4 take the word-by-word row copies, 4 the 16-byte ones
    lane_prefixes, pairs = [], int(elig.sum())
    for lanes in KERNEL_LANES:
        qs = query16[:, :lanes].contiguous()
        call = lambda: fk.gather_filter_table_counts(rows, store16, qs, elig, seg, n_tables=tb)
        err = max_abs_err(call(), fk.gather_filter_table_counts_plain(rows, store16, qs, elig, seg, tb, q))
        if err:
            raise AssertionError(f"gather_filter_table_counts at {lanes} of 16 lanes: kernel disagrees "
                                 f"with its plain version (max_abs_err={err})")
        b_ms, b_by = bound(gather_bytes(rows, 16, lanes, q, tb, True), pairs)
        lane_prefixes.append({"lanes": lanes, "max_abs_err": err, "ms": cuda_ms(call, REPS),
                              "bound_ms": b_ms, "bound_by": b_by})

    # B.1 filter_table_counts on host-gathered rows: its headline shapes
    # ('sum' at 512 and 128 bits, 'any' at 512), then at 128 bits the main
    # path's shapes, 'any' over one and over two query tiles, phantom
    # columns past n_queries, and padding rows; table and key counts exact
    seg_pad = seg.clone()
    seg_pad[::8] = -1
    q300, el300 = next((qs, el) for label, qs, el in main_shapes if qs.shape[0] == 300)
    b1_cases = [("512-bit sum", query16, elig, seg, q, "sum"), ("128-bit sum", query4, elig, seg, q, "sum"),
                ("512-bit any", query16, elig, seg, q, "any")]
    b1_cases += [(f"128-bit sum {label}", qs, el, seg, qs.shape[0], "sum") for label, qs, el in main_shapes]
    b1_cases += [("128-bit any", query4, elig, seg, q, "any"),
                 ("128-bit any q=300 (two query tiles)", q300, el300, seg, 300, "any"),
                 ("128-bit sum n_queries=200 of q=256 (phantom columns)", query4, elig, seg, 200, "sum"),
                 ("128-bit sum seg=-1 on every 8th row", query4, elig, seg_pad, q, "sum"),
                 ("128-bit any q=300 n_queries=290 seg=-1 on every 8th row", q300, el300, seg_pad, 290, "any")]
    row_sk = {16: store16[rows.long()].contiguous()}
    row_sk[4] = row_sk[16][:, :4].contiguous()
    for label, qs, el, sg, nq, mode in b1_cases:
        lanes, keys = qs.shape[1], qs.shape[0]
        rs = row_sk[lanes]
        call = lambda: fk.filter_table_counts(rs, qs, el, sg, n_tables=tb, n_queries=nq, mode=mode)
        plain = lambda: fk.filter_table_counts_plain(rs, qs, el, sg, tb, nq, mode)
        got, want = call(), plain()
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        ms = cuda_ms(call, REPS)
        plain_ms = cuda_ms(plain, 1)
        nbytes, nops = counts_work(n, lanes, nq, keys, tb, el, sg)
        record("filter_table_counts", "src/repro_torch/kernels/csrc/filter_counts.cu",
               "src/repro/kernels/filter_kernel.py:248", err, 0, ms, plain_ms,
               nbytes, nops, f"{label}, n={n}, q={keys}, n_queries={nq}, tables={tb}")
    del row_sk, main_shapes, q300, el300, seg_pad

    # B.4 filter_match and B.5 filter_count on the same rows
    b4 = ("filter_match", "src/repro_torch/kernels/csrc/filter_counts.cu",
          "src/repro/kernels/filter_kernel.py:103")
    b5 = ("filter_count", "src/repro_torch/kernels/csrc/filter_counts.cu",
          "src/repro/kernels/filter_kernel.py:477")
    for label, qs in (("512-bit", query16), ("128-bit", query4)):
        lanes = qs.shape[1]
        row_sk = store16[rows.long(), :lanes].contiguous()
        for (name, source, replaces), call, plain, work in (
                (b4, fk.filter_match, fk.filter_match_plain, match_work),
                (b5, fk.filter_count, fk.filter_count_plain, count_work)):
            err = max_abs_err(call(row_sk, qs), plain(row_sk, qs))
            ms = cuda_ms(lambda: call(row_sk, qs), REPS)
            plain_ms = cuda_ms(lambda: plain(row_sk, qs), 1)
            record(name, source, replaces, err, 0, ms, plain_ms, *work(n, lanes, q),
                   f"{label}, n={n}, q={q}")
        del row_sk
    del store16, store4, rows, elig, seg
    torch.cuda.empty_cache()

    # B.4 and B.5 at every edge shape, exactly; one check line per kernel
    # and lane count
    for lanes in EDGE_LANES:
        all_rows = edge_rows(rng, dev, max(EDGE_N), lanes)
        errs = {"filter_match": 0, "filter_count": 0}
        for nr in EDGE_N:
            rs = all_rows[:nr]
            for nq in EDGE_Q:
                qs = edge_queries(rng, rs, nq)
                for name, call, plain in (("filter_match", fk.filter_match, fk.filter_match_plain),
                                          ("filter_count", fk.filter_count, fk.filter_count_plain)):
                    err = max_abs_err(call(rs, qs), plain(rs, qs))
                    if err:
                        raise AssertionError(f"{name} n={nr} q={nq} lanes={lanes}: kernel disagrees "
                                             f"with its plain version (max_abs_err={err})")
                    errs[name] = max(errs[name], err)
        for name, err in errs.items():
            checks.append({"kernel": name, "shape": f"edge shapes n {list(EDGE_N)} x q {list(EDGE_Q)}, "
                           f"{lanes} lanes, all-ones and zero rows, all-zero and all-ones queries",
                           "max_abs_err": err, "tolerance": 0})
        del all_rows
    nr, nq = BIG_MATCH
    rs = edge_rows(rng, dev, nr, 4)
    qs = edge_queries(rng, rs, nq)
    err = max_abs_err(fk.filter_match(rs, qs), fk.filter_match_plain(rs, qs))
    checks.append({"kernel": "filter_match", "shape": f"n={nr}, q={nq}, 4 lanes (n·q = {nr * nq})",
                   "max_abs_err": err, "tolerance": 0})
    if err:
        raise AssertionError(f"filter_match n={nr} q={nq}: kernel disagrees with its plain version")
    del rs, qs
    torch.cuda.empty_cache()

    # B.3 xash_superkey on the corpus's own values, with its rank vector
    uniq_np = corpus.unique_enc
    uniq = torch.from_numpy(uniq_np).to(dev)
    freq = tuple(corpus.char_frequencies().tolist())
    for label, n_rows, n_cols in (("values", 1 << (LOG_N + 2), 1), ("rows", n, 4)):
        pick = torch.from_numpy(rng.integers(0, uniq.shape[0], size=n_rows * n_cols)).to(dev)
        enc = uniq[pick].reshape(n_rows, n_cols, encoding.MAX_LEN).contiguous()
        for bits in (128, 512):
            cfg = xash.XashConfig(bits=bits, char_freq=freq)
            got = xk.xash_superkey(enc, cfg)
            want = xk.xash_superkey_plain(enc, cfg)
            ms = cuda_ms(lambda: xk.xash_superkey(enc, cfg), REPS)
            plain_ms = cuda_ms(lambda: xk.xash_superkey_plain(enc, cfg), 1)
            nbytes, nops = xash_work(enc, cfg)
            record("xash_superkey", "src/repro_torch/kernels/csrc/xash_superkey.cu",
                   "src/repro/kernels/xash_kernel.py:123", max_abs_err(got, want), 0, ms, plain_ms,
                   nbytes, nops, f"{label} [{n_rows},{n_cols},{encoding.MAX_LEN}] at {bits} bits")
        del enc, pick

    # B.3 edge inputs, each held exactly at 128/256/512 bits under all 8
    # combinations of the ablation flags (and n_char_bits = 11, past the
    # kernel's register selection), one check line per input
    edge = xash_edge_inputs(rng, uniq_np, 1001, encoding.MAX_LEN)
    edge_cases = [("edge rows [1001,3,48]", edge),
                  ("query keys [30,3,48]", edge[rng.permutation(1001)[:30]]),
                  ("edge rows, width 20 [1001,3,20]", xash_edge_inputs(rng, uniq_np, 1001, 20)),
                  ("edge rows, width 80 [1001,3,80]", xash_edge_inputs(rng, uniq_np, 1001, 80)),
                  ("one row [1,3,48]", edge[:1])]
    cfgs = [xash.XashConfig(bits=bits, char_freq=freq, use_location=bool(f & 1),
                            use_length=bool(f & 2), use_rotation=bool(f & 4))
            for bits in (128, 256, 512) for f in range(8)]
    cfgs.append(xash.XashConfig(bits=128, char_freq=freq, n_ones=12))
    for label, arr in edge_cases:
        enc = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        err = max(max_abs_err(xk.xash_superkey(enc, cfg), xk.xash_superkey_plain(enc, cfg)) for cfg in cfgs)
        checks.append({"kernel": "xash_superkey", "shape": f"{label}, {len(cfgs)} configs",
                       "max_abs_err": err, "tolerance": 0})
        if err:
            raise AssertionError(f"xash_superkey {label}: kernel disagrees with its plain version "
                                 f"(max_abs_err={err})")
    del uniq
    torch.cuda.synchronize()
    emit({"phase": "kernels", "checks": checks})
    return results, lane_prefixes


# ---------------------------------------------------------------------------
# Phase 3: the port's main path
# ---------------------------------------------------------------------------

def key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


def first_layers(tree, n: int):
    """The first ``n`` layers of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def counters() -> dict:
    """Every kernel wrapper, by name; each counts its own launches."""
    from repro_torch.kernels import filter_kernel as fk
    from repro_torch.kernels import flash_kernel as flk
    from repro_torch.kernels import xash_kernel as xk

    wrappers = {
        "filter_table_counts": fk.filter_table_counts,
        "gather_filter_table_counts": fk.gather_filter_table_counts,
        "xash_superkey": xk.xash_superkey,
        "filter_match": fk.filter_match,
        "filter_count": fk.filter_count,
        "flash_attention": flk.flash_attention,
        "flash_attention_backward": flk.flash_attention_backward,
    }
    return wrappers


@contextlib.contextmanager
def record_shapes(module, name: str, shape_of):
    """While active, every call of the kernel wrapper ``module.name`` that
    launches appends ``shape_of(*args)`` (None: no launch) to the yielded
    list.  The wrapper counts its launches on the function its module name is
    bound to, so the recorder carries the count while installed and hands it
    back after."""
    wrapper, shapes = getattr(module, name), []

    def recording(*args, **kwargs):
        shape = shape_of(*args, **kwargs)
        if shape is not None:
            shapes.append(shape)
        return wrapper(*args, **kwargs)

    recording.launches = wrapper.launches
    setattr(module, name, recording)
    try:
        yield shapes
    finally:
        wrapper.launches = recording.launches
        setattr(module, name, wrapper)


def b2_shape(rows, store, query_sk, elig, seg_ids, *, n_tables, n_queries=None):
    """(candidate rows, query keys, lanes) of one B.2 launch."""
    keys = query_sk.shape[0] if n_queries is None else n_queries
    return int(rows.shape[0]), int(keys), int(query_sk.shape[1])


def b2_probe(rows, store, query_sk, elig, seg_ids, *, n_tables, n_queries=None):
    """(candidate rows, query keys, probed lanes, store lanes) of one B.2 launch."""
    n, keys, lanes = b2_shape(rows, store, query_sk, elig, seg_ids, n_tables=n_tables, n_queries=n_queries)
    return n, keys, lanes, int(store.shape[1])


def b4_shape(row_sk, query_sk):
    """(rows, query keys, lanes) of one B.4 launch; None when it launches nothing."""
    n, q = int(row_sk.shape[0]), int(query_sk.shape[0])
    return (n, q, int(row_sk.shape[1])) if n and q else None


def b3_shape(enc, cfg):
    """(rows, cells per row, lanes) of one B.3 launch; None when it launches nothing."""
    return (int(enc.shape[0]), int(enc.shape[1]), cfg.lanes) if enc.shape[0] else None


def shape_histogram(shapes, second: str = "keys") -> dict:
    """Launch counts by rows (powers of two), the second dimension (query
    keys of B.2 and B.4, cells per row of B.3) and lanes."""
    def hist(values):
        return dict(sorted(collections.Counter(values).items()))

    rows = [n for n, _, _ in shapes]
    return {"launches": len(shapes), "rows_total": sum(rows), "rows_max": max(rows, default=0),
            "rows_le_pow2": hist(1 << max(n - 1, 0).bit_length() for n in rows),
            second: hist(k for _, k, _ in shapes), "lanes": hist(l for _, _, l in shapes)}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


@contextlib.contextmanager
def path_window(total: collections.Counter):
    """A window around a path's own calls: every launch count is set to 0
    on entering, and on leaving the counts are added to ``total``.  Set-up
    (index builds), references and checks run outside the windows."""
    zero_counts()
    yield
    total.update({name: fn.launches for name, fn in counters().items()})


def check_counts(total, names, path: str) -> dict[str, int]:
    """Every kernel's launches counted in ``total``; raises if one of
    ``names``, the kernels the path must run, never launched."""
    got = {name: int(total[name]) for name in counters()}
    missing = [name for name in names if got[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path}: {missing}")
    return got


def read_counts(names, path: str) -> dict[str, int]:
    """Every kernel's launch count since ``zero_counts`` (``check_counts``)."""
    return check_counts({name: fn.launches for name, fn in counters().items()}, names, path)


MAIN_PATH_KERNELS = ("filter_table_counts", "gather_filter_table_counts", "xash_superkey",
                     "filter_match")
# the path whose run gives each kernel's ``launches`` in the kernels line
HOME_PATH = {**{name: "main_path" for name in MAIN_PATH_KERNELS}, "filter_count": "ops_path",
             "flash_attention": "serve", "flash_attention_backward": "train"}


def main_path_phase(corpus, truth, mixed, b2_shapes, b3_shapes, b4_shapes):
    from repro_torch.core import discovery
    from repro_torch.core.session import DiscoveryConfig, MateSession

    def snapshot():
        return {name: counters()[name].launches for name in MAIN_PATH_KERNELS}

    zero_counts()
    wall: dict[str, float] = {}

    t0 = time.perf_counter()
    session = MateSession.build(corpus, DiscoveryConfig())
    torch.cuda.synchronize()
    wall["build"] = time.perf_counter() - t0
    if session.backend.name != "fused-gather":
        raise AssertionError(f"default backend on CUDA resolved to {session.backend.name}")
    bs = session.build_stats
    emit({"phase": "build", "build_stats": {
        k: v for k, v in vars(bs).items() if not isinstance(v, list)
    }, "wall_s": wall["build"]})

    others = {
        name: MateSession(session.index, DiscoveryConfig(backend=name))
        for name in ("fused", "pallas", "numpy")
    }

    def discover_all(label):
        t = time.perf_counter()
        results = []
        for (query, q_cols, _expected) in truth:
            got, _ = session.discover(query, q_cols)
            results.append(got)
            for name, other in others.items():
                alt, _ = other.discover(query, q_cols)
                if key(alt) != key(got):
                    raise AssertionError(f"{label}: top-k under {name} differs from fused-gather")
        torch.cuda.synchronize()
        wall[label] = time.perf_counter() - t
        return results

    results = discover_all("discover")
    # the last ground-truth query (its plants are intact) against the
    # brute-force oracle: the same joinabilities (a tie at the k-th place may
    # keep another table), each entry exact, and a planted table found at no
    # less than its plant
    q0, q0_cols, expected = truth[-1]
    brute = discovery.topk_bruteforce(corpus, q0, q0_cols, session.config.k)
    got = results[-1]
    if sorted(e.joinability for e in got) != sorted(j for _, j in brute):
        raise AssertionError("discover disagrees with topk_bruteforce")
    for e in got:
        if discovery.joinability_bruteforce(corpus, e.table_id, q0, q0_cols) != e.joinability:
            raise AssertionError(f"table {e.table_id}: joinability differs from brute force")
    if not any(expected.get(e.table_id, 10**9) <= e.joinability for e in got):
        raise AssertionError("no planted table in the top-k")
    same_set = sorted((e.table_id, e.joinability) for e in got) == sorted(brute)

    # one discover of that query under each backend: its launches and its
    # host wall time (ends in a device sync)
    per_discover = {}
    for name, sess in [("fused-gather", session), *others.items()]:
        before, t = snapshot(), time.perf_counter()
        sess.discover(q0, q0_cols)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t
        after = snapshot()
        per_discover[name] = {"wall_s": elapsed,
                              "launches": {k: after[k] - before[k] for k in after}}
    emit({"phase": "one_discover", "query_rows": len(q0.cells), "bruteforce_identical": same_set,
          "per_backend": per_discover})

    t = time.perf_counter()
    group = mixed
    many = session.discover_many(group)
    for name, other in others.items():
        alt = other.discover_many(group)
        if [key(a) for a, _ in alt] != [key(m) for m, _ in many]:
            raise AssertionError(f"discover_many under {name} differs from fused-gather")
    for (query, q_cols), (entries, _) in zip(group, many):
        solo, _ = session.discover(query, q_cols)
        if key(solo) != key(entries):
            raise AssertionError("discover_many differs from solo discover")
    torch.cuda.synchronize()
    wall["discover_many"] = time.perf_counter() - t

    # §5.4: rewrite one cell of the best table, then discover again
    store_before = session.index.device_store()
    top = results[0][0]
    session.update_cell(top.table_id, 0, 0, "mutated cell value")
    if session.index.device_store() is store_before:
        raise AssertionError("device store did not refresh after update_cell")
    after = discover_all("discover_after_update")
    if not after:
        raise AssertionError("no queries after update")
    torch.cuda.synchronize()

    launches = snapshot()
    emit({"phase": "main_path", "queries": len(truth), "group": len(group),
          "wall_s": wall, "session_stats": vars(session.stats), "launches": launches,
          "b2_launch_shapes": shape_histogram(b2_shapes),
          "b3_launch_shapes": shape_histogram(b3_shapes, "cells_per_row"),
          "b4_launch_shapes": shape_histogram(b4_shapes),
          "top1": [key(r[:1]) for r in results]})
    return read_counts(MAIN_PATH_KERNELS, "main path"), session


# ---------------------------------------------------------------------------
# Phase 4: ops.filter_count on the session's own superkeys
# ---------------------------------------------------------------------------

def ops_phase(session, truth) -> dict[str, int]:
    """``ops.filter_count`` (B.5) and the C.5 wrappers at this path's
    shapes: ``ops.superkey`` (B.3) over the ground-truth queries' keys,
    equal to the index's own key superkeys; ``ops.xash_values`` (B.3) over
    the lake's unique values, equal to the build's value lanes;
    ``ops.filter_match`` (B.4) over the superkeys × those keys, whose column
    sums are the B.5 counts.  One call of each is counted; each is then
    timed beside its plain version on the same CUDA inputs (both read back
    to the host, as the wrapper does)."""
    from repro_torch.core import encoding
    from repro_torch.core.xash import lanes_to_numpy, lanes_to_torch
    from repro_torch.kernels import filter_kernel as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels import xash_kernel as xk

    keys = list(dict.fromkeys(
        tuple(row[c] for c in q_cols) for query, q_cols, _ in truth for row in query.cells))
    q_sk = session.index.superkey_of_keys(keys)
    rows = session.index.superkeys
    cfg = session.index.cfg
    corpus = session.index.corpus
    dev = torch.device("cuda")
    enc_keys = encoding.encode_values([v for k in keys for v in k], cfg.max_len).reshape(
        len(keys), len(keys[0]), cfg.max_len)
    zero_counts()
    t = time.perf_counter()
    counts = ops.filter_count(rows, q_sk, device=dev)
    wall = time.perf_counter() - t
    key_sk = ops.superkey(enc_keys, cfg, device=dev)
    value_lanes = ops.xash_values(corpus.unique_enc, cfg, device=dev)
    match = ops.filter_match(rows, q_sk, device=dev)
    launches = read_counts(("filter_count", "xash_superkey", "filter_match"), "ops path")
    match_sum = ops.filter_match_auto(rows, q_sk, "pallas", device=dev).sum(axis=0, dtype=np.int32)
    if not np.array_equal(counts, match_sum):
        raise AssertionError("ops.filter_count differs from the match matrix's column sums")
    if not np.array_equal(match.sum(axis=0, dtype=np.int32), counts):
        raise AssertionError("ops.filter_match's column sums differ from ops.filter_count")
    if not np.array_equal(key_sk, q_sk):
        raise AssertionError("ops.superkey differs from the index's key superkeys")
    if not np.array_equal(value_lanes, session.index.value_lanes):
        raise AssertionError("ops.xash_values differs from the build's value lanes")
    # B.5 at this path's own shape
    rt, qt = lanes_to_torch(rows, dev), lanes_to_torch(q_sk, dev)
    err = max_abs_err(fk.filter_count(rt, qt), fk.filter_count_plain(rt, qt))
    if err:
        raise AssertionError(f"filter_count at the ops path's shape: max_abs_err={err}")
    b_ms, b_by = bound(*count_work(rt.shape[0], rt.shape[1], qt.shape[0]))
    # the wrappers on CUDA tensors, each against its plain version on them
    enc_t = torch.from_numpy(enc_keys).to(dev)
    val_t = torch.from_numpy(corpus.unique_enc).to(dev)
    wrappers = {
        "superkey": (lambda: ops.superkey(enc_t, cfg),
                     lambda: lanes_to_numpy(xk.xash_superkey_plain(enc_t, cfg)),
                     xash_work(enc_t, cfg), f"keys [{len(keys)}, {enc_keys.shape[1]}, {cfg.max_len}]"),
        "xash_values": (lambda: ops.xash_values(val_t, cfg),
                        lambda: lanes_to_numpy(xk.xash_superkey_plain(val_t[:, None], cfg)),
                        xash_work(val_t[:, None], cfg), f"values [{val_t.shape[0]}, {cfg.max_len}]"),
        "filter_match": (lambda: ops.filter_match(rt, qt),
                         lambda: fk.filter_match_plain(rt, qt).view(torch.bool).cpu().numpy(),
                         match_work(rt.shape[0], rt.shape[1], qt.shape[0]),
                         f"rows {rt.shape[0]} x keys {qt.shape[0]} x {rt.shape[1]} lanes"),
    }
    timed = {}
    for name, (kernel, plain, work, shape) in wrappers.items():
        got, want = kernel(), plain()
        if not np.array_equal(got, want):
            raise AssertionError(f"ops.{name} differs from its plain version on the card")
        w_ms, w_by = bound(*work)
        timed[name] = {"shape": shape, "max_abs_err": 0, "ms": cuda_ms(kernel, REPS),
                       "plain_ms": cuda_ms(plain, 1), "bound_ms": w_ms, "bound_by": w_by}
    emit({"phase": "ops_path", "rows": int(rows.shape[0]), "lanes": int(rows.shape[1]),
          "query_keys": int(q_sk.shape[0]), "counts_min": int(counts.min()),
          "counts_max": int(counts.max()), "wall_s": wall, "launches": launches,
          "filter_count": {"max_abs_err": err, "ms": cuda_ms(lambda: fk.filter_count(rt, qt), REPS),
                           "plain_ms": cuda_ms(lambda: fk.filter_count_plain(rt, qt), 1),
                           "bound_ms": b_ms, "bound_by": b_by},
          "wrappers": timed})
    return launches


# ---------------------------------------------------------------------------
# Lane prefixes through the engines (filter_lanes), against 'numpy'
# ---------------------------------------------------------------------------

def lanes_phase(sessions, truth, mixed, lane_prefixes) -> dict[str, int]:
    """``plan_and_count`` and ``discover_many`` at each lane prefix of
    ``SESSION_LANES`` under 'fused-gather' against 'numpy': per-table counts
    and top-k exactly equal, the verified set equal to the full width's.
    The ground-truth group's launch is B.2 on the session's device store,
    at every prefix.  The mixed group holds more candidate tables than one
    fused launch takes (8192), so its launch demotes to B.4 on the
    host-gathered lane prefix, as the reference's does: its counts are held
    at every prefix, its ``discover_many`` only at ``MIXED_MANY_LANES``
    (at 1–3 lanes it verifies 0.4–2.3 M survivors on the host, and B.4 is
    the main path's kernel).  Launches are counted around the
    'fused-gather' calls only."""
    from repro_torch.core import batched
    from repro_torch.kernels import filter_kernel as fk

    t_phase = time.perf_counter()
    total = collections.Counter()
    out, counted = [], []  # counted: the B.2 probes inside the windows
    groups = {"mixed": list(mixed), "truth": [(q, c) for q, c, _ in truth]}
    with record_shapes(fk, "gather_filter_table_counts", b2_probe) as probes, \
            record_shapes(fk, "filter_match", b4_shape) as b4_launches:
        for bits, prefixes in SESSION_LANES.items():
            index, cfg = sessions[bits].index, sessions[bits].config
            kw = dict(init_mode=cfg.init_mode, profile_gate=cfg.profile_gate)
            many = dict(k=cfg.k, rank=cfg.rank, **kw)
            for label, group in groups.items():
                with_many = [fl for fl in prefixes if label == "truth" or fl in MIXED_MANY_LANES]
                full = (batched.discover_many(index, group, backend="fused-gather", **many)
                        if with_many else None)
                for fl in prefixes:
                    n_b2, n_b4 = len(probes), len(b4_launches)
                    t = time.perf_counter()
                    with path_window(total):
                        pcs = batched.plan_and_count(index, group, "fused-gather", filter_lanes=fl, **kw)
                        got = (batched.discover_many(index, group, backend="fused-gather", filter_lanes=fl,
                                                     **many) if fl in with_many else None)
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                    b2, b4 = len(probes) - n_b2, len(b4_launches) - n_b4
                    counted += probes[n_b2:]
                    want_pcs = batched.plan_and_count(index, group, "numpy", filter_lanes=fl, **kw)
                    where = f"{label} group at {fl} of {index.cfg.lanes} lanes"
                    for pc, w in zip(pcs, want_pcs):
                        if pc.filter_lanes != fl or not np.array_equal(pc.counts, w.counts):
                            raise AssertionError(f"plan_and_count of the {where} differs from numpy")
                    row = {"bits": bits, "group": label, "filter_lanes": fl,
                           "candidate_tables": sum(pc.plan.block.n_tables for pc in pcs),
                           "counts_identical": True, "b2_launches": b2, "b4_launches": b4,
                           "wall_s": wall}
                    if got is not None:
                        # 'numpy' discover_many is exactly its plan_and_count
                        # scored per request: one numpy launch serves both
                        want = [batched.score_from_counts(index, pc, cfg.k, rank=cfg.rank) for pc in want_pcs]
                        for (g, _), (w, _), (f, _) in zip(got, want, full):
                            if key(g) != key(w):
                                raise AssertionError(f"discover_many of the {where} differs from numpy")
                            if sorted(key(g)) != sorted(key(f)):
                                raise AssertionError(f"discover_many of the {where} verified another set")
                        stats = [st for _, st in got]
                        row.update({"topk_identical": True,
                                    "filter_passed": sum(st.filter_passed for st in stats),
                                    "full_width_filter_passed": sum(st.filter_passed for _, st in full),
                                    "verified_fp": sum(st.verified_fp for st in stats),
                                    "gather_bytes_saved": sum(st.gather_bytes_saved for st in stats)})
                    out.append(row)
    probed = collections.Counter((p[2], p[3]) for p in counted)
    missing = [(fl, bits // 32) for bits, prefixes in SESSION_LANES.items() for fl in prefixes
               if not probed[fl, bits // 32]]
    if missing:
        raise AssertionError(f"B.2 never probed these (lanes, store lanes) through the engines: {missing}")
    launches = check_counts(total, ("gather_filter_table_counts",), "lanes path")
    emit({"phase": "lanes", "sessions": out,
          "b2_probes_by_lanes": {f"{a} of {b}": n for (a, b), n in sorted(probed.items())},
          "b2_lane_prefixes": lane_prefixes, "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# The FD workload
# ---------------------------------------------------------------------------

def planted_fd_lake(seed: int):
    """(corpus, query, determinant_cols, dependent_col): ``tests/test_fd.py``'s
    planted-FD lake — violating groups, a duplicate row, empty strings,
    clean tables, violators, near-misses, a permuted match, a zero-row
    table and seeded noise."""
    from repro_torch.core.corpus import Corpus, Table

    rng = np.random.default_rng(seed)
    n_keys = 6
    keys = [(f"a{seed}k{r}", f"b{seed}k{r}") for r in range(n_keys)]
    q_cells = []
    for r, (a, b) in enumerate(keys):
        q_cells.append([a, b, f"d{r}"])
        if r < 2:
            q_cells.append([a, b, f"d{r}x"])
        if r == 2:
            q_cells.append([a, b, f"d{r}"])
    q_cells.append(["", f"b{seed}nul", ""])
    query = Table(-1, q_cells, name=f"fd query {seed}")
    tables = [
        Table(0, [[a, b, f"p{seed}"] for a, b in keys[2:]], name="clean wide"),
        Table(1, [[keys[3][0], keys[3][1], "q"], [keys[4][0], keys[4][1], "q"]], name="clean two"),
        Table(2, [[keys[0][0], keys[0][1], "v"], [keys[2][0], keys[2][1], "v"]], name="violator a"),
        Table(3, [[keys[1][0], keys[1][1], "w"]], name="violator b"),
        Table(4, [[keys[0][0], f"zz{seed}"], [f"yy{seed}", keys[0][1]], [keys[5][0], keys[5][1]]],
              name="near miss"),
        Table(5, [["pad", keys[5][1], keys[5][0]]], name="permuted"),
        Table(6, [["", f"b{seed}nul", "k"]], name="empty det"),
        Table(7, [], name="zero rows"),
    ]
    for _ in range(8):
        tid = len(tables)
        r = int(rng.integers(n_keys))
        tables.append(Table(tid, [[keys[r][0], f"n{tid}x{j}{seed}"] for j in range(int(rng.integers(1, 4)))]))
    return Corpus(tables), query, [0, 1], 2


def _row_matches(key: tuple, row: list) -> bool:
    """Some assignment of distinct row columns equals the key position-wise."""
    per_col = [[c for c, v in enumerate(row) if v == qv] for qv in key]
    if len(row) < len(key) or any(not cols for cols in per_col):
        return False
    stack = [(0, frozenset())]
    while stack:
        i, used = stack.pop()
        if i == len(key):
            return True
        stack.extend((i + 1, used | {c}) for c in per_col[i] if c not in used)
    return False


def fd_oracle(corpus, query, det_cols, dep_col, min_support=1):
    """{table_id: (support, holds, violations, matched keys)} by scanning the
    rows of every table that holds one of the query's determinant values."""
    dep_of_key: dict[tuple, set] = {}
    for row in query.cells:
        dep_of_key.setdefault(tuple(row[c] for c in det_cols), set()).add(row[dep_col])
    values = {v for k in dep_of_key for v in k}
    out = {}
    for t in corpus.tables:
        rows = [row for row in t.cells if values.intersection(row)]
        matched = {k for k in dep_of_key if any(_row_matches(k, row) for row in rows)}
        if rows and len(matched) >= min_support:
            viol = sum(1 for k in matched if len(dep_of_key[k]) > 1)
            out[t.table_id] = (len(matched), viol == 0, viol, matched)
    return out


def fd_verdicts(fds):
    return [(c.table_id, c.support, c.holds, c.violations) for c in fds]


def fd_phase(session, truth) -> dict[str, int]:
    """``MateSession.discover_fds`` on the smoke lake (each ground-truth
    query with a second dependent value for its key 2) and on the planted-FD
    lakes at 128/256/512 bits, under 'fused-gather', 'fused' and 'numpy',
    signals off and on: identical verdicts and scored order across backends,
    equal to the brute-force oracle."""
    from repro_torch.core import fd
    from repro_torch.core.corpus import Table
    from repro_torch.core.session import DiscoveryConfig, MateSession
    from repro_torch.kernels import filter_kernel as fk

    def run_all(index, query, det, dep, oracle, label, min_support=1):
        per_signals = {}
        for signals in (None, fd.DEFAULT_SIGNALS):
            got = {}
            for name in FD_BACKENDS:
                sess = MateSession(index, DiscoveryConfig(backend=name, signals=signals))
                n_b2 = len(shapes)
                t = time.perf_counter()
                with path_window(total):
                    fds, stats = sess.discover_fds(query, det, dep, min_support=min_support)
                    torch.cuda.synchronize()
                walls.setdefault(name, []).append(time.perf_counter() - t)
                counted.extend(shapes[n_b2:])
                got[name] = (fd_verdicts(fds), [c.score for c in fds])
                fd_counts.append((stats.fd_candidates, stats.fd_validated))
            first = got[FD_BACKENDS[0]]
            if any(g != first for g in got.values()):
                raise AssertionError(f"{label}: FD verdicts differ across backends (signals={signals})")
            facts = {tid: (sup, holds, viol) for tid, sup, holds, viol in first[0]}
            if facts != {tid: o[:3] for tid, o in oracle.items() if o[0] >= min_support}:
                raise AssertionError(f"{label}: FD verdicts differ from the brute-force oracle")
            per_signals[signals is not None] = first
        if sorted(per_signals[True][0]) != sorted(per_signals[False][0]):
            raise AssertionError(f"{label}: signals changed the FD facts")
        return per_signals[False][0]

    t_phase = time.perf_counter()
    total = collections.Counter()
    walls: dict[str, list[float]] = {}
    fd_counts: list[tuple[int, int]] = []
    counted = []  # B.2 launch shapes inside the windows
    with record_shapes(fk, "gather_filter_table_counts", b2_shape) as shapes:
        lake = []
        for query, q_cols, expected in truth:
            extra = list(query.cells[2])
            extra[2] += " second value"
            fq = Table(-1, [list(r) for r in query.cells] + [extra], name=query.name)
            det, dep = list(q_cols), 2
            oracle = fd_oracle(session.index.corpus, fq, det, dep)
            key2 = tuple(extra[c] for c in det)
            rank0 = next(iter(expected))
            injected = [tid for tid in expected if tid in oracle]
            violators = [tid for tid in injected if key2 in oracle[tid][3]]
            if not violators or any(oracle[tid][1] for tid in violators):
                raise AssertionError("an injected table holding key 2 does not violate")
            if rank0 in oracle and not (key2 not in oracle[rank0][3] and oracle[rank0][1]):
                raise AssertionError("the rank-0 table (keys 0-1 only) does not hold")
            verdicts = run_all(session.index, fq, det, dep, oracle, "smoke lake")
            lake.append({"tables": len(verdicts), "violating": sum(not v[2] for v in verdicts),
                         "injected_matched": len(injected), "rank0_holds": rank0 in oracle})
        planted = []
        for bits in (128, 256, 512):
            for seed in FD_SEEDS:
                corpus_p, query, det, dep = planted_fd_lake(seed)
                index = MateSession.build(corpus_p, DiscoveryConfig(bits=bits)).index
                for ms in (1, 2):
                    oracle = fd_oracle(corpus_p, query, det, dep, ms)
                    verdicts = run_all(index, query, det, dep, oracle, f"planted lake {seed} at {bits} bits", ms)
                    planted.append(len(verdicts))
    launches = check_counts(total, ("gather_filter_table_counts", "filter_table_counts", "xash_superkey"),
                            "FD path")
    emit({"phase": "fd", "smoke_lake": lake, "planted_lakes": {"bits": [128, 256, 512], "seeds": list(FD_SEEDS),
          "min_support": [1, 2], "verdicts_per_run": planted}, "backends": list(FD_BACKENDS),
          "identical_across_backends": True, "equal_to_oracle": True,
          "wall_s_per_discover_fds": {k: sum(v) / len(v) for k, v in walls.items()},
          "fd_candidates": sum(c for c, _ in fd_counts), "fd_validated": sum(v for _, v in fd_counts),
          "b2_launch_shapes": shape_histogram(counted), "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# The routed lake
# ---------------------------------------------------------------------------

def route_accounting(calls) -> tuple[int, int]:
    """(shard launches, count-merge bytes) that host-routed launches owe the
    stats: each call ``(shards it reached, its batch's tables)`` launches once
    per shard and ships each shard's int32 counts vector."""
    return (sum(sh for sh, _ in calls), sum(sh * n * 4 for sh, n in calls))


@contextlib.contextmanager
def record_routed_calls(index):
    """While active, every ``index.routed_counts`` call appends (distinct
    owning shards of its rows, its table count) to the yielded list."""
    calls, inner = [], index.routed_counts

    def recording(rows, query_sk, elig, seg_ids, n_tables, **kw):
        if len(rows) and len(query_sk) and n_tables:
            calls.append((len(np.unique(index._shard_ids_of_rows(rows))), int(n_tables)))
        return inner(rows, query_sk, elig, seg_ids, n_tables, **kw)

    index.routed_counts = recording
    try:
        yield calls
    finally:
        del index.routed_counts


@contextlib.contextmanager
def time_launches(module, name: str):
    """While active, every call of ``module.name`` is timed with CUDA events
    and appended as (rows, query keys, lanes, ms) to the yielded list; the
    launch count carries over as in ``record_shapes``."""
    wrapper, timed = getattr(module, name), []

    def timing(row_sk, query_sk):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = wrapper(row_sk, query_sk)
        end.record()
        end.synchronize()
        timed.append((int(row_sk.shape[0]), int(query_sk.shape[0]), int(row_sk.shape[1]),
                      start.elapsed_time(end)))
        return out

    timing.launches = wrapper.launches
    setattr(module, name, timing)
    try:
        yield timed
    finally:
        wrapper.launches = timing.launches
        setattr(module, name, wrapper)


def routed_mesh_rank(mesh, corpus, groups):
    """One rank of the mesh sub-phase: build the routed session across the
    group (kernel B.3 on this rank's value block, ``all_gather``), attach
    the mesh, and run ``plan_and_count`` of each group under 'fused-gather'
    — this rank launches B.2 (B.4 past the table cap) over its own shard's
    items against its own store on the card, and the counts are
    all-reduced.  Returns the counts, the arena's digest and this rank's
    launch counts."""
    import hashlib

    from repro_torch.core.session import DiscoveryConfig, MateSession

    zero_counts()
    t = time.perf_counter()
    s = MateSession.build(corpus, DiscoveryConfig(backend="fused-gather"), distributed=True, mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    launches_build = {name: fn.launches for name, fn in counters().items()}
    out = {"rank": mesh.rank, "device": str(mesh.device), "build_s": build_s,
           "store_device": str(s.index.shards[mesh.rank].device_store().device),
           "value_lanes": hashlib.sha256(s.index.value_lanes.tobytes()).hexdigest(),
           "counts": {}, "wall_s": {}}
    for label, group in groups.items():
        t = time.perf_counter()
        pcs = s.plan_and_count(group)
        torch.cuda.synchronize()
        out["wall_s"][label] = time.perf_counter() - t
        out["counts"][label] = [pc.counts.tolist() for pc in pcs]
    out["launches"] = {name: fn.launches - launches_build[name] for name, fn in counters().items()}
    out["launches_build"] = launches_build
    return out


def routed_phase(corpus, truth, mixed) -> dict[str, int]:
    """The routed lake on the smoke lake: ``MateSession.build(distributed=True,
    n_shards=4)`` at 128 bits with the default config, beside a single-host
    session built from the same corpus; ``discover`` of the ground-truth
    queries under 'fused-gather', 'fused', 'pallas' and 'numpy',
    ``discover_many`` of the ground-truth and the mixed group, the FD
    queries of the ``fd`` phase and a 16-request ``DiscoveryEngine`` stream,
    every answer equal to the single-host session's (each call timed beside
    it on the host clock); the routed accounting (``shard_launches``,
    ``route_bytes_merged``) equal to what the launches owe; the mixed group,
    past the fused kernels' table cap, on kernel B.4 once per shard (timed
    with CUDA events); ``build_index(n_shards=4)`` byte-identical to the
    single-host build; the mesh mode: ``MESH_RANKS`` ranks spawned on the
    one card over gloo, each launching on the card, whose all-reduced counts
    equal the host-routed counts and whose group-hashed arena equals the
    routed build's; last an ``update_cell`` on an interior shard, to a value already in the
    arena, that moves that shard's epoch and store only (and is undone, the
    corpus's value arena checked unchanged: the corpus is shared with later
    phases).  Launches are counted around the routed calls only."""
    import hashlib

    from repro_torch.core import index as index_lib
    from repro_torch.core.corpus import Table
    from repro_torch.core.session import DiscoveryConfig, MateSession
    from repro_torch.core.xash import lanes_to_numpy
    from repro_torch.kernels import filter_kernel as fk
    from repro_torch.launch import mesh as meshlib
    from repro_torch.serve.engine import DiscoveryEngine

    t_phase = time.perf_counter()
    total = collections.Counter()
    wall: dict[str, dict] = {}

    def clock(label, side, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall.setdefault(label, {}).setdefault(side, []).append(time.perf_counter() - t)
        return out

    def per_request_identity(stats, label):
        for st in stats:
            if st.route_bytes_merged != st.shard_launches * (st.tables_fetched - st.tables_gated) * 4:
                raise AssertionError(f"{label}: route_bytes_merged != shard_launches x n_tables x 4")

    single = clock("build", "single_host", lambda: MateSession.build(corpus, DiscoveryConfig()))
    with path_window(total):
        routed = clock("build", "routed", lambda: MateSession.build(
            corpus, DiscoveryConfig(), distributed=True, n_shards=ROUTED_SHARDS))
    index = routed.index
    if routed.backend.name != "fused-gather" or not index.routed or index.n_shards != ROUTED_SHARDS:
        raise AssertionError(f"routed session: backend {routed.backend.name}, {index!r}")
    if not np.array_equal(index.value_lanes, single.index.value_lanes):
        raise AssertionError("the routed build's value arena differs from the single-host arena")
    arena = hashlib.sha256(index.value_lanes.tobytes()).hexdigest()

    # discover under each backend, beside the single-host session's
    truth_group = [(q, c) for q, c, _ in truth]
    with record_routed_calls(index) as calls:
        for name in ROUTED_BACKENDS:
            r_sess = MateSession(index, DiscoveryConfig(backend=name))
            s_sess = MateSession(single.index, DiscoveryConfig(backend=name))
            for query, q_cols in truth_group:
                n_calls = len(calls)
                with path_window(total):
                    got, st = clock(f"discover[{name}]", "routed", lambda: r_sess.discover(query, q_cols))
                want, _ = clock(f"discover[{name}]", "single_host", lambda: s_sess.discover(query, q_cols))
                if key(got) != key(want):
                    raise AssertionError(f"routed discover under {name} differs from the single-host session")
                if (st.shard_launches, st.route_bytes_merged) != route_accounting(calls[n_calls:]):
                    raise AssertionError("routed discover: the routed accounting differs from its launches")

    with time_launches(fk, "filter_match") as b4_timed:
        for label, group in (("truth", truth_group), ("mixed", list(mixed))):
            n_b4 = len(b4_timed)
            with path_window(total):
                got = clock(f"discover_many[{label}]", "routed", lambda: routed.discover_many(group))
            b4 = b4_timed[n_b4:]
            want = clock(f"discover_many[{label}]", "single_host", lambda: single.discover_many(group))
            if [key(g) for g, _ in got] != [key(w) for w, _ in want]:
                raise AssertionError(f"routed discover_many of the {label} group differs from single-host")
            per_request_identity([st for _, st in got], f"discover_many[{label}]")
            if label == "mixed" and len(b4) != ROUTED_SHARDS:
                raise AssertionError(f"the mixed group ran {len(b4)} B.4 launches, not one per shard")
    b4_mixed = [{"rows": n, "keys": q, "lanes": lanes, "ms": ms} for n, q, lanes, ms in b4]

    # the FD queries of the fd phase
    fd_tables = []
    for query, q_cols, _expected in truth:
        extra = list(query.cells[2])
        extra[2] += " second value"
        fq = Table(-1, [list(r) for r in query.cells] + [extra], name=query.name)
        with path_window(total):
            got, st = clock("discover_fds", "routed", lambda: routed.discover_fds(fq, list(q_cols), 2))
        want, _ = clock("discover_fds", "single_host", lambda: single.discover_fds(fq, list(q_cols), 2))
        if fd_verdicts(got) != fd_verdicts(want):
            raise AssertionError("routed discover_fds differs from the single-host session")
        per_request_identity([st], "discover_fds")
        fd_tables.append(len(got))

    # a DiscoveryEngine stream over each session
    stream = [(truth_group[i % len(truth_group)], 10 if i % 3 else 5) for i in range(ROUTED_STREAM)]

    def serve(sess):
        eng = DiscoveryEngine(session=sess, batch=8)
        reqs = [eng.submit(q, c, k=k) for (q, c), k in stream]
        eng.flush()
        if eng.queue or not all(r.done for r in reqs):
            raise AssertionError("the engine left requests unserved")
        return reqs

    with path_window(total):
        served = clock("engine_stream", "routed", lambda: serve(routed))
    want = clock("engine_stream", "single_host", lambda: serve(MateSession(single.index)))
    if [key(r.results) for r in served] != [key(r.results) for r in want]:
        raise AssertionError("the engine over the routed session answered differently from single-host")
    per_request_identity([r.stats for r in served], "engine")

    # the sharded build, byte-identical to the single-host build
    with path_window(total):
        sharded, sharded_stats = clock("build_index[n_shards=4]", "routed", lambda: index_lib.build_index(
            corpus, use_corpus_char_freq=True, n_shards=ROUTED_SHARDS))
    if not index_lib.index_artifacts_equal(sharded, single.index):
        raise AssertionError("build_index(n_shards=4) artifacts differ from the single-host build")
    del sharded

    # the mesh mode: ranks sharing the one card over gloo
    groups = {"truth": truth_group, "mixed": list(mixed)}
    host_counts = {label: [pc.counts.tolist() for pc in routed.plan_and_count(group)]
                   for label, group in groups.items()}
    ranks = clock("mesh", "routed", lambda: meshlib.run_ranks(  # the default: ranks on the card
        routed_mesh_rank, MESH_RANKS, backend="gloo", args=(corpus, groups), timeout_s=MESH_TIMEOUT_S))
    for r in ranks:
        if r["counts"] != host_counts:
            raise AssertionError(f"mesh rank {r['rank']}: all-reduced counts differ from host-routed")
        if r["value_lanes"] != arena:
            raise AssertionError(f"mesh rank {r['rank']}: the xash_values_mesh arena differs")
        if not r["launches"]["gather_filter_table_counts"] or not r["launches_build"]["xash_superkey"]:
            raise AssertionError(f"mesh rank {r['rank']} launched no B.2 / B.3 on the card")
        if not r["store_device"].startswith("cuda"):
            raise AssertionError(f"mesh rank {r['rank']}: its store is on {r['store_device']}")

    # update_cell on an interior shard: that shard's epoch and store only.
    # The new value is another cell of the same table, already in the value
    # arena, so nothing is interned and the corpus that later phases build
    # from (its character frequencies, hence every superkey) is unchanged.
    stores = [sh.device_store() for sh in index.shards]
    epochs = [sh.mutation_epoch for sh in index.shards]
    n_values = len(corpus.unique_values)
    tid = int(index.shards[1].table_lo)
    old = corpus.tables[tid].cells[0][0]
    new = next(v for r in corpus.tables[tid].cells for v in r if v != old)
    with path_window(total):
        routed.update_cell(tid, 0, 0, new)
        routed.discover(*truth_group[0])
        torch.cuda.synchronize()
    refreshed = [sh.device_store() is not st for sh, st in zip(index.shards, stores)]
    moved = [sh.mutation_epoch - e for sh, e in zip(index.shards, epochs)]
    if refreshed != [i == 1 for i in range(ROUTED_SHARDS)] or moved != [int(i == 1) for i in range(ROUTED_SHARDS)]:
        raise AssertionError(f"update_cell on shard 1: epochs moved {moved}, stores refreshed {refreshed}")
    if not np.array_equal(lanes_to_numpy(index.shards[1].device_store()), index.shards[1].superkeys):
        raise AssertionError("shard 1's refreshed store differs from its superkeys")
    routed.update_cell(tid, 0, 0, old)  # the corpus is shared with later phases
    if len(corpus.unique_values) != n_values or corpus.tables[tid].cells[0][0] != old:
        raise AssertionError("the routed update_cell left the shared corpus changed")

    launches = check_counts(total, ("gather_filter_table_counts", "filter_table_counts", "xash_superkey",
                                    "filter_match"), "routed path")
    emit({"phase": "routed", "n_shards": ROUTED_SHARDS, "bits": index.bits, "tables": len(corpus.tables),
          "shard_row_bounds": index.shard_row_bounds.tolist(),
          "shard_table_bounds": [index.shards[0].table_lo] + [sh.table_hi for sh in index.shards],
          "wall_s_per_call": {label: {side: sum(v) / len(v) for side, v in sides.items()}
                              for label, sides in wall.items()},
          "shard_launches": routed.stats.shard_launches,
          "route_bytes_merged": routed.stats.route_bytes_merged,
          "shard_gather_demotions": routed.stats.shard_gather_demotions,
          "route_identity": True, "answers_equal_single_host": True,
          "mixed_b4_per_shard": b4_mixed, "fd_tables": fd_tables,
          "engine_requests": len(stream),
          "sharded_build": {"artifacts_equal": True, "shard_rows": sharded_stats.shard_rows,
                            "shard_values": sharded_stats.shard_values},
          "update_cell": {"shard": 1, "table": tid, "epochs_moved": moved, "stores_refreshed": refreshed},
          "mesh": {"backend": "gloo", "world_size": MESH_RANKS, "counts_equal_host_routed": True,
                   "xash_values_mesh_equal": True,
                   "ranks": [{k: r[k] for k in ("rank", "device", "build_s", "wall_s", "launches")}
                             for r in ranks]},
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# The discovery serving tier
# ---------------------------------------------------------------------------

def serving_stream(seed, n_truth: int, n_queries: int) -> list[list[tuple[int, int | None]]]:
    """Bursts of (query index, k) requests with a Zipf skew (weight 1 / (rank
    + 1), the ground-truth queries the hottest).  The first burst is a spike
    of the hot ground-truth queries alone at the default k, past twice
    ``max_queue``: full and degraded groups, all on B.2 (a group with a
    mixed query holds more candidate tables than one fused launch takes and
    demotes to B.4), and sheds.  The rest draws from every query, every third
    request at k = 5 (a bound-cache hit where only the bounds are cached)."""
    rng = np.random.default_rng(seed + 7)

    def draw(n, pool):
        w = 1.0 / np.arange(1, pool + 1)
        return [int(qi) for qi in rng.choice(pool, size=n, p=w / w.sum())]

    out = [[(qi, None) for qi in draw(SERVING_BURSTS[0], n_truth)]]
    rest = [(qi, 5 if i % 3 == 2 else None)
            for i, qi in enumerate(draw(SERVING_REQUESTS - SERVING_BURSTS[0], n_queries))]
    for size in SERVING_BURSTS[1:]:
        out.append(rest[:size])
        rest = rest[size:]
    return out


def mixed_spike(seed, n_truth: int, n_queries: int) -> list[tuple[int, None]]:
    """``MIXED_SPIKE`` requests at the default k, drawn with the same Zipf
    skew from the mixed queries alone (indices ``n_truth`` on)."""
    rng = np.random.default_rng(seed + 11)
    w = 1.0 / np.arange(1, n_queries - n_truth + 1)
    return [(n_truth + int(j), None) for j in rng.choice(len(w), size=MIXED_SPIKE, p=w / w.sum())]


def serving_phase(corpus, truth, mixed, seed) -> dict[str, int]:
    """A ``DiscoveryEngine`` (then an ``AsyncDiscoveryEngine``) over a
    512-bit session on the smoke lake, on a ManualClock: shed and degraded
    admissions, result- and bound-cache hits, deadline flushes; every
    answer equal to a cold ``discover`` of its query.  The stream's
    numbers are those of its chosen spike (ground-truth queries, whose
    degraded groups run B.2 at 4 of 16 lanes); a spike of mixed queries
    alone follows on a fresh engine, timed per group, since a degraded
    mixed group demotes to B.4 on rows read back to the host.  Launches are
    counted around the engines' calls only."""
    import asyncio

    from repro_torch.core.session import DiscoveryConfig, MateSession
    from repro_torch.kernels import filter_kernel as fk
    from repro_torch.serve import cache as cache_lib
    from repro_torch.serve.clock import ManualClock
    from repro_torch.serve.engine import AdmissionError, AsyncDiscoveryEngine, DiscoveryEngine

    queries = [(q, c) for q, c, _ in truth] + list(mixed)
    bursts = serving_stream(seed, len(truth), len(queries))
    cfg = DiscoveryConfig(bits=SERVING_BITS, window=SERVING_WINDOW, flush_after=SERVING_FLUSH_AFTER,
                          max_queue=SERVING_MAX_QUEUE, pressure_policy="degrade",
                          degrade_bits=SERVING_DEGRADE_BITS, result_cache=SERVING_CACHE,
                          bound_cache=SERVING_CACHE)
    t_phase = time.perf_counter()
    total = collections.Counter()
    t = time.perf_counter()
    index = MateSession.build(corpus, cfg).index
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t

    def log_groups(eng):
        """Logs each group ``eng`` serves: its size, whether it ran
        degraded, its host seconds (ending in a device sync) and its B.2
        and B.4 launches."""
        serve, log = eng._serve_group, []

        def logged(group):
            launched = lambda: (counters()["gather_filter_table_counts"].launches,
                                counters()["filter_match"].launches)
            before, t = launched(), time.perf_counter()
            serve(group)
            torch.cuda.synchronize()
            after = launched()
            log.append({"requests": len(group), "degraded": sum(r.degraded for r in group),
                        "s": time.perf_counter() - t, "b2": after[0] - before[0], "b4": after[1] - before[1]})

        eng._serve_group = logged
        return log

    def drive(eng, clk):
        reqs, bound_ready, deadline_flushes = [], [], 0
        for burst in bursts:
            new = [eng.submit(*queries[qi], k=k) for qi, k in burst]
            # queued (not answered, not shed) with cached bounds: a bound hit
            bound_ready += [r for r in new if r.bounds is not None and not r.future.done()]
            reqs += new
            eng.pump()
            if eng.queue:  # a partial group: served on its deadline
                clk.advance(SERVING_FLUSH_AFTER)
                deadline_flushes += bool(eng.pump())
        eng.flush()
        return reqs, len(bound_ready), deadline_flushes

    async def drive_async(eng, clk):
        reqs = []
        async with eng:  # the pump task serves due groups whenever the loop yields
            for burst in bursts:
                reqs += [eng.submit(*queries[qi], k=k) for qi, k in burst]
                for _ in range(8):
                    await asyncio.sleep(0)
                if eng.queue:
                    clk.advance(SERVING_FLUSH_AFTER)
                    for _ in range(8):
                        await asyncio.sleep(0)
        return reqs

    clk = ManualClock()
    session = MateSession(index, cfg)
    eng = DiscoveryEngine(session=session, clock=clk.now)
    groups = log_groups(eng)
    with record_shapes(fk, "gather_filter_table_counts", b2_probe) as probes:
        t = time.perf_counter()
        with path_window(total):
            reqs, bound_hits, deadline_flushes = drive(eng, clk)
            torch.cuda.synchronize()
        stream_s = time.perf_counter() - t

    # host-side bookkeeping against the session's counters
    want = {"shed": sum(isinstance(r.future.exception(), AdmissionError) for r in reqs),
            "degraded": sum(r.degraded for r in reqs), "cache_hits": sum(r.from_cache for r in reqs),
            "bound_hits": bound_hits, "requests": sum(r.future.exception() is None for r in reqs)}
    got = {name: getattr(session.stats, name) for name in want}
    if got != want or not all(got[n] > 0 for n in ("shed", "degraded", "cache_hits", "bound_hits")):
        raise AssertionError(f"serving counters {got}, bookkeeping expects {want} (each > 0)")
    probed = collections.Counter((p[2], p[3]) for p in probes)
    if not (probed[16, 16] and probed[4, 16]):
        raise AssertionError(f"B.2 probes of the 16-lane store: {dict(probed)}, want 16 and 4 lanes")

    # every answer against a cold discover at the session's flags: the same
    # top-k set, and the same order unless the request was degraded or a
    # cache hit (a degraded group's quality order may read its looser
    # prefix counts, and a cache hit replays whatever filled it)
    cold_session = MateSession(index, cfg)
    cold: dict = {}

    def check_cold(stream, served) -> int:
        in_order = 0
        for (qi, k), r in zip(stream, served):
            if r.future.exception() is not None:
                continue
            if (qi, k) not in cold:
                cold[qi, k] = key(cold_session.discover(*queries[qi], k=k)[0])
            if sorted(key(r.results)) != sorted(cold[qi, k]):
                raise AssertionError(f"served answer for query {qi} differs from a cold discover")
            if not (r.degraded or r.from_cache) and key(r.results) != cold[qi, k]:
                raise AssertionError(f"served answer for query {qi} is out of the cold order")
            in_order += key(r.results) == cold[qi, k]
        return in_order

    in_order = check_cold([x for b in bursts for x in b], reqs)

    # an FD-workload fingerprint of a served query never hits the join caches
    served = next(r for r in reqs if r.fingerprint is not None and r.future.exception() is None)
    epoch = index.mutation_epoch
    fd_fp = cache_lib.query_fingerprint(served.query, served.q_cols, cfg.init_mode, rank=cfg.rank,
                                        profile_gate=cfg.profile_gate, workload="fd:2:1")
    if (eng.result_cache.get(served.fingerprint, served.k, epoch) is None
            or eng.result_cache.get(fd_fp, served.k, epoch) is not None
            or eng.bound_cache.get(fd_fp, epoch) is not None):
        raise AssertionError("an FD-workload fingerprint hit the join caches (or the join entry is gone)")

    # the same stream through the asyncio tier, on a fresh session
    aclk = ManualClock()
    asession = MateSession(index, cfg)
    aeng = AsyncDiscoveryEngine(session=asession, clock=aclk)
    agroups = log_groups(aeng)
    t = time.perf_counter()
    with path_window(total):
        areqs = asyncio.run(drive_async(aeng, aclk))
        torch.cuda.synchronize()
    async_s = time.perf_counter() - t

    def outcome(r):
        e = r.future.exception()
        return ("shed", str(e)) if isinstance(e, AdmissionError) else ("ok", key(r.results), r.degraded)

    if [outcome(r) for r in areqs] != [outcome(r) for r in reqs] or len(agroups) != len(groups):
        raise AssertionError("the asyncio tier served the stream differently")
    if {name: getattr(asession.stats, name) for name in want} != got:
        raise AssertionError("the asyncio tier's counters differ from the synchronous engine's")

    # a spike of mixed queries alone on a fresh engine (empty caches):
    # max_queue admitted at full width, the rest degraded
    spike = mixed_spike(seed, len(truth), len(queries))
    mclk = ManualClock()
    msession = MateSession(index, cfg)
    meng = DiscoveryEngine(session=msession, clock=mclk.now)
    mgroups = log_groups(meng)
    with record_shapes(fk, "gather_filter_table_counts", b2_probe) as mprobes:
        t = time.perf_counter()
        with path_window(total):
            mreqs = [meng.submit(*queries[qi], k=k) for qi, k in spike]
            meng.flush()
            torch.cuda.synchronize()
        spike_s = time.perf_counter() - t
    mstats = {name: getattr(msession.stats, name) for name in ("shed", "degraded", "cache_hits", "requests")}
    if mstats != {"shed": 0, "degraded": MIXED_SPIKE - SERVING_MAX_QUEUE, "cache_hits": 0,
                  "requests": MIXED_SPIKE}:
        raise AssertionError(f"mixed spike counters {mstats}")
    spike_in_order = check_cold(spike, mreqs)
    degraded_groups = [g for g in mgroups if g["degraded"]]
    full_groups = [g for g in mgroups if not g["degraded"]]

    launches = check_counts(total, ("gather_filter_table_counts", "xash_superkey"), "serving path")
    emit({"phase": "serving_tier", "bits": SERVING_BITS, "degrade_bits": SERVING_DEGRADE_BITS,
          "build_s": build_s, "requests": SERVING_REQUESTS, "bursts": list(SERVING_BURSTS),
          "window": SERVING_WINDOW, "max_queue": SERVING_MAX_QUEUE, "counters": got,
          "groups": len(groups), "deadline_flushes": deadline_flushes, "group_log": groups,
          "b2_probes_by_lanes": {f"{a} of {b}": n for (a, b), n in sorted(probed.items())},
          "answers_equal_cold_discover": True, "answers_in_cold_order": in_order,
          "fd_fingerprint_misses_join_caches": True, "async_identical": True,
          "stream_s": stream_s, "s_per_request": stream_s / SERVING_REQUESTS,
          "async_stream_s": async_s,
          "mixed_spike": {"requests": MIXED_SPIKE, "counters": mstats, "group_log": mgroups,
                          "b2_probes_by_lanes": dict(collections.Counter(f"{p[2]} of {p[3]}" for p in mprobes)),
                          "answers_equal_cold_discover": True, "answers_in_cold_order": spike_in_order,
                          "spike_s": spike_s, "s_per_request": spike_s / MIXED_SPIKE,
                          "full_group_s": [g["s"] for g in full_groups],
                          "degraded_group_s": [g["s"] for g in degraded_groups]},
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# Phase 9: LM serving at full width
# ---------------------------------------------------------------------------

def serve_phase(seed) -> dict[str, int]:
    from repro_torch import configs
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import params as params_lib
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device("cuda")
    cfg = configs.get_config(SERVE_ARCH)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, cfg.vocab_size, size=int(rng.integers(PROMPT_MIN, PROMPT_MAX + 1))).tolist()
               for _ in range(SERVE_REQUESTS)]
    total = collections.Counter()  # launches of the two generate runs and serve.main
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    model = TransformerLM.init(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = params_lib.count(model.params)

    engine = ServeEngine(model, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    runs, wall = [], []
    for _ in range(2):
        t = time.perf_counter()
        with path_window(total):
            done = engine.generate([Request(prompt=p, max_new=SERVE_NEW) for p in prompts])
            torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)
        runs.append([r.out for r in done])
        timings = dict(engine.timings)
    if runs[0] != runs[1]:
        raise AssertionError("two greedy runs gave different tokens")
    if any(len(out) != SERVE_NEW for out in runs[0]):
        raise AssertionError("a request did not get all its tokens")
    groups = -(-SERVE_REQUESTS // SERVE_BATCH)
    flash_serving = total["flash_attention"]

    # decode consistency (tests/test_models.py on the card): prefill at S and
    # decode of token S against the full forward of S + 1 tokens, on the
    # first 1, 2, 6, 12 and 24 layers of the same weights.  Decode differs from
    # the forward row in GEMM shapes and in attention (plain float32
    # einsums against the flash kernel), so their bf16 roundings differ in
    # the last bit; the witness beside each gap is how
    # far the forward moves when one weight (layer 0's first norm scale,
    # 1.0) moves one bf16 ulp.  Decode is held to the bound at 1 and 2
    # layers (the reference test's depth) and printed deeper; prefill
    # repeats the forward's computation and is held at every depth.
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(CONSIST_B, CONSIST_S + 1))).to(dev)
    stack = model.params["layers"]
    nudged_scale = stack["s0"]["mixer_norm"]["scale"].clone()
    nudged_scale[0, 0] += 2.0 ** -7  # one bf16 ulp above 1.0
    nudged_s0 = {**stack["s0"], "mixer_norm": {**stack["s0"]["mixer_norm"], "scale": nudged_scale}}
    consistency = []
    for depth in CONSIST_DEPTHS:
        cut_cfg = dataclasses.replace(cfg, n_layers=depth)
        m = TransformerLM(cut_cfg, {**model.params, "layers": first_layers(stack, depth)})
        full = m(tokens)
        pre, cache = m.prefill(tokens[:, :CONSIST_S], CONSIST_S + 8)
        dec, _ = m.decode_step(tokens[:, CONSIST_S], cache)
        nudged = TransformerLM(cut_cfg, {**model.params, "layers": first_layers(
            {**stack, "s0": nudged_s0}, depth)})(tokens)[:, CONSIST_S]
        for name, x in (("forward", full), ("prefill", pre), ("decode", dec), ("nudged", nudged)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"non-finite {name} logits at {depth} layers")
        scale = float(full.abs().max()) + 1e-6
        d_pre = float((pre - full[:, CONSIST_S - 1]).abs().max()) / scale
        d_dec = float((dec - full[:, CONSIST_S]).abs().max()) / scale
        d_ulp = float((nudged - full[:, CONSIST_S]).abs().max()) / scale
        consistency.append({"layers": depth, "prefill": d_pre, "decode": d_dec, "one_ulp": d_ulp})
        if not d_pre < 0.05 or (depth <= 2 and not d_dec < 0.05):
            raise AssertionError(f"decode consistency at {depth} layers: prefill {d_pre:.4f},"
                                 f" decode {d_dec:.4f} of max|logit|")
        del m, full, cache, nudged
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del model, engine

    t = time.perf_counter()
    with path_window(total):
        served = serve_launch.main([])
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = check_counts(total, ("flash_attention",), "serve path")
    # one flash launch per layer per prefill: the two generate runs and
    # serve.main's groups (its default batch is 4); the consistency check
    # runs outside the counted windows
    want = cfg.n_layers * (2 * groups + -(-len(served) // 4))
    if launches["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times, expected {want}")

    decode = sorted(timings["decode_s"])
    new_tokens = SERVE_REQUESTS * SERVE_NEW
    emit({"phase": "serve", "arch": cfg.name, "stored_params": n_params, "init_s": init_s,
          "requests": SERVE_REQUESTS, "batch": SERVE_BATCH, "max_new": SERVE_NEW,
          "max_seq": SERVE_MAX_SEQ, "prompt_lens": [len(p) for p in prompts],
          "prefill_ms_per_group": [1e3 * s for s in timings["prefill_s"]],
          "decode_ms_per_step_mean": 1e3 * sum(decode) / len(decode),
          "decode_ms_per_step_median": 1e3 * decode[len(decode) // 2],
          "generate_wall_s": wall, "tokens_per_s": new_tokens / wall[-1],
          "flash_launches_in_serving": flash_serving,
          "consistency": consistency, "peak_mem_gb": peak_gb,
          "serve_main_s": main_s, "serve_main_tokens": sum(len(r.out) for r in served),
          "launches": launches, "greedy_repeatable": True, "first_tokens": [o[:4] for o in runs[0]]})
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the other LM families through the serve entry point
# ---------------------------------------------------------------------------

def flash_per_prefill(cfg) -> int:
    """B.6 launches of one prefill: one per attention, cross-attention and
    MLA sublayer, one per encoder layer."""
    from repro_torch.models import transformer

    n = sum(plan.n * sum(m in ("attn", "cross", "mla") for m, _ in plan.sublayers)
            for plan in transformer.group_plans(cfg))
    return n + (cfg.encoder.n_layers if cfg.encoder is not None else 0)


def family_prompts(rng, vocab: int, lo: int, hi: int) -> list[list[int]]:
    """``FAMILY_REQUESTS`` prompts of lo..hi tokens; the longest is rounded
    up to a multiple of 64, so that 4 × its length is a multiple of MoE's
    256-token dispatch group."""
    lens = rng.integers(lo, hi + 1, size=FAMILY_REQUESTS)
    i = int(lens.argmax())
    lens[i] = min(hi, -(-int(lens[i]) // 64) * 64)
    return [rng.integers(2, vocab, size=int(n)).tolist() for n in lens]


def _first(tree, n: int):
    """Views of the first ``n`` entries of every stacked leaf."""
    if isinstance(tree, dict):
        return {k: _first(v, n) for k, v in tree.items()}
    return tree[:n]


def family_cut(cfg, params: dict, depth: int):
    """A model of ``depth`` (1 or 2) layers built from the served weights,
    as (config, parameter views): the first layers of a uniform stack;
    deepseek: depth - 1 dense layers, then its MoE layer; whisper: ``depth``
    decoder and encoder layers.  The VLM and jamba stack blocks of 5 and 8
    sublayers, so their cut rebuilds the block at ``depth`` sublayers
    (``cross_attn_every`` / ``attn_every`` = depth) from block 0's: the
    VLM's [cross] and [self, cross]; jamba's [attention + MLP] and [SSM +
    MLP, attention + MoE] (the attention sublayer's mixer with sublayer
    1's MoE: not a structure of the served model, whose first whole block
    ``family_consistency`` also runs, in bf16 and float32)."""
    from repro_torch.models import transformer

    out = dict(params)
    if cfg.vision is not None or cfg.layer_pattern == "jamba":
        blk = _first(params["blocks"], 1)
        if cfg.vision is not None:
            kw = {"vision": dataclasses.replace(cfg.vision, cross_attn_every=depth)}
            subs = [blk["s4"]] if depth == 1 else [blk["s0"], blk["s4"]]
        else:
            kw = {"attn_every": depth}
            attn_moe = {**blk["s4"], "ffn_norm": blk["s1"]["ffn_norm"], "ffn": blk["s1"]["ffn"]}
            subs = [blk["s4"]] if depth == 1 else [blk["s0"], attn_moe]
        out["blocks"] = {f"s{i}": sub for i, sub in enumerate(subs)}
        return dataclasses.replace(cfg, n_layers=depth, **kw), out
    kw = {}
    if cfg.moe is not None and cfg.moe.first_dense:
        kw["moe"] = dataclasses.replace(cfg.moe, first_dense=depth - 1)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=depth)
        out["encoder"] = _first(params["encoder"], depth)
    cut_cfg = dataclasses.replace(cfg, n_layers=depth, **kw)
    for plan in transformer.group_plans(cut_cfg):
        out[plan.name] = _first(params[plan.name], plan.n)
    return cut_cfg, out


def family_block(cfg, params: dict):
    """The served stack's first whole block where ``family_cut`` rebuilds
    shorter ones, as (config, parameter views): the VLM's 5 layers (4 self
    + 1 cross), jamba's 8 (7 SSM + 1 attention, 4 MoE; its served depth);
    None for the uniform stacks, whose 1- and 2-layer cuts are served
    structures already."""
    if cfg.vision is not None:
        n = cfg.vision.cross_attn_every
    elif cfg.layer_pattern == "jamba":
        n = cfg.attn_every
    else:
        return None
    return dataclasses.replace(cfg, n_layers=n), {**params, "blocks": _first(params["blocks"], 1)}


@contextlib.contextmanager
def float32_activations():
    """While active, the port's bf16 activation casts (the embedding, the
    encoder's input, the caches) are float32, as in the float32 parity test
    of ``tests/test_torch_families.py``."""
    from repro_torch.models import transformer

    saved = (transformer._embed.__defaults__, transformer._encode.__defaults__,
             transformer.init_cache.__defaults__)
    transformer._embed.__defaults__ = (torch.float32,)  # the vocab-parallel lookup kept over a mesh
    transformer._encode.__defaults__ = (torch.float32,)
    transformer.init_cache.__defaults__ = (torch.float32, 0, None)
    try:
        yield
    finally:
        (transformer._embed.__defaults__, transformer._encode.__defaults__,
         transformer.init_cache.__defaults__) = saved


def cast_tree(tree: dict, dtype, in_place: bool) -> dict:
    """A ``dtype`` copy of a parameter tree; ``in_place`` swaps each leaf in
    ``tree`` itself, so that its old copy is freed as the next is made."""
    out = tree if in_place else {}
    for k, v in tree.items():
        out[k] = cast_tree(v, dtype, in_place) if isinstance(v, dict) else v.to(dtype)
    return out


def _consistency(m, tokens, s: int, extra: dict) -> dict:
    """Prefill of S tokens and decode of token S against the full forward
    of S + 1 tokens, in max|logit|; every logit must be finite."""
    full = m(tokens, **extra)
    pre, cache = m.prefill(tokens[:, :s], s + 8, **extra)
    dec, _ = m.decode_step(tokens[:, s], cache)
    for name, x in (("forward", full), ("prefill", pre), ("decode", dec)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{m.cfg.name}: non-finite {name} logits at {m.cfg.n_layers} layers")
    scale = float(full.abs().max()) + 1e-6
    return {"full": full, "dec": dec, "scale": scale,
            "prefill": float((pre - full[:, s - 1]).abs().max()) / scale,
            "decode": float((dec - full[:, s]).abs().max()) / scale}


def family_consistency(cfg, params: dict, rng, dev) -> list[dict]:
    """tests/test_models.py's decode consistency on the card: prefill of S
    tokens and decode of token S against the full forward of S + 1 tokens
    (MoE at capacity_factor 8, MLA on its naive path, as there; B = 2, S =
    127, so that B·S and B·(S + 1) fit MoE's grouping), held to the
    reference test's bound on 1 and 2 layers of the served weights
    (``family_cut``), with the absorbed MLA decode against the naive one.
    Then the first whole block where the cut rebuilt it (``family_block``)
    and the served depth, each in bf16 printed beside ``one_ulp`` — how far
    its forward moves when one weight (the first sublayer's first norm
    scale, 1.0) moves one bf16 ulp — and the block also in float32 (every
    weight and activation), held to ``FAMILY_F32_BOUND`` beside its own
    one-float32-ulp move: the bf16 gap of a chaotic block is rounding only
    if it shrinks with the precision.  jamba's block is its served depth, so its float32 copy
    replaces the bf16 leaves of ``params`` one by one, last: the caller
    holds no other reference to them and does not use them after this.
    Every logit must be finite."""
    from repro_torch.data.pipeline import stub_inputs
    from repro_torch.models import transformer
    from repro_torch.models.transformer import TransformerLM

    bound = 0.35 if (cfg.ssm is not None and cfg.moe is not None) else 0.05
    b, s = FAMILY_CONSIST_B, FAMILY_CONSIST_S
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + 1))).to(dev)
    block = family_block(cfg, params)
    kinds = [("cut", 1), ("cut", 2)]
    if block is not None and block[0].n_layers < cfg.n_layers:
        kinds.append(("block", 0))
    kinds.append(("served" if block is None or block[0].n_layers < cfg.n_layers else "served block", 0))
    del block  # views: the served block's float32 copy must free every bf16 leaf
    out = []
    for kind, depth in kinds:
        cut_cfg, cut = (family_cut(cfg, params, depth) if kind == "cut" else
                        family_block(cfg, params) if kind == "block" else (cfg, params))
        kw = {"mla_absorb": False}
        if cfg.moe is not None:
            kw["moe"] = dataclasses.replace(cut_cfg.moe, capacity_factor=8.0)
        cut_cfg = dataclasses.replace(cut_cfg, **kw)
        extra = stub_inputs(cut_cfg, b, device=dev)
        got = _consistency(TransformerLM(cut_cfg, cut), tokens, s, extra)
        row = {"layers": cut_cfg.n_layers, "kind": kind, "held": kind == "cut", "bound": bound,
               "prefill": got["prefill"], "decode": got["decode"]}
        if cfg.mla is not None:
            absorbed = TransformerLM(dataclasses.replace(cut_cfg, mla_absorb=True), cut)
            _, cache = absorbed.prefill(tokens[:, :s], s + 8, **extra)
            dec_abs, _ = absorbed.decode_step(tokens[:, s], cache)
            row["absorbed_vs_naive"] = float((dec_abs - got["dec"]).abs().max()) / (
                float(got["dec"].abs().max()) + 1e-6)
            del absorbed, cache, dec_abs
        if kind == "cut":
            if not (row["prefill"] < bound and row["decode"] < bound
                    and row.get("absorbed_vs_naive", 0.0) < 0.15):
                raise AssertionError(f"{cfg.name}: decode consistency at {row['layers']} layers: {row}")
        else:
            group = transformer.group_plans(cut_cfg)[0].name
            s0 = cut[group]["s0"]
            norm = {**s0["mixer_norm"], "scale": s0["mixer_norm"]["scale"].clone()}
            norm["scale"][0, 0] += 2.0 ** -7  # one bf16 ulp above 1.0
            nudged = {**cut, group: {**cut[group], "s0": {**s0, "mixer_norm": norm}}}
            moved = TransformerLM(cut_cfg, nudged)(tokens, **extra)
            if not bool(torch.isfinite(moved).all()):
                raise AssertionError(f"{cfg.name}: non-finite nudged logits at {row['layers']} layers")
            row["one_ulp"] = float((moved - got["full"]).abs().max()) / got["scale"]
            del nudged, moved
        del got
        if kind in ("block", "served block"):
            gc.collect()
            torch.cuda.empty_cache()
            p32 = cast_tree(cut, torch.float32, in_place=kind == "served block")
            extra32 = {k: v.float() for k, v in extra.items()}
            with float32_activations():
                f32 = _consistency(TransformerLM(cut_cfg, p32), tokens, s, extra32)
                s0 = p32[group]["s0"]
                norm = {**s0["mixer_norm"], "scale": s0["mixer_norm"]["scale"].clone()}
                norm["scale"][0, 0] += 2.0 ** -23  # one float32 ulp above 1.0
                nudged = {**p32, group: {**p32[group], "s0": {**s0, "mixer_norm": norm}}}
                moved = TransformerLM(cut_cfg, nudged)(tokens, **extra32)
            row["float32"] = {"prefill": f32["prefill"], "decode": f32["decode"],
                              "one_ulp": float((moved - f32["full"]).abs().max()) / f32["scale"],
                              "bound": FAMILY_F32_BOUND}
            del nudged, moved
            if not (f32["prefill"] < FAMILY_F32_BOUND and f32["decode"] < FAMILY_F32_BOUND):
                raise AssertionError(f"{cfg.name}: float32 decode consistency of the"
                                     f" {row['layers']}-layer block: {row}")
            del p32, f32
        out.append(row)
        del cut
        gc.collect()
        torch.cuda.empty_cache()
    return out


def families_phase(seed) -> dict[str, int]:
    """Every family beside the dense one at its published widths, through
    ``ServeEngine`` (with the stub frontends' ``extra_inputs``) and the
    serve entry point: per arch, random weights from ``seed``, 4 requests
    in one slot group of 4 with 16 new tokens each, generated twice (greedy
    must repeat), B.6's launches per prefill held to ``FAMILIES``, every
    logit of one more prefill and decode step finite, then
    ``family_consistency``; each model freed before the next.  Then
    ``launch.serve.main`` at full width for qwen2-moe and with ``--smoke``
    for all six."""
    from repro_torch import configs
    from repro_torch.data.pipeline import stub_inputs
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import params as params_lib
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    total, report, t_phase = collections.Counter(), [], time.perf_counter()
    for arch, depth, (lo, hi), per_prefill in FAMILIES:
        full_cfg = configs.get_config(arch)
        cfg = dataclasses.replace(full_cfg, n_layers=depth)
        if flash_per_prefill(cfg) != per_prefill:
            raise AssertionError(f"{arch}: {flash_per_prefill(cfg)} attention sublayers, expected {per_prefill}")
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        model = TransformerLM.init(cfg, seed=seed, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        prompts = family_prompts(rng, cfg.vocab_size, lo, hi)
        max_seq = max(len(p) for p in prompts) + FAMILY_NEW
        extra = stub_inputs(cfg, FAMILY_REQUESTS, device=dev)
        engine = ServeEngine(model, batch=FAMILY_REQUESTS, max_seq=max_seq, extra_inputs=extra)
        runs, wall, counts = [], [], collections.Counter()
        for _ in range(2):
            t = time.perf_counter()
            with path_window(counts):
                done = engine.generate([Request(prompt=p, max_new=FAMILY_NEW) for p in prompts])
                torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
            runs.append([r.out for r in done])
        if runs[0] != runs[1]:
            raise AssertionError(f"{arch}: two greedy runs gave different tokens")
        if any(len(out) != FAMILY_NEW for out in runs[0]):
            raise AssertionError(f"{arch}: a request did not get all its tokens")
        if counts["flash_attention"] != 2 * per_prefill:
            raise AssertionError(f"{arch}: flash_attention launched {counts['flash_attention']} times"
                                 f" in two prefills, expected {2 * per_prefill}")
        total.update(counts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((FAMILY_REQUESTS, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
        logits, cache = model.prefill(toks, max_seq, **extra)
        step_logits, _ = model.decode_step(logits.argmax(-1), cache)
        if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
            raise AssertionError(f"{arch}: non-finite prefill or decode logits at full depth")
        del logits, step_logits, cache
        timings, peak_gb = engine.timings, torch.cuda.max_memory_allocated(dev) / 1e9
        params = model.params
        del model, engine, done
        consistency = family_consistency(cfg, params, rng, dev)
        decode = sorted(timings["decode_s"])
        report.append({
            "arch": arch, "layers": f"{depth} of {full_cfg.n_layers}",
            "stored_params": params_lib.count(params), "init_s": init_s,
            "prompt_lens": [len(p) for p in prompts], "max_seq": max_seq,
            "prefill_ms_per_group": [1e3 * x for x in timings["prefill_s"]],
            "decode_ms_per_step_mean": 1e3 * sum(decode) / len(decode),
            "decode_ms_per_step_median": 1e3 * decode[len(decode) // 2],
            "generate_wall_s": wall, "tokens_per_s": FAMILY_REQUESTS * FAMILY_NEW / wall[-1],
            "flash_launches_per_prefill": counts["flash_attention"] // 2,
            "peak_mem_gb": peak_gb,
            "greedy_repeatable": True, "logits_finite": True, "consistency": consistency,
            "first_tokens": [o[:4] for o in runs[0]]})
        del params, extra
        gc.collect()
        torch.cuda.empty_cache()

    # the entry point: full width for the headline, then every family's
    # reduced config; 8 requests in slot batches of 4 each (2 prefills)
    serve_main = {}
    for arch, argv in [("qwen2-moe-a2.7b", [])] + [(a, ["--smoke"]) for a, *_ in FAMILIES]:
        cfg = configs.get_config(arch)
        cfg = configs.reduce_config(cfg) if argv else cfg
        counts, t = collections.Counter(), time.perf_counter()
        with path_window(counts), contextlib.redirect_stdout(io.StringIO()) as out:
            served = serve_launch.main(["--arch", arch, *argv])
            torch.cuda.synchronize()
        want = flash_per_prefill(cfg) * -(-len(served) // 4)
        if counts["flash_attention"] != want:
            raise AssertionError(f"serve.main --arch {arch} {argv}: flash_attention launched"
                                 f" {counts['flash_attention']} times, expected {want}")
        total.update(counts)
        serve_main[f"{arch}{' --smoke' if argv else ''}"] = {
            "wall_s": time.perf_counter() - t, "tokens": sum(len(r.out) for r in served),
            "flash_launches": counts["flash_attention"], "line": out.getvalue().splitlines()[0]}
        gc.collect()
        torch.cuda.empty_cache()
    launches = check_counts(total, ("flash_attention",), "families path")
    emit({"phase": "families", "gpu": nvidia_smi(), "archs": report, "serve_main": serve_main,
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# Phase 11: LM training through the train entry point, at full width
# ---------------------------------------------------------------------------

def train_parity(seed, cfg, batch) -> dict:
    """One step's loss and attention-weight gradients at the first
    ``TRAIN_PARITY_LAYERS`` layers of full-width ``cfg``, float32 weights
    and activations: through B.6 (its float32 kernel forward, the torch-ops
    backward) against the same step with the plain attention under
    autograd, within ``TRAIN_PARITY_TOL``."""
    from repro_torch.ckpt.manager import leaves_with_paths
    from repro_torch.kernels import flash_kernel as flk
    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import step as step_lib

    cut = dataclasses.replace(cfg, n_layers=TRAIN_PARITY_LAYERS)
    weights = params_lib.materialize(transformer.model_specs(cut), seed, dtype=torch.float32,
                                     device=torch.device("cuda"))
    tcfg = step_lib.TrainConfig(ce_chunk=1024)
    kernel = flk.flash_attention
    out = {}
    for name in ("kernel", "plain"):
        p = _tree_clone(weights)
        if name == "plain":
            flk.flash_attention = lambda q, k, v, *, causal=True, window=0: flk.flash_attention_plain(
                q, k, v, causal=causal, window=window)
        before = kernel.launches
        try:
            with float32_activations():
                loss, _ = step_lib.loss_fn(p, cut, tcfg, batch)
                loss.backward()
        finally:
            flk.flash_attention = kernel
        out[name] = (float(loss.detach()), {path: leaf.grad for path, leaf in leaves_with_paths(p)
                                   if "['mixer']" in path}, kernel.launches - before)
        del p, loss
    (loss_k, grads_k, launched), (loss_p, grads_p, _) = out["kernel"], out["plain"]
    rel = {path: float((grads_k[path] - g).abs().max() / g.abs().max()) for path, g in grads_p.items()}
    report = {"layers": TRAIN_PARITY_LAYERS, "loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel": abs(loss_k - loss_p) / abs(loss_p), "grad_rel": rel,
              "b6_launches": launched, "tolerance": TRAIN_PARITY_TOL}
    if launched != 2 * TRAIN_PARITY_LAYERS:
        raise AssertionError(f"train parity: B.6 launched {launched} times, expected {2 * TRAIN_PARITY_LAYERS}")
    if not report["loss_rel"] <= TRAIN_PARITY_TOL or not max(rel.values()) <= TRAIN_PARITY_TOL:
        raise AssertionError(f"train parity at {TRAIN_PARITY_LAYERS} layers: {report}")
    return report


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def conditioned(specs, tree) -> None:
    """Rescale, in place, every attention projection of ``tree`` (a leaf
    whose spec has a heads axis) from the init rule's 1/sqrt(shape[-2]) to
    1/sqrt(its input width): the model axis for Q/K/V, heads × head_dim
    for the output projection (``tests/test_torch_families._conditioned``'s
    rule).  At full width the init rule draws Q/K/V with a standard
    deviation of 0.25, not 1/32, and the gradient's global norm reaches
    ~1e12 (PERF.md §6; ROADMAP C.18)."""
    if isinstance(specs, dict):
        for k in specs:
            conditioned(specs[k], tree[k])
        return
    if specs.init != "normal" or not {"heads", "kv_heads"} & set(specs.axes):
        return
    dims = [(ax, n) for ax, n in zip(specs.axes, specs.shape) if ax not in ("layers", "experts")]
    fan_in = dims[0][1] * dims[1][1] if dims[0][0] in ("heads", "kv_heads") else dims[0][1]
    tree.mul_(float(np.sqrt(specs.shape[-2] / fan_in)))


def train_phase(seed) -> dict[str, int]:
    """``launch.train.main`` at full-width qwen1.5-0.5b (``TRAIN_ARGV``:
    [8, 2048] batches of ``TokenPipeline``, AdamW at the default lr, remat,
    chunked CE), three runs, each timed per step (host clock, ending in a
    sync) inside a launch window, B.6's backward calls carrying CUDA events:

    * ``uninterrupted`` — as users run it, weights drawn from ``--seed``:
      ``TRAIN_STEPS`` steps with a checkpoint at ``TRAIN_RESUME_AT``;
    * ``resumed`` — the checkpoints past ``TRAIN_RESUME_AT`` deleted and
      the same command run again, resuming there;
    * ``conditioned`` — the same draw with its attention projections
      rescaled (``conditioned``), written with a fresh optimizer state as
      the step-0 checkpoint of a new directory, from which the same
      command (``TRAIN_FALL_STEPS`` steps) starts.

    Held: every parameter leaf has a finite, nonzero gradient after the
    first step; the first loss is within 0.5 of ln(vocab); B.6 launches 2
    per attention layer per step (forward and remat recompute); the
    resumed steps' losses are the uninterrupted run's within
    ``TRAIN_RESUME_REL``; the conditioned run's last loss is at least
    ``TRAIN_LOSS_FALL`` below its first (the init rule's weights do not
    train at this lr: their gradient norm is printed beside); and
    ``train_parity``."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.ckpt.manager import leaves_with_paths
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_kernel as flk
    from repro_torch.launch import train as train_launch
    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import optimizer as opt, step as step_lib

    dev = torch.device("cuda")
    cfg = configs.get_config(SERVE_ARCH)
    total, steps, grad_check, bwd_events = collections.Counter(), [], {}, []
    make_train_step, backward = step_lib.make_train_step, flk.flash_attention_backward

    def timed_backward(q, k, v, out, lse, dout, *, causal=True, window=0):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        grads = backward(q, k, v, out, lse, dout, causal=causal, window=window)
        stop.record()
        bwd_events.append((start, stop))
        return grads

    # the op counts on the name the module binds (``counters``, ``path_window``):
    # the wrapper carries the count while installed
    timed_backward.launches = backward.launches

    def instrumented(cfg_, tcfg, *mesh_args):
        inner = make_train_step(cfg_, tcfg, *mesh_args)

        def train_step(params, opt_state, batch):
            bwd_events.clear()
            t = time.perf_counter()
            with path_window(total):
                out = inner(params, opt_state, batch)
                torch.cuda.synchronize()
                launches = counters()["flash_attention"].launches
                bwd_launches = counters()["flash_attention_backward"].launches
            ms = 1e3 * (time.perf_counter() - t)
            loss, norm = float(out[2]["loss"]), float(out[2]["grad_norm"])
            if not grad_check:  # after the first step: every leaf's gradient
                for path, leaf in leaves_with_paths(params):
                    g = leaf.grad
                    grad_check[path] = g is not None and bool(torch.isfinite(g).all()) and bool((g != 0).any())
                bad = [p for p, ok in grad_check.items() if not ok]
                if bad:
                    raise AssertionError(f"after step 1 these leaves have no finite nonzero gradient: {bad}")
            steps.append({"ms": ms, "b6_launches": launches, "b6_bwd_launches": bwd_launches,
                          "loss": loss, "grad_norm": norm,
                          "attn_bwd_ms": sum(a.elapsed_time(b) for a, b in bwd_events)})
            return out

        return train_step

    runs = {}
    common = TRAIN_ARGV + ["--log-every", "1", "--seed", str(seed)]
    with tempfile.TemporaryDirectory() as tmp:
        plain_dir, cond_dir = os.path.join(tmp, "plain"), os.path.join(tmp, "conditioned")
        step_lib.make_train_step, flk.flash_attention_backward = instrumented, timed_backward
        try:
            # the conditioned run keeps the driver's --ckpt-every (50): one
            # save at its end, not one every TRAIN_RESUME_AT steps
            resume_at = ["--ckpt-every", str(TRAIN_RESUME_AT)]
            for name, n_steps, ckpt, extra in (("uninterrupted", TRAIN_STEPS, plain_dir, resume_at),
                                               ("resumed", TRAIN_STEPS, plain_dir, resume_at),
                                               ("conditioned", TRAIN_FALL_STEPS, cond_dir, [])):
                if name == "resumed":  # back to the checkpoint at TRAIN_RESUME_AT
                    for st in CheckpointManager(plain_dir).all_steps():
                        if st > TRAIN_RESUME_AT:
                            shutil.rmtree(os.path.join(plain_dir, f"step_{st:06d}"))
                if name == "conditioned":  # the step-0 checkpoint it starts from
                    specs = transformer.model_specs(cfg)
                    weights = params_lib.materialize(specs, seed, device=dev)
                    conditioned(specs, weights)
                    CheckpointManager(cond_dir).save(0, {"params": weights, "opt": opt.init_state(
                        weights, opt.AdamWConfig())})
                    del weights
                    gc.collect()
                    torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                first, t = len(steps), time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as buf:
                    losses = train_launch.main(common + extra + ["--steps", str(n_steps), "--ckpt-dir", ckpt])
                lines = buf.getvalue().splitlines()
                runs[name] = {"losses": losses, "wall_s": time.perf_counter() - t, "steps": steps[first:],
                              "lines": lines, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                              "grad_norm": [float(m) for m in re.findall(r"gnorm=([\d.]+)", "\n".join(lines))]}
                emit({"phase": "train_run", "run": name, "losses": losses,
                      "grad_norm": runs[name]["grad_norm"],
                      "ms_per_step": [st["ms"] for st in steps[first:]],
                      "peak_gb": runs[name]["peak_gb"], "wall_s": runs[name]["wall_s"]})
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            backward.launches = timed_backward.launches
            step_lib.make_train_step, flk.flash_attention_backward = make_train_step, backward
        cond_args = train_launch.parse_args(common + ["--steps", str(TRAIN_FALL_STEPS)])
        policies = train_policies(cfg, cond_args, cond_dir, runs["conditioned"], total)
    full, resumed, cond = runs["uninterrupted"], runs["resumed"], runs["conditioned"]

    launches = check_counts(total, ("flash_attention", "flash_attention_backward"), "train path")
    want_b6 = 2 * cfg.n_layers
    if any(st["b6_launches"] != want_b6 for st in steps):
        raise AssertionError(f"B.6 launches per step {[st['b6_launches'] for st in steps]}, expected {want_b6}")
    if any(st["b6_bwd_launches"] != cfg.n_layers for st in steps):
        raise AssertionError(f"B.6 backward launches per step {[st['b6_bwd_launches'] for st in steps]},"
                             f" expected {cfg.n_layers}")
    losses = full["losses"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses + cond["losses"])):
        raise AssertionError(f"losses {losses}, conditioned {cond['losses']}")
    for run in (full, cond):
        if not abs(run["losses"][0] - np.log(cfg.vocab_size)) <= 0.5:
            raise AssertionError(f"first loss {run['losses'][0]} is not within 0.5 of ln({cfg.vocab_size})")
    if not cond["losses"][-1] <= cond["losses"][0] - TRAIN_LOSS_FALL:
        raise AssertionError(f"the conditioned run's loss went from {cond['losses'][0]} to"
                             f" {cond['losses'][-1]}, not down by {TRAIN_LOSS_FALL}")
    for run, at in ((resumed, TRAIN_RESUME_AT), (cond, 0)):
        if run["lines"][0] != f"[train] resumed from step {at}":
            raise AssertionError(f"a run did not start from its checkpoint: {run['lines'][:2]}")
    tail = losses[TRAIN_RESUME_AT:]
    resume_rel = [abs(a - b) / abs(b) for a, b in zip(resumed["losses"], tail)]
    if len(resumed["losses"]) != len(tail) or not max(resume_rel) <= TRAIN_RESUME_REL:
        raise AssertionError(f"resumed losses {resumed['losses']} against {tail}")

    batch = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in TokenPipeline(
        DataConfig(TRAIN_SEQ, TRAIN_BATCH, cfg.vocab_size, seed)).batch(0).items()}
    parity = train_parity(seed, cfg, batch)
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    steady = [st for run in runs.values() for st in run["steps"][1:]]
    ms = sorted(st["ms"] for st in steady)
    median = ms[len(ms) // 2]
    emit({"phase": "train", "gpu": nvidia_smi(), "arch": cfg.name,
          "argv": common + ["--ckpt-every", "<5, or the default 50>", "--steps", "<n>", "--ckpt-dir", "<tmp>"],
          "losses": losses, "resumed_losses": resumed["losses"], "resume_rel": resume_rel,
          "conditioned_losses": cond["losses"], "conditioned_loss_fall": cond["losses"][0] - cond["losses"][-1],
          "grad_norm": {name: run["grad_norm"] for name, run in runs.items()},
          "ln_vocab": float(np.log(cfg.vocab_size)),
          "ms_per_step": {name: [st["ms"] for st in run["steps"]] for name, run in runs.items()},
          "ms_per_step_median": median, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
          "attn_bwd_ms_per_step_median": sorted(st["attn_bwd_ms"] for st in steady)[len(steady) // 2],
          "attn_bwd_share": sum(st["attn_bwd_ms"] for st in steady) / sum(st["ms"] for st in steady),
          "b6_launches_per_step": sorted(set(st["b6_launches"] for st in steps)),
          "b6_bwd_launches_per_step": sorted(set(st["b6_bwd_launches"] for st in steps)),
          "peak_gb": {name: run["peak_gb"] for name, run in runs.items()},
          "wall_s": {name: run["wall_s"] for name, run in runs.items()},
          "grads_finite_nonzero": len(grad_check), "deterministic_algorithms": False,
          "parity": parity, "remat_policies": policies,
          "lines": {name: run["lines"] for name, run in runs.items()}, "launches": launches})
    if policies["failed"]:
        raise AssertionError(f"train remat policies: {policies['failed']}")
    return launches


def train_policies(cfg, args, ckpt_dir: str, full: dict, total: collections.Counter) -> dict:
    """``TRAIN_POLICY_STEPS`` steps of ``make_train_step`` under each of the
    block's other remat policies ('dots', 'none'), each from the
    conditioned run's step-0 checkpoint in ``ckpt_dir`` (its parameters
    restored as that run restores them, its fresh moments made anew: the
    card holds the same tensors as in that run, so the peaks compare) with
    ``launch.train``'s settings for that
    run's arguments ``args`` and its batches, inside the train path's
    launch window.  Held (after the line): each step's loss and
    gradient norm equal to the conditioned run's (``full``: 'full', the
    driver's default) within ``TRAIN_POLICY_REL``, and B.6's forward
    launches per step ``TRAIN_POLICY_B6`` per attention layer.  Printed:
    ms per step (host clock, ending in a sync) and the peak GB of each
    policy's steps beside 'full''s."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as train_launch
    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import optimizer as opt, step as step_lib

    dev = torch.device("cuda")
    tcfg = train_launch.train_config(args)
    like = {"params": opt.tree_map(lambda _: torch.empty(0, device=dev),
                                   params_lib.abstract(transformer.model_specs(cfg)))}
    data = TokenPipeline(DataConfig(args.seq_len, args.global_batch, cfg.vocab_size, args.seed))
    n = TRAIN_POLICY_STEPS
    head = full["steps"][:n]
    out = {"full": {"losses": [st["loss"] for st in head], "grad_norm": [st["grad_norm"] for st in head],
                    "ms_per_step": [st["ms"] for st in head], "peak_gb": full["peak_gb"],
                    "b6_launches_per_step": [st["b6_launches"] for st in head]},
           "tolerance": TRAIN_POLICY_REL, "failed": []}
    for policy in TRAIN_POLICY_B6:
        params = CheckpointManager(ckpt_dir).restore(0, like)["params"]
        state = opt.init_state(params, tcfg.adamw)
        rows = {"losses": [], "grad_norm": [], "ms_per_step": [], "b6_launches_per_step": [],
                "b6_bwd_launches_per_step": []}
        saved, transformer.REMAT_POLICY = transformer.REMAT_POLICY, policy
        try:
            train_step = step_lib.make_train_step(cfg, tcfg)
            torch.cuda.reset_peak_memory_stats(dev)
            for i in range(n):
                batch = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in data.batch(i).items()}
                t = time.perf_counter()
                with path_window(total):
                    params, state, metrics = train_step(params, state, batch)
                    rows["losses"].append(float(metrics["loss"]))  # ends in a sync
                    rows["b6_launches_per_step"].append(counters()["flash_attention"].launches)
                    rows["b6_bwd_launches_per_step"].append(counters()["flash_attention_backward"].launches)
                rows["ms_per_step"].append(1e3 * (time.perf_counter() - t))
                rows["grad_norm"].append(float(metrics["grad_norm"]))
            rows["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        finally:
            transformer.REMAT_POLICY = saved
        rows["rel"] = {key: [abs(a - b) / abs(b) for a, b in zip(rows[key], out["full"][key])]
                       for key in ("losses", "grad_norm")}
        worst = max(max(v) for v in rows["rel"].values())
        if not worst <= TRAIN_POLICY_REL:
            out["failed"].append(f"{policy}: losses / gradient norms {rows['rel']} against 'full'")
        want = TRAIN_POLICY_B6[policy] * cfg.n_layers
        if rows["b6_launches_per_step"] != [want] * n:
            out["failed"].append(f"{policy}: B.6 launches per step {rows['b6_launches_per_step']}, expected {want}")
        if rows["b6_bwd_launches_per_step"] != [cfg.n_layers] * n:
            out["failed"].append(f"{policy}: B.6 backward launches per step {rows['b6_bwd_launches_per_step']},"
                                 f" expected {cfg.n_layers}")
        out[policy] = rows
        del params, state, train_step
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 11b: training over a mesh; phase 11c: GPipe
# ---------------------------------------------------------------------------

def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def _rank_timing(report: dict, tokens_per_step: int) -> dict:
    """A rank's steady-step timing (steps after the first): ms per step
    (host clock, ending in a sync), tokens/s of the global batch, the
    share of the step in collectives (host clock, host copies included)."""
    steady = list(zip(report["ms"], report["comm_s"]))[1:] or list(zip(report["ms"], report["comm_s"]))
    ms = _median([m for m, _ in steady])
    return {"ms_per_step": report["ms"], "ms_per_step_median": ms, "tokens_per_s": tokens_per_step / (ms / 1e3),
            "comm_share": sum(c for _, c in steady) / (sum(m for m, _ in steady) / 1e3),
            "peak_gb": report["peak_gb"]}


def train_mesh_plan(_mesh, seed, tmp: str, extra=(), device="cuda:0") -> dict:
    """``train_mesh``'s part before the shared spawn, in a process of its
    own (``TrainMeshPlan``): the step-0 checkpoints every run resumes (the
    driver's draw from ``seed`` with its attention projections rescaled,
    ``conditioned``; one with float32 moments, one with int8), linked into
    a directory per run, and the ``--mesh 1x1`` runs (in the path's launch
    window): the plain one, and the int8 one saving after each step, whose
    step-1 checkpoint the 2x2 int8 run resumes.
    Returns the plan: the arguments of each run, their directories, the 1x1
    reports, the launches counted."""
    import shutil

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import train as train_launch
    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import optimizer as opt

    argv = ["--arch", SERVE_ARCH, "--seq-len", str(TRAIN_MESH_SEQ), "--global-batch", str(TRAIN_MESH_BATCH),
            "--steps", str(TRAIN_MESH_STEPS), "--ckpt-every", str(TRAIN_MESH_CKPT), "--log-every", "1",
            "--seed", str(seed), "--layers", str(TRAIN_MESH_LAYERS), *extra]
    int8_argv = [*argv, "--state-dtype", "int8", "--ckpt-every", "1", "--steps", str(TRAIN_MESH_INT8_STEPS)]
    cfg = train_launch._config(train_launch.parse_args(argv))
    dirs = {name: os.path.join(tmp, name) for name in ("start", "mesh", "sp", "1x1", "resumed", "start_int8",
                                                        "int8", "int8_1x1")}
    specs = transformer.model_specs(cfg)
    weights = params_lib.materialize(specs, seed, device=torch.device(device))
    conditioned(specs, weights)
    for name, dtype in (("start", "f32"), ("start_int8", "int8")):
        state = {"params": weights, "opt": opt.init_state(weights, opt.AdamWConfig(state_dtype=dtype))}
        CheckpointManager(dirs[name]).save(0, state)
        del state
    del weights
    for name in ("mesh", "sp", "1x1"):  # the runs write their own checkpoints beside a link to step 0
        shutil.copytree(dirs["start"], dirs[name], copy_function=os.link)
    shutil.copytree(dirs["start_int8"], dirs["int8_1x1"], copy_function=os.link)
    # the 1x1 and sequence-parallel runs save no checkpoint before their last step
    last_only = ["--ckpt-every", str(TRAIN_MESH_STEPS + 1)]
    total, runs = collections.Counter(), {}
    for name, run_argv in (("1x1", argv + ["--mesh", "1x1", "--ckpt-dir", dirs["1x1"], *last_only]),
                           ("int8_1x1", int8_argv + ["--mesh", "1x1", "--ckpt-dir", dirs["int8_1x1"]])):
        t = time.perf_counter()
        with path_window(total), contextlib.redirect_stdout(io.StringIO()) as buf:
            (single,) = train_launch.run(run_argv)
        runs[name] = {"report": single, "wall_s": time.perf_counter() - t, "lines": buf.getvalue().splitlines()}
    os.makedirs(dirs["int8"])  # the 2x2 int8 run resumes the 1x1 int8 run's step 1
    shutil.copytree(os.path.join(dirs["int8_1x1"], "step_000001"), os.path.join(dirs["int8"], "step_000001"),
                    copy_function=os.link)
    mesh_argv = argv + ["--mesh", TRAIN_MESH]
    return {"argv": argv, "int8_argv": int8_argv, "cfg": cfg, "dirs": dirs, "total": total, "device": device,
            **runs,
            "ranks": {"mesh": vars(train_launch.parse_args(mesh_argv + ["--ckpt-dir", dirs["mesh"]])),
                      "sp": vars(train_launch.parse_args(mesh_argv + ["--ckpt-dir", dirs["sp"], *last_only])),
                      "int8": vars(train_launch.parse_args(int8_argv + ["--mesh", TRAIN_MESH,
                                                                        "--ckpt-dir", dirs["int8"]]))}}


class TrainMeshPlan:
    """``train_mesh_plan`` in a process of its own (``SideRun``), its
    checkpoints in a temporary directory of this process; with
    ``families``, after the families' 1x1 runs in the same process
    (``main``, beside the lake's draw: the card cannot hold both at once,
    and the plan's first training step then finds torch and the card
    warm) and the long-context groups' (``long_mesh_single``), which
    ``refs`` ({phase: its ``SideCall``}) hands to ``families_mesh`` and
    ``long_mesh``.  ``get`` returns the plan; ``cleanup`` removes the
    directory."""

    def __init__(self, seed, device="cuda:0", extra=(), families=False):
        import tempfile

        self.tmp = tempfile.mkdtemp(prefix="train_mesh_")
        calls = [(families_mesh_single, (seed,)), (long_mesh_single, (seed,))] if families else []
        self.index = len(calls)
        calls.append((train_mesh_plan, (seed, self.tmp, tuple(extra), device)))
        self.run = SideRun(calls, device)
        self.refs = {"families_mesh": SideCall(self.run, 0), "long_mesh": SideCall(self.run, 1)} if families else {}

    def get(self) -> dict:
        return self.run.get(self.index)

    def cleanup(self) -> None:
        import shutil

        shutil.rmtree(self.tmp, ignore_errors=True)


def train_mesh_ranks(mesh, runs: dict) -> dict:
    """One rank of ``train_mesh`` in the shared spawn: ``launch.train``'s
    rank body (``_rank``, what ``launch.train.run`` spawns for ``--mesh``)
    of the ``--mesh TRAIN_MESH`` run on its ``GridMesh`` over this world,
    then, in the same rank, the same run under ``layers.SEQ_SHARD``
    (``runs['sp']``: its own copy of the step-0 checkpoint; a module switch
    set in the parent would not reach ``run``'s spawned ranks), then the
    int8 run (``runs['int8']``: the last step from the 1x1 int8 run's
    step-1 checkpoint, saved).  Returns the first's report with the others' as 'sp' and
    'int8'."""
    from repro_torch.launch import mesh as meshlib, train as train_launch

    d, m = (int(x) for x in TRAIN_MESH.split("x"))
    grid = meshlib.grid_mesh(mesh, {"data": d, "model": m})
    t = time.perf_counter()
    report = train_launch._rank(grid, runs["mesh"])
    report["wall_s"] = time.perf_counter() - t
    with seq_shard():
        t = time.perf_counter()
        report["sp"] = train_launch._rank(grid, runs["sp"])
        report["sp"]["wall_s"] = time.perf_counter() - t
    t = time.perf_counter()
    report["int8"] = train_launch._rank(grid, runs["int8"])
    report["int8"]["wall_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    return report


def train_mesh_report(plan: dict, ranks: list, spawn_wall: float) -> dict[str, int]:
    """``train_mesh``: ``launch.train``'s ``--mesh TRAIN_MESH`` run at
    qwen1.5-0.5b's published widths, cut to ``TRAIN_MESH_LAYERS`` layers
    (``--layers``), on the shared spawn's 4 gloo ranks on the one card
    (FSDP over 'data', tensor parallel over 'model', B.6 on each rank's 8
    of 16 heads), a checkpoint every ``TRAIN_MESH_CKPT`` steps, then the
    same run under sequence parallelism (``layers.SEQ_SHARD``: the residual
    stream's 512 positions split over 'model', each region's edges an
    all-gather and a reduce-scatter) in the same ranks; beside them
    ``--mesh 1x1`` (``train_mesh_plan``) and, here, ``--mesh 1x1`` resumed
    from the mesh run's step-2 checkpoint (full arrays).  Every run resumes
    the same step-0 checkpoint of the driver's draw from ``seed`` with its
    attention projections rescaled (``conditioned``), since on the init
    rule's own draw the backward explodes (gradient norm ~1e12, ROADMAP
    C.18): there one bf16 ulp on one weight moves the first step's
    gradient norm by 30%, and the mesh run's parts from 1x1's by 40%
    (``tools/train_ulp_witness.py``).  Held: every rank's parameters and
    moments on the card; 2 B.6 launches per rank, layer and step (forward
    and remat recompute), all at [4, 512, 8, 64], in both mesh runs; the
    first step's loss and gradient norm of both within ``TRAIN_MESH_REL``
    of 1x1's; the sequence-parallel run's losses within ``TRAIN_MESH_REL``
    of the mesh run's; the resumed losses within ``TRAIN_MESH_REL`` of the
    mesh run's.  With int8 moments (replicated, each updated whole):
    ``TRAIN_MESH_INT8_STEPS`` steps at 1x1 from the int8 step-0
    checkpoint, saving after each, and 2x2 resumed from its step-1
    checkpoint for the last step, saved (the moments rank 0 writes once);
    held: B.6 as above, the resumed run's first step's loss and gradient
    norm within ``TRAIN_MESH_REL`` of the 1x1 run's same step, and the
    dequantised m and v of the two last checkpoints (one update from the
    same moments) within ``TRAIN_MESH_REL`` of each other (‖Δ‖ / ‖m‖,
    ``int8_moment_gap``; printed: the largest gap in quantisation steps
    and the share over one step — in bf16 the two gradients differ by
    more than the moments' rounding, so single values move by a few
    steps; given the same gradient the update is bit-identical,
    ``tests/test_torch_int8_mesh.py``).  Printed, not held: ms per step,
    tokens/s, peak GB (beside ``TRAIN_MESH_PEAK_GB``), the most
    bytes of FSDP-gathered weights alive at once, the collectives by kind
    of a step and their share of it, per rank and run.  The line is
    printed before a failed check raises."""
    import shutil

    from repro_torch import configs
    from repro_torch.launch import train as train_launch

    cfg, dirs, total, device = plan["cfg"], plan["dirs"], plan["total"], plan["device"]
    os.makedirs(dirs["resumed"])
    shutil.copytree(os.path.join(dirs["mesh"], f"step_{TRAIN_MESH_CKPT:06d}"),
                    os.path.join(dirs["resumed"], f"step_{TRAIN_MESH_CKPT:06d}"))
    t = time.perf_counter()
    with path_window(total), contextlib.redirect_stdout(io.StringIO()) as buf:
        (resumed,) = train_launch.run(plan["argv"] + ["--mesh", "1x1", "--ckpt-dir", dirs["resumed"],
                                                       "--ckpt-every", str(TRAIN_MESH_STEPS + 1)])
    runs = {"1x1": plan["1x1"], "int8_1x1": plan["int8_1x1"],
            "resumed": {"report": resumed, "wall_s": time.perf_counter() - t, "lines": buf.getvalue().splitlines()}}
    single = runs["1x1"]["report"]
    d, m = (int(x) for x in TRAIN_MESH.split("x"))
    want_b6 = 2 * cfg.n_layers
    local = [TRAIN_MESH_BATCH // d, TRAIN_MESH_SEQ, cfg.n_heads // m, cfg.head_dim]
    failed = []
    for r in ranks:
        for name, run in (("mesh", r), ("sp", r["sp"]), ("int8", r["int8"])):
            if run["devices"] != [device]:
                failed.append(f"rank {r['rank']} {name}: parameters and moments on {run['devices']}, not {device}")
            if any(n != want_b6 for n in run["b6_launches"]):
                failed.append(f"rank {r['rank']} {name}: B.6 launches per step {run['b6_launches']},"
                              f" expected {want_b6}")
            if run["attention_shapes"] != {str(local): want_b6 * len(run["losses"])}:
                failed.append(f"rank {r['rank']} {name}: B.6 calls {run['attention_shapes']}, expected {local}")
    full, sp = ranks[0], ranks[0]["sp"]
    rel = lambda a, b: abs(a - b) / abs(b)
    first = {"loss": rel(full["losses"][0], single["losses"][0]),
             "grad_norm": rel(full["grad_norm"][0], single["grad_norm"][0])}
    first_sp = {"loss": rel(sp["losses"][0], single["losses"][0]),
                "grad_norm": rel(sp["grad_norm"][0], single["grad_norm"][0])}
    sp_rel = [rel(a, b) for a, b in zip(sp["losses"], full["losses"])]
    tail = full["losses"][TRAIN_MESH_CKPT:]
    resume_rel = [rel(a, b) for a, b in zip(resumed["losses"], tail)]
    if not max(first.values()) <= TRAIN_MESH_REL:
        failed.append(f"{TRAIN_MESH} first step against 1x1: {first}")
    if not max(first_sp.values()) <= TRAIN_MESH_REL:
        failed.append(f"{TRAIN_MESH} SEQ_SHARD first step against 1x1: {first_sp}")
    if len(sp_rel) != TRAIN_MESH_STEPS or not max(sp_rel) <= TRAIN_MESH_REL:
        failed.append(f"SEQ_SHARD losses {sp['losses']} against the mesh run's {full['losses']}")
    if runs["resumed"]["lines"][0] != f"[train] resumed from step {TRAIN_MESH_CKPT}" or len(resume_rel) != len(
            tail) or not max(resume_rel) <= TRAIN_MESH_REL:
        failed.append(f"resumed losses {resumed['losses']} against {tail}: {runs['resumed']['lines'][:1]}")
    int8, int8_1x1 = ranks[0]["int8"], runs["int8_1x1"]["report"]
    int8_first = {"loss": rel(int8["losses"][0], int8_1x1["losses"][-1]),
                  "grad_norm": rel(int8["grad_norm"][0], int8_1x1["grad_norm"][-1])}
    int8_gap = int8_moment_gap(dirs["int8"], dirs["int8_1x1"], TRAIN_MESH_INT8_STEPS, device)
    if int8["lines"][:1] != ["[train] resumed from step 1"] or len(int8["losses"]) != 1 or not (
            max(int8_first.values()) <= TRAIN_MESH_REL):
        failed.append(f"{TRAIN_MESH} int8 resumed at step 1 against 1x1: {int8_first}, {int8['lines'][:1]}")
    if not all(g["leaves"] and g["rel"] <= TRAIN_MESH_REL for g in int8_gap.values()):
        failed.append(f"{TRAIN_MESH} int8 moments after the last step against 1x1's: {int8_gap}")
    tokens = TRAIN_MESH_BATCH * TRAIN_MESH_SEQ
    launches = {name: int(total[name]) for name in counters()}
    launches["flash_attention"] += sum(r["b6_total"] + r["sp"]["b6_total"] + r["int8"]["b6_total"] for r in ranks)

    def per_rank(run: dict, rank: int) -> dict:
        return {"rank": rank, **_rank_timing(run, tokens), "gathered_peak_gb": run["gathered_peak_bytes"] / 1e9,
                "kinds": {k: v for k, v in run["kinds"].items() if v["count"]}, "wall_s": run["wall_s"]}

    emit({"phase": "train_mesh", "gpu": nvidia_smi(), "arch": cfg.name, "mesh": TRAIN_MESH,
          "layers": f"{cfg.n_layers} of {configs.get_config(SERVE_ARCH).n_layers}",
          "argv": plan["argv"] + ["--mesh", TRAIN_MESH, "--ckpt-dir", "<tmp: the conditioned step 0>"],
          "losses": full["losses"], "grad_norm": full["grad_norm"], "losses_1x1": single["losses"],
          "grad_norm_1x1": single["grad_norm"], "first_step_rel": first, "resumed_losses": resumed["losses"],
          "resume_rel": resume_rel, "tolerance": TRAIN_MESH_REL, "b6_launches_per_rank_step": want_b6,
          "b6_shape": local,
          "seq_shard": {"losses": sp["losses"], "grad_norm": sp["grad_norm"], "first_step_rel": first_sp,
                        "losses_rel_to_mesh": sp_rel,
                        "ranks": [per_rank(r["sp"], r["rank"]) for r in ranks]},
          "int8": {"losses": int8["losses"], "grad_norm": int8["grad_norm"], "losses_1x1": int8_1x1["losses"],
                   "grad_norm_1x1": int8_1x1["grad_norm"], "resumed_step_rel": int8_first,
                   "moments_gap_quant_steps": int8_gap, "ranks": [per_rank(r["int8"], r["rank"]) for r in ranks]},
          "ranks": [{"coords": r["coords"], "devices": r["devices"], **per_rank(r, r["rank"])} for r in ranks],
          "peak_gb_known": TRAIN_MESH_PEAK_GB,
          "timing_1x1": _rank_timing(single, tokens),
          "wall_s": {**{k: v["wall_s"] for k, v in runs.items()}, "spawn": spawn_wall},
          "lines": {"mesh": full["lines"], "seq_shard": sp["lines"], "int8": int8["lines"],
                    **{k: v["lines"] for k, v in runs.items()}},
          "launches": launches, "failed": failed})
    if failed:
        raise AssertionError(f"train_mesh: {failed}")
    check_counts(launches, ("flash_attention",), "train_mesh path")
    return launches


def int8_moment_gap(a_dir: str, b_dir: str, step: int, device) -> dict:
    """The int8 moments of two checkpoints' step ``step`` (``launch.train``
    with ``--state-dtype int8``), dequantised on ``device``: per moment
    ('m', 'v') the leaves compared, ‖a − b‖ / ‖b‖ over all of them
    ('rel'), the largest gap in quantisation steps (each value's
    |difference| over the larger of its block's two scales) and the share
    of values more than one step apart."""
    def files(d: str) -> dict:
        path = os.path.join(d, f"step_{step:06d}")
        with open(os.path.join(path, "manifest.json")) as f:
            return {e["path"]: os.path.join(path, e["file"]) for e in json.load(f)["leaves"]}

    a, b = files(a_dir), files(b_dir)
    out = {}
    for name in ("m", "v"):
        worst, n, over, values, diff2, ref2 = 0.0, 0, 0, 0, 0.0, 0.0
        for key in sorted(k for k in a if k.startswith(f"['opt']['{name}']") and k.endswith("['q']")):
            base = key[: -len("['q']")]
            load = lambda fs, part: torch.from_numpy(np.load(fs[base + part])).to(device)
            qa, sa, qb, sb = load(a, "['q']"), load(a, "['scale']"), load(b, "['q']"), load(b, "['scale']")
            da, db = qa.float() * sa, qb.float() * sb
            steps = (da - db).abs() / torch.maximum(sa, sb).clamp(min=1e-30)
            worst, n = max(worst, float(steps.max())), n + 1
            over, values = over + int((steps > 1 + 1e-5).sum()), values + steps.numel()
            diff2, ref2 = diff2 + float((da - db).double().square().sum()), ref2 + float(db.double().square().sum())
        out[name] = {"leaves": n, "rel": math.sqrt(diff2 / ref2) if ref2 else 0.0, "max_steps": worst,
                     "share_over_one_step": over / max(values, 1)}
    return out


def pipeline_rank(mesh, seed, device_check: str) -> dict:
    """One rank of the GPipe phase: full-width qwen1.5-0.5b drawn from
    ``seed`` on this rank's device, its stage's block of the staged layers,
    ``pipeline_loss_fn`` over the first batch of ``TokenPipeline`` and
    ``loss.backward()``; rank 0 also computes the un-pipelined
    ``chunked_ce`` on the same weights.  Returns the losses, the gradient
    checks, timings and this rank's B.6 launches."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_kernel as flk
    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import pipeline, sharding, step as step_lib

    dev = mesh.device
    cfg = configs.get_config(SERVE_ARCH)
    params = params_lib.materialize(transformer.model_specs(cfg), seed, device=dev)
    batch = TokenPipeline(DataConfig(PIPE_SEQ, PIPE_BATCH, cfg.vocab_size, seed)).batch(0)
    tokens, labels = (torch.from_numpy(batch[k]).to(dev, torch.long) for k in ("tokens", "labels"))
    out = {"rank": mesh.rank, "coords": mesh.coords, "unpiped": None}
    if mesh.rank == 0:
        with torch.no_grad():
            hidden, _ = transformer.forward_hidden(params, cfg, tokens, remat=False)
            head = transformer._head(params, cfg).to(hidden.dtype)
            out["unpiped"] = float(step_lib.chunked_ce(hidden, head, labels, 0, 0.0))
            del hidden, head
    staged = pipeline.stage_view(params, mesh.shape["pod"])
    local = sharding.local_tree(staged, pipeline.stage_placement(staged), mesh)
    del params, staged
    leaves = [leaf for _, leaf in pipeline._flatten(local)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    out["devices"] = sorted({str(t.device) for t in leaves})
    share = PIPE_BATCH // mesh.shape["data"]
    rows = slice(mesh.coords["data"] * share, (mesh.coords["data"] + 1) * share)
    fn = pipeline.pipeline_loss_fn(cfg, mesh, PIPE_MICRO, local, batch_axes=("data",))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    flk.flash_attention.launches, comm, t = 0, sharding.COMM["seconds"], time.perf_counter()
    loss = fn(local, tokens[rows], labels[rows])
    loss.backward()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t)
    out.update(loss=float(loss.detach()), ms=ms, comm_share=(sharding.COMM["seconds"] - comm) / (ms / 1e3),
               ticks=PIPE_MICRO + mesh.shape["pod"] - 1, b6_launches=flk.flash_attention.launches,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None)
    out["grads"] = {"/".join(path): {"finite": bool(torch.isfinite(leaf.grad).all()),
                                     "nonzero": bool((leaf.grad != 0).any())}
                    for path, leaf in pipeline._flatten(local)}
    out["device_ok"] = out["devices"] == [device_check]
    return out


def pipeline_phase(seed, devices=None, device="cuda:0") -> dict[str, int]:
    """``train.pipeline.pipeline_loss_fn`` at full-width qwen1.5-0.5b on
    ``PIPE_STAGES`` gloo ranks on the one card (one stage each, 12 layers,
    one data shard), [8, 512] tokens in ``PIPE_MICRO`` microbatches, then
    ``loss.backward()`` on every rank.  Held: the loss (the same on every
    rank) within ``PIPE_TOL`` of the un-pipelined ``chunked_ce`` on the same
    weights; every leaf's gradient finite on every rank, and every leaf a
    stage uses (its layers; the embedding on the first stage, the final
    norm and the tied head on the last) nonzero; 2 × microbatches × 12 B.6
    launches per rank (forward and the backward's recompute).  Printed:
    ms per step and per tick, tokens/s, peak GB, the collectives' share."""
    from repro_torch import configs
    from repro_torch.launch import mesh as meshlib

    cfg = configs.get_config(SERVE_ARCH)
    world = PIPE_STAGES
    t = time.perf_counter()
    ranks = meshlib.run_ranks(pipeline_rank, world, backend="gloo", devices=devices, args=(seed, device),
                              grid={"pod": PIPE_STAGES, "data": 1}, timeout_s=TRAIN_MESH_TIMEOUT_S)
    wall = time.perf_counter() - t
    losses = {r["loss"] for r in ranks}
    unpiped = ranks[0]["unpiped"]
    gap = abs(ranks[0]["loss"] - unpiped)
    failed = []
    if len(losses) != 1 or not gap <= PIPE_TOL:
        failed.append(f"pipeline losses {sorted(losses)} against the un-pipelined {unpiped}")
    per_stage = cfg.n_layers // PIPE_STAGES
    for r in ranks:
        stage = r["coords"]["pod"]
        used = [p for p in r["grads"] if p.startswith("layers/")]
        used += ["embed"] if stage == 0 else []
        used += ["embed", "final_norm/scale"] if stage == PIPE_STAGES - 1 else []
        bad = [p for p, g in r["grads"].items() if not g["finite"] or (p in used and not g["nonzero"])]
        if bad or not r["device_ok"]:
            failed.append(f"stage {stage}: gradients not finite / zero: {bad}; devices {r['devices']}")
        if r["b6_launches"] != 2 * PIPE_MICRO * per_stage:
            failed.append(f"stage {stage}: {r['b6_launches']} B.6 launches, expected {2 * PIPE_MICRO * per_stage}")
    launches = {name: 0 for name in counters()}
    launches["flash_attention"] = sum(r["b6_launches"] for r in ranks)
    emit({"phase": "pipeline", "gpu": nvidia_smi(), "arch": cfg.name, "stages": PIPE_STAGES, "data": 1,
          "tokens": [PIPE_BATCH, PIPE_SEQ], "n_micro": PIPE_MICRO, "loss": ranks[0]["loss"],
          "unpipelined_loss": unpiped, "gap": gap, "tolerance": PIPE_TOL,
          "ranks": [{"coords": r["coords"], "ms_per_step": r["ms"], "ms_per_tick": r["ms"] / r["ticks"],
                     "tokens_per_s": PIPE_BATCH * PIPE_SEQ / (r["ms"] / 1e3), "peak_gb": r["peak_gb"],
                     "comm_share": r["comm_share"], "b6_launches": r["b6_launches"],
                     "grads_checked": len(r["grads"])} for r in ranks],
          "wall_s": wall, "launches": launches, "failed": failed})
    if failed:
        raise AssertionError(f"pipeline: {failed}")
    check_counts(launches, ("flash_attention",), "pipeline path")
    return launches


def global_cache(cfg, tokens: np.ndarray, forced: np.ndarray, max_seq: int | None = None) -> dict:
    """The shapes of the whole cache that ``serve_on_mesh`` fills (meta
    tensors; made with activation sharding off)."""
    from repro_torch.models import transformer

    return transformer.init_cache(cfg, tokens.shape[0], max_seq or tokens.shape[1] + forced.shape[0],
                                  enc_len=transformer._enc_len(cfg), device="meta")


def serve_on_mesh(mesh, cfg, local: dict, tokens: np.ndarray, forced: np.ndarray, whole: dict,
                  extra=None, max_seq: int | None = None, fill=None) -> dict:
    """This rank's part of serving ``cfg`` over ``mesh`` (activation
    sharding on): ``transformer.prefill`` of its rows of ``tokens`` (every
    row where the batch axes do not divide the batch; and of ``extra``,
    whisper's frames / the VLM's patches of the global batch) from its
    shards ``local`` into a cache of ``max_seq`` slots (default: the
    prompt and the decode steps), ``fill(cache)`` after it where given,
    then a decode step for each row of ``forced`` (the 1x1 run's greedy
    tokens).  Returns the logits (ranks at model coordinate 0: every model
    rank holds the same gathered logits), the B.6 launches of the prefill,
    the cache leaves' devices and shapes against their placements in
    ``whole`` (``global_cache``), each decode step's collectives by kind,
    and host-clock times."""
    from repro_torch.kernels import flash_kernel as flk
    from repro_torch.models import layers, transformer
    from repro_torch.train import sharding

    dev = mesh.device
    max_seq = max_seq or tokens.shape[1] + forced.shape[0]
    b = tokens.shape[0]
    lo, hi = layers.local_rows(b)
    rows = slice(lo, hi)
    keep = mesh.coords["model"] == 0
    out = {"rank": mesh.rank, "coords": mesh.coords, "rows": (lo, hi), "logits": [],
           "decode_ms": [], "decode_kinds": [], "argmax": []}
    with torch.inference_mode():
        tok = torch.from_numpy(tokens[rows]).to(dev, torch.long)
        kw = {k: v[rows] for k, v in (extra or {}).items()}
        torch.cuda.synchronize(dev)
        flk.flash_attention.launches, comm, t = 0, sharding.COMM["seconds"], time.perf_counter()
        logits, cache = transformer.prefill(local, cfg, tok, max_seq, batch=b, **kw)
        torch.cuda.synchronize(dev)
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t)
        out["b6_prefill"] = flk.flash_attention.launches
        if fill is not None:
            t = time.perf_counter()
            fill(cache)
            torch.cuda.synchronize(dev)
            out["fill_ms"] = 1e3 * (time.perf_counter() - t)
        bad = []
        for plan, sub in cache.specs.items():
            for name, leaves in sub.items():
                for leaf, spec in leaves.items():
                    t_, g = cache[plan][name][leaf], whole[plan][name][leaf]
                    want = tuple(n // (mesh.axis_size(e) if e is not None else 1) for n, e in zip(g.shape, spec))
                    if t_.device != dev or tuple(t_.shape) != want:
                        bad.append(f"{plan}.{name}.{leaf}: {tuple(t_.shape)} on {t_.device}, want {want}")
        out["cache_bad"] = bad
        out["cache_specs"] = {f"{p}.{n}.{k}": list(v) for p, sub in cache.specs.items()
                              for n, leaves in sub.items() for k, v in leaves.items()}
        for step in range(forced.shape[0] + 1):
            out["argmax"].append(logits.argmax(dim=-1).cpu().tolist())
            if keep:
                out["logits"].append(logits.float().cpu().numpy())
            if step == forced.shape[0]:
                break
            nxt = torch.from_numpy(forced[step][rows]).to(dev, torch.long)
            torch.cuda.synchronize(dev)
            kinds, t = sharding.kinds_snapshot(), time.perf_counter()
            logits, cache = transformer.decode_step(local, cfg, nxt, cache)
            torch.cuda.synchronize(dev)
            out["decode_ms"].append(1e3 * (time.perf_counter() - t))
            out["decode_kinds"].append({k: {f: v[f] - kinds[k][f] for f in v}
                                        for k, v in sharding.kinds_snapshot().items() if v["count"] > kinds[k]["count"]})
        out["comm_s"] = sharding.COMM["seconds"] - comm
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def serve_mesh_rank(mesh, arch: str, seed: int, tokens: np.ndarray, forced: np.ndarray, n_layers: int) -> dict:
    """One rank of the ``serve_mesh`` phase: ``arch`` at its published
    widths, cut to ``n_layers``, drawn from ``seed`` (attention projections
    rescaled, ``conditioned``) on this rank's card, its shards under the
    training placement, served by ``serve_on_mesh``."""
    from repro_torch import configs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import layers, params as params_lib, transformer
    from repro_torch.train import sharding

    dev = mesh.device
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=n_layers)
    specs = transformer.model_specs(cfg)
    whole = global_cache(cfg, tokens, forced)
    whole_sp = global_cache(cfg, tokens, forced[:SERVE_MESH_SP_NEW])
    full = params_lib.materialize(specs, seed, device=dev)
    conditioned(specs, full)
    layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
    try:
        place = params_lib.validate_divisibility(specs, mesh, meshlib.rules_for(mesh))
        local = sharding.local_tree(full, place, mesh)
        del full
        torch.cuda.empty_cache()
        out = serve_on_mesh(mesh, cfg, local, tokens, forced, whole)
        if arch in SERVE_MESH_SP:
            with seq_shard():
                out["sp"] = serve_on_mesh(mesh, cfg, local, tokens, forced[:SERVE_MESH_SP_NEW], whole_sp)
        return out
    finally:
        layers.disable_activation_sharding()


@contextlib.contextmanager
def seq_shard():
    """Sequence parallelism (``layers.SEQ_SHARD``) while active."""
    from repro_torch.models import layers

    saved, layers.SEQ_SHARD = layers.SEQ_SHARD, True
    try:
        yield
    finally:
        layers.SEQ_SHARD = saved


def serve_mesh_ranks(mesh, groups: list) -> list[dict]:
    """One rank of the ``serve_mesh`` phase: for each ``(arch, grid, *args)``
    of ``groups`` in turn, ``serve_mesh_rank`` on its ``GridMesh`` over this
    world (one spawn for every group; each group's seconds in
    'group_s')."""
    from repro_torch.launch import mesh as meshlib

    out = []
    for arch, grid, *args in groups:
        t = time.perf_counter()
        out.append(serve_mesh_rank(meshlib.grid_mesh(mesh, grid), arch, *args))
        out[-1]["group_s"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_mesh_refs(seed, device="cuda:0") -> dict:
    """The 1x1 run of each ``SERVE_MESH`` configuration in this process,
    outside the path's window: {arch: (prompts, every step's logits, the
    greedy tokens fed, seconds)}."""
    from repro_torch import configs
    from repro_torch.models import params as params_lib, transformer

    dev = torch.device(device)
    refs = {}
    for arch, _grid in SERVE_MESH:
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=SERVE_MESH_LAYERS)
        specs = transformer.model_specs(cfg)
        tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(SERVE_MESH_B, SERVE_MESH_S))
        weights = params_lib.materialize(specs, seed, device=dev)
        conditioned(specs, weights)
        t = time.perf_counter()
        single, forced = serve_single(cfg, weights, tokens, {}, SERVE_MESH_NEW, dev)
        refs[arch] = (tokens, single, forced, time.perf_counter() - t)
        del weights
        torch.cuda.empty_cache()
    return refs


def serve_mesh_groups(seed, refs: dict) -> list:
    """``serve_mesh_ranks``' groups: each configuration with the 1x1 run's
    prompts and greedy tokens."""
    return [(arch, grid, seed, refs[arch][0], refs[arch][2], SERVE_MESH_LAYERS) for arch, grid in SERVE_MESH]


def serve_mesh_report(refs: dict, ranks: list, ranks_wall: float) -> dict[str, int]:
    """The ``serve_mesh`` line from every rank's reports (``serve_mesh_ranks``)
    against the 1x1 runs ``refs``; raises after the line if a check failed."""
    from repro_torch import configs

    launches = {name: 0 for name in counters()}
    rows, failed = [], []
    results = {arch: [r[i] for r in ranks] for i, (arch, _grid) in enumerate(SERVE_MESH)}
    wall = {arch: max(r["group_s"] for r in results[arch]) for arch, _grid in SERVE_MESH}
    for arch, grid in SERVE_MESH:
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=SERVE_MESH_LAYERS)
        ranks, (_tokens, single, _forced, single_s) = results[arch], refs[arch]
        gaps, greedy_equal, sp_gaps = [], True, []
        for r in ranks:
            lo, hi = r["rows"]
            for step, got in enumerate(r["logits"]):
                want = single[step]
                gaps.append(float(np.max(np.abs(got - want[lo:hi]))) / float(np.max(np.abs(want))))
            for step, got in enumerate(r["sp"]["logits"] if arch in SERVE_MESH_SP else []):
                want = single[step]
                sp_gaps.append(float(np.max(np.abs(got - want[lo:hi]))) / float(np.max(np.abs(want))))
            greedy_equal &= all(a == np.argmax(single[step][lo:hi], axis=-1).tolist()
                                for step, a in enumerate(r["argmax"]))
            if r["b6_prefill"] != cfg.n_layers:
                failed.append(f"{arch} rank {r['rank']}: {r['b6_prefill']} B.6 launches per prefill,"
                              f" expected {cfg.n_layers}")
            if r["cache_bad"]:
                failed.append(f"{arch} rank {r['rank']}: cache leaves {r['cache_bad']}")
            launches["flash_attention"] += r["b6_prefill"]
            if arch in SERVE_MESH_SP:
                sp = r["sp"]
                if sp["b6_prefill"] != cfg.n_layers or sp["cache_bad"]:
                    failed.append(f"{arch} rank {r['rank']} SEQ_SHARD: {sp['b6_prefill']} B.6 launches per"
                                  f" prefill, cache leaves {sp['cache_bad']}")
                launches["flash_attention"] += sp["b6_prefill"]
        if not gaps or max(gaps) > SERVE_MESH_TOL:
            failed.append(f"{arch} {grid}: logits gap {max(gaps, default=None)} against 1x1, bound {SERVE_MESH_TOL}")
        if arch in SERVE_MESH_SP and (len(sp_gaps) != len(gaps) // (SERVE_MESH_NEW + 1) * (SERVE_MESH_SP_NEW + 1)
                                      or max(sp_gaps) > SERVE_MESH_TOL):
            failed.append(f"{arch} {grid} SEQ_SHARD: logits gap {max(sp_gaps, default=None)} against 1x1,"
                          f" bound {SERVE_MESH_TOL}")
        rows.append({
            "arch": arch, "grid": grid, "layers": f"{cfg.n_layers} of {configs.get_config(arch).n_layers}",
            "kv_heads": cfg.n_kv_heads,
            "tokens": [SERVE_MESH_B, SERVE_MESH_S], "new": SERVE_MESH_NEW,
            "cache_k_spec": ranks[0]["cache_specs"]["layers.s0.k"],
            "max_gap": max(gaps, default=None), "gap_per_step": gaps[: SERVE_MESH_NEW + 1],
            "tolerance": SERVE_MESH_TOL, "greedy_equal_1x1": greedy_equal,
            "b6_launches_per_prefill": [r["b6_prefill"] for r in ranks],
            "ranks": [{"rank": r["rank"], "coords": r["coords"], "prefill_ms": r["prefill_ms"],
                       "decode_ms_median": _median(r["decode_ms"]),
                       "comm_share": r["comm_s"] / ((r["prefill_ms"] + sum(r["decode_ms"])) / 1e3),
                       "peak_gb": r["peak_gb"]} for r in ranks],
            "single_s": single_s, "group_s": wall[arch],
            "seq_shard": None if arch not in SERVE_MESH_SP else {
                "max_gap": max(sp_gaps), "gap_per_step": sp_gaps[: SERVE_MESH_SP_NEW + 1],
                "b6_launches_per_prefill": [r["sp"]["b6_prefill"] for r in ranks],
                "ranks": [{"rank": r["rank"], "prefill_ms": r["sp"]["prefill_ms"],
                           "decode_ms_median": _median(r["sp"]["decode_ms"]),
                           "comm_share": r["sp"]["comm_s"] / ((r["sp"]["prefill_ms"] + sum(r["sp"]["decode_ms"])) / 1e3),
                           "peak_gb": r["sp"]["peak_gb"]} for r in ranks]},
        })
    emit({"phase": "serve_mesh", "gpu": nvidia_smi(), "configs": rows, "ranks_wall_s": ranks_wall,
          "launches": launches, "failed": failed})
    if failed:
        raise AssertionError(f"serve_mesh: {failed}")
    check_counts(launches, ("flash_attention",), "serve_mesh path")
    return launches


def family_mesh_cfg(arch: str):
    """``arch`` at its published widths cut to the fewest layers that hold
    every kind of its sublayers: qwen2-moe 1 MoE layer; the VLM one block
    of [self, cross] (``family_cut``'s 2-sublayer block); whisper whole (6
    encoder + 6 decoder layers); deepseek-v3 1 dense + 1 MoE layer and its
    MTP module; mamba2 2 layers; jamba one block of 2 sublayers, (SSM,
    MLP) and (attention, MoE)."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    if cfg.layer_pattern == "jamba":
        return dataclasses.replace(cfg, n_layers=2, attn_every=2)
    if cfg.vision is not None:
        return dataclasses.replace(cfg, n_layers=2, vision=dataclasses.replace(cfg.vision, cross_attn_every=2))
    if cfg.encoder is not None:
        return cfg
    if cfg.moe is not None and cfg.moe.first_dense:
        return dataclasses.replace(cfg, n_layers=2, moe=dataclasses.replace(cfg.moe, first_dense=1))
    return dataclasses.replace(cfg, n_layers=1 if cfg.moe is not None else 2)


def draw_shards(cfg, seed: int, dev, mesh=None, place=None, turns: bool = False) -> dict:
    """``cfg``'s weights — the numbers of ``params.materialize(specs, seed)``
    with the attention projections rescaled (``conditioned``) — whole, or
    this rank's shards under ``place`` on ``mesh``: drawn leaf by leaf in
    materialize's order from its generator, each leaf sliced to this rank's
    shard before the next is drawn, so the peak is one whole leaf.  With
    ``turns`` the ranks draw one after the other (a barrier over the world
    between turns)."""
    import torch.distributed as dist

    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import sharding

    specs = transformer.model_specs(cfg)

    def draw():
        gen = torch.Generator(device=dev).manual_seed(seed)

        def go(spec, pl):
            if isinstance(spec, dict):
                return {k: go(spec[k], None if pl is None else pl[k]) for k in sorted(spec)}
            full = params_lib._init_tensor(spec, gen, torch.bfloat16, dev)
            conditioned(spec, full)
            return full if pl is None else sharding.shard_of(full, pl, mesh)

        return go(specs, place)

    if not turns:
        return draw()
    local = None
    world = mesh.group(tuple(mesh.axis_names))
    for turn in range(mesh.size):
        if mesh.rank == turn:
            local = draw()
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        dist.barrier(group=world)
    return local


def serve_single(cfg, weights: dict, tokens: np.ndarray, extra: dict, n_new: int, dev):
    """Prefill of ``tokens`` and ``n_new`` greedy decode steps on one
    process: (the logits of every step as numpy, the greedy tokens fed
    [n_new, B])."""
    from repro_torch.models import transformer

    single, forced = [], []
    with torch.inference_mode():
        logits, cache = transformer.prefill(weights, cfg, torch.from_numpy(tokens).to(dev),
                                            tokens.shape[1] + n_new, **extra)
        for step in range(n_new + 1):
            single.append(logits.float().cpu().numpy())
            if step == n_new:
                break
            nxt = logits.argmax(dim=-1)
            forced.append(nxt.cpu().numpy())
            logits, cache = transformer.decode_step(weights, cfg, nxt, cache)
    return single, np.stack(forced)


def fmesh_seq(arch: str) -> int:
    """The prompt and training length of a ``FAMILIES_MESH`` group."""
    return FMESH_SEQ.get(arch, FMESH_S)


def train_family(cfg, params: dict, dev, seed: int, no_opt: bool, mesh=None, place=None, extra=None,
                 seq: int = FMESH_S) -> dict:
    """``FMESH_STEPS`` AdamW steps of ``launch.train``'s loop on this
    rank's rows of [FMESH_B, seq] batches (one step without the update
    where ``no_opt``), from ``params`` (updated in place), on one process or
    this rank of ``mesh``.  Returns the losses, gradient norms, ms per step
    (host clock, ending in a sync), the seconds in collectives per step,
    B.6 launches per step and the peak GB of the steps."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_kernel as flk
    from repro_torch.launch import mesh as meshlib
    from repro_torch.train import optimizer as opt, sharding, step as step_lib

    tcfg = step_lib.TrainConfig(adamw=opt.AdamWConfig(warmup_steps=1, total_steps=FMESH_STEPS),
                                ce_chunk=min(1024, seq))
    rows = slice(0, FMESH_B)
    if mesh is not None:
        ba = meshlib.batch_axes(mesh)
        share = FMESH_B // mesh.axis_size(ba)
        rows = slice(mesh.axis_index(ba) * share, (mesh.axis_index(ba) + 1) * share)
    data = TokenPipeline(DataConfig(seq, FMESH_B, cfg.vocab_size, seed))
    if no_opt:
        grad_step = step_lib.make_grad_step(cfg, tcfg, mesh, place)
    else:
        train_step, state = step_lib.make_train_step(cfg, tcfg, mesh, place), opt.init_state(params, tcfg.adamw)
    out = {"losses": [], "grad_norm": [], "ms": [], "comm_s": [], "b6_launches": []}
    torch.cuda.reset_peak_memory_stats(dev)
    for step in range(1 if no_opt else FMESH_STEPS):
        batch = {k: torch.from_numpy(v[rows]).to(dev, torch.long) for k, v in data.batch(step).items()}
        batch.update({k: v[rows] for k, v in (extra or {}).items()})
        launches, comm, t = flk.flash_attention.launches, sharding.COMM["seconds"], time.perf_counter()
        if no_opt:
            _grads, norm, metrics = grad_step(params, batch)
        else:
            params, state, metrics = train_step(params, state, batch)
            norm = metrics["grad_norm"]
        out["losses"].append(float(metrics["loss"]))  # ends in a sync
        out["grad_norm"].append(float(norm))
        out["ms"].append(1e3 * (time.perf_counter() - t))
        out["comm_s"].append(sharding.COMM["seconds"] - comm)
        out["b6_launches"].append(flk.flash_attention.launches - launches)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    for p in opt.leaves(params):
        p.grad = None
        p.requires_grad_(False)
    return out


class CardMemory:
    """The card's memory in use by every process (``cudaMemGetInfo``, what
    ``nvidia-smi`` gives as memory.used), sampled from a thread every
    ``every_s`` while the block runs.  ``report()``: ``peak_gb`` the most
    a sample saw; ``bound_gb`` the most the other processes (and this
    one's context) held beside this process's allocator, plus the most
    that allocator reserved, which a peak between two samples does not
    hide (``others_gb`` and ``reserved_gb``, the two terms); ``total_gb``
    the card's."""

    def __init__(self, dev, every_s: float = 0.005):
        self.dev, self.every_s = dev, every_s
        self.peak, self.others, self.reserved, self.samples = 0, 0, 0, 0

    def _sample(self) -> None:
        reserved = torch.cuda.memory_reserved(self.dev)
        free, self.total = torch.cuda.mem_get_info(self.dev)
        used = self.total - free
        self.peak, self.others = max(self.peak, used), max(self.others, used - reserved)
        self.reserved, self.samples = max(self.reserved, reserved), self.samples + 1

    def _run(self) -> None:
        while not self.stop.wait(self.every_s):
            self._sample()

    def __enter__(self):
        import threading

        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        self.thread.join()
        self._sample()
        self.reserved = max(self.reserved, torch.cuda.max_memory_reserved(self.dev))

    def report(self) -> dict:
        return {"peak_gb": self.peak / 1e9, "bound_gb": (self.others + self.reserved) / 1e9,
                "others_gb": self.others / 1e9, "reserved_gb": self.reserved / 1e9, "total_gb": self.total / 1e9,
                "samples": self.samples}


def families_mesh_single(_mesh, seed: int) -> dict:
    """The 1x1 comparator of every ``FAMILIES_MESH`` group, in a process of
    its own (one rank of a one-rank group): each cut model drawn whole from
    ``seed`` (``materialize``, ``conditioned``), served (``serve_single``:
    the logits and the greedy tokens the ranks will feed) and trained
    (``train_family``), then freed before the next; the card's memory in
    use (``CardMemory``) watched throughout, as it runs beside the dry
    runs' processes in the whole smoke."""
    from repro_torch.data.pipeline import stub_inputs

    dev = _mesh.device
    out = {}
    for arch, _grid in FAMILIES_MESH:
        with CardMemory(dev) as card:
            cfg = family_mesh_cfg(arch)
            # served in float32, the bf16 draw's values
            weights = cast_tree(draw_shards(cfg, seed, dev), torch.float32, True)
            extra = stub_inputs(cfg, FMESH_B, device=dev)
            tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(FMESH_B, fmesh_seq(arch)))
            t = time.perf_counter()
            with float32_activations():
                single, forced = serve_single(cfg, weights, tokens, extra, FMESH_NEW, dev)
            serve_s = time.perf_counter() - t
            cast_tree(weights, torch.bfloat16, True)  # exact: the values came from bf16
            torch.cuda.empty_cache()
            train = train_family(cfg, weights, dev, seed, arch in FMESH_NO_OPT, extra=extra, seq=fmesh_seq(arch))
            out[arch] = {"tokens": tokens, "logits": single, "forced": forced, "serve_s": serve_s, "train": train}
            del weights, extra
            gc.collect()
            torch.cuda.empty_cache()
        out[arch]["card"] = card.report()
    return out


def families_mesh_ranks(mesh, seed: int, refs: dict, grids: dict | None = None) -> list[dict]:
    """One rank of the ``families_mesh`` phase: for each group of
    ``FAMILIES_MESH`` in turn, its ``GridMesh`` over this world, this rank's
    shards drawn (``draw_shards``), served (``serve_on_mesh``: the 1x1 run's
    prompts and greedy tokens, from the shards gathered over 'data' once,
    so no call gathers weights) and trained (``train_family``).  Returns a
    report per group: the serving report, the training report, the
    experts this rank holds per MoE layer, and the peak GB of the draw.
    ``grids``: the ``GridMesh`` of each grid made so far (filled here)."""
    from repro_torch.data.pipeline import stub_inputs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import layers, params as params_lib, transformer
    from repro_torch.train import optimizer as opt, sharding

    reports, grids = [], {} if grids is None else grids
    for arch, grid in FAMILIES_MESH:
        key = tuple(grid.items())
        grid_mesh = grids[key] = grids.get(key) or meshlib.grid_mesh(mesh, grid)  # one set of groups a grid
        dev = grid_mesh.device
        cfg = family_mesh_cfg(arch)
        whole = global_cache(cfg, refs[arch]["tokens"], refs[arch]["forced"])
        whole_sp = global_cache(cfg, refs[arch]["tokens"], refs[arch]["forced"][:0])
        torch.cuda.reset_peak_memory_stats(dev)
        layers.enable_activation_sharding(grid_mesh, vocab_size=cfg.vocab_size)
        try:
            place = params_lib.validate_divisibility(transformer.model_specs(cfg), grid_mesh,
                                                     meshlib.rules_for(grid_mesh))
            t = time.perf_counter()
            local = draw_shards(cfg, seed, dev, grid_mesh, place, arch in FMESH_TURNS)
            draw = {"s": time.perf_counter() - t, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
            experts = {f"{plan}.{name}": sl["ffn"]["wi_gate"].shape[1] for plan, sub in local.items()
                       if isinstance(sub, dict) for name, sl in sub.items()
                       if isinstance(sl, dict) and "router" in sl.get("ffn", {})}
            extra = stub_inputs(cfg, FMESH_B, device=dev)
            t = time.perf_counter()
            if grid_mesh.shape["data"] > 1:  # gathered over 'data' once (bf16): prefill and decode gather nothing
                with torch.no_grad():
                    served_params = cast_tree(sharding.gather_tree(local, place, grid_mesh), torch.float32, True)
            else:  # nothing to gather: the shards themselves, in float32 for serving and back after
                served_params = cast_tree(local, torch.float32, True)
            draw["gather_s"] = time.perf_counter() - t
            with float32_activations():
                served = serve_on_mesh(grid_mesh, cfg, served_params, refs[arch]["tokens"], refs[arch]["forced"],
                                       whole, extra)
                if arch in FMESH_SP:
                    with seq_shard():
                        served["sp"] = serve_on_mesh(grid_mesh, cfg, served_params, refs[arch]["tokens"],
                                                     refs[arch]["forced"][:0], whole_sp, extra)
            del served_params
            cast_tree(local, torch.bfloat16, True)  # exact: the values came from bf16
            torch.cuda.empty_cache()
            sp_train = None
            if arch in FMESH_SP:  # one gradient step, no update: the training below starts from the same draw
                with seq_shard():
                    sp_train = train_family(cfg, local, dev, seed, True, grid_mesh, place, extra, fmesh_seq(arch))
            train = train_family(cfg, local, dev, seed, arch in FMESH_NO_OPT, grid_mesh, place, extra,
                                 fmesh_seq(arch))
            reports.append({"arch": arch, "grid": grid, "draw": draw, "serve": served, "train": train,
                            "sp_train": sp_train,
                            "experts": experts,
                            "devices": sorted({str(t_.device) for t_ in opt.leaves(local)})})
            del local, extra
        finally:
            layers.disable_activation_sharding()
        gc.collect()
        torch.cuda.empty_cache()
    return reports


def long_cfg(arch: str):
    """A ``LONG_MESH`` group's model: jamba as ``family_mesh_cfg`` cuts it,
    the others at their published widths cut to ``LONG_LAYERS`` layers."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    return family_mesh_cfg(arch) if cfg.layer_pattern == "jamba" else dataclasses.replace(cfg, n_layers=LONG_LAYERS)


def _attn_layers(cfg):
    """(plan name, sublayer key, stack length) of every attention sublayer."""
    from repro_torch.models import transformer

    return [(plan.name, f"s{i}", plan.n) for plan in transformer.group_plans(cfg)
            for i, (mixer, _ffn) in enumerate(plan.sublayers) if mixer == "attn"]


def long_scales(cfg, cache) -> dict:
    """{'<plan>.<sublayer>.<layer>': (K's std, V's std)} over the slots a
    prefill wrote, from a whole (1x1) cache."""
    out = {}
    for plan, sub, n in _attn_layers(cfg):
        c = cache[plan][sub]
        for li in range(n):
            held = c["slot_pos"][li, 0] >= 0
            out[f"{plan}.{sub}.{li}"] = (float(c["k"][li, 0][held].float().std()),
                                         float(c["v"][li, 0][held].float().std()))
    return out


def long_fill(cfg, cache, scales: dict, seed: int, mesh=None) -> None:
    """Fill the attention caches a prefill left (in place: this rank's
    shards over ``mesh``, the whole cache without one) as if the prompt had
    run to position P = ``LONG_SLOTS`` - ``FMESH_NEW``: every slot holds the
    position it would hold then — a cache of at least P slots position =
    slot below P (the prompt's slots keep the prefill's K/V), a ring of w
    slots positions P - w .. P - 1, each at slot pos % w — its K and V a
    normal draw at ``scales`` (the prefill's own, ``long_scales``) in
    chunks of ``LONG_CHUNK`` slots, each from a generator of its own, so a
    rank draws only the chunks of its slots and every layout holds the
    same values; 'pos' = P.  The SSM state stays as the prefill left it."""
    p_end = LONG_SLOTS - FMESH_NEW
    specs = getattr(cache, "specs", None)

    def span(c, sp, leaf: str, dim: int) -> tuple[int, int]:
        """(this rank's first global index along ``dim`` of ``leaf``, its
        count)."""
        local = c[leaf].shape[dim]
        axes = None if sp is None else sp[leaf][dim]
        return (0 if axes is None else mesh.axis_index(axes) * local), local

    key = 0
    for plan, sub, n in _attn_layers(cfg):
        c, sp = cache[plan][sub], None if specs is None else specs[plan][sub]
        (k_lo, k_n), (h_lo, h_n), (p_lo, p_n) = span(c, sp, "k", 2), span(c, sp, "k", 3), span(c, sp, "slot_pos", 2)
        slots = k_n if sp is None or sp["k"][2] is None else k_n * mesh.axis_size(sp["k"][2])
        if k_n % LONG_CHUNK or p_n % LONG_CHUNK:
            raise ValueError(f"{plan}.{sub}: {k_n} / {p_n} local slots, not a multiple of {LONG_CHUNK}")
        dev = c["k"].device
        for li in range(n):
            prompt = int(c["pos"][li].max())
            k_std, v_std = scales[f"{plan}.{sub}.{li}"]

            def position(g: torch.Tensor) -> torch.Tensor:
                """The position at global slots ``g`` once the prompt reached
                P (-1 for an empty slot)."""
                if slots < p_end:  # a ring
                    return (p_end - slots) + (g - (p_end - slots)) % slots
                return torch.where(g < p_end, g, torch.full_like(g, -1))

            for lo in range(p_lo, p_lo + p_n, LONG_CHUNK):
                g = torch.arange(lo, lo + LONG_CHUNK, device=dev)
                pos = position(g)
                new = pos >= prompt
                at = slice(lo - p_lo, lo - p_lo + LONG_CHUNK)
                c["slot_pos"][li, :, at] = torch.where(new, pos, c["slot_pos"][li, :, at]).to(torch.int32)
            for lo in range(k_lo, k_lo + k_n, LONG_CHUNK):
                gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + key * 65_537 + lo // LONG_CHUNK)
                shape = (LONG_CHUNK, cfg.n_kv_heads, cfg.head_dim)
                kv = [torch.randn(shape, generator=gen, device=dev) * std for std in (k_std, v_std)]
                new = (position(torch.arange(lo, lo + LONG_CHUNK, device=dev)) >= prompt)[:, None, None]
                at = slice(lo - k_lo, lo - k_lo + LONG_CHUNK)
                for leaf, val in zip(("k", "v"), kv):
                    buf = c[leaf][li, :, at]
                    buf.copy_(torch.where(new, val[:, h_lo : h_lo + h_n].to(buf.dtype), buf))
            c["pos"][li] = p_end
            key += 1


def long_mesh_single(_mesh, seed: int) -> dict:
    """The 1x1 comparator of every ``LONG_MESH`` group, in the families'
    side process after their 1x1 runs have freed the card: each cut model
    drawn whole from ``seed`` (``draw_shards``: the bf16 draw's values,
    served in float32), a prefill of one prompt of ``FMESH_S`` tokens into
    a cache of ``LONG_SLOTS`` slots, ``long_fill`` at the prefill's own K/V
    scales, then ``FMESH_NEW`` greedy decode steps; the card's memory in use
    watched throughout (``CardMemory``)."""
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt

    dev = _mesh.device
    out = {}
    for arch, _grid in LONG_MESH:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with CardMemory(dev) as card:
            cfg = long_cfg(arch)
            weights = cast_tree(draw_shards(cfg, seed, dev), torch.float32, True)
            tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(1, FMESH_S))
            single, forced, decode_ms = [], [], []
            with float32_activations(), torch.inference_mode():
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                logits, cache = transformer.prefill(weights, cfg, torch.from_numpy(tokens).to(dev), LONG_SLOTS)
                torch.cuda.synchronize(dev)
                prefill_ms = 1e3 * (time.perf_counter() - t)
                scales = long_scales(cfg, cache)
                long_fill(cfg, cache, scales, seed)
                cache_gb = sum(t_.numel() * t_.element_size() for t_ in opt.leaves(cache)) / 1e9
                for step in range(FMESH_NEW + 1):
                    single.append(logits.float().cpu().numpy())
                    if step == FMESH_NEW:
                        break
                    nxt = logits.argmax(dim=-1)
                    forced.append(nxt.cpu().numpy())
                    torch.cuda.synchronize(dev)
                    t = time.perf_counter()
                    logits, cache = transformer.decode_step(weights, cfg, nxt, cache)
                    torch.cuda.synchronize(dev)
                    decode_ms.append(1e3 * (time.perf_counter() - t))
            out[arch] = {"tokens": tokens, "logits": single, "forced": np.stack(forced), "scales": scales,
                         "prefill_ms": prefill_ms, "decode_ms": decode_ms, "cache_gb": cache_gb,
                         "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
            del weights, cache, logits
            gc.collect()
            torch.cuda.empty_cache()
        out[arch].update(card=card.report(), group_s=time.perf_counter() - t0)
    return out


def long_mesh_ranks(mesh, seed: int, refs: dict, grids: dict) -> list[dict]:
    """One rank of the ``long_mesh`` phase: for each group of ``LONG_MESH``
    in turn, its ``GridMesh`` (shared through ``grids`` with the families'
    groups), this rank's shards drawn (``draw_shards``) and gathered over
    'data' once, then served (``serve_on_mesh``) at batch 1: the 1x1 run's
    prompt into a cache of ``LONG_SLOTS`` slots, ``long_fill`` of this
    rank's slots at the 1x1 prefill's K/V scales, and its greedy tokens;
    the card's memory in use watched (``CardMemory``)."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import layers, params as params_lib, transformer
    from repro_torch.train import optimizer as opt, sharding

    reports = []
    for arch, grid in LONG_MESH:
        t0 = time.perf_counter()
        key = tuple(grid.items())
        grid_mesh = grids[key] = grids.get(key) or meshlib.grid_mesh(mesh, grid)
        dev, cfg, ref = grid_mesh.device, long_cfg(arch), refs[arch]
        whole = global_cache(cfg, ref["tokens"], ref["forced"], LONG_SLOTS)
        torch.cuda.reset_peak_memory_stats(dev)
        layers.enable_activation_sharding(grid_mesh, vocab_size=cfg.vocab_size)
        try:
            with CardMemory(dev) as card:
                place = params_lib.validate_divisibility(transformer.model_specs(cfg), grid_mesh,
                                                         meshlib.rules_for(grid_mesh))
                t = time.perf_counter()
                local = draw_shards(cfg, seed, dev, grid_mesh, place)
                draw = {"s": time.perf_counter() - t}
                t = time.perf_counter()
                with torch.no_grad():  # gathered over 'data' once: prefill and decode gather nothing
                    served_params = cast_tree(sharding.gather_tree(local, place, grid_mesh), torch.float32, True)
                draw["gather_s"] = time.perf_counter() - t
                devices = sorted({str(t_.device) for t_ in opt.leaves(local)})
                del local
                torch.cuda.empty_cache()
                with float32_activations():
                    served = serve_on_mesh(grid_mesh, cfg, served_params, ref["tokens"], ref["forced"], whole,
                                           max_seq=LONG_SLOTS,
                                           fill=lambda cache: long_fill(cfg, cache, ref["scales"], seed, grid_mesh))
                del served_params
            reports.append({"arch": arch, "grid": grid, "draw": draw, "serve": served, "devices": devices,
                            "card": card.report(), "group_s": time.perf_counter() - t0})
        finally:
            layers.disable_activation_sharding()
        gc.collect()
        torch.cuda.empty_cache()
    return reports


def long_mesh_report(refs, ranks: list, ranks_s: float, device="cuda:0") -> dict[str, int]:
    """The ``long_mesh`` line from every rank's reports
    (``long_mesh_ranks``) against the 1x1 runs of ``refs``; raises after
    the line if a check failed."""
    from repro_torch import configs

    results = refs.get()
    launches = {name: 0 for name in counters()}
    failed, rows = [], []
    for g, (arch, grid) in enumerate(LONG_MESH):
        cfg, ref = long_cfg(arch), results[arch]
        group = [r[g] for r in ranks]
        want_b6 = flash_per_prefill(cfg)
        gaps, by_step = [], [0.0] * (FMESH_NEW + 1)
        for r in group:
            sv = r["serve"]
            if sv["rows"] != (0, 1):
                failed.append(f"{arch} rank {sv['rank']}: rows {sv['rows']}, expected the one row (0, 1)")
            for step, got in enumerate(sv["logits"]):
                want = ref["logits"][step]
                gaps.append(float(np.max(np.abs(got - want))) / float(np.max(np.abs(want))))
                by_step[step] = max(by_step[step], gaps[-1])
            if sv["b6_prefill"] != want_b6:
                failed.append(f"{arch} rank {sv['rank']}: {sv['b6_prefill']} B.6 launches per prefill,"
                              f" expected {want_b6}")
            if sv["cache_bad"] or r["devices"] != [device]:
                failed.append(f"{arch} rank {sv['rank']}: cache leaves {sv['cache_bad']}, shards on {r['devices']}")
            launches["flash_attention"] += sv["b6_prefill"]
        if len(gaps) != 2 * (FMESH_NEW + 1) or max(gaps) > LONG_MESH_TOL:
            failed.append(f"{arch} {grid}: {len(gaps)} logits, gap {max(gaps, default=None)} against 1x1,"
                          f" bound {LONG_MESH_TOL}")
        rows.append({
            "arch": arch, "grid": grid, "layers": f"{cfg.n_layers} of {configs.get_config(arch).n_layers}",
            "batch": 1, "prompt": FMESH_S, "slots": LONG_SLOTS, "new": FMESH_NEW,
            "cache_specs": group[0]["serve"]["cache_specs"], "max_gap": max(gaps, default=None),
            "gap_per_step": by_step, "serve_tolerance": LONG_MESH_TOL,
            "greedy_equal_1x1": all(a == np.argmax(ref["logits"][step], axis=-1).tolist()
                                    for r in group for step, a in enumerate(r["serve"]["argmax"])),
            "b6_launches_per_prefill": [r["serve"]["b6_prefill"] for r in group], "b6_plan": want_b6,
            "decode_kinds_rank0": group[0]["serve"]["decode_kinds"][-1],
            "ranks": [{"rank": r["serve"]["rank"], "coords": r["serve"]["coords"], "draw_s": r["draw"]["s"],
                       "gather_s": r["draw"]["gather_s"], "prefill_ms": r["serve"]["prefill_ms"],
                       "fill_ms": r["serve"]["fill_ms"], "decode_ms": r["serve"]["decode_ms"],
                       "decode_ms_median": _median(r["serve"]["decode_ms"]),
                       "serve_comm_share": r["serve"]["comm_s"] / (
                           (r["serve"]["prefill_ms"] + sum(r["serve"]["decode_ms"])) / 1e3),
                       "peak_gb": r["serve"]["peak_gb"], "card": r["card"], "group_s": r["group_s"]} for r in group],
            "single": {"group_s": ref["group_s"], "prefill_ms": ref["prefill_ms"], "decode_ms": ref["decode_ms"],
                       "decode_ms_median": _median(ref["decode_ms"]), "cache_gb": ref["cache_gb"],
                       "peak_gb": ref["peak_gb"], "card": ref["card"]},
        })
    emit({"phase": "long_mesh", "gpu": nvidia_smi(), "groups": rows, "single_s": refs.seconds(),
          "ranks_wall_s": ranks_s, "launches": launches, "failed": failed})
    if failed:
        raise AssertionError(f"long_mesh: {failed}")
    check_counts(launches, ("flash_attention",), "long_mesh path")
    return launches


def _side_calls(mesh, calls: list) -> list:
    """Each ``fn(mesh, *args)`` of ``calls`` in turn: [(its result, its
    end in seconds from the first's start)]."""
    t0, out = time.perf_counter(), []
    for fn, args in calls:
        out.append((fn(mesh, *args), time.perf_counter() - t0))
    return out


class SideRun:
    """The calls ``(fn, args)`` of ``calls``, each ``fn(mesh, *args)`` in
    turn, in one process of their own (one gloo rank on ``device``),
    spawned from a thread: ``main`` starts it right after the kernel
    build, beside the lake's draw (it needs the card and one host core,
    and nothing is timed there), and waits for it with the dry runs,
    before the kernel phase.  ``get(i)`` returns call i's result (waiting
    if need be); ``seconds(i)`` its end, in seconds from the first call's
    start."""

    def __init__(self, calls: list, device: str = "cuda:0"):
        import threading

        self.result, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(calls, device), daemon=True)
        self.thread.start()

    def _run(self, calls: list, device: str) -> None:
        from repro_torch.launch import mesh as meshlib

        try:
            (self.result,) = meshlib.run_ranks(_side_calls, 1, backend="gloo", devices=[device], args=(calls,),
                                               timeout_s=TRAIN_MESH_TIMEOUT_S, env=FMESH_ENV)
        except Exception as e:  # handed to the caller of get
            self.error = e

    def get(self, i: int = 0):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result[i][0]

    def seconds(self, i: int = 0) -> float:
        self.get(i)
        return self.result[i][1]


class SideCall:
    """Call ``i`` of a ``SideRun``: ``get()`` its result, ``seconds()`` its
    end, in seconds from the run's first call's start."""

    def __init__(self, run: SideRun, i: int):
        self.run, self.i = run, i

    def get(self):
        return self.run.get(self.i)

    def seconds(self) -> float:
        return self.run.seconds(self.i)


def side_refs(seed: int, phases, device: str = "cuda:0") -> dict:
    """The 1x1 runs the mesh phases of ``phases`` compare with, in one
    ``SideRun`` (the families', then the long-context groups', after the
    families' have freed the card): {'families_mesh' / 'long_mesh': its
    ``SideCall``}."""
    calls = [(fn, (seed,)) for name, fn in (("families_mesh", families_mesh_single),
                                            ("long_mesh", long_mesh_single)) if name in phases]
    run = SideRun(calls, device) if calls else None
    names = [name for name in ("families_mesh", "long_mesh") if name in phases]
    return {name: SideCall(run, i) for i, name in enumerate(names)}


def _parent_gb(device) -> float:
    """This process's allocated GB after its cached blocks are released,
    before 4 ranks share the card."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(torch.device(device)) / 1e9


def families_mesh_report(refs: SideRun, ranks: list, ranks_s: float, parent_gb: float,
                         device="cuda:0") -> dict[str, int]:
    """The ``families_mesh`` line from every rank's reports
    (``families_mesh_ranks``) against the 1x1 runs of ``refs``; raises
    after the line if a check failed."""
    from repro_torch import configs

    results = refs.get()
    launches = {name: 0 for name in counters()}
    failed, rows = [], []
    for g, (arch, grid) in enumerate(FAMILIES_MESH):
        cfg, ref = family_mesh_cfg(arch), results[arch]
        group = [r[g] for r in ranks]
        want_b6 = flash_per_prefill(cfg)
        m = grid["model"]
        gaps, by_rank, sp_gaps = [], {}, []
        for r in group:
            sv, tr = r["serve"], r["train"]
            lo, hi = sv["rows"]
            for step, got in enumerate(sv["logits"]):
                want = ref["logits"][step]
                gaps.append(float(np.max(np.abs(got - want[lo:hi]))) / float(np.max(np.abs(want))))
                by_rank[sv["rank"]] = max(by_rank.get(sv["rank"], 0.0), gaps[-1])
            if sv["b6_prefill"] != want_b6:
                failed.append(f"{arch} rank {sv['rank']}: {sv['b6_prefill']} B.6 launches per prefill,"
                              f" expected {want_b6}")
            if sv["cache_bad"] or r["devices"] != [device]:
                failed.append(f"{arch} rank {sv['rank']}: cache leaves {sv['cache_bad']}, shards on {r['devices']}")
            if cfg.moe is not None and cfg.moe.n_routed % m == 0 and set(r["experts"].values()) != {
                    cfg.moe.n_routed // m}:
                failed.append(f"{arch} rank {sv['rank']}: experts per MoE layer {r['experts']},"
                              f" expected {cfg.moe.n_routed // m}")
            launches["flash_attention"] += sv["b6_prefill"] + sum(tr["b6_launches"])
            if arch in FMESH_SP:
                for step, got in enumerate(sv["sp"]["logits"]):
                    want = ref["logits"][step]
                    sp_gaps.append(float(np.max(np.abs(got - want[lo:hi]))) / float(np.max(np.abs(want))))
                if sv["sp"]["b6_prefill"] != want_b6 or sv["sp"]["cache_bad"]:
                    failed.append(f"{arch} rank {sv['rank']} SEQ_SHARD: {sv['sp']['b6_prefill']} B.6 launches per"
                                  f" prefill, cache leaves {sv['sp']['cache_bad']}")
                launches["flash_attention"] += sv["sp"]["b6_prefill"] + sum(r["sp_train"]["b6_launches"])
        tr0, single = group[0]["train"], ref["train"]
        first = {"loss": abs(tr0["losses"][0] - single["losses"][0]) / abs(single["losses"][0]),
                 "grad_norm": abs(tr0["grad_norm"][0] - single["grad_norm"][0]) / abs(single["grad_norm"][0])}
        if not gaps or max(gaps) > SERVE_MESH_TOL:
            failed.append(f"{arch} {grid}: logits gap {max(gaps, default=None)} against 1x1, bound {SERVE_MESH_TOL}")
        if not max(first.values()) <= TRAIN_MESH_REL:
            failed.append(f"{arch} {grid}: first step against 1x1 {first}, bound {TRAIN_MESH_REL}")
        if any(r["train"]["losses"] != tr0["losses"] for r in group):
            failed.append(f"{arch}: the ranks' losses differ: {[r['train']['losses'] for r in group]}")
        seq = None
        if arch in FMESH_SP:
            sp0 = group[0]["sp_train"]
            seq = {"max_gap": max(sp_gaps, default=None), "gap_per_step": sp_gaps,
                   "b6_launches_per_prefill": [r["serve"]["sp"]["b6_prefill"] for r in group],
                   "loss": sp0["losses"][0], "grad_norm": sp0["grad_norm"][0],
                   "first_step_rel": {"loss": abs(sp0["losses"][0] - single["losses"][0]) / abs(single["losses"][0]),
                                      "grad_norm": abs(sp0["grad_norm"][0] - single["grad_norm"][0])
                                      / abs(single["grad_norm"][0])},
                   "ranks": [{"rank": r["serve"]["rank"], "prefill_ms": r["serve"]["sp"]["prefill_ms"],
                              "ms_per_step": r["sp_train"]["ms"], "train_peak_gb": r["sp_train"]["peak_gb"],
                              "step_comm_share": sum(r["sp_train"]["comm_s"]) / (sum(r["sp_train"]["ms"]) / 1e3)}
                             for r in group]}
            if len(sp_gaps) != len(gaps) // (FMESH_NEW + 1) or max(sp_gaps) > SERVE_MESH_TOL:
                failed.append(f"{arch} {grid} SEQ_SHARD: logits gap {seq['max_gap']} against 1x1, bound {SERVE_MESH_TOL}")
            if not max(seq["first_step_rel"].values()) <= TRAIN_MESH_REL:
                failed.append(f"{arch} {grid} SEQ_SHARD: step against 1x1 {seq['first_step_rel']},"
                              f" bound {TRAIN_MESH_REL}")
        rows.append({
            "arch": arch, "grid": grid, "layers": f"{cfg.n_layers} of {configs.get_config(arch).n_layers}",
            "encoder_layers": cfg.encoder.n_layers if cfg.encoder is not None else None,
            "mtp": cfg.mtp_depth, "experts_per_rank": group[0]["experts"],
            "cache_specs": group[0]["serve"]["cache_specs"],
            "tokens": [FMESH_B, fmesh_seq(arch)], "new": FMESH_NEW, "max_gap": max(gaps, default=None),
            "gap_per_step": gaps[: FMESH_NEW + 1], "max_gap_by_rank": by_rank, "serve_tolerance": SERVE_MESH_TOL,
            "greedy_equal_1x1": all(a == np.argmax(ref["logits"][step][r["serve"]["rows"][0]:r["serve"]["rows"][1]],
                                                   axis=-1).tolist()
                                    for r in group for step, a in enumerate(r["serve"]["argmax"])),
            "train_steps": len(tr0["losses"]), "optimizer": arch not in FMESH_NO_OPT,
            "losses": tr0["losses"], "grad_norm": tr0["grad_norm"], "losses_1x1": single["losses"],
            "grad_norm_1x1": single["grad_norm"], "first_step_rel": first, "train_tolerance": TRAIN_MESH_REL,
            "b6_launches_per_prefill": [r["serve"]["b6_prefill"] for r in group], "b6_plan": want_b6,
            "b6_launches_per_step": tr0["b6_launches"],
            "ranks": [{"rank": r["serve"]["rank"], "coords": r["serve"]["coords"], "draw_s": r["draw"]["s"],
                       "draw_peak_gb": r["draw"]["peak_gb"], "gather_s": r["draw"]["gather_s"],
                       "prefill_ms": r["serve"]["prefill_ms"],
                       "decode_ms_median": _median(r["serve"]["decode_ms"]),
                       "serve_comm_share": r["serve"]["comm_s"] / (
                           (r["serve"]["prefill_ms"] + sum(r["serve"]["decode_ms"])) / 1e3),
                       "serve_peak_gb": r["serve"]["peak_gb"], "ms_per_step": r["train"]["ms"],
                       "step_comm_share": sum(r["train"]["comm_s"]) / (sum(r["train"]["ms"]) / 1e3),
                       "train_peak_gb": r["train"]["peak_gb"]} for r in group],
            "single": {"serve_s": ref["serve_s"], "ms_per_step": single["ms"], "peak_gb": single["peak_gb"],
                       "card": ref["card"]},
            "seq_shard": seq,
        })
    emit({"phase": "families_mesh", "gpu": nvidia_smi(), "groups": rows, "single_wall_s": refs.seconds(),
          "single_card_margin_gb": min(r["card"]["total_gb"] - r["card"]["bound_gb"] for r in results.values()),
          "ranks_wall_s": ranks_s, "parent_allocated_gb": parent_gb, "launches": launches, "failed": failed})
    if failed:
        raise AssertionError(f"families_mesh: {failed}")
    check_counts(launches, ("flash_attention",), "families_mesh path")
    return launches


def mesh_ranks(mesh, train_runs: dict | None, serve_groups: list, seed: int,
               refs: dict | None, long_refs: dict | None = None) -> tuple[dict | None, list, list, list]:
    """One rank of ``mesh_phase``: ``train_mesh``'s runs (none where
    ``train_runs`` is None), ``serve_mesh``'s groups, then
    ``families_mesh``'s (none where ``refs`` is None), then
    ``long_mesh``'s (none where ``long_refs`` is None)."""
    train = None if train_runs is None else train_mesh_ranks(mesh, train_runs)
    grids: dict = {}  # one set of process groups a grid, over the families' and the long-context groups
    served = serve_mesh_ranks(mesh, serve_groups)
    fam = [] if refs is None else families_mesh_ranks(mesh, seed, refs, grids)
    return train, served, fam, [] if long_refs is None else long_mesh_ranks(mesh, seed, long_refs, grids)


def mesh_phase(seed, phases=MESH_PHASES, refs: dict | None = None, device="cuda:0",
               train_extra=(), train_plan: TrainMeshPlan | None = None) -> dict[str, dict[str, int]]:
    """The mesh phases of ``phases``, their runs and groups in one spawn of
    4 gloo ranks on the one card (``mesh_ranks``), which start and warm up
    once.

    ``train_mesh``: training over a 2x2 mesh, with and without sequence
    parallelism and with int8 moments, beside 1x1 (``train_mesh_plan``
    before the spawn, in a process of its own: ``train_plan``, started by
    ``main`` beside the lake's draw, here when none is given;
    ``train_mesh_ranks`` in the spawn, ``train_mesh_report`` after;
    ``train_extra``: more driver arguments, ``--device cpu`` for a
    rehearsal).

    ``serve_mesh``: prefill and decode over a mesh (``SERVE_MESH``): for
    each dense decoder, ``SERVE_MESH_B`` prompts of ``SERVE_MESH_S`` tokens
    drawn from ``seed`` and ``SERVE_MESH_NEW`` greedy decode steps at 1x1
    in this process first (``serve_mesh_refs``: published widths, cut to
    ``SERVE_MESH_LAYERS`` layers, random weights from ``seed`` with the
    attention projections rescaled, ``conditioned``), then the same prefill
    and decode tokens on the ranks, one configuration after the other
    (``serve_mesh_rank``: this rank's shards and rows, the cache placed by
    ``cache_pspec_for``).  Held: prefill's last-token logits and every
    decode step's within ``SERVE_MESH_TOL`` of max|logit| of the 1x1 run;
    B.6 launches per rank per prefill equal to the layers kept; every cache
    leaf on the card at its local shape.  Printed, not held: the greedy
    tokens against 1x1's (near ties may flip), prefill and decode ms per
    rank, the collectives' share.

    ``families_mesh``: tensor and expert parallelism for every family
    beside the dense decoders (``FAMILIES_MESH``): each cut model's 1x1 run
    in a process of its own (``refs``: started beside the lake's draw by
    ``main``, here when none is given), then the ranks take the groups one
    after the other (``families_mesh_ranks``).  Held, per group: prefill's
    and every decode step's logits (float32) within ``SERVE_MESH_TOL`` of
    max|logit| of 1x1's; the first training step's loss and gradient norm
    within ``TRAIN_MESH_REL`` of 1x1's, and every rank's losses equal; B.6
    launches per rank per prefill equal to the plan (``flash_per_prefill``);
    every cache leaf and parameter shard on the card, each cache leaf at
    its shard's shape; E/M experts a rank on every MoE layer where M
    divides E.  Printed per rank: the draw's seconds and peak GB, prefill
    ms, decode ms (median), ms per step, the collectives' share of serving
    and of a step, the steps' peak GB; per 1x1 run, the card's memory in
    use beside it.  The path's B.6 launches are the ranks' own, from each
    group's prefill, decode and steps.

    ``long_mesh``: serving at batch 1, which the 2 data ranks of the 2x2
    grid do not divide (``LONG_MESH``): each cut model's 1x1 run after the
    families' in the same process (``long_mesh_single``), then the ranks
    (``long_mesh_ranks``).  Held, per group: prefill's and every decode
    step's logits (float32) within ``LONG_MESH_TOL`` of max|logit| of
    1x1's, on every rank the one row; B.6 launches per rank per prefill
    equal to the attention layers; every cache leaf on the card at its
    shard's shape.  Printed: each decode step's collectives by kind, per
    rank the draw, gather, prefill, fill and decode times and the card's
    memory in use; the 1x1 run's decode ms and its card beside them.

    ``refs``: the 1x1 runs (``side_refs``: started beside the lake's draw
    by ``main``, here when none are given).

    Each phase's line carries the seconds of the whole spawn and is printed
    before a failed check raises.  Returns each phase's launches."""
    from repro_torch.launch import mesh as meshlib

    if "train_mesh" in phases:
        train_plan = train_plan or TrainMeshPlan(seed, device, train_extra)
    try:
        plan = train_plan.get() if "train_mesh" in phases else None
        serve_refs = serve_mesh_refs(seed, device) if "serve_mesh" in phases else None
        refs = side_refs(seed, phases, device) if refs is None else refs
        fam_refs, long_refs = refs.get("families_mesh"), refs.get("long_mesh")
        parent_gb = _parent_gb(device)
        groups = serve_mesh_groups(seed, serve_refs) if serve_refs else []
        fam = fam_refs.get() if fam_refs else None
        long = long_refs.get() if long_refs else None
        t = time.perf_counter()
        ranks = meshlib.run_ranks(mesh_ranks, MESH_SERVING_RANKS, backend="gloo",
                                  devices=[device] * MESH_SERVING_RANKS,
                                  args=(plan and plan["ranks"], groups, seed, fam, long),
                                  timeout_s=TRAIN_MESH_TIMEOUT_S, env=FMESH_ENV)
        wall = time.perf_counter() - t
        out = {}
        if plan:
            out["train_mesh"] = train_mesh_report(plan, [r[0] for r in ranks], wall)
    finally:
        if train_plan is not None:
            train_plan.cleanup()
    if serve_refs:
        out["serve_mesh"] = serve_mesh_report(serve_refs, [r[1] for r in ranks], wall)
    if fam_refs:
        out["families_mesh"] = families_mesh_report(fam_refs, [r[2] for r in ranks], wall, parent_gb, device)
    if long_refs:
        out["long_mesh"] = long_mesh_report(long_refs, [r[3] for r in ranks], wall, device)
    return out


# one process running ``module.main(argv + ['--out-dir', D])`` for each argv
# of a list, one after the other
DRYRUN_CHAIN = ("import importlib, json, sys\n"
                "main = importlib.import_module(sys.argv[1]).main\n"
                "for argv in json.loads(sys.argv[2]):\n"
                "    main(argv + ['--out-dir', sys.argv[3]])\n")


class DryRuns:
    """The dry runs' subprocesses (``DRYRUN_CALLS``), each writing its
    cells into one directory and its output to files there; a thread per
    process notes when it exited.  ``main`` starts the tracing ones here,
    before the kernel build: they trace on fake tensors, need no kernel
    and allocate nothing on the card, and run at a lower priority (nice
    ``DRYRUN_NICE``), so they take the cores that nvcc, then the lake's
    draw, the families' 1x1 runs and ``dryrun_mate`` leave idle.
    ``dryrun_mate``, whose sharded build's ranks launch B.3 on the card,
    starts after the build (``start_built``) at the normal priority.
    ``main`` ``wait``s for them all before the kernel phase, the first that
    times anything: no time is taken while they share the host or the
    card.  ``dryrun_phase`` reads what they wrote.  ``stop`` kills what
    still runs."""

    def __init__(self):
        import tempfile

        self.root = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=os.path.join(self.root, "src"))
        self.out_dir = tempfile.mkdtemp(prefix="dryrun_")
        self.t0 = time.perf_counter()
        self.procs, self.ended, self.waited_s = [None] * len(DRYRUN_CALLS), [None] * len(DRYRUN_CALLS), 0.0
        self._start(built=False)

    def start_built(self) -> None:
        """Start the entry points that launch kernels (after the build)."""
        self._start(built=True)

    def _start(self, built: bool) -> None:
        import threading

        for i, (module, argvs, _) in enumerate(DRYRUN_CALLS):
            if module.endswith("dryrun_mate") != built:
                continue
            cmd = [sys.executable, "-c", DRYRUN_CHAIN, module, json.dumps(argvs), self.out_dir]
            with open(os.path.join(self.out_dir, f"{i}.out"), "w") as out, \
                    open(os.path.join(self.out_dir, f"{i}.err"), "w") as err:
                p = subprocess.Popen(cmd, cwd=self.root, env=self.env, stdout=out, stderr=err, text=True)
            if not built:
                os.setpriority(os.PRIO_PROCESS, p.pid, DRYRUN_NICE)
            self.procs[i] = p
            threading.Thread(target=self._wait, args=(i, p), daemon=True).start()

    def wait(self) -> float:
        """Wait for every process, killing any still running
        ``DRYRUN_TIMEOUT_S`` after the start; returns the seconds waited
        in all."""
        t = time.perf_counter()
        for p in filter(None, self.procs):
            try:
                p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - self.t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.waited_s += time.perf_counter() - t
        return self.waited_s

    def _wait(self, i: int, p) -> None:
        p.wait()
        self.ended[i] = time.perf_counter() - self.t0

    def output(self, i: int, stream: str) -> str:
        with open(os.path.join(self.out_dir, f"{i}.{stream}")) as f:
            return f.read()

    def stop(self) -> None:
        import shutil

        for p in filter(None, self.procs):
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(self.out_dir, ignore_errors=True)


def dryrun_phase(runs_started: DryRuns) -> dict[str, int]:
    """The dry runs' entry points as users run them (each ``main`` with a
    user's argv), in subprocesses on this card's torch, started around
    the kernel build and waited for before the kernel phase
    (``DryRuns``): ``repro_torch.launch.dryrun`` over
    qwen1.5-0.5b's four shapes at 16x16 (then its prefill_32k and
    train_4k under sequence parallelism and its train_4k under the 'dots'
    and 'none' remat policies, in the same process), qwen3-32b's train_4k
    at both production meshes, train_4k and decode_32k of the six other
    families (deepseek-v3's train_4k at 2x16x16 too, mamba2's long_500k),
    and ``repro_torch.launch.dryrun_mate`` with its sharded build on 4 gloo ranks
    on the card.  Each cell is rank 0's program traced on fake CUDA tensors
    at the production mesh: planned figures for an H100 cluster, not
    timings.  Held: every expected cell's status (qwen1.5-0.5b's int8
    train_4k cell ``ok``: its moments replicated), no kernel launched in a
    cell (each cell's measured ``kernel_launches`` 0; the trace also raises
    on any), the build byte-identical and B.3 launched by its ranks.  The
    path's launches are the build ranks' own, summed over the ranks (the
    build's ``[build] kernel launches`` line).  Printed per cell: FLOPs per device, argument and temp
    GB, collective MB by kind, the trace's seconds; per run its seconds
    from the start; the train_4k cells' temp GB beside ``DRY_TEMP_GB``."""
    dry = runs_started
    cells, runs, failed = [], [], []
    launches = {name: 0 for name in counters()}
    wait_s = dry.wait()  # main waited before the kernel phase: nothing more here
    for i, ((module, argvs, expect), p) in enumerate(zip(DRYRUN_CALLS, dry.procs)):
        build = [ln for ln in dry.output(i, "out").splitlines() if ln.startswith("[build]")]
        runs.append({"module": module, "argvs": argvs, "exit": p.returncode, "ended_s": dry.ended[i], "build": build})
        if p.returncode:
            failed.append(f"{module} {argvs}: exit {p.returncode}: {dry.output(i, 'err')[-2000:]}")
            continue
        if module.endswith("dryrun_mate"):
            if not (build and build[0].endswith("identical_to_single_host=True")):
                failed.append(f"{module}: the sharded build: {build}")
            for ln in build:
                if ln.startswith("[build] kernel launches over the ranks: "):
                    for name, n in json.loads(ln.split(": ", 1)[1]).items():
                        launches[name] += n
        for name, want in expect.items():
            with open(os.path.join(dry.out_dir, name + ".json")) as f:
                rec = json.load(f)
            status = "skipped" if rec.get("skipped") else "error" if "error" in rec else "ok"
            last = rec["error"].strip().splitlines()[-1] if "error" in rec else None
            kind, _, item = want.partition(":")
            if status != kind or (item and item not in last):
                failed.append(f"{name}: {status} ({last}), expected {want}")
            if status == "ok" and rec.get("kernel_launches") != 0:
                failed.append(f"{name}: {rec.get('kernel_launches')} kernel launches")
            row = {"cell": name, "status": status, "error": last}
            if status == "ok":
                ma, hc = rec["memory_analysis"], rec["hlo_cost"]
                row.update(flops_per_device=hc["flops"], argument_gb=ma["argument_size_in_bytes"] / 1e9,
                           temp_gb=ma["temp_size_in_bytes"] / 1e9, output_gb=ma["output_size_in_bytes"] / 1e9,
                           collective_mb={k: v / 1e6 for k, v in hc["collective_bytes"].items() if v},
                           collective_counts={k: int(v) for k, v in hc["collective_counts"].items() if v},
                           param_bytes_per_device=rec.get("param_bytes_per_device"),
                           trace_s=rec["compile_seconds"], trace_device=rec["trace_device"])
                if name in DRY_LONG_KV_BYTES:  # the cache's bytes: the arguments less the shards and the token
                    cache = ma["argument_size_in_bytes"] - rec["param_bytes_per_device"] - 8
                    row.update(cache_argument_bytes=cache, kv_bytes_planned=DRY_LONG_KV_BYTES[name])
                    if cache < DRY_LONG_KV_BYTES[name]:
                        failed.append(f"{name}: cache arguments {cache} B, below its K/V shards'"
                                      f" {DRY_LONG_KV_BYTES[name]} B")
            cells.append(row)
    temp = {row["cell"]: row["temp_gb"] for row in cells if "temp_gb" in row}
    emit({"phase": "dryrun", "gpu": nvidia_smi(), "planned_not_timed": True, "cells": cells, "runs": runs,
          "waited_s": wait_s,
          "train_4k_temp_gb": {name: {"now": temp.get(name), **known} for name, known in DRY_TEMP_GB.items()},
          "launches": launches, "failed": failed})
    if failed:
        raise AssertionError(f"dryrun: {failed}")
    check_counts(launches, ("xash_superkey",), "dryrun path (the sharded build's ranks)")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the discovery driver, as a user runs it, at the smoke's lake
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def reuse_corpus(spec, cells):
    """While active, ``synthetic.make_corpus(spec)`` returns a corpus built
    from ``cells`` — the tables that call generated earlier in this run,
    copied before any query was planted into them — instead of drawing
    them again (minutes of host time at 20,000 tables)."""
    from repro_torch.core.corpus import Corpus, Table
    from repro_torch.data import synthetic

    original = synthetic.make_corpus

    def make(s):
        if s != spec:
            return original(s)
        return Corpus([Table(tid, [list(r) for r in rows]) for tid, rows in enumerate(cells)])

    synthetic.make_corpus = make
    try:
        yield
    finally:
        synthetic.make_corpus = original


@contextlib.contextmanager
def record_calls(module, name: str):
    """While active, every call of ``module.name`` appends (args, result)."""
    inner, calls = getattr(module, name), []

    def recording(*args):
        out = inner(*args)
        calls.append((args, out))
        return out

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def _one(pattern: str, lines: list[str]) -> re.Match:
    hits = [m for m in (re.search(pattern, ln) for ln in lines) if m]
    if len(hits) != 1:
        raise AssertionError(f"expected one driver line matching {pattern!r}, got {len(hits)}")
    return hits[0]


def driver_phase(args, cells) -> dict[str, int]:
    """``repro_torch.launch.discovery.main`` in this process at the smoke's
    lake (``--n-tables`` tables from ``--seed``): the default config (128
    bits, 'fused-gather', rank 'quality', gate on), ``DRIVER_ARGV`` — FDs,
    the serving caches, a 4-shard routed lake, the build across 2 ranks and
    the row filter over a 2x2 grid of ranks (the rows over 'data', each
    block replicated over 'model').  Its printed lines are parsed and held:
    every engine set identical, the routed top-k bit-identical, every
    request served and every replay from the cache, the 2-rank build
    byte-identical (the driver exits otherwise) and each of the 4 filter
    ranks' counts equal to ``ops.filter_hits_table_counts`` over every
    corpus row for the same keys (kernel B.4 on the card; rows with a hit
    per table, matching rows per key).  Launches are counted around ``main`` only: the
    parent's; the ranks report their own."""
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import discovery as drv

    argv = ["--n-tables", str(args.n_tables), "--seed", str(args.seed), *DRIVER_ARGV]
    total, buf = collections.Counter(), io.StringIO()
    spec = synthetic.SyntheticSpec(n_tables=args.n_tables, seed=args.seed)
    with reuse_corpus(spec, cells), record_calls(drv, "mesh_build") as builds, \
            record_calls(drv, "mesh_filter") as filters:
        t = time.perf_counter()
        try:
            with path_window(total), contextlib.redirect_stdout(buf):
                drv.main(argv)
                torch.cuda.synchronize()
        except BaseException:
            print(buf.getvalue(), file=sys.stderr)
            raise
        wall = time.perf_counter() - t
    lines = buf.getvalue().splitlines()
    launches = check_counts(total, DRIVER_KERNELS, "driver path")

    n_queries = int(DRIVER_ARGV[DRIVER_ARGV.index("--queries") + 1])
    if sum("engines_set_identical=True" in ln for ln in lines) != n_queries:
        raise AssertionError("an engine set differs (or a query line is missing)")
    total_m = _one(r"total: precision=([\d.]+) filter_checks=(\d+) seq=([\d.]+)s "
                   r"batched=([\d.]+)s", lines)
    routed_m = _one(r"routed lake \((\d+) shards.*bit_identical=(\w+), shard_launches=(\d+), "
                    r"gather_demotions=(\d+)", lines)
    traffic_m = _one(r"route_bytes_merged=(\d+)B .* vs (\d+)B", lines)
    served_m = _one(r"DiscoveryEngine: (\d+) requests .*all_served=(\w+)", lines)
    cache_m = _one(r"serving caches: .*cache_hits=(\d+), bound_hits=(\d+), all_from_cache=(\w+)",
                   lines)
    build_m = _one(r"build stats: shards=(\d+) mesh=\{'data': (\d+)\} hash=([\d.]+)s "
                   r"superkeys=([\d.]+)s postings=([\d.]+)s merge=([\d.]+)s", lines)
    fd_m = _one(r"FD workload .*candidates=(\d+) validated=(\d+) pruned=(\d+) "
                r"bytes_verified=(\d+)B", lines)
    mesh_m = _one(r"distributed filter on mesh 2x2 \(impl=(\w+)\): (\d+) candidate rows across "
                  r"(\d+) tables in ([\d.]+)s", lines)
    if routed_m.group(2) != "True":
        raise AssertionError("routed top-k is not bit-identical")
    if served_m.group(2) != "True" or cache_m.group(3) != "True":
        raise AssertionError("a request was not served, or a replay missed the cache")
    if build_m.group(1, 2) != ("2", "2") or len(builds) != 1:
        raise AssertionError("the build did not run across 2 ranks")
    digests = {r["digest"] for r in builds[0][1]}
    if len(digests) != 1:
        raise AssertionError("the build ranks' artifacts differ")

    # every rank's counts (2 row blocks over 'data', each replicated over 'model') against the
    # single-host launch
    (superkeys, row_tables, qsk, n_tables, _backend, grid, _dev), ranks = filters[0]
    world = grid["data"] * grid["model"]
    if len(ranks) != world or world != 4:
        raise AssertionError(f"the mesh filter ran on {len(ranks)} ranks of {grid}, expected 4")
    dev = torch.device("cuda")
    elig = np.ones((superkeys.shape[0], qsk.shape[0]), dtype=bool)
    hits, _ = ops.filter_hits_table_counts(superkeys, qsk, elig, row_tables, n_tables,
                                           backend="pallas", device=dev)
    rt = torch.from_numpy(row_tables).to(dev).long()
    any_counts = torch.zeros(n_tables, dtype=torch.int64, device=dev).index_add_(
        0, rt, hits.any(dim=1).long()).cpu().numpy()
    key_counts = hits.sum(dim=0).cpu().numpy()
    for r in ranks:
        if not (np.array_equal(r["table_counts"], any_counts)
                and np.array_equal(r["key_counts"], key_counts)):
            raise AssertionError("the mesh filter's counts differ from the single-host launch")
    if int(mesh_m.group(2)) != int(any_counts.sum()) or int(mesh_m.group(3)) != int((any_counts > 0).sum()):
        raise AssertionError("the printed mesh counts differ from the single-host launch")

    emit({"phase": "driver", "argv": argv, "wall_s": wall, "queries": n_queries,
          "seq_s": float(total_m.group(3)), "batched_s": float(total_m.group(4)),
          "precision": float(total_m.group(1)), "filter_checks": int(total_m.group(2)),
          "routed": {"shards": int(routed_m.group(1)), "bit_identical": True,
                     "shard_launches": int(routed_m.group(3)),
                     "gather_demotions": int(routed_m.group(4)),
                     "route_bytes_merged": int(traffic_m.group(1)),
                     "host_gather_bytes": int(traffic_m.group(2))},
          "served": int(served_m.group(1)), "all_served": True,
          "cache_hits": int(cache_m.group(1)), "bound_hits": int(cache_m.group(2)),
          "all_from_cache": True,
          "build_mesh": {"ranks": len(builds[0][1]), "byte_identical": True,
                         "rank_build_s": [r["seconds"] for r in builds[0][1]],
                         "hash_s": float(build_m.group(3)), "superkeys_s": float(build_m.group(4)),
                         "postings_s": float(build_m.group(5)), "merge_s": float(build_m.group(6))},
          "fd": {"candidates": int(fd_m.group(1)), "validated": int(fd_m.group(2)),
                 "pruned": int(fd_m.group(3)), "bytes_verified": int(fd_m.group(4))},
          "mesh_filter": {"ranks": world, "grid": grid, "impl": mesh_m.group(1), "n_tables": n_tables,
                          "query_keys": int(qsk.shape[0]), "rows_with_hits": int(any_counts.sum()),
                          "tables_with_hits": int((any_counts > 0).sum()),
                          "counts_equal_single_host": True, "s": float(mesh_m.group(4)),
                          "rank_launches": [r["launches"] for r in ranks]},
          "launches": launches, "lines": lines})
    return launches


# ---------------------------------------------------------------------------
# Phase 13: two-package conformance, the port's half, on the card
# ---------------------------------------------------------------------------

def conformance_phase() -> dict[str, int]:
    """``tests/test_conformance.py``'s scenario on the card: the lake of
    ``conftest.mixed_query_lake`` with that module's parameters (re-made by
    the port's generator), the planted-FD lake of seed 3, every backend of
    the port's registry × 128/256/512 bits against 'numpy' on
    ``discover_batched``, ``discover_many``, ``plan_and_count``'s count
    vectors with ``score_from_counts`` at two k, and ``discover_fds``'s
    verdicts — exactly — with the stats invariant: fused backends report
    ``filter_matrix_bytes == 0``, the others more.  Launches are counted
    around the compared backends' calls; the builds and 'numpy''s answers
    run outside."""
    from repro_torch.core import batched, fd, xash
    from repro_torch.core.index import build_index
    from repro_torch.data import synthetic
    from repro_torch.kernels import registry

    lake = CONFORMANCE_LAKE
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=lake["n_tables"],
                                                           seed=lake["corpus_seed"]))
    queries = synthetic.make_mixed_queries(corpus, lake["n_queries"], lake["n_rows"],
                                           lake["key_width"], seed=lake["query_seed"])
    fd_corpus, fd_query, det_cols, dep_col = planted_fd_lake(CONFORMANCE_FD_SEED)
    k = CONFORMANCE_K
    total, cells, t0 = collections.Counter(), {}, time.perf_counter()

    def surfaces(idx, fd_idx, bk):
        single, st = batched.discover_batched(idx, queries[0][0], queries[0][1], k=k, backend=bk)
        many = batched.discover_many(idx, queries, k=k, backend=bk)
        pcs = batched.plan_and_count(idx, queries, bk)
        scored = [[key(batched.score_from_counts(idx, pc, kk)[0]) for pc in pcs] for kk in (k, 3)]
        fds, fd_st = fd.discover_fds(fd_idx, fd_query, det_cols, dep_col, backend=bk)
        torch.cuda.synchronize()
        answers = {"discover_batched": key(single), "discover_many": [key(e) for e, _ in many],
                   "counts": [np.asarray(pc.counts).tolist() for pc in pcs], "scored": scored,
                   "fds": [dataclasses.astuple(c) for c in fds]}
        return answers, {"discover": st.filter_matrix_bytes, "fd": fd_st.filter_matrix_bytes,
                         "filter_checks": st.filter_checks}

    for bits in (128, 256, 512):
        idx = build_index(corpus, cfg=xash.XashConfig(bits=bits))[0]
        fd_idx = build_index(fd_corpus, cfg=xash.XashConfig(bits=bits))[0]
        want, _ = surfaces(idx, fd_idx, registry.resolve_backend("numpy"))
        if not (want["discover_batched"] and want["fds"]):
            raise AssertionError("the conformance lake gives empty answers")
        for name in registry.backend_names():
            bk = registry.resolve_backend(name)
            with path_window(total):
                got, matrix = surfaces(idx, fd_idx, bk)
            drift = [s for s in want if got[s] != want[s]]
            if drift:
                raise AssertionError(f"{name} at {bits} bits differs from 'numpy' on {drift}")
            if bk.fused and (matrix["discover"] or matrix["fd"]):
                raise AssertionError(f"{name} at {bits} bits materialised a match matrix")
            if not bk.fused and not (matrix["filter_checks"] and matrix["discover"] > 0):
                raise AssertionError(f"{name} at {bits} bits reports no match matrix")
            cells[f"{name}@{bits}"] = {"filter_matrix_bytes": matrix["discover"],
                                       "fd_filter_matrix_bytes": matrix["fd"]}
    launches = check_counts(total, MAIN_PATH_KERNELS, "conformance path")
    emit({"phase": "conformance", "backends": list(registry.backend_names()),
          "bits": [128, 256, 512], "identical_to_numpy": True, "cells": cells,
          "wall_s": time.perf_counter() - t0, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the example twins on the card
# ---------------------------------------------------------------------------

def examples_phase() -> dict[str, int]:
    """Each ``examples/torch_*.py`` twin's ``main`` at its defaults on the
    card (counted), then with ``--device cpu`` (not counted).  Each must
    exit 0 and print what it should (``EXAMPLE_EXPECT``); the lines
    ``tests/test_torch_examples.py`` holds equal to the reference example's
    must be equal between the card and the CPU, with times, rates, sampled
    tokens and the backend's name (the card's default is the gather kernel)
    masked."""
    import importlib.util

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
    masks = [(re.compile(r"\d+\.\d+s\b"), "<t>s"), (re.compile(r"\d+\.\d+ tok/s"), "<rate> tok/s"),
             (re.compile(r"\.\.\. -> \[.*\]$"), "... -> <sampled>"),
             (re.compile(r"^latency: .*"), "latency: <masked>"),
             (re.compile(r"\((CPU|CUDA), reduced"), "(<device>, reduced"),
             (re.compile(r"backend(=|: )[\w-]+(\[\w+\]| \[resolved from \w+\])?"), "backend <b>"),
             (re.compile(r"impl=[\w-]+"), "impl=<impl>"),
             (re.compile(r"loss \d+\.\d+( -> \d+\.\d+)?"), "loss <l>"),
             (re.compile(r"\(\d+\.\d+ steps/s\)"), "(<rate> steps/s)")]

    def masked(lines):
        out = []
        for line in lines:
            for pattern, repl in masks:
                line = pattern.sub(repl, line)
            out.append(line)
        return out

    def run(name, argv, window):
        spec = importlib.util.spec_from_file_location(f"twin_{name}", os.path.join(root, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        buf, status, t = io.StringIO(), 0, time.perf_counter()
        with window, contextlib.redirect_stdout(buf):
            try:
                module.main(argv)
            except SystemExit as e:
                status = e.code if isinstance(e.code, int) else 1
            torch.cuda.synchronize()
        return status, buf.getvalue().splitlines(), time.perf_counter() - t

    total, report = collections.Counter(), {}
    for name, expect in EXAMPLE_EXPECT.items():
        status, lines, wall = run(name, [], path_window(total))
        cpu_status, cpu_lines, cpu_wall = run(name, ["--device", "cpu"], contextlib.nullcontext())
        if status or cpu_status:
            raise AssertionError(f"{name} exited {status} on the card, {cpu_status} on the CPU")
        missing = [e for e in expect if not any(e in ln for ln in lines)]
        if missing:
            raise AssertionError(f"{name} printed none of {missing}")
        if masked(lines) != masked(cpu_lines):
            raise AssertionError(f"{name}: the card's lines differ from the CPU's:\n"
                                 + "\n".join(lines) + "\n---\n" + "\n".join(cpu_lines))
        report[name] = {"exit": status, "wall_s": wall, "cpu_wall_s": cpu_wall,
                        "compared_lines": masked(lines)}
    launches = check_counts(total, EXAMPLE_KERNELS, "examples path")
    emit({"phase": "examples", "twins": report, "launches": launches})
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-tables", type=int, default=20000, help="tables in the main path's lake")
    ap.add_argument("--seed", type=int, default=0, help="seed of the lake and the kernel inputs")
    ap.add_argument("--only", default=None,
                    help=f"comma list of phases to run alone after the build ({', '.join(ONLY_PHASES)}):"
                         " their lines and wall times, no kernels line and no result line (the mesh"
                         " phases asked for together share one spawn, as in the whole run)")
    args = ap.parse_args()
    only = args.only.split(",") if args.only else None
    if only and set(only) - set(ONLY_PHASES):
        ap.error(f"--only takes {', '.join(ONLY_PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import _build

    # host-side traces beside the build and the lake's draw, the families'
    # 1x1 runs and then train_mesh's (one process) beside the lake's draw;
    # all waited for before the kernel phase
    dry = DryRuns() if only is None or "dryrun" in only else None
    train_plan = None
    try:
        nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                              check=True).stdout
        release = re.search(r"release ([\d.]+)", nvcc)
        t0 = time.perf_counter()
        build_s = _build.build_all()
        emit({"phase": "environment", "gpu": nvidia_smi(), "torch": torch.__version__,
              "torch_cuda": torch.version.cuda, "nvcc_release": release and release.group(1),
              "build_s": build_s, "build_wall_s": time.perf_counter() - t0})
        for name, log in _build.build_log.items():
            emit({"phase": "ptxas", "library": name,
                  "report": [ln.strip() for ln in log.splitlines()
                             if "entry function" in ln or "registers" in ln or "spill" in ln
                             or "serialized" in ln],
                  "sass_wgmma": sass_count(_build._lib_path(name), "HGMMA")})
        if dry is not None:
            dry.start_built()
        train_plan = TrainMeshPlan(args.seed, families=True) if only is None else None
        if only:
            mesh = tuple(n for n in MESH_PHASES if n in only)  # the mesh phases asked for share one spawn
            for name in dict.fromkeys(mesh if n in mesh else n for n in only):
                t = time.perf_counter()
                if name == mesh:
                    mesh_phase(args.seed, mesh)
                else:
                    dryrun_phase(dry) if name == "dryrun" else ONLY_PHASES[name](args.seed)
                emit({"phase": "only", "ran": "+".join(mesh) if name == mesh else name,
                      "wall_s": time.perf_counter() - t})
            return 0
        return _phases(args, dry, train_plan)
    finally:
        from repro_torch.launch import mesh as meshlib

        meshlib.release_prestarted()
        if dry is not None:
            dry.stop()
        if train_plan is not None:
            train_plan.cleanup()


def _phases(args, dry: DryRuns, train_plan: "TrainMeshPlan") -> int:
    """``main``'s phases after the kernel build."""
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as meshlib

    t0 = time.perf_counter()
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=args.n_tables, seed=args.seed))
    lake_cells = [[list(r) for r in t.cells] for t in corpus.tables]  # before any planting
    truth = []  # ground-truth queries, each planted into the lake; its arenas rebuilt once, after the last
    for i in range(N_TRUTH):
        query, q_cols, expected, corpus = synthetic.make_query_with_ground_truth(
            corpus, n_rows=30, seed=args.seed + 1 + i, rebuild=i == N_TRUTH - 1
        )
        truth.append((query, q_cols, expected))
    mixed = synthetic.make_mixed_queries(corpus, GROUP, 20, seed=args.seed + 100)
    emit({"phase": "corpus", "n_tables": args.n_tables, "rows": corpus.total_rows,
          "unique_values": len(corpus.unique_values),
          "cells": int((corpus.cell_value_ids >= 0).sum()), "wall_s": time.perf_counter() - t0})

    dry.wait()  # from here on, nothing timed shares the host or the card with them
    train_plan.get()
    rows, lane_prefixes = kernel_phase(args.seed, corpus)
    rows["flash_attention_backward"] = flash_grad_phase(args.seed)
    from repro_torch.core.session import DiscoveryConfig, MateSession
    from repro_torch.kernels import filter_kernel as fk
    from repro_torch.kernels import xash_kernel as xk

    # each path's own launches, counted from 0 around its calls
    by_path, walls = {}, {}

    def run(name, fn, *a):
        t = time.perf_counter()
        out = by_path[name] = fn(*a)
        walls[name] = time.perf_counter() - t
        return out

    with record_shapes(fk, "gather_filter_table_counts", b2_shape) as b2_shapes, \
            record_shapes(xk, "xash_superkey", b3_shape) as b3_shapes, \
            record_shapes(fk, "filter_match", b4_shape) as b4_shapes:
        t = time.perf_counter()
        by_path["main_path"], session = main_path_phase(corpus, truth, mixed, b2_shapes, b3_shapes,
                                                        b4_shapes)
        walls["main_path"] = time.perf_counter() - t
    run("ops_path", ops_phase, session, truth)
    session256 = MateSession.build(corpus, DiscoveryConfig(bits=256))
    run("lanes", lanes_phase, {128: session, 256: session256}, truth, mixed, lane_prefixes)
    del session256
    run("fd", fd_phase, session, truth)
    del session
    # each spawn's processes start a phase ahead (``meshlib.prestart``), so their start-up — seconds a
    # process — runs beside the phase before theirs instead of on the critical path
    meshlib.prestart(MESH_RANKS)  # routed's, taken after its builds
    run("routed", routed_phase, corpus, truth, mixed)
    run("serving_tier", serving_phase, corpus, truth, mixed, args.seed)
    run("serve", serve_phase, args.seed)
    run("families", families_phase, args.seed)
    meshlib.prestart(PIPE_STAGES)
    run("train", train_phase, args.seed)
    meshlib.prestart(MESH_SERVING_RANKS, devices=["cuda:0"] * MESH_SERVING_RANKS, env=FMESH_ENV)
    run("pipeline", pipeline_phase, args.seed)
    t = time.perf_counter()
    by_path.update(mesh_phase(args.seed, MESH_PHASES, train_plan.refs, train_plan=train_plan))
    walls["+".join(MESH_PHASES)] = time.perf_counter() - t
    run("dryrun", dryrun_phase, dry)
    meshlib.prestart(2)  # the driver's --build-mesh 2 and --mesh 2x2 ranks, taken after its session build
    meshlib.prestart(4)
    run("driver", driver_phase, args, lake_cells)
    del lake_cells
    run("conformance", conformance_phase)
    run("examples", examples_phase)
    emit({"phase": "timeline", "wall_s": walls, "since_corpus_s": time.perf_counter() - t0})
    # ``launches``: the count on the kernel's own path (HOME_PATH); every
    # path that launched it, with its own count, beside it
    for name, row in rows.items():
        row["launches"] = by_path[HOME_PATH[name]][name]
        row["launches_path"] = HOME_PATH[name]
        row["launches_by_path"] = {path: c[name] for path, c in by_path.items() if c[name]}
    emit({"kernels": list(rows.values())})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# the phases ``--only`` runs alone: each needs the kernel build and nothing
# else (the mesh phases and the dry runs are run by ``main`` itself)
ONLY_PHASES = {"flash": flash_phase, "flash_grad": flash_grad_phase, "train": train_phase, "train_mesh": None, "pipeline": pipeline_phase, "serve_mesh": None,
               "families_mesh": None, "long_mesh": None, "dryrun": None}


if __name__ == "__main__":
    sys.exit(main())
