#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's paths through their entry points, each with
every launch count set to 0 just before it and read just after. The first
eight run at the paper's Netflix scale (n = 17,770 items, m = 480,189 users,
d = 100, synthetic MF-like factors from ``--seed``):

  f32 reverse   ``RkMIPSEngine("sah").build(...)`` on the card, then
                ``query_batch`` at k = 10 and 50 over 16 queries drawn
                from the top 2% of items by norm (the titles a service
                would promote; from the top 20% no user at this scale has
                a query in its top 50, and the item scan never runs);
  mapped        ``query_batch_mapped`` (the legacy per-query driver) on
                the same engine and queries at k = 10 (k = 50 cut for
                time): predictions and plan counters bitwise
                ``query_batch``'s; its ms per query and ``query_batch``'s,
                medians of three runs each, alternated on the warm engine;
  int8 reverse  the same build and queries with ``scan_precision="int8"``
                (the fused int8 screen);
  forward       ``kmips(users, 10)`` for 4,096 users drawn with
                ``--seed`` (a service recomputing its users' top-10
                items), under the "sah" and the "exact" presets, and the
                exact answer from ``ops.ip_topk``;
  mesh          gloo worlds of 2 and 3 ranks, every rank a process on the
                one card (``spawn_worlds``, a ``file://`` rendezvous, the
                kernels this process built), run late, beside the
                model-parallel worlds (below; this process saves their
                answers here, ``mesh_answers``). Each rank
                rebuilds the index from ``--seed`` under a 1-D
                ``DeviceMesh`` (the row-parallel build stages), answers the
                16 queries at k = 10 in f32 and int8 on its shard of the
                users and the first 256 forward users by the sharded
                single-pass scan with ``n_cand`` a shard's rows; its
                fingerprint, index digest, predictions and per-user
                counters must equal this process's single-device ones bit
                for bit, its forward ids ``ip_topk``'s but for float ties,
                and its launches its own chunks and tile steps. Then the
                serving stack under the mesh, with ``serve_batch_size=8,
                serve_buckets=(1, 2, 4)``: the reverse server (f32, int8)
                bitwise those answers, the forward server for the 256
                users (bitwise the mesh ``kmips``; ``ip_topk``'s ids at
                ``n_cand`` a shard's rows; rungs 1, 2 and 4 bitwise the
                full batch), two runtimes under the controller rank (rank
                0 submits from 4 threads, the others replay; every ticket
                bitwise the synchronous flush; then the artifact phase's
                change and a compaction, landed on every rank with the
                single-device ``compact``'s digest) and a gateway of three
                tenants on one pool. Its ms/query and tickets/s are of
                ranks that share one card, with collectives staged through
                the host: not a multi-GPU speed;
  artifact      on the f32 engine's build: ``save`` and
                ``IndexArtifact.load`` (fingerprint and predictions
                equal); a catalogue change from ``--seed`` (64 deletes, 8
                of them in P', and 192 inserts, new versions of top-5%
                titles) served by the f32 and int8 reverse paths at k = 10
                and 50 (recall 1.0 against the oracle over the effective
                items, int8 equal to f32) and the forward path ("exact" ids
                equal to ``ip_topk``'s over the effective items); then
                ``compact``, equal bit for bit to a fresh build on the
                effective items from the same generator state;
  serving       on the f32 build with ``serve_batch_size=8,
                serve_buckets=(1, 2, 4)``: the reverse server (f32 and
                int8; 16 tickets and 3 more at rung 4) held against the f32
                batch, the forward server (the 4,096 users as single
                tickets, "sketch" and "exact" scans; rungs 1, 2 and 4 held
                bitwise against the full-batch flush), the threaded runtime
                (reverse: warmup, 4 submitter threads, the artifact phase's
                change and a background compaction, each wave held against
                a synchronous server on the same version; forward: the
                4,096 users), and a gateway of three tenants in one pool
                (reverse, reverse under a scan budget, forward);
  examples      the example twins (``repro_torch.examples``) through
                their ``run``: quickstart for each of the paper's
                baselines (``sah``, ``sa-simpfer``, ``h2-cone``,
                ``h2-simpfer``, ``simpfer``) and ``exact`` on the Netflix
                data and the 16 queries (reverse recall 1.0 against the
                oracle but for traced float ties); update_stream (4
                promoted items from the top 2%, the reference's 24 inserts
                and 8 retirements), serve_async (64 queries) and
                serve_multitenant (the 16 queries at the reference's k =
                5; its blitz probes' users to scan, and one probe's first
                ``EX_MT_PROBE_CHUNKS`` chunks timed) at the Netflix
                scale, each with its own checks; reverse_recommend and
                serve_retrieval on two-tower-retrieval at its published
                config (20 and 30 steps at batch 256; 17,770 items and
                480,189 users embedded, and a corpus of 1,000,000; the
                forward top-k ids against ``torch.topk(torch.matmul(...))``
                but for traced ties, no new signature after the warm
                flush); train_lm ``100m`` (50 steps at 8 x 256 under
                deterministic algorithms, once whole, once crashed at step
                30 and resumed from its step-25 checkpoint: bit for bit
                the whole run, no kernel); then ``ip_topk`` and the dense
                ``hamming_scores`` at the shapes these runs gave them,
                each against its plain version and timed;
  recsys        the recsys archs at full width, weights and feature ids
                (uniform per field) from ``--seed``: two-tower-retrieval
                (10M-row tables, towers 1024-512 -> 256) embeds 1,000,000
                candidate items, builds ``launch/serve.py::
                build_candidate_index`` (256 bits) and answers 64
                single-user requests by ``sah_retrieve_step`` (k = 100,
                n_cand = 512) and 64 by the exact ``ops.ip_topk``; then
                ``serve_p99`` (batch 512) of two-tower, DeepFM, xDeepFM
                and DIN, each model freed before the next;
  LM serving    qwen3-0.6b at full width and depth (28 layers, d 1024,
                vocab 151,936, bf16, weights drawn from ``--seed``) with
                ``attn_impl="flash"``: ``prefill`` of 4 prompts of 2,048
                tokens, then 32 greedy ``decode_step``s;
  MoE LM        olmoe-1b-7b at full width and depth (16 layers, d 2,048,
                64 experts top-8, ``d_ff_expert`` 1,024, vocab 50,304,
                bf16, 6.92 B parameters from ``--seed``), flash: the same
                prefill and 32 steps, the share of assignments each layer
                drops at capacity (from ``moe.route`` on each layer's
                input, by forward pre-hooks), none in decode;
  dense 12B     mistral-nemo-12b at full width and depth (40 layers, d
                5,120, 32 heads over 8 KV heads, vocab 131,072, bf16),
                flash: the same prefill and 8 steps (cut for time);
  train         the trainer (``make_train_step`` + ``train_loop``,
                chain(clip 1.0, adamw), deterministic algorithms on):
                qwen3-0.6b at full width and depth in bf16 (remat,
                chunked attention) on one repeated batch of 4 x 4,096
                tokens, 4 micro-batches a step: the first micro-batch's
                loss and gradient norm against float32, the loss falling,
                a run crashed at step 2 and resumed from its checkpoint bit
                for bit equal to the uninterrupted run, ``attn_impl=
                "flash"`` refusing grad; two-tower, DeepFM, xDeepFM and DIN
                at their ``train_batch`` (halved while it does not fit) and
                gat-cora at ``full_graph_sm``, each first loss against
                float64 and the loss falling. No hand-written kernel runs
                there (the reference's training runs no Pallas kernel). It
                first saves the model-parallel phase's training answers:
                the loss, gradient norm and the gradients of layers 0, 14
                and 27, the embedding, the head and the final norm, in
                bf16 and from the float32 copy, on the first one and two
                sequences, and the losses of 3 steps on each, and how far
                a second correct bf16 path (half the attention chunk)
                lies from the first against float32;
  bf16 repair   olmoe-1b-7b at full width cut to 2 layers, one Zipf
                sequence of 4,096 tokens: ``lm_loss``'s gradient norm
                without and with deterministic algorithms and from the
                float32 copy, each pair within 5e-2 (the gathers of a
                frequent token's rows add their gradients in float32);
  model         gloo worlds ("data", "model") of (1, 2) and (2, 2) ranks
  parallel      on the one card, weights from ``--seed`` as above, each
                rank held against answers the recsys, LM, MoE and train
                phases saved: qwen3-0.6b at full width, TP/SP flash
                prefill of
                the 4 x 2,048 prompts (the flash kernel on each rank's
                8 of 16 heads over 4 of 8 KV heads), then 32 split-KV
                greedy decode steps under the decode rules and 8 under the
                long-context ones, each fed the single-device tokens
                (no further from the float32 model than one device's bf16,
                1.25x margin, and within twice that distance of it: the
                prefill logits against the chunked bf16 prefill, as the
                LM phase's rule holds flash, the cache and decode logits
                against the single-device ones; greedy tokens equal but
                for traced near-ties); olmoe-1b-7b on
                (1, 2): expert parallelism of layer 0 and the last layer
                on the single-device inputs against the single-device
                ``_moe_local`` of each rank's tokens at the local
                capacity (drops exact),
                and layer 0's EP backward at the same capacity against
                the composition's gradients (within two bf16 ulps of each
                gradient's largest), then its EP prefill with each layer's
                drops; two-tower retrieval over the 1,000,000 candidates
                with both tables row-sharded (the item and user towers
                bitwise one device's, the 64 sketch requests' ids and
                values bitwise the single-device composition of the
                sharded scan). Then training in the same worlds, under
                the train rules: qwen3-0.6b at full width and depth on one
                4,096-token sequence a data rank, its loss and gradient
                norm within 1e-2 and 5e-2 of one device's and every held
                gradient (reduced, gathered) no further from float32 than
                one device's bf16 (mean and RMS distance within 1.25x,
                the max within 1.5x, and within 2x one device's max
                distance plus one bf16 ulp of its gradient:
                ``grad_close``; the spread of two correct single-device
                bf16 paths is measured beside it), its forward + backward
                timed again without the collective timers and without
                deterministic algorithms and profiled on rank 0 (on
                (1, 2)), 3 steps of
                chain(clip 1.0, adamw) each within 1e-2 of one device's
                loss and the loss falling, ``compressed_psum`` over
                "data" on (2, 2) (int32 sums exact against a host
                replay), and a run crashed at step 2 resumed from its
                sharded checkpoint bit for bit (2 layers at full width);
                olmoe-1b-7b's EP train step on (1, 2) at 2 layers, full
                width, nothing dropped, against one device by the same
                rules. Its times are of ranks that share one card: not a
                multi-GPU speed;
  mesh cells    in a (1, 2) world of their own, the cells under a mesh
                through ``cells.build_cell(..., mesh=)`` and
                ``materialize``: (a)
                ``qwen3_zero1``, qwen3-0.6b ``train_4k`` at full width cut
                to 8 layers and 2 sequences (one a rank), ZeRO-1 over
                both ranks, 2 steps of clip + Adafactor against one
                device's unsharded cell on the same sequences (loss 1e-2,
                gradient norm 5e-2; the held parameters and each rank's
                state shards against the cut of one device's by
                ``grad_close``), (b) gat-cora ``ogb_products`` cut to
                8,388,608 edges, both aggregations, a step's loss and
                gradient norm within 1e-4 of one device's on the same
                graph, (c) the SAH retrieval cell over 2^20 candidates,
                ids and values bitwise the single-device composition of
                the sharded scan (``srp_hash`` and the dense Hamming
                kernel), (d) qwen3-0.6b ``prefill_32k`` cut to one
                8,192-token prompt at TP-2, flash on each rank's heads,
                its gathered logits by the model-parallel LM rule; and,
                beside them on the host, (e) the mesh dry run (one rank
                of the 16x16 mesh on the meta device) of ``perf.py``'s
                ``qwen3_zero1`` and ``gat_dstpart`` and of dbrx-132b
                ``train_4k``, their per-device bytes printed. The cuts
                keep two ranks on one card within the phase's ~2 minutes;
  cells         the reference's cell catalogue at full width through
                ``launch/dryrun.py::run_cell(..., measure_it=True)``:
                each cell reckoned on the meta device, then one warm and
                one timed step on the card (``cell_cuts`` lists every
                cell, its cut and why: qwen3-0.6b ``prefill_32k``,
                ``decode_32k`` and ``long_500k``, olmoe-1b-7b
                ``train_4k`` under Adafactor, the four recsys archs'
                ``serve_bulk`` and ``retrieval_cand``, the SAH sketch
                retrieval cell, gat-cora's ``molecule``, ``minibatch_lg``
                and ``ogb_products``), each held to its check; flash at
                seq 32,768 against its plain version at the cell's
                shape, one (batch, head) pair at a time, and timed
                beside SDPA.

The gloo worlds run side by side, after the single-device phases, the
kernel times and the profiles, with no other work on the card
(``worlds_path``), and a memory reckoning decides when each starts
(``spawn_worlds``): in the order model-parallel (1, 2) and (2, 2), the
mesh cells' (1, 2), then the mesh worlds of 2 and 3 ranks, a world
starts as soon as its ranks' peaks (``WORLD_PEAK``, each rank's
allocator capped there), a CUDA context a rank and what this process
holds fit 80 GiB less 8 beside the worlds alive. Each start prints its
reckoning, and each rank's measured peak is printed beside its cap. The
mesh dry runs run beside them on the host. Each rank takes its share of
the host's cores as torch threads. A failing rank ends every rank of
every world and fails the smoke. The worlds' seconds and ms are taken
side by side. A line ``phase <name>: <s> s, <total> s since start``
ends each phase as it ends (stdout is line-buffered).

It

  1. prints the card (``nvidia-smi`` name and power limit) and versions;
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. fails unless every kernel of a path launched during that path (and
     ``hamming_nearest`` once per tile step of the f32 scan, as many times
     as ``fused_scan`` on the int8 path, the dense ``hamming_scores``
     never there but once per forward serving dispatch, and ``srp_hash``
     once per forward serving dispatch and per reverse chunk;
     ``flash_attention`` exactly once per layer in prefill (on every
     rank of the model-parallel phase too), every
     launch on its ``wgmma`` route, never in decode, and no other kernel
     in an LM phase; ``ip_topk``, which
     the port calls only for the exact forward answer, is counted around
     that one call; on the retrieval path exactly one ``srp_hash`` for the
     build and one a request, one dense ``hamming_scores`` a sketch
     request, one ``ip_topk`` an exact request, and nothing else; in the
     train phase no kernel at all; in the examples phase, for each sketch
     preset of quickstart one ``srp_hash`` for the build and one a chunk
     and ``hamming_nearest`` once a tile step (chunks and tile steps
     counted at ``sa_alsh.decide_count``), for ``simpfer`` and ``exact``
     the build's ``srp_hash`` alone, in serve_retrieval one ``srp_hash``
     for the build, one ``srp_hash`` and one dense ``hamming_scores`` a
     dispatch and two ``ip_topk``, in reverse_recommend one ``ip_topk``,
     in train_lm none; in the cells phase ``flash_attention``
     once a layer in each of the 32k prefill's two steps, all ``wgmma``,
     one ``srp_hash`` and one dense ``hamming_scores`` in each step of the
     SAH retrieval cell, and no kernel in any other cell; on each rank of
     the mesh phase one ``srp_hash`` in the build (its slice of the item
     rows), one a chunk of its shard's queue, ``hamming_nearest`` (f32)
     and ``fused_scan`` (int8) the same number of times, once a tile step
     of its shard, and in the forward scan one ``srp_hash`` (the queries)
     and one dense ``hamming_scores``; its servers one ``srp_hash`` and
     one dense ``hamming_scores`` a forward dispatch, and for the reverse
     server's two dispatches of 8 ``srp_hash`` once a chunk of its shard's
     queues and ``hamming_nearest`` (f32) as often as ``fused_scan``
     (int8));
  4. holds the reverse answers against the exact oracle (recall 1.0 but
     for misses within float32 rounding of their threshold), the int8
     answers against the f32 ones bit for bit, the "exact" forward ids
     against ``ip_topk``'s but for traced float ties, the
     retrieval answers (values the ids' inner products, ``ip_topk``'s ids
     against ``torch.topk(torch.matmul(...))``'s but for traced float
     ties; recall@100 of the sketch printed, with no limit), each recsys
     ``serve_p99`` forward against the same model in float64
     (``RANKER_TOL``, TF32 off), and the flash
     prefill's logits against the plain chunked prefill's and a decode step
     against a prefill one token longer, with the same model in float32 as
     the arbiter of how far two bf16 paths may drift apart (olmoe's cache
     check at capacity factor E / k, where nothing drops; mistral-nemo's
     rule on its first 10 layers);
  5. holds each kernel against its plain PyTorch version on the inputs
     its path gives it (the dense Hamming matrix exactly;
     ``hamming_nearest`` and ``fused_scan`` exactly at the path's tile and
     at 4,096 rows; ``ip_topk`` exactly, the merged answer and the
     kernel's raw per-split lists against ``ref.ip_topk_partials``; SRP
     codes bit for bit at the query chunk and the build; at the retrieval
     shapes, ``srp_hash`` at the 1M-row build and the query, the dense
     Hamming matrix over 1M rows and ``ip_topk`` at k = 100, each exactly;
     flash attention
     within two bf16 ulps on layer 0's q/k/v, with its 8 KV heads read in
     place, and on ``FLASH_CHECKS``, and within 5e-5 in float32; also on
     olmoe's and mistral-nemo's layer-0 q/k/v);
  6. times each kernel and its plain version on the device (launches
     replayed from a CUDA graph) and each wrapper call from Python
     (``ops.ip_topk`` with its merge against one library call, the
     like-for-like pair; ``hamming_nearest`` against the dense kernel +
     ``torch.where`` + ``ref.nearest_rows`` route it replaced; SRP
     against its bound and its no-FMA floor at both shapes), and prints
     the ``-Xptxas -v`` registers and spills of ``hamming_scan``,
     ``srp_hash``, ``ip_topk`` and ``fused_scan``, and of the flash
     kernels with their shared memory and their ``HGMMA`` / ``UTMALDG``
     counts in the SASS;
  7. for each cell prints its cut, reckoned and measured bytes, step ms,
     model FLOPs, bound by its dominant term and step/bound, and holds
     its outputs (finite, the abstract outputs' shapes), the rankers'
     bulk scores against float64 and the unchunked forward, two-tower's
     exact ids against ``torch.topk(torch.matmul(...))`` but for traced
     ties, and the train cells' first loss against float32 (olmoe) or
     float64 (GAT) where that copy fits;
  8. splits a query batch into plan and execute, and profiles it (its
     first ``PROFILE_CHUNKS`` chunks), one LM prefill (qwen3 and olmoe),
     4 decode steps, and one LM train step
     for the device's busy share, their top kernels and the
     device launches per tile step (the f32 profile must hold no
     ``gatherTopK`` or ``radixSortKVInPlace`` row: the selection is in
     ``hamming_nearest``).

Any failure raises and exits nonzero. Without a CUDA device, or away from
the repository, it exits nonzero before printing any result. The last
line is the device JSON; the line before it names the card; the one
before that is the per-kernel JSON.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# An SM issues INT32 work on half as many lanes as FP32 work.
INT32_OP_PER_S = FP32_FLOP_PER_S / 2
# FP32 lane-instructions a second (a multiply or an add each; an FMA is 2
# of the FLOP above in one instruction)
FP32_INSTR_PER_S = FP32_FLOP_PER_S / 2

NQ = 16              # promoted items per query batch
TOP_FRAC = 0.02      # queries come from this top share of items by norm
PROFILE_CHUNKS = 128  # chunks of a reverse batch its profile records
ITERS = 200          # timed launches per kernel
N_FWD = 4096         # users per forward top-k batch
TILE_LARGE = 4096    # fused_scan also checked and timed at the largest tile
K_FWD = 10
POP_FRAC = 0.05      # the artifact phase's change: the top 5% by norm,
N_DEL_TOP = 8        # ... members of P' deleted,
N_DEL_POP = 56       # ... more of the top 5% deleted,
N_INS = 192          # ... and new versions of top-5% items inserted
LM_BATCH = 4         # prompts per prefill
LM_PROMPT = 2048     # tokens per prompt
LM_STEPS = 32        # greedy decode steps
# further flash checks on unit-scale inputs, (B, H, S, Dh), KV heads,
# dtype, causal: float32 at the prefill shape, a ragged S in bf16, full
# (non-causal) attention in float32, and GQA (H / Hkv = 4) with an S that
# is no multiple of the wgmma route's 128-row tiles and Dh 64, in bf16
FLASH_CHECKS = (((4, 16, 2048, 128), 16, "float32", True),
                ((4, 16, 300, 128), 16, "bfloat16", True),
                ((4, 16, 300, 128), 16, "float32", False),
                ((2, 16, 1000, 64), 4, "bfloat16", True),
                ((2, 16, 1000, 64), 4, "bfloat16", False))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def call_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean ms per call of ``fn`` called from Python ``iters`` times, by
    CUDA events after ``warmup`` calls: what a host loop pays per call,
    wrapper and launch included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so no host work sits between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def bound(nbytes, t_ops) -> tuple[float, str]:
    """The least ms the card could take: the larger of ``nbytes`` over the
    memory rate and ``t_ops`` seconds of operations, and which it is."""
    t_b = nbytes / HBM_BYTES_PER_S
    return max(t_b, t_ops) * 1e3, ("bytes" if t_b >= t_ops
                                   else "operations")


def codes_equal(name: str, got, want) -> int:
    """Fail unless two int32 code (or row) tensors are equal; returns the
    max |difference|, 0."""
    import torch
    if got.shape != want.shape or not torch.equal(got, want):
        n_diff = (int((got != want).sum()) if got.shape == want.shape
                  else "shape")
        fail(f"{name}: differs from its plain version ({n_diff})")
    return 0


def ip_tie_check(queries, items, got_ids, want_ids):
    """Positions where two top-k id lists differ must hold items whose
    float64 inner products with the query lie within float32 rounding of
    each other (8 * d * 2**-24 * sum_i |q_i x_i| each). Returns the
    number of such positions; fails on any other difference."""
    import torch
    diff = torch.nonzero(got_ids != want_ids, as_tuple=True)
    if diff[0].numel() == 0:
        return 0
    q = queries[diff[0]].double()

    def ip_and_tol(ids):
        x = items[ids[diff].long()].double()
        return ((q * x).sum(-1),
                8 * q.shape[1] * 2.0 ** -24 * (q * x).abs().sum(-1))

    (a, ta), (b, tb) = ip_and_tol(got_ids), ip_and_tol(want_ids)
    bad = int(((a - b).abs() > ta + tb).sum())
    if bad:
        fail(f"{bad} of {diff[0].numel()} differing top-k ids are not "
             f"float ties")
    return diff[0].numel()


def traced_misses(what: str, items, users_unit, queries, pred, truth,
                  k: int, tie_eps: float) -> int:
    """Fail unless every user the exact oracle puts in an audience and
    ``pred`` leaves out lies within float32 rounding of its threshold
    (``exact.float_tie``, at most 1,000 of them); returns the misses."""
    import torch
    from repro_torch.core import exact
    missed = torch.nonzero(truth & ~pred).tolist()
    ties = sum(exact.float_tie(items, users_unit[u], queries[q], k, tie_eps)
               for q, u in missed[:1000])
    if len(missed) > 1000 or ties != len(missed):
        fail(f"{what}: {len(missed) - ties} missed users are not float "
             f"ties")
    return len(missed)


def profile_query(eng, queries, k: int) -> None:
    """Where one ``query_batch`` spends its time: the plan and execute
    phases on the host clock, and the device's busy share, top kernels and
    launches per tile step from ``torch.profiler`` over a second run of the
    same batch, recorded over its first PROFILE_CHUNKS chunks (the
    profiler's processing of a whole batch's ~110,000 launches at k = 10
    took ~25 s a profile)."""
    import torch
    from repro_torch.core import sah
    cfg = eng.config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = sah.rkmips_plan(eng.index, queries, k, tie_eps=cfg.tie_eps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sah.rkmips_execute(eng.index, plan, k, n_cand=cfg.n_cand, scan=cfg.scan,
                       chunk=cfg.chunk, scan_precision=cfg.scan_precision)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"breakdown {cfg.scan_precision} k={k}: plan {(t1 - t0) * 1e3:.1f} "
          f"ms, execute {(t2 - t1) * 1e3:.1f} ms ({plan.n_work} lanes)")
    window = {"chunks": 0, "tile_steps": 0}

    def until(stop):            # ends the recording after PROFILE_CHUNKS
        def each(counts):
            if counts["chunks"] <= PROFILE_CHUNKS:
                window.update(counts)
            if counts["chunks"] == PROFILE_CHUNKS:
                stop()
        return chunk_counter(each)[1]

    rows = device_profile(
        f"{cfg.scan_precision} k={k}, the first {PROFILE_CHUNKS} chunks of "
        f"the batch", lambda: eng.query_batch(queries, k), until)
    if rows:
        launches = sum(r[1] for r in rows)
        topk = [r for r in rows if "gatherTopK" in r[2]
                or "radixSortKVInPlace" in r[2]]
        print(f"  {launches} device launches, "
              f"{launches / max(window['tile_steps'], 1):.2f} per tile step "
              f"({window['tile_steps']} tile steps in {window['chunks']} "
              f"chunks); gatherTopK / radixSortKVInPlace rows: {len(topk)}")
        if topk and cfg.scan_precision == "f32":
            fail("the f32 tile scan still runs a torch.topk selection")


def kernel_launches(fn) -> int | None:
    """Device kernel launches of one call of ``fn`` (after a warm-up call),
    counted by ``torch.profiler``; None where it records none."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def device_profile(label: str, fn, until=None) -> list:
    """Run ``fn`` once under ``torch.profiler`` and print the device's busy
    share of the wall time (to a device sync) and the top kernels. Returns
    the kernel rows (device us, launches, name); empty when the profiler
    recorded no device time. ``until``, where given, is called before the
    run with a function that ends the recording at a device sync (a window
    of the run: the wall time is then the window's) and returns a function
    to call after the run."""
    import torch
    # device activity only: the busy share reads kernel rows, and recording
    # every host operator as well made each profile take minutes
    acts = [torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    span = []

    def stop():
        if not span:
            torch.cuda.synchronize()
            span.append(time.perf_counter() - t0)
            prof.stop()

    after = until(stop) if until else None
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    try:
        fn()
        stop()
    finally:
        if after:
            after()
    wall_us = span[0] * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue           # operator rows repeat their kernels' time
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profile: the profiler recorded no device time: not measured")
        return []
    print(f"profile {label} (profiler on): wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms = {busy / wall_us:.1%}, idle "
          f"{1 - busy / wall_us:.1%}")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {dev_us / 1e3:9.2f} ms  {count:7d} x  {key[:90]}")
    return rows


def greedy_ties(want, got, tol):
    """Rows where two logit matrices pick different argmax tokens must be
    rows where ``want``'s two largest logits lie within ``tol`` of each
    other. Returns the number of such rows; fails on any other
    difference."""
    import torch
    diff = want.argmax(-1) != got.argmax(-1)
    top2 = torch.topk(want, 2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) <= tol
    if bool((diff & ~near).any()):
        fail(f"{int((diff & ~near).sum())} greedy tokens differ without a "
             f"near-tie")
    return int(diff.sum())


def flash_close(got, want, tol) -> float:
    """Max |got - want|; fails unless every element is within ``tol(want)``."""
    err = (got.float() - want.float()).abs()
    bad = int((err > tol(want.float().abs())).sum())
    if bad:
        fail(f"flash_attention: {bad} of {err.numel()} values outside the "
             f"tolerance (max abs err {float(err.max())})")
    return float(err.max())


RETR_REQUESTS = 64   # single-user requests per retrieval serve mode
RETR_K = 100         # items returned per retrieval request
RETR_N_CAND = 512    # sketch candidates re-ranked per request
EMBED_CHUNK = 1 << 16    # candidate items per item_tower call
# the recsys forwards in float32 against the same model in float64: a
# logit sums at most ~8k float32 products of unit scale (the CIN's
# H_k * F = 7,800 a layer), with TF32 off
RANKER_TOL = dict(rtol=1e-4, atol=1e-4)


def uniform_feats(gen, vocab_sizes, rows: int, dev):
    """(rows, fields) int32 feature ids, each field uniform over its
    vocabulary (as the reference's examples draw them)."""
    import torch
    return torch.stack([torch.randint(0, v, (rows,), generator=gen,
                                      device=dev, dtype=torch.int32)
                        for v in vocab_sizes], -1)


def ranker_batch(arch: str, cfg, rows: int, gen, dev) -> dict:
    """A serving batch of ``rows`` for a DeepFM/xDeepFM or DIN config:
    ids uniform per field; DIN histories of uniform length 1..T."""
    import torch
    if arch != "din":
        return {"sparse": uniform_feats(gen, cfg.embedding.vocab_sizes, rows,
                                        dev)}
    vocab, t = cfg.embedding.vocab_sizes, cfg.seq_len
    lengths = torch.randint(1, t + 1, (rows, 1), generator=gen, device=dev)
    return {"hist": uniform_feats(gen, (vocab[0],) * t, rows, dev),
            "hist_mask": torch.arange(t, device=dev)[None, :] < lengths,
            "target": uniform_feats(gen, vocab[:1], rows, dev)[:, 0],
            "profile": uniform_feats(gen, vocab[1:], rows, dev)}


def held_in_float64(name: str, model, fwd, out) -> float:
    """Recompute ``fwd()`` with ``model`` cast to float64 in place; fail
    unless ``out`` (the float32 result) lies within ``RANKER_TOL`` of it.
    Returns the max |difference|."""
    model.double()
    want = fwd()
    err = (out.double() - want).abs()
    if not bool((err <= RANKER_TOL["atol"]
                 + RANKER_TOL["rtol"] * want.abs()).all()):
        fail(f"{name}: float32 forward is {float(err.max()):.3g} from "
             f"float64 (tolerance {RANKER_TOL})")
    return float(err.max())


def recsys_path(seed: int, dev, mp_dir: str | None = None) -> dict:
    """The recsys serving phase at full width: two-tower retrieval over
    1,000,000 candidates (``launch/serve.py``: the candidate index, 64
    single-user requests by the SAH sketch and 64 by the exact
    ``ip_topk``, counted), its ``serve_p99`` batch, the retrieval-shape
    kernels against their plain versions, then DeepFM, xDeepFM and DIN at
    ``serve_p99``, each held against float64 and freed before the next.
    Fails on any miss; returns the peak device memory before the phase and
    the kernels' retrieval-shape numbers."""
    import torch
    from repro_torch.configs import base
    from repro_torch.core import sa_alsh
    from repro_torch.engine.config import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import recsys as rec

    t_start = t_mark = time.perf_counter()
    parts = {}

    def mark(name):                 # host seconds of each part of the phase
        nonlocal t_mark
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = round(now - t_mark, 2)
        t_mark = now

    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    spec = base.get("two-tower-retrieval")
    cfg = spec.make_config()
    n = spec.shape("retrieval_cand").dims["n_candidates"]
    rows_p99 = spec.shape("serve_p99").dims["batch"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = rec.init_twotower_params(gen, cfg, device=dev)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("a recsys model on the card left TF32 on")
    print(f"recsys: {cfg.name} user table {tuple(model.user_table.shape)}, "
          f"item table {tuple(model.item_table.shape)}, towers "
          f"{cfg.tower_dims} -> {cfg.out_dim}, "
          f"{sum(p.numel() for p in model.parameters()):,} parameters from "
          f"seed {seed}")
    mark("two-tower init")

    # -- the candidates: 1M items through the item tower, then the index ---
    items = uniform_feats(gen, cfg.item_embedding.vocab_sizes, n, dev)
    cand = torch.cat([rec.item_tower(model, items[i:i + EMBED_CHUNK], cfg)
                      for i in range(0, n, EMBED_CHUNK)])
    items_head = items[:EMBED_CHUNK].clone()
    del items
    mark("embed candidates")
    d = cand.shape[1]
    kproj = torch.randn(d + 1, serve.N_BITS,
                        generator=torch.Generator().manual_seed(seed))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    codes, proj = serve.build_candidate_index(
        cand, torch.Generator().manual_seed(seed), kmips_proj=kproj,
        device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_launches = dict(ops.launch_counts)
    if codes.shape != (n, serve.N_BITS // 32) or codes.dtype != torch.int32 \
            or not torch.equal(proj.cpu(), kproj[:-1]):
        fail(f"build_candidate_index: codes {tuple(codes.shape)} "
             f"{codes.dtype}, proj {tuple(proj.shape)}")
    mark("candidate index")

    # -- 64 requests by the sketch, 64 by the exact kernel, counted --------
    users = uniform_feats(gen, cfg.user_embedding.vocab_sizes, RETR_REQUESTS,
                          dev)
    ms = {"sketch": [], "exact": []}
    got = {"sketch": [], "exact": []}
    us = []
    for i in range(RETR_REQUESTS):
        t0 = time.perf_counter()
        ans = serve.sah_retrieve_step(model, users[i:i + 1], cand, codes,
                                      proj, cfg, n_cand=RETR_N_CAND,
                                      k=RETR_K)
        torch.cuda.synchronize()
        ms["sketch"].append((time.perf_counter() - t0) * 1e3)
        got["sketch"].append(ans)
    for i in range(RETR_REQUESTS):
        t0 = time.perf_counter()
        u = rec.user_tower(model, users[i:i + 1], cfg)
        ans = ops.ip_topk(u, cand, RETR_K)
        torch.cuda.synchronize()
        ms["exact"].append((time.perf_counter() - t0) * 1e3)
        got["exact"].append((ans[0][0], ans[1][0]))
        us.append(u[0])
    launches = dict(ops.launch_counts)
    want = {"srp_hash": build_launches["srp_hash"] + RETR_REQUESTS,
            "hamming_scores": RETR_REQUESTS, "ip_topk": RETR_REQUESTS}
    if build_launches["srp_hash"] != 1 or any(
            launches[name] != want.get(name, 0) for name in launches):
        fail(f"retrieval launch counts {launches}, want {want} (the build's "
             f"{build_launches})")
    print(f"launch_counts (retrieval: the index build, then "
          f"{RETR_REQUESTS} sketch and {RETR_REQUESTS} exact requests): "
          f"{launches}; the build's srp_hash {build_launches['srp_hash']}")
    uu = torch.stack(us)
    vals = {m: torch.stack([a[0] for a in got[m]]) for m in got}
    ids = {m: torch.stack([a[1] for a in got[m]]) for m in got}
    for m in got:
        if vals[m].shape != (RETR_REQUESTS, RETR_K) \
                or not bool(torch.isfinite(vals[m]).all()) \
                or bool(((ids[m] < 0) | (ids[m] >= n)).any()) \
                or bool((vals[m][:, :-1] < vals[m][:, 1:]).any()):
            fail(f"retrieval {m}: bad answer {tuple(vals[m].shape)}")
        recomputed = (uu[:, None, :] * cand[ids[m].long()]).sum(-1)
        if not torch.allclose(vals[m], recomputed, rtol=1e-5, atol=1e-6):
            fail(f"retrieval {m}: values are not the ids' inner products")
    hit = (ids["sketch"][:, :, None] == ids["exact"][:, None, :]).any(-1)
    recall = hit.float().mean(dim=1)
    lib_ids = torch.topk(torch.matmul(uu, cand.T), RETR_K).indices
    ties = ip_tie_check(uu, cand, ids["exact"], lib_ids.to(torch.int32))

    # how narrow a cone the random towers' vectors fill: each vector's
    # cosine to the candidates' mean direction (what the sketch's angles
    # have to tell apart)
    axis = torch.nn.functional.normalize(cand.mean(0), dim=0)
    cos_c = torch.nn.functional.normalize(cand, dim=1) @ axis
    cos_u = torch.nn.functional.normalize(uu, dim=1) @ axis

    def ms_line(m):
        t = sorted(ms[m])
        return (f"{sum(t) / len(t):.3f} ms/request mean, p50 "
                f"{t[len(t) // 2]:.3f}, max {t[-1]:.3f}")

    print(f"retrieval ({n:,} candidates, d {d}, {serve.N_BITS} bits, k "
          f"{RETR_K}, n_cand {RETR_N_CAND}, {RETR_REQUESTS} single-user "
          f"requests a mode): index build {t_build:.3f} s; sketch "
          f"(sah_retrieve_step) {ms_line('sketch')}; exact (user_tower + "
          f"ops.ip_topk) {ms_line('exact')}; recall@{RETR_K} of the sketch "
          f"against ip_topk mean {float(recall.mean()):.6f}, min "
          f"{float(recall.min()):.2f} (cosine to the candidates' mean "
          f"direction: candidates mean {float(cos_c.mean()):.4f}, min "
          f"{float(cos_c.min()):.4f}; users mean {float(cos_u.mean()):.4f})"
          f"; ip_topk's ids equal torch.topk("
          f"torch.matmul(u, cand.T))'s but for {ties} positions, all float "
          f"ties")
    mark("retrieval requests")

    # -- the retrieval-shape kernels against their plain versions ----------
    kw = get_config("sah").replace(n_bits=serve.N_BITS).kmips_build_kwargs(n)
    del kw["n_bits"]
    prep = sa_alsh.prepare_items(cand, **kw)
    live = prep.item_mask
    index_codes = torch.zeros(live.shape[0], codes.shape[1],
                              dtype=codes.dtype, device=codes.device)
    index_codes[live] = codes[prep.item_ids[live].long()]
    srp_b = srp_at("retrieval", prep.transformed.contiguous(),
                   kproj.to(dev), index_codes, build_launches["srp_hash"],
                   live)
    u1 = uu[:1].contiguous()
    qcode = ops.srp_hash(u1, proj)
    srpq_err = codes_equal("srp_hash at the retrieval query shape", qcode,
                           ref.srp_hash(u1, proj))
    srpq = {"ms": device_ms(lambda: ops.srp_hash(u1, proj), ITERS),
            "plain_ms": device_ms(lambda: ref.srp_hash(u1, proj), 20),
            "call_ms": call_ms(lambda: ops.srp_hash(u1, proj), ITERS)}
    b = proj.shape[1]
    srpq["bound_ms"], srpq["bound_by"] = bound(
        4 * (d + d * b + b // 32), 2 * d * b / FP32_FLOP_PER_S)
    print(f"check srp_hash at the retrieval query shape {(1, d)}x{(d, b)}: "
          f"bit for bit; time " + ", ".join(
              f"{key} {val:.6f}" if isinstance(val, float) else
              f"{key} {val}" for key, val in srpq.items()))
    dense = dense_at("retrieval", qcode, codes, launches["hamming_scores"])
    ipk = topk_at("retrieval", u1, cand, RETR_K, launches["ip_topk"])
    del prep, index_codes
    mark("retrieval-shape checks and times")

    if mp_dir is not None:
        save_retrieval_answers(mp_dir, cand, codes, proj, users, uu,
                               ids["sketch"], items_head)
        mark("model-parallel answers")

    # -- serve_p99: the towers' row dot at batch 512, then float64 ---------
    uf = uniform_feats(gen, cfg.user_embedding.vocab_sizes, rows_p99, dev)
    itf = uniform_feats(gen, cfg.item_embedding.vocab_sizes, rows_p99, dev)

    def two_tower():
        return (rec.user_tower(model, uf, cfg)
                * rec.item_tower(model, itf, cfg)).sum(-1)

    out = two_tower()
    p99 = {spec.arch_id: {"ms": call_ms(two_tower, 20)}}
    del cand, codes, uu
    p99[spec.arch_id]["f64_err"] = held_in_float64(spec.arch_id, model,
                                                   two_tower, out)
    del model, out
    torch.cuda.empty_cache()
    mark("two-tower serve_p99")

    # -- the rankers at serve_p99, one at a time ----------------------------
    for arch in ("deepfm", "xdeepfm", "din"):
        rspec = base.get(arch)
        rcfg = rspec.make_config()
        rows_b = rspec.shape("serve_p99").dims["batch"]
        rgen = torch.Generator(device=dev).manual_seed(seed)
        if arch == "din":
            model = rec.init_din_params(rgen, rcfg, device=dev)
            forward = rec.din_forward
        else:
            model = rec.init_ctr_params(rgen, rcfg, device=dev)
            forward = rec.ctr_forward
        batch = ranker_batch(arch, rcfg, rows_b, rgen, dev)

        def fwd():
            return forward(model, batch, rcfg)

        out = fwd()
        if out.shape != (rows_b,) or not bool(torch.isfinite(out).all()):
            fail(f"{arch}: bad logits {tuple(out.shape)}")
        p99[arch] = {"ms": call_ms(fwd, 20)}
        p99[arch]["f64_err"] = held_in_float64(arch, model, fwd, out)
        del model, batch, out
        torch.cuda.empty_cache()
        mark(f"{arch} serve_p99")
    print(f"serve_p99 (batch {rows_p99}): ms per forward called from Python "
          f"(CUDA events) and max |float32 - float64| (tolerance "
          f"{RANKER_TOL}): " + "; ".join(
              f"{a} {v['ms']:.4f} ms, err {v['f64_err']:.3g}"
              for a, v in p99.items()))

    peak = torch.cuda.max_memory_allocated()
    print(f"recsys phase: {time.perf_counter() - t_start:.1f} s host "
          f"({parts}), peak device memory {peak / 2**30:.2f} GiB")

    srp_q = {f"retrieval_query_{key}": val for key, val in srpq.items()}
    srp_q.update({"retrieval_query_launches":
                  launches["srp_hash"] - build_launches["srp_hash"],
                  "retrieval_query_shape": f"{(1, d)}x{(d, b)}",
                  "retrieval_query_max_abs_err": srpq_err})
    return {"peak_before": peak_before, "peak": peak,
            "srp": {**srp_b, **srp_q}, "dense": dense, "ip_topk": ipk}


# -- the train phase -----------------------------------------------------------
TRAIN_SEQ = 4096     # tokens a sequence: the train_4k shape
TRAIN_MICRO = 1      # sequences a micro-batch
TRAIN_ACCUM = 4      # micro-batches a step (global batch 256 cut to 4)
TRAIN_STEPS = 3      # steps of a run, on one repeated batch
TRAIN_CKPT_AT = 2    # the crashed run checkpoints at step 2, then fails there
RECSYS_TRAIN_STEPS = 3
GAT_TRAIN_STEPS = 5
CORA_EDGES = 10556   # Cora's directed edges (padded to the shape's 16,384)
CORA_TRAIN_NODES = 140
# qwen3-0.6b in bf16 against the same weights in float32 on one micro-batch
# of 4,096 tokens: bf16 rounds every activation to 8 significant bits
# (2^-8 = 0.4% spacing) through 28 residual layers; rounding errors mostly
# average out in the mean loss but less in the gradient's norm
LM_LOSS_RTOL = 1e-2
LM_GNORM_RTOL = 5e-2
LM_LOSS_DROP = 0.5       # nats the LM loss must fall over TRAIN_STEPS
# Adam's first steps move every weight by about the rate, whatever its
# gradient: at qwen3-0.6b's init on one repeated batch, the launcher's
# 1e-3 overshoots by the third step (12.23 -> 5.72 -> 24.60 nats on an
# H100) and so does 1e-4 (12.23 -> 5.31 -> 11.76); the full-size LM
# trains at 1e-5
LM_LR = 1e-5
# float32 training losses against float64 (TF32 off): RANKER_TOL's reason
TRAIN_F64_RTOL = 1e-4
TRAIN_DROP_REL = 1e-3    # recsys/GAT: the last loss below the first by this
#                          share (not at every step: Adam at 1e-3 can step
#                          over, as xDeepFM's 0.6017 -> 0.6074 did)


def recorded(step, record: list):
    """``step`` wrapped to append (loss, grad norm, host s) of each call,
    the host clock taken from a device sync to the loss read."""
    import torch

    def run(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        record.append((loss, float(metrics["grad_norm"]),
                       time.perf_counter() - t0))
        return state, metrics
    return run


def loss_falls(name: str, record: list, drop: float | None = None) -> list:
    """Fail unless the recorded losses are finite and the last lies below
    the first: by ``drop`` nats, or (``drop`` None) by TRAIN_DROP_REL of
    the first."""
    losses = [r[0] for r in record]
    if drop is None:
        drop = losses[0] * TRAIN_DROP_REL
    ok = all(x == x and abs(x) != float("inf") for x in losses) and \
        losses[-1] <= losses[0] - drop
    what = f"by {drop:.4g}"
    if not ok:
        fail(f"{name}: the loss did not fall {what} over {len(losses)} "
             f"steps on one batch: {losses} (host s a step: "
             f"{[round(r[2], 3) for r in record]})")
    return losses


def step_ms(record: list) -> float:
    """Median host ms of the recorded steps after the first (warm-up)."""
    import statistics
    return statistics.median(r[2] for r in record[1:]) * 1e3


def within(name: str, got: float, want: float, rtol: float) -> float:
    rel = abs(got - want) / abs(want)
    if not rel <= rtol:
        fail(f"{name}: {got!r} is {rel:.3g} from {want!r} (rtol {rtol})")
    return rel


def lm_train(seed: int, dev, mp_dir: str | None = None) -> dict:
    """qwen3-0.6b at full width and depth, trained on one repeated batch
    of TRAIN_ACCUM x TRAIN_MICRO sequences of TRAIN_SEQ tokens by the
    port's ``make_train_step`` + ``train_loop`` (chain(clip 1.0, adamw
    LM_LR), the launcher's but for the rate). Checks (each fatal): the
    first micro-batch's loss and gradient norm against float32, the loss
    falling, a run crashed by ``fail_at_step`` and resumed from its
    checkpoint equal bit for bit to the uninterrupted run, and flash
    attention refusing grad. With ``mp_dir`` it first saves what the
    model-parallel phase holds its training against (``mp_train_answers``).
    Times the steps, one step's parts, and profiles one step."""
    import copy
    import dataclasses
    import itertools
    import shutil
    import torch
    from repro_torch.configs import base
    from repro_torch.data import synthetic
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import (init_state, make_train_step,
                                           train_loop)

    cfg = base.get("qwen3-0.6b").make_config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, gen, dev)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    n_seq = TRAIN_ACCUM * TRAIN_MICRO
    batch = next(synthetic.lm_token_batches(gen, n_seq, TRAIN_SEQ,
                                            cfg.vocab))
    opt = opt_lib.chain(opt_lib.clip_by_global_norm(1.0),
                        opt_lib.adamw(LM_LR))
    step = make_train_step(lambda p, b: tf.lm_loss(model, b), opt,
                           grad_accum=TRAIN_ACCUM)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"train lm: {cfg.name} L={cfg.n_layers} d={cfg.d_model} vocab "
          f"{cfg.vocab} {cfg.dtype} remat={cfg.remat} attn={cfg.attn_impl}, "
          f"{n_params:,} parameters from seed {seed}; a step: "
          f"{TRAIN_ACCUM} micro-batches x {TRAIN_MICRO} x {TRAIN_SEQ} "
          f"tokens (Zipf-ish synthetic), chain(clip 1.0, adamw {LM_LR}); "
          f"{time.perf_counter() - t0:.1f} s to set up")

    # -- the first micro-batch against the same weights in float32 ---------
    micro = {k: v[:TRAIN_MICRO] for k, v in batch.items()}
    held = mp_held(model, MP_TRAIN_LAYERS) if mp_dir else ()

    def loss_and_norm(m, b=micro):
        loss = tf.lm_loss(m, b)
        names = [n for n, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss, list(m.parameters()))
        kept = {n: g.cpu() for n, g in zip(names, grads) if n in held}
        return (float(loss.detach()),
                float(opt_lib.global_norm(dict(enumerate(grads)))), kept)

    loss16, norm16, kept16 = loss_and_norm(model)
    if mp_dir:          # a second correct bf16 path: half the attention
        #                 chunk, so the online softmax sums in another order
        model.cfg = dataclasses.replace(cfg, attn_chunk=cfg.attn_chunk // 2)
        kept16b = loss_and_norm(model)[2]
        model.cfg = cfg
    model32 = copy.deepcopy(model).float()
    model32.cfg = dataclasses.replace(cfg, dtype=torch.float32)
    loss32, norm32, kept32 = loss_and_norm(model32)
    answers = {}
    if mp_dir:
        spread = grad_spread(kept16, kept16b, kept32)
        del kept16b
        print(f"train lm: two single-device bf16 gradient paths (attention "
              f"chunk {cfg.attn_chunk} and {cfg.attn_chunk // 2}) on "
              f"{len(kept32)} leaves, against float32: distance ratios "
              f"either way round up to max {spread['max'][0]:.3f}x "
              f"({spread['max'][1]}), mean {spread['mean'][0]:.3f}x "
              f"({spread['mean'][1]}), rms {spread['rms'][0]:.3f}x "
              f"({spread['rms'][1]}); the two paths up to "
              f"{spread['gap'][0]:.3f}x one path's max distance apart "
              f"({spread['gap'][1]})")
        answers[1] = dict(loss16=loss16, norm16=norm16, loss32=loss32,
                          norm32=norm32, grads16=kept16, grads32=kept32)
        for n in sorted({dp for dp, _ in MP_WORLDS} - {1}):
            b = {k: v[:n] for k, v in batch.items()}
            rec = dict(zip(("loss16", "norm16", "grads16"),
                           loss_and_norm(model, b)))
            rec.update(zip(("loss32", "norm32", "grads32"),
                           loss_and_norm(model32, b)))
            answers[n] = rec
    del model32, kept16, kept32
    torch.cuda.empty_cache()
    rel_loss = within("lm loss bf16 vs float32", loss16, loss32,
                      LM_LOSS_RTOL)
    rel_norm = within("lm grad norm bf16 vs float32", norm16, norm32,
                      LM_GNORM_RTOL)
    print(f"train lm: first micro-batch loss {loss16!r} (float32 "
          f"{loss32!r}, rel {rel_loss:.3g} <= {LM_LOSS_RTOL}), grad norm "
          f"{norm16!r} (float32 {norm32!r}, rel {rel_norm:.3g} <= "
          f"{LM_GNORM_RTOL})")

    quiet = dict(log_every=10 ** 9, log_fn=print)

    def from_start():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(start[k])
        return init_state(params, opt)

    if mp_dir:
        mp_train_answers(mp_dir, model, batch, answers, from_start, held)
        from_start()
    run_a = []
    state = train_loop(init_state(params, opt), recorded(step, run_a),
                       itertools.repeat(batch), n_steps=TRAIN_STEPS, **quiet)
    losses = loss_falls("lm", run_a, LM_LOSS_DROP)
    final = {k: p.detach().clone() for k, p in params.items()}
    del state

    # -- crashed at TRAIN_CKPT_AT, restored from its checkpoint, resumed ---
    ck_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    run_b, run_c = [], []
    t0 = time.perf_counter()
    try:
        train_loop(from_start(), recorded(step, run_b),
                   itertools.repeat(batch), n_steps=TRAIN_STEPS,
                   ckpt_dir=str(ck_dir), ckpt_every=TRAIN_CKPT_AT,
                   fail_at_step=TRAIN_CKPT_AT, **quiet)
        fail("train lm: the simulated failure did not happen")
    except RuntimeError as e:
        if "simulated worker failure" not in str(e):
            raise
    save_s = time.perf_counter() - t0 - sum(r[2] for r in run_b)
    last = ckpt.latest_step(str(ck_dir))
    if last != TRAIN_CKPT_AT:
        fail(f"train lm: latest checkpoint {last}, not {TRAIN_CKPT_AT}")
    ck_bytes = sum(f.stat().st_size for f in ck_dir.rglob("*") if f.is_file())
    state = from_start()          # the weights and moments the crash left
    #                               go: back to the start, then restore
    t0 = time.perf_counter()
    tree, _ = ckpt.restore(str(ck_dir), last,
                           convert.train_state_to_numpy(state))
    state = convert.train_state_from_jax(tree, state)
    del tree
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ck_dir, ignore_errors=True)
    state = train_loop(state, recorded(step, run_c), itertools.repeat(batch),
                       n_steps=TRAIN_STEPS, **quiet)
    differ = [k for k, p in params.items() if not torch.equal(p, final[k])]
    if differ or int(state.step) != TRAIN_STEPS:
        fail(f"train lm: the resumed run differs from the uninterrupted one "
             f"in {len(differ)} of {len(params)} parameters ({differ[:3]})")
    if [r[0] for r in run_c] != losses[last:]:
        fail(f"train lm: resumed losses {[r[0] for r in run_c]} != "
             f"{losses[last:]}")
    print(f"train lm: losses {losses} over {TRAIN_STEPS} steps on one batch "
          f"(must fall by {LM_LOSS_DROP}); crashed at step {last} and "
          f"resumed from its checkpoint ({ck_bytes / 2**30:.2f} GiB, saved "
          f"in {save_s:.1f} s, restored in {restore_s:.1f} s): all "
          f"{len(params)} parameters bit for bit equal to the uninterrupted "
          f"run (deterministic algorithms on)")
    del final

    # -- attn_impl="flash" under grad raises on the card -------------------
    model.cfg = dataclasses.replace(cfg, attn_impl="flash")
    try:
        tf.lm_loss(model, {k: v[:1, :256] for k, v in batch.items()})
        fail("train lm: attn_impl='flash' under grad did not raise")
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    finally:
        model.cfg = cfg
    print("train lm: attn_impl='flash' under grad raises: the CUDA kernel "
          "has no backward")

    # -- one step's parts, host clock to a device sync ---------------------
    def sync_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    loss, fwd_s = sync_s(lambda: tf.lm_loss(model, micro))
    grads, bwd_s = sync_s(lambda: torch.autograd.grad(
        loss, list(params.values())))
    del loss
    with torch.no_grad():
        _, nograd_s = sync_s(lambda: tf.lm_loss(model, micro))

    def optimizer_step():
        updates, st = opt.update(dict(zip(params, grads)), state.opt_state,
                                 params)
        opt_lib.apply_updates(params, updates)
    _, opt_s = sync_s(optimizer_step)
    del grads
    wall = []

    def profiled_step():           # its wall, as device_profile takes it
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)

    rows = device_profile("lm train step", profiled_step)
    profiled_s = wall[0]
    busy = sum(r[0] for r in rows) / 1e6 if rows else None

    tokens = n_seq * TRAIN_SEQ
    t_step = step_ms(run_a + run_b + run_c) / 1e3
    # model FLOPs a token: 6 x the matmul weights (embedding lookup: none)
    # + causal attention's QK^T and PV at a mean context of (S + 1) / 2,
    # forward and backward
    mm = sum(p.numel() for k, p in params.items()
             if p.dim() == 2 and k != "embed")
    attn = 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * (TRAIN_SEQ + 1) / 2
    flops_tok = 3 * (2 * mm + attn)
    # the remat recompute runs every layer's forward once more (not the
    # head's)
    remat_tok = flops_tok + 2 * (mm - cfg.d_model * cfg.vocab) + attn
    mfu = flops_tok * tokens / t_step / BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated()
    print(f"train lm: step {t_step * 1e3:.1f} ms (median of "
          f"{len(run_a) + len(run_b) + len(run_c) - 1} steps after the "
          f"first), {tokens / t_step:,.0f} tokens/s, "
          f"{flops_tok / 1e9:.2f} GFLOP a token (model FLOPs, no remat; "
          f"{remat_tok / 1e9:.2f} with the recompute) -> MFU {mfu:.2%} of "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"train lm: one micro-batch: forward {fwd_s * 1e3:.1f} ms, "
          f"backward with its layer recompute {bwd_s * 1e3:.1f} ms (the "
          f"forward without grad, about the recompute: "
          f"{nograd_s * 1e3:.1f} ms); optimizer on {n_params:,} parameters "
          f"{opt_s * 1e3:.1f} ms; so a step ~ {TRAIN_ACCUM} x "
          f"{(fwd_s + bwd_s) * 1e3:.0f} + {opt_s * 1e3:.0f} ms")
    del state, model, params, start, opt, step
    torch.cuda.empty_cache()
    return {"step_ms": t_step * 1e3, "tokens_per_s": tokens / t_step,
            "mfu": mfu, "gflop_per_token": flops_tok / 1e9,
            "losses": losses, "loss_f32": loss32, "loss_bf16": loss16,
            "fwd_ms": fwd_s * 1e3, "bwd_ms": bwd_s * 1e3,
            "nograd_fwd_ms": nograd_s * 1e3, "opt_ms": opt_s * 1e3,
            "busy_s": busy, "profiled_s": profiled_s, "peak": peak,
            "ckpt_gib": ck_bytes / 2**30,
            "save_s": save_s, "restore_s": restore_s}


def recsys_train_batch(arch: str, cfg, rows: int, gen, dev) -> dict:
    """A training batch of ``rows``: the serving batch of ``ranker_batch``
    with Bernoulli labels (0.3 CTR, 0.5 DIN, as the reference's launcher
    draws them), or the two-tower user/item features with log_q 0."""
    import torch
    if arch == "two-tower-retrieval":
        return {"user_feats": uniform_feats(
                    gen, cfg.user_embedding.vocab_sizes, rows, dev),
                "item_feats": uniform_feats(
                    gen, cfg.item_embedding.vocab_sizes, rows, dev),
                "log_q": torch.zeros(rows, device=dev)}
    batch = ranker_batch(arch, cfg, rows, gen, dev)
    p = 0.5 if arch == "din" else 0.3
    batch["label"] = (torch.rand(rows, generator=gen, device=dev) < p).to(
        torch.float32)
    return batch


def twotower_loss_f64(model, batch: dict, cfg, rows_a_chunk=4096) -> float:
    """The in-batch sampled-softmax loss recomputed in float64 by row
    chunks of the (B, B) logits (a float64 (B, B) at the train batch would
    not fit beside the model)."""
    import torch
    from repro_torch.models import recsys as rec
    u = rec.user_tower(model, batch["user_feats"], cfg)
    v = rec.item_tower(model, batch["item_feats"], cfg)
    log_q = batch["log_q"].double()
    total = 0.0
    for i in range(0, u.shape[0], rows_a_chunk):
        logits = u[i:i + rows_a_chunk] @ v.T - log_q[None, :]
        idx = torch.arange(i, i + logits.shape[0], device=u.device)
        total += float((torch.logsumexp(logits, -1)
                        - logits[idx - i, idx]).sum())
    return total / u.shape[0]


def bce_f64(logits, labels) -> float:
    """The models' binary cross-entropy, all in float64 (their own
    ``bce_loss`` casts the logits to float32 first)."""
    import torch
    z, y = logits.double(), labels.double()
    return float(torch.mean(torch.clamp(z, min=0) - z * y
                            + torch.log1p(torch.exp(-z.abs()))))


def recsys_train(seed: int, dev) -> dict:
    """Each recsys arch at full width, trained at its ``train_batch``
    (halved while it does not fit, each cut printed) for
    RECSYS_TRAIN_STEPS steps on one repeated batch: the first loss held
    against the same model in float64, the loss falling. Each model is
    freed before the next."""
    import copy
    import itertools
    import torch
    from repro_torch.configs import base
    from repro_torch.models import recsys as rec
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import (init_state, make_train_step,
                                           train_loop)
    forward_of = {"deepfm": rec.ctr_forward, "xdeepfm": rec.ctr_forward,
                  "din": rec.din_forward}
    losses_of = {"deepfm": rec.ctr_loss, "xdeepfm": rec.ctr_loss,
                 "din": rec.din_loss, "two-tower-retrieval": rec.twotower_loss}
    init_of = {"deepfm": rec.init_ctr_params, "xdeepfm": rec.init_ctr_params,
               "din": rec.init_din_params,
               "two-tower-retrieval": rec.init_twotower_params}

    def attempt(arch, cfg, rows):
        """Train ``arch`` at batch ``rows``: (record, float64 first loss,
        parameter count). Everything it made is freed when it returns or
        raises."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = init_of[arch](gen, cfg, device=dev)
        batch = recsys_train_batch(arch, cfg, rows, gen, dev)
        with torch.no_grad():
            m64 = copy.deepcopy(model).double()
            loss64 = (twotower_loss_f64(m64, batch, cfg)
                      if arch == "two-tower-retrieval"
                      else bce_f64(forward_of[arch](m64, batch, cfg),
                                   batch["label"]))
            del m64
        params = dict(model.named_parameters())
        opt = opt_lib.chain(opt_lib.clip_by_global_norm(1.0),
                            opt_lib.adamw(1e-3))
        step = make_train_step(lambda p, b: losses_of[arch](model, b, cfg),
                               opt)
        record = []
        train_loop(init_state(params, opt), recorded(step, record),
                   itertools.repeat(batch), n_steps=RECSYS_TRAIN_STEPS,
                   log_every=10 ** 9, log_fn=print)
        return record, loss64, sum(p.numel() for p in params.values())

    out = {}
    for arch in ("two-tower-retrieval", "deepfm", "xdeepfm", "din"):
        spec = base.get(arch)
        cfg = spec.make_config()
        rows = spec.shape("train_batch").dims["batch"]
        cuts = []
        while True:
            torch.cuda.reset_peak_memory_stats()
            try:
                record, loss64, n_params = attempt(arch, cfg, rows)
                break
            except torch.cuda.OutOfMemoryError:
                pass
            torch.cuda.empty_cache()    # the failed attempt's frame is gone
            cuts.append(rows)
            rows //= 2
            if rows < 1024:
                fail(f"train {arch}: does not fit at batch 1024")
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        rel = within(f"train {arch} first loss vs float64", record[0][0],
                     loss64, TRAIN_F64_RTOL)
        losses = loss_falls(f"train {arch}", record)
        out[arch] = {"batch": rows, "cut_from": cuts,
                     "step_ms": step_ms(record), "losses": losses,
                     "f64_rel": rel, "peak": peak}
        print(f"train {arch}: batch {rows:,}"
              + (f" (halved from {cuts[0]:,}: did not fit)" if cuts else "")
              + f", {n_params:,} parameters; first loss {record[0][0]!r} "
              f"(float64 {loss64!r}, rel {rel:.3g} <= {TRAIN_F64_RTOL}); "
              f"losses {losses}; step {out[arch]['step_ms']:.1f} ms; peak "
              f"{peak / 2**30:.2f} GiB")
    return out


def gat_train(seed: int, dev) -> dict:
    """gat-cora at ``full_graph_sm``: a Cora-sized graph (2,708 nodes,
    10,556 edges of a power-law graph from ``--seed`` padded to 16,384,
    1,433 features, 7 classes, 140 labelled nodes) trained full-batch for
    GAT_TRAIN_STEPS steps: the first loss against float64, the loss
    falling."""
    import copy
    import itertools
    import numpy as np
    import torch
    from repro_torch.configs import base
    from repro_torch.data import graph
    from repro_torch.models import gat
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import (init_state, make_train_step,
                                           train_loop)
    spec = base.get("gat-cora")
    cfg = spec.make_config()
    dims = spec.shape("full_graph_sm").dims
    n, e_pad = dims["n_nodes"], dims["n_edges"]
    rng = np.random.default_rng(seed)
    g = graph.random_power_law_graph(rng, n, 4, dims["d_feat"],
                                     dims["n_classes"])
    dst = np.repeat(np.arange(n), np.diff(g.indptr))
    keep = np.sort(rng.choice(dst.shape[0], CORA_EDGES, replace=False))
    src_p, dst_p = np.zeros(e_pad, np.int64), np.zeros(e_pad, np.int64)
    src_p[:CORA_EDGES], dst_p[:CORA_EDGES] = g.indices[keep], dst[keep]
    mask = np.zeros(n, bool)
    mask[rng.choice(n, CORA_TRAIN_NODES, replace=False)] = True
    batch = {"x": torch.from_numpy(g.features).to(dev),
             "src": torch.from_numpy(src_p).to(dev),
             "dst": torch.from_numpy(dst_p).to(dev),
             "edge_mask": torch.arange(e_pad, device=dev) < CORA_EDGES,
             "labels": torch.from_numpy(g.labels).to(dev),
             "label_mask": torch.from_numpy(mask).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    model = gat.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                            dev)
    with torch.no_grad():            # the loss's own log-softmax is float32
        logp = torch.log_softmax(gat.forward(
            copy.deepcopy(model).double(),
            {**batch, "x": batch["x"].double()}, cfg), dim=-1)
        w = batch["label_mask"].double()
        loss64 = float(-(logp.gather(1, batch["labels"][:, None])[:, 0]
                         * w).sum() / w.sum())
    params = dict(model.named_parameters())
    opt = opt_lib.chain(opt_lib.clip_by_global_norm(1.0), opt_lib.adamw(1e-3))
    record = []
    train_loop(init_state(params, opt),
               recorded(make_train_step(
                   lambda p, b: gat.loss_fn(model, b, cfg), opt), record),
               itertools.repeat(batch), n_steps=GAT_TRAIN_STEPS,
               log_every=10 ** 9, log_fn=print)
    rel = within("train gat-cora first loss vs float64", record[0][0], loss64,
                 TRAIN_F64_RTOL)
    losses = loss_falls("train gat-cora", record)
    peak = torch.cuda.max_memory_allocated()
    print(f"train gat-cora: {n} nodes, {CORA_EDGES} edges padded to {e_pad}, "
          f"{dims['d_feat']} features, {CORA_TRAIN_NODES} labelled nodes; "
          f"first loss {record[0][0]!r} (float64 {loss64!r}, rel {rel:.3g} "
          f"<= {TRAIN_F64_RTOL}); losses {losses}; step "
          f"{step_ms(record):.2f} ms; peak {peak / 2**30:.2f} GiB")
    return {"step_ms": step_ms(record), "losses": losses, "f64_rel": rel,
            "peak": peak}


def train_path(seed: int, dev, card: str, mp_dir: str | None = None) -> dict:
    """The train phase: ``lm_train``, ``recsys_train`` and ``gat_train``
    under deterministic algorithms (the resume check is bit for bit). No
    hand-written kernel lies on this path, as no Pallas kernel lies on the
    reference's: the phase fails if any launched. With ``mp_dir`` the LM
    saves the model-parallel phase's answers there. Returns the peak
    device memory before the phase and the phase's numbers."""
    import torch
    from repro_torch.kernels import ops
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the ops used here have deterministic CUDA forms; filling every new
    # buffer with NaN (the mode's default) would only slow the steps
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    ops.reset_launch_counts()
    try:
        out = {"lm": lm_train(seed, dev, mp_dir)}
        out["recsys"] = recsys_train(seed, dev)
        out["gat"] = gat_train(seed, dev)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    launched = {k: v for k, v in ops.launch_counts.items() if v}
    if launched:
        fail(f"train phase launched hand-written kernels: {launched}")
    peak = max([out["lm"]["peak"], out["gat"]["peak"]]
               + [r["peak"] for r in out["recsys"].values()])
    lm = out["lm"]
    idle = ("not measured" if lm["busy_s"] is None else
            f"{1 - lm['busy_s'] / lm['profiled_s']:.1%}")
    print(f"train phase on {card}: {time.perf_counter() - t0:.1f} s host, "
          f"no kernel launched (chunked attention, as the reference "
          f"trains), peak device memory {peak / 2**30:.2f} GiB; qwen3-0.6b "
          f"step {lm['step_ms']:.1f} ms, {lm['tokens_per_s']:,.0f} tokens/s, "
          f"MFU {lm['mfu']:.2%}, device idle {idle} of a profiled step; "
          + "; ".join(f"{a} step {r['step_ms']:.1f} ms at batch "
                      f"{r['batch']:,}" for a, r in out["recsys"].items())
          + f"; gat-cora step {out['gat']['step_ms']:.2f} ms")
    return {"peak_before": peak_before, "peak": peak, **out}


def float32_copy(model, n_layers: int | None = None):
    """The model's first ``n_layers`` blocks (all by default) with its
    embed, head and final norm, upcast to float32 (exact from bf16), on
    chunked attention: the arbiter of how far two bf16 paths may drift."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    cfg32 = dataclasses.replace(model.cfg, attn_impl="chunked",
                                dtype=torch.float32,
                                n_layers=n_layers or model.cfg.n_layers)
    model32 = tf.LM(cfg32, model.embed.device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in model32.named_parameters():
            p.copy_(params[name])
    return model32


def cut_model(model, n_layers: int):
    """A view of ``model`` with its first ``n_layers`` blocks: the same
    parameter tensors, no copy."""
    import dataclasses
    from torch import nn
    from repro_torch.models import transformer as tf
    cut = tf.LM(dataclasses.replace(model.cfg, n_layers=n_layers), "meta")
    cut.embed, cut.head = model.embed, model.head
    cut.final_norm = model.final_norm
    cut.blocks = nn.ModuleList(list(model.blocks)[:n_layers])
    return cut


def serve_lm(label: str, model, prompts, steps: int, mark=None) -> dict:
    """One cold ``prefill`` of ``prompts``, then a timed one and ``steps``
    greedy ``decode_step``s, each with the launch counts set to 0 just
    before it and read just after. Fails unless ``flash_attention`` ran
    once a layer in prefill, all on its ``wgmma`` route, no other
    hand-written kernel ran, none ran in decode, and the outputs are
    finite tokens of the vocabulary. ``mark(phase)`` is called with
    "prefill" and "decode" just before each timed part and "done" after."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    mark = mark or (lambda phase: None)
    # warm-up at full size: the first prefill at these shapes also pays
    # cuBLAS's handles and heuristics and the caching allocator's first
    # blocks (68.7 to 150.5 ms on one H100 after a 256-token warm-up)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tf.prefill(model, prompts)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mark("prefill")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(model, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches_prefill = dict(ops.launch_counts)
    mark("decode")
    ops.reset_launch_counts()
    nxt = logits.argmax(-1)
    tokens_out, fed, all_steps = [], [], []
    t0 = time.perf_counter()
    for step in range(steps):
        fed.append(nxt)
        step_logits, cache = tf.decode_step(model, cache, nxt)
        all_steps.append(step_logits)
        if step == 0:
            first_step = step_logits
        nxt = step_logits.argmax(-1)
        tokens_out.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches_decode = dict(ops.launch_counts)
    mark("done")
    peak = torch.cuda.max_memory_allocated()
    b, s = prompts.shape
    print(f"{label} prefill: {prefill_s:.4f} s for {b} x {s} tokens = "
          f"{b * s / prefill_s:,.0f} prompt tokens/s (the first, cold, "
          f"{cold_s:.4f} s); launches {launches_prefill}")
    print(f"{label} decode: {decode_s * 1e3 / steps:.3f} ms/step, "
          f"{b * steps / decode_s:,.1f} generated tokens/s ({steps} steps, "
          f"batch {b}); launches {launches_decode}")
    print(f"{label} peak device memory (prefill + decode): "
          f"{peak / 2**30:.2f} GiB")
    for name, n in launches_prefill.items():
        want = cfg.n_layers if name.startswith("flash_attention") else 0
        if n != want:
            fail(f"{label}: prefill launched {name} {n} times, not {want}")
    launched = {k: v for k, v in launches_decode.items() if v}
    if launched:
        fail(f"{label}: decode launched hand-written kernels: {launched}")
    out = torch.stack(tokens_out, 1)
    if (logits.shape != (b, cfg.vocab) or cache["length"] != s + steps
            or out.shape != (b, steps)
            or not bool(torch.isfinite(logits).all())
            or not bool(torch.isfinite(step_logits).all())
            or bool(((out < 0) | (out >= cfg.vocab)).any())):
        fail(f"{label}: bad prefill or decode output")
    return dict(logits=logits, first_step=first_step, prefill_s=prefill_s,
                fed=torch.stack(fed), step_logits=torch.stack(all_steps),
                decode_s=decode_s, cold_s=cold_s, steps=steps,
                launches=launches_prefill, launches_decode=launches_decode,
                peak=peak, peak_before=peak_before)


def flash_rule(label: str, model, prompts, logits, model32=None) -> float:
    """Flash against the plain chunked attention on the same weights and
    prompts. Through many bf16 layers of random weights both drift from
    the exact function by rounding, so a fixed tolerance says little; the
    arbiter is the same model in float32 (``float32_copy``, chunked
    attention; ``model32`` if given). The flash prefill's last ``logits``
    must be no further from it than the chunked prefill's (1.25x margin,
    max and mean), and flash and chunked must agree within twice the
    chunked prefill's distance to it, which is returned as the tolerance
    of the other bf16 checks."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, attn_impl="chunked")
    chunked, _ = tf.prefill(model, prompts)
    model.cfg = cfg
    if model32 is None:
        model32 = float32_copy(model)
    exact, _ = tf.prefill(model32, prompts)
    del model32
    err_f, err_c = (logits - exact).abs(), (chunked - exact).abs()
    tol = 2 * float(err_c.max())
    diff = float((logits - chunked).abs().max())
    ties = greedy_ties(chunked, logits, tol)
    ties32 = greedy_ties(exact, logits, tol)
    print(f"{label} check prefill last logits (|logit| <= "
          f"{float(exact.abs().max()):.3f}) against the float32 model: "
          f"flash max {float(err_f.max()):.6f} mean "
          f"{float(err_f.mean()):.6f}, chunked max {float(err_c.max()):.6f} "
          f"mean {float(err_c.mean()):.6f}; flash vs chunked max {diff:.6f} "
          f"(tolerance {tol:.6f}); greedy tokens differ from chunked in "
          f"{ties} and from float32 in {ties32} of {logits.shape[0]} rows, "
          f"all traced near-ties")
    if (float(err_f.max()) > 1.25 * float(err_c.max())
            or float(err_f.mean()) > 1.25 * float(err_c.mean())):
        fail(f"{label}: the flash prefill is further from the float32 model "
             f"than the chunked prefill")
    if diff > tol:
        fail(f"{label}: flash and chunked prefill logits differ by {diff}, "
             f"more than {tol}")
    return tol


def cache_check(label: str, model, prompts, tol: float) -> None:
    """The cache: ``decode_step`` at position S after a prefill of S
    tokens equals the last logits of a prefill of the S + 1 tokens (two
    bf16 paths: held within ``tol``)."""
    import torch
    from repro_torch.models import transformer as tf
    s = prompts.shape[1]
    logits, cache = tf.prefill(model, prompts)
    nxt = logits.argmax(-1)
    stepped, _ = tf.decode_step(model, cache, nxt)
    del cache
    whole, _ = tf.prefill(model, torch.cat([prompts, nxt[:, None]], 1))
    cerr = float((stepped - whole).abs().max())
    cties = greedy_ties(whole, stepped, tol)
    print(f"{label} check cache: decode_step at {s} vs prefill of {s + 1} "
          f"tokens (flash, ragged S): max abs err {cerr:.6f} (tolerance "
          f"{tol:.6f}); greedy ties {cties}")
    if cerr > tol:
        fail(f"{label}: decode logits differ from the longer prefill's by "
             f"{cerr}")


def lm_path(seed: int, dev, mp_dir: str | None = None):
    """The LM serving path: qwen3-0.6b at full width and depth in bf16,
    ``attn_impl="flash"``, weights drawn from ``seed``; prefill of
    LM_BATCH prompts of LM_PROMPT tokens, then LM_STEPS greedy decode
    steps. Holds flash against chunked prefill and decode against a longer
    prefill; returns what the kernel checks and the kernels line need."""
    import dataclasses
    import torch
    from repro_torch.configs import base
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(base.get("qwen3-0.6b").make_config(),
                              attn_impl="flash",
                              max_seq=LM_PROMPT + LM_STEPS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"lm: {cfg.name} L={cfg.n_layers} d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} {cfg.dtype}, {n_params:,} "
          f"parameters (n_params {cfg.n_params:,} + qk-norm scales), "
          f"weights from seed {seed} in {time.perf_counter() - t0:.2f} s; "
          f"{LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_STEPS} greedy "
          f"steps, max_seq {cfg.max_seq}")
    run = serve_lm("lm", model, prompts, LM_STEPS)
    tol = flash_rule("lm", model, prompts, run["logits"])
    cache_check("lm", model, prompts, tol)
    if mp_dir is not None:
        save_lm_answers(mp_dir, model, prompts, run, tol)

    device_profile("lm prefill", lambda: tf.prefill(model, prompts))
    _, cache = tf.prefill(model, prompts)
    nxt = run["logits"].argmax(-1)

    def steps():
        for _ in range(4):
            tf.decode_step(model, cache, nxt)

    device_profile("lm 4 decode steps", steps)
    return dict(cfg=cfg, model=model, prompts=prompts,
                prefill_s=run["prefill_s"], launches=run["launches"],
                peak_before=run["peak_before"])


def flash_build_report() -> dict:
    """Registers, shared memory and spills of each flash kernel from the
    build's ``-Xptxas -v`` output, and the count of ``HGMMA`` and
    ``UTMALDG`` instructions in each kernel's SASS (``cuobjdump``; None
    where the toolkit has none). Prints both and returns them."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import _build

    def short(mangled):
        m = re.search(r"(flash_(?:wgmma|bf16|f32)_kernel)(?:ILi(\d+)E)?",
                      mangled)
        return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)

    ptxas, name = {}, None
    for line in _build.build_log("flash_attention").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m and "flash_" in m.group(1):
            name = short(m.group(1))
        elif name and ("spill" in line or "Used" in line):
            ptxas[name] = (ptxas.get(name, "") + " " + line.split(":")[-1]
                           .strip()).strip()
    lib = _build.load("flash_attention")
    for dp in (64, 128):        # dynamic, so not in the -Xptxas -v lines
        ptxas[f"flash_wgmma_kernel<{dp}>"] += (
            f", {lib.flash_wgmma_smem_bytes(dp)} bytes dynamic smem")
    for k, v in ptxas.items():   # wgmma: the count at entry; setmaxnreg
        print(f"ptxas {k}: {v}")  # then gives consumers 240, producer 24
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = None
    if tool.exists():
        out = subprocess.run([str(tool), "-sass",
                              str(_build._target("flash_attention"))],
                             capture_output=True, text=True,
                             check=True).stdout
        sass, name = {}, None
        for line in out.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                name = short(m.group(1))
                sass[name] = {"HGMMA": 0, "UTMALDG": 0}
            elif name:
                for ins in ("HGMMA", "UTMALDG"):
                    sass[name][ins] += ins in line
        for k, v in sass.items():
            print(f"sass {k}: {v['HGMMA']} HGMMA, {v['UTMALDG']} UTMALDG")
        wg = [v for k, v in sass.items() if k.startswith("flash_wgmma")]
        if not wg or not all(v["HGMMA"] and v["UTMALDG"] for v in wg):
            fail("the wgmma flash kernels issue no HGMMA or no UTMALDG")
    else:
        print(f"sass: cuobjdump is missing ({tool}): HGMMA and UTMALDG "
              f"not counted")
    return {"ptxas": ptxas, "sass": sass}


def flash_kernel_entry(lm: dict, seed: int, dev) -> dict:
    """Hold the flash kernel against its plain version on layer 0's own
    q/k/v from the LM prefill (bf16, the 8 KV heads as the model makes
    them), on ``FLASH_CHECKS``; time it, the earlier mma.sync kernel on the
    same inputs, its plain version and SDPA; return its kernels-line
    entry."""
    import torch
    from repro_torch.kernels import flash_attention, ops, ref
    from repro_torch.models import attention
    from repro_torch.models import transformer as tf
    cfg, model = lm["cfg"], lm["model"]
    blk = model.blocks[0]
    with torch.no_grad():
        h = tf._rms_norm(model.embed[lm["prompts"]], blk.ln1)
        pos = torch.arange(LM_PROMPT, device=dev)
        q, k, v = (t.contiguous() for t in tf._project_qkv(h, blk, cfg, pos))
    rep = cfg.n_heads // cfg.n_kv_heads
    if flash_attention.route(q, k, v) != "wgmma":
        fail("layer 0's q/k/v do not take the wgmma route")

    def bf16_tol(a):           # two bf16 ulps of the plain output
        return 2.0 ** -6 * a + 1e-3

    def f32_tol(a):
        return 5e-5

    err = flash_close(ops.flash_attention(q, k, v),
                      ref.flash_attention(q, k, v), bf16_tol)
    print(f"check flash_attention layer 0 q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)} bf16 causal: max abs err {err:.6f}, every "
          f"value within 2**-6 |plain| + 1e-3")
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32_args = None
    for shape, hkv, dtype, causal in FLASH_CHECKS:
        kv_shape = (shape[0], hkv) + shape[2:]
        a, b, c = (torch.randn(sh, generator=gen, device=dev).to(
            getattr(torch, dtype)) for sh in (shape, kv_shape, kv_shape))
        wgmma = flash_attention.route(a, b, c) == "wgmma"
        before = ops.launch_counts["flash_attention_wgmma"]
        e = flash_close(ops.flash_attention(a, b, c, causal=causal),
                        ref.flash_attention(a, b, c, causal=causal),
                        bf16_tol if dtype == "bfloat16" else f32_tol)
        if ops.launch_counts["flash_attention_wgmma"] - before != wgmma:
            fail(f"flash check {shape}: the wgmma count did not follow "
                 f"the route")
        print(f"check flash_attention {shape} KV heads {hkv} {dtype} "
              f"causal={causal} ({'wgmma' if wgmma else 'not wgmma'}): "
              f"max abs err {e:.7f}")
        if f32_args is None and dtype == "float32" and causal:
            f32_args = (a, b, c)

    b, hh, s, dh = q.shape
    ms = device_ms(lambda: ops.flash_attention(q, k, v), 20, replays=3)
    call = call_ms(lambda: ops.flash_attention(q, k, v), 20)
    mma_ms = device_ms(lambda: flash_attention._launch(q, k, v, True, "mma"),
                       5, replays=3)
    plain = device_ms(lambda: ref.flash_attention(q, k, v), 2, replays=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kr = attention.repeat_kv(k, rep).contiguous()
    vr = attention.repeat_kv(v, rep).contiguous()
    lib = device_ms(lambda: sdpa(q, kr, vr, is_causal=True), 20, replays=3)
    f32_ms = device_ms(lambda: ops.flash_attention(*f32_args), 5, replays=3)
    flops = 4 * dh * b * hh * s * (s + 1) // 2
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    t_ops, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_b) * 1e3
    by = "operations" if t_ops >= t_b else "bytes"
    f32_simt = flops / FP32_FLOP_PER_S * 1e3
    print(f"time flash_attention q {tuple(q.shape)} k/v {tuple(k.shape)} "
          f"bf16 causal: wgmma kernel {ms:.5f} ms (device), {call:.5f} ms "
          f"per call from Python; the earlier mma.sync kernel on the same "
          f"inputs {mma_ms:.5f} ms; plain {plain:.5f} ms; bound "
          f"{bound:.6f} ms ({by}: {flops / 1e9:.2f} GFLOP at 989 TFLOP/s "
          f"bf16; {nbytes / 1e6:.1f} MB at 3.35 TB/s; f32 SIMT figure "
          f"{f32_simt:.4f} ms at 67 TFLOP/s); library "
          f"scaled_dot_product_attention(is_causal=True) on repeated KV "
          f"{lib:.5f} ms; {flops / ms / 1e9:.1f} TFLOP/s; the float32 "
          f"(SIMT) kernel at {tuple(f32_args[0].shape)}: {f32_ms:.5f} ms")
    print(f"lm prefill share of flash: {cfg.n_layers} x {ms:.3f} ms = "
          f"{cfg.n_layers * ms:.1f} ms of {lm['prefill_s'] * 1e3:.1f} ms")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81",
            "launches": lm["launches"]["flash_attention"],
            "launches_wgmma": lm["launches"]["flash_attention_wgmma"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "library_call": "torch.nn.functional."
                            "scaled_dot_product_attention(is_causal=True), "
                            "KV repeated",
            "call_ms": call, "mma_sync_ms": mma_ms,
            "tflops": flops / ms / 1e9, "f32_simt_bound_ms": f32_simt,
            "f32_ms": f32_ms, "f32_shape": str(tuple(f32_args[0].shape)),
            "shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
            "build": lm["flash_build"]}


NEMO_STEPS = 8           # mistral-nemo decode steps, cut from LM_STEPS
NEMO_CHECK_LAYERS = 10   # its float32 arbiter's depth: 40 layers in
#                          float32 (49 GB) do not fit beside the bf16 model


class RouteRecorder:
    """Forward pre-hooks on every MoE layer of a model that re-run the
    port's own routing (``moe.route``) on the layer's input and keep, per
    call, the dropped assignments (a device count, read later: no sync in
    the timed runs) and layer 0's chosen experts, under the phase name
    last given to ``mark``."""

    def __init__(self, model):
        from repro_torch.models import moe
        self.phase, self.drops, self.top_e0 = None, {}, {}

        def pre(i):
            def hook(module, args):
                if self.phase is None:
                    return
                x, cfg = args
                t = x.shape[0] * x.shape[1]
                _, top_e, _, _, keep = moe.route(
                    x.reshape(t, -1), module.router, cfg,
                    moe.expert_capacity(cfg, t))
                self.drops.setdefault(self.phase, []).append(
                    (i, (~keep).sum(), keep.numel()))
                if i == 0:
                    self.top_e0[self.phase] = top_e
            return hook

        self.handles = [blk.moe.register_forward_pre_hook(pre(i))
                        for i, blk in enumerate(model.blocks)]

    def mark(self, phase):
        self.phase = None if phase == "done" else phase

    def dropped(self, phase) -> tuple[list, int, int]:
        """(per-layer dropped shares of the phase's first call, dropped
        and assignments over all its calls)."""
        recs = self.drops.get(phase, [])
        first = {}
        for i, d, n in recs:
            first.setdefault(i, int(d) / n)
        return ([first[i] for i in sorted(first)],
                sum(int(d) for _, d, _ in recs), sum(n for _, _, n in recs))

    def remove(self):
        for h in self.handles:
            h.remove()


def layer0_qkv(model, prompts):
    """Layer 0's q/k/v of ``model``'s prefill of ``prompts`` (bf16, the
    KV heads as the model makes them), contiguous."""
    import torch
    from repro_torch.models import transformer as tf
    blk = model.blocks[0]
    with torch.no_grad():
        h = tf._rms_norm(model.embed[prompts], blk.ln1)
        pos = torch.arange(prompts.shape[1], device=prompts.device)
        return tuple(t.contiguous()
                     for t in tf._project_qkv(h, blk, model.cfg, pos))


def flash_timed_entry(name: str, q, k, v, launches, launches_wgmma) -> dict:
    """Hold the flash kernel against its plain version on q/k/v (within
    two bf16 ulps), time it (CUDA-graph replay), its plain version and
    SDPA on repeated KV, and return its kernels-line entry with the
    operations bound."""
    import torch
    from repro_torch.kernels import flash_attention, ops, ref
    from repro_torch.models import attention
    if flash_attention.route(q, k, v) != "wgmma":
        fail(f"{name}: q/k/v do not take the wgmma route")
    err = flash_close(ops.flash_attention(q, k, v),
                      ref.flash_attention(q, k, v),
                      lambda a: 2.0 ** -6 * a + 1e-3)
    ms = device_ms(lambda: ops.flash_attention(q, k, v), 20, replays=3)
    plain = device_ms(lambda: ref.flash_attention(q, k, v), 2, replays=3)
    rep = q.shape[1] // k.shape[1]
    kr = attention.repeat_kv(k, rep).contiguous()
    vr = attention.repeat_kv(v, rep).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = device_ms(lambda: sdpa(q, kr, vr, is_causal=True), 20, replays=3)
    b, hh, s, dh = q.shape
    flops = 4 * dh * b * hh * s * (s + 1) // 2
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    bnd, by = bound(nbytes, flops / BF16_FLOP_PER_S)
    print(f"check {name} q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
          f"causal: max abs err {err:.6f}, every value within 2**-6 "
          f"|plain| + 1e-3")
    print(f"time {name} q {tuple(q.shape)} k/v {tuple(k.shape)}: wgmma "
          f"kernel {ms:.5f} ms (device); plain {plain:.5f} ms; bound "
          f"{bnd:.6f} ms ({by}: {flops / 1e9:.2f} GFLOP at 989 TFLOP/s "
          f"bf16); library scaled_dot_product_attention(is_causal=True) on "
          f"repeated KV {lib:.5f} ms; {flops / ms / 1e9:.1f} TFLOP/s")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81",
            "launches": launches, "launches_wgmma": launches_wgmma,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib,
            "library_call": "torch.nn.functional."
                            "scaled_dot_product_attention(is_causal=True), "
                            "KV repeated",
            "tflops": flops / ms / 1e9,
            "shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal"}


def flash_shape_entry(arch: str, model, prompts, launches: dict) -> dict:
    """``flash_timed_entry`` on layer 0's own q/k/v of ``model``'s prefill
    of ``prompts``."""
    return flash_timed_entry(f"flash_attention/{arch}",
                             *layer0_qkv(model, prompts),
                             launches["flash_attention"],
                             launches["flash_attention_wgmma"])


def flash_tp_entry(arch: str, model, prompts, tp: int) -> dict:
    """``flash_timed_entry`` at the shapes a rank of a ``tp``-way head
    split launches (``transformer.py``'s TP prefill: its contiguous block
    of query and KV heads), on rank 0's heads of layer 0's q/k/v. The
    launches are the model-parallel phase's, a rank, filled in there."""
    q, k, v = layer0_qkv(model, prompts)
    hq, hk = q.shape[1] // tp, k.shape[1] // tp
    return flash_timed_entry(f"flash_attention/{arch}-tp{tp}",
                             q[:, :hq].contiguous(), k[:, :hk].contiguous(),
                             v[:, :hk].contiguous(), None, None)


def row_parallel_times(model, prompts, tp: int) -> dict:
    """A rank's row-parallel products of a ``tp``-way TP prefill of
    ``model`` (``transformer._mm_f32``: bf16 operands, float32 output) at
    ``prompts``' tokens, on rank 0's rows of layer 0's ``wo`` and
    ``w_out``: held against the float32 product of the upcast operands
    (exact operands, so only the order of the sums differs) and timed
    (CUDA-graph replay) beside that float32 product and one device's bf16
    product of the whole weight."""
    import torch
    from repro_torch.models import transformer as tf
    blk = model.blocks[0]
    rows = prompts.numel()
    gen = torch.Generator(device=prompts.device).manual_seed(7)
    out, flops = {}, 0
    for name in ("wo", "w_out"):
        w = getattr(blk, name).detach()
        w_l = w[:w.shape[0] // tp].contiguous()
        a = torch.randn(rows, w.shape[0], generator=gen, device=w.device,
                        dtype=torch.float32).to(w.dtype)
        a_l = a[:, :w_l.shape[0]].contiguous()
        got = tf._mm_f32(a_l, w_l)
        want = a_l.float() @ w_l.float()
        err = float((got - want).abs().max() / want.abs().max())
        if got.dtype != torch.float32 or err > 3e-5:
            fail(f"row-parallel {name}: out_dtype product {got.dtype} "
                 f"relative err {err}")
        out[name] = {
            "shape": f"({rows}, {w_l.shape[0]}) x {tuple(w_l.shape)}",
            "max_err_over_max": err,
            "ms": device_ms(lambda: tf._mm_f32(a_l, w_l), 20, replays=3),
            "f32_ms": device_ms(lambda: a_l.float() @ w_l.float(), 20,
                                replays=3),
            "whole_bf16_ms": device_ms(lambda: a @ w, 20, replays=3)}
        flops += 2 * rows * w_l.shape[0] * w_l.shape[1]
    for name, t in out.items():
        print(f"time row-parallel {name} a rank of TP {tp}, {t['shape']} "
              f"bf16 -> float32: {t['ms']:.5f} ms (device; max |err| "
              f"{t['max_err_over_max']:.2e} of the float32 product's max "
              f"|value|); the "
              f"float32 product of the upcast operands {t['f32_ms']:.5f} "
              f"ms; one device's bf16 product of the whole weight "
              f"{t['whole_bf16_ms']:.5f} ms")
    layers = model.cfg.n_layers
    print(f"time row-parallel a rank's prefill: {layers} layers x "
          f"(wo + w_out) = {layers * sum(t['ms'] for t in out.values()):.3f}"
          f" ms, float32 {layers * sum(t['f32_ms'] for t in out.values()):.3f}"
          f" ms; {layers * flops / 1e12:.3f} TFLOP")
    return out


def lm_setup(arch: str, seed: int, dev, steps: int, label: str):
    """``arch``'s full config with flash attention and room for ``steps``
    decode steps, its weights drawn from ``seed`` on the card, and
    LM_BATCH prompts of LM_PROMPT tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import base
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(base.get(arch).make_config(),
                              attn_impl="flash", max_seq=LM_PROMPT + steps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    moe = cfg.moe
    print(f"{label}: {cfg.name} L={cfg.n_layers} d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.head_dim} "
          + (f"{moe.n_experts} experts top-{moe.top_k} d_ff_expert="
             f"{moe.d_ff_expert} capacity factor {moe.capacity_factor} "
             if moe else f"d_ff={cfg.d_ff} ")
          + f"vocab={cfg.vocab} {cfg.dtype}, {n_params:,} parameters "
          f"(n_params {cfg.n_params:,}, {n_params * 2 / 1e9:.1f} GB), "
          f"weights from seed {seed} in {time.perf_counter() - t0:.2f} s; "
          f"{LM_BATCH} prompts x {LM_PROMPT} tokens, {steps} greedy steps")
    return cfg, model, prompts


def moe_path(seed: int, dev, mp_dir: str | None = None) -> dict:
    """MoE LM serving: olmoe-1b-7b at full width and depth in bf16
    (16 layers, 64 experts top-8), flash prefill of LM_BATCH x LM_PROMPT
    tokens and LM_STEPS greedy decode steps, the dropped share of each
    layer, the flash/chunked/float32 rule, the cache at a capacity that
    drops nothing, profiles; returns the kernels-line entry."""
    import dataclasses
    import torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    cfg, model, prompts = lm_setup("olmoe-1b-7b", seed, dev, LM_STEPS,
                                   "moe")
    routes = RouteRecorder(model)
    run = serve_lm("moe", model, prompts, LM_STEPS, mark=routes.mark)
    shares, dropped, assigned = routes.dropped("prefill")
    if mp_dir is not None:
        save_moe_answers(mp_dir, model, prompts, shares, dropped / assigned)
    _, d_dropped, d_assigned = routes.dropped("decode")
    with torch.no_grad():
        _, aux, _ = tf.forward(model, prompts)
    print(f"moe routing in the timed prefill (T = {LM_BATCH * LM_PROMPT} "
          f"tokens, capacity "
          f"{moe.expert_capacity(cfg.moe, LM_BATCH * LM_PROMPT)} a expert): "
          f"dropped {dropped} of {assigned} assignments "
          f"({dropped / assigned:.4%}); by layer "
          + ", ".join(f"{x:.4%}" for x in shares)
          + f"; aux loss (mean over layers) {float(aux):.6f}; decode "
          f"dropped {d_dropped} of {d_assigned} (capacity "
          f"{moe.expert_capacity(cfg.moe, LM_BATCH)} >= batch {LM_BATCH})")
    if len(shares) != cfg.n_layers or d_dropped != 0:
        fail(f"moe: {len(shares)} layers routed, {d_dropped} decode drops")

    routes.mark("chunked")
    tol = flash_rule("moe", model, prompts, run["logits"])
    routes.mark("done")
    a, b = (torch.sort(routes.top_e0[p], -1).values
            for p in ("prefill", "chunked"))
    print(f"moe layer-0 router choices, flash vs chunked prefill: "
          f"{int((a != b).sum())} of {a.numel()} differ, in "
          f"{int((a != b).any(-1).sum())} of {a.shape[0]} tokens (routing "
          f"is discrete: a rounding difference flips an expert near a "
          f"tie; the logits rule above decides)")

    # at the config's capacity factor decode and a longer prefill differ by
    # design: capacity grows with T = B * S and the stable sort drops the
    # last assignments first; at n_experts / top_k the capacity is T and
    # nothing drops
    no_drop = cfg.moe.n_experts / cfg.moe.top_k
    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=no_drop))
    routes.mark("cache")
    print(f"moe cache check at capacity factor {no_drop} (capacity = T, "
          f"nothing dropped; at {cfg.moe.capacity_factor} a decode step "
          f"and a prefill one token longer route with other capacities and "
          f"differ by design)")
    cache_check("moe", model, prompts, tol)
    routes.mark("done")
    _, c_dropped, _ = routes.dropped("cache")
    if c_dropped:
        fail(f"moe: {c_dropped} assignments dropped at capacity factor "
             f"{no_drop}")
    model.cfg = cfg
    routes.remove()

    device_profile("moe prefill", lambda: tf.prefill(model, prompts))
    _, cache = tf.prefill(model, prompts)
    nxt = run["logits"].argmax(-1)

    def steps():
        for _ in range(4):
            tf.decode_step(model, cache, nxt)

    device_profile("moe 4 decode steps", steps)
    del cache
    entry = flash_shape_entry(cfg.name, model, prompts, run["launches"])
    tp_entry = flash_tp_entry(cfg.name, model, prompts, MP_TP)
    peak = torch.cuda.max_memory_allocated()
    print(f"moe phase peak device memory (the float32 arbiter and the "
          f"no-drop cache check included): {peak / 2**30:.2f} GiB")
    out = dict(entry=entry, tp_entry=tp_entry, peak=peak,
               peak_before=run["peak_before"])
    del model, run
    torch.cuda.empty_cache()
    return out


def nemo_path(seed: int, dev) -> dict:
    """Dense LM serving at 12B: mistral-nemo-12b at full width and depth
    in bf16 (40 layers, 32 heads over 8 KV heads, d_model 5,120 against
    32 x 128 = 4,096 attention width), flash prefill of LM_BATCH x
    LM_PROMPT tokens and NEMO_STEPS greedy decode steps; the
    flash/chunked/float32 rule on its first NEMO_CHECK_LAYERS layers;
    returns the kernels-line entry."""
    import torch
    from repro_torch.models import transformer as tf
    cfg, model, prompts = lm_setup("mistral-nemo-12b", seed, dev,
                                   NEMO_STEPS, "nemo")
    print(f"nemo: {NEMO_STEPS} decode steps (cut from {LM_STEPS} for the "
          f"smoke's time)")
    run = serve_lm("nemo", model, prompts, NEMO_STEPS)
    cut = cut_model(model, NEMO_CHECK_LAYERS)
    print(f"nemo accuracy check on a depth cut: the first "
          f"{NEMO_CHECK_LAYERS} of {cfg.n_layers} blocks with the same "
          f"embed and head (a float32 copy of all {cfg.n_layers} layers, "
          f"{cfg.n_params * 4 / 1e9:.0f} GB, does not fit beside the bf16 "
          f"model)")
    logits, _ = tf.prefill(cut, prompts)
    flash_rule("nemo", cut, prompts, logits,
               float32_copy(model, NEMO_CHECK_LAYERS))
    del cut, logits
    entry = flash_shape_entry(cfg.name, model, prompts, run["launches"])
    peak = torch.cuda.max_memory_allocated()
    print(f"nemo phase peak device memory (the float32 arbiter included): "
          f"{peak / 2**30:.2f} GiB")
    out = dict(entry=entry, peak=peak, peak_before=run["peak_before"])
    del model, run
    torch.cuda.empty_cache()
    return out


# -- gloo worlds side by side ------------------------------------------------

GIB = 2 ** 30
# the most one rank of each world may reserve on the card: its allocator's
# cap (``_world_rank``), a quarter GiB above the largest rank's
# max_memory_allocated in runs on an H100 80GB HBM3, given beside it
# ((1, 2)'s before the cells and the cells' after them, from runs that
# held both in one world)
WORLD_PEAK = {"mp (1, 2)": 11.2 * GIB,           # 10.96 GiB allocated
              "mp (2, 2)": 8.4 * GIB,            # 8.10, and 8.14 alone
              "mesh cells (1, 2)": 15.1 * GIB,   # 14.85
              "mesh 2": 3.4 * GIB,               # 3.13
              "mesh 3": 4.9 * GIB}               # 4.64
# the ranks' allocator: segments that grow in place and give back free
# pages, so a capped rank reserves little more than it allocates
RANK_ALLOC_CONF = "expandable_segments:True"


@dataclasses.dataclass
class World:
    """One gloo world of ``spawn_worlds``: ``fn(rank, workdir, *args)`` in
    each of ``nprocs`` processes, each writing its record to
    ``rank<r>.json`` in ``workdir`` (the world's own directory, which also
    holds its ``file://`` rendezvous). ``peak``: the most bytes one rank
    may reserve on the card (0: not capped)."""
    name: str
    fn: object
    nprocs: int
    args: tuple = ()
    peak: float = 0


def reckon(worlds: list, held: int, context: int) -> int:
    """The card's memory while ``worlds`` run: each rank's peak and one
    CUDA context, and what this process holds (its own context
    included)."""
    return held + sum(w.nprocs * (w.peak + context) for w in worlds)


def reckoning_line(starting: World, alive: list, held: int, context: int,
                   budget: int) -> str:
    """The line a start prints: ``reckon`` of ``starting`` beside
    ``alive``, its parts and the budget."""
    worlds = alive + [starting]
    parts = " + ".join(f"{w.name} {w.nprocs} x {w.peak / GIB:.2f}"
                       for w in worlds)
    return (f"memory reckoning, starting {starting.name!r} beside "
            f"{[w.name for w in alive]}: rank peaks {parts} GiB, "
            f"{sum(w.nprocs for w in worlds)} contexts x "
            f"{context / GIB:.2f} GiB, this process {held / GIB:.2f} GiB: "
            f"{reckon(worlds, held, context) / GIB:.2f} GiB of a budget of "
            f"{budget / GIB:.2f} GiB")


def _world_rank(rank: int, fn, threads: int, peak: float, workdir: str,
                args: tuple) -> None:
    """A rank of ``spawn_worlds``: its share of the cores and, on the
    card, its allocator capped at ``peak`` bytes; then ``fn``."""
    import torch
    torch.set_num_threads(threads)
    if peak and torch.cuda.is_available():
        total = torch.cuda.get_device_properties(0).total_memory
        torch.cuda.set_per_process_memory_fraction(min(1.0, peak / total),
                                                   0)
    fn(rank, workdir, *args)


def start_world(w: World, threads: int, wdir: str):
    """``w``'s ranks, started (``torch.multiprocessing.start_processes``,
    spawned with ``RANK_ALLOC_CONF`` in their environment); returns the
    context."""
    import torch.multiprocessing as mp
    prior = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = RANK_ALLOC_CONF
    try:
        return mp.start_processes(
            _world_rank, args=(w.fn, threads, w.peak, wdir, w.args),
            nprocs=w.nprocs, join=False, start_method="spawn")
    finally:
        if prior is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prior


def spawn_worlds(worlds: list, root: str, held: int, context: int,
                 budget: int, watch=None) -> dict:
    """Run gloo worlds side by side, each in its own ``torch.
    multiprocessing.start_processes`` context and directory under
    ``root``. The memory reckoning decides the schedule: a world starts,
    in list order, as soon as ``reckon`` of it and the worlds alive (at
    ``held`` bytes for this process and ``context`` a process) fits
    ``budget``; the line of each start shows its reckoning, and a world
    that does not fit even alone fails the smoke. Each rank takes its
    share of this process's cores as torch threads, ``RANK_ALLOC_CONF``
    as its allocator's settings and its world's ``peak`` as its cap.
    ``watch()`` runs about every 0.2 s while a world runs. If any rank
    raises or dies, every rank of every world is terminated and waited
    for, and the smoke fails naming the world. Returns {name: {"ranks":
    the ranks' records, "s": the world's wall seconds}}."""
    import torch.multiprocessing as mp
    from multiprocessing.connection import wait
    for w in worlds:
        if reckon([w], held, context) > budget:
            fail(reckoning_line(w, [], held, context, budget)
                 + ": past the budget even alone")
    cores = len(os.sched_getaffinity(0))
    pending, running, out = list(worlds), {}, {}
    try:
        while pending or running:
            starting = []
            for w in list(pending):
                alive = [r[0] for r in running.values()] + starting
                if reckon(alive + [w], held, context) <= budget:
                    print(reckoning_line(w, alive, held, context, budget))
                    pending.remove(w)
                    starting.append(w)
            if starting:
                threads = max(1, cores // sum(
                    w.nprocs for w in starting + [r[0] for r in
                                                  running.values()]))
                print(f"starting {[w.name for w in starting]}: {threads} "
                      f"torch threads a rank ({cores} cores)")
            for w in starting:
                wdir = os.path.join(root, f"world{len(out) + len(running)}")
                os.makedirs(wdir)
                running[w.name] = (w, start_world(w, threads, wdir), wdir,
                                   time.perf_counter())
            wait([s for _, ctx, _, _ in running.values()
                  for s in ctx.sentinels], timeout=0.2)
            if watch is not None:
                watch()
            for name, (w, ctx, wdir, t0) in list(running.items()):
                try:
                    done = ctx.join(timeout=0)
                except (mp.ProcessRaisedException,
                        mp.ProcessExitedException) as exc:
                    fail(f"world {name}: {exc}")
                if not done:
                    continue
                del running[name]
                ranks = []
                for r in range(w.nprocs):
                    path = os.path.join(wdir, f"rank{r}.json")
                    if not os.path.exists(path):
                        fail(f"world {name}: rank {r} ended without its "
                             f"record")
                    with open(path) as fh:
                        ranks.append(json.load(fh))
                out[name] = {"ranks": ranks, "s": time.perf_counter() - t0}
    finally:
        procs = [p for _, ctx, _, _ in running.values()
                 for p in ctx.processes]
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return out


# -- the model-parallel phase ----------------------------------------------

MP_WORLDS = ((1, 2), (2, 2))   # ("data", "model") gloo worlds on cuda:0
MP_TP = 2                # the "model" axis of both worlds
MP_LONG_STEPS = 8        # long-context decode steps (cut from LM_STEPS)
MP_CACHE_LAYERS = (0, 14, 27)   # qwen3 cache layers held (first, mid, last)
MP_MOE_WORLD = (1, 2)    # olmoe's expert parallelism runs on this world
MP_TIMEOUT = 300         # seconds a collective of a world may wait
# model-parallel training: qwen3 layers whose gradients are held (with the
# embedding, the head and the final norm); the depth of the resume from a
# sharded checkpoint (full width: gathering and writing the 28-layer state
# with AdamW's moments, ~7 GB a save, would take the phase past its time);
# olmoe's EP train step at full width, cut to this depth; EP's backward
# held against the per-shard composition within this share of each
# gradient's largest magnitude (two bf16 ulps: the composition adds the
# two shards' bf16 weight gradients where EP sums them in one product)
MP_TRAIN_LAYERS = (0, 14, 27)
MP_RESUME_LAYERS = 2
MP_MOE_TRAIN_LAYERS = 2
MP_EP_GRAD_TOL = 2.0 ** -7
# a model-parallel gradient leaf's max distance to float32 over one
# device's bf16 one (``grad_close``; mean and RMS stay at 1.25x)
MP_GRAD_MAX_RATIO = 1.5
MP_LABEL = ("ranks share one card, beside the other worlds' ranks; "
            "collectives staged through the host: not a multi-GPU speed")


def mp_file(mp_dir: str, name: str) -> str:
    return os.path.join(mp_dir, f"{name}.pt")


def save_retrieval_answers(mp_dir: str, cand, codes, proj, users, uu,
                           sketch_ids, items_head) -> None:
    """What the model-parallel phase holds two-tower retrieval against:
    the candidates, their codes and the query projection, the requests'
    user features and vectors, the single-device sketch ids, and for each
    world the single-device composition of the sharded scan (each of its
    shards' ``RETR_N_CAND`` nearest re-ranked, the winners merged: the
    mesh's semantics, ``engine/sharding.py::kmips_flat_arrays``)."""
    import torch
    from repro_torch.engine import sharding
    from repro_torch.kernels import ops, ref
    n = cand.shape[0]
    composed = {}
    for shape in MP_WORLDS:
        shards = shape[0] * shape[1]
        rows = sharding.pad_item_rows(
            cand, torch.arange(n, dtype=torch.int32, device=cand.device),
            torch.ones(n, dtype=torch.bool, device=cand.device), codes,
            shards, RETR_K)
        per = rows[0].shape[0] // shards
        vals, ids = [], []
        for u in uu:
            q = u[None, :].contiguous()
            qcode = ops.srp_hash(q, proj)
            parts = [sharding.kmips_flat_arrays(
                *(r[s * per:(s + 1) * per] for r in rows), qcode, q, RETR_K,
                n_cand=RETR_N_CAND) for s in range(shards)]
            best, pos = ref.topk_stable(torch.cat([p[0] for p in parts], 1),
                                        RETR_K)
            vals.append(best[0])
            ids.append(torch.cat([p[1] for p in parts], 1).gather(1, pos)[0])
        composed[shards] = (torch.stack(vals).cpu(), torch.stack(ids).cpu())
    torch.save({"cand": cand.cpu(), "codes": codes.cpu(), "proj": proj.cpu(),
                "users": users.cpu(), "u": uu.cpu(),
                "sketch_ids": sketch_ids.cpu(), "items_head": items_head.cpu(),
                "composed": composed}, mp_file(mp_dir, "retrieval"))


def save_lm_answers(mp_dir: str, model, prompts, run, tol: float) -> None:
    """What the model-parallel phase holds qwen3-0.6b against: the bf16
    prefill's last logits (flash, and chunked: the LM phase's baseline
    of bf16 prefill error), the tokens fed to each greedy step and each
    step's logits, and the same from the float32 arbiter (its prefill,
    and its decode fed the same tokens); the cache layers
    ``MP_CACHE_LAYERS`` of both; the greedy near-tie tolerance."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    s = prompts.shape[1]
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, attn_impl="chunked")
    chunked, _ = tf.prefill(model, prompts)
    model.cfg = cfg
    model32 = float32_copy(model)
    logits32, cache32 = tf.prefill(model32, prompts)
    layers = list(MP_CACHE_LAYERS)
    held32 = {k: cache32[k][layers, :, :, :s].cpu() for k in ("k", "v")}
    steps32 = []
    for tok in run["fed"]:
        step, cache32 = tf.decode_step(model32, cache32, tok)
        steps32.append(step)
    del model32, cache32
    _, cache = tf.prefill(model, prompts)
    torch.save({"prompts": prompts.cpu(), "logits": run["logits"].cpu(),
                "logits_chunked": chunked.cpu(),
                "logits32": logits32.cpu(), "fed": run["fed"].cpu(),
                "steps": run["step_logits"].cpu(),
                "steps32": torch.stack(steps32).cpu(), "tol": tol,
                "cache": {k: cache[k][layers, :, :, :s].cpu()
                          for k in ("k", "v")}, "cache32": held32},
               mp_file(mp_dir, "lm"))
    del cache
    torch.cuda.empty_cache()


def moe_check_layers(n_layers: int) -> tuple[int, int]:
    """The olmoe layers whose expert parallelism is held against the
    per-shard composition: layer 0, and the last (where a quarter of the
    assignments drop at the config's capacity)."""
    return 0, n_layers - 1


def save_moe_answers(mp_dir: str, model, prompts, shares, share) -> None:
    """What the model-parallel phase holds olmoe-1b-7b's expert
    parallelism against: the MoE input of ``moe_check_layers`` in a bf16
    prefill, and for each rank of ``MP_MOE_WORLD`` the single-device
    ``_moe_local`` of its sequence-parallel tokens at the local capacity
    (output, dropped assignments); the single-device phase's dropped
    shares. For the first of those layers also the backward of that
    composition: the gradients of the router, the experts and the input
    under the objective ``sum(out * cot) + aux_loss_weight * mean(aux)``
    over the ranks' shares, ``cot`` a seeded bf16 cotangent."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    layers = moe_check_layers(cfg.n_layers)
    seen = {}

    def keep(i):
        def hook(module, args):       # returns None: the args stay
            seen.setdefault(i, args[0])
        return hook

    hooks = [model.blocks[i].moe.register_forward_pre_hook(keep(i))
             for i in layers]
    tf.prefill(model, prompts)
    for h in hooks:
        h.remove()
    dp, tp = MP_MOE_WORLD
    held = {}
    with torch.no_grad():
        for i in layers:
            h = seen[i]
            s_l = h.shape[1] // tp
            outs, drops = [], []
            for j in range(tp):
                x = h[:, j * s_l:(j + 1) * s_l].reshape(-1, h.shape[-1])
                stats = {}
                out, _ = moe._moe_local(
                    x, model.blocks[i].moe, cfg.moe,
                    moe.expert_capacity(cfg.moe, x.shape[0]), stats)
                outs.append(out.cpu())
                drops.append(int(stats["dropped"]))
            held[i] = {"h": h.cpu(), "outs": outs, "drops": drops}
    held[layers[0]].update(moe_backward_answers(model, layers[0],
                                                seen[layers[0]]))
    torch.save({"prompts": prompts.cpu(), "layers": held, "shares": shares,
                "share": share}, mp_file(mp_dir, "moe"))


MOE_GRADS = ("router", "w_in", "w_gate", "w_out")


def moe_backward_answers(model, i: int, h) -> dict:
    """The per-shard composition's gradients of layer ``i``'s MoE on its
    input ``h`` (``save_moe_answers``), MP_MOE_WORLD's "model" shards at
    the local capacity."""
    import torch
    from repro_torch.models import moe
    cfg = model.cfg
    blk = model.blocks[i].moe
    gen = torch.Generator(device=h.device).manual_seed(i + 1)
    cot = torch.randn(h.shape, generator=gen, device=h.device).to(h.dtype)
    x = h.detach().clone().requires_grad_(True)
    tp = MP_MOE_WORLD[1]
    s_l = h.shape[1] // tp
    total, auxes = 0.0, []
    with torch.enable_grad():
        for j in range(tp):
            part = slice(j * s_l, (j + 1) * s_l)
            xj = x[:, part].reshape(-1, h.shape[-1])
            out, aux = moe._moe_local(xj, blk, cfg.moe,
                                      moe.expert_capacity(cfg.moe,
                                                          xj.shape[0]))
            total = total + (out.float() * cot[:, part].reshape(
                out.shape).float()).sum()
            auxes.append(aux)
        total = total + cfg.aux_loss_weight * torch.stack(auxes).mean()
        grads = torch.autograd.grad(total, [x] + [getattr(blk, n)
                                                  for n in MOE_GRADS])
    return {"cot": cot.cpu(), "grads": {"x": grads[0].cpu(), **{
        n: g.cpu() for n, g in zip(MOE_GRADS, grads[1:])}}}


def mp_close(label: str, got, want, want32) -> dict:
    """Hold bf16 ``got`` against the float32 arbiter ``want32`` no further
    than the single-device bf16 ``want`` is (1.25x margin, max and mean),
    and ``got`` against ``want`` within twice ``want``'s distance to
    ``want32``: the LM phase's rule for two bf16 paths (``flash_rule``).
    Returns the errors."""
    e_mp = (got.float() - want32.float()).abs()
    e_sd = (want.float() - want32.float()).abs()
    out = {"max": float(e_mp.max()), "mean": float(e_mp.mean()),
           "sd_max": float(e_sd.max()), "sd_mean": float(e_sd.mean()),
           "vs_sd": float((got.float() - want.float()).abs().max())}
    if out["max"] > 1.25 * out["sd_max"] or \
            out["mean"] > 1.25 * out["sd_mean"] or \
            out["vs_sd"] > 2 * out["sd_max"]:
        fail(f"model parallel {label}: max {out['max']} mean {out['mean']} "
             f"from the float32 model, single-device bf16 {out['sd_max']} "
             f"and {out['sd_mean']}; {out['vs_sd']} from single-device "
             f"bf16")
    return out


def mp_held(model, layers) -> list[str]:
    """The parameters whose gradients the model-parallel phase holds:
    every leaf of blocks ``layers``, the embedding, the head and the
    final norm."""
    blocks = tuple(f"blocks.{i}." for i in layers)
    return [n for n, _ in model.named_parameters()
            if n.startswith(blocks) or n in ("embed", "head", "final_norm")]


def mp_train_answers(mp_dir: str, model, batch, answers: dict, from_start,
                     held) -> None:
    """What the model-parallel phase holds qwen3-0.6b's training against,
    for each world's global batch (its first ``dp`` sequences, one a data
    rank): ``answers[dp]``, the bf16 loss, gradient norm and ``held``
    gradients and the same from the float32 copy, and here the losses of
    TRAIN_STEPS steps of chain(clip 1.0, adamw LM_LR) from the same
    weights on that batch repeated; and the batch itself."""
    import itertools
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import make_train_step, train_loop
    opt = opt_lib.chain(opt_lib.clip_by_global_norm(1.0),
                        opt_lib.adamw(LM_LR))
    step = make_train_step(lambda p, b: tf.lm_loss(model, b), opt)
    for n, rec in answers.items():
        run = []
        train_loop(from_start(), recorded(step, run),
                   itertools.repeat({k: v[:n] for k, v in batch.items()}),
                   n_steps=TRAIN_STEPS, log_every=10 ** 9, log_fn=print)
        rec["losses"] = [r[0] for r in run]
        rec["step_s"] = [r[2] for r in run]
    n = max(answers)
    torch.save({"tokens": batch["tokens"][:n].cpu(),
                "labels": batch["labels"][:n].cpu(), "held": list(held),
                **answers}, mp_file(mp_dir, "train"))
    print("train lm: saved the model-parallel phase's answers: "
          + "; ".join(f"{n} sequence(s): loss {r['loss16']!r} (float32 "
                      f"{r['loss32']!r}), grad norm {r['norm16']!r} "
                      f"(float32 {r['norm32']!r}), {TRAIN_STEPS} steps "
                      f"{[round(x, 4) for x in r['losses']]}"
                      for n, r in answers.items())
          + f"; {len(held)} gradients held")


def mp_moe_train_answers(mp_dir: str, seed: int, dev) -> None:
    """What the model-parallel phase holds olmoe-1b-7b's EP train step
    against: the model at full width cut to MP_MOE_TRAIN_LAYERS, at a
    capacity factor where nothing drops (E / k) and aux weight 0 (EP's
    aux is the mean of the shards', as the reference's ``shard_map``
    computes it, not one device's), one sequence of TRAIN_SEQ tokens; its
    bf16 loss, gradient norm and the gradients of every leaf but the
    experts', embedding and head (and layer 1's ``w_in``), and the same
    from the float32 copy."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_lib
    cfg = mp_moe_train_config()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    model = tf.init_params(cfg, gen, dev)
    batch = next(synthetic.lm_token_batches(gen, 1, TRAIN_SEQ, cfg.vocab))
    held = [n for n, _ in model.named_parameters()
            if n not in ("embed", "head") and ".moe.w_" not in n] + [
        "blocks.1.moe.w_in"]
    out = {"tokens": batch["tokens"].cpu(), "labels": batch["labels"].cpu(),
           "held": held}
    model32 = float32_copy(model)
    for tag, m in (("16", model), ("32", model32)):
        loss = tf.lm_loss(m, batch)
        named = dict(m.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        out[f"loss{tag}"] = float(loss.detach())
        out[f"norm{tag}"] = float(opt_lib.global_norm(grads))
        out[f"grads{tag}"] = {n: grads[n].cpu() for n in held}
        del grads, loss
    torch.save(out, mp_file(mp_dir, "moe_train"))
    print(f"moe lm: saved the model-parallel EP train step's answers "
          f"({cfg.n_layers} layers at full width, capacity factor "
          f"{cfg.moe.capacity_factor}): loss {out['loss16']!r} (float32 "
          f"{out['loss32']!r}), grad norm {out['norm16']!r} (float32 "
          f"{out['norm32']!r}), {len(held)} gradients held")
    del model, model32
    torch.cuda.empty_cache()


def mp_moe_train_config():
    """olmoe-1b-7b at full width, MP_MOE_TRAIN_LAYERS deep, capacity
    factor E / k (nothing drops), aux weight 0, chunked attention."""
    import dataclasses
    from repro_torch.configs import base
    cfg = base.get("olmoe-1b-7b").make_config()
    return dataclasses.replace(
        cfg, n_layers=MP_MOE_TRAIN_LAYERS, aux_loss_weight=0.0,
        moe=dataclasses.replace(cfg.moe, capacity_factor=float(
            cfg.moe.n_experts // cfg.moe.top_k)))


def grad_close(label: str, got, want, want32) -> dict:
    """Hold a model-parallel gradient ``got`` against the float32 one
    ``want32`` no further than the single-device bf16 gradient ``want``
    is: mean and RMS distance within 1.25x one device's, the max within
    MP_GRAD_MAX_RATIO times; and ``got`` within twice one device's max
    distance of ``want``, plus one bf16 ulp of ``want``'s largest
    magnitude (two bf16 gradients round the same sum apart by up to an
    ulp). The max is held looser than ``mp_close`` holds a forward's
    logits (1.25x): a gradient leaf's largest error is a few elements'
    rounding, and two correct single-device bf16 paths already lie
    1.253x apart there on the CPU (``grad_spread`` measures it at this
    size on the card; PERF.md, Findings). Returns the distances."""
    import math
    g, w, w32 = got.float(), want.float(), want32.float()
    e_mp, e_sd = (g - w32).abs(), (w - w32).abs()
    top = float(w.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    out = {"max": float(e_mp.max()), "mean": float(e_mp.mean()),
           "rms": float(e_mp.square().mean().sqrt()),
           "sd_max": float(e_sd.max()), "sd_mean": float(e_sd.mean()),
           "sd_rms": float(e_sd.square().mean().sqrt()),
           "vs_sd": float((g - w).abs().max()), "ulp": ulp}
    if out["mean"] > 1.25 * out["sd_mean"] or \
            out["rms"] > 1.25 * out["sd_rms"] or \
            out["max"] > MP_GRAD_MAX_RATIO * out["sd_max"] or \
            out["vs_sd"] > 2 * out["sd_max"] + ulp:
        fail(f"model parallel {label}: mean {out['mean']} rms {out['rms']} "
             f"max {out['max']} from the float32 model, single-device bf16 "
             f"{out['sd_mean']}, {out['sd_rms']} and {out['sd_max']}; "
             f"{out['vs_sd']} from single-device bf16 (one ulp {ulp})")
    return out


def grad_spread(grads_a: dict, grads_b: dict, grads32: dict) -> dict:
    """How far apart two correct single-device bf16 gradient paths lie
    in ``grad_close``'s terms: for each statistic, the largest ratio of
    one path's distance to float32 over the other's (either way round),
    and the largest distance between the two over path a's max distance
    to float32; each with its leaf."""
    out = {}
    for name, w32 in grads32.items():
        a = (grads_a[name].float() - w32.float()).abs()
        b = (grads_b[name].float() - w32.float()).abs()
        if not (float(a.max()) and float(b.max())):
            continue                # a path exact on this leaf: no ratio
        gap = float((grads_a[name].float() - grads_b[name].float()).abs()
                    .max()) / float(a.max())
        for key, fa, fb in (
                ("max", a.max(), b.max()), ("mean", a.mean(), b.mean()),
                ("rms", a.square().mean().sqrt(),
                 b.square().mean().sqrt())):
            r = max(float(fa / fb), float(fb / fa))
            if r > out.get(key, (0.0, ""))[0]:
                out[key] = (r, name)
        if gap > out.get("gap", (0.0, ""))[0]:
            out["gap"] = (gap, name)
    return out


def mp_grads_close(label: str, grads: dict, pol, want: dict) -> dict:
    """``grad_close`` of each held gradient (the rank's reduced share,
    gathered whole) against the single-device bf16 and float32 ones, on
    the card. Returns the distances by name."""
    import torch
    dev = next(iter(grads.values())).device
    out = {}
    for name in want["held"]:
        got = pol.relayout(grads[name], pol.param_rule(name), ())
        out[name] = grad_close(f"{label} gradient {name}", got,
                               want["grads16"][name].to(dev),
                               want["grads32"][name].to(dev))
        del got
    torch.cuda.empty_cache()
    return out


def recording(inner, names, store: dict):
    """An optimizer that hands ``inner`` its gradients and keeps those of
    ``names`` from its first update in ``store``: the reduced gradients a
    train step computed."""
    from repro_torch.train import optimizer as opt_lib

    def update(grads, state, params):
        if not store:
            store.update({n: grads[n].detach().clone() for n in names})
        return inner.update(grads, state, params)
    return opt_lib.Optimizer(inner.init, update)


def deterministic(fn):
    """``fn()`` under deterministic algorithms, as the train phase runs."""
    import torch
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


class CollectiveClock:
    """Host seconds inside the process group's collectives while active:
    ``torch.distributed``'s all_gather, reduce_scatter, all_reduce and
    all_to_all_single (the calls ``dist/collectives.py`` makes) wrapped to
    synchronize the card first, so each call's time is its own
    (host-staged by gloo), not the queued work's before it."""

    NAMES = ("all_gather", "reduce_scatter", "all_reduce",
             "all_to_all_single")

    def __enter__(self):
        import torch
        import torch.distributed as dist
        self.s, self.n, self._saved = 0.0, 0, {}

        def timed(fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self.s += time.perf_counter() - t0
                    self.n += 1
            return run
        for name in self.NAMES:
            self._saved[name] = getattr(dist, name)
            setattr(dist, name, timed(self._saved[name]))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        return False


def mp_compressed(grad, pol) -> dict:
    """``compressed_psum`` over "data" of this rank's unreduced share of a
    gradient: the int32 sum exact against a host replay of the formula on
    every data rank's share, the result within ``n_ranks * s_max / 2`` of
    the float ``psum`` (plus the two float32 roundings of the sums)."""
    import torch
    from repro_torch.dist import collectives as coll
    from repro_torch.train import compression
    got = compression.compressed_psum(grad, pol, "data")
    x = grad.float()
    shares = pol.relayout(x[None], ("data",), ((),)).cpu()    # (dp, ...)
    s_max = (torch.clamp(shares.reshape(shares.shape[0], -1).abs().amax(1),
                         min=1e-12) / torch.tensor(127.0)).max()
    q = torch.clamp(torch.round(shares / s_max), -127, 127).to(torch.int32)
    replay = q.sum(0, dtype=torch.int32).to(torch.float32) * s_max
    n = shares.shape[0]
    dense = coll.psum(x, pol, "data")
    err = float((got - dense).abs().max())
    out = {"cp_numel": grad.numel(), "cp_ranks": n, "cp_s_max": float(s_max),
           "cp_err": err, "cp_bound": n * float(s_max) / 2,
           "cp_exact": bool(torch.equal(got.cpu(), replay))}
    if not out["cp_exact"] or \
            err > out["cp_bound"] + 2.0 ** -22 * float(dense.abs().max()):
        fail(f"model parallel compressed_psum: {out}")
    return out


def mp_train_qwen3(mesh, seed: int, mp_dir: str, dev, wdir: str) -> dict:
    """qwen3-0.6b at full width and depth trained on this rank under the
    train rules (bf16, remat full, chunked attention): one sequence of
    TRAIN_SEQ tokens a data rank, the single-device phase's first ``dp``.
    The loss, the global gradient norm and the held gradients (reduced
    over the replicated axes, gathered) against the single-device ones;
    ``compressed_psum`` over "data" on the rank's share of layer 0's
    ``wq`` gradient where "data" has two ranks; TRAIN_STEPS steps of
    chain(clip 1.0, adamw LM_LR), each loss within LM_LOSS_RTOL of the
    single-device run's and falling by LM_LOSS_DROP; then
    ``mp_train_resume``."""
    import itertools
    import torch
    from repro_torch.configs import base
    from repro_torch.dist import ShardingPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    arch = base.get("qwen3-0.6b")
    cfg = arch.make_config()
    pol = ShardingPolicy(mesh=mesh, rules=cells._lm_rules(arch, "train",
                                                          mesh))
    pol = pol.with_params(tf.param_rules(cfg, pol))
    want = torch.load(mp_file(mp_dir, "train"), mmap=True)
    dp = pol.axis_size("data")
    ref = want[dp] | {"held": want["held"]}
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = tf.init_params(cfg, gen, dev, policy=pol)
    params = dict(model.named_parameters())
    rows = (pol.rules["act_btd"][0], None)
    local = {k: pol.relayout(want[k][:dp].to(dev), (), rows).contiguous()
             for k in ("tokens", "labels")}
    out = {"tr_params": sum(p.numel() for p in params.values()),
           "tr_tokens": int(local["tokens"].numel()),
           "tr_sd": {k: ref[k] for k in ("loss16", "norm16", "loss32",
                                          "norm32", "losses")}}
    ops.reset_launch_counts()

    def grad_check():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CollectiveClock() as clock:
            loss = tf.lm_loss(model, local, pol)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            torch.cuda.synchronize()
        out["tr_grad_s"] = time.perf_counter() - t0
        out["tr_coll_s"], out["tr_coll_n"] = clock.s, clock.n
        if dp > 1:
            out.update(mp_compressed(grads["blocks.0.wq"], pol))
        t0 = time.perf_counter()
        grads = trainer.reduce_grads(grads, pol)
        torch.cuda.synchronize()
        out["tr_reduce_s"] = time.perf_counter() - t0
        out["tr_loss"] = float(loss.detach())
        out["tr_norm"] = float(opt_lib.global_norm(grads, pol))
        out["tr_loss_rel"] = within("model parallel qwen3 loss",
                                    out["tr_loss"], ref["loss16"],
                                    LM_LOSS_RTOL)
        out["tr_norm_rel"] = within("model parallel qwen3 grad norm",
                                    out["tr_norm"], ref["norm16"],
                                    LM_GNORM_RTOL)
        out["tr_grads"] = mp_grads_close("qwen3", grads, pol, ref)

    deterministic(grad_check)
    if dp == 1:
        out.update(mp_step_breakdown(model, local, pol))
    opt = opt_lib.chain(
        opt_lib.clip_by_global_norm(1.0, policy=pol),
        opt_lib.adamw(LM_LR))
    step = trainer.make_train_step(lambda p, b: tf.lm_loss(model, b, pol),
                                   opt, policy=pol)
    run = []
    deterministic(lambda: trainer.train_loop(
        trainer.init_state(params, opt), recorded(step, run),
        itertools.repeat(local), n_steps=TRAIN_STEPS, log_every=10 ** 9,
        log_fn=print, policy=pol))
    out["tr_losses"] = loss_falls("model parallel qwen3", run, LM_LOSS_DROP)
    out["tr_losses_rel"] = [
        within(f"model parallel qwen3 step {i + 1} loss", x, y, LM_LOSS_RTOL)
        for i, (x, y) in enumerate(zip(out["tr_losses"], ref["losses"]))]
    out["tr_step_s"] = [r[2] for r in run]
    out["tr_sd_step_s"] = ref["step_s"]
    out["tr_peak"] = torch.cuda.max_memory_allocated()
    del model, params, step, opt, want
    torch.cuda.empty_cache()
    out.update(mp_train_resume(cfg, pol, seed, local, dev, wdir))
    launched = {k: v for k, v in ops.launch_counts.items() if v}
    if launched:
        fail(f"model parallel training launched kernels: {launched}")
    return out


def mp_step_breakdown(model, local: dict, pol) -> dict:
    """Where a rank's forward + backward of ``lm_loss`` goes. The gradient
    check ran it under deterministic algorithms with every collective
    timed from a device sync (``CollectiveClock``); here it runs again
    with neither, then under deterministic algorithms only, then so once
    more with the mesh's first rank under ``torch.profiler`` (host and
    device activity): its device busy share of the wall, top kernels and
    the host operators with the most self time."""
    import torch
    from repro_torch.dist.policy import shard_rank
    from repro_torch.models import transformer as tf
    params = list(model.parameters())

    def fwd_bwd():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tf.lm_loss(model, local, pol)
        torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"bd_plain_s": fwd_bwd(), "bd_det_s": deterministic(fwd_bwd)}
    if shard_rank(pol) != 0:
        out["bd_prof_s"] = deterministic(fwd_bwd)
        return out
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out["bd_prof_s"] = deterministic(fwd_bwd)
    dev_rows, host_rows = [], []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                dev_rows.append((us / 1e6, ev.count, ev.key))
        elif ev.self_cpu_time_total > 0:
            host_rows.append((ev.self_cpu_time_total / 1e6, ev.count,
                              ev.key))
    out["bd_busy_s"] = sum(r[0] for r in dev_rows)
    out["bd_kernels"] = sorted(dev_rows, reverse=True)[:6]
    out["bd_host_s"] = sum(r[0] for r in host_rows)
    out["bd_host"] = sorted(host_rows, reverse=True)[:10]
    return out


def mp_train_resume(cfg, pol, seed: int, local: dict, dev, wdir: str
                    ) -> dict:
    """The sharded checkpoint: ``cfg`` cut to MP_RESUME_LAYERS at full
    width, TRAIN_STEPS steps uninterrupted, then a run that saves at
    TRAIN_CKPT_AT (whole leaves gathered, the mesh's first rank writing)
    and fails there, restored on every rank from the checkpoint (each
    cutting its shards) and resumed: parameters and losses bit for bit
    the uninterrupted run's."""
    import dataclasses
    import itertools
    import torch
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    cfg = dataclasses.replace(cfg, n_layers=MP_RESUME_LAYERS)
    pol = pol.with_params(tf.param_rules(cfg, pol))
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = tf.init_params(cfg, gen, dev, policy=pol)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = opt_lib.chain(
        opt_lib.clip_by_global_norm(1.0, policy=pol),
        opt_lib.adamw(LM_LR))
    step = trainer.make_train_step(lambda p, b: tf.lm_loss(model, b, pol),
                                   opt, policy=pol)
    loop = dict(n_steps=TRAIN_STEPS, log_every=10 ** 9, log_fn=print,
                policy=pol)

    def from_start():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(start[k])
        return trainer.init_state(params, opt)

    def body():
        run_a, run_b, run_c = [], [], []
        trainer.train_loop(from_start(), recorded(step, run_a),
                           itertools.repeat(local), **loop)
        final = {k: p.detach().clone() for k, p in params.items()}
        ck_dir = os.path.join(wdir, "ckpt")
        t0 = time.perf_counter()
        try:
            trainer.train_loop(from_start(), recorded(step, run_b),
                               itertools.repeat(local), ckpt_dir=ck_dir,
                               ckpt_every=TRAIN_CKPT_AT,
                               fail_at_step=TRAIN_CKPT_AT, **loop)
            fail("model parallel resume: the simulated failure did not "
                 "happen")
        except RuntimeError as e:
            if "simulated worker failure" not in str(e):
                raise
        save_s = time.perf_counter() - t0 - sum(r[2] for r in run_b)
        last = ckpt.latest_step(ck_dir)
        if last != TRAIN_CKPT_AT:
            fail(f"model parallel resume: latest checkpoint {last}")
        state = from_start()
        t0 = time.perf_counter()
        tree, _ = ckpt.restore(ck_dir, last,
                               convert.train_state_to_numpy(state),
                               cut=convert.shard_cut(state, pol))
        convert.train_state_from_jax(tree, state)
        del tree
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        trainer.train_loop(state, recorded(step, run_c),
                           itertools.repeat(local), **loop)
        differ = [k for k, p in params.items()
                  if not torch.equal(p, final[k])]
        losses = [r[0] for r in run_a]
        if differ or [r[0] for r in run_c] != losses[last:]:
            fail(f"model parallel resume: {len(differ)} of {len(params)} "
                 f"parameters differ ({differ[:3]}); losses "
                 f"{[r[0] for r in run_c]} against {losses[last:]}")
        ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(ck_dir) for f in fs)
        return {"rs_layers": cfg.n_layers, "rs_losses": losses,
                "rs_ckpt_gib": ck_bytes / 2 ** 30, "rs_save_s": save_s,
                "rs_restore_s": restore_s,
                "rs_step_s": [r[2] for r in run_a]}

    out = deterministic(body)
    del model, params, start, step, opt
    torch.cuda.empty_cache()
    return out


def mp_train_olmoe(mesh, seed: int, mp_dir: str, dev) -> dict:
    """olmoe-1b-7b's training on this rank: one EP train step of
    ``mp_moe_train_config`` (nothing drops, aux weight 0) on the
    single-device phase's sequence, chain(clip 1.0, adamw LM_LR): its loss,
    gradient norm and held gradients (as the optimizer received them)
    against the single-device model by the rules of ``mp_train_qwen3``."""
    import torch
    from repro_torch.configs import base
    from repro_torch.dist import ShardingPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    cfg = mp_moe_train_config()
    pol = ShardingPolicy(mesh=mesh, rules=cells._lm_rules(
        base.get("olmoe-1b-7b"), "train", mesh))
    pol = pol.with_params(tf.param_rules(cfg, pol))
    want = torch.load(mp_file(mp_dir, "moe_train"), mmap=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    model = tf.init_params(cfg, gen, dev, policy=pol)
    params = dict(model.named_parameters())
    rows = (pol.rules["act_btd"][0], None)
    local = {k: pol.relayout(want[k].to(dev), (), rows).contiguous()
             for k in ("tokens", "labels")}
    got = {}
    opt = recording(opt_lib.chain(
        opt_lib.clip_by_global_norm(1.0, policy=pol),
        opt_lib.adamw(LM_LR)), want["held"], got)
    step = trainer.make_train_step(lambda p, b: tf.lm_loss(model, b, pol),
                                   opt, policy=pol)
    ops.reset_launch_counts()

    def one_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(trainer.init_state(params, opt), local)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        return loss, norm, time.perf_counter() - t0

    loss, norm, step_s = deterministic(one_step)
    out = {"mt_loss": loss, "mt_norm": norm, "mt_step_s": step_s,
           "mt_sd": {k: want[k] for k in ("loss16", "norm16", "loss32",
                                           "norm32")},
           "mt_params": sum(p.numel() for p in params.values()),
           "mt_loss_rel": within("model parallel olmoe EP step loss", loss,
                                 want["loss16"], LM_LOSS_RTOL),
           "mt_norm_rel": within("model parallel olmoe EP step grad norm",
                                 norm, want["norm16"], LM_GNORM_RTOL)}
    out["mt_grads"] = mp_grads_close("olmoe EP step", got, pol, want)
    out["mt_peak"] = torch.cuda.max_memory_allocated()
    launched = {k: v for k, v in ops.launch_counts.items() if v}
    if launched:
        fail(f"model parallel olmoe training launched kernels: {launched}")
    del model, params, step, opt, got, want
    torch.cuda.empty_cache()
    return out


def mp_qwen3(mesh, seed: int, mp_dir: str, dev) -> dict:
    """qwen3-0.6b at full width in bf16 on this rank: TP/SP flash prefill
    of the LM phase's prompts, LM_STEPS greedy split-KV decode
    steps under the decode rules and MP_LONG_STEPS under the long-context
    ones, each fed the single-device phase's tokens; held against its
    answers."""
    import dataclasses
    import torch
    from repro_torch.configs import base
    from repro_torch.dist import ShardingPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    from repro_torch.models import transformer as tf
    arch = base.get("qwen3-0.6b")
    cfg = dataclasses.replace(arch.make_config(), attn_impl="flash",
                              max_seq=LM_PROMPT + LM_STEPS)
    pol = {kind: ShardingPolicy(mesh=mesh, rules=cells._lm_rules(
        arch, "decode" if kind != "prefill" else "prefill", mesh,
        long_ctx=kind == "long_ctx"))
        for kind in ("prefill", "decode", "long_ctx")}
    ppol = pol["prefill"]
    want = torch.load(mp_file(mp_dir, "lm"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, gen, dev, policy=ppol)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.synchronize()
    out = {"lm_init_s": time.perf_counter() - t0,
           "lm_params": sum(p.numel() for p in model.parameters())}
    if not torch.equal(prompts.cpu(), want["prompts"]):
        fail("model parallel qwen3: the seed drew other prompts")
    batch = ppol.rules["act_btd"][0]
    logits_rule = (ppol.rules["logits"][0], ppol.rules["logits"][2])
    tok = ppol.relayout(prompts, (), (batch, None))

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(model, tok, ppol)
    torch.cuda.synchronize()
    out["lm_prefill_s"] = time.perf_counter() - t0
    n = dict(ops.launch_counts)
    out["lm_prefill_launches"] = {k: v for k, v in n.items() if v}
    if (n["flash_attention"] != cfg.n_layers
            or n["flash_attention_wgmma"] != cfg.n_layers
            or any(v for k, v in n.items()
                   if not k.startswith("flash_attention"))):
        fail(f"model parallel qwen3 prefill: launches {n}")
    full = ppol.relayout(logits, logits_rule, ())
    if full.shape != (LM_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(full).all()):
        fail(f"model parallel qwen3: bad prefill logits {tuple(full.shape)}")
    # the LM phase's rule: a flash prefill no further from float32 than
    # 1.25 times the chunked bf16 prefill (flash_rule)
    out["lm_prefill_err"] = mp_close("qwen3 prefill logits", full.cpu(),
                                     want["logits_chunked"],
                                     want["logits32"])
    out["lm_prefill_err"]["sd_flash_max"] = float(
        (want["logits"] - want["logits32"]).abs().max())
    out["lm_prefill_err"]["vs_flash"] = float(
        (full.cpu() - want["logits"]).abs().max())
    # like for like: the flash prefill on one device, within twice its
    # distance to float32 (the LM phase's rule for two bf16 paths)
    if out["lm_prefill_err"]["vs_flash"] > \
            2 * out["lm_prefill_err"]["sd_flash_max"]:
        fail(f"model parallel qwen3 prefill logits: "
             f"{out['lm_prefill_err']['vs_flash']} from the single-device "
             f"flash prefill, more than twice its distance "
             f"{out['lm_prefill_err']['sd_flash_max']} to float32")
    tol = want["tol"]
    out["lm_prefill_ties"] = greedy_ties(want["logits"], full.cpu(), tol)
    first = ppol.relayout(tf.greedy(logits, ppol), (batch,), ())
    if not torch.equal(first, full.argmax(-1)):
        fail("model parallel qwen3: greedy over the vocabulary shards is not "
             "the argmax of the gathered logits")
    layers = list(MP_CACHE_LAYERS)
    cache_err = {}
    for name in ("k", "v"):
        whole = ppol.relayout(cache[name], "kv_cache", ())
        held = whole[layers, :, :, :LM_PROMPT].cpu()
        cache_err[name] = mp_close(f"qwen3 cache {name}", held,
                                   want["cache"][name], want["cache32"][name])
        del whole
    out["lm_cache_err"] = cache_err

    for kind, steps in (("decode", LM_STEPS),
                        ("long_ctx", MP_LONG_STEPS)):
        dpol = pol[kind]
        dbatch = (dpol.rules["act_btd"][0],)
        drule = (dpol.rules["logits"][0], dpol.rules["logits"][2])
        c = tf.relayout_cache(cache, ppol, dpol)
        got, ties = [], 0
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(steps):
            fed = dpol.relayout(want["fed"][step].to(dev), (), dbatch)
            step_logits, c = tf.decode_step(model, c, fed, dpol)
            g = dpol.relayout(tf.greedy(step_logits, dpol), dbatch, ())
            whole = dpol.relayout(step_logits, drule, ())
            if not torch.equal(g, whole.argmax(-1)):
                fail(f"model parallel qwen3 {kind}: greedy over the "
                     f"vocabulary shards is not the argmax")
            got.append(whole.cpu())
            ties += greedy_ties(want["steps"][step], got[-1], tol)
        torch.cuda.synchronize()
        out[f"lm_{kind}_ms"] = (time.perf_counter() - t0) * 1e3 / steps
        launched = {k: v for k, v in ops.launch_counts.items() if v}
        if launched:
            fail(f"model parallel qwen3 {kind}: launched {launched}")
        if c["length"] != LM_PROMPT + steps:
            fail(f"model parallel qwen3 {kind}: cache length {c['length']}")
        out[f"lm_{kind}_err"] = mp_close(
            f"qwen3 {kind} logits", torch.stack(got),
            want["steps"][:steps], want["steps32"][:steps])
        out[f"lm_{kind}_ties"] = ties
        out[f"lm_{kind}_local_seq"] = int(c["k"].shape[3])
        del c
    del model, cache
    torch.cuda.empty_cache()
    return out


def mp_moe_backward(model, i: int, held: dict, pol, me: int) -> dict:
    """EP's backward on layer ``i``'s MoE over this rank's tokens of the
    single-device input, at the config's capacity factor: the objective
    of ``moe_backward_answers`` on the rank's share (the aux through its
    ``pmean``), the router's gradient summed over "model", each gradient
    against the per-shard composition's within MP_EP_GRAD_TOL of its
    largest magnitude (the rank's experts, its input rows), the drops
    exact."""
    import torch
    from repro_torch.models import moe
    from repro_torch.train import trainer
    cfg = model.cfg
    dev = model.embed.device
    blk = model.blocks[i].moe
    x = pol.relayout(held["h"].to(dev), (), "act_btd").clone()
    x.requires_grad_(True)
    cot = pol.relayout(held["cot"].to(dev), (), "act_btd")
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        out, aux = moe.moe_ffn(x, blk, cfg.moe, pol, stats=stats)
        total = (out.float() * cot.float()).sum() \
            + cfg.aux_loss_weight * aux
        grads = torch.autograd.grad(total, [x] + [getattr(blk, n)
                                                  for n in MOE_GRADS])
    got = dict(zip(("x",) + MOE_GRADS, grads))
    got["router"] = trainer.reduce_grads(
        {"router": got["router"]},
        pol.with_params({"router": ()}))["router"]
    torch.cuda.synchronize()
    rec = {"s": time.perf_counter() - t0, "dropped": int(stats["dropped"]),
           "want_dropped": held["drops"][me]}
    want = held["grads"]
    for name, g in got.items():
        w = want[name].to(dev)
        if name == "x":
            w = pol.relayout(w, (), "act_btd")
        elif name != "router":
            w = pol.relayout(w, (), ("model", None, None))
        err = float((g.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        rec[name] = {"max_abs_err": err, "max_abs": top}
        if not err <= MP_EP_GRAD_TOL * top:
            fail(f"model parallel olmoe layer {i} backward: {name} "
                 f"gradient {err} from the per-shard composition's "
                 f"(largest {top}; rule {MP_EP_GRAD_TOL} of it)")
    if rec["dropped"] != rec["want_dropped"]:
        fail(f"model parallel olmoe layer {i} backward: dropped {rec}")
    return rec


def mp_olmoe(mesh, seed: int, mp_dir: str, dev) -> dict:
    """olmoe-1b-7b at full width in bf16 on this rank: the MoE of
    ``moe_check_layers`` by expert parallelism on the rank's
    sequence-parallel tokens of the single-device phase's input to that
    layer, held against the single-device ``_moe_local`` of the same
    tokens (dropped assignments exact, outputs within two bf16 ulps);
    then the EP prefill of the prompts, with each layer's drops."""
    import dataclasses
    import torch
    from repro_torch.configs import base
    from repro_torch.dist import ShardingPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    arch = base.get("olmoe-1b-7b")
    cfg = dataclasses.replace(arch.make_config(), attn_impl="flash",
                              max_seq=LM_PROMPT + LM_STEPS)
    pol = ShardingPolicy(mesh=mesh, rules=cells._lm_rules(arch, "prefill",
                                                          mesh))
    want = torch.load(mp_file(mp_dir, "moe"), mmap=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, gen, dev, policy=pol)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.synchronize()
    out = {"moe_init_s": time.perf_counter() - t0,
           "moe_params": sum(p.numel() for p in model.parameters()),
           "moe_experts": [model.blocks[0].moe.w_in.shape[0],
                           cfg.moe.n_experts]}
    if not torch.equal(prompts.cpu(), want["prompts"]):
        fail("model parallel olmoe: the seed drew other prompts")
    me = pol.axis_index("model")
    out["moe_layers"] = {}
    for i, held in want["layers"].items():
        x = pol.relayout(held["h"].to(dev), (), "act_btd")
        stats = {}
        with torch.no_grad():
            got, _ = moe.moe_ffn(x, model.blocks[i].moe, cfg.moe, pol,
                                 stats=stats)
        got = got.reshape(-1, got.shape[-1]).float().cpu()
        ref_out = held["outs"][me].float()
        err = (got - ref_out).abs()
        bad = int((err > 2.0 ** -6 * ref_out.abs() + 1e-3).sum())
        rec = {"max_abs_err": float(err.max()), "bad": bad,
               "dropped": int(stats["dropped"]),
               "want_dropped": held["drops"][me],
               "assigned": stats["assigned"], "capacity": stats["capacity"]}
        out["moe_layers"][str(i)] = rec
        if rec["dropped"] != rec["want_dropped"] or bad:
            fail(f"model parallel olmoe layer {i}: {rec}")
        if "grads" in held:
            out["moe_backward"] = deterministic(lambda: mp_moe_backward(
                model, i, held, pol, me))

    routes = RouteRecorder(model)
    routes.mark("prefill")
    tok = pol.relayout(prompts, (), (pol.rules["act_btd"][0], None))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(model, tok, pol)
    torch.cuda.synchronize()
    out["moe_prefill_s"] = time.perf_counter() - t0
    routes.mark("done")
    n = dict(ops.launch_counts)
    out["moe_prefill_launches"] = {k: v for k, v in n.items() if v}
    if (n["flash_attention"] != cfg.n_layers
            or n["flash_attention_wgmma"] != cfg.n_layers
            or any(v for k, v in n.items()
                   if not k.startswith("flash_attention"))):
        fail(f"model parallel olmoe prefill: launches {n}")
    out["moe_drops"] = [(i, int(d), a) for i, d, a in routes.drops["prefill"]]
    routes.remove()
    full = pol.relayout(logits, (pol.rules["logits"][0],
                                 pol.rules["logits"][2]), ())
    if full.shape != (LM_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(full).all()):
        fail(f"model parallel olmoe: bad prefill logits {tuple(full.shape)}")
    out["moe_cache_local"] = list(cache["k"].shape)
    del model, cache, logits
    torch.cuda.empty_cache()
    return out


def mp_two_tower(mesh, seed: int, mp_dir: str, dev) -> dict:
    """Two-tower retrieval on this rank with both tables row-sharded over
    "model", weights from the recsys phase's seeded draw: the item tower
    on the first candidates' features bitwise the recsys phase's vectors,
    then its 64 sketch requests by ``sah_retrieve_step`` over the
    1,000,000 candidates: user vectors bitwise the single-device tower's,
    ids and values bitwise the single-device composition of the sharded
    scan; one ``srp_hash`` and one dense ``hamming_scores`` a request."""
    import torch
    from repro_torch.configs import base
    from repro_torch.dist import ShardingPolicy, lm_rules
    from repro_torch.dist.policy import shard_rank
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import recsys as rec
    pol = ShardingPolicy(mesh=mesh, rules=lm_rules(("data",), "model"))
    cfg = base.get("two-tower-retrieval").make_config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    with torch.no_grad():
        model = rec.shard_tables(rec.init_twotower_params(gen, cfg,
                                                          device=dev), pol)
    torch.cuda.empty_cache()
    want = torch.load(mp_file(mp_dir, "retrieval"))
    # the rank's equal slice of the candidates, in mesh order
    per = want["cand"].shape[0] // pol.device_count
    mine = slice(shard_rank(pol) * per, (shard_rank(pol) + 1) * per)
    cand, codes = want["cand"][mine].to(dev), want["codes"][mine].to(dev)
    proj, users = want["proj"].to(dev), want["users"].to(dev)
    torch.cuda.synchronize()
    out = {"tt_setup_s": time.perf_counter() - t0,
           "tt_table_rows": model.user_table.shape[0],
           "tt_candidates": want["cand"].shape[0]}
    with torch.no_grad():
        head = rec.item_tower(model, want["items_head"].to(dev), cfg, pol)
        if not torch.equal(head.cpu(), want["cand"][:head.shape[0]]):
            fail("model parallel two-tower: the item tower over the sharded "
                 "item table differs from the single-device one")
        u = torch.cat([rec.user_tower(model, users[i:i + 1], cfg, pol)
                       for i in range(users.shape[0])])
    if not torch.equal(u.cpu(), want["u"]):
        fail("model parallel two-tower: user vectors differ from the "
             "single-device tower's")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, ids = [], []
    for i in range(users.shape[0]):
        v, d = serve.sah_retrieve_step(model, users[i:i + 1], cand, codes,
                                       proj, cfg, pol, n_cand=RETR_N_CAND,
                                       k=RETR_K)
        vals.append(v)
        ids.append(d)
    torch.cuda.synchronize()
    out["tt_ms"] = (time.perf_counter() - t0) * 1e3 / users.shape[0]
    n = {k: v for k, v in ops.launch_counts.items() if v}
    out["tt_launches"] = n
    r = users.shape[0]
    if n != {"srp_hash": r, "hamming_scores": r}:
        fail(f"model parallel two-tower: launches {n}")
    cv, ci = want["composed"][mesh.size()]
    got_v, got_i = torch.stack(vals).cpu(), torch.stack(ids).cpu()
    if not (torch.equal(got_i, ci) and torch.equal(got_v, cv)):
        fail(f"model parallel two-tower: {int((got_i != ci).sum())} ids "
             f"differ from the single-device composition")
    out["tt_same_as_one_device"] = int(
        (got_i == want["sketch_ids"]).all(1).sum())
    del model, cand, codes
    torch.cuda.empty_cache()
    return out


def mp_rank(rank: int, workdir: str, shape: tuple, seed: int,
            mp_dir: str, cells: bool = False) -> None:
    """One rank of a model-parallel world (``spawn_worlds``): gloo over
    CUDA tensors, every rank on cuda:0, a ("data", "model")
    ``DeviceMesh`` of ``shape``. With ``cells``, runs the cells under a
    mesh (``mp_cells``) alone. Otherwise runs qwen3-0.6b (TP/SP prefill,
    split-KV decode), olmoe-1b-7b's expert parallelism (on MP_MOE_WORLD;
    layer 0's backward too) and two-tower retrieval over row-sharded
    tables, then the training: qwen3-0.6b's train step, steps and
    sharded-checkpoint resume (``mp_train_qwen3``; ``compressed_psum``
    where "data" has two ranks) and olmoe's EP train step (on
    MP_MOE_WORLD), each held against the answers the single-device phases
    saved in ``mp_dir``; writes what it saw to ``rank<r>.json`` in
    ``workdir``. A mismatch raises, and ``spawn_worlds`` fails the
    smoke."""
    import datetime
    import math
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=math.prod(shape),
        timeout=datetime.timedelta(seconds=MP_TIMEOUT))
    try:
        mesh = init_device_mesh("cuda", shape,
                                mesh_dim_names=("data", "model"))
        dev = torch.device("cuda", 0)
        out = {"rank": rank, "coord": mesh.get_coordinate()}
        serving = () if cells else (mp_qwen3, mp_olmoe, mp_two_tower)
        training = () if cells else ((mp_train_qwen3, (workdir,)),
                                     (mp_train_olmoe, ()))
        for part in serving:
            if part is mp_olmoe and tuple(shape) != MP_MOE_WORLD:
                continue
            dist.barrier()
            t0 = time.perf_counter()
            out.update(part(mesh, seed, mp_dir, dev))
            out[f"{part.__name__}_s"] = time.perf_counter() - t0
        # training, after the serving checks, in the same world
        for part, args in training:
            if part is mp_train_olmoe and tuple(shape) != MP_MOE_WORLD:
                continue
            dist.barrier()
            t0 = time.perf_counter()
            out.update(part(mesh, seed, mp_dir, dev, *args))
            out[f"{part.__name__}_s"] = time.perf_counter() - t0
        if cells:
            t0 = time.perf_counter()
            out.update(mp_cells(mesh, seed, mp_dir, dev))
            out["mp_cells_s"] = time.perf_counter() - t0
        out["peak"] = torch.cuda.max_memory_allocated()
        out["reserved"] = torch.cuda.max_memory_reserved()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


# -- the cells under a mesh (run in a (1, 2) world of their own) ------------

MC_WORLD = (1, 2)        # the shape of the mesh cells' world
ZERO1_CUT = {"n_layers": 8, "global_batch": 2}   # qwen3_zero1 on 2 ranks
ZERO1_STEPS = 2
ZERO1_HELD = ("blocks.0.wq", "blocks.0.w_out", "blocks.0.ln1",
              "blocks.7.w_in", "final_norm", "head")
GAT_MESH_CUT = {"n_edges": 1 << 23}   # ogb_products: two ranks share a card
GAT_MESH_RTOL = 1e-4     # PERF.md section 2's GAT rule
MC_PREFILL_CUT = {"global_batch": 1, "seq_len": 8192}
# (label, the command's module and arguments, the record it writes)
MC_DRYRUNS = (("qwen3_zero1", ("repro_torch.launch.perf", "--variant",
                               "qwen3_zero1"), "qwen3_zero1.json"),
              ("gat_dstpart", ("repro_torch.launch.perf", "--variant",
                               "gat_dstpart"), "gat_dstpart.json"),
              ("dbrx-132b train_4k", ("repro_torch.launch.dryrun", "--arch",
                                      "dbrx-132b", "--shape", "train_4k",
                                      "--mesh", "single"),
               "dbrx-132b__train_4k__single.json"))
MC_DRYRUN_TIMEOUT = 600
REPAIR_LAYERS = 2        # the bf16 repair's olmoe-1b-7b, cut from 16


def bf16_repair(seed: int, dev) -> dict:
    """The bf16 gradients' repair on the card: olmoe-1b-7b at full width
    cut to REPAIR_LAYERS layers, one Zipf sequence of TRAIN_SEQ tokens,
    ``lm_loss``'s gradient norm with deterministic algorithms off and on
    and from the float32 copy; each pair within LM_GNORM_RTOL (a gather
    of a frequent token's rows, added in bf16 by CUDA's nondeterministic
    atomics, once put the norm 14% below float32's). The control, printed
    and not held: the same sequence through plain indexing's backward
    (``embed[tokens]`` and ``head.index_select``, as before the repair)
    without deterministic algorithms, against float32."""
    import dataclasses
    import torch
    from repro_torch.configs import base
    from repro_torch.data import synthetic
    from repro_torch.models import embedding as emb_lib
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_lib
    cfg = dataclasses.replace(base.get("olmoe-1b-7b").make_config(),
                              n_layers=REPAIR_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = tf.init_params(cfg, gen, dev)
    batch = next(synthetic.lm_token_batches(gen, 1, TRAIN_SEQ, cfg.vocab))

    def norm(m):
        loss = tf.lm_loss(m, batch)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        return float(opt_lib.global_norm(dict(enumerate(grads))))

    out = {"off": norm(model), "on": deterministic(lambda: norm(model))}
    repaired = emb_lib.gather_rows
    emb_lib.gather_rows = lambda t, i, dim=0: (t[i] if dim == 0
                                               else t.index_select(dim, i))
    try:
        out["plain_off"] = norm(model)
    finally:
        emb_lib.gather_rows = repaired
    out["f32"] = norm(float32_copy(model))
    out["plain_off_f32"] = abs(out["plain_off"] - out["f32"]) / abs(
        out["f32"])
    out["off_on"] = within("bf16 repair: norm without against with "
                           "deterministic algorithms", out["off"], out["on"],
                           LM_GNORM_RTOL)
    out["off_f32"] = within("bf16 repair: norm without deterministic "
                            "algorithms against float32", out["off"],
                            out["f32"], LM_GNORM_RTOL)
    out["on_f32"] = within("bf16 repair: norm with deterministic "
                           "algorithms against float32", out["on"],
                           out["f32"], LM_GNORM_RTOL)
    top = int(batch["tokens"].flatten().bincount().max())
    print(f"bf16 repair: olmoe-1b-7b at {REPAIR_LAYERS} layers, full width, "
          f"one Zipf sequence of {TRAIN_SEQ} tokens (the most frequent "
          f"token {top} times): gradient norm {out['off']!r} without "
          f"deterministic algorithms, {out['on']!r} with them (rel "
          f"{out['off_on']:.3g}), float32 {out['f32']!r} (rel "
          f"{out['off_f32']:.3g} and {out['on_f32']:.3g}; rule "
          f"{LM_GNORM_RTOL}); control, plain indexing's backward without "
          f"deterministic algorithms: {out['plain_off']!r} (rel "
          f"{out['plain_off_f32']:.3g} to float32, "
          f"{'outside' if out['plain_off_f32'] > LM_GNORM_RTOL else 'within'}"
          f" the rule)")
    del model
    torch.cuda.empty_cache()
    return out


def zero1_answers(mp_dir: str, seed: int, dev) -> None:
    """What the mesh cells' ``qwen3_zero1`` is held against: one device's
    unsharded ``train_4k`` cell (the same cut and seed: the same weights
    and sequences) and a float32 copy through the same cell step, each
    ZERO1_STEPS steps: losses, norms, and the held parameters and their
    Adafactor state after the steps."""
    import torch
    from repro_torch.launch import cells
    cell = cells.build_cell("qwen3-0.6b", "train_4k", ZERO1_CUT)
    model, state, batch = cells.materialize(
        cell, dev, torch.Generator(device=dev).manual_seed(seed))
    model32 = float32_copy(model)
    opt = cells.default_optimizer("lm")
    state32 = cells.init_state(dict(model32.named_parameters()), opt)
    out = {"bf16": [], "f32": []}
    for _ in range(ZERO1_STEPS):
        state, m = cell.step(model, state, batch)
        state32, m32 = cell.step(model32, state32, batch)
        out["bf16"].append((float(m["loss"]), float(m["grad_norm"])))
        out["f32"].append((float(m32["loss"]), float(m32["grad_norm"])))
    for tag, mod, st in (("16", model, state), ("32", model32, state32)):
        params = dict(mod.named_parameters())
        ada = st.opt_state[1]
        out[f"p{tag}"] = {k: params[k].detach().cpu() for k in ZERO1_HELD}
        out[f"m{tag}"] = {k: ada["m"][k].cpu() for k in ZERO1_HELD}
        out[f"v{tag}"] = {k: {n: t.cpu() for n, t in ada["v"][k].items()}
                          for k in ZERO1_HELD}
    torch.save(out, mp_file(mp_dir, "zero1"))
    print(f"mesh cells: saved qwen3_zero1's one-device answers ("
          f"{ZERO1_CUT}, {ZERO1_STEPS} steps): losses and norms "
          f"{[tuple(round(x, 5) for x in r) for r in out['bf16']]}, float32 "
          f"{[tuple(round(x, 5) for x in r) for r in out['f32']]}")
    del model, model32, state, state32
    torch.cuda.empty_cache()


def mc_zero1(mesh, seed: int, mp_dir: str, dev) -> dict:
    """(a) ``qwen3_zero1``: the mesh cell's two steps against
    ``zero1_answers``."""
    import torch
    from repro_torch.launch import cells
    from repro_torch.train import optimizer as opt_lib
    cell = cells.build_cell("qwen3-0.6b", "train_4k", ZERO1_CUT, mesh=mesh,
                            variant="zero1")
    pol = cell.policy
    model, state, batch = cells.materialize(
        cell, dev, torch.Generator(device=dev).manual_seed(seed))
    want = torch.load(mp_file(mp_dir, "zero1"))
    seen = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZERO1_STEPS):
        state, m = cell.step(model, state, batch)
        seen.append((float(m["loss"]), float(m["grad_norm"])))
    out = {"z1_s": time.perf_counter() - t0, "z1_seen": seen,
           "z1_want": want["bf16"], "z1_tokens": int(batch["tokens"].numel())}
    for i, ((loss, norm), (wl, wn)) in enumerate(zip(seen, want["bf16"])):
        within(f"mesh cells qwen3_zero1 step {i + 1} loss", loss, wl,
               LM_LOSS_RTOL)
        within(f"mesh cells qwen3_zero1 step {i + 1} grad norm", norm, wn,
               LM_GNORM_RTOL)
    params = dict(model.named_parameters())
    ada = state.opt_state[1]
    errs, shards = {}, {}

    def cut(t):
        return pol.relayout(t.to(dev), (), opt_lib.zero1_rule(
            tuple(t.shape), pol))

    for k in ZERO1_HELD:
        errs[f"param {k}"] = grad_close(f"zero1 parameter {k}",
                                        params[k].detach(),
                                        want["p16"][k].to(dev),
                                        want["p32"][k].to(dev))
        leaves = {"m": (ada["m"][k], want["m16"][k], want["m32"][k])}
        leaves.update({f"v.{n}": (t, want["v16"][k][n], want["v32"][k][n])
                       for n, t in ada["v"][k].items()})
        for n, (got, w16, w32) in leaves.items():
            w16, w32 = cut(w16), cut(w32)
            if got.shape != w16.shape:
                fail(f"mesh cells qwen3_zero1: {k} {n} shard {tuple(got.shape)}"
                     f", the cut of one device's {tuple(w16.shape)}")
            shards[f"{k} {n}"] = [tuple(got.shape), tuple(w32.shape)]
            errs[f"{k} {n}"] = grad_close(f"zero1 state {k} {n}", got, w16,
                                          w32)
    whole = sum(int(t.numel()) * t.element_size()
                for t in cells.init_state(dict(cells.tf_lib.LM(
                    model.cfg, "meta").named_parameters()),
                    cells.default_optimizer("lm")).opt_state[1]["m"].values())
    out.update({"z1_errs": errs, "z1_shards": shards,
                "z1_m_bytes": sum(int(t.numel()) * t.element_size()
                                  for t in ada["m"].values()),
                "z1_m_whole_bytes": whole,
                "z1_peak": torch.cuda.max_memory_allocated()})
    del model, state, params
    torch.cuda.empty_cache()
    return out


def mc_gat(mesh, seed: int, dev) -> dict:
    """(b) gat-cora ``ogb_products`` (GAT_MESH_CUT), each aggregation: one
    step of the mesh cell against one device's cell on the same graph."""
    import torch
    from repro_torch.launch import cells
    out = {}
    for variant in ("", "dst_partitioned"):
        runs = []
        for m in (None, mesh):
            cell = cells.build_cell("gat-cora", "ogb_products", GAT_MESH_CUT,
                                    mesh=m, variant=variant)
            args = cells.materialize(
                cell, dev, torch.Generator(device=dev).manual_seed(seed))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, met = cell.step(*args)
            runs.append((float(met["loss"]), float(met["grad_norm"]),
                         time.perf_counter() - t0,
                         int(args[2]["src"].shape[0])))
            del args, cell
            torch.cuda.empty_cache()
        tag = variant or "allreduce"
        (l1, n1, s1, e1), (l2, n2, s2, e2) = runs
        out[f"gat_{tag}"] = {
            "loss": l2, "norm": n2, "loss1": l1, "norm1": n1, "s": s2,
            "s1": s1, "edges": e2, "edges1": e1,
            "loss_rel": within(f"mesh cells gat {tag} loss", l2, l1,
                               GAT_MESH_RTOL),
            "norm_rel": within(f"mesh cells gat {tag} grad norm", n2, n1,
                               GAT_MESH_RTOL)}
    return out


def mc_sah(mesh, seed: int, dev) -> dict:
    """(c) the SAH retrieval cell over ``cells.CAND_PAD`` candidates: its
    ids and values bitwise the single-device composition of the sharded
    scan, from the same draws (the cell's ``materialize``, redrawn
    whole)."""
    import torch
    from repro_torch.configs import base
    from repro_torch.engine import sharding
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import cells, serve
    from repro_torch.models import recsys as rec
    cell = serve.build_sah_retrieval_cell(mesh=mesh)
    pol = cell.policy
    args = cells.materialize(cell, dev,
                             torch.Generator(device=dev).manual_seed(seed))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, ids = cell.step(*args)
    torch.cuda.synchronize()
    out = {"sah_ms": (time.perf_counter() - t0) * 1e3,
           "sah_launches": {k: v for k, v in ops.launch_counts.items() if v},
           "sah_rows": int(args[2].shape[0])}
    for name in ("srp_hash", "hamming_scores"):
        if out["sah_launches"].get(name, 0) < 1:
            fail(f"mesh cells SAH retrieval: {name} was not launched "
                 f"({out['sah_launches']})")
    del args
    # the same draws whole, in the cell's order, then the composition
    cfg = base.get("two-tower-retrieval").make_config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        model = rec.init_twotower_params(gen, cfg, device=dev,
                                         table_pad=pol.model_axis_size)
        feats = cells._fields(gen, cfg.user_embedding.vocab_sizes, 1, dev)
        cand = torch.randn(cells.CAND_PAD, cfg.out_dim, generator=gen,
                           device=dev)
        s = int(torch.randint(2 ** 62, (1,), generator=gen, device=dev))
        codes, proj = serve.build_candidate_index(
            cand, torch.Generator().manual_seed(s), device=dev)
        u = rec.user_tower(model, feats, cfg)
        qcode = ops.srp_hash(u, proj)
        n, per = cand.shape[0], cand.shape[0] // pol.device_count
        parts = [sharding.kmips_flat_arrays(
            cand[i:i + per], torch.arange(i, i + per, dtype=torch.int32,
                                          device=dev),
            torch.ones(per, dtype=torch.bool, device=dev), codes[i:i + per],
            qcode, u, cells.N_RETRIEVE, n_cand=512)
            for i in range(0, n, per)]
        best, pos = ref.topk_stable(torch.cat([v for v, _ in parts], 1),
                                    cells.N_RETRIEVE)
        want_ids = torch.cat([i for _, i in parts], 1).gather(1, pos)[0]
    if not (torch.equal(ids, want_ids) and torch.equal(vals, best[0])):
        fail(f"mesh cells SAH retrieval: {int((ids != want_ids).sum())} ids "
             f"differ from the single-device composition")
    del model, cand, codes
    torch.cuda.empty_cache()
    return out


def mc_prefill(mesh, seed: int, dev) -> dict:
    """(d) qwen3-0.6b ``prefill_32k`` (MC_PREFILL_CUT) at TP-2: the mesh
    cell (flash on the rank's heads) against one device's cell on the same
    weights and prompt, and its float32 copy, by ``mp_close``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    cell = cells.build_cell("qwen3-0.6b", "prefill_32k", MC_PREFILL_CUT,
                            mesh=mesh)
    pol = cell.policy
    args = cells.materialize(cell, dev,
                             torch.Generator(device=dev).manual_seed(seed))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = cell.step(*args)
    torch.cuda.synchronize()
    out = {"pf_ms": (time.perf_counter() - t0) * 1e3,
           "pf_launches": {k: v for k, v in ops.launch_counts.items() if v}}
    if out["pf_launches"].get("flash_attention", 0) < 1:
        fail(f"mesh cells prefill: flash_attention was not launched "
             f"({out['pf_launches']})")
    got = pol.relayout(logits, (pol.rules["logits"][0],
                                pol.rules["logits"][2]), ())
    del args, logits
    one = cells.build_cell("qwen3-0.6b", "prefill_32k", MC_PREFILL_CUT)
    model, tokens = cells.materialize(
        one, dev, torch.Generator(device=dev).manual_seed(seed))
    want = one.step(model, tokens)[0]
    with torch.no_grad():
        from repro_torch.models import transformer as tf
        want32 = tf.prefill(float32_copy(model), tokens)[0]
    out["pf_err"] = mp_close("cells prefill", got, want, want32)
    del model
    torch.cuda.empty_cache()
    return out


def mp_cells(mesh, seed: int, mp_dir: str, dev) -> dict:
    """The mesh cells (a)-(d) on this rank (module docstring)."""
    import torch.distributed as dist
    out = {}
    for part, args in ((mc_zero1, (mp_dir,)), (mc_gat, ()), (mc_sah, ()),
                       (mc_prefill, ())):
        dist.barrier()
        t0 = time.perf_counter()
        out.update(part(mesh, seed, *args, dev) if args
                   else part(mesh, seed, dev))
        out[f"{part.__name__}_s"] = time.perf_counter() - t0
    return out


def start_mesh_dryruns(out_dir: str) -> dict:
    """(e) the mesh dry runs (``MC_DRYRUNS``), started in the background
    on the host (meta tensors, no card): {label: Popen}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return {label: (subprocess.Popen(
        [sys.executable, "-m", *cmd, "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT)), name) for label, cmd, name in MC_DRYRUNS}


def finish_mesh_dryruns(procs: dict, out_dir: str) -> dict:
    """Wait for the mesh dry runs (killing any past MC_DRYRUN_TIMEOUT) and
    print each one's per-device bytes; a failure fails the smoke."""
    t_end = time.perf_counter() + MC_DRYRUN_TIMEOUT
    recs = {}
    for label, (proc, name) in procs.items():
        try:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for p, _ in procs.values():
                p.kill()
                p.communicate()
            fail(f"mesh dry run {label}: not done in {MC_DRYRUN_TIMEOUT} s")
        if proc.returncode:
            fail(f"mesh dry run {label} failed:\n{stdout}{stderr}")
        with open(os.path.join(out_dir, name)) as fh:
            rec = json.load(fh)
        mem = rec.get("memory_per_device",
                      rec.get("memory", {}).get("per_device_total"))
        roof = rec["roofline"]
        recs[label] = {"bytes": mem, "fits": rec["fits_one_h100"],
                       "coll": roof["coll_bytes_per_dev"],
                       "collective_s": roof["collective_s"],
                       "compute_s": roof["compute_s"]}
        print(f"  mesh cells (e) dry run {label}, one rank of the 16x16 mesh "
              f"on the meta device: {mem:,} bytes a device "
              f"({mem / 2**30:.2f} GiB, fits one H100: "
              f"{rec['fits_one_h100']}); collective bytes a device "
              f"{roof['coll_bytes_per_dev']}; compute "
              f"{roof['compute_s'] * 1e3:.2f} ms, collective "
              f"{roof['collective_s'] * 1e3:.2f} ms")
    return recs


def worst_grad(errs: dict) -> str:
    """The held gradients' distances to float32 against one device's
    bf16 ones: the worst ratio of each statistic (``grad_close``'s
    records), how many maxima lie past 1.25x (the rule of the
    model-parallel serving checks), the worst distance to one device's
    gradient over one device's max distance, and the rule."""
    parts = []
    for key in ("mean", "rms", "max"):
        name = max(errs, key=lambda n: errs[n][key] / errs[n][f"sd_{key}"])
        parts.append(f"{key} {errs[name][key] / errs[name][f'sd_{key}']:.3f}x"
                     f" ({name})")
    over = sum(e["max"] > 1.25 * e["sd_max"] for e in errs.values())
    name = max(errs, key=lambda n: errs[n]["vs_sd"] / errs[n]["sd_max"])
    e = errs[name]
    return (f"{len(errs)} gradients, worst against one device " + ", ".join(
        parts) + f"; {over} maxima past 1.25x; from one device's gradient "
        f"up to {e['vs_sd'] / e['sd_max']:.3f}x its max distance ({name}, "
        f"one ulp {e['ulp'] / e['sd_max']:.3f}x) (rule: mean and rms "
        f"1.25x, max {MP_GRAD_MAX_RATIO}x, from one device 2x + one ulp)")


def mp_train_lines(shape, ranks: list, each) -> None:
    """The model-parallel phase's training lines of one world."""
    lead = ranks[0]
    sd = lead["tr_sd"]
    share = ", ".join(f"{r['tr_coll_s'] / r['tr_grad_s']:.1%}" for r in ranks)
    print(f"  mp world={shape} qwen3-0.6b training (train rules, bf16, "
          f"remat full, chunked attention; {lead['tr_tokens']:,} tokens a "
          f"rank, one sequence a data rank; {lead['tr_params']:,} "
          f"parameters a rank): loss {lead['tr_loss']!r} (one device "
          f"{sd['loss16']!r}, rel {lead['tr_loss_rel']:.3g} <= "
          f"{LM_LOSS_RTOL}; float32 {sd['loss32']!r}), grad norm "
          f"{lead['tr_norm']!r} (one device {sd['norm16']!r}, rel "
          f"{lead['tr_norm_rel']:.3g} <= {LM_GNORM_RTOL}); forward + "
          f"backward {each('tr_grad_s')} s a rank, of which "
          f"{each('tr_coll_s')} s, a share of {share}, "
          f"in {lead['tr_coll_n']} host-staged collectives (each timed "
          f"from a device sync), gradient reduction {each('tr_reduce_s')} "
          f"s; {worst_grad(lead['tr_grads'])}; {TRAIN_STEPS} steps of "
          f"chain(clip 1.0, adamw "
          f"{LM_LR}): losses {[round(x, 5) for x in lead['tr_losses']]} "
          f"(one device {[round(x, 5) for x in sd['losses']]}), step s "
          f"{[round(x, 2) for x in lead['tr_step_s']]} (one device "
          f"{[round(x, 2) for x in lead['tr_sd_step_s']]}); peak "
          f"{[round(r['tr_peak'] / 2**30, 2) for r in ranks]} GiB a rank")
    if "bd_plain_s" in lead:
        print(f"  mp world={shape} qwen3-0.6b forward + backward again: "
              f"{each('bd_plain_s')} s a rank with no collective timed and "
              f"deterministic algorithms off, {each('bd_det_s')} s with "
              f"them on; profiled on rank 0 (deterministic, profiler on): "
              f"wall {lead['bd_prof_s']:.3f} s, its kernels busy "
              f"{lead['bd_busy_s']:.3f} s = "
              f"{lead['bd_busy_s'] / lead['bd_prof_s']:.1%}, host operators' "
              f"self time {lead['bd_host_s']:.3f} s")
        for sec, count, key in lead["bd_kernels"]:
            print(f"      device {sec * 1e3:9.2f} ms {count:7d} x  {key[:80]}")
        for sec, count, key in lead["bd_host"]:
            print(f"      host   {sec * 1e3:9.2f} ms {count:7d} x  {key[:80]}")
    if "cp_exact" in lead:
        print(f"  mp world={shape} compressed_psum over \"data\" of layer "
              f"0's wq gradient shares ({lead['cp_numel']:,} values a rank, "
              f"{lead['cp_ranks']} ranks): int32 sums equal the host replay "
              f"on every rank, max error {each('cp_err', 6)} against the "
              f"float psum (bound n * s_max / 2: {each('cp_bound', 6)})")
    print(f"  mp world={shape} sharded checkpoint at {lead['rs_layers']} "
          f"layers, full width: crashed at step {TRAIN_CKPT_AT}, "
          f"{lead['rs_ckpt_gib']:.2f} GiB of whole leaves written by one "
          f"rank (saved in {each('rs_save_s')} s, restored by every rank "
          f"in {each('rs_restore_s')} s), resumed bit for bit equal to the "
          f"uninterrupted run (losses "
          f"{[round(x, 5) for x in lead['rs_losses']]})")
    if "mt_loss" in lead:
        sd = lead["mt_sd"]
        back = lead["moe_backward"]
        print(f"  mp world={shape} olmoe-1b-7b layer 0 EP backward at "
              f"capacity factor 1.25 ({back['s']:.3f} s a rank): dropped "
              f"{[r['moe_backward']['dropped'] for r in ranks]} = the "
              f"per-shard composition's; gradients' max abs error against "
              f"it (their largest) "
              + ", ".join(f"{n} {back[n]['max_abs_err']:.4g} "
                          f"({back[n]['max_abs']:.4g})"
                          for n in ("x",) + MOE_GRADS)
              + f" (rule {MP_EP_GRAD_TOL} of the largest); EP train step "
              f"at {MP_MOE_TRAIN_LAYERS} layers, full width, nothing "
              f"dropped ({lead['mt_params']:,} parameters a rank): loss "
              f"{lead['mt_loss']!r} (one device {sd['loss16']!r}, rel "
              f"{lead['mt_loss_rel']:.3g}), grad norm {lead['mt_norm']!r} "
              f"(one device {sd['norm16']!r}, rel {lead['mt_norm_rel']:.3g})"
              f", {worst_grad(lead['mt_grads'])}; step "
              f"{each('mt_step_s')} s a rank, peak "
              f"{[round(r['mt_peak'] / 2**30, 2) for r in ranks]} GiB")


def rank_values(ranks: list):
    """``each(key, nd=3)``: ``key`` of every rank's record, a float
    rounded to ``nd`` places."""
    def each(key, nd=3):
        return [round(r[key], nd) if isinstance(r[key], float)
                else r[key] for r in ranks]
    return each


def mc_lines(shape, ranks: list, wall: float) -> None:
    """The mesh cells' lines of their world (a)-(d): its ranks' records
    (``mp_rank`` with ``cells``) and its wall seconds beside the other
    worlds."""
    each = rank_values(ranks)
    lead = ranks[0]
    print(f"mesh cells world={shape} (\"data\", \"model\"): backend gloo, "
          f"{len(ranks)} ranks on cuda:0, {wall:.1f} s in all ({MP_LABEL}); "
          f"peak device memory a rank "
          f"{[round(r['peak'] / GIB, 2) for r in ranks]} GiB")
    worst = max(lead["z1_errs"], key=lambda n: lead["z1_errs"][n]["max"]
                / max(lead["z1_errs"][n]["sd_max"], 1e-30))
    e = lead["z1_errs"][worst]
    print(f"  mesh cells world={shape} (a) qwen3_zero1 ({ZERO1_CUT}, "
          f"{lead['z1_tokens']:,} tokens a rank, ZeRO-1 over "
          f"{len(ranks)} ranks): {ZERO1_STEPS} steps' loss and grad norm "
          f"{[tuple(round(x, 5) for x in r) for r in lead['z1_seen']]} "
          f"(one device {[tuple(round(x, 5) for x in r) for r in lead['z1_want']]}"
          f"; rules {LM_LOSS_RTOL}, {LM_GNORM_RTOL}); {len(lead['z1_errs'])} "
          f"held parameters and state shards by grad_close, the worst max "
          f"{e['max'] / max(e['sd_max'], 1e-30):.3f}x one device's ({worst}); "
          f"shards {lead['z1_shards']}; Adafactor momentum a rank "
          f"{lead['z1_m_bytes']:,} bytes of {lead['z1_m_whole_bytes']:,}; "
          f"steps {each('z1_s', 2)} s a rank, peak "
          f"{[round(r['z1_peak'] / 2**30, 2) for r in ranks]} GiB")
    for tag in ("allreduce", "dst_partitioned"):
        g = lead[f"gat_{tag}"]
        print(f"  mesh cells world={shape} (b) gat-cora ogb_products "
              f"{tag} ({g['edges']:,} edges a rank of {g['edges1']:,}): "
              f"loss {g['loss']!r} (one device {g['loss1']!r}, rel "
              f"{g['loss_rel']:.3g}), grad norm {g['norm']!r} (one device "
              f"{g['norm1']!r}, rel {g['norm_rel']:.3g}; rule "
              f"{GAT_MESH_RTOL}); step {[round(r[f'gat_{tag}']['s'], 3) for r in ranks]} "
              f"s a rank, one device {g['s1']:.3f} s")
    print(f"  mesh cells world={shape} (c) retrieval_cand_sah over "
          f"{lead['sah_rows'] * len(ranks):,} candidates "
          f"({lead['sah_rows']:,} a rank): ids and values bitwise the "
          f"single-device composition of the sharded scan; launches "
          f"{lead['sah_launches']} a rank; {each('sah_ms', 2)} ms a rank")
    pe = lead["pf_err"]
    print(f"  mesh cells world={shape} (d) qwen3-0.6b prefill_32k cut to "
          f"{MC_PREFILL_CUT} at TP-2: launches {lead['pf_launches']} a "
          f"rank, {each('pf_ms', 1)} ms a rank (the first, cold); last "
          f"logits from float32 max {pe['max']:.6f} mean {pe['mean']:.6f} "
          f"(one device's bf16 {pe['sd_max']:.6f}, {pe['sd_mean']:.6f}), "
          f"from one device's bf16 max {pe['vs_sd']:.6f}; phase "
          f"{each('mp_cells_s', 1)} s a rank")


def mp_lines(shape: tuple, ranks: list, wall: float, moe_want) -> None:
    """The model-parallel phase's lines of one world: its ranks' records
    (``mp_rank``), its wall seconds beside the other worlds, and the MoE
    phase's saved answers."""
    world = len(ranks)
    each = rank_values(ranks)
    lead = ranks[0]
    print(f"mp world={shape} (\"data\", \"model\"): backend gloo, {world} "
          f"ranks on cuda:0, {wall:.1f} s in all ({MP_LABEL}); seconds "
          f"a rank: qwen3 {each('mp_qwen3_s', 1)}, two-tower "
          f"{each('mp_two_tower_s', 1)}"
          + (f", olmoe {each('mp_olmoe_s', 1)}"
             if shape == MP_MOE_WORLD else "")
          + f", training {each('mp_train_qwen3_s', 1)}"
          + (f", olmoe training {each('mp_train_olmoe_s', 1)}"
             if shape == MP_MOE_WORLD else "")
          + f"; peak device memory a rank "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB")
    pe, ce = lead["lm_prefill_err"], lead["lm_cache_err"]
    print(f"  mp world={shape} qwen3-0.6b TP/SP prefill ({LM_BATCH} x "
          f"{LM_PROMPT} tokens, {lead['lm_params']:,} parameters a "
          f"rank): {each('lm_prefill_s')} s a rank (the first, cold), "
          f"launches {lead['lm_prefill_launches']} a rank; last logits "
          f"from the float32 model max {pe['max']:.6f} mean "
          f"{pe['mean']:.6f} (single-device bf16 chunked "
          f"{pe['sd_max']:.6f} and {pe['sd_mean']:.6f}, flash max "
          f"{pe['sd_flash_max']:.6f}), from single-device chunked max "
          f"{pe['vs_sd']:.6f} and flash {pe['vs_flash']:.6f}; greedy "
          f"ties {each('lm_prefill_ties')}; "
          f"cache layers {list(MP_CACHE_LAYERS)} gathered: k max "
          f"{ce['k']['max']:.6f} v max {ce['v']['max']:.6f} from float32 "
          f"(single-device {ce['k']['sd_max']:.6f}, "
          f"{ce['v']['sd_max']:.6f}), from single-device bf16 k "
          f"{ce['k']['vs_sd']:.6f} v {ce['v']['vs_sd']:.6f}")
    for kind, steps in (("decode", LM_STEPS),
                        ("long_ctx", MP_LONG_STEPS)):
        e = lead[f"lm_{kind}_err"]
        print(f"  mp world={shape} qwen3-0.6b split-KV decode, {kind} "
              f"rules ({steps} steps fed the single-device tokens, KV "
              f"sequence {lead[f'lm_{kind}_local_seq']} positions a "
              f"rank): {each(f'lm_{kind}_ms')} ms/step a rank, no "
              f"kernel; logits from float32 max {e['max']:.6f} mean "
              f"{e['mean']:.6f} (single-device bf16 {e['sd_max']:.6f}, "
              f"{e['sd_mean']:.6f}), from single-device bf16 max "
              f"{e['vs_sd']:.6f}; greedy tokens equal the "
              f"single-device ones but for {each(f'lm_{kind}_ties')} "
              f"traced near-ties")
    if shape == MP_MOE_WORLD:
        drops = {}
        for r in ranks:
            for i, d, a in r["moe_drops"]:
                got = drops.setdefault(i, [0, 0])
                got[0] += d
                got[1] += a
        shares = [drops[i][0] / drops[i][1] for i in sorted(drops)]
        total = (sum(d for d, _ in drops.values())
                 / sum(a for _, a in drops.values()))
        def layer(i, key):
            return [round(r["moe_layers"][i][key], 6) for r in ranks]

        print(f"  mp world={shape} olmoe-1b-7b expert parallelism "
              f"({lead['moe_params']:,} parameters a rank, "
              f"{lead['moe_experts'][0]} of {lead['moe_experts'][1]} "
              f"experts): "
              + "; ".join(
                  f"layer {i} on the single-device layer's input: "
                  f"dropped {layer(i, 'dropped')} = the per-shard "
                  f"composition's {layer(i, 'want_dropped')} of "
                  f"{layer(i, 'assigned')} at capacity "
                  f"{lead['moe_layers'][i]['capacity']}, outputs max "
                  f"abs err {layer(i, 'max_abs_err')}"
                  for i in lead["moe_layers"])
              + f" (within 2**-6 |ref| + 1e-3); EP prefill "
              f"{each('moe_prefill_s')} s a rank, launches "
              f"{lead['moe_prefill_launches']} a rank; dropped "
              f"{total:.4%} of assignments (single device "
              f"{moe_want['share']:.4%}), by layer "
              + ", ".join(f"{x:.4%}" for x in shares)
              + " (single device "
              + ", ".join(f"{x:.4%}" for x in moe_want["shares"]) + ")")
    mp_train_lines(shape, ranks, each)
    print(f"  mp world={shape} two-tower retrieval ({RETR_REQUESTS} "
          f"sketch requests, {lead['tt_candidates']:,} candidates, "
          f"tables row-sharded: "
          f"{lead['tt_table_rows']:,} user rows a rank): "
          f"{each('tt_ms')} ms/request a rank, launches "
          f"{lead['tt_launches']} a rank; item tower and user vectors "
          f"bitwise the single-device towers; ids and values bitwise "
          f"the single-device composition of the sharded scan (n_cand "
          f"{RETR_N_CAND} a shard); {each('tt_same_as_one_device')} of "
          f"{RETR_REQUESTS} requests have the single-device n_cand "
          f"{RETR_N_CAND} answer")


def worlds_path(seed: int, mp_dir: str, root: str, parent: str,
                single: dict, budget: int) -> dict:
    """The gloo worlds, side by side on the one card (``spawn_worlds``, in
    the order model-parallel (1, 2) and (2, 2), the mesh cells' (1, 2),
    then the mesh worlds of 2 and 3 ranks, each starting when the
    reckoning lets it), each rank held against the answers this process
    saved (``mp_dir``: the single-device phases'; ``parent`` and
    ``single``: ``mesh_answers``'s file and figures). Every world runs
    under ``root``, and each rank's measured peak is printed beside its
    cap. Returns the model-parallel worlds' ranks by shape, the mesh
    cells' ranks and the mesh phase's launches."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held, reserved = total - free, torch.cuda.memory_reserved()
    context = held - reserved
    print(f"worlds: this process holds {held / GIB:.2f} GiB of the card's "
          f"{total / GIB:.2f} GiB: {reserved / GIB:.2f} GiB reserved by its "
          f"allocator ({torch.cuda.memory_allocated() / GIB:.2f} GiB "
          f"allocated), {context / GIB:.2f} GiB besides: its CUDA "
          f"context, the size each rank's is reckoned at; the worlds' "
          f"seconds and ms below are taken side by side")
    cells = f"mesh cells {MC_WORLD}"
    worlds = [World(f"mp {shape}", mp_rank, shape[0] * shape[1],
                    (shape, seed, mp_dir), WORLD_PEAK[f"mp {shape}"])
              for shape in MP_WORLDS]
    worlds.append(World(cells, mp_rank, MC_WORLD[0] * MC_WORLD[1],
                        (MC_WORLD, seed, mp_dir, True), WORLD_PEAK[cells]))
    worlds += [World(f"mesh {n}", mesh_rank, n, (n, seed, parent),
                     WORLD_PEAK[f"mesh {n}"])
               for n in MESH_WORLDS]
    used = [0]

    def watch():
        f, t = torch.cuda.mem_get_info()
        used[0] = max(used[0], t - f)

    t0 = time.perf_counter()
    out = spawn_worlds(worlds, root, held, context, budget, watch)
    print(f"worlds: {time.perf_counter() - t0:.1f} s in all ("
          + ", ".join(f"{w.name} {out[w.name]['s']:.1f} s" for w in worlds)
          + f"); the card's used memory, sampled every 0.2 s, peaked at "
          f"{used[0] / GIB:.2f} GiB (budget {budget / GIB:.2f} GiB)")
    for w in worlds:
        ranks = out[w.name]["ranks"]
        got = [r["reserved"] for r in ranks]
        print(f"world {w.name}: peak reserved a rank "
              f"{[round(x / GIB, 2) for x in got]} GiB, allocated "
              f"{[round(r['peak'] / GIB, 2) for r in ranks]} GiB (its cap "
              f"and reckoning {w.peak / GIB:.2f} GiB a rank)")
        if max(got) > w.peak:
            fail(f"world {w.name}: a rank reserved {max(got) / GIB:.2f} GiB, "
                 f"past its cap of {w.peak / GIB:.2f} GiB")
    moe_want = torch.load(mp_file(mp_dir, "moe"), mmap=True)
    for shape in MP_WORLDS:
        world = out[f"mp {shape}"]
        mp_lines(shape, world["ranks"], world["s"], moe_want)
    mc_lines(MC_WORLD, out[cells]["ranks"], out[cells]["s"])
    mesh = {n: out[f"mesh {n}"]["ranks"] for n in MESH_WORLDS}
    for n in MESH_WORLDS:
        mesh_lines(n, mesh[n], out[f"mesh {n}"]["s"], single)
    return {"mp": {shape: out[f"mp {shape}"]["ranks"]
                   for shape in MP_WORLDS},
            "cells": out[cells]["ranks"], "mesh": mesh_launches(mesh)}


# -- the cells phase -------------------------------------------------------

RECSYS_ARCHS = ("two-tower-retrieval", "deepfm", "xdeepfm", "din")
CHECK_ROWS = 4096        # rows of a bulk forward held against float64


def cell_cuts():
    """The cells the cells phase runs, at full width: (arch, shape, cut,
    why). Every cut is a scale cut, decided before the run by the dry
    run's reckoning (``dryrun.FIT``: the largest value that fits one card
    with ``dryrun.FIT_MARGIN`` spare), never by catching an out-of-memory
    error. The reckonings quoted are the dry run's on this tree."""
    from repro_torch.launch import dryrun
    fit = dryrun.FIT
    return (
        ("qwen3-0.6b", "prefill_32k", {"global_batch": 4},
         "global batch 32 -> 4: the KV of 32 prompts is 120 GB; of 4, 15.0 "
         "GB, held twice (forward's k/v stacks and the padded cache)"),
        ("qwen3-0.6b", "decode_32k", {"global_batch": 8},
         "global batch 128 -> 8: a 481 GB cache -> 30.1 GB"),
        ("qwen3-0.6b", "long_500k", {}, "nothing cut"),
        ("olmoe-1b-7b", "train_4k", {"global_batch": 1, "n_layers": fit},
         "global batch 256 -> one sequence of 4,096 tokens; depth to what "
         "fits: bf16 weights and gradients, float32 clipped gradients and "
         "updates and Adafactor's bf16 momentum, ~14 B a parameter"),
        *((arch, shape, {}, "nothing cut") for arch in RECSYS_ARCHS
          for shape in ("serve_bulk", "retrieval_cand")),
        ("two-tower-retrieval", "retrieval_cand_sah", {}, "nothing cut"),
        ("gat-cora", "molecule", {}, "nothing cut"),
        ("gat-cora", "minibatch_lg", {}, "nothing cut"),
        ("gat-cora", "ogb_products", {"n_edges": fit},
         "edges to what fits: each layer gathers (E, heads, dim) float32 "
         "messages and keeps them for the backward, 84.6 GiB reckoned at "
         "the 61.9M published edges"),
    )


def all_finite(t) -> bool:
    """``torch.isfinite(t).all()`` a slab of 2**28 elements at a time, so
    that a cache of tens of GB needs no mask of its size."""
    import torch
    if not t.is_floating_point():
        return True
    flat = t.reshape(-1)
    return all(bool(torch.isfinite(c).all()) for c in flat.split(1 << 28))


def cell_loss_reference(run_args, arch: str, cut: dict) -> tuple[float, str]:
    """The first loss of a train cell in a wider dtype, on its inputs
    before any step: the LM in float32 (``float32_copy``), GAT in float64;
    (nan, why) where that copy does not fit beside the cell."""
    import copy
    import torch
    from repro_torch.models import gat
    from repro_torch.models import transformer as tf
    model, _, batch = run_args
    if arch == "gat-cora":
        if cut:
            return float("nan"), ("left out: the float64 copy of the graph "
                                  "and its activations do not fit beside "
                                  "the cut cell")
        cfg = model.cfg
        with torch.no_grad():
            m64 = copy.deepcopy(model).double()
            loss = float(gat.loss_fn(m64, {**batch, "x": batch["x"].double()},
                                     cfg))
        return loss, "float64 (the loss's own log-softmax is float32)"
    with torch.no_grad():
        m32 = float32_copy(model)
        loss = float(tf.lm_loss(m32, batch, loss_chunk=512))
    del m32
    torch.cuda.empty_cache()
    return loss, "float32"


def cells_path(seed: int, dev, out_dir: Path) -> dict:
    """Every cell of ``cell_cuts`` through ``launch/dryrun.py::run_cell``
    with ``measure_it=True``: reckoned on the meta device, drawn on the
    card from ``seed`` and run one warm and one timed step, the launch
    counts set to 0 after the inputs are drawn and read after the steps.
    Holds each cell's outputs (finite, the abstract outputs' shapes) and
    its own check; returns the phase's numbers and the flash entry at
    seq 32,768."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    gib = 2 ** 30
    t0 = time.perf_counter()
    peak_before = torch.cuda.max_memory_allocated()
    out, flash, peak_phase = {}, None, 0
    resident = torch.cuda.memory_allocated()
    print(f"cells phase: {resident / gib:.2f} GiB held by the process "
          f"before it; each cell is reckoned to fit beside it")
    for arch, shape, cut, why in cell_cuts():
        sah = shape.endswith("_sah")
        torch.cuda.empty_cache()
        t_cell = time.perf_counter()
        cut = dryrun.fit_cut(arch, shape, cut, resident) if not sah else {}
        extra = {}

        def on_args(args, arch=arch, shape=shape, cut=cut, extra=extra):
            if shape == "train_4k" or arch == "gat-cora":
                extra["ref_loss"] = cell_loss_reference(args, arch, cut)
            ops.reset_launch_counts()

        run = dryrun.run_cell(arch, shape.replace("_sah", ""), str(out_dir),
                              sah_variant=sah, measure_it=True, cut=cut,
                              seed=seed, on_args=on_args)
        launches = {k: v for k, v in ops.launch_counts.items() if v}
        rec = run.record
        tag = f"cell {arch} x {rec['shape']}"
        if "measured" not in rec:
            fail(f"{tag}: the reckoning says it does not fit "
                 f"({rec['memory']['per_device_total'] / gib:.2f} GiB)")
        m = rec["measured"]
        if not m["outputs_match_abstract"]:
            fail(f"{tag}: output shapes differ from the cell's abstract "
                 f"outputs")
        if not all(all_finite(t) for t in roofline.tensors_of(run.out)):
            fail(f"{tag}: a non-finite output")
        kind = run.cell.kind
        want = {}
        if shape == "prefill_32k":
            n = run.cell.abstract_args[0].cfg.n_layers
            want = {"flash_attention": 2 * n, "flash_attention_wgmma": 2 * n}
        elif sah:
            want = {"srp_hash": 2, "hamming_scores": 2}
        if launches != want:
            fail(f"{tag}: launches {launches}, expected {want} over its two "
                 f"steps")
        check = cell_check(arch, shape, run, extra)
        if shape == "prefill_32k":
            flash = flash_32k_entry(seed, dev, launches)
        peak = m["peak_bytes"]
        peak_phase = max(peak_phase, peak + m["resident_bytes"])
        mf = rec["model_flops_global"]
        ratio = rec.get("useful_flops_ratio")
        print(f"{tag}: cut {rec['reduced'] or 'none'} ({why}); reckoned "
              f"{rec['memory']['per_device_total'] / gib:.2f} GiB, measured "
              f"peak {peak / gib:.2f} GiB; step {m['step_ms']:.3f} ms (warm "
              f"{m['warm_step_ms']:.1f}); model FLOPs "
              f"{'n/a' if mf is None else f'{mf:.4g}'}; bound "
              f"{rec['bound_s'] * 1e3:.3f} ms "
              f"({rec['roofline']['dominant']}); step/bound "
              f"{m['step_over_bound']:.2f}; useful/counted FLOPs "
              f"{'n/a' if ratio is None else f'{ratio:.4f}'}; launches "
              f"{launches or 'none'}; {check}; "
              f"{time.perf_counter() - t_cell:.1f} s host")
        out[f"{arch}/{rec['shape']}"] = {
            "reduced": rec["reduced"], "why": why,
            "reckoned_bytes": rec["memory"]["per_device_total"],
            "peak_bytes": peak, "step_ms": m["step_ms"],
            "model_flops": mf, "bound_ms": rec["bound_s"] * 1e3,
            "dominant": rec["roofline"]["dominant"],
            "useful_flops_ratio": ratio, "launches": launches,
            "kind": kind}
        del run
    torch.cuda.empty_cache()
    print(f"cells phase: {len(out)} cells in "
          f"{time.perf_counter() - t0:.1f} s host; records under "
          f"{out_dir.name}/")
    return {"cells": out, "flash": flash, "peak_before": peak_before,
            "peak": peak_phase}


def check_rows(n: int, parts: int, dev):
    """``CHECK_ROWS`` row ids of a bulk forward over ``n`` rows run in
    ``parts`` equal chunks: the first and the last ``CHECK_ROWS // parts
    // 2`` of each chunk, so a chunk's offset, length or place in the
    concatenation shows."""
    import torch
    per, half = n // parts, CHECK_ROWS // parts // 2
    return torch.cat([torch.arange(lo, lo + half, device=dev)
                      for i in range(parts)
                      for lo in (i * per, (i + 1) * per - half)])


def cell_check(arch: str, shape: str, run, extra: dict) -> str:
    """The cell's own check on its measured run; returns what held."""
    import torch
    from repro_torch.configs import base
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import cells as cells_lib
    from repro_torch.models import recsys as rec_lib
    rec = run.record
    if "ref_loss" in extra:
        want, how = extra["ref_loss"]
        got = rec["measured"]["first_loss"]
        if want != want:
            return f"first loss {got!r}; its wide-dtype check {how}"
        rtol = LM_LOSS_RTOL if arch != "gat-cora" else TRAIN_F64_RTOL
        rel = within(f"cell {arch} x {shape} first loss", got, want, rtol)
        return (f"first loss {got!r} within {rel:.3g} of {how} {want!r} "
                f"(rtol {rtol})")
    if shape == "retrieval_cand_sah":
        model, feats, cand, codes, proj = run.args
        vals, ids = run.out
        u = rec_lib.user_tower(model, feats, model.cfg)[0].detach()
        ux = u[None].contiguous()
        qcode = ops.srp_hash(ux, proj)
        if not torch.equal(qcode, ref.srp_hash(ux, proj)):
            fail("cell retrieval_cand_sah: srp_hash's query code differs "
                 "from its plain version's")
        dist = ops.hamming_scores(qcode, codes)
        if not torch.equal(dist, ref.hamming_scores(qcode, codes)):
            fail(f"cell retrieval_cand_sah: hamming_scores over the "
                 f"{codes.shape[0]} candidates differs from its plain "
                 f"version's")
        if not torch.allclose(vals, cand[ids.long()].float() @ u, rtol=1e-5,
                              atol=1e-5):
            fail("cell retrieval_cand_sah: values are not the ids' inner "
                 "products")
        exact = torch.topk(cand.float() @ u, cells_lib.N_RETRIEVE).indices
        recall = float(torch.isin(ids.long(), exact).float().mean())
        return (f"query code and its {codes.shape[0]} Hamming distances "
                f"equal the plain versions'; values are the ids' inner "
                f"products; recall@100 of the "
                f"sketch against the exact top-100 {recall:.3f} (random "
                f"towers, no limit)")
    if arch == "two-tower-retrieval" and shape == "retrieval_cand":
        model, feats, cand = run.args
        vals, ids = run.out
        with torch.no_grad():
            u = rec_lib.user_tower(model, feats, model.cfg)[0]
            want = torch.topk(torch.matmul(cand, u), cells_lib.N_RETRIEVE)
        ties = ip_tie_check(u[None], cand, ids[None], want.indices[None])
        return (f"ids equal torch.topk(torch.matmul(cand, u))'s but for "
                f"{ties} positions, all float ties")
    if run.cell.kind in ("serve", "retrieval"):
        model, batch = run.args
        parts = (cells_lib.RETRIEVAL_CHUNKS if shape == "retrieval_cand"
                 else 1)
        idx = check_rows(run.out.shape[0], parts, run.out.device)
        rows = {k: v[idx] for k, v in batch.items()}
        got = run.out[idx]
        if arch == "two-tower-retrieval":
            def fwd():
                u = rec_lib.user_tower(model, rows["user_feats"], model.cfg)
                v = rec_lib.item_tower(model, rows["item_feats"], model.cfg)
                return (u * v).sum(-1)
        else:
            _, _, forward = cells_lib.recsys_fns(base.get(arch), model.cfg)

            def fwd():
                return forward(model, rows)
        note = ""
        with torch.no_grad():
            if shape == "retrieval_cand":
                whole = fwd()
                err = (got - whole).abs()
                if not bool((err <= RANKER_TOL["atol"] + RANKER_TOL["rtol"]
                             * whole.abs()).all()):
                    fail(f"cell {arch} x {shape}: chunked scoring is "
                         f"{float(err.max()):.3g} from the unchunked "
                         f"forward")
                note = (f"chunked within {float(err.max()):.3g} of the "
                        f"unchunked forward on {CHECK_ROWS} rows, the "
                        f"first and last {CHECK_ROWS // parts // 2} of "
                        f"each of its {parts} chunks; ")
            err64 = held_in_float64(f"cell {arch} x {shape}", model, fwd,
                                    got)
        return (f"{note}float32 within {err64:.3g} of float64 on "
                f"{CHECK_ROWS} rows")
    return "outputs finite, shapes as the abstract outputs"


def flash_32k_entry(seed: int, dev, launches: dict,
                    shape=(4, 16, 8, 32768, 128)) -> dict:
    """The flash kernel at the 32k prefill's ``shape``, q (4, 16, 32768,
    128) over 8 KV heads, bf16 causal, on unit-scale inputs from ``seed``, as
    the cell launches it: its whole output held against its plain version
    within two bf16 ulps, the plain version run one (batch, head) pair at
    a time on that head's KV head (its float32 scores are 4.3 GB a pair,
    275 GB for the whole), and timed so; the kernel timed (CUDA-graph
    replay) beside SDPA on repeated KV; its kernels-line entry."""
    import torch
    from repro_torch.kernels import flash_attention, ops, ref
    from repro_torch.models import attention
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, hkv, s, dh = shape           # (batch, heads, KV heads, seq, Dh)
    q = torch.randn((b, h, s, dh), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, hkv, s, dh), generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    if flash_attention.route(q, k, v) != "wgmma":
        fail(f"flash at seq {s}: the inputs do not take the wgmma route")
    got = ops.flash_attention(q, k, v)
    want = torch.empty_like(q)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // hkv)
            want[bi, hi] = ref.flash_attention(
                q[bi:bi + 1, hi:hi + 1], k[bi:bi + 1, kv:kv + 1],
                v[bi:bi + 1, kv:kv + 1])[0, 0]
    end.record()
    end.synchronize()
    plain = start.elapsed_time(end)
    err = flash_close(got, want, lambda a: 2.0 ** -6 * a + 1e-3)
    del got, want
    ms = device_ms(lambda: ops.flash_attention(q, k, v), 2, replays=2)
    kr = attention.repeat_kv(k, h // hkv).contiguous()
    vr = attention.repeat_kv(v, h // hkv).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = device_ms(lambda: sdpa(q, kr, vr, is_causal=True), 2, replays=2)
    flops = 4 * dh * b * h * s * (s + 1) // 2
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    bnd, by = bound(nbytes, flops / BF16_FLOP_PER_S)
    print(f"check flash_attention at seq {s}: q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)}, all {b * h} (batch, head) pairs, max abs err "
          f"{err:.6f}, every value within 2**-6 |plain| + 1e-3")
    print(f"time flash_attention q {tuple(q.shape)} k/v {tuple(k.shape)} "
          f"bf16 causal: wgmma kernel {ms:.4f} ms (device); bound "
          f"{bnd:.4f} ms ({by}: {flops / 1e12:.2f} TFLOP at 989 TFLOP/s "
          f"bf16); library scaled_dot_product_attention(is_causal=True) on "
          f"repeated KV {lib:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s; plain "
          f"version, pair by pair, {plain:.3f} ms")
    return {"name": "flash_attention/prefill_32k", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81",
            "launches": launches["flash_attention"],
            "launches_wgmma": launches["flash_attention_wgmma"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "plain_how": f"{b * h} calls, one (batch, head) pair each",
            "bound_ms": bnd, "bound_by": by,
            "library_ms": lib,
            "library_call": "torch.nn.functional."
                            "scaled_dot_product_attention(is_causal=True), "
                            "KV repeated",
            "tflops": flops / ms / 1e9,
            "shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal"}


def catalogue_change(seed: int, items, n_top: int):
    """The same catalogue change every run from ``seed``: the ids of
    ``N_DEL_TOP`` members of P' (the top ``n_top`` by norm) and of
    ``N_DEL_POP`` more items of the top ``POP_FRAC`` by norm, and
    ``N_INS`` new versions of top-``POP_FRAC`` items (each plus Gaussian
    noise of 5% of its norm over sqrt(d) per coordinate)."""
    import torch
    g = torch.Generator().manual_seed(seed + 1)
    order = torch.argsort(-torch.linalg.norm(items, dim=-1).cpu(),
                          stable=True)
    pop = int(POP_FRAC * items.shape[0])
    dels = torch.cat([
        order[torch.randperm(n_top, generator=g)[:N_DEL_TOP]],
        order[n_top + torch.randperm(pop - n_top, generator=g)[:N_DEL_POP]]])
    src = order[torch.randint(0, pop, (N_INS,), generator=g)]
    base = items[src.to(items.device)]
    noise = torch.randn(N_INS, items.shape[1], generator=g).to(items.device)
    scale = 0.05 * torch.linalg.norm(base, dim=-1, keepdim=True) \
        / items.shape[1] ** 0.5
    return dels.numpy(), base + noise * scale


def artifact_path(seed: int, eng, eng_ex, build_state, items, users,
                  queries, users_fwd, results, results8) -> dict:
    """The artifact phase on the f32 engine's build: save and load, a
    catalogue change served by the f32 and int8 reverse paths and the
    forward path, and ``compact`` against a fresh build. Fails on any
    miss; returns the peak device memory before the phase."""
    import shutil
    import tempfile
    import torch
    from repro_torch import RkMIPSEngine
    from repro_torch.core import metrics, sah
    from repro_torch.engine import IndexArtifact
    from repro_torch.kernels import ops, ref

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, art = eng.config, eng.artifact

    # -- save and load -------------------------------------------------------
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build", prefix="artifact-")
    try:
        t0 = now()
        art.save(tmp)
        t1 = now()
        loaded = IndexArtifact.load(tmp)
        t2 = now()
        size = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                   if f.is_file())
    finally:
        shutil.rmtree(tmp)
    if loaded.fingerprint != art.fingerprint:
        fail("the loaded artifact's fingerprint differs from the saved one")
    got = RkMIPSEngine.from_artifact(loaded).query_batch(queries, 10)
    if not torch.equal(got.predictions, results[10].predictions):
        fail("the loaded artifact's predictions differ from the build's")
    del loaded, got
    print(f"artifact save {t1 - t0:.3f} s, load {t2 - t1:.3f} s (fingerprint "
          f"re-check included), {size / 2**20:.1f} MiB on disk; fingerprint "
          f"{art.fingerprint[:16]} equal; predictions at k=10 equal "
          f"(torch.equal)")

    # -- a catalogue change --------------------------------------------------
    n_top = art.index.top_ids.numel()
    dels, rows = catalogue_change(seed, items, n_top)
    t0 = now()
    art_d = art.delete_items(dels)
    t1 = now()
    art2 = art_d.insert_items(rows)
    t2 = now()
    print(f"catalogue change: delete {len(dels)} ({N_DEL_TOP} of P') in "
          f"{t1 - t0:.4f} s, insert {N_INS} in {t2 - t1:.4f} s; "
          f"{art2.n_items} effective items, {art2.delta_used} of "
          f"{art2.delta_capacity} slots")
    eff = art2.effective_items()
    eff_ids = torch.as_tensor(art2.effective_ids(), device=eff.device)
    every = torch.cat([art2.items, art2.delta_items])    # rows by item id
    engd = RkMIPSEngine.from_artifact(art2)
    engd8 = RkMIPSEngine(cfg.replace(scan_precision="int8")).attach(art2)

    # -- reverse queries with the delta, counted -----------------------------
    resd, launches = {}, {}
    for prec, e in (("f32", engd), ("int8", engd8)):
        ops.reset_launch_counts()
        resd[prec] = {k: e.query_batch(queries, k) for k in (10, 50)}
        launches[prec] = dict(ops.launch_counts)
    print(f"launch_counts (reverse with the delta): f32 {launches['f32']}; "
          f"int8 {launches['int8']}")
    for name in ("srp_hash", "hamming_nearest"):
        if launches["f32"][name] <= 0:
            fail(f"kernel {name} was not launched on the f32 delta path")
    if launches["int8"]["fused_scan"] <= 0:
        fail("kernel fused_scan was not launched on the int8 delta path")
    unit = sah.unit_rows(users)
    for k in (10, 50):
        pred = resd["f32"][k].predictions
        if not torch.equal(resd["int8"][k].predictions, pred):
            fail(f"delta k={k}: int8 predictions differ from f32")
        if not torch.equal(resd["int8"][k].stats.tiles_scanned,
                           resd["f32"][k].stats.tiles_scanned):
            fail(f"delta k={k}: int8 tiles_scanned differ from f32")
        truth = engd.oracle(queries, k)
        missed = traced_misses(f"delta k={k}", eff, unit, queries, pred,
                               truth, k, cfg.tie_eps)
        moved = (pred != results[k].predictions).any(-1)
        if not bool(moved.any()):
            fail(f"delta k={k}: no audience changed with the catalogue")
        rec = metrics.recall(pred, truth)

        def ms(res):
            return f"{res.seconds * 1e3 / NQ:.3f}"

        print(f"delta k={k}: f32 {ms(resd['f32'][k])} ms/query, int8 "
              f"{ms(resd['int8'][k])} (without the delta: f32 "
              f"{ms(results[k])}, int8 {ms(results8[k])}); recall min "
              f"{float(rec.min()):.6f}, misses {missed} (float ties "
              f"{missed}); audience {int(truth.sum())} true / "
              f"{int(pred.sum())} predicted, changed in "
              f"{int(moved.sum())} of {NQ} queries; int8 == f32 bitwise")
        print(f"  funnel: {resd['f32'][k].funnel.format()}")
    view = engd.index
    t0 = now()
    plan = sah.rkmips_plan(view, queries, 10, tie_eps=cfg.tie_eps,
                           delta_items=art2.delta_items,
                           delta_mask=art2.delta_mask)
    t1 = now()
    sah.rkmips_plan(eng.index, queries, 10, tie_eps=cfg.tie_eps)
    t2 = now()
    print(f"plan k=10 with the delta product: {(t1 - t0) * 1e3:.1f} ms "
          f"(without a delta {(t2 - t1) * 1e3:.1f} ms)")

    # -- forward kMIPS with the delta ----------------------------------------
    engx = RkMIPSEngine.from_artifact(
        eng_ex.artifact.delete_items(dels).insert_items(rows))
    ops.reset_launch_counts()
    fx = engx.kmips(users_fwd, K_FWD)
    fs = engd.kmips(users_fwd, K_FWD)
    fs8 = engd8.kmips(users_fwd, K_FWD)
    launches_f = dict(ops.launch_counts)
    for name in ("srp_hash", "hamming_nearest"):
        if launches_f[name] <= 0:
            fail(f"kernel {name} was not launched on the forward delta path")
    # the truth: exact top-k over the effective items, counted on its own
    ops.reset_launch_counts()
    tv, ti = ops.ip_topk(users_fwd, eff, K_FWD)
    if ops.launch_counts["ip_topk"] != 1:
        fail("the forward truth over the effective items did not launch "
             "ip_topk")
    truth_ids = eff_ids[ti.long()]
    ties_f = ip_tie_check(users_fwd, every, fx.ids, truth_ids)
    if not torch.allclose(fx.values, tv, rtol=1e-5, atol=1e-6):
        fail("kmips exact with the delta: values differ from ip_topk's")
    if not (torch.equal(fs8.ids, fs.ids) and torch.equal(fs8.values,
                                                         fs.values)):
        fail("kmips with the delta: int8 differs from f32")
    for name, r in (("sah", fs), ("exact", fx)):
        if bool(torch.isin(r.ids, torch.as_tensor(
                dels, device=r.ids.device)).any()):
            fail(f"kmips {name} with the delta returned a deleted item")
    hit = (fs.ids[:, :, None] == truth_ids[:, None, :]).any(-1)
    staged = int((fs.ids >= art2.n_base).sum())
    print(f"kmips with the delta, k={K_FWD}: sah {fs.seconds * 1e6 / N_FWD:.2f}"
          f" us/user with the merge (int8 {fs8.seconds * 1e6 / N_FWD:.2f}), "
          f"recall@10 vs ip_topk over the effective items "
          f"{float(hit.float().mean()):.6f}, {staged} staged ids answered; "
          f"exact ids equal ip_topk's but for {ties_f} float ties; int8 == "
          f"f32; launches {launches_f} (the truth's ip_topk apart)")

    # -- compact -------------------------------------------------------------
    ops.reset_launch_counts()
    t0 = now()
    comp = art2.compact()
    t1 = now()
    if ops.launch_counts["srp_hash"] <= 0:
        fail("kernel srp_hash was not launched by compact")
    if comp.has_pending or comp.n_base != art2.n_items:
        fail("compact left pending changes or the wrong base size")
    fresh = RkMIPSEngine(cfg).build(eff, users,
                                    torch.Generator().set_state(build_state))
    if comp.fingerprint != fresh.artifact.fingerprint:
        fail("compact's fingerprint differs from a fresh build's")
    for name, a, b in zip(("alsh." + f for f in comp.index.alsh._fields),
                          comp.index.alsh, fresh.index.alsh):
        if not torch.equal(a, b):
            fail(f"compact's {name} differs from a fresh build's")
    for name in comp.index._fields[1:]:
        if not torch.equal(getattr(comp.index, name),
                           getattr(fresh.index, name)):
            fail(f"compact's {name} differs from a fresh build's")
    predc = RkMIPSEngine.from_artifact(comp).query_batch(queries, 10)
    if not torch.equal(predc.predictions,
                       fresh.query_batch(queries, 10).predictions):
        fail("compact's predictions differ from a fresh build's")
    print(f"compact {t1 - t0:.3f} s ({comp.build_timings.format()}) against "
          f"a fresh build {fresh.build_seconds:.3f} s "
          f"({fresh.build_timings.format()}); index arrays, fingerprint and "
          f"predictions at k=10 equal the fresh build's bit for bit")

    # -- the scan kernels on the first tile with a deleted row ---------------
    interior = view.alsh.item_mask != eng.index.alsh.item_mask
    t = int(torch.nonzero(interior)[0]) // cfg.tile
    sl = slice(t * cfg.tile, (t + 1) * cfg.tile)
    a = view.alsh
    lanes = plan.queue[:cfg.chunk] % view.n_users
    chunk_users = view.users[lanes].contiguous()
    ucodes = ops.srp_hash(chunk_users, a.proj[:-1])
    near = (ucodes, a.codes[sl], a.item_mask[sl], cfg.n_cand)
    codes_equal(f"hamming_nearest on tile {t} with deleted rows",
                ops.hamming_nearest(*near), ref.hamming_nearest(*near))
    fused = (ucodes, a.codes[sl], a.item_mask[sl], a.qitems[sl],
             a.qscale[sl], chunk_users)
    for got, want in zip(ops.fused_scan(*fused, n_cand=cfg.n_cand),
                         ref.fused_scan(*fused, cfg.n_cand)):
        if not torch.equal(got, want):
            fail(f"fused_scan on tile {t} with deleted rows differs from "
                 f"its plain version")
    print(f"check hamming_nearest and fused_scan on tile {t} "
          f"({int((~a.item_mask[sl]).sum())} deleted rows inside it), "
          f"{tuple(chunk_users.shape)} lanes: equal their plain versions "
          f"exactly")
    print(f"artifact phase peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"peak_before": peak_before}


MESH_WORLDS = (2, 3)  # gloo worlds of the mesh phase, every rank on cuda:0
MESH_K = 10
MESH_FWD = 256       # forward users of the mesh phase: n_cand covers a
                     # shard's rows, so a lane re-ranks (256, ~9k, 100)
MESH_LABEL = ("ranks share one card, beside the other worlds' ranks; "
              "collectives staged through the host: not a multi-GPU speed")
MESH_COUNTERS = ("blocks_alive", "users_alive", "n_no_lb", "n_yes_norm",
                 "n_scan", "truncated")
MESH_SERVE = dict(serve_batch_size=8, serve_buckets=(1, 2, 4))
MESH_RUNG_USERS = 64     # forward users each rung is held over
MESH_TIMEOUT = 120       # seconds a collective of a mesh world may wait
MESH_WAIT = 120          # seconds any one wait of its serving checks may take


def index_digest(index) -> str:
    """sha256 over every leaf of a SAHIndex (name, dtype, shape, bytes):
    equal digests are equal indexes bit for bit."""
    import hashlib
    h = hashlib.sha256()
    leaves = dict(index._asdict())
    leaves.update({f"alsh/{k}": v
                   for k, v in leaves.pop("alsh")._asdict().items()})
    for name in sorted(leaves):
        a = leaves[name].detach().cpu().numpy()
        h.update(f"{name}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def counted(fn):
    """(fn(), the kernel launches it made in this process)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    return out, {k: v for k, v in ops.launch_counts.items() if v}


def mesh_rank(rank: int, workdir: str, world: int, seed: int,
              parent: str) -> None:
    """One rank of a mesh-phase world (``spawn_worlds``):
    gloo over CUDA tensors, every rank on cuda:0. Rebuilds the Netflix
    index from ``seed`` under the mesh (the row-parallel stages), answers
    the parent's 16 queries at k = 10 in f32 and int8 and 256 forward
    users, and holds each against the parent's single-device answers
    (the file ``parent``) and its own launch counts against its chunks and
    tile steps; writes what it saw to ``rank<r>.json`` in ``workdir``. A
    mismatch raises, and ``spawn_worlds`` fails the smoke."""
    import datetime
    import math
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        from repro_torch import RkMIPSEngine, get_config
        from repro_torch.core import sah
        from repro_torch.data import synthetic
        from repro_torch.dist import ShardingPolicy
        want = torch.load(parent)
        policy = ShardingPolicy(mesh=init_device_mesh(
            "cuda", (world,), mesh_dim_names=("data",)))
        dev = torch.device("cuda", 0)
        ds = synthetic.PAPER_DATASETS["netflix"]
        cfg = get_config("sah")
        gen = torch.Generator().manual_seed(seed)
        items, users = synthetic.recommendation_data(
            gen, ds.n_items, ds.m_users, ds.d, device=dev)
        queries = synthetic.queries_from_items(gen, items, NQ,
                                               top_frac=TOP_FRAC)
        out = {"rank": rank}

        torch.cuda.synchronize()
        dist.barrier()
        eng, out["launches_build"] = counted(
            lambda: RkMIPSEngine(cfg, policy=policy).build(items, users,
                                                           gen))
        out["build_s"] = eng.build_seconds
        if eng.artifact.fingerprint != want["fingerprint"]:
            fail(f"mesh rank {rank}/{world}: artifact fingerprint differs")
        if index_digest(eng.artifact.index) != want["digest"]:
            fail(f"mesh rank {rank}/{world}: the mesh build's index differs "
                 f"from the single-device build")
        if (not eng.build_timings.sharded
                or out["launches_build"] != {"srp_hash": 1}):
            fail(f"mesh rank {rank}/{world}: the build was not row-parallel "
                 f"({out['launches_build']})")
        shard = eng._shard
        out["m_local"], out["n_blocks_local"] = shard.n_users, shard.n_blocks
        plan = sah.rkmips_plan(shard, queries, MESH_K, tie_eps=cfg.tie_eps)
        chunks = math.ceil(plan.n_work / min(cfg.chunk,
                                             NQ * shard.n_users))
        out["chunks"] = chunks
        eng8 = RkMIPSEngine(cfg.replace(scan_precision="int8"),
                            policy=policy).attach(eng.artifact)
        steps = None
        for prec, e in (("f32", eng), ("int8", eng8)):
            res, n = counted(lambda: e.query_batch(queries, MESH_K))
            out[f"launches_{prec}"] = n
            out[f"ms_query_{prec}"] = res.seconds * 1e3 / NQ
            pred = res.predictions.cpu()
            if not torch.equal(pred, want["pred"]):
                fail(f"mesh rank {rank}/{world} {prec}: "
                     f"{int((pred != want['pred']).sum())} predictions "
                     f"differ from the single-device f32 engine")
            for f in MESH_COUNTERS:
                if not torch.equal(getattr(res.stats, f).cpu(), want[f]):
                    fail(f"mesh rank {rank}/{world} {prec}: {f} differs "
                         f"from the single-device engine")
            scan = n.get("hamming_nearest" if prec == "f32"
                         else "fused_scan", 0)
            other = ("fused_scan" if prec == "f32" else "hamming_nearest",
                     "hamming_scores")
            steps = scan if steps is None else steps
            if (n.get("srp_hash", 0) != chunks or scan != steps
                    or any(n.get(o, 0) for o in other)):
                fail(f"mesh rank {rank}/{world} {prec}: launches {n} for "
                     f"{chunks} chunks and {steps} f32 tile steps")
            out[f"tiles_scanned_{prec}"] = int(res.stats.tiles_scanned.sum())
            out[f"chunks_{prec}"] = int(res.stats.chunks.sum())
        out["tile_steps"] = steps

        kidx = eng.kmips_index
        per = -(-kidx.items.shape[0] // world)
        fwd_users = want["users_fwd"].to(dev)
        fw, n = counted(lambda: eng.kmips(fwd_users, MESH_K, n_cand=per))
        out["launches_fwd"], out["fwd_n_cand"] = n, per
        out["fwd_ms"] = fw.seconds * 1e3
        # (the forward index was built above, by ``kmips_index``) one
        # srp_hash for the queries and one dense hamming_scores a shard
        if n != {"srp_hash": 1, "hamming_scores": 1}:
            fail(f"mesh rank {rank}/{world} forward: launches {n}")
        out["fwd_ties"] = ip_tie_check(fwd_users, items, fw.ids,
                                       want["exact_ids"].to(dev))
        if not torch.allclose(fw.values.cpu(), want["exact_vals"],
                              rtol=1e-5, atol=1e-6):
            fail(f"mesh rank {rank}/{world} forward: values differ from "
                 f"ip_topk's")
        t0 = time.perf_counter()
        out.update(mesh_serving(rank, world, policy, eng, want, queries,
                                items))
        out["serve_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["peak"] = torch.cuda.max_memory_allocated()
        out["reserved"] = torch.cuda.max_memory_reserved()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def mesh_serving(rank: int, world: int, policy, eng, want, queries,
                 items) -> dict:
    """The serving stack under the mesh, on every rank of a mesh-phase
    world after its engine checks (the serving phase's config): the
    reverse server (f32, int8) and the forward server held bitwise against
    the parent's answers and the mesh engine, with their launches; two
    runtimes under the controller rank (rank 0 submits from 4 threads, the
    others replay) held against the servers, then a catalogue change and a
    compaction landed with the parent's digest; a gateway of three
    tenants. Fails on any miss; returns what it measured."""
    import math
    from types import SimpleNamespace
    import torch
    from repro_torch import RkMIPSEngine
    from repro_torch.core import sah
    from repro_torch.engine import (ServingGateway, ServingRuntime,
                                    TenantPolicy, controller)
    who = f"mesh rank {rank}/{world}"
    lead = rank == 0
    cfg = eng.config.replace(**MESH_SERVE)
    art = eng.artifact.with_config(cfg)
    k, b = MESH_K, cfg.serve_batch_size
    users = want["users_fwd"].to(queries.device)
    rows, urows = list(queries.unbind(0)), list(users.unbind(0))
    out = {}

    # -- the reverse server, f32 and int8: 2 dispatches of 8, counted ------
    shard = eng._shard
    chunks = sum(math.ceil(
        sah.rkmips_plan(shard, queries[i:i + b], k,
                        tie_eps=cfg.tie_eps).n_work
        / min(cfg.chunk, b * shard.n_users)) for i in range(0, NQ, b))
    served, steps = {}, None
    for prec in ("f32", "int8"):
        srv = RkMIPSEngine(cfg.replace(scan_precision=prec),
                           policy=policy).attach(art).reverse_server()
        srv.submit(queries)
        served[prec], n = counted(lambda: srv.flush(k))
        out[f"serve_launches_rev_{prec}"] = n
        for i, r in enumerate(served[prec]):
            same_reverse(f"{who} reverse server {prec} ticket {i}",
                         SimpleNamespace(predictions=r.predictions.cpu(),
                                         stats=SimpleNamespace(**{
                                             f: getattr(r.stats, f).cpu()
                                             for f in PLAN_COUNTERS})),
                         want["pred"][i], SimpleNamespace(
                             **{f: want[f] for f in PLAN_COUNTERS}), i)
        scan = n.get("hamming_nearest" if prec == "f32" else "fused_scan",
                     0)
        steps = scan if steps is None else steps
        if (n.get("srp_hash", 0) != chunks or scan != steps
                or n.get("hamming_scores", 0)):
            fail(f"{who} reverse server {prec}: launches {n} for {chunks} "
                 f"chunks and {steps} f32 tile steps")
    out["serve_chunks"], out["serve_tile_steps"] = chunks, steps

    # -- the forward server: 32 dispatches a flush, counted ----------------
    feng = RkMIPSEngine.from_artifact(art, policy=policy)
    per = -(-feng.kmips_index.items.shape[0] // world)  # built: no rebuild
    fsrv = feng.server()
    dispatches = -(-MESH_FWD // b)
    fsrv.submit(users)
    exact, n_exact = counted(lambda: fsrv.flush(k, n_cand=per))
    fsrv.submit(users)
    fwd, n_fwd = counted(lambda: fsrv.flush(k))
    for name, n in (("n_cand a shard", n_exact), ("config n_cand", n_fwd)):
        if n != {"srp_hash": dispatches, "hamming_scores": dispatches}:
            fail(f"{who} forward server at {name}: launches {n} for "
                 f"{dispatches} dispatches")
    out["serve_launches_fwd"] = {name: n_exact[name] + n_fwd[name]
                                 for name in n_fwd}
    ids = torch.stack([r.ids for r in exact])
    out["serve_fwd_ties"] = ip_tie_check(users, items, ids,
                                         want["exact_ids"].to(ids.device))
    if not torch.allclose(torch.stack([r.values for r in exact]).cpu(),
                          want["exact_vals"], rtol=1e-5, atol=1e-6):
        fail(f"{who} forward server: values differ from ip_topk's")
    km = feng.kmips(users, k)
    same_forward(f"{who} forward server against the mesh kmips", fwd,
                 [SimpleNamespace(ids=i, values=v)
                  for i, v in zip(km.ids, km.values)])
    for rung in (1, 2, 4):
        for lo in range(0, MESH_RUNG_USERS, rung):
            same_forward(f"{who} forward rung {rung} at user {lo}",
                         fsrv._flush_batch(urows[lo:lo + rung], k,
                                           pad_to=rung), fwd[lo:lo + rung])

    # -- two runtimes under the controller, a change, a compaction ---------
    stream = controller.stream_for(policy)
    before = stream.stats()
    rt_r = ServingRuntime(RkMIPSEngine.from_artifact(
        art, policy=policy).reverse_server(), k=k, warmup=True, workers=2,
        compaction=True, compact_fill=1.0)
    rt_f = ServingRuntime(RkMIPSEngine.from_artifact(
        art, policy=policy).server(), k=k, warmup=True, workers=2)
    try:
        t0 = time.perf_counter()
        if lead:
            jobs = [(rt_r.submit, r) for r in rows] + [(rt_f.submit, u)
                                                       for u in urows]
            tickets = submit_from_threads(lambda j: j[0](j[1]), jobs, 4,
                                          f"{who} runtimes")
            got = answers(tickets, f"{who} runtimes")
            for i, r in enumerate(got[:NQ]):
                same_reverse(f"{who} reverse runtime ticket {i}", r,
                             served["f32"][i].predictions,
                             served["f32"][i].stats)
            same_forward(f"{who} forward runtime", got[NQ:], fwd)
            out["serve_latency"] = latency_ms(tickets)
        drained = [rt_r.drain(MESH_WAIT), rt_f.drain(MESH_WAIT)]
        span = time.perf_counter() - t0
        st = (rt_r.stats, rt_f.stats)
        if not all(drained) or [s.completed for s in st] != [NQ, MESH_FWD] \
                or any(s.traces_after_warmup for s in st):
            fail(f"{who} runtimes: drained {drained}, stats {st}")
        out["serve_tickets_per_s"] = (NQ + MESH_FWD) / span
        t0 = time.perf_counter()
        rt_r.delete_items(want["dels"].numpy())
        rt_r.insert_items(want["new_rows"].to(queries.device))
        rt_r.request_compaction()            # a no-op on a follower
        if lead:
            end = time.monotonic() + MESH_WAIT
            while rt_r.stats.compactions < 1:
                if time.monotonic() > end:
                    fail(f"{who}: the compaction never landed")
                time.sleep(0.01)
        if not rt_r.drain(MESH_WAIT):
            fail(f"{who}: the drain after the compaction timed out")
        out["serve_compact_s"] = time.perf_counter() - t0
        landed = rt_r.artifact
        if rt_r.stats.compactions != 1 or landed.has_pending \
                or landed.fingerprint != want["compact_fingerprint"] \
                or index_digest(landed.index) != want["compact_digest"]:
            fail(f"{who}: the landed compaction differs from the "
                 f"single-device compact of the same change")
        after = stream.stats()
        out["serve_stream"] = {
            part: {op: after[part][op] - before[part][op]
                   for op in controller.OPS} for part in after}
    finally:
        rt_r.close(timeout=MESH_WAIT)
        rt_f.close(timeout=MESH_WAIT)

    # -- a gateway of three tenants on one pool ----------------------------
    gw = ServingGateway(pool_workers=2)
    try:
        gw.register("reverse", art, k=k, sharding=policy)
        gw.register("budgeted", art, k=k, sharding=policy,
                    policy=TenantPolicy(scan_budget=1))
        gw.register("forward", art, k=k, sharding=policy, mode="forward")
        if gw.runtime("budgeted").server.engine._sigs is not \
                gw.runtime("reverse").server.engine._sigs:
            fail(f"{who} gateway: the budgeted tenant did not adopt the "
                 f"reverse tenant's dispatch")
        gw.warmup()
        if lead:
            jobs = ([("reverse", r) for r in rows]
                    + [("budgeted", r) for r in rows]
                    + [("forward", u) for u in urows])
            got = answers(submit_from_threads(
                lambda j: gw.submit(*j), jobs, 4, f"{who} gateway"),
                f"{who} gateway")
            for i, r in enumerate(got[:NQ]):
                same_reverse(f"{who} gateway reverse ticket {i}", r,
                             served["f32"][i].predictions,
                             served["f32"][i].stats)
            flagged = 0
            for i, r in enumerate(got[NQ:2 * NQ]):
                full = served["f32"][i].predictions
                if bool((r.predictions & ~full).any()) or (
                        not r.truncated
                        and not torch.equal(r.predictions, full)):
                    fail(f"{who} gateway budgeted ticket {i}: not a "
                         f"conservative answer")
                flagged += int(r.truncated)
            out["serve_gw_truncated"] = flagged
            same_forward(f"{who} gateway forward", got[2 * NQ:], fwd)
        if not gw.drain(MESH_WAIT):
            fail(f"{who} gateway: drain timed out")
        st = gw.stats()
        if st.traces_after_warmup or [t.completed for t in
                                      st.tenants.values()] != [NQ, NQ,
                                                               MESH_FWD]:
            fail(f"{who} gateway stats: {st}")
    finally:
        gw.close(timeout=MESH_WAIT)
    end = time.monotonic() + MESH_WAIT
    while stream.active:
        if time.monotonic() > end:
            fail(f"{who}: the dispatch stream's thread outlived close")
        time.sleep(0.01)
    return out


def mesh_answers(seed: int, eng, results, users_fwd, exact_vals,
                 exact_ids, parent: str) -> dict:
    """What the mesh worlds hold their ranks against, saved to the file
    ``parent``: this process's single-device f32 answers at k = 10, the
    forward users and their exact answers, the serving checks' catalogue
    change and its single-device compaction's digest. Returns the
    single-device figures the mesh lines print beside the ranks'."""
    import torch
    res = results[MESH_K]
    dels, new_rows = catalogue_change(seed, eng.artifact.items,
                                      eng.index.top_ids.numel())
    compacted = eng.artifact.with_config(eng.config.replace(
        **MESH_SERVE)).delete_items(dels).insert_items(new_rows).compact()
    want = {"fingerprint": eng.artifact.fingerprint,
            "digest": index_digest(eng.artifact.index),
            "pred": res.predictions.cpu(),
            "users_fwd": users_fwd[:MESH_FWD].cpu(),
            "exact_vals": exact_vals[:MESH_FWD].cpu(),
            "exact_ids": exact_ids[:MESH_FWD].cpu(),
            "dels": torch.as_tensor(dels), "new_rows": new_rows.cpu(),
            "compact_fingerprint": compacted.fingerprint,
            "compact_digest": index_digest(compacted.index)}
    del compacted
    want.update({f: getattr(res.stats, f).cpu() for f in MESH_COUNTERS})
    torch.save(want, parent)
    print(f"mesh answers: the single-device f32 answers at k={MESH_K}, "
          f"{MESH_FWD} forward users and the compaction of "
          f"{len(dels)} deletes + {len(new_rows)} inserts saved for the "
          f"mesh worlds")
    return {"m_pad": eng.index.n_users, "n_blocks": eng.index.n_blocks,
            "ms_query": res.seconds * 1e3 / NQ,
            "tiles_scanned": int(res.stats.tiles_scanned.sum()),
            "chunks": int(res.stats.chunks.sum()), "n_dels": len(dels),
            "n_new": len(new_rows)}


def mesh_lines(world: int, ranks: list, wall: float, single: dict) -> None:
    """The mesh phase's lines of one world: its ranks' records
    (``mesh_rank``), its wall seconds beside the other worlds, and the
    single-device figures of ``mesh_answers``."""
    def each(key):
        return [r[key] for r in ranks]

    print(f"mesh world={world}: backend gloo, {world} ranks on "
          f"cuda:0 (spawn_worlds, file:// rendezvous), {wall:.1f} s in "
          f"all; m_local {each('m_local')} and n_blocks "
          f"{each('n_blocks_local')} after padding "
          f"(single-device m_pad {single['m_pad']}, "
          f"{single['n_blocks']} blocks); build s "
          f"{[round(x, 3) for x in each('build_s')]}; f32 k="
          f"{MESH_K} ms/query "
          f"{[round(x, 3) for x in each('ms_query_f32')]}, int8 "
          f"{[round(x, 3) for x in each('ms_query_int8')]} "
          f"({MESH_LABEL}); single-device f32 "
          f"{single['ms_query']:.3f} ms/query; peak device memory a rank "
          f"{[round(r['peak'] / GIB, 2) for r in ranks]} GiB")
    print(f"  mesh world={world} checks: artifact fingerprint and "
          f"index digest equal the single-device build's on every "
          f"rank; predictions and {', '.join(MESH_COUNTERS)} "
          f"bitwise in f32 and int8; summed packing counts "
          f"tiles_scanned {ranks[0]['tiles_scanned_f32']} and chunks "
          f"{ranks[0]['chunks_f32']} (single-device "
          f"{single['tiles_scanned']} and {single['chunks']}); per rank: "
          f"chunks {each('chunks')} = srp_hash launches, tile steps "
          f"{each('tile_steps')} = hamming_nearest (f32) = "
          f"fused_scan (int8) launches, no dense hamming_scores; "
          f"forward {MESH_FWD} users with n_cand "
          f"{ranks[0]['fwd_n_cand']} (a shard's rows): ids equal "
          f"ip_topk's but for {each('fwd_ties')} float ties, "
          f"{[round(x, 2) for x in each('fwd_ms')]} ms; build "
          f"launches {each('launches_build')}")
    lead = ranks[0]
    stream = lead["serve_stream"]
    n_disp = stream["ops"]["dispatch"]
    print(f"  mesh world={world} serving (serve_batch_size 8, "
          f"buckets 1, 2, 4), {[round(x, 1) for x in each('serve_s')]}"
          f" s a rank: reverse server f32 and int8 bitwise the "
          f"single-device predictions and plan counters, per rank "
          f"srp_hash = {each('serve_chunks')} chunks of 2 dispatches, "
          f"hamming_nearest = fused_scan = "
          f"{each('serve_tile_steps')} tile steps; forward server "
          f"{MESH_FWD} users: bitwise the mesh kmips, ids equal "
          f"ip_topk's at n_cand a shard but for "
          f"{each('serve_fwd_ties')} float ties, rungs 1, 2, 4 "
          f"bitwise the full batch, per rank srp_hash = dense "
          f"hamming_scores = {2 * -(-MESH_FWD // 8)} dispatches; "
          f"runtimes under the controller ({NQ} reverse + "
          f"{MESH_FWD} forward tickets from 4 threads on rank 0, "
          f"bitwise the synchronous flush): "
          f"{lead['serve_latency']} on rank 0, tickets/s a rank "
          f"{[round(x, 1) for x in each('serve_tickets_per_s')]} "
          f"({MESH_LABEL}); stream {n_disp} dispatches, "
          f"{stream['broadcasts']['dispatch'] / max(n_disp, 1):.2f} "
          f"broadcasts a dispatch, ops {stream['ops']}; "
          f"{single['n_dels']} deletes + {single['n_new']} "
          f"inserts and a compaction in "
          f"{[round(x, 2) for x in each('serve_compact_s')]} s, "
          f"landed on every rank with the single-device compact's "
          f"digest; gateway of 3 tenants bitwise the dedicated "
          f"runtimes ({lead['serve_gw_truncated']} of {NQ} "
          f"scan_budget=1 tickets truncated, each a subset of the "
          f"full answer)")


def mesh_launches(worlds: dict) -> dict:
    """The mesh phase's launches, summed over every rank of its worlds:
    the engine's (build, f32, int8, forward) and the servers'."""
    launches, serve_launches = {}, {}
    for ranks in worlds.values():
        for r in ranks:
            for part in ("build", "f32", "int8", "fwd"):
                for name, n in r[f"launches_{part}"].items():
                    launches[name] = launches.get(name, 0) + n
            for part in ("rev_f32", "rev_int8", "fwd"):
                for name, n in r[f"serve_launches_{part}"].items():
                    serve_launches[name] = serve_launches.get(name, 0) + n
    print(f"mesh serving launches, all ranks of both worlds: "
          f"{serve_launches}")
    return {"launches": launches, "serve_launches": serve_launches}


SERVE_WAIT = 300     # seconds any one wait of the serving phase may take
PLAN_COUNTERS = ("blocks_alive", "users_alive", "n_no_lb", "n_yes_norm",
                 "n_scan", "truncated")


def answers(tickets, what: str) -> list:
    """Each ticket's answer; fails the smoke on a wait past SERVE_WAIT."""
    out = []
    for t in tickets:
        try:
            out.append(t.result(timeout=SERVE_WAIT))
        except TimeoutError:
            fail(f"{what}: a ticket was not answered within {SERVE_WAIT} s")
    return out


def submit_from_threads(submit, rows, n_threads: int, what: str) -> list:
    """Submit ``rows`` one ticket each from ``n_threads`` threads (thread j
    takes rows j, j + n_threads, ...); the tickets in row order."""
    import threading
    tickets = [None] * len(rows)

    def send(j):
        for i in range(j, len(rows), n_threads):
            tickets[i] = submit(rows[i])

    threads = [threading.Thread(target=send, args=(j,))
               for j in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_WAIT)
        if t.is_alive():
            fail(f"{what}: a submitter thread hung")
    return tickets


def same_reverse(what: str, got, want_pred, want_stats, row=None) -> None:
    """Fail unless a served reverse answer has ``want_pred`` and the plan
    counters and truncation flag of ``want_stats`` (row ``row`` of a
    batch's, or a ticket's own) bit for bit."""
    import torch
    if not torch.equal(got.predictions, want_pred):
        fail(f"{what}: predictions differ")
    for f in PLAN_COUNTERS:
        want = getattr(want_stats, f)
        if not torch.equal(getattr(got.stats, f),
                           want if row is None else want[row]):
            fail(f"{what}: stats.{f} differs")


def same_forward(what: str, got: list, want: list) -> None:
    import torch
    for g, w in zip(got, want):
        if not (torch.equal(g.ids, w.ids) and torch.equal(g.values,
                                                          w.values)):
            fail(f"{what}: ids or values differ")


def latency_ms(tickets) -> str:
    import statistics
    lat = sorted(t.latency * 1e3 for t in tickets)
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    return (f"p50 {statistics.median(lat):.3f} ms, p99 {p99:.3f} ms over "
            f"{len(lat)} tickets")


def serving_path(seed: int, eng, queries, users_fwd, exact_ids, items,
                 results) -> dict:
    """The serving phase on the f32 engine's build, with
    ``serve_batch_size=8, serve_buckets=(1, 2, 4)``: the reverse server
    (f32 and int8), the forward server ("sah" and "exact" scans, rungs 1,
    2 and 4 against the full-batch flush), the threaded runtime (reverse
    with a catalogue change and a background compaction, forward), and a
    gateway of three tenants in one pool. Fails on any miss; returns the
    peak device memory before the phase and the dense ``hamming_scores``
    kernel's serving-shape numbers."""
    import math
    import torch
    from repro_torch import RkMIPSEngine
    from repro_torch.engine import (RetrievalServer, ServingGateway,
                                    ServingRuntime, TenantPolicy)
    from repro_torch.kernels import ops, ref

    t_start = t_mark = time.perf_counter()
    parts = {}

    def mark(name):                 # host seconds of each part of the phase
        nonlocal t_mark
        now = time.perf_counter()
        parts[name] = round(now - t_mark, 2)
        t_mark = now

    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = eng.config.replace(serve_batch_size=8, serve_buckets=(1, 2, 4))
    art = eng.artifact.with_config(cfg)
    k = 10
    rows = list(queries.unbind(0))
    m_pad = eng.index.n_users

    def chunks(served) -> int:
        """srp_hash launches of the reverse dispatches that answered
        ``served``: one a chunk, ceil(scan lanes / chunk) a dispatch."""
        funnels = {id(r.funnel): r.funnel for r in served}.values()
        return sum(math.ceil(f.scan_lanes / min(cfg.chunk, f.queries * m_pad))
                   for f in funnels)

    # -- the reverse server, f32 and int8, counted ----------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    srv = {}
    served = {}
    for prec in ("f32", "int8"):
        e = RkMIPSEngine(cfg.replace(scan_precision=prec)).attach(art)
        srv[prec] = e.reverse_server()
        srv[prec].submit(queries)
        full = srv[prec].flush(k)                        # 2 dispatches of 8
        rung = srv[prec].bucket_for(3)
        if rung != 4:
            fail(f"3 tickets pad to rung {rung}, not 4")
        part = srv[prec]._flush_batch(rows[:3], k, pad_to=rung)
        served[prec] = full + part
    t_rev = time.perf_counter() - t0
    want_pred = results[k].predictions
    packed_equal = 0
    for i, r in enumerate(served["f32"]):
        row = i if i < len(rows) else i - len(rows)
        same_reverse(f"reverse server ticket {i}", r, want_pred[row],
                     results[k].stats, row)
        packed_equal += int(torch.equal(r.stats.tiles_scanned,
                                        results[k].stats.tiles_scanned[row]))
        r8 = served["int8"][i]
        same_reverse(f"int8 reverse server ticket {i}", r8, r.predictions,
                     r.stats)
        for f in ("tiles_scanned", "chunks"):
            if not torch.equal(getattr(r8.stats, f), getattr(r.stats, f)):
                fail(f"int8 reverse server ticket {i}: stats.{f} differs "
                     f"from f32's")
    rev_chunks = chunks(served["f32"]) + chunks(served["int8"])
    rev_launches = dict(ops.launch_counts)
    print(f"serving: reverse server k={k}, 16 tickets (2 dispatches of 8) + "
          f"3 (rung 4), f32 and int8: {t_rev:.2f} s; predictions and plan "
          f"counters equal the f32 path's batch of 16 bitwise (tiles_scanned "
          f"in {packed_equal} of 19 rows: a packing count), int8 == f32 "
          f"bitwise (whole rows); {rev_chunks} chunks; launches "
          f"{rev_launches}")
    if rev_launches["srp_hash"] != rev_chunks:
        fail(f"reverse server: {rev_launches['srp_hash']} srp_hash launches "
             f"for {rev_chunks} chunks")
    for name in ("hamming_nearest", "fused_scan"):
        if rev_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the reverse server")
    if rev_launches["hamming_scores"] != 0:
        fail("the reverse server launched the dense hamming_scores")
    mark("reverse server")

    # -- the forward server, "sah" and "exact" scans, counted -----------------
    fsrv = RetrievalServer.from_artifact(art)
    if fsrv.cache.builds != 0:
        fail("the forward server rebuilt the artifact's forward index")
    users = list(users_fwd.unbind(0))
    fwd, fwd_s, dispatches = {}, {}, 0
    for scan in ("sketch", "exact"):
        t0 = time.perf_counter()
        for u in users:
            fsrv.submit(u)
        fwd[scan] = fsrv.flush(k, scan=scan)
        torch.cuda.synchronize()
        fwd_s[scan] = time.perf_counter() - t0
        n_full = -(-len(users) // cfg.serve_batch_size)
        for rung in (1, 2, 4):
            for lo in range(0, len(users), rung):
                got = fsrv._flush_batch(users[lo:lo + rung], k, scan=scan,
                                        pad_to=rung)
                same_forward(f"forward {scan} rung {rung} at user {lo}", got,
                             fwd[scan][lo:lo + rung])
            n_full += -(-len(users) // rung)
        if scan == "sketch":
            dispatches = n_full
    launches = {n: ops.launch_counts[n] - rev_launches[n]
                for n in ops.launch_counts}
    if launches["hamming_scores"] != dispatches:
        fail(f"forward server: {launches['hamming_scores']} hamming_scores "
             f"launches for {dispatches} sketch dispatches")
    if ops.launch_counts["srp_hash"] != dispatches + rev_chunks:
        fail(f"serving: srp_hash grew by {ops.launch_counts['srp_hash']}, "
             f"not {dispatches} forward dispatches + {rev_chunks} reverse "
             f"chunks")
    ids = {s: torch.stack([r.ids for r in fwd[s]]) for s in fwd}
    vals = torch.stack([r.values for r in fwd["exact"]])
    ties = ip_tie_check(users_fwd, items, ids["exact"], exact_ids)
    recomputed = (users_fwd[:, None, :] * items[ids["exact"].long()]).sum(-1)
    if not torch.allclose(vals, recomputed, rtol=1e-5, atol=1e-6):
        fail("forward server exact: values are not the ids' inner products")
    hit = (ids["sketch"][:, :, None] == exact_ids[:, None, :]).any(-1)
    print(f"serving: forward server, 4,096 single tickets, k={k}: sketch "
          f"{fwd_s['sketch']:.3f} s, exact {fwd_s['exact']:.3f} s (512 "
          f"dispatches each); rungs 1, 2 and 4 bitwise equal to the full "
          f"batch at every user under both scans; sketch recall@10 vs "
          f"ip_topk {float(hit.float().mean()):.6f}; exact ids equal "
          f"ip_topk's but for {ties} float ties; hamming_scores launches = "
          f"{dispatches} sketch dispatches; srp_hash = {dispatches} + "
          f"{rev_chunks} reverse chunks; launches {launches}")
    mark("forward server, rungs included")

    # -- srp_hash and the dense kernel at the serving shapes ------------------
    state = fsrv.cache.get(cfg)
    pq = state.proj_q
    for q in cfg.bucket_ladder():       # every rung and the full batch
        xq = users_fwd[:q].contiguous()
        srp_err = codes_equal(f"srp_hash at the serving shape "
                              f"{tuple(xq.shape)}x{tuple(pq.shape)}",
                              ops.srp_hash(xq, pq), ref.srp_hash(xq, pq))
    x8 = users_fwd[:cfg.serve_batch_size].contiguous()
    ucodes8 = ops.srp_hash(x8, pq)
    (q8, dq), b = x8.shape, pq.shape[1]
    srp_bytes = 4 * (q8 * dq + dq * b + q8 * b // 32)
    t_bytes, t_ops = (srp_bytes / HBM_BYTES_PER_S,
                      2 * q8 * dq * b / FP32_FLOP_PER_S)
    srp = {
        "serving_shape": f"{tuple(x8.shape)}x{tuple(pq.shape)}",
        "serving_shapes_checked": [[q, dq] for q in cfg.bucket_ladder()],
        "serving_launches": launches["srp_hash"],
        "serving_max_abs_err": srp_err,
        "serving_ms": device_ms(lambda: ops.srp_hash(x8, pq), ITERS),
        "serving_plain_ms": device_ms(lambda: ref.srp_hash(x8, pq), 20),
        "serving_call_ms": call_ms(lambda: ops.srp_hash(x8, pq), ITERS),
        "serving_bound_ms": max(t_bytes, t_ops) * 1e3,
        "serving_bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"time srp_hash at the serving shape {srp['serving_shape']} "
          f"(equal to its plain version at rungs "
          f"{list(cfg.bucket_ladder())}): kernel {srp['serving_ms']:.5f} ms "
          f"(device), {srp['serving_call_ms']:.5f} ms per call from "
          f"Python; plain {srp['serving_plain_ms']:.5f} ms; bound "
          f"{srp['serving_bound_ms']:.6f} ms ({srp['serving_bound_by']}); "
          f"{srp['serving_launches']} launches on the forward server")
    dense_err = codes_equal("hamming_scores at the serving shape",
                            ops.hamming_scores(ucodes8, state.codes),
                            ref.hamming_scores(ucodes8, state.codes))
    (q8, w), n = ucodes8.shape, state.codes.shape[0]
    nbytes = 4 * (q8 * w + n * w + q8 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * q8 * n * w / INT32_OP_PER_S
    dense = {
        "serving_shape": f"{tuple(ucodes8.shape)}x{tuple(state.codes.shape)}",
        "serving_launches": launches["hamming_scores"],
        "serving_max_abs_err": dense_err,
        "serving_ms": device_ms(lambda: ops.hamming_scores(ucodes8,
                                                           state.codes),
                                ITERS),
        "serving_plain_ms": device_ms(lambda: ref.hamming_scores(
            ucodes8, state.codes), 20),
        "serving_call_ms": call_ms(lambda: ops.hamming_scores(
            ucodes8, state.codes), ITERS),
        "serving_bound_ms": max(t_bytes, t_ops) * 1e3,
        "serving_bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "serving_bytes": nbytes}
    print(f"time hamming_scores (dense) at the serving shape "
          f"{dense['serving_shape']}: kernel {dense['serving_ms']:.5f} ms "
          f"(device), {dense['serving_call_ms']:.5f} ms per call from "
          f"Python; plain {dense['serving_plain_ms']:.5f} ms; bound "
          f"{dense['serving_bound_ms']:.6f} ms ({dense['serving_bound_by']}: "
          f"{nbytes} bytes); {launches['hamming_scores']} launches in the "
          f"phase")
    mark("serving-shape kernel timing")

    # -- the reverse runtime: warmup, threads, a change, a compaction ---------
    rt = None
    try:
        t0 = time.perf_counter()
        # compact_fill 1.0: the change (192 of 256 slots) starts no
        # compaction of its own; request_compaction() below does
        rt = ServingRuntime(RkMIPSEngine(cfg).attach(art).reverse_server(),
                            k=k, warmup=True, workers=2, compaction=True,
                            compact_fill=1.0)
        t_warm = time.perf_counter() - t0
        warm_sigs = rt.server.compile_count
        tickets = submit_from_threads(rt.submit, rows, 4, "reverse runtime")
        first_wave = answers(tickets, "reverse runtime")
        for i, r in enumerate(first_wave):
            same_reverse(f"reverse runtime ticket {i}", r,
                         served["f32"][i].predictions,
                         served["f32"][i].stats)
        if rt.stats.traces_after_warmup != 0:
            fail(f"reverse runtime: {rt.stats.traces_after_warmup} "
                 f"signatures after warmup")
        rev_lat = latency_ms(tickets)
        dels, new_rows = catalogue_change(seed, items,
                                          art.index.top_ids.numel())
        rt.delete_items(dels)
        rt.insert_items(new_rows)
        after_change = answers(submit_from_threads(
            rt.submit, rows, 4, "reverse runtime"), "reverse runtime")
        sync = RkMIPSEngine(cfg).attach(rt.artifact).reverse_server()
        sync.submit(queries)
        for i, (r, w) in enumerate(zip(after_change, sync.flush(k))):
            same_reverse(f"reverse runtime after the change, ticket {i}", r,
                         w.predictions, w.stats)
        changed = sum(not torch.equal(r.predictions, want_pred[i])
                      for i, r in enumerate(after_change))
        if changed == 0:
            fail("reverse runtime: no audience moved with the change")
        t0 = time.perf_counter()
        rt.request_compaction()
        end = time.monotonic() + SERVE_WAIT
        while rt.stats.compactions < 1:
            if time.monotonic() > end:
                fail("reverse runtime: the compaction never landed")
            time.sleep(0.01)
        t_compact = time.perf_counter() - t0
        if not rt.drain(timeout=SERVE_WAIT):
            fail("reverse runtime: drain timed out")
        st = rt.stats
        if st.compactions != 1 or rt.artifact.has_pending \
                or rt.artifact.n_base != art.n_items - len(dels) + len(
                    new_rows):
            fail(f"reverse runtime: compaction state wrong ({st})")
        after_compact = answers(submit_from_threads(
            rt.submit, rows, 4, "reverse runtime"), "reverse runtime")
        sync = RkMIPSEngine(cfg).attach(rt.artifact).reverse_server()
        sync.submit(queries)
        for i, (r, w) in enumerate(zip(after_compact, sync.flush(k))):
            same_reverse(f"reverse runtime after the compaction, ticket {i}",
                         r, w.predictions, w.stats)
            if not torch.equal(r.predictions, after_change[i].predictions):
                fail(f"reverse runtime ticket {i}: the compaction moved "
                     f"an answer")
        st = rt.stats
        print(f"serving: reverse runtime (workers 2, warmup {t_warm:.3f} s "
              f"for {warm_sigs} signatures, 0 after it), 3 waves of 16 "
              f"tickets from 4 threads: {rev_lat} (first wave); "
              f"batches {st.batches}, bucket_hits {st.bucket_hits}, "
              f"bucket_pad_rows {st.bucket_pad_rows}, swaps {st.swaps}, "
              f"compactions {st.compactions} (requested to landed "
              f"{t_compact:.3f} s, {rt.last_compaction_seconds:.3f} s "
              f"off-thread); answers equal the synchronous server's on each "
              f"version bitwise ({changed} of 16 audiences moved with the "
              f"change, none with the compaction)")
    finally:
        if rt is not None:
            rt.close(timeout=SERVE_WAIT)
    mark("reverse runtime, sync references included")

    # -- the forward runtime --------------------------------------------------
    # 4 submitter threads on 2 workers, then 1 on 1: how much of a
    # ticket's cost is the threads' contention for the host
    for n_sub, n_work in ((4, 2), (1, 1)):
        rt = None
        try:
            t0 = time.perf_counter()
            rt = ServingRuntime(RetrievalServer.from_artifact(art), k=k,
                                warmup=True, workers=n_work)
            t_warm_f = time.perf_counter() - t0
            tickets = submit_from_threads(rt.submit, users, n_sub,
                                          "forward runtime")
            same_forward("forward runtime",
                         answers(tickets, "forward runtime"), fwd["sketch"])
            if not rt.drain(timeout=SERVE_WAIT):
                fail("forward runtime: drain timed out")
            st = rt.stats
            if st.traces_after_warmup != 0 or st.completed != len(users):
                fail(f"forward runtime: {st}")
            span = max(t.done_at for t in tickets) - min(t.submitted_at
                                                         for t in tickets)
            print(f"serving: forward runtime (workers {n_work}, warmup "
                  f"{t_warm_f:.3f} s), 4,096 tickets from {n_sub} "
                  f"thread(s): {latency_ms(tickets)}; "
                  f"{len(users) / span:.0f} tickets/s; batches "
                  f"{st.batches}, bucket_hits {st.bucket_hits}, "
                  f"bucket_pad_rows {st.bucket_pad_rows}; answers equal the "
                  f"synchronous flush bitwise")
        finally:
            if rt is not None:
                rt.close(timeout=SERVE_WAIT)
    mark("forward runtime")

    # -- the gateway: three tenants in one pool -------------------------------
    budget = max(1, int(results[k].stats.tiles_scanned.median()))
    gw = ServingGateway(pool_workers=2)
    try:
        gw.register("reverse", art, k=k)
        gw.register("budgeted", art, k=k,
                    policy=TenantPolicy(scan_budget=budget))
        gw.register("forward", art, k=k, mode="forward")
        if gw.runtime("budgeted").server.engine._sigs is not \
                gw.runtime("reverse").server.engine._sigs:
            fail("gateway: the budgeted tenant did not adopt the reverse "
                 "tenant's dispatch")
        t0 = time.perf_counter()
        cells = gw.warmup()
        t_gw_warm = time.perf_counter() - t0
        rev_t = submit_from_threads(lambda q: gw.submit("reverse", q), rows,
                                    2, "gateway")
        bud_t = submit_from_threads(lambda q: gw.submit("budgeted", q), rows,
                                    2, "gateway")
        fwd_t = submit_from_threads(lambda u: gw.submit("forward", u), users,
                                    4, "gateway")
        rev_g = answers(rev_t, "gateway reverse")
        bud_g = answers(bud_t, "gateway budgeted")
        same_forward("gateway forward", answers(fwd_t, "gateway forward"),
                     fwd["sketch"])
        if not gw.drain(timeout=SERVE_WAIT):
            fail("gateway: drain timed out")
        for i, r in enumerate(rev_g):
            same_reverse(f"gateway budget-0 ticket {i}", r,
                         first_wave[i].predictions, first_wave[i].stats)
        flagged = 0
        for i, r in enumerate(bud_g):
            full = rev_g[i].predictions
            if bool((r.predictions & ~full).any()):
                fail(f"gateway budgeted ticket {i}: a user the unbudgeted "
                     f"answer lacks")
            if r.truncated:
                flagged += 1
                if int(r.stats.tiles_scanned) < budget:
                    fail(f"gateway budgeted ticket {i}: truncated below "
                         f"its budget")
            elif not torch.equal(r.predictions, full):
                fail(f"gateway budgeted ticket {i}: not truncated but not "
                     f"exact")
        if flagged == 0:
            fail(f"gateway: budget {budget} truncated no ticket")
        st = gw.stats()
        tn = st.tenants
        if st.traces_after_warmup != 0 or tn["reverse"].completed != 16 \
                or tn["budgeted"].completed != 16 \
                or tn["forward"].completed != len(users) \
                or tn["budgeted"].truncated != flagged \
                or tn["reverse"].truncated != 0:
            fail(f"gateway stats: {st}")
        print(f"serving: gateway, 3 tenants on 2 pool workers (warmup "
              f"{cells} cells in {t_gw_warm:.3f} s, 0 signatures after it): "
              f"budget-0 reverse equals the dedicated runtime bitwise, "
              f"{latency_ms(rev_t)}; budgeted (scan_budget {budget}, the "
              f"median tile visits of the 16 queries) truncated {flagged} "
              f"of 16, each flagged at or past its budget and a subset of "
              f"the unbudgeted answer, {latency_ms(bud_t)}; forward equals "
              f"the synchronous flush bitwise, {latency_ms(fwd_t)}; "
              f"completed {[tn[n].completed for n in tn]}, truncated "
              f"{[tn[n].truncated for n in tn]}")
    finally:
        gw.close(timeout=SERVE_WAIT)
    mark("gateway")

    print(f"serving phase: {time.perf_counter() - t_start:.1f} s host "
          f"({parts}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"peak_before": peak_before, "dense": dense, "srp": srp}


EX_K = 10                # quickstart's k
EX_PRESETS = ("sah", "sa-simpfer", "h2-cone", "h2-simpfer", "simpfer",
              "exact")   # PAPER_BASELINES and the in-engine oracle preset
EX_INSERTS = 24          # update_stream's trending rows (the reference's)
EX_ASYNC_QUERIES = 64    # serve_async's queries (the reference's)
# serve_multitenant at the reference's k = 5 over the smoke's 16 queries,
# in draw order (the reference's own draw, 24 from the top 20% by norm,
# leaves no user to scan at this scale, so no scan would be truncated),
# without its 4 "promo blitz" probes: each leaves ~450,000 users to scan,
# ~57,000 chunks of its chunk=8, at 2 to 4 ms a chunk through the gateway
# on the H100 (PERF.md section 6) minutes a probe; the first
# EX_MT_PROBE_CHUNKS chunks of one probe are timed instead, through the
# engine's host loop
EX_MT_K = 5
EX_MT_PROBE_CHUNKS = 1024
EX_RR_STEPS = 20         # reverse_recommend's training steps
EX_SR_STEPS = 30         # serve_retrieval's training steps
EX_SR_CORPUS = 1_000_000
EX_SR_REQUESTS = 64
EX_SR_K = 20
# train_lm --model 100m at batch 8 x 256: the reference's --steps 50 and
# --ckpt-every 25, once whole and once crashed with --fail-at 30
EX_LM_STEPS = 50
EX_LM_CKPT_EVERY = 25
EX_LM_FAIL_AT = 30


def chunk_counter(each=None):
    """Count the reverse query's chunks and tile steps independently of
    the kernels: ``sa_alsh.decide_count`` runs once a chunk and returns
    the tile steps it took; ``each(counts)``, where given, is called after
    every chunk. Returns (counts, restore)."""
    from repro_torch.core import sa_alsh
    inner = sa_alsh.decide_count
    counts = {"chunks": 0, "tile_steps": 0}

    def counted(*args, **kw):
        yes, t = inner(*args, **kw)
        counts["chunks"] += 1
        counts["tile_steps"] += int(t)
        if each is not None:
            each(counts)
        return yes, t

    sa_alsh.decide_count = counted

    def restore():
        sa_alsh.decide_count = inner

    return counts, restore


def launches_only(what: str, launches: dict, want: dict) -> None:
    """Fail unless each kernel launched as often as ``want`` says: a count
    there, True for some launches, and none for the kernels it leaves
    out."""
    for name, got in launches.items():
        need = want.get(name, 0)
        if (got <= 0) if need is True else (got != need):
            fail(f"{what}: launch counts {launches}, want {want}")


def counted_run(what: str, fn):
    """``fn()`` with every launch count set to 0 just before it and read
    just after. Returns (its result, the counts)."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    print(f"examples {what}: launch_counts {launches}")
    return out, launches


def examples_path(seed: int, dev, eng, items, users, queries) -> dict:
    """The example twins (``repro_torch.examples``) through their
    ``run``, each with every launch count set to 0 just before it and read
    just after: quickstart for each of ``EX_PRESETS`` on the Netflix data
    and ``queries`` (reverse recall 1.0 against the oracle but for traced
    float ties; ``srp_hash`` = the build's one + chunks and
    ``hamming_nearest`` = tile steps for the sketch presets, neither in
    the query for the exact ones), update_stream, serve_async and
    serve_multitenant (``ex_multitenant``) at the Netflix scale (their own
    checks), reverse_recommend and serve_retrieval on two-tower at its
    published config (recall 1.0 traced; ``ip_topk``'s ids against
    ``torch.topk(torch.matmul(...))``'s but for traced ties; no new
    signature after the warm flush), and train_lm ``100m``
    (``ex_train_lm``). Then ``ip_topk`` and the dense ``hamming_scores``
    at the shapes these runs gave them, each against its plain version,
    and timed. Each model and engine is freed before the next run.
    Returns the kernels' entries and the phase's figures."""
    import torch
    from repro_torch.configs import base
    from repro_torch.core import metrics, sah
    from repro_torch.data import synthetic
    from repro_torch.engine import get_config
    from repro_torch.examples import (quickstart, reverse_recommend,
                                      serve_async, serve_retrieval,
                                      update_stream)
    from repro_torch.kernels import ops

    t_start = t_mark = time.perf_counter()
    parts, figures = {}, {}

    def mark(name):                 # host seconds of each run of the phase
        nonlocal t_mark
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = round(now - t_mark, 2)
        t_mark = now
        print(f"examples {name}: {parts[name]} s")

    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    users_unit = sah.unit_rows(users)

    # -- quickstart: every paper baseline and "exact" ---------------------
    steps, restore = chunk_counter()
    try:
        for method in EX_PRESETS:
            steps.update(chunks=0, tile_steps=0)
            out, launches = counted_run(f"quickstart {method}", lambda: (
                quickstart.run(items, users, queries, k=EX_K, method=method,
                               generator=torch.Generator().manual_seed(seed),
                               device=dev)))
            cfg = get_config(method)
            missed = traced_misses(
                f"quickstart {method}", items, users_unit, queries,
                out["predictions"], out["truth"], EX_K, cfg.tie_eps)
            rec = float(metrics.recall(out["predictions"],
                                       out["truth"]).min())
            sketch = cfg.scan == "sketch"
            launches_only(f"quickstart {method}", launches, {
                "srp_hash": 1 + (steps["chunks"] if sketch else 0),
                "hamming_nearest": steps["tile_steps"] if sketch else 0})
            print(f"examples quickstart {method}: {NQ} queries at "
                  f"k={EX_K}, build {out['build_seconds']:.3f} s, "
                  f"{out['ms_per_query']:.3f} ms/query, F1 mean "
                  f"{out['f1_mean']:.4f}, recall min {rec:.6f} ({missed} "
                  f"misses, all float ties), {steps['chunks']} chunks, "
                  f"{steps['tile_steps']} tile steps; funnel: "
                  f"{out['funnel'].format()}")
            figures[f"quickstart {method}"] = {
                "queries": NQ, "build_s": out["build_seconds"],
                "ms_per_query": out["ms_per_query"],
                "f1_mean": out["f1_mean"], "recall_min": rec,
                "chunks": steps["chunks"], "tile_steps": steps["tile_steps"],
                "launches": launches}
            del out
            torch.cuda.empty_cache()
            mark(f"quickstart {method}")
    finally:
        restore()

    # -- the artifact lifecycle under a live ReverseServer ----------------
    gen = torch.Generator().manual_seed(seed)
    promoted = synthetic.queries_from_items(gen, items, 4,
                                            top_frac=TOP_FRAC)
    pick = torch.randint(0, items.shape[0], (2, EX_INSERTS), generator=gen)
    trending = 0.65 * (items[pick[0].to(dev)] + items[pick[1].to(dev)])
    out, launches = counted_run("update_stream", lambda: update_stream.run(
        items, users, promoted, trending, k=EX_K, generator=gen,
        device=dev))
    launches_only("update_stream", launches,
                  {"srp_hash": True, "hamming_nearest": True})
    figures["update_stream"] = {
        "audiences_v1": out["audiences_v1"],
        "audiences_v2": out["audiences_v2"],
        "audience_v3": out["audience_v3"], "compiles": out["compiles"],
        "launches": launches}
    mark("update_stream")

    # -- the threaded runtime over the forward server ----------------------
    async_q = synthetic.queries_from_items(gen, items, EX_ASYNC_QUERIES)
    pick = torch.randint(0, items.shape[0], (2, 40), generator=gen)
    trending = 0.65 * (items[pick[0].to(dev)] + items[pick[1].to(dev)])
    out, launches = counted_run("serve_async", lambda: serve_async.run(
        items, users, async_q, trending, k=EX_K, generator=gen, device=dev))
    st = out["stats"]
    launches_only("serve_async", launches,
                  {"srp_hash": True, "hamming_scores": True})
    if st.compactions != 1 or st.failed:
        fail(f"serve_async: stats {st}")
    print(f"examples serve_async: p50 {out['p50_ms']:.3f} ms, compaction "
          f"{out['compaction_s']:.3f} s, {st.batches} runtime dispatches "
          f"(dense hamming_scores {launches['hamming_scores']})")
    figures["serve_async"] = {"p50_ms": out["p50_ms"],
                              "compaction_s": out["compaction_s"],
                              "batches": st.batches, "launches": launches}
    mark("serve_async")

    # -- two tenants on one pool -------------------------------------------
    figures["serve_multitenant"] = ex_multitenant(seed, dev, eng, items,
                                                  users, queries)
    mark("serve_multitenant")

    # -- two-tower embeddings at the published config ----------------------
    tt = base.get("two-tower-retrieval").make_config()
    ds = synthetic.PAPER_DATASETS["netflix"]
    out, launches = counted_run("reverse_recommend", lambda: (
        reverse_recommend.run(tt, steps=EX_RR_STEPS, n_items=ds.n_items,
                              m_users=ds.m_users, k=EX_K, seed=seed,
                              device=dev)))
    missed = traced_misses(
        "reverse_recommend", out["items"], out["users_unit"],
        out["queries"], out["predictions"], out["truth"], EX_K,
        out["tie_eps"])
    rec = float(metrics.recall(out["predictions"], out["truth"]).min())
    rq, uu = out["queries"], out["users_unit"]
    lib_ids = torch.topk(torch.matmul(rq, uu.T), EX_K).indices
    ties_rr = ip_tie_check(rq, uu, out["fwd_top"], lib_ids.to(torch.int32))
    launches_only("reverse_recommend", launches, {
        "srp_hash": True, "hamming_nearest": True, "ip_topk": 1})
    print(f"examples reverse_recommend: recall min {rec:.6f} ({missed} "
          f"misses, all float ties); forward ids equal torch.topk("
          f"torch.matmul(...))'s but for {ties_rr} float ties; overlaps "
          f"{out['overlaps']} of {EX_K}; losses {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}")
    figures["reverse_recommend"] = {
        "recall_min": rec, "overlaps": out["overlaps"],
        "audiences": out["audiences"], "seconds": out["seconds"],
        "launches": launches}
    rr_entry = topk_at("reverse_recommend", rq.contiguous(), uu, EX_K,
                       launches["ip_topk"])
    del out, rq, uu, lib_ids
    torch.cuda.empty_cache()
    mark("reverse_recommend")

    out, launches = counted_run("serve_retrieval", lambda: (
        serve_retrieval.run(tt, steps=EX_SR_STEPS, corpus=EX_SR_CORPUS,
                            batch=256, requests=EX_SR_REQUESTS, k=EX_SR_K,
                            seed=seed, device=dev)))
    u, cand = out["users"], out["cand_vecs"]
    lib_ids = torch.topk(torch.matmul(u, cand.T), EX_SR_K).indices
    ties_sr = ip_tie_check(u, cand, out["exact_ids"],
                           lib_ids.to(torch.int32))
    if out["compiles"] != out["compiles_warm"]:
        fail(f"serve_retrieval: {out['compiles'] - out['compiles_warm']} "
             f"new signatures after the warm flush")
    disp = 2 * EX_SR_REQUESTS // out["batch_size"]
    launches_only("serve_retrieval", launches, {
        "srp_hash": 1 + disp, "hamming_scores": disp, "ip_topk": 2})
    print(f"examples serve_retrieval: recall@{EX_SR_K} {out['recall']:.4f};"
          f" exact {out['exact_qps']:.1f} QPS, SAH {out['sah_qps']:.1f} QPS;"
          f" exact ids equal torch.topk(torch.matmul(...))'s but for "
          f"{ties_sr} float ties; {out['compiles']} signature(s), none "
          f"after the warm flush")
    figures["serve_retrieval"] = {
        "recall": out["recall"], "exact_qps": out["exact_qps"],
        "sah_qps": out["sah_qps"], "build_s": out["build_seconds"],
        "launches": launches}
    sr_entry = topk_at("serve_retrieval", u, cand, EX_SR_K,
                       launches["ip_topk"])
    del lib_ids
    art = out["engine"].artifact
    codes, proj_q = art.serving_codes()
    ucodes = ops.srp_hash(u[:out["batch_size"]].contiguous(), proj_q)
    ham_entry = dense_at("serve_retrieval", ucodes, codes,
                         launches["hamming_scores"])
    del out, u, cand, art, codes, ucodes
    torch.cuda.empty_cache()
    mark("serve_retrieval")

    # -- the LM trainer with a crash and a resume ---------------------------
    figures["train_lm"] = ex_train_lm(seed, dev)
    mark("train_lm")

    peak = torch.cuda.max_memory_allocated()
    print(f"examples phase: {time.perf_counter() - t_start:.1f} s host "
          f"({parts}), peak device memory {peak / 2**30:.2f} GiB")
    return {"peak_before": peak_before, "peak": peak, "parts": parts,
            "figures": figures,
            "ip_topk": {**rr_entry, **sr_entry}, "dense": ham_entry}


class _Window(Exception):
    """Ends a timed window of a reverse query's host loop."""


def ex_multitenant(seed: int, dev, eng, items, users, queries) -> dict:
    """serve_multitenant's ``run`` at the Netflix scale over ``queries`` at
    k = EX_MT_K from both tenants, without the blitz probes (its checks;
    traces_after_warmup 0 after live traffic; each prod ticket's users to
    scan, chunks and seconds), then the first EX_MT_PROBE_CHUNKS chunks of
    its first blitz probe through the f32 engine ``eng``'s host loop at
    the example's chunk, timed, beside the probes' users to scan. Returns
    its figures."""
    import torch
    from repro_torch.core import sah
    from repro_torch.examples import serve_multitenant as mt
    gen = torch.Generator().manual_seed(seed)
    out, launches = counted_run("serve_multitenant", lambda: mt.run(
        items, users, queries, items[:0], k=EX_MT_K, generator=gen,
        device=dev))
    if out["traces_after_warmup"] != 0 or out["traces_after_warmup_0"]:
        fail(f"serve_multitenant: traces_after_warmup "
             f"{out['traces_after_warmup']} after live traffic")
    launches_only("serve_multitenant", launches,
                  {"srp_hash": True, "hamming_nearest": True})
    lat, scan = out["prod_latency_ms"], out["prod_scan"]
    print(f"examples serve_multitenant: {out['tickets']} tickets, "
          f"{out['n_truncated']} truncated (trial), traces_after_warmup 0 "
          f"after live traffic; prod tickets (users to scan, chunks of "
          f"their dispatch, ms): "
          f"{[(n, c, round(t)) for (n, c), t in zip(scan, lat)]}")

    # -- a blitz probe's scan, timed over a window of its chunks ---------
    cfg = eng.config
    probes = mt.blitz_probes(items)
    plan = sah.rkmips_plan(eng.index, probes, EX_MT_K, tie_eps=cfg.tie_eps)
    lanes = plan.n_scan.tolist()
    one = sah.rkmips_plan(eng.index, probes[:1], EX_MT_K,
                          tie_eps=cfg.tie_eps)

    def each(counts):
        if counts["chunks"] == EX_MT_PROBE_CHUNKS:
            raise _Window

    counts, restore = chunk_counter(each)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sah.rkmips_execute(eng.index, one, EX_MT_K, n_cand=cfg.n_cand,
                           scan=cfg.scan, chunk=mt.CHUNK,
                           scan_precision=cfg.scan_precision)
    except _Window:
        pass
    finally:
        restore()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per = secs / max(counts["chunks"], 1)
    need = -(-lanes[0] // mt.CHUNK)
    print(f"examples serve_multitenant: the reference's {mt.BLITZ} blitz "
          f"probes leave {lanes} users to scan at k={EX_MT_K}, not served "
          f"here; probe 0's first {counts['chunks']} of its {need} chunks "
          f"of {mt.CHUNK} ({counts['tile_steps']} tile steps) took "
          f"{secs:.3f} s, {per * 1e3:.3f} ms a chunk: the whole probe "
          f"~{need * per:.1f} s at that rate")
    return {"truncated": out["n_truncated"], "prod_latency_ms": lat,
            "prod_scan": scan, "probe_lanes": lanes,
            "probe_window": {**counts, "seconds": secs},
            "probe_chunks": need, "launches": launches}


def ex_train_lm(seed: int, dev) -> dict:
    """train_lm's ``run`` on ``100m`` under deterministic algorithms: once
    whole, once crashed at EX_LM_FAIL_AT and resumed from its checkpoint
    (every parameter and optimizer state tensor bit for bit the whole
    run's, the resumed losses the whole run's; the loss falls; no kernel).
    Returns its figures."""
    import shutil
    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.examples import train_lm
    cfg = train_lm.MODELS["100m"]
    ck = ROOT / "build" / "example_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(steps=EX_LM_STEPS, batch=8, seq=256,
              ckpt_every=EX_LM_CKPT_EVERY, seed=seed, device=dev)
    whole, launches = counted_run("train_lm", lambda: deterministic(
        lambda: train_lm.run(cfg, **kw)))
    final = {n: p.detach().clone()
             for n, p in whole["model"].named_parameters()}
    final_opt = [t.clone() for t in tree_leaves(whole["state"].opt_state)]
    losses = whole["losses"]
    del whole
    try:
        deterministic(lambda: train_lm.run(cfg, ckpt_dir=str(ck),
                                           fail_at=EX_LM_FAIL_AT, **kw))
        fail("train_lm: the simulated failure did not happen")
    except RuntimeError as e:
        if "simulated worker failure" not in str(e):
            raise
    resumed, launches_r = counted_run("train_lm resumed", lambda: (
        deterministic(lambda: train_lm.run(cfg, ckpt_dir=str(ck), **kw))))
    shutil.rmtree(ck, ignore_errors=True)
    launches_only("train_lm", launches, {})
    launches_only("train_lm resumed", launches_r, {})
    if not losses[-1] < losses[0]:
        fail(f"train_lm: the loss did not fall ({losses[0]} -> "
             f"{losses[-1]})")
    differ = [n for n, p in resumed["model"].named_parameters()
              if not torch.equal(p, final[n])]
    opt_leaves = tree_leaves(resumed["state"].opt_state)
    opt_differ = len(opt_leaves) != len(final_opt) or not all(
        torch.equal(a, b) for a, b in zip(opt_leaves, final_opt))
    since = resumed["resumed_from"]
    if since is None or differ or opt_differ \
            or resumed["losses"] != losses[since:]:
        fail(f"train_lm: the resumed run differs from the uninterrupted "
             f"one in {len(differ)} parameters ({differ[:3]}), its "
             f"optimizer state differs: {opt_differ}")
    print(f"examples train_lm 100m: {cfg.n_params / 1e6:.1f}M parameters, "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f} over {EX_LM_STEPS} "
          f"steps; crashed at {EX_LM_FAIL_AT}, resumed from step {since}: "
          f"all {len(final)} parameters and {len(final_opt)} optimizer "
          f"state tensors bit for bit the uninterrupted run's; no kernel "
          f"launched")
    del resumed, final, final_opt
    torch.cuda.empty_cache()
    return {"first_loss": losses[0], "last_loss": losses[-1]}


def topk_at(prefix: str, q, items, k: int, launched: int) -> dict:
    """``ip_topk`` at a shape an example gave it: the merged answer and
    the kernel's per-split lists against their plain versions (one query
    at a time: the plain product of all of them would not fit), then
    timed beside its plain version and the library call."""
    import torch
    from repro_torch.kernels import ip_topk, ops, ref

    def plain(fn, *args):
        outs = [fn(q[i:i + 1], items, *args) for i in range(q.shape[0])]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    vals, ids = ops.ip_topk(q, items, k)
    pv, pi = plain(ref.ip_topk, k)
    if not torch.equal(ids, pi):
        fail(f"ip_topk at the {prefix} shape: {int((ids != pi).sum())} ids "
             f"differ from its plain version")
    err = float((vals - pv).abs().max())
    if err != 0.0:
        fail(f"ip_topk at the {prefix} shape: values differ from its plain "
             f"version by {err}")
    raw_v, raw_i = ip_topk.ip_topk_tiles(q, items, k)
    splits = raw_v.shape[1]
    part_v, part_i = plain(ref.ip_topk_partials, k, splits)
    if not (torch.equal(raw_i, part_i) and torch.equal(raw_v, part_v)):
        fail(f"ip_topk at the {prefix} shape: the kernel's per-split lists "
             f"differ from ref.ip_topk_partials")
    (nq, d), n = q.shape, items.shape[0]
    t = {"ms": device_ms(lambda: ops.ip_topk(q, items, k), 20),
         "kernel_only_ms": device_ms(
             lambda: ip_topk.ip_topk_tiles(q, items, k), 20),
         "plain_ms": device_ms(lambda: plain(ref.ip_topk, k), 1, replays=2),
         "library_ms": device_ms(
             lambda: torch.topk(torch.matmul(q, items.T), k), 20),
         "call_ms": call_ms(lambda: ops.ip_topk(q, items, k), 20)}
    t["bound_ms"], t["bound_by"] = bound(4 * (nq + n) * d + 8 * nq * k,
                                         2 * nq * n * d / FP32_FLOP_PER_S)
    shape = f"{(nq, d)}x{(n, d)}, k {k}"
    print(f"check ip_topk at the {prefix} shape {shape}: ids exact, values "
          f"bitwise, its {splits} per-split lists equal "
          f"ref.ip_topk_partials; time " + ", ".join(
              f"{key} {val:.6f}" if isinstance(val, float) else
              f"{key} {val}" for key, val in t.items()))
    out = {f"{prefix}_{key}": val for key, val in t.items()}
    out.update({f"{prefix}_launches": launched, f"{prefix}_shape": shape,
                f"{prefix}_max_abs_err": err, f"{prefix}_splits": splits,
                f"{prefix}_library_call":
                    f"torch.topk(torch.matmul(q, items.T), {k}), two calls"})
    return out


def dense_at(prefix: str, ucodes, codes, launched: int) -> dict:
    """The dense ``hamming_scores`` at a serving dispatch's shape, bitwise
    against its plain version, and timed."""
    from repro_torch.kernels import ops, ref
    err = codes_equal(f"hamming_scores at the {prefix} shape",
                      ops.hamming_scores(ucodes, codes),
                      ref.hamming_scores(ucodes, codes))
    (c, w), n = ucodes.shape, codes.shape[0]
    t = {"ms": device_ms(lambda: ops.hamming_scores(ucodes, codes), ITERS),
         "plain_ms": device_ms(lambda: ref.hamming_scores(ucodes, codes), 20),
         "call_ms": call_ms(lambda: ops.hamming_scores(ucodes, codes),
                            ITERS)}
    t["bound_ms"], t["bound_by"] = bound(4 * (c * w + n * w + c * n),
                                         3 * c * n * w / INT32_OP_PER_S)
    shape = f"{(c, w)}x{(n, w)}"
    print(f"check hamming_scores (dense) at the {prefix} shape {shape}: "
          f"exact; time " + ", ".join(f"{key} {val:.6f}" if isinstance(
              val, float) else f"{key} {val}" for key, val in t.items()))
    out = {f"{prefix}_{key}": val for key, val in t.items()}
    out.update({f"{prefix}_launches": launched, f"{prefix}_shape": shape,
                f"{prefix}_max_abs_err": err})
    return out


def srp_at(prefix: str, rows, proj, index_codes, launched: int,
           live=None) -> dict:
    """``srp_hash`` at a forward build's shape, bit for bit against its
    plain version and, in the rows ``live`` marks (all by default), the
    built index's codes, and timed."""
    import torch
    from repro_torch.kernels import ops, ref
    codes = ops.srp_hash(rows, proj)
    if live is None:
        live = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    if not torch.equal(codes[live], index_codes[live]):
        fail(f"srp_hash at the {prefix} build shape is not deterministic "
             f"against the built index's codes")
    err = codes_equal(f"srp_hash at the {prefix} build shape", codes,
                      ref.srp_hash(rows, proj))
    (n, d), b = rows.shape, proj.shape[1]
    t = {"ms": device_ms(lambda: ops.srp_hash(rows, proj), 20),
         "plain_ms": device_ms(lambda: ref.srp_hash(rows, proj), 1,
                               replays=1)}
    t["bound_ms"], t["bound_by"] = bound(4 * (n * d + d * b + n * b // 32),
                                         2 * n * d * b / FP32_FLOP_PER_S)
    t["no_fma_floor_ms"] = 2 * n * d * b / FP32_INSTR_PER_S * 1e3
    shape = f"{(n, d)}x{(d, b)}"
    print(f"check srp_hash at the {prefix} build shape {shape}: bit for "
          f"bit; time " + ", ".join(f"{key} {val:.6f}" if isinstance(
              val, float) else f"{key} {val}" for key, val in t.items()))
    out = {f"{prefix}_build_{key}": val for key, val in t.items()}
    out.update({f"{prefix}_build_launches": launched,
                f"{prefix}_build_shape": shape,
                f"{prefix}_build_max_abs_err": err})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic data and the build's draws")
    args = ap.parse_args()
    # a run cut at its time limit still shows the phase it reached
    sys.stdout.reconfigure(line_buffering=True)

    # the train phase runs under deterministic algorithms, whose cuBLAS
    # check reads this once, at the process's first matrix product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import RkMIPSEngine, get_config
    from repro_torch.core import metrics, sa_alsh, sah
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build, ip_topk, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # -- build the kernels from the checkout's sources ---------------------
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s "
          f"({', '.join(_build.KERNELS)} -> {_build.BUILD_DIR.name}/)")
    flash_build = flash_build_report()

    # -- data at the paper's Netflix scale ---------------------------------
    ds = synthetic.PAPER_DATASETS["netflix"]
    cfg = get_config("sah")
    gen = torch.Generator().manual_seed(args.seed)
    items, users = synthetic.recommendation_data(gen, ds.n_items, ds.m_users,
                                                 ds.d, device=dev)
    queries = synthetic.queries_from_items(gen, items, NQ,
                                           top_frac=TOP_FRAC)
    print(f"data: netflix n={ds.n_items} m={ds.m_users} d={ds.d} "
          f"nq={NQ} from the top {TOP_FRAC:.0%} by norm, "
          f"seed={args.seed}; config sah {cfg}")

    phases = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phases[name] = round(now - t_phase, 1)
        t_phase = now
        print(f"phase {name}: {phases[name]} s, {now - T_START:.1f} s since "
              f"start")

    # -- f32 reverse path, counted -------------------------------------------
    build_state = gen.get_state()
    ops.reset_launch_counts()
    eng = RkMIPSEngine(cfg).build(items, users, gen)
    after_build = dict(ops.launch_counts)
    results, steps = {}, {}
    for k in (10, 50):
        before = dict(ops.launch_counts)
        res = eng.query_batch(queries, k)
        results[k] = res
        ham = ops.launch_counts["hamming_nearest"] - before["hamming_nearest"]
        chunks = ops.launch_counts["srp_hash"] - before["srp_hash"]
        steps[k] = ham
        print(f"query f32 k={k}: {res.seconds * 1e3 / NQ:.3f} ms/query "
              f"({res.seconds:.3f} s for {NQ}); host loop: {chunks} "
              f"chunks, {ham} tile steps")
        print(f"  funnel: {res.funnel.format()}")
    launches = dict(ops.launch_counts)
    idx = eng.index
    print(f"build: {eng.build_seconds:.3f} s (partitions="
          f"{int(idx.alsh.n_parts)}, cone blocks={idx.n_blocks}, "
          f"m_pad={idx.n_users}, item tiles={idx.alsh.tile_max_norm.numel()})"
          f"; launches in build {after_build}")
    print(f"launch_counts (f32 reverse path): {launches}")
    for name in ("srp_hash", "hamming_nearest"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the f32 reverse path")
    if launches["hamming_scores"] != 0:
        fail("the f32 reverse path launched the dense hamming_scores")

    phase_done("f32 path")

    # -- answers against the exact oracle ------------------------------------
    users_unit = sah.unit_rows(users)
    for k, res in results.items():
        pred = res.predictions
        if pred.shape != (NQ, ds.m_users) or pred.dtype != torch.bool:
            fail(f"predictions have shape {tuple(pred.shape)} {pred.dtype}")
        truth = eng.oracle(queries, k)
        missed = traced_misses(f"k={k}", items, users_unit, queries, pred,
                               truth, k, cfg.tie_eps)
        rec = metrics.recall(pred, truth)
        f1 = metrics.f1_score(pred, truth)
        print(f"oracle k={k}: recall min {float(rec.min()):.6f} mean "
              f"{float(rec.mean()):.6f}; F1 mean {float(f1.mean()):.4f} "
              f"min {float(f1.min()):.4f}; audience {int(truth.sum())} true "
              f"/ {int(pred.sum())} predicted; misses {missed} "
              f"(all float ties: {missed})")

    phase_done("oracle")

    # -- the mapped baseline (the legacy per-query driver), counted ---------
    ops.reset_launch_counts()
    mapped = eng.query_batch_mapped(queries, 10)
    launches_m = dict(ops.launch_counts)
    batched = results[10]
    if not torch.equal(mapped.predictions, batched.predictions):
        n_diff = int((mapped.predictions != batched.predictions).sum())
        fail(f"query_batch_mapped k=10: {n_diff} predictions differ from "
             f"query_batch")
    for f in PLAN_COUNTERS + ("truncated",):
        if not torch.equal(getattr(mapped.stats, f),
                           getattr(batched.stats, f)):
            fail(f"query_batch_mapped k=10: {f} differs from query_batch")
    for name in ("srp_hash", "hamming_nearest"):
        if launches_m[name] <= 0:
            fail(f"kernel {name} was not launched on the mapped path")
    # both drivers on the warm engine, alternated (b m m b b m), so that
    # neither gains from running first
    secs = {"batched": [], "mapped": []}
    for name in ("batched", "mapped", "mapped", "batched", "batched",
                 "mapped"):
        call = (eng.query_batch if name == "batched"
                else eng.query_batch_mapped)
        secs[name].append(call(queries, 10).seconds)
    med = {n: statistics.median(v) * 1e3 / NQ for n, v in secs.items()}
    print(f"query mapped f32 k=10, warm engine, median of 3 alternated "
          f"runs each: mapped {med['mapped']:.3f} ms/query, query_batch "
          f"{med['batched']:.3f} ms/query (mapped/batched "
          f"{med['mapped'] / med['batched']:.3f}; host seconds mapped "
          f"{secs['mapped']}, batched {secs['batched']}); the counted run "
          f"{mapped.seconds:.3f} s for {NQ}; predictions and plan counters "
          f"bitwise query_batch's; per-query packing {mapped.funnel.chunks} "
          f"chunks, {mapped.funnel.tiles_scanned} tile visits (batched "
          f"{batched.funnel.chunks}, {batched.funnel.tiles_scanned}); "
          f"launch_counts {launches_m}")
    phase_done("mapped baseline")

    # -- int8 reverse path, counted ------------------------------------------
    cfg8 = cfg.replace(scan_precision="int8")
    eng8 = RkMIPSEngine(cfg8).build(items, users,
                                    torch.Generator().set_state(build_state))
    idx8 = eng8.index
    if not torch.equal(idx8.alsh.codes, idx.alsh.codes):
        fail("the int8 engine's index codes differ from the f32 engine's")
    ops.reset_launch_counts()
    results8 = {}
    for k in (10, 50):
        before = dict(ops.launch_counts)
        sa_alsh.reset_band_counts()
        res = eng8.query_batch(queries, k)
        results8[k] = res
        fused = ops.launch_counts["fused_scan"] - before["fused_scan"]
        passes = sa_alsh.band_counts["passes"]
        lanes = int(sa_alsh.band_counts["lanes"])
        print(f"query int8 k={k}: {res.seconds * 1e3 / NQ:.3f} ms/query "
              f"({res.seconds:.3f} s for {NQ}); {fused} fused_scan "
              f"launches for {steps[k]} f32 tile steps; band: {passes} "
              f"passes ({passes / max(fused, 1):.3f} per tile step), "
              f"{lanes} lanes ({lanes / max(fused, 1):.2f} per tile step)")
        print(f"  funnel: {res.funnel.format()}")
        if not torch.equal(res.predictions, results[k].predictions):
            n_diff = int((res.predictions != results[k].predictions).sum())
            fail(f"int8 k={k}: {n_diff} predictions differ from f32")
        if not torch.equal(res.stats.tiles_scanned,
                           results[k].stats.tiles_scanned):
            fail(f"int8 k={k}: tiles_scanned differ from f32")
        if fused != steps[k]:
            fail(f"int8 k={k}: {fused} fused_scan launches for {steps[k]} "
                 f"f32 tile steps (hamming_nearest launches)")
        print(f"  int8 == f32: predictions bitwise equal, tiles_scanned "
              f"equal, recall as f32 (1.0 but for traced float ties)")
    launches8 = dict(ops.launch_counts)
    print(f"launch_counts (int8 reverse path): {launches8}")
    for name in ("hamming_scores", "hamming_nearest"):
        if launches8[name] != 0:
            fail(f"the int8 path launched {name} {launches8[name]} times")
    for name in ("srp_hash", "fused_scan"):
        if launches8[name] <= 0:
            fail(f"kernel {name} was not launched on the int8 reverse path")

    phase_done("int8 path")

    # -- forward path, counted -----------------------------------------------
    pick = torch.randperm(ds.m_users,
                          generator=torch.Generator().manual_seed(args.seed))
    users_fwd = users[pick[:N_FWD].to(dev)].contiguous()
    ops.reset_launch_counts()
    fwd = eng.kmips(users_fwd, K_FWD)
    eng_ex = RkMIPSEngine(get_config("exact")).build(
        items, None, torch.Generator().manual_seed(args.seed))
    fwd_ex = eng_ex.kmips(users_fwd, K_FWD)
    launches_f = dict(ops.launch_counts)
    for name in ("srp_hash", "hamming_nearest"):
        if launches_f[name] <= 0:
            fail(f"kernel {name} was not launched on the forward path")
    # the exact forward answer (ops.ip_topk, the truth), counted on its own
    ops.reset_launch_counts()
    exact_vals, exact_ids = ops.ip_topk(users_fwd, items, K_FWD)
    launches_f["ip_topk"] = ops.launch_counts["ip_topk"]
    if launches_f["ip_topk"] != 1:
        fail("the exact forward answer did not launch ip_topk")
    print(f"launch_counts (forward path; ip_topk: the exact answer): "
          f"{launches_f}")
    n_items = ds.n_items
    for name, r in (("sah", fwd), ("exact", fwd_ex)):
        if (r.values.shape != (N_FWD, K_FWD) or r.ids.shape != (N_FWD, K_FWD)
                or not bool(torch.isfinite(r.values).all())):
            fail(f"kmips {name}: bad result {tuple(r.values.shape)}")
        if bool(((r.ids < 0) | (r.ids >= n_items)).any()):
            fail(f"kmips {name}: item ids outside [0, {n_items})")
        if bool((r.values[:, :-1] < r.values[:, 1:]).any()):
            fail(f"kmips {name}: values are not descending")
        recomputed = (users_fwd[:, None, :] * items[r.ids.long()]).sum(-1)
        if not torch.allclose(r.values, recomputed, rtol=1e-5, atol=1e-6):
            fail(f"kmips {name}: values are not the ids' inner products")
    hit = (fwd.ids[:, :, None] == exact_ids[:, None, :]).any(-1)
    recall = float(hit.sum(-1).float().mean()) / K_FWD
    print(f"kmips sah k={K_FWD}: {N_FWD} users in {fwd.seconds * 1e3:.2f} ms "
          f"({fwd.seconds * 1e6 / N_FWD:.2f} us/user), {fwd.tiles_visited} "
          f"of {eng.kmips_index.tile_max_norm.numel()} tiles; recall@10 "
          f"vs ip_topk {recall:.6f} (min per user "
          f"{float(hit.sum(-1).min()) / K_FWD:.1f})")
    ties_f = ip_tie_check(users_fwd, items, fwd_ex.ids, exact_ids)
    if not torch.allclose(fwd_ex.values, exact_vals, rtol=1e-5, atol=1e-6):
        fail("kmips exact values differ from ip_topk's")
    print(f"kmips exact k={K_FWD}: {fwd_ex.seconds * 1e3:.2f} ms, "
          f"{fwd_ex.tiles_visited} tiles; ids equal ip_topk's but for "
          f"{ties_f} positions, all float ties; values allclose")

    phase_done("forward path")

    # -- the mesh worlds' answers; the worlds run with the model-parallel
    # ones, after the single-device phases ---------------------------------
    worlds_dir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    mesh_parent = os.path.join(worlds_dir.name, "mesh_parent.pt")
    mesh_single = mesh_answers(args.seed, eng, results, users_fwd,
                               exact_vals, exact_ids, mesh_parent)
    phase_done("mesh answers")

    # -- artifact: save/load, a catalogue change, compact, counted -----------
    art_out = artifact_path(args.seed, eng, eng_ex, build_state, items, users,
                            queries, users_fwd, results, results8)
    phase_done("artifact")

    # -- serving: servers, runtimes and a gateway, counted -------------------
    serve_out = serving_path(args.seed, eng, queries, users_fwd, exact_ids,
                             items, results)
    phase_done("serving")

    # -- the example twins through their run(), counted -------------------
    ex_out = examples_path(args.seed, dev, eng, items, users, queries)
    phase_done("examples")

    # the single-device phases' answers that the model-parallel phase holds
    # its ranks against (~6 GB with the training's gradients: beside the
    # build, not in the temporary directory)
    mp_dir = tempfile.TemporaryDirectory(dir=ROOT / "build")

    # -- recsys serving at full width, counted; frees its tables -------------
    with torch.no_grad():           # the towers' parameters are trainable
        rec_out = recsys_path(args.seed, dev, mp_dir.name)
    phase_done("recsys")

    # -- LM serving path, counted ---------------------------------------------
    lm = lm_path(args.seed, dev, mp_dir.name)
    lm["flash_build"] = flash_build
    phase_done("lm path")

    # -- MoE LM serving (olmoe-1b-7b), then mistral-nemo-12b, counted -------
    moe_out = moe_path(args.seed, dev, mp_dir.name)
    # under deterministic algorithms, as the ranks train (without them the
    # bf16 gradient norm came out 14% below float32's, the ranks' within
    # 0.1% of it)
    deterministic(lambda: mp_moe_train_answers(mp_dir.name, args.seed, dev))
    phase_done("moe lm")
    nemo_out = nemo_path(args.seed, dev)
    phase_done("nemo lm")

    # -- training: the LM, recsys and GAT through the trainer, no kernel;
    # the LM saves the model-parallel phase's training answers -------------
    train_out = train_path(args.seed, dev, smi, mp_dir.name)
    phase_done("train")

    # -- the bf16 gradients of a frequent token, repaired -------------------
    bf16_repair(args.seed, dev)
    phase_done("bf16 repair")

    # -- kernels against their plain versions, at main-path inputs -----------
    n_top = cfg.n_top or 2 * cfg.k_max
    split = sah.split_items_by_norm(items, n_top)
    prep = sa_alsh.prepare_items(split.rest, b=cfg.b,
                                 max_partitions=cfg.max_partitions,
                                 tile=cfg.tile, transform=cfg.transform)
    rows = prep.transformed.contiguous()
    proj = idx.alsh.proj
    codes_k = ops.srp_hash(rows, proj)
    if not torch.equal(codes_k, idx.alsh.codes):
        fail("srp_hash is not deterministic against the built index codes")
    err_b = codes_equal("srp_hash at the build shape", codes_k,
                        ref.srp_hash(rows, proj))
    plan = sah.rkmips_plan(idx, queries, 10, tie_eps=cfg.tie_eps)
    lane_ids = plan.queue[:cfg.chunk] % idx.n_users
    chunk_users = idx.users[lane_ids].contiguous()
    qproj = proj[:-1]
    ucodes = ops.srp_hash(chunk_users, qproj)
    err_q = codes_equal("srp_hash at the query chunk", ucodes,
                        ref.srp_hash(chunk_users, qproj))
    tile_codes = idx.alsh.codes[:cfg.tile]
    ham_err = codes_equal("hamming_scores",
                          ops.hamming_scores(ucodes, tile_codes),
                          ref.hamming_scores(ucodes, tile_codes))
    tile_mask = idx.alsh.item_mask[:cfg.tile]
    near_args = (ucodes, tile_codes, tile_mask, cfg.n_cand)
    near_err = codes_equal("hamming_nearest", ops.hamming_nearest(*near_args),
                           ref.hamming_nearest(*near_args))
    near_args4k = (ucodes, idx.alsh.codes[:TILE_LARGE],
                   idx.alsh.item_mask[:TILE_LARGE], cfg.n_cand)
    codes_equal(f"hamming_nearest at {TILE_LARGE} rows",
                ops.hamming_nearest(*near_args4k),
                ref.hamming_nearest(*near_args4k))
    a8 = idx8.alsh
    fused_args = (ucodes, a8.codes[:cfg.tile], a8.item_mask[:cfg.tile],
                  a8.qitems[:cfg.tile], a8.qscale[:cfg.tile], chunk_users)
    cand_k, qips_k = ops.fused_scan(*fused_args, n_cand=cfg.n_cand)
    cand_p, qips_p = ref.fused_scan(*fused_args, cfg.n_cand)
    if not torch.equal(cand_k, cand_p):
        fail(f"fused_scan: {int((cand_k != cand_p).sum())} candidates "
             f"differ from its plain version")
    fused_err = float((qips_k - qips_p).abs().max())
    if fused_err != 0.0:
        fail(f"fused_scan qips differ from its plain version by {fused_err}")
    fused_args4k = (ucodes, a8.codes[:TILE_LARGE],
                    a8.item_mask[:TILE_LARGE], a8.qitems[:TILE_LARGE],
                    a8.qscale[:TILE_LARGE], chunk_users)
    for got, want in zip(ops.fused_scan(*fused_args4k, n_cand=cfg.n_cand),
                         ref.fused_scan(*fused_args4k, cfg.n_cand)):
        if not torch.equal(got, want):
            fail(f"fused_scan at {TILE_LARGE} rows differs from its plain "
                 f"version")
    plain_vals, plain_ids = ref.ip_topk(users_fwd, items, K_FWD)
    if not torch.equal(exact_ids, plain_ids):
        fail(f"ip_topk: {int((exact_ids != plain_ids).sum())} ids differ "
             f"from its plain version")
    ip_err = float((exact_vals - plain_vals).abs().max())
    if ip_err != 0.0:
        fail(f"ip_topk values differ from its plain version by {ip_err}")
    raw_vals, raw_ids = ip_topk.ip_topk_tiles(users_fwd, items, K_FWD)
    splits = raw_vals.shape[1]
    part_vals, part_ids = ref.ip_topk_partials(users_fwd, items, K_FWD,
                                               splits)
    if not (torch.equal(raw_ids, part_ids)
            and torch.equal(raw_vals, part_vals)):
        fail("ip_topk: the kernel's per-split lists differ from "
             "ref.ip_topk_partials")
    torch.cuda.synchronize()
    print(f"check srp_hash build rows {tuple(rows.shape)} x "
          f"{tuple(proj.shape)} and query chunk {tuple(chunk_users.shape)} x "
          f"{tuple(qproj.shape)}: codes equal ref.srp_hash bit for bit "
          f"(torch.equal; 0 flipped bits)")
    print(f"check hamming_scores (dense) {tuple(ucodes.shape)} x "
          f"{tuple(tile_codes.shape)}: exact (max abs err 0)")
    print(f"check hamming_nearest {tuple(ucodes.shape)} lanes x tile 0 "
          f"({cfg.tile} rows) and the first {TILE_LARGE} rows, n_cand "
          f"{cfg.n_cand}: rows equal ref.hamming_nearest exactly")
    print(f"check fused_scan {tuple(chunk_users.shape)} lanes x tile 0 "
          f"({cfg.tile} rows) and the first {TILE_LARGE} rows, n_cand "
          f"{cfg.n_cand}: cand exact, qips bitwise (max abs err 0)")
    print(f"check ip_topk {tuple(users_fwd.shape)} x {tuple(items.shape)}, "
          f"k={K_FWD}: ids exact, values bitwise (max abs err 0); the "
          f"kernel's {splits} per-split lists equal ref.ip_topk_partials "
          f"bitwise")

    phase_done("kernel checks")

    # -- times -------------------------------------------------------------
    it = ITERS
    ham_ms = device_ms(lambda: ops.hamming_scores(ucodes, tile_codes), it)
    ham_plain = device_ms(lambda: ref.hamming_scores(ucodes, tile_codes), it)
    ham_call = call_ms(lambda: ops.hamming_scores(ucodes, tile_codes), it)
    near_ms = device_ms(lambda: ops.hamming_nearest(*near_args), it)
    near_plain = device_ms(lambda: ref.hamming_nearest(*near_args), 20)
    near_call = call_ms(lambda: ops.hamming_nearest(*near_args), it)
    near4k_ms = device_ms(lambda: ops.hamming_nearest(*near_args4k), it)

    def unfused():             # the route hamming_nearest replaced
        dist = ops.hamming_scores(ucodes, tile_codes)
        dist = torch.where(tile_mask[None, :], dist, ref.BIG_HAMMING)
        return ref.nearest_rows(dist, cfg.n_cand)

    if not torch.equal(unfused(), ops.hamming_nearest(*near_args)):
        fail("hamming_nearest differs from the route it replaced")
    unfused_ms = device_ms(unfused, 20)
    near_n, unfused_n = kernel_launches(lambda: ops.hamming_nearest(
        *near_args)), kernel_launches(unfused)
    srp_ms = device_ms(lambda: ops.srp_hash(chunk_users, qproj), it)
    srp_plain = device_ms(lambda: ref.srp_hash(chunk_users, qproj), 20)
    srp_call = call_ms(lambda: ops.srp_hash(chunk_users, qproj), it)
    srpb_ms = device_ms(lambda: ops.srp_hash(rows, proj), it)
    srpb_plain = device_ms(lambda: ref.srp_hash(rows, proj), 20)
    fused_ms = device_ms(
        lambda: ops.fused_scan(*fused_args, n_cand=cfg.n_cand), it)
    fused_plain = device_ms(
        lambda: ref.fused_scan(*fused_args, cfg.n_cand), 20)
    fused_call = call_ms(
        lambda: ops.fused_scan(*fused_args, n_cand=cfg.n_cand), it)
    fused4k_ms = device_ms(
        lambda: ops.fused_scan(*fused_args4k, n_cand=cfg.n_cand), it)
    ipk_pass = device_ms(
        lambda: ip_topk.ip_topk_tiles(users_fwd, items, K_FWD), 20)
    ipk_ms = device_ms(lambda: ops.ip_topk(users_fwd, items, K_FWD), 20)
    ipk_call = call_ms(lambda: ops.ip_topk(users_fwd, items, K_FWD), 20)
    ipk_plain = device_ms(lambda: ref.ip_topk(users_fwd, items, K_FWD), 2,
                          replays=3)
    ipk_lib = device_ms(lambda: torch.topk(torch.matmul(users_fwd, items.T),
                                           K_FWD), 20)

    c, w = ucodes.shape
    t = tile_codes.shape[0]
    ham_bound, ham_by = bound(4 * (c * w + t * w + c * t),
                              3 * c * t * w / INT32_OP_PER_S)

    # hamming_nearest: codes and mask in, (C, n_cand) rows out; the
    # distances' 3 integer ops per (lane, row, word), the selection not
    # counted
    def near_bound_of(t):
        return bound(4 * (c * w + t * w + c * cfg.n_cand) + t,
                     3 * c * t * w / INT32_OP_PER_S)

    near_bound, near_by = near_bound_of(t)
    near4k_bound, _ = near_bound_of(TILE_LARGE)

    def srp_bound(x, p):
        (n, d), b = x.shape, p.shape[1]
        return bound(4 * (n * d + d * b + n * b // 32),
                     2 * n * d * b / FP32_FLOP_PER_S)

    def srp_floor(x, p):       # a separate multiply and add per term
        return 2 * x.shape[0] * x.shape[1] * p.shape[1] / FP32_INSTR_PER_S \
            * 1e3

    srp_bnd, srp_by = srp_bound(chunk_users, qproj)
    srpb_bnd, srpb_by = srp_bound(rows, proj)
    srp_flr, srpb_flr = srp_floor(chunk_users, qproj), srp_floor(rows, proj)
    d = ds.d
    nc = cfg.n_cand
    # fused_scan: codes, mask, int8 rows, scales and users in, cand + qips
    # out; 3 integer ops per (lane, row, word) for the distances and a
    # multiply and an add per (lane, candidate, dim) for the scores
    def fused_bound_of(t):
        return bound(
            4 * (c * w + t * w + t + c * d) + t * d + 8 * c * nc,
            3 * c * t * w / INT32_OP_PER_S
            + 2 * c * nc * d / FP32_FLOP_PER_S)

    fused_bound, fused_by = fused_bound_of(t)
    fused4k_bound, _ = fused_bound_of(TILE_LARGE)
    nq_f, n_i = users_fwd.shape[0], items.shape[0]
    ipk_bound, ipk_by = bound(4 * (nq_f + n_i) * d + 8 * nq_f * K_FWD,
                              2 * nq_f * n_i * d / FP32_FLOP_PER_S)
    # the floor of the bitwise contract: a separate multiply and add per
    # term, each one FP32 lane-instruction, 33.5 T of them a second
    ipk_floor = 2 * nq_f * n_i * d / FP32_INSTR_PER_S * 1e3
    print(f"time hamming_nearest {tuple(ucodes.shape)}x"
          f"{tuple(tile_codes.shape)}, n_cand {cfg.n_cand}: kernel "
          f"{near_ms:.5f} ms (device), {near_call:.5f} ms per call from "
          f"Python; plain {near_plain:.5f} ms; bound {near_bound:.6f} ms "
          f"({near_by}); at {TILE_LARGE} rows {near4k_ms:.5f} ms (bound "
          f"{near4k_bound:.6f} ms); the route it replaced (dense kernel + "
          f"torch.where + ref.nearest_rows, several calls) {unfused_ms:.5f} "
          f"ms; device launches a tile step {near_n} against {unfused_n} "
          f"(profiler); no single PyTorch call computes it")
    print(f"time hamming_scores (dense) {tuple(ucodes.shape)}x"
          f"{tuple(tile_codes.shape)}: kernel {ham_ms:.5f} ms (device), "
          f"{ham_call:.5f} ms per call "
          f"from Python; plain {ham_plain:.5f} ms; bound {ham_bound:.6f} ms "
          f"({ham_by}); no single PyTorch call computes it")
    print(f"time srp_hash query chunk {tuple(chunk_users.shape)}: kernel "
          f"{srp_ms:.5f} ms (device), {srp_call:.5f} ms per call from "
          f"Python; plain {srp_plain:.5f} ms; bound {srp_bnd:.6f} ms "
          f"({srp_by}), no-FMA floor {srp_flr:.6f} ms; no single PyTorch "
          f"call computes it")
    print(f"time srp_hash build rows {tuple(rows.shape)}: kernel "
          f"{srpb_ms:.5f} ms, plain {srpb_plain:.5f} ms, bound "
          f"{srpb_bnd:.6f} ms ({srpb_by}: 67 TFLOP/s, FMA = 2), no-FMA "
          f"floor {srpb_flr:.6f} ms (two FP32 instructions a term at 33.5 "
          f"T/s)")
    print(f"time fused_scan {tuple(chunk_users.shape)} lanes x {t} rows: "
          f"kernel {fused_ms:.5f} ms (device), {fused_call:.5f} ms per call "
          f"from Python; plain {fused_plain:.5f} ms; bound "
          f"{fused_bound:.6f} ms ({fused_by}); at {TILE_LARGE} rows "
          f"{fused4k_ms:.5f} ms (bound {fused4k_bound:.6f} ms); no single "
          f"PyTorch call computes it")
    print(f"time ip_topk {tuple(users_fwd.shape)} x {tuple(items.shape)} "
          f"k={K_FWD}: ops.ip_topk (kernel + merge of {splits} splits) "
          f"{ipk_ms:.5f} ms (device), the kernel alone {ipk_pass:.5f} ms, "
          f"{ipk_call:.5f} ms per call from Python; plain {ipk_plain:.5f} "
          f"ms; bound {ipk_bound:.6f} ms ({ipk_by}: 67 TFLOP/s, FMA = 2), "
          f"no-FMA floor {ipk_floor:.6f} ms (two FP32 instructions a term "
          f"at 33.5 T/s); library torch.topk(torch.matmul(q, items.T), "
          f"10), two calls, {ipk_lib:.5f} ms")
    for name in ("hamming_scan", "srp_hash", "ip_topk", "fused_scan"):
        print(f"ptxas {name}: " + "; ".join(
            line.split(":", 1)[-1].strip()
            for line in _build.build_log(name).splitlines()
            if "Used" in line or "spill" in line or "stack" in line))
    flash_entry = flash_kernel_entry(lm, args.seed, dev)
    qwen_tp_entry = flash_tp_entry("qwen3-0.6b", lm["model"], lm["prompts"],
                                   MP_TP)
    qwen_tp_entry["row_parallel"] = row_parallel_times(
        lm["model"], lm["prompts"], MP_TP)
    phase_done("kernel times")
    profile_query(eng, queries, 10)
    profile_query(eng8, queries, 10)
    phase_done("profiles")

    # the worlds and the cells are reckoned for the card less what this
    # process holds: let the engines, the Netflix users and the LM go first
    del eng, eng8, eng_ex, idx, idx8, a8, users, lm["model"]
    torch.cuda.empty_cache()

    # -- the gloo worlds side by side: model parallelism (1, 2) and (2, 2),
    # the cells under a mesh in (1, 2), then the mesh worlds of 2 and 3
    # ranks; the mesh dry runs beside them on the host ---------------------
    from repro_torch.launch import dryrun
    dry_dir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    dry = start_mesh_dryruns(dry_dir.name)
    zero1_answers(mp_dir.name, args.seed, dev)
    worlds_out = worlds_path(args.seed, mp_dir.name, worlds_dir.name,
                             mesh_parent, mesh_single, dryrun.FIT_BYTES)
    mp_worlds, mc_ranks = worlds_out["mp"], worlds_out["cells"]
    mesh_out = worlds_out["mesh"]
    mp_dir.cleanup()
    worlds_dir.cleanup()
    finish_mesh_dryruns(dry, dry_dir.name)
    dry_dir.cleanup()
    phase_done("worlds")

    # -- the cell catalogue through the dry run, counted -----------------
    cells_out = cells_path(args.seed, dev, ROOT / "build" / "cells")
    phase_done("cells")
    peak = max(cells_out["peak_before"], cells_out["peak"],
               lm["peak_before"], art_out["peak_before"],
               moe_out["peak_before"], moe_out["peak"],
               nemo_out["peak_before"], nemo_out["peak"],
               serve_out["peak_before"], rec_out["peak_before"],
               rec_out["peak"], train_out["peak_before"], train_out["peak"],
               ex_out["peak_before"], ex_out["peak"],
               torch.cuda.max_memory_allocated())
    print(f"peak device memory: {peak / 2**30:.2f} GiB")

    # the model-parallel phase's launches, a rank, by world
    def mp_launches(key, name, worlds=MP_WORLDS):
        return {str(shape): [r[key].get(name, 0) for r in mp_worlds[shape]]
                for shape in worlds}

    flash_entry["launches_mp"] = mp_launches("lm_prefill_launches",
                                             "flash_attention")

    def mc_launches(key, name):
        """The mesh cells' launches, a rank."""
        return [r[key].get(name, 0) for r in mc_ranks]

    flash_entry["launches_mesh_cells"] = mc_launches("pf_launches",
                                                     "flash_attention")
    moe_out["entry"]["launches_mp"] = mp_launches(
        "moe_prefill_launches", "flash_attention", (MP_MOE_WORLD,))
    for entry, key, worlds in ((qwen_tp_entry, "lm_prefill_launches",
                                MP_WORLDS),
                               (moe_out["tp_entry"], "moe_prefill_launches",
                                (MP_MOE_WORLD,))):
        entry["launches_mp"] = mp_launches(key, "flash_attention", worlds)
        entry["launches"] = mp_worlds[worlds[0]][0][key]["flash_attention"]
        entry["launches_wgmma"] = mp_worlds[worlds[0]][0][key][
            "flash_attention_wgmma"]
        entry["launches_are"] = "a rank, in the model-parallel prefill"

    kernels = [
        {"name": "srp_hash", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/srp_hash.cu",
         "replaces": "src/repro/kernels/srp_hash.py:41",
         "launches": launches["srp_hash"], "max_abs_err": err_q,
         "ms": srp_ms, "plain_ms": srp_plain, "bound_ms": srp_bnd,
         "bound_by": srp_by, "library_ms": None, "call_ms": srp_call,
         "shape": f"{tuple(chunk_users.shape)}x{tuple(qproj.shape)}",
         "no_fma_floor_ms": srp_flr, "build_shape_ms": srpb_ms,
         "build_shape_plain_ms": srpb_plain,
         "build_shape_bound_ms": srpb_bnd,
         "build_shape_no_fma_floor_ms": srpb_flr,
         "build_shape_max_abs_err": err_b,
         "launches_int8_path": launches8["srp_hash"],
         "launches_forward_path": launches_f["srp_hash"],
         "launches_mapped_path": launches_m["srp_hash"],
         "launches_mesh_path": mesh_out["launches"].get("srp_hash", 0),
         "launches_mesh_serving": mesh_out["serve_launches"].get(
             "srp_hash", 0),
         "launches_cells_path": cells_out["cells"][
             "two-tower-retrieval/retrieval_cand_sah"]["launches"][
             "srp_hash"],
         "launches_mp_retrieval": mp_launches("tt_launches", "srp_hash"),
         "launches_mesh_cells": mc_launches("sah_launches", "srp_hash"),
         **serve_out["srp"], **rec_out["srp"]},
        {"name": "hamming_nearest", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming_scan.cu",
         "replaces": "src/repro/kernels/hamming_scan.py:36",
         "launches": launches["hamming_nearest"], "max_abs_err": near_err,
         "ms": near_ms, "plain_ms": near_plain, "bound_ms": near_bound,
         "bound_by": near_by, "library_ms": None, "call_ms": near_call,
         "shape": f"{tuple(ucodes.shape)}x{tuple(tile_codes.shape)}, "
                  f"n_cand {cfg.n_cand}",
         "replaced_route_ms": unfused_ms, "launches_a_step": near_n,
         "replaced_route_launches_a_step": unfused_n,
         "replaced_route": "hamming_scores + torch.where + "
                           "ref.nearest_rows, several calls",
         "rows_4096_ms": near4k_ms, "rows_4096_bound_ms": near4k_bound,
         "launches_forward_path": launches_f["hamming_nearest"],
         "launches_mesh_path": mesh_out["launches"].get("hamming_nearest",
                                                        0),
         "launches_mesh_serving": mesh_out["serve_launches"].get(
             "hamming_nearest", 0),
         "launches_mapped_path": launches_m["hamming_nearest"],
         "dense_hamming_scores": {
             "launches": serve_out["dense"]["serving_launches"],
             "launches_reverse_and_kmips_paths": launches["hamming_scores"]
             + launches8["hamming_scores"] + launches_f["hamming_scores"],
             "launches_mesh_path": mesh_out["launches"].get(
                 "hamming_scores", 0),
             "launches_mesh_serving": mesh_out["serve_launches"].get(
                 "hamming_scores", 0),
             "launches_cells_path": cells_out["cells"][
                 "two-tower-retrieval/retrieval_cand_sah"]["launches"][
                 "hamming_scores"],
             "launches_mp_retrieval": mp_launches("tt_launches",
                                                  "hamming_scores"),
             "launches_mesh_cells": mc_launches("sah_launches",
                                                "hamming_scores"),
             "max_abs_err": ham_err, "ms": ham_ms, "plain_ms": ham_plain,
             "bound_ms": ham_bound, "bound_by": ham_by, "call_ms": ham_call,
             "library_ms": None, **serve_out["dense"],
             **rec_out["dense"], **ex_out["dense"]}},
        {"name": "fused_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_scan.cu",
         "replaces": "src/repro/kernels/fused_scan.py:113",
         "launches": launches8["fused_scan"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain, "bound_ms": fused_bound,
         "bound_by": fused_by, "library_ms": None, "call_ms": fused_call,
         "shape": f"{tuple(chunk_users.shape)}x{t} rows, n_cand {nc}",
         "rows_4096_ms": fused4k_ms, "rows_4096_bound_ms": fused4k_bound,
         "launches_mesh_path": mesh_out["launches"].get("fused_scan", 0),
         "launches_mesh_serving": mesh_out["serve_launches"].get(
             "fused_scan", 0)},
        {"name": "ip_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ip_topk.cu",
         "replaces": "src/repro/kernels/ip_topk.py:55",
         "launches": launches_f["ip_topk"], "max_abs_err": ip_err,
         "ms": ipk_ms, "plain_ms": ipk_plain, "bound_ms": ipk_bound,
         "bound_by": ipk_by, "library_ms": ipk_lib,
         "library_call": "torch.topk(torch.matmul(q, items.T), 10), two "
                         "calls", "timed": "ops.ip_topk: kernel + merge",
         "kernel_only_ms": ipk_pass, "no_fma_floor_ms": ipk_floor,
         "splits": splits, "call_ms": ipk_call,
         "shape": f"{tuple(users_fwd.shape)}x{tuple(items.shape)}, k "
                  f"{K_FWD}", **rec_out["ip_topk"], **ex_out["ip_topk"]},
        flash_entry, moe_out["entry"], nemo_out["entry"],
        cells_out["flash"], qwen_tp_entry, moe_out["tp_entry"],
    ]
    print(f"phases (host s): {phases}; total "
          f"{time.perf_counter() - T_START:.1f} s since start")
    print(f"kernels: {json.dumps([k['name'] for k in kernels])}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


T_START = time.perf_counter()

if __name__ == "__main__":
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
