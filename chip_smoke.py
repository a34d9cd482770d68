#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`codegraph_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --phases 0,1     # build + kernel checks only
    python3 chip_smoke.py --phases 0,4,5   # the int8 tier only
    python3 chip_smoke.py --phases 0,1,6,7 # the IVF tiers (K8) only
    python3 chip_smoke.py --phases 0,8     # the default configuration only
    python3 chip_smoke.py --phases 0,9     # the served path (MCP server, agents, CLI) only
    python3 chip_smoke.py --phases 0,10    # the rest of the serving surface only
    python3 chip_smoke.py --phases 0,11    # encoder and cross-encoder training only
    python3 chip_smoke.py --phases 0,12    # the shared-memory hand-off only
    python3 chip_smoke.py --phases 0,13,14 # the parallel/ slice (an 8-shard mesh on one card)
    python3 chip_smoke.py --phases 0,1,3   # the kernels, checked and timed at real size (K4tc, K4r too)
    python3 chip_smoke.py --phases 0,15    # the bf16 main path (K1tc, K2tc) only
    python3 chip_smoke.py --phases 0,16    # the card's pytest cases (tests/test_torch_card.py)
    python3 chip_smoke.py --phases 0,1,17  # every embedding width: the ragged routes, main path at D=100
    python3 chip_smoke.py --phases 0,5     # the int8 tier at 10M rows; K5r, K6r at 760, 764, 765

Phases, each printing one JSON object per line as it ends:

  0  card name and power limit, torch and nvcc versions; builds the CUDA
     sources from csrc/ (flat_topk.cu, flat_topk_tc.cu, flat_topk_k1tc.cu,
     int8_topk.cu, ivfpq_adc.cu and the host helper ivf_spill.cu, one nvcc
     each, in parallel) and, beside them, the host library csrc/cghost.cpp
     (g++ -march=native), and prints the build seconds, the g++ version,
     the host CPU's model and the ptxas line (registers, spills) of every
     kernel instance.
  1  every kernel against its plain PyTorch version on the card. K1, K2
     and K3: f32 and bf16 corpora up to 131,072 x 768, k in {1, 10, 30,
     100, 300, 1024}, K2-K4 at B = 20, 31 and 32 (a 32-row query tile), 33,
     40 and 64 (a 64-row tile) and 70, 96, 256 and 1000 (partial 128-row
     tiles); over bf16 rows K1 runs K1tc and K2 and K3 run K2tc with bf16
     queries and K2tc3 with f32 ones (the tensor cores; f32 queries as
     three bf16 pieces), each bf16 case run again with the same queries
     widened to f32; K2tc and K2tc3 are held as well at B in {32, 33, 64,
     65, 96, 128, 129, 255, 256, 1000} x every k at D = 768, at D in {8,
     64, 200, 1024, 1536} (depths not a multiple of 64, resident and
     streamed query tiles), K3 at 64, 129 and 256, and K1tc with both
     query dtypes at B in {1, 2, 5, 8, 9, 16, 17, 24, 31, 32, 40} x every
     k at D = 768 and at the other depths, over a 131,072-row corpus, a
     ragged N with duplicate rows (ties inside and across tiles) and a
     filter, and 200 rows with 150 live; each call must launch its route
     once and no other kernel. K1tc, K2tc3 and K4tc3 under f32 queries over
     one-hot bf16 rows (each score one query element, whatever the order
     of the sums) at D = 768 and 200: scores equal to the plain version's
     bit for bit, so a kernel that dropped a piece would fail. K5,
     K6 and K7: int8 corpora of the same sizes, k in {1, 10,
     100, 300}, with an all-zero row (scale 0) and rows of +-127 everywhere
     (an int8 wrap would show), K6 at B = 33, 64 (the 64-row tile), 65,
     96, 128, 129, 255, 256 and 1000 (128-row tiles), K7 at 64, 96, 129
     and 256, and K6 at D = 100 (not a multiple of 16: the ragged-row
     producer's instance, K6r), its scores equal to the plain version's
     bit for bit. Every embedding width: K1-K3 over f32 rows and bf16 rows
     (bf16 and f32 queries) and K5-K7 over int8 rows at D in {1, 3, 25,
     50, 100, 300, 760, 764, 765, 1000}, and with the base one element off
     16 bytes at 100, 765 and 1000, over 10,007 rows (duplicates, 1%
     tombstones, a filter), B in {1, 9, 31, 33, 64, 65, 129}, k in {1, 10,
     100, 300}: each call launches the route the rules name (K1r, K2r;
     K1tcr, K2tcr, K2tc3r; K5r; K6r; or the 16-byte and TMA instances),
     once; K1tcr and K2tc3r over one-hot rows at D = 100 and 765 bit for
     bit. K5r's own family (K5R_*): int8 rows of width 1, 3, 25, 101 and
     765 at bases 0-3 bytes past 16, and 765 as the tail of its storage,
     over 10,007 rows, B in {1, 5, 8}, k in {1, 100, 300, 1024}, scores bit
     for bit. Both: a
     ragged N, 1% tombstones, an
     extra_bias filter, k above the live count, duplicate rows (exact
     ties), batches on both sides of 32. K4: K2's cases on xt = x.T (an f32
     xt of 100,003 columns runs K4r, 4-byte pieces); over
     a bf16 xt with N % 8 == 0 (and 100,008 columns with duplicate rows
     and a filter) K4tc with bf16 queries and K4tc3 with f32 ones, over
     100,003 columns K4tcr and K4tc3r (the ragged-row producer); K4tc and
     K4tc3 are held as well at B in {33, 64, 65, 129, 1000} x k in {1, 30,
     300, 1024} over xt of depths 36 (q padded to 40), 200 and 1536, and
     K4tc3 over one-hot rows bit for bit; K4tcr and K4tc3r at B in {33,
     65, 129} x k in {1, 30, 300, 1024} over xt of N in {297, 300, 302,
     1001, 5000, 5003, 100003} (8- and 4-byte pieces, realigned words) and
     bases 2, 4 and 8 bytes past 16 (K4TCR_XT), the same values as an f32
     xt (bases 4, 8 and 16 bytes past 16) under f32 queries on K4r, or K4
     where N % 4 == 0 at an aligned base, and K4tc3r over one-hot rows as
     xt bit for bit. K8:
     synthetic IVF-PQ cells filled to random depths (the fills passed as
     extents, and once not), m in {6, 16, 96}, ksub in {16, 256}, nprobe in
     {1, 8, 32, 64, nlist}, k from 1 to 20,000 (above the live probed
     slots, above pass 2's shared memory: a pairwise merge in device
     memory), 1% tombstones, duplicate slots (exact ties), one cell probed
     by every query of a batch of up to 600, and extents outside [0, cap]
     (clipped); the shared-memory plan against index/ivfpq.py; and the
     compiled spill
     placement against the Python loop on overflowing cells. The host
     library against its plain versions (the Python loops): the padded
     adjacency of 20,000 nodes and 80,000 edges (hubs, tied weights),
     trigram preselection of 20 targets over 19,010 symbols (ten tied for
     eight places, one target without a candidate), BM25 over 100,000 docs
     (five queries, top 200), each timed. Fails on any id mismatch outside
     ties.
  2  the main path: CodeGraph.open(<copy of codegraph_tpu/>, device="cuda")
     with the hash provider at D=768, .index(), .search() for 5 queries
     (checked against the same snapshot searched on the CPU), then 64
     concurrent queries through QueryService (checked against single
     queries). Prints the counts, the kernels' launch counters and the host
     library's call counters (padded adjacency, trigram preselection, BM25:
     each must be called), the resolve stage's seconds, the first and
     second search's ms by part (query embedding, vector search, BM25, the
     graph boost and in it the boost table, the rest), the card and the
     host CPU; then the host library alone
     at real size: padded adjacency over 1,000,000 nodes and 4,000,000
     edges, BM25 over phase 1's 100,000 docs beside its plain version.
  3  real size: FlatIndex of 1,000,000 x 768 rows, f32 then bf16, made on
     the card from a seeded generator, 1% tombstoned; K1 (f32) and K1tc
     (bf16 rows, bf16 and f32 queries) at B=1 and 8, k=30 and 300; K2
     (f32) at B=32 and 64 (QueryService's bucket), k=30 and 300; K2, K3 and
     K4 (f32; K4 on xt = x.T) at B=256 and 1024, k=30, 100 and 300; K2tc
     (bf16 queries, through K2's wrapper) at B=64, 256 and 1024, k=30, 100
     and 300, and through K3's at B=1024, k=100; K2tc3 (f32 queries over
     the bf16 rows) at B=64, 256 and 1024, k=30 and 300; K4tc and K4tc3
     (K4 over xt = x.T of the bf16 rows, bf16 and f32 queries) at the same
     shapes, and K4tc at B=1024, k=100:
     median kernel ms over 7 batches (CUDA events), the plain version's
     ms, a chunked matmul + topk yardstick (library_ms, checked against;
     for bf16 queries the tensor-core torch.mm(out_dtype=f32), beside the
     f32 one; for K4tc and K4tc3 on xt's chunks), the bound (f32 queries
     over bf16 rows: three bf16 tensor-core products, or the bytes) and,
     for K2tc, K2tc3, K4tc and K4tc3, the bytes their blocks read by the
     plan. Then the ragged routes at widths no 16-byte piece fits: 1M x
     765 f32 (K1r at B=1 and 8, K2r at 64, 256, 1024) beside K1 and K2 over
     1M x 764 f32 (16-byte pieces) and 1M x 764 bf16 (K1tcr at B=1 and 8, both
     query dtypes; K2tcr and K2tc3r at 64, 256, 1024), k=30 and 300 (the
     tensor-core library call on zero-padded copies, made untimed); and K4
     over a bf16 xt [768, N] of N = 1,000,004, 1,000,002 and 1,000,003
     columns (the producer's 8- and 4-byte pieces and realigned words):
     K4tcr (bf16 queries) and K4tc3r (f32 queries) at B=64, 256, 1024,
     k=30 and 300, the library call on the same xt; and K4r over an f32 xt
     [768, N] of N = 1,000,003 and 1,000,002 (4-byte pieces) at the same
     shapes, beside K4 over xt = x.T of the 1M x 768 f32 rows (B=64 too),
     the f32 library call on the same xt.
  4  the int8 main path: phase 2 with index.dtype = "int8" (Int8FlatIndex,
     bf16 rescore copy): 5 searches (K5) and 64 concurrent queries through
     QueryService (K6), checked against the same snapshot searched on the
     CPU and against single queries; then CodeGraph.open with an
     index.capacity that the planner sends to the int8 tier on this card.
  5  real size of the int8 tier: Int8FlatIndex of 10,000,000 x 768 rows
     with a bf16 rescore copy (about 23 GB), made on the card, 1%
     tombstoned; K5 at B=1 and 8, K6 and K7 at B=64, 256 and 1024, k=100
     and 300, and K6r (the ragged-row producer's instance) called directly
     at B=1024, k=100, timed as in phase 3 against a chunked torch._int_mm
     + topk yardstick; Int8FlatIndex.search end to end at B=1 and 1024,
     with the time of each of its stages at B=1024 (quantize, scan,
     rescore, copy back); then 10M int8 rows of width 760, 764 and 765 (K5
     at 760 and 764, K5r at 765, at B=1 and 8; K6r at 64, 256, 1024 at 760
     and 765; k=100 and 300; the yardstick on a zero-padded copy at 764 and
     765), and Int8FlatIndex.search over the rows of width 765 with a bf16
     rescore copy (load_arrays) at B=1 and 8, limit 10: ms, each stage's
     ms, and K5r's launches (the kernels line's for K5r).
  6  the IVF-PQ main path: phase 2 with index.kind = "ivfpq" at the config
     defaults (nlist 4096, nprobe 64, pq_m 96, host int8 refine): 5
     searches, a filtered search keeping <= 3% of rows (a fetch above
     1,024), 64 concurrent queries through QueryService, each checked
     against the same snapshot on the CPU or against single queries; K8
     must launch and no flat or int8 kernel. Then index.kind = "ivf" (no
     kernel), and CodeGraph.open with an index.capacity that the planner
     sends to IVF-PQ on this card.
  7  real size of the IVF-PQ tier: IVFPQIndex(768, nlist 4096, nprobe 64,
     m 96, refine "int8_device") over 10,000,000 rows of a clustered
     mixture made on the card, 1% tombstoned; build seconds by stage and
     card memory; K8 at B=1, 8, 256, 1024 and k=40, 300 (and B=1 k=1920,
     phase 6's filtered fetch), with the cells' fills as extents and over
     their whole cap, against its plain version, the batch-shared route
     (library_ms) and its bound, with the time of the coarse stage and ADC
     table, the lookup floor and the code bytes it reads;
     IVFPQIndex.search end to end at B=1 and 1024 and its recall@10
     against an exact f32 scan.
  8  the default configuration: CodeGraph.open(<copy of codegraph_tpu/>,
     CodeGraphConfig() with only data_dir set, device="cuda"), which must
     resolve to the pipeline [ensemble, hash] with the encoder of
     checkpoints/encoder_r3_512.npz and its BPE-16k tokenizer on the card;
     .index() (stage seconds, the encoder's host tokenization apart from
     its forward, texts/s, tokens/s; the hash member must embed nothing
     and no provider fail), 5 searches (K1; the first two by part, as in
     phase 2) and 64 QueryService queries
     (K2; no other kernel may launch), checked as in phase 2; the encoder
     against the JAX package's golden embeddings (tests/data/
     encoder_r3_golden.npz) and against its CPU path, within 2e-3, and one
     forward timed at B=1 x 64 and 256 x 192 tokens; the same snapshot
     loaded on the CPU: hybrid hits with the card's query vectors (1e-5)
     and with each side's own (2e-3), and one semantic_code_search tool
     call with the default feature reranker (2e-3). Where each side embeds
     the query itself, a search whose two sides kept other candidates at a
     cut (the 3 x limit chunk prefetch or the top-limit nodes), every one of
     them within 2e-3 of its side's last kept score, is counted as a cut
     tie and not held position by position (the graph boost is normalised
     over the candidates, so one other chunk moves every score); phases 9
     and 10 count such searches the same way.
  9  the served path: the default configuration through the port's CLI as
     subprocesses on the card (`python -m codegraph_tpu_torch.cli index`,
     then `start stdio` fed initialize, tools/list, a semantic_code_search
     call, an agentic_context call and prompts/get: every stdout line must
     be JSON), then the same snapshot in this process through
     CodeGraph.open(device="cuda") and the server build the CLI shares:
     stdio (resources, prompts, a progress token, the 8 direct tools, the 4
     agentic pipelines), streamable HTTP (a session, JSON and SSE calls, two
     calls at once, an unknown session, DELETE, /metrics) and one ReAct
     agent whose LLM is a scripted OpenAI-compatible endpoint on localhost.
     Every reply must be free of errors; K1 must launch at least once a
     semantic search and no other kernel; the CLI's replies must equal this
     process's (1e-5), the card's the same snapshot's served from the CPU
     (2e-3, no mismatch outside ties or cut ties), the concurrent calls the
     serial ones.
     Prints tools/call ms over stdio and HTTP beside CodeGraph.search, the
     agentic ms without and with the agent, and the CLI's seconds.
  10 the rest of the serving surface: phase 8's project and CodeGraphConfig()
     with search.reranker = "cross_encoder" (checkpoints/cross_encoder_r3.npz
     whole: 4 x 384, 8 heads, 256 tokens, BPE-16k) served through
     make_server: a warm-up and 5 semantic_code_search tools/calls at limit
     20 (stage 1 re-embeds the candidates on the card, stage 2 scores 20
     pairs), each with its stages' ms; the same candidates reranked on the
     CPU; the cross-encoder against the JAX package's golden scores
     (tests/data/cross_encoder_r3_golden.npz) and its CPU path, and its
     forward at 20 x 256 and 1 x 256 against its bf16 bound; CodeGraph.ask
     without an LLM and with the scripted localhost LLM, and
     CodeGraph.insights, against the CPU snapshot; an IndexRouter over the
     default backend (768) and the hash provider at 256 (tool calls by
     `model`, raw vectors by width, an unknown model); SegmentedIndex at
     1,000,000 x 768 f32 fed through WriterHandle in jobs of the default
     seal threshold (ten segments; the writer reports the reference's row
     drift on every job after the first), 1% deleted, searched at B=1 (K1)
     and B=64 (K2) before and after one compact() against one FlatIndex over
     the same rows. Every reply free of errors; K1 at least once a search
     that missed the hybrid cache, and once per non-empty segment.
  11 training at full width: pairs of a docstring and its function's or
     class's source from the repo's codegraph_tpu/ (read with ast),
     tokenized with checkpoints/bpe_code_16k.json. The r3 encoder
     (checkpoints/encoder_r3_512.npz, 6 x 512, 16 heads, L=192) from f32
     master weights: one step at B=8 on the card against the port's CPU
     path (loss, accuracy, grad_norm, each gradient's relative L2, the
     updated parameters); then the r3 trainer's settings (B=256, L=192,
     remat, lr 5e-4 const) for 20 steps over 8 fixed batches, run as
     MLLifecycle.train_model's train_fn: median step ms (CUDA events),
     pairs/s, tokens/s, the share of the bf16 bound (6 operations per
     weight per token and attention's 12 L H, at 989 TFLOP/s), peak memory
     with remat and without, every loss finite and the last 4 steps' mean
     below the first 4's; save_train_state/restore_train_state continuing
     bit-equal; the registered EncoderProvider embedding within 2e-3 of
     encode with the trained weights. The r3 cross-encoder
     (checkpoints/cross_encoder_r3.npz, 4 x 384, L=256) listwise: one step
     at 2 x 8 against the CPU path, 10 steps at 48 queries x 8 candidates.
  12 the shared-memory hand-off at real size: a FlatIndex f32, an
     Int8FlatIndex with its bf16 rescore copy and an IVFPQIndex (nlist
     1024, nprobe 32, m 96, host int8 refine), each 1,000,000 x 768 made on
     the card, 1% tombstoned, published in turn into a segment under TMPDIR
     (or the checkout's _build/ when TMPDIR lacks the room); a second
     process (`--shm-child`, started with subprocess, its own CUDA context)
     attaches it through ShmServedIndex and searches at B=1 and 64 (IVF-PQ:
     B=1), its results equal to the publisher's bit for bit; the publisher
     deletes 1% more rows and republishes, the child must see the new
     generation within check_every (1 s) and answer like the new state.
     Prints attach, publish and reload seconds and the child's own K1/K2,
     K5/K6 and K8 launches, which must be above zero.
  13 the sharded indexes (parallel/) at BASELINE config 5's size on an
     8-shard mesh of one card ([cuda:0] * 8; it shows results and the
     merge's cost, not scaling): ShardedFlatIndex of 10,000,000 x 768 f32
     (rows made on the card from a seeded generator, 1% tombstoned) at B=1,
     8 (K1 per shard) and 1024 (K2 per shard), k=10 and 100, each search
     launching its kernel once per shard, held to a chunked matmul + topk
     oracle over the shard tensors in place (ids equal outside ties), timed
     beside the sharded scan alone and one FlatIndex over the same tensors;
     sharded_topk_2d and sharded_topk_hier on (2, 4) meshes over the same
     rows; ShardedInt8Index at 10,000,000 x 768 (K5 at B=1, 8, K6 at 256;
     the shards' candidates against the plain scan, the host rescore against
     exact dots); ShardedIVFIndex at 1,000,000 x 768 (no kernel; scores
     against the stored rows, recall@10); ShardedIVFPQIndex at 10,000,000 x
     768 with the device int8 refine (K8 per shard at B=1, 8, 1024; K8 per
     shard against its plain version; recall@10 against an exact scan);
     ShardedFlatIndex of 10,000,000 x 768 bf16 (15.4 GB; f32 queries) at
     B=1, 8 (K1tc, three pieces, per shard) and 1024 (K2tc3 per shard),
     k=10 and 100, held to the same oracle and timed beside one scan of the
     route over the unsharded rows; HybridSearch over a ShardedFlatIndex of
     the repo's own sources against the same project's FlatIndex search
     (1e-5).
  14 the encoder across a mesh at the r3 encoder's width (checkpoints/
     encoder_r3_512.npz, 6 x 512, B=256, L=192, on [cuda:0] * n): in f32,
     sp_ring_encode on (dp, sp) = (2, 4), pp_encode with pp = 2 and 3 and
     (pp, tp) = (2, 2), and encode on (dp, sp, tp) = (2, 2, 2), each within
     1e-4 of encode without a mesh; the bf16 forward on the mesh within 2e-3
     of its own; one bf16 training step (remat) from
     make_sharded_train_step on (dp, sp, tp) = (2, 2, 2) and a routed-MoE
     encoder at the same width (4 experts, top-2, capacity 2.0, seeded) on
     (dp, ep, tp) = (2, 2, 2), each against the one-device step's loss and
     grad norm (one bf16 step); make_sharded_topk_moe on ep = 4 against
     topk_moe_dense at capacity 8.0 (1e-4). Prints each one's ms.
  15 the bf16 main path: phase 2 with index.dtype = "bfloat16" (the flat
     tier the planner picks from 200k rows): 5 searches (K1tc) and 64
     concurrent QueryService queries (K2tc), checked as in phase 2; K1tc
     and K2tc must launch and no other kernel. It runs right after phase 2.
  16 the card's pytest cases: `python -m pytest --noconftest -p
     no:cacheprovider -q tests/test_torch_card.py` in a subprocess (the
     conftest imports JAX, which the card's machine lacks); every
     collected case must pass and none skip. Prints the pass count on a
     line of its own. It runs right after phase 1.
  17 every embedding width on the main path: phase 2 at
     embedding.dimension = 100 with index.dtype "float32" (K1, K2 on their
     16-byte pieces), "bfloat16" (K1tcr, K2tcr: the ragged-row producer)
     and phase 4's int8 path (K5's words, K6r), each checked as in phases
     2 and 4, each launching its routes and no other kernel (no TMA
     instance); then a bf16 ShardedFlatIndex (K1tcr at B=8, K2tc3r at
     1024) and a ShardedInt8Index (K5 at 8, K6r at 256) over 1M rows of
     that width on phase 13's 8-shard mesh, against one scan of the same
     route over all rows and the oracle. It runs right after phase 15.

Then the card's name and power limit, one JSON line with every kernel's
numbers, and last {"ok": true, "device": {...}}. Any failed check exits
non-zero before that line. The JAX package is read as text (phase 2's
corpus), never imported.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 1100
NEG_INF = -1e30

# H100 SXM data sheet (dense): the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the peak rate of its type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

# Scores of unit-norm rows and queries lie in [-1, 1]. f32 sums taken in
# another order differ by ~1e-7 at D=768; bf16 rows and queries multiply
# exactly in f32, so both dtypes are held to the same bound.
SCORE_TOL = 1e-5

#: K2tc's cases in phase 1: depths (not a multiple of 64; both query-tile
#: routes), batches on both sides of its 64- and 128-row query tiles, k
TC_D = (768, 8, 64, 200, 1024, 1536)
TC_B = (32, 33, 64, 65, 96, 128, 129, 255, 256, 1000)
TC_K = (1, 10, 30, 100, 300, 1024)
TC_B_OTHER = (33, 64, 65, 129, 1000)
TC_K_OTHER = (1, 30, 300, 1024)

#: K1tc's cases in phase 1: batches on both sides of its 8-row query
#: tiles and of one block's 32, k up to MAX_K, depths as K2tc's
K1TC_B = (1, 2, 5, 8, 9, 16, 17, 24, 31, 32, 40)
K1TC_K = (1, 10, 30, 100, 300, 1024)
K1TC_B_OTHER = (1, 8, 9, 31)
K1TC_K_OTHER = (1, 30, 300, 1024)

#: K4tc's and K4tc3's own family in phase 1 (beside K4's cases at D =
#: 768): xt depths not a multiple of 8 (q padded) or of 64, resident and
#: streamed query tiles; the corpus of duplicate rows has N % 8 == 0
K4TC_D = (36, 200, 1536)
K4TC_RAGGED = 100008
#: K4tcr's and K4tc3r's family in phase 1: (N, depth, base in elements
#: past 16 bytes) of xt [D, N] that TMA cannot read: N % 8 = 1, 4, 6, 1,
#: 3, 0 and 3 (realigned words, 8- and 4-byte pieces) at aligned bases,
#: and N = 5000 and 5003 at 2, 4 and 8 bytes in; depths 36 (q padded),
#: 200 and 768
K4TCR_XT = ((297, 200, 0), (300, 200, 0), (302, 36, 0), (1001, 768, 0), (5003, 200, 0),
            (5003, 768, 1), (5000, 200, 1), (5000, 200, 2), (5000, 768, 4), (100003, 200, 2))
K4TCR_B = (33, 65, 129)
K4TCR_K = (1, 30, 300, 1024)
#: phase 3's xt of N columns for K4tcr and K4tc3r: 8- and 4-byte pieces,
#: realigned words
K4TCR_TIMED_N = (1_000_004, 1_000_002, 1_000_003)
#: phase 3's f32 xt of N columns that 16-byte pieces cannot read (K4r): N
#: odd, and N % 4 = 2
K4R_TIMED_N = (1_000_003, 1_000_002)

#: the every-width family of phase 1: widths that TMA's tiled mode (bf16
#: rows: D % 8; int8 rows: D % 16) or 16-byte pieces (f32 rows: D % 4) or
#: words (int8 rows: D % 4) cannot read, and 1000 (bf16 TMA, int8 8-byte
#: pieces); RAGGED_OFFSET_D also with the base one element off 16 bytes;
#: a ragged N with duplicate rows, 1% tombstones and a filter
RAGGED_D = (1, 3, 25, 50, 100, 300, 760, 764, 765, 1000)
RAGGED_OFFSET_D = (100, 765, 1000)
RAGGED_N = 10007
RAGGED_K = (1, 10, 100, 300)
#: (kernel, B): K1 (K5) on both sides of 8 and up to 31, K2 (K6) on both
#: sides of 32 and of the 64- and 128-row query tiles, K3 (K7)
RAGGED_SHAPES = (("K1", 1), ("K1", 9), ("K1", 31), ("K2", 33), ("K2", 64), ("K2", 65),
                 ("K2", 129), ("K3", 129))
#: K5r's own family in phase 1 (and tests/test_torch_card.py's): int8 rows
#: of widths that words cannot read at bases 0-3 bytes past a 16-byte
#: aligned address (every lead of a row occurs), one batch on each side of
#: K5's 4- and 8-row query tiles, k up to MAX_K; and 765 as the tail of its
#: storage, the last row ending at the storage's last byte
K5R_D = (1, 3, 25, 101, 765)
K5R_OFFSETS = (0, 1, 2, 3)
K5R_B = (1, 5, 8)
K5R_K = (1, 100, 300, 1024)

#: the sources under codegraph_tpu_torch/csrc/, built in phase 0
SOURCES = ("flat_topk", "flat_topk_tc", "flat_topk_k1tc", "int8_topk", "ivfpq_adc", "ivf_spill")
HOST_SOURCE = "cghost"  # csrc/cghost.cpp, the host library (g++)


# name -> (wrapper module, wrapper, source, line of the TPU kernel's pallas_call)
FLAT_CU = "codegraph_tpu_torch/csrc/flat_topk.cu"
FLAT_TC_CU = "codegraph_tpu_torch/csrc/flat_topk_tc.cu"
FLAT_K1TC_CU = "codegraph_tpu_torch/csrc/flat_topk_k1tc.cu"
INT8_CU = "codegraph_tpu_torch/csrc/int8_topk.cu"
IVFPQ_CU = "codegraph_tpu_torch/csrc/ivfpq_adc.cu"
KERNELS = {
    "K1": ("topk", "streaming_topk_cuda", FLAT_CU, "codegraph_tpu/ops/topk.py:347"),
    "K2": ("topk", "streaming_topk_cuda_qmajor", FLAT_CU, "codegraph_tpu/ops/topk.py:456"),
    "K3": ("topk", "streaming_topk_cuda_qres", FLAT_CU, "codegraph_tpu/ops/topk.py:561"),
    "K4": ("topk", "streaming_topk_cuda_qmajor_xt", FLAT_CU, "codegraph_tpu/ops/topk.py:664"),
    # K4 over an f32 xt that 16-byte pieces cannot read (N % 4 != 0, unaligned)
    "K4r": ("topk", "streaming_topk_cuda_qmajor_xt_ragged", FLAT_CU,
            "codegraph_tpu/ops/topk.py:664"),
    # K1 over bf16 rows, bf16 or f32 queries (wgmma, the corpus as the 64-row operand)
    "K1tc": ("topk", "streaming_topk_cuda_k1tc", FLAT_K1TC_CU, "codegraph_tpu/ops/topk.py:347"),
    # K2 and K3 over bf16 queries and bf16 rows (wgmma bf16 on the tensor cores)
    "K2tc": ("topk", "streaming_topk_cuda_tc", FLAT_TC_CU, "codegraph_tpu/ops/topk.py:456"),
    # the same over f32 queries, each as three bf16 pieces
    "K2tc3": ("topk", "streaming_topk_cuda_tc3", FLAT_TC_CU, "codegraph_tpu/ops/topk.py:456"),
    # K4 over a bf16 xt that TMA can read, bf16 queries (K2tc's kernel, xt MN-major)
    "K4tc": ("topk", "streaming_topk_cuda_tc_xt", FLAT_TC_CU, "codegraph_tpu/ops/topk.py:664"),
    # the same over f32 queries, each as three bf16 pieces
    "K4tc3": ("topk", "streaming_topk_cuda_tc3_xt", FLAT_TC_CU, "codegraph_tpu/ops/topk.py:664"),
    # K4tc and K4tc3 over a bf16 xt TMA cannot read (N % 8 != 0, unaligned),
    # fed by the ragged-row producer
    "K4tcr": ("topk", "streaming_topk_cuda_tc_xt_ragged", FLAT_TC_CU,
              "codegraph_tpu/ops/topk.py:664"),
    "K4tc3r": ("topk", "streaming_topk_cuda_tc3_xt_ragged", FLAT_TC_CU,
               "codegraph_tpu/ops/topk.py:664"),
    "K5": ("quantize", "streaming_topk_int8_cuda", INT8_CU, "codegraph_tpu/ops/quantize.py:182"),
    "K6": ("quantize", "streaming_topk_int8_cuda_qmajor", INT8_CU,
           "codegraph_tpu/ops/quantize.py:287"),
    "K7": ("quantize", "streaming_topk_int8_cuda_qres", INT8_CU,
           "codegraph_tpu/ops/quantize.py:396"),
    # K6/K7 over rows TMA cannot read (D % 16 != 0, unaligned rows): the
    # same wgmma kernel fed by the ragged-row producer (csrc/hopper_tc.cuh)
    "K6r": ("quantize", "streaming_topk_int8_cuda_ragged", INT8_CU,
            "codegraph_tpu/ops/quantize.py:287"),
    # K5 over rows that are not 4-byte aligned (D % 4 != 0, a base one byte in)
    "K5r": ("quantize", "streaming_topk_int8_cuda_realigned", INT8_CU,
            "codegraph_tpu/ops/quantize.py:182"),
    # K1 and K2/K3 over f32 rows in 4-byte pieces (D % 4 != 0, unaligned rows)
    "K1r": ("topk", "streaming_topk_cuda_ragged", FLAT_CU, "codegraph_tpu/ops/topk.py:347"),
    "K2r": ("topk", "streaming_topk_cuda_qmajor_ragged", FLAT_CU,
            "codegraph_tpu/ops/topk.py:456"),
    # K1tc, K2tc and K2tc3 over bf16 rows TMA cannot read (D % 8 != 0,
    # unaligned rows), fed by the ragged-row producer
    "K1tcr": ("topk", "streaming_topk_cuda_k1tc_ragged", FLAT_K1TC_CU,
              "codegraph_tpu/ops/topk.py:347"),
    "K2tcr": ("topk", "streaming_topk_cuda_tc_ragged", FLAT_TC_CU,
              "codegraph_tpu/ops/topk.py:456"),
    "K2tc3r": ("topk", "streaming_topk_cuda_tc3_ragged", FLAT_TC_CU,
               "codegraph_tpu/ops/topk.py:456"),
    "K8": ("ivfpq", "ivfpq_search_cuda", IVFPQ_CU, "codegraph_tpu/index/ivfpq.py:273"),
}


def wrapper(mods, name):
    module, fn, _, _ = KERNELS[name]
    return getattr(mods[module], fn)


def reset_launches(mods) -> None:
    """Every kernel's launch count to 0: called just before a main path."""
    for name in KERNELS:
        wrapper(mods, name).launches = 0


def read_launches(mods) -> dict:
    """Every kernel's launch count: read just after a main path."""
    return {name: wrapper(mods, name).launches for name in KERNELS}


class CheckFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# checking a top-k result against a reference
# ---------------------------------------------------------------------------


def dot_judge(q, x, bias):
    """True scores of rows of x for query b: the dot product in f64 + bias."""
    return lambda b, rows: (x[rows].double() @ q[b].double()) + bias[rows].double()


def int8_judge(qv, qs, xv, xs, bias):
    """True scores of int8 rows for query b as the reference rounds them:
    the exact integer dot, then * qs[b], * xs[n], + bias[n] in f32."""
    def judge(b, rows):
        raw = (xv[rows].double() @ qv[b].double()).float()
        return (raw * qs[b] * xs[rows] + bias[rows]).double()
    return judge


def check_topk(torch, q, x, bias, s_k, i_k, s_ref, i_ref, tol=SCORE_TOL, judge=None):
    """Hold (s_k, i_k) to the reference (s_ref, i_ref), tie-aware.

    Sentinel (NEG_INF) positions must agree; live scores must agree within
    tol; live ids must be distinct per row; and where an id differs from
    the reference's, the row it names must score (recomputed by `judge`,
    by default the f64 dot product of q and x plus bias) within tol of the
    reference score at that position, i.e. it is tied.
    Returns (max_abs_err, id_mismatches, mismatches_outside_ties)."""
    judge = judge or dot_judge(q, x, bias)
    live_k = s_k > NEG_INF / 2
    live_r = s_ref > NEG_INF / 2
    bad = int((live_k != live_r).sum())
    bad += int(((~live_k) & (i_k != -1)).sum())
    both = live_k & live_r
    err = float((s_k - s_ref).abs()[both].max()) if bool(both.any()) else 0.0
    differ = (i_k != i_ref) & both
    n_differ = int(differ.sum())
    for b in range(s_k.shape[0]):
        ids = i_k[b][live_k[b]]
        if ids.numel() and torch.unique(ids).numel() != ids.numel():
            bad += 1
        if bool(differ[b].any()):
            pos = differ[b].nonzero().flatten()
            true = judge(b, i_k[b][pos].long())
            bad += int(((true - s_ref[b][pos].double()).abs() > tol).sum())
    if err > tol:
        bad += 1
    return err, n_differ, bad


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase0(torch) -> dict:
    from codegraph_tpu_torch.ops import cuda_build

    smi = nvidia_smi_line()
    nvcc = cuda_build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[-1]
    cxx = cuda_build.find_cxx()
    cxx_ver = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
    # the host library (g++) beside the CUDA sources (one nvcc each), all at once
    host, host_err = {}, []

    def _host():
        t = time.perf_counter()
        try:
            cuda_build.build_host(HOST_SOURCE)
        except Exception as exc:  # raised below, after the CUDA builds end
            host_err.append(exc)
        host["seconds"] = time.perf_counter() - t

    host_thread = threading.Thread(target=_host)
    t0 = time.perf_counter()
    host_thread.start()
    cuda_build.build_all(SOURCES)
    host_thread.join()
    build_s = time.perf_counter() - t0
    if host_err:
        raise host_err[0]
    ptxas = [f"{name}: {line}" for name in SOURCES for line in ptxas_summary(cuda_build.build_log(name))]
    out = {"phase": 0, "gpu": smi, "torch": torch.__version__,
           "torch_cuda": torch.version.cuda, "nvcc": ver,
           "build_seconds": round(build_s, 3), "ptxas": ptxas,
           "host_library": {"source": f"codegraph_tpu_torch/csrc/{HOST_SOURCE}.cpp", "cxx": cxx_ver,
                            "flags": " ".join(cuda_build.HOST_FLAGS),
                            "cpu": cuda_build.host_cpu_model(),
                            "build_seconds": round(host["seconds"], 3)}}
    emit(out)
    return out


def ptxas_summary(log: str) -> list:
    """One line per kernel of `nvcc -Xptxas=-v` output: its (mangled,
    shortened) name, registers and spill bytes."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"(topk_pass1|rows_pass1|bf16_tc_pass1|bf16_k1_pass1|int8_dp4a_pass1|"
                          r"topk_ragged_pass1|bf16_tc_ragged_pass1|int8_dp4a_ragged_pass1|"
                          r"int8_tc_ragged_pass1|"
                          r"int8_tc_pass1|adc_qmajor|"
                          r"merge_pairs_global|"
                          r"topk_merge)"
                          r"(I\w*?EE)?",
                          m.group(1))
            name = k.group(1) + (k.group(2) or "") if k else m.group(1)
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
    return out


def _unit(torch, t):
    return t / t.float().norm(dim=1, keepdim=True).clamp(min=1e-6).to(t.dtype)


def phase1(torch, mods, errs) -> dict:
    topk, quantize = mods["topk"], mods["quantize"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    D = 768
    cases = []
    flat = {"K1": topk.streaming_topk_cuda, "K2": topk.streaming_topk_cuda_qmajor,
            "K3": topk.streaming_topk_cuda_qres}
    k4 = topk.streaming_topk_cuda_qmajor_xt
    int8 = {"K5": quantize.streaming_topk_int8_cuda, "K6": quantize.streaming_topk_int8_cuda_qmajor,
            "K7": quantize.streaming_topk_int8_cuda_qres}
    # (N, duplicate rows, filter, live rows)
    corpora = ((131072, False, False, None), (100003, True, True, None), (200, False, False, 150))
    # a bf16 xt with N % 8 == 0 but not a multiple of 128, with duplicate
    # rows: K4tc's ragged N (100,003 takes K4tcr); K4 alone runs on it
    k4_only = (K4TC_RAGGED, True, True, None)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for N, dup, filt, live in corpora + ((k4_only,) if dtype == torch.bfloat16 else ()):
            x = _unit(torch, torch.randn(N, D, generator=g, device=dev))
            bias = torch.zeros(N, device=dev)
            dead = torch.randperm(N, generator=g, device=dev)[: max(1, N // 100)]
            bias[dead] = NEG_INF
            if live is not None:
                bias[live:] = NEG_INF
            if filt:  # extra_bias: a filter excluding ~10% of rows
                flt = torch.rand(N, generator=g, device=dev) < 0.1
                bias = bias + torch.where(flt, NEG_INF, 0.0)
            if dtype == torch.int8:
                xv, xs = quantize.quantize_rows(x)
                xv[17] = 0  # an all-zero row: scale 0
                xs[17] = 0.0
                xv[20:25] = 127  # +-127 everywhere: an int8 product would wrap
                xv[25:30] = -127
                xs[20:30] = 1.0 / 127
                if dup:  # exact ties: rows 1000..1999 repeat rows 0..999
                    xv[1000:2000] = xv[0:1000]
                    xs[1000:2000] = xs[0:1000]
                kernels, ks = int8, (1, 10, 100, 300)
            else:
                x = x.to(dtype)
                if dup:
                    x[1000:2000] = x[0:1000]
                xt = x.T.contiguous()  # K4's corpus: the same rows as xt [D, N]
                kernels, ks = dict(flat, K4=lambda q_, x_, b_, k_: k4(q_, xt, b_, k_)), \
                    (1, 10, 30, 100, 300, 1024)
            # (kernel, batch); the int8 tier names K5-K7 like K1-K3
            layouts = (("K1", 1), ("K1", 5), ("K2", 96), ("K2", 256), ("K3", 96), ("K3", 256))
            if dtype != torch.int8:  # the row tiles: 32-, 64- and partial 128-row query tiles
                layouts += (("K2", 20), ("K2", 33), ("K2", 64), ("K2", 70), ("K2", 1000),
                            ("K3", 32), ("K3", 40), ("K3", 70), ("K3", 1000), ("K4", 31),
                            ("K4", 64), ("K4", 70), ("K4", 96), ("K4", 256), ("K4", 1000))
            else:  # both sides of K6/K7's 64- and 128-row query tiles
                layouts += (("K2", 33), ("K2", 64), ("K2", 65), ("K2", 128), ("K2", 129),
                            ("K2", 255), ("K2", 1000), ("K3", 64), ("K3", 129))
            if (N, dup, filt, live) == k4_only:
                layouts = tuple(lay for lay in layouts if lay[0] == "K4")
            for kernel, B in layouts:
                if dtype == torch.int8:
                    kernel = {"K1": "K5", "K2": "K6", "K3": "K7"}[kernel]
                fn = kernels[kernel]
                # over bf16 rows K1 runs K1tc, K2 and K3 K2tc (bf16 queries),
                # K4 K4tc where TMA can read xt, else K4tcr; over an f32 xt
                # K4 where 16-byte pieces can read it, else K4r
                name = {"K1": "K1tc", "K2": "K2tc", "K3": "K2tc"}.get(kernel, kernel) \
                    if dtype == torch.bfloat16 else kernel
                if dtype == torch.bfloat16 and kernel == "K4":
                    name = "K4tc" if topk.xt_tma_readable(N, xt.data_ptr()) else "K4tcr"
                elif kernel == "K4" and topk.flat_route(xt) != "16-byte pieces":
                    name = "K4r"
                q = _unit(torch, torch.randn(B, D, generator=g, device=dev))
                if dtype == torch.int8:
                    qv, qs = quantize.quantize_rows(q)
                    if dup:
                        qv[0], qs[0] = xv[5], xs[5]  # its own duplicate pair tops the list
                    if B > 1:
                        qv[1] = 127  # against the +-127 rows: 127^2 * D exactly
                        qs[1] = 1.0 / 127
                    args = (qv, qs, xv, xs, bias)
                    plain = quantize.streaming_topk_int8
                    judge = int8_judge(*args)
                else:
                    q = q.to(dtype)
                    if dup:
                        q[0] = x[5]
                    args = (q, x, bias)
                    plain = topk.streaming_topk
                    judge = dot_judge(q, x, bias)
                # (kernel that must launch, its label, inputs, judge)
                runs = [(name, kernel if name == kernel else f"{name} (via {kernel})", args, judge)]
                if dtype == torch.bfloat16:  # the same rows under f32 queries: three pieces
                    qf = q.float()
                    ran = {"K1tc": "K1tc", "K2tc": "K2tc3", "K4tc": "K4tc3", "K4tcr": "K4tc3r"}[name]
                    runs.append((ran, f"{ran} (via {kernel}, f32 q)", (qf, x, bias),
                                 dot_judge(qf, x, bias)))
                for k in ks:
                    for ran, label, run_args, run_judge in runs:
                        # the route the inputs set, and no other
                        (s_k, i_k), delta = _counted(mods, lambda: fn(*run_args, k))
                        torch.cuda.synchronize()
                        require(delta == {ran: 1},
                                f"phase 1: {label} B={B} k={k} launched {delta}, not {ran} once")
                        s_p, i_p = plain(*run_args, k)
                        err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                                      judge=run_judge)
                        if dtype == torch.int8:  # same f32 operations in the same order
                            bad += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
                        errs[ran] = max(errs[ran], err)
                        cases.append({
                            "kernel": label, "dtype": str(dtype)[6:], "N": N, "B": B,
                            "k": k, "dup": dup, "filter": filt, "live": live or N,
                            "max_abs_err": err, "id_mismatches": n_diff,
                            "mismatches_outside_ties": bad})
    cases += phase1_unaligned(torch, mods, errs, g)
    cases += phase1_ragged(torch, mods, errs)
    cases += phase1_k5r(torch, mods, errs)
    cases += phase1_tc(torch, mods, errs)
    cases += phase1_k1tc(torch, mods, errs)
    cases += phase1_k4tc(torch, mods, errs)
    cases += phase1_k4tcr(torch, mods, errs)
    cases += phase1_pieces_exact(torch, mods, errs)
    cases += phase1_k8(torch, mods, errs)
    spill = phase1_spill(mods)
    host = phase1_host()
    n_bad = sum(c["mismatches_outside_ties"] for c in cases)
    n_host = sum(h["mismatches_outside_ties"] for h in host.values() if isinstance(h, dict))
    out = {"phase": 1, "cases": len(cases), "spill_compiled_vs_python": spill,
           "host_library_vs_plain": host,
           "max_abs_err": {k: v for k, v in errs.items()},
           "id_mismatches": sum(c["id_mismatches"] for c in cases),
           "mismatches_outside_ties": n_bad,
           "failed": [c for c in cases if c["mismatches_outside_ties"]][:10]}
    emit(out)
    require(n_bad == 0, f"phase 1: {n_bad} mismatches outside ties")
    require(spill["equal"], "phase 1: the compiled spill placement differs from the Python loop")
    require(n_host == 0, f"phase 1: the host library differs from its plain versions: {host}")
    return out


def phase1_unaligned(torch, mods, errs, g) -> list:
    """K6 and K7 at a D that is not a multiple of 16: their wrappers send
    it to the ragged-row producer's instance (K6r), which must then have
    launched, and no other kernel."""
    quantize = mods["quantize"]
    dev = torch.device("cuda")
    N, D = 20011, 100
    xv, xs = quantize.quantize_rows(_unit(torch, torch.randn(N, D, generator=g, device=dev)))
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = NEG_INF
    cases = []
    for name, B in (("K6", 70), ("K6", 129), ("K7", 40)):
        qv, qs = quantize.quantize_rows(_unit(torch, torch.randn(B, D, generator=g, device=dev)))
        args = (qv, qs, xv, xs, bias)
        for k in (1, 10, 100, 300):
            (s_k, i_k), delta = _counted(mods, lambda: wrapper(mods, name)(*args, k))
            torch.cuda.synchronize()
            require(delta == {"K6r": 1}, f"phase 1: {name} at D={D} B={B} k={k} launched {delta}, "
                    "not K6r once")
            s_p, i_p = quantize.streaming_topk_int8(*args, k)
            err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                          judge=int8_judge(*args))
            bad += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
            errs["K6r"] = max(errs["K6r"], err)
            cases.append({"kernel": f"K6r (via {name})", "dtype": "int8", "N": N, "D": D, "B": B,
                          "k": k, "max_abs_err": err, "id_mismatches": n_diff,
                          "mismatches_outside_ties": bad})
    return cases


def _offset_copy(torch, t, offset):
    """t's values in a tensor whose base lies `offset` elements past a
    16-byte aligned address (0: a tensor of its own)."""
    if offset == 0:
        return t.clone()
    buf = torch.zeros(t.numel() + offset + 16, dtype=t.dtype, device=t.device)
    skip = (-buf.data_ptr() % 16) // t.element_size()
    out = buf[skip + offset: skip + offset + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _storage_tail(torch, t, offset):
    """t's values in a tensor that begins `offset` bytes past a 16-byte
    aligned address and ends at the last byte of its storage."""
    nbytes = t.numel() * t.element_size()
    buf = torch.empty(nbytes + offset, dtype=torch.uint8, device=t.device)
    require(buf.data_ptr() % 16 == 0, "a fresh allocation is not 16-byte aligned")
    out = buf[offset:].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def phase1_k5r(torch, mods, errs) -> list:
    """K5r's own family: K5 over int8 rows that are not 4-byte aligned, at
    each width of K5R_D and base of K5R_OFFSETS and once as the tail of its
    storage (765), over a ragged N with duplicate rows, 1% tombstones and a
    filter, B in K5R_B, k in K5R_K: each call launches K5r once and no
    other kernel, ids equal the plain version's outside ties and scores bit
    for bit."""
    quantize = mods["quantize"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    N = RAGGED_N
    cases = []
    t0 = time.perf_counter()
    for D in K5R_D:
        x0 = _unit(torch, torch.randn(N, D, generator=g, device=dev))
        x0[1000:2000] = x0[0:1000]  # exact ties
        bias = torch.zeros(N, device=dev)
        bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = NEG_INF
        bias = bias + torch.where(torch.rand(N, generator=g, device=dev) < 0.1, NEG_INF, 0.0)
        q0 = _unit(torch, torch.randn(max(K5R_B), D, generator=g, device=dev))
        q0[0] = x0[5]  # its own duplicate pair tops the list
        xv0, xs = quantize.quantize_rows(x0)
        qv0, qs0 = quantize.quantize_rows(q0)
        bases = [(o, _offset_copy(torch, xv0, o)) for o in K5R_OFFSETS]
        if D == 765:
            bases.append(("tail", _storage_tail(torch, xv0, 1)))
        plain = {}  # the same rows at every base: one plain result a (B, k)
        for offset, xv in bases:
            require(quantize.int8_route("K5", xv, xv, xs, bias) != "4-byte pieces",
                    f"phase 1: K5 reads int8 rows of width {D} at offset {offset} as words")
            for B in K5R_B:
                args = (qv0[:B].contiguous(), qs0[:B].contiguous(), xv, xs, bias)
                for k in K5R_K:
                    (s_k, i_k), delta = _counted(
                        mods, lambda: quantize.streaming_topk_int8_cuda(*args, k))
                    torch.cuda.synchronize()
                    require(delta == {"K5r": 1}, f"phase 1: K5 over int8 rows of width {D} at "
                            f"offset {offset}, B={B} k={k}, launched {delta}, not K5r once")
                    if (B, k) not in plain:
                        plain[(B, k)] = quantize.streaming_topk_int8(*args, k)
                    s_p, i_p = plain[(B, k)]
                    err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                                  judge=int8_judge(*args))
                    bad += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
                    errs["K5r"] = max(errs["K5r"], err)
                    cases.append({"kernel": "K5r (via K5)", "dtype": "int8", "N": N, "D": D,
                                  "offset": offset, "B": B, "k": k, "max_abs_err": err,
                                  "id_mismatches": n_diff, "mismatches_outside_ties": bad})
    emit({"phase": 1, "family": "K5r", "cases": len(cases),
          "seconds": round(time.perf_counter() - t0, 3)})
    return cases


def _ragged_route(topk, quantize, dtype, kernel, q_dtype, x, xs=None, bias=None):
    """The route (KERNELS name) that `kernel` ("K1", "K2", "K3") must take
    over rows x of `dtype`, from the route rules (ops/topk.py
    `flat_route`, ops/quantize.py `int8_route`)."""
    if dtype == "int8":
        k5 = quantize.int8_route("K5", x, x, xs, bias) == "4-byte pieces"
        k6 = quantize.int8_route("K6", x, x, xs, bias) == "tma"
        return {"K1": "K5" if k5 else "K5r", "K2": "K6" if k6 else "K6r",
                "K3": "K7" if k6 else "K6r"}[kernel]
    route = topk.flat_route(x)
    if dtype == "float32":
        wide = route == "16-byte pieces"
        return {"K1": "K1" if wide else "K1r", "K2": "K2" if wide else "K2r",
                "K3": "K3" if wide else "K2r"}[kernel]
    if kernel == "K1":
        return "K1tc" if route == "tma" else "K1tcr"
    base = "K2tc" if q_dtype == "bfloat16" else "K2tc3"
    return base if route == "tma" else base + "r"


def phase1_ragged(torch, mods, errs) -> list:
    """Every width on the card: K1-K3 over f32 and bf16 rows (bf16 and f32
    queries) and K5-K7 over int8 rows at each width of RAGGED_D (and of
    RAGGED_OFFSET_D with the base one element off 16 bytes), over a ragged
    N with duplicate rows, 1% tombstones and a filter, at RAGGED_SHAPES x
    RAGGED_K, through the public wrappers: each call launches the route
    the rules name (the ragged-row producer's K1tcr, K2tcr, K2tc3r, K6r;
    the 4-byte pieces of K1r, K2r; K5r's realigned words; or a TMA or
    16-byte instance), once and no other kernel, and is held to the plain
    version (int8 scores bit for bit)."""
    topk, quantize = mods["topk"], mods["quantize"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    fns = {"K1": topk.streaming_topk_cuda, "K2": topk.streaming_topk_cuda_qmajor,
           "K3": topk.streaming_topk_cuda_qres}
    int8_fns = {"K1": quantize.streaming_topk_int8_cuda,
                "K2": quantize.streaming_topk_int8_cuda_qmajor,
                "K3": quantize.streaming_topk_int8_cuda_qres}
    cases = []
    N = RAGGED_N
    for D in RAGGED_D:
        x0 = _unit(torch, torch.randn(N, D, generator=g, device=dev))
        x0[1000:2000] = x0[0:1000]  # exact ties
        bias = torch.zeros(N, device=dev)
        bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = NEG_INF
        bias = bias + torch.where(torch.rand(N, generator=g, device=dev) < 0.1, NEG_INF, 0.0)
        q0 = _unit(torch, torch.randn(max(B for _, B in RAGGED_SHAPES), D, generator=g,
                                      device=dev))
        q0[0] = x0[5]  # its own duplicate pair tops the list
        xv0, xs = quantize.quantize_rows(x0)
        qv0, qs0 = quantize.quantize_rows(q0)
        for offset in ((0, 1) if D in RAGGED_OFFSET_D else (0,)):
            for dtype in ("float32", "bfloat16", "int8"):
                if dtype == "int8":
                    xv = _offset_copy(torch, xv0, offset)
                    runs = [(int8_fns, "int8", (xv, xs, bias))]
                else:
                    x = _offset_copy(torch, x0.to(getattr(torch, dtype)), offset)
                    runs = [(fns, q_d, (x, bias)) for q_d in
                            (("bfloat16", "float32") if dtype == "bfloat16" else ("float32",))]
                for table, q_d, corpus in runs:
                    for kernel, B in RAGGED_SHAPES:
                        if dtype == "int8":
                            args = (qv0[:B].contiguous(), qs0[:B].contiguous(), *corpus)
                            ran = _ragged_route(topk, quantize, dtype, kernel, q_d, corpus[0],
                                                corpus[1], corpus[2])
                            plain, judge = quantize.streaming_topk_int8, int8_judge(*args)
                        else:
                            qb = q0[:B].to(getattr(torch, q_d)).contiguous()
                            args = (qb, *corpus)
                            ran = _ragged_route(topk, quantize, dtype, kernel, q_d, corpus[0])
                            plain, judge = topk.streaming_topk, dot_judge(*args)
                        for k in RAGGED_K:
                            (s_k, i_k), delta = _counted(mods, lambda: table[kernel](*args, k))
                            torch.cuda.synchronize()
                            require(delta == {ran: 1}, f"phase 1: {kernel} over {dtype} rows of "
                                    f"width {D} at offset {offset} with {q_d} queries, B={B} "
                                    f"k={k}, launched {delta}, not {ran} once")
                            s_p, i_p = plain(*args, k)
                            err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p,
                                                          i_p, judge=judge)
                            if dtype == "int8":
                                bad += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
                            errs[ran] = max(errs[ran], err)
                            cases.append({"kernel": f"{ran} (via {kernel})", "dtype": dtype,
                                          "q_dtype": q_d, "N": N, "D": D, "offset": offset,
                                          "B": B, "k": k, "max_abs_err": err,
                                          "id_mismatches": n_diff,
                                          "mismatches_outside_ties": bad})
    return cases


def _tc_corpus(torch, g, dev, N, D, dup, filt, live):
    """Unit bf16 rows on the card with 1% tombstones; dup: rows 1000..1999
    repeat rows 0..999 (exact ties); filt: an extra_bias filter excluding
    ~10% of rows; live: rows from `live` on are dead (k above the live
    count)."""
    x = _unit(torch, torch.randn(N, D, generator=g, device=dev)).to(torch.bfloat16)
    if dup:
        x[1000:2000] = x[0:1000]
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: max(1, N // 100)]] = NEG_INF
    if live is not None:
        bias[live:] = NEG_INF
    if filt:
        bias = bias + torch.where(torch.rand(N, generator=g, device=dev) < 0.1, NEG_INF, 0.0)
    return x, bias


def _tc_cases(torch, mods, errs, g, shapes_of, routes, depths=TC_D, ragged=100003) -> list:
    """The tensor-core routes' case families over bf16 rows: for each depth
    of `depths` (TC_D: not a multiple of 64; resident and streamed query
    tiles), a 131,072-row corpus (at D = 768 only), a ragged N (`ragged`)
    with duplicate rows and a filter, and 200 rows with 150 live (k above
    the live count); for each (kernel, B, k) of shapes_of(D), unit queries
    (query 0 a duplicated row where there are ties) in each query dtype of
    `routes` ({dtype: kernel that must launch, alone}), against the plain
    version. Kernel K4 gets the rows as xt = x.T."""
    topk = mods["topk"]
    dev = torch.device("cuda")
    cases = []
    for D in depths:
        corpora = ((131072, False, False, None), (ragged, True, True, None), (200, False, False, 150))
        for N, dup, filt, live in (corpora if D == 768 else corpora[1:]):
            x, bias = _tc_corpus(torch, g, dev, N, D, dup, filt, live)
            xt = x.T.contiguous() if any(s[0] == "K4" for s in shapes_of(D)) else None
            for kernel, B, k in shapes_of(D):
                q = _unit(torch, torch.randn(B, D, generator=g, device=dev))
                if dup:
                    q[0] = x[5].float()  # its own duplicate pair tops the list
                corpus = xt if kernel == "K4" else x
                for q_dtype, ran in routes.items():
                    qd = q.to(q_dtype)
                    (s_k, i_k), delta = _counted(mods,
                                                 lambda: wrapper(mods, kernel)(qd, corpus, bias, k))
                    torch.cuda.synchronize()
                    require(delta == {ran: 1}, f"phase 1: {kernel} over bf16 rows with "
                            f"{q_dtype} queries, B={B} D={D} k={k}, launched {delta}, not {ran}")
                    s_p, i_p = topk.streaming_topk(qd, x, bias, k)
                    err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                                  judge=dot_judge(qd, x, bias))
                    errs[ran] = max(errs[ran], err)
                    cases.append({"kernel": f"{ran} (via {kernel})", "dtype": "bfloat16",
                                  "q_dtype": str(q_dtype)[6:], "N": N, "D": D, "B": B, "k": k,
                                  "dup": dup, "filter": filt, "live": live or N,
                                  "max_abs_err": err, "id_mismatches": n_diff,
                                  "mismatches_outside_ties": bad})
    return cases


def phase1_tc(torch, mods, errs) -> list:
    """K2 and K3 over bf16 rows, through their wrappers, on the tensor
    cores: bf16 queries launch K2tc and f32 queries K2tc3 (three pieces),
    each alone, held to the plain version at every batch of TC_B and k of
    TC_K at D = 768 (the 64- and 128-row query tiles on both sides) and
    at TC_B_OTHER x TC_K_OTHER at the other depths; K3 at 64, 129 and
    256."""
    g = torch.Generator(device="cuda").manual_seed(15)

    def shapes_of(D):
        if D == 768:
            return [("K2", B, k) for B in TC_B for k in TC_K] + \
                [("K3", B, k) for B in (64, 129, 256) for k in (10, 300)]
        return [("K2", B, k) for B in TC_B_OTHER for k in TC_K_OTHER] + \
            [("K3", B, 300) for B in (64, 129, 256)]

    return _tc_cases(torch, mods, errs, g, shapes_of,
                     {torch.bfloat16: "K2tc", torch.float32: "K2tc3"})


def phase1_k1tc(torch, mods, errs) -> list:
    """K1 over bf16 rows through its wrapper: bf16 and f32 queries launch
    K1tc (one piece or three), held to the plain version at every batch of
    K1TC_B (8-row query tiles, one block's 32, a second tile) and k of
    K1TC_K at D = 768, and at K1TC_B_OTHER x K1TC_K_OTHER at the other
    depths (resident and streamed query tiles)."""
    g = torch.Generator(device="cuda").manual_seed(16)

    def shapes_of(D):
        if D == 768:
            return [("K1", B, k) for B in K1TC_B for k in K1TC_K]
        return [("K1", B, k) for B in K1TC_B_OTHER for k in K1TC_K_OTHER]

    return _tc_cases(torch, mods, errs, g, shapes_of,
                     {torch.bfloat16: "K1tc", torch.float32: "K1tc"})


def phase1_k4tc(torch, mods, errs) -> list:
    """K4 over a bf16 xt through its wrapper, on the tensor cores: bf16
    queries launch K4tc and f32 queries K4tc3, each alone, held to the
    plain version at TC_B_OTHER x TC_K_OTHER over xt of the depths of
    K4TC_D (36: q padded to 40, xt's depths past 36 read as zeros; not a
    multiple of 64; resident and streamed query tiles), with K4TC_RAGGED
    columns (duplicate rows, a filter) and 200 (150 live). K4's cases at D
    = 768 are phase 1's own."""
    g = torch.Generator(device="cuda").manual_seed(19)

    def shapes_of(D):
        return [("K4", B, k) for B in TC_B_OTHER for k in TC_K_OTHER]

    return _tc_cases(torch, mods, errs, g, shapes_of,
                     {torch.bfloat16: "K4tc", torch.float32: "K4tc3"}, depths=K4TC_D,
                     ragged=K4TC_RAGGED)


def phase1_k4tcr(torch, mods, errs) -> list:
    """K4 over an xt that TMA (bf16) or 16-byte pieces (f32) cannot read,
    through its wrapper, at K4TCR_B x K4TCR_K over each xt of K4TCR_XT (N
    % 8 != 0, or a base 2, 4 or 8 bytes past 16 as bf16, 4, 8 or 16 as f32;
    duplicate rows where N > 2,000, a filter, and 150 live columns of the
    297), each call held to the plain version: over the bf16 xt bf16
    queries launch K4tcr and f32 queries K4tc3r (the ragged-row producer's
    two MN-major boxes a stage), so that the producer's 8- and 4-byte
    pieces and realigned words, the zeros past N and D, and a split's last
    tile running past its end are each exercised; over the same values as
    an f32 xt f32 queries launch K4r (4-byte pieces) or, where N % 4 == 0
    and the base is 16-byte aligned, K4, each alone."""
    topk = mods["topk"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    cases = []
    for N, D, offset in K4TCR_XT:
        live = 150 if N == 297 else None
        x, bias = _tc_corpus(torch, g, dev, N, D, N > 2000, True, live)
        for xt_dtype in (torch.bfloat16, torch.float32):
            xt = _offset_copy(torch, x.T.contiguous().to(xt_dtype), offset)
            if xt_dtype == torch.bfloat16:
                require(not topk.xt_tma_readable(N, xt.data_ptr()),
                        f"phase 1: xt of N={N} at offset {offset} is one TMA reads")
                routes = {torch.bfloat16: "K4tcr", torch.float32: "K4tc3r"}
                piece = topk.load_piece(2 * N, xt.data_ptr())
            else:
                routes = {torch.float32: "K4" if topk.flat_route(xt) == "16-byte pieces" else "K4r"}
                piece = topk.load_piece(4 * N, xt.data_ptr())
            for B in K4TCR_B:
                q = _unit(torch, torch.randn(B, D, generator=g, device=dev))
                if N > 2000:
                    q[0] = x[5].float()  # its own duplicate pair tops the list
                for k in K4TCR_K:
                    for q_dtype, ran in routes.items():
                        qd = q.to(q_dtype)
                        (s_k, i_k), delta = _counted(
                            mods, lambda: topk.streaming_topk_cuda_qmajor_xt(qd, xt, bias, k))
                        torch.cuda.synchronize()
                        require(delta == {ran: 1}, f"phase 1: K4 over a {xt_dtype} xt of N={N} "
                                f"D={D} at offset {offset} with {q_dtype} queries, B={B} k={k}, "
                                f"launched {delta}, not {ran}")
                        s_p, i_p = topk.streaming_topk(qd, x, bias, k)
                        err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                                      judge=dot_judge(qd, x, bias))
                        errs[ran] = max(errs[ran], err)
                        cases.append({"kernel": f"{ran} (via K4)", "dtype": str(xt_dtype)[6:],
                                      "q_dtype": str(q_dtype)[6:], "N": N, "D": D,
                                      "offset": offset, "piece": piece, "B": B, "k": k,
                                      "live": live or N, "max_abs_err": err,
                                      "id_mismatches": n_diff, "mismatches_outside_ties": bad})
    return cases


def phase1_pieces_exact(torch, mods, errs) -> list:
    """The three-piece routes use every piece of an f32 query: over one-hot
    bf16 rows (row n is e_(n % D), so rows n and n + D tie exactly) each
    score is the one element q[n % D] (+ a zero bias) whatever the order
    of the sums, so K1tc (B = 1, 8, 9, 31) and K2tc3 (K2 at B = 33, 64,
    65, 129 and K3 at 129) must equal the plain version bit for bit. The
    queries carry 24 significant bits, so nearly every `lo` piece is
    nonzero and a kernel that dropped one would miss by 1e-7 to 1e-6.
    K4tc3 (K4 at B = 33, 65, 129) takes the first rows of a multiple of 8
    as xt, which TMA reads."""
    topk = mods["topk"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    cases = []
    for D, N in ((768, 3 * 768 + 5), (200, 1003)):
        x = torch.zeros(N, D, device=dev)
        x[torch.arange(N, device=dev), torch.arange(N, device=dev) % D] = 1.0
        x = x.to(torch.bfloat16)
        bias = torch.zeros(N, device=dev)
        bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = NEG_INF
        q = _unit(torch, torch.randn(129, D, generator=g, device=dev))
        lo_share = float((topk.split_bf16(q)[2] != 0).float().mean())
        require(lo_share > 0.9, f"phase 1: only {lo_share} of the lo pieces are nonzero")
        n8 = N - N % 8
        x8, bias8 = x[:n8], bias[:n8]
        xt8 = x8.T.contiguous()
        for kernel, ran, B in (("K1", "K1tc", 1), ("K1", "K1tc", 8), ("K1", "K1tc", 9),
                               ("K1", "K1tc", 31), ("K2", "K2tc3", 33), ("K2", "K2tc3", 64),
                               ("K2", "K2tc3", 65), ("K2", "K2tc3", 129), ("K3", "K2tc3", 129),
                               ("K4", "K4tc3", 33), ("K4", "K4tc3", 65), ("K4", "K4tc3", 129)):
            qb = q[:B].contiguous()
            rows, corpus, b_ = (x8, xt8, bias8) if kernel == "K4" else (x, x, bias)
            for k in (1, 30, 300, 1024):
                (s_k, i_k), delta = _counted(mods,
                                             lambda: wrapper(mods, kernel)(qb, corpus, b_, k))
                torch.cuda.synchronize()
                require(delta == {ran: 1}, f"phase 1: {kernel} over one-hot bf16 rows with f32 "
                        f"queries, B={B} D={D} k={k}, launched {delta}, not {ran}")
                s_p, i_p = topk.streaming_topk(qb, rows, b_, k)
                err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p, tol=0.0,
                                              judge=dot_judge(qb, rows, b_))
                errs[ran] = max(errs[ran], err)
                cases.append({"kernel": f"{ran} (via {kernel}, one-hot rows, exact)",
                              "dtype": "bfloat16", "q_dtype": "float32", "N": rows.shape[0],
                              "D": D, "B": B,
                              "k": k, "lo_nonzero": lo_share, "max_abs_err": err,
                              "id_mismatches": n_diff, "mismatches_outside_ties": bad})
    # the ragged-row producer's routes at widths TMA cannot read: a chunk
    # stored under the wrong swizzle, a stale byte of an earlier stage or a
    # byte past D would change a score; K4tc3r over the same rows as xt,
    # N = 3D + 5 columns (realigned words at D = 100, 8-byte pieces at 765)
    for D in (100, 765):
        N = 3 * D + 5
        x = torch.zeros(N, D, device=dev)
        x[torch.arange(N, device=dev), torch.arange(N, device=dev) % D] = 1.0
        x = x.to(torch.bfloat16)
        bias = torch.zeros(N, device=dev)
        bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = NEG_INF
        q = _unit(torch, torch.randn(129, D, generator=g, device=dev))
        xt = x.T.contiguous()
        for kernel, ran, B in (("K1", "K1tcr", 1), ("K1", "K1tcr", 8), ("K1", "K1tcr", 9),
                               ("K1", "K1tcr", 31), ("K2", "K2tc3r", 33), ("K2", "K2tc3r", 64),
                               ("K2", "K2tc3r", 65), ("K2", "K2tc3r", 129),
                               ("K3", "K2tc3r", 129), ("K4", "K4tc3r", 33), ("K4", "K4tc3r", 65),
                               ("K4", "K4tc3r", 129)):
            qb = q[:B].contiguous()
            corpus = xt if kernel == "K4" else x
            for k in (1, 30, 300):
                (s_k, i_k), delta = _counted(mods,
                                             lambda: wrapper(mods, kernel)(qb, corpus, bias, k))
                torch.cuda.synchronize()
                require(delta == {ran: 1}, f"phase 1: {kernel} over one-hot bf16 rows of width "
                        f"{D} with f32 queries, B={B} k={k}, launched {delta}, not {ran}")
                s_p, i_p = topk.streaming_topk(qb, x, bias, k)
                err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p, tol=0.0,
                                              judge=dot_judge(qb, x, bias))
                errs[ran] = max(errs[ran], err)
                cases.append({"kernel": f"{ran} (via {kernel}, one-hot rows, exact)",
                              "dtype": "bfloat16", "q_dtype": "float32", "N": N, "D": D, "B": B,
                              "k": k, "max_abs_err": err, "id_mismatches": n_diff,
                              "mismatches_outside_ties": bad})
    return cases


def ivfpq_state(torch, g, nlist, m, ksub, D, cap, dup=False):
    """Synthetic IVF-PQ cells on the card: unit centroids, small random
    codebooks, cells filled to random depths with unique row ids, 1% of
    the rows tombstoned; with dup, slots 8..15 of every cell repeat slots
    0..7 (the same codes in the same cell: exact ties, other ids)."""
    dev = torch.device("cuda")
    centroids = _unit(torch, torch.randn(nlist, D, generator=g, device=dev))
    books = 0.1 * torch.randn(m, ksub, D // m, generator=g, device=dev)
    codes = torch.randint(0, ksub, (nlist, m, cap), generator=g, device=dev).to(torch.uint8)
    fill = torch.randint(cap // 4, cap + 1, (nlist,), generator=g, device=dev)
    if dup:
        fill = torch.clamp(fill, min=16)
        codes[:, :, 8:16] = codes[:, :, 0:8]
    used = torch.arange(cap, device=dev)[None, :] < fill[:, None]
    n = int(used.sum())
    ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    ids[used] = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    bias = torch.where(used, 0.0, NEG_INF).float()
    dead = torch.rand(nlist, cap, generator=g, device=dev) < 0.01
    bias[dead & used] = NEG_INF
    return centroids, codes, ids, bias, books


def synthetic_ivfpq_cells(torch, g, nlist=4096, m=96, ksub=256, cap=4992, D=768):
    """Synthetic IVF-PQ cells at phase 7's shape (its list_cap), for the K8
    tools: each cell filled to a uniform depth in [cap / 4, 3 cap / 4]
    (about 10M rows at the defaults), random codes and codebooks, 1% of the
    rows tombstoned. (centroids, codes, ids, bias, books, fill)."""
    dev = torch.device("cuda")
    centroids = _unit(torch, torch.randn(nlist, D, generator=g, device=dev))
    books = 0.1 * torch.randn(m, ksub, D // m, generator=g, device=dev)
    codes = torch.randint(0, ksub, (nlist, m, cap), generator=g, device=dev, dtype=torch.uint8)
    fill = torch.randint(cap // 4, 3 * cap // 4 + 1, (nlist,), generator=g, device=dev)
    used = torch.arange(cap, device=dev)[None, :] < fill[:, None]
    ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    ids[used] = torch.randperm(int(used.sum()), generator=g, device=dev).to(torch.int32)
    bias = torch.where(used, 0.0, NEG_INF).float()
    dead = torch.rand(nlist, cap, generator=g, device=dev) < 0.01
    bias[dead & used] = NEG_INF
    return centroids, codes, ids, bias, books, fill.to(torch.int32).contiguous()


def adc_judge(torch, q, centroids, codes, ids, bias, books):
    """True scores of row ids for query b: the coarse dot plus the ADC of
    the row's codes plus its bias, in f64 (the kernel's function)."""
    nlist, m, cap = codes.shape
    loc = torch.full((int(ids.max()) + 2,), -1, dtype=torch.long, device=ids.device)
    live = ids >= 0
    loc[ids[live].long()] = torch.arange(nlist * cap, device=ids.device).view(nlist, cap)[live]
    dsub = books.shape[2]

    def judge(b, rows):
        cells, pos = loc[rows] // cap, loc[rows] % cap
        qb = q[b].double()
        table = (qb.view(m, dsub)[:, None, :] * books.double()).sum(-1)  # [m, ksub]
        cds = codes[cells, :, pos].long()                                  # [n, m]
        adc = table[torch.arange(m, device=q.device)[None, :], cds].sum(-1)
        return centroids[cells].double() @ qb + adc + bias[cells, pos].double()
    return judge


def phase1_k8(torch, mods, errs) -> list:
    """K8 against its plain version on synthetic cells, with the cells'
    fills as extents (and once without); the shared-memory plan against
    its Python counterpart."""
    ivfpq = mods["ivfpq"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    lib = ivfpq._lib()
    cases = []
    smem = [(lib.ivfpq_qmajor_smem(m, ks, npb, t), ivfpq.qmajor_smem(m, ks, npb, t))
            for m, ks, npb, t in ((96, 256, 64, 1), (96, 256, 4096, 0), (6, 16, 1, 1))]
    smem.append((lib.ivfpq_merge_max_k(), ivfpq.MERGE_MAX_K))
    # (the plan check counts as a case without mismatches: it fails the
    # phase on the spot)
    cases.append({"kernel": "K8", "check": "shared-memory plan vs the .cu", "pairs": smem,
                  "id_mismatches": 0, "mismatches_outside_ties": 0})
    require(all(a == b for a, b in smem), f"phase 1: K8 plan disagrees with the .cu: {smem}")
    # (nlist, m, ksub, D, cap, hot, [(nprobe, B, k), ...]); hot: every query
    # near centroid 0, so that one cell is probed by all of them
    states = (
        (256, 96, 256, 768, 512, False,
         [(1, 1, 1), (1, 600, 10), (1, 1, 1920), (8, 7, 10), (8, 600, 40), (8, 7, 300),
          (64, 1, 40), (64, 7, 300), (64, 300, 40), (64, 1, 1920), (64, 2, 5000),
          (64, 2, 20000), (256, 1, 10), (256, 300, 1920)]),
        (256, 96, 256, 768, 512, True, [(8, 600, 40), (8, 300, 300), (64, 40, 1), (1, 600, 300)]),
        (64, 16, 16, 768, 256, False, [(1, 1, 1), (8, 520, 40), (64, 1, 300), (64, 260, 10)]),
        (32, 6, 256, 48, 128, False, [(8, 3, 10), (32, 600, 300), (32, 3, 40), (1, 513, 1)]),
    )
    for si, (nlist, m, ksub, D, cap, hot, shapes) in enumerate(states):
        state = ivfpq_state(torch, g, nlist, m, ksub, D, cap, dup=True)
        centroids, codes, ids, bias, books = state
        fill = (ids >= 0).sum(1).to(torch.int32).contiguous()
        qs = _unit(torch, torch.randn(600, D, generator=g, device=dev))
        if hot:
            qs = _unit(torch, centroids[0] + 0.02 * qs)
        qs[1] = centroids[0]  # probes cell 0 first: its duplicate slots tie
        judge = adc_judge(torch, qs, *state)
        for nprobe, B, k in shapes:
            q = qs[:B].contiguous()
            s_p, i_p = ivfpq.ivfpq_search(q, centroids, codes, ids, bias, books, k, nprobe)
            for ext in ((fill, None) if si == 0 else (fill,)):
                s_k, i_k = ivfpq.ivfpq_search_cuda(q, centroids, codes, ids, bias, books, k,
                                                   nprobe, extents=ext)
                torch.cuda.synchronize()
                err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                              judge=judge)
                errs["K8"] = max(errs["K8"], err)
                live = int((s_p > NEG_INF / 2).sum(dim=1).min())
                cases.append({"kernel": "K8", "nlist": nlist, "m": m, "ksub": ksub, "cap": cap,
                              "hot_cell": hot, "nprobe": nprobe, "B": B, "k": k,
                              "extents": ext is not None, "min_live_results": live,
                              "max_abs_err": err, "id_mismatches": n_diff,
                              "mismatches_outside_ties": bad})
    # extents outside [0, cap] are clipped: negative on emptied cells, past
    # cap on the others, the same result as the plain version
    centroids, codes, ids, bias, books = ivfpq_state(torch, g, 64, 16, 256, 128, 256)
    ids[:8], bias[:8] = -1, NEG_INF
    fill = (ids >= 0).sum(1).to(torch.int32)
    ext = torch.where(fill == 0, -9, fill + 10_000).to(torch.int32).contiguous()
    q = _unit(torch, torch.randn(520, 128, generator=g, device=dev))
    q[:4] = centroids[:4]  # probe the emptied cells first
    s_p, i_p = ivfpq.ivfpq_search(q, centroids, codes, ids, bias, books, 40, 16)
    s_k, i_k = ivfpq.ivfpq_search_cuda(q, centroids, codes, ids, bias, books, 40, 16, extents=ext)
    torch.cuda.synchronize()
    err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                  judge=adc_judge(torch, q, centroids, codes, ids, bias, books))
    errs["K8"] = max(errs["K8"], err)
    cases.append({"kernel": "K8", "check": "extents outside [0, cap]", "B": 520, "k": 40,
                  "max_abs_err": err, "id_mismatches": n_diff, "mismatches_outside_ties": bad})
    return cases


def phase1_spill(mods) -> dict:
    """The compiled spill placement against the Python loop, on cells that
    overflow (skewed first choices) from a partly filled start."""
    ivf = mods["ivf"]
    rng = np.random.default_rng(9)
    nlist, cap, n = 64, 40, 3000
    top2 = np.stack([rng.zipf(1.6, n) % nlist, rng.integers(0, nlist, n)], 1).astype(np.int32)
    fill0 = rng.integers(0, cap, nlist).astype(np.int64)
    f_py, f_c = fill0.copy(), fill0.copy()
    a_py, p_py = ivf.spill_assign(top2, f_py, cap)
    a_c, p_c = ivf.spill_assign_host(top2, f_c, cap)
    third = int(sum(a != t0 and a != t1 for a, (t0, t1) in zip(a_py, top2)))
    return {"rows": n, "second_or_third_choice": int((a_py != top2[:, 0]).sum()),
            "third_choice": third,
            "equal": bool(np.array_equal(a_py, a_c) and np.array_equal(p_py, p_c)
                          and np.array_equal(f_py, f_c))}


# ---------------------------------------------------------------------------
# the host library (csrc/cghost.cpp): padded adjacency, trigram
# preselection, BM25; each held to its plain version (the Python loop
# beside its caller) in phase 1 and timed at real size in phase 2
# ---------------------------------------------------------------------------

HOST_ADJ_CHECK = (20_000, 80_000)        # phase 1: nodes, edges
HOST_ADJ_REAL = (1_000_000, 4_000_000)   # phase 2
HOST_MAX_DEG = 32                        # HybridSearch's max_deg
HOST_TRIGRAM = (20, 19_000)              # targets, symbols (codegraph_tpu/ has ~19k)
HOST_BM25_DOCS = 100_000
HOST_BM25_K = 200                        # HybridSearch's BM25 fetch at limit 10 is 30
HOST_RTOL = 1e-5
HOST_WORDS = ("parse file load config render page compute checksum total graph node edge "
              "index search query token chunk plan budget embed vector score rank filter "
              "cache store snapshot manifest resolve symbol import module class method "
              "function call path root tree lexer string comment batch shard merge").split()
_host_data: dict = {}


def host_graph(n, m, seed):
    """CSR of n nodes and m edges shaped like codegraph_tpu/'s own graph,
    whose heaviest hub holds ~6% of the edges: 15% of the sources are
    Zipf-ranked hubs (the first ~6.6% of all edges), the rest uniform;
    weights from a small set (ties at every cut), self loops, edge types
    that boost and that do not."""
    from codegraph_tpu_torch.core.types import EDGE_TYPE_CODES
    from codegraph_tpu_torch.graph.csr import build_csr

    rng = np.random.default_rng(seed)
    src = np.where(rng.random(m) < 0.15, (rng.zipf(1.6, m) - 1) % n, rng.integers(0, n, m))
    dst = rng.integers(0, n, m)
    codes = np.array(sorted(EDGE_TYPE_CODES.values()), np.int16)
    et = codes[rng.integers(0, len(codes), m)]
    w = rng.choice(np.array([0.25, 0.5, 1.0, 2.0], np.float32), m)
    return build_csr(n, src, dst, et, w)


def adjacency_row_right(csr, row, table, max_deg) -> bool:
    """One row of a padded-adjacency table against the CSR: each kept
    neighbour with the weight, edge type and direction of its heaviest
    boost edge (outgoing first on a tie), no neighbour twice, and the
    heaviest min(degree, max_deg) weights kept."""
    from codegraph_tpu_torch.graph.csr import BOOST_EDGE_CODES

    truth = {}
    for ptr, ids, ets, ws, d in ((csr.indptr, csr.indices, csr.etype, csr.weight, 0),
                                 (csr.r_indptr, csr.r_indices, csr.r_etype, csr.r_weight, 1)):
        for j in range(int(ptr[row]), int(ptr[row + 1])):
            if int(ets[j]) in BOOST_EDGE_CODES:
                i = int(ids[j])
                if i not in truth or float(ws[j]) > truth[i][0]:
                    truth[i] = (float(ws[j]), int(ets[j]), d)
    nbr, wgt, et, dirn = (t[row] for t in table)
    kept = [(int(i), (float(w), int(e), int(d))) for i, w, e, d in zip(nbr, wgt, et, dirn) if i >= 0]
    heaviest = sorted((w for w, _, _ in truth.values()), reverse=True)[:max_deg]
    return (len({i for i, _ in kept}) == len(kept) == len(heaviest)
            and all(truth.get(i) == v for i, v in kept)
            and sorted((v[0] for _, v in kept), reverse=True) == heaviest)


def adjacency_mismatches(csr, a, b, max_deg) -> int:
    """Rows where two padded-adjacency tables differ and one of them is
    wrong by `adjacency_row_right` (two right rows differ only among the
    neighbours tied at a full row's cut, or in order)."""
    differ = np.zeros(a[0].shape[0], bool)
    for ta, tb in zip(a, b):
        differ |= (ta != tb).any(1)
    return sum(not (adjacency_row_right(csr, row, a, max_deg)
                    and adjacency_row_right(csr, row, b, max_deg))
               for row in np.nonzero(differ)[0])


def host_symbols(n, seed):
    """n distinct identifiers of one to four words, snake_case or
    CamelCase, a few with a non-ASCII letter."""
    rng = np.random.default_rng(seed)
    out = {}
    while len(out) < n:
        parts = list(rng.choice(HOST_WORDS, int(rng.integers(1, 5))))
        name = "".join(w.capitalize() for w in parts) if rng.random() < 0.3 else "_".join(parts)
        if rng.random() < 0.01:
            name += "\u00e9"
        out[name] = None
    return list(out)


def host_targets(symbols, n, seed):
    """n call targets: symbols one edit away (a letter dropped, added or
    recased), one with ten tied candidates, one with none."""
    rng = np.random.default_rng(seed)
    out = []
    for name in rng.choice(symbols, n - 2, replace=False):
        i = int(rng.integers(0, len(name)))
        edit = int(rng.integers(0, 3))
        out.append(name[:i] + name[i + 1:] if edit == 0 else
                   name[:i] + "s" + name[i:] if edit == 1 else name.swapcase())
    return out + ["plan_budget_x", "zzqxv"]


def preselect_mismatches(targets, symbols, a, b) -> int:
    """Targets whose preselections differ outside ties: other scores, or
    other ids but among those at a full row's cut score (each checked
    against its own jaccard)."""
    from codegraph_tpu_torch.native import _fnv_trigrams

    (ia, sa), (ib, sb) = a, b
    bad = 0
    for row, target in enumerate(targets):
        if not np.array_equal(sa[row], sb[row]) or not np.array_equal(ia[row] >= 0, ib[row] >= 0):
            bad += 1
            continue
        va = ia[row] >= 0
        if set(ia[row][va]) == set(ib[row][va]):
            continue
        cut = sa[row][-1]
        keep = sa[row] > cut
        tt = _fnv_trigrams(target)

        def jac(j):
            st = _fnv_trigrams(symbols[int(j)])
            n = len(tt & st)
            return np.float32(n) / np.float32(len(tt) + len(st) - n)

        if not va.all() or set(ia[row][keep]) != set(ib[row][keep]) or \
                any(jac(j) != cut for j in list(ia[row][~keep]) + list(ib[row][~keep])):
            bad += 1
    return bad


def host_bm25():
    """A BM25Index of HOST_BM25_DOCS docs (3-60 tokens of a 20,000-term
    vocabulary, Zipf) and five queries of five common terms; built once
    (phase 1 checks it, phase 2 times it)."""
    if "bm25" not in _host_data:
        from codegraph_tpu_torch.search.bm25 import BM25Index

        rng = np.random.default_rng(21)
        vocab = [f"{HOST_WORDS[i % len(HOST_WORDS)]}{i}" for i in range(20_000)]
        p = 1.0 / np.arange(1, len(vocab) + 1) ** 1.1
        lens = rng.integers(3, 61, HOST_BM25_DOCS)
        ids = rng.choice(len(vocab), int(lens.sum()), p=p / p.sum())
        index, off = BM25Index(), 0
        t0 = time.perf_counter()
        for d, n in enumerate(lens):
            index.add(d, " ".join(vocab[i] for i in ids[off:off + n]))
            off += n
        queries = [" ".join(vocab[i] for i in rng.choice(40, 5, replace=False)) for _ in range(5)]
        _host_data["bm25"] = (index, queries, time.perf_counter() - t0)
    return _host_data["bm25"]


def bm25_mismatches(index, terms, avg_len, a, b, rtol=HOST_RTOL) -> int:
    """Positions where two (doc, score) lists, highest first, differ
    outside ties: a score off by more than rtol, or a doc on one side only
    whose own score (recomputed in f64) is not the cut's."""
    if len(a) != len(b):
        return max(len(a), len(b))
    sa = np.array([x for _, x in a])
    sb = np.array([x for _, x in b])
    bad = int((np.abs(sa - sb) > rtol * np.abs(sa)).sum())
    cut = sa[-1] if len(sa) else 0.0
    for d in dict(a).keys() ^ dict(b).keys():
        score = 0.0
        for t in terms:
            tf = index.postings[t].get(d, 0)
            if tf:
                dl = index.doc_len[d]
                score += index._idf(t) * tf * (index.k1 + 1) / (
                    tf + index.k1 * (1 - index.b + index.b * dl / avg_len))
        bad += abs(score - cut) > rtol * abs(cut)
    return bad


def _host_query_terms(index, query):
    from codegraph_tpu_torch.search.bm25 import tokenize

    return [t for t in set(tokenize(query)) if t in index.postings], index.total_len / index.n_docs


def phase1_host() -> dict:
    """Each function of the host library against its plain version at a
    check size: padded adjacency over 20,000 nodes and 80,000 edges,
    trigram preselection of 20 targets over 19,000 symbols, BM25 over
    100,000 docs (five queries, top 200)."""
    from codegraph_tpu_torch import native

    t_all = time.perf_counter()
    native.lib()  # built in phase 0: load it (and key it) before timing a call
    out = {}
    csr = host_graph(*HOST_ADJ_CHECK, seed=5)
    t0 = time.perf_counter()
    lib = csr.padded_adjacency(max_deg=HOST_MAX_DEG)
    t1 = time.perf_counter()
    plain = csr.padded_adjacency_plain(max_deg=HOST_MAX_DEG)
    t2 = time.perf_counter()
    out["padded_adjacency"] = {
        "nodes": HOST_ADJ_CHECK[0], "edges": HOST_ADJ_CHECK[1], "max_deg": HOST_MAX_DEG,
        "rows_cut": int(((lib[0] >= 0).sum(1) == HOST_MAX_DEG).sum()),
        "rows_ordered_otherwise": int((lib[0] != plain[0]).any(1).sum()),
        "ms": round((t1 - t0) * 1e3, 3), "plain_ms": round((t2 - t1) * 1e3, 3),
        "mismatches_outside_ties": adjacency_mismatches(csr, lib, plain, HOST_MAX_DEG)}

    symbols = host_symbols(HOST_TRIGRAM[1], seed=6)
    targets = host_targets(symbols, HOST_TRIGRAM[0], seed=7)
    symbols += [f"plan_budget_{c}" for c in "abcdefghij"]  # ten ties for eight places
    t0 = time.perf_counter()
    lib = native.trigram_preselect_native(targets, symbols, 0.3, 8)
    t1 = time.perf_counter()
    plain = native.trigram_preselect_plain(targets, symbols, 0.3, 8)
    t2 = time.perf_counter()
    out["trigram_preselect"] = {
        "targets": len(targets), "symbols": len(symbols), "top_j": 8,
        "candidates": int((lib[0] >= 0).sum()), "targets_without": int((lib[0] < 0).all(1).sum()),
        "ms": round((t1 - t0) * 1e3, 3), "plain_ms": round((t2 - t1) * 1e3, 3),
        "mismatches_outside_ties": preselect_mismatches(targets, symbols, lib, plain)}

    index, queries, build_s = host_bm25()
    ms, plain_ms, bad = [], [], 0
    for q in queries:
        terms, avg = _host_query_terms(index, q)
        t0 = time.perf_counter()
        lib = index._search_native(terms, avg, HOST_BM25_K)
        t1 = time.perf_counter()
        plain = index._search_plain(terms, avg, HOST_BM25_K)
        t2 = time.perf_counter()
        ms.append((t1 - t0) * 1e3)
        plain_ms.append((t2 - t1) * 1e3)
        bad += bm25_mismatches(index, terms, avg, lib, plain)
    out["bm25"] = {"docs": index.n_docs, "queries": len(queries), "top": HOST_BM25_K,
                   "index_build_seconds": round(build_s, 3),
                   "ms": round(statistics.median(ms), 3),
                   "plain_ms": round(statistics.median(plain_ms), 3),
                   "mismatches_outside_ties": bad}
    out["seconds"] = round(time.perf_counter() - t_all, 3)
    return out


def host_real_size() -> dict:
    """The host library's functions alone at real size: padded adjacency
    over 1,000,000 nodes and 4,000,000 edges (its plain version, ~100 s
    there, is timed at phase 1's size), and BM25 over phase 1's 100,000
    docs beside its plain version (median of five queries)."""
    from codegraph_tpu_torch import native

    t0 = t_all = time.perf_counter()
    csr = host_graph(*HOST_ADJ_REAL, seed=8)
    t1 = time.perf_counter()
    nbr, _, _, _ = csr.padded_adjacency(max_deg=HOST_MAX_DEG)
    t2 = time.perf_counter()
    out = {"padded_adjacency": {"nodes": HOST_ADJ_REAL[0], "edges": HOST_ADJ_REAL[1],
                                "max_deg": HOST_MAX_DEG, "csr_build_ms": round((t1 - t0) * 1e3, 3),
                                "ms": round((t2 - t1) * 1e3, 3),
                                "rows_cut": int(((nbr >= 0).sum(1) == HOST_MAX_DEG).sum())}}
    index, queries, _ = host_bm25()
    ms, plain_ms = [], []
    for q in queries:
        terms, avg = _host_query_terms(index, q)
        t0 = time.perf_counter()
        before = native.calls["bm25_score"]
        index.search(q, HOST_BM25_K)
        t1 = time.perf_counter()
        index._search_plain(terms, avg, HOST_BM25_K)
        t2 = time.perf_counter()
        require(native.calls["bm25_score"] == before + 1, "BM25Index.search did not score in the host library")
        ms.append((t1 - t0) * 1e3)
        plain_ms.append((t2 - t1) * 1e3)
    out["bm25_search"] = {"docs": index.n_docs, "queries": len(queries), "top": HOST_BM25_K,
                          "ms": round(statistics.median(ms), 3),
                          "plain_ms": round(statistics.median(plain_ms), 3)}
    out["seconds"] = round(time.perf_counter() - t_all, 3)
    return out


QUERIES = [
    "parse a source file into nodes and edges",
    "streaming top-k kernel over the corpus",
    "hybrid search with bm25 and graph boost",
    "save the index snapshot manifest",
    "resolve call edges between symbols",
]


def phase2(torch, mods, errs, dtype="float32", phase=2, D=768, kernels=None) -> dict:
    """The main path over a flat index of `dtype` at embedding width D: K1
    for the 5 searches, K2 for the service's batches (over bf16 rows the
    tensor cores: K1tc and K2tc); `kernels` (single, batched) names the
    routes another width takes, which must launch, and no other."""
    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.core.config import CodeGraphConfig
    from codegraph_tpu_torch.ops.cuda_build import host_cpu_model
    from codegraph_tpu_torch.search.service import QueryService

    src = os.path.join(ROOT, "codegraph_tpu")
    require(os.path.isdir(src), f"no JAX package source at {src} to index")
    tmp = tempfile.mkdtemp(prefix="cg_smoke_")
    svc = None
    try:
        proj = os.path.join(tmp, "codegraph_tpu")
        shutil.copytree(src, proj, ignore=shutil.ignore_patterns("__pycache__"))
        cfg = CodeGraphConfig()
        cfg.embedding.provider = "hash"
        cfg.embedding.dimension = D
        cfg.data_dir = os.path.join(tmp, "data")
        cfg.index.dtype = dtype
        single_kernel, batched_kernel = kernels or (
            ("K1tc", "K2tc") if dtype == "bfloat16" else ("K1", "K2"))

        topk = mods["topk"]
        reset_launches(mods)
        host_calls = reset_host_calls()
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        stats = cg.index()
        t_index = time.perf_counter() - t0

        t0 = time.perf_counter()
        with StageTimer(torch, hybrid_parts(cg)) as first_parts:
            hits = [cg.search(QUERIES[0], limit=10)]
        t_first = time.perf_counter() - t0
        with StageTimer(torch, hybrid_parts(cg)) as second_parts:
            hits.append(cg.search(QUERIES[1], limit=10))
        t_second = time.perf_counter() - t0 - t_first
        hits += [cg.search(qt, limit=10) for qt in QUERIES[2:]]
        t_search = time.perf_counter() - t0

        index = cg.indexer.index
        texts = [f"{QUERIES[i % 5]} variant {i}" for i in range(64)]
        embs = cg.indexer.provider.embed_texts(texts)
        k = 30
        t0 = time.perf_counter()
        svc = QueryService.auto(index, k=k)
        futures = [svc.submit(e) for e in embs]
        batched = [f.result(timeout=120) for f in futures]
        svc.close()
        svc_stats = svc.stats
        svc = None
        t_service = time.perf_counter() - t0
        # the main path ends here; later launches only check results
        launches = read_launches(mods)
        host_calls = dict(host_calls)
        singles = [index.search(e[None, :], k) for e in embs]

        # batched (K2) vs single (K1) results on the same index; the queries
        # as the index scores them (a bf16 index: bf16 queries)
        x, bias = index.arrays()
        require(x.dtype == getattr(torch, dtype), f"phase {phase}: the index holds {x.dtype} rows")
        require(x.shape[1] == D, f"phase {phase}: the index holds rows of width {x.shape[1]}")
        qn = torch.nn.functional.normalize(torch.as_tensor(embs, device="cuda"), dim=1).to(x.dtype)
        s_b = torch.as_tensor(np.stack([b[0] for b in batched]), device="cuda")
        i_b = torch.as_tensor(np.stack([b[1] for b in batched]), device="cuda")
        s_1 = torch.as_tensor(np.stack([s[0][0] for s in singles]), device="cuda")
        i_1 = torch.as_tensor(np.stack([s[1][0] for s in singles]), device="cuda")
        err_svc, diff_svc, bad_svc = check_topk(torch, qn, x, bias, s_b, i_b, s_1, i_1)
        errs[batched_kernel] = max(errs[batched_kernel], err_svc)

        # each kernel against its plain version at the main path's shapes
        main_shapes = {}
        for name, fn, B in ((single_kernel, topk.streaming_topk_cuda, 1),
                            (batched_kernel, topk.streaming_topk_cuda_qmajor, 64)):
            s_k, i_k = fn(qn[:B].contiguous(), x, bias, k)
            s_p, i_p = topk.streaming_topk(qn[:B], x, bias, k)
            e, n_d, b_d = check_topk(torch, qn[:B], x, bias, s_k, i_k, s_p, i_p)
            errs[name] = max(errs[name], e)
            main_shapes[name] = {"N": int(x.shape[0]), "B": B, "k": k, "max_abs_err": e,
                                 "id_mismatches": n_d, "mismatches_outside_ties": b_d}

        # the same snapshot searched on the CPU (plain versions) as reference
        cpu = CodeGraph(cfg, device="cpu")
        hybrid = _hybrid_vs_cpu(torch, cg, cpu, hits, k,
                                lambda q: dot_judge(q.to(x.dtype), x, bias))
        out = {
            "phase": phase, "index_dtype": dtype, "D": D, "files": stats.files_total,
            "nodes": stats.nodes,
            "chunks": stats.chunks, "edges": stats.edges_total,
            "index_rows": index.n_rows, "index_capacity": index.capacity,
            "index_seconds": round(t_index, 3),
            "stage_seconds": {k: round(v, 3) for k, v in stats.stage_seconds.items()},
            "resolve_seconds": round(stats.stage_seconds["resolve"], 3),
            "search_seconds_5": round(t_search, 3),
            "first_search_ms": round(t_first * 1e3, 3),
            "first_search_parts_ms": _parts_ms(first_parts, t_first),
            "second_search_ms": round(t_second * 1e3, 3),
            "second_search_parts_ms": _parts_ms(second_parts, t_second),
            "search_perf": cg.indexer.search.monitor.report(),
            "host_library_calls": host_calls,
            "service_seconds_64": round(t_service, 3),
            "service_batches": svc_stats.batches, "service_max_batch": svc_stats.max_batch_seen,
            "launches": launches,
            "top1": [h[0].name if h else None for h in hits],
            "service_vs_single": {"max_abs_err": err_svc, "id_mismatches": diff_svc,
                                  "mismatches_outside_ties": bad_svc},
            "hybrid_vs_cpu": hybrid,
            "kernel_vs_plain_main_shapes": main_shapes,
            "gpu": nvidia_smi_line(), "cpu": host_cpu_model(),
        }
        emit(out)
        if phase == 2:  # the host library alone at real size, beside the main path
            out["host_real_size"] = host_real_size()
            emit({"phase": phase, "host_real_size": out["host_real_size"],
                  "gpu": out["gpu"], "cpu": out["cpu"]})
        require(all(host_calls.values()),
                f"phase {phase}: the main path did not call every host function: {host_calls}")
        require(stats.nodes > 0 and stats.chunks > 0 and stats.edges_total > 0, "empty index")
        require(bad_svc == 0, f"phase {phase}: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                f"phase {phase}: a kernel disagrees with its plain version at the main path's shapes")
        require(hybrid["mismatches_outside_ties"] == 0,
                f"phase {phase}: CUDA hybrid results disagree with the CPU path")
        require(launches[single_kernel] > 0 and launches[batched_kernel] > 0,
                f"phase {phase}: main path did not launch {single_kernel} and {batched_kernel}: "
                f"{launches}")
        require(all(v == 0 for k_, v in launches.items() if k_ not in (single_kernel, batched_kernel)),
                f"phase {phase}: main path launched another kernel than {single_kernel} and "
                f"{batched_kernel}: {launches}")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


def reset_host_calls() -> dict:
    """The host library's call counts, set to 0: called just before a main
    path; the dict is live, so read (copy) it just after."""
    from codegraph_tpu_torch import native

    for name in native.calls:
        native.calls[name] = 0
    return native.calls


def hybrid_parts(cg) -> dict:
    """StageTimer's targets for CodeGraph.search: the query's embedding, the
    vector search (the kernel and its copies), BM25, and the graph boost
    (the device gather and compare), of it the boost table's build (the
    host library's padded adjacency, then its copy to the card)."""
    hs = cg.indexer.search
    return {"embed_query": (hs.provider, "embed_texts"), "vector_search": (hs.index, "search"),
            "bm25": (hs.bm25, "search"), "graph_boost": (hs, "_graph_boost"),
            "boost_table": (hs, "_adjacency")}


def _parts_ms(timer, total_s) -> dict:
    """The parts' ms, and "other": the search's ms outside them (the boost
    table is inside the graph boost)."""
    out = {name: round(sec * 1e3, 3) for name, sec in timer.seconds.items()}
    if out:
        out["other"] = round(total_s * 1e3 - sum(v for k, v in out.items() if k != "boost_table"), 3)
    return out


def phase15(torch, mods, errs) -> dict:
    """The bf16 main path: phase 2 with index.dtype = "bfloat16" (the flat
    tier the planner picks from 200k rows), so the searches run K1tc and
    QueryService's batches K2tc through FlatIndex.search."""
    return phase2(torch, mods, errs, dtype="bfloat16", phase=15)


#: phase 17: the width of the main path at an embedding width TMA's tiled
#: mode cannot read for every dtype (f32 rows 400 bytes: 16-byte pieces;
#: bf16 rows 200 bytes: the ragged producer's 8-byte pieces; int8 rows 100
#: bytes: K5's words and the ragged producer's 4-byte pieces), and the
#: 8-shard indexes' rows at that width
RAGGED_MAIN_D = 100
RAGGED_SHARD_N = 1_000_000


def phase17(torch, mods, errs) -> dict:
    """The main path at embedding.dimension = 100 (`RAGGED_MAIN_D`), on the
    hash provider, through CodeGraph.open -> .index() -> .search() ->
    QueryService as phases 2 and 4 run it, with index.dtype "float32" (K1,
    K2 on their 16-byte pieces), "bfloat16" (K1tcr, K2tcr) and "int8" (K5's
    words, K6r): each run launches its routes and no other (no TMA
    instance); then an 8-shard search at that width (bf16 and int8 rows on
    phase 13's mesh) against one unsharded scan of the same route."""
    D = RAGGED_MAIN_D
    runs = {"float32": phase2(torch, mods, errs, "float32", 17, D, ("K1", "K2")),
            "bfloat16": phase2(torch, mods, errs, "bfloat16", 17, D, ("K1tcr", "K2tcr")),
            "int8": phase4(torch, mods, errs, 17, D, ("K5", "K6r"))}
    mesh8 = _mesh(torch, (SHARDS,), ("data",))
    reset_launches(mods)
    sharded = _phase17_sharded(torch, mods, errs, mesh8, D)
    shard_launches = read_launches(mods)
    launches = {name: sum(r["launches"][name] for r in runs.values()) + shard_launches[name]
                for name in KERNELS}
    out = {"phase": 17, "D": D, "launches": launches, "shard_launches": shard_launches,
           "runs": {k: {"launches": {n: v for n, v in r["launches"].items() if v}}
                    for k, r in runs.items()},
           "sharded": sharded}
    emit(out)
    require(all(launches[k] > 0 for k in ("K1", "K2", "K1tcr", "K2tcr", "K2tc3r", "K5", "K6r")),
            f"phase 17: a route of the width-100 paths never launched: {launches}")
    require(all(launches[k] == 0 for k in ("K1tc", "K2tc", "K2tc3", "K6")),
            f"phase 17: a TMA instance launched at D = {D}: {launches}")
    return out


def _phase17_sharded(torch, mods, errs, mesh8, D) -> list:
    """ShardedFlatIndex (bf16 rows: f32 queries, K1tcr at B = 8, K2tc3r at
    B = 1024 on every shard) and ShardedInt8Index (K5 at B = 8, K6r at B =
    256) over RAGGED_SHARD_N rows of width D, each search held to one scan
    of the same route over all rows (the unsharded index's) and to the
    oracle; the int8 candidates to the plain version."""
    from codegraph_tpu_torch.ops import quantize as q8
    from codegraph_tpu_torch.parallel import sharded_search as ss

    topk = mods["topk"]
    N = RAGGED_SHARD_N
    g = torch.Generator(device="cuda").manual_seed(SHARD_SEED + 17)
    out = []
    rows = torch.randn(N, D, generator=g, device="cuda")
    dead = torch.randperm(N, generator=g, device="cuda")[: N // 100].cpu().numpy()
    flat = ss.ShardedFlatIndex(D, mesh8, dtype="bfloat16", tile_n=1024)
    flat.build(rows)
    flat.delete(dead)
    x_full, b_full = flat._x.full, flat._bias.full
    for B, k, kernel in ((8, 10, "K1tcr"), (1024, 100, "K2tc3r")):
        q = _unit(torch, torch.randn(B, D, generator=g, device="cuda"))
        (s_np, i_np), delta = _counted(mods, lambda: flat.search(q, k))
        _require_per_shard(delta, kernel, SHARDS, f"bf16 ShardedFlatIndex.search D={D} B={B}")
        qn = ss._normalize_rows(q)
        scan = topk.streaming_topk_cuda_qmajor if B >= 32 else topk.streaming_topk_cuda
        s_u, i_u = _uncounted(mods, lambda: scan(qn, x_full, b_full, k))
        s_ref, i_ref = _sharded_oracle(torch, qn, flat.x_shards, flat.bias_shards, k)
        got = _host_result(torch, s_np, i_np)
        e_u, d_u, bad_u = check_topk(torch, qn, x_full, b_full, *got, s_u, i_u)
        e_o, d_o, bad_o = check_topk(torch, qn, x_full, b_full, *got, s_ref, i_ref)
        errs[kernel] = max(errs[kernel], e_o)
        row = {"phase": 17, "index": "ShardedFlatIndex", "dtype": "bfloat16", "N": N, "D": D,
               "shards": SHARDS, "B": B, "k": k, "kernel": kernel, "launches_per_search": delta,
               "vs_unsharded": {"max_abs_err": e_u, "id_mismatches": d_u,
                                "mismatches_outside_ties": bad_u},
               "vs_oracle": {"max_abs_err": e_o, "id_mismatches": d_o,
                             "mismatches_outside_ties": bad_o}}
        emit(row)
        out.append(row)
        require(bad_u == 0 and bad_o == 0, f"phase 17: bf16 ShardedFlatIndex D={D} B={B}: "
                f"{bad_u} mismatches against the unsharded scan, {bad_o} against the oracle")
    del flat, x_full, b_full
    int8 = ss.ShardedInt8Index(D, mesh8, rescore_k=100)
    int8.build(rows)
    int8.delete(dead)
    del rows
    qv_full, qs_full, b_full = int8._qv.full, int8._qs.full, int8._bias.full
    for B, k, kernel in ((8, 10, "K5"), (256, 10, "K6r")):
        q = _unit(torch, torch.randn(B, D, generator=g, device="cuda"))
        (s_np, i_np), delta = _counted(mods, lambda: int8.search(q, k))
        _require_per_shard(delta, kernel, SHARDS, f"ShardedInt8Index.search D={D} B={B}")
        cand = int8.rescore_k
        qv, qs = q8.quantize_rows(ss._normalize_rows(q))
        s_k, i_k = _uncounted(mods, lambda: ss.sharded_topk_int8(
            qv, qs, int8._qv.shards, int8._qs.shards, int8._bias.shards, cand, mesh8))
        one = q8.streaming_topk_int8_cuda_qmajor if B >= 32 else q8.streaming_topk_int8_cuda
        s_u, i_u = _uncounted(mods, lambda: one(qv, qs, qv_full, qs_full, b_full, cand))
        s_p, i_p = q8.streaming_topk_int8(qv, qs, qv_full, qs_full, b_full, cand)
        judge = int8_judge(qv, qs, qv_full, qs_full, b_full)
        e_u, d_u, bad_u = check_topk(torch, None, None, None, s_k, i_k, s_u, i_u, judge=judge)
        e_p, d_p, bad_p = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p, judge=judge)
        bad_p += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
        live = ~np.isin(i_np, dead) & (i_np >= 0)
        ok = bool(live.all() and (np.diff(s_np, axis=1) <= 0).all() and np.isfinite(s_np).all())
        errs[kernel] = max(errs[kernel], e_p)
        row = {"phase": 17, "index": "ShardedInt8Index", "dtype": "int8", "N": N, "D": D,
               "shards": SHARDS, "B": B, "k": k, "rescore_k": cand, "kernel": kernel,
               "launches_per_search": delta,
               "candidates_vs_unsharded": {"max_abs_err": e_u, "id_mismatches": d_u,
                                           "mismatches_outside_ties": bad_u},
               "candidates_vs_plain": {"max_abs_err": e_p, "id_mismatches": d_p,
                                       "mismatches_outside_ties": bad_p},
               "results_ok": ok}
        emit(row)
        out.append(row)
        require(bad_u == 0 and bad_p == 0 and ok, f"phase 17: ShardedInt8Index D={D} B={B}: "
                f"{bad_u} and {bad_p} mismatches, results ok={ok}")
    del int8, qv_full, qs_full, b_full
    torch.cuda.empty_cache()
    return out


CARD_TESTS = "tests/test_torch_card.py"


def phase16(torch, mods, errs) -> dict:
    """The card's pytest cases (tests/test_torch_card.py, which imports no
    JAX) in a subprocess on this card, without the conftest (it imports
    JAX): every collected case must pass, none may skip."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
           CARD_TESTS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    counts = {word: int(n) for n, word in re.findall(r"(\d+) (passed|failed|skipped|errors?|"
                                                     r"xfailed|xpassed|deselected)", tail)}
    out = {"phase": 16, "command": " ".join(cmd[1:]), "rc": proc.returncode, "summary": tail,
           "counts": counts, "seconds": round(seconds, 3)}
    emit(out)
    print(f"card tests passed: {counts.get('passed', 0)}", flush=True)
    if proc.returncode != 0 or set(counts) != {"passed"}:
        print(proc.stdout[-6000:], file=sys.stderr)
        print(proc.stderr[-3000:], file=sys.stderr)
    require(proc.returncode == 0, f"phase 16: the card tests failed (rc {proc.returncode}): {tail}")
    require(counts.get("passed", 0) > 0, f"phase 16: no card test ran: {tail}")
    require(set(counts) == {"passed"}, f"phase 16: card tests skipped or failed: {tail}")
    return out


def _time_ms(torch, fn, batches, outs=None):
    """Median ms of fn(batch) over batches (one launch each, CUDA events);
    fn's results are appended to `outs` when it is given."""
    fn(batches[0])  # warm
    times = []
    for qb in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(qb)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        if outs is not None:
            outs.append(out)
    return statistics.median(times)


def yardstick(torch, q, x, bias, k, chunk=131072, xt=False):
    """Chunked torch.matmul + torch.topk (library calls; used only here);
    xt: x is the corpus as xt [D, N], read in chunks of its columns."""
    ss, ii = [], []
    qf = q.float()
    for base in range(0, x.shape[1] if xt else x.shape[0], chunk):
        if xt:
            s = qf @ x[:, base: base + chunk].float() + bias[base: base + chunk]
        else:
            s = qf @ x[base: base + chunk].float().T + bias[base: base + chunk]
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        ss.append(v)
        ii.append(i + base)
    s = torch.cat(ss, 1)
    v, p = torch.topk(s, k, dim=1)
    return v, torch.gather(torch.cat(ii, 1), 1, p).int()


def yardstick_tc(torch, q, x, bias, k, chunk=131072):
    """The same function for bf16 q and x on the tensor cores: chunked
    torch.mm(q, x.T, out_dtype=torch.float32) (bf16 products, f32 sums) +
    torch.topk (library calls; used only here)."""
    ss, ii = [], []
    for base in range(0, x.shape[0], chunk):
        s = torch.mm(q, x[base: base + chunk].T, out_dtype=torch.float32) + bias[base: base + chunk]
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        ss.append(v)
        ii.append(i + base)
    s = torch.cat(ss, 1)
    v, p = torch.topk(s, k, dim=1)
    return v, torch.gather(torch.cat(ii, 1), 1, p).int()


def yardstick_tc_xt(torch, q, xt, bias, k, chunk=131072):
    """yardstick_tc on the layout K4 reads, xt [D, N]: chunked torch.mm(q,
    xt[:, base:base + chunk], out_dtype=torch.float32) + torch.topk
    (library calls; used only here)."""
    ss, ii = [], []
    for base in range(0, xt.shape[1], chunk):
        s = torch.mm(q, xt[:, base: base + chunk], out_dtype=torch.float32) + bias[base: base + chunk]
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        ss.append(v)
        ii.append(i + base)
    s = torch.cat(ss, 1)
    v, p = torch.topk(s, k, dim=1)
    return v, torch.gather(torch.cat(ii, 1), 1, p).int()


def _bound(nbytes: float, ops: float, dtype_name: str):
    """(bound ms, what sets it): bytes over the memory rate or operations
    over the peak rate of the type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase3(torch, topk, errs) -> list:
    from codegraph_tpu_torch.index.flat import FlatIndex

    dev = torch.device("cuda")
    rows_out = []
    # 768, and the widths whose rows the ragged routes read (f32 765: 4-byte
    # pieces, beside K1 and K2 at 764; bf16 764: the ragged-row producer's
    # 8-byte pieces); then K4 over bf16 xt of N columns that TMA cannot read
    # and over f32 xt of N columns that 16-byte pieces cannot read
    for dtype_name, D, N in (("float32", 768, 1_000_000), ("bfloat16", 768, 1_000_000),
                             ("float32", 765, 1_000_000), ("float32", 764, 1_000_000),
                             ("bfloat16", 764, 1_000_000),
                             *(("bfloat16", 768, n) for n in K4TCR_TIMED_N),
                             *(("float32", 768, n) for n in K4R_TIMED_N)):
        g = torch.Generator(device=dev).manual_seed(2024)
        t0 = time.perf_counter()
        f32, bf16 = torch.float32, torch.bfloat16
        x, xt, idx = None, None, None
        xt_only = N in K4TCR_TIMED_N + K4R_TIMED_N
        if xt_only:  # only xt [D, N] is read: made directly, no index
            bias = torch.zeros(N, device=dev)
            bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = NEG_INF
            xt = torch.empty((D, N), dtype=getattr(torch, dtype_name), device=dev)
            for base in range(0, N, 131072):
                n = min(131072, N - base)
                xt[:, base: base + n] = torch.nn.functional.normalize(
                    torch.randn(n, D, generator=g, device=dev), dim=1).to(xt.dtype).T
            x = xt.T  # the rows as a view, for the plain version and the checks
        else:
            idx = FlatIndex(D, dtype=dtype_name, device="cuda")
            idx.reserve(N)
            for base in range(0, N, 131072):
                n = min(131072, N - base)
                idx.add(torch.randn(n, D, generator=g, device=dev))
            dead = torch.randperm(N, generator=g, device=dev)[: N // 100]
            idx.delete(dead.cpu().numpy())
            x, bias = idx.arrays()
            x, bias = x[:N], bias[:N]  # capacity padding is dead rows; time the live corpus
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        elt = x.element_size()
        # (kernel, wrapper, B, k, query dtype)
        if xt_only and dtype_name == "float32":  # K4r: 4-byte pieces of an f32 xt
            shapes = [("K4r", "K4", B, k, f32) for B in (64, 256, 1024) for k in (30, 300)]
        elif xt_only:  # K4tcr, K4tc3r: the ragged-row producer over xt
            shapes = [(name, "K4", B, k, qd) for name, qd in (("K4tcr", bf16), ("K4tc3r", f32))
                      for B in (64, 256, 1024) for k in (30, 300)]
        elif dtype_name == "float32" and D == 764:  # K1 beside K1r, K2 beside K2r: 16-byte pieces
            shapes = [("K1", "K1", B, k, f32) for B in (1, 8) for k in (30, 300)]
            shapes += [("K2", "K2", B, k, f32) for B in (64, 256, 1024) for k in (30, 300)]
        elif dtype_name == "float32" and D != 768:  # K1r, K2r: 4-byte pieces
            shapes = [("K1r", "K1", B, k, f32) for B in (1, 8) for k in (30, 300)]
            shapes += [("K2r", "K2", B, k, f32) for B in (64, 256, 1024) for k in (30, 300)]
        elif D != 768:  # K1tcr, K2tcr, K2tc3r: the ragged-row producer
            shapes = [("K1tcr", "K1", B, k, qd) for qd in (bf16, f32) for B in (1, 8)
                      for k in (30, 300)]
            shapes += [("K2tcr", "K2", B, k, bf16) for B in (64, 256, 1024) for k in (30, 300)]
            shapes += [("K2tc3r", "K2", B, k, f32) for B in (64, 256, 1024) for k in (30, 300)]
        elif dtype_name == "float32":
            shapes = [("K1", "K1", B, k, f32) for B in (1, 8) for k in (30, 300)]
            shapes += [("K2", "K2", B, k, f32) for B in (32, 64) for k in (30, 300)]
            shapes += [(name, name, B, k, f32) for name in ("K2", "K3", "K4") for B in (256, 1024)
                       for k in (30, 100, 300)]
            shapes += [("K4", "K4", 64, k, f32) for k in (30, 300)]  # beside K4r's shapes
            xt = x.T.contiguous()  # K4's corpus: the same rows as xt [D, N]
        else:  # bf16 queries (FlatIndex's) and f32 queries (ShardedFlatIndex's, three pieces)
            shapes = [("K1tc", "K1", B, k, qd) for qd in (bf16, f32) for B in (1, 8)
                      for k in (30, 300)]
            shapes += [("K2tc", "K2", B, k, bf16) for B in (64, 256, 1024) for k in (30, 100, 300)]
            shapes += [("K2tc", "K3", 1024, 100, bf16)]
            shapes += [("K2tc3", "K2", B, k, f32) for B in (64, 256, 1024) for k in (30, 300)]
            # K4 over the same rows as a bf16 xt [D, N]: K4tc and K4tc3
            shapes += [("K4tc", "K4", B, k, bf16) for B in (64, 256, 1024) for k in (30, 300)]
            shapes += [("K4tc", "K4", 1024, 100, bf16)]
            shapes += [("K4tc3", "K4", B, k, f32) for B in (64, 256, 1024) for k in (30, 300)]
            xt = x.T.contiguous()
        flat = {"K1": topk.streaming_topk_cuda, "K2": topk.streaming_topk_cuda_qmajor,
                "K3": topk.streaming_topk_cuda_qres,
                "K4": lambda q_, x_, b_, k_: topk.streaming_topk_cuda_qmajor_xt(q_, xt, b_, k_)}
        plain_cache = {}
        x_pad = None
        for name, via, B, k, q_dtype in shapes:
            fn = flat[via]
            batches = [
                _unit(torch, torch.randn(B, D, generator=g, device=dev)).to(q_dtype)
                for _ in range(7)
            ]
            counted = getattr(topk, KERNELS[name][1])  # the wrapper that counts the route
            launched = counted.launches
            ms = _time_ms(torch, lambda qb: fn(qb, x, bias, k), batches)
            require(counted.launches == launched + len(batches) + 1,
                    f"phase 3: {via} {dtype_name} B={B} k={k} did not run {name}")
            # K4tc/K4tc3 (K4tcr/K4tc3r, K4r): the library calls on the layout they read, xt
            on_xt = name in ("K4tc", "K4tc3", "K4tcr", "K4tc3r", "K4r")
            lib_ms = _time_ms(torch, lambda qb: yardstick(torch, qb, xt, bias, k, xt=True) if on_xt
                              else yardstick(torch, qb, x, bias, k), batches[:3])
            extra = {"via": via, "q_dtype": str(q_dtype)[6:]}
            tc_yardstick = (lambda qb: yardstick_tc_xt(torch, qb, xt, bias, k)) if on_xt else \
                (lambda qb: yardstick_tc(torch, qb, x, bias, k))
            if dtype_name == "bfloat16" and q_dtype == torch.bfloat16:
                # the f32 yardstick casts the bf16 rows to f32; the fair library
                # call for a bf16 corpus is the tensor-core product
                extra["library_f32_ms"] = lib_ms
                lib_batches = batches[:3]
                if D % 8:  # torch.mm's bf16 operands on a zero-padded copy, made untimed
                    if x_pad is None:
                        x_pad = torch.nn.functional.pad(x, (0, 8 - D % 8))
                    lib_batches = [torch.nn.functional.pad(qb, (0, 8 - D % 8)) for qb in lib_batches]
                    tc_yardstick = lambda qb: yardstick_tc(torch, qb, x_pad, bias, k)  # noqa: E731
                    extra["library_note"] = (f"torch.mm on rows and queries zero-padded to "
                                             f"{D + 8 - D % 8} columns (the copy not timed)")
                lib_ms = _time_ms(torch, tc_yardstick, lib_batches)
            if name in ("K4tcr", "K4tc3r", "K4r"):
                extra["piece"] = topk.load_piece(elt * N, xt.data_ptr())
            if (B, k, q_dtype) not in plain_cache:  # K2, K3 and K4 share their plain version
                # one timed call after the warm-up: the plain version is no
                # yardstick of speed, and its calls take most of the phase
                plain_cache[(B, k, q_dtype)] = _time_ms(
                    torch, lambda qb: topk.streaming_topk(qb, x, bias, k), batches[:1])
            plain_ms = plain_cache[(B, k, q_dtype)]
            # correctness on a sample of the first batch against the yardstick
            qs = batches[0][: min(B, 16)].contiguous()
            s_k, i_k = fn(qs, x, bias, k)
            s_y, i_y = yardstick(torch, qs, x, bias, k)
            err, n_diff, bad = check_topk(torch, qs, x, bias, s_k, i_k, s_y, i_y)
            if "library_f32_ms" in extra:
                s_t, i_t = tc_yardstick(torch.nn.functional.pad(qs, (0, x_pad.shape[1] - D))
                                        if x_pad is not None else qs)
                extra["library_mismatches_outside_ties"] = check_topk(
                    torch, qs, x, bias, s_t, i_t, s_y, i_y)[2]
                bad += extra["library_mismatches_outside_ties"]
            errs[name] = max(errs[name], err)
            # f32 rows: f32 FMAs. bf16 rows: bf16 tensor-core products, three
            # for an f32 query, whose exact f32 x bf16 products take its
            # three bf16 pieces (the least work for them on this card)
            pieces = 3 if dtype_name == "bfloat16" and q_dtype == f32 else 1
            bound, bound_by = _bound(N * D * elt + N * 4 + B * D * qs.element_size() + B * k * 8,
                                     pieces * 2.0 * B * N * D, dtype_name)
            if pieces == 3:
                extra["bound_note"] = ("f32 queries over bf16 rows: three bf16 tensor-core "
                                       "products a score (hi + mid + lo == q, each exact in "
                                       "f32), or the bytes")
            if name in ("K2tc", "K2tc3", "K4tc", "K4tc3", "K2tcr", "K2tc3r", "K4tcr", "K4tc3r"):
                # bytes the blocks read, from L2 or HBM
                plan = topk.tc_plan(B, N, D, k, sms=torch.cuda.get_device_properties(0)
                                    .multi_processor_count, pieces=pieces)
                extra["l2_bytes"] = topk.tc_l2_bytes(plan, N, D, pieces=pieces)
            row = {"phase": 3, "kernel": name, "dtype": dtype_name, "N": N, "D": D,
                   "B": B, "k": k, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": bound_by,
                   **extra, "share_of_bound": bound / ms, "max_abs_err": err,
                   "id_mismatches": n_diff, "mismatches_outside_ties": bad,
                   "index_build_seconds": round(build_s, 3)}
            emit(row)
            rows_out.append(row)
            require(bad == 0, f"phase 3: {bad} mismatches outside ties ({name} {dtype_name} B={B} k={k})")
        del idx, x, xt, bias, x_pad
        torch.cuda.empty_cache()
    return rows_out


def _hybrid_vs_cpu(torch, cg, cpu, hits, k, judge) -> dict:
    """The card's vector stage and hybrid top-10 against the same snapshot
    searched on the CPU. Vector stage: the prefetch (k) tie-aware. Hybrid
    stage: top-10 scores position by position, unless a tie at the
    prefetch boundary let a different chunk in (then the candidate sets
    differ legitimately and are counted)."""
    index = cg.indexer.index
    bad, diff, err, boundary_ties = 0, 0, 0.0, 0
    qe = cg.indexer.provider.embed_texts(QUERIES)
    for qt, e, got in zip(QUERIES, qe, hits):
        s_g, i_g = index.search(e[None, :], k)
        s_c, i_c = cpu.indexer.index.search(e[None, :], k)
        q1 = torch.nn.functional.normalize(torch.as_tensor(e[None, :], device="cuda"), dim=1)
        _, _, bad_v = check_topk(torch, None, None, None,
                                 *(torch.as_tensor(a, device="cuda") for a in (s_g, i_g, s_c, i_c)),
                                 judge=judge(q1))
        bad += bad_v
        ref = cpu.search(qt, limit=10)
        require(len(got) == len(ref) > 0, f"{len(got)} vs {len(ref)} hits for {qt!r}")
        require(all(math.isfinite(a.score) for a in got), "non-finite hybrid score")
        if set(i_g[0].tolist()) != set(i_c[0].tolist()):
            boundary_ties += 1
            continue
        for a, b in zip(got, ref):
            d = abs(a.score - b.score)  # position by position: a swap is a tie
            err = max(err, d)
            diff += a.node_id != b.node_id
            bad += d > SCORE_TOL
    return {"max_abs_err": err, "id_mismatches": diff, "mismatches_outside_ties": bad,
            "queries_with_prefetch_boundary_ties": boundary_ties}


def phase4(torch, mods, errs, phase=4, D=768, kernels=("K5", "K6")) -> dict:
    """The int8 main path: index.dtype = "int8" through the entry points, at
    embedding width D; `kernels` (single, batched) must launch, and no
    other. At D = 768 the planner's int8 choice too."""
    from codegraph_tpu_torch.api import CodeGraph, index_memory_budget
    from codegraph_tpu_torch.core.config import CodeGraphConfig
    from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
    from codegraph_tpu_torch.search.service import QueryService
    from codegraph_tpu_torch.utils.tuning import plan_index

    quantize = mods["quantize"]
    src = os.path.join(ROOT, "codegraph_tpu")
    require(os.path.isdir(src), f"no JAX package source at {src} to index")
    tmp = tempfile.mkdtemp(prefix="cg_smoke_int8_")
    svc = None
    try:
        proj = os.path.join(tmp, "codegraph_tpu")
        shutil.copytree(src, proj, ignore=shutil.ignore_patterns("__pycache__"))

        def config(data):
            cfg = CodeGraphConfig()
            cfg.embedding.provider = "hash"
            cfg.embedding.dimension = D
            cfg.data_dir = os.path.join(tmp, data)
            return cfg

        cfg = config("data")
        cfg.index.dtype = "int8"
        reset_launches(mods)
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        stats = cg.index()
        t_index = time.perf_counter() - t0

        t0 = time.perf_counter()
        hits = [cg.search(qt, limit=10) for qt in QUERIES]
        t_search = time.perf_counter() - t0

        index = cg.indexer.index
        texts = [f"{QUERIES[i % 5]} variant {i}" for i in range(64)]
        embs = cg.indexer.provider.embed_texts(texts)
        k = 30
        t0 = time.perf_counter()
        svc = QueryService.auto(index, k=k)
        futures = [svc.submit(e) for e in embs]
        batched = [f.result(timeout=120) for f in futures]
        svc.close()
        svc_stats = svc.stats
        svc = None
        t_service = time.perf_counter() - t0
        # the main path ends here; later launches only check results
        launches = read_launches(mods)
        require(isinstance(index, Int8FlatIndex), f"phase {phase} built {type(index).__name__}")
        singles = [index.search(e[None, :], k) for e in embs]

        # batched (K6) vs single (K5) final results: the rescore of the
        # bf16 rows decides, so a tie is judged by those rows' dot product
        qv_x, s_x, r_x, bias = index.arrays()
        no_bias = torch.zeros_like(bias)

        def rescore_judge(q):
            return dot_judge(q, r_x, no_bias)

        qn = torch.nn.functional.normalize(torch.as_tensor(embs, device="cuda"), dim=1)
        s_b = torch.as_tensor(np.stack([b[0] for b in batched]), device="cuda")
        i_b = torch.as_tensor(np.stack([b[1] for b in batched]), device="cuda")
        s_1 = torch.as_tensor(np.stack([s[0][0] for s in singles]), device="cuda")
        i_1 = torch.as_tensor(np.stack([s[1][0] for s in singles]), device="cuda")
        err_svc, diff_svc, bad_svc = check_topk(torch, None, None, None, s_b, i_b, s_1, i_1,
                                                judge=rescore_judge(qn))

        # each kernel against its plain version at the main path's shapes
        cand_k = min(max(k, index.rescore_k), index.capacity)
        main_shapes = {}
        for name, B in zip(kernels, (1, 64)):
            qv, qs = quantize.quantize_rows(qn[:B])
            args = (qv, qs, qv_x, s_x, bias)
            s_k, i_k = wrapper(mods, name)(*args, cand_k)
            s_p, i_p = quantize.streaming_topk_int8(*args, cand_k)
            e, n_d, b_d = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                     judge=int8_judge(*args))
            b_d += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
            errs[name] = max(errs[name], e)
            main_shapes[name] = {"N": int(qv_x.shape[0]), "B": B, "k": cand_k, "max_abs_err": e,
                                 "id_mismatches": n_d, "mismatches_outside_ties": b_d}

        # the same snapshot searched on the CPU (plain versions) as reference
        cpu = CodeGraph(cfg, device="cpu")
        require(isinstance(cpu.indexer.index, Int8FlatIndex) and
                cpu.indexer.index.n_rows == index.n_rows, f"phase {phase}: CPU snapshot load")
        hybrid = _hybrid_vs_cpu(torch, cg, cpu, hits, k, rescore_judge)

        out = {
            "phase": phase, "D": D, "files": stats.files_total, "nodes": stats.nodes,
            "chunks": stats.chunks, "edges": stats.edges_total,
            "index": type(index).__name__, "index_rows": index.n_rows,
            "index_capacity": index.capacity, "rescore_dtype": str(index.rescore_dtype),
            "rescore_k": index.rescore_k,
            "index_seconds": round(t_index, 3),
            "stage_seconds": {k_: round(v, 3) for k_, v in stats.stage_seconds.items()},
            "search_seconds_5": round(t_search, 3),
            "search_perf": cg.indexer.search.monitor.report(),
            "service_seconds_64": round(t_service, 3),
            "service_batches": svc_stats.batches, "service_max_batch": svc_stats.max_batch_seen,
            "launches": launches,
            "top1": [h[0].name if h else None for h in hits],
            "service_vs_single": {"max_abs_err": err_svc, "id_mismatches": diff_svc,
                                  "mismatches_outside_ties": bad_svc},
            "hybrid_vs_cpu": hybrid,
            "kernel_vs_plain_main_shapes": main_shapes,
        }
        if D == 768:
            # the planner: a capacity whose bf16 rows overflow this card's
            # budget and whose int8 rows fit
            budget = index_memory_budget("cuda")
            capacity = int(budget // (768 * 1.5))
            pcfg = config("planned")
            pcfg.index.capacity = capacity
            planned = CodeGraph.open(proj, config=pcfg, device="cuda")
            plan = plan_index(capacity, 768, hbm_budget_bytes=budget)
            out["plan"] = {"capacity": capacity, "budget_bytes": budget, "kind": pcfg.index.kind,
                           "dtype": pcfg.index.dtype, "rescore_k": pcfg.index.rescore_k,
                           "tile_n": plan.tile_n, "reason": plan.reason,
                           "index": type(planned.indexer.index).__name__}
        emit(out)
        require(stats.nodes > 0 and stats.chunks > 0 and stats.edges_total > 0, "empty index")
        require(bad_svc == 0, f"phase {phase}: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                f"phase {phase}: a kernel disagrees with its plain version at the main path's "
                "shapes")
        require(hybrid["mismatches_outside_ties"] == 0,
                f"phase {phase}: CUDA hybrid results disagree with the CPU path")
        require(all(launches[name] > 0 for name in kernels),
                f"phase {phase}: int8 main path did not launch {kernels}: {launches}")
        require(all(v == 0 for name, v in launches.items() if name not in kernels),
                f"phase {phase}: int8 main path launched another kernel than {kernels}: "
                f"{launches}")
        if D == 768:
            require(pcfg.index.dtype == "int8" and
                    isinstance(planned.indexer.index, Int8FlatIndex),
                    f"phase 4: planner chose {pcfg.index.kind}/{pcfg.index.dtype} for "
                    f"{capacity} rows")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


def int8_yardstick(torch, qv, qs, xv, xs, bias, k, chunk=131072):
    """Chunked torch._int_mm + scales + torch.topk (library calls; used
    only here). torch._int_mm takes more than 16 rows: a smaller batch is
    padded with zero rows, which are dropped."""
    B = qv.shape[0]
    if B < 17:
        qv = torch.cat([qv, qv.new_zeros((17 - B, qv.shape[1]))])
    ss, ii = [], []
    for base in range(0, xv.shape[0], chunk):
        raw = torch._int_mm(qv, xv[base: base + chunk].t())[:B]
        s = raw.float() * qs[:, None] * xs[base: base + chunk][None, :] + bias[base: base + chunk]
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        ss.append(v)
        ii.append(i + base)
    s = torch.cat(ss, 1)
    v, p = torch.topk(s, k, dim=1)
    return v, torch.gather(torch.cat(ii, 1), 1, p).int()


def phase5(torch, mods, errs) -> list:
    """Real size of the int8 tier: 10M x 768 with a bf16 rescore copy."""
    from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex

    quantize = mods["quantize"]
    dev = torch.device("cuda")
    N, D = 10_000_000, 768
    require(N % 8 == 0, "phase 5: torch._int_mm needs N % 8 == 0")
    g = torch.Generator(device=dev).manual_seed(2025)
    t0 = time.perf_counter()
    idx = Int8FlatIndex(D, rescore_dtype="bfloat16", device="cuda")
    idx.reserve(N)
    for base in range(0, N, 131072):
        idx.add(torch.randn(min(131072, N - base), D, generator=g, device=dev))
    dead = torch.randperm(N, generator=g, device=dev)[: N // 100]
    idx.delete(dead.cpu().numpy())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mem_gb = torch.cuda.memory_allocated() / 1e9
    xv, xs, _, bias = idx.arrays()
    xv, xs, bias = xv[:N], xs[:N], bias[:N]  # capacity padding is dead rows; time the live corpus
    rows_out = []
    plain_cache = {}  # K6 and K7 compute the same function: one plain timing per shape
    shapes = [("K5", 1, 100), ("K5", 1, 300), ("K5", 8, 100), ("K5", 8, 300)]
    shapes += [(name, B, k) for name in ("K6", "K7") for B in (64, 256, 1024) for k in (100, 300)]
    # K6r called directly at D = 768: like for like with K6 (and with the
    # mma.sync kernel it replaces)
    shapes += [("K6r", 1024, 100)]
    for name, B, k in shapes:
        fn = wrapper(mods, name)
        batches = [quantize.quantize_rows(_unit(torch, torch.randn(B, D, generator=g, device=dev)))
                   for _ in range(7)]
        outs = []
        ms = _time_ms(torch, lambda b: fn(b[0], b[1], xv, xs, bias, k), batches, outs)
        lib_ms = _time_ms(torch, lambda b: int8_yardstick(torch, b[0], b[1], xv, xs, bias, k),
                          batches[:3])
        if (B, k) not in plain_cache:
            plain_cache[(B, k)] = _time_ms(
                torch, lambda b: quantize.streaming_topk_int8(b[0], b[1], xv, xs, bias, k),
                batches[:2])
        # correctness: a sample of every timed batch against the yardstick
        err, n_diff, bad = 0.0, 0, 0
        m = min(B, 4)
        for (qv, qs), (s_k, i_k) in zip(batches, outs):
            args = (qv[:m].contiguous(), qs[:m].contiguous(), xv, xs, bias)
            s_y, i_y = int8_yardstick(torch, *args, k)
            e, d, b_ = check_topk(torch, None, None, None, s_k[:m], i_k[:m], s_y, i_y,
                                  judge=int8_judge(*args))
            err, n_diff, bad = max(err, e), n_diff + d, bad + b_
        errs[name] = max(errs[name], err)
        bound, bound_by = _bound(N * D + 8 * N + B * D + 4 * B + B * k * 8, 2.0 * B * N * D, "int8")
        row = {"phase": 5, "kernel": name, "dtype": "int8", "N": N, "D": D, "B": B, "k": k,
               "ms": ms, "plain_ms": plain_cache[(B, k)], "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
               "max_abs_err": err, "sampled_rows": m * len(batches), "id_mismatches": n_diff,
               "mismatches_outside_ties": bad, "index_build_seconds": round(build_s, 3),
               "device_gb_allocated": round(mem_gb, 3)}
        emit(row)
        rows_out.append(row)
        require(bad == 0, f"phase 5: {bad} mismatches outside ties ({name} B={B} k={k})")
    # the index end to end: quantize, scan (K5 or K6), rescore, copy back
    stages = search_stages(torch, mods, idx, g, 1024, 10)
    live = torch.ones(idx.capacity, dtype=torch.bool)
    live[dead.cpu()] = False
    live[N:] = False
    for B in (1, 1024):
        batches = [torch.randn(B, D, generator=g, device=dev) for _ in range(7)]
        idx.search(batches[0], 10)  # warm
        times = []
        for qb in batches:
            t0 = time.perf_counter()
            s_np, i_np = idx.search(qb, 10)  # returns host arrays: synchronized
            times.append((time.perf_counter() - t0) * 1e3)
        ok = (s_np.shape == (B, 10) and np.isfinite(s_np).all() and (i_np >= 0).all()
              and bool(live[torch.as_tensor(i_np).long()].all()))
        row = {"phase": 5, "kind": "Int8FlatIndex.search", "N": N, "D": D, "B": B, "k": 10,
               "rescore_k": idx.rescore_k, "ms": statistics.median(times),
               "ms_all": [round(t, 3) for t in times], "results_ok": ok}
        if B == 1024:
            row["stage_ms"] = stages
        emit(row)
        rows_out.append(row)
        require(ok, f"phase 5: Int8FlatIndex.search at B={B} returned dead or missing rows")
    del idx, xv, xs, bias
    torch.cuda.empty_cache()
    rows_out += _phase5_ragged(torch, mods, errs)
    return rows_out


#: phase 5's widths for the int8 routes that read rows TMA cannot: 760
#: (K5's words, K6r's 8-byte pieces), 764 (K5's words, the width nearest
#: 765 that K5 reads as words; K5 only) and 765 (K5r's and K6r's realigned
#: words), 10M rows each
RAGGED_INT8_D = (760, 764, 765)


def _phase5_ragged(torch, mods, errs) -> list:
    """K5 (B = 1, 8: K5 at 760 and 764, K5r at 765) and K6 (B = 64, 256,
    1024: K6r; not at 764) through their wrappers over 10M int8 rows of
    each width of RAGGED_INT8_D, k = 100 and 300, timed as phase 5's rows,
    with the bound at the real D; torch._int_mm (the yardstick) takes a
    width that is a multiple of 8, so at 764 and 765 it runs on a
    zero-padded copy, made untimed. At 765, then, Int8FlatIndex.search over
    the same rows (`_phase5_ragged_search`)."""
    quantize = mods["quantize"]
    dev = torch.device("cuda")
    N = 10_000_000
    rows_out = []
    for D in RAGGED_INT8_D:
        g = torch.Generator(device=dev).manual_seed(2026 + D)
        t0 = time.perf_counter()
        xv = torch.empty((N, D), dtype=torch.int8, device=dev)
        xs = torch.empty(N, device=dev)
        for base in range(0, N, 131072):
            n = min(131072, N - base)
            xv[base: base + n], xs[base: base + n] = quantize.quantize_rows(
                torch.randn(n, D, generator=g, device=dev))
        bias = torch.zeros(N, device=dev)
        bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = NEG_INF
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        xv_lib, lib_note = xv, None
        if D % 8:
            xv_lib = torch.nn.functional.pad(xv, (0, 8 - D % 8))
            lib_note = f"torch._int_mm on rows and queries zero-padded to {D + 8 - D % 8} columns"
        plain_cache = {}
        shapes = [("K5", B, k) for B in (1, 8) for k in (100, 300)]
        if D != 764:
            shapes += [("K6", B, k) for B in (64, 256, 1024) for k in (100, 300)]
        for via, B, k in shapes:
            fn = wrapper(mods, via)
            batches = [quantize.quantize_rows(_unit(torch, torch.randn(B, D, generator=g,
                                                                       device=dev)))
                       for _ in range(7)]
            name = _ragged_route(mods["topk"], quantize, "int8", "K1" if via == "K5" else "K2",
                                 "int8", xv, xs, bias)
            counted = wrapper(mods, name)
            launched = counted.launches
            outs = []
            ms = _time_ms(torch, lambda b: fn(b[0], b[1], xv, xs, bias, k), batches, outs)
            require(counted.launches == launched + len(batches) + 1,
                    f"phase 5: {via} at D={D} B={B} k={k} did not run {name}")
            lib_batches = [(torch.nn.functional.pad(b[0], (0, xv_lib.shape[1] - D)), b[1])
                           for b in batches[:3]]
            lib_ms = _time_ms(torch, lambda b: int8_yardstick(torch, b[0], b[1], xv_lib, xs, bias,
                                                              k), lib_batches)
            # one batch (after a warm one): ~1.3 s a call; at 764, where K5 stands
            # beside K5r, not timed (K5's plain time is phase 5's at 768)
            if D != 764 and (B, k) not in plain_cache:
                plain_cache[(B, k)] = _time_ms(
                    torch, lambda b: quantize.streaming_topk_int8(b[0], b[1], xv, xs, bias, k),
                    batches[:1])
            err, n_diff, bad = 0.0, 0, 0
            m = min(B, 4)
            for (qv, qs), (s_k, i_k) in zip(batches, outs):
                args = (qv[:m].contiguous(), qs[:m].contiguous(), xv, xs, bias)
                s_y, i_y = int8_yardstick(torch, torch.nn.functional.pad(args[0], (
                    0, xv_lib.shape[1] - D)), args[1], xv_lib, xs, bias, k)
                e, d, b_ = check_topk(torch, None, None, None, s_k[:m], i_k[:m], s_y, i_y,
                                      judge=int8_judge(*args))
                err, n_diff, bad = max(err, e), n_diff + d, bad + b_
            errs[name] = max(errs[name], err)
            bound, bound_by = _bound(N * D + 8 * N + B * D + 4 * B + B * k * 8,
                                     2.0 * B * N * D, "int8")
            row = {"phase": 5, "kernel": name, "via": via, "dtype": "int8", "N": N, "D": D,
                   "B": B, "k": k, "ms": ms, "plain_ms": plain_cache.get((B, k)), "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
                   "max_abs_err": err, "sampled_rows": m * len(batches), "id_mismatches": n_diff,
                   "mismatches_outside_ties": bad, "index_build_seconds": round(build_s, 3)}
            if lib_note:
                row["library_note"] = lib_note
            emit(row)
            rows_out.append(row)
            require(bad == 0, f"phase 5: {bad} mismatches outside ties ({name} D={D} B={B} "
                              f"k={k})")
        del xv_lib
        torch.cuda.empty_cache()
        if D == 765:
            rows_out += _phase5_ragged_search(torch, mods, xv, xs, bias, g)
        del xv, xs, bias
        torch.cuda.empty_cache()
    return rows_out


def _phase5_ragged_search(torch, mods, xv, xs, bias, g) -> list:
    """The int8 tier's served search over rows that are not 4-byte aligned:
    Int8FlatIndex.search over the 10M int8 rows of width 765 (xv, xs, bias)
    with a bf16 rescore copy (the rows dequantized), adopted through
    load_arrays, at B = 1 and 8 (K5r's route), limit 10: the search's ms
    (host clock, 7 searches after a warm one) and each stage's
    (`search_stages`). The launch counts go to 0 just before the timed
    searches and are read just after: K5r must have launched once a
    search, and no other kernel."""
    from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex

    N, D = xv.shape
    t0 = time.perf_counter()
    r = torch.empty((N, D), dtype=torch.bfloat16, device=xv.device)
    for base in range(0, N, 131072):
        r[base: base + 131072] = (xv[base: base + 131072].float()
                                  * xs[base: base + 131072, None]).to(torch.bfloat16)
    idx = Int8FlatIndex(D, rescore_dtype="bfloat16", device="cuda")
    idx.load_arrays(xv, xs, r, bias, N, N - int((bias < NEG_INF / 2).sum()))
    del r  # the index holds it
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    live = (bias > NEG_INF / 2).cpu()
    rows_out = []
    for B in (1, 8):
        stages = search_stages(torch, mods, idx, g, B, 10)
        batches = [torch.randn(B, D, generator=g, device=xv.device) for _ in range(7)]
        idx.search(batches[0], 10)  # warm
        reset_launches(mods)
        times = []
        for qb in batches:
            t0 = time.perf_counter()
            s_np, i_np = idx.search(qb, 10)  # returns host arrays: synchronized
            times.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches(mods)
        ok = (s_np.shape == (B, 10) and np.isfinite(s_np).all() and (i_np >= 0).all()
              and bool(live[torch.as_tensor(i_np).long()].all()))
        row = {"phase": 5, "kind": "Int8FlatIndex.search", "N": N, "D": D, "B": B, "k": 10,
               "rescore_k": idx.rescore_k, "ms": statistics.median(times),
               "ms_all": [round(t, 3) for t in times], "stage_ms": stages,
               "launches": launches, "results_ok": ok,
               "index_load_seconds": round(load_s, 3)}
        emit(row)
        rows_out.append(row)
        require(ok, f"phase 5: Int8FlatIndex.search at D={D} B={B} returned dead or missing rows")
        require(launches["K5r"] == len(batches) and
                all(v == 0 for name, v in launches.items() if name != "K5r"),
                f"phase 5: Int8FlatIndex.search at D={D} B={B} launched {launches}, not K5r "
                f"once a search")
    del idx
    return rows_out


def search_stages(torch, mods, idx, g, B, k) -> dict:
    """Median ms (CUDA events, 5 batches) of each stage of
    Int8FlatIndex.search at batch B: quantize the queries, the scan (K6 at
    B >= 32), the rescore of the candidates, and the copy of the results
    to the host."""
    quantize = mods["quantize"]
    x_q, x_s, x_r, bias = idx.arrays()
    cand_k = min(max(k, idx.rescore_k), idx.capacity)
    qs = [torch.nn.functional.normalize(torch.randn(B, idx.dim, generator=g, device="cuda"), dim=1)
          for _ in range(5)]
    qz = [quantize.quantize_rows(q) for q in qs]
    scan = wrapper(mods, "K6" if B >= 32 else "K5")
    cands = [scan(v, s, x_q, x_s, bias, cand_k) for v, s in qz]
    res = [quantize.rescore_topk(q, x_r, c[1], c[0], k) for q, c in zip(qs, cands)]
    out = {"quantize": _time_ms(torch, lambda q: quantize.quantize_rows(q), qs),
           "scan": _time_ms(torch, lambda z: scan(z[0], z[1], x_q, x_s, bias, cand_k), qz),
           "rescore": _time_ms(torch, lambda i: quantize.rescore_topk(qs[i], x_r, cands[i][1],
                                                                      cands[i][0], k),
                               list(range(5))),
           "copy_back": _time_ms(torch, lambda r: (r[0].cpu(), r[1].cpu()), res)}
    out["sum"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# the IVF tiers
# ---------------------------------------------------------------------------


def _project_copy(tmp) -> str:
    src = os.path.join(ROOT, "codegraph_tpu")
    require(os.path.isdir(src), f"no JAX package source at {src} to index")
    proj = os.path.join(tmp, "codegraph_tpu")
    shutil.copytree(src, proj, ignore=shutil.ignore_patterns("__pycache__"))
    return proj


def _hash_config(tmp, data, kind="flat"):
    from codegraph_tpu_torch.core.config import CodeGraphConfig

    cfg = CodeGraphConfig()
    cfg.embedding.provider = "hash"
    cfg.embedding.dimension = 768
    cfg.data_dir = os.path.join(tmp, data)
    cfg.index.kind = kind
    return cfg


def refine_rows(torch, index):
    """The host int8 refine bank of an IVF-PQ index as f32 rows on the card."""
    raw = torch.as_tensor(np.concatenate(index._raw_chunks), device="cuda").float()
    return raw * torch.as_tensor(np.concatenate(index._raw_scales), device="cuda")


def ivf_rows(torch, index):
    """An IVF index's stored rows by row id ([n_rows, D] f32 on the card)."""
    _, x, ids, _ = index.arrays()
    rows = torch.zeros((index.n_rows, index.dim), device="cuda")
    live = ids >= 0
    rows[ids[live].long()] = x[live].float()
    return rows


def _narrow_filter(cg, proj, max_frac=0.03):
    """A SearchFilters (one path prefix of the project) that keeps more than
    0 and at most max_frac of the index rows, and its row mask."""
    from codegraph_tpu_torch.core.types import SearchFilters

    bank, n = cg.indexer.search.filters_bank, cg.indexer.index.n_rows
    for name in sorted(os.listdir(proj)):
        filt = SearchFilters.make(path_prefixes=[os.path.join(proj, name)])
        eb = bank.bias_for(filt, n)
        frac = float((eb > NEG_INF / 2).mean()) if eb is not None else 1.0
        if 0 < frac <= max_frac:
            return filt, eb, frac
    raise CheckFailed("phase 6: no path prefix keeps <= 3% of the rows")


def _hits_vs(got, ref, tol=SCORE_TOL) -> dict:
    """Hybrid hits position by position: a swap is a tie within tol."""
    require(len(got) == len(ref) > 0, f"{len(got)} vs {len(ref)} hits")
    require(all(math.isfinite(h.score) for h in got), "non-finite hybrid score")
    err = max(abs(a.score - b.score) for a, b in zip(got, ref))
    return {"max_abs_err": err, "id_mismatches": sum(a.node_id != b.node_id for a, b in zip(got, ref)),
            "mismatches_outside_ties": int(err > tol)}


def phase6(torch, mods, errs) -> dict:
    """The IVF tiers through the entry points: IVF-PQ (K8), IVF, the planner."""
    from codegraph_tpu_torch.api import CodeGraph, index_memory_budget
    from codegraph_tpu_torch.index.ivf import IVFIndex
    from codegraph_tpu_torch.index.ivfpq import IVFPQIndex, _filter_fetch_k
    from codegraph_tpu_torch.search.service import QueryService
    from codegraph_tpu_torch.utils.tuning import plan_index

    ivfpq = mods["ivfpq"]
    tmp = tempfile.mkdtemp(prefix="cg_smoke_ivf_")
    svc = None
    try:
        proj = _project_copy(tmp)
        k = 30
        # -- IVF-PQ at the config defaults ---------------------------------
        cfg = _hash_config(tmp, "data_ivfpq", "ivfpq")
        reset_launches(mods)
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        stats = cg.index()
        t_index = time.perf_counter() - t0
        t0 = time.perf_counter()
        hits = [cg.search(qt, limit=10) for qt in QUERIES]
        t_search = time.perf_counter() - t0
        index = cg.indexer.index
        filt, eb, frac = _narrow_filter(cg, proj)
        fetch_k = _filter_fetch_k(k, eb, index.list_cap * index.nprobe)
        # the query is the text of a chunk inside the filter, so that the
        # probed cells hold allowed rows (its own row at least)
        store = cg.indexer.store
        f_query = next(c.text for c in store.chunks.values()
                       if store.nodes[c.parent_node].location.file_path.startswith(
                           filt.path_prefixes[0]))
        t0 = time.perf_counter()
        f_hits = cg.indexer.search.search_text(f_query, 10, filters=filt)
        t_filter = time.perf_counter() - t0
        texts = [f"{QUERIES[i % 5]} variant {i}" for i in range(64)]
        embs = cg.indexer.provider.embed_texts(texts)
        t0 = time.perf_counter()
        svc = QueryService.auto(index, k=k)
        batched = [f.result(timeout=120) for f in [svc.submit(e) for e in embs]]
        svc.close()
        svc_stats = svc.stats
        svc = None
        t_service = time.perf_counter() - t0
        # the main path ends here; later launches only check results
        launches = read_launches(mods)
        require(isinstance(index, IVFPQIndex), f"phase 6 built {type(index).__name__}")
        singles = [index.search(e[None, :], k) for e in embs]
        rows = refine_rows(torch, index)
        zeros = torch.zeros(rows.shape[0], device="cuda")
        qn = torch.nn.functional.normalize(torch.as_tensor(embs, device="cuda"), dim=1)
        s_b, i_b, s_1, i_1 = (torch.as_tensor(np.stack(a), device="cuda") for a in (
            [b[0] for b in batched], [b[1] for b in batched],
            [s[0][0] for s in singles], [s[1][0] for s in singles]))
        err_svc, diff_svc, bad_svc = check_topk(torch, None, None, None, s_b, i_b, s_1, i_1,
                                                judge=dot_judge(qn, rows, zeros))
        # K8 against its plain version at the main path's shapes
        centroids, codes, ids, bias = index.arrays()
        state = (centroids, codes, ids, bias, index._books)
        k_refine = max(k, min(k * index.refine_factor, index.list_cap * index.nprobe))
        main_shapes = {}
        for B, kk in ((1, k_refine), (64, k_refine), (1, fetch_k)):
            s_k, i_k = ivfpq.ivfpq_search_cuda(qn[:B].contiguous(), *state, kk, index.nprobe,
                                               extents=index._extents())
            s_p, i_p = ivfpq.ivfpq_search(qn[:B], *state, kk, index.nprobe)
            e, n_d, b_d = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                     judge=adc_judge(torch, qn[:B], *state))
            errs["K8"] = max(errs["K8"], e)
            main_shapes[f"B={B} k={kk}"] = {"max_abs_err": e, "id_mismatches": n_d,
                                            "mismatches_outside_ties": b_d}
        # the same snapshot searched on the CPU (plain versions) as reference
        cpu = CodeGraph(cfg, device="cpu")
        require(isinstance(cpu.indexer.index, IVFPQIndex)
                and cpu.indexer.index.n_rows == index.n_rows, "phase 6: CPU snapshot load")
        hybrid = _hybrid_vs_cpu(torch, cg, cpu, hits, k, lambda q: dot_judge(q, rows, zeros))
        filtered = _hits_vs(f_hits, cpu.indexer.search.search_text(f_query, 10, filters=filt))
        kept = all(cg.indexer.store.nodes[h.node_id].location.file_path.startswith(
            filt.path_prefixes[0]) for h in f_hits)
        ivfpq_out = {
            "files": stats.files_total, "chunks": stats.chunks, "index_rows": index.n_rows,
            "stats": index.stats(), "index_seconds": round(t_index, 3),
            "stage_seconds": {k_: round(v, 3) for k_, v in stats.stage_seconds.items()},
            "search_seconds_5": round(t_search, 3),
            "search_perf": cg.indexer.search.monitor.report(),
            "filtered": {"rows_kept": frac, "fetch_k": fetch_k, "seconds": round(t_filter, 3),
                         "hits": len(f_hits), "all_in_filter": kept, "vs_cpu": filtered},
            "service_seconds_64": round(t_service, 3), "service_batches": svc_stats.batches,
            "service_max_batch": svc_stats.max_batch_seen, "launches": launches,
            "top1": [h[0].name if h else None for h in hits],
            "service_vs_single": {"max_abs_err": err_svc, "id_mismatches": diff_svc,
                                  "mismatches_outside_ties": bad_svc},
            "hybrid_vs_cpu": hybrid, "kernel_vs_plain_main_shapes": main_shapes,
        }
        # -- IVF (no kernel) -------------------------------------------------
        icfg = _hash_config(tmp, "data_ivf", "ivf")
        reset_launches(mods)
        t0 = time.perf_counter()
        cg_ivf = CodeGraph.open(proj, config=icfg, device="cuda")
        istats = cg_ivf.index()
        hits_ivf = [cg_ivf.search(qt, limit=10) for qt in QUERIES]
        t_ivf = time.perf_counter() - t0
        launches_ivf = read_launches(mods)
        iidx = cg_ivf.indexer.index
        require(type(iidx) is IVFIndex, f"phase 6 built {type(iidx).__name__} for kind ivf")
        irows = ivf_rows(torch, iidx)
        izeros = torch.zeros(irows.shape[0], device="cuda")
        hybrid_ivf = _hybrid_vs_cpu(torch, cg_ivf, CodeGraph(icfg, device="cpu"), hits_ivf, k,
                                    lambda q: dot_judge(q, irows, izeros))
        # -- the planner sends a large capacity to IVF-PQ on this card --------
        budget = index_memory_budget("cuda")
        capacity = max(60_000_000, budget // 768 + 1)  # int8 rows over the budget
        pcfg = _hash_config(tmp, "data_planned")
        pcfg.index.capacity = capacity
        t0 = time.perf_counter()
        planned = CodeGraph.open(proj, config=pcfg, device="cuda")
        plan = plan_index(capacity, 768, hbm_budget_bytes=budget)
        pstats = planned.index()
        phits = planned.search(QUERIES[0], limit=10)
        t_planned = time.perf_counter() - t0
        pidx = planned.indexer.index
        out = {
            "phase": 6, "ivfpq": ivfpq_out,
            "ivf": {"index_rows": iidx.n_rows, "stats": iidx.stats(),
                    "seconds_index_and_5_searches": round(t_ivf, 3), "launches": launches_ivf,
                    "top1": [h[0].name if h else None for h in hits_ivf],
                    "hybrid_vs_cpu": hybrid_ivf},
            "planned": {"capacity": capacity, "budget_bytes": budget, "plan": plan.to_dict(),
                        "index": type(pidx).__name__, "nlist_after_shrink": pidx.nlist,
                        "fill_entries": len(pidx._fill), "chunks": pstats.chunks,
                        "live": len(pidx), "hits": len(phits),
                        "seconds_open_index_search": round(t_planned, 3)},
        }
        emit(out)
        require(stats.chunks > 0 and len(index) == stats.chunks, "phase 6: IVF-PQ index rows")
        require(bad_svc == 0, "phase 6: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                "phase 6: K8 disagrees with its plain version at the main path's shapes")
        require(fetch_k > 1024, f"phase 6: the filtered fetch {fetch_k} is not above 1,024")
        require(hybrid["mismatches_outside_ties"] == 0 and filtered["mismatches_outside_ties"] == 0
                and kept, "phase 6: CUDA IVF-PQ results disagree with the CPU path")
        require(launches["K8"] > 0, f"phase 6: the IVF-PQ main path did not launch K8: {launches}")
        require(all(v == 0 for n, v in launches.items() if n != "K8"),
                f"phase 6: the IVF-PQ main path launched a flat or int8 kernel: {launches}")
        require(all(v == 0 for v in launches_ivf.values()),
                f"phase 6: the IVF path launched a kernel: {launches_ivf}")
        require(hybrid_ivf["mismatches_outside_ties"] == 0,
                "phase 6: CUDA IVF results disagree with the CPU path")
        require(pcfg.index.kind == "ivfpq" and isinstance(pidx, IVFPQIndex) and len(phits) > 0,
                f"phase 6: planner chose {pcfg.index.kind} for {capacity} rows")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


class StageTimer:
    """Seconds spent in named functions (each call synchronized), by
    wrapping them in place for the duration of a `with` block."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.seconds, self._saved = torch, targets, {}, []

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            self.seconds[name] = 0.0
            setattr(owner, attr, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def run(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            return out
        return run

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


def mixture_chunk(torch, centers, base, n, seed, spread):
    """Rows [base, base + n) of the clustered mixture, made on the card from
    a generator seeded per chunk, so that any chunk can be made again."""
    g = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + base)
    pick = torch.randint(0, centers.shape[0], (n,), generator=g, device="cuda")
    return centers[pick] + spread * torch.randn(n, centers.shape[1], generator=g, device="cuda")


def phase7(torch, mods, errs) -> list:
    """Real size of the IVF-PQ tier: 10M x 768 rows, device refine bank."""
    import codegraph_tpu_torch.index.ivf as ivf_mod
    from codegraph_tpu_torch.index.ivfpq import IVFPQIndex

    ivfpq = mods["ivfpq"]
    # the reference's clustered mixture (benchmarks/bench_build_device.py
    # gen_clustered): 16,384 unit centers, offsets of expected norm 1
    N, D, CHUNK, SEED = 10_000_000, 768, 524_288, 2026
    SPREAD = 1.0 / math.sqrt(D)
    nlist, nprobe, m = 4096, 64, 96
    gc = torch.Generator(device="cuda").manual_seed(SEED)
    centers = _unit(torch, torch.randn(16_384, D, generator=gc, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    idx = IVFPQIndex(D, nlist=nlist, nprobe=nprobe, m=m, refine="int8_device", device="cuda")
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    idx.reserve(N)
    torch.cuda.synchronize()
    t_reserve = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.train(mixture_chunk(torch, centers, N, idx.train_sample, SEED + 1, SPREAD))
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    stages = {"assign": (ivf_mod, "assign_clusters_topk"), "pq_encode": (ivfpq, "pq_encode"),
              "spill": (ivf_mod.IVFIndex, "_spill"), "scatter": (IVFPQIndex, "_scatter_payload"),
              "refine_bank": (ivfpq, "_quantize_rows_device")}
    t_gen = 0.0
    with StageTimer(torch, stages) as timer:
        for base in range(0, N, CHUNK):
            t0 = time.perf_counter()
            rows = mixture_chunk(torch, centers, base, min(CHUNK, N - base), SEED, SPREAD)
            torch.cuda.synchronize()
            t_gen += time.perf_counter() - t0
            idx.add(rows)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dead = torch.randperm(N, generator=g, device="cuda")[: N // 100]
    t0 = time.perf_counter()
    idx.delete(dead.cpu().numpy())
    torch.cuda.synchronize()
    t_delete = time.perf_counter() - t0
    build_s = time.perf_counter() - t_all
    mem = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "codes_gb": idx._x.numel() / 1e9,
           "ids_bias_gb": (idx._ids.numel() + idx._bias.numel()) * 4 / 1e9,
           "refine_bank_gb": (idx._dev_chunks[0].numel() + idx._dev_scales[0].numel() * 4) / 1e9}
    st = idx.stats()
    emit({"phase": 7, "build": {"N": N, "D": D, "nlist": nlist, "nprobe": nprobe, "m": m,
                                "list_cap": idx.list_cap, "seconds": round(build_s, 3),
                                "reserve": round(t_reserve, 3), "train": round(t_train, 3),
                                "generate": round(t_gen, 3), "delete": round(t_delete, 3),
                                **{k_: round(v, 3) for k_, v in timer.seconds.items()}},
          "memory": mem, "stats": st})
    centroids, codes, ids, bias = idx.arrays()
    state = (centroids, codes, ids, bias, idx._books)
    fill = torch.as_tensor(idx._fill[:nlist], device="cuda")
    ext = idx._extents()
    # the lookup floor: conflict-free lookups at 32 per SM and clock, at the
    # card's top SM clock
    sm_ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]) / 1e3
    rows_out = []
    def queries(B, r=0):  # batch r of B queries from the same mixture
        return _unit(torch, mixture_chunk(torch, centers, N + (r + 1) * 1_000_003 + B, B,
                                          SEED + 3, SPREAD))

    # (1, 1920): the filtered fetch of phase 6 (its k_fetch at a 3% filter)
    for B, k in ((1, 40), (1, 300), (1, 1920), (8, 40), (8, 300), (256, 40), (256, 300),
                 (1024, 40), (1024, 300)):
        batches = [queries(B, r) for r in range(7)]
        outs, outs_cap = [], []
        ms = _time_ms(torch, lambda qb: ivfpq.ivfpq_search_cuda(qb, *state, k, nprobe, extents=ext),
                      batches, outs)
        # the same scan over every cell's whole cap (no extents): what the
        # extents save
        ms_cap = _time_ms(torch, lambda qb: ivfpq.ivfpq_search_cuda(qb, *state, k, nprobe),
                          batches, outs_cap)
        coarse_ms = _time_ms(torch, lambda qb: ivfpq.adc_inputs(qb, centroids, idx._books, nprobe),
                             batches)
        plain_ms = _time_ms(torch, lambda qb: ivfpq.ivfpq_search(qb, *state, k, nprobe),
                            batches[:1])

        def shared(qb):
            _, probe = ivf_mod.coarse_probe(qb, centroids, nprobe)
            return ivfpq.ivfpq_batch_search(qb, probe, ivf_mod.union_cells(probe, nlist, 16),
                                            codes, ids, bias, centroids, idx._books, k)
        lib_ms = _time_ms(torch, shared, batches[:1])
        err, n_diff, bad, sampled = 0.0, 0, 0, 0
        for r, (qb, (s_k, i_k)) in enumerate(zip(batches, outs)):
            qs = qb[: min(B, 4)]
            s_p, i_p = ivfpq.ivfpq_search(qs, *state, k, nprobe)
            for s_r, i_r in [(s_k, i_k)] + ([outs_cap[0]] if r == 0 else []):
                e, d, b_ = check_topk(torch, None, None, None, s_r[: len(qs)], i_r[: len(qs)],
                                      s_p, i_p, judge=adc_judge(torch, qs, *state))
                err, n_diff, bad, sampled = max(err, e), n_diff + d, bad + b_, sampled + len(qs)
        errs["K8"] = max(errs["K8"], err)
        # bound: the probed cells' occupied slots read once (codes, ids,
        # bias), the table, probes and outputs; operations: the coarse
        # product, the table and m f32 adds per probed slot and query
        probe = ivf_mod.coarse_probe(batches[0], centroids, nprobe)[1]
        slots = float(fill[probe].sum())
        union = float(fill[torch.unique(probe)].sum())
        # code bytes the kernel reads: every probed extent (rounded to 8),
        # once a query; the union's, which a read once a batch would take
        code_bytes = {"read": float(((ext.long()[probe] + 7) // 8 * 8).sum()) * m,
                      "union": union * m}
        nbytes = (union * (m + 8) + nlist * D * 4 + B * D * 4 + B * m * 256 * 4
                  + B * nprobe * 8 + B * k * 8)
        ops = 2.0 * B * nlist * D + 2.0 * B * D * 256 + slots * m
        bound, bound_by = _bound(nbytes, ops, "float32")
        row = {"phase": 7, "kernel": "K8", "dtype": "uint8 codes", "N": N, "D": D, "B": B, "k": k,
               "ms": ms, "ms_whole_cap": ms_cap, "coarse_and_table_ms": coarse_ms,
               "lookup_floor_ms": slots * m / (32 * 132 * sm_ghz * 1e9) * 1e3,
               "lookup_floor_sm_ghz": sm_ghz, "code_bytes": code_bytes, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library": "ivfpq_batch_search (batch-shared decode)",
               "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
               "probed_slots": slots, "union_slots": union, "max_abs_err": err,
               "sampled_rows": sampled, "id_mismatches": n_diff, "mismatches_outside_ties": bad,
               "index_build_seconds": round(build_s, 3)}
        emit(row)
        rows_out.append(row)
        require(bad == 0, f"phase 7: {bad} mismatches outside ties (K8 B={B} k={k})")
    # the index end to end (K8 + device refine) and its recall@10 against an
    # exact f32 scan of the same (re-made) rows, tombstones excluded
    qr = queries(256)
    live = torch.ones(N, dtype=torch.bool, device="cuda")
    live[dead] = False
    best_s = torch.full((256, 10), -float("inf"), device="cuda")
    best_i = torch.zeros((256, 10), dtype=torch.long, device="cuda")
    t0 = time.perf_counter()
    for base in range(0, N, CHUNK):
        n = min(CHUNK, N - base)
        s = qr @ _unit(torch, mixture_chunk(torch, centers, base, n, SEED, SPREAD)).T
        s[:, ~live[base: base + n]] = -float("inf")
        v, i = torch.topk(torch.cat([best_s, s], 1), 10, dim=1)
        best_i = torch.gather(torch.cat([best_i, torch.arange(base, base + n, device="cuda")
                                         .expand(256, -1)], 1), 1, i)
        best_s = v
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    _, got = idx.search(qr, 10)
    recall = float(np.mean([len(set(a) & set(b)) / 10.0
                            for a, b in zip(got.tolist(), best_i.cpu().tolist())]))
    for B in (1, 1024):
        batches = [queries(B, 10 + r) for r in range(7)]
        idx.search(batches[0], 10)  # warm
        times = []
        for qb in batches:
            t0 = time.perf_counter()
            s_np, i_np = idx.search(qb, 10)  # returns host arrays: synchronized
            times.append((time.perf_counter() - t0) * 1e3)
        ok = (s_np.shape == (B, 10) and np.isfinite(s_np).all() and (i_np >= 0).all()
              and bool(live[torch.as_tensor(i_np, device="cuda").long()].all()))
        row = {"phase": 7, "kind": "IVFPQIndex.search", "N": N, "D": D, "B": B, "k": 10,
               "refine": idx.refine, "k_fetch": 10 * idx.refine_factor,
               "ms": statistics.median(times), "ms_all": [round(t, 3) for t in times],
               "results_ok": ok}
        if B == 1024:
            row.update({"recall_at_10": recall, "recall_queries": 256,
                        "exact_scan_seconds": round(t_exact, 3)})
        emit(row)
        rows_out.append(row)
        require(ok, f"phase 7: IVFPQIndex.search at B={B} returned dead or missing rows")
    # a sanity floor: an index that lost or scrambled its rows scores ~0
    require(recall > 0.1, f"phase 7: recall@10 {recall} against the exact scan")
    del idx, state, centroids, codes, ids, bias
    torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# the default configuration: the ensemble provider (r3 encoder) on the card
# ---------------------------------------------------------------------------

#: the JAX package's encoder embeddings of 32 fixed texts (tools/encoder_golden.py)
GOLDEN = os.path.join(ROOT, "tests", "data", "encoder_r3_golden.npz")
ENCODER_CKPT = "encoder_r3_512.npz"
# the encoder's bf16 tolerance against the JAX package and between two
# devices (tests/test_torch_encoder.py BF16_TOL at the shipped width); the
# hybrid scores and tool results of two devices' query vectors get the same
ENC_TOL = 2e-3
ENCODER_ROUTE = ("torch.mm/torch.bmm of bf16 operands with out_dtype=torch.float32 "
                 "(tensor cores, f32 sums), f32 bias/GELU/norms/softmax")


def _ranked_close(a, b, tol) -> dict:
    """Two ranked lists of (id, score), position by position: scores within
    tol; where the ids differ, the scores of that position and a neighbour
    tie within tol (a swap), else it is a mismatch outside ties."""
    require(len(a) == len(b), f"{len(a)} vs {len(b)} ranked results")
    require(all(math.isfinite(s) for _, s in a), "non-finite score")
    err = max((abs(x[1] - y[1]) for x, y in zip(a, b)), default=0.0)
    scores = [s for _, s in b]
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x[0] != y[0]]
    outside = sum(not any(abs(scores[n] - scores[i]) <= tol
                          for n in (i - 1, i + 1) if 0 <= n < len(scores)) for i in differ)
    return {"max_abs_err": err, "id_mismatches": len(differ),
            "mismatches_outside_ties": outside + int(err > tol)}


def _tool_close(got, ref, tol) -> dict:
    """Two semantic_code_search outputs: counts equal, hits as `_ranked_close`."""
    require("error" not in got and "error" not in ref, f"tool error: {got} / {ref}")
    require(got["count"] == ref["count"] > 0, f"{got['count']} vs {ref['count']} tool results")
    return {"count": got["count"], **_ranked_close(
        [(r["node_id"], r["score"]) for r in got["results"]],
        [(r["node_id"], r["score"]) for r in ref["results"]], tol)}


def _cut_tie(searches, query, limit, filters=(None, None), tol=ENC_TOL) -> str:
    """How the card's and the CPU's HybridSearch (`searches`) chose their
    candidates for `query`, each side embedding it as it serves it and
    applying its own `filters`: "same" when both kept the same chunk rows
    at the vector prefetch and the same nodes at the top-`limit` cut;
    "tie" when they differ at a cut and every row or node that one side
    alone kept scores within tol of that side's last kept score, so that
    the two encoders' roundings decided it; "differ" otherwise.

    A node's hybrid score depends on the whole candidate set (the graph
    boost is normalised by its maximum), so one chunk let in at the
    prefetch cut moves every score of that search."""
    kept = []
    for search, flt in zip(searches, filters):
        lim = min(limit or search.config.default_limit, search.config.max_limit)
        q = search.provider.embed_texts([query])[0]
        prefetch = max(lim * search.config.prefetch_multiplier, lim)
        s, r = search._vector_search(q, prefetch, None if flt is None or flt.empty else flt)
        rows = {i: v for i, v in zip(r[0].tolist(), s[0].tolist()) if i >= 0}
        hits = search.search_embedding(q, lim, text_query=query, filters=flt)
        kept.append((rows, {h.node_id: h.score for h in hits}))
    for stage in (0, 1):
        a, b = kept[0][stage], kept[1][stage]
        if a.keys() == b.keys():
            continue
        for own, other in ((a, b), (b, a)):
            last = min(own.values())
            if any(own[x] - last > tol for x in own.keys() - other.keys()):
                return "differ"
        return "tie"
    return "same"


def _log_searches(search) -> list:
    """The (query, limit, filters) of every search_text call on the
    HybridSearch `search` from now on, in a list the caller may clear."""
    calls = []
    inner = search.search_text

    def logged(query, limit=0, filters=None):
        calls.append((query, limit, filters))
        return inner(query, limit, filters)

    search.search_text = logged
    return calls


def _unless_cut_tie(r, searches, query, limit, filters=(None, None), tol=ENC_TOL) -> dict:
    """r, a comparison of one search on the card and on the CPU, as it
    stands, unless it holds a mismatch and `_cut_tie` finds the two sides'
    candidates differ by a tie at a cut: then that search is counted in
    `cut_ties` and its mismatches are not held."""
    r = {**r, "cut_ties": 0}
    if r["mismatches_outside_ties"] and _cut_tie(searches, query, limit, filters, tol) == "tie":
        r["cut_ties"], r["mismatches_outside_ties"] = 1, 0
    return r


def _encoder_forward_ms(torch, enc, B, L, reps=20):
    """Median ms of one encoder forward at [B, L] (CUDA events) on seeded
    random token ids, every position live."""
    from codegraph_tpu_torch.models.encoder import encode

    g = torch.Generator(device="cuda").manual_seed(8)
    ids = torch.randint(0, enc.cfg.vocab_size, (B, L), generator=g, device="cuda")
    mask = torch.ones((B, L), dtype=torch.bool, device="cuda")
    with torch.inference_mode():  # as the providers run it
        return _time_ms(torch, lambda _: encode(enc.params, ids, mask, enc.cfg), [None] * reps)


def phase8(torch, mods, errs) -> dict:
    """The default configuration through the entry points: CodeGraphConfig()
    with only data_dir set, so the ensemble provider (the r3 encoder on the
    card + the hash half), a flat f32 index, hybrid search (K1), QueryService
    (K2), the feature reranker and the semantic_code_search tool."""
    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.core.config import CodeGraphConfig
    from codegraph_tpu_torch.index.flat import FlatIndex
    from codegraph_tpu_torch.mcp.tools import GraphToolExecutor
    from codegraph_tpu_torch.models.bpe import BPETokenizer
    from codegraph_tpu_torch.models.providers import EncoderProvider, HybridEmbeddingPipeline
    from codegraph_tpu_torch.search.reranker import make_reranker_pipeline
    from codegraph_tpu_torch.search.service import QueryService

    require(os.path.exists(GOLDEN), f"no golden embeddings at {GOLDEN}")
    tmp = tempfile.mkdtemp(prefix="cg_smoke_default_")
    svc = None
    try:
        proj = _project_copy(tmp)
        cfg = CodeGraphConfig()
        cfg.data_dir = os.path.join(tmp, "data")

        reset_launches(mods)
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        t_open = time.perf_counter() - t0
        prov = cg.indexer.provider
        require(isinstance(prov, HybridEmbeddingPipeline)
                and [p.name for p in prov.providers] == ["ensemble", "hash"],
                f"phase 8: the default provider is {getattr(prov, 'name', prov)!r}")
        ens, hsh = prov.providers
        enc = ens.encoder
        require(os.path.basename(enc.checkpoint or "") == ENCODER_CKPT,
                f"phase 8: the encoder came from {enc.checkpoint!r}")
        require(isinstance(enc.tokenizer, BPETokenizer) and enc.tokenizer.vocab_size == 16644,
                f"phase 8: the encoder's tokenizer is {type(enc.tokenizer).__name__}")
        require({v.device.type for v in enc.params.values()} == {"cuda"},
                "phase 8: encoder parameters are not all on the card")
        require(isinstance(cg.indexer.index, FlatIndex) and cg.indexer.index.dim == 768,
                "phase 8: the default index is not a flat 768-d index")

        t0 = time.perf_counter()
        stats = cg.index()
        t_index = time.perf_counter() - t0
        counters = enc.counters.to_dict()
        index_texts = enc.metrics.texts

        hits, search_s, parts = [], [], []
        for i, qt in enumerate(QUERIES):
            t0 = time.perf_counter()
            # the first two searches by part (the first one after index())
            with StageTimer(torch, hybrid_parts(cg) if i < 2 else {}) as timer:
                hits.append(cg.search(qt, limit=10))
            search_s.append(time.perf_counter() - t0)
            if i < 2:
                parts.append(_parts_ms(timer, search_s[-1]))
        # the encoder's share of a B=1 search: the same queries' embedding alone
        embed_s = []
        for qt in QUERIES:
            t0 = time.perf_counter()
            prov.embed_texts([f"{qt} again"])
            embed_s.append(time.perf_counter() - t0)
        index = cg.indexer.index
        texts = [f"{QUERIES[i % 5]} variant {i}" for i in range(64)]
        embs = prov.embed_texts(texts)
        k = 30
        t0 = time.perf_counter()
        svc = QueryService.auto(index, k=k)
        futures = [svc.submit(e) for e in embs]
        batched = [f.result(timeout=120) for f in futures]
        svc.close()
        svc_stats = svc.stats
        svc = None
        t_service = time.perf_counter() - t0
        # the main path ends here; later launches only check results
        launches = read_launches(mods)

        # the service (K2) against single queries (K1), and each kernel
        # against its plain version, on the encoder's embeddings
        singles = [index.search(e[None, :], k) for e in embs]
        x, bias = index.arrays()
        qn = torch.nn.functional.normalize(torch.as_tensor(embs, device="cuda"), dim=1)
        s_b = torch.as_tensor(np.stack([b[0] for b in batched]), device="cuda")
        i_b = torch.as_tensor(np.stack([b[1] for b in batched]), device="cuda")
        s_1 = torch.as_tensor(np.stack([s[0][0] for s in singles]), device="cuda")
        i_1 = torch.as_tensor(np.stack([s[1][0] for s in singles]), device="cuda")
        err_svc, diff_svc, bad_svc = check_topk(torch, qn, x, bias, s_b, i_b, s_1, i_1)
        errs["K2"] = max(errs["K2"], err_svc)
        topk = mods["topk"]
        main_shapes = {}
        for name, fn, B in (("K1", topk.streaming_topk_cuda, 1),
                            ("K2", topk.streaming_topk_cuda_qmajor, 64)):
            s_k, i_k = fn(qn[:B].contiguous(), x, bias, k)
            s_p, i_p = topk.streaming_topk(qn[:B], x, bias, k)
            e, n_d, b_d = check_topk(torch, qn[:B], x, bias, s_k, i_k, s_p, i_p)
            errs[name] = max(errs[name], e)
            main_shapes[name] = {"N": int(x.shape[0]), "B": B, "k": k, "max_abs_err": e,
                                 "id_mismatches": n_d, "mismatches_outside_ties": b_d}

        # the encoder against the JAX package's golden embeddings and
        # against this port's CPU path on the same texts
        gold = np.load(GOLDEN)
        gtexts = [str(t) for t in gold["texts"]]
        card_enc = enc.embed_texts(gtexts)
        card_ens = ens.embed_texts(gtexts)
        cpu_enc = EncoderProvider(batch_size=32, checkpoint=enc.checkpoint, device="cpu")
        cpu_vecs = cpu_enc.embed_texts(gtexts)
        encoder_errs = {
            "vs_jax_golden": float(np.abs(card_enc - gold["encoder"]).max()),
            "ensemble_vs_jax_golden": float(np.abs(card_ens - gold["ensemble"]).max()),
            "vs_cpu_path": float(np.abs(card_enc - cpu_vecs).max()),
            "cpu_path_vs_jax_golden": float(np.abs(cpu_vecs - gold["encoder"]).max()),
            "texts": len(gtexts),
        }
        forward_ms = {"B=1 L=64": _encoder_forward_ms(torch, enc, 1, 64),
                      "B=256 L=192": _encoder_forward_ms(torch, enc, 256, 192)}

        # the same snapshot on the CPU: the card's query vectors on both
        # sides (the index stage alone differs), then each side's own text path
        # (a search whose candidates differ by a tie at a cut is counted: _cut_tie)
        t0 = time.perf_counter()
        cpu = CodeGraph(cfg, device="cpu")
        require(len(cpu.indexer.index) == len(index), "phase 8: CPU snapshot load")
        qvecs = prov.embed_texts(QUERIES)
        same_vec, own_text = [], []
        boundary_ties = 0
        for qt, qv, got in zip(QUERIES, qvecs, hits):
            s_g, i_g = index.search(qv[None, :], 30)
            s_c, i_c = cpu.indexer.index.search(qv[None, :], 30)
            if set(i_g[0].tolist()) != set(i_c[0].tolist()):
                boundary_ties += 1  # a tie at the prefetch boundary let another chunk in
            else:
                same_vec.append(_hits_vs(cg.indexer.search.search_embedding(qv, 10, text_query=qt),
                                         cpu.indexer.search.search_embedding(qv, 10, text_query=qt)))
            own_text.append(_unless_cut_tie(_hits_vs(got, cpu.search(qt, limit=10), ENC_TOL),
                                            (cg.indexer.search, cpu.indexer.search), qt, 10))
        tool_args = {"query": QUERIES[2], "limit": 10}
        tools = GraphToolExecutor(cg.graph, cg.indexer.search,
                                  make_reranker_pipeline(prov, cfg.search),
                                  rerank_default=cfg.search.rerank)
        cpu_tools = GraphToolExecutor(cpu.graph, cpu.indexer.search,
                                      make_reranker_pipeline(cpu.indexer.provider, cfg.search),
                                      rerank_default=cfg.search.rerank)
        t1 = time.perf_counter()
        tool_out = tools.execute("semantic_code_search", tool_args)
        t_tool = time.perf_counter() - t1
        tool = _unless_cut_tie(
            _tool_close(tool_out, cpu_tools.execute("semantic_code_search", tool_args), ENC_TOL),
            (cg.indexer.search, cpu.indexer.search), tool_args["query"], tool_args["limit"],
            (tools._auto_filters(tool_args["query"]), cpu_tools._auto_filters(tool_args["query"])))
        tool["seconds"] = round(t_tool, 4)
        t_cpu = time.perf_counter() - t0

        def worst(rows, key):
            return max((r[key] for r in rows), default=0)

        out = {
            "phase": 8, "gpu": nvidia_smi_line(), "files": stats.files_total,
            "nodes": stats.nodes, "chunks": stats.chunks, "edges": stats.edges_total,
            "edges_semantic": stats.edges_resolved_semantic,
            "open_seconds": round(t_open, 3), "index_seconds": round(t_index, 3),
            "stage_seconds": {k_: round(v, 3) for k_, v in stats.stage_seconds.items()},
            "encoder": {**counters, "index_texts": index_texts,
                        "texts_per_s": counters["texts"] / max(
                            counters["tokenize_seconds"] + counters["forward_seconds"], 1e-9),
                        "tokens_per_s_forward": counters["tokens"] / max(
                            counters["forward_seconds"], 1e-9),
                        "route": ENCODER_ROUTE},
            "providers": {p.name: {"texts": p.metrics.texts, "failures": p.metrics.failures}
                          for p in (ens, enc, hsh)},
            "search_seconds_5": round(sum(search_s), 3),
            "search_ms_each": [round(t * 1e3, 3) for t in search_s],
            "search_parts_ms_first_two": parts,
            "query_embed_ms_each": [round(t * 1e3, 3) for t in embed_s],
            "search_perf": cg.indexer.search.monitor.report(),
            "service_seconds_64": round(t_service, 3),
            "service_batches": svc_stats.batches, "service_max_batch": svc_stats.max_batch_seen,
            "launches": launches,
            "service_vs_single": {"max_abs_err": err_svc, "id_mismatches": diff_svc,
                                  "mismatches_outside_ties": bad_svc},
            "kernel_vs_plain_main_shapes": main_shapes,
            "encoder_max_abs_err": encoder_errs, "encoder_forward_ms": forward_ms,
            "hybrid_same_vectors_vs_cpu": {
                "max_abs_err": worst(same_vec, "max_abs_err"),
                "id_mismatches": sum(r["id_mismatches"] for r in same_vec),
                "mismatches_outside_ties": sum(r["mismatches_outside_ties"] for r in same_vec),
                "queries_with_prefetch_boundary_ties": boundary_ties},
            "hybrid_own_text_vs_cpu": {
                "max_abs_err": worst(own_text, "max_abs_err"),
                "id_mismatches": sum(r["id_mismatches"] for r in own_text),
                "mismatches_outside_ties": sum(r["mismatches_outside_ties"] for r in own_text),
                "cut_ties": sum(r["cut_ties"] for r in own_text)},
            "tool_vs_cpu": tool, "cpu_side_seconds": round(t_cpu, 3),
            "top1": [h[0].name if h else None for h in hits],
        }
        emit(out)
        require(stats.nodes > 0 and stats.chunks > 0 and stats.edges_total > 0, "empty index")
        require(hsh.metrics.texts == 0, f"phase 8: the hash member embedded {hsh.metrics.texts} texts")
        require(all(p.metrics.failures == 0 for p in (ens, enc, hsh)),
                "phase 8: a provider recorded a failure")
        require(index_texts >= stats.chunks and len(index) == stats.chunks,
                f"phase 8: the encoder embedded {index_texts} texts for {stats.chunks} chunks")
        require(bad_svc == 0, "phase 8: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                "phase 8: a kernel disagrees with its plain version at the main path's shapes")
        require(launches["K1"] > 0 and launches["K2"] > 0,
                f"phase 8: the default path did not launch K1 and K2: {launches}")
        require(all(launches[n] == 0 for n in launches if n not in ("K1", "K2")),
                f"phase 8: the default path launched another kernel: {launches}")
        require(all(v <= ENC_TOL for k_, v in encoder_errs.items() if k_ != "texts"),
                f"phase 8: the encoder is off its references: {encoder_errs}")
        require(out["hybrid_same_vectors_vs_cpu"]["mismatches_outside_ties"] == 0
                and out["hybrid_own_text_vs_cpu"]["mismatches_outside_ties"] == 0,
                "phase 8: CUDA hybrid results disagree with the CPU snapshot")
        require(tool["mismatches_outside_ties"] == 0,
                "phase 8: the semantic_code_search tool disagrees with the CPU snapshot")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: the served path (MCP server, agents, CLI)
# ---------------------------------------------------------------------------

# every semantic search below asks a query no earlier call asked, so that
# each reaches the index (no tool or search cache hit) and launches K1
CLI_QUERY = "load the graph snapshot from disk"
FAKE_LLM_QUERY = "where are tool calls dispatched to the graph executor"
FAKE_LLM_ANSWER = "Tool calls go through GraphToolExecutor.execute, which dispatches to GraphQueries."
FAKE_ASK_ANSWER = "The evidence points at the cited files; see the sources."


def _rpc(method, params=None, mid=1):
    msg = {"jsonrpc": "2.0", "method": method}
    if mid is not None:
        msg["id"] = mid
    if params is not None:
        msg["params"] = params
    return msg


def _call(name, args, mid, token=None):
    params = {"name": name, "arguments": args}
    if token is not None:
        params["_meta"] = {"progressToken": token}
    return _rpc("tools/call", params, mid)


def _payload(reply, what) -> dict:
    """The tool result of a tools/call reply; fails on a JSON-RPC error, on
    isError, and on an `error` key in the result or in any of its evidence."""
    require(reply is not None and "error" not in reply, f"phase 9: {what}: {reply}")
    result = reply["result"]
    require(result.get("isError") is False, f"phase 9: {what}: isError {result}")
    payload = json.loads(result["content"][0]["text"])
    require("error" not in payload, f"phase 9: {what}: {payload.get('error')}")
    for ev in payload.get("evidence", []):
        require("error" not in ev["result"], f"phase 9: {what}: {ev['tool']}: {ev['result']}")
    return payload


def _payload_close(got, ref, tol, cut_tie=None, params=None) -> dict:
    """Two tool payloads: search hits as `_tool_close`; an agentic result's
    evidence item by item (the graph tools it seeds with the top hit only
    where the top hits agree); anything else exactly. With `cut_tie` (a
    search's params -> whether the two sides' candidates differ by a tie at
    a cut, `_cut_tie`), a search that differs so counts in `cut_ties` and
    its mismatches are not held; `params` are a search payload's own."""
    def search(g, r, p):
        out = {**_tool_close(g, r, tol), "cut_ties": 0}
        if cut_tie is not None and out["mismatches_outside_ties"] and cut_tie(p):
            out["cut_ties"], out["mismatches_outside_ties"] = 1, 0
        return out

    if "results" in got:
        return search(got, ref, params)
    out = {"max_abs_err": 0.0, "id_mismatches": 0, "mismatches_outside_ties": 0, "cut_ties": 0}
    if "evidence" in got:
        require([e["tool"] for e in got["evidence"]] == [e["tool"] for e in ref["evidence"]]
                and got["agent"] == ref["agent"], "phase 9: agentic evidence differs")
        same_top = True
        for eg, er in zip(got["evidence"], ref["evidence"]):
            if "results" in eg["result"]:
                r = search(eg["result"], er["result"], eg["params"])
                same_top = eg["result"]["results"][0]["node_id"] == er["result"]["results"][0]["node_id"]
                for key in out:
                    out[key] = max(out[key], r[key]) if key == "max_abs_err" else out[key] + r[key]
            elif same_top:
                out["mismatches_outside_ties"] += int(eg != er)
        return out
    out["mismatches_outside_ties"] = int(got != ref)
    return out


def _fake_llm():
    """A scripted OpenAI-compatible chat endpoint on localhost: the first
    turn of a conversation asks for one semantic_code_search call, the turn
    after a tool result answers. Streamed (SSE) or JSON, as asked."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body leave in two writes: without TCP_NODELAY each
        # reply would wait out the client's delayed ACK (~40 ms)
        disable_nagle_algorithm = True

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen.append(body)
            if "tools" not in body and body["messages"][0]["content"].startswith("Question: "):
                # a RAG completion (CodeGraph.ask, phase 10): plain JSON text
                data = json.dumps({"choices": [{"message": {
                    "role": "assistant", "content": FAKE_ASK_ANSWER},
                    "finish_reason": "stop"}]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            answered = body["messages"][-1]["content"].startswith("[tool result for")
            call = {"index": 0, "id": "call_1", "type": "function",
                    "function": {"name": "semantic_code_search",
                                 "arguments": json.dumps({"query": FAKE_LLM_QUERY, "limit": 5})}}
            if body.get("stream"):
                if answered:
                    half = len(FAKE_LLM_ANSWER) // 2
                    chunks = [{"choices": [{"delta": {"content": FAKE_LLM_ANSWER[:half]}}]},
                              {"choices": [{"delta": {"content": FAKE_LLM_ANSWER[half:]}}]},
                              {"choices": [{"delta": {}, "finish_reason": "stop"}]}]
                else:
                    chunks = [{"choices": [{"delta": {"tool_calls": [call]},
                                            "finish_reason": "tool_calls"}]}]
                raw = "".join(f"data: {json.dumps(c)}\n\n" for c in chunks) + "data: [DONE]\n\n"
                ctype = "text/event-stream"
            else:
                msg = ({"role": "assistant", "content": FAKE_LLM_ANSWER} if answered else
                       {"role": "assistant", "content": None, "tool_calls": [call]})
                raw = json.dumps({"choices": [{"message": msg, "finish_reason":
                                               "stop" if answered else "tool_calls"}]})
                ctype = "application/json"
            data = raw.encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}/v1", seen


def _http(port, method, body=None, headers=None, path="/mcp"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _stdio(server, msgs) -> list:
    import io

    out = io.StringIO()
    server.serve_stdio(io.StringIO("".join(json.dumps(m) + "\n" for m in msgs)), out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def phase9(torch, mods, errs) -> dict:
    """The served path: the port's CLI (`index`, then `start stdio` fed five
    JSON-RPC lines) as subprocesses on the card, then the MCP server of the
    same snapshot in this process over stdio and HTTP (sessions, SSE, two
    calls at once, DELETE, /metrics), the no-LLM agentic pipelines and one
    ReAct agent driven by a scripted LLM on localhost; checked against the
    CLI's replies, against the same snapshot served from the CPU (a search
    whose candidates differ by a tie at a cut counted: `_cut_tie`), and
    concurrent calls against serial ones."""
    import copy
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.core.config import CodeGraphConfig
    from codegraph_tpu_torch.mcp.server import make_server

    tmp = tempfile.mkdtemp(prefix="cg_smoke_served_")
    httpd = fake = None
    try:
        proj = _project_copy(tmp)
        data = os.path.join(tmp, "data")
        toml = os.path.join(tmp, "config.toml")
        with open(toml, "w") as f:
            f.write(f'data_dir = "{data}"\n')
        env = {**os.environ, "PYTHONPATH": ROOT}
        cli = [sys.executable, "-m", "codegraph_tpu_torch.cli", "--device", "cuda", "--config", toml]

        # 1. the CLI on the card: index, then start stdio with five lines
        t0 = time.perf_counter()
        proc = subprocess.run(cli + ["index", proj], capture_output=True, text=True,
                              timeout=300, env=env, cwd=ROOT)
        t_cli_index = time.perf_counter() - t0
        require(proc.returncode == 0, f"phase 9: cli index exited {proc.returncode}: "
                                      f"{proc.stderr[-3000:]}")
        cli_stats = json.loads(proc.stdout)
        cli_msgs = [_rpc("initialize", {}, 1), _rpc("tools/list", mid=2),
                    _call("semantic_code_search", {"query": CLI_QUERY, "limit": 10}, 3),
                    _call("agentic_context", {"query": CLI_QUERY}, 4),
                    _rpc("prompts/get", {"name": "code_search",
                                         "arguments": {"query": CLI_QUERY}}, 5)]
        t0 = time.perf_counter()
        proc = subprocess.run(cli + ["start", "stdio"],
                              input="".join(json.dumps(m) + "\n" for m in cli_msgs),
                              capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        t_cli_start = time.perf_counter() - t0
        require(proc.returncode == 0, f"phase 9: cli start stdio exited {proc.returncode}: "
                                      f"{proc.stderr[-3000:]}")
        cli_replies = []
        for line in proc.stdout.splitlines():
            try:
                cli_replies.append(json.loads(line))
            except ValueError:
                raise CheckFailed(f"phase 9: a stdout line of start stdio is not JSON: {line!r}")
        require([r.get("id") for r in cli_replies] == [1, 2, 3, 4, 5],
                f"phase 9: start stdio replied {[r.get('id') for r in cli_replies]}")
        require(all("error" not in r for r in cli_replies), "phase 9: a CLI reply is an error")
        cli_search = _payload(cli_replies[2], "cli semantic_code_search")
        cli_agentic = _payload(cli_replies[3], "cli agentic_context")

        # 2. the same snapshot in this process, served as the CLI serves it
        cfg = CodeGraphConfig()
        cfg.data_dir = data
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        index = cg.indexer.index
        require(len(index) == cli_stats["chunks"] > 0, "phase 9: the CLI's snapshot did not load")
        server = make_server(cg.indexer, cfg)
        fake, fake_url, fake_seen = _fake_llm()
        lcfg = copy.deepcopy(cfg)
        lcfg.llm.provider, lcfg.llm.base_url, lcfg.llm.model = "openai_compatible", fake_url, "scripted"
        llm_server = make_server(cg.indexer, lcfg)
        hub = cg.graph.hub_nodes(3)["hubs"][0]["name"]
        src_file = sorted(cg.indexer.store.file_metadata)[0]
        direct = [
            ("get_transitive_dependencies", {"node": hub, "max_depth": 3}),
            ("detect_circular_dependencies", {}),
            ("trace_call_chain", {"source": hub, "max_depth": 4}),
            ("calculate_coupling_metrics", {"node": hub}),
            ("get_hub_nodes", {"limit": 10}),
            ("get_reverse_dependencies", {"node": hub}),
            ("find_nodes_by_name", {"name": "search", "limit": 10}),
            ("find_complexity_hotspots", {"limit": 10}),
        ]
        agentic = [(name, f"{name} over the served snapshot") for name in
                   ("agentic_context", "agentic_impact", "agentic_architecture", "agentic_quality")]
        # the queries of the semantic searches asked below (tools, pipelines,
        # CodeGraph.search, the agent), and the searches that missed the
        # hybrid search's cache: each of those runs the index's top-k
        asked = {CLI_QUERY, FAKE_LLM_QUERY, "progress of a tools/call"}
        asked |= {q for name, q in agentic if name in ("agentic_context", "agentic_impact")}
        misses0 = cg.indexer.search.cache.misses

        reset_launches(mods)
        # 2a. stdio: the CLI's lines, resources, prompts, a call with a
        # progress token, every direct tool and the four agentic pipelines
        session = cli_msgs + [
            _rpc("ping", mid=6), _rpc("resources/list", mid=7),
            _rpc("resources/read", {"uri": f"codegraph://file/{src_file}"}, 8),
            _rpc("prompts/list", mid=9),
            _call("semantic_code_search", {"query": "progress of a tools/call", "limit": 10},
                  10, token="p10"),
        ] + [_call(t, a, 20 + i) for i, (t, a) in enumerate(direct)] + [
            _call(n, {"query": q}, 30 + i) for i, (n, q) in enumerate(agentic)]
        t0 = time.perf_counter()
        replies = _stdio(server, session)
        t_stdio_session = time.perf_counter() - t0
        by_id = {r["id"]: r for r in replies if "id" in r}
        notes = [r for r in replies if "id" not in r]
        require(sorted(by_id) == sorted(m["id"] for m in session),
                f"phase 9: stdio replied to {sorted(by_id)}")
        require(all("error" not in r for r in by_id.values()), "phase 9: a stdio reply is an error")
        require([n["params"]["progress"] for n in notes
                 if n.get("method") == "notifications/progress"] == [10, 100],
                f"phase 9: progress notifications {notes}")
        served = {mid: _payload(r, f"stdio id {mid}") for mid, r in by_id.items()
                  if "content" in r["result"]}
        require(len(served) == 3 + len(direct) + len(agentic), "phase 9: tool replies missing")
        require(by_id[8]["result"]["contents"][0]["text"], "phase 9: resources/read is empty")

        # 2b. timed: one tools/call over stdio, the same through
        # CodeGraph.search, an agentic pipeline (each a new query)
        timed = {"stdio": [], "search": [], "agentic_pipeline": []}
        for i in range(5):
            asked |= {f"timed stdio query {i} about edges", f"timed library query {i} about edges",
                      f"timed agentic query {i}"}
            t0 = time.perf_counter()
            r = _stdio(server, [_call("semantic_code_search",
                                      {"query": f"timed stdio query {i} about edges", "limit": 10},
                                      100 + i)])
            timed["stdio"].append((time.perf_counter() - t0) * 1e3)
            _payload(r[-1], "timed stdio call")
            t0 = time.perf_counter()
            hits = cg.search(f"timed library query {i} about edges", limit=10)
            timed["search"].append((time.perf_counter() - t0) * 1e3)
            require(hits and all(math.isfinite(h.score) for h in hits), "phase 9: CodeGraph.search")
            t0 = time.perf_counter()
            _payload(server.handle_message(_call("agentic_context",
                                                 {"query": f"timed agentic query {i}"}, 200 + i)),
                     "timed agentic_context")
            timed["agentic_pipeline"].append((time.perf_counter() - t0) * 1e3)

        # 2c. HTTP: a session, JSON and SSE calls, two calls at once
        httpd = server.make_http_server("127.0.0.1", 0)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        status, headers, body = _http(port, "POST", _rpc("initialize", {}))
        sid = headers.get("Mcp-Session-Id", "")
        require(status == 200 and len(sid) == 32, f"phase 9: initialize over HTTP: {status}")
        hs = {"Mcp-Session-Id": sid}
        status, headers, body = _http(port, "POST", _call(
            "semantic_code_search", {"query": "JSON over streamable HTTP", "limit": 10}, 2), hs)
        require(status == 200 and headers["Content-Type"] == "application/json",
                f"phase 9: JSON tools/call {status}")
        http_json = _payload(json.loads(body), "HTTP JSON tools/call")
        status, headers, body = _http(port, "POST", _call(
            "semantic_code_search", {"query": "server-sent events over HTTP", "limit": 10}, 3,
            token="s3"), {**hs, "Accept": "application/json, text/event-stream"})
        require(status == 200 and headers["Content-Type"] == "text/event-stream",
                f"phase 9: SSE tools/call {status}")
        events = [json.loads(block.split("data: ", 1)[1])
                  for block in body.decode().split("\n\n") if block.strip()]
        require([e["params"]["progress"] for e in events[:-1]] == [10, 100]
                and events[-1].get("id") == 3, f"phase 9: SSE events {events}")
        _payload(events[-1], "HTTP SSE tools/call")
        asked |= {"JSON over streamable HTTP", "server-sent events over HTTP"}
        conc_msgs = [_call("semantic_code_search", {"query": q, "limit": 10}, 40 + i)
                     for i, q in enumerate(("two calls at once: the first",
                                            "two calls at once: the second"))]
        with ThreadPoolExecutor(2) as pool:
            conc = list(pool.map(lambda m: _http(port, "POST", m, hs), conc_msgs))
        concurrent = [_payload(json.loads(c[2]), "concurrent tools/call") for c in conc]
        server.tools.invalidate()
        cg.indexer.search.cache.invalidate()
        serial = [_payload(json.loads(_http(port, "POST", m, hs)[2]), "serial tools/call")
                  for m in conc_msgs]
        asked |= {m["params"]["arguments"]["query"] for m in conc_msgs}
        timed["http"] = []
        for i in range(5):
            asked.add(f"timed http query {i} about nodes")
            t0 = time.perf_counter()
            status, _, body = _http(port, "POST", _call(
                "semantic_code_search", {"query": f"timed http query {i} about nodes",
                                         "limit": 10}, 300 + i), hs)
            timed["http"].append((time.perf_counter() - t0) * 1e3)
            _payload(json.loads(body), "timed HTTP call")
        status_unknown = _http(port, "POST", _rpc("ping"), {"Mcp-Session-Id": "0" * 32})[0]
        status_get = _http(port, "GET")[0]
        status_delete = _http(port, "DELETE", headers=hs)[0]
        status_after = _http(port, "POST", _rpc("ping"), hs)[0]
        status_metrics, _, metrics = _http(port, "GET", path="/metrics")
        samples = dict(line.rsplit(" ", 1) for line in metrics.decode().splitlines()
                       if line and not line.startswith("#"))

        # 2d. the ReAct agent, its LLM a scripted endpoint on localhost (the
        # time inside the LLM's calls is kept apart from the agent's own)
        llm_ms = []
        llm_stream = llm_server.llm.chat_stream

        def timed_stream(*args, **kwargs):
            t1 = time.perf_counter()
            resp = llm_stream(*args, **kwargs)
            llm_ms.append((time.perf_counter() - t1) * 1e3)
            return resp

        llm_server.llm.chat_stream = timed_stream
        notes = []
        t0 = time.perf_counter()
        reply = llm_server.handle_message(_call(
            "agentic_context", {"query": "how does the server dispatch a tool call"}, 50,
            token="a50"), notify=notes.append)
        t_react = (time.perf_counter() - t0) * 1e3
        react = _payload(reply, "ReAct agentic_context")
        # the main path ends here; later launches only check results
        launches = read_launches(mods)
        n_search = cg.indexer.search.cache.misses - misses0
        streamed = "".join(n["params"]["data"] for n in notes
                           if n.get("method") == "notifications/message")

        # 3. checks: the CLI process against this one, the CPU snapshot
        in_proc = {mid: served[mid] for mid in (3, 4)}
        cli_vs_card = [_payload_close(cli_search, in_proc[3], SCORE_TOL),
                       _payload_close(cli_agentic, in_proc[4], SCORE_TOL)]
        conc_vs_serial = [_payload_close(c, s, SCORE_TOL) for c, s in zip(concurrent, serial)]
        cpu = CodeGraph(cfg, device="cpu")
        require(len(cpu.indexer.index) == len(index), "phase 9: CPU snapshot load")
        cpu_server = make_server(cpu.indexer, cfg)
        cpu_replies = _stdio(cpu_server, session)
        cpu_by_id = {r["id"]: r for r in cpu_replies if "id" in r}
        args = {m["id"]: m["params"]["arguments"] for m in session if m["method"] == "tools/call"}

        def cut_tie(p):
            # each side's search as its server runs it: its own query
            # vector, the tools' soft filters of the query
            q = p["query"]
            return _cut_tie((cg.indexer.search, cpu.indexer.search), q, int(p.get("limit", 10)),
                            (server.tools._auto_filters(q), cpu_server.tools._auto_filters(q))) == "tie"

        card_vs_cpu = {}
        for mid, payload in served.items():
            card_vs_cpu[mid] = _payload_close(payload, _payload(cpu_by_id[mid], f"CPU id {mid}"),
                                              ENC_TOL, cut_tie, args[mid])
        plain = {mid: by_id[mid] == cpu_by_id[mid] for mid in (1, 2, 5, 6, 7, 8, 9)}

        def total(rows, key):
            vals = [r[key] for r in rows]
            return max(vals) if key == "max_abs_err" else sum(vals)

        keys = ("max_abs_err", "id_mismatches", "mismatches_outside_ties", "cut_ties")
        out = {
            "phase": 9, "gpu": nvidia_smi_line(), "chunks": cli_stats["chunks"],
            "cli_index_seconds": round(t_cli_index, 3), "cli_start_seconds": round(t_cli_start, 3),
            "stdio_session_seconds": round(t_stdio_session, 3), "stdio_session_calls": len(session),
            "tools_call_ms": {k: {"median": round(statistics.median(v), 3),
                                  "each": [round(x, 3) for x in v]} for k, v in timed.items()},
            "react_agent_ms": round(t_react, 3), "react_llm_ms": [round(x, 3) for x in llm_ms],
            "fake_llm_requests": len(fake_seen),
            "launches": launches, "uncached_searches": n_search, "distinct_queries": len(asked),
            "http_status": {"unknown_session": status_unknown, "get": status_get,
                            "delete": status_delete, "after_delete": status_after,
                            "metrics": status_metrics},
            "metrics_samples": len(samples),
            "cli_vs_card": {k: total(cli_vs_card, k) for k in keys},
            "concurrent_vs_serial": {k: total(conc_vs_serial, k) for k in keys},
            "card_vs_cpu": {k: total(list(card_vs_cpu.values()), k) for k in keys},
            "plain_replies_equal_cpu": plain,
            "react": {"agent": react["agent"], "turns": react["turns"],
                      "evidence": [e["tool"] for e in react["evidence"]],
                      "streamed_chars": len(streamed)},
            "http_json_count": http_json["count"],
        }
        emit(out)
        require(launches["K1"] >= n_search >= len(asked),
                f"phase 9: {launches['K1']} K1 launches for {n_search} uncached searches "
                f"of {len(asked)} queries")
        require(all(v == 0 for k_, v in launches.items() if k_ != "K1"),
                f"phase 9: the served path launched another kernel: {launches}")
        require(react["agent"] == "react" and react["evidence"]
                and react["evidence"][0]["tool"] == "semantic_code_search"
                and react["answer"] == FAKE_LLM_ANSWER and streamed == FAKE_LLM_ANSWER
                and len(fake_seen) == 2, f"phase 9: the ReAct agent did not run: {out['react']}")
        require(out["cli_vs_card"]["mismatches_outside_ties"] == 0
                and out["cli_vs_card"]["max_abs_err"] <= SCORE_TOL,
                f"phase 9: the CLI's replies differ from the card's: {out['cli_vs_card']}")
        require(out["concurrent_vs_serial"]["mismatches_outside_ties"] == 0,
                f"phase 9: concurrent replies differ from serial: {out['concurrent_vs_serial']}")
        require(out["card_vs_cpu"]["mismatches_outside_ties"] == 0,
                f"phase 9: the card's replies differ from the CPU snapshot's: {out['card_vs_cpu']}")
        require(all(plain.values()), f"phase 9: protocol replies differ from the CPU's: {plain}")
        require((status_unknown, status_get, status_delete, status_after, status_metrics)
                == (404, 405, 204, 404, 200), f"phase 9: HTTP statuses {out['http_status']}")
        require(float(samples.get("codegraph_index_rows", -1)) == len(index)
                and 'codegraph_tool_calls_total{tool="semantic_code_search"}' in samples,
                "phase 9: /metrics lacks the index or tool samples")
        return out
    finally:
        for srv in (httpd, fake):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: the rest of the serving surface (cross-encoder reranker,
# CodeGraph.ask/insights, the router, the segmented index)
# ---------------------------------------------------------------------------

CE_GOLDEN = os.path.join(ROOT, "tests", "data", "cross_encoder_r3_golden.npz")
CE_CKPT = "cross_encoder_r3.npz"
# the cross-encoder's bf16 tolerance against the JAX package and between two
# devices (tests/test_torch_cross_encoder.py CE_TOL and CE_MEAN_TOL): its CLS
# vectors are not normalized (|x| < 4, where a bf16 step is up to 2^-6)
CE_TOL = 6.25e-2
CE_MEAN_TOL = 5e-3
CE_QUERIES = [f"rerank query {i}: how are search results scored and ordered" for i in range(5)]
ASK_QUESTIONS = ["how does the server dispatch a tool call?",
                 "where is the graph snapshot loaded from disk",
                 "explain the reranker pipeline"]
INSIGHT_TOPICS = ["hybrid search scoring", "graph snapshot archive"]
SEG_N, SEG_D, SEG_JOB, SEG_K = 1_000_000, 768, 100_000, 30


def _ce_flops(cfg, n, L) -> float:
    """bf16 operations of one cross-encoder forward over n pairs of L tokens:
    per layer the QKV, output and MLP products (2 L H (3H + H + 2 r H)) and
    attention's two products (4 L^2 H), times the layers and the pairs."""
    H, r = cfg.hidden, cfg.mlp_ratio
    return float(n) * cfg.n_layers * (2.0 * L * H * (4 * H + 2 * r * H) + 4.0 * L * L * H)


def _ce_bytes(ce, n, L) -> float:
    """Bytes a forward must move: every parameter but the token table once,
    the n x L gathered token rows, the ids and mask, the n scores."""
    params = sum(v.numel() * v.element_size() for k, v in ce.params.items() if k != "tok_emb")
    return params + n * L * ce.cfg.hidden * 4 + n * L * 5 + n * 4


def _hits_of(results):
    """SearchResults as (id, score) pairs for `_ranked_close`."""
    return [(r.node_id, r.score) for r in results]


def _sources_close(got, ref, conf, tol) -> dict:
    """Two ask() source lists, (id, score) each. The generator keeps a hit
    whose score reaches its confidence threshold, and lists the top hits
    when none does (confidence 0): a source on one side only must tie that
    threshold within tol (a threshold tie); the sources on both sides are
    held as `_ranked_close`. conf is the two sides' confidences."""
    from codegraph_tpu_torch.rag.generator import GenerationConfig

    floor = GenerationConfig().min_confidence_threshold
    g_ids, r_ids = {i for i, _ in got}, {i for i, _ in ref}
    if (conf[0] == 0.0) != (conf[1] == 0.0):
        # one side selected nothing: every source the other selected is a tie
        picked = got if conf[0] else ref
        one_sided = list(picked)
        got, ref = [], []
    else:
        one_sided = [x for x in got if x[0] not in r_ids] + [x for x in ref if x[0] not in g_ids]
        got, ref = [x for x in got if x[0] in r_ids], [x for x in ref if x[0] in g_ids]
    out = _ranked_close(got, ref, tol)
    out["threshold_ties"] = len(one_sided)
    out["mismatches_outside_ties"] += sum(abs(s - floor) > tol for _, s in one_sided)
    return out


def _phase10_cross_encoder(torch, mods, cg, cpu, cfg) -> dict:
    """semantic_code_search with reranker="cross_encoder" through make_server
    on the card: stage 1 re-embeds the candidates with the provider, stage 2
    scores them with the r3 cross-encoder; held to the golden file and to the
    same candidates reranked on the CPU."""
    import copy

    from codegraph_tpu_torch.mcp.server import make_server
    from codegraph_tpu_torch.models.bpe import BPETokenizer
    from codegraph_tpu_torch.models.cross_encoder import CrossEncoder
    from codegraph_tpu_torch.search.reranker import make_reranker_pipeline

    server = make_server(cg.indexer, cfg)
    pipe = server.tools.reranker
    ce = pipe.cross_encoder
    require(isinstance(ce, CrossEncoder) and ce.device.type == "cuda",
            f"phase 10: the served reranker has no cross-encoder on the card: {ce!r}")
    c = ce.cfg
    require((c.hidden, c.n_layers, c.n_heads, c.max_len, c.pooling) == (384, 4, 8, 256, "cls"),
            f"phase 10: the cross-encoder is {c}")
    require(isinstance(ce.tokenizer, BPETokenizer) and ce.tokenizer.vocab_size == 16644,
            f"phase 10: the cross-encoder's tokenizer is {type(ce.tokenizer).__name__}")
    require({v.device.type for v in ce.params.values()} == {"cuda"},
            "phase 10: cross-encoder parameters are not all on the card")
    require(type(pipe.stage1).__name__ == "EmbeddingReranker",
            f"phase 10: stage 1 is {type(pipe.stage1).__name__}")

    stage_ms = {"stage1": [], "stage2": []}
    stage1, stage2 = pipe.stage1.rerank, ce.rerank_batch

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            stage_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    pipe.stage1.rerank = timed("stage1", stage1)
    ce.rerank_batch = timed("stage2", stage2)
    misses0 = cg.indexer.search.cache.misses
    # a warm-up call (the process's first cross-encoder forward), then the
    # timed ones, each a new query at the stage-2 width of 20 pairs
    reset_launches(mods)
    _payload(server.handle_message(_call("semantic_code_search",
                                         {"query": "warm up the cross-encoder", "limit": 20}, 1)),
             "warm-up cross-encoder call")
    call_ms, replies = [], []
    for i, q in enumerate(CE_QUERIES):
        t0 = time.perf_counter()
        reply = server.handle_message(_call("semantic_code_search", {"query": q, "limit": 20},
                                            10 + i))
        call_ms.append((time.perf_counter() - t0) * 1e3)
        replies.append(_payload(reply, f"cross-encoder tools/call {i}"))
    launches = read_launches(mods)
    n_search = cg.indexer.search.cache.misses - misses0
    pipe.stage1.rerank, ce.rerank_batch = stage1, stage2
    require(all(r["count"] == 20 for r in replies), "phase 10: a rerank returned fewer than 20")

    # the same candidates reranked by the card's pipeline and by the CPU's
    cpu_pipe = make_reranker_pipeline(cpu.indexer.provider, cfg.search, device="cpu")
    cpu_ce = cpu_pipe.cross_encoder
    rerank_vs_cpu, served_vs_direct, tols = [], [], []
    for q, reply in zip(CE_QUERIES, replies):
        cands = cg.indexer.search.search_text(q, 20, filters=server.tools._auto_filters(q))
        card = pipe.rerank(q, copy.deepcopy(cands))
        served_vs_direct.append([r["node_id"] for r in reply["results"]]
                                == [r.node_id for r in card])
        stage1_out = pipe.stage1.rerank(q, copy.deepcopy(cands), 20)
        base = np.array([r.score for r in stage1_out])
        ce_s = ce.score_pairs(q, [f"{r.name} {r.snippet}" for r in stage1_out])
        # a min-max normalized blend: each side's gap over its span, times its weight
        tol = (0.7 * 3 * ENC_TOL / max(float(base.max() - base.min()), 1e-9)
               + 0.3 * 3 * CE_TOL / max(float(ce_s.max() - ce_s.min()), 1e-9))
        tols.append(tol)
        rerank_vs_cpu.append(_ranked_close(_hits_of(card),
                                           _hits_of(cpu_pipe.rerank(q, copy.deepcopy(cands))), tol))

    gold = np.load(CE_GOLDEN)
    framed = [ce._encode_pairs(str(q), [str(d)]) for q, d in zip(gold["queries"], gold["docs"])]
    framing_equal = all(np.array_equal(f[0][0], gold["ids"][r]) and
                        np.array_equal(f[1][0], gold["mask"][r]) for r, f in enumerate(framed))
    card_cls = ce.cls_vectors(gold["ids"], gold["mask"]).cpu().numpy()
    card_scores = ce.score_framed(gold["ids"], gold["mask"]).cpu().numpy()
    cpu_cls = cpu_ce.cls_vectors(gold["ids"], gold["mask"]).numpy()
    cpu_scores = cpu_ce.score_framed(gold["ids"], gold["mask"]).numpy()
    ce_errs = {
        "cls_vs_jax_golden": float(np.abs(card_cls - gold["cls"]).max()),
        "cls_mean_vs_jax_golden": float(np.abs(card_cls - gold["cls"]).mean()),
        "scores_vs_jax_golden": float(np.abs(card_scores - gold["scores"]).max()),
        "cls_vs_cpu_path": float(np.abs(card_cls - cpu_cls).max()),
        "cls_mean_vs_cpu_path": float(np.abs(card_cls - cpu_cls).mean()),
        "scores_vs_cpu_path": float(np.abs(card_scores - cpu_scores).max()),
        "cpu_scores_vs_jax_golden": float(np.abs(cpu_scores - gold["scores"]).max()),
        "pairs": int(gold["ids"].shape[0]),
    }

    forward = {}
    g = torch.Generator(device="cuda").manual_seed(10)
    for n in (20, 1):
        L = c.max_len
        ids = torch.randint(0, c.vocab_size, (n, L), generator=g, device="cuda")
        mask = torch.ones((n, L), dtype=torch.bool, device="cuda")
        ms = _time_ms(torch, lambda _: ce.score_framed(ids, mask), [None] * 20)
        bound, bound_by = _bound(_ce_bytes(ce, n, L), _ce_flops(c, n, L), "bfloat16")
        forward[f"{n}x{L}"] = {"ms": ms, "gflop": _ce_flops(c, n, L) / 1e9, "bound_ms": bound,
                               "bound_by": bound_by, "share_of_bound": bound / ms}
    total = {k: max((r[k] for r in rerank_vs_cpu), default=0) if k == "max_abs_err" else
             sum(r[k] for r in rerank_vs_cpu) for k in rerank_vs_cpu[0]}
    out = {"checkpoint": os.path.basename(_shipped_ce_checkpoint()),
           "tools_call_ms": {"median": statistics.median(call_ms), "each": call_ms},
           "stage1_ms": {"median": statistics.median(stage_ms["stage1"][1:]),
                         "each": stage_ms["stage1"][1:]},
           "stage2_ms": {"median": statistics.median(stage_ms["stage2"][1:]),
                         "each": stage_ms["stage2"][1:]},
           "forward": forward, "max_abs_err": ce_errs, "golden_framing_equal": framing_equal,
           "rerank_vs_cpu_same_candidates": total, "blend_tol_max": max(tols),
           "served_equals_direct": served_vs_direct,
           "launches": launches, "uncached_searches": n_search}
    require(framing_equal, "phase 10: the cross-encoder frames pairs unlike the JAX package")
    require(all(ce_errs[k] <= CE_TOL for k in ce_errs if not k.startswith("cls_mean") and k != "pairs")
            and ce_errs["cls_mean_vs_jax_golden"] <= CE_MEAN_TOL
            and ce_errs["cls_mean_vs_cpu_path"] <= CE_MEAN_TOL,
            f"phase 10: the cross-encoder is off its references: {ce_errs}")
    require(total["mismatches_outside_ties"] == 0,
            f"phase 10: the card's rerank differs from the CPU's: {total}")
    require(all(served_vs_direct), "phase 10: the served rerank differs from the pipeline's")
    require(launches["K1"] >= n_search >= len(CE_QUERIES) + 1,
            f"phase 10: {launches['K1']} K1 launches for {n_search} uncached rerank searches")
    require(all(v == 0 for k_, v in launches.items() if k_ != "K1"),
            f"phase 10: the rerank path launched another kernel: {launches}")
    return out


def _shipped_ce_checkpoint():
    from codegraph_tpu_torch.models.cross_encoder import default_cross_encoder_checkpoint

    path = default_cross_encoder_checkpoint()
    require(path is not None and os.path.basename(path) == CE_CKPT,
            f"phase 10: the shipped cross-encoder checkpoint is {path!r}")
    return path


def _phase10_ask(torch, mods, cg, cpu, cfg) -> dict:
    """CodeGraph.ask without an LLM and with the scripted one on localhost,
    and CodeGraph.insights, on the card, held to the CPU snapshot."""
    import copy

    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.rag.generator import GenerationConfig

    conf_floor = GenerationConfig().min_confidence_threshold
    fake = None
    try:
        fake, fake_url, fake_seen = _fake_llm()
        lcfg = copy.deepcopy(cfg)
        lcfg.llm.provider, lcfg.llm.base_url, lcfg.llm.model = "openai_compatible", fake_url, "scripted"
        llm_card = CodeGraph(lcfg, device="cuda")
        llm_cpu = CodeGraph(lcfg, device="cpu")
        runs = {}

        def capture(graph):
            """ask() builds its RAGSystem on first use; keep each RAGAnswer."""
            answers = []
            rag = graph._rag
            inner = rag.process_query

            def wrapped(q):
                a = inner(q)
                answers.append(a)
                return a
            rag.process_query = wrapped
            return answers

        misses0 = cg.indexer.search.cache.misses + llm_card.indexer.search.cache.misses
        reset_launches(mods)
        for name, graph in (("no_llm", cg), ("scripted_llm", llm_card)):
            graph.ask("warm up the RAG path")
            answers = capture(graph)
            t_each = []
            replies = []
            for q in ASK_QUESTIONS:
                t0 = time.perf_counter()
                replies.append(graph.ask(q))
                t_each.append((time.perf_counter() - t0) * 1e3)
            runs[name] = {"replies": replies, "answers": answers, "ms": t_each}
        t0 = time.perf_counter()
        insights = [cg.insights(t) for t in INSIGHT_TOPICS]
        t_insights = (time.perf_counter() - t0) * 1e3 / len(INSIGHT_TOPICS)
        launches = read_launches(mods)
        n_search = (cg.indexer.search.cache.misses + llm_card.indexer.search.cache.misses
                    - misses0)

        checks = {}
        card_of = {"no_llm": cg, "scripted_llm": llm_card}
        for name, graph in (("no_llm", cpu), ("scripted_llm", llm_cpu)):
            graph.ask("warm up the RAG path")
            answers = capture(graph)
            searched = _log_searches(graph.indexer.search)
            mine = runs[name]
            rows = []
            for q, reply, ans in zip(ASK_QUESTIONS, mine["replies"], mine["answers"]):
                searched.clear()
                ref = graph.ask(q)
                ref_ans = answers[-1]
                both_fresh = not ans.degraded and not ref_ans.degraded
                conf = [ans.response.confidence, ref_ans.response.confidence]
                # sources' scores are rounded to four places: 1e-4 more
                tol = ENC_TOL + 1e-4
                sources = _sources_close(
                    [(x["node_id"], x["score"]) for x in reply["sources"]],
                    [(x["node_id"], x["score"]) for x in ref["sources"]], conf, tol)
                # the retrieval's searches, as the CPU side asked them
                verdicts = {_cut_tie((card_of[name].indexer.search, graph.indexer.search),
                                     sq, lim, (flt, flt)) for sq, lim, flt in searched
                            } if sources["mismatches_outside_ties"] else set()
                sources["cut_ties"] = int("tie" in verdicts and "differ" not in verdicts)
                if sources["cut_ties"]:
                    sources["mismatches_outside_ties"] = 0
                # the answer is a function of the sources in their order and of
                # the confidence against its threshold: compared where both agree
                same_inputs = ([x["node_id"] for x in reply["sources"]]
                               == [x["node_id"] for x in ref["sources"]]
                               and not min(conf) < conf_floor <= max(conf))
                rows.append({
                    "sources": sources,
                    "confidence": conf,
                    "query_type_equal": reply["query_type"] == ref["query_type"],
                    "degraded": [ans.degraded, ref_ans.degraded],
                    "used_llm": [ans.response.used_llm, ref_ans.response.used_llm],
                    "answer_equal": ((reply["answer"] == ref["answer"])
                                     if both_fresh and same_inputs else None),
                    "answer_is_llm": reply["answer"] == FAKE_ASK_ANSWER})
            checks[name] = rows
        insights_cpu = [cpu.insights(t) for t in INSIGHT_TOPICS]
        insight_rows = []
        for topic, got, ref in zip(INSIGHT_TOPICS, insights, insights_cpu):
            # the relevant-code insight lists the top hits: a swap is a tie of
            # the two hits' scores; the rest follows from the top hit
            hits = _unless_cut_tie(_hits_vs(cg.search(topic, 5), cpu.search(topic, 5), ENC_TOL),
                                   (cg.indexer.search, cpu.indexer.search), topic, 5)
            same_top = cg.search(topic, 5)[0].node_id == cpu.search(topic, 5)[0].node_id
            kinds_equal = [i["kind"] for i in got] == [i["kind"] for i in ref] or not same_top
            rest_equal = (not same_top) or [i for i in got if i["kind"] != "relevant_code"] == \
                [i for i in ref if i["kind"] != "relevant_code"]
            insight_rows.append({"equal": got == ref, "kinds": [i["kind"] for i in got],
                                 "hits_vs_cpu": hits, "same_top": same_top,
                                 "kinds_equal": kinds_equal, "rest_equal": rest_equal})

        def stages(name):
            return {k: statistics.median(a.stage_ms[k] for a in runs[name]["answers"])
                    for k in runs[name]["answers"][0].stage_ms}

        out = {"ask_ms": {n: {"median": statistics.median(r["ms"]), "each": r["ms"]}
                          for n, r in runs.items()},
               "ask_stage_ms": {n: stages(n) for n in runs},
               "insights_ms": t_insights, "ask_vs_cpu": checks, "insights_vs_cpu": insight_rows,
               "fake_llm_requests": len(fake_seen), "launches": launches,
               "uncached_searches": n_search}
        for name, rows in checks.items():
            for r in rows:
                require(r["sources"]["mismatches_outside_ties"] == 0 and r["query_type_equal"],
                        f"phase 10: ask ({name}) differs from the CPU snapshot: {r}")
                require(r["answer_equal"] in (True, None),
                        f"phase 10: ask ({name}) answers differ from the CPU's: {r}")
                require(not r["degraded"][0], f"phase 10: a warm ask on the card degraded: {r}")
        require(any(r["answer_is_llm"] for r in checks["scripted_llm"])
                and all(not r["answer_is_llm"] for r in checks["no_llm"]),
                f"phase 10: the scripted LLM did not answer an ask: {checks}")
        require(all(r["hits_vs_cpu"]["mismatches_outside_ties"] == 0 and r["kinds_equal"]
                    and r["rest_equal"] and r["kinds"] for r in insight_rows),
                f"phase 10: insights differ from the CPU snapshot: {insight_rows}")
        require(launches["K1"] >= n_search > 0,
                f"phase 10: {launches['K1']} K1 launches for {n_search} uncached ask searches")
        require(all(v == 0 for k_, v in launches.items() if k_ != "K1"),
                f"phase 10: ask/insights launched another kernel: {launches}")
        return out
    finally:
        if fake is not None:
            fake.shutdown()
            fake.server_close()


def _phase10_router(torch, mods, cg, tmp, proj) -> dict:
    """An IndexRouter over two backends of different widths of one project:
    the default (ensemble + hash, 768) and the hash provider at 256."""
    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.mcp.tools import GraphToolExecutor
    from codegraph_tpu_torch.search.router import IndexRouter, RoutingError

    hcfg = _hash_config(tmp, "data_hash256")
    hcfg.embedding.dimension = 256
    hcfg.embedding.fallbacks = []
    narrow = CodeGraph.open(proj, config=hcfg, device="cuda")
    narrow.index()
    backends = {"default": cg, "hash256": narrow}
    router = IndexRouter()
    for name, graph in backends.items():
        router.register(name, graph.indexer.provider, graph.indexer.search,
                        default=(name == "default"))
    tools = GraphToolExecutor(cg.graph, cg.indexer.search, router=router)
    require(router.dimensions() == {"default": 768, "hash256": 256},
            f"phase 10: router widths {router.dimensions()}")
    routes = {}
    for i, name in enumerate(backends):
        q = f"routed query {i} about graph edges"
        misses = {n: g.indexer.search.cache.misses for n, g in backends.items()}
        reset_launches(mods)
        got = tools.execute("semantic_code_search", {"query": q, "limit": 10, "model": name})
        launches = read_launches(mods)
        hit = {n: g.indexer.search.cache.misses - misses[n] for n, g in backends.items()}
        graph = backends[name]
        own = GraphToolExecutor(graph.graph, graph.indexer.search).execute(
            "semantic_code_search", {"query": q, "limit": 10})
        routes[f"tool:{name}"] = {"launches": launches, "searched": hit,
                                  "vs_own": _tool_close(got, own, SCORE_TOL)}
    rng = np.random.default_rng(10)
    for dim, name in ((768, "default"), (256, "hash256")):
        v = rng.standard_normal(dim).astype(np.float32)
        reset_launches(mods)
        s, r = router.search_vector(v, 10)
        launches = read_launches(mods)
        s_own, r_own = backends[name].indexer.index.search(v[None, :], 10)
        routes[f"vector:{dim}"] = {"launches": launches, "backend": router.resolve(dimension=dim),
                                   "equal": bool(np.array_equal(r, r_own)
                                                 and np.array_equal(s, s_own))}
    unknown = tools.execute("semantic_code_search", {"query": "x", "model": "nope"})
    try:
        router.resolve(model="nope")
        raised = False
    except RoutingError:
        raised = True
    out = {"backends": router.stats(), "routes": routes, "unknown_model_raises": raised,
           "unknown_model_tool_error": unknown.get("error", "")[:80],
           "launches": {k: sum(r["launches"][k] for r in routes.values()) for k in KERNELS}}
    for name in backends:
        r = routes[f"tool:{name}"]
        require(r["searched"][name] == 1 and sum(r["searched"].values()) == 1,
                f"phase 10: the model {name!r} did not land on its own backend: {r}")
        require(r["launches"]["K1"] >= 1 and r["vs_own"]["mismatches_outside_ties"] == 0,
                f"phase 10: the route to {name!r} differs from the backend's own search: {r}")
    for dim, name in ((768, "default"), (256, "hash256")):
        r = routes[f"vector:{dim}"]
        require(r["backend"] == name and r["equal"] and r["launches"]["K1"] == 1,
                f"phase 10: a {dim}-wide vector did not land on {name!r}: {r}")
    require(raised and unknown.get("error", "").startswith("RoutingError"),
            "phase 10: an unknown model did not raise RoutingError")
    return out


def _phase10_segments(torch, mods) -> dict:
    """SegmentedIndex at 1M x 768 f32 fed through WriterHandle in jobs of the
    default seal threshold (100,000 rows: ten segments), 1% deleted, searched
    at B=1 and 64 before and after one compact(), against one FlatIndex over
    the same rows on the card."""
    from codegraph_tpu_torch.core.types import CodeChunk
    from codegraph_tpu_torch.graph.store import GraphStore
    from codegraph_tpu_torch.index import FlatIndex, SegmentedIndex
    from codegraph_tpu_torch.indexer.writer import WriterHandle

    dev = torch.device("cuda")
    seg = SegmentedIndex(SEG_D, device="cuda")
    require(seg.seal_threshold == SEG_JOB, f"phase 10: seal_threshold {seg.seal_threshold}")
    flat = FlatIndex(SEG_D, device="cuda")
    flat.reserve(SEG_N)
    store = GraphStore()
    g = torch.Generator(device=dev).manual_seed(2026)
    t0 = time.perf_counter()
    writer = WriterHandle(store, seg)
    for j in range(SEG_N // SEG_JOB):
        x = torch.randn(SEG_JOB, SEG_D, generator=g, device=dev)
        chunks = [CodeChunk.make(f"segment-node-{j}", f"row {j * SEG_JOB + i}", i, SEG_JOB)
                  for i in range(SEG_JOB)]
        writer.enqueue_chunk_embeddings(chunks, x)
        flat.add(x)
    errors = writer.flush()
    writer.close()
    torch.cuda.synchronize()
    t_feed = time.perf_counter() - t0
    stride = SegmentedIndex.SEGMENT_STRIDE

    def global_rows(r):
        r = np.asarray(r, np.int64)
        return np.where(r >= 0, (r // SEG_JOB) * stride + r % SEG_JOB, -1)

    dead = torch.randperm(SEG_N, generator=g, device=dev)[: SEG_N // 100].cpu().numpy()
    seg.delete(global_rows(dead))
    flat.delete(dead)
    x_flat, bias_flat = flat.arrays()

    def search_and_check(tag, to_flat_rows):
        """B=1 (K1) and B=64 (K2): the segmented index's global rows, mapped
        back to the flat index's rows, held to the flat index's top-k."""
        rows = []
        for B in (1, 64):
            q = torch.randn(B, SEG_D, generator=g, device=dev)
            q_host = q.cpu().numpy()
            reset_launches(mods)
            t1 = time.perf_counter()
            s_g, i_g = seg.search(q_host, SEG_K)
            ms = (time.perf_counter() - t1) * 1e3
            launches = read_launches(mods)
            s_f, i_f = flat.search(q, SEG_K)
            qn = torch.nn.functional.normalize(q.float(), dim=1)
            err, n_diff, bad = check_topk(
                torch, qn, x_flat, bias_flat, torch.as_tensor(s_g, device=dev),
                torch.as_tensor(to_flat_rows(i_g), device=dev).int(),
                torch.as_tensor(s_f, device=dev), torch.as_tensor(i_f, device=dev).int())
            rows.append({"when": tag, "B": B, "k": SEG_K, "ms": ms, "launches": launches,
                         "segments_searched": sum(len(s) > 0 for s in seg._segments),
                         "max_abs_err": err, "id_mismatches": n_diff,
                         "mismatches_outside_ties": bad})
        return rows

    def flat_of_global(gl):
        gl = np.asarray(gl, np.int64)
        return np.where(gl >= 0, (gl // stride) * SEG_JOB + gl % stride, -1)

    searches = search_and_check("ten segments", flat_of_global)
    sealed_before = sum(s.sealed for s in seg.stats())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    remap = seg.compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    # the merged segment's rows (segment 0 after compaction) -> flat rows
    old = np.fromiter(remap.keys(), np.int64, len(remap))
    new = np.fromiter(remap.values(), np.int64, len(remap))
    flat_of_merged = np.full(len(remap), -1, np.int64)
    flat_of_merged[new] = flat_of_global(old)

    def flat_of_compacted(r):
        r = np.asarray(r, np.int64)
        require(bool((r < stride).all()), "phase 10: a hit outside the merged segment")
        return np.where(r >= 0, flat_of_merged[np.maximum(r, 0)], -1)

    searches += search_and_check("after compact", flat_of_compacted)
    out = {"rows": SEG_N, "dim": SEG_D, "seal_threshold": seg.seal_threshold,
           "feed_seconds": t_feed, "compact_seconds": t_compact,
           "writer_errors": len(errors), "writer_errors_all_row_drift":
               all("row drift" in e for e in errors),
           "store_chunks": store.stats()["chunks"], "sealed_before_compact": sealed_before,
           "segments_after_compact": [(s.rows, s.live, s.sealed) for s in seg.stats()],
           "remap_rows": len(remap), "searches": searches,
           "launches": {k: sum(r["launches"][k] for r in searches) for k in KERNELS}}
    require(len(errors) == SEG_N // SEG_JOB - 1 and out["writer_errors_all_row_drift"],
            f"phase 10: the writer reported {errors[:2]}... ({len(errors)}); expected the "
            "reference's row drift on every job after the first segment")
    require(sealed_before == SEG_N // SEG_JOB and len(seg) == SEG_N - SEG_N // 100
            and store.stats()["chunks"] == SEG_N and len(remap) == SEG_N - SEG_N // 100,
            f"phase 10: segment bookkeeping {out['segments_after_compact']}")
    for r in searches:
        kernel = "K1" if r["B"] < 32 else "K2"
        require(r["launches"][kernel] == r["segments_searched"]
                and all(v == 0 for k_, v in r["launches"].items() if k_ != kernel),
                f"phase 10: segmented search launches {r}")
        require(r["mismatches_outside_ties"] == 0 and r["max_abs_err"] <= SCORE_TOL,
                f"phase 10: SegmentedIndex differs from FlatIndex: {r}")
    require([r["segments_searched"] for r in searches] == [10, 10, 1, 1],
            f"phase 10: segments searched {[r['segments_searched'] for r in searches]}")
    del seg, flat, x_flat, bias_flat
    torch.cuda.empty_cache()
    return out


def phase10(torch, mods, errs) -> dict:
    """The rest of the serving surface on the card: the cross-encoder
    reranker through make_server, CodeGraph.ask/insights, an IndexRouter
    over two backends, and SegmentedIndex at 1M x 768 against FlatIndex."""
    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.core.config import CodeGraphConfig

    require(os.path.exists(CE_GOLDEN), f"no golden cross-encoder scores at {CE_GOLDEN}")
    _shipped_ce_checkpoint()
    tmp = tempfile.mkdtemp(prefix="cg_smoke_serving_")
    try:
        proj = _project_copy(tmp)
        cfg = CodeGraphConfig()
        cfg.data_dir = os.path.join(tmp, "data")
        cfg.search.reranker = "cross_encoder"
        require(cfg.search.rerank, "phase 10: rerank is off by default")
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        stats = cg.index()
        t_index = time.perf_counter() - t0
        cpu = CodeGraph(cfg, device="cpu")
        require(len(cpu.indexer.index) == len(cg.indexer.index) == stats.chunks > 0,
                "phase 10: CPU snapshot load")
        parts = {}
        for name, fn, args in (("cross_encoder", _phase10_cross_encoder, (cg, cpu, cfg)),
                               ("ask", _phase10_ask, (cg, cpu, cfg)),
                               ("router", _phase10_router, (cg, tmp, proj)),
                               ("segments", _phase10_segments, ())):
            t1 = time.perf_counter()
            parts[name] = fn(torch, mods, *args)
            parts[name]["seconds"] = round(time.perf_counter() - t1, 3)
        out = {"phase": 10, "gpu": nvidia_smi_line(), "chunks": stats.chunks,
               "index_seconds": round(t_index, 3), **parts,
               "launches": {k: sum(p["launches"][k] for p in parts.values()) for k in KERNELS}}
        emit(out)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: training at full width
# ---------------------------------------------------------------------------

# the r3 trainer's settings (benchmarks/train_encoder_r3.py): B=256 pairs of
# L=192 tokens, remat, lr 5e-4 const; 20 steps over 8 fixed batches
TRAIN_B, TRAIN_STEPS, TRAIN_BATCHES, TRAIN_LR = 256, 20, 8, 5e-4
# the cross-encoder trainer's (benchmarks/train_cross_encoder_r3.py): 48
# queries x 8 candidates, listwise
CE_TRAIN_QUERIES, CE_TRAIN_GROUP, CE_TRAIN_STEPS = 48, 8, 10
# card against the CPU path at bf16, as tests/test_torch_training.py states
# the port against JAX: loss and grad_norm within one bf16 step of their
# value, each gradient within 2e-2 (relative L2), each parameter within
# 2.5 lr of the step's
TRAIN_GRAD_REL = 2e-2
TRAIN_PARAM_LR = 2.5


def _doc_code_pairs() -> list:
    """(docstring, source) of every documented function and class of the
    repo's codegraph_tpu/ sources (read as text with ast), in file order."""
    import ast

    src = os.path.join(ROOT, "codegraph_tpu")
    require(os.path.isdir(src), f"no JAX package source at {src} to train on")
    pairs = []
    for d, dirs, files in os.walk(src):
        dirs.sort()
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            text = open(os.path.join(d, f), encoding="utf-8").read()
            for node in ast.walk(ast.parse(text)):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    doc = ast.get_docstring(node)
                    if doc and len(doc) >= 16:
                        pairs.append((doc, ast.get_source_segment(text, node)))
    return pairs


def _bf16_step(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def _raw_grads(torch, opt_state, grad_norm, clip):
    """One step's raw gradients from the first moments it left (mu = 0.1 g'
    after one step from zero, g' = g * min(1, clip / |g|))."""
    scale = max(1.0, float(grad_norm) / clip) / 0.1
    return {k: v.float() * scale for k, v in opt_state["mu"].items()}


def _step_gaps(torch, card, cpu, lr) -> dict:
    """Card against CPU after one step from the same state: metric gaps,
    the worst gradient's relative L2 and the worst parameter gap in lr."""
    (p_c, s_c, m_c), (p_h, s_h, m_h) = card, cpu
    gaps = {k: abs(float(m_c[k]) - float(m_h[k])) for k in m_c}
    out = {"loss": float(m_c["loss"]), "loss_cpu": float(m_h["loss"]), "gaps": gaps,
           "param_gap_lr": max(float((p_c[k].cpu() - p_h[k]).abs().max()) for k in p_h) / lr}
    require(gaps["loss"] <= _bf16_step(float(m_h["loss"])), f"phase 11: loss gap {gaps}")
    require(out["param_gap_lr"] <= TRAIN_PARAM_LR, f"phase 11: parameters {out['param_gap_lr']} lr apart")
    if "grad_norm" in m_c:  # the encoder's step reports it (the cross-encoder's does not)
        require(gaps["grad_norm"] <= _bf16_step(float(m_h["grad_norm"])), f"phase 11: grad_norm {gaps}")
        g_c = _raw_grads(torch, s_c, m_c["grad_norm"], 1.0)
        g_h = _raw_grads(torch, s_h, m_h["grad_norm"], 1.0)
        rel = {k: float((g_c[k].cpu() - g_h[k]).norm() / g_h[k].norm().clamp(min=1e-30))
               for k in g_h}
        worst = max(rel, key=rel.get)
        out["grad_rel_l2_max"], out["grad_rel_l2_worst"] = rel[worst], worst
        require(rel[worst] <= TRAIN_GRAD_REL, f"phase 11: gradient of {worst} {rel[worst]} apart")
    return out


def _train_flops(cfg, B, L) -> float:
    """One InfoNCE step's matmul operations (forward and backward, anchors
    and positives): 6 per weight per token over 12 H^2 weights a layer, and
    attention's 12 L H per token a layer. Remat's second forward is not
    counted: the bound is the work the step needs."""
    H, n = cfg.hidden, cfg.n_layers
    tokens = 2 * B * L
    return tokens * n * (6 * 12 * H * H + 12 * L * H)


def _event_ms(torch, fn, reps):
    """[ms] of fn() reps times, each between two CUDA events; results kept."""
    outs, events = [], []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        outs.append(fn())
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events], outs


def _profile_step(torch, fn) -> dict:
    """Device time of one fn() by kind of kernel (torch.profiler): the
    tensor-core and f32 products (cuBLAS's gemm and nvjet kernels) and the
    rest, the eight costliest kernels, and the device's idle share of the
    wall time under the profiler; None where the trace shows no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    if busy <= 0:
        return None
    gemm = sum(v for k_, v in kernels.items()
               if any(w in k_.lower() for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy, "gemm_ms": gemm, "other_ms": busy - gemm,
            "idle_share": max(0.0, 1.0 - busy / wall_ms), "kernels": len(kernels),
            "top": [[k_[:80], v] for k_, v in top]}


def _phase11_encoder(torch, tt, pairs, tmp) -> dict:
    import dataclasses

    from codegraph_tpu_torch.ml.pipeline import MLLifecycle
    from codegraph_tpu_torch.models.encoder import encode
    from codegraph_tpu_torch.models.providers import EncoderProvider, save_encoder_checkpoint

    ckpt = os.path.join(ROOT, "checkpoints", ENCODER_CKPT)
    base = EncoderProvider(checkpoint=ckpt, device="cuda")
    cfg, tok = dataclasses.replace(base.cfg, remat=True), base.tokenizer
    L = cfg.max_len
    require((cfg.hidden, cfg.n_layers, cfg.n_heads, L) == (512, 6, 16, 192),
            f"phase 11: the r3 encoder is {cfg}")
    master = {k: v.float() for k, v in base.params.items()}  # f32 master weights
    del base
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(TRAIN_BATCHES):
        pick = rng.choice(len(pairs), TRAIN_B, replace=False)
        a_ids, a_mask = tok.encode_batch([pairs[i][0] for i in pick], max_len=L)
        p_ids, p_mask = tok.encode_batch([pairs[i][1] for i in pick], max_len=L)
        batches.append({k: torch.from_numpy(v).cuda() for k, v in
                        (("anchor_ids", a_ids), ("anchor_mask", a_mask),
                         ("positive_ids", p_ids), ("positive_mask", p_mask))})
    tcfg = tt.TrainConfig(learning_rate=TRAIN_LR, temperature=0.05)
    opt = tt.make_optimizer(tcfg)

    # 1. one step at B=8 on the card and on the CPU path, same state and batch
    small = {k: v[:8] for k, v in batches[0].items()}
    card = tt.train_step(master, opt.init(master), small, cfg, tcfg, opt)
    cpu_params = {k: v.cpu() for k, v in master.items()}
    t0 = time.perf_counter()
    cpu = tt.train_step(cpu_params, opt.init(cpu_params), {k: v.cpu() for k, v in small.items()},
                        cfg, tcfg, opt)
    one_step = {"B": 8, "cpu_seconds": round(time.perf_counter() - t0, 3),
                **_step_gaps(torch, card, cpu, TRAIN_LR)}
    del card, cpu, cpu_params

    # 2. + 4. the r3 trainer's settings through MLLifecycle.train_model
    life = MLLifecycle(device="cuda")
    run = {}

    def train_fn():
        params, state = master, opt.init(master)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics = []

        def one(i):
            nonlocal params, state
            params, state, m = tt.train_step(params, state, batches[i % TRAIN_BATCHES], cfg,
                                              tcfg, opt)
            return m

        it = iter(range(TRAIN_STEPS))
        ms, metrics = _event_ms(torch, lambda: one(next(it)), TRAIN_STEPS)
        run.update(ms=ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   losses=[float(m["loss"]) for m in metrics],
                   accuracy=[float(m["accuracy"]) for m in metrics],
                   params=params, state=state)
        path = os.path.join(tmp, "encoder_retrained.npz")
        save_encoder_checkpoint(path, params, cfg=cfg,
                                tokenizer_file=os.path.join(ROOT, "checkpoints", "bpe_code_16k.json"))
        # the tokenizer resolves next to the checkpoint
        shutil.copy(os.path.join(ROOT, "checkpoints", "bpe_code_16k.json"), tmp)
        return path

    life.train_model("r3-retrained", train_fn)
    losses = run["losses"]
    require(all(math.isfinite(x) for x in losses), f"phase 11: a loss is not finite: {losses}")
    first, last = sum(losses[:4]) / 4, sum(losses[-4:]) / 4
    require(last < first, f"phase 11: the loss did not fall ({first} -> {last})")
    step_ms = statistics.median(run["ms"])
    flops = _train_flops(cfg, TRAIN_B, L)
    bound_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    live = sum(int(b["anchor_mask"].sum() + b["positive_mask"].sum()) for b in batches) / TRAIN_BATCHES

    # peak memory of one step without remat (from the trained state)
    plain_cfg = dataclasses.replace(cfg, remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_plain, _ = _event_ms(torch, lambda: tt.train_step(run["params"], run["state"], batches[0],
                                                        plain_cfg, tcfg, opt), 2)
    peak_plain = torch.cuda.max_memory_allocated() / 1e9

    # where one step's time goes on the card
    profile = _profile_step(torch, lambda: tt.train_step(run["params"], run["state"], batches[0],
                                                         cfg, tcfg, opt))

    # save/restore: the next step is bit-equal to the uninterrupted one
    state_path = os.path.join(tmp, "train_state.pt")
    tt.save_train_state(state_path, run["params"], run["state"], TRAIN_STEPS)
    p_ref, s_ref, m_ref = tt.train_step(run["params"], run["state"], batches[0], cfg, tcfg, opt)
    p_got, s_got, n_got = tt.restore_train_state(state_path, template=run["params"])
    p_got, s_got, m_got = tt.train_step(p_got, s_got, batches[0], cfg, tcfg, opt)
    bit_equal = (n_got == TRAIN_STEPS and all(torch.equal(p_got[k], p_ref[k]) for k in p_ref)
                 and all(torch.equal(s_got["nu"][k], s_ref["nu"][k]) for k in p_ref)
                 and all(torch.equal(m_got[k], m_ref[k]) for k in m_ref))
    require(bit_equal, "phase 11: the restored train state does not continue bit-equal")

    # the registered provider embeds with the trained weights
    prov = life.models["r3-retrained"]
    require(isinstance(prov, EncoderProvider) and prov.device.type == "cuda"
            and prov.tokenizer.vocab_size == tok.vocab_size,
            "phase 11: train_model did not register the retrained encoder on the card")
    texts = [d for d, _ in pairs[:32]]
    got = torch.from_numpy(prov.embed_texts(texts))
    want = torch.zeros_like(got)
    with torch.inference_mode():
        for sel, ids, mask in prov._batches(texts):
            want[sel] = encode(run["params"], torch.from_numpy(ids).cuda(),
                               torch.from_numpy(mask).cuda(), cfg).cpu()
    provider_err = float((got - want).abs().max())
    require(provider_err <= ENC_TOL, f"phase 11: the registered provider is {provider_err} off")
    return {"config": {"hidden": cfg.hidden, "layers": cfg.n_layers, "heads": cfg.n_heads,
                       "L": L, "vocab": cfg.vocab_size, "B": TRAIN_B, "lr": TRAIN_LR,
                       "remat": True, "pairs": len(pairs), "batches": TRAIN_BATCHES},
            "one_step_card_vs_cpu": one_step,
            "step_ms_median": step_ms, "step_ms": run["ms"],
            "pairs_per_s": TRAIN_B / step_ms * 1e3,
            "tokens_per_s": 2 * TRAIN_B * L / step_ms * 1e3,
            "live_tokens_per_s": live / step_ms * 1e3,
            "tflop_per_step": flops / 1e12, "bound_ms": bound_ms, "bound_by": "operations",
            "share_of_bound": bound_ms / step_ms,
            "profile": profile,
            "peak_gb_remat": run["peak_gb"], "peak_gb_no_remat": peak_plain,
            "step_ms_no_remat": statistics.median(ms_plain),
            "losses": losses, "accuracy": run["accuracy"],
            "loss_first4": first, "loss_last4": last, "restore_bit_equal": bit_equal,
            "provider_max_abs_err": provider_err}


def _ce_batch(torch, ce, pairs, first, n_queries, rng):
    """n_queries groups of CE_TRAIN_GROUP candidates: a docstring against its own
    code (first, label 1) and CE_TRAIN_GROUP - 1 others."""
    ids, mask, labels = [], [], []
    for qi in range(first, first + n_queries):
        others = [j for j in rng.choice(len(pairs), CE_TRAIN_GROUP + 2, replace=False) if j != qi]
        docs = [pairs[qi][1]] + [pairs[j][1] for j in others[:CE_TRAIN_GROUP - 1]]
        i, m = ce._encode_pairs(pairs[qi][0], docs)
        ids.append(i)
        mask.append(m)
        labels.append(np.eye(1, CE_TRAIN_GROUP, 0, dtype=np.int32)[0])
    return {"pair_ids": torch.from_numpy(np.concatenate(ids)).cuda(),
            "pair_mask": torch.from_numpy(np.concatenate(mask)).cuda(),
            "labels": torch.from_numpy(np.concatenate(labels)).cuda()}


def _phase11_cross_encoder(torch, tt, pairs) -> dict:
    from codegraph_tpu_torch.models.cross_encoder import CrossEncoder

    ce = CrossEncoder(checkpoint=_shipped_ce_checkpoint(), device="cuda")
    cfg = ce.cfg
    require((cfg.hidden, cfg.n_layers, cfg.n_heads, cfg.max_len) == (384, 4, 8, 256),
            f"phase 11: the r3 cross-encoder is {cfg}")
    params = {k: v.float() for k, v in ce.params.items()}
    head = {k: v.float() for k, v in ce.head.items()}
    tcfg = tt.TrainConfig(learning_rate=TRAIN_LR, temperature=0.05)
    step, opt = tt.make_cross_encoder_train_step(cfg, tcfg, group_size=CE_TRAIN_GROUP)
    rng = np.random.default_rng(12)
    # one step at 2 x 8 on the card and on the CPU path
    small = _ce_batch(torch, ce, pairs, 0, 2, rng)
    state = ((params, head), opt.init((params, head)))
    (pc, sc), mc = step(state, small)
    cpu_ph = ({k: v.cpu() for k, v in params.items()}, {k: v.cpu() for k, v in head.items()})
    (ph, sh), mh = step((cpu_ph, opt.init(cpu_ph)), {k: v.cpu() for k, v in small.items()})
    one_step = _step_gaps(torch, ({**pc[0], **{"head." + k: v for k, v in pc[1].items()}}, sc, mc),
                          ({**ph[0], **{"head." + k: v for k, v in ph[1].items()}}, sh, mh),
                          TRAIN_LR)
    # 10 steps at 48 x 8 pairs of 256 tokens
    batch = _ce_batch(torch, ce, pairs, 2, CE_TRAIN_QUERIES, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []

    def one():
        nonlocal state
        state, m = step(state, batch)
        return m

    ms, metrics = _event_ms(torch, one, CE_TRAIN_STEPS)
    profile = _profile_step(torch, one)
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(x) for x in losses), f"phase 11: a cross-encoder loss is {losses}")
    n, L, H = CE_TRAIN_QUERIES * CE_TRAIN_GROUP, cfg.max_len, cfg.hidden
    flops = n * L * cfg.n_layers * (6 * 12 * H * H + 12 * L * H)
    step_ms = statistics.median(ms)
    bound_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"config": {"hidden": H, "layers": cfg.n_layers, "heads": cfg.n_heads, "L": L,
                       "queries": CE_TRAIN_QUERIES, "group": CE_TRAIN_GROUP},
            "one_step_card_vs_cpu": {"pairs": 2 * CE_TRAIN_GROUP, **one_step},
            "step_ms_median": step_ms, "step_ms": ms, "pairs_per_s": n / step_ms * 1e3,
            "tokens_per_s": n * L / step_ms * 1e3, "tflop_per_step": flops / 1e12,
            "bound_ms": bound_ms, "bound_by": "operations", "share_of_bound": bound_ms / step_ms,
            "profile": profile,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses,
            "accuracy": [float(m["accuracy"]) for m in metrics]}


def phase11(torch, mods, errs) -> dict:
    """Encoder and cross-encoder training on the card at full width."""
    from codegraph_tpu_torch.models import training as tt

    pairs = _doc_code_pairs()
    require(len(pairs) >= TRAIN_B + CE_TRAIN_QUERIES + 2, f"phase 11: {len(pairs)} pairs")
    tmp = tempfile.mkdtemp(prefix="cg_smoke_train_")
    try:
        reset_launches(mods)
        t0 = time.perf_counter()
        enc = _phase11_encoder(torch, tt, pairs, tmp)
        enc["seconds"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        ce = _phase11_cross_encoder(torch, tt, pairs)
        ce["seconds"] = round(time.perf_counter() - t0, 3)
        out = {"phase": 11, "gpu": nvidia_smi_line(), "encoder": enc, "cross_encoder": ce,
               "launches": read_launches(mods)}
        emit(out)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: the shared-memory hand-off at real size
# ---------------------------------------------------------------------------

SHM_N, SHM_D, SHM_K = 1_000_000, 768, 10
SHM_CHECK_EVERY = 1.0  # the attaching process polls the generation this often
SHM_POLL_SLACK = 0.1   # its loop's own sleep and one generation read


def _shm_dir(need: int) -> tuple:
    """A directory with `need` bytes free: TMPDIR, else the checkout's
    build directory (gitignored). -> (path, free bytes)."""
    for base in (tempfile.gettempdir(), os.path.join(ROOT, "codegraph_tpu_torch", "_build")):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free
        if free >= need:
            return tempfile.mkdtemp(prefix="cg_smoke_shm_", dir=base), free
    raise CheckFailed(f"phase 12: no directory with {need} bytes free for the segments")


def shm_child(seg_dir: str) -> int:
    """The attaching process of phase 12 (`chip_smoke.py --shm-child DIR`):
    JSON commands on stdin, one JSON reply a line on stdout. It attaches
    each segment through ShmServedIndex on its own CUDA context, searches
    queries from DIR and writes the results there, and reports its own
    kernels' launch counts."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from codegraph_tpu_torch.index import ivf, ivfpq
    from codegraph_tpu_torch.ops import quantize, topk
    from codegraph_tpu_torch.search.service import ShmServedIndex

    mods = {"topk": topk, "quantize": quantize, "ivfpq": ivfpq, "ivf": ivf}
    served = {}
    for line in sys.stdin:
        cmd = json.loads(line)
        op, name = cmd["op"], cmd.get("name")
        if op == "exit":
            break
        t0 = time.perf_counter()
        if op == "attach":
            served[name] = ShmServedIndex(cmd["path"], check_every=SHM_CHECK_EVERY, device="cuda")
            torch.cuda.synchronize()
            reply = {"attach_seconds": time.perf_counter() - t0, "n": len(served[name]),
                     "generation": served[name].generation}
        elif op == "search":
            q = np.load(os.path.join(seg_dir, cmd["queries"]))
            reset_launches(mods)
            s, i = served[name].search(q, cmd["k"])
            torch.cuda.synchronize()
            np.savez(os.path.join(seg_dir, cmd["out"]), s=s, i=i)
            reply = {"seconds": time.perf_counter() - t0, "launches": read_launches(mods)}
        elif op == "await_reload":
            reply = {"reloaded": False}
            while time.time() - cmd["published_at"] < cmd["timeout"]:
                t_call = time.time()
                if served[name].maybe_reload():
                    torch.cuda.synchronize()
                    reply = {"reloaded": True, "detected_after_s": t_call - cmd["published_at"],
                             "reload_seconds": time.time() - t_call, "n": len(served[name]),
                             "generation": served[name].generation}
                    break
                time.sleep(0.01)
        else:
            reply = {"error": f"unknown op {op!r}"}
        print(json.dumps(reply), flush=True)
    for s in served.values():
        s.close()
    return 0


def _shm_indexes(torch):
    """The three published indexes at 1M x 768, made on the card from seeded
    generators, 1% tombstoned; and the rows that the republish deletes."""
    from codegraph_tpu_torch.index.flat import FlatIndex
    from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
    from codegraph_tpu_torch.index.ivfpq import IVFPQIndex

    dev = torch.device("cuda")
    N, D, CHUNK = SHM_N, SHM_D, 131072
    g = torch.Generator(device=dev).manual_seed(1212)
    centers = _unit(torch, torch.randn(4096, D, generator=g, device=dev))
    flat = FlatIndex(D, device="cuda")
    int8 = Int8FlatIndex(D, rescore_dtype="bfloat16", device="cuda")
    pq = IVFPQIndex(D, nlist=1024, nprobe=32, m=96, refine="int8", device="cuda")
    pq.train(mixture_chunk(torch, centers, N, pq.train_sample, 1213, 1.0 / math.sqrt(D)))
    flat.reserve(N)
    int8.reserve(N)
    pq.reserve(N)
    for base in range(0, N, CHUNK):
        rows = mixture_chunk(torch, centers, base, min(CHUNK, N - base), 1212, 1.0 / math.sqrt(D))
        for idx in (flat, int8, pq):
            idx.add(rows)
    perm = torch.randperm(N, generator=g, device=dev).cpu().numpy()
    dead, more = perm[: N // 100], perm[N // 100: N // 50]
    for idx in (flat, int8, pq):
        idx.delete(dead)
    torch.cuda.synchronize()
    return {"flat": flat, "int8": int8, "ivfpq": pq}, more, centers


def phase12(torch, mods, errs) -> dict:
    """Publish three indexes at 1M x 768 into segments; a second process
    attaches each through ShmServedIndex on its own CUDA context and
    searches (K1/K2, K5/K6, K8); a delete + republish must reach it within
    check_every, and every result must equal the publisher's own."""
    from codegraph_tpu_torch.index.snapshot import publish_index_shm

    t0 = time.perf_counter()
    idxs, more, centers = _shm_indexes(torch)
    build_s = time.perf_counter() - t0
    # one segment at a time, the f32 one the largest: its rows and the
    # publish's growth slack (0.5)
    need = int(1.6 * SHM_N * SHM_D * 4)
    seg_dir, free = _shm_dir(need)
    emit({"phase": 12, "segments_dir": seg_dir, "free_bytes": free, "need_bytes": need,
          "build_seconds": round(build_s, 3)})
    shapes = {"flat": (1, 64), "int8": (1, 64), "ivfpq": (1,)}
    g = torch.Generator(device="cuda").manual_seed(1214)
    qfiles = {}
    for B in (1, 64):
        q = _unit(torch, mixture_chunk(torch, centers, 2 * SHM_N + B, B, 1215, 1.0 / math.sqrt(SHM_D)))
        qfiles[B] = f"q{B}.npy"
        np.save(os.path.join(seg_dir, qfiles[B]), q.cpu().numpy())
    env = dict(os.environ, PYTHONPATH=ROOT)
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--shm-child", seg_dir],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
                             cwd=ROOT)
    stores = {}

    def ask(**cmd):
        child.stdin.write(json.dumps(cmd) + "\n")
        child.stdin.flush()
        line = child.stdout.readline()
        require(bool(line), f"phase 12: the attaching process ended ({child.poll()})")
        reply = json.loads(line)
        require("error" not in reply, f"phase 12: {reply}")
        return reply

    def compare(name, tag) -> dict:
        """The child's searches against the publisher's own index."""
        out = {"launches": {}}
        for B in shapes[name]:
            q = np.load(os.path.join(seg_dir, qfiles[B]))
            r = ask(op="search", name=name, queries=qfiles[B], k=SHM_K, out=f"{name}_{tag}_{B}.npz")
            got = np.load(os.path.join(seg_dir, f"{name}_{tag}_{B}.npz"))
            s, i = idxs[name].search(q, SHM_K)
            equal = bool(np.array_equal(got["s"], s) and np.array_equal(got["i"], i))
            require(equal, f"phase 12: {name} B={B} ({tag}) differs from the publisher's")
            out[f"B{B}"] = {"equal": equal, "child_seconds": r["seconds"]}
            for k_, v in r["launches"].items():
                out["launches"][k_] = out["launches"].get(k_, 0) + v
        return out

    try:
        parts = {}
        for name, idx in idxs.items():
            path = os.path.join(seg_dir, f"{name}.shm")
            t0 = time.perf_counter()
            stores[name] = publish_index_shm(idx, path)
            pub_s = time.perf_counter() - t0
            a = ask(op="attach", name=name, path=path)
            require(a["n"] == len(idx), f"phase 12: {name} attached {a['n']} of {len(idx)} rows")
            before = compare(name, "before")
            # the publisher deletes 1% more rows and republishes in place
            idx.delete(more)
            t0 = time.perf_counter()
            stores[name].close()
            stores[name] = publish_index_shm(idx, path)
            published_at = time.time()
            repub_s = time.perf_counter() - t0
            r = ask(op="await_reload", name=name, published_at=published_at,
                    timeout=SHM_CHECK_EVERY + 30.0)
            require(r["reloaded"] and r["n"] == len(idx), f"phase 12: {name} did not reload: {r}")
            require(r["detected_after_s"] <= SHM_CHECK_EVERY + SHM_POLL_SLACK,
                    f"phase 12: {name} reload seen {r['detected_after_s']} s after the republish")
            after = compare(name, "after")
            launches = {k_: before["launches"].get(k_, 0) + after["launches"].get(k_, 0)
                        for k_ in KERNELS}
            want = {"flat": ("K1", "K2"), "int8": ("K5", "K6"), "ivfpq": ("K8",)}[name]
            require(all(launches[k_] > 0 for k_ in want),
                    f"phase 12: {name} launched {launches} in the attaching process")
            parts[name] = {"segment_bytes": os.path.getsize(path), "publish_seconds": pub_s,
                           "republish_seconds": repub_s, "attach_seconds": a["attach_seconds"],
                           "reload_detected_after_s": r["detected_after_s"],
                           "reload_seconds": r["reload_seconds"], "rows": len(idx),
                           "before": {k_: v for k_, v in before.items() if k_ != "launches"},
                           "after": {k_: v for k_, v in after.items() if k_ != "launches"},
                           "launches": launches}
            emit({"phase": 12, "index": name, **parts[name]})
            stores[name].close()
            os.unlink(path)
        child.stdin.write(json.dumps({"op": "exit"}) + "\n")
        child.stdin.flush()
        require(child.wait(timeout=60) == 0, "phase 12: the attaching process failed")
        out = {"phase": 12, "gpu": nvidia_smi_line(), "segments_dir": seg_dir,
               "check_every": SHM_CHECK_EVERY, **parts,
               "launches": {k_: sum(p["launches"][k_] for p in parts.values()) for k_ in KERNELS}}
        emit(out)
        return out
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        for s in stores.values():
            s.close()
        shutil.rmtree(seg_dir, ignore_errors=True)
        del idxs
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the parallel/ slice: the sharded indexes at BASELINE config 5's size, and
# the encoder across a mesh, all on one card (a mesh of [cuda:0] * n)
# ---------------------------------------------------------------------------

SHARDS = 8
SHARD_N, SHARD_D = 10_000_000, 768
SHARD_IVF_N = 1_000_000
SHARD_REPS = 3
SHARD_SEED = 5150


def _mesh(torch, shape, axes):
    """A mesh of n shards on card 0 (the explicit one-card mesh)."""
    from codegraph_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape, axes, devices=[torch.device("cuda", 0)] * int(np.prod(shape)))


def _counted(mods, fn):
    """(fn(), {kernel: launches during it} for the kernels that launched)."""
    before = read_launches(mods)
    out = fn()
    after = read_launches(mods)
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _uncounted(mods, fn):
    """fn() with the kernels' launch counts left as they were: launches made
    to compare with another route or a plain version are not the main
    path's."""
    saved = read_launches(mods)
    try:
        return fn()
    finally:
        for name, n in saved.items():
            wrapper(mods, name).launches = n


def _require_per_shard(delta, kernel, n, what):
    require(delta == {kernel: n}, f"phase 13: {what} launched {delta}, not {kernel} x {n}")


def _sharded_oracle(torch, q, xs, bs, k):
    """The exact top-k over the shards' rows read in place: chunked
    torch.matmul + torch.topk per shard (library calls; used only here),
    then torch.topk over the shards' candidates."""
    ss, ii, off = [], [], 0
    for x, b in zip(xs, bs):
        s, i = yardstick(torch, q, x, b, k)
        ss.append(s)
        ii.append(i.long() + off)
        off += x.shape[0]
    v, p = torch.topk(torch.cat(ss, 1), k, dim=1)
    return v, torch.gather(torch.cat(ii, 1), 1, p).int()


def _host_result(torch, s_np, i_np):
    return torch.as_tensor(s_np, device="cuda"), torch.as_tensor(i_np, device="cuda").int()


def _phase13_flat(torch, mods, mesh8) -> list:
    from codegraph_tpu_torch.index.flat import FlatIndex
    from codegraph_tpu_torch.parallel import sharded_search as ss

    N, D = SHARD_N, SHARD_D
    g = torch.Generator(device="cuda").manual_seed(SHARD_SEED)
    t0 = time.perf_counter()
    rows = torch.randn(N, D, generator=g, device="cuda")
    idx = ss.ShardedFlatIndex(D, mesh8, tile_n=1024)
    idx.build(rows)
    del rows
    dead = torch.randperm(N, generator=g, device="cuda")[: N // 100].cpu().numpy()
    idx.delete(dead)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x_full, b_full = idx._x.full, idx._bias.full
    require(all(s.data_ptr() == x_full[i * idx.capacity // SHARDS].data_ptr()
                for i, s in enumerate(idx.x_shards)), "phase 13: a shard is not a view")
    # one FlatIndex over the same rows (the same tensors, no copy): the
    # unsharded search the merge is measured against
    single = FlatIndex.from_arrays(x_full, b_full, idx.n_rows, idx.n_live, device="cuda")
    require(single._x.data_ptr() == x_full.data_ptr(), "phase 13: the FlatIndex copied the rows")
    out = []
    for B, k in ((1, 10), (1, 100), (8, 10), (8, 100), (1024, 10), (1024, 100)):
        kernel = "K2" if B >= 32 else "K1"
        batches = [_unit(torch, torch.randn(B, D, generator=g, device="cuda"))
                   for _ in range(SHARD_REPS)]
        (s_np, i_np), delta = _counted(mods, lambda: idx.search(batches[0], k))
        _require_per_shard(delta, kernel, SHARDS, f"ShardedFlatIndex.search B={B}")
        ms = _time_ms(torch, lambda qb: idx.search(qb, k), batches)
        scan_ms = _time_ms(torch, lambda qb: ss.sharded_topk(qb, idx.x_shards, idx.bias_shards,
                                                             k, mesh8), batches)
        single_ms = _uncounted(mods, lambda: _time_ms(torch, lambda qb: single.search(qb, k),
                                                      batches))
        qn = ss._normalize_rows(batches[0])
        s_ref, i_ref = _sharded_oracle(torch, qn, idx.x_shards, idx.bias_shards, k)
        err, n_diff, bad = check_topk(torch, qn, x_full, b_full, *_host_result(torch, s_np, i_np),
                                      s_ref, i_ref)
        nbytes = N * D * 4 + N * 4 + B * D * 4 + B * k * 8
        bound, bound_by = _bound(nbytes, 2.0 * B * N * D, "float32")
        row = {"phase": 13, "index": "ShardedFlatIndex", "dtype": "float32", "N": N, "D": D,
               "shards": SHARDS, "B": B, "k": k, "kernel": kernel, "launches_per_search": delta,
               "ms": ms, "scan_ms": scan_ms, "unsharded_flat_ms": single_ms,
               "merge_overhead_ms": ms - single_ms, "bound_ms": bound, "bound_by": bound_by,
               "max_abs_err": err, "id_mismatches": n_diff, "mismatches_outside_ties": bad,
               "build_seconds": round(build_s, 3)}
        emit(row)
        out.append(row)
        require(bad == 0, f"phase 13: ShardedFlatIndex B={B} k={k}: {bad} mismatches outside ties")

    # the same rows on a (2, 4) query x data mesh and a (2, 4) dcn x ici mesh
    qb = _unit(torch, torch.randn(64, D, generator=g, device="cuda"))
    s_ref, i_ref = _sharded_oracle(torch, qb, idx.x_shards, idx.bias_shards, 10)
    for name, fn, shape, axes in (("sharded_topk_2d", ss.sharded_topk_2d, (2, 4), ("q", "data")),
                                  ("sharded_topk_hier", ss.sharded_topk_hier, (2, 4),
                                   ("dcn", "ici"))):
        mesh = _mesh(torch, shape, axes)
        (s, i), delta = _counted(mods, lambda: fn(qb, x_full, b_full, 10, mesh))
        _require_per_shard(delta, "K2", SHARDS, name)
        ms = _time_ms(torch, lambda q: fn(q, x_full, b_full, 10, mesh), [qb] * SHARD_REPS)
        err, n_diff, bad = check_topk(torch, qb, x_full, b_full, s, i, s_ref, i_ref)
        row = {"phase": 13, "fn": name, "mesh": dict(zip(axes, shape)), "N": N, "D": D, "B": 64,
               "k": 10, "launches_per_search": delta, "ms": ms, "max_abs_err": err,
               "id_mismatches": n_diff, "mismatches_outside_ties": bad}
        emit(row)
        out.append(row)
        require(bad == 0, f"phase 13: {name}: {bad} mismatches outside ties")
    del idx, single, x_full, b_full
    torch.cuda.empty_cache()
    return out


def _phase13_flat_bf16(torch, mods, mesh8) -> list:
    """ShardedFlatIndex over bf16 rows at the f32 case's size: the sharded
    scan hands each shard f32 queries, so B = 1 and 8 launch K1tc and B =
    1024 K2tc3 on every shard, each query as three bf16 pieces. Each result
    is held to the oracle over the same rows (the f32 queries against the
    rows widened to f32), and timed beside one scan of the same route over
    the unsharded rows."""
    from codegraph_tpu_torch.parallel import sharded_search as ss

    topk = mods["topk"]
    N, D = SHARD_N, SHARD_D
    g = torch.Generator(device="cuda").manual_seed(SHARD_SEED + 2)
    t0 = time.perf_counter()
    rows = torch.randn(N, D, generator=g, device="cuda")
    idx = ss.ShardedFlatIndex(D, mesh8, dtype="bfloat16", tile_n=1024)
    idx.build(rows)
    del rows
    dead = torch.randperm(N, generator=g, device="cuda")[: N // 100].cpu().numpy()
    idx.delete(dead)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x_full, b_full = idx._x.full, idx._bias.full
    require(x_full.dtype == torch.bfloat16, f"phase 13: the bf16 index holds {x_full.dtype} rows")
    out = []
    for B, k in ((1, 10), (1, 100), (8, 10), (8, 100), (1024, 10), (1024, 100)):
        kernel = "K2tc3" if B >= 32 else "K1tc"
        batches = [_unit(torch, torch.randn(B, D, generator=g, device="cuda"))
                   for _ in range(SHARD_REPS)]
        (s_np, i_np), delta = _counted(mods, lambda: idx.search(batches[0], k))
        _require_per_shard(delta, kernel, SHARDS, f"bf16 ShardedFlatIndex.search B={B}")
        ms = _time_ms(torch, lambda qb: idx.search(qb, k), batches)
        scan = topk.streaming_topk_cuda_qmajor if B >= 32 else topk.streaming_topk_cuda
        single_ms = _uncounted(mods, lambda: _time_ms(
            torch, lambda qb: scan(ss._normalize_rows(qb), x_full, b_full, k), batches))
        qn = ss._normalize_rows(batches[0])
        s_ref, i_ref = _sharded_oracle(torch, qn, idx.x_shards, idx.bias_shards, k)
        err, n_diff, bad = check_topk(torch, qn, x_full, b_full, *_host_result(torch, s_np, i_np),
                                      s_ref, i_ref)
        nbytes = N * D * 2 + N * 4 + B * D * 4 + B * k * 8
        bound, bound_by = _bound(nbytes, 3 * 2.0 * B * N * D, "bfloat16")
        row = {"phase": 13, "index": "ShardedFlatIndex", "dtype": "bfloat16", "q_dtype": "float32",
               "N": N, "D": D, "shards": SHARDS, "B": B, "k": k, "kernel": kernel,
               "launches_per_search": delta, "ms": ms, "unsharded_scan_ms": single_ms,
               "merge_overhead_ms": ms - single_ms, "bound_ms": bound, "bound_by": bound_by,
               "max_abs_err": err, "id_mismatches": n_diff, "mismatches_outside_ties": bad,
               "build_seconds": round(build_s, 3)}
        emit(row)
        out.append(row)
        require(bad == 0, f"phase 13: bf16 ShardedFlatIndex B={B} k={k}: {bad} mismatches "
                          "outside ties")
    del idx, x_full, b_full
    torch.cuda.empty_cache()
    return out


def _phase13_int8(torch, mods, mesh8) -> list:
    from codegraph_tpu_torch.ops import quantize as q8
    from codegraph_tpu_torch.parallel import sharded_search as ss

    N, D = SHARD_N, SHARD_D
    g = torch.Generator(device="cuda").manual_seed(SHARD_SEED + 1)
    t0 = time.perf_counter()
    rows = torch.randn(N, D, generator=g, device="cuda")
    idx = ss.ShardedInt8Index(D, mesh8, rescore_k=100)
    idx.build(rows)
    del rows
    dead = torch.randperm(N, generator=g, device="cuda")[: N // 100].cpu().numpy()
    idx.delete(dead)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qv_full, qs_full, b_full = idx._qv.full, idx._qs.full, idx._bias.full
    host = idx._host_f32
    out = []
    for B, k in ((1, 10), (8, 10), (256, 10)):
        kernel = "K6" if B >= 32 else "K5"
        batches = [_unit(torch, torch.randn(B, D, generator=g, device="cuda"))
                   for _ in range(SHARD_REPS)]
        (s_np, i_np), delta = _counted(mods, lambda: idx.search(batches[0], k))
        _require_per_shard(delta, kernel, SHARDS, f"ShardedInt8Index.search B={B}")
        ms = _time_ms(torch, lambda qb: idx.search(qb, k), batches)
        # the scan alone (the shards' candidates and their merge) against one
        # launch of the same kernel over every row
        cand = idx.rescore_k
        quant = [q8.quantize_rows(qb) for qb in batches]
        scan_ms = _time_ms(torch, lambda qq: ss.sharded_topk_int8(
            qq[0], qq[1], idx._qv.shards, idx._qs.shards, idx._bias.shards, cand, mesh8), quant)
        one = q8.streaming_topk_int8_cuda_qmajor if B >= 32 else q8.streaming_topk_int8_cuda
        single_ms = _uncounted(mods, lambda: _time_ms(
            torch, lambda qq: one(qq[0], qq[1], qv_full, qs_full, b_full, cand), quant))
        # the kernels' candidates against their plain version, shard by shard
        qv, qs = quant[0]
        s_k, i_k = _uncounted(mods, lambda: ss.sharded_topk_int8(
            qv, qs, idx._qv.shards, idx._qs.shards, idx._bias.shards, cand, mesh8))
        t1 = time.perf_counter()
        parts = []
        for s_, (v, sc, b) in enumerate(zip(idx._qv.shards, idx._qs.shards, idx._bias.shards)):
            sp, ip = q8.streaming_topk_int8(qv, qs, v, sc, b, cand)
            parts.append((sp, ss._global_ids(ip, s_ * v.shape[0])))
        s_p, i_p = ss.merge_shards(torch.stack([p[0] for p in parts]),
                                   torch.stack([p[1] for p in parts]), cand)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                      judge=int8_judge(qv, qs, qv_full, qs_full, b_full))
        # the rescored result: exact f32 dots of the host copy, sorted, live
        qn = ss._normalize_rows(batches[0]).cpu().numpy()
        exact = np.einsum("bd,bkd->bk", qn.astype(np.float64),
                          host[np.maximum(i_np, 0)].astype(np.float64))
        live = ~np.isin(i_np, dead) & (i_np >= 0)
        rescore_err = float(np.abs(exact - s_np).max())
        ok = bool(live.all() and rescore_err <= SCORE_TOL and (np.diff(s_np, axis=1) <= 0).all())
        nbytes = N * D + N * 8 + B * D + B * cand * 8
        bound, bound_by = _bound(nbytes, 2.0 * B * N * D, "int8")
        row = {"phase": 13, "index": "ShardedInt8Index", "dtype": "int8", "N": N, "D": D,
               "shards": SHARDS, "B": B, "k": k, "rescore_k": cand, "kernel": kernel,
               "launches_per_search": delta, "ms": ms, "scan_ms": scan_ms,
               "unsharded_scan_ms": single_ms, "scan_merge_overhead_ms": scan_ms - single_ms,
               "scan_bound_ms": bound, "scan_bound_by": bound_by, "plain_scan_ms": plain_ms,
               "max_abs_err": err, "id_mismatches": n_diff, "mismatches_outside_ties": bad,
               "rescore_max_abs_err": rescore_err, "results_ok": ok,
               "build_seconds": round(build_s, 3)}
        emit(row)
        out.append(row)
        require(bad == 0 and ok, f"phase 13: ShardedInt8Index B={B}: {bad} mismatches, ok={ok}")
    del idx, qv_full, qs_full, b_full, host
    torch.cuda.empty_cache()
    return out


def _recall_at_10(torch, qr, centers, n, seed, spread, live, got):
    """recall@10 of `got` against an exact f32 scan of the (re-made) mixture rows."""
    best_s = torch.full((qr.shape[0], 10), -float("inf"), device="cuda")
    best_i = torch.zeros((qr.shape[0], 10), dtype=torch.long, device="cuda")
    for base in range(0, n, 524_288):
        m = min(524_288, n - base)
        s = qr @ _unit(torch, mixture_chunk(torch, centers, base, m, seed, spread)).T
        s[:, ~live[base: base + m]] = -float("inf")
        v, i = torch.topk(torch.cat([best_s, s], 1), 10, dim=1)
        best_i = torch.gather(torch.cat([best_i, torch.arange(base, base + m, device="cuda")
                                         .expand(qr.shape[0], -1)], 1), 1, i)
        best_s = v
    return float(np.mean([len(set(a) & set(b)) / 10.0
                          for a, b in zip(got.tolist(), best_i.cpu().tolist())]))


def _phase13_ivf(torch, mods, mesh8) -> list:
    from codegraph_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
    from codegraph_tpu_torch.ops.similarity import l2_normalize
    from codegraph_tpu_torch.parallel.sharded_ivfpq import (ShardedIVFPQIndex, _local_parts,
                                                            sharded_ivfpq_search)
    from codegraph_tpu_torch.parallel.sharded_search import _gather_merge

    ivfpq = mods["ivfpq"]
    D, SEED = SHARD_D, 2027
    SPREAD = 1.0 / math.sqrt(D)
    gc = torch.Generator(device="cuda").manual_seed(SEED)
    centers = _unit(torch, torch.randn(16_384, D, generator=gc, device="cuda"))
    out = []

    def queries(B, r, n):
        return _unit(torch, mixture_chunk(torch, centers, n + (r + 1) * 1_000_003 + B, B,
                                          SEED + 3, 1.0 / math.sqrt(D)))

    # ShardedIVFIndex at 1M x 768 (bf16 cells; the reference's defaults)
    N = SHARD_IVF_N
    t0 = time.perf_counter()
    ivf = ShardedIVFIndex(D, mesh8)
    ivf._base.reserve(N)
    ivf.train(mixture_chunk(torch, centers, N, ivf._base.train_sample, SEED + 1, SPREAD))
    for base in range(0, N, 524_288):
        ivf.add(mixture_chunk(torch, centers, base, min(524_288, N - base), SEED, SPREAD))
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dead = torch.randperm(N, generator=g, device="cuda")[: N // 100]
    ivf.delete(dead.cpu().numpy())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    live = torch.ones(N, dtype=torch.bool, device="cuda")
    live[dead] = False
    base_idx = ivf._base
    _, x_lists, _, _ = base_idx.arrays()
    loc = torch.as_tensor(base_idx._row_loc[:N], device="cuda")
    for B in (1, 8, 64):
        batches = [queries(B, r, N) for r in range(SHARD_REPS)]
        (s_np, i_np), delta = _counted(mods, lambda: ivf.search(batches[0], 10))
        require(not delta, f"phase 13: ShardedIVFIndex launched {delta} (it has no kernel)")
        ms = _time_ms(torch, lambda qb: ivf.search(qb, 10), batches)
        # each score is the dot of the stored (bf16) row it names
        s, i = _host_result(torch, s_np, i_np)
        rows = x_lists[loc[i.long(), 0], loc[i.long(), 1]].float()
        err = float((torch.einsum("bd,bkd->bk", batches[0], rows) - s).abs().max())
        ok = bool((i >= 0).all() and live[i.long()].all()) and err <= SCORE_TOL
        row = {"phase": 13, "index": "ShardedIVFIndex", "dtype": "bfloat16", "N": N, "D": D,
               "shards": SHARDS, "nlist": base_idx.nlist, "nprobe_per_shard": ivf.nprobe,
               "B": B, "k": 10, "launches_per_search": delta, "ms": ms,
               "score_vs_stored_rows_max_abs": err, "results_ok": ok,
               "build_seconds": round(build_s, 3)}
        if B == 64:
            row["recall_at_10"] = _recall_at_10(torch, batches[0], centers, N, SEED, SPREAD, live,
                                                torch.as_tensor(i_np))
        emit(row)
        out.append(row)
        require(ok, f"phase 13: ShardedIVFIndex B={B}: scores off the stored rows by {err}")
    del ivf, base_idx, x_lists, loc
    torch.cuda.empty_cache()

    # ShardedIVFPQIndex at 10M x 768 with the device refine (K8 per shard)
    N = SHARD_N
    t0 = time.perf_counter()
    pq = ShardedIVFPQIndex(D, mesh8, nlist=4096, nprobe=64, m=96, refine="int8_device")
    pq._base.reserve(N)
    pq.train(mixture_chunk(torch, centers, N, pq._base.train_sample, SEED + 1, SPREAD))
    for base in range(0, N, 524_288):
        pq.add(mixture_chunk(torch, centers, base, min(524_288, N - base), SEED, SPREAD))
    dead = torch.randperm(N, generator=g, device="cuda")[: N // 100]
    pq.delete(dead.cpu().numpy())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    live = torch.ones(N, dtype=torch.bool, device="cuda")
    live[dead] = False
    pq._place()
    base = pq._base
    np_eff = min(pq.nprobe, base.nlist // SHARDS)
    k_fetch = max(10, min(10 * base.refine_factor, base.list_cap * np_eff))
    bank, scales = base._dev_bank()

    def int8_exact(qn, rows):
        """Exact scores of int8 bank rows [B, c] for qn [B, D]: the integer
        rows times their scale, dotted in f64 (in query chunks)."""
        return torch.cat([torch.einsum("bd,bcd->bc", qn[b0: b0 + 128].double(),
                                       bank[rows[b0: b0 + 128]].double())
                          * scales[rows[b0: b0 + 128], 0].double()
                          for b0 in range(0, qn.shape[0], 128)])

    for B in (1, 8, 1024):
        batches = [queries(B, r, N) for r in range(SHARD_REPS)]
        (s_np, i_np), delta = _counted(mods, lambda: pq.search(batches[0], 10))
        _require_per_shard(delta, "K8", SHARDS, f"ShardedIVFPQIndex.search B={B}")
        ms = _time_ms(torch, lambda qb: pq.search(qb, 10), batches)
        ok = bool((i_np >= 0).all() and live[torch.as_tensor(i_np, device="cuda").long()].all()
                  and np.isfinite(s_np).all())
        # the range-sharded refine and its psum against an oracle: every
        # shard's K8 candidates, scored exactly from the whole bank in f64,
        # the top 10 by a stable sort (a tie to the earlier candidate)
        qn = l2_normalize(base._queries(batches[0]))
        parts = _uncounted(mods, lambda: _local_parts(qn, *pq._cells, pq._books, k_fetch, np_eff,
                                                      mesh8, pq.axis, pq._ext))
        cand = torch.cat([i.to("cuda") for _, i in parts], 1).long()    # shard-major
        exact = torch.where(cand >= 0, int8_exact(qn, cand.clamp(min=0)), -math.inf)
        s_ref, pos = torch.sort(exact, dim=1, descending=True, stable=True)
        s_ref, i_ref = s_ref[:, :10].float(), torch.gather(cand, 1, pos[:, :10]).int()
        err, n_diff, bad = check_topk(
            torch, None, None, None, *_host_result(torch, s_np, i_np), s_ref, i_ref,
            judge=lambda b, rows: int8_exact(qn[b: b + 1], rows[None])[0])
        row = {"phase": 13, "index": "ShardedIVFPQIndex", "refine": "int8_device", "N": N, "D": D,
               "shards": SHARDS, "nlist": base.nlist, "nprobe_per_shard": pq.nprobe, "m": 96,
               "B": B, "k": 10, "k_fetch_per_shard": k_fetch, "launches_per_search": delta,
               "ms": ms, "results_ok": ok, "refine_vs_exact_max_abs_err": err,
               "refine_id_mismatches": n_diff, "refine_mismatches_outside_ties": bad,
               "build_seconds": round(build_s, 3)}
        emit(row)
        out.append(row)
        require(ok, f"phase 13: ShardedIVFPQIndex B={B} returned dead or missing rows")
        require(bad == 0, f"phase 13: ShardedIVFPQIndex B={B}: the refine disagrees with the "
                          f"exact int8 rescore of the shards' candidates ({bad})")
    # K8 per shard against its plain version, merged the same way: at B=8,
    # and at B=1024 (the main path's batch) on 16 of its queries, whose
    # results depend on no other query
    full = base.arrays()
    for B, sample in ((8, None), (1024, torch.linspace(0, 1023, 16).long().cuda())):
        qs = queries(B, 99, N)
        s_k, i_k = _uncounted(mods, lambda: sharded_ivfpq_search(
            qs, *pq._cells, pq._books, k_fetch, np_eff, mesh8, extents=pq._ext))
        qp = qs if sample is None else qs[sample]
        if sample is not None:
            s_k, i_k = s_k[sample], i_k[sample]
        parts = [ivfpq.ivfpq_search(qp, c, cl, il, bl, pq._books, k_fetch, np_eff)
                 for c, cl, il, bl in zip(*pq._cells)]
        s_p, i_p = _gather_merge(parts, k_fetch, mesh8.first_device)
        err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                      judge=adc_judge(torch, qp, *full, pq._books))
        row = {"phase": 13, "index": "ShardedIVFPQIndex", "check": "K8 per shard vs plain",
               "B": B, "rows_compared": qp.shape[0], "k": k_fetch, "max_abs_err": err,
               "id_mismatches": n_diff, "mismatches_outside_ties": bad}
        emit(row)
        out.append(row)
        require(bad == 0, f"phase 13: K8 per shard disagrees with its plain version at B={B} "
                          f"({bad})")
    # recall@10 against an exact f32 scan, at the refine factor of the main
    # path (4) and at larger ones: what the PQ ranking of k_fetch candidates
    # a shard costs
    qr = queries(256, 50, N)
    recalls = {}
    for rf in (4, 16, 64):
        base.refine_factor = rf
        _, got = pq.search(qr, 10)
        recalls[rf] = _recall_at_10(torch, qr, centers, N, SEED, SPREAD, live,
                                    torch.as_tensor(got))
    base.refine_factor = 4
    row = {"phase": 13, "index": "ShardedIVFPQIndex", "check": "recall@10 by refine_factor",
           "recall_queries": 256, "nprobe_per_shard": pq.nprobe,
           "recall_at_10": {str(rf): r for rf, r in recalls.items()}}
    emit(row)
    out.append(row)
    require(recalls[4] > 0.45, f"phase 13: ShardedIVFPQIndex recall@10 {recalls[4]}")
    del pq, base, full, bank, scales
    torch.cuda.empty_cache()
    return out


def _phase13_hybrid(torch, mods, mesh8) -> dict:
    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.parallel.sharded_search import ShardedFlatIndex
    from codegraph_tpu_torch.search.hybrid import HybridSearch

    tmp = tempfile.mkdtemp(prefix="cg_smoke13_")
    try:
        proj = _project_copy(tmp)
        cfg = _hash_config(tmp, "data")
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        cg.index()
        ix = cg.indexer
        flat = ix.index
        x, bias = flat.arrays()
        sharded = ShardedFlatIndex(x.shape[1], mesh8, tile_n=1024)
        sharded.build(x[: flat.n_rows])
        dead = (bias[: flat.n_rows] <= NEG_INF / 2).nonzero().flatten().cpu().numpy()
        sharded.delete(dead)
        hs = HybridSearch(ix.store, sharded, ix.provider, ix.bm25, cfg.search)
        require(hs._index_filter_ok, "phase 13: HybridSearch does not pass filters to the index")
        mismatches, err, launches = 0, 0.0, []
        for query in QUERIES:
            got, delta = _counted(mods, lambda: hs.search_text(query, limit=10))
            want = _uncounted(mods, lambda: cg.search(query, limit=10))
            launches.append(delta)
            _require_per_shard(delta, "K1", SHARDS, "HybridSearch over ShardedFlatIndex")
            require(len(got) == len(want) > 0, f"phase 13: hybrid hits {len(got)} vs {len(want)}")
            for n, (a, b) in enumerate(zip(got, want)):
                err = max(err, abs(a.score - b.score))
                if a.node_id != b.node_id and not any(
                        abs(want[m].score - b.score) <= SCORE_TOL
                        for m in (n - 1, n + 1) if 0 <= m < len(want)):
                    mismatches += 1
        out = {"phase": 13, "hybrid": "HybridSearch over ShardedFlatIndex", "shards": SHARDS,
               "rows": flat.n_rows, "queries": len(QUERIES), "launches": launches,
               "max_abs_err": err, "mismatches_outside_ties": mismatches}
        emit(out)
        require(mismatches == 0 and err <= SCORE_TOL,
                f"phase 13: sharded hybrid hits differ from the FlatIndex's ({mismatches}, {err})")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase13(torch, mods, errs) -> dict:
    mesh8 = _mesh(torch, (SHARDS,), ("data",))
    reset_launches(mods)
    flat = _phase13_flat(torch, mods, mesh8)
    flat += _phase13_flat_bf16(torch, mods, mesh8)
    int8 = _phase13_int8(torch, mods, mesh8)
    ivf = _phase13_ivf(torch, mods, mesh8)
    hybrid = _phase13_hybrid(torch, mods, mesh8)
    launches = read_launches(mods)
    for rows in (flat, int8):
        for r in rows:
            if "kernel" in r:
                errs[r["kernel"]] = max(errs[r["kernel"]], r["max_abs_err"])
    errs["K8"] = max([errs["K8"]] + [r["max_abs_err"] for r in ivf
                                     if r.get("check") == "K8 per shard vs plain"])
    require(all(launches[k] > 0 for k in ("K1", "K2", "K1tc", "K2tc3", "K5", "K6", "K8")),
            f"phase 13: a kernel of the sharded paths never launched: {launches}")
    return {"launches": launches, "rows": flat + int8 + ivf, "hybrid": hybrid}


# -- phase 14: the encoder across a mesh -------------------------------------

PAR_B, PAR_TOL = 256, 1e-4


def _max_gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase14(torch, mods, errs) -> dict:
    import dataclasses
    import importlib

    from codegraph_tpu_torch.models import training as tt
    from codegraph_tpu_torch.models.encoder import encode, init_encoder_params
    from codegraph_tpu_torch.models.providers import EncoderProvider
    from codegraph_tpu_torch.parallel import moe
    from codegraph_tpu_torch.parallel.pipeline import pp_encode

    ring = importlib.import_module("codegraph_tpu_torch.parallel.ring_attention")
    reset_launches(mods)
    base = EncoderProvider(checkpoint=os.path.join(ROOT, "checkpoints", ENCODER_CKPT), device="cuda")
    cfg, tok = base.cfg, base.tokenizer
    L = cfg.max_len
    require((cfg.hidden, cfg.n_layers, cfg.n_heads, L) == (512, 6, 16, 192),
            f"phase 14: the r3 encoder is {cfg}")
    master = {k: v.float() for k, v in base.params.items()}
    del base
    pairs = _doc_code_pairs()
    pick = np.random.default_rng(14).choice(len(pairs), PAR_B, replace=False)
    a_ids, a_mask = tok.encode_batch([pairs[i][0] for i in pick], max_len=L)
    p_ids, p_mask = tok.encode_batch([pairs[i][1] for i in pick], max_len=L)
    ids, mask = torch.from_numpy(p_ids).cuda(), torch.from_numpy(p_mask).cuda()
    batch = {"anchor_ids": torch.from_numpy(a_ids).cuda(), "anchor_mask": torch.from_numpy(a_mask).cuda(),
             "positive_ids": ids, "positive_mask": mask}
    out = {"phase": 14, "config": {"hidden": cfg.hidden, "layers": cfg.n_layers,
                                   "heads": cfg.n_heads, "B": PAR_B, "L": L}}

    # 1. forwards in f32 (TF32 off) against encode without a mesh
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    fwd = {}
    with torch.inference_mode():
        runs = {
            "encode": lambda: encode(master, ids, mask, cfg32),
            "sp_ring_encode (dp, sp) = (2, 4)": lambda: ring.sp_ring_encode(
                master, ids, mask, cfg32, _mesh(torch, (2, 4), ("dp", "sp")), sp_axis="sp",
                dp_axis="dp"),
            "pp_encode pp = 2": lambda: pp_encode(master, ids, mask, cfg32,
                                                  _mesh(torch, (2,), ("pp",)), n_micro=4),
            "pp_encode pp = 3": lambda: pp_encode(master, ids, mask, cfg32,
                                                  _mesh(torch, (3,), ("pp",)), n_micro=4),
            "pp_encode (pp, tp) = (2, 2)": lambda: pp_encode(
                master, ids, mask, cfg32, _mesh(torch, (2, 2), ("pp", "tp")), n_micro=4,
                tp_axis="tp"),
            "encode (dp, sp, tp) = (2, 2, 2)": lambda: encode(
                master, ids, mask, cfg32, mesh=_mesh(torch, (2, 2, 2), ("dp", "sp", "tp")),
                dp_axis="dp", sp_axis="sp"),
        }
        ref = runs["encode"]()
        for name, fn in runs.items():
            ms, got = _event_ms(torch, fn, 3)
            gap = _max_gap(got[-1], ref)
            fwd[name] = {"ms": statistics.median(ms), "max_abs_vs_encode": gap}
            require(got[-1].shape == ref.shape and bool(torch.isfinite(got[-1]).all()),
                    f"phase 14: {name} gave {tuple(got[-1].shape)}")
            require(gap <= PAR_TOL, f"phase 14: {name} is {gap} from encode")
        # the card's bf16 forward on the mesh against its own unsharded one
        bf16 = {k: v.to(torch.bfloat16) for k, v in master.items()}
        ms1, r1 = _event_ms(torch, lambda: encode(bf16, ids, mask, cfg), 3)
        ms2, r2 = _event_ms(torch, lambda: encode(
            bf16, ids, mask, cfg, mesh=_mesh(torch, (2, 2, 2), ("dp", "sp", "tp")), dp_axis="dp",
            sp_axis="sp"), 3)
        fwd["bf16 encode"] = {"ms": statistics.median(ms1)}
        fwd["bf16 encode (dp, sp, tp) = (2, 2, 2)"] = {"ms": statistics.median(ms2),
                                                        "max_abs_vs_encode": _max_gap(r2[-1], r1[-1])}
        require(fwd["bf16 encode (dp, sp, tp) = (2, 2, 2)"]["max_abs_vs_encode"] <= ENC_TOL,
                f"phase 14: the bf16 forward on the mesh is {fwd} from encode")
    out["forward"] = fwd

    # 2. one training step (bf16, remat) on (dp, sp, tp) = (2, 2, 2) against one device
    tcfg = tt.TrainConfig(learning_rate=TRAIN_LR, temperature=0.05)
    rcfg = dataclasses.replace(cfg, remat=True)
    steps = {}
    plain_step, _ = tt.make_sharded_train_step(None, rcfg, tcfg, device="cuda")
    mesh_step, _ = tt.make_sharded_train_step(_mesh(torch, (2, 2, 2), ("dp", "sp", "tp")), rcfg,
                                              tcfg, sp_axis="sp")
    opt = tt.make_optimizer(tcfg)
    for name, step in (("one device", plain_step), ("(dp, sp, tp) = (2, 2, 2)", mesh_step)):
        step(master, opt.init(master), batch)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, res = _event_ms(torch, lambda: step(master, opt.init(master), batch), 3)
        m = res[-1][2]
        steps[name] = {"ms": statistics.median(ms), "loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del res
    a, b = steps["one device"], steps["(dp, sp, tp) = (2, 2, 2)"]
    require(math.isfinite(b["loss"]) and abs(a["loss"] - b["loss"]) <= _bf16_step(a["loss"])
            and abs(a["grad_norm"] - b["grad_norm"]) <= _bf16_step(a["grad_norm"]),
            f"phase 14: the sharded step differs from one device's: {steps}")

    # 3. a routed-MoE encoder at the r3 width, one step on (dp, ep, tp) = (2, 2, 2)
    mcfg = dataclasses.replace(rcfg, n_experts=4, moe_top_k=2, moe_capacity=2.0)
    mparams = {k: v.cuda() for k, v in
               init_encoder_params(mcfg, torch.Generator().manual_seed(14)).items()}
    plain_moe, _ = tt.make_sharded_train_step(None, mcfg, tcfg, device="cuda")
    mesh_moe, _ = tt.make_sharded_train_step(_mesh(torch, (2, 2, 2), ("dp", "ep", "tp")), mcfg,
                                             tcfg, ep_axis="ep")
    for name, step in (("MoE one device", plain_moe), ("MoE (dp, ep, tp) = (2, 2, 2)", mesh_moe)):
        step(mparams, opt.init(mparams), batch)  # warm
        ms, res = _event_ms(torch, lambda: step(mparams, opt.init(mparams), batch), 2)
        m = res[-1][2]
        steps[name] = {"ms": statistics.median(ms), "loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"])}
        del res
    a, b = steps["MoE one device"], steps["MoE (dp, ep, tp) = (2, 2, 2)"]
    require(math.isfinite(b["loss"]) and abs(a["loss"] - b["loss"]) <= _bf16_step(a["loss"])
            and abs(a["grad_norm"] - b["grad_norm"]) <= _bf16_step(a["grad_norm"]),
            f"phase 14: the routed-MoE step on the mesh differs from one device's: {steps}")
    out["train_steps"] = steps

    # 4. the all-to-all MoE layer, ep = 4, against the dense oracle
    T, E = 4096, 8
    p = {k: v.cuda() for k, v in moe.init_moe_params(torch.Generator().manual_seed(4), cfg.hidden,
                                                     cfg.mlp_hidden, E).items()}
    x = torch.randn(T, cfg.hidden, generator=torch.Generator().manual_seed(5)).cuda()
    fwd_moe = moe.make_sharded_topk_moe(_mesh(torch, (4,), ("ep",)), "ep", k=2, capacity_factor=8.0)
    with torch.inference_mode():
        ms_a2a, r_a2a = _event_ms(torch, lambda: fwd_moe(x, p), 3)
        ms_dense, r_dense = _event_ms(torch, lambda: moe.topk_moe_dense(x, p, k=2), 3)
    gap = _max_gap(r_a2a[-1], r_dense[-1])
    out["moe_all_to_all"] = {"T": T, "H": cfg.hidden, "F": cfg.mlp_hidden, "E": E, "k": 2, "ep": 4,
                             "capacity": 8.0, "ms": statistics.median(ms_a2a),
                             "dense_ms": statistics.median(ms_dense), "max_abs_vs_dense": gap}
    require(gap <= PAR_TOL, f"phase 14: the ep=4 all-to-all MoE is {gap} from the dense oracle")
    out["launches"] = read_launches(mods)
    emit(out)
    return out


def _on_alarm(signum, frame):
    raise TimeoutError(f"chip_smoke watchdog: {WATCHDOG_S}s exceeded")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--shm-child", metavar="DIR",
                    help="run as phase 12's attaching process (started by phase 12)")
    args = ap.parse_args(argv)
    if args.shm_child:
        return shm_child(args.shm_child)
    phases = {int(p) for p in args.phases.split(",") if p.strip()}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "codegraph_tpu_torch")):
        print(f"chip_smoke: no codegraph_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true f32
    torch.backends.cudnn.allow_tf32 = False

    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(WATCHDOG_S)
    faulthandler.dump_traceback_later(WATCHDOG_S + 60, exit=True)
    t_all = time.perf_counter()
    from codegraph_tpu_torch.index import ivf, ivfpq
    from codegraph_tpu_torch.ops import quantize, topk

    mods = {"topk": topk, "quantize": quantize, "ivfpq": ivfpq, "ivf": ivf}
    errs = {name: 0.0 for name in KERNELS}
    seconds = {}

    def run(n, fn, *args, empty=None):
        if n not in phases:
            return empty
        t0 = time.perf_counter()
        out = fn(torch, *args)
        seconds[n] = round(time.perf_counter() - t0, 3)
        emit({"phase": n, "seconds": seconds[n]})
        return out

    try:
        p0 = run(0, phase0)
        run(1, phase1, mods, errs)
        run(16, phase16, mods, errs)
        p2 = run(2, phase2, mods, errs)
        p15 = run(15, phase15, mods, errs)
        p17 = run(17, phase17, mods, errs)
        p3 = run(3, phase3, topk, errs, empty=[])
        p4 = run(4, phase4, mods, errs)
        p5 = run(5, phase5, mods, errs, empty=[])
        p6 = run(6, phase6, mods, errs)
        p7 = run(7, phase7, mods, errs, empty=[])
        p8 = run(8, phase8, mods, errs)
        p9 = run(9, phase9, mods, errs)
        p10 = run(10, phase10, mods, errs)
        run(11, phase11, mods, errs)
        p12 = run(12, phase12, mods, errs)
        p13 = run(13, phase13, mods, errs)
        p14 = run(14, phase14, mods, errs)
    except (CheckFailed, TimeoutError) as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()

    # each kernel at one shape of its real-size phase (rows, their dtype,
    # B, k, the queries' dtype where two are timed, D, and N where one D
    # has several); launches from its
    # tier's main path, for K1 and K2 the default configuration's (phase 8)
    # when it ran, else for K1 the served path's (phase 9), for K1tc and
    # K2tc the bf16 main path's (phase 15), for K2tc3 the sharded bf16
    # index's (phase 13), for the ragged routes the main path at D = 100
    # (phase 17: K1tcr, K2tcr, K6r; K2tc3r on its 8-shard index), for K5r
    # the int8 index's searches over 10M rows of width 765 (phase 5) (K3, K4,
    # K4r, K4tc, K4tc3, K4tcr, K4tc3r and K7 are public ops that no index calls:
    # 0 launches on every path; K1r and K2r take widths that are not a
    # multiple of 4, which phase 17's D = 100 is not)
    shapes = {"K1": (p3, "float32", 1, 30, None, 768), "K2": (p3, "float32", 1024, 30, None, 768),
              "K3": (p3, "float32", 1024, 100, None, 768),
              "K4": (p3, "float32", 1024, 30, None, 768),
              "K4r": (p3, "float32", 1024, 30, None, 768, K4R_TIMED_N[0]),
              "K1tc": (p3, "bfloat16", 1, 30, "bfloat16", 768),
              "K2tc": (p3, "bfloat16", 1024, 30, None, 768),
              "K2tc3": (p3, "bfloat16", 1024, 30, None, 768),
              "K4tc": (p3, "bfloat16", 1024, 30, None, 768),
              "K4tc3": (p3, "bfloat16", 1024, 30, None, 768),
              "K4tcr": (p3, "bfloat16", 1024, 30, None, 768, K4TCR_TIMED_N[0]),
              "K4tc3r": (p3, "bfloat16", 1024, 30, None, 768, K4TCR_TIMED_N[0]),
              "K5": (p5, "int8", 1, 100, None, 768), "K6": (p5, "int8", 1024, 100, None, 768),
              "K7": (p5, "int8", 1024, 100, None, 768),
              "K6r": (p5, "int8", 1024, 100, None, 760), "K5r": (p5, "int8", 1, 100, None, 765),
              "K1r": (p3, "float32", 1, 30, None, 765),
              "K2r": (p3, "float32", 1024, 30, None, 765),
              "K1tcr": (p3, "bfloat16", 1, 30, "bfloat16", 764),
              "K2tcr": (p3, "bfloat16", 1024, 30, None, 764),
              "K2tc3r": (p3, "bfloat16", 1024, 30, None, 764),
              "K8": (p7, "uint8 codes", 1, 40, None, 768)}
    flat_path = p8 or p2
    p5_search = [r for r in p5 if r.get("kind") == "Int8FlatIndex.search" and "launches" in r]
    p5_ragged = ({"launches": {name: sum(r["launches"][name] for r in p5_search)
                               for name in KERNELS}} if p5_search else None)
    paths = {"K1": p8 or p9 or p2, "K2": flat_path, "K3": flat_path, "K4": flat_path,
             "K4r": flat_path,
             "K1tc": p15, "K2tc": p15, "K2tc3": p13, "K4tc": p15, "K4tc3": p13, "K4tcr": p15,
             "K4tc3r": p13, "K5": p4,
             "K6": p4, "K7": p4, "K8": p6["ivfpq"] if p6 else None,
             "K5r": p5_ragged,
             **{name: p17 for name in ("K1r", "K2r", "K1tcr", "K2tcr", "K2tc3r", "K6r")}}
    kernels = []
    for name, (_, fn_name, source, replaces) in KERNELS.items():
        rows, dtype, B, k, q_dtype, D, *n_of = shapes[name]
        row = next((r for r in rows if r.get("kernel") == name and r["dtype"] == dtype
                    and r["B"] == B and r["k"] == k and r.get("D", 768) == D
                    and n_of in ([], [r.get("N")])
                    and r.get("via", name) in (name, "K1", "K2", "K4", "K5", "K6")
                    and q_dtype in (None, r.get("q_dtype"))), {})
        path = paths[name]
        kernels.append({
            "name": f"{name} {fn_name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": path["launches"][name] if path else None,
            "launches_by_phase": {str(n): p["launches"][name] for n, p in
                                  ((2, p2), (4, p4), (5, p5_ragged),
                                   (6, p6["ivfpq"] if p6 else None), (8, p8),
                                   (9, p9), (10, p10), (12, p12), (13, p13), (14, p14),
                                   (15, p15), (17, p17))
                                  if p},
            "max_abs_err": errs[name],
            "ms": row.get("ms"), "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"), "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms"),
            "shape": f"N={row['N']} D={D} {dtype} B={B} k={k}" if row else None,
        })
    if phases >= set(range(18)):  # a whole run times every kernel at its shape
        missing = [k["name"] for k in kernels
                   if None in (k["ms"], k["plain_ms"], k["bound_ms"], k["launches"])]
        if missing:
            print(f"chip_smoke FAILED: no timed row for {missing}", file=sys.stderr, flush=True)
            return 1
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_all, 3),
          "phase_seconds": seconds, "build_seconds": p0["build_seconds"] if p0 else None})
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
