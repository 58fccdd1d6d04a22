#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py [--seed 7] [--out FILE]

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), prints each kernel's
   ``ptxas -v`` registers and spills (with the entry functions of the
   redesigned ``posting_score``, ``unpack_blocks``, ``flash_attention``
   and four fused scorers),
   the attention kernels' threads and dynamic shared memory per head
   width, and the card's name and power limit.
2. Generates the repository's 1M-document tier
   (``CorpusSpec(num_docs=1_004_721, vocab=50_000, avg_distinct=40)``,
   one ``stream_batches`` batch of all docs) and bulk-builds it.
3. Puts the HOR and the packed index on the card and serves ``BATCHES``
   batches of 8 queries x 3 terms (df band 0.15-0.5, k = 10,
   cap = max_posting_len) through ``make_scorer(engine="fused")``, with
   every kernel launch counter reset just before and read just after.
4. Checks: each kernel was launched; each kernel equals its plain
   PyTorch version on the same routing pairs (values and ids, to the
   bit); the engine's ids equal the dense oracle's (``engine="torch"``),
   scores within rtol 1e-5; no routing overflow; HOR and packed agree.
4b. The reference's own routing budget on each bulk index:
   ``make_adaptive_scorer(index, k=10, cap=max_posting_len)`` over the
   ``BATCHES`` batches ``ADAPTIVE_ROUNDS`` times from its initial budget
   of 64 pairs.  Prints each call's budget before and after, its
   overflow and its ms (host clock with ``synchronize``) beside the
   static-budget batch's ms.  Checks: the first call overflows; the last
   pass overflows nowhere; every call without overflow equals the
   static-budget scorer on the same batch, ids and score bits; the last
   call's kernel launch equals its plain version to the bit.
5. Times each kernel and its plain version with CUDA events, in turns
   (kernel, plain, kernel) beside a reading of the card's clocks, and
   computes its bound at 3.35 TB/s from the bytes this run's pairs must
   move; prints each batch's visited tiles, longest and mean run of
   pairs, and the kernel's CTAs per SM and shared memory per CTA.
6. The live phase, on the same corpus: ``SegmentedIndex.from_host(host,
   seal_layout="banded")`` (one banded segment over all docs), 50,000
   new docs (``CorpusSpec(num_docs=50_000, ..., seed=seed+1)``) ingested
   through a 16,384-doc delta as four 10,000-doc seals (which the tiered
   policy merges), an HOR seal, a packed seal and a 300-doc delta tail,
   with every 64th doc deleted.  Serves ``BATCHES`` batches through
   ``LiveView.topk(mode="candidates")``, then ``BATCHES`` through
   ``mode="dense"``, each mode with every launch counter reset just
   before and read just after.  The kernel calls of each mode's last
   batch are recorded as the path makes them; each is then held to its
   plain version on the same arguments, to the bit, and timed (one
   call repeated: its blocks may sit in L2); each call also prints its
   visited tiles, its longest and mean run of pairs, and its kernel's
   CTAs per SM and shared memory per CTA.  A check batch of HOR-band terms,
   which the served df band lacks, gives the 1M-doc segment's HOR band
   real pairs and is held the same way (not timed).  Checks that all
   four kernels launched, that there was no routing overflow, and that
   ids and scores hold to the gather oracle (``engine="torch"``).
6b. The query weights' kernels (``csrc/query_weights.cu``: ``idf`` and
   ``query_norm``), which every bulk and live batch launches (counted in
   steps 3 and 6): held to their plain versions, on the card and on the
   CPU, to the bit, at the last bulk batch's shapes (timed in turns
   beside the plain versions and, for the norm,
   ``torch.linalg.vector_norm``), over every df up to the live doc
   count, and at every width from 1 to 32.
6c. The serving phase, on the live phase's index (the 1M banded
   segment, the 40,000-doc banded merge, the HOR and packed seals, the
   300-doc delta): ``QueryServer(ServerConfig(batch_size=8,
   n_terms_budget=8, k=10, trace_sample=1))`` after ``warmup()``.  At
   epoch e0 it serves 64 distinct queries (the live batches' 40 rows and
   8 each of 4, 6 and 8 terms in the same df band), each submitted on
   its own and all before pumping (a closed backlog: the latencies
   include queue wait), then 16 of them again.  Under the server's lock
   it ingests 2,048 docs (``seed+2``) and deletes every 64th of them;
   ``IndexMaintenance.run_once`` seals the delta in the index's own
   layout; at epoch e1 it serves the 64 again.  Checks: (a) each fresh
   response equals ``view.topk`` (fused, candidates) on the same padded
   batch of the view pinned for its epoch, ids and score bits; (b) its
   ids equal the gather oracle's but at printed near ties, scores
   within rtol 1e-5, every id live; (c) each cache hit equals the
   response it repeats, bit for bit, at the same epoch; (d) the epochs,
   and how many answers changed between them; (e) each traced
   response's stages sum to its ``latency_us`` (rel 1e-9: the same
   clock readings, summed in floats); (f) with every launch counter
   reset just before each epoch's batches and read just after, each
   micro-batch launched ``idf`` and ``query_norm`` once and each fused
   kernel once per segment (band) of its layout, and the cache hits
   launched nothing; (g) the last e1 micro-batch's kernel calls, the new
   seal's included, each equal their plain versions to the bit; (h) no
   routing overflow (``engine_pair_overflow`` does not grow).  Then the
   full index is serialized (``serialize_segmented``) and restored on
   the card (``restore_segmented``), and the copy answers e1's batches
   with the same ids and score bits.  Prints one ``serving:`` line
   (latency p50/p99 per epoch, QPS, batch fill, cache hit rate, stage
   summary and the score span's children, maintenance, epochs, the
   seconds of each step, peak memory, the card) and the recorded calls
   on ``serving kernel site:`` lines.
7. The paper phase, on the same corpus: the paper's four
   representations as Table 7 compares them, PR (``CooIndex``) and OR
   (``CsrIndex``) each with a B+tree (``SortedLookup``) and a hash
   (``HashLookup``) lookup, COR (``CompactCsrIndex``), HOR and packed,
   plus the direct index.  Table 7's protocol: 8 queries of each of 1-4
   terms (``sample_query_terms``, seed = the term count), k = 10, cap =
   max_posting_len.  With every launch counter reset just before and
   read just after, it runs ``blocked_query_scores`` on the HOR index
   for each of the 32 queries (``posting_score``) and ``unpack_postings``
   over every block of the packed index (``unpack_blocks``).  Checks:
   the seven oracles (``make_scorer(engine="torch")``) give identical
   ids and bit-equal scores; both lookups give the same term ids for
   the queries and for 64 absent hashes; every ``posting_score`` launch
   equals its plain version and the oracle's raw accumulation to the
   bit, with no routing overflow; the decode equals its plain version
   and, term by term, the host's doc ids; ``conjunctive_filter`` gives
   identical ids on all seven and every returned doc holds every query
   term (``BlockedIndex.contains``); ``expand_query`` on each query's
   top 10 equals ``expand_query_scan`` over PR and over OR;
   ``relevance_feedback`` runs; after ``delete_docs`` of each query's
   top doc, no representation returns it.  Prints Tables 5-7 (bytes
   beside the size model, lookup bytes, ms per query) and times both
   kernels, their plain versions and, for the posting scorer, the one
   PyTorch call that computes its sum (``index_add_`` over lanes already
   gathered and multiplied: less work than the kernel does).  The
   decode's bound counts each block's own ``ceil(block * bits / 32)``
   words, as the kernel reads them; the padded rows' bytes are printed
   beside it.
8. The model phase: the three model kernels through their entry points
   (``ops.embedding_bag``, ``ops.pna_multi_agg``, ``ops.attention``) at
   the widths of the repository's model configurations, inputs made on
   the card from ``--seed``: xDeepFM's fused field table (39 fields x
   1,000,000 rows, d = 10, rows padded to 512) under a serve_bulk batch
   of 262,144 one-hot rows and a serve_p99 batch of 512 multi-hot rows
   (8 slots, a quarter padding); PNA's hidden features (d = 75) over
   ogbn-products (2,449,408 nodes, padded degree 64, degrees 37-64) and
   a Reddit minibatch (fanout 15, 10 from 1,024 seeds, a tenth of the
   nodes without neighbours); causal attention at S = 4,096 for
   Qwen3-0.6B (16 q / 8 kv heads, d 128, bf16 at batch 2, f32 at batch
   1) and Gemma-3-4B (8 / 4 heads, d 256, bf16, batch 2, a local layer's
   1,024 window and a global layer).  With every launch counter reset
   just before and read just after, each site is called once; each
   kernel must launch once per site and the six others never.  Checks:
   the bag and PNA equal their plain versions to the bit, attention
   within 2e-4 (f32) or 3e-2 (bf16), and a bf16 site also within one
   bf16 rounding (rtol 8e-3, atol 1e-3) of the plain version run in f32
   on the same inputs; PNA equals the model's segment
   aggregation written as ``scatter_reduce`` (a 1/16 slice of
   ogbn-products); Qwen3's bf16 site equals the models' own
   ``chunked_attention`` on its plain path
   (``models.attention.chunked_attention_plain``) within 3e-2.  Times
   each site in turns with its plain version, beside its bound and the
   one PyTorch call that computes it (``F.embedding_bag``,
   ``F.scaled_dot_product_attention``; none for PNA), and prints each
   attention site's achieved TFLOP/s.
   Attention's bound counts its products on the tensor cores: one bf16
   pass, or three TF32 passes for f32 (3xTF32, as the kernel computes
   them; the f32 CUDA-core time is printed beside it).
   Each bag and PNA site also prints its gather floor
   (``gather_floor_ms``: the 32-byte sectors every valid slot's row
   touches, plus the ids and the output, at 3.35 TB/s), the least a
   gather moves when no row comes from cache; the bound counts each
   distinct row once.
10. The tuning phase, after every other event timing: the tuned-geometry
   path at the 1M tier.  On freshly built HOR and packed indexes,
   ``autotune.autotune_index(index, qh, idf_w, k=10, reps=TUNE_REPS)``
   sweeps the reference's eight candidate configs (the default, tiles 256
   and 1,024, the bitonic reducer, two pairs per step, k_tile 32 with
   each reducer, tile 1,024 with two pairs per step) over the first bulk
   batch, with every launch counter reset just before and read just
   after; the winner goes into a fresh ``TuningTable`` under ("cuda",
   size class, layout), which round-trips through ``save`` / ``load`` in
   a temporary directory.  Checks, in this order: (e) on the live
   phase's index (after the serving phase; then freed), one batch per
   mode with ``tune=TuneConfig(reducer="bitonic")`` and one with each
   winner give the untuned answers, and the bitonic batch's candidate
   kernel calls equal their plain versions; (a) every config gives the
   default config's answer on every bulk batch, ids and score bits, with
   no routing overflow; (b) every bitonic call on the bulk batches
   equals its plain version (``reducer="bitonic"``) to the bit, and the
   successive kernel's ids (and value bits, but at signed zeros, whose
   count is printed), and the ids of a stable ``torch.sort`` of the dense
   kernel's tiled final scores; on each layout's last bulk batch
   (``edge_calls``, a ``tune edge calls <layout>:`` line) the bitonic
   kernel at k_tile 64, both candidate kernels with a NaN rank on 16
   docs (those tiles' CTAs run the network; the successive kernel writes
   (NaN, -1) through each row holding one) and the successive kernel on
   final scores of signed zeros, each equal to its plain version to the
   bit (NaN slots NaN to NaN), the zero and -0.0 slots counted; (c) with
   the loaded table active, ``make_scorer(engine="fused")`` gives the
   empty table's answers
   through the winner's kernel; (d) ``LayoutCostModel().choose`` at the
   1M class gives a ``measured:cuda@...`` reason; (f) the empty table
   is active again.  Prints a ``tune <layout>:`` line per layout (each
   config's median ms, ``max_pairs``, peak memory and candidate bytes
   per query, the winner, default / winner) and a ``tune kernel site:``
   line per bitonic config: its ms by events over the last two bulk
   batches, in turns with the successive kernel on the same pairs and
   with the plain version, its bound and the ``torch.sort`` yardstick.
11. The distributed phase, after step 10 (the live index kept for it):
   the distributed engines as ``DIST_SHARDS`` = 4 shards of one mesh
   (``distributed.shmap.make_mesh(4, device=cuda)``), run in turn on
   this one card; nothing here is a multi-GPU measurement.  (a) On the
   1M host, ``build_doc_sharded_fused`` in HOR and in packed and the
   gather oracle ``build_doc_sharded``; (b) the term-sharded fused
   engine in HOR, packed and banded.  Each serves the first bulk
   batch's 8 queries one per call; ids equal the single-node fused
   engine's (``make_scorer(engine="fused")`` with k + 1, the live
   phase's near-tie rule), scores within rtol 1e-5; HOR and packed
   bit-equal to each other in both shardings.  (c) The live index
   sealed and pinned, ``stack_segment_shards(view, 4)`` and
   ``make_doc_sharded_segment_scorer`` over the same 8 rows: ids equal
   ``view.topk``'s, scores within rtol 1e-5; a ``distributed stack
   group:`` line per group (its slots, bytes and the pairs its budget
   routes a row on all shards, inert slots included).  (d)
   ``MeshServer(topology="doc_stack", n_shards=4, n_replicas=2)`` over
   the live index: ``MESH_QUERIES`` distinct 3-term queries at e0 (a
   closed backlog), ``MESH_REPEATS`` of them again (cache hits, bit-equal,
   no launch), a write step (2,048 docs, every 64th deleted, a
   handoff), the queries at e1; each fresh response's ids equal the
   single-host ``QueryServer`` path over the same pin (``view.topk`` on
   the padded batch of 8), scores within rtol 1e-5 (the count of scores
   that are not bit-equal printed); the replicas' digests agree.  (e)
   The same with ``topology="term_fused"`` on a 50,000-doc index (the
   1m tier's churn batch, ``seed+1``; cut from 1M because this topology
   bulk-builds the live corpus at every handoff).  For every sub-step,
   with every launch counter reset just before and read just after: the
   launches equal what its structure implies (per shard and slot, inert
   ones included) and no routing pair overflows; then its last query is
   scored once more with each kernel call held to its plain version, to
   the bit, as it returns (``distributed kernel site:`` lines).  No
   kernel is timed here: the kernel rows keep the single-node sites'
   times.  Prints a ``distributed <engine>:`` or ``distributed mesh
   <topology>:`` line each (ms a row by the host clock with
   ``synchronize``, launches, peak memory; for a mesh its epochs' p50 /
   p99, QPS, the ``shard_fanout`` / ``shard_sync`` spans, the handoff
   pause) and writes them under ``distributed`` in the JSON.  Each
   also scores its last query once more under torch's sync debug mode
   (``sync_probe``): the spans of that call, the synchronising calls
   torch reports in it by line, and the caching allocator's device
   allocations, frees and retries in it, which say where the host
   waited for the card.
12. The model serving phase, after step 11: the transformer serving
   path (``repro_torch.models.transformer``) on the card.  (a) Each of
   the five LM archs at its smoke config (weights from ``init_params``
   on the card, MoE capacity 16): prefill(16) against prefill(15) +
   ``pad_cache`` + ``decode_step``, rel-to-max < 2e-2 (a GQA prefill
   runs the kernel's f32 p, its decode the plain path's bf16 p, so the
   reference's 1e-3 between two plain paths holds on the CPU only,
   where ``tests/test_torch_models.py`` keeps it); each prefill
   launches the flash kernel once per GQA layer (MLA's none) and no
   other kernel, a decode step nothing; the ring cache decodes as the
   full cache within 2e-3.  (b) Qwen3-0.6B at full
   width (``configs.qwen3_0p6b.make_config("full")``: 28 layers, d
   1,024, 16 / 8 heads of 128, vocab 152,064), f32 masters made on the
   card and served as bf16: one prefill of ``LM_BATCH`` = 8 requests of
   4,096 seeded tokens, ``pad_cache`` to 4,160 slots, ``LM_DECODE`` = 64
   greedy decode steps, with every launch counter reset just before
   each and read just after (28 flash launches a prefill, none a
   step).  Layer 0's and layer 27's kernel calls, recorded as the path
   makes them, are held to ``flash_attention_plain`` within 3e-2, and
   to it run in f32 and rounded to bf16 within ``BF16_RTOL`` /
   ``BF16_ATOL``;
   prefill(4,095) + one decode step is held to prefill(4,096) (rel-to-
   max < 2e-2); the logits are finite.  (c) The same weights on the
   CPU: one request of 128 tokens and 8 decode steps (the card's greedy
   tokens fed to both), every logits row within rel-to-max 2e-2 of the
   card's.  (d) ``splitk_decode_attention`` on a 4-shard mesh over
   layer 0's decode cache as f32 copies (B 8, Hkv 8, S 4,160, D 128,
   uneven lengths), windows 0 and 1,024, equal to ``decode_attention``
   within rtol 2e-4, atol 1e-5.  Prints ``model serve smoke <arch>:``
   lines and one ``model serve qwen3-0.6b:`` line (prefill ms and
   decode ms a step by the host clock with ``synchronize``, decode
   tokens/s, the attention kernel's ms inside one prefill by events
   around each call, the prefill's FLOPs: the reference's cell count
   (2 x active params x tokens, the tied embedding table included)
   beside the matmuls the prefill runs (2 x the layers' weights x
   tokens, the last position's logits, attention), whose rate is
   printed beside 989 TFLOP/s, KV-cache bytes, peak memory, the
   card); layer 0's call is a row-9 site (``model kernel site:``),
   timed in turns with the plain version beside its bound and SDPA.
13. The recsys and GNN serving phase, run right after step 14, while
   nothing else holds device memory: the recsys models
   (``repro_torch.models.recsys``, xDeepFM's lookups through the bag
   kernel) and PNA (``repro_torch.models.gnn``, each layer's four
   aggregations one PNA kernel launch) on the card, weights made once on
   the CPU from ``--seed`` and copied to the card, inputs from
   ``--seed``, TF32 off.  (a) The five archs at their smoke configs, on
   the card and on the CPU: SASRec, BERT4Rec, DIEN and xDeepFM (also
   with ``n_hot=3``) through ``configs.base.recsys_serve_fn`` at
   serve_p99 and ``recsys_retrieval_fn`` at retrieval_cand; PNA through
   ``node_logits`` at full_graph_sm, minibatch_lg (the port's
   ``NeighborSampler``) and ogb_products, and ``graph_loss`` at
   molecule.  Logits within rel-to-max ``REC_TOL``; top-k ids equal but
   at adjacent scores within ``REC_NEAR_TIE`` relative (printed), scores
   within rtol 1e-5; each call launches the bag kernel once (xDeepFM) or
   the PNA kernel once a layer, and nothing else.  (b) The four recsys
   archs at full width (``make_config("full")``: 1,000,448-row item
   tables, xDeepFM's 39,000,064 x 10 field table) at serve_p99 (512
   users), held to the CPU as in (a); xDeepFM also at serve_bulk
   (262,144 users in 128 chunks of 2,048), SASRec also at retrieval_cand
   (one user against 1,000,448 candidates, k 100, held to the CPU).
   With every launch counter reset just before a batch and read just
   after: xDeepFM launches the bag kernel once a user chunk and nothing
   else, SASRec, BERT4Rec and DIEN nothing (printed); the first and last
   chunk's bag calls, recorded as the path makes them, equal
   ``embedding_bag_plain`` to the bit.  (c) PNA at full width
   (``configs.pna.make_config("full", shape)``: d 75, 4 layers) at
   ogb_products (``make_synthetic_graph(2,449,029, 61,859,140, 100, 47)``
   through ``fullgraph_batch``, padded to 2,449,408 nodes and 61,859,328
   edges with trash edges at node N) and minibatch_lg (a
   ``NeighborSampler`` block of 1,024 seeds, fanout 15, 10, over a
   Reddit-sized graph of 232,965 nodes with ``REDDIT_EDGES`` edges, the
   cut printed under ``reduced``).  The graphs are made on the host
   while (a) and (b) run.  One forward holds each layer's call to
   ``pna_multi_agg_plain`` to the bit as it returns (none is kept), and
   at ogb_products layer 0's output to the port's ``core.segments``
   reductions over the same edge list (its first 1/16 of the nodes)
   within 1e-5; a second forward is counted (4 PNA launches, nothing
   else) and timed; minibatch_lg's logits are held to the CPU's within
   ``REC_TOL``.  Prints ``model serve recsys <arch> <shape>:`` lines (ms
   a batch by the host clock with ``synchronize``, users/s, the bag
   kernel's ms by events and its share, peak memory, the card),
   ``model serve gnn pna <shape>:`` lines (forward ms, ``nbr`` build ms
   and K, the PNA kernel's ms a layer by events and its share, peak
   memory, the card) and the step's wall time, peak memory and what
   earlier steps held; the first bag call of each xDeepFM batch and
   layer 0's PNA call of each graph are ``model kernel site:`` rows,
   timed in turns with their plain versions beside their bound, gather
   floor and library time.
9. Last, after every event timing (a trace slows the launches timed
   after it): one ``torch.profiler`` trace of each live call site of
   the four fused kernels, of the last bulk batch's candidate call per
   layout, of each bitonic site's last call, of both side kernels, of
   the two weights kernels and of every model site, step 12's included
   (``MODEL_TRACED`` calls after one warm-up), printed as device ms per
   launch beside the event ms (for the bag and PNA sites with the
   host's share of the event time).  Then one full-width Qwen3 prefill
   and one decode step, each in a trace of its own (``model serve trace
   qwen3-0.6b:``): each call's device-busy share of its kernels' span
   and of its host time, and the attention kernel's share of the
   prefill's device time.  Then, each in a trace of its own, step 13's
   xDeepFM serve_p99 batch and one serve_bulk chunk and a PNA forward
   over each full-width graph (``model serve trace recsys/gnn:``): each
   call's device-busy share and its bag or PNA kernel's device ms a
   launch, which is that site's device time.
   Then per-phase wall
   times, a ``{"kernels": [...]}`` line with all nine kernels, the two
   bitonic entry points and the two weights kernels (means per launch
   over every counted call site of the paths; ``device_ms`` where every
   site was traced) and, last, ``{"ok": true, "device": {...}}``.
14. The training phase, run first, right after step 1, while nothing
   else holds the card's memory, with torch's deterministic algorithms
   on while it runs (as ``launch.train.deterministic`` sets them; the
   cuBLAS workspace is left at torch's default for the later steps).  (a) Each backward rule of the
   three ``kernels.ops`` Functions (torch ops, not a TPU kernel) at a
   model site, on the card, against autograd of the plain version on
   the same inputs and output gradient: attention at a Qwen3 layer (1 x
   16/8 heads x 4,096 x 128, bf16, causal; plain: the chunked
   reference arithmetic) within 2e-2 rel-to-max; the bag at an xDeepFM
   ``train_batch`` lookup (65,536 x 39 one-hot bags over the fused
   39M-row table) within 1e-6 (autograd adds a row's slots in another
   order); PNA at the Reddit block's layer (minibatch_lg's 169,984
   nodes and 168,960 random edges, relu messages with ties at 0;
   plain: ``pna_multi_agg_autograd`` over the whole block, the
   aggregation the rule recomputes in node chunks) within 1e-4.  Each forward launches
   its kernel once; ``train rule <kernel>:`` lines give the errors and
   both backward passes' ms by events.  (b) Qwen3-0.6B at full width
   (28 layers, d 1,024, vocab 152,064), seq 4,096, the batch cut from
   ``train_4k``'s 256 to the largest of ``TRAIN_BATCHES`` whose step
   fits (printed): one ``optimizer.make_train_step`` step, every
   counter set to 0 just before and read just after, launches the
   attention kernel twice a layer (the forward, and the layer's
   recomputation in the backward pass: ``remat``) and nothing else;
   every gradient leaf finite, ``wq``/``wk``/``wv`` of every layer
   nonzero; ``TRAIN_STEPS`` steps of ``loop.fit`` over that step on a
   repeated batch, a checkpoint every ``TRAIN_CKPT_EVERY`` steps in a
   temp dir, counted the same way; the loss descends.  (c) One
   step run twice from the same state gives the same loss and parameter
   bits.  (d) The last checkpoint dropped, ``fit`` resumes from the one
   before and lands on the identical loss, the replayed steps counted
   too.  ``train qwen3-0.6b:`` gives
   the losses, step ms, tokens/s and peak memory.  (e)
   ``launch.train.main([..., "--steps", "3"])`` on the card at smoke
   scale for each of the ten archs, each ending with a finite loss.
   (f) xDeepFM at ``train_batch`` (65,536, in ``XDEEPFM_MICROBATCHES``
   micro-batches: the same gradient in a quarter of the memory) and PNA
   at minibatch_lg (the launcher's synthetic graph of that shape), both
   at full width, ``REC_TRAIN_STEPS`` steps each, every launch counter
   set to 0 before and read after: one bag launch a micro-batch, four
   PNA launches (one a layer) a step, nothing else.  Every line carries
   the card's name and power limit; ``train step:`` gives the wall time.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Every failed check raises.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device-memory rate
F32_OPS_PER_S = 67e12         # H100 SXM f32 rate outside the tensor cores
NUM_DOCS, VOCAB, AVG_DISTINCT = 1_004_721, 50_000, 40
BATCH, TERMS, K = 8, 3, 10
BATCHES = 5                   # query batches served per layout
REPS = 5                      # timing rounds over all batches per turn
MODEL_TRACED = 3              # traced calls per model site (step 9)
ADAPTIVE_ROUNDS = 2           # passes of the adaptive scorer over BATCHES
TUNE_REPS = 3                 # timed calls per config of the sweep (step 10)
KERNELS = {
    "fused_topk_blocked": ("hor", "src/repro/kernels/fused_decode_score.py:513"),
    "fused_topk_packed": ("packed",
                          "src/repro/kernels/fused_decode_score.py:589"),
}
DENSE_KERNELS = {
    "fused_score_blocked": ("hor",
                            "src/repro/kernels/fused_decode_score.py:309"),
    "fused_score_packed": ("packed",
                           "src/repro/kernels/fused_decode_score.py:342"),
}
FUSED_KERNELS = (*KERNELS, *DENSE_KERNELS)
# the bitonic epilogue of the candidate kernels (reducer="bitonic"): its own
# entry points and launch counters (``launches_bitonic``)
BITONIC_KERNELS = {
    "fused_topk_blocked_bitonic": (
        "hor", "src/repro/kernels/fused_decode_score.py:194",
        "fused_topk_blocked"),
    "fused_topk_packed_bitonic": (
        "packed", "src/repro/kernels/fused_decode_score.py:194",
        "fused_topk_packed"),
}
PAPER_KERNELS = {
    "posting_score": "src/repro/kernels/posting_score.py:87",
    "unpack_blocks": "src/repro/kernels/packed_postings.py:46",
}
MODEL_KERNELS = {
    "embedding_bag": "src/repro/kernels/embedding_bag.py:46",
    "pna_multi_agg": "src/repro/kernels/segment_multi_agg.py:59",
    "flash_attention": "src/repro/kernels/flash_attention.py:78",
}
ALL_KERNELS = (*FUSED_KERNELS, *BITONIC_KERNELS, *PAPER_KERNELS,
               *MODEL_KERNELS)
# the query weights' kernels (csrc/query_weights.cu): every bulk and live
# batch launches them; they replace XLA code of the reference, not Pallas
WEIGHT_KERNELS = {
    "idf": "src/repro/core/query.py:33",
    "query_norm": "src/repro/core/live_index.py:134",
}
# whose ptxas entry lines are printed
REDESIGNED = ("posting_score", "unpack_blocks", "flash_attention",
              *FUSED_KERNELS)
# live phase: the 1m tier's ingest batch and delta (benchmarks/campaign.py)
NEW_DOCS, DELTA_DOCS = 50_000, 16_384
SEALS = ((0, 10_000, None), (10_000, 20_000, None), (20_000, 30_000, None),
         (30_000, 40_000, None), (40_000, 44_850, "hor"),
         (44_850, 49_700, "packed"))     # then 49_700..50_000 stay in delta
NEAR_TIE = 1e-6
# paper phase: Table 7's seven indexes and its protocol
# (benchmarks/table7_query.py)
SEVEN = ("pr_btree", "pr_hash", "or_btree", "or_hash", "cor", "hor",
         "packed")
SIZE_LAYOUT = {"pr_btree": "pr", "pr_hash": "pr", "or_btree": "or",
               "or_hash": "or", "cor": "cor", "hor": "hor",
               "packed": "packed"}
PAPER_TERMS = (1, 2, 3, 4)
# model phase: the model kernels at the widths of the repository's configs
XDEEPFM_FIELDS, XDEEPFM_VOCAB, XDEEPFM_DIM = 39, 1_000_000, 10  # xdeepfm.py
XDEEPFM_BULK, XDEEPFM_P99, MULTI_HOT = 262_144, 512, 8
PNA_DIM = 75                                     # pna.py d_hidden
OGB_NODES, OGB_K, OGB_DEG = 2_449_408, 64, (37, 64)   # pna.py ogb_products
MB_SEEDS, MB_FANOUT = 1024, (15, 10)             # pna.py minibatch_lg
MB_NODES = MB_SEEDS * (1 + 15 + 150)
ATTN_SEQ = 4096                                  # the LM configs' train_4k
ATTN_SITES = {       # site: (batch, Hq, Hkv, head dim, window, dtype name)
    "attn@qwen3_0.6b": (2, 16, 8, 128, 0, "bfloat16"),
    "attn@gemma3_4b_local": (2, 8, 4, 256, 1024, "bfloat16"),
    "attn@gemma3_4b_global": (2, 8, 4, 256, 0, "bfloat16"),
    "attn@qwen3_0.6b_f32": (1, 16, 8, 128, 0, "float32"),
}
# a bf16 site's kernel against the plain version in f32, rounded to bf16:
# one bf16 rounding apart at most (2**-7 of the value), above a floor
BF16_RTOL, BF16_ATOL = 8e-3, 1e-3
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
# H100 SXM dense TF32 tensor-core rate (NVIDIA's data sheet): an f32
# product to f32 accuracy takes three TF32 passes (3xTF32), the least time
# this card can do it in
TF32_OPS_PER_S = 495e12


def smi(fields: str) -> str:
    """One ``nvidia-smi`` reading of ``fields`` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, calls, reps):
    """Mean ms per call of ``fn(*c)`` over ``reps`` rounds of ``calls``
    (round-robin over distinct batches, so each call finds the previous
    batch's blocks, not its own, in L2)."""
    import torch
    for c in calls:                       # warm-up
        fn(*c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for c in calls:
            fn(*c)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * len(calls))


def kernel_work(kind, args, tile, q_real):
    """(bytes, ops) one call must move/do at least, from this call's
    pairs: each distinct routed block read once, the real pairs'
    routing rows, norm/rank of visited tiles, candidates written."""
    import torch
    if kind == "hor":
        (docs, tfs, pb, pt, pqw, pcap, norm, rank, qnorm, num_docs,
         k_tile) = args
        block_bytes = docs.shape[1] * 4 + tfs.shape[1] * 4
        pair_bytes = 4 + 4 + 4 + 4 * pqw.shape[1]
    else:
        (packed, tfs, pb, pt, pqw, pcap, bits, base, count, norm, rank,
         qnorm, num_docs, block, k_tile) = args
        block_bytes = packed.shape[1] * 4 + tfs.shape[1] * 2
        pair_bytes = 4 + 4 + 4 + 4 * pqw.shape[1] + 12
    n_tiles = -(-num_docs // tile)
    real = int(torch.searchsorted(
        pt, torch.tensor([n_tiles], dtype=pt.dtype, device=pt.device)))
    blocks = int(torch.unique(pb[:real]).numel())
    tiles = int(torch.unique(pt[:real]).numel())
    q = pqw.shape[1]
    out_bytes = q * n_tiles * k_tile * 8
    nbytes = (blocks * block_bytes + real * pair_bytes + tiles * tile * 8
              + q * 4 + out_bytes)
    # per posting lane: Q products + Q adds; per (query, doc) of a
    # visited tile: the 5-op scoring tail and k_tile compares
    ops = (blocks * 128 * 2 * q_real
           + q_real * tiles * tile * (5 + k_tile))
    return nbytes, ops, real, blocks, tiles


def dense_work(kind, args, tile, q_real):
    """(bytes, ops) one dense call must move/do at least: each distinct
    routed block read once, the real pairs' routing rows, and the
    Q x num_docs f32 scores written."""
    import torch
    if kind == "hor":
        docs, tfs, pb, pt, pqw, pcap, num_docs = args
        block_bytes = docs.shape[1] * 4 + tfs.shape[1] * 4
        pair_bytes = 4 + 4 + 4 + 4 * pqw.shape[1]
    else:
        (packed, tfs, pb, pt, pqw, pcap, bits, base, count, num_docs,
         block) = args
        block_bytes = packed.shape[1] * 4 + tfs.shape[1] * 2
        pair_bytes = 4 + 4 + 4 + 4 * pqw.shape[1] + 12
    n_tiles = -(-num_docs // tile)
    real = int(torch.searchsorted(
        pt, torch.tensor([n_tiles], dtype=pt.dtype, device=pt.device)))
    blocks = int(torch.unique(pb[:real]).numel())
    q = pqw.shape[1]
    nbytes = blocks * block_bytes + real * pair_bytes + q * num_docs * 4
    # per posting lane of a routed pair: one multiply-add per real query
    ops = real * 128 * 2 * q_real
    return nbytes, ops, real, blocks


def run_stats(pair_tile, num_docs, tile):
    """A fused call's runs: the tiles its real pairs visit, and the
    longest and mean run of pairs per visited tile."""
    import torch
    n_tiles = -(-num_docs // tile)
    pt = pair_tile[pair_tile < n_tiles].long()
    runs = torch.bincount(pt, minlength=n_tiles) if pt.numel() else \
        torch.zeros(n_tiles, dtype=torch.int64, device=pair_tile.device)
    visited = int((runs > 0).sum())
    return {"visited_tiles": visited, "longest_run": int(runs.max()),
            "mean_run": pt.numel() / visited if visited else 0.0}


# kernels' symbols, as the profiler names their device activity
SYMBOLS = {"posting_score": "posting_score_kernel",
           "unpack_blocks": "unpack_kernel",
           "idf": "idf_kernel", "query_norm": "norm_kernel",
           "fused_topk_blocked":
               "score_kernel<fused_score::TopkOut, fused_score::HorBlocks",
           "fused_topk_packed":
               "score_kernel<fused_score::TopkOut, fused_score::PackedBlocks",
           "fused_score_blocked":
               "score_kernel<fused_score::DenseOut, fused_score::HorBlocks",
           "fused_score_packed":
               "score_kernel<fused_score::DenseOut, fused_score::PackedBlocks",
           "fused_topk_blocked_bitonic":
               "score_kernel<fused_score::BitonicOut, fused_score::HorBlocks",
           "fused_topk_packed_bitonic":
               "score_kernel<fused_score::BitonicOut, "
               "fused_score::PackedBlocks",
           "embedding_bag": "bag_kernel", "pna_multi_agg": "pna_kernel",
           "flash_attention": "flash_"}


def device_ms(runs):
    """Mean device time per launch of each kernel alone (no wrapper
    work, no other kernel), for every ``key: (kernel, fn, calls)`` or
    ``key: (kernel, fn, calls, warm)`` of ``runs``, from ONE
    ``torch.profiler`` trace that runs ``fn(*c)`` over ``calls`` for
    each key in turn: the trace's kernels named ``SYMBOLS[kernel]``, in
    launch order, are the keys' launches in order.  The first ``warm``
    calls of a key (default 0) are traced but not counted.  None for a
    key whose launches the trace does not show.  A trace slows the
    launches timed after it, so this runs once, after every event timing
    of the script."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10_000)     # a trace can miss its first kernel
        for _, fn, calls, *_ in runs.values():
            for c in calls:
                fn(*c)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.events() if e.device_type == cuda),
                    key=lambda e: e.time_range.start)
    queues = {k: [e.time_range.elapsed_us() for e in events
                  if SYMBOLS[k] in e.name]
              for k in {run[0] for run in runs.values()}}
    out = {}
    for key, (kernel, _, calls, *warm) in runs.items():
        mine, queues[kernel] = (queues[kernel][:len(calls)],
                                queues[kernel][len(calls):])
        n = len(calls) - sum(warm)
        mine = mine[len(mine) - n:] if len(mine) == len(calls) else []
        out[key] = (sum(mine) / n / 1e3
                    if mine and sum(mine) > 0 else None)
    return out


def time_in_turns(run, run_plain, calls):
    """Kernel, plain, kernel timings (ms per call) of ``run(*c)`` and
    ``run_plain(*c)`` over ``calls`` (CUDA events, wrapper included),
    and the card's clocks read right after, while it is warm."""
    ms_first = event_ms(run, calls, REPS)
    plain_ms = event_ms(run_plain, calls, 1)
    ms_second = event_ms(run, calls, REPS)
    clocks = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    return (ms_first + ms_second) / 2, [ms_first, ms_second], plain_ms, \
        clocks


def wrappers():
    """Each kernel's wrapper, by name (its ``.launches`` count)."""
    from repro_torch.kernels import fused_decode_score as fds
    from repro_torch.kernels import packed_postings, posting_score
    out = {n: getattr(fds, n) for n in FUSED_KERNELS}
    out.update(posting_score=posting_score.posting_score,
               unpack_blocks=packed_postings.unpack_blocks)
    from repro_torch.kernels import embedding_bag, flash_attention
    from repro_torch.kernels import segment_multi_agg
    out.update(embedding_bag=embedding_bag.embedding_bag,
               pna_multi_agg=segment_multi_agg.pna_multi_agg,
               flash_attention=flash_attention.flash_attention)
    from repro_torch.core import query
    out.update(idf=query.idf, query_norm=query.query_norm)
    return out


def counters():
    """Each kernel's launch counter, by name: (wrapper, attribute); the
    bitonic epilogue counts on its candidate wrapper's
    ``launches_bitonic``."""
    out = {n: (fn, "launches") for n, fn in wrappers().items()}
    out.update({n: (out[base][0], "launches_bitonic")
                for n, (_, _, base) in BITONIC_KERNELS.items()})
    return out


def reset_launches():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_launches():
    return {n: getattr(fn, attr) for n, (fn, attr) in counters().items()}


def near_tie_swaps(ids, scores, ref_ids, ref_scores, k):
    """Positions where the engine's ids differ from the oracle's.  Each
    must sit at an oracle near-tie — its score within NEAR_TIE relative
    of an adjacent oracle score (the oracle has k+1 entries) — where the
    fused engines' other grouping of a doc's adds may swap two docs; any
    other difference raises.  Scores agree within rtol 1e-5."""
    import numpy as np
    np.testing.assert_allclose(scores, ref_scores[:, :k], rtol=1e-5, atol=0)
    cases = []
    for q, j in zip(*np.nonzero(ids != ref_ids[:, :k])):
        s = ref_scores[q]
        near = [i for i in (j - 1, j + 1)
                if abs(s[j] - s[i]) <= NEAR_TIE * abs(s[j])]
        if not near:
            raise AssertionError(
                f"query {q} rank {j}: engine id {ids[q, j]} != oracle id "
                f"{ref_ids[q, j]} at score {s[j]!r}, no near tie")
        cases.append({"query": int(q), "rank": int(j),
                      "engine_id": int(ids[q, j]),
                      "oracle_id": int(ref_ids[q, j]),
                      "oracle_score": float(s[j]),
                      "neighbour_score": float(s[near[0]])})
    return cases


def same_candidates(a, b):
    import torch
    (va, ia), (vb, ib) = a, b
    if not (torch.equal(ia, ib) and torch.equal(va.isfinite(),
                                                vb.isfinite())):
        return False, float("inf")
    fin = va.isfinite()
    err = float((va[fin] - vb[fin]).abs().max()) if fin.any() else 0.0
    bits_equal = torch.equal(va.view(torch.int32), vb.view(torch.int32))
    return bits_equal, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="also write the measurements to this JSON file")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import build, layouts, query
    from repro_torch.kernels import cuda_build, fused_decode_score as fds
    from repro_torch.kernels import ops
    from repro_torch.text import corpus

    phase_s = {}
    t_phase = time.perf_counter()

    report: dict = {}
    dev = torch.device("cuda", 0)

    # 1. kernels + card ---------------------------------------------------
    t0 = time.perf_counter()
    ptxas = cuda_build.build()
    report["build_s"] = time.perf_counter() - t0
    for name, log in ptxas.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or \
                    (name in REDESIGNED and "Compiling entry" in line):
                print(f"ptxas {name}: {line.strip()}")
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import posting_score as tps
    print(f"posting_score: 128 threads, {tps.TILE * 4} B dynamic shared "
          f"memory per CTA (tile {tps.TILE})")
    for d in tfa.HEAD_DIMS:
        for dtype in tfa.DTYPES:
            smem, threads = tfa.kernel_shape(d, dtype)
            print(f"flash_attention D={d} {str(dtype)[6:]}: {threads} "
                  f"threads, {smem} B dynamic shared memory per CTA")
    card = smi("name,power.limit")
    print(f"card: {card}")
    print(f"nvcc build: {report['build_s']:.2f} s "
          f"({len(ptxas)} kernels compiled)")

    # 14. training, first, while nothing else holds the card's memory
    # (Qwen3's step takes most of it); torch's deterministic algorithms
    # are on only while it runs
    t0 = time.perf_counter()
    train_phase(a.seed, dev, report, card)
    torch.cuda.empty_cache()
    phase_s["train"] = time.perf_counter() - t0
    print(f"phase train: {phase_s['train']:.1f} s")
    t_phase += phase_s["train"]

    # 13. recsys and GNN serving, next, while nothing else is held
    t0 = time.perf_counter()
    rg_sites, rg_keep = rec_gnn_phase(a.seed, dev, report, card)
    torch.cuda.empty_cache()
    phase_s["rec_gnn_serve"] = time.perf_counter() - t0
    print(f"phase rec_gnn_serve: {phase_s['rec_gnn_serve']:.1f} s")
    t_phase += phase_s["rec_gnn_serve"]

    # 2. corpus -----------------------------------------------------------
    t0 = time.perf_counter()
    spec = corpus.CorpusSpec(num_docs=NUM_DOCS, vocab=VOCAB,
                             avg_distinct=AVG_DISTINCT, seed=a.seed)
    host = build.bulk_build(next(corpus.stream_batches(
        spec, batch_docs=spec.num_docs)))
    report["corpus"] = {"docs": host.num_docs, "terms": host.num_terms,
                        "postings": host.num_postings,
                        "max_posting_len": host.max_posting_len,
                        "build_s": time.perf_counter() - t0}
    print(f"corpus: {json.dumps(report['corpus'])}")
    cap = host.max_posting_len
    batches = [corpus.sample_query_terms(
        host.df, host.term_hashes, BATCH, TERMS, df_band=(0.15, 0.5),
        num_docs=host.num_docs, seed=a.seed * 1000 + i)
        for i in range(BATCHES)]

    # 3-4. each layout on the card ----------------------------------------
    sites, bulk_traces, static = [], {}, {}
    weight_launches = dict.fromkeys(WEIGHT_KERNELS, 0)
    ids_by_layout = {}
    builders = {"hor": layouts.build_blocked,
                "packed": layouts.build_packed_csr}
    for name, (kind, _) in KERNELS.items():
        t0 = time.perf_counter()
        ix = builders[kind](host, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        wrapper = getattr(fds, name)
        plain = getattr(fds, name + "_plain")
        fused = query.make_scorer(ix, k=K, cap=cap, engine="fused",
                                  return_stats=True)
        oracle = query.make_scorer(ix, k=K, cap=cap, engine="torch")

        fused(batches[0])                 # warm-up (allocator, lib load)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        results, e2e_ms = [], []
        for qb in batches:
            t0 = time.perf_counter()
            res, stats = fused(qb)
            torch.cuda.synchronize()
            e2e_ms.append((time.perf_counter() - t0) * 1e3)
            results.append((res, stats))
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        for k in WEIGHT_KERNELS:
            if launches[k] < len(batches):
                raise AssertionError(f"{kind}: {k} launched {launches[k]} "
                                     f"times for {len(batches)} batches")
            weight_launches[k] += launches[k]
        if launches[name] < len(batches):
            raise AssertionError(f"{name}: {launches[name]} launches for "
                                 f"{len(batches)} batches")
        if any(launches[n] for n in ALL_KERNELS if n != name):
            raise AssertionError(f"{kind} index launched {launches}")

        ids_all, oracle_ms = [], []
        for qb, (res, stats) in zip(batches, results):
            if stats["pair_overflow"] != 0:
                raise AssertionError(f"{kind}: overflow {stats}")
            ids = res.doc_ids.cpu().numpy()
            sc = res.scores.cpu().numpy()
            if ids.shape != (BATCH, K) or not np.isfinite(sc).all():
                raise AssertionError(f"{kind}: bad result {ids.shape}")
            if not ((ids >= 0) & (ids < host.num_docs)).all():
                raise AssertionError(f"{kind}: ids out of range / missing")
            t0 = time.perf_counter()
            ref = oracle(qb)
            ref_ids = ref.doc_ids.cpu().numpy()
            oracle_ms.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(ids, ref_ids):
                raise AssertionError(f"{kind}: engine ids != oracle ids\n"
                                     f"{ids}\n{ref_ids}")
            np.testing.assert_allclose(sc, ref.scores.cpu().numpy(),
                                       rtol=1e-5, atol=0)
            ids_all.append(ids)
        ids_by_layout[kind] = np.stack(ids_all)
        if kind == "hor":
            # the single-node fused engine's answers to the first batch,
            # with one more rank for the near-tie rule (step 11)
            one = query.make_scorer(ix, k=K + 1, cap=cap,
                                    engine="fused")(batches[0])
            single_node = (one.doc_ids.cpu().numpy(),
                           one.scores.cpu().numpy())

        # kernel vs plain on the very same routing pairs
        calls, work, pairs_ms = [], [], []
        for qb in batches:
            t0 = time.perf_counter()
            qh = layouts.hash_tensor(qb, dev)
            term_ids, idf_t = query.lookup_query(ix, qh)
            _, _, args, kw, _ = ops.fused_topk_args(ix, term_ids, idf_t,
                                                    cap, K)
            torch.cuda.synchronize()
            weight_args = (ix.term_df(term_ids), host.num_docs, idf_t)
            pairs_ms.append((time.perf_counter() - t0) * 1e3)
            calls.append(args)
            work.append(kernel_work(kind, args, kw["tile"], BATCH))
        max_err, bit_equal = 0.0, True
        for args in calls:
            got = wrapper(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            eq, err = same_candidates(got, want)
            bit_equal &= eq
            max_err = max(max_err, err)
        if not bit_equal:
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {max_err})")
        # in turns (kernel, plain, kernel) on this card, with the clocks
        # read while the card is warm
        ms, turns, plain_ms, clocks = time_in_turns(
            lambda *c: wrapper(*c, **kw), lambda *c: plain(*c, **kw), calls)
        runs = [site_stats(name, c, host.num_docs, kw["tile"])
                for c in calls]
        nbytes = float(np.mean([w[0] for w in work]))
        nops = float(np.mean([w[1] for w in work]))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        layout_report = {
            "index_build_s": build_s, "device_bytes": ix.nbytes(),
            "words_per_block": getattr(ix, "words_per_block", None),
            "posting_bytes": ix.posting_bytes(),
            "e2e_ms_per_batch": e2e_ms,
            "pairs_ms_per_batch": pairs_ms,
            "oracle_ms_per_batch": oracle_ms,
            "launches": launches[name],
            "real_pairs_per_batch": [w[2] for w in work],
            "distinct_blocks_per_batch": [w[3] for w in work],
            "visited_tiles_per_batch": [w[4] for w in work],
            "longest_run_per_batch": [r["longest_run"] for r in runs],
            "mean_run_per_batch": [r["mean_run"] for r in runs],
            "ctas_per_sm": runs[0]["ctas_per_sm"],
            "smem_bytes": runs[0]["smem_bytes"],
            "max_pairs": int(calls[0][2].shape[0]),
            "bytes_per_batch": nbytes, "ops_per_batch": nops,
            "kernel_ms": ms, "kernel_ms_turns": turns,
            "plain_ms": plain_ms,
            "clocks_sm_mem_power_temp": clocks,
            "bound_ms": max(t_bytes, t_ops),
            "max_memory_allocated": peak,
        }
        report[kind] = layout_report
        print(f"{kind}: {json.dumps(layout_report)}")
        static[kind] = (results, e2e_ms)
        site = f"bulk:{name}@{host.num_docs}"
        sites.append({
            "site": site, "kernel": name,
            "launches": launches[name], "max_abs_err": max_err,
            "kernel_ms": ms, "plain_ms": plain_ms, "t_bytes_ms": t_bytes,
            "t_ops_ms": t_ops})
        # the last batch's call, traced at the end for its device time
        bulk_traces[site] = (name, functools.partial(wrapper, **kw),
                             [calls[-1]])
        del ix, fused, oracle, calls
        torch.cuda.empty_cache()

    if not np.array_equal(ids_by_layout["hor"], ids_by_layout["packed"]):
        raise AssertionError("HOR and packed engines rank differently")
    # 4b, each index built again after both layouts' timings, so that no
    # other work runs between them
    for kind, build_index in builders.items():
        ix = build_index(host, device=dev)
        report[f"adaptive_{kind}"] = adaptive_budget(ix, cap, batches,
                                                     *static[kind], kind)
        del ix
        torch.cuda.empty_cache()
    del static
    phase_s["bulk"] = time.perf_counter() - t_phase
    print(f"phase bulk: {phase_s['bulk']:.1f} s")

    t_phase = time.perf_counter()
    live_sites, traces, si = live_phase(host, batches, a.seed, dev, report)
    sites += live_sites
    traces.update(bulk_traces)
    del bulk_traces
    for mode, counted in report["live"]["launches"].items():
        for k in WEIGHT_KERNELS:
            if counted[k] < len(batches):
                raise AssertionError(f"live {mode}: {k} launched "
                                     f"{counted[k]} times")
            weight_launches[k] += counted[k]
    w_sites, w_traces = weight_sites(*weight_args, weight_launches,
                                     report["live"]["live_docs"])
    sites += w_sites
    traces.update(w_traces)
    del weight_args
    phase_s["live"] = time.perf_counter() - t_phase
    print(f"phase live: {phase_s['live']:.1f} s")

    t_phase = time.perf_counter()
    serving_phase(si, batches, a.seed, dev, report, card)
    torch.cuda.empty_cache()
    phase_s["serving"] = time.perf_counter() - t_phase
    print(f"phase serving: {phase_s['serving']:.1f} s")

    t_phase = time.perf_counter()
    paper_sites, paper_traces = paper_phase(host, dev, report)
    sites += paper_sites
    traces.update(paper_traces)
    phase_s["paper"] = time.perf_counter() - t_phase
    print(f"phase paper: {phase_s['paper']:.1f} s")

    t_phase = time.perf_counter()
    model_sites, model_traces = model_phase(a.seed, dev, report)
    sites += model_sites
    traces.update(model_traces)
    phase_s["model"] = time.perf_counter() - t_phase
    print(f"phase model: {phase_s['model']:.1f} s")

    t_phase = time.perf_counter()
    state = tuning_sweep(host, cap, batches, dev)
    tune_live = tuning_live(si, batches, state)
    torch.cuda.empty_cache()
    tune_sites, tune_traces = tuning_checks(host, batches, cap, dev, report,
                                            state)
    report["tuning"]["live"] = tune_live
    del state
    torch.cuda.empty_cache()
    sites += tune_sites
    traces.update(tune_traces)
    phase_s["tuning"] = time.perf_counter() - t_phase
    print(f"phase tuning: {phase_s['tuning']:.1f} s")

    t_phase = time.perf_counter()
    distributed_phase(host, batches, si, single_node, a.seed, dev, report,
                      card)
    del si
    torch.cuda.empty_cache()
    phase_s["distributed"] = time.perf_counter() - t_phase
    print(f"phase distributed: {phase_s['distributed']:.1f} s")

    t_phase = time.perf_counter()
    lm_site, lm_call, lm_keep = lm_phase(a.seed, dev, report, card)
    sites.append(lm_site)
    traces[lm_call[0]] = lm_call[1]
    del lm_call
    torch.cuda.empty_cache()
    phase_s["lm_serve"] = time.perf_counter() - t_phase
    print(f"phase lm_serve: {phase_s['lm_serve']:.1f} s")

    # last, after every event timing: the traced sites' device time
    t_phase = time.perf_counter()
    dev_ms = device_ms(traces)
    for site in sites:
        if site["site"] in dev_ms:
            site["device_ms"] = dev_ms[site["site"]]
            host = ""
            if site["kernel"] in ("embedding_bag", "pna_multi_agg") and \
                    site["device_ms"] is not None:
                # the share of the call's event time the device is not
                # running the kernel: the host's, when calls run back to back
                site["host_share"] = 1 - site["device_ms"] / site["kernel_ms"]
                host = (f", host share {site['host_share']:.3f}, gather "
                        f"floor {site['gather_floor_ms']:.4f} ms")
            print(f"device time: {site['site']}: {site['kernel_ms']:.4f} "
                  f"ms per call by events (wrapper included), device "
                  f"{site['device_ms']} ms, bound "
                  f"{max(site['t_bytes_ms'], site['t_ops_ms']):.4f} ms, "
                  f"library {site.get('library_ms')} ms{host}")
    report["device_ms_by_site"] = dev_ms
    del traces
    torch.cuda.empty_cache()
    report["lm_serve"]["trace"] = lm_trace(lm_keep)
    del lm_keep
    torch.cuda.empty_cache()
    report["rec_gnn_serve"]["trace"] = rec_gnn_trace(rg_keep, rg_sites, dev)
    del rg_keep
    torch.cuda.empty_cache()
    for site in rg_sites:
        print(f"device time: {site['site']}: {site['kernel_ms']:.4f} ms per "
              f"call by events (wrapper included), device "
              f"{site.get('device_ms')} ms, bound {site['bound_ms']:.4f} ms, "
              f"library {site['library_ms']} ms, host share "
              f"{site.get('host_share')}, gather floor "
              f"{site['gather_floor_ms']:.4f} ms")
    sites += rg_sites
    phase_s["device_time"] = time.perf_counter() - t_phase
    report["phase_s"] = phase_s

    kinfo = {"kernels": kernel_rows(sites)}
    # the next redesign goes to the largest launches x (ms - bound ms)
    gap = {r["name"]: r["launches"] * (r["ms"] - r["bound_ms"])
           for r in kinfo["kernels"]}
    print("launches x (ms - bound ms): " + ", ".join(
        f"{n} {g:.3f}" for n, g in sorted(gap.items(), key=lambda x: -x[1])))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(
            {**report, **kinfo, "card": card}, indent=1) + "\n")
    print(json.dumps(kinfo))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


@contextlib.contextmanager
def recording(ops, on=True):
    """Record every kernel call the path makes through ``ops`` (the
    module whose names the engines call) as (name, args, kwargs), while
    still launching the real wrappers, so the calls checked afterwards
    are the path's own."""
    calls = []
    saved = {n: getattr(ops, n) for n in FUSED_KERNELS}

    def rec(name, fn):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return call
    if on:
        for n, fn in saved.items():
            setattr(ops, n, rec(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def site_stats(name, args, num_docs, tile, reducer="successive"):
    """A fused call's runs (``run_stats``), and the CTAs per SM and
    dynamic shared memory per CTA of the kernel it launches (a candidate
    kernel by ``reducer``'s epilogue)."""
    from repro_torch.kernels import fused_decode_score as fds
    stats = run_stats(args[3], num_docs, tile)
    wpb = args[0].shape[1] if name.endswith("_packed") else 0
    stats["ctas_per_sm"], stats["smem_bytes"] = fds.occupancy(
        name, args[4].shape[1], tile, wpb,
        reducer if name in KERNELS else "successive")
    return stats


def held_site(name, args, kw, got, label, i, q_real=BATCH):
    """A fused kernel call's output ``got`` held to its plain version on
    the same arguments, to the bit (raises if not), with the call's
    work, runs and occupancy: the site dict ``replay`` prints."""
    import torch

    from repro_torch.kernels import fused_decode_score as fds
    want = getattr(fds, name + "_plain")(*args, **kw)
    torch.cuda.synchronize()
    if name in DENSE_KERNELS:
        err = float((got - want).abs().max())
        eq = torch.equal(got.view(torch.int32), want.view(torch.int32))
        nbytes, nops, real, blocks = dense_work(
            DENSE_KERNELS[name][0], args, kw["tile"], q_real)
        num_docs = args[-1 if name == "fused_score_blocked" else -2]
    else:
        eq, err = same_candidates(got, want)
        nbytes, nops, real, blocks, _ = kernel_work(
            KERNELS[name][0], args, kw["tile"], q_real)
        num_docs = args[-2 if name == "fused_topk_blocked" else -3]
    reducer = kw.get("reducer", "successive")
    extra = site_stats(name, args, num_docs, kw["tile"], reducer)
    kname = name + ("_bitonic" if reducer == "bitonic" else "")
    site = {"site": f"{label}#{i}:{kname}@{num_docs}", "kernel": kname,
            "num_docs": int(num_docs),
            "max_pairs": int(args[2].shape[0]), "real_pairs": real,
            "distinct_blocks": blocks, "bytes": nbytes, "ops": nops,
            "t_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "t_ops_ms": nops / F32_OPS_PER_S * 1e3,
            "max_abs_err": err, **extra}
    if not eq:
        raise AssertionError(f"{site['site']}: kernel != plain version "
                             f"(max abs err {err})")
    return site


def replay(calls, fds, label, timed=True, tag="live"):
    """Holds each recorded kernel call against its plain version on the
    same arguments, to the bit, and (``timed``) times both in turns.
    Returns one dict per call (a call site of the path), each printed
    on a ``<tag> kernel site:`` line."""
    sites = []
    for i, (name, args, kw) in enumerate(calls):
        wrapper, plain = getattr(fds, name), getattr(fds, name + "_plain")
        site = held_site(name, args, kw, wrapper(*args, **kw), label, i)
        if timed:
            ms, turns, plain_ms, clocks = time_in_turns(
                lambda *c: wrapper(*c, **kw), lambda *c: plain(*c, **kw),
                [args])
            site.update(kernel_ms=ms, kernel_ms_turns=turns,
                        plain_ms=plain_ms, clocks_sm_mem_power_temp=clocks)
        sites.append(site)
        print(f"{tag} kernel site: {json.dumps(site)}")
    return sites


@contextlib.contextmanager
def holding(ops, label, q_real=1):
    """As ``recording``, but each kernel call the path makes through
    ``ops`` is held to its plain version as soon as it returns (to the
    bit, ``held_site``), and only its site dict is kept, printed on a
    ``distributed kernel site:`` line: a sharded call's routing buffers
    are not held beyond its own check."""
    sites = []
    saved = {n: getattr(ops, n) for n in FUSED_KERNELS}

    def hold(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            site = held_site(name, args, kw, out, label, len(sites), q_real)
            print(f"distributed kernel site: {json.dumps(site)}")
            sites.append(site)
            return out
        return call
    for n, fn in saved.items():
        setattr(ops, n, hold(n, fn))
    try:
        yield sites
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def adaptive_budget(ix, cap, batches, static, static_ms, kind):
    """The reference's own routing budget, ``make_adaptive_scorer``, on a
    bulk index: ``ADAPTIVE_ROUNDS`` passes over the bulk batches from
    its initial budget.  Prints each call's budget before and after, its
    overflow and its ms (host clock with ``synchronize``) beside the
    static-budget batch's ms.  Checks: the last pass overflows nowhere;
    every call without overflow equals the static-budget scorer on the
    same batch (``static``: its (result, stats)), ids and score bits;
    the last call's kernel launch equals its plain version to the bit.
    A measurement: nothing is claimed from it."""
    import numpy as np
    import torch

    from repro_torch.core import query
    from repro_torch.kernels import fused_decode_score as fds
    from repro_torch.kernels import ops

    scorer = query.make_adaptive_scorer(ix, k=K, cap=cap)
    rows = []
    n_calls = ADAPTIVE_ROUNDS * len(batches)
    for c in range(n_calls):
        i = c % len(batches)
        before = dict(scorer.budget._budgets)
        with recording(ops, on=c == n_calls - 1) as calls:
            t0 = time.perf_counter()
            res, stats = scorer(batches[i])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        row = {"round": c // len(batches), "batch": i,
               "budget_before": before,
               "budget_after": dict(scorer.budget._budgets),
               "overflow": int(stats["pair_overflow"]), "ms": ms,
               "static_ms": static_ms[i]}
        if row["overflow"] == 0:
            want = static[i][0]
            if not (torch.equal(res.doc_ids, want.doc_ids) and torch.equal(
                    res.scores.view(torch.int32),
                    want.scores.view(torch.int32))):
                raise AssertionError(f"adaptive {kind} batch {i}: answer "
                                     "!= the static budget's")
        rows.append(row)
        print(f"adaptive budget {kind}: {json.dumps(row)}")
    last = [r for r in rows if r["round"] == ADAPTIVE_ROUNDS - 1]
    if rows[0]["overflow"] == 0:
        raise AssertionError(f"adaptive {kind}: the initial budget did not "
                             "overflow, so it never grew")
    if any(r["overflow"] for r in last):
        raise AssertionError(f"adaptive {kind}: overflow in the last pass")
    held = replay(calls, fds, f"adaptive-{kind}", timed=False,
                  tag="adaptive")
    return {"calls": rows, "final_budgets": rows[-1]["budget_after"],
            "converged_ms": [r["ms"] for r in last],
            "static_ms": list(static_ms), "held_call": held}


def hor_band_batch(view, batches):
    """A batch whose queries each hold two HOR-band terms of the largest
    banded segment (the densest such terms) beside one query term of
    ``batches[0]``: the served df band holds no HOR-band term, so this
    is the batch that gives that band's dense kernel real pairs."""
    import numpy as np
    import torch
    seg = max((s for s in view.segments if s.layout == "banded"),
              key=lambda s: int(s.index.docs.num_docs))
    df = seg.index.hor.df.cpu().numpy()
    order = np.argsort(-df, kind="stable")[:2 * BATCH]
    if df[order[-1]] == 0:
        raise AssertionError("the banded segment's HOR band holds too few "
                             "terms for a check batch")
    hashes = seg.index.sorted_hash.cpu().numpy().view(np.uint32)[order]
    qb = np.asarray(batches[0]).copy()
    qb[:, 1:] = hashes.reshape(BATCH, 2)
    return qb, int(seg.index.docs.num_docs)


def live_phase(host, batches, seed, dev, report):
    """The live index at the 1M tier (step 6 of the module docstring);
    returns its per-call-site kernel measurements, their traces, and the
    index (the serving phase serves it)."""
    import numpy as np
    import torch

    from repro_torch.core import build, live_index
    from repro_torch.kernels import ops
    from repro_torch.kernels import fused_decode_score as fds
    from repro_torch.text import corpus

    live: dict = {}
    t0 = time.perf_counter()
    si = live_index.SegmentedIndex.from_host(
        host, seal_layout="banded", delta_doc_capacity=DELTA_DOCS,
        delta_posting_capacity=DELTA_DOCS * 64, device=dev)
    torch.cuda.synchronize()
    live["from_host_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    new = corpus.generate(corpus.CorpusSpec(
        num_docs=NEW_DOCS, vocab=VOCAB, avg_distinct=AVG_DISTINCT,
        seed=seed + 1))

    def part(lo, hi):
        return build.TokenizedCorpus(new.doc_term_ids[lo:hi],
                                     new.doc_counts[lo:hi],
                                     new.term_hashes, hi - lo)
    for i, (lo, hi, layout) in enumerate(SEALS):
        si.add_batch(part(lo, hi))
        si.seal(layout=layout)
        if i == 3:      # before the add that triggers the tiered merge
            si.delete(np.arange(0, si.num_docs, 64))
    si.add_batch(part(SEALS[-1][1], NEW_DOCS))
    si.delete(np.arange(0, si.num_docs, 64))
    torch.cuda.synchronize()
    live["ingest_s"] = time.perf_counter() - t0

    view = si.view()
    mix = view.layout_mix()
    live.update(layout_mix=mix["segments"], stats=dataclasses.asdict(
        si.stats), delta_docs=view.delta_n_docs, live_docs=view.live_docs,
        num_docs=view.num_docs)
    print(f"live index: {json.dumps(live)}")
    for lay in ("banded", "hor", "packed"):
        if not mix["counts"].get(lay):
            raise AssertionError(f"live index holds no {lay} segment: "
                                 f"{mix['counts']}")
    if si.stats.compactions < 1 or view.delta_n_docs == 0:
        raise AssertionError(f"need a compaction and a live delta: "
                             f"{si.stats}, delta {view.delta_n_docs}")

    # warm-up, one batch per mode; the peak is read over it (the counted
    # run below holds its last batch's kernel arguments for the checks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for mode in ("candidates", "dense"):
        view.topk(batches[0], K, mode=mode)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)

    # the main path, one mode at a time: every launch counted from zero
    # just before and read just after; the last batch's kernel calls are
    # recorded, then each is held to its plain version and timed
    served, launches, sites, traces = {}, {}, [], {}
    for mode in ("candidates", "dense"):
        reset_launches()
        out, e2e_ms = [], []
        for i, qb in enumerate(batches):
            with recording(ops, on=i == len(batches) - 1) as calls:
                t0 = time.perf_counter()
                res, stats = view.topk(qb, K, mode=mode, return_stats=True)
                torch.cuda.synchronize()
                e2e_ms.append((time.perf_counter() - t0) * 1e3)
            if stats["pair_overflow"] != 0:
                raise AssertionError(f"live {mode}: overflow {stats}")
            out.append(res)
        launches[mode] = read_launches()
        served[mode] = (out, e2e_ms)
        for (name, args, kw), site in zip(calls, replay(calls, fds, mode)):
            # every batch launches each of the path's sites once
            site.update(mode=mode, launches=len(batches))
            sites.append(site)
            # its device time, at the end
            traces[site["site"]] = (name, functools.partial(
                getattr(fds, name), **kw), [args])
        del calls
        torch.cuda.empty_cache()
    print(f"live launches: {json.dumps(launches)}")
    for name in FUSED_KERNELS:
        n = sum(c[name] for c in launches.values())
        if n == 0:
            raise AssertionError(f"{name} never launched on the live path")
        if n != sum(x["launches"] for x in sites if x["kernel"] == name):
            raise AssertionError(f"{name}: {n} launches, but the recorded "
                                 f"sites account for a different count")

    # where a batch's time goes: one traced pass per mode after the
    # counted run (spans time the host; merge includes the copy back)
    from repro_torch.obs.trace import Trace
    spans = {}
    for mode in ("candidates", "dense"):
        acc: dict = {}
        for qb in batches:
            trace = Trace()
            view.topk(qb, K, mode=mode, trace=trace)
            for sp in trace.spans:
                key = sp.name + (f"@{sp.attrs['doc_base']}"
                                 if sp.name == "segment" else "")
                acc[key] = acc.get(key, 0.0) + sp.duration_us / 1e3
        spans[mode] = {key: ms / len(batches) for key, ms in acc.items()}
    print(f"live spans ms per batch: {json.dumps(spans)}")

    # a check batch (not served traffic) that routes real pairs to the
    # largest banded segment's HOR band: every kernel call held to its
    # plain version, ids and scores to the oracle
    hb, hb_docs = hor_band_batch(view, batches)
    with recording(ops) as calls:
        hres, hstats = view.topk(hb, K, mode="dense", return_stats=True)
    hor_check = replay(calls, fds, "hor-band-check", timed=False)
    del calls
    band = [x for x in hor_check if x["kernel"] == "fused_score_blocked"
            and x["num_docs"] == hb_docs]
    if not band or band[0]["real_pairs"] == 0 or hstats["pair_overflow"]:
        raise AssertionError(f"HOR-band check batch: {band}, {hstats}")
    live["hor_band_check"] = hor_check

    # results against the gather oracle over the same view
    swaps, oracle_ms = [], []
    checked = [(i, qb, {m: v[0][i] for m, v in served.items()})
               for i, qb in enumerate(batches)]
    checked.append(("hor-band-check", hb, {"dense": hres}))
    for i, qb, by_mode in checked:
        t0 = time.perf_counter()
        ref = view.topk(qb, K + 1, engine="torch")
        oracle_ms.append((time.perf_counter() - t0) * 1e3)
        ref_ids, ref_sc = ref.doc_ids.cpu().numpy(), ref.scores.cpu().numpy()
        for mode, res in by_mode.items():
            ids = res.doc_ids.cpu().numpy()
            sc = res.scores.cpu().numpy()
            if ids.shape != (BATCH, K) or not np.isfinite(sc).all():
                raise AssertionError(f"live {mode}: bad result {ids.shape}")
            if not ((ids >= 0) & (ids < view.num_docs)).all() or \
                    not view.live[ids].all():
                raise AssertionError(f"live {mode}: missing or dead ids")
            for case in near_tie_swaps(ids, sc, ref_ids, ref_sc, K):
                case.update(batch=i, mode=mode)
                print(f"near-tie swap: {json.dumps(case)}")
                swaps.append(case)

    live.update(
        launches=launches, max_memory_allocated=peak,
        e2e_ms_per_batch={m: v[1] for m, v in served.items()},
        oracle_ms_per_batch=oracle_ms, near_tie_swaps=swaps,
        span_ms_per_batch=spans, kernel_sites=sites)
    print(f"live serving: {json.dumps({k: live[k] for k in ('launches', 'max_memory_allocated', 'e2e_ms_per_batch', 'oracle_ms_per_batch')})}")
    report["live"] = live
    del view
    torch.cuda.empty_cache()
    return sites, traces, si


# serving phase: the serving tier over the live phase's index
SERVE_EXTRA = (4, 6, 8)       # widths of the extra queries, 8 of each
SERVE_REPEATS = 16            # queries resubmitted at e0: cache hits
SERVE_NEW_DOCS = 2_048        # ingested between the two epochs
SERVE_SEAL_FILL = 0.1         # the delta then holds ~2,348 of 16,384 docs
STAGE_REL = 1e-9              # stage sums vs latency_us: float rounding


def path_launches(view, batches):
    """Launch counts ``batches`` micro-batches through ``view`` imply:
    ``idf`` and ``query_norm`` once each per batch, one dense launch per
    band of each banded segment, one candidate launch per HOR or packed
    segment (``LiveView.topk``, mode "candidates")."""
    want = dict.fromkeys((*ALL_KERNELS, *WEIGHT_KERNELS), 0)
    want["idf"] = want["query_norm"] = batches
    for seg in view.segments:
        names = {"banded": ("fused_score_packed", "fused_score_blocked"),
                 "hor": ("fused_topk_blocked",),
                 "packed": ("fused_topk_packed",)}[seg.layout]
        for name in names:
            want[name] += batches
    return want


def serving_phase(si, batches, seed, dev, report, card):
    """The serving tier on the live phase's index (``QueryServer``,
    ``IndexMaintenance``, the snapshot): 64 distinct queries at epoch
    e0, 16 of them again as cache hits, a write step (2,048 docs in,
    every 64th deleted, the delta sealed by maintenance), the 64 again
    at e1, then a full-size snapshot restored on the card.  Every
    request is submitted before pumping, so the latencies are a closed
    backlog's, queue wait included, not those of an open arrival rate.
    Checks (a)-(h) of the module docstring's step 6c; prints one
    ``serving:`` line."""
    import numpy as np
    import torch

    from repro_torch.kernels import fused_decode_score as fds
    from repro_torch.kernels import ops
    from repro_torch.obs.registry import GLOBAL, percentiles
    from repro_torch.serve import (IndexMaintenance, QueryServer,
                                   ServerConfig, restore_segmented,
                                   serialize_segmented)
    from repro_torch.text import corpus

    class Server(QueryServer):
        """Records every view it pins, by epoch."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.views = {self._pinned.epoch: self._pinned}

        def refresh_view(self):
            v = super().refresh_view()
            self.views[v.epoch] = v
            return v

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = ServerConfig(batch_size=BATCH, n_terms_budget=8, k=K,
                       trace_sample=1)
    view = si.view()
    rows, seen = [], set()

    def take(q):
        row = np.zeros(cfg.n_terms_budget, np.uint32)
        row[:len(q)] = q
        if tuple(row.tolist()) in seen:
            return 0
        seen.add(tuple(row.tolist()))
        rows.append(row)
        return 1
    for qb in batches:
        for q in qb:
            take(q)
    n_live_rows = len(rows)
    for t in SERVE_EXTRA:
        got, s = 0, 0
        while got < BATCH:
            got += take(corpus.sample_query_terms(
                view.df, view.hashes, 1, t, df_band=(0.15, 0.5),
                num_docs=view.live_docs, seed=seed * 1000 + 100 * t + s)[0])
            s += 1
    if len(rows) % BATCH:
        raise AssertionError(f"serving: {len(rows)} distinct queries")
    n_batches = len(rows) // BATCH

    server = Server(si, cfg)
    t0 = time.perf_counter()
    server.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    GLOBAL.counter("engine_pair_overflow")        # get or create
    overflow0 = server.metrics_snapshot()["engine_pair_overflow"]["value"]

    def serve(qs, record=False):
        """Submit every query, then pump until drained: (responses,
        wall seconds, the kernel calls of the last micro-batch)."""
        t0 = time.perf_counter()
        tickets = [server.submit(q) for q in qs]
        last = []
        while server.pending:
            on = record and server.pending <= cfg.batch_size
            with recording(ops, on=on) as calls:
                server.pump()
            if on:
                last = calls
        wall = time.perf_counter() - t0
        return [t.result(timeout=600.0) for t in tickets], wall, last

    def check_launches(label, got, want):
        if got != want:
            raise AssertionError(f"serving {label}: launches {got}, the "
                                 f"layout implies {want}")

    # epoch e0: the 64, then 16 of them again
    reset_launches()
    e0_resp, e0_wall, _ = serve(rows)
    e0 = server.pinned_epoch
    launches_e0 = read_launches()
    check_launches("e0", launches_e0, path_launches(server.views[e0],
                                                    n_batches))
    rep_idx = list(range(0, len(rows), len(rows) // SERVE_REPEATS))
    reset_launches()
    hits, hits_wall, _ = serve([rows[i] for i in rep_idx])
    check_launches("cache hits", read_launches(),
                   dict.fromkeys((*ALL_KERNELS, *WEIGHT_KERNELS), 0))
    for i, r in zip(rep_idx, hits):                              # (c)
        want = e0_resp[i]
        if not (r.cached and r.epoch == want.epoch == e0
                and np.array_equal(r.doc_ids, want.doc_ids)
                and np.array_equal(r.scores.view(np.int32),
                                   want.scores.view(np.int32))):
            raise AssertionError(f"serving: cache hit {i} differs from "
                                 "the response it repeats")

    # the write step, then maintenance seals the delta
    new = corpus.generate(corpus.CorpusSpec(
        num_docs=SERVE_NEW_DOCS, vocab=VOCAB, avg_distinct=AVG_DISTINCT,
        seed=seed + 2))
    t0 = time.perf_counter()
    with server.index_lock:
        base = si.num_docs
        si.add_batch(new)
        si.delete(np.arange(base, base + SERVE_NEW_DOCS, 64))
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    fill = si.delta_fill
    maint = IndexMaintenance(si, server.index_lock, seal_fill=SERVE_SEAL_FILL)
    t0 = time.perf_counter()
    did = maint.run_once()
    torch.cuda.synchronize()
    maint_s = time.perf_counter() - t0
    if not did["sealed"]:
        raise AssertionError(f"serving: maintenance did not seal the delta "
                             f"(fill {fill}): {did}")
    sealed = si.segments()[-1]

    # epoch e1: the 64 again, the last micro-batch's kernel calls recorded
    reset_launches()
    e1_resp, e1_wall, e1_calls = serve(rows, record=True)
    e1 = server.pinned_epoch
    launches_e1 = read_launches()
    check_launches("e1", launches_e1, path_launches(server.views[e1],
                                                    n_batches))
    if not e0 < e1 == si.epoch:
        raise AssertionError(f"serving: epochs e0 {e0}, e1 {e1}, index "
                             f"{si.epoch}")
    serving_sites = replay(e1_calls, fds, "serving-e1", timed=False,
                           tag="serving")                        # (g)
    if not any(x["num_docs"] == sealed.index.docs.num_docs
               for x in serving_sites):
        raise AssertionError("serving: the new seal's kernel calls were not "
                             "recorded")

    def check_epoch(epoch, resp):
        """(a) each response == ``view.topk`` on the same padded batch of
        the pinned view, ids and score bits, with no overflow (h); (b)
        ids == the gather oracle's but at printed near ties, scores
        within rtol 1e-5, every id live; (d) the epoch."""
        view = server.views[epoch]
        swaps = []
        for b0 in range(0, len(resp), cfg.batch_size):
            group = resp[b0:b0 + cfg.batch_size]
            qb = np.stack(rows[b0:b0 + cfg.batch_size])
            ids = np.stack([r.doc_ids for r in group])
            sc = np.stack([r.scores for r in group])
            if any(r.epoch != epoch or r.cached or not r.ok
                   for r in group):
                raise AssertionError(f"serving: batch {b0} not served "
                                     f"fresh at epoch {epoch}")
            res, st = view.topk(qb, K, engine="fused", mode="candidates",
                                return_stats=True)
            if st["pair_overflow"] != 0:
                raise AssertionError(f"serving: overflow {st}")
            if not (np.array_equal(ids, res.doc_ids.cpu().numpy())
                    and np.array_equal(
                        sc.view(np.int32),
                        res.scores.cpu().numpy().view(np.int32))):
                raise AssertionError(f"serving: batch {b0} at epoch {epoch} "
                                     "!= view.topk on the same batch")
            ref = view.topk(qb, K + 1, engine="torch")
            for case in near_tie_swaps(ids, sc, ref.doc_ids.cpu().numpy(),
                                       ref.scores.cpu().numpy(), K):
                case.update(batch=b0 // cfg.batch_size, epoch=epoch)
                print(f"near-tie swap: {json.dumps(case)}")
                swaps.append(case)
            if not ((ids >= 0) & (ids < view.num_docs)).all() or \
                    not view.live[ids].all():
                raise AssertionError(f"serving: missing or dead ids at "
                                     f"epoch {epoch}")
        return swaps
    swaps = check_epoch(e0, e0_resp) + check_epoch(e1, e1_resp)
    changed_ids = sum(not np.array_equal(a.doc_ids, b.doc_ids)
                      for a, b in zip(e0_resp, e1_resp))
    changed = sum(not (np.array_equal(a.doc_ids, b.doc_ids)
                       and np.array_equal(a.scores, b.scores))
                  for a, b in zip(e0_resp, e1_resp))
    if changed == 0:                                              # (d)
        print("serving: no answer changed between e0 and e1, though the "
              "live doc count behind every idf did")
    for r in (*e0_resp, *hits, *e1_resp):                         # (e)
        stages = r.trace.stage_durations()
        want = ({"queue_wait", "cache_hit"} if r.cached
                else {"queue_wait", "assemble", "score", "respond"})
        total = sum(stages.values())
        if set(stages) != want or \
                abs(total - r.latency_us) > STAGE_REL * r.latency_us:
            raise AssertionError(f"serving: stages {stages} sum to {total}, "
                                 f"latency {r.latency_us} us")
    overflow1 = server.metrics_snapshot()["engine_pair_overflow"]["value"]
    if overflow1 != overflow0:                                    # (h)
        raise AssertionError(f"serving: engine_pair_overflow grew "
                             f"{overflow0} -> {overflow1}")

    # the snapshot at full size, in memory
    t0 = time.perf_counter()
    state = serialize_segmented(si, server.index_lock)
    serialize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    si2 = restore_segmented(state, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if si2.epoch != e1 or si2.layout_mix() != si.layout_mix():
        raise AssertionError("serving: the restored index differs")
    for b0 in range(0, len(rows), cfg.batch_size):
        res = si2.topk(np.stack(rows[b0:b0 + cfg.batch_size]), K)
        group = e1_resp[b0:b0 + cfg.batch_size]
        if not (np.array_equal(np.stack([r.doc_ids for r in group]),
                               res.doc_ids.cpu().numpy())
                and np.array_equal(
                    np.stack([r.scores for r in group]).view(np.int32),
                    res.scores.cpu().numpy().view(np.int32))):
            raise AssertionError(f"serving: the restored index answers "
                                 f"batch {b0} otherwise")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del si2, state
    torch.cuda.empty_cache()

    def lat(resp):
        p = percentiles([r.latency_us for r in resp if not r.cached])
        return {"p50_us": p["p50"], "p99_us": p["p99"]}

    def score_children(resp):
        """Mean ms per micro-batch of the score span's children (one
        trace per batch: its tickets adopt the same spans)."""
        acc: dict = {}
        for r in resp[::cfg.batch_size]:
            for sp in r.trace.spans:
                if sp.parent == "score":
                    key = sp.name + (f"@{sp.attrs['doc_base']}"
                                     if sp.name == "segment" else "")
                    acc[key] = acc.get(key, 0.0) + sp.duration_us / 1e3
        return {key: ms / n_batches for key, ms in acc.items()}

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}
    summary = server.metrics.summary()
    line = {
        "card": card,
        "arrival": "closed backlog: every request submitted before "
                   "pumping; latency includes queue wait; not an open "
                   "arrival rate",
        "queries": len(rows), "live_phase_queries": n_live_rows,
        "micro_batches_per_epoch": n_batches,
        "latency_e0": lat(e0_resp), "latency_e1": lat(e1_resp),
        "qps_e0": len(rows) / e0_wall, "qps_e1": len(rows) / e1_wall,
        "cache_hits_wall_s": hits_wall,
        "qps_window": summary["qps"], "batch_fill": summary["batch_fill"],
        "cache_hit_rate": server.cache.hit_rate,
        "cache_hits": server.cache.hits,
        "stages": server.stage_summary(),
        "score_children_ms_per_batch": {"e0": score_children(e0_resp),
                                        "e1": score_children(e1_resp)},
        "maintenance": {"did": did, "delta_fill": fill,
                        "seconds": maint_s,
                        "sealed": {"doc_base": sealed.doc_base,
                                   "docs": sealed.doc_span,
                                   "layout": sealed.layout,
                                   "size_class": sealed.size_class}},
        "epochs": [e0, e1], "answers_changed": changed,
        "ids_changed": changed_ids, "near_tie_swaps": swaps,
        "warmup_s": warmup_s, "write_s": write_s,
        "serialize_s": serialize_s, "restore_s": restore_s,
        "launches": {"e0": nonzero(launches_e0),
                     "e1": nonzero(launches_e1)},
        "max_memory_allocated": peak,
    }
    report["serving"] = {**line, "kernel_sites": serving_sites}
    print(f"serving: {json.dumps(line)}")


# f32 operations per slot of ``idf`` (a fused multiply-add counts two):
# the division, x + 1, and the log's 10 FMAs and 10 other operations
IDF_OPS = 2 + 2 * 10 + 10


def weight_sites(df, num_docs, w, launches, live_docs):
    """The query weights' kernels at the main path's shapes, the last
    bulk batch's df (i32[B, T]) and weights: each held to its plain
    version on the card and on the CPU, to the bit, and timed in turns
    beside it.  Then, untimed, ``idf`` over every df up to the live doc
    count and ``query_norm`` at every width from 1 to 32 (random
    weights, 8 rows) held the same way.  ``launches`` are the counted
    runs' (bulk and live).  Returns the sites and their traces."""
    import numpy as np
    import torch

    from repro_torch.core import query

    def held(name, args):
        got = getattr(query, name)(*args)
        plain = getattr(query, name + "_plain")
        want = plain(*args)
        cpu = plain(*(x.cpu() if isinstance(x, torch.Tensor) else x
                      for x in args))
        torch.cuda.synchronize()
        for other in (want, cpu):
            if not torch.equal(got.cpu().view(torch.int32),
                               other.cpu().view(torch.int32)):
                raise AssertionError(f"{name}: kernel != plain version "
                                     f"at {tuple(args[0].shape)}")
        return float((got - want).abs().max()) if got.numel() else 0.0

    rows, width = w.shape
    work = {"idf": ((df, num_docs), df.numel() * 8, df.numel() * IDF_OPS,
                    None),
            "query_norm": ((w,), w.numel() * 4 + rows * 4, w.numel() * 2,
                           lambda x: torch.linalg.vector_norm(x, dim=-1))}
    sites, traces = [], {}
    for name, (args, nbytes, nops, lib) in work.items():
        err = held(name, args)
        ms, turns, plain_ms, clocks = time_in_turns(
            getattr(query, name), getattr(query, name + "_plain"), [args])
        site = {"site": f"weights:{name}@{rows}x{width}", "kernel": name,
                "launches": launches[name], "max_abs_err": err,
                "bytes": nbytes, "ops": nops,
                "t_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "t_ops_ms": nops / F32_OPS_PER_S * 1e3,
                "kernel_ms": ms, "kernel_ms_turns": turns,
                "plain_ms": plain_ms, "clocks_sm_mem_power_temp": clocks,
                "library_ms": (event_ms(lib, [args], REPS)
                               if lib else None)}
        sites.append(site)
        traces[site["site"]] = (name, getattr(query, name), [args])
        print(f"weights kernel site: {json.dumps(site)}")
    every_df = torch.arange(0, live_docs + 1, dtype=torch.int32,
                            device=df.device)
    held("idf", (every_df, float(np.float32(live_docs))))
    rng = np.random.default_rng(live_docs)
    for t in range(1, 33):
        r = (rng.random((8, t)) * 14).astype(np.float32)
        r[rng.random(r.shape) < 0.2] = 0.0
        held("query_norm", (torch.from_numpy(r).to(df.device),))
    print(f"weights: kernel == plain version (card and CPU) over df "
          f"0..{live_docs} and widths 1-32")
    return sites, traces


def absent_hashes(term_hashes, n, seed):
    """``n`` u32 hashes that are not in the vocabulary (nor 0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    taken = set(int(x) for x in term_hashes)
    out = []
    while len(out) < n:
        h = int(rng.integers(1, 2**32))
        if h not in taken:
            out.append(h)
            taken.add(h)
    return np.asarray(out, np.uint32)


def paper_phase(host, dev, report):
    """The paper's representation comparison at the 1M tier (step 7 of
    the module docstring); returns the two side kernels' sites."""
    import numpy as np
    import torch

    from repro_torch.core import direct_index, layouts, query, size_model
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_postings as pp
    from repro_torch.kernels import posting_score as ps
    from repro_torch.text import corpus

    paper: dict = {}
    cap = host.max_posting_len
    W, D = host.num_terms, host.num_docs
    torch.cuda.reset_peak_memory_stats(dev)

    # builds: each posting set once; the _hash twins swap the lookup
    build_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        return out
    btree = timed("btree_lookup",
                  lambda: layouts.build_sorted_lookup(host.term_hashes, dev))
    hashlk = timed("hash_lookup",
                   lambda: layouts.build_hash_lookup(host.term_hashes, dev))
    pr = timed("pr", lambda: layouts.build_coo(host, device=dev))
    orr = timed("or", lambda: layouts.build_csr(host, device=dev))
    ix = {"pr_btree": pr,
          "pr_hash": dataclasses.replace(pr, lookup=hashlk),
          "or_btree": orr,
          "or_hash": dataclasses.replace(orr, lookup=hashlk),
          "cor": timed("cor", lambda: layouts.build_compact_csr(
              host, device=dev)),
          "hor": timed("hor", lambda: layouts.build_blocked(host,
                                                            device=dev)),
          "packed": timed("packed", lambda: layouts.build_packed_csr(
              host, device=dev))}
    direct = timed("direct", lambda: direct_index.build_direct(
        host, device=dev))
    paper["build_s"] = build_s
    paper["device_bytes_allocated"] = torch.cuda.memory_allocated(dev)
    print(f"paper builds (s): {json.dumps(build_s)}")

    # Table 5: bytes per representation beside the size model
    seg = size_model.SegmentStats(num_docs=D, num_postings=host.num_postings,
                                  num_terms=W)
    cs = size_model.CorpusStats(D=D, W=W, N_d=host.num_postings)
    table5 = {name: {"nbytes": x.nbytes(), "posting_bytes": x.posting_bytes(),
                     "est_posting_bytes": size_model.est_posting_bytes(
                         seg, SIZE_LAYOUT[name])}
              for name, x in ix.items()}
    table5["direct"] = {"nbytes": direct.nbytes()}
    table5["model"] = {
        "pr_bytes": size_model.pr_bytes(cs),
        "orif_bytes": size_model.orif_bytes(cs),
        "pr_over_orif": size_model.pr_over_orif(cs),
        "pr_pages": size_model.pages(size_model.pr_bytes(cs)),
        "orif_pages": size_model.pages(size_model.orif_bytes(cs)),
        "coo_layout_bytes": size_model.coo_layout_bytes(cs),
        "csr_layout_bytes": size_model.csr_layout_bytes(cs),
        "packed_csr_layout_bytes": size_model.packed_csr_layout_bytes(cs)}
    for name in ("pr_btree", "or_btree", "cor"):
        if table5[name]["posting_bytes"] != table5[name]["est_posting_bytes"]:
            raise AssertionError(f"table 5 {name}: {table5[name]}")
    paper["table5"] = table5
    print(f"table 5 (bytes): {json.dumps(table5)}")

    # Table 7's protocol: 8 queries of 1-4 terms from the df band
    batches = {n: corpus.sample_query_terms(
        host.df, host.term_hashes, BATCH, n, num_docs=D, seed=n)
        for n in PAPER_TERMS}
    qhs = {n: layouts.hash_tensor(qb, dev) for n, qb in batches.items()}

    # Table 6: both lookups on the queries' hashes and on absent ones
    probe = layouts.hash_tensor(np.concatenate(
        [np.concatenate([b.reshape(-1) for b in batches.values()]),
         absent_hashes(host.term_hashes, 64, 6)]), dev)
    got_b, got_h = btree.lookup(probe), hashlk.lookup(probe)
    if not torch.equal(got_b, got_h) or bool((got_b[:-64] < 0).any()) \
            or bool((got_b[-64:] != -1).any()):
        raise AssertionError("btree and hash lookups disagree")
    look_ms = {k: event_ms(lk.lookup, [(probe,)], REPS)
               for k, lk in (("btree", btree), ("hash", hashlk))}
    paper["table6"] = {
        "btree_bytes": btree.nbytes(), "hash_bytes": hashlk.nbytes(),
        "hash_slots": int(hashlk.keys.shape[0]),
        "cor_folded_bytes": (ix["cor"].sorted_hash.numel()
                             + ix["cor"].df.numel()) * 4,
        "lookup_ms_per_call": look_ms, "hashes_per_call": probe.numel()}
    print(f"table 6: {json.dumps(paper['table6'])}")

    # 1. the seven representations through the oracle (Table 7)
    ms7, results = {}, {}
    for name, x in ix.items():
        scorer = query.make_scorer(x, k=K, cap=cap, engine="torch")
        scorer(qhs[1])                                   # warm-up
        ms7[name], results[name] = {}, {}
        for n, qh in qhs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = scorer(qh)
            torch.cuda.synchronize()
            ms7[name][n] = (time.perf_counter() - t0) * 1e3 / BATCH
            results[name][n] = r
    base = results["pr_btree"]
    for name in SEVEN:
        for n in PAPER_TERMS:
            r = results[name][n]
            if r.doc_ids.shape != (BATCH, K) or \
                    not bool(torch.isfinite(r.scores).all()) or \
                    bool((r.doc_ids < 0).any()):
                raise AssertionError(f"{name} {n}t: bad result")
            if not torch.equal(r.doc_ids, base[n].doc_ids) or not \
                    torch.equal(r.scores.view(torch.int32),
                                base[n].scores.view(torch.int32)):
                raise AssertionError(f"{name} {n}t ranks unlike pr_btree")

    hor, packed = ix["hor"], ix["packed"]
    tfirst, tcount, n_tiles = ops.routing_spans(hor, ps.TILE)
    # warm-up (library loads), then the main path: every counter from
    # zero just before, read just after
    tids, idf_w = query.lookup_query(hor, qhs[1])
    ops.blocked_query_scores(hor, tids[0], idf_w[0], hor.max_blocks_per_term,
                             1 << 16)
    pp.unpack_blocks(packed.packed[:1], packed.block_bits[:1],
                     packed.block_base[:1], packed.block_count[:1],
                     packed.block)
    torch.cuda.synchronize()
    reset_launches()
    single, ms_single = [], {}
    for n, qh in qhs.items():
        tids, idf_w = query.lookup_query(hor, qh)
        ms = []
        for t, w in zip(tids, idf_w):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sel, valid, sw = ops.select_query_blocks(
                hor, t, w, hor.max_blocks_per_term)
            max_pairs = max(int(tcount[sel.long()][valid].sum()), 1)
            scores, ovf = ops.blocked_query_scores(
                hor, t, w, hor.max_blocks_per_term, max_pairs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            single.append((t, w, sel, valid, sw, max_pairs, scores,
                           int(ovf)))
        ms_single[n] = ms
    t0 = time.perf_counter()
    decoded = ops.unpack_postings(packed)
    torch.cuda.synchronize()
    unpack_e2e_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    print(f"paper launches: {json.dumps(launches)}")
    if launches["posting_score"] != BATCH * len(PAPER_TERMS) or \
            launches["unpack_blocks"] != 1 or \
            any(launches[k] for k in FUSED_KERNELS):
        raise AssertionError(f"paper path launches {launches}")
    ms7["hor_posting_score"] = {n: float(np.mean(v))
                                for n, v in ms_single.items()}
    paper["table7_ms_per_query"] = ms7
    print(f"table 7 (ms per query): {json.dumps(ms7)}")

    # 2. each posting_score launch against its plain version and the
    # oracle's raw accumulation, to the bit
    calls, lib_calls, work = [], [], []
    nb_docs = hor.block_docs.shape[1]
    for t, w, sel, valid, sw, max_pairs, scores, ovf in single:
        if ovf != 0:
            raise AssertionError(f"posting_score overflow {ovf}")
        pb, pt, pw, _ = ps.build_pairs(sel, valid, sw, tfirst, tcount,
                                       n_tiles, max_pairs)
        args = (hor.block_docs, hor.block_tfs, pb, pt, pw, D)
        want = ps.posting_score_plain(*args)
        d, tf, v = hor.gather_postings(t, cap)
        raw = query.accumulate_scores(d, tf * w[:, None], v, D)
        torch.cuda.synchronize()
        for label, other in (("plain", want), ("oracle", raw)):
            if not torch.equal(scores.view(torch.int32),
                               other.view(torch.int32)):
                err = float((scores - other).abs().max())
                raise AssertionError(f"posting_score != {label} "
                                     f"(max abs err {err})")
        calls.append(args)
        blocks = sel[valid].long()
        bd = hor.block_docs[blocks].reshape(-1)
        lib_calls.append((torch.where(bd >= 0, bd, D).long(),
                          (hor.block_tfs[blocks] * sw[valid][:, None])
                          .reshape(-1)))
        real = max_pairs
        work.append((int(torch.unique(pb).numel()) * nb_docs * 8
                     + real * 12 + (n_tiles + 1) * 4 + D * 4,
                     real * nb_docs * 2))
    ms, turns, plain_ms, clocks = time_in_turns(
        ps.posting_score, ps.posting_score_plain, calls)
    acc = torch.zeros(D + 1, dtype=torch.float32, device=dev)
    lib_ms = event_ms(lambda i, v: acc.index_add_(0, i, v), lib_calls, REPS)
    nbytes = float(np.mean([x[0] for x in work]))
    nops = float(np.mean([x[1] for x in work]))
    sites = [{"site": f"paper:posting_score@hor{D}", "kernel": "posting_score",
              "launches": launches["posting_score"], "max_abs_err": 0.0,
              "kernel_ms": ms, "kernel_ms_turns": turns,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "bytes": nbytes, "ops": nops,
              "real_pairs_per_query": [x[5] for x in single],
              "t_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "t_ops_ms": nops / F32_OPS_PER_S * 1e3,
              "clocks_sm_mem_power_temp": clocks}]
    del lib_calls, acc

    # 3. the decode against its plain version and the host, term by term
    args = (packed.packed, packed.block_bits, packed.block_base,
            packed.block_count, packed.block)
    want = pp.unpack_blocks_plain(*args)
    if not torch.equal(decoded, want):
        raise AssertionError("unpack_blocks != plain version")
    del want
    _, _, _, _, src, brow, lane = layouts._block_layout(host, packed.block)
    expect = torch.full((decoded.numel(),), -1, dtype=torch.int32,
                        device=dev)
    expect[torch.from_numpy(brow * packed.block + lane).to(dev)] = \
        torch.from_numpy(host.doc_ids[src].astype(np.int32)).to(dev)
    if not torch.equal(decoded.reshape(-1), expect):
        raise AssertionError("unpack_postings != the host's doc ids")
    del expect, src, brow, lane
    # each block's own ceil(block bits / 32) words (the kernel reads no
    # more), its metadata and its output; the padded rows beside it
    nb, wpb = packed.packed.shape
    words = int(((packed.block_bits.long() * packed.block + 31) // 32)
                .clamp(1, wpb).sum())
    u_bytes = words * 4 + nb * 12 + nb * packed.block * 4
    u_padded = nb * wpb * 4 + nb * 12 + nb * packed.block * 4
    u_ops = nb * packed.block * 5
    ms_u, turns_u, plain_u, clocks_u = time_in_turns(
        pp.unpack_blocks, pp.unpack_blocks_plain, [args])
    sites.append({
        "site": f"paper:unpack_blocks@packed{D}", "kernel": "unpack_blocks",
        "launches": launches["unpack_blocks"], "max_abs_err": 0.0,
        "kernel_ms": ms_u, "kernel_ms_turns": turns_u, "plain_ms": plain_u,
        "library_ms": None, "e2e_ms": unpack_e2e_ms, "blocks": nb,
        "words_per_block": wpb, "words_read": words, "bytes": u_bytes,
        "ops": u_ops, "t_bytes_ms": u_bytes / HBM_BYTES_PER_S * 1e3,
        "bytes_padded_rows": u_padded,
        "t_bytes_padded_rows_ms": u_padded / HBM_BYTES_PER_S * 1e3,
        "t_ops_ms": u_ops / F32_OPS_PER_S * 1e3,
        "clocks_sm_mem_power_temp": clocks_u})
    del decoded

    # 4. conjunctive_filter on all seven; every hit holds every term
    conj_hits, conj_ms = 0, {}
    for n, qb in batches.items():
        for q in range(BATCH):
            got = {}
            for name, x in ix.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r, st = query.conjunctive_filter(x, qb[q], K, cap)
                torch.cuda.synchronize()
                conj_ms.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
                if st["truncated_terms"] != 0:
                    raise AssertionError(f"conjunctive {name}: {st}")
                got[name] = r
            for name, r in got.items():
                if not torch.equal(r.doc_ids, got["pr_btree"].doc_ids):
                    raise AssertionError(f"conjunctive {name} {n}t q{q}")
            tids = hor.lookup_terms(qhs[n][q])
            for doc in got["hor"].doc_ids.tolist():
                if doc >= 0:
                    conj_hits += 1
                    if not bool(hor.contains(tids, doc).all()):
                        raise AssertionError(f"conjunctive hit {doc} lacks "
                                             f"a term of {n}t q{q}")
    if conj_hits == 0:
        raise AssertionError("conjunctive_filter found no doc at all")
    paper["conjunctive"] = {
        "hits_checked": conj_hits,
        "ms_per_query": {k: float(np.mean(v)) for k, v in conj_ms.items()}}
    print(f"conjunctive: {json.dumps(paper['conjunctive'])}")

    # 5. the direct index: expansion beside the full scans, feedback,
    # deletion
    exp_ms = {"direct": [], "scan_pr": [], "scan_or": []}
    for n in PAPER_TERMS:
        tids_or = orr.lookup_terms(qhs[n])
        for q in range(BATCH):
            top = base[n].doc_ids[q]
            t0 = time.perf_counter()
            e = direct_index.expand_query(direct, top, W, direct.max_doc_len)
            torch.cuda.synchronize()
            exp_ms["direct"].append((time.perf_counter() - t0) * 1e3)
            for key, x in (("scan_pr", pr), ("scan_or", orr)):
                t0 = time.perf_counter()
                s_ = direct_index.expand_query_scan(x, top, W)
                torch.cuda.synchronize()
                exp_ms[key].append((time.perf_counter() - t0) * 1e3)
                if not (torch.equal(s_.term_ids, e.term_ids) and torch.equal(
                        s_.weights.view(torch.int32),
                        e.weights.view(torch.int32))):
                    raise AssertionError(f"expand_query != {key} "
                                         f"({n}t q{q})")
            fb = direct_index.relevance_feedback(direct, top, tids_or[q], W,
                                                 direct.max_doc_len)
            if fb.term_ids.shape != (10,) or \
                    not bool(torch.isfinite(fb.weights).all()) or \
                    not bool((fb.term_ids[:1] >= 0).all()):
                raise AssertionError(f"relevance_feedback {fb}")
    victims = torch.stack([base[n].doc_ids[:, 0] for n in PAPER_TERMS])
    victims = victims.reshape(-1)
    norm = direct_index.delete_docs(pr.docs.norm, victims)
    if bool((norm[victims.long()] != 0).any()):
        raise AssertionError("delete_docs left a norm")
    for name, x in ix.items():
        dead = dataclasses.replace(x, docs=layouts.DocTable(
            norm=norm, rank=x.docs.rank))
        scorer = query.make_scorer(dead, k=K, cap=cap, engine="torch")
        for n, qh in qhs.items():
            if bool(torch.isin(scorer(qh).doc_ids, victims).any()):
                raise AssertionError(f"{name} returned a deleted doc")
    paper["direct"] = {
        "max_doc_len": direct.max_doc_len, "deleted": victims.numel(),
        "expand_ms_per_query": {k: float(np.mean(v))
                                for k, v in exp_ms.items()}}
    print(f"direct index: {json.dumps(paper['direct'])}")

    paper["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    for site in sites:
        print(f"paper kernel site: {json.dumps(site)}")
    report["paper"] = {**paper, "kernel_sites": sites}
    # each side kernel's device time is read at the end of the script (a
    # trace slows the launches timed after it)
    traces = {sites[0]["site"]: ("posting_score", ps.posting_score, calls),
              sites[1]["site"]: ("unpack_blocks", pp.unpack_blocks, [args])}
    del ix, pr, orr, hor, packed, direct, results, base, single, calls, args
    torch.cuda.empty_cache()
    return sites, traces


def model_inputs(seed, dev):
    """Every input of the model phase, made on the card from ``seed``:
    xDeepFM's fused field table and its serve_bulk and multi-hot id
    batches, PNA's hidden features and padded neighbour lists at
    ogbn-products and a Reddit minibatch, and q/k/v at each attention
    site.  Returns the main path's calls as (site, kernel, args, kw)."""
    import torch
    from repro_torch.kernels import embedding_bag as tbag
    g = torch.Generator(device=dev).manual_seed(seed)

    def ids(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def rand(shape):
        return torch.rand(shape, generator=g, device=dev)

    f, vocab = XDEEPFM_FIELDS, XDEEPFM_VOCAB
    table = torch.randn(tbag.padded_rows(f * vocab), XDEEPFM_DIM,
                        generator=g, device=dev) * 0.02   # embed_init
    bulk = tbag.field_ids(ids(vocab, (XDEEPFM_BULK, f)), vocab)
    multi = tbag.field_ids(ids(vocab, (XDEEPFM_P99, f, MULTI_HOT)), vocab)
    multi = multi.reshape(-1, MULTI_HOT)
    multi[rand(multi.shape) < 0.25] = -1
    calls = [("bag@xdeepfm_serve_bulk", "embedding_bag",
              (table, bulk.reshape(-1, 1)), {}),
             ("bag@xdeepfm_multihot", "embedding_bag", (table, multi), {})]

    feats = torch.randn(OGB_NODES, PNA_DIM, generator=g, device=dev)
    nbr = ids(OGB_NODES, (OGB_NODES, OGB_K))
    deg = torch.randint(OGB_DEG[0], OGB_DEG[1] + 1, (OGB_NODES, 1),
                        generator=g, device=dev)
    nbr[torch.arange(OGB_K, device=dev)[None, :] >= deg] = -1
    calls.append(("pna@ogbn_products", "pna_multi_agg", (feats, nbr), {}))
    feats = torch.randn(MB_NODES, PNA_DIM, generator=g, device=dev)
    n = MB_SEEDS
    for hop, fan in enumerate(MB_FANOUT, 1):
        nbr = ids(MB_NODES, (n, fan))
        nbr[(rand((n, 1)) < 0.1).expand(n, fan)] = -1  # degree-0 nodes
        calls.append((f"pna@reddit_minibatch/hop{hop}", "pna_multi_agg",
                      (feats, nbr), {}))
        n *= fan

    for site, (b, hq, hkv, d, window, dt) in ATTN_SITES.items():
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, h, ATTN_SEQ, d, generator=g, device=dev)
                   .to(dtype) for h in (hq, hkv, hkv))
        calls.append((site, "flash_attention", (q, k, v),
                      {"causal": True, "window": window}))
    return calls


def scatter_aggregate(feats, nbr):
    """PNA's four aggregations the way the model computes them
    (``gnn._pna_layer``: segment reductions over an edge list), written
    as ``scatter_reduce`` over src = nbr, dst = the node."""
    import torch
    n, k = nbr.shape
    d = feats.shape[1]
    dst = torch.arange(n, device=nbr.device).repeat_interleave(k)
    src = nbr.reshape(-1).long()
    keep = src >= 0
    src, dst = src[keep], dst[keep]
    m = feats[src]
    idx = dst[:, None].expand(-1, d)
    zeros = torch.zeros((n, d), device=feats.device)
    cnt = torch.zeros(n, device=feats.device).scatter_reduce(
        0, dst, torch.ones_like(dst, dtype=torch.float32), "sum")
    cnt = cnt.clamp_min(1.0)[:, None]
    mean = zeros.scatter_reduce(0, idx, m, "sum") / cnt
    mean_sq = zeros.scatter_reduce(0, idx, m * m, "sum") / cnt
    mn = torch.full_like(zeros, float("inf")).scatter_reduce(0, idx, m,
                                                             "amin")
    mx = torch.full_like(zeros, float("-inf")).scatter_reduce(0, idx, m,
                                                              "amax")
    std = torch.sqrt((mean_sq - mean * mean).clamp_min(0.0) + 1e-5)
    return torch.cat([mean, torch.where(torch.isfinite(mn), mn, 0.0),
                      torch.where(torch.isfinite(mx), mx, 0.0), std], dim=1)


def live_pairs(s, window):
    """Causal (query, key) pairs with a live entry at length ``s``."""
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


SECTOR = 32                   # bytes: the unit device memory moves


def row_sectors(ids, row_bytes, base=0):
    """The 32-byte sectors that the row of each id touches in a table of
    ``row_bytes``-byte rows starting ``base`` bytes past a sector
    boundary; 0 for padding (a negative id)."""
    import torch
    start = ids.long() * row_bytes + base
    n = (start + row_bytes - 1) // SECTOR - start // SECTOR + 1
    return torch.where(ids >= 0, n, 0)


def gather_floor_bytes(table, ids, out_bytes, chunk=1 << 24):
    """Bytes a gather must move when no row is served from cache: the
    sectors that every valid slot's row touches, the ids and the
    output."""
    row_bytes = table.shape[1] * table.element_size()
    base = table.data_ptr() % SECTOR
    flat = ids.reshape(-1)
    sectors = sum(int(row_sectors(flat[i:i + chunk], row_bytes, base).sum())
                  for i in range(0, flat.numel(), chunk))
    return sectors * SECTOR + ids.numel() * 4 + out_bytes


def model_work(kernel, args, kw):
    """(bytes, ops, extra) one call must move/do at least: every input
    read once and the output written once, counted from this call's
    data (distinct table and neighbour rows, valid slots, live
    pairs).  For the two gathers ``extra`` also holds the gather floor's
    bytes (``gather_floor_bytes``)."""
    import torch
    if kernel == "embedding_bag":
        table, idx = args
        elt = table.element_size()
        ok = idx >= 0
        valid = int(ok.sum())
        rows = int(torch.unique(idx[ok]).numel())
        d = table.shape[1]
        out_bytes = idx.shape[0] * d * elt
        nbytes = idx.numel() * 4 + rows * d * elt + out_bytes
        return nbytes, valid * d, {
            "valid_slots": valid, "distinct_rows": rows,
            "gathered_row_bytes": valid * d * elt,
            "gather_floor_bytes": gather_floor_bytes(table, idx, out_bytes)}
    if kernel == "pna_multi_agg":
        feats, nbr = args
        d = feats.shape[1]
        ok = nbr >= 0
        valid = int(ok.sum())
        rows = int(torch.unique(nbr[ok]).numel())
        out_bytes = nbr.shape[0] * 4 * d * 4
        nbytes = nbr.numel() * 4 + rows * d * 4 + out_bytes
        # per valid (neighbour, column): add, two for the fma, min, max
        return nbytes, valid * d * 5, {
            "valid_edges": valid, "distinct_rows": rows,
            "gathered_row_bytes": valid * d * 4,
            "gather_floor_bytes": gather_floor_bytes(feats, nbr, out_bytes)}
    q, k, v = args
    b, hq, s, d = q.shape
    live = live_pairs(s, kw["window"])
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return nbytes, 4 * b * hq * d * live, {"live_pairs_per_head": live}


def model_phase(seed, dev, report):
    """The model kernels at the widths of the repository's model
    configurations (step 8 of the module docstring); returns their sites
    and, for step 9's trace, each site's call."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as tbag
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_multi_agg as tpna
    from repro_torch.models import attention as tattn

    # the plain versions' f32 products run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = {"embedding_bag": ops.embedding_bag,
             "pna_multi_agg": ops.pna_multi_agg,
             "flash_attention": ops.attention}
    plain = {"embedding_bag": tbag.embedding_bag_plain,
             "pna_multi_agg": tpna.pna_multi_agg_plain,
             "flash_attention": tfa.flash_attention_plain}
    model: dict = {}
    t0 = time.perf_counter()
    calls = model_inputs(seed, dev)
    torch.cuda.synchronize()
    model["inputs_s"] = time.perf_counter() - t0

    # warm-up (library loads) on a slice of each kind of call
    for _, kern, args, kw in calls:
        if kern == "flash_attention":
            entry[kern](*(x[:1, :, :64].contiguous() for x in args), **kw)
        else:
            entry[kern](args[0], args[1][:1].contiguous(), **kw)
    torch.cuda.synchronize()

    # the main path: every counter from zero just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    outs, e2e_ms = [], []
    for _, kern, args, kw in calls:
        t0 = time.perf_counter()
        outs.append(entry[kern](*args, **kw))
        torch.cuda.synchronize()
        e2e_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    print(f"model launches: {json.dumps(launches)}")
    for name in ALL_KERNELS:
        want = sum(c[1] == name for c in calls)
        if launches[name] != want:
            raise AssertionError(f"model path launched {name} "
                                 f"{launches[name]} times, not {want}")

    sites, traces = [], {}
    for (site, kern, args, kw), got, ms_e2e in zip(calls, outs, e2e_ms):
        want = plain[kern](*args, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{site}: bad output {tuple(got.shape)} "
                                 f"{got.dtype}")
        err = float((got.float() - want.float()).abs().max())
        info = {"site": site, "kernel": kern, "launches": 1,
                "shapes": [list(x.shape) for x in args],
                "dtype": str(args[0].dtype), **kw, "max_abs_err": err,
                "e2e_ms": ms_e2e}
        if kern == "flash_attention":
            tol = 3e-2 if got.dtype == torch.bfloat16 else 2e-4
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            info["tolerance"] = tol
            if got.dtype == torch.bfloat16:
                # the plain version computes in bf16; the kernel, like the
                # Pallas kernel, in f32 from the bf16 inputs: held to the
                # plain version run in f32 on the same inputs and rounded
                # to bf16, it may differ by one rounding of the output
                f32 = plain[kern](*(x.float() for x in args), **kw)
                f32 = f32.to(torch.bfloat16).float()
                torch.testing.assert_close(got.float(), f32,
                                           rtol=BF16_RTOL, atol=BF16_ATOL)
                gap = (got.float() - f32).abs()
                info.update(
                    tolerance_f32_plain=[BF16_RTOL, BF16_ATOL],
                    max_abs_err_f32_plain=float(gap.max()),
                    max_rel_err_f32_plain=float(
                        (gap / f32.abs().clamp_min(BF16_ATOL)).max()),
                    outputs_off_f32_plain=int((gap > 0).sum()))
                del f32, gap
            if site == "attn@qwen3_0.6b":
                # the models' own chunked attention on its plain path
                yard = tattn.chunked_attention_plain(*args, **kw)
                torch.testing.assert_close(got.float(), yard.float(),
                                           rtol=tol, atol=tol)
                info["max_abs_err_model_attention"] = float(
                    (got.float() - yard.float()).abs().max())
                del yard
        elif not torch.equal(got.float().view(torch.int32),
                             want.float().view(torch.int32)):
            raise AssertionError(f"{site}: kernel != plain version "
                                 f"(max abs err {err})")
        if kern == "pna_multi_agg":
            # the model's own aggregation on the same edges (a 1/16
            # slice of the largest graph)
            feats, nbr = args
            n = nbr.shape[0] if nbr.shape[0] < 100_000 else \
                nbr.shape[0] // 16
            agg = scatter_aggregate(feats, nbr[:n])
            torch.testing.assert_close(got[:n], agg, rtol=1e-5, atol=1e-5)
            info.update(scatter_nodes_checked=n, max_abs_err_scatter=float(
                (got[:n] - agg).abs().max()))
            del agg
        del want

        nbytes, nops, extra = model_work(kern, args, kw)
        # attention's products belong on the tensor cores: in bf16 one
        # pass, in f32 three TF32 passes (3xTF32; the f32 CUDA-core time is
        # printed beside it); every other operation here is f32 on the CUDA
        # cores
        t_ops_ms = nops / F32_OPS_PER_S * 1e3
        if kern == "flash_attention":
            if args[0].dtype == torch.bfloat16:
                t_ops_ms = nops / BF16_OPS_PER_S * 1e3
            else:
                extra["t_ops_cuda_cores_ms"] = t_ops_ms
                t_ops_ms = 3 * nops / TF32_OPS_PER_S * 1e3
        ms, turns, plain_ms, clocks = time_in_turns(
            lambda *c: entry[kern](*c, **kw),
            lambda *c: plain[kern](*c, **kw), [args])
        lib_ms, lib_note = None, None
        if kern == "embedding_bag":
            table, idx = args
            lib_args = (idx.clamp_min(0), (idx >= 0).to(table.dtype))
            lib_ms = event_ms(lambda i, w: F.embedding_bag(
                i, table, mode="sum", per_sample_weights=w), [lib_args],
                REPS)
            lib_note = "F.embedding_bag(mode='sum', per_sample_weights)"
        elif kern == "flash_attention":
            q = args[0]
            s = q.shape[2]
            pos = torch.arange(s, device=dev)
            if kw["window"] > 0:
                mask = (pos[None, :] <= pos[:, None]) & \
                    (pos[None, :] > pos[:, None] - kw["window"])
                lib_ms = event_ms(lambda *c: F.scaled_dot_product_attention(
                    *c, attn_mask=mask, enable_gqa=True), [args], REPS)
                lib_note = "F.scaled_dot_product_attention(bool window mask)"
            else:
                lib_ms = event_ms(lambda *c: F.scaled_dot_product_attention(
                    *c, is_causal=True, enable_gqa=True), [args], REPS)
                lib_note = "F.scaled_dot_product_attention(is_causal)"
        else:
            lib_note = ("none: PNA's four aggregations take four "
                        "scatter_reduce calls, not one")
        info.update(extra, bytes=nbytes, ops=nops, kernel_ms=ms,
                    kernel_ms_turns=turns, plain_ms=plain_ms,
                    library_ms=lib_ms, library=lib_note,
                    t_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    t_ops_ms=t_ops_ms,
                    clocks_sm_mem_power_temp=clocks)
        info["bound_ms"] = max(info["t_bytes_ms"], info["t_ops_ms"])
        if "gather_floor_bytes" in info:
            info["gather_floor_ms"] = (info["gather_floor_bytes"]
                                       / HBM_BYTES_PER_S * 1e3)
            print(f"{site}: kernel {ms:.4f} ms, gather floor "
                  f"{info['gather_floor_ms']:.4f} ms, bound "
                  f"{info['bound_ms']:.4f} ms, library {lib_ms} ms")
        if kern == "flash_attention":
            info["tflops"] = nops / ms / 1e9
            print(f"{site}: {info['tflops']:.1f} TFLOP/s; kernel {ms:.4f} "
                  f"ms, SDPA {lib_ms:.4f} ms, bound {info['bound_ms']:.4f} "
                  f"ms ({info['dtype']})")
        print(f"model kernel site: {json.dumps(info)}")
        sites.append(info)
        # the site's call, traced at the end for its device time: one
        # warm-up, then MODEL_TRACED counted calls
        traces[site] = (kern, functools.partial(entry[kern], **kw),
                        [args] * (1 + MODEL_TRACED), 1)
    model["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print(f"model: {json.dumps(model)}")
    report["model"] = {**model, "kernel_sites": sites}
    del calls, outs
    torch.cuda.empty_cache()
    return sites, traces


# tuning phase: the tuned-geometry path at the 1M tier


def bitonic_work(kind, args, tile, q_real):
    """(bytes, ops) a bitonic candidate call must move/do at least,
    whatever implements it: the candidate kernel's bytes (``kernel_work``:
    the routed blocks, the real pairs' rows, norm/rank of visited tiles,
    the candidates written) and, per posting lane, Q products + Q adds;
    per (query, doc) of a visited tile, the 5-op scoring tail and one
    compare (a selection of the first k_tile looks at each doc once)."""
    nbytes, _, real, blocks, tiles = kernel_work(kind, args, tile, q_real)
    ops = blocks * 128 * 2 * q_real + q_real * tiles * tile * (5 + 1)
    return nbytes, ops, real, blocks, tiles


def signed_zero_docs(n, tile, dev):
    """A doc table whose final scores, at qnorm 1e30 and rank_blend 0.5,
    hold zeros of both signs (``tests/test_torch_cuda.py``'s "mixed"
    table): per 64 docs one positive (norm 1.0: a cosine near 1e-30), four
    zeros (norm 3e38 overflows the denominator; half a rank of plus or
    minus the least subnormal rounds to a zero of that sign), the rest
    deleted; +0.0 in each tile's first half and every third 16 docs after
    it but the last four, -0.0 elsewhere."""
    import numpy as np
    import torch

    from repro_torch.core.layouts import DocTable
    tiny = float(np.float32(np.finfo(np.float32).smallest_subnormal))
    d = torch.arange(n, device=dev)
    pos = d % tile
    plus = ((pos < tile // 2) | ((pos // 16) % 3 == 0)) & (pos < tile - 64)
    return DocTable(norm=torch.where(d % 64 == 1, 1.0,
                                     torch.where(d % 16 == 0, 3e38, 0.0)),
                    rank=torch.where(plus, tiny, -tiny))


def edge_calls(ix, name, batch, cap, dev):
    """Step 10 (b)'s edge calls on one layout's last bulk batch, each held
    to its plain version to the bit (a NaN slot to a NaN slot, whatever
    the payloads): the bitonic epilogue at k_tile 64;
    both epilogues with a NaN rank on 16 docs of 16 tiles (those CTAs take
    the network, the others the selection; the successive epilogue writes
    (NaN, -1) through every row holding one); the successive epilogue over
    ``signed_zero_docs`` at k_tile 64.  Returns the counts it prints."""
    import torch

    from repro_torch.core import layouts, query
    from repro_torch.core.layouts import DocTable
    from repro_torch.kernels import fused_decode_score as fds
    from repro_torch.kernels import ops

    wrapper, plain = getattr(fds, name), getattr(fds, name + "_plain")
    qh = layouts.hash_tensor(batch, dev)

    def held(index, label, reducer, **kw):
        tids, idf_t = query.lookup_query(index, qh)
        _, _, args, akw, _ = ops.fused_topk_args(index, tids, idf_t, cap, K,
                                                 **kw)
        akw = dict(akw, reducer=reducer)
        got, want = wrapper(*args, **akw), plain(*args, **akw)
        torch.cuda.synchronize()
        # a NaN equals a NaN in the same slot, whatever its payload: the
        # card's tail makes 0x7fffffff, the plain version's f64 FMA another
        nan = got[0].isnan()
        if not (torch.equal(got[1], want[1])
                and torch.equal(nan, want[0].isnan())
                and torch.equal(got[0].view(torch.int32)[~nan],
                                want[0].view(torch.int32)[~nan])):
            raise AssertionError(f"{name} {label}: kernel != plain version")
        return got[0]

    out = {}
    v = held(ix, "bitonic k_tile 64", "bitonic", k_tile=64)
    out["bitonic_k64_finite_slots"] = int(v.isfinite().sum())
    n = int(ix.docs.num_docs)
    rank = ix.docs.rank.clone()
    nan_docs = torch.arange(16, device=dev) * (n // 16) + 5
    rank[nan_docs] = float("nan")
    nan_ix = dataclasses.replace(ix, docs=DocTable(norm=ix.docs.norm,
                                                   rank=rank))
    for reducer in ("bitonic", "successive"):
        v = held(nan_ix, f"{reducer} NaN ranks", reducer, rank_blend=0.3)
        out[f"{reducer}_nan_slots"] = int(v.isnan().sum())
    if out["successive_nan_slots"] == 0:
        raise AssertionError(f"{name}: the NaN ranks gave no NaN row")
    zx = dataclasses.replace(ix, docs=signed_zero_docs(n, fds.TILE, dev))
    v = held(zx, "successive signed zeros", "successive", k_tile=64,
             rank_blend=0.5, qnorm=torch.full((BATCH,), 1e30, device=dev))
    zero = v == 0
    out["successive_zero_slots"] = int(zero.sum())
    out["successive_minus_zero_slots"] = int((zero & v.signbit()).sum())
    if not out["successive_minus_zero_slots"] or \
            out["successive_zero_slots"] == out["successive_minus_zero_slots"]:
        raise AssertionError(f"{name}: the signed-zero call gave {out}")
    return out


def same_answer(a, b):
    """Two QueryResults equal in ids and score bits."""
    import torch
    return torch.equal(a.doc_ids, b.doc_ids) and torch.equal(
        a.scores.view(torch.int32), b.scores.view(torch.int32))


def tuning_sweep(host, cap, batches, dev):
    """Step 10's sweep: the HOR and the packed index built afresh,
    ``autotune_index`` over the first bulk batch on each (the tuned
    path's main run: every counter from zero just before, read just
    after), the winners in a fresh table that round-trips through a file
    in a temporary directory.  Returns the tuning state the later checks
    take."""
    import tempfile

    import torch

    from repro_torch.core import layouts, query
    from repro_torch.kernels import autotune

    if len(autotune.get_active()):
        raise AssertionError("tuning: the active table is not empty")
    builders = {"hor": layouts.build_blocked,
                "packed": layouts.build_packed_csr}
    state = {"table": autotune.TuningTable(), "layouts": {},
             "memory_allocated_at_start": torch.cuda.memory_allocated(dev)}
    for name, (kind, _) in KERNELS.items():
        bname = name + "_bitonic"
        t0 = time.perf_counter()
        ix = builders[kind](host, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        qh0 = query.dedup_query_hashes(layouts.hash_tensor(batches[0], dev))
        _, idf0 = query.lookup_query(ix, qh0)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        best, records = autotune.autotune_index(
            ix, qh0, idf0, k=K, cap=cap, reps=TUNE_REPS,
            table=state["table"])
        sweep_s = time.perf_counter() - t0
        launches = read_launches()
        configs = [autotune.TuneConfig.from_dict(r["config"])
                   for r in records]
        n_bit = sum(c.reducer == "bitonic" for c in configs)
        want = {name: (len(configs) - n_bit) * (1 + TUNE_REPS),
                bname: n_bit * (1 + TUNE_REPS)}
        if len(configs) != 8 or n_bit == 0 or any(
                launches[n] != want.get(n, 0) for n in ALL_KERNELS):
            raise AssertionError(f"tuning {kind}: the sweep of {len(configs)}"
                                 f" configs launched {launches}")
        state["layouts"][kind] = {
            "index": ix, "name": name, "best": best, "records": records,
            "configs": configs, "build_s": build_s, "sweep_s": sweep_s,
            "size_class": autotune.size_class_of(int(ix.docs.num_docs)),
            "sweep_launches": {n: launches[n] for n in (name, bname)}}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tuned.json"
        state["table"].save(str(path))
        state["loaded"] = autotune.TuningTable.load(str(path))
    if state["loaded"].to_dict() != state["table"].to_dict() or any(
            state["loaded"].get(dev.type, lay["size_class"], kind)
            != lay["best"] for kind, lay in state["layouts"].items()):
        raise AssertionError("tuning: the table's round trip changed it")
    return state


def tuning_live(si, batches, state):
    """Step 10 (e): on the live phase's index, one batch per mode with
    every segment on the bitonic reducer, and one with each winner, give
    the untuned answers, ids and score bits, with no routing overflow;
    the bitonic candidate batch launches both bitonic kernels, and each
    of its candidate kernel calls equals its plain version."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import fused_decode_score as fds

    view = si.view()
    tunes = {"bitonic": autotune.TuneConfig(reducer="bitonic")}
    for kind, lay in state["layouts"].items():
        if lay["best"] not in tunes.values():
            tunes[f"winner_{kind}"] = lay["best"]
    live = {}
    for label, cfg in tunes.items():
        for mode in ("candidates", "dense"):
            want = view.topk(batches[0], K, mode=mode)
            reset_launches()
            with recording(ops, on=label == "bitonic") as calls:
                res, stats = view.topk(batches[0], K, mode=mode, tune=cfg,
                                       return_stats=True)
            got = read_launches()
            # the dense calls were held to their plain versions in step 6
            calls = [c for c in calls if c[0] in KERNELS]
            if stats["pair_overflow"] or not same_answer(res, want):
                raise AssertionError(f"tuning live {label} {mode}: answer "
                                     "differs from the untuned one")
            if label == "bitonic" and mode == "candidates" and not all(
                    got[n] for n in BITONIC_KERNELS):
                raise AssertionError(f"tuning live: bitonic launches {got}")
            held = replay(calls, fds, f"tune-live-{mode}", timed=False,
                          tag="tune live") if calls else []
            live[f"{label}/{mode}"] = {
                "launches": {n: v for n, v in got.items() if v},
                "held_calls": len(held)}
            del calls
    print(f"tune live: {json.dumps(live)}")
    return live


def tuning_checks(host, batches, cap, dev, report, state):
    """Step 10 (a)-(d) and (f) on the swept indexes, and each bitonic
    config's site: held to its plain version on every bulk batch and
    timed in turns.  Returns the bitonic sites and their traces."""
    import numpy as np
    import torch

    from repro_torch.core import layouts, query, size_model
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import fused_decode_score as fds

    tuning = {"memory_allocated_at_start":
              state["memory_allocated_at_start"]}
    # (a) every config on every bulk batch gives the default config's
    # answer, ids and score bits, with no routing overflow
    answers = {}
    for kind, lay in state["layouts"].items():
        ix = lay["index"]
        default = query.make_scorer(ix, k=K, cap=cap, engine="fused")
        answers[kind] = [default(qb) for qb in batches]
        rows = []
        for cfg, rec in zip(lay["configs"], lay["records"]):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            scorer = query.make_scorer(ix, k=K, cap=cap, engine="fused",
                                       return_stats=True, tune=cfg)
            for i, (qb, want) in enumerate(zip(batches, answers[kind])):
                res, stats = scorer(qb)
                if stats["pair_overflow"] or not same_answer(res, want):
                    raise AssertionError(
                        f"tuning {kind} {cfg}: batch {i} differs from the "
                        f"default config's (overflow "
                        f"{stats['pair_overflow']})")
            torch.cuda.synchronize()
            rows.append({
                "config": rec["config"], "median_ms": rec["median_s"] * 1e3,
                "max_pairs": ops.padded_pairs_budget(ix, cfg.tile,
                                                     cfg.pairs_per_step),
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "candidate_bytes_per_query":
                    rec["candidate_bytes_per_query"],
                "is_default": rec["is_default"]})
        lay["rows"] = rows

    # (b) every bitonic call on every bulk batch equals its plain version
    # to the bit, and the successive kernel's ids (and value bits but at
    # signed zeros); each bitonic config's site timed over the last two
    # batches in turns with the successive kernel and the plain version
    sites, traces = [], {}
    for kind, lay in state["layouts"].items():
        ix, name = lay["index"], lay["name"]
        bname = name + "_bitonic"
        wrapper, plain = getattr(fds, name), getattr(fds, name + "_plain")
        num_docs = int(ix.docs.num_docs)
        for cfg in lay["configs"]:
            if cfg.reducer != "bitonic":
                continue
            k_tile = cfg.resolve_k_tile(K)
            calls, work = [], []
            max_err, signed_zeros = 0.0, 0
            for i, qb in enumerate(batches):
                tids, idf_t = query.lookup_query(
                    ix, layouts.hash_tensor(qb, dev))
                _, _, args, kw, _ = ops.fused_topk_args(
                    ix, tids, idf_t, cap, K, tile=cfg.tile, k_tile=k_tile,
                    q_pad=cfg.q_pad, pairs_per_step=cfg.pairs_per_step)
                bkw = dict(kw, reducer="bitonic")
                got, want = wrapper(*args, **bkw), plain(*args, **bkw)
                succ = wrapper(*args, **kw)
                torch.cuda.synchronize()
                eq, err = same_candidates(got, want)
                max_err = max(max_err, err)
                if not eq:
                    raise AssertionError(f"{bname} {cfg}: kernel != plain "
                                         f"version (max abs err {err})")
                if not torch.equal(got[1], succ[1]):
                    raise AssertionError(f"{bname} {cfg}: ids != the "
                                         "successive kernel's")
                differ = got[0].view(torch.int32) != succ[0].view(torch.int32)
                zero = differ & (got[0] == 0) & (succ[0] == 0)
                if bool((differ & ~zero).any()):
                    raise AssertionError(f"{bname} {cfg}: values != the "
                                         "successive kernel's")
                signed_zeros += int(zero.sum())
                work.append(bitonic_work(kind, args, cfg.tile, BATCH))
                if i >= len(batches) - 2:
                    calls.append(args)
                del got, want, succ
            b1 = event_ms(lambda *c: wrapper(*c, **bkw), calls, REPS)
            s1 = event_ms(lambda *c: wrapper(*c, **kw), calls, REPS)
            plain_ms = event_ms(lambda *c: plain(*c, **bkw), calls, 1)
            b2 = event_ms(lambda *c: wrapper(*c, **bkw), calls, REPS)
            s2 = event_ms(lambda *c: wrapper(*c, **kw), calls, REPS)
            clocks = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
            # the library yardstick: one stable descending torch.sort of
            # each tile of the dense kernel's final scores (the last
            # batch's), as extract_tile_candidates takes them; it gives
            # the kernel's candidate ids
            got_ids = wrapper(*calls[-1], **bkw)[1][:BATCH]
            tids, idf_t = query.lookup_query(
                ix, layouts.hash_tensor(batches[-1], dev))
            dk, _, dargs, dkw, _ = ops.fused_score_args(
                ix, tids, idf_t, cap, tile=cfg.tile, q_pad=cfg.q_pad)
            final = query.final_scores(dk(*dargs, **dkw)[:BATCH],
                                       ix.docs.norm, ix.docs.rank,
                                       query.query_norm(idf_t), 0.0)
            del dargs
            if not torch.equal(fds.extract_tile_candidates(
                    final, cfg.tile, k_tile)[1], got_ids):
                raise AssertionError(f"{bname} {cfg}: the sorted dense "
                                     "scores give other candidates")
            n_tiles = -(-num_docs // cfg.tile)
            tiled = torch.nn.functional.pad(
                final, (0, n_tiles * cfg.tile - num_docs),
                value=float("-inf")).view(BATCH, n_tiles, cfg.tile)
            library_ms = event_ms(lambda: torch.sort(
                tiled, dim=-1, descending=True, stable=True), [()], REPS)
            del final, tiled
            label = "bitonic" if cfg.k_tile is None else f"k{k_tile}_bitonic"
            nbytes = float(np.mean([w[0] for w in work]))
            nops = float(np.mean([w[1] for w in work]))
            site = {
                "site": f"tune:{bname}@{num_docs}:{label}", "kernel": bname,
                "config": cfg.to_dict(), "k_tile": k_tile,
                "launches": 1 + TUNE_REPS, "max_abs_err": max_err,
                "signed_zero_differences": signed_zeros,
                "kernel_ms": (b1 + b2) / 2, "kernel_ms_turns": [b1, b2],
                "successive_ms": (s1 + s2) / 2,
                "successive_ms_turns": [s1, s2], "plain_ms": plain_ms,
                "library_ms": library_ms, "bytes": nbytes, "ops": nops,
                "t_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "t_ops_ms": nops / F32_OPS_PER_S * 1e3,
                "clocks_sm_mem_power_temp": clocks,
                **site_stats(name, calls[-1], num_docs, cfg.tile, "bitonic")}
            sites.append(site)
            print(f"tune kernel site: {json.dumps(site)}")
            traces[site["site"]] = (bname, functools.partial(wrapper, **bkw),
                                    [calls[-1]])
            del calls
            torch.cuda.empty_cache()
        edges = edge_calls(ix, name, batches[-1], cap, dev)
        tuning[f"edge_calls_{kind}"] = edges
        print(f"tune edge calls {kind}: {json.dumps(edges)}")
        torch.cuda.empty_cache()

    # (c) the table, as loaded, active: make_scorer gives the empty
    # table's answers, through the winner's kernel
    for kind, lay in state["layouts"].items():
        ix, name, best = lay["index"], lay["name"], lay["best"]
        autotune.set_active(state["loaded"])
        try:
            scorer = query.make_scorer(ix, k=K, cap=cap, engine="fused",
                                       return_stats=True)
            reset_launches()
            for i, (qb, want) in enumerate(zip(batches, answers[kind])):
                res, stats = scorer(qb)
                if stats["pair_overflow"] or not same_answer(res, want):
                    raise AssertionError(f"tuning {kind}: batch {i} with the "
                                         "table active differs")
            tabled = read_launches()
        finally:
            autotune.set_active(None)
        ran = name + "_bitonic" if best.reducer == "bitonic" else name
        if tabled[ran] != len(batches):
            raise AssertionError(f"tuning {kind}: the table's winner ran "
                                 f"{tabled}")
        default_ms = [r["median_ms"] for r in lay["rows"]
                      if r["is_default"]][0]
        best_ms = [r["median_ms"] for r in lay["rows"]
                   if r["config"] == best.to_dict()][0]
        tuning[kind] = {
            "index_build_s": lay["build_s"], "sweep_s": lay["sweep_s"],
            "size_class": lay["size_class"], "configs": lay["rows"],
            "winner": best.to_dict(),
            "default_over_winner": default_ms / best_ms,
            "sweep_launches": lay["sweep_launches"],
            "tabled_launches": {n: tabled[n]
                                for n in (name, name + "_bitonic")}}
        print(f"tune {kind}: {json.dumps(tuning[kind])}")

    # (d) the layout chooser reads both measured costs at the 1M class
    cls_ = state["layouts"]["hor"]["size_class"]
    autotune.set_active(state["loaded"])
    try:
        d = size_model.LayoutCostModel().choose(size_model.SegmentStats(
            num_docs=host.num_docs, num_postings=host.num_postings,
            num_terms=host.num_terms), size_class=cls_,
            device_type=dev.type)
    finally:
        autotune.set_active(None)
    if not d.reason.startswith(f"measured:{dev.type}@{cls_} "):
        raise AssertionError(f"tuning: the chooser's reason {d.reason!r}")
    tuning["layout_decision"] = dataclasses.asdict(d)
    tuning["table"] = state["loaded"].to_dict()
    print(f"tune table: {json.dumps(tuning['table'])}; layout decision "
          f"{json.dumps(tuning['layout_decision'])}")
    # (f) the empty table again before the trace
    autotune.set_active(None)
    if len(autotune.get_active()):
        raise AssertionError("tuning: the active table is not empty")
    report["tuning"] = tuning
    return sites, traces

# distributed phase (step 11): S shards of one mesh, run in turn on one card
DIST_SHARDS = 4
MESH_QUERIES = 32             # distinct queries per epoch of each mesh
MESH_REPEATS = 8              # of them again at the first epoch: cache hits
MESH_NEW_DOCS = 2_048         # ingested between a mesh's two epochs
TERM_MESH_DOCS = NEW_DOCS     # the term topology's index: the 1m tier's
#                               churn batch (it rebuilds at every handoff)


def stack_row_launches(metas, n_shards):
    """Launches one row of the segment-stack scorer implies: ``idf`` and
    ``query_norm`` once per shard, and per shard and slot (inert ones
    too) one candidate launch for an HOR or packed group, one dense
    launch per band for a banded group (the active table's reducer)."""
    from repro_torch.kernels import autotune
    per = {"idf": n_shards, "query_norm": n_shards}
    for m in metas:
        n = n_shards * m.n_slots
        if m.layout == "banded":
            names = ("fused_score_packed", "fused_score_blocked")
        else:
            name = ("fused_topk_packed" if m.layout == "packed"
                    else "fused_topk_blocked")
            if autotune.lookup("cuda", m.d_pad, m.layout).reducer == \
                    "bitonic":
                name += "_bitonic"
            names = (name,)
        for name in names:
            per[name] = per.get(name, 0) + n
    return per


def held_want(per_row):
    """The fused-kernel calls one row's ``per_row`` launches imply: the
    calls ``holding`` must see (the weights kernels are not held)."""
    return sum(n for name, n in per_row.items() if name not in WEIGHT_KERNELS)


ALLOC_WAITS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
               "num_sync_all_streams")


def sync_probe(call, row):
    """``call(row)`` once more, traced where it takes ``trace=``, under
    torch's sync debug mode: the ``shard_fanout`` / ``shard_sync`` spans
    (ms), the synchronising calls torch reports in it (count by
    file:line), and the caching allocator's device allocations, frees,
    retries and all-stream syncs in it (``cudaFree`` waits for the
    device).  Says where the host waited inside the shards' work."""
    import inspect
    import os
    import warnings

    import torch

    from repro_torch.obs.trace import Trace
    tr = Trace()
    kw = {"trace": tr} if "trace" in inspect.signature(call).parameters \
        else {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call(row, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    sites: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    spans = {sp.name: sp.duration_us / 1e3 for sp in tr.spans}
    return {"fanout_ms": spans.get("shard_fanout"),
            "sync_ms": spans.get("shard_sync"), "host_syncs": sites,
            "allocator": {k: (after[k] - before[k] if k in after else None)
                          for k in ALLOC_WAITS}}


def dist_want(per_row, rows):
    want = dict.fromkeys((*ALL_KERNELS, *WEIGHT_KERNELS), 0)
    for name, n in per_row.items():
        want[name] += n * rows
    return want


def dist_rows(label, scorer, rows, per_row):
    """One query per scorer call, over ``rows``, with every launch
    counter reset just before and read just after; ms a row by the host
    clock with ``synchronize``.  Checks the launches against ``per_row``
    and that no routing pair overflowed; probes the last row
    (``sync_probe``); then calls the scorer once more on it with every
    kernel call held to its plain version as it returns (``holding``),
    as many calls as ``per_row`` implies.  Returns (answers, ms per row,
    launches, the held calls' sites, the probe)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.obs.registry import GLOBAL
    overflow0 = GLOBAL.counter("engine_pair_overflow").value
    reset_launches()
    out, ms = [], []
    for row in rows:
        t0 = time.perf_counter()
        v, ids = scorer(row)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(host_answer(v, ids))
    got = read_launches()
    want = dist_want(per_row, len(rows))
    if got != want:
        raise AssertionError(f"distributed {label}: launches {got}, the "
                             f"structure implies {want}")
    if GLOBAL.counter("engine_pair_overflow").value != overflow0:
        raise AssertionError(f"distributed {label}: routing overflow")
    probe = sync_probe(scorer, rows[-1])
    with holding(ops, f"dist-{label}") as held:
        again = host_answer(*scorer(rows[-1]))
    if not same_bits(again, out[-1]):
        raise AssertionError(f"distributed {label}: the held call answers "
                             "otherwise")
    if len(held) != held_want(per_row):
        raise AssertionError(f"distributed {label}: {len(held)} kernel calls "
                             f"held, the structure implies "
                             f"{held_want(per_row)}")
    return out, ms, got, held, probe


def host_answer(v, ids):
    """A sharded scorer's (scores, ids) as host (ids, scores), misses as
    (-1, 0.0), as ``MeshServer`` answers them."""
    import numpy as np
    v, ids = v.cpu().numpy(), ids.cpu().numpy()
    hit = np.isfinite(v)
    return (np.where(hit, ids, -1).astype(np.int32),
            np.where(hit, v, 0.0).astype(np.float32))


def hold_to_single_node(label, ids, sc, single_node):
    """Ids equal to the single-node fused engine's but at printed near
    ties, scores within rtol 1e-5; returns the near ties."""
    swaps = near_tie_swaps(ids, sc, single_node[0][:len(ids)],
                           single_node[1][:len(ids)], K)
    for case in swaps:
        case.update(engine=label)
        print(f"near-tie swap: {json.dumps(case)}")
    return swaps


def same_bits(a, b):
    import numpy as np
    return (np.array_equal(a[0], b[0])
            and np.array_equal(a[1].view(np.int32), b[1].view(np.int32)))


def distributed_phase(host, batches, si, single_node, seed, dev, report,
                      card):
    """Step 11: the distributed engines and ``MeshServer`` as
    ``DIST_SHARDS`` shards of one mesh, run in turn on one card; (a)-(e)
    of the module docstring, written to ``report["distributed"]``.
    Nothing here is a multi-GPU measurement, and no kernel time: every
    kernel call of a sub-step's last query is held to its plain version
    as it returns, and none is kept for timing (the earlier phases'
    traced calls already hold most of the card's memory)."""
    import numpy as np
    import torch

    from repro_torch.core import build, live_index
    from repro_torch.distributed import retrieval, shmap
    from repro_torch.kernels import ops
    from repro_torch.obs.registry import GLOBAL, percentiles
    from repro_torch.serve import MeshConfig, MeshServer
    from repro_torch.text import corpus

    S = DIST_SHARDS
    mesh = shmap.make_mesh(S, "shards", device=dev)
    out: dict = {"shards": S, "device": card,
                 "note": f"{S} shards of one mesh, run in turn on one card"}
    rows = [np.asarray(q, np.uint32) for q in batches[0]]

    def engine(label, index, maker, per_row, build_s, single=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        scorer = maker(index, mesh, "shards", k=K)
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        scorer(rows[0])                       # warm-up (allocator)
        ans, ms, got, held, probe = dist_rows(label, scorer, rows, per_row)
        ids = np.stack([i for i, _ in ans])
        sc = np.stack([v for _, v in ans])
        line = {"build_s": build_s, "to_device_s": put_s,
                "ms_per_row": ms, "launches": {k: v for k, v in got.items()
                                               if v},
                "held_calls": len(held), "sync_probe": probe,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
        if single:
            line["near_tie_swaps"] = hold_to_single_node(label, ids, sc,
                                                         single_node)
        print(f"distributed {label}: {json.dumps(line)}")
        out[label] = line
        return ids, sc

    def built(fn, *args, **kw):
        t0 = time.perf_counter()
        ix = fn(*args, **kw)
        return ix, time.perf_counter() - t0

    # (a) bulk doc-sharded: HOR and packed fused, and the gather oracle
    fused = {"idf": S, "query_norm": S}
    answers = {}
    for lay in ("hor", "packed"):
        (ix, reason), s_ = built(retrieval.build_doc_sharded_fused, host, S,
                                 layout=lay)
        name = "fused_topk_packed" if lay == "packed" else "fused_topk_blocked"
        answers[f"doc_{lay}"] = engine(
            f"doc_{lay}", ix, retrieval.make_doc_sharded_fused_scorer,
            {**fused, name: S}, s_)
        out[f"doc_{lay}"]["reason"] = reason
        del ix
    ix, s_ = built(retrieval.build_doc_sharded, host, S)
    engine("doc_oracle", ix, retrieval.make_doc_sharded_scorer, fused, s_)
    del ix
    if not same_bits(answers["doc_hor"], answers["doc_packed"]):
        raise AssertionError("doc-sharded HOR and packed answers differ")

    # (b) term-sharded fused: HOR, packed, banded
    dense = {"hor": ("fused_score_blocked",), "packed": ("fused_score_packed",),
             "banded": ("fused_score_packed", "fused_score_blocked")}
    for lay, names in dense.items():
        ix, s_ = built(retrieval.TERM_BUILDERS[lay], host, S)
        answers[f"term_{lay}"] = engine(
            f"term_{lay}", ix, retrieval.make_term_sharded_fused_scorer,
            {"idf": S, **{n: S for n in names}}, s_)
        del ix
    if not same_bits(answers["term_hor"], answers["term_packed"]):
        raise AssertionError("term-sharded HOR and packed answers differ")
    torch.cuda.empty_cache()

    # (c) the sharded segment stack over the live phase's index
    if si.delta_postings or si._delta.n_docs:
        si.seal()
    view = si.view()
    t0 = time.perf_counter()
    stack = retrieval.stack_segment_shards(view, S)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    metas = stack.signature()
    groups = []
    for m, (_, arrs) in zip(metas, stack.groups):
        mp = retrieval._pair_budget(m.route_pairs_max, 3,
                                    max(m.max_blocks_per_term, 1),
                                    m.route_span_max)
        g = {"layout": m.layout, "size_class": m.d_pad, "n_slots": m.n_slots,
             "filled_slots": int((arrs["norm"].abs().sum(-1) > 0).sum()),
             "bytes": sum(t.numel() * t.element_size()
                          for t in arrs.values()),
             "pair_budget_per_slot": mp,
             "pairs_routed_per_row": mp * S * m.n_slots}
        if m.layout == "banded":
            mh = retrieval._pair_budget(m.hor_route_pairs_max, 3,
                                        max(m.hor_max_blocks_per_term, 1),
                                        m.hor_route_span_max)
            g["hor_pair_budget_per_slot"] = mh
            g["pairs_routed_per_row"] += mh * S * m.n_slots
        groups.append(g)
        print(f"distributed stack group: {json.dumps(g)}")
    stack_ids, stack_sc = engine(
        "stack", stack, retrieval.make_doc_sharded_segment_scorer,
        stack_row_launches(metas, S), stack_s, single=False)
    ref = view.topk(np.stack(rows), K)
    if not np.array_equal(stack_ids, ref.doc_ids.cpu().numpy()):
        raise AssertionError("stack ids != view.topk's")
    np.testing.assert_allclose(stack_sc, ref.scores.cpu().numpy(),
                               rtol=1e-5, atol=0)
    out["stack"].update(groups=groups, not_bit_equal=int(
        (stack_sc.view(np.int32)
         != ref.scores.cpu().numpy().view(np.int32)).sum()))
    del stack, view
    torch.cuda.empty_cache()

    # (d), (e): MeshServer over each topology
    def mesh_queries(df, hashes, num_docs, seed0):
        qs, seen, s_ = [], set(), 0
        while len(qs) < MESH_QUERIES:
            q = corpus.sample_query_terms(
                df, hashes, 1, TERMS, df_band=(0.15, 0.5),
                num_docs=num_docs, seed=seed0 + s_)[0]
            s_ += 1
            row = np.zeros(8, np.uint32)
            row[:len(q)] = q
            if row.tobytes() not in seen:
                seen.add(row.tobytes())
                qs.append(row)
        return qs

    def new_batch(n, s_):
        return corpus.generate(corpus.CorpusSpec(
            num_docs=n, vocab=VOCAB, avg_distinct=AVG_DISTINCT, seed=s_))

    def run_mesh(label, index, cfg, new_docs, qrows, per_row_of):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        overflow0 = GLOBAL.counter("engine_pair_overflow").value
        t0 = time.perf_counter()
        ms = MeshServer(index, cfg, mesh=mesh)
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        ms.warmup()

        def serve(qs):
            t0 = time.perf_counter()
            tickets = [ms.submit(q) for q in qs]
            while ms.pending:
                ms.pump()
            wall = time.perf_counter() - t0
            return [t.result(timeout=600.0) for t in tickets], wall

        per_epoch = {}
        for step in ("e0", "e1"):
            if step == "e1":
                t0 = time.perf_counter()
                base = ms.index.num_docs
                ms.add_batch(new_docs)
                ms.delete_docs(np.arange(base, base + new_docs.num_docs, 64))
                pause = ms.handoff()
                write_s = time.perf_counter() - t0
            epoch = ms.serving_epoch
            reset_launches()
            resp, wall = serve(qrows)
            got = read_launches()
            want = dist_want(per_row_of(ms._state), len(qrows))
            if got != want:
                raise AssertionError(f"mesh {label} {step}: launches {got}, "
                                     f"the structure implies {want}")
            if any(r.epoch != epoch or r.cached or r.status != "ok"
                   for r in resp):
                raise AssertionError(f"mesh {label} {step}: not served fresh "
                                     f"at epoch {epoch}")
            # the single-host QueryServer's computation over the same pin:
            # ids identical, scores within rtol 1e-5 (bit differences
            # counted: a single row's norm chains FMAs at every width)
            view = ms.serving_view
            not_bits = 0
            for b0 in range(0, len(qrows), BATCH):
                res = view.topk(np.stack(qrows[b0:b0 + BATCH]), K)
                ids = np.stack([r.doc_ids for r in resp[b0:b0 + BATCH]])
                sc = np.stack([r.scores for r in resp[b0:b0 + BATCH]])
                if not np.array_equal(ids, res.doc_ids.cpu().numpy()):
                    raise AssertionError(f"mesh {label} {step}: ids != the "
                                         "single-host server's")
                want_sc = res.scores.cpu().numpy()
                np.testing.assert_allclose(sc, want_sc, rtol=1e-5, atol=0)
                not_bits += int((sc.view(np.int32)
                                 != want_sc.view(np.int32)).sum())
            entry = {"epoch": epoch, "wall_s": wall,
                     "qps": len(qrows) / wall, "not_bit_equal": not_bits,
                     "launches": {k: v for k, v in got.items() if v}}
            p = percentiles([r.latency_us for r in resp])
            entry.update(p50_us=p["p50"], p99_us=p["p99"])
            # a micro-batch's spans are adopted by each of its tickets:
            # read them once per batch
            acc: dict = {}
            for r in resp[::cfg.batch_size]:
                for sp in r.trace.spans:
                    if sp.name in ("shard_fanout", "shard_sync", "score"):
                        acc[sp.name] = acc.get(sp.name, 0.0) + \
                            sp.duration_us / 1e3
            entry["span_ms_per_row"] = {k: v / len(resp)
                                        for k, v in acc.items()}
            if step == "e0":
                reset_launches()
                hits, _ = serve(qrows[:MESH_REPEATS])
                if any(read_launches().values()):
                    raise AssertionError(f"mesh {label}: cache hits launched")
                for r, want_r in zip(hits, resp):
                    if not (r.cached and same_bits(
                            (r.doc_ids, r.scores),
                            (want_r.doc_ids, want_r.scores))):
                        raise AssertionError(f"mesh {label}: a cache hit "
                                             "differs from its response")
            else:
                entry.update(write_s=write_s, handoff_pause_s=pause)
            for r in resp:
                stages = r.trace.stage_durations()
                if abs(sum(stages.values()) - r.latency_us) > \
                        STAGE_REL * r.latency_us:
                    raise AssertionError(f"mesh {label}: stages {stages}")
            per_epoch[step] = entry
        digests = {r.digest() for r in ms.replicas}
        if len(digests) != 1:
            raise AssertionError(f"mesh {label}: replicas differ {digests}")
        if GLOBAL.counter("engine_pair_overflow").value != overflow0:
            raise AssertionError(f"mesh {label}: routing overflow")
        # the last row's call again, each kernel call held to its plain
        # version as it returns; it answers as the served response did
        probe = sync_probe(ms._state.score_row, qrows[-1])
        with holding(ops, f"dist-mesh-{label}") as held:
            again = ms._state.score_row(qrows[-1])
        if not same_bits(again, (resp[-1].doc_ids, resp[-1].scores)):
            raise AssertionError(f"mesh {label}: the held call answers "
                                 "otherwise")
        if len(held) != held_want(per_row_of(ms._state)):
            raise AssertionError(f"mesh {label}: {len(held)} kernel calls "
                                 "held, the structure implies "
                                 f"{held_want(per_row_of(ms._state))}")
        summ = ms.mesh_summary()
        line = {**per_epoch, "start_s": start_s, "held_calls": len(held),
                "sync_probe": probe,
                "handoff_pause_us": summ["handoff_pause_us"],
                "replicas": len(ms.replicas), "digest": list(digests)[0],
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
        print(f"distributed mesh {label}: {json.dumps(line)}")
        out[f"mesh_{label}"] = line
        ms.stop()
        del ms
        torch.cuda.empty_cache()

    # (d) the doc-sharded stack over the live index, two replicas
    view = si.view()
    qrows = mesh_queries(view.df, view.hashes, view.live_docs, seed * 777)
    del view
    run_mesh("doc_stack", si, MeshConfig(
        batch_size=BATCH, n_terms_budget=8, k=K, n_shards=S, n_replicas=2,
        auto_handoff=False, trace_sample=1),
        new_batch(MESH_NEW_DOCS, seed + 3), qrows,
        lambda state: stack_row_launches(state.groups, S))

    # (e) the term topology on the 50,000-doc churn batch (cut from 1M:
    # it bulk-builds the live corpus again at every handoff)
    h50 = build.bulk_build(new_batch(TERM_MESH_DOCS, seed + 1))
    si50 = live_index.SegmentedIndex.from_host(h50, device=dev)
    qrows = mesh_queries(h50.df, h50.term_hashes, h50.num_docs, seed * 991)
    run_mesh("term_fused", si50, MeshConfig(
        batch_size=BATCH, n_terms_budget=8, k=K, n_shards=S,
        topology="term_fused", auto_handoff=False, trace_sample=1),
        new_batch(MESH_NEW_DOCS, seed + 4), qrows,
        lambda state: {"idf": S, "fused_score_blocked": S})
    out["mesh_term_fused"]["reduced"] = (
        f"{TERM_MESH_DOCS:,} docs, not 1M: the term topology bulk-builds "
        "the live corpus at every handoff")
    del si50, h50
    torch.cuda.empty_cache()
    report["distributed"] = out


# model serving phase (step 12): the transformer serving path
LM_BATCH = 8                  # requests of ATTN_SEQ tokens in one prefill
LM_DECODE = 64                # greedy decode steps after it
LM_SLOTS = ATTN_SEQ + LM_DECODE   # the decode cache's slots (pad_cache)
LM_HELD_LAYERS = (0, 27)      # the first and last layer's kernel calls
LM_CPU_SEQ, LM_CPU_DECODE = 128, 8   # (c): one request, on both sides
LM_TOL = 2e-2                 # bf16 rel-to-max (the reference's MLA bound)
SPLITK_WINDOWS = (0, 1024)
# (d): cache lengths across the four 1,040-slot shards, some at a
# shard's edge
SPLITK_LENS = (4159, 4000, 3121, 2080, 2079, 1040, 1039, 517)


def rel_to_max(got, want):
    """max |got - want| over max |want|, in f32."""
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-9))


@contextlib.contextmanager
def kernel_calls(ops, name, keep=(), timed=False, check=None):
    """Wrap ``ops.<name>`` (the entry point a model path calls for each
    kernel launch: ``attention`` for every GQA prefill layer,
    ``embedding_bag`` for xDeepFM's lookups, ``pna_multi_agg`` for every
    PNA layer) while the path runs the real kernel: the calls at the
    indexes in ``keep`` are recorded as (args, kw, output), with
    ``timed`` every call is bracketed by CUDA events, and ``check(i,
    args, kw, output)`` runs on each call as it returns (nothing of it is
    kept).  Yields ``{"held": {index: call}, "events": [(start, stop),
    ...], "n": calls}``."""
    import torch
    out = {"held": {}, "events": [], "n": 0}
    saved = getattr(ops, name)

    def call(*args, **kw):
        i = out["n"]
        out["n"] += 1
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        res = saved(*args, **kw)
        if timed:
            stop.record()
            out["events"].append((start, stop))
        if i in keep:
            out["held"][i] = (args, kw, res)
        if check is not None:
            check(i, args, kw, res)
        return res
    setattr(ops, name, call)
    try:
        yield out
    finally:
        setattr(ops, name, saved)


def lm_smoke_archs(seed, dev):
    """(a) of step 12: every LM arch at its smoke config on the card,
    the reference's serving protocol (``tests/test_models.py``) and its
    ring-cache check."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    out = {}
    for arch_id, arch in configs.ARCHS.items():
        if arch.kind != "lm":       # the recsys and GNN archs: step 13
            continue
        cfg = arch.make_config("smoke", "decode_32k")
        if cfg.moe is not None:     # capacity must not bind (see the test)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=16.0))
        params = tfm.init_params(seed, cfg, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        toks = torch.randint(0, cfg.vocab, (2, 16), generator=g, device=dev,
                             dtype=torch.int32)
        gqa = cfg.n_layers if cfg.attn == "gqa" else 0
        reset_launches()
        full = tfm.prefill(params, cfg, toks)
        only_launched(f"{arch_id} prefill(16)", read_launches(),
                      {"flash_attention": gqa})
        reset_launches()
        part = tfm.prefill(params, cfg, toks[:, :15])
        only_launched(f"{arch_id} prefill(15)", read_launches(),
                      {"flash_attention": gqa})
        cache = tfm.pad_cache(part.cache, 16, cfg)
        reset_launches()
        logits, _, _ = tfm.decode_step(params, cfg, cache, toks[:, 15:],
                                       part.cache_len)
        only_launched(f"{arch_id} decode", read_launches(),
                      {"flash_attention": 0})
        # the bf16 bound: a GQA prefill runs the kernel's arithmetic (the
        # Pallas kernel's: p and PV in f32), its decode the plain path's
        # (p rounded to bf16), so the reference's 1e-3 for two plain
        # paths (held on the CPU) does not apply here
        rel = rel_to_max(logits, full.logits)
        tol = LM_TOL
        out[arch_id] = {"rel_to_max": rel, "tolerance": tol,
                        "launches_per_prefill": gqa}
        print(f"model serve smoke {arch_id}: {json.dumps(out[arch_id])}")
        if not (rel < tol and bool(torch.isfinite(logits).all())):
            raise AssertionError(f"{arch_id}: prefill(15) + decode is "
                                 f"{rel} from prefill(16) (tolerance {tol})")

    # the ring cache decodes as the full cache once the window wraps
    cfg_full = tfm.TransformerConfig(
        name="swa", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab=128, window=8, global_every=0,
        chunk_q=8, loss_chunk=8, ring_cache=False)
    cfg_ring = dataclasses.replace(cfg_full, ring_cache=True)
    params = tfm.init_params(seed, cfg_full, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    steps = 24
    toks = torch.randint(0, 128, (2, steps), generator=g, device=dev,
                         dtype=torch.int32)
    runs = []
    for cfg in (cfg_full, cfg_ring):
        cache = tfm.init_cache(cfg, 2, steps, device=dev)
        cl = torch.zeros(2, dtype=torch.int32, device=dev)
        outs = []
        for i in range(steps):
            logits, cache, cl = tfm.decode_step(params, cfg, cache,
                                                toks[:, i:i + 1], cl)
            outs.append(logits)
        runs.append(torch.stack(outs))
    if cache[0].shape[3] != tfm.cache_slots(cfg_ring, steps) or \
            cache[0].shape[3] != 8:
        raise AssertionError(f"ring cache holds {cache[0].shape[3]} slots")
    torch.testing.assert_close(runs[1], runs[0], rtol=2e-3, atol=2e-3)
    out["ring_cache_max_abs_err"] = float((runs[1] - runs[0]).abs().max())
    return out


def lm_phase(seed, dev, report, card):
    """Step 12: the transformer serving path on the card, (a)-(d) of the
    module docstring.  Returns the full-width prefill's attention site
    (a row-9 site of the ``kernels`` line), its call for step 9's
    trace, and what step 9's model trace needs: the bf16 weights, the
    tokens and the decode cache."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.configs import base as cbase
    from repro_torch.distributed import decode_attn, shmap
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as tattn
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize
    line: dict = {"held_by_earlier_steps_bytes":
                  torch.cuda.memory_allocated(dev)}
    sync()
    torch.cuda.reset_peak_memory_stats(dev)

    # (a) the five archs at their smoke configs
    t0 = time.perf_counter()
    line["smoke"] = lm_smoke_archs(seed, dev)
    line["smoke_s"] = time.perf_counter() - t0

    # (b) Qwen3-0.6B at full width: f32 masters made on the card, served
    # as bf16 weights (the reference's serving cells read bf16)
    cfg = configs.get_arch("qwen3-0.6b").make_config("full")
    masters = tfm.init_params(seed, cfg, device=dev)
    n_active = cbase.lm_active_params(masters, cfg)
    params = tfm.tree_map(lambda t: t.to(torch.bfloat16), masters)
    del masters
    line.update(config=dataclasses.asdict(cfg) | {
        "dtype": "bfloat16", "residual_dtype": "float32"},
        n_active_params=n_active, weight_bytes=sum(
            t.nbytes for t in tfm.tree_leaves(params)))
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, ATTN_SEQ), generator=g,
                         device=dev, dtype=torch.int32)
    gqa = cfg.n_layers
    # warm-up: a short prefill and a decode step (library loads)
    w = tfm.prefill(params, cfg, toks[:1, :64])
    tfm.decode_step(params, cfg, tfm.pad_cache(w.cache, 65, cfg),
                    toks[:1, :1], w.cache_len)
    sync()
    del w

    # the main path: every counter from zero just before, read just after
    with kernel_calls(ops, "attention", keep=LM_HELD_LAYERS) as rec:
        reset_launches()
        sync()
        t0 = time.perf_counter()
        pre = tfm.prefill(params, cfg, toks)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        only_launched("qwen3 prefill", read_launches(),
                      {"flash_attention": gqa})
    logits = pre.logits
    if logits.shape != (LM_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"qwen3 prefill: bad logits {logits.shape}")
    cache = tfm.pad_cache(pre.cache, LM_SLOTS, cfg)
    cache_len = pre.cache_len
    del pre
    kv_bytes = sum(c.nbytes for c in cache)

    # the recorded kernel calls of layers 0 and 27, held to the plain
    # version within the reference's bf16 tolerance, and, as step 8's
    # bf16 sites are, to the plain version run in f32 on the same inputs
    # and rounded to bf16 within one bf16 rounding (at this length an
    # output is about as large as 3e-2)
    held, held_f32 = [], []
    for i in LM_HELD_LAYERS:
        args, kw, got = rec["held"][i]
        want = tfa.flash_attention_plain(*args, **kw)
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)
        held.append(float((got.float() - want.float()).abs().max()))
        del want
        f32 = tfa.flash_attention_plain(*(x.float() for x in args), **kw)
        f32 = f32.to(torch.bfloat16).float()
        torch.testing.assert_close(got.float(), f32, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
        held_f32.append(float((got.float() - f32).abs().max()))
        del f32
    layer0 = rec["held"][LM_HELD_LAYERS[0]]
    del rec

    # prefill(4,095) + one decode step against prefill(4,096)
    part = tfm.prefill(params, cfg, toks[:, :-1])
    pcache, plen = tfm.pad_cache(part.cache, ATTN_SEQ, cfg), part.cache_len
    del part
    reset_launches()
    plogits, _, _ = tfm.decode_step(params, cfg, pcache, toks[:, -1:], plen)
    only_launched("qwen3 decode after prefill(4095)", read_launches(),
                  {"flash_attention": 0})
    del pcache
    consistency = rel_to_max(plogits, logits)

    # greedy decode: LM_DECODE steps from the prefill's cache
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        step_logits, cache, cache_len = tfm.decode_step(params, cfg, cache,
                                                        tok, cache_len)
        tok = step_logits.argmax(-1, keepdim=True).to(torch.int32)
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / LM_DECODE
    only_launched("qwen3 decode steps", read_launches(),
                  {"flash_attention": 0})
    if not bool(torch.isfinite(step_logits).all()) or \
            cache_len.tolist() != [LM_SLOTS] * LM_BATCH:
        raise AssertionError(f"qwen3 decode: lengths {cache_len.tolist()}")

    # the attention kernel's ms inside one more prefill, by events around
    # each call the path makes (the wrapper's copies of q/k/v included)
    with kernel_calls(ops, "attention", timed=True) as rec:
        sync()
        t0 = time.perf_counter()
        tfm.prefill(params, cfg, toks)
        sync()
        prefill2_ms = (time.perf_counter() - t0) * 1e3
    attn_ms = sum(a.elapsed_time(b) for a, b in rec["events"])
    if len(rec["events"]) != gqa:
        raise AssertionError(f"{len(rec['events'])} attention calls")
    del rec

    # (c) the same weights on the CPU: one request of LM_CPU_SEQ tokens
    # and LM_CPU_DECODE decode steps, the card's greedy tokens fed to both
    t0 = time.perf_counter()
    cpu_params = tfm.tree_map(lambda t: t.cpu(), params)
    sides = []
    for p, d in ((params, dev), (cpu_params, torch.device("cpu"))):
        one = tfm.prefill(p, cfg, toks[:1, :LM_CPU_SEQ].to(d))
        c = tfm.pad_cache(one.cache, LM_CPU_SEQ + LM_CPU_DECODE, cfg)
        n, outs = one.cache_len, [one.logits]
        for i in range(LM_CPU_DECODE):
            t = (sides[0][i].argmax(-1, keepdim=True).to(torch.int32)
                 if sides else outs[-1].argmax(-1, keepdim=True).to(
                     torch.int32)).to(d)
            lg, c, n = tfm.decode_step(p, cfg, c, t, n)
            outs.append(lg)
        sides.append(outs)
    cpu_rel = [rel_to_max(c, g) for g, c in zip(*sides)]
    cpu_s = time.perf_counter() - t0
    del cpu_params, sides
    if max(cpu_rel) >= LM_TOL:
        raise AssertionError(f"card vs CPU logits {cpu_rel}")

    # (d) split-K decode over a 4-shard mesh: layer 0's decode cache as
    # f32 copies, against the single-device decode attention
    kc, vc = (c[0].float() for c in cache)
    q = torch.randn(LM_BATCH, cfg.n_heads, 1, cfg.head_dim, generator=g,
                    device=dev)
    lens = torch.tensor(SPLITK_LENS, dtype=torch.int32, device=dev)
    splitk = decode_attn.splitk_decode_attention(
        shmap.make_mesh(DIST_SHARDS, device=dev), "shards")
    splitk_err = {}
    for w in SPLITK_WINDOWS:
        got = splitk(q, kc, vc, lens, window=w)
        want = tattn.decode_attention(q, kc, vc, lens, window=w)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)
        splitk_err[w] = float((got - want).abs().max())
    del kc, vc

    # the row-9 site: layer 0's call timed in turns with the plain
    # version, beside its bound and SDPA on the same inputs
    args, kw, _ = layer0
    nbytes, nops, extra = model_work("flash_attention", args, kw)
    ms, turns, plain_ms, clocks = time_in_turns(
        lambda *c: ops.attention(*c, **kw),
        lambda *c: tfa.flash_attention_plain(*c, **kw), [args])
    lib_ms = event_ms(lambda *c: F.scaled_dot_product_attention(
        *c, is_causal=True, enable_gqa=True), [args], REPS)
    site = {"site": "serve@qwen3_0.6b_prefill", "kernel": "flash_attention",
            "launches": gqa, "shapes": [list(x.shape) for x in args],
            "dtype": str(args[0].dtype), **kw, "max_abs_err": max(held),
            "held_layers": list(LM_HELD_LAYERS), "max_abs_err_held": held,
            "tolerance": 3e-2, "max_abs_err_held_f32_plain": held_f32,
            "tolerance_f32_plain": [BF16_RTOL, BF16_ATOL],
            "bytes": nbytes, "ops": nops, **extra,
            "kernel_ms": ms, "kernel_ms_turns": turns, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library": "F.scaled_dot_product_attention(is_causal)",
            "t_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "t_ops_ms": nops / BF16_OPS_PER_S * 1e3,
            "clocks_sm_mem_power_temp": clocks}
    site["bound_ms"] = max(site["t_bytes_ms"], site["t_ops_ms"])
    print(f"model kernel site: {json.dumps(site)}")

    tokens = LM_BATCH * ATTN_SEQ
    # the reference's cells count 2 x active params x tokens, the tied
    # embedding table included; the prefill only gathers its rows and
    # unembeds the last position of each request, so the rate and the
    # peak share count the matmuls the prefill runs: the layers' weights
    # for every token, the logits of B rows, and attention
    cell_flops = 2.0 * n_active * tokens
    layer_weights = sum(t.numel() for t in tfm.tree_leaves(
        {"attn": params["attn"], "mlp": params["mlp"]}) if t.dim() == 3)
    matmul_flops = 2.0 * layer_weights * tokens \
        + 2.0 * cfg.d_model * cfg.vocab * LM_BATCH
    attn_flops = gqa * nops                    # QK^T and PV, live pairs
    line.update(
        requests=LM_BATCH, prompt_tokens=ATTN_SEQ, decode_steps=LM_DECODE,
        cache_slots=LM_SLOTS, prefill_ms=prefill_ms,
        prefill_ms_second=prefill2_ms, decode_ms_per_step=decode_ms,
        decode_tokens_per_s=LM_BATCH * 1e3 / decode_ms,
        attention_ms_in_prefill=attn_ms,
        attention_share_of_prefill=attn_ms / prefill2_ms,
        attention_launches_per_prefill=gqa, decode_launches=0,
        cell_flops_prefill=cell_flops, layer_matmul_weights=layer_weights,
        matmul_flops_prefill=matmul_flops,
        attention_flops_prefill=attn_flops,
        prefill_tflops=(matmul_flops + attn_flops) / prefill_ms / 1e9,
        prefill_peak_share=(matmul_flops + attn_flops) / prefill_ms / 1e9
        / (BF16_OPS_PER_S / 1e12),
        kv_cache_bytes=kv_bytes,
        prefill_4095_plus_decode_rel_to_max=consistency,
        card_vs_cpu_rel_to_max=cpu_rel, cpu_check_s=cpu_s,
        splitk_max_abs_err=splitk_err,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        card=card)
    print(f"model serve qwen3-0.6b: {json.dumps(line)}")
    if consistency >= LM_TOL:
        raise AssertionError(f"prefill(4095) + decode is {consistency} "
                             f"from prefill(4096) (tolerance {LM_TOL})")
    report["lm_serve"] = {**line, "kernel_site": site}
    trace = (site["site"], ("flash_attention",
                            functools.partial(ops.attention, **kw),
                            [args] * (1 + MODEL_TRACED), 1))
    keep = {"cfg": cfg, "params": params, "toks": toks, "cache": cache,
            "cache_len": cache_len - 1, "tok": tok}
    return site, trace, keep


def lm_trace(keep):
    """Step 9's model trace: one full-width prefill and one decode step,
    each in a ``torch.profiler`` trace of its own.  The device-busy
    share of a call is the summed kernel time over the span from its
    first kernel's start to its last kernel's end (an eager decode step
    waits on the host between launches); the attention kernel's share is
    its summed time over the prefill's summed kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tfm
    cfg, params = keep["cfg"], keep["params"]
    calls = {"prefill": lambda: tfm.prefill(params, cfg, keep["toks"]),
             "decode_step": lambda: tfm.decode_step(
                 params, cfg, keep["cache"], keep["tok"],
                 keep["cache_len"])}
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.events() if e.device_type == cuda]
        if not ev:
            out[name] = {"kernels": 0, "wall_ms": wall_ms}
            continue
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        span = (max(e.time_range.end for e in ev)
                - min(e.time_range.start for e in ev)) / 1e3
        attn = sum(e.time_range.elapsed_us() for e in ev
                   if SYMBOLS["flash_attention"] in e.name) / 1e3
        out[name] = {"kernels": len(ev), "device_busy_ms": busy,
                     "span_ms": span, "wall_ms": wall_ms,
                     "device_busy_share_of_span": busy / span,
                     "device_busy_share_of_wall": busy / wall_ms,
                     "attention_device_ms": attn,
                     "attention_share_of_device": attn / busy}
    print(f"model serve trace qwen3-0.6b: {json.dumps(out)}")
    return out


# recsys and GNN serving phase (step 13): the recsys models and PNA
REC_ARCHS = ("sasrec", "bert4rec", "dien", "xdeepfm")
REC_SMOKE = (("sasrec", 1), ("bert4rec", 1), ("dien", 1), ("xdeepfm", 1),
             ("xdeepfm", 3))         # (arch, n_hot): xDeepFM multi-hot too
REC_TOL = 1e-4                # f32 rel-to-max, card vs CPU
REC_NEAR_TIE = 1e-5           # adjacent top-k scores that may swap
PNA_SMOKE = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# ogbn-products as configs/pna.py sizes it: nodes, edges, features, classes
OGB_GRAPH = (2_449_029, 61_859_140, 100, 47)
# minibatch_lg's full graph (Reddit): nodes, edges, features, classes.  Its
# edges are cut to REDDIT_EDGES: making all 114,615,892 (a stable argsort
# over them) takes ~40 s of host time, past the step's budget; the sampled
# block keeps its shape (169,984 nodes, 168,960 edges)
REDDIT_GRAPH = (232_965, 114_615_892, 602, 41)
REDDIT_EDGES = REDDIT_GRAPH[1] // 4


def full_graphs(seed):
    """The two full-width PNA graphs, made on the host (beside the recsys
    part of the step): ogbn-products through ``fullgraph_batch``, padded
    to the config's node and edge counts with trash edges at node N; a
    ``NeighborSampler`` block (1,024 seeds, fanout 15, 10) over the
    Reddit-sized graph with REDDIT_EDGES edges.  Each as (batch, seconds,
    cuts)."""
    import numpy as np

    from repro_torch.configs import pna
    from repro_torch.train import data
    out = {}
    t0 = time.perf_counter()
    g = data.make_synthetic_graph(*OGB_GRAPH, seed=seed)
    b = data.fullgraph_batch(g, seed=seed)
    del g
    shp = pna.SHAPES["ogb_products"]
    n, e = shp["n_nodes"], shp["n_edges"]
    feats = np.zeros((n, OGB_GRAPH[2]), np.float32)
    feats[:OGB_GRAPH[0]] = b["feats"]
    src = np.full(e, n, np.int32)
    dst = np.full(e, n, np.int32)
    src[:OGB_GRAPH[1]] = b["src"]
    dst[:OGB_GRAPH[1]] = b["dst"]
    out["ogb_products"] = ({"feats": feats, "src": src, "dst": dst},
                           time.perf_counter() - t0, {})
    del b
    t0 = time.perf_counter()
    fg = pna.SHAPES["minibatch_lg"]["full_graph"]
    g = data.make_synthetic_graph(REDDIT_GRAPH[0], REDDIT_EDGES,
                                  REDDIT_GRAPH[2], REDDIT_GRAPH[3],
                                  seed=seed + 1)
    block = data.NeighborSampler(g, fg["batch_nodes"], fg["fanout"]).sample(
        seed)
    out["minibatch_lg"] = (block, time.perf_counter() - t0, {
        "full_graph_edges": [REDDIT_GRAPH[1], REDDIT_EDGES]})
    return out


def rec_call(arch_id, cfg, shp, shape_id, rng):
    """(fn, inputs, extra args) of a recsys cell body at ``shp``: the
    serve step over ``rec_serve_inputs``' layout, or the retrieval step
    against ``padded_rows(n_candidates)`` candidate rows.  Inputs are
    made with numpy from ``rng`` (CPU tensors): histories of real items,
    a quarter of them with three padding slots in front, BERT4Rec's last
    slot [MASK]."""
    import numpy as np
    import torch

    from repro_torch.configs import base as cbase
    from repro_torch.models import recsys
    if shape_id.startswith("serve"):
        layout = cbase.rec_serve_inputs(arch_id, cfg, shp)
        fn = cbase.recsys_serve_fn(arch_id, cfg, shp)
        extra = ()
    else:
        layout = cbase._rec_serve_inputs(arch_id, cfg, shp["batch"])
        fn = cbase.recsys_retrieval_fn(arch_id, cfg, shp)
        extra = (torch_of(rng.normal(size=(
            recsys.padded_rows(shp["n_candidates"]), cfg.embed_dim)).astype(
                np.float32)),)
    inp = {}
    for k, (shape, _) in layout.items():
        if arch_id == "xdeepfm":
            a = rng.integers(0, cfg.field_vocab, shape)
        else:
            a = rng.integers(1, cfg.n_items, shape)
            if k == "hist":
                a[..., :3] *= rng.random(shape[:-1] + (1,)) >= 0.25
                if arch_id == "bert4rec":
                    a[..., -1] = cfg.n_items
        inp[k] = torch.from_numpy(a.astype(np.int32))
    return fn, inp, extra


def torch_of(a):
    import numpy as np
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def to_card(tree, dev):
    from repro_torch.models import transformer as tfm
    return tfm.tree_map(lambda t: t.to(dev), tree)


def held_to_cpu(label, got, want):
    """The card's output against the CPU's on the same weights and
    inputs: logits within rel-to-max REC_TOL; top-k (values, ids): ids
    equal but at adjacent CPU scores within REC_NEAR_TIE relative
    (printed), scores within rtol 1e-5."""
    import numpy as np
    if not isinstance(want, tuple):
        rel = rel_to_max(got, want)
        if not (rel < REC_TOL and bool(got.isfinite().all())):
            raise AssertionError(f"{label}: card vs CPU {rel} (tolerance "
                                 f"{REC_TOL})")
        return {"rel_to_max": rel}
    gv, gi = (x.cpu().reshape(-1, x.shape[-1]).numpy() for x in got)
    wv, wi = (x.reshape(-1, x.shape[-1]).numpy() for x in want)
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=0)
    swaps = []
    for q, j in zip(*np.nonzero(gi != wi)):
        s = wv[q]
        if not any(abs(s[j] - s[i]) <= REC_NEAR_TIE * abs(s[j])
                   for i in (j - 1, j + 1) if 0 <= i < len(s)):
            raise AssertionError(f"{label}: user {q} rank {j}: card id "
                                 f"{gi[q, j]} != CPU id {wi[q, j]}, no "
                                 "near tie")
        swaps.append([int(q), int(j), int(gi[q, j]), int(wi[q, j])])
    if swaps:
        print(f"{label}: near-tie swaps (user, rank, card id, CPU id): "
              f"{swaps}")
    return {"near_tie_swaps": len(swaps),
            "max_abs_err_scores": float(np.abs(gv - wv).max())}


def only_launched(label, launches, want):
    """Each kernel of ``want`` launched that often, and no other."""
    got = {k: v for k, v in launches.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return got


def pna_smoke_batch(shape_id, cfg, shp, seed):
    """A PNA smoke shape's batch from the port's generators (the
    sampler's block at minibatch_lg), as CPU tensors."""
    from repro_torch.train import data
    if shp.get("graph_level"):
        b = data.molecule_batch(seed, 0, shp["n_graphs"],
                                shp["n_nodes"] // shp["n_graphs"],
                                shp["n_edges"] // shp["n_graphs"],
                                cfg.d_feat, cfg.n_classes)
    elif "full_graph" in shp:
        fg = shp["full_graph"]
        g = data.make_synthetic_graph(fg["n_nodes"], fg["n_edges"],
                                      cfg.d_feat, cfg.n_classes, seed)
        b = data.NeighborSampler(g, fg["batch_nodes"], fg["fanout"]).sample(
            seed)
    else:
        g = data.make_synthetic_graph(shp["n_nodes"], shp["n_edges"],
                                      cfg.d_feat, cfg.n_classes, seed)
        b = data.fullgraph_batch(g, seed=seed)
    return {k: torch_of(v) for k, v in b.items()}


def rec_gnn_smoke(seed, dev):
    """(a) of step 13: the five new archs at their smoke configs, the
    same weights and inputs on the card and on the CPU."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.configs import base as cbase
    from repro_torch.models import gnn
    out = {}
    rng = np.random.default_rng(seed)
    for arch_id, n_hot in REC_SMOKE:
        arch = configs.get_arch(arch_id)
        cfg = arch.make_config("smoke")
        if arch_id == "xdeepfm":
            cfg = dataclasses.replace(cfg, n_hot=n_hot)
        cpu = cbase._REC_INIT[arch_id](seed, cfg, device="cpu")
        card = to_card(cpu, dev)
        for shape_id in ("serve_p99", "retrieval_cand"):
            fn, inp, extra = rec_call(arch_id, cfg,
                                      arch.smoke_shapes[shape_id], shape_id,
                                      rng)
            reset_launches()
            got = fn(card, to_card(inp, dev), *to_card(extra, dev))
            label = f"{arch_id} n_hot={n_hot} {shape_id}"
            only_launched(label, read_launches(),
                          {"embedding_bag": int(arch_id == "xdeepfm")})
            out[label] = held_to_cpu(label, got, fn(cpu, inp, *extra))
    pna = configs.get_arch("pna")
    for shape_id in PNA_SMOKE:
        shp = pna.smoke_shapes[shape_id]
        cfg = pna.make_config("smoke", shape_id)
        b = pna_smoke_batch(shape_id, cfg, shp, seed)
        cpu = gnn.init_params(seed, cfg, device="cpu")
        card, cb = to_card(cpu, dev), to_card(b, dev)
        n = b["feats"].shape[0]
        reset_launches()
        if shp.get("graph_level"):
            got = gnn.graph_loss(card, cfg, cb)
            want = gnn.graph_loss(cpu, cfg, b)
        else:
            got = gnn.node_logits(card, cfg, cb["feats"], cb["src"],
                                  cb["dst"], n)
            want = gnn.node_logits(cpu, cfg, b["feats"], b["src"],
                                   b["dst"], n)
        label = f"pna {shape_id}"
        only_launched(label, read_launches(),
                      {"pna_multi_agg": cfg.n_layers})
        out[label] = held_to_cpu(label, got, want)
    print(f"model serve smoke recsys/gnn: {json.dumps(out)}")
    return out


def gather_site(site, kern, args, launches, err, extra_info):
    """A ``model kernel site:`` row for a bag or PNA call of a model path:
    timed in turns with its plain version (CUDA events, wrapper
    included), beside its bound, its gather floor and the library call
    where there is one (``F.embedding_bag``; none for PNA)."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as tbag
    from repro_torch.kernels import segment_multi_agg as tpna
    wrapper, plain = {
        "embedding_bag": (tbag.embedding_bag, tbag.embedding_bag_plain),
        "pna_multi_agg": (tpna.pna_multi_agg, tpna.pna_multi_agg_plain)
    }[kern]
    nbytes, nops, extra = model_work(kern, args, {})
    ms, turns, plain_ms, clocks = time_in_turns(wrapper, plain, [args])
    lib_ms, lib_note = None, ("none: PNA's four aggregations take four "
                              "scatter_reduce calls, not one")
    if kern == "embedding_bag":
        table, idx = args
        lib_args = (idx.clamp_min(0), (idx >= 0).to(table.dtype))
        lib_ms = event_ms(lambda i, w: F.embedding_bag(
            i, table, mode="sum", per_sample_weights=w), [lib_args], REPS)
        lib_note = "F.embedding_bag(mode='sum', per_sample_weights)"
    info = {"site": site, "kernel": kern, "launches": launches,
            "shapes": [list(x.shape) for x in args],
            "dtype": str(args[0].dtype), "max_abs_err": err, **extra_info,
            **extra, "bytes": nbytes, "ops": nops, "kernel_ms": ms,
            "kernel_ms_turns": turns, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": lib_note,
            "t_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "t_ops_ms": nops / F32_OPS_PER_S * 1e3,
            "clocks_sm_mem_power_temp": clocks}
    info["bound_ms"] = max(info["t_bytes_ms"], info["t_ops_ms"])
    info["gather_floor_ms"] = (info["gather_floor_bytes"]
                               / HBM_BYTES_PER_S * 1e3)
    return info


def equal_bits(a, b):
    """Two tensors of one shape and dtype with the same bits."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.float().view(torch.int32), b.float().view(torch.int32))


def recsys_full(seed, dev, card, step):
    """(b) of step 13: the four recsys archs at full width on the card.
    Returns the bag sites and what step 9's trace needs."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import base as cbase
    from repro_torch.kernels import embedding_bag as tbag
    from repro_torch.kernels import ops
    sync = torch.cuda.synchronize
    rng = np.random.default_rng(seed + 3)
    sites, keep = [], {}
    for arch_id in REC_ARCHS:
        arch = configs.get_arch(arch_id)
        cfg = arch.make_config("full")
        t0 = time.perf_counter()
        cpu = cbase._REC_INIT[arch_id](seed, cfg, device="cpu")
        params = to_card(cpu, dev)
        sync()
        init_s = time.perf_counter() - t0
        runs = [("serve_p99", True)]
        if arch_id == "xdeepfm":
            runs.append(("serve_bulk", False))
            keep["xdeepfm"] = {"cfg": cfg, "params": cpu}
        if arch_id == "sasrec":
            runs.append(("retrieval_cand", True))
        for shape_id, on_cpu in runs:
            shp = arch.shapes[shape_id]
            fn, inp, extra = rec_call(arch_id, cfg, shp, shape_id, rng)
            dinp, dextra = to_card(inp, dev), to_card(extra, dev)
            chunks = cbase.serve_chunks(shp)[0] \
                if shape_id.startswith("serve") else 1
            bag = chunks if arch_id == "xdeepfm" else 0
            fn(params, dinp, *dextra)              # warm-up
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            with kernel_calls(ops, "embedding_bag", keep={0, bag - 1},
                              timed=True) as rec:
                reset_launches()
                sync()
                t0 = time.perf_counter()
                got = fn(params, dinp, *dextra)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                label = f"{arch_id} {shape_id}"
                launched = only_launched(label, read_launches(),
                                         {"embedding_bag": bag})
            users = shp["batch"]
            line = {"users": users, "chunks": chunks, "ms_per_batch": ms,
                    "users_per_s": users / ms * 1e3, "init_s": init_s,
                    "launches": launched,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(
                        dev)}
            if bag:
                bag_ms = sum(x.elapsed_time(y) for x, y in rec["events"])
                line.update(bag_kernel_ms=bag_ms, bag_share=bag_ms / ms)
                # the first and last chunk's calls, as the path made them
                errs = []
                for i, (args, kw, res) in sorted(rec["held"].items()):
                    want = tbag.embedding_bag_plain(*args, **kw)
                    if not equal_bits(res, want):
                        raise AssertionError(f"{label}: bag call {i} != "
                                             "its plain version")
                    errs.append(float((res - want).abs().max()))
                line["bag_calls_held"] = sorted(rec["held"])
                site = gather_site(
                    f"serve@xdeepfm_{shape_id}", "embedding_bag",
                    rec["held"][0][0], bag, max(errs),
                    {"chunk_users": users // chunks})
                print(f"model kernel site: {json.dumps(site)}")
                sites.append(site)
                keep["xdeepfm"][shape_id] = {k: v[0] for k, v in inp.items()}
            del rec
            if on_cpu:
                t0 = time.perf_counter()
                line["card_vs_cpu"] = held_to_cpu(label, got,
                                                  fn(cpu, inp, *extra))
                line["cpu_check_s"] = time.perf_counter() - t0
            if isinstance(got, tuple):
                if not bool(got[0].isfinite().all()) or \
                        bool(got[1].min() < 0):
                    raise AssertionError(f"{label}: bad top-k")
            elif got.shape != (chunks, users // chunks)[2 - got.dim():] or \
                    not bool(got.isfinite().all()):
                raise AssertionError(f"{label}: bad logits {got.shape}")
            line["card"] = card
            print(f"model serve recsys {arch_id} {shape_id}: "
                  f"{json.dumps(line)}")
            step[label] = line
            del got, dinp, dextra
        del params, cpu
        torch.cuda.empty_cache()
    return sites, keep


def pna_full(seed, dev, card, step, graphs):
    """(c) of step 13: PNA at full width (d 75, 4 layers) on the card.
    Returns the PNA sites and what step 9's trace needs."""
    import torch

    from repro_torch import configs
    from repro_torch.core import segments
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_multi_agg as tpna
    from repro_torch.models import gnn
    sync = torch.cuda.synchronize
    sites, keep = [], {}
    for shape_id in ("minibatch_lg", "ogb_products"):
        batch, gen_s, reduced = graphs.pop(shape_id)
        cfg = configs.get_arch("pna").make_config("full", shape_id)
        cpu = gnn.init_params(seed, cfg, device="cpu")
        params = to_card(cpu, dev)
        host = {k: torch_of(batch[k]) for k in ("feats", "src", "dst")}
        del batch
        b = to_card(host, dev)
        n = b["feats"].shape[0]
        label = f"pna {shape_id}"
        held = {"max_abs_err": 0.0}

        def check(i, args, kw, res):
            """Each layer's call against the plain version, to the bit,
            as it returns (a layer's messages are 18.6 GB at
            ogbn-products, so none is kept); layer 0's call is the site,
            and at ogbn-products it is also held to the port's segment
            reductions over the same edge list."""
            want = tpna.pna_multi_agg_plain(*args, **kw)
            if not equal_bits(res, want):
                raise AssertionError(f"{label}: layer {i} != its plain "
                                     "version")
            held["max_abs_err"] = max(held["max_abs_err"], float(
                (res - want).abs().max()))
            del want
            if i:
                return
            m, nbr = args
            if shape_id == "ogb_products":
                # messages come in dst order: the first 1/16 of the nodes
                # own a prefix of them
                n16 = nbr.shape[0] // 16
                seg = torch.repeat_interleave(
                    torch.arange(n16, device=dev), (nbr[:n16] >= 0).sum(1))
                mm = m[:seg.shape[0]]
                mn = segments.segment_min(mm, seg, n16)
                mx = segments.segment_max(mm, seg, n16)
                agg = torch.cat([
                    segments.segment_mean(mm, seg, n16),
                    torch.where(torch.isfinite(mn), mn, 0.0),
                    torch.where(torch.isfinite(mx), mx, 0.0),
                    segments.segment_std(mm, seg, n16, eps=kw["eps"])], 1)
                torch.testing.assert_close(res[:n16], agg, rtol=1e-5,
                                           atol=1e-5)
                held.update(segments_nodes_checked=n16,
                            segments_edges_checked=int(seg.shape[0]),
                            max_abs_err_segments=float(
                                (res[:n16] - agg).abs().max()))
                del agg, mn, mx, seg, mm
            sites.append(gather_site(
                f"serve@pna_{shape_id}", "pna_multi_agg", (m, nbr),
                cfg.n_layers, 0.0, {"layer": 0, "eps": kw["eps"]}))

        with kernel_calls(ops, "pna_multi_agg", check=check):
            logits = gnn.node_logits(params, cfg, b["feats"], b["src"],
                                     b["dst"], n)
            sync()
        sites[-1]["max_abs_err"] = held.pop("max_abs_err")
        print(f"model kernel site: {json.dumps(sites[-1])}")
        if logits.shape != (n, cfg.n_classes) or \
                not bool(logits.isfinite().all()):
            raise AssertionError(f"{label}: bad logits {logits.shape}")

        # the neighbour lists alone, then the counted, timed forward
        sync()
        t0 = time.perf_counter()
        edges = gnn.build_edges(b["src"], b["dst"], n)
        sync()
        nbr_ms = (time.perf_counter() - t0) * 1e3
        k, kept = edges.nbr.shape[1], edges.src.shape[0]
        del edges
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with kernel_calls(ops, "pna_multi_agg", timed=True) as rec:
            reset_launches()
            sync()
            t0 = time.perf_counter()
            again = gnn.node_logits(params, cfg, b["feats"], b["src"],
                                    b["dst"], n)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            launched = only_launched(label, read_launches(),
                                     {"pna_multi_agg": cfg.n_layers})
        layer_ms = [x.elapsed_time(y) for x, y in rec["events"]]
        del rec
        line = {"nodes": n, "edges": int(b["src"].shape[0]),
                "edges_kept": kept, "K": k, "d_hidden": cfg.d_hidden,
                "layers": cfg.n_layers, "forward_ms": ms,
                "nbr_build_ms": nbr_ms, "pna_kernel_ms_per_layer": layer_ms,
                "pna_share": sum(layer_ms) / ms, "launches": launched,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "rerun_rel_to_max": rel_to_max(again, logits),
                "graph_gen_s": gen_s, "reduced": reduced, **held}
        del again
        if shape_id == "minibatch_lg":
            t0 = time.perf_counter()
            line["card_vs_cpu"] = held_to_cpu(label, logits, gnn.node_logits(
                cpu, cfg, host["feats"], host["src"], host["dst"], n))
            line["cpu_check_s"] = time.perf_counter() - t0
        line["card"] = card
        print(f"model serve gnn pna {shape_id}: {json.dumps(line)}")
        step[label] = line
        keep[shape_id] = {"cfg": cfg, "params": cpu, "batch": host}
        del params, b, logits
        torch.cuda.empty_cache()
    return sites, keep


def rec_gnn_phase(seed, dev, report, card):
    """Step 13: the recsys and GNN serving paths on the card, (a)-(c) of
    the module docstring.  Returns the model-path sites of the bag and
    PNA kernels and what step 9's trace of the paths needs."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t_step = time.perf_counter()
    torch.cuda.synchronize()
    step = {"held_by_earlier_steps_bytes": torch.cuda.memory_allocated(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    with ThreadPoolExecutor(1) as pool:
        graphs = pool.submit(full_graphs, seed)     # host numpy, meanwhile
        step["smoke"] = rec_gnn_smoke(seed, dev)
        rec_sites, keep = recsys_full(seed, dev, card, step)
        t0 = time.perf_counter()
        graphs = graphs.result()
        step["graph_wait_s"] = time.perf_counter() - t0
    pna_sites, keep["pna"] = pna_full(seed, dev, card, step, graphs)
    step["step_s"] = time.perf_counter() - t_step
    step["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print(f"model serve rec/gnn step: {step['step_s']:.1f} s, peak "
          f"{step['max_memory_allocated']} B, held before "
          f"{step['held_by_earlier_steps_bytes']} B")
    report["rec_gnn_serve"] = step
    return rec_sites + pna_sites, keep


def rec_gnn_trace(keep, sites, dev):
    """Step 9's trace of step 13's paths, each call in a
    ``torch.profiler`` trace of its own after one warm-up: xDeepFM's
    serve_p99 batch and one serve_bulk chunk (2,048 users), and one PNA
    forward per full-width graph.  Each call's device-busy share of its
    kernels' span and of its host time, and its bag or PNA kernel's
    device ms per launch, which goes into that path's site."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import gnn, recsys
    x = keep["xdeepfm"]

    def xdeepfm(shape_id):
        params, sparse = to_card(x["params"], dev), x[shape_id][
            "sparse"].to(dev)
        return lambda: recsys.xdeepfm_logit(params, x["cfg"], sparse)

    def pna(shape_id):
        g = keep["pna"][shape_id]
        params, b = to_card(g["params"], dev), to_card(g["batch"], dev)
        n = b["feats"].shape[0]
        return lambda: gnn.node_logits(params, g["cfg"], b["feats"],
                                       b["src"], b["dst"], n)

    calls = {"xdeepfm_serve_p99": ("embedding_bag", xdeepfm, "serve_p99"),
             "xdeepfm_serve_bulk_chunk": ("embedding_bag", xdeepfm,
                                          "serve_bulk"),
             "pna_minibatch_lg": ("pna_multi_agg", pna, "minibatch_lg"),
             "pna_ogb_products": ("pna_multi_agg", pna, "ogb_products")}
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name, (kern, make, shape_id) in calls.items():
        fn = make(shape_id)
        fn()                                          # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        del fn
        torch.cuda.empty_cache()
        ev = [e for e in prof.events() if e.device_type == cuda]
        mine = [e.time_range.elapsed_us() / 1e3 for e in ev
                if SYMBOLS[kern] in e.name]
        if not mine:
            out[name] = {"kernels": len(ev), "wall_ms": wall_ms}
            continue
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        span = (max(e.time_range.end for e in ev)
                - min(e.time_range.start for e in ev)) / 1e3
        out[name] = {"kernels": len(ev), "device_busy_ms": busy,
                     "span_ms": span, "wall_ms": wall_ms,
                     "device_busy_share_of_span": busy / span,
                     "device_busy_share_of_wall": busy / wall_ms,
                     f"{kern}_device_ms": mine,
                     f"{kern}_share_of_device": sum(mine) / busy}
        site = next(s for s in sites if s["site"] == {
            "embedding_bag": f"serve@xdeepfm_{shape_id}",
            "pna_multi_agg": f"serve@pna_{shape_id}"}[kern])
        site["device_ms"] = sum(mine) / len(mine)
        site["host_share"] = 1 - site["device_ms"] / site["kernel_ms"]
    print(f"model serve trace recsys/gnn: {json.dumps(out)}")
    return out


def kernel_rows(sites):
    """One row per kernel for the ``kernels`` line: ``launches`` sums
    the counted runs of every path, and ``ms``, ``plain_ms`` and
    ``bound_ms`` are means per launch (each call site weighted by its
    launches); the per-site numbers are printed above."""
    import numpy as np
    rows = []
    replaced = {n: r for n, (_, r) in {**KERNELS, **DENSE_KERNELS}.items()}
    replaced.update({n: r for n, (_, r, _) in BITONIC_KERNELS.items()})
    source = {n: n for n in (*FUSED_KERNELS, *PAPER_KERNELS, *MODEL_KERNELS)}
    source.update({n: "query_weights" for n in WEIGHT_KERNELS})
    source.update({n: base for n, (_, _, base) in BITONIC_KERNELS.items()})
    for name, replaces in {**replaced, **PAPER_KERNELS, **MODEL_KERNELS,
                           **WEIGHT_KERNELS}.items():
        mine = [x for x in sites if x["kernel"] == name]
        if not mine:
            raise AssertionError(f"{name}: no call site on any path")
        w = [x["launches"] for x in mine]

        def mean(key):
            return float(np.average([x[key] for x in mine], weights=w))
        t_bytes, t_ops = mean("t_bytes_ms"), mean("t_ops_ms")
        lib = [x.get("library_ms") for x in mine]
        dev = [x.get("device_ms") for x in mine]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source[name]}.cu",
            "replaces": replaces, "launches": int(sum(w)),
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (mean("library_ms")
                           if None not in lib else None),
            "device_ms": mean("device_ms") if None not in dev else None})
    return rows


# training phase (step 14): gradients, the optimizer, the loop, the launcher
TRAIN_BATCHES = (16, 8, 4, 2, 1)   # Qwen3 train_4k batches tried, in turn
TRAIN_STEPS = 4                    # loop.fit steps at full width
TRAIN_CKPT_EVERY = 2
RULE_TOL = {"attention": 2e-2, "embedding_bag": 1e-6, "pna_multi_agg": 1e-4}
REC_TRAIN_STEPS = 3
# xDeepFM's train_batch (65,536 users) in micro-batches: CIN's [B, 200,
# 39, 10] f32 products, kept for the backward pass, take 20 GB a layer at
# the whole batch (the gradient is the same, ``make_train_step``)
XDEEPFM_MICROBATCHES = 4


def rule_site(name, fn, plain, args, cot, tol, card):
    """(a) one backward rule at a model site: ``fn`` (the ``ops`` entry
    point: kernel forward, rule backward) and ``plain`` (its plain
    version, differentiated by autograd), both on the card from the same
    inputs and output gradient; the rule's gradients within ``tol``
    rel-to-max of autograd's, and both backward passes timed by events
    (the forward outside the timed span)."""
    import torch
    counter = {"attention": "flash_attention",
               "embedding_bag": "embedding_bag",
               "pna_multi_agg": "pna_multi_agg"}[name]
    grads, ms = {}, {}
    for label, f in (("rule", fn), ("plain", plain)):
        for rep in range(2):            # a warm-up, then the timed pass
            xs = [a.detach().requires_grad_() for a in args]
            reset_launches()
            y = f(*xs)
            launched = read_launches()[counter]
            if launched != (1 if label == "rule" else 0):
                raise AssertionError(f"train rule {name} {label}: "
                                     f"{launched} kernel launches")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            y.backward(cot)
            stop.record()
            torch.cuda.synchronize()
            ms[label] = start.elapsed_time(stop)
            grads[label] = [x.grad for x in xs]
            del y, xs
    errs = [rel_to_max(g, w) for g, w in zip(grads["rule"], grads["plain"])]
    if not (max(errs) <= tol and all(bool(g.isfinite().all())
                                     for g in grads["rule"])):
        raise AssertionError(f"train rule {name}: rel-to-max {errs} > {tol}")
    row = {"kernel": name, "shapes": [list(a.shape) for a in args],
           "dtype": str(args[0].dtype)[6:], "rel_to_max": errs, "tol": tol,
           "backward_ms": ms["rule"], "plain_backward_ms": ms["plain"],
           "route": "torch ops (not a TPU kernel)"}
    print(f"train rule {name}: {json.dumps(row)} ({card})")
    return row


def train_rules(seed, dev, card):
    """(a): attention at a Qwen3 layer (1 x 16/8 heads x 4,096 x 128,
    bf16), the bag at an xDeepFM ``train_batch`` lookup (65,536 x 39
    one-hot bags over the fused 39M-row table), PNA at the Reddit
    block's layer (minibatch_lg's edges, relu messages: ties at 0)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import embedding_bag as tbag
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_multi_agg as tpna
    from repro_torch.models import gnn
    from repro_torch.models.attention import chunked_attention_plain
    from repro_torch.train import data as tdata
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    q = torch.randn(1, 16, ATTN_SEQ, 128, generator=g, device=dev)
    kv = [torch.randn(1, 8, ATTN_SEQ, 128, generator=g, device=dev)
          for _ in range(2)]
    args = [x.to(torch.bfloat16) for x in (q, *kv)]
    cot = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    rows.append(rule_site(
        "attention", lambda *x: ops.attention(*x, causal=True),
        lambda *x: chunked_attention_plain(*x, causal=True, chunk=512),
        args, cot, RULE_TOL["attention"], card))
    del q, kv, args, cot
    xcfg = configs.get_arch("xdeepfm").make_config("full", "train_batch")
    b = configs.get_arch("xdeepfm").shapes["train_batch"]["batch"]
    table = torch.randn(tbag.padded_rows(xcfg.n_fields * xcfg.field_vocab),
                        xcfg.embed_dim, generator=g, device=dev) * 0.01
    sparse = torch_of(tdata.xdeepfm_batch(seed, 0, b, xcfg.n_fields,
                                          xcfg.field_vocab)["sparse"])
    ids = tbag.field_ids(sparse.to(dev), xcfg.field_vocab).reshape(-1, 1)
    cot = torch.randn(ids.shape[0], xcfg.embed_dim, generator=g, device=dev)
    rows.append(rule_site(
        "embedding_bag", lambda t: ops.embedding_bag(t, ids),
        lambda t: tbag.embedding_bag_plain(t, ids), [table], cot,
        RULE_TOL["embedding_bag"], card))
    del table, ids, cot
    shp = configs.get_arch("pna").shapes["minibatch_lg"]
    n, e = shp["n_nodes"], shp["n_edges"]
    src = torch.randint(0, n, (e,), generator=g, device=dev)
    dst = torch.randint(0, n, (e,), generator=g, device=dev)
    edges = gnn.build_edges(src.int(), dst.int(), n)
    m = torch.relu(torch.randn(edges.src.shape[0], 75, generator=g,
                               device=dev))
    cot = torch.randn(n, 4 * 75, generator=g, device=dev)
    rows.append(rule_site(
        "pna_multi_agg", lambda f: ops.pna_multi_agg(f, edges.nbr),
        lambda f: tpna.pna_multi_agg_autograd(f, edges.nbr), [m], cot,
        RULE_TOL["pna_multi_agg"], card))
    return rows


def qwen3_train(seed, dev, card):
    """(b)-(d): Qwen3-0.6B at full width, seq ``ATTN_SEQ``: the largest
    batch of ``TRAIN_BATCHES`` whose step fits; one no-grad forward's
    attention launches; every gradient leaf finite and wq / wk / wv of
    every layer nonzero; (c) one step twice from the same state, the
    same loss and parameter bits; (b) ``TRAIN_STEPS`` steps of
    ``loop.fit`` on a repeated batch with a checkpoint every
    ``TRAIN_CKPT_EVERY`` in a temp dir, the loss descending; (d) the
    last checkpoint dropped, ``fit`` again: it resumes and lands on the
    identical loss.  Every counter is set to 0 just before each of
    these runs and read just after: a step launches the attention
    kernel twice a layer (the forward, and ``remat``'s recomputation of
    the layer in the backward pass) and nothing else."""
    import shutil
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.train import checkpoint as tckpt
    from repro_torch.train import data as tdata
    from repro_torch.train import loop as tloop
    from repro_torch.train import optimizer as topt
    from repro_torch.core import tree
    arch = configs.get_arch("qwen3-0.6b")
    cfg = arch.make_config("full", "train_4k")
    full_batch = arch.shapes["train_4k"]["batch"]
    params = tfm.init_params(seed, cfg, device=dev)
    state = topt.init(params)
    ocfg = topt.AdamWConfig(lr=1e-3, warmup_steps=1,
                            total_steps=TRAIN_STEPS)

    def loss_fn(p, b):
        return tfm.loss_fn(p, cfg, b)

    step_fn = topt.make_train_step(loss_fn, ocfg)

    def batch_of(bsz, step=0):
        return {k: torch_of(v).to(dev) for k, v in tdata.lm_batch(
            seed, step, bsz, ATTN_SEQ, cfg.vocab).items()}

    out = {"n_params": cfg.param_count(params), "seq": ATTN_SEQ}
    for bsz in TRAIN_BATCHES:          # the largest batch that fits
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            step_fn(params, state, batch_of(bsz))
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
    else:
        raise AssertionError("qwen3 train: no batch fits")
    out["batch"] = bsz
    out["reduced"] = f"batch {full_batch} -> {bsz} (the largest of " \
                     f"{TRAIN_BATCHES} whose step fits the card)"
    print(f"train qwen3-0.6b reduced: {out['reduced']}")
    batch = batch_of(bsz)
    per_step = 2 * cfg.n_layers        # the forward and remat's recompute

    def counted(label, steps, fn, *args):
        reset_launches()
        r = fn(*args)
        torch.cuda.synchronize()
        out[f"launches_{label}"] = only_launched(
            f"train qwen3 {label}", read_launches(),
            {"flash_attention": per_step * steps})
        return r

    with torch.no_grad():
        reset_launches()
        loss_fn(params, batch)
        out["launches_forward"] = only_launched(
            "train qwen3 forward", read_launches(),
            {"flash_attention": cfg.n_layers})
    loss0, grads = counted("value_and_grad", 1, topt.value_and_grad,
                           loss_fn, params, batch)
    bad = [i for i, x in enumerate(tree.leaves(grads))
           if not bool(torch.isfinite(x).all())]
    zero = [(w, i) for w in ("wq", "wk", "wv")
            for i in range(cfg.n_layers)
            if not bool((grads["attn"][w][i] != 0).any())]
    if bad or zero or not torch.isfinite(loss0):
        raise AssertionError(f"qwen3 train: non-finite leaves {bad}, zero "
                             f"attention grads {zero}, loss {loss0}")
    out["grad_leaves"] = len(tree.leaves(grads))
    del grads
    # (c) the same step twice from the same state
    first = counted("step", 1, step_fn, params, state, batch)
    first_host = [x.cpu() for x in tree.leaves(first)]
    del first
    second = step_fn(params, state, batch)
    same = all(torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.cpu().view(torch.uint8) if b.dim() else b.cpu())
               for a, b in zip(first_host, tree.leaves(second)))
    out["repeatable"] = same
    if not same:
        raise AssertionError("qwen3 train: the same step gave other bits")
    del second, first_host
    torch.cuda.empty_cache()
    # (b) the loop, with checkpoints; (d) a restart from the last but one
    log = []

    def timed(p, s, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step_fn(p, s, b)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, float(r[2]["loss"])))
        return r

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        lcfg = tloop.LoopConfig(total_steps=TRAIN_STEPS, ckpt_dir=ckpt,
                                ckpt_every=TRAIN_CKPT_EVERY, keep_last=2,
                                log_every=0)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = counted("fit", TRAIN_STEPS, tloop.fit, timed, params, state,
                      lambda step: batch, lcfg)
        out["fit_s"] = time.perf_counter() - t0
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["losses"] = [x[1] for x in log]
        out["step_ms"] = [x[0] * 1e3 for x in log]
        final = float(res.metrics["loss"])
        del res
        if not out["losses"][-1] < out["losses"][0]:
            raise AssertionError(f"qwen3 train: loss {out['losses']}")
        out["checkpoints"] = tckpt.list_steps(ckpt)
        shutil.rmtree(tckpt._step_dir(ckpt, TRAIN_STEPS))
        log.clear()
        t0 = time.perf_counter()
        res = counted("restart", TRAIN_STEPS - TRAIN_CKPT_EVERY, tloop.fit,
                      timed, params, state, lambda step: batch, lcfg)
        out["restart_s"] = time.perf_counter() - t0
        out["restart_steps"] = len(log)
        out["restart_loss"] = float(res.metrics["loss"])
        del res
        if out["restart_loss"] != final or \
                len(log) != TRAIN_STEPS - TRAIN_CKPT_EVERY:
            raise AssertionError(f"qwen3 train: restart {out}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    ms = sorted(out["step_ms"][1:]) or out["step_ms"]
    out["step_ms_median"] = ms[len(ms) // 2]
    out["tokens_per_s"] = bsz * ATTN_SEQ / (out["step_ms_median"] / 1e3)
    print(f"train qwen3-0.6b: {json.dumps(out)} ({card})")
    return out


def launcher_smoke(dev, card):
    """(e): ``launch.train.main`` on the card at smoke scale, 3 steps, for
    every arch; each ends with a finite loss."""
    import io

    from repro_torch import configs
    from repro_torch.launch import train as tlaunch
    out = {}
    for arch in configs.ARCHS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tlaunch.main(["--arch", arch, "--steps", "3", "--device",
                               str(dev), "--log-every", "0"])
        done = buf.getvalue().strip().splitlines()[-1]
        if rc != 0 or not done.startswith("done: step=3 loss="):
            raise AssertionError(f"launch.train {arch}: rc {rc}, {done}")
        out[arch] = {"done": done, "s": time.perf_counter() - t0}
        print(f"train launcher {arch}: {done} "
              f"({out[arch]['s']:.1f} s, {card})")
    return out


def rec_gnn_train(seed, dev, card):
    """(f): xDeepFM at ``train_batch`` (65,536) and PNA at minibatch_lg,
    both at full width, ``REC_TRAIN_STEPS`` steps each through
    ``make_train_step`` (xDeepFM's in ``XDEEPFM_MICROBATCHES``
    micro-batches), with every launch counter set to 0 just before and
    read just after: one bag launch a micro-batch, one PNA launch a
    layer a step, nothing else."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import train as tlaunch
    from repro_torch.train import optimizer as topt
    out = {}
    for arch_id, shape_id, kernel, micro in (
            ("xdeepfm", "train_batch", "embedding_bag", XDEEPFM_MICROBATCHES),
            ("pna", "minibatch_lg", "pna_multi_agg", 1)):
        arch = configs.get_arch(arch_id)
        cfg = arch.make_config("full", shape_id)
        per_step = cfg.n_layers if arch_id == "pna" else micro
        shp = arch.shapes[shape_id]
        params, loss_fn = tlaunch.model_fns(arch, cfg, shp, seed, dev)
        state = topt.init(params)
        step_fn = topt.make_train_step(loss_fn, topt.AdamWConfig(lr=1e-3),
                                       microbatches=micro)
        batches = tlaunch.make_batch_fn(arch, cfg, shp, seed)
        to_dev = tlaunch.to_device_fn(dev)
        batch = to_dev(batches(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        losses, ms = [], []
        for i in range(REC_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = only_launched(f"train {arch_id}", read_launches(),
                                 {kernel: per_step * REC_TRAIN_STEPS})
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train {arch_id}: losses {losses}")
        out[arch_id] = {"shape": shape_id, "microbatches": micro,
                        "losses": losses, "step_ms": ms,
                        "launches": launches,
                        "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        print(f"train {arch_id} {shape_id}: {json.dumps(out[arch_id])} "
              f"({card})")
        del params, state, batch, m
        torch.cuda.empty_cache()
    return out


def train_phase(seed, dev, report, card):
    """Step 14: the training path on the card, (a)-(f) of the module
    docstring, with torch's deterministic algorithms on (as the
    launcher sets them) and off again after, the environment as it
    was."""
    import os

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t_step = time.perf_counter()
    env = dict(os.environ)
    held = torch.cuda.memory_allocated(dev)
    # the launcher's deterministic mode, but not its cuBLAS workspace
    # setting, which would stay with the later steps' products
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        step = {"rules": train_rules(seed, dev, card)}
        torch.cuda.empty_cache()
        step["qwen3"] = qwen3_train(seed, dev, card)
        torch.cuda.empty_cache()
        step["launcher"] = launcher_smoke(dev, card)
        step["rec_gnn"] = rec_gnn_train(seed, dev, card)
    finally:
        torch.use_deterministic_algorithms(False)
        os.environ.clear()
        os.environ.update(env)
    step["step_s"] = time.perf_counter() - t_step
    step["held_by_earlier_steps_bytes"] = held
    print(f"train step: {step['step_s']:.1f} s wall, held before {held} B "
          f"({card})")
    report["train"] = step


if __name__ == "__main__":
    sys.exit(main())
