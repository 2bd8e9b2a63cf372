#!/usr/bin/env python3
"""Smoke run of the PyTorch port (embeddinghub_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), the CUDA version,
   and the seconds it takes to build the kernels from csrc/.
2. Kernels against their plain PyTorch versions, on the card, at every
   shape a path below gives them (capacity and live rows included), and at
   B=1024 for l2 and cosine over 1M rows (capacity 1,048,576) x 128, plus
   K1's bf16-operand instantiation and K1 l2 at B=4096 (distances in the
   hundreds, the tight case of its compensated TF32 product): K1 at k=16,
   K2 (on the arena's bf16 mirror) at k=128, and K1's large-k route at
   k=2048.  Median device ms of each (CUDA events, 5 runs after 2
   warm-ups), beside its bound (the larger of the operations over the
   card's peak for their type and the bytes over its memory rate, counted
   from this case's live rows; bf16 operands, K2's and K1's exact=False,
   count at the bf16 tensor-core rate; K1's f32 operands at the lesser of
   f32 FMA and its three TF32 passes, and the line keeps the FMA figure
   too), the achieved TFLOP/s and library_ms: the same product alone as
   one PyTorch call per arena chunk (bf16 matmul with bf16 output for K2,
   bf16 matmul with f32 output for K1's exact=False, f32 matmul with TF32
   off for K1's exact=True), which the port never calls.  Each
   K1 case also prints the largest error of its distances, and of its plain
   version's, against a float64 product of the rows each returned.  Two K1
   cases are the graph build's pools (phase 8): B=4096, k=256, bf16
   operands (exact=False), l2 over the 1M rows, and an upper layer's, k=64
   over a 65,536-row sub-arena of which 62,165 rows are live (layer 1 of
   a 1M-row graph: the level draws are the index's, seed 100).  Three K1
   cases are the graph writes' pools (phase 9), bf16 operands at B=4096:
   the layer-0 wave pool, k=200 over the arena's live prefix of 1,114,688
   rows (the last wave's high-water mark); the upper wave pool, k=64 over
   the 69,197 rows of layer 1's members; and refine's pools, k=256 over
   1,118,784 rows of which 1,108,784 are live.  Four K1 cases are the
   cluster-routed build's pools (phase 10), bf16 operands: the routed
   pool, k=257 over a block's 32,768 gathered candidate rows at B=4096,
   and at a cluster's remainder blocks (B=1,145 over 20,000 live rows,
   B=37 over 9,000: the arena's -1 tail is invalid rows); and the boundary
   repair's, k=256 at B=4096 over the live prefix of 4,000,000 rows.
   The summary line reports the 1M-row cosine numbers at B=4096 (K1, K2)
   and B=16 (large k), and the graph builds' and the waves' pool cases as
   entries of their own.  Then K2's candidate pools (QUANT_CASES), the
   phase 1 of the quantized searches, at every shape phase 11 gives them:
   the int8 instantiation over the 1M rows' int8 planes (B=4096, k=128 and
   256, one segment) and over 10,485,760 x 96 normal rows drawn on the
   card (B=1,024, 40 segments of 262,144 rows, k=256 and 128; B=64 and 8,
   segments of 2**20 rows, k=256), and K2's bf16 scan as the deep bf16
   pool; each against its plain version (the same sorted scores, exactly
   for int8, within 1e-3 for bf16; every id a live row of its segment, one
   a bin; an id that differs from the plain version's scores, by the plain
   formula, as the plain version's slot: ids differ only between ties),
   with its bound
   (int8 operations at 1,979 TOPS) and library_ms (torch._int_mm of the
   int8 queries and the plane, per arena chunk; none below 17 queries).
   Phase 12's shapes are cases too, one shard's each: K1 at B=4096, k=16
   (cosine, exact) over 250,000 live rows in 262,144; its build pool at
   B=4096, k=256 (bf16 operands) over the same; its wave pool at B=1,024,
   k=200 over the 251,024-row live prefix; and K2's int8 pool at B=1,024
   and B=8 over 16 segments of 2**18 rows of which 2,500,000 (and the
   streamed rows) are live.  Phase 13's shape is a case too: K2 at B=1,
   k=128, cosine over the first 262,144 of the 1M rows (capacity 262,144),
   reported as an entry of its own.
3. Main path in process, at SIFT-1M scale: EmbeddingHub on "cuda" ->
   create_space(128, cosine) -> Version.multiset of 1,000,000 keyed rows in
   4096-row batches -> nearest_batch of 4096 queries at k=10 under
   mode="auto" (must run K2, recall@10 >= 0.995 against an exact oracle
   computed on the card) -> FlatIndex.search(mode="exact") (must run K1,
   ids equal to the oracle up to ties) -> keyed nearest (excludes self) ->
   delete (the key never comes back).
4. Over the wire: the port's gRPC server in process on 127.0.0.1, driven
   through the raw EmbeddingHubStub: CreateSpace, MultiSet of 100,000 rows,
   NearestNeighbor by embedding and by key, NearestNeighbor with num=1500
   (a 2048-wide fetch: K1's large-k route), BatchNearestNeighbor of 1024
   queries and Get must equal the in-process store's answers; Set after
   FreezeSpace fails with FAILED_PRECONDITION, NearestNeighbor with key and
   embedding with INVALID_ARGUMENT.  Without grpc the script fails here.
5. Restore, 1M x 128 cosine, in a temporary data directory removed at the
   end: EmbeddingHub.load_or_create(dir, "cuda") -> multiset of 1,000,000
   rows in 4096-row batches with the WAL on (rows/s, WAL bytes) -> delete
   "k123" -> nearest_batch of 4096 queries at k=10 -> drop the hub unsaved
   and reopen from the WAL alone (reopen s): the same lists, "k123" absent,
   K2 launched -> save (s, snapshot bytes) and reopen from the snapshot
   (reopen s, first query s with the full upload): the same lists again ->
   exact search at k=10 (K1) and at k=2048 (K1's large-k route) of 16
   queries, ids equal to an on-card oracle up to ties.
6. Crash, over the wire and without jax: the port's server as a subprocess
   on a data directory; through the port's EmbeddingHubClient a MultiSet of
   20,000 acknowledged rows and 500 set(wait=False); SIGKILL; restart on the
   same directory: every acknowledged row comes back bit-exact (MultiGet),
   Download holds at least 20,000 rows, NearestNeighbor by key excludes the
   key; on SIGTERM the server prints its kernel launches.  Every wait on
   the subprocess is bounded (service/spawn.py).
7. Offline: the port's sdk.offline.Index on "cuda" over the first 100,000
   rows answers nearest_neighbor_batch and a keyed nearest_neighbor as a
   Version over the same rows does, at recall@10 >= 0.99 against the
   exact oracle.
8. Graph, the hnsw engine at 1M x 128 (the ROADMAP's graph cell): SIFT-
   statistics proxy rows and 1,024 queries (sift_proxy, a numpy copy of
   benchmarks/cluster_build.py:40-76, rng seeds 0 and 1) ->
   EmbeddingHub.load_or_create(dir, engine="hnsw", device="cuda") ->
   create_space(128, l2) -> one Version.multiset of all rows with the WAL
   on: one exact bulk build at M=16, efC=200 (must launch K1 for its
   pools), its seconds by part (pools, prune, symmetrize, upper, host) ->
   an exact top-10 oracle from K1 (exact=True) -> HNSWIndex.search at ef
   50, 100 and 200 (expand 8, the bf16 walk), B=1024, k=10: recall@10,
   device ms per batch (CUDA events around the call, median of 5 after 2
   warm-ups), beam iterations (hops) and ms per hop; recall@10 at ef=100
   must be >= 0.95 -> the same at ef=100 on the packed walk (pack_walk) ->
   save -> the port's gRPC server in process on the data directory (a
   reopen from the snapshot): nearest_batch, BatchNearestNeighbor and
   NearestNeighbor give the lists the store gave before the save.  About
   a minute on an H100.
9. Graph writes, into the store phase 8 reopened (no second build): 24
   Version.multiset calls of 4,096 new SIFT-proxy rows (rng seed 2), one
   wave each (K1 must launch): rows/s, median ms a wave, the wave's parts
   (HNSWIndex.wave_seconds: layer-0 pool, upper pools, scatter, prune,
   reciprocal commits, device-state rebuild, host, the rollback copies)
   and the capacity-growth
   wave (2**20 -> 2**21 rows) apart -> a raw-stub MultiSet of 20,480 rows
   over the wire (5 flushes, 5 waves) ->
   recall@10 at ef 50/100/200 against an exact K1 oracle over every live
   row (ef=100 must reach 0.95) and a self-check (1,024 inserted rows
   find themselves in their top 10 at ef=100 at a rate of 0.99 or more)
   -> 10,000 Version.delete calls, half old rows and half new (deletes/s;
   no deleted key in any list; recall at ef=100 still 0.95) -> refine of
   8,192 inserted rows (K1 must launch; recall may fall by 0.005 at most)
   -> save, then one more wave and 100 deletes unsaved -> the store
   dropped and reopened from snapshot + WAL: every acknowledged key
   bit-exact (Get), no deleted key, recall at ef=100 still 0.95.
10. The cluster-routed build at 4M x 128: 4,000,000 SIFT-proxy rows (drawn
   in worker processes, a generator per 2**18-row chunk, seed 10), 1,024
   queries (seed 11) -> EmbeddingHub.load_or_create(dir, engine="hnsw",
   device="cuda") -> one Version.multiset of all rows with the WAL on: one
   cluster-routed build at M=16, efC=200 and the default cluster knobs
   (k-means of 1,024 clusters, pools over 8 probed clusters, an exact
   boundary repair of half the rows), its seconds by part, its plan
   (_cluster_stats), the boundary rows and K1's launches by kind -> an exact
   top-10 oracle from K1 -> recall@10, ms per batch and hops at ef 50, 100
   and 200 (at least 0.97 at ef=200 and 0.91 at ef=100) -> build_route(16)
   and the routed walk at ef=100 (recall no more than 0.01 below the
   descent's) -> 3 multisets of 4,096 new rows (seed 12), one wave each
   (rows/s) -> save, reopen from the snapshot: the same routed lists.
11. The quantized flat arenas.  (a) EmbeddingHub(engine="flat-bf16",
   "flat-int8", "flat-int8x2") on "cuda", each filled with phase 3's 1M x
   128 cosine rows by Version.multiset in 4,096-row batches ->
   nearest_batch of 4,096 queries at k=10: the dtype the guard kept, ms a
   call, device ms, a torch.profiler split of the device time (K2's scan,
   its select, the rest) and recall@10 against K1's exact oracle (int8 and
   int8x2 >= 0.95; bf16, and its mode="exact" (K1 over f32 upcasts of the
   bf16 plane), within 0.001 of the storage's ceiling, the exact top-10
   over the unit rows rounded to bf16 computed here, with 0.995 printed).
   (b) benchmarks/capacity.py's Deep-10M cell: its generator copied here
   (1,024 centers, noise 0.35, one default_rng(0): centers, 10,000,000 x 96
   rows in steps of 2,000,000, a 1,024-query batch, 256 recall queries) ->
   an in-memory EmbeddingHub(engine="flat-int8"), one multiset of the keyed
   rows -> the first search runs the guard, which must escalate int8 ->
   int8x2 (its sampled recall printed) -> nearest_batch of the 1,024 at
   k=10 (ms, device ms and its split) -> recall@10 of the 256 in a batch of
   1,024 padded with zeros against K1's exact oracle over the f32 rows,
   >= 0.977 -> the same rows as an int8 FlatIndex without the guard and as
   a bf16 one (recall printed) -> audit_quantization(bar=0.95, nq=64) ->
   100,000 rows streamed in multisets of 8,192, a search after each (the
   dirty-row scatter): 64 of them must find themselves -> the version's
   snapshot (store/persistence.save_version, what hub.save writes for it)
   and a reopen that must quantize nothing and give the same lists.

12. The sharded engines (parallel/) on Mesh(["cuda"] * 4), four shards of
   the one card.  (a) EmbeddingHub(engine="sharded") filled with phase 3's
   1M x 128 cosine rows in 4,096-row multisets (250,000 rows a shard in a
   local capacity of 2**18) -> nearest_batch of 4,096 queries at k=10: one
   K1 launch a shard, ms a call, device ms, a torch.profiler split (the K1
   scans, the rest: the merge of the [B, 4 x 16] lists); the lists equal
   one card's FlatIndex.search(mode="exact") up to ties (slots within 1e-5)
   and recall@10 against those exact lists >= 0.999.  (b) Phase 11's
   Deep-10M rows (no second draw) in EmbeddingHub(engine="sharded-int8"),
   one multiset: 2,500,000 rows a shard in 2**22 local rows, the deep path
   (16 chunks of 2**18 rows, K2's int8 pool once a shard) -> the first
   search runs the guard, which must escalate int8 -> int8x2 -> B=1,024:
   ms, device ms and split, recall@10 of the 256 recall queries >= 0.977
   against phase 11's K1 oracle -> 4 multisets of 8,192 new rows, a search
   after each (the scatter); 64 of them must find themselves -> the
   version's snapshot (store/persistence.save_version; the in-memory hub
   keeps no 4 GB WAL of the 10M rows) and a reopen onto the same mesh
   (load_version(mesh=...)): int8x2 from sflat_meta, the same lists.  (c)
   Phase 8's 1M SIFT-proxy rows in EmbeddingHub(engine="hnsw-sharded",
   M=16, efC=200) on a data directory, one multiset with the WAL on: four
   exact bulk builds of 250,000 rows (K1's pools), their seconds ->
   recall@10 at ef 50/100/200 against an exact K1 oracle (>= 0.95 at
   ef=100) and device ms per 1,024-query batch -> 2 multisets of 4,096 new
   rows (seed 3; a wave of 1,024 rows a shard, K1's pools) -> hub.save()
   and a reopen onto the mesh: the same lists.  A [sharded] line prints a
   JSON object of shards, rows a shard, ms, recall and the guard's dtype
   and recall.
13. The feature store's vector serving path (embeddinghub_tpu_torch.
   featurestore), in process: a port ff.Client applies a sqlite offline
   store, the engine vector store on "cuda", an entity, primary data of
   the first 262,144 of phase 3's rows ({"key": "e<i>", "vec": [...]})
   and an embedding feature of 128 dims -> every resource READY, the
   vector space "vector__emb__default" on the card with 262,144 rows; the
   seconds of the apply, of the sqlite registration, of the
   materialization and of the copy into the engine -> 8 warm-up calls,
   then 256 single client.nearest(..., 10) calls (128 stored rows with
   noise 0.05 * N(0, 1), 128 fresh Gaussian vectors; seed SEED + 13): each
   call's keys equal Version.nearest_batch's for the same vector,
   recall@10 >= 0.99 against the exact oracle on the card, top-1 the
   source row for >= 99 % of the copies; p50 and p99 ms a call, the
   median CUDA-event ms a call and K2's launches a call -> 4 calls, then
   16 each in tracing.annotate("ff.nearest"), under tracing.profile: the
   Chrome trace must hold 16 ff.nearest ranges and at least 16 launches
   each of k2_scan_kernel and k2_select_kernel; their device us a launch,
   every kernel's us a call, and the device's idle share over an
   untraced call.
14. The composer, over the wire: phase 13's rows in a .npy file and a
   definitions file that loads them and registers phase 13's resources
   (the engine vector store on its default "cuda") ->
   MALLOC_ARENA_MAX=1 python -m embeddinghub_tpu_torch.main --defs ... on
   free ports (the store, serving and metadata gRPC servers, the
   dashboard, the coordinator's poll loop; service/spawn.ComposerProcess,
   bounded waits)
   -> seconds to its "up" line, then to every resource READY, polled over
   its metadata gRPC (the compact service for the providers, the entity
   and the feature; the typed ff_metadata service for the source, whose
   compact blob carries the inline rows) -> 8 warm-ups and phase 13's 256
   queries as single RemoteServingClient.nearest(..., 10) calls: every key
   list equal to phase 13's in-process one, recall@10 >= 0.99 against
   phase 13's oracle, p50 and p99 ms a call -> the same 256 calls from 8
   client threads, a channel each, 32 calls each: every answer equal to
   the single client's, calls/s and p99 -> the store surface through the
   port's EmbeddingHubClient (a space of 4,096 rows: multiset, get
   bit-exact, a keyed nearest_neighbor without the key, its l2 distances
   those of an exact f64 oracle; phase 2 holds K1 at this shape too) ->
   the dashboard's
   /data/features lists emb -> SIGTERM: the composer stops, exits 0 and
   reports its kernel launches (K2 at least once a Nearest call, and K1).

Without grpc the script fails (phases 4, 6 and 14 need it).  The launch
counters are zeroed just before each path (main: phases 3-4; restore: 5;
offline: 7; graph: 8; writes: 9; cluster: 10; quantized: 11; sharded: 12;
featurestore: 13) and read just after it; the crash path's (6) and the
composer path's (14) are those their subprocesses report as they stop.  Each path must
have launched the kernels it runs.  The second-to-last line is a JSON
summary of the kernels, an entry per summary case: "launches" is the main
path's count (the graph path's for the build's pool cases, the writes
path's for the waves', the cluster path's for the cluster-routed build's,
the quantized path's for the pools, the sharded path's for its shapes,
the featurestore path's for phase 13's shape, the composer path's for
its store surface's),
"paths" each path's own.  The last line is {"ok": true, "device": {...}}.  Data comes from
numpy with a fixed seed.
"""

from __future__ import annotations

import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 20261016
ROWS, CAP, DIMS = 1_000_000, 1 << 20, 128
MAIN_B, MAIN_K = 4096, 10
WIRE_ROWS, WIRE_B = 100_000, 1024
WIRE_CAP = 1 << 17  # the capacity 100,000 rows take (and the offline Index's)
BIG_K, BIG_B, BIG_NUM = 2048, 16, 1500  # exact search past K1's lists (k > 1024)
CRASH_ROWS, CRASH_UNACKED = 20_000, 500
CRASH_CAP = 1 << 15
OFFLINE_ROWS, OFFLINE_B = 100_000, 1024
# K2 keeps one row per 128-row group: over 782 groups two of a query's 10
# nearest share one with odds about 45/782, so recall@10 is near 0.994 by
# design (0.9995 over the 1M rows of phase 3).
OFFLINE_RECALL = 0.99
GRAPH_QUERIES, GRAPH_K, GRAPH_EFS = 1024, 10, (50, 100, 200)
GRAPH_M, GRAPH_EFC, GRAPH_RECALL = 16, 200, 0.95  # recall@10 at ef=100
GRAPH_POOL_B, GRAPH_POOL_K = 4096, 256  # the build's layer-0 pools
# Layer 1 of a 1M-row graph: 62,165 members of the index's level draws
# (seed 100, P(level >= 1) = 1/16), a sub-arena rounded up to 65,536, pools
# of 4M = 64.
UPPER_CAP, UPPER_ROWS, UPPER_K = 1 << 16, 62_165, 64
FLUSH = 4096  # the server's MultiSet flush size
CARD = "cuda"  # the device of phases 8, 9 and 13
# Phase 9, writes into the phase-8 graph: 24 in-process multisets of FLUSH
# rows, 5 wire flushes, 10,000 deletes, a refine of 8,192 rows, one more
# wave after a save.  Each multiset of FLUSH rows is one wave.
WAVE_ROWS, WIRE_WAVE_ROWS = 24 * FLUSH, 5 * FLUSH
WAVE_POOL_K = 200  # ef0 = min(max(efC, 16), 1024)
# The last wave's layer-0 pool scans the arena's live prefix (its
# high-water mark), and its layer-1 pool the layer's 69,415 members: the
# 62,165 of the build and those of the first 114,688 level draws of the
# reopened index (a fresh generator, seed 100; P(level >= 1) = 1/16).
WAVE_HI = ROWS + WAVE_ROWS + WIRE_WAVE_ROWS - FLUSH
WAVE_UPPER = 69_415
DELETES, REFINE_ROWS, SELF_QUERIES, SELF_RATE = 10_000, 8_192, 1_024, 0.99
# Phase 10, the cluster-routed build: 4M SIFT-proxy rows (rng seeds 10 for
# the rows, 11 for the queries, 12 for the waves) in one cold multiset, the
# default cluster knobs (target 4,096, probes 8, repair 0.5).  Its routed
# pools: blocks of up to 4,096 rows, K1 for 256 + 1 (the own row goes after)
# over S = next_pow2(8 * 4096) gathered rows; its boundary repair: refine's
# pools (k = 256) over the live prefix of every row.
BIG_ROWS, BIG_WAVES = 4_000_000, 3
ROUTED_S, ROUTED_K = 8 * 4096, GRAPH_POOL_K + 1
# A cluster's last block is shorter (clusters of 2,565 to 5,241 rows leave
# remainders down to a few rows), and most arenas end in -1 padding (rows
# K1 reads as invalid): a remainder block of 1,145 rows over 20,000 live
# rows, and one narrower than a 128-query tile over 9,000.
ROUTED_TAILS = ((1145, 20_000), (37, 9_000))
# recall@10 bars at ef 200 and 100 (the reference's graph at these knobs and
# this size reached 0.9740 and 0.9221, benchmarks/RESULTS.md:569-573; the
# bars allow 0.01 for the sample of queries)
BIG_RECALL = {200: 0.97, 100: 0.91}
ROUTE_PROBES = 16
# Phase 11, the quantized arenas.  (a) The 1M x 128 cosine rows of phase 3
# in a flat-bf16, a flat-int8 and a flat-int8x2 store, recall@10 bars: int8
# and int8x2 the quantization guard's; bf16 the main path's 0.995 is the
# bf16 storage's own ceiling on these rows, so the bf16 store (and its mode
# "exact", K1 over f32 upcasts) is held to that ceiling less
# QUANT_BF16_GAP, and 0.995 is printed.  The ceiling is computed here, not
# by the port: the exact top-10 of the f32 queries over the unit rows
# rounded to bf16 (exact_oracle).
QUANT_BARS = {"flat-bf16": 0.995, "flat-int8": 0.95, "flat-int8x2": 0.95}
QUANT_BF16_GAP = 0.001
# (b) benchmarks/capacity.py's Deep-10M cell (benchmarks/RESULTS.md:117-172),
# its widths and scale: 10,000,000 x 96 cosine rows around 1,024 centers,
# noise 0.35 (near duplicates); a 1,024-query batch; 256 recall queries
# searched in a batch of 1,024 padded with zeros (capacity.py:163-166), so
# that the deep path's chunk is the reference's, 262,144 rows, and its pool
# 256 candidates a chunk; then 100,000 rows streamed in multisets of 8,192.
DEEP_ROWS, DEEP_DIMS, DEEP_CENTERS, DEEP_NOISE = 10_000_000, 96, 1024, 0.35
DEEP_CAP = 10 * (1 << 20)  # the capacity 10,000,000 rows take (1M-row blocks)
DEEP_B, DEEP_RECALL_Q, DEEP_GEN_STEP = 1024, 256, 2_000_000
DEEP_CHUNK = 1 << 18  # FlatIndex._deep_chunk of a 1,024-query batch
DEEP_STREAM, DEEP_WAVE, DEEP_SELF = 100_000, 8192, 64
# The reference served recall@10 0.9871 after its guard escalated int8 to
# int8x2 (RESULTS.md:159-162); the bar allows 0.01 for the sample.
DEEP_RECALL = 0.977
# Phase 2: a live prefix that ends mid-tile and mid-segment (a multiple of 8
# rows, as torch._int_mm in the library call wants).
POOL_PREFIX = 600_008
# Phase 12, the sharded engines on a mesh of SHARDS shards of one card: (a)
# phase 3's 1M x 128 cosine rows in a "sharded" store (250,000 live rows in
# a local capacity of 2**18 a shard: K1 at k=16 on each); (b) phase 11's
# Deep-10M rows in a "sharded-int8" store (2,500,000 a shard in 2**22 local
# rows, past the 2**21-row shard threshold: K2's int8 pool over 16 chunks of
# 2**18 rows, 256 candidates each), then SHARD_STREAMS multisets of
# DEEP_WAVE new rows; (c) phase 8's 1M SIFT-proxy rows in an "hnsw-sharded"
# store: four exact bulk builds of 250,000 rows (K1's pools at k=256 over
# 262,144 padded rows), then SHARD_GRAPH_WAVES multisets of FLUSH rows (a
# wave of 1,024 rows a shard: K1's layer-0 pool at k=200 over the shard's
# live prefix).
SHARDS = 4
SHARD_CAP, SHARD_ROWS = 1 << 18, ROWS // SHARDS
SHARD_RECALL, SHARD_TIE = 0.999, 1e-5
SHARD_DEEP_CAP, SHARD_DEEP_ROWS = 1 << 22, DEEP_ROWS // SHARDS
SHARD_DEEP_CHUNK = 1 << 18  # parallel/sharded_flat._DEEP_CHUNK
SHARD_STREAMS, SHARD_SELF = 4, 64
SHARD_GRAPH_WAVES = 2
SHARD_WAVE_B = FLUSH // SHARDS
# Phase 13, the feature store's vector serving path: phase 3's first FS_ROWS
# rows (keys e0...) as an embedding feature of a sqlite source, materialized
# into the engine vector store on the card (capacity FS_ROWS, past
# FlatIndex's 65,536-row approximate threshold: K2 and the f32 rerank, a
# pool of 10 -> 16 * 8 = 128 groups), then FS_QUERIES single nearest calls
# after FS_WARM warm-ups: FS_NEAR noisy copies of stored rows and fresh
# Gaussian vectors; FS_TRACED of them under tracing.profile.  1M rows would
# add minutes of JSON encoding in the sqlite store.
FS_ROWS = 1 << 18
FS_K, FS_WARM, FS_QUERIES, FS_NEAR, FS_NOISE, FS_TRACED = 10, 8, 256, 128, 0.05, 16
FS_TRACE_WARM = 4
FS_RECALL, FS_TOP1 = 0.99, 0.99
# Phase 14, the composer: phase 13's definitions (a sqlite source of FS_ROWS
# rows, the engine vector store on the card, the entity, the embedding
# feature: 5 resources) applied by its coordinator, READY within
# COMPOSER_READY_S; FS_WARM + FS_QUERIES single Nearest calls, then
# COMPOSER_THREADS clients of COMPOSER_CALLS calls each over phase 13's
# queries; a store-surface space of COMPOSER_STORE_ROWS rows (exact: K1).
COMPOSER_RESOURCES, COMPOSER_READY_S = 5, 300
COMPOSER_THREADS, COMPOSER_CALLS = 8, 32
COMPOSER_STORE_ROWS = 4096
COMPOSER_STORE_CAP = 1 << 12  # the capacity 4,096 rows take
# (kernel, metric, B, k, exact, capacity, live rows) compared with its plain
# version, at every shape a path gives it; exact is K1's operand precision
# (None for K2, which is always bf16).
KERNEL_CASES = (
    ("fused_topk_search", "l2", GRAPH_POOL_B, GRAPH_POOL_K, False, CAP, ROWS),  # graph
    ("fused_topk_search", "l2", GRAPH_POOL_B, UPPER_K, False, UPPER_CAP, UPPER_ROWS),
    ("fused_topk_search", "l2", GRAPH_QUERIES, GRAPH_K, True, CAP, ROWS),  # graph oracle
    ("fused_topk_search", "l2", FLUSH, WAVE_POOL_K, False, WAVE_HI, WAVE_HI),  # writes
    ("fused_topk_search", "l2", FLUSH, UPPER_K, False, WAVE_UPPER, WAVE_UPPER),
    ("fused_topk_search", "l2", FLUSH, GRAPH_POOL_K, False, WAVE_HI + FLUSH,  # refine
     WAVE_HI + FLUSH - DELETES),
    ("fused_topk_search", "l2", FLUSH, ROUTED_K, False, ROUTED_S, ROUTED_S),  # cluster
    *(("fused_topk_search", "l2", b, ROUTED_K, False, ROUTED_S, rows)
      for b, rows in ROUTED_TAILS),
    ("fused_topk_search", "l2", FLUSH, GRAPH_POOL_K, False, BIG_ROWS, BIG_ROWS),
    ("fused_topk_search", "l2", 1024, 16, True, CAP, ROWS),
    ("fused_topk_search", "cosine", 1024, 16, True, CAP, ROWS),
    ("fused_topk_search", "cosine", 1024, 16, False, CAP, ROWS),
    ("fused_topk_search", "cosine", MAIN_B, 16, True, CAP, ROWS),       # main, restore
    ("fused_topk_search", "l2", MAIN_B, 16, True, CAP, ROWS),
    ("fused_topk_search", "l2", 1, 16, True, CRASH_CAP, CRASH_ROWS + CRASH_UNACKED),  # crash
    ("fused_topk_search", "l2", 1, 16, True, COMPOSER_STORE_CAP,  # composer
     COMPOSER_STORE_ROWS),
    ("fused_topk_search_v2", "l2", 1024, 128, None, CAP, ROWS),
    ("fused_topk_search_v2", "cosine", 1024, 128, None, CAP, ROWS),
    ("fused_topk_search_v2", "cosine", MAIN_B, 128, None, CAP, ROWS),   # main, restore
    ("fused_topk_search_v2", "cosine", 1, 128, None, CAP, ROWS),        # main
    ("fused_topk_search_v2", "cosine", 1, 128, None, FS_ROWS, FS_ROWS),  # featurestore
    ("fused_topk_search_v2", "l2", WIRE_B, 128, None, WIRE_CAP, WIRE_ROWS),     # wire
    ("fused_topk_search_v2", "l2", 1, 128, None, WIRE_CAP, WIRE_ROWS),          # wire
    ("fused_topk_search_v2", "cosine", OFFLINE_B, 128, None, WIRE_CAP, OFFLINE_ROWS),  # offline
    ("fused_topk_search_v2", "cosine", 1, 128, None, WIRE_CAP, OFFLINE_ROWS),   # offline
    ("fused_topk_search_large_k", "l2", 1, BIG_K, True, WIRE_CAP, WIRE_ROWS),   # wire
    ("fused_topk_search_large_k", "cosine", BIG_B, BIG_K, True, CAP, ROWS),     # restore
    ("fused_topk_search", "cosine", MAIN_B, 16, True, SHARD_CAP, SHARD_ROWS),   # sharded
    ("fused_topk_search", "l2", GRAPH_POOL_B, GRAPH_POOL_K, False, SHARD_CAP, SHARD_ROWS),
    ("fused_topk_search", "l2", SHARD_WAVE_B, WAVE_POOL_K, False, SHARD_ROWS + SHARD_WAVE_B,
     SHARD_ROWS + SHARD_WAVE_B),
)
# K2's candidate pools (phase 11's phase 1) compared with their plain
# version, at every shape phase 11 gives them: (kernel, metric, B, k,
# capacity, live rows, dims, segment rows or None for one segment).  The
# live rows are the arena's high-water mark, which the kernel is given (the
# rows past it dead); the plain version scores the whole capacity.  The
# int8 pools: the shallow flat-int8 and flat-int8x2 stores at 1M (k * 8 and
# k * 16 of a 16-wide fetch); the deep int8x2 arena at B=1,024 (chunks of
# 262,144 rows, 256 a chunk), its guard-off int8 twin (128 a chunk), the
# audit's 64 queries and the stream's searches of 8 (chunks of 2**20 rows
# for their padded batches of 64 and 8); the deep bf16 arena's pool is K2's
# bf16 scan.
QUANT_CASES = (
    ("fused_topk_search_v2_int8", "cosine", MAIN_B, 128, CAP, ROWS, DIMS, None),
    ("fused_topk_search_v2_int8", "cosine", MAIN_B, 256, CAP, ROWS, DIMS, None),
    # a live prefix that ends mid-segment, three segments of 2**17 rows past it
    ("fused_topk_search_v2_int8", "cosine", DEEP_B, 256, CAP, POOL_PREFIX, DIMS, 1 << 17),
    ("fused_topk_search_v2_int8", "cosine", DEEP_B, 256, DEEP_CAP, DEEP_ROWS, DEEP_DIMS,
     DEEP_CHUNK),
    ("fused_topk_search_v2_int8", "cosine", DEEP_B, 128, DEEP_CAP, DEEP_ROWS, DEEP_DIMS,
     DEEP_CHUNK),
    ("fused_topk_search_v2_int8", "cosine", 64, 256, DEEP_CAP, DEEP_ROWS, DEEP_DIMS, 1 << 20),
    ("fused_topk_search_v2_int8", "cosine", 8, 256, DEEP_CAP, DEEP_ROWS + DEEP_STREAM,
     DEEP_DIMS, 1 << 20),
    ("fused_topk_search_v2", "cosine", DEEP_B, 128, DEEP_CAP, DEEP_ROWS, DEEP_DIMS,
     DEEP_CHUNK),
    # phase 12 (b): one shard's deep int8x2 arena, its searches of 1,024 and 8
    ("fused_topk_search_v2_int8", "cosine", DEEP_B, 256, SHARD_DEEP_CAP, SHARD_DEEP_ROWS,
     DEEP_DIMS, SHARD_DEEP_CHUNK),
    ("fused_topk_search_v2_int8", "cosine", 8, 256, SHARD_DEEP_CAP,
     SHARD_DEEP_ROWS + SHARD_STREAMS * DEEP_WAVE // SHARDS, DEEP_DIMS, SHARD_DEEP_CHUNK),
)
# The quantized cases the summary line reports: (kernel, B, k, capacity,
# segment) -> (label, the reference's XLA scan it replaces).
QUANT_SUMMARY = {
    ("fused_topk_search_v2_int8", MAIN_B, 128, CAP, None):
        ("int8 pool", "embeddinghub_tpu/ops/topk.py:301-313"),
    ("fused_topk_search_v2_int8", DEEP_B, 256, DEEP_CAP, DEEP_CHUNK):
        ("deep int8 pool", "embeddinghub_tpu/ops/topk.py:697-710"),
    ("fused_topk_search_v2", DEEP_B, 128, DEEP_CAP, DEEP_CHUNK):
        ("deep bf16 pool", "embeddinghub_tpu/ops/topk.py:697-710"),
    ("fused_topk_search_v2_int8", DEEP_B, 256, SHARD_DEEP_CAP, SHARD_DEEP_CHUNK):
        ("sharded deep int8 pool", "embeddinghub_tpu/ops/topk.py:697-710"),
}
# Published peaks of one H100 SXM (dense): bf16 and TF32 tensor cores, f32
# FMA outside them, HBM3.
PEAK_BF16, PEAK_TF32, PEAK_F32, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12
PEAK_INT8 = 1979e12  # int8 tensor cores, dense
LIBRARY_CHUNK_BYTES = 1 << 30  # one [B, chunk] product of library_ms at most
# The cases whose numbers the summary line reports, an entry each: (metric,
# B, k, exact, capacity) -> (kernel, label).
SUMMARY = {
    ("cosine", MAIN_B, 16, True, CAP): ("fused_topk_search", "main"),
    ("cosine", MAIN_B, 128, None, CAP): ("fused_topk_search_v2", "main"),
    ("cosine", 1, 128, None, FS_ROWS): ("fused_topk_search_v2", "featurestore"),
    ("cosine", BIG_B, BIG_K, True, CAP): ("fused_topk_search_large_k", "main"),
    ("l2", GRAPH_POOL_B, GRAPH_POOL_K, False, CAP): ("fused_topk_search", "graph pool"),
    ("l2", GRAPH_POOL_B, UPPER_K, False, UPPER_CAP): ("fused_topk_search",
                                                       "graph upper-layer pool"),
    ("l2", FLUSH, WAVE_POOL_K, False, WAVE_HI): ("fused_topk_search", "wave pool"),
    ("l2", FLUSH, UPPER_K, False, WAVE_UPPER): ("fused_topk_search",
                                                "wave upper-layer pool"),
    ("l2", FLUSH, ROUTED_K, False, ROUTED_S): ("fused_topk_search", "routed pool"),
    ("l2", FLUSH, GRAPH_POOL_K, False, BIG_ROWS): ("fused_topk_search",
                                                   "boundary repair pool"),
    ("cosine", MAIN_B, 16, True, SHARD_CAP): ("fused_topk_search", "sharded"),
    ("l2", GRAPH_POOL_B, GRAPH_POOL_K, False, SHARD_CAP): ("fused_topk_search",
                                                           "sharded graph pool"),
    ("l2", 1, 16, True, COMPOSER_STORE_CAP): ("fused_topk_search", "composer store"),
}
# the path whose launches a summary case reports
CASE_PATH = {"main": "main", "graph pool": "graph", "graph upper-layer pool": "graph",
             "wave pool": "writes", "wave upper-layer pool": "writes",
             "routed pool": "cluster", "boundary repair pool": "cluster",
             "int8 pool": "quantized", "deep int8 pool": "quantized",
             "deep bf16 pool": "quantized", "sharded": "sharded",
             "sharded graph pool": "sharded", "sharded deep int8 pool": "sharded",
             "featurestore": "featurestore", "composer store": "composer"}
SERVER_START_S, WAIT_S = 300, 60  # bounds on every wait for the server subprocess


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_ms(torch, fn, warmup: int = 2, runs: int = 5) -> float:
    """Median device milliseconds of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scores_of(torch, q, x, x_sq, ids, metric, bf16):
    """Distances of the given rows under a kernel's own scoring."""
    from embeddinghub_tpu_torch.ops import distance as D

    q = q.float()
    if metric == "cosine":
        q = D.normalize(q)
    rows = x[ids.clamp(min=0).long()]
    qc = q
    if bf16:
        qc, rows = D.round_bf16(q), D.round_bf16(rows)
    dots = torch.einsum("bkd,bd->bk", rows, qc)
    if metric == "l2":
        d = torch.clamp(x_sq[ids.clamp(min=0).long()] - 2 * dots
                        + (q * q).sum(1, keepdim=True), min=0)
    else:
        d = 1 - dots
    return torch.where(ids >= 0, d, float("inf"))


def compare(torch, name, got, want, truth, gap, rtol, atol):
    """Kernel (d, ids) against its plain version: same distances within
    (rtol, atol); where the ids differ, the kernel's row must score within
    ``gap + rtol*|d|`` of the plain version's row (a near-tie; the relative
    term covers f32 rounding of l2 distances in the hundreds).  Returns the
    largest absolute distance error and the number of tie swaps."""
    (dk, ik), (dr, ir) = got, want
    fin = torch.isfinite(dr)
    check(torch.equal(fin, torch.isfinite(dk)), f"{name}: finite slots differ")
    check(torch.allclose(dk[fin], dr[fin], rtol=rtol, atol=atol),
          f"{name}: distances differ beyond rtol={rtol} atol={atol}")
    swaps = ik != ir
    if swaps.any():
        off = ((truth(ik) - dr).abs() - rtol * dr.abs())[swaps]
        check(bool((off <= gap).all()),
              f"{name}: {int(swaps.sum())} id mismatches, worst gap "
              f"{float(off.max()):.3g} > {gap}")
    return float((dk[fin] - dr[fin]).abs().max()), int(swaps.sum())


def bound(name, b, rows, cap, dims, k, exact=True):
    """(ms, "operations" or "bytes", unit, f32 FMA ms): the least time the
    card could take for a kernel's work at this case.  Operations:
    2*B*rows*D products and sums over the live rows, on bf16 tensor cores
    for bf16 operands (K2, and K1 with ``exact=False``: one bf16 product
    with f32 sums computes its scores); for K1's f32 operands the lesser of
    f32 FMA and three TF32 passes on the tensor cores (its compensated
    split), named in ``unit``, with the FMA figure returned beside it.
    Bytes: each input read once (the live rows of the arena, bf16 for K2
    and f32 for K1, and their x_sq; the whole valid mask; the f32 queries)
    and the [B, k] results written once."""
    k2 = name == "fused_topk_search_v2"
    flops = 2 * b * rows * dims
    fma_ms = flops / PEAK_F32 * 1e3
    if k2 or not exact:
        ops_ms, unit = flops / PEAK_BF16 * 1e3, "bf16"
    else:
        ops_ms, unit = min((3 * flops / PEAK_TF32 * 1e3, "3 TF32 passes"),
                           (fma_ms, "f32 FMA"))
    nbytes = rows * (dims * (2 if k2 else 4) + 4) + cap + b * dims * 4 + b * k * 8
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", unit, fma_ms
    return bytes_ms, "bytes", "HBM", fma_ms


def f64_error(torch, q, x, x_sq, got, metric, bf16):
    """The largest error of the finite distances in ``got = (d, ids)``
    against a float64 product of the rows named, in the kernel's own
    scoring (operands rounded to bf16 first when ``bf16``)."""
    from embeddinghub_tpu_torch.ops import distance as D

    d, ids = got
    q = q.float()
    if metric == "cosine":
        q = D.normalize(q)
    worst = 0.0
    for s in range(0, q.shape[0], 256):  # [256, k, D] float64 at a time
        i = ids[s:s + 256].clamp(min=0).long()
        rows, qc = x[i], q[s:s + 256]
        if bf16:
            rows, qc = D.round_bf16(rows), D.round_bf16(qc)
        dots = torch.einsum("bkd,bd->bk", rows.double(), qc.double())
        if metric == "l2":
            want = torch.clamp(x_sq[i].double() - 2 * dots
                               + (q[s:s + 256].double() ** 2).sum(1, keepdim=True), min=0)
        else:
            want = 1 - dots
        fin = torch.isfinite(d[s:s + 256]) & (ids[s:s + 256] >= 0)
        if fin.any():
            worst = max(worst, float((d[s:s + 256].double() - want)[fin].abs().max()))
    return worst


def library_product(torch, name, q, x, xb, exact=True):
    """The product alone, as a library would compute it before any top-k:
    bf16 ``q @ xb.T`` with bf16 output for K2, the same with f32 output for
    K1's bf16 operands (``exact=False``), f32 ``q @ x.T`` (TF32 off) for
    K1's f32 operands; one ``torch.mm`` per arena chunk of at most
    LIBRARY_CHUNK_BYTES of output."""
    from embeddinghub_tpu_torch.ops import fused_topk as F

    k2 = name == "fused_topk_search_v2"
    bf16 = k2 or not exact
    lhs = F.arena_bf16(q) if bf16 else q.float()
    rhs = xb if bf16 else x
    kw = {"out_dtype": torch.float32} if bf16 and not k2 else {}
    out_size = 2 if k2 else 4
    chunk = max(F.GROUP, LIBRARY_CHUNK_BYTES // (out_size * lhs.shape[0]))

    def run():
        for s in range(0, rhs.shape[0], chunk):
            torch.mm(lhs, rhs[s:s + chunk].T, **kw)
    return run


def phase_kernels(torch, x_host, report):
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F

    kernels = {
        "fused_topk_search": (F.exact_topk, F.fused_topk_search_reference),
        "fused_topk_search_v2": (F.approx_candidates, F.fused_topk_search_v2_reference),
        "fused_topk_search_large_k": (F.exact_topk_large_k,
                                      F.fused_topk_search_large_k_reference),
    }
    rng = np.random.default_rng(SEED + 1)
    q_all = torch.from_numpy(rng.standard_normal(
        (max(c[2] for c in KERNEL_CASES), DIMS), dtype=np.float32)).cuda()
    # past ROWS (the wave cases' grown arena): more rows of the same draw
    raw = torch.zeros((max(CAP, max(c[5] for c in KERNEL_CASES)), DIMS),
                      dtype=torch.float32, device="cuda")
    raw[:ROWS] = torch.from_numpy(x_host).cuda()
    raw[ROWS:] = torch.from_numpy(rng.standard_normal(
        (raw.shape[0] - ROWS, DIMS), dtype=np.float32)).cuda()
    for metric in ("l2", "cosine"):
        x_full = D.preprocess_vectors(raw, metric)
        xb_full = F.arena_bf16(x_full)
        x_sq_full = D.sqnorms(x_full)
        for name, m, b, k, exact, cap, rows in KERNEL_CASES:
            if m != metric:
                continue
            kernel, plain = kernels[name]
            q = q_all[:b]
            # the first cap rows: contiguous
            x, xb, x_sq = x_full[:cap], xb_full[:cap], x_sq_full[:cap]
            arena = xb if name == "fused_topk_search_v2" else x
            valid = torch.arange(cap, device="cuda") < rows
            args = dict(k=k, metric=metric)
            if exact is not None:
                args["exact"] = exact
            bf16 = exact is not True
            # (tie gap, rtol, atol): f32 operands on both sides differ only
            # in summation order; bf16 operands leave ties 1e-3 wide
            gap, rtol, atol = (1e-3, 1e-3, 1e-3) if bf16 else (1e-4, 1e-5, 1e-4)
            got = kernel(q, arena, valid, x_sq, **args)
            want = plain(q, arena, valid, x_sq, **args)
            torch.cuda.synchronize()
            err, swaps = compare(
                torch, f"{name}/{metric}/B={b}/cap={cap}", got, want,
                lambda ids: scores_of(torch, q, x, x_sq, ids, metric, bf16),
                gap, rtol, atol)
            f64 = ""
            if exact is not None:
                f64 = (f" f64_err={f64_error(torch, q, x, x_sq, got, metric, bf16):.3g}"
                       f" plain_f64_err={f64_error(torch, q, x, x_sq, want, metric, bf16):.3g}")
            ms = device_ms(torch, lambda: kernel(q, arena, valid, x_sq, **args))
            plain_ms = device_ms(torch, lambda: plain(q, arena, valid, x_sq, **args))
            library_ms = device_ms(torch, library_product(torch, name, q, x, xb,
                                                          exact is not False))
            bound_ms, bound_by, unit, fma_ms = bound(name, b, rows, cap, DIMS, k,
                                                     exact is not False)
            tflops = 2 * b * rows * DIMS / (ms * 1e-3) / 1e12
            # exact_topk takes K1's large-k route at some shapes (k1_route)
            via = ("fused_topk_search_large_k" if name == "fused_topk_search"
                   and F.k1_route(k, b, cap, F.k1_tile(b, DIMS, exact)) == "large_k"
                   else name)
            print(f"[kernels] {name} {metric} B={b} cap={cap} rows={rows} k={k}"
                  f"{'' if exact is None else f' exact={exact}'}"
                  f"{'' if via == name else f' via={via}'}: "
                  f"max_abs_err={err:.3g}{f64} tie_swaps={swaps} "
                  f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={bound_ms:.3f} ({bound_by}: {unit}; f32 FMA "
                  f"{fma_ms:.3f}) tflops={tflops:.1f} "
                  f"library_ms={library_ms:.3f}", flush=True)
            worst = report.setdefault(name, {"max_abs_err": 0.0})
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            label = SUMMARY.get((metric, b, k, exact, cap))
            if label is not None:
                report[label] = dict(
                    via=via, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bound_unit=unit, fma_bound_ms=fma_ms,
                    library_ms=library_ms,
                    shape=f"{metric} B={b} k={k} exact={exact} cap={cap} rows={rows}")
        del x_full, xb_full, x_sq_full, x, xb, x_sq, valid
    del raw, q_all
    torch.cuda.empty_cache()


def pool_bound(name, b, rows, cap, dims, k, n_seg):
    """(ms, "operations" or "bytes", unit) of a candidate pool: 2*B*rows*D
    products and sums over the live rows, int8 (1,979 TOPS) or bf16
    tensor cores; the bytes of each input read once (the live rows' plane,
    int8 or bf16, their x_sq and, int8, scales; the valid mask; the f32
    queries) and the [B, segments, k] keys written once."""
    i8 = name == "fused_topk_search_v2_int8"
    ops_ms = 2 * b * rows * dims / (PEAK_INT8 if i8 else PEAK_BF16) * 1e3
    nbytes = (rows * (dims * (1 if i8 else 2) + (8 if i8 else 4)) + cap + b * dims * 4
              + b * n_seg * k * 8)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", "int8" if i8 else "bf16"
    return bytes_ms, "bytes", "HBM"


def library_pool(torch, qf, plane, i8):
    """The pool's product alone as one PyTorch call per arena chunk of at
    most LIBRARY_CHUNK_BYTES of output: torch._int_mm of the int8 queries
    and the hi plane (int32 sums; it takes more than 16 queries), or a bf16
    matmul with bf16 output; None where no such call takes the shape."""
    from embeddinghub_tpu_torch.ops import fused_topk as F

    if i8:
        if qf.shape[0] <= 16:
            return None
        lhs = F.quantize_queries(qf, "cosine")[0][:, :qf.shape[1]].contiguous()
        mm = torch._int_mm
    else:
        lhs, mm = F.arena_bf16(qf), torch.mm
    chunk = max(F.GROUP, LIBRARY_CHUNK_BYTES // (4 * lhs.shape[0]))

    def run():
        for s in range(0, plane.shape[0], chunk):
            mm(lhs, plane[s:s + chunk].T)
    return run


def phase_quant_kernels(torch, x_host, report):
    """Phase 2, K2's candidate pools: the kernel (int8 instantiation, or
    the bf16 scan) against its plain version at QUANT_CASES, on the 1M rows
    of phase 3 and on 10,485,760 x 96 normal rows drawn on the card."""
    from embeddinghub_tpu_torch.index.flat import quantize_planes
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F

    gen = torch.Generator(device=CARD).manual_seed(SEED + 3)
    q_all = D.normalize(torch.randn((max(c[2] for c in QUANT_CASES), DIMS),
                                    generator=gen, device=CARD))
    for cap, dims in sorted({(c[4], c[6]) for c in QUANT_CASES}):
        raw = torch.zeros((cap, dims), device=CARD)  # rows past the data: dead
        if (cap, dims) == (CAP, DIMS):
            raw[:ROWS] = torch.from_numpy(x_host).to(CARD)
        else:
            raw[:max(c[5] for c in QUANT_CASES if c[4] == cap)] = torch.randn(
                (max(c[5] for c in QUANT_CASES if c[4] == cap), dims), generator=gen,
                device=CARD)
        i8p = quantize_planes(raw, "cosine", "int8")
        xb = F.arena_bf16(D.normalize(raw))
        del raw
        for name, metric, b, k, c_cap, rows, c_dims, seg in QUANT_CASES:
            if (c_cap, c_dims) != (cap, dims):
                continue
            i8 = name == "fused_topk_search_v2_int8"
            plane = i8p["hi"] if i8 else xb
            args = (D.normalize(q_all[:b, :dims]), plane,
                    torch.arange(cap, device=CARD) < rows, i8p["sq"], i8p["sc"] if i8 else None)
            kw = dict(k=k, metric=metric, seg=seg)
            got = F.pool_candidates(*args, **kw, rows=rows)
            want = F.pool_candidates_reference(*args, **kw)
            torch.cuda.synchronize()
            err, swaps = check_pool(torch, f"{name} B={b} cap={cap} rows={rows} k={k}", args,
                                    metric, seg, got, want, i8)
            ms = device_ms(torch, lambda: F.pool_candidates(*args, **kw, rows=rows))
            plain_ms = device_ms(torch, lambda: F.pool_candidates_reference(*args, **kw))
            lib = library_pool(torch, args[0], plane[:rows], i8)
            library_ms = None if lib is None else device_ms(torch, lib)
            n_seg = got[0].shape[1]
            bound_ms, bound_by, unit = pool_bound(name, b, rows, cap, dims, k, n_seg)
            tops = 2 * b * rows * dims / (ms * 1e-3) / 1e12
            print(f"[kernels] {name} pool {metric} B={b} cap={cap} rows={rows} D={dims} "
                  f"k={k} segment={seg or cap} ({n_seg} segments): max_abs_err={err:.3g} "
                  f"tie_swaps={swaps} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={bound_ms:.3f} ({bound_by}: {unit}) tops={tops:.1f} "
                  f"library_ms={'null' if library_ms is None else f'{library_ms:.3f}'}",
                  flush=True)
            worst = report.setdefault(name, {"max_abs_err": 0.0})
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            label = QUANT_SUMMARY.get((name, b, k, cap, seg))
            if label is not None:
                report[(name, label[0])] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bound_unit=unit, fma_bound_ms=None,
                    library_ms=library_ms, replaces=label[1],
                    shape=f"{metric} B={b} k={k} cap={cap} rows={rows} D={dims} "
                          f"segment={seg or cap}")
        del i8p, xb, plane, args, got, want
        torch.cuda.empty_cache()


def check_pool(torch, label, args, metric, seg, got, want, i8):
    """K2's pool (scores, ids ``[B, segments, k]``) against its plain
    version on the same inputs.  The sorted scores agree: exactly for int8
    (exact integer sums, the plain version's order of operations), within
    1e-3 for bf16 (f32 sums in another order).  Every pooled id is a live
    row of its own segment, no bin gives two, and wherever an id differs
    from the plain version's, the plain formula scores that row as the
    plain version scored its slot (int8: exactly; bf16: within 1e-3): ids
    differ only between tied scores.  Returns the largest score error and
    the count of differing ids."""
    qf, plane, valid, x_sq, scales = args
    (s, i), (rs, ri) = got, want
    fin = torch.isfinite(rs)
    check(torch.equal(fin, torch.isfinite(s)) and torch.equal(fin, i >= 0),
          f"{label}: finite slots")
    tol = 0.0 if i8 else 1e-3 * max(1.0, float(rs[fin].abs().max()) if fin.any() else 1.0)
    err = float((s[fin] - rs[fin]).abs().max()) if fin.any() else 0.0
    check(err <= tol, f"{label}: scores differ by {err}")
    ids = i.long()
    check(bool(valid[ids[fin]].all()), f"{label}: a dead row was pooled")
    seg_of = torch.arange(s.shape[1], device=ids.device)[None, :, None]
    check(bool(((ids // (seg or plane.shape[0]) == seg_of) | ~fin).all()),
          f"{label}: a row pooled in another segment")
    bins = torch.where(fin, (ids // 128) * 4 + (ids % 8) // 2, -1).sort(dim=2).values
    check(not bool(((bins[..., 1:] == bins[..., :-1]) & (bins[..., 1:] >= 0)).any()),
          f"{label}: a bin pooled twice")
    swapped = (i != ri) & fin
    if swapped.any():
        qb = swapped.nonzero()[:, 0]
        rows = ids[swapped]
        dims = qf.shape[1]
        bias = x_sq[rows] if metric == "l2" else torch.zeros_like(x_sq[rows])
        if i8:
            from embeddinghub_tpu_torch.ops.fused_topk import quantize_queries
            qq, qs = quantize_queries(qf, metric)
            acc = (qq[qb, :dims].float() * plane[rows, :dims].float()).sum(1)
            score = bias - (qs[qb] * scales[rows]) * acc
        else:
            dots = (qf[qb].bfloat16().float() * plane[rows, :dims].float()).sum(1)
            score = bias - 2.0 * dots if metric == "l2" else bias - dots
        off = float((score - rs[swapped]).abs().max())
        check(off <= tol, f"{label}: {int(swapped.sum())} ids differ, one scores "
                          f"{off:.3g} away from the plain version's slot")
    return err, int(swapped.sum())


def exact_oracle(torch, x_dev, queries, k, chunk=1 << 17, dead=(), unit_rows=False):
    """Exact cosine top-k on the card, in chunks, independent of the port:
    f32 products (TF32 is off for the whole script).  Rows in ``dead`` are
    left out.  ``unit_rows``: the rows are scored as they are (already
    normalized, or rounded from normalized rows), not normalized here."""
    qn = queries / queries.norm(dim=1, keepdim=True).clamp(min=1e-30)
    best_d = best_i = None
    for s in range(0, x_dev.shape[0], chunk):
        xs = x_dev[s:s + chunk]
        if not unit_rows:
            xs = xs / xs.norm(dim=1, keepdim=True).clamp(min=1e-30)
        d = 1 - qn @ xs.T
        for r in dead:
            if s <= r < s + xs.shape[0]:
                d[:, r - s] = float("inf")
        cd, ci = torch.topk(d, k, dim=1, largest=False)
        ci = ci + s
        if best_d is None:
            best_d, best_i = cd, ci
        else:
            best_d, pos = torch.topk(torch.cat([best_d, cd], 1), k, dim=1, largest=False)
            best_i = torch.gather(torch.cat([best_i, ci], 1), 1, pos)
    return best_d, best_i


def check_exact(i_ex, d_ex, od, oi, queries, x_host, what) -> int:
    """Exact-search ids and cosine distances against the oracle's: where
    the ids differ, the port's row must lie within 1e-4 of the oracle's
    distance at that position (a tie).  Returns the number of swaps."""
    oi_host, od_host = oi.cpu().numpy(), od.cpu().numpy()
    swaps = i_ex != oi_host
    if swaps.any():
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        xr = x_host[i_ex[swaps]]
        xr = xr / np.linalg.norm(xr, axis=1, keepdims=True)
        rq = np.nonzero(swaps)[0]
        true_d = 1 - np.einsum("nd,nd->n", xr, qn[rq])
        check(np.abs(true_d - od_host[swaps]).max() <= 1e-4,
              f"{what}: ids differ from the oracle beyond ties")
    check(np.allclose(d_ex, od_host, rtol=1e-5, atol=1e-4), f"{what}: distances")
    return int(swaps.sum())


def phase_main(torch, x_host, launches):
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    rng = np.random.default_rng(SEED + 2)
    queries = rng.standard_normal((MAIN_B, DIMS), dtype=np.float32)
    hub = EmbeddingHub.in_memory(device="cuda")
    version = hub.create_space("smoke", DIMS, "cosine").default_version()
    keys = [f"k{j}" for j in range(ROWS)]
    t0 = time.perf_counter()
    for s in range(0, ROWS, FLUSH):
        version.multiset(zip(keys[s:s + FLUSH], x_host[s:s + FLUSH]))
    ingest_s = time.perf_counter() - t0
    check(version.size == ROWS and version.index.capacity == CAP,
          f"size {version.size} cap {version.index.capacity}")
    print(f"[main] multiset {ROWS} rows in {FLUSH}-row batches: {ingest_s:.2f} s "
          f"({ROWS / ingest_s:.0f} rows/s)", flush=True)

    before = dict(launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = version.nearest_batch(queries, MAIN_K)
    first_s = time.perf_counter() - t0
    check(launches["fused_topk_search_v2"] > before["fused_topk_search_v2"],
          "auto search did not launch K2")
    check(launches["fused_topk_search"] == before["fused_topk_search"],
          "auto search launched K1")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = version.nearest_batch(queries, MAIN_K)
        times.append(time.perf_counter() - t0)
    check(again == got, "repeated nearest_batch differs")
    steady = statistics.median(times)
    print(f"[main] nearest_batch B={MAIN_B} k={MAIN_K} auto: first call (with "
          f"full sync) {first_s * 1e3:.1f} ms; steady median of 3 "
          f"{steady * 1e3:.1f} ms = {MAIN_B / steady:.0f} queries/s", flush=True)

    x_dev = torch.from_numpy(x_host).cuda()
    q_dev = torch.from_numpy(queries).cuda()
    od, oi = exact_oracle(torch, x_dev, q_dev, MAIN_K)
    oi_host = oi.cpu().numpy()
    check(all(len(r) == MAIN_K for r in got), "short result rows")
    hits = sum(len({int(k[1:]) for k in r} & set(o)) for r, o in zip(got, oi_host))
    recall = hits / (MAIN_B * MAIN_K)
    print(f"[main] recall@{MAIN_K} auto vs exact oracle: {recall:.5f}", flush=True)
    check(recall >= 0.995, f"recall@10 {recall} < 0.995")

    before = dict(launches)
    t0 = time.perf_counter()
    d_ex, i_ex = version.index.search(queries, MAIN_K, mode="exact")
    exact_s = time.perf_counter() - t0
    check(launches["fused_topk_search"] > before["fused_topk_search"],
          "exact search did not launch K1")
    check(launches["fused_topk_search_v2"] == before["fused_topk_search_v2"],
          "exact search launched K2")
    swaps = check_exact(i_ex, d_ex, od, oi, queries, x_host, "exact search")
    print(f"[main] exact search B={MAIN_B}: {exact_s * 1e3:.1f} ms "
          f"({MAIN_B / exact_s:.0f} queries/s), {swaps} tie swaps "
          f"vs oracle", flush=True)

    near = version.nearest(MAIN_K, key="k123")
    check(len(near) == MAIN_K and "k123" not in near, f"keyed nearest {near}")
    version.delete("k123")
    back = version.nearest_batch(x_host[123:124], MAIN_K)[0]
    check("k123" not in back and "k123" not in version, "deleted key came back")
    print("[main] keyed nearest excludes self; deleted key never comes back",
          flush=True)
    del x_dev, q_dev, hub, version
    torch.cuda.empty_cache()


def phase_wire(torch, x_host):
    import grpc

    from embeddinghub_tpu_torch.service.server import build_server, pb, pb_grpc

    server, service, port = build_server("127.0.0.1:0", "cuda")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = pb_grpc.EmbeddingHubStub(channel)
        stub.CreateSpace(pb.CreateSpaceRequest(name="wire", dims=DIMS))
        rows = x_host[:WIRE_ROWS]

        def requests():
            for j in range(WIRE_ROWS):
                req = pb.MultiSetRequest(space="wire", key=f"w{j}")
                req.embedding.values[:] = rows[j].tolist()
                yield req

        t0 = time.perf_counter()
        stub.MultiSet(requests())
        print(f"[wire] MultiSet {WIRE_ROWS} rows: {time.perf_counter() - t0:.2f} s",
              flush=True)
        version = service._store.get_version("wire")
        check(version.size == WIRE_ROWS, f"wire size {version.size}")

        rng = np.random.default_rng(SEED + 3)
        queries = rng.standard_normal((WIRE_B, DIMS), dtype=np.float32)
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(
            space="wire", embedding=pb.Embedding(values=queries[0].tolist()), num=10))
        check(list(resp.keys) == version.nearest(10, vector=queries[0]),
              "NearestNeighbor by embedding differs from the store")
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(space="wire", key="w5", num=10))
        check(list(resp.keys) == version.nearest(10, key="w5") and "w5" not in resp.keys,
              "NearestNeighbor by key differs from the store")
        # num=1500 fetches 2048: K1's large-k route
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(
            space="wire", embedding=pb.Embedding(values=queries[1].tolist()), num=BIG_NUM))
        check(len(resp.keys) == BIG_NUM
              and list(resp.keys) == version.nearest(BIG_NUM, vector=queries[1]),
              f"NearestNeighbor num={BIG_NUM} differs from the store")
        req = pb.BatchNearestNeighborRequest(space="wire", num=10)
        for qv in queries:
            req.embeddings.add().values[:] = qv.tolist()
        t0 = time.perf_counter()
        resp = stub.BatchNearestNeighbor(req)
        batch_s = time.perf_counter() - t0
        check([list(r.keys) for r in resp.results] == version.nearest_batch(queries, 10),
              "BatchNearestNeighbor differs from the store")
        print(f"[wire] BatchNearestNeighbor B={WIRE_B} k=10: {batch_s * 1e3:.1f} ms "
              f"round trip", flush=True)
        got = stub.Get(pb.GetRequest(space="wire", key="w7"))
        check(np.array_equal(np.asarray(got.embedding.values, np.float32), rows[7]),
              "Get differs")

        stub.FreezeSpace(pb.FreezeSpaceRequest(name="wire"))
        for what, call, code in (
            ("Set after FreezeSpace",
             lambda: stub.Set(pb.SetRequest(space="wire", key="new",
                                            embedding=pb.Embedding(values=rows[0].tolist()))),
             grpc.StatusCode.FAILED_PRECONDITION),
            ("NearestNeighbor with key and embedding",
             lambda: stub.NearestNeighbor(pb.NearestNeighborRequest(
                 space="wire", key="w1", embedding=pb.Embedding(values=rows[1].tolist()),
                 num=3)),
             grpc.StatusCode.INVALID_ARGUMENT),
        ):
            try:
                call()
            except grpc.RpcError as e:
                check(e.code() == code, f"{what}: {e.code()} != {code}")
            else:
                raise RuntimeError(f"check failed: {what} succeeded")
        print("[wire] answers equal the in-process store's; FAILED_PRECONDITION "
              "and INVALID_ARGUMENT as expected", flush=True)
    finally:
        channel.close()
        server.stop(0).wait()
        service.stop()


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def phase_restore(torch, x_host, launches):
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    rng = np.random.default_rng(SEED + 4)
    queries = rng.standard_normal((MAIN_B, DIMS), dtype=np.float32)
    keys = [f"k{j}" for j in range(ROWS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_restore_") as tmp:
        base = Path(tmp) / "store"
        vdir = base / "restore" / "initial"
        hub = EmbeddingHub.load_or_create(base, device="cuda")
        version = hub.create_space("restore", DIMS, "cosine").default_version()
        t0 = time.perf_counter()
        for s in range(0, ROWS, FLUSH):
            version.multiset(zip(keys[s:s + FLUSH], x_host[s:s + FLUSH]))
        ingest_s = time.perf_counter() - t0
        print(f"[restore] multiset {ROWS} rows in {FLUSH}-row batches, WAL on: "
              f"{ingest_s:.2f} s ({ROWS / ingest_s:.0f} rows/s); WAL "
              f"{(vdir / 'wal.bin').stat().st_size} bytes", flush=True)
        version.delete("k123")
        want = version.nearest_batch(queries, MAIN_K)
        check(all(len(r) == MAIN_K and "k123" not in r for r in want),
              "nearest_batch before the restart")
        del hub, version  # dropped unsaved: the WAL is all that is left
        gc.collect()
        torch.cuda.empty_cache()

        def reopen(what):
            t0 = time.perf_counter()
            hub = EmbeddingHub.load_or_create(base, device="cuda")
            reopen_s = time.perf_counter() - t0
            version = hub.get_version("restore")
            check(version is not None and version.size == ROWS - 1
                  and "k123" not in version, f"{what}: store after reopen")
            before = launches["fused_topk_search_v2"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = version.nearest_batch(queries, MAIN_K)
            first_s = time.perf_counter() - t0
            check(got == want, f"{what}: nearest_batch differs from before the restart")
            check(launches["fused_topk_search_v2"] > before, f"{what}: K2 not launched")
            print(f"[restore] reopen from {what}: {reopen_s:.2f} s; first "
                  f"nearest_batch B={MAIN_B} (with the full upload) "
                  f"{first_s * 1e3:.1f} ms; lists equal to before the restart",
                  flush=True)
            return hub, version

        hub, version = reopen("the WAL alone")
        t0 = time.perf_counter()
        hub.save()
        save_s = time.perf_counter() - t0
        snap = next(vdir.glob("index-*"))
        print(f"[restore] save: {save_s:.2f} s; snapshot {dir_bytes(snap)} bytes "
              f"+ meta.json {(vdir / 'meta.json').stat().st_size} bytes; WAL "
              f"{(vdir / 'wal.bin').stat().st_size} bytes after", flush=True)
        del hub, version
        gc.collect()
        torch.cuda.empty_cache()
        hub, version = reopen("the snapshot")

        x_dev = torch.from_numpy(x_host[:ROWS]).cuda()
        for k, b, engine in ((MAIN_K, MAIN_B, "fused_topk_search"),
                             (BIG_K, BIG_B, "fused_topk_search_large_k")):
            before = launches[engine]
            t0 = time.perf_counter()
            d_ex, i_ex = version.index.search(queries[:b], k, mode="exact")
            exact_s = time.perf_counter() - t0
            check(launches[engine] > before, f"exact k={k} did not run {engine}")
            od, oi = exact_oracle(torch, x_dev, torch.from_numpy(queries[:b]).cuda(),
                                  k, dead=(123,))
            swaps = check_exact(i_ex, d_ex, od, oi, queries[:b], x_host,
                                f"restored exact k={k}")
            print(f"[restore] exact search B={b} k={k} ({engine}): "
                  f"{exact_s * 1e3:.1f} ms, {swaps} tie swaps vs oracle", flush=True)
        del x_dev, hub, version
        gc.collect()
        torch.cuda.empty_cache()


def phase_crash(torch, x_host):
    """Returns the kernel launches of the restarted server's process."""
    from concurrent.futures import TimeoutError as FutureTimeout

    import grpc

    from embeddinghub_tpu_torch.sdk.client import EmbeddingHubClient
    from embeddinghub_tpu_torch.service.spawn import ServerProcess

    rows = x_host[:CRASH_ROWS]
    keys = [f"c{j}" for j in range(CRASH_ROWS)]
    bounds = dict(device="cuda", start_timeout=SERVER_START_S, wait_timeout=WAIT_S)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_crash_") as tmp:
        data_dir = Path(tmp) / "store"
        t0 = time.perf_counter()
        server = ServerProcess(data_dir, **bounds)
        print(f"[crash] server subprocess up in {time.perf_counter() - t0:.1f} s",
              flush=True)
        try:
            c = EmbeddingHubClient(host="127.0.0.1", port=server.port)
            c.create_space("crash", DIMS)
            t0 = time.perf_counter()
            c.multiset("crash", ((keys[j], rows[j].tolist()) for j in range(CRASH_ROWS)))
            ingest_s = time.perf_counter() - t0
            futures = [c.set("crash", f"u{j}", x_host[CRASH_ROWS + j].tolist(), wait=False)
                       for j in range(CRASH_UNACKED)]
            os.kill(server.proc.pid, signal.SIGKILL)
            server.proc.wait(timeout=WAIT_S)
            lost = 0
            for f in futures:
                try:
                    f.result(timeout=WAIT_S)
                except (grpc.RpcError, FutureTimeout):
                    lost += 1
            c.close()
            print(f"[crash] MultiSet {CRASH_ROWS} acknowledged rows: {ingest_s:.2f} s "
                  f"({CRASH_ROWS / ingest_s:.0f} rows/s); SIGKILL with "
                  f"{CRASH_UNACKED} set(wait=False) sent, {lost} of them failed",
                  flush=True)
        finally:
            server.kill()

        t0 = time.perf_counter()
        server = ServerProcess(data_dir, port=server.port, **bounds)
        restart_s = time.perf_counter() - t0
        try:
            c = EmbeddingHubClient(host="127.0.0.1", port=server.port)
            got = np.asarray(list(c.multiget("crash", keys)), dtype=np.float32)
            check(np.array_equal(got, rows), "acknowledged rows not bit-exact after restart")
            n = sum(1 for _ in c.download("crash"))
            check(n >= CRASH_ROWS, f"download holds {n} < {CRASH_ROWS} rows")
            near = list(c.nearest_neighbor("crash", MAIN_K, key="c5"))
            check(len(near) == MAIN_K and "c5" not in near, f"keyed nearest {near}")
            c.close()
            launches = server.stop()
        finally:
            server.kill()
    print(f"[crash] restart on the same directory: {restart_s:.1f} s to listening; "
          f"all {CRASH_ROWS} acknowledged rows bit-exact, download {n} rows, "
          f"keyed nearest excludes the key", flush=True)
    return launches


def phase_offline(torch, x_host):
    from embeddinghub_tpu_torch.sdk.offline import Index
    from embeddinghub_tpu_torch.store.version import Version

    rows = x_host[:OFFLINE_ROWS]
    keys = [f"o{j}" for j in range(OFFLINE_ROWS)]
    queries = np.random.default_rng(SEED + 5).standard_normal((OFFLINE_B, DIMS),
                                                              dtype=np.float32)
    t0 = time.perf_counter()
    index = Index(zip(keys, rows), DIMS, metric="cosine", device="cuda")
    build_s = time.perf_counter() - t0
    got = index.nearest_neighbor_batch(MAIN_K, queries)
    version = Version("offline", "initial", DIMS, "cosine", device="cuda")
    version.multiset(zip(keys, rows))
    check(got == version.nearest_batch(queries, MAIN_K),
          "offline Index differs from a Version over the same rows")
    check(index.nearest_neighbor(MAIN_K, key="o5") == version.nearest(MAIN_K, key="o5"),
          "offline keyed nearest_neighbor differs")
    x_dev = torch.from_numpy(rows).cuda()
    _, oi = exact_oracle(torch, x_dev, torch.from_numpy(queries).cuda(), MAIN_K)
    hits = sum(len({int(k[1:]) for k in r} & set(o)) for r, o in zip(got, oi.cpu().numpy()))
    recall = hits / (OFFLINE_B * MAIN_K)
    check(recall >= OFFLINE_RECALL, f"offline recall@{MAIN_K} {recall} < {OFFLINE_RECALL}")
    print(f"[offline] Index over {OFFLINE_ROWS} rows on cuda: built in {build_s:.2f} s; "
          f"nearest_neighbor_batch B={OFFLINE_B} and keyed nearest_neighbor equal "
          f"a Version's; recall@{MAIN_K} vs exact oracle {recall:.5f}", flush=True)
    del index, version, x_dev
    torch.cuda.empty_cache()


def sift_desc(count: int, r):
    """``count`` SIFT-descriptor-statistics rows of 128 integer-valued f32
    from generator ``r``: a numpy copy of ``sample_desc`` in
    benchmarks/cluster_build.py:40-76, which imports the JAX package's
    benchmarks."""
    base_ori = r.uniform(0, 8, size=(count, 1, 1))
    drift = r.normal(0, 1.2, size=(count, 4, 4)).cumsum(2)
    ori = (base_ori + drift) % 8
    bins = np.arange(8)[None, None, None, :]
    ang = np.minimum(np.abs(bins - ori[..., None]), 8 - np.abs(bins - ori[..., None]))
    resp = np.exp(-(ang ** 2) / (2 * 1.1 ** 2))
    energy = r.gamma(2.0, 1.0, size=(count, 4, 4, 1))
    noise = r.gamma(1.0, 0.25, size=(count, 4, 4, 8))
    d = (resp * energy + noise).reshape(count, 128)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
    d = np.minimum(d, 0.2)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
    return np.floor(512.0 * d).astype(np.float32)


def sift_rows(n: int, seed: int) -> np.ndarray:
    """``n`` rows of :func:`sift_desc` from rng ``seed``, drawn chunk by chunk
    as ``sift_desc_chunked`` draws them."""
    chunk = 1 << 18
    rng = np.random.default_rng(seed)
    out = np.empty((n, DIMS), np.float32)
    for done in range(0, n, chunk):
        out[done:done + chunk] = sift_desc(min(chunk, n - done), rng)
    return out


def sift_proxy(n: int, nq: int, dims: int):
    """SIFT-proxy rows ``[n, dims]`` (rng seed 0) and queries ``[nq, dims]``
    (rng seed 1), as benchmarks/cluster_build.py draws them."""
    return sift_rows(n, 0), sift_desc(nq, np.random.default_rng(1))


def graph_walk(torch, index, test, oracle, ef, what, tag="graph"):
    """Recall@10 of ``index.search`` at ``ef`` against ``oracle`` rows,
    device ms per batch (CUDA events, median of 5 after 2 warm-ups) and
    the beam's hops."""
    _, ids = index.search(test, GRAPH_K, ef=ef)
    recall = np.mean([len(set(a) & set(b)) / GRAPH_K for a, b in zip(ids, oracle)])
    ms = device_ms(torch, lambda: index.search(test, GRAPH_K, ef=ef))
    hops = index.last_hops
    print(f"[{tag}] search {what} B={len(test)} k={GRAPH_K} ef={ef}: "
          f"recall@{GRAPH_K} {recall:.4f}; {ms:.3f} ms per batch, "
          f"{hops} hops, {ms / hops:.3f} ms per hop", flush=True)
    return recall


def phase_graph(torch, launches, base):
    """Phase 8.  Returns what phase 9 writes into: the reopened store (behind
    the gRPC server), the rows and the queries."""
    from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub
    from embeddinghub_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    train, test = sift_proxy(ROWS, GRAPH_QUERIES, DIMS)
    print(f"[graph] SIFT proxy {ROWS} x {DIMS} and {GRAPH_QUERIES} queries: "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    keys = [f"g{j}" for j in range(ROWS)]
    config = Config(engine="hnsw", hnsw_m=GRAPH_M, hnsw_ef_construction=GRAPH_EFC)
    hub = EmbeddingHub.load_or_create(base, engine="hnsw", device=CARD)
    version = hub.create_space("graph", DIMS, "l2").default_version()
    index = version.index
    check(isinstance(index, HNSWIndex) and (index.m, index.ef_construction)
          == (GRAPH_M, GRAPH_EFC), "engine=hnsw did not give an M=16 efC=200 graph")
    before = launches["fused_topk_search"]
    t0 = time.perf_counter()
    version.multiset(zip(keys, train))
    ingest_s = time.perf_counter() - t0
    built = launches["fused_topk_search"] - before
    check(built > 0, "the bulk build did not launch K1")
    parts = ", ".join(f"{k} {v:.2f}" for k, v in index.build_seconds.items())
    print(f"[graph] multiset {ROWS} rows, WAL on, one exact bulk build: "
          f"{ingest_s:.2f} s; build {sum(index.build_seconds.values()):.2f} s "
          f"({parts}); K1 launched {built} times; levels up to "
          f"{index._max_level}", flush=True)

    x_dev = torch.from_numpy(train).to(CARD)
    q_dev = torch.from_numpy(test).to(CARD)
    valid = torch.ones(ROWS, dtype=torch.bool, device=CARD)
    _, oracle = F.exact_topk(q_dev, x_dev, valid, D.sqnorms(x_dev), k=GRAPH_K,
                             metric="l2", exact=True)
    oracle = oracle.cpu().numpy()
    del x_dev, q_dev, valid

    recalls = {ef: graph_walk(torch, index, test, oracle, ef, "bf16 walk")
               for ef in GRAPH_EFS}
    check(recalls[100] >= GRAPH_RECALL,
          f"recall@10 at ef=100 {recalls[100]} < {GRAPH_RECALL}")
    t0 = time.perf_counter()
    index.pack_walk()
    torch.cuda.synchronize()
    print(f"[graph] pack_walk: {time.perf_counter() - t0:.2f} s", flush=True)
    graph_walk(torch, index, test, oracle, 100, "packed walk")
    index.walk_packed = False

    want = version.nearest_batch(test, GRAPH_K)
    singles = [version.nearest(GRAPH_K, vector=test[j]) for j in range(8)]
    t0 = time.perf_counter()
    hub.save()
    save_s = time.perf_counter() - t0
    del hub, version, index
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[graph] save: {save_s:.2f} s; snapshot "
          f"{dir_bytes(base / 'graph' / 'initial')} bytes", flush=True)
    ctx = {"train": train, "test": test, "base": base, "wire": None}
    import grpc

    from embeddinghub_tpu_torch.service.server import build_server, pb, pb_grpc

    t0 = time.perf_counter()
    server, service, port = build_server("127.0.0.1:0", CARD, data_dir=str(base),
                                         config=config)
    reopen_s = time.perf_counter() - t0
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    ctx["hub"], ctx["wire"] = service._store, (server, service, channel)
    version = service._store.get_version("graph")
    check(isinstance(version.index, HNSWIndex) and version.size == ROWS,
          "the reopened store holds no 1M-row graph")
    check(version.nearest_batch(test, GRAPH_K) == want,
          "nearest_batch after the reopen differs")
    stub = pb_grpc.EmbeddingHubStub(channel)
    req = pb.BatchNearestNeighborRequest(space="graph", num=GRAPH_K)
    for qv in test:
        req.embeddings.add().values[:] = qv.tolist()
    resp = stub.BatchNearestNeighbor(req)
    check([list(r.keys) for r in resp.results] == want,
          "BatchNearestNeighbor differs from the store before the save")
    for j, keys_j in enumerate(singles):
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(
            space="graph", embedding=pb.Embedding(values=test[j].tolist()),
            num=GRAPH_K))
        check(list(resp.keys) == keys_j,
              "NearestNeighbor differs from the store before the save")
    print(f"[graph] reopened from the snapshot in process ({reopen_s:.2f} s): "
          f"nearest_batch, BatchNearestNeighbor (B={GRAPH_QUERIES}) and "
          f"NearestNeighbor (8 queries) equal the lists before the save",
          flush=True)
    return ctx


def close_graph(torch, ctx) -> None:
    """Stops phase 8's server, if it runs, and drops its store."""
    if ctx.get("wire"):
        server, service, channel = ctx["wire"]
        channel.close()
        server.stop(0).wait()
        service.stop()
    ctx.pop("wire", None)
    ctx.pop("hub", None)
    gc.collect()
    torch.cuda.empty_cache()


class Rows:
    """What phase 9 has written: every key, its vector and whether it is
    live, for the oracle over the live rows and the reopen's checks."""

    def __init__(self, keys, vecs):
        self.keys, self.vecs = list(keys), [vecs]
        self.live = dict.fromkeys(self.keys, True)
        self.at = {k: j for j, k in enumerate(self.keys)}

    def add(self, keys, vecs):
        for k in keys:
            self.at[k] = len(self.keys)
            self.keys.append(k)
            self.live[k] = True
        self.vecs.append(vecs)

    def matrix(self):
        if len(self.vecs) > 1:
            self.vecs = [np.concatenate(self.vecs)]
        return self.vecs[0]

    def vector(self, key):
        return self.matrix()[self.at[key]]

    def oracle(self, torch, version, queries, k=GRAPH_K):
        """Exact top-k rows of the version over its live keys, from K1 with
        f32 operands on an arena built from what was written."""
        from embeddinghub_tpu_torch.ops import distance as D
        from embeddinghub_tpu_torch.ops import fused_topk as F

        live = [key for key, ok in self.live.items() if ok]
        rows = np.fromiter((version.keymap.row(key) for key in live), np.int64, len(live))
        x = torch.zeros((int(rows.max()) + 1, DIMS), dtype=torch.float32, device=CARD)
        x[torch.from_numpy(rows).to(CARD)] = torch.from_numpy(
            self.matrix()[[self.at[key] for key in live]]).to(CARD)
        valid = torch.zeros(x.shape[0], dtype=torch.bool, device=CARD)
        valid[torch.from_numpy(rows).to(CARD)] = True
        _, ids = F.exact_topk(torch.from_numpy(queries).to(CARD), x, valid,
                              D.sqnorms(x), k=k, metric="l2", exact=True)
        return ids.cpu().numpy()


def phase_writes(torch, launches, ctx):
    """Phase 9: writes into the reopened 1M-row graph of phase 8."""
    from embeddinghub_tpu_torch.index.hnsw import WAVE_SECONDS
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    test = ctx["test"]
    version = ctx["hub"].get_version("graph")
    index = version.index
    t_phase = t0 = time.perf_counter()
    new = sift_rows(WAVE_ROWS + WIRE_WAVE_ROWS + FLUSH, 2)
    new_keys = [f"w{j}" for j in range(len(new))]
    print(f"[writes] {len(new)} new SIFT-proxy rows (rng seed 2): "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    rows = Rows((f"g{j}" for j in range(ROWS)), ctx["train"])

    # 1. in process: one wave a multiset
    per_wave, parts, special = [], dict.fromkeys(WAVE_SECONDS, 0.0), []
    k1 = launches["fused_topk_search"]
    waves0 = index.waves
    t_all = time.perf_counter()
    for b in range(WAVE_ROWS // FLUSH):
        s = b * FLUSH
        cap0, fresh = index._cap, index._device_state is None
        t0 = time.perf_counter()
        version.multiset(zip(new_keys[s:s + FLUSH], new[s:s + FLUSH]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        seconds = dict(index.wave_seconds)
        if fresh or index._cap != cap0:
            special.append((b, dt, seconds, cap0, index._cap, fresh))
        else:
            per_wave.append(dt)
            for key, v in seconds.items():
                parts[key] += v
    in_s = time.perf_counter() - t_all
    rows.add(new_keys[:WAVE_ROWS], new[:WAVE_ROWS])
    k1_waves = launches["fused_topk_search"] - k1
    check(index.waves - waves0 == WAVE_ROWS // FLUSH, "a multiset was not one wave")
    check(k1_waves > 0, "the waves did not launch K1")
    check(version.size == ROWS + WAVE_ROWS and index._cap == 2 * CAP,
          f"size {version.size} capacity {index._cap}")
    n = len(per_wave)
    print(f"[writes] {WAVE_ROWS // FLUSH} multisets of {FLUSH} rows in process "
          f"(one wave each): {in_s:.2f} s, {WAVE_ROWS / in_s:.0f} rows/s; K1 "
          f"launched {k1_waves} times; median {statistics.median(per_wave) * 1e3:.1f} "
          f"ms a multiset over the {n} waves without a rebuild", flush=True)
    print(f"[writes] wave parts, mean ms a wave over those {n}: " + ", ".join(
        f"{key} {v / n * 1e3:.2f}" for key, v in parts.items())
        + f"; store (keys, WAL) "
        f"{(sum(per_wave) - sum(parts.values())) / n * 1e3:.2f}", flush=True)
    for b, dt, seconds, cap0, cap1, fresh in special:
        what = ("the first wave after the reopen: the device state built whole"
                if fresh else f"the capacity growth {cap0} -> {cap1}: the device "
                "state rebuilt whole")
        print(f"[writes] multiset {b + 1}, {what}: {dt * 1e3:.1f} ms, of which "
              f"rebuild {seconds['rebuild'] * 1e3:.1f} ms, pool0 "
              f"{seconds['pool0'] * 1e3:.1f} ms", flush=True)

    # 2. over the wire: 5 flushes, 5 waves
    s = WAVE_ROWS
    wire_keys = new_keys[s:s + WIRE_WAVE_ROWS]
    from embeddinghub_tpu_torch.service.server import pb, pb_grpc

    stub = pb_grpc.EmbeddingHubStub(ctx["wire"][2])

    def requests():
        for j in range(WIRE_WAVE_ROWS):
            req = pb.MultiSetRequest(space="graph", key=wire_keys[j])
            req.embedding.values[:] = new[s + j].tolist()
            yield req

    waves0 = index.waves
    t0 = time.perf_counter()
    stub.MultiSet(requests())
    wire_s = time.perf_counter() - t0
    check(index.waves - waves0 == WIRE_WAVE_ROWS // FLUSH,
          f"wire MultiSet made {index.waves - waves0} waves")
    print(f"[writes] raw-stub MultiSet of {WIRE_WAVE_ROWS} rows "
          f"({WIRE_WAVE_ROWS // FLUSH} flushes, one wave each): {wire_s:.2f} s, "
          f"{WIRE_WAVE_ROWS / wire_s:.0f} rows/s", flush=True)
    rows.add(wire_keys, new[s:s + WIRE_WAVE_ROWS])
    check(version.size == ROWS + WAVE_ROWS + WIRE_WAVE_ROWS, f"size {version.size}")
    # the last wave pooled layer 1 over the members of the rows before it
    upper = int(np.count_nonzero(index._levels[:WAVE_HI] >= 1))
    check(upper == WAVE_UPPER, f"layer-1 members at the last wave: {upper}")

    # 3. recall against an exact oracle over every live row; new rows
    # find themselves
    oracle = rows.oracle(torch, version, test)
    recalls = {ef: graph_walk(torch, index, test, oracle, ef, "after the inserts",
                              "writes") for ef in GRAPH_EFS}
    check(recalls[100] >= GRAPH_RECALL,
          f"recall@10 at ef=100 after the inserts {recalls[100]} < {GRAPH_RECALL}")
    pick = np.linspace(0, WAVE_ROWS + WIRE_WAVE_ROWS - 1, SELF_QUERIES).astype(np.int64)
    want_rows = np.asarray([version.keymap.row(new_keys[j]) for j in pick])
    _, ids = index.search(new[pick], GRAPH_K, ef=100)
    self_rate = float(np.mean([r in got for r, got in zip(want_rows, ids)]))
    print(f"[writes] self-check: {SELF_QUERIES} inserted rows queried by their own "
          f"vectors at ef=100 find themselves in their top {GRAPH_K}: {self_rate:.4f}",
          flush=True)
    check(self_rate >= SELF_RATE, f"self-check {self_rate} < {SELF_RATE}")

    # 4. deletes: half old rows, half new
    gone = ([f"g{j}" for j in range(0, ROWS, 2 * ROWS // DELETES)][:DELETES // 2]
            + [new_keys[j] for j in range(0, WAVE_ROWS + WIRE_WAVE_ROWS,
                                          (WAVE_ROWS + WIRE_WAVE_ROWS) * 2 // DELETES)
               ][:DELETES // 2])
    check(len(set(gone)) == DELETES, "delete keys")
    gone_rows = np.asarray([version.keymap.row(k) for k in gone])
    t0 = time.perf_counter()
    version.delete(gone[0])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for key in gone[1:]:
        version.delete(key)
    rest_s = time.perf_counter() - t0
    for key in gone:
        rows.live[key] = False
    lists = version.nearest_batch(test, GRAPH_K)
    gone_set = set(gone)
    check(not any(k in gone_set for r in lists for k in r), "a deleted key came back")
    _, ids = index.search(rows.matrix()[[rows.at[k] for k in gone[::10]]], GRAPH_K,
                          ef=100)
    check(not np.isin(ids, gone_rows).any(), "a deleted row came back")
    print(f"[writes] {DELETES} deletes ({DELETES // 2} old rows, {DELETES // 2} new): "
          f"the first {first_s * 1e3:.1f} ms (it pulls the graph down to the host), "
          f"the other {DELETES - 1} {rest_s:.2f} s, {(DELETES - 1) / rest_s:.0f} "
          f"deletes/s; no deleted key in any list", flush=True)
    oracle = rows.oracle(torch, version, test)
    after_delete = graph_walk(torch, index, test, oracle, 100, "after the deletes",
                              "writes")
    check(after_delete >= GRAPH_RECALL,
          f"recall@10 at ef=100 after the deletes {after_delete} < {GRAPH_RECALL}")

    # 5. refine 8,192 inserted rows
    ref_rows = np.asarray([version.keymap.row(new_keys[j])
                           for j in range(0, WAVE_ROWS, 2)
                           if rows.live[new_keys[j]]][:REFINE_ROWS])
    k1 = launches["fused_topk_search"]
    t0 = time.perf_counter()
    with version.lock:
        index.refine(ref_rows)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    check(launches["fused_topk_search"] > k1, "refine did not launch K1")
    print(f"[writes] refine of {len(ref_rows)} inserted rows: {refine_s:.2f} s, K1 "
          f"launched {launches['fused_topk_search'] - k1} times", flush=True)
    refined = graph_walk(torch, index, test, oracle, 100, "after the refine", "writes")
    check(refined >= after_delete - 0.005,
          f"recall@10 at ef=100 fell from {after_delete} to {refined} in the refine")

    # 6. save; then a wave and 100 deletes unsaved; reopen from snapshot + WAL
    t0 = time.perf_counter()
    ctx["hub"].save()
    save_s = time.perf_counter() - t0
    s = WAVE_ROWS + WIRE_WAVE_ROWS
    version.multiset(zip(new_keys[s:], new[s:]))
    rows.add(new_keys[s:], new[s:])
    late_gone = [f"g{j}" for j in range(1, 200, 2)]
    for key in late_gone:
        version.delete(key)
        rows.live[key] = False
    n_live = sum(rows.live.values())
    check(version.size == n_live, f"size {version.size} != {n_live}")
    del version, index
    close_graph(torch, ctx)
    t0 = time.perf_counter()
    hub = EmbeddingHub.load_or_create(ctx["base"], engine="hnsw", device=CARD)
    reopen_s = time.perf_counter() - t0
    version = hub.get_version("graph")
    check(version.size == n_live, f"reopened size {version.size} != {n_live}")
    live = [k for k, ok in rows.live.items() if ok]
    got = np.stack(version.multiget(live))
    check(np.array_equal(got, rows.matrix()[[rows.at[k] for k in live]]),
          "an acknowledged key is not bit-exact after the reopen")
    check(not any(k in version for k in gone + late_gone), "a deleted key is back")
    oracle = rows.oracle(torch, version, test)
    reopened = graph_walk(torch, version.index, test, oracle, 100,
                          "after the reopen", "writes")
    check(reopened >= GRAPH_RECALL,
          f"recall@10 at ef=100 after the reopen {reopened} < {GRAPH_RECALL}")
    print(f"[writes] save {save_s:.2f} s; then {FLUSH} rows and {len(late_gone)} "
          f"deletes unsaved; reopen from snapshot + WAL {reopen_s:.2f} s: all "
          f"{n_live} acknowledged keys bit-exact (Get), no deleted key", flush=True)
    print(f"[writes] phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)
    del hub, version
    gc.collect()
    torch.cuda.empty_cache()


def sift_chunk(seed: int, i: int, count: int) -> np.ndarray:
    """Chunk ``i`` of :func:`sift_rows_parallel`: ``count`` rows of
    :func:`sift_desc` from the generator ``default_rng([seed, i])``."""
    return sift_desc(count, np.random.default_rng([seed, i]))


def sift_rows_parallel(n: int, seed: int, chunk: int = 1 << 18) -> np.ndarray:
    """``n`` SIFT-proxy rows drawn chunk by chunk, each chunk from its own
    generator (``sift_chunk``), in worker processes: the same rows whatever
    the number of workers.  The workers are stopped before it returns."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    out = np.empty((n, DIMS), np.float32)
    starts = range(0, n, chunk)
    workers = max(1, min(8, os.cpu_count() or 1, len(starts)))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        parts = [ex.submit(sift_chunk, seed, i, min(chunk, n - s))
                 for i, s in enumerate(starts)]
        for s, part in zip(starts, parts):
            out[s:s + chunk] = part.result()
    return out


def phase_cluster(torch, launches, base):
    """Phase 10: the cluster-routed build of 4M rows through the store, its
    recall, the route, three waves, a snapshot and a reopen."""
    from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    t_phase = t0 = time.perf_counter()
    train = sift_rows_parallel(BIG_ROWS, 10)
    test = sift_desc(GRAPH_QUERIES, np.random.default_rng(11))
    new = sift_rows_parallel(BIG_WAVES * FLUSH, 12)
    print(f"[cluster] SIFT proxy {BIG_ROWS} x {DIMS}, {GRAPH_QUERIES} queries and "
          f"{BIG_WAVES * FLUSH} wave rows: {time.perf_counter() - t0:.1f} s on the host",
          flush=True)
    hub = EmbeddingHub.load_or_create(base, engine="hnsw", device=CARD)
    version = hub.create_space("big", DIMS, "l2").default_version()
    index = version.index
    check(isinstance(index, HNSWIndex) and (index.m, index.ef_construction,
                                            index.cluster_target, index.cluster_probes,
                                            index.cluster_repair_frac)
          == (GRAPH_M, GRAPH_EFC, 4096, 8, 0.5),
          "engine=hnsw did not give an M=16 efC=200 graph with the default cluster knobs")
    check(index.exact_build_max < BIG_ROWS <= index.cluster_build_max,
          "4M rows do not take the cluster-routed build")
    keys = [f"b{j}" for j in range(BIG_ROWS)]
    before = dict(launches)
    t0 = time.perf_counter()
    version.multiset(zip(keys, train))
    ingest_s = time.perf_counter() - t0
    # the routed pools take K1's large-k route (fused_topk.k1_route)
    routed = launches["fused_topk_search_large_k"] - before["fused_topk_search_large_k"]
    built = launches["fused_topk_search"] - before["fused_topk_search"] + routed
    check(built > 0, "the cluster-routed build did not launch K1")
    secs = index.build_seconds
    check("routed_pools" in secs and "boundary_repair" in secs,
          f"not the cluster-routed build: {sorted(secs)}")
    route = index._cluster_route
    sizes = np.bincount(route["assign"], minlength=route["cent"].shape[0])
    blocks = int((-(-sizes // 4096)).sum())
    tails = sizes[sizes % 4096 > 0] % 4096
    repairs = -(-index.boundary_rows // FLUSH)
    print(f"[cluster] multiset {BIG_ROWS} rows, WAL on, one cluster-routed build: "
          f"{ingest_s:.2f} s; build {sum(secs.values()):.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"); levels up to {index._max_level}", flush=True)
    print(f"[cluster] plan: {index._cluster_stats}; {route['cent'].shape[0]} clusters "
          f"of {int(sizes.min())} to {int(sizes.max())} rows; boundary repair of "
          f"{index.boundary_rows} rows", flush=True)
    # (so do pools of at most 32 queries at k > 32: small upper layers)
    check(routed >= blocks,
          f"{routed} launches of K1's large-k route for {blocks} routed pools")
    print(f"[cluster] K1 launched {built} times in the build: {blocks} routed pools "
          f"by its large-k route "
          f"(B <= 4096, k={ROUTED_K}, {ROUTED_S} gathered rows; {tails.size} "
          f"remainder blocks of {int(tails.min(initial=4096))} to "
          f"{int(tails.max(initial=0))} rows), {repairs} repair "
          f"pools (B <= 4096, k={GRAPH_POOL_K}, {BIG_ROWS} rows), "
          f"{built - blocks - repairs} upper-layer pools", flush=True)

    x_dev = torch.from_numpy(train).to(CARD)
    _, oracle = F.exact_topk(torch.from_numpy(test).to(CARD), x_dev,
                             torch.ones(BIG_ROWS, dtype=torch.bool, device=CARD),
                             D.sqnorms(x_dev), k=GRAPH_K, metric="l2", exact=True)
    oracle = oracle.cpu().numpy()
    del x_dev
    torch.cuda.empty_cache()
    recalls = {ef: graph_walk(torch, index, test, oracle, ef, "bf16 walk", "cluster")
               for ef in GRAPH_EFS}
    for ef, bar in BIG_RECALL.items():
        check(recalls[ef] >= bar, f"recall@10 at ef={ef} {recalls[ef]} < {bar}")

    t0 = time.perf_counter()
    index.build_route(ROUTE_PROBES)
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    check(index.seed_probes == ROUTE_PROBES, "build_route did not set the seed probes")
    print(f"[cluster] build_route({ROUTE_PROBES}): {route_s:.2f} s, the build's "
          f"{index._cluster_route['cent'].shape[0]} centroids", flush=True)
    routed = graph_walk(torch, index, test, oracle, 100, "routed walk", "cluster")
    check(routed >= recalls[100] - 0.01,
          f"the routed walk's recall {routed} fell below the descent's {recalls[100]}")

    waves0, per_wave = index.waves, []
    for w in range(BIG_WAVES):
        t0 = time.perf_counter()
        version.multiset((f"n{j}", new[j]) for j in range(w * FLUSH, (w + 1) * FLUSH))
        torch.cuda.synchronize()
        per_wave.append(time.perf_counter() - t0)
        print(f"[cluster] multiset {w + 1} of {FLUSH} rows into the 4M graph: "
              f"{per_wave[-1] * 1e3:.1f} ms, of which " + ", ".join(
                  f"{k} {v * 1e3:.1f}" for k, v in index.wave_seconds.items())
              + " ms", flush=True)
    check(index.waves - waves0 == BIG_WAVES, "a multiset was not one wave")
    check(version.size == BIG_ROWS + BIG_WAVES * FLUSH, f"size {version.size}")
    print(f"[cluster] {BIG_WAVES} multisets of {FLUSH} rows, one wave each: "
          f"{sum(per_wave):.2f} s, {BIG_WAVES * FLUSH / sum(per_wave):.0f} rows/s",
          flush=True)

    want = version.nearest_batch(test, GRAPH_K)
    t0 = time.perf_counter()
    hub.save()
    save_s = time.perf_counter() - t0
    del hub, version, index
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hub = EmbeddingHub.load_or_create(base, engine="hnsw", device=CARD)
    reopen_s = time.perf_counter() - t0
    version = hub.get_version("big")
    check(version.size == BIG_ROWS + BIG_WAVES * FLUSH
          and version.index.seed_probes == ROUTE_PROBES, "the reopened store")
    check(version.nearest_batch(test, GRAPH_K) == want,
          "nearest_batch after the reopen differs")
    print(f"[cluster] save {save_s:.2f} s, snapshot {dir_bytes(base / 'big' / 'initial')} "
          f"bytes; reopen {reopen_s:.2f} s: routed nearest_batch lists equal",
          flush=True)
    print(f"[cluster] phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    del hub, version
    gc.collect()
    torch.cuda.empty_cache()


def deep_rows(rng, centers, count: int) -> np.ndarray:
    """``count`` rows of benchmarks/capacity.py's ``gen_chunk`` (:48-59),
    the same draws from the same generator: a center each, plus noise."""
    assign = rng.integers(0, DEEP_CENTERS, count)
    out = centers[assign] + DEEP_NOISE * rng.standard_normal(
        (count, DEEP_DIMS)).astype(np.float32)
    return out.astype(np.float32)


def recall_at(got, want) -> float:
    return float(np.mean([len(set(g.tolist()) & set(w.tolist())) / want.shape[1]
                          for g, w in zip(got, want)]))


def device_split(torch, fn, runs: int = 3) -> str:
    """Where a call's time goes: a torch.profiler trace of ``runs`` calls,
    the device time of K2's scan, its select, the row bias and scale
    kernels, and everything else (the queries' quantization, the rerank's
    gathers, products and top-k, copies), against the wall time, with the
    device's idle share (1 - busy / wall)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    parts = {"scan": 0.0, "select": 0.0, "bias": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name
        part = ("scan" if "k2_scan_kernel" in name else "select" if "k2_select" in name
                else "bias" if "row_bias" in name or "row_scale" in name
                or "k2_queries" in name else "other")
        parts[part] += e.time_range.elapsed_us()
    busy = sum(parts.values())
    return (f"wall {wall_us / runs / 1e3:.3f} ms a call, device busy "
            f"{busy / runs / 1e3:.3f} (" + ", ".join(
                f"{k} {v / runs / 1e3:.3f}" for k, v in parts.items())
            + f"), idle share {1 - busy / wall_us:.3f}")


def phase_quantized(torch, x_host, launches):
    """Phase 11: the quantized flat arenas, shallow at 1M x 128 and the
    Deep-10M near-duplicate cell."""
    from embeddinghub_tpu_torch.index import flat as flat_mod
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F
    from embeddinghub_tpu_torch.store import persistence
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    t_phase = time.perf_counter()
    # (a) 1M x 128 cosine, one store per engine, K1's exact oracle
    queries = np.random.default_rng(SEED + 11).standard_normal((MAIN_B, DIMS),
                                                               dtype=np.float32)
    x_dev = F.arena_f32(D.normalize(torch.from_numpy(x_host).to(CARD)))
    ones = torch.ones(ROWS, dtype=torch.bool, device=CARD)
    _, oracle = F.exact_topk(torch.from_numpy(queries).to(CARD), x_dev, ones,
                             D.sqnorms(x_dev), k=MAIN_K, metric="cosine")
    oracle = oracle.cpu().numpy()
    del x_dev, ones
    x_bf = torch.from_numpy(x_host).to(CARD)
    x_bf = (x_bf / x_bf.norm(dim=1, keepdim=True).clamp(min=1e-30)).bfloat16().float()
    bf16_ceiling = recall_at(exact_oracle(torch, x_bf, torch.from_numpy(queries).to(CARD),
                                          MAIN_K, unit_rows=True)[1].cpu().numpy(), oracle)
    del x_bf
    keys = [f"k{j}" for j in range(ROWS)]
    for engine, bar in QUANT_BARS.items():
        hub = EmbeddingHub.in_memory(engine=engine, device=CARD)
        version = hub.create_space("quant", DIMS, "cosine").default_version()
        t0 = time.perf_counter()
        for s in range(0, ROWS, FLUSH):
            version.multiset(zip(keys[s:s + FLUSH], x_host[s:s + FLUSH]))
        ingest_s = time.perf_counter() - t0
        before = dict(launches)
        t0 = time.perf_counter()
        got = version.nearest_batch(queries, MAIN_K)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = version.nearest_batch(queries, MAIN_K)
            times.append(time.perf_counter() - t0)
        check(again == got, f"{engine}: repeated nearest_batch differs")
        index = version.index
        dev_ms = device_ms(torch, lambda: index._search_device(queries, MAIN_K, "auto", None))
        ran = {n: launches[n] - before[n] for n in launches if launches[n] > before[n]}
        split = device_split(torch, lambda: version.nearest_batch(queries, MAIN_K))
        hits = sum(len({int(k[1:]) for k in r} & set(o)) for r, o in zip(got, oracle))
        recall = hits / (MAIN_B * MAIN_K)
        print(f"[quantized] {engine} 1M x {DIMS} cosine: multiset {ingest_s:.2f} s; storage "
              f"the guard kept: {index.storage_dtype} (sampled recall@10 "
              f"{index.guard_recalls}); nearest_batch B={MAIN_B} k={MAIN_K}: first "
              f"(guard, quantize, upload) {first_s * 1e3:.1f} ms, steady "
              f"{statistics.median(times) * 1e3:.1f} ms, device {dev_ms:.3f} ms a search; "
              f"recall@{MAIN_K} {recall:.5f} (bar {bar}); kernels {ran}; nearest_batch: "
              f"{split}", flush=True)
        if engine == "flat-bf16":
            before = launches["fused_topk_search"]
            t0 = time.perf_counter()
            exact = index.search(queries, MAIN_K, mode="exact")[1]
            exact_s = time.perf_counter() - t0
            check(launches["fused_topk_search"] > before, "bf16 exact did not launch K1")
            exact_recall = recall_at(exact, oracle)
            print(f"[quantized] flat-bf16: the bf16 storage's ceiling (the exact top-"
                  f"{MAIN_K} over the bf16-rounded unit rows, computed here) recall@"
                  f"{MAIN_K} {bf16_ceiling:.5f}; mode=exact (K1 over f32 upcasts of the "
                  f"bf16 plane) {exact_s * 1e3:.1f} ms, recall@{MAIN_K} {exact_recall:.5f}; "
                  f"auto {recall:.5f} is {'at or above' if recall >= bar else 'below'} "
                  f"{bar}", flush=True)
            bar = bf16_ceiling - QUANT_BF16_GAP
            check(exact_recall >= bar, f"flat-bf16 mode=exact: recall@{MAIN_K} "
                                       f"{exact_recall} < {bar}")
        check(recall >= bar, f"{engine}: recall@{MAIN_K} {recall} < {bar}")
        del hub, version, index
        gc.collect()
        torch.cuda.empty_cache()

    # (b) Deep-10M: capacity.py's rows in its order, one generator
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    centers = (3.0 * rng.standard_normal((DEEP_CENTERS, DEEP_DIMS))).astype(np.float32)
    x = np.empty((DEEP_ROWS, DEEP_DIMS), np.float32)
    for s in range(0, DEEP_ROWS, DEEP_GEN_STEP):
        x[s:s + DEEP_GEN_STEP] = deep_rows(rng, centers, min(DEEP_GEN_STEP, DEEP_ROWS - s))
    qv = deep_rows(rng, centers, DEEP_B)
    qr = deep_rows(rng, centers, DEEP_RECALL_Q)
    padded = np.concatenate([qr, np.zeros((DEEP_B - DEEP_RECALL_Q, DEEP_DIMS), np.float32)])
    print(f"[quantized] deep: {DEEP_ROWS} x {DEEP_DIMS} near-duplicate rows and "
          f"{DEEP_B + DEEP_RECALL_Q} queries generated on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    hub = EmbeddingHub.in_memory(engine="flat-int8", device=CARD)
    version = hub.create_space("deep", DEEP_DIMS, "cosine").default_version()
    index = version.index
    t0 = time.perf_counter()
    version.multiset(zip((f"d{j}" for j in range(DEEP_ROWS)), x))
    print(f"[quantized] deep: one multiset of {DEEP_ROWS} keyed rows "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(index.capacity == DEEP_CAP and index.storage_dtype == "int8",
          f"capacity {index.capacity}, storage {index.storage_dtype}")
    before = dict(launches)
    t0 = time.perf_counter()
    index.search(qv, MAIN_K)
    torch.cuda.synchronize()
    print(f"[quantized] deep: first search (guard, quantize and upload, search) "
          f"{time.perf_counter() - t0:.2f} s; the guard escalated int8 -> "
          f"{index.storage_dtype} at a sampled recall@10 of "
          f"{index.guard_recalls.get('int8', float('nan')):.4f} ({index.guard_recalls})",
          flush=True)
    check(index.storage_dtype == "int8x2", f"the guard kept {index.storage_dtype}")
    check(launches["fused_topk_search_v2_int8"] > before["fused_topk_search_v2_int8"],
          "the deep search did not launch K2's int8 pool")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        version.nearest_batch(qv, MAIN_K)
        times.append(time.perf_counter() - t0)
    dev_ms = device_ms(torch, lambda: index._search_device(qv, MAIN_K, "auto", None))
    print(f"[quantized] deep: nearest_batch B={DEEP_B} k={MAIN_K} median of 3 "
          f"{statistics.median(times) * 1e3:.1f} ms ({DEEP_B / statistics.median(times):.0f} "
          f"queries/s); device {dev_ms:.3f} ms a search (chunks of "
          f"{index._deep_chunk(DEEP_B)} rows); nearest_batch: "
          f"{device_split(torch, lambda: version.nearest_batch(qv, MAIN_K))}", flush=True)

    # the exact oracle: K1 over the f32 rows on the card
    x_dev = F.arena_f32(D.normalize(torch.from_numpy(x).to(CARD)))
    _, oracle = F.exact_topk(torch.from_numpy(qr).to(CARD), x_dev,
                             torch.ones(DEEP_ROWS, dtype=torch.bool, device=CARD),
                             D.sqnorms(x_dev), k=MAIN_K, metric="cosine")
    oracle = oracle.cpu().numpy()
    del x_dev
    torch.cuda.empty_cache()
    got = index.search(padded, MAIN_K)[1][:DEEP_RECALL_Q]
    recall = recall_at(got, oracle)
    print(f"[quantized] deep: recall@{MAIN_K} of {DEEP_RECALL_Q} queries (in a padded "
          f"batch of {DEEP_B}) {recall:.4f} on {index.storage_dtype} (bar {DEEP_RECALL})",
          flush=True)
    check(recall >= DEEP_RECALL, f"deep recall@{MAIN_K} {recall} < {DEEP_RECALL}")
    for dtype in ("int8", "bfloat16"):  # the same rows without the guard, and in bf16
        other = flat_mod.FlatIndex(DEEP_DIMS, "cosine", capacity=DEEP_ROWS,
                                   storage_dtype=dtype, quant_guard=False, device=CARD)
        other.add(np.arange(DEEP_ROWS), x)
        t0 = time.perf_counter()
        o_got = other.search(padded, MAIN_K)[1][:DEEP_RECALL_Q]
        print(f"[quantized] deep: a {dtype} FlatIndex (guard off) over the same rows: "
              f"recall@{MAIN_K} {recall_at(o_got, oracle):.4f} (first search "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
        del other
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report = version.audit_quantization(bar=0.95, nq=64)
    print(f"[quantized] deep: audit_quantization(bar=0.95, nq=64) in "
          f"{time.perf_counter() - t0:.1f} s: {report}", flush=True)

    # stream 100,000 rows, a search after each multiset (the dirty-row scatter)
    streamed = []
    t0 = time.perf_counter()
    for s in range(0, DEEP_STREAM, DEEP_WAVE):
        rows = deep_rows(rng, centers, min(DEEP_WAVE, DEEP_STREAM - s))
        streamed.append(rows)
        version.multiset(zip((f"s{s + j}" for j in range(len(rows))), rows))
        check(index._dirty_rows and not index._needs_full_sync, "not a scatter")
        version.nearest_batch(rows[:8], MAIN_K)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    streamed = np.concatenate(streamed)
    sample = rng.integers(DEEP_ROWS, DEEP_ROWS + DEEP_STREAM, DEEP_SELF)
    q_self = np.concatenate([streamed[sample - DEEP_ROWS],
                             np.zeros((DEEP_B - DEEP_SELF, DEEP_DIMS), np.float32)])
    hit = index.search(q_self, MAIN_K)[1][:DEEP_SELF]
    self_recall = float(np.mean([sample[j] in hit[j] for j in range(DEEP_SELF)]))
    print(f"[quantized] deep: streamed {DEEP_STREAM} rows in multisets of {DEEP_WAVE}, a "
          f"search after each: {stream_s:.2f} s ({DEEP_STREAM / stream_s:.0f} rows/s); "
          f"self-recall of {DEEP_SELF} streamed rows {self_recall}", flush=True)
    check(self_recall == 1.0, f"streamed self-recall {self_recall}")
    check(version.size == DEEP_ROWS + DEEP_STREAM, f"size {version.size}")

    # the version's snapshot (what hub.save writes for it), then a reopen
    want = index.search(qv, MAIN_K)[1]
    quantized = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deep_") as tmp:
        t0 = time.perf_counter()
        persistence.save_version(Path(tmp) / "deep", version)
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(Path(tmp))
        del hub, version, index
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        version = persistence.load_version(Path(tmp) / "deep", device=CARD)
        index = version.index
        plain_planes = flat_mod.quantize_planes
        flat_mod.quantize_planes = lambda *a, **kw: quantized.append(1) or plain_planes(*a, **kw)
        try:
            t1 = time.perf_counter()
            got = index.search(qv, MAIN_K)[1]
            first_s = time.perf_counter() - t1
        finally:
            flat_mod.quantize_planes = plain_planes
        reopen_s = time.perf_counter() - t0
        check(index.storage_dtype == "int8x2" and not quantized,
              f"the reopen quantized again ({len(quantized)} blocks, {index.storage_dtype})")
        check(np.array_equal(got, want), "the lists differ after the reopen")
        print(f"[quantized] deep: snapshot {save_s:.2f} s ({nbytes} bytes, q_* planes "
              f"included); reopen and first search {reopen_s:.2f} s (search with the "
              f"planes' upload {first_s:.2f} s, nothing quantized): the same lists",
              flush=True)
        del version, index
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[quantized] phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    # phase 12 (b) takes the same rows, queries, oracle and generator
    return {"x": x, "centers": centers, "rng": rng, "qv": qv, "padded": padded,
            "oracle": oracle}


def sharded_split(torch, fn, runs: int = 3) -> str:
    """Where a sharded search's time goes: a torch.profiler trace of
    ``runs`` calls, the device time of K1's kernels (the shards' scans and
    their split merges), K2's (the shards' int8 pools), and everything else
    (the reranks, the merge of the shards' lists, copies), against the wall
    time, with the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    parts = {"K1": 0.0, "K2": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name
        part = ("K1" if "k1_scan_kernel" in name or name.startswith("merge_kernel")
                else "K2" if "k2_" in name or "row_scale" in name else "other")
        parts[part] += e.time_range.elapsed_us()
    busy = sum(parts.values())
    return (f"wall {wall_us / runs / 1e3:.3f} ms a call, device busy "
            f"{busy / runs / 1e3:.3f} (" + ", ".join(
                f"{k} {v / runs / 1e3:.3f}" for k, v in parts.items())
            + f"), idle share {1 - busy / wall_us:.3f}")


def timed_calls(fn, runs: int = 3) -> float:
    """Median host seconds of ``runs`` calls of ``fn``."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_sharded(torch, x_host, launches, deep, graph_rows, base):
    """Phase 12: the sharded engines on a mesh of SHARDS shards of one card."""
    from embeddinghub_tpu_torch.index.flat import FlatIndex
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F
    from embeddinghub_tpu_torch.parallel import Mesh, ShardedFlatIndex, ShardedHNSWIndex
    from embeddinghub_tpu_torch.store import persistence
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub
    from embeddinghub_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    mesh = Mesh([CARD] * SHARDS)
    line = {"shards": SHARDS}

    # (a) sharded f32: 1M x 128 cosine, 4,096-row multisets
    queries = np.random.default_rng(SEED + 12).standard_normal((MAIN_B, DIMS),
                                                               dtype=np.float32)
    hub = EmbeddingHub.in_memory(engine="sharded", mesh=mesh)
    version = hub.create_space("sharded", DIMS, "cosine").default_version()
    index = version.index
    check(isinstance(index, ShardedFlatIndex) and index.mesh.size == SHARDS,
          "engine=sharded did not give a ShardedFlatIndex on the mesh")
    keys = [f"k{j}" for j in range(ROWS)]
    t0 = time.perf_counter()
    for s in range(0, ROWS, FLUSH):
        version.multiset(zip(keys[s:s + FLUSH], x_host[s:s + FLUSH]))
    ingest_s = time.perf_counter() - t0
    check(index._cap_local == SHARD_CAP, f"local capacity {index._cap_local}")
    before = launches["fused_topk_search"]
    t0 = time.perf_counter()
    got = version.nearest_batch(queries, MAIN_K)
    first_s = time.perf_counter() - t0
    check(launches["fused_topk_search"] - before == SHARDS,
          f"a sharded search launched K1 {launches['fused_topk_search'] - before} times")
    steady = timed_calls(lambda: version.nearest_batch(queries, MAIN_K))
    qp = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    dev_ms = device_ms(torch, lambda: index.search_device(qp, 16))
    split = sharded_split(torch, lambda: version.nearest_batch(queries, MAIN_K))
    sd, si = index.search(queries, MAIN_K)
    check([[f"k{r}" for r in row] for row in si] == got, "nearest_batch != search")
    flat = FlatIndex(DIMS, "cosine", capacity=CAP, device=CARD)
    flat.add(np.arange(ROWS), x_host)
    fd, fi = flat.search(queries, MAIN_K, mode="exact")
    del flat
    swaps = si != fi
    check(np.abs(sd - fd).max() <= SHARD_TIE, "sharded distances differ from one card's")
    if swaps.any():  # ties: the sharded row lies within SHARD_TIE of the slot
        qn = qp[np.nonzero(swaps)[0]]
        xr = x_host[si[swaps]]
        true_d = 1 - np.einsum("nd,nd->n", xr / np.linalg.norm(xr, axis=1, keepdims=True), qn)
        check(np.abs(true_d - fd[swaps]).max() <= SHARD_TIE,
              "sharded lists differ from one card's beyond ties")
    recall = recall_at(si, fi)
    line.update(f32_rows_per_shard=SHARD_ROWS, f32_ms=round(steady * 1e3, 3),
                f32_device_ms=round(dev_ms, 3), f32_recall=recall)
    print(f"[sharded] (a) {SHARDS} shards of {CARD}, 1M x {DIMS} cosine, {SHARD_ROWS} "
          f"rows a shard (local capacity {index._cap_local}): multiset in {FLUSH}-row "
          f"batches {ingest_s:.2f} s ({ROWS / ingest_s:.0f} rows/s); nearest_batch "
          f"B={MAIN_B} k={MAIN_K}: first (full sync) {first_s * 1e3:.1f} ms, steady "
          f"{steady * 1e3:.1f} ms ({MAIN_B / steady:.0f} queries/s), device "
          f"{dev_ms:.3f} ms a search ({SHARDS} K1 scans and the merge); the lists "
          f"equal one card's FlatIndex exact lists ({int(swaps.sum())} tie swaps); "
          f"recall@{MAIN_K} {recall:.5f} (bar {SHARD_RECALL}); nearest_batch: {split}",
          flush=True)
    check(recall >= SHARD_RECALL, f"sharded recall@{MAIN_K} {recall} < {SHARD_RECALL}")
    del hub, version, index
    gc.collect()
    torch.cuda.empty_cache()

    # (b) sharded-int8, Deep-10M: phase 11's rows, one multiset
    x, qv, padded, oracle, rng = deep["x"], deep["qv"], deep["padded"], deep["oracle"], \
        deep["rng"]
    hub = EmbeddingHub.in_memory(engine="sharded-int8", mesh=mesh)
    version = hub.create_space("deep", DEEP_DIMS, "cosine").default_version()
    index = version.index
    t0 = time.perf_counter()
    version.multiset(zip((f"d{j}" for j in range(DEEP_ROWS)), x))
    ingest_s = time.perf_counter() - t0
    check(index._cap_local == SHARD_DEEP_CAP and index.storage_dtype == "int8",
          f"local capacity {index._cap_local}, storage {index.storage_dtype}")
    before = launches["fused_topk_search_v2_int8"]
    t0 = time.perf_counter()
    index.search(qv, MAIN_K)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(launches["fused_topk_search_v2_int8"] - before == SHARDS,
          "a deep sharded search did not launch K2's int8 pool once a shard")
    guard = index.guard_recalls.get("int8", float("nan"))
    print(f"[sharded] (b) Deep-10M: one multiset of {DEEP_ROWS} keyed rows "
          f"{ingest_s:.1f} s; first search (guard, quantize and upload, search) "
          f"{first_s:.2f} s; the guard escalated int8 -> {index.storage_dtype} at a "
          f"sampled recall@10 of {guard:.4f} ({index.guard_recalls})", flush=True)
    check(index.storage_dtype == "int8x2", f"the guard kept {index.storage_dtype}")
    steady = timed_calls(lambda: version.nearest_batch(qv, MAIN_K))
    dev_ms = device_ms(torch, lambda: index.search_device(
        qv / np.linalg.norm(qv, axis=1, keepdims=True), 16))
    split = sharded_split(torch, lambda: version.nearest_batch(qv, MAIN_K))
    recall = recall_at(index.search(padded, MAIN_K)[1][:DEEP_RECALL_Q], oracle)
    print(f"[sharded] (b) nearest_batch B={DEEP_B} k={MAIN_K}: {steady * 1e3:.1f} ms "
          f"({DEEP_B / steady:.0f} queries/s), device {dev_ms:.3f} ms a search ({SHARDS} "
          f"shards of {SHARD_DEEP_ROWS} rows in {SHARD_DEEP_CAP // SHARD_DEEP_CHUNK} chunks "
          f"of {SHARD_DEEP_CHUNK}); recall@{MAIN_K} of {DEEP_RECALL_Q} queries "
          f"{recall:.4f} (bar {DEEP_RECALL}); nearest_batch: {split}", flush=True)
    check(recall >= DEEP_RECALL, f"sharded deep recall@{MAIN_K} {recall} < {DEEP_RECALL}")
    line.update(deep_rows_per_shard=SHARD_DEEP_ROWS, deep_ms=round(steady * 1e3, 3),
                deep_device_ms=round(dev_ms, 3), deep_recall=recall,
                guard_dtype=index.storage_dtype, guard_recall=guard)
    streamed = []
    t0 = time.perf_counter()
    for j in range(SHARD_STREAMS):
        rows = deep_rows(rng, deep["centers"], DEEP_WAVE)
        streamed.append(rows)
        version.multiset(zip((f"s{j * DEEP_WAVE + i}" for i in range(DEEP_WAVE)), rows))
        check(index._dirty_rows and not index._dirty, "not a scatter")
        version.nearest_batch(rows[:8], MAIN_K)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    streamed = np.concatenate(streamed)
    sample = rng.choice(len(streamed), SHARD_SELF, replace=False)
    hit = index.search(streamed[sample], MAIN_K)[1]
    found = float(np.mean([DEEP_ROWS + sample[j] in hit[j] for j in range(SHARD_SELF)]))
    check(version.size == DEEP_ROWS + len(streamed), f"size {version.size}")
    print(f"[sharded] (b) {SHARD_STREAMS} multisets of {DEEP_WAVE} rows, a search after "
          f"each (the scatter): {stream_s:.2f} s; {SHARD_SELF} streamed rows find "
          f"themselves: {found}", flush=True)
    check(found == 1.0, f"streamed self-recall {found}")
    want = index.search(qv, MAIN_K)[1]
    t0 = time.perf_counter()
    persistence.save_version(base / "deep", version)
    save_s = time.perf_counter() - t0
    del hub, version, index
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    version = persistence.load_version(base / "deep", device=CARD, mesh=mesh)
    index = version.index
    again = index.search(qv, MAIN_K)[1]
    reopen_s = time.perf_counter() - t0
    check(isinstance(index, ShardedFlatIndex) and index.storage_dtype == "int8x2"
          and index.mesh is mesh, f"reopened {type(index).__name__} {index.storage_dtype}")
    check(np.array_equal(again, want), "the deep lists differ after the reopen")
    print(f"[sharded] (b) snapshot {save_s:.2f} s ({dir_bytes(base / 'deep')} bytes); "
          f"reopen onto the {SHARDS}-shard mesh and first search {reopen_s:.2f} s "
          f"(int8x2 from sflat_meta, planes quantized again): the same lists", flush=True)
    del version, index
    gc.collect()
    torch.cuda.empty_cache()

    # (c) hnsw-sharded: phase 8's 1M SIFT-proxy rows, one multiset
    train, test = graph_rows
    config = Config(engine="hnsw-sharded", hnsw_m=GRAPH_M, hnsw_ef_construction=GRAPH_EFC)
    hub = EmbeddingHub.load_or_create(base / "graph", engine="hnsw-sharded", mesh=mesh,
                                      config=config)
    version = hub.create_space("graph", DIMS, "l2").default_version()
    index = version.index
    check(isinstance(index, ShardedHNSWIndex) and index.n_shards == SHARDS,
          "engine=hnsw-sharded did not give a ShardedHNSWIndex on the mesh")
    keys = [f"g{j}" for j in range(ROWS)]
    before = launches["fused_topk_search"]
    t0 = time.perf_counter()
    version.multiset(zip(keys, train))
    ingest_s = time.perf_counter() - t0
    built = launches["fused_topk_search"] - before
    check(built > 0, "the shards' bulk builds did not launch K1")
    build_s = sum(sum(sh.build_seconds.values()) for sh in index._shards)
    x_dev = torch.from_numpy(train).to(CARD)
    _, oracle = F.exact_topk(torch.from_numpy(test).to(CARD), x_dev,
                             torch.ones(ROWS, dtype=torch.bool, device=CARD),
                             D.sqnorms(x_dev), k=GRAPH_K, metric="l2", exact=True)
    oracle = oracle.cpu().numpy()
    del x_dev
    print(f"[sharded] (c) hnsw-sharded 1M x {DIMS} l2, M={GRAPH_M} efC={GRAPH_EFC}, "
          f"{SHARD_ROWS} rows a shard: one multiset with the WAL on {ingest_s:.2f} s; "
          f"the {SHARDS} bulk builds {build_s:.2f} s ("
          + "; ".join(f"{sum(sh.build_seconds.values()):.2f}" for sh in index._shards)
          + f"); K1 launched {built} times", flush=True)
    recalls, walk_ms = {}, {}
    for ef in GRAPH_EFS:
        ids = index.search(test, GRAPH_K, ef=ef)[1]
        recalls[ef] = recall_at(ids, oracle)
        walk_ms[ef] = device_ms(torch, lambda: index.search(test, GRAPH_K, ef=ef))
        print(f"[sharded] (c) search B={GRAPH_QUERIES} k={GRAPH_K} ef={ef}: recall@"
              f"{GRAPH_K} {recalls[ef]:.4f}; {walk_ms[ef]:.3f} ms per batch", flush=True)
    check(recalls[100] >= GRAPH_RECALL,
          f"sharded graph recall@10 at ef=100 {recalls[100]} < {GRAPH_RECALL}")
    line.update(graph_rows_per_shard=SHARD_ROWS, graph_build_s=round(build_s, 3),
                graph_recall={str(ef): r for ef, r in recalls.items()},
                graph_ms={str(ef): round(v, 3) for ef, v in walk_ms.items()})
    new = sift_rows(SHARD_GRAPH_WAVES * FLUSH, 3)
    before = launches["fused_topk_search"]
    t0 = time.perf_counter()
    for j in range(SHARD_GRAPH_WAVES):
        version.multiset(zip((f"w{j * FLUSH + i}" for i in range(FLUSH)),
                             new[j * FLUSH:(j + 1) * FLUSH]))
    waves_s = time.perf_counter() - t0
    check(launches["fused_topk_search"] > before, "the waves did not launch K1")
    check(version.size == ROWS + len(new), f"size {version.size}")
    want = version.nearest_batch(test, GRAPH_K)
    t0 = time.perf_counter()
    hub.save()
    save_s = time.perf_counter() - t0
    del hub, version, index
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hub = EmbeddingHub.load_or_create(base / "graph", engine="hnsw-sharded", mesh=mesh,
                                      config=config)
    reopen_s = time.perf_counter() - t0
    check(hub.get_version("graph").nearest_batch(test, GRAPH_K) == want,
          "the sharded graph's lists differ after the reopen")
    print(f"[sharded] (c) {SHARD_GRAPH_WAVES} multisets of {FLUSH} rows (a wave of "
          f"{SHARD_WAVE_B} a shard): {waves_s:.2f} s ({len(new) / waves_s:.0f} rows/s); "
          f"save {save_s:.2f} s, reopen {reopen_s:.2f} s: the same lists", flush=True)
    del hub
    gc.collect()
    torch.cuda.empty_cache()
    line["phase_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"[sharded] {json.dumps(line)}", flush=True)


def trace_events(log_dir: str) -> list:
    """The events of the one Chrome trace ``tracing.profile`` wrote."""
    import glob

    paths = glob.glob(os.path.join(log_dir, "*.json"))
    check(len(paths) == 1, f"tracing.profile wrote {paths}, not one trace")
    with open(paths[0]) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    check(len(events) > 0, "the profiler trace is empty")
    return events


def phase_featurestore(torch, x_host, launches):
    """Phase 13: the feature store's definitions applied by a port
    ``ff.Client`` in process, the embedding feature materialized into the
    engine vector store on the card, then single ``nearest`` calls.
    Returns the queries, their keys and the exact oracle's rows (phase 14
    asks the composer the same)."""
    import embeddinghub_tpu_torch.featurestore as ff
    from embeddinghub_tpu_torch.featurestore.providers import engine_vector
    from embeddinghub_tpu_torch.featurestore.providers.base import reset_provider_cache
    from embeddinghub_tpu_torch.featurestore.providers.sqlite_offline import (
        SqliteOfflineStore,
    )
    from embeddinghub_tpu_torch.featurestore.resources import Status
    from embeddinghub_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    x = x_host[:FS_ROWS]
    rows = [{"key": f"e{i}", "vec": v} for i, v in enumerate(x.tolist())]
    # the apply's parts, timed where the coordinator's tasks call them
    spent = {"register": 0.0, "materialize": 0.0, "copy": 0.0}
    timed = ((SqliteOfflineStore, "register_primary", "register"),
             (SqliteOfflineStore, "materialize", "materialize"),
             (engine_vector._LocalVectorTable, "batch_set", "copy"))
    originals = [(cls, attr, getattr(cls, attr)) for cls, attr, _ in timed]

    def timer(fn, part):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[part] += time.perf_counter() - t0
        return run

    reset_provider_cache()
    ff.global_registrar().reset()
    client = ff.Client()
    reg = client.registrar
    reg.register_sqlite_offline("warehouse")
    reg.register_engine_vector_store("vectors", device=CARD)
    reg.register_entity("item")
    reg.register_primary_data("items", provider="warehouse", location={"rows": rows})
    reg.register_embedding_feature(
        "emb", source=("items", "default"), entity="item", entity_column="key",
        value_column="vec", dims=DIMS, provider="vectors")
    for cls, attr, part in timed:
        setattr(cls, attr, timer(getattr(cls, attr), part))
    try:
        t0 = time.perf_counter()
        client.apply()
        apply_s = time.perf_counter() - t0
    finally:
        for cls, attr, fn in originals:
            setattr(cls, attr, fn)
    del rows
    states = {(r.rtype.name, r.name): r.status for r in client.metadata.all()}
    check(all(s == Status.READY for s in states.values()), f"not all READY: {states}")
    hub = client.coordinator.provider_for("vectors")._hub
    version = hub.get_space("vector__emb__default").default_version()
    index = version.index
    check(version.size == FS_ROWS and index.capacity == FS_ROWS
          and index.device.type == "cuda",
          f"vector space: {version.size} rows, capacity {index.capacity} on {index.device}")
    print(f"[featurestore] apply of {FS_ROWS} x {DIMS} rows: {apply_s:.2f} s (register "
          f"{spent['register']:.2f} s, materialize {spent['materialize']:.2f} s, copy "
          f"into the engine {spent['copy']:.2f} s); {len(states)} resources READY, the "
          f"vector space on {index.device} with {version.size} rows", flush=True)

    rng = np.random.default_rng(SEED + 13)
    src = rng.choice(FS_ROWS, FS_NEAR, replace=False)
    queries = np.concatenate([
        x[src] + FS_NOISE * rng.standard_normal((FS_NEAR, DIMS), dtype=np.float32),
        rng.standard_normal((FS_QUERIES - FS_NEAR, DIMS), dtype=np.float32)])

    def nearest(q):
        return client.nearest("emb", "default", q, FS_K)

    for q in queries[:FS_WARM]:
        nearest(q)
    before = launches.get("fused_topk_search_v2", 0)
    walls, events, got = [], [], []
    for q in queries:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        got.append(nearest(q))
        end.record()
        walls.append(time.perf_counter() - t0)
        events.append((start, end))
    torch.cuda.synchronize()
    per_call = (launches.get("fused_topk_search_v2", 0) - before) / FS_QUERIES
    check(per_call >= 1, f"K2 launched {per_call} times a nearest call")
    event_ms = [s.elapsed_time(e) for s, e in events]
    walls_ms = np.array(walls) * 1e3
    for q, keys in zip(queries, got):
        check(keys == version.nearest_batch(q[None], FS_K)[0],
              "the feature store's nearest keys differ from nearest_batch's")
    x_dev = torch.from_numpy(x).cuda()
    _, oi = exact_oracle(torch, x_dev, torch.from_numpy(queries).cuda(), FS_K)
    del x_dev
    check(all(len(keys) == FS_K for keys in got), "short nearest results")
    ids = np.array([[int(k[1:]) for k in keys] for keys in got])
    recall = recall_at(ids, oi.cpu().numpy())
    top1 = float(np.mean([ids[j][0] == int(src[j]) for j in range(FS_NEAR)]))
    print(f"[featurestore] {FS_QUERIES} nearest calls at k={FS_K} ({FS_NEAR} noisy "
          f"copies, {FS_QUERIES - FS_NEAR} fresh): p50 {np.percentile(walls_ms, 50):.3f} "
          f"ms, p99 {np.percentile(walls_ms, 99):.3f} ms a call; CUDA events "
          f"{statistics.median(event_ms):.3f} ms (median); K2 launches a call "
          f"{per_call:g}; keys equal nearest_batch's; recall@{FS_K} {recall:.5f}; "
          f"top-1 the source row {top1:.4f}", flush=True)
    check(recall >= FS_RECALL, f"featurestore recall@{FS_K} {recall} < {FS_RECALL}")
    check(top1 >= FS_TOP1, f"featurestore top-1 {top1} < {FS_TOP1}")

    # the profiler can lose a kernel's activity record (one run's trace held
    # 15 of 16 K2 scans): FS_TRACE_WARM more calls in the window leave room
    # for such losses in the launch counts checked below
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        with tracing.profile(tmp):
            for q in queries[FS_TRACED:FS_TRACED + FS_TRACE_WARM]:
                nearest(q)
            for q in queries[:FS_TRACED]:
                with tracing.annotate("ff.nearest"):
                    nearest(q)
        trace = trace_events(tmp)
    ranges = [e for e in trace if e.get("name") == "ff.nearest"
              and e.get("cat") == "user_annotation"]
    range_us = sum(e.get("dur", 0.0) for e in ranges)
    kernels = {"k2_scan_kernel": [], "k2_select_kernel": []}
    busy_us = 0.0
    for e in trace:
        if e.get("cat") != "kernel":
            continue
        busy_us += e.get("dur", 0.0)
        for name in kernels:
            if name in e.get("name", ""):
                kernels[name].append(e.get("dur", 0.0))
    calls = FS_TRACED + FS_TRACE_WARM
    print(f"[featurestore] trace of {calls} calls, {FS_TRACED} annotated: {len(ranges)} "
          f"ff.nearest ranges; device us a launch: " + ", ".join(
              f"{n} {sum(d) / max(len(d), 1):.1f} ({len(d)} launches)"
              for n, d in kernels.items())
          + f"; every kernel {busy_us / calls:.1f} us a call; the annotated calls' range "
          f"{range_us / FS_TRACED:.1f} us (the profiler's host cost included); "
          f"untraced, CUDA events {statistics.median(event_ms) * 1e3:.1f} us a call "
          f"(idle share {1 - busy_us / calls / 1e3 / statistics.median(event_ms):.3f})",
          flush=True)
    check(len(ranges) == FS_TRACED, f"{len(ranges)} ff.nearest ranges, not {FS_TRACED}")
    for name, durs in kernels.items():
        check(len(durs) >= FS_TRACED, f"the trace names {name} {len(durs)} times")
    del client, hub, version, index
    reset_provider_cache()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[featurestore] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"queries": queries, "keys": got, "oracle": oi.cpu().numpy()}


# phase 14's definitions file: phase 13's resources, the rows from a .npy
COMPOSER_DEFS = """
import numpy as np
import embeddinghub_tpu_torch.featurestore as ff

x = np.load({rows!r})
reg = ff.global_registrar()
reg.register_sqlite_offline("warehouse")
reg.register_engine_vector_store("vectors")
reg.register_entity("item")
reg.register_primary_data("items", provider="warehouse", location={{"rows": [
    {{"key": f"e{{i}}", "vec": v}} for i, v in enumerate(x.tolist())]}})
reg.register_embedding_feature(
    "emb", source=("items", "default"), entity="item", entity_column="key",
    value_column="vec", dims={dims}, provider="vectors")
"""


def composer_ready(mc, wire, deadline: float) -> dict:
    """Poll the composer's metadata gRPC until its COMPOSER_RESOURCES
    resources are READY; a FAILED one, or the deadline, fails the run.
    ``mc`` (the compact service) lists the providers, the entity and the
    feature; the source comes from ``wire`` (the typed ff_metadata
    service), because the compact service's blob carries the source's
    inline rows as JSON (10,927,216 bytes for 4,096 rows of 128 dims,
    already past gRPC's default 4 MiB message limit)."""
    from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_pb2 as mpb
    from embeddinghub_tpu_torch.featurestore.resources import ResourceType

    kinds = (ResourceType.PROVIDER, ResourceType.ENTITY, ResourceType.FEATURE_VARIANT)
    source = mpb.NameVariantRequest(name_variant=mpb.NameVariant(
        name="items", variant="default"))
    while True:
        states = {(r.rtype.name, r.name): (r.status.name, r.status_error)
                  for t in kinds for r in mc.list(t)}
        for sv in wire.GetSourceVariants(iter([source])):
            states[("SOURCE_VARIANT", sv.name)] = (
                mpb.ResourceStatus.Status.Name(sv.status.status), sv.status.error_message)
        failed = {k: err for k, (status, err) in states.items() if status == "FAILED"}
        check(not failed, f"composer resources FAILED: {failed}")
        if (len(states) == COMPOSER_RESOURCES
                and all(status == "READY" for status, _ in states.values())):
            return states
        now = {k: status for k, (status, _) in states.items()}
        check(time.monotonic() < deadline,
              f"composer resources not READY within {COMPOSER_READY_S} s: {now}")
        time.sleep(0.5)


def phase_composer(torch, x_host, fs):
    """Phase 14: ``python -m embeddinghub_tpu_torch.main`` on the card,
    phase 13's definitions applied by its coordinator, ``Nearest`` over
    gRPC from one client and from COMPOSER_THREADS, the store surface and
    the dashboard.  Returns the launches its process reports on SIGTERM."""
    import urllib.request

    from embeddinghub_tpu_torch.featurestore.metadata_grpc import RemoteMetadataClient
    from embeddinghub_tpu_torch.featurestore.proto import ff_scheduling_pb2 as spb
    from embeddinghub_tpu_torch.featurestore.proto.ff_metadata_grpc import MetadataStub
    from embeddinghub_tpu_torch.featurestore.proto.ff_scheduling_grpc import TasksStub
    from embeddinghub_tpu_torch.featurestore.remote_client import RemoteServingClient
    from embeddinghub_tpu_torch.sdk.client import EmbeddingHubClient
    from embeddinghub_tpu_torch.service.spawn import ComposerProcess

    t_phase = time.perf_counter()
    queries, want = fs["queries"], fs["keys"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_composer_") as tmp:
        rows = Path(tmp) / "rows.npy"
        np.save(rows, x_host[:FS_ROWS])
        defs = Path(tmp) / "defs.py"
        defs.write_text(COMPOSER_DEFS.format(rows=str(rows), dims=DIMS))
        t0 = time.perf_counter()
        # One malloc arena: glibc gives each further thread an arena of its
        # own, in which the coordinator thread's registration of the source
        # ran 2.5x slower than in a main thread (tools/probe_composer.py).
        composer = ComposerProcess(Path(tmp) / "store", device=CARD, defs=defs,
                                   env={"MALLOC_ARENA_MAX": "1"},
                                   start_timeout=SERVER_START_S, wait_timeout=WAIT_S)
        up_s, up_wall = time.perf_counter() - t0, time.time()
        try:
            mc = RemoteMetadataClient(host="127.0.0.1", port=composer.metadata_port)
            wire = MetadataStub(mc._channel)
            t0 = time.perf_counter()
            states = composer_ready(mc, wire, time.monotonic() + COMPOSER_READY_S)
            ready_s = time.perf_counter() - t0
            # the coordinator's task runs, from its tasks wire: where READY's
            # seconds went
            runs = sorted(TasksStub(mc._channel).GetAllRuns(spb.Empty()),
                          key=lambda r: r.startTime.ToMilliseconds())
            mc.close()
            parts = "; ".join(
                f"{r.name} from {r.startTime.ToMilliseconds() / 1e3 - up_wall:.2f} s, "
                f"{(r.endTime.ToMilliseconds() - r.startTime.ToMilliseconds()) / 1e3:.2f} s"
                for r in runs)
            print(f"[composer] up in {up_s:.2f} s (store, serving, metadata, dashboard "
                  f"and the coordinator; the defs' {FS_ROWS} rows loaded); "
                  f"{len(states)} resources READY {ready_s:.2f} s after the up line "
                  f"(the coordinator's materialization of {FS_ROWS} x {DIMS}); task runs, "
                  f"start after the up line and length: {parts}", flush=True)

            rc = RemoteServingClient(host="127.0.0.1", port=composer.serving_port)

            def nearest(client, q):
                return client.nearest("emb", "default", q, FS_K)

            for q in queries[:FS_WARM]:
                nearest(rc, q)
            walls, got = [], []
            for q in queries:
                t0 = time.perf_counter()
                got.append(nearest(rc, q))
                walls.append(time.perf_counter() - t0)
            rc.close()
            check(got == want, "a gRPC Nearest key list differs from phase 13's "
                  "in-process one")
            ids = np.array([[int(k[1:]) for k in keys] for keys in got])
            recall = recall_at(ids, fs["oracle"])
            check(recall >= FS_RECALL, f"composer recall@{FS_K} {recall} < {FS_RECALL}")
            walls_ms = np.array(walls) * 1e3
            print(f"[composer] {FS_QUERIES} Nearest calls over gRPC, one client, "
                  f"k={FS_K}: p50 {np.percentile(walls_ms, 50):.3f} ms, p99 "
                  f"{np.percentile(walls_ms, 99):.3f} ms a call; keys equal phase 13's "
                  f"in-process keys; recall@{FS_K} {recall:.5f}", flush=True)

            # COMPOSER_THREADS clients, a channel each, COMPOSER_CALLS calls each
            from concurrent.futures import ThreadPoolExecutor

            def client_thread(t):
                c = RemoteServingClient(host="127.0.0.1", port=composer.serving_port)
                out = []
                try:
                    for j in range(t * COMPOSER_CALLS, (t + 1) * COMPOSER_CALLS):
                        t0 = time.perf_counter()
                        keys = nearest(c, queries[j])
                        out.append((j, keys, time.perf_counter() - t0))
                finally:
                    c.close()
                return out

            t0 = time.perf_counter()
            with ThreadPoolExecutor(COMPOSER_THREADS) as pool:
                results = [r for rs in pool.map(client_thread, range(COMPOSER_THREADS))
                           for r in rs]
            conc_s = time.perf_counter() - t0
            calls = COMPOSER_THREADS * COMPOSER_CALLS
            check(len(results) == calls, f"{len(results)} concurrent answers, not {calls}")
            for j, keys, _ in results:
                check(keys == got[j], f"concurrent Nearest {j} differs from the "
                      "single-client answer")
            conc_ms = np.array([dt for _, _, dt in results]) * 1e3
            print(f"[composer] {COMPOSER_THREADS} clients x {COMPOSER_CALLS} Nearest "
                  f"calls: {calls / conc_s:.1f} calls/s, p50 "
                  f"{np.percentile(conc_ms, 50):.3f} ms, p99 "
                  f"{np.percentile(conc_ms, 99):.3f} ms a call; every answer equals the "
                  f"single-client one", flush=True)

            # the store surface: an exact space (4,096 rows: K1)
            c = EmbeddingHubClient(host="127.0.0.1", port=composer.store_port)
            c.create_space("composer", DIMS)
            keys = [f"c{j}" for j in range(COMPOSER_STORE_ROWS)]
            c.multiset("composer", ((keys[j], x_host[j].tolist())
                                    for j in range(COMPOSER_STORE_ROWS)))
            back = np.asarray(c.get("composer", "c7"), dtype=np.float32)
            check(np.array_equal(back, x_host[7]), "the store surface's get differs")
            near = list(c.nearest_neighbor("composer", MAIN_K, key="c5"))
            check(len(near) == MAIN_K and "c5" not in near,
                  f"the store surface's keyed nearest {near}")
            # against an exact f64 oracle over the space's rows but the key's
            space = x_host[:COMPOSER_STORE_ROWS].astype(np.float64)
            dist = ((space - space[5]) ** 2).sum(axis=1)
            dist[5] = np.inf
            want_d = np.sort(dist)[:MAIN_K]
            got_d = dist[[int(key[1:]) for key in near]]
            store_err = float(np.abs(got_d - want_d).max())
            check(np.allclose(got_d, want_d, rtol=1e-5, atol=1e-4),
                  f"the store surface's keyed nearest is off the exact oracle by "
                  f"{store_err} (l2 distances {got_d} against {want_d})")
            c.close()

            with urllib.request.urlopen(
                    f"http://127.0.0.1:{composer.http_port}/data/features",
                    timeout=WAIT_S) as r:
                features = json.loads(r.read().decode())
            check([f["name"] for f in features] == ["emb"],
                  f"the dashboard lists {features}")
            print(f"[composer] store surface: {COMPOSER_STORE_ROWS} rows multiset, get "
                  f"bit-exact, keyed nearest excludes the key and matches the exact "
                  f"oracle's distances (max abs err {store_err:.3g}); the dashboard's "
                  f"/data/features lists emb", flush=True)
            t0 = time.perf_counter()
            launches = composer.stop()
            stop_s = time.perf_counter() - t0
        finally:
            composer.kill()
    nearest_calls = FS_WARM + FS_QUERIES + calls
    per_call = launches.get("fused_topk_search_v2", 0) / nearest_calls
    print(f"[composer] SIGTERM: stopped in {stop_s:.2f} s, exit code 0; K2 launches a "
          f"Nearest call {per_call:g} ({nearest_calls} calls); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(per_call >= 1, f"K2 launched {per_call} times a Nearest call in the composer")
    return launches


REPLACES = {"fused_topk_search": "embeddinghub_tpu/ops/pallas_topk.py:124",
            "fused_topk_search_v2": "embeddinghub_tpu/ops/pallas_topk.py:270",
            "fused_topk_search_large_k": "embeddinghub_tpu/ops/pallas_topk.py:124"}
SOURCES = {"fused_topk_search": "embeddinghub_tpu_torch/csrc/k1_scan.cu",
           "fused_topk_search_v2": "embeddinghub_tpu_torch/csrc/k2_scan.cu",
           "fused_topk_search_large_k": "embeddinghub_tpu_torch/csrc/k1_scan.cu",
           "fused_topk_search_v2_int8": "embeddinghub_tpu_torch/csrc/k2_scan.cu"}


def summary_entries(report, paths) -> list:
    """An entry per summary case.  launches: the count of the path the case
    belongs to (CASE_PATH: the main path's; the graph path's for the
    build's pool shapes, the writes path's for the waves', the quantized
    path's for the pools) of the wrapper that ran the case (``via``: K1's
    large-k route where ``exact_topk`` takes it); paths: each path's own.
    A main entry's max_abs_err is its kernel's largest over every case.  The int8 pools
    replace the reference's XLA scans, which their case names; K2's bf16
    scan, a pool's too, the Pallas K2."""
    entries = []
    cases = [*SUMMARY.values(),
             *((key[0], label) for key, (label, _) in QUANT_SUMMARY.items())]
    for name, label in cases:
        path = CASE_PATH[label]
        numbers = dict(report[(name, label)])
        if label == "main":
            numbers["max_abs_err"] = report[name]["max_abs_err"]
        via = numbers.get("via", name)
        entries.append({
            "name": name, "case": label, "route": "cuda", "source": SOURCES[name],
            "replaces": (numbers["replaces"] if name == "fused_topk_search_v2_int8"
                         else REPLACES[name]),
            "via": via, "launches": paths[path][via],
            "paths": {p: counts.get(via, 0) for p, counts in paths.items()},
            **{key: numbers[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_unit",
                "fma_bound_ms", "library_ms", "shape")}})
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # every f32 product in full f32
    from embeddinghub_tpu_torch.ops import _build
    from embeddinghub_tpu_torch.ops import fused_topk as F

    t0 = time.perf_counter()
    _build.library()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; kernel build {time.perf_counter() - t0:.1f} s",
          flush=True)

    rng = np.random.default_rng(SEED)
    x_host = rng.standard_normal((ROWS, DIMS), dtype=np.float32)
    report: dict = {}
    phase_kernels(torch, x_host, report)
    phase_quant_kernels(torch, x_host, report)

    # Each path: counts zeroed just before it, read just after it.
    paths = {}
    F.reset_launches()
    phase_main(torch, x_host, F.LAUNCHES)
    phase_wire(torch, x_host)
    paths["main"] = dict(F.LAUNCHES)
    flat = ("fused_topk_search", "fused_topk_search_v2", "fused_topk_search_large_k")
    needs = {"main": flat,
             "restore": flat,
             "offline": ("fused_topk_search_v2",),
             "graph": ("fused_topk_search",),
             "writes": ("fused_topk_search",),
             "cluster": ("fused_topk_search", "fused_topk_search_large_k"),
             "quantized": ("fused_topk_search_v2_int8", "fused_topk_search_v2"),
             "sharded": ("fused_topk_search", "fused_topk_search_v2_int8"),
             "featurestore": ("fused_topk_search_v2",),
             "crash": ("fused_topk_search",),
             "composer": ("fused_topk_search_v2", "fused_topk_search")}
    for path, run in (("restore", lambda: phase_restore(torch, x_host, F.LAUNCHES)),
                      ("offline", lambda: phase_offline(torch, x_host))):
        F.reset_launches()
        run()
        paths[path] = dict(F.LAUNCHES)
    # the graph path builds and saves the graph (phase 8) and the writes path
    # writes into it after a reopen (phase 9)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        ctx = {}
        try:
            F.reset_launches()
            ctx = phase_graph(torch, F.LAUNCHES, Path(tmp) / "store")
            paths["graph"] = dict(F.LAUNCHES)
            F.reset_launches()
            phase_writes(torch, F.LAUNCHES, ctx)
            paths["writes"] = dict(F.LAUNCHES)
        finally:
            close_graph(torch, ctx)
    graph_rows = (ctx["train"], ctx["test"])  # phase 12 (c) builds on them too
    # the cluster path: the 4M cluster-routed build (phase 10)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as tmp:
        F.reset_launches()
        phase_cluster(torch, F.LAUNCHES, Path(tmp) / "store")
        paths["cluster"] = dict(F.LAUNCHES)
    # the quantized path: the flat-bf16/int8/int8x2 stores and Deep-10M (phase 11)
    F.reset_launches()
    deep = phase_quantized(torch, x_host, F.LAUNCHES)
    paths["quantized"] = dict(F.LAUNCHES)
    # the sharded path: the sharded engines on four shards of the card (phase 12)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        F.reset_launches()
        phase_sharded(torch, x_host, F.LAUNCHES, deep, graph_rows, Path(tmp))
        paths["sharded"] = dict(F.LAUNCHES)
    del deep, graph_rows
    # the feature store's vector path: ff.Client -> materialization -> the
    # engine vector store -> nearest (phase 13)
    F.reset_launches()
    fs = phase_featurestore(torch, x_host, F.LAUNCHES)
    paths["featurestore"] = dict(F.LAUNCHES)
    # the crash path's and the composer path's kernels run in subprocesses,
    # which report them as they stop
    paths["crash"] = phase_crash(torch, x_host)
    paths["composer"] = phase_composer(torch, x_host, fs)
    del fs
    for path, counts in paths.items():
        print(f"[{path}] launches on the {path} path: {counts}", flush=True)
        for name in needs[path]:
            check(counts.get(name, 0) > 0, f"{name} was not launched on the {path} path")

    print(json.dumps({"kernels": summary_entries(report, paths)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
