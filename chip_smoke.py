#!/usr/bin/env python3
"""Drive the PyTorch port's SIMILAR paths once on one NVIDIA GPU: the
auto-IVF path, then the brute-force pooled, int8 and binary routes, PQ and
TT collections and the ANN index APIs (IVF, HNSW, saved indexes), a
checkpoint and rollback of a loaded store with blob storage and the LLM
cache, then a 3,072-d binary collection, then the hybrid graph + vector
query; serve the auto-IVF and brute-force corpora over HTTP and over
gRPC (Execute, the Points plane, gRPC-web) to concurrent clients, and
the brute-force corpus from three shard servers behind a scatter-gather
coordinator and from a mesh of four logical devices of the card; run the
shell.

Usage, from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit (nvcc)::

    python3 chip_smoke.py [--seed 0] [--rows 4194304] [--pooled-rows 1048576]
        [--wide-rows 262144]

Phases (each raises on failure; exit code 0 only if all pass):

1. print the card's name and power limit (nvidia-smi), build the CUDA
   kernels from neumann_tpu_torch/csrc (nine sources, one nvcc each) and
   print the build time; build and load the native lexer and parser
   (neumann_tpu_torch/native/*.cpp), fail if either is missing, and time
   the parse of 64 unseen SIMILARs of 768 and of 3,072 floats through the
   native entry and the pure-Python parser (medians, equal ASTs);
2. hold each kernel against its plain PyTorch version on the card at
   its path's shapes, timing both with CUDA events (probe: 32 queries x
   81 probes x 1,024-row windows x 768, and 1 query, phase 4's single
   launch, also by torch.profiler; batched top-2: 4,096 windows x
   64 slots; int8 scores: 64 x 1,048,576 x 768, and 1 x 524,288 x 768,
   one block of the int8 euclidean scan's single query; int8 and f32 pooled
   bits: 8 and 1,024 queries x 1,048,576 x 768 at pool 512, the f32
   kernel's 1,024 on the TF32 tensor cores as split products, bound by
   its three TF32 passes with the FFMA's bound beside; hamming:
   1,024 and 1 queries x 131,072 rows x 24 words, the TOP 65 route's
   launch, bit-exact; hamming top-10: 1,024 and 1 queries x 1,048,576
   rows x 24 words with 1 % dead rows, scores and ids equal; both hamming
   kernels bound by the card's 1-bit tensor-core rate, measured by a bare
   loop, and again at 96 words (3,072-d): both at 64 queries x 131,072
   rows, the distances at 1 query x 131,072 rows (phase 10's TOP 65
   launch), the top-10 at 1 and 256 queries x 262,144 rows (phase 10's
   single and batch launches); the batched top-2 probe again at d 4,096,
   512 windows; the f32 pooled bits again at phase 11's FIND launch, 1
   query x 262,144 rows at pool 128; the ADC scan (row 8) at 1,024, 8
   and 1 queries x 1,048,576 rows x 96 subspaces, in its gathered mode at
   64 queries x 16 blocks of 2,048, and at 64 x 262,144 x 384: its scores
   mode bit for bit beside one ``F.embedding_bag`` call for the same
   sums, its select mode (top-10 inside the kernel) equal to its plain
   version beside the scores mode + ``_topk_stable``; phases 14 and 15
   add the shapes their batches launch); the batched probe in top-1 mode
   (``batched_probe_top1``, the launch of the top-1 route that phase
   17b calls) at the top-2 shape, bit for bit; the exact int8 scan of
   the delta plane (row 9, ``int8_exact_topk``) at A17's 419,430 filled
   slots x 768, Q 1, 16, 17 and 1,024, k 10 and 64 (select mode) and 65
   (scores mode), 1 % dead rows and a block of rows copied 4 times in a
   row: scores within 1e-5 of its plain version, ids equal but at near
   ties, copies in ascending rows; its query split into three bf16
   parts exact on the card, and its few-query and batch kernels'
   scores (Q 1, 16 and 17) bit-equal over the plane; timed at Q 1,024
   and 1 beside the plain version and ``torch.matmul`` (TF32 off) for
   the product alone, bound by the three bf16 passes on the tensor
   cores; the non-fast batched first pass (row 10, ``ivf_window_topm``)
   at A17's TOP 65 batch (4,096 windows of 1,024 random int8 rows x 768,
   1 % dead, 1,024 queries x 81 random probes, q_cap 64, m 152, a row's
   32 copies met by 4 queries) and at m 1,024, Q 64 (q_cap 16), windows
   of 4,096 rows and d 4,096: scores and positions bit-equal to its plain
   version on every filled slot, equal scores in ascending positions;
   each timed beside the plain version, bound by its bytes;
3. generate a 4,194,304 x 768 corpus from --seed with numpy (4,096
   N(0,1) centres + sigma 0.25 noise) and load it with
   ``router.vector.ingest_matrix``; the int8 planes that the index build
   (phase 4's first SIMILAR) quantizes on the card with
   ``EmbeddingSlab.host_int8`` are held, 65,536 rows of each, to the
   CPU's recomputation bit for bit;
4. with every launch count at 0: 64 ``router.execute("SIMILAR [...]
   TOP 10")`` queries (the first builds the IVF index and is timed on
   its own; p50/p99 over the rest), then ``router.vector.batch_search``
   on 1,024 queries (QPS); read the launch counts;
5. recall@10 of both routes against the port's exact f32 scan over all
   rows (each >= 0.95), and both kernels launched by the main path;
6. re-embed one key, search with the new vector, that key comes first;
17. on the same router and rows (counted: every count at 0 before each
    part, read after it):
    b. 1,024 queries ``TOP 65`` through ``router.vector.batch_search``
       (k_ivf 146 > 128: ``search_batched``'s non-fast branch, row 10's
       exact int8 dots and top-152 of each probed (query, window) in one
       launch, 1,184 candidates a query to the rerank); QPS (median of the last 3
       of 4 calls), recall@10 of the first ten hits >= 0.95 against the
       exact scan, recall@65 and the overlap with the latency path's hits
       (the same queries in batches of ``ivf_auto_max_batch``) recorded;
       the first pass (and again with row 10's plain version in its
       place), the pre-selection and the rerank timed on the inputs the
       route gave them (CUDA events, kernel launches from torch.profiler),
       the first pass's bound, one batch call profiled;
       then the top-1 batched route (``batched_ivf_topk(fused="pallas",
       presel=0)``, pool expansion in the rerank), which no entry point
       of the port reaches yet, called by this script at TOP 10, recall
       >= 0.95. Counted apart: the TOP 65 route (it must launch row 10
       and no other hand kernel, and never run row 10's plain version),
       the latency-path comparison (row 1), the top-1 call (row 2's top-1
       mode);
    c. an index over A's int8 rows (the engine's layout, shared; the
       engine's own index is not mutated) takes 419,430 new rows of the
       mixture through ``add`` (chunks of 65,536) and loses 41,943 old and
       new ids through ``delete``; 64 singles and a batch of 1,024 search
       it: recall@10 >= 0.95 against one ``int8_exact_topk`` over the
       main and added rows in a single plane (multipliers computed
       there, the phase's own deleted ids masked: not the index's delta
       scan or merge; the plain version, not the kernel), no deleted id
       back, 1,024 added rows (and 64
       singly, and 4 ``TOP 65`` singles: row 9's scores mode) first
       for their own vectors; the delta scan (row 9 over the filled
       slots) must launch in both modes, and is timed at Q 1,024 and 1
       on the plane beside its plain version and ``torch.matmul``;
       ``compact`` (the live ids kept), the same searches; seconds of
       each step and the first search after it;
   then release that router.
7. the default pooled route (BASELINE configs 2 and 3): a second router
   with 1,048,576 x 768 rows of the same recipe, loaded by
   ``store_embedding(key, v, {"cat": i % 16})`` under ``bulk_ingest()``
   (capacity 2^20, so the gate picks pool 512 over 2,048 pools); counted:
   64 single SIMILARs (p50/p99), a batch of 1,024 (QPS), 16 SIMILARs
   WHERE cat = 3; recall@10 of each against the exact f32 scan (masked
   for the filtered ones) >= 0.95, every filtered hit in cat 3;
8. an int8 collection of the same rows (``CREATE COLLECTION q8 ...
   QUANTIZATION int8``, ``store_in_collection``); counted: 64 single
   SIMILARs IN q8 and a ``batch_search_ns`` of 1,024 on the int8 pooled
   route (recall@10 >= 0.95 against the f32 scan), 16 SIMILARs IN q8
   METRIC euclidean on the int8 scan (ids equal to the plain
   ``int8_topk_scan`` on the card, except at equal scores);
9. a binary collection of the same rows; counted: 64 single SIMILARs
   and a batch of 1,024 (the fused hamming top-k), 4 SIMILARs TOP 65 and
   a ``batch_search_ns`` of 1,024 at TOP 65 (above its cap:
   hamming_scores, 8 launches of 1,024 x 131,072 a batch, and a keyed
   merge); each query's ids and distances equal to the plain hamming
   top-k's, in the same order (for the TOP 65 batch on a fixed sample of
   64 queries); then the 64 single SIMILARs again, parsed now (p50
   without the parse);
10. a 3,072-d binary collection (W 96): 262,144 rows of the same recipe
    in 3,072-d, ``store_in_collection`` under ``bulk_ingest()``; counted:
    8 single SIMILARs TOP 10, 2 TOP 65 and a batch of 256 at TOP 10 (four
    calls, QPS over the median of the last three, as every batch), ids
    and distances equal to the plain hamming top-k's, in order.
11. the hybrid query (BASELINE config 4; cell F), a router of its own:
    262,144 entities ``{"tier": i % 16}`` of the same recipe through
    ``unified.create_entity`` under ``bulk_ingest()``, 1,048,576 random
    directed ``rel`` edges and 8 hubs of 500 random out-neighbours through
    ``graph.batch_create_edges``; counted: 64 ``SIMILAR [...] TOP 10
    CONNECTED TO 'hub'`` (a hub's neighbourhood is a sparse mask: the
    exact flat scan), 8 ``NEIGHBORS hub BOTH BY SIMILARITY LIMIT 10``, 4
    ``FIND NODE entity WHERE tier = 3 SIMILAR TO [...] LIMIT 10`` (8 rows
    in every pool of 128: the f32 pooled route, which must launch), then
    PageRank, connected components and BFS from a hub on the card. The
    hybrid and NEIGHBORS hits equal a float64 numpy scan over the masked
    rows (keys in order, scores within 1e-5; two keys may trade places
    only when their exact scores are less than 1e-6 apart, counted as
    ``hybrid_swaps``), FIND reaches recall@10 >= 0.95 with every hit in
    tier 3, the components are scipy's partition, the BFS levels scipy's
    unweighted shortest paths, PageRank within rtol 1e-4 of a float64
    power iteration. Then CREATE TABLE, 65,536 rows INSERTed in 16
    statements, a ``SELECT ... WHERE`` equal to numpy, ``FIND ROWS``.
12. serving (at the end of phases 4-6 and 7-9, on their routers):
    a. A: ``router.warmup()`` (seconds, calls), batched serving on, a
       ``RestServer`` on 127.0.0.1:0, and 512 ``SIMILAR [...] TOP 10``
       POSTed to /query from 32 client threads (a connection per
       request); served p50 / p99, QPS, batches and mean cohort size;
       every response 200, recall@10 >= 0.95, mean cohort above 1;
    b. B-D: the same run on the default namespace (f32 pooled), ``IN
       q8`` (int8) and ``IN bits`` (binary: the plain hamming top-k's
       ids and distances in order), 16 served ``WHERE cat = 3`` (every
       hit in cat 3), a cohort with an ``in`` filter on a list submitted
       straight to a ``QueryBatcher`` and then a plain query, and 64 REST
       Points queries on q8 (no batcher), with their p50. Each served
       kernel (rows 2, 5, 6, 7) must launch.
13. samples/knowledge-base.nql through the port's shell (plain theme,
    ``--wal-dir`` in a temporary directory) on a CUDA router and on a CPU
    router: equal text, no statement answered with an error; ``doctor``
    reports the CUDA device.
14. PQ and TT collections (cell G; run after phase 12b, on phases 7-9's
    rows): a ``QUANTIZATION pq`` collection of all 1,048,576 rows
    ``{"cat": i % 16}`` (its first SIMILAR trains the 96-subspace
    codebook and encodes, timed apart); counted: 64 singles, a batch of
    1,024, 4 ``WHERE cat = 3`` (the ADC kernel's select mode, row 8) and
    2 ``TOP 65`` (its scores mode), hits equal to the plain ADC + top-k
    on the engine's codes, keys in order, every filtered hit in cat 3;
    the batch must be one select launch (launch counter) and allocate
    less than a quarter of its [Q, N] scores; row 8 timed in both modes
    at the batch's launch shape, and one batch call profiled; a standing
    check of its select mode at one query (``pq_select_repeat``: 10,880
    launches over the 1,088 queries' own tables, each equal to the
    scores mode + ``_topk_stable``, and a count of the queries whose
    one-query tables differ from a batch's); then a
    ``QUANTIZATION tt`` collection of the
    first 262,144 rows (its first SIMILAR decomposes them on the card):
    16 singles and a batch of 256, hits equal to the exact scan of the
    reconstructed rows, 256 sampled rows within 1e-5 relative of the
    numpy ``tt_decompose``. recall@10 against the exact f32 scan (L2 for
    pq, cosine for tt) recorded, not limited.
15. the ANN index APIs (cell H): ``build_ivf_index(1024, 32)`` over the
    first 262,144 of the same rows in a default namespace (its padded
    layout of 1,048,576 rows would take 100 GiB; build seconds; p50 and
    recall@10 of 64 singles at nprobe 8 and 32, 16 of them equal to an
    exact float64 scan of their probed lists); ``IVFIndex`` in the pq
    storage (row 8's select mode, gathered, equal to its plain version)
    and the binary storage on 262,144 rows, row 8 timed in both modes at
    the shapes its batch and a single query launch; ``build_hnsw_index`` dense on
    4,096 rows, quantized on 2,048 and binary on 1,024 (host inserts,
    one row a call, the three graphs built at once in threads: insert
    rate, p50, recall@10); ``save_index`` ->
    ``load_index`` on a fresh router gives the same hits, for HNSW and
    for IVF.
16. the extended modules (run after phase 15, on phases 7-9's rows): a
    router of its own holds 262,144 of them ``{"cat": i % 16}`` (cut from
    1,048,576: 218 s there, past the phase's 150 s), an int8 and a
    binary collection of 262,144 and an ``events`` table; EXPLAIN of a
    SIMILAR on each route (pooled, ``WHERE cat = 3``, int8, binary) names
    the kernel that route then launches; 16 SIMILARs a route and 4 ``WHERE
    cat = 3`` give their hits; ``init_checkpoints`` in a temporary
    directory, CHECKPOINT (seconds, snapshot bytes); 1,024 rows
    re-embedded by EMBED STORE, 48 of them to the routes' query vectors;
    a DELETE that takes an automatic checkpoint (seconds); the SIMILARs
    again put the re-embedded rows first; ROLLBACK (seconds), then
    counted: the SIMILARs (each route's first timed on its own: it
    rebuilds the device view) give the hits from before the checkpoint,
    keys equal and scores within 1e-5, the table's rows are back, and
    rows 5-7 launch; the directory is removed. ``enable_query_cache`` on
    that router: a repeated SIMILAR served from the cache with equal
    hits, searched again after a write. A 64 MiB blob from --seed (BLOB
    PUT / GET MB/s, VERIFY), deleted and brought back by ROLLBACK with
    equal bytes. CACHE INIT (10,000 entries, the 256-d default embedder,
    on the host) filled with 2,500 prompts from --seed, then 1,000
    lookups (half repeats, 3/10 with a word swapped): exact and semantic
    hit rates and p50s. Prints whether ``cryptography`` imports; the
    vault is host-only and is not driven on the card (its tests run on
    the CPU).
18. the chain and the cluster. 18a (at the end of phase 16, on its
    router: 262,144 rows and two collections of 262,144, cut from phases
    7-9's 3,145,728 keys, whose state root took 34-46 s to seed):
    ``init_chain(embedding_dim=768)``; a chain transaction
    EMBEDs new vectors for 1,024 existing keys and commits, 64 SIMILARs
    of them give their own keys first; a second re-embeds the same keys
    and ends in ROLLBACK CHAIN, the SIMILARs then give the hits they
    gave before it (keys equal, scores within 1e-5); CHAIN VERIFY,
    HEIGHT, TIP, HISTORY, SIMILAR, DRIFT and the codebook statements
    answer; row 6 launches. 18b: ``classify_pairwise_codes`` over 4,096
    deltas x 768 with key sets from a seeded vocabulary on the card,
    codes equal to a float64 classification but for pairs within 1e-5
    of a threshold (counted); its device function timed by CUDA events,
    its launches from torch.profiler, its bound. 18c: three
    TcpClusterNodes in this process on localhost sockets, each router
    on the card; a replicated CREATE COLLECTION … QUANTIZATION int8 and
    EMBED BATCHes of two rows load 256 rows of B's recipe through the
    leader (8 ClusterClients at once, rows a second); 64 SIMILARs a
    replica give their own keys first, row 4 launching on each. 18d:
    three ``python -m neumann_tpu_torch.chain.node --wal-dir …``
    processes on the card load the same rows from 8 ClusterClients
    through the leader; the leader is SIGKILLed at half the rows and
    the clients move to the node elected after it; every
    acknowledged key is read back by SIMILAR, its own key first, from
    both survivors, and from the killed node once restarted from its
    WAL directory and caught up; EXPLAIN SIMILAR … IN on each names row
    4's kernel. The nodes' logs go to chiprun_out/node_*.log.
19. serving over gRPC, right after 12a and 12b on their routers, each
    part counted from its first served request: a ``NeumannServer`` on
    127.0.0.1:0 started by ``serve()`` (the router's warm-up, which
    raises on a failure; batched serving on), the native points codec
    loaded (or the phase fails), ``Health`` naming the card. 19a (A): 32
    client threads, a ``NeumannClient.connect`` channel each, send 512
    ``SIMILAR [...] TOP 10`` through ``Execute`` (p50 / p99, QPS,
    batches, mean cohort above 1, recall@10 >= 0.95; the card's idle
    share from the same run under torch.profiler); one Points
    ``QueryBatch`` of 512 equal to ``router.vector.batch_search`` on
    the same matrix; rows 1 and 2 launch. 19b (B-D): the same ``Execute``
    run on the default namespace (row 6); a ``PointsPipeline``
    (QueryStream) of 512 pipelined queries on q8 answered through the
    batcher's completion callback (row 5; every future resolves,
    recall@10 >= 0.95); a ``QueryBatch`` of 512 on bits (row 7; ids
    and distances of the plain hamming top-k, in order); 16 Points
    queries with ``filter_json`` cat = 3 at once on the default
    namespace (q8's rows hold no metadata; every hit in cat 3, recall
    against the masked scan); 64 ``Execute`` over gRPC-web through a
    ``RestServer(grpc_web=server)``, each equal to the same statement
    sent alone over gRPC; rows 5, 6 and 7 launch.
20. scatter-gather (cell P; after 19b, on phase 7's rows and queries): a
    ``SemanticPartitioner(3)`` trained on the card over 65,536 of the
    rows places every row on a shard (``assign_batch``); the rows go to
    ``.npy`` files in a temporary directory, and three ``NeumannServer``
    processes of this checkout on the card (``_SHARD_WORKER``, logs in
    chiprun_out/shard_*.log) each memory-map theirs, load it through
    ``ingest_matrix``, warm up, set their launch counts to 0 and serve.
    The coordinator, a ``QueryRouter`` on the card, fans statements out
    through ``attach_planner`` over ``NeumannClient`` connections. 20a:
    64 ``SIMILAR [...] TOP 10`` (p50 / p99), each merge equal to the top
    10 of the shards' own answers asked directly (keys, scores, ties in
    shard order), recall@10 >= 0.95 against phase 7's exact scan of all
    rows; 20b: the semantic planner at nprobe 1, 2, 3 (p50, recall; at 3
    the hits of 20a); 20c: N_SERVED statements from 32 threads (QPS);
    20d: COUNT EMBEDDINGS equal to the rows; 20e: one shard SIGKILLed,
    16 SIMILARs each equal to the live shards' own merge. Each shard's
    launch counts come back on its stdin's request (the killed one's
    before the kill) and when its stdin closes: row 6 must launch in
    every shard of at least 262,144 rows, whose EXPLAIN names it, and a
    smaller shard must take the exact scan.
21. the mesh (cell M; after phase 20, on phase 7's rows and queries):
    ``NEUMANN_MESH_DEVICES=4`` for this phase only, so the engine's
    mesh is four logical devices of the card; phases 7-9's router,
    which holds the rows ``{"cat": i % 16}`` and an int8 collection of
    them (a router of its own would load them again: 54-68 s), places
    them at its first search; every SIMILAR through ``router.execute``,
    counted from 21a to 21g (``launches_mesh``): 21a 64 singles and a
    batch of 1,024 on the f32 ``ShardedCorpus`` (hits equal to the exact
    f32 scan: scores within 1e-5, ids wherever no two scores are within
    1e-5); 21b the same IN q8 (the int8 ``ShardedCorpus``: row 5 on each
    shard, then the rerank; recall@10 >= 0.95); 21c 16 IN q8 METRIC
    euclidean (row 4; recall against the exact euclidean scan); 21d 16
    ``WHERE cat = 3`` (every hit in cat 3, recall against the masked
    scan); 21e ``ivf_auto_threshold`` set to the row count: the
    ``ShardedIVFCorpus`` placement (first query = build, 64 singles, a
    batch of 1,024; recall@10 against the f32 scan >= 0.85, the
    reference's numerics, and >= 0.95 against the exact scan of the
    placement's own rows); 21f 64 keys re-embedded, each new vector's key
    first on the IVF and the f32 placements, neither rebuilt; 21g
    ``search_batched`` on the placement, fast (row 2 top-2) and not, over
    1,024 stored rows: the non-fast top-1 equal to ``search``'s (scores
    within 1e-5); the fast form's hits equal to its run through the plain
    batched probe, its top-1 equal to ``search``'s for >= 97 % of the
    rows (its pool-winner probes pick other windows), ``search``'s the
    row itself for >= 99 %. Every placement has 4 shards; rows 2, 4 and 5
    launch. Then the merge equals each shard's own answer concatenated in
    shard order and cut by ``_topk_stable`` (repeated queries, stored
    rows, and a small corpus with rows copied across shards), and rows 2,
    4 and 5 are held bit for bit to their plain versions at the launches
    the shards make (captured from the path), timed with CUDA events
    beside their bounds (``_mesh`` / ``_mesh_q1`` in the kernels line).
22. equal scores (after phase 16, on phase 7's rows and queries; a
    router of its own): 262,144 of the rows each stored 4 times (row i
    holds vector i % 262,144, so the copies sit in separate pools) by
    ``ingest_matrix``, 1,048,576 keys; and an int8 collection of
    131,072 of them 4 times, ``{"cat": i % 16}``, stored row by row (the
    only way into a collection with metadata; 1,048,576 such rows would
    take the phase's time alone). Counted (``launches_ties``): 64 singles
    and a batch of 1,024 on each (the pooled f32 and pooled int8 routes
    and their rerank), 4 ``WHERE cat = 3`` IN the collection (pooled int8
    under the mask) and 4 METRIC euclidean on the store (the exact scan),
    and 4 paginated walks of 4 pages of 10 (METRIC dot: the exact scan,
    whose top-k are prefixes of each other; a pooled route's candidate
    count grows with k + offset). Every top-10 meets groups of
    four equal scores across its 10th place. And a store of its own
    holding 131,072 of the rows 4 times in a row (524,288 keys), searched
    by a batch of 64 METRIC euclidean: the exact scan in blocks of 65,536
    rows, each block's [64, 65,536] scores above ``_SORT_MAX`` (the
    int64 keys' select), with copies in one block; some top-10 must meet
    equal scores across the 10th place (``ties_run_straddles``). Gate:
    each hit list is the one the plain version gives: the scores over
    the same candidates, recomputed on the card from the route's first
    pass (or the exact scan's ``score_all``), ordered on the host by
    ``np.lexsort`` (``host_top``: equal scores by ascending candidate
    slot, the first pass's order, or the row for the exact scan), apart
    from the port's selections (``ties_mismatches`` 0); the walks' pages
    are disjoint and together the top-40.

Every kernel must launch in the counted phases. After phase 4 it
profiles 8 single SIMILARs and one batch (cProfile on the host,
torch.profiler on the device) into chiprun_out/profile_*.txt, and the
first SIMILAR (the build) into chiprun_out/profile_build_host.txt;
phases 7 and 9 profile their single queries and batch the same way,
phase 8 its batch, phase 9 also its TOP 65 batch (device time of the
hamming distances against the keyed merge's), phase 11 8 hybrid
queries, one FIND and the three graph analytics; phases 12a and 12b
profile a served run of A and of B (one client under cProfile,
profile_served_*_host.txt; 32 clients under torch.profiler: the device
idle share of serving). Device times come from CUDA-only traces, and
are null (with a log line) where a trace holds fewer records of the hand
kernels than the traced run's launch counts (``trace_kernel_ms``).

Prints the metrics JSON line, the kernels JSON line, the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Everything is also
written to chiprun_out/chip_smoke.json. Fails (non-zero, no result)
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

DIM = 768
N_CENTRES = 4096
SIGMA = 0.25
TOP_K = 10
N_SINGLE = 64
N_BATCH = 1024
MIN_RECALL = 0.95
# probe: f32 sums in another order; for unit rows the worst case is
# d * 2^-24 ~= 4.6e-5
PROBE_ATOL = 1e-4
# phases 7-9: rows of the brute-force corpus, metadata categories, and
# the pool the default gate picks at 2^20 rows
POOLED_ROWS = 1 << 20
N_CATS = 16
FILTER_CAT = 3
N_FILTERED = 16
POOL = 512
# f32 pooled kernel vs plain: the dots are f32 sums in another order,
# and a decoded winner keeps 23 - log2(pool) mantissa bits, so a winner
# score may move by one packed step (pool * 2^-22 for scores in [1, 4))
# plus 1e-6 for the sums; winning rows must agree on >= 99 % of pools
F32_POOLED_ATOL = POOL * 2.0 ** -22 + 1e-6
F32_POOLED_MIN_AGREE = 0.99
KERNELS = {
    "ivf_probe": dict(source="neumann_tpu_torch/csrc/ivf_probe.cu",
                      replaces="neumann_tpu/ops/pallas_kernels.py:212"),
    "batched_probe": dict(source="neumann_tpu_torch/csrc/batched_probe.cu",
                          replaces="neumann_tpu/ops/pallas_kernels.py:329"),
    "batched_probe_top1": dict(
        source="neumann_tpu_torch/csrc/batched_probe.cu",
        replaces="neumann_tpu/ops/pallas_kernels.py:329"),
    "int8_dot_scores": dict(source="neumann_tpu_torch/csrc/int8_scores.cu",
                            replaces="neumann_tpu/ops/pallas_kernels.py:162"),
    "int8_pooled_bits": dict(source="neumann_tpu_torch/csrc/int8_scores.cu",
                             replaces="neumann_tpu/ops/quant.py:371"),
    "f32_pooled_bits": dict(source="neumann_tpu_torch/csrc/f32_pooled.cu",
                            replaces="neumann_tpu/ops/quant.py:525"),
    "hamming_scores": dict(source="neumann_tpu_torch/csrc/hamming.cu",
                           replaces="neumann_tpu/ops/pallas_kernels.py:40"),
    "hamming_topk": dict(source="neumann_tpu_torch/csrc/hamming_topk.cu",
                         replaces="neumann_tpu/ops/pallas_kernels.py:90"),
    "pq_adc": dict(source="neumann_tpu_torch/csrc/pq_adc.cu",
                   replaces="neumann_tpu/ops/pq.py:116"),
    "pq_adc_select": dict(source="neumann_tpu_torch/csrc/pq_adc.cu",
                          replaces="neumann_tpu/ops/pq.py:111"),
    "int8_exact_select": dict(source="neumann_tpu_torch/csrc/int8_exact.cu",
                              replaces="neumann_tpu/ops/quant.py:402"),
    "int8_exact_scores": dict(source="neumann_tpu_torch/csrc/int8_exact.cu",
                              replaces="neumann_tpu/ops/quant.py:402"),
    "ivf_topm_select": dict(source="neumann_tpu_torch/csrc/ivf_topm.cu",
                            replaces="neumann_tpu/ops/ivf.py:1307"),
}
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# a kernel's bound is the larger of its bytes (each input read once, each
# output written once) over HBM_BYTES_PER_S and its operations over the
# peak of their type
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
# dense bf16 on the tensor cores (row 9 runs its f32 products there as
# three bf16 passes; its record keeps the FFMA bound beside)
BF16_FLOPS_PER_S = 989e12
# dense TF32 on the tensor cores (row 6 above 16 queries runs its f32
# products there as three TF32 passes; its record keeps the FFMA bound
# beside)
TF32_FLOPS_PER_S = 495e12
# hamming's popcounts have no published peak: the issue rate of the CUDA
# C++ Programming Guide's throughput table (16 POPC per SM per clock) at
# 132 SMs and the 1,980 MHz boost clock, reported beside the bytes bound
POPC_PER_S = 16 * 132 * 1.98e9
# the ADC scan's operations are table lookups in shared memory: 32 banks,
# one 4-byte word each a clock, a SM, at 132 SMs and the same clock
SMEM_LOOKUPS_PER_S = 32 * 132 * 1.98e9
# why a kernel has no one-call PyTorch yardstick (library_ms null)
NO_LIBRARY = {
    "ivf_probe": "no one PyTorch call scores windows gathered by probe "
                 "lists (a gather, then a product)",
    "batched_probe": "no one PyTorch call scores per-window query tables "
                     "into packed top-2 winners",
    "batched_probe_top1": "no one PyTorch call scores per-window query "
                          "tables into packed pool winners",
    "hamming_scores": "no PyTorch call takes packed sign bits (cdist p=0 "
                      "needs them unpacked to floats)",
    "hamming_topk": "no PyTorch call takes packed sign bits, and none "
                    "selects a top-k without the [Q, N] distances",
    "ivf_topm_select": "no one PyTorch call scores windows against "
                       "per-window query tables and selects each slot's "
                       "top-m",
}
# row 8's yardstick: one PyTorch call for the same sums (adc_library)
ADC_LIBRARY = ("F.embedding_bag(idx, w, mode='sum'): bags of a row's M "
               "codes offset 256 a subspace (gathered: and M * 256 a query) "
               "into the tables; sums only, no negation or mask")
ADC_SELECT_LIBRARY = ("no one PyTorch call selects the top-k of ADC sums "
                      "without the [Q, C] sums; F.embedding_bag gives the "
                      "sums alone (pq_adc's library_ms), scores_topk_ms the "
                      "scores mode and _topk_stable over them")
# phase 2: rows of one hamming_scores launch on the binary route above the
# fused kernel's k cap (ops/quant.hamming_topk's block); phase 9: queries
# of the TOP 65 batch held against the plain top-k
HAMMING_BLOCK = 131_072
N_WIDE_SAMPLE = 64
# phase 10: a 3,072-d binary collection (text-embedding-3-large's width),
# 3.2 GB of f32 rows on the card
WIDE_DIM = 3072
WIDE_ROWS = 1 << 18
N_WIDE_SINGLE = 8
N_WIDE_TOP65 = 2
N_WIDE_BATCH = 256
# phase 11: the hybrid query (BASELINE config 4, bench_all.py config 4),
# cell F. bench_all's 1,048,576 entities are cut to 262,144: the host
# loads an entity (graph node + entity tensor + embedding) in about 44 us
# and an edge in about 15 us, so 1M entities and 4M edges would take some
# 100 s to load; 262,144 entities and 1,048,576 edges take about 30 s.
# The rows are still enough for the pooled gate (256 Ki rows, 2,048 pools
# of 128), which FIND's WHERE tier = 3 (8 rows in every pool) opens
HYBRID_ROWS = 1 << 18
HYBRID_EDGES = 1 << 20
HYBRID_POOL = 128
N_HUBS = 8
HUB_DEGREE = 500
N_HYBRID = 64
N_FIND = 4
N_TIERS = 16
FIND_TIER = 3
SQL_ROWS = 1 << 16
SQL_CHUNK = 4096
HYBRID_ATOL = 1e-5
# two hits may trade places when their exact scores are this close
SWAP_TOL = 1e-6
PAGERANK_RTOL = 1e-4
# phase 1: unseen SIMILAR statements timed through the native parse and
# the pure-Python parse, at 768 and 3,072 floats
N_PARSE = 64
# phases 12a-12b: statements served over HTTP (batched serving on) from
# N_CLIENTS client threads, each request on a connection of its own (the
# REST handler speaks HTTP/1.0); N_POINTS REST Points queries; a served
# run under cProfile from one client and one under torch.profiler.
# N_SERVED was cut from 1,024 to keep the run inside its time limit on a
# slower host (about 8 served runs of 4-6 s each at 1,024)
N_SERVED = 512
N_CLIENTS = 32
N_POINTS = 64
N_PROFILED = 64
IN_CATS = (1, 3)
# phase 13: the sample script the shell runs, and how far a printed
# float may move between the card and the CPU (f32 sums in another
# order: a few ulps, which 6-digit output can show as one digit)
SHELL_RTOL = 1e-5
SAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples",
                      "knowledge-base.nql")
# the counted phases' launch counts: A-D, phase 10's wide collection,
# phase 11's hybrid queries (F) and the served phases 12a (A) and 12b
# (B-D); phase 17b's TOP 65 route, the same queries on the latency path,
# and the top-1 batched route that the script calls itself (no entry
# point of the port reaches it), each counted apart
ROUTES = ("ivf", "top65", "top65_latency", "top1_direct", "delta",
          "pooled", "int8", "binary", "wide", "hybrid", "served_ivf",
          "served_brute", "pq", "tt", "ann", "rollback", "chain", "cluster",
          "served_grpc_ivf", "served_grpc_brute", "sharded", "mesh", "ties")
# phase 17 (on A's corpus): the TOP 65 batch (k_ivf 146 > 128, the
# non-fast batched route), and an index over A's rows that takes 10 %
# more rows through add (in chunks of 65,536) and loses 1 % of A's row
# count through delete, searched before and after compact
TOP65 = 65
PHASE17_BATCH = N_BATCH
DELTA_FRAC = 0.1
DELTA_CHUNK = 1 << 16
DELETE_FRAC = 0.01
# phase 17c: the delta plane's TOP 65 singles (row 9's scores mode)
N_DELTA_TOP65 = 4
# phases 2 and 17c: row 9, the exact int8 scan of the delta plane. Phase
# 2 holds it to its plain version at A17's filled delta slots x DIM, each
# of EXACT_QS queries (the singles, both sides of its stream / batch
# switch, the delta batch) and EXACT_KS (both sides of its select cap),
# EXACT_DEAD of the rows dead and a block of EXACT_COPY_ROWS rows from
# EXACT_COPY0 (its first EXACT_SAME equal) copied EXACT_COPIES times in a
# row, across its tiles and, for the equal rows, every k-th place: scores
# within EXACT_TOL, ids equal but where another plain score of the query
# stands within EXACT_TOL, copies in ascending rows with no tolerance
EXACT_ROWS = int(4_194_304 * DELTA_FRAC)
EXACT_QS = (1, 16, 17, N_BATCH)
EXACT_KS = (TOP_K, 64, TOP65)
EXACT_DEAD = 0.01
EXACT_COPY0 = 100_001
EXACT_COPY_ROWS = 32
EXACT_SAME = 17
EXACT_COPIES = 4
EXACT_TOL = 1e-5
EXACT_DESIGN = ("the f32 query split into three bf16 parts (hi + mid + lo "
                "== qf) against int8 rows exact in bf16, on wgmma "
                "(m64nNk16, f32 accumulation; rows on M from registers, "
                "converted there by two logic ops and a bf16x2 subtraction "
                "a pair; query parts on N in shared memory); a block of two "
                "warpgroups over 128 rows x 8 or 16 queries (Q <= 16, two "
                "blocks a SM; at d <= 768 the block splits the queries "
                "itself and keeps their parts) or x 128 (one a SM), its "
                "first thread filling a TMA ring of 64-K stages; each "
                "stage's 12 products (lo, mid, hi) in a fresh accumulator, "
                "added to the running sum by one rounded add: one order for "
                "every (query, row); select mode: each warpgroup's passing "
                "keys buffered in shared memory and merged by a warp a "
                "query into its list in the keys output once a buffer "
                "fills, one torch.topk over the lists")
EXACT_LIBRARY = ("torch.matmul(qf, rows.float().t()) with allow_tf32 False, "
                 "the product alone (rows converted once, outside its time; "
                 "no mask or selection)")
# phases 2 and 17b: row 10, the non-fast batched first pass. Phase 2
# holds it to its plain version, bit for bit on every filled slot, at
# A17's TOP 65 batch (TOPM_WINDOWS windows of TOPM_WINDOW random int8
# rows x DIM, TOPM_DEAD of them dead, N_BATCH queries x TOPM_NPROBE
# random probes, q_cap TOPM_Q_CAP, m TOPM_M = min(k_ivf + 6, window) with
# k_ivf = 2 * TOP65 + 16) and at TOPM_EDGES: m up to the window, the
# smallest batch the route takes (Q 64, its default q_cap 16), windows of
# 4,096 rows (the kernel's chunks) over the same rows, d 4,096 (8 slots a
# block). TOPM_RUNS: (first row, rows) of two runs of copies of the row
# before them, each in its own window; TOPM_COPY_QUERIES queries are
# that row and probe its window. The first run fits in their top m, in
# ascending positions; the second is longer than TOPM_M, so their m-th
# key lies inside a run of equal scores and the kernel's cut takes its
# first rows by ascending position
TOPM_WINDOWS = 4096
TOPM_WINDOW = 1024
TOPM_NPROBE = 81
TOPM_Q_CAP = 64
TOPM_M = 2 * TOP65 + 16 + 6
TOPM_DEAD = 0.01
TOPM_RUNS = ((7 * TOPM_WINDOW + 100, 32), (23 * TOPM_WINDOW + 50, 200))
TOPM_COPY_QUERIES = 4
# suffix: (windows, window, d, queries, probes, q_cap, m)
TOPM_EDGES = {
    "_m1024": (TOPM_WINDOWS, TOPM_WINDOW, DIM, N_BATCH, TOPM_NPROBE,
               TOPM_Q_CAP, TOPM_WINDOW),
    "_q64": (TOPM_WINDOWS, TOPM_WINDOW, DIM, 64, TOPM_NPROBE, 16, TOPM_M),
    "_w4096": (TOPM_WINDOWS // 4, 4 * TOPM_WINDOW, DIM, 256, 20, 16, TOPM_M),
    "_d4096": (512, TOPM_WINDOW, 4096, 128, 16, 16, TOPM_M),
}
TOPM_DESIGN = ("one block a (probed window, group of 16 table slots; 8 at "
               "d 3,072 and 4,096), two blocks a SM up to d 4,096, a block "
               "whose first slot is empty exits; the group's int8 query "
               "rows gathered into shared memory by cp.async, the window's "
               "rows by TMA from a producer warp (128 rows x 64 bytes, "
               "64-byte swizzle, a 4-stage ring on full / empty mbarriers) "
               "on mma.sync.m16n8k32.s8 in 8 consumer warps (rows on M, "
               "slots on N); each score (two __fmul_rn, no contraction) "
               "stored as its 32-bit order-preserving image by row offset; "
               "a warp a slot: a radix select of the m-th image (8-bit "
               "digits, a shared histogram with warp-aggregated "
               "increments), the images above it and the first at it by "
               "ascending offset, only those m keys sorted in registers "
               "(bitonic, shuffles; m up to 256, above it the block sorts "
               "a slot's keys in shared memory); wider windows in "
               "1,024-row chunks merged by one torch.topk")
# phase 2's records: the main shape's keys bare, the other shapes' with a
# suffix
SHAPE_SUFFIXES = ("_q1", "_k64", "_q8", "_q32", "_w96", "_w96q1",
                  "_w96q256", "_d4096", "_hyb", "_ivf", "_m384", "_g_step",
                  "_h_step", "_h_tail", "_h_single", "_mesh", "_mesh_q1",
                  "_m1024", "_q64", "_w4096")
# row 7's design, named in its kernels-line entry beside each shape's
# plan (ops/kernels._hamming_groups)
HT_DESIGN = ("queries on M (16 a warp, up to 8 warps a block), rows on N "
             "from a 3-16 stage cp.async.bulk ring filled by a producer "
             "warp (full / ready / empty mbarriers; row popcounts by 4 "
             "helper warps, or by the one reader at one query tile), "
             "warp-local selection with no block barrier, row slices for "
             "blocks of fewer query tiles, k-th keys shared across blocks "
             "by 64-bit atomicMin")
# the wrappers a route's reference swaps for their plain versions
_PLAIN_SWAPPED = ("int8_dot_scores", "int8_pooled_bits", "f32_pooled_bits",
                  "hamming_scores", "hamming_topk", "pq_adc_scores",
                  "pq_adc_topk")
# phase 2 and phases 14-15: row 8, the ADC scan. The engine's codebook at
# 768-d has DIM // 8 subspaces; the kernel's design, named in its entry
PQ_M = DIM // 8
PQ_DESIGN = ("shared layout (full scan, Q >= 8): 8 queries and passes of "
             "4,096 rows a block of 512 threads, each code read once for "
             "the 8, tables as [m][code][4 copies][8 queries] so a warp's "
             "float4 lookups never conflict, a 3-stage ring (tables loaded "
             "once and stored 4 times, codes transposed to [M, N] and "
             "staged by cp.async) under full / empty mbarriers, 16 rows x "
             "4 queries "
             "of sums in registers in subspace order; lane layout (Q < 8, "
             "gathered): a query and 2,048 columns a block, a row a lane; "
             "select mode: each block's k best keys a query in shared "
             "memory, a buffer of 192 merged by a warp, k-th keys shared "
             "across blocks by 64-bit atomicMax")
# phase 14: SIMILARs above the select mode's k cap (the scores mode)
N_PQ_TOP65 = 2
# phase 14's standing check of row 8's select mode at one query (10
# launches for each of 1,088 queries' tables; about 9 s on an H100), and
# its sweep: Q 8, each k, the lane layout over the codes, over the codes
# repeated 4 times, and the gathered mode over PQ_SWEEP_CANDS candidates
PQ_REPEAT_LAUNCHES = 10_880
PQ_SWEEP_KS = (1, 10, 64)
PQ_SWEEP_Q = 8
PQ_SWEEP_ROUNDS = 16
PQ_SWEEP_CANDS = 8192
PQ_TOP65 = 65
# the CUDA kernels that each counted wrapper (kernels.LAUNCHES) runs once
# a launch, by their names in a torch.profiler trace; a trace that holds
# fewer of them than the wrappers counted in the traced run has lost
# records, and its device time is not measured (``trace_kernel_ms``)
TRACE_KERNELS = {
    "ivf_probe": ("ivf_probe_kernel",),
    "batched_probe": ("batched_probe_kernel",),
    "batched_probe_top1": ("batched_probe_kernel",),
    "int8_dot_scores": ("int8_kernel", "int8_tma_kernel"),
    "int8_pooled_bits": ("int8_kernel", "int8_tma_kernel"),
    "f32_pooled_bits": ("stream_kernel", "tf32_kernel"),
    "hamming_scores": ("hamming_few_kernel", "hamming_batch_kernel"),
    "hamming_topk": ("hamming_topk_kernel",),
    "pq_adc": ("pq_adc_kernel",),
    "pq_adc_select": ("pq_adc_kernel",),
    "int8_exact_select": ("exact_wgmma_kernel",),
    "int8_exact_scores": ("exact_wgmma_kernel",),
    "ivf_topm_select": ("ivf_topm_kernel",),
}
# row 8's kernels by name in a profile: the scan, and the select mode's
# threshold fill, codes transpose and tables interleave
ADC_KERNEL_NAMES = ("pq_adc_kernel", "transpose_codes", "interleave_tables",
                    "fill_empty")
# phase 14 (cell G): the pq collection takes phases 7-9's rows; the tt one
# their first TT_ROWS (the host decomposes nothing: the batched SVD runs on
# the card), TT_SAMPLE of them held to the numpy decomposition
TT_ROWS = 1 << 18
N_TT_SINGLE = 16
N_TT_BATCH = 256
N_PQ_FILTERED = 4
TT_SAMPLE = 256
TT_RTOL = 1e-5
# phase 15 (cell H): the legacy IVF index over the first IVF_ROWS of
# phases 7-9's rows at each nprobe (its layout pads every cluster to the
# largest: at 1,048,576 rows and 1,024 clusters the largest held about
# 34,000 rows, a 100 GiB buffer, so the rows are cut to a quarter);
# IVF_CHECKED queries a nprobe held to an exact scan of their probed
# lists; IVFIndex's pq and binary storages on IVF_INDEX_ROWS rows; HNSW
# graphs built on the host one row a call (the three at once, a thread
# each), cut from 1,048,576 rows to what fits beside the other phases in
# the run's time limit: on the card's host dense inserts ran at 130-160
# rows a second at 32,768 rows, binary ones at 38-41 a second at 8,192
# (251 s of phase at 32,768 / 16,384 / 8,192 rows, in a 1,081 s run), and
# at 126 and 48 a second at half those sizes on a slower host (131 s of
# graphs in a 1,224 s run), and a 1,048 s run at a quarter of them still
# ran past the 1,200 s limit on a slower host, so they build at an eighth
IVF_ROWS = 1 << 18
IVF_CLUSTERS = 1024
IVF_NPROBES = (8, 32)
IVF_CHECKED = 16
IVF_INDEX_ROWS = 1 << 18
IVF_INDEX_CLUSTERS = 256
IVF_INDEX_NPROBE = 16
HNSW_ROWS = 4096
HNSW_QUANT_ROWS = 2048
HNSW_BINARY_ROWS = 1024
# phase 16: the extended modules. A router of its own holds the first
# ROLLBACK_ROWS of phases 7-9's rows (default namespace, {"cat": i % 16};
# cut from 1,048,576, where the phase took 218 s by
# scripts/torch_extended_phase.py, past its 150 s) and the
# first ROLLBACK_SUB_ROWS in an int8 and a binary collection;
# N_ROLLBACK_SINGLE SIMILARs a
# route and N_ROLLBACK_FILTERED WHERE cat = 3 before a checkpoint and
# after the rollback; N_REEMBED rows re-embedded between the two, the
# events table's rows, a blob of BLOB_BYTES, CACHE_PROMPTS prompts of
# CACHE_WORDS words from a CACHE_VOCAB-word vocabulary and a replayed mix
# of CACHE_MIX lookups (half repeats, 3/10 one word swapped, the rest
# unseen). The cache's prompts were cut from 10,000 (a 30 s fill on the
# host) to keep the run inside its time limit on a slower host
ROLLBACK_ROWS = 1 << 18
ROLLBACK_SUB_ROWS = 1 << 18
N_ROLLBACK_SINGLE = 16
N_ROLLBACK_FILTERED = 4
N_REEMBED = 1024
N_EVENTS = 1024
ROLLBACK_ATOL = 1e-5
BLOB_BYTES = 64 << 20
CACHE_PROMPTS = 2_500
CACHE_WORDS = 24
CACHE_VOCAB = 4096
CACHE_MIX = 1000

# phase 18: the chain and the cluster. 18a on phases 7-9's router (B's
# rows): a chain transaction re-embeds N_CHAIN_KEYS keys and commits, a
# second ends in ROLLBACK CHAIN; N_CHAIN_SIMILAR SIMILARs of the new
# vectors before and after it (scores within CHAIN_ATOL)
N_CHAIN_KEYS = 1024
N_CHAIN_SIMILAR = 64
CHAIN_ATOL = 1e-5
# 18b: the pairwise consensus classification of N_DELTAS deltas whose key
# sets come from DELTA_VOCAB keys, held to float64 but for pairs within
# CONSENSUS_MARGIN of a threshold
N_DELTAS = 4096
DELTA_VOCAB = 1024
CONSENSUS_MARGIN = 1e-5
# 18c-d: three replicas load CLUSTER_ROWS rows of B's recipe through Raft
# (cut from 65,536: the load is held by the statements' parse, PERF.md
# §4; then from 1,024, whose loads, kill and catch-up took 152 s of a
# 1,048 s run and ran past the 1,200 s limit on a slower host) from
# CLUSTER_CLIENTS clients (more stall Raft's resends, ROADMAP §2
# tuning item 10). EMBED BATCH is outside the native parser's grammar,
# so the Python parser runs on the native lexer's tokens, whose cap
# (4,096) holds two rows of 768 floats a statement
CLUSTER_ROWS = 256
CLUSTER_BATCH_ROWS = 2
CLUSTER_CLIENTS = 8
N_CLUSTER_SIMILAR = 64
CLUSTER_TIMEOUT_S = 30.0
# the load's writes, retried on the next node: writes in flight at the
# leader when it is SIGKILLed came back only at their timeout (18d's 256
# rows took 36 s against 18c's 5 s at 30 s), so they wait less
CLUSTER_WRITE_TIMEOUT_S = 10.0
CLUSTER_DEADLINE_S = 600.0
# phase 20 (cell P): phase 7's rows placed on SHARD_SERVERS shard-server
# processes by a SemanticPartitioner trained (PARTITION_ITERS Lloyd
# steps) on PARTITION_SAMPLE of them; SIMILAR scattered by the
# coordinator's planner, fully and at nprobe 1..SHARD_SERVERS; N_SERVED
# statements from N_CLIENTS threads; N_DEGRADED after one shard's SIGKILL
SHARD_SERVERS = 3
PARTITION_SAMPLE = 1 << 16
PARTITION_ITERS = 20
N_DEGRADED = 16
SHARD_START_S = 300.0
# phase 21 (cell M): phase 7's rows on a mesh of MESH_SHARDS logical
# devices of the one card (NEUMANN_MESH_DEVICES, this phase only),
# batches of MESH_BATCH of its queries; MESH_FRESH keys re-embedded in part f; the merge gate's small corpus of
# MESH_COPY_ROWS rows a shard
MESH_SHARDS = 4
MESH_BATCH = N_BATCH
# the sharded IVF ranks its candidates by their int8 rows times scale /
# ||f32 row|| (the JAX class's design: no residual plane), which on these
# mixtures' near-equal neighbours swaps ranks: on 16,384 rows of the
# recipe, 256 a centre as here, both packages' ShardedIVFCorpus reach
# recall@10 0.8891 against the f32 scan over every window, and at this
# phase's layout (windows of 1,024, nprobe a quarter of a shard's
# windows) on 65,536 rows 0.8656, where an exact int8 scan reaches
# 0.9703 / 0.9719 (tests/test_torch_mesh.py::
# test_sharded_ivf_recall_is_the_references, both cases). Against the
# f32 scan the route is held to MESH_IVF_MIN_RECALL (0.8896-0.8922 read
# on an H100); against the exact scan of the placement's own rows and
# multipliers (what its probes and its bf16 first pass can lose) to
# MIN_RECALL
MESH_IVF_MIN_RECALL = 0.85
MESH_FRESH = 64
MESH_COPY_ROWS = 2048
MESH_TOL = 1e-5
# 21g, over stored rows: search's top-1 is the row itself unless its
# window is not among its shard's nprobe best (a fixed window straddling
# two clusters has a blended mean); the fast form's pool-winner probes
# (JAX's probe_mode "pool": one window a strided pool of the centroid
# scores) pick another window set than search's exact top-nprobe, so its
# top-1 may differ where that window falls outside it. Both are the JAX
# class's designs (tests/test_torch_mesh.py holds each form to JAX's); on
# an H100 at cell M: 5 and 7-14 departures of 1,024 (PERF.md §6), so the
# limits allow 10 and 15
MESH_SELF_MIN = 0.99
MESH_FAST_MIN_AGREE = 0.985
# phase 22: TIE_ROWS of phase 7's rows TIE_COPIES times in the store,
# TIE_INT8_ROWS of them in the int8 collection; TIE_WALKS paginated walks
# of TIE_PAGES pages of TOP_K
TIE_ROWS = 1 << 18
TIE_INT8_ROWS = 1 << 17
TIE_COPIES = 4
TIE_FILTERED = 4
TIE_WALKS = 4
TIE_PAGES = 4
# and TIE_RUN_ROWS of them TIE_COPIES times in a row in a store of its
# own, searched by a batch of TIE_RUN_QUERIES (the exact scan's blocks of
# [TIE_RUN_QUERIES, 65,536] scores: above _SORT_MAX, the int64 keys)
TIE_RUN_ROWS = 1 << 17
TIE_RUN_QUERIES = 64


_T_START = time.perf_counter()


def say(msg: str) -> None:
    """A progress line, led by the seconds since the script started: the
    run as a whole is held to a time limit."""
    print(f"{time.perf_counter() - _T_START:7.1f}s {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> str:
    """The host CPU's model and core count: single-query latency and
    batch QPS are host-bound, so they move with it."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model} x {os.cpu_count()}"


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of fn over reps calls, by CUDA events."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launches_since(before: dict) -> dict:
    """kernels.LAUNCHES counted since the copy ``before`` was taken."""
    from neumann_tpu_torch.ops import kernels as tk

    return {k: v - before.get(k, 0) for k, v in tk.LAUNCHES.items()}


def trace_kernel_ms(tp, launched: dict, what: str):
    """(kernel ms by name, lost) from a CUDA trace of a run in which the
    wrappers counted ``launched``. ``lost`` maps each group of
    TRACE_KERNELS names the trace holds fewer records of than its
    wrappers launched to (records, launches); the caller then records
    no device time (the trace has lost kernels: it has happened with
    hand kernels and CUDA-only traces)."""
    import torch

    kernels, records = {}, {}
    for e in tp.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
            records[e.name] = records.get(e.name, 0) + 1
    want = {}
    for name, n in launched.items():
        if n > 0:
            names = TRACE_KERNELS[name]
            want[names] = want.get(names, 0) + n
    lost = {}
    for names, n in want.items():
        pat = re.compile(r"::(%s)\b" % "|".join(names))
        seen = sum(c for k, c in records.items() if pat.search(k))
        if seen < n:
            lost["|".join(names)] = (seen, n)
    if lost:
        say(f"[profile] {what}: the trace holds fewer kernel records than "
            f"launches {lost} (records, launches): device time not "
            f"measured")
    return kernels, lost


def device_ms(fn, reps: int, what: str = "device_ms", only=None):
    """Mean device time of the CUDA kernels fn launches (those whose
    names match the regex ``only``, if given), from torch.profiler's
    kernel records: without the gaps a host-bound call (one query)
    leaves between launches, which cuda_ms counts. None where the trace
    lost a counted launch's kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neumann_tpu_torch.ops import kernels as tk

    fn()
    torch.cuda.synchronize()
    before = dict(tk.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, lost = trace_kernel_ms(tp, launches_since(before), what)
    if lost:
        return None
    return sum(v for name, v in kernels.items()
               if only is None or re.search(only, name)) / reps


def ms_text(ms, digits: int = 3) -> str:
    """A device time for a log line: "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def bound(n_bytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak, and which."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=t_bytes, ops_bound_ms=t_ops)


def probe_table_bytes(b, rm2, scm, got, n_filled: int) -> int:
    """The batched probe's bytes: the windows' rows and multipliers, the
    slots' scales and the packed winners, and the query table's filled
    slots alone (its empty slots are never read)."""
    return nbytes(b, rm2, scm, got) + n_filled * DIM


def turns(kernel, library, reps: int):
    """Device times of a kernel and of a library call for the same
    product, taken in turns on one card (kernel, library, library,
    kernel); means of the two runs of each."""
    k1 = cuda_ms(kernel, reps)
    l1 = cuda_ms(library, reps)
    l2 = cuda_ms(library, reps, warm=False)
    k2 = cuda_ms(kernel, reps, warm=False)
    return (k1 + k2) / 2, (l1 + l2) / 2


def check_kernels(dev, rows: int, seed: int) -> dict:
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=dev).manual_seed(seed)
    window, nprobe, n_probe_q = 1024, 81, 32
    buf = torch.randint(-127, 128, (rows, DIM), generator=g, device=dev,
                        dtype=torch.int8)
    # realistic multipliers: 1/||row|| (unit rows), some dead rows
    rm = torch.cat([torch.rsqrt((buf[s:s + 65536].float() ** 2).sum(1))
                    for s in range(0, rows, 65536)])
    rm[::997] = 0.0
    out = {}

    sb = torch.randint(0, rows // 128 - window // 128 + 1,
                       (n_probe_q, nprobe), generator=g, device=dev,
                       dtype=torch.int32)
    qs = torch.randn(n_probe_q, DIM, generator=g, device=dev)
    qs /= qs.norm(dim=1, keepdim=True)
    got = tk.ivf_probe_scores(buf, rm, sb, qs, window)
    want = tk.ivf_probe_scores_plain(buf, rm, sb, qs, window)
    torch.cuda.synchronize()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("ivf_probe: -inf slots differ from plain")
    live = torch.isfinite(want)
    err = float((got[live] - want[live]).abs().max())
    if not err <= PROBE_ATOL:
        raise AssertionError(f"ivf_probe: max |kernel - plain| {err} > "
                             f"{PROBE_ATOL}")
    # bytes: the distinct 128-row blocks the probe lists touch, read once
    blocks = (sb.long()[:, :, None]
              + torch.arange(window // 128, device=dev)).unique()
    blocks = int((blocks < rows // 128).sum())
    probe_bound = bound(blocks * 128 * (DIM + 4) + nbytes(sb, qs, got),
                        2 * n_probe_q * nprobe * window * DIM,
                        F32_FLOPS_PER_S)
    out["ivf_probe"] = dict(
        **probe_bound, distinct_blocks=blocks,
        max_abs_err=err,
        ms=cuda_ms(lambda: tk.ivf_probe_scores(buf, rm, sb, qs, window), 20),
        plain_ms=cuda_ms(
            lambda: tk.ivf_probe_scores_plain(buf, rm, sb, qs, window), 2,
            warm=False),
        shape=f"Q={n_probe_q} nprobe={nprobe} window={window} d={DIM}")
    say(f"[2] ivf_probe kernel vs plain: max_abs_err {err:.3g} "
        f"(atol {PROBE_ATOL}); kernel {out['ivf_probe']['ms']:.4f} ms, "
        f"plain {out['ivf_probe']['plain_ms']:.4f} ms")
    out["ivf_probe"].update(probe_single(buf, rm, sb[:1], qs[:1], window))
    del got, want, live, sb, qs

    n_win, q_cap = rows // window, 64
    qsel = torch.randint(-127, 128, (n_win, q_cap, DIM), generator=g,
                         device=dev, dtype=torch.int8)
    # ~1/3 of the slots filled, in order (as the query tables fill them)
    filled = torch.randint(0, 2 * q_cap // 3, (n_win, 1), generator=g,
                           device=dev)
    scm = (torch.rand(n_win, q_cap, generator=g, device=dev) * 0.004
           + 0.004) * (torch.arange(q_cap, device=dev) < filled)
    rm2 = rm[:n_win * window].reshape(n_win, window)
    b = buf[:n_win * window]
    got = tk.batched_probe(b, rm2, qsel, scm, window, top2=True)
    want = tk.batched_probe_plain(b, rm2, qsel, scm, window, top2=True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"batched_probe: {bad} packed words differ "
                             f"from plain (must be bit-exact)")
    s_got, _ = tk.decode_strided_pool_bits(got, window)
    s_want, _ = tk.decode_strided_pool_bits(want, window)
    fin = torch.isfinite(s_want)
    err = float((s_got[fin] - s_want[fin]).abs().max()) if fin.any() else 0.0
    # the filled query slots are the work: their table rows are read and
    # scored against every row of their window
    n_filled = int(filled.clamp(max=q_cap).sum())
    out["batched_probe"] = dict(
        **bound(probe_table_bytes(b, rm2, scm, got, n_filled),
                2 * n_filled * window * DIM, INT8_OPS_PER_S),
        filled_slots=n_filled,
        max_abs_err=err,
        ms=cuda_ms(lambda: tk.batched_probe(b, rm2, qsel, scm, window,
                                            top2=True), 10),
        plain_ms=cuda_ms(lambda: tk.batched_probe_plain(
            b, rm2, qsel, scm, window, top2=True), 1, warm=False),
        shape=f"C={n_win} q_cap={q_cap} window={window} d={DIM} top2")
    say(f"[2] batched_probe kernel vs plain: bit-exact, max_abs_err "
        f"{err:.3g}; kernel {out['batched_probe']['ms']:.4f} ms, plain "
        f"{out['batched_probe']['plain_ms']:.4f} ms")
    # the top-1 mode at the same shape: 128 lanes out, one winner a pool
    got = tk.batched_probe(b, rm2, qsel, scm, window)
    want = tk.batched_probe_plain(b, rm2, qsel, scm, window)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"batched_probe top-1: "
                             f"{int((got != want).sum())} packed words "
                             f"differ from plain (must be bit-exact)")
    out["batched_probe_top1"] = dict(
        **bound(probe_table_bytes(b, rm2, scm, got, n_filled),
                2 * n_filled * window * DIM, INT8_OPS_PER_S),
        filled_slots=n_filled, max_abs_err=0.0,
        ms=cuda_ms(lambda: tk.batched_probe(b, rm2, qsel, scm, window), 10),
        plain_ms=cuda_ms(lambda: tk.batched_probe_plain(
            b, rm2, qsel, scm, window), 1, warm=False),
        shape=f"C={n_win} q_cap={q_cap} window={window} d={DIM} top1")
    say(f"[2] batched_probe top-1 vs plain: bit-exact; kernel "
        f"{out['batched_probe_top1']['ms']:.4f} ms (top-2 "
        f"{out['batched_probe']['ms']:.4f}), plain "
        f"{out['batched_probe_top1']['plain_ms']:.4f} ms, bound "
        f"{out['batched_probe_top1']['bound_ms']:.4f} ms")
    del got, want, qsel, scm, b, rm2, buf, rm
    out["batched_probe"].update(check_batched_probe_wide(dev, seed, window))
    return out


def probe_single(buf, rm, sb, q, window: int) -> dict:
    """Row 1 at A's single-query launch (``_q1``: phase 4's singles, one
    query's nprobe windows): held to the plain version as at Q 32, its
    kernel time from torch.profiler (CUDA events over back-to-back calls
    measure the host's launch rate at one query) and by events, and its
    bound: the distinct 128-row blocks of its windows read once."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    got = tk.ivf_probe_scores(buf, rm, sb, q, window)
    want = tk.ivf_probe_scores_plain(buf, rm, sb, q, window)
    torch.cuda.synchronize()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("ivf_probe at Q 1: -inf slots differ from "
                             "plain")
    live = torch.isfinite(want)
    err = float((got[live] - want[live]).abs().max())
    if not err <= PROBE_ATOL:
        raise AssertionError(f"ivf_probe at Q 1: max |kernel - plain| {err}"
                             f" > {PROBE_ATOL}")
    rows = buf.shape[0]
    blocks = (sb.long()[:, :, None]
              + torch.arange(window // 128, device=buf.device)).unique()
    blocks = int((blocks < rows // 128).sum())
    nprobe = sb.shape[1]
    rec = {f"{k}_q1": v for k, v in bound(
        blocks * 128 * (DIM + 4) + nbytes(sb, q, got),
        2 * nprobe * window * DIM, F32_FLOPS_PER_S).items()}
    call = lambda: tk.ivf_probe_scores(buf, rm, sb, q, window)  # noqa: E731
    rec.update(max_abs_err_q1=err, distinct_blocks_q1=blocks,
               ms_q1=cuda_ms(call, 200),
               device_ms_q1=device_ms(call, 50, "ivf_probe_q1"),
               plain_ms_q1=cuda_ms(lambda: tk.ivf_probe_scores_plain(
                   buf, rm, sb, q, window), 3),
               shape_q1=f"Q=1 nprobe={nprobe} window={window} d={DIM}")
    say(f"[2] ivf_probe at Q 1: max_abs_err {err:.3g}; kernel "
        f"{ms_text(rec['device_ms_q1'], 4)} ms (device; "
        f"{rec['ms_q1']:.4f} by events), bound {rec['bound_ms_q1']:.4f} ms "
        f"({rec['bound_by_q1']}), plain {rec['plain_ms_q1']:.4f} ms")
    return rec


def check_batched_probe_wide(dev, seed: int, window: int) -> dict:
    """Row 2 at d 4,096 (past the 3,072 up to which the queries stay in
    shared memory; above, they ride in the ring with the rows): 512
    windows, 64 slots, a third filled, bit-exact against plain."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    d, n_win, q_cap = 4096, 512, 64
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    buf = torch.randint(-127, 128, (n_win * window, d), generator=g,
                        device=dev, dtype=torch.int8)
    qsel = torch.randint(-127, 128, (n_win, q_cap, d), generator=g,
                         device=dev, dtype=torch.int8)
    rm2 = torch.rand(n_win, window, generator=g, device=dev) * 2e-3
    rm2[:, ::97] = 0.0
    filled = torch.randint(0, 2 * q_cap // 3, (n_win, 1), generator=g,
                           device=dev)
    scm = (torch.rand(n_win, q_cap, generator=g, device=dev) * 0.004
           + 0.004) * (torch.arange(q_cap, device=dev) < filled)
    got = tk.batched_probe(buf, rm2, qsel, scm, window, top2=True)
    want = tk.batched_probe_plain(buf, rm2, qsel, scm, window, top2=True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"batched_probe at d {d}: "
                             f"{int((got != want).sum())} packed words "
                             f"differ from plain (must be bit-exact)")
    n_filled = int(filled.sum())
    rec = {f"{k}_d4096": v for k, v in bound(
        nbytes(buf, rm2, scm, got) + n_filled * d,
        2 * n_filled * window * d, INT8_OPS_PER_S).items()}
    rec.update(max_abs_err_d4096=0.0, filled_slots_d4096=n_filled,
               ms_d4096=cuda_ms(lambda: tk.batched_probe(
                   buf, rm2, qsel, scm, window, top2=True), 10),
               plain_ms_d4096=cuda_ms(lambda: tk.batched_probe_plain(
                   buf, rm2, qsel, scm, window, top2=True), 1, warm=False),
               shape_d4096=f"C={n_win} q_cap={q_cap} window={window} d={d} "
                           f"top2")
    say(f"[2] batched_probe at d {d}: bit-exact; kernel "
        f"{rec['ms_d4096']:.4f} ms, plain {rec['plain_ms_d4096']:.4f} ms, "
        f"bound {rec['bound_ms_d4096']:.4f} ms")
    return rec


def _decode(bits, pool: int):
    """Winner scores of packed pooled bits (-inf for dead pools)."""
    import torch

    return torch.where(bits > 0, (bits & ~(pool - 1)).view(torch.float32)
                       - 2.0, torch.full(bits.shape, float("-inf"),
                                         device=bits.device))


def check_new_kernels(dev, seed: int) -> dict:
    """Phase 2, the brute-force routes' kernels: each against its plain
    version at the shapes phases 7-10 give it, on random rows."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.quant import (
        _pooled_bits_select,
        binary_quantize,
        int8_cosine_row_mult,
        scalar_quantize,
    )

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n, step = POOLED_ROWS, 1 << 18
    x = torch.randn(n, DIM, generator=g, device=dev)
    rm = 1.0 / x.norm(dim=1)
    cq = torch.empty((n, DIM), dtype=torch.int8, device=dev)
    cs = torch.empty(n, device=dev)
    for r0 in range(0, n, step):
        cq[r0:r0 + step], cs[r0:r0 + step] = scalar_quantize(x[r0:r0 + step])
    rm8 = torch.cat([int8_cosine_row_mult(cq[r0:r0 + step], cs[r0:r0 + step])
                     for r0 in range(0, n, step)])
    # 1 % dead rows
    bias = torch.where(torch.rand(n, generator=g, device=dev) < 0.99,
                       torch.full((n,), 2.0, device=dev),
                       torch.full((n,), -1e30, device=dev))
    qs = x[torch.randint(0, n, (N_BATCH,), generator=g, device=dev)] \
        + 0.1 * torch.randn(N_BATCH, DIM, generator=g, device=dev)
    qq, qsc = scalar_quantize(qs)
    qm8 = qsc / torch.sqrt(((qq.float() * qsc[:, None]) ** 2).sum(1))
    qmf = 1.0 / qs.norm(dim=1)
    out = {}

    got = tk.int8_dot_scores(cq, rm8, qq[:64], qm8[:64])
    want = tk.int8_dot_scores_plain(cq, rm8, qq[:64], qm8[:64])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"int8_dot_scores: {int((got != want).sum())} "
                             f"scores differ from plain (must be "
                             f"bit-exact)")
    ms, lib_ms = turns(
        lambda: tk.int8_dot_scores(cq, rm8, qq[:64], qm8[:64]),
        lambda: torch._int_mm(qq[:64], cq.t()), 10)
    out["int8_dot_scores"] = dict(
        **bound(nbytes(cq, rm8, qq[:64], qm8[:64], got),
                2 * 64 * n * DIM, INT8_OPS_PER_S),
        max_abs_err=float((got - want).abs().max()),
        ms=ms, library_ms=lib_ms,
        library="torch._int_mm(qq, cq.t()), product only (int32, no "
                "scaling)",
        plain_ms=cuda_ms(lambda: tk.int8_dot_scores_plain(
            cq, rm8, qq[:64], qm8[:64]), 3),
        shape=f"Q=64 N={n} d={DIM}; Q=1 N={n // 2}")
    del got, want
    # the int8 route's own launch: one euclidean query against one
    # 524,288-row block of int8_topk_scan, scale-only multipliers (the
    # mma.sync kernel; Q=64 above runs the wgmma one)
    a1 = (cq[:n // 2], cs[:n // 2], qq[:1], qsc[:1])
    got = tk.int8_dot_scores(*a1)
    want = tk.int8_dot_scores_plain(*a1)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"int8_dot_scores at Q=1: "
                             f"{int((got != want).sum())} scores differ "
                             f"from plain (must be bit-exact)")
    rec = out["int8_dot_scores"]
    for k, v in bound(nbytes(*a1, got), 2 * (n // 2) * DIM,
                      INT8_OPS_PER_S).items():
        rec[f"{k}_q1"] = v
    rec.update(max_abs_err_q1=float((got - want).abs().max()),
               ms_q1=cuda_ms(lambda: tk.int8_dot_scores(*a1), 20),
               plain_ms_q1=cuda_ms(lambda: tk.int8_dot_scores_plain(*a1), 3))
    # torch._int_mm takes more than 16 rows (a multiple of 8): the query
    # padded with 31 zero rows, so it does 32 queries' products
    q32 = torch.zeros((32, DIM), dtype=torch.int8, device=dev)
    q32[0] = qq[0]
    _, rec["library_ms_q1"] = turns(
        lambda: tk.int8_dot_scores(*a1),
        lambda: torch._int_mm(q32, a1[0].t()), 20)
    rec["library_q1"] = ("torch._int_mm(q32, cq.t()), the query padded with "
                         "31 zero rows to 32 (its least row count above 16):"
                         " 32 queries' products, no scaling")
    del got, want, q32

    for name, fn, plain, args in (
            ("int8_pooled_bits", tk.int8_pooled_bits,
             tk.int8_pooled_bits_plain, (cq, rm8, bias, qq, qm8)),
            ("f32_pooled_bits", tk.f32_pooled_bits,
             tk.f32_pooled_bits_plain, (x, rm, bias, qs, qmf))):
        rec = {"shape": f"Q=8 and Q={N_BATCH}, N={n} d={DIM} pool={POOL}"}
        for q in (8, N_BATCH):
            a = args[:3] + (args[3][:q], args[4][:q])
            got, want = fn(*a, POOL), plain(*a, POOL)
            torch.cuda.synchronize()
            s_got, s_want = _decode(got, POOL), _decode(want, POOL)
            live = torch.isfinite(s_want)
            if not torch.equal(torch.isfinite(s_got), live):
                raise AssertionError(f"{name}: dead pools differ from plain")
            err = float((s_got - s_want)[live].abs().max())
            if name == "int8_pooled_bits":
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name}: {int((got != want).sum())} packed words "
                        f"differ from plain (must be bit-exact)")
            else:
                agree = float(((got & (POOL - 1)) == (want & (POOL - 1)))
                              [live].float().mean())
                # candidate-set recall: the 80 candidates the rerank sees
                _, r_got = _pooled_bits_select(got, POOL, 80)
                _, r_want = _pooled_bits_select(want, POOL, 80)
                cand = float(np.mean([
                    len(set(a_.tolist()) & set(b_.tolist())) / 80
                    for a_, b_ in zip(r_got.cpu(), r_want.cpu())]))
                rec[f"winner_agree_q{q}"] = agree
                rec[f"candidate_recall_q{q}"] = cand
                if err > F32_POOLED_ATOL or agree < F32_POOLED_MIN_AGREE:
                    raise AssertionError(
                        f"{name}: max decoded err {err} (atol "
                        f"{F32_POOLED_ATOL}), winners agree {agree} (min "
                        f"{F32_POOLED_MIN_AGREE})")
            key = "" if q == N_BATCH else f"_q{q}"
            rec[f"max_abs_err{key}"] = err
            int8 = name == "int8_pooled_bits"
            if int8:
                for k, v in bound(nbytes(*a, got), 2 * q * n * DIM,
                                  INT8_OPS_PER_S).items():
                    rec[f"{k}{key}"] = v
            else:
                f32_bounds(rec, key, nbytes(*a, got), 2 * q * n * DIM)
            if q == N_BATCH:
                # the same product by one library call (TF32 off, stated
                # here as well as by the package); no scaling, no pools
                torch.backends.cuda.matmul.allow_tf32 = False
                lib = ((lambda: torch._int_mm(a[3], a[0].t())) if int8
                       else (lambda: torch.matmul(a[3], a[0].t())))
                rec["ms"], rec["library_ms"] = turns(
                    lambda: fn(*a, POOL), lib, 5)
                rec["library"] = (
                    "torch._int_mm(qq, cq.t()), product only (int32, no "
                    "scaling or pooling)" if int8 else
                    "torch.matmul(qs, x.t()) with allow_tf32 False, "
                    "product only (no scaling or pooling)")
            else:
                rec[f"ms{key}"] = cuda_ms(lambda: fn(*a, POOL), 5)
            rec[f"plain_ms{key}"] = cuda_ms(lambda: plain(*a, POOL), 1,
                                            warm=False)
            del got, want, s_got, s_want, live
        out[name] = rec
    out["f32_pooled_bits"].update(check_f32_pooled_hybrid(
        x, rm, bias, qs[:1], qmf[:1]))

    rate = b1_ops_per_s(tk.build_kernels())
    out["hamming_scores"] = check_hamming_scores(
        binary_quantize(x[:HAMMING_BLOCK]), binary_quantize(qs), rate)
    out["hamming_topk"] = check_hamming_topk(x, qs, bias > 0, rate)
    wide3, wide7 = check_hamming_wide(dev, seed, rate)
    out["hamming_scores"].update(wide3)
    out["hamming_topk"].update(wide7)
    for name, rec in out.items():
        say(f"[2] {name} kernel vs plain ({rec['shape']}): max_abs_err "
            f"{rec['max_abs_err']:.3g}; kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), library {rec.get('library_ms')}"
            + "".join(f"; at {sfx[1:]} kernel {rec[f'ms{sfx}']:.4f} ms, "
                      f"plain {rec[f'plain_ms{sfx}']:.4f} ms, bound "
                      f"{rec[f'bound_ms{sfx}']:.4f} ms, library "
                      f"{rec.get(f'library_ms{sfx}')}"
                      for sfx in SHAPE_SUFFIXES if f"ms{sfx}" in rec))
    return out


def f32_bounds(rec: dict, sfx: str, n_bytes: int, flop: float) -> None:
    """Row 6's bounds into ``rec`` under suffix ``sfx``: the bytes, and
    the f32 product's ``flop`` as the three TF32 passes on the tensor
    cores (the kernel's split above 16 queries: the least the card could
    take for f32-level dots); the FFMA's bound of one f32 pass beside."""
    for k, v in bound(n_bytes, 3 * flop, TF32_FLOPS_PER_S).items():
        rec[f"{k}{sfx}"] = v
    rec[f"ffma_bound_ms{sfx}"] = bound(n_bytes, flop,
                                       F32_FLOPS_PER_S)["bound_ms"]


def check_f32_pooled_hybrid(x, rm, bias, q, qm) -> dict:
    """Row 6 at phase 11's own launch (``_hyb``): FIND's one query against
    the 262,144-row entity corpus at its gate's pool of 128; the same
    checks as above, and the kernel's device time (one query: CUDA events
    over back-to-back calls measure the host's launch rate)."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    n, pool = HYBRID_ROWS, HYBRID_POOL
    a = (x[:n], rm[:n], bias[:n], q, qm)
    got = tk.f32_pooled_bits(*a, pool)
    want = tk.f32_pooled_bits_plain(*a, pool)
    torch.cuda.synchronize()
    s_got, s_want = _decode(got, pool), _decode(want, pool)
    live = torch.isfinite(s_want)
    if not torch.equal(torch.isfinite(s_got), live):
        raise AssertionError("f32_pooled_bits at phase 11's shape: dead "
                             "pools differ from plain")
    err = float((s_got - s_want)[live].abs().max())
    agree = float(((got & (pool - 1)) == (want & (pool - 1)))[live]
                  .float().mean())
    atol = pool * 2.0 ** -22 + 1e-6
    if err > atol or agree < F32_POOLED_MIN_AGREE:
        raise AssertionError(
            f"f32_pooled_bits at phase 11's shape: max decoded err {err} "
            f"(atol {atol}), winners agree {agree}")
    rec = {}
    f32_bounds(rec, "_hyb", nbytes(*a, got), 2 * n * DIM)
    # the library yardstick at this shape: the product and the per-pool
    # max (no row bias, no winner bits), TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    xn = a[0]

    def lib():
        return torch.matmul(q, xn.t()).view(1, n // pool, pool).amax(-1)

    rec.update(max_abs_err_hyb=err, winner_agree_hyb=agree,
               ms_hyb=cuda_ms(lambda: tk.f32_pooled_bits(*a, pool), 20),
               device_ms_hyb=device_ms(
                   lambda: tk.f32_pooled_bits(*a, pool), 20),
               plain_ms_hyb=cuda_ms(
                   lambda: tk.f32_pooled_bits_plain(*a, pool), 3),
               library_ms_hyb=cuda_ms(lib, 20),
               library_device_ms_hyb=device_ms(lib, 20),
               library_hyb="torch.matmul(q, x.t()) with allow_tf32 False "
                           "and .amax over each pool of 128 (no row bias "
                           "or winner bits)",
               shape_hyb=f"Q=1 N={n} d={DIM} pool={pool}")
    return rec


def check_hamming_scores(cb, qb, rate: float) -> dict:
    """Phase 2, row 3 at the launch of the binary route above the fused
    kernel's k cap (one 131,072-row block of 24 words): 1,024 queries, as
    D's TOP 65 batch, and 1, as D's TOP 65 single; bit-exact.

    Bound: the larger of the bytes (corpus, queries, the [Q, N] int32
    distances) and the bit products (2 Q N d) at the 1-bit rate measured
    in this run; beside it the POPC issue time of an XOR + POPC loop.
    ``ms`` times back-to-back wrapper calls with CUDA events (at one query
    that is the host's rate of wrapper calls), ``kernel_ms`` back-to-back
    calls of the C entry point into one output, ``device_ms`` the kernel
    alone (torch.profiler)."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    n, w = cb.shape
    lib = tk.build_kernels()
    rec = {"shape": f"Q={qb.shape[0]} and Q=1, N={n} W={w}"}
    for q in (qb.shape[0], 1):
        qq = qb[:q].contiguous()
        key = "" if q > 1 else "_q1"
        got = tk.hamming_scores(cb, qq)
        want = tk.hamming_scores_plain(cb, qq)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hamming_scores at Q={q}: "
                                 f"{int((got != want).sum())} distances "
                                 f"differ from plain")
        for k, v in bound(nbytes(cb, qq, got), 2 * q * n * 32 * w,
                          rate).items():
            rec[f"{k}{key}"] = v
        rec[f"popc_issue_bound_ms{key}"] = q * cb.numel() / POPC_PER_S * 1e3
        rec[f"max_abs_err{key}"] = 0.0
        reps = 10 if q > 1 else 200
        rec[f"ms{key}"] = cuda_ms(lambda: tk.hamming_scores(cb, qq), reps)
        entry = (lambda: tk._raise_on(lib.neumann_hamming_scores(
            cb.data_ptr(), qq.data_ptr(), got.data_ptr(), n, q, w,
            tk._stream()), "hamming_scores"))
        rec[f"kernel_ms{key}"] = cuda_ms(entry, reps)
        rec[f"device_ms{key}"] = device_ms(entry, reps)
        rec[f"plain_ms{key}"] = cuda_ms(
            lambda: tk.hamming_scores_plain(cb, qq), 1, warm=False)
        del got, want
    return rec


def check_hamming_wide(dev, seed: int, rate: float):
    """Phase 2, rows 3 and 7 at 3,072-d rows (W 96, past the 64 words both
    kernels once took), on random bits with every fourth row a copy of an
    earlier one (equal distances everywhere) and 1 % dead rows, queries
    near stored rows: both at 64 queries x 131,072 rows (``_w96``); the
    distances at 1 query x 131,072 rows, phase 10's TOP 65 launch
    (``_w96q1``); the top-10 at 1 and 256 queries x WIDE_ROWS rows, phase
    10's single and batch launches (``_w96q1``, ``_w96q256``). Distances
    bit-exact, top-10 scores and ids equal to the plain versions'.
    Row 3's ``kernel_ms`` and ``device_ms`` (torch.profiler) time the C
    entry point alone, row 7's launch as ``_topk_launches`` says (with
    ``unselected_ms``), ``ms`` the wrapper (host-bound at one query).
    Returns the two records' entries."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    w, lib = WIDE_DIM // 32, tk.build_kernels()
    g = torch.Generator(device=dev).manual_seed(seed + 2)

    def bits(rows):
        return torch.randint(-(1 << 31), 1 << 31, (rows, w), generator=g,
                             device=dev, dtype=torch.int64).int()

    cb = bits(WIDE_ROWS)
    cb[3::4] = cb[torch.randint(0, WIDE_ROWS, (WIDE_ROWS // 4,), generator=g,
                                device=dev)]
    qb = (cb[torch.randint(0, HAMMING_BLOCK, (N_WIDE_BATCH,), generator=g,
                           device=dev)]
          ^ (bits(N_WIDE_BATCH) & bits(N_WIDE_BATCH) & bits(N_WIDE_BATCH)))
    mask = torch.rand(WIDE_ROWS, generator=g, device=dev) > 0.01
    r3, r7 = {}, {}

    def record(rec, sfx, q, shape, got, want, fn, entry, plain, n_bytes,
               ops):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{shape}: {int((a != b).sum())} values "
                                     f"differ from plain")
        reps = 200 if q == 1 else 20
        rec.update({f"{k}{sfx}": v for k, v in bound(n_bytes, ops,
                                                     rate).items()})
        rec.update({f"shape{sfx}": shape, f"max_abs_err{sfx}": 0.0,
                    f"ms{sfx}": cuda_ms(fn, reps),
                    f"kernel_ms{sfx}": cuda_ms(entry, reps),
                    f"device_ms{sfx}": device_ms(entry, reps),
                    f"plain_ms{sfx}": cuda_ms(plain, 1, warm=False)})

    for sfx, q in (("_w96", 64), ("_w96q1", 1)):
        c, qq = cb[:HAMMING_BLOCK], qb[:q].contiguous()
        got = tk.hamming_scores(c, qq)
        want = tk.hamming_scores_plain(c, qq)
        torch.cuda.synchronize()
        record(r3, sfx, q, f"Q={q} N={HAMMING_BLOCK} W={w}", (got,), (want,),
               lambda: tk.hamming_scores(c, qq),
               lambda: tk._raise_on(lib.neumann_hamming_scores(
                   c.data_ptr(), qq.data_ptr(), got.data_ptr(),
                   HAMMING_BLOCK, q, w, tk._stream()), "hamming_scores"),
               lambda: tk.hamming_scores_plain(c, qq), nbytes(c, qq, got),
               2 * q * HAMMING_BLOCK * 32 * w)
        del got, want
    for sfx, q, n in (("_w96", 64, HAMMING_BLOCK), ("_w96q1", 1, WIDE_ROWS),
                      ("_w96q256", N_WIDE_BATCH, WIDE_ROWS)):
        c, qq, m = cb[:n], qb[:q].contiguous(), mask[:n]
        got = tk.hamming_topk(c, qq, m, TOP_K)
        want = tk.hamming_topk_plain(c, qq, m, TOP_K)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"hamming_topk Q={q} N={n} W={w}: "
                                     f"{int((a != b).sum())} values differ "
                                     f"from plain")
        reps = 200 if q == 1 else 20
        r7.update({f"{k}{sfx}": v for k, v in bound(
            nbytes(c, qq, m, *got), 2 * q * n * 32 * w, rate).items()})
        r7.update({f"shape{sfx}": f"Q={q} N={n} W={w} k={TOP_K}",
                   f"max_abs_err{sfx}": 0.0,
                   f"ms{sfx}": cuda_ms(lambda: tk.hamming_topk(c, qq, m,
                                                               TOP_K), reps),
                   f"plain_ms{sfx}": cuda_ms(
                       lambda: tk.hamming_topk_plain(c, qq, m, TOP_K), 1,
                       warm=False)})
        _topk_launches(c, qq, m, r7, sfx, reps)
        del got, want
    say(f"[2] hamming at W={w}: distances bit-exact (kernel "
        f"{r3['ms_w96']:.4f} ms, bound {r3['bound_ms_w96']:.4f}; Q 1 device "
        f"{ms_text(r3['device_ms_w96q1'], 4)} ms, bound "
        f"{r3['bound_ms_w96q1']:.4f}), "
        f"top-{TOP_K} equal (kernel {r7['ms_w96']:.4f} ms; at {WIDE_ROWS} "
        f"rows Q 1 device {ms_text(r7['device_ms_w96q1'], 4)} ms, Q "
        f"{N_WIDE_BATCH} "
        f"{r7['ms_w96q256']:.4f} ms)")
    return r3, r7


def b1_ops_per_s(lib) -> float:
    """The card's rate of 1-bit tensor-core products (mma.sync
    m16n8k256.b1.and.popc), measured: a bare loop of independent products
    on registers, 4 blocks of 8 warps a SM, each product 2 x 16 x 8 x 256
    operations (AND + POPC-accumulate a bit pair, as int8's multiply-add)."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    blocks, iters = 4 * torch.cuda.get_device_properties(
        0).multi_processor_count, 8192   # about 3 ms a launch
    sink = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: tk._raise_on(lib.neumann_b1_mma_rate(
        blocks, iters, sink.data_ptr(), tk._stream()), "b1_mma_rate"), 5)
    return blocks * 8 * iters * 8 * 2 * 16 * 8 * 256 / (ms * 1e-3)


def _topk_launches(cb, qb, mask, rec: dict, key: str, reps: int) -> None:
    """Row 7's launch alone at one shape: its plan, ``kernel_ms`` (CUDA
    events over back-to-back launches), ``unselected_ms`` (the same launch
    with nothing selected: copies, row counts, products and compares, no
    appends, merges or shared thresholds) and ``device_ms`` (the launch's
    own device time, its threshold memset included, from
    torch.profiler)."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    (n, w), q = cb.shape, qb.shape[0]
    plan = tk._hamming_groups(n, q, w, TOP_K, torch.cuda.get_device_properties(
        cb.device).multi_processor_count)
    keys = torch.empty((q, plan[4] * plan[1] * TOP_K), dtype=torch.int64,
                       device=cb.device)
    gthr = torch.empty(q, dtype=torch.int64, device=cb.device)

    def launch(select):
        return lambda: tk._hamming_topk_launch(cb, qb, mask, TOP_K, plan,
                                               keys, gthr, select)

    rec[f"plan{key}"] = dict(zip(("query_tiles", "row_slices",
                                  "rows_per_warp", "stages", "groups",
                                  "span"), plan))
    rec[f"kernel_ms{key}"] = cuda_ms(launch(True), reps)
    rec[f"unselected_ms{key}"] = cuda_ms(launch(False), reps)
    rec[f"device_ms{key}"] = device_ms(launch(True), reps)


def check_hamming_topk(x, qs, mask, rate: float) -> dict:
    """Phase 2, the fused hamming top-k at D's shapes: all 1,048,576 rows
    of 24 words, k 10, 1 % dead rows, against a batch of 1,024 (the
    counted batch), 32 and 8 (served cohorts) and 1 query. Scores and ids
    must equal the plain version's.

    Its bound is the larger of the bytes (corpus, queries, mask, the top-k
    written) and the bit products (2 Q N d) at the 1-bit tensor-core rate
    that ``b1_ops_per_s`` measures in this run (the data sheet gives no
    1-bit rate). Beside it: the popcount issue time of an XOR + POPC loop
    and the products' time at the int8 rate. ``ms`` times the wrapper (the
    launch, the final torch.topk over the warps' keys, the decode); the
    launch alone as ``_topk_launches`` says, so kernel_ms - unselected_ms
    is what the selection's appends, merges and shared thresholds cost."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.quant import binary_quantize

    cb = binary_quantize(x)
    n, w = cb.shape
    rec = {"shape": f"Q={N_BATCH}, 32, 8 and 1, N={n} W={w} k={TOP_K}, "
                    f"{int((~mask).sum())} dead rows", "b1_ops_per_s": rate,
           "design": HT_DESIGN}
    for q in (N_BATCH, 32, 8, 1):
        qb = binary_quantize(qs[:q])
        got = tk.hamming_topk(cb, qb, mask, TOP_K)
        want = tk.hamming_topk_plain(cb, qb, mask, TOP_K)
        torch.cuda.synchronize()
        for a, b, what in zip(got, want, ("scores", "ids")):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"hamming_topk at Q={q}: {int((a != b).sum())} {what} "
                    f"differ from plain")
        key = "" if q == N_BATCH else f"_q{q}"
        ops = 2 * q * n * 32 * w
        for k, v in bound(nbytes(cb, qb, mask, *got), ops, rate).items():
            rec[f"{k}{key}"] = v
        rec[f"int8_rate_ms{key}"] = ops / INT8_OPS_PER_S * 1e3
        rec[f"popc_issue_bound_ms{key}"] = q * cb.numel() / POPC_PER_S * 1e3
        rec[f"max_abs_err{key}"] = 0.0
        reps = 10 if q == N_BATCH else 100
        rec[f"ms{key}"] = cuda_ms(lambda: tk.hamming_topk(cb, qb, mask, TOP_K),
                                  reps)
        _topk_launches(cb, qb, mask, rec, key, reps)
        rec[f"plain_ms{key}"] = cuda_ms(
            lambda: tk.hamming_topk_plain(cb, qb, mask, TOP_K), 1, warm=False)
    return rec


@contextlib.contextmanager
def plain_kernels():
    """Swap the brute-force routes' kernel wrappers for their plain
    versions, so a route's reference runs on the same card (its calls
    launch no kernel and count nothing)."""
    from neumann_tpu_torch.ops import kernels as tk

    saved = {n: getattr(tk, n) for n in _PLAIN_SWAPPED}
    try:
        for n in _PLAIN_SWAPPED:
            setattr(tk, n, getattr(tk, n + "_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(tk, n, fn)


# ---------------------------------------------------------------------------
# phase 3: the corpus
# ---------------------------------------------------------------------------

# rows of each int8 plane the IVF build's EmbeddingSlab.host_int8 returns
# (quantized on the card) held bit for bit to the CPU's recomputation
HOST_INT8_CHECK_ROWS = 65_536


@contextlib.contextmanager
def host_int8_sampled(sink: list):
    """Inside the block, every EmbeddingSlab.host_int8 call appends (the
    slab, HOST_INT8_CHECK_ROWS rows spread over it, those rows of each
    plane it returned) to ``sink``."""
    from neumann_tpu_torch.store.embedding_slab import EmbeddingSlab

    saved = EmbeddingSlab.host_int8

    def call(self, *a, **kw):
        out = saved(self, *a, **kw)
        n = out[0].shape[0]
        idx = np.unique(np.linspace(0, n - 1, min(n, HOST_INT8_CHECK_ROWS))
                        .astype(np.int64))
        sink.append((self, idx, [p[idx].copy() for p in out]))
        return out

    EmbeddingSlab.host_int8 = call
    try:
        yield sink
    finally:
        EmbeddingSlab.host_int8 = saved


def check_host_int8(sink: list) -> dict:
    """The sampled host_int8 planes against scalar_quantize and
    residual_quantize of the same host rows on the CPU, in the form
    host_int8 names ("divide", the JAX slab's numpy quantizer): the
    rows whose scales or int8 values differ."""
    import torch

    from neumann_tpu_torch.ops.quant import scalar_quantize
    from neumann_tpu_torch.ops.rerank import residual_quantize

    rec = dict(calls=len(sink), rows=0, scales_differ=0, values_differ=0)
    for slab, idx, planes in sink:
        x = torch.from_numpy(slab.rows_matrix(idx)[0])
        want = scalar_quantize(x, form="divide")
        if len(planes) == 4:
            want = want + residual_quantize(x, *want, form="divide")
        rec["rows"] += len(idx)
        for got, w in zip(planes, want):
            w = w.numpy()
            view = np.uint8 if w.dtype == np.int8 else np.uint32
            diff = (got.view(view) != w.view(view)).reshape(len(idx), -1)
            rec["values_differ" if got.ndim == 2 else "scales_differ"] += \
                int(diff.any(axis=1).sum())
    if not rec["calls"] or rec["scales_differ"] or rec["values_differ"]:
        raise AssertionError(f"host_int8's planes from the device differ "
                             f"from the CPU's: {rec}")
    return rec


def mixture(n: int, centres: np.ndarray, seed_seq, chunk: int = 1 << 17
            ) -> np.ndarray:
    """n rows of centre + SIGMA * N(0, 1), generated in parallel chunks
    (one independent stream per chunk, so the result does not depend on
    the thread schedule)."""
    out = np.empty((n, centres.shape[1]), np.float32)
    starts = list(range(0, n, chunk))
    seqs = seed_seq.spawn(len(starts))

    def fill(i):
        s = starts[i]
        e = min(n, s + chunk)
        rng = np.random.default_rng(seqs[i])
        which = rng.integers(0, len(centres), e - s)
        rng.standard_normal(out=out[s:e], dtype=np.float32)
        out[s:e] *= SIGMA
        out[s:e] += centres[which]

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        list(pool.map(fill, range(len(starts))))
    return out


def profile_paths(router, stmts, fresh, batch, out_dir: str) -> dict:
    """Where the time goes, after the counted phase (its launches are not
    counted): ``profile_calls`` of 8 single SIMILARs and of one batch,
    and the host time of ``parse_cached`` on statements it has not seen
    (``fresh``), the router's first step."""
    from neumann_tpu_torch.lang.parser import parse_cached

    parse_ms = []
    for stmt in fresh:
        t0 = time.perf_counter()
        parse_cached(stmt)
        parse_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"parse_ms": parse_ms}
    say(f"[profile] parse of an unseen 768-float SIMILAR: median "
        f"{float(np.median(parse_ms)):.3f} ms")
    out.update(profile_calls(
        {"single": lambda: [router.execute(s) for s in stmts],
         "batch": lambda: router.vector.batch_search(batch, TOP_K)},
        out_dir))
    return out


def profile_calls(calls: dict, out_dir: str) -> dict:
    """For each named call: cProfile on the host (top functions by
    cumulative time, profile_<name>_host.txt), then torch.profiler over a
    second run (profile_<name>_device.txt): kernel time summed from the
    CUDA events, and the device busy share = kernel time / wall time (the
    profiler's own overhead is in the wall time). The device trace is
    CUDA-only, as ``device_ms``'s. Where it holds fewer records of the
    hand kernels than the run's launch counts (``trace_kernel_ms``: it
    has lost them in G's batch and F's FIND), the busy time and share
    are None, and ``trace_lost`` says which."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from neumann_tpu_torch.ops import kernels as tk

    out = {}
    for name, fn in calls.items():
        prof = cProfile.Profile()
        prof.enable()
        fn()
        prof.disable()
        txt = io.StringIO()
        pstats.Stats(prof, stream=txt).sort_stats("cumulative").print_stats(30)
        with open(os.path.join(out_dir, f"profile_{name}_host.txt"), "w") as f:
            f.write(txt.getvalue())
        torch.cuda.synchronize()
        before = dict(tk.LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels, lost = trace_kernel_ms(tp, launches_since(before), name)
        busy_ms = None if lost else sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        out[name] = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                         device_busy_share=None if lost
                         else busy_ms / (wall * 1e3),
                         top_kernels_ms=top, kernels_ms=kernels,
                         trace_lost=lost)
        with open(os.path.join(out_dir, f"profile_{name}_device.txt"),
                  "w") as f:
            f.write(tp.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=25))
        share = "" if lost else f" ({100 * busy_ms / (wall * 1e3):.1f}%)"
        say(f"[profile] {name}: wall {wall * 1e3:.2f} ms, device busy "
            f"{ms_text(busy_ms, 2)} ms{share}; "
            f"top: {[(k[:48], round(v, 3)) for k, v in top[:5]]}")
    return out


@contextlib.contextmanager
def gc_pauses_ms():
    """Record collector pauses, in ms: every full (generation 2) one, and
    every young (generation 0-1) one of 1 ms or more."""
    full, young, t0 = [], [], [0.0]

    def watch(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
            return
        ms = (time.perf_counter() - t0[0]) * 1e3
        if info.get("generation") == 2:
            full.append(ms)
        elif ms >= 1.0:
            young.append(ms)

    gc.callbacks.append(watch)
    try:
        yield full, young
    finally:
        gc.callbacks.remove(watch)


def vec_literal(v: np.ndarray) -> str:
    return "[" + ", ".join(f"{x:.7g}" for x in v.tolist()) + "]"


def recall(got_rows, truth: np.ndarray) -> float:
    return float(np.mean([len(set(g) & set(t.tolist())) / truth.shape[1]
                          for g, t in zip(got_rows, truth)]))


# run()'s groups of phases, in the order they run: the native parse (1),
# the auto-IVF path (3-6, 17, 12a, 19a), the brute-force routes (7-9,
# 12b, 19b, 20), the mesh (21), pq / tt (14), the ANN indexes (15), the
# extended modules (16, 18a), equal scores (22), the wide binary
# collection (10), the hybrid query (11), the shell (13) and the chain's
# classification and clusters (18b-d)
PHASES = ("parse", "ivf", "brute", "mesh", "quantized", "ann", "extended",
          "ties", "wide", "hybrid", "shell", "cluster")
# the groups that take phases 7-9's rows and queries
BRUTE_DATA = ("brute", "mesh", "quantized", "ann", "extended", "ties")


def run(args, dev, config=None, on_card: bool = True,
        phases=None) -> dict:
    """All phases on ``dev``. ``config`` (a VectorEngineConfig) and
    on_card=False exist only to rehearse the control flow on the CPU at
    a toy size: phases 1-2 and the launch checks need the card.
    ``phases`` (names of PHASES; all by default) runs some groups alone,
    each on the data it would have in the whole run (the seeds are drawn
    in the same order), for the rehearsal's tests; the card run takes
    them all."""
    phases = set(PHASES if phases is None else phases)
    if phases - set(PHASES) or (on_card and phases != set(PHASES)):
        raise ValueError(f"phases {sorted(phases)}: names of {PHASES}, "
                         f"all of them on the card")
    import torch

    import neumann_tpu_torch  # noqa: F401  (sets TF32 off)
    from neumann_tpu_torch.ops import kernels as tk

    report = {}
    if on_card:
        os.makedirs("chiprun_out", exist_ok=True)
        report["smi"] = smi_line()
        report["host_cpu"] = host_cpu()
        say(f"[1] {report['smi']}; host {report['host_cpu']}")
        t0 = time.perf_counter()
        tk.build_kernels(verbose=True)
        report["build_kernels_s"] = time.perf_counter() - t0
        say(f"[1] kernels built in {report['build_kernels_s']:.3f} s")
        report["kernels"] = check_kernels(dev, args.rows, args.seed)
        torch.cuda.empty_cache()
        report["kernels"].update(check_new_kernels(dev, args.seed))
        torch.cuda.empty_cache()
        rec, sel = check_pq_adc(dev, args.seed)
        report["kernels"]["pq_adc"] = rec
        report["kernels"]["pq_adc_select"] = sel
        say(f"[2] pq_adc kernel vs plain ({rec['shape']}): scores bit-exact,"
            f" top-{TOP_K} equal"
            + "".join(f"; {sfx[1:] or 'Q=' + str(N_BATCH)} select "
                      f"{sel[f'ms{sfx}']:.4f} ms (device "
                      f"{sel.get(f'device_ms{sfx}')}), scores + "
                      f"_topk_stable {sel[f'scores_topk_ms{sfx}']:.4f} ms, "
                      f"scores {rec[f'ms{sfx}']:.4f} ms, plain select "
                      f"{sel[f'plain_ms{sfx}']:.4f} ms, embedding_bag "
                      f"{rec[f'library_ms{sfx}']:.4f} ms, bound "
                      f"{sel[f'bound_ms{sfx}']:.4f} ms "
                      f"({sel[f'bound_by{sfx}']})"
                      for sfx in ("", "_q8", "_q1", "_ivf", "_m384")))
        torch.cuda.empty_cache()
        sel, scr = check_int8_exact(dev, args.seed)
        report["kernels"]["int8_exact_select"] = sel
        report["kernels"]["int8_exact_scores"] = scr
        torch.cuda.empty_cache()
        report["kernels"]["ivf_topm_select"] = check_ivf_topm(dev, args.seed)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    if "parse" in phases:
        report.update(check_native_parse(args.seed))

    root = np.random.SeedSequence(args.seed)
    s_centres, s_corpus, s_queries = root.spawn(3)
    centres = np.random.default_rng(s_centres).standard_normal(
        (N_CENTRES, DIM)).astype(np.float32)
    if "ivf" in phases:
        report.update(run_ivf(args, dev, centres, s_corpus, s_queries,
                              config, on_card))
    # phases 1-6's router is gone with run_ivf's frame; give its memory
    # back before the brute-force corpora
    gc.unfreeze()
    gc.collect()
    if on_card:
        report["peak_device_mem_gb_ivf"] = \
            torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    s_corpus7, s_queries7 = root.spawn(2)
    shared = {}
    if "brute" in phases:
        report.update(run_brute(args, dev, centres, s_corpus7, s_queries7,
                                on_card, shared))
    elif phases & set(BRUTE_DATA):
        shared.update(zip(("corpus", "queries"), brute_data(
            args, centres, s_corpus7, s_queries7)))
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # ---- phase 21: the same rows on a mesh of logical devices ----------
    if "mesh" in phases:
        report.update(run_mesh(args, dev, shared["corpus"],
                               shared["queries"], on_card, report,
                               router=shared.pop("router", None)))
        for name, rec in report.pop("mesh_kernels", {}).items():
            report["kernels"][name].update(rec)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    shared.pop("router", None)
    adc_recs = ((report["kernels"]["pq_adc"],
                 report["kernels"]["pq_adc_select"]) if on_card else None)
    if "quantized" in phases:
        report.update(run_quantized(args, dev, shared["corpus"],
                                    shared["queries"], on_card, adc_recs))
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    if "ann" in phases:
        report.update(run_ann(args, dev, shared["corpus"],
                              shared["queries"], on_card, adc_recs))
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    if "extended" in phases:
        t0 = time.perf_counter()
        report.update(run_extended(args, dev, shared["corpus"],
                                   shared["queries"], on_card, chain=True))
        report["extended_s"] = (time.perf_counter() - t0
                                - report["phase18a_s"])
    if "ties" in phases:
        report.update(run_ties(dev, shared["corpus"], shared["queries"],
                               on_card))
    del shared
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    s_wide = root.spawn(3)
    if "wide" in phases:
        report.update(run_wide(args, dev, *s_wide, on_card))
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    s_hybrid = root.spawn(3)
    if "hybrid" in phases:
        report.update(run_hybrid(args, dev, centres, *s_hybrid, on_card))
        gc.collect()
    if "shell" in phases:
        report.update(run_shell(dev))
        gc.collect()
    s_cluster = root.spawn(2)
    if "cluster" in phases:
        report.update(run_chain_cluster(args, dev, centres, *s_cluster,
                                        on_card))
    report["launches"] = {
        name: sum(report.get(f"launches_{ph}", {}).get(name, 0)
                  for ph in ROUTES)
        for name in tk.LAUNCHES}
    if on_card:
        missing = [n for n, c in report["launches"].items() if c <= 0]
        if missing:
            raise AssertionError(f"kernels never launched by the counted "
                                 f"phases: {missing}")
        report["peak_device_mem_gb_brute"] = \
            torch.cuda.max_memory_allocated() / 1e9
        report["peak_device_mem_gb"] = max(
            report["peak_device_mem_gb_ivf"],
            report["peak_device_mem_gb_brute"])
    return report


def run_ivf(args, dev, centres, s_corpus, s_queries, config,
            on_card: bool) -> dict:
    """Phases 3-6 and 17: the auto-IVF path at --rows."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.scan import topk_scan
    from neumann_tpu_torch.router import QueryRouter

    report = {}
    t0 = time.perf_counter()
    corpus = mixture(args.rows, centres, s_corpus)
    queries = mixture(N_SINGLE + N_BATCH + 1, centres, s_queries)
    report["generate_s"] = time.perf_counter() - t0
    router = QueryRouter(device=dev)
    if config is not None:
        router.vector.config = config
    t0 = time.perf_counter()
    keys = [f"k{i}" for i in range(args.rows)]
    router.vector.ingest_matrix(keys, corpus, copy=False)
    report["ingest_s"] = time.perf_counter() - t0
    say(f"[3] corpus {args.rows} x {DIM} generated in "
        f"{report['generate_s']:.1f} s, ingested in "
        f"{report['ingest_s']:.1f} s")

    # ---- phase 4: the main path, counted -----------------------------
    quant_sink = []
    with gc_pauses_ms() as (gc_pauses, young), \
            host_int8_sampled(quant_sink):
        tk.reset_launch_counts()
        single_rows, lat = [], []
        for i in range(N_SINGLE):
            stmt = f"SIMILAR {vec_literal(queries[i])} TOP {TOP_K}"
            build_prof = None
            if i == 0 and on_card:
                import cProfile

                build_prof = cProfile.Profile()
                build_prof.enable()
            t0 = time.perf_counter()
            res = router.execute(stmt)
            lat.append(time.perf_counter() - t0)
            if build_prof is not None:
                import io
                import pstats

                build_prof.disable()
                txt = io.StringIO()
                pstats.Stats(build_prof, stream=txt).sort_stats(
                    "cumulative").print_stats(40)
                with open(os.path.join("chiprun_out",
                                       "profile_build_host.txt"), "w") as f:
                    f.write(txt.getvalue())
            scores = [h["score"] for h in res.results]
            if res.kind != "similar" or len(scores) != TOP_K or not all(
                    np.isfinite(scores)) or max(abs(x) for x in scores) > 1.01:
                raise AssertionError(f"bad SIMILAR result: {res.results}")
            single_rows.append([int(h["key"][1:]) for h in res.results])
        report["first_query_incl_build_s"] = lat[0]
        report["single_ms"] = [x * 1e3 for x in lat[1:]]
        warm = np.array(lat[1:]) * 1e3
        report["single_p50_ms"] = float(np.percentile(warm, 50))
        report["single_p99_ms"] = float(np.percentile(warm, 99))
        batch = queries[N_SINGLE:N_SINGLE + N_BATCH]
        times = []
        for _ in range(4):                          # the first one warms up
            t0 = time.perf_counter()
            res_b = router.vector.batch_search(batch, TOP_K)
            times.append(time.perf_counter() - t0)
        report["batch_s"] = times
        times = times[1:]
        report["batch_qps"] = N_BATCH / float(np.median(times))
        launches = dict(tk.LAUNCHES)
    report["gc_gen2_pauses_ms"] = gc_pauses
    report["gc_young_pauses_ms"] = young
    # phase 3's rows as the index build quantized them on the device
    report["host_int8_check"] = check_host_int8(quant_sink)
    del quant_sink
    say(f"[3] host_int8 of the index build: {report['host_int8_check']}"
        f" (rows whose planes differ from the CPU's)")
    say(f"[4] first SIMILAR (incl. index build) "
        f"{report['first_query_incl_build_s']:.2f} s; single p50 "
        f"{report['single_p50_ms']:.3f} ms p99 "
        f"{report['single_p99_ms']:.3f} ms; batch of {N_BATCH}: "
        f"{report['batch_qps']:.0f} QPS; launches {launches}")

    if on_card:
        report["profile"] = profile_paths(
            router, [f"SIMILAR {vec_literal(q)} TOP {TOP_K}"
                     for q in queries[:8]],
            [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in batch[:8]],
            batch, "chiprun_out")

    # ---- phase 5: recall against the exact scan, launches --------------
    slab = router.vector._corpora[""][DIM].slab
    emb, valid = slab.device_view()
    qd = torch.from_numpy(queries[:N_SINGLE + N_BATCH]).to(dev)
    _, oracle = topk_scan(emb, qd, TOP_K, "cosine", valid)
    oracle = oracle.cpu().numpy()
    batch_rows = []
    for hits in res_b:
        if len(hits) != TOP_K or not all(np.isfinite(h.score) for h in hits):
            raise AssertionError(f"bad batch_search result: {hits}")
        batch_rows.append([int(h.key[1:]) for h in hits])
    report["recall_single"] = recall(single_rows, oracle[:N_SINGLE])
    report["recall_batch"] = recall(batch_rows, oracle[N_SINGLE:])
    say(f"[5] recall@{TOP_K}: single {report['recall_single']:.4f}, "
        f"batch {report['recall_batch']:.4f} (>= {MIN_RECALL})")
    if min(report["recall_single"], report["recall_batch"]) < MIN_RECALL:
        raise AssertionError("recall below the limit")
    if on_card:
        require_launches(launches, ("ivf_probe", "batched_probe"), "5")

    # ---- phase 6: delta rescan -----------------------------------------
    key = f"k{args.rows // 3}"
    new = queries[-1]
    router.execute(f"EMBED STORE '{key}' {vec_literal(new)}")
    hits = router.execute(f"SIMILAR {vec_literal(new)} TOP {TOP_K}").results
    if hits[0]["key"] != key or hits[0]["score"] < 0.9999:
        raise AssertionError(f"re-embedded {key} not first: {hits[:3]}")
    say(f"[6] delta rescan: re-embedded {key} comes first "
        f"(score {hits[0]['score']:.6f})")

    report["launches_ivf"] = launches
    # ---- phase 17: TOP 65 batches, the delta plane ----------------------
    t0 = time.perf_counter()
    report.update(run_top65(router, batch[:PHASE17_BATCH],
                            oracle[N_SINGLE:N_SINGLE + PHASE17_BATCH], emb,
                            valid, on_card))
    report.update(run_delta_plane(
        args, router.vector._corpora[""][DIM]._auto_ivf, centres,
        s_corpus.spawn(1)[0], queries, on_card))
    report["phase17_s"] = time.perf_counter() - t0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # ---- phase 12a: served auto-IVF --------------------------------------
    report.update(serve_ivf(router, batch, oracle[N_SINGLE:], on_card))
    # ---- phase 19a: the same served over gRPC -----------------------------
    report.update(serve_grpc_ivf(router, batch, oracle[N_SINGLE:], dev,
                                 on_card))
    return report


# ---------------------------------------------------------------------------
# phase 17: A's TOP 65 batch (the non-fast batched route) and the delta
# plane of an index over A's rows
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def captured(module, name: str):
    """Record the arguments of every call of ``module.name`` inside the
    block (the path calls it through the module), to time that step
    afterwards on the same inputs."""
    seen = []
    saved = getattr(module, name)

    def call(*a, **kw):
        seen.append((a, kw))
        return saved(*a, **kw)

    setattr(module, name, call)
    try:
        yield seen
    finally:
        setattr(module, name, saved)


def torch_step(fn, reps: int, what: str) -> dict:
    """A plain-torch step on the card: its mean time by CUDA events, its
    device time and the CUDA kernels one call launches, from a
    torch.profiler trace of one call (None, with a log line, where the
    trace holds no kernel record: it has lost them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = cuda_ms(fn, reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in tp.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        say(f"[profile] {what}: the trace holds no kernel record: device "
            f"time and launches not measured")
        return dict(ms=ms, device_ms=None, launches=None, what=what)
    dev_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    return dict(ms=ms, device_ms=dev_ms, launches=len(kern), what=what)


def top65_steps(ivf, call: tuple, rerank_call: tuple, on_card: bool
                ) -> dict:
    """The non-fast batched route's three steps, each on the inputs the
    route gave it: the first pass (``batched_ivf_topk``, row 10 inside),
    the pre-selection (``_topk_stable`` of the first-pass scores) and the
    rerank (gather and exact rescore of the survivors); their times,
    launches and the first pass's bound: the probed windows' rows and
    multipliers read once (bytes), and 2 x window x d int8 operations for
    every filled table slot (the padded q_cap slots are the JAX design's
    extra work); and the first pass again with row 10's plain version in
    the kernel's place (``first_pass_plain``)."""
    import torch

    from neumann_tpu_torch.ops import ivf as tivf
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops import rerank as trerank
    from neumann_tpu_torch.ops.scan import _topk_stable

    a, kw = call
    buf, rmult, cents, starts, qs, nprobe, window, m, q_cap = a[:9]
    qn = qs / qs.norm(dim=1, keepdim=True).clamp_min(1e-30)
    probe = tivf._probe_windows(qn, cents, nprobe, kw["probe_mode"])
    probe = torch.where(kw["valid_q"][:, None], probe,
                        torch.full_like(probe, cents.shape[0]))
    tbl, _, overflow = tivf._query_tables(probe, cents.shape[0], q_cap)
    live_windows = int((tbl[:, 0] >= 0).sum())
    filled = int((tbl >= 0).sum())
    d = buf.shape[1]
    ra, rkw = rerank_call
    sc, pos = tivf.batched_ivf_topk(*a, **kw)[:2]
    pre = rkw["pre_select"]
    fs, ci = _topk_stable(sc, pre)
    pos_pre = torch.gather(pos, 1, ci)
    rkw_pre = dict(rkw, first_scores=fs, pre_select=None)
    out = dict(
        shape=f"Q={qs.shape[0]} nprobe={nprobe} window={window} d={d} "
              f"m={m} q_cap={q_cap} pre_select={pre}",
        live_windows=live_windows, filled_slots=filled,
        padded_slots=live_windows * q_cap, overflow=overflow,
        plain_windows_per_step=tk._windows_per_step(window, q_cap, d))
    out.update(bound(live_windows * window * (d + 4) + nbytes(qs)
                     + 8 * sc.numel(),
                     2 * filled * window * d, INT8_OPS_PER_S))
    out["padded_ops_bound_ms"] = (2 * live_windows * q_cap * window * d
                                  / INT8_OPS_PER_S * 1e3)
    if on_card:
        out["first_pass"] = torch_step(
            lambda: tivf.batched_ivf_topk(*a, **kw), 3, "batched_ivf_topk")
        kernel = tk.ivf_window_topm
        tk.ivf_window_topm = tk.ivf_window_topm_plain
        try:
            out["first_pass_plain"] = torch_step(
                lambda: tivf.batched_ivf_topk(*a, **kw), 3,
                "batched_ivf_topk, row 10's plain version")
        finally:
            tk.ivf_window_topm = kernel
        out["pre_select"] = torch_step(
            lambda: _topk_stable(sc, pre), 5, "_topk_stable")
        out["rerank"] = torch_step(
            lambda: trerank.gather_rerank_topk_chunked(
                ra[0], pos_pre, *ra[2:], **rkw_pre), 3,
            "gather_rerank_topk_chunked")
    return out


def run_top65(router, batch, truth10, emb, valid, on_card: bool) -> dict:
    """Phase 17b: 1,024 ``TOP 65`` queries through the router's batch
    search (k_ivf 146 > 128: ``search_batched``'s non-fast branch),
    recall@10 of the first ten hits >= MIN_RECALL against the exact scan,
    recall@65 and the overlap with the latency path's hits recorded; the
    route's steps timed; then the top-1 batched route (row 2 in top-1
    mode, pool expansion in the rerank) at TOP 10, recall >= MIN_RECALL."""
    import torch

    from neumann_tpu_torch.ops import ivf as tivf
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops import rerank as trerank
    from neumann_tpu_torch.ops.scan import topk_scan

    k = TOP65
    report = {}
    eng = router.vector
    ivf = eng._corpora[""][DIM]._auto_ivf
    # counted: the TOP 65 route alone (its first pass row 10; the plain
    # version of the first pass must not run on the card)
    tk.reset_launch_counts()
    with captured(tivf, "batched_ivf_topk") as calls, \
            captured(tivf, "gather_rerank_topk_chunked") as reranks, \
            captured(tk, "ivf_window_topm_plain") as plain_first:
        qps, times, rows, _ = batch_series(
            lambda: eng.batch_search(batch, k), k)
    report["launches_top65"] = dict(tk.LAUNCHES)
    report["top65_plain_first_pass_calls"] = len(plain_first)
    report["top65_batch_qps"] = qps
    report["top65_batch_s"] = times
    # counted apart: the same queries on the latency path (row 1)
    lat_rows = []
    step = eng.config.ivf_auto_max_batch
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    for q0 in range(0, len(batch), step):
        lat_rows += [[int(h.key[1:]) for h in hits]
                     for hits in eng.batch_search(batch[q0:q0 + step], k)]
    report["top65_latency_path_s"] = time.perf_counter() - t0
    report["launches_top65_latency"] = dict(tk.LAUNCHES)
    qd = torch.from_numpy(batch).to(emb.device)
    _, truth65 = topk_scan(emb, qd, k, "cosine", valid)
    truth65 = truth65.cpu().numpy()
    report["top65_recall10"] = recall([r[:TOP_K] for r in rows], truth10)
    report["top65_recall65"] = recall(rows, truth65)
    report["top65_latency_recall65"] = recall(lat_rows, truth65)
    report["top65_overlap_latency"] = recall(rows, np.array(lat_rows))
    fast = [c for c in calls if c[1].get("fused") == "pallas"]
    if fast or not calls:
        raise AssertionError(f"the TOP {k} batch did not take the non-fast "
                             f"batched route ({len(calls)} calls)")
    report["top65_steps"] = top65_steps(ivf, calls[-1], reranks[-1],
                                        on_card)
    say(f"[17b] TOP {k} batch of {len(batch)}: {qps:.0f} QPS; recall@10 "
        f"{report['top65_recall10']:.4f} (>= {MIN_RECALL}), recall@{k} "
        f"{report['top65_recall65']:.4f} (latency path "
        f"{report['top65_latency_recall65']:.4f}, overlap "
        f"{report['top65_overlap_latency']:.4f}); first pass "
        + ", ".join(f"{n} {report['top65_steps'][n]}" for n in (
            "shape", "live_windows", "filled_slots", "bound_ms",
            "bound_by")))
    if on_card:
        st = report["top65_steps"]
        say("[17b] " + "; ".join(
            f"{n} {st[n]['ms']:.3f} ms (device "
            f"{ms_text(st[n]['device_ms'])}, {st[n]['launches']} launches)"
            for n in ("first_pass", "first_pass_plain", "pre_select",
                      "rerank")))
        report["profile_top65"] = profile_calls(
            {"top65_batch": lambda: eng.batch_search(batch, k)},
            "chiprun_out")["top65_batch"]
    if report["top65_recall10"] < MIN_RECALL:
        raise AssertionError(f"TOP {k} batch recall@10 below the limit")

    # the top-1 batched route, called here (no entry point of the port
    # reaches it; in the JAX package only the unported sharded search
    # does), counted apart: row 2's top-1 mode, every (probe, pool)
    # winner, each expanded to its strided pool's rows in the rerank
    window, pool = ivf._window, ivf._window // 128
    valid_q = torch.ones(len(batch), dtype=torch.bool, device=emb.device)
    qp = torch.zeros((len(batch), ivf.dim), device=emb.device)
    qp[:, :DIM] = qd
    q_cap = ivf.default_q_cap(len(batch), ivf.nprobe)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    while True:
        sc, pos, overflow = tivf.batched_ivf_topk(
            ivf._buf, ivf._rmult, ivf.centroids, ivf._starts, qp,
            ivf.nprobe, window, 1, q_cap, valid_q=valid_q, selection=pool,
            fused="pallas", probe_mode="pool")
        if overflow == 0 or q_cap >= len(batch):
            break
        q_cap *= 2
    s1, p1 = trerank.gather_rerank_topk_chunked(
        ivf._buf, pos, qp, TOP_K, "cosine", scale=ivf._scale,
        residual_q=ivf._rbuf, residual_scale=ivf._rscale, first_scores=sc,
        dedup=False, chunk=128, pre_select=8 * TOP_K + 16,
        expand_pool=pool, expand_window=window, valid_rows=ivf._rmult)
    p1 = p1.cpu().numpy()
    report["top1_route_s"] = time.perf_counter() - t0
    report["launches_top1_direct"] = dict(tk.LAUNCHES)
    ids = np.where(p1 >= 0, np.asarray(ivf._row_ids)[np.maximum(p1, 0)], -1)
    report["top1_route_recall10"] = recall(ids.tolist(), truth10)
    report["top1_route_q_cap"] = q_cap
    say(f"[17b] launches: TOP {k} route {report['launches_top65']}; "
        f"latency path {report['launches_top65_latency']}")
    say(f"[17b] top-1 batched route, called directly (row 2 top-1, pool "
        f"{pool} expanded): recall@{TOP_K} "
        f"{report['top1_route_recall10']:.4f} in "
        f"{report['top1_route_s']:.3f} s; launches "
        f"{report['launches_top1_direct']}")
    if report["top1_route_recall10"] < MIN_RECALL:
        raise AssertionError("top-1 batched route recall below the limit")
    if on_card:
        hand = {n: c for n, c in report["launches_top65"].items() if c}
        if set(hand) != {"ivf_topm_select"} or \
                report["top65_plain_first_pass_calls"]:
            raise AssertionError(
                f"[17b] the TOP {k} route's first pass must launch row 10 "
                f"alone and never its plain version: launches {hand}, "
                f"plain calls {report['top65_plain_first_pass_calls']}")
        require_launches(report["launches_top65_latency"], ("ivf_probe",),
                         "17b")
        require_launches(report["launches_top1_direct"],
                         ("batched_probe_top1",), "17b")
    return report


def live_exact_top(ix, q: np.ndarray, k: int, added_ids: np.ndarray,
                   dead: np.ndarray):
    """The exact top-k over an index's live rows, apart from the index's
    own delta scan, merge and tombstones: its main rows and the
    ``added_ids`` rows of its delta plane put into one int8 plane on the
    card, each row's cosine multiplier 1 / ||row|| computed here, the
    ids in ``dead`` (the phase's own record) masked, one
    ``int8_exact_topk_plain`` over the plane (the plain version: apart
    from the kernel the delta scan runs). Host (scores, ids)."""
    import torch

    from neumann_tpu_torch.ops.kernels import int8_exact_topk_plain
    from neumann_tpu_torch.ops.scan import host_pull

    if ix._dn != len(added_ids):
        raise AssertionError(f"[17c] {ix._dn} delta rows for "
                             f"{len(added_ids)} added")
    main_ids = np.asarray(ix._row_ids, np.int64)   # rows past it: padding
    plane = torch.cat([ix._buf[:len(main_ids)], ix._dbuf[:ix._dn]])
    ids = np.concatenate([main_ids, added_ids])
    step = 1 << 18
    norm2 = torch.cat([(plane[r:r + step].float() ** 2).sum(dim=1)
                       for r in range(0, plane.shape[0], step)])
    live = torch.from_numpy(~np.isin(ids, dead)).to(plane.device)
    live &= norm2 > 0
    mult = torch.where(live, norm2.clamp_min(1.0).rsqrt(),
                       torch.zeros_like(norm2))
    qd = torch.from_numpy(np.ascontiguousarray(q)).to(ix.device)
    qf = qd / qd.norm(dim=1, keepdim=True).clamp_min(1e-30)
    s, pos = host_pull(*int8_exact_topk_plain(plane, mult, qf, k))
    del plane
    return s, np.where(pos >= 0, ids[np.maximum(pos, 0)], -1)


def delta_searches(ix, q_single, q_batch, truth, dead: set, tag: str,
                   report: dict) -> None:
    """64 singles (the first timed apart) and a batch (QPS) on ``ix``:
    recall@10 against ``truth``, and no deleted id among the hits."""
    lat, rows = [], []
    for q in q_single:
        t0 = time.perf_counter()
        _, ids = ix.search(q, TOP_K)
        lat.append((time.perf_counter() - t0) * 1e3)
        rows.append(ids[0].tolist())
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        _, ids_b = ix.search_batched(q_batch, TOP_K)
        times.append(time.perf_counter() - t0)
    rows += ids_b.tolist()
    report[f"delta_{tag}_first_ms"] = lat[0]
    report[f"delta_{tag}_p50_ms"] = float(np.percentile(lat[1:], 50))
    report[f"delta_{tag}_batch_qps"] = len(q_batch) / float(
        np.median(times[1:]))
    report[f"delta_{tag}_recall"] = recall(rows, truth)
    back = dead & {i for r in rows for i in r}
    if back:
        raise AssertionError(f"[17c] deleted ids came back ({tag}): "
                             f"{sorted(back)[:8]}")


def run_delta_plane(args, ivf, centres, s_delta, queries, on_card: bool
                    ) -> dict:
    """Phase 17c: an index over A's int8 rows (the engine's layout,
    shared: deletes replace the multipliers, so the engine's index is
    left as it is) takes DELTA_FRAC more rows of the same mixture through
    ``add`` in chunks of DELTA_CHUNK and loses DELETE_FRAC of the old and
    new ids through ``delete``; 64 singles and a batch of 1,024 search it
    (recall@10 >= MIN_RECALL against ``live_exact_top``, built apart
    from the index's delta scan and merge; no deleted id back, each of
    1,024 added rows first for its own vector); then ``compact`` (ids
    preserved) and the same searches."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.ivf import DeviceIVFInt8

    report = {}
    n = args.rows
    n_add = int(n * DELTA_FRAC)
    s_new, s_del = s_delta.spawn(2)
    new = mixture(n_add, centres, s_new)
    ix = DeviceIVFInt8.from_device_layout(
        ivf.dim, ivf.centroids, ivf._buf, ivf._rmult, ivf._starts,
        ivf._row_ids, ivf._window, nprobe=ivf.nprobe, scale=ivf._scale,
        fixed=ivf._fixed, device=ivf.device)
    for key in ("_kmeans_k", "_nprobe_cfg", "iters", "max_read_frac"):
        setattr(ix, key, getattr(ivf, key))
    pad = ivf.dim - DIM

    def padded(x):
        return np.pad(x, ((0, 0), (0, pad))) if pad else x

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    ids = np.concatenate([ix.add(padded(new[s:s + DELTA_CHUNK]))
                          for s in range(0, n_add, DELTA_CHUNK)])
    if on_card:
        torch.cuda.synchronize()
    report["delta_add_s"] = time.perf_counter() - t0
    if ids.tolist() != list(range(n, n + n_add)):
        raise AssertionError("[17c] add did not continue the ids")
    qs = padded(queries[N_SINGLE:N_SINGLE + PHASE17_BATCH])
    t0 = time.perf_counter()
    ix.search(qs[:1], TOP_K)
    report["delta_first_search_after_add_ms"] = (
        time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(s_del)
    n_del = int(n * DELETE_FRAC)
    dead_ids = rng.choice(n + n_add, n_del, replace=False)
    t0 = time.perf_counter()
    removed = ix.delete(dead_ids)
    if on_card:
        torch.cuda.synchronize()
    report["delta_delete_s"] = time.perf_counter() - t0
    if removed != n_del or ix.delete(dead_ids[:16]) != 0:
        raise AssertionError(f"[17c] delete removed {removed} of {n_del}")
    t0 = time.perf_counter()
    ix.search(qs[:1], TOP_K)
    report["delta_first_search_after_delete_ms"] = (
        time.perf_counter() - t0) * 1e3
    dead = set(dead_ids.tolist())
    live_added = np.setdiff1d(np.arange(n_add), dead_ids - n)
    probe_rows = live_added[rng.choice(len(live_added), PHASE17_BATCH,
                                       replace=False)]
    q_single = [padded(queries[i:i + 1]) for i in range(N_SINGLE)]
    q_all = np.concatenate(q_single + [qs])
    t0 = time.perf_counter()
    _, truth = live_exact_top(ix, q_all, TOP_K, ids, dead_ids)
    report["delta_oracle_s"] = time.perf_counter() - t0
    delta_searches(ix, q_single, qs, truth, dead, "before", report)
    _, ids_b = ix.search_batched(padded(new[probe_rows]), TOP_K)
    _, ids_s = ix.search(padded(new[probe_rows[:N_SINGLE]]), TOP_K)
    first = np.concatenate([ids_b[:, 0], ids_s[:, 0]])
    want = np.concatenate([n + probe_rows, n + probe_rows[:N_SINGLE]])
    # TOP 65 singles: the delta scan's scores mode (k above its cap)
    lat65 = []
    for r in probe_rows[:N_DELTA_TOP65]:
        t0 = time.perf_counter()
        _, ids65 = ix.search(padded(new[r:r + 1]), TOP65)
        lat65.append((time.perf_counter() - t0) * 1e3)
        first = np.append(first, ids65[0, 0])
        want = np.append(want, n + r)
        if dead & set(ids65[0].tolist()):
            raise AssertionError("[17c] deleted ids came back (TOP 65)")
    report["delta_top65_p50_ms"] = float(np.median(lat65))
    report["delta_added_first"] = float(np.mean(first == want))
    if report["delta_added_first"] < 1.0:
        raise AssertionError(f"[17c] an added row did not come first for "
                             f"its own vector: "
                             f"{report['delta_added_first']}")
    launches = dict(tk.LAUNCHES)
    report["delta_scan"] = delta_scan_times(ix, qs, on_card)

    t0 = time.perf_counter()
    n_live = ix.compact()
    if on_card:
        torch.cuda.synchronize()
    report["delta_compact_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix.search(qs[:1], TOP_K)
    report["delta_first_search_after_compact_ms"] = (
        time.perf_counter() - t0) * 1e3
    live = np.setdiff1d(np.arange(n + n_add), dead_ids)
    if n_live != len(live) or not np.array_equal(
            np.sort(np.asarray(ix._row_ids)), live):
        raise AssertionError("[17c] compact did not keep the live ids")
    tk.reset_launch_counts()
    delta_searches(ix, q_single, qs, truth, dead, "after", report)
    report["launches_delta"] = {
        k: launches.get(k, 0) + v for k, v in tk.LAUNCHES.items()}
    report["delta_recall_drop"] = (report["delta_before_recall"]
                                   - report["delta_after_recall"])
    report.update(delta_rows_added=n_add, delta_rows_deleted=n_del,
                  delta_live_rows=n_live)
    say(f"[17c] delta plane: add {n_add} rows {report['delta_add_s']:.3f} s, "
        f"delete {n_del} {report['delta_delete_s']:.3f} s, compact "
        f"{report['delta_compact_s']:.2f} s; first search after add / "
        f"delete / compact "
        f"{report['delta_first_search_after_add_ms']:.2f} / "
        f"{report['delta_first_search_after_delete_ms']:.2f} / "
        f"{report['delta_first_search_after_compact_ms']:.2f} ms; single "
        f"p50 {report['delta_before_p50_ms']:.3f} -> "
        f"{report['delta_after_p50_ms']:.3f} ms, batch "
        f"{report['delta_before_batch_qps']:.0f} -> "
        f"{report['delta_after_batch_qps']:.0f} QPS, recall@{TOP_K} "
        f"{report['delta_before_recall']:.4f} -> "
        f"{report['delta_after_recall']:.4f} (>= {MIN_RECALL}); added "
        f"rows first {report['delta_added_first']:.4f}; delta scan "
        f"{ {k: v for k, v in report['delta_scan'].items()} }; launches "
        f"{report['launches_delta']}")
    if min(report["delta_before_recall"],
           report["delta_after_recall"]) < MIN_RECALL:
        raise AssertionError("[17c] recall below the limit")
    if on_card:
        require_launches(report["launches_delta"],
                         ("ivf_probe", "batched_probe", "int8_exact_select",
                          "int8_exact_scores"), "17c")
    return report


def delta_scan_times(ix, qs: np.ndarray, on_card: bool) -> dict:
    """Phase 17c: row 9 on the index's own delta plane (its filled
    slots) at the delta batch's Q and at Q 1, top-10: the call (CUDA
    events), the kernel's device time, the plain version's, the product
    alone by ``torch.matmul`` (TF32 off), and the bound."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    plane, mult = ix._dbuf[:ix._dn], ix._drmult[:ix._dn]
    qd = torch.from_numpy(qs).to(ix.device)
    qf = qd / qd.norm(dim=1, keepdim=True).clamp_min(1e-30)
    out = dict(shape=f"Q={len(qs)} (and 1) x {ix._dn} filled delta slots "
                     f"(of {int(ix._dbuf.shape[0])}) x d {ix.dim}, k "
                     f"{TOP_K}")
    if not on_card:
        return out
    torch.backends.cuda.matmul.allow_tf32 = False
    cf = plane.float()
    for sfx, q in (("", len(qs)), ("_q1", 1)):
        _, lib = turns(lambda: tk.int8_exact_topk(plane, mult, qf[:q], TOP_K),
                       lambda: torch.matmul(qf[:q], cf.t()),
                       3 if q > 1 else 20)
        exact_record(out, sfx, plane, mult, qf[:q], TOP_K,
                     3 if q > 1 else 20, lib)
    del cf
    return out


def require_launches(launches: dict, names, phase: str) -> None:
    missing = [n for n in names if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"[{phase}] kernels of the path never "
                             f"launched: {missing} ({launches})")


def similar_series(router, stmts, cosine: bool = True, k: int = TOP_K):
    """Execute SIMILAR statements one by one, host clock around each.
    Returns (latencies ms, row ids per statement, scores per statement);
    each must give k finite hits (cosine ones within [-1.01, 1.01])."""
    lat, rows, scores = [], [], []
    for stmt in stmts:
        t0 = time.perf_counter()
        res = router.execute(stmt)
        lat.append((time.perf_counter() - t0) * 1e3)
        sc = [h["score"] for h in res.results]
        if res.kind != "similar" or len(sc) != k or not all(
                np.isfinite(sc)) or (cosine and max(map(abs, sc)) > 1.01):
            raise AssertionError(f"bad SIMILAR result ({stmt[:32]}...): "
                                 f"{res.results}")
        rows.append([int(h["key"][1:]) for h in res.results])
        scores.append(sc)
    return lat, rows, scores


def batch_series(fn, k: int = TOP_K):
    """Four calls of a batch search (the first warms up): QPS over the
    median of the last three, the call times, and the last result's
    (row ids, scores) per query; each query must get k finite hits."""
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        res = fn()
        times.append(time.perf_counter() - t0)
    rows, scores = [], []
    for hits in res:
        if len(hits) != k or not all(np.isfinite(h.score) for h in hits):
            raise AssertionError(f"bad batch result: {hits}")
        rows.append([int(h.key[1:]) for h in hits])
        scores.append([h.score for h in hits])
    return len(res) / float(np.median(times[1:])), times, rows, scores


def latency_stats(report: dict, prefix: str, lat) -> None:
    """First call on its own (it builds the route's device view), p50 and
    p99 over the rest."""
    report[f"{prefix}_first_ms"] = lat[0]
    report[f"{prefix}_ms"] = lat[1:]
    report[f"{prefix}_p50_ms"] = float(np.percentile(lat[1:], 50))
    report[f"{prefix}_p99_ms"] = float(np.percentile(lat[1:], 99))


def brute_data(args, centres, s_corpus, s_queries) -> tuple:
    """Phases 7-9's rows (--pooled-rows) and their queries (singles, the
    batch, the filtered), which phases 14-16, 21 and 22 take too."""
    return (mixture(args.pooled_rows, centres, s_corpus),
            mixture(N_SINGLE + N_BATCH + N_FILTERED, centres, s_queries))


def run_brute(args, dev, centres, s_corpus, s_queries,
              on_card: bool, shared: dict) -> dict:
    """Phases 7-9: the brute-force routes at --pooled-rows (f32 pooled,
    int8 pooled and int8 scan, binary), each counted on its own. The
    rows and queries are left in ``shared`` for phases 14-15."""
    import torch

    from neumann_tpu_torch.engines.vector import FilterCondition
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.quant import (
        binary_quantize,
        hamming_topk,
        int8_topk_scan,
    )
    from neumann_tpu_torch.ops.scan import topk_scan
    from neumann_tpu_torch.router import QueryRouter

    n = args.pooled_rows
    report = {}
    t0 = time.perf_counter()
    corpus, queries = brute_data(args, centres, s_corpus, s_queries)
    single = queries[:N_SINGLE]
    batch = queries[N_SINGLE:N_SINGLE + N_BATCH]
    extra = queries[N_SINGLE + N_BATCH:]
    report["pooled_generate_s"] = time.perf_counter() - t0
    shared.update(corpus=corpus, queries=queries)
    router = QueryRouter(device=dev)
    eng = router.vector
    t0 = time.perf_counter()
    with eng.bulk_ingest():
        for i in range(n):
            eng.store_embedding(f"k{i}", corpus[i], {"cat": i % N_CATS})
    report["pooled_ingest_s"] = time.perf_counter() - t0
    base = eng._corpora[""][DIM]
    say(f"[7] corpus {n} x {DIM} generated in "
        f"{report['pooled_generate_s']:.1f} s, stored row by row (with "
        f"metadata) in {report['pooled_ingest_s']:.1f} s; slab capacity "
        f"{base.slab.capacity}")

    # the exact f32 scan over all rows: the recall oracle of phases 7-9
    cond = FilterCondition.eq("cat", FILTER_CAT)
    t0 = time.perf_counter()
    cat_rows = base.filter_mask(cond)
    report["filter_mask_ms"] = (time.perf_counter() - t0) * 1e3
    emb, valid = base.slab.device_view()
    qd = torch.from_numpy(queries).to(dev)
    _, oracle = topk_scan(emb, qd, TOP_K, "cosine", valid)
    _, oracle_f = topk_scan(emb, qd[N_SINGLE + N_BATCH:], TOP_K, "cosine",
                            valid & torch.from_numpy(cat_rows).to(dev))
    oracle, oracle_f = oracle.cpu().numpy(), oracle_f.cpu().numpy()
    del emb, valid

    # ---- phase 7: the default pooled route, counted --------------------
    stmts = [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in single]
    with gc_pauses_ms() as (pauses, young):
        tk.reset_launch_counts()
        lat, rows_s, _ = similar_series(router, stmts)
        qps, times, rows_b, _ = batch_series(
            lambda: eng.batch_search(batch, TOP_K))
        lat_f, rows_f, _ = similar_series(router, [
            f"SIMILAR {vec_literal(q)} WHERE cat = {FILTER_CAT} TOP {TOP_K}"
            for q in extra])
        launches = dict(tk.LAUNCHES)
    report["gc_gen2_pauses_ms_pooled"] = pauses
    report["gc_young_pauses_ms_pooled"] = young
    report["launches_pooled"] = launches
    latency_stats(report, "pooled_single", lat)
    latency_stats(report, "pooled_filtered", lat_f)
    report["pooled_batch_s"] = times
    report["pooled_batch_qps"] = qps
    report["pooled_recall_single"] = recall(rows_s, oracle[:N_SINGLE])
    report["pooled_recall_batch"] = recall(rows_b, oracle[N_SINGLE:
                                                          N_SINGLE + N_BATCH])
    report["pooled_recall_filtered"] = recall(rows_f, oracle_f)
    off_cat = [r for rr in rows_f for r in rr if r % N_CATS != FILTER_CAT]
    say(f"[7] pooled route: single p50 {report['pooled_single_p50_ms']:.3f} "
        f"ms p99 {report['pooled_single_p99_ms']:.3f} ms (first "
        f"{lat[0]:.1f} ms); batch of {N_BATCH}: {qps:.0f} QPS; filtered "
        f"p50 {report['pooled_filtered_p50_ms']:.3f} ms (filter_mask "
        f"{report['filter_mask_ms']:.1f} ms); recall@{TOP_K} single "
        f"{report['pooled_recall_single']:.4f} batch "
        f"{report['pooled_recall_batch']:.4f} filtered "
        f"{report['pooled_recall_filtered']:.4f}; launches {launches}")
    if off_cat:
        raise AssertionError(f"filtered hits outside cat {FILTER_CAT}: "
                             f"{off_cat[:5]}")
    if min(report["pooled_recall_single"], report["pooled_recall_batch"],
           report["pooled_recall_filtered"]) < MIN_RECALL:
        raise AssertionError("pooled route recall below the limit")
    if on_card:
        require_launches(launches, ("f32_pooled_bits",), "7")
        report["profile_pooled"] = profile_calls(
            {"pooled_single": lambda: [router.execute(s)
                                       for s in stmts[:8]],
             "pooled_batch": lambda: eng.batch_search(batch, TOP_K)},
            "chiprun_out")

    # ---- phase 8: an int8 collection, counted ---------------------------
    router.execute(f"CREATE COLLECTION q8 DIM {DIM} QUANTIZATION int8")
    t0 = time.perf_counter()
    with eng.bulk_ingest():
        for i in range(n):
            eng.store_in_collection("q8", f"k{i}", corpus[i])
    report["int8_ingest_s"] = time.perf_counter() - t0
    stmts = [f"SIMILAR {vec_literal(q)} IN q8 TOP {TOP_K}" for q in single]
    with gc_pauses_ms() as (pauses, young):
        tk.reset_launch_counts()
        lat, rows_s, _ = similar_series(router, stmts)
        qps, times, rows_b, _ = batch_series(
            lambda: eng.batch_search_ns(batch, TOP_K, ns="col/q8"))
        lat_e, rows_e, _ = similar_series(router, [
            f"SIMILAR {vec_literal(q)} IN q8 METRIC euclidean TOP {TOP_K}"
            for q in extra], cosine=False)
        launches = dict(tk.LAUNCHES)
    report["gc_gen2_pauses_ms_int8"] = pauses
    report["gc_young_pauses_ms_int8"] = young
    report["launches_int8"] = launches
    latency_stats(report, "int8_single", lat)
    latency_stats(report, "int8_euclid", lat_e)
    report["int8_batch_s"] = times
    report["int8_batch_qps"] = qps
    report["int8_recall_single"] = recall(rows_s, oracle[:N_SINGLE])
    report["int8_recall_batch"] = recall(rows_b, oracle[N_SINGLE:
                                                        N_SINGLE + N_BATCH])
    # the int8 scan's reference: the plain int8_topk_scan on the card
    q8 = eng._corpora["col/q8"][DIM]
    with plain_kernels():
        cq, cs, valid = q8.slab.quantized_view("int8")
        ref_s, ref_i = int8_topk_scan(cq, cs, qd[N_SINGLE + N_BATCH:], TOP_K,
                                      "euclidean", valid)
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    bad = []
    for r, got in enumerate(rows_e):
        want = [int(k[1:]) for k in q8.index.keys_of(ref_i[r].tolist())]
        for j in range(TOP_K):
            if (ref_s[r] == ref_s[r, j]).sum() == 1 and got[j] != want[j]:
                bad.append((r, j, got[j], want[j]))
    report["int8_euclid_mismatches"] = len(bad)
    say(f"[8] int8 collection (stored in {report['int8_ingest_s']:.1f} s): "
        f"single p50 {report['int8_single_p50_ms']:.3f} ms p99 "
        f"{report['int8_single_p99_ms']:.3f} ms; batch of {N_BATCH}: "
        f"{qps:.0f} QPS; recall@{TOP_K} single "
        f"{report['int8_recall_single']:.4f} batch "
        f"{report['int8_recall_batch']:.4f}; euclidean p50 "
        f"{report['int8_euclid_p50_ms']:.3f} ms, ids vs the plain int8 "
        f"scan: {len(bad)} mismatches; launches {launches}")
    if bad:
        raise AssertionError(f"int8 euclidean ids differ from the plain "
                             f"scan: {bad[:5]}")
    if min(report["int8_recall_single"],
           report["int8_recall_batch"]) < MIN_RECALL:
        raise AssertionError("int8 route recall below the limit")
    if on_card:
        require_launches(launches, ("int8_pooled_bits", "int8_dot_scores"),
                         "8")

    # ---- phase 9: a binary collection, counted --------------------------
    router.execute(f"CREATE COLLECTION bits DIM {DIM} QUANTIZATION binary")
    t0 = time.perf_counter()
    with eng.bulk_ingest():
        for i in range(n):
            eng.store_in_collection("bits", f"k{i}", corpus[i])
    report["binary_ingest_s"] = time.perf_counter() - t0
    stmts = [f"SIMILAR {vec_literal(q)} IN bits TOP {TOP_K}" for q in single]
    # above the fused kernel's k cap the route takes hamming_scores
    top_wide = tk.HAMMING_TOPK_CAP + 1
    with gc_pauses_ms() as (pauses, young):
        tk.reset_launch_counts()
        lat, rows_s, sc_s = similar_series(router, stmts, cosine=False)
        qps, times, rows_b, sc_b = batch_series(
            lambda: eng.batch_search_ns(batch, TOP_K, ns="col/bits"))
        wide = [router.execute(f"SIMILAR {vec_literal(q)} IN bits TOP "
                               f"{top_wide}").results for q in extra[:4]]
        qps_w, times_w, rows_bw, sc_bw = batch_series(
            lambda: eng.batch_search_ns(batch, top_wide, ns="col/bits"),
            top_wide)
        launches = dict(tk.LAUNCHES)
    # the same statements again, parsed now: the route without the parse
    # of a 768-float literal, which dominates the p50 above
    lat_parsed, _, _ = similar_series(router, stmts, cosine=False)
    report["binary_single_parsed_p50_ms"] = float(np.percentile(lat_parsed,
                                                                50))
    report["gc_gen2_pauses_ms_binary"] = pauses
    report["gc_young_pauses_ms_binary"] = young
    report["launches_binary"] = launches
    latency_stats(report, "binary_single", lat)
    report["binary_batch_s"] = times
    report["binary_batch_qps"] = qps
    report["binary_top65_batch_s"] = times_w
    report["binary_top65_batch_qps"] = qps_w
    # recall of 1-bit codes against the f32 scan: recorded, not a limit
    report["binary_recall_vs_f32"] = recall(rows_s + rows_b,
                                            oracle[:N_SINGLE + N_BATCH])
    # the reference: the plain hamming top-k on the card, ids and
    # distances in the same order (equal distances by row)
    bits_c = eng._corpora["col/bits"][DIM]
    with plain_kernels():
        bits, valid = bits_c.slab.quantized_view("binary")
        ref = hamming_topk(bits, binary_quantize(qd[:N_SINGLE + N_BATCH]),
                           TOP_K, valid)
        ref_w = hamming_topk(bits, binary_quantize(
            qd[N_SINGLE + N_BATCH:][:4]), top_wide, valid)
        sample = list(range(0, N_BATCH, N_BATCH // N_WIDE_SAMPLE))
        ref_bw = hamming_topk(bits, binary_quantize(
            qd[N_SINGLE:N_SINGLE + N_BATCH][sample]), top_wide, valid)

    def mismatches(rows, scores, ref_pair):
        ref_s, ref_i = (t.cpu().numpy() for t in ref_pair)
        bad = []
        for r, (got_rows, got_s) in enumerate(zip(rows, scores)):
            want = [int(k[1:]) for k in bits_c.index.keys_of(
                ref_i[r].tolist())]
            if got_rows != want or got_s != ref_s[r].tolist():
                bad.append(r)
        return bad

    bad = mismatches(rows_s + rows_b, sc_s + sc_b, ref)
    bad_w = mismatches([[int(h["key"][1:]) for h in res] for res in wide],
                       [[h["score"] for h in res] for res in wide], ref_w)
    bad_bw = mismatches([rows_bw[i] for i in sample],
                        [sc_bw[i] for i in sample], ref_bw)
    report["binary_mismatches"] = len(bad) + len(bad_w) + len(bad_bw)
    say(f"[9] binary collection (stored in {report['binary_ingest_s']:.1f} "
        f"s): single p50 {report['binary_single_p50_ms']:.3f} ms p99 "
        f"{report['binary_single_p99_ms']:.3f} ms (parsed statements: p50 "
        f"{report['binary_single_parsed_p50_ms']:.3f} ms); batch of "
        f"{N_BATCH}: "
        f"{qps:.0f} QPS, at TOP {top_wide} {qps_w:.0f} QPS; ids and "
        f"distances vs the plain hamming top-{TOP_K}: {len(bad)} queries "
        f"differ, top-{top_wide}: {len(bad_w)} of 4 singles and "
        f"{len(bad_bw)} of {len(sample)} batch queries differ; recall vs "
        f"f32 {report['binary_recall_vs_f32']:.4f}; launches {launches}")
    if bad or bad_w or bad_bw:
        raise AssertionError(f"binary ids or distances differ from the "
                             f"plain hamming top-k for queries {bad[:5]}, "
                             f"top-{top_wide} {bad_w}, batch {bad_bw[:5]}")
    if on_card:
        require_launches(launches, ("hamming_topk", "hamming_scores"), "9")
        report["profile_quantized"] = prof = profile_calls(
            {"int8_batch": lambda: eng.batch_search_ns(batch, TOP_K,
                                                       ns="col/q8"),
             "binary_single": lambda: [router.execute(s) for s in stmts[:8]],
             "binary_batch": lambda: eng.batch_search_ns(batch, TOP_K,
                                                         ns="col/bits"),
             "binary_top65_batch": lambda: eng.batch_search_ns(
                 batch, top_wide, ns="col/bits")},
            "chiprun_out")
        # the TOP 65 batch's device time: the hamming distances (row 3)
        # against the keyed merge (hamming_keys, merge_keys' topk and cat)
        top65 = prof["binary_top65_batch"]
        row3 = rest = None
        if top65["device_busy_ms"] is not None:
            row3 = sum(v for k, v in top65["kernels_ms"].items()
                       if "hamming" in k)
            rest = top65["device_busy_ms"] - row3
        report["binary_top65_split_ms"] = dict(
            hamming_scores=row3, keyed_merge_and_rest=rest,
            wall=top65["wall_ms"])
        say(f"[9] TOP {top_wide} batch device time: hamming_scores "
            f"{ms_text(row3)} ms, keyed merge and the rest "
            f"{ms_text(rest)} ms, of {top65['wall_ms']:.1f} ms")

    # ---- phase 12b: the brute-force routes served ------------------------
    report.update(serve_brute(
        router, batch, extra, oracle[N_SINGLE:N_SINGLE + N_BATCH], oracle_f,
        (ref[0][N_SINGLE:], ref[1][N_SINGLE:]), bits_c.index, on_card))
    # ---- phase 19b: the same routes served over gRPC ----------------------
    report.update(serve_grpc_brute(
        router, batch, extra, oracle[N_SINGLE:N_SINGLE + N_BATCH], oracle_f,
        (ref[0][N_SINGLE:], ref[1][N_SINGLE:]), bits_c.index, dev, on_card))

    # ---- phase 20: the same rows on shard servers, SIMILAR fanned out ---
    report.update(run_sharded(dev, corpus, queries, oracle, args.seed,
                              on_card, report))
    # phase 21 places this router's rows on a mesh
    shared["router"] = router
    return report


def run_wide(args, dev, s_centres, s_corpus, s_queries,
             on_card: bool) -> dict:
    """Phase 10: a 3,072-d QUANTIZATION binary collection (96 words a row,
    the width past which the hamming kernels once refused), WIDE_ROWS rows
    of the same recipe in 3,072-d, counted: N_WIDE_SINGLE single SIMILARs
    TOP 10, N_WIDE_TOP65 TOP 65 (hamming_scores) and a batch of
    N_WIDE_BATCH at TOP 10 (the fused top-k); ids and distances equal to
    the plain hamming top-k's, in order."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.quant import binary_quantize, hamming_topk
    from neumann_tpu_torch.router import QueryRouter

    n = args.wide_rows
    report = {}
    t0 = time.perf_counter()
    centres = np.random.default_rng(s_centres).standard_normal(
        (N_CENTRES, WIDE_DIM)).astype(np.float32)
    corpus = mixture(n, centres, s_corpus)
    queries = mixture(N_WIDE_SINGLE + N_WIDE_TOP65 + N_WIDE_BATCH, centres,
                      s_queries)
    report["wide_generate_s"] = time.perf_counter() - t0
    single = queries[:N_WIDE_SINGLE]
    top65 = queries[N_WIDE_SINGLE:N_WIDE_SINGLE + N_WIDE_TOP65]
    batch = queries[N_WIDE_SINGLE + N_WIDE_TOP65:]
    router = QueryRouter(device=dev)
    eng = router.vector
    router.execute(f"CREATE COLLECTION wide DIM {WIDE_DIM} QUANTIZATION "
                   f"binary")
    t0 = time.perf_counter()
    with eng.bulk_ingest():
        for i in range(n):
            eng.store_in_collection("wide", f"k{i}", corpus[i])
    report["wide_ingest_s"] = time.perf_counter() - t0
    del corpus
    top_wide = tk.HAMMING_TOPK_CAP + 1
    with gc_pauses_ms() as (pauses, young):
        tk.reset_launch_counts()
        lat, rows_s, sc_s = similar_series(router, [
            f"SIMILAR {vec_literal(q)} IN wide TOP {TOP_K}" for q in single],
            cosine=False)
        wide = [router.execute(f"SIMILAR {vec_literal(q)} IN wide TOP "
                               f"{top_wide}").results for q in top65]
        qps, times, rows_b, sc_b = batch_series(
            lambda: eng.batch_search_ns(batch, TOP_K, ns="col/wide"))
        launches = dict(tk.LAUNCHES)
    report["gc_gen2_pauses_ms_wide"] = pauses
    report["gc_young_pauses_ms_wide"] = young
    report["launches_wide"] = launches
    latency_stats(report, "wide_single", lat)
    report["wide_batch_s"] = times
    report["wide_batch_qps"] = qps
    coll = eng._corpora["col/wide"][WIDE_DIM]
    qd = torch.from_numpy(queries).to(dev)
    with plain_kernels():
        bits, valid = coll.slab.quantized_view("binary")
        ref = hamming_topk(bits, binary_quantize(torch.cat(
            [qd[:N_WIDE_SINGLE], qd[N_WIDE_SINGLE + N_WIDE_TOP65:]])),
            TOP_K, valid)
        ref_w = hamming_topk(bits, binary_quantize(
            qd[N_WIDE_SINGLE:N_WIDE_SINGLE + N_WIDE_TOP65]), top_wide, valid)
    bad = []
    for k, got_rows, got_s, ref_pair in (
            (TOP_K, rows_s + rows_b, sc_s + sc_b, ref),
            (top_wide, [[int(h["key"][1:]) for h in r] for r in wide],
             [[h["score"] for h in r] for r in wide], ref_w)):
        ref_s, ref_i = (t.cpu().numpy() for t in ref_pair)
        for r, (gr, gs) in enumerate(zip(got_rows, got_s)):
            want = [int(key[1:]) for key in coll.index.keys_of(
                ref_i[r].tolist())]
            if gr != want or gs != ref_s[r].tolist():
                bad.append((k, r))
    report["wide_mismatches"] = len(bad)
    say(f"[10] {WIDE_DIM}-d binary collection, {n} rows (generated in "
        f"{report['wide_generate_s']:.1f} s, stored in "
        f"{report['wide_ingest_s']:.1f} s): single p50 "
        f"{report['wide_single_p50_ms']:.3f} ms; batch of {len(batch)}: "
        f"{report['wide_batch_qps']:.0f} QPS; ids and distances vs the "
        f"plain hamming top-k: {len(bad)} of "
        f"{len(rows_s) + len(rows_b) + len(wide)} queries differ; launches "
        f"{launches}")
    if bad:
        raise AssertionError(f"{WIDE_DIM}-d binary ids or distances differ "
                             f"from the plain hamming top-k: {bad[:5]}")
    if on_card:
        require_launches(launches, ("hamming_topk", "hamming_scores"), "10")
    return report


def _neighbours(src: np.ndarray, dst: np.ndarray, node: int) -> np.ndarray:
    """Sorted rows joined to ``node`` by an edge either way (the unified
    engine's CONNECTED TO neighbourhood)."""
    return np.union1d(dst[src == node], src[dst == node])


def exact_masked(corpus: np.ndarray, rows: np.ndarray, q: np.ndarray,
                 k: int):
    """float64 cosine top-k over ``rows``: (rows, scores), best first,
    equal scores by ascending row."""
    v = corpus[rows].astype(np.float64)
    s = v @ q.astype(np.float64) / (np.linalg.norm(v, axis=1)
                                    * np.linalg.norm(q.astype(np.float64)))
    order = np.lexsort((rows, -s))[:k]
    return rows[order], s[order]


def check_ranked(hits, corpus, rows, q, k: int) -> int:
    """One SIMILAR's hits against the exact masked scan: the same keys in
    order, scores within HYBRID_ATOL. Two keys may trade places only when
    their exact scores differ by less than SWAP_TOL; returns how many
    positions did."""
    want_rows, want_s = exact_masked(corpus, rows, q, k)
    got_rows = np.array([int(h["key"][1:]) for h in hits], np.int64)
    got_s = np.array([h["score"] for h in hits])
    if len(got_rows) != len(want_rows):
        raise AssertionError(f"{len(got_rows)} hits, the exact masked scan "
                             f"has {len(want_rows)}")
    if not np.all(np.abs(got_s - want_s) <= HYBRID_ATOL):
        raise AssertionError(f"scores off the exact masked scan by "
                             f"{np.abs(got_s - want_s).max()} (atol "
                             f"{HYBRID_ATOL})")
    swaps = 0
    exact = dict(zip(*exact_masked(corpus, rows, q, len(rows))))
    for j in np.flatnonzero(got_rows != want_rows):
        if got_rows[j] not in exact or \
                abs(exact[got_rows[j]] - want_s[j]) >= SWAP_TOL:
            raise AssertionError(
                f"hit {j}: row {got_rows[j]} where the exact masked scan "
                f"has row {want_rows[j]} (not a near-tie)")
        swaps += 1
    return swaps


def run_hybrid(args, dev, centres, s_corpus, s_queries, s_graph,
               on_card: bool) -> dict:
    """Phase 11: the hybrid query (cell F) through a router of its own.
    HYBRID_ROWS entities ``{"tier": i % 16}`` with bench.py's corpus
    recipe, HYBRID_EDGES random directed ``rel`` edges and N_HUBS hubs
    of HUB_DEGREE out-neighbours each (bench_all.py:106-119); counted:
    N_HYBRID ``SIMILAR … CONNECTED TO`` hubs (sparse mask, the exact flat
    scan), one ``NEIGHBORS … BY SIMILARITY`` per hub, N_FIND ``FIND …
    WHERE tier = 3 SIMILAR TO`` (dense mask, the f32 pooled route), then
    PageRank, connected components and BFS from a hub over the whole
    graph; each held to a float64 numpy or scipy reference. Then a small
    SQL pass."""
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import connected_components, shortest_path

    from neumann_tpu_torch.engines.vector import _pooled_pool
    from neumann_tpu_torch.ops import graph_kernels as gk
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.router import QueryRouter

    n, m = HYBRID_ROWS, HYBRID_EDGES
    report = {}
    t0 = time.perf_counter()
    corpus = mixture(n, centres, s_corpus)
    queries = mixture(N_HYBRID + N_FIND, centres, s_queries)
    rng = np.random.default_rng(s_graph)
    hubs = rng.choice(n, N_HUBS, replace=False)
    src = np.concatenate([rng.integers(0, n, m),
                          np.repeat(hubs, HUB_DEGREE)])
    dst = np.concatenate([rng.integers(0, n, m)] + [
        rng.choice(n, HUB_DEGREE, replace=False) for _ in hubs])
    report["hybrid_generate_s"] = time.perf_counter() - t0
    router = QueryRouter(device=dev)
    t0 = time.perf_counter()
    with router.vector.bulk_ingest():
        for i in range(n):
            router.unified.create_entity(f"e{i}", {"tier": i % N_TIERS},
                                         corpus[i])
    report["hybrid_entity_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    router.graph.batch_create_edges(
        [(a, b, "rel") for a, b in zip(src.tolist(), dst.tolist())])
    report["hybrid_edge_load_s"] = time.perf_counter() - t0
    if any(router.unified.node_id_of(f"e{h}") != h for h in hubs):
        raise AssertionError("entity node ids are not their rows")
    say(f"[11] {n} entities loaded in {report['hybrid_entity_load_s']:.1f} "
        f"s, {len(src)} edges in {report['hybrid_edge_load_s']:.1f} s")

    # the gate: FIND's tier mask opens the pooled route, a hub's
    # neighbourhood does not (the exact flat scan)
    ent = router.vector.entity_corpus(DIM)
    tier_rows = np.arange(FIND_TIER, n, N_TIERS)
    mask_ms, hub_rows = [], {}
    for h in hubs:
        hub_rows[h] = _neighbours(src, dst, h)
        keys = {f"e{r}" for r in hub_rows[h].tolist()}
        t0 = time.perf_counter()
        mask = router.unified._keys_to_row_mask(keys, DIM)
        mask_ms.append((time.perf_counter() - t0) * 1e3)
        if _pooled_pool(ent, TOP_K, "cosine", mask) is not None:
            raise AssertionError(f"hub {h}'s mask opens the pooled gate")
    report["hybrid_mask_ms"] = mask_ms
    tier_mask = np.zeros(ent.slab.capacity, bool)
    tier_mask[tier_rows] = True
    report["hybrid_find_pool"] = _pooled_pool(ent, TOP_K, "cosine",
                                              tier_mask)
    if report["hybrid_find_pool"] is None:
        raise AssertionError("FIND's tier mask does not open the pooled "
                             "gate")

    hub_of = [int(hubs[i % N_HUBS]) for i in range(N_HYBRID)]
    stmts = [f"SIMILAR {vec_literal(q)} TOP {TOP_K} CONNECTED TO 'e{h}'"
             for q, h in zip(queries[:N_HYBRID], hub_of)]
    nb_stmts = [f"NEIGHBORS {h} BOTH BY SIMILARITY LIMIT {TOP_K}"
                for h in hubs]
    find_stmts = [f"FIND NODE entity WHERE tier = {FIND_TIER} SIMILAR TO "
                  f"{vec_literal(q)} LIMIT {TOP_K}"
                  for q in queries[N_HYBRID:]]

    def timed(stmts_):
        lat, out = [], []
        for stmt in stmts_:
            t0 = time.perf_counter()
            out.append(router.execute(stmt))
            lat.append((time.perf_counter() - t0) * 1e3)
        return lat, out

    t0 = time.perf_counter()
    src_t, dst_t, bsrc_t, bdst_t, valid_t, n_slots = \
        router.graph._edge_arrays()
    report["hybrid_edge_tensors_ms"] = (time.perf_counter() - t0) * 1e3
    with gc_pauses_ms() as (pauses, young):
        tk.reset_launch_counts()
        lat_h, res_h = timed(stmts)
        lat_n, res_n = timed(nb_stmts)
        lat_f, res_f = timed(find_stmts)
        graph_ms = {}
        t0 = time.perf_counter()
        pr = router.graph.pagerank()
        graph_ms["pagerank"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cc = router.graph.connected_components()
        graph_ms["components"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        bfs = router.graph.bfs_levels(int(hubs[0]))
        graph_ms["bfs"] = (time.perf_counter() - t0) * 1e3
        launches = dict(tk.LAUNCHES)
    report["gc_gen2_pauses_ms_hybrid"] = pauses
    report["gc_young_pauses_ms_hybrid"] = young
    report["launches_hybrid"] = launches
    latency_stats(report, "hybrid", lat_h)
    latency_stats(report, "hybrid_neighbors", lat_n)
    report["hybrid_find_ms"] = lat_f
    report["hybrid_find_p50_ms"] = float(np.percentile(lat_f, 50))
    report["hybrid_graph_ms"] = graph_ms

    # ---- checks against float64 numpy / scipy ----------------------------
    swaps = 0
    for res, h, q in zip(res_h, hub_of, queries):
        swaps += check_ranked(res.results, corpus, hub_rows[h], q, TOP_K)
    for res, h in zip(res_n, hubs):
        swaps += check_ranked(res.results, corpus,
                              np.setdiff1d(hub_rows[h], [h]), corpus[h],
                              TOP_K)
    report["hybrid_swaps"] = swaps
    rec = []
    for res, q in zip(res_f, queries[N_HYBRID:]):
        if any(r["tier"] != FIND_TIER for r in res.rows):
            raise AssertionError(f"FIND hit outside tier {FIND_TIER}")
        want, _ = exact_masked(corpus, tier_rows, q, TOP_K)
        got = [int(r["key"][1:]) for r in res.rows]
        rec.append(len(set(got) & set(want.tolist())) / TOP_K)
    report["hybrid_find_recall"] = float(np.mean(rec))
    if report["hybrid_find_recall"] < MIN_RECALL:
        raise AssertionError(f"FIND recall@{TOP_K} "
                             f"{report['hybrid_find_recall']} below "
                             f"{MIN_RECALL}")
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    _, want_cc = connected_components(adj, directed=True,
                                      connection="weak")
    got_cc = np.array([cc[i] for i in range(n)])
    pairs = np.unique(np.stack([got_cc, want_cc]), axis=1).shape[1]
    if not pairs == len(np.unique(got_cc)) == len(np.unique(want_cc)):
        raise AssertionError("component labels are not scipy's partition")
    report["hybrid_components"] = int(len(np.unique(got_cc)))
    dist = shortest_path(adj, directed=True, unweighted=True,
                         indices=int(hubs[0]))
    want_bfs = {i: int(d) for i, d in enumerate(dist) if np.isfinite(d)}
    if bfs != want_bfs:
        raise AssertionError("BFS levels differ from scipy's shortest "
                             "paths")
    report["hybrid_bfs_reached"] = len(bfs)
    report["hybrid_bfs_depth"] = max(bfs.values())
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    rank = np.full(n, 1.0 / n)
    for _ in range(20):
        contrib = np.where(outdeg > 0, rank / np.maximum(outdeg, 1.0), 0.0)
        incoming = np.bincount(dst, weights=contrib[src], minlength=n)
        rank = 0.15 / n + 0.85 * (incoming + rank[outdeg == 0].sum() / n)
    got_pr = np.array([pr[i] for i in range(n)])
    pr_err = float(np.max(np.abs(got_pr - rank) / rank))
    report["hybrid_pagerank_max_rel_err"] = pr_err
    if pr_err > PAGERANK_RTOL:
        raise AssertionError(f"PageRank off the float64 power iteration "
                             f"by rtol {pr_err} (limit {PAGERANK_RTOL})")

    # the analytics alone on the cached edge tensors, by CUDA events (the
    # per-level / per-round host syncs of BFS and components included)
    start = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    start[int(hubs[0])] = True
    report["hybrid_graph_events_ms"] = {
        "pagerank": cuda_ms(lambda: gk.pagerank(
            src_t, dst_t, n_slots, valid_t), 3) if on_card else None,
        "components": cuda_ms(lambda: gk.connected_components(
            bsrc_t, bdst_t, n_slots, valid_t), 3) if on_card else None,
        "bfs": cuda_ms(lambda: gk.bfs_levels(
            src_t, dst_t, n_slots, start), 3) if on_card else None}
    say(f"[11] hybrid CONNECTED TO p50 {report['hybrid_p50_ms']:.3f} ms p99 "
        f"{report['hybrid_p99_ms']:.3f} ms (first {lat_h[0]:.1f} ms); "
        f"NEIGHBORS p50 {report['hybrid_neighbors_p50_ms']:.3f} ms; FIND "
        f"p50 {report['hybrid_find_p50_ms']:.1f} ms, recall@{TOP_K} "
        f"{report['hybrid_find_recall']:.4f} (pool "
        f"{report['hybrid_find_pool']}); mask build median "
        f"{float(np.median(mask_ms)):.2f} ms; {swaps} near-tie swaps "
        f"(exact scores < {SWAP_TOL} apart) allowed; graph "
        f"{ {k: round(v, 1) for k, v in graph_ms.items()} } ms (events "
        f"{report['hybrid_graph_events_ms']}), edge tensors "
        f"{report['hybrid_edge_tensors_ms']:.0f} ms; "
        f"{report['hybrid_components']} components, BFS reached "
        f"{len(bfs)} nodes in {report['hybrid_bfs_depth']} levels, "
        f"PageRank max rel err {pr_err:.2e}; launches {launches}")
    if on_card:
        require_launches(launches, ("f32_pooled_bits",), "11")
        calls = {
            "hybrid_single": lambda: [router.execute(s) for s in stmts[:8]],
            "hybrid_find": lambda: router.execute(find_stmts[0]),
            "hybrid_graph": lambda: (
                router.graph.pagerank(), router.graph.connected_components(),
                router.graph.bfs_levels(int(hubs[0])))}
        report["profile_hybrid"] = profile_calls(calls, "chiprun_out")
        # kernel time by a CUDA-only trace: the CPU + CUDA trace above
        # once showed no record of the pooled kernel in FIND's 0.9 s call
        report["hybrid_device_ms"] = {
            k: device_ms(fn, 1, k) for k, fn in calls.items()}

    # ---- relational statements on the same router ------------------------
    t0 = time.perf_counter()
    router.execute("CREATE TABLE orders (id INT PRIMARY KEY, tier INT, "
                   "amount FLOAT)")
    for c in range(0, SQL_ROWS, SQL_CHUNK):
        router.execute("INSERT INTO orders VALUES " + ", ".join(
            f"({i}, {i % N_TIERS}, {i * 0.5})"
            for i in range(c, min(c + SQL_CHUNK, SQL_ROWS))))
    report["sql_insert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = router.execute(f"SELECT id FROM orders WHERE tier = {FIND_TIER} "
                         f"AND amount > 1000").rows
    report["sql_select_ms"] = (time.perf_counter() - t0) * 1e3
    ids = np.arange(SQL_ROWS)
    want = ids[(ids % N_TIERS == FIND_TIER) & (ids * 0.5 > 1000)]
    if [r["id"] for r in got] != want.tolist():
        raise AssertionError("SELECT ... WHERE differs from numpy")
    found = router.execute(f"FIND ROWS FROM orders WHERE tier = "
                           f"{FIND_TIER} LIMIT 5").rows
    count = router.execute("SELECT COUNT(*) FROM orders").rows[0]
    if len(found) != 5 or any(r["tier"] != FIND_TIER for r in found) or \
            list(count.values()) != [SQL_ROWS]:
        raise AssertionError(f"FIND ROWS / COUNT wrong: {found}, {count}")
    say(f"[11] SQL: {SQL_ROWS} rows inserted in {report['sql_insert_s']:.2f} "
        f"s, SELECT ... WHERE {report['sql_select_ms']:.1f} ms, "
        f"{len(got)} rows, equal to numpy")
    return report


# ---------------------------------------------------------------------------
# phase 16: the extended modules (checkpoints, blobs, the LLM cache)
# ---------------------------------------------------------------------------

def rollback_hits(router, stmts: dict) -> tuple:
    """Each route's statements through the router: ({route: [(key,
    score), ...] per statement}, {route: latencies ms})."""
    hits, lat = {}, {}
    for route, group in stmts.items():
        hits[route], lat[route] = [], []
        for stmt in group:
            t0 = time.perf_counter()
            res = router.execute(stmt)
            lat[route].append((time.perf_counter() - t0) * 1e3)
            if res.kind != "similar" or len(res.results) != TOP_K:
                raise AssertionError(f"[16] bad SIMILAR result on {route}: "
                                     f"{res.results}")
            hits[route].append([(h["key"], h["score"])
                                for h in res.results])
    return hits, lat


def same_route_hits(a, b, atol: float) -> list:
    """Statements whose keys differ, or a score by more than atol."""
    return [i for i, (x, y) in enumerate(zip(a, b))
            if [k for k, _ in x] != [k for k, _ in y]
            or max(abs(s - t) for (_, s), (_, t) in zip(x, y)) > atol]


def rollback_router(dev, corpus, queries) -> tuple:
    """Phase 16's router: ``corpus`` (its first ROLLBACK_ROWS rows) in
    the default namespace, loaded as phase 7 loads it (``{"cat": i %
    16}``, under ``bulk_ingest``), its first ROLLBACK_SUB_ROWS rows in an
    int8 (``q8``) and a binary (``bits``) collection, and an ``events``
    table of N_EVENTS rows. Returns (router, {route: SIMILAR
    statements})."""
    from neumann_tpu_torch.router import QueryRouter

    n = min(len(corpus), ROLLBACK_ROWS)
    sub = min(n, ROLLBACK_SUB_ROWS)
    router = QueryRouter(device=dev)
    eng = router.vector
    with eng.bulk_ingest():
        for i in range(n):
            eng.store_embedding(f"k{i}", corpus[i], {"cat": i % N_CATS})
    router.execute(f"CREATE COLLECTION q8 DIM {DIM} QUANTIZATION int8")
    router.execute(f"CREATE COLLECTION bits DIM {DIM} QUANTIZATION binary")
    with eng.bulk_ingest():
        for i in range(sub):
            eng.store_in_collection("q8", f"k{i}", corpus[i])
            eng.store_in_collection("bits", f"k{i}", corpus[i])
    router.execute("CREATE TABLE events (id INT PRIMARY KEY, kind INT)")
    router.execute("INSERT INTO events VALUES " + ", ".join(
        f"({i}, {i % 8})" for i in range(N_EVENTS)))
    single = queries[:N_ROLLBACK_SINGLE]
    stmts = {
        "pooled": [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in single],
        "pooled_filtered": [
            f"SIMILAR {vec_literal(q)} WHERE cat = {FILTER_CAT} TOP {TOP_K}"
            for q in queries[N_ROLLBACK_SINGLE:N_ROLLBACK_SINGLE
                             + N_ROLLBACK_FILTERED]],
        "int8": [f"SIMILAR {vec_literal(q)} IN q8 TOP {TOP_K}"
                 for q in single],
        "binary": [f"SIMILAR {vec_literal(q)} IN bits TOP {TOP_K}"
                   for q in single]}
    return router, stmts


def run_extended(args, dev, corpus, queries, on_card: bool,
                 chain: bool = False) -> dict:
    """Phase 16: checkpoint and rollback of a store of phases 7-9's rows
    on the card, then SIMILAR on every route (ids equal to those before
    the checkpoint, scores within ROLLBACK_ATOL, rows 5-7 launched);
    EXPLAIN SIMILAR names the kernel each route launches; a blob survives
    a delete and a rollback with equal bytes; the LLM cache (host HNSW)
    and the router's query cache. With ``chain``, phase 18a's chain
    transactions then run on the same router (``phase18a_s``)."""
    import shutil
    import tempfile

    from neumann_tpu_torch.ops import kernels as tk

    report = {}
    n = min(len(corpus), ROLLBACK_ROWS)
    sub = min(n, ROLLBACK_SUB_ROWS)
    t0 = time.perf_counter()
    router, stmts = rollback_router(dev, corpus, queries)
    report["rollback_load_s"] = time.perf_counter() - t0
    single = queries[:N_ROLLBACK_SINGLE]
    say(f"[16] {n} rows + {sub} int8 + {sub} binary + {N_EVENTS} table rows "
        f"loaded in {report['rollback_load_s']:.1f} s")

    # ---- EXPLAIN names the kernel each route launches ---------------------
    explained = {}
    for route, group in stmts.items():
        detail = router.execute(f"EXPLAIN {group[0]}").rows[0]["detail"]
        m = re.search(r"\(kernel (\w+)\)", detail)
        explained[route] = m.group(1) if m else None
        tk.reset_launch_counts()
        router.execute(group[0])
        if on_card and (m is None or tk.LAUNCHES[m.group(1)] <= 0):
            raise AssertionError(f"[16] EXPLAIN names {explained[route]} "
                                 f"for {route}, launches {dict(tk.LAUNCHES)}")
    report["explain_kernels"] = explained
    say(f"[16] EXPLAIN SIMILAR kernels by route: {explained}")

    # ---- 1-2: hits, then a checkpoint ---------------------------------------
    before, _ = rollback_hits(router, stmts)
    ck_dir = tempfile.mkdtemp(prefix="neumann_ckpt_")
    try:
        router.init_checkpoints(ck_dir)
        t0 = time.perf_counter()
        router.execute("CHECKPOINT 'pre'")
        report["checkpoint_s"] = time.perf_counter() - t0
        report["checkpoint_bytes"] = os.path.getsize(
            router.checkpoints.list()[0]["path"])
        # ---- 3: re-embed rows; each route's query vector lands on a row
        rng = np.random.default_rng(args.seed + 16)
        moved = {"pooled": [], "int8": [], "binary": []}
        t0 = time.perf_counter()
        for j, q in enumerate(single):
            row = sub - 1 - j   # a row in every namespace
            for route, where in (("pooled", ""), ("int8", " IN q8"),
                                 ("binary", " IN bits")):
                router.execute(f"EMBED STORE 'k{row}' {vec_literal(q)}"
                               f"{where}")
                moved[route].append(f"k{row}")
        others = rng.choice(np.setdiff1d(np.arange(n), sub - 1 - np.arange(
            len(single))), N_REEMBED - 3 * len(single), replace=False)
        for row in others:
            router.execute(f"EMBED STORE 'k{row}' "
                           f"{vec_literal(-corpus[row])}")
        report["reembed_s"] = time.perf_counter() - t0
        # ---- 4: a DELETE takes an automatic checkpoint first
        t0 = time.perf_counter()
        deleted = router.execute("DELETE FROM events WHERE kind = 3").count
        report["delete_auto_checkpoint_s"] = time.perf_counter() - t0
        autos = [c for c in router.checkpoints.list() if c["auto"]]
        if len(autos) != 1 or not autos[0]["reason"].startswith("delete"):
            raise AssertionError(f"[16] DELETE took no auto checkpoint: "
                                 f"{router.checkpoints.list()}")
        # ---- 5: the re-embedded rows come first, no filtered hit lost
        # its category (EMBED STORE drops a row's metadata)
        during, _ = rollback_hits(router, stmts)
        for route, keys in moved.items():
            firsts = [hits[0][0] for hits in during[route]]
            if firsts != keys:
                raise AssertionError(f"[16] re-embedded rows not first on "
                                     f"{route}: {firsts} != {keys}")
        lost = set(others.tolist()) | set(sub - 1 - np.arange(len(single)))
        off = [k for hits in during["pooled_filtered"] for k, _ in hits
               if int(k[1:]) % N_CATS != FILTER_CAT or int(k[1:]) in lost]
        if off:
            raise AssertionError(f"[16] filtered hits off the filter: {off}")
        # ---- 6: ROLLBACK, then the first SIMILAR rebuilds device views
        t0 = time.perf_counter()
        router.execute("ROLLBACK TO 'pre'")
        report["rollback_s"] = time.perf_counter() - t0
        with gc_pauses_ms() as (pauses, young):
            tk.reset_launch_counts()
            after, lat = rollback_hits(router, stmts)
            launches = dict(tk.LAUNCHES)
        report["launches_rollback"] = launches
        report["gc_gen2_pauses_ms_rollback"] = pauses
        report["rollback_first_query_ms"] = {r: v[0] for r, v in lat.items()}
        report["rollback_p50_ms"] = {r: float(np.percentile(v[1:], 50))
                                     for r, v in lat.items()}
        report["rollback_events_rows"] = router.relational.row_count(
            "events")
        report["checkpoints_after"] = len(router.checkpoints.list())
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    # ---- 7-8: the hits of step 1 on every route, rows 5-7 launched
    bad = {route: same_route_hits(before[route], after[route],
                                  ROLLBACK_ATOL) for route in stmts}
    report["rollback_mismatches"] = sum(map(len, bad.values()))
    say(f"[16] CHECKPOINT {report['checkpoint_s']:.2f} s "
        f"({report['checkpoint_bytes'] / 1e9:.2f} GB), {N_REEMBED} rows "
        f"re-embedded in {report['reembed_s']:.2f} s, DELETE ({deleted} "
        f"rows) with its auto checkpoint "
        f"{report['delete_auto_checkpoint_s']:.2f} s, ROLLBACK "
        f"{report['rollback_s']:.2f} s; first SIMILAR "
        f"after it by route (ms) {report['rollback_first_query_ms']}, p50 "
        f"{report['rollback_p50_ms']}; statements differing from before the "
        f"checkpoint {bad}; events rows {report['rollback_events_rows']}; "
        f"launches {launches}")
    if report["rollback_mismatches"] or \
            report["rollback_events_rows"] != N_EVENTS:
        raise AssertionError(f"[16] rollback did not restore the hits: {bad}"
                             f", events {report['rollback_events_rows']}")
    if on_card:
        require_launches(launches, ("f32_pooled_bits", "int8_pooled_bits",
                                    "hamming_topk"), "16")
    report.update(run_query_cache(router, stmts["pooled"][0], corpus))
    if chain:
        t0 = time.perf_counter()
        report.update(run_chain(args, router, corpus[:n], on_card))
        report["phase18a_s"] = time.perf_counter() - t0
    del router
    gc.collect()
    report.update(run_blob(args, dev))
    report.update(run_llm_cache(args, dev))
    try:
        import cryptography
        crypto = f"imports (cryptography {cryptography.__version__})"
    except ImportError:
        crypto = "does not import"
    report["cryptography"] = crypto
    say(f"[16] cryptography {crypto} here; the vault is host-only and not "
        f"driven on the card (its tests run on the CPU)")
    return report


def run_query_cache(router, stmt: str, corpus) -> dict:
    """enable_query_cache on the phase's router: a repeated SIMILAR is
    served from the cache (the router runs no statement for it) with the
    fresh answer's hits; after a write the same statement is run again."""
    router.enable_query_cache()
    runs, run_statement = [], router.execute_statement

    def counted(parsed):
        runs.append(parsed)
        return run_statement(parsed)

    router.execute_statement = counted
    times, hits = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        hits.append(router.execute(stmt).results)
        times.append((time.perf_counter() - t0) * 1e3)
    if hits[1] != hits[0] or len(runs) != 1:
        raise AssertionError(f"[16] the query cache did not serve the "
                             f"repeat: {len(runs)} statements run")
    top = hits[0][0]["key"]
    router.execute(f"EMBED STORE '{top}' {vec_literal(-corpus[int(top[1:])])}")
    fresh = router.execute(stmt).results
    router.execute_statement = run_statement
    if len(runs) != 3 or fresh[0]["key"] == top:
        raise AssertionError(f"[16] the query cache served a result "
                             f"across a write: {len(runs)} statements run")
    say(f"[16] query cache: SIMILAR {times[0]:.2f} ms, repeat from the "
        f"cache {times[1]:.3f} ms with equal hits; after a write searched "
        f"again")
    return {"query_cache_miss_ms": times[0], "query_cache_hit_ms": times[1]}


def run_blob(args, dev) -> dict:
    """BLOB INIT on a router of its own; a BLOB_BYTES artifact from
    --seed put and got back with equal bytes (MB/s each), VERIFY; a
    checkpoint, BLOB DELETE, ROLLBACK, and VERIFY again with equal
    bytes."""
    import shutil
    import tempfile

    from neumann_tpu_torch.router import QueryRouter

    router = QueryRouter(device=dev)
    router.execute("BLOB INIT")
    data = np.random.default_rng(args.seed + 17).bytes(BLOB_BYTES)
    tmp = tempfile.mkdtemp(prefix="neumann_blob_")
    try:
        path = os.path.join(tmp, "artifact.bin")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        aid = router.execute(f"BLOB PUT 'artifact.bin' FROM '{path}'").value
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = router.execute(f"BLOB GET '{aid}'").value
        get_s = time.perf_counter() - t0
        ok = [got == data, router.execute(f"BLOB VERIFY '{aid}'").message]
        router.init_checkpoints(os.path.join(tmp, "ckpts"))
        router.execute("CHECKPOINT 'blob'")
        router.execute(f"BLOB DELETE '{aid}'")
        gone = router.blob.list() == []
        router.execute("ROLLBACK TO 'blob'")
        ok += [router.execute(f"BLOB VERIFY '{aid}'").message,
               router.execute(f"BLOB GET '{aid}'").value == data]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mb = BLOB_BYTES / 1e6
    report = {"blob_put_mb_s": mb / put_s, "blob_get_mb_s": mb / get_s,
              "blob_checks": ok}
    say(f"[16] blob of {BLOB_BYTES} bytes: put {mb / put_s:.1f} MB/s, get "
        f"{mb / get_s:.1f} MB/s; equal, VERIFY, deleted, after ROLLBACK "
        f"VERIFY and equal: {ok} (deleted: {gone})")
    if ok != [True, "OK", "OK", True] or not gone:
        raise AssertionError(f"[16] blob checks failed: {ok}, {gone}")
    return report


def run_llm_cache(args, dev) -> dict:
    """CACHE INIT (capacity 10,000, the 256-d default embedder) on a
    router of its own, filled with CACHE_PROMPTS prompts from --seed;
    a replayed mix through CACHE SEMANTIC GET: exact and semantic hit
    rates, p50 of put, exact get and semantic get. The cache runs on the
    host (its HNSW graph is the native host one)."""
    from neumann_tpu_torch.router import QueryRouter

    router = QueryRouter(device=dev)
    router.execute("CACHE INIT")
    rng = np.random.default_rng(args.seed + 18)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.integers(3, 9)))
             for _ in range(CACHE_VOCAB)]
    prompts = [" ".join(rng.choice(vocab, CACHE_WORDS))
               for _ in range(CACHE_PROMPTS)]
    put = []
    for i, p in enumerate(prompts):
        t0 = time.perf_counter()
        router.execute(f"CACHE PUT '{p}' 'answer {i}'")
        put.append((time.perf_counter() - t0) * 1e3)
    n_exact, n_swap = CACHE_MIX // 2, 3 * CACHE_MIX // 10
    mix = []
    for i in rng.integers(0, CACHE_PROMPTS, n_exact):
        mix.append(("exact", prompts[i]))
    for i in rng.integers(0, CACHE_PROMPTS, n_swap):
        words = prompts[i].split()
        words[rng.integers(CACHE_WORDS)] = "zz" + vocab[rng.integers(
            CACHE_VOCAB)]
        mix.append(("swapped", " ".join(words)))
    for _ in range(CACHE_MIX - n_exact - n_swap):
        mix.append(("unseen", " ".join(rng.choice(vocab, CACHE_WORDS))))
    order = rng.permutation(len(mix))
    stats = router.cache.stats
    lat = {"exact": [], "semantic": [], "miss": []}
    for j in order:
        _, text = mix[j]
        hits0, sem0 = stats.exact_hits, stats.semantic_hits
        t0 = time.perf_counter()
        router.execute(f"CACHE SEMANTIC GET '{text}'")
        ms = (time.perf_counter() - t0) * 1e3
        lat["exact" if stats.exact_hits > hits0 else
            "semantic" if stats.semantic_hits > sem0 else "miss"].append(ms)
    report = {
        "cache_entries": len(router.cache),
        "cache_exact_hit_rate": len(lat["exact"]) / len(mix),
        "cache_semantic_hit_rate": len(lat["semantic"]) / len(mix),
        "cache_put_p50_ms": float(np.median(put)),
        "cache_fill_s": sum(put) / 1e3,
        **{f"cache_{k}_get_p50_ms": float(np.median(v)) if v else None
           for k, v in lat.items()}}
    say(f"[16] LLM cache (host): {report['cache_entries']} entries filled in "
        f"{report['cache_fill_s']:.1f} s, put p50 "
        f"{report['cache_put_p50_ms']:.3f} ms; replayed {len(mix)} lookups "
        f"({n_exact} repeats, {n_swap} with a word swapped): exact hits "
        f"{report['cache_exact_hit_rate']:.3f}, semantic "
        f"{report['cache_semantic_hit_rate']:.3f}; p50 exact get "
        f"{report['cache_exact_get_p50_ms']} ms, semantic get "
        f"{report['cache_semantic_get_p50_ms']} ms, miss "
        f"{report['cache_miss_get_p50_ms']} ms")
    if report["cache_entries"] != min(CACHE_PROMPTS, 10_000) or \
            len(lat["exact"]) < n_exact:
        raise AssertionError(f"[16] LLM cache: {report}")
    return report


# ---------------------------------------------------------------------------
# phase 2, row 8: the ADC scan
# ---------------------------------------------------------------------------

def adc_library(codes, tables, cand=None):
    """Row 8's one-call PyTorch yardstick, ``F.embedding_bag(idx, w,
    mode="sum")``, with its index and weight layouts built here, outside
    the timed call: the full scan's bags are a row's M codes offset by
    256 a subspace into the [M * 256, Q] tables (out [N, Q]); the
    gathered mode's are a (query, candidate) pair's codes offset also by
    its query's M * 256 into the flat tables (out [Q * C, 1]). The
    negation and the -inf mask are elementwise extras, left out as the
    scales are beside ``_int_mm``. Returns the call."""
    import torch
    import torch.nn.functional as F

    q, m, _ = tables.shape
    off = torch.arange(m, device=codes.device) * 256
    if cand is None:
        idx = codes.long() + off
        w = tables.permute(1, 2, 0).reshape(m * 256, q).contiguous()
    else:
        idx = (codes[cand.long().clamp_min(0)].long() + off
               + (torch.arange(q, device=codes.device) * (m * 256))[
                   :, None, None]).reshape(-1, m)
        w = tables.reshape(q * m * 256, 1)
    return lambda: F.embedding_bag(idx, w, mode="sum")


def adc_record(rec: dict, sfx: str, codes, tables, valid, cand=None,
               reps: int = 5) -> None:
    """Row 8 at one shape, into ``rec`` under ``sfx``: the kernel bit for
    bit against its plain version; the kernel and the library yardstick
    timed in turns (``turns``), the yardstick held to the plain sums
    within rtol 1e-5 (it computes the same function); the plain
    version's time; device time (torch.profiler) at 8 queries or fewer;
    the bound: the bytes each input and output move once (the gathered
    mode's distinct candidate rows) and the live rows' lookups at the
    shared-memory rate."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    got = tk.pq_adc_scores(codes, tables, valid, cand)
    want = tk.pq_adc_scores_plain(codes, tables, valid, cand)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"pq_adc{sfx}: {int((got != want).sum())} scores differ "
            f"from plain (must be bit-exact)")
    fin = torch.isfinite(want)
    q, m = tables.shape[0], codes.shape[1]
    if cand is None:
        rows_read = codes.shape[0]
        in_bytes = nbytes(codes, tables, valid)
    else:
        rows_read = int(torch.unique(cand[cand >= 0]).numel())
        in_bytes = rows_read * (m + 1) + nbytes(cand, tables)
    lookups = int(fin.sum()) * m
    for k, v in bound(in_bytes + nbytes(got), lookups,
                      SMEM_LOOKUPS_PER_S).items():
        rec[f"{k}{sfx}"] = v
    rec[f"max_abs_err{sfx}"] = float(
        (got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    del got
    lib = adc_library(codes, tables, cand)
    sums = lib()
    sums = (sums.T if cand is None else sums.reshape(q, -1))[fin]
    lib_err = float(((-sums) - want[fin]).abs().max()) if fin.any() else 0.0
    scale = float(want[fin].abs().max()) if fin.any() else 1.0
    if not lib_err <= 1e-5 * max(scale, 1e-30):
        raise AssertionError(f"pq_adc{sfx}: the embedding_bag yardstick is "
                             f"off the plain sums by {lib_err}")
    rec[f"library_max_abs_err{sfx}"] = lib_err
    del want, fin, sums
    rec[f"ms{sfx}"], rec[f"library_ms{sfx}"] = turns(
        lambda: tk.pq_adc_scores(codes, tables, valid, cand), lib, reps)
    del lib
    rec[f"plain_ms{sfx}"] = cuda_ms(
        lambda: tk.pq_adc_scores_plain(codes, tables, valid, cand), 1,
        warm=False)
    if q <= 8:
        # a profile that saw no kernel gives 0: not measured then
        rec[f"device_ms{sfx}"] = device_ms(
            lambda: tk.pq_adc_scores(codes, tables, valid, cand), 20) or None
    rec[f"lookups{sfx}"] = lookups
    rec[f"rows_read{sfx}"] = rows_read
    cols = (f"C {cand.shape[1]}" if cand is not None
            else f"N {codes.shape[0]}")
    rec[f"shape{sfx}"] = f"Q {q} x {cols} x M {m}"
    torch.cuda.empty_cache()


def adc_select_record(rec: dict, sfx: str, codes, tables, valid, k: int,
                      cand=None, reps: int = 5) -> None:
    """Row 8's select mode at one shape, into ``rec`` under ``sfx``: its
    scores and columns equal to ``pq_adc_topk_plain``'s; its time beside
    the plain version's and the path it replaced (``scores_topk_ms``: the
    scores mode, then ``_topk_stable`` over the [Q, C] scores); device
    time (torch.profiler) at 8 queries or fewer; the plan; the bound: the
    codes, tables and mask (gathered: the distinct candidate rows and
    cand) and the [Q, k] result once each, and the live rows' lookups at
    the shared-memory rate."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.scan import _topk_stable

    got = tk.pq_adc_topk(codes, tables, valid, k, cand)
    want = tk.pq_adc_topk_plain(codes, tables, valid, k, cand)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("scores", "columns")):
        if not torch.equal(a, b):
            raise AssertionError(
                f"pq_adc_select{sfx}: {int((a != b).sum())} {what} differ "
                f"from plain (must be equal)")
    del want
    q, m = tables.shape[0], codes.shape[1]
    cols = codes.shape[0] if cand is None else cand.shape[1]
    if cand is None:
        live = int(valid.sum()) * q
        in_bytes = nbytes(codes, tables, valid)
    else:
        ok = cand >= 0
        live = int((ok & valid[cand.long().clamp_min(0)]).sum())
        rows_read = int(torch.unique(cand[ok]).numel())
        in_bytes = rows_read * (m + 1) + nbytes(cand, tables)
    for key, v in bound(in_bytes + nbytes(*got), live * m,
                        SMEM_LOOKUPS_PER_S).items():
        rec[f"{key}{sfx}"] = v
    rec[f"max_abs_err{sfx}"] = 0.0
    del got
    rec[f"ms{sfx}"] = cuda_ms(
        lambda: tk.pq_adc_topk(codes, tables, valid, k, cand), reps)
    rec[f"scores_topk_ms{sfx}"] = cuda_ms(lambda: _topk_stable(
        tk.pq_adc_scores(codes, tables, valid, cand), min(k, cols)), reps)
    torch.cuda.empty_cache()
    rec[f"plain_ms{sfx}"] = cuda_ms(
        lambda: tk.pq_adc_topk_plain(codes, tables, valid, k, cand), 1,
        warm=False)
    if q <= 8:
        rec[f"device_ms{sfx}"] = device_ms(
            lambda: tk.pq_adc_topk(codes, tables, valid, k, cand), 20) or None
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    rec[f"plan{sfx}"] = dict(zip(
        ("shared", "chunk", "parts", "span"),
        tk._pq_adc_plan(cols, q, m, k, cand is not None, True, sms)))
    rec[f"shape{sfx}"] = (f"Q {q} x {'C' if cand is not None else 'N'} "
                          f"{cols} x M {m}, k {k}")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def adc_launches():
    """Record the mode and arguments of every call of row 8's wrappers
    (``pq_adc_topk``: "select", ``pq_adc_scores``: "scores") the main
    path makes inside the block (``ops/pq`` and ``ops/ivf`` call them
    through the ``kernels`` module), to time row 8 afterwards at those
    shapes."""
    from neumann_tpu_torch.ops import kernels as tk

    seen = []
    saved = {"select": tk.pq_adc_topk, "scores": tk.pq_adc_scores}

    def spy(mode, fn):
        def call(*a):
            seen.append((mode, a))
            return fn(*a)
        return call

    tk.pq_adc_topk = spy("select", saved["select"])
    tk.pq_adc_scores = spy("scores", saved["scores"])
    try:
        yield seen
    finally:
        tk.pq_adc_topk = saved["select"]
        tk.pq_adc_scores = saved["scores"]


def adc_both(recs, sfx: str, args) -> None:
    """Row 8 in both modes at the shape of one recorded select call's
    arguments, into recs = (scores record, select record)."""
    codes, tables, valid, k = args[:4]
    cand = args[4] if len(args) > 4 else None
    adc_record(recs[0], sfx, codes, tables, valid, cand)
    adc_select_record(recs[1], sfx, codes, tables, valid, k, cand)


def check_pq_adc(dev, seed: int):
    """Row 8 in both modes: the scores bit for bit against their plain
    version and beside the library yardstick (``adc_record``), the select
    mode (k 10) equal to its plain version and beside the scores mode
    and ``_topk_stable`` (``adc_select_record``), at: Q 1,024, 8 and 1 x
    1,048,576 rows x M 96 (the 768-d codebook), 1 % dead rows; the
    gathered mode at 64 queries x 16 probed blocks of 2,048 rows, a third
    of each block padding; M 384 (a 3,072-d codebook, past a block's
    shared memory) at Q 64 x 262,144. Phases 14 and 15 add the shapes
    their batches launch, on their own codes and tables. Returns the
    (scores, select) records."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + 8)
    rec = {"library": ADC_LIBRARY, "design": PQ_DESIGN}
    sel = {"library": ADC_SELECT_LIBRARY, "design": PQ_DESIGN}

    def one(sfx, codes, tables, valid, cand=None, reps=5):
        adc_record(rec, sfx, codes, tables, valid, cand, reps)
        adc_select_record(sel, sfx, codes, tables, valid, TOP_K, cand, reps)

    n = POOLED_ROWS
    codes = torch.randint(0, 256, (n, PQ_M), generator=g, device=dev,
                          dtype=torch.uint8)
    valid = torch.rand(n, generator=g, device=dev) > 0.01
    tables = torch.rand(N_BATCH, PQ_M, 256, generator=g, device=dev) * 4.0
    one("", codes, tables, valid, reps=3)
    for q in (8, 1):
        one(f"_q{q}", codes, tables[:q].contiguous(), valid, reps=20)
    del codes, valid, tables
    blocks, stride, nprobe, q = 256, 2048, 16, 64
    codes = torch.randint(0, 256, (blocks * stride, PQ_M), generator=g,
                          device=dev, dtype=torch.uint8)
    valid = (torch.arange(blocks * stride, device=dev) % stride
             < 2 * stride // 3)
    probe = torch.stack([torch.randperm(blocks, generator=g,
                                        device=dev)[:nprobe]
                         for _ in range(q)])
    cand = ((probe[:, :, None] * stride
             + torch.arange(stride, device=dev)).reshape(q, -1).int())
    tables = torch.rand(q, PQ_M, 256, generator=g, device=dev) * 4.0
    one("_ivf", codes, tables, valid, cand, reps=10)
    del codes, valid, cand, tables
    wide_m = WIDE_DIM // 8
    codes = torch.randint(0, 256, (WIDE_ROWS, wide_m), generator=g,
                          device=dev, dtype=torch.uint8)
    valid = torch.rand(WIDE_ROWS, generator=g, device=dev) > 0.01
    tables = torch.rand(64, wide_m, 256, generator=g, device=dev) * 4.0
    one("_m384", codes, tables, valid, reps=5)
    rec["shape"] = sel["shape"] = (
        f"Q={N_BATCH} (8, 1) x N={n} x M={PQ_M}; gathered Q={q} x {nprobe} "
        f"blocks of {stride}; Q=64 x N={WIDE_ROWS} x M={wide_m}; phase 14's "
        f"and 15's batch steps")
    return rec, sel


# ---------------------------------------------------------------------------
# phase 14 (cell G): PQ and TT collections
# ---------------------------------------------------------------------------

def exact_mismatch(got, want_k1, k: int) -> dict:
    """Row 9's top-k against its plain version's top-(k + 1): the largest
    score difference; the places whose ids differ where no other plain
    score of the query (k + 1 of them) stands within EXACT_TOL; the
    places where one is -inf / -1 and the other not; the runs of
    bit-equal scores whose rows do not ascend."""
    s_g, i_g = (t.cpu().numpy() for t in got)
    s_w1, i_w1 = (t.cpu().numpy() for t in want_k1)
    s_w, i_w = s_w1[:, :k], i_w1[:, :k]
    dead = int((np.isneginf(s_g) != np.isneginf(s_w)).sum()
               + ((i_g == -1) != (i_w == -1)).sum())
    fin = np.isfinite(s_g) & np.isfinite(s_w)
    err = float(np.abs(s_g[fin] - s_w[fin]).max(initial=0.0))
    ids = sum(1 for r, j in zip(*np.nonzero(i_g != i_w))
              if not (np.abs(np.delete(s_w1[r], j) - s_w1[r, j])
                      <= EXACT_TOL).any())
    same = (s_g[:, 1:] == s_g[:, :-1]) & np.isfinite(s_g[:, 1:])
    order = int((same & (i_g[:, 1:] <= i_g[:, :-1])).sum())
    return dict(max_abs_err=err, id_mismatches=ids, dead_differ=dead,
                order_errors=order)


def exact_record(rec: dict, sfx: str, c, rm, qf, k: int, reps: int,
                 library_ms: float) -> None:
    """Row 9's times at one shape into ``rec`` under suffix ``sfx``: the
    call (CUDA events), its kernels' device time and the hand kernel's
    own (torch.profiler), the plain version's, the bound (each input
    read once and the top-k written; the three bf16 passes of the live
    rows on the tensor cores, and beside it the FFMA of one f32 pass)."""
    from neumann_tpu_torch.ops import kernels as tk

    q = qf.shape[0]
    live = int((rm > 0).sum())
    rec[f"ms{sfx}"] = cuda_ms(lambda: tk.int8_exact_topk(c, rm, qf, k), reps)
    rec[f"device_ms{sfx}"] = device_ms(
        lambda: tk.int8_exact_topk(c, rm, qf, k), 3, "int8_exact")
    rec[f"kernel_ms{sfx}"] = device_ms(
        lambda: tk.int8_exact_topk(c, rm, qf, k), 3, "int8_exact",
        only=r"exact_wgmma_kernel")
    rec[f"plain_ms{sfx}"] = cuda_ms(
        lambda: tk.int8_exact_topk_plain(c, rm, qf, k), 1)
    rec[f"library_ms{sfx}"] = library_ms
    for key, v in bound(nbytes(c, rm, qf) + 12 * q * k,
                        6 * q * live * c.shape[1], BF16_FLOPS_PER_S).items():
        rec[f"{key}{sfx}"] = v
    rec[f"ffma_bound_ms{sfx}"] = max(
        bound(nbytes(c, rm, qf) + 12 * q * k, 2 * q * live * c.shape[1],
              F32_FLOPS_PER_S)["bound_ms"], rec[f"bytes_bound_ms{sfx}"])


def exact_split_check(qf) -> dict:
    """Row 9's query split on the card: (hi + mid) + lo == qf bit for
    bit in f32 for every query (ops/kernels._exact_split)."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    hi, mid, lo = tk._exact_split(qf)
    back = (hi.float() + mid.float()) + lo.float()
    bad = int((back.view(torch.int32) != qf.view(torch.int32)).sum())
    nz = qf[qf != 0].abs()
    rec = dict(queries=qf.shape[0], elements_differ=bad,
               min_nonzero=float(nz.min()) if nz.numel() else None)
    if bad:
        raise AssertionError(f"int8_exact: the query split is not exact on "
                             f"the card: {rec}")
    return rec


def exact_paths_bit_equal(c, rm, qf) -> dict:
    """Row 9's few-query kernels (Q 1: 8-query blocks, Q 16: 16-query
    blocks, both splitting the queries themselves) and its batch kernel
    (Q 17: 128-query blocks, the parts split by the wrapper) give the
    same queries' scores bit for bit alike over the whole plane (the
    scores mode's launches, uncounted)."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    rows = tk._exact_rows(c)
    got = {q: tk._exact_launch(rows, rm,
                               tk._exact_queries(qf[:q], rows.shape[1]), q,
                               0, False).view(torch.int32)
           for q in (1, 16, 17)}
    differ = int((got[16] != got[17][:16]).sum()
                 + (got[1] != got[17][:1]).sum())
    rec = dict(scores=got[16].numel() + got[1].numel(), differ=differ)
    if differ:
        raise AssertionError(f"int8_exact: the Q=1, Q=16 and Q=17 kernels' "
                             f"scores differ: {rec}")
    return rec


def check_int8_exact(dev, seed: int):
    """Phase 2, row 9: ``int8_exact_topk`` at A17's delta shapes
    (EXACT_ROWS x DIM) on random rows of which EXACT_DEAD are dead, and a
    block of copies (EXACT_COPY0 ..): each of EXACT_QS x EXACT_KS against
    the plain version (``exact_mismatch``), query 0 the block's equal
    row (its EXACT_SAME x EXACT_COPIES copies first, rows ascending), the
    next queries its other rows (their EXACT_COPIES copies first). Times
    at Q N_BATCH and 1 beside ``torch.matmul`` (TF32 off) for the product
    alone. Returns the select mode's record and the scores mode's."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.quant import (
        int8_cosine_row_mult,
        scalar_quantize,
    )

    g = torch.Generator(device=dev).manual_seed(seed + 9)
    n, b0, br = EXACT_ROWS, EXACT_COPY0, EXACT_COPY_ROWS
    x = torch.randn(n, DIM, generator=g, device=dev)
    x[b0:b0 + EXACT_SAME] = x[b0]
    for m in range(1, EXACT_COPIES):
        x[b0 + m * br:b0 + (m + 1) * br] = x[b0:b0 + br]
    c, sc = scalar_quantize(x)
    rm = int8_cosine_row_mult(c, sc)
    dead = torch.rand(n, generator=g, device=dev) < EXACT_DEAD
    dead[b0:b0 + EXACT_COPIES * br] = False
    rm = rm.masked_fill(dead, 0.0)
    qs = x[torch.randint(0, n, (N_BATCH,), generator=g, device=dev)] \
        + 0.1 * torch.randn(N_BATCH, DIM, generator=g, device=dev)
    qs[:br - EXACT_SAME + 1] = x[b0 + EXACT_SAME - 1:b0 + br]
    qf = qs / qs.norm(dim=1, keepdim=True).clamp_min(1e-30)
    copies = [sorted(b0 + m * br + i for m in range(EXACT_COPIES)
                     for i in range(EXACT_SAME))]
    copies += [[b0 + i + m * br for m in range(EXACT_COPIES)]
               for i in range(EXACT_SAME, br)]
    checks, worst = {}, dict(max_abs_err=0.0)
    for q in EXACT_QS:
        for k in EXACT_KS:
            got = tk.int8_exact_topk(c, rm, qf[:q], k)
            res = exact_mismatch(
                got, tk.int8_exact_topk_plain(c, rm, qf[:q], k + 1), k)
            rows = got[1].cpu().numpy()
            res["copies_out_of_order"] = sum(
                1 for j, want in enumerate(copies[:q])
                if rows[j, :min(k, len(want))].tolist()
                != want[:min(k, len(want))])
            checks[f"q{q}_k{k}"] = res
            worst[f"k{k}"] = max(worst.get(f"k{k}", 0.0), res["max_abs_err"])
            if (res["max_abs_err"] > EXACT_TOL or res["id_mismatches"]
                    or res["dead_differ"] or res["order_errors"]
                    or res["copies_out_of_order"]):
                raise AssertionError(f"int8_exact at Q={q} k={k} departs "
                                     f"from its plain version: {res}")
    split = exact_split_check(qf)
    same = exact_paths_bit_equal(c, rm, qf)
    torch.backends.cuda.matmul.allow_tf32 = False
    cf = c.float()
    lib = {}
    for sfx, q in (("", N_BATCH), ("_q1", 1)):
        _, lib[sfx] = turns(lambda: tk.int8_exact_topk(c, rm, qf[:q], TOP_K),
                            lambda: torch.matmul(qf[:q], cf.t()),
                            5 if q > 1 else 20)
    del cf
    shape = (f"Q={N_BATCH} (and Q=1) x {n} rows x d={DIM}, "
             f"{EXACT_DEAD:.0%} dead")
    sel = dict(shape=f"{shape}, k={TOP_K}", design=EXACT_DESIGN,
               library=EXACT_LIBRARY, checks=checks, split=split,
               stream_batch_bit_equal=same)
    scr = dict(shape=f"{shape}, k={TOP65}", design=EXACT_DESIGN,
               library=EXACT_LIBRARY)
    # the select mode also at its largest k, where its keys leave one
    # batch block a SM (csrc/int8_exact.cu)
    for rec, sfx, q, k in ((sel, "", N_BATCH, TOP_K), (sel, "_q1", 1, TOP_K),
                           (sel, "_k64", N_BATCH, 64),
                           (scr, "", N_BATCH, TOP65), (scr, "_q1", 1, TOP65)):
        exact_record(rec, sfx, c, rm, qf[:q], k, 3 if q > 1 else 20,
                     lib["_q1" if q == 1 else ""])
        rec[f"shape{sfx}"] = f"Q={q} x {n} x {DIM}, k={k}"
    for rec, k in ((sel, TOP_K), (scr, TOP65)):
        rec["max_abs_err"] = worst[f"k{k}"]
        rec["max_abs_err_q1"] = checks[f"q1_k{k}"]["max_abs_err"]
    sel["max_abs_err_k64"] = checks[f"q{N_BATCH}_k64"]["max_abs_err"]
    say(f"[2] int8_exact vs plain ({len(checks)} shapes, {shape}): max "
        f"err {max(worst.values()):.3g}, 0 ids out of place, copies in "
        f"ascending rows; the split exact on the card ({split['queries']} "
        f"queries), Q=1 / 16 scores bit-equal to Q=17's ({same['scores']} "
        f"of them); select k={TOP_K}: Q={N_BATCH} {sel['ms']:.3f} ms "
        f"(kernel {ms_text(sel['kernel_ms'])}), Q=1 {sel['ms_q1']:.4f} ms "
        f"(kernel {ms_text(sel['kernel_ms_q1'], 4)}), k=64 "
        f"{sel['ms_k64']:.3f} ms; scores k={TOP65}: "
        f"{scr['ms']:.3f} / {scr['ms_q1']:.4f} ms; plain "
        f"{sel['plain_ms']:.3f} / {sel['plain_ms_q1']:.4f} ms; matmul "
        f"{lib['']:.3f} / {lib['_q1']:.4f} ms; bound {sel['bound_ms']:.3f} "
        f"({sel['bound_by']}; FFMA {sel['ffma_bound_ms']:.3f}) / "
        f"{sel['bound_ms_q1']:.4f} ms ({sel['bound_by_q1']})")
    return sel, scr


def topm_row_mult(buf):
    """1 / the norm of each int8 row, a step of rows at a time."""
    import torch

    step = 1 << 18
    return torch.cat([1.0 / buf[r0:r0 + step].float().norm(dim=1)
                      for r0 in range(0, buf.shape[0], step)])


def topm_inputs(buf, rm, window: int, q: int, nprobe: int, q_cap: int,
                g, copies: bool = False):
    """Row 10's inputs over a fixed-window layout: q random unit queries
    (where ``copies``, TOPM_COPY_QUERIES for each of TOPM_RUNS the row
    the run copies, probing its window) quantized as the route quantizes
    them, nprobe distinct random probes each, the query tables of q_cap
    slots. Returns the wrapper's (buf, rmult, first, base, tbl, qq, qsc)
    and the filled slots."""
    import torch

    from neumann_tpu_torch.ops import ivf as tivf
    from neumann_tpu_torch.ops.quant import scalar_quantize

    n_win = buf.shape[0] // window
    x = torch.randn(q, buf.shape[1], generator=g, device=buf.device)
    pick = torch.rand(q, n_win, generator=g, device=buf.device)
    if copies:
        for i, (r0, _) in enumerate(TOPM_RUNS):
            qs = slice(i * TOPM_COPY_QUERIES, (i + 1) * TOPM_COPY_QUERIES)
            x[qs] = buf[r0 - 1].float()
            pick[qs, r0 // window] = 2.0
    qq, qsc = scalar_quantize(x / x.norm(dim=1, keepdim=True),
                              form="reciprocal")
    tbl, _, _ = tivf._query_tables(pick.topk(nprobe, dim=1).indices, n_win,
                                   q_cap)
    live = torch.nonzero(tbl[:, 0] >= 0).flatten()
    base = live * window
    args = (buf, rm, base, base.clone(), tbl[live].contiguous(), qq, qsc)
    return args, int((tbl >= 0).sum())


def topm_runs_met(got, args, window: int, m: int) -> int:
    """The runs' queries whose lists start with their run: the copied row
    and its copies in ascending positions, all one score (the whole list
    where the run is longer than m)."""
    import torch

    base, tbl = args[3], args[4]
    met = 0
    for i, (r0, copies) in enumerate(TOPM_RUNS):
        li = int(torch.nonzero(base == r0 // window * window)[0])
        n = min(m, copies + 1)
        want = torch.arange(r0 - 1, r0 - 1 + n, device=base.device,
                            dtype=torch.int32)
        for qi in range(i * TOPM_COPY_QUERIES, (i + 1) * TOPM_COPY_QUERIES):
            sl = int(torch.nonzero(tbl[li] == qi)[0])
            sc = got[0][li, sl, :n]
            met += int(torch.equal(got[1][li, sl, :n], want)
                       and bool((sc == sc[0]).all()))
    return met


def topm_compare(got, want, tbl) -> dict:
    """Row 10 against its plain version on the filled slots: scores whose
    bits differ, positions that differ, the largest score difference,
    and in the kernel's lists the runs of equal finite scores (ties met)
    and those whose positions do not ascend."""
    import torch

    filled = (tbl >= 0)[:, :, None].expand_as(want[0])
    gs, ws = got[0][filled], want[0][filled]
    fin = torch.isfinite(ws)
    s = torch.where(tbl[:, :, None] >= 0, got[0], float("-inf"))
    same = (s[..., 1:] == s[..., :-1]) & torch.isfinite(s[..., 1:])
    return dict(
        score_bits_differ=int((gs.view(torch.int32)
                               != ws.view(torch.int32)).sum()),
        positions_differ=int((got[1][filled] != want[1][filled]).sum()),
        max_abs_err=float((gs[fin] - ws[fin]).abs().max())
        if fin.any() else 0.0,
        tied_pairs=int(same.sum()),
        order_errors=int((same & (got[1][..., 1:]
                                  <= got[1][..., :-1])).sum()))


def topm_record(rec: dict, sfx: str, args, window: int, m: int,
                filled: int, reps: int) -> None:
    """Row 10's times at one shape into ``rec`` under suffix ``sfx``: the
    call (CUDA events), its kernel's device time (torch.profiler), the
    plain version's, and the bound: the probed windows' rows and
    multipliers, the queries, scales, tables and starts read once and the
    filled slots' top-m written (bytes), 2 window d int8 operations a
    filled slot."""
    from neumann_tpu_torch.ops import kernels as tk

    buf, rm, first, base, tbl, qq, qsc = args
    n_live, d = tbl.shape[0], buf.shape[1]
    rec[f"ms{sfx}"] = cuda_ms(
        lambda: tk.ivf_window_topm(*args, window, m), reps)
    rec[f"device_ms{sfx}"] = device_ms(
        lambda: tk.ivf_window_topm(*args, window, m), 3, "ivf_topm",
        only=r"ivf_topm_kernel")
    rec[f"plain_ms{sfx}"] = cuda_ms(
        lambda: tk.ivf_window_topm_plain(*args, window, m), 1)
    for key, v in bound(n_live * window * (d + 4)
                        + nbytes(first, base, tbl, qq, qsc) + 8 * filled * m,
                        2 * filled * window * d, INT8_OPS_PER_S).items():
        rec[f"{key}{sfx}"] = v
    rec[f"shape{sfx}"] = (f"{n_live} probed windows x {window} x d={d}, "
                          f"q_cap={tbl.shape[1]} ({filled} slots filled), "
                          f"Q={qq.shape[0]}, m={m}")
    rec[f"filled_slots{sfx}"] = filled


def topm_cases(dev, seed: int):
    """Row 10's inputs at A17's TOP 65 batch and at TOPM_EDGES, one shape
    at a time: yields (suffix, the wrapper's args, filled slots, window,
    m, queries). The rows at d DIM (with TOPM_RUNS) are made once and
    shared by the shapes of that width."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + 10)
    n = TOPM_WINDOWS * TOPM_WINDOW
    buf = torch.randint(-127, 128, (n, DIM), generator=g, device=dev,
                        dtype=torch.int8)
    for r0, copies in TOPM_RUNS:
        buf[r0:r0 + copies] = buf[r0 - 1]
    rm = topm_row_mult(buf).masked_fill(
        torch.rand(n, generator=g, device=dev) < TOPM_DEAD, 0.0)
    for r0, copies in TOPM_RUNS:
        rm[r0 - 1:r0 + copies] = 1.0 / buf[r0 - 1].float().norm()
    shapes = {"": (TOPM_WINDOWS, TOPM_WINDOW, DIM, N_BATCH, TOPM_NPROBE,
                   TOPM_Q_CAP, TOPM_M), **TOPM_EDGES}
    for sfx, (n_win, window, d, q, nprobe, q_cap, m) in shapes.items():
        if d == DIM:
            b, r = buf, rm
        else:
            b = torch.randint(-127, 128, (n_win * window, d), generator=g,
                              device=dev, dtype=torch.int8)
            r = topm_row_mult(b)
        args, filled = topm_inputs(b, r, window, q, nprobe, q_cap, g,
                                   copies=d == DIM and window == TOPM_WINDOW)
        yield sfx, args, filled, window, m, q
        del args, b, r
        torch.cuda.empty_cache()


def check_ivf_topm(dev, seed: int) -> dict:
    """Phase 2, row 10: ``ivf_window_topm`` at A17's TOP 65 batch and at
    TOPM_EDGES (``topm_cases``) against its plain version on the same
    inputs, every filled slot bit for bit (``topm_compare``: no score
    bit and no position may differ, and equal scores must come in
    ascending positions), and where the inputs hold TOPM_RUNS, every run
    query's list led by its run (``topm_runs_met``); its time, device
    time and bound beside the plain version's at each shape. Returns the
    record."""
    from neumann_tpu_torch.ops import kernels as tk

    rec = dict(design=TOPM_DESIGN, checks={})
    runs = len(TOPM_RUNS) * TOPM_COPY_QUERIES
    for sfx, args, filled, window, m, q in topm_cases(dev, seed):
        got = tk.ivf_window_topm(*args, window, m)
        res = topm_compare(got, tk.ivf_window_topm_plain(*args, window, m),
                           args[4])
        if args[0].shape[1] == DIM and window == TOPM_WINDOW:
            res["runs_met"] = topm_runs_met(got, args, window, m)
        rec["checks"][sfx or "a17"] = res
        if (res["score_bits_differ"] or res["positions_differ"]
                or res["order_errors"] or res.get("runs_met", runs) < runs):
            raise AssertionError(f"ivf_topm{sfx or ' at A17'} departs from "
                                 f"its plain version: {res}")
        tied = TOPM_COPY_QUERIES * sum(min(c, m - 1) for _, c in TOPM_RUNS)
        if sfx == "" and res["tied_pairs"] < tied:
            raise AssertionError(f"ivf_topm: the copies' ties were not met "
                                 f"({res})")
        del got
        topm_record(rec, sfx, args, window, m, filled, 5 if q > 64 else 20)
    rec["max_abs_err"] = max(c["max_abs_err"] for c in rec["checks"].values())
    say(f"[2] ivf_topm vs plain ({len(rec['checks'])} shapes): scores and "
        f"positions bit-equal on every filled slot, "
        f"{rec['checks']['a17']['tied_pairs']} tied pairs in ascending "
        f"positions, the runs' {runs} queries led by their runs (the "
        f"second's cut inside it); "
        + "; ".join(f"{sfx[1:] or 'A17'} {rec[f'ms{sfx}']:.3f} ms (device "
                    f"{ms_text(rec[f'device_ms{sfx}'])}), plain "
                    f"{rec[f'plain_ms{sfx}']:.3f} ms, bound "
                    f"{rec[f'bound_ms{sfx}']:.3f} ms "
                    f"({rec[f'bound_by{sfx}']})"
                    for sfx in ("", *TOPM_EDGES)))
    return rec


@contextlib.contextmanager
def timed_methods(cls, names, sink: dict):
    """Add each call's seconds of ``cls.<name>`` to ``sink[name]`` (the
    engine trains and encodes inside a route's first query)."""
    saved = {n: getattr(cls, n) for n in names}

    def wrap(n, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sink[n] = sink.get(n, 0.0) + time.perf_counter() - t0
        return timed

    try:
        for n, fn in saved.items():
            setattr(cls, n, wrap(n, fn))
        yield sink
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def hit_rows(hits) -> list:
    return [int(h.key[1:]) for h in hits]


def key_rows(index, ids) -> list:
    """Corpus rows (keys k<row>) of slab row ids, per query."""
    return [[int(k[1:]) for k in index.keys_of(r)] for r in ids]


def pq_select_repeat(book, codes, live, qd) -> dict:
    """A standing check of row 8's select mode at the single query's
    launch (Q 1, the lane layout, k 10, M 96) on phase 14's trained
    codebook and codes: PQ_REPEAT_LAUNCHES launches, the queries' own
    tables in turn (each query PQ_REPEAT_LAUNCHES / len(qd) times), each
    held to the scores mode + ``_topk_stable`` on the same tables (scores
    and columns equal). A launch that differs leaves its inputs in
    chiprun_out/pq_select_mismatch.pt and fails the phase. Also counts
    the queries whose one-query tables differ bit for bit from the same
    rows of a batch's tables (``adc_tables`` at Q 1 and at Q 1,088), and
    those whose top-10 then differ: hits of a single SIMILAR held to a
    batched reference can differ that way with no kernel at fault."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.scan import _topk_stable

    t0 = time.perf_counter()
    batched = book.adc_tables(qd)
    singles = [book.adc_tables(qd[i:i + 1]) for i in range(len(qd))]
    table_diff = [i for i, t in enumerate(singles)
                  if not torch.equal(t[0], batched[i])]
    hits_diff = 0
    for i in table_diff:
        a = tk.pq_adc_topk(codes, singles[i], live, TOP_K)[1]
        b = tk.pq_adc_topk(codes, batched[i:i + 1], live, TOP_K)[1]
        hits_diff += int(not torch.equal(a, b))
    launches = 0
    bad = []
    while launches < PQ_REPEAT_LAUNCHES:
        flags = []
        for i in range(len(qd)):
            if launches >= PQ_REPEAT_LAUNCHES:
                break
            s, c = tk.pq_adc_topk(codes, singles[i], live, TOP_K)
            s2, c2 = _topk_stable(tk.pq_adc_scores(codes, singles[i], live),
                                  TOP_K)
            flags.append(((s != s2) | (c != c2)).any())
            launches += 1
        miss = torch.stack(flags).nonzero().flatten().tolist()
        for j in miss:
            bad.append(j)
            s, c = tk.pq_adc_topk(codes, singles[j], live, TOP_K)
            s2, c2 = _topk_stable(tk.pq_adc_scores(codes, singles[j], live),
                                  TOP_K)
            torch.save({"query": j, "tables": singles[j].cpu(),
                        "select": (s.cpu(), c.cpu()),
                        "scores_topk": (s2.cpu(), c2.cpu())},
                       os.path.join("chiprun_out", "pq_select_mismatch.pt"))
    out = {"pq_repeat_launches": launches, "pq_repeat_mismatches": len(bad),
           "pq_repeat_queries": len(qd),
           "pq_tables_single_vs_batch_differ": len(table_diff),
           "pq_hits_single_vs_batch_tables_differ": hits_diff,
           "pq_repeat_s": time.perf_counter() - t0}
    say(f"[14] row 8 select mode at Q 1, k {TOP_K}: {launches} launches "
        f"over {len(qd)} queries' tables, {len(bad)} differ from the scores "
        f"mode + _topk_stable; {len(table_diff)} queries' one-query tables "
        f"differ from their rows of the batch's, {hits_diff} of them with "
        f"other top-{TOP_K} columns ({out['pq_repeat_s']:.1f} s)")
    if bad:
        raise AssertionError(f"[14] row 8's select mode differs from the "
                             f"scores mode + _topk_stable on queries "
                             f"{bad[:5]} (inputs in chiprun_out/"
                             f"pq_select_mismatch.pt)")
    return out


def pq_select_sweep(codes, live, tables) -> dict:
    """Row 8's select mode beyond the standing check's one shape: Q 8
    and k 1 / 10 / 64, in the lane layout over phase 14's codes, over a
    quarter of them repeated 4 times (equal codes at four rows: ties
    everywhere, across blocks), and in the gathered mode
    (PQ_SWEEP_CANDS seeded candidate positions a query, -1 at every 16th
    and repeats allowed); PQ_SWEEP_ROUNDS launches each, the 8 queries'
    tables in turn, each held to the scores mode + ``_topk_stable`` on
    the same inputs (scores and columns equal). A launch that differs
    fails the phase."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.scan import _topk_stable

    t0 = time.perf_counter()
    n = codes.shape[0]
    quarter = n // 4
    g = torch.Generator(device=codes.device).manual_seed(PQ_SWEEP_CANDS)
    cand = torch.randint(0, n, (PQ_SWEEP_Q, PQ_SWEEP_CANDS), generator=g,
                         device=codes.device, dtype=torch.int32)
    cand[:, ::16] = -1
    modes = {"lane": (codes, live, None),
             "duplicated": (codes[:quarter].repeat(4, 1),
                            live[:quarter].repeat(4), None),
             "gathered": (codes, live, cand)}
    launches, bad = 0, []
    for k in PQ_SWEEP_KS:
        for mode, (c, v, cd) in modes.items():
            for r in range(PQ_SWEEP_ROUNDS):
                q0 = (r * PQ_SWEEP_Q) % (len(tables) - PQ_SWEEP_Q + 1)
                t = tables[q0:q0 + PQ_SWEEP_Q]
                s, col = tk.pq_adc_topk(c, t, v, k, cd)
                s2, col2 = _topk_stable(tk.pq_adc_scores(c, t, v, cd), k)
                launches += 1
                if not (torch.equal(s, s2) and torch.equal(col, col2)):
                    bad.append((mode, k, r))
    out = {"pq_sweep_launches": launches, "pq_sweep_mismatches": len(bad),
           "pq_sweep_s": time.perf_counter() - t0}
    say(f"[14] row 8 select mode at Q {PQ_SWEEP_Q}, k {PQ_SWEEP_KS}, lane /"
        f" duplicated codes / gathered: {launches} launches, {len(bad)} "
        f"differ from the scores mode + _topk_stable {bad[:8]} "
        f"({out['pq_sweep_s']:.1f} s)")
    if bad:
        raise AssertionError(f"[14] row 8's select mode differs from its "
                             f"scores mode: {bad}")
    return out


def run_quantized(args, dev, corpus, queries, on_card: bool,
                  adc_recs=None) -> dict:
    """Phase 14, cell G: phases 7-9's rows in a ``QUANTIZATION pq``
    collection and their first TT_ROWS in a ``QUANTIZATION tt`` one,
    through the router. Counted: 64 singles, a batch of 1,024, 4 ``WHERE
    cat = 3`` (the ADC kernel's select mode) and 2 ``TOP 65`` (its scores
    mode) on pq; 16 singles and a batch of 256 on tt. Gates: pq hits equal
    the plain ADC + top-k on the engine's own codes (keys and order); the
    batch is one select launch and allocates less than its [Q, N] scores
    would take; tt hits equal the exact scan over the reconstructed rows;
    TT_SAMPLE sampled rows reconstruct within TT_RTOL of the numpy
    ``tt_decompose``; filtered hits in their category. recall@10 against
    the exact f32 scan (L2 for pq, cosine for tt) is recorded, not
    limited. ``adc_recs``: row 8's (scores, select) records, which get
    the batch's launch shape."""
    import torch

    from neumann_tpu_torch.compress.tensor_train import (
        TTConfig,
        tt_decompose,
        tt_reconstruct,
    )
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.pq import PQCodebook, pq_topk
    from neumann_tpu_torch.ops.scan import topk_scan
    from neumann_tpu_torch.router import QueryRouter

    n = len(corpus)
    report = {}
    single = queries[:N_SINGLE]
    batch = queries[N_SINGLE:N_SINGLE + N_BATCH]
    extra = queries[N_SINGLE + N_BATCH:][:N_PQ_FILTERED]
    router = QueryRouter(device=dev)
    eng = router.vector
    router.execute(f"CREATE COLLECTION pq DIM {DIM} QUANTIZATION pq")
    t0 = time.perf_counter()
    with eng.bulk_ingest():
        for i in range(n):
            eng.store_in_collection("pq", f"k{i}", corpus[i],
                                    {"cat": i % N_CATS})
    report["pq_ingest_s"] = time.perf_counter() - t0
    stmts = [f"SIMILAR {vec_literal(q)} IN pq TOP {TOP_K}" for q in single]
    spent = {}
    with timed_methods(PQCodebook, ("train", "encode"), spent):
        t0 = time.perf_counter()
        router.execute(stmts[0])
        report["pq_first_query_s"] = time.perf_counter() - t0
    report["pq_train_s"] = spent["train"]
    report["pq_encode_s"] = spent["encode"]
    with gc_pauses_ms() as (pauses, young):
        tk.reset_launch_counts()
        lat, rows_s, _ = similar_series(router, stmts, cosine=False)
        qps, times, rows_b, _ = batch_series(
            lambda: eng.batch_search_ns(batch, TOP_K, ns="col/pq"))
        lat_f, rows_f, _ = similar_series(router, [
            f"SIMILAR {vec_literal(q)} IN pq WHERE cat = {FILTER_CAT} TOP "
            f"{TOP_K}" for q in extra], cosine=False)
        lat_65, rows_65, _ = similar_series(router, [
            f"SIMILAR {vec_literal(q)} IN pq TOP {PQ_TOP65}"
            for q in single[:N_PQ_TOP65]], cosine=False, k=PQ_TOP65)
        pq_launches = dict(tk.LAUNCHES)
    latency_stats(report, "pq_single", lat)
    latency_stats(report, "pq_filtered", lat_f)
    report["pq_top65_ms"] = lat_65
    report["pq_batch_s"] = times
    report["pq_batch_qps"] = qps
    coll = eng._corpora["col/pq"][DIM]
    _, book, codes, code_rows = coll._pq
    qd = torch.from_numpy(np.ascontiguousarray(
        queries[:N_SINGLE + N_BATCH + N_PQ_FILTERED])).to(dev)
    live = torch.from_numpy(coll.slab.valid_mask_host()[code_rows]).to(dev)
    cat = torch.from_numpy(np.asarray([
        int(k[1:]) % N_CATS == FILTER_CAT
        for k in coll.index.keys_of(code_rows.tolist())])).to(dev)
    with plain_kernels():
        _, ref = pq_topk(book, codes, qd[:N_SINGLE + N_BATCH], TOP_K, live)
        _, ref_f = pq_topk(book, codes, qd[N_SINGLE + N_BATCH:], TOP_K,
                           live & cat)
        _, ref_65 = pq_topk(book, codes, qd[:N_PQ_TOP65], PQ_TOP65, live)
    want = [key_rows(coll.index, code_rows[r.cpu().numpy()].tolist())
            for r in (ref, ref_f, ref_65)]
    want = want[0] + want[1] + want[2]
    bad = [i for i, (got, w) in enumerate(zip(
        rows_s + rows_b + rows_f + rows_65, want)) if got != w]
    off_cat = [r for rr in rows_f for r in rr if r % N_CATS != FILTER_CAT]
    emb, valid = coll.slab.device_view()
    _, oracle = topk_scan(emb, qd[:N_SINGLE + N_BATCH], TOP_K, "euclidean",
                          valid)
    report["pq_recall_vs_l2"] = recall(rows_s + rows_b, np.asarray(
        key_rows(coll.index, oracle.cpu().numpy().tolist())))
    report["pq_subspaces"] = book.config.n_subspaces
    report["pq_mismatches"] = len(bad)
    report["launches_pq"] = pq_launches
    say(f"[14] pq collection, {n} rows stored in "
        f"{report['pq_ingest_s']:.1f} s; first query "
        f"{report['pq_first_query_s']:.2f} s (train "
        f"{report['pq_train_s']:.2f} s, encode {report['pq_encode_s']:.2f} "
        f"s, M {book.config.n_subspaces}); single p50 "
        f"{report['pq_single_p50_ms']:.3f} ms p99 "
        f"{report['pq_single_p99_ms']:.3f} ms; batch of {N_BATCH}: "
        f"{qps:.0f} QPS; filtered p50 {report['pq_filtered_p50_ms']:.3f} "
        f"ms; recall@{TOP_K} vs exact L2 {report['pq_recall_vs_l2']:.4f}; "
        f"{len(bad)} queries differ from the plain ADC; launches "
        f"{pq_launches}")
    if bad or off_cat:
        raise AssertionError(f"pq hits differ from the plain ADC for "
                             f"queries {bad[:5]}, or outside cat "
                             f"{FILTER_CAT}: {off_cat[:5]}")
    if on_card:
        require_launches(pq_launches, ("pq_adc", "pq_adc_select"), "14")
        # the batch in one select launch (the launch counter), allocating
        # far less than its [Q, N] f32 scores; row 8 in both modes at that
        # launch's shape on the engine's codes and tables; then where one
        # batch call's device time goes
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        with adc_launches() as seen:
            eng.batch_search_ns(batch, TOP_K, ns="col/pq")
        torch.cuda.synchronize()
        report["pq_batch_launch_counts"] = {
            k: tk.LAUNCHES[k] for k in ("pq_adc", "pq_adc_select")}
        report["pq_batch_peak_extra_gb"] = (
            torch.cuda.max_memory_allocated() - base) / 1e9
        scores_gb = len(batch) * n * 4 / 1e9
        report["pq_batch_adc_launches"] = len(seen)
        if report["pq_batch_launch_counts"] != {"pq_adc": 0,
                                                "pq_adc_select": 1} or \
                not report["pq_batch_peak_extra_gb"] < scores_gb / 4:
            raise AssertionError(
                f"pq batch: launches {report['pq_batch_launch_counts']} "
                f"(want one select launch), peak +"
                f"{report['pq_batch_peak_extra_gb']:.2f} GB (its [Q, N] "
                f"scores: {scores_gb:.2f} GB)")
        a = seen[0][1]
        del seen
        adc_both(adc_recs, "_g_step", a)
        del a
        prof = profile_calls({"pq_batch": lambda: eng.batch_search_ns(
            batch, TOP_K, ns="col/pq")}, "chiprun_out")["pq_batch"]
        adc_ms = None if prof["trace_lost"] else sum(
            v for k, v in prof["kernels_ms"].items()
            if any(n in k for n in ADC_KERNEL_NAMES))
        report["profile_pq_batch"] = dict(prof, adc_device_ms=adc_ms)
        # the call's kernels from a second trace, of the call alone
        report["pq_batch_device_ms"] = device_ms(
            lambda: eng.batch_search_ns(batch, TOP_K, ns="col/pq"), 1,
            "pq_batch")
        say(f"[14] pq batch of {N_BATCH}: launches "
            f"{report['pq_batch_launch_counts']}, peak +"
            f"{report['pq_batch_peak_extra_gb']:.3f} GB (its scores would "
            f"take {scores_gb:.2f}); device "
            f"{ms_text(report['pq_batch_device_ms'], 2)} ms a call; "
            f"profiled: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{ms_text(prof['device_busy_ms'], 2)} ms, of it row 8 "
            f"{ms_text(adc_ms, 2)} ms")
        report.update(pq_select_repeat(book, codes, live,
                                       qd[:N_SINGLE + N_BATCH]))
        report.update(pq_select_sweep(codes, live, book.adc_tables(
            qd[:N_SINGLE + N_BATCH])))
    del emb, valid, codes, book, coll, live, cat, router, eng
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- tt, a router of its own -----------------------------------------
    m = min(n, TT_ROWS)
    router = QueryRouter(device=dev)
    eng = router.vector
    router.execute(f"CREATE COLLECTION tt DIM {DIM} QUANTIZATION tt")
    t0 = time.perf_counter()
    with eng.bulk_ingest():
        for i in range(m):
            eng.store_in_collection("tt", f"k{i}", corpus[i])
    report["tt_ingest_s"] = time.perf_counter() - t0
    stmts = [f"SIMILAR {vec_literal(q)} IN tt TOP {TOP_K}"
             for q in single[:N_TT_SINGLE]]
    tt_batch = batch[:N_TT_BATCH]
    t0 = time.perf_counter()
    router.execute(stmts[0])
    report["tt_first_query_s"] = time.perf_counter() - t0
    with gc_pauses_ms() as (pauses, young):
        tk.reset_launch_counts()
        lat, rows_s, _ = similar_series(router, stmts)
        qps, times, rows_b, _ = batch_series(
            lambda: eng.batch_search_ns(tt_batch, TOP_K, ns="col/tt"))
        report["launches_tt"] = dict(tk.LAUNCHES)
    latency_stats(report, "tt_single", lat)
    report["tt_batch_s"] = times
    report["tt_batch_qps"] = qps
    coll = eng._corpora["col/tt"][DIM]
    _, tts, tt_rows = coll._tt
    t0 = time.perf_counter()
    recon = tts.reconstruct()
    if on_card:
        torch.cuda.synchronize()
    report["tt_reconstruct_ms"] = (time.perf_counter() - t0) * 1e3
    report["tt_compression_ratio"] = tts.compression_ratio()
    report["tt_rank_profiles"] = len(tts.groups)
    tq = torch.cat([qd[:N_TT_SINGLE], qd[N_SINGLE:N_SINGLE + N_TT_BATCH]])
    live = torch.from_numpy(coll.slab.valid_mask_host()[tt_rows]).to(dev)
    _, ref = topk_scan(recon, tq, TOP_K, "cosine", live)
    want = key_rows(coll.index, tt_rows[ref.cpu().numpy()].tolist())
    bad = [i for i, (got, w) in enumerate(zip(rows_s + rows_b, want))
           if got != w]
    # sampled rows against the numpy decomposition, row by row
    cfg = TTConfig.for_dim(coll.slab.dim_pad)
    pick = np.random.default_rng(args.seed).choice(m, min(m, TT_SAMPLE),
                                                   replace=False)
    got = recon[torch.from_numpy(pick).to(dev)].cpu().numpy()
    ref_rec = np.stack([tt_reconstruct(tt_decompose(r, cfg)) for r in
                        coll.slab.rows_matrix(tt_rows[pick])[0]])
    err = float((np.abs(got - ref_rec).max(axis=1)
                 / np.maximum(np.abs(ref_rec).max(axis=1), 1e-30)).max())
    report["tt_sample_max_rel_err"] = err
    emb, valid = coll.slab.device_view()
    _, oracle = topk_scan(emb, tq, TOP_K, "cosine", valid)
    report["tt_recall_vs_f32"] = recall(rows_s + rows_b, np.asarray(
        key_rows(coll.index, oracle.cpu().numpy().tolist())))
    report["tt_mismatches"] = len(bad)
    say(f"[14] tt collection, {m} rows stored in "
        f"{report['tt_ingest_s']:.1f} s; first query (the decomposition) "
        f"{report['tt_first_query_s']:.2f} s, {len(tts.groups)} rank "
        f"profiles, compression {report['tt_compression_ratio']:.3f}x; "
        f"single p50 {report['tt_single_p50_ms']:.3f} ms; batch of "
        f"{len(tt_batch)}: {qps:.0f} QPS; reconstruct "
        f"{report['tt_reconstruct_ms']:.2f} ms; sampled rows vs numpy: "
        f"max rel err {err:.3g}; recall@{TOP_K} vs f32 "
        f"{report['tt_recall_vs_f32']:.4f}; {len(bad)} queries differ from "
        f"the exact scan of the reconstruction")
    if bad or not err <= TT_RTOL:
        raise AssertionError(f"tt hits differ from the exact scan of the "
                             f"reconstructed rows for {bad[:5]}, or sampled "
                             f"rows off numpy by {err} (rtol {TT_RTOL})")
    return report


# ---------------------------------------------------------------------------
# phase 15 (cell H): the ANN index APIs
# ---------------------------------------------------------------------------

def ann_router(dev, corpus: np.ndarray):
    """A router whose default namespace holds ``corpus`` (keys k0..)."""
    from neumann_tpu_torch.router import QueryRouter

    router = QueryRouter(device=dev)
    router.vector.ingest_matrix([f"k{i}" for i in range(len(corpus))],
                                corpus)
    return router


def exact_rows(dev, corpus_t, q: np.ndarray, k: int = TOP_K) -> np.ndarray:
    """Exact f32 cosine top-k row ids of queries over a device matrix."""
    import torch

    from neumann_tpu_torch.ops.scan import topk_scan

    _, ids = topk_scan(corpus_t, torch.from_numpy(
        np.ascontiguousarray(q)).to(dev), k, "cosine")
    return ids.cpu().numpy()


def timed_hits(fn, queries) -> tuple:
    """(latencies ms, hit rows) of fn(q) per query."""
    lat, rows = [], []
    for q in queries:
        t0 = time.perf_counter()
        hits = fn(q)
        lat.append((time.perf_counter() - t0) * 1e3)
        rows.append(hit_rows(hits))
    return lat, rows


def same_hits(a, b) -> bool:
    return [(h.key, h.score) for h in a] == [(h.key, h.score) for h in b]


def run_ann(args, dev, corpus, queries, on_card: bool,
            adc_recs=None) -> dict:
    """Phase 15, cell H: the ANN index APIs. build_ivf_index over
    IVF_ROWS of phases 7-9's rows in a default namespace (IVF_CLUSTERS
    clusters), 64 singles at each of IVF_NPROBES, IVF_CHECKED of them
    equal to an exact float64 scan of their probed lists; IVFIndex (the
    default 8 PQ subspaces) in the pq storage (row 8's gathered mode,
    equal to its plain version) and the binary storage on IVF_INDEX_ROWS
    rows; build_hnsw_index (dense, quantized, binary) on routers of their
    own; save_index -> load_index on a fresh router gives the same hits,
    for HNSW and for IVF."""
    import tempfile

    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.ivf import IVFConfig, IVFIndex
    from neumann_tpu_torch.ops.scan import _topk_stable

    report = {}
    qs = np.ascontiguousarray(queries[:N_SINGLE])
    corpus_t = torch.from_numpy(corpus).to(dev)

    # ---- the legacy IVF API -----------------------------------------------
    n_ivf = min(len(corpus), IVF_ROWS)
    router = ann_router(dev, corpus[:n_ivf])
    eng = router.vector
    t0 = time.perf_counter()
    eng.build_ivf_index(n_clusters=IVF_CLUSTERS, nprobe=max(IVF_NPROBES))
    report["ivf_build_s"] = time.perf_counter() - t0
    idx, _, row_map = eng._ivf
    report["ivf_stride"] = idx._stride
    oracle = exact_rows(dev, corpus_t[:n_ivf], qs)
    tk.reset_launch_counts()
    for nprobe in IVF_NPROBES:
        lat, rows = timed_hits(
            lambda q: eng.search_with_ivf_nprobe(q, TOP_K, nprobe), qs)
        report[f"ivf_nprobe{nprobe}_p50_ms"] = float(np.percentile(lat, 50))
        report[f"ivf_nprobe{nprobe}_recall"] = recall(rows, oracle)
    ivf_launches = dict(tk.LAUNCHES)
    # the plain reference: the same probed lists (the f32 cosine to the
    # normalized centroids, as the index ranks them), scanned exactly
    cents = torch.from_numpy(idx.centroids).to(dev)
    cn = cents / cents.norm(dim=1, keepdim=True).clamp_min(1e-30)
    qd = torch.from_numpy(qs).to(dev)
    qn = qd / qd.norm(dim=1, keepdim=True).clamp_min(1e-30)
    swaps = 0
    for nprobe in IVF_NPROBES:
        _, probe = _topk_stable(qn[:IVF_CHECKED] @ cn.T,
                                min(nprobe, len(cn)))
        for qi, blocks in enumerate(probe.cpu().numpy()):
            pos = (blocks[:, None] * idx._stride
                   + np.arange(idx._stride)).reshape(-1)
            ids = idx._row_ids[pos]
            rows = np.sort(row_map[ids[ids >= 0]])
            hits = eng.search_with_ivf_nprobe(qs[qi], TOP_K, nprobe)
            swaps += check_ranked(
                [{"key": h.key, "score": h.score} for h in hits], corpus,
                rows, qs[qi], TOP_K)
    report["ivf_swaps"] = swaps
    say(f"[15] IVF index, {n_ivf} rows, {idx.config.n_clusters} "
        f"clusters (stride {idx._stride}), built in "
        f"{report['ivf_build_s']:.1f} s; "
        + "; ".join(f"nprobe {p}: p50 {report[f'ivf_nprobe{p}_p50_ms']:.3f}"
                    f" ms, recall@{TOP_K} "
                    f"{report[f'ivf_nprobe{p}_recall']:.4f}"
                    for p in IVF_NPROBES)
        + f"; {IVF_CHECKED} queries a nprobe equal the exact scan of their "
          f"probed lists ({swaps} near-tie swaps)")
    eng._ivf = None
    del router, eng, idx, cents
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- IVFIndex, pq and binary storages --------------------------------
    m = min(len(corpus), IVF_INDEX_ROWS)
    x = corpus_t[:m]
    oracle = exact_rows(dev, x, qs)
    batch = np.ascontiguousarray(queries[N_SINGLE:N_SINGLE + N_TT_BATCH])
    launches = {}
    for storage in ("pq", "binary"):
        ix = IVFIndex(DIM, IVFConfig(
            n_clusters=min(IVF_INDEX_CLUSTERS, m), nprobe=IVF_INDEX_NPROBE,
            storage=storage), device=dev)
        t0 = time.perf_counter()
        ix.train(x[:100_000])
        ix.add(x)
        report[f"ivf_{storage}_build_s"] = time.perf_counter() - t0
        tk.reset_launch_counts()
        lat, rows = [], []
        for q in qs:
            t0 = time.perf_counter()
            _, ids = ix.search(q, TOP_K)
            lat.append((time.perf_counter() - t0) * 1e3)
            rows.append(ids[0].tolist())
        t0 = time.perf_counter()
        s_b, i_b = ix.search(batch, TOP_K)
        report[f"ivf_{storage}_batch_qps"] = len(batch) / (
            time.perf_counter() - t0)
        launches[storage] = dict(tk.LAUNCHES)
        report[f"ivf_{storage}_p50_ms"] = float(np.percentile(lat, 50))
        report[f"ivf_{storage}_recall"] = recall(rows, oracle)
        if storage == "pq":
            with plain_kernels():
                s_p, i_p = ix.search(batch, TOP_K)
            if not (np.array_equal(i_p, i_b) and np.array_equal(s_p, s_b)):
                raise AssertionError("IVFIndex pq storage: ids or scores "
                                     "differ from the plain ADC")
            if adc_recs is not None:
                # row 8's gathered mode at the shapes this index launches:
                # the batch's query steps (they bound the [Q, C]
                # candidates) and a single query, on its own codes and
                # tables, in both modes
                with adc_launches() as seen:
                    ix.search(batch, TOP_K)
                    ix.search(qs[0], TOP_K)
                report["ivf_pq_batch_adc_launches"] = len(seen) - 1
                report["ivf_pq_adc_modes"] = sorted({m for m, _ in seen})
                if report["ivf_pq_adc_modes"] != ["select"]:
                    raise AssertionError(
                        f"IVFIndex pq at TOP {TOP_K} launched "
                        f"{report['ivf_pq_adc_modes']} (want the select "
                        f"mode alone)")
                steps = {"_h_step": seen[0], "_h_tail": seen[-2],
                         "_h_single": seen[-1]}
                del seen
                for sfx, (_, a) in steps.items():
                    adc_both(adc_recs, sfx, a)
                del steps, a
        say(f"[15] IVFIndex {storage}, {m} rows, "
            f"{ix.config.n_clusters} clusters (stride {ix._stride}), built "
            f"in {report[f'ivf_{storage}_build_s']:.1f} s: p50 "
            f"{report[f'ivf_{storage}_p50_ms']:.3f} ms, batch of "
            f"{len(batch)} {report[f'ivf_{storage}_batch_qps']:.0f} QPS, "
            f"recall@{TOP_K} {report[f'ivf_{storage}_recall']:.4f} (nprobe "
            f"{IVF_INDEX_NPROBE}); launches {launches[storage]}")
        del ix
        gc.collect()
    report["launches_ann"] = {
        name: ivf_launches.get(name, 0) + sum(lc.get(name, 0)
                                              for lc in launches.values())
        for name in tk.LAUNCHES}
    if on_card:
        require_launches(launches["pq"], ("pq_adc_select",), "15")
        torch.cuda.empty_cache()

    # ---- HNSW, and saved indexes -----------------------------------------
    # the three graphs build at once, a thread each (the native inserts
    # release the GIL); each build's own seconds give its insert rate
    engines = {st: ann_router(dev, corpus[:min(n_rows, len(corpus))]).vector
               for st, n_rows in (("dense", HNSW_ROWS),
                                  ("quantized", HNSW_QUANT_ROWS),
                                  ("binary", HNSW_BINARY_ROWS))}

    def build(storage):
        t0 = time.perf_counter()
        rows_n = engines[storage].build_hnsw_index(storage=storage)
        return rows_n, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(engines)) as pool:
        built = dict(zip(engines, pool.map(build, engines)))
    report["hnsw_build_wall_s"] = time.perf_counter() - t0
    say(f"[15] HNSW graphs built concurrently in "
        f"{report['hnsw_build_wall_s']:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        for storage, eng in engines.items():
            rows_n, dt = built[storage]
            report[f"hnsw_{storage}_rows"] = rows_n
            report[f"hnsw_{storage}_build_s"] = dt
            report[f"hnsw_{storage}_insert_per_s"] = rows_n / dt
            lat, rows = timed_hits(lambda q: eng.search_with_hnsw(q, TOP_K),
                                   qs)
            report[f"hnsw_{storage}_p50_ms"] = float(np.percentile(lat, 50))
            report[f"hnsw_{storage}_recall"] = recall(
                rows, exact_rows(dev, corpus_t[:rows_n], qs))
            say(f"[15] HNSW {storage}, {rows_n} rows: built in {dt:.1f} s "
                f"({rows_n / dt:.0f} inserts/s), search p50 "
                f"{report[f'hnsw_{storage}_p50_ms']:.3f} ms, recall@{TOP_K} "
                f"{report[f'hnsw_{storage}_recall']:.4f} (ef 50)")
            if storage == "dense":
                path = os.path.join(tmp, "hnsw.npz")
                eng.save_index(path)
                fresh = ann_router(dev, corpus[:rows_n]).vector
                if fresh.load_index(path) != rows_n or not all(
                        same_hits(eng.search_with_hnsw(q, TOP_K),
                                  fresh.search_with_hnsw(q, TOP_K))
                        for q in qs[:16]):
                    raise AssertionError("a loaded HNSW index gives other "
                                         "hits")
                ivf_eng = ann_router(dev, corpus[:rows_n]).vector
                ivf_eng.build_ivf_index(n_clusters=64, nprobe=8)
                path = os.path.join(tmp, "ivf.npz")
                ivf_eng.save_index(path)
                fresh = ann_router(dev, corpus[:rows_n]).vector
                if fresh.load_index(path) != rows_n or not all(
                        same_hits(ivf_eng.search_with_ivf_nprobe(q, TOP_K, 8),
                                  fresh.search_with_ivf_nprobe(q, TOP_K, 8))
                        for q in qs[:16]):
                    raise AssertionError("a loaded IVF index gives other "
                                         "hits")
                report["saved_index_ok"] = True
                say("[15] save_index -> load_index on a fresh router: the "
                    "same hits for HNSW and for IVF")
                del ivf_eng, fresh
    del engines, eng
    gc.collect()
    return report


def check_native_parse(seed: int) -> dict:
    """Phase 1's parse check: the port's native lexer and parser build
    from neumann_tpu_torch/native/*.cpp and load, ``lang.parser.parse``
    is the native entry, and on N_PARSE unseen ``SIMILAR [...] TOP 10``
    statements of 768 and of 3,072 floats its AST equals the pure-Python
    parser's (regex tokenizer, recursive descent). Medians of three
    parses of each statement in this call: the native entry, the Python
    parser over the native tokenizer (where a statement past the C
    parser's 4,096 tokens falls through to) and the pure-Python path."""
    from neumann_tpu_torch.lang import lexer as lx
    from neumann_tpu_torch.lang import parser as lp
    from neumann_tpu_torch.native import pylexer, pyparser

    t0 = time.perf_counter()
    if pylexer.load() is None or pyparser.load() is None:
        raise AssertionError("the native lexer or parser did not build")
    out = {"build_native_parser_s": time.perf_counter() - t0}
    lp._native()
    if lp.parse.__name__ != "parse_full":
        raise AssertionError("lang.parser.parse is not the native entry")
    ext = pyparser.load()
    rng = np.random.default_rng(seed)
    for d in (DIM, WIDE_DIM):
        native, native_lex, python = [], [], []
        for v in rng.standard_normal((N_PARSE, d)).astype(np.float32):
            stmt = f"SIMILAR {vec_literal(v)} TOP {TOP_K}"
            t0 = time.perf_counter()
            got = lp.parse(stmt)
            t1 = time.perf_counter()
            lp._parse_python(stmt)
            t2 = time.perf_counter()
            saved = lx._EXT, lx._EXT_TRIED
            lx._EXT, lx._EXT_TRIED = None, True    # the regex tokenizer
            try:
                t3 = time.perf_counter()
                want = lp._parse_python(stmt)
                t4 = time.perf_counter()
            finally:
                lx._EXT, lx._EXT_TRIED = saved
            native.append((t1 - t0) * 1e3)
            native_lex.append((t2 - t1) * 1e3)
            python.append((t4 - t3) * 1e3)
            if got != want or len(got.query_vector) != d:
                raise AssertionError(f"native AST differs at {d} floats")
        sfx = "" if d == DIM else f"_{d}"
        out[f"parse_native_ms{sfx}"] = float(np.median(native))
        out[f"parse_python_native_lex_ms{sfx}"] = float(np.median(native_lex))
        out[f"parse_python_ms{sfx}"] = float(np.median(python))
        # the C parser takes at most 4,096 tokens (MAX_TOKS): longer
        # statements fall through to the Python parser
        out[f"parse_native_covers{sfx}"] = ext.parse(stmt) is not None
        say(f"[1] parse of an unseen {d}-float SIMILAR, median of "
            f"{N_PARSE}: native entry {out[f'parse_native_ms{sfx}']:.3f} "
            f"ms, Python parser on native tokens "
            f"{out[f'parse_python_native_lex_ms{sfx}']:.3f} ms, pure "
            f"Python {out[f'parse_python_ms{sfx}']:.3f} ms (ASTs "
            f"equal; the C fast path "
            f"{'covers' if out[f'parse_native_covers{sfx}'] else 'falls through at'}"
            f" {d} floats)")
    if not out["parse_native_covers"]:
        raise AssertionError("the native parser does not cover a 768-float "
                             "SIMILAR")
    return out


@contextlib.contextmanager
def serving(router):
    """Batched serving on and a RestServer on 127.0.0.1:0; yields the
    port. Stops the server and the batchers' threads on the way out."""
    from neumann_tpu_torch.server import RestServer

    router.enable_batched_serving()
    srv = RestServer(router)
    try:
        yield srv.serve()
    finally:
        srv.stop()
        router.disable_batched_serving()


def post(port: int, path: str, body: bytes):
    """One request on a connection of its own: (ms, status, JSON)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return (time.perf_counter() - t0) * 1e3, resp.status, json.loads(data)


def served_run(port: int, stmts, clients: int = N_CLIENTS):
    """POST each statement to /query from ``clients`` threads. Returns the
    latencies (ms), the hits per statement and the wall seconds; fails
    unless every response is 200 with TOP_K finite hits."""
    bodies = [json.dumps({"query": s}).encode() for s in stmts]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as ex:
        got = list(ex.map(lambda b: post(port, "/query", b), bodies))
    wall = time.perf_counter() - t0
    bad = [(i, st, body) for i, (_, st, body) in enumerate(got)
           if st != 200 or len(body["hits"]) != TOP_K or not all(
               np.isfinite(h["score"]) for h in body["hits"])]
    if bad:
        raise AssertionError(f"{len(bad)} served statements failed: "
                             f"{bad[:3]}")
    return [g[0] for g in got], [g[2]["hits"] for g in got], wall


def batcher_counts(router):
    bs = list((router._batchers or {}).values())
    return (sum(b.batches_run for b in bs),
            sum(b.queries_served for b in bs))


def served_part(report: dict, prefix: str, router, run):
    """A served run (``run()``: ``served_run`` or ``grpc_served_run`` on
    its statements) with its p50 / p99, QPS, the batches the router's
    batchers ran and their mean cohort size; fails unless the mean cohort
    is above 1 (concurrent statements were coalesced). Returns the row
    ids per statement and the hits."""
    b0, s0 = batcher_counts(router)
    lat, hits, wall = run()
    b1, s1 = batcher_counts(router)
    report[f"{prefix}_p50_ms"] = float(np.percentile(lat, 50))
    report[f"{prefix}_p99_ms"] = float(np.percentile(lat, 99))
    report[f"{prefix}_qps"] = len(lat) / wall
    report[f"{prefix}_batches"] = b1 - b0
    report[f"{prefix}_mean_cohort"] = (s1 - s0) / max(b1 - b0, 1)
    if report[f"{prefix}_mean_cohort"] <= 1:
        raise AssertionError(f"{prefix}: no coalescing ({b1 - b0} batches "
                             f"for {s1 - s0} queries)")
    return [[int(h["key"][1:]) for h in hh] for hh in hits], hits


def profile_served(port: int, stmts, tag: str) -> dict:
    """Where a served query's time goes: one client's run under cProfile
    (one profiler sees every thread: client, HTTP handler, batcher
    worker; profile_served_<tag>_host.txt by own time), then a run from
    N_CLIENTS threads under torch.profiler (device kernel time against
    the wall: the device busy share of serving; None where the trace
    lost launches, as in ``profile_calls``)."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    served_run(port, stmts[:N_PROFILED], clients=1)
    prof.disable()
    txt = io.StringIO()
    st = pstats.Stats(prof, stream=txt).sort_stats("tottime")
    st.print_stats(40)
    with open(os.path.join("chiprun_out", f"profile_served_{tag}_host.txt"),
              "w") as f:
        f.write(txt.getvalue())
    top = sorted(((v[2] * 1e3, f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})")
                  for k, v in st.stats.items()), reverse=True)[:10]
    out = dict(device_idle(lambda: served_run(port, stmts), f"served {tag}"),
               host_top_own_ms=top)
    idle = "" if out["trace_lost"] else \
        f" (idle share {100 * out['device_idle_share']:.1f}%)"
    say(f"[profile] served {tag}: {len(stmts)} statements from {N_CLIENTS} "
        f"clients in {out['served_wall_ms']:.1f} ms, device busy "
        f"{ms_text(out['device_busy_ms'], 2)} ms{idle}; one client's host "
        f"top by own time: {[(n, round(ms, 1)) for ms, n in top[:5]]}")
    return out


def device_idle(run, what: str) -> dict:
    """``run()`` (a served run) under torch.profiler: device kernel time
    against the wall, the card's idle share while it serves (None where
    the trace lost launches, as in ``profile_calls``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neumann_tpu_torch.ops import kernels as tk

    torch.cuda.synchronize()
    before = dict(tk.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, lost = trace_kernel_ms(tp, launches_since(before), what)
    busy = None if lost else sum(kernels.values())
    return dict(served_wall_ms=wall, device_busy_ms=busy, trace_lost=lost,
                device_idle_share=None if lost else 1 - busy / wall)


def serve_ivf(router, qs, truth, on_card: bool) -> dict:
    """Phase 12a: served auto-IVF on A's router. ``router.warmup()``,
    then batched serving and a RestServer: N_SERVED ``SIMILAR [...] TOP
    10`` of the batch queries (their exact top-10 known) from N_CLIENTS
    threads; every response 200, recall@10 >= MIN_RECALL, mean cohort
    above 1. Launches counted from the warm-up on: served cohorts of at
    most N_CLIENTS queries take the probe kernel (the latency path up to
    ivf_auto_max_batch), the warm-up's 64 and 256 buckets the batched
    top-2 kernel."""
    from neumann_tpu_torch.ops import kernels as tk

    report = {}
    stmts = [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in qs[:N_SERVED]]
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    report["warmup_calls"] = router.warmup()
    report["warmup_s"] = time.perf_counter() - t0
    warm = dict(tk.LAUNCHES)
    with serving(router) as port:
        rows, _ = served_part(report, "served_ivf", router,
                              lambda: served_run(port, stmts))
        launches = dict(tk.LAUNCHES)
        if on_card:
            report["profile_served_ivf"] = profile_served(port, stmts, "ivf")
    report["served_ivf_recall"] = recall(rows, truth[:N_SERVED])
    report["launches_served_ivf"] = launches
    report["launches_served_ivf_http"] = {
        k: v - warm.get(k, 0) for k, v in launches.items()}
    say(f"[12a] warm-up: {report['warmup_calls']} calls in "
        f"{report['warmup_s']:.3f} s; served {len(stmts)} SIMILARs over "
        f"HTTP from {N_CLIENTS} clients: p50 "
        f"{report['served_ivf_p50_ms']:.3f} ms p99 "
        f"{report['served_ivf_p99_ms']:.3f} ms, "
        f"{report['served_ivf_qps']:.0f} QPS, "
        f"{report['served_ivf_batches']} batches (mean cohort "
        f"{report['served_ivf_mean_cohort']:.2f}), recall@{TOP_K} "
        f"{report['served_ivf_recall']:.4f}; launches {launches} (HTTP "
        f"part {report['launches_served_ivf_http']})")
    if report["served_ivf_recall"] < MIN_RECALL:
        raise AssertionError("served auto-IVF recall below the limit")
    if on_card:
        require_launches(launches, ("ivf_probe", "batched_probe"), "12a")
    return report


def serve_brute(router, batch, extra, truth, truth_f, ref_bits, bits_index,
                on_card: bool) -> dict:
    """Phase 12b: served brute-force routes on B's router. Over HTTP with
    batching on, N_SERVED statements each on the default namespace (f32
    pooled), ``IN q8`` (int8) and ``IN bits`` (binary): recall@10 >=
    MIN_RECALL on the first two, the plain hamming top-k's ids and
    distances in order on the third; N_FILTERED ``WHERE cat = 3`` (every
    hit in cat 3, recall against the masked scan); one cohort with an
    ``in`` filter built on a list (not hashable) submitted straight to
    the default batcher, then a plain query that must be answered; and
    N_POINTS REST Points queries on q8 (no batcher), one client."""
    from neumann_tpu_torch.engines.vector import FilterCondition
    from neumann_tpu_torch.ops import kernels as tk

    report = {}
    qs = batch[:N_SERVED]
    tk.reset_launch_counts()
    with serving(router) as port:
        for name, suffix, kernel in (
                ("pooled", "", "f32_pooled_bits"),
                ("int8", " IN q8", "int8_pooled_bits"),
                ("binary", " IN bits", "hamming_topk")):
            stmts = [f"SIMILAR {vec_literal(q)}{suffix} TOP {TOP_K}"
                     for q in qs]
            before = dict(tk.LAUNCHES)
            rows, hits = served_part(report, f"served_{name}", router,
                                     lambda: served_run(port, stmts))
            part = {k: v - before.get(k, 0) for k, v in tk.LAUNCHES.items()}
            report[f"launches_served_{name}"] = part
            if on_card:
                require_launches(part, (kernel,), f"12b {name}")
                if name == "pooled":
                    report["profile_served_pooled"] = profile_served(
                        port, stmts, "pooled")
            if name == "binary":
                ref_s, ref_i = (t.cpu().numpy() for t in ref_bits)
                bad = [r for r, hh in enumerate(hits)
                       if rows[r] != [int(k[1:]) for k in bits_index.keys_of(
                           ref_i[r].tolist())]
                       or [h["score"] for h in hh] != ref_s[r].tolist()]
                report["served_binary_mismatches"] = len(bad)
                detail = f"{len(bad)} differ from the plain top-k"
                if bad:
                    raise AssertionError(f"served binary hits differ from "
                                         f"the plain hamming top-k: "
                                         f"{bad[:5]}")
            else:
                report[f"served_{name}_recall"] = recall(rows,
                                                         truth[:N_SERVED])
                detail = f"recall@{TOP_K} {report[f'served_{name}_recall']:.4f}"
                if report[f"served_{name}_recall"] < MIN_RECALL:
                    raise AssertionError(f"served {name} recall below the "
                                         f"limit")
            say(f"[12b] served {name}: p50 "
                f"{report[f'served_{name}_p50_ms']:.3f} ms p99 "
                f"{report[f'served_{name}_p99_ms']:.3f} ms, "
                f"{report[f'served_{name}_qps']:.0f} QPS, "
                f"{report[f'served_{name}_batches']} batches (mean cohort "
                f"{report[f'served_{name}_mean_cohort']:.2f}), {detail}; "
                f"launches {part}")
        # filtered statements: coalesced by filter
        lat, hits, _ = served_run(port, [
            f"SIMILAR {vec_literal(q)} WHERE cat = {FILTER_CAT} TOP {TOP_K}"
            for q in extra])
        rows_f = [[int(h["key"][1:]) for h in hh] for hh in hits]
        report["served_filtered_p50_ms"] = float(np.percentile(lat, 50))
        report["served_filtered_recall"] = recall(rows_f, truth_f)
        off = [r for rr in rows_f for r in rr if r % N_CATS != FILTER_CAT]
        if off or report["served_filtered_recall"] < MIN_RECALL:
            raise AssertionError(f"served filtered SIMILAR: hits outside cat "
                                 f"{FILTER_CAT} {off[:5]} or recall "
                                 f"{report['served_filtered_recall']:.4f}")
        # an `in` filter on a list: the cohort is keyed and served, and
        # the batcher's workers live on
        b = router._batcher_for(DIM)
        reqs = [b.submit(q, TOP_K, FilterCondition("in", "cat",
                                                   list(IN_CATS)))
                for q in extra[:8]]
        for req in reqs:
            if not req.event.wait(300) or req.error is not None:
                raise AssertionError(f"the 'in' cohort failed: {req.error}")
        off = [h.key for req in reqs for h in req.result
               if int(h.key[1:]) % N_CATS not in IN_CATS]
        plain = b.search(qs[0], TOP_K, timeout_s=300)
        if off or len(plain) != TOP_K:
            raise AssertionError(f"'in' cohort hits outside {IN_CATS}: "
                                 f"{off[:5]}, or the next query was not "
                                 f"answered ({plain})")
        report["served_in_filter_ok"] = True
        # REST Points queries: no batcher on this path; the hits are the
        # engine's own for the same query
        lat, rows_p, bad = [], [], []
        for i, q in enumerate(qs[:N_POINTS]):
            ms, status, body = post(port, "/collections/q8/points/query",
                                    json.dumps({"vector": q.tolist(),
                                                "limit": TOP_K}).encode())
            if status != 200 or len(body["result"]) != TOP_K:
                raise AssertionError(f"points query failed: {body}")
            lat.append(ms)
            rows_p.append([int(h["id"][1:]) for h in body["result"]])
            want = router.vector.search_in_collection("q8", q, TOP_K)
            if [(h["id"], h["score"]) for h in body["result"]] != \
                    [(h.key, h.score) for h in want]:
                bad.append(i)
        report["points_query_p50_ms"] = float(np.percentile(lat, 50))
        report["points_query_recall"] = recall(rows_p, truth[:N_POINTS])
        report["points_query_mismatches"] = len(bad)
    report["launches_served_brute"] = dict(tk.LAUNCHES)
    say(f"[12b] served {len(extra)} WHERE cat = {FILTER_CAT}: p50 "
        f"{report['served_filtered_p50_ms']:.3f} ms, recall@{TOP_K} "
        f"{report['served_filtered_recall']:.4f}, every hit in cat "
        f"{FILTER_CAT}; an 'in' {list(IN_CATS)} cohort served, then a plain "
        f"query; {N_POINTS} REST Points queries on q8: p50 "
        f"{report['points_query_p50_ms']:.3f} ms, recall@{TOP_K} "
        f"{report['points_query_recall']:.4f}, {len(bad)} differ from the "
        f"engine's own hits")
    if bad:
        raise AssertionError(f"REST Points hits differ from "
                             f"search_in_collection for queries {bad[:5]}")
    return report


# ---------------------------------------------------------------------------
# phase 19: serving over gRPC (NeumannServer, its clients, the Points
# plane and the gRPC-web gateway) on phase 12's routers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def grpc_serving(router):
    """A ``NeumannServer`` on 127.0.0.1:0 over ``router``, started with
    ``serve()`` as a user starts it: the router's warm-up (a failure
    raises) and batched serving on. Yields (server, its address, the
    warm-up's seconds); stops the server (and the batchers) on the way
    out."""
    from neumann_tpu_torch.server import NeumannServer

    srv = NeumannServer(router, host="127.0.0.1", port=0)
    t0 = time.perf_counter()
    port = srv.serve(warmup=True)
    warm_s = time.perf_counter() - t0
    try:
        yield srv, f"127.0.0.1:{port}", warm_s
    finally:
        srv.stop()


def grpc_clients(addr: str, n: int):
    from neumann_tpu_torch.server import NeumannClient

    return [NeumannClient.connect(addr, retries=0) for _ in range(n)]


def grpc_served_run(clients, stmts):
    """``Execute`` each statement from one thread a client (statement i
    on client i mod len(clients)). Returns the latencies (ms), the hits
    per statement and the wall seconds; fails unless every answer has
    TOP_K finite hits."""
    lat = [0.0] * len(stmts)
    hits = [None] * len(stmts)

    def work(c):
        for i in range(c, len(stmts), len(clients)):
            t0 = time.perf_counter()
            res = clients[c].execute(stmts[i])
            lat[i] = (time.perf_counter() - t0) * 1e3
            hits[i] = res.hits

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(clients)) as ex:
        list(ex.map(work, range(len(clients))))
    wall = time.perf_counter() - t0
    bad = [i for i, hh in enumerate(hits)
           if len(hh) != TOP_K or not all(np.isfinite(h["score"])
                                          for h in hh)]
    if bad:
        raise AssertionError(f"{len(bad)} statements served over gRPC "
                             f"failed: {[(i, hits[i]) for i in bad[:3]]}")
    return lat, hits, wall


def check_health(client, dev, phase: str) -> dict:
    health = client.health()
    if not health["ok"] or health["device"] != dev.type:
        raise AssertionError(f"[{phase}] Health reports {health}, not a "
                             f"{dev.type} device")
    return health


def check_points_codec(on_card: bool) -> bool:
    """Whether the native points codec serves the Points plane; on the
    card it must (the data plane phase 19 measures is the native one)."""
    from neumann_tpu_torch.native import pypoints
    from neumann_tpu_torch.server.server import _PbPointsCodec, _points_codec

    native = _points_codec() is not _PbPointsCodec and \
        pypoints.load() is not None
    if on_card and not native:
        raise AssertionError("[19] the native points codec did not load")
    return native


def serve_grpc_ivf(router, batch, truth, dev, on_card: bool) -> dict:
    """Phase 19a, on A's router after 12a: a ``NeumannServer`` (warm-up,
    batching); N_SERVED ``SIMILAR [...] TOP 10`` through ``Execute``
    from N_CLIENTS threads, a channel each (recall@10 >= MIN_RECALL,
    mean cohort above 1, the card's idle share from a second run under
    torch.profiler); one Points ``QueryBatch`` of the same N_SERVED
    queries (hits equal ``router.vector.batch_search`` on the same
    matrix); ``Health`` reports the device. Launches counted from the
    first served request: rows 1 (the served cohorts) and 2 (the
    QueryBatch) must launch."""
    from neumann_tpu_torch.ops import kernels as tk

    report = {"points_codec_native": check_points_codec(on_card)}
    qs = batch[:N_SERVED]
    stmts = [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in qs]
    t_phase = time.perf_counter()
    with grpc_serving(router) as (srv, addr, warm_s):
        report["grpc_warmup_s"] = warm_s
        clients = grpc_clients(addr, N_CLIENTS)
        try:
            report["grpc_health"] = check_health(clients[0], dev, "19a")
            tk.reset_launch_counts()
            rows, _ = served_part(report, "grpc_ivf", router,
                                  lambda: grpc_served_run(clients, stmts))
            t0 = time.perf_counter()
            got = clients[0].query_points_batch(qs, TOP_K)
            report["grpc_ivf_query_batch_ms"] = \
                (time.perf_counter() - t0) * 1e3
            launches = dict(tk.LAUNCHES)
            want = router.vector.batch_search(qs, TOP_K)
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if [(h["id"], h["score"]) for h in g]
                   != [(h.key, h.score) for h in w]]
            report["grpc_ivf_query_batch_mismatches"] = len(bad)
            if bad or len(got) != len(qs):
                raise AssertionError(f"[19a] QueryBatch hits differ from "
                                     f"batch_search for queries {bad[:5]}")
            if on_card:
                report["grpc_ivf_idle"] = device_idle(
                    lambda: grpc_served_run(clients, stmts), "gRPC ivf")
        finally:
            for c in clients:
                c.close()
        report["grpc_ivf_server_requests"] = srv.metrics["requests"]
    report["phase19a_s"] = time.perf_counter() - t_phase
    report["grpc_ivf_recall"] = recall(rows, truth[:N_SERVED])
    report["launches_served_grpc_ivf"] = launches
    idle = report.get("grpc_ivf_idle", {}).get("device_idle_share")
    say(f"[19a] gRPC server warm-up {warm_s:.3f} s; {len(stmts)} SIMILARs "
        f"through Execute from {N_CLIENTS} channels: p50 "
        f"{report['grpc_ivf_p50_ms']:.3f} ms p99 "
        f"{report['grpc_ivf_p99_ms']:.3f} ms, "
        f"{report['grpc_ivf_qps']:.0f} QPS, {report['grpc_ivf_batches']} "
        f"batches (mean cohort {report['grpc_ivf_mean_cohort']:.2f}), "
        f"recall@{TOP_K} {report['grpc_ivf_recall']:.4f}, device idle "
        f"share {ms_text(idle, 4)}; QueryBatch of {len(qs)} in "
        f"{report['grpc_ivf_query_batch_ms']:.1f} ms, equal to "
        f"batch_search; Health {report['grpc_health']}; native points "
        f"codec {report['points_codec_native']}; launches {launches}")
    if report["grpc_ivf_recall"] < MIN_RECALL:
        raise AssertionError("[19a] recall over gRPC below the limit")
    if on_card:
        require_launches(launches, ("ivf_probe", "batched_probe"), "19a")
    return report


def grpc_web_execute(port: int, query: str):
    """One ``Execute`` as a gRPC-web call (binary frames) to a
    RestServer's port: (ms, hits)."""
    import http.client

    from neumann_tpu_torch.server import neumann_pb2 as pb
    from neumann_tpu_torch.server.grpc_web import decode_frames, encode_frame

    body = encode_frame(0x00, pb.QueryRequest(query=query)
                        .SerializeToString())
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/neumann.QueryService/Execute", body,
                     {"Content-Type": "application/grpc-web+proto"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    ms = (time.perf_counter() - t0) * 1e3
    frames = decode_frames(data)
    if resp.status != 200 or not frames or frames[0][0] != 0x00:
        raise AssertionError(f"[19b] gRPC-web call failed: {resp.status} "
                             f"{data[:200]!r}")
    msg = pb.QueryResponse.FromString(frames[0][1])
    if msg.error:
        raise AssertionError(f"[19b] gRPC-web Execute: {msg.error}")
    return ms, [{"key": h.key, "score": h.score} for h in msg.hits]


def serve_grpc_brute(router, batch, extra, truth, truth_f, ref_bits,
                     bits_index, dev, on_card: bool) -> dict:
    """Phase 19b, on B's router after 12b: a ``NeumannServer``; N_SERVED
    ``SIMILAR [...] TOP 10`` on the default namespace through
    ``Execute`` from N_CLIENTS channels (f32 pooled, row 6; recall@10 >=
    MIN_RECALL); a ``PointsPipeline`` (QueryStream) of the N_SERVED
    queries on q8, answered through the batcher's completion callback
    (int8 pooled, row 5): every future resolves, recall@10 >=
    MIN_RECALL; a Points ``QueryBatch`` of them on bits (row 7): ids and distances equal
    the plain hamming top-k's, in order; N_FILTERED Points queries with
    ``filter_json`` cat = 3 on the default namespace (q8's rows carry no
    metadata): every hit in cat 3, recall against the masked scan; 64
    ``Execute`` over gRPC-web through a ``RestServer(grpc_web=server)``,
    one at a time, each equal to the same statement's hits over gRPC
    sent alone (a cohort of one either way: a cohort's size picks the
    f32 pooled kernel's mode, so hits of near ties may differ between
    cohorts). Rows 5, 6 and 7 must launch."""
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.server import RestServer

    report = {"points_codec_native": check_points_codec(on_card)}
    qs = batch[:N_SERVED]
    stmts = [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in qs]
    t_phase = time.perf_counter()
    with grpc_serving(router) as (srv, addr, warm_s):
        report["grpc_brute_warmup_s"] = warm_s
        clients = grpc_clients(addr, N_CLIENTS)
        try:
            check_health(clients[0], dev, "19b")
            tk.reset_launch_counts()
            rows, _ = served_part(report, "grpc_pooled", router,
                                  lambda: grpc_served_run(clients, stmts))
            report["grpc_pooled_recall"] = recall(rows, truth[:N_SERVED])
            pooled = dict(tk.LAUNCHES)
            # QueryStream on q8: pipelined, answered by callbacks
            before = dict(tk.LAUNCHES)
            b0, s0 = batcher_counts(router)
            t0 = time.perf_counter()
            with clients[1].points_pipeline() as pipe:
                futs = [pipe.search(q, TOP_K, "q8") for q in qs]
                got = [f.result(timeout=300) for f in futs]
            wall = time.perf_counter() - t0
            b1, s1 = batcher_counts(router)
            report["grpc_stream_qps"] = len(qs) / wall
            report["grpc_stream_batches"] = b1 - b0
            report["grpc_stream_mean_cohort"] = (s1 - s0) / max(b1 - b0, 1)
            stream = launches_since(before)
            report["grpc_stream_recall"] = recall(
                [[int(h["id"][1:]) for h in hh] for hh in got],
                truth[:N_SERVED])
            if any(len(hh) != TOP_K for hh in got):
                raise AssertionError("[19b] a QueryStream answer lacks hits")
            # QueryBatch on bits: ids and distances of the plain top-k
            before = dict(tk.LAUNCHES)
            t0 = time.perf_counter()
            got = clients[2].query_points_batch(qs, TOP_K, "bits")
            report["grpc_bits_query_batch_ms"] = \
                (time.perf_counter() - t0) * 1e3
            bits = launches_since(before)
            ref_s, ref_i = (t.cpu().numpy() for t in ref_bits)
            bad = [r for r, hh in enumerate(got)
                   if [h["id"] for h in hh]
                   != bits_index.keys_of(ref_i[r].tolist())
                   or [h["score"] for h in hh] != ref_s[r].tolist()]
            report["grpc_bits_mismatches"] = len(bad)
            if bad or len(got) != len(qs):
                raise AssertionError(f"[19b] QueryBatch on bits differs from "
                                     f"the plain hamming top-k: {bad[:5]}")
            # filtered Points queries, one client each at once: one
            # cohort of the filter
            filt = {"op": "eq", "field": "cat", "value": FILTER_CAT}
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(extra)) as ex:
                got = list(ex.map(
                    lambda i: clients[i].query_points(
                        "", extra[i], TOP_K, filter_json=filt,
                        with_payload=True), range(len(extra))))
            report["grpc_filtered_wall_ms"] = \
                (time.perf_counter() - t0) * 1e3
            off = [h for hh in got for h in hh
                   if int(h["id"][1:]) % N_CATS != FILTER_CAT
                   or h["payload"] != {"cat": FILTER_CAT}]
            report["grpc_filtered_recall"] = recall(
                [[int(h["id"][1:]) for h in hh] for hh in got], truth_f)
            if off or any(len(hh) != TOP_K for hh in got):
                raise AssertionError(f"[19b] filtered Points hits outside cat "
                                     f"{FILTER_CAT}: {off[:3]}")
            # gRPC-web through the REST port, one statement at a time and
            # each also over gRPC: both cohorts of one, the same launch
            web = RestServer(router, grpc_web=srv)
            port = web.serve()
            try:
                lat, diff = [], []
                for i, s in enumerate(stmts[:N_POINTS]):
                    ms, hits = grpc_web_execute(port, s)
                    lat.append(ms)
                    if hits != clients[4].execute(s).hits:
                        diff.append(i)
            finally:
                web.stop()
            report["grpc_web_p50_ms"] = float(np.percentile(lat, 50))
            report["grpc_web_mismatches"] = len(diff)
            if diff:
                raise AssertionError(f"[19b] gRPC-web hits differ from "
                                     f"gRPC's for statements {diff[:5]}")
            launches = dict(tk.LAUNCHES)
            if on_card:
                report["grpc_pooled_idle"] = device_idle(
                    lambda: grpc_served_run(clients, stmts), "gRPC pooled")
        finally:
            for c in clients:
                c.close()
    report["phase19b_s"] = time.perf_counter() - t_phase
    report["launches_served_grpc_brute"] = launches
    idle = report.get("grpc_pooled_idle", {}).get("device_idle_share")
    say(f"[19b] gRPC server warm-up {warm_s:.3f} s; {len(stmts)} SIMILARs "
        f"through Execute: p50 {report['grpc_pooled_p50_ms']:.3f} ms p99 "
        f"{report['grpc_pooled_p99_ms']:.3f} ms, "
        f"{report['grpc_pooled_qps']:.0f} QPS, mean cohort "
        f"{report['grpc_pooled_mean_cohort']:.2f}, recall@{TOP_K} "
        f"{report['grpc_pooled_recall']:.4f}, device idle share "
        f"{ms_text(idle, 4)}, launches {pooled}; QueryStream of "
        f"{len(qs)} on q8: {report['grpc_stream_qps']:.0f} QPS, mean "
        f"cohort {report['grpc_stream_mean_cohort']:.2f}, recall@{TOP_K} "
        f"{report['grpc_stream_recall']:.4f}, launches {stream}; QueryBatch "
        f"of {len(qs)} on bits {report['grpc_bits_query_batch_ms']:.1f} "
        f"ms, equal to the plain top-k, launches {bits}; {len(extra)} "
        f"filtered Points queries at once in "
        f"{report['grpc_filtered_wall_ms']:.0f} ms, all in cat {FILTER_CAT} "
        f"(recall {report['grpc_filtered_recall']:.4f}); {N_POINTS} gRPC-web "
        f"Executes equal to gRPC's, p50 {report['grpc_web_p50_ms']:.3f} ms")
    for name in ("grpc_pooled_recall", "grpc_stream_recall",
                 "grpc_filtered_recall"):
        if report[name] < MIN_RECALL:
            raise AssertionError(f"[19b] {name} {report[name]:.4f} below "
                                 f"the limit")
    if on_card:
        require_launches(pooled, ("f32_pooled_bits",), "19b Execute")
        require_launches(stream, ("int8_pooled_bits",), "19b QueryStream")
        require_launches(bits, ("hamming_topk",), "19b QueryBatch")
    return report


_NUMERAL = re.compile(r"(-?\d+\.\d+(?:[eE][-+]?\d+)?)")


def text_rel_diff(a: str, b: str) -> float:
    """0 for equal text; for text equal but for its decimal numerals, the
    largest relative difference between them; inf otherwise. Table
    borders and runs of blanks are dropped first: a numeral printed one
    digit shorter pads its column by one blank."""
    def cells(text):
        rows = [ln for ln in text.splitlines() if set(ln) - set("+-")]
        return re.sub(r"\s+", " ", "\n".join(rows))

    if a == b:
        return 0.0
    pa, pb = _NUMERAL.split(cells(a)), _NUMERAL.split(cells(b))
    if len(pa) != len(pb) or pa[::2] != pb[::2]:
        return float("inf")
    return max([abs(float(x) - float(y)) / max(abs(float(y)), 1e-30)
                for x, y in zip(pa[1::2], pb[1::2])] + [0.0])


def run_shell(dev) -> dict:
    """Phase 13: samples/knowledge-base.nql statement by statement through
    the port's Shell (plain theme) on a router on ``dev`` and on a CPU
    router: equal text, but that a printed float (6 significant digits)
    may differ within SHELL_RTOL, since the card sums in another order
    (PageRank's scatter adds are atomic); ``doctor`` reports ``dev``'s
    device. Each shell has a ``--wal-dir`` of its own (removed after), so
    the sample's CHECKPOINT answers too: no statement may answer with an
    error."""
    import io
    import shutil
    import tempfile

    import torch

    from neumann_tpu_torch.router import QueryRouter
    from neumann_tpu_torch.shell import Shell
    from neumann_tpu_torch.shell.shell import _split_script

    with open(SAMPLE, encoding="utf-8") as f:
        stmts = _split_script(f.read())
    report, outs = {}, {}
    tmp = tempfile.mkdtemp(prefix="neumann_shell_")
    try:
        for name, d in (("dev", dev), ("cpu", "cpu")):
            sh = Shell(router=QueryRouter(device=d), stdout=io.StringIO(),
                       theme="plain", wal_dir=os.path.join(tmp, name))
            t0 = time.perf_counter()
            outs[name] = [sh.execute(s) for s in stmts]
            report[f"shell_{name}_s"] = time.perf_counter() - t0
            if name == "dev":
                doctor = sh.doctor()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rel = [text_rel_diff(a, b) for a, b in zip(outs["dev"], outs["cpu"])]
    differ = [(stmts[i], outs["dev"][i], outs["cpu"][i])
              for i in range(len(stmts)) if rel[i] > SHELL_RTOL]
    devices = [ln.strip() for ln in doctor.splitlines() if "devices" in ln]
    kind = torch.device(dev).type
    n = torch.cuda.device_count() if kind == "cuda" else 1
    report["shell_statements"] = len(stmts)
    report["shell_exact_differ"] = sum(r > 0 for r in rel)
    report["shell_max_rel_diff"] = max(rel)
    report["shell_errors"] = sum(o.startswith("error:") for o in outs["dev"])
    report["shell_doctor_devices"] = devices
    say(f"[13] shell: {len(stmts)} statements of the sample on {kind} "
        f"({report['shell_dev_s']:.2f} s) and on the CPU "
        f"({report['shell_cpu_s']:.2f} s): {report['shell_exact_differ']} "
        f"outputs differ in text, {len(differ)} beyond a relative "
        f"{SHELL_RTOL} in their numerals (largest "
        f"{report['shell_max_rel_diff']:.2e}); "
        f"{report['shell_errors']} answered with an error; "
        f"doctor: {devices}")
    if differ:
        raise AssertionError(f"shell outputs differ: {differ[:3]}")
    if report["shell_errors"]:
        errors = [o for o in outs["dev"] if o.startswith("error:")]
        raise AssertionError(f"shell statements answered with an error: "
                             f"{errors}")
    if devices != [f"[OK ] devices         {n} x {kind}"]:
        raise AssertionError(f"doctor does not report {n} x {kind}: "
                             f"{devices}")
    return report


# ---------------------------------------------------------------------------
# phase 18: the chain and the cluster
# ---------------------------------------------------------------------------

def chain_hits(router, stmts) -> tuple:
    """SIMILAR statements through the router: ([(key, score), ...] per
    statement, latencies ms)."""
    hits, lat = [], []
    for stmt in stmts:
        t0 = time.perf_counter()
        res = router.execute(stmt)
        lat.append((time.perf_counter() - t0) * 1e3)
        if res.kind != "similar" or len(res.results) != TOP_K:
            raise AssertionError(f"[18] bad SIMILAR result: {res.results}")
        hits.append([(h["key"], h["score"]) for h in res.results])
    return hits, lat


def chain_tx(router, keys, vecs, end: str) -> tuple:
    """BEGIN CHAIN TRANSACTION, EMBED STORE each key's vector, then
    ``end`` (COMMIT CHAIN or ROLLBACK CHAIN): (its message, the EMBEDs'
    seconds, ``end``'s ms)."""
    router.execute("BEGIN CHAIN TRANSACTION")
    t0 = time.perf_counter()
    for key, v in zip(keys, vecs):
        router.execute(f"EMBED STORE '{key}' {vec_literal(v)}")
    embed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    msg = router.execute(end).message
    return msg, embed_s, (time.perf_counter() - t0) * 1e3


def run_chain(args, router, corpus, on_card: bool) -> dict:
    """Phase 18a: chain transactions on a router holding ``corpus`` as
    keys ``k<i>`` in the default namespace at the f32 pooled route (row
    6): phase 16's, after its rollback. ``init_chain``
    at 768 dimensions (its state root seeded from every stored key);
    a transaction re-embeds N_CHAIN_KEYS keys and commits: SIMILARs of
    the new vectors give their own keys first; a second re-embeds the
    same keys and ends in ROLLBACK CHAIN: the SIMILARs give the hits
    they gave before it (keys equal, scores within CHAIN_ATOL). CHAIN
    VERIFY, HEIGHT, TIP, HISTORY, SIMILAR, DRIFT and the codebook
    statements answer; row 6 launches (counted as ``chain``)."""
    from neumann_tpu_torch.ops import kernels as tk

    report = {}
    rng = np.random.default_rng(args.seed + 18)
    rows = rng.choice(len(corpus), N_CHAIN_KEYS, replace=False)
    keys = [f"k{r}" for r in rows]
    fresh = rng.standard_normal((N_CHAIN_KEYS, DIM)).astype(np.float32)
    other = rng.standard_normal((N_CHAIN_KEYS, DIM)).astype(np.float32)
    stmts = [f"SIMILAR {vec_literal(v)} TOP {TOP_K}"
             for v in fresh[:N_CHAIN_SIMILAR]]
    t0 = time.perf_counter()
    router.init_chain(embedding_dim=DIM)
    report["chain_init_s"] = time.perf_counter() - t0
    report["chain_store_keys"] = len(router.store)
    msg, report["chain_embed_s"], report["chain_commit_ms"] = chain_tx(
        router, keys, fresh, "COMMIT CHAIN")
    tk.reset_launch_counts()
    committed, lat_c = chain_hits(router, stmts)
    launches = dict(tk.LAUNCHES)
    firsts = [h[0][0] for h in committed]
    if firsts != keys[:N_CHAIN_SIMILAR]:
        raise AssertionError(f"[18a] committed rows not first: "
                             f"{firsts[:5]} != {keys[:5]}")
    msg2, report["chain_abort_embed_s"], report["chain_rollback_ms"] = \
        chain_tx(router, keys, other, "ROLLBACK CHAIN")
    tk.reset_launch_counts()
    after, lat_r = chain_hits(router, stmts)
    launches = {k: v + tk.LAUNCHES[k] for k, v in launches.items()}
    report["launches_chain"] = launches
    report["chain_first_similar_after_commit_ms"] = lat_c[0]
    report["chain_first_similar_after_rollback_ms"] = lat_r[0]
    report["chain_similar_p50_ms"] = float(np.percentile(lat_c + lat_r, 50))
    bad = same_route_hits(committed, after, CHAIN_ATOL)
    report["chain_rollback_mismatches"] = len(bad)

    # the chain's views
    verify = router.execute("CHAIN VERIFY").message
    height = router.execute("CHAIN HEIGHT").count
    tip = router.execute("CHAIN TIP").rows[0]
    store_key = tip["transactions"][0]["ops"][0]["key"]
    history = router.execute(f"CHAIN HISTORY '{store_key}'").rows
    # a statement-level transaction journals its writes at the store and
    # stages none in the chain's workspace, so its block's delta is zero
    # (as in the JAX router): CHAIN SIMILAR finds no block, DRIFT is 0
    tip_delta = float(np.linalg.norm(tip["delta_embedding"]))
    delta = fresh.sum(0) - corpus[rows].sum(0)
    blocks = router.execute(f"CHAIN SIMILAR {vec_literal(delta)} "
                            f"LIMIT 3").rows
    drift = router.execute("CHAIN DRIFT FROM 0 TO 1").rows[0]
    book = router.execute("SHOW CODEBOOK GLOBAL").rows[0]
    trans = router.execute("ANALYZE CODEBOOK TRANSITIONS").rows[0]
    report["chain_views"] = dict(
        verify=verify, height=height, tip_ops=len(tip["transactions"][0][
            "ops"]), history=len(history), similar_blocks=blocks,
        drift_norm=drift["drift_norm"], tip_delta_norm=tip_delta,
        codebook=book, transitions=trans)
    say(f"[18a] init_chain over {report['chain_store_keys']} keys "
        f"{report['chain_init_s']:.2f} s; {N_CHAIN_KEYS} EMBED STOREs "
        f"{report['chain_embed_s']:.2f} s, {msg} in "
        f"{report['chain_commit_ms']:.2f} ms; {msg2} in "
        f"{report['chain_rollback_ms']:.2f} ms after "
        f"{report['chain_abort_embed_s']:.2f} s of EMBEDs; first SIMILAR "
        f"after commit {lat_c[0]:.2f} ms, after rollback {lat_r[0]:.2f} ms, "
        f"p50 {report['chain_similar_p50_ms']:.3f} ms; statements differing "
        f"after ROLLBACK CHAIN {bad}; views {report['chain_views']}; "
        f"launches {launches}")
    if bad:
        raise AssertionError(f"[18a] ROLLBACK CHAIN changed the hits of "
                             f"statements {bad}")
    if verify != "chain OK" or height != 1 or len(history) != 1 or \
            bool(blocks) != (tip_delta > 0) or book["trained"] or \
            abs(drift["drift_norm"] - tip_delta) > 1e-3 * tip_delta or \
            report["chain_views"]["tip_ops"] != N_CHAIN_KEYS:
        raise AssertionError(f"[18a] chain views: {report['chain_views']}")
    if on_card:
        require_launches(launches, ("f32_pooled_bits",), "18a")
    return report


def consensus_inputs(seed) -> tuple:
    """N_DELTAS deltas of DIM in groups of 8 around a base vector (two
    near-copies with equal key sets, four at noise 1, two free), one in
    97 zero, and key sets of 1-4 keys from a vocabulary of DELTA_VOCAB
    (one in 101 empty): every class occurs."""
    rng = np.random.default_rng(seed)
    n = N_DELTAS
    j = np.arange(n) % 8
    base = rng.standard_normal((n // 8 + 1, DIM)).astype(np.float32)
    noise = rng.standard_normal((n, DIM)).astype(np.float32)
    scale = np.where(j < 2, 0.05, 1.0).astype(np.float32)[:, None]
    deltas = np.where(j[:, None] < 6, base[np.arange(n) // 8]
                      + scale * noise, noise).astype(np.float32)
    deltas[::97] = 0.0
    key_sets = []
    for i in range(n):
        if j[i] == 1:
            key_sets.append(set(key_sets[-1]))
        elif i % 101 == 0:
            key_sets.append(set())
        else:
            key_sets.append({f"key{k}" for k in rng.choice(
                DELTA_VOCAB, int(rng.integers(1, 5)), replace=False)})
    return deltas, key_sets


def pairwise_codes_f64(deltas, key_sets, cfg) -> tuple:
    """The classification of ``pairwise_codes_kernel`` in float64 numpy
    (the key-set intersections as exact f32 counts): (codes int8
    [n, n], pairs whose cosine or Jaccard lies within CONSENSUS_MARGIN
    of a threshold)."""
    d = np.asarray(deltas, np.float64)
    norms = np.linalg.norm(d, axis=1, keepdims=True)
    dn = np.where(norms > 0, d / np.maximum(norms, 1e-300), 0.0)
    cos = dn @ dn.T
    vocab = {k: i for i, k in enumerate(sorted({k for s in key_sets
                                                for k in s}))}
    inc = np.zeros((len(key_sets), max(len(vocab), 1)), np.float32)
    for i, s in enumerate(key_sets):
        inc[i, [vocab[k] for k in s]] = 1.0
    inter = (inc @ inc.T).astype(np.float64)
    sizes = inc.sum(1).astype(np.float64)
    union = sizes[:, None] + sizes[None, :] - inter
    jac = np.where(union > 0, inter / np.maximum(union, 1.0), 1.0)
    eq = (inter >= sizes[:, None]) & (inter >= sizes[None, :])
    codes = np.where(
        jac > cfg.jaccard_conflict,
        np.where(eq & (cos >= cfg.identical_threshold), 0,
                 np.where(cos >= cfg.similar_threshold, 1, 3)),
        np.where(np.abs(cos) <= cfg.orthogonal_threshold, 2,
                 np.where(cos >= cfg.similar_threshold, 1, 2))
    ).astype(np.int8)
    m = CONSENSUS_MARGIN
    near = ((np.abs(cos - cfg.identical_threshold) < m)
            | (np.abs(cos - cfg.similar_threshold) < m)
            | (np.abs(np.abs(cos) - cfg.orthogonal_threshold) < m)
            | ((np.abs(jac - cfg.jaccard_conflict) < m)
               & (jac != cfg.jaccard_conflict)))
    return codes, near


def run_consensus(dev, seed, on_card: bool) -> dict:
    """Phase 18b: ``classify_pairwise_codes`` over N_DELTAS deltas on the
    card, held to a float64 classification (equal codes but for pairs
    within CONSENSUS_MARGIN of a threshold, counted); the card time of
    its device function (``pairwise_codes_kernel``) by CUDA events, its
    launches from torch.profiler, and its bound: the f32 products at
    the FFMA peak against the inputs read and the int8 [n, n] written."""
    import torch

    from neumann_tpu_torch.chain.consensus import (
        ConsensusConfig,
        classify_pairwise_codes,
        pairwise_codes_kernel,
    )

    cfg = ConsensusConfig()
    deltas, key_sets = consensus_inputs(seed)
    t0 = time.perf_counter()
    codes = classify_pairwise_codes(deltas, key_sets, cfg, device=dev)
    call_ms = (time.perf_counter() - t0) * 1e3
    want, near = pairwise_codes_f64(deltas, key_sets, cfg)
    off = (codes != want) & ~near
    counts = np.bincount(codes.ravel().astype(np.int64), minlength=4)
    report = {"consensus_pairs": int(codes.size),
              "consensus_class_counts": counts.tolist(),
              "consensus_near_threshold_pairs": int(near.sum()),
              "consensus_near_threshold_differ": int(
                  ((codes != want) & near).sum()),
              "consensus_mismatches": int(off.sum()),
              "consensus_call_ms": call_ms}
    n = len(key_sets)
    vocab = {k for s in key_sets for k in s}
    d = torch.from_numpy(deltas).to(dev)
    inc = np.zeros((n, len(vocab)), np.float32)
    index = {k: i for i, k in enumerate(sorted(vocab))}
    for i, s in enumerate(key_sets):
        inc[i, [index[k] for k in s]] = 1.0
    a = torch.from_numpy(inc).to(dev)

    def step():
        return pairwise_codes_kernel(
            d, a, cfg.identical_threshold, cfg.similar_threshold,
            cfg.orthogonal_threshold, cfg.jaccard_conflict)

    if not np.array_equal(step().cpu().numpy(), codes):
        raise AssertionError("[18b] pairwise_codes_kernel differs from "
                             "classify_pairwise_codes")
    if on_card:
        rec = torch_step(step, 10, "pairwise_codes_kernel")
        flops = 2.0 * n * n * (DIM + len(vocab))
        rec.update(bound(nbytes(d, a) + n * n, flops, F32_FLOPS_PER_S))
        rec["shape"] = f"{n} deltas x {DIM}, {len(vocab)} keys"
        report["consensus_kernel"] = rec
    say(f"[18b] classify_pairwise_codes over {n} deltas x {DIM} on "
        f"{dev}: {call_ms:.1f} ms the call; classes {counts.tolist()} "
        f"(identical, similar, orthogonal, conflicting); "
        f"{report['consensus_mismatches']} pairs differ from float64 off "
        f"the thresholds, {report['consensus_near_threshold_pairs']} lie "
        f"within {CONSENSUS_MARGIN} of one "
        f"({report['consensus_near_threshold_differ']} of them differ); "
        f"device function {report.get('consensus_kernel')}")
    if report["consensus_mismatches"] or not counts.all():
        raise AssertionError(f"[18b] codes differ from float64 on "
                             f"{report['consensus_mismatches']} pairs, "
                             f"classes {counts.tolist()}")
    return report


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def embed_batches(vecs: np.ndarray, coll: str) -> list:
    """(keys, ``EMBED BATCH … IN coll`` statement) of CLUSTER_BATCH_ROWS
    rows each; key ``r<i>`` holds row i."""
    out = []
    for s in range(0, len(vecs), CLUSTER_BATCH_ROWS):
        keys = [f"r{i}" for i in range(s, min(len(vecs),
                                               s + CLUSTER_BATCH_ROWS))]
        out.append((keys, "EMBED BATCH [" + ", ".join(
            f"('{k}', {vec_literal(vecs[int(k[1:])])})" for k in keys)
            + f"] IN {coll}"))
    return out


def cluster_load(addrs: list, batches: list, clients: int,
                 during=None) -> dict:
    """Execute every statement through ClusterClients, ``clients`` at
    once, each retried on the next node of ``addrs`` until acknowledged
    (a reply after the leader applied it) or CLUSTER_DEADLINE_S pass.
    ``addrs`` is shared: ``during(acked rows)`` runs on the caller's
    thread every 0.2 s and may change it (empty: wait). Returns
    acknowledged keys, seconds and retries."""
    import queue
    import threading

    from neumann_tpu_torch.chain.node import ClusterClient
    from neumann_tpu_torch.utils.errors import ChainError

    work = queue.Queue()
    for b in batches:
        work.put(b)
    acked, errors = [], []
    state = {"retries": 0}
    lock = threading.Lock()
    deadline = time.time() + CLUSTER_DEADLINE_S

    def worker(w: int) -> None:
        cc, i = None, w
        try:
            while True:
                try:
                    keys, stmt = work.get_nowait()
                except queue.Empty:
                    return
                while True:
                    if time.time() > deadline:
                        raise AssertionError(f"[18] a write was never "
                                             f"acknowledged: {keys}")
                    try:
                        if cc is None:
                            live = list(addrs)
                            if not live:        # no leader known yet
                                time.sleep(0.2)
                                continue
                            cc = ClusterClient(live[i % len(live)])
                        cc.execute(stmt, timeout=CLUSTER_WRITE_TIMEOUT_S)
                        break
                    except (ChainError, OSError):
                        with lock:
                            state["retries"] += 1
                        if cc is not None:
                            cc.close()
                        cc, i = None, i + 1
                        time.sleep(0.2)
                with lock:
                    acked.extend(keys)
        except Exception as e:  # noqa: BLE001 (raised by the caller)
            errors.append(e)
        finally:
            if cc is not None:
                cc.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(clients)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        if during is not None:
            with lock:
                n = len(acked)
            during(n)
        for t in threads:
            t.join(timeout=0.2 / len(threads))
    if errors:
        raise errors[0]
    return {"acked": acked, "load_s": time.perf_counter() - t0,
            "retries": state["retries"]}


def cluster_reads(addr, keys, vecs, coll: str) -> dict:
    """SIMILAR of each key's vector IN ``coll`` through a ClusterClient to
    the node at ``addr``: keys whose own key is not first, and
    latencies ms."""
    from neumann_tpu_torch.chain.node import ClusterClient

    cc = ClusterClient(addr)
    lost, lat = [], []
    try:
        for k in keys:
            t0 = time.perf_counter()
            res = cc.execute(f"SIMILAR {vec_literal(vecs[int(k[1:])])} IN "
                             f"{coll} TOP {TOP_K}", timeout=CLUSTER_TIMEOUT_S)
            lat.append((time.perf_counter() - t0) * 1e3)
            hits = res.get("hits") or []
            if not hits or hits[0]["key"] != k:
                lost.append(k)
        explain = cc.execute(f"EXPLAIN SIMILAR {vec_literal(vecs[0])} IN "
                             f"{coll} TOP {TOP_K}")["rows"][0]["detail"]
    finally:
        cc.close()
    m = re.search(r"\(kernel (\w+)\)", explain)
    return {"lost": lost, "lat": lat, "kernel": m.group(1) if m else None}


def collection_count(addr, coll: str) -> int:
    from neumann_tpu_torch.chain.node import ClusterClient

    cc = ClusterClient(addr)
    try:
        rows = cc.execute("SHOW COLLECTIONS",
                          timeout=CLUSTER_TIMEOUT_S)["rows"]
    finally:
        cc.close()
    return next((r["count"] for r in rows if r["name"] == coll), -1)


def wait_counts(addrs, coll: str, n: int, what: str) -> float:
    """Seconds until every node at ``addrs`` holds n rows in ``coll``."""
    from neumann_tpu_torch.utils.errors import ChainError

    t0 = time.perf_counter()
    while True:
        try:
            counts = [collection_count(a, coll) for a in addrs]
        except (ChainError, OSError):   # a node still starting
            counts = [-1]
        if min(counts) >= n:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > CLUSTER_DEADLINE_S:
            raise AssertionError(f"[18] {what}: {counts} of {n} rows after "
                                 f"{CLUSTER_DEADLINE_S} s")
        time.sleep(0.25)


def run_cluster(dev, vecs: np.ndarray, on_card: bool) -> dict:
    """Phase 18c: three TcpClusterNodes in this process over localhost
    sockets, each router on ``dev``. A replicated CREATE COLLECTION …
    QUANTIZATION int8 and EMBED BATCH … IN statements load ``vecs``
    through the leader (every row through Raft), CLUSTER_CLIENTS
    ClusterClients at once; then on every replica N_CLUSTER_SIMILAR
    SIMILARs of loaded rows give their own keys first, each replica's
    counted apart: row 4 (the int8 scan) launches on each."""
    from neumann_tpu_torch.chain.node import ClusterClient, TcpClusterNode
    from neumann_tpu_torch.chain.raft import RaftConfig
    from neumann_tpu_torch.ops import kernels as tk

    report = {}
    ids = ("c0", "c1", "c2")
    # the node CLI's Raft settings and 50 ms tick: heartbeats 150 ms
    # apart (a 30 ms heartbeat resends each pending batch of statements,
    # up to 64 of 16 KB, before its ack is back: the leader then spends
    # its loop compressing frames and the load stalls)
    nodes = {nid: TcpClusterNode(nid, {}, port=0, config=RaftConfig(),
                                 seed=i, device=dev.type)
             for i, nid in enumerate(ids)}
    addrs = {nid: n.address for nid, n in nodes.items()}
    try:
        for nid, n in nodes.items():
            n._peer_addrs = {p: addrs[p] for p in ids if p != nid}
            n.raft.voters = set(ids)
            n.start()
        t0 = time.perf_counter()
        while not any(n.is_leader() for n in nodes.values()):
            if time.perf_counter() - t0 > 60:
                raise AssertionError("[18c] no leader elected in 60 s")
            time.sleep(0.05)
        leader = next(nid for nid, n in nodes.items() if n.is_leader())
        report["cluster_elect_s"] = time.perf_counter() - t0
        cc = ClusterClient(addrs[leader])
        try:
            cc.execute(f"CREATE COLLECTION cl DIM {DIM} QUANTIZATION int8",
                       timeout=CLUSTER_TIMEOUT_S)
        finally:
            cc.close()
        load = cluster_load([addrs[leader]], embed_batches(vecs, "cl"),
                            CLUSTER_CLIENTS)
        report["cluster_load_s"] = load["load_s"]
        report["cluster_acked_rows"] = len(load["acked"])
        report["cluster_rows_per_s"] = len(load["acked"]) / load["load_s"]
        report["cluster_retries"] = load["retries"]
        report["cluster_replicas_s"] = wait_counts(
            list(addrs.values()), "cl", len(vecs), "18c replicas")
        keys = [f"r{i}" for i in range(0, len(vecs),
                                       max(1, len(vecs)
                                           // N_CLUSTER_SIMILAR))]
        keys = keys[:N_CLUSTER_SIMILAR]
        per = {}
        for nid in ids:
            tk.reset_launch_counts()
            got = cluster_reads(addrs[nid], keys, vecs, "cl")
            per[nid] = dict(lost=got["lost"], kernel=got["kernel"],
                            p50_ms=float(np.percentile(got["lat"], 50)),
                            launches=dict(tk.LAUNCHES))
        report["cluster_replicas"] = per
        report["launches_cluster"] = {
            k: sum(p["launches"][k] for p in per.values())
            for k in tk.LAUNCHES}
    finally:
        for n in nodes.values():
            n.stop()
    say(f"[18c] 3 nodes in one process (routers on {dev}): leader "
        f"{leader} in {report['cluster_elect_s']:.2f} s; {len(vecs)} rows "
        f"in EMBED BATCHes of {CLUSTER_BATCH_ROWS} (the Python parser on "
        f"the native lexer's tokens) acknowledged in "
        f"{report['cluster_load_s']:.1f} s "
        f"({report['cluster_rows_per_s']:.1f} rows/s, "
        f"{CLUSTER_CLIENTS} clients, {report['cluster_retries']} retries), "
        f"every replica whole {report['cluster_replicas_s']:.2f} s later; "
        f"reads by replica {per}")
    bad = {nid: p["lost"] for nid, p in per.items() if p["lost"]}
    if bad:
        raise AssertionError(f"[18c] own keys not first on replicas: {bad}")
    if on_card:
        for nid, p in per.items():
            require_launches(p["launches"], ("int8_dot_scores",),
                             f"18c {nid}")
    return report


class NodeProcess:
    """A ``python -m neumann_tpu_torch.chain.node`` process of this
    checkout, its output in ``log_dir``."""

    def __init__(self, nid: str, port: int, peers: str, wal_dir: str,
                 device: str, log_dir: str):
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        self.nid = nid
        self.args = [sys.executable, "-m", "neumann_tpu_torch.chain.node",
                     "--id", nid, "--port", str(port), "--peers", peers,
                     "--wal-dir", wal_dir, "--device", device]
        self.log_path = os.path.join(log_dir, f"node_{nid}.log")
        self.env, self.cwd = env, root
        self.proc = None
        self.start()

    def start(self) -> None:
        with open(self.log_path, "a") as log:
            self.proc = subprocess.Popen(
                self.args, cwd=self.cwd, env=self.env, stdout=log,
                stderr=subprocess.STDOUT)

    def state(self) -> Optional[str]:
        with open(self.log_path) as f:
            found = re.findall(r"state=(\w+)", f.read())
        return found[-1] if found else None

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


def run_cluster_processes(dev, vecs: np.ndarray, on_card: bool) -> dict:
    """Phase 18d: three node processes on the one card (``--wal-dir``
    each); CLUSTER_CLIENTS ClusterClients load ``vecs`` by acknowledged
    EMBED BATCHes through the leader (the node a status line names:
    statements a follower forwards stall the leader, ROADMAP §2 tuning
    item 10); the leader is SIGKILLed when half the rows are
    acknowledged, and the clients move to the node elected after it.
    Every acknowledged key is then read back by
    SIMILAR, its own key first, from both surviving nodes; the killed
    node, restarted from its WAL dir, catches up and answers the same.
    EXPLAIN SIMILAR … IN on each node names row 4's kernel (the node
    processes' launch counts are out of this script's reach)."""
    report = {}
    ids = ("p0", "p1", "p2")
    ports = free_ports(3)
    addrs = {nid: ("127.0.0.1", ports[i]) for i, nid in enumerate(ids)}
    work = tempfile.mkdtemp(prefix="neumann_cluster_")
    log_dir = "chiprun_out" if on_card else work
    os.makedirs(log_dir, exist_ok=True)
    procs = {}
    try:
        for i, nid in enumerate(ids):
            peers = ",".join(f"{p}=127.0.0.1:{ports[j]}"
                             for j, p in enumerate(ids) if p != nid)
            procs[nid] = NodeProcess(nid, ports[i], peers,
                                     os.path.join(work, nid), dev.type,
                                     log_dir)
        t0 = time.perf_counter()
        while True:
            states = {nid: p.state() for nid, p in procs.items()}
            if "leader" in states.values():
                break
            dead = [nid for nid, p in procs.items()
                    if p.proc.poll() is not None]
            if dead or time.perf_counter() - t0 > 120:
                raise AssertionError(f"[18d] no leader: states {states}, "
                                     f"exited {dead}")
            time.sleep(0.25)
        report["cluster_proc_start_s"] = time.perf_counter() - t0
        from neumann_tpu_torch.chain.node import ClusterClient

        first = next(n for n, s in states.items() if s == "leader")
        cc = ClusterClient(addrs[first])
        try:
            cc.execute(f"CREATE COLLECTION cl DIM {DIM} QUANTIZATION int8",
                       timeout=CLUSTER_TIMEOUT_S)
        finally:
            cc.close()
        live = [addrs[first]]
        killed = {}

        def kill_leader(n_acked: int) -> None:
            if not killed and n_acked >= len(vecs) // 2:
                procs[first].kill()
                live.clear()
                killed.update(nid=first, at_rows=n_acked,
                              t=time.perf_counter())
            elif killed and not live:
                new = [nid for nid in ids if nid != first
                       and procs[nid].state() == "leader"]
                if new:
                    live.append(addrs[new[0]])
                    killed["new_leader_s"] = (time.perf_counter()
                                              - killed["t"])

        load = cluster_load(live, embed_batches(vecs, "cl"),
                            CLUSTER_CLIENTS, during=kill_leader)
        if not killed:
            raise AssertionError("[18d] the leader was never killed")
        acked = sorted(set(load["acked"]), key=lambda k: int(k[1:]))
        report.update(cluster_kill_load_s=load["load_s"],
                      cluster_kill_acked_rows=len(acked),
                      cluster_kill_rows_per_s=len(acked) / load["load_s"],
                      cluster_kill_retries=load["retries"],
                      cluster_killed=killed["nid"],
                      cluster_killed_at_rows=killed["at_rows"],
                      cluster_new_leader_s=killed.get("new_leader_s"))
        survivors = [nid for nid in ids if nid != killed["nid"]]
        report["cluster_survivors_whole_s"] = wait_counts(
            [addrs[n] for n in survivors], "cl", len(acked),
            "18d survivors")
        reads = {}
        with ThreadPoolExecutor(len(survivors)) as pool:
            for nid, got in zip(survivors, pool.map(
                    lambda n: cluster_reads(addrs[n], acked, vecs, "cl"),
                    survivors)):
                reads[nid] = got
        t0 = time.perf_counter()
        procs[killed["nid"]].start()
        report["cluster_restart_catchup_s"] = wait_counts(
            [addrs[killed["nid"]]], "cl", len(acked), "18d restarted node")
        reads[killed["nid"]] = cluster_reads(addrs[killed["nid"]], acked,
                                             vecs, "cl")
        report["cluster_restart_s"] = time.perf_counter() - t0
        report["cluster_kill_reads"] = {
            nid: dict(lost=len(r["lost"]), kernel=r["kernel"],
                      p50_ms=float(np.percentile(r["lat"], 50)))
            for nid, r in reads.items()}
    finally:
        for p in procs.values():
            p.stop()
        shutil.rmtree(work, ignore_errors=True)
    say(f"[18d] 3 node processes (routers on {dev.type}) up in "
        f"{report['cluster_proc_start_s']:.1f} s; {len(acked)} rows "
        f"acknowledged in {report['cluster_kill_load_s']:.1f} s "
        f"({report['cluster_kill_rows_per_s']:.1f} rows/s, "
        f"{report['cluster_kill_retries']} retries), leader "
        f"{killed['nid']} SIGKILLed at {killed['at_rows']} rows, a new "
        f"leader named {killed.get('new_leader_s')} s later; "
        f"survivors whole {report['cluster_survivors_whole_s']:.2f} s after"
        f" the load; the restarted node caught up in "
        f"{report['cluster_restart_catchup_s']:.1f} s; reads "
        f"{report['cluster_kill_reads']}")
    lost = {nid: r["lost"][:5] for nid, r in reads.items() if r["lost"]}
    if lost or len(acked) != len(vecs):
        raise AssertionError(f"[18d] acknowledged keys lost: {lost}, "
                             f"{len(acked)} of {len(vecs)} acknowledged")
    wrong = {nid: r["kernel"] for nid, r in reads.items()
             if r["kernel"] != "int8_dot_scores"}
    if wrong:
        raise AssertionError(f"[18d] EXPLAIN names another kernel: {wrong}")
    return report


# the shard server of phase 20: ``python -c _SHARD_WORKER PREFIX --device
# DEV`` serves PREFIX.rows.npy (memory-mapped) under the keys k<id> of
# PREFIX.ids.npy; it prints ``READY <port>`` once warm with its launch
# counts at 0, the counts as one JSON line for each line read from stdin,
# and once more when stdin closes, then exits. Its other output goes to
# stderr.
_SHARD_WORKER = r"""
import json, os, sys
proto = os.fdopen(os.dup(1), "w")
os.dup2(2, 1)
import numpy as np
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.router import QueryRouter
from neumann_tpu_torch.server.server import NeumannServer

prefix, device = sys.argv[1], sys.argv[sys.argv.index("--device") + 1]
rows = np.load(prefix + ".rows.npy", mmap_mode="r")
ids = np.load(prefix + ".ids.npy")
router = QueryRouter(device=device)
router.vector.ingest_matrix([f"k{i}" for i in ids.tolist()], rows)
srv = NeumannServer(router, host="127.0.0.1", port=0, device=device)
port = srv.serve(warmup=True)
tk.reset_launch_counts()
print(f"READY {port}", file=proto, flush=True)
for _ in sys.stdin:
    print(json.dumps(dict(tk.LAUNCHES)), file=proto, flush=True)
print(json.dumps(dict(tk.LAUNCHES)), file=proto, flush=True)
srv.stop()
"""


class ShardServer:
    """A ``NeumannServer`` process of this checkout serving one shard's
    rows (``_SHARD_WORKER``); its stderr in ``log_path``."""

    def __init__(self, prefix: str, device: str, log_path: str):
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        self.log_path = log_path
        with open(log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _SHARD_WORKER, prefix, "--device",
                 device], cwd=root, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=log, bufsize=0)
        self._buf = b""

    def line(self, deadline: float) -> str:
        """The next line of its output, or an error naming its log when it
        exits or the deadline passes first."""
        import select

        fd = self.proc.stdout.fileno()
        while b"\n" not in self._buf:
            left = deadline - time.perf_counter()
            ready = select.select([fd], [], [], max(left, 0))[0] if \
                left > 0 else []
            chunk = os.read(fd, 1 << 16) if ready else b""
            if not chunk:
                with open(self.log_path) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(
                    f"[20] shard server {self.log_path} "
                    f"{'exited' if ready else 'timed out'} "
                    f"(rc {self.proc.poll()}): {tail}")
            self._buf += chunk
        out, _, self._buf = self._buf.partition(b"\n")
        return out.decode()

    def counts(self, timeout: float = 60.0) -> dict:
        self.proc.stdin.write(b"\n")
        self.proc.stdin.flush()
        return json.loads(self.line(time.perf_counter() + timeout))

    def close(self, timeout: float = 60.0) -> dict:
        """Close its stdin: its last launch counts, then its exit."""
        self.proc.stdin.close()
        counts = json.loads(self.line(time.perf_counter() + timeout))
        self.proc.wait(timeout=timeout)
        return counts

    def kill(self) -> None:
        """SIGKILL it if it still runs, and close its pipes."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self.proc.stdin.close()
        self.proc.stdout.close()


def shard_executor(client, calls: list):
    """The planner's executor for one shard server: its ``Execute`` answer
    as a ``QueryResult``; each call's host milliseconds go to ``calls``."""
    from neumann_tpu_torch.router import QueryResult

    def run(query: str):
        t0 = time.perf_counter()
        r = client.execute(query)
        calls.append((time.perf_counter() - t0) * 1e3)
        return QueryResult(kind=r.kind, message=r.message, rows=r.rows,
                           count=r.count, results=r.hits, value=r.value)
    return run


def split_fanned(report: dict, prefix: str, lat, calls: dict) -> None:
    """Where a fanned-out statement's time went: each shard's call p50,
    and the p50 of what the coordinator spent around the calls (each
    statement asked every shard once, in order), the first statement
    apart as ``latency_stats`` keeps it."""
    report[f"{prefix}_call_p50_ms"] = {
        nm: float(np.percentile(c[1:], 50)) for nm, c in calls.items()}
    own = np.asarray(lat[1:]) - np.sum([c[1:] for c in calls.values()],
                                       axis=0)
    report[f"{prefix}_coordinator_p50_ms"] = float(np.percentile(own, 50))
    for c in calls.values():
        c.clear()


def shard_merge(clients, names, stmt: str) -> tuple:
    """The top TOP_K of the named shards' own answers to ``stmt``, asked
    of each directly, merged as ``ResultMerger`` merges them (by score,
    ties in shard order): (row ids, scores) as ``similar_series`` gives
    them."""
    hits = [h for n in names for h in clients[n].execute(stmt).hits]
    hits.sort(key=lambda h: -h["score"])
    return ([int(h["key"][1:]) for h in hits[:TOP_K]],
            [h["score"] for h in hits[:TOP_K]])


def run_sharded(dev, corpus, queries, oracle, seed: int, on_card: bool,
                beside: dict) -> dict:
    """Phase 20 (cell P): scatter-gather SIMILAR over SHARD_SERVERS shard
    servers on the one card, each holding the rows of ``corpus`` that a
    ``SemanticPartitioner`` trained on PARTITION_SAMPLE of them assigns
    it; the coordinator is a ``QueryRouter`` on ``dev`` whose planner
    (``attach_planner``) fans statements out over ``NeumannClient``
    connections. ``oracle``: the exact f32 top-10 rows of ``queries``
    over all of ``corpus`` (phase 7's). ``beside``: B's single-process
    numbers from this call, recorded next to P's."""
    from neumann_tpu_torch.parallel import SemanticPartitioner
    from neumann_tpu_torch.parallel.distributed import QueryPlanner
    from neumann_tpu_torch.router import QueryRouter
    from neumann_tpu_torch.server import NeumannClient

    t_phase = time.perf_counter()
    n = len(corpus)
    report = {}
    names = [f"s{i}" for i in range(SHARD_SERVERS)]
    t0 = time.perf_counter()
    sample = corpus[np.sort(np.random.default_rng(seed).choice(
        n, min(PARTITION_SAMPLE, n), replace=False))]
    part = SemanticPartitioner(SHARD_SERVERS, device=dev)
    part.train(sample, iters=PARTITION_ITERS)
    report["sharded_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    owner = part.assign_batch(corpus)
    sizes = np.bincount(owner, minlength=SHARD_SERVERS)
    report["sharded_assign_s"] = time.perf_counter() - t0
    report["sharded_sizes"] = sizes.tolist()
    pooled_min = int(os.environ.get("NEUMANN_POOLED_MIN_ROWS", 1 << 18))
    work = tempfile.mkdtemp(prefix="neumann_shards_")
    log_dir = "chiprun_out" if on_card else work
    servers, clients = {}, {}
    try:
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            ids = np.flatnonzero(owner == i)
            np.save(os.path.join(work, f"{name}.ids.npy"), ids)
            np.save(os.path.join(work, f"{name}.rows.npy"), corpus[ids])
        report["sharded_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name in names:
            servers[name] = ShardServer(os.path.join(work, name), dev.type,
                                        os.path.join(log_dir,
                                                     f"shard_{name}.log"))
        for name in names:
            ready = servers[name].line(t0 + SHARD_START_S)
            if not ready.startswith("READY "):
                raise AssertionError(f"[20] shard {name} said {ready!r}")
            clients[name] = NeumannClient.connect(
                f"127.0.0.1:{int(ready.split()[1])}", retries=0)
        report["sharded_start_s"] = time.perf_counter() - t0
        say(f"[20] {SHARD_SERVERS} shard servers of {sizes.tolist()} rows "
            f"up in {report['sharded_start_s']:.1f} s (partitioner trained "
            f"on {len(sample)} rows in {report['sharded_train_s']:.2f} s, "
            f"{n} rows assigned in {report['sharded_assign_s']:.2f} s, "
            f"written in {report['sharded_write_s']:.1f} s)")
        calls = {nm: [] for nm in names}
        executors = {nm: shard_executor(c, calls[nm])
                     for nm, c in clients.items()}
        router = QueryRouter(device=dev)
        full = QueryPlanner("coordinator", names)
        semantic = QueryPlanner("coordinator", names, semantic=part)
        single = queries[:N_SINGLE]
        stmts = [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in single]

        # ---- 20a: full fan-out, each merge held to the shards' own ------
        router.attach_planner(full, executors)
        lat, rows, scores = similar_series(router, stmts)
        latency_stats(report, "sharded", lat)
        split_fanned(report, "sharded", lat, calls)
        bad = [i for i, stmt in enumerate(stmts)
               if shard_merge(clients, names, stmt) != (rows[i], scores[i])]
        report["sharded_mismatches"] = len(bad)
        report["sharded_recall"] = recall(rows, oracle[:N_SINGLE])
        say(f"[20a] full fan-out: p50 {report['sharded_p50_ms']:.3f} ms p99 "
            f"{report['sharded_p99_ms']:.3f} ms (B in one process: p50 "
            f"{beside['pooled_single_p50_ms']:.3f} ms; each shard's call "
            f"p50 {report['sharded_call_p50_ms']}, the coordinator's own "
            f"{report['sharded_coordinator_p50_ms']:.3f} ms); recall@{TOP_K} "
            f"{report['sharded_recall']:.4f} against the exact scan of all "
            f"{n} rows; {len(bad)} of {len(stmts)} merges differ from the "
            f"shards' own")
        if bad:
            raise AssertionError(f"[20a] merged hits differ from the shards' "
                                 f"own merge for queries {bad[:5]}")
        if report["sharded_recall"] < MIN_RECALL:
            raise AssertionError("[20a] recall below the limit")

        # ---- 20b: semantic routing at nprobe 1..SHARD_SERVERS -----------
        for nprobe in range(1, SHARD_SERVERS + 1):
            router.attach_planner(semantic, executors, nprobe=nprobe)
            lat_n, rows_n, scores_n = similar_series(router, stmts)
            latency_stats(report, f"sharded_nprobe{nprobe}", lat_n)
            report[f"sharded_nprobe{nprobe}_recall"] = recall(
                rows_n, oracle[:N_SINGLE])
            if nprobe == SHARD_SERVERS:
                differ = sum(a != b for a, b in zip(
                    zip(rows_n, scores_n), zip(rows, scores)))
                report["sharded_nprobe_all_mismatches"] = differ
                split_fanned(report, f"sharded_nprobe{nprobe}", lat_n,
                             calls)
            for c in calls.values():
                c.clear()
        say("[20b] semantic routing: " + "; ".join(
            f"nprobe {p} p50 {report[f'sharded_nprobe{p}_p50_ms']:.3f} ms "
            f"recall@{TOP_K} {report[f'sharded_nprobe{p}_recall']:.4f}"
            for p in range(1, SHARD_SERVERS + 1))
            + f"; nprobe {SHARD_SERVERS}: "
            f"{report['sharded_nprobe_all_mismatches']} queries differ from "
            f"the full fan-out, each shard's call p50 "
            f"{report[f'sharded_nprobe{SHARD_SERVERS}_call_p50_ms']}, the "
            f"coordinator's own "
            f"{report[f'sharded_nprobe{SHARD_SERVERS}_coordinator_p50_ms']:.3f}"
            f" ms")
        if report["sharded_nprobe_all_mismatches"]:
            raise AssertionError(f"[20b] nprobe {SHARD_SERVERS} hits differ "
                                 f"from the full fan-out's")

        # ---- 20c: throughput from N_CLIENTS threads ---------------------
        router.attach_planner(full, executors)
        batch = queries[N_SINGLE:N_SINGLE + N_SERVED]
        served = [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in batch]
        got = [None] * len(served)

        def work_thread(c):
            for i in range(c, len(served), N_CLIENTS):
                got[i] = similar_series(router, served[i:i + 1])[1][0]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CLIENTS) as ex:
            list(ex.map(work_thread, range(N_CLIENTS)))
        wall = time.perf_counter() - t0
        report["sharded_qps"] = len(served) / wall
        report["sharded_served_call_p50_ms"] = {
            nm: float(np.percentile(c, 50)) for nm, c in calls.items()}
        report["sharded_served_recall"] = recall(
            got, oracle[N_SINGLE:N_SINGLE + len(served)])
        # ---- 20d: an aggregate through the planner ----------------------
        report["sharded_count"] = router.execute("COUNT EMBEDDINGS").count
        say(f"[20c] {len(served)} statements from {N_CLIENTS} threads: "
            f"{report['sharded_qps']:.1f} QPS (B over gRPC in one process, "
            f"19b: {beside.get('grpc_pooled_qps')} QPS; each shard's call "
            f"p50 {report['sharded_served_call_p50_ms']}), recall@{TOP_K} "
            f"{report['sharded_served_recall']:.4f}; [20d] COUNT EMBEDDINGS "
            f"{report['sharded_count']}")
        if report["sharded_count"] != n:
            raise AssertionError(f"[20d] COUNT EMBEDDINGS gave "
                                 f"{report['sharded_count']}, not {n}")

        # each shard's route, and its launch counts before the SIGKILL
        explained, counts = {}, {}
        for name in names:
            detail = clients[name].execute(f"EXPLAIN {stmts[0]}").rows[0][
                "detail"]
            m = re.search(r"\(kernel (\w+)\)", detail)
            explained[name] = m.group(1) if m else detail
        victim = names[-1]
        counts[victim] = servers[victim].counts()

        # ---- 20e: one shard SIGKILLed -----------------------------------
        servers[victim].kill()
        live = names[:-1]
        extra = queries[N_SINGLE + N_BATCH:][:N_DEGRADED]
        degraded = [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in extra]
        lat_d, rows_d, scores_d = similar_series(router, degraded)
        bad_d = [i for i, stmt in enumerate(degraded)
                 if shard_merge(clients, live, stmt) != (rows_d[i],
                                                          scores_d[i])]
        report["sharded_degraded_p50_ms"] = float(np.percentile(lat_d, 50))
        report["sharded_degraded_mismatches"] = len(bad_d)
        for name in live:
            counts[name] = servers[name].close()
        report["sharded_explain"] = explained
        report["sharded_launches"] = counts
        report["launches_sharded"] = {
            k: sum(c.get(k, 0) for c in counts.values()) for k in counts[
                victim]}
        say(f"[20e] {victim} SIGKILLed: {len(degraded)} SIMILARs answered, "
            f"p50 {report['sharded_degraded_p50_ms']:.3f} ms, {len(bad_d)} "
            f"differ from the live shards' own merge; EXPLAIN by shard "
            f"{explained}; f32_pooled_bits launches by shard "
            + str({nm: c["f32_pooled_bits"] for nm, c in counts.items()}))
        if bad_d:
            raise AssertionError(f"[20e] degraded hits differ from the live "
                                 f"shards' merge for queries {bad_d[:5]}")
        for i, name in enumerate(names):
            pooled = sizes[i] >= pooled_min
            launched = counts[name]["f32_pooled_bits"]
            if not pooled:
                say(f"[20] shard {name} holds {sizes[i]} rows, below the "
                    f"pooled route's {pooled_min}: it takes the exact scan")
            if on_card and (pooled != (launched > 0) or pooled != (
                    explained[name] == "f32_pooled_bits")):
                raise AssertionError(
                    f"[20] shard {name} of {sizes[i]} rows: EXPLAIN names "
                    f"{explained[name]}, f32_pooled_bits launched {launched}"
                    f" times")
    finally:
        for c in clients.values():
            c.close()
        for srv in servers.values():
            srv.kill()
        shutil.rmtree(work, ignore_errors=True)
    report["phase20_s"] = time.perf_counter() - t_phase
    say(f"[20] phase 20 took {report['phase20_s']:.1f} s")
    return report


def exact_mismatches(rows, scores, o_ids, o_scores, tol: float) -> list:
    """(query, rank) where a hit list departs from the exact scan's: a
    score more than ``tol`` from the scan's at that rank, or another id
    where the scan's score stands more than ``tol`` from every other of
    its top-(k + 1)."""
    bad = []
    for r, (got, sc) in enumerate(zip(rows, scores)):
        want, ws = o_ids[r], o_scores[r]
        for j in range(len(got)):
            if abs(sc[j] - ws[j]) > tol:
                bad.append((r, j, "score"))
            elif got[j] != want[j] and (np.abs(np.delete(ws, j) - ws[j])
                                        > tol).all():
                bad.append((r, j, "id"))
    return bad


def ivf_placement_exact(ivf, queries: np.ndarray, k: int) -> np.ndarray:
    """The exact top-k of a ShardedIVFCorpus under its own scoring: every
    stored int8 row times its multiplier (the unit row its rerank
    scores) against the normalized f32 query, on each shard, merged in
    shard order. Returns ids into the rows the placement was loaded
    with (-1 where fewer)."""
    import torch

    from neumann_tpu_torch.ops.scan import _topk_stable, host_pull
    from neumann_tpu_torch.parallel import sharded_search as tss

    q = np.zeros((len(queries), ivf.dim_pad), np.float32)
    q[:, :queries.shape[1]] = queries
    parts_s, parts_p = [], []
    for shard, (buf, rm) in enumerate(zip(ivf.corpus, ivf.rmult)):
        qd = torch.from_numpy(q).to(buf.device)
        qn = qd / qd.norm(dim=1, keepdim=True).clamp_min(1e-30)
        sc = torch.cat([
            qn @ (buf[r0:r0 + (1 << 16)].float()
                  * rm[r0:r0 + (1 << 16), None]).T
            for r0 in range(0, len(buf), 1 << 16)], dim=1)
        sc = sc.masked_fill((rm <= 0)[None, :], float("-inf"))
        s_k, pos = _topk_stable(sc, min(k, sc.shape[1]))
        parts_s.append(s_k)
        parts_p.append(torch.where(torch.isneginf(s_k), -1,
                                   pos + shard * ivf.rows_s))
        del sc
    s, gpos = host_pull(*tss._merge_gathered(parts_s, parts_p, k,
                                             ivf.devices[0]))
    return ivf._host_ids(s, gpos)[1]


def mesh_kernel_check(rec: dict, name: str, sfx: str, fn, plain, a: tuple,
                      ops: float, reps: int, bytes_of=None) -> None:
    """A kernel launched by a shard (its captured inputs ``a``) against
    its plain version, bit for bit; CUDA-event times and the bound into
    ``rec`` under ``sfx``. The bound's bytes are ``bytes_of(got)``, by
    default every tensor input and the output once."""
    import torch

    got, want = fn(*a), plain(*a)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"[21] {name}{sfx}: "
                             f"{int((got != want).sum())} values differ "
                             f"from plain (must be bit-exact)")
    if bytes_of is None:
        n_bytes = nbytes(*[x for x in a if torch.is_tensor(x)], got)
    else:
        n_bytes = bytes_of(got)
    for k, v in bound(n_bytes, ops, INT8_OPS_PER_S).items():
        rec[f"{k}{sfx}"] = v
    rec[f"max_abs_err{sfx}"] = 0.0
    rec[f"ms{sfx}"] = cuda_ms(lambda: fn(*a), reps)
    rec[f"plain_ms{sfx}"] = cuda_ms(lambda: plain(*a), 1, warm=False)
    rec[f"shape{sfx}"] = ", ".join(
        "x".join(map(str, x.shape)) if torch.is_tensor(x) else str(x)
        for x in a)


def run_mesh(args, dev, corpus, queries, on_card: bool, beside: dict,
             router=None) -> dict:
    """Phase 21 (cell M): phase 7's rows on a mesh of MESH_SHARDS logical
    devices of one card, SIMILAR through ``router.execute`` served by the
    engine's mesh placements (``ShardedCorpus`` f32 and int8,
    ``ShardedIVFCorpus``). ``beside``: B's numbers from this call on the
    same rows, recorded next to M's. The variable that makes the logical
    devices is set for this phase alone. ``router``: phases 7-9's router,
    which holds ``corpus`` as this phase loads it (the default namespace
    ``{"cat": i % 16}`` and the ``q8`` collection); without it the phase
    loads a router of its own. The engine places its rows on the mesh at
    the first search with the variable set."""
    import torch

    from neumann_tpu_torch.engines.vector import FilterCondition
    from neumann_tpu_torch.ops import ivf as tivf
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.scan import _topk_stable, topk_scan
    from neumann_tpu_torch.parallel import mesh as tmesh
    from neumann_tpu_torch.parallel import sharded_search as tss
    from neumann_tpu_torch.router import QueryRouter

    t_phase = time.perf_counter()
    n = len(corpus)
    report = {}
    single = queries[:N_SINGLE]
    batch = queries[N_SINGLE:N_SINGLE + MESH_BATCH]
    extra = queries[N_SINGLE + N_BATCH:]
    saved_env = os.environ.get(tmesh.MESH_DEVICES_ENV)
    os.environ[tmesh.MESH_DEVICES_ENV] = str(MESH_SHARDS)
    try:
        loaded = router is not None
        if not loaded:
            router = QueryRouter(device=dev)
        eng = router.vector
        # the engine reads its mesh once; phases 7-9's router read it
        # before the variable was set
        eng._mesh_cache = "unset"
        # the default mesh_threshold (262,144) on the card; the CPU
        # rehearsal's rows are fewer
        eng.config.mesh_threshold = min(eng.config.mesh_threshold, n)
        ivf_threshold = eng.config.ivf_auto_threshold
        if ivf_threshold <= n:
            raise AssertionError(f"[21] parts a-d need fewer rows than "
                                 f"ivf_auto_threshold ({ivf_threshold})")
        t0 = time.perf_counter()
        if not loaded:
            with eng.bulk_ingest():
                for i in range(n):
                    eng.store_embedding(f"k{i}", corpus[i],
                                        {"cat": i % N_CATS})
            router.execute(f"CREATE COLLECTION q8 DIM {DIM} "
                           f"QUANTIZATION int8")
            with eng.bulk_ingest():
                for i in range(n):
                    eng.store_in_collection("q8", f"k{i}", corpus[i])
        report["mesh_ingest_s"] = None if loaded else \
            time.perf_counter() - t0
        base = eng._corpora[""][DIM]
        q8 = eng._corpora["col/q8"][DIM]
        # the exact f32 scans of all rows (k + 1: the gap past the k-th)
        emb, valid = base.slab.device_view()
        qd = torch.from_numpy(queries).to(dev)
        cat_rows = base.filter_mask(FilterCondition.eq("cat", FILTER_CAT))
        o_s, o_i = (t.cpu().numpy() for t in topk_scan(
            emb, qd, TOP_K + 1, "cosine", valid))
        o_f = topk_scan(emb, qd[N_SINGLE + N_BATCH:], TOP_K, "cosine",
                        valid & torch.from_numpy(cat_rows).to(dev)
                        )[1].cpu().numpy()
        o_e = topk_scan(emb, qd[N_SINGLE + N_BATCH:], TOP_K, "euclidean",
                        valid)[1].cpu().numpy()
        del emb, valid
        say(f"[21] {n} rows with metadata and an int8 collection of them "
            + ("on phases 7-9's router" if loaded else
               f"stored in {report['mesh_ingest_s']:.1f} s")
            + f"; mesh of {MESH_SHARDS} logical devices: {eng._mesh()}")

        stmts = [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in single]
        fresh_keys = (np.arange(MESH_FRESH) * (n // MESH_FRESH) + 7)
        fresh = np.random.default_rng(args.seed + 21).standard_normal(
            (MESH_FRESH, DIM)).astype(np.float32)
        fresh_stmts = [f"SIMILAR {vec_literal(v)} TOP {TOP_K}"
                       for v in fresh]
        tk.reset_launch_counts()
        # ---- 21a: f32 ShardedCorpus (every shard's exact scan) ---------
        lat, rows_a, sc_a = similar_series(router, stmts)
        latency_stats(report, "mesh_f32_single", lat)
        report["mesh_f32_batch_qps"], report["mesh_f32_batch_s"], \
            rows_ab, sc_ab = batch_series(lambda: eng.batch_search(
                batch, TOP_K))
        placed_f32 = base._sharded[1]
        # ---- 21b: int8 ShardedCorpus, cosine (row 5, the rerank) ----------
        lat, rows_b, _ = similar_series(router, [
            f"SIMILAR {vec_literal(q)} IN q8 TOP {TOP_K}" for q in single])
        latency_stats(report, "mesh_int8_single", lat)
        report["mesh_int8_batch_qps"], report["mesh_int8_batch_s"], \
            rows_bb, _ = batch_series(lambda: eng.batch_search_ns(
                batch, TOP_K, ns="col/q8"))
        # ---- 21c: int8, euclidean (row 4, the rerank) --------------------
        lat, rows_c, _ = similar_series(router, [
            f"SIMILAR {vec_literal(q)} IN q8 METRIC euclidean TOP {TOP_K}"
            for q in extra], cosine=False)
        latency_stats(report, "mesh_euclid", lat)
        # ---- 21d: WHERE cat = 3 on the f32 placement -------------------
        lat, rows_d, _ = similar_series(router, [
            f"SIMILAR {vec_literal(q)} WHERE cat = {FILTER_CAT} TOP {TOP_K}"
            for q in extra])
        latency_stats(report, "mesh_filtered", lat)
        # ---- 21e: the sharded IVF placement ------------------------------
        eng.config.ivf_auto_threshold = n
        t0 = time.perf_counter()
        similar_series(router, stmts[:1])
        report["mesh_ivf_first_query_s"] = time.perf_counter() - t0
        ivf = base._sharded_ivf[1]
        lat, rows_e, _ = similar_series(router, stmts)
        latency_stats(report, "mesh_ivf_single", lat)
        report["mesh_ivf_batch_qps"], report["mesh_ivf_batch_s"], \
            rows_eb, _ = batch_series(lambda: eng.batch_search(batch, TOP_K))
        # ---- 21f: re-embedded keys, served through the delta rescans ----
        for key, v in zip(fresh_keys, fresh):
            router.execute(f"EMBED STORE 'k{key}' {vec_literal(v)}")
        _, rows_fi, _ = similar_series(router, fresh_stmts)
        eng.config.ivf_auto_threshold = ivf_threshold
        _, rows_ff, _ = similar_series(router, fresh_stmts)
        rebuilt = (base._sharded[1] is not placed_f32
                   or base._sharded_ivf[1] is not ivf)
        # ---- 21g: ShardedIVFCorpus.search_batched on the placement, on
        # stored rows (each must find itself first, as the graft entry
        # asserts) ------------------------------------------------------
        ivf_rows = base._sharded_ivf[2]
        g_pick = np.linspace(0, len(ivf_rows) - 1, MESH_BATCH).astype(
            np.int64)
        g_queries = corpus[ivf_rows[g_pick]]
        got_g = {}
        for fast in (True, False):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                got_g[fast] = ivf.search_batched(g_queries, TOP_K, fast=fast)
                times.append((time.perf_counter() - t0) * 1e3)
            report[f"mesh_ivf_batched_{'fast' if fast else 'non_fast'}"
                   f"_ms"] = float(np.median(times))
        launches = dict(tk.LAUNCHES)
        report["launches_mesh"] = launches
        report["mesh_s"] = time.perf_counter() - t_phase
        # the fast form again through the batched probe's plain version:
        # the kernel is bit-exact, so the hits must be the same
        saved = tivf.batched_probe
        tivf.batched_probe = tk.batched_probe_plain
        try:
            plain_g = ivf.search_batched(g_queries, TOP_K, fast=True)
        finally:
            tivf.batched_probe = saved

        # ---- gates -------------------------------------------------------
        shards = {"f32": placed_f32.n_shards,
                  "int8": q8._sharded[1].n_shards, "ivf": ivf.n_shards}
        report["mesh_shards"] = shards
        report["mesh_f32_mismatches"] = len(
            exact_mismatches(rows_a, sc_a, o_i[:N_SINGLE], o_s[:N_SINGLE],
                             MESH_TOL)
            + exact_mismatches(rows_ab, sc_ab, o_i[N_SINGLE:N_SINGLE
                                                   + MESH_BATCH],
                               o_s[N_SINGLE:N_SINGLE + MESH_BATCH],
                               MESH_TOL))
        o10 = o_i[:, :TOP_K]
        for name, got, truth in (
                ("int8_recall_single", rows_b, o10[:N_SINGLE]),
                ("int8_recall_batch", rows_bb,
                 o10[N_SINGLE:N_SINGLE + MESH_BATCH]),
                ("euclid_recall", rows_c, o_e),
                ("filtered_recall", rows_d, o_f),
                ("ivf_recall_single", rows_e, o10[:N_SINGLE]),
                ("ivf_recall_batch", rows_eb,
                 o10[N_SINGLE:N_SINGLE + MESH_BATCH])):
            report[f"mesh_{name}"] = recall(got, truth)
        off_cat = [r for rr in rows_d for r in rr if r % N_CATS != FILTER_CAT]
        stale = {"ivf": int(sum(r[0] != k
                                for r, k in zip(rows_fi, fresh_keys))),
                 "f32": int(sum(r[0] != k
                                for r, k in zip(rows_ff, fresh_keys)))}
        report["mesh_fresh_not_first"] = stale
        ss, is_ = ivf.search(g_queries, TOP_K)
        g_bad = {"search_self": int((is_[:, 0] != g_pick).sum()),
                 "fast_plain": int((got_g[True][1] != plain_g[1]).sum()
                                   + (got_g[True][0] != plain_g[0]).sum())}
        for fast, (sg, ig) in got_g.items():
            g_bad["fast" if fast else "non_fast"] = int(
                ((ig[:, 0] != is_[:, 0])
                 | (np.abs(sg[:, 0] - ss[:, 0]) > MESH_TOL)).sum())
        # the IVF route against the exact scan of its own placement
        own = ivf_rows[np.maximum(ivf_placement_exact(
            ivf, np.concatenate([single, batch]), TOP_K), 0)]
        report["mesh_ivf_recall_own_single"] = recall(rows_e,
                                                      own[:N_SINGLE])
        report["mesh_ivf_recall_own_batch"] = recall(rows_eb,
                                                     own[N_SINGLE:])
        report["mesh_ivf_batched_top1_mismatches"] = g_bad
        say(f"[21] mesh of {MESH_SHARDS} on one card ({shards} shards): "
            f"f32 single p50 {report['mesh_f32_single_p50_ms']:.3f} ms p99 "
            f"{report['mesh_f32_single_p99_ms']:.3f} ms, batch "
            f"{report['mesh_f32_batch_qps']:.0f} QPS, "
            f"{report['mesh_f32_mismatches']} departures from the exact "
            f"scan (B in one process: p50 "
            f"{beside.get('pooled_single_p50_ms')} ms, batch "
            f"{beside.get('pooled_batch_qps')} QPS); int8 p50 "
            f"{report['mesh_int8_single_p50_ms']:.3f} ms, batch "
            f"{report['mesh_int8_batch_qps']:.0f} QPS, recall "
            f"{report['mesh_int8_recall_single']:.4f} / "
            f"{report['mesh_int8_recall_batch']:.4f} (C: p50 "
            f"{beside.get('int8_single_p50_ms')} ms); euclidean p50 "
            f"{report['mesh_euclid_p50_ms']:.3f} ms recall "
            f"{report['mesh_euclid_recall']:.4f}; filtered p50 "
            f"{report['mesh_filtered_p50_ms']:.3f} ms recall "
            f"{report['mesh_filtered_recall']:.4f}; IVF: first query "
            f"(build) {report['mesh_ivf_first_query_s']:.2f} s, p50 "
            f"{report['mesh_ivf_single_p50_ms']:.3f} ms p99 "
            f"{report['mesh_ivf_single_p99_ms']:.3f} ms, batch "
            f"{report['mesh_ivf_batch_qps']:.0f} QPS, recall "
            f"{report['mesh_ivf_recall_single']:.4f} / "
            f"{report['mesh_ivf_recall_batch']:.4f}, against the exact scan "
            f"of the placement's own rows "
            f"{report['mesh_ivf_recall_own_single']:.4f} / "
            f"{report['mesh_ivf_recall_own_batch']:.4f} (window {ivf.window}, "
            f"{ivf.c_per} windows a shard, nprobe {ivf.nprobe}); "
            f"on {MESH_BATCH} stored rows search_batched fast "
            f"{report['mesh_ivf_batched_fast_ms']:.1f} ms, non-fast "
            f"{report['mesh_ivf_batched_non_fast_ms']:.1f} ms; departures "
            f"of search's top-1 from the row itself, of the batched forms' "
            f"from search's and of the fast form's hits from its run "
            f"through the plain batched probe: {g_bad}; re-embedded keys "
            f"not first "
            f"{stale}, placements rebuilt: {rebuilt}; launches {launches}")
        if set(shards.values()) != {MESH_SHARDS}:
            raise AssertionError(f"[21] placements of {shards} shards")
        if report["mesh_f32_mismatches"]:
            raise AssertionError("[21a] hits depart from the exact scan")
        if min(report[f"mesh_{k}"] for k in (
                "int8_recall_single", "int8_recall_batch", "euclid_recall",
                "filtered_recall", "ivf_recall_own_single",
                "ivf_recall_own_batch")) < MIN_RECALL or min(
                report["mesh_ivf_recall_single"],
                report["mesh_ivf_recall_batch"]) < MESH_IVF_MIN_RECALL:
            raise AssertionError("[21] recall below the limit")
        if off_cat:
            raise AssertionError(f"[21d] hits outside cat {FILTER_CAT}: "
                                 f"{off_cat[:5]}")
        if any(stale.values()) or rebuilt:
            raise AssertionError(f"[21f] re-embedded keys not first "
                                 f"({stale}) or a placement rebuilt "
                                 f"({rebuilt})")
        if (g_bad["non_fast"] or g_bad["fast_plain"]
                or g_bad["search_self"] > (1 - MESH_SELF_MIN) * MESH_BATCH
                or g_bad["fast"] > (1 - MESH_FAST_MIN_AGREE) * MESH_BATCH):
            raise AssertionError(f"[21g] departures beyond the limits: "
                                 f"{g_bad}")
        if on_card:
            require_launches(launches, ("batched_probe", "int8_dot_scores",
                                        "int8_pooled_bits"), "21")

        # ---- the merge: the shards' own answers in shard order ----------
        dup = np.concatenate([single[:8], single[:8],
                              corpus[np.arange(MESH_SHARDS) * (n // MESH_SHARDS)
                                     + 3]])
        merge_bad = mesh_merge_mismatches(placed_f32, dup, repeated=8)
        rng = np.random.default_rng(args.seed + 22)
        small = rng.standard_normal(
            (MESH_SHARDS * MESH_COPY_ROWS, DIM)).astype(np.float32)
        src = rng.choice(len(small) // 2, 16, replace=False)
        small[src + len(small) // 2] = small[src]
        for quantized in (False, True):
            sc = tss.ShardedCorpus(placed_f32.mesh, DIM, quantized=quantized)
            sc.load(small)
            merge_bad += mesh_merge_mismatches(sc, small[src])
            _, ids = sc.search(small[src], 2)
            merge_bad += int((ids[:, 0] != src).sum()
                             + (ids[:, 1] != src + len(small) // 2).sum())
        report["mesh_merge_mismatches"] = merge_bad
        say(f"[21] merge against the shards' own answers concatenated in "
            f"shard order (repeated queries, stored rows, rows copied "
            f"across shards): {merge_bad} mismatches")
        if merge_bad:
            raise AssertionError("[21] the merge departs from the shards' "
                                 "own answers")

        # ---- rows 2, 4 and 5 at the shards' launches ---------------------
        if on_card:
            recs = {}
            with captured(tk, "int8_pooled_bits") as seen:
                router.execute(f"SIMILAR {vec_literal(single[0])} IN q8 "
                               f"TOP {TOP_K}")
                eng.batch_search_ns(batch, TOP_K, ns="col/q8")
            rec = recs.setdefault("int8_pooled_bits", {})
            for sfx, (a, kw) in (("_mesh_q1", seen[0]),
                                 ("_mesh", seen[MESH_SHARDS])):
                q, nr = a[3].shape[0], a[0].shape[0]
                mesh_kernel_check(rec, "int8_pooled_bits", sfx,
                                  tk.int8_pooled_bits,
                                  tk.int8_pooled_bits_plain, a,
                                  2 * q * nr * DIM, 5)
            with captured(tk, "int8_dot_scores") as seen:
                router.execute(f"SIMILAR {vec_literal(extra[0])} IN q8 "
                               f"METRIC euclidean TOP {TOP_K}")
            a, _ = seen[0]
            mesh_kernel_check(recs.setdefault("int8_dot_scores", {}),
                              "int8_dot_scores", "_mesh_q1",
                              tk.int8_dot_scores,
                              tk.int8_dot_scores_plain, a,
                              2 * a[2].shape[0] * a[0].shape[0] * DIM, 20)
            with captured(tivf, "batched_probe") as seen:
                ivf.search_batched(g_queries, TOP_K, fast=True)
            a, kw = seen[0]
            if not kw.get("top2"):
                raise AssertionError("[21g] the fast form ran the top-1 "
                                     "mode")
            buf, rm2, _, scm, window = a
            filled = int((scm != 0).sum())
            mesh_kernel_check(
                recs.setdefault("batched_probe", {}), "batched_probe",
                "_mesh",
                functools.partial(tk.batched_probe, top2=True),
                functools.partial(tk.batched_probe_plain, top2=True), a,
                2 * filled * window * DIM, 10,
                bytes_of=lambda got: probe_table_bytes(buf, rm2, scm, got,
                                                       filled))
            report["mesh_kernels"] = recs
            say("[21] at the shards' launches, bit for bit: " + "; ".join(
                f"{name}{sfx} ({rec[f'shape{sfx}']}) kernel "
                f"{rec[f'ms{sfx}']:.4f} ms, plain {rec[f'plain_ms{sfx}']:.4f}"
                f" ms, bound {rec[f'bound_ms{sfx}']:.4f} ms "
                f"({rec[f'bound_by{sfx}']})"
                for name, rec in recs.items()
                for sfx in ("_mesh", "_mesh_q1") if f"ms{sfx}" in rec))
        del router, eng, base, q8, ivf, placed_f32
    finally:
        if saved_env is None:
            os.environ.pop(tmesh.MESH_DEVICES_ENV, None)
        else:
            os.environ[tmesh.MESH_DEVICES_ENV] = saved_env
    report["phase21_s"] = time.perf_counter() - t_phase
    say(f"[21] phase 21 took {report['phase21_s']:.1f} s (counted part "
        f"{report['mesh_s']:.1f} s)")
    return report


def mesh_merge_mismatches(sc, q: np.ndarray, repeated: int = 0) -> int:
    """Queries whose merged top-k (``make_sharded_topk`` over the mesh of
    ``sc``) departs from each shard's own top-k (the same function over
    that shard alone), ids made global, concatenated in shard order and
    cut by ``_topk_stable``; plus, of the first 2 x ``repeated`` queries
    (the first ``repeated`` twice), those whose hits differ."""
    import torch

    from neumann_tpu_torch.ops.scan import _topk_stable
    from neumann_tpu_torch.parallel.mesh import Mesh
    from neumann_tpu_torch.parallel.sharded_search import make_sharded_topk

    qd = torch.zeros((len(q), sc.dim_pad), device=sc.devices[0])
    qd[:, :q.shape[1]] = torch.from_numpy(q).to(qd.device)

    def call(mesh, shards):
        def pick(xs):
            return [xs[j] for j in shards]
        fn = make_sharded_topk(mesh, TOP_K, quantized=sc.quantized)
        if sc.quantized:
            return fn(pick(sc.corpus), pick(sc.scale), pick(sc.sqnorm), qd,
                      pick(sc.mask))
        return fn(pick(sc.corpus), qd, pick(sc.mask))

    s, i = call(sc.mesh, range(sc.n_shards))
    parts_s, parts_i = [], []
    for j, dev in enumerate(sc.devices):
        one = np.empty(1, dtype=object)
        one[0] = dev
        ps, pi = call(Mesh(one, ("shard",)), [j])
        rows = len(sc.corpus[j])
        parts_s.append(ps.to(qd.device))
        parts_i.append(torch.where(pi >= 0, pi + j * rows, -1).to(qd.device))
    want_s, pos = _topk_stable(torch.cat(parts_s, dim=1), s.shape[1])
    want_i = torch.gather(torch.cat(parts_i, dim=1), 1, pos)
    bad = int(((s != want_s) | (i != want_i)).any(dim=1).sum())
    if repeated:
        bad += int((i[:repeated] != i[repeated:2 * repeated]).any(dim=1)
                   .sum())
    return bad


def run_chain_cluster(args, dev, centres, s_consensus, s_cluster,
                      on_card: bool) -> dict:
    """Phases 18b-18d (18a runs at the end of phases 7-9)."""
    report = {}
    t0 = time.perf_counter()
    report.update(run_consensus(dev, s_consensus, on_card))
    vecs = mixture(CLUSTER_ROWS, centres, s_cluster)
    report.update(run_cluster(dev, vecs, on_card))
    report.update(run_cluster_processes(dev, vecs, on_card))
    report["phase18bcd_s"] = time.perf_counter() - t0
    return report


def host_top(scores: np.ndarray, k: int):
    """(scores, slots) of each row's k best, ordered on the host apart
    from the port's selections: descending in the IEEE total order of
    the f32 bits (a negative zero below zero, as ``lax.top_k``), equal
    scores by ascending slot (``np.lexsort``)."""
    scores = np.ascontiguousarray(scores, np.float32)
    b = scores.view(np.int32)
    img = np.where(b < 0, b ^ 0x7FFFFFFF, b).astype(np.int64)
    n = scores.shape[1]
    k = min(k, n)
    slots = np.empty((len(scores), k), np.int64)
    for r in range(len(scores)):
        kth = np.partition(img[r], n - k)[n - k]
        cand = np.nonzero(img[r] >= kth)[0]
        slots[r] = cand[np.lexsort((cand, -img[r][cand]))[:k]]
    return np.take_along_axis(scores, slots, 1), slots


def tie_plain(eng, ns: str, q: np.ndarray, k: int, metric: str = "cosine",
              cat_mask=None, one_by_one: bool = True,
              straddles=None) -> list:
    """Phase 22's plain version of one route's hit keys a query: the
    route's first pass again (its kernel, on the card), the rerank's
    scores by plain torch ops over the same candidates, or the exact
    scan's by ``score_all`` over the scan's blocks; then ``host_top``'s
    order on the host (equal scores by ascending slot: the first pass's
    order, or the row). ``one_by_one``: each query alone, as the single
    SIMILARs ran (the same shapes, so the same sums); else the batch.
    ``straddles`` gets the count of queries whose k-th and (k + 1)-th
    scores are equal."""
    import torch

    from neumann_tpu_torch.ops.quant import f32_pooled_topk, int8_pooled_topk
    from neumann_tpu_torch.ops.scan import (
        _DEFAULT_BLOCK_ROWS,
        _FLAT_MAX_ROWS,
        NEG_INF,
        score_all,
    )

    if one_by_one and len(q) > 1:
        return [hits for i in range(len(q))
                for hits in tie_plain(eng, ns, q[i:i + 1], k, metric,
                                      cat_mask, straddles=straddles)]
    qd = torch.from_numpy(np.ascontiguousarray(q)).to(eng.device)

    quant = "int8" if ns.startswith("col/") else "none"
    route = eng.search_route(ns, DIM, k, metric, None, quant)
    if cat_mask is not None:
        assert route["route"] in ("int8_pooled", "f32_pooled"), route
    corpus = eng._corpus_for(ns, DIM, False)
    mask = None if cat_mask is None else torch.from_numpy(cat_mask).to(
        qd.device)
    if route["route"] == "exact":
        emb, valid = corpus.slab.device_view()
        step = len(emb) if len(emb) <= _FLAT_MAX_ROWS else \
            _DEFAULT_BLOCK_ROWS
        scores = torch.cat(
            [score_all(emb[r:r + step], qd, metric, valid[r:r + step])
             for r in range(0, len(emb), step)], dim=1)
        cand = None
    else:
        c = max(8 * k, 64)
        if route["route"] == "int8_pooled":
            data, scale, rmult, valid = corpus.slab.quantized_view("int8c")
            live = valid if mask is None else valid & mask
            s1, pos = int8_pooled_topk(data, scale, qd, c,
                                       pool=route["pool"], mask=live,
                                       row_mult=rmult)
        else:
            data, rmult, valid = corpus.slab.quantized_view("f32c")
            live = valid if mask is None else valid & mask
            s1, pos = f32_pooled_topk(data, qd, c, pool=route["pool"],
                                      mask=live, row_mult=rmult)
        safe = pos.long().clamp_min(0)
        rows = data[safe].float()
        dots = torch.einsum("qcd,qd->qc", rows, qd)
        qn = torch.sqrt((qd * qd).sum(-1, keepdim=True).clamp_min(1e-60))
        if route["route"] == "int8_pooled":
            scores = dots * rmult[safe] / qn
        else:
            cn2 = (rows * rows).sum(-1)
            scores = torch.where(
                cn2 > 0, dots * torch.rsqrt(cn2.clamp_min(1e-60)) / qn,
                torch.zeros_like(dots))
        scores = scores.masked_fill((pos < 0) | torch.isneginf(s1), NEG_INF)
        cand = safe.cpu().numpy()
    s, slots = host_top(scores.cpu().numpy(), k + 1)
    if straddles is not None and s.shape[1] > k:
        straddles.append(int((s[:, k - 1] == s[:, k]).sum()))
    s, slots = s[:, :k], slots[:, :k]
    rows = slots if cand is None else np.take_along_axis(cand, slots, 1)
    rows = np.where(np.isneginf(s), -1, rows)
    return [[key for key in corpus.index.keys_of(r.tolist())
             if key is not None] for r in rows]


def run_ties(dev, corpus, queries, on_card: bool) -> dict:
    """Phase 22 (module docstring): equal scores on the pooled f32 and
    int8 routes, their filtered and batched forms, the exact scan and
    paginated walks, held to ``tie_plain``."""
    from neumann_tpu_torch.engines.vector import FilterCondition
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.router import QueryRouter

    t_phase = time.perf_counter()
    report = {}
    base = corpus[:min(TIE_ROWS, len(corpus))]
    n = len(base) * TIE_COPIES
    n8 = min(TIE_INT8_ROWS, len(base)) * TIE_COPIES
    router = QueryRouter(device=dev)
    eng = router.vector
    t0 = time.perf_counter()
    eng.ingest_matrix([f"k{i}" for i in range(n)],
                      np.tile(base, (TIE_COPIES, 1)), copy=False)
    report["ties_ingest_s"] = time.perf_counter() - t0
    router.execute(f"CREATE COLLECTION tq8 DIM {DIM} QUANTIZATION int8")
    t0 = time.perf_counter()
    with eng.bulk_ingest():
        for i in range(n8):
            eng.store_in_collection("tq8", f"k{i}", base[i % (n8 // 4)],
                                    {"cat": i % N_CATS})
    report["ties_int8_ingest_s"] = time.perf_counter() - t0
    run_router = QueryRouter(device=dev)
    run_eng = run_router.vector
    run_base = base[:TIE_RUN_ROWS]
    n_run = len(run_base) * TIE_COPIES
    t0 = time.perf_counter()
    run_eng.ingest_matrix([f"k{i}" for i in range(n_run)],
                          np.repeat(run_base, TIE_COPIES, axis=0))
    report["ties_run_ingest_s"] = time.perf_counter() - t0
    single = queries[:N_SINGLE]
    batch = queries[N_SINGLE:N_SINGLE + N_BATCH]
    extra = queries[N_SINGLE + N_BATCH:][:max(TIE_FILTERED, TIE_WALKS)]
    cond = FilterCondition.eq("cat", FILTER_CAT)
    walk_k = TOP_K * TIE_PAGES

    def keys(hits):
        return [h.key for h in hits]

    tk.reset_launch_counts()
    got = {
        "f32_single": [keys(eng.search_similar(q, TOP_K)) for q in single],
        "int8_single": [keys(eng.search_in_collection("tq8", q, TOP_K))
                        for q in single],
        "f32_batch": [keys(h) for h in eng.batch_search(batch, TOP_K)],
        "int8_batch": [keys(h) for h in eng.batch_search_ns(
            batch, TOP_K, ns="col/tq8")],
        "int8_filtered": [keys(eng.search_filtered_in_collection(
            "tq8", q, TOP_K, cond)) for q in extra[:TIE_FILTERED]],
        "f32_euclidean": [keys(eng.search_similar_with_metric(
            q, TOP_K, "euclidean")) for q in extra[:TIE_FILTERED]],
        "walks": [[keys(eng.search_similar_paginated(q, TOP_K, off, "dot"))
                   for off in range(0, walk_k, TOP_K)]
                  for q in extra[:TIE_WALKS]],
        "walk_tops": [keys(eng.search_similar_with_metric(q, walk_k, "dot"))
                      for q in extra[:TIE_WALKS]],
        "run_euclidean": [keys(h) for h in run_eng.batch_search(
            batch[:TIE_RUN_QUERIES], TOP_K, "euclidean")]}
    launches = dict(tk.LAUNCHES)
    report["launches_ties"] = launches
    if on_card:
        require_launches(launches, ("f32_pooled_bits", "int8_pooled_bits"),
                         "22")

    col = eng._corpus_for("col/tq8", DIM, False)
    cat_mask = col.filter_mask(cond)
    few = extra[:TIE_FILTERED]
    run_straddles = []
    want = {
        "f32_single": tie_plain(eng, "", single, TOP_K),
        "int8_single": tie_plain(eng, "col/tq8", single, TOP_K),
        "f32_batch": tie_plain(eng, "", batch, TOP_K, one_by_one=False),
        "int8_batch": tie_plain(eng, "col/tq8", batch, TOP_K,
                                one_by_one=False),
        "int8_filtered": tie_plain(eng, "col/tq8", few, TOP_K,
                                   cat_mask=cat_mask),
        "f32_euclidean": tie_plain(eng, "", few, TOP_K, "euclidean"),
        "walk_tops": tie_plain(eng, "", extra[:TIE_WALKS], walk_k, "dot"),
        "run_euclidean": tie_plain(run_eng, "", batch[:TIE_RUN_QUERIES],
                                   TOP_K, "euclidean", one_by_one=False,
                                   straddles=run_straddles)}
    bad = {name: sum(g != w for g, w in zip(got[name], want[name]))
           for name in want}
    for name in want:
        if len(got[name]) != len(want[name]):
            bad[name] += abs(len(got[name]) - len(want[name]))
    walk_bad = 0
    for pages, top in zip(got["walks"], got["walk_tops"]):
        flat = [key for page in pages for key in page]
        walk_bad += int(len(set(flat)) != len(flat) or flat != top)
    bad["walks"] = walk_bad
    # every hit list meets an exact tie: a group of equal vectors
    tied = sum(len(set(int(key[1:]) % len(base) for key in hits)) < len(hits)
               for hits in got["f32_single"] + got["int8_single"])
    report["ties_mismatches"] = sum(bad.values())
    report["ties_mismatches_by_route"] = bad
    report["ties_lists_with_copies"] = tied
    report["ties_routes"] = {
        ns or "default": eng.search_route(ns, DIM, TOP_K, "cosine", None,
                                          quant)["route"]
        for ns, quant in (("", "none"), ("col/tq8", "int8"))}
    report["ties_routes"]["run_euclidean"] = run_eng.search_route(
        "", DIM, TOP_K, "euclidean", None, "none")["route"]
    report["ties_run_straddles"] = sum(run_straddles)
    report["phase22_s"] = time.perf_counter() - t_phase
    say(f"[22] {n} keys ({len(base)} rows x {TIE_COPIES}) by ingest_matrix "
        f"in {report['ties_ingest_s']:.1f} s, an int8 collection of {n8} "
        f"row by row in {report['ties_int8_ingest_s']:.1f} s, {n_run} keys "
        f"({len(run_base)} rows x {TIE_COPIES} in a row) in "
        f"{report['ties_run_ingest_s']:.1f} s; routes "
        f"{report['ties_routes']}; {tied} of {2 * len(single)} single "
        f"top-{TOP_K}s hold copies; {report['ties_run_straddles']} of "
        f"{TIE_RUN_QUERIES} batched euclidean top-{TOP_K}s meet equal "
        f"scores across the {TOP_K}th place; orders differing from the "
        f"plain versions: {bad}; launches {launches}; "
        f"{report['phase22_s']:.1f} s")
    if (report["ties_mismatches"] or not tied
            or not report["ties_run_straddles"]
            or report["ties_routes"]["run_euclidean"] != "exact"):
        raise AssertionError(f"[22] equal scores out of lax.top_k's order "
                             f"({bad}) or no ties met ({tied}, "
                             f"{report['ties_run_straddles']}) or "
                             f"{report['ties_routes']}")
    del router, eng, col, run_router, run_eng
    return report


def kernels_line(report: dict) -> dict:
    """The kernels JSON line: per kernel its time, its plain version's,
    its bound and roofline share, the library call's time (or null and
    why), and its launches in the counted phases, in all and by route."""
    rows = []
    for name, meta in KERNELS.items():
        rec = report["kernels"][name]
        row = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"],
                   launches=int(report.get("launches", {}).get(name, 0)),
                   max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                   plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                   bound_by=rec["bound_by"],
                   roofline_share=rec["bound_ms"] / rec["ms"],
                   library_ms=rec.get("library_ms"))
        row["library"] = rec.get("library", NO_LIBRARY.get(name))
        for extra in ("bytes_bound_ms", "ops_bound_ms",
                      "popc_issue_bound_ms", "int8_rate_ms", "b1_ops_per_s",
                      "kernel_ms", "unselected_ms", "device_ms", "design",
                      "plan", "scores_topk_ms", "ffma_bound_ms"):
            if extra in rec:
                row[extra] = rec[extra]
        for sfx in SHAPE_SUFFIXES:   # the other shapes a kernel serves
            if f"ms{sfx}" in rec:
                row.update({f"{k}{sfx}": rec[f"{k}{sfx}"] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "bytes_bound_ms", "ops_bound_ms", "kernel_ms",
                    "unselected_ms", "device_ms", "library_ms",
                    "library_device_ms", "library", "plan", "shape",
                    "library_max_abs_err", "scores_topk_ms",
                    "ffma_bound_ms")
                    if f"{k}{sfx}" in rec})
                row[f"roofline_share{sfx}"] = (rec[f"bound_ms{sfx}"]
                                               / rec[f"ms{sfx}"])
                # a profile that saw no kernel records 0: no share then
                if rec.get(f"device_ms{sfx}"):
                    row[f"device_roofline_share{sfx}"] = (
                        rec[f"bound_ms{sfx}"] / rec[f"device_ms{sfx}"])
        row["launches_by_route"] = {
            ph: int(report[f"launches_{ph}"].get(name, 0))
            for ph in ROUTES if f"launches_{ph}" in report}
        rows.append(row)
    return {"kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=4_194_304)
    ap.add_argument("--pooled-rows", type=int, default=POOLED_ROWS)
    ap.add_argument("--wide-rows", type=int, default=WIDE_ROWS)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import neumann_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    if args.rows % 1024 or args.rows < 4_000_000:
        print("chip_smoke: --rows must be a multiple of 1,024 and at least "
              "the auto-IVF threshold (4,000,000)", file=sys.stderr)
        return 2
    if args.pooled_rows & (args.pooled_rows - 1) or \
            not 1 << 18 <= args.pooled_rows < 4_000_000:
        print("chip_smoke: --pooled-rows must be a power of two from 262,144 "
              "(the pooled gate) to below the auto-IVF threshold",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    report = run(args, torch.device("cuda"))
    report["total_s"] = time.perf_counter() - t_start
    kernels = kernels_line(report)
    metrics = {k: report[k] for k in (
        "single_p50_ms", "single_p99_ms", "batch_qps",
        "first_query_incl_build_s", "recall_single", "recall_batch",
        "build_kernels_s", "generate_s", "ingest_s", "peak_device_mem_gb",
        "pooled_single_p50_ms", "pooled_single_p99_ms", "pooled_batch_qps",
        "pooled_recall_single", "pooled_recall_batch",
        "pooled_filtered_p50_ms", "pooled_filtered_p99_ms",
        "pooled_recall_filtered", "filter_mask_ms", "pooled_ingest_s",
        "int8_single_p50_ms", "int8_single_p99_ms", "int8_batch_qps",
        "int8_recall_single", "int8_recall_batch", "int8_euclid_p50_ms",
        "int8_euclid_p99_ms", "binary_single_p50_ms", "binary_single_p99_ms",
        "binary_single_parsed_p50_ms",
        "binary_batch_qps", "binary_recall_vs_f32", "binary_mismatches",
        "binary_top65_batch_qps", "binary_top65_split_ms",
        "peak_device_mem_gb_brute", "wide_single_p50_ms",
        "wide_single_p99_ms", "wide_batch_qps", "wide_mismatches",
        "wide_ingest_s", "hybrid_entity_load_s", "hybrid_edge_load_s",
        "hybrid_p50_ms", "hybrid_p99_ms", "hybrid_neighbors_p50_ms",
        "hybrid_find_p50_ms", "hybrid_find_recall", "hybrid_swaps",
        "hybrid_graph_ms", "hybrid_graph_events_ms", "hybrid_device_ms",
        "hybrid_edge_tensors_ms", "sql_insert_s", "sql_select_ms",
        "build_native_parser_s", "parse_native_ms", "parse_python_ms",
        "parse_native_ms_3072", "parse_python_ms_3072", "warmup_calls",
        "warmup_s", "served_filtered_p50_ms", "served_filtered_recall",
        "served_binary_mismatches", "points_query_p50_ms",
        "points_query_recall", "points_query_mismatches",
        "parse_native_covers", "parse_native_covers_3072",
        "parse_python_native_lex_ms", "parse_python_native_lex_ms_3072",
        "shell_exact_differ", "shell_max_rel_diff", "shell_dev_s", "shell_cpu_s",
        "pq_ingest_s", "pq_first_query_s", "pq_train_s", "pq_encode_s",
        "pq_single_p50_ms", "pq_single_p99_ms", "pq_batch_qps",
        "pq_filtered_p50_ms", "pq_recall_vs_l2", "pq_mismatches",
        "tt_ingest_s", "tt_first_query_s", "tt_single_p50_ms",
        "tt_single_p99_ms", "tt_batch_qps", "tt_reconstruct_ms",
        "tt_compression_ratio", "tt_sample_max_rel_err", "tt_recall_vs_f32",
        "tt_mismatches", "ivf_build_s", "ivf_stride", "ivf_swaps",
        *(f"ivf_nprobe{p}_{k}" for p in IVF_NPROBES
          for k in ("p50_ms", "recall")),
        *(f"ivf_{st}_{k}" for st in ("pq", "binary")
          for k in ("build_s", "p50_ms", "batch_qps", "recall")),
        *(f"hnsw_{st}_{k}" for st in ("dense", "quantized", "binary")
          for k in ("rows", "build_s", "insert_per_s", "p50_ms", "recall")),
        "hnsw_build_wall_s", "pq_batch_adc_launches",
        "pq_batch_launch_counts", "pq_batch_peak_extra_gb",
        "pq_batch_device_ms",
        "ivf_pq_batch_adc_launches", "saved_index_ok",
        "rollback_load_s", "checkpoint_s", "checkpoint_bytes", "reembed_s",
        "delete_auto_checkpoint_s", "rollback_s", "rollback_first_query_ms",
        "rollback_p50_ms", "rollback_mismatches", "explain_kernels",
        "query_cache_miss_ms", "query_cache_hit_ms", "blob_put_mb_s",
        "blob_get_mb_s", "cache_fill_s", "cache_put_p50_ms",
        "cache_exact_hit_rate", "cache_semantic_hit_rate",
        "cache_exact_get_p50_ms", "cache_semantic_get_p50_ms",
        "cache_miss_get_p50_ms", "cryptography", "extended_s",
        "shell_errors", "top65_batch_qps", "top65_recall10",
        "top65_recall65", "top65_latency_recall65", "top65_overlap_latency",
        "top1_route_recall10", "delta_add_s", "delta_delete_s",
        "delta_compact_s", "delta_first_search_after_add_ms",
        "delta_first_search_after_delete_ms",
        "delta_first_search_after_compact_ms", "delta_before_p50_ms",
        "delta_after_p50_ms", "delta_before_batch_qps",
        "delta_after_batch_qps", "delta_before_recall", "delta_after_recall",
        "delta_recall_drop", "delta_added_first", "delta_top65_p50_ms",
        "delta_scan", "phase17_s",
        "chain_init_s", "chain_store_keys", "chain_embed_s",
        "chain_commit_ms", "chain_rollback_ms",
        "chain_first_similar_after_commit_ms",
        "chain_first_similar_after_rollback_ms", "chain_similar_p50_ms",
        "chain_rollback_mismatches", "consensus_call_ms",
        "consensus_kernel", "consensus_mismatches",
        "consensus_near_threshold_pairs", "consensus_class_counts",
        "cluster_load_s", "cluster_rows_per_s", "cluster_replicas_s",
        "cluster_kill_load_s", "cluster_kill_rows_per_s",
        "cluster_restart_catchup_s", "cluster_kill_reads", "phase18a_s",
        "phase18bcd_s", "points_codec_native", "grpc_warmup_s",
        "grpc_brute_warmup_s", "grpc_ivf_query_batch_ms",
        "grpc_ivf_query_batch_mismatches", "grpc_stream_qps",
        "grpc_stream_batches", "grpc_stream_mean_cohort",
        "grpc_stream_recall", "grpc_bits_query_batch_ms",
        "grpc_bits_mismatches", "grpc_filtered_recall",
        "grpc_filtered_wall_ms", "grpc_web_p50_ms",
        "grpc_web_mismatches", "phase19a_s", "phase19b_s",
        "pq_repeat_launches", "pq_repeat_mismatches",
        "pq_tables_single_vs_batch_differ",
        "pq_hits_single_vs_batch_tables_differ", "pq_repeat_s",
        "pq_sweep_launches", "pq_sweep_mismatches", "pq_sweep_s",
        "sharded_sizes", "sharded_start_s", "sharded_p50_ms",
        "sharded_p99_ms", "sharded_recall", "sharded_mismatches",
        "sharded_call_p50_ms", "sharded_coordinator_p50_ms",
        f"sharded_nprobe{SHARD_SERVERS}_call_p50_ms",
        f"sharded_nprobe{SHARD_SERVERS}_coordinator_p50_ms",
        "sharded_served_call_p50_ms",
        *(f"sharded_nprobe{p}_{k}" for p in range(1, SHARD_SERVERS + 1)
          for k in ("p50_ms", "recall")),
        "sharded_nprobe_all_mismatches", "sharded_qps",
        "sharded_served_recall", "sharded_count", "sharded_degraded_p50_ms",
        "sharded_degraded_mismatches", "sharded_explain", "phase20_s",
        "mesh_ingest_s", "mesh_shards", "mesh_f32_single_p50_ms",
        "mesh_f32_single_p99_ms", "mesh_f32_batch_qps",
        "mesh_f32_mismatches", "mesh_int8_single_p50_ms",
        "mesh_int8_single_p99_ms", "mesh_int8_batch_qps",
        "mesh_int8_recall_single", "mesh_int8_recall_batch",
        "mesh_euclid_p50_ms", "mesh_euclid_recall", "mesh_filtered_p50_ms",
        "mesh_filtered_recall", "mesh_ivf_first_query_s",
        "mesh_ivf_single_p50_ms", "mesh_ivf_single_p99_ms",
        "mesh_ivf_batch_qps", "mesh_ivf_recall_single",
        "mesh_ivf_recall_batch", "mesh_ivf_recall_own_single",
        "mesh_ivf_recall_own_batch", "mesh_ivf_batched_fast_ms",
        "mesh_ivf_batched_non_fast_ms", "mesh_ivf_batched_top1_mismatches",
        "mesh_fresh_not_first", "mesh_merge_mismatches", "phase21_s",
        "ties_ingest_s", "ties_int8_ingest_s", "ties_run_ingest_s",
        "ties_run_straddles", "ties_mismatches",
        "ties_lists_with_copies", "phase22_s", "total_s")}
    for part in ("ivf", "pooled", "int8", "binary"):
        for k in ("p50_ms", "p99_ms", "qps", "batches", "mean_cohort",
                  "recall"):
            if f"served_{part}_{k}" in report:
                metrics[f"served_{part}_{k}"] = report[f"served_{part}_{k}"]
    for part in ("ivf", "pooled"):
        metrics[f"served_{part}_device_idle_share"] = \
            report[f"profile_served_{part}"]["device_idle_share"]
        for k in ("p50_ms", "p99_ms", "qps", "batches", "mean_cohort",
                  "recall"):
            metrics[f"grpc_{part}_{k}"] = report[f"grpc_{part}_{k}"]
        metrics[f"grpc_{part}_device_idle_share"] = \
            report[f"grpc_{part}_idle"]["device_idle_share"]
    metrics["hybrid_mask_ms_median"] = float(np.median(
        report["hybrid_mask_ms"]))
    metrics["parse_ms_median"] = float(np.median(
        report["profile"]["parse_ms"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(report, kernel_checks=report["kernels"], **kernels),
                  f, indent=1, default=str)
    print(json.dumps({"metrics": metrics, "card": report["smi"],
                      "host_cpu": report["host_cpu"]}))
    print(json.dumps(kernels))
    print(report["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
