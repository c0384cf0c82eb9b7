#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port still builds, starts and trains on the card.

Phases (any failure raises, and the exit status is non-zero):
1. card: require CUDA; print the card's name and power limit.
2. build: compile the hand-written CUDA sketch kernels from the checkout.
3. kernel vs plain: each kernel must equal its plain PyTorch version on the
   card (torch.equal: bitwise, up to the sign of zero) at the ResNet-9
   slice's shapes and at small edge shapes (c not a multiple of 4, c below
   the kernels' 2048-item tile, d < c, r = 1 and r = 16).
4. times: each kernel's median over CUDA-event-timed launches, cold (L2
   flushed before each) and warm (its input rewritten just before each, as
   a round finds it), its plain version's, and its bound from the bytes it
   must move at the H100's 3.35 TB/s (or its float32 operations at 67
   TFLOP/s, whichever is larger).
5. main path: ``commefficient_tpu_torch.cv_train.main`` runs 5 FetchSGD
   rounds of full-width ResNet-9 through its default (async) run loop and
   an eval, with the launch counts zeroed
   just before; every logged loss must be finite, each kernel must have
   launched at least once per round, and the params must have moved in at
   most k coordinates per round.
6. checked rounds: one more FetchSGD round, and one uncompressed round
   after the control's first, both at lr 0.1 through ``run_round``; their
   new params are held against the step recomputed on the card from the
   same cohort's reduced gradient (the sketch round through the plain
   sketch and query, the control as ``p - lr * (0.9 V + g)``).
7. card vs CPU: the kernels again on a real reduced gradient and error
   table, and the client reduction of a few cohorts on the card held
   against the same reduction on the CPU; every reading is printed.
8. run loop: the slice through ``cv_train.main``'s run loop (async by
   default), with the launch counts zeroed just before:
   a. the sync loop twice, 6 rounds each, under the entry point's own
      switches (``cv_train.build`` calls ``utils.device.make_reproducible``,
      which makes cuDNN and every other operation deterministic): the final states must be bitwise equal, and every
      comparison below is bitwise;
   b. the async loop with --checkpoint_every 3 (both checkpoints must land
      and verify) and c. with --rounds_per_dispatch 3, each held against
      the sync run (params, Vvelocity, Verror, eval row);
   d. --fault_plan preempt@2 exits 75 with an emergency checkpoint at
      round 3; --resume to round 6 is held against the uninterrupted run;
   e. --fault_plan ckpt_corrupt@3: the resume falls back past the damaged
      round-3 checkpoint to round 2, sets it aside, and ends as (a);
   f. the uncompressed control, 2 rounds, async against sync;
   g. --pairs N alternating sync/async timing pairs (default 2);
   h. the round path between two drains makes no host sync: four
      dispatches run under ``torch.cuda.set_sync_debug_mode("error")``, and
      a profiler window over them and their drain counts the synchronize
      calls.
   Each kernel must have launched exactly once per sketch round of the
   phase; every time is printed beside the card's name and power limit.
9. profile: a torch.profiler window over two more rounds prints the device's
   busy time, idle share and top kernels per round, first under the entry
   point's reproducibility switches, then (for this window only) under
   cuDNN's and PyTorch's defaults: the cost of determinism.
10. baselines: ``cv_train.main`` at full width in FetchSGD's baselines, with
   the launch counts zeroed just before each run:
   a. FEMNIST true_topk, 3,550 synthetic writers, 8 sampled, k = 50,000;
   b. FEMNIST local_topk with virtual momentum and virtual error (no
      client state: 3,550 writers' state would not fit on one card);
   c. ResNet-9 local_topk with the reference's defaults (local momentum and
      local error, LOCAL_CLIENTS = 32 clients: 1.7 GB of client state), sync and async
      (with its checkpoint timed) held bitwise, and preempt -> resume
      held bitwise against the uninterrupted run;
   d. ResNet-9 fedavg with 5 local iterations;
   e. ResNet-9 true_topk with --server_state sketch (r = 5, c = 524,288):
      each kernel must launch exactly once per round (the dense-state runs
      must launch none).
   Every logged loss must be finite, and a mode that releases k moves the
   params in at most k coordinates a round. After each run one more round
   at lr 0.1 through ``run_round`` is held against the mode's algebra
   recomputed on the card from the same cohort's per-client updates.

11. GPT-2: ``gpt2_train.main`` fine-tunes GPT-2 small (byte vocabulary
   261, seq_len 256, dropout 0.1, d = 85,453,056) over 4,375 synthetic
   personas (a quarter of the paper's 17,500: the corpus is host time) with
   FetchSGD (r = 5, c = 1,000,000, k = 50,000, 4 clients of 8 rows a
   round), with the launch counts zeroed before each run:
   a. 4 rounds through the sync loop, with --eval_f1 4; d and the flat
      layout's first and last leaves, peak device memory;
   b. both kernels at this shape bitwise against their plain versions (on a
      random vector and on the run's params and error table) and timed
      cold and warm beside their bound;
   c. the async loop held bitwise against (a), eval row included;
   d. --fault_plan preempt@2 exits 75, and --resume is held bitwise against
      (a), with dropout on;
   e. one round at lr 0.1 held against FetchSGD's algebra on the card;
   g. two greedy decodes of the 4 validation prompts bitwise equal, F1;
   h. a profiler window over 2 rounds, with the host operations that take
      most host time;
   f. the uncompressed control, 2 rounds, async against sync.
   Every logged NLL must be finite, and each kernel must launch once per
   sketch round of every run (none in the control's).
12. cohort: client participation on the slice (ResNet-9 FetchSGD at full
   width, 6-round runs through ``cv_train.main``):
   a. --fault_plan with a drop of positions 0 and 3 at round 1, a
      straggler and a NaN-poisoned client at round 2, and a data load
      failing past its retries at round 3, sync then async: round 1 has 6
      participants and its dropped ids are in round 2's cohort, round 2 is
      skipped as non-finite and keeps its batch-norm statistics, round 3
      degrades (0 participants, its 8 clients queued, a line on stderr);
      each kernel launches once a round (counts zeroed just before the
      sync run), and async == sync bitwise, per-round metrics and the
      committed queue included;
   b. --client_dropout 0.25 --dp_clip 5 --requeue_policy aged with
      drops: async == sync bitwise; preempt@3 exits 75 with a non-empty
      queue in meta.json, and --resume lands bitwise on the uninterrupted
      run, queue and ages included;
   c. one round with positions {0, 3} masked against the same round over
      the 6 survivors alone: bitwise at --client_chunk 1 (one client a
      vmap); at chunk 0 (a vmap of 8 against one of 6) top-k agreement and
      the moved params held as phase 15a holds them;
   d. both kernels bitwise against their plain versions on (c)'s reduced
      gradient and error table;
   f. round time (sync, async) and device busy a round beside a clean run
      of the same shape;
   e. FEMNIST true_topk with --dp_clip 1 --dp_noise 1: the noise on a
      round's aggregate has std dp_noise * dp_clip / participants within
      1%, a fully masked round releases nothing, async == sync bitwise;
   g. phase 8h's sync probe with (b)'s dropout and clip, and with (e)'s
      noise: no host sync between drains.
13. bfloat16, the double head and --init_from, through the entry points,
   with the launch counts zeroed before each run:
   a. ResNet-9 FetchSGD (phase 5's flags) with --dtype bfloat16, 6 rounds
      sync and async: bitwise equal, one launch of each kernel a round,
      the kernels == plain on the run's params and error table; a cohort's
      reduced gradient on the card against the CPU port's in bfloat16
      (bound: the card's own bfloat16-vs-float32 gap on that cohort) and
      its loss sum (1e-2); device busy a round beside phase 9's float32;
   b. GPT-2 small (phase 11's flags) with --mc_coef 1 --num_candidates 2
      --dtype bfloat16 --eval_f1 4, 4 rounds sync and async: d =
      85,453,824, bitwise equal rows (mc_acc, val_mc_acc, val_f1
      included), one launch of each kernel a round, both kernels bitwise
      against their plain versions at this d and timed; cuBLAS's reduced-
      precision bfloat16 reductions timed on and off; device busy and
      matrix-product time a round beside phase 11's float32, peak memory;
   c. a GPT-2-small-shaped checkpoint in HuggingFace's layout (vocabulary
      256, 1,024 positions) written with torch.save; --init_from loads it
      bitwise (the grown rows by the reference's formula) and 2 rounds run.

14. serving: the streaming aggregation service on the slice (phase 5's
   flags, 4-round sync runs through ``cv_train.main``), with the launch
   counts zeroed before (a) and (b):
   a. --serve inproc, announce payloads, quorum 6 of 8 within 1 s: every
      round has casualties; held bitwise (params, mode state, batch-norm
      statistics, eval row, queue and ages) against the batch round with
      the same drops as a client_drop plan; one launch of each kernel a
      round;
   b. --serve_payload sketch (quorum 6 within 30 s, trace seed 3) with a
      corrupt frame, a duplicated frame and a NaN-poisoned client: each
      rejection class counted, the accumulate launched W = 8 times and the
      query once a round, held bitwise against the batch payload round
      (``engine.compose_payload``) with the same drops; every client's
      table of a round == the plain sketch of its update, bitwise;
   c. (b) over the loopback socket, event loop and threaded, == (b)
      bitwise, with one GET /metrics over HTTP;
   d. (b) with preempt@2: exit 75, a ``serve`` block in meta.json, and
      --resume == (b) bitwise;
   e. stage ms, round ms beside the batch twins', the [W, r, c] stack's
      D2H and H2D bytes and ms, socket bytes a round, device busy of the
      payload and announce rounds.

15. batched clients: the client phase is one ``torch.func.vmap`` over the
   cohort (``--client_chunk`` 0, the default every phase above runs), or
   W / C vmapped chunks; every phase above runs chunk 0. Sessions from the
   entry points' build functions:
   a. ResNet-9 FetchSGD (phase 5's flags) at chunk 0, 4 and 1 on one
      state and cohort: per-client loss sums (FWD_REL) and gradients
      (CLIENT_GRAD_REL), and the cohort's reduced gradient (GRAD_REL_L2),
      against chunk 1; one round at lr 0.1 at each chunk: top-k agreement
      (TOPK_AGREE) and the params both moved (GRAD_REL_L2); one launch of
      each kernel a round; the kernels bitwise against their plain
      versions on the chunk-0 reduced gradient; peak memory;
   b. GPT-2 small at full width, LM float32 and MC bfloat16 with dropout
      0.1, at chunk 0, 2 and 1: every client's dropout masks under the
      vmap bitwise its (round, slot, step) generator's; per-client
      gradients and loss sums at chunk 0 against chunk 1; one launch of
      each kernel a round; peak memory at each chunk;
   c. sync timing, chunk 0 and chunk 1 in turns (BATCH_PAIRS each), for
      (a) and both GPT-2 runs: host dispatch ms, round ms, then a
      profiler window: device busy ms a round with the matrix products
      apart and kernel launches a round;
   and no vmap batching-rule fallback warning fires on any of it.

16. observability (``obs/``) through the entry points, with the launch
   counts zeroed before (a), (d) and (e):
   a. ResNet-9 FetchSGD (phase 5's flags), 6 rounds, async, plain and with
      --trace --trace_events --health_every 2 --ledger --slo warn
      --profile_rounds 2:3 --profile_dir: bitwise equal; the trace holds
      the runner's spans and device spans over every round; the capture
      (the exported Chrome trace) holds accumulate_tiles once and
      query_tiles once a round it covers, plus one query_tiles a health
      round; health blocks on rounds 0, 2 and 4 only, each recall proxy
      within 0.05 of the truth; each health round's raw table queried by
      the kernel == its plain query bitwise; the ledger's replay-check and
      diff against a second armed run exit 0;
   b. preempt@2 -> exit 75 -> --resume with --ledger: one gap-free ledger,
      and the exit-75 postmortem bundle (trace, ledger tail, registry,
      config, reason);
   c. phase 8h's sync probe with --trace --health_every 1 --ledger;
   d. GPT-2 (phase 11's flags), 2 sync rounds with --health_every 1: the
      chunked split estimator gives a finite block; its device ms and
      transient memory, and a round with and without it, in turns;
   e. the served sketch-payload round in process, 4 rounds with
      --health_every 1: every health block == the batch payload round's;
   f. sync round ms, plain against armed (off cadence and health rounds),
      3 alternating rounds each.
17. robust merges and the quarantine (phase 5's flags, sync runs through
   ``cv_train.main``), with the launch counts zeroed before each run of (a)
   and (b):
   a. 4 rounds of the table round at --merge_policy sum, trimmed
      (--merge_trim 1) and median under a 50x-scaled, a sign-flipped and a
      colluding client: each run's params distance from a clean run (the
      sum's must be the largest), 32 accumulate and 4 query launches in 4
      rounds; one attacked round's [8, 5, 524,288] stack merged by the
      trimmed mean and the median (with and without the winsorized
      residual) on the card == the same merge of a CPU copy, bitwise;
   b. 5 announce rounds with --client_update_clip 3 --quarantine_window 4
      --quarantine_scope layer and a NaN-poisoned client at round 2: the
      one verdict, one launch of each kernel a round; the quarantined round
      == the round with that client's validity zeroed, bitwise; the sync
      probe with the clip armed;
   c. phase 14's served sketch payload with the clip and a 50x table at
      round 2: the gauntlet rejects it QUARANTINED, and the state equals
      the batch twin's whose merge quarantines it, bitwise;
   d. (b) preempted at round 2 and resumed == (b), rings included;
   e. sum, trimmed and median rounds and merges on one state and cohort in
      turns (CUDA events), peak memory, the sort along dim 0 against a
      transposed one, and the trimmed keep mask three ways (sorted values,
      ranks by counting, stable sort + argsort) at W = 8 to 100.
18. the sharded round (``client_shards``, ``--mesh``; phase 5's flags, 4
   rounds, S = 4 shards of 2 clients):
   a. the emulation on one card (the session at client_shards=4 through
      ``cv_train.main``, sync): exactly 4 accumulate and 1 query launches a
      round; one round from its state against the unsharded round on the
      same batch, allclose: rel L2 of the params' movement and top-k
      agreement;
   b. a 4-rank gloo group on the one card (``distributed.launch_local``,
      the ranks sharing cuda:0; NCCL refuses two ranks on one card; in the
      whole script one launch, ``joint_launch``, runs the group runs of
      18b, 20 and 21 in turn, one process start for all), each
      rank through ``cv_train.main``, async: rank 0's rows, checkpoint
      (params, Vvelocity, Verror, batch-norm statistics) and every rank's
      per-round metrics bitwise (a)'s, every rank's ledger fingerprints
      equal every round, 1 accumulate and 1 query launch a round on each
      rank; --fault_plan host_preempt@1:host=2: every rank exits 75 and
      rank 0 alone checkpoints round 2; --resume from it == the
      uninterrupted run, bitwise;
   c. a one-rank NCCL group on the card: ``initialize``, one gather of an
      [r, c] table (the identity at one rank), ``all_hosts_max``; the NCCL
      version;
   d. round ms, the emulation (S = 4) against the unsharded round in turns
      (CUDA events); the gloo gather's ms on rank 0 (processes on one card
      through host memory: it says nothing of NVLink or InfiniBand);
      ``merge_comm_bytes`` at S = 4 for ResNet-9 and GPT-2.
19. the layerwise sketch path (``--sketch_path layerwise``); every phase
   above runs the ravel path and must launch no ``sketch_accumulate_tree``:
   a. the tree accumulate against its plain version (the per-leaf fold),
      bitwise after the whole tree, and against ``sketch_accumulate`` of
      the raveled vector, with ceil(L / TREE_MAX_LEAVES) launches a tree: on
      edge trees (a leaf that starts mid-slab and spans 3 slabs, a
      1-element leaf, a last leaf with padding past d; c not a multiple of
      4 at r = 1; r = 16; c below the tile), the same trees as separate
      allocations starting at element offsets 1, 2 and 3 mod 4, a tree of
      500 leaves of 1-37 coordinates (more than one launch takes), then
      ResNet-9's plan (26 leaves, c = 524,288) and GPT-2's (148, c =
      1,000,000); cold and warm ms of a whole tree's fold (one launch,
      beside ``sketch_accumulate`` of the same vector) and of a one-leaf
      fold in place on the largest and the smallest leaf, with plain ms and
      bound;
   b. ResNet-9 FetchSGD (phase 5's flags), 6 rounds: ravel sync, layerwise
      sync and async (bitwise equal), launches a round 1
      ``sketch_accumulate_tree``, 0 ``sketch_accumulate``, 1
      ``sketch_query``; layerwise against ravel bitwise (the client phase
      is shared, so only the fold can differ); sync round ms and peak
      memory of each path in turns (CUDA events);
   d. --fault_plan preempt@2 exits 75, --resume == (b)'s layerwise run;
   c. GPT-2 LM (phase 11's flags, chunk 0), 2 rounds each way: 1 tree
      launch a round, state and rows against ravel's bitwise, round ms and
      peak memory in turns.

20. the rest of the client mesh on a group: 4 gloo ranks sharing the card
   (phase 18b's launch), 4 rounds a run at ResNet-9's full width:
   a. local_topk with local error and momentum (phase 10's flags, 32
      clients): the [32, d] client state padded and split, 8 rows a key
      on each rank; == the one-device twin (the emulation at S = 4)
      bitwise on every rank, client rows included; each rank's resident
      state a quarter of the twin's; preempted at round 1 on rank 2 and
      resumed, == the uninterrupted run; rank 0's round-2 checkpoint
      resumed in a one-device session, == the same;
   b. fedavg with 5 local steps == its twin bitwise;
   c. the trimmed table round (trim 1, clip 3, a 50x client) == the
      one-device groups at client_shards 4 bitwise; each rank launches 2
      accumulates and 1 query a round;
   d. local_topk round ms on rank 0 in turns with the twin (rank 0 holds
      it), the row moves' ms and bytes (against ``client_row_bytes``) and
      the table gather's, on rank 0 after a barrier.
21. serving on a group and the serving pipeline: 4 gloo ranks sharing the
   card (phase 18b's launch), 4 rounds a run at ResNet-9's full width:
   a. served announce (phase 14a's close) and served payload (phase 14b's,
      with --client_update_clip 3 and a wire_corrupt client), each ==
      the one-device served run at client_shards 4 bitwise on every rank
      (params, optimizer state, batch-norm statistics, the quarantine's
      rings, every per-round metric, the committed queue and ages), rank
      0's serve counters and casualties == the twin's; launches a rank:
      announce 1 accumulate and 1 query a round, payload 2 and 1; the
      payload close's broadcast (bytes and ms) on rank 0 after a barrier;
   b. the payload group with host_preempt@1:host=2: every rank exits 75 at
      round 2, rank 0's checkpoint has the serve block, and --resume ==
      (a)'s payload run on every rank;
   c. local_topk (phase 20a's, no checkpoints) served serially and with
      --serve_pipeline on the group: bitwise equal on every rank, client
      rows included; server_idle_ms and round ms of each;
   d. on one card, 6 rounds each of announce and payload, serial and
      pipelined in turns: bitwise equal, server_idle_ms and round ms of
      each, launches (W = 8 accumulate and 1 query a payload round; a
      payload pipeline's worker may sketch one round past the end), and
      the kernels == plain on the pipelined run's params and error table.
22. the buffered-async service, served payload in process at ResNet-9's
   full width (the serve trace seed 5, a 30 s deadline), launches counted
   over each run (W = 8 accumulates and 1 query a round):
   a. --serve_async --serve_buffer 8 == the sync served run (quorum 8),
      4 rounds, bitwise; no fold runs;
   b. --serve_buffer 6 --serve_stale_rounds 1 --serve_staleness 0.5, 6
      rounds, twice: bitwise equal, stragglers folded in every round from
      1 (0 < stale_weight < stale_folded), and both kernels == plain on
      the run's last folded table and on its error table; the H2D bytes
      and CUDA-event ms of the live and the stale stacks;
   c. trimmed (trim 2) and median, clean and under
      client_stale_poison@2 (positions 0 and 1, -5x): the poisoned tables
      admitted ACCEPTED_STALE and folded into round 3's union stack; the
      params' distance from the clean run;
   d. (b) preempted at round 3 (checkpoint at round 4, its stale band
      non-empty in meta.json), --resume == (b) bitwise;
   e. (b) with --serve_pipeline == (b) bitwise; round ms and
      server_idle_ms of async buffer 6 and sync quorum 6, serial and
      pipelined;
   f. (b) on 4 gloo ranks sharing the card, 4 rounds, == the one-device
      run at client_shards 4 bitwise on every rank (2 accumulates a rank a
      round), with rank 0's broadcast bytes a round with and without
      stale slots (in the whole script the ranks are phase 21's launch's).
23. the serving fast path (--serve_fastpath) on phase 22's served payload
   cell, under a corrupt frame at round 1 and a NaN table at round 2 with
   the clip at 3, every run held bitwise against its fastpath-off twin
   (params, optimizer state, batch-norm statistics, metrics, queue and,
   but pipelined, the admission counters), launches counted over each run
   (W = 8 accumulates and 1 query a round):
   a. in process, 6 rounds a run, slow, fast, fast, slow; the chaos went
      through the validation; both kernels == plain on the fast run's last
      merged table and on its error table;
   b. over the socket, the eventloop and the threaded engine, 4 rounds a
      run: the validation ran in batches, and the host copies of a table,
      slow against fast, are printed;
   c. async buffer 6 and d. pipelined, 4 rounds a run;
   e. the fast run on 4 gloo ranks sharing the card, 3 rounds (in phase
      21's launch when the whole script runs), == the one-device fast run
      at client_shards 4 on every rank (2 accumulates a rank a round; rank
      0 broadcasts its ring-built stack);
   f. a's runs in turns: host copies of a table, the H2D copies' bytes and
      CUDA-event ms (the ring's chunks against the slow path's stack), the
      loop's host ms a round, round ms, the ring's blocks made and the host
      allocator's pinned blocks made and handed out;
   no "gauntlet batch failed" line may appear.
24. the sharded ingest on phase 23b's socket eventloop cell (the corrupt
   frame, the NaN table, the clip at 3), 4 rounds a run, 8 accumulates and 1
   query a payload round counted over each run, each round's merged stack
   digested, /dev/shm's names the same before and after each run:
   a. 4 thread shards (fast) == the one-listener run, slow and fast (phase
      23b's runs in the whole script) bitwise: params, optimizer state,
      batch-norm statistics, every metric row, the queue, the admission
      counters, each round's stack;
   b. 4 process shards (fewer if /dev/shm cannot hold 4 blocks of the
      cohort), slow (tables over the control connections) and fast (the
      shared-memory ring blocks): == (a) bitwise, the same keys; steady
      round ms, the serve_stage_collect_ms p50, host copies of a table, the
      H2D copies of the shm chunks ("h2d_ring"), the workers' spawn s;
   c. shard_kill@2:shards=1 == client_drop@2 of the dead shard's cohort
      positions bitwise; 1 death, the worker respawned at round 3 (its s);
   d. the fast process run on 4 gloo ranks sharing the card, 3 rounds
      (phase 21's launch in the whole script), == the one-device run at
      client_shards 4 on every rank (2 accumulates and 1 query a rank a
      round);
   e. one load-generator stage: 2,048 connections from 4 client processes
      for 5 s against the process shards: submissions/s, the verdicts, the
      descriptor cap of a client process, os.cpu_count().
25. the two-tier edge tree (--serve_edges) on phase 22's served payload
   cell, 3 rounds a run through the sync loop, each run's launch counts
   zeroed just before it (W = 8 accumulates and 1 query a round, tree or
   flat twin); the flat twin is the same edge-armed session served with
   the tree off (ServeConfig.edges 0), and every pin is bitwise: params,
   optimizer state, batch-norm statistics, metrics, queue and (in process)
   the admission counters:
   a. the tree == its flat twin in process at E = 2 (tree, flat, flat,
      tree) and E = 4; the root's H2D copy of the E partials ("h2d_edge",
      E x 10,485,760 B a round) against the twin's of the stack ("h2d",
      83,886,080 B), and the host fold's ms a round; both kernels == plain
      on the tree run's params and error table;
   b. the same with the clip at 3 under a 50x table at round 1 and a NaN
      table at round 2: the rejected and quarantined counts equal;
   c. edge_kill@2:edges=1 == client_drop@2 of the positions edge 1 owns in
      round 2; 1 edge death;
   d. forward mode: --merge_policy trimmed --merge_trim 1 --serve_edges 2
      == the flat trimmed run, its NOTE on stderr;
   e. over the socket (event loop, 4 thread shards) with --serve_edges 4
      == (a)'s E = 4 tree in process;
   f. the E = 2 tree with the clip on 4 gloo ranks sharing the card (in
      phase 21's launch when the whole script runs) == the one-device run
      at client_shards 4 on every rank (2 accumulates and 1 query a rank a
      round); rank 0's broadcast bytes and ms a round against 23e's
      W-table stack.
26. GPT-2's mixture of experts at full width: phase 11's flags and corpus
   with --moe_experts 8 (every second block's MLP a Switch top-1 mixture
   of 8 experts, float32), d = 283,647,744, past the unsketch's 1 GiB
   single-shot line; each run's launch counts zeroed just before it:
   a. 3 rounds through the sync loop: d, finite NLL, each round's
      moe_aux_sum > 0 and moe_aux_count == 4 (one a client), one launch of
      each kernel a round, peak device memory;
   b. both kernels bitwise against their plain versions on the run's
      params and error table, and timed cold and warm beside their bound;
   c. the card's single-shot unsketch_topk of the run's error table (the
      query kernel and one top-k) against the CPU's chunk scan of the same
      table (one slab at a time, the scan the port runs on a CPU table
      past the line; on a thread while (b), (d) and (e) run, or in the
      whole script on half the cores beside phase 27's group launch, and
      checked after it):
      the same indices and bitwise values; --topk_impl approx and
      oversample on the card select what exact selects;
   d. one round at lr 0.1 held against FetchSGD's algebra on the card;
   e. the async loop over 2 rounds held bitwise against (a)'s state and
      metrics after its round 2.
27. GPT-2's parallelism at full width: phase 11's cell (GPT-2 small,
   seq_len 256, d = 85,453,056, r = 5, c = 1,000,000, 4 clients of 8 rows
   a round, FetchSGD LM in float32) through ``gpt2_train.main``, 2 rounds
   a run through the sync loop, each run's launch counts zeroed just
   before it and each round timed after a barrier:
   a. GPT2Config(remat=True) against the plain model on one card: the
      state and every round's metrics bitwise; peak device memory of a
      round step and of its client phase, and round ms, of both; where
      the client phase's peak lay in round 1 (the allocator's memory
      history replayed, by the port's allocating line);
   b. --model_parallel 2 on 2 gloo ranks sharing the card (collectives
      staged through host memory): against (a)'s plain run, the coordinates
      both moved within rtol 2e-4 / atol 2e-5 and the moved sets agreeing
      in at least 99 %; the two ranks' states bitwise; one launch of each
      kernel a rank a round; both kernels bitwise against their plain
      versions on the run's params and error table; rank 0's collective
      bytes, calls and ms a round, and the round ms;
   c. --seq_parallel 2 --attn_impl ring on the same launch, with (b)'s
      checks, against a dense one-device run with dropout 0;
   d. ``ops.pipeline.pipeline_apply`` over GPT-2 small's 12 blocks in 2
      stages on those ranks at 4 microbatches of 2 rows: forward and each
      stage's gradients of mean(y^2) against the sequential stack within
      rtol 2e-4 / atol 2e-5; the ms of each;
   e. runs (a)-(c) with --eval_f1 4 (greedy, 32 new tokens): every rank
      decodes at the eval boundary; the ranks' ids and lengths bitwise;
      (b)'s and (c)'s ids against (a)'s plain and dense runs', any
      differing token printed with its step's top-2 logit gap (a gap above
      1e-3 fails); each run's val_f1, decode ms and collective bytes and
      ms;
   f. --serve inproc --serve_payload sketch --serve_pipeline on
      --model_parallel 2, 2 rounds, on the same launch (the worker's client
      step on the serve cycle's own groups), against a one-card served
      twin of the same seed: (b)'s checks (ranks bitwise, the moved set
      and values, both kernels against their plain versions on every
      rank, launches a round), the served rounds' ms and each client
      step's ms and collective bytes and ms;
   g. the same on --seq_parallel 2 --attn_impl ring with dropout 0,
      against a one-card dense served twin with dropout 0.

Prints one JSON line with the kernels' numbers (launches counted over
phase 8; under "gpt2" each kernel's numbers at the GPT-2 shape, launches
counted over phase 11a; "launches_cohort" counted over phase 12a's sync
run; "launches_bf16" over each run of phase 13 and under "gpt2_mc_bf16"
the numbers at phase 13b's shape; "launches_serve" over phase 14a's and
14b's served runs; "launches_batched" over each round of phase 15;
"launches_obs" over phase 16's armed (a), GPT-2 (d) and served (e) runs,
"launches_robust" over phase 17's attacked runs and its quarantine run,
"launches_mesh" over phase 18's emulation and each rank of its
uninterrupted gloo run, "launches_layerwise" over each run of phase 19,
"launches_group" over each of phase 20's runs on rank 0,
"launches_serve_group" over each of phase 21's runs (rank 0's on the
group), "launches_async" over each of phase 22's runs (rank 0's on the
group), "launches_fastpath" over each of phase 23's runs (rank 0's on the
group), "launches_shards" over each of phase 24's runs (rank 0's on the
group), "launches_edges" over each of phase 25's runs (rank 0's on the
group), under "gpt2_moe" each kernel's numbers at phase 26's shape,
launches counted over phase 26a, and "launches_parallel" over each of
phase 27's runs (each rank's on the group); a
third row, ``sketch_accumulate_tree``, with a whole ResNet-9 tree's fold
times and (b)'s layerwise launches),
then
as its last line
``{"ok": true, "device": {...}}``. Run from the repository root:
    python3 chip_smoke.py
``--kernels-only`` stops after phase 4 (a short first check of a new kernel),
``--layerwise-only`` runs phase 19 right after phase 4 and stops,
``--group-only`` runs phase 20 right after phase 4 and stops,
``--serve-only`` runs phase 21 right after phase 4 and stops,
``--async-only`` runs phase 22 right after phase 4 and stops,
``--fastpath-only`` runs phase 23 right after phase 4 and stops,
``--shards-only`` runs phase 24 right after phase 4 and stops,
``--edges-only`` runs phase 25 right after phase 4 and stops,
``--moe-only`` runs phase 26 right after phase 4 and stops,
``--parallel-only`` runs phase 27 right after phase 4 and stops,
``--shard-turns N`` runs phase 24's cell in N turns of the one listener and
process shards (``shard_turns``) right after phase 4 and stops,
``--cohorts N`` sets the number of cohorts phase 7 compares (default 4);
``--pairs N`` the sync/async timing pairs of phase 8 (default 2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SLICE = dict(d=6_573_130, c=524_288, r=5)
# (d, c, r): ragged last slab; d < c; c < the 2048-item tile; whole slabs;
# c not a multiple of 4 at r = 1; r = 16; c far below the tile, many slabs
EDGE_SHAPES = [(3000, 1024, 3), (700, 1024, 3), (1500, 1000, 4), (2048, 1024, 3),
               (5000, 777, 1), (40000, 4096, 16), (2500, 300, 2)]
SLICE_ARGS = ["--dataset", "cifar10", "--mode", "sketch", "--hash_family", "rotation",
              "--num_clients", "100", "--num_workers", "8", "--local_batch_size", "8",
              "--k", "50000", "--num_rows", "5", "--num_cols", "524288",
              "--device", "cuda"]
ROUNDS = 5
TIMED_LAUNCHES = 30
COHORTS = 4
CHECK_LR = 0.1
# a checked round's new params against the step recomputed on the card from
# the same cohort's gradients: the two differ only in the order the card
# sums them, so the params may differ by a sliver of the step; a missing,
# scaled or mis-signed step is O(1)
STEP_REL = 1e-3
# the sketch round's top-k against the plain recomputation: coordinates at
# the k-th |estimate| may swap with that same sliver
TOPK_AGREE = 0.99
# card vs CPU on the same cohort (float32, TF32 off). The forward values
# (loss sums, new batch-norm statistics) are continuous in rounding noise
# and must agree to 1e-5. The gradient is not continuous: rounding moves a
# few ReLU/max-pool branch decisions among the ~24M activations of a 64-row
# cohort, and a decision moved late in the network changes the backward
# signal of every layer before it. Over 16 cohorts (``--cohorts 16``) an
# H100 read relative L2 differences from 1.1e-4 to 2.7e-3, while two
# reductions of one cohort on the card moved the params by a few 1e-6 of
# the step apart (phase 6). So the gradient
# gets a bound of 3x the largest of those readings, which a layout, sign or
# scaling fault (an O(1) difference) cannot pass; its arithmetic is held
# tightly against the JAX package on the CPU (tests/test_torch_*.py).
FWD_REL = 1e-5
GRAD_REL_L2 = 8e-3
# run-loop phase: runs of LOOP_ROUNDS rounds, held bitwise
LOOP_ROUNDS = 6
PAIRS = 2
# baselines phase: rounds per run
BASE_ROUNDS = 4
FEMNIST_ARGS = ["--dataset", "femnist", "--num_clients", "3550", "--num_workers", "8",
                "--local_batch_size", "8", "--k", "50000", "--device", "cuda"]
# phase 11: GPT-2 small (byte vocabulary 261, seq_len 256, dropout 0.1), the
# paper's configuration #4 at its widths, over 4,375 synthetic personas: its
# 17,500 cut to a quarter, since the LM and MC corpora cost about 1.5 and 4
# ms of host a persona and the rounds sample 4 of them
GPT2_ARGS = ["--mode", "sketch", "--hash_family", "rotation", "--num_clients", "4375",
             "--num_workers", "4", "--local_batch_size", "8", "--k", "50000",
             "--num_rows", "5", "--num_cols", "1000000", "--num_blocks", "20",
             "--device", "cuda"]
GPT2_D = 85_453_056
GPT2_ROUNDS = 4
# phase 26: phase 11's flags with eight experts in every second block
MOE_ARGS = GPT2_ARGS + ["--moe_experts", "8"]
MOE_D = 283_647_744
MOE_ROUNDS = 3
MOE_ASYNC_ROUNDS = 2
# phase 27: phase 11's cell through each parallelism, 2 rounds a run; the
# group runs on 2 gloo ranks sharing the card
PAR_ROUNDS = 2
PAR_ARGS = GPT2_ARGS + ["--num_rounds", str(PAR_ROUNDS), "--sync_loop"]
PAR_RANKS = 2
PAR_RTOL, PAR_ATOL = 2e-4, 2e-5
PAR_TOPK_AGREE = 0.99
PIPE_MICRO, PIPE_ROWS = 4, 2
# phase 27e: runs (a)-(c) decode --eval_f1 4 dialogs (greedy, the default
# 32 new tokens); a group's token may differ from the one card's only at a
# step whose top-2 logits lie within F1_GAP
PAR_F1 = ["--eval_f1", "4"]
F1_GAP = 1e-3
# phases 27f, 27g: the served payload round, pipelined, on the model and
# the seq group, each beside a one-card served twin
PAR_SERVE = ["--serve", "inproc", "--serve_payload", "sketch", "--serve_pipeline"]
RESNET_ARGS = ["--dataset", "cifar10", "--hash_family", "rotation", "--num_clients", "100",
               "--num_workers", "8", "--local_batch_size", "8", "--k", "50000",
               "--device", "cuda"]
# local_topk with local error and momentum keeps two [clients, d] rows a
# client; its runs (phases 10c, 20a, 21c) hold LOCAL_CLIENTS clients' state,
# 1.68 GB, where 100 clients' 5.26 GB took a minute of checkpoint copies,
# writes and reads a run of the whole script
LOCAL_CLIENTS = 32
LOCAL_ARGS = RESNET_ARGS + ["--mode", "local_topk", "--num_clients", str(LOCAL_CLIENTS)]
# phase 12: client participation on the main path, runs of COHORT_ROUNDS
COHORT_ROUNDS = 6
COHORT_PLAN = ("client_drop@1:clients=0+3;client_straggle@2:clients=1,secs=0.2;"
               "client_poison@2:clients=5,value=nan;data_fail@3:times=4")
DROPOUT_ARGS = ["--client_dropout", "0.25", "--dp_clip", "5.0", "--requeue_policy", "aged"]
DROPOUT_PLAN = "client_drop@1:clients=2+5;client_drop@3:clients=0+4"
# the DP noise's measured std against dp_noise * dp_clip / participants
NOISE_REL = 0.01
# phase 13: bfloat16, the double head and --init_from. A cohort's bf16 loss
# sum on the card against the CPU port's: bf16 rounding moves it by parts
# in 1e4; a fault moves it by O(1)
BF16_ROUNDS = 6
BF16_LOSS_REL = 1e-2
GPT2_MC_D = GPT2_D + 768  # the mc head: one n_embd vector
INIT_VOCAB = 256  # the written checkpoint's vocabulary, grown to the byte tokenizer's 261
INIT_ROUNDS = 2
# phase 14: serving, runs of SERVE_ROUNDS rounds of phase 5's flags through
# the sync loop. (a) closes at 6 of 8 with a 1 s deadline, so every round
# has casualties; (b)-(d) close at 6 of 8 within 30 s (only no-shows miss
# it), on a trace seed whose clients at the faulted positions submit
SERVE_ROUNDS = 4
SERVE_ANNOUNCE = ["--serve", "inproc", "--serve_quorum", "6", "--serve_deadline", "1.0"]
SERVE_PAYLOAD = ["--serve_payload", "sketch", "--serve_quorum", "6", "--serve_deadline",
                 "30.0", "--serve_trace", "seed=3"]
SERVE_PLAN = ("wire_corrupt@1:clients=0;wire_dup@1:clients=1;"
              "client_poison@2:clients=3,value=nan")
# phase 15: batched clients. ResNet-9 at these client chunks, GPT-2 at 0, 2
# and 1 (the timing at 0 and 1); BATCH_PAIRS alternating sync pairs each.
# A vmap over 8 clients and one over 1 run their products at other batch
# sizes, so a float32 client's gradient sums in another order: held within
# GRAD_REL_L2 and its loss sum within FWD_REL. In bfloat16 a product that
# sums in another order may round its output one bfloat16 ulp (2**-8)
# apart, and the backward carries such flips into every layer below: the
# gradient within BF16_GRAD_REL and the loss sum within BF16_LOSS_REL, which
# a layout, mask or scaling fault (an O(1) difference) cannot pass
BATCH_CHUNKS = (0, 4, 1)
GPT2_CHUNKS = (0, 2, 1)
BATCH_PAIRS = 3
BF16_GRAD_REL = 5e-2
# one client's float32 gradient, not a cohort's mean, is what the vmap
# changes: unaveraged, the same branch flips weigh more (an H100 read 6.0e-3
# for the worst of 8 ResNet-9 clients at chunk 0 against chunk 1, the mean
# of the cohort much less); a fault is O(1)
CLIENT_GRAD_REL = 3e-2
# phase 16: observability, runs of OBS_ROUNDS rounds of phase 5's flags;
# OBS_PAIRS alternating sync rounds a side in (f)
OBS_ROUNDS = 6
OBS_PAIRS = 3
# phase 17: robust merges and the quarantine, sync runs of phase 5's flags.
# (a) runs ROBUST_ROUNDS rounds of each policy under ATTACK_PLAN; (b) and (d)
# QUARANTINE_ROUNDS rounds with a NaN-poisoned client at round 2 (phase 12's
# poison) under QUARANTINE_ARGS; (c) the served payload round of phase 14
# with a 50x table at round 2; (e) ROBUST_PAIRS timed turns a policy
ROBUST_ROUNDS = 4
ATTACK_PLAN = ("client_scale@1:clients=1,factor=50;client_signflip@2:clients=0;"
               "client_collude@3:frac=0.25")
ROBUST_POLICIES = {"sum": ["--merge_policy", "sum"],
                   "trimmed": ["--merge_policy", "trimmed", "--merge_trim", "1"],
                   "median": ["--merge_policy", "median"]}
QUARANTINE_ARGS = ["--client_update_clip", "3", "--quarantine_window", "4",
                   "--quarantine_scope", "layer"]
QUARANTINE_PLAN = "client_poison@2:clients=5,value=nan"
QUARANTINE_ROUNDS = 5
SERVED_PLAN = "client_scale@2:clients=1,factor=50"
ROBUST_PAIRS = 3
RANK_COHORTS = (8, 12, 16, 24, 32, 100)  # phase 17e: W of the trimmed keep-mask timings
# phase 18: the sharded round, MESH_SHARDS shards (ranks) of phase 5's
# cohort, MESH_ROUNDS rounds; MESH_PAIRS timed turns in (d)
MESH_SHARDS = 4
MESH_ROUNDS = 4
MESH_PAIRS = 3
MESH_ARGS = ["--num_rounds", str(MESH_ROUNDS), "--checkpoint_every", "2",
             "--client_dropout", "0.25"]
# the emulation against the unsharded round: the shards sum their clients
# in another order, so a released coordinate may swap at the k-th estimate
# and the params move by a sliver of the step apart
MESH_TOPK_AGREE = 0.99
MESH_REL = 1e-3
# phase 20: the rest of the client mesh on a group of GROUP_SHARDS gloo
# ranks sharing the card, GROUP_ROUNDS rounds a run: (a) local_topk with
# local error and momentum (phase 10's flags, 32 clients: the client state
# split over the ranks), (b) fedavg with 5 local steps, (c) the table round
# of a trimmed merge with the clip and a 50x client; GROUP_TURNS timed
# turns in (d)
GROUP_SHARDS = 4
GROUP_ROUNDS = 4
GROUP_TURNS = 3
GROUP_RUNS = {
    "local_topk": LOCAL_ARGS,
    "fedavg": RESNET_ARGS + ["--mode", "fedavg", "--num_local_iters", "5"],
    "table": SLICE_ARGS + ["--merge_policy", "trimmed", "--merge_trim", "1",
                           "--client_update_clip", "3", "--fault_plan",
                           "client_scale@1:clients=1,factor=50"],
}
# phase 21: serving on a group of SERVE_GROUP_SHARDS gloo ranks sharing the
# card, SERVE_GROUP_ROUNDS rounds a run: (a) announce (phase 14a's close)
# and payload (phase 14b's, with the clip and a corrupt frame) against the
# one-device served runs at client_shards 4, (b) the payload run preempted
# and resumed, (c) local_topk (phase 20a's) pipelined against serial;
# SERVE_GROUP_TURNS timed broadcasts; (d) SERVE_ONE_ROUNDS rounds a run on
# one card, pipelined against serial. (c) and (d) run the sync loop, which
# drains every round, so every commit-to-dispatch gap is measured
SERVE_GROUP_SHARDS = 4
SERVE_GROUP_ROUNDS = 4
SERVE_GROUP_TURNS = 3
SERVE_GROUP_PLAN = "wire_corrupt@1:clients=0"
SERVE_GROUP_RUNS = {
    "announce": SLICE_ARGS + SERVE_ANNOUNCE + ["--num_rounds", str(SERVE_GROUP_ROUNDS)],
    "payload": SLICE_ARGS + ["--serve", "inproc"] + SERVE_PAYLOAD
    + ["--client_update_clip", "3", "--fault_plan", SERVE_GROUP_PLAN,
       "--num_rounds", str(SERVE_GROUP_ROUNDS)],
    "local_topk": GROUP_RUNS["local_topk"] + SERVE_ANNOUNCE
    + ["--num_rounds", str(SERVE_GROUP_ROUNDS), "--sync_loop"],
}
SERVE_ONE_ROUNDS = 6
SERVE_ONE_RUNS = {
    "announce": SLICE_ARGS + SERVE_ANNOUNCE + ["--num_rounds", str(SERVE_ONE_ROUNDS),
                                               "--sync_loop"],
    "payload": SLICE_ARGS + ["--serve", "inproc"] + SERVE_PAYLOAD
    + ["--fault_plan", SERVE_PLAN, "--num_rounds", str(SERVE_ONE_ROUNDS), "--sync_loop"],
}
# phase 22: the buffered-async service on phase 21's served payload cell
# with a 30 s deadline (only no-shows miss a close of the whole cohort) and
# the serve trace seed 5, whose buffer-6 closes leave stragglers in every
# round from 0 to 4, so every later round folds: (a) the sync run (quorum 8) against async with
# --serve_buffer 8, ASYNC_SHORT rounds; (b) ASYNC_ARGS (buffer 6 of 8, the
# stragglers folded a round later at (1 + 1)^-0.5) twice, ASYNC_ROUNDS
# rounds; (c) trimmed (trim 2) and median, clean and under
# ASYNC_POISON_PLAN, ASYNC_SHORT rounds; (d) (b) preempted at round 3 with
# its band non-empty, resumed; (e) (b) pipelined, and the sync twin
# (quorum 6) serial and pipelined; (f) (b) on ASYNC_GROUP_SHARDS gloo ranks
# sharing the card against the one-device run at client_shards 4
ASYNC_SHORT = 4
ASYNC_ROUNDS = 6
ASYNC_BASE = SLICE_ARGS + ["--serve", "inproc", "--serve_payload", "sketch",
                           "--serve_deadline", "30.0", "--serve_trace", "seed=5"]
ASYNC_ARGS = ASYNC_BASE + ["--serve_async", "--serve_buffer", "6", "--serve_stale_rounds",
                           "1", "--serve_staleness", "0.5"]
ASYNC_POISON_PLAN = "client_stale_poison@2:clients=0+1,factor=-5"
ASYNC_GROUP_SHARDS = 4
# phase 23: the fast path (--serve_fastpath) on phase 22's served payload
# cell under FAST_PLAN with the clip at 3 (a corrupt frame at round 1, a NaN
# table at round 2, each through the validation): (a) in process, slow and
# fast in turns (slow, fast, fast, slow), FAST_ROUNDS rounds each; (b) over
# the socket, each engine slow then fast, FAST_SOCKET_ROUNDS rounds (a
# socket round ships 8 tables of 14 MB of JSON: about 1.7 s); (c) async
# buffer 6 and (d) pipelined, fast against slow, ASYNC_SHORT rounds; (e) the
# fast run on ASYNC_GROUP_SHARDS gloo ranks sharing the card, FAST_GROUP_ROUNDS
# rounds, against the one-device fast run at client_shards 4 (in the whole
# script the group runs of 22f and 23e ride phase 21's launch)
FAST_ROUNDS = 6
FAST_SOCKET_ROUNDS = 4
FAST_GROUP_ROUNDS = 3
FAST_PLAN = "wire_corrupt@1:clients=0;client_poison@2:clients=3,value=nan"
FAST_BASE = ASYNC_BASE + ["--client_update_clip", "3", "--fault_plan", FAST_PLAN, "--sync_loop"]
# phase 24: the sharded ingest on phase 23b's socket eventloop cell,
# SHARD_ROUNDS rounds a run: (a) SHARDS thread shards against the one
# listener (23b's runs where the whole script ran them); (b) SHARDS process
# shards (fewer if /dev/shm cannot hold SHARDS blocks of the cohort), slow
# and fast; (c) KILL_PLAN against client_drop of the dead shard's cohort
# positions; (d) the fast process run on ASYNC_GROUP_SHARDS gloo ranks
# (phase 21's launch in the whole script), SHARD_GROUP_ROUNDS rounds; (e)
# one load-generator stage of LOADGEN_CONNS connections from LOADGEN_PROCS
# client processes for LOADGEN_S seconds against process shards
SHARD_ROUNDS = 4
SHARD_GROUP_ROUNDS = 3
SHARDS = 4
SHARD_BASE = FAST_BASE + ["--serve", "socket", "--serve_transport", "eventloop"]
KILL_ROUND, KILL_SHARD = 2, 1
LOADGEN_CONNS, LOADGEN_PROCS, LOADGEN_S = 2048, 4, 5.0
# phase 25: the edge tree on phase 22's served payload cell, EDGE_ROUNDS
# rounds a run through the sync loop: (a) E = 2 in turns and E = 4, tree
# against the flat twin; (b) with EDGE_CLIP_PLAN and the clip at 3; (c)
# edge_kill at EDGE_KILL_ROUND of EDGE_KILL against client_drop of its
# positions; (d) forward mode under trimmed (trim 1); (e) over the socket
# with 4 thread shards, E = 4; (f) (b)'s tree on ASYNC_GROUP_SHARDS gloo
# ranks (phase 21's launch in the whole script)
EDGE_ROUNDS = 3
EDGE_BASE = ASYNC_BASE + ["--sync_loop", "--num_rounds", str(EDGE_ROUNDS)]
EDGE_CLIP_PLAN = "client_scale@1:clients=2,factor=50;client_poison@2:clients=3,value=nan"
EDGE_CLIP = EDGE_BASE + ["--client_update_clip", "3", "--fault_plan", EDGE_CLIP_PLAN]
EDGE_KILL_ROUND, EDGE_KILL = 2, 1
# phase 19: the layerwise sketch path. (b) and (d) run LW_ROUNDS rounds of
# phase 5's flags, (c) LW_GPT2_ROUNDS of phase 11's; LW_PAIRS timed turns a
# path. LEAF_EDGES (d, c, r, leaf sizes): a leaf that starts mid-slab and
# spans 3 slabs, a 1-element leaf and a last leaf with padding past d; c not
# a multiple of 4 at r = 1; r = 16; c below the 2048-bucket tile.
# MANY_LEAVES leaves of 1 to 37 coordinates at (c, r) make a tree of more
# leaves than one launch of the tree kernel takes
LW_ROUNDS = 6
LW_GPT2_ROUNDS = 2
LW_PAIRS = 3
LEAF_EDGES = [(3000, 1024, 3, (100, 2500, 1, 399)), (5003, 777, 1, (5, 1600, 1, 3397)),
              (40000, 4096, 16, (4096, 1, 30000, 5903)), (2500, 300, 2, (299, 2, 2199))]
MANY_LEAVES = (500, 1000, 5)
# phase 19a's timings spin about 2 ms ahead of each timed call, past the
# host work of a 148-leaf tree's call, so that the events time the device
LW_SPIN_CYCLES = 4_000_000
LW_HOST_CALLS = 20


def reuse_run_inputs(cv_train) -> None:
    """Most runs of this script build their session from the same synthetic
    CIFAR (or FEMNIST) set and the same initial weights of their seed, each
    about 1.5-3 s of host time a run, over a hundred runs, and GPT-2 small's
    initial weights take seconds of host time a build, over 16 builds: build
    each once a process and hand later runs the same (never mutated) data
    arrays and a copy of the weights, bitwise the ones the run would have
    built itself (both inits draw from a generator of their own seed).
    Idempotent; ``cv_train.main`` and ``gpt2_train.main`` are otherwise
    untouched."""
    if getattr(cv_train, "_reused_inputs", False):
        return
    from commefficient_tpu_torch import gpt2_train

    data, weights = {}, {}

    def once(load):
        def load_once(*args, **kw):
            key = (load.__name__, args, tuple(sorted(kw.items())))
            if key not in data:
                data[key] = load(*args, **kw)
            return data[key]
        return load_once

    def init_once(init):
        def init_cached(model, seed):
            key = (type(model).__name__, seed,
                   tuple((n, tuple(p.shape), p.dtype) for n, p in model.named_parameters()))
            if key in weights:
                model.load_state_dict(weights[key])
            else:
                init(model, seed)
                weights[key] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        return init_cached

    cv_train.load_cifar_fed = once(cv_train.load_cifar_fed)
    cv_train.load_femnist_fed = once(cv_train.load_femnist_fed)
    cv_train.init_weights = init_once(cv_train.init_weights)
    gpt2_train.init_weights = init_once(gpt2_train.init_weights)
    cv_train._reused_inputs = True


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or not torch.equal(got, want):
        err = (got - want).abs().max().item() if got.shape == want.shape else math.inf
        fail(f"{name}: kernel disagrees with the plain version (max abs err {err})")
    return (got - want).abs().max().item()


def check_kernels(csvec, spec, v: torch.Tensor, table: torch.Tensor | None = None) -> tuple:
    """(accumulate err, query err) of the kernels against the plain versions
    on the card. The query is checked on `table` (default: v's sketch)."""
    acc = compare(f"sketch_accumulate {spec}", csvec.sketch_vec(spec, v),
                  csvec._sketch_vec_rotation(spec, v))
    if table is None:
        table = csvec._sketch_vec_rotation(spec, v)
    qry = compare(f"sketch_query {spec}", csvec.query_all(spec, table),
                  csvec._query_all_rotation(spec, table))
    return acc, qry


def checked_round(session, engine, lr: float):
    """Run one round of ``session`` at ``lr`` through ``run_round`` and
    return (state before, the round cohort's reduced gradient on the card,
    new params). The cohort is drawn first, and the host RNG rewound so
    that ``run_round`` draws the same one."""
    rng_state = session.rng.get_state()
    batch = session.prepare_round().batch
    session.rng.set_state(rng_state)
    before = {"params": session.state["params"].clone(),
              **{k: v.clone() for k, v in session.state["mode_state"].items()}}
    g, _, _ = engine.reduce_clients(session.train_loss_fn, session.cfg, session.layout,
                                    session.state, session._to_device(batch))
    session.run_round(lr)
    return before, g, session.state["params"]


def check_sketch_round(session, engine, csvec) -> str:
    """FetchSGD Alg. 1 recomputed with the plain sketch and query."""
    mcfg = session.cfg.mode
    spec, k = mcfg.sketch_spec, mcfg.k
    before, g, new = checked_round(session, engine, CHECK_LR)
    V = mcfg.momentum * before["Vvelocity"] + csvec._sketch_vec_rotation(spec, g)
    est = csvec._query_all_rotation(spec, before["Verror"] + CHECK_LR * V)
    idx = torch.topk(est.abs(), k).indices
    moved = new != before["params"]
    n_moved, agree = int(moved.sum()), moved[idx].float().mean().item()
    common = idx[moved[idx]]
    want = before["params"][common] - est[common]
    rel = ((new[common] - want).abs().max() / est[idx].abs().max()).item() if n_moved else math.inf
    verdict = (f"checked sketch round at lr {CHECK_LR}: {n_moved} params moved (k {k}), "
               f"top-k agreement with the plain recomputation {agree:.6f}, "
               f"value error / largest step {rel:.3e}")
    if not (0 < n_moved <= k and agree >= TOPK_AGREE and rel < STEP_REL):
        fail(verdict)
    return verdict


def check_control_round(session, engine) -> str:
    """The uncompressed control: p - lr * (momentum * V + g)."""
    before, g, new = checked_round(session, engine, CHECK_LR)
    lr_t = torch.tensor(CHECK_LR, dtype=torch.float32, device=g.device)
    want = before["params"] - lr_t * (session.cfg.mode.momentum * before["Vvelocity"] + g)
    step = (want - before["params"]).abs().max().item()
    rel = (new - want).abs().max().item() / step if step > 0 else math.inf
    verdict = (f"checked uncompressed round at lr {CHECK_LR}: largest step {step:.3e}, "
               f"error / largest step {rel:.3e}")
    if not rel < STEP_REL:
        fail(verdict)
    return verdict


def card_vs_cpu(session, engine, csvec, cohorts: int, errs: dict) -> None:
    """The kernels on a real round's reduced gradient and error table, and
    the client reduction of ``cohorts`` cohorts on the card against the same
    reduction on the CPU; prints every reading."""
    spec = session.cfg.mode.sketch_spec
    cpu_state = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                     else v.cpu() if torch.is_tensor(v) else v)
                 for k, v in session.state.items()}
    readings = []
    for i in range(cohorts):
        batch = session.prepare_round().batch
        weighted, stats, metrics = engine.reduce_clients(
            session.train_loss_fn, session.cfg, session.layout, session.state,
            session._to_device(batch))
        if i == 0:
            a, q = check_kernels(csvec, spec, weighted, session.state["mode_state"]["Verror"])
            errs["sketch_accumulate"] = max(errs["sketch_accumulate"], a)
            errs["sketch_query"] = max(errs["sketch_query"], q)
            print("real round: kernels == plain on its reduced gradient and error table",
                  flush=True)
        cpu_batch = dict(batch)  # host tensors already
        w_cpu, stats_cpu, metrics_cpu = engine.reduce_clients(
            session.train_loss_fn, session.cfg, session.layout, cpu_state, cpu_batch)
        loss_rel = abs(metrics["loss_sum"].item() / metrics_cpu["loss_sum"].item() - 1)
        stats_rel = max(((stats[k].cpu() - v).abs().max() / v.abs().max()).item()
                        for k, v in stats_cpu.items())
        diff = (weighted.cpu() - w_cpu).abs()
        grad_rel = (diff.norm() / w_cpu.norm()).item()
        live = w_cpu.abs() > 1e-6 * w_cpu.abs().max()
        grad_median = (diff[live] / w_cpu.abs()[live]).median().item()
        print(f"card vs CPU, cohort {i}: loss sum rel {loss_rel:.3e}, batch-norm stats rel "
              f"{stats_rel:.3e}, reduced gradient median rel {grad_median:.3e}, "
              f"rel L2 {grad_rel:.3e}", flush=True)
        readings.append((loss_rel, stats_rel, grad_rel))
    worst = [max(r[j] for r in readings) for j in range(3)]
    if not (worst[0] < FWD_REL and worst[1] < FWD_REL and worst[2] < GRAD_REL_L2):
        fail(f"card vs CPU over {cohorts} cohorts: worst loss sum rel {worst[0]:.3e}, "
             f"stats rel {worst[1]:.3e} (bound {FWD_REL}), gradient rel L2 "
             f"{worst[2]:.3e} (bound {GRAD_REL_L2})")


def _is_gemm(kernel_name: str) -> bool:
    """A cuBLAS/CUTLASS matrix-product kernel, by its name."""
    name = kernel_name.lower()
    return any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass"))


def profile_rounds(session, rounds: int = 2, top: int = 12, label: str = "",
                   host_top: int = 0, out: dict | None = None) -> float:
    """Where a steady round's time goes: a torch.profiler window over
    `rounds` more rounds; prints the device's busy time and idle share per
    round, the kernels that took most device time and the ``host_top`` host
    operations that took most host time, and returns the busy ms per round
    (0.0: not measured). ``out``, if given, receives "busy_ms", "wall_ms",
    "gemm_ms" (the matrix-product kernels' ms a round, ``_is_gemm``) and
    "launches" (device kernels a round). The host's operations are
    recorded only for ``host_top``: recording every operator slows the
    window's host side and multiplies the profiler's post-processing, which
    takes seconds a round over a per-client loop's tens of thousands of
    events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host_top else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            session.run_round(0.01)
        wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / rounds
    if busy_ms <= 0:
        print(f"profile{label}: the profiler recorded no device time (not measured)",
              flush=True)
        return 0.0
    gemms = [e for e in kernels if _is_gemm(e.key)]
    gemm_ms = sum(e.self_device_time_total for e in gemms) / 1e3 / rounds
    launches = sum(e.count for e in kernels) / rounds
    print(f"profile{label}: {rounds} rounds, wall {wall_ms:.2f} ms/round (profiled), device "
          f"busy {busy_ms:.2f} ms/round, idle share {1 - busy_ms / wall_ms:.3f}, matrix "
          f"products {gemm_ms:.2f} ms/round in {len(gemms)} kernels, {launches:.0f} kernel "
          "launches a round", flush=True)
    if out is not None:
        out.update(busy_ms=busy_ms, wall_ms=wall_ms, gemm_ms=gemm_ms, launches=launches)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / rounds
        print(f"  {ms:8.3f} ms/round  {e.count // rounds:5d}x  {e.key[:110]}", flush=True)
    if host_top:
        ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
        print(f"profile{label}: host operations by self host time", flush=True)
        for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:host_top]:
            ms = e.self_cpu_time_total / 1e3 / rounds
            print(f"  {ms:8.3f} ms/round  {e.count // rounds:5d}x  {e.key[:110]}", flush=True)
    return busy_ms


def determinism_cost(session, card: str) -> None:
    """Device busy per round under the entry point's reproducibility
    switches and, for these windows only, under cuDNN's and PyTorch's
    defaults (the port's behaviour before the switches), in turns."""
    on = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
          torch.are_deterministic_algorithms_enabled())
    busy = {"switches on": [], "defaults": []}
    try:
        for turn in range(4):
            det = turn % 2 == 0
            torch.backends.cudnn.deterministic = on[0] if det else False
            torch.use_deterministic_algorithms(on[2] if det else False)
            label = "switches on" if det else "defaults"
            busy[label].append(profile_rounds(session, top=0, label=f" ({label})"))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = on[0], on[1]
        torch.use_deterministic_algorithms(on[2])
    print(f"determinism cost: device busy ms/round with the switches {busy['switches on']}, "
          f"with the defaults {busy['defaults']} [{card}]", flush=True)


def _state(session) -> dict:
    return {"params": session.state["params"],
            "Vvelocity": session.state["mode_state"]["Vvelocity"],
            "Verror": session.state["mode_state"]["Verror"]}


def _rel(a: dict, b: dict, p0: torch.Tensor) -> float:
    """Largest relative L2 difference of two runs' states: params against
    their movement from p0, the tables against their own norm."""
    out = 0.0
    for k in a:
        ref = (b[k] - p0) if k == "params" else b[k]
        den = ref.norm().item()
        diff = (a[k] - b[k]).norm().item()
        out = max(out, diff / den if den > 0 else (0.0 if diff == 0 else math.inf))
    return out


def _equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _steady_ms(stats) -> float:
    """Median per-round ms over a run's drain windows, the first (which
    carries the first round's start-up) left out."""
    ms = stats.round_ms[1:] or stats.round_ms
    return statistics.median(ms)


def _times(label: str, stats, card: str) -> str:
    ck = "; ".join(f"save copy {t['copy_ms']:.1f} write {t['write_ms']:.1f} verify "
                   f"{t['verify_ms']:.1f} ms" for t in stats.checkpoints)
    return (f"  {label}: per-round ms {[round(t, 2) for t in stats.round_ms]} "
            f"(rounds per drain {stats.window_rounds}), steady median {_steady_ms(stats):.2f}, "
            f"in-flight depth {stats.max_inflight_used}, rtt {stats.rtt_ms:.4f} ms, host ms "
            f"prepare {stats.prepare_ms:.1f} dispatch {stats.dispatch_ms:.1f} drain "
            f"{stats.drain_ms:.1f}{'; checkpoints: ' + ck if ck else ''} [{card}]")


def run_loop_phase(cv_train, kernels, card: str, pairs: int) -> dict:
    """Phase 8: the run loop at full width; returns the launch counts."""
    import shutil

    from commefficient_tpu_torch.utils import checkpoint as ckpt

    base = os.path.join(ROOT, "build", "chip_smoke", "loop")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    rounds = 0  # sketch rounds committed in this phase

    def run(extra, label, mode="sketch"):
        nonlocal rounds
        log = os.path.join(base, f"{label}.jsonl")
        argv = SLICE_ARGS + ["--num_rounds", str(LOOP_ROUNDS), "--log_jsonl", log,
                             "--mode", mode] + list(extra)
        s = cv_train.main(argv)
        torch.cuda.synchronize()
        if mode == "sketch":
            rounds += s.run_stats.rounds
        with open(log) as f:
            row = [json.loads(line) for line in f][-1]
        print(_times(label, s.run_stats, card), flush=True)
        return s, row

    kernels.reset_launch_counts()
    a, row_a = run(["--sync_loop"], "sync_a")
    b, _ = run(["--sync_loop"], "sync_b")
    from commefficient_tpu_torch.models.convert import FlatLayout
    from commefficient_tpu_torch.models.resnet9 import ResNet9, init_weights
    model0 = ResNet9()
    init_weights(model0, 42)
    p0 = FlatLayout(model0).flatten(dict(model0.named_parameters())).to(a.state["params"].device)
    spread = _rel(_state(a), _state(b), p0)
    verdict = (f"run loop: two sync runs of one seed under the entry point's switches "
               f"(cudnn.deterministic {torch.backends.cudnn.deterministic}, deterministic "
               f"algorithms {torch.are_deterministic_algorithms_enabled()}): relative L2 "
               f"{spread:.3e}")
    if not _equal(_state(a), _state(b)):
        fail(verdict + ", not bitwise equal")
    print(verdict + ", bitwise equal - held", flush=True)

    def hold(label, s, row, ref=a, ref_row=row_a, keys=("train_loss", "train_acc",
                                                          "test_loss", "test_acc", "comm_mb")):
        """Bitwise, and ``keys`` of the eval rows equal too (a resumed run's
        train columns sum only the rounds it ran, so it is held on the
        rest)."""
        got = _rel(_state(s), _state(ref), p0)
        ok = _equal(_state(s), _state(ref)) and all(row[k] == ref_row[k] for k in keys)
        msg = f"run loop: {label} vs sync: relative L2 {got:.3e}"
        if not ok:
            fail(msg + ", not bitwise equal")
        print(msg + " - held bitwise", flush=True)

    ck1 = os.path.join(base, "ck_async")
    c, row_c = run(["--checkpoint_every", "3", "--checkpoint_dir", ck1], "async")
    names = sorted(d for d in os.listdir(ck1) if d.startswith("round_"))
    if names != ["round_00000003", "round_00000006"] or \
            not all(ckpt.verify(os.path.join(ck1, n)) is True for n in names):
        fail(f"async checkpoints: {names}")
    hold("async, checkpoint every 3", c, row_c)
    d, row_d = run(["--rounds_per_dispatch", "3"], "async_blocks")
    hold("async, 3 rounds per dispatch", d, row_d)

    ck2 = os.path.join(base, "ck_preempt")
    try:
        run(["--checkpoint_dir", ck2, "--fault_plan", "preempt@2"], "preempted")
        fail("preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    names = sorted(d for d in os.listdir(ck2) if d.startswith("round_"))
    if names[-1:] != ["round_00000003"] or ckpt.verify(os.path.join(ck2, names[-1])) is not True:
        fail(f"preemption checkpoint: {names}")
    rounds += 3
    print("run loop: preempt@2 exited 75 with a verified emergency checkpoint at round 3",
          flush=True)
    e, row_e = run(["--checkpoint_dir", ck2, "--fault_plan", "preempt@2", "--resume"],
                   "resumed")
    if e.run_stats.rounds != 3:
        fail(f"resume ran {e.run_stats.rounds} rounds, not 3")
    hold("preempt -> resume", e, row_e, ref=c, ref_row=row_c,
         keys=("test_loss", "test_acc", "comm_mb"))

    ck3 = os.path.join(base, "ck_corrupt")
    run(["--checkpoint_dir", ck3, "--checkpoint_every", "2", "--fault_plan", "ckpt_corrupt@3",
         "--num_rounds", "3"], "corrupted")
    f_, row_f = run(["--checkpoint_dir", ck3, "--resume"], "fallback")
    damaged = sorted(x for x in os.listdir(ck3) if x.endswith(".damaged"))
    if damaged != ["round_00000003.damaged"] or f_.run_stats.rounds != 4:
        fail(f"ckpt_corrupt@3: damaged {damaged}, resumed run ran {f_.run_stats.rounds}")
    print("run loop: the resume fell back past the damaged round-3 checkpoint to round 2",
          flush=True)
    hold("corrupt -> fallback resume", f_, row_f, keys=("test_loss", "test_acc", "comm_mb"))
    launches = ravel_launches(kernels)
    for name, n in launches.items():
        if n != rounds:
            fail(f"{name} launched {n} times in {rounds} sketch rounds of the run-loop phase")
    print(f"run loop: launches {launches} in {rounds} sketch rounds (one per round)", flush=True)

    ua, _ = run(["--sync_loop", "--num_rounds", "2"], "control_sync_a", "uncompressed")
    ub, _ = run(["--sync_loop", "--num_rounds", "2"], "control_sync_b", "uncompressed")
    uc, _ = run(["--num_rounds", "2"], "control_async", "uncompressed")
    verdict = (f"run loop: control, sync vs sync relative L2 "
               f"{_rel(_state(ua), _state(ub), p0):.3e}, async vs sync "
               f"{_rel(_state(uc), _state(ua), p0):.3e}")
    if not (_equal(_state(ua), _state(ub)) and _equal(_state(uc), _state(ua))):
        fail(verdict + ", not bitwise equal")
    print(verdict + " - held bitwise", flush=True)

    sync_ms, async_ms = [], []
    for i in range(pairs):
        order = [True, False] if i % 2 == 0 else [False, True]
        for sync in order:
            s, _ = run(["--num_rounds", str(2 * LOOP_ROUNDS)] + (["--sync_loop"] if sync else []),
                       f"pair{i}_{'sync' if sync else 'async'}")
            (sync_ms if sync else async_ms).append(_steady_ms(s.run_stats))
    print(f"run loop: {pairs} alternating pairs, steady per-round ms: sync "
          f"{[round(t, 2) for t in sync_ms]}, async {[round(t, 2) for t in async_ms]} [{card}]",
          flush=True)
    return launches


def sync_probe(cv_train, slice_args) -> None:
    """Between two drains the round path must not sync the host. Four
    prefetched dispatches run under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises at any synchronizing CUDA call; the drain's copy, run under
    it first, must raise (the detector works). A profiler window over the
    dispatches and their drain also counts the synchronize calls: the
    drain's and the profiler's own at its exit, no more. The observability
    flags among ``slice_args`` (--trace, --health_every, --ledger) are
    armed and attached as the entry point does, so their work runs under
    the detector too."""
    from torch.profiler import ProfilerActivity, profile

    from commefficient_tpu_torch import obs
    from commefficient_tpu_torch.runner import RoundPrefetcher
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    args = resolve_defaults(make_parser().parse_args(slice_args))
    obs.configure_from_args(args)
    session, _ = cv_train.build(args)
    wiring = obs.attach_from_args(args, session)
    src = RoundPrefetcher(session, 0, depth=4)
    try:
        session.commit_round(session.dispatch_round(src.next(), 0.01))  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = [session.dispatch_round(src.next(), 0.01) for _ in range(4)]
                try:
                    session.fetch_metrics(pending)
                    fail("sync probe: the drain's copy did not register as a sync")
                except RuntimeError:
                    pass
            finally:
                torch.cuda.set_sync_debug_mode(0)
            session.commit_rounds(pending, session.fetch_metrics(pending))
    finally:
        src.stop()
        wiring.close()
        obs.trace.configure()
    syncs = [e.name for e in prof.events()
             if e.name.startswith("cuda") and "Synchronize" in e.name]
    print(f"sync probe: 4 dispatches ran with no synchronizing call; the profiler window "
          f"(dispatches, drain, its own exit) holds {len(syncs)} synchronize call(s) "
          f"{syncs}", flush=True)
    if len(syncs) > 2:
        fail(f"sync probe: {len(syncs)} synchronize calls, more than the drain's and the "
             "profiler's")

def _initial_params(dataset: str, dev) -> torch.Tensor:
    """The CLI's initial flat params at the parser's default --seed."""
    from commefficient_tpu_torch.cv_train import init_weights
    from commefficient_tpu_torch.models.convert import FlatLayout
    from commefficient_tpu_torch.models.femnist_cnn import FEMNISTCNN
    from commefficient_tpu_torch.models.resnet9 import ResNet9

    model = FEMNISTCNN() if dataset == "femnist" else ResNet9()
    init_weights(model, 42)
    return FlatLayout(model).flatten(dict(model.named_parameters())).to(dev)


def _releases_k(mcfg) -> bool:
    return mcfg.mode == "true_topk" or (mcfg.mode == "local_topk"
                                        and mcfg.error_type == "virtual")


def check_baseline_round(session, engine, csvec) -> str:
    """One round at lr CHECK_LR through ``run_round``, held against the
    mode's algebra recomputed on the card from the same cohort's per-client
    updates (the engine's ``make_client_updates``: gradient plus weight
    decay, or the local-SGD weight delta): per-client top-k with torch.topk
    and the client rows for local_topk, the survivor mean, server momentum
    and error, the plain sketch and query for sketched state."""
    mcfg = session.cfg.mode
    rng_state = session.rng.get_state()
    prep = session.prepare_round()
    session.rng.set_state(rng_state)
    batch = session._to_device(prep.batch)
    batch.pop(engine.VALID_KEY)
    state = session.state
    dev = state["params"].device
    lr = torch.tensor(CHECK_LR, dtype=torch.float32, device=dev)
    p0 = state["params"].clone()
    V0, E0 = (state["mode_state"][k].clone() for k in ("Vvelocity", "Verror"))
    ids = torch.from_numpy(prep.ids.astype("int64")).to(dev)
    rows0 = ({k: v[ids] for k, v in session.client_state.items()}
             if session.client_state is not None else {})
    updates = engine.make_client_updates(session.train_loss_fn, session.cfg, session.layout)
    W, k = len(prep.ids), mcfg.k
    ups = list(updates(state, batch, lr, range(W))[0])
    want_rows = {}
    if mcfg.mode == "local_topk":
        dense = []
        for w, u in enumerate(ups):
            acc = u
            if mcfg.momentum_type == "local":
                acc = mcfg.momentum * rows0["momentum"][w] + u
                want_rows.setdefault("momentum", []).append(acc)
            if mcfg.error_type == "local":
                acc = rows0["error"][w] + acc
            idx = torch.topk(acc.abs(), k).indices
            d_w = torch.zeros_like(acc)
            d_w[idx] = acc[idx]
            dense.append(d_w)
            if mcfg.error_type == "local":
                want_rows.setdefault("error", []).append(acc - d_w)
        ups = dense
    g = sum(ups) / W
    rho = mcfg.momentum if mcfg.momentum_type == "virtual" else 0.0
    session.run_round(CHECK_LR)
    new = session.state["params"]
    if _releases_k(mcfg):
        if mcfg.server_state == "sketch":
            spec = mcfg.sketch_spec
            V = rho * V0 + csvec._sketch_vec_rotation(spec, g)
            est = csvec._query_all_rotation(spec, E0 + lr * V)
        else:
            V = rho * V0 + g
            est = (E0 if mcfg.error_type != "none" else 0.0) + lr * V
        idx = torch.topk(est.abs(), k).indices
        moved = new != p0
        n_moved, agree = int(moved.sum()), moved[idx].float().mean().item()
        common = idx[moved[idx]]
        err = (new[common] - (p0[common] - est[common])).abs().max().item() if n_moved else 0.0
        rel = err / est[idx].abs().max().item() if n_moved else math.inf
        verdict = (f"checked {mcfg.mode} round at lr {CHECK_LR}: {n_moved} params moved "
                   f"(k {k}), top-k agreement {agree:.6f}, value error / largest step "
                   f"{rel:.3e}")
        ok = 0 < n_moved <= k and agree >= TOPK_AGREE and rel < STEP_REL
    else:
        rate = mcfg.server_lr if mcfg.uses_weight_delta else lr
        want = p0 - rate * (rho * V0 + g)
        step = (want - p0).abs().max().item()
        rel = (new - want).abs().max().item() / step if step > 0 else math.inf
        verdict = (f"checked {mcfg.mode} round at lr {CHECK_LR}: largest step {step:.3e}, "
                   f"error / largest step {rel:.3e}")
        ok = rel < STEP_REL
    for key, rows in want_rows.items():
        want_r = torch.stack(rows)
        got_r = session.client_state[key][ids]
        rel_r = ((got_r - want_r).norm() / want_r.norm()).item()
        verdict += f"; client {key} rows rel L2 {rel_r:.3e}"
        ok = ok and rel_r < STEP_REL
    if not ok:
        fail(verdict)
    return verdict


def client_state_ms(session, time_ms, card: str) -> str:
    """Device ms of one round's client-state traffic as ``dispatch_round``
    runs it (median of 5 CUDA-event-timed launches each): the gather of the
    cohort's rows, and the out-of-place scatter of the new rows into new
    [num_clients, d] tensors, beside its byte bound (the old state read and
    the new one written once, at 3.35 TB/s)."""
    cs = session.client_state
    ids = torch.arange(session.num_workers, device=session.device) * 7 % len(
        next(iter(cs.values())))
    rows = {k: v.index_select(0, ids) + 1.0 for k, v in cs.items()}
    gather = time_ms(lambda: {k: v.index_select(0, ids) for k, v in cs.items()}, 5,
                     lambda: None)
    scatter = time_ms(lambda: {k: v.index_copy(0, ids, rows[k]) for k, v in cs.items()}, 5,
                      lambda: None)
    nbytes = sum(2 * v.numel() * 4 for v in cs.values())
    return (f"client state {nbytes / 2e9:.2f} GB: gather {gather:.3f} ms, out-of-place "
            f"scatter {scatter:.3f} ms (byte bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms) "
            f"[{card}]")


def baselines_phase(cv_train, engine, csvec, kernels, card: str) -> None:
    """Phase 10: FetchSGD's baselines at full width through
    ``cv_train.main``."""
    import shutil

    from commefficient_tpu_torch.utils import checkpoint as ckpt

    base = os.path.join(ROOT, "build", "chip_smoke", "baselines")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    dev = torch.device("cuda")
    p0s, launch_log = {}, {}

    def run(args, label, sketch_launches=0, extra=()):
        log = os.path.join(base, f"{label}.jsonl")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = cv_train.main(list(args) + ["--num_rounds", str(BASE_ROUNDS), "--log_jsonl", log,
                                        *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ravel_launches(kernels)
        if any(n != sketch_launches * s.run_stats.rounds for n in launches.values()):
            fail(f"{label}: launches {launches} in {s.run_stats.rounds} rounds, expected "
                 f"{sketch_launches} per round")
        with open(log) as f:
            rows = [json.loads(line) for line in f]
        if not rows or not all(math.isfinite(r[key]) for r in rows
                               for key in ("train_loss", "test_loss")):
            fail(f"{label}: non-finite or missing loss in {rows}")
        mcfg = s.cfg.mode
        dataset = args[args.index("--dataset") + 1]
        if dataset not in p0s:
            p0s[dataset] = _initial_params(dataset, dev)
        moved = int((s.state["params"] != p0s[dataset]).sum())
        bound = (mcfg.k if _releases_k(mcfg) else
                 s.num_workers * mcfg.k if mcfg.mode == "local_topk" else mcfg.d)
        if not 0 < moved <= s.round * bound:
            fail(f"{label}: {moved} params moved in {s.round} rounds (bound {bound} a round)")
        launch_log[label] = launches
        print(f"baselines {label}: d={mcfg.d:,} {s.run_stats.rounds} rounds in {wall:.1f} s, "
              f"launches {launches}, {moved} params moved, final test loss "
              f"{rows[-1]['test_loss']:.4f}, comm {rows[-1]['comm_mb']:.3f} MB", flush=True)
        print(_times(label, s.run_stats, card), flush=True)
        return s, rows[-1]

    def checked(s, label):
        print(f"baselines {label}: " + check_baseline_round(s, engine, csvec), flush=True)
        profile_rounds(s, top=4, label=f" {label} [{card}]")

    topk = ["--mode", "true_topk"]
    s, _ = run(FEMNIST_ARGS + topk, "femnist_true_topk")
    checked(s, "femnist_true_topk")
    virt = ["--mode", "local_topk", "--error_type", "virtual", "--momentum_type", "virtual"]
    s, _ = run(FEMNIST_ARGS + virt, "femnist_local_topk_virtual")
    checked(s, "femnist_local_topk_virtual")
    del s

    local = LOCAL_ARGS
    a, row_a = run(local + ["--sync_loop"], "resnet9_local_topk_sync")
    gb = sum(v.numel() * 4 for v in a.client_state.values()) / 1e9
    ck = os.path.join(base, "ck_local")
    c, row_c = run(local, "resnet9_local_topk_async", extra=["--checkpoint_dir", ck])

    def same(x, y):
        return (_equal(_state(x), _state(y)) and x.client_state.keys() == y.client_state.keys()
                and all(torch.equal(x.client_state[k], y.client_state[k])
                        for k in x.client_state))

    if not (same(a, c) and row_a["test_loss"] == row_c["test_loss"]):
        fail("resnet9 local_topk: async run differs from the sync run")
    print(f"baselines: resnet9 local_topk async == sync bitwise, client state "
          f"{sorted(a.client_state)} ({gb:.2f} GB) included", flush=True)
    path = ckpt.latest(ck)
    t0 = time.perf_counter()
    ckpt.restore(path, c)
    torch.cuda.synchronize()
    print(f"baselines: checkpoint of the {gb:.2f} GB client state: "
          + "; ".join(f"copy {t['copy_ms']:.0f} write {t['write_ms']:.0f} verify "
                      f"{t['verify_ms']:.0f} ms" for t in c.run_stats.checkpoints)
          + f"; restore {1e3 * (time.perf_counter() - t0):.0f} ms [{card}]", flush=True)
    del c
    shutil.rmtree(ck, ignore_errors=True)
    ck2 = os.path.join(base, "ck_preempt")
    try:
        run(local, "resnet9_local_topk_preempted",
            extra=["--checkpoint_dir", ck2, "--fault_plan", "preempt@1"])
        fail("preempt@1 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    e_, row_e = run(local, "resnet9_local_topk_resumed",
                    extra=["--checkpoint_dir", ck2, "--fault_plan", "preempt@1", "--resume"])
    if not (e_.run_stats.rounds == BASE_ROUNDS - 2 and same(a, e_)
            and row_a["test_loss"] == row_e["test_loss"] and row_a["comm_mb"] == row_e["comm_mb"]):
        fail("resnet9 local_topk: preempt -> resume differs from the uninterrupted run")
    print("baselines: resnet9 local_topk preempt@1 -> exit 75 -> resume == uninterrupted, "
          "bitwise, client state included", flush=True)
    del e_
    shutil.rmtree(ck2, ignore_errors=True)
    from commefficient_tpu_torch.sketch.time_kernels import time_ms
    print("baselines: " + client_state_ms(a, time_ms, card), flush=True)
    checked(a, "resnet9_local_topk")
    del a

    s, _ = run(RESNET_ARGS + ["--mode", "fedavg", "--num_local_iters", "5"], "resnet9_fedavg")
    checked(s, "resnet9_fedavg")
    del s
    sk = RESNET_ARGS + ["--mode", "true_topk", "--server_state", "sketch", "--num_rows", "5",
                        "--num_cols", "524288"]
    s, _ = run(sk, "resnet9_true_topk_sketch_state", sketch_launches=1)
    checked(s, "resnet9_true_topk_sketch_state")
    return launch_log["resnet9_true_topk_sketch_state"]


class _Tee:
    """A text stream that writes through to another and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


@contextlib.contextmanager
def recording_rounds():
    """Inside the block, every session records each committed round's host
    metrics and the batch-norm statistics as committed, and each round's
    first preparation: (cohort ids, the queue after it)."""
    from commefficient_tpu_torch.federated.api import FederatedSession

    rec = {"metrics": [], "net_state": [], "cohorts": {}}
    commit, prepare = FederatedSession.commit_rounds, FederatedSession.prepare_round

    def commit_rec(self, infls, hosts):
        out = commit(self, infls, hosts)
        rec["metrics"].extend(out)
        rec["net_state"].append({k: v.clone() for k, v in self.state["net_state"].items()})
        return out

    def prepare_rec(self, rnd=None):
        prep = prepare(self, rnd)
        rec["cohorts"].setdefault(prep.rnd, ([int(i) for i in prep.ids], prep.requeue))
        return prep

    FederatedSession.commit_rounds, FederatedSession.prepare_round = commit_rec, prepare_rec
    try:
        yield rec
    finally:
        FederatedSession.commit_rounds, FederatedSession.prepare_round = commit, prepare


def _full_state(s) -> dict:
    return {**_state(s), **{f"bn:{k}": v for k, v in s.state["net_state"].items()}}


def _same_run(a, b, rec_a, rec_b) -> bool:
    """Bitwise: params, mode state, batch-norm statistics, every round's
    metrics, the committed queue and its ages."""
    return (_equal(_full_state(a), _full_state(b)) and rec_a["metrics"] == rec_b["metrics"]
            and a._requeue_committed == b._requeue_committed
            and a._requeue_ages_committed == b._requeue_ages_committed)


def cohort_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 12: client participation on ResNet-9 FetchSGD at full width
    (and DP on the FEMNIST CNN); returns each kernel's launches over the
    sync run of 12a."""
    import shutil

    from commefficient_tpu_torch.utils import checkpoint as ckpt
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "cohort")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    times = {}

    def run(extra, label):
        argv = SLICE_ARGS + ["--num_rounds", str(COHORT_ROUNDS), "--log_jsonl",
                             os.path.join(base, f"{label}.jsonl")] + list(extra)
        with recording_rounds() as rec:
            s = cv_train.main(argv)
        torch.cuda.synchronize()
        times[label] = _steady_ms(s.run_stats)
        print(_times(label, s.run_stats, card), flush=True)
        return s, rec

    # a. scheduled faults, sync and async
    faults = ["--fault_plan", COHORT_PLAN, "--on_nonfinite", "skip", "--requeue_policy", "fifo"]
    tee = _Tee(sys.stderr)
    kernels.reset_launch_counts()
    with contextlib.redirect_stderr(tee):
        a, rec_a = run(faults + ["--sync_loop"], "faults_sync")
    launches = ravel_launches(kernels)
    m = rec_a["metrics"]
    cols = {k: [x.get(k) for x in m] for k in ("participants", "clients_dropped",
                                               "requeue_depth", "nonfinite_rounds")}
    print(f"cohort a: per round {json.dumps(cols)}", flush=True)
    cohorts = rec_a["cohorts"]
    gone = {cohorts[1][0][0], cohorts[1][0][3]}
    checks = {
        "round 1: 6 participants, 2 dropped": (cols["participants"][1], cols["clients_dropped"][1])
        == (6.0, 2.0),
        "round 1's dropped ids in round 2's cohort": gone <= set(cohorts[2][0]),
        "round 2 skipped as non-finite": cols["nonfinite_rounds"][2] == 1.0,
        "round 2 keeps round 1's batch-norm statistics": all(
            torch.equal(rec_a["net_state"][2][k], rec_a["net_state"][1][k])
            for k in rec_a["net_state"][1]),
        "round 3 degraded: 0 participants, 8 dropped, 8 queued": (
            cols["participants"][3], cols["clients_dropped"][3], cols["requeue_depth"][3])
        == (0.0, 8.0, 8.0),
        "round 3's whole cohort queued": set(cohorts[3][1]) == set(cohorts[3][0]),
        "round 3's degradation on stderr": "round 3 batch load failed after retries"
        in tee.text(),
        "one launch of each kernel a round": all(n == COHORT_ROUNDS
                                                 for n in launches.values()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"cohort a: {bad}; launches {launches}")
    print(f"cohort a: held: {'; '.join(checks)} (launches {launches}) [{card}]", flush=True)
    b, rec_b = run(faults, "faults_async")
    if not _same_run(a, b, rec_a, rec_b):
        fail("cohort a: the async run differs from the sync run")
    print("cohort a: async == sync bitwise (params, Vvelocity, Verror, batch-norm statistics, "
          "per-round metrics, committed queue)", flush=True)
    del b

    # b. random dropout and the clip, then preempt -> resume with a queue
    drop = DROPOUT_ARGS + ["--fault_plan", DROPOUT_PLAN]
    c, rec_c = run(drop + ["--sync_loop"], "dropout_sync")
    d, rec_d = run(drop, "dropout_async")
    parts = [x["participants"] for x in rec_c["metrics"]]
    # rounds 0, 2, 4 and 5 drop clients only at random
    if not _same_run(c, d, rec_c, rec_d) or min(parts[i] for i in (0, 2, 4, 5)) == 8.0:
        fail(f"cohort b: async differs from sync, or dropout dropped nobody ({parts})")
    print(f"cohort b: participants a round {parts}; async == sync bitwise", flush=True)
    del d
    ck = os.path.join(base, "ck")
    preempt = DROPOUT_ARGS + ["--fault_plan", DROPOUT_PLAN + ";preempt@3",
                              "--checkpoint_dir", ck]
    try:
        run(preempt, "dropout_preempted")
        fail("cohort b: preempt@3 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    path = ckpt.latest(ck)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if not path.endswith("round_00000004") or not meta["requeued"]:
        fail(f"cohort b: checkpoint {path} with queue {meta['requeued']}")
    e_, rec_e = run(preempt + ["--resume"], "dropout_resumed")
    if not (e_.run_stats.rounds == 2 and _equal(_full_state(c), _full_state(e_))
            and rec_e["metrics"] == rec_c["metrics"][4:]
            and e_._requeue_committed == c._requeue_committed
            and e_._requeue_ages_committed == c._requeue_ages_committed):
        fail("cohort b: preempt -> resume differs from the uninterrupted run")
    print(f"cohort b: preempt@3 -> exit 75 with queue {meta['requeued']} (ages "
          f"{meta['requeue_ages']}) in meta.json -> resume == uninterrupted, bitwise", flush=True)
    del e_

    # c. masked == surviving cohort, one round on the card: bitwise at
    # --client_chunk 1 (one client a vmap, as the reference pins it); at
    # chunk 0 a vmap of 8 and one of 6 sum in another order (GRAD_REL_L2)
    for chunk in (1, 0):
        args = resolve_defaults(make_parser().parse_args(
            SLICE_ARGS + ["--client_chunk", str(chunk)]))
        s, _ = cv_train.build(args)
        batch = s.prepare_round(0).batch
        masked = dict(batch, _valid=batch["_valid"].clone())
        masked["_valid"][[0, 3]] = 0.0
        surv = [1, 2, 4, 5, 6, 7]
        alone = {k: v[surv] for k, v in batch.items()}
        lr = torch.tensor(CHECK_LR, device=s.device)
        out_m = s._step(s.state, s._to_device(masked), {}, lr)
        out_s = s._step(s.state, s._to_device(alone), {}, lr)
        diffs = {"params": (out_m[0]["params"] - out_s[0]["params"]).abs().max().item()}
        for k in out_m[0]["mode_state"]:
            diffs[k] = (out_m[0]["mode_state"][k] - out_s[0]["mode_state"][k]).abs().max().item()
        print(f"cohort c: chunk {chunk}: positions {{0, 3}} masked vs the 6 survivors alone: "
              f"max abs differences {diffs}", flush=True)
        if chunk == 1:
            same = (torch.equal(out_m[0]["params"], out_s[0]["params"])
                    and all(torch.equal(out_m[0][p][k], out_s[0][p][k])
                            for p in ("mode_state", "net_state") for k in out_m[0][p])
                    and all(torch.equal(out_m[2][k], out_s[2][k]) for k in out_m[2]))
            if not same:
                fail("cohort c: the masked round is not bitwise the surviving cohort's round")
            print("cohort c: chunk 1: masked round == surviving cohort's round, bitwise "
                  "(params, Vvelocity, Verror, batch-norm statistics, metrics)", flush=True)
        else:
            agree, rel, swaps = round_agreement(out_m[0], out_s[0], s.state["params"])
            verdict = (f"cohort c: chunk 0: masked vs surviving: top-k agreement {agree:.6f} "
                       f"(bound {TOPK_AGREE}), moved params rel L2 on the coordinates both "
                       f"moved {rel:.3e} (bound {GRAD_REL_L2}), {swaps} swaps")
            print(verdict, flush=True)
            if not (agree >= TOPK_AGREE and rel < GRAD_REL_L2):
                fail(verdict)

    # d. the kernels on the masked round's reduced gradient and error table
    g, _, _ = engine.reduce_clients(s.train_loss_fn, s.cfg, s.layout, s.state,
                                    s._to_device(masked))
    check_kernels(csvec, s.cfg.mode.sketch_spec, g, out_m[0]["mode_state"]["Verror"])
    print("cohort d: kernels == plain on the masked round's gradient and error table",
          flush=True)
    del s, out_m, out_s

    # f. round time and device busy beside a clean run of the same shape
    e, _ = run(["--sync_loop"], "clean_sync")
    run([], "clean_async")
    busy_clean = profile_rounds(e, top=3, label=f" clean [{card}]")
    busy_cohort = profile_rounds(c, top=3, label=f" dropout+clip [{card}]")
    print(f"cohort f: steady round ms {json.dumps({k: round(v, 2) for k, v in times.items()})}; "
          f"device busy ms a round: clean {busy_clean:.2f}, dropout+clip {busy_cohort:.2f} "
          f"[{card}]", flush=True)
    del a, c, e

    # e. DP noise on FEMNIST true_topk (no batch norm)
    fem = FEMNIST_ARGS + ["--mode", "true_topk", "--dp_clip", "1.0", "--dp_noise", "1.0",
                          "--num_rounds", str(BASE_ROUNDS)]
    s, _ = cv_train.build(resolve_defaults(make_parser().parse_args(fem)))
    batch = s._to_device(s.prepare_round(0).batch)
    weighted, _, met = engine.reduce_clients(s.train_loss_fn, s.cfg, s.layout, s.state, batch)
    noised = engine._dp_noise_agg(s.cfg, {"dense": weighted}, met["participants"], 0)["dense"]
    noise = (noised - weighted).double()
    n_live = met["participants"].item()
    want = s.cfg.dp_noise * s.cfg.dp_clip / n_live
    std = noise.std().item()
    empty = engine._dp_noise_agg(s.cfg, {"dense": weighted}, met["participants"] * 0, 0)
    print(f"cohort e: FEMNIST d={noise.numel():,}, {n_live:.0f} participants: noise std "
          f"{std:.6e} against {want:.6e} ({std / want - 1:+.4%}), mean {noise.mean().item():.3e}",
          flush=True)
    if abs(std / want - 1) > NOISE_REL or not torch.equal(empty["dense"], weighted):
        fail("cohort e: DP noise std off, or noise released with no participant")
    del s, batch, weighted, noised, noise
    s, _ = cv_train.build(resolve_defaults(make_parser().parse_args(
        fem + ["--fault_plan", "data_fail@0:times=9", "--max_retries", "0"])))
    p0 = s.state["params"].clone()
    mh = s.run_round(CHECK_LR)
    ms = s.state["mode_state"]
    if not (mh["participants"] == 0.0 and torch.equal(s.state["params"], p0)
            and not torch.count_nonzero(ms["Vvelocity"]) and not torch.count_nonzero(ms["Verror"])):
        fail("cohort e: a fully masked round with DP noise released something")
    print("cohort e: a fully masked round with DP noise on released nothing (params unchanged, "
          "Vvelocity and Verror exactly zero)", flush=True)
    del s
    fs = cv_train.main(fem + ["--sync_loop"])
    fa = cv_train.main(fem)
    if not _equal(_state(fs), _state(fa)):
        fail("cohort e: FEMNIST DP async differs from sync")
    print("cohort e: FEMNIST true_topk with DP clip and noise, async == sync bitwise", flush=True)
    del fs, fa
    shutil.rmtree(ck, ignore_errors=True)

    # g. the participation mask, the clip and the noise sync nothing
    for label, argv in (("dropout+clip", SLICE_ARGS + DROPOUT_ARGS), ("DP noise", fem)):
        print(f"cohort g: {label}:", end=" ", flush=True)
        sync_probe(cv_train, argv)
    return launches


@contextlib.contextmanager
def serving_runs(fetch_after: int = 2):
    """Inside the block, every round source a service hands out is recorded
    with its service, and the first commit at or past round
    ``fetch_after`` of a service with a metrics endpoint fetches
    ``GET /metrics`` over HTTP into rec["metrics"]."""
    import urllib.request

    from commefficient_tpu_torch.serve import service as svc

    rec = {"runs": [], "metrics": None}
    source, committed = svc.AggregationService.source, svc.ServedSource.on_committed

    def source_rec(self, start_round=None):
        src = source(self, start_round)
        rec["runs"].append((self, src))
        return src

    def committed_rec(self, committed_round):
        committed(self, committed_round)
        ms = getattr(self.service, "metrics_server", None)  # a group's followers have none
        if ms is not None and rec["metrics"] is None and committed_round >= fetch_after:
            host, port = ms.address
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30) as r:
                rec["metrics"] = json.loads(r.read())

    svc.AggregationService.source, svc.ServedSource.on_committed = source_rec, committed_rec
    try:
        yield rec
    finally:
        svc.AggregationService.source, svc.ServedSource.on_committed = source, committed


def _drop_plan(closed_rounds) -> str:
    """The batch round's fault plan that drops the positions a served run
    masked, round by round."""
    return ";".join(f"client_drop@{c.rnd}:clients=" + "+".join(
        str(int(p)) for p in np.flatnonzero(c.arrived == 0.0))
        for c in closed_rounds if (c.arrived == 0.0).any())


def serve_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 14: the streaming aggregation service on ResNet-9 FetchSGD at
    full width; returns each kernel's launches over the served runs of (a)
    and (b)."""
    import shutil

    from commefficient_tpu_torch.obs import registry as obreg
    from commefficient_tpu_torch.utils import checkpoint as ckpt
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "serve")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    reg = obreg.default()
    out = {}

    def run(extra, label, batch=False):
        """One cv_train.main run; returns its record: session, round
        source (served runs), service, logged rows (less time_s), stage
        p50s, socket bytes, table-stack copies."""
        log = os.path.join(base, f"{label}.jsonl")
        argv = SLICE_ARGS + ["--num_rounds", str(SERVE_ROUNDS), "--sync_loop",
                             "--log_jsonl", log] + list(extra)
        for st in obreg.SERVE_STAGES:
            reg.histogram(f"serve_stage_{st}_ms").reset_window()
        mark = reg.mark()
        service_from_args = cv_train.service_from_args
        if batch:  # the same session, driven by the batch round: no service
            cv_train.service_from_args = lambda args, session: None
        try:
            with serving_runs() as rec:
                s = cv_train.main(argv)
        finally:
            cv_train.service_from_args = service_from_args
        torch.cuda.synchronize()
        rows = [json.loads(line) for line in open(log)]
        for r in rows:
            r.pop("time_s")
        svc, src = rec["runs"][0] if rec["runs"] else (None, None)
        info = {"s": s, "src": src, "svc": svc, "rows": rows, "metrics": rec["metrics"],
                "stages": {st: reg.histogram(f"serve_stage_{st}_ms").summary()["p50"]
                           for st in obreg.SERVE_STAGES} if svc is not None else None,
                "wire_bytes": mark.delta("serve_client_wire_bytes_total"),
                "copies": s.wire_copy_stats(), "round_ms": _steady_ms(s.run_stats)}
        print(f"serve {label}: steady round ms {info['round_ms']:.2f}"
              + (f", serve_stage_ms p50 {json.dumps(info['stages'])}" if svc else "")
              + (f", counters {json.dumps(svc.queue.counters())}" if svc else "")
              + f" [{card}]", flush=True)
        out[label] = info
        return info

    def same(a, b, keys=None) -> bool:
        """Bitwise: params, mode state, batch-norm statistics, the queue and
        its ages, and the eval rows (only ``keys`` of them after a resume,
        whose train-loss window starts at the resumed round)."""
        sa, sb = a["s"], b["s"]
        ra, rb = a["rows"], b["rows"]
        if keys is not None:
            ra, rb = ([{k: r[k] for k in keys} for r in x] for x in (ra, rb))
        return (_equal(_full_state(sa), _full_state(sb)) and ra == rb
                and list(sa._requeue_committed) == list(sb._requeue_committed)
                and sa._requeue_ages_committed == sb._requeue_ages_committed)

    # a. announce, inproc, against the batch round with the same drops
    kernels.reset_launch_counts()
    a = run(SERVE_ANNOUNCE, "announce_inproc")
    launches = {"announce_inproc": ravel_launches(kernels)}
    plan_a = _drop_plan(a["src"].closed_rounds)
    print(f"serve a: closes {[c.closed_by for c in a['src'].closed_rounds]}, batch twin plan "
          f"{plan_a!r}", flush=True)
    if not plan_a or any(n != SERVE_ROUNDS for n in launches["announce_inproc"].values()):
        fail(f"serve a: no casualties ({plan_a!r}) or launches {launches} not one a round")
    ab = run(SERVE_ANNOUNCE + ["--fault_plan", plan_a], "announce_batch", batch=True)
    if not same(a, ab):
        fail("serve a: the served announce run differs from the batch round with its drops")
    print("serve a: served announce == batch round with the same drops, bitwise (params, "
          "Vvelocity, Verror, batch-norm statistics, eval row, queue and ages); one launch of "
          "each kernel a round", flush=True)

    # b. sketch payload, inproc, against compose_payload with the same drops
    payload = ["--serve", "inproc"] + SERVE_PAYLOAD
    kernels.reset_launch_counts()
    b = run(payload + ["--fault_plan", SERVE_PLAN], "payload_inproc")
    launches["payload_inproc"] = lp = ravel_launches(kernels)
    counters = b["svc"].queue.counters()
    W = b["s"].num_workers
    checks = {
        f"accumulate launched {W} times a round": lp["sketch_accumulate"] == W * SERVE_ROUNDS,
        "query launched once a round": lp["sketch_query"] == SERVE_ROUNDS,
        "rejected_malformed >= 1": counters["rejected_malformed"] >= 1,
        "rejected_dup >= 1": counters["rejected_dup"] >= 1,
        "rejected_quarantined >= 1": counters["rejected_quarantined"] >= 1,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"serve b: {bad}; launches {lp}, counters {counters}")
    plan_b = _drop_plan(b["src"].closed_rounds)
    bb = run(payload + ["--fault_plan", plan_b], "payload_batch", batch=True)
    if not same(b, bb):
        fail("serve b: the served payload run differs from the batch payload round")
    print(f"serve b: held: {'; '.join(checks)} (launches {lp}); served payload == "
          f"compose_payload batch round with drops {plan_b!r}, bitwise", flush=True)
    s, _ = cv_train.build(resolve_defaults(make_parser().parse_args(SLICE_ARGS + payload)))
    batch, _ = engine.split_valid(s._to_device(s.prepare_round(0).batch))
    tables = s._payload_client(s.state, batch)[0]
    updates = engine.make_client_updates(s.train_loss_fn, s.cfg, s.layout)
    spec = s.cfg.mode.sketch_spec
    for w, u in enumerate(engine._clip_rows(s.cfg, updates(s.state, batch, None, range(W))[0])):
        got = csvec.sketch_vec(spec, u)
        compare(f"sketch_accumulate client {w}", got, csvec._sketch_vec_rotation(spec, u))
        if not torch.equal(got, tables[w]):
            fail(f"serve b: client {w}'s table in the client step differs from the kernel's "
                 "table of its recomputed update")
    print(f"serve b: each of the {W} per-client tables of round 0 == the plain sketch of its "
          "update, bitwise, and == the client step's table", flush=True)
    del s, batch, tables

    # c. the same over the socket, both engines
    for eng in ("eventloop", "threaded"):
        sock = ["--serve", "socket", "--serve_transport", eng] + SERVE_PAYLOAD
        c = run(sock + ["--fault_plan", SERVE_PLAN]
                + (["--serve_metrics_port", "0"] if eng == "eventloop" else []),
                f"payload_socket_{eng}")
        if not same(b, c):
            fail(f"serve c: the socket ({eng}) run differs from the inproc run")
        print(f"serve c: socket ({eng}) == inproc bitwise; client bytes on the wire "
              f"{c['wire_bytes'] / SERVE_ROUNDS:.0f} a round; counters "
              f"{json.dumps(c['svc'].queue.counters())}", flush=True)
    metrics = out["payload_socket_eventloop"]["metrics"]
    if not metrics or metrics.get("payload") != "sketch":
        fail(f"serve c: GET /metrics returned {metrics}")
    print(f"serve c: GET /metrics over HTTP: {json.dumps(metrics)}", flush=True)

    # d. preempt -> 75 -> resume, against (b)
    ck = os.path.join(base, "ck")
    pre = payload + ["--fault_plan", SERVE_PLAN + ";preempt@2", "--checkpoint_dir", ck]
    try:
        run(pre, "payload_preempted")
        fail("serve d: preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    path = ckpt.latest(ck)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if "serve" not in meta:
        fail(f"serve d: no serve block in {path}/meta.json")
    r = run(pre + ["--resume"], "payload_resumed")
    if not (r["s"].run_stats.rounds == SERVE_ROUNDS - 3
            and same(b, r, keys=("round", "test_loss", "test_acc", "comm_mb"))):
        fail("serve d: preempt -> resume differs from the uninterrupted served run")
    print(f"serve d: preempt@2 -> exit 75, checkpoint {os.path.basename(path)} with serve block "
          f"{json.dumps(meta['serve'])} -> resume == uninterrupted served run, bitwise",
          flush=True)
    shutil.rmtree(ck, ignore_errors=True)

    # e. numbers
    for label in ("announce_inproc", "payload_inproc", "payload_socket_eventloop",
                  "payload_socket_threaded"):
        i = out[label]
        print(f"serve e: {label}: serve_stage_ms p50 {json.dumps(i['stages'])}, steady round "
              f"ms {i['round_ms']:.2f} (batch twin: announce {ab['round_ms']:.2f}, payload "
              f"{bb['round_ms']:.2f}) [{card}]", flush=True)
    for direction, d in out["payload_inproc"]["copies"].items():
        print(f"serve e: [W, r, c] stack {direction}: {d['bytes'] / d['copies']:.0f} bytes, "
              f"{d['ms'] / d['copies']:.3f} ms a round ({d['copies']} copies) [{card}]",
              flush=True)
    busy = {k: profile_rounds(out[k]["s"], top=4, label=f" {k} [{card}]")
            for k in ("announce_batch", "payload_batch")}
    print(f"serve e: device busy ms a round: announce round {busy['announce_batch']:.2f}, "
          f"payload round {busy['payload_batch']:.2f} [{card}]", flush=True)
    return launches


def gpt2_phase(kernels, csvec, engine, time_ms, gen: torch.Generator, card: str,
               prof: dict) -> dict:
    """Phase 11: GPT-2 small PersonaChat fine-tuning through
    ``gpt2_train.main``; returns the kernels' fields at the GPT-2 shape and
    fills ``prof`` with its profile window's numbers."""
    import shutil

    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.data.personachat import load_personachat_fed
    from commefficient_tpu_torch.utils import checkpoint as ckpt
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "gpt2")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    args0 = resolve_defaults(make_parser("gpt2").parse_args(GPT2_ARGS))
    t0 = time.perf_counter()
    load_personachat_fed(args0.data_root, args0.num_clients, args0.seq_len, args0.seed)
    print(f"gpt2: synthetic corpus of {args0.num_clients:,} personas at seq_len "
          f"{args0.seq_len} built in {time.perf_counter() - t0:.1f} s (host)", flush=True)

    launch_log = {}

    def run(extra, label, mode="sketch"):
        log = os.path.join(base, f"{label}.jsonl")
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = gpt2_train.main(GPT2_ARGS + ["--num_rounds", str(GPT2_ROUNDS), "--log_jsonl", log,
                                         "--mode", mode, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ravel_launches(kernels)
        per_round = 1 if mode == "sketch" else 0
        if any(n != per_round * s.run_stats.rounds for n in launches.values()):
            fail(f"gpt2 {label}: launches {launches} in {s.run_stats.rounds} {mode} rounds, "
                 f"expected {per_round} per round")
        launch_log[label] = launches
        with open(log) as f:
            rows = [json.loads(line) for line in f]
        if not rows or not all(math.isfinite(r[k]) for r in rows
                               for k in ("train_nll", "val_nll")):
            fail(f"gpt2 {label}: non-finite or missing NLL in {rows}")
        print(f"gpt2 {label}: {s.run_stats.rounds} {mode} rounds in {wall:.1f} s (with start-up "
              f"and eval), launches {launches}, final row {rows[-1]}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        print(_times(f"gpt2 {label}", s.run_stats, card), flush=True)
        return s, rows[-1]

    def same(a, b):
        return _equal(_state(a), _state(b))

    def rows_equal(x, y, keys=("train_nll", "val_nll", "val_f1", "comm_mb")):
        return all(x[k] == y[k] for k in keys if k in x or k in y)

    # a. the model and its flat vector
    phase_t = time.perf_counter()
    f1 = ["--eval_f1", "4"]
    a, row_a = run(f1 + ["--sync_loop"], "sync")
    layout = a.layout
    vocab = next(leaf.shape[0] for leaf in layout.leaves if leaf.name == "wte")
    print(f"gpt2: d={layout.d:,} (first leaf {layout.leaves[0].name}, last "
          f"{layout.leaves[-1].name}), vocabulary {vocab}, {a.num_workers} clients of "
          f"{a.local_batch_size} rows a round", flush=True)
    if layout.d != GPT2_D:
        fail(f"gpt2: d={layout.d}, expected {GPT2_D}")

    # b. both kernels at this shape, bitwise and timed
    spec = a.cfg.mode.sketch_spec
    v = torch.randn(spec.d, generator=gen, device="cuda")
    errs = [max(e) for e in zip(check_kernels(csvec, spec, v),
                                check_kernels(csvec, spec, a.state["params"],
                                              a.state["mode_state"]["Verror"]))]
    print(f"gpt2: kernels == plain at d={spec.d} c={spec.c} r={spec.r} "
          f"({spec.num_slabs} slabs), on a random vector and on the run's params and error "
          "table", flush=True)
    times = time_kernels(csvec, kernels, time_ms, spec, gen)
    del v

    # c. sync against async, bitwise, with dropout on
    b, row_b = run(f1, "async")
    if not (same(a, b) and rows_equal(row_a, row_b)):
        fail("gpt2: the async run differs from the sync run")
    print(f"gpt2: async == sync bitwise over {GPT2_ROUNDS} rounds (params, Vvelocity, Verror; "
          f"eval row incl. val_f1 {row_b['val_f1']})", flush=True)

    # d. preempt -> exit 75 -> resume, bitwise against the uninterrupted run
    ck = os.path.join(base, "ck_preempt")
    chaos = ["--checkpoint_dir", ck, "--fault_plan", "preempt@2"]
    try:
        run(f1 + chaos, "preempted")
        fail("gpt2: preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    if ckpt.latest(ck) is None or not ckpt.latest(ck).endswith("round_00000003"):
        fail(f"gpt2: preemption checkpoint {ckpt.latest(ck)}")
    r_, row_r = run(f1 + chaos + ["--resume"], "resumed")
    if not (r_.run_stats.rounds == GPT2_ROUNDS - 3 and same(a, r_)
            and rows_equal(row_a, row_r, ("val_nll", "val_f1", "comm_mb"))):
        fail("gpt2: preempt -> resume differs from the uninterrupted run")
    print("gpt2: preempt@2 -> exit 75 -> resume == uninterrupted, bitwise, dropout on",
          flush=True)
    del r_
    shutil.rmtree(ck, ignore_errors=True)

    # e. one round at lr 0.1 against FetchSGD's algebra on the card
    print("gpt2: " + check_sketch_round(b, engine, csvec), flush=True)

    # g. greedy decodes of --eval_f1 4: bitwise equal in two calls
    args = resolve_defaults(make_parser("gpt2").parse_args(GPT2_ARGS + f1))
    _, valid_set, extras = gpt2_train.build(args)
    f1_eval = gpt2_train.F1Eval(args, extras["model"], extras["tok"], valid_set, b.device)
    (ids1, len1), (ids2, len2) = (f1_eval.decode(b.params(), 0) for _ in range(2))
    if not ((ids1 == ids2).all() and (len1 == len2).all()):
        fail("gpt2: two greedy decodes differ")
    print(f"gpt2: greedy decodes of {len(len1)} validation prompts bitwise equal in two calls "
          f"(generated lengths {(len1 - f1_eval.prompt_len).tolist()}), val_f1 "
          f"{f1_eval(b.params(), 0):.4f}", flush=True)
    del f1_eval, extras, valid_set

    # h. where a round's time goes
    busy = profile_rounds(b, top=10, label=f" gpt2 [{card}]", host_top=12, out=prof)
    del a, b

    # f. the uncompressed control, async against sync
    ua, row_ua = run(["--sync_loop", "--num_rounds", "2"], "control_sync", "uncompressed")
    ub, row_ub = run(["--num_rounds", "2"], "control_async", "uncompressed")
    if not (same(ua, ub) and rows_equal(row_ua, row_ub)):
        fail("gpt2: the uncompressed control's async run differs from its sync run")
    print("gpt2: uncompressed control, async == sync bitwise over 2 rounds", flush=True)
    print(f"gpt2: phase took {time.perf_counter() - phase_t:.1f} s; device busy {busy:.2f} "
          f"ms/round [{card}]", flush=True)
    return {name: {**times[name], "launches": launch_log["sync"][name],
                   "max_abs_err": errs[i], "d": spec.d, "c": spec.c, "r": spec.r}
            for i, name in enumerate(("sketch_accumulate", "sketch_query"))}


def write_hf_checkpoint(path: str, n_layer: int, n_embd: int, n_head: int, vocab: int,
                        positions: int, gen: torch.Generator) -> dict:
    """A GPT-2 checkpoint in HuggingFace's layout (``transformer.`` names,
    Conv1D weights [in, out], a tied ``lm_head``), random normal(0.02)
    weights and unit LayerNorm scales from ``gen``, written with
    ``torch.save`` beside its ``config.json``; returns the state dict."""
    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=gen)

    sd = {"transformer.wte.weight": normal(vocab, n_embd),
          "transformer.wpe.weight": normal(positions, n_embd),
          "transformer.ln_f.weight": 1.0 + normal(n_embd), "transformer.ln_f.bias": normal(n_embd)}
    for i in range(n_layer):
        h = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[h + ln + ".weight"], sd[h + ln + ".bias"] = 1.0 + normal(n_embd), normal(n_embd)
        for name, (fan_in, fan_out) in (("attn.c_attn", (n_embd, 3 * n_embd)),
                                        ("attn.c_proj", (n_embd, n_embd)),
                                        ("mlp.c_fc", (n_embd, 4 * n_embd)),
                                        ("mlp.c_proj", (4 * n_embd, n_embd))):
            sd[h + name + ".weight"] = normal(fan_in, fan_out)
            sd[h + name + ".bias"] = normal(fan_out)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"n_head": n_head, "n_layer": n_layer, "n_embd": n_embd,
                   "layer_norm_epsilon": 1e-5}, f)
    return sd


def check_loaded(params: dict, sd: dict, vocab: int) -> str:
    """The port's parameters loaded from ``sd`` against it, bitwise: every
    linear weight transposed back ([out, in] -> HF's [in, out]), ``wte``'s
    first ``vocab`` rows as written and the rows past them the mean row plus
    0.02 x ``RandomState(0)`` normals (the reference's formula, in numpy),
    ``wpe`` sliced to the run's positions. Returns a verdict; calls
    ``fail`` on any difference."""
    import numpy as np

    bad = []
    for name, p in params.items():
        if name == "mc_head":
            continue
        p = p.detach().cpu()
        if name == "wte":
            wte = sd["transformer.wte.weight"].numpy()
            extra = p.shape[0] - vocab
            grown = wte.mean(axis=0, keepdims=True) + 0.02 * np.random.RandomState(
                0).standard_normal((extra, wte.shape[1])).astype(np.float32)
            ok = (torch.equal(p[:vocab], torch.from_numpy(wte))
                  and torch.equal(p[vocab:], torch.from_numpy(grown)))
        elif name == "wpe":
            ok = torch.equal(p, sd["transformer.wpe.weight"][:p.shape[0]])
        else:
            hf = "transformer." + name.replace("h_", "h.", 1)
            want = sd[hf]
            ok = torch.equal(p.t() if p.dim() == 2 else p, want)
        if not ok:
            bad.append(name)
    if bad:
        fail(f"init_from: loaded params differ from the written checkpoint: {bad[:8]}")
    return (f"init_from: {len(params) - 1} loaded leaves equal the written checkpoint bitwise "
            f"(wte rows 0-{vocab - 1} as written, rows {vocab}-{params['wte'].shape[0] - 1} "
            "the reference's mean + RandomState(0) formula)")


def gemm_flag_ms(time_ms, card: str) -> str:
    """cuBLAS's reduced-precision reductions of bfloat16 products, on
    (torch's default) against off (the entry point's setting), in turns on
    the GPT-2 small MLP's widest product: [4096, 768] x [768, 3072], the
    rows of one client (8 sets of 2 candidates x 256 tokens)."""
    a = torch.randn(4096, 768, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(768, 3072, device="cuda", dtype=torch.bfloat16)
    flag = torch.backends.cuda.matmul
    was = flag.allow_bf16_reduced_precision_reduction
    ms = {True: [], False: []}
    try:
        for turn in range(4):
            on = turn % 2 == 0
            flag.allow_bf16_reduced_precision_reduction = on
            ms[on].append(time_ms(lambda: a @ b, 20, lambda: None))
        flag.allow_bf16_reduced_precision_reduction = True
        c_on = a @ b
        flag.allow_bf16_reduced_precision_reduction = False
        c_off = a @ b
    finally:
        flag.allow_bf16_reduced_precision_reduction = was
    exact = (a.double() @ b.double())
    err = {k: ((c.double() - exact).norm() / exact.norm()).item()
           for k, c in (("on", c_on), ("off", c_off))}
    tflops = 2 * 4096 * 768 * 3072 / (min(ms[False]) * 1e-3) / 1e12
    return (f"bf16 reduced-precision reductions: [4096, 768] x [768, 3072] ms on "
            f"{[round(t, 4) for t in ms[True]]}, off {[round(t, 4) for t in ms[False]]} "
            f"({tflops:.0f} TFLOP/s off); relative L2 error against float64: on "
            f"{err['on']:.3e}, off {err['off']:.3e} [{card}]")


def bf16_phase(cv_train, engine, csvec, kernels, time_ms, gen: torch.Generator, card: str,
               f32: dict) -> dict:
    """Phase 13: bfloat16 compute, the double head and --init_from through
    the entry points; ``f32`` holds this run's float32 readings (phase 9's
    and 11's profile windows). Returns the kernels' launch counts and their
    fields at the MC GPT-2 shape."""
    import shutil

    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.data.personachat import load_personachat_fed
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "bf16")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    launches = {}

    def counted(label, fn, rounds_per_run=1):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = fn()
        torch.cuda.synchronize()
        got = ravel_launches(kernels)
        if any(n != rounds_per_run * s.run_stats.rounds for n in got.values()):
            fail(f"bf16 {label}: launches {got} in {s.run_stats.rounds} rounds, expected "
                 f"{rounds_per_run} per round")
        launches[label] = got
        print(f"bf16 {label}: {s.run_stats.rounds} rounds in {time.perf_counter() - t0:.1f} s "
              f"(with start-up and eval), launches {got}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        print(_times(f"bf16 {label}", s.run_stats, card), flush=True)
        return s

    def rows_of(log):
        with open(log) as f:
            return [json.loads(line) for line in f]

    # a. ResNet-9 FetchSGD in bfloat16, sync and async
    res_args = SLICE_ARGS + ["--dtype", "bfloat16", "--num_rounds", str(BF16_ROUNDS)]
    logs = {k: os.path.join(base, f"resnet9_{k}.jsonl") for k in ("sync", "async")}
    a = counted("resnet9_sync", lambda: cv_train.main(
        res_args + ["--sync_loop", "--log_jsonl", logs["sync"]]))
    b = counted("resnet9_async", lambda: cv_train.main(res_args + ["--log_jsonl", logs["async"]]))
    ra, rb = rows_of(logs["sync"])[-1], rows_of(logs["async"])[-1]
    if not (_equal(_full_state(a), _full_state(b))
            and all(ra[k] == rb[k] for k in ("train_loss", "test_loss", "test_acc", "comm_mb"))):
        fail("bf16 resnet9: the async run differs from the sync run")
    if not all(math.isfinite(ra[k]) for k in ("train_loss", "test_loss")):
        fail(f"bf16 resnet9: non-finite loss in {ra}")
    print(f"bf16 resnet9: async == sync bitwise over {BF16_ROUNDS} rounds (params, Vvelocity, "
          f"Verror, batch-norm statistics, eval row {ra})", flush=True)
    del b
    check_kernels(csvec, a.cfg.mode.sketch_spec, a.state["params"], a.state["mode_state"]["Verror"])
    print("bf16 resnet9: kernels == plain on the run's params and error table", flush=True)
    # the card's bf16 gradient against the CPU port's, and against float32
    batch = a.prepare_round().batch
    g_card, _, m_card = engine.reduce_clients(a.train_loss_fn, a.cfg, a.layout, a.state,
                                              a._to_device(batch))
    cpu_state = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                     else v.cpu() if torch.is_tensor(v) else v) for k, v in a.state.items()}
    g_cpu, _, m_cpu = engine.reduce_clients(a.train_loss_fn, a.cfg, a.layout, cpu_state,
                                            dict(batch))
    f32_session, _ = cv_train.build(resolve_defaults(make_parser().parse_args(SLICE_ARGS)))
    g_f32, _, _ = engine.reduce_clients(f32_session.train_loss_fn, f32_session.cfg,
                                        f32_session.layout, a.state, a._to_device(batch))
    del f32_session
    cpu_rel = ((g_card.cpu() - g_cpu).norm() / g_cpu.norm()).item()
    gap = ((g_card - g_f32).norm() / g_f32.norm()).item()
    loss_rel = abs(m_card["loss_sum"].item() / m_cpu["loss_sum"].item() - 1)
    verdict = (f"bf16 resnet9: reduced gradient, card bf16 vs CPU bf16 relative L2 {cpu_rel:.3e} "
               f"(bound: the card's own bf16-vs-float32 gap {gap:.3e}; phase 7's float32 card "
               f"vs CPU bound {GRAD_REL_L2}), loss sum rel {loss_rel:.3e} (bound {BF16_LOSS_REL})")
    if not (cpu_rel < gap and loss_rel < BF16_LOSS_REL):
        fail(verdict)
    print(verdict, flush=True)
    prof_res = {}
    profile_rounds(a, top=6, label=f" bf16 resnet9 [{card}]", out=prof_res)
    print(f"bf16 resnet9: device busy {prof_res.get('busy_ms', 0.0):.2f} ms/round against "
          f"float32's {f32.get('resnet9_busy_ms', 0.0):.2f} (phase 9) [{card}]", flush=True)
    del a

    # b. GPT-2 small, the double head in bfloat16
    print(gemm_flag_ms(time_ms, card), flush=True)
    mc = GPT2_ARGS + ["--mc_coef", "1", "--num_candidates", "2", "--dtype", "bfloat16",
                      "--num_rounds", str(GPT2_ROUNDS)]
    args0 = resolve_defaults(make_parser("gpt2").parse_args(mc))
    t0 = time.perf_counter()
    load_personachat_fed(args0.data_root, args0.num_clients, args0.seq_len, args0.seed,
                         num_candidates=2)
    print(f"bf16 gpt2: MC corpus of {args0.num_clients:,} personas x 2 candidates at seq_len "
          f"{args0.seq_len} built in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    logs = {k: os.path.join(base, f"gpt2_{k}.jsonl") for k in ("sync", "async", "init")}
    s = counted("gpt2_mc_sync", lambda: gpt2_train.main(
        mc + ["--sync_loop", "--eval_f1", "4", "--log_jsonl", logs["sync"]]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if s.layout.d != GPT2_MC_D:
        fail(f"bf16 gpt2: d={s.layout.d}, expected {GPT2_MC_D}")
    t = counted("gpt2_mc_async", lambda: gpt2_train.main(
        mc + ["--eval_f1", "4", "--log_jsonl", logs["async"]]))
    rs, rt = rows_of(logs["sync"])[-1], rows_of(logs["async"])[-1]
    keys = ("train_nll", "val_nll", "mc_acc", "val_mc_acc", "val_f1", "comm_mb")
    if not all(math.isfinite(rs[k]) for k in keys):
        fail(f"bf16 gpt2: non-finite value in {rs}")
    if not (_equal(_state(s), _state(t)) and all(rs[k] == rt[k] for k in keys)):
        fail("bf16 gpt2: the async run differs from the sync run")
    print(f"bf16 gpt2: d={s.layout.d:,} (mc_head at {[l.name for l in s.layout.leaves][-3]}), "
          f"async == sync bitwise over {GPT2_ROUNDS} rounds; final row {rs}", flush=True)
    del t
    spec = s.cfg.mode.sketch_spec
    v = torch.randn(spec.d, generator=gen, device="cuda")
    errs = [max(e) for e in zip(check_kernels(csvec, spec, v),
                                check_kernels(csvec, spec, s.state["params"],
                                              s.state["mode_state"]["Verror"]))]
    del v
    print(f"bf16 gpt2: kernels == plain at d={spec.d} c={spec.c} r={spec.r} "
          f"({spec.num_slabs} slabs), on a random vector and on the run's params and error "
          "table", flush=True)
    times = time_kernels(csvec, kernels, time_ms, spec, gen)
    prof = {}
    profile_rounds(s, top=12, label=f" bf16 gpt2 mc [{card}]", host_top=8, out=prof)
    print(f"bf16 gpt2: device busy {prof.get('busy_ms', 0.0):.2f} ms/round, matrix products "
          f"{prof.get('gemm_ms', 0.0):.2f}, peak device memory {peak_gb:.2f} GB; float32 LM "
          f"(phase 11): busy {f32.get('gpt2_busy_ms', 0.0):.2f}, matrix products "
          f"{f32.get('gpt2_gemm_ms', 0.0):.2f} [{card}]", flush=True)
    del s

    # c. --init_from a checkpoint in HuggingFace's layout
    ckpt_dir = os.path.join(base, "hf_gpt2_small")
    t0 = time.perf_counter()
    sd = write_hf_checkpoint(ckpt_dir, 12, 768, 12, INIT_VOCAB, 1024,
                             torch.Generator().manual_seed(0))
    init = mc[:mc.index("--num_rounds")] + ["--num_rounds", str(INIT_ROUNDS), "--init_from",
                                            ckpt_dir]
    session, _, _ = gpt2_train.build(resolve_defaults(make_parser("gpt2").parse_args(init)))
    print(check_loaded(session.params(), sd, INIT_VOCAB) + f" ({time.perf_counter() - t0:.1f} s "
          "to write and load)", flush=True)
    del session
    u = counted("init_from", lambda: gpt2_train.main(init + ["--log_jsonl", logs["init"]]))
    ru = rows_of(logs["init"])[-1]
    if not all(math.isfinite(ru[k]) for k in ("train_nll", "val_nll", "mc_acc")):
        fail(f"bf16 init_from: non-finite value in {ru}")
    print(f"bf16 init_from: {INIT_ROUNDS} rounds from the checkpoint, final row {ru}", flush=True)
    del u, sd
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"launches": launches,
            "gpt2_mc": {name: {**times[name], "launches": launches["gpt2_mc_sync"][name],
                               "max_abs_err": errs[i], "d": spec.d, "c": spec.c, "r": spec.r}
                        for i, name in enumerate(("sketch_accumulate", "sketch_query"))}}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def round_agreement(a: dict, b: dict, p0: torch.Tensor) -> tuple[float, float, int]:
    """Two top-k rounds from one state whose gradients differ by rounding:
    (the share of b's moved coordinates that a moved too, the rel L2 of a's
    movement against b's on the coordinates both moved, the coordinates one
    moved and the other did not). A near-tie at the k-th estimate swaps
    between the two; their state differs by whole steps there."""
    ma, mb = a["params"] != p0, b["params"] != p0
    both = ma & mb
    agree = (both.sum() / mb.sum().clamp_min(1)).item()
    rel = _rel_l2(a["params"][both] - p0[both], b["params"][both] - p0[both])
    return agree, rel, int((ma ^ mb).sum())


def _client_rows(session, engine, batch: dict, chunk: int) -> tuple:
    """The cohort's per-client updates and metric sums as ``client_chunk`` =
    ``chunk`` computes them (0: one vmap of all W; C: W / C vmaps)."""
    updates = engine.make_client_updates(session.train_loss_fn, session.cfg, session.layout)
    W = next(iter(batch.values())).shape[0]
    C = chunk or W
    outs = [updates(session.state, {k: v[lo:lo + C] for k, v in batch.items()}, None,
                    range(lo, lo + C)) for lo in range(0, W, C)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[2]["loss_sum"] for o in outs])


def timed_pairs(sessions: dict, pairs: int, card: str) -> None:
    """Sync rounds of ``sessions`` in turns (a, b, then b, a, ...), each
    batch prepared first: per label the host ms of the dispatch (the round's
    launches, from the call to its return) and of the round (dispatch to
    the device's end), then a profiler window of 1 round (the profiler's
    post-processing of a per-client loop's tens of thousands of events takes
    seconds a round): device busy, matrix products and kernel launches a
    round; prints them."""
    out = {label: {"dispatch_ms": [], "round_ms": []} for label in sessions}
    order = list(sessions)
    for i in range(pairs):
        for label in (order if i % 2 == 0 else order[::-1]):
            s = sessions[label]
            prep = s.prepare_round()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infl = s.dispatch_round(prep, 0.01)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            s.commit_round(infl)
            out[label]["dispatch_ms"].append((t1 - t0) * 1e3)
            out[label]["round_ms"].append((t2 - t0) * 1e3)
    for label, s in sessions.items():
        prof = {}
        profile_rounds(s, rounds=1, top=0, label=f" {label} [{card}]", out=prof)
        r = out[label]
        r.update(prof)
        busy, gemm = r.get("busy_ms", 0.0), r.get("gemm_ms", 0.0)
        print(f"batched {label}: sync, {pairs} rounds in turns: host dispatch ms "
              f"{[round(t, 2) for t in r['dispatch_ms']]} (median "
              f"{statistics.median(r['dispatch_ms']):.2f}), round ms "
              f"{[round(t, 2) for t in r['round_ms']]} (median "
              f"{statistics.median(r['round_ms']):.2f}); device busy {busy:.2f} ms a round, "
              f"matrix products {gemm:.2f}, the rest {busy - gemm:.2f}; "
              f"{r.get('launches', 0.0):.0f} kernel launches a round [{card}]", flush=True)


def batched_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 15: the batched client phase (one ``torch.func.vmap`` over the
    cohort, ``--client_chunk``) at full width through the entry points'
    build functions; returns each kernel's launches a round, by run."""
    import warnings

    launches = {}
    # a batching rule functorch lacks falls back to a loop over the clients,
    # with this warning
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _batched_runs(cv_train, engine, csvec, kernels, card, launches)
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = sorted({str(w.message)[:160] for w in caught if "fallback" in str(w.message)})
    if fallbacks:
        fail(f"batched: vmap fell back to a loop: {fallbacks}")
    print("batched: no vmap batching-rule fallback on any model's step", flush=True)
    return launches


def _batched_runs(cv_train, engine, csvec, kernels, card: str, launches: dict) -> None:
    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    lr = CHECK_LR

    def counted_round(label, s):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        s.run_round(lr)
        torch.cuda.synchronize()
        got = ravel_launches(kernels)
        launches[label] = got
        if any(n != 1 for n in got.values()):
            fail(f"batched {label}: launches {got} in one sketch round, expected 1 each")
        return torch.cuda.max_memory_allocated() / 1e9

    # a. ResNet-9 FetchSGD at chunk 0, 4 and 1
    sessions = {c: cv_train.build(resolve_defaults(make_parser().parse_args(
        SLICE_ARGS + ["--client_chunk", str(c)])))[0] for c in BATCH_CHUNKS}
    s0 = sessions[0]
    p0 = s0.state["params"].clone()
    rng_state = s0.rng.get_state()
    batch, _ = engine.split_valid(s0._to_device(s0.prepare_round().batch))
    s0.rng.set_state(rng_state)
    rows = {c: _client_rows(s0, engine, batch, c) for c in BATCH_CHUNKS}
    grad_rel = {c: max(_rel_l2(rows[c][0][w], rows[1][0][w]) for w in range(len(rows[1][0])))
                for c in BATCH_CHUNKS}
    loss_rel = {c: max(abs(a / b - 1) for a, b in zip(rows[c][1].tolist(), rows[1][1].tolist()))
                for c in BATCH_CHUNKS}
    host_batch = s0.prepare_round().batch
    s0.rng.set_state(rng_state)
    reduced = {c: engine.reduce_clients(s.train_loss_fn, s.cfg, s.layout, s.state,
                                        s._to_device(host_batch))[0]
               for c, s in sessions.items()}
    reduced_rel = {c: _rel_l2(reduced[c], reduced[1]) for c in BATCH_CHUNKS}
    check_kernels(csvec, s0.cfg.mode.sketch_spec, reduced[0], s0.state["mode_state"]["Verror"])
    del rows, reduced
    peak = {c: counted_round(f"resnet9_chunk{c}", s) for c, s in sessions.items()}
    agree = {c: round_agreement(_state(s), _state(sessions[1]), p0)
             for c, s in sessions.items()}
    verdict = (f"batched resnet9: against chunk 1, per-client loss sums worst rel "
               f"{json.dumps(loss_rel)} (bound {FWD_REL}), per-client gradients worst rel L2 "
               f"{json.dumps(grad_rel)} (bound {CLIENT_GRAD_REL}), the cohort's reduced "
               f"gradient rel L2 {json.dumps(reduced_rel)} (bound {GRAD_REL_L2}); a round at lr "
               f"{lr} from one state and cohort: (top-k agreement, moved params rel L2 on the "
               f"coordinates both moved, swaps) {json.dumps(agree)} (bounds {TOPK_AGREE}, "
               f"{GRAD_REL_L2}); launches {launches}; peak device memory GB "
               f"{json.dumps({c: round(v, 2) for c, v in peak.items()})}")
    if not (max(loss_rel.values()) < FWD_REL and max(grad_rel.values()) < CLIENT_GRAD_REL
            and max(reduced_rel.values()) < GRAD_REL_L2
            and min(a[0] for a in agree.values()) >= TOPK_AGREE
            and max(a[1] for a in agree.values()) < GRAD_REL_L2):
        fail(verdict)
    print(verdict + "; kernels == plain on the chunk-0 reduced gradient and error table",
          flush=True)
    timed_pairs({"resnet9 chunk 0": sessions[0], "resnet9 chunk 1": sessions[1]}, BATCH_PAIRS,
                card)
    del sessions, s0, batch

    # b. GPT-2 small at full width: LM float32 and the double head in bfloat16
    mc = ["--mc_coef", "1", "--num_candidates", "2", "--dtype", "bfloat16"]
    for name, extra, grad_bound, loss_bound in (("gpt2_lm", [], CLIENT_GRAD_REL, FWD_REL),
                                                ("gpt2_mc_bf16", mc, BF16_GRAD_REL,
                                                 BF16_LOSS_REL)):
        sessions, peak = {}, {}
        for c in GPT2_CHUNKS:
            args = resolve_defaults(make_parser("gpt2").parse_args(
                GPT2_ARGS + extra + ["--client_chunk", str(c)]))
            sessions[c], _, extras = gpt2_train.build(args)
        keep = 1.0 - extras["model"].cfg.dropout
        del extras
        s0 = sessions[0]
        rng_state = s0.rng.get_state()
        batch, _ = engine.split_valid(s0._to_device(s0.prepare_round().batch))
        s0.rng.set_state(rng_state)
        W = next(iter(batch.values())).shape[0]
        loss_fn, cfg, rnd = s0.train_loss_fn, s0.cfg, s0.state["round"]
        stacked = engine._draw_masks(loss_fn, cfg, rnd, range(W), 0, batch, s0.device)
        for w in range(W):
            one = engine._draw_masks(loss_fn, cfg, rnd, range(w, w + 1), 0,
                                     {k: v[w:w + 1] for k, v in batch.items()}, s0.device)
            # the embedding's mask, as the forward draws it from the generator
            direct = torch.rand(stacked[0][w].shape, device=s0.device,
                                generator=cfg.generator(rnd, w, 0, s0.device)) < keep
            if not (all(torch.equal(a[w], b[0]) for a, b in zip(stacked, one))
                    and torch.equal(stacked[0][w], direct)):
                fail(f"batched {name}: client {w}'s dropout masks under the vmap differ from "
                     "its generator's")
        n_masks = len(stacked)
        del stacked, one, direct
        r0, r1 = _client_rows(s0, engine, batch, 0), _client_rows(s0, engine, batch, 1)
        grad_rel = max(_rel_l2(r0[0][w], r1[0][w]) for w in range(W))
        loss_rel = max(abs(a / b - 1) for a, b in zip(r0[1].tolist(), r1[1].tolist()))
        del r0, r1, batch
        for c, s in sessions.items():
            peak[c] = counted_round(f"{name}_chunk{c}", s)
        verdict = (f"batched {name}: the {n_masks} dropout masks of each of the {W} clients "
                   f"under the vmap == its (round, slot, step) generator's, bitwise; per-client "
                   f"gradient chunk 0 against chunk 1 worst rel L2 {grad_rel:.3e} (bound "
                   f"{grad_bound}), loss sum rel {loss_rel:.3e} (bound {loss_bound}); launches "
                   f"{ {c: launches[f'{name}_chunk{c}'] for c in GPT2_CHUNKS} }; peak device "
                   f"memory GB a round (the three sessions' states live) "
                   f"{json.dumps({c: round(v, 2) for c, v in peak.items()})} [{card}]")
        if not (grad_rel < grad_bound and loss_rel < loss_bound):
            fail(verdict)
        print(verdict, flush=True)
        timed_pairs({f"{name} chunk 0": sessions[0], f"{name} chunk 1": sessions[1]},
                    BATCH_PAIRS, card)
        del sessions, s0


@contextlib.contextmanager
def recording_health(engine):
    """Inside the block, every health block the engine computes records its
    raw aggregate table (a copy), the CUDA events around the block and the
    device memory before it and at its peak (the peak statistics are reset
    just before the block)."""
    rec = []
    orig = engine._health_metrics

    def health(cfg, raw_agg, *a, **kw):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0.record()
        out = orig(cfg, raw_agg, *a, **kw)
        t1.record()
        rec.append({"table": raw_agg["table"].clone(), "events": (t0, t1), "base": base,
                    "peak": torch.cuda.max_memory_allocated()})
        return out

    engine._health_metrics = health
    try:
        yield rec
    finally:
        engine._health_metrics = orig


def _capture_kernels(path: str) -> Counter:
    """Device kernel launches by name in an exported torch.profiler trace."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    return Counter(e["name"] for e in evs if e.get("cat") == "kernel")


def obs_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 16: the observability layer on the card; returns each kernel's
    launches over (a)'s armed run, (d)'s GPT-2 health run and (e)'s served
    payload run."""
    import dataclasses
    import shutil

    from commefficient_tpu_torch import gpt2_train, obs
    from commefficient_tpu_torch.obs import ledger as tledger
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    phase_t = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke", "obs")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    launches = {}

    def run(extra, label, main=cv_train.main, argv0=SLICE_ARGS, rounds=OBS_ROUNDS):
        log = os.path.join(base, f"{label}.jsonl")
        s = main(argv0 + ["--num_rounds", str(rounds), "--log_jsonl", log] + list(extra))
        torch.cuda.synchronize()
        rows = [json.loads(line) for line in open(log)]
        for r in rows:
            r.pop("time_s")
        return s, rows

    def armed(tag):
        return ["--trace", os.path.join(base, f"{tag}.trace.json"), "--trace_events",
                os.path.join(base, f"{tag}.events.jsonl"), "--health_every", "2", "--ledger",
                os.path.join(base, f"{tag}.ledger.jsonl"), "--slo", "warn"]

    # a. armed against plain, bitwise; the trace, the capture, the blocks
    plain, rows_p = run([], "plain")
    pdir = os.path.join(base, "prof")
    kernels.reset_launch_counts()
    with recording_health(engine) as hrec:
        arm, rows_a = run(armed("a") + ["--profile_rounds", "2:3", "--profile_dir", pdir],
                          "armed")
    launches["armed"] = la = ravel_launches(kernels)
    if not (_equal(_full_state(plain), _full_state(arm)) and rows_p == rows_a):
        fail("obs a: the armed run differs from the plain run")
    health_rounds = [r for r in range(OBS_ROUNDS) if r % 2 == 0]
    want = {"sketch_accumulate": OBS_ROUNDS, "sketch_query": OBS_ROUNDS + len(health_rounds)}
    if la != want:
        fail(f"obs a: launches {la}, expected {want} (one query more a health round)")
    with open(os.path.join(base, "a.trace.json")) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e["ph"] != "M"]
    spans = Counter((e["cat"], e["name"]) for e in evs)
    device = sorted((e["args"]["round_first"], e["args"]["rounds"]) for e in evs
                    if e["cat"] == "device")
    if (any(spans[("runner", p)] < 1 for p in ("prepare", "dispatch", "drain", "commit", "eval"))
            or [r for f, n in device for r in range(f, f + n)] != list(range(OBS_ROUNDS))):
        fail(f"obs a: the trace lacks runner spans or device spans: {spans}, {device}")
    (cap,) = os.listdir(pdir)
    first, last = (int(x) for x in cap.split(".")[0].split("_")[1:3])
    got = _capture_kernels(os.path.join(pdir, cap))
    cap_acc = sum(n for k, n in got.items() if "accumulate_tiles" in k)
    cap_query = sum(n for k, n in got.items() if "query_tiles" in k)
    covered = range(first, last + 1)
    want_q = len(covered) + sum(1 for r in covered if r % 2 == 0)
    if (cap_acc, cap_query) != (len(covered), want_q):
        fail(f"obs a: the capture of rounds {first}..{last} holds accumulate_tiles "
             f"{cap_acc}x and query_tiles {cap_query}x, expected {len(covered)} and {want_q}")
    blocks = list(arm.health_monitor.history)
    if [r for r, _ in blocks] != health_rounds:
        fail(f"obs a: health blocks on rounds {[r for r, _ in blocks]}, not {health_rounds}")
    for r, b in blocks:
        gap = abs(b["topk_mass_proxy"] - b["topk_mass_true"])
        print(f"obs a: round {r}: topk_mass_proxy {b['topk_mass_proxy']:.4f} (width "
              f"{b['topk_proxy_width']:.4f}) against topk_mass_true {b['topk_mass_true']:.4f}, "
              f"gap {gap:.4f}; row_mass_cv {b['row_mass_cv']:.4f}, occupancy "
              f"{b['table_occupancy']:.4f}, verror_ratio {b['verror_ratio']:.4f}", flush=True)
        if not gap <= 0.05:
            fail(f"obs a: round {r}'s recall proxy is {gap:.4f} from the truth (bar 0.05)")
    spec = arm.cfg.mode.sketch_spec
    for h in hrec:
        compare("sketch_query on a health round's raw table", csvec.query_all(spec, h["table"]),
                csvec._query_all_rotation(spec, h["table"]))
    led = os.path.join(base, "a.ledger.jsonl")
    arm2, _ = run(armed("a2"), "armed2")
    codes = (tledger.main(["replay-check", led]),
             tledger.main(["diff", led, os.path.join(base, "a2.ledger.jsonl")]))
    if codes != (0, 0):
        fail(f"obs a: ledger replay-check / diff exit {codes}")
    print(f"obs a: armed run (--trace --trace_events --health_every 2 --ledger --slo warn "
          f"--profile_rounds 2:3) == plain run bitwise; launches {la}; {len(evs)} trace events, "
          f"device spans {device}; capture of rounds {first}..{last}: accumulate_tiles "
          f"{cap_acc}x, query_tiles {cap_query}x; health blocks on rounds {health_rounds}; the "
          "health rounds' raw-table queries == plain bitwise; ledger replay-check 0, diff "
          "against a second armed run 0", flush=True)
    del plain, arm, arm2, hrec

    # b. preempt -> 75 -> resume with --ledger, and the exit-75 bundle
    ck, led_b = os.path.join(base, "ck"), os.path.join(base, "b.ledger.jsonl")
    pre = ["--ledger", led_b, "--trace", os.path.join(base, "b.trace.json"),
           "--checkpoint_dir", ck, "--fault_plan", "preempt@2"]
    try:
        run(pre, "preempted")
        fail("obs b: preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    bundle = led_b + ".postmortem"
    have = sorted(os.listdir(bundle))
    with open(os.path.join(bundle, "reason.json")) as f:
        reason = json.load(f)
    if (have != ["config.json", "ledger_tail.jsonl", "reason.json", "registry.json",
                 "trace.json"] or reason["reason"] != "preemption"
            or reason["artifact_failures"] is not None):
        fail(f"obs b: the exit-75 bundle holds {have}, reason {reason}")
    r_, _ = run(pre + ["--resume"], "resumed")
    recs = tledger.round_records(led_b)
    if tledger.replay_check(led_b) or [r["round"] for r in recs] != list(range(OBS_ROUNDS)):
        fail(f"obs b: the resumed ledger is not gap-free: {[r['round'] for r in recs]}")
    print(f"obs b: preempt@2 -> exit 75 (bundle {have}, reason preemption) -> resume: one "
          f"ledger, rounds {[r['round'] for r in recs]}, no gaps or duplicates", flush=True)
    del r_
    shutil.rmtree(ck, ignore_errors=True)

    # c. the sync probe, armed
    led_c = os.path.join(base, "c.ledger.jsonl")
    print("obs c: --trace --health_every 1 --ledger:", end=" ", flush=True)
    sync_probe(cv_train, SLICE_ARGS + ["--trace", os.path.join(base, "c.trace.json"),
                                       "--health_every", "1", "--ledger", led_c])
    recs = tledger.round_records(led_c)
    if len(recs) != 5 or not all(r["health"] and r["fingerprint"] for r in recs):
        fail(f"obs c: the probe's ledger holds {len(recs)} rounds with health and fingerprints")

    # d. GPT-2: the chunked split estimator at d = 85,453,056
    kernels.reset_launch_counts()
    with recording_health(engine) as hrec:
        g, _ = run(["--sync_loop", "--health_every", "1"], "gpt2", gpt2_train.main, GPT2_ARGS, 2)
    launches["gpt2_health"] = lg = ravel_launches(kernels)
    if lg != {"sketch_accumulate": 2, "sketch_query": 4}:
        fail(f"obs d: launches {lg}, expected 2 accumulates and 4 queries")
    for r, b in g.health_monitor.history:
        bad = [k for k, v in b.items() if not np.isfinite(v).all()]
        if bad:
            fail(f"obs d: GPT-2 round {r}'s health block is not finite: {bad}")
        print(f"obs d: GPT-2 round {r}: topk_mass_proxy {b['topk_mass_proxy']:.4f} (width "
              f"{b['topk_proxy_width']:.4f}) against topk_mass_true {b['topk_mass_true']:.4f}; "
              f"{len(b['leaf_norms'])} leaf norms", flush=True)
    torch.cuda.synchronize()
    hms = [h["events"][0].elapsed_time(h["events"][1]) for h in hrec]
    hgb = [(h["peak"] - h["base"]) / 1e9 for h in hrec]
    spec = g.cfg.mode.sketch_spec
    chunk = max(g.cfg.mode.k, csvec.UNSKETCH_SINGLE_SHOT_BYTES // (4 * spec.r))
    del hrec

    def timed_round(session) -> tuple:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        session.run_round(0.01)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1), torch.cuda.max_memory_allocated() / 1e9

    cfg_on = g.cfg
    turns = {"health": [], "off": []}
    for label in ("off", "health", "off", "health"):
        g.cfg = cfg_on if label == "health" else dataclasses.replace(cfg_on, health=False)
        g._build_steps()
        turns[label].append(timed_round(g))
    print(f"obs d: GPT-2 health block (chunked split estimator, chunks of {chunk:,} "
          f"coordinates, {math.ceil(spec.d / chunk)} chunks): device ms between its events "
          f"{[round(t, 2) for t in hms]}, transient peak above the round's live memory "
          f"{[round(x, 2) for x in hgb]} GB; a whole round (device ms, peak GB) with the "
          f"block {turns['health']} against without {turns['off']} [{card}]", flush=True)
    del g

    # e. served payload rounds: the health block == the batch payload round's
    payload = ["--sync_loop", "--serve", "inproc"] + SERVE_PAYLOAD + ["--health_every", "1"]
    kernels.reset_launch_counts()
    with serving_runs() as rec:
        served, _ = run(payload, "served", rounds=SERVE_ROUNDS)
    launches["served_health"] = ls = ravel_launches(kernels)
    W = served.num_workers
    if ls != {"sketch_accumulate": W * SERVE_ROUNDS, "sketch_query": 2 * SERVE_ROUNDS}:
        fail(f"obs e: launches {ls}, expected {W} accumulates and 2 queries a round")
    plan = _drop_plan(rec["runs"][0][1].closed_rounds)
    service_from_args = cv_train.service_from_args
    cv_train.service_from_args = lambda args, session: None
    try:
        batch, _ = run(payload + (["--fault_plan", plan] if plan else []), "served_batch",
                       rounds=SERVE_ROUNDS)
    finally:
        cv_train.service_from_args = service_from_args
    hs, hb = list(served.health_monitor.history), list(batch.health_monitor.history)
    if hs != hb or len(hs) != SERVE_ROUNDS or not _equal(_full_state(served),
                                                         _full_state(batch)):
        fail("obs e: the served payload rounds' health blocks differ from the batch twin's")
    print(f"obs e: served payload, {SERVE_ROUNDS} rounds with health: every block == the batch "
          f"payload round's (drops {plan!r}) bitwise; launches {ls}", flush=True)
    del served, batch

    # f. round ms, armed against plain, in turns
    def session(extra):
        args = resolve_defaults(make_parser().parse_args(SLICE_ARGS + list(extra)))
        s, _ = cv_train.build(args)
        return s, obs.attach_from_args(args, s)

    trace_f = os.path.join(base, "f.trace.json")
    (sp, _), (sa, wa) = session([]), session(armed("f"))
    ms = {"plain": [], "armed, off cadence": [], "armed, health round": []}
    for s in (sp, sa):
        s.run_round(0.01)  # warm
    torch.cuda.synchronize()
    for _ in range(OBS_PAIRS * 2):
        for label, s in (("plain", sp), ("armed", sa)):
            obs.trace.configure(trace_f if s is sa else None)
            if s is sa:
                label = "armed, health round" if s.round % 2 == 0 else "armed, off cadence"
            t0 = time.perf_counter()
            s.run_round(0.01)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3)
    obs.trace.configure()
    wa.close()
    print("obs f: sync round ms (prepare, dispatch, commit, synchronize), in turns: "
          + "; ".join(f"{k} {[round(t, 2) for t in v]} (median {statistics.median(v):.2f})"
                      for k, v in ms.items()) + f" [{card}]", flush=True)
    del sp, sa
    print(f"obs: phase took {time.perf_counter() - phase_t:.1f} s [{card}]", flush=True)
    return launches


def robust_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 17: robust merges and the sketch-space quarantine on ResNet-9
    FetchSGD at full width; returns each kernel's launches over the attacked
    runs of (a) and the quarantine run of (b)."""
    import dataclasses
    import shutil

    from commefficient_tpu_torch.modes import modes
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "robust")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    launches = {}

    def run(extra, label, rounds=ROBUST_ROUNDS, count=False):
        argv = SLICE_ARGS + ["--num_rounds", str(rounds), "--sync_loop"] + list(extra)
        if count:
            kernels.reset_launch_counts()
        with recording_rounds() as rec:
            s = cv_train.main(argv)
        torch.cuda.synchronize()
        if count:
            launches[label] = ravel_launches(kernels)
        return s, rec

    def build(extra):
        return cv_train.build(resolve_defaults(make_parser().parse_args(SLICE_ARGS + extra)))[0]

    # a. the sum, trimmed and median table rounds under the same attacks,
    # against a clean run: the sum drifts furthest
    clean, _ = run([], "clean")
    W = clean.num_workers
    p0 = _initial_params("cifar10", clean.device)
    moved = (clean.state["params"] - p0).norm().item()
    dist = {}
    for pol, flags in ROBUST_POLICIES.items():
        s, rec = run(flags + ["--fault_plan", ATTACK_PLAN], pol, count=True)
        want = {"sketch_accumulate": W * ROBUST_ROUNDS, "sketch_query": ROBUST_ROUNDS}
        if not s._table_round or launches[pol] != want:
            fail(f"robust a: {pol}: table round {s._table_round}, launches {launches[pol]} "
                 f"(want {want})")
        if not torch.isfinite(s.state["params"]).all():
            fail(f"robust a: {pol}: non-finite params")
        dist[pol] = (s.state["params"] - clean.state["params"]).norm().item()
        del s
    print(f"robust a: {ROBUST_ROUNDS} rounds under {ATTACK_PLAN!r}: params L2 distance from "
          f"the clean run {json.dumps({k: round(v, 6) for k, v in dist.items()})} (the clean "
          f"run moved {moved:.6f} from its initial params); launches a run {launches['sum']} "
          f"[{card}]", flush=True)
    if not dist["sum"] > max(dist["trimmed"], dist["median"]):
        fail(f"robust a: the sum run did not drift furthest from the clean run ({dist})")
    del clean

    # the robust merge of one attacked round's [W, r, c] stack on the card
    # against the same merge of a CPU copy, bitwise; the stack on the card
    # is (e)'s input
    s = build(ROBUST_POLICIES["median"] + ["--fault_plan", ATTACK_PLAN])
    batch = s._to_device(s.prepare_round(1).batch)  # round 1: client 1 sends 50x
    tables, _, _, live, _ = s._payload_client(s.state, batch)
    spec = s.cfg.mode.sketch_spec
    cpu_tables, cpu_live = tables.cpu(), live.cpu()
    for pol, trim in (("median", 0), ("trimmed", 1)):
        for resid in (False, True):
            got = modes._robust_table_merge(spec, tables, live, pol, trim, want_residual=resid)
            want = modes._robust_table_merge(spec, cpu_tables, cpu_live, pol, trim,
                                             want_residual=resid)
            pairs = ([(got, want)] if not resid
                     else [(got[0], want[0]), (got[2]["residual"], want[2]["residual"])])
            for g, w in pairs:
                if not torch.equal(g.cpu(), w):
                    fail(f"robust a: the {pol} merge (residual {resid}) on the card differs "
                         f"from its CPU run (max abs {(g.cpu() - w).abs().max().item()})")
    print(f"robust a: the {tuple(tables.shape)} stack of round 1 merged on the card == its "
          "CPU run, bitwise (median and trimmed 1, plain and with the residual)", flush=True)

    # e. the merge's cost: sum, trimmed and median on one state and cohort,
    # in turns: a round (client step + merge) and the merge alone, by CUDA
    # events, and the round's peak memory above the state
    steps, merges = {}, {}
    for pol, kw in (("sum", dict(merge_policy="sum", merge_trim=0)),
                    ("trimmed", dict(merge_policy="trimmed", merge_trim=1)),
                    ("median", dict(merge_policy="median", merge_trim=0))):
        cfg = dataclasses.replace(s.cfg, **kw)
        steps[pol] = engine.compose_payload(*engine.make_payload_round_steps(
            s.train_loss_fn, cfg, s.layout))
        rp = engine.robust_policy(cfg)
        merges[pol] = (lambda rp=rp, t=kw["merge_trim"]: modes.merge_partial_wires(
            s.cfg.mode, {"table": tables}, policy=rp, live=live, trim=t) if rp else
            modes.merge_partial_wires(s.cfg.mode, {"table": modes.mask_rows(live, tables)}))
    lr = torch.tensor(0.01, device=s.device)
    cost = {p: {"round_ms": [], "merge_ms": [], "peak_mb": []} for p in steps}
    for _ in range(ROBUST_PAIRS + 1):  # the first turn warms up and is dropped
        for pol in steps:
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            e0.record()
            steps[pol](s.state, batch, {}, lr)
            e1.record()
            merges[pol]()
            e2.record()
            e2.synchronize()
            cost[pol]["round_ms"].append(e0.elapsed_time(e1))
            cost[pol]["merge_ms"].append(e1.elapsed_time(e2))
            cost[pol]["peak_mb"].append((torch.cuda.max_memory_allocated() - base_mem) / 2**20)
    med = {p: {k: statistics.median(v[1:]) for k, v in c.items()} for p, c in cost.items()}
    for pol, m in med.items():
        print(f"robust e: {pol}: round {m['round_ms']:.3f} ms, merge {m['merge_ms']:.4f} ms "
              f"(device, CUDA events), peak memory {m['peak_mb']:.1f} MiB above the state "
              f"(medians of {ROBUST_PAIRS} turns) [{card}]", flush=True)
    # the merge's order statistics, in turns: on this stack, the sort along
    # dim 0 against one along the last dim after a transposed copy; at each
    # W of RANK_COHORTS (this stack at 8, seeded ones of its row width), the
    # trimmed mean's keep mask three ways: read off the sorted values (the
    # port's), from ranks by counting (W passes), and from a stable sort and
    # an argsort of its order (the reference's); and the whole trimmed merge
    def counted_ranks(keyed):
        ranks = torch.zeros(keyed.shape, dtype=torch.int32, device=keyed.device)
        for j in range(keyed.shape[0]):
            ranks += keyed[j] < keyed
            ranks[j + 1:] += keyed[j] == keyed[j + 1:]
        return ranks

    def window(ranks, n):
        return (ranks >= 1) & (ranks < n - 1)

    def timed(fns):
        got = {k: f() for k, f in fns.items()}
        ms = {k: [] for k in fns}
        for _ in range(ROBUST_PAIRS):
            for k, f in fns.items():
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                f()
                e1.record()
                e1.synchronize()
                ms[k].append(e0.elapsed_time(e1))
        return got, {k: round(statistics.median(v), 4) for k, v in ms.items()}

    keyed = torch.where(live[:, None, None] > 0, tables, torch.full_like(tables, math.inf))
    got, piece_ms = timed({
        "sort dim 0": lambda: torch.sort(keyed, dim=0).values,
        "transpose + sort last dim": lambda: torch.sort(
            keyed.movedim(0, -1).contiguous(), dim=-1).values.movedim(-1, 0)})
    if not torch.equal(got["sort dim 0"], got["transpose + sort last dim"]):
        fail("robust e: the sort along dim 0 differs from the transposed sort")
    print(f"robust e: sorts of the {tuple(tables.shape)} stack, device ms (medians of "
          f"{ROBUST_PAIRS} turns; equal): {json.dumps(piece_ms)} [{card}]", flush=True)
    del got
    gen = torch.Generator(device=s.device).manual_seed(17)
    for cw in RANK_COHORTS:
        stack = tables if cw == tables.shape[0] else tables.std() * torch.randn(
            (cw,) + tuple(tables.shape[1:]), generator=gen, device=s.device)
        wlive = live if cw == tables.shape[0] else torch.ones(cw, device=s.device)
        keyed = torch.where(wlive[:, None, None] > 0, stack, torch.full_like(stack, math.inf))
        n = (wlive > 0).sum()
        got, rank_ms = timed({
            "sorted values (port)": lambda: modes._trimmed_keep(
                keyed, torch.sort(keyed, dim=0).values, n, 1),
            "ranks by counting": lambda: window(counted_ranks(keyed), n),
            "stable sort + argsort (reference)": lambda: window(torch.argsort(
                torch.sort(keyed, dim=0, stable=True).indices, dim=0, stable=True), n),
            "sort dim 0": lambda: torch.sort(keyed, dim=0).values,
            "trimmed merge (port)": lambda: modes._robust_table_merge(
                spec, stack, wlive, "trimmed", 1)})
        masks = [v for k, v in got.items() if k not in ("sort dim 0", "trimmed merge (port)")]
        if not all(torch.equal(masks[0], m) for m in masks[1:]):
            fail(f"robust e: the trimmed keep masks disagree at W = {cw}")
        print(f"robust e: trimmed 1 keep mask of a {(cw,) + tuple(tables.shape[1:])} stack, "
              f"device ms (medians of {ROBUST_PAIRS} turns; the three masks equal): "
              f"{json.dumps(rank_ms)} [{card}]", flush=True)
        del stack, keyed, got, masks
    del s, tables, batch, steps, merges

    # b. the quarantine in the announce round: window 4, layer scope, a
    # NaN-poisoned client at round 2
    qrun, rec_q = run(QUARANTINE_ARGS + ["--fault_plan", QUARANTINE_PLAN], "quarantine",
                      rounds=QUARANTINE_ROUNDS, count=True)
    counts = [m["clients_quarantined"] for m in rec_q["metrics"]]
    lq = launches["quarantine"]
    if counts != [0.0, 0.0, 1.0] + [0.0] * (QUARANTINE_ROUNDS - 3) or qrun._table_round or \
            any(n != QUARANTINE_ROUNDS for n in lq.values()):
        fail(f"robust b: clients_quarantined a round {counts}, launches {lq}")
    q = qrun.state["quarantine"]
    print(f"robust b: clients_quarantined a round {counts}, median "
          f"{[round(m['quarantine_median'], 6) for m in rec_q['metrics']]}, ring count "
          f"{int(q['count'])}, {q['layer_median'].numel()} leaf rings; one launch of each "
          f"kernel a round ({lq})", flush=True)
    s = build(QUARANTINE_ARGS)
    for _ in range(2):
        s.run_round(0.01)  # seeds the rings
    clean_batch = s.prepare_round(2).batch
    poisoned = {k: v.clone() for k, v in clean_batch.items()}
    for k, v in poisoned.items():
        if not k.startswith("_") and v.is_floating_point():
            v[5] = float("nan")
    masked = dict(clean_batch, _valid=clean_batch["_valid"].clone())
    masked["_valid"][5] = 0.0
    lr = torch.tensor(CHECK_LR, device=s.device)
    out_q = s._step(s.state, s._to_device(poisoned), {}, lr)
    out_m = s._step(s.state, s._to_device(masked), {}, lr)
    diff = {f"{p}.{k}": (out_q[0][p][k] - out_m[0][p][k]).abs().max().item()
            for p in ("mode_state", "net_state", "quarantine") for k in out_q[0][p]
            if not torch.equal(out_q[0][p][k], out_m[0][p][k])}
    if not torch.equal(out_q[0]["params"], out_m[0]["params"]):
        diff["params"] = (out_q[0]["params"] - out_m[0]["params"]).abs().max().item()
    if not torch.equal(out_q[2]["loss_sum"], out_m[2]["loss_sum"]):
        diff["loss_sum"] = (out_q[2]["loss_sum"] - out_m[2]["loss_sum"]).abs().max().item()
    counts = [(out_q[2][k].item(), out_m[2][k].item())
              for k in ("participants", "clients_quarantined")]
    if diff or counts != [(W - 1, W - 1), (1.0, 0.0)]:
        fail(f"robust b: the quarantined round differs from the round with that client "
             f"masked (max abs differences {diff}; participants and clients_quarantined, "
             f"quarantined against masked, {counts})")
    print("robust b: the round with client 5 poisoned and quarantined == the round with its "
          "validity zeroed, bitwise (params, Vvelocity, Verror, batch-norm statistics, the "
          "rings, loss sum)", flush=True)
    del s, out_q, out_m
    print("robust b:", end=" ", flush=True)
    sync_probe(cv_train, SLICE_ARGS + QUARANTINE_ARGS)

    # d. preempt (b)'s run and resume it: the rings survive
    ck = os.path.join(base, "ck")
    pre = QUARANTINE_ARGS + ["--fault_plan", QUARANTINE_PLAN + ";preempt@2",
                             "--checkpoint_dir", ck]
    try:
        run(pre, "preempted", rounds=QUARANTINE_ROUNDS)
        fail("robust d: preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    r, rec_r = run(pre + ["--resume"], "resumed", rounds=QUARANTINE_ROUNDS)
    if not (r.run_stats.rounds == QUARANTINE_ROUNDS - 3
            and _equal(_full_state(qrun), _full_state(r))
            and all(torch.equal(r.state["quarantine"][k], v) for k, v in q.items())
            and rec_r["metrics"] == rec_q["metrics"][3:]):
        fail("robust d: preempt -> resume differs from the uninterrupted run")
    print("robust d: preempt@2 -> exit 75 -> resume == the uninterrupted run, bitwise (params, "
          "Vvelocity, Verror, batch-norm statistics, every ring, per-round metrics)", flush=True)
    shutil.rmtree(ck, ignore_errors=True)
    del qrun, r

    # c. served: the gauntlet rejects a 50x table as QUARANTINED; the round
    # equals its batch twin whose merge quarantines the same client
    served = ["--serve", "inproc"] + SERVE_PAYLOAD + ["--client_update_clip", "3"]
    with serving_runs() as rec:
        sv, rec_s = run(served + ["--fault_plan", SERVED_PLAN], "served", rounds=3)
    svc, src = rec["runs"][0]
    counters = svc.queue.counters()
    drops = ";".join(f"client_drop@{c.rnd}:clients=" + "+".join(str(p) for p in pos)
                     for c in src.closed_rounds
                     for pos in [[int(p) for p in np.flatnonzero(c.arrived == 0.0)
                                  if (c.rnd, int(p)) != (2, 1)]] if pos)
    build_service = cv_train.service_from_args
    cv_train.service_from_args = lambda args, session: None
    try:
        bt, rec_b = run(served + ["--fault_plan", ";".join(filter(None, [SERVED_PLAN, drops]))],
                        "served_batch", rounds=3)
    finally:
        cv_train.service_from_args = build_service
    held = {
        "the gauntlet rejected one payload QUARANTINED": counters["rejected_quarantined"] == 1,
        "round 2 of the batch twin quarantined one client":
            rec_b["metrics"][2]["clients_quarantined"] == 1.0,
        "round 2 of the served run quarantined none in the merge":
            rec_s["metrics"][2]["clients_quarantined"] == 0.0,
        "the same state, bitwise": _equal(_full_state(sv), _full_state(bt)) and all(
            torch.equal(sv.state["quarantine"][k], v) for k, v in bt.state["quarantine"].items()),
    }
    bad = [k for k, ok in held.items() if not ok]
    if bad:
        fail(f"robust c: {bad}; counters {counters}, twin drops {drops!r}")
    print(f"robust c: held: {'; '.join(held)} (counters {json.dumps(counters)}, twin drops "
          f"{drops!r})", flush=True)
    return launches


def ravel_launches(kernels) -> dict:
    """The launch counts of a run of the ravel path (phases 5-18): the
    tree accumulate must not have launched; returns the counts of the two
    whole-vector kernels."""
    counts = dict(kernels.launch_counts)
    tree = counts.pop("sketch_accumulate_tree")
    if tree:
        fail(f"a ravel-path run launched sketch_accumulate_tree {tree} times")
    return counts


def plain_fold(layerwise, csvec, spec, leaves: list, offsets: list):
    """The tree kernel's plain version: the per-leaf fold in ravel order
    into a zero table."""
    table = csvec.zero_table(spec, "cuda")
    for v, off in zip(leaves, offsets):
        layerwise._accumulate_leaf_rotation(spec, table, v,
                                            layerwise._leaf_block(spec, off, v.numel()))
    return table


def fold_check(layerwise, csvec, kernels, spec, leaves: list, label: str,
               whole: torch.Tensor | None = None) -> float:
    """Fold ``leaves`` (flat float32 tensors on the card, in ravel order,
    views or separate allocations) through the tree kernel and through the
    plain per-leaf fold, and hold the two tables bitwise after the whole
    tree, with ceil(L / TREE_MAX_LEAVES) launches; then against
    ``sketch_accumulate`` of the raveled vector (``whole``, default the
    concatenation). Returns the largest difference (0.0: any other
    fails)."""
    sizes = [v.numel() for v in leaves]
    offsets = [sum(sizes[:m]) for m in range(len(sizes))]
    before = kernels.launch_counts["sketch_accumulate_tree"]
    got = layerwise.sketch_tree(spec, leaves)
    launched = kernels.launch_counts["sketch_accumulate_tree"] - before
    want = -(-len(leaves) // kernels.TREE_MAX_LEAVES)
    if launched != want:
        fail(f"sketch_accumulate_tree {label}: {launched} launches for {len(leaves)} leaves, "
             f"want {want}")
    err = compare(f"sketch_accumulate_tree {label} ({len(leaves)} leaves)", got,
                  plain_fold(layerwise, csvec, spec, leaves, offsets))
    whole = torch.cat(leaves) if whole is None else whole
    return max(err, compare(f"sketch_accumulate_tree {label}: the table against "
                            "sketch_accumulate", got, csvec.sketch_vec(spec, whole)))


def separate_leaves(v: torch.Tensor, sizes) -> list:
    """v's leaves of ``sizes`` as separate allocations starting at element
    offsets 1, 2, 3, 1, ... mod 4."""
    out, off = [], 0
    for m, n in enumerate(sizes):
        k = 1 + m % 3
        out.append(torch.empty(n + 4, device=v.device)[k:k + n].copy_(v[off:off + n]))
        off += n
    return out


def leaf_times(layerwise, csvec, kernels, time_ms, spec, segments, gen, label: str,
               card: str) -> dict:
    """Cold (L2 flushed) and warm (the leaves just rewritten) ms of a whole
    tree's fold into a fresh table (one launch) beside ``sketch_accumulate``
    of the same vector, and of a one-leaf fold in place on the largest and
    the smallest leaf; each with its plain version's ms and its bound, the
    work's: the coordinates read once and the table written once (fresh,
    the tree and ``sketch_accumulate``: 4d + 4rc bytes) or the touched
    buckets (min(n, c) a row) read and written once (in place), with the
    hashes, at 3.35 TB/s, or 2 operations a (row, coordinate) at 67
    TFLOP/s; and the host ms of a call (its Python, the ctypes call and the
    launch, no sync). Prints them; returns the numbers by name."""
    import functools

    d, c, r = spec.d, spec.c, spec.r
    v = torch.randn(d, generator=gen, device="cuda")
    leaves = [v[o:o + n] for o, n in segments]
    offsets = [o for o, _ in segments]
    shifts, ks = csvec._rotation_keys(spec, v.device)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    hash_bytes = 4 * (r * spec.num_slabs + r)

    def bound(n_coords, table_bytes):
        b = 4 * n_coords + table_bytes + hash_bytes
        ops = 2 * r * n_coords
        bytes_ms, ops_ms = b / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    plan = layerwise.make_block_plan(spec, leaves)  # once, as the engine makes it
    out = {}
    work = {"tree": (lambda: layerwise.sketch_tree(spec, leaves, plan),
                     lambda: plain_fold(layerwise, csvec, spec, leaves, offsets), d, 4 * r * c,
                     1),
            "sketch_accumulate": (lambda: kernels.accumulate(v, shifts, ks, c), None, d,
                                  4 * r * c, 1)}
    table = csvec.zero_table(spec, "cuda")
    for which, i in (("largest leaf", max(range(len(segments)), key=lambda i: segments[i][1])),
                     ("smallest leaf", min(range(len(segments)), key=lambda i: segments[i][1]))):
        o, n = segments[i]
        work[which] = (functools.partial(kernels.accumulate_tree, table, [leaves[i]], [o],
                                         shifts, ks, c, d),
                       functools.partial(layerwise._accumulate_leaf_rotation, spec, table.clone(),
                                         leaves[i], layerwise._leaf_block(spec, o, n)),
                       n, 8 * r * min(n, c), 1)
    def host_ms(fn):
        torch.cuda.synchronize()
        calls = []
        for _ in range(LW_HOST_CALLS):
            t0 = time.perf_counter()
            fn()
            calls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(calls)

    for name, (fn, plain, n_coords, table_bytes, launches) in work.items():
        ms = time_ms(fn, TIMED_LAUNCHES, flush.sum, LW_SPIN_CYCLES)
        warm = time_ms(fn, TIMED_LAUNCHES, lambda: v.mul_(1.0), LW_SPIN_CYCLES)
        plain_ms = time_ms(plain, 3, flush.sum) if plain is not None else None
        b_ms, b_by = bound(n_coords, table_bytes)
        out[name] = {"ms": ms, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "launches": launches, "coords": n_coords,
                     "mb": (4 * n_coords + table_bytes + hash_bytes) / 1e6,
                     "host_ms": host_ms(fn)}
        print(f"layerwise a: {label} {name} ({launches} launch, {n_coords:,} coordinates): "
              f"{ms:.4f} ms cold, {warm:.4f} warm, plain "
              f"{'n/a' if plain_ms is None else f'{plain_ms:.3f}'} ms, bound {b_ms:.4f} ms "
              f"({b_by}: {out[name]['mb']:.1f} MB); host {out[name]['host_ms']:.4f} ms a call "
              f"[{card}]", flush=True)
    return out


def layerwise_phase(cv_train, engine, csvec, kernels, time_ms, gen: torch.Generator,
                    card: str) -> dict:
    """Phase 19: the layerwise sketch path (``--sketch_path layerwise``) at
    full width: the tree kernel against its plain version (a), ResNet-9
    FetchSGD layerwise against ravel (b), GPT-2 LM (c), preempt and resume
    (d). Returns the tree kernel's row fields and each kernel's launches by
    run."""
    import dataclasses
    import shutil

    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.sketch import layerwise

    base = os.path.join(ROOT, "build", "chip_smoke", "layerwise")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    phase_t = time.perf_counter()
    launches = {}
    err = 0.0

    # a. the kernel against its plain version on the edge cases first: views
    # of one vector, then separate allocations off 16 bytes
    for d, c, r, sizes in LEAF_EDGES:
        spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=42, family="rotation")
        v = torch.randn(d, generator=gen, device="cuda")
        err = max(err, fold_check(layerwise, csvec, kernels, spec,
                                  list(torch.split(v, list(sizes))), f"d={d} c={c} r={r}"))
        err = max(err, fold_check(layerwise, csvec, kernels, spec, separate_leaves(v, sizes),
                                  f"d={d} c={c} r={r} separate", whole=v))
    n_many, c, r = MANY_LEAVES
    sizes = torch.randint(1, 38, (n_many,), generator=torch.Generator().manual_seed(0)).tolist()
    spec = csvec.CSVecSpec(d=sum(sizes), c=c, r=r, seed=42, family="rotation")
    v = torch.randn(spec.d, generator=gen, device="cuda")
    err = max(err, fold_check(layerwise, csvec, kernels, spec, list(torch.split(v, sizes)),
                              f"{n_many} leaves of 1-37"))
    print(f"layerwise a: sketch_accumulate_tree == the plain fold and sketch_accumulate, "
          f"bitwise, on {len(LEAF_EDGES)} edge trees {[e[3] for e in LEAF_EDGES]} as views and "
          f"as separate allocations at element offsets 1-3 mod 4, and on {n_many} leaves of "
          f"1-37 coordinates (d={spec.d}, c={c}, r={r}; "
          f"{-(-n_many // kernels.TREE_MAX_LEAVES)} launches)", flush=True)

    def run(main, argv, label, sketch_path):
        log = os.path.join(base, f"{label}.jsonl")
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        s = main(argv + ["--sketch_path", sketch_path, "--log_jsonl", log])
        torch.cuda.synchronize()
        launches[label] = dict(kernels.launch_counts)
        with open(log) as f:
            rows = [{k: v for k, v in json.loads(ln).items() if k != "time_s"} for ln in f]
        print(f"layerwise {label}: {s.run_stats.rounds} rounds, launches {launches[label]}, "
              f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, last row "
              f"{rows[-1]}", flush=True)
        print(_times(f"layerwise {label}", s.run_stats, card), flush=True)
        return s, rows

    def per_round_launches(label, rounds, trees, accumulate=0):
        want = {"sketch_accumulate": accumulate * rounds, "sketch_query": rounds,
                "sketch_accumulate_tree": trees * rounds}
        if launches[label] != want:
            fail(f"layerwise {label}: launches {launches[label]} in {rounds} rounds, want {want}")

    def turns(steps: dict, state, batch, lr) -> dict:
        """Round ms of each step in turns (CUDA events), the first turn a
        warm-up, and each step's peak device memory above what was
        allocated before it."""
        ms = {k: [] for k in steps}
        peak = {}
        for i in range(LW_PAIRS + 1):
            for label in (list(steps) if i % 2 == 0 else list(steps)[::-1]):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                steps[label](state, batch, {}, lr)
                e1.record()
                e1.synchronize()
                peak[label] = (torch.cuda.max_memory_allocated() - before) / 1e9
                if i:
                    ms[label].append(e0.elapsed_time(e1))
        return {k: {"ms": v, "median": statistics.median(v), "peak_gb": peak[k]}
                for k, v in ms.items()}

    # b. ResNet-9 FetchSGD at full width, layerwise against ravel
    argv = SLICE_ARGS + ["--num_rounds", str(LW_ROUNDS), "--eval_every", str(LW_ROUNDS)]
    rv, rows_rv = run(cv_train.main, argv + ["--sync_loop"], "resnet9_ravel", "ravel")
    lw, rows_lw = run(cv_train.main, argv + ["--sync_loop"], "resnet9_sync", "layerwise")
    segments = layerwise.leaf_segments(lw.layout)
    per_round_launches("resnet9_ravel", LW_ROUNDS, 0, accumulate=1)
    per_round_launches("resnet9_sync", LW_ROUNDS, 1)
    la, rows_la = run(cv_train.main, argv, "resnet9_async", "layerwise")
    per_round_launches("resnet9_async", LW_ROUNDS, 1)
    if not (_equal(_full_state(lw), _full_state(la)) and rows_lw == rows_la):
        fail("layerwise b: the async layerwise run differs from the sync one")

    if not (_equal(_full_state(rv), _full_state(lw)) and rows_rv == rows_lw):
        fail("layerwise b: the layerwise run differs from the ravel run")
    print(f"layerwise b: ResNet-9 FetchSGD, {LW_ROUNDS} rounds: layerwise sync == async bitwise; "
          f"layerwise == ravel bitwise (params, Vvelocity, Verror, batch-norm statistics, rows "
          f"but time_s); launches a round 1 sketch_accumulate_tree ({len(segments)} "
          "leaves), 0 "
          f"sketch_accumulate, 1 sketch_query [{card}]", flush=True)
    # the kernel on every leaf of ResNet-9's plan, on the run's reduced
    # gradient's shape, and the times
    spec = lw.cfg.mode.sketch_spec
    v = torch.randn(spec.d, generator=gen, device="cuda")
    err = max(err, fold_check(layerwise, csvec, kernels, spec,
                              [v[o:o + n] for o, n in segments], "resnet9"))
    print(f"layerwise a: ResNet-9's plan ({len(segments)} leaves, d={spec.d:,} c={spec.c:,} "
          f"r={spec.r}) in 1 launch == the plain fold, the table == sketch_accumulate, bitwise",
          flush=True)
    times = leaf_times(layerwise, csvec, kernels, time_ms, spec, segments, gen, "resnet9", card)
    batch = lw._to_device(lw.prepare_round(lw.round).batch)
    lr = torch.tensor(CHECK_LR, device=lw.device)
    ravel_step = engine.make_round_step(lw.train_loss_fn,
                                        dataclasses.replace(lw.cfg, sketch_path="ravel"), lw.layout)
    t9 = turns({"ravel": ravel_step, "layerwise": lw._step}, lw.state, batch, lr)
    print(f"layerwise b: ResNet-9 sync round ms (CUDA events, {LW_PAIRS} turns): "
          + ", ".join(f"{k} {[round(x, 3) for x in t['ms']]} (median {t['median']:.3f}, peak "
                      f"{t['peak_gb']:.3f} GB above the state)" for k, t in t9.items())
          + f" [{card}]", flush=True)
    del rv, la, ravel_step, batch

    # d. preempt and resume, layerwise
    ck = os.path.join(base, "ck")
    pre = argv + ["--sync_loop", "--checkpoint_dir", ck, "--fault_plan", "preempt@2"]
    try:
        run(cv_train.main, pre, "resnet9_preempted", "layerwise")
        fail("layerwise d: preempt@2 did not exit")
    except SystemExit as ex:
        if ex.code != 75:
            raise
    res, rows_res = run(cv_train.main, pre + ["--resume"], "resnet9_resumed", "layerwise")
    keys = ("round", "test_loss", "test_acc", "comm_mb")
    if not (_equal(_full_state(res), _full_state(lw))
            and [{k: r[k] for k in keys} for r in rows_res[-1:]] ==
            [{k: r[k] for k in keys} for r in rows_lw[-1:]]):
        fail("layerwise d: preempt -> resume differs from the uninterrupted layerwise run")
    print("layerwise d: preempt@2 -> exit 75 -> --resume == the uninterrupted layerwise run, "
          "bitwise (params, Vvelocity, Verror, batch-norm statistics, eval row)", flush=True)
    shutil.rmtree(ck, ignore_errors=True)
    del res, lw

    # c. GPT-2 LM (phase 11's flags, client_chunk 0), layerwise against ravel
    gargv = GPT2_ARGS + ["--num_rounds", str(LW_GPT2_ROUNDS), "--sync_loop"]
    grv, grows_rv = run(gpt2_train.main, gargv, "gpt2_ravel", "ravel")
    glw, grows_lw = run(gpt2_train.main, gargv, "gpt2_sync", "layerwise")
    gsegments = layerwise.leaf_segments(glw.layout)
    per_round_launches("gpt2_ravel", LW_GPT2_ROUNDS, 0, accumulate=1)
    per_round_launches("gpt2_sync", LW_GPT2_ROUNDS, 1)
    if not (_equal(_full_state(grv), _full_state(glw)) and grows_rv == grows_lw):
        diff = max((_state(glw)[k] - _state(grv)[k]).abs().max().item() for k in _state(grv))
        fail(f"layerwise c: GPT-2's layerwise run differs from the ravel run (params, "
             f"Vvelocity, Verror max abs difference {diff:.3e})")
    print(f"layerwise c: GPT-2 LM, {LW_GPT2_ROUNDS} rounds: layerwise == ravel bitwise (params, "
          f"Vvelocity, Verror, rows but time_s); 1 tree launch a round ({len(gsegments)} "
          f"leaves) [{card}]", flush=True)
    gspec = glw.cfg.mode.sketch_spec
    v = torch.randn(gspec.d, generator=gen, device="cuda")
    err = max(err, fold_check(layerwise, csvec, kernels, gspec,
                              [v[o:o + n] for o, n in gsegments], "gpt2"))
    print(f"layerwise a: GPT-2's plan ({len(gsegments)} leaves, d={gspec.d:,} c={gspec.c:,} "
          f"r={gspec.r}) in 1 launch == the plain fold, the table == sketch_accumulate, "
          "bitwise", flush=True)
    del v
    gtimes = leaf_times(layerwise, csvec, kernels, time_ms, gspec, gsegments, gen, "gpt2", card)
    gbatch = glw._to_device(glw.prepare_round(glw.round).batch)
    glr = torch.tensor(CHECK_LR, device=glw.device)
    tg = turns({"ravel": grv._step, "layerwise": glw._step}, glw.state, gbatch, glr)
    print(f"layerwise c: GPT-2 LM sync round ms (CUDA events, {LW_PAIRS} turns): "
          + ", ".join(f"{k} {[round(x, 3) for x in t['ms']]} (median {t['median']:.3f}, peak "
                      f"{t['peak_gb']:.3f} GB above the state)" for k, t in tg.items())
          + f" [{card}]", flush=True)
    del grv, glw, gbatch
    print(f"layerwise: phase took {time.perf_counter() - phase_t:.1f} s [{card}]", flush=True)
    tree = times["tree"]
    return {"row": {"max_abs_err": err, "ms": tree["ms"], "warm_ms": tree["warm_ms"],
                    "plain_ms": tree["plain_ms"],
                    "bound_ms": tree["bound_ms"], "bound_by": tree["bound_by"],
                    "launches": launches["resnet9_sync"]["sketch_accumulate_tree"],
                    "one_leaf": {k: times[k] for k in ("largest leaf", "smallest leaf")},
                    "sketch_accumulate_same_vector": times["sketch_accumulate"],
                    "gpt2": {**gtimes["tree"], "launches": launches["gpt2_sync"][
                        "sketch_accumulate_tree"], "one_leaf": {
                        k: gtimes[k] for k in ("largest leaf", "smallest leaf")},
                        "sketch_accumulate_same_vector": gtimes["sketch_accumulate"]},
                    "round_ms": {"resnet9": t9, "gpt2": tg}},
            "launches": launches}


REPLACES = {"sketch_accumulate": "commefficient_tpu/sketch/pallas_kernels.py:135",
            "sketch_query": "commefficient_tpu/sketch/pallas_kernels.py:211"}


def tree_row(lw: dict) -> dict:
    """The tree accumulate's row of the kernels line, from phase 19: its
    times are a whole ResNet-9 tree's fold (26 leaves, one launch), its
    launches those of (b)'s layerwise sync run. It has no library call:
    PyTorch has no rotation-family Count-Sketch, and ``index_put_``
    computes another hash family's scatter."""
    return {"name": "sketch_accumulate_tree", "route": "cuda",
            "source": "commefficient_tpu_torch/sketch/csrc/sketch_kernels.cu",
            "replaces": REPLACES["sketch_accumulate"], "library_ms": None, **lw["row"]}


def _mesh_argv(base: str) -> dict:
    """Phase 18b's three group runs (uninterrupted, preempted at round 1 on
    rank 2, resumed), each its flags, in ``base``."""
    argv = SLICE_ARGS + MESH_ARGS
    ck, ck2 = os.path.join(base, "ck"), os.path.join(base, "ck2")
    return {"mesh": argv + ["--checkpoint_dir", ck, "--ledger", os.path.join(base, "mesh.ledger"),
                            "--log_jsonl", os.path.join(base, "mesh.jsonl")],
            "preempt": argv + ["--checkpoint_dir", ck2, "--fault_plan", "host_preempt@1:host=2"],
            "resume": argv + ["--checkpoint_dir", ck2, "--resume"]}


def _mesh_runs(out_dir: str, device: str) -> None:
    """On a rank of the joined group, phase 18b's runs of ``_mesh_argv``
    through ``cv_train.main``, in order; each writes this rank's per-round
    metrics, launch counts, gather times, exit code and the checkpoints
    its directory held before it ran to ``out_dir/<tag>_<rank>.json``."""
    import torch.distributed as dist

    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.parallel import distributed
    from commefficient_tpu_torch.sketch import kernels

    rank = distributed.rank()
    gather = distributed.all_gather_stacked
    gathers = []

    def timed_gather(tensors, group=None):
        # the shard phase done and every rank at the gather first, so the
        # time is the gather's (host staging, the collective, the copy back)
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = gather(tensors, group)
        if device == "cuda":
            torch.cuda.synchronize()
        gathers.append([(time.perf_counter() - t0) * 1e3,
                        sum(t.numel() * t.element_size() for t in tensors)])
        return out

    distributed.all_gather_stacked = timed_gather
    try:
        for tag, argv in _mesh_argv(out_dir).items():
            # rank 0's round-2 checkpoint is on disk before any rank resumes
            dist.barrier()
            ck = argv[argv.index("--checkpoint_dir") + 1]
            before = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
            gathers.clear()
            kernels.reset_launch_counts()
            code = 0
            with recording_rounds() as rec:
                try:
                    cv_train.main(list(argv))
                except SystemExit as e:
                    code = e.code if isinstance(e.code, int) else 1
            with open(os.path.join(out_dir, f"{tag}_{rank}.json"), "w") as f:
                json.dump({"metrics": rec["metrics"], "launches": ravel_launches(kernels),
                           "gathers": list(gathers), "code": code, "before": before}, f)
    finally:
        distributed.all_gather_stacked = gather


def _joint_rank(bases: dict, device: str, parts: tuple, extra: tuple) -> None:
    """One rank of the gloo group of 4 ranks sharing the card that phases
    18b, 20 and 21 (and through 21 the group runs of 22f to 25f) share:
    joined once, then each part's runs in turn: "mesh" (18b), "group" (20),
    "serve" (21, then the runs ``extra`` of ``served_group_runs()``), each
    writing into its directory of ``bases``."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.parallel import distributed

    # the serve group waits out the served rounds' deadline; no other group
    # reads it
    distributed.initialize(force=True, backend="gloo", device=device,
                           serve_deadline_s=float(SERVE_PAYLOAD[SERVE_PAYLOAD.index(
                               "--serve_deadline") + 1]))
    reuse_run_inputs(cv_train)
    for part in parts:
        if part == "mesh":
            _mesh_runs(bases[part], device)
        elif part == "group":
            _group_runs(bases[part], device)
        else:
            _serve_group_runs(bases[part], device, extra)
        dist.barrier()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


def joint_launch(parts: tuple, extra: tuple = ()) -> dict:
    """One launch of ``_joint_rank`` on MESH_SHARDS gloo ranks sharing the
    card, each part's directory emptied first: {"bases", "codes" (the
    ranks' exit codes), "secs" (the launch's seconds), "parts"}."""
    import shutil

    from commefficient_tpu_torch.parallel import distributed

    assert MESH_SHARDS == GROUP_SHARDS == SERVE_GROUP_SHARDS == ASYNC_GROUP_SHARDS
    device = "cuda" if "cuda" in SLICE_ARGS else "cpu"
    dirs = {"mesh": "mesh", "group": "group", "serve": "serve_group"}
    bases = {p: os.path.join(ROOT, "build", "chip_smoke", dirs[p]) for p in parts}
    for b in bases.values():
        shutil.rmtree(b, ignore_errors=True)
        os.makedirs(b)
    t0 = time.perf_counter()
    codes = distributed.launch_local(_joint_rank, MESH_SHARDS,
                                     (bases, device, tuple(parts), tuple(extra)),
                                     env={"LOCAL_RANK": "0"}, timeout_s=900)
    return {"bases": bases, "codes": codes, "secs": time.perf_counter() - t0, "parts": parts}


def mesh_phase(cv_train, engine, kernels, card: str, joint: dict) -> dict:
    """Phase 18: the sharded round on ResNet-9 FetchSGD at full width, one
    card: the emulation (a), a 4-rank gloo group (b: the "mesh" part of
    ``joint``, a ``joint_launch``), a one-rank NCCL group (c) and the times
    (d). Returns each kernel's launches over (a) and over each rank of (b)'s
    uninterrupted run."""
    import dataclasses
    import functools

    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.parallel import distributed
    from commefficient_tpu_torch.parallel.mesh import merge_comm_bytes

    device = "cuda" if "cuda" in SLICE_ARGS else "cpu"
    base = joint["bases"]["mesh"]
    S, R = MESH_SHARDS, MESH_ROUNDS
    argv = SLICE_ARGS + MESH_ARGS
    launches = {}

    def ledger_prints(path):
        with open(path) as f:
            return [json.loads(ln).get("fingerprint") for ln in f if '"kind": "round"' in ln]

    def ck_state(ck, rnd):
        return torch.load(os.path.join(ck, f"round_{rnd:08d}", "state.pt"), weights_only=True)

    def same_tree(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
        return torch.equal(a, b) if torch.is_tensor(a) else a == b

    # a. the emulation: the session at client_shards=S on one card
    emu_dir = os.path.join(base, "emu")
    orig_session = cv_train.FederatedSession
    cv_train.FederatedSession = functools.partial(FederatedSession, client_shards=S)
    try:
        kernels.reset_launch_counts()
        with recording_rounds() as emu_rec:
            emu = cv_train.main(argv + ["--sync_loop", "--checkpoint_dir", emu_dir + "_ck",
                                        "--ledger", emu_dir + ".ledger", "--log_jsonl",
                                        emu_dir + ".jsonl"])
        torch.cuda.synchronize()
        launches["emulation"] = ravel_launches(kernels)
    finally:
        cv_train.FederatedSession = orig_session
    want = {"sketch_accumulate": S * R, "sketch_query": R}
    if emu.cfg.client_shards != S or launches["emulation"] != want:
        fail(f"mesh a: client_shards {emu.cfg.client_shards}, launches "
             f"{launches['emulation']} in {R} rounds (want {want})")
    # one round from the emulation's state, sharded and unsharded, on one batch
    plain = engine.make_round_step(emu.train_loss_fn, dataclasses.replace(emu.cfg, client_shards=1),
                                   emu.layout)
    batch = emu._to_device(emu.prepare_round(R).batch)
    lr = torch.tensor(CHECK_LR, device=emu.device)
    a, _, _ = emu._step(emu.state, batch, {}, lr)
    b, _, _ = plain(emu.state, batch, {}, lr)
    agree, rel, swapped = round_agreement(a, b, emu.state["params"])
    print(f"mesh a: emulation at client_shards={S}, {R} sync rounds: launches "
          f"{launches['emulation']} ({S} accumulate and 1 query a round); one round at lr "
          f"{CHECK_LR} against the unsharded round on the same state and batch: top-k agreement "
          f"{agree:.6f}, rel L2 of the movement {rel:.3e}, {swapped} coordinates moved by one "
          f"only [{card}]", flush=True)
    if agree < MESH_TOPK_AGREE or rel > MESH_REL:
        fail(f"mesh a: emulation vs unsharded round: agreement {agree}, rel {rel}")

    # b. four ranks in a gloo group on the one card, each run's codes as
    # the ranks recorded them
    def read(tag):
        ranks = []
        for r in range(S):
            path = os.path.join(base, f"{tag}_{r}.json")
            if not os.path.exists(path):
                fail(f"mesh b: {tag}: rank {r} wrote nothing (the launch's exit codes "
                     f"{joint['codes']})")
            with open(path) as f:
                ranks.append(json.load(f))
        return [g["code"] for g in ranks], ranks

    ck = os.path.join(base, "ck")
    ledger = os.path.join(base, "mesh.ledger")
    codes, ranks = read("mesh")
    if codes != [0] * S:
        fail(f"mesh b: rank exit codes {codes}")
    for r, got in enumerate(ranks):
        if got["metrics"] != emu_rec["metrics"]:
            fail(f"mesh b: rank {r}'s per-round metrics differ from the emulation's")
        if got["launches"] != {"sketch_accumulate": R, "sketch_query": R}:
            fail(f"mesh b: rank {r} launched {got['launches']} in {R} rounds")
        launches[f"rank{r}"] = got["launches"]
    prints = [ledger_prints(ledger)] + [ledger_prints(f"{ledger}.rank{r}") for r in range(1, S)]
    if len(prints[0]) != R or any(p != prints[0] for p in prints) or \
            prints[0] != ledger_prints(emu_dir + ".ledger"):
        fail("mesh b: the ranks' ledger fingerprints differ (from each other or the emulation)")
    with open(emu_dir + ".jsonl") as f1, open(os.path.join(base, "mesh.jsonl")) as f2:
        rows = [[{k: v for k, v in json.loads(ln).items() if k != "time_s"} for ln in f]
                for f in (f1, f2)]
    if rows[0] != rows[1]:
        fail("mesh b: rank 0's rows differ from the emulation's")
    final = ck_state(ck, R)
    if not same_tree(final, ck_state(emu_dir + "_ck", R)):
        fail("mesh b: the final state differs from the emulation's")
    print(f"mesh b: {S} gloo ranks on one card, {R} async rounds: params, Vvelocity, Verror, "
          f"batch-norm statistics, rows and every per-round metric == the emulation's, bitwise; "
          f"fingerprints equal on every rank every round; launches a rank {ranks[0]['launches']}; "
          f"{joint['secs']:.1f} s for the launch of parts {list(joint['parts'])} [{card}]",
          flush=True)
    ck2 = os.path.join(base, "ck2")
    codes, pre = read("preempt")
    # what the preempted run left, as every rank found it before the resume
    _, res = read("resume")
    left = [g["before"] for g in res]
    if codes != [75] * S or left != [["round_00000002"]] * S:
        fail(f"mesh b: host_preempt@1:host=2: exit codes {codes}, checkpoints {left}")
    if any(len(p["metrics"]) != 2 or p["metrics"] != emu_rec["metrics"][:2] for p in pre):
        fail("mesh b: the preempted ranks did not all commit rounds 0 and 1 as the emulation")
    codes, res = read("resume")
    if codes != [0] * S or not same_tree(ck_state(ck2, R), final):
        fail(f"mesh b: the resume from rank 0's round-2 checkpoint (exit codes {codes}) does "
             "not end on the uninterrupted run's state")
    if any(p["metrics"] != emu_rec["metrics"][2:] for p in res):
        fail("mesh b: the resumed rounds' metrics differ from the uninterrupted run's")
    print(f"mesh b: host_preempt@1:host=2 -> every rank exit 75 at round 2, one checkpoint "
          f"(rank 0's); --resume -> round {R} == the uninterrupted run, bitwise [{card}]",
          flush=True)

    # c. a one-rank NCCL group on the card
    if device == "cuda":
        distributed.initialize(force=True, device="cuda",
                               coordinator_address=f"localhost:{distributed.free_port()}",
                               num_processes=1, process_id=0)
        try:
            table = emu.state["mode_state"]["Verror"]
            (got,) = distributed.all_gather_stacked([table])
            ok = (torch.distributed.get_backend() == "nccl" and got.shape == (1,) + table.shape
                  and torch.equal(got[0], table) and distributed.all_hosts_max(3) == 3)
            nccl = ".".join(map(str, torch.cuda.nccl.version()))
        finally:
            distributed.shutdown()
        if not ok:
            fail("mesh c: the one-rank NCCL group's gather or agreement is wrong")
        print(f"mesh c: a one-rank NCCL group (NCCL {nccl}): initialize, the gather of a "
              f"{tuple(table.shape)} table == the table, all_hosts_max(3) == 3 [{card}]",
              flush=True)

    # d. times
    steps = {"unsharded": plain, f"emulated S={S}": emu._step}
    ms = {k: [] for k in steps}
    for i in range(MESH_PAIRS + 1):  # the first turn warms up and is dropped
        for label in (list(steps) if i % 2 == 0 else list(steps)[::-1]):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            steps[label](emu.state, batch, {}, lr)
            e1.record()
            e1.synchronize()
            if i:
                ms[label].append(e0.elapsed_time(e1))
    gathers = ranks[0]["gathers"]
    print(f"mesh d: sync round ms (CUDA events, {MESH_PAIRS} turns): "
          + ", ".join(f"{k} {[round(t, 3) for t in v]} (median {statistics.median(v):.3f})"
                      for k, v in ms.items()) + f" [{card}]", flush=True)
    print(f"mesh d: gloo gather on rank 0, {S} processes on one card through host memory "
          f"(not NVLink, not InfiniBand): ms {[round(g[0], 3) for g in gathers]} (median "
          f"{statistics.median(g[0] for g in gathers):.3f}), {gathers[0][1] / 1e6:.2f} MB a "
          f"rank a round [{card}]", flush=True)
    for name, (r, c, d) in (("resnet9", (5, 524_288, 6_573_130)),
                            ("gpt2", (5, 1_000_000, GPT2_D))):
        print(f"mesh d: merge_comm_bytes(S={S}) {name}: {json.dumps(merge_comm_bytes(S, r, c, d))}",
              flush=True)
    return launches


def tree_digest(tree) -> str:
    """sha256 over a nested dict of tensors (keys sorted, each tensor's
    dtype, shape and bytes): two trees with equal digests are bitwise
    equal."""
    import hashlib

    h = hashlib.sha256()

    def walk(t, key):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{key}/{k}")
        elif torch.is_tensor(t):
            c = t.detach().contiguous().cpu()
            h.update(f"{key}:{c.dtype}:{tuple(c.shape)}".encode())
            h.update(c.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(f"{key}={t!r}".encode())

    walk(tree, "")
    return h.hexdigest()


def _server_state(s) -> dict:
    """The committed server state (params, batch-norm statistics, optimizer
    state, the quarantine's rings), without the round counter."""
    return {k: v for k, v in s.state.items() if k != "round"}


def _client_blocks(client_state: dict, shards: int) -> list:
    """The digests of the blocks a group of ``shards`` ranks holds of a
    one-device [N, d] client state: padded to a multiple of ``shards``, cut
    into contiguous blocks."""
    n = next(iter(client_state.values())).shape[0]
    B = -(-n // shards)
    padded = {k: torch.cat([v, v.new_zeros((B * shards - n, v.shape[1]))])
              for k, v in client_state.items()}
    return [tree_digest({k: v[r * B:(r + 1) * B] for k, v in padded.items()})
            for r in range(shards)]


def _twin_session(shards: int):
    """A FederatedSession factory for the group's one-device twin: the
    sharded round's emulation at ``shards`` on one card, set on the built
    session (the session's client_shards takes only the reference's linear
    scope; the table round's emulation is that argument's)."""
    import dataclasses

    from commefficient_tpu_torch.federated.api import FederatedSession

    def make(*a, **kw):
        s = FederatedSession(*a, **kw)
        s.cfg = dataclasses.replace(s.cfg, client_shards=shards)
        s._build_steps()
        return s

    return make


def _group_runs(out_dir: str, device: str) -> None:
    """On a rank of the joined group, phase 20's runs of GROUP_RUNS through
    ``cv_train.main`` ((a) uninterrupted, preempted at round 1 on rank 2
    and resumed; (b); (c)), then (d)'s timed turns, row moves and table
    gathers. Writes this rank's per-run metrics, launch counts, state and
    client-block digests, resident client-state bytes and times to
    ``out_dir/group_<rank>.json``."""
    import dataclasses

    import torch.distributed as dist

    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.parallel import distributed
    from commefficient_tpu_torch.parallel.mesh import client_row_bytes
    from commefficient_tpu_torch.sketch import kernels
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    rank, S = distributed.rank(), distributed.world_size()
    out = {"runs": {}}
    ck = os.path.join(out_dir, "ck")
    rounds = ["--num_rounds", str(GROUP_ROUNDS)]

    def run(tag, argv):
        kernels.reset_launch_counts()
        code, s = 0, None
        t0 = time.perf_counter()
        with recording_rounds() as rec:
            try:
                s = cv_train.main(list(argv) + rounds)
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else 1
        torch.cuda.synchronize() if device == "cuda" else None
        got = {"metrics": rec["metrics"], "launches": ravel_launches(kernels), "code": code,
               "s": time.perf_counter() - t0}
        if s is not None:
            got["state"] = tree_digest(_server_state(s))
            if s.client_state is not None:
                got["block"] = tree_digest(s.client_state)
                got["client_block"] = list(s.client_block)
                got["resident_bytes"] = sum(v.numel() * v.element_size()
                                            for v in s.client_state.values())
            got["round_ms"] = s.run_stats.round_ms
        out["runs"][tag] = got
        return s

    local = GROUP_RUNS["local_topk"]
    run("local_topk", local)
    run("preempted", local + ["--checkpoint_dir", ck, "--fault_plan", "host_preempt@1:host=2"])
    dist.barrier()
    # the resume keeps round 2's checkpoint beside its own (the newest 3
    # are kept): the one-device restore reads it
    s = run("resumed", local + ["--checkpoint_dir", ck, "--resume"])
    run("fedavg", GROUP_RUNS["fedavg"])
    run("table", GROUP_RUNS["table"])

    # d. times, on the resumed session: the group's round in turns with its
    # twin (rank 0 alone runs the twin, the others wait at a barrier), then
    # the row moves and the table gather, each on rank 0 after a barrier
    twin = None
    if rank == 0:
        cli_mesh = distributed.cli_mesh
        distributed.cli_mesh = lambda a: None
        try:
            twin, _ = cv_train.build(resolve_defaults(make_parser().parse_args(local + rounds)))
        finally:
            distributed.cli_mesh = cli_mesh
        twin.cfg = dataclasses.replace(twin.cfg, client_shards=S)
        twin._build_steps()

    def timed(fn):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, r

    turns = {"group": [], "twin": []}
    for i in range(GROUP_TURNS + 1):  # the first turn warms up and is dropped
        for label in (("group", "twin") if i % 2 == 0 else ("twin", "group")):
            dist.barrier()
            if label == "group":
                ms, _ = timed(lambda: s.run_round(CHECK_LR))
            elif rank == 0:
                ms, _ = timed(lambda: twin.run_round(CHECK_LR))
            if i and (label == "group" or rank == 0):
                turns[label].append(ms)
    del twin
    moves, gathers = [], []
    d = s.layout.d
    B = s.client_block[1]
    tables = torch.randn((8 // S, SLICE["r"], SLICE["c"]), device=s.device)
    for i in range(GROUP_TURNS + 1):
        ids = s.sample_cohort(s.round)
        plan = distributed.RowMoves(ids, B, s.group)
        distributed.row_move_bytes.update(sent=0, received=0)
        dist.barrier()
        fetch_ms, rows = timed(lambda: plan.fetch(s.client_state))
        dist.barrier()
        back_ms, _ = timed(lambda: plan.give_back(s.client_state, rows))
        want = client_row_bytes(ids, s.train_set.num_clients, S, d, len(s.client_state))
        moved = dict(distributed.row_move_bytes)
        both = want["sent_per_rank"][rank] + want["received_per_rank"][rank]
        if moved != {"sent": both, "received": both}:
            fail(f"group d: rank {rank} moved {moved}, client_row_bytes counts {both} each way")
        dist.barrier()
        gather_ms, _ = timed(lambda: distributed.all_gather_stacked([tables], s.group))
        if i:
            moves.append([fetch_ms, back_ms, want["bytes_each_way"], want["crossing"],
                          moved["sent"], moved["received"]])
            gathers.append([gather_ms, tables.numel() * tables.element_size() * S])
    out.update(turns=turns, moves=moves, gathers=gathers)
    with open(os.path.join(out_dir, f"group_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()


def group_phase(cv_train, engine, kernels, card: str, joint: dict | None = None) -> dict:
    """Phase 20: the rest of the client mesh on 4 gloo ranks sharing the
    card, at ResNet-9's full width: (a) local_topk with the client state
    split over the ranks, against its one-device twin, preempted and
    resumed, its checkpoint resumed on one device; (b) fedavg; (c) the
    trimmed table round; (d) the times. The group's runs are the "group"
    part of ``joint`` (a ``joint_launch``; one of its own when None).
    Returns each kernel's launches on rank 0 over each run."""
    import functools
    import shutil

    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.utils import checkpoint as ckpt
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    S, R = GROUP_SHARDS, GROUP_ROUNDS
    joint = joint or joint_launch(("group",))
    base, codes, secs = joint["bases"]["group"], joint["codes"], joint["secs"]
    ranks = []
    for r in range(S):
        path = os.path.join(base, f"group_{r}.json")
        if not os.path.exists(path):
            fail(f"group: rank {r} wrote nothing (exit codes {codes})")
        with open(path) as f:
            ranks.append(json.load(f))
    if codes != [0] * S:
        fail(f"group: rank exit codes {codes}")
    rounds = ["--num_rounds", str(R)]

    def twin(tag, factory):
        orig = cv_train.FederatedSession
        cv_train.FederatedSession = factory
        try:
            kernels.reset_launch_counts()
            with recording_rounds() as rec:
                s = cv_train.main(GROUP_RUNS[tag] + rounds)
            torch.cuda.synchronize()
        finally:
            cv_train.FederatedSession = orig
        return s, rec["metrics"], ravel_launches(kernels)

    def same_as(tag, run, s, metrics):
        for r, got in enumerate(ranks):
            g = got["runs"][run]
            if g["code"] != 0 or g["metrics"] != metrics:
                fail(f"group {tag}: rank {r}'s per-round metrics differ from the twin's")
            if g["state"] != tree_digest(_server_state(s)):
                fail(f"group {tag}: rank {r}'s state differs from the twin's")

    # a. local_topk: states, client rows, residency, preemption, a checkpoint
    # resumed on one device
    a, a_metrics, a_launches = twin("local_topk", _twin_session(S))
    same_as("a", "local_topk", a, a_metrics)
    a_digest = tree_digest(_server_state(a))
    blocks = _client_blocks(a.client_state, S)
    one_bytes = sum(v.numel() * v.element_size() for v in a.client_state.values())
    resident = []
    for r, got in enumerate(ranks):
        g = got["runs"]["local_topk"]
        if g["block"] != blocks[r]:
            fail(f"group a: rank {r}'s client rows differ from the twin's")
        resident.append(g["resident_bytes"])
        if 4 * g["resident_bytes"] != one_bytes or g["launches"] != a_launches:
            fail(f"group a: rank {r} holds {g['resident_bytes']} bytes of client state (the "
                 f"twin {one_bytes}), launched {g['launches']}")
    print(f"group a: local_topk on {S} gloo ranks, {R} rounds == the one-device twin "
          f"(the emulation at S={S}), bitwise on every rank: params, batch-norm statistics, "
          f"Vvelocity, Verror, every per-round metric and every client row; resident client "
          f"state a rank {[round(b / 1e9, 4) for b in resident]} GB against "
          f"{one_bytes / 1e9:.4f} GB on one device; {secs:.1f} s for the launch of parts "
          f"{list(joint['parts'])} [{card}]",
          flush=True)
    for r, got in enumerate(ranks):
        pre, res = got["runs"]["preempted"], got["runs"]["resumed"]
        if pre["code"] != 75 or pre["metrics"] != a_metrics[:2] or \
                res["metrics"] != a_metrics[2:] or res["state"] != a_digest or \
                res["block"] != blocks[r]:
            fail(f"group a: rank {r}: host_preempt@1:host=2 -> exit {pre['code']}; the resume "
                 "does not land on the uninterrupted run")
    # the group's round-2 checkpoint (the unpadded rows, written by rank 0)
    # restored in a one-device session, the twin, which runs rounds 2 and 3
    # at the logged lrs
    c = _twin_session(S)
    orig = cv_train.FederatedSession
    cv_train.FederatedSession = c
    try:
        c, _ = cv_train.build(resolve_defaults(make_parser().parse_args(
            GROUP_RUNS["local_topk"] + rounds)))
    finally:
        cv_train.FederatedSession = orig
    ckpt.restore(os.path.join(base, "ck", "round_00000002"), c)
    c_metrics = [c.run_round(m["lr"]) for m in a_metrics[2:]]
    if c.round != R or c_metrics != a_metrics[2:] or \
            not all(torch.equal(c.client_state[k], v) for k, v in a.client_state.items()) or \
            tree_digest(_server_state(c)) != a_digest:
        fail("group a: the group's round-2 checkpoint, resumed on one device, does not land on "
             "the uninterrupted run")
    print(f"group a: host_preempt@1:host=2 -> every rank exit 75 at round 2; the group's "
          f"resume == the uninterrupted run, client rows included; the group's round-2 "
          f"checkpoint resumed on one device == the same, bitwise [{card}]", flush=True)
    del a, c
    shutil.rmtree(os.path.join(base, "ck"), ignore_errors=True)
    torch.cuda.empty_cache()

    # b. fedavg, 5 local steps
    b, b_metrics, b_launches = twin("fedavg", _twin_session(S))
    same_as("b", "fedavg", b, b_metrics)
    print(f"group b: fedavg (5 local steps) on {S} gloo ranks, {R} rounds == the one-device "
          f"twin, bitwise on every rank, every per-round metric included [{card}]", flush=True)
    del b

    # c. the table round: trimmed (trim 1), the clip, a 50x client
    c, c_metrics, c_launches = twin("table", functools.partial(FederatedSession,
                                                               client_shards=S))
    same_as("c", "table", c, c_metrics)
    want = {"sketch_accumulate": 8 // S * R, "sketch_query": R}
    quarantined = [m["clients_quarantined"] for m in c_metrics]
    for r, got in enumerate(ranks):
        if got["runs"]["table"]["launches"] != want:
            fail(f"group c: rank {r} launched {got['runs']['table']['launches']} (want {want})")
    if c_launches != {"sketch_accumulate": 8 * R, "sketch_query": R} or not quarantined[1]:
        fail(f"group c: the twin launched {c_launches}, quarantined {quarantined}")
    print(f"group c: the trimmed table round (trim 1, clip 3, a 50x client at round 1) on {S} "
          f"gloo ranks, {R} rounds == the one-device groups at client_shards={S}, bitwise on "
          f"every rank; launches a rank {want} (the twin {c_launches}); quarantined a round "
          f"{quarantined} [{card}]", flush=True)
    del c

    # d. times, on rank 0
    turns, moves, gathers = ranks[0]["turns"], ranks[0]["moves"], ranks[0]["gathers"]
    print(f"group d: local_topk sync round ms on rank 0 (host clock, synced, {GROUP_TURNS} "
          f"turns): group {[round(t, 3) for t in turns['group']]} (median "
          f"{statistics.median(turns['group']):.3f}), one-device twin "
          f"{[round(t, 3) for t in turns['twin']]} (median "
          f"{statistics.median(turns['twin']):.3f}) [{card}]", flush=True)
    print(f"group d: row moves on rank 0 after a barrier, {S} processes on one card through "
          f"host memory: fetch ms {[round(m[0], 3) for m in moves]}, return ms "
          f"{[round(m[1], 3) for m in moves]}; client_row_bytes a round each way "
          f"{[round(m[2] / 1e6, 3) for m in moves]} MB ({[m[3] for m in moves]} of 8 slot rows "
          f"cross ranks); rank 0 sent {[round(m[4] / 1e6, 3) for m in moves]} MB, received "
          f"{[round(m[5] / 1e6, 3) for m in moves]} MB (both ways, as counted) [{card}]",
          flush=True)
    print(f"group d: the table gather on rank 0 after a barrier: ms "
          f"{[round(g[0], 3) for g in gathers]} (median "
          f"{statistics.median(g[0] for g in gathers):.3f}), {gathers[0][1] / 1e6:.2f} MB of "
          f"[{S}, {8 // S}, {SLICE['r']}, {SLICE['c']}] tables on every rank [{card}]",
          flush=True)
    print(f"group: run s on rank 0 "
          + ", ".join(f"{k} {v['s']:.1f}" for k, v in ranks[0]["runs"].items()), flush=True)
    return {run: ranks[0]["runs"][run]["launches"] for run in ranks[0]["runs"]}


def _serve_run(cv_train, kernels, tag: str, argv: list, out: dict, device: str,
               stacks: bool = False):
    """One ``cv_train.main`` run of phase 21 with the launch counts zeroed
    just before: its exit code, per-round metrics, launches, state and
    client-block digests, committed queue and ages, server idle and round
    ms, and (where this process ran the service) the service's counters,
    invite lists and casualties; with ``stacks`` each payload round's merged
    stack's digest; into ``out[tag]``. Returns the session (None after an
    exit)."""
    from commefficient_tpu_torch.parallel import distributed

    kernels.reset_launch_counts()
    distributed.broadcast_stats.update(calls=0, bytes=0, ms=0.0)
    code, s = 0, None
    t0 = time.perf_counter()
    with recording_rounds() as rec, serving_runs() as srv, \
            (recording_stacks() if stacks else contextlib.nullcontext([])) as digests:
        try:
            s = cv_train.main(list(argv))
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    if device == "cuda":
        torch.cuda.synchronize()
    got = {"metrics": rec["metrics"], "launches": ravel_launches(kernels), "code": code,
           "s": time.perf_counter() - t0, "broadcast": dict(distributed.broadcast_stats),
           "stacks": list(digests)}
    if s is not None:
        st = s.run_stats
        got.update(state=tree_digest(_server_state(s)),
                   requeue=[list(s._requeue_committed),
                            [list(a) for a in s._requeue_ages_committed]],
                   idle_ms=[st.server_idle_ms, st.server_idle_ms_max],
                   round_ms=_steady_ms(st),
                   # the loop's host ms a round: waiting for the prepared
                   # round, dispatching it, draining it
                   host_ms=[x / max(st.rounds, 1) for x in (st.prepare_ms, st.dispatch_ms,
                                                            st.drain_ms)])
        if s.client_state is not None:
            got["block"] = tree_digest(s.client_state)
    if srv["runs"]:
        svc, src = srv["runs"][0]
        got["counters"] = svc.queue.counters()
        if svc.cfg.fastpath:
            got["fastpath"] = svc.metrics_snapshot()["fastpath"]
            # process shards run no ring pool in the root (their blocks are
            # the workers' shared-memory segments)
            got["ring_blocks"] = svc._ring.allocated if svc._ring is not None else None
        got["closes"] = [[int(p) for p in np.flatnonzero(c.arrived == 0.0)]
                         for c in src.closed_rounds]
        got["invited"] = [[int(i) for i in c.invited] for c in src.closed_rounds]
        if svc._proc is not None:
            got["spawn_s"] = [round(w.spawn_s, 3) for w in svc._proc.workers]
            got["respawns"] = [(k, round(t, 3)) for k, t in svc._proc.respawns]
    out[tag] = got
    return s


def _serve_group_runs(out_dir: str, device: str, extra: tuple = ()) -> None:
    """On a rank of the joined group, phase 21's runs: (a) the served
    announce and payload runs, (b) the payload run preempted on rank 2 and
    resumed, (c) local_topk served serially and pipelined, then the close's
    broadcast timed after a barrier, then (the whole script) the runs
    ``extra`` of ``served_group_runs()`` for phases 22f to 25f. Writes
    ``out_dir/serve_<rank>.json`` (and ``out_dir/served_<rank>.json``)."""
    import torch.distributed as dist

    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.parallel import distributed
    from commefficient_tpu_torch.sketch import kernels

    rank = distributed.rank()
    out = {"runs": {}}
    runs = out["runs"]
    ck = os.path.join(out_dir, "ck")
    argv = SERVE_GROUP_RUNS
    _serve_run(cv_train, kernels, "announce", argv["announce"], runs, device)
    _serve_run(cv_train, kernels, "payload", argv["payload"], runs, device)
    pre = ["--checkpoint_dir", ck, "--fault_plan", SERVE_GROUP_PLAN + ";host_preempt@1:host=2"]
    _serve_run(cv_train, kernels, "preempted", argv["payload"] + pre, runs, device)
    dist.barrier()
    _serve_run(cv_train, kernels, "resumed", argv["payload"] + pre + ["--resume"], runs, device)
    _serve_run(cv_train, kernels, "local_serial", argv["local_topk"], runs, device)
    _serve_run(cv_train, kernels, "local_pipelined", argv["local_topk"] + ["--serve_pipeline"],
               runs, device)
    # the close's broadcast at the payload round's shape, on rank 0 after a
    # barrier (processes on one card, through host memory)
    W = 8
    parts = [torch.ones(W), torch.randn(W, SLICE["r"], SLICE["c"])]
    group = distributed.serve_group()
    times = []
    for i in range(SERVE_GROUP_TURNS + 1):
        dist.barrier()
        t0 = time.perf_counter()
        got = distributed.broadcast_from_root(parts, group)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    if not all(torch.equal(a, b) for a, b in zip(got, parts)) and rank == 0:
        fail("serve group: rank 0's broadcast changed its own tensors")
    out["broadcast_ms"] = times
    out["broadcast_bytes"] = sum(t.numel() * t.element_size() for t in parts)
    with open(os.path.join(out_dir, f"serve_{rank}.json"), "w") as f:
        json.dump(out, f)
    if extra:
        _served_runs(out_dir, device, extra)
    dist.barrier()


def serve_group_phase(cv_train, engine, csvec, kernels, card: str, extra: tuple = (),
                      joint: dict | None = None) -> tuple:
    """Phase 21: serving on a group of 4 gloo ranks sharing the card, and
    the serving pipeline on one card, at ResNet-9's full width. The group's
    runs are the "serve" part of ``joint`` (a ``joint_launch`` whose extra
    runs are ``extra``; one of its own when None). Returns (each kernel's
    launches over each run, rank 0's for the group's; with ``extra``, the
    same launch's (ranks, seconds) of those runs of ``served_group_runs()``,
    which phases 22f to 25f read, else None)."""
    import functools
    import shutil

    from commefficient_tpu_torch.federated.api import FederatedSession

    device = "cuda" if "cuda" in SLICE_ARGS else "cpu"
    S, R = SERVE_GROUP_SHARDS, SERVE_GROUP_ROUNDS
    joint = joint or joint_launch(("serve",), extra)
    base, codes, secs = joint["bases"]["serve"], joint["codes"], joint["secs"]
    shared = (read_served_group(base, codes, "serve group"), secs) if extra else None
    ranks = []
    for r in range(S):
        path = os.path.join(base, f"serve_{r}.json")
        if not os.path.exists(path):
            fail(f"serve group: rank {r} wrote nothing (exit codes {codes})")
        with open(path) as f:
            ranks.append(json.load(f))
    if codes != [0] * S:
        fail(f"serve group: rank exit codes {codes}")

    # a. against the one-device served runs at client_shards S
    twins = {}
    orig = cv_train.FederatedSession
    cv_train.FederatedSession = functools.partial(FederatedSession, client_shards=S)
    try:
        for tag in ("announce", "payload"):
            _serve_run(cv_train, kernels, tag, SERVE_GROUP_RUNS[tag], twins, device)
    finally:
        cv_train.FederatedSession = orig
    want = {"announce": {"sketch_accumulate": R, "sketch_query": R},
            "payload": {"sketch_accumulate": 8 // S * R, "sketch_query": R}}
    for tag in ("announce", "payload"):
        t = twins[tag]
        for r, got in enumerate(ranks):
            g = got["runs"][tag]
            for key in ("code", "metrics", "state", "requeue"):
                if g[key] != t[key]:
                    fail(f"serve group a: {tag} rank {r}'s {key} differs from the one-device "
                         f"served run at client_shards={S}")
            if g["launches"] != want[tag]:
                fail(f"serve group a: {tag} rank {r} launched {g['launches']} (want "
                     f"{want[tag]})")
        if ranks[0]["runs"][tag]["counters"] != t["counters"] or \
                ranks[0]["runs"][tag]["closes"] != t["closes"]:
            fail(f"serve group a: {tag} rank 0's serve counters or closes differ from the twin's")
        if not any(t["closes"]):
            fail(f"serve group a: {tag}: no casualties, the pin is vacuous")
        b0 = ranks[0]["runs"][tag]["broadcast"]
        print(f"serve group a: {tag} served on {S} gloo ranks, {R} rounds == the one-device "
              f"served run at client_shards={S}, bitwise on every rank: params, Vvelocity, "
              f"Verror, batch-norm statistics, the quarantine's rings, every per-round metric, "
              f"the committed queue and ages; rank 0's counters {json.dumps(t['counters'])} == "
              f"the twin's; casualties a round {t['closes']}; launches a rank {want[tag]} (the "
              f"twin {t['launches']}); rank 0 broadcast {b0['calls']} closes, "
              f"{b0['bytes'] / max(b0['calls'], 1):.0f} bytes each, {b0['ms']:.1f} ms in all "
              f"[{card}]", flush=True)
    times, nbytes = ranks[0]["broadcast_ms"], ranks[0]["broadcast_bytes"]
    print(f"serve group a: the payload close's broadcast on rank 0 after a barrier, {S} "
          f"processes on one card through host memory: {nbytes} bytes ([8] arrived + [8, "
          f"{SLICE['r']}, {SLICE['c']}] float32), ms {[round(x, 3) for x in times]} (median "
          f"{statistics.median(times):.3f}) [{card}]", flush=True)

    # b. preempted on rank 2 at round 1, resumed
    t = twins["payload"]
    with open(os.path.join(base, "ck", "round_00000002", "meta.json")) as f:
        meta = json.load(f)
    for r, got in enumerate(ranks):
        pre, res = got["runs"]["preempted"], got["runs"]["resumed"]
        if pre["code"] != 75 or pre["metrics"] != t["metrics"][:2] or \
                res["code"] != 0 or res["metrics"] != t["metrics"][2:] or \
                res["state"] != t["state"] or res["requeue"] != t["requeue"]:
            fail(f"serve group b: rank {r}: host_preempt@1:host=2 -> exit {pre['code']}; the "
                 "resume does not land on the uninterrupted served run")
    if "serve" not in meta:
        fail("serve group b: no serve block in the group's checkpoint")
    print(f"serve group b: the served payload group, host_preempt@1:host=2 -> every rank exit "
          f"75 at round 2, rank 0's checkpoint with serve block {json.dumps(meta['serve'])}; "
          f"--resume == the uninterrupted run bitwise on every rank [{card}]", flush=True)
    shutil.rmtree(os.path.join(base, "ck"), ignore_errors=True)

    # c. pipelined local_topk on the group, against the serial group run
    for r, got in enumerate(ranks):
        a, p = got["runs"]["local_serial"], got["runs"]["local_pipelined"]
        for key in ("code", "metrics", "state", "block", "requeue"):
            if a[key] != p[key]:
                fail(f"serve group c: rank {r}'s pipelined local_topk {key} differs from the "
                     "serial run's")
    a, p = ranks[0]["runs"]["local_serial"], ranks[0]["runs"]["local_pipelined"]
    print(f"serve group c: served local_topk ({LOCAL_CLIENTS} clients, the client state "
          f"split) on {S} "
          f"gloo ranks, {R} rounds: pipelined == serial bitwise on every rank (params, "
          f"optimizer state, client rows, metrics, queue); rank 0 server_idle_ms mean/max "
          f"serial {[round(x, 3) for x in a['idle_ms']]} pipelined "
          f"{[round(x, 3) for x in p['idle_ms']]}, steady round ms serial {a['round_ms']:.2f} "
          f"pipelined {p['round_ms']:.2f} [{card}]", flush=True)

    # d. pipelined on one card, in turns with serial
    one = {}
    sessions = {}
    for kind, order in (("announce", (False, True)), ("payload", (True, False))):
        for pipelined in order:
            tag = f"{kind}_{'pipelined' if pipelined else 'serial'}"
            sessions[tag] = _serve_run(
                cv_train, kernels, tag, SERVE_ONE_RUNS[kind]
                + (["--serve_pipeline"] if pipelined else []), one, device)
        a, p = one[f"{kind}_serial"], one[f"{kind}_pipelined"]
        for key in ("code", "metrics", "state", "requeue"):
            if a[key] != p[key]:
                fail(f"serve d: the pipelined {kind} run's {key} differs from the serial run's")
        W = 8 if kind == "payload" else 1
        # a payload pipeline's worker may compute one round's tables past
        # the end before its stop
        extra = (0, W) if kind == "payload" else (0,)
        if a["launches"] != {"sketch_accumulate": W * SERVE_ONE_ROUNDS,
                             "sketch_query": SERVE_ONE_ROUNDS} or \
                p["launches"]["sketch_query"] != SERVE_ONE_ROUNDS or \
                p["launches"]["sketch_accumulate"] - W * SERVE_ONE_ROUNDS not in extra:
            fail(f"serve d: {kind} launched {a['launches']} serial, {p['launches']} pipelined")
        print(f"serve d: {kind} on one card, {SERVE_ONE_ROUNDS} rounds, pipelined == serial "
              f"bitwise (params, optimizer state, batch-norm statistics, metrics, queue); "
              f"server_idle_ms mean/max serial {[round(x, 3) for x in a['idle_ms']]} "
              f"pipelined {[round(x, 3) for x in p['idle_ms']]}; steady round ms serial "
              f"{a['round_ms']:.2f} pipelined {p['round_ms']:.2f}; launches serial "
              f"{a['launches']}, pipelined {p['launches']} [{card}]", flush=True)
    s = sessions["payload_pipelined"]
    check_kernels(csvec, s.cfg.mode.sketch_spec, s.state["params"],
                  s.state["mode_state"]["Verror"])
    print("serve d: kernels == plain on the pipelined payload run's params and error table",
          flush=True)
    del sessions, s
    print(f"serve group: {secs:.1f} s for the launch of parts {list(joint['parts'])}; run s "
          f"on rank 0 "
          + ", ".join(f"{k} {v['s']:.1f}" for k, v in ranks[0]["runs"].items())
          + "; one card " + ", ".join(f"{k} {v['s']:.1f}" for k, v in one.items()), flush=True)
    launches = {f"group_{k}": v["launches"] for k, v in ranks[0]["runs"].items()}
    launches.update({k: v["launches"] for k, v in one.items()})
    return launches, shared


@contextlib.contextmanager
def recording_folds(engine):
    """Inside the block, the last table ``engine._stale_fold`` returned
    (rec["table"], a copy), how many folds ran (rec["folds"]) and, on the
    card, each fold's CUDA-event ms (rec["ms"], read at the block's end)."""
    rec = {"table": None, "folds": 0, "ms": []}
    fold = engine._stale_fold
    events = []

    def fold_rec(*a):
        cuda = a[0].is_cuda
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record()
        out = fold(*a)
        if cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            events.append((t0, t1))
        rec["table"], rec["folds"] = out[0].clone(), rec["folds"] + 1
        return out

    engine._stale_fold = fold_rec
    try:
        yield rec
    finally:
        engine._stale_fold = fold
        for t0, t1 in events:
            t1.synchronize()
            rec["ms"].append(t0.elapsed_time(t1))


def _served_group_rank(out_dir: str, device: str, tags: tuple) -> None:
    """One rank of a gloo group of its own for the runs ``tags`` of
    ``served_group_runs()`` (phase 22f or 23e run alone)."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from commefficient_tpu_torch.parallel import distributed

    distributed.initialize(force=True, backend="gloo", device=device,
                           serve_deadline_s=float(ASYNC_BASE[ASYNC_BASE.index(
                               "--serve_deadline") + 1]))
    _served_runs(out_dir, device, tags)
    dist.barrier()


def _served_runs(out_dir: str, device: str, tags: tuple) -> None:
    """On a rank of a joined group: the runs ``tags`` of
    ``served_group_runs()``, each broadcast's bytes recorded by run. Writes
    ``out_dir/served_<rank>.json``."""
    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.parallel import distributed
    from commefficient_tpu_torch.sketch import kernels

    reuse_run_inputs(cv_train)
    sizes = []
    broadcast = distributed.broadcast_from_root

    def sized(tensors, group=None):
        sizes.append(sum(t.numel() * t.element_size() for t in tensors))
        return broadcast(tensors, group)

    distributed.broadcast_from_root = sized
    out = {"runs": {}, "sizes": {}}
    try:
        for tag in tags:
            sizes.clear()
            _serve_run(cv_train, kernels, tag, served_group_runs()[tag], out["runs"], device)
            out["sizes"][tag] = list(sizes)
    finally:
        distributed.broadcast_from_root = broadcast
    with open(os.path.join(out_dir, f"served_{distributed.rank()}.json"), "w") as f:
        json.dump(out, f)


def served_group_runs() -> dict:
    """The served runs on a group: phase 22f's async run, phase 23e's fast
    one, phase 24d's fast run over process shards (rank 0's ingest) and
    phase 25f's edge tree."""
    return {"async": ASYNC_ARGS + ["--num_rounds", str(ASYNC_SHORT), "--sync_loop"],
            "fast": FAST_BASE + ["--serve_fastpath", "--num_rounds", str(FAST_GROUP_ROUNDS)],
            "proc": SHARD_BASE + ["--serve_fastpath", "--serve_shards", str(shard_count()),
                                  "--serve_shard_mode", "process", "--num_rounds",
                                  str(SHARD_GROUP_ROUNDS)],
            "edge": EDGE_CLIP + ["--serve_edges", "2"]}


def launch_served_group(base: str, device: str, tags: tuple, label: str) -> tuple:
    """One launch of ASYNC_GROUP_SHARDS gloo ranks sharing the card, running
    the runs ``tags``: (each rank's output, the launch's seconds)."""
    from commefficient_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    codes = distributed.launch_local(_served_group_rank, ASYNC_GROUP_SHARDS,
                                     (base, device, tuple(tags)), env={"LOCAL_RANK": "0"},
                                     timeout_s=600)
    return read_served_group(base, codes, label), time.perf_counter() - t0


def read_served_group(base: str, codes: list, label: str) -> list:
    """Each rank's ``served_<rank>.json`` in ``base``; fails on a missing
    file or a rank's non-zero exit code."""
    ranks = []
    for rk in range(ASYNC_GROUP_SHARDS):
        path = os.path.join(base, f"served_{rk}.json")
        if not os.path.exists(path):
            fail(f"{label}: rank {rk} wrote nothing (exit codes {codes})")
        with open(path) as f:
            ranks.append(json.load(f))
    if codes != [0] * ASYNC_GROUP_SHARDS:
        fail(f"{label}: rank exit codes {codes}")
    return ranks


def async_phase(cv_train, engine, csvec, kernels, card: str, group=None) -> dict:
    """Phase 22: the buffered-async service on ResNet-9 FetchSGD at full
    width, served payload, in process. ``group``: phase 21's launch's
    (ranks, seconds), where the whole script ran (f)'s async run; None
    launches the group here. Returns each kernel's launches over each run
    (rank 0's for the group's)."""
    import functools
    import shutil

    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.obs import registry as obreg

    device = "cuda" if "cuda" in SLICE_ARGS else "cpu"
    base = os.path.join(ROOT, "build", "chip_smoke", "async")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    runs, sessions, folds = {}, {}, {}
    short, rounds = ["--num_rounds", str(ASYNC_SHORT)], ["--num_rounds", str(ASYNC_ROUNDS)]

    def run(tag, argv):
        with recording_folds(engine) as rec:
            sessions[tag] = _serve_run(cv_train, kernels, tag, argv, runs, device)
        folds[tag] = rec
        s = sessions[tag]
        if s is not None:
            runs[tag]["copies"] = s.wire_copy_stats()
        return runs[tag]

    def per_round(tag):
        want = {"sketch_accumulate": 8 * len(runs[tag]["metrics"]),
                "sketch_query": len(runs[tag]["metrics"])}
        if runs[tag]["launches"] != want:
            fail(f"async {tag}: launched {runs[tag]['launches']} (want {want})")

    # a. everyone on time: async == sync
    a = run("sync_q8", ASYNC_BASE + ["--serve_quorum", "8", "--sync_loop"] + short)
    b = run("async_b8", ASYNC_BASE + ["--serve_async", "--serve_buffer", "8",
                                      "--sync_loop"] + short)
    for key in ("code", "metrics", "state", "requeue"):
        if a[key] != b[key]:
            fail(f"async a: --serve_buffer 8's {key} differs from the sync served run's")
    for tag in ("sync_q8", "async_b8"):
        per_round(tag)
    if folds["async_b8"]["folds"] or any("stale_folded" in m for m in b["metrics"]):
        fail("async a: a fold ran with every client on time")
    print(f"async a: --serve_async --serve_buffer 8 == the sync served run, {ASYNC_SHORT} "
          f"rounds, bitwise (params, optimizer state, batch-norm statistics, metrics, queue); "
          f"no fold ran; launches {b['launches']}; casualties a round {b['closes']} [{card}]",
          flush=True)

    # b. buffer 6 of 8, twice
    b1 = run("async_b6", ASYNC_ARGS + ["--sync_loop"] + rounds)
    b2 = run("async_b6_again", ASYNC_ARGS + ["--sync_loop"] + rounds)
    for key in ("code", "metrics", "state", "requeue"):
        if b1[key] != b2[key]:
            fail(f"async b: the second buffer-6 run's {key} differs from the first's")
    per_round("async_b6")
    stale = [(m.get("stale_folded", 0.0), m.get("stale_weight", 0.0)) for m in b1["metrics"]]
    if stale[0][0] or not all(f > 0 for f, _ in stale[1:]) or \
            not all(0 < w < f for f, w in stale[1:]):
        fail(f"async b: (stale_folded, stale_weight) a round {stale}")
    s = sessions["async_b6"]
    spec = s.cfg.mode.sketch_spec
    folded = folds["async_b6"]["table"]
    check_kernels(csvec, spec, s.state["params"], folded)
    check_kernels(csvec, spec, s.state["params"], s.state["mode_state"]["Verror"])
    cp = b1["copies"]
    h2d, hst = cp.get("h2d", {}), cp.get("h2d_stale", {})
    print(f"async b: --serve_buffer 6 --serve_stale_rounds 1 --serve_staleness 0.5, "
          f"{ASYNC_ROUNDS} rounds, twice: bitwise equal; (stale_folded, stale_weight) a round "
          f"{stale}; {folds['async_b6']['folds']} folds; kernels == plain on the run's last "
          f"folded table and its error table; launches {b1['launches']} [{card}]", flush=True)
    print(f"async b: H2D a run: the live stacks {h2d.get('bytes', 0)} bytes in "
          f"{h2d.get('copies', 0)} copies, {h2d.get('ms', 0.0):.3f} ms; the stale stacks "
          f"{hst.get('bytes', 0)} bytes in {hst.get('copies', 0)} copies, "
          f"{hst.get('ms', 0.0):.3f} ms (CUDA events) [{card}]", flush=True)
    del sessions["async_b6_again"]

    # c. the robust merges under the stale-band poison, beside clean runs
    for pol, flags in (("trimmed", ["--merge_policy", "trimmed", "--merge_trim", "2"]),
                       ("median", ["--merge_policy", "median"])):
        run(f"{pol}_clean", ASYNC_ARGS + flags + ["--sync_loop"] + short)
        mark = obreg.default().mark()
        pois = run(f"{pol}_poisoned", ASYNC_ARGS + flags + ["--sync_loop", "--fault_plan",
                                                            ASYNC_POISON_PLAN] + short)
        attacks = mark.delta("resilience_attack_stale_poison_total")
        admitted = mark.delta("serve_stale_admitted_total")
        per_round(f"{pol}_clean")
        per_round(f"{pol}_poisoned")
        clean_p = sessions.pop(f"{pol}_clean").state["params"]
        pois_p = sessions.pop(f"{pol}_poisoned").state["params"]
        if attacks != 1 or admitted < 2 or not torch.isfinite(pois_p).all() or \
                pois["metrics"][3].get("stale_folded", 0) < 2:
            fail(f"async c: {pol}: attacks {attacks}, late tables admitted {admitted}, "
                 f"round 3 {pois['metrics'][3]}")
        dist = float((pois_p - clean_p).norm() / clean_p.norm())
        print(f"async c: {pol} under {ASYNC_POISON_PLAN}: the withheld pair no-shows round 2, "
              f"their -5x tables ACCEPTED_STALE ({admitted:.0f}) and folded into round 3's "
              f"union stack ({pois['metrics'][3]['stale_folded']:.0f} slots); params "
              f"{dist:.3e} (rel L2) from the clean async {pol} run [{card}]", flush=True)
        del clean_p, pois_p

    # d. preempted at round 3 with the band non-empty, resumed
    ck = os.path.join(base, "ck")
    pre = ["--sync_loop", "--checkpoint_dir", ck]
    p = run("preempted", ASYNC_ARGS + pre + rounds + ["--fault_plan", "preempt@3"])
    # the emergency checkpoint after the in-flight round 3: round 4's
    meta = os.path.join(ck, sorted(os.listdir(ck))[-1], "meta.json")
    with open(meta) as f:
        band = json.load(f)["serve"]["band"]
    depth = len(band["stale"]) + len(band["stash"])
    r = run("resumed", ASYNC_ARGS + pre + rounds + ["--fault_plan", "preempt@3", "--resume"])
    if p["code"] != 75 or depth < 1 or r["code"] != 0 or \
            p["metrics"] + r["metrics"] != b1["metrics"] or r["state"] != b1["state"] or \
            r["requeue"] != b1["requeue"]:
        fail(f"async d: preempt@3 -> exit {p['code']}, band of {depth}; the resume does not "
             "land on (b)'s run")
    print(f"async d: preempt@3 -> exit 75, the checkpoint at round {len(p['metrics'])} with "
          f"{depth} late table(s) in its band ({os.path.getsize(meta)} bytes of meta.json); "
          f"--resume == (b) bitwise [{card}]", flush=True)
    shutil.rmtree(ck, ignore_errors=True)

    # e. pipelined == serial; the sync twin at quorum 6, serial and pipelined
    e = run("async_b6_pipelined", ASYNC_ARGS + ["--serve_pipeline", "--sync_loop"] + rounds)
    for key in ("code", "metrics", "state", "requeue"):
        if e[key] != b1[key]:
            fail(f"async e: the pipelined run's {key} differs from the serial run's")
    extra = e["launches"]["sketch_accumulate"] - 8 * ASYNC_ROUNDS
    if e["launches"]["sketch_query"] != ASYNC_ROUNDS or extra not in (0, 8):
        fail(f"async e: the pipelined run launched {e['launches']}")
    q6 = ASYNC_BASE + ["--serve_quorum", "6", "--sync_loop"] + rounds
    sy = run("sync_q6", q6)
    sp = run("sync_q6_pipelined", q6 + ["--serve_pipeline"])
    print(f"async e: the pipelined async run == serial bitwise; steady round ms / "
          f"server_idle_ms mean: sync quorum 6 serial {sy['round_ms']:.2f} / "
          f"{sy['idle_ms'][0]:.3f}, pipelined {sp['round_ms']:.2f} / {sp['idle_ms'][0]:.3f}; "
          f"async buffer 6 serial {b1['round_ms']:.2f} / {b1['idle_ms'][0]:.3f}, pipelined "
          f"{e['round_ms']:.2f} / {e['idle_ms'][0]:.3f} [{card}]", flush=True)
    print("async e: host ms a round (prepare, dispatch, drain): " + "; ".join(
        f"{tag} {[round(x, 3) for x in runs[tag]['host_ms']]}"
        for tag in ("sync_q6", "sync_q6_pipelined", "async_b6", "async_b6_pipelined"))
        + f"; the fold's CUDA-event ms {[round(x, 4) for x in folds['async_b6']['ms']]} "
        f"[{card}]", flush=True)
    sessions.clear()
    if device == "cuda":
        torch.cuda.empty_cache()

    # f. on a group of 4 gloo ranks sharing the card (phase 21's launch ran
    # it when the whole script runs)
    S = ASYNC_GROUP_SHARDS
    shared = group is not None
    ranks, secs = group or launch_served_group(base, device, ("async",), "async f")
    orig = cv_train.FederatedSession
    cv_train.FederatedSession = functools.partial(FederatedSession, client_shards=S)
    try:
        twin = run("group_twin", ASYNC_ARGS + ["--num_rounds", str(ASYNC_SHORT), "--sync_loop"])
    finally:
        cv_train.FederatedSession = orig
    want = {"sketch_accumulate": 8 // S * ASYNC_SHORT, "sketch_query": ASYNC_SHORT}
    for rk, got in enumerate(ranks):
        g = got["runs"]["async"]
        for key in ("code", "metrics", "state", "requeue"):
            if g[key] != twin[key]:
                fail(f"async f: rank {rk}'s {key} differs from the one-device run at "
                     f"client_shards={S}")
        if g["launches"] != want:
            fail(f"async f: rank {rk} launched {g['launches']} (want {want})")
    if ranks[0]["runs"]["async"]["counters"] != twin["counters"]:
        fail("async f: rank 0's serve counters differ from the twin's")
    sizes = ranks[0]["sizes"]["async"]
    print(f"async f: async buffer 6 on {S} gloo ranks, {ASYNC_SHORT} rounds == the one-device "
          f"run at client_shards={S}, bitwise on every rank (params, optimizer state, "
          f"batch-norm statistics, metrics, queue); launches a rank {want}; rank 0's "
          f"broadcasts a round (mask + count, then the stack and the filled slots), bytes "
          f"{[sizes[i:i + 2] for i in range(0, len(sizes), 2)]}: round 0 without stale "
          f"slots, later rounds with them; {secs:.1f} s for the launch"
          f"{' (shared with phase 21)' if shared else ''} [{card}]", flush=True)
    print("async: run s " + ", ".join(f"{k} {v['s']:.1f}" for k, v in runs.items()), flush=True)
    launches = {k: v["launches"] for k, v in runs.items()}
    launches["group_async"] = ranks[0]["runs"]["async"]["launches"]
    return launches


@contextlib.contextmanager
def recording_merges(csvec):
    """Inside the block, the last table ``csvec.merge_tables`` returned
    (rec["table"], a copy): a payload round's merged table."""
    rec = {"table": None}
    merge = csvec.merge_tables

    def merge_rec(spec, tables):
        out = merge(spec, tables)
        rec["table"] = out.clone()
        return out

    csvec.merge_tables = merge_rec
    try:
        yield rec
    finally:
        csvec.merge_tables = merge


@contextlib.contextmanager
def recording_stacks():
    """Inside the block, the digest of each payload round's merged [W, r, c]
    stack (the close's host stack or the ring-built device one), in the
    order the service finished them."""
    from commefficient_tpu_torch.federated.api import FederatedSession

    digests = []
    finish = FederatedSession.finish_served_payload

    def finish_rec(self, prep0, arrived, wire_tables, aux, stale=None, **edge):
        t = wire_tables if torch.is_tensor(wire_tables) else torch.from_numpy(
            np.asarray(wire_tables))
        digests.append(tree_digest({"stack": t}))
        return finish(self, prep0, arrived, wire_tables, aux, stale=stale, **edge)

    FederatedSession.finish_served_payload = finish_rec
    try:
        yield digests
    finally:
        FederatedSession.finish_served_payload = finish


@contextlib.contextmanager
def counting_stderr(needle: str):
    """Inside the block stderr passes through, and rec["n"] counts the
    occurrences of ``needle`` written to it (from any thread)."""
    rec = {"n": 0}
    real = sys.stderr

    class Tee:
        def write(self, text):
            rec["n"] += text.count(needle)
            return real.write(text)

        def __getattr__(self, name):
            return getattr(real, name)

    sys.stderr = Tee()
    try:
        yield rec
    finally:
        sys.stderr = real


def _pinned_stats() -> dict | None:
    """The host allocator's pinned blocks made and handed out so far (None
    where this torch has no ``host_memory_stats``)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    got = stats()
    return {"made": int(got.get("num_host_alloc", 0)),
            "handed_out": int(got.get("active_requests.allocated", 0))}


def fastpath_phase(cv_train, engine, csvec, kernels, card: str, group=None,
                   runs_out: dict | None = None) -> dict:
    """Phase 23: the serving fast path on ResNet-9 FetchSGD's served payload
    round at full width. ``group``: phase 21's launch's (ranks, seconds),
    where the whole script ran (e)'s fast run; None launches the group here.
    Returns each kernel's launches over each run (rank 0's for the
    group's); ``runs_out`` receives (b)'s eventloop runs, each round's stack
    digested, which phase 24 reads."""
    import functools
    import shutil

    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.obs import registry as obreg

    device = "cuda" if "cuda" in SLICE_ARGS else "cpu"
    base = os.path.join(ROOT, "build", "chip_smoke", "fastpath")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    reg = obreg.default()
    runs, merged = {}, {}
    fast = ["--serve_fastpath"]
    table_bytes = 4 * SLICE["r"] * SLICE["c"]

    def run(tag, argv, keep=False):
        batches = reg.histogram("serve_gauntlet_batch_ms").count
        pins = _pinned_stats()
        mark = reg.mark()
        reg.histogram("serve_stage_collect_ms").reset_window()
        with recording_merges(csvec) as rec:
            s = _serve_run(cv_train, kernels, tag, argv, runs, device,
                           stacks=tag.startswith("socket_eventloop"))
        r = runs[tag]
        r["collect_p50"] = reg.histogram("serve_stage_collect_ms").summary()["p50"]
        r["bytes_copied"] = mark.delta("serve_table_bytes_copied_total")
        r["batches"] = reg.histogram("serve_gauntlet_batch_ms").count - batches
        after = _pinned_stats()
        r["pinned"] = None if pins is None else {k: after[k] - pins[k] for k in pins}
        if s is not None:
            r["copies"] = s.wire_copy_stats()
            if keep:
                merged[tag] = (s, rec["table"])
        return r

    def same(tag, twin, label, keys=("code", "metrics", "state", "requeue", "counters")):
        for key in keys:
            if runs[tag][key] != runs[twin][key]:
                fail(f"fastpath {label}: {tag}'s {key} differs from {twin}'s")

    def per_round(tag, rounds, past_end=False):
        n = runs[tag]["launches"]
        extra = n["sketch_accumulate"] - 8 * rounds
        if n["sketch_query"] != rounds or extra not in ((0, 8) if past_end else (0,)):
            fail(f"fastpath {tag}: launched {n} in {rounds} rounds")

    def per_table(tag):
        r = runs[tag]
        return r["bytes_copied"] / max(r["counters"]["accepted"], 1) / table_bytes

    with counting_stderr("gauntlet batch failed") as failures:
        # a. in process, in turns
        argv = FAST_BASE + ["--num_rounds", str(FAST_ROUNDS)]
        turns = ["slow_1", "fast_1", "fast_2", "slow_2"]
        for tag in turns:
            run(tag, argv + (fast if tag.startswith("fast") else []), keep=tag == "fast_2")
        for tag in turns:
            same(tag, "slow_1", "a")
            per_round(tag, FAST_ROUNDS)
        c = runs["fast_1"]["counters"]
        if c["rejected_malformed"] < 1 or c["rejected_quarantined"] < 1:
            fail(f"fastpath a: the chaos never reached the validation: {c}")
        s, table = merged.pop("fast_2")
        spec = s.cfg.mode.sketch_spec
        check_kernels(csvec, spec, s.state["params"], table)
        check_kernels(csvec, spec, s.state["params"], s.state["mode_state"]["Verror"])
        del s, table
        print(f"fastpath a: in process, {FAST_ROUNDS} rounds under {FAST_PLAN} (clip 3), slow, "
              f"fast, fast, slow: bitwise equal (params, optimizer state, batch-norm "
              f"statistics, metrics, queue, admission counters {c}); launches "
              f"{runs['fast_1']['launches']}; kernels == plain on the fast run's last merged "
              f"table and its error table [{card}]", flush=True)

        # b. over the socket, each engine
        ratios = {}
        for eng in ("eventloop", "threaded"):
            argv = FAST_BASE + ["--serve", "socket", "--serve_transport", eng,
                                "--num_rounds", str(FAST_SOCKET_ROUNDS)]
            slow_t, fast_t = f"socket_{eng}_slow", f"socket_{eng}_fast"
            run(slow_t, argv)
            run(fast_t, argv + fast)
            same(fast_t, slow_t, f"b {eng}")
            per_round(slow_t, FAST_SOCKET_ROUNDS)
            per_round(fast_t, FAST_SOCKET_ROUNDS)
            if runs[fast_t]["batches"] < 1 or runs[slow_t]["batches"]:
                fail(f"fastpath b {eng}: {runs[fast_t]['batches']} validation batches fast, "
                     f"{runs[slow_t]['batches']} slow")
            ratios[eng] = (per_table(slow_t), per_table(fast_t))
            ms = runs[fast_t]["fastpath"]["gauntlet_batch_ms"]
            print(f"fastpath b: socket ({eng}), {FAST_SOCKET_ROUNDS} rounds: fast == slow "
                  f"bitwise; {runs[fast_t]['batches']} validation batches (the process's "
                  f"batch ms p50 {ms['p50']}, p99 {ms['p99']}); host copies of a table "
                  f"slow {ratios[eng][0]:.3f}, fast {ratios[eng][1]:.3f} (ratio "
                  f"{ratios[eng][0] / max(ratios[eng][1], 1e-9):.3f}); steady round ms slow "
                  f"{runs[slow_t]['round_ms']:.2f}, fast {runs[fast_t]['round_ms']:.2f} "
                  f"[{card}]", flush=True)

        # c. async buffer 6, d. pipelined: each against its slow twin
        short = ["--num_rounds", str(ASYNC_SHORT)]
        argv = FAST_BASE + ["--serve_async", "--serve_buffer", "6", "--serve_stale_rounds", "1",
                            "--serve_staleness", "0.5"] + short
        run("async_slow", argv)
        run("async_fast", argv + fast)
        same("async_fast", "async_slow", "c")
        per_round("async_fast", ASYNC_SHORT)
        if not any(m.get("stale_folded", 0) for m in runs["async_fast"]["metrics"]):
            fail("fastpath c: no late table folded")
        argv = FAST_BASE + ["--serve_pipeline"] + short
        run("pipelined_slow", argv)
        run("pipelined_fast", argv + fast)
        # a pipeline's worker may serve a round past the end before its
        # stop, whose admissions count
        same("pipelined_fast", "pipelined_slow", "d", ("code", "metrics", "state", "requeue"))
        per_round("pipelined_fast", ASYNC_SHORT, past_end=True)
        print(f"fastpath c, d: async buffer 6 and pipelined, {ASYNC_SHORT} rounds each: fast "
              f"== slow bitwise; stale_folded a round "
              f"{[m.get('stale_folded', 0.0) for m in runs['async_fast']['metrics']]}; "
              f"launches {runs['async_fast']['launches']}, pipelined "
              f"{runs['pipelined_fast']['launches']} [{card}]", flush=True)
        if device == "cuda":
            torch.cuda.empty_cache()

        # e. on a group of 4 gloo ranks sharing the card (phase 21's launch
        # ran it when the whole script runs)
        S = ASYNC_GROUP_SHARDS
        out, secs = group or launch_served_group(base, device, ("fast",), "fastpath e")
        ranks = [r["runs"]["fast"] for r in out]
        orig = cv_train.FederatedSession
        cv_train.FederatedSession = functools.partial(FederatedSession, client_shards=S)
        try:
            twin = run("group_twin", FAST_BASE + fast + ["--num_rounds",
                                                         str(FAST_GROUP_ROUNDS)])
        finally:
            cv_train.FederatedSession = orig
        want = {"sketch_accumulate": 8 // S * FAST_GROUP_ROUNDS,
                "sketch_query": FAST_GROUP_ROUNDS}
        for rk, g in enumerate(ranks):
            for key in ("code", "metrics", "state", "requeue"):
                if g[key] != twin[key]:
                    fail(f"fastpath e: rank {rk}'s {key} differs from the one-device fast run "
                         f"at client_shards={S}")
            if g["launches"] != want:
                fail(f"fastpath e: rank {rk} launched {g['launches']} (want {want})")
        if ranks[0]["counters"] != twin["counters"]:
            fail("fastpath e: rank 0's serve counters differ from the twin's")
        print(f"fastpath e: the fast run on {S} gloo ranks, {FAST_GROUP_ROUNDS} rounds == the "
              f"one-device fast run at client_shards={S}, bitwise on every rank (params, "
              f"optimizer state, batch-norm statistics, metrics, queue); rank 0 broadcast its "
              f"ring-built stack, {ranks[0]['broadcast']['bytes']} bytes in "
              f"{ranks[0]['broadcast']['calls']} broadcasts; launches a rank {want}; "
              f"{secs:.1f} s for the launch{' (shared with phase 21)' if group else ''} "
              f"[{card}]", flush=True)
    if failures["n"]:
        fail(f"fastpath: {failures['n']} 'gauntlet batch failed' line(s)")

    # f. the numbers, in turns (a's runs: slow, fast, fast, slow)
    for tag in turns:
        r = runs[tag]
        cp = r["copies"]
        h2d = cp.get("h2d_ring" if tag.startswith("fast") else "h2d", {})
        print(f"fastpath f: {tag}: host copies of a table {per_table(tag):.3f} "
              f"({r['bytes_copied']:.0f} bytes, {r['counters']['accepted']} accepted); H2D "
              f"{h2d.get('copies', 0)} copies, {h2d.get('bytes', 0)} bytes, "
              f"{h2d.get('ms', 0.0):.3f} ms (CUDA events; a run); D2H "
              f"{cp.get('d2h', {}).get('ms', 0.0):.3f} ms; host ms a round (prepare, "
              f"dispatch, drain) {[round(x, 3) for x in r['host_ms']]}; steady round ms "
              f"{r['round_ms']:.2f}; server_idle_ms {r['idle_ms'][0]:.3f}; ring blocks made "
              f"{r.get('ring_blocks', 'none')}; the host allocator's pinned blocks made / "
              f"handed out {r['pinned'] if r['pinned'] is not None else 'not measured'} "
              f"[{card}]", flush=True)
    print("fastpath: run s " + ", ".join(f"{k} {v['s']:.1f}" for k, v in runs.items()),
          flush=True)
    if runs_out is not None:
        runs_out.update({k: v for k, v in runs.items() if k.startswith("socket_eventloop")})
    launches = {k: v["launches"] for k, v in runs.items()}
    launches["group_fast"] = ranks[0]["launches"]
    return launches


def shard_count() -> int:
    """Phase 24's process shards: SHARDS, or as many blocks of the cohort
    (W = 8 tables of r x c) as /dev/shm holds; fails below 2."""
    from commefficient_tpu_torch.serve.scale.shmring import layout, shm_free_bytes

    W = int(SLICE_ARGS[SLICE_ARGS.index("--num_workers") + 1])
    per = layout(SLICE["r"], SLICE["c"], W)[4]
    free = shm_free_bytes()
    n = SHARDS if free is None else min(SHARDS, free // per)
    if n < 2:
        fail(f"shards: /dev/shm has {free} bytes free; 2 shared-memory table ring blocks "
             f"need {2 * per}")
    return int(n)


def shards_phase(cv_train, engine, csvec, kernels, card: str, group=None,
                 eventloop: dict | None = None) -> dict:
    """Phase 24: the sharded ingest on phase 23b's socket eventloop cell at
    full width. ``group``: phase 21's launch's (ranks, seconds), where the
    whole script ran (d)'s run; None launches the group here. ``eventloop``:
    phase 23b's one-listener runs where the whole script ran them; None
    runs them here. Returns each kernel's launches over each run (rank 0's
    for the group's)."""
    import functools
    import shutil

    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.obs import registry as obreg
    from commefficient_tpu_torch.serve.scale import loadgen
    from commefficient_tpu_torch.serve.scale.procshard import ProcShardedIngest
    from commefficient_tpu_torch.serve.scale.shard import shard_for
    from commefficient_tpu_torch.serve.scale.shmring import layout, shm_free_bytes

    device = "cuda" if "cuda" in SLICE_ARGS else "cpu"
    shared = group is not None
    base = os.path.join(ROOT, "build", "chip_smoke", "shards")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    reg = obreg.default()
    N = shard_count()
    W = int(SLICE_ARGS[SLICE_ARGS.index("--num_workers") + 1])
    table_bytes = 4 * SLICE["r"] * SLICE["c"]
    shm_bytes = N * layout(SLICE["r"], SLICE["c"], W)[4]
    print(f"shards: /dev/shm {shm_free_bytes()} bytes free; {N} process shards, "
          f"{shm_bytes} bytes of shared-memory ring; os.cpu_count() {os.cpu_count()} "
          f"[{card}]", flush=True)
    runs = dict(eventloop or {})
    group = group or launch_served_group(base, device, ("proc",), "shards d")
    fast = ["--serve_fastpath"]
    thread = ["--serve_shards", str(N), "--serve_shard_mode", "thread"]
    proc = ["--serve_shards", str(N), "--serve_shard_mode", "process"]
    rounds = ["--num_rounds", str(SHARD_ROUNDS)]

    def shm_names():
        return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()

    def run(tag, argv):
        names, mark = shm_names(), reg.mark()
        reg.histogram("serve_stage_collect_ms").reset_window()
        s = _serve_run(cv_train, kernels, tag, argv, runs, device, stacks=True)
        r = runs[tag]
        r["collect_p50"] = reg.histogram("serve_stage_collect_ms").summary()["p50"]
        r["bytes_copied"] = mark.delta("serve_table_bytes_copied_total")
        r["deaths"] = mark.delta("serve_shard_deaths_total")
        r["copies"] = s.wire_copy_stats() if s is not None else {}
        if shm_names() != names:
            fail(f"shards {tag}: /dev/shm holds {sorted(shm_names() ^ names)} after the run")
        return r

    def same(tag, twin, label, keys=("code", "metrics", "state", "requeue", "counters",
                                     "stacks")):
        for key in keys:
            if runs[tag][key] != runs[twin][key]:
                fail(f"shards {label}: {tag}'s {key} differs from {twin}'s")

    def per_round(tag, n_rounds):
        want = {"sketch_accumulate": W * n_rounds, "sketch_query": n_rounds}
        if runs[tag]["launches"] != want:
            fail(f"shards {tag}: launched {runs[tag]['launches']} in {n_rounds} rounds "
                 f"(want {want})")

    def numbers(tag):
        r = runs[tag]
        h2d = r["copies"].get("h2d_ring", r["copies"].get("h2d", {}))
        per_table = r["bytes_copied"] / max(r["counters"]["accepted"], 1) / table_bytes
        return (f"steady round ms {r['round_ms']:.2f}; serve_stage_collect_ms p50 "
                f"{r['collect_p50']}; host copies of a table {per_table:.3f}; H2D "
                f"{h2d.get('copies', 0)} copies, {h2d.get('bytes', 0)} bytes, "
                f"{h2d.get('ms', 0.0):.3f} ms (CUDA events; a run); launches {r['launches']}"
                + (f"; worker spawn s {r['spawn_s']}, respawns {r['respawns']}"
                   if "spawn_s" in r else ""))

    # a. the one listener (phase 23b's runs in the whole script) and thread
    # shards
    for tag, extra in (("socket_eventloop_slow", []), ("socket_eventloop_fast", fast)):
        if tag not in runs:
            run(tag, SHARD_BASE + rounds + extra)
    run("thread_fast", SHARD_BASE + rounds + thread + fast)
    same("socket_eventloop_fast", "socket_eventloop_slow", "a")
    same("thread_fast", "socket_eventloop_slow", "a")
    for tag in ("socket_eventloop_slow", "socket_eventloop_fast", "thread_fast"):
        per_round(tag, SHARD_ROUNDS)
    c = runs["thread_fast"]["counters"]
    if c["rejected_malformed"] < 1 or c["rejected_quarantined"] < 1:
        fail(f"shards a: the chaos never reached the validation: {c}")
    print(f"shards a: {N} thread shards, {SHARD_ROUNDS} rounds, fast == the one listener slow "
          f"and fast bitwise (params, optimizer state, batch-norm statistics, metrics, queue, "
          f"admission counters, each round's stack) [{card}]", flush=True)

    # b. process shards, slow and fast
    run("process_slow", SHARD_BASE + rounds + proc)
    run("process_fast", SHARD_BASE + rounds + proc + fast)
    for tag in ("process_slow", "process_fast"):
        same(tag, "socket_eventloop_slow", "b")
        per_round(tag, SHARD_ROUNDS)
        if runs[tag]["deaths"] or runs[tag]["respawns"]:
            fail(f"shards b: {tag} lost a worker")
    print(f"shards b: {N} process shards, {SHARD_ROUNDS} rounds, slow and fast == (a) bitwise "
          f"(the same keys) [{card}]", flush=True)
    for tag in ("socket_eventloop_slow", "socket_eventloop_fast", "thread_fast",
                "process_slow", "process_fast"):
        print(f"shards a/b: {tag}: {numbers(tag)} [{card}]", flush=True)

    # c. shard_kill against client_drop of the dead shard's positions
    plan_i = SHARD_BASE.index("--fault_plan") + 1
    kill = list(SHARD_BASE)
    kill[plan_i] = f"{FAST_PLAN};shard_kill@{KILL_ROUND}:shards={KILL_SHARD}"
    run("kill", kill + rounds + proc + fast)
    ids = runs["kill"]["invited"][KILL_ROUND]
    doomed = [p for p, cid in enumerate(ids) if shard_for(cid, N) == KILL_SHARD]
    if not doomed:
        fail(f"shards c: shard {KILL_SHARD} owns none of round {KILL_ROUND}'s cohort {ids}")
    drop = list(SHARD_BASE)
    drop[plan_i] = (f"{FAST_PLAN};client_drop@{KILL_ROUND}:clients="
                    + "+".join(map(str, doomed)))
    run("drop", drop + rounds + proc + fast)
    # (a dropped client's table still crosses the wire and is masked in the
    # merge; a dead shard's never arrives: the stacks differ, the rounds not)
    same("kill", "drop", "c", ("code", "metrics", "state", "requeue"))
    per_round("kill", SHARD_ROUNDS)
    k = runs["kill"]
    if k["deaths"] != 1 or [s for s, _ in k["respawns"]] != [KILL_SHARD]:
        fail(f"shards c: {k['deaths']} deaths, respawns {k['respawns']}")
    if not set(doomed) <= set(k["closes"][KILL_ROUND]):
        fail(f"shards c: round {KILL_ROUND} masked {k['closes'][KILL_ROUND]}, not {doomed}")
    print(f"shards c: shard_kill@{KILL_ROUND}:shards={KILL_SHARD} == client_drop@{KILL_ROUND} "
          f"of its positions {doomed} bitwise (params, optimizer state, batch-norm statistics, "
          f"metrics, queue); 1 death, respawned at round "
          f"{KILL_ROUND + 1} in {k['respawns'][0][1]:.3f} s; {numbers('kill')} [{card}]",
          flush=True)
    if device == "cuda":
        torch.cuda.empty_cache()

    # d. the fast process run on a group of 4 gloo ranks sharing the card
    # (phase 21's launch ran it when the whole script runs; alone, the
    # launch came first, before the other runs' thousands of connections)
    S = ASYNC_GROUP_SHARDS
    out, secs = group
    ranks = [r["runs"]["proc"] for r in out]
    orig = cv_train.FederatedSession
    cv_train.FederatedSession = functools.partial(FederatedSession, client_shards=S)
    try:
        twin = run("group_twin", served_group_runs()["proc"])
    finally:
        cv_train.FederatedSession = orig
    want = {"sketch_accumulate": W // S * SHARD_GROUP_ROUNDS, "sketch_query": SHARD_GROUP_ROUNDS}
    for rk, g in enumerate(ranks):
        for key in ("code", "metrics", "state", "requeue"):
            if g[key] != twin[key]:
                fail(f"shards d: rank {rk}'s {key} differs from the one-device run at "
                     f"client_shards={S}")
        if g["launches"] != want:
            fail(f"shards d: rank {rk} launched {g['launches']} (want {want})")
    if ranks[0]["counters"] != twin["counters"]:
        fail("shards d: rank 0's serve counters differ from the twin's")
    print(f"shards d: the fast process-shard run on {S} gloo ranks, {SHARD_GROUP_ROUNDS} rounds "
          f"== the one-device run at client_shards={S}, bitwise on every rank; launches a rank "
          f"{want}; {secs:.1f} s for the launch{' (shared with phase 21)' if shared else ''} "
          f"[{card}]", flush=True)

    # e. the load generator against process shards
    t = ProcShardedIngest(n_shards=N)
    names = shm_names()
    t.start()
    try:
        t.queue.open_round(0, list(range(W)))
        lg = loadgen.run_stage(loadgen.LoadGenConfig(
            port=t.address[1], processes=LOADGEN_PROCS, stage_s=LOADGEN_S, model="flat",
            connections=LOADGEN_CONNS, ramp_start=LOADGEN_CONNS), LOADGEN_CONNS)
        counts = t.queue.counters()
        per_shard = [v["submissions"] for v in t.counters().values()]
    finally:
        t.stop()
    if shm_names() != names:
        fail("shards e: /dev/shm changed")
    # the server also decided the submissions in flight at the stage's end
    # (at most one a connection), whose verdicts no client read
    if lg["opened_conns"] != LOADGEN_CONNS or lg["errors"] or \
            sum(lg["statuses"].values()) != lg["submissions"] or not \
            lg["submissions"] <= counts["rejected_uninvited"] <= lg["submissions"] + LOADGEN_CONNS:
        fail(f"shards e: {lg}, server counters {counts}")
    print(f"shards e: loadgen {LOADGEN_CONNS} connections from {LOADGEN_PROCS} processes for "
          f"{LOADGEN_S:g} s against {N} process shards: {lg['submissions_per_s']:.1f} "
          f"submissions/s ({lg['submissions']} submissions, verdicts {lg['statuses']}, "
          f"{lg['errors']} errors, per shard {per_shard}); fd cap {lg['fd_cap_per_proc']} a "
          f"client process (capped {lg['fd_capped']}); os.cpu_count() {os.cpu_count()} "
          f"[{card}]", flush=True)
    print("shards: run s " + ", ".join(f"{k} {v['s']:.1f}" for k, v in runs.items()),
          flush=True)
    launches = {k: v["launches"] for k, v in runs.items()}
    launches["group_proc"] = ranks[0]["launches"]
    return launches


def shard_turns(cv_train, kernels, card: str, turns: int) -> None:
    """``--shard-turns N``: phase 24's cell in N turns of the one listener
    fast, process shards fast (the uploader polling every 2 ms, then every
    20 ms) and process shards slow, 4 shards, SHARD_ROUNDS rounds a run;
    each run's round ms, stage p50s, the loop's host ms and the H2D copies."""
    from commefficient_tpu_torch.obs import registry as obreg
    from commefficient_tpu_torch.serve import service

    reg = obreg.default()
    fast = ["--serve_fastpath"]
    proc = ["--serve_shards", str(SHARDS), "--serve_shard_mode", "process"]
    plan = [("one_fast", fast, 0.002), ("proc_fast", proc + fast, 0.002),
            ("proc_fast_poll20", proc + fast, 0.02), ("proc_slow", proc, 0.002)]
    runs, poll = {}, service._RingUploader.POLL_S
    try:
        for turn in range(turns):
            for tag, extra, poll_s in plan:
                service._RingUploader.POLL_S = poll_s
                for st in obreg.SERVE_STAGES:
                    reg.histogram(f"serve_stage_{st}_ms").reset_window()
                key = f"{tag}_{turn}"
                s = _serve_run(cv_train, kernels, key, SHARD_BASE + extra + [
                    "--num_rounds", str(SHARD_ROUNDS)], runs, "cuda")
                r = runs[key]
                copies = s.wire_copy_stats()
                h2d = copies.get("h2d_ring", copies.get("h2d", {}))
                p50 = {st: reg.histogram(f"serve_stage_{st}_ms").summary()["p50"]
                       for st in obreg.SERVE_STAGES}
                print(f"shard turns: {key}: round ms {r['round_ms']:.2f}; stage p50 {p50}; host "
                      f"ms a round {[round(x, 2) for x in r['host_ms']]}; H2D {h2d}; spawn s "
                      f"{r.get('spawn_s')}; run s {r['s']:.1f} [{card}]", flush=True)
    finally:
        service._RingUploader.POLL_S = poll


@contextlib.contextmanager
def timing_edge_folds():
    """Inside the block, the host ms of each ``EdgeTree.aggregate_round``
    (the edges' screens and numpy folds of a round), in rec["ms"]."""
    from commefficient_tpu_torch.serve.scale.edge import EdgeTree

    rec = {"ms": []}
    agg = EdgeTree.aggregate_round

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = agg(self, *a, **kw)
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    EdgeTree.aggregate_round = timed
    try:
        yield rec
    finally:
        EdgeTree.aggregate_round = agg


@contextlib.contextmanager
def flat_twin():
    """Inside the block the CLIs serve with the edge tree off
    (``ServeConfig.edges`` 0) while their sessions stay edge-armed: every
    round merges through the grouped flat twin."""
    from commefficient_tpu_torch.serve import service

    from_args = service.ServeConfig.from_args.__func__
    service.ServeConfig.from_args = classmethod(
        lambda cls, args: dataclasses.replace(from_args(cls, args), edges=0))
    try:
        yield
    finally:
        service.ServeConfig.from_args = classmethod(from_args)


def edges_phase(cv_train, engine, csvec, kernels, card: str, group=None) -> dict:
    """Phase 25: the two-tier edge tree on phase 22's served payload cell at
    ResNet-9's full width. ``group``: phase 21's launch's (ranks, seconds),
    where the whole script ran (f)'s run and 23e's; None launches the group
    here. Returns each kernel's launches over each run (rank 0's for the
    group's)."""
    import functools
    import shutil

    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.obs import registry as obreg
    from commefficient_tpu_torch.serve.scale.edge import assign_edges

    device = "cuda" if "cuda" in SLICE_ARGS else "cpu"
    base = os.path.join(ROOT, "build", "chip_smoke", "edges")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    reg = obreg.default()
    W = int(SLICE_ARGS[SLICE_ARGS.index("--num_workers") + 1])
    table_bytes = 4 * SLICE["r"] * SLICE["c"]
    runs, kept = {}, {}
    shared = group is not None
    group = group or launch_served_group(base, device, ("edge", "fast"), "edges f")

    def run(tag, argv, twin=False, keep=False):
        mark = reg.mark()
        with timing_edge_folds() as folds, \
                (flat_twin() if twin else contextlib.nullcontext()):
            s = _serve_run(cv_train, kernels, tag, argv, runs, device)
        r = runs[tag]
        r["fold_ms"] = folds["ms"]
        r["deaths"] = mark.delta("serve_edge_deaths_total")
        r["partials"] = mark.delta("serve_edge_partials_total")
        r["copies"] = s.wire_copy_stats() if s is not None else {}
        if keep:
            kept[tag] = s
        per_round(tag)
        return r

    def per_round(tag):
        want = {"sketch_accumulate": W * EDGE_ROUNDS, "sketch_query": EDGE_ROUNDS}
        if runs[tag]["launches"] != want:
            fail(f"edges {tag}: launched {runs[tag]['launches']} in {EDGE_ROUNDS} rounds "
                 f"(want {want})")

    def same(tag, twin, label, keys=("code", "metrics", "state", "requeue", "counters")):
        for key in keys:
            if runs[tag][key] != runs[twin][key]:
                fail(f"edges {label}: {tag}'s {key} differs from {twin}'s")

    def copies(tag, direction, n_tables):
        c = runs[tag]["copies"].get(direction, {})
        if device == "cuda" and (c.get("copies") != EDGE_ROUNDS or c.get("bytes") !=
                                 EDGE_ROUNDS * n_tables * table_bytes):
            fail(f"edges {tag}: {direction} copies {c} (want {EDGE_ROUNDS} of {n_tables} "
                 "tables)")
        return c

    def tree_run(tag, n_edges, argv, *, keep=False):
        r = run(tag, argv + ["--serve_edges", str(n_edges)], keep=keep)
        copies(tag, "h2d_edge", n_edges)
        # a dead edge forwards no partial for its round
        if "h2d" in r["copies"] or r["partials"] != n_edges * EDGE_ROUNDS - r["deaths"]:
            fail(f"edges {tag}: copies {r['copies']}, {r['partials']} partials")
        return r

    def flat_run(tag, n_edges, argv):
        r = run(tag, argv + ["--serve_edges", str(n_edges)], twin=True)
        copies(tag, "h2d", W)
        if "h2d_edge" in r["copies"] or r["partials"] or r["fold_ms"]:
            fail(f"edges {tag}: the flat twin ran the tree")
        return r

    def numbers(tag):
        r = runs[tag]
        h2d = r["copies"].get("h2d_edge", r["copies"].get("h2d", {}))
        fold = (f"host fold ms a round {[round(x, 3) for x in r['fold_ms']]}; "
                if r["fold_ms"] else "")
        return (f"{fold}H2D {h2d.get('copies', 0)} copies, {h2d.get('bytes', 0)} bytes, "
                f"{h2d.get('ms', 0.0):.3f} ms (CUDA events; a run); steady round ms "
                f"{r['round_ms']:.2f}; host ms a round (prepare, dispatch, drain) "
                f"{[round(x, 3) for x in r['host_ms']]}")

    # a. the tree against its flat twin, E = 2 in turns, then E = 4
    tree_run("tree2_1", 2, EDGE_BASE, keep=True)
    flat_run("flat2_1", 2, EDGE_BASE)
    flat_run("flat2_2", 2, EDGE_BASE)
    tree_run("tree2_2", 2, EDGE_BASE)
    tree_run("tree4", 4, EDGE_BASE)
    flat_run("flat4", 4, EDGE_BASE)
    for tag in ("flat2_1", "flat2_2", "tree2_2"):
        same(tag, "tree2_1", "a")
    same("flat4", "tree4", "a")
    s = kept.pop("tree2_1")
    check_kernels(csvec, s.cfg.mode.sketch_spec, s.state["params"],
                  s.state["mode_state"]["Verror"])
    del s
    print(f"edges a: the tree == its flat twin in process, {EDGE_ROUNDS} rounds, E = 2 (tree, "
          f"flat, flat, tree) and E = 4, bitwise (params, optimizer state, batch-norm "
          f"statistics, metrics, queue, admission counters); casualties a round "
          f"{runs['tree2_1']['closes']}; launches a run {runs['tree2_1']['launches']}; kernels "
          f"== plain on the E = 2 tree's params and error table [{card}]", flush=True)
    for tag in ("tree2_1", "flat2_1", "flat2_2", "tree2_2", "tree4", "flat4"):
        print(f"edges a: {tag}: {numbers(tag)} [{card}]", flush=True)

    # b. the clip under a 50x table and a NaN table
    tree_run("clip_tree", 2, EDGE_CLIP)
    flat_run("clip_flat", 2, EDGE_CLIP)
    same("clip_tree", "clip_flat", "b")
    c = runs["clip_tree"]["counters"]
    quarantined = [m.get("clients_quarantined", 0.0) for m in runs["clip_tree"]["metrics"]]
    if c["rejected_malformed"] + c["rejected_quarantined"] < 2:
        fail(f"edges b: the chaos never reached the validation: {c}")
    print(f"edges b: {EDGE_CLIP_PLAN} with the clip at 3, E = 2: the tree == its flat twin "
          f"bitwise; admission counters {json.dumps(c)} in both; clients_quarantined a round "
          f"{quarantined} [{card}]", flush=True)

    # c. an edge's death against the drop of its clients
    kill = list(EDGE_BASE) + ["--fault_plan", f"edge_kill@{EDGE_KILL_ROUND}:edges={EDGE_KILL}"]
    tree_run("kill", 2, kill)
    ids = runs["kill"]["invited"][EDGE_KILL_ROUND]
    doomed = [int(p) for p in np.flatnonzero(assign_edges(ids, 2) == EDGE_KILL)]
    if not doomed:
        fail(f"edges c: edge {EDGE_KILL} owns none of round {EDGE_KILL_ROUND}'s cohort {ids}")
    drop = list(EDGE_BASE) + ["--fault_plan", f"client_drop@{EDGE_KILL_ROUND}:clients="
                              + "+".join(map(str, doomed))]
    tree_run("drop", 2, drop)
    same("kill", "drop", "c", ("code", "metrics", "state", "requeue"))
    if runs["kill"]["deaths"] != 1 or runs["drop"]["deaths"]:
        fail(f"edges c: {runs['kill']['deaths']} edge deaths killed, {runs['drop']['deaths']} "
             "dropped")
    # (the close's own casualties plus the dead edge's clients)
    masked = runs["kill"]["metrics"][EDGE_KILL_ROUND]["clients_dropped"]
    if masked < len(doomed) + len(runs["kill"]["closes"][EDGE_KILL_ROUND]):
        fail(f"edges c: round {EDGE_KILL_ROUND} masked {masked} clients, edge {EDGE_KILL} owns "
             f"{doomed}")
    print(f"edges c: edge_kill@{EDGE_KILL_ROUND}:edges={EDGE_KILL} == client_drop@"
          f"{EDGE_KILL_ROUND} of its positions {doomed} bitwise (params, optimizer state, "
          f"batch-norm statistics, metrics, queue {runs['kill']['requeue'][0]}); 1 edge death, "
          f"{masked:g} clients masked at round {EDGE_KILL_ROUND} [{card}]", flush=True)

    # d. forward mode under a robust policy
    trimmed = EDGE_BASE + ["--merge_policy", "trimmed", "--merge_trim", "1"]
    with counting_stderr("FORWARDS its shard's validated tables") as note:
        run("forward", trimmed + ["--serve_edges", "2"])
    run("trimmed", trimmed)
    same("forward", "trimmed", "d")
    if note["n"] != 1 or "h2d_edge" in runs["forward"]["copies"]:
        fail(f"edges d: {note['n']} forward-mode notes, copies {runs['forward']['copies']}")
    print(f"edges d: --merge_policy trimmed --merge_trim 1 --serve_edges 2 runs forward mode "
          f"(its NOTE printed once) == the flat trimmed run bitwise; launches "
          f"{runs['forward']['launches']} [{card}]", flush=True)

    # e. over the socket: the event loop with 4 thread shards, E = 4
    tree_run("socket4", 4, EDGE_BASE + ["--serve", "socket", "--serve_transport", "eventloop",
                                        "--serve_shards", "4"])
    same("socket4", "tree4", "e")
    print(f"edges e: over the socket (event loop, 4 thread shards), E = 4 == (a)'s tree in "
          f"process bitwise; {numbers('socket4')} [{card}]", flush=True)
    if device == "cuda":
        torch.cuda.empty_cache()

    # f. on a group of 4 gloo ranks sharing the card
    S = ASYNC_GROUP_SHARDS
    out, secs = group
    ranks = [r["runs"]["edge"] for r in out]
    orig = cv_train.FederatedSession
    cv_train.FederatedSession = functools.partial(FederatedSession, client_shards=S)
    try:
        twin = run("group_twin", served_group_runs()["edge"])
    finally:
        cv_train.FederatedSession = orig
    want = {"sketch_accumulate": W // S * EDGE_ROUNDS, "sketch_query": EDGE_ROUNDS}
    for rk, g in enumerate(ranks):
        for key in ("code", "metrics", "state", "requeue"):
            if g[key] != twin[key]:
                fail(f"edges f: rank {rk}'s {key} differs from the one-device run at "
                     f"client_shards={S}")
        if g["launches"] != want:
            fail(f"edges f: rank {rk} launched {g['launches']} (want {want})")
    if ranks[0]["counters"] != twin["counters"]:
        fail("edges f: rank 0's serve counters differ from the twin's")
    # (the closes' broadcasts; a smaller one would be the run's own)
    sizes = [n for n in out[0]["sizes"]["edge"] if n > 4096]
    if sizes != [4 * 3 * W + 2 * table_bytes] * EDGE_ROUNDS:
        fail(f"edges f: rank 0 broadcast {sizes} bytes a round")
    b, fb = ranks[0]["broadcast"], out[0]["runs"]["fast"]["broadcast"]
    print(f"edges f: the E = 2 tree with the clip on {S} gloo ranks, {EDGE_ROUNDS} rounds == "
          f"the one-device run at client_shards={S}, bitwise on every rank; launches a rank "
          f"{want}; rank 0's broadcast a round {sizes[0]} bytes (the mask, the norms, the "
          f"assignment and 2 partials), {b['ms'] / max(b['calls'], 1):.3f} ms, against 23e's "
          f"W-table stack {fb['bytes'] / max(fb['calls'], 1):.0f} bytes, "
          f"{fb['ms'] / max(fb['calls'], 1):.3f} ms; {secs:.1f} s for the launch"
          f"{' (shared with phase 21)' if shared else ''} [{card}]", flush=True)
    print("edges: run s " + ", ".join(f"{k} {v['s']:.1f}" for k, v in runs.items()),
          flush=True)
    launches = {k: v["launches"] for k, v in runs.items()}
    launches["group_edge"] = ranks[0]["launches"]
    return launches


@contextlib.contextmanager
def recording_moe(at_round: int):
    """Inside the block, every session records each committed round's host
    metrics and, as committed after round ``at_round``, a copy of its
    params and optimizer state."""
    from commefficient_tpu_torch.federated.api import FederatedSession

    rec = {"metrics": [], "state": None}
    commit = FederatedSession.commit_rounds

    def commit_rec(self, infls, hosts):
        out = commit(self, infls, hosts)
        rec["metrics"].extend(out)
        if self.round == at_round:
            rec["state"] = {k: v.clone() for k, v in _state(self).items()}
        return out

    FederatedSession.commit_rounds = commit_rec
    try:
        yield rec
    finally:
        FederatedSession.commit_rounds = commit


def unsketch_check(csvec, spec, table: torch.Tensor, k: int, scanned: tuple) -> str:
    """Phase 26c: ``unsketch_topk`` of ``table`` on its own device (for a
    CUDA table the single shot: the query kernel, then one top-k) against
    ``scanned``, the same table's unsketch on the CPU by the chunk scan:
    the same indices and bitwise-equal values; and ``impl`` approx and
    oversample on the table's device select what exact selects there."""
    idx, vals = csvec.unsketch_topk(spec, table, k)
    if not (torch.equal(idx.cpu(), scanned[0]) and torch.equal(vals.cpu(), scanned[1])):
        same = (idx.cpu() == scanned[0]).float().mean().item()
        fail(f"unsketch_topk at d={spec.d}: the single shot and the CPU chunk scan differ "
             f"(index agreement {same:.6f})")
    for impl in ("approx", "oversample"):
        i2, v2 = csvec.unsketch_topk(spec, table, k, impl=impl)
        if not (torch.equal(i2, idx) and torch.equal(v2, vals)):
            fail(f"unsketch_topk at d={spec.d}: impl {impl} selects other than exact")
    return (f"unsketch_topk at d={spec.d:,} (k {k}): the {table.device.type} single shot == "
            f"the CPU chunk scan over {spec.num_slabs} slabs (indices, values bitwise); "
            "approx == oversample == exact")


def moe_phase(kernels, csvec, engine, time_ms, gen: torch.Generator, card: str,
              pending: list | None = None) -> dict:
    """Phase 26: GPT-2 small with eight experts through ``gpt2_train.main``
    at d = 283,647,744; returns the kernels' fields at this shape. (c)'s
    CPU scan runs on a thread while (b), (d) and (e) run; with ``pending``
    (a list), it runs instead on half the cores when the caller calls
    ``start`` of the pair (start, finish) appended to it, and ``finish``
    joins it and checks (c)."""
    import shutil

    from commefficient_tpu_torch import gpt2_train

    base = os.path.join(ROOT, "build", "chip_smoke", "moe")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    phase_t = time.perf_counter()

    def run(extra: list, label: str, rounds: int):
        log = os.path.join(base, f"{label}.jsonl")
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording_moe(MOE_ASYNC_ROUNDS) as rec:
            s = gpt2_train.main(MOE_ARGS + ["--num_rounds", str(rounds), "--log_jsonl", log,
                                            *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ravel_launches(kernels)
        if any(n != s.run_stats.rounds for n in launches.values()):
            fail(f"moe {label}: launches {launches} in {s.run_stats.rounds} rounds, expected "
                 "one of each kernel a round")
        with open(log) as f:
            rows = [json.loads(line) for line in f]
        if not rows or not all(math.isfinite(r[k]) for r in rows
                               for k in ("train_nll", "val_nll")):
            fail(f"moe {label}: non-finite or missing NLL in {rows}")
        aux = [(m["moe_aux_sum"], m["moe_aux_count"]) for m in rec["metrics"]]
        if len(aux) != rounds or not all(a > 0 and n == s.num_workers for a, n in aux):
            fail(f"moe {label}: (moe_aux_sum, moe_aux_count) a round {aux}, expected > 0 and "
                 f"{s.num_workers}")
        print(f"moe {label}: {s.run_stats.rounds} rounds in {wall:.1f} s (with start-up and "
              f"eval), launches {launches}, (moe_aux_sum, moe_aux_count) a round {aux}, final "
              f"row {rows[-1]}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]", flush=True)
        print(_times(f"moe {label}", s.run_stats, card), flush=True)
        return s, launches, rec

    # a. three rounds through the sync loop
    a, launches, rec_a = run(["--sync_loop"], "sync", MOE_ROUNDS)
    layout, spec, k = a.layout, a.cfg.mode.sketch_spec, a.cfg.mode.k
    moe_leaves = [leaf.name for leaf in layout.leaves if ".moe_mlp." in leaf.name]
    print(f"moe: d={layout.d:,} ({len(layout.leaves)} leaves, {len(moe_leaves)} of them the "
          f"experts' and routers', first {moe_leaves[0]}), 4d = {4 * layout.d:,} B against the "
          f"single-shot line {csvec.UNSKETCH_SINGLE_SHOT_BYTES:,} B", flush=True)
    if layout.d != MOE_D or 4 * layout.d <= csvec.UNSKETCH_SINGLE_SHOT_BYTES:
        fail(f"moe: d={layout.d}, expected {MOE_D} past the single-shot line")

    # c (started here). the CPU chunk scan of the run's error table, on a
    # thread while (b), (d) and (e) run on the card, or (with ``pending``)
    # where the caller starts it, on half the cores, the rest left to the
    # processes of that phase
    table = a.state["mode_state"]["Verror"].clone()
    scan = {}
    threads = torch.get_num_threads()

    def cpu_scan():
        t0 = time.perf_counter()
        try:
            scan["out"] = csvec.unsketch_topk(spec, table.cpu(), k)
        except BaseException as e:  # re-raised on the main thread
            scan["error"] = e
        scan["s"] = time.perf_counter() - t0

    scanner = threading.Thread(target=cpu_scan, name="moe-cpu-scan")

    def start():
        if pending is not None:
            torch.set_num_threads(max(threads // 2, 1))
        scanner.start()

    if pending is None:
        start()

    # b. both kernels at this shape, bitwise and timed
    errs = check_kernels(csvec, spec, a.state["params"], a.state["mode_state"]["Verror"])
    print(f"moe: kernels == plain at d={spec.d:,} c={spec.c} r={spec.r} ({spec.num_slabs} "
          "slabs) on the run's params and error table", flush=True)
    times = time_kernels(csvec, kernels, time_ms, spec, gen)

    # d. one round at lr 0.1 against FetchSGD's algebra on the card
    state_a = rec_a["state"]
    print("moe: " + check_sketch_round(a, engine, csvec), flush=True)
    del a

    # e. the async loop over 2 rounds against (a) after its round 2
    b, _, rec_b = run([], "async", MOE_ASYNC_ROUNDS)
    if not (_equal(_state(b), state_a)
            and rec_b["metrics"] == rec_a["metrics"][:MOE_ASYNC_ROUNDS]):
        fail("moe: the async run differs from the sync run after round 2")
    print(f"moe: async == sync bitwise over {MOE_ASYNC_ROUNDS} rounds (params, Vvelocity, "
          "Verror, every round's metrics)", flush=True)
    del b, state_a

    # c. the single shot on the card against the CPU scan
    def finish():
        t0 = time.perf_counter()
        scanner.join()
        torch.set_num_threads(threads)
        if "error" in scan:
            raise scan["error"]
        print(f"moe: {unsketch_check(csvec, spec, table, k, scan['out'])}; the CPU scan took "
              f"{scan['s']:.1f} s on a thread, {time.perf_counter() - t0:.1f} s of it "
              f"waited for [{card}]", flush=True)

    if pending is None:
        finish()
    else:
        pending.append((start, finish))
    print(f"moe: phase took {time.perf_counter() - phase_t:.1f} s [{card}]", flush=True)
    return {name: {**times[name], "launches": launches[name], "max_abs_err": errs[i],
                   "d": spec.d, "c": spec.c, "r": spec.r}
            for i, name in enumerate(("sketch_accumulate", "sketch_query"))}


@contextlib.contextmanager
def gpt2_fields(**changes):
    """Inside the block, ``gpt2_train`` builds GPT-2 (small and tiny) with
    these config fields changed (remat, dropout: the CLI has no flag for
    them)."""
    from commefficient_tpu_torch import gpt2_train

    orig = gpt2_train.SMALL, gpt2_train.TINY
    gpt2_train.SMALL, gpt2_train.TINY = (dataclasses.replace(c, **changes) for c in orig)
    try:
        yield
    finally:
        gpt2_train.SMALL, gpt2_train.TINY = orig


def peak_sites(snapshot: dict, base: int, top: int = 8) -> dict:
    """Where the device memory lay at the peak of a window recorded by
    ``torch.cuda.memory._record_memory_history``: the allocator's trace
    replayed (an alloc adds its block, a free takes it away) to its highest
    point, the blocks live there summed by the innermost frame of the
    port's code that allocated them. ``base``: the bytes allocated when the
    window opened (not in the trace). Returns {"peak_gb", "base_gb",
    "sites": [(site, GB, its three commonest (block bytes, count)), ...]}
    largest first."""
    trace = [e for dev in snapshot["device_traces"] for e in dev]
    live, cur, best, best_at = {}, 0, 0, -1
    frees = {"free_requested", "free"}
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            cur += e["size"]
            if cur > best:
                best, best_at = cur, i
        elif e["action"] in frees:
            cur -= e["size"]
    for e in trace[:best_at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] in frees:
            live.pop(e["addr"], None)
    sites, sizes = Counter(), {}
    for e in live.values():
        frame = next((f for f in e.get("frames", ())
                      if "commefficient_tpu_torch" in f["filename"]), None)
        where = (f"{os.path.basename(frame['filename'])}:{frame['line']} {frame['name']}"
                 if frame else "elsewhere")
        sites[where] += e["size"]
        sizes.setdefault(where, Counter())[e["size"]] += 1
    return {"peak_gb": (base + best) / 1e9, "base_gb": base / 1e9,
            "sites": [(w, round(b / 1e9, 3), sizes[w].most_common(3))
                      for w, b in sites.most_common(top)]}


@contextlib.contextmanager
def timed_rounds(engine, rec: list, device: str, first: dict):
    """Inside the block, each round step of a session built there
    synchronizes, meets the group's other ranks at a barrier, zeroes the
    collectives' counts (and on the card the peak memory), runs and
    synchronizes again, and appends its {"round_ms", "peak_gb" (the step's
    peak device memory), "client_peak_gb" (its client phase's: the vmapped
    gradients), "coll_bytes", "coll_calls", "coll_ms"} to ``rec``; ``first["p0"]`` is a
    copy of the params the first round started from, and ``first["peak"]``
    the peak device bytes of the run up to its last round's end."""
    import torch.distributed as dist

    from commefficient_tpu_torch.parallel import collectives, distributed

    make, make_updates = engine.make_round_step, engine.make_client_updates
    seen = {"before": 0, "client": 0}  # this round's peak bytes before the client phase, in it

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def make_updates_peaked(*a, **kw):
        updates = make_updates(*a, **kw)

        def peaked(*args, **kwargs):
            if device != "cuda":
                return updates(*args, **kwargs)
            seen["before"] = max(seen["before"], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            traced = first.get("trace_round") == len(rec)
            if traced:
                base = torch.cuda.memory_allocated()
                torch.cuda.memory._record_memory_history(max_entries=2_000_000)
            out = updates(*args, **kwargs)
            seen["client"] = max(seen["client"], torch.cuda.max_memory_allocated())
            if traced:
                torch.cuda.synchronize()
                first["peak_sites"] = peak_sites(torch.cuda.memory._snapshot(), base)
                torch.cuda.memory._record_memory_history(enabled=None)
            return out

        return peaked

    def make_timed(*a, **kw):
        step = make(*a, **kw)

        def timed(*args, **kwargs):
            if not rec:
                first["p0"] = args[0]["params"].detach().clone()
            sync()
            if distributed.is_joined():
                dist.barrier()
            collectives.stats.update(calls=0, bytes=0, ms=0.0)
            if device == "cuda":
                first["peak"] = max(first.get("peak", 0), torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
            seen.update(before=0, client=0)
            t0 = time.perf_counter()
            out = step(*args, **kwargs)
            sync()
            after = torch.cuda.max_memory_allocated() if device == "cuda" else 0
            peak = max(seen["before"], seen["client"], after)
            first["peak"] = max(first.get("peak", 0), peak)
            rec.append({"round_ms": (time.perf_counter() - t0) * 1e3, "peak_gb": peak / 1e9,
                        "client_peak_gb": seen["client"] / 1e9,
                        **{f"coll_{k}": v for k, v in collectives.stats.items()}})
            return out

        return timed

    engine.make_round_step, engine.make_client_updates = make_timed, make_updates_peaked
    try:
        yield
    finally:
        engine.make_round_step, engine.make_client_updates = make, make_updates


def _coll_delta(before: dict) -> dict:
    from commefficient_tpu_torch.parallel import collectives

    return {f"coll_{k}": collectives.stats[k] - before[k] for k in before}


@contextlib.contextmanager
def recording_decodes(rec: list, device: str):
    """Inside the block, each ``F1Eval.decode`` (--eval_f1) appends to
    ``rec`` its ids [B, T] and lengths [B], the prompt lengths, each
    step's top-2 logit gap a row ([steps][B], read off the logits the step
    picked from), its host ms between two device syncs and the collectives'
    bytes, calls and ms over it."""
    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.models import generate
    from commefficient_tpu_torch.parallel import collectives

    decode, pick = gpt2_train.F1Eval.decode, generate._nucleus_pick
    gaps: list = []

    def picking(logits, *args):
        top = logits.float().topk(2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])  # on the device: no sync a step
        return pick(logits, *args)

    def recorded(self, params, rnd):
        gaps.clear()
        if device == "cuda":
            torch.cuda.synchronize()
        before = dict(collectives.stats)
        t0 = time.perf_counter()
        ids, lengths = decode(self, params, rnd)  # ends in a copy to the host
        ms = (time.perf_counter() - t0) * 1e3
        rec.append({"ids": ids.tolist(), "lengths": lengths.tolist(),
                    "plen": self.prompt_len.tolist(),
                    "gaps": torch.stack(gaps).tolist(), "ms": ms, **_coll_delta(before)})
        return ids, lengths

    gpt2_train.F1Eval.decode, generate._nucleus_pick = recorded, picking
    try:
        yield
    finally:
        gpt2_train.F1Eval.decode, generate._nucleus_pick = decode, pick


def decode_diffs(have: dict, want: dict) -> list:
    """Where the decode ``have`` departs from ``want`` (two records of
    ``recording_decodes``): for each row, its first differing token as
    (row, step, have's token, want's token, have's top-2 gap at that step,
    want's), or its length where only that differs."""
    out = []
    for b, (h, w) in enumerate(zip(have["ids"], want["ids"])):
        at = next((t for t, (x, y) in enumerate(zip(h, w)) if x != y), None)
        if at is not None:
            step = at - have["plen"][b]
            gap = (lambda g: g[step][b] if 0 <= step < len(g) else math.inf)
            out.append((b, step, h[at], w[at], gap(have["gaps"]), gap(want["gaps"])))
        elif have["lengths"][b] != want["lengths"][b]:
            out.append((b, None, have["lengths"][b], want["lengths"][b], math.inf, math.inf))
    return out


def par_run(kernels, engine, label: str, flags: list, changes: dict, device: str,
            log_dir: str, trace_round: int | None = None) -> dict:
    """One phase-27 run of ``gpt2_train.main`` (PAR_ARGS + flags, with the
    GPT-2 fields ``changes``): its session, launches (counted over the run
    only), per-round timings, logged rows, initial params, peak device
    memory over the run (its eval included) and over its round steps, and
    its F1 decodes (``recording_decodes``); with ``trace_round`` i, where
    round i's client phase held its peak (``peak_sites``)."""
    from commefficient_tpu_torch import gpt2_train

    log = os.path.join(log_dir, f"{label}.jsonl")
    if os.path.exists(log):
        os.remove(log)
    rec: list = []
    decodes: list = []
    first: dict = {"trace_round": trace_round}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with gpt2_fields(**changes), timed_rounds(engine, rec, device, first), \
            recording_decodes(decodes, device):
        s = gpt2_train.main(PAR_ARGS + ["--log_jsonl", log, *flags])
    launches = ravel_launches(kernels)
    rows = []
    if os.path.exists(log):
        with open(log) as f:
            rows = [json.loads(line) for line in f]
    if any(n != PAR_ROUNDS for n in launches.values()):
        fail(f"parallel {label}: launches {launches} in {PAR_ROUNDS} rounds, expected one of "
             "each kernel a round")
    if len(rec) != PAR_ROUNDS:
        fail(f"parallel {label}: {len(rec)} timed rounds, expected {PAR_ROUNDS}")
    peak = max(first["peak"], torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    return {"session": s, "launches": launches, "rounds": rec, "rows": rows, "p0": first["p0"],
            "peak_gb": peak / 1e9, "round_peak_gb": max(r["peak_gb"] for r in rec),
            "peak_sites": first.get("peak_sites"), "decodes": decodes}


def decode_line(run: dict) -> str:
    """A run's F1 decode for a printed line: its val_f1 and its last
    decode's shape, ms and collectives."""
    d = run["decodes"][-1]
    f1 = run["rows"][-1].get("val_f1") if run["rows"] else None
    return (f"val_f1 {f1}, {len(d['ids'])} dialogs x {len(d['gaps'])} steps decoded in "
            f"{d['ms']:.1f} ms, collectives {d['coll_bytes'] / 1e6:.1f} MB in "
            f"{d['coll_calls']} calls, {d['coll_ms']:.1f} ms; smallest top-2 logit gap "
            f"{min(min(g) for g in d['gaps']):.3e}")


def served_line(run: dict) -> str:
    """A served run for a printed line: round ms, client steps, launches,
    final row."""
    return (f"round ms {[round(x, 1) for x in run['round_ms']]}, client step ms "
            f"{[round(x['ms'], 1) for x in run['steps']]}, its collectives MB "
            f"{[round(x['coll_bytes'] / 1e6, 1) for x in run['steps']]} in "
            f"{[x['coll_calls'] for x in run['steps']]} calls, "
            f"{[round(x['coll_ms'], 1) for x in run['steps']]} ms; launches "
            f"{run['launches']}; final row {run['rows'][-1] if run['rows'] else None}")


def served_par_run(kernels, label: str, flags: list, changes: dict, device: str,
                   log_dir: str) -> dict:
    """One served run of phases 27f/27g (``gpt2_train.main`` of PAR_ARGS +
    PAR_SERVE + flags, with the GPT-2 fields ``changes``): its session,
    launches over the run (one accumulate a client a round, one query a
    round; the pipelined worker may sketch one round past the last before
    its stop), rows, the sync loop's round ms, and each payload client
    step's host ms between two device syncs with the collectives' bytes,
    calls and ms over it."""
    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.parallel import collectives

    log = os.path.join(log_dir, f"{label}.jsonl")
    if os.path.exists(log):
        os.remove(log)
    steps: list = []
    compute = FederatedSession.compute_client_tables

    def timed(self, prep, *args, **kw):
        if device == "cuda":
            torch.cuda.synchronize()
        before = dict(collectives.stats)
        t0 = time.perf_counter()
        out = compute(self, prep, *args, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, **_coll_delta(before)})
        return out

    kernels.reset_launch_counts()
    FederatedSession.compute_client_tables = timed
    try:
        with gpt2_fields(**changes):
            s = gpt2_train.main(PAR_ARGS + PAR_SERVE + ["--log_jsonl", log, *flags])
    finally:
        FederatedSession.compute_client_tables = compute
    launches = ravel_launches(kernels)
    W = s.num_workers
    acc, qry = launches["sketch_accumulate"], launches["sketch_query"]
    if qry != PAR_ROUNDS or acc not in (W * PAR_ROUNDS, W * (PAR_ROUNDS + 1)):
        fail(f"served {label}: launches {launches} in {PAR_ROUNDS} payload rounds of {W} "
             "clients, expected one accumulate a client a round and one query a round")
    rows = []
    if os.path.exists(log):
        with open(log) as f:
            rows = [json.loads(line) for line in f]
    if s.round != PAR_ROUNDS:
        fail(f"served {label}: the run ended at round {s.round}, expected {PAR_ROUNDS}")
    return {"session": s, "launches": launches, "rows": rows,
            "round_ms": list(s.run_stats.round_ms), "steps": steps[:PAR_ROUNDS]}


def par_agreement(state: dict, twin: dict, p0: torch.Tensor) -> dict:
    """A group run's state against its one-device twin's from the same
    initial params p0: the share of the twin's moved coordinates the run
    moved too, whether the coordinates both moved agree within rtol
    PAR_RTOL / atol PAR_ATOL, and the largest difference there."""
    agree, rel, swapped = round_agreement(state, twin, p0)
    both = (state["params"] != p0) & (twin["params"] != p0)
    a, b = state["params"][both], twin["params"][both]
    return {"agree": agree, "rel": rel, "swapped": swapped,
            "close": bool(torch.allclose(a, b, rtol=PAR_RTOL, atol=PAR_ATOL)),
            "max_abs": (a - b).abs().max().item() if a.numel() else 0.0}


def _stack_blocks(cfg, n: int, seed: int, device: str) -> dict:
    """n GPT-2 blocks' parameters from a seeded generator (Dense kernels
    normal(0.02), norms 1, biases 0), stacked [n, ...] by the port's
    names."""
    from commefficient_tpu_torch.models import gpt2

    gen = torch.Generator().manual_seed(seed)
    block = gpt2.Block(cfg)
    layers = []
    for _ in range(n):
        layer = {}
        for name, p in block.named_parameters():
            if p.dim() == 2:
                layer[name] = torch.randn(p.shape, generator=gen) * 0.02
            else:
                layer[name] = torch.ones(p.shape) if ".weight" in name and "ln_" in name \
                    else torch.zeros(p.shape)
        layers.append(layer)
    return {k: torch.stack([layer[k] for layer in layers]).to(device) for k in layers[0]}


def pipeline_check(axis, device: str) -> dict:
    """Phase 27d on this rank: GPT-2 small's 12 blocks in S stages at
    PIPE_MICRO microbatches of PIPE_ROWS rows, forward and the stage's
    gradients of mean(y^2), against the sequential stack on this rank."""
    import torch.distributed as dist
    from torch.func import functional_call

    from commefficient_tpu_torch.models import gpt2
    from commefficient_tpu_torch.ops import pipeline

    cfg = dataclasses.replace(gpt2.SMALL, vocab_size=261, n_positions=256, dropout=0.0)
    block = gpt2.Block(cfg).to(device)
    stacked = _stack_blocks(cfg, cfg.n_layer, 27, device)
    gen = torch.Generator().manual_seed(28)
    x = torch.randn(PIPE_MICRO, PIPE_ROWS, cfg.n_positions, cfg.n_embd, generator=gen).to(device)

    def layer_fn(p, h):
        return functional_call(block, p, (h, None))

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()

    def piped():
        staged = pipeline.local_stage(pipeline.stack_stages(stacked, axis.size), axis)
        staged = {k: v.clone().requires_grad_() for k, v in staged.items()}
        y = pipeline.pipeline_apply(pipeline.scan_stage(layer_fn), staged, x, axis)
        torch.mean(y ** 2).backward()
        return y.detach(), staged

    def sequential():
        seq = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        ys = torch.stack([pipeline.scan_stage(layer_fn)(seq, x[m]) for m in range(PIPE_MICRO)])
        torch.mean(ys ** 2).backward()
        return ys.detach(), seq

    ms, got = {}, {}
    for _ in range(2):  # the first turn warms up; the second's times are kept
        for name, fn in (("pipe", piped), ("seq", sequential)):
            sync()
            t0 = time.perf_counter()
            got[name] = fn()
            sync()
            ms[name] = (time.perf_counter() - t0) * 1e3
    (y, staged), (ys, seq) = got["pipe"], got["seq"]
    pipe_ms, seq_ms = ms["pipe"], ms["seq"]
    per = cfg.n_layer // axis.size
    lo = axis.index * per
    y_err = (y - ys).abs().max().item()
    ok = torch.allclose(y, ys, rtol=PAR_RTOL, atol=PAR_ATOL)
    g_err = 0.0
    for k, v in staged.items():
        want = seq[k].grad[lo:lo + per]
        g_err = max(g_err, (v.grad[0] - want).abs().max().item())
        ok = ok and torch.allclose(v.grad[0], want, rtol=PAR_RTOL, atol=PAR_ATOL)
    return {"ok": bool(ok), "y_err": y_err, "grad_err": g_err, "pipe_ms": pipe_ms,
            "seq_ms": seq_ms}


def _parallel_rank(base: str, device: str) -> None:
    """One rank of phase 27's gloo group: (b) --model_parallel 2 and (c)
    --seq_parallel 2 --attn_impl ring through ``gpt2_train.main`` with
    (e)'s F1 decode, each held against its one-device twin's state from
    ``base``, then the served runs (f) and (g) against theirs, then (d)
    the pipeline; writes its readings to ``base/rank<r>.json``."""
    sys.path.insert(0, ROOT)
    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.federated import engine
    from commefficient_tpu_torch.parallel import collectives, distributed
    from commefficient_tpu_torch.sketch import csvec, kernels

    reuse_run_inputs(cv_train)
    distributed.initialize(force=True, backend="gloo", device=device)
    rank = distributed.rank()
    out = {}
    p0 = torch.load(os.path.join(base, "p0.pt"), map_location=device)
    tp, seq = ["--model_parallel", "2"], ["--seq_parallel", "2", "--attn_impl", "ring"]
    for tag, flags, changes, twin in (("tp", tp + PAR_F1, {}, "plain"),
                                      ("seq", seq + PAR_F1, {"dropout": 0.0}, "dense0"),
                                      ("serve_tp", tp, {}, "serve_plain"),
                                      ("serve_seq", seq, {"dropout": 0.0}, "serve_dense0")):
        served = tag.startswith("serve")
        if served:
            got = served_par_run(kernels, f"{tag}_rank{rank}", flags, changes, device, base)
        else:
            got = par_run(kernels, engine, f"{tag}_rank{rank}", flags, changes, device, base)
        s = got["session"]
        st = {k: v for k, v in _state(s).items()}
        want = torch.load(os.path.join(base, f"{twin}.pt"), map_location=device)
        errs = check_kernels(csvec, s.cfg.mode.sketch_spec, st["params"], st["Verror"])
        out[tag] = {"digest": tree_digest(st), "launches": got["launches"], "rows": got["rows"],
                    "kernel_errs": list(errs), "parallel": s.train_loss_fn.parallel is not None,
                    **par_agreement(st, want, p0)}
        if served:
            out[tag].update(round_ms=got["round_ms"], steps=got["steps"],
                            serve_parallel=s.serve_train_loss_fn.parallel is not None)
        else:
            out[tag].update(rounds=got["rounds"], peak_gb=got["peak_gb"],
                            round_peak_gb=got["round_peak_gb"], decodes=got["decodes"])
        del s, got, st, want
        if device == "cuda":
            torch.cuda.empty_cache()
    axis = collectives.Axis(torch.distributed.group.WORLD, distributed.world_size(), rank)
    out["pipe"] = pipeline_check(axis, device)
    with open(os.path.join(base, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()


def check_decodes(what: str, ranks: list, one_card: dict, card: str) -> None:
    """Phase 27e on a group run: every rank's decode bitwise rank 0's, and
    rank 0's against the one-card run's, each differing token printed with
    its step's top-2 logit gaps; one at a gap above F1_GAP fails."""
    for r, d in enumerate(ranks[1:], 1):
        if d["ids"] != ranks[0]["ids"] or d["lengths"] != ranks[0]["lengths"]:
            fail(f"parallel e ({what}): rank {r}'s decoded ids differ from rank 0's")
    diffs = decode_diffs(ranks[0], one_card)
    for b, step, have, want, gap, gap_one in diffs:
        print(f"parallel e ({what}): row {b} departs from the one-card decode at step {step}: "
              f"token {have} against {want}, top-2 logit gap {gap:.3e} here, {gap_one:.3e} on "
              f"the one card [{card}]", flush=True)
    if any(gap > F1_GAP for *_, gap, _ in diffs):
        fail(f"parallel e ({what}): a decoded token differs from the one-card decode at a "
             f"top-2 logit gap above {F1_GAP}")
    print(f"parallel e ({what}): the ranks' ids and lengths bitwise; {len(diffs)} of "
          f"{len(ranks[0]['ids'])} rows depart from the one-card decode [{card}]", flush=True)


def parallel_phase(cv_train, engine, csvec, kernels, card: str, device: str = "cuda",
                   before_group=None) -> dict:
    """Phase 27: GPT-2's parallelism on phase 11's cell; ``before_group``,
    if given, is called just before the group's launch (after (a)'s timed
    runs). Returns each kernel's launches over each run (each rank's on the
    group)."""
    import shutil

    from commefficient_tpu_torch.parallel import distributed

    reuse_run_inputs(cv_train)
    base = os.path.join(ROOT, "build", "chip_smoke", "parallel")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    phase_t = time.perf_counter()
    launches = {}

    def line(label, got):
        r = got["rounds"]
        return (f"{label}: round ms {[round(x['round_ms'], 1) for x in r]}, peak device memory "
                f"{[round(x['peak_gb'], 2) for x in r]} GB a round step, {got['peak_gb']:.2f} GB "
                f"over the run, launches {got['launches']}, final row "
                f"{got['rows'][-1] if got['rows'] else None} [{card}]")

    # a. remat against plain on one card, each with (e)'s F1 decode
    runs = {}
    for label, changes in (("plain", {}), ("remat", {"remat": True}), ("dense0", {"dropout": 0.0})):
        # round 1 (the warm-up) records the memory history; round 2 is timed clean
        runs[label] = par_run(kernels, engine, label, PAR_F1, changes, device, base,
                              trace_round=0 if label != "dense0" else None)
        launches[label] = runs[label]["launches"]
        print(f"parallel a {line(label, runs[label])}", flush=True)
    one_card = {label: runs[label]["decodes"][-1] for label in ("plain", "dense0")}
    for label in runs:
        print(f"parallel e (a) {label}: {decode_line(runs[label])} [{card}]", flush=True)
    pl, rm = runs["plain"]["session"], runs["remat"]["session"]
    if not (_equal(_state(pl), _state(rm)) and runs["plain"]["rows"] == [
            {**r, "time_s": p["time_s"]} for r, p in zip(runs["remat"]["rows"],
                                                         runs["plain"]["rows"])]):
        fail("parallel a: the remat run differs from the plain run")
    pk, rk = runs["plain"]["round_peak_gb"], runs["remat"]["round_peak_gb"]
    pc, rc = (max(r["client_peak_gb"] for r in runs[k]["rounds"]) for k in ("plain", "remat"))
    print(f"parallel a: remat == plain bitwise over {PAR_ROUNDS} rounds (params, Vvelocity, "
          f"Verror, rows); a round step's peak device memory {pk:.2f} GB plain, {rk:.2f} GB "
          f"remat ({100 * (1 - rk / max(pk, 1e-9)):.1f} % less), its client phase's {pc:.2f} "
          f"and {rc:.2f} GB ({100 * (1 - rc / max(pc, 1e-9)):.1f} % less); over the run, eval "
          f"included, {runs['plain']['peak_gb']:.2f} and {runs['remat']['peak_gb']:.2f} GB "
          f"[{card}]", flush=True)
    for label in ("plain", "remat"):
        if runs[label]["peak_sites"]:
            print(f"parallel a {label}: round 1's client phase at its peak (memory history "
                  f"replayed): {runs[label]['peak_sites']}", flush=True)
    if not all(torch.equal(runs[k]["p0"], runs["plain"]["p0"]) for k in runs):
        fail("parallel a: the runs started from different params")
    torch.save(runs["plain"]["p0"], os.path.join(base, "p0.pt"))
    for label in ("plain", "dense0"):
        torch.save(_state(runs[label]["session"]), os.path.join(base, f"{label}.pt"))
    del runs, pl, rm
    if device == "cuda":
        torch.cuda.empty_cache()
    # f, g: the served runs' one-card twins
    for label, changes in (("serve_plain", {}), ("serve_dense0", {"dropout": 0.0})):
        got = served_par_run(kernels, label, [], changes, device, base)
        launches[label] = got["launches"]
        torch.save(_state(got["session"]), os.path.join(base, f"{label}.pt"))
        print(f"parallel {'f' if label == 'serve_plain' else 'g'} twin {label}: "
              f"{served_line(got)} [{card}]", flush=True)
        del got
        if device == "cuda":
            torch.cuda.empty_cache()

    # b-d. the group
    if before_group is not None:
        before_group()
    t0 = time.perf_counter()
    codes = distributed.launch_local(_parallel_rank, PAR_RANKS, (base, device),
                                     env={"LOCAL_RANK": "0"}, timeout_s=900)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(PAR_RANKS):
        path = os.path.join(base, f"rank{r}.json")
        if not os.path.exists(path):
            fail(f"parallel: rank {r} wrote nothing (exit codes {codes})")
        with open(path) as f:
            ranks.append(json.load(f))
    if codes != [0] * PAR_RANKS:
        fail(f"parallel: exit codes {codes}")
    for tag, what in (("tp", "b --model_parallel 2"), ("seq", "c --seq_parallel 2 ring"),
                      ("serve_tp", "f served --model_parallel 2"),
                      ("serve_seq", "g served --seq_parallel 2 ring")):
        first = ranks[0][tag]
        for r, got in enumerate(ranks):
            g = got[tag]
            launches[f"{tag}_rank{r}"] = g["launches"]
            if not g["parallel"] or not g.get("serve_parallel", True):
                fail(f"parallel {what}: rank {r}'s loss computed over no group")
            if g["digest"] != first["digest"]:
                fail(f"parallel {what}: rank {r}'s state differs from rank 0's")
            if any(g["kernel_errs"]):
                fail(f"parallel {what}: rank {r}'s kernels differ from the plain versions")
            if not g["close"] or g["agree"] < PAR_TOPK_AGREE:
                fail(f"parallel {what}: rank {r} against the one-device run: agreement "
                     f"{g['agree']}, within tolerance {g['close']}, max abs {g['max_abs']}")
        if tag.startswith("serve"):
            print(f"parallel {what}: ranks bitwise; against the one-card served twin: moved-set "
                  f"agreement {first['agree']:.6f}, {first['swapped']} coordinates moved by one "
                  f"only, the both-moved coordinates within rtol {PAR_RTOL} / atol {PAR_ATOL} "
                  f"(max abs {first['max_abs']:.3e}, rel L2 {first['rel']:.3e}); kernels == "
                  f"plain on every rank; rank 0's {served_line(first)} (gloo through host "
                  f"memory, 2 ranks on one card) [{card}]", flush=True)
            continue
        check_decodes(what, [got[tag]["decodes"][-1] for got in ranks],
                      one_card["plain" if tag == "tp" else "dense0"], card)
        print(f"parallel e ({what[0]}): rank 0's {decode_line(first)} [{card}]", flush=True)
        rounds = first["rounds"]
        print(f"parallel {what}: ranks bitwise; against the one-device run: moved-set "
              f"agreement {first['agree']:.6f}, {first['swapped']} coordinates moved by one "
              f"only, the both-moved coordinates within rtol {PAR_RTOL} / atol {PAR_ATOL} (max "
              f"abs {first['max_abs']:.3e}, rel L2 {first['rel']:.3e}); kernels == plain on "
              f"the run's params and error table; launches a rank {first['launches']}; rank "
              f"0's rounds: ms {[round(x['round_ms'], 1) for x in rounds]}, collective MB "
              f"{[round(x['coll_bytes'] / 1e6, 1) for x in rounds]}, calls "
              f"{[x['coll_calls'] for x in rounds]}, host ms in collectives "
              f"{[round(x['coll_ms'], 1) for x in rounds]} (gloo through host memory, 2 ranks "
              f"on one card); a rank's peak device memory {first['round_peak_gb']:.2f} GB a "
              f"round step, {first['peak_gb']:.2f} GB over the run; final row "
              f"{first['rows'][-1] if first['rows'] else None} [{card}]", flush=True)
    for r, got in enumerate(ranks):
        pp = got["pipe"]
        if not pp["ok"]:
            fail(f"parallel d: rank {r}'s pipeline differs from the sequential stack "
                 f"(y {pp['y_err']}, grads {pp['grad_err']})")
    pp = ranks[0]["pipe"]
    print(f"parallel d: pipeline_apply over GPT-2 small's 12 blocks in {PAR_RANKS} stages at "
          f"{PIPE_MICRO} microbatches of {PIPE_ROWS} rows == the sequential stack within rtol "
          f"{PAR_RTOL} / atol {PAR_ATOL} on every rank (max abs y {pp['y_err']:.3e}, grads "
          f"{max(g['pipe']['grad_err'] for g in ranks):.3e}); forward + backward "
          f"{pp['pipe_ms']:.1f} ms pipelined, {pp['seq_ms']:.1f} ms sequential on rank 0, after "
          "a warm-up turn of each "
          f"[{card}]", flush=True)
    print(f"parallel: group launch {wall:.1f} s; phase took {time.perf_counter() - phase_t:.1f} "
          f"s [{card}]", flush=True)
    return launches


def time_kernels(csvec, kernels, time_ms, spec, gen: torch.Generator) -> dict:
    """Each kernel's median over CUDA-event-timed launches at ``spec``'s
    shape, cold (L2 flushed before each) and warm (its input just
    rewritten), its plain version's time and its bound: the bytes it must
    move at 3.35 TB/s or its float32 operations at 67 TFLOP/s, whichever
    is larger. Prints one line per kernel."""
    d, c, r = spec.d, spec.c, spec.r
    v = torch.randn(d, generator=gen, device="cuda")
    table = csvec._sketch_vec_rotation(spec, v)
    shifts, ks = csvec._rotation_keys(spec, v.device)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    hash_bytes = 4 * (r * spec.num_slabs + r)
    work = {
        # bytes: v read once, table written once (query: the reverse)
        "sketch_accumulate": dict(
            fn=lambda: kernels.accumulate(v, shifts, ks, c), input=v,
            plain=lambda: csvec._sketch_vec_rotation(spec, v),
            bytes=4 * d + 4 * r * c + hash_bytes,
            ops=2 * r * d),  # a +-1 multiply and an add per (row, coordinate)
        "sketch_query": dict(
            fn=lambda: kernels.query(table, shifts, ks, d), input=table,
            plain=lambda: csvec._query_all_rotation(spec, table),
            bytes=4 * r * c + 4 * d + hash_bytes,
            # r multiplies and the odd-even network's min and max per coordinate
            ops=(r + 2 * sum((r - p % 2) // 2 for p in range(r))) * d),
    }
    out = {}
    for name, w in work.items():
        ms = time_ms(w["fn"], TIMED_LAUNCHES, flush.sum)
        # warm: the input just written, and read from L2 as far as it fits
        warm_ms = time_ms(w["fn"], TIMED_LAUNCHES, lambda: w["input"].mul_(1.0))
        plain_ms = time_ms(w["plain"], 5, flush.sum)
        bytes_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = w["ops"] / FP32_OPS_PER_S * 1e3
        out[name] = {"ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "mb": w["bytes"] / 1e6}
        print(f"{name} at d={d} c={c} r={r}: {ms:.4f} ms (L2 flushed; median of "
              f"{TIMED_LAUNCHES})  warm {warm_ms:.4f} ms  plain {plain_ms:.3f} ms  bound "
              f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}: "
              f"{w['bytes'] / 1e6:.1f} MB)", flush=True)
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.federated import engine
    from commefficient_tpu_torch.models.convert import FlatLayout
    from commefficient_tpu_torch.models.resnet9 import ResNet9, init_weights
    from commefficient_tpu_torch.sketch import _build, csvec, kernels
    from commefficient_tpu_torch.sketch.time_kernels import card_line, ptxas_summary, time_ms

    reuse_run_inputs(cv_train)
    cohorts = int(argv[argv.index("--cohorts") + 1]) if "--cohorts" in argv else COHORTS
    pairs = int(argv[argv.index("--pairs") + 1]) if "--pairs" in argv else PAIRS
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"== phase {name} at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 1. card
    print(f"card: {card_line()}", flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s  ({_build.library_path().name})", flush=True)
    if _build.build_log:
        print(f"ptxas: {ptxas_summary(_build.build_log)}", flush=True)

    # 3. kernel vs plain
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"sketch_accumulate": 0.0, "sketch_query": 0.0}
    for d, c, r in [(SLICE["d"], SLICE["c"], SLICE["r"]), *EDGE_SHAPES]:
        spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=42, family="rotation")
        v = torch.randn(d, generator=gen, device=dev)
        a, q = check_kernels(csvec, spec, v)
        errs["sketch_accumulate"] = max(errs["sketch_accumulate"], a)
        errs["sketch_query"] = max(errs["sketch_query"], q)
        print(f"kernel == plain at d={d} c={c} r={r}", flush=True)

    # 4. times at the slice's shapes
    phase("4 (times)")
    spec = csvec.CSVecSpec(d=SLICE["d"], c=SLICE["c"], r=SLICE["r"], seed=42,
                           family="rotation")
    rows = {}
    for name, t in time_kernels(csvec, kernels, time_ms, spec, gen).items():
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "commefficient_tpu_torch/sketch/csrc/sketch_kernels.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": 0.0,
            **{k: t[k] for k in ("ms", "warm_ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
        }
    if "--kernels-only" in argv:
        print("chip_smoke: kernels-only run done", flush=True)
        return 0
    if "--group-only" in argv:
        phase("20 (group)")
        group = group_phase(cv_train, engine, kernels, card_line())
        for name in rows:
            rows[name]["launches_group"] = {run: n[name] for run, n in group.items()}
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: group-only run done", flush=True)
        return 0
    if "--serve-only" in argv:
        phase("21 (serving on a group, the pipeline)")
        served, _ = serve_group_phase(cv_train, engine, csvec, kernels, card_line())
        for name in rows:
            rows[name]["launches_serve_group"] = {run: n[name] for run, n in served.items()}
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: serve-only run done", flush=True)
        return 0
    if "--async-only" in argv:
        phase("22 (the buffered-async service)")
        asy = async_phase(cv_train, engine, csvec, kernels, card_line())
        for name in rows:
            rows[name]["launches_async"] = {run: n[name] for run, n in asy.items()}
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: async-only run done", flush=True)
        return 0
    if "--fastpath-only" in argv:
        phase("23 (the serving fast path)")
        fp = fastpath_phase(cv_train, engine, csvec, kernels, card_line())
        for name in rows:
            rows[name]["launches_fastpath"] = {run: n[name] for run, n in fp.items()}
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: fastpath-only run done", flush=True)
        return 0
    if "--shard-turns" in argv:
        phase("24 (the sharded ingest, in turns)")
        shard_turns(cv_train, kernels, card_line(), int(argv[argv.index("--shard-turns") + 1]))
        print("chip_smoke: shard-turns run done", flush=True)
        return 0
    if "--shards-only" in argv:
        phase("24 (the sharded ingest)")
        sh = shards_phase(cv_train, engine, csvec, kernels, card_line())
        for name in rows:
            rows[name]["launches_shards"] = {run: n[name] for run, n in sh.items()}
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: shards-only run done", flush=True)
        return 0
    if "--edges-only" in argv:
        phase("25 (the edge tree)")
        ed = edges_phase(cv_train, engine, csvec, kernels, card_line())
        for name in rows:
            rows[name]["launches_edges"] = {run: n[name] for run, n in ed.items()}
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: edges-only run done", flush=True)
        return 0
    if "--moe-only" in argv:
        phase("26 (mixture of experts)")
        moe = moe_phase(kernels, csvec, engine, time_ms, gen, card_line())
        for name in rows:
            rows[name]["gpt2_moe"] = moe[name]
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: moe-only run done", flush=True)
        return 0
    if "--parallel-only" in argv:
        phase("27 (parallelism)")
        par = parallel_phase(cv_train, engine, csvec, kernels, card_line())
        for name in rows:
            rows[name]["launches_parallel"] = {run: n[name] for run, n in par.items()}
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: parallel-only run done", flush=True)
        return 0
    if "--layerwise-only" in argv:
        phase("19 (layerwise)")
        lw = layerwise_phase(cv_train, engine, csvec, kernels, time_ms, gen, card_line())
        rows["sketch_accumulate_tree"] = tree_row(lw)
        for name in rows:
            rows[name]["launches_layerwise"] = {run: n[name] for run, n in lw["launches"].items()}
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print("chip_smoke: layerwise-only run done", flush=True)
        return 0

    # 5. main path
    phase("5 (main path)")
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, "sketch_rows.jsonl")
    if os.path.exists(log):
        os.remove(log)
    model = ResNet9()
    init_weights(model, 42)  # the parser's default --seed: the run's initial params
    p0 = FlatLayout(model).flatten(dict(model.named_parameters())).to(dev)
    kernels.reset_launch_counts()
    session = cv_train.main(SLICE_ARGS + ["--num_rounds", str(ROUNDS), "--log_jsonl", log])
    torch.cuda.synchronize()
    launches = ravel_launches(kernels)
    with open(log) as f:
        logged = [json.loads(line) for line in f]
    for row in logged:
        for key in ("train_loss", "test_loss"):
            if not math.isfinite(row[key]):
                fail(f"non-finite {key} in {row}")
    if len(logged) != 1 or logged[0]["round"] != ROUNDS:
        fail(f"expected one eval row at round {ROUNDS}, got {logged}")
    for name, n in launches.items():
        if n < ROUNDS:
            fail(f"{name} launched {n} times in {ROUNDS} sketch rounds")
        rows[name]["launches"] = n
    pflat = session.state["params"]
    if tuple(pflat.shape) != (SLICE["d"],) or not torch.isfinite(pflat).all():
        fail("params are not finite [d]")
    # round 1 runs at lr 0 (the triangular schedule starts there); each
    # later round moves at most k coordinates
    moved = int((pflat != p0).sum())
    if not 0 < moved <= ROUNDS * session.cfg.mode.k:
        fail(f"{moved} params moved in {ROUNDS} rounds of k={session.cfg.mode.k}")
    window_ms = session.run_stats.round_ms
    print(f"main path: {ROUNDS} sketch rounds (async loop), launches {launches}, {moved} "
          f"params moved, per-round ms from drains {[round(t, 2) for t in window_ms]} "
          f"(rounds per drain {session.run_stats.window_rounds}), rtt "
          f"{session.run_stats.rtt_ms:.3f} ms, in-flight depth "
          f"{session.run_stats.max_inflight_used}", flush=True)

    # 6. checked rounds
    phase("6 (checked rounds)")
    print(check_sketch_round(session, engine, csvec), flush=True)
    uncompressed = cv_train.main(SLICE_ARGS + ["--mode", "uncompressed", "--num_rounds", "1"])
    if not torch.isfinite(uncompressed.state["params"]).all():
        fail("uncompressed round produced non-finite params")
    print(f"uncompressed: 1 round (lr 0), {uncompressed.run_stats.round_ms[0]:.2f} ms",
          flush=True)
    print(check_control_round(uncompressed, engine), flush=True)

    # 7. card vs CPU
    phase("7 (card vs CPU)")
    card_vs_cpu(session, engine, csvec, cohorts, errs)

    # 8. run loop
    phase("8 (run loop)")
    card = card_line()
    launches = run_loop_phase(cv_train, kernels, card, pairs)
    for name, n in launches.items():
        rows[name]["launches"] = n
    sync_probe(cv_train, SLICE_ARGS)
    check_kernels(csvec, session.cfg.mode.sketch_spec, session.state["params"],
                  session.state["mode_state"]["Verror"])
    print("run loop: kernels == plain on the run's params and error table", flush=True)

    # 9. profile
    phase("9 (profile)")
    f32 = {"resnet9_busy_ms": profile_rounds(session)}
    determinism_cost(session, card)

    # 10. baselines
    phase("10 (baselines)")
    sketch_state = baselines_phase(cv_train, engine, csvec, kernels, card)
    print(f"baselines: the sketched server state launched {sketch_state} in {BASE_ROUNDS} "
          "rounds (one per round)", flush=True)

    # 11. GPT-2
    phase("11 (gpt2)")
    prof = {}
    gpt2 = gpt2_phase(kernels, csvec, engine, time_ms, gen, card, prof)
    f32.update(gpt2_busy_ms=prof.get("busy_ms", 0.0), gpt2_gemm_ms=prof.get("gemm_ms", 0.0))

    # 12. client participation
    phase("12 (cohort)")
    cohort = cohort_phase(cv_train, engine, csvec, kernels, card)

    # 13. bfloat16, the double head, --init_from
    phase("13 (bf16, double head, init_from)")
    bf16 = bf16_phase(cv_train, engine, csvec, kernels, time_ms, gen, card, f32)

    # 14. serving
    phase("14 (serving)")
    serve = serve_phase(cv_train, engine, csvec, kernels, card)

    # 15. batched clients
    phase("15 (batched clients)")
    batched = batched_phase(cv_train, engine, csvec, kernels, card)

    # 16. observability
    phase("16 (observability)")
    obs_launches = obs_phase(cv_train, engine, csvec, kernels, card)

    # 17. robust merges and the quarantine
    phase("17 (robust merges, quarantine)")
    robust = robust_phase(cv_train, engine, csvec, kernels, card)

    # 18. the sharded round; one launch of 4 gloo ranks runs the group runs
    # of phases 18b, 20 and 21 (and through 21, those of 22f to 25f)
    phase("18 (sharded round)")
    served_extra = ("async", "fast", "proc", "edge")
    joint = joint_launch(("mesh", "group", "serve"), served_extra)
    mesh = mesh_phase(cv_train, engine, kernels, card, joint)

    # 19. the layerwise sketch path
    phase("19 (layerwise)")
    lw = layerwise_phase(cv_train, engine, csvec, kernels, time_ms, gen, card)

    # 20. the rest of the client mesh on a group
    phase("20 (group)")
    group = group_phase(cv_train, engine, kernels, card, joint)

    # 21. serving on a group, the serving pipeline
    phase("21 (serving on a group, the pipeline)")
    served, shared = serve_group_phase(cv_train, engine, csvec, kernels, card,
                                       extra=served_extra, joint=joint)

    # 22. the buffered-async service
    phase("22 (the buffered-async service)")
    asy = async_phase(cv_train, engine, csvec, kernels, card, shared)

    # 23. the serving fast path
    phase("23 (the serving fast path)")
    eventloop = {}
    fp = fastpath_phase(cv_train, engine, csvec, kernels, card, shared, runs_out=eventloop)

    # 24. the sharded ingest (23b's one-listener runs are its (a)'s)
    phase("24 (the sharded ingest)")
    sh = shards_phase(cv_train, engine, csvec, kernels, card, shared, eventloop=eventloop)

    # 25. the two-tier edge tree
    phase("25 (the edge tree)")
    ed = edges_phase(cv_train, engine, csvec, kernels, card, shared)

    # 26. GPT-2's mixture of experts past the unsketch's single-shot line
    phase("26 (mixture of experts)")
    # (c)'s CPU scan runs beside phase 27's group launch and is checked
    # after it
    moe_pending: list = []
    moe = moe_phase(kernels, csvec, engine, time_ms, gen, card, pending=moe_pending)

    # 27. GPT-2's parallelism: remat, tensor and sequence parallelism, GPipe
    phase("27 (parallelism)")
    par = parallel_phase(cv_train, engine, csvec, kernels, card,
                         before_group=lambda: [start() for start, _ in moe_pending])
    phase("26c (the MoE unsketch against the CPU scan)")
    for _, finish in moe_pending:
        finish()
    phase("end")

    for name in rows:
        rows[name]["max_abs_err"] = max(errs[name], bf16["gpt2_mc"][name]["max_abs_err"],
                                        moe[name]["max_abs_err"])
        rows[name]["gpt2_moe"] = moe[name]
        rows[name]["gpt2"] = gpt2[name]
        rows[name]["launches_cohort"] = cohort[name]
        rows[name]["gpt2_mc_bf16"] = bf16["gpt2_mc"][name]
        rows[name]["launches_bf16"] = {run: n[name] for run, n in bf16["launches"].items()}
        rows[name]["launches_serve"] = {run: n[name] for run, n in serve.items()}
        rows[name]["launches_batched"] = {run: n[name] for run, n in batched.items()}
        rows[name]["launches_obs"] = {run: n[name] for run, n in obs_launches.items()}
        rows[name]["launches_robust"] = {run: n[name] for run, n in robust.items()}
        rows[name]["launches_mesh"] = {run: n[name] for run, n in mesh.items()}
    rows["sketch_accumulate_tree"] = tree_row(lw)
    for name in rows:
        rows[name]["launches_layerwise"] = {run: n[name] for run, n in lw["launches"].items()}
        rows[name]["launches_group"] = {run: n.get(name, 0) for run, n in group.items()}
        rows[name]["launches_serve_group"] = {run: n.get(name, 0) for run, n in served.items()}
        rows[name]["launches_async"] = {run: n.get(name, 0) for run, n in asy.items()}
        rows[name]["launches_fastpath"] = {run: n.get(name, 0) for run, n in fp.items()}
        rows[name]["launches_shards"] = {run: n.get(name, 0) for run, n in sh.items()}
        rows[name]["launches_edges"] = {run: n.get(name, 0) for run, n in ed.items()}
        rows[name]["launches_parallel"] = {run: n.get(name, 0) for run, n in par.items()}
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
