#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure;
each phase's start goes to stderr with the seconds since the start, and a
run still going after ``SMOKE_LIMIT_S`` dumps every thread's stack there
and exits non-zero):

1. Device: the card's name and power limit (nvidia-smi).
2. Build: every CUDA kernel from ``csrc/`` (one nvcc each, in parallel),
   with each kernel instance's registers, static shared memory and spills
   from the ``ptxas`` report; the import check of every port module; the
   port's ``scripts/check_metrics_catalog.py`` (its three planes against
   ``docs/OBSERVABILITY.md``'s catalog).
3. Kernels against their plain PyTorch versions, on the card:
   decode attention at every window bucket up to 4096 (G = 1, 2, 4, 8;
   strided windows of a real cache buffer; lengths 0, mid and W), and
   where its split over the window can go wrong (lengths on and beside
   every split boundary, W = 997 of a 1000-wide window, W = 97 of 100,
   16-byte and 4-byte row loads, G = 8 and a length-0 row with several
   splits, a split past W), within 1e-4 absolute + 1e-4 relative in f32;
   the same decode kernel over a bf16 window (the dense cache's instance,
   no scales) at the same bucket ladder and split edges (4-byte rows from
   130-wide buffers), within the same tolerance, timed at Llama-2-7B's
   decode shape beside its plain chain and SDPA over the window;
   RMSNorm at H = 4096 and rows 1, 4, 32, 256, 512 in bf16 within one
   bf16 ulp, f32 x within 1e-6, a misaligned view that must take the
   scalar instance and a 32768-wide row that must take the cluster
   instance, each with the plan that ran and the host's time a call, and
   the plan taken against other cuts of a row (a plan sweep);
   flash attention at BERT-base B32/H12/S128/D64 with a ragged key bias
   (one row masked everywhere), the same from strided views of one
   projection buffer, B8/S512, causal and kv_len forms at D=128 S=T=1024,
   S=T=50, D=16 and D=32 at S=T=200 with a bias, causal at S=T=200, f32
   I/O and kv_len 0 (every row the mean of V), Llama-2-7B's prefill
   shapes (a whole 1024-token causal prompt; 256-token chunks at cache
   offsets 256, 768 and 3840 read through strided views of a
   position-major [1, 4096, NKV, 128] buffer; grouped heads at G = 4 and
   8; S = 100 at offset 300; each in bf16 and f32), within FLASH_TOL, a q
   that is not 16-byte aligned and a chunk with q_offset + S > T (each a
   ValueError).  Times each kernel, its plain version and, where one
   exists, the one PyTorch call for the
   function (``F.rms_norm``, SDPA for flash attention), each with the
   profiler's device time beside its CUDA-event time; decode attention
   also over a ladder of windows, with its split count.  The decode
   kernel's verify chunk instance (self-speculative verify) against its
   plain versions, int8 and bf16/f32 windows: NKV 32 G 1 and a synthetic
   NKV 8 at G 4 and 8, B 4, W 768 and 4096, S 2, 3, 5, 17 and 65, S 128,
   256, 512 and 1024 at G 1 and S 1024 at G 4 (a super-step as wide as the
   shipped CRs' prefill chunk), lengths 0, 1, W - 1 and W / 2 in one batch,
   chunk rows near the int8 clip, bf16 and f32 q, within the decode checks'
   tolerance, and an empty chunk or rows that are not S x G raising before
   a launch; its time over S (2 .. 1024) at W 768 beside the S = 1 decode
   kernel on the same window, its plain version and (dense) SDPA over the
   window plus the chunk with a boolean mask;
   with a live count a slot (``counts``, the unified super-step's) at S =
   256: counts 1 / 5 / 256 / 0 against the plain version with them (int8
   and bf16/f32 windows, W 768 and 4096, parked rows exactly zero), and
   device ms at W 768 under a decode-only tick's mix (1 x 4) and a mixed
   tick's (1, 1, 5, 256), with and without counts, beside the bound.
   The ragged instance of the flash kernel (packed prefill) against its
   plain version computed in f32 from the same inputs, within FLASH_TOL:
   int8 (with scales) and bf16 caches of 10 rows, B_p 1, 3 real rows padded
   with a parked row (offset = capacity) and 8, permuted slots, offsets 0,
   256, 768, 3840 and off the 64-key tiles (37, 1337, 3990), G 1, 4 and 8,
   chunks of 256 and 100, chunk rows near the int8 clip, D 128 and one
   check a cache at D 64; timed at Llama-2-7B's packed shape (B_p 4, C 256,
   offsets 0/256/768/3840, H = NKV = 32, D 128) on both caches beside its
   plain version, its bound and, on the bf16 cache, SDPA over the gathered window plus the chunk with a
   boolean mask; a misaligned q must raise ValueError.
3b. D-major decode attention against its plain version at the layout
   probe's shapes (B = 8 and 32, NKV=16, D=128, W=512), at W = 96, 192,
   768, 4096, at D=64, with bf16 q and with a W of 97 sliced from a wider
   buffer (one fully masked row, ragged lengths), and where its split
   over W can go wrong (lengths on and beside
   every split edge, B = 1 at W = 4096 with the cap of 8 splits, a split
   past W, 16- and 4-byte copies), within 1e-4 absolute + 1e-4 relative;
   against the head-major decode kernel through the self-row identity at
   the probe's shapes; its time, the profiler's device time, the
   head-major kernel's on the same values and the byte bound, a split
   sweep (1, 2, 4, 8) with the merge that ran and a window ladder (96 to
   4096).  Then the path that runs it: the port's layout probe
   (``<port>.scripts.proto_dmajor_attention``) in process, with its
   parity assert and its launch counts.
4. Loader: writes a tiny native artifact, starts ``python -m
   <port>.server --quantize int8kv`` as a subprocess and calls /generate;
   the process flags: ``--metrics-port`` answers ``/metrics``; SIGTERM with
   ``--drain-s 1`` turns ``/readyz`` to 503 while a generate sent inside the
   lag is answered 200, then the process exits 0; with ``--log-format
   json`` every log line is a JSON object and the completion line carries
   the request id.
5. Serving at full width: Llama-2-7B (all 32 layers), one draw of random
   bf16 weights from a seed serving all three quantize modes behind the
   same ``build_server`` over HTTP.  5b: ``quantize: none`` (bf16
   weights, bf16 KV cache, whole-prompt prefill), then ``quantize: int8``
   (the same tree quantized; bf16 KV cache, prefill chunks of 256, so
   chunks 2+ run flash at a query offset): each answers one request
   alone, four concurrent ones (17/130/300/700-token prompts, one
   sampled) and a seeded stream equal to the same request without stream;
   flash launches = 32 x prefill forwards, decode attention = 32 x decode
   dispatches, RMSNorm = 65 x forwards over every request; tok/s, TTFT,
   peak memory, token agreement and the device busy share of one request.
   Then int8 weights with the int8 KV cache (int8kv).  First the port's
   threefry (``models/prng``) on the card against the same code on the
   CPU at seeds 0, 7, 2^31-1,
   2^32+5 and 2^63-1 ([4, 32000] draws): keys, splits, folds and bits
   identical, uniforms bit-equal, gumbels within 2 f32 ulp of max(|g|, 1).
   Then one request alone, four concurrent ones (one sampled); a seeded
   sampled request (0.8 / top_k 50 / top_p 0.95 / seed 1234, 32 new
   tokens) streamed as Server-Sent Events and again without stream, whose
   tokens must be equal (event indices 0..n-1, the done event's
   ``output_ids``), with the client's TTFT and ITL p50 and max from the
   events' arrival, then four such streams at once (seeds 1234-1237),
   whose ITL p50/p99 take every gap of every stream; ``/metrics`` against the answers (generated tokens,
   TTFT, ITL and request-token counts, the seldon counts by code,
   ``tpumlops_model_ready`` 1); a lossless drain (a 64-token stream in
   flight, ``POST /admin/drain``: ``/readyz`` 503 draining with the
   request in flight, a new request 429 ``draining`` with
   ``Retry-After``, the stream ends whole, the drain answers drained,
   cancel restores 200s, the shed counter moves by one); and a second
   server on the same weights with one slot and an admission budget one
   long prompt fills, where a request over the budget is a 429 ``budget``
   while a stream runs and an oversized request on the idle engine is
   admitted.  The decode-attention launches must equal 32 x the engines'
   decode dispatches, the flash launches 32 x their prefill forwards and
   the RMSNorm launches 65 x their forwards, over every request of the
   phase.  Prints tokens/s, TTFT, the token
   agreement of a greedy request with a teacher-forced forward of its own
   output, what the threefry draw and the whole sampling step add to a
   decode tick at V = 32000 (device ms, launches, host ms), beside the
   per-row ``torch.Generator`` draw it replaced, and a summary
   line with the card's name and power limit.  The HuggingFace loader is
   not driven here: the card's machine has no ``transformers`` (its tests
   run on the CPU).
   5c: the radix prefix cache and self-speculative decoding on the same
   int8 weights (int8kv, 4 slots, prefill chunks of 256; cache budget 512
   MiB, four 128 MiB chunks, host L2 256 MiB; 4 draft tokens, n-grams
   1..4, adaptive).  First ``verify_ragged`` against 5 sequential
   ``decode_ragged`` steps on the card (argmax agreement and the largest
   logit difference, reported).  Then over HTTP: a cold 768 + 100-token
   prompt A, a warm one on the same 768-token prefix, A again (tokens
   equal to the cold answer), a second prefix whose write-back evicts A's
   chunks into the L2, A once more (two chunks promoted from the L2,
   tokens equal again), four concurrent prompts repeating a 64-token
   pattern four times (48 new tokens each, so the drafter proposes) and a
   seeded sampled stream beside them (equal to its answer without
   stream); then four short prompts with speculation off (the drafter
   proposing nothing) and again with an oracle drafter that proposes
   those answers, which must accept drafts and take fewer decode + verify
   ticks than tokens (agreement with the answers with speculation off
   reported, and again with f32 activations on an engine of its own).
   The engine is stopped before its tick-cost probe.  The
   prefix-cache counters must equal ``/metrics`` and the
   values the radix rules give, the spec counters ``/metrics``, with
   drafts proposed; flash = 32 x prefill forwards, decode attention = 32 x
   (decode + verify ticks), RMSNorm = 65 x forwards.  Prints A's cold and
   warm TTFT, the seed's ms a chunk and whether the chunks were pinned,
   verify ticks, tokens a slot a verify tick, the acceptance rate, a verify
   tick's wall and device ms beside a plain decode tick's, the four
   requests' tok/s and their token agreement with a teacher-forced
   forward.
   5d: packed multi-admission prefill on the same int8 weights (int8kv, 4
   slots, chunks of 256, ``prefill_batch`` 4, no token budget, the prefix
   cache on with 2 GiB, speculation off): a prompt P (the 1000-token burst
   prompt's first 768 tokens and 100 of its own) answered cold, then warm
   (its three chunks read back off its reserved row and seeded into the
   next one), equal tokens; then four concurrent prompts of 300 / 700 /
   1000 / 1500 tokens, 16 greedy tokens each, profiled; the same on a
   serial server (``prefill_batch`` 1).  Asserted: fewer packed forwards
   than the burst's 12 chunks, the ``tpumlops_prefill_batch_fill`` count and
   sum on ``/metrics`` equal to the packed forwards and chunks, ragged flash
   launches = 32 x prefill forwards on the packed server (flash on the
   serial one), decode attention = 32 x decode ticks, RMSNorm = 65 x
   forwards, the prefix counters (2 hits, 1536 cached tokens, no eviction).
   Prints both servers' burst TTFT p50 / max, chunks a forward, the device
   idle share of each burst, their token agreement, and one packed forward
   at B_p = 4 beside one serial chunk forward (device and wall ms).  Before
   the weights are quantized, the bf16 tree serves four concurrent 300-700
   token prompts (8 new tokens) with ``quantize: none`` packed and serial:
   the bf16-window instance of the ragged kernel on a served path, its
   launches = 32 x packed forwards, and the packed answers' agreement with
   the serial ones.
   5e: fused multi-step decode (``decode_steps``) and the sampled step's
   kernels.  First the step (``ops/sample_step``: the prep kernel, the
   sort, the draw kernel) against the plain chain at B 1, 4 and 32, V
   32000, 32001 and 128256, four filter mixes (the served T 0.8 / top_k
   50 / top_p 0.95, none, top-p only, top-k 1), two seeds, and on bf16
   logits at B 4, with NaN, +-inf and all -inf rows, greedy rows and a
   top_p 0 row: carry keys and the prep kernel's scaled values bit-equal,
   greedy tokens equal, every other token equal or inside the rule
   (GUMBEL_ULPS between the two choices' scores, or the plain mass at one
   of them within P_TOL of p; the rows that differ are counted); at B 4 and
   32, V 32000, under each mix, the step's device ms, launches and host
   ms, the prep and draw kernels alone, the sort's own device ms, the
   plain chain's, and the bound of the kernels' work.  Then on the bf16
   tree (``quantize: none``, whole prompts) and, after the quantization,
   on int8kv (chunks of 256), both cut to ``MS_LAYERS`` layers (widths
   whole): three servers
   on one weight tree at ``decode_steps`` 1, 4 and 8 (the fused ones
   capture one CUDA graph per window bucket and token rule at start: the
   count, the seconds and the pool's bytes are printed); one replay of a
   captured graph against one eager ``decode_multistep`` from the same
   state (4 rows at lengths 5 / 130 / 700 / 1500, one row's budget ending
   mid-block, greedy and sampled): the token block, ``valid``, lengths,
   tokens, keys and the committed K/V rows bit-equal; each graph's kernel
   nodes (read from the graph itself, kept for that) exactly the kernels
   its capture recorded (the counts each replay adds to the launch
   counters: 32K decode attention, 65K RMSNorm, K prep and K draw kernels
   sampled), and profiled replays of it launching no more than those and
   each of them (up to 5 replays, as a profiler window may miss some);
   then in turns (1, 4, 8, then 8, 4, 1, ...) MS_REPEATS times one request alone (5 + 24
   tokens) and four concurrent ones (17/130/300/700 + 24, one sampled);
   at each K a seeded stream equal to the same request without stream and
   four seeded streams at once (ITL p50 / p99 from the events' arrival,
   TTFT); the launch identities over every request, replays counted
   (decode attention = 32 x (decode ticks + K x multistep dispatches),
   RMSNorm = 65 x those forwards and the prefills, flash = 32 x prefill
   forwards, the sampled step's wrapper = the engines' sampling steps);
   ``/metrics``' multistep dispatches equal to the engines' and ITL
   observations that are not all 0; the idle share of one 5 + 16-token
   request at each K, and of one seeded sampled one (T 0.8, top_k 50,
   top_p 0.95) at K 1 and 4 with its tok/s; peak memory; and the greedy tokens' and the seeded
   stream's agreement with K = 1 (reported: the wider pre-picked window
   changes the decode kernel's split and can flip bf16 near-ties).
   5f: the unified ragged super-step on the bf16 tree (``none``) and,
   after the quantization, on int8kv, both at ``INT8KV_LAYERS`` layers: two
   servers on one weight tree, the
   split engine and the unified one built from ``--unified-step 1`` (both
   K 4, chunks of 256 packed 4, speculation with 4 drafts); the unified
   engine's graphs (2 x |window buckets|), capture seconds and pool bytes;
   one replay of a captured graph against one eager run of the program on
   the same staged inputs, for a decode-only tick and a mixed tick (two
   decode rows, a verify row with 4 drafts, a 256-token prefill row that
   completes its prompt), greedy and sampled: packed outputs, state
   buffers and written K/V rows bit-equal; each graph's kernel nodes the
   counts recorded at its capture (L x K decode attention, L of them the
   verify chunk, (2L + 1) x K RMSNorm, 1 + K sampled steps sampled, 1
   greedy), its profiled replays held to them as in 5e, and each
   tick's device ms; then in turns, UNI_REPEATS times, one request alone
   (5 + 24), four concurrent (17/130/300/700 + 24, one sampled), phase
   5d's burst (300/700/1000/1500 + 16; TTFT p50 and max from the engine's
   hook) and four seeded SSE streams (ITL p50 / p99); every unified tick
   a ``superstep`` dispatch replayed from a graph (seeds aside), some
   ticks carrying a prefill chunk beside decode rows, and the launch
   identities over the turns, the counters set to 0 just before them:
   the unified engine's decode attention L x K a tick (the verify chunk
   L), RMSNorm (2L + 1) x K, no flash, the sampled step's wrapper = its
   sampling steps; the split engine's L a decode or verify tick and L x K
   a multistep dispatch, flash and ragged L a prefill forward; the idle
   share of one 5 + 16 request on each engine (the union of the device
   intervals over the wall of the same profiled request); peak memory;
   greedy agreement of the two engines (reported).
   5g: SLO classes and mid-decode preemption on the bf16 tree (``none``,
   the split engine at K 4) and, after the quantization, on int8kv (the
   unified engine, K 4, chunks of 256 packed 4, 4 drafts; both at
   ``INT8KV_LAYERS`` layers), 4 slots, the
   prefix cache at 512 MiB with L2 256 MiB, ``--slo-class batch
   --preemption 1``.  (a) An engine driven by hand, never started: four
   best-effort streams (300 + 40, one seeded and sampled), and once each
   holds 16 tokens an interactive request (200 + 8) submitted from a
   stream's ``on_token``; every slot's cache row over ``[0, hist)`` and its
   state rows (length, pending token, key row, temperature, top-k, top-p)
   snapshot at each tick boundary until the eviction; the restore held to
   the victim's snapshot bit-equal (a bf16 engine's int8 scales come back
   exactly from ``bf16(code x scale)``; the int8 row also equal to the
   snapshot requantized on the card, and the CPU quantizer's difference
   on it reported), its state rows bit-equal, on the unified engine the engine's
   state still the program's buffers; then one graph replay on the
   restored state against the eager tick, bit-equal.  (b) A server: four
   best-effort SSE streams (300 + 256, one seeded at T 0.8 / top_k 50 /
   top_p 0.95), and once each has 16 tokens two interactive SSE requests
   (200 + 32): every stream whole, evictions >= 1 and restores equal to
   them, nothing recomputed, ``tpumlops_engine_preempt_total{event}`` on
   ``/metrics`` equal to the engine's counters, every unified tick a graph
   replay, the launch identities over the traffic (counters set to 0 just
   before it).  On ``none`` the same traffic on a server with classes but
   no preemption.  Prints the interactive TTFT p50 / max with and without
   preemption, evict and restore ms (synchronized host walls), KV bytes an
   eviction, L2 hits, and the preempted greedy streams' agreement with the
   clean run (reported: the window buckets differ).
   5h: the observed replica on the bf16 tree cut to ``MS_LAYERS``
   layers (widths whole): one ``none`` split K 4
   server, 4 slots (5e's K 4 server), with ``--trace-ring``,
   ``--timeseries-ring``, ``--device-telemetry`` and
   ``--watchdog-deadline-s 2`` on.  The HBM ledger against
   ``torch.cuda.memory_allocated()`` within 5 %; the compile observatory's
   capture events, one a graph, and the kernel builds found built; tokens/s
   alone (5 + 24) against 5e's K 4 server; a 250-token prompt (a 256-token
   prefill) and a seeded sampled request; ``POST /debug/profile`` (2 s)
   under two request loops, whose trace must name the decode-attention and
   RMSNorm kernels; an injected wedge (one dispatch sleeps 3.5 s: ``/readyz``
   503 within the deadline + 1 s, then 200, one stall, one ``watchdog``
   event of kind ``multistep``, ``on_exit`` a recording callable never
   called); an injected poison prompt (two admission crashes, two 500s, each
   recovery recapturing the graphs with the watchdog disarmed around it,
   then a 422, an innocent request served); the launch identities over all
   that traffic (counters set to 0 just before it; the recaptures' eager
   warm-up runs counted); MFU and HBM-bandwidth shares by tick kind from the
   recorder's ticks and ``/debug/device``, every tick's unclamped ratio
   (the cost model over its wall) at most 1.05; the Chrome trace's
   invariants; the timeseries ring's utilization; then one replay on the
   recaptured graphs bit-equal to eager (``_graph_vs_eager``).
   5i: the KV handoff on the bf16 tree: a ``--fleet-role prefill`` and a
   ``--fleet-role decode`` server (``none``, split K 1, 4 slots, the prefix
   cache at chunks of 256 with 1024 MB) on the one weight tree, over HTTP.
   A 600-token prompt exported cold (the exporter prefills; 2 chunks,
   256 MiB) and warm (the same bytes), imported (512 tokens), its chunks
   read back bit-equal to the exporter's; 16 greedy tokens on the importer
   bit-equal to the exporter's own cache-hit serve; a corrupt blob 400, a
   blob of chunks of 128 tokens 409; the ``kv-import`` tick on
   ``/debug/trace``; then the imported chunks evicted by four other prompts
   and the prompt served cold on the importer: agreement reported, and the
   recompute's time beside the handoff's (export, serialize, wire,
   deserialize, import ms); launch identities over the served traffic.
   5j: snapshot and attach on the ``int8`` tree: a snapshot written under
   ``build/`` (deleted after; the free disk checked first, depth cut only
   if it cannot hold the tree), a ``--warm-pool`` server (split K 4, 4
   slots, chunks of 256) prewarmed from it: ``/readyz`` 503 ``warm-pool``,
   generate 503 ``warm_pool_empty``; ``POST /admin/attach`` restores it
   (``restored`` true, graphs captured after the restore) and one greedy
   request is bit-equal to the same tree served directly; a second attach
   is a no-op; a flipped byte fails the restore typed (``SnapshotError``),
   and on a one-layer full-width artifact an attach of a snapshot with a
   flipped byte loads cold, bakes again and serves.  The snapshot's GiB,
   write s, restore s and GB/s, capture s and attach wall beside the cold
   path of the same run (the quantize from the bf16 draw, then the direct
   server's start); launch identities over the attached replica's request.
   5k: the 7B rehearsal, the port's ``scripts/gen_7b_checkpoint.py`` and
   ``scripts/rehearse_7b_load.py``: before the quantize, the bf16 draw
   (all 32 layers) written through the generator's writer under ``build/``
   (the free disk checked first; the bytes and the write's seconds); after
   5j, ``rehearse`` on it: the loader's streamed int8 load (each matrix
   quantized on the card as it arrives), its seconds, stages and read GB/s,
   the card's resident and peak memory above what the phase held, a
   16-token prefill and 8 greedy decode steps at window 512 (flash, RMSNorm
   and the bf16-window decode kernel, counted); every loaded leaf bit-equal
   to phase 5's ``quantize_llama`` tree and the same chain on that tree
   giving the same tokens, its logits within REHEARSAL_TOL; the artifact
   deleted.  The phase's wall beside REHEARSAL_BUDGET_S.
6. Serving BERT-base at full width (12 layers, random weights from a
   seed) over ``/v2/models/{name}/infer``: a native artifact written by
   the port's writer, loaded with quantize none (bf16, erf GELU) and int8
   (int8 GEMMs, tanh GELU), each behind ``build_server``: 64 single
   requests 32 at a time, one 32 x 128 client batch and one 600-token
   request (a 400).  Every logit must agree with an in-process classify
   through the plain attention (BERT_TOL), flash launches must equal 12 x
   the engine's batch dispatches, and ``/metrics`` must count the 200s and
   the 400.  Prints B32/S128 batch latency p50/p99, requests/s, peak memory
   and the device busy share.
7. The V2 flavors, each loaded by the port's loader and served in process
   behind ``build_server``.  ResNet-50 at full width and depth (25.6M
   parameters, 224 x 224 x 3, 1000 classes; seeded He-normal weights and
   random folded batch norms) written as a native artifact and loaded
   through an ``s3://`` URI with ``TPUMLOPS_ARTIFACT_MIRROR`` set to the
   directory (the loader's serving-type cast must not reach it: the tree
   it holds on the card is f32): a B2 request over
   ``/v2/models/{name}/infer`` and a B1 ``data.tensor`` request over
   ``/api/v1.0/predictions``, both against the same forward in f64 on the
   card (RESNET_TOL of the largest logit; top-1 equal but at a near tie,
   RESNET_GAP), with their walls; the engine's batch latency at B 1, 8
   and 32 (p50, p99, images/s, the device idle share) and the peak
   memory.  An xgboost JSON forest (200 trees of depth 6 on 32 features,
   ``binary:logistic``, from a seed) written with ``save_xgboost_model``:
   it must take the product form, which at B 256 (rows on a split and a
   NaN row among them) must equal the gather form on the card within
   XGB_TOL and both a numpy traversal on the host within XGB_HOST_TOL;
   each form's device ms at B 256, and the served p50 of a V2 request.
   An iris logistic regression (3 classes, 4 features; an object with
   ``coef_``, ``intercept_`` and ``predict_proba``, as the card's machine
   has no sklearn) from a ``model.pkl``: V2 infer (B150 and 16 singles)
   and the Seldon route with ``data.ndarray``, class ids equal to numpy's;
   three feedback rewards (1, -0.5, 2) must show on ``/metrics`` as
   ``tpumlops_feedback_reward_total`` 2.5 and three requests under
   ``service="feedback"``, with the predictions and latency counts
   unchanged.  Prints the phase's wall on a line of its own.
8. A served replica at ``--mesh-shape {"dp": 2, "tp": 2}``: Llama-2-7B's
   widths (H 4096, 32 heads and 32 KV heads, MLP 11008, vocab 32000) cut
   to MESH_LAYERS layers for the time limit, random bf16 weights from a
   seeded generator written once as a native artifact under ``build/``
   (deleted after).  Each unit starts as its pod would: the command,
   arguments and environment of the pod the operator builds for an
   ``h100-4`` CR with the phase's options (``python -m
   <port>.server.launch``, the unit launcher), plus the flags a CR cannot
   state (a local port, ``--drain-s 0``, ``--max-slots``) and the
   launcher's ``--ranks-share-card`` (printed: the four ranks share the
   one card).  The launcher starts the four rank processes, each loading
   its block through the loader; the backend is gloo
   (``parallel.distributed.choose_backend``: four ranks, one card), read
   from the leader's log; the launcher's seconds from its start to the
   leader serving are printed.  Traffic over ``/generate``: a
   request that puts a two-chunk prefix in the radix cache, then five
   concurrent greedy requests of 32 tokens (two cold, two seeded from the
   cached prefix, one repeating pattern the n-gram drafter proposes from).
   At ``--dtype float32`` every request's tokens must equal a tp-1, dp-1
   engine's in this process on the same artifact and options (a differing
   token prints its position and that engine's top-2 logit margin); then
   at bf16 the agreement is reported, not asserted.  Every request
   completes, SIGTERM to the launcher ends every rank with 0 and the
   launcher with 0, every rank
   launched the same kernels (decode attention, its verify instance,
   RMSNorm and flash attention each more than once), the seed, verify
   and decode ops all ran, and each rank's peak allocation (the load
   included) and reserve stay within MESH_PEAK_SLACK and
   MESH_RESERVED_SLACK of its HBM ledger.  Prints, per rank, its decode/verify/chunk op
   walls, its measured collective host seconds, its HBM ledger against
   ``torch.cuda.memory_allocated()``, ``max_memory_allocated()`` and
   ``memory_reserved()`` and its launches (each rank's
   ``TPUMLOPS_RANK_REPORT_DIR`` report), and the leader's analytic
   collective seconds (``tpumlops_engine_collective_seconds``, NVLink
   rate); last a one-rank ``nccl`` group's ``all_reduce`` in a process of
   its own (a world of two or more NCCL ranks needs two cards).  The
   phase's wall beside MESH_BUDGET_S.
8b. ``{"sp": 2, "tp": 2}`` on phase 8's artifact (the ring prefill, a
   sharded snapshot baked and restored; the restored unit at
   ``--decode-steps 4``) and 8c, the V2 path and the warm pool across
   ranks: see ``phase_serve_mesh_sp`` and ``phase_serve_mesh_v2``.
8d. The port's shipped ``deploy/examples/llama-7b-tp4.yaml`` through its
   ``h100-4`` manifest: three units of four ranks side by side on phase
   8's artifact in f32, its split engine (K 4, packed chunks of 512, the
   prefix cache) and the same with ``unifiedStep`` (a super-step 512 wide),
   both over an f32 KV cache with greedy tokens equal to a one-rank engine
   whose program is captured, and the CR's int8kv as shipped (its tokens'
   agreement and int8 codes against one rank reported); the uncaptured
   program on every rank (see ``phase_serve_mesh_tp4``).
8e. The port's ``scripts/rehearse_tp8_dryrun.py`` on phase 8's artifact:
   eight ranks from the launcher's rank plan on the one card (gloo), each
   loading its blocks at ``{"tp": 8}`` int8 in bf16 and checking every int8
   leaf is its block of the whole leaf quantized, one 16-token prefill a
   rank; every rank's logits equal and within TP8_TOL of a one-rank int8
   load of the same artifact; each rank's RMSNorm and flash launches (see
   ``phase_tp8_dryrun``).  The phase's wall beside TP8_BUDGET_S.
9. The control plane's canary: BERT-base v1 -> v2 promoted in 10% steps
   by the port's ``OperatorRuntime`` through the port's router, each
   version a server process of the operator's ``backend: cuda`` manifest.
9b. The control plane's judgment on a shared warm pool (sharing phase 9's
   router build): four Llama models at Llama-2-7B's widths cut to
   MESH_LAYERS layers (bf16 artifacts of seeds 11-14, served f32) on three
   ``--warm-pool 1`` server processes behind the router in
   model-multiplexing mode, r1's leg through a ``ChaosProxy``; four CRs
   with ``spec.multiplex``, ``spec.slo`` and ``spec.anomaly`` in the port's
   ``OperatorRuntime``: parked requests attached and answered with a
   direct f32 engine's tokens, the straggler r1 flagged from the router's
   legs, a replace journaled, SLO records recomputed, a suggested plan
   equal to a re-plan with the detected H100 peaks, RMSNorm / flash /
   decode launches on every replica, and ``python -m <port>.operator
   --leader-elect`` taking its Lease and stopping on SIGTERM; before the
   teardown the port's ``scripts/plan.py`` on the router's journey export
   (a file) byte for byte the planner's plan, and ``scripts/stitch_trace.py``
   on the router and the replicas (each with a flight recorder of
   JUDGE_TRACE_RING) writing Chrome trace JSON whose router track and a
   replica's hold the export's request ids (see
   ``phase_control_plane_judgment``).  The phase's wall beside
   JUDGE_BUDGET_S.

The line before the last is the ``{"kernels": [...]}`` record; the last
is ``{"ok": true, "device": {...}}``.  Details, and the server
subprocess's log, go to ``OUT_DIR``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch"
JAX_PKG = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu"
OUT_DIR = ROOT / "chiprun_out"  # run outputs, ignored by git

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12          # H100 SXM, f32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12 # H100 SXM, dense bf16 on the tensor cores
DA_TOL = 1e-4              # decode attention, absolute and relative, f32
# flash attention against its plain version (computed in f32 from the same
# inputs), absolute and relative: f32 I/O, and bf16 I/O, whose output is
# one bf16 rounding (2^-8 relative) of the kernel's f32 result.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

DETAIL: dict = {}
# Past this many seconds the run dumps every thread's stack to stderr and
# exits non-zero: a hang shows where it was, inside a 1200 s limit.
SMOKE_LIMIT_S = 1140
_T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def stage(name: str) -> None:
    """The phase about to run and the seconds since the start, on stderr
    (whose end is what a caller that cuts the run keeps)."""
    print(f"chip_smoke: +{time.perf_counter() - _T_START:.1f} s {name}",
          file=sys.stderr, flush=True)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profiled(hold):
    """A started device-activity profiler (``torch.profiler``), started
    inside ``hold()`` (a served engine's ``between_ticks``: the profiler's
    start or stop beside a CUDA graph replay on the scheduler thread
    deadlocked)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    with hold():
        prof.start()
    return prof


def _stop_profiled(prof, hold) -> None:
    import torch

    with hold():
        torch.cuda.synchronize()
        prof.stop()


def profile_device(fn, iters: int = 20, launches: dict | None = None,
                   hold=contextlib.nullcontext) -> tuple[dict[str, float], float]:
    """Device milliseconds by kernel name over ``iters`` calls of ``fn``
    (torch.profiler, device activity only, so the host is not slowed by
    op tracing), and the wall milliseconds of the profiled calls (the
    profiler's start and stop outside it).  ``launches``,
    when given, receives the launches the profiler saw of each name.
    ``hold``: the engine whose scheduler ``fn`` drives, if any, holds
    between two ticks while the profiler starts and stops."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof = _profiled(hold)
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        _stop_profiled(prof, hold)
    by_kernel: dict[str, float] = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us:
            by_kernel[evt.key] = dev_us / 1e3
            if launches is not None:
                launches[evt.key] = evt.count
    return by_kernel, wall_ms


def busy_window(fn, device_type=None, hold=contextlib.nullcontext) -> dict:
    """One call of ``fn`` under the profiler (device activity only): its
    wall inside the profiled window, the union of the device intervals the
    profiler saw in that window (kernels, copies and sets; overlapping
    ones count once), their plain sum, and the idle share 1 - union /
    wall.  ``device_type``: whose events count (the card's by default);
    ``hold`` as for :func:`profile_device`."""
    import torch
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if device_type is None else device_type
    torch.cuda.synchronize()
    prof = _profiled(hold)
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        _stop_profiled(prof, hold)
    spans, by_kernel = [], {}
    for evt in prof.events():
        if evt.device_type != want or getattr(evt, "is_user_annotation", False):
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if end > start:
            spans.append((start, end))
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + (end - start) / 1e3
    union_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            union_us += end - max(start, reach)
            reach = end
    busy_ms = union_us / 1e3
    # A union past the wall would mean the two clocks disagree: no share then.
    share = 1 - busy_ms / wall_ms if busy_ms <= wall_ms else None
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "sum_ms": sum(by_kernel.values()),
            "events": len(spans), "idle_share": share,
            "top": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]}


def kernel_device_ms(fn, needle: str, iters: int = 50) -> float | None:
    """Mean device ms per call of the kernels whose name holds ``needle``,
    each launched once a call: the sum over those names of their mean time
    a launch the profiler saw (a window that misses launches, as one now
    and then does, must not read as a faster kernel); None when the
    profiler saw no device time for them."""
    for _ in range(2):  # a profiler window now and then comes back empty
        launches: dict[str, int] = {}
        by_kernel, _ = profile_device(fn, iters, launches)
        per_launch = [v / launches[k] for k, v in by_kernel.items() if needle in k]
        if per_launch:
            return sum(per_launch)
    return None


def device_ms_by_kernel(fn, needle: str, iters: int = 20) -> dict[str, float]:
    """Mean device ms a launch of each kernel whose name holds ``needle``
    (the short name before its argument list), as ``kernel_device_ms``
    sums them."""
    out: dict[str, float] = {}
    for _ in range(2):  # a profiler window now and then comes back empty
        launches: dict[str, int] = {}
        by_kernel, _ = profile_device(fn, iters, launches)
        out = {re.sub(r"^.*::|\(.*$", "", k): v / launches[k]
               for k, v in by_kernel.items() if needle in k and launches.get(k)}
        if out:
            break
    return out


def device_ms_per_call(fn, iters: int = 50) -> float | None:
    """Mean device ms per call of ``fn``, all the kernels it launches
    together (a library call may launch several); None when the profiler
    saw no device time."""
    for _ in range(2):  # a profiler window now and then comes back empty
        by_kernel, _ = profile_device(fn, iters)
        total = sum(by_kernel.values())
        if total:
            return total / iters
    return None


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 1-2
# ---------------------------------------------------------------------------


def chunk_occupancy() -> dict[str, int]:
    """Blocks an SM holds of the two chunk-against-window kernels at D =
    128 (the CUDA occupancy API on the built libraries), by cache."""
    from importlib import import_module

    build = import_module(f"{PKG}.ops._build")
    verify = build.load("decode_attention").verify_attention_occupancy
    ragged = build.load("flash_attention").flash_ragged_occupancy
    return {"verify_int8": verify(0), "verify_bf16": verify(1),
            "ragged_int8": ragged(1), "ragged_bf16": ragged(0)}


def phase_device() -> str:
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(out)
    DETAIL["nvidia_smi"] = out
    DETAIL["torch"] = torch.__version__
    DETAIL["cuda"] = torch.version.cuda
    return out


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel template instance (``bf16``/``f32``
    /``i8`` for the type, the integer arguments in order)."""
    m = re.search(r"(?<=\d)([a-z]+(?:_[a-z]+)*_kernel(?:_[a-z0-9]+)?)I"
                  r"((?:13__nv_bfloat16|S\d*_|L[ib]-?\d+E|f|a)+)E", mangled)
    if not m:
        return mangled
    args = []
    for a in re.findall(r"13__nv_bfloat16|S\d*_|L[ib]-?\d+E|f|a", m.group(2)):
        if a.startswith("S"):  # a repeated type
            args.append(next(x for x in reversed(args) if x in ("bf16", "f32")))
        else:
            args.append("bf16" if a.startswith("13") else "f32" if a == "f"
                        else "i8" if a == "a" else re.sub(r"\D", "", a))
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_summary(report: str) -> dict[str, dict]:
    """Registers, static shared memory and spills of each kernel instance
    in an ``nvcc -Xptxas -v`` report."""
    out: dict[str, dict] = {}
    name = None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                out[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                sm = re.search(r"(\d+) bytes smem", ln)
                out[name].update(registers=int(m[1]), static_smem=int(sm[1]) if sm else 0)
    return out


def phase_build() -> None:
    from importlib import import_module

    build = import_module(f"{PKG}.ops._build")
    t0 = time.perf_counter()
    per = build.build()
    wall = time.perf_counter() - t0
    log(f"build: {wall:.1f} s wall, per source {json.dumps({k: round(v, 1) for k, v in per.items()})}")
    summary = {}
    for name, report in build.ptxas_reports.items():
        summary[name] = ptxas_summary(report)
        for kernel, r in summary[name].items():
            log(f"  {kernel}: {r.get('registers')} registers, {r.get('static_smem')} bytes "
                f"static smem, spills {r.get('spill_stores')}/{r.get('spill_loads')} bytes")
    DETAIL["build_s"] = wall
    DETAIL["ptxas"] = build.ptxas_reports
    DETAIL["ptxas_summary"] = summary


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _da_inputs(B, NKV, G, D, T, layers, dtype, gen, row=None, dense=False):
    """Decode-attention inputs whose K/V windows are strided views of a
    head-major cache buffer [layers, B, NKV, T, D] (layer 0 is checked).
    ``row``: the cache rows are ``[..., :D]`` slices of rows ``row`` wide.
    ``dense``: the cache is of q's type (the bf16 ragged cache), with no
    scales (ks and vs None)."""
    import torch

    dev = "cuda"
    shape = (layers, B, NKV, T, row or D)
    if dense:
        k8, v8 = (torch.randn(shape, generator=gen, device=dev).to(dtype)[..., :D]
                  for _ in range(2))
        ks = vs = None
    else:
        k8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)[..., :D]
        v8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)[..., :D]
        ks = torch.rand((layers, B, NKV, T, 1), generator=gen, device=dev) * 0.01 + 1e-3
        vs = torch.rand((layers, B, NKV, T, 1), generator=gen, device=dev) * 0.01 + 1e-3
    q = torch.randn((B, NKV, G, D), generator=gen, device=dev).to(dtype)
    k_self = torch.randn((B, NKV, 1, D), generator=gen, device=dev).to(dtype)
    v_self = torch.randn((B, NKV, 1, D), generator=gen, device=dev).to(dtype)
    return q, k8, ks, v8, vs, k_self, v_self


def _mask(lengths, W):
    import torch

    pos = torch.arange(W, device="cuda")
    valid = pos[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]
    return torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, :]


def _da_bytes_flops(B, NKV, G, D, W, itemsize, dense=False):
    nbytes = (B * NKV * G * D * itemsize          # q
              + 2 * B * NKV * W * D * (itemsize if dense else 1)  # k, v
              + (0 if dense else 2 * B * NKV * W * 4)             # ks, vs
              + 2 * B * NKV * D * itemsize        # k_self, v_self
              + B * W * 4                         # mask
              + B * NKV * G * D * 4)              # out
    flops = B * NKV * G * (4 * W * D + 6 * W + 4 * D)
    return nbytes, flops


def _da_check(da, inputs, W, lengths, what, fn=None) -> float:
    """The kernel on layer 0's window [:W] of ``inputs`` against its plain
    version (DA_TOL absolute + relative); a length-0 row must be exactly
    v_self.  Returns the max abs error."""
    import torch

    q, k8, ks, v8, vs, k_self, v_self = inputs
    if ks is None:  # the dense window of q's type
        args = (q, k8[0, :, :, :W], v8[0, :, :, :W], k_self, v_self, _mask(lengths, W))
        out = (fn or da.decode_attention_dense)(*args)
        ref = da.decode_attention_dense_reference(*args)
    else:
        args = (q, k8[0, :, :, :W], ks[0, :, :, :W], v8[0, :, :, :W], vs[0, :, :, :W],
                k_self, v_self, _mask(lengths, W))
        out = (fn or da.decode_attention)(*args)
        ref = da.decode_attention_reference(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    if not bool(torch.isfinite(out).all()) or bool((err > DA_TOL + DA_TOL * ref.abs()).any()):
        raise AssertionError(f"decode attention disagrees: {what} W={W} lengths={lengths} "
                             f"splits={da.num_splits(q.shape[0], q.shape[1], W)} "
                             f"max_abs_err={float(err.max()):.3e}")
    for i in (i for i, n in enumerate(lengths) if n == 0):
        row = float((out[i] - v_self[i].float()).abs().max())
        if row > DA_TOL:  # a length-0 row attends only itself
            raise AssertionError(f"{what}: length-0 row is not v_self (W={W}): {row}")
    return float(err.max())


def _da_split_checks(da, dense=False) -> dict:
    """The split kernel where it can go wrong: lengths on and beside every
    split boundary, a window that is not a multiple of the split width,
    both load widths, G = 8 and a length-0 row with splits > 1, and a
    split with no position (past W).  ``dense``: the same cases over a
    window of q's type (4-byte rows from 130-wide buffers)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4321)
    D, bf = 128, torch.bfloat16
    narrow = 130 if dense else 132  # a row width whose rows are 4-byte, not 16-byte, aligned
    out = {}

    def run(what, B, NKV, G, W, T, lengths_all, vec, row=None, dtype=bf):
        inputs = _da_inputs(B, NKV, G, D, T, 1, dtype, gen, row=row, dense=dense)
        k8w, v8w = inputs[1][0, :, :, :W], inputs[3][0, :, :, :W]
        if da.load_width(k8w, v8w) != vec:
            raise AssertionError(f"{what}: load width {da.load_width(k8w, v8w)}, expected {vec}")
        worst, n = 0.0, 0
        for i in range(0, len(lengths_all), B):
            lengths = (lengths_all[i:i + B] + [W] * B)[:B]
            worst = max(worst, _da_check(da, inputs, W, lengths, what))
            n += 1
        splits = da.num_splits(B, NKV, W)
        out[what] = {"shape": [B, NKV, G, D, W], "splits": splits,
                     "split_len": da.split_len(W, splits), "vec": vec, "checks": n,
                     "max_abs_err": worst}
        return splits

    def boundaries(B, NKV, W):
        s = da.num_splits(B, NKV, W)
        c = da.split_len(W, s)
        return [0, W, W - 1] + [j * c + o for j in range(1, s) for o in (-1, 0, 1)]

    # Llama-2-7B's decode shape, 16-byte rows of a head-major cache view.
    s = run("boundaries_w768", 4, 32, 1, 768, 1024, boundaries(4, 32, 768), 16)
    if s < 2:
        raise AssertionError(f"W=768 at 4 slots x 32 heads takes {s} split")
    # W not a multiple of the split width, sliced from a wider window.
    run("ragged_w997_of_1000", 4, 32, 1, 997, 1000, boundaries(4, 32, 997), 16)
    run("w97_of_100", 4, 32, 1, 97, 100, [0, 96, 97, 1, 50, 48, 49, 2], 16)
    # 4-byte rows: [..., :128] of a 132-wide (dense: 130-wide) buffer.
    run("vec4_w768", 4, 32, 1, 768, 800, boundaries(4, 32, 768), 4, row=narrow)
    run("vec4_w97_of_100", 4, 32, 1, 97, 100, [0, 96, 97, 1], 4, row=narrow)
    # G = 8 with splits > 1, a length-0 row among them; both load widths.
    for what, row, vec in (("g8_split", None, 16), ("g8_split_vec4", narrow, 4)):
        if run(what, 2, 8, 8, 768, 768, boundaries(2, 8, 768)[:6] + [0, 65], vec,
               row=row, dtype=torch.float32) < 2:
            raise AssertionError(f"{what} took 1 split")
    # The last split owns no position: it must add nothing, and no NaN.
    W = 4225
    s = da.num_splits(1, 1, W)
    if (s - 1) * da.split_len(W, s) < W:
        raise AssertionError(f"W={W} at one (slot, head) has no empty split ({s} splits)")
    run("empty_last_split_w4225", 1, 1, 1, W, W, [W, 0, W - 1, 4160], 16)
    return out


def phase_decode_attention(da, buckets) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    T, D = 4096, 128
    worst = 0.0
    checks = 0
    for (NKV, G) in ((32, 1), (16, 2), (8, 4), (8, 8)):
        for B in (1, 4):
            inputs = _da_inputs(B, NKV, G, D, T, 1, torch.float32, gen)
            fn = da.decode_attention_vpu if G == 1 else da.decode_attention_batched
            for wi, W in enumerate(buckets):
                if B == 1:
                    lengths = [(0, W // 2, W)[wi % 3]]
                else:
                    lengths = [0, W // 2, W, max(W - 1, 0)]
                worst = max(worst, _da_check(da, inputs, W, lengths,
                                             f"B={B} NKV={NKV} G={G}", fn=fn))
                checks += 1
    # bf16 inputs (the model's type) at the main path's shapes.
    inputs = _da_inputs(4, 32, 1, D, T, 1, torch.bfloat16, gen)
    for W in buckets:
        worst = max(worst, _da_check(da, inputs, W, [0, W // 2, W, W - 1], "bf16 q",
                                     fn=da.decode_attention_vpu))
        checks += 1
    split_checks = _da_split_checks(da)
    for r in split_checks.values():
        worst = max(worst, r["max_abs_err"])
        checks += r["checks"]
    log(f"decode attention: {checks} checks over windows {buckets[0]}..{buckets[-1]}, "
        f"G in (1, 2, 4, 8), max_abs_err {worst:.3e} (tol {DA_TOL} abs + {DA_TOL} rel)")
    log(f"  split checks (shape [B, NKV, G, D, W], splits, load width): "
        + "; ".join(f"{k} {v['shape']} {v['splits']}x{v['split_len']} vec{v['vec']}"
                    for k, v in split_checks.items()))

    # Timing at the main path's widest window: B=4 slots, 32 heads, G=1,
    # W=768, bf16 queries; the window rotates over 8 layers of one cache
    # (200 MB > the 50 MB L2) as consecutive layers do.
    B, NKV, G, W, layers = 4, 32, 1, 768, 8
    q, k8, ks, v8, vs, k_self, v_self = _da_inputs(B, NKV, G, D, T, layers, torch.bfloat16, gen)
    mask = _mask([W // 4, W // 2, 3 * W // 4, W], W)
    views = [(q, k8[l, :, :, :W], ks[l, :, :, :W], v8[l, :, :, :W], vs[l, :, :, :W],
              k_self, v_self, mask) for l in range(layers)]
    it = {"i": 0}

    def kernel():
        it["i"] += 1
        return da.decode_attention_vpu(*views[it["i"] % layers])

    def plain():
        it["i"] += 1
        return da.decode_attention_reference(*views[it["i"] % layers])

    splits = da.num_splits(B, NKV, W)
    ms = cuda_time_ms(kernel, iters=200)
    device_ms = kernel_device_ms(kernel, "decode_attention_kernel")
    plain_ms = cuda_time_ms(plain, iters=50)
    nbytes, flops = _da_bytes_flops(B, NKV, G, D, W, 2)
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
    def rotating(Wl):
        """The kernel over layer after layer of the cache at window Wl."""
        vws = [(q, k8[l, :, :, :Wl], ks[l, :, :, :Wl], v8[l, :, :, :Wl], vs[l, :, :, :Wl],
                k_self, v_self, _mask([Wl] * B, Wl)) for l in range(layers)]
        j = {"i": 0}

        def kl():
            j["i"] += 1
            return da.decode_attention_vpu(*vws[j["i"] % layers])

        return kl

    ladder = {}
    for Wl in (16, 48, 192, 768, 1536, 4096):
        kl = rotating(Wl)
        nb, fl = _da_bytes_flops(B, NKV, G, D, Wl, 2)
        ladder[Wl] = {"ms": cuda_time_ms(kl, iters=100),
                      "device_ms": kernel_device_ms(kl, "decode_attention_kernel"),
                      "bound_ms": bound(nb, fl, F32_FLOPS)[0],
                      "splits": da.num_splits(B, NKV, Wl)}
    # The split count: num_splits fills one wave of BLOCKS_PER_SM blocks an
    # SM; the same windows with the constant moved give fewer and more.
    sweep = {}
    keep = da.BLOCKS_PER_SM
    try:
        for bps in (2, 3, 4, 5, 6, 8):
            da.BLOCKS_PER_SM = bps
            for Wl in (768, 4096):
                sweep.setdefault(Wl, {})[da.num_splits(B, NKV, Wl)] = kernel_device_ms(
                    rotating(Wl), "decode_attention_kernel")
    finally:
        da.BLOCKS_PER_SM = keep
    log(f"decode attention B=4 NKV=32 G=1 D=128 W=768 ({splits} splits): kernel {ms:.4f} "
        f"ms a call (device time alone {device_ms} ms), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    log("  window ladder (W: ms, device ms, bound ms, splits): " + json.dumps(
        {k: [round(v["ms"], 4), v["device_ms"] and round(v["device_ms"], 4),
             round(v["bound_ms"], 4), v["splits"]] for k, v in ladder.items()}))
    log(f"  split sweep (W: {{splits: device ms}}; num_splits takes {splits}): "
        + json.dumps(sweep))
    DETAIL["decode_attention"] = {"checks": checks, "max_abs_err": worst, "ms": ms,
                                  "device_ms": device_ms, "splits": splits,
                                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "ladder": ladder, "split_sweep": sweep,
                                  "shape": [B, NKV, G, D, W],
                                  "split_checks": split_checks}
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "device_ms": device_ms,
            "splits": splits}


def phase_decode_attention_dense(da, buckets) -> dict:
    """The dense-window instance (bf16 cache, no scales) against its plain
    version: the window-bucket ladder at G = 1, 2, 4, 8, the split edges
    of the int8 checks, and its time at Llama-2-7B's decode shape beside
    its bound, the plain chain and SDPA over the same window."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5678)
    T, D, bf = 4096, 128, torch.bfloat16
    worst, checks = 0.0, 0
    for (NKV, G) in ((32, 1), (16, 2), (8, 4), (8, 8)):
        for B in (1, 4):
            inputs = _da_inputs(B, NKV, G, D, T, 1, bf, gen, dense=True)
            for wi, W in enumerate(buckets):
                lengths = [(0, W // 2, W)[wi % 3]] if B == 1 else [0, W // 2, W, max(W - 1, 0)]
                worst = max(worst, _da_check(da, inputs, W, lengths,
                                             f"dense B={B} NKV={NKV} G={G}"))
                checks += 1
            del inputs
    split_checks = _da_split_checks(da, dense=True)
    for r in split_checks.values():
        worst = max(worst, r["max_abs_err"])
        checks += r["checks"]
    log(f"decode attention, bf16 window: {checks} checks over windows {buckets[0]}.."
        f"{buckets[-1]}, G in (1, 2, 4, 8), max_abs_err {worst:.3e} (tol {DA_TOL} abs + "
        f"{DA_TOL} rel)")
    log(f"  split checks (shape [B, NKV, G, D, W], splits, load width): "
        + "; ".join(f"{k} {v['shape']} {v['splits']}x{v['split_len']} vec{v['vec']}"
                    for k, v in split_checks.items()))

    # Llama-2-7B's decode shape, the window rotating over 8 layers of one
    # bf16 cache (400 MB > the 50 MB L2) as consecutive layers do.
    B, NKV, G, W, layers = 4, 32, 1, 768, 8
    q, k, _, v, _, k_self, v_self = _da_inputs(B, NKV, G, D, T, layers, bf, gen, dense=True)
    lengths = [W // 4, W // 2, 3 * W // 4, W]
    mask = _mask(lengths, W)
    views = [(q, k[l, :, :, :W], v[l, :, :, :W], k_self, v_self, mask) for l in range(layers)]
    # SDPA over the same window with the self row joined outside the timed
    # region: q [B, H, 1, D], K/V [B, NKV, W + 1, D], a boolean mask.
    valid = torch.cat([mask[:, 0] == 0, torch.ones((B, 1), dtype=torch.bool, device="cuda")],
                      dim=1)[:, None, None, :]
    lib_views = [(q.reshape(B, NKV * G, 1, D), torch.cat([k[l, :, :, :W], k_self], dim=2),
                  torch.cat([v[l, :, :, :W], v_self], dim=2)) for l in range(layers)]
    it = {"i": 0}

    def rot(f, vs):
        def call():
            it["i"] += 1
            return f(*vs[it["i"] % layers])
        return call

    kernel = rot(da.decode_attention_dense, views)
    plain = rot(da.decode_attention_dense_reference, views)
    lib = rot(lambda qq, kk, vv: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=valid, **({"enable_gqa": True} if G > 1 else {})), lib_views)
    splits = da.num_splits(B, NKV, W)
    ms = cuda_time_ms(kernel, iters=200)
    device_ms = kernel_device_ms(kernel, "decode_attention_kernel")
    plain_ms = cuda_time_ms(plain, iters=50)
    library_ms = cuda_time_ms(lib, iters=200)
    library_device_ms = device_ms_per_call(lib)
    nbytes, flops = _da_bytes_flops(B, NKV, G, D, W, 2, dense=True)
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
    log(f"decode attention, bf16 window B=4 NKV=32 G=1 D=128 W=768 ({splits} splits): "
        f"kernel {ms:.4f} ms a call (device {device_ms} ms), plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms (device {library_device_ms} ms), bound {bound_ms:.4f} ms "
        f"({bound_by})")
    res = {"checks": checks, "max_abs_err": worst, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_device_ms": library_device_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "splits": splits, "shape": [B, NKV, G, D, W],
           "split_checks": split_checks}
    DETAIL["decode_attention_dense"] = res
    return {k: res[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                                "library_device_ms", "bound_ms", "bound_by", "shape")}


def _va_inputs(B, NKV, S, G, D, T, layers, dtype, gen, dense, near_clip=False, row=None):
    """Verify-attention inputs: the window as strided views of a head-major
    cache buffer [layers, B, NKV, T, D] (int8 with scales, or q's type),
    q [B, NKV, S*G, D], the chunk's exact K/V [B, NKV, S, D] and, for the
    int8 window, the chunk through the cache's quantize round-trip.
    ``near_clip``: every chunk row holds one +-8 outlier, so its other
    elements land on few int8 steps and its outlier on +-127.  ``row``:
    the cache rows are ``[..., :D]`` slices of rows ``row`` wide."""
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    q, k, ks, v, vs, _, _ = _da_inputs(B, NKV, S * G, D, T, layers, dtype, gen, row=row,
                                       dense=dense)
    kc = torch.randn((B, NKV, S, D), generator=gen, device="cuda")
    vc = torch.randn((B, NKV, S, D), generator=gen, device="cuda")
    if near_clip:
        kc[..., 3] = 8.0 * torch.sign(kc[..., 3])
        vc[..., 5] = -8.0
    kc, vc = kc.to(dtype), vc.to(dtype)
    rt = None if dense else (*llama._quant_kv(kc), *llama._quant_kv(vc))
    return q, k, ks, v, vs, kc, vc, rt


def _va_args(inputs, W, lengths, layer=0):
    q, k, ks, v, vs, kc, vc, rt = inputs
    mask = _mask(lengths, W)
    if ks is None:
        return (q, k[layer, :, :, :W], v[layer, :, :, :W], kc, vc, mask)
    k8c, ksc, v8c, vsc = rt
    return (q, k[layer, :, :, :W], ks[layer, :, :, :W], v[layer, :, :, :W], vs[layer, :, :, :W],
            kc, vc, k8c, ksc, v8c, vsc, mask)


def _va_check(da, inputs, W, lengths, what, counts=None) -> float:
    """The verify kernel on layer 0's window [:W] against its plain version
    (DA_TOL absolute + relative, as the decode checks, bf16 q included);
    with ``counts`` (a slot's live chunk positions) both take it and the
    kernel's parked rows must be exactly zero.  Returns the max abs error."""
    import torch

    args = _va_args(inputs, W, lengths)
    dense = inputs[2] is None
    out = (da.verify_attention_dense if dense else da.verify_attention)(*args, counts=counts)
    ref = (da.verify_attention_dense_reference if dense else da.verify_attention_reference)(
        *args, counts=counts)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    q = inputs[0]
    if not bool(torch.isfinite(out).all()) or bool((err > DA_TOL + DA_TOL * ref.abs()).any()):
        raise AssertionError(
            f"verify attention disagrees: {what} W={W} lengths={lengths} rows={q.shape[2]} "
            f"counts={None if counts is None else counts.tolist()} "
            f"max_abs_err={float(err.max()):.3e}")
    if counts is not None:
        g = q.shape[2] // inputs[5].shape[2]
        parked = (torch.arange(q.shape[2], device="cuda") // g)[None, :] >= counts[:, None]
        if bool(out.transpose(1, 2)[parked].any()):
            raise AssertionError(f"verify attention: parked rows not zero ({what}, counts "
                                 f"{counts.tolist()})")
    return float(err.max())


def _va_bytes_flops(B, NKV, S, G, D, W, itemsize, dense, counts=None):
    """Bytes (each input read once, the output written once; the pieces'
    partials are the kernel's overhead, not the function's) and the
    tensor-core operations of the bf16 verify: each query row's W window
    keys and its causal chunk keys (j <= s), Q . K once and P . V twice
    (its f32 probabilities as a hi/lo pair of bf16 products, the least the
    card's tensor cores take for them), 2 * D flops a product, all at the
    bf16 tensor-core peak.  ``counts``: only each slot's live positions
    count (their q rows, chunk K/V and its round-trip, and their chunk
    keys), the parked ones unread and their output rows still written."""
    r = S * G
    live = [S] * B if counts is None else [min(S, int(c)) for c in counts]
    nbytes = (NKV * sum(live) * G * D * itemsize               # q
              + 2 * B * NKV * W * D * (itemsize if dense else 1)  # window K, V
              + (0 if dense else 2 * B * NKV * W * 4)          # ks, vs
              + 2 * NKV * sum(live) * D * itemsize             # the chunk's K, V
              + (0 if dense else 2 * NKV * sum(live) * (D + 4))  # its round-trip
              + B * W * 4                                      # mask
              + B * NKV * r * D * 4)                           # out
    pairs = NKV * sum(c * G * W + G * c * (c + 1) // 2 for c in live)
    return nbytes, 3 * 2 * D * pairs


def _va_counts(da, gen) -> dict:
    """The live count a slot (``counts``, the unified super-step's): at S =
    256, G 1, NKV 32, B 4, the kernel with counts 1 / 5 / 256 / 0 against
    its plain version with them (both windows, bf16 and f32 q, W 768 and
    4096; parked rows exactly zero), then its device ms at W 768 under the
    row mixes of a decode-only tick (counts 1 x 4) and of a mixed tick (1,
    1, 5, 256), with and without counts, beside the bound of each."""
    import torch

    D, B, NKV, S = 128, 4, 32, 256
    counts = torch.tensor([1, 5, 256, 0], dtype=torch.int32, device="cuda")
    worst, checks = 0.0, 0
    for dense in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            inputs = _va_inputs(B, NKV, S, 1, D, 4096, 1, dtype, gen, dense)
            for W in (768, 4096):
                what = f"{'dense' if dense else 'int8'} S=256 {str(dtype).replace('torch.', '')}"
                worst = max(worst, _va_check(da, inputs, W, [0, 1, W - 1, W // 2], what,
                                             counts=counts))
                checks += 1
            del inputs
    W, layers = 768, 8
    lengths = [W // 4, W // 2, 3 * W // 4, W]
    timing = {}
    for dense in (False, True):
        inputs = _va_inputs(B, NKV, S, 1, D, 4096, layers, torch.bfloat16, gen, dense)
        views = [_va_args(inputs, W, lengths, layer=l) for l in range(layers)]
        fn = da.verify_attention_dense if dense else da.verify_attention
        for mix, cs in (("decode", (1, 1, 1, 1)), ("mixed", (1, 1, 5, 256))):
            ct = torch.tensor(cs, dtype=torch.int32, device="cuda")
            it = {"i": 0}

            def call(c=ct):
                it["i"] += 1
                return fn(*views[it["i"] % layers], counts=c)

            def call_all():
                it["i"] += 1
                return fn(*views[it["i"] % layers])

            nbytes, flops = _va_bytes_flops(B, NKV, S, 1, D, W, 2, dense, counts=cs)
            bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
            timing[f"{'dense' if dense else 'int8'}_{mix}"] = {
                "counts": list(cs), "device_ms": kernel_device_ms(call, "attention_kernel"),
                "device_ms_all_rows": kernel_device_ms(call_all, "attention_kernel"),
                "ms": cuda_time_ms(call, iters=100), "bound_ms": bound_ms,
                "bound_by": bound_by}
        del inputs, views
    log(f"verify attention with counts: {checks} checks at S 256 (counts 1/5/256/0, int8 and "
        f"bf16/f32 windows, W 768 and 4096; parked rows zero), max_abs_err {worst:.3e}; device "
        f"ms at W 768 with counts / all 256 rows / bound: " + json.dumps(
            {k: [r["device_ms"] and round(r["device_ms"], 4),
                 r["device_ms_all_rows"] and round(r["device_ms_all_rows"], 4),
                 round(r["bound_ms"], 4)] for k, r in timing.items()}))
    return {"checks": checks, "max_abs_err": worst, "timing": timing}


def phase_verify_attention(da) -> dict:
    """The decode kernel's verify chunk instance (both windows) against its
    plain versions: Llama-2-7B's shape (NKV 32, D 128, G 1) and grouped
    heads on a synthetic NKV 8 (G 4, 8), B 4, W 768 and 4096, S 2, 3, 5,
    17, 65, S 128 / 256 / 512 / 1024 at G 1 and S 1024 at G 4 (a super-step
    as wide as a prefill chunk), lengths 0, 1, W - 1 and W / 2 in one
    batch, chunk rows near the int8 clip, bf16 and f32 q; a malformed chunk
    (no position, rows not S x G) raises before a launch; then its time over
    S (2 .. 1024) at W 768 beside the S = 1 decode kernel on the same
    window, the plain version and (dense) SDPA over the window plus the
    chunk with a boolean mask."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(8642)
    D, B = 128, 4
    worst, checks = 0.0, 0
    cases = [(NKV, G, S) for NKV, G in ((32, 1), (8, 4), (8, 8)) for S in (2, 3, 5, 17, 65)]
    cases += [(32, 1, 128), (32, 1, 256)]  # up to the split engine's prefill chunk
    # A super-step as wide as the shipped CRs' prefill chunk of 512, and 1024:
    # the chunk keys past 256 in tiles (f32 q) or 64-key slices (bf16 q).
    cases += [(32, 1, 512), (32, 1, 1024), (8, 4, 1024)]
    for dense in (False, True):
        for NKV, G, S in cases:
            for dtype in (torch.bfloat16, torch.float32):
                inputs = _va_inputs(B, NKV, S, G, D, 4096, 1, dtype, gen, dense,
                                    near_clip=S in (3, 17, 128, 512))
                for W in (768, 4096):
                    what = (f"{'dense' if dense else 'int8'} NKV={NKV} G={G} S={S} "
                            f"{str(dtype).replace('torch.', '')}")
                    worst = max(worst, _va_check(da, inputs, W, [0, 1, W - 1, W // 2], what))
                    checks += 1
                del inputs
    # The kernel's other instances: D = 64 (16 heads over 8 K/V heads) and
    # windows whose rows are 4-byte, not 16-byte, aligned (int8 rows 132
    # bytes and bf16 rows 260 bytes apart: 4-byte copies).
    for dense in (False, True):
        for what, nkv, g, d, row in (("D=64", 8, 2, 64, None),
                                     ("4-byte rows", 32, 1, 128, 130 if dense else 132)):
            inputs = _va_inputs(B, nkv, 5, g, d, 1024, 1, torch.bfloat16, gen, dense, row=row)
            if da.load_width(inputs[1][0], inputs[3][0]) != (4 if row else 16):
                raise AssertionError(f"verify attention {what}: not the load width it checks")
            worst = max(worst, _va_check(da, inputs, 768, [0, 1, 767, 384],
                                         f"{'dense' if dense else 'int8'} {what}"))
            checks += 1
            del inputs
    # A malformed chunk raises before anything launches: no chunk position,
    # and query rows that are not S x G.
    for what, s_q, s_c in (("an empty chunk", 0, 0), ("6 rows for 4 positions", 6, 4)):
        q, k, ks, v, vs, kc, vc, rt = _va_inputs(1, 2, max(s_c, 1), 1, D, 64, 1,
                                                 torch.bfloat16, gen, False)
        q = torch.zeros((1, 2, s_q, D), dtype=torch.bfloat16, device="cuda")
        kc, vc = kc[:, :, :s_c], vc[:, :, :s_c]
        rt = tuple(t[:, :, :s_c] for t in rt)
        before = (da.launches, da.verify_launches)
        try:
            da.verify_attention(*_va_args((q, k, ks, v, vs, kc, vc, rt), 64, [64]))
        except ValueError as e:
            if "chunk position" not in str(e) and "query rows" not in str(e):
                raise
        else:
            raise AssertionError(f"verify attention took {what}")
        if (da.launches, da.verify_launches) != before:
            raise AssertionError(f"a refused verify call ({what}) counted a launch")
    log(f"verify attention: {checks} checks (int8 and bf16/f32 windows, G 1/4/8, S 2..65, "
        f"S 128/256/512/1024 at G 1 and S 1024 at G 4, W 768 and 4096, lengths "
        f"0/1/W-1/W/2, rows near the int8 clip; D 64 and 4-byte-aligned rows at S 5), "
        f"max_abs_err {worst:.3e} (tol {DA_TOL} abs + {DA_TOL} rel); an empty chunk and rows "
        f"that are not S x G raise")

    # Time at Llama-2-7B's shape, the window rotating over 8 layers of one
    # cache (> the 50 MB L2) as consecutive layers do.
    NKV, G, W, layers = 32, 1, 768, 8
    lengths = [W // 4, W // 2, 3 * W // 4, W]
    timing, sweep = {}, {}
    for dense in (False, True):
        tag = "dense" if dense else "int8"
        for S in (2, 3, 5, 17, 65, 128, 256, 512, 1024):
            inputs = _va_inputs(B, NKV, S, G, D, 4096, layers, torch.bfloat16, gen, dense)
            views = [_va_args(inputs, W, lengths, layer=l) for l in range(layers)]
            q, k, ks, v, vs, kc, vc, _ = inputs
            self_views = [
                (q[:, :, :1], k[l, :, :, :W], v[l, :, :, :W], kc[:, :, :1], vc[:, :, :1],
                 views[l][-1]) if dense else
                (q[:, :, :1], k[l, :, :, :W], ks[l, :, :, :W], v[l, :, :, :W], vs[l, :, :, :W],
                 kc[:, :, :1], vc[:, :, :1], views[l][-1]) for l in range(layers)]
            it = {"i": 0}

            def rot(f, vws):
                def call():
                    it["i"] += 1
                    return f(*vws[it["i"] % layers])
                return call

            kern = rot(da.verify_attention_dense if dense else da.verify_attention, views)
            plain = rot(da.verify_attention_dense_reference if dense
                        else da.verify_attention_reference, views)
            one = rot(da.decode_attention_dense if dense else da.decode_attention_vpu, self_views)
            nbytes, flops = _va_bytes_flops(B, NKV, S, G, D, W, 2, dense)
            bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
            row = {"ms": cuda_time_ms(kern, iters=100),
                   "device_ms": kernel_device_ms(kern, "attention_kernel"),
                   "s1_ms": cuda_time_ms(one, iters=100),
                   "s1_device_ms": kernel_device_ms(one, "attention_kernel"),
                   "plain_ms": cuda_time_ms(plain, iters=20 if S <= 65 else 5 if S <= 256
                                            else 2, warmup=1 if S > 256 else 3),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "plan": da.verify_plan(B, NKV, S * G, W)._asdict(),
                   "device_ms_by_kernel": device_ms_by_kernel(kern, "attention_kernel")}
            if S in (5, 17, 65) or (S == 256 and not dense):
                # The plan's sweep: the blocks the window pieces aim to fill.
                default = da.VERIFY_BLOCKS
                try:
                    for mult in (1, 2, 3, 4, 8):
                        da.VERIFY_BLOCKS = mult * da.NUM_SMS
                        plan = da.verify_plan(B, NKV, S * G, W)
                        sweep[f"{tag}_S{S}_blocks{da.VERIFY_BLOCKS}"] = {
                            "splits": plan.splits, "piece_len": plan.piece_len,
                            "device_ms": kernel_device_ms(kern, "attention_kernel")}
                finally:
                    da.VERIFY_BLOCKS = default
            if dense:
                # SDPA over the window with the chunk joined (outside the
                # timed region): q [B, H, S, D], K/V [B, NKV, W + S, D] and
                # a boolean mask, the window strict and the chunk causal.
                win = views[0][-1][:, 0] == 0                              # [B, W]
                causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device="cuda"))
                valid = torch.cat([win[:, None, :].expand(B, S, W),
                                   causal[None].expand(B, S, S)], dim=-1)[:, None]
                lib_views = [(q.reshape(B, NKV, S, G, D).transpose(2, 3).reshape(B, NKV * G, S, D),
                              torch.cat([k[l, :, :, :W], kc], dim=2),
                              torch.cat([v[l, :, :, :W], vc], dim=2)) for l in range(layers)]
                lib = rot(lambda qq, kk, vv: F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=valid), lib_views)
                row["library_ms"] = cuda_time_ms(lib, iters=100)
                row["library_device_ms"] = device_ms_per_call(lib)
            timing[f"{tag}_S{S}"] = row
            del inputs, views, self_views
    log("verify attention B=4 NKV=32 G=1 D=128 W=768 bf16 q (case: ms, device ms, S=1 "
        "kernel device ms, plain ms, bound ms, SDPA device ms): " + json.dumps(
            {k: [round(r["ms"], 4), r["device_ms"] and round(r["device_ms"], 4),
                 r["s1_device_ms"] and round(r["s1_device_ms"], 4), round(r["plain_ms"], 4),
                 round(r["bound_ms"], 4), r.get("library_device_ms") and
                 round(r["library_device_ms"], 4)] for k, r in timing.items()}))
    # A window ladder at S = 5 on the int8 window with one piece a (slot,
    # head) (one block an SM): its slope is a 64-key tile's cost, its
    # intercept a block's fixed cost.
    ladder = {}
    default = da.VERIFY_BLOCKS
    try:
        da.VERIFY_BLOCKS = B * NKV
        for Wl in (64, 192, 384, 768, 1536, 4096):
            inputs = _va_inputs(B, NKV, 5, G, D, 4096, layers, torch.bfloat16, gen, False)
            views = [_va_args(inputs, Wl, [Wl] * B, layer=l) for l in range(layers)]
            it = {"i": 0}

            def kern_w():
                it["i"] += 1
                return da.verify_attention(*views[it["i"] % layers])

            ladder[Wl] = kernel_device_ms(kern_w, "attention_kernel")
            del inputs, views
    finally:
        da.VERIFY_BLOCKS = default
    tiles = {Wl: -(-Wl // da.VERIFY_TILE) + 1 for Wl in ladder}  # window tiles + the chunk's
    if all(ladder.values()):
        slope = (ladder[4096] - ladder[64]) / (tiles[4096] - tiles[64])
        log(f"verify attention int8 S=5, one piece a (slot, head), device ms over W: "
            f"{json.dumps({w: round(v, 4) for w, v in ladder.items()})}; {slope * 1e3:.2f} us a "
            f"64-key tile, {(ladder[64] - slope * tiles[64]) * 1e3:.2f} us a block besides")
    log("verify attention device ms a launch by kernel: " + json.dumps(
        {k: {n: round(v, 4) for n, v in r["device_ms_by_kernel"].items()}
         for k, r in timing.items()}))
    log("verify attention plan sweep (case_blocks: window pieces, keys a piece, device ms): "
        + json.dumps({k: [r["splits"], r["piece_len"], r["device_ms"] and
                          round(r["device_ms"], 4)] for k, r in sweep.items()}))
    occupancy = chunk_occupancy()
    log(f"chunk kernels' blocks an SM (D 128): {json.dumps(occupancy)}")
    counted = _va_counts(da, gen)
    res = {"checks": checks + counted["checks"],
           "max_abs_err": max(worst, counted["max_abs_err"]), "timing": timing,
           "plan_sweep": sweep, "one_piece_ladder": ladder, "blocks_per_sm": occupancy,
           "counts": counted}
    DETAIL["verify_attention"] = res
    return res


def _bf16_ulps(out, ref):
    """|out - ref| in units of ref's bf16 ulp (2^(e - 7))."""
    import torch

    r = ref.float().abs()
    e = torch.floor(torch.log2(torch.clamp(r, min=torch.finfo(torch.bfloat16).tiny)))
    ulp = torch.exp2(e - 7)
    return ((out.float() - ref.float()).abs() / ulp)


def _rn_case(rn, x, scale, what) -> dict:
    """RMSNorm of ``x`` against its plain version (one bf16 ulp; f32 within
    1e-6 absolute + relative), with the plan that ran."""
    import torch

    out = rn.rmsnorm(x, scale, 1e-5)
    ref = rn.rmsnorm_reference(x, scale, 1e-5)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    if x.dtype == torch.bfloat16:
        bad = float(_bf16_ulps(out, ref).max()) > 1.0
    else:
        bad = bool((err > 1e-6 + 1e-6 * ref.abs()).any())
    if not bool(torch.isfinite(out.float()).all()) or bad:
        raise AssertionError(f"rmsnorm disagrees on {what}: max_abs_err {float(err.max()):.3e}, "
                             f"{float(_bf16_ulps(out, ref).max()):.2f} bf16 ulp")
    aligned = (x.data_ptr() | out.data_ptr() | scale.data_ptr()) % 16 == 0
    plan = rn.rmsnorm_plan(x.numel() // x.shape[-1], x.shape[-1], x.element_size(), aligned)
    return {"max_abs_err": float(err.max()), "ulp": float(_bf16_ulps(out, ref).max()),
            "dtype": str(x.dtype).replace("torch.", ""), "plan": plan._asdict()}


def phase_rmsnorm(rn) -> dict:
    """RMSNorm at Llama-2-7B's width (H = 4096): bf16 at rows 1 and 4
    (decode), 32, 256 and 512 (prefill chunks), f32 x, a misaligned view
    (``buf[1:]``) that must run the scalar instance, and a 32768-wide row
    that must run the cluster instance.  Times the kernel (CUDA events and
    the profiler's device time, the host's share a call between them), its
    plain version and ``F.rms_norm``, and the plan taken against other cuts
    of a row at 4 and 512 rows."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(99)
    H = 4096
    lib = getattr(F, "rms_norm", None)
    worst_ulp, worst_abs = 0.0, 0.0
    cases, timings = {}, {}
    scale = (1 + 0.1 * torch.randn((H,), generator=gen, device="cuda")).to(torch.bfloat16)
    for rows in (1, 4, 32, 256, 512):
        x = torch.randn((rows, H), generator=gen, device="cuda").to(torch.bfloat16)
        c = cases[f"rows{rows}"] = _rn_case(rn, x, scale, f"rows={rows}")
        t = {
            "ms": cuda_time_ms(lambda: rn.rmsnorm(x, scale, 1e-5), iters=200),
            "plain_ms": cuda_time_ms(lambda: rn.rmsnorm_reference(x, scale, 1e-5), iters=200),
            "library_ms": (cuda_time_ms(lambda: lib(x, (H,), scale, 1e-5), iters=200)
                           if lib is not None else None),
            "device_ms": kernel_device_ms(lambda: rn.rmsnorm(x, scale, 1e-5), "rmsnorm_kernel"),
            "library_device_ms": (device_ms_per_call(lambda: lib(x, (H,), scale, 1e-5))
                                  if lib is not None else None),
            "plan": c["plan"],
        }
        # What a call costs beyond the kernel: the wrapper's host time
        # between back-to-back launches.
        t["host_us"] = (t["ms"] - t["device_ms"]) * 1e3 if t["device_ms"] else None
        t["faster_than_library"] = (t["device_ms"] is not None and t["library_device_ms"]
                                    is not None and t["device_ms"] < t["library_device_ms"])
        nbytes = 2 * rows * H * 2 + H * 2
        t["bound_ms"], t["bound_by"] = bound(nbytes, 4 * rows * H, F32_FLOPS)
        timings[rows] = t
    # The plan: the one rmsnorm_plan takes against other cuts of a row (a
    # cluster of 8 CTAs of 64 threads, one CTA of 512, 128 threads a row).
    plan_sweep = {}
    keep = rn.rmsnorm_plan
    try:
        for rows in (4, 512):
            x = torch.randn((rows, H), generator=gen, device="cuda").to(torch.bfloat16)
            nvec = H // 8
            for name, forced in (
                    ("taken", keep(rows, H, 2, True)),
                    ("cluster8x64", rn.Plan(8, 1, 8, nvec // 8, 64, 64)),
                    ("cta512", rn.Plan(8, 1, 1, nvec, 512, 512)),
                    ("tpr128", rn.Plan(8, 4, 1, nvec, 128, 256))):
                rn.rmsnorm_plan = lambda *a, forced=forced: forced  # noqa: E731
                _rn_case(rn, x, scale, f"plan {name}, rows={rows}")
                plan_sweep.setdefault(rows, {})[name] = kernel_device_ms(
                    lambda: rn.rmsnorm(x, scale, 1e-5), "rmsnorm_kernel")
    finally:
        rn.rmsnorm_plan = keep
    x32 = torch.randn((4, H), generator=gen, device="cuda")
    cases["f32_rows4"] = _rn_case(rn, x32, scale, "f32 x, rows=4")
    cases["f32_rows4"]["device_ms"] = kernel_device_ms(lambda: rn.rmsnorm(x32, scale, 1e-5),
                                                       "rmsnorm_kernel")
    buf = torch.randn((4 * H + 1,), generator=gen, device="cuda").to(torch.bfloat16)
    xm = buf[1:].view(4, H)  # 2 bytes off 16: the scalar instance
    cases["misaligned_rows4"] = _rn_case(rn, xm, scale, "buf[1:] view, rows=4")
    if cases["misaligned_rows4"]["plan"]["vec"] != 1:
        raise AssertionError(f"a misaligned x took {cases['misaligned_rows4']['plan']}")
    cases["misaligned_rows4"]["device_ms"] = kernel_device_ms(
        lambda: rn.rmsnorm(xm, scale, 1e-5), "rmsnorm_kernel")
    wide_scale = (1 + 0.1 * torch.randn((32768,), generator=gen, device="cuda")).to(torch.bfloat16)
    xw = torch.randn((4, 32768), generator=gen, device="cuda").to(torch.bfloat16)
    cases["wide_h32768_rows4"] = _rn_case(rn, xw, wide_scale, "H=32768, rows=4")
    if cases["wide_h32768_rows4"]["plan"]["cluster"] < 2:
        raise AssertionError(f"a 32768-wide row took {cases['wide_h32768_rows4']['plan']}")
    cases["wide_h32768_rows4"]["device_ms"] = kernel_device_ms(
        lambda: rn.rmsnorm(xw, wide_scale, 1e-5), "rmsnorm_kernel")
    for c in cases.values():
        worst_ulp = max(worst_ulp, c["ulp"] if c["dtype"] == "bfloat16" else 0.0)
        worst_abs = max(worst_abs, c["max_abs_err"])
    log(f"rmsnorm: {len(cases)} cases, bf16 within {worst_ulp:.2f} ulp, f32 within 1e-6 "
        f"(max_abs_err {worst_abs:.3e}); plans (vec, nv, cluster, threads a row piece, "
        f"threads a CTA): " + "; ".join(
            f"{k} {v['plan']['vec']}/{v['plan']['nv']}/{v['plan']['cluster']}/"
            f"{v['plan']['tpr']}/{v['plan']['threads']}" for k, v in cases.items()))
    for k in ("f32_rows4", "misaligned_rows4", "wide_h32768_rows4"):
        log(f"  {k}: device {cases[k]['device_ms']} ms")
    log(f"  plan sweep (rows: {{plan: device ms}}): {json.dumps(plan_sweep)}")
    for rows, t in timings.items():
        lib_ms = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"  rows={rows}: kernel {t['ms']:.4f} ms a call (device time alone "
            f"{t['device_ms']} ms; host {t['host_us']} us a call), plain {t['plain_ms']:.4f} ms, "
            f"F.rms_norm {lib_ms} ms (device time alone {t['library_device_ms']} ms; kernel "
            f"faster: {t['faster_than_library']}), bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    DETAIL["rmsnorm"] = {"max_ulp": worst_ulp, "max_abs_err": worst_abs,
                         "timings": timings, "cases": cases, "plan_sweep": plan_sweep}
    t = timings[4]  # decode: one row per slot, the path's most frequent shape
    return {"max_abs_err": worst_abs, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"], "host_us": t["host_us"],
            "plan": t["plan"],
            "rows": {r: {k: timings[r][k] for k in ("device_ms", "library_device_ms",
                                                    "bound_ms", "host_us")}
                     for r in timings}}


def _flash_case(gen, B, H, S, T, D, dtype, *, bias_lengths=None, causal=False,
                kv_len=None, strided=False, q_offset=0, nkv=None, cache=None):
    """Inputs of one flash case: q/k/v [B, H, S|T, D] (strided: sliced from
    one [B, S, 3*H*D] projection buffer as BERT's views are), an optional
    f32 key bias from per-row lengths (0 = every key masked).  ``cache``:
    Llama's chunked prefill, q a [B, H, S, D] view of a [B, S, H, D]
    buffer and k/v [B, NKV, T, D] views of the first T positions of a
    position-major [B, cache, NKV, D] buffer; the chunk's queries sit at
    key positions q_offset + i."""
    import torch

    dev = "cuda"
    if cache is not None:
        nkv = nkv or H
        q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype).transpose(1, 2)
        k, v = (torch.randn((B, cache, nkv, D), generator=gen, device=dev).to(dtype)
                [:, :T].transpose(1, 2) for _ in range(2))
    elif strided:
        buf = torch.randn((B, S, 3 * H * D), generator=gen, device=dev).to(dtype)
        q, k, v = (buf[:, :, i * H * D:(i + 1) * H * D].view(B, S, H, D).transpose(1, 2)
                   for i in range(3))
    else:
        q = torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, H, T, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, H, T, D), generator=gen, device=dev).to(dtype)
    bias = None
    if bias_lengths is not None:
        lens = torch.as_tensor(bias_lengths, device=dev)
        bias = torch.where(torch.arange(T, device=dev)[None, :] < lens[:, None], 0.0, -1e9)
        bias = bias.to(torch.float32)
    return {"q": q, "k": k, "v": v, "bias": bias, "causal": causal, "kv_len": kv_len,
            "q_offset": q_offset}


def _flash_work(c) -> tuple[float, float]:
    """Bytes (each input read once, the output written once; K/V at their
    own NKV heads) and flops (4 * D a (query, key) pair that the masks
    leave: kv_len and causal pairs, the latter from each query's position
    q_offset + i, are skipped work, a bias is not)."""
    q, k = c["q"], c["k"]
    B, H, S, D = q.shape
    NKV, T = k.shape[1], k.shape[2]
    kv = T if c["kv_len"] is None else min(c["kv_len"], T)
    if kv <= 0:  # every key masked: the softmax still runs over all T keys
        kv, causal = T, False
    else:
        causal = c["causal"]
    if causal:
        pairs = sum(min(c["q_offset"] + i + 1, kv) for i in range(S))
    else:
        pairs = S * kv
    size = q.element_size()
    nbytes = 2 * B * H * S * D * size + 2 * B * NKV * T * D * size
    if c["bias"] is not None:
        nbytes += B * T * 4
    return nbytes, 4.0 * B * H * pairs * D


def phase_flash_attention(fa) -> dict:
    """The flash kernel against its plain version at the listed shapes,
    with times, the profiler's device time, the plain chain's, SDPA's and
    the bound."""
    import torch
    import torch.nn.functional as F

    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(2024)
    lens_rng = np.random.default_rng(11)
    bert_lens = lens_rng.integers(8, 129, 32).tolist()
    bert_lens[3] = 0  # one row with every key masked: BERT averages V
    long_lens = lens_rng.integers(32, 513, 8).tolist()
    bf, f32 = torch.bfloat16, torch.float32
    cases = {
        "bert_b32_s128_bias": dict(shape=(32, 12, 128, 128, 64, bf), bias_lengths=bert_lens),
        "bert_b32_s128_bias_strided": dict(shape=(32, 12, 128, 128, 64, bf),
                                           bias_lengths=bert_lens, strided=True),
        "b8_s512_bias": dict(shape=(8, 12, 512, 512, 64, bf), bias_lengths=long_lens),
        "causal_d128_s1024": dict(shape=(2, 16, 1024, 1024, 128, bf), causal=True),
        "kv_len_d128_s1024": dict(shape=(2, 16, 1024, 1024, 128, bf), kv_len=700),
        "ragged_s50": dict(shape=(4, 12, 50, 50, 64, bf)),
        # every tensor-core head dim, ragged S = T = 200, a bias with a row
        # masked everywhere; causal with ragged tiles
        "d16_s200_bias": dict(shape=(4, 8, 200, 200, 16, bf), bias_lengths=[0, 57, 133, 200]),
        "d32_s200_bias": dict(shape=(4, 8, 200, 200, 32, bf), bias_lengths=[200, 1, 99, 0]),
        "causal_s200": dict(shape=(4, 8, 200, 200, 64, bf), causal=True),
        "f32_small": dict(shape=(2, 3, 70, 130, 64, f32), kv_len=97),
        # every key masked, T not a multiple of the kernel's tiles: the mean
        # of V over the T keys, as attention_reference gives
        "f32_kv_len0": dict(shape=(2, 3, 70, 130, 64, f32), kv_len=0),
    }
    # Llama-2-7B prefill (H32, D128): a whole 1024-token prompt bucket, then
    # 256-token chunks at cache offsets, each read through strided views of
    # a position-major [1, 4096, NKV, 128] cache buffer (kv_len = offset +
    # 256); grouped heads at G = 4 and 8; an S off the 64-row tiles at an
    # offset; f32 I/O at the same shapes.
    for dt, tag in ((bf, ""), (f32, "f32_")):
        cases[f"{tag}llama_prompt_s1024"] = dict(shape=(1, 32, 1024, 1024, 128, dt),
                                                 causal=True, kv_len=1024, cache=1024)
        for off in (256, 768, 3840):
            cases[f"{tag}llama_chunk_off{off}"] = dict(
                shape=(1, 32, 256, off + 256, 128, dt), causal=True, kv_len=off + 256,
                q_offset=off, cache=4096)
        for nkv in (8, 4):
            cases[f"{tag}gqa_g{32 // nkv}_chunk_off768"] = dict(
                shape=(1, 32, 256, 1024, 128, dt), causal=True, kv_len=1024, q_offset=768,
                nkv=nkv, cache=4096)
        cases[f"{tag}llama_chunk_s100_off300"] = dict(
            shape=(1, 32, 100, 400, 128, dt), causal=True, kv_len=400, q_offset=300,
            cache=4096)
    results = {}
    worst = 0.0
    for name, spec in cases.items():
        B, H, S, T, D, dtype = spec.pop("shape")
        c = _flash_case(gen, B, H, S, T, D, dtype, **spec)
        args = (c["q"], c["k"], c["v"])
        kw = dict(causal=c["causal"], kv_len=c["kv_len"], bias=c["bias"],
                  q_offset=c["q_offset"])
        out = fa.flash_attention(*args, **kw)
        ref = fa.flash_attention_reference(*(x.float() for x in args), **kw)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype).replace("torch.", "")]
        err = (out.float() - ref).abs()
        if not bool(torch.isfinite(out.float()).all()) or bool((err > tol + tol * ref.abs()).any()):
            raise AssertionError(f"flash attention disagrees on {name}: max_abs_err "
                                 f"{float(err.max()):.3e} (tol {tol} abs + {tol} rel)")
        if c["bias"] is not None and 0 in spec.get("bias_lengths", []):
            row = spec["bias_lengths"].index(0)
            uniform = c["v"][row].float().mean(dim=1, keepdim=True).expand(-1, S, -1)
            if float((out[row].float() - uniform).abs().max()) > tol + tol * float(uniform.abs().max()):
                raise AssertionError(f"{name}: the fully masked row is not the mean of V")
        if c["kv_len"] == 0:
            mean_v = c["v"].float().mean(dim=2, keepdim=True).expand(-1, -1, S, -1)
            if float((out.float() - mean_v).abs().max()) > tol + tol * float(mean_v.abs().max()):
                raise AssertionError(f"{name}: kv_len 0 rows are not the mean of V")
        worst = max(worst, float(err.max()))
        fn = lambda: fa.flash_attention(*args, **kw)  # noqa: E731
        ms = cuda_time_ms(fn, iters=100)
        device_ms = kernel_device_ms(fn, "flash_attention_kernel")
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(*args, **kw), iters=20)
        sdpa_kw = {"is_causal": c["causal"]}
        if c["bias"] is not None:
            sdpa_kw["attn_mask"] = c["bias"][:, None, None, :].to(dtype)
        elif c["q_offset"]:  # an explicit boolean mask: key <= offset + query
            pos = torch.arange(T, device="cuda")
            qpos = c["q_offset"] + torch.arange(S, device="cuda")
            sdpa_kw = {"attn_mask": (pos[None, :] <= qpos[:, None])[None, None]
                       & (pos < c["kv_len"])[None, None, None, :]}
        elif c["kv_len"] is not None and c["kv_len"] < T:
            sdpa_kw["attn_mask"] = (torch.arange(T, device="cuda") < c["kv_len"])[None, None, None, :]
        if c["k"].shape[1] != H:
            sdpa_kw["enable_gqa"] = True
        sdpa = lambda: F.scaled_dot_product_attention(*args, **sdpa_kw)  # noqa: E731
        library_ms = cuda_time_ms(sdpa, iters=100)
        library_device_ms = device_ms_per_call(sdpa)
        nbytes, flops = _flash_work(c)
        bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        f32_bound_ms, f32_bound_by = bound(nbytes, flops, F32_FLOPS)
        results[name] = {
            "shape": [B, H, S, T, D, str(dtype).replace("torch.", "")],
            "max_abs_err": float(err.max()), "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "f32_cuda_core_bound_ms": f32_bound_ms,
            "f32_cuda_core_bound_by": f32_bound_by, "flops": flops, "bytes": nbytes,
        }
        log(f"flash {name} {results[name]['shape']}: max_abs_err {float(err.max()):.3e}; "
            f"kernel {ms:.4f} ms (device {device_ms} ms), plain {plain_ms:.4f} ms, SDPA "
            f"{library_ms:.4f} ms (device {library_device_ms} ms), bound {bound_ms:.5f} ms "
            f"({bound_by}; f32 CUDA-core "
            f"{f32_bound_ms:.5f} ms)")
    # A q whose base is not 16-byte aligned: the bf16 kernel copies Q with
    # 16-byte cp.async, so the wrapper raises (it never reroutes).
    c = _flash_case(gen, 2, 4, 64, 64, 64, bf)
    buf = torch.empty(c["q"].numel() + 1, dtype=bf, device="cuda")
    q_off = buf[1:].view(c["q"].shape).copy_(c["q"])
    before = fa.launches
    try:
        fa.flash_attention(q_off, c["k"], c["v"])
    except ValueError as e:
        if "16-byte" not in str(e):
            raise
    else:
        raise AssertionError("flash attention took a q that is not 16-byte aligned")
    if fa.launches != before:
        raise AssertionError("a refused flash call counted a launch")
    log("flash: a q that is not 16-byte aligned raises ValueError")
    # A chunk whose positions run past the keys: q_offset + S > T.
    c = _flash_case(gen, 1, 32, 256, 1024, 128, bf, q_offset=800, cache=4096)
    before = fa.launches
    try:
        fa.flash_attention(c["q"], c["k"], c["v"], causal=True, q_offset=800)
    except ValueError as e:
        if "outside" not in str(e):
            raise
    else:
        raise AssertionError("flash attention took q_offset + S > T")
    if fa.launches != before:
        raise AssertionError("a refused flash call counted a launch")
    log("flash: q_offset 800 + S 256 over T 1024 raises ValueError")
    DETAIL["flash_attention"] = results
    head = results["bert_b32_s128_bias"]
    return {"max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "device_ms": head["device_ms"],
            "library_device_ms": head["library_device_ms"],
            "f32_cuda_core_bound_ms": head["f32_cuda_core_bound_ms"],
            "shape": head["shape"],
            "llama": {k: {f: results[k][f] for f in (
                "shape", "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                "bound_ms", "bound_by", "max_abs_err")}
                for k in ("llama_prompt_s1024", "llama_chunk_off768")}}


# The log-sum-exp of the flash kernel (ring attention's blocks) against the
# plain version's, absolute and relative: f32 keeps the scores the plain
# version keeps; bf16 sums the probabilities rounded to bf16 (relative 2^-9
# each), so its l, and log(l), move by up to ~2^-9.
LSE_TOL = {"float32": 1e-4, "bfloat16": 4e-3}


def phase_flash_lse(fa) -> dict:
    """The flash kernel with its log-sum-exp output (``return_lse=True``)
    against the plain version's at the ring's block shapes: Llama-2-7B's
    heads (H32, and H16 a tp-2 rank), D128, one 1024-position block of a
    2048-token prompt at sp 2 (S = T = 1024), the diagonal block (causal)
    and an off-diagonal one, f32 and bf16; a kv_len edge (a partial key
    range, and kv_len 0: every row -inf, its output the mean of V).  The
    output within FLASH_TOL, the log-sum-exp within LSE_TOL; times beside
    the plain version's, the bound and (bf16) the library's flash
    attention, which returns a logsumexp too."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2026)
    bf, f32 = torch.bfloat16, torch.float32
    cases = {}
    for dt, tag in ((bf, "bf16"), (f32, "f32")):
        for h in (32, 16):
            for causal in (True, False):
                cases[f"ring_{tag}_h{h}_{'diag' if causal else 'off'}"] = dict(
                    shape=(1, h, 1024, 1024, 128, dt), causal=causal)
        cases[f"ring_{tag}_kv_len700"] = dict(shape=(1, 32, 1024, 1024, 128, dt), kv_len=700)
        cases[f"ring_{tag}_kv_len0"] = dict(shape=(1, 16, 200, 1024, 128, dt), kv_len=0)
    results, worst, worst_lse = {}, 0.0, 0.0
    for name, spec in cases.items():
        B, H, S, T, D, dtype = spec.pop("shape")
        c = _flash_case(gen, B, H, S, T, D, dtype, **spec)
        # The ring's layout: q a [B, H, S, D] view of [B, S, H, D], k/v dense blocks.
        q = c["q"].transpose(1, 2).contiguous().transpose(1, 2)
        args = (q, c["k"].contiguous(), c["v"].contiguous())
        kw = dict(causal=c["causal"], kv_len=c["kv_len"], return_lse=True)
        lse0 = fa.lse_launches
        out, lse = fa.flash_attention(*args, **kw)
        if fa.lse_launches != lse0 + 1:
            raise AssertionError(f"flash lse {name}: the launch was not counted")
        ref, ref_lse = fa.flash_attention_reference(*(x.float() for x in args), **kw)
        torch.cuda.synchronize()
        key = str(dtype).replace("torch.", "")
        tol, ltol = FLASH_TOL[key], LSE_TOL[key]
        err = (out.float() - ref).abs()
        if not bool(torch.isfinite(out.float()).all()) or bool((err > tol + tol * ref.abs()).any()):
            raise AssertionError(f"flash lse {name}: output max_abs_err {float(err.max()):.3e}")
        if not torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse)):
            raise AssertionError(f"flash lse {name}: -inf rows differ from the plain version's")
        fin = torch.isfinite(ref_lse)
        lerr = (lse[fin] - ref_lse[fin]).abs()
        lerr_max = float(lerr.max()) if lerr.numel() else 0.0
        if lerr.numel() and bool((lerr > ltol + ltol * ref_lse[fin].abs()).any()):
            raise AssertionError(f"flash lse {name}: log-sum-exp max_abs_err {lerr_max:.3e} "
                                 f"(tol {ltol} abs + {ltol} rel)")
        if c["kv_len"] == 0 and not bool(torch.isneginf(lse).all()):
            raise AssertionError(f"flash lse {name}: kv_len 0 rows are not -inf")
        worst, worst_lse = max(worst, float(err.max())), max(worst_lse, lerr_max)
        fn = lambda: fa.flash_attention(*args, **kw)  # noqa: E731
        ms = cuda_time_ms(fn, iters=100)
        device_ms = kernel_device_ms(fn, "flash_attention_kernel")
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(*args, **kw), iters=20)
        nbytes, flops = _flash_work(c)
        nbytes += B * H * S * 4  # the log-sum-exp written
        peak = BF16_TENSOR_FLOPS if dtype == bf else F32_FLOPS
        bound_ms, bound_by = bound(nbytes, flops, peak)
        library_ms = library_lse_err = None
        if dtype == bf and c["kv_len"] is None:
            lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(  # noqa: E731
                *args, 0.0, c["causal"], False, scale=1.0 / D ** 0.5)
            library_ms = cuda_time_ms(lib, iters=100)
            library_lse_err = float((lib()[1].float() - lse).abs().max())
        results[name] = {"shape": [B, H, S, T, D, key], "causal": c["causal"],
                         "kv_len": c["kv_len"], "max_abs_err": float(err.max()),
                         "lse_max_abs_err": lerr_max, "ms": ms, "device_ms": device_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms, "library_lse_max_abs_diff": library_lse_err}
        log(f"flash lse {name} {results[name]['shape']} causal {c['causal']} kv_len "
            f"{c['kv_len']}: max_abs_err {float(err.max()):.3e}, lse {lerr_max:.3e}; kernel "
            f"{ms:.4f} ms (device {device_ms} ms), plain {plain_ms:.4f} ms, library flash "
            f"{library_ms} ms (its lse differs by {library_lse_err}), bound {bound_ms:.5f} ms "
            f"({bound_by})")
    DETAIL["flash_attention_lse"] = results
    head = results["ring_bf16_h16_diag"]
    return {"max_abs_err": worst, "lse_max_abs_err": worst_lse, "ms": head["ms"],
            "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": "B1 H16 (tp 2) S=T=1024 D128 bf16, causal (the ring's diagonal block)",
            "off_diagonal": {k: results[k] for k in ("ring_bf16_h16_off", "ring_bf16_h32_off")}}


def _ragged_case(gen, Bp, C, H, NKV, offsets, slots, n_slots, int8, near_clip=False,
                 T=4096, D=128, layers=1):
    """Inputs of one ragged flash case at the engine's layouts: q [Bp, C, H,
    D] bf16; ``layers`` layers of a head-major cache [NS, NKV, T, D] (int8
    codes with f32 scales, or bf16); slots/offsets int32 on the card; the
    chunk's exact K/V [Bp, C, NKV, D] bf16 and, int8, its round-trip
    codes.  ``near_clip``: every chunk row holds one +-8 outlier, so the
    round-trip lands it on +-127 and the rest on few steps."""
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    dev = "cuda"
    bf = torch.bfloat16
    q = torch.randn((Bp, C, H, D), generator=gen, device=dev).to(bf)
    kc = torch.randn((Bp, C, NKV, D), generator=gen, device=dev)
    vc = torch.randn((Bp, C, NKV, D), generator=gen, device=dev)
    if near_clip:
        kc[..., 3] = 8.0 * torch.sign(kc[..., 3])
        vc[..., 5] = -8.0
    kc, vc = kc.to(bf), vc.to(bf)
    shape = (layers, n_slots, NKV, T, D)
    if int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand(shape[:-1] + (1,), generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(shape[:-1] + (1,), generator=gen, device=dev) * 0.02 + 1e-3
        rt = (*llama._quant_kv(kc), *llama._quant_kv(vc))
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(bf)
        v = torch.randn(shape, generator=gen, device=dev).to(bf)
        ks = vs = rt = None
    return {"q": q, "k": k, "v": v, "ks": ks, "vs": vs, "kc": kc, "vc": vc, "rt": rt,
            "slots": torch.tensor(slots, dtype=torch.int32, device=dev),
            "offsets": torch.tensor(offsets, dtype=torch.int32, device=dev)}


def _ragged_args(c, layer=0):
    """The wrapper's arguments for one layer of a ragged case."""
    if c["ks"] is None:
        return (c["q"], c["k"][layer], c["v"][layer], c["slots"], c["offsets"], c["kc"],
                c["vc"])
    return (c["q"], c["k"][layer], c["v"][layer], c["slots"], c["offsets"], c["kc"], c["vc"],
            c["ks"][layer], c["vs"][layer], c["rt"])


def _ragged_work(c) -> tuple[float, float]:
    """Bytes (q and the output, each row's window up to its offset with its
    scales, the chunk's K/V and round-trip codes, slots and offsets) and
    flops (4 * D a (query, key) pair: each query's window keys plus its
    causal chunk keys) that this case's data needs."""
    q, k = c["q"], c["k"]
    Bp, C, H, D = q.shape
    NKV, T = k.shape[2], k.shape[3]
    win = [o if 0 < o < T else 0 for o in c["offsets"].tolist()]
    int8 = c["ks"] is not None
    per_key = 2 * NKV * D * (1 if int8 else 2) + (2 * NKV * 4 if int8 else 0)
    nbytes = (2 * Bp * C * H * D * 2 + sum(win) * per_key
              + 2 * Bp * C * NKV * D * 2 + (Bp * C * per_key if int8 else 0) + 2 * Bp * 4)
    pairs = sum(C * w + C * (C + 1) // 2 for w in win)
    return nbytes, 4.0 * D * H * pairs


def _ragged_check(fa, c, what) -> float:
    """The ragged kernel against its plain version computed in f32 from
    the same inputs, every row (parked rows included), FLASH_TOL for bf16
    I/O; returns the max abs error."""
    import torch

    args = _ragged_args(c)
    out = fa.flash_attention_ragged(*args)
    wide = [x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x
            for x in args]
    ref = fa.flash_attention_ragged_reference(*wide)
    torch.cuda.synchronize()
    tol = FLASH_TOL["bfloat16"]
    err = (out.float() - ref).abs()
    if not bool(torch.isfinite(out.float()).all()) or bool((err > tol + tol * ref.abs()).any()):
        raise AssertionError(f"ragged flash attention disagrees: {what} max_abs_err "
                             f"{float(err.max()):.3e} (tol {tol} abs + {tol} rel)")
    return float(err.max())


def phase_flash_ragged(fa) -> dict:
    """The ragged instance of the flash kernel (packed prefill) against its
    plain version: int8 (with scales) and bf16 caches; B_p 1, 3 (bucket 4
    with a parked row) and 8; permuted, non-contiguous slots of a 10-row
    cache; offsets 0, 256, 768, 3840 and off the 64-key tiles; G 1, 4, 8;
    chunks of 256 and 100; chunk rows near the int8 clip; D 128, and D 64
    once a cache; f32 q at C 512 (the verify chunk kernel's f32 instance,
    int8 and f32 caches, within DA_TOL).  Then its time at
    Llama-2-7B's packed shape (B_p 4, C 256, offsets 0/256/768/3840, H =
    NKV = 32, D 128) on both caches, with the profiler's device time, the
    plain version's, the bound and, on the bf16 cache, SDPA over the
    gathered window plus the chunk with a boolean mask; a misaligned q must
    raise ValueError."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from importlib import import_module

    llama_mod = import_module(f"{PKG}.models.llama")
    da_mod = import_module(f"{PKG}.ops.decode_attention")
    gen = torch.Generator(device="cuda").manual_seed(9753)
    perm = np.random.default_rng(5).permutation(10).tolist()
    T, NS = 4096, 10
    # (B_p real rows, C, offsets): a parked row (offset T) pads B_p 3 to 4
    layouts = [
        (1, 256, [3840]),
        (3, 256, [0, 768, 3840, T]),
        (8, 100, [0, 256, 768, 3840, 1337, 37, 3990, 64]),
    ]
    worst, checks = 0.0, 0
    for int8 in (True, False):
        for NKV in (32, 8, 4):
            for real, C, offsets in layouts:
                c = _ragged_case(gen, len(offsets), C, 32, NKV, offsets, perm[:len(offsets)],
                                 NS, int8, near_clip=real == 3)
                what = (f"{'int8' if int8 else 'bf16'} cache G={32 // NKV} B_p={len(offsets)} "
                        f"({real} real) C={C} offsets={offsets}")
                worst = max(worst, _ragged_check(fa, c, what))
                checks += 1
                del c
        # The D = 64 instance: 16 query heads over 4 K/V heads, a parked row.
        c = _ragged_case(gen, 4, 100, 16, 4, [0, 300, 1337, T], perm[:4], NS, int8,
                         near_clip=True, D=64)
        worst = max(worst, _ragged_check(fa, c, f"{'int8' if int8 else 'bf16'} cache D=64"))
        checks += 1
        del c
    log(f"ragged flash: {checks} checks (int8 and bf16 caches, G 1/4/8, B_p 1/4 with a parked "
        f"row/8, C 256 and 100, permuted slots, offsets 0..3990 on and off the tiles, rows "
        f"near the int8 clip, D 128 and 64), max_abs_err {worst:.3e} (tol "
        f"{FLASH_TOL['bfloat16']} abs + rel)")
    # f32 q (an f32 replica's packed prefill, phase 8d): the verify chunk
    # kernel's f32-q instance on each row's gathered window, int8 and f32
    # caches, C 512 with a parked row, against the plain version (DA_TOL).
    f32_worst, f32_checks = 0.0, 0
    for int8 in (True, False):
        for NKV in (32, 8):
            c = _ragged_case(gen, 4, 512, 32, NKV, [0, 512, 1100, T], perm[:4], NS, int8,
                             near_clip=True)
            c["q"], c["kc"], c["vc"] = (c[n].float() for n in ("q", "kc", "vc"))
            if int8:
                c["rt"] = (*llama_mod._quant_kv(c["kc"]), *llama_mod._quant_kv(c["vc"]))
            else:
                c["k"], c["v"] = c["k"].float(), c["v"].float()
            args = _ragged_args(c)
            before = (fa.ragged_launches, da_mod.verify_launches)
            out = fa.flash_attention_ragged(*args)
            ref = fa.flash_attention_ragged_reference(*args)
            torch.cuda.synchronize()
            if (fa.ragged_launches, da_mod.verify_launches) != (before[0], before[1] + 1):
                raise AssertionError("ragged flash f32: not one verify launch")
            err = (out - ref).abs()
            if out.dtype != torch.float32 or not bool(torch.isfinite(out).all()) or bool(
                    (err > DA_TOL + DA_TOL * ref.abs()).any()):
                raise AssertionError(f"ragged flash f32 q disagrees: {'int8' if int8 else 'f32'}"
                                     f" cache NKV={NKV} max_abs_err {float(err.max()):.3e}")
            f32_worst = max(f32_worst, float(err.max()))
            f32_checks += 1
            del c, args, out, ref
    log(f"ragged flash f32 q (through the verify chunk kernel's f32 instance): {f32_checks} "
        f"checks (int8 and f32 caches, G 1 and 4, B_p 4 with a parked row, C 512), "
        f"max_abs_err {f32_worst:.3e} (tol {DA_TOL} abs + rel)")

    # Time at the packed shape, the cache rotating over 4 layers (> the
    # 50 MB L2 on the int8 cache's window) as consecutive layers do.
    offsets, layers = [0, 256, 768, 3840], 4
    timing, sweep = {}, {}
    for int8 in (True, False):
        tag = "int8" if int8 else "bf16"
        c = _ragged_case(gen, 4, 256, 32, 32, offsets, perm[:4], NS, int8, layers=layers)
        views = [_ragged_args(c, l) for l in range(layers)]
        it = {"i": 0}

        def rot(f, vws):
            def call():
                it["i"] += 1
                return f(*vws[it["i"] % layers])
            return call

        kern = rot(fa.flash_attention_ragged, views)
        plain = rot(fa.flash_attention_ragged_reference, views)
        nbytes, flops = _ragged_work(c)
        bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        row = {"ms": cuda_time_ms(kern, iters=50),
               "device_ms": kernel_device_ms(kern, "flash_ragged_kernel"),
               "plain_ms": cuda_time_ms(plain, iters=5),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
               "library_ms": None, "library_device_ms": None,
               "plan": fa.ragged_plan(256, T)._asdict(),
               "device_ms_by_kernel": device_ms_by_kernel(kern, "flash_ragged_kernel")}
        # The plan's sweep: keys a window piece (4096: no split).
        default = fa.RAGGED_PIECE
        try:
            for piece in (512, 1024, 2048, 4096):
                fa.RAGGED_PIECE = piece
                sweep[f"{tag}_piece{piece}"] = kernel_device_ms(kern, "flash_ragged_kernel")
        finally:
            fa.RAGGED_PIECE = default
        if not int8:
            # SDPA over each row's gathered window plus its chunk (built
            # outside the timed region): keys [B_p, NKV, T + C, D], the
            # window strict and the chunk causal in a boolean mask.
            key = torch.arange(T, device="cuda")
            win = key[None, :] < c["offsets"][:, None].long()               # [B_p, T]
            causal = torch.tril(torch.ones((256, 256), dtype=torch.bool, device="cuda"))
            valid = torch.cat([win[:, None, :].expand(4, 256, T),
                               causal[None].expand(4, 256, 256)], dim=-1)[:, None]
            rows = c["slots"].long()
            lib_views = [(c["q"].transpose(1, 2),
                          torch.cat([c["k"][l][rows], c["kc"].transpose(1, 2)], dim=2),
                          torch.cat([c["v"][l][rows], c["vc"].transpose(1, 2)], dim=2))
                         for l in range(layers)]
            lib = rot(lambda qq, kk, vv: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=valid), lib_views)
            row["library_ms"] = cuda_time_ms(lib, iters=50)
            row["library_device_ms"] = device_ms_per_call(lib)
            del lib_views
        timing[tag] = row
        log(f"ragged flash {tag} cache B_p=4 C=256 offsets {offsets} H=NKV=32 D=128: kernel "
            f"{row['ms']:.4f} ms (device {row['device_ms']} ms), plain {row['plain_ms']:.4f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), SDPA {row['library_ms']} ms (device "
            f"{row['library_device_ms']} ms); by kernel {row['device_ms_by_kernel']}")
        del c, views
    log("ragged flash plan sweep at B_p=4 C=256 offsets 0/256/768/3840 (case: device ms): "
        + json.dumps({k: v and round(v, 4) for k, v in sweep.items()}))

    # A q whose base is not 16-byte aligned raises; nothing launches.
    c = _ragged_case(gen, 2, 64, 32, 32, [0, 64], perm[:2], NS, True)
    buf = torch.empty(c["q"].numel() + 1, dtype=torch.bfloat16, device="cuda")
    c["q"] = buf[1:].view(c["q"].shape).copy_(c["q"])
    before = fa.ragged_launches
    try:
        fa.flash_attention_ragged(*_ragged_args(c))
    except ValueError as e:
        if "misaligned" not in str(e):
            raise
    else:
        raise AssertionError("ragged flash attention took a misaligned q")
    if fa.ragged_launches != before:
        raise AssertionError("a refused ragged flash call counted a launch")
    log("ragged flash: a q that is not 16-byte aligned raises ValueError")
    res = {"checks": checks, "max_abs_err": worst, "timing": timing, "plan_sweep": sweep}
    DETAIL["flash_ragged"] = res
    return res


def _dm_case(dm, gen, B, NKV, D, W, lengths, qdtype=None, pad_w=None, copies=1):
    """Inputs of one D-major case as the probe draws them, on the card:
    head-major int8 K/V [copies, B, NKV, W, D], scales, f32 (or bf16) q,
    the 0 / -1e9 mask, and real D-major copies.  ``pad_w``: the D-major
    window is a [..., :W] slice of a buffer ``pad_w`` wide."""
    import torch

    dev = "cuda"
    wb = pad_w or W
    shape = (copies, B, NKV, wb, D)
    k8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    ks = torch.randn(shape[:4] + (1,), generator=gen, device=dev).abs() * 0.01 + 1e-3
    vs = torch.randn(shape[:4] + (1,), generator=gen, device=dev).abs() * 0.01 + 1e-3
    q = torch.randn((B, NKV, 1, D), generator=gen, device=dev).to(qdtype or torch.float32)
    mask = dm.length_mask(torch.as_tensor(lengths, device=dev), W)
    t = lambda x: x.transpose(-2, -1).contiguous()  # noqa: E731
    k8t, v8t, kst, vst = t(k8)[..., :W], t(v8)[..., :W], t(ks)[..., :W], t(vs)[..., :W]
    k8, v8, ks, vs = k8[:, :, :, :W], v8[:, :, :, :W], ks[:, :, :, :W], vs[:, :, :, :W]
    return {"q": q, "qt": t(q), "mask": mask, "lengths": lengths,
            "head": [(k8[i], ks[i], v8[i], vs[i]) for i in range(copies)],
            "dmajor": [(k8t[i], kst[i], v8t[i], vst[i]) for i in range(copies)]}


def _dm_bytes_flops(B, NKV, D, W, itemsize):
    nbytes = (B * NKV * D * itemsize      # q
              + 2 * B * NKV * D * W       # k8t, v8t
              + 2 * B * NKV * W * 4       # ks, vs
              + B * W * 4                 # mask
              + B * NKV * D * 4)          # out
    # q * scale; the scores (2DW), * ks + mask, - max, exp, p * vs, the sum
    # of p; the context (2DW); the division.
    flops = B * NKV * (4 * D * W + 6 * W + 2 * D)
    return nbytes, flops


def _dm_check(dm, c, what) -> float:
    """The D-major kernel on copy 0 of case ``c`` against its plain version
    (DA_TOL absolute + relative); a row masked everywhere must be the
    uniform average over W of vs * v.  Returns the max abs error."""
    import torch

    args = (c["qt"], *c["dmajor"][0], c["mask"])
    out = dm.attn_dmajor(*args)
    ref = dm.attn_dmajor_reference(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    if not bool(torch.isfinite(out).all()) or bool((err > DA_TOL + DA_TOL * ref.abs()).any()):
        raise AssertionError(f"dmajor attention disagrees on {what}: max_abs_err "
                             f"{float(err.max()):.3e} (tol {DA_TOL} abs + {DA_TOL} rel)")
    k8t, kst, v8t, vst = c["dmajor"][0]
    for i in (i for i, n in enumerate(c["lengths"]) if n == 0):
        uniform = (v8t[i].float() * vst[i]).mean(dim=-1, keepdim=True)
        if float((out[i] - uniform).abs().max()) > DA_TOL + DA_TOL * float(uniform.abs().max()):
            raise AssertionError(f"dmajor {what}: the fully masked row is not uniform")
    return float(err.max())


def _dm_split_checks(dm) -> dict:
    """The split kernel where it can go wrong:
    lengths on and beside every split edge, B = 1 at W = 4096 (the cap of
    8 splits), a split past W, 16- and 4-byte copies with splits."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2718)
    out = {}

    def edges(B, NKV, W):
        s = dm.dmajor_splits(B, NKV, W)
        c = dm.split_len(W, s)
        return [0, W, W - 1] + [j * c + o for j in range(1, s) for o in (-1, 0, 1)
                                if j * c + o <= W]

    def run(what, B, NKV, W, lengths_all, vec, pad_w=None, want_splits=None):
        c0 = _dm_case(dm, gen, B, NKV, 128, W, [W] * B, pad_w=pad_w)
        k8t, _, v8t, _ = c0["dmajor"][0]
        if dm.load_width(k8t, v8t) != vec:
            raise AssertionError(f"{what}: load width {dm.load_width(k8t, v8t)}, expected {vec}")
        s = dm.dmajor_splits(B, NKV, W)
        if want_splits is not None and s != want_splits:
            raise AssertionError(f"{what}: {s} splits, expected {want_splits}")
        worst, n = 0.0, 0
        for i in range(0, len(lengths_all), B):
            lengths = (lengths_all[i:i + B] + [W] * B)[:B]
            c = dict(c0, lengths=lengths, mask=dm.length_mask(
                torch.as_tensor(lengths, device="cuda"), W))
            worst = max(worst, _dm_check(dm, c, what))
            n += 1
        out[what] = {"shape": [B, NKV, 128, W], "splits": s, "split_len": dm.split_len(W, s),
                     "vec": vec, "checks": n, "max_abs_err": worst}

    run("edges_b2_w4096", 2, 16, 4096, edges(2, 16, 4096), 16)
    run("b1_w4096_cap8", 1, 16, 4096, edges(1, 16, 4096), 16, want_splits=dm.MAX_SPLITS)
    # 513 positions in 8 runs of 80: the last split owns none.
    s, c = dm.dmajor_splits(1, 16, 513), dm.split_len(513, dm.dmajor_splits(1, 16, 513))
    if (s - 1) * c < 513:
        raise AssertionError(f"W=513 at one slot has no empty split ({s} x {c})")
    run("split_past_w513", 1, 16, 513, [513, 481, 480, 479, 1, 0], 16, pad_w=528)
    # 4-byte copies with splits: rows 4100 bytes apart.
    run("vec4_edges_b2_w4096", 2, 16, 4096, edges(2, 16, 4096), 4, pad_w=4100)
    return out


def phase_dmajor_attention(dm, da) -> dict:
    """The D-major kernel against its plain version at the listed shapes,
    where its split over W can go wrong, against the head-major decode
    kernel through the self-row identity, its times beside the head-major
    kernel's and the bound (a window ladder and a split sweep), then the
    port's layout probe in process (the path that runs
    the kernel)."""
    import math

    import numpy as np
    import torch
    from importlib import import_module

    gen = torch.Generator(device="cuda").manual_seed(3141)
    rng = np.random.default_rng(17)
    NKV, D, W = dm.NKV, dm.D, dm.W
    probe_lengths = {b: (np.arange(b) * (W // b) + 1).tolist() for b in (8, 32)}
    cases = {f"probe_b{b}": dict(B=b, NKV=NKV, D=D, W=W, lengths=probe_lengths[b])
             for b in (8, 32)}
    for w in (96, 192, 768, 4096):  # one fully masked row, ragged lengths
        cases[f"w{w}"] = dict(B=4, NKV=NKV, D=D, W=w, lengths=[0, 1, w // 3, w])
    cases["d64"] = dict(B=4, NKV=NKV, D=64, W=W, lengths=rng.integers(1, W + 1, 4).tolist())
    cases["bf16_q"] = dict(B=4, NKV=NKV, D=D, W=W, lengths=[0, 37, 300, W],
                           qdtype=torch.bfloat16)
    # W not a multiple of 4, as a slice of a wider buffer: 4-byte copies, a zero-filled tail
    cases["w97_sliced"] = dict(B=3, NKV=4, D=32, W=97, lengths=[0, 50, 97], pad_w=100)
    worst = 0.0
    for name, spec in cases.items():
        c = _dm_case(dm, gen, **spec)
        worst = max(worst, _dm_check(dm, c, name))
        if name.startswith("probe_"):
            out = dm.attn_dmajor(c["qt"], *c["dmajor"][0], c["mask"])
            hm_in = dm.headmajor_self_row_inputs(c["q"], *c["head"][0], c["lengths"])
            hm = da.decode_attention(*hm_in).transpose(2, 3)
            torch.cuda.synchronize()
            herr = (out - hm).abs()
            if bool((herr > DA_TOL + DA_TOL * hm.abs()).any()):
                raise AssertionError(f"dmajor vs head-major kernel on {name}: max_abs_err "
                                     f"{float(herr.max()):.3e}")
            log(f"dmajor {name}: vs the head-major kernel through the self-row identity "
                f"max_abs_err {float(herr.max()):.3e}")
    split_checks = _dm_split_checks(dm)
    for r in split_checks.values():
        worst = max(worst, r["max_abs_err"])
    log(f"dmajor attention: {len(cases)} shapes against the plain version, and "
        f"{sum(r['checks'] for r in split_checks.values())} split checks, max_abs_err "
        f"{worst:.3e} (tol {DA_TOL} abs + {DA_TOL} rel)")
    log("  split checks (shape [B, NKV, D, W], splits x split_len, copy width): " + "; ".join(
        f"{k} {v['shape']} {v['splits']}x{v['split_len']} vec{v['vec']}"
        for k, v in split_checks.items()))

    # Timing at the probe's shapes.  Calls rotate over enough copies of the
    # window that the working set exceeds the 50 MB L2, as 24 layers would.
    timings = {}
    for b in (8, 32):
        nbytes, flops = _dm_bytes_flops(b, NKV, D, W, 4)
        copies = max(2, math.ceil(150e6 / nbytes))
        c = _dm_case(dm, gen, b, NKV, D, W, probe_lengths[b], copies=copies)
        dviews = [(c["qt"], k, ks, v, vs, c["mask"]) for k, ks, v, vs in c["dmajor"]]
        hviews = [dm.headmajor_self_row_inputs(c["q"], *h, c["lengths"]) for h in c["head"]]
        it = {"i": 0}

        def rotate(fn, views, it=it):
            it["i"] += 1
            return fn(*views[it["i"] % len(views)])

        kern = lambda: rotate(dm.attn_dmajor, dviews)  # noqa: E731
        head = lambda: rotate(da.decode_attention, hviews)  # noqa: E731
        t = {
            "ms": cuda_time_ms(kern, iters=200),
            "device_ms": kernel_device_ms(kern, "dmajor_attention_kernel"),
            # the same window every call, as the probe's chain sees it (L2-warm)
            "device_ms_same_window": kernel_device_ms(lambda: dm.attn_dmajor(*dviews[0]),
                                                      "dmajor_attention_kernel"),
            "plain_ms": cuda_time_ms(lambda: rotate(dm.attn_dmajor_reference, dviews), iters=20),
            "headmajor_ms": cuda_time_ms(head, iters=200),
            "headmajor_device_ms": kernel_device_ms(head, "decode_attention_kernel"),
            "headmajor_device_ms_same_window": kernel_device_ms(
                lambda: da.decode_attention(*hviews[0]), "decode_attention_kernel"),
            "headmajor_splits": da.num_splits(b, NKV, W),
            "splits": dm.dmajor_splits(b, NKV, W),
            "copies": copies, "bytes": nbytes, "flops": flops,
        }
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
        timings[b] = t
        if b == 8:
            # The split count: dmajor_splits fills one wave of BLOCKS_PER_SM
            # blocks an SM; the constant moved gives 1, 2, 4 and 8 splits here
            # (more than 1: the merge kernel runs too).
            sweep = {}
            keep = dm.BLOCKS_PER_SM
            try:
                for bps in (1, 2, 4, 8):
                    dm.BLOCKS_PER_SM = bps
                    sweep[dm.dmajor_splits(b, NKV, W)] = kernel_device_ms(
                        kern, "dmajor_attention_kernel")
            finally:
                dm.BLOCKS_PER_SM = keep
        log(f"dmajor B={b} NKV={NKV} D={D} W={W} f32 q: kernel {t['ms']:.4f} ms a call "
            f"(device {t['device_ms']} ms; same window {t['device_ms_same_window']} ms), "
            f"plain {t['plain_ms']:.4f} ms, head-major kernel {t['headmajor_ms']:.4f} ms "
            f"(device {t['headmajor_device_ms']} ms; same window "
            f"{t['headmajor_device_ms_same_window']} ms; {t['headmajor_splits']} splits), "
            f"bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}; {nbytes / 1e6:.2f} MB), {copies} windows rotated, "
            f"{t['splits']} splits ({'with' if t['splits'] > 1 else 'no'} merge kernel)")
        del c, dviews, hviews
    log(f"  split sweep at B=8 ({{splits: device ms}}; dmajor_splits takes "
        f"{timings[8]['splits']}): {json.dumps(sweep)}")
    # A window ladder at 8 slots, rotated over copies beyond the L2.
    ladder = {}
    for Wl in (96, 512, 1536, 4096):
        nb, fl = _dm_bytes_flops(8, NKV, D, Wl, 4)
        c = _dm_case(dm, gen, 8, NKV, D, Wl, [Wl] * 8, copies=max(2, math.ceil(150e6 / nb)))
        dviews = [(c["qt"], k, ks, v, vs, c["mask"]) for k, ks, v, vs in c["dmajor"]]
        it = {"i": 0}

        def kl(dviews=dviews, it=it):
            it["i"] += 1
            return dm.attn_dmajor(*dviews[it["i"] % len(dviews)])

        ladder[Wl] = {"device_ms": kernel_device_ms(kl, "dmajor_attention_kernel"),
                      "bound_ms": bound(nb, fl, F32_FLOPS)[0],
                      "splits": dm.dmajor_splits(8, NKV, Wl)}
        del c, dviews
    log("  window ladder at B=8 (W: device ms, bound ms, splits): " + json.dumps(
        {k: [v["device_ms"] and round(v["device_ms"], 5), round(v["bound_ms"], 5), v["splits"]]
         for k, v in ladder.items()}))
    torch.cuda.empty_cache()

    # The path that runs the kernel: the layout probe, counts from 0.
    probe_mod = import_module(f"{PKG}.scripts.proto_dmajor_attention")
    slots, rounds = (8, 32), 2
    for mod in (dm, da):
        mod.launches = 0
    t0 = time.perf_counter()
    probe = probe_mod.main(["--slots", ",".join(map(str, slots)), "--rounds", str(rounds)])
    probe_s = time.perf_counter() - t0
    launches, hm_launches = dm.launches, da.launches
    n1, n2, runs = dm.LAYERS, 5 * dm.LAYERS, max(3, 2 * rounds)
    want = len(slots) * (1 + (runs + 1) * (n1 + n2))  # parity, warm-up pair, timed pairs
    if launches != want or hm_launches != want:
        raise AssertionError(f"the probe launched the dmajor kernel {launches} times and the "
                             f"head-major kernel {hm_launches}; expected {want} each")
    log(f"probe ({probe_s:.1f} s): dmajor launches {launches}, head-major {hm_launches} "
        f"(= {len(slots)} x (1 + {runs + 1} x {n1 + n2})); {json.dumps(probe)}")
    DETAIL["dmajor_attention"] = {"max_abs_err": worst, "cases": list(cases),
                                  "split_checks": split_checks, "timings": timings,
                                  "split_sweep": sweep, "ladder": ladder,
                                  "probe": probe, "probe_s": probe_s,
                                  "launches": launches, "headmajor_launches": hm_launches}
    t = timings[8]
    return {"max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "device_ms": t["device_ms"], "headmajor_device_ms": t["headmajor_device_ms"],
            "shape": [8, NKV, D, W, "float32"], "launches": launches,
            "headmajor_splits": t["headmajor_splits"], "splits": t["splits"],
            "merge": "kernel" if t["splits"] > 1 else "none",
            "b32": {k: timings[32][k] for k in ("ms", "device_ms", "bound_ms",
                                                "headmajor_device_ms", "headmajor_splits",
                                                "splits")}}


# ---------------------------------------------------------------------------
# HTTP helpers
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, body: dict, timeout: float = 600) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _check_outputs(resp: dict, lens: list[int], vocab: int) -> list[list[int]]:
    outs = resp["outputs"]
    if len(outs) != len(lens):
        raise AssertionError(f"{len(outs)} outputs for {len(lens)} prompts")
    toks = []
    for i, (o, n) in enumerate(zip(outs, lens)):
        if o["name"] != f"output_ids_{i}" or o["datatype"] != "INT32":
            raise AssertionError(f"bad output header {o}")
        if o["shape"] != [n] or len(o["data"]) != n:
            raise AssertionError(f"output {i} has shape {o['shape']}, expected [{n}]")
        if not all(0 <= t < vocab for t in o["data"]):
            raise AssertionError(f"output {i} has ids outside [0, {vocab})")
        toks.append(o["data"])
    return toks


# ---------------------------------------------------------------------------
# Phase 4: the loader and the server entry point, in a subprocess
# ---------------------------------------------------------------------------


def phase_loader_subprocess() -> None:
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    loader = import_module(f"{PKG}.server.loader")
    cfg = llama.LlamaConfig.tiny(max_seq=64)
    params = llama.init(torch.Generator().manual_seed(5), cfg, dtype=torch.bfloat16)
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        art = loader.save_native_model(Path(tmp) / "tiny", "llama-generate", params,
                                       config=dataclasses.asdict(cfg))
        port, mport = _free_port(), _free_port()
        log_path = OUT_DIR / "server_subprocess.log"
        env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONWARNINGS="ignore")
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", f"{PKG}.server", "--model-uri", str(art),
                 "--quantize", "int8kv", "--host", "127.0.0.1", "--port", str(port),
                 "--max-slots", "2", "--prefill-chunk", "16", "--drain-s", "1",
                 "--metrics-port", str(mport), "--log-format", "json"],
                cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
            try:
                base = f"http://127.0.0.1:{port}"
                deadline = time.time() + 180
                while True:
                    if proc.poll() is not None:
                        raise AssertionError(f"server exited {proc.returncode}; see {log_path}")
                    try:
                        with urllib.request.urlopen(base + "/v2/health/ready", timeout=5) as r:
                            if r.status == 200:
                                break
                    except OSError:
                        pass
                    if time.time() > deadline:
                        raise AssertionError("server not ready within 180 s")
                    time.sleep(0.5)
                t0 = time.perf_counter()
                resp = _post(base + "/v2/models/model/generate",
                             {"prompt_ids": [[5, 9, 2], [7, 1, 4, 8, 3, 11, 17, 30, 2, 9,
                                                         40, 41, 42, 43, 44, 45, 46, 47]],
                              "max_new_tokens": 12})
                toks = _check_outputs(resp, [12, 12], cfg.vocab_size)
                log(f"loader + server subprocess (int8kv, tiny): 2 prompts -> 12 tokens each "
                    f"in {time.perf_counter() - t0:.2f} s")
                DETAIL["subprocess_tokens"] = toks
                DETAIL["subprocess_flags"] = _process_flags(proc, base, mport, log_path,
                                                            cfg.vocab_size)
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


def _process_flags(proc, base: str, mport: int, log_path: Path, vocab: int) -> dict:
    """The server process's flags: ``--metrics-port`` answers ``/metrics``;
    after SIGTERM ``/readyz`` is 503 while a generate sent inside the
    ``--drain-s 1`` lag is answered 200, then the process exits 0; every
    line of its ``--log-format json`` log parses, and the completion line
    carries the request id."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10) as r:
        if r.status != 200 or b"tpumlops_model_ready" not in r.read():
            raise AssertionError("the --metrics-port listener did not serve /metrics")
    proc.send_signal(signal.SIGTERM)
    t_sig = time.perf_counter()
    while _call("GET", base + "/readyz", timeout=5)[0] != 503:
        if time.perf_counter() - t_sig > 1.0:
            raise AssertionError("/readyz still 200 1 s after SIGTERM")
        time.sleep(0.02)
    not_ready_s = time.perf_counter() - t_sig
    req = urllib.request.Request(base + "/v2/models/model/generate",
                                 data=json.dumps({"prompt_ids": [5, 9, 2],
                                                  "max_new_tokens": 4}).encode(),
                                 headers={"Content-Type": "application/json",
                                          "X-Request-Id": "smoke-lag-1"})
    with urllib.request.urlopen(req, timeout=30) as r:
        _check_outputs(json.loads(r.read()), [4], vocab)
    answered_s = time.perf_counter() - t_sig
    if answered_s > 1.0:
        raise AssertionError(f"the lag's generate was answered {answered_s:.2f} s after "
                             "SIGTERM, past --drain-s 1")
    code = proc.wait(timeout=60)
    exit_s = time.perf_counter() - t_sig
    if code != 0:
        raise AssertionError(f"the server exited {code} after SIGTERM; see {log_path}")
    lines = [ln for ln in log_path.read_text().splitlines() if ln.strip()]
    try:
        records = [json.loads(ln) for ln in lines]
    except ValueError as e:
        raise AssertionError(f"--log-format json wrote a line that is no JSON ({e}); "
                             f"see {log_path}") from None
    done = [r_ for r_ in records if r_.get("request_id") == "smoke-lag-1"
            and r_.get("logger", "").endswith("server.requests")]
    if len(done) != 1 or "code=200" not in done[0]["message"]:
        raise AssertionError(f"no completion line with request_id smoke-lag-1: {done}")
    res = {"not_ready_after_s": not_ready_s, "lag_generate_answered_s": answered_s,
           "exit_after_s": exit_s, "json_lines": len(records),
           "wall_s": time.perf_counter() - t0}
    log(f"server flags: /metrics on --metrics-port; SIGTERM -> /readyz 503 after "
        f"{not_ready_s * 1e3:.0f} ms, a generate in the lag answered 200 after "
        f"{answered_s * 1e3:.0f} ms, exit 0 after {exit_s:.2f} s; {len(records)} log lines, "
        "all JSON, the completion line with its request id")
    return res


# ---------------------------------------------------------------------------
# Phase 5: Llama-2-7B at full width over /generate
# ---------------------------------------------------------------------------

PRNG_SEEDS = (0, 7, 2**31 - 1, 2**32 + 5, 2**63 - 1)


def _prng_checks(prng) -> dict:
    """The port's threefry on the card against the same code on the CPU:
    keys, splits, folds and bits identical, uniforms bit-equal, gumbels
    within 2 f32 ulp of max(|g|, 1) (the device's log)."""
    import numpy as np
    import torch

    worst = 0.0
    for seed in PRNG_SEEDS:
        got, want = {}, {}
        for dev, out in (("cuda", got), ("cpu", want)):
            k = prng.key(seed, dev)
            keys = prng.split(k, 4)
            out["key"] = k
            out["split"] = keys
            out["fold_in"] = prng.fold_in(keys, torch.arange(4, device=dev) * 977 + 1)
            out["bits"] = prng.random_bits(keys, (32000,))
            out["uniform"] = prng.uniform(keys, (32000,)).view(torch.int32)
            out["gumbel"] = prng.gumbel(keys, (32000,))
        for name in ("key", "split", "fold_in", "bits", "uniform"):
            if not torch.equal(got[name].cpu(), want[name]):
                raise AssertionError(f"threefry {name} differs between cuda and cpu at seed {seed}")
        g, w = got["gumbel"].cpu().numpy(), want["gumbel"].numpy()
        ulp = np.spacing(np.maximum(np.abs(w), 1.0).astype(np.float32))
        err = float((np.abs(g - w) / ulp).max())
        if err > 2.0:
            raise AssertionError(f"gumbel differs by {err} ulp at seed {seed}")
        worst = max(worst, err)
    log(f"threefry: key/split/fold_in/bits/uniform identical on cuda and cpu at seeds "
        f"{PRNG_SEEDS} ([4, 32000] draws); gumbel within {worst:.2f} ulp of max(|g|, 1)")
    return {"gumbel_max_ulp": worst}


def _generator_gumbel(gens):
    """The draw that the threefry draw replaced: one ``torch.rand`` a row
    from the row's own ``torch.Generator``, in ``prng.gumbel``'s place."""
    import torch

    tiny = torch.finfo(torch.float32).tiny

    def gumbel(keys, shape):
        out = torch.zeros(len(gens), *shape, device=keys.device)
        for i, gen in enumerate(gens):
            u = torch.rand(*shape, generator=gen, device=keys.device, dtype=torch.float32)
            out[i] = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        return out

    return gumbel


def _sampling_tick_cost(prng, sampling) -> dict:
    """What the threefry draw, and the whole sampling step, add to a decode
    tick at V = 32000: device ms and launches a call (profiler), the host's
    enqueue ms a call and the wall ms a call (synchronized).  The same for
    the per-row ``torch.Generator`` draw it replaced, and for that draw in
    the step in place of the key split and the threefry draw."""
    import torch

    out = {}
    names = ("threefry_draw", "sampling_step", "generator_draw", "generator_sampling_step",
             "argmax")
    for B in (1, 4):
        gen = torch.Generator(device="cuda").manual_seed(B)
        logits = torch.randn(B, 32000, device="cuda", generator=gen, dtype=torch.float32) * 3
        keys = prng.split(prng.key(1234, "cuda"), B)
        temps = torch.full((B,), 0.8, device="cuda")
        topk = torch.full((B,), 50, dtype=torch.int32, device="cuda")
        topp = torch.full((B,), 0.95, device="cuda")
        gens = [torch.Generator(device="cuda").manual_seed(1234 + i) for i in range(B)]
        gen_gumbel = _generator_gumbel(gens)

        def draw():
            _, use = sampling.split_keys(keys)
            return prng.gumbel(use, (32000,))

        def step():
            carry, use = sampling.split_keys(keys)
            return sampling.sample_logits(logits, use, temps, topk, topp)

        def gen_draw():
            return gen_gumbel(keys, (32000,))

        def gen_step():
            threefry_gumbel, prng.gumbel = prng.gumbel, gen_gumbel
            try:
                return sampling.sample_logits(logits, keys, temps, topk, topp)
            finally:
                prng.gumbel = threefry_gumbel

        def greedy():
            return torch.argmax(logits, dim=-1)

        for name, fn in zip(names, (draw, step, gen_draw, gen_step, greedy)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            iters = 50
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3 / iters
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
            launches: dict[str, int] = {}
            by_kernel, _ = profile_device(fn, iters=20, launches=launches)
            out[f"{name}_b{B}"] = {
                "device_ms": sum(by_kernel.values()) / 20,
                "launches": sum(launches.values()) / 20,
                "host_ms": host_ms, "wall_ms": wall_ms,
            }
        log(f"sampling at V=32000, B={B}: " + "; ".join(
            f"{n} device {out[f'{n}_b{B}']['device_ms']:.4f} ms, "
            f"{out[f'{n}_b{B}']['launches']:.0f} launches, host {out[f'{n}_b{B}']['host_ms']:.3f} ms, "
            f"wall {out[f'{n}_b{B}']['wall_ms']:.3f} ms"
            for n in names))
    return out


def _call(method: str, url: str, body=None, timeout: float = 600):
    """(status, parsed body, headers) of one HTTP call, errors included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status, headers = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, headers = e.read(), e.code, dict(e.headers)
    try:
        return status, json.loads(raw), headers
    except ValueError:
        return status, raw.decode(), headers


def _sse(port: int, path: str, body: dict, on_event=None) -> dict:
    """POST a streamed /generate and read its events as they arrive:
    tokens, indices, arrival times (perf_counter) and the final event."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t_send = time.perf_counter()
    conn.request("POST", path, json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"stream answered {resp.status}: {resp.read()[:200]}")
    out = {"t_send": t_send, "tokens": [], "indices": [], "times": [], "final": None,
           "event": ""}
    name = ""
    try:
        for raw in resp:
            line = raw.decode().rstrip("\r\n")
            if line.startswith("event: "):
                name = line[len("event: "):]
                continue
            if not line.startswith("data: "):
                continue
            payload = json.loads(line[len("data: "):])
            if payload.get("done"):
                out["final"], out["event"] = payload, name
                break
            out["times"].append(time.perf_counter())
            out["tokens"].append(payload["token"])
            out["indices"].append(payload["index"])
            if on_event is not None:
                on_event(len(out["tokens"]))
    finally:
        conn.close()
    if out["final"] is None or out["event"] == "error" or "error" in out["final"]:
        raise AssertionError(f"stream ended without its result: {out['final']}")
    if out["indices"] != list(range(len(out["tokens"]))):
        raise AssertionError(f"event indices {out['indices'][:8]}... are not 0..n-1")
    if out["final"]["output_ids"] != out["tokens"]:
        raise AssertionError("the done event's output_ids differ from the streamed tokens")
    return out


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _scrape(base: str) -> list[tuple[str, dict, float]]:
    """``/metrics`` as (sample name, labels, value)."""
    status, text, _ = _call("GET", base + "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    out = []
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m and not line.startswith("#"):
            out.append((m.group(1), dict(_LABEL.findall(m.group(2) or "")), float(m.group(3))))
    return out


def _value(samples, name: str, **labels) -> float:
    return sum(v for n, lab, v in samples
               if n == name and all(lab.get(k) == w for k, w in labels.items()))


def _percentile_ms(xs, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs) * 1e3, q))


def phase_serve_7b(da, rn, fa, smi: str, params) -> dict:
    """Llama-2-7B int8kv (``params``: the int8 weight tree) behind
    ``build_server``."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    prng = import_module(f"{PKG}.models.prng")
    sampling = import_module(f"{PKG}.models.sampling")
    app = import_module(f"{PKG}.server.app")

    prng_res = _prng_checks(prng)
    cfg = llama.LlamaConfig.llama2_7b()
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    config = app.ServerConfig(model_name="llama2-7b", host="127.0.0.1", port=0,
                              quantize="int8kv", max_slots=4, prefill_chunk=256,
                              device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = app.build_server(predictor, config)
    engine = srv.engine
    ttfts: list[float] = []
    metric_ttft = engine.on_ttft
    engine.on_ttft = lambda s: (ttfts.append(s), metric_ttft(s))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    base = f"http://127.0.0.1:{port}"
    path = "/v2/models/llama2-7b/generate"
    url = base + path
    rng = np.random.default_rng(7)
    srv2 = th2 = None
    try:
        # Warm-up request (first cuBLAS calls, allocator growth), as a
        # replica warms up before it reads ready; not measured.
        _post(url, {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})
        ttfts.clear()
        scrape0 = _scrape(base)
        disp0 = dict(engine.dispatches_total)
        dec0, pre0 = engine.decode_forwards, engine.prefill_forwards
        da.launches = 0
        rn.launches = 0
        fa.launches = 0

        t_single = time.perf_counter()
        single_prompt = rng.integers(1, cfg.vocab_size, 5).tolist()
        single = _post(url, {"prompt_ids": single_prompt, "max_new_tokens": 40})
        single_s = time.perf_counter() - t_single
        single_toks = _check_outputs(single, [40], cfg.vocab_size)[0]

        lens = (17, 130, 300, 700)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
        bodies = [{"prompt_ids": p, "max_new_tokens": 32} for p in prompts]
        bodies[1].update(temperature=0.8, top_k=40, top_p=0.95, seed=7)
        t_conc = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            resps = list(pool.map(lambda b: _post(url, b), bodies))
        conc_s = time.perf_counter() - t_conc
        conc_toks = [_check_outputs(r, [32], cfg.vocab_size)[0] for r in resps]
        torch.cuda.synchronize()

        da_launches, rn_launches, fa_launches = da.launches, rn.launches, fa.launches
        decodes = engine.decode_forwards - dec0
        forwards = decodes + engine.prefill_forwards - pre0
        disp = {k: engine.dispatches_total.get(k, 0) - disp0.get(k, 0)
                for k in engine.dispatches_total}
        if disp.get("decode", 0) != decodes:
            raise AssertionError(f"decode dispatches {disp} vs decode forwards {decodes}")
        if da_launches != cfg.num_layers * decodes or decodes == 0:
            raise AssertionError(
                f"decode attention launched {da_launches} times for {decodes} decode "
                f"dispatches; expected {cfg.num_layers} x {decodes}")
        if rn_launches != (2 * cfg.num_layers + 1) * forwards:
            raise AssertionError(
                f"rmsnorm launched {rn_launches} times for {forwards} forwards; "
                f"expected {2 * cfg.num_layers + 1} x {forwards}")
        if fa_launches != cfg.num_layers * (forwards - decodes):
            raise AssertionError(
                f"flash attention launched {fa_launches} times for {forwards - decodes} "
                f"prefill forwards; expected {cfg.num_layers} x {forwards - decodes}")
        log(f"7B serve: {decodes} decode dispatches, {forwards - decodes} prefill "
            f"forwards; decode attention {da_launches} launches (= {cfg.num_layers} x "
            f"{decodes}), rmsnorm {rn_launches} (= {2 * cfg.num_layers + 1} x {forwards}), "
            f"flash attention {fa_launches} (= {cfg.num_layers} x {forwards - decodes})")

        # A seeded sampled request streamed, then the same request not
        # streamed: the same tokens, by the event indices and the done event.
        seeded = {"prompt_ids": rng.integers(1, cfg.vocab_size, 24).tolist(),
                  "max_new_tokens": 32, "temperature": 0.8, "top_k": 50, "top_p": 0.95,
                  "seed": 1234}
        streamed = _sse(port, path, seeded)
        plain = _check_outputs(_post(url, seeded), [32], cfg.vocab_size)[0]
        if streamed["tokens"] != plain:
            raise AssertionError(f"streamed tokens {streamed['tokens'][:8]}... differ from "
                                 f"the answer without stream {plain[:8]}...")
        # Four such streams at once (seeds 1234-1237), every slot busy: the
        # ITL percentiles take every gap of every stream, the TTFTs every
        # stream's first event.
        with ThreadPoolExecutor(4) as pool:
            streams = list(pool.map(lambda i: _sse(port, path, {**seeded, "seed": 1234 + i}),
                                    range(4)))
        alone_itl = np.diff(streamed["times"])
        itl = np.concatenate([np.diff(st["times"]) for st in streams])
        ttft4 = [(st["times"][0] - st["t_send"]) * 1e3 for st in streams]
        stream_res = {
            "ttft_ms": (streamed["times"][0] - streamed["t_send"]) * 1e3,
            "alone_itl_p50_ms": _percentile_ms(alone_itl, 50),
            "alone_itl_max_ms": float(alone_itl.max() * 1e3), "alone_itl_n": len(alone_itl),
            "itl_p50_ms": _percentile_ms(itl, 50), "itl_p99_ms": _percentile_ms(itl, 99),
            "itl_n": len(itl), "ttft4_ms": ttft4,
            "tokens": streamed["tokens"],
        }
        log(f"7B stream: 24+32 tokens seeded (0.8/50/0.95/1234), equal to the answer "
            f"without stream; client TTFT {stream_res['ttft_ms']:.1f} ms, ITL p50 "
            f"{stream_res['alone_itl_p50_ms']:.2f} ms max {stream_res['alone_itl_max_ms']:.2f} "
            f"ms over its {len(alone_itl)} gaps. 4 streams at once: ITL p50 "
            f"{stream_res['itl_p50_ms']:.2f} ms p99 {stream_res['itl_p99_ms']:.2f} ms over "
            f"{len(itl)} gaps, TTFT ms {[round(t, 1) for t in ttft4]}")

        # /metrics against the answers since the scrape before.
        answers = ([single_toks] + conc_toks + [streamed["tokens"], plain]
                   + [st["tokens"] for st in streams])
        scrape1 = _scrape(base)
        fams = {}
        for name, labels in (
                ("tpumlops_generated_tokens_total", {}), ("tpumlops_ttft_seconds_count", {}),
                ("tpumlops_itl_seconds_count", {}), ("tpumlops_request_tokens_count", {}),
                ("seldon_api_executor_server_requests_seconds_count", {"code": "200"}),
                ("seldon_api_executor_client_requests_seconds_count", {})):
            fams[name] = _value(scrape1, name, **labels) - _value(scrape0, name, **labels)
        tokens = sum(len(a) for a in answers)
        want = {"tpumlops_generated_tokens_total": tokens,
                "tpumlops_ttft_seconds_count": len(answers),
                "tpumlops_itl_seconds_count": tokens - len(answers),
                "tpumlops_request_tokens_count": len(answers),
                "seldon_api_executor_server_requests_seconds_count": len(answers),
                "seldon_api_executor_client_requests_seconds_count": len(answers)}
        if fams != want:
            raise AssertionError(f"/metrics {fams} against the answers {want}")
        if _value(scrape1, "tpumlops_model_ready") != 1.0:
            raise AssertionError("tpumlops_model_ready is not 1")
        codes = {lab["code"] for n, lab, _ in scrape1
                 if n == "seldon_api_executor_server_requests_seconds_count"}
        if codes != {"200"}:
            raise AssertionError(f"answers by code {codes}, expected only 200")
        log(f"7B /metrics: {tokens} tokens, {len(answers)} requests: generated_tokens, "
            f"ttft/itl/request_tokens counts and the seldon counts equal the answers; "
            f"model_ready 1")

        # A lossless drain with a stream in flight.
        drain, probes = {}, {}

        def drain_call():
            t = time.perf_counter()
            drain["status"], drain["body"], _ = _call("POST", base + "/admin/drain",
                                                      {"grace_s": 120})
            drain["s"] = time.perf_counter() - t

        drainer = threading.Thread(target=drain_call)

        def on_event(n):
            if n != 1:
                return
            drainer.start()
            deadline = time.time() + 30
            while srv.lifecycle != "draining" and time.time() < deadline:
                time.sleep(0.001)
            probes["readyz"] = _call("GET", base + "/readyz")
            probes["shed"] = _call("POST", url, {"prompt_ids": [1, 2], "max_new_tokens": 2})

        shed0 = _value(_scrape(base), "tpumlops_engine_shed_total", reason="draining")
        drained_stream = _sse(port, path, {"prompt_ids": rng.integers(1, cfg.vocab_size, 8).tolist(),
                                           "max_new_tokens": 64}, on_event=on_event)
        drainer.join(timeout=180)
        rz_status, rz, _ = probes["readyz"]
        if rz_status != 503 or rz.get("lifecycle") != "draining" or rz.get("inFlight", 0) < 1:
            raise AssertionError(f"/readyz while draining: {rz_status} {rz}")
        sh_status, sh, sh_headers = probes["shed"]
        if sh_status != 429 or sh.get("reason") != "draining" or "Retry-After" not in sh_headers:
            raise AssertionError(f"/generate while draining: {sh_status} {sh} {sh_headers}")
        if len(drained_stream["tokens"]) != 64:
            raise AssertionError(f"the drained stream ended with {len(drained_stream['tokens'])} tokens")
        if drain.get("status") != 200 or drain["body"].get("drained") is not True:
            raise AssertionError(f"drain answered {drain}")
        c_status, c_body, _ = _call("POST", base + "/admin/drain", {"cancel": True})
        if c_status != 200 or _call("GET", base + "/readyz")[0] != 200:
            raise AssertionError(f"drain cancel: {c_status} {c_body}")
        after = _check_outputs(_post(url, {"prompt_ids": [4, 5, 6], "max_new_tokens": 4}),
                               [4], cfg.vocab_size)
        shed1 = _value(_scrape(base), "tpumlops_engine_shed_total", reason="draining")
        if shed1 - shed0 != 1:
            raise AssertionError(f"tpumlops_engine_shed_total{{reason=draining}} moved by {shed1 - shed0}")
        drain_res = {"drain_s": drain["s"], "drain_body": drain["body"], "readyz": rz,
                     "shed": sh, "after_cancel": after}
        log(f"7B drain: stream of 64 finished whole through the drain ({drain['s']:.2f} s, "
            f"{drain['body']}); /readyz 503 {rz}; 429 {sh['reason']} with Retry-After "
            f"{sh_headers.get('Retry-After')}; cancel restored 200s; shed counter +1")

        # Shed on budget: a second server on the same weights, one slot and
        # a budget one long prompt fills.
        budget = 1100
        config2 = dataclasses.replace(config, max_slots=1, admission_queue_budget=budget)
        srv2 = app.build_server(predictor, config2)
        engine2 = srv2.engine
        th2 = threading.Thread(target=srv2.serve_forever, daemon=True)
        th2.start()
        port2 = srv2.server_address[1]
        url2 = f"http://127.0.0.1:{port2}{path}"
        occupied = threading.Event()
        results: dict = {}

        def occupant():
            results["a"] = _sse(port2, path, {"prompt_ids": [3, 1, 4, 1, 5],
                                              "max_new_tokens": 64},
                                on_event=lambda n: occupied.set())

        ta = threading.Thread(target=occupant)
        ta.start()
        if not occupied.wait(120):
            raise AssertionError("the occupant stream sent no token")
        long_prompt = rng.integers(1, cfg.vocab_size, 1000).tolist()
        tb = threading.Thread(target=lambda: results.update(
            b=_post(url2, {"prompt_ids": long_prompt, "max_new_tokens": 32})))
        tb.start()
        deadline = time.time() + 30
        while engine2._queue.qsize() < 1 and time.time() < deadline:
            time.sleep(0.001)
        over = _call("POST", url2, {"prompt_ids": rng.integers(1, cfg.vocab_size, 100).tolist(),
                                    "max_new_tokens": 32})
        if over[0] != 429 or over[1].get("reason") != "budget" or "Retry-After" not in over[2]:
            raise AssertionError(f"a request over the budget answered {over[0]} {over[1]}")
        ta.join(timeout=300)
        tb.join(timeout=300)
        _check_outputs(results["b"], [32], cfg.vocab_size)
        if len(results["a"]["tokens"]) != 64:
            raise AssertionError("the occupant stream lost tokens")
        oversized = _post(url2, {"prompt_ids": rng.integers(1, cfg.vocab_size, 1200).tolist(),
                                 "max_new_tokens": 32})  # est 1232 > budget, queue empty
        _check_outputs(oversized, [32], cfg.vocab_size)
        shed_budget = _value(_scrape(f"http://127.0.0.1:{port2}"), "tpumlops_engine_shed_total",
                             reason="budget")
        if shed_budget != 1:
            raise AssertionError(f"tpumlops_engine_shed_total{{reason=budget}} is {shed_budget}")
        log(f"7B budget shed (1 slot, budget {budget}): 429 {over[1]['reason']} with "
            f"Retry-After {over[2].get('Retry-After')} while a stream ran and 1032 tokens "
            f"queued; an oversized request (1232) on the idle engine admitted")

        # The launch counts hold over every request since the reset, both
        # servers' engines together.
        torch.cuda.synchronize()
        all_decodes = (engine.decode_forwards - dec0) + engine2.decode_forwards
        all_forwards = all_decodes + (engine.prefill_forwards - pre0) + engine2.prefill_forwards
        if da.launches != cfg.num_layers * all_decodes:
            raise AssertionError(f"decode attention launched {da.launches} times for "
                                 f"{all_decodes} decode dispatches")
        if rn.launches != (2 * cfg.num_layers + 1) * all_forwards:
            raise AssertionError(f"rmsnorm launched {rn.launches} times for {all_forwards} forwards")
        all_prefills = all_forwards - all_decodes
        if fa.launches != cfg.num_layers * all_prefills:
            raise AssertionError(f"flash attention launched {fa.launches} times for "
                                 f"{all_prefills} prefill forwards")
        da_launches, rn_launches, fa_launches = da.launches, rn.launches, fa.launches
        log(f"7B serve, every request of the phase: decode attention {da_launches} launches "
            f"(= {cfg.num_layers} x {all_decodes}), rmsnorm {rn_launches} "
            f"(= {2 * cfg.num_layers + 1} x {all_forwards}), flash attention {fa_launches} "
            f"(= {cfg.num_layers} x {all_prefills})")
        srv2.shutdown_all()
        th2.join(timeout=30)
        srv2 = None

        # Teacher-forced agreement of a greedy request with its own output.
        p, o = prompts[2], conc_toks[2]
        ids = torch.tensor([p + o[:-1]], dtype=torch.int64, device="cuda")
        logits, _ = llama.prefill(params, ids, cfg, torch.bfloat16)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("teacher-forced logits are not finite")
        pred = torch.argmax(logits[0, len(p) - 1:], dim=-1).tolist()
        agreement = float(np.mean([a == b for a, b in zip(pred, o)]))

        tick = _sampling_tick_cost(prng, sampling)
        ttft_main = list(ttfts)[:5]
        # Where the time goes: device time by kernel over one request of
        # 5 prompt + 16 new tokens (one prefill chunk, 15 decode steps).
        # The profiler slows the host, so the idle share divides the device
        # busy time by the wall of the same request run without it.
        body16 = {"prompt_ids": single_prompt, "max_new_tokens": 16}
        t_plain = time.perf_counter()
        _post(url, body16)
        plain_wall_ms = (time.perf_counter() - t_plain) * 1e3
        prof, wall_ms = profile_device(lambda: _post(url, body16), iters=1,
                                       hold=engine.between_ticks)
        busy_ms = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:15]
        log(f"7B profile (1 request, 5+16 tokens): wall {plain_wall_ms:.1f} ms unprofiled "
            f"({wall_ms:.1f} ms profiled), device busy {busy_ms:.1f} ms, idle share "
            f"{1 - busy_ms / plain_wall_ms:.3f}")
        for name, ms_ in top[:8]:
            log(f"  {ms_:9.3f} ms  {name[:110]}")

        res = {
            "profile_wall_ms": wall_ms,
            "unprofiled_wall_ms": plain_wall_ms,
            "profile_busy_ms": busy_ms,
            "profile_top": top,
            "single_request_s": single_s,
            "single_tokens_per_s": 40 / single_s,
            "concurrent_s": conc_s,
            "concurrent_tokens_per_s": 32 * len(lens) / conc_s,
            "ttft_s": ttft_main,
            "token_agreement": agreement,
            "decode_dispatches": decodes,
            "prefill_forwards": forwards - decodes,
            "dispatches": disp,
            "da_launches": da_launches,
            "rn_launches": rn_launches,
            "fa_launches": fa_launches,
            "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "single_tokens": single_toks,
            "prng": prng_res,
            "stream": stream_res,
            "drain": drain_res,
            "sampling_tick": tick,
        }
        log(f"7B serve: single request 5+40 tokens in {single_s:.3f} s "
            f"({40 / single_s:.2f} tok/s); 4 concurrent (17/130/300/700 + 32) in "
            f"{conc_s:.3f} s ({32 * len(lens) / conc_s:.2f} tok/s)")
        log(f"7B serve: TTFT s {[round(t, 4) for t in ttft_main]}; token_agreement "
            f"(greedy 300-token prompt, teacher-forced) {agreement:.3f}; peak "
            f"{res['max_memory_gib']:.2f} GiB")
        summary = {
            "tok_s_single": 40 / single_s, "tok_s_concurrent": 32 * len(lens) / conc_s,
            "itl_p50_ms": stream_res["itl_p50_ms"], "itl_p99_ms": stream_res["itl_p99_ms"],
            "itl_n": stream_res["itl_n"], "alone_itl_p50_ms": stream_res["alone_itl_p50_ms"],
            "alone_itl_max_ms": stream_res["alone_itl_max_ms"],
            "ttft_ms": stream_res["ttft_ms"], "drain_s": drain["s"],
            "sampling_tick_ms": tick["sampling_step_b4"]["wall_ms"],
            "generator_sampling_tick_ms": tick["generator_sampling_step_b4"]["wall_ms"],
        }
        log(f"7B summary: {json.dumps(summary)} on {smi}")
        DETAIL["serve_7b"] = res
        return res
    finally:
        if srv2 is not None:
            srv2.shutdown_all()
            th2.join(timeout=30)
        srv.shutdown_all()
        th.join(timeout=30)


def _verify_vs_sequential(llama, params, cfg, S: int = 5, device: str = "cuda",
                          dtype=None) -> dict:
    """``verify_ragged`` at Llama-2-7B (int8 weights, int8 KV cache) against
    S sequential ``decode_ragged`` steps on the same card: four rows at
    lengths 300, 517, 64 and 1, the chunk the tokens the sequential steps
    fed, activations in ``dtype`` (bf16 by default).  Reports the argmax
    agreement per position and the largest logit difference (near-ties
    of the random weights' flat logits may flip)."""
    import numpy as np
    import torch
    from importlib import import_module

    dtype = dtype or torch.bfloat16
    cfg_s = dataclasses.replace(cfg, max_seq=1024)
    gen_mod = import_module(f"{PKG}.server.generation")
    rng = np.random.default_rng(31)
    lens = [300, 517, 64, 1]
    B = len(lens)
    seq_cache = llama.QuantRaggedKVCache.create(cfg_s, B, device)
    ver_cache = llama.QuantRaggedKVCache.create(cfg_s, B, device)
    first = []
    for b, n in enumerate(lens):
        ids = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, n)), device=device)
        logits, seq = llama.prefill(params, ids, cfg_s, dtype)
        seq_cache = llama.insert_sequence(seq_cache, seq, b, n)
        ver_cache = llama.insert_sequence(ver_cache, seq, b, n)
        first.append(int(torch.argmax(logits[0, n - 1])))
        del logits, seq
    window = gen_mod.decode_window_bucket(max(lens) + S, cfg_s.max_seq)
    active = torch.ones((B,), dtype=torch.bool, device=device)
    feed = torch.tensor(first, device=device)[:, None]
    fed, seq_logits = [], []
    for _ in range(S):
        fed.append(feed)
        lg, seq_cache = llama.decode_ragged(params, feed, seq_cache, cfg_s, active,
                                            dtype, window)
        seq_logits.append(lg[:, 0].float())
        feed = torch.argmax(lg[:, -1], dim=-1)[:, None]
    vlogits, _ = llama.verify_ragged(params, torch.cat(fed, dim=1), ver_cache, cfg_s,
                                     dtype, window, active)
    torch.cuda.synchronize()
    seq_l = torch.stack(seq_logits, dim=1)
    if not bool(torch.isfinite(vlogits).all()):
        raise AssertionError("verify logits are not finite")
    agree = (vlogits.argmax(-1) == seq_l.argmax(-1)).float().mean().item()
    res = {"S": S, "dtype": str(dtype).replace("torch.", ""), "lengths": lens,
           "window": window, "argmax_agreement": agree,
           "max_abs_logit_diff": float((vlogits - seq_l).abs().max()),
           "max_abs_logit": float(seq_l.abs().max())}
    del seq_cache, ver_cache
    torch.cuda.empty_cache()
    return res


def phase_serve_7b_spec(da, rn, fa, smi: str, params, device: str = "cuda") -> dict:
    """Phase 5c: Llama-2-7B int8kv (``params``: the int8 weight tree) with
    the radix prefix cache (budget 512 MiB = four 256-token chunks, host L2
    256 MiB) and self-speculative n-gram decoding (4 draft tokens, n-grams
    1..4, adaptive) behind ``build_server``: a cold 768 + 100-token prompt,
    a warm one on the same prefix, the cold one again (equal tokens), a
    second prefix whose write-back evicts the first into the L2, the first
    once more (promoted from the L2, equal tokens), four concurrent
    repeated-pattern prompts that draft, and a seeded sampled stream beside
    them (equal to its answer without stream), and an oracle drafter on
    four short prompts that must accept drafts in fewer decode + verify
    ticks than tokens (its agreement with speculation off reported, in
    bf16 and on an f32 engine).  The counters on /metrics
    equal the engine's and the values the radix rules give; flash = 32 x
    prefill forwards, decode attention = 32 x (decode + verify ticks),
    RMSNorm = 65 x forwards.  ``device`` is the card, or the CPU for a
    rehearsal of the phase at a small configuration."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    app = import_module(f"{PKG}.server.app")
    gen_mod = import_module(f"{PKG}.server.generation")
    spec_mod = import_module(f"{PKG}.server.speculative")
    cfg = llama.LlamaConfig.llama2_7b()
    vs_seq = [_verify_vs_sequential(llama, params, cfg, device=device, dtype=dt)
              for dt in (torch.bfloat16, torch.float32)]
    for r in vs_seq:
        log(f"7B verify vs sequential decode (int8kv, {r['dtype']} activations, S={r['S']}, "
            f"lengths {r['lengths']}, W={r['window']}): argmax agreement "
            f"{r['argmax_agreement']:.3f}, max |logit diff| {r['max_abs_logit_diff']:.4f} "
            f"(max |logit| {r['max_abs_logit']:.2f})")

    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    config = app.ServerConfig(
        model_name="llama2-7b", host="127.0.0.1", port=0, quantize="int8kv", max_slots=4,
        prefill_chunk=256, device=device, prefix_cache=True, prefix_cache_budget_mb=512,
        prefix_cache_l2_budget_mb=256, speculative=True, speculative_draft_tokens=4,
        speculative_ngram_min=1, speculative_ngram_max=4, speculative_adaptive=True)
    torch.cuda.empty_cache()
    srv = app.build_server(predictor, config)
    engine = srv.engine
    ttfts: list[float] = []
    metric_ttft = engine.on_ttft
    engine.on_ttft = lambda s_: (ttfts.append(s_), metric_ttft(s_))
    ticks: dict[str, list[float]] = {}
    metric_tick = engine.on_tick
    engine.on_tick = lambda k, s_: (ticks.setdefault(k, []).append(s_), metric_tick(k, s_))
    seeds: list[dict] = []
    real_seed = engine._device_seed

    def timed_seed(cached_kv, length):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_seed(cached_kv, length)
        torch.cuda.synchronize()
        seeds.append({"ms": (time.perf_counter() - t) * 1e3, "chunks": len(cached_kv),
                      "pinned": all(k.is_pinned() and v.is_pinned() for k, v in cached_kv)})

    engine._device_seed = timed_seed
    verifies: list[tuple[int, int]] = []  # (active slots, accepted draft tokens) a verify tick
    real_verify = engine._device_verify

    def counted_verify(toks, active_np, draft_len, window):
        greedy, accepted = real_verify(toks, active_np, draft_len, window)
        verifies.append((int(active_np.sum()), int(accepted[active_np].sum())))
        return greedy, accepted

    engine._device_verify = counted_verify
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    base = f"http://127.0.0.1:{port}"
    path = "/v2/models/llama2-7b/generate"
    url = base + path
    rng = np.random.default_rng(29)
    V, L = cfg.vocab_size, cfg.num_layers
    names = ("hits", "cached_tokens", "evictions", "l2_hits", "l2_spills", "l2_evictions")

    def counters():
        c = engine._prefix_cache
        return {"hits": engine.prefix_hits, "cached_tokens": engine.prefix_cached_tokens,
                "evictions": engine.prefix_evictions, "l2_hits": c.l2_hits,
                "l2_spills": c.l2_spills, "l2_evictions": c.l2_evictions}

    try:
        _post(url, {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up, not measured
        ttfts.clear()
        ticks.clear()
        verifies.clear()
        scrape0 = _scrape(base)
        c0 = counters()
        spec0 = (engine.spec_verify_ticks, engine.spec_proposed_tokens,
                 engine.spec_accepted_tokens)
        dec0, pre0 = engine.decode_forwards, engine.prefill_forwards
        da.launches = da.verify_launches = rn.launches = fa.launches = 0

        p1, p2 = (rng.integers(1, V, 768).tolist() for _ in range(2))
        s1, s2, s3 = (rng.integers(1, V, 100).tolist() for _ in range(3))

        def greedy(prompt, n=16):
            return _check_outputs(_post(url, {"prompt_ids": prompt, "max_new_tokens": n}),
                                  [n], V)[0]

        def delta():
            c = counters()
            return {k: c[k] - c0[k] for k in names}

        cold = greedy(p1 + s1)
        if delta() != dict.fromkeys(names, 0):
            raise AssertionError(f"a cold admission moved the prefix cache: {delta()}")
        warm = greedy(p1 + s2)
        again = greedy(p1 + s1)
        if again != cold:
            raise AssertionError(f"the warm repeat {again} differs from the cold answer {cold}")
        greedy(p2 + s3)
        after_l2 = greedy(p1 + s1)
        if after_l2 != cold:
            raise AssertionError(f"the L2-promoted answer {after_l2} differs from the cold one "
                                 f"{cold}")
        # The radix rules on this sequence (128 MiB chunks, 4 in the tree,
        # 2 in the L2): three hits of three chunks; P2's write-back evicts
        # P1's last two chunks into the L2; the fourth A promotes both back,
        # spilling P2's last two.
        want5 = {"hits": 3, "cached_tokens": 3 * 768, "evictions": 4, "l2_hits": 2,
                 "l2_spills": 4, "l2_evictions": 0}
        if delta() != want5:
            raise AssertionError(f"prefix cache after the five prompts {delta()}, expected {want5}")
        ttft_a = {"cold_s": ttfts[0], "warm_s": ttfts[1], "repeat_s": ttfts[2],
                  "l2_s": ttfts[4], "other_prefix_cold_s": ttfts[3]}

        # Four repeated-pattern prompts that draft, and a seeded sampled
        # stream beside them: it is admitted first, and while it runs every
        # tick has a sampling slot and is plain; the fourth pattern prompt
        # waits for its slot.
        patterns = [rng.integers(1, V, 64).tolist() * 4 for _ in range(4)]
        seeded = {"prompt_ids": rng.integers(1, V, 24).tolist(), "max_new_tokens": 16,
                  "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 4321}
        spec_results: dict = {}
        first_event = threading.Event()

        def spec_one(i):
            spec_results[i] = _check_outputs(
                _post(url, {"prompt_ids": patterns[i], "max_new_tokens": 48}), [48], V)[0]

        def stream_one():
            spec_results["stream"] = _sse(port, path, seeded,
                                          on_event=lambda n: first_event.set())

        streamer = threading.Thread(target=stream_one)
        streamer.start()
        if not first_event.wait(120):
            raise AssertionError("the seeded stream sent no token")
        t_spec = time.perf_counter()
        workers = [threading.Thread(target=spec_one, args=(i,)) for i in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        spec_s = time.perf_counter() - t_spec
        streamer.join(timeout=600)
        streamed = spec_results["stream"]
        spec_toks = [spec_results[i] for i in range(4)]
        plain = _check_outputs(_post(url, seeded), [16], V)[0]
        if streamed["tokens"] != plain:
            raise AssertionError(f"streamed tokens {streamed['tokens'][:8]}... differ from the "
                                 f"answer without stream {plain[:8]}...")
        # Each pattern prompt is one full chunk: four inserts, each evicting
        # the LRU leaf into the L2, which ages out its four oldest.
        want = {"hits": 3, "cached_tokens": 3 * 768, "evictions": 8, "l2_hits": 2,
                "l2_spills": 8, "l2_evictions": 4}
        if delta() != want:
            raise AssertionError(f"prefix cache after the phase {delta()}, expected {want}")
        spec1 = (engine.spec_verify_ticks, engine.spec_proposed_tokens,
                 engine.spec_accepted_tokens)
        verify_ticks, proposed, accepted = (b - a for a, b in zip(spec0, spec1))
        if proposed <= 0 or verify_ticks <= 0:
            raise AssertionError(f"no draft was verified: {verify_ticks} verify ticks, "
                                 f"{proposed} proposed")
        traffic_verifies = list(verifies)

        # An oracle drafter, so that drafts are accepted on the card (random
        # weights repeat no n-gram): four short prompts answered with
        # speculation off (the drafter proposing nothing, so every tick is
        # the plain decode), then again with a drafter that proposes those
        # answers.  Accepted drafts, several tokens a slot a verify tick and
        # the commit of accepted + 1 positions decide the served tokens.
        oracle_prompts = [rng.integers(1, V, 40).tolist() for _ in range(4)]
        n_oracle = 24
        real_propose = engine._propose
        engine._propose = lambda slot, budget: []
        refs = {tuple(p): greedy(p, n_oracle) for p in oracle_prompts}

        def oracle_for(refs, fallback):
            def propose(slot, budget):
                ref = refs.get(tuple(slot.history[:slot.prompt_len].tolist()))
                if ref is None:
                    return fallback(slot, budget)
                g = len(slot.generated)
                return ref[g:g + budget]
            return propose

        engine._propose = oracle_for(refs, real_propose)
        dec1 = engine.decode_forwards
        try:
            oracle_out = [greedy(p, n_oracle) for p in oracle_prompts]
        finally:
            engine._propose = real_propose
        oracle_ticks = engine.decode_forwards - dec1
        o_verify, o_proposed, o_accepted = (
            b - a for a, b in zip(spec1, (engine.spec_verify_ticks, engine.spec_proposed_tokens,
                                          engine.spec_accepted_tokens)))
        o_tokens = len(oracle_prompts) * (n_oracle - 1)  # after each prefill's token
        if o_accepted <= 0 or oracle_ticks >= o_tokens:
            raise AssertionError(f"the oracle drafter: {o_accepted} of {o_proposed} accepted, "
                                 f"{oracle_ticks} decode + verify ticks for {o_tokens} tokens")
        o_agree = [float(np.mean([a == b for a, b in zip(o, refs[tuple(p)])]))
                   for p, o in zip(oracle_prompts, oracle_out)]
        o_slots = sum(a for a, _ in verifies[len(traffic_verifies):])
        oracle_res = {
            "requests": len(oracle_prompts), "new_tokens": n_oracle, "ticks": oracle_ticks,
            "verify_ticks": o_verify, "proposed": o_proposed, "accepted": o_accepted,
            "acceptance_rate": o_accepted / max(o_proposed, 1),
            "tokens_per_verify_slot": (o_slots + o_accepted) / max(o_slots, 1),
            "agreement_with_speculation_off": o_agree}
        log(f"7B spec, oracle drafter: {o_accepted}/{o_proposed} accepted in {o_verify} verify "
            f"ticks, {oracle_res['tokens_per_verify_slot']:.3f} tokens a slot a verify tick, "
            f"{oracle_ticks} decode + verify ticks for {o_tokens} tokens; agreement with the "
            f"answers with speculation off {[round(a, 3) for a in o_agree]}")
        if delta() != want:
            raise AssertionError(f"the oracle prompts moved the prefix cache: {delta()}")
        torch.cuda.synchronize()
        da_launches, rn_launches, fa_launches = da.launches, rn.launches, fa.launches
        va_launches = da.verify_launches
        decodes = engine.decode_forwards - dec0  # decode and verify ticks
        verifies = engine.spec_verify_ticks - spec0[0]
        prefills = engine.prefill_forwards - pre0
        if da_launches != L * decodes or fa_launches != L * prefills or \
                rn_launches != (2 * L + 1) * (decodes + prefills) or \
                va_launches != L * verifies or verifies == 0:
            raise AssertionError(
                f"7B spec: launches decode {da_launches} (verify {va_launches}), flash "
                f"{fa_launches}, rmsnorm {rn_launches} for {decodes} decode + verify ticks "
                f"({verifies} verify) and {prefills} prefill forwards")

        scrape1 = _scrape(base)

        def moved(name):
            return _value(scrape1, name) - _value(scrape0, name)

        on_metrics = {
            "hits": moved("tpumlops_prefix_cache_hits_total"),
            "cached_tokens": moved("tpumlops_prefix_cache_cached_tokens_total"),
            "evictions": moved("tpumlops_prefix_cache_evictions_total"),
            "l2_hits": moved("tpumlops_prefix_cache_l2_hits_total"),
            "l2_spills": moved("tpumlops_prefix_cache_l2_spills_total"),
            "l2_evictions": moved("tpumlops_prefix_cache_l2_evictions_total"),
        }
        if on_metrics != delta():
            raise AssertionError(f"/metrics prefix counters {on_metrics} != engine {delta()}")
        spec_metrics = (moved("tpumlops_spec_proposed_tokens_total"),
                        moved("tpumlops_spec_accepted_tokens_total"))
        spec_engine = (proposed + o_proposed, accepted + o_accepted)
        if spec_metrics != spec_engine:
            raise AssertionError(f"/metrics spec counters {spec_metrics} != engine "
                                 f"{spec_engine}")
        if moved("tpumlops_engine_dispatches_total") != sum(len(v) for v in ticks.values()):
            raise AssertionError("tpumlops_engine_dispatches moved by other than the ticks")
        log(f"7B spec: {decodes} decode + verify ticks ({verify_ticks + o_verify} verify), "
            f"{prefills} prefill forwards, {len(seeds)} seeds; decode attention {da_launches} "
            f"launches (= {L} x {decodes}), flash {fa_launches} (= {L} x {prefills}), rmsnorm "
            f"{rn_launches} (= {2 * L + 1} x {decodes + prefills}); prefix counters "
            f"{delta()} equal /metrics and the radix rules; spec {spec_engine[0]} proposed, "
            f"{spec_engine[1]} accepted, equal /metrics")

        # One verify tick against one plain decode tick of this server's
        # engine, stopped first (the probe runs its device steps from this
        # thread), all rows inactive (nothing is written), at the window of
        # a 900-token row.
        srv.shutdown_all()
        th.join(timeout=30)
        window = 1024
        idle = np.zeros((engine.max_slots,), dtype=bool)
        toks = np.zeros((engine.max_slots, 5), np.int32)
        zero = np.zeros((engine.max_slots,), np.int32)

        def one_verify():
            real_verify(toks, idle, zero, window)

        def one_decode():
            engine._device_step(idle, window, False)
            engine._tokens[:, 0].cpu()

        tick_cost = {}
        for name, fn in (("verify_s5", one_verify), ("decode", one_decode)):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3 / 5
            prof, _ = profile_device(fn, iters=3)
            tick_cost[name] = {"wall_ms": wall_ms, "device_ms": sum(prof.values()) / 3}

        # The oracle again with f32 activations, on an engine of its own
        # (the four prompts at once, speculation off, then on): there verify
        # and decode agree on the argmax (see vs_seq), so the bf16 run's
        # near-tie flips should be gone.  Reported.
        eng32 = gen_mod.GenerationEngine(
            params, cfg, max_slots=4, dtype=torch.float32, kv_quant=True, prefill_chunk=256,
            device=device, speculative=spec_mod.SpeculativeConfig(
                enabled=True, draft_tokens=4, ngram_min=1, ngram_max=4, adaptive=True))
        eng32.start()
        try:
            eng32._propose = lambda slot, budget: []
            futs = [eng32.submit(p, n_oracle) for p in oracle_prompts]
            refs32 = {tuple(p): f.result(timeout=600).tolist()
                      for p, f in zip(oracle_prompts, futs)}
            eng32._propose = oracle_for(refs32, lambda slot, budget: [])
            before = (eng32.spec_verify_ticks, eng32.spec_proposed_tokens,
                      eng32.spec_accepted_tokens)
            futs = [eng32.submit(p, n_oracle) for p in oracle_prompts]
            out32 = [f.result(timeout=600).tolist() for f in futs]
            v32, p32, a32 = (b - a for a, b in zip(before, (
                eng32.spec_verify_ticks, eng32.spec_proposed_tokens,
                eng32.spec_accepted_tokens)))
        finally:
            eng32.shutdown()
        del eng32
        torch.cuda.empty_cache()
        oracle_res["f32"] = {
            "verify_ticks": v32, "proposed": p32, "accepted": a32,
            "agreement_with_speculation_off": [
                float(np.mean([a == b for a, b in zip(o, refs32[tuple(p)])]))
                for p, o in zip(oracle_prompts, out32)]}
        log(f"7B spec, oracle drafter with f32 activations (one engine, the four prompts at "
            f"once): {a32}/{p32} accepted in {v32} verify ticks; agreement with the answers "
            f"with speculation off {oracle_res['f32']['agreement_with_speculation_off']}")

        # Teacher-forced agreement of the speculative answers.
        agree = []
        for p, o in zip(patterns, spec_toks):
            ids = torch.tensor([p + o[:-1]], dtype=torch.int64, device=device)
            logits, _ = llama.prefill(params, ids, cfg, torch.bfloat16)
            pred = torch.argmax(logits[0, len(p) - 1:], dim=-1).tolist()
            agree.append(float(np.mean([a == b for a, b in zip(pred, o)])))
            del logits
        slot_verifies = sum(a for a, _ in traffic_verifies)
        seed_chunk_ms = [s["ms"] / s["chunks"] for s in seeds]
        res = {
            "verify_vs_sequential": vs_seq,
            "ttft": ttft_a,
            "seeds": seeds, "seed_ms_per_chunk": seed_chunk_ms,
            "seed_pinned": all(s["pinned"] for s in seeds),
            "prefix_counters": delta(),
            "verify_ticks": verify_ticks, "proposed": proposed, "accepted": accepted,
            "acceptance_rate": accepted / proposed,
            "tokens_per_verify_slot": (slot_verifies + sum(a for _, a in traffic_verifies))
            / max(slot_verifies, 1),
            "oracle": oracle_res,
            "tick_wall_ms": {k: float(np.median(v)) * 1e3 for k, v in ticks.items()},
            "tick_count": {k: len(v) for k, v in ticks.items()},
            "tick_cost": tick_cost,
            "spec_tokens_per_s": 4 * 48 / spec_s, "spec_s": spec_s,
            "token_agreement": agree,
            "decode_ticks": decodes, "prefill_forwards": prefills,
            "da_launches": da_launches, "rn_launches": rn_launches, "fa_launches": fa_launches,
            "va_launches": va_launches, "warm_tokens": warm, "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        log(f"7B spec: TTFT of A cold {ttft_a['cold_s'] * 1e3:.1f} ms, warm (768 cached) "
            f"{ttft_a['warm_s'] * 1e3:.1f} ms, repeat {ttft_a['repeat_s'] * 1e3:.1f} ms, after "
            f"the L2 {ttft_a['l2_s'] * 1e3:.1f} ms; seed {[round(x, 2) for x in seed_chunk_ms]} "
            f"ms a 128 MiB chunk (pinned {res['seed_pinned']})")
        log(f"7B spec: {verify_ticks} verify ticks, {res['tokens_per_verify_slot']:.3f} tokens "
            f"a slot a verify tick, acceptance {res['acceptance_rate']:.3f} ({accepted}/"
            f"{proposed}); tick wall median ms {json.dumps(res['tick_wall_ms'])}; one tick at "
            f"W=1024, 4 idle rows: {json.dumps(tick_cost)}; 4 x 48 tokens in {spec_s:.2f} s "
            f"({res['spec_tokens_per_s']:.2f} tok/s); token_agreement "
            f"{[round(a, 3) for a in agree]} on {smi}")
        DETAIL["serve_7b_spec"] = res
        return res
    finally:
        srv.shutdown_all()
        th.join(timeout=30)


def _packed_server(app, predictor, quantize: str, prefill_batch: int, prefix_cache: bool,
                   device: str):
    """A Llama-2-7B server with 4 slots and prefill chunks of 256, packed
    (``prefill_batch`` 4) or serial (1), serving on a thread; returns (srv,
    thread, base url, TTFT list fed by the engine's hook)."""
    config = app.ServerConfig(
        model_name="llama2-7b", host="127.0.0.1", port=0, quantize=quantize, max_slots=4,
        prefill_chunk=256, prefill_batch=prefill_batch, prefill_token_budget=0, device=device,
        prefix_cache=prefix_cache, prefix_cache_budget_mb=2048)
    srv = app.build_server(predictor, config)
    ttfts: list[float] = []
    metric_ttft = srv.engine.on_ttft
    srv.engine.on_ttft = lambda s_: (ttfts.append(s_), metric_ttft(s_))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{srv.server_address[1]}", ttfts


def _burst(url: str, prompts, n: int, vocab: int) -> list[list[int]]:
    """The prompts as concurrent /generate requests, n greedy tokens each."""
    with ThreadPoolExecutor(len(prompts)) as pool:
        resps = list(pool.map(lambda p: _post(url, {"prompt_ids": p, "max_new_tokens": n}),
                              prompts))
    return [_check_outputs(r, [n], vocab)[0] for r in resps]


def _agreement(a, b) -> float:
    import numpy as np

    return float(np.mean([x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb)]))


def _ragged_at_burst(fa, rows_seen, capacity: int, n_rows: int) -> list[dict]:
    """The ragged kernel at the slots and offsets of phase 5d's own packed
    burst forwards (each distinct B_p >= 2 set once; int8 cache of the
    engine's rows and capacity, random codes, C 256, H = NKV = 32, D 128):
    checked against its plain version (FLASH_TOL) and timed beside the
    plain version and the bound, the cache rotating over 4 layers."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1357)
    out, seen, layers = [], set(), 4
    for slots, offsets in rows_seen:
        if len(slots) < 2 or (tuple(slots), tuple(offsets)) in seen:
            continue
        seen.add((tuple(slots), tuple(offsets)))
        c = _ragged_case(gen, len(slots), 256, 32, 32, offsets, slots, n_rows, True,
                         T=capacity, layers=layers)
        err = _ragged_check(fa, c, f"burst slots={slots} offsets={offsets}")
        views = [_ragged_args(c, l) for l in range(layers)]
        it = {"i": 0}

        def rot(f):
            def call():
                it["i"] += 1
                return f(*views[it["i"] % layers])
            return call

        nbytes, flops = _ragged_work(c)
        bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        out.append({"slots": slots, "offsets": offsets, "max_abs_err": err,
                    "ms": cuda_time_ms(rot(fa.flash_attention_ragged), iters=50),
                    "device_ms": kernel_device_ms(rot(fa.flash_attention_ragged),
                                                  "flash_ragged_kernel"),
                    "plain_ms": cuda_time_ms(rot(fa.flash_attention_ragged_reference), iters=5),
                    "bound_ms": bound_ms, "bound_by": bound_by})
        del c, views
    log("ragged flash at the burst's packed forwards (int8 cache, C=256, H=NKV=32, D=128; "
        "offsets: device ms, bound ms, max_abs_err): " + json.dumps(
            {str(r["offsets"]): [r["device_ms"] and round(r["device_ms"], 4),
                                 round(r["bound_ms"], 4), float(f"{r['max_abs_err']:.3e}")]
             for r in out}))
    return out


def phase_serve_7b_packed(da, rn, fa, smi: str, params, device: str = "cuda",
                          layers: int | None = None) -> dict:
    """Phase 5d: packed multi-admission prefill at Llama-2-7B int8kv
    (``params``: the int8 weight tree), 4 slots, chunks of 256,
    ``prefill_batch`` 4, no token budget, the prefix cache on (2 GiB, so
    nothing is evicted), speculation off.  A prompt P of the 1000-token
    burst prompt's first 768 tokens plus 100 of its own, answered cold and
    then warm (its three chunks seeded into the reserved row): the warm
    answer must equal the cold one.  Then a burst of four concurrent prompts
    of 300 / 700 / 1000 / 1500 tokens, 16 greedy tokens each (the
    1000-token prompt's first 768 tokens are P's cached chunks), under the
    profiler for the device's busy share; the same sequence on a serial
    server (``prefill_batch`` 1): token agreement (reported, not asserted:
    the packed path reads earlier chunks through the int8 codes) and TTFT
    p50 / max of both.  Asserted: fewer packed forwards than chunks, the
    fill histogram's count and sum equal to the packed forwards and chunks,
    the ragged flash launches = 32 x prefill forwards (flash on the serial
    server), decode = 32 x decode ticks, RMSNorm = 65 x forwards, the
    prefix counters exactly the radix rules'.  Then one packed forward at
    B_p = 4 against one serial chunk forward (device and wall ms).
    ``layers``: the tree cut to its first ``layers`` layers (widths whole;
    the launch identities count L = ``layers``)."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    app = import_module(f"{PKG}.server.app")
    cfg = llama.LlamaConfig.llama2_7b()
    if layers is not None and layers < cfg.num_layers:
        params, cfg = _cut_depth(params, layers), dataclasses.replace(cfg, num_layers=layers)
    V, L = cfg.vocab_size, cfg.num_layers
    rng = np.random.default_rng(41)
    lens = (300, 700, 1000, 1500)
    burst = [rng.integers(1, V, n).tolist() for n in lens]
    shared = burst[2][:768] + rng.integers(1, V, 100).tolist()
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    runs = {}
    for mode, pb in (("packed", 4), ("serial", 1)):
        torch.cuda.empty_cache()
        srv, th, base, ttfts = _packed_server(app, predictor, "int8kv", pb, True, device)
        engine = srv.engine
        url = base + "/v2/models/llama2-7b/generate"
        calls: list[tuple[int, int]] = []  # (rows, parked pad rows) a packed forward
        rows_seen: list[tuple[list, list]] = []  # (slots, offsets) a packed forward
        real_chunks = engine._device_chunks

        def counted_chunks(ids, slots, offsets, finals, real_chunks=real_chunks, calls=calls,
                           rows_seen=rows_seen):
            calls.append((len(ids), int((offsets == engine.capacity).sum())))
            rows_seen.append(([int(x) for x in slots], [int(x) for x in offsets]))
            return real_chunks(ids, slots, offsets, finals)

        engine._device_chunks = counted_chunks
        try:
            _post(url, {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up, not measured
            ttfts.clear()
            scrape0 = _scrape(base)
            dec0, pre0 = engine.decode_forwards, engine.prefill_forwards
            chunks0 = engine.prefill_chunks_dispatched
            da.launches = rn.launches = fa.launches = fa.ragged_launches = 0
            cold = _check_outputs(_post(url, {"prompt_ids": shared, "max_new_tokens": 16}),
                                  [16], V)[0]
            warm = _check_outputs(_post(url, {"prompt_ids": shared, "max_new_tokens": 16}),
                                  [16], V)[0]
            if warm != cold:
                raise AssertionError(f"7B {mode}: the warm answer {warm} differs from the cold "
                                     f"one {cold}")
            pre1, chunks1 = engine.prefill_forwards, engine.prefill_chunks_dispatched
            calls.clear()
            rows_seen.clear()
            ttfts.clear()
            torch.cuda.synchronize()
            prof = _profiled(engine.between_ticks)
            try:
                t0 = time.perf_counter()
                outs = _burst(url, burst, 16, V)
                torch.cuda.synchronize()
                burst_s = time.perf_counter() - t0
            finally:
                _stop_profiled(prof, engine.between_ticks)
            busy_ms = 0.0
            for evt in prof.key_averages():
                dev_us = getattr(evt, "self_device_time_total", None)
                busy_ms += (dev_us if dev_us is not None
                            else getattr(evt, "self_cuda_time_total", 0.0)) / 1e3
            burst_ttfts = list(ttfts)
            torch.cuda.synchronize()
            decodes = engine.decode_forwards - dec0
            prefills = engine.prefill_forwards - pre0
            counts = {"decode": da.launches, "rmsnorm": rn.launches, "flash": fa.launches,
                      "ragged": fa.ragged_launches}
            want = {"decode": L * decodes, "rmsnorm": (2 * L + 1) * (decodes + prefills),
                    "flash": 0 if pb > 1 else L * prefills,
                    "ragged": L * prefills if pb > 1 else 0}
            if counts != want:
                raise AssertionError(f"7B {mode}: launches {counts}, expected {want} for "
                                     f"{decodes} decode ticks and {prefills} prefill forwards")
            prefix = {"hits": engine.prefix_hits, "cached_tokens": engine.prefix_cached_tokens,
                      "evictions": engine.prefix_evictions}
            # The radix rules: P's cold pass writes its three full chunks and
            # its warm pass hits them; in the burst the 1000-token prompt hits
            # the same 768 tokens, and the others write their full chunks
            # (1 + 2 + 5, within the 2 GiB budget).
            if prefix != {"hits": 2, "cached_tokens": 1536, "evictions": 0}:
                raise AssertionError(f"7B {mode}: prefix counters {prefix}")
            scrape1 = _scrape(base)
            res = {"prefill_batch": pb, "cold_tokens": cold, "burst_tokens": outs,
                   "burst_s": burst_s, "burst_ttft_s": burst_ttfts,
                   "ttft_p50_ms": _percentile_ms(burst_ttfts, 50),
                   "ttft_max_ms": max(burst_ttfts) * 1e3,
                   "burst_prefill_forwards": engine.prefill_forwards - pre1,
                   "decode_ticks": decodes, "prefill_forwards": prefills,
                   "launches": counts, "prefix": prefix,
                   "burst_busy_ms": busy_ms, "burst_idle_share": 1 - busy_ms / (burst_s * 1e3),
                   "dispatches": dict(engine.dispatches_total)}
            if pb > 1:
                chunks = engine.prefill_chunks_dispatched - chunks0
                burst_chunks = engine.prefill_chunks_dispatched - chunks1
                fill_count = (_value(scrape1, "tpumlops_prefill_batch_fill_count")
                              - _value(scrape0, "tpumlops_prefill_batch_fill_count"))
                fill_sum = (_value(scrape1, "tpumlops_prefill_batch_fill_sum")
                            - _value(scrape0, "tpumlops_prefill_batch_fill_sum"))
                if (fill_count, fill_sum) != (prefills, chunks):
                    raise AssertionError(f"7B packed: the fill histogram counts {fill_count} "
                                         f"forwards of {fill_sum} chunks, the engine {prefills} "
                                         f"of {chunks}")
                if burst_chunks != 2 + 3 + 1 + 6 or not res["burst_prefill_forwards"] < burst_chunks:
                    raise AssertionError(f"7B packed: the burst ran {burst_chunks} chunks in "
                                         f"{res['burst_prefill_forwards']} forwards")
                res.update(chunks=chunks, burst_chunks=burst_chunks,
                           chunks_per_forward=burst_chunks / res["burst_prefill_forwards"],
                           burst_calls=list(calls), burst_rows=list(rows_seen),
                           burst_pad_rows=sum(pad for _, pad in calls))
                capacity, n_rows = engine.capacity, engine._cache.k8.shape[1]
            runs[mode] = res
            log(f"7B int8kv {mode} (prefill_batch {pb}): P cold = warm {cold[:4]}...; burst "
                f"300/700/1000/1500 + 16 in {burst_s:.3f} s, {res['burst_prefill_forwards']} "
                f"prefill forwards, TTFT p50 {res['ttft_p50_ms']:.1f} ms max "
                f"{res['ttft_max_ms']:.1f} ms ({[round(t * 1e3, 1) for t in burst_ttfts]}), "
                f"device busy {busy_ms:.1f} ms (idle share {res['burst_idle_share']:.3f}); "
                f"launches {counts} for {decodes} decode ticks and {prefills} prefill forwards; "
                f"prefix {prefix}")
        finally:
            srv.shutdown_all()
            th.join(timeout=30)
        if mode == "packed":
            packed_engine = engine
        del srv, engine
    agree = _agreement(runs["packed"]["burst_tokens"], runs["serial"]["burst_tokens"])
    cold_agree = _agreement([runs["packed"]["cold_tokens"]], [runs["serial"]["cold_tokens"]])

    # One packed forward at B_p = 4 (offsets 0/256/768/1024 on the packed
    # engine's int8 cache, the server stopped) against one serial chunk
    # forward (a 256-token chunk at offset 768 of a batch-1 scratch cache).
    ids = torch.randint(1, V, (4, 256), device=device,
                        generator=torch.Generator(device=device).manual_seed(3))
    slots = torch.arange(4, dtype=torch.int32, device=device)
    offsets = torch.tensor([0, 256, 768, 1024], dtype=torch.int32, device=device)
    seq = llama.KVCache.create(cfg, 1, torch.bfloat16, device)

    def packed_fwd():
        llama.prefill_chunks_ragged(params, ids, packed_engine._cache, slots, offsets, cfg)

    def packed_fwd3():  # three rows: what a pad row costs is b4 - b3
        llama.prefill_chunks_ragged(params, ids[:3], packed_engine._cache, slots[:3],
                                    offsets[:3], cfg)

    def serial_fwd():
        llama.forward(params, ids[:1], seq._replace(length=768), cfg)

    fwd = {}
    for name, fn in (("packed_b4", packed_fwd), ("packed_b3", packed_fwd3),
                     ("serial_chunk", serial_fwd)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / 3
        prof_k, _ = profile_device(fn, iters=3)
        fwd[name] = {"wall_ms": wall_ms, "device_ms": sum(prof_k.values()) / 3}
    del seq, packed_engine
    torch.cuda.empty_cache()
    ragged_burst = _ragged_at_burst(fa, runs["packed"]["burst_rows"], capacity, n_rows)

    # Each burst answer against a teacher-forced whole-prompt forward of
    # its own output (flash at offset 0 on a bf16 scratch cache): the share
    # of its tokens that are that forward's argmax.
    for r in runs.values():
        agree_tf = []
        for prompt, o in zip(burst, r["burst_tokens"]):
            ids = torch.tensor([prompt + o[:-1]], dtype=torch.int64, device=device)
            logits, _ = llama.prefill(params, ids, cfg, torch.bfloat16)
            pred = torch.argmax(logits[0, len(prompt) - 1:], dim=-1).tolist()
            agree_tf.append(_agreement([pred], [o]))
            del logits
        r["teacher_forced_agreement"] = agree_tf
    p, sr = runs["packed"], runs["serial"]
    res = {"runs": runs, "burst_agreement": agree, "cold_agreement": cold_agree,
           "forward": fwd, "ragged_at_burst": ragged_burst,
           "da_launches": p["launches"]["decode"] + sr["launches"]["decode"],
           "rn_launches": p["launches"]["rmsnorm"] + sr["launches"]["rmsnorm"],
           "fa_launches": sr["launches"]["flash"], "ragged_launches": p["launches"]["ragged"]}
    log(f"7B packed prefill (int8kv, {L} layers): the burst's 12 chunks in "
        f"{p['burst_prefill_forwards']} "
        f"packed forwards ({p['chunks_per_forward']:.2f} chunks a forward) against "
        f"{sr['burst_prefill_forwards']} serial (rows, pad rows a packed forward: "
        f"{p['burst_calls']}); TTFT p50/max packed {p['ttft_p50_ms']:.1f}/"
        f"{p['ttft_max_ms']:.1f} ms, serial {sr['ttft_p50_ms']:.1f}/{sr['ttft_max_ms']:.1f} ms; "
        f"idle share packed {p['burst_idle_share']:.3f}, serial {sr['burst_idle_share']:.3f}; "
        f"token agreement packed vs serial {agree:.3f} (P cold {cold_agree:.3f}), each burst "
        f"answer with a teacher-forced forward of its own output: packed "
        f"{[round(a, 3) for a in p['teacher_forced_agreement']]}, serial "
        f"{[round(a, 3) for a in sr['teacher_forced_agreement']]}; one forward: "
        f"packed B_p=4 {fwd['packed_b4']['device_ms']:.2f} device ms "
        f"({fwd['packed_b4']['wall_ms']:.2f} wall), B_p=3 {fwd['packed_b3']['device_ms']:.2f} "
        f"({fwd['packed_b3']['wall_ms']:.2f}), against a serial chunk "
        f"{fwd['serial_chunk']['device_ms']:.2f} ({fwd['serial_chunk']['wall_ms']:.2f} wall) "
        f"on {smi}")
    DETAIL["serve_7b_packed"] = res
    return res


def phase_serve_7b_packed_none(da, rn, fa, smi: str, params, device: str = "cuda") -> dict:
    """Phase 5d, bf16: Llama-2-7B ``quantize: none`` (``params``: the bf16
    weight tree) with ``prefill_batch`` 4 against 1 (4 slots, chunks of
    256, no prefix cache): four concurrent prompts of 300-700 tokens, 8
    greedy tokens each.  The packed server runs the bf16-window instance of
    the ragged kernel: ragged launches = 32 x prefill forwards, fewer
    forwards than chunks; the packed answers' agreement with the serial
    ones is reported."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    app = import_module(f"{PKG}.server.app")
    cfg = llama.LlamaConfig.llama2_7b()
    V, L = cfg.vocab_size, cfg.num_layers
    rng = np.random.default_rng(43)
    prompts = [rng.integers(1, V, n).tolist() for n in (300, 420, 550, 700)]
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    out = {}
    for mode, pb in (("packed", 4), ("serial", 1)):
        torch.cuda.empty_cache()
        srv, th, base, ttfts = _packed_server(app, predictor, "none", pb, False, device)
        engine = srv.engine
        try:
            url = base + "/v2/models/llama2-7b/generate"
            _post(url, {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up
            ttfts.clear()
            dec0, pre0 = engine.decode_forwards, engine.prefill_forwards
            da.launches = rn.launches = fa.launches = fa.ragged_launches = 0
            toks = _burst(url, prompts, 8, V)
            torch.cuda.synchronize()
            decodes = engine.decode_forwards - dec0
            prefills = engine.prefill_forwards - pre0
            counts = {"decode": da.launches, "rmsnorm": rn.launches, "flash": fa.launches,
                      "ragged": fa.ragged_launches}
            want = {"decode": L * decodes, "rmsnorm": (2 * L + 1) * (decodes + prefills),
                    "flash": 0 if pb > 1 else L * prefills,
                    "ragged": L * prefills if pb > 1 else 0}
            if counts != want:
                raise AssertionError(f"7B none {mode}: launches {counts}, expected {want}")
            if pb > 1 and not prefills < 2 + 2 + 3 + 3:
                raise AssertionError(f"7B none packed: {prefills} forwards for 10 chunks")
            out[mode] = {"tokens": toks, "prefill_forwards": prefills, "decode_ticks": decodes,
                         "launches": counts, "ttft_s": list(ttfts)}
        finally:
            srv.shutdown_all()
            th.join(timeout=30)
        del srv, engine
    agree = _agreement(out["packed"]["tokens"], out["serial"]["tokens"])
    res = {**out, "agreement": agree, "ragged_launches": out["packed"]["launches"]["ragged"],
           "da_launches": sum(r["launches"]["decode"] for r in out.values()),
           "rn_launches": sum(r["launches"]["rmsnorm"] for r in out.values()),
           "fa_launches": out["serial"]["launches"]["flash"]}
    log(f"7B none packed prefill (bf16 cache): 10 chunks in {out['packed']['prefill_forwards']} "
        f"packed forwards (serial {out['serial']['prefill_forwards']}); ragged launches "
        f"{res['ragged_launches']}; token agreement with the serial answers {agree:.3f} on {smi}")
    DETAIL["serve_7b_packed_none"] = res
    return res


def phase_serve_7b_dense(da, rn, fa, smi: str, params, quantize: str,
                         prefill_chunk: int | None) -> dict:
    """Llama-2-7B on the dense bf16 KV cache (``quantize`` none: bf16
    weights; int8: int8 weights) behind ``build_server``: one request
    alone, four concurrent ones (17/130/300/700-token prompts, one
    sampled), a seeded stream against the same request without stream,
    the launch counts over every request, a greedy request's agreement
    with a teacher-forced forward and the device busy share of one
    request."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    app = import_module(f"{PKG}.server.app")

    cfg = llama.LlamaConfig.llama2_7b()
    tag = f"7B {quantize} (bf16 cache, prefill_chunk {prefill_chunk})"
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    config = app.ServerConfig(model_name="llama2-7b", host="127.0.0.1", port=0,
                              quantize=quantize, max_slots=4, prefill_chunk=prefill_chunk,
                              device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = app.build_server(predictor, config)
    engine = srv.engine
    if engine._kv_quant or not isinstance(engine._cache, llama.RaggedKVCache):
        raise AssertionError(f"{tag}: the engine did not take the dense cache")
    if engine._cache.k.dtype != torch.bfloat16:
        raise AssertionError(f"{tag}: cache dtype {engine._cache.k.dtype}")
    ttfts: list[float] = []
    metric_ttft = engine.on_ttft
    engine.on_ttft = lambda s_: (ttfts.append(s_), metric_ttft(s_))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    path = "/v2/models/llama2-7b/generate"
    url = f"http://127.0.0.1:{port}{path}"
    rng = np.random.default_rng(17)
    try:
        _post(url, {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up, not measured
        ttfts.clear()
        dec0, pre0 = engine.decode_forwards, engine.prefill_forwards
        disp0 = dict(engine.dispatches_total)
        da.launches = rn.launches = fa.launches = 0

        t_single = time.perf_counter()
        single_prompt = rng.integers(1, cfg.vocab_size, 5).tolist()
        single = _post(url, {"prompt_ids": single_prompt, "max_new_tokens": 40})
        single_s = time.perf_counter() - t_single
        _check_outputs(single, [40], cfg.vocab_size)

        lens = (17, 130, 300, 700)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
        bodies = [{"prompt_ids": p, "max_new_tokens": 32} for p in prompts]
        bodies[1].update(temperature=0.8, top_k=40, top_p=0.95, seed=7)
        t_conc = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            resps = list(pool.map(lambda b: _post(url, b), bodies))
        conc_s = time.perf_counter() - t_conc
        conc_toks = [_check_outputs(r, [32], cfg.vocab_size)[0] for r in resps]

        seeded = {"prompt_ids": rng.integers(1, cfg.vocab_size, 24).tolist(),
                  "max_new_tokens": 32, "temperature": 0.8, "top_k": 50, "top_p": 0.95,
                  "seed": 1234}
        streamed = _sse(port, path, seeded)
        plain = _check_outputs(_post(url, seeded), [32], cfg.vocab_size)[0]
        if streamed["tokens"] != plain:
            raise AssertionError(f"{tag}: streamed tokens {streamed['tokens'][:8]}... differ "
                                 f"from the answer without stream {plain[:8]}...")
        torch.cuda.synchronize()

        da_launches, rn_launches, fa_launches = da.launches, rn.launches, fa.launches
        decodes = engine.decode_forwards - dec0
        prefills = engine.prefill_forwards - pre0
        disp = {k: engine.dispatches_total.get(k, 0) - disp0.get(k, 0)
                for k in engine.dispatches_total}
        L = cfg.num_layers
        if disp.get("decode", 0) != decodes or decodes == 0 or prefills == 0:
            raise AssertionError(f"{tag}: dispatches {disp}, {decodes} decodes, "
                                 f"{prefills} prefills")
        if da_launches != L * decodes:
            raise AssertionError(f"{tag}: decode attention launched {da_launches} times for "
                                 f"{decodes} decode dispatches")
        if fa_launches != L * prefills:
            raise AssertionError(f"{tag}: flash attention launched {fa_launches} times for "
                                 f"{prefills} prefill forwards")
        if rn_launches != (2 * L + 1) * (decodes + prefills):
            raise AssertionError(f"{tag}: rmsnorm launched {rn_launches} times for "
                                 f"{decodes + prefills} forwards")
        log(f"{tag}: {decodes} decode dispatches, {prefills} prefill forwards; decode "
            f"attention {da_launches} launches (= {L} x {decodes}), flash attention "
            f"{fa_launches} (= {L} x {prefills}), rmsnorm {rn_launches} (= {2 * L + 1} x "
            f"{decodes + prefills}); the seeded stream equals the answer without stream")
        max_memory_gib = torch.cuda.max_memory_allocated() / 2**30

        # Teacher-forced agreement of a greedy request with its own output.
        p, o = prompts[2], conc_toks[2]
        ids = torch.tensor([p + o[:-1]], dtype=torch.int64, device="cuda")
        logits, _ = llama.prefill(params, ids, cfg, torch.bfloat16)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: teacher-forced logits are not finite")
        pred = torch.argmax(logits[0, len(p) - 1:], dim=-1).tolist()
        agreement = float(np.mean([a == b for a, b in zip(pred, o)]))
        del logits

        # Device busy share of one 5 + 16-token request (as phase 5).
        body16 = {"prompt_ids": single_prompt, "max_new_tokens": 16}
        t_plain = time.perf_counter()
        _post(url, body16)
        plain_wall_ms = (time.perf_counter() - t_plain) * 1e3
        prof, wall_ms = profile_device(lambda: _post(url, body16), iters=1,
                                       hold=engine.between_ticks)
        busy_ms = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:8]
        res = {
            "quantize": quantize, "prefill_chunk": prefill_chunk,
            "single_request_s": single_s, "single_tokens_per_s": 40 / single_s,
            "concurrent_s": conc_s, "concurrent_tokens_per_s": 32 * len(lens) / conc_s,
            "ttft_s": list(ttfts)[:5], "stream_ttft_ms": (streamed["times"][0]
                                                         - streamed["t_send"]) * 1e3,
            "token_agreement": agreement, "decode_dispatches": decodes,
            "prefill_forwards": prefills, "da_launches": da_launches,
            "fa_launches": fa_launches, "rn_launches": rn_launches,
            "max_memory_gib": max_memory_gib, "profile_busy_ms": busy_ms,
            "unprofiled_wall_ms": plain_wall_ms, "profile_wall_ms": wall_ms,
            "idle_share": 1 - busy_ms / plain_wall_ms, "profile_top": top,
        }
        log(f"{tag}: single request 5+40 tokens {40 / single_s:.2f} tok/s; 4 concurrent "
            f"(17/130/300/700 + 32) {32 * len(lens) / conc_s:.2f} tok/s; TTFT s "
            f"{[round(t, 4) for t in res['ttft_s']]}; token_agreement {agreement:.3f}; peak "
            f"{max_memory_gib:.2f} GiB; one 5+16 request: device busy {busy_ms:.1f} of "
            f"{plain_wall_ms:.1f} ms (idle share {res['idle_share']:.3f}) on {smi}")
        for name, ms_ in top[:6]:
            log(f"  {ms_:9.3f} ms  {name[:110]}")
        DETAIL[f"serve_7b_{quantize}"] = res
        return res
    finally:
        srv.shutdown_all()
        th.join(timeout=30)


# ---------------------------------------------------------------------------
# Phase 5e: fused multi-step decode (CUDA graphs) and the sampling kernel
# ---------------------------------------------------------------------------

# A token of the sampling kernels that differs from the plain chain's must
# do so inside one of two rules (``_sample_rule``):
# - the plain scores at the two chosen ranks lie within GUMBEL_ULPS f32 ulp:
#   the kernel's Gumbel is the device's logf of a bit-equal uniform, two
#   logs each within an ulp or two;
# - the plain exclusive mass at one of the two chosen ranks lies within
#   P_TOL of p: both sides add the softmax sum and the exclusive mass in f32
#   over up to V terms in different orders (the kernels: four ranks a
#   thread, a warp scan, the warps, the chunks; the plain chain: softmax's
#   and cumsum's own), each side's deepest chain some 40 roundings of at
#   most 2^-24 relative, ~5e-6 apart at worst; 1e-5 keeps a factor of two.
GUMBEL_ULPS = 4
P_TOL = 1e-5
# The H100's int32 issue rate: 64 of the 128 f32 lanes an SM, one operation
# a clock against the f32 rate's two (F32_FLOPS counts a fused multiply-add).
INT32_OPS = F32_FLOPS / 4
# The H100's exponentials a second: 16 results a clock an SM from the
# special-function units, against 128 f32 lanes of two flops.
EXP_OPS = F32_FLOPS / 16
# Integer operations the draw kernel executes for a kept rank
# (csrc/sampling.cu): the counter's add into the key, 20 threefry rounds of
# an add, a rotate and a xor, five key injections of two adds, and the xor,
# shift and or of the uniform's bits.  Its two logs are f32 work (a
# polynomial each) and are left out of the bound.  A row's key split is two
# hashes without the uniform's bits.
GUMBEL_OPS = 1 + 20 * 3 + 5 * 2 + 3
SPLIT_OPS = 2 * (GUMBEL_OPS - 3)
# (T, top_k, top_p): the smoke's served filter, none, top-p only, top-k 1.
SAMPLE_MIXES = {"smoke": (0.8, 50, 0.95), "none": (1.0, 0, 1.0), "top_p": (0.7, 0, 0.9),
                "top_k1": (0.8, 1, 1.0)}
MS_STEPS = (1, 4, 8)  # decode_steps served in turns
MS_REPEATS = 2  # turns a K (3 until the preemption phase 5g took their time)
MS_NEW = 24  # new tokens a request


def _short(kernel: str) -> str:
    """A kernel's name without its namespaces, template arguments and
    parameters, as the profiler reports it."""
    k = re.split(r"[(<]", kernel.replace("(anonymous namespace)::", ""))[0]
    return k.rsplit("::", 1)[-1].strip().split(" ")[-1] or kernel


def _call_cost(fn, iters: int = 50) -> dict:
    """Device ms and launches a call (profiler), the host's enqueue ms and
    the synchronized wall ms a call."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    for _ in range(2):  # a profiler window now and then comes back empty
        launches: dict[str, int] = {}
        by_kernel, _ = profile_device(fn, iters=20, launches=launches)
        if by_kernel:
            break
    by_name: dict[str, float] = {}
    for k, v in by_kernel.items():
        by_name[_short(k)] = by_name.get(_short(k), 0.0) + v / 20
    return {"device_ms": sum(by_kernel.values()) / 20,
            "launches": sum(launches.values()) / 20, "host_ms": host_ms, "wall_ms": wall_ms,
            "by_kernel": by_name}


def _sample_inputs(B: int, V: int, seed: int, mix, dtype=None):
    """Logits as the decode hands them (a seeded normal times 3) with the
    rows the rules must hold on (B > 2: NaN logits; B > 3: every other one
    -inf; B > 4: a +inf one; B > 5: all -inf), greedy rows among the
    sampled ones (every third from row 1), top_p 0 on row 6, and keys."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, V, device="cuda", generator=gen) * 3
    if B > 2:
        x[2, [7, 100]] = float("nan")
    if B > 3:
        x[3, ::2] = float("-inf")
    if B > 4:
        x[4, 5] = float("inf")
    if B > 5:
        x[5] = float("-inf")
    T, k, p = mix
    temps = torch.full((B,), T, device="cuda")
    temps[1::3] = 0.0
    topk = torch.full((B,), k, dtype=torch.int32, device="cuda")
    topp = torch.full((B,), p, device="cuda")
    if B > 6:
        topp[6] = 0.0
    return x if dtype is None else x.to(dtype), temps, topk, topp


def _sample_rule(ss, prng, logits, keys, temps, topk, topp, got, want) -> dict:
    """Rows where the kernels' tokens ``got`` differ from the plain chain's
    ``want``, each of which must be sampled and inside GUMBEL_ULPS or P_TOL
    (see above), and the largest score difference between the two choices
    under the plain chain's scores."""
    import numpy as np
    import torch

    _, use = prng.split_keys(keys)
    _, order, masked = ss.filter_logits(logits, temps, topk, topp)
    t = torch.clamp(temps, min=1e-6)[:, None]
    sorted_logits = -torch.sort(-(logits.float() / t), dim=-1, stable=True)[0]
    probs = torch.softmax(sorted_logits, dim=-1)
    mass = (torch.cumsum(probs, dim=-1) - probs).cpu().numpy()
    scores = masked + prng.gumbel(use, (logits.shape[1],))
    ca = (order == got[:, None].long()).int().argmax(-1)
    cb = (order == want[:, None].long()).int().argmax(-1)
    sa = scores.gather(1, ca[:, None])[:, 0].cpu().numpy()
    sb = scores.gather(1, cb[:, None])[:, 0].cpu().numpy()
    ulp = np.spacing(np.maximum(np.abs(sa), np.abs(sb)).astype(np.float32))
    err = np.abs(sa.astype(np.float64) - sb) / ulp
    p = np.clip(topp.cpu().numpy(), 0.0, 1.0)
    ca, cb, sampled = ca.cpu().numpy(), cb.cpu().numpy(), (temps > 0).cpu().numpy()
    by_ulp = by_mass = 0
    for b in np.nonzero(got.cpu().numpy() != want.cpu().numpy())[0]:
        near = min(abs(mass[b, ca[b]] - p[b]), abs(mass[b, cb[b]] - p[b]))
        if sampled[b] and err[b] <= GUMBEL_ULPS:
            by_ulp += 1
        elif sampled[b] and near <= P_TOL:
            by_mass += 1
        else:
            raise AssertionError(
                f"sample_step row {b}: token {int(got[b])} (rank {ca[b]}) against the plain "
                f"{int(want[b])} (rank {cb[b]}), scores {sa[b]} / {sb[b]} ({err[b]:.1f} ulp), "
                f"mass {mass[b, ca[b]]} / {mass[b, cb[b]]} at p {p[b]}, T {float(temps[b])}")
    return {"differ": by_ulp + by_mass, "by_ulp": by_ulp, "by_mass": by_mass,
            "max_abs": float(np.abs(sa.astype(np.float64) - sb).max())}


def _sample_bound(ss, logits, temps, topk, topp) -> dict:
    """The least time the two kernels could take for this step's work, for
    the prep kernel, the draw kernel and both, each the largest of three:
    bytes at the HBM rate (prep: the logits read and the negated scaled
    values written; draw: the sorted ranks a sampled row needs, its kept
    ones and the first masked one, and one order element a row), integer
    operations at INT32_OPS (SPLIT_OPS a row; GUMBEL_OPS a kept rank of a
    sampled row) and exponentials at EXP_OPS (V a row for the softmax sum;
    one a needed rank for its mass)."""
    B, V = logits.shape
    _, _, masked = ss.filter_logits(logits, temps, topk, topp)
    kept_rows = ((masked > -1e30) & (temps > 0)[:, None]).sum(-1)
    kept = int(kept_rows.sum())
    needed = int(((kept_rows + 1).clamp(max=V) * (temps > 0)).sum())

    def best(nbytes, ints, exps):
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "integer": ints / INT32_OPS * 1e3,
             "exp": exps / EXP_OPS * 1e3}
        by = max(t, key=t.get)
        return {"ms": t[by], "by": "bytes" if by == "bytes" else "operations", "times": t}

    item = logits.element_size()
    prep = (B * V * (item + 4), B * SPLIT_OPS, B * V)
    draw = (needed * 4 + B * 8, kept * GUMBEL_OPS, needed)
    return {"kept": kept, "needed": needed, "prep": best(*prep), "draw": best(*draw),
            "both": best(*(x + y for x, y in zip(prep, draw)))}


def phase_sample_step(ss, prng) -> dict:
    """The sampled step's two kernels (``ops/sample_step``: the prep kernel,
    the sort, the draw kernel) against the plain chain on the card at B 1 /
    4 / 32, V 32000 / 32001 / 128256, under the four filter mixes, two seeds
    each, and once on bf16 logits at B 4 V 32000: carry keys bit-equal, the
    prep kernel's negated scaled values bit-equal to the plain chain's,
    greedy rows equal, every other token equal or inside the rule.  Then, at
    B 4 and 32, V 32000, under each mix: the whole step's device ms,
    launches and host ms, each kernel alone (CUDA events and profiler), the
    sort's own, the plain chain's, and the bound."""
    import torch

    checks = differ = by_mass = 0
    max_abs = 0.0
    cases = [(B, V, mix, seed, None) for B in (1, 4, 32) for V in (32000, 32001, 128256)
             for mix in SAMPLE_MIXES for seed in (1, 2)]
    cases += [(4, 32000, mix, 3, torch.bfloat16) for mix in SAMPLE_MIXES]
    for B, V, mix, seed, dtype in cases:
        x, temps, topk, topp = _sample_inputs(B, V, seed * 1000 + B, SAMPLE_MIXES[mix], dtype)
        keys = prng.split(prng.key(seed, "cuda"), B)
        carry, tok = ss.sample_step(x, keys, temps, topk, topp)
        ref_carry, ref_tok = ss.sample_step_reference(x, keys, temps, topk, topp)
        if not torch.equal(carry, ref_carry):
            raise AssertionError(f"sample_step carry keys differ at B{B} V{V} {mix}")
        _, neg, _ = ss.prep_launch(x, keys, temps)
        want = -(x.float() / torch.clamp(temps, min=1e-6)[:, None])
        same = (neg.view(torch.int32) == want.view(torch.int32)) | (neg.isnan() & want.isnan())
        if not bool(same.all()):
            raise AssertionError(f"sample_prep's scaled values differ at B{B} V{V} {mix}")
        rule = _sample_rule(ss, prng, x, keys, temps, topk, topp, tok, ref_tok)
        differ += rule["differ"]
        by_mass += rule["by_mass"]
        max_abs = max(max_abs, rule["max_abs"])
        checks += 1
    torch.cuda.synchronize()
    log(f"sample_step: {checks} checks (B 1/4/32, V 32000/32001/128256, mixes "
        f"{list(SAMPLE_MIXES)}, seeds 1/2; bf16 logits at B4 V32000; NaN, +-inf, all -inf, "
        f"top_p 0 and greedy rows): carry keys and scaled values bit-equal; {differ} rows "
        f"chose another token than the plain chain ({by_mass} by the mass rule), max abs "
        f"score difference {max_abs:.3g}")
    timing = {}
    V = 32000
    for B in (4, 32):
        gen = torch.Generator(device="cuda").manual_seed(B)
        x = torch.randn(B, V, device="cuda", generator=gen) * 3
        keys = prng.split(prng.key(1234, "cuda"), B)
        for mix, (T, k, p) in SAMPLE_MIXES.items():
            temps = torch.full((B,), T, device="cuda")
            topk = torch.full((B,), k, dtype=torch.int32, device="cuda")
            topp = torch.full((B,), p, device="cuda")
            _, neg, state = ss.prep_launch(x, keys, temps)
            neg_sorted, order = torch.sort(neg, dim=-1, stable=True)

            def step():
                return ss.sample_step(x, keys, temps, topk, topp)

            def plain():
                return ss.sample_step_reference(x, keys, temps, topk, topp)

            def prep():
                return ss.prep_launch(x, keys, temps)

            def draw():
                return ss.draw_launch(neg_sorted, order, state, temps, topk, topp)

            def sort():
                return torch.sort(neg, dim=-1, stable=True)

            cost = _call_cost(step)
            own = {n: v for n, v in cost["by_kernel"].items()
                   if n in ("sample_prep_kernel", "sample_draw_kernel")}
            r = {"step": cost, "step_ms": cuda_time_ms(step),
                 "prep_ms": cuda_time_ms(prep), "draw_ms": cuda_time_ms(draw),
                 "prep_device_ms": own.get("sample_prep_kernel"),
                 "draw_device_ms": own.get("sample_draw_kernel"),
                 "sort_device_ms": cost["device_ms"] - sum(own.values()),
                 "sort_launches": cost["launches"] - len(own),
                 "sort_alone": _call_cost(sort), "plain": _call_cost(plain),
                 "plain_ms": cuda_time_ms(plain), "bound": _sample_bound(ss, x, temps, topk, topp)}
            timing[f"b{B}_{mix}"] = r
            b = r["bound"]
            log(f"sample_step B{B} V{V} {mix} (T {T}, k {k}, p {p}; {b['kept']} kept ranks): step "
                f"{cost['device_ms']:.4f} device ms, {cost['launches']:.0f} launches, host "
                f"{cost['host_ms']:.3f} ms, {r['step_ms']:.4f} CUDA-event ms; prep "
                f"{r['prep_device_ms']} device / {r['prep_ms']:.4f} ms, draw "
                f"{r['draw_device_ms']} device / {r['draw_ms']:.4f} ms, the sort "
                f"{r['sort_device_ms']:.4f} device ms in {r['sort_launches']:.0f} launches; bound "
                f"prep {b['prep']['ms']:.5f} ({b['prep']['by']}), draw {b['draw']['ms']:.5f} "
                f"({b['draw']['by']}), both {b['both']['ms']:.5f} ms ({b['both']['by']}); the "
                f"plain chain {r['plain']['device_ms']:.4f} device ms, "
                f"{r['plain']['launches']:.0f} launches, host {r['plain']['host_ms']:.3f} ms")
    res = {"checks": checks, "rows_differ": differ, "rows_by_mass": by_mass,
           "max_abs_err": max_abs, "timing": timing}
    DETAIL["sample_step"] = res
    return res


# The kernel each launch counter of a graph stands for: one launch of the
# named kernels a counted wrapper call launches one of (the decode wrappers
# a decode or a verify chunk kernel, the verify wrappers counted again on
# their own; the sampling wrapper its prep and its draw kernel once each,
# around the sort).
REPLAY_KERNELS = (("decode_attention", ("decode_attention_kernel", "verify_attention_kernel")),
                  ("verify_attention", ("verify_attention_kernel",)),
                  ("rmsnorm", ("rmsnorm_kernel",)),
                  ("flash_attention", ("flash_attention_kernel_bf16",
                                       "flash_attention_kernel_f32")),
                  ("sample_step", ("sample_prep_kernel",)),
                  ("sample_step", ("sample_draw_kernel",)))


def _graph_kernels(prog, window: int, sampling: bool) -> dict[str, int]:
    """The kernel nodes of the program's ``(window, sampling)`` graph, by
    the kernel groups of ``REPLAY_KERNELS``.  A replay launches each node of
    its graph once, so these are exactly the launches of one replay.  The
    graph must have been captured with ``cuda_graphs.KEEP_GRAPHS`` set."""
    path = ROOT / "build" / f"graph_{os.getpid()}.dot"  # ignored by git
    path.parent.mkdir(exist_ok=True)
    try:
        text = prog.kernel_nodes(window, sampling, path)
    finally:
        path.unlink(missing_ok=True)
    nodes = re.findall(r'label="\{KERNEL\n\| \{ID \| \d+ \(topoId: \d+\) \| ([^\s\\]+)\\<', text)
    if not nodes:
        raise AssertionError(f"graph (window {window}, sampling {sampling}): no kernel node "
                             f"in its dump ({len(text)} bytes)")
    # A mangled name holds each identifier as its length, then its letters.
    pats = {k: re.compile(rf"{len(k)}{k}(?![a-z0-9_])")
            for _, names in REPLAY_KERNELS for k in names}
    return {"+".join(names): sum(1 for n in nodes if any(pats[k].search(n) for k in names))
            for _, names in REPLAY_KERNELS}


def _replay_launches(prog, window: int, sampling: bool, load, tries: int = 5,
                     run=None) -> dict:
    """The launches of each kernel in one replay of the ``(window,
    sampling)`` graph, against the counts the program recorded at its
    capture (and adds at every replay).  The graph's own kernel nodes
    (``_graph_kernels``) must equal them: that is what a replay launches.
    The profiler must see each replay launch on the card no more than
    that, and each kernel at least once.  A profiler window now and then
    misses launches (PERF.md section 7), so a replay is profiled up to
    ``tries`` times until each kernel has been seen as often as recorded;
    the most seen of each is returned, and ``missed`` holds what the
    profiler still missed then.  ``load`` puts the state back before each
    try; ``run`` is the replay (the multi-step program's dispatch and
    harvest when None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, deltas = prog.graphs[(window, sampling)]
    recorded = dict(deltas)
    want = {"+".join(names): recorded[mod] for mod, names in REPLAY_KERNELS}
    nodes = _graph_kernels(prog, window, sampling)
    if nodes != want:
        raise AssertionError(f"graph (window {window}, sampling {sampling}): kernel nodes "
                             f"{nodes}, recorded at capture {want}")
    best = {k: 0 for k in want}
    for i in range(tries):
        load()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if run is None:
                prog.harvest(prog.dispatch(window, sampling))
            else:
                run()
            torch.cuda.synchronize()
        seen = {k: 0 for k in want}
        for evt in prof.key_averages():
            for _, names in REPLAY_KERNELS:
                if any(re.search(rf"\b{n}\s*[<(]", evt.key) for n in names):
                    seen["+".join(names)] += evt.count
        over = {k: (seen[k], want[k]) for k in want if seen[k] > want[k]}
        if over:
            raise AssertionError(f"one replay of graph (window {window}, sampling {sampling}) "
                                 f"launched (profiled, recorded at capture) {over}")
        best = {k: max(best[k], seen[k]) for k in want}
        if best == want:
            break
    unseen = [k for k in want if want[k] and not best[k]]
    if unseen:
        raise AssertionError(f"graph (window {window}, sampling {sampling}): the profiler saw "
                             f"no launch of {unseen} in {i + 1} replays")
    missed = {k: want[k] - best[k] for k in want if best[k] < want[k]}
    if missed:
        log(f"graph (window {window}, sampling {sampling}): the profiler missed {missed} "
            f"launches in the best of {i + 1} replays; the graph's nodes hold them")
    return {"recorded": recorded, "graph_nodes": nodes, "profiled": best,
            "profiled_replays": i + 1, "missed": missed}


def _graph_vs_eager(engine, prng, lengths=(5, 130, 700, 1500)) -> dict:
    """One replay of the engine's captured (K, window) graph against one
    eager ``decode_multistep`` from the same state, greedy and sampled:
    ``tok_block``, ``valid``, lengths, tokens, keys and the committed K/V
    rows must be bit-equal.  Then each of the two graphs' kernel nodes
    must be the counts recorded at capture, which every replay adds to the
    launch counters, and profiled replays must launch them
    (``_replay_launches``); those counts must be K decode steps' (L decode
    attention, 2L + 1 RMSNorm and, sampled, one sampling kernel a step).  Run on an engine
    that has served nothing (its scheduler never touches the program),
    over cache rows filled with random values; the written rows are put
    back after each run."""
    import numpy as np
    import torch
    from importlib import import_module

    prog = engine._program
    K = prog.steps
    cache = engine._cache
    bufs = [t for t in cache[:-1]]
    gen_rand = torch.Generator(device="cuda").manual_seed(5)
    span = max(lengths) + K
    for t in bufs:
        if t.dtype == torch.int8:
            t[:, :, :, :span] = torch.randint(-127, 128, t[:, :, :, :span].shape, device="cuda",
                                              dtype=torch.int8, generator=gen_rand)
        else:
            scale = 0.01 if t.shape[-1] == 1 else 0.5  # int8 scales, or bf16 K/V
            t[:, :, :, :span] = (torch.randn(t[:, :, :, :span].shape, device="cuda",
                                             generator=gen_rand) * scale).to(t.dtype)
    B = len(lengths)
    gen = import_module(f"{PKG}.server.generation")
    window = gen.decode_window_bucket(min(max(lengths) + K - 1, engine.capacity), engine.capacity)
    state = dict(
        tokens=torch.tensor([[11], [222], [3333], [4444]], device="cuda"),
        lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
        keys=prng.split(prng.key(99, "cuda"), B).contiguous(),
        temps=torch.tensor([0.8, 0.0, 1.0, 0.7], device="cuda"),
        topk=torch.tensor([50, 0, 0, 5], dtype=torch.int32, device="cuda"),
        topp=torch.tensor([0.95, 1.0, 0.9, 1.0], device="cuda"))
    host = dict(active_np=np.ones(B, bool), remaining_np=np.array([100, 2, 100, 100], np.int32),
                eos_np=np.full(B, -1, np.int32))

    def rows():
        return [t[:, b, :, n:n + K].clone() for t in bufs for b, n in enumerate(lengths)]

    def put(saved):
        i = 0
        for t in bufs:
            for b, n in enumerate(lengths):
                t[:, b, :, n:n + K] = saved[i]
                i += 1

    out = {}
    for sampling in (False, True):
        before = rows()
        prog.load(**state, **host)
        tok_g, valid_g = prog.harvest(prog.dispatch(window, sampling))
        graph = (rows(), prog.lengths.clone(), prog.tokens.clone(), prog.keys.clone())
        put(before)
        prog.load(**state, **host)
        prog._run(window, sampling)
        torch.cuda.synchronize()
        tok_e, valid_e = prog.tok_block.cpu().numpy(), prog.valid.cpu().numpy()
        eager = (rows(), prog.lengths.clone(), prog.tokens.clone(), prog.keys.clone())
        put(before)
        same = (np.array_equal(tok_g, tok_e) and np.array_equal(valid_g, valid_e)
                and all(torch.equal(a, b) for a, b in zip(graph[0], eager[0]))
                and all(torch.equal(a, b) for a, b in zip(graph[1:], eager[1:])))
        if not same:
            raise AssertionError(f"replay and eager decode_multistep differ (sampling "
                                 f"{sampling}): tokens {tok_g.tolist()} / {tok_e.tolist()}, "
                                 f"valid {valid_g.tolist()} / {valid_e.tolist()}")
        if valid_g.tolist() != [K, min(K, 2), K, K]:
            raise AssertionError(f"valid {valid_g.tolist()} at K {K}")
        counted = _replay_launches(prog, window, sampling, lambda: prog.load(**state, **host))
        put(before)
        L = prog._cfg.num_layers
        steps = {"decode_attention": L * K, "verify_attention": 0, "rmsnorm": (2 * L + 1) * K,
                 "flash_attention": 0, "sample_step": K if sampling else 0}
        if counted["recorded"] != steps:
            raise AssertionError(f"graph (window {window}, sampling {sampling}) recorded "
                                 f"{counted['recorded']} launches a replay, not {steps}")
        out["sampled" if sampling else "greedy"] = {"tok_block": tok_g.tolist(),
                                                    "valid": valid_g.tolist(),
                                                    "replay_launches": counted}
    out["window"] = window
    return out


def _settle(engines, replays0, timeout: float = 60.0) -> None:
    """Wait until every fused dispatch has been harvested (a burst's last
    harvest may follow the answer of its last request)."""
    deadline = time.time() + timeout
    for e in engines:
        prog = e._program
        if prog is None:
            continue
        while (e.dispatches_total.get("multistep", 0) - replays0[e][1]
               != prog.replays - replays0[e][0]):
            if time.time() > deadline:
                raise AssertionError("a fused dispatch was never harvested")
            time.sleep(0.005)


def phase_serve_7b_multistep(da, rn, fa, ss, smi: str, params, quantize: str,
                             prefill_chunk: int | None, layers: int | None = None) -> dict:
    """Llama-2-7B served at ``decode_steps`` 1, 4 and 8 (three servers on
    one weight tree, driven in turns): graph replay against the eager call,
    tok/s alone and four concurrent, TTFT, SSE ITL over four seeded
    streams, the idle share of one request, the graphs' count, capture
    seconds and pool bytes, peak memory, ``/metrics``, the launch
    identities with replays counted, and token agreement against K = 1.
    ``layers``: the tree cut to its first ``layers`` layers (widths whole)."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    prng = import_module(f"{PKG}.models.prng")
    app = import_module(f"{PKG}.server.app")
    gen = import_module(f"{PKG}.server.generation")

    cfg = llama.LlamaConfig.llama2_7b()
    if layers is not None and layers < cfg.num_layers:
        params, cfg = _cut_depth(params, layers), dataclasses.replace(cfg, num_layers=layers)
    L = cfg.num_layers
    tag = f"7B multistep {quantize}" + (f" ({L} layers)" if layers is not None else "")
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    path = "/v2/models/llama2-7b/generate"
    servers: dict[int, dict] = {}
    graph_eager: dict[int, dict] = {}
    try:
        for K in MS_STEPS:
            config = app.ServerConfig(model_name="llama2-7b", host="127.0.0.1", port=0,
                                      quantize=quantize, max_slots=4,
                                      prefill_chunk=prefill_chunk, device="cuda",
                                      decode_steps=K)
            alloc0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            srv = app.build_server(predictor, config)
            build_s = time.perf_counter() - t0
            prog = srv.engine._program
            if K > 1:
                graph_eager[K] = _graph_vs_eager(srv.engine, prng)
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            port = srv.server_address[1]
            servers[K] = {
                "srv": srv, "th": th, "port": port, "engine": srv.engine,
                "base": f"http://127.0.0.1:{port}", "url": f"http://127.0.0.1:{port}{path}",
                "build_s": build_s, "graphs": len(prog.graphs) if prog else 0,
                "capture_s": prog.capture_s if prog else 0.0,
                "pool_bytes": prog.pool_bytes() if prog else 0,
                "alloc_gib": (torch.cuda.memory_allocated() - alloc0) / 2**30,
            }
            buckets = gen.decode_window_buckets(srv.engine.capacity)
            if K > 1 and len(prog.graphs) != 2 * len(buckets):
                raise AssertionError(f"{tag}: {len(prog.graphs)} graphs at K {K}")
            log(f"{tag}: server K={K} built in {build_s:.1f} s; {servers[K]['graphs']} graphs "
                f"captured in {servers[K]['capture_s']:.2f} s, pool "
                f"{servers[K]['pool_bytes'] / 2**20:.1f} MiB; the server's allocations "
                f"{servers[K]['alloc_gib']:.2f} GiB")
        peak_built = torch.cuda.max_memory_allocated() / 2**30
        for K in MS_STEPS:
            _post(servers[K]["url"], {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up
        log(f"{tag}: one replay equals one eager decode_multistep (tokens, valid, lengths, "
            f"tokens out, keys, committed K/V rows; lengths 5/130/700/1500, greedy and "
            f"sampled) at K {sorted(graph_eager)}; a graph's kernel nodes are the launches "
            f"recorded at its capture, which the profiler saw a replay launch: " + "; ".join(
                f"K {K} {mode} {graph_eager[K][mode]['replay_launches']['profiled']}"
                for K in sorted(graph_eager) for mode in ("greedy", "sampled")))

        rng = np.random.default_rng(29)
        V = cfg.vocab_size
        single_prompt = rng.integers(1, V, 5).tolist()
        lens = (17, 130, 300, 700)
        prompts = [rng.integers(1, V, n).tolist() for n in lens]
        bodies = [{"prompt_ids": p, "max_new_tokens": MS_NEW} for p in prompts]
        bodies[1].update(temperature=0.8, top_k=40, top_p=0.95, seed=7)
        seeded = {"prompt_ids": rng.integers(1, V, 24).tolist(), "max_new_tokens": MS_NEW,
                  "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 1234}
        engines = [servers[K]["engine"] for K in MS_STEPS]
        base0 = {e: (e._program.replays if e._program else 0,
                     e.dispatches_total.get("multistep", 0)) for e in engines}
        disp0 = {e: dict(e.dispatches_total) for e in engines}
        pre0 = {e: e.prefill_forwards for e in engines}
        samp0 = {e: e.sample_steps for e in engines}
        tok0 = {e: e.tokens_generated for e in engines}
        scrape0 = {K: _scrape(servers[K]["base"]) for K in MS_STEPS}
        da.launches = rn.launches = fa.launches = ss.launches = 0

        runs = {K: {"single_tok_s": [], "conc_tok_s": [], "ttft_ms": [], "single": [],
                    "conc": []} for K in MS_STEPS}
        for r in range(MS_REPEATS):
            for K in (MS_STEPS if r % 2 == 0 else MS_STEPS[::-1]):
                s, run = servers[K], runs[K]
                ttfts: list[float] = []
                metric_ttft = s["engine"].on_ttft
                s["engine"].on_ttft = lambda x, m=metric_ttft, t=ttfts: (t.append(x), m(x))
                t0 = time.perf_counter()
                single = _check_outputs(_post(s["url"], {"prompt_ids": single_prompt,
                                                         "max_new_tokens": MS_NEW}),
                                        [MS_NEW], V)[0]
                run["single_tok_s"].append(MS_NEW / (time.perf_counter() - t0))
                t0 = time.perf_counter()
                with ThreadPoolExecutor(4) as pool:
                    resps = list(pool.map(lambda b, u=s["url"]: _post(u, b), bodies))
                run["conc_tok_s"].append(MS_NEW * len(lens) / (time.perf_counter() - t0))
                s["engine"].on_ttft = metric_ttft
                run["ttft_ms"].append([t * 1e3 for t in ttfts])
                run["single"].append(single)
                run["conc"].append([_check_outputs(x, [MS_NEW], V)[0] for x in resps])

        streams = {}
        for K in MS_STEPS:
            s = servers[K]
            streamed = _sse(s["port"], path, seeded)
            plain = _check_outputs(_post(s["url"], seeded), [MS_NEW], V)[0]
            if streamed["tokens"] != plain:
                raise AssertionError(f"{tag} K={K}: the seeded stream {streamed['tokens'][:8]} "
                                     f"differs from the answer without stream {plain[:8]}")
            with ThreadPoolExecutor(4) as pool:
                four = list(pool.map(lambda i, p=s["port"]: _sse(p, path,
                                                                 {**seeded, "seed": 1234 + i}),
                                     range(4)))
            itl = np.concatenate([np.diff(st["times"]) for st in four])
            streams[K] = {"tokens": plain, "ttft_ms": (streamed["times"][0]
                                                       - streamed["t_send"]) * 1e3,
                          "itl_p50_ms": _percentile_ms(itl, 50),
                          "itl_p99_ms": _percentile_ms(itl, 99), "itl_n": len(itl),
                          "ttft4_ms": [(st["times"][0] - st["t_send"]) * 1e3 for st in four]}
        torch.cuda.synchronize()
        _settle(engines, base0)

        # Launch identities over every request since the reset, replays counted.
        decodes = ms_steps = prefills = samples = 0
        per_k = {}
        for K, e in zip(MS_STEPS, engines):
            d = e.dispatches_total.get("decode", 0) - disp0[e].get("decode", 0)
            m = e.dispatches_total.get("multistep", 0) - disp0[e].get("multistep", 0)
            p = e.prefill_forwards - pre0[e]
            decodes, ms_steps, prefills = decodes + d, ms_steps + K * m, prefills + p
            samples += e.sample_steps - samp0[e]
            # the first token of each request comes from its prefill
            decoded = e.tokens_generated - tok0[e] - (5 * MS_REPEATS + 6)
            per_k[K] = {"decode": d, "multistep": m, "prefill": p,
                        "tokens_per_dispatch": decoded / max(1, d + m)}
            if (K > 1) != (m > 0):
                raise AssertionError(f"{tag} K={K}: {m} multistep dispatches")
        if da.launches != L * (decodes + ms_steps):
            raise AssertionError(f"{tag}: decode attention launched {da.launches} times for "
                                 f"{decodes} decode ticks + {ms_steps} fused steps")
        if rn.launches != (2 * L + 1) * (decodes + ms_steps + prefills):
            raise AssertionError(f"{tag}: rmsnorm launched {rn.launches} times for "
                                 f"{decodes + ms_steps + prefills} forwards")
        if fa.launches != L * prefills:
            raise AssertionError(f"{tag}: flash attention launched {fa.launches} times for "
                                 f"{prefills} prefill forwards")
        if ss.launches != samples or samples == 0:
            raise AssertionError(f"{tag}: sample_step launched {ss.launches} times for "
                                 f"{samples} sampling steps")
        launches = {"da": da.launches, "rn": rn.launches, "fa": fa.launches, "ss": ss.launches}
        log(f"{tag}: launches with replays counted: decode attention {da.launches} (= {L} x "
            f"({decodes} + {ms_steps})), rmsnorm {rn.launches} (= {2 * L + 1} x "
            f"{decodes + ms_steps + prefills}), flash {fa.launches} (= {L} x {prefills}), "
            f"sample_step {ss.launches} (= {samples} sampling steps); by K {per_k}")

        # /metrics: the multistep dispatches and the ITL observations.
        metrics = {}
        for K in MS_STEPS:
            s, e = servers[K], servers[K]["engine"]
            sc = _scrape(s["base"])
            m_disp = (_value(sc, "tpumlops_engine_dispatches_total", op="multistep")
                      - _value(scrape0[K], "tpumlops_engine_dispatches_total", op="multistep"))
            itl_n = (_value(sc, "tpumlops_itl_seconds_count")
                     - _value(scrape0[K], "tpumlops_itl_seconds_count"))
            itl_sum = (_value(sc, "tpumlops_itl_seconds_sum")
                       - _value(scrape0[K], "tpumlops_itl_seconds_sum"))
            if m_disp != per_k[K]["multistep"]:
                raise AssertionError(f"{tag} K={K}: /metrics multistep {m_disp}, engine "
                                     f"{per_k[K]['multistep']}")
            if itl_n == 0 or itl_sum <= 0:
                raise AssertionError(f"{tag} K={K}: ITL observations {itl_n}, sum {itl_sum}")
            metrics[K] = {"multistep": m_disp, "itl_n": itl_n, "itl_mean_ms": itl_sum / itl_n * 1e3}

        # Device idle share of one 5 + 16-token request at each K.
        idle = {}
        body16 = {"prompt_ids": single_prompt, "max_new_tokens": 16}
        for K in MS_STEPS:
            url = servers[K]["url"]
            t0 = time.perf_counter()
            _post(url, body16)
            wall = (time.perf_counter() - t0) * 1e3
            prof, prof_wall = profile_device(lambda u=url: _post(u, body16), iters=1,
                                             hold=servers[K]["engine"].between_ticks)
            busy = sum(prof.values())
            idle[K] = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
                       "profile_wall_ms": prof_wall,
                       "top": sorted(prof.items(), key=lambda kv: -kv[1])[:6]}
        # One seeded sampled request alone (5 + 16 tokens, the served filter)
        # at K 1 and 4: tok/s, the idle share and the sampling kernels' time.
        sampled = {}
        body_s = {**body16, "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 4321}
        for K in (1, 4):
            url = servers[K]["url"]
            t0 = time.perf_counter()
            toks = _check_outputs(_post(url, body_s), [16], V)[0]
            wall = (time.perf_counter() - t0) * 1e3
            prof, prof_wall = profile_device(lambda u=url: _post(u, body_s), iters=1,
                                             hold=servers[K]["engine"].between_ticks)
            busy = sum(prof.values())
            sampled[K] = {"tok_s": 16e3 / wall, "wall_ms": wall, "busy_ms": busy,
                          "idle_share": 1 - busy / wall, "profile_wall_ms": prof_wall,
                          "sample_kernels_ms": sum(v for n, v in prof.items() if "sample_" in n),
                          "tokens": toks}
        log(f"{tag}: one seeded sampled request alone (5 + 16, T 0.8 k 50 p 0.95): " + "; ".join(
            f"K {K} {sampled[K]['tok_s']:.2f} tok/s, idle share {sampled[K]['idle_share']:.3f} "
            f"(busy {sampled[K]['busy_ms']:.1f} of {sampled[K]['wall_ms']:.1f} ms, sampling "
            f"kernels {sampled[K]['sample_kernels_ms']:.3f} ms)" for K in sampled)
            + f"; tokens equal at K 1 and 4: {sampled[1]['tokens'] == sampled[4]['tokens']}")
        peak = torch.cuda.max_memory_allocated() / 2**30

        def agree(a, b):
            return float(np.mean([x == y for x, y in zip(a, b)]))

        res = {"quantize": quantize, "layers": L, "graph_vs_eager": graph_eager,
               "launches": launches, "sampled_alone": sampled,
               "per_k": per_k, "metrics": metrics, "peak_gib": peak, "peak_built_gib": peak_built,
               "by_k": {}}
        for K in MS_STEPS:
            run, s = runs[K], servers[K]
            greedy = [run["single"][0]] + [c for i, c in enumerate(run["conc"][0]) if i != 1]
            base = [runs[1]["single"][0]] + [c for i, c in enumerate(runs[1]["conc"][0])
                                              if i != 1]
            st = streams[K]
            by = {
                "single_tok_s": run["single_tok_s"], "conc_tok_s": run["conc_tok_s"],
                "ttft_ms": run["ttft_ms"], "stream": {k: v for k, v in st.items()
                                                      if k != "tokens"},
                "idle": idle[K], "graphs": s["graphs"], "capture_s": s["capture_s"],
                "pool_bytes": s["pool_bytes"], "alloc_gib": s["alloc_gib"],
                "multistep": per_k[K]["multistep"], "decode": per_k[K]["decode"],
                "tokens_per_dispatch": per_k[K]["tokens_per_dispatch"],
                "agreement_vs_k1": agree(sum(greedy, []), sum(base, [])),
                "seeded_agreement_vs_k1": agree(st["tokens"], streams[1]["tokens"]),
                "repeats_equal": all(x == run["single"][0] for x in run["single"]),
            }
            res["by_k"][K] = by
            log(f"{tag} K={K}: single 5+{MS_NEW} tok/s {[round(x, 2) for x in by['single_tok_s']]}; "
                f"4 concurrent (17/130/300/700 + {MS_NEW}) tok/s "
                f"{[round(x, 2) for x in by['conc_tok_s']]}; TTFT ms (first repeat) "
                f"{[round(t, 1) for t in run['ttft_ms'][0]]}; SSE 4 streams ITL p50 "
                f"{st['itl_p50_ms']:.2f} p99 {st['itl_p99_ms']:.2f} ms over {st['itl_n']} gaps, "
                f"TTFT {st['ttft_ms']:.1f} ms; idle share {idle[K]['idle_share']:.3f} "
                f"(busy {idle[K]['busy_ms']:.1f} of {idle[K]['wall_ms']:.1f} ms); dispatches "
                f"decode {per_k[K]['decode']} multistep {per_k[K]['multistep']} "
                f"({by['tokens_per_dispatch']:.2f} tokens a dispatch); "
                f"/metrics ITL mean {metrics[K]['itl_mean_ms']:.2f} ms over "
                f"{metrics[K]['itl_n']:.0f}; agreement with K=1 {by['agreement_vs_k1']:.3f} "
                f"(greedy), {by['seeded_agreement_vs_k1']:.3f} (seeded stream)")
            for name, ms_ in idle[K]["top"][:4]:
                log(f"  {ms_:9.3f} ms  {name[:110]}")
        log(f"{tag}: peak {peak:.2f} GiB ({peak_built:.2f} after building the three "
            f"servers) on {smi}")
        DETAIL[f"serve_7b_multistep_{quantize}"] = res
        return res
    finally:
        for s in servers.values():
            s["srv"].shutdown_all()
            s["th"].join(timeout=30)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5f: the unified ragged super-step
# ---------------------------------------------------------------------------

UNI_K = 4          # decode_steps of both engines
UNI_REPEATS = 2    # turns, split then unified, then the other way
UNI_NEW = 24       # new tokens a request
UNI_BURST = (300, 700, 1000, 1500)  # phase 5d's burst
# Llama-2-7B's widths at this depth in the int8kv turns of phases 5d, 5e,
# 5f and 5g (their engines copy every int8 weight to bf16 each forward,
# 2.4-3.6x the `none` turns' walls at 32 layers) and in the `none` turns of
# 5e, 5f and 5g: cut for the smoke's time limit (5d and 5e int8kv when phase
# 8c came, the three `none` turns when phase 9b did, 5h's `none` server when
# phase 8d did).
INT8KV_LAYERS = 8
# 5e's turns (both quantize modes) and 5h's server, which 5h compares with
# 5e's at the same depth, cut further when phases 5k and 8e came.
MS_LAYERS = 4


def _superstep_vs_eager(engine, prng, lengths=(5, 130, 700, 1500)) -> dict:
    """One replay of the unified engine's captured graph against one eager
    run of the program on the same staged inputs, for a decode-only tick
    (four decode rows, one budget ending inside the K steps) and a mixed
    tick (two decode rows, a verify row with 4 drafts, a prefill row whose
    256-token chunk at offset 1536 completes its prompt), greedy and
    sampled: the packed outputs (token block, valid, greedy, accepted,
    first tokens), the state buffers (tokens, lengths, keys, temperatures,
    top-k, top-p) and the written K/V rows bit-equal.  Then each graph
    used held to the counts recorded at its capture, by its kernel nodes
    and profiled replays (``_replay_launches``)
    (L x K decode attention, the L verify chunk calls among them, (2L + 1) x K
    RMSNorm, one sampled step for the finalize and K more sampled), and
    each mix's device ms.  Run on an engine that has served nothing, over
    cache rows filled with random values; the rows and the engine's state
    are put back after."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    gen = import_module(f"{PKG}.server.generation")
    prog = engine._program
    K, S, B = prog.steps, prog.width, prog.batch
    L = prog._cfg.num_layers
    bufs = list(engine._cache[:-1])
    state0 = [t.clone() for t in (prog.tokens, prog.lengths, prog.keys, prog.temps, prog.topk,
                                  prog.topp)]
    g = torch.Generator(device="cuda").manual_seed(6)
    span = 1536 + S + K
    for t in bufs:
        if t.dtype == torch.int8:
            t[:, :, :, :span] = torch.randint(-127, 128, t[:, :, :, :span].shape, device="cuda",
                                              dtype=torch.int8, generator=g)
        else:
            scale = 0.01 if t.shape[-1] == 1 else 0.5  # int8 scales, or bf16 K/V
            t[:, :, :, :span] = (torch.randn(t[:, :, :, :span].shape, device="cuda",
                                             generator=g) * scale).to(t.dtype)
    state = dict(tokens=torch.tensor([[11], [222], [3333], [4444]], device="cuda"),
                 lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
                 keys=prng.split(prng.key(99, "cuda"), B).contiguous(),
                 temps=torch.tensor([0.8, 0.0, 1.0, 0.7], device="cuda"),
                 topk=torch.tensor([50, 0, 0, 5], dtype=torch.int32, device="cuda"),
                 topp=torch.tensor([0.95, 1.0, 0.9, 1.0], device="cuda"))
    rng = np.random.default_rng(17)
    V = prog._cfg.vocab_size

    def mix_inputs(mix):
        (ids, roles, offsets, counts, draft_len, active, remaining, eos_ids, last_pos,
         final_lens, slot_keys, r_temps, r_tks, r_tps) = engine._parked_superstep()
        ids[:] = rng.integers(1, V, ids.shape)
        active[:] = True
        roles[:] = llama.ROLE_DECODE
        counts[:] = 1
        remaining[:] = (100, 2, 100, 100)
        if mix == "mixed":
            roles[2], counts[2], draft_len[2], remaining[2] = llama.ROLE_VERIFY, 5, 4, 0
            roles[3], counts[3], offsets[3], remaining[3] = llama.ROLE_PREFILL, S, 1536, 0
            active[3] = False
            last_pos[3], final_lens[3] = 100, 1536 + 101
            slot_keys[3] = prng.key(7).numpy()
            r_temps[3], r_tks[3], r_tps[3] = 0.8, 50, 0.95
        bases = [1536 if r == llama.ROLE_PREFILL else n for r, n in zip(roles, lengths)]
        decode_hi = max(n for r, n in zip(roles, lengths) if r == llama.ROLE_DECODE)
        other_hi = max([0] + [b for r, b in zip(roles, bases) if r != llama.ROLE_DECODE])
        window = gen.superstep_window(decode_hi, other_hi, K, engine.capacity)
        return ((ids, roles, offsets, counts, draft_len, active, remaining, eos_ids, last_pos,
                 final_lens, slot_keys, r_temps, r_tks, r_tps), window, bases)

    out = {}
    try:
        for mix in ("decode", "mixed"):
            inputs, window, bases = mix_inputs(mix)

            def rows():
                return [t[:, b, :, n:n + S + K].clone() for t in bufs
                        for b, n in enumerate(bases)]

            def put(saved):
                i = 0
                for t in bufs:
                    for b, n in enumerate(bases):
                        t[:, b, :, n:n + S + K] = saved[i]
                        i += 1

            def load():
                prog.load_state(**state)
                prog.stage(*inputs)

            def bufs_now():
                return [prog._out.clone(), prog.tokens.clone(), prog.lengths.clone(),
                        prog.keys.clone(), prog.temps.clone(), prog.topk.clone(),
                        prog.topp.clone()]

            for sampling in (False, True):
                before = rows()
                load()
                res = prog.dispatch(window, sampling)
                graph = (rows(), bufs_now())
                put(before)
                load()
                prog._run(window, sampling)
                torch.cuda.synchronize()
                eager = (rows(), bufs_now())
                put(before)
                same = (all(torch.equal(a, b) for a, b in zip(graph[0], eager[0]))
                        and all(torch.equal(a, b) for a, b in zip(graph[1], eager[1])))
                if not same:
                    raise AssertionError(
                        f"super-step replay and eager run differ ({mix}, sampling {sampling}): "
                        f"tokens {res.tok_block.tolist()}, valid {res.valid.tolist()}")
                want_valid = [K, 2, K, K] if mix == "decode" else [K, 2, 0, 0]
                if res.valid.tolist() != want_valid:
                    raise AssertionError(f"super-step {mix}: valid {res.valid.tolist()}")
                counted = _replay_launches(prog, window, sampling, load,
                                           run=lambda w=window, sm=sampling: prog.dispatch(w, sm))
                put(before)
                want = {"decode_attention": L * K, "verify_attention": L,
                        "rmsnorm": (2 * L + 1) * K, "flash_attention": 0,
                        "sample_step": 1 + (K if sampling else 0)}
                if counted["recorded"] != want:
                    raise AssertionError(f"super-step graph (window {window}, sampling "
                                         f"{sampling}) recorded {counted['recorded']}, not {want}")
                out[f"{mix}_{'sampled' if sampling else 'greedy'}"] = {
                    "window": window, "valid": res.valid.tolist(),
                    "accepted": res.accepted.tolist(), "firsts": res.firsts.tolist(),
                    "replay_launches": counted}
            # One tick's device ms (greedy), the rows put back each time.
            before = rows()

            def tick(w=window):
                load()
                prog.dispatch(w, False)

            by_kernel, wall = profile_device(tick, iters=3)
            put(before)
            out[f"{mix}_device_ms"] = sum(by_kernel.values()) / 3
            out[f"{mix}_wall_ms"] = wall / 3
            out[f"{mix}_top"] = sorted(((k, v / 3) for k, v in by_kernel.items()),
                                       key=lambda kv: -kv[1])[:8]
    finally:
        for buf, t in zip((prog.tokens, prog.lengths, prog.keys, prog.temps, prog.topk,
                           prog.topp), state0):
            buf.copy_(t)
        torch.cuda.synchronize()
    return out


def phase_serve_7b_unified(da, rn, fa, ss, smi: str, params, quantize: str,
                           layers: int | None = None) -> dict:
    """Llama-2-7B served by the split engine and the unified super-step
    engine (``--unified-step 1``) on one weight tree, K 4, prefill chunks of
    256 packed 4 at a time, speculation with 4 drafts, in turns: replay
    against the eager call for each role mix, the graphs' count, capture
    seconds and pool bytes, tok/s alone and four concurrent, the TTFT of
    phase 5d's burst, SSE ITL over four seeded streams, the idle share of
    one request, every unified tick a super-step replay (seeds aside) with
    mixed ticks among them, the launch identities of the unified engine's
    ticks, and greedy agreement between the two engines (reported).
    ``layers``: the tree cut to its first ``layers`` layers (widths whole)."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    prng = import_module(f"{PKG}.models.prng")
    app = import_module(f"{PKG}.server.app")
    gen = import_module(f"{PKG}.server.generation")

    cfg = llama.LlamaConfig.llama2_7b()
    if layers is not None and layers < cfg.num_layers:
        params, cfg = _cut_depth(params, layers), dataclasses.replace(cfg, num_layers=layers)
    L = cfg.num_layers
    V = cfg.vocab_size
    tag = f"7B unified {quantize}" + (f" ({L} layers)" if layers else "")
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    path = "/v2/models/llama2-7b/generate"
    argv = ["--model-uri", "unused", "--model-name", "llama2-7b", "--host", "127.0.0.1",
            "--port", "0", "--quantize", quantize, "--max-slots", "4", "--prefill-chunk",
            "256", "--prefill-batch", "4", "--decode-steps", str(UNI_K), "--speculative", "1",
            "--speculative-draft-tokens", "4", "--device", "cuda"]
    servers: dict[str, dict] = {}
    try:
        for name, extra in (("split", []), ("unified", ["--unified-step", "1"])):
            config = app.config_from_args(app.build_arg_parser().parse_args(argv + extra))
            alloc0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            srv = app.build_server(predictor, config)
            build_s = time.perf_counter() - t0
            prog = srv.engine._program
            servers[name] = {"srv": srv, "engine": srv.engine, "prog": prog,
                             "build_s": build_s, "graphs": len(prog.graphs),
                             "capture_s": prog.capture_s, "pool_bytes": prog.pool_bytes(),
                             "alloc_gib": (torch.cuda.memory_allocated() - alloc0) / 2**30}
        uni = servers["unified"]
        if not isinstance(uni["prog"], import_module(f"{PKG}.server.cuda_graphs").SuperstepProgram):
            raise AssertionError(f"{tag}: --unified-step 1 built {type(uni['prog']).__name__}")
        buckets = gen.decode_window_buckets(uni["engine"].capacity)
        for name, s in servers.items():
            if s["graphs"] != 2 * len(buckets):
                raise AssertionError(f"{tag}: the {name} engine captured {s['graphs']} graphs, "
                                     f"not 2 x {len(buckets)}")
        eager = _superstep_vs_eager(uni["engine"], prng)
        log(f"{tag}: {uni['graphs']} super-step graphs (width {uni['prog'].width}, K "
            f"{UNI_K}) captured in {uni['capture_s']:.2f} s, pool "
            f"{uni['pool_bytes'] / 2**20:.1f} MiB (split engine: {servers['split']['graphs']} "
            f"multistep graphs, {servers['split']['capture_s']:.2f} s, "
            f"{servers['split']['pool_bytes'] / 2**20:.1f} MiB); replay bit-equal to eager for "
            f"a decode-only and a mixed tick, greedy and sampled; launches a replay "
            + json.dumps({k: v["replay_launches"]["recorded"] for k, v in eager.items()
                          if isinstance(v, dict)})
            + f"; one tick's device ms: decode-only {eager['decode_device_ms']:.3f}, mixed "
            f"{eager['mixed_device_ms']:.3f}")
        for name in ("decode", "mixed"):
            for k, ms_ in eager[f"{name}_top"][:5]:
                log(f"  {name} tick {ms_:9.3f} ms  {k[:100]}")
        for s in servers.values():
            th = threading.Thread(target=s["srv"].serve_forever, daemon=True)
            th.start()
            port = s["srv"].server_address[1]
            s.update(th=th, port=port, base=f"http://127.0.0.1:{port}",
                     url=f"http://127.0.0.1:{port}{path}")
            _post(s["url"], {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up

        # The unified engine's ticks: role mixes, and launches counted per tick.
        eng = uni["engine"]
        mixes: list[tuple] = []
        real = eng._device_superstep

        def spy(ids, roles, *rest):
            mixes.append(tuple(sorted(set(int(r) for r in roles if r))))
            return real(ids, roles, *rest)

        eng._device_superstep = spy
        rng = np.random.default_rng(31)
        single_prompt = rng.integers(1, V, 5).tolist()
        lens = (17, 130, 300, 700)
        conc = [{"prompt_ids": rng.integers(1, V, n).tolist(), "max_new_tokens": UNI_NEW}
                for n in lens]
        conc[1].update(temperature=0.8, top_k=40, top_p=0.95, seed=7)
        burst = [rng.integers(1, V, n).tolist() for n in UNI_BURST]
        seeded = {"prompt_ids": rng.integers(1, V, 24).tolist(), "max_new_tokens": UNI_NEW,
                  "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 1234}
        runs = {n: {"single_tok_s": [], "conc_tok_s": [], "burst_ttft_ms": [], "single": [],
                    "conc": [], "burst": [], "itl_p50_ms": [], "itl_p99_ms": []}
                for n in servers}
        split_engine = servers["split"]["engine"]

        def settle():
            # The split engine's last burst may still harvest after its answers.
            _settle([split_engine], {split_engine: (0, 0)})

        def now(name):
            e, d = servers[name]["engine"], servers[name]["engine"].dispatches_total
            return {"da": da.launches, "va": da.verify_launches, "rn": rn.launches,
                    "fa": fa.launches, "fr": fa.ragged_launches, "ss": ss.launches,
                    "superstep": d.get("superstep", 0), "decode": d.get("decode", 0),
                    "verify": d.get("verify", 0), "multistep": d.get("multistep", 0),
                    "prefills": e.prefill_forwards, "samples": e.sample_steps,
                    "replays": servers[name]["prog"].replays}

        # The turns are this phase's serving run: every counter starts at 0
        # here, after the replay checks and the warm-ups, and each turn's
        # deltas are its engine's (the turns never overlap).
        settle()
        da.launches = da.verify_launches = rn.launches = fa.launches = 0
        fa.ragged_launches = ss.launches = 0
        counted = {n: dict.fromkeys(now(n), 0) for n in servers}

        def run_one(name):
            s, run = servers[name], runs[name]
            e = s["engine"]
            snap = now(name)
            t0 = time.perf_counter()
            single = _check_outputs(_post(s["url"], {"prompt_ids": single_prompt,
                                                     "max_new_tokens": UNI_NEW}), [UNI_NEW], V)[0]
            run["single_tok_s"].append(UNI_NEW / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as pool:
                resps = list(pool.map(lambda b, u=s["url"]: _post(u, b), conc))
            run["conc_tok_s"].append(UNI_NEW * len(lens) / (time.perf_counter() - t0))
            ttfts: list[float] = []
            metric_ttft = e.on_ttft
            e.on_ttft = lambda x, m=metric_ttft: (ttfts.append(x), m(x))
            run["burst"].append(_burst(s["url"], burst, 16, V))
            e.on_ttft = metric_ttft
            run["burst_ttft_ms"].append(sorted(t * 1e3 for t in ttfts))
            with ThreadPoolExecutor(4) as pool:
                four = list(pool.map(lambda i, p=s["port"]: _sse(p, path,
                                                                 {**seeded, "seed": 1234 + i}),
                                     range(4)))
            itl = np.concatenate([np.diff(st["times"]) for st in four])
            run["itl_p50_ms"].append(_percentile_ms(itl, 50))
            run["itl_p99_ms"].append(_percentile_ms(itl, 99))
            run["single"].append(single)
            run["conc"].append([_check_outputs(x, [UNI_NEW], V)[0] for x in resps])
            settle()
            for key, b in now(name).items():
                counted[name][key] += b - snap[key]

        for r in range(UNI_REPEATS):
            for name in (("split", "unified") if r % 2 == 0 else ("unified", "split")):
                run_one(name)
        eng._device_superstep = real
        launches = {"da": da.launches, "va": da.verify_launches, "rn": rn.launches,
                    "fa": fa.launches, "fr": fa.ragged_launches, "ss": ss.launches}

        kinds = set(eng.dispatches_total) - {"superstep", "seed"}
        if kinds:
            raise AssertionError(f"{tag}: the unified engine ran {sorted(kinds)} ticks")
        uc, sc = counted["unified"], counted["split"]
        ticks = uc["superstep"]
        if uc["replays"] != ticks or ticks == 0:
            raise AssertionError(f"{tag}: {ticks} super-step ticks, {uc['replays']} graph replays")
        n_mixed = sum(1 for m in mixes if llama.ROLE_PREFILL in m and llama.ROLE_DECODE in m)
        if n_mixed == 0:
            raise AssertionError(f"{tag}: no tick carried a prefill chunk beside decode rows "
                                 f"({len(mixes)} ticks)")
        # The launch identities: the turns' counts are the two engines'
        # (nothing launched outside them), the unified engine's L x K decode
        # attention calls a tick with the L verify chunk calls among them,
        # and the split engine's one call a layer a decode or verify tick
        # and K a multistep dispatch, its prefills through the flash kernels.
        for key, n in launches.items():
            if n != uc[key] + sc[key]:
                raise AssertionError(f"{tag}: {key} launched {n} times in the turns, the two "
                                     f"engines' turns {uc[key]} + {sc[key]}")
        split_fwd = sc["decode"] + sc["verify"] + UNI_K * sc["multistep"]
        for engine_name, got, want in (
                ("unified", {k: uc[k] for k in launches},
                 {"da": L * UNI_K * ticks, "va": L * ticks, "rn": (2 * L + 1) * UNI_K * ticks,
                  "fa": 0, "fr": 0, "ss": uc["samples"]}),
                ("split", {"da": sc["da"], "va": sc["va"], "rn": sc["rn"],
                           "fa+fr": sc["fa"] + sc["fr"], "ss": sc["ss"]},
                 {"da": L * split_fwd, "va": L * sc["verify"],
                  "rn": (2 * L + 1) * (split_fwd + sc["prefills"]),
                  "fa+fr": L * sc["prefills"], "ss": sc["samples"]})):
            bad = {k: (got[k], w) for k, w in want.items() if got[k] != w}
            if bad:
                raise AssertionError(f"{tag}: the {engine_name} engine's launches (counted, "
                                     f"expected) {bad}")

        # Idle share of one 5 + 16-token request on each engine: the device
        # intervals' union over the wall of the same profiled request.
        idle = {}
        body16 = {"prompt_ids": single_prompt, "max_new_tokens": 16}
        for name, s in servers.items():
            _post(s["url"], body16)  # warm, not measured
            idle[name] = busy_window(lambda u=s["url"]: _post(u, body16),
                                     hold=s["engine"].between_ticks)
        peak = torch.cuda.max_memory_allocated() / 2**30

        def greedy_of(name):
            run = runs[name]
            return ([run["single"][0]] + [c for i, c in enumerate(run["conc"][0]) if i != 1]
                    + run["burst"][0])

        agreement = _agreement(greedy_of("unified"), greedy_of("split"))
        res = {"quantize": quantize, "eager": {k: v for k, v in eager.items()
                                               if not k.endswith("_top")},
               "mixed_ticks": n_mixed, "ticks": ticks, "role_mixes": sorted(set(mixes)),
               "counted": counted, "launches": launches, "peak_gib": peak,
               "agreement_unified_vs_split": agreement, "by_engine": {}}
        for name, s in servers.items():
            run = runs[name]
            by = {k: run[k] for k in ("single_tok_s", "conc_tok_s", "burst_ttft_ms",
                                      "itl_p50_ms", "itl_p99_ms")}
            by.update(idle=idle[name], graphs=s["graphs"], capture_s=s["capture_s"],
                      pool_bytes=s["pool_bytes"], alloc_gib=s["alloc_gib"],
                      build_s=s["build_s"], dispatches=dict(s["engine"].dispatches_total),
                      ttft_p50_ms=[float(np.median(t)) for t in run["burst_ttft_ms"]],
                      ttft_max_ms=[max(t) for t in run["burst_ttft_ms"]])
            res["by_engine"][name] = by
            log(f"{tag} {name}: single 5+{UNI_NEW} tok/s "
                f"{[round(x, 2) for x in by['single_tok_s']]}; 4 concurrent tok/s "
                f"{[round(x, 2) for x in by['conc_tok_s']]}; burst {UNI_BURST} TTFT p50 "
                f"{[round(x, 1) for x in by['ttft_p50_ms']]} max "
                f"{[round(x, 1) for x in by['ttft_max_ms']]} ms; SSE ITL p50 "
                f"{[round(x, 2) for x in by['itl_p50_ms']]} p99 "
                f"{[round(x, 2) for x in by['itl_p99_ms']]} ms; idle share "
                f"{idle[name]['idle_share']} (device busy {idle[name]['busy_ms']:.3f} ms as the "
                f"union of {idle[name]['events']} intervals, {idle[name]['sum_ms']:.3f} summed, "
                f"in the same {idle[name]['wall_ms']:.3f} ms window); dispatches "
                f"{by['dispatches']}")
        log(f"{tag}: {ticks} super-step ticks counted, {n_mixed} of them mixed (prefill beside "
            f"decode); role mixes seen {res['role_mixes']}; launches in the turns {launches}: "
            f"unified decode attention {uc['da']} (= {L} x {UNI_K} x {ticks}), the verify chunk "
            f"{uc['va']} (= {L} x {ticks}), rmsnorm {uc['rn']}, sample_step {uc['ss']}; split "
            f"decode attention {sc['da']} (= {L} x ({sc['decode']} + {sc['verify']} + {UNI_K} x "
            f"{sc['multistep']})), verify {sc['va']}, rmsnorm {sc['rn']}, flash {sc['fa']} + "
            f"ragged {sc['fr']} (= {L} x {sc['prefills']}), sample_step {sc['ss']}; greedy "
            f"agreement unified vs split {agreement:.3f} (reported: bf16 near-ties); peak "
            f"{peak:.2f} GiB on {smi}")
        DETAIL[f"serve_7b_unified_{quantize}"] = res
        return res
    finally:
        for s in servers.values():
            s["srv"].shutdown_all()
            if "th" in s:
                s["th"].join(timeout=30)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5g: SLO classes and mid-decode preemption
# ---------------------------------------------------------------------------

PRE_SLOTS = 4
PRE_BE = (300, 256)   # best-effort streams: prompt, new tokens (served)
PRE_IA = (200, 32)    # interactive requests: prompt, new tokens (served)
PRE_TRIGGER = 16      # tokens each best-effort stream holds before the interactive ones
PRE_HAND_NEW = (40, 8)  # new tokens in the hand-driven run: best-effort, interactive
PRE_SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}


def _preempt_argv(quantize: str, preemption: bool = True) -> list[str]:
    """The served configuration: 4 slots, capacity 4096, chunks of 256, the
    prefix cache at 512 MiB with L2 256 MiB (5c's), K 4; ``none`` on the
    split engine, int8kv on the unified one (packed 4, 4 drafts)."""
    argv = ["--model-uri", "unused", "--model-name", "llama2-7b", "--host", "127.0.0.1",
            "--port", "0", "--quantize", quantize, "--max-slots", str(PRE_SLOTS),
            "--prefill-chunk", "256", "--decode-steps", "4", "--prefix-cache", "1",
            "--prefix-cache-budget-mb", "512", "--prefix-cache-l2-budget-mb", "256",
            "--slo-class", "batch", "--device", "cuda"]
    if preemption:
        argv += ["--preemption", "1"]
    if quantize == "int8kv":
        argv += ["--unified-step", "1", "--prefill-batch", "4", "--speculative", "1",
                 "--speculative-draft-tokens", "4"]
    return argv


def _synced_ms(fn, *args) -> float:
    """The host wall of ``fn(*args)`` with the card synchronized on both
    sides, in ms."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _kv_bufs(engine) -> list:
    return list(engine._cache[:-1])  # k, v (or k8, k_scale, v8, v_scale)


def _slot_state(engine, i: int) -> list:
    """Slot ``i``'s state rows: length, pending token, key row, temperature,
    top-k, top-p (clones on the card)."""
    return [engine._cache.lengths[i].clone(), engine._tokens[i].clone(),
            engine._keys[i].clone(), engine._temps[i].clone(), engine._topk[i].clone(),
            engine._topp[i].clone()]


def _requantized(snap: list, device) -> list:
    """An int8 row's codes and scales after the restore's round trip,
    ``bf16(code * scale)`` requantized, computed on ``device`` from the
    snapshot (the composition the CPU tests hold to the JAX package's bit
    for bit)."""
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    out = []
    for q8, sc in ((snap[0], snap[1]), (snap[2], snap[3])):
        deq = (q8.to(device).to(torch.bfloat16) * sc.to(device)).to(torch.bfloat16)
        out.extend(llama._quant_kv(deq))
    return out


def _replay_after_restore(engine) -> dict:
    """One graph replay on the engine's live state right after a restore,
    against one eager run of the same tick: a K-step burst of every occupied
    slot on the split engine (``MultistepProgram``), a decode-only
    super-step of them on the unified one.  Outputs, state buffers and the
    K/V rows the tick writes bit-equal; the rows and the state are put back
    after each run, so the scheduler resumes where it was."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    gen = import_module(f"{PKG}.server.generation")
    prog = engine._program
    K, cap = prog.steps, engine.capacity
    occupied = [s is not None for s in engine._slots]
    sampling = any(s is not None and s.sampling for s in engine._slots)
    pos = [s.prompt_len + len(s.generated) if s is not None else 0 for s in engine._slots]
    width = K + (prog.width if engine._unified else 0)
    lengths = engine._cache.lengths.tolist()
    bufs = _kv_bufs(engine)

    def rows():
        return [t[:, b, :, n:min(n + width, cap)].clone() for t in bufs
                for b, n in enumerate(lengths)]

    def put(saved):
        i = 0
        for t in bufs:
            for b, n in enumerate(lengths):
                t[:, b, :, n:min(n + width, cap)] = saved[i]
                i += 1

    remaining = np.asarray([s.remaining if s is not None else 0 for s in engine._slots],
                           np.int32)
    eos = np.asarray([s.eos_id if s is not None and s.eos_id is not None else -1
                      for s in engine._slots], np.int32)
    if engine._unified:
        state0 = [t.clone() for t in (prog.tokens, prog.lengths, prog.keys, prog.temps,
                                      prog.topk, prog.topp)]
        inputs = list(engine._parked_superstep())
        for i, s in enumerate(engine._slots):
            if s is not None:
                inputs[0][i, 0] = s.generated[-1]
                inputs[1][i], inputs[3][i] = llama.ROLE_DECODE, 1
                inputs[5][i], inputs[6][i], inputs[7][i] = True, remaining[i], eos[i]
        window = gen.superstep_window(max(pos), 0, K, cap)

        def load():
            prog.load_state(*state0)
            prog.stage(*inputs)

        def replay():
            prog.dispatch(window, sampling)

        def outs():
            return [prog._out.clone(), prog.tokens.clone(), prog.lengths.clone(),
                    prog.keys.clone(), prog.temps.clone(), prog.topk.clone(), prog.topp.clone()]
    else:
        window = gen.decode_window_bucket(min(max(pos) + K - 1, cap), cap)

        def load():
            prog.load(engine._tokens, engine._cache.lengths, engine._keys, engine._temps,
                      engine._topk, engine._topp, np.asarray(occupied), remaining, eos)

        def replay():
            prog.harvest(prog.dispatch(window, sampling))

        def outs():
            return [prog.tok_block.clone(), prog.valid.clone(), prog.lengths.clone(),
                    prog.tokens.clone(), prog.keys.clone()]
    try:
        before = rows()
        load()
        replay()
        torch.cuda.synchronize()
        graph = (rows(), outs())
        put(before)
        load()
        prog._run(window, sampling)
        torch.cuda.synchronize()
        eager = (rows(), outs())
        put(before)
    finally:
        if engine._unified:
            prog.load_state(*state0)
        torch.cuda.synchronize()
    same = (all(torch.equal(a, b) for a, b in zip(graph[0], eager[0]))
            and all(torch.equal(a, b) for a, b in zip(graph[1], eager[1])))
    if not same:
        raise AssertionError(f"the replay after a restore differs from the eager tick "
                             f"(window {window}, sampling {sampling})")
    return {"window": window, "sampling": sampling, "rows": int(sum(occupied))}


def _preempt_by_hand(engine, V: int, tag: str) -> dict:
    """Drive a built, not started engine's scheduler by hand: four
    best-effort streams (one sampled), and once each holds PRE_TRIGGER
    tokens an interactive request, submitted from a stream's ``on_token``.
    Every occupied slot's cache row over ``[0, hist)`` and its state rows
    are snapshot just before the admission phase that evicts; the restore
    is held to the victim's snapshot bit-equal (the int8 cache also to the
    snapshot requantized on the card, ``_requantized``; the CPU quantizer's
    difference on it is reported) with the state rows bit-equal and, on the
    unified engine, the engine's state still the program's buffers; then
    one graph replay on the restored state against the eager tick.  Evict
    and restore ms are synchronized host walls."""
    import numpy as np
    import torch

    rng = np.random.default_rng(41)
    n_be, n_ia = PRE_HAND_NEW
    quant = engine._kv_quant
    counts = [0] * PRE_SLOTS
    ia: list = []

    def on_tok(i):
        def f(_t):
            counts[i] += 1
            if not ia and min(counts) >= PRE_TRIGGER:
                ia.append(engine.submit(rng.integers(1, V, PRE_IA[0]).tolist(), n_ia,
                                        slo_class="interactive"))
        return f

    be = [engine.submit(rng.integers(1, V, PRE_BE[0]).tolist(), n_be, on_token=on_tok(i),
                        slo_class="best-effort", **(dict(PRE_SAMPLED, seed=99) if i == 1 else {}))
          for i in range(PRE_SLOTS)]
    snaps: dict = {}
    res: dict = {"evict_ms": [], "restore_ms": [], "kv_bytes": [], "checks": [],
                 "cpu_quantizer_diff": []}
    real_evict, real_restore = engine._evict_slot, engine._admit_restore

    def evict(idx):
        res["evict_ms"].append(_synced_ms(real_evict, idx))
        rec = engine._class_queues["best-effort"][0]
        res["kv_bytes"].append(sum(t.nbytes for pair in rec.chunks for t in pair))
        snaps[id(rec.generated)] = snaps.pop(idx)

    def restore(rec):
        res["restore_ms"].append(_synced_ms(real_restore, rec))
        j = next(i for i, s in enumerate(engine._slots)
                 if s is not None and s.generated is rec.generated)
        rows, state, hist = snaps.pop(id(rec.generated))
        got = [t[:, j, :, :hist] for t in _kv_bufs(engine)]
        if quant:
            # The round trip on the card's own quantizer; a bf16 engine's
            # scales (a bf16 amax over 127) come back exactly, so it is the
            # snapshot itself (the rule the CPU tests hold).
            want = _requantized(rows, rows[0].device)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{tag}: the restored int8 row differs from its "
                                     "snapshot requantized on the card")
            # Reported: the CPU's quantizer on the same snapshot.
            cpu = _requantized(rows, "cpu")
            res["cpu_quantizer_diff"].append(
                sum(int((a.cpu() != b).sum()) for a, b in zip(want, cpu)))
        changed = sum(int((a != b).sum()) for a, b in zip(got, rows))
        if changed:
            raise AssertionError(f"{tag}: the restored row differs from its snapshot in "
                                 f"{changed} elements")
        if not all(torch.equal(a, b) for a, b in zip(_slot_state(engine, j), state)):
            raise AssertionError(f"{tag}: the restored state rows differ from the snapshot")
        if engine._unified:
            prog = engine._program
            pairs = ((engine._tokens, prog.tokens), (engine._keys, prog.keys),
                     (engine._temps, prog.temps), (engine._topk, prog.topk),
                     (engine._topp, prog.topp), (engine._cache.lengths, prog.lengths))
            if not all(a.data_ptr() == b.data_ptr() for a, b in pairs):
                raise AssertionError(f"{tag}: a restore rebound the super-step's buffers")
        replay = _replay_after_restore(engine)
        res["checks"].append({"slot": j, "hist": hist, "replay": replay})

    engine._evict_slot, engine._admit_restore = evict, restore
    try:
        deadline = time.time() + 300
        while not all(f.done() for f in be + ia):
            if time.time() > deadline:
                raise AssertionError(f"{tag}: the hand-driven run did not finish")
            if ia and not engine.preemptions:
                # Every tick boundary until the eviction: the snapshot is
                # the one the evicting admission phase sees.
                snaps.clear()
                for i, s in enumerate(engine._slots):
                    if s is not None:
                        hist = s.prompt_len + len(s.generated) - 1
                        snaps[i] = ([t[:, i, :, :hist].clone() for t in _kv_bufs(engine)],
                                    _slot_state(engine, i), hist)
                        if int(snaps[i][1][0]) != hist or int(snaps[i][1][1]) != s.generated[-1]:
                            raise AssertionError(f"{tag}: slot {i}'s state rows lag its host "
                                                 "view at the tick boundary")
            if not engine._admit_phase():
                raise AssertionError(f"{tag}: the scheduler saw its shutdown sentinel")
            engine._step()
    finally:
        engine._evict_slot, engine._admit_restore = real_evict, real_restore
    outs = [f.result(timeout=0).tolist() for f in be]
    if any(len(o) != n_be for o in outs) or len(ia[0].result(timeout=0)) != n_ia:
        raise AssertionError(f"{tag}: a stream came back short")
    if engine.preemptions < 1 or engine.preempt_restores != engine.preemptions:
        raise AssertionError(f"{tag}: {engine.preemptions} evictions, "
                             f"{engine.preempt_restores} restores")
    if len(res["checks"]) != engine.preempt_restores or engine.preempt_recomputed_tokens:
        raise AssertionError(f"{tag}: {len(res['checks'])} restores checked")
    res.update(preemptions=engine.preemptions, restores=engine.preempt_restores,
               l2_hits=engine._prefix_cache.l2_hits, prefix_hits=engine.prefix_hits)
    return res


def _preempt_traffic(s: dict, V: int, rng) -> dict:
    """5g's traffic on one server: four best-effort SSE streams (one seeded
    and sampled), and once each has PRE_TRIGGER tokens two interactive SSE
    requests; client TTFT of each from its events' arrival."""
    import threading

    path = "/v2/models/llama2-7b/generate"
    be = [{"prompt_ids": rng.integers(1, V, PRE_BE[0]).tolist(), "max_new_tokens": PRE_BE[1],
           "slo_class": "best-effort"} for _ in range(PRE_SLOTS)]
    be[1].update(PRE_SAMPLED, seed=4321)
    ia = [{"prompt_ids": rng.integers(1, V, PRE_IA[0]).tolist(), "max_new_tokens": PRE_IA[1],
           "slo_class": "interactive"} for _ in range(2)]
    reached = [threading.Event() for _ in be]

    def mark(i):
        return lambda n: n >= PRE_TRIGGER and reached[i].set()

    with ThreadPoolExecutor(len(be) + len(ia)) as pool:
        be_f = [pool.submit(_sse, s["port"], path, b, mark(i)) for i, b in enumerate(be)]
        for e, f in zip(reached, be_f):
            while not e.wait(1.0):
                if f.done():
                    f.result()  # raises what failed
                    raise AssertionError("a best-effort stream ended before its trigger")
        ia_f = [pool.submit(_sse, s["port"], path, b) for b in ia]
        ia_out = [f.result() for f in ia_f]
        be_out = [f.result() for f in be_f]
    for st, n in [(x, PRE_BE[1]) for x in be_out] + [(x, PRE_IA[1]) for x in ia_out]:
        if len(st["tokens"]) != n or not all(0 <= t < V for t in st["tokens"]):
            raise AssertionError(f"a stream returned {len(st['tokens'])} tokens, not {n}")
    return {"be": [x["tokens"] for x in be_out], "ia": [x["tokens"] for x in ia_out],
            "ttft_ms": [(x["times"][0] - x["t_send"]) * 1e3 for x in ia_out],
            "be_bodies": be}


def phase_serve_7b_preempt(da, rn, fa, ss, smi: str, params, quantize: str,
                           layers: int | None = None) -> dict:
    """Phase 5g on Llama-2-7B, uncut: (a) an engine driven by hand
    (``_preempt_by_hand``), the split engine at K 4 on ``none``, the unified
    one on int8kv; (b) a server with ``--slo-class batch --preemption 1``
    serving ``_preempt_traffic``, every best-effort stream whole, restores
    equal to evictions, nothing recomputed, ``/metrics``' preemption
    counters equal to the engine's, every unified tick a graph replay, and
    the launch identities over the served traffic (counters set to 0 just
    before it); on ``none`` also the same traffic on a server with classes
    but no preemption, whose interactive TTFT the preempting one's is set
    beside and whose best-effort streams are the clean run.  ``layers``:
    the tree cut to its first ``layers`` layers (widths whole)."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    app = import_module(f"{PKG}.server.app")
    cfg = llama.LlamaConfig.llama2_7b()
    if layers is not None and layers < cfg.num_layers:
        params, cfg = _cut_depth(params, layers), dataclasses.replace(cfg, num_layers=layers)
    L, V = cfg.num_layers, cfg.vocab_size
    K = 4
    tag = f"7B preempt {quantize}" + (f" ({L} layers)" if layers else "")
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def config(preemption=True):
        return app.config_from_args(app.build_arg_parser().parse_args(
            _preempt_argv(quantize, preemption)))

    # (a) in process.
    engine = app.make_gen_engine(predictor, config(), app.ServerMetrics("d", "v1", "ns"))
    engine._capture = True
    engine._capture_graphs()
    try:
        hand = _preempt_by_hand(engine, V, tag)
    finally:
        engine.shutdown()  # never started: drops the graphs and fails nothing
        del engine
        torch.cuda.empty_cache()
    log(f"{tag} (a): {hand['preemptions']} evictions, {hand['restores']} restores by hand; "
        f"each restored row and state held to its snapshot ("
        + ("bit-equal" if quantize == "none" else "bit-equal, and equal to the snapshot "
           "requantized from bf16(code x scale) on the card; the CPU's quantizer on the "
           f"same snapshot differs in {hand['cpu_quantizer_diff']} elements")
        + "), the replay after it bit-equal "
        f"to eager ({[c['replay'] for c in hand['checks']]}); evict ms "
        f"{[round(x, 3) for x in hand['evict_ms']]}, restore ms "
        f"{[round(x, 3) for x in hand['restore_ms']]} (synchronized), KV bytes an eviction "
        f"{hand['kv_bytes']}; L2 hits {hand['l2_hits']}")

    # (b) served.
    names = ["preempt"] + (["classes"] if quantize == "none" else [])
    servers: dict[str, dict] = {}
    try:
        for name in names:
            srv = app.build_server(predictor, config(preemption=name == "preempt"))
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            port = srv.server_address[1]
            servers[name] = {"srv": srv, "th": th, "port": port, "engine": srv.engine,
                             "prog": srv.engine._program, "base": f"http://127.0.0.1:{port}"}
            _post(servers[name]["base"] + "/v2/models/llama2-7b/generate",
                  {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up
        pre = servers["preempt"]["engine"]
        walls: dict[str, list] = {"evict": [], "restore": []}
        real_evict, real_restore = pre._evict_slot, pre._admit_restore
        kv_bytes: list[int] = []

        def evict(idx):
            walls["evict"].append(_synced_ms(real_evict, idx))
            rec = pre._class_queues["best-effort"][0]
            kv_bytes.append(sum(t.nbytes for pair in rec.chunks for t in pair))

        pre._evict_slot = evict
        pre._admit_restore = lambda rec: walls["restore"].append(_synced_ms(real_restore, rec))

        def now(name):
            e, d = servers[name]["engine"], servers[name]["engine"].dispatches_total
            prog = servers[name]["prog"]
            return {"da": da.launches, "va": da.verify_launches, "rn": rn.launches,
                    "fa": fa.launches, "fr": fa.ragged_launches, "ss": ss.launches,
                    "superstep": d.get("superstep", 0), "decode": d.get("decode", 0),
                    "verify": d.get("verify", 0), "multistep": d.get("multistep", 0),
                    "prefills": e.prefill_forwards, "samples": e.sample_steps,
                    "replays": prog.replays if prog is not None else 0}

        def settle(name):
            e = servers[name]["engine"]
            if not e._unified:
                _settle([e], {e: (0, 0)})

        for name in names:
            settle(name)
        scrape0 = _scrape(servers["preempt"]["base"])
        # The served traffic is this phase's main path: the counters start at 0.
        da.launches = da.verify_launches = rn.launches = fa.launches = 0
        fa.ragged_launches = ss.launches = 0
        counted, runs = {}, {}
        for name in names:
            snap = now(name)
            runs[name] = _preempt_traffic(servers[name], V, np.random.default_rng(43))
            settle(name)
            counted[name] = {k: v - snap[k] for k, v in now(name).items()}
        pre._evict_slot, pre._admit_restore = real_evict, real_restore
        launches = {"da": da.launches, "va": da.verify_launches, "rn": rn.launches,
                    "fa": fa.launches, "fr": fa.ragged_launches, "ss": ss.launches}
        for key, n in launches.items():
            if n != sum(c[key] for c in counted.values()):
                raise AssertionError(f"{tag}: {key} launched {n} times, the servers' runs "
                                     f"{[c[key] for c in counted.values()]}")
        for name, c in counted.items():
            e = servers[name]["engine"]
            if e._unified:
                ticks = c["superstep"]
                want = {"da": L * K * ticks, "va": L * ticks, "rn": (2 * L + 1) * K * ticks,
                        "fa": 0, "fr": 0, "ss": c["samples"]}
                kinds = set(e.dispatches_total) - {"superstep", "seed", "preempt-evict",
                                                   "preempt-restore"}
                if kinds or c["replays"] != ticks or ticks == 0:
                    raise AssertionError(f"{tag} {name}: {ticks} super-step ticks, "
                                         f"{c['replays']} replays, other kinds {kinds}")
            else:
                fwd = c["decode"] + c["verify"] + K * c["multistep"]
                want = {"da": L * fwd, "va": L * c["verify"],
                        "rn": (2 * L + 1) * (fwd + c["prefills"]),
                        "fa": L * c["prefills"], "fr": 0, "ss": c["samples"]}
                if c["multistep"] == 0 or c["replays"] != c["multistep"]:
                    raise AssertionError(f"{tag} {name}: {c['multistep']} multistep "
                                         f"dispatches, {c['replays']} replays")
            bad = {k: (c[k], w) for k, w in want.items() if c[k] != w}
            if bad:
                raise AssertionError(f"{tag} {name}: launches (counted, expected) {bad}")
        n_pre, n_res = pre.preemptions, pre.preempt_restores
        if n_pre < 1 or n_res != n_pre or pre.preempt_recomputed_tokens:
            raise AssertionError(f"{tag}: {n_pre} evictions, {n_res} restores, "
                                 f"{pre.preempt_recomputed_tokens} recomputed")
        sc = _scrape(servers["preempt"]["base"])
        metric = {ev: _value(sc, "tpumlops_engine_preempt_total", event=ev)
                  - _value(scrape0, "tpumlops_engine_preempt_total", event=ev)
                  for ev in ("evict", "restore")}
        if metric != {"evict": n_pre, "restore": n_res}:
            raise AssertionError(f"{tag}: /metrics preemptions {metric}, engine "
                                 f"{n_pre} / {n_res}")
        if "classes" in servers and servers["classes"]["engine"].preemptions:
            raise AssertionError(f"{tag}: the server without preemption evicted")
        # The clean run: the same best-effort streams uninterrupted (the
        # classes-only server's on none; again alone on the same server
        # on int8kv).
        if "classes" in runs:
            clean = runs["classes"]["be"]
        else:
            with ThreadPoolExecutor(PRE_SLOTS) as pool:
                clean = list(pool.map(
                    lambda b: _sse(servers["preempt"]["port"],
                                   "/v2/models/llama2-7b/generate", b)["tokens"],
                    runs["preempt"]["be_bodies"]))
        greedy = [i for i in range(PRE_SLOTS) if i != 1]
        agreement = _agreement([runs["preempt"]["be"][i] for i in greedy],
                               [clean[i] for i in greedy])
        seeded_equal = runs["preempt"]["be"][1] == clean[1]
        ttft = {n: {"p50_ms": float(np.median(r["ttft_ms"])), "max_ms": max(r["ttft_ms"]),
                    "all_ms": r["ttft_ms"]} for n, r in runs.items()}
        res = {"quantize": quantize, "hand": hand, "ttft": ttft, "evict_ms": walls["evict"],
               "restore_ms": walls["restore"], "kv_bytes": kv_bytes,
               "preemptions": n_pre, "restores": n_res, "metrics": metric,
               "l2_hits": pre._prefix_cache.l2_hits, "prefix_hits": pre.prefix_hits,
               "counted": counted, "launches": launches,
               "greedy_agreement_vs_clean": agreement, "seeded_equal_clean": seeded_equal,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"{tag} (b): interactive TTFT p50 / max "
            + "; ".join(f"{n} {t['p50_ms']:.1f} / {t['max_ms']:.1f} ms" for n, t in ttft.items())
            + f"; {n_pre} evictions = {n_res} restores = /metrics {metric}; evict ms "
            f"{[round(x, 3) for x in walls['evict']]}, restore ms "
            f"{[round(x, 3) for x in walls['restore']]} (synchronized); KV bytes an eviction "
            f"{kv_bytes}; L2 hits {res['l2_hits']}, prefix hits {res['prefix_hits']}; the "
            f"preempted greedy streams' agreement with the clean run {agreement:.3f} "
            f"(reported), the seeded one equal: {seeded_equal}; launches {launches} "
            f"(identities held per server: {counted}); peak {res['peak_gib']:.2f} GiB on {smi}")
        DETAIL[f"serve_7b_preempt_{quantize}"] = res
        return res
    finally:
        for s in servers.values():
            s["srv"].shutdown_all()
            s["th"].join(timeout=30)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5h: the observed replica (recorder, timeseries ring, device
# telemetry, watchdog) and its containment
# ---------------------------------------------------------------------------

OBS_DEADLINE_S = 2.0   # the watchdog deadline of phase 5h's server
OBS_WEDGE_S = 3.5      # the injected dispatch's sleep: past the deadline
OBS_RATIO_MAX = 1.05   # a tick's unclamped utilization above this is a fault
OBS_LEDGER_PCT = 5.0   # the HBM ledger against torch.cuda.memory_allocated()
OBS_PROFILE_S = 2.0
OBS_TURNS = 4          # single requests with the options on, and as many off


def _idle(engine, timeout: float = 60.0) -> None:
    """Wait until the engine holds no request and its last burst's harvest
    is in (it may follow the answer by one tick)."""
    deadline = time.perf_counter() + timeout
    while any(s is not None for s in engine._slots) or engine._pending:
        if time.perf_counter() > deadline:
            raise AssertionError("the engine never went idle")
        time.sleep(0.01)
    time.sleep(0.1)


def _chrome_trace_invariants(doc: dict) -> None:
    """What every Chrome export of the flight recorder satisfies (the
    reference's test invariants): complete events are engine ticks on tid 0
    (or a relayed request's handoff) with non-negative durations; every
    async request span's begin pairs with exactly one end on the same track,
    never before it; token instants sit inside their request's span."""
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise AssertionError("empty Chrome trace")
    for e in events:
        if not isinstance(e["ph"], str) or ("ts" in e and not isinstance(e["ts"], int)):
            raise AssertionError(f"bad event {e}")
        if e.get("pid") != 1 and e["ph"] != "M":
            raise AssertionError(f"event off pid 1: {e}")
    for t in (e for e in events if e["ph"] == "X"):
        if t["dur"] < 0 or t["cat"] not in ("tick", "handoff"):
            raise AssertionError(f"bad complete event {t}")
        if t["cat"] == "tick" and t["tid"] != 0:
            raise AssertionError(f"a tick off the tick track: {t}")
    begins = {e["id"]: e for e in events if e["ph"] == "b"}
    ends = {e["id"]: e for e in events if e["ph"] == "e"}
    if set(begins) != set(ends) or len([e for e in events if e["ph"] == "b"]) != len(begins):
        raise AssertionError("request spans do not pair up")
    for rid, b in begins.items():
        e = ends[rid]
        if e["ts"] < b["ts"] or e["tid"] != b["tid"] or not (e["cat"] == b["cat"] == "request"):
            raise AssertionError(f"request span {rid}: {b} / {e}")
    for tok in (e for e in events if e.get("cat") == "token"):
        rid = tok["args"]["request_id"]
        if not begins[rid]["ts"] <= tok["ts"] <= ends[rid]["ts"]:
            raise AssertionError(f"a token of {rid} outside its span")


def phase_serve_7b_observed(da, rn, fa, ss, smi: str, params, ms_none: dict,
                            layers: int | None = None) -> dict:
    """Phase 5h on Llama-2-7B (``layers``: the tree cut to its first
    ``layers`` layers, widths whole, as 5e's): one ``none`` split K 4 server (4
    slots, whole prompts, phase 5e's K 4 server) with ``--trace-ring``,
    ``--timeseries-ring``, ``--device-telemetry`` and
    ``--watchdog-deadline-s`` all on.  The HBM ledger against the caching
    allocator; the compile observatory's capture events (one a graph);
    tokens/s alone against 5e's K 4 server (``ms_none``) in turns as 5e
    ran them; MFU and HBM-bandwidth shares by tick kind from
    ``/debug/device`` and the recorder's ticks, every tick's unclamped
    ratio (cost model over its wall) at most ``OBS_RATIO_MAX``; the Chrome
    trace's invariants; ``POST /debug/profile`` under traffic naming the
    decode-attention and RMSNorm kernels; an injected wedge (one dispatch
    sleeps past the deadline: ``/readyz`` 503 within the deadline + 1 s, 200
    again, one stall, a ``watchdog`` event; ``on_exit`` a recording
    callable); an injected poison prompt (two admission crashes, each
    recapturing the graphs with the watchdog disarmed around it, then a
    422, an innocent request served), launch identities over the served
    traffic (counters set to 0 just before it), then one replay bit-equal
    to eager on the recaptured graphs."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    prng = import_module(f"{PKG}.models.prng")
    app = import_module(f"{PKG}.server.app")
    build = import_module(f"{PKG}.ops._build")
    cfg = llama.LlamaConfig.llama2_7b()
    if layers is not None and layers < cfg.num_layers:
        params, cfg = _cut_depth(params, layers), dataclasses.replace(cfg, num_layers=layers)
    L, V, K = cfg.num_layers, cfg.vocab_size, 4
    tag = "7B observed none" + (f" ({L} layers)" if layers is not None else "")
    t_phase = time.perf_counter()
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    config = app.ServerConfig(model_name="llama2-7b", host="127.0.0.1", port=0,
                              quantize="none", max_slots=4, device="cuda", decode_steps=K,
                              trace_ring=4096, timeseries_ring=600, device_telemetry=True,
                              watchdog_deadline_s=OBS_DEADLINE_S, watchdog_grace_s=600.0)
    gc.collect()  # earlier phases' engines in reference cycles
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    srv = app.build_server(predictor, config)
    build_s = time.perf_counter() - t0
    engine, tel, rec = srv.engine, srv.telemetry, srv.recorder
    wd = engine._watchdog
    exits: list = []
    wd.on_exit = lambda: exits.append(time.perf_counter())  # the process must not exit
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    url = base + "/v2/models/llama2-7b/generate"
    res: dict = {"build_s": build_s}
    try:
        # -- the ledger and the observatory, before any traffic ----------------
        torch.cuda.synchronize()
        status, dev, _ = _call("GET", base + "/debug/device")
        if status != 200:
            raise AssertionError(f"{tag}: /debug/device answered {status}")
        hbm = dev["hbm"]
        allocated = torch.cuda.memory_allocated()
        comps = hbm["components"]
        weights = sum(v for k, v in comps.items() if k.startswith("weights_"))
        engine_own = hbm["device_total_bytes"] - weights
        # What the process held before the server beyond the weights (earlier
        # phases' leftovers) is not this replica's: the ledger is held to the
        # rest.
        other = alloc0 - weights
        pct = 100.0 * (hbm["device_total_bytes"] - (allocated - other)) / (allocated - other)
        res["ledger"] = {"components": comps, "device_total": hbm["device_total_bytes"],
                         "other_before_bytes": other,
                         "server_ledger_vs_measured_pct": hbm.get("ledger_vs_measured_pct"),
                         "graph_pool_reserved": engine._program.pool_bytes(),
                         "measured": hbm["measured"], "allocated": allocated,
                         "ledger_vs_measured_pct": pct,
                         "engine_own_ledger": engine_own,
                         "engine_own_allocated": allocated - alloc0}
        if abs(pct) > OBS_LEDGER_PCT or hbm["measured"]["bytes_in_use"] < allocated - other:
            raise AssertionError(f"{tag}: the HBM ledger {hbm['device_total_bytes']} B against "
                                 f"{allocated} B allocated less {other} B held before: "
                                 f"{pct:.2f} % (tolerance {OBS_LEDGER_PCT} %)")
        if dev["peaks"]["source"] != "detected" or dev["peaks"]["device"] != "nvidia-h100":
            raise AssertionError(f"{tag}: peaks {dev['peaks']}")
        prog = engine._program
        comp = dev["compile"]
        captures = [e for e in comp["events"] if e["op"] == "multistep" and e["warmup"]]
        if len(captures) != len(prog.graphs) or comp["warmup"]["ops"] != {
                "multistep": len(prog.graphs)}:
            raise AssertionError(f"{tag}: {len(captures)} capture events for "
                                 f"{len(prog.graphs)} graphs ({comp['warmup']})")
        hits = sum(r["cache_hits"] for op, r in comp["ops"].items() if op in build.SOURCES)
        if hits != len(build.SOURCES):
            raise AssertionError(f"{tag}: {hits} kernel build cache hits at start")
        res["observatory"] = {"captures": len(captures),
                              "capture_s": sum(e["seconds"] for e in captures),
                              "program_capture_s": prog.capture_s, "warmup": comp["warmup"],
                              "build_cache_hits": hits}
        log(f"{tag}: server built in {build_s:.1f} s; HBM ledger {hbm['device_total_bytes']} B "
            f"({', '.join(f'{k} {v}' for k, v in comps.items())}) against "
            f"torch.cuda.memory_allocated() {allocated} B less the {other} B the process held "
            f"before the server beyond the weights: {pct:.2f} % (tolerance {OBS_LEDGER_PCT} %; "
            f"/debug/device's own {hbm.get('ledger_vs_measured_pct')} %); the engine's own "
            f"components {engine_own} B against "
            f"{allocated - alloc0} B allocated by building it (the graph pool holds "
            f"{res['ledger']['graph_pool_reserved']} B reserved); observatory: "
            f"{len(captures)} graph captures ({res['observatory']['capture_s']:.2f} s of "
            f"{prog.capture_s:.2f} s capture), {hits} kernel builds found built")

        # -- the served traffic, launches counted ---------------------------------
        ticks: list = []
        record = engine._record_tick

        def spy(kind, t0, wall_s, **kw):
            ticks.append((kind, wall_s, kw.get("cost")))
            record(kind, t0, wall_s, **kw)

        engine._record_tick = spy
        _post(url, {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up
        rng = np.random.default_rng(29)
        single_prompt = rng.integers(1, V, 5).tolist()  # phase 5e's single request
        disp0, pre0 = dict(engine.dispatches_total), engine.prefill_forwards
        samp0, replays0 = engine.sample_steps, prog.replays
        da.launches = rn.launches = fa.launches = ss.launches = 0
        # The options' overhead on this server: turns with every option on
        # and with the recorder, telemetry, watchdog and ring hooks taken off
        # the engine in place (on, off, off, on, ...), each turn one 5 + 24
        # request alone, the engine idle between turns.
        m = srv.metrics
        on_state = (engine._recorder, engine._telemetry, engine._watchdog, engine._sync_ticks,
                    engine.on_step, engine.on_itl, engine.on_tick, engine.on_shed)
        off_state = (None, None, None, False, m.observe_decode_step, m.observe_itl,
                     m.observe_tick, m.inc_shed)

        def options(on: bool) -> None:
            _idle(engine)
            if not on:
                wd.disarm()
            (engine._recorder, engine._telemetry, engine._watchdog, engine._sync_ticks,
             engine.on_step, engine.on_itl, engine.on_tick, engine.on_shed) = (
                on_state if on else off_state)
            if on:
                wd.arm()

        tok_s: dict = {"on": [], "off": []}
        for turn in range(2 * OBS_TURNS):
            on = turn % 4 in (0, 3)
            options(on)
            t0 = time.perf_counter()
            _check_outputs(_post(url, {"prompt_ids": single_prompt, "max_new_tokens": MS_NEW}),
                           [MS_NEW], V)
            tok_s["on" if on else "off"].append(MS_NEW / (time.perf_counter() - t0))
        options(True)
        long_prompt = rng.integers(1, V, 250).tolist()  # a 256-token prefill bucket
        _check_outputs(_post(url, {"prompt_ids": long_prompt, "max_new_tokens": 8}), [8], V)
        _check_outputs(_post(url, {"prompt_ids": single_prompt, "max_new_tokens": 16,
                                   "temperature": 0.8, "top_k": 50, "top_p": 0.95,
                                   "seed": 4321}), [16], V)
        base_tok_s = ms_none["by_k"][4]["single_tok_s"]
        # Against 5e's K 4 server only where 5e served the same depth.
        same_depth = ms_none.get("layers", L) == L
        res["overhead"] = {"tok_s": tok_s, "phase_5e_k4_tok_s": base_tok_s,
                           "phase_5e_layers": ms_none.get("layers", L),
                           "on_over_off": float(np.median(tok_s["on"])
                                                / np.median(tok_s["off"])),
                           "on_over_5e": (float(np.median(tok_s["on"]) / np.median(base_tok_s))
                                          if same_depth else None)}
        vs_5e = (f"{res['overhead']['on_over_5e']:.3f}" if same_depth
                 else f"not comparable (5e served {ms_none.get('layers')} layers)")
        log(f"{tag}: single 5+{MS_NEW} tok/s with every option on "
            f"{[round(x, 2) for x in tok_s['on']]}, off on the same server "
            f"{[round(x, 2) for x in tok_s['off']]} (in turns): on / off "
            f"{res['overhead']['on_over_off']:.3f}; against phase 5e's K 4 server "
            f"{[round(x, 2) for x in base_tok_s]}: {vs_5e}")

        # /debug/profile under traffic.
        stop_traffic = threading.Event()
        traffic_errors: list = []

        prompts = [rng.integers(1, V, n).tolist() for n in (17, 130, 300)]

        def traffic():
            i = 0
            while not stop_traffic.is_set():
                try:
                    _post(url, {"prompt_ids": prompts[i % 3], "max_new_tokens": 16})
                except Exception as e:  # surfaced below: a failed request fails the phase
                    traffic_errors.append(repr(e))
                    return
                i += 1

        pool = [threading.Thread(target=traffic, daemon=True) for _ in range(2)]
        for t in pool:
            t.start()
        time.sleep(0.5)
        stalls0 = wd.stalls_total
        t_prof = time.perf_counter()
        status, prof, _ = _call("POST", base + "/debug/profile", {"duration_s": OBS_PROFILE_S},
                                timeout=120)
        prof_wall = time.perf_counter() - t_prof
        stop_traffic.set()
        for t in pool:
            t.join(timeout=120)
        if traffic_errors or status != 200:
            raise AssertionError(f"{tag}: profile {status} {prof}; traffic {traffic_errors}")
        # A capture under traffic may hold the scheduler (the profiler's stop
        # and export): the watchdog reads that as a stall, reported here.
        _idle(engine)
        prof_stalls = wd.stalls_total - stalls0
        prof_events = [e for e in _call("GET", base + "/debug/engine")[1]["events"]
                       if e["event"] == "watchdog"]
        trace_path = Path(prof["trace_dir"]) / "trace.json"
        text = trace_path.read_text()
        named = {k: text.count(k) for k in ("decode_attention_kernel", "rmsnorm_kernel")}
        if not all(named.values()):
            cats: dict = {}
            for e in json.loads(text).get("traceEvents", []):
                cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
            raise AssertionError(f"{tag}: the profile names {named}; {len(text)} B of trace, "
                                 f"events by category {cats}, answered after {prof_wall:.1f} s")
        res["profile"] = {"trace_dir": prof["trace_dir"], "bytes": trace_path.stat().st_size,
                          "kernel_name_count": named, "wall_s": prof_wall,
                          "stalls": prof_stalls,
                          "stall_age_s": [e["age_s"] for e in prof_events]}
        log(f"{tag}: POST /debug/profile ({OBS_PROFILE_S} s under two request loops) answered "
            f"after {prof_wall:.1f} s and wrote {trace_path.stat().st_size} B of Chrome trace "
            f"naming {named}; watchdog stalls during it {prof_stalls} (ages "
            f"{res['profile']['stall_age_s']} s)")
        trace_path.unlink()  # tens of MB; the directory stays for the GC

        # The injected wedge: one dispatch sleeps past the deadline.
        real_ms = engine._device_multistep
        wedge: dict = {}

        def wedged(window, sampling):
            if "t" not in wedge:
                wedge["t"] = time.perf_counter()
                time.sleep(OBS_WEDGE_S)
            return real_ms(window, sampling)

        engine._device_multistep = wedged
        stalls0, events0 = wd.stalls_total, len(prof_events)
        with ThreadPoolExecutor(1) as one:
            fut = one.submit(_post, url, {"prompt_ids": single_prompt, "max_new_tokens": 24})
            t_flip = t_back = None
            deadline = time.perf_counter() + 60
            while time.perf_counter() < deadline:
                code = _call("GET", base + "/readyz")[0]
                now = time.perf_counter()
                if code == 503 and t_flip is None and "t" in wedge:
                    t_flip = now - wedge["t"]
                if code == 200 and t_flip is not None:
                    t_back = now - wedge["t"]
                    break
                time.sleep(0.05)
            _check_outputs(fut.result(timeout=120), [24], V)
        engine._device_multistep = real_ms
        sc = _scrape(base)
        stalls = _value(sc, "tpumlops_engine_watchdog_stalls_total") - stalls0
        events = _call("GET", base + "/debug/engine")[1]["events"]
        wd_events = [e for e in events if e["event"] == "watchdog"][events0:]
        if (t_flip is None or t_flip > OBS_DEADLINE_S + 1.0 or t_back is None or stalls != 1
                or len(wd_events) != 1 or wd_events[0]["kind"] != "multistep"
                or not wd_events[0]["slots"] or exits):
            raise AssertionError(f"{tag}: wedge: readyz 503 after {t_flip} s, 200 after "
                                 f"{t_back} s, stalls {stalls}, events {wd_events}, exits {exits}")
        res["wedge"] = {"readyz_503_after_s": t_flip, "readyz_200_after_s": t_back,
                        "stalls": stalls, "event": wd_events[0]}
        log(f"{tag}: a dispatch wedged {OBS_WEDGE_S} s: /readyz 503 after {t_flip:.2f} s "
            f"(deadline {OBS_DEADLINE_S} s), 200 again after {t_back:.2f} s; stalls {stalls:.0f}, "
            f"one watchdog event (kind {wd_events[0]['kind']}, age "
            f"{wd_events[0]['age_s']} s, {len(wd_events[0]['slots'])} slots in flight)")

        # The injected poison: two admission crashes of one prompt.
        poison = rng.integers(1, V, 7).tolist()
        real_admit = engine._device_admit

        def crashing_admit(ids, slot_idx, L_, slot_key, req):
            if req.prompt.tolist() == poison:
                raise RuntimeError("injected admission crash")
            return real_admit(ids, slot_idx, L_, slot_key, req)

        engine._device_admit = crashing_admit
        codes = [_call("POST", url, {"prompt_ids": poison, "max_new_tokens": 4})[0]
                 for _ in range(2)]
        deadline = time.perf_counter() + 60
        while engine.poison_quarantined_total < 1 and time.perf_counter() < deadline:
            time.sleep(0.05)
        code3, body3, _ = _call("POST", url, {"prompt_ids": poison, "max_new_tokens": 4})
        engine._device_admit = real_admit
        innocent = _check_outputs(_post(url, {"prompt_ids": single_prompt,
                                              "max_new_tokens": MS_NEW}), [MS_NEW], V)[0]
        dev = _call("GET", base + "/debug/device")[1]
        recaptures = [e for e in dev["compile"]["events"] if not e["warmup"]]
        if (codes != [500, 500] or code3 != 422 or body3.get("reason") != "poison_quarantined"
                or len(recaptures) != 2 * len(engine._program.graphs)
                or wd.stalls_total != stalls0 + 1 or srv.lifecycle != "ready"):
            raise AssertionError(f"{tag}: poison: {codes}, {code3} {body3}, "
                                 f"{len(recaptures)} recapture events, stalls "
                                 f"{wd.stalls_total}, lifecycle {srv.lifecycle}")
        n_graphs = len(engine._program.graphs)
        res["poison"] = {"codes": codes + [code3], "body": body3,
                         "recapture_s": [round(sum(e["seconds"] for e in part), 3) for part in
                                         (recaptures[:n_graphs], recaptures[n_graphs:])]}
        log(f"{tag}: a poison prompt crashed admission twice ({codes}; each recovery "
            f"recaptured {n_graphs} graphs in {res['poison']['recapture_s']} s, the watchdog "
            f"disarmed around it: no stall added), then {code3} {body3['reason']} (crashes "
            f"{body3['crashes']}); an innocent request served {len(innocent)} tokens")

        # Launch identities over the served traffic, once the last burst's
        # harvest is in (it may follow the answer).  Each recapture's two
        # eager warm-up runs (greedy, sampled; K steps at the smallest
        # window) launched on the card too.
        recaps = 2
        deadline = time.perf_counter() + 60
        while True:
            d = engine.dispatches_total.get("decode", 0) - disp0.get("decode", 0)
            m = engine.dispatches_total.get("multistep", 0) - disp0.get("multistep", 0)
            p = engine.prefill_forwards - pre0
            samples = engine.sample_steps - samp0
            launches = {"da": da.launches, "rn": rn.launches, "fa": fa.launches,
                        "ss": ss.launches}
            want = {"da": L * (d + K * m) + recaps * 2 * L * K,
                    "rn": (2 * L + 1) * (d + K * m + p) + recaps * 2 * (2 * L + 1) * K,
                    "fa": L * p, "ss": samples + recaps * K}
            if launches == want or time.perf_counter() > deadline:
                break
            time.sleep(0.01)
        engine._record_tick = record
        if launches != want or not m or not samples:
            raise AssertionError(f"{tag}: launches {launches}, for decode {d}, multistep {m}, "
                                 f"prefill {p}, sampling steps {samples} and {recaps} "
                                 f"recaptures: {want}")
        res["launches"] = launches
        res["dispatches"] = {"decode": d, "multistep": m, "prefill": p, "sampling": samples,
                             "recaptures": recaps}

        # Utilization by tick kind: the recorder's ticks and /debug/device.
        eng_snap = _call("GET", base + "/debug/engine")[1]
        by_kind: dict = {}
        for t in eng_snap["ticks"]:
            if "mfu" in t:
                k = by_kind.setdefault(t["kind"], {"mfu": [], "hbm_bw_util": []})
                k["mfu"].append(t["mfu"])
                k["hbm_bw_util"].append(t["hbm_bw_util"])
        ratios: dict = {}
        for kind, wall, cost in ticks:
            if cost is None:
                continue
            r = max(cost[0] / wall / BF16_TENSOR_FLOPS, cost[1] / wall / HBM_BYTES_PER_S)
            ratios.setdefault(kind, []).append(r)
        worst = max(max(v) for v in ratios.values())
        util = {kind: {"n": len(v["mfu"]),
                       "mfu_median": float(np.median(v["mfu"])), "mfu_max": max(v["mfu"]),
                       "hbm_bw_util_median": float(np.median(v["hbm_bw_util"])),
                       "hbm_bw_util_max": max(v["hbm_bw_util"]),
                       "unclamped_max": max(ratios.get(kind, [0.0]))}
                for kind, v in by_kind.items()}
        res["utilization"] = {"by_kind": util, "last": dev["utilization"],
                              "unclamped_max": worst}
        if worst > OBS_RATIO_MAX:
            raise AssertionError(f"{tag}: a tick's unclamped ratio {worst:.3f} > "
                                 f"{OBS_RATIO_MAX} (the cost model or the wall is wrong): {util}")
        per_token = 2.0 * llama.matmul_param_count(cfg)  # a prefill's flops a position
        prefill256 = [(c[0] / w / BF16_TENSOR_FLOPS) for kind, w, c in ticks
                      if kind == "prefill" and c is not None and 256 <= c[0] / per_token < 512]
        res["utilization"]["prefill_256_mfu"] = prefill256
        log(f"{tag}: utilization by tick kind (recorder ticks; median / max): " + "; ".join(
            f"{k} n {u['n']} MFU {u['mfu_median']:.4g} / {u['mfu_max']:.4g}, HBM-bandwidth "
            f"{u['hbm_bw_util_median']:.3f} / {u['hbm_bw_util_max']:.3f}"
            for k, u in sorted(util.items()))
            + f"; a 256-token prefill's MFU {[round(x, 3) for x in prefill256]}; every tick's "
            f"unclamped ratio at most {worst:.3f} (limit {OBS_RATIO_MAX}); /debug/device's last "
            f"ticks {dev['utilization']}")

        # The Chrome export and the timeseries ring.
        status, doc, _ = _call("GET", base + "/debug/trace?format=chrome")
        _chrome_trace_invariants(doc)
        ts = _call("GET", base + "/debug/timeseries")[1]
        with_util = sum(1 for s in ts["samples"] if "mfu" in s)
        if not ts["samples"] or not with_util:
            raise AssertionError(f"{tag}: timeseries {len(ts['samples'])} samples, "
                                 f"{with_util} with utilization")
        res["chrome_events"] = len(doc["traceEvents"])
        res["timeseries"] = {"samples": len(ts["samples"]), "with_util": with_util}
        log(f"{tag}: the Chrome trace ({len(doc['traceEvents'])} events) passes the "
            f"recorder's invariants; the timeseries ring holds {len(ts['samples'])} seconds, "
            f"{with_util} with MFU and bandwidth")
        # One replay against eager on the recaptured graphs, the scheduler idle
        # (its launches are not counted above).
        res["graph_vs_eager"] = {mode: {"valid": r["valid"]}
                                 for mode, r in _graph_vs_eager(engine, prng).items()
                                 if mode in ("greedy", "sampled")}
    finally:
        srv.shutdown_all()
        th.join(timeout=30)
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"{tag}: after the recaptures one replay equals one eager decode_multistep, greedy "
        f"and sampled; launches {res['launches']} ({res['dispatches']}); phase wall "
        f"{res['wall_s']:.1f} s on {smi}")
    DETAIL["serve_7b_observed_none"] = res
    return res


# ---------------------------------------------------------------------------
# Phase 5i: the KV handoff between a prefill and a decode replica
# ---------------------------------------------------------------------------

HANDOFF_PROMPT = 600  # tokens: 2 whole chunks of 256 to hand off, 88 to prefill
HANDOFF_NEW = 16


def _http_bytes(method: str, url: str, data: bytes | None = None,
                content_type: str = "application/json", timeout: float = 600):
    """(status, raw body, headers) of one HTTP call whose body or answer is
    binary (a KV handoff blob)."""
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _fleet_server(app, predictor, role: str, device: str):
    config = app.ServerConfig(
        model_name="llama2-7b", host="127.0.0.1", port=0, quantize="none", max_slots=4,
        device=device, prefix_cache=True, prefix_cache_chunk=256,
        prefix_cache_budget_mb=1024, trace_ring=1024, fleet_role=role)
    srv = app.build_server(predictor, config)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{srv.server_address[1]}"


def _debug_generate(url: str, prompt, n: int, vocab: int) -> tuple[list[int], dict, float]:
    t0 = time.perf_counter()
    resp = _post(url, {"prompt_ids": prompt, "max_new_tokens": n, "debug": True})
    wall = time.perf_counter() - t0
    return _check_outputs(resp, [n], vocab)[0], resp["timing"], wall


def phase_serve_7b_handoff(da, rn, fa, smi: str, params, device: str = "cuda") -> dict:
    """Phase 5i on Llama-2-7B, uncut (``params``: the bf16 tree): a
    ``--fleet-role prefill`` and a ``--fleet-role decode`` server (``none``,
    split K 1, 4 slots, prefix cache chunks of 256, 1024 MB: 8 chunks) on the
    one weight tree, each with its own KV and radix caches, over HTTP.  A
    600-token prompt is exported cold (the exporter prefills) and warm (the
    same bytes), imported, read back bit-equal; the importer's 16 greedy
    tokens equal the exporter's own cache-hit serve; a corrupt blob is a
    400, chunks of 128 tokens a 409; the ``kv-import`` tick is on
    ``/debug/trace``; four other prompts evict the imported chunks and the
    prompt is served cold on the importer (agreement reported).  Launch
    identities over the served traffic (counters set to 0 just before it)."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    app = import_module(f"{PKG}.server.app")
    kv = import_module(f"{PKG}.server.kv_transfer")
    cfg = llama.LlamaConfig.llama2_7b()
    L, V = cfg.num_layers, cfg.vocab_size
    tag = "7B handoff none"
    t_phase = time.perf_counter()
    gc.collect()  # earlier phases' engines in reference cycles
    torch.cuda.empty_cache()
    predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
    rng = np.random.default_rng(61)
    prompt = rng.integers(1, V, HANDOFF_PROMPT).tolist()
    others = [rng.integers(1, V, 520).tolist() for _ in range(4)]
    servers = [_fleet_server(app, predictor, role, device) for role in ("prefill", "decode")]
    (exp_srv, _, exp_base), (imp_srv, _, imp_base) = servers
    exp, imp = exp_srv.engine, imp_srv.engine
    gen_path = "/v2/models/llama2-7b/generate"
    res: dict = {}
    try:
        for _, _, base in servers:
            _post(base + gen_path, {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})  # warm-up
            if _call("GET", base + "/readyz")[1].get("fleetRole") not in ("prefill", "decode"):
                raise AssertionError(f"{tag}: /readyz names no fleet role")
        torch.cuda.synchronize()
        engines = (exp, imp)
        disp0 = {e: dict(e.dispatches_total) for e in engines}
        pre0 = {e: e.prefill_forwards for e in engines}
        da.launches = rn.launches = fa.launches = 0
        body = json.dumps({"prompt_ids": prompt}).encode()

        t0 = time.perf_counter()
        code, blob, hdrs = _http_bytes("POST", exp_base + "/admin/kv/export", body)
        export_cold_ms = (time.perf_counter() - t0) * 1e3
        if code != 200 or hdrs.get("X-Tpumlops-Kv-Tokens") != "512":
            raise AssertionError(f"{tag}: cold export answered {code} {hdrs} {blob[:200]!r}")
        t0 = time.perf_counter()
        code, blob2, _ = _http_bytes("POST", exp_base + "/admin/kv/export", body)
        export_warm_ms = (time.perf_counter() - t0) * 1e3
        if code != 200 or blob2 != blob:
            raise AssertionError(f"{tag}: the warm export differs from the cold one")
        arr = np.asarray(prompt, np.int32)
        t0 = time.perf_counter()
        matched, exp_chunks = exp.export_prefix_kv(arr)
        lookup_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        again = kv.serialize_chunks(256, arr, exp_chunks)
        serialize_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        kv.deserialize_chunks(blob, pin_memory=device == "cuda")
        deserialize_ms = (time.perf_counter() - t0) * 1e3
        if matched != 512 or again != blob:
            raise AssertionError(f"{tag}: {matched} tokens in the exporter's cache, or its "
                                 "chunks serialize to other bytes than the export's")
        del again

        t0 = time.perf_counter()
        code, raw, _ = _http_bytes("POST", imp_base + "/admin/kv/import", blob,
                                   "application/octet-stream")
        import_ms = (time.perf_counter() - t0) * 1e3
        if code != 200 or json.loads(raw) != {"imported_tokens": 512, "chunks": 2}:
            raise AssertionError(f"{tag}: import answered {code} {raw[:300]!r}")
        got, imp_chunks = imp.export_prefix_kv(arr)
        same = got == 512 and all(torch.equal(a, b) for pa, pb in zip(exp_chunks, imp_chunks)
                                  for a, b in zip(pa, pb))
        if not same:
            raise AssertionError(f"{tag}: the imported chunks, read back, differ from the "
                                 "exported ones")
        del imp_chunks
        imp_toks, imp_timing, imp_wall = _debug_generate(imp_base + gen_path, prompt,
                                                         HANDOFF_NEW, V)
        exp_toks, exp_timing, _ = _debug_generate(exp_base + gen_path, prompt, HANDOFF_NEW, V)
        if imp_timing["cached_tokens"] != 512 or exp_timing["cached_tokens"] != 512:
            raise AssertionError(f"{tag}: cached tokens {imp_timing['cached_tokens']} / "
                                 f"{exp_timing['cached_tokens']}, expected 512 / 512")
        if imp_toks != exp_toks:
            raise AssertionError(f"{tag}: the importer's tokens {imp_toks} differ from the "
                                 f"exporter's cache-hit serve {exp_toks}")

        corrupt = bytearray(blob)
        corrupt[-1] ^= 0xFF
        code, raw, _ = _http_bytes("POST", imp_base + "/admin/kv/import", bytes(corrupt),
                                   "application/octet-stream")
        if code != 400 or json.loads(raw).get("reason") != "bad_blob":
            raise AssertionError(f"{tag}: a corrupt blob answered {code} {raw[:200]!r}")
        del corrupt
        half = kv.serialize_chunks(128, arr, [(k[:, :, :128], v[:, :, :128])
                                              for k, v in exp_chunks])
        code, raw, _ = _http_bytes("POST", imp_base + "/admin/kv/import", half,
                                   "application/octet-stream")
        if code != 409 or json.loads(raw).get("reason") != "geometry_mismatch":
            raise AssertionError(f"{tag}: chunks of 128 tokens answered {code} {raw[:200]!r}")
        del half, exp_chunks
        trace = _call("GET", imp_base + "/debug/trace")[1]
        ticks = [e for e in trace["traceEvents"]
                 if e.get("cat") == "tick" and e.get("name") == "kv-import"]
        if len(ticks) != 1:
            raise AssertionError(f"{tag}: {len(ticks)} kv-import ticks on /debug/trace")
        import_tick_ms = ticks[0]["dur"] / 1e3

        ev0 = imp.prefix_evictions
        for p in others:
            _post(imp_base + gen_path, {"prompt_ids": p, "max_new_tokens": 1})
        cold_toks, cold_timing, cold_wall = _debug_generate(imp_base + gen_path, prompt,
                                                            HANDOFF_NEW, V)
        if imp.prefix_evictions - ev0 < 2 or cold_timing["cached_tokens"] != 0:
            raise AssertionError(f"{tag}: the cold serve found {cold_timing['cached_tokens']} "
                                 f"cached tokens after {imp.prefix_evictions - ev0} evictions")
        torch.cuda.synchronize()
        decodes = sum(e.dispatches_total.get("decode", 0) - disp0[e].get("decode", 0)
                      for e in engines)
        prefills = sum(e.prefill_forwards - pre0[e] for e in engines)
        launches = {"da": da.launches, "rn": rn.launches, "fa": fa.launches}
        want = {"da": L * decodes, "rn": (2 * L + 1) * (decodes + prefills), "fa": L * prefills}
        if launches != want or not all(launches.values()):
            raise AssertionError(f"{tag}: launches {launches}, expected {want}")
        res = {
            "blob_bytes": len(blob), "tokens": 512, "chunks": 2,
            "export_cold_ms": export_cold_ms, "export_warm_ms": export_warm_ms,
            "lookup_ms": lookup_ms, "serialize_ms": serialize_ms,
            "wire_ms": export_warm_ms - lookup_ms - serialize_ms,
            "deserialize_ms": deserialize_ms, "import_ms": import_ms,
            "import_tick_ms": import_tick_ms,
            "ttft_after_import_ms": imp_timing["ttft_ms"], "wall_after_import_s": imp_wall,
            "ttft_cold_ms": cold_timing["ttft_ms"], "wall_cold_s": cold_wall,
            "prefix_recompute_ms": cold_timing["ttft_ms"] - imp_timing["ttft_ms"],
            "handoff_ms": export_warm_ms + import_ms,
            "token_agreement_vs_cold": _agreement([imp_toks], [cold_toks]),
            "tokens_after_import": imp_toks, "tokens_cold": cold_toks,
            "decode_ticks": decodes, "prefill_forwards": prefills, "launches": launches,
        }
    finally:
        for srv, th, _ in servers:
            srv.shutdown_all()
            th.join(timeout=30)
        del servers, exp_srv, imp_srv, exp, imp, predictor
        gc.collect()
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"{tag}: {res['blob_bytes'] / 2**20:.0f} MiB blob (512 tokens); export cold "
        f"{res['export_cold_ms']:.1f} ms (its prefill included), warm {export_warm_ms:.1f} ms "
        f"(lookup {lookup_ms:.1f}, serialize {serialize_ms:.1f}, wire {res['wire_ms']:.1f}); "
        f"deserialize {deserialize_ms:.1f} ms; import {import_ms:.1f} ms (its tick "
        f"{import_tick_ms:.2f} ms); TTFT after the import {res['ttft_after_import_ms']:.1f} ms "
        f"against {res['ttft_cold_ms']:.1f} ms cold (the prefix's recompute "
        f"{res['prefix_recompute_ms']:.1f} ms); the importer's 16 tokens equal the "
        f"exporter's cache-hit serve; agreement with the cold serve "
        f"{res['token_agreement_vs_cold']:.3f}; launches {res['launches']}; phase wall "
        f"{res['wall_s']:.1f} s on {smi}")
    DETAIL["serve_7b_handoff_none"] = res
    return res


# ---------------------------------------------------------------------------
# Phase 5j: weight snapshots, the warm pool and attach
# ---------------------------------------------------------------------------

ATTACH_PROMPT = 300
ATTACH_NEW = 16
ATTACH_K = 4
# Llama-2-7B's widths at this depth for 5j's snapshot, attach and direct
# start (at 32 layers the attach's capture alone took 41-60 s): cut for the
# smoke's time limit.
ATTACH_LAYERS = 8
SNAPSHOT_DIR = ROOT / "build" / "smoke_snapshots"  # ignored by git, deleted after


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _cut_depth(tree, n: int):
    """The tree with its first ``n`` layers (every leaf under ``layers`` is
    stacked on the layer axis); widths unchanged."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:n]

    return {**tree, "layers": cut(tree["layers"])}


def _attach_server(app, config):
    srv = app.build_server(None, config)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{srv.server_address[1]}"


def phase_serve_7b_attach(da, rn, fa, smi: str, params, quantize_s: float,
                          device: str = "cuda") -> dict:
    """Phase 5j on Llama-2-7B (``params``: the ``int8`` tree, quantized from
    the bf16 draw in ``quantize_s``): its snapshot written under
    ``SNAPSHOT_DIR`` (the free disk checked first; fewer layers only if the
    disk cannot hold ``ATTACH_LAYERS``), a ``--warm-pool`` server (split K 4,
    4 slots, chunks of 256) prewarmed from it, the typed 503s before an attach, the
    attach (a restore, graphs captured after it), one greedy request
    bit-equal to the same tree served directly, a second attach a no-op, a
    flipped byte a typed ``SnapshotError``; on a one-layer full-width
    artifact, an attach of a snapshot with a flipped byte loads cold, bakes
    again and serves.  The attach against the cold path of this run: the
    quantize, then the direct server's start (its graph capture).  The tree
    is cut to its first ``ATTACH_LAYERS`` layers (widths whole), or fewer
    where the disk cannot hold that."""
    import numpy as np
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    registry = import_module(f"{PKG}.models.registry")
    app = import_module(f"{PKG}.server.app")
    loader = import_module(f"{PKG}.server.loader")
    snap = import_module(f"{PKG}.server.snapshot")
    cfg = llama.LlamaConfig.llama2_7b()
    tag = "7B attach int8"
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    SNAPSHOT_DIR.mkdir(parents=True)
    tree_bytes = _tree_bytes(params)
    full_layers = cfg.num_layers
    per_layer = _tree_bytes(params["layers"]) // full_layers
    free = shutil.disk_usage(SNAPSHOT_DIR).free
    # The 7B snapshot, the one-layer artifact (bf16) and its two bakes, with room.
    small = 3 * (tree_bytes - _tree_bytes(params["layers"]) + 2 * per_layer)
    layers, why = min(cfg.num_layers, ATTACH_LAYERS), "time limit"
    if 1.1 * (tree_bytes - per_layer * (full_layers - layers)) + small > free:
        layers = int((free / 1.1 - small - (tree_bytes - per_layer * full_layers)) // per_layer)
        why = "disk"
        if layers < 1:
            raise AssertionError(f"{tag}: {free / 2**30:.1f} GiB free cannot hold one layer")
    if layers < full_layers:
        params = _cut_depth(params, layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
        tree_bytes = _tree_bytes(params)
    L, V = cfg.num_layers, cfg.vocab_size
    uri = "smoke/llama2-7b-int8"
    res: dict = {"free_disk_gib": free / 2**30, "layers": L,
                 "cut": None if L == full_layers else f"depth {L} of {full_layers} ({why})"}
    rng = np.random.default_rng(71)
    body = {"prompt_ids": rng.integers(1, V, ATTACH_PROMPT).tolist(),
            "max_new_tokens": ATTACH_NEW}
    conf = dict(model_name="llama2-7b", host="127.0.0.1", port=0, quantize="int8",
                max_slots=4, prefill_chunk=256, decode_steps=ATTACH_K, device=device,
                snapshot_dir=str(SNAPSHOT_DIR))
    try:
        ident = snap.snapshot_identity(uri, "int8", loader.SNAPSHOT_MESH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spath = snap.write_snapshot(SNAPSHOT_DIR, params, identity=ident,
                                    flavor="llama-generate", config=dataclasses.asdict(cfg))
        res["write_s"] = time.perf_counter() - t0
        manifest = snap.read_manifest(spath)
        res["snapshot_gib"] = manifest["total_bytes"] / 2**30
        if manifest["total_bytes"] != tree_bytes:
            raise AssertionError(f"{tag}: the snapshot holds {manifest['total_bytes']} B of a "
                                 f"{tree_bytes} B tree")

        t0 = time.perf_counter()
        wp, wth, wbase = _attach_server(app, app.ServerConfig(warm_pool=True, model_uri=uri,
                                                              **conf))
        res["warm_pool_boot_s"] = time.perf_counter() - t0
        try:
            code, ready, _ = _call("GET", wbase + "/readyz")
            if code != 503 or ready.get("lifecycle") != "warm-pool":
                raise AssertionError(f"{tag}: /readyz before an attach {code} {ready}")
            code, shed, hdrs = _call("POST", wbase + "/v2/models/llama2-7b/generate", body)
            if code != 503 or shed.get("reason") != "warm_pool_empty":
                raise AssertionError(f"{tag}: generate before an attach {code} {shed}")
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            code, att, _ = _call("POST", wbase + "/admin/attach", {"model_uri": uri})
            res["attach_wall_s"] = time.perf_counter() - t0
            if code != 200 or att.get("restored") is not True:
                raise AssertionError(f"{tag}: the attach answered {code} {att} (a restore "
                                     "was expected, not a cold load)")
            stats = att["load_breakdown_s"]
            res.update(restore_s=stats["restore_s"], disk_s=stats["disk_s"],
                       transfer_s=stats["transfer_s"], read_gib=stats["read_gib"],
                       capture_s=att["capture_s"],
                       restore_gb_per_s=manifest["total_bytes"] / 1e9 / stats["restore_s"],
                       snapshot_hash=att["snapshot_hash"])
            engine = wp.engine
            res["graphs"] = len(engine._program.graphs)
            if res["graphs"] == 0:
                raise AssertionError(f"{tag}: the attached engine captured no graph")
            if _call("GET", wbase + "/readyz")[0] != 200:
                raise AssertionError(f"{tag}: /readyz not 200 after the attach")
            disp0, pre0 = dict(engine.dispatches_total), engine.prefill_forwards
            base0 = {engine: (engine._program.replays, disp0.get("multistep", 0))}
            da.launches = rn.launches = fa.launches = 0
            attached = _check_outputs(_post(wbase + "/v2/models/llama2-7b/generate", body),
                                      [ATTACH_NEW], V)[0]
            _settle([engine], base0)
            torch.cuda.synchronize()
            d = engine.dispatches_total.get("decode", 0) - disp0.get("decode", 0)
            m = engine.dispatches_total.get("multistep", 0) - disp0.get("multistep", 0)
            p = engine.prefill_forwards - pre0
            launches = {"da": da.launches, "rn": rn.launches, "fa": fa.launches}
            want = {"da": L * (d + ATTACH_K * m),
                    "rn": (2 * L + 1) * (d + ATTACH_K * m + p), "fa": L * p}
            if launches != want or not all(launches.values()) or m == 0:
                raise AssertionError(f"{tag}: launches {launches}, expected {want} "
                                     f"({d} decode ticks, {m} multistep, {p} prefills)")
            res.update(launches=launches, decode_ticks=d, multistep=m, prefill_forwards=p)
            code, noop, _ = _call("POST", wbase + "/admin/attach", {"model_uri": uri})
            if code != 200 or noop.get("noop") is not True or wp.engine is not engine:
                raise AssertionError(f"{tag}: a second attach answered {code} {noop}")
            del engine
        finally:
            wp.shutdown_all()
            wth.join(timeout=30)
            del wp
            gc.collect()
            torch.cuda.empty_cache()

        chunk = sorted(spath.glob("chunk-*.bin"))[0]
        with open(chunk, "r+b") as f:
            f.seek(1000)
            byte = f.read(1)
            f.seek(1000)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            snap.load_snapshot(spath, identity=ident, device=device)
        except snap.SnapshotError as e:
            if type(e) is not snap.SnapshotError or "CRC" not in str(e):
                raise
            res["flipped_byte"] = str(e)
        else:
            raise AssertionError(f"{tag}: a snapshot with a flipped byte restored")

        # The cold path of this run: the quantize from the bf16 draw, then a
        # direct server's start on the same tree (its graph capture).
        predictor = registry._build_llama(params, cfg, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        ds = app.build_server(predictor, app.ServerConfig(**{**conf, "snapshot_dir": ""}))
        res["direct_start_s"] = time.perf_counter() - t0
        dth = threading.Thread(target=ds.serve_forever, daemon=True)
        dth.start()
        try:
            direct = _check_outputs(
                _post(f"http://127.0.0.1:{ds.server_address[1]}/v2/models/llama2-7b/generate",
                      body), [ATTACH_NEW], V)[0]
        finally:
            ds.shutdown_all()
            dth.join(timeout=30)
            del ds, predictor
            gc.collect()
            torch.cuda.empty_cache()
        if attached != direct:
            raise AssertionError(f"{tag}: the attached replica's tokens {attached} differ from "
                                 f"the tree served directly {direct}")
        res.update(tokens=attached, quantize_s=quantize_s,
                   cold_path_s=quantize_s + res["direct_start_s"])

        res["fallback"] = _attach_fallback(app, loader, snap, llama, conf, device)
    finally:
        shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"{tag}: snapshot {res['snapshot_gib']:.2f} GiB ({L} layers) written in "
        f"{res['write_s']:.2f} s; warm pool booted in {res['warm_pool_boot_s']:.2f} s; attach "
        f"{res['attach_wall_s']:.2f} s (restore {res['restore_s']:.2f} s, "
        f"{res['restore_gb_per_s']:.2f} GB/s; capture {res['capture_s']:.2f} s, "
        f"{res['graphs']} graphs) against the cold path {res['cold_path_s']:.2f} s (quantize "
        f"{quantize_s:.2f} s + start {res['direct_start_s']:.2f} s); the attached tokens equal "
        f"the direct serve; a flipped byte failed typed; the fallback served after a cold "
        f"load; launches {res['launches']}; phase wall {res['wall_s']:.1f} s on {smi}")
    DETAIL["serve_7b_attach_int8"] = res
    return res


def _attach_fallback(app, loader, snap, llama, conf: dict, device: str) -> dict:
    """On a one-layer Llama-2-7B-width artifact (bf16, drawn from a seed):
    a cold load bakes its snapshot, one byte of it is flipped, and a
    warm-pool attach of it fails the restore typed, moves it aside, loads
    cold, bakes again and serves."""
    import torch

    cfg1 = llama.LlamaConfig.llama2_7b(num_layers=1)
    art = SNAPSHOT_DIR / "layer1"
    tree = llama.init(torch.Generator(device=device).manual_seed(3), cfg1,
                      dtype=torch.bfloat16, device=device)
    loader.save_native_model(art, "llama-generate", tree, config=dataclasses.asdict(cfg1))
    del tree
    uri, sdir = str(art), str(SNAPSHOT_DIR / "fallback")
    loader.load_predictor(uri, quantize="int8", device=device, snapshot_dir=sdir)
    spath = snap.snapshot_path_for(sdir, uri)
    chunk = sorted(spath.glob("chunk-*.bin"))[0]
    raw = bytearray(chunk.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    chunk.write_bytes(bytes(raw))
    del raw
    srv, th, base = _attach_server(app, app.ServerConfig(
        **{**conf, "decode_steps": 1, "snapshot_dir": sdir, "warm_pool": True,
           "model_uri": uri}))
    try:
        t0 = time.perf_counter()
        code, att, _ = _call("POST", base + "/admin/attach", {"model_uri": uri})
        wall = time.perf_counter() - t0
        if code != 200 or att.get("restored") is not False:
            raise AssertionError(f"fallback attach answered {code} {att}")
        if not list(spath.parent.glob(f"{spath.name}.corrupt-*")):
            raise AssertionError("the corrupt snapshot was not moved aside")
        if not (spath / snap.MANIFEST_NAME).exists():
            raise AssertionError("the cold load did not bake the snapshot again")
        _check_outputs(_post(base + "/v2/models/llama2-7b/generate",
                             {"prompt_ids": [5, 9, 2, 7], "max_new_tokens": 4}),
                       [4], cfg1.vocab_size)
    finally:
        srv.shutdown_all()
        th.join(timeout=30)
    return {"attach_wall_s": wall, "load_breakdown_s": att["load_breakdown_s"]}


# ---------------------------------------------------------------------------
# Phase 5k: the 7B rehearsal (the repo-root CLIs' artifact and its load)
# ---------------------------------------------------------------------------

REHEARSAL_DIR = ROOT / "build" / "smoke_ckpt7b"  # ignored by git, deleted after
REHEARSAL_BUDGET_S = 60.0  # phase 5k's share of SMOKE_LIMIT_S: the write, load and decode
# The loaded model's last logits against phase 5's tree's through the same
# chain, max |difference| over max |logit|: the same leaves and kernels, so
# 0 unless a GEMM picks another order between the two runs.
REHEARSAL_TOL = 1e-3


def phase_7b_write(params) -> dict:
    """Phase 5k's first half: phase 5's bf16 draw (all 32 layers) written
    through the port's ``scripts/gen_7b_checkpoint.py`` writer under
    ``build/`` at the reference's geometry (max_seq 1024), after the disk's
    free space is checked against the tree's bytes."""
    from importlib import import_module

    gen = import_module(f"{PKG}.scripts.gen_7b_checkpoint")
    quant = import_module(f"{PKG}.models.quantization")
    g = gen.GEOMETRY
    shapes = {"embed": (g["vocab_size"], g["hidden_size"]),
              "q": (g["num_layers"], g["hidden_size"], g["hidden_size"]),
              "down": (g["num_layers"], g["intermediate_size"], g["hidden_size"])}
    got = {"embed": tuple(params["embed"].shape), "q": tuple(params["layers"]["q"].shape),
           "down": tuple(params["layers"]["down"].shape)}
    if got != shapes:
        raise AssertionError(f"5k: phase 5's tree {got} is not the artifact's geometry {shapes}")
    need = quant.quantized_bytes(params)
    shutil.rmtree(REHEARSAL_DIR, ignore_errors=True)
    REHEARSAL_DIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(REHEARSAL_DIR.parent).free
    if free < need + (1 << 30):
        raise AssertionError(f"5k: the 7B artifact needs {need} bytes (and 1 GiB spare) but "
                             f"{free} bytes are free under {REHEARSAL_DIR.parent}")
    t0 = time.perf_counter()
    nbytes = gen.write_checkpoint(REHEARSAL_DIR, params)
    write_s = time.perf_counter() - t0
    log(f"5k: phase 5's bf16 tree written through gen_7b_checkpoint: {nbytes / 1e9:.2f} GB "
        f"in {write_s:.1f} s ({nbytes / 1e9 / write_s:.2f} GB/s; {free / 1e9:.1f} GB were free)")
    return {"path": REHEARSAL_DIR, "bytes": nbytes, "write_s": write_s, "free_bytes": free}


def phase_7b_rehearsal(da, rn, fa, smi: str, written: dict, want: dict) -> dict:
    """Phase 5k's second half: ``scripts/rehearse_7b_load.py``'s
    ``rehearse`` on the artifact ``phase_7b_write`` wrote (the loader's
    streamed int8 load at full depth, the memory above what the card held
    before, 8 greedy steps after a 16-token prefill), launch counts over it
    (counters set to 0 just before); then every loaded leaf bit-equal to
    ``want``, phase 5's ``quantize_llama`` of the same bf16 tree, and the
    same greedy chain on ``want`` giving the same tokens and logits bit for
    bit.  The artifact is deleted at the end."""
    import torch
    from importlib import import_module

    rehearse = import_module(f"{PKG}.scripts.rehearse_7b_load")
    loader = import_module(f"{PKG}.server.loader")
    t_phase = time.perf_counter()
    try:
        torch.cuda.empty_cache()
        da.launches = rn.launches = fa.launches = 0
        out = rehearse.rehearse(written["path"], "cuda", log=lambda m: log(f"5k: {m}"))
        launches = {"da": da.launches, "rn": rn.launches, "fa": fa.launches}
        pred = out.pop("predictor")
        got = loader._flatten(pred.causal_lm["params"])
        ref = loader._flatten(want)
        if sorted(got) != sorted(ref):
            raise AssertionError(f"5k: the loaded tree's leaves {sorted(got)} are not "
                                 f"phase 5's {sorted(ref)}")
        differ = [k for k in ref if not (got[k].dtype == ref[k].dtype
                                         and torch.equal(got[k], ref[k]))]
        if differ:
            raise AssertionError(f"5k: loaded leaves {differ} differ from quantize_llama's")
        tokens, logits = rehearse.greedy_chain(want, pred.causal_lm["cfg"], torch.device("cuda"))
        logits = logits.float().cpu()
        same = torch.equal(logits, out["logits"])
        gap = float((logits - out["logits"]).abs().max() / logits.abs().max())
        if tokens != out["tokens"] or gap > REHEARSAL_TOL:
            raise AssertionError(f"5k: the loaded model's tokens {out['tokens']} are not phase "
                                 f"5's tree's {tokens}, or its logits are {gap:.3e} away")
        del pred, got, logits
        if min(launches.values()) <= 0:
            raise AssertionError(f"5k: the rehearsal launched {launches}")
    finally:
        shutil.rmtree(written["path"], ignore_errors=True)
        torch.cuda.empty_cache()
    stats = out["load_stats"]
    res = {"write_s": written["write_s"], "bytes": written["bytes"], "load_s": out["load_s"],
           "load_stats": stats, "read_gb_s": stats["read_gib"] * 2**30 / 1e9 / out["load_s"],
           "stored_bytes": out["stored_bytes"], "loaded": out["loaded"],
           "decoded": out["decoded"], "decode_s": out["decode_s"], "tokens": out["tokens"],
           "launches": launches, "leaves_equal": len(ref), "logits_bit_equal": same,
           "layers": int(want["layers"]["attn_norm"].shape[0]),
           "wall_s": written["write_s"] + time.perf_counter() - t_phase}
    log(f"5k: {res['layers']} layers loaded int8 in {out['load_s']:.2f} s (stages {stats}; "
        f"read {res['read_gb_s']:.2f} GB/s, warm page cache), resident "
        f"{out['loaded']['allocated'] / 2**30:.2f} GiB, load peak "
        f"{out['loaded']['peak'] / 2**30:.2f} GiB, decode peak "
        f"{out['decoded']['peak'] / 2**30:.2f} GiB above the {_tree_bytes(want) / 2**30:.2f} "
        f"GiB phase 5 held; {len(ref)} leaves bit-equal to quantize_llama's; greedy "
        f"{out['tokens']} ({out['decode_s']:.2f} s), the logits bit-equal to phase 5's tree's: "
        f"{same}; launches {launches}; phase wall {res['wall_s']:.1f} s with the write; {smi}")
    if res["wall_s"] > REHEARSAL_BUDGET_S:
        log(f"5k: WARNING phase wall {res['wall_s']:.1f} s over its "
            f"{REHEARSAL_BUDGET_S:.0f} s share")
    DETAIL["rehearse_7b_load"] = res
    return res


# ---------------------------------------------------------------------------
# Phase 6: BERT-base at full width over /v2/models/{name}/infer
# ---------------------------------------------------------------------------

# Logits of a served request against an in-process classify of the same
# unpadded ids through the plain attention, absolute and relative.  Both
# run bf16 weights; the served batch differs in shape (sequence and batch
# buckets), so cuBLAS may sum in another order, and int8 adds the per-token
# activation rounding of the other batch's GEMM shapes.
BERT_TOL = {"none": 3e-2, "int8": 5e-2}
# Phase 7: ResNet-50's served logits (f32 images, TF32 convolutions)
# against the same forward in f64 on the card, the largest absolute
# difference over the largest f64 logit; a row's top-1 must agree unless its
# f64 top-2 gap is under RESNET_GAP x that largest difference (a near tie).
RESNET_TOL = 5e-3
RESNET_GAP = 2.0


def _post_code(url: str, body: dict, timeout: float = 600) -> tuple[int, dict]:
    try:
        return 200, _post(url, body, timeout)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _v2_ids(ids) -> dict:
    return {"inputs": [{"name": "input_ids", "datatype": "INT32",
                        "shape": list(ids.shape), "data": ids.reshape(-1).tolist()}]}


def _metric_count(text: str, family: str, code: str) -> float:
    """Sum of ``family_count`` samples labelled ``code``."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(family + "_count{") and f'code="{code}"' in line:
            total += float(line.rsplit(" ", 1)[1])
    return total


def _serve_bert_once(fa, bert, loader, app, art, cfg, quantize: str) -> dict:
    import numpy as np
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = loader.load_predictor(str(art), quantize=quantize, device="cuda",
                                 dtype=torch.bfloat16)
    load_s = time.perf_counter() - t0
    want_act = "gelu" if quantize == "none" else "gelu_tanh"
    if pred.metadata["hidden_act"] != want_act:
        raise AssertionError(f"{quantize}: hidden_act {pred.metadata['hidden_act']}")
    config = app.ServerConfig(model_name="bert-base", host="127.0.0.1", port=0,
                              quantize=quantize, device="cuda", max_batch_size=32,
                              max_batch_delay_ms=5)
    t0 = time.perf_counter()
    srv = app.build_server(pred, config)
    warmup_s = time.perf_counter() - t0
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    url = base + "/v2/models/bert-base/infer"
    rng = np.random.default_rng(21)
    lens = rng.integers(8, 129, 60).tolist() + rng.integers(200, 513, 4).tolist()
    rng.shuffle(lens)
    singles = [rng.integers(1, cfg.vocab_size, (1, n)).astype(np.int32) for n in lens]
    batch = rng.integers(1, cfg.vocab_size, (32, 128)).astype(np.int32)
    eng = srv.engine
    try:
        d0 = eng.dispatches
        fa.launches = 0
        t_s = time.perf_counter()
        with ThreadPoolExecutor(32) as pool:
            single_resps = list(pool.map(lambda ids: _post_code(url, _v2_ids(ids)), singles))
        singles_s = time.perf_counter() - t_s
        batch_resp = _post_code(url, _v2_ids(batch))
        long_resp = _post_code(url, _v2_ids(np.ones((1, 600), np.int32)))
        torch.cuda.synchronize()
        launches, dispatches = fa.launches, eng.dispatches - d0

        if dispatches == 0 or launches != cfg.num_layers * dispatches:
            raise AssertionError(f"{quantize}: flash attention launched {launches} times for "
                                 f"{dispatches} batch dispatches; expected {cfg.num_layers} x")
        bad = [c for c, _ in single_resps if c != 200]
        if bad or batch_resp[0] != 200:
            raise AssertionError(f"{quantize}: non-200 answers {bad} / {batch_resp[0]}: "
                                 f"{batch_resp[1] if batch_resp[0] != 200 else ''}")
        if long_resp[0] != 400 or "exceeds" not in long_resp[1].get("error", ""):
            raise AssertionError(f"{quantize}: a 600-token request got {long_resp}")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            text = r.read().decode()
        fam = "seldon_api_executor_server_requests_seconds"
        n200, n400 = _metric_count(text, fam, "200"), _metric_count(text, fam, "400")
        if n200 != len(singles) + 1 or n400 != 1:
            raise AssertionError(f"{quantize}: /metrics counts 200={n200} 400={n400}, "
                                 f"expected {len(singles) + 1} and 1")

        def logits(resp):
            out = resp["outputs"][0]
            return np.asarray(out["data"], np.float32).reshape(out["shape"])

        got = [logits(r) for _, r in single_resps] + [logits(batch_resp[1])]
        # The same ids, unpadded, through the plain attention (the kernel
        # is swapped out for this reference only; the server is idle).
        orig = bert.flash_attention
        bert.flash_attention = fa.flash_attention_reference
        try:
            ref = [pred.predict(ids).float().cpu().numpy() for ids in singles + [batch]]
        finally:
            bert.flash_attention = orig
        tol = BERT_TOL[quantize]
        errs = [np.abs(g - r) for g, r in zip(got, ref)]
        max_err = max(float(e.max()) for e in errs)
        if any(not np.isfinite(g).all() or (e > tol + tol * np.abs(r)).any()
               for g, r, e in zip(got, ref, errs)):
            raise AssertionError(f"{quantize}: served logits disagree with the plain "
                                 f"path: max_abs_err {max_err:.3e} (tol {tol} abs + rel)")
        g_all, r_all = np.concatenate(got), np.concatenate(ref)
        agree = float((g_all.argmax(-1) == r_all.argmax(-1)).mean())

        # Batch latency at the headline shape, B32/S128, straight through
        # the engine with a synchronize per batch.
        ex = {"input_ids": batch, "attention_mask": np.ones_like(batch)}
        for _ in range(5):
            eng.predict(ex)
        lat = []
        for _ in range(60):
            t0 = time.perf_counter()
            eng.predict(ex)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(10):
            eng.predict(ex)
        torch.cuda.synchronize()
        wall10_ms = (time.perf_counter() - t0) * 1e3
        prof, prof_wall_ms = profile_device(lambda: eng.predict(ex), iters=10)
        busy_ms = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:12]
        flash_dev = sum(v for k, v in prof.items() if "flash_attention_kernel" in k)
        res = {
            "load_s": load_s, "warmup_s": warmup_s,
            "requests": len(singles) + 1, "singles_s": singles_s,
            "requests_per_s": len(singles) / singles_s,
            "lengths": lens, "flash_launches": launches, "batch_dispatches": dispatches,
            "metrics_200": n200, "metrics_400": n400,
            "max_abs_err": max_err, "argmax_agreement": agree,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "latencies_ms": lat, "busy_ms_10": busy_ms, "wall_ms_10": wall10_ms,
            "profiled_wall_ms_10": prof_wall_ms,
            "busy_share": busy_ms / wall10_ms, "flash_device_ms_10": flash_dev,
            "profile_top": top,
            "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        log(f"BERT-base {quantize}: {len(singles)} single requests (32 at a time, lengths "
            f"8-128 and four of 200-512) in {singles_s:.3f} s = "
            f"{res['requests_per_s']:.1f} req/s; one 32x128 client batch; a 600-token "
            f"request -> 400")
        log(f"  flash launches {launches} = {cfg.num_layers} x {dispatches} batch dispatches; "
            f"/metrics code=200 {n200:.0f}, code=400 {n400:.0f}; logits vs plain path "
            f"max_abs_err {max_err:.3e} (tol {tol}), argmax agreement {agree:.3f}")
        log(f"  B32/S128 batch latency p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms "
            f"(60 batches); device busy {busy_ms:.1f} of {wall10_ms:.1f} ms over 10 batches "
            f"(share {res['busy_share']:.3f}; flash kernel {flash_dev:.2f} ms); peak "
            f"{res['max_memory_gib']:.2f} GiB; load {load_s:.1f} s, warmup {warmup_s:.1f} s")
        for name, ms_ in top[:8]:
            log(f"  {ms_:9.3f} ms  {name[:110]}")
        return res
    finally:
        srv.shutdown_all()
        th.join(timeout=30)


def phase_serve_bert(fa) -> dict:
    """BERT-base (random weights from a seed) written as a native artifact
    by the port's writer, loaded by the port's loader twice (quantize none:
    bf16 with erf GELU; int8: int8 x int8 encoder GEMMs with tanh GELU) and
    served through ``build_server`` over HTTP."""
    import torch
    from importlib import import_module

    bert = import_module(f"{PKG}.models.bert")
    loader = import_module(f"{PKG}.server.loader")
    app = import_module(f"{PKG}.server.app")
    cfg = bert.BertConfig.base()
    torch.cuda.empty_cache()
    params = bert.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                       dtype=torch.bfloat16, device="cuda")
    # No hidden_act in the config: the int8 load switches to tanh-GELU.
    config = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "hidden_act"}
    scratch = ROOT / "build"  # ignored by git
    scratch.mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        art = loader.save_native_model(Path(tmp) / "bert-base", "bert-classifier", params,
                                       config=config, builder_kwargs={"seq_len": 128})
        del params
        for quantize in ("none", "int8"):
            out[quantize] = _serve_bert_once(fa, bert, loader, app, art, cfg, quantize)
    DETAIL["serve_bert"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 7: the V2 flavors (ResNet-50, xgboost, iris) and the Seldon routes
# ---------------------------------------------------------------------------

RESNET_IMAGE = 224
RESNET_BATCHES = (1, 8, 32)
# xgboost margins, absolute and relative: the product form against the
# gather form (tests/test_models_tabular.py's parity bar for the two
# forms), and each against a numpy traversal on the host summed in f64
# (200 f32 leaf sums: each addition rounds by up to 2^-24 of a partial sum),
# whose sigmoid the served probabilities also meet.
XGB_TOL = 1e-6
XGB_HOST_TOL = 1e-5
XGB_TREES, XGB_DEPTH, XGB_FEATURES, XGB_B = 200, 6, 32, 256


class _IrisLogistic:
    """What the ``sklearn-linear`` builder reads of a fitted
    ``LogisticRegression`` (the card's machine has no sklearn): ``coef_``,
    ``intercept_`` and a ``predict_proba``."""

    def __init__(self, rng):
        self.coef_ = rng.normal(size=(3, 4))
        self.intercept_ = rng.normal(size=3)

    def predict_proba(self, x):
        import numpy as np

        z = np.asarray(x) @ self.coef_.T + self.intercept_
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)


def _xgb_forest(rng) -> tuple[dict, list]:
    """A seeded xgboost JSON model (the layout ``Booster.save_model`` writes,
    as tests/test_models_tabular.py builds it): XGB_TREES full binary trees
    of depth XGB_DEPTH on XGB_FEATURES features, ``binary:logistic``."""
    n_int = 2**XGB_DEPTH - 1
    n = 2 * n_int + 1
    trees = []
    for _ in range(XGB_TREES):
        left = [2 * i + 1 if i < n_int else -1 for i in range(n)]
        right = [2 * i + 2 if i < n_int else -1 for i in range(n)]
        split_idx = [int(rng.integers(XGB_FEATURES)) if i < n_int else 0 for i in range(n)]
        cond = [float(rng.normal()) if i < n_int else float(0.1 * rng.normal())
                for i in range(n)]
        trees.append({
            "base_weights": [0.0] * n, "categories": [], "categories_nodes": [],
            "categories_segments": [], "categories_sizes": [], "default_left": [1] * n,
            "id": len(trees), "left_children": left, "loss_changes": [0.0] * n,
            "parents": [2147483647] * n, "right_children": right,
            "split_conditions": cond, "split_indices": split_idx, "split_type": [0] * n,
            "sum_hessian": [1.0] * n,
            "tree_param": {"num_deleted": "0", "num_feature": str(XGB_FEATURES),
                           "num_nodes": str(n), "size_leaf_vector": "1"},
        })
    model = {"learner": {
        "attributes": {}, "feature_names": [], "feature_types": [],
        "gradient_booster": {"model": {
            "gbtree_model_param": {"num_parallel_tree": "1", "num_trees": str(XGB_TREES)},
            "iteration_indptr": list(range(XGB_TREES + 1)), "tree_info": [0] * XGB_TREES,
            "trees": trees}, "name": "gbtree"},
        "learner_model_param": {"base_score": "0.5", "boost_from_average": "1",
                                "num_class": "0", "num_feature": str(XGB_FEATURES),
                                "num_target": "1"},
        "objective": {"name": "binary:logistic",
                      "reg_loss_param": {"scale_pos_weight": "1"}}},
        "version": [2, 0, 0]}
    return model, trees


def _xgb_host_margins(trees, X, base_margin: float):
    """An independent numpy traversal with xgboost's strict ``<`` (a NaN
    goes right, as the reference routes it), in f64."""
    import numpy as np

    out = np.full(X.shape[0], base_margin, np.float64)
    rows = np.arange(X.shape[0])
    for t in trees:
        left, right = np.asarray(t["left_children"]), np.asarray(t["right_children"])
        feat, cond = np.asarray(t["split_indices"]), np.asarray(t["split_conditions"], np.float32)
        node = np.zeros(X.shape[0], np.int64)
        while (left[node] != -1).any():
            inner = left[node] != -1
            go_left = X[rows, feat[node]] < cond[node]
            nxt = np.where(go_left, left[node], right[node])
            node = np.where(inner, nxt, node)
        out += cond[node]
    return out


def _serve_in_process(app, pred, name: str, max_batch_size: int, device: str):
    config = app.ServerConfig(model_name=name, host="127.0.0.1", port=0, device=device,
                              max_batch_size=max_batch_size, max_batch_delay_ms=2)
    t0 = time.perf_counter()
    srv = app.build_server(pred, config)
    warmup_s = time.perf_counter() - t0
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{srv.server_address[1]}", warmup_s


def _stop_server(srv, th) -> None:
    srv.shutdown_all()
    th.join(timeout=30)
    if th.is_alive():
        raise AssertionError("a phase 7 server thread did not stop")


def _v2_tensor(x, name: str = "x") -> dict:
    return {"inputs": [{"name": name, "datatype": "FP32", "shape": list(x.shape),
                        "data": x.reshape(-1).tolist()}]}


def _v2_out(resp: dict):
    import numpy as np

    out = resp["outputs"][0]
    return np.asarray(out["data"]).reshape(out["shape"])


def _resnet50_params(resnet, device: str):
    """ResNet-50 drawn from seed 0 with random folded BN statistics (so BN
    is no identity); phases 7 and 8c serve it."""
    import torch

    cfg = resnet.ResNetConfig.resnet50()
    gen = torch.Generator(device=device).manual_seed(0)
    params = resnet.init(gen, cfg, device=device)

    def random_bn(node):
        if isinstance(node, list):
            return [random_bn(v) for v in node]
        if set(node) == {"scale", "bias"}:
            c = node["scale"].shape[0]

            def draw(lo, hi):
                return lo + (hi - lo) * torch.rand(c, generator=gen, device=device)

            return resnet.fold_batchnorm(draw(0.5, 1.5), 0.1 * draw(-1, 1),
                                         0.1 * draw(-1, 1), draw(0.5, 2.0))
        return {k: (random_bn(v) if isinstance(v, (dict, list)) else v)
                for k, v in node.items()}

    return random_bn(params), cfg


def _phase7_resnet(resnet, loader, app, scratch: Path, device: str) -> dict:
    import numpy as np
    import torch

    params, cfg = _resnet50_params(resnet, device)
    n_params = sum(t.numel() for t in _leaves(params))
    art = loader.save_native_model(scratch / "bucket" / "models" / "resnet50",
                                   "resnet-classifier", params,
                                   config=dataclasses.asdict(cfg),
                                   builder_kwargs={"image_size": RESNET_IMAGE})
    # The object-store URI through the mirror: s3://<bucket>/<path>.
    os.environ[loader.MIRROR_ENV] = str(scratch)
    uri = "s3://bucket/models/resnet50"
    if loader.resolve_uri(uri) != art:
        raise AssertionError(f"the mirror resolved {uri} to {loader.resolve_uri(uri)}")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    held0 = torch.cuda.memory_allocated() if device == "cuda" else 0
    t0 = time.perf_counter()
    stats: dict = {}
    pred = loader.load_predictor(uri, device=device, load_stats=stats)  # default dtype bf16
    load_s = time.perf_counter() - t0
    resident = (torch.cuda.memory_allocated() - held0) if device == "cuda" else None
    # The loader's bf16 cast must not reach ResNet: the served tree (its
    # OIHW serving copy of the convs, the BN and fc leaves) is f32.
    if resident is not None and resident < 0.95 * 4 * n_params:
        raise AssertionError(f"ResNet-50 holds {resident / 2**20:.1f} MiB on the card for "
                             f"{n_params} parameters: not f32")
    if pred.name != "resnet-classifier" or pred.metadata["num_classes"] != cfg.num_classes:
        raise AssertionError(f"loaded {pred.name} {pred.metadata}")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    srv, th, base, warmup_s = _serve_in_process(app, pred, "resnet50", 32, device)
    try:
        rng = np.random.default_rng(7)
        imgs = rng.normal(size=(2, RESNET_IMAGE, RESNET_IMAGE, 3)).astype(np.float32)
        t0 = time.perf_counter()
        code, resp, _ = _call("POST", base + "/v2/models/resnet50/infer", _v2_tensor(imgs))
        v2_wall_ms = (time.perf_counter() - t0) * 1e3
        if code != 200:
            raise AssertionError(f"ResNet V2 infer answered {code}: {resp}")
        served = _v2_out(resp).astype(np.float64)
        t0 = time.perf_counter()
        code, sresp, _ = _call("POST", base + "/api/v1.0/predictions", {"data": {"tensor": {
            "shape": [1, RESNET_IMAGE, RESNET_IMAGE, 3], "values": imgs[:1].reshape(-1).tolist()}}})
        seldon_wall_ms = (time.perf_counter() - t0) * 1e3
        if code != 200:
            raise AssertionError(f"ResNet Seldon predictions answered {code}: {sresp}")
        seldon = np.asarray(sresp["data"]["ndarray"], np.float64)
        p64 = _cast_tree(params, torch.float64)
        with torch.no_grad():
            ref = resnet.forward(p64, torch.from_numpy(imgs.astype(np.float64)).to(device),
                                 cfg).double().cpu().numpy()
        del p64
        if served.shape != ref.shape or seldon.shape != (1, cfg.num_classes):
            raise AssertionError(f"logit shapes {served.shape} / {seldon.shape}")
        scale = float(np.abs(ref).max())
        err = float(np.abs(served - ref).max())
        seldon_err = float(np.abs(seldon - ref[:1]).max())
        if not np.isfinite(served).all() or err > RESNET_TOL * scale \
                or seldon_err > RESNET_TOL * scale:
            raise AssertionError(f"ResNet-50 logits vs f64: max_abs_err {err:.3e} / Seldon "
                                 f"{seldon_err:.3e} over a scale of {scale:.3e} "
                                 f"(tol {RESNET_TOL} x scale)")
        top2 = np.sort(ref, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > RESNET_GAP * err
        agree = served.argmax(1) == ref.argmax(1)
        if not agree[clear].all():
            raise AssertionError(f"ResNet-50 top-1 differs from f64 on a clear row: "
                                 f"{served.argmax(1)} vs {ref.argmax(1)}")
        eng = srv.engine
        lat = {}
        for b in RESNET_BATCHES:
            ex = {"x": rng.normal(size=(b, RESNET_IMAGE, RESNET_IMAGE, 3)).astype(np.float32)}
            for _ in range(3):
                eng.predict(ex)
            walls = []
            for _ in range(30):
                t0 = time.perf_counter()
                eng.predict(ex)
                if device == "cuda":
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            prof, prof_wall_ms = profile_device(lambda: eng.predict(ex), iters=10)
            busy_ms = sum(prof.values())
            p50 = _percentile_ms(walls, 50)
            lat[b] = {"p50_ms": p50, "p99_ms": _percentile_ms(walls, 99),
                      "images_per_s": b / (p50 / 1e3), "busy_ms_10": busy_ms,
                      "wall_ms_10": prof_wall_ms,
                      "idle_share": 1 - busy_ms / prof_wall_ms if prof_wall_ms else None,
                      "top": sorted(prof.items(), key=lambda kv: -kv[1])[:5]}
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    finally:
        _stop_server(srv, th)
        os.environ.pop(loader.MIRROR_ENV, None)
    res = {"n_params": n_params, "uri": uri, "load_s": load_s, "load_stats": stats,
           "resident_mib": None if resident is None else resident / 2**20,
           "warmup_s": warmup_s, "max_abs_err": err, "seldon_max_abs_err": seldon_err,
           "logit_scale": scale, "top1_agree": agree.tolist(), "top1_clear": clear.tolist(),
           "v2_b2_wall_ms": v2_wall_ms, "seldon_b1_wall_ms": seldon_wall_ms,
           "batches": lat, "max_memory_gib": peak}
    log(f"ResNet-50 ({n_params} parameters, {RESNET_IMAGE}x{RESNET_IMAGE}) via {uri}: load "
        f"{load_s:.2f} s ({res['resident_mib'] or 0:.1f} MiB on the card, f32), warmup "
        f"{warmup_s:.2f} s; logits vs f64 max_abs_err {err:.3e} (Seldon {seldon_err:.3e}) over "
        f"a scale {scale:.3e} (tol {RESNET_TOL} x scale), top-1 {agree.tolist()}")
    log(f"  HTTP walls: V2 infer B2 {v2_wall_ms:.1f} ms, Seldon data.tensor B1 "
        f"{seldon_wall_ms:.1f} ms; peak {peak or 0:.2f} GiB")
    for b, r in lat.items():
        log(f"  engine B{b}: p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
            f"{r['images_per_s']:.1f} images/s, device busy {r['busy_ms_10']:.1f} of "
            f"{r['wall_ms_10']:.1f} ms over 10 batches (idle share "
            f"{(r['idle_share'] or 0):.3f})")
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def _phase7_xgboost(tabular, loader, app, scratch: Path, device: str) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    model, trees_json = _xgb_forest(rng)
    art = loader.save_xgboost_model(scratch / "xgb", model)
    t0 = time.perf_counter()
    pred = loader.load_predictor(str(art), device=device)
    load_s = time.perf_counter() - t0
    if pred.metadata["eval_form"] != "gemm" or pred.metadata["n_trees"] != XGB_TREES:
        raise AssertionError(f"xgboost loaded as {pred.metadata}")
    X = rng.normal(size=(XGB_B, XGB_FEATURES)).astype(np.float32)
    for r in range(8):  # rows exactly on a split: strict < sends them right
        t = trees_json[r]
        X[r, t["split_indices"][0]] = np.float32(t["split_conditions"][0])
    X[8, :4] = np.nan  # NaN goes right at every node
    base = float(np.log(0.5 / 0.5))
    host = _xgb_host_margins(trees_json, X, base)
    trees, _ = tabular.from_xgboost_json(model)
    gemm_fn, form = tabular.lower_forest(trees, device)
    gather_trees = tabular._to_device(trees, device)
    xd = torch.from_numpy(X).to(device)
    gemm = gemm_fn(xd).double().cpu().numpy()
    gather = tabular.eval_forest(gather_trees, xd).double().cpu().numpy()
    err_forms = float(np.abs(gemm - gather).max())
    err_host = float(max(np.abs(gemm - host).max(), np.abs(gather - host).max()))
    if form != "gemm" or not np.isfinite(gemm).all() \
            or (np.abs(gemm - gather) > XGB_TOL + XGB_TOL * np.abs(gather)).any() \
            or (np.abs(gemm - host) > XGB_HOST_TOL + XGB_HOST_TOL * np.abs(host)).any() \
            or (np.abs(gather - host) > XGB_HOST_TOL + XGB_HOST_TOL * np.abs(host)).any():
        raise AssertionError(f"xgboost margins: gemm vs gather {err_forms:.3e} (tol {XGB_TOL}), "
                             f"vs host {err_host:.3e} (tol {XGB_HOST_TOL}), abs + rel")
    served = pred.predict(X).double().cpu().numpy()
    prob_err = float(np.abs(served - 1 / (1 + np.exp(-host))).max())
    if prob_err > XGB_HOST_TOL:
        raise AssertionError(f"xgboost probabilities vs host: {prob_err:.3e}")
    if device == "cuda":
        gemm_ms = cuda_time_ms(lambda: gemm_fn(xd))
        gather_ms = cuda_time_ms(lambda: tabular.eval_forest(gather_trees, xd))
    else:
        gemm_ms = gather_ms = None
    srv, th, base_url, warmup_s = _serve_in_process(app, pred, "xgb", XGB_B, device)
    try:
        body = _v2_tensor(X[9:])  # no NaN on the JSON wire
        walls = []
        for _ in range(30):
            t0 = time.perf_counter()
            code, resp, _ = _call("POST", base_url + "/v2/models/xgb/infer", body)
            walls.append(time.perf_counter() - t0)
            if code != 200:
                raise AssertionError(f"xgboost V2 infer answered {code}: {resp}")
        got = _v2_out(resp)
        if np.abs(got - served[9:]).max() > XGB_TOL:
            raise AssertionError("served xgboost probabilities differ from the predictor's")
    finally:
        _stop_server(srv, th)
    res = {"trees": XGB_TREES, "depth": XGB_DEPTH, "features": XGB_FEATURES, "batch": XGB_B,
           "load_s": load_s, "eval_form": form, "max_abs_err_forms": err_forms,
           "max_abs_err_host": err_host, "prob_max_abs_err": prob_err,
           "gemm_device_ms": gemm_ms, "gather_device_ms": gather_ms,
           "served_rows": XGB_B - 9, "served_p50_ms": _percentile_ms(walls, 50),
           "served_p99_ms": _percentile_ms(walls, 99), "warmup_s": warmup_s}
    log(f"xgboost {XGB_TREES} trees depth {XGB_DEPTH} on {XGB_FEATURES} features, "
        f"binary:logistic, eval_form {form}: margins gemm vs gather {err_forms:.3e} (tol "
        f"{XGB_TOL}), vs host {err_host:.3e} (tol {XGB_HOST_TOL}); B{XGB_B} device ms gemm "
        f"{gemm_ms if gemm_ms is None else round(gemm_ms, 4)}, gather "
        f"{gather_ms if gather_ms is None else round(gather_ms, 4)}; served V2 B{XGB_B - 9} "
        f"p50 {res['served_p50_ms']:.2f} ms, p99 {res['served_p99_ms']:.2f} ms")
    return res


def _phase7_iris(loader, app, scratch: Path, device: str) -> dict:
    import numpy as np

    rng = np.random.default_rng(5)
    model = _IrisLogistic(rng)
    art = loader.save_sklearn_model(scratch / "iris", model, "sklearn-linear")
    pred = loader.load_predictor(str(art), device=device)
    if pred.name != "sklearn-linear" or pred.metadata != {"n_features": 4, "n_classes": 3}:
        raise AssertionError(f"iris loaded as {pred.name} {pred.metadata}")
    lo, hi = np.array([4.3, 2.0, 1.0, 0.1]), np.array([7.9, 4.4, 6.9, 2.5])
    X = (lo + (hi - lo) * rng.random((150, 4))).astype(np.float32)
    want = (X.astype(np.float64) @ model.coef_.T + model.intercept_).argmax(1)
    srv, th, base, warmup_s = _serve_in_process(app, pred, "iris", 8, device)
    try:
        code, resp, _ = _call("POST", base + "/v2/models/iris/infer", _v2_tensor(X))
        if code != 200 or resp["outputs"][0]["datatype"] != "INT32":
            raise AssertionError(f"iris V2 infer answered {code}: {resp}")
        v2 = _v2_out(resp)
        with ThreadPoolExecutor(8) as pool:
            singles = list(pool.map(lambda i: _call("POST", base + "/v2/models/iris/infer",
                                                    _v2_tensor(X[i:i + 1])), range(16)))
        code, sresp, _ = _call("POST", base + "/api/v1.0/predictions",
                               {"data": {"ndarray": X[:5].tolist()}})
        if code != 200 or any(c != 200 for c, _, _ in singles):
            raise AssertionError(f"iris Seldon answered {code}: {sresp}")
        got_single = np.asarray([_v2_out(r)[0] for _, r, _ in singles])
        if not (np.array_equal(v2, want) and np.array_equal(got_single, want[:16])
                and np.array_equal(sresp["data"]["ndarray"], want[:5])):
            raise AssertionError("iris class ids differ from numpy's argmax")
        before = _scrape(base)
        for reward in (1, -0.5, 2):
            code, fresp, _ = _call("POST", base + "/api/v1.0/feedback",
                                   {"reward": reward, "response": {"data": {"ndarray": [[0]]}}})
            if (code, fresp) != (200, {"meta": {}}):
                raise AssertionError(f"feedback answered {code}: {fresp}")
        after = _scrape(base)
        fam = "seldon_api_executor_server_requests_seconds_count"
        lat = "seldon_api_executor_client_requests_seconds_count"
        reward_total = _value(after, "tpumlops_feedback_reward_total")
        fb = _value(after, fam, service="feedback") - _value(before, fam, service="feedback")
        dpred = (_value(after, fam, service="predictions")
                 - _value(before, fam, service="predictions"))
        dlat = _value(after, lat) - _value(before, lat)
        if reward_total != 2.5 or fb != 3 or dpred != 0 or dlat != 0:
            raise AssertionError(f"feedback metrics: reward {reward_total}, feedback "
                                 f"count +{fb}, predictions +{dpred}, latency +{dlat}")
        n_pred = _value(after, fam, service="predictions", code="200")
    finally:
        _stop_server(srv, th)
    res = {"rows": len(X), "singles": len(singles), "agree": 1.0, "warmup_s": warmup_s,
           "feedback_reward_total": reward_total, "feedback_count": fb,
           "predictions_200": n_pred}
    log(f"iris (3 classes, 4 features) from model.pkl: V2 infer B150 and 16 singles, Seldon "
        f"ndarray B5, class ids equal to numpy's; feedback 1, -0.5, 2 -> "
        f"tpumlops_feedback_reward_total {reward_total}, service=\"feedback\" +{fb:.0f}, "
        f"predictions +{dpred:.0f}")
    return res


def phase_serve_v2_flavors(device: str = "cuda") -> dict:
    """ResNet-50 (a native artifact through an ``s3://`` URI and the
    artifact mirror), an xgboost JSON forest and an iris logistic
    regression from a ``model.pkl``, each loaded by the port's loader and
    served in process (V2 infer, the Seldon route, feedback)."""
    import torch
    from importlib import import_module

    t_phase = time.perf_counter()
    resnet = import_module(f"{PKG}.models.resnet")
    tabular = import_module(f"{PKG}.models.tabular")
    loader = import_module(f"{PKG}.server.loader")
    app = import_module(f"{PKG}.server.app")
    scratch = ROOT / "build"  # ignored by git
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        out = {"resnet50": _phase7_resnet(resnet, loader, app, Path(tmp), device)}
        if device == "cuda":
            torch.cuda.empty_cache()
        out["xgboost"] = _phase7_xgboost(tabular, loader, app, Path(tmp), device)
        out["iris"] = _phase7_iris(loader, app, Path(tmp), device)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 7 wall {out['wall_s']:.1f} s")
    DETAIL["serve_v2_flavors"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 8: a served replica of four ranks ({"dp": 2, "tp": 2}) on one card
# ---------------------------------------------------------------------------

MESH_SHAPE = {"dp": 2, "tp": 2}
MESH_LAYERS = 2   # Llama-2-7B's widths cut to this depth (the smoke's time limit)
MESH_NEW = 32     # greedy tokens a request
MESH_CHUNK = 64   # prefill chunk, the prefix cache's reuse unit
MESH_BUDGET_S = 100.0  # phase 8's share of SMOKE_LIMIT_S
# A rank's peak allocation and its allocator's reserve over its HBM ledger
# (the ledger counts the rank's blocks, cache rows and sampling state; the
# slack is the activations, logits and allocator rounding beside them).
MESH_PEAK_SLACK = 0.25
MESH_RESERVED_SLACK = 0.35


# The CR of every unit of phases 8-8c: an h100-4 node, the kernel cache the
# smoke built (phase 1b).  Each unit's pod comes from the operator's own
# manifest for it (``_unit_pod``); the smoke runs its launcher.
UNIT_TOPOLOGY = "h100-4"
UNIT_CARDS = 4


def _unit_cr(uri: Path, cuda: dict, warm_pool: bool = False) -> dict:
    spec = {"modelName": "model", "modelAlias": "smoke", "backend": "cuda",
            "cuda": {"gpuTopology": UNIT_TOPOLOGY,
                     "compileCacheDir": str(ROOT / "build" / "torch_kernels"), **cuda}}
    if warm_pool:
        spec["autoscaling"] = {"warmPoolSize": 1}
    return spec


def _mesh_cuda(dtype: str, mesh: dict = MESH_SHAPE, **more) -> dict:
    """Phase 8's server options as ``spec.cuda``."""
    return {"meshShape": mesh, "dtype": dtype, "maxSlots": 4, "prefillChunk": MESH_CHUNK,
            "prefixCache": {"enabled": True}, "speculative": {"enabled": True, "draftTokens": 4},
            "observability": {"deviceTelemetry": True}, **more}


def _unit_local(device: str, max_slots: int | None = 4) -> list[str]:
    """The flags a CR cannot state: a local listener, no drain lag, the
    device, and ``--max-slots`` (``spec.cuda.maxSlots`` is no server flag
    of the manifest)."""
    return (["--host", "127.0.0.1", "--port", "0", "--metrics-port", "0", "--drain-s", "0",
             "--device", device] + (["--max-slots", str(max_slots)] if max_slots else []))


def _unit_pod(uri: Path, cuda: dict, warm_pool: bool = False) -> dict:
    """The container of the ``h100-4`` pod the operator builds for this
    unit (``build_deployment``; the warm-pool manifest for a pool), checked
    to run the launcher on the node's cards with a memory ``/dev/shm``."""
    from importlib import import_module

    builder = import_module(f"{PKG}.operator.builder")
    config = import_module(f"{PKG}.utils.config")
    cfg = config.OperatorConfig.from_spec(_unit_cr(uri, cuda, warm_pool))
    if warm_pool:
        (dep,) = builder.build_warm_pool_manifests("model", "smoke", "smoke", cfg, "1", str(uri))
        pod = dep["spec"]["template"]["spec"]
    else:
        manifest = builder.build_deployment(
            name="model", namespace="smoke", owner_uid="smoke", config=cfg,
            current_version="1", new_model_uri=str(uri), traffic_current=100)
        pod = manifest["spec"]["predictors"][0]["componentSpecs"][0]["spec"]
    (c,) = pod["containers"]
    if (c["command"] != ["python", "-m", builder.LAUNCH_MODULE]
            or c["resources"]["limits"] != {"nvidia.com/gpu": str(UNIT_CARDS)}
            or {"name": "dshm", "emptyDir": {"medium": "Memory"}} not in pod["volumes"]):
        raise AssertionError(f"mesh: the {UNIT_TOPOLOGY} pod runs {c['command']} with "
                             f"{c['resources']} and volumes {pod.get('volumes')}")
    return c


def _mesh_argv(art: Path, dtype: str, device: str) -> list[str]:
    """Phase 8's server arguments: the manifest's, then the local flags."""
    return _unit_pod(art, _mesh_cuda(dtype))["args"] + _unit_local(device)


def _mesh_prompts(vocab: int) -> dict:
    """The traffic: a warm-up request that puts a two-chunk prefix in the
    radix cache, then a burst of five: two cold prompts, two that share
    the cached prefix (each seeded from it), and one repeating pattern the
    n-gram drafter proposes from (verify ticks)."""
    import numpy as np

    rng = np.random.default_rng(8)
    ids = lambda n: [int(t) for t in rng.integers(3, vocab, n)]  # noqa: E731
    shared = ids(2 * MESH_CHUNK)
    pattern = ids(6)
    return {"warm": shared + ids(20),
            "burst": {"cold_a": ids(120), "cold_b": ids(90), "shared_a": shared + ids(25),
                      "shared_b": shared + ids(9), "spec": pattern * 12}}


def _mesh_traffic(url: str, prompts: dict, vocab: int) -> dict:
    """The warm-up alone, then the burst concurrently; each request's
    greedy tokens."""
    gen = url + "/v2/models/model/generate"
    out = {"warm": _check_outputs(_post(gen, {"prompt_ids": prompts["warm"],
                                              "max_new_tokens": MESH_NEW}),
                                  [MESH_NEW], vocab)[0]}
    names = list(prompts["burst"])
    with ThreadPoolExecutor(len(names)) as ex:
        futs = {n: ex.submit(_post, gen, {"prompt_ids": prompts["burst"][n],
                                          "max_new_tokens": MESH_NEW}) for n in names}
        for n in names:
            out[n] = _check_outputs(futs[n].result(timeout=600), [MESH_NEW], vocab)[0]
    return out


def _mesh_reference(app, loader, art: Path, dtype: str, prompts: dict, device: str,
                    sequential: bool = False, chunk_s: dict | None = None):
    """The same traffic through a tp-1, dp-1 engine in this process, on the
    same artifact and options; returns (tokens by request, predictor).
    ``sequential``: ``prompts`` is {name: prompt}, sent one at a time, and
    ``chunk_s`` receives each request's prefill chunk forwards' seconds
    (each synchronized)."""
    import torch
    from importlib import import_module

    metrics_mod = import_module(f"{PKG}.server.metrics")
    pred = loader.load_predictor(str(art), device=device, dtype=app._DTYPES[dtype])
    conf = app.config_from_args(app.build_arg_parser().parse_args(
        _mesh_argv(art, dtype, device) + ["--mesh-shape", json.dumps({"dp": 1, "tp": 1})]))
    engine = app.make_gen_engine(pred, conf, metrics_mod.ServerMetrics("smoke", "v1", "smoke"))
    spent = [0.0]
    if chunk_s is not None:
        real = engine._device_chunk

        def timed(*args, **kw):
            t0 = time.perf_counter()
            real(*args, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0

        engine._device_chunk = timed
    engine.start()
    try:
        if sequential:
            out = {}
            for n, p in prompts.items():
                spent[0] = 0.0
                out[n] = engine.generate(p, MESH_NEW, timeout=600).tolist()
                if chunk_s is not None:
                    chunk_s[n] = spent[0]
        else:
            out = {"warm": engine.generate(prompts["warm"], MESH_NEW, timeout=600).tolist()}
            futs = {n: engine.submit(p, MESH_NEW) for n, p in prompts["burst"].items()}
            out.update({n: f.result(timeout=600).tolist() for n, f in futs.items()})
    finally:
        engine.shutdown()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, pred


def _top2_margin(llama, pred, prompt: list, toks: list, pos: int, device: str) -> float:
    """The tp-1 model's margin between its top two logits where token
    ``pos`` is drawn (teacher-forced on its own tokens, in f32)."""
    import torch

    lm = pred.causal_lm
    ids = torch.tensor([list(prompt) + list(toks[:pos])], device=device)
    logits, _ = llama.prefill(lm["params"], ids, lm["cfg"], torch.float32)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def _launch_unit(uri: Path, cuda: dict, device: str, tag: str, report_dir: Path,
                 warm_pool: bool = False, max_slots: int | None = 4) -> dict:
    """A unit started as its pod starts: the launcher of the ``h100-4``
    manifest (``_unit_pod``) with the manifest's arguments and environment,
    then the local flags, and ``--ranks-share-card`` (the unit's four ranks
    share the one card of this machine; the operator never emits it).  The
    launcher's output, each rank's lines prefixed ``[rank r]``, goes to
    ``chiprun_out/mesh_<tag>_launcher.log``; not waited for."""
    c = _unit_pod(uri, cuda, warm_pool)
    world = math.prod(cuda["meshShape"].values())
    shutil.rmtree(report_dir, ignore_errors=True)
    env = dict(os.environ, **{e["name"]: e["value"] for e in c["env"]}, PYTHONPATH=str(ROOT),
               PYTHONWARNINGS="ignore", OMP_NUM_THREADS="1",
               TPUMLOPS_RANK_REPORT_DIR=str(report_dir))
    argv = ([sys.executable] + c["command"][1:] + c["args"] + _unit_local(device, max_slots)
            + ["--ranks-share-card"])
    launcher_log = OUT_DIR / f"mesh_{tag}_launcher.log"
    log(f"mesh {tag}: the launcher of the {UNIT_TOPOLOGY} manifest "
        f"({' '.join(c['command'])}), {world} ranks, --ranks-share-card added (one card here)")
    with open(launcher_log, "w") as logf:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    return {"tag": tag, "launcher": proc, "launcher_log": launcher_log, "world": world,
            "report_dir": report_dir, "t0": time.perf_counter()}


def _await_unit(unit: dict, what: str = "llama-generate") -> str:
    """The leader's URL once it serves ``what`` (a flavor, or ``warm pool``;
    every rank up: the leader serves after the process group formed and its
    engine started).  ``start_s``: the launcher's seconds from its start to
    the leader serving."""
    serving = re.compile(r"\[rank 0\] .*serving model \(" + re.escape(what)
                         + r"\) on 127\.0\.0\.1:(\d+)")
    deadline = time.time() + 300
    while True:
        m = serving.search(unit["launcher_log"].read_text(errors="replace"))
        if m:
            unit["start_s"] = time.perf_counter() - unit["t0"]
            log(f"mesh {unit['tag']}: the leader served {unit['start_s']:.1f} s after the "
                "launcher started")
            return f"http://127.0.0.1:{m.group(1)}"
        code = unit["launcher"].poll()
        if code is not None or time.time() > deadline:
            _kill_unit(unit)
            raise AssertionError(f"mesh {unit['tag']}: the launcher exited ({code}) before the "
                                 f"leader served (or 300 s passed); see {unit['launcher_log']}")
        time.sleep(0.2)


def _kill_unit(unit: dict) -> None:
    """SIGKILL to the launcher: its ranks die with it (``PR_SET_PDEATHSIG``)."""
    p = unit["launcher"]
    if p.poll() is None:
        p.kill()
        p.wait()


def _stop_units(units) -> None:
    """SIGTERM to each launcher: it goes to the leader, which drains, stops
    its engine and releases its followers; every rank must exit 0, and the
    launcher then exits 0."""
    for unit in units:
        unit["launcher"].send_signal(signal.SIGTERM)
    for unit in units:
        try:
            code = unit["launcher"].wait(timeout=120)
        except subprocess.TimeoutExpired:
            _kill_unit(unit)
            raise AssertionError(f"mesh {unit['tag']}: the launcher did not exit within 120 s "
                                 f"of SIGTERM; see {unit['launcher_log']}") from None
        text = unit["launcher_log"].read_text()
        every = f"every rank exited 0 ({list(range(unit['world']))})"
        if code != 0 or every not in text:
            raise AssertionError(f"mesh {unit['tag']}: the launcher exited {code}: "
                                 f"{text[-2000:]}")
        unit["launcher_code"] = code


def _nccl_one_rank() -> subprocess.Popen:
    """A one-rank nccl group and an all_reduce, in a process of its own
    (the NCCL library loads and runs on the card); read with
    :func:`_nccl_result`."""
    code = (
        "import json, torch, torch.distributed as dist\n"
        f"dist.init_process_group('nccl', init_method='tcp://127.0.0.1:{_free_port()}', "
        "world_size=1, rank=0)\n"
        "x = torch.ones(1 << 20, device='cuda')\n"
        "dist.all_reduce(x); torch.cuda.synchronize()\n"
        "print(json.dumps({'ok': bool((x == 1).all()), 'nccl': '.'.join(map(str, "
        "torch.cuda.nccl.version())), 'backend': dist.get_backend()}))\n"
        "dist.destroy_process_group()\n")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONWARNINGS="ignore"))


def _nccl_result(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("one-rank nccl all_reduce did not finish within 120 s") from None
    line = (out.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or not line.startswith("{"):
        raise AssertionError(f"one-rank nccl all_reduce failed ({proc.returncode}): "
                             f"{err[-2000:]}")
    res = json.loads(line)
    if not res["ok"]:
        raise AssertionError(f"one-rank nccl all_reduce gave a wrong sum: {res}")
    return res


def _mesh_run(unit: dict, url: str, prompts: dict, vocab: int) -> dict:
    """One served unit's traffic and the leader's analytic collective
    seconds (the unit is stopped after, with the other)."""
    try:
        t1 = time.perf_counter()
        toks = _mesh_traffic(url, prompts, vocab)
        traffic_s = time.perf_counter() - t1
        samples = _scrape(url)
        coll = {op: _value(samples, "tpumlops_engine_collective_seconds_total", op=op)
                for op in ("all_reduce", "all_gather")}
    except BaseException:
        _kill_unit(unit)
        raise
    return {"tokens": toks, "start_s": unit["start_s"], "traffic_s": traffic_s,
            "collective_s_analytic": coll}


def _mesh_reports(unit: dict, run: dict) -> None:
    """After the stop: the backend from the leader's log, each rank's report."""
    backend = re.search(r"\[rank 0\] .*model collectives over (\w+)",
                        unit["launcher_log"].read_text(errors="replace"))
    run["backend"] = backend.group(1) if backend else None
    run["reports"] = [json.loads((unit["report_dir"] / f"rank-{r}.json").read_text())
                      for r in range(unit["world"])]
    run["launcher_code"] = unit.get("launcher_code")


def _rank_lines(tag: str, run: dict, smi: str) -> None:
    """Per rank: its decode and verify tick walls, its measured collective
    host seconds, its HBM ledger against the allocator (allocated, peak
    allocated and reserved), its launches."""
    for rep in run["reports"]:
        ops = rep["ops"]
        walls = {k: (f"{1e3 * ops[k]['seconds'] / ops[k]['count']:.2f} ms mean, "
                     f"{1e3 * ops[k]['max_s']:.2f} max x{ops[k]['count']}")
                 for k in ("gen_step", "gen_verify", "gen_chunk", "gen_chunks", "gen_multistep",
                           "gen_superstep") if k in ops}
        coll = {k: f"{v['seconds']:.3f} s/{v['calls']}" for k, v in rep["collectives"].items()}
        led = rep.get("ledger", {})
        alloc = rep.get("memory_allocated")
        pct = (f" ({100.0 * (led['total'] - alloc) / alloc:+.1f}% vs allocated "
               f"{alloc / 2**30:.3f} GiB; peak {rep['max_memory_allocated'] / 2**30:.3f} GiB, "
               f"reserved {rep['memory_reserved'] / 2**30:.3f} GiB)" if alloc else "")
        log(f"mesh {tag} rank {rep['rank']} {rep['mesh']['coords']}: ticks {walls}; "
            f"collectives {coll}; ledger {led.get('total', 0) / 2**30:.3f} GiB{pct}; "
            f"launches {rep['launches']} [{smi}]")


def _check_rank_memory(tag: str, run: dict) -> None:
    """Each rank's peak allocation and reserve against its HBM ledger: a
    rank that loaded the whole model before cutting its block (or kept
    full-size blocks reserved) exceeds it by the model's size."""
    for rep in run["reports"]:
        total = rep["ledger"]["total"]
        for key, slack in (("max_memory_allocated", MESH_PEAK_SLACK),
                           ("memory_reserved", MESH_RESERVED_SLACK)):
            if rep[key] > total * (1.0 + slack):
                raise AssertionError(
                    f"mesh {tag} rank {rep['rank']}: {key} {rep[key]} B exceeds its HBM "
                    f"ledger {total} B by more than {100 * slack:.0f}%")


def mesh_artifact(device: str = "cuda") -> Path:
    """Phase 8's artifact, which phase 8b shares: Llama-2-7B's widths at
    MESH_LAYERS layers, bf16 weights drawn from a seed, in the native
    layout under ``build/`` (ignored by git; the caller deletes it)."""
    import torch
    from importlib import import_module

    llama = import_module(f"{PKG}.models.llama")
    loader = import_module(f"{PKG}.server.loader")
    cfg = llama.LlamaConfig.llama2_7b(num_layers=MESH_LAYERS)
    scratch = ROOT / "build" / "smoke_mesh"
    shutil.rmtree(scratch, ignore_errors=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(18)
    params = llama.init(gen, cfg, dtype=torch.bfloat16, device=device)
    art = loader.save_native_model(scratch / f"llama2-7b-{MESH_LAYERS}l", "llama-generate",
                                   params, config=dataclasses.asdict(cfg))
    del params
    log(f"mesh artifact: {time.perf_counter() - t0:.1f} s, "
        f"{(art / 'params.npz').stat().st_size / 2**30:.2f} GiB")
    return art


def phase_serve_mesh(smi: str, art: Path, device: str = "cuda") -> dict:
    """A served replica at ``--mesh-shape {"dp": 2, "tp": 2}``: four rank
    processes on the one card (gloo), Llama-2-7B's widths at MESH_LAYERS
    layers, from a bf16 native artifact drawn from a seed; its greedy
    tokens at f32 against a tp-1 engine in this process (equal), then at
    bf16 (agreement reported); the backend, the ranks' tick walls, HBM
    ledgers, collective seconds and launches; a one-rank nccl group.  For
    the time limit the f32 and bf16 units boot side by side while this
    process runs the tp-1 references, then serve their traffic in turns
    (the other unit idle in its control channel)."""
    import torch
    from importlib import import_module

    t_phase = time.perf_counter()
    llama = import_module(f"{PKG}.models.llama")
    loader = import_module(f"{PKG}.server.loader")
    app = import_module(f"{PKG}.server.app")
    distributed = import_module(f"{PKG}.parallel.distributed")
    cfg = llama.LlamaConfig.llama2_7b(num_layers=MESH_LAYERS)
    want_backend = distributed.choose_backend(math.prod(MESH_SHAPE.values()), device)
    out: dict = {"mesh": MESH_SHAPE, "layers": MESH_LAYERS, "backend_expected": want_backend,
                 "cut": f"depth {cfg.num_layers} of Llama-2-7B's 32 layers (time limit); "
                        "widths whole"}
    units: list = []
    nccl = None
    try:
        prompts = _mesh_prompts(cfg.vocab_size)
        dtypes = ("float32", "bfloat16")
        if device == "cuda":
            nccl = _nccl_one_rank()
        units = [_launch_unit(art, _mesh_cuda(dt), device, dt, OUT_DIR / f"mesh_{dt}_reports")
                 for dt in dtypes]
        refs, preds, ref_s = {}, {}, {}
        for dt in dtypes:  # while the units boot
            t1 = time.perf_counter()
            refs[dt], preds[dt] = _mesh_reference(app, loader, art, dt, prompts, device)
            ref_s[dt] = time.perf_counter() - t1
        urls = [_await_unit(u) for u in units]
        runs = {dt: _mesh_run(u, url, prompts, cfg.vocab_size)
                for dt, u, url in zip(dtypes, units, urls)}
        _stop_units(units)
        for dt, u in zip(dtypes, units):
            _mesh_reports(u, runs[dt])
        out["reference_tokens"] = refs
        for dt in dtypes:
            run, ref = runs[dt], refs[dt]
            run["reference_s"] = ref_s[dt]
            names = list(ref)
            same = {n: run["tokens"][n] == ref[n] for n in names}
            agree = sum(a == b for n in names for a, b in zip(run["tokens"][n], ref[n]))
            run["agreement"] = agree / sum(len(ref[n]) for n in names)
            if dt == "float32":
                for n in names:
                    if not same[n]:
                        pos = next(i for i, (a, b) in enumerate(zip(run["tokens"][n], ref[n]))
                                   if a != b)
                        prompt = prompts["warm"] if n == "warm" else prompts["burst"][n]
                        margin = _top2_margin(llama, preds[dt], prompt, ref[n], pos, device)
                        log(f"mesh f32: {n} differs at token {pos} (tp-1 top-2 margin "
                            f"{margin:.3g})")
                if not all(same.values()):
                    raise AssertionError(f"mesh f32 tokens differ from the tp-1 engine's: {same}")
            if run["backend"] != want_backend:
                raise AssertionError(f"mesh {dt}: ranks used {run['backend']}, "
                                     f"expected {want_backend}")
            launches = [rep["launches"] for rep in run["reports"]]
            if any(la != launches[0] for la in launches):
                raise AssertionError(f"mesh {dt}: the ranks' launches differ: {launches}")
            if device == "cuda":
                for k in ("decode_attention", "verify_attention", "rmsnorm", "flash_attention"):
                    if launches[0][k] <= 0:
                        raise AssertionError(f"mesh {dt}: no {k} launch on the ranks")
                _check_rank_memory(dt, run)
            ops = run["reports"][0]["ops"]
            for k in ("gen_seed", "gen_verify", "gen_step"):
                if k not in ops:
                    raise AssertionError(f"mesh {dt}: no {k} op ran: {sorted(ops)}")
            log(f"mesh {dt}: backend {run['backend']}, {len(names)} requests x {MESH_NEW} "
                f"tokens, agreement with the tp-1 engine {run['agreement']:.3f}; launcher "
                f"start to the leader serving {run['start_s']:.1f} s (both units side by side), "
                f"launcher exit {run['launcher_code']}; traffic "
                f"{run['traffic_s']:.1f} s, tp-1 reference {ref_s[dt]:.1f} s; analytic NVLink "
                f"collective s {run['collective_s_analytic']}")
            _rank_lines(dt, run, smi)
        del preds
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        out["runs"] = runs
        if nccl is not None:
            out["nccl_one_rank"] = _nccl_result(nccl)
            nccl = None
            log(f"mesh: one-rank nccl all_reduce ok (NCCL {out['nccl_one_rank']['nccl']}); "
                "a world of two or more nccl ranks waits for a machine with two cards")
    finally:
        for u in units:
            _kill_unit(u)
        if nccl is not None:
            nccl.kill()
            nccl.communicate()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 8 wall {out['wall_s']:.1f} s (budget {MESH_BUDGET_S:.0f} s); {out['cut']}; "
        f"{smi}")
    DETAIL["serve_mesh"] = out
    return out

# ---------------------------------------------------------------------------
# Phase 8b: a served {"sp": 2, "tp": 2} replica (the ring prefill) and its
# sharded snapshot, on phase 8's artifact
# ---------------------------------------------------------------------------

SP_MESH = {"sp": 2, "tp": 2}
SP_THRESHOLD = 512  # --sp-prefill-threshold: the cold prompt rides the ring
SP_LONG = 1500      # the cold prompt (a 2048-position bucket: 1024 a ring rank)
SP_SHORT = 60       # under the threshold: the chunked path
SP_SHARED = 1024    # the third prompt's prefix taken from the first (16 chunks of 64)
SP_RESTORE_K = 4    # the restored unit's decode steps: the long-context CR's K


def _sp_prompts(vocab: int) -> dict:
    """Sent one at a time: a cold long prompt (the ring pass, whose whole
    chunks go back into the radix cache), a short one, and one that shares
    the long one's first SP_SHARED tokens (seeded from those chunks)."""
    import numpy as np

    rng = np.random.default_rng(82)
    ids = lambda n: [int(t) for t in rng.integers(3, vocab, n)]  # noqa: E731
    long = ids(SP_LONG)
    return {"long": long, "short": ids(SP_SHORT), "shared": long[:SP_SHARED] + ids(40)}


def _sp_traffic(url: str, prompts: dict, vocab: int) -> dict:
    gen = url + "/v2/models/model/generate"
    out, walls = {}, {}
    for name, prompt in prompts.items():
        t0 = time.perf_counter()
        out[name] = _check_outputs(_post(gen, {"prompt_ids": prompt,
                                               "max_new_tokens": MESH_NEW}),
                                   [MESH_NEW], vocab)[0]
        walls[name] = time.perf_counter() - t0
    return {"tokens": out, "request_s": walls}


def _sp_served(unit: dict, prompts: dict, vocab: int) -> dict:
    """Wait for the unit, send the traffic, read /metrics, stop the unit
    and read its rank reports."""
    try:
        url = _await_unit(unit)
        run = _sp_traffic(url, prompts, vocab)
        samples = _scrape(url)
        run["sp_dispatches"] = _value(samples, "tpumlops_engine_dispatches_total",
                                      op="sp-prefill")
        run["dispatches"] = {op: _value(samples, "tpumlops_engine_dispatches_total", op=op)
                             for op in ("decode", "verify", "multistep", "superstep")}
        run["program"] = _call("GET", url + "/debug/device")[1].get("program")
        run["prefix_hits"] = _value(samples, "tpumlops_prefix_cache_hits_total")
        run["load_s"] = {stage: _value(samples, "tpumlops_model_load_seconds", stage=stage)
                         for stage in ("restore", "total")}
        run["start_s"] = unit["start_s"]
    except BaseException:
        _kill_unit(unit)
        raise
    _stop_units([unit])
    _mesh_reports(unit, run)
    return run


def _sp_checks(tag: str, run: dict, device: str) -> None:
    """sp-prefill ran once (the long prompt; the shared one is warm, the
    short one under the threshold), the shared prompt was seeded from the
    ring's write-back, every rank replayed the ring and launched flash
    with its log-sum-exp once a layer a block it ran (rank of sp index s:
    s + 1 blocks, the later ones lie above the diagonal)."""
    if run["sp_dispatches"] != 1:
        raise AssertionError(f"mesh sp {tag}: {run['sp_dispatches']} sp-prefill dispatches, "
                             "expected 1")
    if run["prefix_hits"] < 1:
        raise AssertionError(f"mesh sp {tag}: the shared prompt missed the radix cache")
    for rep in run["reports"]:
        ops = rep["ops"]
        for op in ("gen_sp_prefill", "gen_seed"):
            if ops.get(op, {}).get("count", 0) != 1:
                raise AssertionError(f"mesh sp {tag} rank {rep['rank']}: {op} ran "
                                     f"{ops.get(op, {}).get('count', 0)} times, expected 1")
        if device == "cuda":
            want = MESH_LAYERS * (rep["mesh"]["coords"]["sp"] + 1)
            got = rep["launches"]["flash_attention_lse"]
            if got != want:
                raise AssertionError(f"mesh sp {tag} rank {rep['rank']}: {got} flash launches "
                                     f"with the log-sum-exp, expected {want}")


def _sp_compare(tag: str, run: dict, ref: dict, prompts: dict, llama, pred, device: str,
                exact: bool) -> float:
    names = list(ref)
    agree = sum(a == b for n in names for a, b in zip(run["tokens"][n], ref[n]))
    share = agree / sum(len(ref[n]) for n in names)
    if exact and any(run["tokens"][n] != ref[n] for n in names):
        for n in names:
            if run["tokens"][n] != ref[n]:
                pos = next(i for i, (a, b) in enumerate(zip(run["tokens"][n], ref[n]))
                           if a != b)
                margin = _top2_margin(llama, pred, prompts[n], ref[n], pos, device)
                log(f"mesh sp {tag}: {n} differs at token {pos} (tp-1 top-2 margin "
                    f"{margin:.3g})")
        raise AssertionError(f"mesh sp {tag}: tokens differ from the tp-1 engine's")
    return share


def phase_serve_mesh_sp(smi: str, art: Path, device: str = "cuda") -> dict:
    """A served ``--mesh-shape {"sp": 2, "tp": 2}`` replica, four ranks on
    the one card, ``--sp-prefill-threshold 512``, on phase 8's artifact:
    the f32 and bf16 units boot side by side while this process runs the
    tp-1, sp-1 references, then serve a cold ~1500-token prompt (the ring
    prefill), a short one and one sharing the long one's prefix, in turns.
    f32 tokens equal the reference's (bf16 agreement reported).  Then a
    second f32 start with ``--snapshot-dir`` loads cold and bakes the
    sharded snapshot, and a third restores it (its ``restore`` load stage)
    at ``--decode-steps`` SP_RESTORE_K, the long-context CR's combination
    (the ring prefill beside K-step bursts, uncaptured at a world of four:
    multistep dispatches, no decode tick, ``/debug/device`` naming the
    mode), serves the same tokens and keeps each rank's peak within its HBM
    ledger."""
    import torch
    from importlib import import_module

    t_phase = time.perf_counter()
    llama = import_module(f"{PKG}.models.llama")
    loader = import_module(f"{PKG}.server.loader")
    app = import_module(f"{PKG}.server.app")
    snap = import_module(f"{PKG}.server.snapshot")
    cfg = llama.LlamaConfig.llama2_7b(num_layers=MESH_LAYERS)
    prompts = _sp_prompts(cfg.vocab_size)
    def sp_cuda(dtype: str, **more) -> dict:
        return _mesh_cuda(dtype, SP_MESH, spPrefillThreshold=SP_THRESHOLD, **more)

    snapdir = ROOT / "build" / "smoke_sp_snapshots"  # ignored by git, deleted after
    shutil.rmtree(snapdir, ignore_errors=True)
    out: dict = {"mesh": SP_MESH, "layers": MESH_LAYERS, "threshold": SP_THRESHOLD,
                 "prompts": {n: len(p) for n, p in prompts.items()},
                 "cut": f"depth {MESH_LAYERS} of Llama-2-7B's 32 layers (time limit); widths "
                        "whole"}
    dtypes = ("float32", "bfloat16")
    units: list = []
    try:
        units = [_launch_unit(art, sp_cuda(dt), device, f"sp_{dt}",
                              OUT_DIR / f"mesh_sp_{dt}_reports") for dt in dtypes]
        refs, preds = {}, {}
        for dt in dtypes:  # while the units boot
            t1 = time.perf_counter()
            out[f"reference_chunk_s_{dt}"] = {}
            refs[dt], preds[dt] = _mesh_reference(app, loader, art, dt, prompts, device,
                                                  sequential=True,
                                                  chunk_s=out[f"reference_chunk_s_{dt}"])
            out[f"reference_s_{dt}"] = time.perf_counter() - t1
        runs = {}
        for dt, unit in zip(dtypes, units):
            runs[dt] = _sp_served(unit, prompts, cfg.vocab_size)
            _sp_checks(dt, runs[dt], device)
            runs[dt]["agreement"] = _sp_compare(dt, runs[dt], refs[dt], prompts, llama,
                                                preds[dt], device, exact=dt == "float32")
        units = []
        # The second start bakes, the third restores (f32).
        t1 = time.perf_counter()
        snapshot = {"snapshot": {"enabled": True, "dir": str(snapdir)}}
        bake = _launch_unit(art, sp_cuda("float32", **snapshot), device, "sp_bake",
                            OUT_DIR / "mesh_sp_bake_reports")
        units = [bake]
        _await_unit(bake)
        out["bake_start_s"] = bake["start_s"]
        _stop_units([bake])
        units = []
        spath = snap.snapshot_path_for(str(snapdir), str(art))
        manifest = snap.read_manifest(spath)
        if manifest["identity"]["mesh_shape"] != SP_MESH:
            raise AssertionError(f"mesh sp bake: identity {manifest['identity']}")
        sharded = [leaf for leaf in manifest["leaves"] if "shards" in leaf]
        if not sharded or any(len(leaf["shards"]) != SP_MESH["tp"] for leaf in sharded):
            raise AssertionError("mesh sp bake: not one shard a tp block in the manifest")
        out["bake_s"] = time.perf_counter() - t1
        out["snapshot_gib"] = manifest["total_bytes"] / 2**30
        # The restore serves the long-context CR's combination: the ring
        # prefill beside K-step bursts (K 4, uncaptured at a world of 4).
        t1 = time.perf_counter()
        restore = _launch_unit(art, sp_cuda("float32", decodeSteps=SP_RESTORE_K, **snapshot),
                               device, "sp_restore", OUT_DIR / "mesh_sp_restore_reports")
        units = [restore]
        runs["restore"] = _sp_served(restore, prompts, cfg.vocab_size)
        units = []
        out["restore_phase_s"] = time.perf_counter() - t1
        run = runs["restore"]
        if not run["load_s"]["restore"] > 0:
            raise AssertionError(f"mesh sp restore: no restore load stage: {run['load_s']}")
        _sp_checks("restore", run, device)
        if run["dispatches"]["multistep"] < 1 or run["dispatches"]["decode"] > 0:
            raise AssertionError(f"mesh sp restore at K {SP_RESTORE_K}: dispatches "
                                 f"{run['dispatches']}, expected multistep and no decode tick")
        want_mode = ("multistep, uncaptured "
                     f"({'world %d' % math.prod(SP_MESH.values()) if device == 'cuda' else 'cpu'})")
        if run["program"] != want_mode:
            raise AssertionError(f"mesh sp restore: /debug/device program {run['program']!r}, "
                                 f"expected {want_mode!r}")
        _sp_compare("restore", run, refs["float32"], prompts, llama, preds["float32"], device,
                    exact=True)
        if run["tokens"] != runs["float32"]["tokens"]:
            raise AssertionError("mesh sp restore: tokens differ from the cold unit's")
        for tag in ("float32", "bfloat16", "restore"):
            r = runs[tag]
            ring = [rep["ops"]["gen_sp_prefill"] for rep in r["reports"]]
            shift_s = [rep["collectives"].get("ring_shift", {}).get("seconds")
                       for rep in r["reports"]]
            chunk = r["reports"][0]["ops"]["gen_chunk"]
            r["chunk_ms_mean"] = 1e3 * chunk["seconds"] / chunk["count"]
            log(f"mesh sp {tag}: backend {r['backend']}, launcher exit {r['launcher_code']}; "
                f"agreement with the tp-1 engine {r.get('agreement', 1.0):.3f}; launcher start "
                f"to the leader serving {r['start_s']:.1f} s; the leader's "
                f"{MESH_CHUNK}-token chunk op {r['chunk_ms_mean']:.1f} ms mean x"
                f"{chunk['count']} (a chunked prefill of the long prompt: "
                f"{-(-SP_LONG // MESH_CHUNK)} of them); request walls "
                f"{ {k: round(v, 3) for k, v in r['request_s'].items()} } s; ring pass op "
                f"{[round(1e3 * o['seconds'], 1) for o in ring]} ms a rank; ring_shift host "
                f"s {shift_s}; "
                f"load stages {r['load_s']}; [{smi}]")
            _rank_lines(f"sp_{tag}", r, smi)
        # Each rank's peak within its HBM ledger, after the cold loads (f32,
        # bf16) and after the restore (a restore that held more than its
        # blocks would show here).  The ledger counts the ring pass's
        # activations at sp > 1 (``ring_activations``).
        if device == "cuda":
            for tag in ("float32", "bfloat16", "restore"):
                _check_rank_memory(f"sp {tag}", runs[tag])
        out["runs"] = runs
        del preds
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        for u in units:
            _kill_unit(u)
        shutil.rmtree(snapdir, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"mesh sp: the tp-1 engine's chunked prefill of each prompt (synchronized chunk "
        f"forwards) f32 {out.get('reference_chunk_s_float32')} s, bf16 "
        f"{out.get('reference_chunk_s_bfloat16')} s; {smi}")
    log(f"phase 8b wall {out['wall_s']:.1f} s (bake start {out.get('bake_s', 0):.1f} s, "
        f"restore start and traffic {out.get('restore_phase_s', 0):.1f} s, snapshot "
        f"{out.get('snapshot_gib', 0):.2f} GiB); {out['cut']}; {smi}")
    DETAIL["serve_mesh_sp"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 8c: the V2 path and the warm pool across ranks ({"dp": 2, "tp": 2})
# ---------------------------------------------------------------------------

V2_POOL_BATCH = 8    # unit (a)'s --max-batch-size: its BERT and ResNet batches
V2_LAT_N = 20        # unit (b)'s timed requests a shape
V2_WEIGHTLESS = 64 * 2**20  # what a weightless rank may hold (kernel tables, buffers)


def _v2_cuda(dtype: str, max_batch: int, **more) -> dict:
    """A V2 unit's server options as ``spec.cuda``."""
    return {"meshShape": MESH_SHAPE, "dtype": dtype, "maxBatchSize": max_batch,
            "maxBatchDelayMs": 5, **more}


def _unit_ranks(url: str) -> list:
    """Every rank's report, gathered by the leader (``GET /debug/ranks``)."""
    code, body, _ = _call("GET", url + "/debug/ranks", timeout=600)
    if code != 200:
        raise AssertionError(f"/debug/ranks answered {code}: {body}")
    return body["ranks"]


def _check_pool_memory(tag: str, reports: list, device: str) -> list:
    """Each rank's peak since the last release within its HBM ledger at
    MESH_PEAK_SLACK: a rank still holding the model before would exceed it
    by that model's blocks.  Returns (rank, peak GiB, ledger GiB) rows."""
    rows = []
    for rep in reports:
        total = rep["ledger"]["total"]
        peak = rep.get("max_memory_allocated", 0)
        rows.append((rep["rank"], peak / 2**30, total / 2**30))
        if device == "cuda" and peak > total * (1.0 + MESH_PEAK_SLACK):
            raise AssertionError(
                f"mesh v2 {tag} rank {rep['rank']}: peak {peak} B exceeds its HBM ledger "
                f"{total} B ({rep['ledger']}) by more than {100 * MESH_PEAK_SLACK:.0f}%")
    return rows


def _attach(url: str, uri: str, replace: bool = False) -> tuple[int, dict]:
    code, body, _ = _call("POST", url + "/admin/attach", {"model_uri": uri, "replace": replace},
                          timeout=900)
    return code, body


def _logits_out(resp: dict):
    import numpy as np

    out = resp["outputs"][0]
    return np.asarray(out["data"], np.float32).reshape(out["shape"])


def _bert_close(tag: str, got, ref, tol: float) -> float:
    import numpy as np

    err = np.abs(got - ref)
    if got.shape != ref.shape or not np.isfinite(got).all() or (
            err > tol + tol * np.abs(ref)).any():
        raise AssertionError(f"mesh v2 {tag}: logits disagree with the one-rank port: "
                             f"max_abs_err {float(err.max()):.3e} (tol {tol} abs + rel)")
    return float(err.max())


def phase_serve_mesh_v2(smi: str, art: Path, mesh_out: dict, device: str = "cuda") -> dict:
    """Two units of four ranks (``{"dp": 2, "tp": 2}``, gloo on the one card):

    (a) a ``--warm-pool 1`` unit in f32 with a snapshot dir, booted once
    for every attach: weightless at boot; an attach of a URI that does not
    exist answers 500 and leaves it in the warm pool; phase 8's artifact
    attached serves phase 8's tp-1 f32 tokens; a ``replace`` with BERT-base
    (phase 6's draw) answers the one-rank port's logits within
    BERT_TOL["none"], one with ResNet-50 (phase 7's draw) within RESNET_TOL;
    after each attach every rank's peak since the release stays within its
    HBM ledger (the old model is gone).

    (b) BERT-base int8 in bf16: logits within BERT_TOL["int8"] of the
    one-rank int8 port; B1 and B32/S128 request latency (HTTP, p50/p99),
    flash launches and gloo collective host seconds per rank."""
    import numpy as np
    import torch
    from importlib import import_module

    t_phase = time.perf_counter()
    llama = import_module(f"{PKG}.models.llama")
    bert = import_module(f"{PKG}.models.bert")
    resnet = import_module(f"{PKG}.models.resnet")
    loader = import_module(f"{PKG}.server.loader")
    cfg = llama.LlamaConfig.llama2_7b(num_layers=MESH_LAYERS)
    bcfg = bert.BertConfig.base()
    scratch = ROOT / "build" / "smoke_mesh_v2"  # ignored by git, deleted after
    shutil.rmtree(scratch, ignore_errors=True)
    snapdir = scratch / "snapshots"
    out: dict = {"mesh": MESH_SHAPE, "pool_batch": V2_POOL_BATCH}
    units: list = []
    try:
        t1 = time.perf_counter()
        params = bert.init(torch.Generator(device=device).manual_seed(0), bcfg,
                           dtype=torch.bfloat16, device=device)
        config = {k: v for k, v in dataclasses.asdict(bcfg).items() if k != "hidden_act"}
        bert_art = loader.save_native_model(scratch / "bert-base", "bert-classifier", params,
                                            config=config, builder_kwargs={"seq_len": 128})
        del params
        rparams, rcfg = _resnet50_params(resnet, device)
        resnet_art = loader.save_native_model(scratch / "resnet50", "resnet-classifier",
                                              rparams, config=dataclasses.asdict(rcfg),
                                              builder_kwargs={"image_size": RESNET_IMAGE})
        del rparams
        out["artifacts_s"] = time.perf_counter() - t1
        pool = _launch_unit(art, _mesh_cuda("float32", maxBatchSize=V2_POOL_BATCH,
                                            snapshot={"enabled": True, "dir": str(snapdir)}),
                            device, "v2_pool", OUT_DIR / "mesh_v2_pool_reports", warm_pool=True)
        units.append(pool)
        bunit = _launch_unit(bert_art, _v2_cuda("bfloat16", 32, quantize="int8"), device,
                             "v2_bert_int8", OUT_DIR / "mesh_v2_bert_reports", max_slots=None)
        units.append(bunit)
        # The one-rank references while the units boot.
        t1 = time.perf_counter()
        rng = np.random.default_rng(83)
        ids8 = rng.integers(1, bcfg.vocab_size, (V2_POOL_BATCH, 128)).astype(np.int32)
        ids32 = rng.integers(1, bcfg.vocab_size, (32, 128)).astype(np.int32)
        ids1 = rng.integers(1, bcfg.vocab_size, (1, 128)).astype(np.int32)
        imgs = rng.standard_normal((V2_POOL_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)).astype(
            np.float32)
        refs = {}
        for name, uri, kw, x in (
                ("bert_f32", bert_art, dict(dtype=torch.float32), ids8),
                ("bert_int8", bert_art, dict(quantize="int8", dtype=torch.bfloat16), ids32),
                ("resnet", resnet_art, {}, imgs)):
            pred = loader.load_predictor(str(uri), device=device, **kw)
            refs[name] = pred.predict(x).float().cpu().numpy()
            del pred
        gc.collect()
        torch.cuda.empty_cache()
        out["references_s"] = time.perf_counter() - t1

        # (a) the warm-pool unit
        url = _await_unit(pool, "warm pool")
        out["pool_start_s"] = pool["start_s"]
        boot = _unit_ranks(url)
        out["pool_backend"] = sorted({rep["backend"] for rep in boot})
        log(f"mesh v2 pool: backend {out['pool_backend']} on every rank")
        out["weightless_gib"] = [rep.get("memory_allocated", 0) / 2**30 for rep in boot]
        if any("ledger" in rep for rep in boot) or (device == "cuda" and any(
                rep["memory_allocated"] > V2_WEIGHTLESS for rep in boot)):
            raise AssertionError(f"mesh v2 pool: a rank is not weightless at boot: "
                                 f"{out['weightless_gib']} GiB")
        code, body = _attach(url, str(scratch / "no-such-model"))
        ready = _call("GET", url + "/readyz")
        if code != 500 or ready[0] != 503 or ready[1].get("lifecycle") != "warm-pool":
            raise AssertionError(f"mesh v2 pool: a missing model answered {code} {body}, "
                                 f"then /readyz {ready[:2]}")
        steps: dict = {}
        t1 = time.perf_counter()
        code, body = _attach(url, str(art))
        if code != 200:
            raise AssertionError(f"mesh v2 pool: the Llama attach answered {code}: {body}")
        steps["llama"] = {"attach_s": time.perf_counter() - t1, "load": body["load_breakdown_s"]}
        toks = _mesh_traffic(url, _mesh_prompts(cfg.vocab_size), cfg.vocab_size)
        if toks != mesh_out["reference_tokens"]["float32"]:
            raise AssertionError("mesh v2 pool: the attached Llama's f32 tokens differ from "
                                 "phase 8's tp-1 engine's")
        steps["llama"]["memory"] = _check_pool_memory("llama", _unit_ranks(url), device)
        for name, uri, ref_key, request in (
                ("bert", bert_art, "bert_f32", _v2_ids(ids8)),
                ("resnet", resnet_art, "resnet", _v2_tensor(imgs))):
            t1 = time.perf_counter()
            code, body = _attach(url, str(uri), replace=True)
            if code != 200:
                raise AssertionError(f"mesh v2 pool: the {name} replace answered {code}: {body}")
            step = {"attach_s": time.perf_counter() - t1, "load": body["load_breakdown_s"]}
            code, resp, _ = _call("POST", url + "/v2/models/model/infer", request)
            if code != 200:
                raise AssertionError(f"mesh v2 pool: {name} infer answered {code}: {resp}")
            got, ref = _logits_out(resp), refs[ref_key]
            if name == "bert":
                step["max_abs_err"] = _bert_close("pool bert", got, ref, BERT_TOL["none"])
            else:
                step["rel_err"] = float(np.abs(got - ref).max() / np.abs(ref).max())
                if got.shape != ref.shape or not step["rel_err"] <= RESNET_TOL:
                    raise AssertionError(f"mesh v2 pool: ResNet-50 logits {step['rel_err']:.3e} "
                                         f"from the one-rank port's (tol {RESNET_TOL})")
            reports = _unit_ranks(url)
            step["memory"] = _check_pool_memory(name, reports, device)
            step["follower_ops"] = reports[1]["ops"]
            steps[name] = step
        ops = steps["resnet"]["follower_ops"]
        if ops.get("detach", {}).get("count") != 3 or ops.get("attach", {}).get("count") != 4:
            raise AssertionError(f"mesh v2 pool: follower ops {sorted(ops)}: expected 4 "
                                 "attaches and 3 detaches")
        _stop_units([pool])
        units.remove(pool)
        out["pool"] = steps
        for name, step in steps.items():
            log(f"mesh v2 pool {name}: attach {step['attach_s']:.1f} s (load stages "
                f"{step['load']}); per rank (rank, peak GiB, ledger GiB) {step['memory']}"
                + (f"; logits max_abs_err {step['max_abs_err']:.3e}" if "max_abs_err" in step
                   else "") + (f"; rel_err {step['rel_err']:.3e}" if "rel_err" in step else "")
                + f" [{smi}]")

        # (b) BERT-base int8 over four ranks
        burl = _await_unit(bunit, "bert-classifier")
        out["bert_start_s"] = bunit["start_s"]
        infer = burl + "/v2/models/model/infer"
        code, resp, _ = _call("POST", infer, _v2_ids(ids32))
        if code != 200:
            raise AssertionError(f"mesh v2 bert int8: infer answered {code}: {resp}")
        b = {"max_abs_err": _bert_close("bert int8", _logits_out(resp), refs["bert_int8"],
                                        BERT_TOL["int8"])}
        before = _unit_ranks(burl)
        for shape, x in (("b1", ids1), ("b32", ids32)):
            body = _v2_ids(x)
            for _ in range(3):
                _call("POST", infer, body)
            lat = []
            for _ in range(V2_LAT_N):
                t1 = time.perf_counter()
                code, resp, _ = _call("POST", infer, body)
                lat.append((time.perf_counter() - t1) * 1e3)
                if code != 200:
                    raise AssertionError(f"mesh v2 bert int8 {shape}: {code} {resp}")
            b[shape] = {"p50_ms": float(np.percentile(lat, 50)),
                        "p99_ms": float(np.percentile(lat, 99))}
        after = _unit_ranks(burl)
        flash, coll = [], []
        for r0, r1 in zip(before, after):
            n = r1["launches"]["flash_attention"] - r0["launches"]["flash_attention"]
            flash.append(n)
            coll.append({k: round(v["seconds"] - r0["collectives"].get(k, {}).get("seconds", 0.0),
                                  4) for k, v in r1["collectives"].items()})
        batches = 2 * (3 + V2_LAT_N)
        if device == "cuda" and flash != [bcfg.num_layers * batches] * len(flash):
            raise AssertionError(f"mesh v2 bert int8: flash launches per rank {flash}, expected "
                                 f"{bcfg.num_layers} x {batches} batches on every rank")
        follower = after[1]["ops"]["predict"]["count"] - before[1]["ops"]["predict"]["count"]
        if follower != batches:
            raise AssertionError(f"mesh v2 bert int8: the follower replayed {follower} of "
                                 f"{batches} batches")
        b.update(flash_launches=flash, collective_s=coll, batches=batches,
                 memory=_check_pool_memory("bert int8", after, device),
                 backend=sorted({rep["backend"] for rep in after}))
        _stop_units([bunit])
        units.remove(bunit)
        out["bert_int8"] = b
        log(f"mesh v2 bert int8 {MESH_SHAPE} bf16 (backend {b['backend']}, launcher exit "
            f"{bunit.get('launcher_code')}): logits vs the one-rank int8 port "
            f"max_abs_err {b['max_abs_err']:.3e} (tol {BERT_TOL['int8']}); request latency "
            f"B1/S128 p50 {b['b1']['p50_ms']:.2f} ms p99 {b['b1']['p99_ms']:.2f} ms, B32/S128 "
            f"p50 {b['b32']['p50_ms']:.2f} ms p99 {b['b32']['p99_ms']:.2f} ms (HTTP, "
            f"{V2_LAT_N} each); flash launches per rank {flash} for {batches} batches "
            f"({bcfg.num_layers} x, H {bcfg.num_heads // MESH_SHAPE['tp']} a rank); gloo "
            f"collective host s per rank over those batches {coll}; per rank (rank, peak GiB, "
            f"ledger GiB) {b['memory']} [{smi}]")
    finally:
        for u in units:
            _kill_unit(u)
        shutil.rmtree(scratch, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 8c wall {out['wall_s']:.1f} s; launcher start to the leader serving: pool "
        f"{out.get('pool_start_s', 0):.1f} s, bert int8 {out.get('bert_start_s', 0):.1f} s; "
        f"launcher exits {pool.get('launcher_code')}, {bunit.get('launcher_code')}; {smi}")
    DETAIL["serve_mesh_v2"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 8d: the port's shipped llama-7b-tp4 CR ({"dp": 1, "tp": 4}, K 4)
# ---------------------------------------------------------------------------

TP4_EXAMPLE = "llama-7b-tp4.yaml"  # in the port's deploy/examples
TP4_MESH = {"dp": 1, "tp": 4}
TP4_SLOTS = 4       # the CR's maxSlots 32 at phase 8's 4: a unified tick runs slots x 512 rows
TP4_NEW = 16        # tokens a request
TP4_COLD = 1100     # the cold prompt: three chunks of 512 (the last partial), packed
TP4_SHARED = 1024   # the second prompt's prefix: the cold prompt's first two chunks
TP4_SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 1234}
# tag -> (what runs a decode tick, quantize).  "k4" and "unified": the CR's
# split engine and the same with unifiedStep, int8 weights over an f32 KV
# cache, greedy tokens held equal to one rank's.  "shipped": the CR as it
# ships (int8kv), tokens reported: its int8 K/V quantizer turns the last-bit
# differences of tp 4's sums into whole code steps (PERF.md §6).
TP4_VARIANTS = {"k4": ("multistep", "int8"), "unified": ("superstep", "int8"),
                "shipped": ("multistep", "int8kv")}


def _cr_scalar(text: str):
    t = text.strip().strip("\"'")
    if t in ("true", "false"):
        return t == "true"
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    return t


def read_example_cr(name: str) -> dict:
    """One CR of the port's ``deploy/examples`` as a dict.  The card's
    machine may lack a YAML library, so this reads the subset the CR is
    written in: block mappings by indentation, ``{ a: 1, b: 2 }`` flow
    mappings, ``#`` comments, and boolean, number and string scalars (a
    sequence or a second document raises)."""
    root: dict = {}
    stack = [(-1, root)]
    for raw in (ROOT / PKG / "deploy" / "examples" / name).read_text().splitlines():
        line = "" if raw.lstrip().startswith("#") else re.sub(r"\s+#.*$", "", raw).rstrip()
        if not line.strip():
            continue
        if line.strip() == "---" or line.lstrip().startswith("- "):
            raise ValueError(f"{name}: {line.strip()!r} is outside the subset read here")
        indent = len(line) - len(line.lstrip())
        key, _, value = line.strip().partition(":")
        while indent <= stack[-1][0]:
            stack.pop()
        parent, value = stack[-1][1], value.strip()
        if not value:
            parent[key] = {}
            stack.append((indent, parent[key]))
        elif value.startswith("{"):
            parent[key] = {k.strip(): _cr_scalar(v) for k, v in
                           (item.split(":", 1) for item in value.strip("{} ").split(","))}
        else:
            parent[key] = _cr_scalar(value)
    return root


def _tp4_cuda(unified: bool, quantize: str) -> tuple[dict, dict]:
    """The shipped CR's ``spec.cuda`` as this phase serves it, and what it
    changes: option -> (the CR's value, the served one; None drops it)."""
    spec = read_example_cr(TP4_EXAMPLE)["spec"]
    cuda = dict(spec["cuda"])
    shipped = {"gpuTopology": UNIT_TOPOLOGY, "meshShape": TP4_MESH, "quantize": "int8kv",
               "decodeSteps": 4, "prefillChunk": 512, "prefillBatch": 4}
    if spec["backend"] != "cuda" or any(cuda.get(k) != v for k, v in shipped.items()) or (
            cuda["prefixCache"].get("chunkTokens") != 512):
        raise AssertionError(f"mesh tp4: {TP4_EXAMPLE} no longer ships {shipped}: {cuda}")
    changed = {
        "dtype": (cuda.get("dtype", "bfloat16"), "float32"),  # tokens held exactly
        "maxSlots": (cuda.get("maxSlots"), TP4_SLOTS),
        "snapshot": (cuda.get("snapshot"), None),  # no bake: 8b bakes and restores
        "compileCacheDir": (cuda.get("compileCacheDir"), str(ROOT / "build" / "torch_kernels")),
    }
    if quantize != cuda["quantize"]:
        changed["quantize"] = (cuda["quantize"], quantize)
    if unified:
        changed["unifiedStep"] = (cuda.get("unifiedStep", False), True)
    for k, (_, v) in changed.items():
        if v is None:
            cuda.pop(k, None)
        else:
            cuda[k] = v
    return cuda, changed


def _tp4_prompts(vocab: int) -> dict:
    """Sent one at a time: a cold prompt of three chunks (packed), one
    sharing its first two chunks (a prefix-cache seed), two short greedy
    prompts and a seeded sampled one; name -> (prompt, sampling)."""
    import numpy as np

    rng = np.random.default_rng(84)
    ids = lambda n: [int(t) for t in rng.integers(3, vocab, n)]  # noqa: E731
    cold = ids(TP4_COLD)
    return {"cold": (cold, {}), "shared": (cold[:TP4_SHARED] + ids(40), {}),
            "short_a": (ids(20), {}), "short_b": (ids(57), {}),
            "sampled": (ids(30), dict(TP4_SAMPLED))}


def _tp4_reference(app, loader, art: Path, cuda: dict, prompts: dict, device: str) -> dict:
    """The traffic through a one-rank engine in this process with the
    unit's options, one request at a time; its program is captured into
    CUDA graphs.  Returns its tokens, its program's mode and graphs, its
    dispatches by kind, the cold prompt's first prefix chunk (K/V as the
    radix cache holds it) and the predictor (for a margin)."""
    import torch
    from importlib import import_module

    metrics_mod = import_module(f"{PKG}.server.metrics")
    argv = (_unit_pod(art, cuda)["args"] + _unit_local(device, TP4_SLOTS)
            + ["--mesh-shape", json.dumps({"dp": 1, "tp": 1})])
    conf = app.config_from_args(app.build_arg_parser().parse_args(argv))
    pred = loader.load_predictor(str(art), quantize=conf.quantize, device=device,
                                 dtype=app._DTYPES[conf.dtype])
    engine = app.make_gen_engine(pred, conf, metrics_mod.ServerMetrics("smoke", "v1", "smoke"))
    engine.start()
    try:
        prog = engine._program
        replays0 = prog.replays
        toks = {}
        for n, (p, kw) in prompts.items():
            toks[n] = engine.submit(p, TP4_NEW, **kw).result(timeout=600).tolist()
        _, chunks = engine.export_prefix_kv(prompts["cold"][0][:TP4_SHARED])
        res = {"tokens": toks, "mode": prog.mode, "captured": prog.captured,
               "graphs": len(prog.graphs), "replays": prog.replays - replays0,
               "dispatches": dict(engine.dispatches_total), "chunk": chunks[0], "pred": pred}
    finally:
        engine.shutdown()
    if device == "cuda":
        torch.cuda.synchronize()
    return res


def _tp4_served(unit: dict, prompts: dict, vocab: int) -> dict:
    """Wait for the unit, send the traffic one request at a time, read
    ``/metrics``, ``/debug/device`` and the cold prompt's first prefix
    chunk (``/admin/kv/export``), stop the unit, read its reports."""
    from importlib import import_module

    kv_transfer = import_module(f"{PKG}.server.kv_transfer")
    try:
        url = _await_unit(unit)
        gen = url + "/v2/models/model/generate"
        toks, walls = {}, {}
        for n, (p, kw) in prompts.items():
            t0 = time.perf_counter()
            toks[n] = _check_outputs(_post(gen, {"prompt_ids": p, "max_new_tokens": TP4_NEW,
                                                 **kw}), [TP4_NEW], vocab)[0]
            walls[n] = time.perf_counter() - t0
        samples = _scrape(url)
        status, blob, _ = _http_bytes("POST", url + "/admin/kv/export", json.dumps(
            {"prompt_ids": prompts["cold"][0][:TP4_SHARED]}).encode())
        if status != 200:
            raise AssertionError(f"mesh {unit['tag']}: /admin/kv/export answered {status}")
        run = {"tokens": toks, "request_s": walls, "start_s": unit["start_s"],
               "dispatches": {op: _value(samples, "tpumlops_engine_dispatches_total", op=op)
                              for op in ("decode", "verify", "multistep", "superstep",
                                         "packed-prefill", "prefill", "seed")},
               "prefix_hits": _value(samples, "tpumlops_prefix_cache_hits_total"),
               "program": _call("GET", url + "/debug/device")[1].get("program"),
               "chunk": kv_transfer.deserialize_chunks(blob)[1][0]}
    except BaseException:
        _kill_unit(unit)
        raise
    _stop_units([unit])
    _mesh_reports(unit, run)
    return run


def _code_steps(got, ref) -> dict:
    """Each layer's K and V of one prefix chunk (``[L, 1, C, NKV, D]``, the
    int8 cache dequantized) against one rank's: the elements that differ by
    half a quantization step of their (position, head) or more, and the
    largest difference in steps."""
    out = {}
    for name, x, y in (("k", got[0], ref[0]), ("v", got[1], ref[1])):
        x, y = x.float(), y.float()
        step = (y.abs().amax(-1, keepdim=True) / 127.0).clamp(min=1e-30)
        d = (x - y).abs() / step
        out[name] = {"differing": (d >= 0.5).sum(dim=(1, 2, 3, 4)).tolist(),
                     "max_steps": [round(float(v), 3) for v in d.amax(dim=(1, 2, 3, 4))],
                     "of": int(x[0].numel())}
    return out


def _sampled_gap(llama, pred, prompt: list, toks: list, pos: int, kw: dict,
                 device: str) -> float:
    """The one-rank model's smallest gap between adjacent scaled logits among
    the ranks a sampled draw keeps (top-k, then top-p) where token ``pos``
    is drawn (teacher-forced on its own tokens, in f32): the Gumbel noise
    goes by sorted rank, so two kept logits closer than the tp sums'
    rounding trade their noise and can change the draw."""
    import torch

    lm = pred.causal_lm
    ids = torch.tensor([list(prompt) + list(toks[:pos])], device=device)
    logits, _ = llama.prefill(lm["params"], ids, lm["cfg"], torch.float32)
    s = torch.sort(logits[0, -1].float() / kw["temperature"], descending=True).values
    s = s[:kw["top_k"]]
    p = torch.softmax(s, dim=0)
    kept = int(((torch.cumsum(p, 0) - p) < kw["top_p"]).sum())
    return float((s[:kept - 1] - s[1:kept]).min()) if kept > 1 else float("inf")


def _first_diff(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _tp4_checks(tag: str, run: dict, ref: dict, prompts: dict, want_backend: str,
                device: str) -> None:
    """The unit against the one-rank engine and its own ranks: see
    :func:`phase_serve_mesh_tp4`."""
    kind, quantize = TP4_VARIANTS[tag]
    world = math.prod(TP4_MESH.values())
    if quantize != "int8kv":
        greedy = [n for n, (_, kw) in prompts.items() if not kw]
        if any(run["tokens"][n] != ref["tokens"][n] for n in greedy):
            raise AssertionError(f"mesh tp4 {tag}: f32 greedy tokens differ from the one-rank "
                                 f"engine's: first differing token {run['first_diff']}")
    if device == "cuda" and (not ref["captured"] or ref["mode"] != f"{kind}, captured"
                             or ref["replays"] < 1):
        raise AssertionError(f"mesh tp4 {tag}: the one-rank engine's program {ref['mode']} "
                             f"replayed {ref['replays']} graphs")
    want_mode = f"{kind}, uncaptured ({'world %d' % world if device == 'cuda' else 'cpu'})"
    if run["program"] != want_mode:
        raise AssertionError(f"mesh tp4 {tag}: /debug/device program {run['program']!r}, "
                             f"expected {want_mode!r}")
    d = run["dispatches"]
    others = {"decode", "verify", "multistep", "superstep"} - {kind}
    if d[kind] < 1 or any(d[k] for k in others):
        raise AssertionError(f"mesh tp4 {tag}: the leader's dispatches {d}: expected {kind} "
                             f"and no other decode kind")
    if run["prefix_hits"] < 1 or d["seed"] < 1:
        raise AssertionError(f"mesh tp4 {tag}: the shared prompt was not seeded from the "
                             f"prefix cache ({run['prefix_hits']} hits, dispatches {d})")
    if run["backend"] != want_backend:
        raise AssertionError(f"mesh tp4 {tag}: ranks used {run['backend']}, expected "
                             f"{want_backend}")
    reps = run["reports"]
    ops = [{k: v["count"] for k, v in rep["ops"].items() if k.startswith("gen_")}
           for rep in reps]
    if any(o != ops[0] for o in ops[1:]):
        raise AssertionError(f"mesh tp4 {tag}: a follower replayed other ops than the leader "
                             f"dispatched: {ops}")
    if ops[0].get(f"gen_{kind}", 0) != d[kind]:
        raise AssertionError(f"mesh tp4 {tag}: {ops[0]} ops for {d[kind]} {kind} dispatches")
    launches = [rep["launches"] for rep in reps]
    if any(la != launches[0] for la in launches):
        raise AssertionError(f"mesh tp4 {tag}: the ranks' launches differ: {launches}")
    if device == "cuda":
        # decode attention, RMSNorm and the verify instance at 512 positions:
        # the super-step's (unified) or, f32 q, the packed chunks' (split)
        for k in ("decode_attention", "rmsnorm", "verify_attention"):
            if launches[0][k] <= 0:
                raise AssertionError(f"mesh tp4 {tag}: no {k} launch on the ranks")
        _check_rank_memory(f"tp4 {tag}", run)


def phase_serve_mesh_tp4(smi: str, art: Path, device: str = "cuda") -> dict:
    """The port's shipped ``deploy/examples/llama-7b-tp4.yaml`` on the card:
    its ``h100-4`` manifest built by the operator's builder, three units of
    four ranks started side by side through the launcher with
    ``--ranks-share-card`` (gloo), each serving phase 8's artifact in f32
    (every option changed from the CR is printed): (a) ``k4``, the CR's
    split engine (``{"dp": 1, "tp": 4}``, ``decodeSteps`` 4,
    ``prefillChunk`` 512, ``prefillBatch`` 4, the prefix cache in chunks of
    512) and (b) ``unified``, the same with ``unifiedStep`` (a super-step
    512 wide), both with int8 weights over an f32 KV cache; (c)
    ``shipped``, the CR's int8kv.  The traffic, one request at a time: a
    cold 1100-token prompt (three packed chunks), one sharing its first
    1024 tokens (seeded from the prefix cache), two short greedy prompts
    and a seeded sampled one.  Against an in-process one-rank engine with
    the same options (its program captured): (a) and (b)'s greedy tokens
    equal; every unit's agreement, first differing tokens (with the one-rank
    top-2 margin, or for the sampled draw the smallest gap between kept
    logits, there) and the int8 codes of the cold prompt's first chunk
    against one rank's are printed.  Each unit: the leader's dispatches
    show multistep (a, c) or superstep (b) and no other decode kind; every
    follower replayed the leader's ops; ``/debug/device`` reports the
    uncaptured program; every rank launched the same kernels; each rank's
    peak stays within its HBM ledger; every launcher exits 0 after
    SIGTERM.  Prints the leader's K-step and super-step op walls."""
    import torch
    from importlib import import_module

    t_phase = time.perf_counter()
    llama = import_module(f"{PKG}.models.llama")
    loader = import_module(f"{PKG}.server.loader")
    app = import_module(f"{PKG}.server.app")
    distributed = import_module(f"{PKG}.parallel.distributed")
    cfg = llama.LlamaConfig.llama2_7b(num_layers=MESH_LAYERS)
    prompts = _tp4_prompts(cfg.vocab_size)
    want_backend = distributed.choose_backend(math.prod(TP4_MESH.values()), device)
    cudas, changed = {}, {}
    for tag, (kind, quantize) in TP4_VARIANTS.items():
        cudas[tag], changed[tag] = _tp4_cuda(kind == "superstep", quantize)
    out: dict = {"example": TP4_EXAMPLE, "mesh": TP4_MESH, "layers": MESH_LAYERS,
                 "changed": {tag: {k: list(v) for k, v in c.items()}
                             for tag, c in changed.items()},
                 "prompts": {n: len(p) for n, (p, _) in prompts.items()},
                 "cut": f"depth {MESH_LAYERS} of Llama-2-7B's 32 layers (time limit); widths "
                        "whole"}
    log(f"mesh tp4: {TP4_EXAMPLE} served with these options changed (CR -> served): "
        f"{json.dumps(out['changed'])}")
    units: list = []
    try:
        units = [_launch_unit(art, cudas[tag], device, f"tp4_{tag}",
                              OUT_DIR / f"mesh_tp4_{tag}_reports", max_slots=TP4_SLOTS)
                 for tag in TP4_VARIANTS]
        refs = {}
        for tag in TP4_VARIANTS:  # while the units boot
            t1 = time.perf_counter()
            refs[tag] = _tp4_reference(app, loader, art, cudas[tag], prompts, device)
            refs[tag]["s"] = time.perf_counter() - t1
        runs = {}
        for tag, unit in zip(TP4_VARIANTS, units):
            runs[tag] = _tp4_served(unit, prompts, cfg.vocab_size)
        units = []
        for tag, (kind, quantize) in TP4_VARIANTS.items():
            run, ref = runs[tag], refs[tag]
            leader = run["reports"][0]["ops"]
            op = leader.get(f"gen_{kind}", {"count": 0, "seconds": 0.0, "max_s": 0.0})
            run["op_ms_mean"] = 1e3 * op["seconds"] / max(op["count"], 1)
            run["op_ms_max"] = 1e3 * op["max_s"]
            agree = sum(a == b for n in ref["tokens"]
                        for a, b in zip(run["tokens"][n], ref["tokens"][n]))
            run["agreement"] = agree / sum(len(t) for t in ref["tokens"].values())
            run["first_diff"] = {n: _first_diff(run["tokens"][n], ref["tokens"][n])
                                 for n in ref["tokens"]}
            run["at_first_diff"] = {}
            for n, pos in run["first_diff"].items():
                if pos is None:
                    continue
                prompt, kw = prompts[n]
                run["at_first_diff"][n] = (
                    {"min_kept_gap": _sampled_gap(llama, ref["pred"], prompt, ref["tokens"][n],
                                                  pos, kw, device)} if kw else
                    {"top2_margin": _top2_margin(llama, ref["pred"], prompt, ref["tokens"][n],
                                                 pos, device)})
            run["kv_codes"] = (_code_steps(run["chunk"], ref["chunk"])
                               if quantize == "int8kv" else None)
            log(f"mesh tp4 {tag} ({kind}, {quantize}): backend {run['backend']}, launcher exit "
                f"{run['launcher_code']}; program {run['program']!r} (one rank: "
                f"{ref['mode']!r}, {ref['graphs']} graphs, {ref['replays']} replays); "
                f"agreement with the one-rank engine {run['agreement']:.3f}, first differing "
                f"token {run['first_diff']} ({run['at_first_diff']}); the leader's {kind} op "
                f"{run['op_ms_mean']:.1f} ms mean, {run['op_ms_max']:.1f} max x{op['count']}; "
                f"dispatches {run['dispatches']}; prefix hits {run['prefix_hits']}; request "
                f"walls { {k: round(v, 3) for k, v in run['request_s'].items()} } s; launcher "
                f"start to the leader serving {run['start_s']:.1f} s; one-rank reference "
                f"{ref['s']:.1f} s; [{smi}]")
            if run["kv_codes"] is not None:
                log(f"mesh tp4 {tag}: the cold prompt's first chunk, int8 K/V elements that "
                    f"differ from one rank's by half a step or more, by layer: "
                    f"{json.dumps(run['kv_codes'])}")
            _rank_lines(f"tp4_{tag}", run, smi)
        for tag in TP4_VARIANTS:
            _tp4_checks(tag, runs[tag], refs[tag], prompts, want_backend, device)
        for run in runs.values():
            del run["chunk"]
        out["runs"] = runs
        out["reference"] = {tag: {k: v for k, v in r.items() if k not in ("pred", "chunk")}
                            for tag, r in refs.items()}
        del refs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        for u in units:
            _kill_unit(u)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 8d wall {out['wall_s']:.1f} s; {out['cut']}; {smi}")
    DETAIL["serve_mesh_tp4"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 8e: the tp-8 dry run (scripts/rehearse_tp8_dryrun.py) as eight ranks
# ---------------------------------------------------------------------------

TP8_BUDGET_S = 45.0  # phase 8e's share of SMOKE_LIMIT_S
# Each rank's bf16 logits against a one-rank int8 load of the same artifact,
# max |difference| over max |logit|: the ranks' int8 leaves are quantized on
# the host and one rank's on the card, where a scale may round one f32 ulp
# apart (and then a code one step); bf16 activations summed across 8 row
# blocks in another order may round one bf16 step (2^-8) apart.
TP8_TOL = 2e-2


def phase_tp8_dryrun(smi: str, art: Path, device: str = "cuda") -> dict:
    """``scripts/rehearse_tp8_dryrun.py``'s ``dryrun`` on phase 8's artifact
    (Llama-2-7B's widths at MESH_LAYERS layers): eight ranks started by the
    launcher's rank plan on the one card (gloo, ``--ranks-share-card``),
    each loading its blocks at ``{"tp": 8}`` int8 in bf16, checking every
    int8 leaf is its block of the whole leaf quantized, and running one
    16-token prefill; every rank's logits equal (the dry run's check), and
    within TP8_TOL of a one-rank int8 load of the same artifact in this
    process.  Each rank's RMSNorm and flash launches over its prefill (2L +
    1 and L)."""
    import torch
    from importlib import import_module

    dry = import_module(f"{PKG}.scripts.rehearse_tp8_dryrun")
    llama = import_module(f"{PKG}.models.llama")
    loader = import_module(f"{PKG}.server.loader")
    tag = "8e tp8 dry run"
    t_phase = time.perf_counter()
    res = dry.dryrun(art, device, torch.bfloat16, timeout=300)
    pred = loader.load_predictor(str(art), quantize="int8", device=device, dtype=torch.bfloat16)
    p, cfg = pred.causal_lm["params"], pred.causal_lm["cfg"]
    ids = torch.ones((1, dry.PROMPT), dtype=torch.long, device=device)
    ref = llama.prefill(p, ids, cfg, dtype=torch.bfloat16)[0].float().cpu()
    # One rank's int8 leaves (quantized on the card) against the same leaves
    # quantized on the host, as the ranks' are: scales and codes that differ.
    apart = {"scales": 0, "codes": 0, "of_scales": 0, "of_codes": 0, "max_code_step": 0}
    for key, host in res["whole"].items():
        card = p["lm_head"] if key == "lm_head" else p["layers"][key.split("|")[1]]
        apart["scales"] += int((card["scale"].cpu() != host["scale"]).sum())
        step = (card["q8"].cpu().int() - host["q8"].int()).abs()
        apart["codes"] += int((step > 0).sum())
        apart["max_code_step"] = max(apart["max_code_step"], int(step.max()))
        apart["of_scales"] += host["scale"].numel()
        apart["of_codes"] += host["q8"].numel()
    del pred, p
    torch.cuda.empty_cache()
    gap = float((res["logits"] - ref).abs().max() / ref.abs().max())
    if not gap <= TP8_TOL:
        raise AssertionError(f"{tag}: the ranks' logits are {gap:.3e} of max |logit| from one "
                             f"rank's (tolerance {TP8_TOL})")
    want = ({"rmsnorm": 2 * cfg.num_layers + 1, "flash_attention": cfg.num_layers}
            if device == "cuda" else {"rmsnorm": 0, "flash_attention": 0})
    for r in res["ranks"]:
        if r["launches"] != want or r["backend"] != "gloo" or len(r["blocks"]) != 8:
            raise AssertionError(f"{tag}: rank {r['rank']} launched {r['launches']} (want "
                                 f"{want}) over {r['backend']}, blocks {r['blocks']}")
    out = {"gap": gap, "apart": apart, "wall_s": time.perf_counter() - t_phase,
           "unit_wall_s": res["wall_s"],
           "share_card": res["share_card"],
           "ranks": [{k: r[k] for k in ("rank", "device", "backend", "load_s", "load_stats",
                                        "prefill_s", "load_peak_bytes", "launches")}
                     for r in res["ranks"]],
           "blocks": res["ranks"][0]["blocks"]}
    log(f"{tag}: 8 ranks over gloo on the one card (shared: {res['share_card']}), each "
        f"holding its blocks ({out['blocks'][0]}, ...); loads "
        f"{[round(r['load_s'], 2) for r in out['ranks']]} s, load peaks "
        f"{[round((r['load_peak_bytes'] or 0) / 2**30, 3) for r in out['ranks']]} GiB, prefills "
        f"{[round(r['prefill_s'], 2) for r in out['ranks']]} s; logits equal across ranks, "
        f"{gap:.3e} of max |logit| from one rank's (tolerance {TP8_TOL}); one rank's int8 "
        f"leaves (quantized on the card) against the host's: {apart}; the unit "
        f"{res['wall_s']:.1f} s, phase wall {out['wall_s']:.1f} s; {smi}")
    if out["wall_s"] > TP8_BUDGET_S:
        log(f"{tag}: WARNING phase wall {out['wall_s']:.1f} s over its {TP8_BUDGET_S:.0f} s share")
    DETAIL["tp8_dryrun"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 9: the control plane's canary (BERT-base promoted 0 -> 100%)
# ---------------------------------------------------------------------------

CANARY_RATE = 50.0   # V2 requests a second through the router (open loop)
CANARY_SEQ = 128     # tokens a request (B1)
CANARY_BUDGET_S = 60.0  # phase 9's share of SMOKE_LIMIT_S
# The reference's canary: 10% steps from 10%, its error-rate gate at the
# default 2%, and its latency gate with tolerances the router's histograms
# can resolve on one card: two equal BERT-base servers there differ by up
# to 13% in mean latency as the traffic share moves (the busier server
# queues longer), and a p95 interpolated in the 10/25/50 ms buckets jumps
# 1.85x when a few requests cross 25 ms; at the default 5% the gate refused
# 78 times in one promotion and ran out of attempts in another (PERF.md,
# §6).  So p95 may double (one bucket) and the mean may rise 25%, as the
# reference's own live local-plane canaries relax them
# (``clients.localplane.relaxed_gate_spec``).  Only the pacing is cut to
# seconds.  A canary with no traffic in the window gets the reference's
# warm-up requests, sent to it directly (a just-started server's first
# requests are its slowest).  The kernel cache is the checkout's, which the
# servers share.
CANARY_SPEC = {
    "modelName": "bert-base", "modelAlias": "prod", "backend": "cuda",
    "monitoringInterval": 0.2,
    "thresholds": {"latencyP95": 1.0, "latencyAvg": 0.25},
    "canary": {"stepInterval": 0.5, "attemptDelay": 0.3, "maxAttempts": 100,
               "metricsWindow": 2, "warmupRequests": 32},
    "cuda": {"gpuTopology": "h100-1",
             "compileCacheDir": str(ROOT / "build" / "torch_kernels")},
}
_ROUTER_BUILD: dict = {}


def start_router_build() -> None:
    """Compile the port's ``native/router.cc`` with g++ on a thread while the
    kernels build and the early phases run; phase 9 joins it."""
    from importlib import import_module

    def build():
        t0 = time.perf_counter()
        try:
            _ROUTER_BUILD["path"] = import_module(f"{PKG}.clients.router").build_router()
        except BaseException as e:  # re-raised by phase 9
            _ROUTER_BUILD["error"] = e
        _ROUTER_BUILD["s"] = time.perf_counter() - t0

    _ROUTER_BUILD["thread"] = threading.Thread(target=build, daemon=True, name="router-build")
    _ROUTER_BUILD["thread"].start()


class _Journal:
    """The runtime's recorder: every gate and transition record, in order."""

    def __init__(self):
        self.records: list = []

    def record(self, namespace: str, name: str, rec) -> None:
        self.records.append(rec)


def _paced_traffic(url: str, body: bytes, rate: float, stop: threading.Event, out: dict):
    """Open-loop V2 traffic at ``rate`` requests a second until ``stop``;
    ``out`` counts what was sent and every answer that was not a 2xx."""
    def one():
        try:
            req = urllib.request.Request(url, data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                r.read()
                ok = 200 <= r.status < 300
        except Exception:
            ok = False
        with out["lock"]:
            out["non_2xx" if not ok else "ok"] += 1

    with ThreadPoolExecutor(16) as pool:
        t_next = time.perf_counter()
        while not stop.is_set():
            pool.submit(one)
            out["sent"] += 1
            t_next += 1.0 / rate
            time.sleep(max(0.0, t_next - time.perf_counter()))


def _pod_argv(builder, config, version: str, uri: str, port: int, device: str) -> list[str]:
    """The command a ``backend: cuda`` pod of ``version`` runs, from the
    operator's own manifest, on a local port."""
    manifest = builder.build_deployment(
        name="bert-base", namespace="models", owner_uid="smoke", config=config,
        current_version=version, new_model_uri=uri, traffic_current=100)
    pod = manifest["spec"]["predictors"][0]["componentSpecs"][0]["spec"]
    (c,) = pod["containers"]
    if (c["command"] != ["python", "-m", f"{PKG}.server"]
            or c["resources"]["limits"] != {"nvidia.com/gpu": "1"}
            or any(v["name"] == "dshm" for v in pod.get("volumes", []))):
        raise AssertionError(f"canary: the pod runs {c['command']} with {c['resources']} and "
                             f"volumes {pod.get('volumes')}")
    return ([sys.executable] + c["command"][1:] + c["args"]
            + ["--host", "127.0.0.1", "--port", str(port), "--metrics-port", "0",
               "--drain-s", "0", "--device", device])


def _batches(base: str) -> float:
    """Batches the server's engine ran (its warm-up's included)."""
    return _value(_scrape(base), "tpumlops_batch_size_count")


def _server_launches(report: Path) -> dict:
    """The kernel launches a server process counted, from the report it
    wrote as it exited."""
    return json.loads(report.read_text())["launches"]


def phase_control_plane_canary(fa, smi: str, device: str = "cuda") -> dict:
    """The port's control plane drives a canary on the card: two BERT-base
    native artifacts (phase 6's config and dtype, seeds 1 and 2), each
    served by its own process running the command of the operator's
    ``backend: cuda`` manifest (``python -m <port>.server``), the port's
    native router (``native/router.cc``) splitting open-loop V2 traffic
    (B1, S128, ``CANARY_RATE`` a second), and the port's ``OperatorRuntime``
    on a ``SystemClock`` over the fakes (``SyncingKube``), its judge reading
    the router's histograms (``CANARY_SPEC``'s gate).  v1 is served until ``Stable``; then the alias
    moves to v2, which is promoted in 10% steps to 100% with v1's predictor
    deleted.  Fails unless the CR is ``Stable`` on v2 at weight 100 with v1
    gone, every server's flash launches are 12 x its batches with the
    traffic's batches among them, and v2's logits for a fixed batch are
    within ``BERT_TOL`` of the plain-attention forward."""
    import numpy as np
    import torch
    from importlib import import_module

    t_phase = time.perf_counter()
    bert = import_module(f"{PKG}.models.bert")
    loader = import_module(f"{PKG}.server.loader")
    lp = import_module(f"{PKG}.clients.localplane")
    rmod = import_module(f"{PKG}.clients.router")
    base = import_module(f"{PKG}.clients.base")
    fakes = import_module(f"{PKG}.clients.fakes")
    builder = import_module(f"{PKG}.operator.builder")
    runtime = import_module(f"{PKG}.operator.runtime")
    clock = import_module(f"{PKG}.utils.clock")
    config = import_module(f"{PKG}.utils.config")
    tag = "control-plane canary"
    spec = json.loads(json.dumps(CANARY_SPEC))
    op_config = config.OperatorConfig.from_spec(spec)
    cfg = bert.BertConfig.base()
    bert_config = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "hidden_act"}
    scratch = ROOT / "build"  # ignored by git
    scratch.mkdir(exist_ok=True)
    procs: dict = {}
    router = rt = None
    res: dict = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        try:
            uris, ports, bases = {}, {}, {}
            t0 = time.perf_counter()
            for seed in (1, 2):
                params = bert.init(torch.Generator(device=device).manual_seed(seed), cfg,
                                   dtype=torch.bfloat16, device=device)
                uris[f"v{seed}"] = str(loader.save_native_model(
                    Path(tmp) / f"bert-base-v{seed}", "bert-classifier", params,
                    config=bert_config, builder_kwargs={"seq_len": CANARY_SEQ}))
                del params
            res["artifacts_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            OUT_DIR.mkdir(exist_ok=True)
            for pred, uri in uris.items():
                ports[pred] = lp.free_port()
                bases[pred] = f"http://127.0.0.1:{ports[pred]}"
                argv = _pod_argv(builder, op_config, pred[1:], uri, ports[pred], device)
                log_f = open(OUT_DIR / f"canary_{pred}.log", "w")
                procs[pred] = (subprocess.Popen(
                    argv, cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT,
                    env={**os.environ, "TPUMLOPS_RANK_REPORT_DIR": f"{tmp}/report_{pred}"}),
                    log_f)
            for pred, (proc, log_f) in procs.items():
                deadline = time.perf_counter() + 120
                while True:
                    if proc.poll() is not None:
                        raise AssertionError(f"{tag}: the {pred} server exited {proc.returncode}"
                                             f" (its log: {log_f.name})")
                    try:
                        urllib.request.urlopen(bases[pred] + "/v2/health/ready", timeout=1)
                        break
                    except Exception:
                        if time.perf_counter() > deadline:
                            raise AssertionError(f"{tag}: the {pred} server never became ready")
                        time.sleep(0.1)
            res["servers_s"] = time.perf_counter() - t0
            boot_batches = {pred: _batches(b) for pred, b in bases.items()}
            if "thread" in _ROUTER_BUILD:
                _ROUTER_BUILD["thread"].join()
                if "error" in _ROUTER_BUILD:
                    raise _ROUTER_BUILD["error"]
            binary = rmod.build_router()
            res["router_build_s"] = _ROUTER_BUILD.get("s")
            if binary.parent != ROOT / "build" / "native":
                raise AssertionError(f"{tag}: the router was built at {binary}")
            router = rmod.RouterProcess(port=lp.free_port(), backends={},
                                        namespace="models", binary=binary).start()
            sync = rmod.RouterSync(router.admin, lambda pred: ("127.0.0.1", ports[pred]))
            kube = lp.SyncingKube(sync)
            registry = fakes.FakeRegistry()
            for pred, uri in uris.items():
                registry.register("bert-base", pred[1:], uri)
            registry.set_alias("bert-base", "prod", "1")
            journal = _Journal()
            rng = np.random.default_rng(9)
            ids = rng.integers(1, cfg.vocab_size, (1, CANARY_SEQ)).astype(np.int32)
            warmed: dict = {}

            def warmup(deployment, predictor, namespace, n, model=None):
                for _ in range(n):
                    _post(f"{bases[predictor]}/v2/models/{model}/infer", _v2_ids(ids))
                warmed[predictor] = warmed.get(predictor, 0) + n

            rt = runtime.OperatorRuntime(kube, registry,
                                         metrics=rmod.RouterMetricsSource(router.admin),
                                         clock=clock.SystemClock(), sync_interval_s=0.05,
                                         recorder=journal, warmup=warmup)
            ref = base.ObjectRef(namespace="models", name="bert-base", **base.MLFLOWMODEL)
            sd_ref = base.ObjectRef(namespace="models", name="bert-base",
                                    **base.SELDONDEPLOYMENT)

            def status():
                return kube.get(ref).get("status") or {}

            # The router's histograms, scraped while both versions serve:
            # a version's series leave the router with its predictor.
            scraped: dict = {}

            def scrape():
                parsed = rmod.parse_prometheus_text(router.admin.metrics_text())
                for (name, labels), v in parsed.items():
                    lab = dict(labels)
                    if name == "seldon_api_executor_client_requests_seconds_bucket":
                        scraped.setdefault(lab.get("predictor_name"), {})[float(lab["le"])] = v

            def wait(pred, what, limit):
                deadline = time.perf_counter() + limit
                t_scrape = 0.0
                while not pred():
                    if time.perf_counter() - t_scrape > 0.25:
                        scrape()
                        t_scrape = time.perf_counter()
                    if time.perf_counter() > deadline:
                        raise AssertionError(f"{tag}: timed out waiting for {what}; status "
                                             f"{json.dumps(status(), default=str)[:600]}")
                    time.sleep(0.02)

            kube.create(ref, {"spec": spec})
            threading.Thread(target=rt.serve, daemon=True, name="operator").start()
            wait(lambda: status().get("phase") == "Stable", "v1 Stable", 20)
            if router.admin.get_weights() != {"v1": 100}:
                raise AssertionError(f"{tag}: weights at v1 Stable {router.admin.get_weights()}")
            body = json.dumps(_v2_ids(ids)).encode()
            url = f"http://127.0.0.1:{router.port}/v2/models/bert-base/infer"
            traffic = {"sent": 0, "ok": 0, "non_2xx": 0, "lock": threading.Lock()}
            stop = threading.Event()
            gen = threading.Thread(target=_paced_traffic, daemon=True,
                                   args=(url, body, CANARY_RATE, stop, traffic))
            gen.start()
            try:
                wait(lambda: traffic["ok"] >= 50, "baseline traffic on v1", 10)
                n_journal = len(journal.records)
                t_move = time.perf_counter()
                registry.set_alias("bert-base", "prod", "2")
                wait(lambda: status().get("phase") == "Stable"
                     and status().get("currentModelVersion") == "2", "v2 Stable at 100%",
                     CANARY_BUDGET_S)
                res["to_100_s"] = time.perf_counter() - t_move
            finally:
                stop.set()
                gen.join(timeout=30)
            weights = router.admin.get_weights()
            predictors = [p["name"] for p in kube.get(sd_ref)["spec"]["predictors"]]
            st = status()
            if (st.get("trafficCurrent") != 100 or weights != {"v2": 100}
                    or predictors != ["v2"] or st.get("previousModelVersion") is not None):
                raise AssertionError(f"{tag}: after the promotion status {st.get('phase')} "
                                     f"traffic {st.get('trafficCurrent')}, router weights "
                                     f"{weights}, predictors {predictors}")
            records = journal.records[n_journal:]
            gates = [r for r in records if hasattr(r, "margins")]
            steps = sorted({r.traffic_after for r in gates if r.promote})
            res.update(
                sent=traffic["sent"], ok=traffic["ok"], non_2xx=traffic["non_2xx"],
                warmup_requests=warmed,
                weights=weights, predictors=predictors, reasons=kube.event_reasons(),
                steps=steps,
                gates=[{"traffic_before": r.traffic_before, "traffic_after": r.traffic_after,
                        "attempt": r.attempt, "promote": r.promote, "reasons": list(r.reasons),
                        "margins": dict(r.margins), "new": dict(r.new_metrics),
                        "old": dict(r.old_metrics), "timings": dict(r.timings)}
                       for r in gates])
            for g in res["gates"]:
                new, old = g["new"], g["old"]

                def ms(m, k):
                    v = m.get(k)
                    return "-" if v is None else f"{1e3 * v:.2f}"

                log(f"{tag}: gate {g['traffic_before']} -> {g['traffic_after']}% attempt "
                    f"{g['attempt']}: {'promote' if g['promote'] else 'refuse'}; p95 new / "
                    f"old {ms(new, 'latency_95th')} / {ms(old, 'latency_95th')} ms, mean "
                    f"{ms(new, 'latency_avg')} / {ms(old, 'latency_avg')} ms, errors "
                    f"{new.get('error_rate')} / {old.get('error_rate')}, samples "
                    f"{new.get('request_count')} / {old.get('request_count')}; step wall "
                    f"{1e3 * sum(g['timings'].values()):.1f} ms (gate read "
                    f"{1e3 * g['timings'].get('gate_read', 0.0):.1f} ms)"
                    + ("" if g["promote"] else f"; {g['reasons']}"))
            if steps != list(range(20, 101, 10)):
                raise AssertionError(f"{tag}: the promoted steps {steps}, not 20..100 by 10")

            # p50 / p99 a version from the router's cumulative histograms
            # (v1's as last scraped before its predictor left).
            scrape()
            lat = {}
            for pred in ("v1", "v2"):
                b = sorted(scraped.get(pred, {}).items())
                lat[pred] = {"p50_ms": 1e3 * (rmod._histogram_quantile(0.5, b) or 0.0),
                             "p99_ms": 1e3 * (rmod._histogram_quantile(0.99, b) or 0.0),
                             "count": b[-1][1] if b else 0.0}
            res["latency"] = lat

            # v2's logits for a fixed batch through the router, against the
            # plain-attention forward of the same ids (phase 6's check).
            batch = rng.integers(1, cfg.vocab_size, (4, CANARY_SEQ)).astype(np.int32)
            out = _post(url, _v2_ids(batch))["outputs"][0]
            got = np.asarray(out["data"], np.float32).reshape(out["shape"])
            pred2 = loader.load_predictor(uris["v2"], device=device, dtype=torch.bfloat16)
            orig = bert.flash_attention
            bert.flash_attention = fa.flash_attention_reference
            try:
                want = pred2.predict(batch).float().cpu().numpy()
            finally:
                bert.flash_attention = orig
            del pred2
            tol = BERT_TOL["none"]
            err = np.abs(got - want)
            res["max_abs_err"] = float(err.max())
            if not np.isfinite(got).all() or (err > tol + tol * np.abs(want)).any():
                raise AssertionError(f"{tag}: v2's logits disagree with the plain path: "
                                     f"max_abs_err {res['max_abs_err']:.3e} (tol {tol})")

            # Each server's flash launches, from the report it writes as it
            # exits: 12 a batch, its warm-up's batches and the traffic's.
            batches = {pred: _batches(b) for pred, b in bases.items()}
            for proc, log_f in procs.values():
                proc.send_signal(signal.SIGTERM)
            res["launches"], res["batches"] = {}, {}
            for pred, (proc, log_f) in procs.items():
                if proc.wait(timeout=60) != 0:
                    raise AssertionError(f"{tag}: the {pred} server exited {proc.returncode}")
                launches = _server_launches(Path(tmp) / f"report_{pred}" / "rank-0.json")
                n = launches["flash_attention"]
                served = batches[pred] - boot_batches[pred]
                res["launches"][pred], res["batches"][pred] = n, (boot_batches[pred], served)
                if served <= 0 or n != cfg.num_layers * batches[pred]:
                    raise AssertionError(f"{tag}: the {pred} server launched flash {n} times "
                                         f"for {batches[pred]:.0f} batches ({served:.0f} served "
                                         f"in the phase); expected {cfg.num_layers} x")
        finally:
            if rt is not None:
                rt.stop()
            if router is not None:
                router.stop()
            for proc, log_f in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
                log_f.close()
            torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"{tag}: v1 -> v2 promoted to 100% in {res['to_100_s']:.2f} s after the alias move "
        f"(steps {res['steps']}, {len(res['gates'])} gate reads); router p50 / p99 v1 "
        f"{lat['v1']['p50_ms']:.2f} / {lat['v1']['p99_ms']:.2f} ms ({lat['v1']['count']:.0f}), "
        f"v2 {lat['v2']['p50_ms']:.2f} / {lat['v2']['p99_ms']:.2f} ms "
        f"({lat['v2']['count']:.0f}); {res['sent']} requests at {CANARY_RATE:.0f}/s, "
        f"{res['non_2xx']} not 2xx, warm-up requests {res['warmup_requests']}; flash launches by server {res['launches']} (= "
        f"{cfg.num_layers} x batches, warm-up and served: {res['batches']}); v2 logits "
        f"max_abs_err {res['max_abs_err']:.3e} (tol {BERT_TOL['none']}); v1's predictor gone, "
        f"weights {res['weights']}; artifacts {res['artifacts_s']:.1f} s, servers "
        f"{res['servers_s']:.1f} s, router build {res['router_build_s']} s; phase wall "
        f"{res['wall_s']:.1f} s on {smi}")
    if res["wall_s"] > CANARY_BUDGET_S:
        log(f"{tag}: WARNING phase wall {res['wall_s']:.1f} s over its "
            f"{CANARY_BUDGET_S:.0f} s share")
    DETAIL["control_plane_canary"] = res
    return res


# ---------------------------------------------------------------------------
# Phase 9b: the control plane's judgment on a shared warm pool
# ---------------------------------------------------------------------------

JUDGE_BUDGET_S = 100.0  # phase 9b's share of SMOKE_LIMIT_S
JUDGE_SEEDS = (11, 12, 13, 14)  # one artifact a seed, models mux0..mux3
JUDGE_NEW = 8  # greedy tokens a request
JUDGE_PROMPT = 24  # prompt tokens a request
JUDGE_SLOW_S = 0.35  # ChaosProxy's hold on each response of replica r1
JUDGE_REPLICAS = ("r0", "r1", "r2")
JUDGE_CLIENTS = 3  # concurrent clients of the straggler traffic
# The SLO every member CR declares: TTFT and ITL p99 from the pool's live
# series, 99% objective over 5 minutes (the phase is shorter: no sample
# leaves the window, so a recomputation sees every one).
JUDGE_SLO = {"ttftP99Ms": 2000, "itlP99Ms": 500, "availabilityPct": 99.0, "windowMinutes": 5}
JUDGE_OBJECTIVE = {"ttftP99Ms": 2000.0}
JUDGE_TRACE_RING = 256  # each pool server's flight recorder: the stitcher's replica tracks


def _judge_cuda(snapdir: Path) -> dict:
    return {"gpuTopology": "h100-1", "dtype": "float32",
            "snapshot": {"enabled": True, "dir": str(snapdir)},
            "observability": {"timeseriesRing": 64, "traceRing": JUDGE_TRACE_RING},
            "compileCacheDir": str(ROOT / "build" / "torch_kernels")}


def _judge_pool_spec(snapdir: Path) -> dict:
    """The spec whose warm-pool manifest the pool servers run."""
    return {"modelName": "pool", "modelAlias": "prod", "backend": "cuda",
            "cuda": _judge_cuda(snapdir),
            "autoscaling": {"enabled": True, "minReplicas": 1, "maxReplicas": 3,
                            "targetQueueDepthPerReplica": 2,
                            "warmPoolSize": len(JUDGE_REPLICAS)}}


def _judge_spec(name: str, arts: Path, snapdir: Path) -> dict:
    return {"modelName": name, "modelAlias": "prod", "backend": "cuda",
            "artifactRoot": str(arts), "monitoringInterval": 0.3,
            "cuda": _judge_cuda(snapdir), "observability": {"historyLimit": 64},
            "multiplex": {"poolRef": "shared"}, "slo": dict(JUDGE_SLO),
            "anomaly": {"driftPct": 0, "windowSeconds": 5, "baselineSeconds": 5}}


def _pool_argv(builder, config, uri: str, port: int, device: str) -> list[str]:
    """The command of the operator's warm-pool manifest (``--warm-pool 1``)
    for ``config``, on a local port."""
    (dep,) = builder.build_warm_pool_manifests(
        name="pool", namespace="models", owner_uid="smoke", config=config, version="1",
        model_uri=uri)
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    if "--warm-pool" not in c["args"] or c["resources"]["limits"] != {"nvidia.com/gpu": "1"}:
        raise AssertionError(f"9b: the pool pod runs {c['args']} with {c['resources']}")
    return ([sys.executable] + c["command"][1:] + c["args"]
            + ["--host", "127.0.0.1", "--port", str(port), "--metrics-port", "0",
               "--drain-s", "0", "--device", device])


def _judge_generate(port: int, model: str, prompt: list, timeout: float = 300) -> tuple:
    """(status, body, seconds) of one /generate through the router."""
    t0 = time.perf_counter()
    code, body, _ = _call("POST", f"http://127.0.0.1:{port}/v2/models/{model}/generate",
                          {"prompt_ids": prompt, "max_new_tokens": JUDGE_NEW}, timeout=timeout)
    return code, body, time.perf_counter() - t0


def _judge_references(app, loader, metrics_mod, uris: dict, argv: list, prompts: dict,
                      device: str) -> dict:
    """Each model's greedy tokens from a direct one-process engine in f32,
    on the pool servers' own options."""
    import torch

    args = argv[argv.index("-m") + 2:]
    i = args.index("--warm-pool")
    del args[i:i + 2]
    out = {}
    for name, uri in uris.items():
        args[args.index("--model-uri") + 1] = uri
        conf = app.config_from_args(app.build_arg_parser().parse_args(args))
        pred = loader.load_predictor(uri, device=device, dtype=torch.float32)
        engine = app.make_gen_engine(pred, conf, metrics_mod.ServerMetrics("smoke", "v1", "smoke"))
        engine.start()
        try:
            out[name] = {k: engine.generate(p, JUDGE_NEW, timeout=600).tolist()
                         for k, p in prompts[name].items()}
        finally:
            engine.shutdown()
        del pred, engine
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _slo_recomputed(slo_mod, rec, name: str, tracker, spec) -> list:
    """Every SloRecord of ``name`` against a fresh ``SloTracker`` fed the
    live tracker's samples up to the record's wall: (slo, field, journaled,
    recomputed) where they differ."""
    bad = []
    for r in rec:
        samples = [s for s in tracker._windows.get(r["slo"], ()) if s.wall <= r["ts"]]
        fresh = slo_mod.SloTracker()
        for s in samples:
            fresh.observe(r["slo"], s.wall, s.good, s.observed)
        ev = fresh.evaluate(r["slo"], r["ts"], spec.window_minutes * 60.0,
                            spec.availability_pct, slo_mod.target_of(spec, r["slo"]))
        for field, want in (("attainment", ev.attainment), ("burnRate", ev.burn_rate),
                            ("budgetRemaining", ev.budget_remaining), ("samples", ev.samples)):
            if r[field] != want:
                bad.append((name, r["slo"], field, r[field], want))
    return bad


def _judge_clis(trace: dict, router_port: int, ports: dict, scratch: Path, planner, jt,
                peaks) -> dict:
    """Phase 9b's repo-root CLIs on the live fleet: ``scripts/plan.py`` on
    the router's journey export written to a file, byte for byte the
    planner's plan of the same trace (the CLI's ``--expect``); and
    ``scripts/stitch_trace.py`` against the router and the three replicas,
    whose output must be Chrome trace JSON with one process track each and
    request ids of the router's journey export on the router's track and on
    a replica's."""
    from importlib import import_module

    plan_cli = import_module(f"{PKG}.scripts.plan")
    stitch_cli = import_module(f"{PKG}.scripts.stitch_trace")
    stitch_mod = import_module(f"{PKG}.utils.trace_stitch")
    tag = "9b CLIs"
    t0 = time.perf_counter()
    trace_file, expect_file = scratch / "journeys.json", scratch / "plan.json"
    trace_file.write_text(json.dumps(trace))
    ms = JUDGE_OBJECTIVE["ttftP99Ms"]
    want = planner.plan(jt.load_journey_trace(trace), JUDGE_OBJECTIVE, peaks=peaks,
                        chips_available=1)
    expect_file.write_text(json.dumps(want, indent=1, sort_keys=True) + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = plan_cli.main(["--trace", str(trace_file), "--objective-ttft-p99-ms", str(ms),
                              "--chips", "1", "--dry-run", "--expect", str(expect_file)])
    if code != 0 or json.loads(buf.getvalue()) != want:
        raise AssertionError(f"{tag}: plan exited {code} on the journey export")
    out_file = scratch / "fleet_trace.json"
    code = stitch_cli.main(["--router", f"http://127.0.0.1:{router_port}", "-o", str(out_file)]
                           + [a for r in JUDGE_REPLICAS
                              for a in ("--replica", f"http://127.0.0.1:{ports[r]}")])
    doc = json.loads(out_file.read_text())
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if code != 0 or not isinstance(events, list) or not all(
            isinstance(e, dict) and {"ph", "pid"} <= set(e) for e in events):
        raise AssertionError(f"{tag}: stitch_trace exited {code} or wrote no Chrome trace")
    names = {e["pid"]: e["args"]["name"] for e in events
             if e["ph"] == "M" and e.get("name") == "process_name"}
    if sorted(names.values()) != ["replica-0", "replica-1", "replica-2", "router"]:
        raise AssertionError(f"{tag}: the stitched tracks are {names}")
    ids = stitch_mod.request_ids_by_pid(doc)
    exported = {str(r["request_id"]) for r in trace.get("requests") or []}
    router_pid = next(p for p, n in names.items() if n == "router")
    on_router = ids.get(router_pid, set()) & exported
    shared = {p: len(on_router & v) for p, v in ids.items() if p != router_pid}
    if not on_router or not any(shared.values()):
        raise AssertionError(f"{tag}: no request id of the journey export on the router's "
                             f"track and a replica's ({len(on_router)} on the router's, "
                             f"{shared} shared)")
    out = {"plan_knobs": want["knobs"], "trace_events": len(events),
           "router_ids": len(on_router), "shared_ids_by_replica_pid": shared,
           "wall_s": time.perf_counter() - t0}
    log(f"{tag}: plan on the {len(trace.get('requests') or [])}-journey export equal to the "
        f"planner's; stitch_trace {len(events)} events on 4 tracks, {len(on_router)} "
        f"exported request ids on the router's, shared with the replicas' {shared}; "
        f"{out['wall_s']:.2f} s")
    return out


def phase_control_plane_judgment(smi: str, device: str = "cuda", cfg=None) -> dict:
    """The rest of the port's operator on the card: four Llama models
    (Llama-2-7B's widths at ``MESH_LAYERS`` layers unless ``cfg`` is given;
    bf16 artifacts of seeds 11-14, served f32) share three ``--warm-pool 1``
    servers (the operator's warm-pool manifest's command, one snapshot dir,
    a timeseries ring each) behind the port's router in model-multiplexing
    mode, r1's leg through a ``ChaosProxy`` holding each response
    ``JUDGE_SLOW_S``.  Four ``MlflowModel`` CRs (``backend: cuda``,
    ``h100-1``, ``spec.multiplex`` on pool ``shared``, ``spec.slo``,
    ``spec.anomaly``) run in the port's ``OperatorRuntime`` on a
    ``SystemClock`` with the pool's ``Multiplexer``, ``PoolMetrics``, the
    rings and ``OperatorTelemetry``.  Fails unless: (1) requests to mux0-2
    park until the packer attaches each, then answer 200 with the direct f32
    engine's tokens; (2) the observatory names r1 from the router's leg
    series, ``status.anomalies`` carries it and the Multiplexer holds r1 as
    a straggler; (3) a request to mux3 makes the packer replace an
    attachment, journaled as ``kind: "mux"`` in mux3's history, and answers
    the direct engine's tokens; (4) every CR's SloRecords agree with
    ``SloTracker`` recomputed from the samples, and the telemetry exports
    ``tpumlops_operator_slo_*``; (5) ``spec.planner`` (suggest) on mux3 with
    the router's journey export journals the plan a re-plan with
    ``detect_peaks()`` gives; (6) each replica launched RMSNorm, flash and
    decode attention (on the card); (7) ``python -m <port>.operator
    --leader-elect`` against the port's ``EnvtestServer`` takes its Lease,
    serves ``/metrics`` and exits 0 within 10 s of SIGTERM."""
    import numpy as np
    import torch
    from importlib import import_module

    t_phase = time.perf_counter()
    llama = import_module(f"{PKG}.models.llama")
    loader = import_module(f"{PKG}.server.loader")
    app = import_module(f"{PKG}.server.app")
    metrics_mod = import_module(f"{PKG}.server.metrics")
    lp = import_module(f"{PKG}.clients.localplane")
    rmod = import_module(f"{PKG}.clients.router")
    base = import_module(f"{PKG}.clients.base")
    fakes = import_module(f"{PKG}.clients.fakes")
    chaos_mod = import_module(f"{PKG}.clients.chaos")
    envtest = import_module(f"{PKG}.clients.envtest")
    kube_rest = import_module(f"{PKG}.clients.kube_rest")
    builder = import_module(f"{PKG}.operator.builder")
    runtime = import_module(f"{PKG}.operator.runtime")
    mux_mod = import_module(f"{PKG}.operator.multiplexer")
    anomaly = import_module(f"{PKG}.operator.anomaly")
    slo_mod = import_module(f"{PKG}.operator.slo")
    planner = import_module(f"{PKG}.operator.planner")
    telemetry_mod = import_module(f"{PKG}.operator.telemetry")
    leader = import_module(f"{PKG}.operator.leader")
    clock = import_module(f"{PKG}.utils.clock")
    config = import_module(f"{PKG}.utils.config")
    jt = import_module(f"{PKG}.utils.journey_trace")
    dtel = import_module(f"{PKG}.server.device_telemetry")
    tag = "9b judgment"
    cfg = cfg or llama.LlamaConfig.llama2_7b(num_layers=MESH_LAYERS)
    V = cfg.vocab_size
    scratch = ROOT / "build" / "smoke_judge"  # ignored by git, deleted after
    shutil.rmtree(scratch, ignore_errors=True)
    arts, snapdir = scratch / "arts", scratch / "snaps"
    names = [f"mux{i}" for i in range(len(JUDGE_SEEDS))]
    OUT_DIR.mkdir(exist_ok=True)
    res: dict = {"walls": {}}
    procs: dict = {}
    env_srv = op_proc = router = chaos = sync = rt = None
    stop_traffic = threading.Event()
    try:
        # (7) first: the operator process boots beside everything else.
        env_srv = envtest.EnvtestServer().start()
        mport = _free_port()
        op_log = open(OUT_DIR / "judge_operator.log", "w")
        op_proc = (subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.operator", "--kube-url", env_srv.url,
             "--leader-elect", "--metrics-port", str(mport), "--namespace", "models",
             "--log-level", "WARNING"], cwd=ROOT, stdout=op_log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT),
                 "MLFLOW_TRACKING_URI": "http://127.0.0.1:9"}), op_log)

        t0 = time.perf_counter()
        uris = {}
        for name, seed in zip(names, JUDGE_SEEDS):
            params = llama.init(torch.Generator(device=device).manual_seed(seed), cfg,
                                dtype=torch.bfloat16, device=device)
            uris[name] = str(loader.save_native_model(arts / name, "llama-generate", params,
                                                      config=dataclasses.asdict(cfg)))
            del params
            if name == names[0]:
                # The pool boots on mux0's geometry while the rest are written.
                pool_config = config.OperatorConfig.from_spec(_judge_pool_spec(snapdir))
                ports = {r: _free_port() for r in JUDGE_REPLICAS}
                t_boot = time.perf_counter()
                for r in JUDGE_REPLICAS:
                    argv = _pool_argv(builder, pool_config, uris[name], ports[r], device)
                    log_f = open(OUT_DIR / f"judge_{r}.log", "w")
                    procs[r] = (subprocess.Popen(
                        argv, cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT,
                        env={**os.environ, "PYTHONPATH": str(ROOT),
                             "TPUMLOPS_RANK_REPORT_DIR": str(scratch / f"report_{r}")}), log_f)
        if device == "cuda":
            torch.cuda.empty_cache()
        res["walls"]["artifacts_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(21)
        prompts = {n: {"wake": [int(t) for t in rng.integers(3, V, JUDGE_PROMPT)]}
                   for n in names}
        t0 = time.perf_counter()
        refs = _judge_references(app, loader, metrics_mod, uris, argv, prompts, device)
        res["walls"]["references_s"] = time.perf_counter() - t0
        for r, (proc, log_f) in procs.items():
            deadline = time.perf_counter() + 180
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"{tag}: pool server {r} exited {proc.returncode} "
                                         f"(its log: {log_f.name})")
                try:
                    code, body, _ = _call("GET", f"http://127.0.0.1:{ports[r]}/readyz",
                                          timeout=2)
                except (urllib.error.URLError, OSError):
                    code = body = None
                if code == 503 and isinstance(body, dict) and body.get("lifecycle") == "warm-pool":
                    break
                if time.perf_counter() > deadline:
                    raise AssertionError(f"{tag}: pool server {r} never reached the warm pool")
                time.sleep(0.1)
        res["walls"]["pool_boot_s"] = time.perf_counter() - t_boot

        if "thread" in _ROUTER_BUILD:
            _ROUTER_BUILD["thread"].join()
            if "error" in _ROUTER_BUILD:
                raise _ROUTER_BUILD["error"]
        chaos = chaos_mod.ChaosProxy(ports["r1"])
        # Every response r1 relays is held: the router pools its upstream
        # connections, so a hold of each connection's first response only
        # would slow a handful of r1's legs.
        chaos.inject_slow(JUDGE_SLOW_S, times=10**6, each_response=True)
        legs = {r: ("127.0.0.1", chaos.port if r == "r1" else ports[r]) for r in JUDGE_REPLICAS}
        router = rmod.RouterProcess(
            port=_free_port(), backends={r: (h, p, 50) for r, (h, p) in legs.items()},
            namespace="models", deployment="pool", binary=rmod.build_router(),
            park_buffer=16, park_timeout_s=300.0, mux_models=1, journey_ring=256,
            timeseries_ring=64).start()
        attach_walls: list = []

        def timed_attach(replica, uri, replace=False, wake_start_wall=None):
            t = time.perf_counter()
            out = mux_mod.http_attach(replica, uri, replace=replace,
                                      wake_start_wall=wake_start_wall, timeout_s=600.0)
            attach_walls.append({"replica": replica.name, "model": uri_to_name.get(uri),
                                 "replace": replace, "s": time.perf_counter() - t,
                                 "restored": out.get("restored")})
            return out

        uri_to_name = {u: n for n, u in uris.items()}
        mux = mux_mod.Multiplexer(
            "shared", [mux_mod.MuxReplica(r, url=f"http://127.0.0.1:{ports[r]}")
                       for r in JUDGE_REPLICAS],
            attach=timed_attach, parked=lambda: router.admin.parked().get("models") or {})
        sync = lp.MuxRouterSync(router.admin, mux, legs, uri_to_name.get, "models",
                                "pool").start()
        sources = [{"name": r, "base_url": f"http://127.0.0.1:{ports[r]}"}
                   for r in JUDGE_REPLICAS]
        sources.append({"name": "router", "kind": "router",
                        "base_url": f"http://127.0.0.1:{router.port}"})

        def holders(name):
            return [ports[r.name] for r in mux.replicas
                    if r.attached_uri and r.attached_uri == uris.get(name)]

        kube = fakes.FakeKube()
        registry = fakes.FakeRegistry()
        for n, u in uris.items():
            registry.register(n, "1", u)
            registry.set_alias(n, "prod", "1")
        telemetry = telemetry_mod.OperatorTelemetry()
        rt = runtime.OperatorRuntime(
            kube, registry, metrics=lp.PoolMetrics(holders, rmod.RouterMetricsSource(router.admin)),
            clock=clock.SystemClock(), sync_interval_s=0.05, telemetry=telemetry,
            mux_pools={"shared": mux}, ring_sources=anomaly.ring_sources_from(sources))

        def ref(n):
            return base.ObjectRef(namespace="models", name=n, **base.MLFLOWMODEL)

        def status(n):
            return kube.get(ref(n)).get("status") or {}

        def wait(pred, what, limit):
            deadline = time.perf_counter() + limit
            while not pred():
                if time.perf_counter() > deadline:
                    raise AssertionError(f"{tag}: timed out waiting for {what}; statuses "
                                         + json.dumps({n: {k: status(n).get(k) for k in (
                                             "phase", "multiplex", "anomalies", "error")}
                                             for n in names}, default=str)[:1500])
                time.sleep(0.05)

        for n in names:
            kube.create(ref(n), {"spec": _judge_spec(n, arts, snapdir)})
        threading.Thread(target=rt.serve, daemon=True, name="operator").start()
        wait(lambda: all(status(n).get("phase") == "Stable"
                         and (status(n).get("multiplex") or {}).get("pool") == "shared"
                         for n in names), "four members Stable on the pool", 30)

        # (1) cold wake: mux0-2 park until the packer attaches each.
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as ex:
            futs = {n: ex.submit(_judge_generate, router.port, n, prompts[n]["wake"])
                    for n in names[:3]}
            wait(lambda: sum((router.admin.parked().get("models") or {}).values()) >= 1
                 or all(f.done() for f in futs.values()), "a parked request", 30)
            woken = {n: f.result(timeout=600) for n, f in futs.items()}
        res["walls"]["wake_s"] = time.perf_counter() - t0
        res["park_to_200_s"] = {n: w[2] for n, w in woken.items()}
        for n, (code, body, _) in woken.items():
            if code != 200:
                raise AssertionError(f"{tag}: {n}'s parked request answered {code}: {body}")
            got = _check_outputs(body, [JUDGE_NEW], V)[0]
            if got != refs[n]["wake"]:
                raise AssertionError(f"{tag}: {n}'s tokens {got} differ from its direct f32 "
                                     f"engine's {refs[n]['wake']}")
        held = {r.name: uri_to_name.get(r.attached_uri) for r in mux.replicas}
        if sorted(v for v in held.values() if v) != names[:3]:
            raise AssertionError(f"{tag}: after the wake the pool holds {held}")
        if "MuxAttached" not in kube.event_reasons():
            raise AssertionError(f"{tag}: no MuxAttached event")

        # (2) the straggler: traffic on mux0-2 until the verdict names r1.
        sent = {"ok": 0, "bad": 0}

        def client(i):
            k = i
            while not stop_traffic.is_set():
                n = names[k % 3]
                k += 1
                code, _, _ = _judge_generate(router.port, n, prompts[n]["wake"], timeout=120)
                sent["ok" if code == 200 else "bad"] += 1

        t0 = time.perf_counter()
        pool = [threading.Thread(target=client, args=(i,), daemon=True)
                for i in range(JUDGE_CLIENTS)]
        for th in pool:
            th.start()

        def flagged(n):
            return [v for v in status(n).get("anomalies") or []
                    if v.get("replica") == "r1" and v.get("series", "").startswith("router_leg_")]

        seen: dict = {}

        def verdict_on_r1():
            # The verdicts that met the wait, kept: a later read may find
            # them expired once the traffic stops.
            now = {n: flagged(n) for n in names[:3]}
            if all(now.values()) and "r1" in mux._stragglers:
                seen.update(now)
            return bool(seen)

        try:
            wait(verdict_on_r1, "the verdict on r1", 90)
        finally:
            stop_traffic.set()
            for th in pool:
                th.join(timeout=150)
        res["walls"]["verdict_s"] = time.perf_counter() - t0
        res["straggler_traffic"] = dict(sent)
        verdicts = seen[names[0]]
        res["verdict"] = verdicts
        res["anomaly_z"] = max(abs(v["z"]) for v in verdicts)
        others = sorted({v["replica"] for n in names for v in status(n).get("anomalies") or []}
                        - {"r1"})
        res["other_flagged"] = others
        if sent["bad"]:
            raise AssertionError(f"{tag}: {sent['bad']} straggler-traffic requests failed")

        # (3) mux3 alone: the packer replaces one attachment.
        t0 = time.perf_counter()
        code, body, secs = _judge_generate(router.port, names[3], prompts[names[3]]["wake"])
        res["walls"]["replace_s"] = time.perf_counter() - t0
        res["park_to_200_s"][names[3]] = secs
        if code != 200:
            raise AssertionError(f"{tag}: mux3's request answered {code}: {body}")
        got = _check_outputs(body, [JUDGE_NEW], V)[0]
        if got != refs[names[3]]["wake"]:
            raise AssertionError(f"{tag}: mux3's tokens {got} differ from its direct f32 "
                                 f"engine's {refs[names[3]]['wake']}")
        wait(lambda: any(h.get("kind") == "mux" and h.get("action") == "replace"
                         for h in status(names[3]).get("history") or []),
             "mux3's replace record", 15)
        replace = [h for h in status(names[3])["history"]
                   if h.get("kind") == "mux" and h.get("action") == "replace"][0]
        res["replace"] = {k: replace.get(k) for k in ("replica", "displaced", "parked",
                                                       "snapshotHash")}
        if replace["replica"] == "r1" or not replace.get("snapshotHash"):
            raise AssertionError(f"{tag}: the replace {replace} went to the straggler "
                                 "or echoed no snapshot hash")

        # (5) the planner, suggest mode, on the router's journey export.
        trace = router.admin.journeys()
        spec3 = kube.get(ref(names[3]))["spec"]
        profile = {"num_layers": cfg.num_layers, "hidden_size": cfg.hidden_size,
                   "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
                   "head_dim": cfg.head_dim, "intermediate_size": cfg.intermediate_size,
                   "vocab_size": cfg.vocab_size}
        spec3["planner"] = {"enabled": True, "applyMode": "suggest",
                            "objective": dict(JUDGE_OBJECTIVE), "trace": trace,
                            "model": profile}
        obj3 = kube.get(ref(names[3]))
        obj3["spec"] = spec3
        kube.replace(ref(names[3]), obj3)
        wait(lambda: status(names[3]).get("plan") is not None
             and any(h.get("kind") == "plan" for h in status(names[3]).get("history") or []),
             "mux3's plan", 20)
        peaks = dtel.detect_peaks()
        if device == "cuda" and (peaks.kind != "nvidia-h100" or peaks.source != "detected"):
            raise AssertionError(f"{tag}: detect_peaks() on the card gave {peaks}")
        replan = planner.plan(jt.load_journey_trace(trace), JUDGE_OBJECTIVE,
                              profile=planner.ModelProfile.from_spec(profile), peaks=peaks,
                              chips_available=config.GPU_TOPOLOGIES["h100-1"].cards)
        plan = status(names[3])["plan"]
        if plan != replan:
            raise AssertionError(f"{tag}: status.plan {plan} differs from the re-plan {replan}")
        plan_rec = [h for h in status(names[3])["history"] if h.get("kind") == "plan"][-1]
        if plan_rec["applyMode"] != "suggest" or plan_rec["knobs"] != plan["knobs"]:
            raise AssertionError(f"{tag}: the plan record {plan_rec} is not the plan's")
        ttft = lp.PoolMetrics(lambda _: [ports[r] for r in JUDGE_REPLICAS]).engine_metrics(
            "pool", "v1", "models", slo_tails=True).ttft_p99_s
        res["plan"] = {"knobs": plan["knobs"], "predicted_ttft_p99_ms":
                       plan["predicted"]["ttftP99Ms"], "requests": plan["trace"]["requests"],
                       "measured_ttft_p99_ms": None if ttft is None else 1e3 * ttft,
                       "peaks": {"kind": peaks.kind, "source": peaks.source}}
        res["clis"] = _judge_clis(trace, router.port, ports, scratch, planner, jt, peaks)

        # (4) SLO records against a recomputation from the same samples.
        text = telemetry.exposition().decode()
        res["slo"] = {}
        for n in names:
            rec = rt._entries[("models", n)].reconciler
            spec = config.OperatorConfig.from_spec(kube.get(ref(n))["spec"]).slo
            recs = [h for h in status(n).get("history") or [] if h.get("kind") == "slo"]
            kinds = {r["slo"] for r in recs}
            if not {"ttft_p99", "itl_p99"} <= kinds:
                raise AssertionError(f"{tag}: {n}'s SLO records cover {sorted(kinds)}")
            bad = _slo_recomputed(slo_mod, recs, n, rec._slo_tracker, spec)
            if bad:
                raise AssertionError(f"{tag}: SLO records disagree with SloTracker: {bad[:4]}")
            for r in recs:
                if r["slo"] in ("ttft_p99", "itl_p99") and (r["observed"] is None
                                                           or r["samples"] < 1):
                    raise AssertionError(f"{tag}: {n}'s {r['slo']} record {r} has no sample")
            res["slo"][n] = {s: len(rec._slo_tracker._windows.get(s, ()))
                             for s in ("ttft_p99", "itl_p99", "availability")}
            for fam in ("tpumlops_operator_slo_attainment", "tpumlops_operator_slo_burn_rate",
                        "tpumlops_operator_slo_error_budget_remaining"):
                if f'name="{n}"' not in text or fam not in text:
                    raise AssertionError(f"{tag}: {fam} for {n} missing from the telemetry")
        for fam in ("tpumlops_operator_mux_moves_total", "tpumlops_operator_anomaly_active"):
            if fam not in text:
                raise AssertionError(f"{tag}: {fam} missing from the telemetry")
        res["attach"] = attach_walls
        res["mux_moves"] = mux.moves_total

        # (7) the operator process: its Lease, /metrics, SIGTERM.
        proc, _ = op_proc
        kube_rest_client = kube_rest.KubeRestClient(env_srv.url)
        lease_ref = base.ObjectRef(namespace="tpumlops-system", name="tpumlops-operator",
                                   **leader.LEASE)
        deadline = time.perf_counter() + 30
        lease = op_text = None
        while lease is None or op_text is None:
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"{tag}: the operator process (exit {proc.poll()}) took "
                                     f"no Lease or served no /metrics; lease {lease}")
            try:
                lease = kube_rest_client.get(lease_ref)
                if not lease["spec"].get("holderIdentity"):
                    lease = None
                op_text = _call("GET", f"http://127.0.0.1:{mport}/metrics", timeout=2)[1]
            except Exception:
                time.sleep(0.1)
        for fam in ("tpumlops_operator_reconcile_total", "tpumlops_operator_slo_attainment",
                    "tpumlops_operator_mux_moves_total", "tpumlops_operator_resources"):
            if f"# TYPE {fam}" not in op_text:
                raise AssertionError(f"{tag}: the operator process's /metrics lacks {fam}")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        res["operator_exit_s"] = time.perf_counter() - t0
        if rc != 0 or res["operator_exit_s"] > 10.0:
            raise AssertionError(f"{tag}: the operator process exited {rc} "
                                 f"{res['operator_exit_s']:.2f} s after SIGTERM")
        res["lease_holder"] = lease["spec"]["holderIdentity"]

        # (6) each replica's launches, from the report it writes as it exits.
        rt.stop()
        rt = None
        for proc, _ in procs.values():
            proc.send_signal(signal.SIGTERM)
        res["launches"] = {}
        for r, (proc, _) in procs.items():
            if proc.wait(timeout=60) != 0:
                raise AssertionError(f"{tag}: pool server {r} exited {proc.returncode}")
            launches = _server_launches(scratch / f"report_{r}" / "rank-0.json")
            res["launches"][r] = {k: launches[k] for k in ("rmsnorm", "flash_attention",
                                                           "decode_attention")}
            if device == "cuda" and min(res["launches"][r].values()) <= 0:
                raise AssertionError(f"{tag}: replica {r} launched {res['launches'][r]}")
    finally:
        stop_traffic.set()
        if rt is not None:
            rt.stop()
        if sync is not None:
            sync.stop()
        if router is not None:
            router.stop()
        if chaos is not None:
            chaos.stop()
        for proc, log_f in list(procs.values()) + ([op_proc] if op_proc else []):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log_f.close()
        if env_srv is not None:
            env_srv.stop()
        shutil.rmtree(scratch, ignore_errors=True)
        if device == "cuda":
            torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    att = ", ".join(f"{a['model']}->{a['replica']}{' (replace)' if a['replace'] else ''} "
                    f"{a['s']:.2f} s" for a in res["attach"])
    log(f"{tag}: attaches {att}; park to 200 "
        f"{ {n: round(s, 2) for n, s in res['park_to_200_s'].items()} } s; the verdict on r1 "
        f"(|z| {res['anomaly_z']:.1f}, {res['straggler_traffic']['ok']} requests, "
        f"{res['walls']['verdict_s']:.1f} s; other replicas flagged {res['other_flagged']}); "
        f"mux3 replaced {res['replace']['displaced']} on {res['replace']['replica']}; SLO "
        f"samples {res['slo']}; plan {res['plan']['knobs']} predicts TTFT p99 "
        f"{res['plan']['predicted_ttft_p99_ms']:.3f} ms against a measured "
        f"{res['plan']['measured_ttft_p99_ms']} ms (the replicas' histograms) over "
        f"{res['plan']['requests']} journeys; launches {res['launches']}; operator process "
        f"exit {res['operator_exit_s']:.2f} s after SIGTERM; walls "
        f"{ {k: round(v, 1) for k, v in res['walls'].items()} }; phase wall "
        f"{res['wall_s']:.1f} s on {smi}")
    if res["wall_s"] > JUDGE_BUDGET_S:
        log(f"{tag}: WARNING phase wall {res['wall_s']:.1f} s over its "
            f"{JUDGE_BUDGET_S:.0f} s share")
    DETAIL["control_plane_judgment"] = res
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke: {PKG} not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from importlib import import_module

    faulthandler.dump_traceback_later(SMOKE_LIMIT_S, exit=True)
    # CUPTI set up once, at the first profile, and kept, as the port's
    # profile route keeps it: no teardown beside the graphs of later phases.
    import_module(f"{PKG}.utils.tracing").keep_cupti()
    t_start = time.perf_counter()
    smi = phase_device()
    start_router_build()  # g++ beside the kernels' nvcc; phase 9 joins it
    stage("2 build")
    phase_build()
    # Every port module, then the import check, before any profiler runs
    # (torch.profiler may import jax on its own where jax is installed).
    import pkgutil

    pkg = import_module(PKG)
    for m in pkgutil.walk_packages(pkg.__path__, PKG + "."):
        if not m.name.endswith("__main__"):
            import_module(m.name)
    for name in ("ops.ring_attention", "parallel.mesh", "parallel.sharding",
                 "parallel.collectives",
                 "parallel.distributed", "models.partition", "server.multihost",
                 "utils.config", "clients.router", "clients.localplane",
                 "operator.reconciler", "operator.runtime", "operator.multiplexer",
                 "operator.anomaly", "operator.slo", "operator.planner", "operator.telemetry",
                 "operator.leader", "clients.kube_rest", "clients.envtest", "clients.chaos",
                 "scripts.plan", "scripts.stitch_trace", "scripts.gen_7b_checkpoint",
                 "scripts.rehearse_7b_load", "scripts.rehearse_tp8_dryrun",
                 "scripts.check_metrics_catalog"):
        if f"{PKG}.{name}" not in sys.modules:
            raise AssertionError(f"the import check missed {PKG}.{name}")
    pulled = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "tpumlops", JAX_PKG))
    if pulled:
        raise AssertionError(f"the port pulled in {pulled[:5]}")
    # The port's three metric planes against the catalog, both directions.
    problems, families = import_module(f"{PKG}.scripts.check_metrics_catalog").check()
    if problems:
        raise AssertionError(f"the metrics catalog is out of sync: {problems[:5]}")
    log(f"metrics catalog: {families} families across the port's 3 planes, as documented")
    # Every graph keeps its nodes, which _replay_launches reads.
    import_module(f"{PKG}.server.cuda_graphs").KEEP_GRAPHS = True
    da = import_module(f"{PKG}.ops.decode_attention")
    rn = import_module(f"{PKG}.ops.rmsnorm")
    gen_mod = import_module(f"{PKG}.server.generation")
    buckets = gen_mod.decode_window_buckets(4096)
    fa = import_module(f"{PKG}.ops.flash_attention")
    stage("3 kernels")
    da_res = phase_decode_attention(da, buckets)
    da_res["dense"] = phase_decode_attention_dense(da, buckets)
    da_res["verify"] = phase_verify_attention(da)
    rn_res = phase_rmsnorm(rn)
    fa_res = phase_flash_attention(fa)
    lse_res = phase_flash_lse(fa)
    ragged_res = phase_flash_ragged(fa)
    dm = import_module(f"{PKG}.ops.dmajor_attention")
    stage("3b dmajor")
    dm_res = phase_dmajor_attention(dm, da)
    stage("4 loader subprocess")
    phase_loader_subprocess()
    # One draw of Llama-2-7B's weights serves all three quantize modes.
    llama = import_module(f"{PKG}.models.llama")
    quant = import_module(f"{PKG}.models.quantization")
    cfg7 = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg7,
                        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"7B: random bf16 weights drawn on the card in {time.perf_counter() - t0:.1f} s")
    stage("dense none")
    dense = {"none": phase_serve_7b_dense(da, rn, fa, smi, params, "none", None)}
    stage("5d packed none")
    packed_none = phase_serve_7b_packed_none(da, rn, fa, smi, params)
    ss = import_module(f"{PKG}.ops.sample_step")
    stage("sampled step kernels")
    ss_res = phase_sample_step(ss, import_module(f"{PKG}.models.prng"))
    stage("5e multistep none")
    multistep = {"none": phase_serve_7b_multistep(da, rn, fa, ss, smi, params, "none", None,
                                                  layers=MS_LAYERS)}
    stage("5f unified none")
    unified = {"none": phase_serve_7b_unified(da, rn, fa, ss, smi, params, "none",
                                              layers=INT8KV_LAYERS)}
    stage("5g preempt none")
    preempt = {"none": phase_serve_7b_preempt(da, rn, fa, ss, smi, params, "none",
                                              layers=INT8KV_LAYERS)}
    stage("5h observed")
    observed = phase_serve_7b_observed(da, rn, fa, ss, smi, params, multistep["none"],
                                       layers=MS_LAYERS)
    stage("5i handoff none")
    handoff = phase_serve_7b_handoff(da, rn, fa, smi, params)
    stage("5k 7B rehearsal: the write")
    written = phase_7b_write(params)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = quant.quantize_llama(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    quantize_peak = torch.cuda.max_memory_allocated() - held
    torch.cuda.empty_cache()
    log(f"7B: quantized to int8 on the card in {quantize_s:.2f} s (one layer's matrix at a "
        f"time; peak {quantize_peak / 2**30:.2f} GiB above the bf16 tree); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    stage("dense int8")
    dense["int8"] = phase_serve_7b_dense(da, rn, fa, smi, params, "int8", 256)
    stage("5 serve int8kv")
    serve = phase_serve_7b(da, rn, fa, smi, params)
    stage("5c spec")
    spec = phase_serve_7b_spec(da, rn, fa, smi, params)
    stage("5d packed int8kv")
    packed = phase_serve_7b_packed(da, rn, fa, smi, params, layers=INT8KV_LAYERS)
    stage("5e multistep int8kv")
    multistep["int8kv"] = phase_serve_7b_multistep(da, rn, fa, ss, smi, params, "int8kv", 256,
                                                   layers=MS_LAYERS)
    stage("5f unified int8kv")
    unified["int8kv"] = phase_serve_7b_unified(da, rn, fa, ss, smi, params, "int8kv",
                                               layers=INT8KV_LAYERS)
    stage("5g preempt int8kv")
    preempt["int8kv"] = phase_serve_7b_preempt(da, rn, fa, ss, smi, params, "int8kv",
                                               layers=INT8KV_LAYERS)
    stage("5j attach int8")
    attach = phase_serve_7b_attach(da, rn, fa, smi, params, quantize_s)
    stage("5k 7B rehearsal")
    rehearsal = phase_7b_rehearsal(da, rn, fa, smi, written, params)
    del params
    torch.cuda.empty_cache()
    stage("6 bert")
    bert = phase_serve_bert(fa)
    stage("7 v2 flavors")
    phase_serve_v2_flavors()
    stage("8 mesh")
    art = mesh_artifact()
    try:
        mesh = phase_serve_mesh(smi, art)
        stage("8b mesh sp")
        mesh_sp = phase_serve_mesh_sp(smi, art)
        stage("8c mesh v2 and warm pool")
        phase_serve_mesh_v2(smi, art, mesh)
        stage("8d mesh tp4 example")
        phase_serve_mesh_tp4(smi, art)
        stage("8e tp8 dry run")
        tp8 = phase_tp8_dryrun(smi, art)
    finally:
        shutil.rmtree(art.parent, ignore_errors=True)
    stage("9 control-plane canary")
    phase_control_plane_canary(fa, smi)
    stage("9b control-plane judgment")
    judge = phase_control_plane_judgment(smi)
    if any(m.split(".")[0] in ("tpumlops", JAX_PKG) for m in sys.modules):
        raise AssertionError("the JAX package was imported")
    # jax itself may arrive with torch.profiler's own imports where it is
    # installed; the port never imports it (checked above, before profiling).
    DETAIL["jax_loaded_after_profiling"] = "jax" in sys.modules

    jax_pkg = JAX_PKG
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": f"{PKG}/csrc/decode_attention.cu",
         "replaces": f"{jax_pkg}/ops/decode_attention.py:52",
         "also_replaces": f"{jax_pkg}/ops/decode_attention.py:173",
         "launches": (serve["da_launches"] + spec["da_launches"] + packed["da_launches"]
                      + packed_none["da_launches"]
                      + sum(r["da_launches"] for r in dense.values())
                      + sum(r["launches"]["da"] for r in multistep.values())
                      + sum(r["launches"]["da"] for r in unified.values())
                      + sum(r["launches"]["da"] for r in preempt.values())
                      + observed["launches"]["da"] + handoff["launches"]["da"]
                      + attach["launches"]["da"] + rehearsal["launches"]["da"]
                      + sum(r["decode_attention"] for r in judge["launches"].values())),
         # the verify chunk instance's share of them (phases 5c, 5f and 5g)
         "verify_launches": (spec["va_launches"]
                             + sum(r["launches"]["va"] for r in unified.values())
                             + sum(r["launches"]["va"] for r in preempt.values())),
         **da_res},
        {"name": "rmsnorm", "route": "cuda",
         "source": f"{PKG}/csrc/rmsnorm.cu",
         "replaces": f"{jax_pkg}/ops/rmsnorm.py:24",
         "launches": (serve["rn_launches"] + spec["rn_launches"] + packed["rn_launches"]
                      + packed_none["rn_launches"]
                      + sum(r["rn_launches"] for r in dense.values())
                      + sum(r["launches"]["rn"] for r in multistep.values())
                      + sum(r["launches"]["rn"] for r in unified.values())
                      + sum(r["launches"]["rn"] for r in preempt.values())
                      + observed["launches"]["rn"] + handoff["launches"]["rn"]
                      + attach["launches"]["rn"] + rehearsal["launches"]["rn"]
                      + sum(r["launches"]["rmsnorm"] for r in tp8["ranks"])
                      + sum(r["rmsnorm"] for r in judge["launches"].values())),
         **rn_res},
        {"name": "flash_attention", "route": "cuda",
         "source": f"{PKG}/csrc/flash_attention.cu",
         "replaces": f"{jax_pkg}/ops/flash_attention.py:62",
         "launches": (sum(r["flash_launches"] for r in bert.values()) + serve["fa_launches"]
                      + spec["fa_launches"] + packed["fa_launches"] + packed_none["fa_launches"]
                      + sum(r["fa_launches"] for r in dense.values())
                      + sum(r["launches"]["fa"] for r in multistep.values())
                      + sum(r["launches"]["fa"] for r in unified.values())
                      + sum(r["launches"]["fa"] for r in preempt.values())
                      + observed["launches"]["fa"] + handoff["launches"]["fa"]
                      + attach["launches"]["fa"] + rehearsal["launches"]["fa"]
                      + sum(r["launches"]["flash_attention"] for r in tp8["ranks"])
                      + sum(r["flash_attention"] for r in judge["launches"].values())),
         **fa_res},
        # The same kernel's log-sum-exp instance: the ring blocks of phase
        # 8b's sp prefills, every rank of its three served units.
        {"name": "flash_attention_lse", "route": "cuda",
         "source": f"{PKG}/csrc/flash_attention.cu",
         "replaces": f"{jax_pkg}/ops/flash_attention.py:62",
         "launches": sum(rep["launches"]["flash_attention_lse"]
                         for run in mesh_sp["runs"].values() for rep in run["reports"]),
         **lse_res},
        *({"name": name, "route": "cuda", "source": f"{PKG}/csrc/flash_attention.cu",
           "replaces": f"{jax_pkg}/ops/flash_attention.py:62",
           "launches": launches, "max_abs_err": ragged_res["max_abs_err"],
           "shape": "B_p=4 C=256 offsets 0/256/768/3840 H=NKV=32 D=128 bf16 q, "
                    f"{cache} cache", **ragged_res["timing"][cache]}
          for name, cache, launches in (
              ("flash_attention_ragged", "int8",
               packed["ragged_launches"] + unified["int8kv"]["launches"]["fr"]
               + preempt["int8kv"]["launches"]["fr"]),
              ("flash_attention_ragged_bf16", "bf16",
               packed_none["ragged_launches"] + unified["none"]["launches"]["fr"]
               + preempt["none"]["launches"]["fr"]))),
        {"name": "dmajor_attention", "route": "cuda",
         "source": f"{PKG}/csrc/dmajor_attention.cu",
         "replaces": "scripts/proto_dmajor_attention.py:41", **dm_res},
        *({"name": name, "route": "cuda", "source": f"{PKG}/csrc/sampling.cu",
           # not a Pallas port: the XLA sampling step it stands in for
           "replaces": f"{jax_pkg}/models/sampling.py:125",
           "launches": sum(r["launches"]["ss"] for r in (*multistep.values(),
                                                          *unified.values(),
                                                          *preempt.values(),
                                                          observed)),
           "max_abs_err": ss_res["max_abs_err"] if name == "sample_draw" else 0.0,
           "shape": "B=32 V=32000 f32 logits, T 0.8 top_k 50 top_p 0.95",
           "ms": t[f"{part}_ms"], "device_ms": t[f"{part}_device_ms"],
           # the plain chain's whole step, its sort included
           "plain_ms": t["plain_ms"], "bound_ms": t["bound"][part]["ms"],
           "bound_by": t["bound"][part]["by"], "library_ms": None}
          for t in [ss_res["timing"]["b32_smoke"]]
          for name, part in (("sample_prep", "prep"), ("sample_draw", "draw"))),
    ]
    DETAIL["kernels"] = kernels
    DETAIL["wall_s"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(DETAIL, indent=1, default=str))
    log(f"wall {DETAIL['wall_s']:.1f} s on {smi}")
    stage("done")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
