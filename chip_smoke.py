"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing here catches its own failure):

1. the card's name and power limit, and the build of every CUDA kernel of
   the serving and training paths from ``neuronx_distributed_tpu_torch/csrc``
   (one ``nvcc`` per source, started together); K1's, K2's, K3's, K4's,
   K5's, K5q's (with the write too), QW's and PF's resources as built
   (neither K1 nor a decode kernel, QW or PF may spill, nor may ptxas
   serialize K1's ``wgmma`` products);
2. each kernel against its plain PyTorch version at its path's shapes,
   bf16, with its time, the plain version's, the least time the card could
   take (``bound_ms``) and one PyTorch library call's (SDPA) time: K1 at the
   serving prefills (S=512 and 4096, left padding) and at the training batch
   (B=2, S=4096, unpacked and packed), bitwise reproducible, timed as a
   CUDA-graph replay (back to back beside), with its tile plan (visited,
   masked and live tile pairs); K4 at the serving shapes, K5 through a
   scrambled block table at K4's shapes and at the paged serving phase's
   geometry (also bitwise equal to K4 on the gathered view and blind to
   the null page), K2 and K3 at the
   training shapes (unpacked, packed and ragged), each also bitwise
   reproducible. K4, K5 and their SDPA yardstick take less device time
   than the host needs to issue them: their times are CUDA-graph replays
   (``graph_ms``), with the back-to-back time printed beside; K4's and
   K5's split plans (blocks, live tiles, bytes moved against the bound's)
   are printed; K4 and K5 at phase 5d's verify window (s = gamma = 4, 16
   rows a kv-head, the gap columns rejected drafts leave), K4 at the row
   serving shapes, K5 through a scrambled table at the paged serving
   geometry; K4 and K5 on their multi-row path at phase 5c's geometry
   (R = 64, 1024 and 2048), K5 bitwise equal to K4 on the gathered view;
   K5q (int8 pages, a bf16 scale per page and kv-head, converted where
   the products read them) at K5's two geometries against
   its plain version and bitwise equal to K4 on the dequantized gathered
   view (a dropped tile must fail the limit), at 64 slots of the serving
   pages (more items than the card holds blocks at once) and with a slot
   that has no live column, three CUDA-graph replays in a row equal bit
   for bit,
   timed beside SDPA on that view and the gather-dequantize; QW (the int8
   pool's window re-quantize, K and V in one launch) bitwise equal to its
   plain version on every page but the null page at a decode step and at
   a 300-token prefill window from mid-page, one page's absmax rising and
   one's falling, each timed against its bytes bound; K5q with the write
   (the int8 pool's decode step: QW's window re-quantize folded into K5q's
   range kernel) at the paged serving geometry, at a decode step and at a
   verify window (s = 4, R = 16) across a page and a 256-column range,
   bitwise equal to QW then K5q (pools and scales on every page but the
   null page, out and lse), one page's absmax rising and one's falling, a
   variant that skips the write and one that attends the stale codes
   failing that check, timed (graph replays) beside K5q alone and QW +
   K5q against K5q's bytes plus QW's; DQ (the one-pass weight
   dequantize) at lm_head's shape, int8 and fp8, bitwise equal to its
   plain version, timed against its 3-bytes-a-weight bound; PF (the
   per-page pool fingerprints of a paged prefix hit) over 100 pages in
   scrambled order of phase 5b's bf16 pool and of phase 5f(c)'s int8 pool
   with scales, bitwise equal to its plain version, one flipped bit moving
   its page's value alone, timed against its bytes bound; MX and MXq (the
   routed SwiGLU expert product of a MoE decode step, bf16 and int8/fp8
   experts) at Mixtral-8x7B's shapes against their plain version stage by
   stage (a dropped tile or pair must fail the limits), on random routes
   at T = 8 and 1, every pair on one expert and one expert untouched, two
   runs and three graph replays bitwise equal, timed (graph replay) against
   the bytes of the experts the call touches, the plain version and
   ``torch._grouped_mm`` over the same expert-sorted pairs; MXq's
   dequantize code by code (x one-hot: every int8 and finite e4m3 code of
   up and of down, bit for bit); ``ptxas`` reports no spill and no
   serialized ``wgmma`` in ``csrc/moe_experts.cu``;
3. outputs: the full-width model's logits through the kernels, with a row
   cache and with a paged cache behind a scrambled block table, against the
   same model with the plain versions swapped in, on a short prompt;
4. serving: ``ServingEngine`` over Llama-3-8B at full width (all 32 layers,
   random bf16 weights from a seed) answering six requests, its decode step
   one CUDA graph captured at the first chunk and replayed; every kernel's
   launch count is zeroed just before and read just after (a replay calls
   no wrapper: replays x launches per replay count for it); then a witness
   run with the eager step patched in, whose token streams must be
   identical;
5. the same workload under ``torch.profiler`` (the decode program captured
   before it opens): device time by kernel family, the device's idle share,
   and the profiler's K4 kernel records, two (range, merge) per executed
   step and layer;
5b. paged serving: the same model behind a paged engine (16 slots, a pool
   of four row slots' bytes) answering 15 mixed-length requests, with K5
   attending the pool, with K4 on the gathered view patched in (before the
   first chunk, so the graph captures it) and with the eager step patched
   in, all with identical token streams; then the K5 run once more under
   the profiler (K5 records counted as in 5);
5c. prefix-cache serving: 12 requests sharing a 1600-token system prompt
   (4 short tails, 7 chat turns of 100-400 tokens, a duplicate) through the
   row engine and the paged engine, each with the prefix cache and without,
   after a warm-up wave on another system prompt and the store cleared:
   11 hits and 1 miss, hits prefilling their tails through K4/K5 (the
   multi-row path above 32 rows per kv-head) and never K1, the decode
   program captured once; paged: zero KV bytes copied, 100 pages shared a
   hit, pinned pages bitwise unchanged, ``check()`` after every step, every
   page free after the store is cleared; three hits' suffix-prefill logits
   against full prefills of the same contexts (phase 3's limits); the
   earlier serving phases run with ``prefix_cache=None``;
5d. speculative serving: phase 4's six requests through the model and its
   early-exit draft (layer 0 alone, sharing the target's tensors; the
   later layers' residual weights scaled by eps), gamma 4, 8 slots, chunk
   8 rounds, each engine's draft-verify round one CUDA graph: eps 0 spec
   on (the greedy slots must accept at least 0.9 of their drafts); eps
   0.3 spec on, spec off, spec on with the eager round patched in (the
   captured round's streams must equal it bit for bit), the paged engine
   (K5 for both caches, both pools ``check()`` clean) and a profiled
   rerun (device time by family, idle share); every executed round
   launches 4 + 32 decode kernels and no multi-row one, every admission
   K1 33 times, and every emitted greedy token lies within phase 3's
   limit of its row's maximum logit in a teacher-forced target pass;
5e. Medusa tree decoding: phase 4's base (shared, not copied) with four
   bf16 Medusa heads from a seed, the default tree (8 nodes, depth 3), top_k
   10: ``medusa_generate`` with random heads at B = 1 (a 256-token prompt,
   128 new tokens); the base's greedy ``generate`` of 256 tokens after that
   prompt; 30 steps of head training on those 512 tokens (fp32 master
   heads, the backbone frozen, AdamW at weight decay 0, peak memory under
   72 GiB); the trained heads at B = 1 (the same prompt) and B = 4 (four
   prompts, the trained one first, 64 new tokens); the B = 1 trained run
   again with the eager round patched in (tokens and accepted lengths bit
   for bit) and its first 32 tokens under the profiler (opened after the
   capture: device time by family, idle share, the heaviest kernels); a
   round's parts timed as graph replays at B = 1 and 4. Each call
   captures its round once and replays it every round, each replay K4
   once a layer and nothing else, the prefill K1 once a layer; at least
   one trained round at B = 1 emits two tokens or more; every emitted
   token lies within phase 3's limit of its row's maximum logit in a
   teacher-forced base pass;
5f. quantized serving, at full width and depth: (a) int8 weights behind
   the row engine, phase 4's requests: weight bytes against bf16, one
   capture with K4 32 and DQ 225 a replay, the eager-step witness's streams
   identical, ms a decode-only step, and a 64-token prompt's 16 teacher-
   forced steps against the bf16 model (max KL at most 5e-3; top-1
   agreement printed); (b) fp8 weights, the same, KL printed; (c) int8
   weights and an int8 page pool of phase 5b's bytes behind the paged
   engine, phase 5b's traffic: K5q with the write 32 (K5q's count holds
   it), QW 0 and DQ 225 a replay, QW the prefills' writes alone, K5 0, the
   eager-step witness identical, ``check()`` clean, peak occupancy, the ms
   a step and the profile by family; (d) phase 5c's
   paged prefix leg on that pool: 11 hits and 1 miss, ``copy_bytes`` 0,
   pinned pages' codes and scales bitwise unchanged, each hit's suffix
   prefilled on K4 (multi-row) over a dequantized float row; (e) that pool
   beside a float draft (phase 5d's early-exit pair at eps 0.3, the
   draft's tensors its own, gamma 4, phase 4's requests, 16 slots of 16-
   column pages): K5q with the write 32 a round at R = 16 (the verify
   window), QW 0 a round, the captured round's streams = the eager
   round's, every greedy token within phase 3's limit teacher-forced, both
   pools ``check()`` clean;
5g. the serving engine's fault contract at full width, every fault counter
   equal to the injected schedule, the decode program one capture on its
   buffers through every recovery and quarantine: on phase 4's row engine
   (a) a dispatch failure before the chunk (recovery, DEGRADED then OK),
   (b) the chunk raising after its replays ran (reset in place), (c) a
   poisoned readback (the slot quarantined, the neighbours' streams equal
   to phase 4's), (d) persistent failures (HALTED, the work requeued, the
   post-mortem written and parsed back), (e) a skewed clock shedding two
   queued requests before any prefill, (f) one prefill fault; on phase
   5c's paged prefix traffic (g) a poisoned page shared by every request
   (all requeued, ``check()`` clean every step) and a flipped pool bit
   caught by the page fingerprints at a hit (a full prefill instead), one
   host read more a paged hit; on phase 5d's speculative engine (h) a
   failed draft dispatch (one plain chunk, every slot preempted). Tokens
   emitted before a fault equal the fault-free run's; the rest are counted
   bit for bit and every greedy token lies within phase 3's limit
   teacher-forced; the recovery walls of (a) and (g);
5h. SLO-aware multi-tenant serving, at full width and depth: a seeded
   two-tenant tape (chat: Poisson at 16 rps, prompts of 100-400 tokens, 32-64 new,
   interactive, TTFT 0.5 s and TPOT 0.05 s bounds; docs: bursty, prompts of
   2000-3000 tokens, 64-128 new, batch, TTFT 4 s) through phase 5b's paged
   engine (a) on a virtual clock (``serving/traffic.replay``, 0.1 s a
   step) under FIFO and under the SLO policy, a shared registry labelled
   by engine, the SLO engine traced: every arrival DONE with its token
   count or attributed, at least one SLO preemption, one capture an engine
   on the same buffers, K5 = executed steps x 32 + the warm-up's 32, K1 =
   admissions x 32 (victims' resumes included), host reads = chunks +
   first tokens, ``check()`` after every step, one connected Perfetto flow
   a request with each victim's ``slo_preempt`` step, every greedy token
   of the SLO run within phase 3's limit teacher-forced; the two reports,
   the policy's snapshot, chat's attainment under each policy and the
   streams equal across the runs printed; (b) the tape's first 6 s (the
   duration cut to keep 5h within 120 s) on the wall clock under both
   policies, per-tenant TTFT/TPOT/queue-wait
   percentiles, attainment and goodput printed (no gate on speed); (c) a
   row leg: the tape's first 3 s through phase 4's row engine under the
   SLO policy (K4), with (a)'s count gates;
5i. the host page tier (``kv_host_pages=``), at full width and depth:
   phase 5c's paged engine (2 slots, page 16, chunk 8, eager) with four
   1600-token system prompts and tails of 100-400 tokens in serial waves
   0,1,2,3,0,1,2,3 through a pool of 380 pages (two prefixes beside the
   active slot): (a) tiering off (every revisit misses), on with 512 host
   pages (1 GiB pinned; every revisit a host-tier hit, at least 4) and a
   control of 1200 pages (every revisit a device-tier hit); streams on =
   control bit for bit; after every prefetch PF over the new pages = the
   entry's insert-time ``page_fp``; one capture an engine, replays =
   executed steps, K1 = full prefills x 32, K5's own launches = suffix
   prefills x 32, PF = inserts + device-tier hits (none at a host-tier
   hit), host reads = chunks + first tokens + one a spill + one a
   device-tier hit, ``copy_bytes`` 0, ``check()`` of both tiers after
   every step, every page free after the store is cleared; the spill walls
   (copy and CRC), the verify walls, TTFT of a miss, a host-tier and a
   device-tier hit at the same context lengths, ``hbm.snapshot()`` and
   ``plan()``; (b) the eight at once under the profiler: the prefetches'
   host-to-device copies beside kernels of other streams, every greedy
   token within phase 3's limit teacher-forced; (c) phase 5f(c)'s int8
   pool (bf16 weights), (a)'s tiering-on leg against an int8 control, K5q
   with the write 32 a replay (K5q's count holds it), QW 0 a replay, K5 0;
   (d) a failed spill, a poisoned host page and a
   failed prefetch on (a)'s tiered engine: counters = the schedule,
   requests submitted before the first fault = the fault-free run's, every
   greedy token within phase 3's limit teacher-forced;
5j. weights that change, at full width and depth (random bf16 weights,
   W0 = seed 0, the model's; W1 = seed 1): (a) phase 5c's paged prefix
   engine and traffic, a wave under W0, ``engine.params = W1`` (the
   device-to-device copy timed), the same wave again: every parameter at
   its address, one capture, the store empty, every page free of pins,
   ``check()`` clean; the second wave hits and misses as the first (no W0
   entry reused), K1 = full prefills x 32, PF = inserts + hits, its streams
   differ from W0's and equal a fresh engine's over the model now holding
   W1 bit for bit; (b) phase 5f(a)'s int8 engine: a float W1 re-quantized
   into the engine's own tensors = ``quantize_state_dict(W1)`` bit for bit
   (timed), a pre-quantized W1 bound as is, DQ 225 a replay, streams = a
   fresh int8 engine's on W1, the float source model = ``init_params(seed
   0)`` bit for bit; (c) phase 5d's speculative engine with ``draft_params=``
   (the layer-0 draft's tensors copied, no storage shared with the
   target): beside an int8 target, poisoned at every dispatch (greedy
   acceptance under 0.5, the clean control's over 0.9, the draft's bits
   restored) and swapped mid-flight to a corrupted draft and back (its
   acceptance collapses, no new capture); every greedy token within phase
   3's limit teacher-forced; (d) phase 4's row engine and phase 5b's paged
   engine on a virtual clock: two steps, ``fence``, the snapshot through
   JSON, a restore into a fresh engine 1000 s later: the live requests
   restored, the downtime and every deadline budget exact, every stream
   DONE and beginning with its pre-kill tokens, every greedy token within
   phase 3's limit teacher-forced, K1 = (admissions + re-admissions) x 32,
   one capture an engine; streams equal to the uninterrupted run's and the
   wall from the fence to the first token after the restore printed; (e)
   the fenced row engine's requeued requests adopted one by one by a fresh
   engine, (d)'s stream gates;
5k. the serving fabric at full width (``serving/router.py``,
   ``transport.py``, ``disagg.py``; the replicas are engines over the one
   module, each with its own cache and capture): (a) 3 replicas of phase
   5b's paged engine, prefix cache on, phase 5c's 12 sessions one at a
   time then phase 5b's 15 requests: routed = submitted, affinity hits
   and each replica's hits, misses and inserts = a CPU dry run of the same
   leg at tiny width, K1 = full prefills x 32, PF = inserts + paged hits,
   one capture a replica, ``check()`` on every replica after every step;
   (b) 3 replicas of phase 4's row engine, replica 1 halted mid-decode by
   failing dispatches: its unfinished requests re-homed with
   ``tokens_lost == 0`` (their pre-halt tokens kept exactly), the
   survivors' captures unchanged, K1 = (admissions + re-admissions) x 32,
   the re-home wall; (c) (a)'s router over a ``ChaosTransport`` (JAX's
   ``_chaos_faults``) with a watchdog on a virtual clock, replica 2
   partitioned: OK -> SUSPECT -> DEGRADED -> DEAD, fenced, re-homed, no
   rid admitted twice, the probe states and the transport's snapshot = the
   dry run's; (d) ``add_replica`` (rebalanced = the dry run's),
   ``remove_replica``, ``restart_replica`` of a fenced replica (its live
   requests restored, ``router_restart_latency_s``); (e) a
   ``DisaggregatedServer`` on phase 5b's engine: a shared pool
   (``copy_bytes`` 0) and distinct pools (``copy_bytes`` = the exported
   bytes) with equal streams, the staged pages = a coupled prefill's bit
   for bit on the bf16 pool and 5f(c)'s int8 pool, K1 = worker prefills x
   32, K5 = executed steps x 32, the coupled fallbacks under
   ``fail_handoff`` and a worker death, the handoff and import walls, TPOT
   p50/p99 of chat decoders under a document burst through the coupled
   engine and the disaggregated server (reported). Every greedy token of
   every leg within phase 3's limit teacher-forced; peak memory under 72 GiB;
5l. integrity and program observability at full width
   (``integrity/``, ``serving/router.py``'s vote, ``observability/
   programs.py``, ``observability/profiler.py``, ``inference/aot.py``):
   (a) three int8 replicas (phase 5f(a)'s engine, 4 row slots; a quantized
   replica owns its weights) under ``WatchdogConfig(
   integrity_interval_s=0.5)`` on a virtual clock with phase 4's requests,
   ``flip_bits("params", at=1)`` on replica 0: convicted at the first vote
   after the flip, fenced, re-homed, ``tokens_lost == 0``; a clean control
   (no disagreement, no fence) and two replicas (a disagreement at every
   vote after the flip, no fence); the stats, walks and flight events of all three = a CPU dry run
   at tiny width; a probe's wall; (b) phase 5b's engine with
   ``program_ledger=``: decode dispatches = replays = executed steps, one
   capture, the step's metered FLOPs = the analytic count, MFU by program,
   host reads and tokens = phase 5b's; (c) phase 4's engine with
   ``profile_dir=``: the trace's K4 records = chunks [2, 5)'s,
   ``record_device_memory`` = ``mem_get_info``; (d) ``restart_replica`` and
   ``add_replica`` with a donor's manifest and ``cache_dir``: every program
   replayed, the first request captures and builds nothing, TTFT against a
   cold replica's. Phase 2's TF check (bf16 Llama-3-8B weights, 5f(a)'s
   int8 tensors) runs once the model is built;
5m. Mixtral serving at Mixtral-8x7B width (hidden 4096, 32/8 heads, 8
   experts top-2, intermediate 14336, vocab 32000; random weights from seed
   0; run after the Llama model is freed): (a) bf16 cut to 16 layers (~47
   GB): the kernel path against the plain path on a short prompt (phase
   3's limits), phase 4's requests through a row engine at 8 slots (MX 16
   a replay), its eager witness bit for bit, solo ``generate``, a profiled
   rerun (idle share), phase 5b's traffic through a paged engine at 16
   slots (the blockwise route's sort and ``torch._grouped_mm`` under the
   capture) and its eager witness, phase 5c's prefix wave on the row
   engine (11 hits, 1 miss; each hit's logits against a full prefill's,
   and against MX's plain version on the same route), then
   ``engine.params = W1`` on a captured row engine at 8 slots: every
   parameter at its address, one capture, streams = a fresh engine's on
   W1; (b) int8 and fp8
   copies of an 8-layer model teacher-forced against it: JAX's Mixtral
   criterion (median relative error < 0.02, 95% under 0.1) and the max KL;
   (c) the full 32-layer model with int8 weights, filled weight by weight
   on the card, phase 4's requests at 8 slots: MXq 32 and DQ 129 a replay,
   peak memory under 72 GiB;
5n. the other decoder families at full width, random bf16 weights from
   seed 0 filled on the card, each freed before the next (run after
   Mixtral): (a) GPT-NeoX-20B whole (44 layers, head_dim 96): phase 4's
   requests with the prompts cut to its 2048 columns through the row
   engine, its eager witness (bit for bit), the paged engine and solo
   ``generate``; K1, K4 and K5 on their head_dim-96 builds alone (prefills
   x 44, (replays + warm-up) x 44; every 128 count 0); every greedy token
   within phase 3's limit teacher-forced; peak memory under 72 GiB; (b)
   CodeGen2.5-7B whole (head_dim 128), the same on the row engine and solo
   ``generate``; (c) DBRX's widths (16 experts top-4, hidden 6144,
   intermediate 10752) cut to 8 layers and 4096 columns: phase 4's
   requests through the row engine (MX 8 a replay) and its route-recording
   eager witness, the greedy tokens teacher-forced on the routes that
   served them, and the same through the paged engine and its recording
   witness (where the two engines part logged). Phase 2 holds the head_dim-96 builds
   of K1 (GPT-NeoX-20B's 2048-token prefill), K4 and K5 (the decode step,
   the verify window at R = 16, the multi-row path at R = 1024) to their
   plain versions, K5 = K4 on the gathered view bit for bit, timed beside
   D = 96's own bound and SDPA; phase 1 reports their ``ptxas`` spills;
6. training, kernel path against plain path: one step's loss and gradients
   of a 2-layer Llama-3-8B-width model at S=1024;
7. training: six ``build_train_step`` steps of Llama-3-8B width cut to 8
   layers (fp32 masters, AdamW, remat) on one packed 2 x 4096 batch, launch
   counts zeroed just before and read just after, then one step under the
   profiler;
7b. the training loop (``trainer/loop.py``) at Llama-3-8B width cut to 2
   layers (1,486,901,248 parameters), phase 7's packed 2 x 4096 batches
   from a seed, counts zeroed before and read after: (a) ``Trainer.fit``
   8 steps with async ``CheckpointCallback(every=4)`` (keep-last 2) and a
   ``MetricsCallback``, one host read a step; a fresh fit resumed from
   step_4 reaches step 8 with steps 5-8's losses and TF over the final
   state (= its plain version) bit for bit; the manifests verify; (b) one
   schedule (NaN at 1, a failed dispatch, a spike at 4 after a warm-up of
   2, SIGTERM at 6): the counters, health by step and tags = a CPU dry run
   at tiny width, the skipped steps' TF unchanged, the preemption's step_6
   resumed to an uninterrupted run's final bits; (c) at B = 1 (the memory
   reckoning in PERF.md) the canary sentinel every 4 steps: zero false
   positives and the sentinel-off run's bits; a params flip at the step-8
   check convicted, rolled back to step 4 and retrained to the clean bits;
   a flip between checks (step 5) not convicted; at B = 2 a rotten shard
   of (a)'s step_8 refused, the fallback to step_4 retrained to (a)'s bits;
   (d) remat policies None, "dots" and "dots_saveable": equal losses bit
   for bit, each one's wall and peak. K1 = 2 x 2 x train-step dispatches,
   K2 = K3 = 2 x dispatches, TF = two a check and the gates' own; peak
   under 72 GiB; the checkpoint directory (build/phase7b_ckpt, its free
   space printed first) deleted at the end; TF over the train state timed
   against its bytes bound after the counted window;
7c. Mixtral training at Mixtral-8x7B width cut to 2 layers (3,164,688,384
   parameters; fp32 masters, gradients and AdamW's moments take 50.6 GB),
   random weights from a seed, after phase 7b freed its model: (a) one
   step at B = 1, S = 1024 (packed, jitter and shuffle on) through the
   kernels against the plain path (plain attention and the all-experts
   einsums) forced onto the routes the kernel run took, the loss and
   every gradient within phase 6's limits; (b) six ``build_train_step``
   steps on one packed 2 x 4096 batch (remat on, router jitter 0.01, the
   token shuffle, the blockwise route's ``torch._grouped_mm`` products and
   their backward), each step's jitter and permutation from the step's
   generator: the loss finite and falling, K1 = 2 x 2 layers x steps and
   K2 = K3 = 2 x steps, every other count 0, the step wall, tokens/s, MFU
   by active parameters (top-2 of 8 experts) beside the program ledger's
   metered FLOPs, peak under 72 GiB, one profiled step (device ms of the
   grouped products, K1-K3, the dense GEMMs, AdamW and the rest, the idle
   share) and one step's forward and backward re-run from a fresh
   generator of the same (seed, step), equal in TF bits (the state itself
   is too large to copy on the card); (c) ``Trainer.fit`` for 6 steps with
   the canary every 2 steps, jitter and shuffle on, at B = 1 and an expert
   width cut to 3584 (the canary's two state-sized snapshots beside the
   state): no check disagrees, and the losses and the final TF equal a
   sentinel-off run's;
8. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device: without one it exits non-zero before printing any
result.
"""

from __future__ import annotations

import bisect
import collections.abc
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# Output limits, elementwise: |out - ref| <= 2^-7 |ref| + c * (P|V|) + 1e-5.
# 2^-7 |ref| is one bf16 ulp of O: both sides round O to bf16 last. P|V| is
# the plain version run on |V|, the softmax-weighted size of what a row
# averages, which bounds any difference in its P·V sum. K1 rounds P to bf16
# for that product (2^-9 relative per term): c = 2^-8, twice that bound. K4
# keeps P in f32 and differs in summation order and expf only: c = 2^-12.
K1_PV = 2.0 ** -8
K4_PV = 2.0 ** -12
LSE_TOL = 5e-4  # f32 on both sides; exp-sums of <= 8192 terms in another order (n * 2^-24)
# Backward limits, elementwise, the same form: |g - ref| <= 2^-7 |ref| +
# c * M + 1e-5, with M the sum of the magnitudes of the terms of g: P|dO|
# for dV, |dS||Q| for dK, |dS||K| for dQ (dS = P (dP - delta) scale). K2 and K3 round P
# and dS to bf16 (2^-9 relative per term) as the A operands of those
# products, where the plain version keeps f32; dS itself, S and dP are f32
# sums of exact bf16 products on both sides. c = 2^-8, twice that bound.
K2K3_C = 2.0 ** -8


def log(*a):
    print(*a, flush=True)


def tol_ratio(out, ref, pv, c: float) -> float:
    """Largest |out - ref| over its elementwise limit (above 1 fails)."""
    ref = ref.float()
    limit = 2.0 ** -7 * ref.abs() + c * pv.float() + 1e-5
    return float(((out.float() - ref).abs() / limit).max())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time of ``fn`` with the host taken out: ``iters`` calls
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events. K4, K5 and SDPA at decode shapes take less device time than the
    host needs to issue them, so back-to-back launches (``cuda_ms``) time
    the host there; both numbers are printed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def graph_replays(fn, n: int) -> list:
    """``fn`` (returning tensors) captured once in a CUDA graph and replayed
    ``n`` times in a row: a copy of its outputs after each replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    got = []
    for _ in range(n):
        for t in outs:
            t.zero_()
        graph.replay()
        got.append([t.clone() for t in outs])
    torch.cuda.synchronize()
    del graph
    return got


def decode_plan(valid, bound_cols: int, hkv: int, rows: int, page_size: int = 0) -> dict:
    """What K4/K5 launch and move for one call, from the inputs and the
    kernels' split plan (``split_cols`` columns a block, ``tile_cols`` a
    tile): blocks in the grid, ranges of a slot that start before the bound
    (their blocks run), working blocks (a range with a live tile), live
    tiles, and the bytes the plan moves: the live K/V columns, the table
    entries of live pages (K5), q for every block that runs, the kv_valid
    bytes of every block, the partial O and LSE written and merged, out and
    lse."""
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("flash_decode")
    split, tile = lib.nxd_flash_decode_split_cols(), lib.nxd_flash_decode_tile_cols()
    b, L = valid.shape
    d = 128
    n_splits, ranges = -(-L // split), -(-bound_cols // split)
    live = torch.nn.functional.pad(valid[:, :bound_cols], (0, ranges * split - bound_cols))
    live_tiles = int(live.reshape(b, -1, tile).any(-1).sum()) * hkv
    working = int(live.reshape(b, ranges, split).any(-1).sum()) * hkv
    grid, in_bound = hkv * b * n_splits, hkv * b * ranges
    moved = (2 * 2 * d * int(live.sum()) * hkv                          # live K and V
             + in_bound * 2 * rows * d + grid * split                   # q, kv_valid
             + 4 * rows * (2 * in_bound + working * d + in_bound * d)   # partials: written, merged
             + 2 * b * hkv * rows * d + 4 * b * hkv * rows)             # out, lse
    if page_size:
        moved += 4 * int(live.reshape(b, -1, page_size).any(-1).sum()) * hkv
    return dict(grid=grid, splits=n_splits, ranges=ranges, in_bound=in_bound, working=working,
                live_tiles=live_tiles, read_bytes=moved)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# --- phase 2: kernels against their plain versions ----------------------------

K1_SHAPES = (  # (name, B, S, segments): the serving prefills, then the training batch
    ("serving", 1, 512, 77), ("serving", 1, 4096, 1001),
    ("training", 2, 4096, None), ("training", 2, 4096, "packed"))


def k1_inputs(gen, b: int, s: int, segments, h: int = 32, hkv: int = 8, d: int = 128):
    """``check_k1``'s inputs: q (B, S, h, d), k and v (B, S, hkv, d) (32,
    8 and 128 by default: Llama-3-8B's) and the segment ids: ``pad`` (an
    int) left-padding rows as segment -1, the training batch's packed
    documents (``"packed"``), or none."""
    import numpy as np

    dev, bf = torch.device("cuda"), torch.bfloat16
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    seg = None
    if segments == "packed":
        seg = torch.from_numpy(packed_segments(np.random.default_rng(s), b, s)).to(dev)
    elif segments is not None:
        seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
        seg[:, :segments] = -1
    return q, k, v, seg


def k1_plan(q, k, seg) -> dict:
    """K1's tile plan for one call (``flash_fwd_tile_plan``, the kernel's
    own predicate): (query tile, key tile, head, batch) pairs in the grid,
    visited, masked, and live (holding a live pair of the plain mask); and
    the FLOPs of the visited tiles over the live pairs' (the bound's)."""
    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        FWD_K_TILE,
        FWD_Q_TILE,
        _live,
        _seg_tile_ranges,
        flash_fwd_tile_plan,
    )

    b, s, h, _ = q.shape
    sk = k.shape[1]
    ranges = {}
    if seg is not None:
        ranges = dict(q_ranges=_seg_tile_ranges(seg, FWD_Q_TILE),
                      k_ranges=_seg_tile_ranges(seg, FWD_K_TILE))
    plan = flash_fwd_tile_plan(s, sk, True, h=h, b=b, **ranges)
    live = _live(q, k, True, seg, seg)[:, 0, 0]
    nq, nk = plan["visited"].shape[1:]
    live = torch.nn.functional.pad(live, (0, nk * FWD_K_TILE - sk, 0, nq * FWD_Q_TILE - s))
    live_tiles = live.reshape(b, nq, FWD_Q_TILE, nk, FWD_K_TILE).any(4).any(2).cpu()
    visited = int(plan["visited"].sum()) * h
    pairs = int(live.sum()) * h
    return dict(grid=b * nq * nk * h, visited=visited, masked=int(plan["masked"].sum()) * h,
                live=int(live_tiles.sum()) * h, blocks=int(plan["order"].shape[0]),
                work_over_bound=visited * FWD_Q_TILE * FWD_K_TILE / pairs)


def check_k1(gen, b: int, s: int, segments, **heads):
    """K1 at one of ``K1_SHAPES``: B, S, H=32, Hkv=8, D=128 (or ``heads``'
    h, hkv and d: :func:`k1_inputs`), causal, bf16;
    against the plain version, twice for the same bits, timed (a CUDA-graph
    replay of the wrapper's call, device time only, and back to back)
    beside its bound and SDPA: a boolean mask where there are segments,
    ``is_causal`` (a fused causal kernel) where there are none."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
    )

    dev = torch.device("cuda")
    q, k, v, seg = k1_inputs(gen, b, s, segments, **heads)
    out, lse = flash_attention_fwd(q, k, v, True, seg)
    again, again_lse = flash_attention_fwd(q, k, v, True, seg)
    ref, ref_lse = flash_attention_plain(q, k, v, True, seg)
    pv = flash_attention_plain(q, k, v.abs(), True, seg)[0]
    # what a kernel that skipped the keys S-64..S-1 (part of the diagonal
    # tile of the last query tile) would return: the limit must fail it
    q_seg = seg if seg is not None else torch.zeros(b, s, dtype=torch.int32, device=dev)
    kv_seg = q_seg.clone()
    kv_seg[:, s - 64:] = -2
    fault = flash_attention_plain(q, k, v, True, q_seg, kv_seg)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K1_PV), tol_ratio(fault, ref, pv, K1_PV)
    del ref, pv, fault
    tag = f"K1 B={b} S={s} {segments if segments is not None else 'unsegmented'}"
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"{tag}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"{tag}: the output limit passes a dropped K tile ({fault_ratio:.3g}x)")
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{tag}: two runs differ in their bits")
    # the work this input needs: live (query, key) pairs of the causal,
    # segment-masked score matrix, 4*D FLOPs each (QK^T and PV)
    h, d = q.shape[2], q.shape[3]
    pairs = live_pairs(seg, b, s, dev) * h
    flops = 4.0 * d * pairs
    seg_bytes = 0 if seg is None else 2 * 4 * seg.numel()
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel() + seg_bytes
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    call = lambda: flash_attention_fwd(q, k, v, True, seg)  # noqa: E731
    ms, eager_ms = graph_ms(call, 10), cuda_ms(call, 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, True, seg), 3, warmup=1)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if seg is None:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
    else:
        rows = torch.arange(s, device=dev)
        mask = (rows[:, None] >= rows[None, :]) & (seg[:, :, None] == seg[:, None, :])
        mask = mask[:, None]  # (B, 1, S, S) boolean, True = attend
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    lib_ms = graph_ms(lib, 10)
    return dict(b=b, s=s, segments=segments, err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio,
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms, library_eager_ms=cuda_ms(lib, 20), tflops=flops / ms / 1e9,
                plan=k1_plan(q, k, seg))


VERIFY_DECODE_START = 3076  # check_k4 at s > 1: where decoding began (256 rounds of 4)


def rejected_gaps(gen, dec_start, L: int, bound_cols: int, s: int):
    """(B, L) bool: the gap columns a speculative engine's rounds leave in
    the columns ``[dec_start[b], bound_cols - s)`` of each slot: rounds of
    ``s`` columns aligned to end at the bound, each keeping a random 1..s
    of its columns (``invalidate_cache_window``: the accepted drafts and
    the correction) and clearing the rest. The last round, the verify
    window at ``[bound_cols - s, bound_cols)``, is whole."""
    dev = dec_start.device
    cols = torch.arange(L, device=dev)
    rnd = torch.div(bound_cols - 1 - cols, s, rounding_mode="floor")  # 0: the verify window
    off = cols - (bound_cols - s * (rnd + 1))  # column of its round
    n_rounds = -(-bound_cols // s)
    keep = torch.randint(1, s + 1, (dec_start.shape[0], n_rounds), generator=gen, device=dev)
    kept = keep.gather(1, rnd.clamp(0, n_rounds - 1)[None].expand(dec_start.shape[0], -1))
    return ((off[None] >= kept) & (rnd[None] >= 1) & (cols[None] < bound_cols)
            & (cols[None] >= dec_start[:, None]))


def k4_inputs(gen, s: int = 1):
    """``check_k4``'s inputs: q (8, s, 32, 128), a row cache (8, 8192, 8,
    128), the positions ``4100 - s .. 4099``, kv_valid with left padding
    (slot i from column 400 i) and gap columns: at s = 1 10% of the columns
    at random; at s > 1 (a speculative verify window) those rejected drafts
    leave (``rejected_gaps``) from column ``VERIFY_DECODE_START``, where
    every slot's prompt ends (the row cache's cursor is shared)."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    b, h, hkv, d, L, bound_cols = 8, 32, 8, 128, 8192, 4100
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    kc = torch.randn(b, L, hkv, d, generator=gen, device=dev).to(bf)
    vc = torch.randn(b, L, hkv, d, generator=gen, device=dev).to(bf)
    pos = torch.arange(bound_cols - s, bound_cols, dtype=torch.int32, device=dev)
    valid = torch.zeros(b, L, dtype=torch.bool, device=dev)
    for i in range(b):  # slot i's prompt starts further right: left padding
        valid[i, 400 * i: bound_cols] = True
    if s == 1:
        valid &= torch.rand(b, L, generator=gen, device=dev) > 0.1  # gap columns
    else:
        start = torch.full((b,), VERIFY_DECODE_START, device=dev)
        valid &= ~rejected_gaps(gen, start, L, bound_cols, s)
    return q, kc, vc, pos, valid


def decode_bound(q, valid, pos, bound_cols: int, hkv: int, extra_bytes: int = 0,
                 kv_bytes: int = 2):
    """(bound_ms, bound_by, bytes) of K4/K5 on these inputs: every row's
    live pairs (valid columns at or before its position), 4 D FLOPs each
    per q-head; the bytes of q, the K/V columns live for some row
    (``kv_bytes`` an element: 1 for K5q's int8 pages), the validity bytes
    up to the bound, out and lse, plus ``extra_bytes`` (K5's table
    entries; K5q's scales)."""
    b, s, h, d = q.shape
    cols = torch.arange(bound_cols, device=q.device)
    live = valid[:, None, :bound_cols] & (cols[None, None] <= pos[None, :, None].long())
    flops = 4.0 * d * h * int(live.sum())
    nbytes = (2 * q.numel() + 2 * kv_bytes * int(valid[:, :bound_cols].sum()) * hkv * d
              + b * bound_cols + 2 * q.numel() + 4 * b * s * h + extra_bytes)
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return bound, "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes", nbytes


def row_masks(valid, pos):
    """SDPA's boolean mask (B, 1, s, L) for K4/K5's inputs."""
    cols = torch.arange(valid.shape[1], device=valid.device)
    return valid[:, None, None, :] & (cols[None, :] <= pos[:, None].long())[None, None]


def check_k4(gen, s: int = 1):
    """K4 at decode shapes: 8 slots, L=8192, a 4100-column bound, kv_valid
    with gaps (left padding and invalid columns); s = 1 the plain decode
    step, s = 4 a speculative round's verify window (16 rows a kv-head)."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        flash_decode_plain,
    )

    hkv, bound_cols = 8, 4100
    q, kc, vc, pos, valid = k4_inputs(gen, s)
    out, lse = flash_decode_fwd(q, kc, vc, pos, valid)
    ref, ref_lse = flash_decode_plain(q, kc, vc, pos, valid)
    pv = flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    # what a kernel that skipped the last, partial 128-column tile (columns
    # 4096..4099) would return: the limit must fail it
    cut = valid.clone()
    cut[:, 4096:bound_cols] = False
    fault = flash_decode_plain(q, kc, vc, pos, cut)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K4_PV), tol_ratio(fault, ref, pv, K4_PV)
    tag = "K4" if s == 1 else f"K4 (verify window, s={s})"
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"{tag}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"{tag}: the output limit passes a dropped tile ({fault_ratio:.3g}x)")
    bound, bound_by, nbytes = decode_bound(q, valid, pos, bound_cols, hkv)
    ms = graph_ms(lambda: flash_decode_fwd(q, kc, vc, pos, valid), 20)
    eager_ms = cuda_ms(lambda: flash_decode_fwd(q, kc, vc, pos, valid), 50)
    plain_ms = cuda_ms(lambda: flash_decode_plain(q, kc, vc, pos, valid), 5, warmup=1)
    mask = row_masks(valid, pos)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    lib_ms = graph_ms(lib, 20)
    return dict(err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
                library_eager_ms=cuda_ms(lib, 50), live_cols=int(valid[:, :bound_cols].sum()),
                plan=dict(decode_plan(valid, bound_cols, hkv, 4 * s), bound_bytes=nbytes))


def k5_shapes(name: str, bound: int = 3109):
    """(slots, pool pages, live bound, per-slot valid column runs) of K5's
    two checks, page_size 16, L=8192. ``"k4"``: K4's shapes, 8 slots over
    the row-equivalent pool plus the null page, slot i valid from column
    400 i to the bound (gaps are added later). ``"serving"``: the paged
    serving phase's geometry, 16 slots over a 2049-page pool, the bound at
    3109 (mid tile): 12 chats of 100-400 columns and 3 documents of
    2000-3000 in the workload's order, each context from a page-aligned
    start right-aligned under the bound, then a gap, then the last 8 decode
    columns; slot 15 idle (no valid column, no page); ``bound`` moves the
    bound and every context with it. ``"serving64"``: those 16 slots four
    times over (64 slots, 8193 pages)."""
    import numpy as np

    if name == "k4":
        return 8, 8 * 512 + 1, 4100, [[(400 * i, 4100)] for i in range(8)]
    if name == "serving64":  # the serving geometry's 16 slots four times over
        b, n_pages, bound, runs = k5_shapes("serving")
        return 4 * b, 4 * (n_pages - 1) + 1, bound, runs * 4
    rng = np.random.default_rng(3)
    chats = [int(n) for n in rng.integers(100, 401, size=12)]
    docs = [int(n) for n in rng.integers(2000, 3001, size=3)]
    lens = []
    for i, n in enumerate(chats):
        lens.append(n)
        if i % 4 == 3:
            lens.append(docs[i // 4])
    runs = []
    for n in lens:
        lo = (bound - 8 - n) // 16 * 16
        runs.append([(lo, lo + n), (bound - 8, bound)])
    return 16, 2049, bound, runs + [[]]


def k5_inputs(gen, shapes: str, s: int = 1, bound: int = 3109):
    """``check_k5``'s inputs at ``k5_shapes(shapes)``: q, the pools (page 0
    scaled by 64), the block table, the positions ``bound - s .. bound - 1``
    and kv_valid. At s > 1 (a speculative verify window, serving shapes) a
    slot's columns from its context's end to the bound are its decode
    columns, with the gaps rejected drafts leave (``rejected_gaps``)."""
    import numpy as np

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, n_pages, bound_cols, runs = k5_shapes(shapes, bound)
    h, hkv, d, L, ps = 32, 8, 128, 8192, 16
    n_log = L // ps
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    kp = torch.randn(n_pages, ps, hkv, d, generator=gen, device=dev).to(bf)
    vp = torch.randn(n_pages, ps, hkv, d, generator=gen, device=dev).to(bf)
    kp[0].mul_(64.0)
    vp[0].mul_(64.0)
    pos = torch.arange(bound_cols - s, bound_cols, dtype=torch.int32, device=dev)
    valid = torch.zeros(b, L, dtype=torch.bool, device=dev)
    if s > 1:  # each context runs on into its decode columns, up to the bound
        runs = [[(r[0][0], bound_cols)] if r else [] for r in runs]
    perm = iter(np.random.default_rng(5).permutation(np.arange(1, n_pages)).tolist())
    table = np.zeros((b, n_log), np.int32)
    for i, slot_runs in enumerate(runs):
        for lo, hi in slot_runs:
            valid[i, lo:hi] = True
        if slot_runs:
            for j in range(slot_runs[0][0] // ps, -(-bound_cols // ps)):
                table[i, j] = next(perm)
    if s > 1:
        ends = [r[0][1] if r else bound_cols for r in k5_shapes(shapes, bound)[3]]
        valid &= ~rejected_gaps(gen, torch.tensor(ends, device=dev), L, bound_cols, s)
    elif shapes == "k4":
        valid &= torch.rand(b, L, generator=gen, device=dev) > 0.1  # gap columns
    return q, kp, vp, torch.from_numpy(table).to(dev), pos, valid


def check_k5(gen, shapes: str, timed: bool, s: int = 1):
    """K5 at ``k5_shapes(shapes)`` with ``s`` query tokens (4: a
    speculative round's verify window): each slot's logical pages from its
    first valid column's page through the bound's map to a numpy-seeded
    random permutation of pool pages; its unmapped pages (left padding,
    past the bound, an idle slot's) to page 0, which holds random garbage.
    At K4's shapes ``kv_valid`` also has random gaps, as in ``check_k4``;
    at s > 1 the gaps of rejected drafts."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        paged_flash_decode_fwd,
        paged_flash_decode_plain,
        paged_gather_leaf,
    )

    b, n_pages, bound_cols, _ = k5_shapes(shapes)
    hkv, ps = 8, 16
    q, kp, vp, bt, pos, valid = k5_inputs(gen, shapes, s)
    table = bt.cpu().numpy()
    out, lse = paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    again, again_lse = paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    kg, vg = paged_gather_leaf(kp, bt, ps), paged_gather_leaf(vp, bt, ps)
    row, row_lse = flash_decode_fwd(q, kg, vg, pos, valid)
    kp0, vp0 = kp[0].clone(), vp[0].clone()
    kp[0].normal_(generator=gen).mul_(-300.0)
    vp[0].normal_(generator=gen).mul_(300.0)
    other, other_lse = paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    kp[0], vp[0] = kp0, vp0
    ref, ref_lse = paged_flash_decode_plain(q, kp, vp, bt, pos, valid, ps)
    pv = paged_flash_decode_plain(q, kp, vp.abs(), bt, pos, valid, ps)[0]
    # what a kernel that skipped the last, partial 128-column tile would
    # return: the limit must fail it
    cut = valid.clone()
    cut[:, (bound_cols - 1) // 128 * 128:bound_cols] = False
    fault = paged_flash_decode_plain(q, kp, vp, bt, pos, cut, ps)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K4_PV), tol_ratio(fault, ref, pv, K4_PV)
    tag = f"K5 ({shapes} shapes{'' if s == 1 else f', verify window, s={s}'})"
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"{tag}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"{tag}: the output limit passes a dropped tile ({fault_ratio:.3g}x)")
    if not (torch.equal(out, row) and torch.equal(lse, row_lse)):
        raise AssertionError(f"{tag} differs from K4 on the gathered view (must be bitwise equal)")
    if not (torch.equal(out, other) and torch.equal(lse, other_lse)):
        raise AssertionError(f"{tag}: the output depends on the null page's content")
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{tag}: two runs differ in their bits")
    # the table entries up to the bound besides what K4 must move
    bound, bound_by, nbytes = decode_bound(q, valid, pos, bound_cols, hkv,
                                           extra_bytes=4 * b * -(-bound_cols // ps))
    res = dict(err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio, bound_ms=bound,
               bound_by=bound_by, slots=b, pages=n_pages, bound_cols=bound_cols,
               mapped=int((table != 0).sum()), live_cols=int(valid[:, :bound_cols].sum()))
    res["ms"] = graph_ms(lambda: paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps), 20)
    res["eager_ms"] = cuda_ms(lambda: paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps), 50)
    res["plan"] = dict(decode_plan(valid, bound_cols, hkv, 4 * s, ps), bound_bytes=nbytes)
    if not timed:
        return res
    res["plain_ms"] = cuda_ms(lambda: paged_flash_decode_plain(q, kp, vp, bt, pos, valid, ps), 5,
                              warmup=1)
    res["gather_ms"] = cuda_ms(lambda: (paged_gather_leaf(kp, bt, ps),
                                        paged_gather_leaf(vp, bt, ps)), 20)
    mask = row_masks(valid, pos)
    qt, kt, vt = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    res["library_ms"] = graph_ms(lib, 20)
    return res


def check_k5q(gen, shapes: str) -> dict:
    """K5q at ``k5_shapes(shapes)``: ``k5_inputs``' pools quantized to int8
    pages with a bf16 scale per (page, kv-head) (``quantize_page_block``;
    the null page's codes and scales garbage too), against its plain
    version within K5's limits (a dropped tile must fail them), bitwise
    equal to K4 on the dequantized gathered view, blind to the null page,
    the same bits twice and over three CUDA-graph replays in a row, O = 0
    and LSE -1e30 for a slot with no
    live column; its time (graph replay: the pages stay in L2) and its
    ``cold_ms`` (graph replays cycling over ``K5Q_COLD_COPIES`` copies of the
    pools, more bytes than L2 holds, as a serving step's 32 layers read
    theirs), beside SDPA on the dequantized gathered view and the
    gather-dequantize's own time, and its bytes bound (int8 K/V, the table
    and the scales of live pages)."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        paged_flash_decode_fwd,
        paged_flash_decode_plain_q,
        paged_gather_leaf_dequant,
        quantize_page_block,
    )

    b, n_pages, bound_cols, runs = k5_shapes(shapes)
    hkv, ps = 8, 16
    q, kp, vp, bt, pos, valid = k5_inputs(gen, shapes)
    (kq, ks), (vq, vs) = quantize_page_block(kp), quantize_page_block(vp)
    del kp, vp
    run = lambda: paged_flash_decode_fwd(q, kq, vq, bt, pos, valid, ps, ks, vs)  # noqa: E731
    out, lse = run()
    again, again_lse = run()
    kg, vg = paged_gather_leaf_dequant(kq, ks, bt, ps), paged_gather_leaf_dequant(vq, vs, bt, ps)
    row, row_lse = flash_decode_fwd(q, kg, vg, pos, valid)
    saved = [t[0].clone() for t in (kq, vq, ks, vs)]
    kq[0].random_(-127, 128, generator=gen)
    vq[0].random_(-127, 128, generator=gen)
    ks[0].normal_(generator=gen).mul_(300.0)
    vs[0].normal_(generator=gen).mul_(-300.0)
    other, other_lse = run()
    for t, x in zip((kq, vq, ks, vs), saved):
        t[0] = x
    ref, ref_lse = paged_flash_decode_plain_q(q, kq, vq, ks, vs, bt, pos, valid, ps)
    pv = paged_flash_decode_plain_q(q, kq, vq.abs(), ks, vs, bt, pos, valid, ps)[0]
    cut = valid.clone()
    cut[:, (bound_cols - 1) // 128 * 128:bound_cols] = False
    fault = paged_flash_decode_plain_q(q, kq, vq, ks, vs, bt, pos, cut, ps)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K4_PV), tol_ratio(fault, ref, pv, K4_PV)
    tag = f"K5q ({shapes} shapes)"
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"{tag}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"{tag}: the output limit passes a dropped tile ({fault_ratio:.3g}x)")
    if not (torch.equal(out, row) and torch.equal(lse, row_lse)):
        raise AssertionError(f"{tag} differs from K4 on the dequantized gathered view (must be "
                             "bitwise equal)")
    if not (torch.equal(out, other) and torch.equal(lse, other_lse)):
        raise AssertionError(f"{tag}: the output depends on the null page's content")
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{tag}: two runs differ in their bits")
    replays = graph_replays(run, 3)
    if not all(torch.equal(o, out) and torch.equal(x, lse) for o, x in replays):
        raise AssertionError(f"{tag}: three graph replays differ from the eager call's bits")
    dead = [i for i, r in enumerate(runs) if not r]  # slots with no live column
    if dead and (out[dead].any() or not bool((lse[dead] == -1e30).all())):
        raise AssertionError(f"{tag}: a slot with no live column has O != 0 or LSE != -1e30")
    pages_live = int(torch.nn.functional.pad(valid[:, :bound_cols], (0, -bound_cols % ps))
                     .reshape(b, -1, ps).any(-1).sum())
    bound, bound_by, nbytes = decode_bound(
        q, valid, pos, bound_cols, hkv, kv_bytes=1,
        extra_bytes=4 * b * -(-bound_cols // ps) + 2 * 2 * hkv * pages_live)
    mask = row_masks(valid, pos)
    qt, kt, vt = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    return dict(err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio, bound_ms=bound,
                bound_by=bound_by, bytes=nbytes, slots=b, pages=n_pages, bound_cols=bound_cols,
                dead=len(dead), ms=graph_ms(run, 20), eager_ms=cuda_ms(run, 50),
                cold_ms=k5q_cold_ms(q, kq, vq, ks, vs, bt, pos, valid, ps),
                plain_ms=cuda_ms(lambda: paged_flash_decode_plain_q(
                    q, kq, vq, ks, vs, bt, pos, valid, ps), 5, warmup=1),
                gather_ms=cuda_ms(lambda: (paged_gather_leaf_dequant(kq, ks, bt, ps),
                                           paged_gather_leaf_dequant(vq, vs, bt, ps)), 20),
                library_ms=graph_ms(lib, 20), live_cols=int(valid[:, :bound_cols].sum()))


QW_COL = 3109  # a decode step's column: the paged serving geometry's bound, mid-page


def qw_case(gen, rows: slice, s: int, col: int, b: int, used: int = 200):
    """QW's inputs at phase 5f(c)'s pool geometry: an int8 pool (bf16 scales,
    8 kv-heads, page_size 16, L = 8192) of ``b`` slots x ``used`` pages
    behind a numpy-seeded scrambled table (the rest of each row unmapped),
    random pages; the view of slots ``rows`` at column ``col`` with ``s``
    columns addressed, and new rows k, v: the first row's 50x (its page's
    absmax rises); the pool rows under the second row's columns 50x before
    they are quantized (its page's absmax falls). Returns (cache, view,
    table, k, v)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.kernels.flash_decode import quantize_page_block
    from neuronx_distributed_tpu_torch.modules.attention import PagedKVCache

    hkv, d, ps, L = 8, 128, PAGE, 8192
    n_pages = b * used + 1
    cache = PagedKVCache.allocate(1, b, L, hkv, d, torch.bfloat16, "cuda", n_pages, ps,
                                  kv_quant="int8")
    table = np.zeros((b, L // ps), np.int32)
    table[:, :used] = np.random.default_rng(col).permutation(np.arange(1, n_pages)).reshape(b, used)
    first = rows.start or 0
    for pool, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        x = torch.randn(n_pages, ps, hkv, d, generator=gen, device="cuda")
        if rows.stop is None or rows.stop - first > 1:
            for c in range(col, col + s):
                x[int(table[first + 1, c // ps]), c % ps] *= 50.0
        q, sc = quantize_page_block(x.to(torch.bfloat16))
        pool[0].copy_(q)
        scale[0].copy_(sc)
    cache.upload_table(table)
    view = cache.view(rows, col)
    view._address(view._cols[:s])
    nb = len(range(b)[rows])
    k = torch.randn(nb, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(nb, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    k[0].mul_(50.0)
    v[0].mul_(50.0)
    return cache, view, table, k, v


def check_qw(gen) -> dict:
    """QW at phase 5f(c)'s geometry: a decode step's write (16 slots, s = 1,
    column ``QW_COL``) and a 300-token prefill window from mid-page (one
    slot's view at column 45), each bitwise equal to its plain version on
    every page but the null page, with one page's absmax rising and one's
    falling; the decode write's time (graph replay, K and V of one layer)
    against its bound (each window page's codes and scale read and written
    once, the rows read once), and the plain version's. No single PyTorch
    call computes it."""
    from neuronx_distributed_tpu_torch.kernels.kv_quant import (
        window_requantize_fwd,
        window_requantize_plain,
    )

    res = {}
    for name, rows, s, col in (("decode", slice(None), 1, QW_COL),
                               ("prefill", slice(0, 1), 300, 45)):
        cache, view, table, k, v = qw_case(gen, rows, s, col, PAGED_SLOTS)
        pages, w0 = view._win
        leaves = (cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0])
        want = [t.clone() for t in leaves]
        before = [t.clone() for t in leaves]
        window_requantize_plain(*want, pages, w0, k, v)
        n = window_requantize_fwd.launches
        view.decode_write(0, k, v)
        torch.cuda.synchronize()
        if window_requantize_fwd.launches != n + 1:
            raise AssertionError(f"QW ({name}): {window_requantize_fwd.launches - n} launches a write")
        if not all(torch.equal(t[1:], w[1:]) for t, w in zip(leaves, want)):
            raise AssertionError(f"QW ({name}) differs from its plain version (must be bitwise "
                                 "equal on every page but the null page)")
        first = rows.start or 0
        ks, ks0 = leaves[2].float(), before[2].float()
        rise = int(table[first, col // PAGE])
        if not bool((ks[rise] > 2 * ks0[rise]).all()):
            raise AssertionError(f"QW ({name}): page {rise}'s scale did not rise")
        if name == "decode":
            fall = int(table[1, col // PAGE])
            if not bool((ks[fall] < 0.5 * ks0[fall]).all()):
                raise AssertionError(f"QW ({name}): page {fall}'s scale did not fall")
        b, n_win = pages.shape
        nbytes = qw_bytes(k, n_win)
        res[name] = dict(slots=b, s=s, col=col, n_win=n_win, bytes=nbytes,
                         bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes")
        res[name]["ms"] = graph_ms(lambda: view.decode_write(0, k, v), 20)
        if name == "decode":
            res[name]["plain_ms"] = cuda_ms(lambda: window_requantize_plain(*want, pages, w0, k, v),
                                            5, warmup=1)
        del cache, view
        torch.cuda.empty_cache()
    return res


def qw_bytes(k, n_win: int) -> int:
    """QW's bytes for new rows ``k`` (B, s, Hkv, D) and ``n_win`` window
    pages a row, each leaf: a window page's codes written and its scale
    read and written, its old codes read only in the rows the new ones do
    not replace; the new rows, the pages and the first column read once."""
    b, s, hkv, d = k.shape
    kept = n_win * PAGE - s
    return (2 * b * hkv * (n_win * (PAGE * d + 2 * 2) + kept * d) + 2 * k.numel() * 2
            + 8 * b * n_win + 8)


WRITE_ATTEND_CASES = (("decode", 1, 3109),  # 5f(c)'s decode step: the serving geometry
                      # the verify window (s = gamma, R = 16, rejected drafts'
                      # gaps) across a page and a 256-column range: each of
                      # its two pages has its own owner
                      ("verify", 4, 3074))


def write_attend_case(gen, s: int, bound: int):
    """K5q with the write's inputs at the paged serving geometry
    (``k5_inputs(gen, "serving", s, bound)``: 16 slots, page_size 16, slot
    15 idle, its window the null page), the pools quantized
    (``quantize_page_block``) after the rows under slot 1's window columns
    were scaled 50x (its page's absmax falls); the new rows k, v (16, s, 8,
    128) at columns ``bound - s .. bound - 1``, slot 0's 50x (its page's
    absmax rises). Returns (cache, view, q, k, v, pos, valid): an int8
    ``PagedKVCache`` over the pools and table, and its view at the first
    new column with ``s`` columns addressed."""
    from neuronx_distributed_tpu_torch.kernels.flash_decode import quantize_page_block
    from neuronx_distributed_tpu_torch.modules.attention import PagedKVCache

    q, kp, vp, bt, pos, valid = k5_inputs(gen, "serving", s, bound)
    b, L = valid.shape
    col = bound - s
    for c in range(col, bound):
        page = int(bt[1, c // PAGE])
        kp[page, c % PAGE] *= 50.0
        vp[page, c % PAGE] *= 50.0
    cache = PagedKVCache.allocate(1, b, L, 8, 128, torch.bfloat16, "cuda", kp.shape[0], PAGE,
                                  kv_quant="int8")
    for pool, scale, x in ((cache.k, cache.k_scale, kp), (cache.v, cache.v_scale, vp)):
        codes, sc = quantize_page_block(x)
        pool[0].copy_(codes)
        scale[0].copy_(sc)
    del kp, vp
    cache.block_table.copy_(bt)
    cache.valid.copy_(valid)
    view = cache.view(slice(None), col)
    view._address(view._cols[:s])
    k = torch.randn(b, s, 8, 128, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, s, 8, 128, generator=gen, device="cuda").to(torch.bfloat16)
    k[0].mul_(50.0)
    v[0].mul_(50.0)
    return cache, view, q, k, v, pos, valid


def check_write_attend(gen) -> dict:
    """K5q with the write (``qpaged_write_attend_fwd``) against QW then K5q,
    both on the card, on ``write_attend_case``'s inputs (the bound) for each of
    ``WRITE_ATTEND_CASES``: the pools and scales bit for bit on every page
    but the null page (which this route does not write), out and lse bit
    for bit; the same check must fail two broken variants on a copy of the
    inputs: one that skips the write (K5q on the old pools) and one that
    attends the stale codes (QW's pools, K5q's output on the old ones).
    Times (graph replays): the fused launch, K5q alone on the written pools,
    QW + K5q in one graph; the bound: K5q's bytes (int8 K/V columns, the
    table up to the bound, the live pages' scales) plus QW's (``qw_bytes``),
    each once."""
    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        paged_flash_decode_plain_q,
        qpaged_flash_decode_fwd,
        qpaged_write_attend_fwd,
        qpaged_write_attend_plain,
    )
    from neuronx_distributed_tpu_torch.kernels.kv_quant import window_requantize_fwd

    res = {}
    for name, s, bound_cols in WRITE_ATTEND_CASES:
        cache, view, q, k, v, pos, valid = write_attend_case(gen, s, bound_cols)
        leaves = (cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0])
        bt, w0 = cache.block_table, view._c0
        base = [t.clone() for t in leaves]

        def two():  # QW, then K5q: the two-launch route
            view.decode_write(0, k, v)
            return qpaged_flash_decode_fwd(q, *leaves, bt, pos, valid, PAGE)

        def fused():
            return qpaged_write_attend_fwd(q, k, v, *leaves, bt, pos, valid, w0, PAGE)

        def restore():
            for t, x in zip(leaves, base):
                t.copy_(x)

        def mismatches(pools, out, lse):
            bad = [n for n, t, w in zip(("k", "v", "k_scale", "v_scale"), pools, want)
                   if not torch.equal(t[1:], w[1:])]
            return bad + [n for n, t, w in (("out", out, want_out), ("lse", lse, want_lse))
                          if not torch.equal(t, w)]

        want_out, want_lse = two()
        want = [t.clone() for t in leaves]
        restore()
        n, nq = qpaged_write_attend_fwd.launches, qpaged_flash_decode_fwd.launches
        nw = window_requantize_fwd.launches
        out, lse = fused()
        torch.cuda.synchronize()
        if (qpaged_write_attend_fwd.launches - n, qpaged_flash_decode_fwd.launches - nq,
                window_requantize_fwd.launches - nw) != (1, 1, 0):
            raise AssertionError(f"K5q with the write ({name}): launches counted wrong")
        bad = mismatches(leaves, out, lse)
        if bad:
            raise AssertionError(f"K5q with the write ({name}) differs from QW then K5q in {bad} "
                                 "(must be bitwise equal on every page but the null page)")
        # the plain version on the same inputs, within K5q's limit
        plain = [x.clone() for x in base]
        ref, ref_lse = qpaged_write_attend_plain(q, k, v, *plain, bt, pos, valid, w0, PAGE)
        if not all(torch.equal(t[1:], w[1:]) for t, w in zip(plain, want)):
            raise AssertionError(f"K5q with the write ({name}): its plain version's pools differ")
        pv = paged_flash_decode_plain_q(q, want[0], want[1].abs(), want[2], want[3], bt, pos,
                                        valid, PAGE)[0]
        ratio = tol_ratio(out, ref, pv, K4_PV)
        lerr = max_err(lse, ref_lse)
        if not (ratio <= 1.0 and lerr <= LSE_TOL):
            raise AssertionError(f"K5q with the write ({name}): {ratio:.3g}x its limit against "
                                 f"its plain version, |lse err| {lerr}")
        # the broken variants, on a copy of the inputs
        copy = [x.clone() for x in base]
        skip = mismatches(copy, *qpaged_flash_decode_fwd(q, *copy, bt, pos, valid, PAGE))
        stale_out = qpaged_flash_decode_fwd(q, *copy, bt, pos, valid, PAGE)
        window_requantize_fwd(*copy, *view._win, k, v)
        stale = mismatches(copy, *stale_out)
        if not skip or not stale:
            raise AssertionError(f"K5q with the write ({name}): the check passes a variant that "
                                 f"skips the write ({skip}) or attends the stale codes ({stale})")
        restore()
        fused_ms = graph_ms(fused, 20)
        two_ms = graph_ms(two, 20)
        k5q_ms = graph_ms(lambda: qpaged_flash_decode_fwd(q, *leaves, bt, pos, valid, PAGE), 20)
        b, hkv = q.shape[0], k.shape[2]
        pages_live = int(valid.reshape(b, -1, PAGE).any(-1).sum())
        n_win = view._win[0].shape[1]
        qwb = qw_bytes(k, n_win)
        bound, bound_by, nbytes = decode_bound(
            q, valid, pos, bound_cols, hkv, kv_bytes=1,
            extra_bytes=4 * b * -(-bound_cols // PAGE) + 2 * 2 * hkv * pages_live + qwb)
        ks, ks0 = want[2].float(), base[2].float()
        rise, fall = (int(cache.block_table[i, (bound_cols - 1) // PAGE]) for i in (0, 1))
        if not (bool((ks[rise] > 2 * ks0[rise]).all()) and bool((ks[fall] < 0.5 * ks0[fall]).all())):
            raise AssertionError(f"K5q with the write ({name}): page {rise}'s scale did not rise or "
                                 f"page {fall}'s did not fall")
        res[name] = dict(slots=b, s=s, rows=4 * s, col=bound_cols - s, n_win=n_win, ms=fused_ms,
                         k5q_ms=k5q_ms, qw_k5q_ms=two_ms, bound_ms=bound, bound_by=bound_by,
                         bytes=nbytes, qw_bytes=qwb, ratio=ratio, err=max(max_err(out, ref), lerr),
                         broken=dict(skip=skip, stale=stale),
                         plain_ms=cuda_ms(lambda: qpaged_write_attend_plain(
                             q, k, v, *plain, bt, pos, valid, w0, PAGE), 5, warmup=1))
        del cache, view
        torch.cuda.empty_cache()
    return res


K5Q_COLD_COPIES = 6  # pools K5q's cold time cycles over: 6 x 21 MB live at the serving geometry


def k5q_cold_ms(q, kq, vq, ks, vs, bt, pos, valid, ps) -> float:
    """K5q's time a call with its pages read from device memory: one graph
    of 4 rounds over ``K5Q_COLD_COPIES`` copies of the pools and scales
    (the same table), replayed, over the calls."""
    from neuronx_distributed_tpu_torch.kernels.flash_decode import paged_flash_decode_fwd

    copies = [tuple(t.clone() for t in (kq, vq, ks, vs)) for _ in range(K5Q_COLD_COPIES - 1)]
    copies.append((kq, vq, ks, vs))
    ms = graph_ms(lambda: [paged_flash_decode_fwd(q, k, v, bt, pos, valid, ps, a, c)
                           for k, v, a, c in copies], 4) / len(copies)
    del copies
    torch.cuda.empty_cache()
    return ms


def check_dq(gen) -> dict:
    """DQ at lm_head's shape (128256 x 4096): a bf16 weight from ``gen``
    quantized per output channel to int8 and to fp8 e4m3
    (``quantize_state_dict``'s rule), DQ bitwise equal to its plain version
    on both; its time (graph replay) against its bound, 3 bytes a weight
    (1 read, 2 written), the plain version's, and for int8 that of one
    ``torch.mul(q, scale[:, None], out=bf16)``, held bitwise to the plain
    version too."""
    from neuronx_distributed_tpu_torch.kernels.dequantize import dequantize_fwd, dequantize_plain
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.quantization.utils import direct_cast_quantize

    w = (torch.randn(128256, 4096, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    res = {}
    for kind in ("int8", "fp8"):
        q, scale = direct_cast_quantize(w, QuantConfig(weights=kind).weight_qconfig())
        scale = scale.reshape(-1)
        got = dequantize_fwd(q, scale, torch.bfloat16)
        if not torch.equal(got, dequantize_plain(q, scale[:, None], torch.bfloat16)):
            raise AssertionError(f"DQ ({kind}) differs from its plain version (must be bitwise equal)")
        del got
        res[kind] = dict(ms=graph_ms(lambda: dequantize_fwd(q, scale, torch.bfloat16), 10),
                         plain_ms=cuda_ms(lambda: dequantize_plain(q, scale[:, None],
                                                                   torch.bfloat16), 5, warmup=1),
                         err=0.0, library_ms=None)
        if kind == "int8":
            # one TensorIterator call: int8 x f32 promotes to f32 and casts
            # to the bf16 out inside the kernel; torch refuses to promote
            # fp8 with f32, so the fp8 row has no such call
            buf = torch.empty_like(q, dtype=torch.bfloat16)
            lib = lambda: torch.mul(q, scale[:, None], out=buf)  # noqa: E731
            lib()
            if not torch.equal(buf, dequantize_plain(q, scale[:, None], torch.bfloat16)):
                raise AssertionError("torch.mul(int8, f32, out=bf16) differs from DQ's plain "
                                     "version (expected bitwise equal)")
            res[kind]["library_ms"] = graph_ms(lib, 10)
            del buf
        del q
        torch.cuda.empty_cache()
    nbytes = 3 * w.numel() + 4 * w.shape[0]
    res.update(bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes", bytes=nbytes,
               shape=tuple(w.shape))
    return res


PF_PAGES = 100  # pages a phase 5c hit maps: its 1600-token system prompt at page 16


def pf_leaves(gen, int8: bool) -> list:
    """A pool at phase 5b's geometry (32 layers, 2049 pages of 16 columns,
    Hkv 8, D 128, bf16 K and V) or phase 5f(c)'s int8 pool of the same
    bytes (4094 pages, a bf16 scale a page and kv-head), filled from
    ``gen``; the leaves in PF's order (K, K scale, V, V scale)."""
    layers, hkv, d = 32, 8, 128
    bf16_page = 2 * layers * PAGE * hkv * d * 2
    pages = ROW_SLOTS * 8192 // PAGE + 1
    if not int8:
        return [torch.randn(layers, pages, PAGE, hkv, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2)]
    pages = pages * bf16_page // (2 * layers * (PAGE * hkv * d + hkv * 2))
    codes = [torch.randint(-127, 128, (layers, pages, PAGE, hkv, d), generator=gen,
                           device="cuda", dtype=torch.int8) for _ in range(2)]
    scales = [(torch.rand(layers, pages, 1, hkv, 1, generator=gen, device="cuda") * 0.02)
              .to(torch.bfloat16) for _ in range(2)]
    return [codes[0], scales[0], codes[1], scales[1]]


def check_pf(gen) -> dict:
    """PF at phase 5b's bf16 pool and phase 5f(c)'s int8 pool: the
    fingerprints of 100 pages given in scrambled order equal the plain
    version's bit for bit; flipping one bit of one page moves that page's
    value and no other; timed as a CUDA-graph replay against its bytes
    bound (each page of each leaf read once, the ids read, the values
    written)."""
    from neuronx_distributed_tpu_torch.kernels.page_fingerprint import (
        pool_pages_fingerprint_fwd,
        pool_pages_fingerprint_plain,
    )
    from neuronx_distributed_tpu_torch.utils.fingerprint import jax_layer_order

    res = {}
    for kind in ("bf16", "int8"):
        leaves = pf_leaves(gen, kind == "int8")
        pages = leaves[0].shape[1]
        ids = (torch.randperm(pages - 1, generator=gen, device="cuda")[:PF_PAGES] + 1)
        order = jax_layer_order(leaves[0].shape[0])
        got = pool_pages_fingerprint_fwd(leaves, ids, order)
        want = pool_pages_fingerprint_plain(leaves, ids, order)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"PF ({kind} pool) differs from its plain version at {bad} of "
                                 f"{PF_PAGES} pages (must be bitwise equal)")
        victim = int(ids[37])
        v = leaves[len(leaves) // 2]  # V (codes on the int8 pool)
        v.view(torch.uint8)[17, victim].reshape(-1)[4321] ^= 8
        moved = (pool_pages_fingerprint_fwd(leaves, ids, order) != got).tolist()
        if moved != [i == 37 for i in range(PF_PAGES)]:
            raise AssertionError(f"PF ({kind} pool): one flipped bit moved pages "
                                 f"{[i for i, m in enumerate(moved) if m]}, want [37]")
        nbytes = sum(t[:, 0].numel() * t.element_size() for t in leaves) * PF_PAGES + 16 * PF_PAGES
        res[kind] = dict(ms=graph_ms(lambda: pool_pages_fingerprint_fwd(leaves, ids, order), 10),
                         plain_ms=cuda_ms(lambda: pool_pages_fingerprint_plain(leaves, ids, order),
                                          2, warmup=1),
                         bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes", bytes=nbytes,
                         pages=pages)
        del leaves, got, want
        torch.cuda.empty_cache()
    return res


ROWS_PREFIX, ROWS_PADDED = 1600, 2048  # phase 5c's shared prompt and its prefill bucket


MX_E, MX_H, MX_I, MX_TOPK = 8, 4096, 14336, 2  # Mixtral-8x7B's expert shapes
MX_CASES = (("random", 8), ("random", 1), ("skewed", 8), ("untouched", 8))
MX_UNTOUCHED = 5  # the expert no pair routes to in the "untouched" case
# MX/MXq's CUDA kernels by name (the two products', the combine's and, for
# codes, the input permute's), for the profiles' device time by family
MX_KERNELS = ("routed_mma_kernel", "moe_combine_kernel", "moe_permute_kernel")


def mx_routes(gen, case: str, t: int):
    """``(top_e, top_w)`` of ``t`` tokens, top-2 of 8: "random" (two
    distinct experts a token), "skewed" (every pair on expert 3: a token's
    two slots on one expert, 2t pairs on it) or "untouched" (random over
    the experts but MX_UNTOUCHED)."""
    if case == "skewed":
        top_e = torch.full((t, MX_TOPK), 3, dtype=torch.int64, device="cuda")
    else:
        pool = MX_E - (case == "untouched")
        top_e = torch.rand(t, pool, generator=gen, device="cuda").argsort(-1)[:, :MX_TOPK]
        if case == "untouched":
            top_e = top_e + (top_e >= MX_UNTOUCHED).long()
    w = torch.rand(t, MX_TOPK, generator=gen, device="cuda") + 0.1
    return top_e, w / w.sum(-1, keepdim=True)


def mx_weights(gen) -> dict:
    """Mixtral-8x7B's expert stacks of one layer from ``gen`` (torch's (E,
    out, in), N(0, 1/fan_in)) in bf16, and quantized per expert and output
    channel to int8 and fp8 (``quantize_weight``, the rule of
    ``quantize_state_dict``)."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.quantization.utils import quantize_weight

    out = {"bf16": {}, "int8": {}, "fp8": {}}
    for name, shape in (("gate", (MX_E, MX_I, MX_H)), ("up", (MX_E, MX_I, MX_H)),
                        ("down", (MX_E, MX_H, MX_I))):
        w = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        w.normal_(0.0, 1.0 / math.sqrt(shape[-1]), generator=gen)
        out["bf16"][name] = w
        for kind in ("int8", "fp8"):
            q, s = quantize_weight(w, QuantConfig(weights=kind).weight_qconfig())
            out[kind][name], out[kind][name + "_scale"] = q, s
    return out


def mx_args(ws: dict) -> tuple:
    return (ws["gate"], ws["up"], ws["down"], ws.get("gate_scale"), ws.get("up_scale"),
            ws.get("down_scale"))


def mx_ratio(got, ref, limit) -> float:
    return float(((got.float() - ref.float()).abs() / limit).max())


@contextlib.contextmanager
def f32_reductions():
    """bf16 products of the plain versions accumulate in f32 throughout
    (no reduced-precision split-K reduction), as the kernel does."""
    old = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = old


def mx_stage_check(x, top_e, top_w, ws: dict) -> dict:
    """MX/MXq against the plain version, stage by stage, with limits that
    bound what the two sides may differ by (the same bf16 rounding points;
    f32 sums in other orders: at most 2 n 2^-24 of the sum of |terms| over
    n terms, 2^-11 for H = 4096, 2^-9 for I = 14336; a bf16 rounding that
    then lands one ulp apart, 2^-8 relative, up to three such in the
    SwiGLU):
    act (the SwiGLU activations) <= 2^-6 |act| + 2^-11 (1.1 |u| G + |s| U)
    with G, U the sums of |x||gate|, |x||up| and s = silu(g); y (each pair's
    down output, against the plain product of the kernel's own act) <= 2^-8
    |y| + 2^-9 D, D the sum of |act||down|; out <= 2^-7 |out| + 2^-9 sum_j
    |w_j| D_j (D from the plain act). A dropped act tile (16 rows of one
    expert), a dropped down tile (32 rows) and a dropped pair each must read
    above 1."""
    from neuronx_distributed_tpu_torch.kernels import moe_experts as mx

    dt = torch.bfloat16
    gate, up, down, gs, us, ds = mx_args(ws)
    t, k = top_e.shape
    out, act, y = mx._kernel_call(x, top_e, top_w, gate, up, down, gs, us, ds)
    act, y = act.reshape(t, k, MX_I), y.reshape(t, k, MX_H)
    with f32_reductions():
        G = mx.gathered(gate, gs, top_e, dt)
        g = torch.einsum("th,tkih->tki", x, G)
        Gm = torch.einsum("th,tkih->tki", x.float().abs(), G.float().abs())
        del G
        U = mx.gathered(up, us, top_e, dt)
        u = torch.einsum("th,tkih->tki", x, U)
        Um = torch.einsum("th,tkih->tki", x.float().abs(), U.float().abs())
        del U
        s = torch.nn.functional.silu(g)
        act_ref = s * u
        D = mx.gathered(down, ds, top_e, dt)
        y_ref = torch.einsum("tki,tkhi->tkh", act_ref, D)
        y_own = torch.einsum("tki,tkhi->tkh", act, D)
        Df = D.float().abs()
        del D
        Md_own = torch.einsum("tki,tkhi->tkh", act.float().abs(), Df)
        Md_ref = torch.einsum("tki,tkhi->tkh", act_ref.float().abs(), Df)
        del Df
        out_ref = torch.einsum("tkh,tk->th", y_ref, top_w.to(dt))
        plain = mx.moe_experts_plain(x, top_e, top_w, gate, up, down, gs, us, ds)
    if not torch.equal(plain, out_ref):
        raise AssertionError("moe_experts_plain differs from its own stages")
    lim_act = (2.0 ** -6 * act_ref.float().abs() + 2.0 ** -11 * (
        1.1 * u.float().abs() * Gm + s.float().abs() * Um) + 1e-6)
    lim_y = 2.0 ** -8 * y_own.float().abs() + 2.0 ** -9 * Md_own + 1e-6
    wb = top_w.to(dt).float().abs()
    lim_out = 2.0 ** -7 * out_ref.float().abs() + 2.0 ** -9 * torch.einsum(
        "tk,tkh->th", wb, Md_ref) + 1e-5
    act_fault = act.clone()
    act_fault[0, 0, 16:32] = 0  # one 16-row tile of the first pair's expert dropped
    y_fault = y.clone()
    y_fault[0, 0, 32:64] = 0  # one 32-row down tile dropped
    out_fault = out_ref.float() - top_w[0, 0].to(dt).float() * y_ref[0, 0].float()
    return dict(
        out=out, err=max_err(out, out_ref), ratio=mx_ratio(out, out_ref, lim_out),
        act_ratio=mx_ratio(act, act_ref, lim_act), y_ratio=mx_ratio(y, y_own, lim_y),
        act_fault=mx_ratio(act_fault, act_ref, lim_act),
        y_fault=mx_ratio(y_fault, y_own, lim_y),
        pair_fault=mx_ratio(out_fault[:1], out_ref[:1], lim_out[:1]))


def mx_bound(x, top_e, ws: dict) -> tuple:
    """MX/MXq's least time on the card for this call: bytes of the experts
    this call's pairs touch (each of their weights and scales read once),
    x and the routes read, out written; 6 H I operations a pair at the
    bf16 tensor-core rate. Returns (ms, by, touched experts, bytes)."""
    from neuronx_distributed_tpu_torch.kernels.moe_experts import expert_bytes

    gate, up, down, gs, us, ds = mx_args(ws)
    touched = int(torch.unique(top_e).numel())
    t, k = top_e.shape
    nbytes = (expert_bytes(gate, up, down, (gs, us, ds), touched) + 2 * 2 * t * MX_H
              + 12 * t * k)
    flops = 6.0 * t * k * MX_H * MX_I
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", touched, nbytes


def mx_library(x, top_e, top_w, ws: dict, kind: str):
    """The yardstick: ``torch._grouped_mm`` over the same expert-sorted
    pairs (three products and the SiLU, the blockwise route's
    ``expert_mlps.blockwise``); for quantized experts DQ of the touched
    experts first (their codes gathered, ``dequantize_stack``)."""
    from neuronx_distributed_tpu_torch.modules.moe.expert_mlps import blockwise
    from neuronx_distributed_tpu_torch.quantization.layers import dequantize_stack

    gate, up, down, gs, us, ds = mx_args(ws)
    if kind == "bf16":
        return lambda: blockwise(x, top_e, top_w, gate, up, down, MX_E)
    sel = torch.unique(top_e)
    remap = torch.searchsorted(sel, top_e)
    n_sel = int(sel.numel())

    def run():
        w = [dequantize_stack(c[sel], sc[sel], torch.bfloat16)
             for c, sc in ((gate, gs), (up, us), (down, ds))]
        return blockwise(x, remap, top_w, *w, n_sel)

    return run


def check_mx(gen) -> dict:
    """MX (bf16 experts) and MXq (int8 and fp8 codes, f32 scales) at
    Mixtral-8x7B's shapes (E 8, top 2, H 4096, I 14336) on the cases of
    MX_CASES: the stage limits of :func:`mx_stage_check`, two runs and three
    graph replays bitwise equal; the time as a graph replay and the bound
    from the touched experts; at T = 8 random (the decode step's routes)
    the plain version's and the library's (``mx_library``) times."""
    from neuronx_distributed_tpu_torch.kernels import moe_experts as mx

    weights = mx_weights(gen)
    res = {}
    for case, t in MX_CASES:
        x = torch.randn(t, MX_H, generator=gen, device="cuda").to(torch.bfloat16)
        top_e, top_w = mx_routes(gen, case, t)
        for kind, ws in weights.items():
            r = mx_stage_check(x, top_e, top_w, ws)
            for what in ("ratio", "act_ratio", "y_ratio"):
                if r[what] > 1:
                    raise AssertionError(f"MX ({kind}, {case}, T={t}): {what} {r[what]:.3g} "
                                         f"above its limit")
            for what in ("act_fault", "y_fault", "pair_fault"):
                if r[what] <= 1:
                    raise AssertionError(f"MX ({kind}, {case}, T={t}): a {what} reads "
                                         f"{r[what]:.3g}x, within the limit")
            args = (x, top_e, top_w, *mx_args(ws))
            if not torch.equal(mx._kernel_call(*args)[0], r["out"]):
                raise AssertionError(f"MX ({kind}, {case}): two runs differ")
            reps = graph_replays(lambda: (mx._kernel_call(*args)[0],), 3)
            if any(not torch.equal(o[0], r["out"]) for o in reps):
                raise AssertionError(f"MX ({kind}, {case}): a graph replay differs")
            bound, by, touched, nbytes = mx_bound(x, top_e, ws)
            r.update(bound_ms=bound, bound_by=by, touched=touched, bytes=nbytes, t=t,
                     ms=graph_ms(lambda: mx._kernel_call(*args), 10))
            r.pop("out")
            if case == "random" and t == 8:
                with f32_reductions():
                    r["plain_ms"] = cuda_ms(lambda: mx.moe_experts_plain(*args), 3, warmup=1)
                    r["library_ms"] = graph_ms(mx_library(x, top_e, top_w, ws, kind), 5)
            res[(kind, case, t)] = r
            torch.cuda.empty_cache()
    del weights
    torch.cuda.empty_cache()
    return res


def mx_resources() -> list:
    """``ptxas -v``'s register and spill lines for ``csrc/moe_experts.cu``;
    raises if a kernel spills, if ``ptxas`` serialized a ``wgmma`` (its
    C7512 note), or if nothing was reported."""
    from neuronx_distributed_tpu_torch.kernels import _build

    report = _build.resource_report("moe_experts")
    lines = [line.strip() for line in report.splitlines()
             if "registers" in line or "spill" in line]
    if "C7512" in report or not any("spill" in line for line in lines) or any(
            "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
            for line in lines):
        raise AssertionError("MX/MXq spills, serializes its wgmma or was not reported:\n"
                             + "\n".join(lines + [l for l in report.splitlines() if "C7512" in l]))
    return lines


def mx_dequant_check(kind: str) -> dict:
    """MXq's dequantize code by code at Mixtral-8x7B's H and I (two
    experts, 8 tokens, both slots routed): ``dequant_probe``'s x is one-hot,
    so every sum is a single term; act over every code of up (act = 128
    bf16(f32(q) scale), under a spread of scales), then each pair's down
    output over every code of down, must equal the plain version's bit for
    bit."""
    from neuronx_distributed_tpu_torch.kernels import moe_experts as mx

    pr = mx.dequant_probe(kind, MX_H, MX_I)
    x, top_e, top_w = pr["x"], pr["top_e"], pr["top_w"]
    t, k = top_e.shape
    res = {}
    for what, up in (("up", pr["up"]), ("down", pr["up1"])):
        ws = (pr["gate"], up, pr["down"])
        _, act, y = mx._kernel_call(x, top_e, top_w, *(w for w, _ in ws), *(s for _, s in ws))
        with f32_reductions():
            G, U = (mx.gathered(w, s, top_e, torch.bfloat16) for w, s in ws[:2])
            a = torch.nn.functional.silu(torch.einsum("th,tkih->tki", x, G)) * torch.einsum(
                "th,tkih->tki", x, U)
            del G, U
            D = mx.gathered(*pr["down"], top_e, torch.bfloat16)
            y_ref = torch.einsum("tki,tkhi->tkh", a, D).reshape(t * k, MX_H)
            del D
        a = a.reshape(t * k, MX_I)
        if not torch.isfinite(a.float()).all() or not torch.equal(act, a):
            raise AssertionError(f"MXq ({kind}) dequantize: act differs from the plain version's "
                                 f"at {int((act != a).sum())} of {a.numel()} ({what} codes)")
        if what == "down" and not torch.equal(y, y_ref):
            raise AssertionError(f"MXq ({kind}) dequantize: y differs from the plain version's "
                                 f"at {int((y != y_ref).sum())} of {y.numel()}")
        res[what] = act.numel() if what == "up" else y.numel()
    del pr
    torch.cuda.empty_cache()
    return res


def log_mx(res: dict, smi: str) -> None:
    for (kind, case, t), r in res.items():
        name = "MX moe_experts" if kind == "bf16" else f"MXq moe_experts_quantized ({kind})"
        log(f"{name} ({smi}) T={t} top-2 of 8, H 4096 I 14336, {case} routes ({r['touched']} "
            f"experts touched): max_err {r['err']:.3g} ({r['ratio']:.3g}x its limit; a dropped "
            f"pair reads {r['pair_fault']:.3g}x); act {r['act_ratio']:.3g}x (a dropped 16-row "
            f"tile {r['act_fault']:.3g}x), y {r['y_ratio']:.3g}x (a dropped 32-row tile "
            f"{r['y_fault']:.3g}x); two runs and three graph replays bitwise equal; kernel_ms "
            f"{r['ms']:.4f} (graph replay) bound_ms {r['bound_ms']:.4f} ({r['bound_by']}, "
            f"{r['bytes']} B; {r['ms'] / r['bound_ms']:.2f}x)"
            + (f" plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
               f"({'' if kind == 'bf16' else 'DQ of the touched experts, then '}"
               f"torch._grouped_mm x3 + SiLU, graph replay)" if "plain_ms" in r else ""))


def rows_inputs(gen, chunk: int):
    """``check_decode_rows``'s inputs at phase 5c's geometry: one slot of a
    row cache (1, 8192, 8, 128) whose context of p tokens ends at column
    2048 (left padding before it): a live 1600-column prefix, then a suffix
    chunk of ``chunk`` tokens at the prefix's end, s = min(chunk - 3, 400)
    of them real (the longest chat turn is 400 tokens) and the rest a pad
    tail (invalid columns), so R = 4 x chunk rows per kv-head; q (1, chunk,
    32, 128)."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    h, hkv, d, L = 32, 8, 128, 8192
    s = min(chunk - 3, 400)
    c0 = ROWS_PADDED - ROWS_PREFIX - s  # the context's first column
    assert c0 >= 0, "the context must fit the prefill bucket"
    q = torch.randn(1, chunk, h, d, generator=gen, device=dev).to(bf)
    kc = torch.randn(1, L, hkv, d, generator=gen, device=dev).to(bf)
    vc = torch.randn(1, L, hkv, d, generator=gen, device=dev).to(bf)
    pos = torch.arange(c0 + ROWS_PREFIX, c0 + ROWS_PREFIX + chunk, dtype=torch.int32, device=dev)
    valid = torch.zeros(1, L, dtype=torch.bool, device=dev)
    valid[0, c0:c0 + ROWS_PREFIX + s] = True
    return q, kc, vc, pos, valid


def scrambled_pages(kc, vc, valid, ps: int = 16, seed: int = 7):
    """Pools, a numpy-seeded scrambled block table and its page count for a
    batch-1 row cache: logical pages with a valid column map to random pool
    pages holding their columns, the rest to page 0, filled with garbage."""
    import numpy as np

    _, L, hkv, d = kc.shape
    n_log = L // ps
    mapped = np.flatnonzero(valid[0].reshape(n_log, ps).any(-1).cpu().numpy())
    perm = np.random.default_rng(seed).permutation(np.arange(1, len(mapped) + 1))
    kp = torch.randn(len(mapped) + 1, ps, hkv, d, device=kc.device).to(kc.dtype).mul_(64.0)
    vp = torch.randn(len(mapped) + 1, ps, hkv, d, device=kc.device).to(kc.dtype).mul_(64.0)
    table = np.zeros((1, n_log), np.int32)
    table[0, mapped] = perm
    idx = torch.from_numpy(perm).long().to(kc.device)
    cols = torch.from_numpy(mapped).long().to(kc.device)
    kp[idx] = kc[0].reshape(n_log, ps, hkv, d)[cols]
    vp[idx] = vc[0].reshape(n_log, ps, hkv, d)[cols]
    return kp, vp, torch.from_numpy(table).to(kc.device)


def check_decode_rows(gen, chunk: int) -> dict:
    """K4's and K5's multi-row path at phase 5c's geometry with R = 4 x
    ``chunk`` rows: against the plain versions (K4's limit), bitwise
    reproducible, K5 through a scrambled table bitwise equal to K4 on the
    gathered view; a kernel that dropped one row tile (the 64 // 4 tokens of
    one tile, every head of the group, zero) must read above the limit. Its
    tile plan (``flash_decode_rows_plan``: blocks, visited and masked
    column tiles, the pairs they hold over the live pairs). Times as
    CUDA-graph replays, beside the plain version's and SDPA's (boolean
    mask, GQA, on the row view)."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        flash_decode_plain,
        paged_flash_decode_fwd,
        paged_gather_leaf,
    )

    lib = tfd._decode_lib()
    if (lib.row_tile, lib.row_tile_cols) != (tfd.ROWS_TILE, tfd.ROWS_TILE_COLS):
        raise AssertionError(f"the kernel's row tile {lib.row_tile} x {lib.row_tile_cols} is not "
                             f"flash_decode_rows_plan's {tfd.ROWS_TILE} x {tfd.ROWS_TILE_COLS}")
    h, hkv, d, ps = 32, 8, 128, 16
    q, kc, vc, pos, valid = rows_inputs(gen, chunk)
    out, lse = flash_decode_fwd(q, kc, vc, pos, valid)
    again, again_lse = flash_decode_fwd(q, kc, vc, pos, valid)
    kp, vp, bt = scrambled_pages(kc, vc, valid, ps)
    paged, paged_lse = paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    row, row_lse = flash_decode_fwd(q, paged_gather_leaf(kp, bt, ps), paged_gather_leaf(vp, bt, ps),
                                    pos, valid)
    ref, ref_lse = flash_decode_plain(q, kc, vc, pos, valid)
    pv = flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    tokens = lib.row_tile // (h // hkv)  # a row tile: these tokens of every head of a group
    t = chunk // 2 // tokens * tokens
    fault = ref.clone()
    fault[:, t:t + tokens] = 0
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K4_PV), tol_ratio(fault, ref, pv, K4_PV)
    tag = f"K4/K5 multi-row (R={4 * chunk})"
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"{tag}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"{tag}: the output limit passes a dropped row tile ({fault_ratio:.3g}x)")
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{tag}: two runs differ in their bits")
    if not (torch.equal(paged, row) and torch.equal(paged_lse, row_lse)):
        raise AssertionError(f"{tag}: K5 differs from K4 on the gathered view (must be bitwise equal)")
    # least work: every row's live pairs (valid columns at or before its
    # position), 4 D FLOPs each per q-head; least bytes: q, the K/V columns
    # live for some row, the validity bytes up to the bound, out and lse
    cols = torch.arange(kc.shape[1], device=q.device)
    live = valid[0][None, :] & (cols[None, :] <= pos[:, None].long())  # (chunk, L)
    pairs = int(live.sum())
    live_cols = int(live.any(0).sum())
    bound_cols = int(pos.max()) + 1
    flops = 4.0 * d * h * pairs
    nbytes = (2 * q.numel() + 2 * 2 * live_cols * hkv * d + bound_cols + 2 * out.numel()
              + 4 * lse.numel())
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    mask = live[None, None]  # (1, 1, chunk, L)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    plan = tfd.flash_decode_rows_plan(pos.cpu(), valid.cpu(), kc.shape[1], h // hkv, b=1, hkv=hkv)
    visited, masked = plan["visited"], plan["visited"] & plan["masked"]
    # (row, column) pairs in visited tiles, a head, against the live pairs
    tile_pairs = int((visited.sum(-1) * plan["tokens"]).sum()) * tfd.ROWS_TILE_COLS
    plan = dict(blocks=len(plan["order"]), visited=int(visited.sum()) * hkv,
                masked=int(masked.sum()) * hkv, work_over_live=tile_pairs / pairs)
    return dict(rows=4 * chunk, err=max(err, lerr, max_err(paged, ref)), ratio=ratio,
                fault_ratio=fault_ratio, pairs=pairs, bound_ms=bound, bound_by=bound_by,
                tokens=tokens, plan=plan,
                ms=graph_ms(lambda: flash_decode_fwd(q, kc, vc, pos, valid), 5),
                paged_ms=graph_ms(lambda: paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps), 5),
                plain_ms=cuda_ms(lambda: flash_decode_plain(q, kc, vc, pos, valid), 3, warmup=1),
                library_ms=graph_ms(sdpa, 5), gflop=flops / 1e9)


def packed_segments(rng, b: int, s: int, lo: int = 200, hi: int = 3000):
    """(B, S) int32 segment ids of documents of lo..hi tokens packed end to
    end (a document cut by the window edge keeps its id)."""
    import numpy as np

    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        pos, doc = 0, 0
        while pos < s:
            n = int(rng.integers(lo, hi + 1))
            seg[i, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return seg


def live_pairs(seg, b: int, s: int, dev) -> int:
    """Live (query, key) pairs of one head over a batch of ``b`` rows:
    causal, equal segment ids (no segments: every row its causal prefix)."""
    rows = torch.arange(s, device=dev)
    causal = rows[:, None] >= rows[None, :]
    if seg is None:
        return b * int(causal.sum())
    return sum(int((causal & (r[:, None] == r[None, :])).sum()) for r in seg)


def bwd_magnitudes(q, k, v, do, lse, delta, seg, kv_seg):
    """The sums of term magnitudes each backward output is limited by:
    (dK: |dS||Q|, dV: P|dO|, dQ: |dS||K|), f32; dS = P (dP - delta) scale."""
    from neuronx_distributed_tpu_torch.kernels.flash_attention import backward_scores

    b, s, h, d = q.shape
    hkv = k.shape[2]
    p, ds = backward_scores(q, k, v, do, lse, delta, True, seg, kv_seg)
    dog = do.float().abs().reshape(b, s, hkv, h // hkv, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    del p
    ds = ds.abs_()
    qg = q.float().abs().reshape(b, s, hkv, h // hkv, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float().abs()).reshape(b, s, h, d)
    return dk, dv, dq


def check_k2k3(gen, s: int, packed: bool, timed: bool):
    """K2 and K3 at training shapes: B=2, H=32, Hkv=8, D=128, bf16, causal,
    optionally packed segment ids. LSE from K1, delta = rowsum(dO * O)."""
    import numpy as np
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention_dkdv,
        flash_attention_dkdv_plain,
        flash_attention_dq,
        flash_attention_dq_plain,
        flash_attention_fwd,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, h, hkv, d = 2, 32, 8, 128
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    do = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    seg = (torch.from_numpy(packed_segments(np.random.default_rng(s), b, s)).to(dev)
           if packed else None)
    out, lse = flash_attention_fwd(q, k, v, True, seg)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, True, seg)
    dk, dv = flash_attention_dkdv(*args)
    dq = flash_attention_dq(*args)
    dk2, dv2 = flash_attention_dkdv(*args)
    dq2 = flash_attention_dq(*args)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b_) for a, b_ in ((dk, dk2), (dv, dv2), (dq, dq2)))
    del dk2, dv2, dq2
    rk, rv = flash_attention_dkdv_plain(*args)
    rq = flash_attention_dq_plain(*args)
    mk, mv, mq = bwd_magnitudes(q, k, v, do, lse, delta, seg, seg)
    ratios = {name: tol_ratio(got, ref, mag, K2K3_C)
              for name, got, ref, mag in (("dk", dk, rk, mk), ("dv", dv, rv, mv), ("dq", dq, rq, mq))}
    errs = {"dk": max_err(dk, rk), "dv": max_err(dv, rv), "dq": max_err(dq, rq)}
    # deliberately wrong kernels: K2 without the last key tile (those keys'
    # dK/dV come out 0), K3 without the first (rows 0..63 see only it)
    kv_seg = seg.clone() if seg is not None else torch.zeros(b, s, dtype=torch.int32, device=dev)
    q_seg = seg if seg is not None else torch.zeros_like(kv_seg)
    last, first = kv_seg.clone(), kv_seg.clone()
    last[:, (s - 1) // 64 * 64:] = -2
    first[:, :64] = -2
    fk, fv = flash_attention_dkdv_plain(q, k, v, do, lse, delta, True, q_seg, last)
    fq = flash_attention_dq_plain(q, k, v, do, lse, delta, True, q_seg, first)
    fault = {"dk": tol_ratio(fk, rk, mk, K2K3_C), "dv": tol_ratio(fv, rv, mv, K2K3_C),
             "dq": tol_ratio(fq, rq, mq, K2K3_C)}
    del rk, rv, rq, mk, mv, mq, fk, fv, fq
    torch.cuda.synchronize()
    tag = f"S={s} {'packed' if packed else 'unpacked'}"
    if not same_bits:
        raise AssertionError(f"K2/K3 {tag}: two runs differ in their bits")
    if max(ratios.values()) > 1.0:
        raise AssertionError(f"K2/K3 {tag}: outside the limit: {ratios} (max errs {errs})")
    if min(fault.values()) <= 1.0:
        raise AssertionError(f"K2/K3 {tag}: the limit passes a dropped key tile: {fault}")
    res = dict(err=errs, ratio=ratios, fault=fault)
    if not timed:
        return res
    pairs = live_pairs(seg, b, s, dev) * h
    seg_bytes = 0 if seg is None else 2 * 4 * seg.numel()
    io = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * (lse.numel() + delta.numel())
    work = {  # name: (FLOPs: 2*D per live pair per product, bytes read once + written once)
        "dkdv": (4 * 2.0 * d * pairs, io + seg_bytes + 2 * (k.numel() + v.numel())),
        "dq": (3 * 2.0 * d * pairs, io + seg_bytes + 2 * q.numel()),
    }
    for name, fn, plain in (
            ("dkdv", lambda: flash_attention_dkdv(*args), lambda: flash_attention_dkdv_plain(*args)),
            ("dq", lambda: flash_attention_dq(*args), lambda: flash_attention_dq_plain(*args))):
        flops, nbytes = work[name]
        ms = cuda_ms(fn, 10)
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        res[name] = dict(
            ms=ms, plain_ms=cuda_ms(plain, 2, warmup=1), bound_ms=bound,
            bound_by="operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
            tflops=flops / ms / 1e9, over_bound=ms / bound)
    if packed:  # SDPA has no segment mask short of a dense one: no yardstick here
        res["library_ms"] = None
        return res
    # yardstick: SDPA's backward (dQ, dK and dV together) = fwd+bwd - fwd
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    g = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    fwd_ms = cuda_ms(sdpa, 10)
    both_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), g), 10)
    res["library_ms"] = both_ms - fwd_ms
    return res


# --- phase 3: outputs against the plain path -----------------------------------

@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain versions (reference
    runs only; the port itself has no such switch)."""
    from neuronx_distributed_tpu_torch.kernels.flash_attention import flash_attention_plain
    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_plain,
        paged_flash_decode_plain,
    )
    from neuronx_distributed_tpu_torch.modules import attention

    saved = (attention.flash_attention, attention.flash_decode_attention,
             attention.paged_flash_decode_attention)
    attention.flash_attention = lambda *a, **kw: flash_attention_plain(*a, **kw)[0]
    attention.flash_decode_attention = lambda *a, **kw: flash_decode_plain(*a, **kw)[0]
    attention.paged_flash_decode_attention = lambda *a, **kw: paged_flash_decode_plain(*a, **kw)[0]
    try:
        yield
    finally:
        (attention.flash_attention, attention.flash_decode_attention,
         attention.paged_flash_decode_attention) = saved


@contextlib.contextmanager
def gathered_paged_attention():
    """Attend a paged cache by gathering its logical view and running K4 on
    it, in place of K5 (the witness K5's serving run is held to; the port
    itself has no such switch)."""
    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_attention,
        paged_gather_leaf,
    )
    from neuronx_distributed_tpu_torch.modules import attention

    def gathered(q, k_pool, v_pool, block_table, q_pos, kv_valid=None, page_size=16):
        return flash_decode_attention(q, paged_gather_leaf(k_pool, block_table, page_size),
                                      paged_gather_leaf(v_pool, block_table, page_size),
                                      q_pos, kv_valid)

    saved, attention.paged_flash_decode_attention = attention.paged_flash_decode_attention, gathered
    try:
        yield
    finally:
        attention.paged_flash_decode_attention = saved


def scrambled_paged_cache(model, seed: int = 0):
    """A batch-1 paged cache (page_size 16, K5 attending) whose logical
    pages 0..7 map to a numpy-seeded random choice of pool pages and whose
    other entries point at page 0, filled with random garbage."""
    import numpy as np

    n_log = model.config.max_seq_len // 16
    cache = model.new_paged_cache(1, num_pages=n_log + 1, page_size=16)
    table = np.zeros((1, n_log), np.int32)
    table[0, :8] = np.random.default_rng(seed).permutation(np.arange(1, n_log + 1))[:8]
    cache.upload_table(table)
    g = torch.Generator(device=cache.k.device).manual_seed(seed)
    for pool in (cache.k, cache.v):
        pool[:, 0].normal_(generator=g)
    return cache


def teacher_logits(model, ids, steps: int, feed=None, cache=None):
    """Prefill ``ids`` then ``steps`` decode steps through ``cache`` (a fresh
    row cache by default); feeds ``feed`` tokens (or the greedy choice) and
    returns (logits (steps+1, V) f32, tokens)."""
    cache = model.new_cache(1) if cache is None else cache
    logits = [model(ids, mode="prefill", cache=cache, last_only=True)[0, -1].float()]
    toks = []
    for t in range(steps):
        tok = int(feed[t]) if feed is not None else int(logits[-1].argmax())
        toks.append(tok)
        x = torch.tensor([[tok]], device=ids.device)
        logits.append(model(x, mode="decode", cache=cache, last_only=True)[0, -1].float())
    return torch.stack(logits), toks


def check_outputs(model, gen) -> dict:
    """The kernels' logits against the plain path's, through a row cache
    (K1, K4) and through a paged cache behind a scrambled table (K1, K5)."""
    ids = torch.randint(1, model.config.vocab_size, (1, 64), generator=gen, device="cuda")
    with plain_attention():
        ref, toks = teacher_logits(model, ids, 8)
    res = {}
    for name, cache in (("row", None), ("paged", scrambled_paged_cache(model))):
        got, _ = teacher_logits(model, ids, 8, feed=toks, cache=cache)
        if not torch.isfinite(got).all():
            raise AssertionError(f"non-finite logits through the kernels ({name} cache)")
        scale = float(ref.abs().max())
        rel = max_err(got, ref) / scale
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        in_top5 = bool((got.topk(5, dim=-1).indices == ref.argmax(-1)[:, None]).any(-1).all())
        # bf16 model with random weights: K1 rounds P to bf16 where the plain
        # path keeps f32 (~2^-9 relative per attention output), and 32 random
        # layers amplify it; near-ties among 128256 logits may swap the top-1,
        # so the plain path's choice must stay within the kernels' top 5
        if rel > 5e-2 or not in_top5:
            raise AssertionError(f"logits ({name} cache) disagree with the plain path: rel {rel}, "
                                 f"argmax {agree}/{ref.shape[0]}, plain top-1 in top-5: {in_top5}")
        res[name] = dict(rel_err=rel, argmax_agree=f"{agree}/{ref.shape[0]}", logit_scale=scale)
    return res


# --- phase 4: serving ---------------------------------------------------------

@contextlib.contextmanager
def eager_decode_step():
    """Run the engine's decode step eagerly in place of its captured graph
    (the witness the graph engine's streams are held to; the engine itself
    has no such switch)."""
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram

    saved = DecodeProgram.__call__
    DecodeProgram.__call__ = lambda self: self.step()
    try:
        yield
    finally:
        DecodeProgram.__call__ = saved


def decode_program(engine):
    """The engine's decode program, or None (not made yet, or a checkout
    whose engine launches every decode op from Python)."""
    return getattr(engine, "decode_program", None)


def engine_launches(engine, counts: dict):
    """(kernel launches of a run by wrapper, those of them the capture's
    warm-up made). A replay calls no wrapper, so the launches of the
    replays, ``replays x launches per replay``, are added to the wrappers'
    counts ``counts``; the warm-up (one masked no-op step before capture)
    launched through the wrappers what one replay launches, and is no
    decode step."""
    out, warm = dict(counts), dict.fromkeys(counts, 0)
    prog = decode_program(engine)
    if prog is not None:
        for name, n in prog.launches_per_replay.items():
            out[name] += prog.replays * n
            warm[name] = prog.captures * n
    return out, warm


def check_program(engine, what: str, eager: bool) -> None:
    """One captured decode program whose replays are the executed steps
    (none and eager steps for the witness)."""
    prog, snap = decode_program(engine), engine.metrics.snapshot()
    if prog is None:
        return
    want = (0, 0) if eager else (1, snap["executed_steps"])
    if (engine.decode_compilations, prog.replays) != want:
        raise AssertionError(f"{what}: decode_compilations {engine.decode_compilations}, replays "
                             f"{prog.replays}; want {want}")


def decode_records(prof, paged: bool) -> int:
    """The profiler's CUDA kernel records of K4 (``paged``: K5): the range
    kernel and the merge, two per call."""
    n = 0
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        if "flash_decode_kernel" in e.name and ("paged_" in e.name) == paged:
            n += 1
    return n


def serve(model, gen, dq=None):
    """Phase 4's workload through the engine as it serves (its decode
    program captured at the first chunk); ``dq`` as :func:`serve_workload`
    takes it (a pre-quantized model's DQ launches)."""
    lengths = [30, 250, 700, 1500, 2200, 3000]
    new = 32
    prompts = [torch.randint(1, model.config.vocab_size, (n,), generator=gen, device="cuda")
               .cpu().numpy() for n in lengths]
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    cfgs = [GenerationConfig(max_new_tokens=new, temperature=0.0) for _ in lengths]
    cfgs[2] = GenerationConfig(max_new_tokens=new, temperature=0.8, top_k=50)
    return serve_workload(model, (prompts, cfgs), dq=dq)


def serve_workload(model, workload, eager: bool = False, quantize=None, dq=None,
                   witness=None) -> dict:
    """Six requests into 8 slots, chunk 8: all admitted in the first step
    (six prefills, then one decode chunk), then decode-only steps. Every
    kernel's launch count is zeroed just before and read just after.
    ``eager`` runs the decode step eagerly (the witness); ``quantize`` is
    the engine's (phase 5f: DQ once a linear, 7 x 32 + 1, a forward);
    ``dq`` (DQ launches a decode step, a prefill) overrides that count
    (phase 5m(c)'s pre-quantized Mixtral); ``witness(engine)``, with
    ``eager``, is the context the eager run goes through in place of
    :func:`eager_decode_step` (phase 5m's route recorder)."""
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    prompts, cfgs = workload
    layers = model.config.num_layers
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8, prefix_cache=None,
                           quantize=quantize)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    run_ctx = (witness(engine) if witness is not None else eager_decode_step()) if eager else \
        contextlib.nullcontext()
    with run_ctx:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
        engine.step()  # admits all six (8 slots): six prefills, then one decode chunk
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps0, executed0 = engine.metrics.steps, engine.metrics.executed_steps
        engine.run()  # decode-only steps
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches, warm = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != r.config.max_new_tokens:
            raise AssertionError(f"request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < model.config.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocabulary")
    if min(launches["flash_attention"], launches["flash_decode"]) < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    if (launches["paged_flash_decode"] or launches["flash_attention_dkdv"]
            or launches["flash_attention_dq"] or launches["qpaged_flash_decode"]
            or launches.get("window_requantize", 0) or launches.get("qpaged_write_attend", 0)):
        raise AssertionError(f"row serving launched a kernel of another path: {launches}")
    snap = engine.metrics.snapshot()
    # executed steps each ran the whole model (and one K4 per layer); used
    # steps had a live slot — the rest were masked no-ops
    if launches["flash_decode"] - warm["flash_decode"] != snap["executed_steps"] * layers:
        raise AssertionError(f"K4 launches {launches['flash_decode']} (warm-up "
                             f"{warm['flash_decode']}) != executed steps "
                             f"{snap['executed_steps']} x {layers} layers")
    # DQ once a linear of every forward: the prefills' and the steps'
    linears = 7 * layers + 1 if quantize is not None and quantize.weights else 0
    dq_step, dq_prefill = dq if dq is not None else (linears, linears)
    if (launches["dequantize"] - warm["dequantize"]
            != snap["executed_steps"] * dq_step + snap["prefills"] * dq_prefill):
        raise AssertionError(f"DQ launches {launches['dequantize']} (warm-up {warm['dequantize']}) "
                             f"!= executed steps {snap['executed_steps']} x {dq_step} + prefills "
                             f"{snap['prefills']} x {dq_prefill}")
    check_program(engine, "serving", eager)
    prog = decode_program(engine)
    weight_bytes = sum(t.numel() * t.element_size() for t in engine.model.state_dict().values())
    return dict(wall_s=t2 - t0, admit_s=t1 - t0, decode_s=t2 - t1, weight_bytes=weight_bytes,
                decode_only_executed=snap["executed_steps"] - executed0,
                decode_only_used=snap["steps"] - steps0, launches=launches, snap=snap,
                prefills=snap["prefills"], workload=workload,
                tokens=[list(r.tokens) for r in reqs], rids=[r.rid for r in reqs],
                compilations=getattr(engine, "decode_compilations", None),
                replays=prog.replays if prog is not None else None,
                per_replay=dict(prog.launches_per_replay) if prog is not None else None)


def prewarm(engine) -> float:
    """Capture the engine's decode program before the profiler opens (0 for
    a checkout without one)."""
    return engine.prewarm() if hasattr(engine, "prewarm") else 0.0


def profile_serving(model, workload) -> dict:
    """The serving workload once more under ``torch.profiler``: device time
    by kernel family, and the profiler's count of K4 kernel records against
    the executed steps. The decode program is captured before the profiler
    opens. The profiler slows the host several-fold, so only its device
    times are used (against the unprofiled run's wall)."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    prompts, cfgs = workload
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8, prefix_cache=None)
    capture_s = prewarm(engine)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, (p, c) in enumerate(zip(prompts, cfgs)):
            engine.submit(p, c, seed=i)
        engine.run()
        torch.cuda.synchronize()
    executed = engine.metrics.executed_steps
    records = decode_records(prof, paged=False)
    if records != 2 * executed * model.config.num_layers:
        raise AssertionError(f"profiled serving: {records} K4 kernel records != 2 x {executed} "
                             f"executed steps x {model.config.num_layers} layers")
    fams = device_time_by_family(prof, {"flash_attention": "flash_fwd_kernel",
                                        "flash_decode": "flash_decode_kernel",
                                        "moe_experts": MX_KERNELS})
    return dict(fams=fams, records=records, executed=executed, capture_s=capture_s)


def paged_workload(vocab: int):
    """12 chat turns of 100-400 tokens and 3 documents of 2000-3000 tokens,
    a document after every fourth chat (the JAX bench's paged leg,
    ``bench.py:1049-1087``, at Llama-3-8B scale); 32 new tokens each,
    temperature 0.8 with top_k 20 except two greedy requests."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    rng = np.random.default_rng(3)
    chats = [rng.integers(1, vocab, size=int(rng.integers(100, 401))) for _ in range(12)]
    docs = [rng.integers(1, vocab, size=int(rng.integers(2000, 3001))) for _ in range(3)]
    prompts = []
    for i, p in enumerate(chats):
        prompts.append(p)
        if i % 4 == 3:
            prompts.append(docs[i // 4])
    cfgs = [GenerationConfig(max_new_tokens=32, temperature=0.8, top_k=20) for _ in prompts]
    for i in (1, 9):
        cfgs[i] = GenerationConfig(max_new_tokens=32, temperature=0.0)
    return prompts, cfgs


PAGED_SLOTS, PAGE, ROW_SLOTS = 16, 16, 4


def serve_paged(model, workload, attention: str, profiled: bool = False,
                eager: bool = False, quantize=None, num_pages=None, strict=True,
                program_ledger=None) -> dict:
    """The paged engine (16 slots, page_size 16, chunk 8, conservative,
    FIFO) over a pool of ROW_SLOTS row slots' bytes plus the null page,
    answering ``workload``; every kernel's launch count is zeroed just
    before and read just after. ``attention`` is ``"fused"`` (the engine as
    it serves, K5) or ``"gather"`` (K4 on the gathered view patched in, the
    witness: patched before the first chunk, so the graph captures it).
    ``eager`` runs the decode step eagerly (the graph's witness).
    ``profiled`` captures the decode program first, then runs under the
    profiler and adds the device time by family and the profiler's count
    of K5 records (its walls are the profiler's, not the engine's).
    ``quantize`` and ``num_pages`` are phase 5f's: an int8 pool's decode
    step writes and attends through K5q with the write (counted in K5q's
    launches too), its prefills write through QW. ``strict=False``
    (``chip_decode_ab.py``, which may drive an older checkout) reports
    the fused route's and QW's launches and the profiler's decode records
    without holding them to this checkout's counts. ``program_ledger`` is
    phase 5l(b)'s."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    cfg = model.config
    engine = ServingEngine(model, num_slots=PAGED_SLOTS, decode_chunk_size=8, kv_page_size=PAGE,
                           kv_num_pages=num_pages or ROW_SLOTS * cfg.max_seq_len // PAGE + 1,
                           prefix_cache=None, quantize=quantize,
                           **({} if program_ledger is None else {"program_ledger": program_ledger}))
    prompts, cfgs = workload
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    capture_s = prewarm(engine) if profiled else 0.0
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
           else contextlib.nullcontext())
    route = gathered_paged_attention() if attention == "gather" else contextlib.nullcontext()
    decode_s, decode_executed = 0.0, 0
    with route, eager_decode_step() if eager else contextlib.nullcontext(), ctx as prof:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
        while engine.has_work:
            prefills, executed = engine.metrics.prefills, engine.metrics.executed_steps
            t1 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            if engine.metrics.prefills == prefills:  # a decode-only step
                decode_s += time.perf_counter() - t1
                decode_executed += engine.metrics.executed_steps - executed
        wall = time.perf_counter() - t0
    launches, warm = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    engine.cache.check()
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != 32:
            raise AssertionError(f"paged request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"paged request {r.rid}: token outside the vocabulary")
    snap = engine.metrics.snapshot()
    attended = ("flash_decode" if attention == "gather" else "qpaged_flash_decode"
                if quantize is not None and quantize.kv else "paged_flash_decode")
    qkv = quantize is not None and quantize.kv is not None
    want = {"paged_flash_decode": 0, "flash_decode": 0, "qpaged_flash_decode": 0}
    want[attended] = snap["executed_steps"] * cfg.num_layers
    if strict:  # an int8 pool's writes: a step's in K5q with the write, a prefill's in QW
        want["qpaged_write_attend"] = snap["executed_steps"] * cfg.num_layers * qkv
        want["window_requantize"] = snap["prefills"] * cfg.num_layers * qkv
    got = {k: launches.get(k, 0) - warm.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"paged ({attention}) decode launches {got} != {want}")
    if launches["flash_attention"] != snap["prefills"] * cfg.num_layers:
        raise AssertionError(f"paged ({attention}) K1 launches {launches['flash_attention']} != "
                             f"{snap['prefills']} prefills x {cfg.num_layers} layers")
    if snap["peak_occupancy"] <= ROW_SLOTS:
        raise AssertionError(f"paged: at most {snap['peak_occupancy']} requests decoded at once, "
                             f"no more than the {ROW_SLOTS} row slots of the same bytes")
    check_program(engine, f"paged serving ({attention})", eager)
    prog = decode_program(engine)
    res = dict(tokens=[list(r.tokens) for r in reqs], launches=launches, snap=snap, wall_s=wall,
               decode_s=decode_s, decode_executed=decode_executed,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               pool_gib=engine.cache.nbytes / 2**30, pool_pages=engine.cache.alloc.num_pages,
               per_replay=dict(prog.launches_per_replay) if prog is not None else None,
               compilations=getattr(engine, "decode_compilations", None),
               capture_s=capture_s or snap.get("capture_s", 0.0),
               replays=prog.replays if prog is not None else None,
               host_reads=getattr(engine, "host_reads", None))
    if profiled:
        # K5 and K5q: a range kernel and its merge a call
        res["records"] = decode_records(prof, paged=attention == "fused")
        if strict and res["records"] != 2 * snap["executed_steps"] * cfg.num_layers:
            raise AssertionError(f"profiled paged serving: {res['records']} K5 kernel records != "
                                 f"2 x {snap['executed_steps']} executed steps x "
                                 f"{cfg.num_layers} layers")
        res["fams"] = device_time_by_family(prof, {
            "qpaged_write_attend": "qpaged_flash_decode_kernel_write",
            "qpaged_flash_decode": "qpaged_flash_decode_kernel", "dequantize": "dequantize_kernel",
            "window_requantize": "window_requantize_kernel",
            "paged_flash_decode": "paged_flash_decode_kernel",
            "flash_attention": "flash_fwd_kernel", "flash_decode": "flash_decode_kernel"})
    del engine
    torch.cuda.empty_cache()
    return res


# --- phase 5c: prefix-cache serving ----------------------------------------------

def prefix_workload(vocab: int, seed: int = 5):
    """The JAX bench's prefix leg (``bench.py:860-1011``) at Llama-3-8B
    scale: a shared system prompt of 1600 tokens (numpy seed ``seed``) and 12
    requests, each the system prompt plus a unique tail: 4 tails of 4-8
    tokens (the bench's own; suffix chunk <= 8, R <= 32), 7 chat turns of
    100-400 tokens (chunks 128-512, R = 512-2048) and an exact duplicate of
    the first request (reuse capped at p - 1); 32 new tokens each, half
    greedy, half at temperature 0.8 with top_k 20."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, size=ROWS_PREFIX)
    tails = [rng.integers(1, vocab, size=int(rng.integers(4, 9))) for _ in range(4)]
    tails += [rng.integers(1, vocab, size=int(rng.integers(100, 401))) for _ in range(7)]
    prompts = [np.concatenate([system, t]).astype(np.int32) for t in tails]
    prompts.append(prompts[0].copy())
    cfgs = [GenerationConfig(max_new_tokens=32, temperature=0.0) if i % 2 == 0 else
            GenerationConfig(max_new_tokens=32, temperature=0.8, top_k=20) for i in range(12)]
    return prompts, cfgs


def prefix_warmup(vocab: int):
    """The warm-up wave: the same shapes on a different system prompt (seed
    6), 4 new tokens each, so the decode program is captured and the suffix
    chunks' shapes have run before the measured wave."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    prompts, _ = prefix_workload(vocab, seed=6)
    return prompts[:5] + prompts[-2:-1], [GenerationConfig(max_new_tokens=4, temperature=0.0)] * 6


def serve_prefix(model, workload, paged: bool, prefix, profiled: bool = False,
                 quantize=None, num_pages=None, on_measured=None) -> dict:
    """Phase 5c's workload through the row engine (8 slots, chunk 8,
    conservative) or the paged engine (16 slots, page 16, 2049 pages), with
    ``prefix`` as its ``prefix_cache``: the warm-up wave, the store cleared,
    every kernel's launch count zeroed, then the measured wave, each request
    submitted at once. Paged: ``check()`` after every step, each entry's
    pages cloned when pinned and compared at the end, and after
    ``prefix.clear()`` every page but the null page free. ``profiled``: the
    measured wave runs under ``torch.profiler`` with each suffix prefill in
    a ``SUFFIX_RANGE`` range (the profile is returned as ``prof``).
    ``quantize`` and ``num_pages`` are phase 5f's: on an int8 pool the
    steps attend through K5q, a hit's suffix prefill runs on K4 over a
    dequantized float row, and a pinned page's scales are part of it.
    ``on_measured(engine)`` runs just before the measured wave (phase 5m's
    route recorder)."""
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    cfg = model.config
    kw = (dict(num_slots=PAGED_SLOTS, kv_page_size=PAGE,
               kv_num_pages=num_pages or ROW_SLOTS * cfg.max_seq_len // PAGE + 1) if paged
          else dict(num_slots=8))
    engine = ServingEngine(model, decode_chunk_size=8, prefix_cache=prefix, quantize=quantize,
                           **kw)
    qkv = quantize is not None and quantize.kv is not None
    warm = prefix_warmup(cfg.vocab_size)
    for i, (p, c) in enumerate(zip(*warm)):
        engine.submit(p, c, seed=1000 + i)
    engine.run()
    if engine.prefix is not None:
        engine.prefix.clear()  # the measured wave starts with a cold store
    if on_measured is not None:
        on_measured(engine)
    pinned = {}  # page: its K and V (and scales) as the prefill left them, while pinned
    if paged:
        pin, unpin = engine.cache.pin_pages, engine.cache.unpin_pages
        c = engine.cache.cache
        page_leaves = (c.k, c.v) + ((c.k_scale, c.v_scale) if qkv else ())

        def cloning(ids):
            for pid in ids:
                pinned.setdefault(int(pid), tuple(t[:, pid].clone() for t in page_leaves))
            pin(ids)

        def dropping(ids):
            unpin(ids)
            for pid in ids:
                if not engine.cache._pins.get(int(pid)):
                    pinned.pop(int(pid), None)

        engine.cache.pin_pages, engine.cache.unpin_pages = cloning, dropping
    base = engine.metrics.snapshot()
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "multi_row_launches"):
            c.multi_row_launches = 0
    prog = decode_program(engine)
    replays0 = prog.replays
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(profiled_suffix_prefills()) if profiled else None
        t0 = time.perf_counter()
        prompts, cfgs = workload
        reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
        while engine.has_work:
            engine.step()
            if paged:
                engine.cache.check()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != 32:
            raise AssertionError(f"prefix request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"prefix request {r.rid}: token outside the vocabulary")
    snap = engine.metrics.snapshot()
    delta = {k: snap[k] - base[k] for k in (
        "prefix_hits", "prefix_misses", "prefix_tokens_reused", "prefix_evictions",
        "prefix_validation_failures", "prefix_pages_shared", "prefill_full_wall_s",
        "prefill_suffix_wall_s", "prefill_full_count", "prefill_suffix_count", "prefills",
        "executed_steps")}
    launches = {name: c.launches for name, c in counters.items()}
    rows = {name: c.multi_row_launches for name, c in counters.items()
            if hasattr(c, "multi_row_launches")}
    # the steps' decode kernel, and the suffix prefills' (an int8 pool's hit
    # prefills its suffix over a float row: K4)
    decode = "qpaged_flash_decode" if qkv else "paged_flash_decode" if paged else "flash_decode"
    suffix = "flash_decode" if qkv else decode
    per_replay = prog.launches_per_replay.get(decode, 0) if prog is not None else 0
    # every executed decode step is a replay of the program the warm-up wave
    # captured; the wrappers' own decode launches are the suffix prefills'
    replays = prog.replays - replays0
    if prog.captures and replays != delta["executed_steps"]:
        raise AssertionError(f"prefix serving: {replays} replays != {delta['executed_steps']} "
                             f"executed steps")
    want = {decode: delta["executed_steps"] * cfg.num_layers}
    want[suffix] = want.get(suffix, 0) + delta["prefill_suffix_count"] * cfg.num_layers
    got = {k: launches[k] + (replays * per_replay if k == decode else 0) for k in want}
    if got != want:
        raise AssertionError(f"prefix serving: decode launches {got} (replays x {per_replay} "
                             f"included) != {want} ({delta['prefill_suffix_count']} suffix "
                             f"prefills, {delta['executed_steps']} steps, x {cfg.num_layers})")
    if launches["flash_attention"] != delta["prefill_full_count"] * cfg.num_layers:
        raise AssertionError(f"prefix serving: K1 launches {launches['flash_attention']} != "
                             f"{delta['prefill_full_count']} full prefills x {cfg.num_layers}")
    if engine.decode_compilations != 1:
        raise AssertionError(f"prefix serving: decode_compilations {engine.decode_compilations}")
    res = dict(tokens=[list(r.tokens) for r in reqs], snap=snap, delta=delta, wall_s=wall,
               launches=launches, multi_row=rows, replayed=replays * per_replay, decode=decode,
               per_replay=dict(prog.launches_per_replay),
               ttft=[r.first_token_time - r.submit_time for r in reqs], engine=engine, prof=prof)
    if paged:
        res["copy_bytes"] = engine.cache.alloc.copy_bytes
        res["pages_shared_total"] = engine.cache.prefix_pages_shared_total
        res["pinned_pages"] = len(pinned)
        changed = [pid for pid, kept in pinned.items()
                   if not all(torch.equal(t[:, pid], x) for t, x in zip(page_leaves, kept))]
        if changed:
            raise AssertionError(f"paged prefix serving: pinned pages written: {changed[:8]}")
        engine.cache.pin_pages, engine.cache.unpin_pages = pin, unpin
        pinned.clear()
    else:
        res["entry_bytes"] = engine.prefix.nbytes if engine.prefix is not None else 0
    return res


SUFFIX_RANGE = "suffix_prefill"  # the profiler range around each suffix prefill


@contextlib.contextmanager
def profiled_suffix_prefills():
    """``torch.profiler`` (CPU and CUDA activity) with the serving engine's
    ``suffix_prefill_step`` wrapped in a ``SUFFIX_RANGE`` range; yields the
    profile."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from neuronx_distributed_tpu_torch.serving import engine as engine_mod

    step = engine_mod.suffix_prefill_step

    def ranged(*a, **kw):
        with record_function(SUFFIX_RANGE):
            return step(*a, **kw)

    engine_mod.suffix_prefill_step = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield prof
    finally:
        engine_mod.suffix_prefill_step = step


def range_device_ms(prof, name: str):
    """Device ms of the kernels that ran inside the device-side spans of the
    ``name`` ranges (the profiler's GPU user annotations), or None where
    the profile holds no such span."""
    spans, kernels = [], []
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        (spans if e.name == name else kernels).append(e)
    if not spans:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in spans)
    starts = [a for a, _ in spans]
    total = 0.0
    for k in kernels:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        if i >= 0 and k.time_range.start < spans[i][1]:
            total += k.device_time
    return total / 1e3


def profile_prefix(model, workload, wall_s: float, suffix_wall_s: float) -> dict:
    """Phase 5c's row engine with the prefix cache on, once more under the
    profiler (its measured wave): device ms by family (K1, K4 on the split
    path, K4 on the multi-row path, GEMMs, other), busy against the
    unprofiled run's wall (``wall_s``), and the device ms inside the suffix
    prefills against their unprofiled wall (``suffix_wall_s``), whose rest
    is host issue. The profiler slows the host, so only device times are
    read from it."""
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache

    run = serve_prefix(model, workload, False, PrefixCache(), profiled=True)
    prof = run.pop("prof")
    drain_prefix_store(run)
    fams = device_time_by_family(prof, {"flash_attention": "flash_fwd_kernel",
                                        "flash_decode_multi_row": "flash_decode_kernel_rows",
                                        "flash_decode": "flash_decode_kernel"},
                                 skip=(SUFFIX_RANGE,))
    busy = sum(fams.values())
    suffix_ms = range_device_ms(prof, SUFFIX_RANGE)
    return dict(fams=fams, busy_ms=busy, idle_share=1 - busy / (1e3 * wall_s),
                suffix_device_ms=suffix_ms, suffix_wall_ms=1e3 * suffix_wall_s,
                suffix_host_share=None if suffix_ms is None else 1 - suffix_ms / (1e3 * suffix_wall_s),
                hits=run["delta"]["prefix_hits"])


def drain_prefix_store(res: dict) -> None:
    """After the run: clear the store and check that every page but the
    null page is free (paged), then free the engine."""
    engine = res.pop("engine")
    if engine.prefix is not None:
        engine.prefix.clear()
    if hasattr(engine.cache, "check"):
        engine.cache.check()
        if engine.cache.alloc.free_pages != engine.cache.alloc.capacity:
            raise AssertionError(f"paged prefix serving: {engine.cache.alloc.free_pages} free "
                                 f"pages of {engine.cache.alloc.capacity} after clear and drain")
    del engine
    torch.cuda.empty_cache()


def check_hit_logits(model, engine, workload, rec=None) -> list:
    """For a short tail, a long tail and the duplicate: the suffix-prefill
    logits of a hit on the engine's stored entry (K4, on a fresh batch-1
    cache seeded from it) against the full-prefill logits of the same
    context (K1), phase 3's limits. ``rec`` (phase 5m's Mixtral, a
    :class:`RouteRecorder` that filed the wave's admissions): the limits
    hold against a second full prefill forced onto the hit's routes (the
    stored prefix's, then the suffix prefill's), and the unforced one is
    reported (``rel_unforced``), with the forced rows whose own route
    differs (``flips``)."""
    from neuronx_distributed_tpu_torch.inference.generate import (
        pack_padded_prompt,
        serving_clones,
        suffix_prefill_step,
    )
    from neuronx_distributed_tpu_torch.modules.attention import seed_cache_prefix
    from neuronx_distributed_tpu_torch.serving.engine import _bucket, _suffix_bucket

    prompts, cfgs = workload
    _, decode = serving_clones(model)
    L = model.config.max_seq_len
    out = []
    with torch.no_grad():
        for name, i in (("short tail", 1), ("long tail", 6), ("duplicate", 11)):
            ctx = prompts[i]
            p = len(ctx)
            entry, m_use = engine.prefix.peek(ctx)
            if name != "duplicate":  # the reuse the tails got at admission: the system prompt
                m_use = ROWS_PREFIX
            padded = _bucket(p, L, cfgs[i].max_new_tokens)
            ids, mask = pack_padded_prompt(ctx, padded)
            cache = model.new_cache(1)
            full = model(torch.from_numpy(ids).long().cuda(), mode="prefill", cache=cache,
                         padding_mask=torch.from_numpy(mask).cuda(), last_only=True)[0, -1].float()
            chunk = _suffix_bucket(p - m_use, padded, L)
            seed_cache_prefix(cache, entry.tree, m_use, padded - p)
            sfx, _ = pack_padded_prompt(ctx[m_use:], chunk, pad_side="right")
            if rec is not None:
                rec.take()  # the full prefill's
            hit = suffix_prefill_step(decode, cache, torch.from_numpy(sfx).long().cuda(),
                                      p - m_use).float()
            del cache
            if not torch.isfinite(hit).all():
                raise AssertionError(f"non-finite suffix-prefill logits ({name})")
            extra = {}
            if rec is not None:
                (sfx_routes,) = rec.take()
                routes = torch.cat([rec.routes_for(ctx, m_use), sfx_routes[:p - m_use].cpu()])
                routes = torch.cat([torch.full((padded - p,) + routes.shape[1:], -1,
                                               dtype=routes.dtype), routes])
                extra = dict(rel_unforced=max_err(hit, full) / float(full.abs().max()))
                with forced_routes(model, routes) as flips:
                    full = model(torch.from_numpy(ids).long().cuda(), mode="prefill",
                                 cache=model.new_cache(1), padding_mask=torch.from_numpy(mask).cuda(),
                                 last_only=True)[0, -1].float()
                extra["flips"] = flips[0]
            scale = float(full.abs().max())
            rel = max_err(hit, full) / scale
            in_top5 = bool((hit.topk(5).indices == full.argmax()).any())
            if rel > 5e-2 or not in_top5:
                raise AssertionError(f"hit logits ({name}) disagree with the full prefill"
                                     f"{' on their routes' if rec is not None else ''}: rel "
                                     f"{rel}, full top-1 in the hit's top-5: {in_top5}")
            out.append(dict(name=name, p=p, m=m_use, chunk=chunk, rows=4 * chunk, rel_err=rel,
                            argmax_equal=bool(hit.argmax() == full.argmax()), logit_scale=scale,
                            hit=hit, **extra))
    torch.cuda.empty_cache()
    return out


def prefix_phase(model) -> dict:
    """Phase 5c: the prefix workload through the row and the paged engine,
    each with the prefix cache (``"auto"``) and without, checked and
    printed; the hit logits against full prefills on the row engine's
    store. Returns the prefix-on runs' launches by wrapper (replays
    included) and multi-row launches."""
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache

    cfg = model.config
    workload = prefix_workload(cfg.vocab_size)
    out = {"launches": dict.fromkeys(kernel_counters(), 0), "multi_row": {}}
    for paged in (False, True):
        name = "paged" if paged else "row"
        on = serve_prefix(model, workload, paged, PrefixCache())
        if not paged:
            hits = check_hit_logits(model, on["engine"], workload)
        drain_prefix_store(on)
        off = serve_prefix(model, workload, paged, None)
        drain_prefix_store(off)
        d = on["delta"]
        # JAX counts 11 hits and 1 miss on this traffic (tests/test_torch_prefix.py)
        if (d["prefix_hits"], d["prefix_misses"], d["prefix_validation_failures"]) != (11, 1, 0):
            raise AssertionError(f"{name} prefix serving: hits {d['prefix_hits']}, misses "
                                 f"{d['prefix_misses']}, validation failures "
                                 f"{d['prefix_validation_failures']}; want 11, 1, 0")
        if on["multi_row"]["paged_flash_decode" if paged else "flash_decode"] < 1:
            raise AssertionError(f"{name} prefix serving never took the multi-row path")
        if paged and (on["copy_bytes"] != 0
                      or d["prefix_pages_shared"] < ROWS_PREFIX // PAGE * d["prefix_hits"]):
            raise AssertionError(f"paged prefix serving: copy_bytes {on['copy_bytes']}, pages "
                                 f"shared {d['prefix_pages_shared']} for {d['prefix_hits']} hits")
        same = sum(a == b for a, b in zip(on["tokens"], off["tokens"]))
        ttft_on, ttft_off = on["ttft"], off["ttft"]
        ds = {k: off["delta"][k] for k in ("prefill_full_wall_s", "prefill_full_count")}
        log(f"prefix serving ({name} engine, "
            + (f"{PAGED_SLOTS} slots, page_size {PAGE}, {ROW_SLOTS * cfg.max_seq_len // PAGE + 1} "
               "pages" if paged else "8 slots") + f", chunk 8, conservative): 12 requests, a "
            f"{ROWS_PREFIX}-token system prompt + tails of 4-8 (4), 100-400 (7) and a duplicate, "
            f"32 new tokens, half greedy; prefix on: hits {d['prefix_hits']}, misses "
            f"{d['prefix_misses']}, hit rate {d['prefix_hits'] / (d['prefix_hits'] + d['prefix_misses']):.3f}, tokens reused "
            f"{d['prefix_tokens_reused']}, evictions {d['prefix_evictions']}, validation failures "
            f"{d['prefix_validation_failures']}; wall {on['wall_s']:.3f} s (off {off['wall_s']:.3f})")
        log(f"prefix serving ({name}): prefill wall full {d['prefill_full_wall_s']:.4f} s over "
            f"{d['prefill_full_count']} (mean {d['prefill_full_wall_s'] / max(d['prefill_full_count'], 1):.4f}), "
            f"suffix {d['prefill_suffix_wall_s']:.4f} s over {d['prefill_suffix_count']} (mean "
            f"{d['prefill_suffix_wall_s'] / max(d['prefill_suffix_count'], 1):.4f}); prefix off: "
            f"full {ds['prefill_full_wall_s']:.4f} s over {ds['prefill_full_count']} (mean "
            f"{ds['prefill_full_wall_s'] / max(ds['prefill_full_count'], 1):.4f}); TTFT mean "
            f"{statistics.mean(ttft_on):.4f} s max {max(ttft_on):.4f} s on, mean "
            f"{statistics.mean(ttft_off):.4f} s max {max(ttft_off):.4f} s off")
        dec = "paged_flash_decode" if paged else "flash_decode"
        log(f"prefix serving ({name}) launches, prefix on: K1 {on['launches']['flash_attention']} "
            f"(full prefills), {dec} {on['launches'][dec] + on['replayed']} ("
            f"{on['launches'][dec] - on['multi_row'][dec]} suffix prefills at R <= 32, "
            f"{on['multi_row'][dec]} at R > 32 on the multi-row path, {on['replayed']} in decode "
            f"replays); prefix off: K1 {off['launches']['flash_attention']}, {dec} "
            f"{off['launches'][dec] + off['replayed']} ({off['replayed']} in replays); streams "
            f"identical on and off: {same} of 12 (reported, not gated: K1 and K4/K5 round "
            f"bf16 differently)")
        if paged:
            log(f"prefix serving (paged): copy_bytes {on['copy_bytes']}, prefix_pages_shared "
                f"{d['prefix_pages_shared']} (warm-up wave included {on['pages_shared_total']}), pinned pages "
                f"bitwise unchanged from pin to the end: {on['pinned_pages']}, peak pages mapped "
                f"{on['snap']['peak_pages_mapped']} (off {off['snap']['peak_pages_mapped']}); "
                f"check() clean after every step; after clear and drain every page but the null "
                f"page is free")
        else:
            log(f"prefix serving (row): entries hold {on['entry_bytes'] / 2**30:.3f} GiB of K/V "
                f"copies at the end of the wave")
            for h in hits:
                log(f"hit logits vs full prefill ({h['name']}: p={h['p']}, reused {h['m']}, "
                    f"suffix chunk {h['chunk']}, R={h['rows']}): rel_err {h['rel_err']:.3g}, "
                    f"argmax equal {h['argmax_equal']}, logit_scale {h['logit_scale']:.3g}")
            prof = profile_prefix(model, workload, on["wall_s"], d["prefill_suffix_wall_s"])
            suffix = ("not measured (no device-side range in the profile)"
                      if prof["suffix_device_ms"] is None else
                      f"{prof['suffix_device_ms']:.2f} of their unprofiled wall "
                      f"{prof['suffix_wall_ms']:.2f} (host issue share {prof['suffix_host_share']:.3f})")
            log("device time of prefix serving (row engine, prefix on, the measured wave once more "
                "under the profiler, ms): " + ", ".join(f"{k} {v:.2f}" for k, v in prof["fams"].items())
                + f"; busy {prof['busy_ms']:.2f} of the unprofiled wall {1e3 * on['wall_s']:.2f} "
                f"(idle share {prof['idle_share']:.3f}); device ms inside the {prof['hits']} hits' "
                f"suffix prefills: {suffix}")
            out["profile"] = prof
        for k in out["launches"]:
            out["launches"][k] += on["launches"][k] + (on["replayed"] if k == dec else 0)
        out["multi_row"][dec] = on["multi_row"][dec]
    return out


# --- phase 5d: speculative serving ---------------------------------------------

SPEC_GAMMA, SPEC_DRAFT_LAYERS = 4, 1  # bench.py's serving_spec leg: an early-exit draft


def teacher_ratio(model, workload, tokens) -> float:
    """The emitted greedy tokens against a teacher-forced target pass: one
    forward of prompt + emitted tokens (K1, no cache) whose logits at each
    emitted position must put the emitted token within phase 3's limit of
    the row's maximum logit, 5e-2 of the logit scale. Returns the largest
    gap over its limit (above 1 fails)."""
    import numpy as np

    prompts, cfgs = workload
    worst = 0.0
    with torch.no_grad():
        for p, toks, c in zip(prompts, tokens, cfgs):
            if c.temperature != 0.0:
                continue
            ids = torch.tensor(np.concatenate([p, toks[:-1]])[None], device=model.device)
            x = model.model(ids, mode="train")
            logits = model.lm_head(x[:, len(p) - 1:]).float()[0]  # row j predicts toks[j]
            emitted = torch.tensor(toks, device=model.device)[:, None]
            gap = logits.max(-1).values - logits.gather(-1, emitted)[:, 0]
            worst = max(worst, float((gap / (5e-2 * logits.abs().max())).max()))
    return worst


def serve_spec(target, draft, workload, paged: bool = False, eager: bool = False,
               profiled: bool = False, own_draft: bool = False, quantize=None, injector=None,
               between=None, slots: int = 8) -> dict:
    """Phase 4's six requests through an engine with the speculative round
    (``draft`` None: the same engine without it): 8 slots, chunk 8
    (rounds), conservative, ``prefix_cache=None``; ``paged`` over a pool of
    ROW_SLOTS row slots' bytes of 16-column pages, the draft's of the same
    geometry; ``eager`` runs the round eagerly (the graph's witness);
    ``profiled`` captures first and runs under the profiler. Every kernel's
    launch count is zeroed just before and read just after; each executed
    round launches the draft's draft_layers x gamma decode kernels and the
    target's one a layer, K5 on the paged engine and K4 on the row one, and
    never the multi-row path; each admission K1 once a layer of both
    models. Phase 5j's: ``own_draft`` gives the engine a copy of the draft's
    tensors (``draft_params=``), ``quantize`` its target (DQ once a linear
    of every target forward; with ``kv``, paged, the target's pool int8
    and the draft's float: the target's verify window attends through K5q
    with the write, counted in K5q's launches too, the draft's steps
    through K5, and QW writes only the target's prefills), ``injector`` a
    fault schedule, ``between(engine, i)`` runs after the i-th decode-only
    step, and ``slots`` is the engine's (phase 5f(e): 16, the paged serving
    geometry)."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        paged_flash_decode_fwd,
    )
    from neuronx_distributed_tpu_torch.models.llama import shares_storage
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    prompts, cfgs = workload
    cfg = target.config
    layers = cfg.num_layers
    kw = dict(kv_page_size=PAGE, kv_num_pages=ROW_SLOTS * cfg.max_seq_len // PAGE + 1) if paged else {}
    spec = dict(draft_model=draft, gamma=SPEC_GAMMA) if draft is not None else {}
    if own_draft:
        spec["draft_params"] = draft.state_dict()
    engine = ServingEngine(target, num_slots=slots, decode_chunk_size=8, prefix_cache=None, **kw,
                           **spec, quantize=quantize, fault_injector=injector)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    flash_decode_fwd.multi_row_launches = paged_flash_decode_fwd.multi_row_launches = 0
    capture_s = prewarm(engine) if profiled else 0.0
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
           else contextlib.nullcontext())
    with eager_decode_step() if eager else contextlib.nullcontext(), ctx as prof:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
        engine.step()  # admits all six: twelve prefills (target, draft), then one chunk
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        executed0 = engine.metrics.executed_steps
        i = 0
        while engine.has_work:
            engine.step()
            if between is not None:
                between(engine, i)
            i += 1
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches, warm = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    multi = flash_decode_fwd.multi_row_launches + paged_flash_decode_fwd.multi_row_launches
    what = (f"speculative {'paged' if paged else 'row'} serving" if draft is not None
            else "spec-off serving") + (" (eager round)" if eager else "")
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != r.config.max_new_tokens:
            raise AssertionError(f"{what}: request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"{what}: request {r.rid}: token outside the vocabulary")
    snap = engine.metrics.snapshot()
    d_layers = draft.config.num_layers if draft is not None else 0
    per_round = d_layers * SPEC_GAMMA + layers
    dec, other = (("paged_flash_decode", "flash_decode") if paged
                  else ("flash_decode", "paged_flash_decode"))
    qkv = quantize is not None and quantize.kv is not None
    # an int8 target pool: the draft's steps on K5, the target's verify on
    # K5q with the write (counted under both names), its prefills on QW
    rounds = {dec: d_layers * SPEC_GAMMA, "qpaged_flash_decode": layers,
              "qpaged_write_attend": layers} if qkv else {dec: per_round}
    got = ({k: launches[k] - warm[k] for k in rounds}, launches[other], multi,
           launches["flash_attention"], launches["window_requantize"] - warm["window_requantize"])
    want = ({k: snap["executed_steps"] * n for k, n in rounds.items()}, 0, 0,
            snap["prefills"] * (layers + d_layers), snap["prefills"] * layers * qkv)
    if got != want:
        raise AssertionError(f"{what}: launches (decode kernels less the warm-up, {other}, "
                             f"multi-row, K1, QW) {got} != {want} ({snap['executed_steps']} "
                             f"executed rounds x {rounds}, {snap['prefills']} admissions x "
                             f"{layers + d_layers})")
    check_program(engine, what, eager)
    prog = decode_program(engine)
    linears = 7 * layers + 1 if quantize is not None and quantize.weights else 0
    want_replay = {**rounds, **({"dequantize": linears} if linears else {})}
    if not eager and prog.launches_per_replay != want_replay:
        raise AssertionError(f"{what}: launches per replay {prog.launches_per_replay}, want "
                             f"{want_replay}")
    if (launches["dequantize"] - warm["dequantize"]
            != (snap["executed_steps"] + snap["prefills"]) * linears):
        raise AssertionError(f"{what}: DQ launches {launches['dequantize']} (warm-up "
                             f"{warm['dequantize']}) != (executed rounds + admissions) x "
                             f"{linears} linears")
    if paged:
        engine.cache.check()
        if engine.draft_cache is not None:
            engine.draft_cache.check()
    res = dict(tokens=[list(r.tokens) for r in reqs], launches=launches, snap=snap,
               wall_s=t2 - t0, decode_s=t2 - t1,
               decode_executed=snap["executed_steps"] - executed0, per_round=per_round,
               compilations=engine.decode_compilations, replays=prog.replays,
               per_replay=dict(prog.launches_per_replay), capture_s=capture_s or snap["capture_s"],
               sampled_rounds=sum(len(r.tokens) - 1 for r in reqs if r.config.temperature > 0),
               # of the decode launches, the target's verify windows: a layer
               # each round that went through the wrapper (the capture's
               # warm-up, the eager rounds) or was replayed
               verify=(launches["qpaged_write_attend"] if qkv
                       else (launches[dec] // per_round) * layers),
               # the served target (a quantized copy under ``quantize``) and
               # the draft's tensors, for phase 5j's checks
               model=engine.model, draft_state=engine.draft_params,
               draft_alone=draft is None or not shares_storage(engine.draft_model, engine.model))
    if profiled:
        res["records"] = decode_records(prof, paged=paged)
        if res["records"] != 2 * snap["executed_steps"] * per_round:
            raise AssertionError(f"{what}, profiled: {res['records']} decode kernel records != 2 "
                                 f"x {snap['executed_steps']} executed rounds x {per_round}")
        res["fams"] = device_time_by_family(prof, {"flash_attention": "flash_fwd_kernel",
                                                   "flash_decode": "flash_decode_kernel"})
    del engine
    torch.cuda.empty_cache()
    return res


def greedy_accept_rate(res: dict) -> float:
    """The acceptance rate of the greedy slots: a sampled slot accepts
    nothing by construction and emits one token a round, so its rounds
    (its tokens after the first) are taken out of the drafted count."""
    sn = res["snap"]
    drafted = sn["spec_draft_tokens"] - SPEC_GAMMA * res["sampled_rounds"]
    return sn["spec_accepted_tokens"] / drafted if drafted else 0.0


def spec_phase(model, workload, smi: str) -> dict:
    """Phase 5d: phase 4's workload through the early-exit pair of ``model``
    (the target's first layer as the draft, gamma 4): eps 0 spec on; eps
    0.3 spec on, spec off, and spec on with the eager round patched in;
    the paged engine at eps 0.3; the eps 0.3 row run once more under the
    profiler. Checked and printed; returns the eps 0.3 row and paged runs'
    launches by wrapper (replays included) and those of them that were the
    target's verify windows (K4 in the row run, K5 in the paged)."""
    from neuronx_distributed_tpu_torch.models.llama import early_exit_draft

    t_phase = time.perf_counter()
    runs = {}
    for eps in (0.0, 0.3):
        target, draft = early_exit_draft(model, SPEC_DRAFT_LAYERS, eps)
        names = ("on",) if eps == 0.0 else ("on", "off", "eager", "paged", "profiled")
        for name in names:
            r = serve_spec(target, None if name == "off" else draft, workload,
                           paged=name == "paged", eager=name == "eager",
                           profiled=name == "profiled")
            r["teacher"] = teacher_ratio(target, workload, r["tokens"])
            runs[(eps, name)] = r
        del target, draft
        torch.cuda.empty_cache()
    on, off, wit = runs[(0.3, "on")], runs[(0.3, "off")], runs[(0.3, "eager")]
    if wit["tokens"] != on["tokens"] or runs[(0.3, "profiled")]["tokens"] != on["tokens"]:
        raise AssertionError("speculative serving: the captured round's streams differ from the "
                             "eager round's or the profiled rerun's")
    rate0 = greedy_accept_rate(runs[(0.0, "on")])
    if rate0 < 0.9:
        raise AssertionError(f"speculative serving at eps 0: the greedy slots accept {rate0:.3f} of "
                             "their drafts (draft and target are the same function up to GEMM "
                             "shape)")
    for key, r in runs.items():
        if r["teacher"] > 1.0:
            raise AssertionError(f"speculative serving {key}: an emitted greedy token lies "
                                 f"{r['teacher']:.3g}x phase 3's limit below its row's maximum "
                                 "logit in the teacher-forced pass")
    for (eps, name), r in runs.items():
        sn = r["snap"]
        acc = ("" if name == "off" else
               f"; acceptance: rate {sn['spec_accept_rate']:.4f} (greedy slots "
               f"{greedy_accept_rate(r):.4f}), rounds {sn['spec_rounds']}, drafted "
               f"{sn['spec_draft_tokens']}, accepted {sn['spec_accepted_tokens']}, wasted "
               f"{sn['draft_tokens_wasted']}, accept_len p50 {sn['spec_accept_len_p50']} p95 "
               f"{sn['spec_accept_len_p95']}")
        log(f"speculative serving eps {eps} {name} ({smi}): wall {r['wall_s']:.3f} s (capture "
            f"{r['capture_s']:.4f} s), TTFT mean {sn['mean_ttft']:.4f} s max {sn['max_ttft']:.4f} s, "
            f"decode {sn['chunk_tokens_per_sec']:.1f} tok/s (chunk wall), "
            f"{r['decode_executed']} decode-only {'steps' if name == 'off' else 'rounds'} executed "
            f"in {r['decode_s']:.4f} s ({1e3 * r['decode_s'] / max(r['decode_executed'], 1):.2f} "
            f"ms each), executed {sn['executed_steps']} (live {sn['steps']}), replays "
            f"{r['replays']}, decode_compilations {r['compilations']}, launches {r['launches']} "
            f"({r['per_round']} decode kernels a replay), teacher-forced gap "
            f"{r['teacher']:.3g}x its limit{acc}")
    same = sum(a == b for a, b in zip(on["tokens"], off["tokens"]))
    agree = sum(x == y for a, b in zip(on["tokens"], off["tokens"]) for x, y in zip(a, b))
    paged_same = sum(a == b for a, b in zip(runs[(0.3, "paged")]["tokens"], on["tokens"]))
    log(f"speculative serving eps 0.3: streams identical to the eager round's and the profiled "
        f"rerun's (6 of 6); to the spec-off engine's {same} of 6 ({agree} of "
        f"{sum(len(a) for a in on['tokens'])} tokens agree; reported, not gated: the verify "
        f"forward's GEMMs have M = gamma x slots); the paged engine's to the row engine's "
        f"{paged_same} of 6; both paged pools check() clean")
    prof = runs[(0.3, "profiled")]
    busy = sum(prof["fams"].values())
    wall_ms = 1e3 * (on["wall_s"] - on["capture_s"])
    log(f"device time of speculative serving, eps 0.3, row (profiler, ms; round captured before "
        f"the profiler opened): " + ", ".join(f"{k} {v:.2f}" for k, v in prof["fams"].items())
        + f"; busy {busy:.2f} of the unprofiled wall less its capture {wall_ms:.2f} (idle share "
        f"{1 - busy / wall_ms:.3f}); K4 kernel records {prof['records']} = 2 x "
        f"{prof['snap']['executed_steps']} executed rounds x {prof['per_round']}")
    log(f"phase 5d wall: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches={k: on["launches"][k] + runs[(0.3, "paged")]["launches"][k]
                          for k in on["launches"]}, tokens=on["tokens"],
                verify={"flash_decode": on["verify"],
                        "paged_flash_decode": runs[(0.3, "paged")]["verify"]})


# --- phase 5e: Medusa tree decoding ----------------------------------------------

MEDUSA_HEADS, MEDUSA_PROMPT, MEDUSA_TRAIN_STEPS, MEDUSA_LR = 4, 256, 30, 1e-3


# host seconds between the profile's edges and the Medusa replays. The
# profiler mostly loses the first kernel launched after it opens (the
# marker below: chip_medusa_profile.py), and a run whose first launch
# was a replay once lost 38 K4 records; the marker takes that place, and
# the margin keeps the replays clear of the opening
PROFILE_MARGIN_S = 0.1


@contextlib.contextmanager
def profile_after_capture():
    """A ``torch.profiler`` run that opens right after the Medusa round's
    capture (the warm-up and the capture stay outside it; the first
    replay and every later one are inside). Once the profiler is open, a
    marker kernel (``torch.cuda._sleep``, named ``spin_kernel``) is the
    first launch and is waited for, then ``PROFILE_MARGIN_S`` pass before
    the first replay; the same margin passes after the last one before
    the profiler stops. Yields the profiler, stopped on exit."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    saved = DecodeProgram.capture

    def capture(self):
        took = saved(self)
        prof.start()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        time.sleep(PROFILE_MARGIN_S)
        return took

    DecodeProgram.capture = capture
    try:
        yield prof
    finally:
        DecodeProgram.capture = saved
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        prof.stop()


def medusa_run(model, prompts, new: int, eager: bool = False, profiled: bool = False) -> dict:
    """One ``medusa_generate`` call of ``model`` (a MedusaForCausalLM over
    the full-width base) on ``prompts`` (B, S) int64 for ``new`` tokens,
    with every kernel's launch count zeroed just before and read just
    after: the round one CUDA graph (``eager``: the eager round patched in,
    the witness), captured once and replayed every round, each replay K4
    once a layer and nothing else; the prefill K1 once a layer; no
    multi-row launch. ``profiled`` opens the profiler after the capture.
    The round walls are the host clock between two rounds' reads (each
    read waits for its round), from the second round on."""
    from neuronx_distributed_tpu_torch.inference.medusa import MedusaStats, medusa_generate
    from neuronx_distributed_tpu_torch.kernels.flash_decode import flash_decode_fwd

    layers = model.config.num_layers
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    flash_decode_fwd.multi_row_launches = 0
    stats = MedusaStats()
    with contextlib.ExitStack() as stack:
        if eager:
            stack.enter_context(eager_decode_step())
        prof = stack.enter_context(profile_after_capture()) if profiled else None
        t0 = time.perf_counter()
        toks, acc = medusa_generate(model, prompts, new, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prog, rounds = stats.program, len(stats.emitted)
    launches = {name: c.launches for name, c in counters.items()}
    what = f"medusa B={prompts.shape[0]}{' (eager round)' if eager else ''}"
    want = (0, 0, {}) if eager else (1, rounds, {"flash_decode": layers})
    if (prog.captures, prog.replays, prog.launches_per_replay) != want:
        raise AssertionError(f"{what}: captures {prog.captures}, replays {prog.replays}, launches "
                             f"per replay {prog.launches_per_replay}; want {want} ({rounds} rounds)")
    k4 = rounds * layers if eager else layers  # eager rounds, or the capture's warm-up
    got = (launches["flash_attention"], launches["flash_decode"],
           flash_decode_fwd.multi_row_launches,
           sum(n for k, n in launches.items() if k not in ("flash_attention", "flash_decode")))
    if got != (layers, k4, 0, 0):
        raise AssertionError(f"{what}: launches (K1, K4 through the wrapper, multi-row, other) "
                             f"{got} != {(layers, k4, 0, 0)}")
    launches["flash_decode"] += prog.replays * layers
    if tuple(toks.shape) != (prompts.shape[0], new) or int(toks.min()) < 0 or \
            int(toks.max()) >= model.config.vocab_size:
        raise AssertionError(f"{what}: tokens of shape {tuple(toks.shape)} or outside the vocabulary")
    gaps = [b - a for a, b in zip(stats.round_end_s, stats.round_end_s[1:])]
    res = dict(tokens=toks.cpu().numpy(), acc=acc, stats=stats, wall_s=wall, rounds=rounds,
               launches=launches, capture_s=prog.capture_s,
               round_ms=1e3 * statistics.median(gaps),
               per_round=statistics.mean(stats.emitted))
    res["tok_s"] = prompts.shape[0] * res["per_round"] / (res["round_ms"] / 1e3)
    if profiled:
        res["fams"] = device_time_by_family(prof, {"flash_attention": "flash_fwd_kernel",
                                                   "flash_decode": "flash_decode_kernel"})
        res["records"] = decode_records(prof, paged=False)
        res["markers"] = sum(str(getattr(e, "device_type", "")).endswith("CUDA")
                             and "spin_kernel" in e.name for e in prof.events())
        res["top"] = top_kernels(prof)
    return res


def train_medusa_heads(model, serve, seq) -> dict:
    """Head training by self-distillation on ``seq`` (1, S): fp32 master
    heads over ``model``'s frozen bf16 base (shared), from the seed the
    serving heads ``serve`` were drawn from, MEDUSA_TRAIN_STEPS steps of
    the port's AdamW at weight decay 0 (optax's adam); the backbone runs
    under no_grad, the loss head by head. The trained heads are then cast
    into ``serve``. Returns the loss curve, step walls and peak memory."""
    from neuronx_distributed_tpu_torch.models.medusa import (
        MedusaForCausalLM,
        init_medusa_heads,
        medusa_head_loss,
    )
    from neuronx_distributed_tpu_torch.trainer.trainer import AdamW

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train = init_medusa_heads(MedusaForCausalLM(model.config, MEDUSA_HEADS, base=model,
                                                trainable=True), seed=1)
    heads = train.head_parameters()
    opt = AdamW(MEDUSA_LR, weight_decay=0.0)
    state = opt.init(heads)
    labels = torch.roll(seq, -1, dims=1)
    losses, walls = [], []
    for _ in range(MEDUSA_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = medusa_head_loss(train, seq, labels)
        opt.update(heads, torch.autograd.grad(loss, heads), state)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    serve.load_state_dict({k: v for k, v in train.state_dict().items() if k.startswith("medusa")},
                          strict=False)
    n_params = sum(p.numel() for p in heads)
    del train, heads, opt, state
    torch.cuda.empty_cache()
    return dict(losses=losses, walls=walls, peak_gib=peak, n_params=n_params)


def medusa_round_parts(serve, prompts) -> dict:
    """Device ms of a Medusa round's parts at its shapes after ``prompts``
    (B, S), each a CUDA-graph replay (``graph_ms``): the W-token window
    step (32 layers, K4), the LM head and the four heads at one position,
    the tree verify with its LM head, and the verify's masked attention
    alone (32 layers). Its launches count nowhere."""
    from neuronx_distributed_tpu_torch.inference.medusa import DEFAULT_CHOICES, tree_attention_mask
    from neuronx_distributed_tpu_torch.modules.attention import tree_decode_attention
    from neuronx_distributed_tpu_torch.utils.medusa import generate_medusa_buffers, medusa_buffers_on

    cfg, b = serve.config, prompts.shape[0]
    bufs = medusa_buffers_on(generate_medusa_buffers(DEFAULT_CHOICES), "cuda")
    cache = serve.new_cache(b)
    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():
        serve.model(prompts, "prefill", cache)
        start = cache.cursor.clone()
        cur = start + 1
        mask = tree_attention_mask(cur, bufs["attn_mask"],
                                   torch.arange(cfg.max_seq_len, device="cuda"))
        h1 = torch.randn(b, 1, cfg.hidden_size, generator=gen, device="cuda").to(cfg.dtype)
        q = torch.randn(b, 8, cfg.num_heads, cfg.head_dim_, generator=gen,
                        device="cuda").to(cfg.dtype)

        def step():
            cache.cursor.copy_(start)
            serve.model(prompts[:, :4], "decode", cache)

        def heads():
            serve.lm_head(h1)
            serve.medusa_logits(h1)

        def verify():
            cache.cursor.copy_(cur)
            serve.lm_head(serve.model(prompts[:, :8], "decode", cache,
                                      positions=cur + bufs["position_ids"], attn_mask=mask))

        def tree_attention():
            for layer in range(cfg.num_layers):
                tree_decode_attention(q, cache.k[layer], cache.v[layer], mask, cache.valid)

        parts = {name: graph_ms(fn, 1, replays=10) for name, fn in (
            ("window step", step), ("heads", heads), ("verify", verify),
            ("tree attention", tree_attention))}
    del cache
    torch.cuda.empty_cache()
    return parts


def medusa_phase(model, smi: str) -> dict:
    """Phase 5e: Medusa over phase 4's base (shared, not copied) with 4
    bf16 heads from a seed, DEFAULT_CHOICES, top_k 10: random heads at B =
    1 (256-token prompt, 128 new tokens); the base's greedy ``generate``
    of 256 tokens after that prompt; 30 steps of head training on the 512
    tokens; the trained heads at B = 1 (the same prompt, 128 new) and B =
    4 (four 256-token prompts, the trained one first, 64 new); the B = 1
    trained run again with the eager round (bit for bit) and, its first 32
    tokens, under the profiler. Checked and printed; returns the main runs' launches by
    wrapper (replays included: random, generate, training, trained B = 1
    and B = 4)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
    from neuronx_distributed_tpu_torch.models.medusa import MedusaForCausalLM, init_medusa_heads

    t_phase = time.perf_counter()
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(11)
    prompts = torch.randint(1, cfg.vocab_size, (4, MEDUSA_PROMPT), generator=gen, device="cuda")
    serve = init_medusa_heads(MedusaForCausalLM(cfg, MEDUSA_HEADS, base=model), seed=1)
    runs = {"random": medusa_run(serve, prompts[:1], 128)}

    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    cont = generate(model, prompts[:1], GenerationConfig(256, temperature=0.0))
    torch.cuda.synchronize()
    gen_ms = 1e3 * (time.perf_counter() - t0) / 256
    seq = torch.cat([prompts[:1], cont], dim=1)
    tr = train_medusa_heads(model, serve, seq)
    train_launches = {name: c.launches for name, c in counters.items()}
    if tr["peak_gib"] >= 72.0:
        raise AssertionError(f"medusa head training: peak memory {tr['peak_gib']:.2f} GiB >= 72")
    if not all(math.isfinite(x) for x in tr["losses"]) or tr["losses"][-1] >= tr["losses"][0]:
        raise AssertionError(f"medusa head training: the loss did not fall: {tr['losses']}")

    runs["trained"] = medusa_run(serve, prompts[:1], 128)
    runs["trained B=4"] = medusa_run(serve, prompts, 64)
    wit = medusa_run(serve, prompts[:1], 128, eager=True)
    # the profiled rerun is the trained run's first 32 tokens (a shorter run
    # takes the same rounds, fewer of them): the profiler's records of 128
    # tokens' rounds take a minute to process
    prof = medusa_run(serve, prompts[:1], 32, profiled=True)
    main = runs["trained"]
    for name, r in (("eager round", wit), ("profiled rerun", prof)):
        n, k = r["tokens"].shape[1], len(r["stats"].accept_lens)
        if (not np.array_equal(r["tokens"], main["tokens"][:, :n])
                or r["stats"].accept_lens != main["stats"].accept_lens[:k]):
            raise AssertionError(f"medusa: the {name}'s tokens or accepted lengths differ from the "
                                 "captured run's")
    if max(main["stats"].emitted) < 2:
        raise AssertionError("medusa with trained heads at B = 1: no round emitted 2 tokens or more")
    for name, r in runs.items():
        rows = list(prompts[:len(r["tokens"])].cpu().numpy())
        cfgs = [GenerationConfig(r["tokens"].shape[1], temperature=0.0)] * len(rows)
        r["teacher"] = teacher_ratio(model, (rows, cfgs), list(r["tokens"]))
        if r["teacher"] > 1.0:
            raise AssertionError(f"medusa {name}: an emitted token lies {r['teacher']:.3g}x phase "
                                 "3's limit below its row's maximum logit in the teacher-forced "
                                 "pass")
    agree = {name: int((torch.as_tensor(runs[name]["tokens"][0]) == cont[0, :128].cpu()).sum())
             for name in ("random", "trained")}

    log(f"medusa head training ({smi}): {MEDUSA_HEADS} heads, {tr['n_params'] / 1e9:.3f} B "
        f"params fp32 over the frozen bf16 base, self-distillation on the base's greedy "
        f"continuation ({MEDUSA_PROMPT} + 256 tokens), AdamW lr {MEDUSA_LR} wd 0, {MEDUSA_TRAIN_STEPS} steps: "
        f"step wall {statistics.median(tr['walls'][1:]):.4f} s (median), peak mem "
        f"{tr['peak_gib']:.2f} GiB; losses " + ", ".join(f"{x:.4f}" for x in tr["losses"]))
    log(f"plain greedy generate ({smi}): 256 tokens at B = 1 after a {MEDUSA_PROMPT}-token "
        f"prompt, {gen_ms:.2f} ms a token (eager steps, prefill included)")
    for name, r in (*runs.items(), ("trained, eager round", wit)):
        sn = r["stats"]
        log(f"medusa {name} ({smi}): B={len(sn.accept_lens[0])} {r['tokens'].shape[1]} new "
            f"tokens, {r['rounds']} rounds, {r['round_ms']:.3f} ms a round (median, rounds 2-; "
            f"{'eager' if r is wit else 'graph replays'}), {r['per_round']:.3f} tokens a round "
            f"realised, {r['tok_s']:.1f} tokens/s, mean_accepted {r['acc']:.4f}, emitted a round "
            f"max {max(sn.emitted)}, wall {r['wall_s']:.3f} s (capture {r['capture_s']:.4f} s of "
            f"it), launches {r['launches']}"
            + (f", teacher-forced gap {r['teacher']:.3g}x its limit" if "teacher" in r else ""))
    busy = sum(prof["fams"].values())
    per_round = busy / prof["rounds"]
    log(f"device time of medusa trained B=1 (profiler opened after the capture, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in prof["fams"].items())
        + f"; {per_round:.3f} busy a round against {main['round_ms']:.3f} ms a round unprofiled "
        f"(idle share {1 - per_round / main['round_ms']:.3f}); K4 kernel records "
        f"{prof['records']} = 2 x {prof['rounds']} rounds x {cfg.num_layers}; the opening "
        f"marker recorded {prof['markers']} time(s)")
    log("heaviest kernels of those rounds (ms a round, launches a round): " + "; ".join(
        f"{name[:70]} {ms / prof['rounds']:.3f} ({k / prof['rounds']:.0f})"
        for name, ms, k in prof["top"]))
    if prof["records"] != 2 * prof["rounds"] * cfg.num_layers:
        raise AssertionError(f"medusa profiled: {prof['records']} K4 records != 2 x "
                             f"{prof['rounds']} rounds x {cfg.num_layers} (the opening marker "
                             f"recorded {prof['markers']} time(s))")
    for p in (prompts[:1], prompts):
        parts = medusa_round_parts(serve, p)
        log(f"medusa round parts at B={p.shape[0]} (graph replays, ms): window step "
            f"{parts['window step']:.3f} (W = 4, K4), LM head + 4 heads at one position "
            f"{parts['heads']:.3f}, tree verify + LM head {parts['verify']:.3f}, of which the "
            f"masked attention {parts['tree attention']:.3f} ({cfg.num_layers} layers, 8 nodes x "
            f"{cfg.max_seq_len} columns)")
    log(f"medusa: captured and eager rounds bit for bit equal (tokens and accepted lengths), "
        f"profiled rerun too; B=1 tokens agree with the base's greedy generate (the training "
        f"text) in {agree['random']} of 128 with random heads, {agree['trained']} with trained "
        f"ones (reported, not gated: the window step's GEMMs have another M); "
        f"phase 5e wall {time.perf_counter() - t_phase:.1f} s")
    del serve
    torch.cuda.empty_cache()
    return dict(launches={k: sum(r["launches"][k] for r in runs.values()) + train_launches[k]
                          for k in train_launches})


def top_kernels(prof, n: int = 10) -> list:
    """The ``n`` CUDA kernels of a profile with the most device time:
    (name, ms, launches), heaviest first."""
    agg = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms, k = agg.get(e.name, (0.0, 0))
            agg[e.name] = (ms + e.device_time / 1e3, k + 1)
    return sorted(((name, ms, k) for name, (ms, k) in agg.items()), key=lambda t: -t[1])[:n]


def device_time_by_family(prof, kernels: dict, skip=()) -> dict:
    """Device ms of a profile by family: each of ``kernels`` (family: a
    substring of its CUDA kernels' names, or a tuple of them; the first
    family that matches wins), GEMMs,
    and everything else; device events named in ``skip`` (the device-side
    spans of profiler ranges) are no kernels."""
    fams = {**{fam: 0.0 for fam in kernels}, "gemm": 0.0, "other": 0.0}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") or e.name in skip:
            continue
        name = e.name
        fam = next((f for f, key in kernels.items()
                    if any(k in name for k in ((key,) if isinstance(key, str) else key))), None)
        if fam is None:
            fam = ("gemm" if any(t in name for t in ("nvjet", "gemm", "cutlass", "xmma"))
                   else "other")
        fams[fam] += e.device_time / 1e3  # us -> ms
    return fams


# --- phase 5f: quantized serving -----------------------------------------------

QUANT_KL_BUDGET = 5e-3  # the JAX package's (tests/serving/test_quantized_engine.py)


def quant_kl(model, qcfg, gen) -> dict:
    """A 64-token prompt (from ``gen``) and 16 greedy steps of the bf16
    model, teacher-forced through its ``qcfg`` quantized copy
    (``quantize_model``): per-step KL of the quantized next-token
    distribution from the bf16 one (max, mean), and top-1 agreement."""
    from neuronx_distributed_tpu_torch.models.llama import quantize_model

    ids = torch.randint(1, model.config.vocab_size, (1, 64), generator=gen, device=model.device)
    ref, toks = teacher_logits(model, ids, 16)
    qm = quantize_model(model, qcfg)
    got, _ = teacher_logits(qm, ids, 16, feed=toks)
    del qm
    torch.cuda.empty_cache()
    lp = torch.log_softmax(ref.double(), -1)
    kl = (lp.exp() * (lp - torch.log_softmax(got.double(), -1))).sum(-1)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits through the quantized model")
    return dict(max_kl=float(kl.max()), mean_kl=float(kl.mean()),
                top1=float((got.argmax(-1) == ref.argmax(-1)).double().mean()))


def quant_phase(model, srv: dict, paged: dict, gen) -> dict:
    """Phase 5f: quantized serving of ``model`` at full width and depth.
    (a) int8 and (b) fp8 weights behind the row engine on phase 4's
    requests (``srv``), each with its eager-step witness; (c) int8 weights
    and an int8 pool of phase 5b's bytes (``paged``: its pool) behind the
    paged engine on phase 5b's traffic, with its witness; (d) phase 5c's
    paged prefix leg on that pool; (e) the int8 pool beside a float draft
    (``quantize.kv`` with ``draft_model=``): phase 5d's early-exit pair at
    eps 0.3, the draft's tensors its own, gamma 4, phase 4's six requests
    through the paged engine at the paged serving geometry (16 slots,
    page_size 16), with its eager-round witness. Returns the launches by
    wrapper of the runs that are no witness (replays included)."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache

    t_phase = time.perf_counter()
    cfg = model.config
    layers, linears = cfg.num_layers, 7 * cfg.num_layers + 1
    out = {"launches": dict.fromkeys(kernel_counters(), 0)}
    float_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    for kind in ("int8", "fp8"):
        qc = QuantConfig(weights=kind)
        torch.cuda.reset_peak_memory_stats()
        r = serve_workload(model, srv["workload"], quantize=qc)
        peak = torch.cuda.max_memory_allocated() / 2**30
        wit = serve_workload(model, srv["workload"], eager=True, quantize=qc)
        if wit["tokens"] != r["tokens"]:
            raise AssertionError(f"{kind} serving: the decode graph's streams differ from the "
                                 "eager step's")
        if r["per_replay"] != {"flash_decode": layers, "dequantize": linears}:
            raise AssertionError(f"{kind} serving: launches per replay {r['per_replay']}")
        kl = quant_kl(model, qc.weight_qconfig(), gen)
        if kind == "int8" and kl["max_kl"] > QUANT_KL_BUDGET:
            raise AssertionError(f"int8 weights: max KL {kl['max_kl']} against the bf16 model "
                                 f"over the budget {QUANT_KL_BUDGET}")
        same = sum(a == b for a, b in zip(r["tokens"], srv["tokens"]))
        sn = r["snap"]
        log(f"quantized serving ({kind} weights, row engine, phase 4's 6 requests): weights "
            f"{r['weight_bytes'] / 1e9:.3f} GB against bf16 {float_bytes / 1e9:.3f} GB "
            f"({r['weight_bytes'] / float_bytes:.3f}x); wall {r['wall_s']:.3f} s (capture "
            f"{sn['capture_s']:.4f} s of it), decode_compilations {r['compilations']}, replays "
            f"{r['replays']} = executed steps, launches per replay {r['per_replay']}; "
            f"{r['decode_only_executed']} decode-only steps {r['decode_s']:.4f} s "
            f"({1e3 * r['decode_s'] / max(r['decode_only_executed'], 1):.2f} ms per executed step; "
            f"eager witness {1e3 * wit['decode_s'] / max(wit['decode_only_executed'], 1):.2f}), "
            f"decode {sn['chunk_tokens_per_sec']:.1f} tok/s (chunk wall), TTFT mean "
            f"{sn['mean_ttft']:.4f} s, peak mem {peak:.1f} GiB (the bf16 model's 15.0 "
            f"included); eager-step streams identical; streams equal to bf16 phase 4's: {same} "
            f"of 6 (reported, not gated)")
        log(f"quantized serving ({kind} weights): 64-token prompt, 16 steps teacher-forced "
            f"against the bf16 model: max KL {kl['max_kl']:.3g}, mean KL {kl['mean_kl']:.3g} "
            + (f"(gated at {QUANT_KL_BUDGET})" if kind == "int8" else "(printed, not gated)")
            + f", top-1 agreement {kl['top1']:.4f} (printed, not gated: near-ties of a random "
            f"bf16 base)")
        out[kind] = dict(r, kl=kl, witness_decode_s=wit["decode_s"])
        for k in out["launches"]:
            out["launches"][k] += r["launches"][k]
    # (c) int8 weights and an int8 pool of phase 5b's bytes
    qc = QuantConfig(weights="int8", kv="int8")
    d, hkv, ps = cfg.head_dim_, cfg.num_kv_heads, PAGE
    bf16_page = 2 * layers * ps * hkv * d * 2
    int8_page = 2 * layers * (ps * hkv * d + hkv * 2)
    n_pages = paged["pool_pages"] * bf16_page // int8_page
    workload = paged_workload(cfg.vocab_size)
    c = serve_paged(model, workload, "fused", quantize=qc, num_pages=n_pages)
    cw = serve_paged(model, workload, "fused", eager=True, quantize=qc, num_pages=n_pages)
    cp = serve_paged(model, workload, "fused", profiled=True, quantize=qc, num_pages=n_pages)
    if cw["tokens"] != c["tokens"] or cp["tokens"] != c["tokens"]:
        raise AssertionError("int8 pool serving: the decode graph's streams differ from the "
                             "eager step's or the profiled rerun's")
    if c["per_replay"] != {"qpaged_flash_decode": layers, "qpaged_write_attend": layers,
                           "dequantize": linears}:
        raise AssertionError(f"int8 pool serving: launches per replay {c['per_replay']}")
    sn = c["snap"]
    log(f"quantized serving (int8 weights + int8 KV pool, paged engine, phase 5b's 15 requests, "
        f"{PAGED_SLOTS} slots, page_size {PAGE}): pool {n_pages} pages, {c['pool_gib']:.3f} GiB "
        f"(phase 5b: {paged['pool_pages']} pages, {paged['pool_gib']:.3f} GiB); all 15 DONE, "
        f"check() clean, eager-step streams identical; wall {c['wall_s']:.3f} s, replays "
        f"{c['replays']}, launches per replay {c['per_replay']}, K5q with the write "
        f"{c['launches']['qpaged_write_attend']} = executed steps {sn['executed_steps']} x "
        f"{layers} + the warm-up's {layers} (K5q's count {c['launches']['qpaged_flash_decode']} "
        f"holds them), QW {c['launches']['window_requantize']} = prefills {sn['prefills']} x "
        f"{layers}, K5 {c['launches']['paged_flash_decode']}; "
        f"{c['decode_executed']} decode-only steps {c['decode_s']:.4f} s "
        f"({1e3 * c['decode_s'] / max(c['decode_executed'], 1):.2f} ms per executed step; eager "
        f"witness {1e3 * cw['decode_s'] / max(cw['decode_executed'], 1):.2f}), decode "
        f"{sn['chunk_tokens_per_sec']:.1f} tok/s (chunk wall), mean occupancy "
        f"{sn['mean_occupancy']:.2f}, peak occupancy {sn['peak_occupancy']} (phase 5b: "
        f"{paged['snap']['peak_occupancy']}), peak pages mapped {sn['peak_pages_mapped']}, peak "
        f"mem {c['peak_gib']:.1f} GiB")
    busy = sum(cp["fams"].values())
    wall_ms = 1e3 * (c["wall_s"] - c["capture_s"])
    log(f"device time of the int8 pool serving workload (profiler, ms; decode program captured "
        f"before the profiler opened): " + ", ".join(f"{k} {v:.2f}" for k, v in cp["fams"].items())
        + f"; busy {busy:.2f} of the unprofiled wall less its capture {wall_ms:.2f} (idle share "
        f"{1 - busy / wall_ms:.3f}); K5q kernel records {cp['records']} = 2 x "
        f"{cp['snap']['executed_steps']} executed steps x {layers} layers (range with the write, "
        f"and merge)")
    out["paged"] = dict(c, fams=cp["fams"])
    for k in out["launches"]:
        out["launches"][k] += c["launches"][k]
    # (d) phase 5c's paged prefix leg on the int8 pool
    pre = serve_prefix(model, prefix_workload(cfg.vocab_size), True, PrefixCache(), quantize=qc,
                       num_pages=n_pages)
    drain_prefix_store(pre)
    dd = pre["delta"]
    if (dd["prefix_hits"], dd["prefix_misses"], dd["prefix_validation_failures"]) != (11, 1, 0):
        raise AssertionError(f"int8 pool prefix serving: hits {dd['prefix_hits']}, misses "
                             f"{dd['prefix_misses']}; want 11, 1")
    qw_pre = (pre["delta"]["prefill_full_count"] + pre["delta"]["prefill_suffix_count"]) * layers
    if ("window_requantize" in pre["per_replay"]
            or pre["per_replay"].get("qpaged_write_attend") != layers
            or pre["launches"]["window_requantize"] != qw_pre):
        raise AssertionError(f"int8 pool prefix serving: {pre['per_replay']} a replay, QW "
                             f"{pre['launches']['window_requantize']} outside replays; want K5q "
                             f"with the write {layers} and no QW a replay, QW {qw_pre} (a full or "
                             f"suffix prefill's write x {layers})")
    if pre["copy_bytes"] != 0 or pre["multi_row"]["flash_decode"] < 1 or not pre["pinned_pages"]:
        raise AssertionError(f"int8 pool prefix serving: copy_bytes {pre['copy_bytes']}, K4 "
                             f"multi-row launches {pre['multi_row']['flash_decode']}, pinned "
                             f"pages {pre['pinned_pages']}")
    log(f"quantized serving (int8 weights + int8 KV pool, phase 5c's paged prefix leg): hits "
        f"{dd['prefix_hits']}, misses {dd['prefix_misses']}, copy_bytes {pre['copy_bytes']}, "
        f"pages shared {dd['prefix_pages_shared']}, pinned pages' codes and scales bitwise "
        f"unchanged from pin to the end: {pre['pinned_pages']}; suffix prefills "
        f"{dd['prefill_suffix_count']} on K4 over a dequantized float row "
        f"({pre['launches']['flash_decode']} launches, {pre['multi_row']['flash_decode']} "
        f"multi-row), K5q {pre['launches']['qpaged_flash_decode'] + pre['replayed']} (decode "
        f"replays), K5 {pre['launches']['paged_flash_decode']}; wall {pre['wall_s']:.3f} s, suffix "
        f"prefill mean {dd['prefill_suffix_wall_s'] / max(dd['prefill_suffix_count'], 1):.4f} s")
    out["prefix"] = pre
    for k in out["launches"]:
        out["launches"][k] += pre["launches"][k] + (pre["replayed"] if k == pre["decode"] else 0)
    for k in ("dequantize", "qpaged_write_attend"):
        out["launches"][k] += pre["per_replay"].get(k, 0) * pre["delta"]["executed_steps"]
    # (e) the int8 pool beside a float draft
    spec = quant_spec_leg(model, srv["workload"], qc)
    for k in out["launches"]:
        out["launches"][k] += spec["launches"][k]
    out["spec"] = spec
    log(f"phase 5f wall: {time.perf_counter() - t_phase:.1f} s")
    return out


def quant_spec_leg(model, workload, qc) -> dict:
    """5f(e): phase 5d's early-exit pair at eps 0.3 (the draft: layer 0, its
    tensors the engine's own), the target quantized by ``qc`` (int8 weights
    and an int8 pool; the draft's pool float), gamma 4, on ``workload``
    through the paged engine at the paged serving geometry; the captured
    round against the eager round. Gates: every request DONE (``serve_spec``),
    the streams bit for bit, every greedy token within phase 3's limit of
    the served target's teacher-forced row maximum, K5q with the write once a
    layer a round (the verify window, R = 16) and QW no time, both pools
    ``check()`` clean. Returns the captured run's launches."""
    from neuronx_distributed_tpu_torch.models.llama import early_exit_draft

    layers = model.config.num_layers
    target, draft = early_exit_draft(model, SPEC_DRAFT_LAYERS, 0.3)
    kw = dict(paged=True, own_draft=True, quantize=qc, slots=PAGED_SLOTS)
    on = serve_spec(target, draft, workload, **kw)
    wit = serve_spec(target, draft, workload, eager=True, **kw)
    if wit["tokens"] != on["tokens"]:
        raise AssertionError("int8 pool + draft serving: the captured round's streams differ from "
                             "the eager round's")
    teacher = teacher_ratio(on["model"], workload, on["tokens"])
    if teacher > 1.0:
        raise AssertionError(f"int8 pool + draft serving: a greedy token lies {teacher:.3g}x phase "
                             "3's limit below its row's maximum teacher-forced")
    sn = on["snap"]
    log(f"quantized serving 5f(e) (int8 weights + int8 KV pool beside a float draft: phase 5d's "
        f"early-exit pair at eps 0.3, the draft's tensors its own, gamma {SPEC_GAMMA}, phase 4's "
        f"6 requests, {PAGED_SLOTS} slots, page_size {PAGE}): all DONE, both pools check() clean, "
        f"captured streams = the eager round's bit for bit, teacher-forced gap {teacher:.3g}x "
        f"phase 3's limit; one capture, launches per replay {on['per_round']} decode kernels: "
        f"{dict(sorted(on['per_replay'].items()))} (K5q with the write at R = "
        f"{4 * SPEC_GAMMA}, QW none); QW {on['launches']['window_requantize']} = admissions "
        f"{sn['prefills']} x {layers}; greedy acceptance {greedy_accept_rate(on):.4f}, rounds "
        f"{sn['spec_rounds']}; wall {on['wall_s']:.3f} s, {on['decode_executed']} decode-only "
        f"rounds in {on['decode_s']:.4f} s ({1e3 * on['decode_s'] / max(on['decode_executed'], 1):.2f}"
        f" ms each; eager witness "
        f"{1e3 * wit['decode_s'] / max(wit['decode_executed'], 1):.2f})")
    del target, draft
    collect_engines()
    return dict(launches=on["launches"], teacher=teacher, tokens=on["tokens"],
                verify=on["verify"], per_replay=on["per_replay"],
                accept=greedy_accept_rate(on), snap=sn)


# --- phase 5g: the fault contract -------------------------------------------------

FAULT_KEYS = ("sheds", "timed_out", "failed", "quarantines", "page_quarantines",
              "dispatch_retries", "recoveries", "prefill_failures", "spec_fallbacks")


def timed_injector():
    """A ``FaultInjector`` that notes, each time a fault fires, the time,
    the engine's chunk count and every request's token count (set
    ``engine`` and ``reqs`` on it): the recovery wall and the tokens each
    stream held before the fault."""
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector

    class Timed(FaultInjector):
        def __init__(self):
            super().__init__()
            self.engine, self.reqs, self.fired = None, (), []

        def _note(self, kind):
            self.fired.append(dict(kind=kind, t=time.perf_counter(),
                                   chunks=self.engine.metrics.chunks,
                                   tokens=[len(r.tokens) for r in self.reqs]))

        def _raising(self, hook, kind, *a):
            try:
                hook(*a)
            except Exception:
                self._note(kind)
                raise

        def on_dispatch(self, attempt):
            self._raising(super().on_dispatch, "dispatch", attempt)

        def on_spec_dispatch(self, attempt):
            self._raising(super().on_spec_dispatch, "draft_dispatch", attempt)

        def on_prefill(self, call):
            self._raising(super().on_prefill, "prefill", call)

        def on_readback(self, readback, toks, counts, active=None):
            n = self.counters["poisoned_readbacks"]
            out = super().on_readback(readback, toks, counts, active)
            if self.counters["poisoned_readbacks"] > n:
                self._note("readback")
            return out

        def on_page_readback(self, readback, slot_pages, active=None):
            pages = super().on_page_readback(readback, slot_pages, active)
            if pages:
                self._note("page")
            return pages

        def on_prefix_reuse(self, reuse, entry, cache=None):
            n = self.counters["bit_flips"]
            super().on_prefix_reuse(reuse, entry, cache)
            if self.counters["bit_flips"] > n:
                self._note("bit_flip")

    return Timed()


def graph_buffers(engine) -> list:
    """The data pointers of every buffer the captured decode step reads."""
    c = engine.cache.cache
    return [t.data_ptr() for t in (c.k, c.v, c.valid, c.cursor, *engine._state.values())]


def drive(engine, inj, paged: bool = False) -> float:
    """Step ``engine`` until it is idle or halted (``check()`` after every
    step on a paged engine). Returns the recovery wall of the first fault
    ``inj`` noted: from the fault to the end of the next executed chunk (a
    poisoned readback's own chunk counts as executed), or 0."""
    recovered = None
    while engine.has_work:
        engine.step()
        if paged:
            engine.cache.check()
        if inj.fired and recovered is None:
            f = inj.fired[0]
            done = f["chunks"] + (2 if f["kind"] in ("readback", "page") else 1)
            if engine.metrics.chunks >= done:
                torch.cuda.synchronize()
                recovered = time.perf_counter() - f["t"]
    return recovered or 0.0


def expect_counters(what: str, engine, **want) -> dict:
    """The engine's fault counters must equal the schedule exactly."""
    snap = engine.metrics.snapshot()
    got = {k: snap[k] for k in FAULT_KEYS}
    full = dict.fromkeys(FAULT_KEYS, 0)
    full.update(want)
    if got != full:
        raise AssertionError(f"fault phase {what}: counters {got} != the schedule's {full}")
    return snap


def stream_rule(what: str, model, workload, reqs, ref, pre) -> tuple:
    """Tokens a request emitted before the fault (``pre``) equal the
    fault-free run's (``ref``); the whole streams are counted bit for bit,
    and every greedy token of a finished request lies within phase 3's
    limit of its row's maximum logit in a teacher-forced pass. Returns
    (streams identical, the teacher-forced gap over its limit)."""
    for i, r in enumerate(reqs):
        if r.tokens[:pre[i]] != ref[i][:pre[i]]:
            raise AssertionError(f"fault phase {what}: request {i}'s tokens before the fault "
                                 "differ from the fault-free run's")
    done = [i for i, r in enumerate(reqs) if r.state.value == "done"]
    prompts, cfgs = workload
    worst = teacher_ratio(model, ([prompts[i] for i in done], [cfgs[i] for i in done]),
                          [reqs[i].tokens for i in done])
    if worst > 1.0:
        raise AssertionError(f"fault phase {what}: a greedy token lies {worst:.3g}x phase 3's "
                             "limit below its row's maximum logit teacher-forced")
    return sum(r.tokens == ref[i] for i, r in enumerate(reqs)), worst


def health_events(engine) -> list:
    return [e["value"] for e in engine.flight.events() if e["kind"] == "health"]


def fault_phase(model, srv: dict, spec_tokens, smi: str) -> dict:
    """Phase 5g: the serving engine's fault contract at full width, on
    phase 4's row engine (8 slots, chunk 8, the six requests, decode
    captured), phase 5c's paged prefix traffic and phase 5d's speculative
    engine (eps 0.3). Every fault counter must equal the injected schedule;
    the decode program stays one capture on its buffers through every
    recovery and quarantine. Returns the phase's launches by wrapper
    (replays included)."""
    import json
    import tempfile

    from neuronx_distributed_tpu_torch.models.llama import early_exit_draft
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache
    from neuronx_distributed_tpu_torch.serving.engine import EngineHealth, ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    t_phase = time.perf_counter()
    cfg = model.config
    workload, ref = srv["workload"], srv["tokens"]
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    replayed = dict.fromkeys(counters, 0)

    def row_engine(inj, target=model, **kw):
        inj.engine = ServingEngine(target, num_slots=8, decode_chunk_size=8, prefix_cache=None,
                                   fault_injector=inj, **kw)
        inj.reqs = [inj.engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(*workload))]
        return inj.engine, inj.reqs

    def retire(inj):
        """Count the replays of the injector's engine and let it go (a paged
        engine and its prefix store hold each other: collect the cycle)."""
        import gc

        engine = inj.engine
        progs = [engine.decode_program]
        if engine._plain_chunk is not None:
            progs.append(engine._plain_chunk.program)
        for prog in progs:
            for name, n in prog.launches_per_replay.items():
                replayed[name] += prog.replays * n
        inj.engine = None
        del engine, progs
        gc.collect()
        torch.cuda.empty_cache()

    def one_capture(what, engine, ptrs):
        if engine.decode_compilations != 1 or graph_buffers(engine) != ptrs:
            raise AssertionError(f"fault phase {what}: decode_compilations "
                                 f"{engine.decode_compilations}, buffers moved: "
                                 f"{graph_buffers(engine) != ptrs}")

    # (a) a dispatch failure before the chunk's first replay
    inj = timed_injector().fail_dispatch(at=2)
    engine, reqs = row_engine(inj, degraded_cooldown_chunks=2)
    ptrs = graph_buffers(engine)
    wall_a = drive(engine, inj)
    expect_counters("(a)", engine, dispatch_retries=1, recoveries=1)
    if health_events(engine) != ["degraded", "ok"] or engine.health() is not EngineHealth.OK:
        raise AssertionError(f"fault phase (a): health {health_events(engine)}, now "
                             f"{engine.health()}; want degraded, then ok after the cooldown")
    one_capture("(a)", engine, ptrs)
    same_a, gap_a = stream_rule("(a)", model, workload, reqs, ref, inj.fired[0]["tokens"])
    log(f"fault (a) fail_dispatch(at=2) ({smi}): dispatch_retries 1, recoveries 1, health "
        f"degraded then ok after 2 chunks, decode_compilations 1 on its buffers; recovery wall "
        f"(failure to the next executed chunk: the retry wait, six re-prefills, one chunk) "
        f"{wall_a:.4f} s; streams: {inj.fired[0]['tokens'][0]} tokens each before the fault "
        f"equal phase 4's, {same_a} of 6 whole streams bit-identical, teacher-forced gap "
        f"{gap_a:.3g}x its limit")
    del engine
    retire(inj)

    # (b) the chunk raising after its replays ran: reset in place
    inj = timed_injector()
    engine, reqs = row_engine(inj, degraded_cooldown_chunks=2)
    ptrs = graph_buffers(engine)
    engine.step()
    engine.step()
    real = engine._chunk

    class StepsThenFail:
        def __getattr__(self, name):
            return getattr(real, name)

        def __call__(self):
            real()
            raise RuntimeError("fault after the chunk's replays ran")

    pre_b = [len(r.tokens) for r in reqs]
    engine._chunk = StepsThenFail()
    t_b = time.perf_counter()
    engine.step()
    engine._chunk = real
    if engine.cache.cursor != 0 or bool(engine._state["active"].any()):
        raise AssertionError("fault phase (b): the caches or slot state were not reset")
    chunks_b = engine.metrics.chunks
    wall_b = 0.0
    while engine.has_work:
        engine.step()
        if not wall_b and engine.metrics.chunks > chunks_b:
            torch.cuda.synchronize()
            wall_b = time.perf_counter() - t_b
    expect_counters("(b)", engine, dispatch_retries=1, recoveries=1)
    one_capture("(b)", engine, ptrs)
    same_b, gap_b = stream_rule("(b)", model, workload, reqs, ref, pre_b)
    log(f"fault (b) the chunk raising after its {real.chunk_size} replays ran: cursor 0 and slot "
        f"state reset in place, dispatch_retries 1, recoveries 1, decode_compilations 1 on its "
        f"buffers; wall to the next executed chunk {wall_b:.4f} s; {pre_b[0]} tokens each "
        f"before the fault equal phase 4's, {same_b} of 6 whole streams bit-identical, "
        f"teacher-forced gap {gap_b:.3g}x its limit")
    del engine, real
    retire(inj)

    # (c) a poisoned readback: the slot quarantined, the victim requeued
    inj = timed_injector().poison_readback(at=3, slot=1, token=-5)
    engine, reqs = row_engine(inj)
    ptrs = graph_buffers(engine)
    engine.step()
    victim = next(i for i, r in enumerate(reqs) if r.slot == 1)
    drive(engine, inj)
    expect_counters("(c)", engine, quarantines=1)
    if (engine.cache.usable_slots, engine.cache.quarantined_slots) != (7, [1]) \
            or engine.health() is not EngineHealth.DEGRADED:
        raise AssertionError(f"fault phase (c): usable {engine.cache.usable_slots}, quarantined "
                             f"{engine.cache.quarantined_slots}, health {engine.health()}")
    one_capture("(c)", engine, ptrs)
    wrong = [i for i, r in enumerate(reqs) if i != victim and r.tokens != ref[i]]
    if wrong or any(r.state is not RequestState.DONE for r in reqs):
        raise AssertionError(f"fault phase (c): neighbours' streams differ from phase 4's: {wrong}")
    pre_c = inj.fired[0]["tokens"]
    same_c, gap_c = stream_rule("(c) victim", model, workload, reqs, ref, pre_c)
    log(f"fault (c) poison_readback(at=3, slot=1): slot 1 quarantined (7 usable, DEGRADED), "
        f"request {victim} requeued and finished; the 5 neighbours' streams bit-identical to "
        f"phase 4's; the victim's {pre_c[victim]} tokens before the fault equal, its whole "
        f"stream {'bit-identical' if reqs[victim].tokens == ref[victim] else 'not bit-identical'} "
        f"({same_c} of 6 in all), teacher-forced gap {gap_c:.3g}x its limit; "
        f"decode_compilations 1 on its buffers")
    del engine
    retire(inj)

    # (d) persistent dispatch failures: HALTED, work requeued, post-mortem
    with tempfile.TemporaryDirectory() as flight_dir:
        inj = timed_injector().fail_dispatch(at=1, times=None)
        engine, reqs = row_engine(inj, flight_dir=flight_dir)
        drive(engine, inj)
        expect_counters("(d)", engine, dispatch_retries=3, recoveries=2)
        pm = json.loads(open(engine.flight.last_dump_path).read())
        if (engine.health() is not EngineHealth.HALTED
                or "3 consecutive dispatch failures" not in engine.halt_reason
                or any(r.state is not RequestState.QUEUED or r.tokens != ref[i][:len(r.tokens)]
                       or not r.tokens for i, r in enumerate(reqs))
                or [e["kind"] for e in pm["events"]].count("dispatch_failure") != 3
                or pm["reason"] != engine.halt_reason):
            raise AssertionError(f"fault phase (d): health {engine.health()}, reason "
                                 f"{engine.halt_reason}, states {[r.state for r in reqs]}")
        log(f"fault (d) fail_dispatch(at=1, times=None): HALTED after 3 attempts "
            f"({engine.halt_reason!r}), all 6 requests QUEUED with their "
            f"{[len(r.tokens) for r in reqs]} tokens (equal to phase 4's), post-mortem "
            f"{os.path.basename(engine.flight.last_dump_path)} written and parsed back "
            f"({pm['events_kept']} events, {len(json.dumps(pm))} bytes)")
        del engine
        retire(inj)

    # (e) a skewed clock sheds two queued requests before any prefill
    inj = timed_injector()
    engine, reqs = row_engine(inj)
    extra = [engine.submit(p, c, seed=10 + i, queue_timeout_s=5.0)
             for i, (p, c) in enumerate(zip(*workload)) if i < 2]
    inj.skew_clock(by=100.0)
    k1 = counters["flash_attention"].launches
    drive(engine, inj)
    k1 = counters["flash_attention"].launches - k1
    expect_counters("(e)", engine, sheds=2, timed_out=2)
    if (k1 != 6 * cfg.num_layers or any(r.state is not RequestState.TIMED_OUT or r.tokens
                                        for r in extra)
            or [r.tokens for r in reqs] != ref):
        raise AssertionError(f"fault phase (e): K1 launches {k1}, shed states "
                             f"{[r.state for r in extra]}")
    log(f"fault (e) skew_clock(by=100 s) with queue_timeout_s=5: 2 queued requests shed "
        f"(TIMED_OUT, no token) before any prefill, K1 {k1} = 6 prefills x {cfg.num_layers} "
        f"layers; the six streams bit-identical to phase 4's")
    del engine
    retire(inj)

    # (f) one prefill fault fails exactly one request
    inj = timed_injector().fail_prefill(at=1)
    engine, reqs = row_engine(inj)
    drive(engine, inj)
    expect_counters("(f)", engine, failed=1, prefill_failures=1)
    failed = [i for i, r in enumerate(reqs) if r.state is RequestState.FAILED]
    if len(failed) != 1 or engine.cache.free_slots != 8 or any(
            r.state is not RequestState.DONE for i, r in enumerate(reqs) if i != failed[0]):
        raise AssertionError(f"fault phase (f): failed {failed}, free slots "
                             f"{engine.cache.free_slots}")
    same_f, gap_f = stream_rule("(f)", model, workload, reqs, ref, [0] * 6)
    log(f"fault (f) fail_prefill(at=1): request {failed[0]} FAILED ({reqs[failed[0]].error!r}), "
        f"the other 5 DONE, every slot back in the rotation; {same_f} of 5 streams "
        f"bit-identical to phase 4's, teacher-forced gap {gap_f:.3g}x its limit")
    del engine
    retire(inj)

    # (g) phase 5c's paged prefix traffic: a poisoned shared page, a
    # flipped pool bit at a hit, one host read more a paged hit
    pworkload = prefix_workload(cfg.vocab_size)
    pkw = dict(num_slots=PAGED_SLOTS, decode_chunk_size=8, kv_page_size=PAGE,
               kv_num_pages=ROW_SLOTS * cfg.max_seq_len // PAGE + 1)

    def paged_engine(inj, reqs_of=range(12)):
        inj.engine = ServingEngine(model, prefix_cache=PrefixCache(), fault_injector=inj, **pkw)
        inj.reqs = [inj.engine.submit(pworkload[0][i], pworkload[1][i], seed=i) for i in reqs_of]
        return inj.engine, inj.reqs

    def reads_rule(what, engine, fresh):
        sn = engine.metrics.snapshot()
        want = sn["chunks"] + fresh + sn["prefix_hits"] + sn["prefix_validation_failures"]
        if engine.host_reads != want:
            raise AssertionError(f"fault phase {what}: host_reads {engine.host_reads} != chunks "
                                 f"{sn['chunks']} + {fresh} first tokens + one a paged hit "
                                 f"({sn['prefix_hits']} + {sn['prefix_validation_failures']})")
        return sn

    inj = timed_injector()
    engine, reqs = paged_engine(inj)
    drive(engine, inj, paged=True)
    sn = reads_rule("(g) fault-free", engine, 12)
    pref = [list(r.tokens) for r in reqs]
    if (sn["prefix_hits"], sn["prefix_misses"]) != (11, 1):
        raise AssertionError(f"fault phase (g): fault-free hits {sn['prefix_hits']}, misses "
                             f"{sn['prefix_misses']}; want 11, 1")
    free_reads = engine.host_reads
    del engine
    retire(inj)

    inj = timed_injector().poison_page(at=1, slot=0)
    engine, reqs = paged_engine(inj)
    ptrs = graph_buffers(engine)
    wall_g = drive(engine, inj, paged=True)
    sn = expect_counters("(g) poison_page", engine, page_quarantines=1)
    holders = next(e["slots"] for e in engine.flight.events() if e["kind"] == "page_quarantine")
    if (engine.cache.pages_quarantined != 1 or holders != {"len": 12}
            or any(r.state is not RequestState.DONE for r in reqs)):
        raise AssertionError(f"fault phase (g): pages quarantined "
                             f"{engine.cache.pages_quarantined}, holders {holders}")
    one_capture("(g)", engine, ptrs)
    reads_rule("(g) poison_page", engine, 12)
    same_g, gap_g = stream_rule("(g) poison_page", model, pworkload, reqs, pref,
                                inj.fired[0]["tokens"])
    log(f"fault (g) poison_page(at=1, slot=0) on phase 5c's traffic ({smi}; {PAGED_SLOTS} slots, pool "
        f"{pkw['kv_num_pages']} pages): the system prompt's first page, shared copy-on-write by "
        f"all 12 requests, quarantined (pages_quarantined 1); every holder requeued, the entry "
        f"pinning it evicted, check() clean after every step; prefix hits "
        f"{sn['prefix_hits']} (11 before the fault), misses {sn['prefix_misses']}; recovery wall "
        f"(the poison to the next executed chunk: 12 re-admissions, 1 full prefill and 11 "
        f"suffix prefills, one chunk) {wall_g:.4f} s; {inj.fired[0]['tokens'][0]} tokens each "
        f"before the fault equal the fault-free run's, {same_g} of 12 whole streams "
        f"bit-identical, teacher-forced gap {gap_g:.3g}x its limit; decode_compilations 1 on "
        f"its buffers")
    del engine
    retire(inj)

    inj = timed_injector().flip_bits("kv_pool", at=0)
    engine, reqs = paged_engine(inj, reqs_of=[0])
    drive(engine, inj, paged=True)
    pf0, k1 = counters["page_fingerprint"].launches, counters["flash_attention"].launches
    reqs += [engine.submit(pworkload[0][i], pworkload[1][i], seed=i) for i in range(1, 12)]
    inj.reqs = reqs
    drive(engine, inj, paged=True)
    k1 = counters["flash_attention"].launches - k1
    sn = expect_counters("(g) flip_bits", engine)
    if (inj.counters["bit_flips"] != 1 or sn["prefix_validation_failures"] != 1
            or sn["prefix_hits"] != 10 or k1 != cfg.num_layers
            or any(r.state is not RequestState.DONE for r in reqs)):
        raise AssertionError(f"fault phase (g) flip_bits: flips {inj.counters['bit_flips']}, "
                             f"validation failures {sn['prefix_validation_failures']}, hits "
                             f"{sn['prefix_hits']}, K1 launches {k1}")
    reads_rule("(g) flip_bits", engine, 12)
    same_f2, gap_f2 = stream_rule("(g) flip_bits", model, pworkload, reqs, pref, [0] * 12)
    log(f"fault (g) flip_bits(\"kv_pool\", at=0): request 0 alone first (a miss: its pages "
        f"pinned, their fingerprints recorded), then the other 11: the first hit's page "
        f"fingerprints differ after one flipped bit, the entry is evicted and that request "
        f"full-prefills (K1 {k1} = 1 x {cfg.num_layers}) and inserts anew; 10 hits on the new "
        f"entry; PF launches in the wave {counters['page_fingerprint'].launches - pf0} (the "
        f"hits' checks and the insert); {same_f2} of 12 streams bit-identical to the one-wave "
        f"fault-free run's, teacher-forced gap {gap_f2:.3g}x its limit; host_reads = chunks + "
        f"first tokens + one a paged hit in all three (g) runs (fault-free {free_reads})")
    del engine
    retire(inj)

    # (h) phase 5d's speculative engine: a failed draft dispatch falls back
    target, draft = early_exit_draft(model, SPEC_DRAFT_LAYERS, 0.3)
    inj = timed_injector().fail_draft_dispatch(at=1)
    engine, reqs = row_engine(inj, target=target, draft_model=draft, gamma=SPEC_GAMMA)
    drive(engine, inj)
    sn = expect_counters("(h)", engine, spec_fallbacks=1)
    active = sum(1 for n in inj.fired[0]["tokens"] if n)
    if sn["preemptions"] != active or any(r.state is not RequestState.DONE for r in reqs):
        raise AssertionError(f"fault phase (h): preemptions {sn['preemptions']}, active at the "
                             f"fallback {active}")
    same_h, gap_h = stream_rule("(h)", target, workload, reqs, spec_tokens,
                                inj.fired[0]["tokens"])
    log(f"fault (h) fail_draft_dispatch(at=1), eps 0.3, gamma {SPEC_GAMMA}: spec_fallbacks 1 "
        f"(one chunk of plain steps on the same buffers), all {active} active slots preempted "
        f"and resumed speculating (spec rounds {sn['spec_rounds']}); decode programs captured "
        f"{engine.decode_compilations} (the round and the plain step; the JAX engine's "
        f"decode_compilations counts 2 in the same test, tests/test_torch_faults.py); "
        f"{inj.fired[0]['tokens'][0]} tokens each before the fault equal phase 5d's, {same_h} of "
        f"6 whole streams bit-identical, teacher-forced gap {gap_h:.3g}x its limit")
    del engine
    retire(inj)
    del target, draft
    torch.cuda.empty_cache()

    launches = {name: c.launches + replayed[name] for name, c in counters.items()}
    log(f"fault phase launches (replays included): {launches}")
    log(f"phase 5g wall: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, recovery_a_s=wall_a, recovery_g_s=wall_g)


# --- phase 5h: SLO-aware multi-tenant serving -----------------------------------

SLO_STEP_DT = 0.1  # virtual seconds a step: about one chunk of phase 5b's steps
SLO_TAPE_S = 10.0  # the tape's virtual duration
# the wall-clock runs' share of the tape (its first SLO_WALL_S seconds): cut
# from the whole 10 s, which served in 23-25 s a run on an H100 and took
# phase 5h to 123 s, over its 120 s budget
SLO_WALL_S = 6.0
SLO_ROW_S = 3.0    # the row leg's share of the tape
# chat's Poisson rate: up to 14 rps chat attains every request on the
# virtual clock, so no victim is ever nominated; from 15 rps chat is
# pressured while docs still attains and the policy preempts (16 rps: four
# victims); at 18-22 rps docs misses its own bound too, and no attaining
# victim is left
SLO_CHAT_RPS = 16.0


def slo_tape(vocab: int, duration_s: float = SLO_TAPE_S, seed: int = 0) -> list:
    """Phase 5h's arrival tape at Llama-3-8B scale (``generate_tape``'s own
    shapes, 4-48 tokens, are too small for the card): ``chat``, interactive,
    Poisson at ``SLO_CHAT_RPS``, prompts of 100-400 tokens, 32-64 new;
    ``docs``, batch, bursty at 2 rps off-peak, 4x at peak (period 8 s, duty 0.25, by thinning
    against the peak rate, as ``generate_tape`` draws), prompts of
    2000-3000 tokens, 64-128 new. Every request greedy; two seeded
    ``random.Random`` a tenant, one for times, lengths and seeds, one for
    the token ids (so the schedule does not depend on the vocabulary);
    merged by (time, tenant, seed)."""
    import random

    from neuronx_distributed_tpu_torch.serving.traffic import Arrival

    shapes = (("chat", "interactive", SLO_CHAT_RPS, 1.0, (100, 400), (32, 64)),
              ("docs", "batch", 2.0, 4.0, (2000, 3000), (64, 128)))
    tape = []
    for k, (name, priority, rate, factor, plen, new) in enumerate(shapes):
        rng = random.Random(seed * 1_000_003 + k)
        ids = random.Random(seed * 1_000_003 + k + 100)
        peak, t = rate * factor, 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= duration_s:
                break
            if factor > 1.0:
                phase = (t % 8.0) / 8.0
                if rng.random() > (peak if phase < 0.25 else rate) / peak:
                    continue
            n = rng.randint(*plen)
            tape.append(Arrival(t=t, tenant=name, priority=priority,
                                prompt=tuple(ids.randint(1, vocab - 1) for _ in range(n)),
                                max_new_tokens=rng.randint(*new), temperature=0.0,
                                key_seed=rng.getrandbits(31)))
    tape.sort(key=lambda a: (a.t, a.tenant, a.key_seed))
    return tape


def slo_specs():
    from neuronx_distributed_tpu_torch.observability.slo import SLOSpec

    return {"chat": SLOSpec(ttft_p99_s=0.5, tpot_p99_s=0.05), "docs": SLOSpec(ttft_p99_s=4.0)}


def slo_engine(model, scheduling, registry, label, paged=True, **kw):
    """Phase 5b's paged engine (16 slots, 2049 pages of 16, chunk 8, no
    prefix cache) or phase 4's row engine (8 slots), with the SLO specs."""
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cache = (dict(num_slots=PAGED_SLOTS, kv_page_size=PAGE,
                  kv_num_pages=ROW_SLOTS * model.config.max_seq_len // PAGE + 1) if paged
             else dict(num_slots=8))
    return ServingEngine(model, decode_chunk_size=8, prefix_cache=None, scheduling=scheduling,
                         registry=registry, engine_label=label, slo=slo_specs(), **cache, **kw)


def collect_engines() -> None:
    """Free dropped engines' device memory now: the SLO policy (and 5h's
    checked ``step``) hold an engine in reference cycles, which only the
    cycle collector frees (a 4.3 GB pool an engine, and the model)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def slo_flows(path: str, reqs) -> int:
    """The Perfetto file parsed back: one connected flow a request (one start,
    one end, one name, times in order, submit first and retire last), each
    victim's holding its ``slo_preempt`` step. Returns the flows checked."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    flows = {}
    for e in events:
        if e.get("cat") == "request" and e["ph"] in ("s", "t", "f"):
            flows.setdefault(e["id"], []).append(e)
    for r in reqs:
        fl = flows.get(r.rid, [])
        stages = [e["args"]["stage"] for e in fl]
        if ([e["ph"] for e in fl].count("s"), [e["ph"] for e in fl].count("f")) != (1, 1) \
                or stages[0] != "submit" or stages[-1] != "retire" \
                or len({e["name"] for e in fl}) != 1 \
                or [e["ts"] for e in fl] != sorted(e["ts"] for e in fl):
            raise AssertionError(f"slo phase: request {r.rid}'s flow is not one connected "
                                 f"flow: {stages}")
        if r.preemptions and "slo_preempt" not in stages:
            raise AssertionError(f"slo phase: victim {r.rid}'s flow lacks its slo_preempt step")
    return len(reqs)


def slo_virtual(model, tape, scheduling, registry, layers, trace_dir=None, paged=True):
    """One virtual-clock replay (``serving/traffic.replay``, step_dt 0.1 s)
    with its gates: every arrival DONE with its token count or attributed,
    one capture on the same buffers, decode launches = executed steps x
    layers plus the warm-up's, K1 = admissions x layers, host reads =
    chunks + first tokens, ``check()`` clean after every step, the trace's
    flows (``trace_dir``)."""
    from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock, replay
    from neuronx_distributed_tpu_torch.utils.timeline import Timeline

    clock = VirtualClock()
    timeline = Timeline(os.path.join(trace_dir, f"{scheduling}.json")) if trace_dir else None
    label = scheduling if paged else f"row_{scheduling}"
    engine = slo_engine(model, scheduling, registry, label, paged=paged, time_fn=clock,
                        timeline=timeline)
    buffers = graph_buffers(engine)
    step = engine.step

    def checked_step():
        out = step()
        if paged:
            engine.cache.check()
        return out

    engine.step = checked_step
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    report = replay(engine, tape, clock, step_dt=SLO_STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, warm = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    snap = engine.metrics.snapshot()
    rep = report["replay"]
    reqs = sorted(engine.scheduler.requests.values(), key=lambda r: r.rid)
    what = f"slo phase ({'paged' if paged else 'row'}, {scheduling}, virtual clock)"
    for r in reqs:
        if r.state.value != "done" or len(r.tokens) != r.config.max_new_tokens:
            raise AssertionError(f"{what}: request {r.rid} {r.state.value} with "
                                 f"{len(r.tokens)} of {r.config.max_new_tokens} tokens")
    attributed = sum(t["rejects"] + t["sheds"] + t["failed"] for t in report["tenants"].values())
    if (rep["submitted"] != len(reqs) or rep["submitted"] + rep["rejected"] + rep["unplaceable"]
            != len(tape) or attributed != rep["rejected"] + rep["unplaceable"]
            or rep["truncated"]):
        raise AssertionError(f"{what}: arrivals not all served or attributed: {rep}")
    if engine.decode_compilations != 1 or graph_buffers(engine) != buffers:
        raise AssertionError(f"{what}: decode_compilations {engine.decode_compilations}, "
                             "buffers moved")
    decode = "paged_flash_decode" if paged else "flash_decode"
    want = {decode: snap["executed_steps"] * layers}
    got = {decode: launches[decode] - warm[decode]}
    if got != want or warm[decode] != layers:
        raise AssertionError(f"{what}: decode launches {got} (warm-up {warm[decode]}) != {want} "
                             f"+ {layers}")
    if launches["flash_attention"] != snap["prefills"] * layers:
        raise AssertionError(f"{what}: K1 launches {launches['flash_attention']} != "
                             f"{snap['prefills']} admissions x {layers}")
    first = sum(r.first_token_time is not None for r in reqs)
    if engine.host_reads != snap["chunks"] + first:
        raise AssertionError(f"{what}: host reads {engine.host_reads} != chunks "
                             f"{snap['chunks']} + first tokens {first}")
    out = dict(report=report, snap=snap, launches=launches, wall_s=wall,
               tokens=[list(r.tokens) for r in reqs],
               victims=[r.rid for r in reqs if r.preemptions],
               policy=engine.policy.snapshot(), host_reads=engine.host_reads)
    if timeline is not None:
        timeline.save()
        out["flows"] = slo_flows(timeline.trace_file_path, reqs)
    del engine, step, checked_step
    collect_engines()
    return out


def slo_wall(model, tape, scheduling, registry, layers) -> dict:
    """The same tape on the wall clock: this loop (not the package: a replay
    refuses a wall clock) submits each arrival at its time on
    ``time.monotonic`` and steps the engine; the decode program is captured
    before the clock starts. Per tenant TTFT, TPOT, queue wait, attainment
    and goodput come from the engine's registry."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    import numpy as np

    engine = slo_engine(model, scheduling, registry, f"wall_{scheduling}")
    prewarm(engine)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0, i = time.monotonic(), 0
    while i < len(tape) or engine.has_work:
        now = time.monotonic() - t0
        while i < len(tape) and tape[i].t <= now:
            a = tape[i]
            engine.submit(np.asarray(a.prompt, np.int32),
                          GenerationConfig(max_new_tokens=a.max_new_tokens,
                                           temperature=a.temperature),
                          seed=a.key_seed, tenant=a.tenant, priority=a.priority)
            i += 1
        if engine.has_work:
            engine.step()
        elif i < len(tape):
            time.sleep(min(0.002, max(tape[i].t - now, 0.0)))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, _ = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    snap = engine.metrics.snapshot()
    reqs = list(engine.scheduler.requests.values())
    if len(reqs) != len(tape) or any(r.state.value != "done"
                                     or len(r.tokens) != r.config.max_new_tokens for r in reqs):
        raise AssertionError(f"slo phase (wall clock, {scheduling}): not every arrival DONE")
    if engine.decode_compilations != 1:
        raise AssertionError(f"slo phase (wall clock, {scheduling}): "
                             f"{engine.decode_compilations} captures")
    out = dict(snap=snap, launches=launches, wall_s=wall)
    del engine
    collect_engines()
    return out


def slo_phase(model, smi: str) -> dict:
    """Phase 5h: SLO-aware multi-tenant serving at full width. (a) The tape
    through phase 5b's paged engine on a virtual clock under FIFO and under
    the SLO policy (shared registry, the SLO engine traced), every gate of
    ``slo_virtual``, at least one SLO preemption, every greedy token of the
    SLO run within phase 3's limit teacher-forced; (b) the tape's first
    ``SLO_WALL_S`` seconds on the wall clock, FIFO and SLO, per-tenant
    latencies printed (no gate on speed); (c) the row leg: the first
    ``SLO_ROW_S`` seconds through phase 4's row engine under the SLO
    policy (K4). Returns the phase's launches (replays included)."""
    import tempfile

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry

    import numpy as np

    t_phase = time.perf_counter()
    cfg = model.config
    layers = cfg.num_layers
    tape = slo_tape(cfg.vocab_size)
    n_chat = sum(a.tenant == "chat" for a in tape)
    log(f"slo phase tape: {len(tape)} arrivals over {SLO_TAPE_S:.0f} virtual s ({n_chat} chat: "
        f"Poisson {SLO_CHAT_RPS:.0f} rps, prompts 100-400, 32-64 new, interactive, ttft_p99 "
        f"0.5 s tpot_p99 0.05 s; {len(tape) - n_chat} docs: bursty 2 rps x4 at peak (period 8 s, duty 0.25), "
        f"prompts 2000-3000, 64-128 new, batch, ttft_p99 4 s); all greedy; paged engine "
        f"{PAGED_SLOTS} slots, {ROW_SLOTS * cfg.max_seq_len // PAGE + 1} pages of {PAGE}, chunk "
        f"8, step_dt {SLO_STEP_DT} s")
    registry = MetricsRegistry()
    runs = {}
    with tempfile.TemporaryDirectory() as trace_dir:
        for scheduling in ("fifo", "slo"):
            runs[scheduling] = slo_virtual(model, tape, scheduling, registry, layers,
                                           trace_dir=trace_dir if scheduling == "slo" else None)
    fifo, slo = runs["fifo"], runs["slo"]
    if slo["snap"]["preemptions"] < 1 or slo["policy"]["preemptions_requested"] < 1:
        raise AssertionError("slo phase: the SLO policy preempted nothing")
    prompts = [np.asarray(a.prompt) for a in tape]
    cfgs = [GenerationConfig(max_new_tokens=a.max_new_tokens, temperature=0.0) for a in tape]
    gap = teacher_ratio(model, (prompts, cfgs), slo["tokens"])
    if gap > 1.0:
        raise AssertionError(f"slo phase: a greedy token of the SLO run lies {gap:.3g}x phase "
                             "3's limit below its row's maximum logit teacher-forced")
    victims = set(slo["victims"]) | set(fifo["victims"])
    same = [i for i in range(len(tape)) if i not in victims
            and slo["tokens"][i] == fifo["tokens"][i]]
    victim_same = sum(slo["tokens"][i] == fifo["tokens"][i] for i in slo["victims"])
    for name, r in runs.items():
        sn = r["snap"]
        log(f"slo phase (a) virtual clock, {name} ({smi}): report {json.dumps(r['report'])}")
        log(f"slo phase (a) {name}: wall {r['wall_s']:.2f} s, steps "
            f"{r['report']['replay']['steps']}, chunks {sn['chunks']}, executed steps {sn['executed_steps']}, prefills "
            f"{sn['prefills']}, preemptions {sn['preemptions']}, peak occupancy "
            f"{sn['peak_occupancy']}, peak pages mapped {sn['peak_pages_mapped']}, host reads "
            f"{r['host_reads']} = chunks + first tokens, decode_compilations 1, launches "
            f"{r['launches']}")
    log(f"slo phase (a) SLO policy: {json.dumps(slo['policy'])}; trace flows checked "
        f"{slo['flows']} (one connected flow a request, {len(slo['victims'])} victims holding "
        f"slo_preempt)")
    chat = {n: r["report"]["tenants"]["chat"].get("attainment") for n, r in runs.items()}
    log(f"slo phase (a): chat attainment fifo {chat['fifo']} slo {chat['slo']}; "
        f"{len(same)} of {len(tape) - len(victims)} never-preempted streams bit-identical "
        f"across the two runs; victims' streams bit-identical to FIFO's: {victim_same} of "
        f"{len(slo['victims'])} (counted, not gated: a resume re-prefills with GEMMs of another "
        f"M); every greedy token of the SLO run within {gap:.3g}x phase 3's limit "
        "teacher-forced")

    wall_tape = [a for a in tape if a.t < SLO_WALL_S]
    wall_registry = MetricsRegistry()
    walls = {s: slo_wall(model, wall_tape, s, wall_registry, layers) for s in ("fifo", "slo")}
    for name, r in walls.items():
        sn = r["snap"]
        for tenant, row in sn["tenants"].items():
            t_slo = sn["slo"]["per_tenant"].get(tenant, {})
            log(f"slo phase (b) wall clock, {name}, {tenant} ({smi}; {len(wall_tape)} arrivals "
                f"over the tape's first {SLO_WALL_S:.0f} s, the duration cut from "
                f"{SLO_TAPE_S:.0f} s to keep phase 5h within 120 s; the shapes uncut): TTFT p50 "
                f"{row['ttft_p50_s']:.4f} "
                f"p99 {row['ttft_p99_s']:.4f} s, TPOT p50 {row['tpot_p50_s']:.5f} p99 "
                f"{row['tpot_p99_s']:.5f} s, queue wait p95 {row['queue_wait_p95_s']:.4f} s, "
                f"attainment {t_slo.get('attainment')}, goodput "
                f"{t_slo.get('goodput_tok_s', 0.0):.1f} tok/s")
        log(f"slo phase (b) wall clock, {name}: run {r['wall_s']:.2f} s, preemptions "
            f"{sn['preemptions']}, completed {sn['completed']}, decode "
            f"{sn['chunk_tokens_per_sec']:.1f} tok/s (chunk wall)")

    row_tape = [a for a in tape if a.t < SLO_ROW_S]
    row = slo_virtual(model, row_tape, "slo", MetricsRegistry(), layers, paged=False)
    log(f"slo phase (c) row leg ({len(row_tape)} arrivals, the tape's first {SLO_ROW_S:.0f} s; "
        f"8 slots, SLO policy, virtual clock): K4 {row['launches']['flash_decode']} launches = "
        f"{row['snap']['executed_steps']} executed steps x {layers} + the warm-up's, K1 "
        f"{row['launches']['flash_attention']} = {row['snap']['prefills']} admissions x {layers}, "
        f"preemptions {row['snap']['preemptions']}, host reads = chunks + first tokens")
    launches = {name: sum(r["launches"][name] for r in (fifo, slo, row, *walls.values()))
                for name in fifo["launches"]}
    log(f"slo phase launches (replays included): {launches}")
    log(f"phase 5h wall: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# --- phase 5i: the host page tier ---------------------------------------------------

TIER_PREFIX, TIER_NEW = 1600, 16   # system prompt tokens; new tokens a request
TIER_PAGES = 380                   # pool pages: two of the four prefixes beside the active slot
TIER_HOST_PAGES = 512              # host tier pages (1 GiB pinned at page 16)
TIER_CONTROL_PAGES = 1200          # the control's pool: the whole working set
TIER_SCHEDULE = (("fail_spill", 0), ("poison_host_page", 0), ("fail_prefetch", 1))


def tier_workload(vocab: int, seed: int = 9):
    """Four distinct 1600-token system prompts (numpy seed ``seed``), each
    with a tail of 100-400 tokens, in waves 0,1,2,3,0,1,2,3: request j + 4
    revisits request j's system prompt with a tail of its own of the same
    length, so a miss, a host-tier hit and a device-tier hit meet at one
    context length; 16 new tokens each, greedy."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    rng = np.random.default_rng(seed)
    systems = [rng.integers(1, vocab, size=TIER_PREFIX) for _ in range(4)]
    lens = [int(rng.integers(100, 401)) for _ in range(4)]
    tails = [rng.integers(1, vocab, size=lens[i % 4]) for i in range(8)]
    prompts = [np.concatenate([systems[i % 4], tails[i]]).astype(np.int32) for i in range(8)]
    return prompts, [GenerationConfig(max_new_tokens=TIER_NEW, temperature=0.0)] * 8


def tier_serve(model, workload, pages: int, host, serial: bool = True, quantize=None,
               schedule=(), profiled: bool = False) -> dict:
    """``workload`` through a paged engine of 2 slots, page 16, ``pages``
    pool pages, chunk 8, eager admission, the prefix cache on and ``host``
    host pages (None: no tier): a warm-up request on a prompt of its own
    (the decode program's capture), the store cleared, every kernel's count
    zeroed, then the requests, one ``run()`` each (``serial``) or all at
    once, ``check()`` of both tiers after every step. After every prefetch
    one PF over the prefetched pages must equal the entry's insert-time
    ``page_fp`` (the smoke's launches, not the engine's). Gates: every
    request DONE with its tokens in the vocabulary, one capture, replays =
    executed steps, K1 = full prefills x 32, the decode kernel's own
    launches = suffix prefills x 32, PF = inserts + device-tier hits, host
    reads = chunks + first tokens + spills + device-tier hits, ``copy_bytes``
    0, and after the store is cleared every device and host page free.
    ``schedule``: (FaultInjector method, at) pairs; ``profiled``: the
    requests run under the profiler, opened after the capture."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
    from neuronx_distributed_tpu_torch.utils.fingerprint import pool_pages_fingerprint

    cfg = model.config
    layers = cfg.num_layers
    inj = None
    if schedule:
        inj = FaultInjector()
        for method, at in schedule:
            getattr(inj, method)(at=at)
    collect_engines()  # the previous run's engine (held in cycles) frees before this one
    t0 = time.perf_counter()
    engine = ServingEngine(model, num_slots=2, decode_chunk_size=8, kv_page_size=PAGE,
                           kv_num_pages=pages, kv_host_pages=host, admission="eager",
                           prefix_cache=PrefixCache(), quantize=quantize, fault_injector=inj,
                           sleep_fn=lambda s: None)
    build_s = time.perf_counter() - t0
    warm = np.arange(1, 200, dtype=np.int32) % (cfg.vocab_size - 1) + 1
    engine.submit(warm, GenerationConfig(max_new_tokens=4, temperature=0.0), seed=999)
    engine.run()
    engine.prefix.clear()
    tier = engine.tier
    qkv = quantize is not None and quantize.kv is not None
    decode = "qpaged_flash_decode" if qkv else "paged_flash_decode"
    suffix = "flash_decode" if qkv else "paged_flash_decode"
    counters = kernel_counters()
    pf = counters["page_fingerprint"]
    spills, verifies, fp_checked, smoke_pf, inserts = [], [], [], [0], [0]
    if tier is not None:
        put, verify = tier.put, tier.verify

        def timed_put(pids, items):
            c0, r0 = tier.copy_s, tier.crc_s
            out = put(pids, items)
            spills.append(dict(pages=len(pids), copy_s=tier.copy_s - c0, crc_s=tier.crc_s - r0))
            return out

        def timed_verify(hids):
            v0 = tier.verify_s
            ok = verify(hids)
            verifies.append(dict(pages=len(hids), s=tier.verify_s - v0, ok=ok))
            return ok

        tier.put, tier.verify = timed_put, timed_verify
        prefetch = engine._prefetch_entry

        def checked(entry, late=False):
            ok = prefetch(entry, late)
            if ok and entry.page_fp is not None:
                engine.cache.sync_tier(entry.page_ids)
                n0 = pf.launches
                now = pool_pages_fingerprint(engine.cache.cache, entry.page_ids)
                smoke_pf[0] += pf.launches - n0
                if not torch.equal(now, entry.page_fp):
                    raise AssertionError("tier phase: PF over the prefetched pages differs "
                                         "from the entry's insert-time fingerprints")
                fp_checked.append(len(entry.page_ids))
            return ok

        engine._prefetch_entry = checked
    insert = engine.prefix.insert

    def counting(*a, **kw):
        entry, evicted = insert(*a, **kw)
        inserts[0] += entry is not None
        return entry, evicted

    engine.prefix.insert = counting
    base = engine.metrics.snapshot()
    reads0, prog = engine.host_reads, decode_program(engine)
    replays0 = prog.replays
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    prompts, cfgs = workload
    fired = []  # faults fired before each request's submission
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled else None
    t0 = time.perf_counter()
    if prof is not None:
        prof.start()
    reqs = []
    for i, (p, c) in enumerate(zip(prompts, cfgs)):
        fired.append(sum(inj.counters.values()) if inj is not None else 0)
        reqs.append(engine.submit(p, c, seed=i))
        if serial or i == len(prompts) - 1:
            while engine.has_work:
                engine.step()
                engine.cache.check()
                if tier is not None:
                    tier.check()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != TIER_NEW:
            raise AssertionError(f"tier request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"tier request {r.rid}: token outside the vocabulary")
    snap = engine.metrics.snapshot()
    keys = ("prefix_hits", "prefix_misses", "prefix_evictions", "prefix_validation_failures",
            "prefill_full_count", "prefill_suffix_count", "executed_steps", "chunks",
            "kv_pages_spilled", "kv_spill_bytes", "kv_pages_prefetched", "kv_prefetch_bytes",
            "kv_prefetch_late", "kv_prefetch_wasted", "kv_spill_failures",
            "kv_prefetch_failures", "kv_host_poisoned", "prefill_full_wall_s",
            "prefill_suffix_wall_s")
    delta = {k: snap[k] - base[k] for k in keys}
    tiers = {t: snap["prefix_hit_tier"].get(t, 0) - base["prefix_hit_tier"].get(t, 0)
             for t in ("device", "host")}
    launches = {name: c.launches for name, c in counters.items()}
    replays = prog.replays - replays0
    if engine.decode_compilations != 1 or replays != delta["executed_steps"]:
        raise AssertionError(f"tier phase: decode_compilations {engine.decode_compilations}, "
                             f"replays {replays} for {delta['executed_steps']} executed steps")
    per_replay = dict(prog.launches_per_replay)
    want_replay = ({"qpaged_flash_decode": layers, "qpaged_write_attend": layers} if qkv
                   else {"paged_flash_decode": layers})
    if quantize is not None and quantize.weights is not None:
        want_replay["dequantize"] = 7 * layers + 1  # phase 5f's rule: every linear and lm_head
    if per_replay != want_replay:
        raise AssertionError(f"tier phase: launches per replay {per_replay} != {want_replay}")
    if launches["flash_attention"] != delta["prefill_full_count"] * layers:
        raise AssertionError(f"tier phase: K1 {launches['flash_attention']} != "
                             f"{delta['prefill_full_count']} full prefills x {layers}")
    if launches[suffix] != delta["prefill_suffix_count"] * layers or (
            qkv and launches["paged_flash_decode"] != 0):
        raise AssertionError(f"tier phase: {suffix} {launches[suffix]} != "
                             f"{delta['prefill_suffix_count']} suffix prefills x {layers}")
    engine_pf = launches["page_fingerprint"] - smoke_pf[0]
    if engine_pf != inserts[0] + tiers["device"]:
        raise AssertionError(f"tier phase: PF {engine_pf} != {inserts[0]} inserts + "
                             f"{tiers['device']} device-tier hits")
    n_spills = len(spills)
    reads = engine.host_reads - reads0
    want_reads = delta["chunks"] + len(reqs) + n_spills + tiers["device"]
    if reads != want_reads:
        raise AssertionError(f"tier phase: host reads {reads} != {delta['chunks']} chunks + "
                             f"{len(reqs)} first tokens + {n_spills} spills + {tiers['device']} "
                             "device-tier hits")
    if engine.cache.alloc.copy_bytes != 0:
        raise AssertionError(f"tier phase: copy_bytes {engine.cache.alloc.copy_bytes}")
    hbm = engine.hbm.snapshot()
    allocated = torch.cuda.memory_allocated()
    plan = engine.hbm.plan(host_budget_bytes=tier.arena_nbytes if tier is not None else None)
    res = dict(tokens=[list(r.tokens) for r in reqs], delta=delta, tiers=tiers, wall_s=wall,
               launches={k: v + (replays * per_replay.get(k, 0)) for k, v in launches.items()},
               replays=replays, per_replay=per_replay, inserts=inserts[0], engine_pf=engine_pf,
               spills=spills, verifies=verifies, fp_checked=fp_checked, reads=reads,
               ttft=[r.first_token_time - r.submit_time for r in reqs], hbm=hbm,
               allocated=allocated, plan=plan, build_s=build_s, fired=fired,
               counters=dict(inj.counters) if inj is not None else None, prof=prof,
               summary=tier.summary() if tier is not None else None,
               arena_pinned=tier.arena.is_pinned() if tier is not None else None,
               arena_bytes=tier.arena_nbytes if tier is not None else 0)
    res["launches"]["page_fingerprint"] -= smoke_pf[0]  # the smoke's checks are not the path's
    engine.prefix.clear()
    engine.cache.check()
    if engine.cache.alloc.free_pages != engine.cache.alloc.capacity or (
            tier is not None and tier.used_pages != 0):
        raise AssertionError("tier phase: pages still held after the store was cleared")
    if tier is not None:
        tier.check()
    return res


def tier_overlap(prof) -> dict:
    """From a profile's trace: the device ms of the host-to-device copies of
    at least 1 MiB (the prefetches' page copies on the tier stream) and of
    that, the ms during which a kernel ran on another stream (the decode
    replay's, a prefill's)."""
    import json
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    copies, kernels = [], {}
    for e in events:
        args = e.get("args") or {}
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "") and \
                int(args.get("bytes", 0)) >= 2 ** 20:
            copies.append((args.get("stream"), span))
        elif e.get("cat") == "kernel":
            kernels.setdefault(args.get("stream"), []).append(span)
    if not copies:
        return dict(copy_ms=None, overlap_ms=None, copies=0)
    copy_us = overlap_us = 0.0
    for stream, (a, b) in copies:
        copy_us += b - a
        other = sorted(s for st, spans in kernels.items() if st != stream for s in spans)
        covered, cur = 0.0, a
        for s0, s1 in other:
            lo, hi = max(s0, cur), min(s1, b)
            if hi > lo:
                covered += hi - lo
                cur = hi
        overlap_us += covered
    return dict(copy_ms=copy_us / 1e3, overlap_ms=overlap_us / 1e3, copies=len(copies))


def tier_phase(model, smi: str) -> dict:
    """Phase 5i: the host page tier at full width. (a) Four 1600-token
    system prompts in serial waves 0,1,2,3,0,1,2,3 through a pool that holds
    two of them: tiering off (revisits miss), on (every revisit a host-tier
    hit) and a control whose pool holds them all (every revisit a device-tier
    hit); on = control bit for bit. (b) The eight at once to the two slots,
    tiering on, under the profiler: the prefetches' copies overlapping the
    decode replays. (c) The int8 pool of phase 5f(c), (a)'s tiering-on leg
    and its control. (d) (a)'s tiered engine with a failed spill, a poisoned
    host page and a failed prefetch. Returns the phase's launches."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    t_phase = time.perf_counter()
    cfg = model.config
    workload = tier_workload(cfg.vocab_size)
    lens = [len(p) for p in workload[0]]
    off = tier_serve(model, workload, TIER_PAGES, None)
    on = tier_serve(model, workload, TIER_PAGES, TIER_HOST_PAGES)
    ctl = tier_serve(model, workload, TIER_CONTROL_PAGES, None)
    d = on["delta"]
    if off["delta"]["prefix_hits"] != 0:
        raise AssertionError(f"tier phase (a): tiering off scored {off['delta']['prefix_hits']} "
                             "hits on the revisits")
    if on["tiers"]["host"] != d["prefix_hits"] or d["prefix_hits"] < 4:
        raise AssertionError(f"tier phase (a): host-tier hits {on['tiers']} of "
                             f"{d['prefix_hits']} hits; want all, and at least 4")
    if ctl["tiers"]["device"] != ctl["delta"]["prefix_hits"] or ctl["delta"]["prefix_hits"] < 4:
        raise AssertionError(f"tier phase (a): control hits {ctl['tiers']}")
    if on["tokens"] != ctl["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(on["tokens"], ctl["tokens"])) if a != b]
        raise AssertionError(f"tier phase (a): tiering-on streams differ from the control's: "
                             f"requests {diff}")
    if len(on["fp_checked"]) != len(on["verifies"]) or not on["arena_pinned"]:
        raise AssertionError("tier phase (a): a prefetch went unchecked, or the arena is "
                             "not pinned")
    mib = 2.0 ** 20
    log(f"tier phase (a) ({smi}; llama3_8b, all {cfg.num_layers} layers, random bf16 weights "
        f"seed 0; 2 slots, page {PAGE}, chunk 8, eager; four {TIER_PREFIX}-token system "
        f"prompts + tails, contexts {lens[:4]}, waves 0,1,2,3,0,1,2,3, one run() each, "
        f"{TIER_NEW} new tokens greedy): pool {TIER_PAGES} pages, host tier "
        f"{TIER_HOST_PAGES} pages ({on['arena_bytes'] / 2**30:.3f} GiB pinned, "
        f"allocated with the engine in {on['build_s']:.3f} s of its construction)")
    for name, r in (("tiering off", off), ("tiering on", on), ("control (pool "
                                                                 f"{TIER_CONTROL_PAGES} pages)", ctl)):
        x = r["delta"]
        log(f"tier phase (a) {name}: hits {x['prefix_hits']} (device {r['tiers']['device']}, "
            f"host {r['tiers']['host']}), misses {x['prefix_misses']}, evictions "
            f"{x['prefix_evictions']}, spilled {x['kv_pages_spilled']} pages "
            f"({x['kv_spill_bytes'] / mib:.1f} MiB) in {len(r['spills'])} spills, prefetched "
            f"{x['kv_pages_prefetched']} pages ({x['kv_prefetch_bytes'] / mib:.1f} MiB), late "
            f"{x['kv_prefetch_late']}, wasted {x['kv_prefetch_wasted']}; full prefills "
            f"{x['prefill_full_count']} ({x['prefill_full_wall_s']:.4f} s), suffix prefills "
            f"{x['prefill_suffix_count']} ({x['prefill_suffix_wall_s']:.4f} s); host reads "
            f"{r['reads']} = chunks + first tokens + spills + device-tier hits; PF "
            f"{r['engine_pf']} = {r['inserts']} inserts + {r['tiers']['device']} device-tier "
            f"hits; wall {r['wall_s']:.3f} s")
    unit = on["hbm"]["residents"]["kv_pages"]["unit_bytes"]  # bytes of a page
    for sp in on["spills"]:
        log(f"tier phase (a) spill: {sp['pages']} pages ({sp['pages'] * unit / mib:.1f} MiB), copy "
            f"{1e3 * sp['copy_s']:.2f} ms (gather + pack + one device-to-host copy + the sync), "
            f"CRC {1e3 * sp['crc_s']:.2f} ms")
    for v in on["verifies"]:
        log(f"tier phase (a) verify: {v['pages']} pages, {1e3 * v['s']:.2f} ms (CRC-32 on the host)")
    crc_bytes = sum(sp["pages"] for sp in on["spills"]) * unit
    crc_s = sum(sp["crc_s"] for sp in on["spills"])
    log(f"tier phase (a) host CRC rate at put: {crc_bytes / max(crc_s, 1e-9) / 1e9:.3f} GB/s "
        f"({crc_bytes / mib:.1f} MiB in {crc_s:.4f} s)")
    ttft = {name: [r["ttft"][i] for i in range(4, 8)] for name, r in
            (("host-tier hit", on), ("device-tier hit", ctl))}
    ttft["miss"] = on["ttft"][:4]
    log("tier phase (a) TTFT at the same context lengths " + str(lens[:4]) + ": " + "; ".join(
        f"{k} " + ", ".join(f"{t:.4f}" for t in v) + f" s (mean {statistics.mean(v):.4f})"
        for k, v in ttft.items()))
    h = on["hbm"]
    dev = {k: v["bytes"] for k, v in h["residents"].items() if "tier" not in v}
    hst = {k: v["bytes"] for k, v in h["residents"].items() if "tier" in v}
    fits = on["plan"]["fits"]
    log(f"tier phase (a) hbm.snapshot() at the end of the tiered waves: device residents "
        f"{dev} (total {h['resident_bytes_total']}), host residents {hst}; bytes_in_use "
        f"{h['bytes_in_use']} (torch.cuda.memory_allocated {on['allocated']}), unaccounted "
        f"{h['unaccounted_bytes']}, limit {h['bytes_limit']}, utilization "
        f"{h['utilization'] if isinstance(h['utilization'], str) else round(h['utilization'], 4)}; "
        f"plan(): kv_pages additional {fits['kv_pages'].get('additional')}, kv_host_pages "
        f"additional {fits.get('kv_host_pages', {}).get('additional')} (host budget = the arena)")
    log(f"tier phase (a): streams on = control bit for bit (8 of 8); after every prefetch PF "
        f"over the new pages = the insert-time page_fp ({len(on['fp_checked'])} prefetches, "
        f"{sum(on['fp_checked'])} pages); copy_bytes 0; check() of both tiers clean after every "
        f"step; one capture an engine; after the store is cleared every device and host page "
        f"free")

    # (b) the eight at once: queued hits prefetch while a chunk runs
    ovl = tier_serve(model, workload, TIER_PAGES, TIER_HOST_PAGES, serial=False, profiled=True)
    worst = teacher_ratio(model, workload, ovl["tokens"])
    if worst > 1.0:
        raise AssertionError(f"tier phase (b): a greedy token lies {worst:.3g}x phase 3's limit "
                             "below its row's maximum teacher-forced")
    o = tier_overlap(ovl.pop("prof"))
    x = ovl["delta"]
    log(f"tier phase (b) ({smi}; the 8 requests at once, 2 slots, tiering on, profiler opened "
        f"after the capture): all DONE; hits {x['prefix_hits']} (host {ovl['tiers']['host']}), "
        f"prefetched {x['kv_pages_prefetched']} pages, kv_prefetch_late {x['kv_prefetch_late']}, "
        f"wasted {x['kv_prefetch_wasted']}; host-to-device copies >= 1 MiB: {o['copies']}, "
        + ("device time not measured (no copy in the trace)" if o["copy_ms"] is None else
           f"{o['copy_ms']:.3f} ms of device time, {o['overlap_ms']:.3f} ms of it beside a "
           f"kernel on another stream")
        + f"; every greedy token within {worst:.3g}x of phase 3's limit teacher-forced; "
        f"check() clean; wall {ovl['wall_s']:.3f} s (profiled)")

    # (c) the int8 pool of phase 5f(c)
    q = QuantConfig(kv="int8")
    qon = tier_serve(model, workload, TIER_PAGES, TIER_HOST_PAGES, quantize=q)
    qctl = tier_serve(model, workload, TIER_CONTROL_PAGES, None, quantize=q)
    if qon["tokens"] != qctl["tokens"]:
        raise AssertionError("tier phase (c): int8-pool tiering-on streams differ from the "
                             "int8 control's")
    if qon["tiers"]["host"] != qon["delta"]["prefix_hits"] or qon["delta"]["prefix_hits"] < 4:
        raise AssertionError(f"tier phase (c): hits {qon['tiers']}")
    x = qon["delta"]
    log(f"tier phase (c) ({smi}; phase 5f(c)'s int8 weights and int8 pool): hits "
        f"{x['prefix_hits']} all host-tier, spilled "
        f"{x['kv_pages_spilled']} pages ({x['kv_spill_bytes'] / mib:.1f} MiB: codes and scales), "
        f"prefetched {x['kv_pages_prefetched']}; PF with scales over every prefetch = page_fp "
        f"({len(qon['fp_checked'])}); launches per replay {qon['per_replay']} (phase 5f's rule; "
        f"K5 0), replays "
        f"{qon['replays']} = executed steps; streams = the int8 control's (pool "
        f"{TIER_CONTROL_PAGES} pages) bit for bit; spill walls copy "
        + ", ".join(f"{1e3 * s['copy_s']:.2f}" for s in qon["spills"]) + " ms, CRC "
        + ", ".join(f"{1e3 * s['crc_s']:.2f}" for s in qon["spills"]) + " ms")

    # (d) faults on (a)'s tiered engine
    flt = tier_serve(model, workload, TIER_PAGES, TIER_HOST_PAGES, schedule=TIER_SCHEDULE)
    want = {"spill_failures": 1, "poisoned_host_pages": 1, "prefetch_failures": 1}
    got = {k: flt["counters"][k] for k in want}
    x = flt["delta"]
    mets = {"kv_spill_failures": x["kv_spill_failures"], "kv_host_poisoned": x["kv_host_poisoned"],
            "kv_prefetch_failures": x["kv_prefetch_failures"]}
    if got != want or list(mets.values()) != [1, 1, 1] or sum(
            v for k, v in flt["counters"].items() if k not in want):
        raise AssertionError(f"tier phase (d): injector {flt['counters']}, metrics {mets}; "
                             f"the schedule: {want}")
    before = [i for i, n in enumerate(flt["fired"]) if n == 0]
    for i in before:
        if flt["tokens"][i] != on["tokens"][i]:
            raise AssertionError(f"tier phase (d): request {i}, submitted before any fault, "
                                 "differs from the fault-free run")
    worst = teacher_ratio(model, workload, flt["tokens"])
    if worst > 1.0:
        raise AssertionError(f"tier phase (d): a greedy token lies {worst:.3g}x phase 3's limit "
                             "below its row's maximum teacher-forced")
    same = sum(a == b for a, b in zip(flt["tokens"], on["tokens"]))
    log(f"tier phase (d) ({smi}; fail_spill at 0, poison_host_page at 0, fail_prefetch at 1): "
        f"injector {got}, metrics {mets}; hits {x['prefix_hits']} (host {flt['tiers']['host']}), "
        f"misses {x['prefix_misses']}, validation failures {x['prefix_validation_failures']}; "
        f"requests {before} submitted before the first fault equal the fault-free run's; "
        f"{same} of 8 streams equal it; every greedy token within {worst:.3g}x of phase 3's "
        f"limit teacher-forced; check() of both tiers clean after every step")
    runs = (off, on, ctl, ovl, qon, qctl, flt)
    launches = {name: sum(r["launches"][name] for r in runs) for name in off["launches"]}
    log(f"tier phase launches (replays included): {launches}")
    log(f"phase 5i wall: {time.perf_counter() - t_phase:.1f} s")
    collect_engines()
    return dict(launches=launches)


# --- phase 5j: weights that change ----------------------------------------------

SWAP_SEED = 1              # W1, the weights the swaps write (the model holds W0, seed 0)
RESTART_DEADLINE_S = 3600.0  # each restarted request's deadline budget (virtual seconds)
RESTART_GAP_S = 1000.0     # the virtual clock's jump between the kill and the restore


def param_ptrs(module) -> dict:
    return {k: t.data_ptr() for k, t in module.state_dict().items()}


def seed_mismatches(model, seed: int) -> list:
    """The parameters of ``model`` that differ from ``init_params(model,
    seed)``'s values, regenerated one tensor at a time in its order and
    compared bit for bit (no second copy of the model)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    bad = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            want = torch.empty_like(p)
            if name.endswith("norm.weight"):
                want.fill_(1.0)
            elif name == "model.embed.weight":
                want.normal_(0.0, 1.0, generator=gen)
            elif p.ndim == 2:
                want.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            else:
                want.zero_()
            if not torch.equal(want, p):
                bad.append(name)
            del want
    return bad


def engine_wave(engine, workload, paged: bool = False) -> dict:
    """``workload`` through a live engine: every kernel's count zeroed, the
    requests submitted at once (seed = index) and stepped to idle,
    ``check()`` of a paged pool after every step, each new prefix entry
    counted. Gates: every request DONE with its token count in the
    vocabulary. Returns the streams, the snapshot's deltas, the launches
    (the program's replays in the wave x its launches per replay added),
    the replays and the inserts."""
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    prompts, cfgs = workload
    counters = kernel_counters()
    prog = decode_program(engine)
    replays0, base = prog.replays, engine.metrics.snapshot()
    inserts = [0]
    if engine.prefix is not None:
        insert = engine.prefix.insert

        def counting(*a, **kw):
            entry, evicted = insert(*a, **kw)
            inserts[0] += entry is not None
            return entry, evicted

        engine.prefix.insert = counting
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
    while engine.has_work:
        engine.step()
        if paged:
            engine.cache.check()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if engine.prefix is not None:
        engine.prefix.insert = insert
    vocab = engine.model.config.vocab_size
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != r.config.max_new_tokens:
            raise AssertionError(f"request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocabulary")
    snap = engine.metrics.snapshot()
    replays = prog.replays - replays0
    launches = {name: c.launches for name, c in counters.items()}
    for name, n in prog.launches_per_replay.items():
        launches[name] += replays * n
    delta = {k: snap[k] - base[k] for k in (
        "prefix_hits", "prefix_misses", "prefix_evictions", "prefills", "executed_steps",
        "prefill_full_count", "prefill_suffix_count")}
    return dict(tokens=[list(r.tokens) for r in reqs], delta=delta, launches=launches,
                replays=replays, inserts=inserts[0], wall_s=wall,
                per_replay=dict(prog.launches_per_replay))


def swap_leg(model, m1, smi: str) -> dict:
    """5j(a): phase 5c's paged prefix engine and traffic. A wave under W0
    (``serve_prefix``: warm-up, the store cleared, the measured wave), then
    ``engine.params = W1`` (the float engine writes the model it serves),
    then the same wave again; a fresh engine over the model, which now
    holds W1, serves it too. Returns the launches of the second wave."""
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache

    cfg = model.config
    layers = cfg.num_layers
    workload = prefix_workload(cfg.vocab_size)
    w0 = serve_prefix(model, workload, True, PrefixCache())
    engine = w0.pop("engine")
    entries = len(engine.prefix.entries)
    ptrs, prog = param_ptrs(engine.model), decode_program(engine)
    w1 = m1.state_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.params = w1
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    alloc = engine.cache.alloc
    if param_ptrs(engine.model) != ptrs or engine.decode_compilations != 1:
        raise AssertionError("weight swap: a parameter moved, or the decode program was "
                             f"captured again ({engine.decode_compilations} captures)")
    if (engine.prefix.entries or alloc.referenced_pages or alloc.free_pages != alloc.capacity
            or engine.metrics.snapshot()["prefix_evictions"] - w0["snap"]["prefix_evictions"]
            != entries):
        raise AssertionError(f"weight swap: {len(engine.prefix.entries)} entries left of "
                             f"{entries}, {alloc.referenced_pages} pages referenced, "
                             f"{alloc.free_pages} of {alloc.capacity} free")
    engine.cache.check()
    w2 = engine_wave(engine, workload, paged=True)
    d = w2["delta"]
    if (d["prefix_hits"], d["prefix_misses"]) != (w0["delta"]["prefix_hits"],
                                                  w0["delta"]["prefix_misses"]):
        raise AssertionError(f"weight swap: the wave after it hit {d['prefix_hits']} and missed "
                             f"{d['prefix_misses']}; W0's wave {w0['delta']['prefix_hits']}, "
                             f"{w0['delta']['prefix_misses']} (a W0 entry was reused)")
    got = {"flash_attention": w2["launches"]["flash_attention"],
           "page_fingerprint": w2["launches"]["page_fingerprint"],
           "paged_flash_decode": w2["launches"]["paged_flash_decode"]}
    want = {"flash_attention": d["prefill_full_count"] * layers,
            "page_fingerprint": w2["inserts"] + d["prefix_hits"],
            "paged_flash_decode": (d["executed_steps"] + d["prefill_suffix_count"]) * layers}
    if got != want or engine.decode_compilations != 1:
        raise AssertionError(f"weight swap, second wave: launches {got} != {want} (K1 a full "
                             f"prefill x {layers}, PF an insert or a hit, K5 a replay or a "
                             f"suffix prefill x {layers}), captures {engine.decode_compilations}")
    same_w0 = [i for i, (a, b) in enumerate(zip(w2["tokens"], w0["tokens"])) if a == b]
    if same_w0:
        raise AssertionError(f"weight swap: requests {same_w0} streamed W0's tokens after the "
                             "swap")
    engine.prefix.clear()
    engine.cache.check()
    del engine
    collect_engines()
    fresh = serve_prefix(model, workload, True, PrefixCache())
    drain_prefix_store(fresh)
    if fresh["tokens"] != w2["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(w2["tokens"], fresh["tokens"])) if a != b]
        raise AssertionError(f"weight swap: requests {diff} differ from a fresh engine's over the "
                             "model holding W1")
    n = len(w2["tokens"])
    log(f"weights 5j(a) ({smi}; phase 5c's paged prefix engine and traffic, {PAGED_SLOTS} slots, "
        f"page {PAGE}): engine.params = W1 (seed {SWAP_SEED}, {sum(t.numel() * t.element_size() for t in w1.values()) / 1e9:.3f} GB "
        f"on the card) in {1e3 * swap_s:.2f} ms (device-to-device copy_ of every tensor, "
        f"the checks and the store's clear); every parameter at its address, one capture, "
        f"{entries} entries dropped, every page free of pins, check() clean; the wave after the "
        f"swap: hits {d['prefix_hits']}, misses {d['prefix_misses']} (W0's entry not reused), "
        f"K1 {got['flash_attention']} = {d['prefill_full_count']} full prefills x {layers}, PF "
        f"{got['page_fingerprint']} = {w2['inserts']} inserts + {d['prefix_hits']} hits, K5 "
        f"{got['paged_flash_decode']}; streams differ from W0's ({n} of {n}) and equal a fresh "
        f"engine's on W1 bit for bit ({n} of {n}); wall {w2['wall_s']:.3f} s (W0 wave "
        f"{w0['wall_s']:.3f})")
    return dict(launches=w2["launches"], swap_s=swap_s)


def quant_swap_leg(model, m1, srv: dict, smi: str) -> dict:
    """5j(b): phase 5f(a)'s int8 engine on phase 4's requests. A wave under
    W0, ``engine.params = W1`` (float: re-quantized into the engine's own
    codes and scales), a pre-quantized W1 bound as is, a wave under W1; a
    fresh int8 engine over ``m1`` (W1) serves the same wave. Returns the
    launches of the wave after the swap."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.quantization.utils import quantize_state_dict
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    layers, linears = model.config.num_layers, 7 * model.config.num_layers + 1
    q = QuantConfig(weights="int8")
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8, prefix_cache=None,
                           quantize=q)
    engine_wave(engine, srv["workload"])
    ptrs, w1 = param_ptrs(engine.model), m1.state_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.params = w1
    torch.cuda.synchronize()
    requant_s = time.perf_counter() - t0
    want = quantize_state_dict(w1, engine._weight_qcfg)
    got = engine.params
    bad = [k for k in want if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]
    if sorted(got) != sorted(want) or bad or param_ptrs(engine.model) != ptrs:
        raise AssertionError(f"quantized swap: codes or scales differ from quantize_state_dict(W1) "
                             f"({bad[:4]}), or a tensor moved")
    t0 = time.perf_counter()
    engine.params = want  # pre-quantized: bound as is
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    if param_ptrs(engine.model) != ptrs:
        raise AssertionError("quantized swap: a pre-quantized bind moved a tensor")
    del want, got
    w = engine_wave(engine, srv["workload"])
    if (w["per_replay"] != {"flash_decode": layers, "dequantize": linears}
            or engine.decode_compilations != 1):
        raise AssertionError(f"quantized swap: launches per replay {w['per_replay']}, captures "
                             f"{engine.decode_compilations}")
    d = w["delta"]
    if w["launches"]["dequantize"] != (d["executed_steps"] + d["prefills"]) * linears:
        raise AssertionError(f"quantized swap: DQ launches {w['launches']['dequantize']} != "
                             f"(executed steps + prefills) x {linears}")
    del engine
    collect_engines()
    fresh = ServingEngine(m1, num_slots=8, decode_chunk_size=8, prefix_cache=None, quantize=q)
    engine_wave(fresh, srv["workload"])  # the same history: a wave, then the measured one
    ref = engine_wave(fresh, srv["workload"])
    del fresh
    collect_engines()
    if ref["tokens"] != w["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(w["tokens"], ref["tokens"])) if a != b]
        raise AssertionError(f"quantized swap: requests {diff} differ from a fresh int8 engine's "
                             "on W1")
    bad = seed_mismatches(model, 0)
    if bad:
        raise AssertionError(f"quantized swap: the float source model changed: {bad[:4]}")
    log(f"weights 5j(b) ({smi}; phase 5f(a)'s int8 row engine, phase 4's 6 requests): "
        f"engine.params = W1 (float) re-quantized in {1e3 * requant_s:.2f} ms, codes and scales = "
        f"quantize_state_dict(W1) bit for bit in the same tensors; a pre-quantized W1 bound as "
        f"is in {1e3 * bind_s:.2f} ms; launches per replay {w['per_replay']}, DQ "
        f"{w['launches']['dequantize']} = (executed {d['executed_steps']} + prefills "
        f"{d['prefills']}) x {linears}; streams = a fresh int8 engine's on W1 ({len(w['tokens'])} "
        f"of {len(w['tokens'])}); the float source model = init_params(seed 0) bit for bit")
    return dict(launches=w["launches"], requant_s=requant_s)


def draft_leg(model, srv: dict, smi: str) -> dict:
    """5j(c): phase 5d's speculative engine (gamma 4) with ``draft_params=``
    holding the early-exit draft's tensors (eps 0) copied: the int8 target
    beside the float draft; a poisoned draft against its clean control; a
    draft swap mid-flight. Returns the launches of its runs."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.models.llama import early_exit_draft
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector

    workload = srv["workload"]
    target, draft = early_exit_draft(model, SPEC_DRAFT_LAYERS, 0.0)
    runs = {}
    # the int8 target is the early-exit target quantized: the pair's function
    # up to the quantization, so the acceptance still reads the draft
    runs["int8 target"] = serve_spec(target, draft, workload, own_draft=True,
                                     quantize=QuantConfig(weights="int8"))
    inj = FaultInjector().poison_draft(at=0, times=None)
    runs["poisoned"] = serve_spec(target, draft, workload, own_draft=True, injector=inj)
    runs["clean"] = serve_spec(target, draft, workload, own_draft=True)
    # the draft swap mid-flight: greedy, 160 new tokens (a clean chunk emits
    # up to 32), a corrupted draft between the first and the third
    # decode-only step, the clean one after
    prompts = workload[0]
    greedy = (prompts, [GenerationConfig(max_new_tokens=160, temperature=0.0)] * len(prompts))
    good = draft.state_dict()
    bad = {k: -v + 3.7 for k, v in good.items()}
    seg = {}

    def between(engine, i):
        sn = engine.metrics.snapshot()
        seg[i] = (sn["spec_accepted_tokens"], sn["spec_draft_tokens"])
        if i == 0:
            engine.draft_params = bad
        elif i == 2:
            engine.draft_params = good

    runs["swapped"] = serve_spec(target, draft, greedy, own_draft=True, between=between)
    del bad
    for name, r in runs.items():
        r["teacher"] = teacher_ratio(r["model"], workload if name != "swapped" else greedy,
                                     r["tokens"])
        if r["teacher"] > 1.0:
            raise AssertionError(f"draft 5j(c) {name}: a greedy token lies {r['teacher']:.3g}x "
                                 "phase 3's limit below its row's maximum teacher-forced")
        if not r["draft_alone"]:
            raise AssertionError(f"draft 5j(c) {name}: the draft shares storage with the target")
    poisoned, clean = greedy_accept_rate(runs["poisoned"]), greedy_accept_rate(runs["clean"])
    if inj.counters["poisoned_drafts"] < 1 or poisoned >= 0.5 or clean <= 0.9:
        raise AssertionError(f"draft 5j(c): poisoned_drafts {inj.counters['poisoned_drafts']}, "
                             f"greedy acceptance poisoned {poisoned:.4f} (< 0.5), clean "
                             f"{clean:.4f} (> 0.9)")
    changed = [k for k, v in runs["poisoned"]["draft_state"].items() if not torch.equal(v, good[k])]
    if changed:
        raise AssertionError(f"draft 5j(c): the poisoned draft's bits were not restored: "
                             f"{changed[:4]}")
    s0, s2 = seg[0], seg[2]
    last = runs["swapped"]["snap"]
    before = s0[0] / max(s0[1], 1)
    during = (s2[0] - s0[0]) / max(s2[1] - s0[1], 1)
    after = (last["spec_accepted_tokens"] - s2[0]) / max(last["spec_draft_tokens"] - s2[1], 1)
    if (during >= 0.5 or before <= 0.9 or s2[1] == s0[1]
            or runs["swapped"]["compilations"] != 1):
        raise AssertionError(f"draft 5j(c) mid-flight swap: acceptance before {before:.4f}, with "
                             f"the corrupted draft {during:.4f}, captures "
                             f"{runs['swapped']['compilations']}")
    for name, r in runs.items():
        sn = r["snap"]
        log(f"draft 5j(c) {name} ({smi}; phase 5d's engine, gamma {SPEC_GAMMA}, the layer-0 "
            f"draft at eps 0 as tensors of its own, no storage shared with the target): greedy "
            f"acceptance {greedy_accept_rate(r):.4f} (rate {sn['spec_accept_rate']:.4f}), rounds "
            f"{sn['spec_rounds']}, launches per replay {r['per_round']} decode kernels"
            + (f" + {7 * model.config.num_layers + 1} DQ" if name == "int8 target" else "")
            + f", one capture, teacher-forced "
            f"gap {r['teacher']:.3g}x its limit, wall {r['wall_s']:.3f} s")
    log(f"draft 5j(c): poisoned_drafts {inj.counters['poisoned_drafts']}, the draft's bits after "
        f"the run = its clean copy; mid-flight swap (greedy, 160 new tokens): acceptance "
        f"{before:.4f} before, {during:.4f} with the corrupted draft (2 chunks), {after:.4f} "
        f"after the clean one is back (old-draft K/V stays in the draft cache), no new capture")
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["clean"]["launches"]}
    del runs, target, draft, good
    collect_engines()
    return dict(launches=launches, poisoned=poisoned, clean=clean)


def restart_engine(model, paged: bool, clock):
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    kw = (dict(num_slots=PAGED_SLOTS, kv_page_size=PAGE,
               kv_num_pages=ROW_SLOTS * model.config.max_seq_len // PAGE + 1) if paged
          else dict(num_slots=8))
    return ServingEngine(model, decode_chunk_size=8, prefix_cache=None, time_fn=clock, **kw)


def resumed_gates(what: str, model, engine, reqs, mid, workload, ref_tokens, counts) -> dict:
    """The gates every continued stream passes (5j(d) and (e)): DONE with
    its token count, its pre-kill tokens first, every greedy token within
    phase 3's limit teacher-forced, K1 = the engine's admissions x 32, one
    capture. Returns the engine's launches and how many streams equal the
    uninterrupted run's."""
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    prompts, cfgs = workload
    layers = model.config.num_layers
    for r in reqs:
        i = r.rid
        if r.state is not RequestState.DONE or len(r.tokens) != cfgs[i].max_new_tokens:
            raise AssertionError(f"{what}: request {i}: {r.state} with {len(r.tokens)} tokens")
        if r.tokens[:len(mid[i])] != mid[i]:
            raise AssertionError(f"{what}: request {i} does not continue its pre-kill tokens")
    tokens = [list(r.tokens) for r in sorted(reqs, key=lambda r: r.rid)]
    order = sorted(r.rid for r in reqs)
    worst = teacher_ratio(model, ([prompts[i] for i in order], [cfgs[i] for i in order]), tokens)
    if worst > 1.0:
        raise AssertionError(f"{what}: a greedy token lies {worst:.3g}x phase 3's limit below its "
                             "row's maximum teacher-forced")
    launches, _ = engine_launches(engine, counts)
    if launches["flash_attention"] != engine.metrics.prefills * layers:
        raise AssertionError(f"{what}: K1 {launches['flash_attention']} != "
                             f"{engine.metrics.prefills} admissions x {layers}")
    if engine.decode_compilations != 1:
        raise AssertionError(f"{what}: {engine.decode_compilations} captures")
    same = sum(t == ref_tokens[i] for t, i in zip(tokens, order))
    return dict(launches=launches, same=same, teacher=worst)


def restart_leg(model, workload, paged: bool, ref_tokens, smi: str) -> dict:
    """5j(d): two steps of ``workload`` on a virtual clock, ``fence``, the
    snapshot through JSON, a restore into a fresh engine over the same
    module 1000 s later; (e) on the row engine, the fenced engine's
    requeued requests adopted one by one by another fresh engine. Returns
    the launches of every engine."""
    from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock

    what = "paged" if paged else "row"
    prompts, cfgs = workload
    layers = model.config.num_layers
    clock = VirtualClock(start=0.0)
    a = restart_engine(model, paged, clock)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    reqs = [a.submit(p, c, seed=i, deadline_s=RESTART_DEADLINE_S)
            for i, (p, c) in enumerate(zip(prompts, cfgs))]
    for _ in range(2):
        a.step()
        clock.advance(0.5)
    mid = [list(r.tokens) for r in reqs]
    live = [r for r in reqs if not r.finished]
    budgets = {r.rid: r.deadline - clock() for r in live}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.fence("chip smoke kill")
    snap = json.loads(json.dumps(a.snapshot_serving_state()))
    a.step()
    if [list(r.tokens) for r in reqs] != mid:
        raise AssertionError(f"restart ({what}): stepping the fenced engine changed a token")
    out = {name: c.launches for name, c in counters.items()}
    a_launch, _ = engine_launches(a, out)
    if a_launch["flash_attention"] != a.metrics.prefills * model.config.num_layers:
        raise AssertionError(f"restart ({what}): the killed engine's K1 {a_launch['flash_attention']}")
    for c in counters.values():
        c.launches = 0
    clock_b = VirtualClock(start=clock() + RESTART_GAP_S)
    b = restart_engine(model, paged, clock_b)
    rep = b.restore_serving_state(snap)
    b.step()  # the re-prefills and the first chunk: the first tokens after the restore
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    b.run()
    if paged:
        b.cache.check()
    if rep["restored"] != len(live) or rep["downtime_s"] != RESTART_GAP_S:
        raise AssertionError(f"restart ({what}): {rep} for {len(live)} live requests and a "
                             f"{RESTART_GAP_S} s gap")
    got = [b.scheduler.requests[r.rid] for r in live]
    left = {r.rid: r.deadline - clock_b() for r in got}  # the virtual clock stood still
    if b.metrics.prefills != len(live) or left != budgets:
        raise AssertionError(f"restart ({what}): {b.metrics.prefills} re-admissions, deadline "
                             f"budgets {left} against {budgets}")
    res = resumed_gates(f"restart ({what})", model, b, got, mid, workload, ref_tokens,
                        {name: c.launches for name, c in counters.items()})
    launches = {k: a_launch[k] + res["launches"][k] for k in a_launch}
    log(f"weights 5j(d) restart, {what} engine ({smi}; "
        + (f"phase 5b's {PAGED_SLOTS}-slot paged engine and 15 requests" if paged else
           "phase 4's 8-slot row engine and 6 requests")
        + f", a virtual clock): two steps, fence, the snapshot through JSON "
        f"({len(json.dumps(snap))} bytes, {len(snap['requests'])} requests); the fenced engine's "
        f"step changed no token; restored {rep['restored']} (the live requests), downtime_s "
        f"{rep['downtime_s']} exact, every deadline budget exact, all DONE, every stream begins "
        f"with its pre-kill tokens, teacher-forced gap {res['teacher']:.3g}x phase 3's limit; K1 "
        f"{a_launch['flash_attention']} + {res['launches']['flash_attention']} = (admissions "
        f"{a.metrics.prefills} + re-admissions {b.metrics.prefills}) x {layers}; one capture an "
        f"engine; "
        f"streams equal to the uninterrupted run's: {res['same']} of {len(live)}; fence to the "
        f"first token after the restore {first_s:.3f} s (the snapshot, the new engine, "
        f"{b.metrics.prefills} re-prefills, the capture and one chunk)")
    out = dict(launches=launches, first_s=first_s)
    if not paged:
        # (e) adopt: the fenced engine's requeued requests, one by one
        for c in counters.values():
            c.launches = 0
        e = restart_engine(model, False, VirtualClock(start=clock() + 5.0))
        adopted = [e.adopt(r) for r in a.scheduler.queued_requests]
        e.run()
        res_e = resumed_gates("adopt", model, e, adopted, mid, workload, ref_tokens,
                              {name: c.launches for name, c in counters.items()})
        log(f"weights 5j(e) adopt ({smi}): the fenced row engine's {len(adopted)} requeued "
            f"requests adopted one by one by a fresh engine: all DONE, every stream begins with "
            f"its pre-kill tokens, teacher-forced gap {res_e['teacher']:.3g}x phase 3's limit, K1 "
            f"{res_e['launches']['flash_attention']} = {e.metrics.prefills} admissions x {layers}, one "
            f"capture; equal to the uninterrupted run's: {res_e['same']} of {len(adopted)}")
        out["launches"] = {k: launches[k] + res_e["launches"][k] for k in launches}
        del e
    del a, b
    collect_engines()
    return out


def weights_phase(model, srv: dict, paged: dict, smi: str) -> dict:
    """Phase 5j: weights that change, at full width and depth. (a) a weight
    swap on phase 5c's paged prefix engine; (b) a quantized swap on phase
    5f(a)'s int8 engine; (c) a draft with its own weights on phase 5d's
    engine (beside an int8 target, poisoned, swapped mid-flight); (d)
    fence, snapshot and restore on phase 4's row and phase 5b's paged
    engines; (e) adopt on the row engine. ``srv``/``paged``: phases 4's and
    5b's runs (the workloads and the uninterrupted streams). Returns the
    phase's launches (replays included)."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    m1 = init_params(LlamaForCausalLM(model.config, device=model.device), seed=SWAP_SEED)
    torch.cuda.synchronize()
    log(f"weights 5j: W1 = init_params(seed {SWAP_SEED}) on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    a = swap_leg(model, m1, smi)
    init_params(model, seed=0)  # the model back to W0 (the float engine wrote W1 into it)
    b = quant_swap_leg(model, m1, srv, smi)
    del m1
    collect_engines()
    c = draft_leg(model, srv, smi)
    d_row = restart_leg(model, srv["workload"], False, srv["tokens"], smi)
    d_paged = restart_leg(model, paged_workload(model.config.vocab_size), True, paged["tokens"],
                          smi)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak > 72:
        raise AssertionError(f"weights 5j: peak memory {peak:.1f} GiB over 72")
    legs = (a, b, c, d_row, d_paged)
    launches = {k: sum(x["launches"][k] for x in legs) for k in a["launches"]}
    log(f"weights phase launches (replays included): {launches}; peak mem {peak:.1f} GiB")
    log(f"phase 5j wall: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# --- phase 5k: the serving fabric ------------------------------------------------

FABRIC_REPLICAS = 3    # the router's replicas: engines that share the one card and its weights
FABRIC_STEP_DT = 0.3   # virtual seconds a router step in 5k(c)/(d): one watchdog probe a step
FABRIC_PARTITIONED = 2  # the replica 5k(c) partitions
BURST_CHATS, BURST_DOCS = 8, 4  # 5k(e)'s TPOT burst: chat decoders, then 5h-sized documents


def fabric_sync(model) -> None:
    if model.device.type == "cuda":
        torch.cuda.synchronize()


def fabric_paged_kw(model) -> dict:
    """Phase 5b's paged engine: 16 slots, 2049 pages of 16, chunk 8."""
    return dict(num_slots=PAGED_SLOTS, kv_page_size=PAGE, decode_chunk_size=8,
                kv_num_pages=ROW_SLOTS * model.config.max_seq_len // PAGE + 1)


def fabric_dry_model(model):
    """The CPU dry run's model: the phase's vocabulary and ``max_seq_len``
    at a tiny width (fp32, one layer). The router's decisions depend on
    lengths, prompt tokens, the virtual clock and host state only, never
    on the model's arithmetic, so a dry run of a leg on the CPU makes the
    decisions the card's run must make."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params

    c = model.config
    cfg = LlamaConfig(vocab_size=c.vocab_size, hidden_size=64, intermediate_size=128, num_layers=1,
                      num_heads=2, num_kv_heads=1, max_seq_len=c.max_seq_len, dtype=torch.float32)
    return init_params(LlamaForCausalLM(cfg, device="cpu"), seed=0)


@contextlib.contextmanager
def fabric_dry_sampler():
    """The dry run's decode steps pick each slot's argmax: its decisions do
    not depend on the tokens (no request stops at an EOS), and the
    per-row sampler sorts the whole 128256-wide vocabulary a slot and a
    step, which on the CPU costs most of a dry run. The card's legs run
    the engine's own sampler."""
    from neuronx_distributed_tpu_torch.inference import generate as gen_mod
    from neuronx_distributed_tpu_torch.utils.sampling import greedy

    saved = gen_mod.sample_per_row
    gen_mod.sample_per_row = lambda logits, *a: greedy(logits)
    try:
        yield
    finally:
        gen_mod.sample_per_row = saved


def fabric_chaos():
    """JAX's ``_chaos_faults`` (``tests/serving/test_fabric_soak.py``):
    duplicated, dropped and delayed sends across the run."""
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector

    return (FaultInjector().dup_send(at=3, times=2).drop_send(at=9, times=2)
            .delay_send(at=15, times=2, by=0.01).dup_send(at=24, times=1)
            .drop_send(at=33, times=1))


def fabric_step(router, paged: bool = True) -> None:
    """One router step, then ``check()`` of every paged replica's pool."""
    router.step()
    if paged:
        for e in router.replicas:
            getattr(e, "engine", e).cache.check()


def fabric_launches(engines, counters) -> dict:
    """The wrappers' counts plus every engine's replays x its launches a
    replay (a replay calls no wrapper)."""
    out = {name: c.launches for name, c in counters.items()}
    for e in engines:
        prog = decode_program(e)
        if prog is not None:
            for name, n in prog.launches_per_replay.items():
                out[name] += prog.replays * n
    return out


def fabric_zero(model) -> dict:
    counters = kernel_counters()
    fabric_sync(model)
    for c in counters.values():
        c.launches = 0
    return counters


def fabric_done(what: str, model, reqs) -> None:
    """Every request DONE with its token count, in the vocabulary."""
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    vocab = model.config.vocab_size
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != r.config.max_new_tokens:
            raise AssertionError(f"fabric {what}: request {r.rid}: {r.state} with "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"fabric {what}: request {r.rid}: a token outside the vocabulary")


def fabric_teacher(what: str, model, prompts, cfgs, reqs) -> float:
    worst = teacher_ratio(model, (prompts, cfgs), [list(r.tokens) for r in reqs])
    if worst > 1.0:
        raise AssertionError(f"fabric {what}: a greedy token lies {worst:.3g}x phase 3's limit "
                             "below its row's maximum teacher-forced")
    return worst


def fabric_captures(what: str, router) -> list:
    """One capture a replica that decoded, none elsewhere."""
    got = [getattr(e, "engine", e).decode_compilations for e in router.replicas]
    want = [int(getattr(e, "engine", e).metrics.executed_steps > 0) for e in router.replicas]
    if got != want:
        raise AssertionError(f"fabric {what}: captures {got}, want {want}")
    return got


def fabric_affinity(model, dry: bool = False) -> dict:
    """5k(a): a router of 3 paged replicas (phase 5b's engine, prefix cache
    on) serves phase 5c's prefix workload in the order of JAX's
    ``test_affinity_steers_shared_prefix_sessions`` (one session warms a
    replica, each later one is submitted and served alone), then phase 5b's
    15 requests at once. ``dry``: the decisions alone (the CPU dry run)."""
    from neuronx_distributed_tpu_torch.serving.router import ReplicaRouter

    cfg = model.config
    layers = cfg.num_layers
    pre_p, pre_c = prefix_workload(cfg.vocab_size)
    pag_p, pag_c = paged_workload(cfg.vocab_size)
    router = ReplicaRouter.build(model, FABRIC_REPLICAS, **fabric_paged_kw(model))
    inserts = [0] * FABRIC_REPLICAS
    for i, e in enumerate(router.replicas):
        def counting(*a, _insert=e.prefix.insert, _i=i, **kw):
            entry, evicted = _insert(*a, **kw)
            inserts[_i] += entry is not None
            return entry, evicted

        e.prefix.insert = counting
    counters = fabric_zero(model)
    t0 = time.perf_counter()
    reqs = []
    for i, (p, c) in enumerate(zip(pre_p, pre_c)):
        reqs.append(router.submit(p, c, seed=i))
        while router.has_work:
            fabric_step(router)
    for j, (p, c) in enumerate(zip(pag_p, pag_c)):
        reqs.append(router.submit(p, c, seed=j))
    while router.has_work:
        fabric_step(router)
    fabric_sync(model)
    wall = time.perf_counter() - t0
    launches = fabric_launches(router.replicas, counters)
    fabric_done("5k(a)", model, reqs)
    snaps = [e.metrics.snapshot() for e in router.replicas]
    decisions = dict(routed=router.stats["routed"], affinity_hits=router.stats["affinity_hits"],
                     routed_by_replica=list(router.routed_by_replica),
                     hits=[s["prefix_hits"] for s in snaps], misses=[s["prefix_misses"] for s in snaps],
                     inserts=list(inserts))
    if dry:
        return dict(decisions=decisions)
    if router.stats["routed"] != len(reqs):
        raise AssertionError(f"fabric 5k(a): routed {router.stats['routed']} of {len(reqs)}")
    full = sum(s["prefill_full_count"] for s in snaps)
    if launches["flash_attention"] != full * layers:
        raise AssertionError(f"fabric 5k(a): K1 {launches['flash_attention']} != full prefills "
                             f"{full} x {layers}")
    hits = sum(decisions["hits"])
    if launches["page_fingerprint"] != sum(inserts) + hits:
        raise AssertionError(f"fabric 5k(a): PF {launches['page_fingerprint']} != inserts "
                             f"{sum(inserts)} + paged hits {hits}")
    captures = fabric_captures("5k(a)", router)
    worst = fabric_teacher("5k(a)", model, pre_p + pag_p, pre_c + pag_c, reqs)
    del router
    collect_engines()
    return dict(decisions=decisions, launches=launches, wall_s=wall, full=full, hits=hits,
                teacher=worst, captures=captures)


def fabric_rehome(model, srv: dict) -> dict:
    """5k(b): a router of 3 row replicas (phase 4's engine: 8 slots, chunk
    8) on phase 4's requests; replica 1's dispatches fail from its third on
    (JAX's ``test_halted_replica_rehomes_with_zero_tokens_lost``), so it
    halts mid-decode with its work requeued, and the router re-homes it."""
    from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
    from neuronx_distributed_tpu_torch.serving.engine import EngineHealth
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
    from neuronx_distributed_tpu_torch.serving.router import ReplicaRouter

    prompts, cfgs = srv["workload"]
    layers = model.config.num_layers
    router = ReplicaRouter.build(model, FABRIC_REPLICAS, num_slots=8, decode_chunk_size=8,
                                 prefix_cache=None, sleep_fn=lambda s: None,
                                 registry=MetricsRegistry())
    inj = FaultInjector().fail_dispatch(at=2, times=None)
    router.replicas[1]._faults = inj
    counters = fabric_zero(model)
    reqs = [router.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
    bufs, pre = {}, None
    while router.has_work:
        router.step()
        for i in (0, 2):
            e = router.replicas[i]
            if i not in bufs and e.decode_compilations:
                bufs[i] = graph_buffers(e)
        if pre is None and router.replicas[1].health() is EngineHealth.HALTED:
            pre = {r.rid: list(r.tokens) for r in router.replicas[1].scheduler.queued_requests}
    fabric_sync(model)
    launches = fabric_launches(router.replicas, counters)
    fabric_done("5k(b)", model, reqs)
    if pre is None or not all(pre.values()):
        raise AssertionError(f"fabric 5k(b): replica 1 did not halt mid-decode ({pre})")
    final = {r.rid: router.requests[r.rid].tokens for r in reqs}
    lost = [rid for rid, toks in pre.items() if final[rid][:len(toks)] != toks]
    if lost or router.stats["rehomed_requests"] != len(pre):
        raise AssertionError(f"fabric 5k(b): re-homed {router.stats['rehomed_requests']} of "
                             f"{len(pre)} unfinished; streams that lost their pre-halt tokens {lost}")
    for i in (0, 2):
        e = router.replicas[i]
        if e.decode_compilations != 1 or graph_buffers(e) != bufs[i]:
            raise AssertionError(f"fabric 5k(b): survivor {i}'s capture changed")
    admissions = sum(e.metrics.prefills for e in router.replicas)
    if launches["flash_attention"] != admissions * layers:
        raise AssertionError(f"fabric 5k(b): K1 {launches['flash_attention']} != (admissions + "
                             f"re-admissions) {admissions} x {layers}")
    if min(launches["flash_decode"], launches["flash_attention"]) < 1 or launches["paged_flash_decode"]:
        raise AssertionError(f"fabric 5k(b): row serving launched {launches}")
    worst = fabric_teacher("5k(b)", model, prompts, cfgs, reqs)
    same = sum(router.requests[r.rid].tokens == srv["tokens"][i] for i, r in enumerate(reqs))
    out = dict(launches=launches, rehomed=router.stats["rehomed_requests"],
               rehome_s=router._h_rehome.sum, admissions=admissions, teacher=worst, same=same,
               failures=inj.counters["dispatch_failures"], pre=sum(map(len, pre.values())))
    del router
    collect_engines()
    return out


def fabric_watchdog(model, dry: bool = False) -> dict:
    """5k(c): the router of (a) over a ``ChaosTransport`` (JAX's
    ``_chaos_faults``) with a ``WatchdogConfig`` on a virtual clock,
    phase 5b's traffic; right after the submissions replica 2 is
    partitioned for good, so its probes fail until it is declared DEAD,
    fenced, and its work re-homed."""
    from neuronx_distributed_tpu_torch.serving.engine import EngineHealth
    from neuronx_distributed_tpu_torch.serving.router import ReplicaRouter, WatchdogConfig
    from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock
    from neuronx_distributed_tpu_torch.serving.transport import ChaosTransport

    cfg = model.config
    prompts, cfgs = paged_workload(cfg.vocab_size)
    clock = VirtualClock()
    inj = fabric_chaos()
    transport = ChaosTransport(inj, time_fn=clock)
    router = ReplicaRouter.build(model, FABRIC_REPLICAS, transport=transport,
                                 watchdog=WatchdogConfig(), time_fn=clock,
                                 **fabric_paged_kw(model))
    counters = fabric_zero(model)
    reqs = [router.submit(p, c, seed=j) for j, (p, c) in enumerate(zip(prompts, cfgs))]
    inj.partition(FABRIC_PARTITIONED, at=transport._send_idx)
    dead = router.replicas[FABRIC_PARTITIONED]
    seq, pre = [tuple(router.probe_states().values())], None
    while router.has_work:
        before = {r.rid: list(r.tokens) for r in dead.scheduler.requests.values()
                  if not r.finished}
        clock.advance(FABRIC_STEP_DT)
        fabric_step(router)
        seq.append(tuple(router.probe_states().values()))
        if pre is None and dead.health() is EngineHealth.HALTED:
            pre = before
    fabric_sync(model)
    launches = fabric_launches(router.replicas, counters)
    fabric_done("5k(c)", model, reqs)
    walk = [s[FABRIC_PARTITIONED] for i, s in enumerate(seq)
            if i == 0 or s[FABRIC_PARTITIONED] != seq[i - 1][FABRIC_PARTITIONED]]
    decisions = dict(seq=seq, transport=transport.snapshot(), stats=dict(router.stats),
                     counters=dict(inj.counters), routed_by_replica=list(router.routed_by_replica))
    if dry:
        return dict(decisions=decisions)
    if walk != ["ok", "suspect", "degraded", "dead"] or pre is None:
        raise AssertionError(f"fabric 5k(c): replica {FABRIC_PARTITIONED} walked {walk}")
    objects = {}
    for e in router.replicas:
        for rid, r in e.scheduler.requests.items():
            objects.setdefault(rid, set()).add(id(r))
    twice = [rid for rid, ids in objects.items() if len(ids) != 1]
    lost = [rid for rid, toks in pre.items() if router.requests[rid].tokens[:len(toks)] != toks]
    if (twice or lost or router.stats["rehomed_requests"] != len(pre)
            or router.stats["watchdog_deaths"] != 1):
        raise AssertionError(f"fabric 5k(c): rids twice {twice}, streams that lost tokens {lost}, "
                             f"re-homed {router.stats['rehomed_requests']} of {len(pre)}, "
                             f"deaths {router.stats['watchdog_deaths']}")
    captures = fabric_captures("5k(c)", router)
    worst = fabric_teacher("5k(c)", model, prompts, cfgs, reqs)
    out = dict(decisions=decisions, launches=launches, walk=walk, rehomed=len(pre),
               teacher=worst, captures=captures, steps=len(seq) - 1)
    del router
    collect_engines()
    return out


def fabric_join(model, dry: bool = False) -> dict:
    """5k(d): (c)'s router configuration without the partition, phase
    5b's 15 requests queued: ``add_replica()`` rebalances the queue onto a
    fourth replica, ``remove_replica(0)`` drains replica 0 out, and after
    two steps replica 1 is fenced and ``restart_replica(1)`` restores its
    live requests on a fresh replica."""
    from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
    from neuronx_distributed_tpu_torch.serving.router import ReplicaRouter, WatchdogConfig
    from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock
    from neuronx_distributed_tpu_torch.serving.transport import ChaosTransport

    cfg = model.config
    prompts, cfgs = paged_workload(cfg.vocab_size)
    clock = VirtualClock()
    inj = fabric_chaos()
    transport = ChaosTransport(inj, time_fn=clock)
    router = ReplicaRouter.build(model, FABRIC_REPLICAS, transport=transport,
                                 watchdog=WatchdogConfig(), time_fn=clock,
                                 registry=MetricsRegistry(), **fabric_paged_kw(model))
    counters = fabric_zero(model)
    reqs = [router.submit(p, c, seed=j) for j, (p, c) in enumerate(zip(prompts, cfgs))]
    joined = router.add_replica()
    router.remove_replica(0)
    for _ in range(2):
        clock.advance(FABRIC_STEP_DT)
        fabric_step(router)
    victim = router.replicas[1]
    victim.fence("chip smoke kill")
    mid = {r.rid: list(r.tokens) for r in victim.scheduler.queued_requests}
    t0 = time.perf_counter()
    new = router.restart_replica(1)
    while router.has_work:
        clock.advance(FABRIC_STEP_DT)
        fabric_step(router)
    fabric_sync(model)
    launches = fabric_launches(router.replicas, counters)
    final = [router.requests[r.rid] for r in reqs]
    fabric_done("5k(d)", model, final)
    decisions = dict(joined=joined, new=new, stats=dict(router.stats),
                     routed_by_replica=list(router.routed_by_replica),
                     probe_states=router.probe_states(), transport=transport.snapshot(),
                     restored=sorted(mid))
    if dry:
        return dict(decisions=decisions)
    lost = [rid for rid, toks in mid.items() if router.requests[rid].tokens[:len(toks)] != toks]
    if (lost or router.stats["replicas_removed"] != 1 or router.stats["replicas_restarted"] != 1
            or not mid):
        raise AssertionError(f"fabric 5k(d): streams that lost tokens {lost}, stats "
                             f"{router.stats}, restored {len(mid)}")
    restored = router.replicas[new].metrics.snapshot()["restored"]
    if restored != len(mid):
        raise AssertionError(f"fabric 5k(d): restored {restored} of {len(mid)} live requests")
    captures = fabric_captures("5k(d)", router)
    worst = fabric_teacher("5k(d)", model, prompts, cfgs, final)
    out = dict(decisions=decisions, launches=launches, restart_s=router._h_restart.sum,
               restore_to_idle_s=time.perf_counter() - t0, restored=restored, teacher=worst,
               captures=captures)
    del router
    collect_engines()
    return out


def fabric_staged_vs_coupled(model, quantize, num_pages, prompts) -> dict:
    """For each prompt, on one engine: a coupled admission (its slot's
    pages), then the same prompt through a worker of a
    ``DisaggregatedServer`` over the same engine (its staged pages): the two
    page sets hold the same bytes, K and V in every context row (whole
    pages, codes and scales, on an int8 pool); then both requests decode to
    the end (K5, or K5q on an int8 pool, right after the handoff)."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.disagg import DisaggregatedServer
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    kw = dict(fabric_paged_kw(model), kv_num_pages=num_pages or fabric_paged_kw(model)["kv_num_pages"])
    engine = ServingEngine(model, prefix_cache=None, quantize=quantize, **kw)
    names = ("k", "v", "k_scale", "v_scale") if engine.cache.cache.quantized else ("k", "v")
    counters = fabric_zero(model)
    pages, reqs = 0, []
    for i, p in enumerate(prompts):
        g = GenerationConfig(max_new_tokens=8, temperature=0.0)
        reqs.append(engine.submit(p, g, seed=i))
        engine._admit(engine._now())
        cids = engine.cache.slot_pages(reqs[-1].slot)
        server = DisaggregatedServer(engine, n_workers=1)
        reqs.append(engine.submit(p, g, seed=i))
        server._run_prefills(engine._now())
        _, staged, _ = server._pending[0]
        sids = list(staged.page_ids)
        c = engine.cache.cache
        for name in names:
            a, b = getattr(c, name)[:, cids], getattr(c, name)[:, sids]
            if not engine.cache.cache.quantized:
                # a float pool's recycled page keeps its last owner's rows past
                # the context (never attended); an int8 page is zeroed when
                # mapped, so its whole page, scales included, is compared
                a, b = (t.flatten(1, 2)[:, :len(p)] for t in (a, b))
            if len(sids) != len(cids) or not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(f"fabric 5k(e): prompt of {len(p)}: the staged pages' {name} "
                                     "differ from the coupled prefill's")
        pages += len(sids)
        server.run()
        engine.cache.check()
        engine.external_prefill = False
    fabric_done("5k(e) staged", model, reqs)
    if engine.cache.alloc.referenced_pages or engine.decode_compilations != 1:
        raise AssertionError(f"fabric 5k(e): staged leg left {engine.cache.alloc.referenced_pages} "
                             f"pages referenced, {engine.decode_compilations} captures")
    fabric_sync(model)
    launches = fabric_launches([engine], counters)
    per_replay = dict(engine.decode_program.launches_per_replay)
    del engine, server
    collect_engines()
    return dict(pages=pages, per_replay=per_replay, launches=launches)


def fabric_disagg_run(model, prompts, cfgs, shared: bool, injector=None) -> dict:
    """Phase 5b's engine behind a ``DisaggregatedServer`` (1 worker,
    ``prefills_per_step=1``, ``shared_pool``), the requests submitted at
    once and served to the end, ``check()`` after every step; the walls of
    each handoff's ``map_staged`` and each ``import_pages``."""
    from neuronx_distributed_tpu_torch.serving.disagg import DisaggregatedServer
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine(model, prefix_cache=None, **fabric_paged_kw(model))
    server = DisaggregatedServer(engine, n_workers=1, prefills_per_step=1, shared_pool=shared,
                                 fault_injector=injector)
    workers = list(server.workers)  # a dead worker leaves server.workers
    walls = {"map_staged": [], "import_pages": []}
    nbytes = []
    for name in walls:
        fn = getattr(engine.cache, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            fabric_sync(model)
            t = time.perf_counter()
            out = _fn(*a, **kw)
            fabric_sync(model)
            walls[_name].append(time.perf_counter() - t)
            if _name == "import_pages":
                nbytes.append(a[0].nbytes)
            return out

        setattr(engine.cache, name, timed)
    counters = fabric_zero(model)
    reqs = [server.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
    while server.has_work:
        server.step()
        engine.cache.check()
    fabric_sync(model)
    launches, warm = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    fabric_done("5k(e)", model, reqs)
    a = engine.cache.alloc
    if a.referenced_pages or a.free_pages != a.capacity:
        raise AssertionError(f"fabric 5k(e): {a.referenced_pages} pages still referenced")
    out = dict(tokens=[list(r.tokens) for r in reqs], stats=dict(server.stats),
               copy_bytes=a.copy_bytes, exported=sum(nbytes), walls=walls, launches=launches,
               warm=warm, snap=engine.metrics.snapshot(), page_nbytes=engine.cache.page_nbytes,
               captures=engine.decode_compilations, workers=len(server.workers),
               coupled=engine.metrics.snapshot()["prefill_full_count"], reqs=reqs,
               worker_calls=sum(w.calls for w in workers))
    del engine, server
    collect_engines()
    return out


def fabric_burst(model, disagg: bool) -> dict:
    """TPOT under a document burst (wall clock): 8 chat requests of
    100-400 tokens (64 new, greedy) decode; once every one has its first
    token, 4 documents of 2000-3000 tokens (phase 5h's docs sizes, 16 new)
    arrive. Through the coupled engine their prefills run inside the
    decoders' steps, all in one; through the disaggregated server (1
    worker, one prefill a step) at most one runs between two chunks.
    Returns the chat requests' TPOT (first token to last, a request's
    mean) p50 and p99, and the p99 over chats of each one's longest wait
    between two token deliveries after the burst (a chunk's tokens arrive
    together, so the waits are the steps)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.disagg import DisaggregatedServer
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    rng = np.random.default_rng(11)
    vocab = model.config.vocab_size
    chats = [rng.integers(1, vocab, size=int(rng.integers(100, 401))) for _ in range(BURST_CHATS)]
    docs = [rng.integers(1, vocab, size=int(rng.integers(2000, 3001))) for _ in range(BURST_DOCS)]
    engine = ServingEngine(model, prefix_cache=None, **fabric_paged_kw(model))
    engine.prewarm()
    front = DisaggregatedServer(engine, n_workers=1, prefills_per_step=1) if disagg else engine
    stamps = {}

    def stamp(req, tok):
        stamps.setdefault(req.rid, []).append(time.perf_counter())

    chat_reqs = [front.submit(p, GenerationConfig(max_new_tokens=64, temperature=0.0), seed=i,
                              on_token=stamp) for i, p in enumerate(chats)]
    while not all(r.tokens for r in chat_reqs):
        front.step()
    t_burst = time.perf_counter()
    doc_reqs = [front.submit(p, GenerationConfig(max_new_tokens=16, temperature=0.0), seed=100 + i)
                for i, p in enumerate(docs)]
    while front.has_work:
        front.step()
    fabric_done("5k(e) burst", model, chat_reqs + doc_reqs)
    tpot = [(r.finish_time - r.first_token_time) / (len(r.tokens) - 1) for r in chat_reqs]
    gaps = [max((b - a for a, b in zip(ts, ts[1:]) if a >= t_burst), default=0.0)
            for ts in (stamps[r.rid] for r in chat_reqs)]
    out = dict(p50=float(np.percentile(tpot, 50)), p99=float(np.percentile(tpot, 99)),
               gap99=float(np.percentile(gaps, 99)), captures=engine.decode_compilations)
    del engine, front
    collect_engines()
    return out


def fabric_disagg(model, paged: dict, smi: str) -> dict:
    """5k(e): disaggregated prefill on phase 5b's engine and 15 requests:
    a shared pool, then distinct pools; the staged pages against a coupled
    prefill's on the bf16 pool and on 5f(c)'s int8 pool; the coupled
    fallbacks under ``fail_handoff`` and a worker death; the TPOT burst."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector

    cfg = model.config
    layers = cfg.num_layers
    prompts, cfgs = paged_workload(cfg.vocab_size)
    shared = fabric_disagg_run(model, prompts, cfgs, True)
    distinct = fabric_disagg_run(model, prompts, cfgs, False)
    want_bytes = sum(-(-len(p) // PAGE) for p in prompts) * shared["page_nbytes"]
    for name, r in (("shared", shared), ("distinct", distinct)):
        st = r["stats"]
        if (st["prefills"], st["handoffs"], st["handoff_failures"], st["worker_failures"],
                st["coupled_fallbacks"]) != (len(prompts), len(prompts), 0, 0, 0) \
                or r["coupled"] != 0 or r["captures"] != 1:
            raise AssertionError(f"fabric 5k(e) {name}: stats {st}, coupled prefills "
                                 f"{r['coupled']}, captures {r['captures']}")
        if r["launches"]["flash_attention"] != st["prefills"] * layers:
            raise AssertionError(f"fabric 5k(e) {name}: K1 {r['launches']['flash_attention']} != "
                                 f"the worker's prefills {st['prefills']} x {layers}")
        k5 = r["launches"]["paged_flash_decode"] - r["warm"]["paged_flash_decode"]
        if k5 != r["snap"]["executed_steps"] * layers:
            raise AssertionError(f"fabric 5k(e) {name}: K5 {k5} != executed steps "
                                 f"{r['snap']['executed_steps']} x {layers}")
    if shared["copy_bytes"] != 0:
        raise AssertionError(f"fabric 5k(e): the shared pool copied {shared['copy_bytes']} bytes")
    if distinct["copy_bytes"] != distinct["exported"] or distinct["exported"] != want_bytes:
        raise AssertionError(f"fabric 5k(e): distinct pools copied {distinct['copy_bytes']} B, "
                             f"exported {distinct['exported']} B, the contexts' pages hold "
                             f"{want_bytes} B")
    if shared["tokens"] != distinct["tokens"]:
        raise AssertionError("fabric 5k(e): the shared and distinct pools' streams differ")
    worst = fabric_teacher("5k(e)", model, prompts, cfgs, shared["reqs"])
    same = sum(t == u for t, u in zip(shared["tokens"], paged["tokens"]))
    # the staged pages against a coupled prefill's: a chat turn, a document, and one more
    pick = [prompts[0], prompts[4], prompts[9]]
    bf16 = fabric_staged_vs_coupled(model, None, None, pick)
    qc = QuantConfig(weights="int8", kv="int8")
    d, hkv = cfg.head_dim_, cfg.num_kv_heads
    n_pages = paged["pool_pages"] * (2 * layers * PAGE * hkv * d * 2) \
        // (2 * layers * (PAGE * hkv * d + hkv * 2))
    int8 = fabric_staged_vs_coupled(model, qc, n_pages, pick)
    if (int8["per_replay"].get("qpaged_flash_decode") != layers
            or int8["per_replay"].get("qpaged_write_attend") != layers
            or "window_requantize" in int8["per_replay"]):
        raise AssertionError(f"fabric 5k(e): the int8 pool decoded with {int8['per_replay']}")
    # the coupled fallbacks: two failed handoffs, then a worker death
    few_p, few_c = prompts[:4], cfgs[:4]
    hinj = FaultInjector().fail_handoff(at=0, times=2)
    ho = fabric_disagg_run(model, few_p, few_c, True, injector=hinj)
    winj = FaultInjector().fail_prefill(at=0, times=None)
    wd = fabric_disagg_run(model, few_p, few_c, True, injector=winj)
    if (hinj.counters["handoff_failures"], ho["stats"]["handoff_failures"],
            ho["stats"]["coupled_fallbacks"], ho["coupled"]) != (2, 2, 2, 2):
        raise AssertionError(f"fabric 5k(e): fail_handoff x2 gave {ho['stats']}, injector "
                             f"{hinj.counters['handoff_failures']}, coupled {ho['coupled']}")
    if (winj.counters["prefill_failures"], wd["stats"]["worker_failures"], wd["workers"],
            wd["coupled"]) != (1, 1, 0, len(few_p)):
        raise AssertionError(f"fabric 5k(e): a worker death gave {wd['stats']}, workers "
                             f"{wd['workers']}, coupled {wd['coupled']}")
    for name, r, failed in (("fail_handoff", ho, 0), ("worker death", wd, 1)):
        ran = r["worker_calls"] - failed + r["coupled"]  # a failed worker call ran no kernel
        if r["launches"]["flash_attention"] != ran * layers:
            raise AssertionError(f"fabric 5k(e) {name}: K1 {r['launches']['flash_attention']} != "
                                 f"{ran} prefills x {layers}")
    burst_c = fabric_burst(model, False)
    burst_d = fabric_burst(model, True)
    launches = {k: sum(r["launches"][k] for r in (shared, distinct, bf16, int8, ho, wd))
                for k in shared["launches"]}
    ms = shared["walls"]["map_staged"]
    imp = distinct["walls"]["import_pages"]
    bound_s = 2 * distinct["exported"] / PEAK_BYTES  # each byte read once and written once
    log(f"fabric 5k(e) disaggregated prefill ({smi}; phase 5b's {PAGED_SLOTS}-slot paged engine "
        f"and 15 requests, 1 worker, prefills_per_step 1): shared pool: {len(prompts)} worker "
        f"prefills, {shared['stats']['handoffs']} page-table handoffs, copy_bytes 0; distinct "
        f"pools: copy_bytes {distinct['copy_bytes']} = the exported pages' bytes "
        f"({want_bytes // shared['page_nbytes']} pages x {shared['page_nbytes']} B); the two runs' "
        f"streams equal bit for bit; K1 {shared['launches']['flash_attention']} = worker prefills "
        f"x {layers}, K5 = executed steps x {layers} + the warm-up's; one capture, every page free "
        f"and check() clean after every step; teacher-forced gap {worst:.3g}x phase 3's limit; "
        f"streams equal to phase 5b's: {same} of {len(prompts)}")
    log(f"fabric 5k(e) staged pages = a coupled prefill's bit for bit: {bf16['pages']} pages of "
        f"three prompts ({', '.join(str(len(p)) for p in pick)} tokens) on the bf16 pool, "
        f"{int8['pages']} on 5f(c)'s int8 pool of {n_pages} pages (codes and scales; K5q "
        f"with the write {int8['per_replay']['qpaged_write_attend']} a replay after the handoff, "
        f"QW the prefills' writes alone)")
    log(f"fabric 5k(e) fallbacks: fail_handoff x2 -> 2 coupled prefills, counters "
        f"{ {k: ho['stats'][k] for k in ('handoffs', 'handoff_failures', 'coupled_fallbacks')} }; "
        f"a worker death -> worker_failures 1, no worker left, {wd['coupled']} coupled prefills; "
        f"streams DONE, every page free")
    log(f"fabric 5k(e) walls ({smi}): map_staged (the handoff) median "
        f"{1e3 * statistics.median(ms):.4f} ms over {len(ms)}; import_pages median "
        f"{1e3 * statistics.median(imp):.4f} ms over {len(imp)}, total {1e3 * sum(imp):.3f} ms for "
        f"{distinct['exported']} B against the bytes' bound {1e3 * bound_s:.3f} ms (read + write at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s)")
    log(f"fabric 5k(e) TPOT under a document burst ({smi}; {BURST_CHATS} chat decoders, then, "
        f"once all have their first token, {BURST_DOCS} documents of 2000-3000 tokens; wall "
        f"clock, reported, not gated): coupled p50 {1e3 * burst_c['p50']:.3f} ms p99 "
        f"{1e3 * burst_c['p99']:.3f} ms, longest wait between deliveries p99 "
        f"{1e3 * burst_c['gap99']:.3f} ms; disaggregated p50 {1e3 * burst_d['p50']:.3f} ms p99 "
        f"{1e3 * burst_d['p99']:.3f} ms, longest wait p99 {1e3 * burst_d['gap99']:.3f} ms")
    return dict(launches=launches, map_ms=1e3 * statistics.median(ms),
                import_ms=1e3 * sum(imp), import_bound_ms=1e3 * bound_s,
                tpot=(burst_c, burst_d))


def fabric_phase(model, srv: dict, paged: dict, smi: str) -> dict:
    """Phase 5k: the serving fabric at full width. (a) balancing and
    affinity, (b) halt and re-home on row replicas, (c) the watchdog over a
    chaos transport, (d) live join, drain and restart, (e) disaggregated
    prefill. (a), (c) and (d) are held to a CPU dry run of the same legs at
    tiny width (``fabric_dry_model``). Returns the phase's launches."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dry_model = fabric_dry_model(model)
    with fabric_dry_sampler():
        dry = {"a": fabric_affinity(dry_model, dry=True),
               "c": fabric_watchdog(dry_model, dry=True), "d": fabric_join(dry_model, dry=True)}
    del dry_model
    log(f"fabric 5k: the CPU dry runs of (a), (c), (d) (tiny width, the same vocabulary and "
        f"max_seq_len) in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    layers = model.config.num_layers
    a = fabric_affinity(model)
    if a["decisions"] != dry["a"]["decisions"]:
        raise AssertionError(f"fabric 5k(a): decisions {a['decisions']} != the dry run's "
                             f"{dry['a']['decisions']}")
    ad = a["decisions"]
    log(f"fabric 5k(a) balancing and affinity ({smi}; {FABRIC_REPLICAS} replicas of phase 5b's "
        f"paged engine over one module, prefix cache on; phase 5c's 12 sessions one at a time, "
        f"then phase 5b's 15 at once): routed {ad['routed']} = submitted, affinity hits "
        f"{ad['affinity_hits']}, routed by replica {ad['routed_by_replica']}, prefix hits "
        f"{ad['hits']} misses {ad['misses']} inserts {ad['inserts']} = the dry run's; K1 "
        f"{a['launches']['flash_attention']} = full prefills {a['full']} x {layers}; PF "
        f"{a['launches']['page_fingerprint']} = inserts {sum(ad['inserts'])} + paged hits "
        f"{a['hits']}; captures {a['captures']}; check() clean on every replica after every "
        f"step; teacher-forced gap {a['teacher']:.3g}x phase 3's limit; wall {a['wall_s']:.2f} s")
    b = fabric_rehome(model, srv)
    log(f"fabric 5k(b) halt and re-home ({smi}; {FABRIC_REPLICAS} replicas of phase 4's 8-slot "
        f"row engine, phase 4's 6 requests; replica 1's dispatches fail from its third, "
        f"{b['failures']} failures, HALTED): re-homed {b['rehomed']} = its unfinished requests, "
        f"tokens_lost 0 (every stream DONE, {b['pre']} pre-halt tokens kept exactly); survivors' "
        f"captures unchanged (one each, same buffers); K1 {b['launches']['flash_attention']} = "
        f"(admissions + re-admissions) {b['admissions']} x {layers}; K4 "
        f"{b['launches']['flash_decode']}; teacher-forced gap {b['teacher']:.3g}x phase 3's "
        f"limit; re-home wall {1e3 * b['rehome_s']:.3f} ms; streams equal to phase 4's "
        f"uninterrupted run: {b['same']} of 6")
    c = fabric_watchdog(model)
    if c["decisions"] != dry["c"]["decisions"]:
        raise AssertionError(f"fabric 5k(c): the probe states, transport or stats differ from the "
                             f"dry run's: {c['decisions']} against {dry['c']['decisions']}")
    log(f"fabric 5k(c) watchdog over a ChaosTransport ({smi}; (a)'s router, JAX's _chaos_faults "
        f"and replica {FABRIC_PARTITIONED} partitioned after the submissions, a virtual clock of "
        f"{FABRIC_STEP_DT} s a step, phase 5b's 15 requests): replica {FABRIC_PARTITIONED} walked "
        f"{' -> '.join(c['walk'])}, fenced, {c['rehomed']} requests re-homed; tokens_lost 0, no "
        f"rid admitted twice; probe states ({c['steps']} steps), transport "
        f"{c['decisions']['transport']} and injector counters = the dry run's; captures "
        f"{c['captures']}; teacher-forced gap {c['teacher']:.3g}x phase 3's limit")
    d = fabric_join(model)
    if d["decisions"] != dry["d"]["decisions"]:
        raise AssertionError(f"fabric 5k(d): {d['decisions']} != the dry run's {dry['d']['decisions']}")
    ds = d["decisions"]["stats"]
    log(f"fabric 5k(d) live join, drain and restart ({smi}; (c)'s configuration without the "
        f"partition, phase 5b's 15 requests queued): add_replica() -> replica "
        f"{d['decisions']['joined']}, rebalanced {ds['rebalanced_requests']} = the dry run's; "
        f"remove_replica(0) drained out (replicas_removed {ds['replicas_removed']}); replica 1 "
        f"fenced after two steps, restart_replica(1) -> replica {d['decisions']['new']} restored "
        f"{d['restored']} live requests, every stream DONE with its pre-kill tokens; "
        f"router_restart_latency_s {d['restart_s']:.4f} s; captures {d['captures']}; "
        f"teacher-forced gap {d['teacher']:.3g}x phase 3's limit")
    e = fabric_disagg(model, paged, smi)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak > 72:
        raise AssertionError(f"fabric 5k: peak memory {peak:.1f} GiB over 72")
    legs = (a, b, c, d, e)
    launches = {k: sum(x["launches"][k] for x in legs) for k in a["launches"]}
    log(f"fabric phase launches (replays included): {launches}; peak mem {peak:.1f} GiB")
    log(f"phase 5k wall: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# --- phase 2 (TF): the tree fingerprint --------------------------------------------


def check_tf(model) -> dict:
    """TF (``csrc/tree_fingerprint.cu``) on the full bf16 Llama-3-8B
    weights (the engine's integrity leaves) and on phase 5f(a)'s int8
    engine's tensors (codes, scales, embedding, norms): bitwise = its plain
    version (which runs on the card, a chunk at a time); a flipped bit and a
    swap of two elements each move it (both undone after); timed as a
    CUDA-graph replay against its bytes bound, the plain version beside. No
    single PyTorch call computes it (no library time)."""
    from neuronx_distributed_tpu_torch.integrity.chaos import flip_leaf_bit
    from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import (
        TreeFingerprint,
        tree_fingerprint_plain,
    )
    from neuronx_distributed_tpu_torch.models.llama import quantize_model
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.serving.engine import _weight_leaves

    res = {}
    qmodel = None
    for kind in ("bf16", "int8"):
        if kind == "int8":
            qmodel = quantize_model(model, QuantConfig(weights="int8").weight_qconfig())
        leaves = _weight_leaves(model if kind == "bf16" else qmodel)
        prog = TreeFingerprint(leaves)
        got = int(prog())
        want = int(tree_fingerprint_plain(leaves))
        if got != want:
            raise AssertionError(f"TF ({kind}) {got:#010x} != its plain version {want:#010x}")
        big = max(leaves, key=lambda t: t.numel())
        flip_leaf_bit(big, byte_index=big.numel() * big.element_size() // 3)
        flipped = int(prog())
        flip_leaf_bit(big, byte_index=big.numel() * big.element_size() // 3)
        flat = big.view(-1)
        i, j = flat.numel() // 2, flat.numel() // 2 + 4097
        a, b = flat[i].clone(), flat[j].clone()
        if torch.equal(a, b):
            raise AssertionError(f"TF ({kind}): the swap's elements are equal; pick others")
        flat[i], flat[j] = b, a
        swapped = int(prog())
        flat[i], flat[j] = a, b
        if int(prog()) != got or flipped == got or swapped == got:
            raise AssertionError(f"TF ({kind}): restored {int(prog()):#010x} vs {got:#010x}, "
                                 f"flipped {flipped:#010x}, swapped {swapped:#010x}")
        nbytes = prog.nbytes + 8
        res[kind] = dict(ms=graph_ms(prog, 3, replays=3),
                         plain_ms=cuda_ms(lambda: tree_fingerprint_plain(leaves), 1, warmup=1),
                         bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes", bytes=nbytes,
                         leaves=len(leaves), value=got)
        del prog, leaves
    del qmodel
    torch.cuda.empty_cache()
    return res


# --- phase 5l: integrity and program observability -----------------------------------

INTEGRITY_REPLICAS = 3    # 5l(a)'s vote: own-weight int8 replicas (each owns its tensors)
INTEGRITY_DT = 0.6        # virtual seconds a router step; the vote every 0.5 s, so every step
INTEGRITY_SLOTS = 4       # a replica's row slots (4 x 1.07 GB of K/V at 8192 columns)
INTEGRITY_EVENTS = ("integrity_disagreement", "integrity_conviction", "rehome")


def integrity_run(model, workload, replicas: int, flip_at, dry: bool = False) -> dict:
    """5l(a): ``replicas`` int8 replicas (phase 5f(a)'s engine with row
    slots; quantized replicas own their weights, the vote's condition)
    under ``WatchdogConfig(integrity_interval_s=0.5)`` on a virtual clock,
    phase 4's six requests, ``flip_bits("params", at=flip_at)`` on replica 0
    (None: the clean control). Returns the decisions (stats, probe-state
    walk, the replicas' integrity flight events, the injector's counters),
    checked against the CPU dry run's by the caller."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.serving.engine import EngineHealth
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
    from neuronx_distributed_tpu_torch.serving.router import ReplicaRouter, WatchdogConfig
    from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock

    prompts, cfgs = workload
    clock = VirtualClock()
    router = ReplicaRouter.build(model, replicas, time_fn=clock, num_slots=INTEGRITY_SLOTS,
                                 decode_chunk_size=8, prefix_cache=None,
                                 quantize=QuantConfig(weights="int8"),
                                 watchdog=WatchdogConfig(integrity_interval_s=0.5))
    inj = FaultInjector()
    if flip_at is not None:
        inj.flip_bits("params", at=flip_at)
        router.replicas[0]._faults = inj
    counters = fabric_zero(model)
    reqs = [router.submit(p, c, seed=j) for j, (p, c) in enumerate(zip(prompts, cfgs))]
    seq, pre, probe_s = [tuple(router.probe_states().values())], None, []
    victim = router.replicas[0]
    while router.has_work:
        before = {r.rid: list(r.tokens) for r in victim.scheduler.requests.values()
                  if not r.finished}
        router.step()
        fabric_sync(model)
        seq.append(tuple(router.probe_states().values()))
        if pre is None and victim.health() is EngineHealth.HALTED:
            pre = before
        clock.advance(INTEGRITY_DT)
    fabric_sync(model)
    launches = fabric_launches(router.replicas, counters)
    fabric_done("5l(a)", model, reqs)
    events = [[(e["kind"], e.get("replica")) for e in r.flight.events()
               if e["kind"] in INTEGRITY_EVENTS] for r in router.replicas]
    walk = [s[0] for i, s in enumerate(seq) if i == 0 or s[0] != seq[i - 1][0]]
    decisions = dict(stats=dict(router.stats), walk=walk, events=events,
                     counters={k: v for k, v in inj.counters.items() if v},
                     routed_by_replica=list(router.routed_by_replica))
    if dry:
        return dict(decisions=decisions)
    lost = ([rid for rid, toks in pre.items() if router.requests[rid].tokens[:len(toks)] != toks]
            if pre is not None else [])
    survivor = router.replicas[-1]
    for _ in range(3):  # a probe's wall: TF over the int8 weights and its 8-byte read
        fabric_sync(model)
        t0 = time.perf_counter()
        survivor.integrity_fingerprint()
        probe_s.append(time.perf_counter() - t0)
    teacher = fabric_teacher("5l(a)", survivor.model, prompts, cfgs, reqs)
    out = dict(decisions=decisions, launches=launches, lost=lost,
               rehomed=router.stats["rehomed_requests"], pre=sum(map(len, (pre or {}).values())),
               teacher=teacher, probe_ms=1e3 * min(probe_s),
               weight_gb=sum(t.numel() * t.element_size()
                             for t in survivor.integrity_leaves()) / 1e9)
    del router, victim, survivor
    collect_engines()
    return out


def integrity_schedules():
    """5l(a)'s three schedules: (replicas, the flip's step or None)."""
    return {"vote": (INTEGRITY_REPLICAS, 1), "clean": (INTEGRITY_REPLICAS, None),
            "pair": (2, 0)}


def ledger_leg(model, workload, fused: dict) -> dict:
    """5l(b): phase 5b's paged engine with ``program_ledger=`` (a ledger of
    the caller's): decode-chunk dispatches = replays = executed steps, one
    capture; the decode step's metered FLOPs a dispatch = the analytic
    ``2 x linear weights x 16 slots + 4 x 16 x 32 heads x 8192 columns x
    128 x 32 layers`` (relative 1e-9: sums of integers in float64); MFU
    per program; host reads = the fixed budget of one read a chunk plus
    each request's first token (every request is fresh: no prefix cache);
    every token = phase 5b's run's (the engine's own default ledger) bit
    for bit. The eager programs (prefills, first token, slot write and
    clear) run unmetered inside the requests; a fresh engine's prewarm on
    the same ledger then meters each of them once, their dispatches and
    compiles unchanged."""
    from neuronx_distributed_tpu_torch.inference.aot import ProgramManifest
    from neuronx_distributed_tpu_torch.observability.programs import UNAVAILABLE, ProgramLedger
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    ledger = ProgramLedger()
    r = serve_paged(model, workload, "fused", program_ledger=ledger)
    by = ledger.snapshot()["by_program"]
    dc = by["decode_chunk"]
    executed = r["snap"]["executed_steps"]
    if (dc["dispatches"], dc["compiles"], r["replays"]) != (executed, 1, executed):
        raise AssertionError(f"ledger 5l(b): decode_chunk dispatches {dc['dispatches']}, compiles "
                             f"{dc['compiles']}, replays {r['replays']}; executed {executed}")
    cfg = model.config
    want = decode_step_flops(cfg, PAGED_SLOTS, cfg.max_seq_len)
    if abs(dc["flops_per_dispatch"] - want) > 1e-9 * want:
        raise AssertionError(f"ledger 5l(b): decode step {dc['flops_per_dispatch']} FLOPs != the "
                             f"analytic {want}")
    budget = r["snap"]["chunks"] + len(r["tokens"])
    if r["tokens"] != fused["tokens"] or r["host_reads"] != budget:
        raise AssertionError(f"ledger 5l(b): tokens equal {r['tokens'] == fused['tokens']}, host "
                             f"reads {r['host_reads']} != chunks {r['snap']['chunks']} + first "
                             f"tokens {len(r['tokens'])}")
    prefills = sum(e["dispatches"] for n, e in by.items() if n.startswith("prefill["))
    if prefills != r["snap"]["prefills"]:
        raise AssertionError(f"ledger 5l(b): {prefills} prefill dispatches != "
                             f"{r['snap']['prefills']} prefills")
    # the eager programs ran unmetered inside the requests; a fresh engine of
    # the same geometry on the same ledger replays them once under its
    # prewarm, which meters each recorded variant off the request path
    unmetered = sorted(n for n, e in by.items()
                       if e["dispatches"] and e["flops_per_dispatch"] == UNAVAILABLE)
    if "decode_chunk" in unmetered or not any(n.startswith("prefill[") for n in unmetered):
        raise AssertionError(f"ledger 5l(b): unmetered after the run {unmetered}")
    shadow = ServingEngine(model, num_slots=PAGED_SLOTS, decode_chunk_size=8, kv_page_size=PAGE,
                           kv_num_pages=ROW_SLOTS * cfg.max_seq_len // PAGE + 1,
                           prefix_cache=None, program_ledger=ledger)
    rep = shadow.prewarm(manifest=ProgramManifest.from_ledger(ledger, names=unmetered))
    del shadow
    after = ledger.snapshot()["by_program"]
    if sorted(rep["replayed"]) != unmetered or rep["failed"] or rep["skipped"] or any(
            after[n]["dispatches"] != by[n]["dispatches"] or after[n]["compiles"] != by[n]["compiles"]
            or after[n]["cost_source"] != "prewarm dispatch" for n in unmetered):
        raise AssertionError(f"ledger 5l(b): the metering prewarm {rep}")
    by = after
    mfu = {n: e.get("mfu_p50") for n, e in by.items() if e["dispatches"]}
    return dict(launches=r["launches"], decode=dc, want=want, mfu=mfu, executed=executed,
                table=ledger.table(), host_reads=r["host_reads"], prefills=prefills,
                chunks=r["snap"]["chunks"], requests=len(r["tokens"]), metered=unmetered,
                prewarm_s=rep["wall_s"])


def decode_step_flops(cfg, slots: int, cols: int) -> float:
    """The analytic decode step: 2 x in x out a slot for every linear (q,
    k, v, o, gate, up, down, lm_head) and 4 x heads x columns x head_dim a
    slot and layer of attention over every column the kernel is handed."""
    hd = cfg.head_dim_
    per_layer = (cfg.hidden_size * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                 + cfg.num_heads * hd * cfg.hidden_size
                 + 3 * cfg.hidden_size * cfg.intermediate_size)
    weights = cfg.num_layers * per_layer + cfg.hidden_size * cfg.vocab_size
    return 2.0 * weights * slots + 4.0 * slots * cfg.num_heads * cols * hd * cfg.num_layers


def profiler_leg(model, srv: dict) -> dict:
    """5l(c): phase 4's engine with ``profile_dir=`` (a temporary
    directory): the Chrome trace exists, holds 2 K4 records (range kernel
    and merge) a layer and executed step of chunks 2, 3 and 4 and none of
    the others; the streams = phase 4's; ``record_device_memory``'s gauges
    agree with ``torch.cuda.mem_get_info``. The profiler can lose a kernel
    record (one of 1024 K4 records in one run on an H100 80GB HBM3), so the
    count is held to at most the window's and to more than the window's
    less one chunk's: a window one chunk early or late still fails."""
    import tempfile

    from neuronx_distributed_tpu_torch.observability.profiler import TRACE_NAME, record_device_memory
    from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    prompts, cfgs = srv["workload"]
    with tempfile.TemporaryDirectory() as d:
        engine = ServingEngine(model, num_slots=8, decode_chunk_size=8, prefix_cache=None,
                               profile_dir=d)
        reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
        in_window = 0
        while engine.has_work:
            chunks, executed = engine.metrics.chunks, engine.metrics.executed_steps
            engine.step()
            if 2 <= chunks < 5 and engine.metrics.chunks > chunks:
                in_window += engine.metrics.executed_steps - executed
        torch.cuda.synchronize()
        path = os.path.join(d, TRACE_NAME)
        with open(path) as f:
            trace = json.load(f)
        size = os.path.getsize(path)
    kernels = [ev["name"] for ev in trace["traceEvents"] if ev.get("cat") == "kernel"]
    k4 = sum("flash_decode_kernel" in n and "paged" not in n for n in kernels)
    layers = model.config.num_layers
    want, chunk = 2 * in_window * layers, 2 * engine.decode_chunk_size * layers
    if not want - chunk < k4 <= want or in_window == 0:
        raise AssertionError(f"profiler 5l(c): {k4} K4 records in the trace, not in ({want - chunk}, "
                             f"{want}]: 2 x {in_window} executed steps of chunks [2, 5) x {layers}, "
                             "less under one chunk's")
    tokens = [list(r.tokens) for r in reqs]
    if tokens != srv["tokens"]:
        raise AssertionError("profiler 5l(c): streams differ from phase 4's")
    reg = MetricsRegistry()
    n = record_device_memory(reg)
    free, total = torch.cuda.mem_get_info(0)
    got_free = reg.get("device0_bytes_free").value
    if n != torch.cuda.device_count() or reg.get("device0_bytes_limit").value != total \
            or abs(got_free - free) > 64 << 20:
        raise AssertionError(f"profiler 5l(c): record_device_memory {n} devices, limit "
                             f"{reg.get('device0_bytes_limit').value} vs {total}, free "
                             f"{got_free} vs {free}")
    del engine
    collect_engines()
    return dict(k4=k4, want=want, in_window=in_window, kernels=len(kernels), trace_bytes=size,
                in_use=reg.get("device0_bytes_in_use").value,
                utilization=reg.get("device0_memory_utilization").value)


def warm_spawn_leg(model, srv: dict) -> dict:
    """5l(d): a router of two phase-4 row replicas over the one module
    serves phase 4's six requests; replica 0's bundle (``save_aot``: its
    manifest and the process's kernel libraries) goes to a temporary
    ``cache_dir``. ``restart_replica(1, cache_dir=)`` and
    ``add_replica(manifest=, cache_dir=)`` prewarm their replicas: every
    manifest program replayed (``last_prewarm``), the kernels loaded from
    ``cache_dir`` (no build). Each warm replica's first request (phase 4's 3000-token prompt)
    then captures nothing and builds nothing; its TTFT and first step's
    wall are printed against a cold replica's (``add_replica()``), whose
    first step captures the decode graph. The warm and cold streams equal."""
    import tempfile

    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.serving.router import ReplicaRouter

    prompts, cfgs = srv["workload"]
    router = ReplicaRouter.build(model, 2, num_slots=8, decode_chunk_size=8, prefix_cache=None)
    reqs = [router.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
    router.run()
    fabric_done("5l(d) donor", model, reqs)
    donor = router.replicas[0]
    out, reports = {}, {}
    with tempfile.TemporaryDirectory() as d:
        bundle = donor.save_aot(d)
        manifest = donor.manifest()
        names = sorted(n for n in manifest.names() if manifest.entries(n))
        t0 = time.perf_counter()
        restarted = router.restart_replica(1, cache_dir=d)
        reports["restart"] = (restarted, time.perf_counter() - t0)
        t0 = time.perf_counter()
        added = router.add_replica(manifest=manifest, cache_dir=d, adopt_backlog=False)
        reports["add"] = (added, time.perf_counter() - t0)
        cold = router.add_replica(adopt_backlog=False)
        for what, i in (("restart", restarted), ("add", added), ("cold", cold)):
            e = router.replicas[i]
            if what != "cold":
                rep = e.last_prewarm
                if (sorted(rep["replayed"]) != names or rep["skipped"] or rep["failed"]
                        or rep["deserialized"]
                        or sorted(rep["kernels_cached"]) != sorted(manifest.meta["kernels"])):
                    raise AssertionError(f"warm spawn 5l(d) {what}: replayed {rep['replayed']} of "
                                         f"{names}, skipped {rep['skipped']}, failed "
                                         f"{rep['failed']}, kernels cached {rep['kernels_cached']}")
            compiles = {n: p.compiles for n, p in e.programs.programs().items()}
            captures, builds = e.decode_compilations, _build.stats["builds"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            req = e.submit(prompts[-1], cfgs[-1], seed=99)
            e.step()
            torch.cuda.synchronize()
            first_step = time.perf_counter() - t1
            e.run()
            torch.cuda.synchronize()
            out[what] = dict(ttft_s=req.first_token_time - req.submit_time, first_step_s=first_step,
                             new_captures=e.decode_compilations - captures,
                             new_builds=_build.stats["builds"] - builds,
                             new_compiles={n: p.compiles - compiles.get(n, 0)
                                           for n, p in e.programs.programs().items()
                                           if p.compiles != compiles.get(n, 0)},
                             tokens=list(req.tokens), wall_s=reports.get(what, (0, 0.0))[1])
        out["process"] = fresh_process_spawn(d, prompts[-1], model.config)
    cold_r = out["cold"]
    for what in ("restart", "add"):
        warm = out[what]
        if warm["new_captures"] or warm["new_builds"] or warm["new_compiles"]:
            raise AssertionError(f"warm spawn 5l(d) {what}: the first request captured "
                                 f"{warm['new_captures']}, built {warm['new_builds']}, compiled "
                                 f"{warm['new_compiles']}")
        if warm["tokens"] != cold_r["tokens"]:
            raise AssertionError(f"warm spawn 5l(d) {what}: its stream differs from the cold "
                                 "replica's")
    if cold_r["new_captures"] != 1:
        raise AssertionError(f"warm spawn 5l(d): the cold replica captured "
                             f"{cold_r['new_captures']} (want 1)")
    del router, donor
    collect_engines()
    return dict(out, names=names, kernels=bundle["kernels"])


FRESH_SPAWN = r"""
import json, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import dataclasses, numpy as np, torch
from neuronx_distributed_tpu_torch.kernels import _build
_build.BUILD_DIR = tempfile.mkdtemp()  # an empty build directory: nothing built here yet
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
cfg = LlamaConfig(**{k: getattr(torch, v) if k in ("dtype", "param_dtype") else v
                     for k, v in json.loads(sys.argv[3]).items()})
dev = "cuda" if torch.cuda.is_available() else "cpu"
model = init_params(LlamaForCausalLM(cfg, device=dev), seed=0)
engine = ServingEngine(model, num_slots=8, decode_chunk_size=8, prefix_cache=None)
t0 = time.perf_counter()
rep = engine.prewarm(cache_dir=sys.argv[2])
prewarm_s = time.perf_counter() - t0
builds, captures = _build.stats["builds"], engine.decode_compilations
compiles = {n: p.compiles for n, p in engine.programs.programs().items()}
prompt = np.array(json.loads(sys.argv[4]))
t1 = time.perf_counter()
req = engine.submit(prompt, GenerationConfig(max_new_tokens=32, temperature=0.0), seed=99)
engine.step()
if dev == "cuda":
    torch.cuda.synchronize()
first_step = time.perf_counter() - t1
engine.run()
print(json.dumps(dict(replayed=sorted(rep["replayed"]), skipped=rep["skipped"], failed=rep["failed"],
                      cached=sorted(rep["kernels_cached"]), prewarm_s=prewarm_s,
                      builds=_build.stats["builds"], builds_at_prewarm=builds,
                      new_captures=engine.decode_compilations - captures,
                      new_compiles=sum(p.compiles for p in engine.programs.programs().values())
                      - sum(compiles.values()), ttft_s=req.first_token_time - req.submit_time,
                      first_step_s=first_step, tokens=len(req.tokens))))
"""


def fresh_process_spawn(cache_dir: str, prompt, cfg) -> dict:
    """5l(d)'s last leg: a FRESH process whose kernel build directory is
    empty prewarms a row engine (2 layers of the same width: the manifest
    and the libraries do not depend on depth) from ``cache_dir`` alone:
    every library loaded from there, no ``nvcc`` run, every manifest
    program replayed, then a request served with no capture, build or
    compile. Returns the process's report (its TTFT, first step, prewarm
    wall)."""
    import dataclasses

    small = dataclasses.asdict(dataclasses.replace(cfg, num_layers=2))
    small = {k: (str(v).replace("torch.", "") if isinstance(v, torch.dtype) else v)
             for k, v in small.items()}
    out = subprocess.run([sys.executable, "-c", FRESH_SPAWN, os.path.dirname(os.path.abspath(
        __file__)), cache_dir, json.dumps(small), json.dumps([int(t) for t in prompt])],
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"warm spawn 5l(d): the fresh process failed:\n{out.stderr[-3000:]}")
    from neuronx_distributed_tpu_torch.inference.aot import ProgramManifest

    rep = json.loads(out.stdout.strip().splitlines()[-1])
    want = sorted(ProgramManifest.load(cache_dir).meta["kernels"])
    if rep["builds"] or rep["new_captures"] or rep["new_compiles"] or rep["skipped"] \
            or rep["failed"] or rep["tokens"] != 32 or rep["cached"] != want:
        raise AssertionError(f"warm spawn 5l(d): the fresh process {rep}")
    return rep


def integrity_phase(model, srv: dict, fused: dict, smi: str) -> dict:
    """Phase 5l: integrity and program observability at full width. (a)
    the cross-replica vote (three schedules, each = its CPU dry run at tiny
    width), (b) the program ledger, (c) the profiler window and device
    memory gauges, (d) the warm spawn. Returns the phase's launches."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig  # noqa: F401

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    workload = srv["workload"]
    t0 = time.perf_counter()
    dry_model = fabric_dry_model(model)
    with fabric_dry_sampler():
        dry = {k: integrity_run(dry_model, workload, n, at, dry=True)["decisions"]
               for k, (n, at) in integrity_schedules().items()}
    del dry_model
    log(f"integrity 5l: the CPU dry runs of (a)'s three schedules (tiny width, int8, the same "
        f"vocabulary and max_seq_len) in {time.perf_counter() - t0:.2f} s")
    runs = {}
    for k, (n, at) in integrity_schedules().items():
        runs[k] = integrity_run(model, workload, n, at)
        if runs[k]["decisions"] != dry[k]:
            raise AssertionError(f"integrity 5l(a) {k}: {runs[k]['decisions']} != the dry run's "
                                 f"{dry[k]}")
    v, c, p = runs["vote"], runs["clean"], runs["pair"]
    vs, cs, ps = v["decisions"]["stats"], c["decisions"]["stats"], p["decisions"]["stats"]
    if (vs["integrity_fences"], vs["integrity_disagreements"], v["decisions"]["walk"]) != \
            (1, 0, ["ok", "dead"]) or v["lost"] or v["rehomed"] < 1:
        raise AssertionError(f"integrity 5l(a): fences {vs['integrity_fences']}, disagreements "
                             f"{vs['integrity_disagreements']}, walk {v['decisions']['walk']}, "
                             f"streams that lost tokens {v['lost']}, re-homed {v['rehomed']}")
    if cs["integrity_fences"] or cs["integrity_disagreements"]:
        raise AssertionError(f"integrity 5l(a) clean control: {cs}")
    if ps["integrity_fences"] or ps["integrity_disagreements"] < 1:
        raise AssertionError(f"integrity 5l(a) two replicas: {ps}")
    log(f"integrity 5l(a) the vote ({smi}; {INTEGRITY_REPLICAS} replicas of phase 5f(a)'s int8 "
        f"engine with {INTEGRITY_SLOTS} row slots each, each owning its {v['weight_gb']:.3f} GB "
        f"of weights; WatchdogConfig(integrity_interval_s=0.5), {INTEGRITY_DT} virtual s a step; "
        f"phase 4's six requests; flip_bits('params', at=1) on replica 0): replica 0 walked "
        f"{' -> '.join(v['decisions']['walk'])} at the first vote after the flip, fenced, "
        f"{v['rehomed']} requests re-homed, tokens_lost 0 ({v['pre']} pre-conviction tokens kept "
        f"exactly), every request DONE with 32 tokens; integrity_probes "
        f"{vs['integrity_probes']}, fences {vs['integrity_fences']}, flight events "
        f"{v['decisions']['events']} = the dry run's; clean control: probes "
        f"{cs['integrity_probes']}, no disagreement, no fence; two replicas, flip at 0: "
        f"disagreements {ps['integrity_disagreements']} (one a vote after the flip), no fence; "
        f"a probe's wall (TF over "
        f"{v['weight_gb']:.3f} GB and its 8-byte read) {v['probe_ms']:.3f} ms; teacher-forced gap "
        f"(int8 teacher) {v['teacher']:.3g} / {c['teacher']:.3g} / {p['teacher']:.3g}x phase 3's "
        f"limit")
    b = ledger_leg(model, paged_workload(model.config.vocab_size), fused)
    dc = b["decode"]
    log(f"ledger 5l(b) ({smi}; phase 5b's paged engine, program_ledger=): decode_chunk "
        f"dispatches {dc['dispatches']} = replays = executed steps {b['executed']}, compiles "
        f"{dc['compiles']} (the capture), {dc['flops_per_dispatch']:.6g} FLOPs a dispatch = the "
        f"analytic {b['want']:.6g} (16 slots x 2 x the linear weights + attention over 8192 "
        f"columns), {dc['bytes_per_dispatch']:.6g} bytes, kernels a step {dc['kernels']}; "
        f"prefill dispatches {b['prefills']} = prefills; host reads {b['host_reads']} = chunks "
        f"{b['chunks']} + first tokens {b['requests']}; every token = phase 5b's run; MFU p50 by "
        f"program (datasheet peak) "
        + json.dumps({k: (round(x, 6) if isinstance(x, float) else x) for k, x in b["mfu"].items()}))
    log(f"ledger 5l(b): metered by a second engine's prewarm on the same ledger, "
        f"{b['prewarm_s']:.3f} s: {b['metered']}")
    for line in b["table"].splitlines():
        log(f"ledger 5l(b) table: {line}")
    cl = profiler_leg(model, srv)
    log(f"profiler 5l(c) ({smi}; phase 4's engine, profile_dir=): the Chrome trace "
        f"({cl['trace_bytes']} B, {cl['kernels']} kernel records) holds {cl['k4']} K4 records of "
        f"the window's {cl['want']} (2 x {cl['in_window']} executed steps of chunks [2, 5) x 32; "
        f"{cl['want'] - cl['k4']} lost by the profiler), none outside; streams = phase "
        f"4's; record_device_memory: in use {cl['in_use']} B, utilization "
        f"{cl['utilization']:.4f}, limit and free = mem_get_info")
    d = warm_spawn_leg(model, srv)
    log(f"warm spawn 5l(d) ({smi}; two phase-4 row replicas over one module; the donor's "
        f"manifest ({len(d['names'])} programs: {d['names']}) and kernel libraries "
        f"{d['kernels']}): restart_replica(1, cache_dir=) in {d['restart']['wall_s']:.3f} s and "
        f"add_replica(manifest=, cache_dir=) in {d['add']['wall_s']:.3f} s, every program "
        f"replayed, every library loaded from cache_dir; their first request (3000 tokens): no "
        f"capture, no build, no compile, TTFT {d['restart']['ttft_s']:.4f} / "
        f"{d['add']['ttft_s']:.4f} s, first step {d['restart']['first_step_s']:.4f} / "
        f"{d['add']['first_step_s']:.4f} s; a cold replica's (add_replica()): TTFT "
        f"{d['cold']['ttft_s']:.4f} s, first step {d['cold']['first_step_s']:.4f} s (its capture "
        f"in it); streams equal")
    fp = d["process"]
    log(f"warm spawn 5l(d) fresh process ({smi}; an empty build directory, 2 layers of the width): "
        f"prewarm(cache_dir=) {fp['prewarm_s']:.3f} s, libraries loaded from cache_dir "
        f"{fp['cached']}, nvcc runs {fp['builds']}, programs replayed {fp['replayed']}; its first "
        f"request (3000 tokens): no capture, no compile, TTFT {fp['ttft_s']:.4f} s, first step "
        f"{fp['first_step_s']:.4f} s")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak > 72:
        raise AssertionError(f"integrity 5l: peak memory {peak:.1f} GiB over 72")
    launches = {k: sum(x["launches"][k] for x in (v, c, p, b)) for k in v["launches"]}
    log(f"phase 5l launches (replays included; (c) and (d) not counted): {launches}; peak mem "
        f"{peak:.1f} GiB")
    log(f"phase 5l wall: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# --- phases 6-7: training ------------------------------------------------------

EOS_ID = 128001  # Llama-3's <|end_of_text|>


def packed_batch(vocab: int, b: int, s: int, seed: int = 0, eos: int = EOS_ID) -> dict:
    """``b`` windows of ``s`` tokens from ``pack_documents`` over random
    documents of 200..3000 tokens with an ``eos`` separator: ids, labels,
    segment ids and the boundary loss mask (as ``PackedCorpus`` emits)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.trainer.data import pack_documents

    rng = np.random.default_rng(seed)
    docs, n = [], 0
    while n < b * (s + 1):
        docs.append(rng.integers(1, vocab - 1, size=int(rng.integers(200, 3001))))
        n += len(docs[-1]) + 1
    windows, segs = pack_documents(docs, s, eos, return_segments=True)
    w, g = windows[:b], segs[:b]
    return {"input_ids": w[:, :-1], "labels": w[:, 1:], "segment_ids": g[:, :-1],
            "loss_mask": (g[:, :-1] == g[:, 1:]).astype(np.float32)}


def kernel_counters():
    """The kernel wrappers that count their launches, by name: the
    checkout's own list (``inference/graphs.py kernel_wrappers``), so
    ``chip_decode_ab.py`` can drive an older checkout through this file."""
    from neuronx_distributed_tpu_torch.inference.graphs import kernel_wrappers

    return kernel_wrappers()


def train_vs_plain() -> dict:
    """One step's loss and gradients of a 2-layer llama3_8b-width model at
    S=1024 through the kernels, and with the plain versions swapped in."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b
    from neuronx_distributed_tpu_torch.parallel.grads import global_grad_norm
    from neuronx_distributed_tpu_torch.trainer.trainer import _to_device, default_loss_fn

    model = init_params(LlamaForCausalLM(llama3_8b(num_layers=2), trainable=True), seed=1)
    batch = _to_device(packed_batch(model.config.vocab_size, 2, 1024, seed=1), model.device)
    watched = [n for n, _ in model.named_parameters() if ".attn.qkv." in n]
    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        with plain_attention() if plain else contextlib.nullcontext():
            loss = default_loss_fn(model, batch)
            loss.backward()
        grads = dict(model.named_parameters())
        runs.append((float(loss.detach()), float(global_grad_norm([p.grad for p in model.parameters()])),
                     {n: grads[n].grad.clone() for n in watched}))
    (lk, nk, gk), (lp, np_, gp) = runs
    rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm()) for n in watched}
    out = dict(loss=lk, loss_rel=abs(lk - lp) / abs(lp), gnorm_rel=abs(nk - np_) / np_,
               qkv_grad_rel=max(rel.values()), qkv_grad_worst=max(rel, key=rel.get))
    del model, runs, gk, gp
    torch.cuda.empty_cache()
    # bf16 model: K1 rounds P, K2/K3 round P and dS to bf16 where the plain
    # path keeps f32 (~2^-9 relative per term); the q/k/v projection
    # gradients are the ones that attention's backward alone produces
    if not (out["loss_rel"] <= 1e-3 and out["gnorm_rel"] <= 1e-2 and out["qkv_grad_rel"] <= 2e-2):
        raise AssertionError(f"training: kernel path vs plain path: {out}")
    return out


def train_phase(steps: int = 6) -> dict:
    """Llama-3-8B width at 8 layers, fp32 masters, AdamW (lr 1e-3, weight
    decay 0.1, clip 1.0), remat on: ``steps`` steps on one packed batch."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b
    from neuronx_distributed_tpu_torch.trainer import (
        OptimizerConfig,
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    cfg = llama3_8b(num_layers=8)
    b, s = 2, 4096
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, trainable=True)
    opt_cfg = OptimizerConfig(learning_rate=1e-3, weight_decay=0.1, max_grad_norm=1.0)
    optimizer = make_optimizer(opt_cfg)
    state = create_train_state(model, optimizer, seed=0)
    step = build_train_step(model, optimizer, max_grad_norm=opt_cfg.max_grad_norm)
    batch = packed_batch(cfg.vocab_size, b, s)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    losses, walls = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(counters, 0)  # no serving kernel
    want.update(flash_attention=2 * cfg.num_layers * steps,
                flash_attention_dkdv=cfg.num_layers * steps,
                flash_attention_dq=cfg.num_layers * steps)
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: {losses}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    fams = device_time_by_family(prof, {"flash_attention": "flash_fwd_kernel",
                                        "flash_attention_dkdv": "flash_dkdv_kernel",
                                        "flash_attention_dq": "flash_dq_kernel"})
    seg = torch.from_numpy(batch["segment_ids"]).cuda()
    pairs = live_pairs(seg, b, s, seg.device)
    d, h = cfg.head_dim_, cfg.num_heads
    embed = model.model.embed.weight.numel()
    # model FLOPs: 6 per matmul parameter per token (fwd + bwd; the embedding
    # lookup has none) and attention's two products, 4*D*H per live pair
    # forward, 3x that with the backward; the remat recompute is not counted
    flops = 6.0 * (n_params - embed) * b * s + 12.0 * d * h * pairs * cfg.num_layers
    wall = statistics.median(walls[1:])
    del state, step, model, optimizer
    torch.cuda.empty_cache()
    return dict(losses=losses, walls=walls, wall=wall, tokens_per_s=b * s / wall,
                flops=flops, mfu=flops / wall / PEAK_BF16_FLOPS, peak_gib=peak / 2**30,
                launches=launches, fams=fams, n_params=n_params, init_s=init_s,
                pairs=pairs, docs=int(seg.max()) + 1)


# --- phase 7b: the training loop ------------------------------------------------

LOOP_LAYERS = 2     # depth cut: Llama-3-8B width, 2 layers (1,486,901,248 parameters)
LOOP_STEPS = 8
LOOP_EVERY = 4      # the checkpoint and sentinel cadence
LOOP_SEQ = 4096
LOOP_DATA_SEED = 1000
LOOP_LR = 3e-4      # OptimizerConfig's default (JAX's)
LOOP_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase7b_ckpt")
LOOP_SCHEDULE = "nan_loss(at=1), fail_dispatch(at=3), spike_grads(at=4), deliver_sigterm(at=6)"


class PackedSource:
    """Phase 7's packed batches from a seed (batch ``i`` from seed
    ``LOOP_DATA_SEED + i``), with the ``state()``/``restore()`` cursor the
    loop's exact resume reads."""

    def __init__(self, vocab: int, b: int, s: int = LOOP_SEQ, eos: int = EOS_ID):
        self.vocab, self.b, self.s, self.eos, self.i = vocab, b, s, eos, 0

    def state(self) -> dict:
        return {"batch": self.i}

    def restore(self, st: dict) -> None:
        self.i = int(st["batch"])

    def __iter__(self):
        while True:
            batch = packed_batch(self.vocab, self.b, self.s, seed=LOOP_DATA_SEED + self.i,
                                 eos=self.eos)
            self.i += 1
            yield batch


class LoopRecorder:
    """A training-loop callback keeping each step's loss as a device scalar
    (read after the fit, so the loop's host reads stay its own), the step's
    end on the host clock, the health, and optionally TF over the params and
    the optimizer state."""

    def __init__(self, fingerprint: bool = False):
        self.losses, self.ends, self.health, self.fps = [], [], [], []
        self.fingerprint = fingerprint
        self._fp = None

    def on_train_start(self, trainer):
        self.t0 = time.perf_counter()

    def on_step_end(self, trainer, metrics):
        self.losses.append(metrics["loss"])
        self.ends.append(time.perf_counter())
        self.health.append(trainer.health().value)
        if self.fingerprint:
            from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import TreeFingerprint

            if self._fp is None:
                # params and the optimizer state (a skipped step moves the
                # guard's counters, by design)
                leaves = trainer._state_leaves()
                self._fp = TreeFingerprint(leaves[:-3] if trainer.state.guard is not None
                                           else leaves)
            self.fps.append(self._fp())

    def on_train_end(self, trainer):
        pass

    def host_losses(self) -> list:
        return [float(x) for x in self.losses]

    def walls(self) -> list:
        return [b - a for a, b in zip([self.t0] + self.ends[:-1], self.ends)]


def loop_fit(model, b: int, steps: int = LOOP_STEPS, seed: int = 0, resume_from=None,
             callbacks=(), fingerprint: bool = False, **kw):
    """One ``Trainer.fit`` of phase 7b over ``PackedSource`` batches: AdamW
    at lr 3e-4, weight decay 0.1, clip 1.0."""
    from neuronx_distributed_tpu_torch.trainer import OptimizerConfig, Trainer

    rec = LoopRecorder(fingerprint)
    tr = Trainer(model=model, callbacks=[rec, *callbacks], optimizer_config=OptimizerConfig(
        learning_rate=LOOP_LR, weight_decay=0.1, max_grad_norm=1.0), **kw)
    out = tr.fit(PackedSource(model.config.vocab_size, b), seed, max_steps=steps,
                 resume_from=resume_from)
    torch.cuda.synchronize()
    return tr, rec, out


def state_fp(tr) -> int:
    """TF over the trainer's state (one launch) — and the caller counts it."""
    from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import TreeFingerprint

    return int(TreeFingerprint(tr._state_leaves())())


def release() -> None:
    """Free what the caller's deleted trainers held (their optimizer state,
    the sentinel's snapshots)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def fault_schedule(with_sigterm: bool):
    from neuronx_distributed_tpu_torch.trainer.faults import FaultInjector

    inj = FaultInjector().nan_loss(at=1).fail_dispatch(at=3).spike_grads(at=4, factor=1e6)
    return inj.deliver_sigterm(at=6) if with_sigterm else inj


def fault_leg(model, b: int, root: str, seq: int = LOOP_SEQ) -> dict:
    """7b(b): the schedule with and without the SIGTERM, the resume from the
    preemption's tag. On the card (``model`` at full width) or as the CPU dry
    run (a tiny model). Returns the decisions the two must share."""
    from neuronx_distributed_tpu_torch.trainer import AnomalyGuardConfig, OptimizerConfig, Trainer
    from neuronx_distributed_tpu_torch.utils.retry import RetryPolicy

    def run(inj, steps, resume_from=None, emergency=None, fingerprint=False):
        rec = LoopRecorder(fingerprint=fingerprint and model.device.type == "cuda")
        tr = Trainer(model=model, callbacks=[rec], fault_injector=inj, emergency_dir=emergency,
                     optimizer_config=OptimizerConfig(learning_rate=LOOP_LR, weight_decay=0.1),
                     anomaly_guard=AnomalyGuardConfig(warmup_steps=2),
                     dispatch_retry=RetryPolicy(max_attempts=3, first_wait=0.0, min_wait=0.0))
        tr.fit(PackedSource(model.config.vocab_size, b, seq), 0, max_steps=steps,
               resume_from=resume_from)
        return tr, rec

    ref, ref_rec = run(fault_schedule(False), LOOP_STEPS)
    ref_fp = state_fp(ref) if model.device.type == "cuda" else None
    ref_facts = dict(skips=ref.anomaly_skips, retries=ref.dispatch_retries,
                     counters=dict(ref.fault_injector.counters), health=ref_rec.health)
    ref_dispatches = ref.programs.dispatches("train_step")
    del ref
    pre, pre_rec = run(fault_schedule(True), LOOP_STEPS, emergency=root, fingerprint=True)
    preempt_s = time.perf_counter() - pre_rec.ends[-1]
    t0 = time.perf_counter()
    post, post_rec = run(None, LOOP_STEPS, resume_from=root)
    resume_s = time.perf_counter() - t0
    out = dict(ref=ref_facts, preempted=pre.preempted, pre_step=pre.step,
               counters=dict(pre.fault_injector.counters), skips=pre.anomaly_skips,
               retries=pre.dispatch_retries, health=pre_rec.health, tags=sorted(os.listdir(root)),
               resumed_steps=post.steps_run, final_step=post.step,
               post_skips=post.anomaly_skips, post_retries=post.dispatch_retries)
    out["dispatches"] = (ref_dispatches + pre.programs.dispatches("train_step")
                         + post.programs.dispatches("train_step"))
    if model.device.type == "cuda":
        fps = [int(x) for x in pre_rec.fps]
        out.update(ref_fp=ref_fp, fp=state_fp(post), step_fps=fps, resume_s=resume_s,
                   preempt_s=preempt_s,
                   tf_calls=2 + len(fps), pre_losses=pre_rec.host_losses(),
                   post_losses=post_rec.host_losses(), ref_losses=ref_rec.host_losses())
    del pre, post
    return out


def fault_dry_run(tmp: str) -> dict:
    """7b(b)'s schedule on the CPU at tiny width (2 layers, packed 2 x 64)."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, tiny_llama

    model = init_params(LlamaForCausalLM(tiny_llama(num_layers=2, vocab_size=EOS_ID + 2),
                                         device="cpu", trainable=True), seed=0)
    out = fault_leg(model, 2, tmp, seq=64)
    out.pop("dispatches")
    return out


def loop_phase(smi: str) -> dict:
    """Phase 7b: ``Trainer.fit`` at Llama-3-8B width cut to 2 layers, phase
    7's packed 2 x 4096 batches from a seed, fp32 masters, remat on.
    (a) 8 steps with async checkpoints every 4 and a MetricsCallback, a
    fresh fit resumed from step_4 to step 8; (b) the fault schedule, its
    preemption and resume, against a CPU dry run; (c) the canary sentinel
    at B = 1 (the memory reckoning in PERF.md), a flip convicted and rolled
    back, a rotten shard's fallback at B = 2; (d) the three remat policies.
    Every count is zeroed before and read after; the checkpoint directory
    lives in build/ and is deleted at the end."""
    import shutil
    import tempfile

    from neuronx_distributed_tpu_torch.integrity import SentinelConfig
    from neuronx_distributed_tpu_torch.integrity.checkpoint import verify_manifest
    from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import (
        TreeFingerprint,
        tree_fingerprint_plain,
    )
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b
    from neuronx_distributed_tpu_torch.observability.callback import MetricsCallback
    from neuronx_distributed_tpu_torch.trainer import CheckpointCallback
    from neuronx_distributed_tpu_torch.trainer.checkpoint import (
        NEWEST_FILE,
        create_checkpoint_storage,
    )
    from neuronx_distributed_tpu_torch.trainer.faults import FaultInjector

    t_phase = time.perf_counter()
    shutil.rmtree(LOOP_CKPT, ignore_errors=True)
    os.makedirs(LOOP_CKPT)
    free = shutil.disk_usage(LOOP_CKPT).free
    log(f"phase 7b: checkpoint directory {LOOP_CKPT}: {free / 1e9:.1f} GB free")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dry = fault_dry_run(tmp)
        dry_s = time.perf_counter() - t0
    cfg = llama3_8b(num_layers=LOOP_LAYERS)
    model = LlamaForCausalLM(cfg, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    dispatches, tf_calls, res = 0, 0, {"dry_s": dry_s, "n_params": n_params, "free_gb": free / 1e9}
    dir_a, dir_b = os.path.join(LOOP_CKPT, "a"), os.path.join(LOOP_CKPT, "b")
    try:
        # (c) first: the sentinel's two snapshots want the card to themselves
        c_ref, rec, _ = loop_fit(model, 1)
        c_losses, c_fp, c_walls = rec.host_losses(), state_fp(c_ref), rec.walls()
        dispatches += c_ref.programs.dispatches("train_step")
        tf_calls += 1
        del c_ref, rec
        release()
        sent = {}
        for name, inj in (("clean", None), ("flip7", FaultInjector().flip_bits("params", at=7)),
                          ("flip5", FaultInjector().flip_bits("params", at=5))):
            tr, rec, _ = loop_fit(model, 1, integrity=SentinelConfig(check_every=LOOP_EVERY),
                                  fault_injector=inj)
            s = tr._sentinel
            sent[name] = dict(counters=dict(s.counters), fp=state_fp(tr), losses=rec.host_losses(),
                              walls=rec.walls(), reads=tr.host_reads, step=tr.step,
                              events=[(e["kind"], e.get("step", e.get("to_step")))
                                      for e in tr._flight.events() if e["kind"].startswith("sdc")],
                              snap_bytes=tr.hbm.resident_bytes("integrity_snapshots"),
                              state_bytes=sum(t.numel() * t.element_size()
                                              for t in tr._state_leaves()),
                              peak=torch.cuda.max_memory_allocated())
            dispatches += tr.programs.dispatches("train_step")
            tf_calls += 1 + 2 * s.counters["integrity_checks"]
            del tr, rec, s
            release()
        if sent["clean"]["counters"] != {"integrity_checks": 2, "sdc_detected": 0,
                                         "sdc_unlocalized": 0, "sdc_rollbacks": 0}:
            raise AssertionError(f"7b(c): the clean run's checks {sent['clean']['counters']}")
        if sent["clean"]["losses"] != c_losses or sent["clean"]["fp"] != c_fp:
            raise AssertionError("7b(c): the sentinel changed the clean run's losses or bits")
        f7 = sent["flip7"]
        if (f7["counters"]["sdc_detected"], f7["counters"]["sdc_rollbacks"]) != (1, 1) or \
                f7["fp"] != c_fp or ("sdc_detected", 8) not in f7["events"] or \
                ("sdc_rollback", 4) not in f7["events"]:
            raise AssertionError(f"7b(c): the flip at step 7: {f7['counters']}, {f7['events']}, "
                                 f"final bits {'equal' if f7['fp'] == c_fp else 'differ'}")
        if sent["flip5"]["counters"]["sdc_detected"] != 0:
            raise AssertionError(f"7b(c): a flip between checks convicted: {sent['flip5']}")
        if any(v["snap_bytes"] != 2 * v["state_bytes"] for v in sent.values()):
            raise AssertionError("7b(c): the snapshots are not two state-sized buffers")
        res["sent"], res["c_walls"], res["c_fp"] = sent, c_walls, c_fp

        # (a) the clean run with async checkpoints and the exact resume
        class TimedCheckpoint(CheckpointCallback):
            stalls = []

            def _save(self, trainer, async_save):
                t0 = time.perf_counter()
                super()._save(trainer, async_save)
                self.stalls.append(time.perf_counter() - t0)

        mcb = MetricsCallback()
        ck = TimedCheckpoint(dir_a, every=LOOP_EVERY, num_kept=2, async_save=True,
                             save_on_end=False)
        a1, rec, _ = loop_fit(model, 2, callbacks=[ck, mcb])
        a_losses, a_walls = rec.host_losses(), rec.walls()
        leaves = a1._state_leaves()
        a_fp = int(TreeFingerprint(leaves)())
        plain_fp = int(tree_fingerprint_plain(leaves))
        tf_calls += 1
        storage = create_checkpoint_storage(dir_a)
        tags = sorted(storage.list_checkpoint_tags())
        tag_bytes = sum(storage.file_size(os.path.join("step_8", f))
                        for f in storage.list_files("step_8"))
        t0 = time.perf_counter()
        ok8, detail8 = verify_manifest(storage, "step_8")
        verify_s = time.perf_counter() - t0
        prog = a1.programs.snapshot()["by_program"]["train_step"]
        res["a"] = dict(losses=a_losses, walls=a_walls, fp=a_fp, plain_fp=plain_fp,
                        reads=a1.host_reads, tags=tags, tag_bytes=tag_bytes, verify8=detail8,
                        verify_s=verify_s, stalls=list(ck.stalls), prog=prog,
                        registry=mcb.registry.snapshot(), peak=torch.cuda.max_memory_allocated())
        dispatches += a1.programs.dispatches("train_step")
        if a_fp != plain_fp or not ok8 or tags != ["step_4", "step_8"] or a1.host_reads != 8:
            raise AssertionError(f"7b(a): TF {a_fp:#010x} plain {plain_fp:#010x}, step_8 "
                                 f"{detail8}, tags {tags}, host reads {a1.host_reads}")
        res["tf"] = dict(leaves=len(leaves), bytes=sum(t.numel() * t.element_size() for t in leaves))
        del a1, rec, leaves
        release()
        storage.save_text("step_4", NEWEST_FILE)  # resume_from=step_4
        t0 = time.perf_counter()
        a2, rec, _ = loop_fit(model, 2, seed=99, resume_from=dir_a)
        res["a"]["resume_wall_s"] = time.perf_counter() - t0
        a2_losses, a2_fp = rec.host_losses(), state_fp(a2)
        tf_calls += 1
        dispatches += a2.programs.dispatches("train_step")
        if a2.steps_run != 4 or a2_losses != a_losses[4:] or a2_fp != a_fp \
                or a2.checkpoint_integrity_failures:
            raise AssertionError(f"7b(a): the resume from step_4 ran {a2.steps_run} steps, losses "
                                 f"{'equal' if a2_losses == a_losses[4:] else 'differ'}, bits "
                                 f"{'equal' if a2_fp == a_fp else 'differ'}")
        res["a"]["resumed_walls"] = rec.walls()
        del a2, rec
        release()
        # (c) a rotten shard in the newest tag: the restore falls back to step_4
        storage.save_text("step_8", NEWEST_FILE)
        inj = FaultInjector().flip_bits("checkpoint_shard", at=0)
        inj.on_checkpoint_saved(dir_a, "step_8")
        t0 = time.perf_counter()
        cs, rec, _ = loop_fit(model, 2, seed=98, resume_from=dir_a)
        res["shard"] = dict(flips=inj.counters["bit_flips"], failures=cs.checkpoint_integrity_failures,
                            steps_run=cs.steps_run, wall_s=time.perf_counter() - t0,
                            tags=sorted(storage.list_checkpoint_tags()))
        cs_fp = state_fp(cs)
        tf_calls += 1
        dispatches += cs.programs.dispatches("train_step")
        if (res["shard"]["flips"], res["shard"]["failures"], res["shard"]["steps_run"]) != (1, 1, 4) \
                or cs_fp != a_fp or rec.host_losses() != a_losses[4:]:
            raise AssertionError(f"7b(c): the rotten shard {res['shard']}, bits "
                                 f"{'equal' if cs_fp == a_fp else 'differ'}")
        del cs, rec
        release()
        shutil.rmtree(dir_a)

        # (b) the fault schedule, its preemption and resume
        os.makedirs(dir_b)
        fl = fault_leg(model, 2, dir_b)
        dispatches += fl.pop("dispatches")
        tf_calls += fl["tf_calls"]
        shutil.rmtree(dir_b)
        skipped = [1, 4]
        fps = fl["step_fps"]
        if fl["fp"] != fl["ref_fp"] or any(fps[i] != fps[i - 1] for i in skipped) or \
                "degraded" not in fl["health"] or not fl["preempted"]:
            raise AssertionError(f"7b(b): resumed bits {'equal' if fl['fp'] == fl['ref_fp'] else 'differ'}, "
                                 f"skipped steps' TF {[(fps[i - 1], fps[i]) for i in skipped]}, "
                                 f"health {fl['health']}, preempted {fl['preempted']}")
        keys = ("preempted", "pre_step", "counters", "skips", "retries", "health", "tags",
                "resumed_steps", "final_step", "post_skips", "post_retries", "ref")
        diff = {k: (fl[k], dry[k]) for k in keys if fl[k] != dry[k]}
        if diff:
            raise AssertionError(f"7b(b): the card's decisions differ from the CPU dry run's: {diff}")
        res["b"] = fl

        # (d) the remat policies: equal losses, each one's wall and peak
        remat = {}
        for pol in (None, "dots", "dots_saveable"):
            model.model.config = dataclasses.replace(cfg, remat_policy=pol)
            torch.cuda.reset_peak_memory_stats()
            tr, rec, _ = loop_fit(model, 2, steps=3)
            remat[pol] = dict(losses=rec.host_losses(), walls=rec.walls(),
                              peak=torch.cuda.max_memory_allocated())
            dispatches += tr.programs.dispatches("train_step")
            del tr, rec
            release()
        model.model.config = cfg
        if len({tuple(v["losses"]) for v in remat.values()}) != 1:
            raise AssertionError(f"7b(d): the remat policies' losses differ: {remat}")
        res["remat"] = remat
    finally:
        shutil.rmtree(LOOP_CKPT, ignore_errors=True)
    launches = {name: c.launches for name, c in counters.items()}
    seg = torch.from_numpy(packed_batch(cfg.vocab_size, 2, LOOP_SEQ, LOOP_DATA_SEED)["segment_ids"])
    res["formula_flops"] = (6.0 * (n_params - model.model.embed.weight.numel()) * 2 * LOOP_SEQ
                            + 12.0 * cfg.head_dim_ * cfg.num_heads * cfg.num_layers
                            * live_pairs(seg.cuda(), 2, LOOP_SEQ, "cuda"))
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=2 * LOOP_LAYERS * dispatches,
                flash_attention_dkdv=LOOP_LAYERS * dispatches,
                flash_attention_dq=LOOP_LAYERS * dispatches, tree_fingerprint=tf_calls)
    if launches != want:
        raise AssertionError(f"7b launches {launches} != {want} ({dispatches} train-step dispatches)")
    peak = max([v["peak"] for v in res["sent"].values()] + [res["a"]["peak"]]
               + [v["peak"] for v in res["remat"].values()])
    if peak >= 72 * 2**30:
        raise AssertionError(f"7b peak memory {peak / 2**30:.2f} GiB >= 72 GiB")
    # TF over a train state of these shapes (the parameters, two moment
    # buffers, the count and the guard) against its bytes bound, after the
    # counted window: a comparison, not the main path
    params = [p.detach() for p in model.parameters()]
    leaves = params + [torch.zeros_like(p) for p in params] * 2 + [
        torch.zeros((), dtype=torch.int32, device="cuda"),
        torch.zeros((), device="cuda"), torch.zeros((), dtype=torch.int32, device="cuda"),
        torch.zeros((), dtype=torch.int32, device="cuda")]
    prog = TreeFingerprint(leaves)
    nbytes = prog.nbytes + 8
    res["tf"].update(ms=cuda_ms(prog, 10), plain_ms=cuda_ms(
        lambda: tree_fingerprint_plain(leaves), 1, warmup=1), bound_ms=nbytes / PEAK_BYTES * 1e3,
        bound_by="bytes")
    if int(prog()) != int(tree_fingerprint_plain(leaves)):
        raise AssertionError("7b: TF over the train state differs from its plain version")
    del leaves, prog, params
    release()
    res.update(launches=launches, dispatches=dispatches, tf_calls=tf_calls, peak_gib=peak / 2**30,
               wall_s=time.perf_counter() - t_phase, dry=dry)
    return res


def ptxas_lines(report: list, sym: str) -> list:
    """The ``ptxas -v`` lines of kernel ``sym`` in a library's report."""
    at = next(i for i, line in enumerate(report) if "entry function" in line and sym in line)
    out = []
    for line in report[at + 1:]:
        if "entry function" in line:
            break
        out.append(line.split(":", 1)[-1].strip())
    return out


def fwd_resources() -> dict:
    """K1's resources as built, as ``bwd_resources``; K1 must not spill, and
    ptxas must not have serialized its ``wgmma`` products (C7514/C7515)."""
    import ctypes

    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("flash_attention")
    text = _build.resource_report("flash_attention")
    vals = (ctypes.c_int * 4)()
    _build.check(lib.nxd_flash_attention_fwd_resources(vals), "flash_fwd_kernel")
    ptxas = ptxas_lines(text.splitlines(), "flash_fwd_kernel")
    spills = [line for line in ptxas if "spill" in line]
    if vals[2] or not spills or any("0 bytes spill stores, 0 bytes spill loads" not in line
                                    for line in spills):
        raise AssertionError(f"K1 spills: {vals[2]} B local a thread; ptxas: {ptxas}")
    if "C7514" in text or "C7515" in text:
        raise AssertionError(f"ptxas serialized K1's wgmma products:\n{text}")
    return dict(kernel="flash_fwd_kernel", smem=vals[0], regs=vals[1], local=vals[2],
                blocks_per_sm=vals[3], ptxas="; ".join(ptxas))


def d96_resources() -> list:
    """The head_dim-96 builds' ``ptxas -v`` spill lines (every kernel of
    csrc/flash_attention.cu and csrc/flash_decode.cu at -DNXD_HEAD_DIM=96):
    none may spill, nor may ptxas serialize K1's ``wgmma`` products."""
    from neuronx_distributed_tpu_torch.kernels import _build

    out = []
    for name in ("flash_attention_d96", "flash_decode_d96"):
        text = _build.resource_report(name)
        spills = [line.strip() for line in text.splitlines() if "spill" in line]
        if not spills or any("0 bytes spill stores, 0 bytes spill loads" not in line
                             for line in spills):
            raise AssertionError(f"{name} spills or was not reported:\n" + "\n".join(spills))
        if "C7514" in text or "C7515" in text:
            raise AssertionError(f"ptxas serialized {name}'s wgmma products:\n{text}")
        out.append(f"{name}: {len(spills)} kernels, no spill")
    return out


def bwd_resources() -> list:
    """K2's and K3's resources as built: dynamic shared memory, registers a
    thread at entry, spill bytes and blocks per SM from the runtime, and the
    ``ptxas -v`` lines of each kernel."""
    import ctypes

    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("flash_attention_bwd")
    report = _build.resource_report("flash_attention_bwd").splitlines()
    out = []
    for which, sym in ((0, "flash_dkdv_kernel"), (1, "flash_dq_kernel")):
        vals = (ctypes.c_int * 4)()
        _build.check(lib.nxd_flash_attention_bwd_resources(which, vals), sym)
        out.append(dict(kernel=sym, smem=vals[0], regs=vals[1], local=vals[2], blocks_per_sm=vals[3],
                        ptxas="; ".join(ptxas_lines(report, sym))))
    return out


def decode_resources() -> tuple:
    """K4's, K5's, K5q's and K5q with the write's resources as built, at R <= 4
    (Llama-3-8B's group of 4 at s = 1), R <= 16 (the verify window, K5q's),
    R <= 32 and on the multi-row path: dynamic shared memory, registers a thread, local
    bytes and blocks per SM from the runtime; and ``ptxas -v``'s spill line
    of every decode kernel and merge, which must show no spill. Returns
    (the resources, the number of kernels ``ptxas`` reported)."""
    import ctypes

    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("flash_decode")
    out = []
    # K4, K5, K5q, K5q with the write
    for kind, prefix, suffix in ((0, "", ""), (1, "paged_", ""), (2, "qpaged_", ""),
                                 (3, "qpaged_", "_write")):
        for rmax in (4, 32, 0) if kind < 2 else (4, 16, 32):  # 0: the multi-row kernel
            vals = (ctypes.c_int * 4)()
            _build.check(lib.nxd_flash_decode_resources(kind, rmax, vals), "flash_decode")
            kernel = "flash_decode_kernel" + (f"{suffix}<{rmax}>" if rmax else "_rows")
            out.append(dict(kernel=prefix + kernel,
                            smem=vals[0], regs=vals[1], local=vals[2], blocks_per_sm=vals[3]))
    report = _build.resource_report("flash_decode").splitlines()
    spills = [line.strip() for line in report if "spill" in line]
    if any("0 bytes spill stores, 0 bytes spill loads" not in line for line in spills):
        raise AssertionError("a decode kernel spills:\n" + "\n".join(spills))
    return out, len(spills)


def log_loop_phase(lp: dict, smi: str) -> None:
    """Phase 7b's report lines."""
    med = statistics.median
    a, b, sent, tf = lp["a"], lp["b"], lp["sent"], lp["tf"]
    log(f"phase 7b ({smi}): Trainer.fit, llama3_8b width cut to {LOOP_LAYERS} layers "
        f"({lp['n_params']} parameters: fp32 masters, AdamW lr {LOOP_LR} wd 0.1 clip 1.0, remat on), "
        f"phase 7's packed batches from a seed (B = 2, S = {LOOP_SEQ}; the sentinel leg at B = 1), "
        f"{lp['free_gb']:.1f} GB free for checkpoints; wall {lp['wall_s']:.1f} s, the CPU dry run "
        f"{lp['dry_s']:.1f} s of it")
    log("7b(a) losses: " + ", ".join(f"{x:.5f}" for x in a["losses"])
        + "; step walls (s): " + ", ".join(f"{x:.4f}" for x in a["walls"]))
    log(f"7b(a): host reads {a['reads']} = steps; tags {a['tags']} (keep-last 2), {a['tag_bytes']} "
        f"B a tag; async save stalls (the host copy) "
        + ", ".join(f"{x:.3f}" for x in a["stalls"]) + f" s; step_8 {a['verify8']} in "
        f"{a['verify_s']:.2f} s; TF over the final state {a['fp']:#010x} = plain; the fresh fit "
        f"from step_4 (verify, load, 4 steps) {a['resume_wall_s']:.2f} s: steps 5-8's losses and "
        f"the final TF equal bit for bit; resumed step walls "
        + ", ".join(f"{x:.4f}" for x in a["resumed_walls"]))
    reg = a["registry"]
    log(f"7b(a) MetricsCallback: train_steps {reg.get('train_steps')}, train_tokens_seen "
        f"{reg.get('train_tokens_seen')}, train_loss {reg.get('train_loss')}, "
        f"train_anomaly_skips {reg.get('train_anomaly_skips')}")
    prog = a["prog"]
    wall = med(a["walls"][1:])
    log(f"7b(a) trainer ledger, train_step: {prog['dispatches']} dispatches, {prog['compiles']} "
        f"compile(s), {prog['flops_per_dispatch']:.5g} FLOPs a dispatch (metered at the first, remat "
        f"recompute included), wall p50 {prog.get('wall', {}).get('p50_s', 'unavailable')}, MFU "
        f"p50 {prog.get('mfu_p50', 'unavailable')}; phase 7's formula (6 x non-embedding params x "
        f"tokens + attention, no recompute) at this depth: {lp['formula_flops']:.5g} FLOPs, "
        f"mfu {lp['formula_flops'] / wall / PEAK_BF16_FLOPS:.4f} at the median wall {wall:.4f} s")
    log(f"7b(b) schedule {LOOP_SCHEDULE}, warm-up 2: counters {b['counters']}, anomaly_skips "
        f"{b['skips']}, dispatch_retries {b['retries']}, health by step {b['health']}, "
        f"preempted at step {b['pre_step']} ({b['preempt_s']:.2f} s from the last step to the "
        f"return: the sync save of step_{b['pre_step']}), tags {b['tags']}; the skipped steps' TF "
        f"unchanged; the resume ({b['resume_s']:.2f} s, {b['resumed_steps']} steps) reaches the "
        f"uninterrupted schedule's final bits {b['fp']:#010x}; = the CPU dry run at tiny width")
    c_walls = lp["c_walls"]
    cl = sent["clean"]["walls"]
    checks = [cl[i] for i in range(len(cl)) if (i + 1) % LOOP_EVERY == 0]
    plain = [cl[i] for i in range(1, len(cl)) if (i + 1) % LOOP_EVERY != 0]
    log(f"7b(c) SentinelConfig(check_every={LOOP_EVERY}), B = 1: clean {sent['clean']['counters']}, "
        f"losses and final TF = the sentinel-off run's; step wall (median, steps 2-8 but checks) "
        f"{med(plain):.4f} s with the sentinel, {med(c_walls[1:]):.4f} s without; check steps "
        + ", ".join(f"{x:.4f}" for x in checks)
        + f" s (+{med(checks) - med(plain):.4f} s a check: a second step, three state copies, two "
        f"TF); snapshots {sent['clean']['snap_bytes']} B = 2 x the state; host reads "
        f"{sent['clean']['reads']} = steps")
    for name in ("flip7", "flip5"):
        v = sent[name]
        log(f"7b(c) flip_bits('params', at={name[-1]}): {v['counters']}, events {v['events']}, final "
            f"bits {'= the clean run' if v['fp'] == lp['c_fp'] else 'differ from the clean run'}"
            + ("" if name == "flip7" else " (between checks: outside the canary's reach, as "
               "JAX's)"))
    sh = lp["shard"]
    log(f"7b(c) flip_bits('checkpoint_shard') on step_8: the restore failed verification and fell "
        f"back to step_4 (checkpoint_integrity_failures {sh['failures']}, tags left {sh['tags']}), "
        f"{sh['steps_run']} steps retrained to the clean final bits, {sh['wall_s']:.2f} s")
    for pol, v in lp["remat"].items():
        log(f"7b(d) remat_policy {pol}: losses " + ", ".join(f"{x:.5f}" for x in v["losses"])
            + f" (equal across the policies), step wall (median of steps 2-3) "
            f"{med(v['walls'][1:]):.4f} s, peak {v['peak'] / 2**30:.2f} GiB")
    log(f"7b launches {lp['launches']}: K1 = 2 x {LOOP_LAYERS} layers x {lp['dispatches']} "
        f"train-step dispatches (forward and recompute), K2 = K3 = {LOOP_LAYERS} x "
        f"{lp['dispatches']}, TF {lp['tf_calls']} (two a check and the gates' own); peak "
        f"{lp['peak_gib']:.2f} GiB")
    log(f"TF tree_fingerprint over the train state ({smi}; {tf['leaves']} leaves: params, mu, nu, "
        f"count, guard; {tf['bytes']} B): kernel_ms {tf['ms']:.4f} plain_ms {tf['plain_ms']:.4f} "
        f"bound_ms {tf['bound_ms']:.4f} ({tf['bound_by']}; {tf['ms'] / tf['bound_ms']:.2f}x)")


# --- phase 5m: Mixtral serving ---------------------------------------------------

MOE_LAYERS_BF16, MOE_LAYERS_QUANT = 16, 8  # depth cuts of (a) and (b): bf16 at 32 layers is 93 GB


class LogitsOnly:
    """A Mixtral seen as the Llama helpers above see a model: its calls
    return the logits alone (``forward`` returns ``(logits, aux)``)."""

    def __init__(self, model):
        self.model, self.config, self.device = model, model.config, model.device

    def new_cache(self, batch: int):
        return self.model.new_cache(batch)

    def new_paged_cache(self, *args, **kwargs):
        return self.model.new_paged_cache(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        return self.model(*args, **kwargs)[0]


@contextlib.contextmanager
def plain_experts():
    """Route the experts' selective route through MX/MXq's plain version
    (reference runs only; the port itself has no such switch)."""
    from neuronx_distributed_tpu_torch.kernels.moe_experts import moe_experts_plain
    from neuronx_distributed_tpu_torch.modules.moe import expert_mlps

    saved = expert_mlps.moe_experts, expert_mlps.moe_experts_quantized
    expert_mlps.moe_experts = lambda *a, **kw: moe_experts_plain(*a, **kw)
    expert_mlps.moe_experts_quantized = lambda *a, **kw: moe_experts_plain(*a, **kw)
    try:
        with f32_reductions():
            yield
    finally:
        expert_mlps.moe_experts, expert_mlps.moe_experts_quantized = saved


def moe_outputs(model, gen) -> dict:
    """Phase 3's check on a Mixtral: the logits of a 64-token prompt and 8
    decode steps through the kernels (K1, K4 or K5 behind a scrambled table,
    MX) against the plain path's (plain attention and MX's plain version;
    the prefill's blockwise products are the same torch ops on both), within
    phase 3's limits."""
    lm = LogitsOnly(model)
    ids = torch.randint(1, model.config.vocab_size, (1, 64), generator=gen, device="cuda")
    with plain_attention(), plain_experts():
        ref, toks = teacher_logits(lm, ids, 8)
    res = {}
    for name, cache in (("row", None), ("paged", scrambled_paged_cache(lm))):
        got, _ = teacher_logits(lm, ids, 8, feed=toks, cache=cache)
        scale = float(ref.abs().max())
        rel = max_err(got, ref) / scale
        in_top5 = bool((got.topk(5, dim=-1).indices == ref.argmax(-1)[:, None]).any(-1).all())
        if not torch.isfinite(got).all() or rel > 5e-2 or not in_top5:
            raise AssertionError(f"Mixtral logits ({name} cache) disagree with the plain path: "
                                 f"rel {rel}, plain top-1 in top-5: {in_top5}")
        res[name] = dict(rel_err=rel, logit_scale=scale,
                         argmax_agree=f"{int((got.argmax(-1) == ref.argmax(-1)).sum())}/"
                                      f"{ref.shape[0]}")
    return res


def mixtral_routers(model) -> list:
    """The routers of a Mixtral (or of its :class:`LogitsOnly` view), by layer."""
    model = model.model if isinstance(model, LogitsOnly) else model
    return [layer.moe.router for layer in model.model.layers]


class RouteRecorder:
    """The experts a Mixtral's eager forwards routed each token to
    (reference runs only; the port itself records nothing). Every router
    call's ``top_e`` is kept, none while a CUDA graph captures; the caller
    takes them a forward at a time (:meth:`take`) and files a forward's
    rows under their context and first position (:meth:`file`).
    :meth:`routes_for` gives a context's routes position by position from
    the first filing that computed the position in that context: a later
    prefix hit reuses the K/V that computation stored."""

    def __init__(self, model):
        routers = mixtral_routers(model)
        self.layers = len(routers)
        self.pending, self.entries = [], []
        self.handles = [r.register_forward_hook(self._hook) for r in routers]

    def _hook(self, module, args, out):
        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            self.pending.append(out.top_e.detach().clone())

    def take(self) -> list:
        """The routes of the forwards since the last take: a (T, L, k)
        tensor each."""
        got, self.pending = self.pending, []
        if len(got) % self.layers:
            raise AssertionError(f"{len(got)} router calls are no whole forwards of "
                                 f"{self.layers} layers")
        return [torch.stack(got[i:i + self.layers], 1) for i in range(0, len(got), self.layers)]

    def file(self, ctx, start: int, routes: torch.Tensor) -> None:
        """``routes`` (n, L, k) are those of positions ``start .. start + n``
        of the context ``ctx`` (its tokens up to those positions at least)."""
        import numpy as np

        self.entries.append((np.asarray(ctx, np.int64), start, routes.cpu()))

    def routes_for(self, ctx, n=None) -> torch.Tensor:
        """(n, L, k) routes of the positions ``0 .. n`` of ``ctx`` (all by
        default); raises when a position has none."""
        import numpy as np

        ctx = np.asarray(ctx, np.int64)
        n = len(ctx) if n is None else n
        out, have = None, np.zeros(n, bool)
        for c, start, r in self.entries:
            m = min(len(c), n)
            diff = np.flatnonzero(c[:m] != ctx[:m])
            hi = min(start + r.shape[0], int(diff[0]) if diff.size else m)
            if hi <= start:
                continue
            if out is None:
                out = torch.full((n,) + tuple(r.shape[1:]), -1, dtype=r.dtype)
            new = torch.from_numpy(~have[start:hi])
            out[start:hi][new] = r[:hi - start][new]
            have[start:hi] = True
        if not have.all():
            raise AssertionError(f"no recorded route for {int((~have).sum())} of {n} positions "
                                 f"(first {int(np.flatnonzero(~have)[0])})")
        return out

    def close(self) -> None:
        for h in self.handles:
            h.remove()


@contextlib.contextmanager
def forced_routes(model, routes: torch.Tensor):
    """Every router of ``model`` takes ``routes`` (T, L, k; -1: the
    router's own choice) for one forward of T tokens, its affinities
    renormalized over them as ``RouterTopK`` does (reference runs only).
    Yields a one-element list: after the forward, the count of forced
    (token, layer) routes whose expert set the router's own top-k would
    not have chosen."""
    from neuronx_distributed_tpu_torch.modules.moe.routing import RouterOutput

    flips = [0]
    handles = []

    def hook_for(layer):
        def hook(module, args, out):
            want = routes[:, layer].to(out.top_e.device)
            if want.shape != out.top_e.shape:
                raise AssertionError(f"forced routes {tuple(want.shape)} for a router call of "
                                     f"{tuple(out.top_e.shape)}")
            forced = (want >= 0).all(-1)
            te = torch.where(forced[:, None], want, out.top_e)
            own = out.top_e.sort(-1).values != te.sort(-1).values
            flips[0] += int((own.any(-1) & forced).sum())
            tw = out.probs.gather(-1, te)
            if module.normalize_top_k_affinities and module.act_fn == "softmax":
                tw = tw / tw.sum(-1, keepdim=True).clamp_min(1e-9)
            return RouterOutput(out.logits, out.probs, te, tw)
        return hook

    for i, r in enumerate(mixtral_routers(model)):
        handles.append(r.register_forward_hook(hook_for(i)))
    try:
        yield flips
    finally:
        for h in handles:
            h.remove()


def record_admissions(engine, rec: RouteRecorder) -> None:
    """File each admission's prefill rows in ``rec``: a full prefill's
    prompt rows (left-padded) from position 0, a hit's suffix rows
    (right-padded) from its reuse. An engine (row or paged) without a
    draft only."""
    real = engine._admit_and_prefill

    def admit(req, slot, call, ctx, p, padded, target, plan):
        rec.take()  # a decode step's warm-up, run before a capture
        got = real(req, slot, call, ctx, p, padded, target, plan)
        if got[0] is not None:
            (te,) = rec.take()
            if plan is None:
                rec.file(ctx, 0, te[padded - p:])
            else:
                rec.file(ctx, plan[1], te[:p - plan[1]])
        return got

    engine._admit_and_prefill = admit


@contextlib.contextmanager
def recorded_eager_steps(engine, rec: RouteRecorder, steps: dict):
    """The engine's decode step run eagerly (:func:`eager_decode_step`),
    its admissions filed in ``rec``, and each step's routes kept by slot:
    ``steps[(rid, j)] = (input token, routes (L, k))`` for the step that
    emitted a request's token ``j``, which fed it token ``j - 1`` (file
    them with :func:`file_decode_routes` once the streams are known)."""
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram

    record_admissions(engine, rec)

    def step(prog):
        st = engine._state
        active, ntok, tok = (st[n].clone() for n in ("active", "ntok", "tok"))
        slots = list(engine._slot_req)
        rec.take()
        prog.step()
        (te,) = rec.take()
        for s in torch.nonzero(active).flatten().tolist():
            steps[(slots[s].rid, int(ntok[s]))] = (int(tok[s]), te[s].cpu())

    saved, DecodeProgram.__call__ = DecodeProgram.__call__, step
    try:
        yield
    finally:
        DecodeProgram.__call__ = saved


def file_decode_routes(rec: RouteRecorder, steps: dict, rid: int, prompt, toks) -> None:
    """File request ``rid``'s decode routes (:func:`recorded_eager_steps`):
    positions ``len(prompt) ..`` of ``prompt + toks[:-1]``, after checking
    that each step fed the token this mapping says."""
    import numpy as np

    rows = []
    for j in range(1, len(toks)):
        fed, routes = steps[(rid, j)]
        if fed != toks[j - 1]:
            raise AssertionError(f"request {rid}: the step emitting token {j} fed {fed}, not "
                                 f"token {j - 1} ({toks[j - 1]})")
        rows.append(routes)
    rec.file(np.concatenate([prompt, toks[:-1]]), len(prompt), torch.stack(rows))


def moe_teacher_ratio(model, streams) -> dict:
    """:func:`teacher_ratio` for a Mixtral on the routes its tokens were
    served on: for each greedy ``(rec, prompt, tokens)`` of ``streams``, one
    teacher-forced forward (K1, the blockwise route) of prompt + tokens with
    every router forced onto the served routes (``rec.routes_for``); every
    token within phase 3's limit of its row's maximum logit. Returns the
    largest gap over its limit and the forced routes the forward's own
    routers would not have chosen, of all."""
    import numpy as np

    worst, flips, forced = 0.0, 0, 0
    with torch.no_grad():
        for rec, p, toks in streams:
            ctx = np.concatenate([p, toks[:-1]])
            routes = rec.routes_for(ctx)
            with forced_routes(model, routes) as fl:
                logits = model(torch.tensor(ctx[None], device=model.device))[0]
            logits = logits[0, len(p) - 1:].float()  # row j predicts toks[j]
            emitted = torch.tensor(toks, device=model.device)[:, None]
            gap = logits.max(-1).values - logits.gather(-1, emitted)[:, 0]
            worst = max(worst, float((gap / (5e-2 * logits.abs().max())).max()))
            flips += fl[0]
            forced += routes.shape[0] * routes.shape[1]
    return dict(ratio=worst, flips=flips, forced=forced)


def first_route_difference(a: torch.Tensor, b: torch.Tensor):
    """The first (position, layer) at which two (n, L, k) route records
    choose another expert set, or None."""
    diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
    where = torch.nonzero(diff)
    return tuple(int(v) for v in where[0]) if where.shape[0] else None


def moe_quant_check(model, qcfg, gen) -> dict:
    """A 64-token prompt and 16 greedy steps of the bf16 ``model``,
    teacher-forced through its ``qcfg`` copy (``quantize_model``: linears,
    lm_head and the expert stacks; the routers float): JAX's Mixtral
    criterion on the logits (median of |q - ref| / max |ref| under 0.02,
    95% of them under 0.1; ``tests/quantization/test_quantized_model.py:
    199-205``), the max and mean KL of the quantized next-token
    distribution from the bf16 one, top-1 agreement."""
    from neuronx_distributed_tpu_torch.models.mixtral import quantize_model

    ids = torch.randint(1, model.config.vocab_size, (1, 64), generator=gen, device=model.device)
    ref, toks = teacher_logits(LogitsOnly(model), ids, 16)
    qm = quantize_model(model, qcfg)
    got, _ = teacher_logits(LogitsOnly(qm), ids, 16, feed=toks)
    weight_bytes = sum(t.numel() * t.element_size() for t in qm.state_dict().values())
    del qm
    torch.cuda.empty_cache()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits through the quantized Mixtral")
    rel = (got - ref).abs() / ref.abs().max()
    lp = torch.log_softmax(ref.double(), -1)
    kl = (lp.exp() * (lp - torch.log_softmax(got.double(), -1))).sum(-1)
    res = dict(median_rel=float(rel.median()), frac_under=float((rel < 0.1).double().mean()),
               max_rel=float(rel.max()), max_kl=float(kl.max()), mean_kl=float(kl.mean()),
               top1=float((got.argmax(-1) == ref.argmax(-1)).double().mean()),
               weight_bytes=weight_bytes)
    if res["median_rel"] >= 0.02 or res["frac_under"] <= 0.95:
        raise AssertionError(f"quantized Mixtral logits fail JAX's criterion: {res}")
    return res


def moe_expert_gates(what: str, res: dict, layers: int, name: str, per_replay: int) -> None:
    """MX/MXq once a layer a replay (``per_replay`` layers: 0 on the
    blockwise route) and once a layer in the capture's warm-up; the
    prefills (>= 30 tokens) take the blockwise route, so no other launch."""
    got = res["per_replay"].get(name, 0)
    if got != per_replay:
        raise AssertionError(f"{what}: {name} {got} a replay, want {per_replay}")
    want = (res["replays"] + 1) * per_replay
    if res["launches"][name] != want:
        raise AssertionError(f"{what}: {name} launches {res['launches'][name]} != (replays "
                             f"{res['replays']} + the warm-up) x {per_replay}")


class SeededWeights(collections.abc.Mapping):
    """W1 of a weight swap for a model the card cannot hold twice: a state
    dict whose tensors are drawn when read, each by ``init_params``'s rule
    (``models/mixtral.py _fill``) from a generator of its own (seed and
    its index in state-dict order), so every read of a key gives the same
    values and few tensors exist at a time."""

    def __init__(self, model, seed: int):
        self._own = model.state_dict()
        self._index = {name: n for n, name in enumerate(self._own)}
        self._seed = seed

    def __getitem__(self, name):
        from neuronx_distributed_tpu_torch.models.mixtral import _fill

        t = self._own[name]
        gen = torch.Generator(device=t.device).manual_seed(
            self._seed * 1_000_003 + self._index[name])
        w = torch.empty_like(t)
        _fill(w, name, gen)
        return w

    def __iter__(self):
        return iter(self._own)

    def __len__(self):
        return len(self._own)


def moe_swap_leg(model, workload, w0_tokens, smi: str) -> dict:
    """5m(a)'s weight swap. The captured decode step holds MX's tensor maps,
    which encode the expert stacks' addresses, so a swap must write the
    stacks in place for a replay to read the new weights. Phase 4's
    requests through a row engine at 8 slots under W0 (the model's
    weights), ``engine.params = W1`` (:class:`SeededWeights`, seed
    SWAP_SEED), the same requests again. Gates: every parameter at its
    address, one capture, MX once a layer a replay and no other MX launch,
    every stream unlike W0's and equal to a fresh engine's over the model,
    which now holds W1. Returns the three waves' launches and the swap's
    wall."""
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    layers = model.config.num_layers
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8, prefix_cache=None)
    w0 = engine_wave(engine, workload)
    ptrs = param_ptrs(engine.model)
    w1_dict = SeededWeights(model, SWAP_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.params = w1_dict
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    if param_ptrs(engine.model) != ptrs or engine.decode_compilations != 1:
        raise AssertionError("5m(a) weight swap: a parameter moved, or the decode program was "
                             f"captured again ({engine.decode_compilations} captures)")
    w1 = engine_wave(engine, workload)
    mx = w1["launches"]["moe_experts"]
    if (engine.decode_compilations != 1 or w1["per_replay"].get("moe_experts") != layers
            or mx != w1["replays"] * layers):
        raise AssertionError(f"5m(a) weight swap, second wave: {engine.decode_compilations} "
                             f"captures, MX {w1['per_replay'].get('moe_experts')} a replay, "
                             f"{mx} launches for {w1['replays']} replays x {layers} layers")
    same_w0 = [i for i, (a, b) in enumerate(zip(w1["tokens"], w0["tokens"])) if a == b]
    if same_w0:
        raise AssertionError(f"5m(a) weight swap: requests {same_w0} streamed W0's tokens after "
                             "the swap")
    del engine
    collect_engines()
    fresh = serve_workload(model, workload)
    if fresh["tokens"] != w1["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(w1["tokens"], fresh["tokens"])) if a != b]
        raise AssertionError(f"5m(a) weight swap: requests {diff} differ from a fresh engine's "
                             "over the model holding W1")
    n = len(w1["tokens"])
    nbytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    log(f"5m(a) weight swap ({smi}; phase 4's 6 requests, row engine, 8 slots): the W0 wave's "
        f"streams {'equal' if w0['tokens'] == w0_tokens else 'differ from'} the row serving's; "
        f"engine.params = W1 (seed {SWAP_SEED}, {nbytes / 1e9:.3f} GB drawn on the card as "
        f"read) in {1e3 * swap_s:.2f} ms; every parameter at its address, one capture; the wave "
        f"after the swap: MX {mx} = {w1['replays']} replays x {layers}, streams differ from "
        f"W0's ({n} of {n}) and equal a fresh engine's on W1 bit for bit ({n} of {n})")
    return dict(launches=(w0["launches"], w1["launches"], fresh["launches"]), swap_s=swap_s)


def moe_phase(smi: str) -> dict:
    """Phase 5m: Mixtral serving at Mixtral-8x7B width (hidden 4096, 32/8
    heads, 8 experts top-2, intermediate 14336, vocab 32000, random weights
    from seed 0). (a) bf16 at MOE_LAYERS_BF16 layers (~47 GB of weights):
    the kernel path against the plain path; solo ``generate``; phase 4's
    requests through a row engine at 8 slots (MX once a layer a replay),
    its eager witness bit for bit, a profiled rerun (idle share); phase 5b's
    traffic through a paged engine at 16 slots (K5 and the blockwise route
    under the capture), its eager witness bit for bit; phase 5c's prefix
    wave on the row engine (11 hits, 1 miss; hit logits against full
    prefills forced onto the hits' routes); a weight swap on a row engine
    at 8 slots (:func:`moe_swap_leg`). Every greedy token of the row
    engine and of solo ``generate`` within phase 3's limit in a
    teacher-forced forward forced onto the routes that served it (recorded
    in the eager witness and in solo ``generate``): a random router's
    near-ties make the expert choice the one discontinuity between two
    routes' arithmetic, so the references take the served routes and the
    route differences are counted and reported.
    (b) int8 and fp8 copies of an MOE_LAYERS_QUANT-layer bf16 model,
    teacher-forced: JAX's Mixtral criterion, max KL. (c) the full 32-layer
    Mixtral-8x7B with int8 weights, filled weight by weight
    (``init_params`` of the quantized model: one float weight in memory at
    a time), phase 4's requests through a row engine at 8 slots: MXq once a
    layer and DQ 4 x 32 + 1 a replay, peak memory under 72 GiB."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
    from neuronx_distributed_tpu_torch.models.mixtral import (
        MixtralForCausalLM,
        init_params,
        mixtral_8x7b,
    )
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    import numpy as np

    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache

    out = {"launches": dict.fromkeys(kernel_counters(), 0)}
    # its own generator: the prompts do not depend on the earlier phases
    gen = torch.Generator(device="cuda").manual_seed(0)

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] += v

    # (a) bf16 at 16 layers
    t0 = time.perf_counter()
    cfg = mixtral_8x7b(num_layers=MOE_LAYERS_BF16)
    model = init_params(MixtralForCausalLM(cfg), seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"5m(a) model: mixtral_8x7b cut to {cfg.num_layers} layers (widths kept), "
        f"{n_params / 1e9:.3f} B params bf16 ({2 * n_params / 1e9:.2f} GB; routers f32), init "
        f"{time.perf_counter() - t0:.1f} s")
    for name, r in moe_outputs(model, gen).items():
        log(f"5m(a) outputs vs plain path ({name} cache{', scrambled table, K5' if name == 'paged' else ''}"
            f", MX against its plain version; 64-token prompt, 8 decode steps): rel_err "
            f"{r['rel_err']:.3g} argmax {r['argmax_agree']} logit_scale {r['logit_scale']:.3g}")
    srv = serve(model, gen)
    moe_expert_gates("5m(a) row serving", srv, cfg.num_layers, "moe_experts", cfg.num_layers)
    prompts, cfgs = srv["workload"]
    rec_eng, steps = RouteRecorder(model), {}
    wit = serve_workload(model, srv["workload"], eager=True,
                         witness=lambda engine: recorded_eager_steps(engine, rec_eng, steps))
    rec_eng.close()
    if wit["tokens"] != srv["tokens"]:
        raise AssertionError("5m(a): row streams differ between the decode graph and the eager step")
    add(srv["launches"])
    greedy = [i for i, c in enumerate(cfgs) if c.temperature == 0.0]
    for i in greedy:
        file_decode_routes(rec_eng, steps, wit["rids"][i], prompts[i], wit["tokens"][i])
    rec_solo = RouteRecorder(model)
    solo = generate(model, torch.tensor(prompts[0][None]), cfgs[0]).cpu()[0].tolist()
    calls = rec_solo.take()
    rec_solo.close()
    rec_solo.file(prompts[0], 0, calls[0])
    rec_solo.file(np.concatenate([prompts[0], solo[:-1]]), len(prompts[0]), torch.cat(calls[1:]))
    teach = moe_teacher_ratio(model, [(rec_eng, prompts[i], srv["tokens"][i]) for i in greedy]
                              + [(rec_solo, prompts[0], solo)])
    if teach["ratio"] > 1.0:
        raise AssertionError(f"5m(a): a served greedy token is {teach['ratio']:.3g}x phase 3's "
                             f"limit from its row's maximum, teacher-forced on its own routes")
    # where solo generate and the engine part: the first position and layer
    # at which their routes differ, within the context they share
    jd = next((j for j, (a, b) in enumerate(zip(solo, srv["tokens"][0])) if a != b), None)
    if jd is not None and jd > 0:
        shared = np.concatenate([prompts[0], solo[:jd]])
        first = first_route_difference(rec_solo.routes_for(shared), rec_eng.routes_for(shared))
        parting = (f"they first part at token {jd} (predicted at position "
                   f"{len(prompts[0]) + jd - 1}); their routes first differ at "
                   + (f"position {first[0]}, layer {first[1]}" if first else "no position"))
    else:
        parting = "identical" if jd is None else "they part at the first token"
    snap = srv["snap"]
    step_ms = 1e3 * srv["decode_s"] / max(srv["decode_only_executed"], 1)
    log(f"5m(a) row serving ({smi}): phase 4's 6 requests, 8 slots, chunk 8: every request DONE "
        f"with 32 tokens; one capture, {srv['replays']} replays = executed steps, launches a "
        f"replay {srv['per_replay']}; the eager step's streams identical; TTFT mean "
        f"{snap['mean_ttft']:.4f} s max {snap['max_ttft']:.4f} s; {step_ms:.2f} ms a decode-only "
        f"step ({srv['decode_only_executed']} executed); decode {snap['chunk_tokens_per_sec']:.1f} "
        f"tok/s (chunk wall); wall {srv['wall_s']:.3f} s (capture {snap['capture_s']:.4f} s); "
        f"solo generate of request 0: {sum(a == b for a, b in zip(solo, srv['tokens'][0]))}/32 "
        f"tokens equal the engine's, {parting}; the greedy tokens of the engine and of solo "
        f"generate, teacher-forced on the routes that served them: largest gap to the row "
        f"maximum {teach['ratio']:.3g}x phase 3's limit (<= 1); of the {teach['forced']} forced "
        f"(token, layer) routes, {teach['flips']} differ from the forward's own top-2")
    prof = profile_serving(model, srv["workload"])
    busy = sum(prof["fams"].values())
    wall_ms = 1e3 * (srv["wall_s"] - snap["capture_s"])
    out["a"] = dict(ttft=snap["mean_ttft"], step_ms=step_ms, tps=snap["chunk_tokens_per_sec"],
                    idle=1 - busy / wall_ms, fams=prof["fams"])
    log("5m(a) device time of the row workload (profiler, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in prof["fams"].items())
        + f"; busy {busy:.2f} of the unprofiled wall less its capture {wall_ms:.2f} (idle share "
        f"{1 - busy / wall_ms:.3f})")
    workload = paged_workload(cfg.vocab_size)
    fused = serve_paged(model, workload, "fused")
    eager = serve_paged(model, workload, "fused", eager=True)
    if eager["tokens"] != fused["tokens"]:
        raise AssertionError("5m(a): paged streams differ between the decode graph and the eager "
                             "step")
    moe_expert_gates("5m(a) paged serving", fused, cfg.num_layers, "moe_experts", 0)
    add(fused["launches"])
    sn = fused["snap"]
    log(f"5m(a) paged serving ({smi}): phase 5b's 15 requests, 16 slots (the blockwise route: "
        f"torch._grouped_mm under the capture), page 16, pool {fused['pool_gib']:.3f} GiB: every "
        f"request DONE, check() clean, one capture, launches a replay {fused['per_replay']}, the "
        f"eager step's streams identical; TTFT mean {sn['mean_ttft']:.4f} s, "
        f"{1e3 * fused['decode_s'] / max(fused['decode_executed'], 1):.2f} ms a decode-only step, "
        f"decode {sn['chunk_tokens_per_sec']:.1f} tok/s, peak occupancy {sn['peak_occupancy']}, "
        f"peak mem {fused['peak_gib']:.1f} GiB")
    pwork = prefix_workload(cfg.vocab_size)
    rec_wave = RouteRecorder(model)
    pre = serve_prefix(model, pwork, False, PrefixCache(),
                       on_measured=lambda engine: record_admissions(engine, rec_wave))
    hits = check_hit_logits(LogitsOnly(model), pre["engine"], pwork, rec=rec_wave)
    # the same hits with MX's plain version on their selective routes
    with plain_experts():
        plain_hits = check_hit_logits(LogitsOnly(model), pre["engine"], pwork, rec=rec_wave)
    rec_wave.close()
    for h, ph in zip(hits, plain_hits):
        h["plain_rel"] = max_err(h["hit"], ph["hit"]) / float(ph["hit"].abs().max())
        if h["plain_rel"] > 5e-2:
            raise AssertionError(f"5m(a) hit logits ({h['name']}): MX against its plain version "
                                 f"on the same route, rel {h['plain_rel']:.3g}")
    drain_prefix_store(pre)
    d = pre["delta"]
    if (d["prefix_hits"], d["prefix_misses"], d["prefix_validation_failures"]) != (11, 1, 0):
        raise AssertionError(f"5m(a) prefix wave: hits {d['prefix_hits']}, misses "
                             f"{d['prefix_misses']}; want 11, 1")
    add(pre["launches"])
    log(f"5m(a) prefix wave ({smi}): phase 5c's 12 requests on the row engine: hits "
        f"{d['prefix_hits']}, misses {d['prefix_misses']}, wall {pre['wall_s']:.3f} s; hit "
        f"logits against full prefills forced onto the hit's routes (phase 3's limits): "
        + "; ".join(
            f"{h['name']} rel_err {h['rel_err']:.3g} argmax equal {h['argmax_equal']} "
            f"({h['flips']} forced routes differ from the full prefill's own; unforced rel "
            f"{h['rel_unforced']:.3g}; against the plain experts on the same route "
            f"{h['plain_rel']:.3g})" for h in hits))
    del pre
    collect_engines()
    swap = moe_swap_leg(model, srv["workload"], srv["tokens"], smi)
    for launches in swap["launches"]:
        add(launches)
    out["a"]["swap_s"] = swap["swap_s"]
    del model
    collect_engines()  # the engines' reference cycles hold the 47 GB model

    # (b) int8 and fp8 against bf16 at 8 layers
    cfg8 = mixtral_8x7b(num_layers=MOE_LAYERS_QUANT)
    m8 = init_params(MixtralForCausalLM(cfg8), seed=0)
    out["b"] = {}
    for kind in ("int8", "fp8"):
        n0 = {k: c.launches for k, c in kernel_counters().items()}
        r = moe_quant_check(m8, QuantConfig(weights=kind).weight_qconfig(), gen)
        add({k: c.launches - n0[k] for k, c in kernel_counters().items()})
        out["b"][kind] = r
        log(f"5m(b) {kind} weights against bf16 ({smi}; {cfg8.num_layers} layers, 64-token prompt, "
            f"16 teacher-forced steps): median rel {r['median_rel']:.4g} (< 0.02), "
            f"{r['frac_under']:.4f} of logits under 0.1 (> 0.95), max rel {r['max_rel']:.4g}, max "
            f"KL {r['max_kl']:.4g} mean {r['mean_kl']:.4g}, top-1 {r['top1']:.3f}; weight bytes "
            f"{r['weight_bytes']}")
    del m8
    collect_engines()

    # (c) the full 32-layer Mixtral-8x7B, int8 weights
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    qcfg = QuantConfig(weights="int8").weight_qconfig()
    full = mixtral_8x7b(quantization=qcfg)
    qm = init_params(MixtralForCausalLM(full), seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in qm.state_dict().values())
    L = full.num_layers
    srv_c = serve_workload(qm, srv["workload"], dq=(4 * L + 1, 7 * L + 1))
    moe_expert_gates("5m(c)", srv_c, L, "moe_experts_quantized", L)
    if srv_c["per_replay"].get("dequantize") != 4 * L + 1:
        raise AssertionError(f"5m(c): DQ {srv_c['per_replay'].get('dequantize')} a replay, "
                             f"want {4 * L + 1}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak >= 72:
        raise AssertionError(f"5m(c): peak memory {peak:.2f} GiB, not under 72")
    add(srv_c["launches"])
    sc = srv_c["snap"]
    step_c = 1e3 * srv_c["decode_s"] / max(srv_c["decode_only_executed"], 1)
    out["c"] = dict(weight_bytes=weight_bytes, peak_gib=peak, step_ms=step_c,
                    tps=sc["chunk_tokens_per_sec"], ttft=sc["mean_ttft"],
                    per_replay=srv_c["per_replay"])
    log(f"5m(c) Mixtral-8x7B, all {L} layers, int8 weights ({smi}): {weight_bytes} B of weights "
        f"(filled weight by weight in {init_s:.1f} s), peak mem {peak:.2f} GiB (< 72); phase 4's 6 "
        f"requests, 8 slots: every request DONE; one capture, launches a replay "
        f"{srv_c['per_replay']}; TTFT mean {sc['mean_ttft']:.4f} s; {step_c:.2f} ms a decode-only "
        f"step; decode {sc['chunk_tokens_per_sec']:.1f} tok/s (chunk wall)")
    del qm
    collect_engines()
    return out



# --- phase 7c: Mixtral training ---------------------------------------------------

MIXTRAL_TRAIN_LAYERS = 2  # depth cut: 8x7B width, 2 layers (3,164,688,384 parameters, 50.6 GB of state)
MIXTRAL_EOS = 2           # Mixtral's </s>
MIXTRAL_TRAIN_STEPS = 6
MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_S = 2, 4096  # 7c(b)'s packed batch; (c) at B = 1
MIXTRAL_VS_PLAIN_S = 1024                   # 7c(a)'s one window
MIXTRAL_TRAIN_LR = 1e-3
# the stochastic training features of 7c(b) and (c): jitter, the shuffle, the blockwise route
MIXTRAL_STOCHASTIC = dict(router_jitter_eps=0.01, token_shuffle=True, expert_strategy="blockwise")
# 7c(c)'s width cut: the canary holds two state-sized snapshots beside the
# state (48 B a parameter), so the expert width is cut to a quarter
# (1,050,759,168 parameters, 50.4 GB with the snapshots); every other width is 8x7B's
MIXTRAL_CANARY_INTERMEDIATE = 3584
MIXTRAL_CANARY_EVERY = 2


def mixtral_train_config(**over):
    from neuronx_distributed_tpu_torch.models.mixtral import mixtral_8x7b

    return mixtral_8x7b(num_layers=MIXTRAL_TRAIN_LAYERS, **{**MIXTRAL_STOCHASTIC, **over})


def mixtral_loss_fn(model, deterministic: bool = False):
    """The MoE objective a Mixtral trains on (``model.loss``: cross entropy
    plus the weighted router losses), drawing its jitter and permutation
    from the step's generator."""
    def loss_fn(batch, generator):
        return model.loss(batch["input_ids"], batch["labels"],
                          segment_ids=batch.get("segment_ids"), loss_mask=batch.get("loss_mask"),
                          deterministic=deterministic, generator=generator)
    return loss_fn


def active_params(model) -> tuple:
    """``(matmul parameters a token runs through, all parameters)``: the
    weights of the products (not the embedding's lookup, not the norms),
    each expert stack counted at top_k / num_experts of its size (a token
    visits k of the E experts)."""
    cfg = model.config
    total = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for n, p in model.named_parameters() if ".moe.experts." in n)
    dense = sum(p.numel() for n, p in model.named_parameters()
                if p.dim() >= 2 and ".moe.experts." not in n) - model.model.embed.weight.numel()
    return dense + experts * cfg.top_k / cfg.num_experts, total


def mixtral_train_vs_plain(model) -> dict:
    """7c(a): one step's loss and every gradient at B = 1, S = 1024
    (packed, jitter and shuffle on, remat off) through the kernels (K1-K3,
    the blockwise grouped products) and through the plain path (plain
    attention and the all-experts einsums), the plain run forced onto the
    routes the kernel run's routers took (drawn from one step generator,
    so the jitter and the permutation are the same)."""
    import dataclasses

    from neuronx_distributed_tpu_torch.parallel.grads import global_grad_norm
    from neuronx_distributed_tpu_torch.trainer.trainer import _to_device, step_generator

    cfg = model.config
    model.model.config = dataclasses.replace(cfg, remat=False)
    batch = _to_device(packed_batch(cfg.vocab_size, 1, MIXTRAL_VS_PLAIN_S, seed=1,
                                    eos=MIXTRAL_EOS), model.device)
    loss_fn = mixtral_loss_fn(model)
    experts = [layer.moe.experts for layer in model.model.layers]
    params = [p for p in model.parameters() if p.requires_grad]
    rec = RouteRecorder(model)
    runs = []
    try:
        for plain in (False, True):
            gen = step_generator(1, 0, model.device)
            if plain:
                for e in experts:
                    e.strategy = "all_experts"
                with plain_attention(), forced_routes(model, forced) as flips:
                    loss = loss_fn(batch, gen)
                    loss.backward()
                n_flips = flips[0]
            else:
                loss = loss_fn(batch, gen)
                forced = rec.take()[0]  # (T, L, k): the kernel run's routes
                rec.close()
                loss.backward()
                n_flips = 0
            runs.append((float(loss.detach()), float(global_grad_norm([p.grad for p in params])),
                         {n: p.grad for n, p in model.named_parameters()}, n_flips))
            for p in params:
                p.grad = None
    finally:
        rec.close()
        for e in experts:
            e.strategy = cfg.expert_strategy
        model.model.config = cfg
    (lk, nk, gk, _), (lp, np_, gp, flips) = runs
    rel = {n: float((gk[n] - gp[n]).float().norm() / gp[n].float().norm().clamp_min(1e-30))
           for n in gk}
    worst = max(rel, key=rel.get)
    out = dict(loss=lk, loss_rel=abs(lk - lp) / abs(lp), gnorm_rel=abs(nk - np_) / np_,
               grad_rel=rel[worst], grad_worst=worst, flips=flips, leaves=len(rel),
               tokens=int(forced.shape[0]))
    del runs, gk, gp
    torch.cuda.empty_cache()
    # phase 6's limits: bf16 products, K1-K3 round P and dS to bf16, the
    # grouped products and the einsums sum in other orders
    if not (out["loss_rel"] <= 1e-3 and out["gnorm_rel"] <= 1e-2 and out["grad_rel"] <= 2e-2):
        raise AssertionError(f"7c(a): kernel path vs plain path: {out}")
    return out


def mixtral_step_profile(step, state, batch, optimizer) -> tuple:
    """One train step under the profiler, AdamW's update inside an
    ``adamw`` range: device ms by family (the grouped products, K1, K2, K3,
    the dense GEMMs, AdamW, the rest) and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    update = optimizer.update

    def ranged(*a, **kw):
        with record_function("adamw"):
            return update(*a, **kw)

    optimizer.update = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        optimizer.update = update
    fams = device_time_by_family(prof, {"grouped_mm": ("grouped", "Grouped", "GroupProblem"),
                                        "flash_attention": "flash_fwd_kernel",
                                        "flash_attention_dkdv": "flash_dkdv_kernel",
                                        "flash_attention_dq": "flash_dq_kernel"},
                                 skip=("adamw",))
    adamw = range_device_ms(prof, "adamw") or 0.0
    fams["adamw"] = adamw
    fams["other"] -= adamw  # AdamW's kernels are elementwise: "other" held them
    return fams, [k for k in top_kernels(prof, 9) if k[0] != "adamw"][:8]


def mixtral_canary_leg(steps: int) -> dict:
    """7c(c): ``Trainer.fit`` at the canary's width cut, B = 1, S = 4096,
    jitter and shuffle on: a sentinel-free fit, then the same fit with the
    canary every ``MIXTRAL_CANARY_EVERY`` steps; no check may disagree, and
    the losses and the final state's TF equal the sentinel-free run's."""
    from neuronx_distributed_tpu_torch.integrity import SentinelConfig
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_tpu_torch.trainer import OptimizerConfig, Trainer

    cfg = mixtral_train_config(intermediate_size=MIXTRAL_CANARY_INTERMEDIATE)
    model = MixtralForCausalLM(cfg, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    res, dispatches, tf_calls = {}, 0, 0
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for name, integrity in (("off", None),
                            ("canary", SentinelConfig(check_every=MIXTRAL_CANARY_EVERY))):
        rec = LoopRecorder()
        tr = Trainer(model=model, loss_fn=mixtral_loss_fn(model), callbacks=[rec],
                     integrity=integrity, optimizer_config=OptimizerConfig(
                         learning_rate=LOOP_LR, weight_decay=0.1, max_grad_norm=1.0))
        tr.fit(PackedSource(cfg.vocab_size, 1, MIXTRAL_TRAIN_S, eos=MIXTRAL_EOS), 0,
               max_steps=steps)
        torch.cuda.synchronize()
        s = tr._sentinel
        res[name] = dict(losses=rec.host_losses(), walls=rec.walls(), fp=state_fp(tr),
                         counters=dict(s.counters) if s else None, reads=tr.host_reads)
        dispatches += tr.programs.dispatches("train_step")
        tf_calls += 1 + (2 * s.counters["integrity_checks"] if s else 0)
        del tr, rec, s
        release()
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    del model
    release()
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=2 * cfg.num_layers * dispatches,
                flash_attention_dkdv=cfg.num_layers * dispatches,
                flash_attention_dq=cfg.num_layers * dispatches, tree_fingerprint=tf_calls)
    if launches != want:
        raise AssertionError(f"7c(c): launches {launches} != {want} ({dispatches} train-step "
                             f"dispatches)")
    checks = steps // MIXTRAL_CANARY_EVERY
    c = res["canary"]
    if c["counters"] != {"integrity_checks": checks, "sdc_detected": 0, "sdc_unlocalized": 0,
                         "sdc_rollbacks": 0}:
        raise AssertionError(f"7c(c): the canary's checks {c['counters']} (a false positive?)")
    if c["losses"] != res["off"]["losses"] or c["fp"] != res["off"]["fp"]:
        raise AssertionError("7c(c): the canary changed the run's losses or final bits")
    if peak >= 72 * 2**30:
        raise AssertionError(f"7c(c): peak memory {peak / 2**30:.2f} GiB >= 72 GiB")
    return dict(res, n_params=n_params, dispatches=dispatches, tf_calls=tf_calls,
                peak_gib=peak / 2**30, checks=checks, launches=launches)


def mixtral_train_phase(smi: str) -> dict:
    """Phase 7c: Mixtral training at 8x7B width cut to 2 layers, fp32
    masters, random weights from a seed. (a) the kernel path against the
    plain path on the routes the kernels took; (b) six ``build_train_step``
    steps on one packed 2 x 4096 batch (remat on, jitter 0.01, the shuffle,
    the blockwise route): the loss falls, the K1-K3 counts, the step wall,
    tokens/s, MFU by active parameters beside the ledger's metered FLOPs,
    peak memory, a profiled step and a re-run of one step's forward and
    backward from a fresh generator of the same (seed, step), equal in TF
    bits; (c) ``Trainer.fit`` with the canary (at a width cut)."""
    from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import TreeFingerprint
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM, init_params
    from neuronx_distributed_tpu_torch.observability.programs import ProgramLedger
    from neuronx_distributed_tpu_torch.trainer import (
        OptimizerConfig,
        build_train_step,
        create_train_state,
        make_optimizer,
    )
    from neuronx_distributed_tpu_torch.trainer.trainer import _to_device, step_generator

    t_phase = time.perf_counter()
    # phase 7b's trainers leave reference cycles that hold a 2-layer Llama
    # train state (22.2 GiB) until the cyclic collector runs
    release()
    resident = torch.cuda.memory_allocated()
    cfg = mixtral_train_config()
    steps = MIXTRAL_TRAIN_STEPS
    b, s = MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_S
    t0 = time.perf_counter()
    model = init_params(MixtralForCausalLM(cfg, trainable=True), seed=1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = dict(build_s=build_s, resident_gib=resident / 2**30)
    res["a"] = mixtral_train_vs_plain(model)

    opt_cfg = OptimizerConfig(learning_rate=MIXTRAL_TRAIN_LR, weight_decay=0.1, max_grad_norm=1.0)
    optimizer = make_optimizer(opt_cfg)
    t0 = time.perf_counter()
    state = create_train_state(model, optimizer, seed=0)
    loss_fn = mixtral_loss_fn(model)
    ledger = ProgramLedger(prefix="train", subsystem="trainer", device=model.device)
    step = ledger.wrap("train_step", build_train_step(model, optimizer,
                                                      max_grad_norm=opt_cfg.max_grad_norm,
                                                      loss_fn=loss_fn, seed=0), meter_first=True)
    batch = _to_device(packed_batch(cfg.vocab_size, b, s, eos=MIXTRAL_EOS), model.device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    active, n_params = active_params(model)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(counters, 0)  # no serving kernel: MX is decode only
    want.update(flash_attention=2 * cfg.num_layers * steps,
                flash_attention_dkdv=cfg.num_layers * steps,
                flash_attention_dq=cfg.num_layers * steps)
    if launches != want:
        raise AssertionError(f"7c(b): launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"7c(b): losses not finite and falling: {losses}")
    if peak >= 72 * 2**30:
        raise AssertionError(f"7c(b): peak memory {peak / 2**30:.2f} GiB >= 72 GiB")
    fams, heavy = mixtral_step_profile(step, state, batch, optimizer)

    # the same step's forward and backward twice, each from a generator made
    # afresh from (seed, step): equal TF bits over the loss and every gradient
    # (the state itself, 50.6 GB, cannot be copied on the card)
    params = [p for p in model.parameters() if p.requires_grad]
    fps = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(batch, step_generator(0, state.step, model.device))
        loss.backward()
        fps.append(int(TreeFingerprint([p.grad for p in params] + [loss.detach().reshape(1)])()))
    model.zero_grad(set_to_none=True)
    if fps[0] != fps[1]:
        raise AssertionError(f"7c(b): a re-run of step {state.step} differs: TF {fps}")

    seg = batch["segment_ids"]
    pairs = live_pairs(seg, b, s, seg.device)
    d, h = cfg.head_dim_, cfg.num_heads
    # model FLOPs: 6 per active matmul parameter per token (fwd + bwd; a
    # token runs through k of the E experts) and attention's products, 12 x
    # D x H per live pair; the remat recompute is not counted
    flops = 6.0 * active * b * s + 12.0 * d * h * pairs * cfg.num_layers
    wall = statistics.median(walls[1:])
    metered = ledger.flops_per_dispatch("train_step")
    del state, step, optimizer, params, batch
    model.zero_grad(set_to_none=True)
    del model
    release()
    res["b"] = dict(losses=losses, walls=walls, wall=wall, tokens_per_s=b * s / wall, flops=flops,
                    mfu=flops / wall / PEAK_BF16_FLOPS, metered_flops=metered,
                    metered_mfu=metered / wall / PEAK_BF16_FLOPS, peak_gib=peak / 2**30,
                    launches=launches, fams=fams, heavy=heavy, n_params=n_params,
                    active=active, init_s=init_s, pairs=pairs, docs=int(seg.max()) + 1, fps=fps)
    res["c"] = c = mixtral_canary_leg(MIXTRAL_TRAIN_STEPS)
    res.update(launches={name: launches[name] + c["launches"][name] for name in launches},
               wall_s=time.perf_counter() - t_phase)
    return res


def log_mixtral_train_phase(mt: dict, smi: str) -> None:
    """Phase 7c's report lines."""
    cfg = mixtral_train_config()
    a, b, c = mt["a"], mt["b"], mt["c"]
    log(f"phase 7c ({smi}): Mixtral training, 8x7B width cut to {MIXTRAL_TRAIN_LAYERS} layers "
        f"(hidden {cfg.hidden_size}, {cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} "
        f"experts top-{cfg.top_k}, intermediate {cfg.intermediate_size}, vocab {cfg.vocab_size}; "
        f"{b['n_params']} parameters, {b['active']:.0f} active matmul parameters a token), fp32 "
        f"masters, AdamW lr {MIXTRAL_TRAIN_LR} wd 0.1 clip 1.0, random weights from a seed (built "
        f"and filled in {mt['build_s']:.2f} s); {mt['resident_gib']:.2f} GiB allocated on entry; "
        f"wall {mt['wall_s']:.1f} s")
    log(f"7c(a) kernel path vs plain path (B = 1, S = {MIXTRAL_VS_PLAIN_S} packed, one step, "
        f"jitter and shuffle on, remat off; the plain path: plain attention and the all-experts "
        f"einsums on the "
        f"kernel run's routes for {a['tokens']} tokens x {MIXTRAL_TRAIN_LAYERS} layers, "
        f"{a['flips']} forced routes its own routers would not have chosen): loss "
        f"{a['loss']:.5f} rel_err {a['loss_rel']:.3g}, grad norm rel_err {a['gnorm_rel']:.3g}, "
        f"every gradient ({a['leaves']} leaves) rel_err <= {a['grad_rel']:.3g} ({a['grad_worst']})")
    log(f"7c(b) build_train_step, one packed batch {MIXTRAL_TRAIN_B} x {MIXTRAL_TRAIN_S} "
        f"({b['docs']} documents, {b['pairs']} live attention pairs a head), remat on, jitter "
        f"0.01, token shuffle, "
        f"blockwise route; train state from seed 0 in {b['init_s']:.2f} s; losses "
        + ", ".join(f"{x:.5f}" for x in b["losses"]) + "; step walls (s): "
        + ", ".join(f"{x:.4f}" for x in b["walls"]) + " (the first metered)")
    log(f"7c(b): step wall {b['wall']:.4f} s (median of steps 2-{MIXTRAL_TRAIN_STEPS}), "
        f"{b['tokens_per_s']:.1f} tokens/s, model {b['flops'] / b['wall'] / 1e12:.1f} TFLOP/s by "
        f"active parameters (6 x active x tokens + attention, no recompute): mfu {b['mfu']:.4f} "
        f"of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; the ledger's metered train_step "
        f"{b['metered_flops']:.5g} FLOPs (remat recompute, AdamW and the aux losses included): "
        f"mfu {b['metered_mfu']:.4f}; peak mem {b['peak_gib']:.2f} GiB (< 72)")
    log(f"7c(b) launches ({MIXTRAL_TRAIN_STEPS} steps): {b['launches']} (K1 = 2 x "
        f"{MIXTRAL_TRAIN_LAYERS} layers x steps: forward and remat recompute; K2 = K3 = "
        f"{MIXTRAL_TRAIN_LAYERS} x steps); a re-run of a step's forward and backward from a "
        f"fresh generator of the same (seed, step): TF {b['fps'][0]:#018x} twice")
    busy = sum(b["fams"].values())
    wall_ms = 1e3 * b["wall"]
    log("7c(b) device time of one step (profiler, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in b["fams"].items())
        + f"; busy {busy:.2f} of the unprofiled step wall {wall_ms:.2f} (idle share "
        f"{1 - busy / wall_ms:.3f}); heaviest kernels: "
        + "; ".join(f"{n[:80]} {ms:.2f} ms x{k}" for n, ms, k in b["heavy"]))
    cc, off = c["canary"], c["off"]
    log(f"7c(c) Trainer.fit, {MIXTRAL_TRAIN_STEPS} steps at B = 1, S = {MIXTRAL_TRAIN_S}, "
        f"jitter and shuffle on, at the canary's width cut (intermediate {MIXTRAL_CANARY_INTERMEDIATE}: two "
        f"state-sized snapshots beside the state; {c['n_params']} parameters): "
        f"SentinelConfig(check_every={MIXTRAL_CANARY_EVERY}) {cc['counters']}; losses and final "
        f"TF {cc['fp']:#018x} = the sentinel-off run's; step walls off "
        + ", ".join(f"{x:.4f}" for x in off["walls"]) + " s, canary "
        + ", ".join(f"{x:.4f}" for x in cc["walls"]) + f" s; host reads {cc['reads']}; peak "
        f"{c['peak_gib']:.2f} GiB")
    log(f"7c launches (b) and (c): {mt['launches']}")


# --- phase 2, head_dim 96: the builds of K1, K4 and K5 GPT-NeoX-20B runs on ---

NEOX_H, NEOX_D, NEOX_L = 64, 96, 2048  # GPT-NeoX-20B: 64 heads of 96, a kv-head a head, 2048 columns
D96_DECODE = (  # (name, s, slots, bound): the decode step, the verify window, a suffix prefill
    ("step", 1, 8, 1540), ("verify", 16, 8, 1540), ("multi_row", 1024, 1, 2000))


def check_d96_k1(gen) -> dict:
    """K1's head_dim-96 build at GPT-NeoX-20B's longest serving prefill: B=1,
    S=2048, H=Hkv=64, D=96, causal, 77 columns of left padding;
    :func:`check_k1`'s checks and times, its bound on D = 96's own FLOPs and
    bytes (the kernel computes on 128-column tiles: 4/3 of them)."""
    return check_k1(gen, 1, NEOX_L, 77, h=NEOX_H, hkv=NEOX_H, d=NEOX_D)


def d96_decode_inputs(gen, s: int, b: int, bound_cols: int):
    """K4's inputs at GPT-NeoX-20B's geometry: q (B, s, 64, 96), a row cache
    (B, 2048, 64, 96), positions ``bound - s .. bound - 1``; slot i valid
    from column 100 i to the bound, and then: at s = 1 10% gap columns at
    random; at 1 < s <= 32 (a verify window, R = s) the gaps rejected drafts
    leave over the last 512 columns (``rejected_gaps``); above (a suffix
    prefill on the multi-row path) a 3-token pad tail."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    q = torch.randn(b, s, NEOX_H, NEOX_D, generator=gen, device=dev).to(bf)
    kc = torch.randn(b, NEOX_L, NEOX_H, NEOX_D, generator=gen, device=dev).to(bf)
    vc = torch.randn(b, NEOX_L, NEOX_H, NEOX_D, generator=gen, device=dev).to(bf)
    pos = torch.arange(bound_cols - s, bound_cols, dtype=torch.int32, device=dev)
    valid = torch.zeros(b, NEOX_L, dtype=torch.bool, device=dev)
    for i in range(b):
        valid[i, 100 * i:bound_cols] = True
    if s == 1:
        valid &= torch.rand(b, NEOX_L, generator=gen, device=dev) > 0.1
    elif s <= 32:
        start = torch.full((b,), bound_cols - 512, device=dev)
        valid &= ~rejected_gaps(gen, start, NEOX_L, bound_cols, s)
    else:
        valid[:, bound_cols - 3:] = False
    return q, kc, vc, pos, valid


def scrambled_pool(kc, vc, valid, ps: int = 16, seed: int = 11):
    """Pools and a numpy-seeded scrambled block table for a (B, L) row
    cache: every logical page holding a valid column maps to a random pool
    page holding its columns, the rest to page 0, filled with garbage x 64."""
    import numpy as np

    b, L, hkv, d = kc.shape
    n_log = L // ps
    mapped = valid.reshape(b, n_log, ps).any(-1).cpu().numpy()
    perm = np.random.default_rng(seed).permutation(np.arange(1, int(mapped.sum()) + 1))
    kp = torch.randn(len(perm) + 1, ps, hkv, d, device=kc.device).to(kc.dtype).mul_(64.0)
    vp = torch.randn(len(perm) + 1, ps, hkv, d, device=kc.device).to(kc.dtype).mul_(64.0)
    table = np.zeros((b, n_log), np.int32)
    table[mapped] = perm
    idx = torch.from_numpy(perm).long().to(kc.device)
    src = torch.from_numpy(np.flatnonzero(mapped.reshape(-1))).long().to(kc.device)
    kp[idx] = kc.reshape(b * n_log, ps, hkv, d)[src]
    vp[idx] = vc.reshape(b * n_log, ps, hkv, d)[src]
    return kp, vp, torch.from_numpy(table).to(kc.device)


def check_d96_decode(gen, s: int, b: int, bound_cols: int) -> dict:
    """K4's and K5's head_dim-96 builds at :func:`d96_decode_inputs`: K4
    against its plain version within K4's limit (a kernel that dropped the
    last, partial 64-column tile must fail it), twice for the same bits; K5
    through a scrambled table (page 16, a garbage null page) bitwise equal
    to K4 on the gathered view; both launched on the 96 build alone. Times
    as CUDA-graph replays beside the plain versions', the bound (D = 96's
    own FLOPs and bytes; K5's table entries too) and SDPA's on the row view
    (boolean mask)."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        flash_decode_plain,
        paged_flash_decode_fwd,
        paged_flash_decode_plain,
        paged_gather_leaf,
    )

    ps = 16
    q, kc, vc, pos, valid = d96_decode_inputs(gen, s, b, bound_cols)
    n128 = (flash_decode_fwd.launches, paged_flash_decode_fwd.launches)
    n96 = (flash_decode_fwd.d96.launches, paged_flash_decode_fwd.d96.launches)
    out, lse = flash_decode_fwd(q, kc, vc, pos, valid)
    again, again_lse = flash_decode_fwd(q, kc, vc, pos, valid)
    kp, vp, bt = scrambled_pool(kc, vc, valid, ps)
    paged, paged_lse = paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    if ((flash_decode_fwd.launches, paged_flash_decode_fwd.launches) != n128
            or (flash_decode_fwd.d96.launches, paged_flash_decode_fwd.d96.launches)
            != (n96[0] + 2, n96[1] + 1)):
        raise AssertionError("head_dim 96: K4/K5 launched another build than the 96 one")
    kg, vg = paged_gather_leaf(kp, bt, ps), paged_gather_leaf(vp, bt, ps)
    row, row_lse = flash_decode_fwd(q, kg, vg, pos, valid)
    ref, ref_lse = flash_decode_plain(q, kc, vc, pos, valid)
    pv = flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    cut = valid.clone()
    cut[:, (bound_cols - 1) // 64 * 64:bound_cols] = False
    fault = flash_decode_plain(q, kc, vc, pos, cut)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K4_PV), tol_ratio(fault, ref, pv, K4_PV)
    tag = f"K4/K5 head_dim 96 (s={s}, B={b})"
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"{tag}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"{tag}: the output limit passes a dropped tile ({fault_ratio:.3g}x)")
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{tag}: two runs differ in their bits")
    if not (torch.equal(paged, row) and torch.equal(paged_lse, row_lse)):
        raise AssertionError(f"{tag}: K5 differs from K4 on the gathered view (must be bitwise equal)")
    del ref, pv, fault
    bound, bound_by, nbytes = decode_bound(q, valid, pos, bound_cols, NEOX_H)
    pbound = decode_bound(q, valid, pos, bound_cols, NEOX_H,
                          extra_bytes=4 * b * -(-bound_cols // ps))[0]
    mask = row_masks(valid, pos)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
    return dict(
        s=s, b=b, bound_cols=bound_cols, rows=s, err=max(err, lerr), ratio=ratio,
        fault_ratio=fault_ratio, bound_ms=bound, bound_by=bound_by, paged_bound_ms=pbound,
        bytes=nbytes, live_cols=int(valid[:, :bound_cols].sum()), pages=kp.shape[0],
        ms=graph_ms(lambda: flash_decode_fwd(q, kc, vc, pos, valid), 10),
        paged_ms=graph_ms(lambda: paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps), 10),
        plain_ms=cuda_ms(lambda: flash_decode_plain(q, kc, vc, pos, valid), 3, warmup=1),
        paged_plain_ms=cuda_ms(lambda: paged_flash_decode_plain(q, kp, vp, bt, pos, valid, ps), 3,
                               warmup=1),
        library_ms=graph_ms(sdpa, 10))


def log_d96(k1: dict, dec: dict, smi: str) -> None:
    log(f"K1 flash_attention_d96 ({smi}; the head_dim-96 build) B=1 S={NEOX_L} H=Hkv={NEOX_H} "
        f"D={NEOX_D} causal pad 77 (GPT-NeoX-20B's prefill): max_err {k1['err']:.3g} "
        f"({k1['ratio']:.3g}x its limit; a dropped K tile reads {k1['fault_ratio']:.3g}x); two "
        f"runs bitwise equal; kernel_ms {k1['ms']:.4f} (graph replay; back to back "
        f"{k1['eager_ms']:.4f}) plain_ms {k1['plain_ms']:.4f} bound_ms {k1['bound_ms']:.4f} "
        f"({k1['bound_by']}, D = 96's own work; {k1['ms'] / k1['bound_ms']:.2f}x, "
        f"{k1['tflops']:.1f} TFLOP/s) library_ms {k1['library_ms']:.4f} (SDPA, bool mask; graph "
        f"replay); tile plan {k1['plan']['blocks']} blocks, {k1['plan']['visited']} visited "
        f"tile pairs ({k1['plan']['work_over_bound']:.3f}x the live pairs)")
    for name, r in dec.items():
        path = "multi-row" if r["rows"] > 32 else "split"
        log(f"K4/K5 flash_decode_d96 / paged_flash_decode_d96 ({smi}; {name}: B={r['b']} "
            f"s={r['s']} (R={r['rows']}, the {path} path) H=Hkv={NEOX_H} D={NEOX_D} L={NEOX_L} "
            f"bound {r['bound_cols']}, {r['live_cols']} live columns; K5 page 16 through a "
            f"scrambled table of {r['pages']} pages, garbage null page): max_err {r['err']:.3g} "
            f"({r['ratio']:.3g}x its limit; a dropped tile reads {r['fault_ratio']:.3g}x); two "
            f"runs bitwise equal, K5 bitwise equal to K4 on the gathered view; K4 kernel_ms "
            f"{r['ms']:.4f} K5 kernel_ms {r['paged_ms']:.4f} (graph replays) plain_ms "
            f"{r['plain_ms']:.4f} (K5's {r['paged_plain_ms']:.4f}) bound_ms {r['bound_ms']:.5f} "
            f"({r['bound_by']}, {r['bytes']} B; K5's {r['paged_bound_ms']:.5f}; "
            f"{r['ms'] / r['bound_ms']:.2f}x) library_ms {r['library_ms']:.4f} (SDPA, bool mask, "
            f"on the row view; graph replay)")


# --- phase 5n: the other decoder families -----------------------------------------

# phase 4's six requests with the prompts a 2048-column model holds (2000 +
# 32 new tokens at most)
FAMILY_LENGTHS = (30, 250, 700, 1100, 1500, 2000)
DBRX_LAYERS, DBRX_SEQ = 8, 4096  # DBRX's cuts: 8 of its 40 layers, 4096 of its 32768 columns
ATTENTION_KERNELS = ("flash_attention", "flash_attention_d96", "flash_decode", "flash_decode_d96",
                     "paged_flash_decode", "paged_flash_decode_d96", "qpaged_flash_decode",
                     "qpaged_write_attend", "flash_attention_dkdv", "flash_attention_dq",
                     "window_requantize")


def family_workload(vocab: int, lengths, gen):
    """Phase 4's workload at ``lengths``: 32 new tokens each, greedy but for
    the third request (temperature 0.8, top_k 50)."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    prompts = [torch.randint(1, vocab, (n,), generator=gen, device="cuda").cpu().numpy()
               for n in lengths]
    cfgs = [GenerationConfig(max_new_tokens=32, temperature=0.0) for _ in lengths]
    cfgs[2] = GenerationConfig(max_new_tokens=32, temperature=0.8, top_k=50)
    return prompts, cfgs


def family_serve(model, workload, paged: bool, eager: bool = False, witness=None) -> dict:
    """Phase 4's run on one engine over a family's model: 8 slots, chunk 8,
    no prefix cache (paged: page 16 and a pool of ROW_SLOTS row slots' bytes
    plus the null page), the decode step one CUDA graph (``eager``: the
    eager step, or ``witness(engine)``'s context). Every kernel's launch
    count is zeroed just before and read just after: every request DONE
    with its 32 tokens; K1 a prefill and K4 (paged: K5) an executed step
    once a layer, all on the build of the model's head dim, no other
    attention kernel."""
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    cfg = model.config
    layers, sfx = cfg.num_layers, "_d96" if cfg.head_dim_ == 96 else ""
    kw = dict(kv_page_size=PAGE, kv_num_pages=ROW_SLOTS * cfg.max_seq_len // PAGE + 1) if paged else {}
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8, prefix_cache=None, **kw)
    prompts, cfgs = workload
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    ctx = ((witness(engine) if witness is not None else eager_decode_step()) if eager
           else contextlib.nullcontext())
    with ctx:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
        engine.step()  # admits all six: six prefills, then one decode chunk
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        executed0 = engine.metrics.executed_steps
        engine.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches, warm = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    what = f"{type(model).__name__} {'paged' if paged else 'row'}{' eager' if eager else ''}"
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != r.config.max_new_tokens:
            raise AssertionError(f"{what}: request {r.rid} {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"{what}: request {r.rid}: a token outside the vocabulary")
    snap = engine.metrics.snapshot()
    want = dict.fromkeys(ATTENTION_KERNELS, 0)
    want["flash_attention" + sfx] = snap["prefills"] * layers
    want[("paged_flash_decode" if paged else "flash_decode") + sfx] = snap["executed_steps"] * layers
    got = {k: launches[k] - warm[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: attention launches {got} != {want}")
    if paged:
        engine.cache.check()
    check_program(engine, what, eager)
    prog = decode_program(engine)
    res = dict(tokens=[list(r.tokens) for r in reqs], rids=[r.rid for r in reqs],
               launches=launches, snap=snap, wall_s=t2 - t0, admit_s=t1 - t0, decode_s=t2 - t1,
               decode_only_executed=snap["executed_steps"] - executed0,
               replays=prog.replays if prog is not None else None,
               per_replay=dict(prog.launches_per_replay) if prog is not None else None)
    del engine
    collect_engines()
    return res


def family_line(what: str, r: dict) -> str:
    sn = r["snap"]
    return (f"{what}: every request DONE with 32 tokens; {sn['prefills']} prefills, "
            f"{sn['executed_steps']} decode steps executed, one capture, {r['replays']} replays, "
            f"launches a replay {r['per_replay']}; TTFT mean {sn['mean_ttft']:.4f} s max "
            f"{sn['max_ttft']:.4f} s; {1e3 * r['decode_s'] / max(r['decode_only_executed'], 1):.2f}"
            f" ms a decode-only step; decode {sn['chunk_tokens_per_sec']:.1f} tok/s (chunk "
            f"wall); wall {r['wall_s']:.3f} s")


def greedy_solo(model, workload) -> list:
    """Solo ``generate`` of each greedy request of ``workload`` (None for a
    sampled one)."""
    from neuronx_distributed_tpu_torch.inference.generate import generate

    prompts, cfgs = workload
    return [generate(model, torch.tensor(p[None]), c).cpu()[0].tolist()
            if c.temperature == 0.0 else None for p, c in zip(prompts, cfgs)]


def agreement(a: list, b: list, cfgs) -> str:
    """Equal tokens over the greedy requests' streams (``cfgs``' greedy
    ones; None: no stream), as ``n/m``."""
    pairs = [(x, y) for x, y, c in zip(a, b, cfgs)
             if x is not None and y is not None and c.temperature == 0.0]
    return f"{sum(u == v for x, y in pairs for u, v in zip(x, y))}/{sum(len(x) for x, _ in pairs)}"


def dense_family(name: str, model, workload, paged: bool) -> dict:
    """A dense family (GPT-NeoX, CodeGen) served: the row engine and its
    eager witness (the same streams bit for bit), the paged engine
    (``paged``), solo ``generate`` of the greedy requests; every greedy
    token of each within phase 3's limit of its row's maximum logit in a
    teacher-forced pass; peak memory."""
    row = family_serve(model, workload, False)
    wit = family_serve(model, workload, False, eager=True)
    if wit["tokens"] != row["tokens"]:
        raise AssertionError(f"{name}: row streams differ between the decode graph and the eager step")
    runs = {"row": row}
    if paged:
        runs["paged"] = family_serve(model, workload, True)
    solo = greedy_solo(model, workload)
    prompts, cfgs = workload
    teach = {k: teacher_ratio(model, workload, r["tokens"]) for k, r in runs.items()}
    greedy = [i for i, c in enumerate(cfgs) if c.temperature == 0.0]
    teach["solo"] = teacher_ratio(model, ([prompts[i] for i in greedy], [cfgs[i] for i in greedy]),
                                  [solo[i] for i in greedy])
    if max(teach.values()) > 1.0:
        raise AssertionError(f"{name}: a greedy token is past phase 3's limit from its row's "
                             f"maximum, teacher-forced: {teach}")
    return dict(runs=runs, solo=solo, teach=teach,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                solo_agree=agreement(solo, row["tokens"], cfgs),
                paged_agree=(agreement(runs["paged"]["tokens"], row["tokens"], cfgs) if paged
                             else None))


def family_phase(smi: str) -> dict:
    """Phase 5n: the other decoder families at full width, weights from seed
    0 filled on the card weight by weight (``init_params``), bf16, each freed
    (collected first) before the next. (a) GPT-NeoX-20B whole (44 layers,
    head_dim 96: the 96 builds of K1, K4 and K5, every 128 count 0): phase 4's
    requests (prompts cut to 2048 columns) through the row engine, its eager
    witness, the paged engine and solo ``generate``, peak memory under 72
    GiB. (b) CodeGen2.5-7B whole (head_dim 128): the same on the row engine
    and solo ``generate``. (c) DBRX at full width cut to DBRX_LAYERS layers
    and DBRX_SEQ columns: phase 4's requests through the row engine (its
    decode step on MX, DBRX_LAYERS a replay; prefills on the blockwise
    route), its eager witness recording the routes, every greedy token
    within phase 3's limit teacher-forced on the routes that served it; the
    same through the paged engine and its recording witness, with where the
    two engines' streams first part."""
    from neuronx_distributed_tpu_torch.models import (
        CodeGenForCausalLM,
        DbrxForCausalLM,
        GPTNeoXForCausalLM,
        codegen25_7b,
        dbrx_base,
        gpt_neox_20b,
    )
    from neuronx_distributed_tpu_torch.models.gpt_neox import init_params
    import numpy as np

    out = {"launches": dict.fromkeys(kernel_counters(), 0)}
    gen = torch.Generator(device="cuda").manual_seed(25)

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] += v

    def build(cls, cfg):
        collect_engines()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_params(cls(cfg), seed=0)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        return model, n, time.perf_counter() - t0

    # (a) GPT-NeoX-20B, all 44 layers
    cfg = gpt_neox_20b()
    model, n, init_s = build(GPTNeoXForCausalLM, cfg)
    log(f"5n(a) model: gpt_neox_20b, all {cfg.num_layers} layers, head_dim {cfg.head_dim_} "
        f"({cfg.hidden_size} / {cfg.num_heads}), {n / 1e9:.3f} B params bf16 "
        f"({2 * n / 1e9:.2f} GB; norms f32), filled on the card in {init_s:.1f} s")
    wl = family_workload(cfg.vocab_size, FAMILY_LENGTHS, gen)
    neox = dense_family("5n(a) GPT-NeoX-20B", model, wl, paged=True)
    if neox["peak_gib"] >= 72:
        raise AssertionError(f"5n(a): peak memory {neox['peak_gib']:.2f} GiB, not under 72")
    for k, r in neox["runs"].items():
        add(r["launches"])
        log(family_line(f"5n(a) GPT-NeoX-20B {k} engine ({smi}; phase 4's 6 requests at "
                        f"{FAMILY_LENGTHS} tokens, 8 slots, chunk 8"
                        + (", page 16" if k == "paged" else "") + ")", r))
    log(f"5n(a) GPT-NeoX-20B ({smi}): the eager step's row streams identical; greedy tokens "
        f"teacher-forced: largest gap {max(neox['teach'].values()):.3g}x phase 3's limit (<= 1; "
        f"row, paged, solo generate: {neox['teach']}); paged = row on {neox['paged_agree']} "
        f"greedy tokens, solo generate = row on {neox['solo_agree']}; launches of the 96 "
        f"builds: K1 {out['launches']['flash_attention_d96']} (= prefills x 44), K4 "
        f"{out['launches']['flash_decode_d96']}, K5 {out['launches']['paged_flash_decode_d96']} "
        f"(= (replays + warm-up) x 44), every head_dim-128 attention count 0; peak mem "
        f"{neox['peak_gib']:.2f} GiB (< 72)")
    out["a"] = dict(n_params=n, peak_gib=neox["peak_gib"],
                    ttft=neox["runs"]["row"]["snap"]["mean_ttft"],
                    tps=neox["runs"]["row"]["snap"]["chunk_tokens_per_sec"],
                    paged_tps=neox["runs"]["paged"]["snap"]["chunk_tokens_per_sec"])
    del model, neox
    collect_engines()

    # (b) CodeGen2.5-7B, all 32 layers
    cfg = codegen25_7b()
    model, n, init_s = build(CodeGenForCausalLM, cfg)
    log(f"5n(b) model: codegen25_7b, all {cfg.num_layers} layers, head_dim {cfg.head_dim_}, "
        f"{n / 1e9:.3f} B params bf16, filled on the card in {init_s:.1f} s")
    wl = family_workload(cfg.vocab_size, FAMILY_LENGTHS, gen)
    cg = dense_family("5n(b) CodeGen2.5-7B", model, wl, paged=False)
    add(cg["runs"]["row"]["launches"])
    log(family_line(f"5n(b) CodeGen2.5-7B row engine ({smi}; phase 4's 6 requests at "
                    f"{FAMILY_LENGTHS} tokens, 8 slots, chunk 8)", cg["runs"]["row"]))
    log(f"5n(b) CodeGen2.5-7B ({smi}): the eager step's streams identical; greedy tokens "
        f"teacher-forced: largest gap {max(cg['teach'].values()):.3g}x phase 3's limit; solo "
        f"generate = row on {cg['solo_agree']} greedy tokens; K1 and K4 on the head_dim-128 "
        f"builds, every 96 count 0; peak mem {cg['peak_gib']:.2f} GiB")
    out["b"] = dict(n_params=n, ttft=cg["runs"]["row"]["snap"]["mean_ttft"],
                    tps=cg["runs"]["row"]["snap"]["chunk_tokens_per_sec"])
    del model, cg
    collect_engines()

    # (c) DBRX at full width, cut in depth and context
    cfg = dbrx_base(num_layers=DBRX_LAYERS, max_seq_len=DBRX_SEQ)
    model, n, init_s = build(DbrxForCausalLM, cfg)
    log(f"5n(c) model: dbrx_base cut to {cfg.num_layers} of 40 layers and {cfg.max_seq_len} "
        f"columns (widths kept: hidden {cfg.hidden_size}, {cfg.num_heads}/{cfg.num_kv_heads} "
        f"heads, {cfg.num_experts} experts top-{cfg.top_k}, intermediate {cfg.intermediate_size}),"
        f" {n / 1e9:.3f} B params bf16 ({2 * n / 1e9:.2f} GB; routers f32), filled on the card "
        f"in {init_s:.1f} s")
    wl = family_workload(cfg.vocab_size, (30, 250, 700, 1500, 2200, 3000), gen)
    prompts, cfgs = wl
    row = family_serve(model, wl, False)
    moe_expert_gates("5n(c) row serving", row, cfg.num_layers, "moe_experts", cfg.num_layers)
    rec, steps = RouteRecorder(model), {}
    wit = family_serve(model, wl, False, eager=True,
                       witness=lambda engine: recorded_eager_steps(engine, rec, steps))
    rec.close()
    if wit["tokens"] != row["tokens"]:
        raise AssertionError("5n(c): row streams differ between the decode graph and the eager step")
    greedy = [i for i, c in enumerate(cfgs) if c.temperature == 0.0]
    for i in greedy:
        file_decode_routes(rec, steps, wit["rids"][i], prompts[i], wit["tokens"][i])
    paged = family_serve(model, wl, True)
    moe_expert_gates("5n(c) paged serving", paged, cfg.num_layers, "moe_experts", cfg.num_layers)
    prec, psteps = RouteRecorder(model), {}
    pwit = family_serve(model, wl, True, eager=True,
                        witness=lambda engine: recorded_eager_steps(engine, prec, psteps))
    prec.close()
    if pwit["tokens"] != paged["tokens"]:
        raise AssertionError("5n(c): paged streams differ between the decode graph and the eager step")
    for i in greedy:
        file_decode_routes(prec, psteps, pwit["rids"][i], prompts[i], pwit["tokens"][i])
    teach = moe_teacher_ratio(model, [(rec, prompts[i], row["tokens"][i]) for i in greedy]
                              + [(prec, prompts[i], paged["tokens"][i]) for i in greedy])
    if teach["ratio"] > 1.0:
        raise AssertionError(f"5n(c): a served greedy token is {teach['ratio']:.3g}x phase 3's "
                             f"limit from its row's maximum, teacher-forced on its own routes")
    # where the row and paged engines part: each greedy request's first
    # differing token and, within the context they share, the first
    # position and layer at which their routes differ
    partings = []
    for i in greedy:
        a, b = row["tokens"][i], paged["tokens"][i]
        jd = next((j for j, (u, v) in enumerate(zip(a, b)) if u != v), None)
        if jd is None:
            partings.append(f"request {i} identical")
            continue
        shared = np.concatenate([prompts[i], a[:jd]])
        first = first_route_difference(rec.routes_for(shared), prec.routes_for(shared))
        partings.append(f"request {i} at token {jd}, routes first differ at "
                        + (f"position {first[0]} (prompt {len(prompts[i])}), layer {first[1]}"
                           if first else "no position"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in (row, paged):
        add(r["launches"])
    for k, r in (("row", row), ("paged", paged)):
        log(family_line(f"5n(c) DBRX ({cfg.num_layers} layers) {k} engine ({smi}; phase 4's 6 "
                        f"requests, 8 slots, chunk 8" + (", page 16" if k == "paged" else "")
                        + ")", r))
    log(f"5n(c) DBRX ({smi}): the eager step's streams identical; MX {cfg.num_layers} a replay "
        f"(top-{cfg.top_k} of {cfg.num_experts} at 8 slots); the greedy tokens teacher-forced on "
        f"the routes that served them: largest gap {teach['ratio']:.3g}x phase 3's limit (<= 1); "
        f"of the {teach['forced']} forced (token, layer) routes, {teach['flips']} differ from the "
        f"forward's own top-{cfg.top_k} (row and paged engines, each through its eager witness "
        f"with the same streams); paged = row on {agreement(row['tokens'], paged['tokens'], cfgs)} "
        f"greedy tokens, where they part: {'; '.join(partings)}; peak mem {peak:.2f} GiB")
    out["c"] = dict(n_params=n, peak_gib=peak, ttft=row["snap"]["mean_ttft"],
                    tps=row["snap"]["chunk_tokens_per_sec"])
    del model
    collect_engines()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    t0 = time.perf_counter()
    _build.build(["flash_attention", "flash_attention_bwd", "flash_decode", "dequantize",
                  "kv_quant", "page_fingerprint", "tree_fingerprint", "moe_experts",
                  "flash_attention_d96", "flash_decode_d96"])
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, the eight sources and the "
        f"head_dim-96 builds of two of them, ten libraries in parallel)")
    for r in [fwd_resources(), *bwd_resources()]:
        log(f"{r['kernel']}: {r['smem']} B dynamic shared memory a block, {r['regs']} registers a "
            f"thread at entry, {r['local']} B local a thread, {r['blocks_per_sm']} block(s) per SM; "
            f"ptxas: {r['ptxas']}")
    dres, n_spill_lines = decode_resources()
    for r in dres:
        log(f"{r['kernel']}: {r['smem']} B dynamic shared memory a block, {r['regs']} registers a "
            f"thread, {r['local']} B local a thread, {r['blocks_per_sm']} block(s) per SM")
    log(f"ptxas -v, csrc/flash_decode.cu: {n_spill_lines} kernels, none spills")
    log("ptxas -v, the head_dim-96 builds (-DNXD_HEAD_DIM=96; no serialized wgmma): "
        + "; ".join(d96_resources()))
    qw_spills = [line.strip() for line in _build.resource_report("kv_quant").splitlines()
                 if "spill" in line]
    if not qw_spills or any("0 bytes spill stores, 0 bytes spill loads" not in line
                            for line in qw_spills):
        raise AssertionError("QW spills or was not reported:\n" + "\n".join(qw_spills))
    log(f"ptxas -v, csrc/kv_quant.cu: {len(qw_spills)} kernel, no spill")
    pf_lines = [line.strip() for line in _build.resource_report("page_fingerprint").splitlines()
                if "registers" in line or "spill" in line]
    if not any("spill" in line for line in pf_lines) or any(
            "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
            for line in pf_lines):
        raise AssertionError("PF spills or was not reported:\n" + "\n".join(pf_lines))
    log("ptxas -v, csrc/page_fingerprint.cu (PF: the page kernel, the combine kernel): "
        + "; ".join(pf_lines))
    tf_lines = [line.strip() for line in _build.resource_report("tree_fingerprint").splitlines()
                if "registers" in line or "spill" in line]
    if not any("spill" in line for line in tf_lines) or any(
            "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
            for line in tf_lines):
        raise AssertionError("TF spills or was not reported:\n" + "\n".join(tf_lines))
    log("ptxas -v, csrc/tree_fingerprint.cu (TF: the item kernel, the combine kernel): "
        + "; ".join(tf_lines))
    mx_lines = mx_resources()
    log(f"ptxas -v, csrc/moe_experts.cu (MX/MXq: routed_mma_kernel by format, matrices and "
        f"pairs a pass, moe_permute_kernel and moe_combine_kernel; "
        f"{sum('spill' in line for line in mx_lines)} kernels, no spill, no serialized wgmma): "
        + "; ".join(mx_lines))

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = [check_k1(gen, b, s, segments) for _, b, s, segments in K1_SHAPES]
    for (path, *_), r in zip(K1_SHAPES, k1):
        seg = ("unsegmented" if r["segments"] is None else "packed" if r["segments"] == "packed"
               else f"pad {r['segments']}")
        tag = f"K1 flash_attention B={r['b']} S={r['s']} H=32 Hkv=8 D=128 causal {seg} ({path})"
        log(f"{tag}: max_err {r['err']:.3g} ({r['ratio']:.3g}x its limit; a dropped K tile reads "
            f"{r['fault_ratio']:.3g}x); two runs bitwise equal; kernel_ms {r['ms']:.4f} (graph "
            f"replay; back to back {r['eager_ms']:.4f}) plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}; {r['ms'] / r['bound_ms']:.2f}x, "
            f"{r['tflops']:.1f} TFLOP/s) library_ms {r['library_ms']:.4f} (SDPA, "
            f"{'is_causal' if r['segments'] is None else 'bool mask'}, GQA; graph replay; back to "
            f"back {r['library_eager_ms']:.4f})")
        pl = r["plan"]
        log(f"{tag} tile plan: {pl['blocks']} blocks, {pl['grid']} (query tile, key tile) pairs "
            f"over the heads, {pl['visited']} visited, {pl['masked']} of them masked, {pl['live']} "
            f"hold a live pair; the visited tiles hold {pl['work_over_bound']:.3f}x the live pairs")
    k4 = check_k4(gen)
    log(f"K4 flash_decode B=8 s=1 H=32 Hkv=8 D=128 L=8192 bound 4100: max_err {k4['err']:.3g} "
        f"({k4['ratio']:.3g}x its limit; a dropped partial tile reads {k4['fault_ratio']:.3g}x) "
        f"kernel_ms {k4['ms']:.4f} (graph replay; back to back {k4['eager_ms']:.4f}) plain_ms "
        f"{k4['plain_ms']:.4f} bound_ms {k4['bound_ms']:.4f} ({k4['bound_by']}) library_ms "
        f"{k4['library_ms']:.4f} (SDPA, bool mask, GQA; graph replay; back to back "
        f"{k4['library_eager_ms']:.4f})")
    k5 = check_k5(gen, "k4", timed=True)
    k5s = check_k5(gen, "serving", timed=False)
    for name, r in (("K4's shapes", k5), ("the paged serving geometry", k5s)):
        log(f"K5 paged_flash_decode at {name}: B={r['slots']} s=1 H=32 Hkv=8 D=128 L=8192 "
            f"bound {r['bound_cols']} page_size 16, pool {r['pages']} pages ({r['mapped']} mapped "
            f"through a scrambled table), garbage null page, {r['live_cols']} live columns: "
            f"max_err {r['err']:.3g} ({r['ratio']:.3g}x its limit; a dropped partial tile reads "
            f"{r['fault_ratio']:.3g}x); bitwise equal to K4 on the gathered view, blind to the "
            f"null page, two runs bitwise equal; kernel_ms {r['ms']:.4f} (graph replay; back to "
            f"back {r['eager_ms']:.4f}) bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    for name, r in (("K4", k4), ("K5 at K4's shapes", k5), ("K5 at the paged serving geometry", k5s)):
        pl = r["plan"]
        log(f"{name} split plan: grid {pl['grid']} blocks ({pl['splits']} ranges of a slot and "
            f"kv-head, {pl['ranges']} before the bound: {pl['in_bound']} blocks run, "
            f"{pl['working']} with a live tile, {pl['live_tiles']} live 64-column tiles); "
            f"bytes the plan moves {pl['read_bytes']} against the bound's {pl['bound_bytes']} "
            f"({pl['read_bytes'] / pl['bound_bytes']:.3f}x)")
    log(f"K5 at K4's shapes: plain_ms {k5['plain_ms']:.4f} library_ms {k5['library_ms']:.4f} "
        f"(SDPA on the gathered view, bool mask, GQA; graph replay) + gather_ms {k5['gather_ms']:.4f} "
        f"(K and V views)")
    # the verify window of phase 5d's rounds (s = gamma): its own generator,
    # so the other checks keep their inputs
    vgen = torch.Generator(device="cuda").manual_seed(SPEC_GAMMA)
    k4v = check_k4(vgen, SPEC_GAMMA)
    k5v = check_k5(vgen, "serving", timed=True, s=SPEC_GAMMA)
    log(f"K4 flash_decode, verify window: B=8 s={SPEC_GAMMA} (R={4 * SPEC_GAMMA}) H=32 Hkv=8 "
        f"D=128 L=8192 bound 4100, left padding, the gap columns of rejected drafts from column "
        f"{VERIFY_DECODE_START} ({k4v['live_cols']} live columns): max_err {k4v['err']:.3g} "
        f"({k4v['ratio']:.3g}x its limit; a dropped partial tile reads {k4v['fault_ratio']:.3g}x) "
        f"kernel_ms {k4v['ms']:.4f} (graph replay; back to back {k4v['eager_ms']:.4f}) plain_ms "
        f"{k4v['plain_ms']:.4f} bound_ms {k4v['bound_ms']:.4f} ({k4v['bound_by']}) library_ms "
        f"{k4v['library_ms']:.4f} (SDPA, bool mask, GQA; graph replay; back to back "
        f"{k4v['library_eager_ms']:.4f})")
    log(f"K5 paged_flash_decode, verify window at the paged serving geometry: B={k5v['slots']} "
        f"s={SPEC_GAMMA} (R={4 * SPEC_GAMMA}) H=32 Hkv=8 D=128 L=8192 bound {k5v['bound_cols']} "
        f"page_size 16, pool {k5v['pages']} pages ({k5v['mapped']} mapped through a scrambled "
        f"table), garbage null page, the gap columns of rejected drafts after each context "
        f"({k5v['live_cols']} live columns): max_err {k5v['err']:.3g} ({k5v['ratio']:.3g}x its "
        f"limit; a dropped partial tile reads {k5v['fault_ratio']:.3g}x); bitwise equal to K4 on "
        f"the gathered view, blind to the null page, two runs bitwise equal; kernel_ms "
        f"{k5v['ms']:.4f} (graph replay; back to back {k5v['eager_ms']:.4f}) plain_ms "
        f"{k5v['plain_ms']:.4f} bound_ms {k5v['bound_ms']:.4f} ({k5v['bound_by']}) library_ms "
        f"{k5v['library_ms']:.4f} (SDPA on the gathered view, bool mask, GQA; graph replay) + "
        f"gather_ms {k5v['gather_ms']:.4f}")
    for name, r in (("K4, verify window", k4v), ("K5, verify window", k5v)):
        pl = r["plan"]
        log(f"{name} split plan: grid {pl['grid']} blocks ({pl['splits']} ranges of a slot and "
            f"kv-head, {pl['ranges']} before the bound: {pl['in_bound']} blocks run, "
            f"{pl['working']} with a live tile, {pl['live_tiles']} live 64-column tiles); "
            f"bytes the plan moves {pl['read_bytes']} against the bound's {pl['bound_bytes']} "
            f"({pl['read_bytes'] / pl['bound_bytes']:.3f}x)")
    # K5q and DQ: their own generator, so the other checks keep their inputs
    qgen = torch.Generator(device="cuda").manual_seed(12)
    k5q = {shapes: check_k5q(qgen, shapes) for shapes in ("k4", "serving", "serving64")}
    k5_ms = {"k4": f"{k5['ms']:.4f}", "serving": f"{k5s['ms']:.4f}", "serving64": "not run"}
    geometry = {"k4": "K4's geometry", "serving": "the paged serving geometry",
                "serving64": "the paged serving geometry four times over"}
    for shapes, r in k5q.items():
        log(f"K5q qpaged_flash_decode at {geometry[shapes]}: B={r['slots']} s=1 H=32 Hkv=8 "
            f"D=128 L=8192 bound {r['bound_cols']} "
            f"page_size 16, pool {r['pages']} int8 pages with a bf16 scale a (page, kv-head), "
            f"garbage null page, {r['live_cols']} live columns, {r['dead']} slot(s) with none: "
            f"max_err {r['err']:.3g} "
            f"({r['ratio']:.3g}x its limit; a dropped partial tile reads {r['fault_ratio']:.3g}x); "
            f"bitwise equal to K4 on the dequantized gathered view, blind to the null page, two "
            f"runs and three graph replays bitwise equal; kernel_ms {r['ms']:.4f} (graph replay; back to back "
            f"{r['eager_ms']:.4f}; pages from device memory {r['cold_ms']:.4f}; K5 on the bf16 "
            f"pool {k5_ms[shapes]}) plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}, {r['bytes']} B) "
            f"library_ms {r['library_ms']:.4f} (SDPA on the dequantized gathered view, bool mask, "
            f"GQA; graph replay) + gather_ms {r['gather_ms']:.4f} (the gather-dequantize of K "
            f"and V)")
    qw = check_qw(qgen)
    for name, r in qw.items():
        log(f"QW window_requantize ({smi}; {name}: B={r['slots']} s={r['s']} at column {r['col']}, "
            f"{r['n_win']} window page(s) a row, Hkv=8 D=128 page_size 16, int8 pool, bf16 scales, "
            f"K and V in one launch): bitwise equal to its plain version on every page but the "
            f"null page, one page's scale risen and one's fallen; kernel_ms {r['ms']:.4f} (graph "
            f"replay) bound_ms {r['bound_ms']:.5f} ({r['bound_by']}, {r['bytes']} B; "
            f"{r['ms'] / r['bound_ms']:.1f}x)"
            + (f" plain_ms {r['plain_ms']:.4f}" if "plain_ms" in r else "")
            + " library_ms null (no single PyTorch call re-quantizes a page window)")
    # K5q with the write: its own generator, so the other checks keep their inputs
    wa = check_write_attend(torch.Generator(device="cuda").manual_seed(23))
    for name, r in wa.items():
        log(f"K5q with the write qpaged_write_attend ({smi}; {name}: B={r['slots']} s={r['s']} "
            f"(R={r['rows']}) H=32 Hkv=8 D=128 L=8192 page_size 16 at the paged serving "
            f"geometry, the new rows at column {r['col']}, {r['n_win']} window page(s) a row, the "
            f"last slot idle): pools and scales bitwise equal to QW then K5q on every page but "
            f"the null page, out and lse bit for bit, one page's scale risen and one's fallen; "
            f"{r['ratio']:.3g}x K5q's limit against its plain version; the check fails a "
            f"variant that skips the write (differs in {r['broken']['skip']}) and one that "
            f"attends the stale codes (differs in {r['broken']['stale']}); kernel_ms "
            f"{r['ms']:.4f} (graph replay) against K5q alone {r['k5q_ms']:.4f} and QW + K5q "
            f"{r['qw_k5q_ms']:.4f} (one graph; fused {r['ms'] - r['k5q_ms']:+.4f} ms on K5q, "
            f"{r['ms'] - r['qw_k5q_ms']:+.4f} on QW + K5q) plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.5f} ({r['bound_by']}, {r['bytes']} B with QW's {r['qw_bytes']}; "
            f"{r['ms'] / r['bound_ms']:.2f}x) library_ms null (no single PyTorch call writes and "
            f"attends an int8 pool)")
    dq = check_dq(qgen)
    for kind in ("int8", "fp8"):
        log(f"DQ dequantize {kind} at lm_head's shape {dq['shape'][0]} x {dq['shape'][1]} (bf16 "
            f"out, a scale per row): bitwise equal to its plain version; kernel_ms "
            f"{dq[kind]['ms']:.4f} (graph replay) plain_ms {dq[kind]['plain_ms']:.4f} bound_ms "
            f"{dq['bound_ms']:.4f} ({dq['bound_by']}, 3 B a weight; {dq['bound_ms'] / dq[kind]['ms']:.3f} "
            f"of it); " + (f"library_ms {dq[kind]['library_ms']:.4f} (torch.mul(q, scale, "
                           f"out=bf16), bitwise equal; graph replay)" if kind == "int8" else
                           "library_ms null (torch.mul refuses to promote fp8 e4m3 with f32)"))
    pf = check_pf(qgen)
    for kind, r in pf.items():
        log(f"PF page_fingerprint ({smi}; {kind} pool, 32 layers x {r['pages']} pages of 16, Hkv 8, D "
            f"128{', bf16 scales' if kind == 'int8' else ''}; {PF_PAGES} pages in scrambled "
            f"order): bitwise equal to its plain version, one flipped bit moves that page's "
            f"value alone; kernel_ms {r['ms']:.4f} (graph replay) plain_ms {r['plain_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}, {r['bytes']} B; "
            f"{r['ms'] / r['bound_ms']:.2f}x) library_ms null (no single PyTorch call "
            f"computes it)")
    torch.cuda.empty_cache()
    mx = check_mx(qgen)
    log_mx(mx, smi)
    for kind in ("int8", "fp8"):
        r = mx_dequant_check(kind)
        log(f"MXq moe_experts_quantized ({kind}) dequantize ({smi}): x one-hot at H 4096 I 14336, "
            f"every {'int8' if kind == 'int8' else 'finite e4m3'} code of up and of down under "
            f"per-row scales 2^-30..2^19: act ({r['up']} values) and y ({r['down']} values) equal "
            f"the plain version's bit for bit")
    rows = {chunk: check_decode_rows(gen, chunk) for chunk in (16, 256, 512)}
    for chunk, r in rows.items():
        log(f"K4/K5 multi-row B=1 s={chunk} (R={r['rows']}) H=32 Hkv=8 D=128 L=8192, a "
            f"{ROWS_PREFIX}-column live prefix, pad tail {chunk - min(chunk - 3, 400)}: max_err {r['err']:.3g} "
            f"({r['ratio']:.3g}x its limit; a dropped {4 * r['tokens']}-row tile reads "
            f"{r['fault_ratio']:.3g}x); "
            f"two runs bitwise equal, K5 through a scrambled table bitwise equal to K4 on the "
            f"gathered view; K4 kernel_ms {r['ms']:.4f} K5 kernel_ms {r['paged_ms']:.4f} (graph "
            f"replays) plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} ({r['bound_by']}; "
            f"{r['pairs']} live pairs a head, {r['ms'] / r['bound_ms']:.1f}x, "
            f"{r['gflop'] / r['ms']:.1f} TFLOP/s) library_ms {r['library_ms']:.4f} (SDPA, bool "
            f"mask, GQA; graph replay)")
        pl = r["plan"]
        log(f"K4/K5 multi-row (R={r['rows']}) tile plan: {pl['blocks']} blocks (64-row tiles x 8 "
            f"kv-heads), {pl['visited']} visited 64-column tiles, {pl['masked']} of them masked; "
            f"the visited tiles hold {pl['work_over_live']:.3f}x the live pairs")
    # the head_dim-96 builds: their own generator, so the other checks keep their inputs
    dgen = torch.Generator(device="cuda").manual_seed(96)
    k1_96 = check_d96_k1(dgen)
    dec96 = {name: check_d96_decode(dgen, s, b, bound) for name, s, b, bound in D96_DECODE}
    log_d96(k1_96, dec96, smi)
    torch.cuda.empty_cache()
    k23 = {(s, packed): check_k2k3(gen, s, packed, timed=s == 4096)
           for s, packed in ((4096, False), (4096, True), (1000, False))}
    for (s, packed), r in k23.items():
        log(f"K2/K3 flash_attention_dkdv/dq B=2 S={s} H=32 Hkv=8 D=128 causal "
            f"{'packed' if packed else 'unpacked'}: max_err "
            + ", ".join(f"{n} {r['err'][n]:.3g} ({r['ratio'][n]:.3g}x its limit; a dropped key "
                        f"tile reads {r['fault'][n]:.3g}x)" for n in ("dk", "dv", "dq"))
            + "; two runs bitwise equal")
    k23_main = k23[(4096, False)]
    for packed in (False, True):
        for n in ("dkdv", "dq"):
            r = k23[(4096, packed)][n]
            log(f"K{2 if n == 'dkdv' else 3} flash_attention_{n} S=4096 "
                f"{'packed' if packed else 'unpacked'}: kernel_ms {r['ms']:.4f} plain_ms "
                f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}); "
                f"{r['tflops']:.1f} TFLOP/s, {r['over_bound']:.2f}x its bound")
    log(f"SDPA backward (dQ, dK, dV together; fwd+bwd - fwd, is_causal, GQA) S=4096: "
        f"library_ms {k23_main['library_ms']:.4f}")
    torch.cuda.empty_cache()

    cfg = llama3_8b()
    t0 = time.perf_counter()
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    torch.cuda.synchronize()
    log(f"model: llama3_8b, {cfg.num_layers} layers (no depth cut), "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params bf16, "
        f"init {time.perf_counter() - t0:.1f} s")
    tf = check_tf(model)
    for kind, r in tf.items():
        log(f"TF tree_fingerprint ({smi}; {kind}: {r['leaves']} leaves, {r['bytes']} B): = plain "
            f"bit for bit ({r['value']:#010x}), a flipped bit and a swap each move it; kernel_ms "
            f"{r['ms']:.4f} (graph replay) plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}; {r['ms'] / r['bound_ms']:.2f}x) library_ms "
            f"null (no single PyTorch call computes it)")
    for name, out in check_outputs(model, gen).items():
        log(f"outputs vs plain path ({name} cache{', scrambled table, K5' if name == 'paged' else ''}"
            f"; 64-token prompt, 8 decode steps): rel_err {out['rel_err']:.3g} argmax "
            f"{out['argmax_agree']} logit_scale {out['logit_scale']:.3g}")

    srv = serve(model, gen)
    snap = srv["snap"]
    wit = serve_workload(model, srv["workload"], eager=True)
    if wit["tokens"] != srv["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(srv["tokens"], wit["tokens"])) if a != b]
        raise AssertionError(f"serving token streams differ between the decode graph and the "
                             f"eager step: requests {diff}")
    log(f"serving: 6 requests (prompts 30..3000, 32 new tokens, 1 sampled), 8 slots, chunk 8: "
        f"wall {srv['wall_s']:.3f} s (capture {snap['capture_s']:.4f} s of it), prefills "
        f"{srv['prefills']}, decode steps "
        f"{snap['executed_steps']} executed ({snap['executed_steps'] - snap['steps']} masked no-ops), "
        f"TTFT mean {snap['mean_ttft']:.4f} s max {snap['max_ttft']:.4f} s, "
        f"decode {snap['chunk_tokens_per_sec']:.1f} tok/s (chunk wall), "
        f"prefill wall {snap['prefill_wall_s']:.4f} s, cursor {snap['cursor_high_water']}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for name, r in (("decode graph", srv), ("eager step (witness)", wit)):
        log(f"serving breakdown, {name}: admission step (6 prefills + 1 chunk"
            f"{', its capture included' if r is srv else ''}) {r['admit_s']:.4f} s, "
            f"{r['decode_only_executed']} decode-only steps executed ({r['decode_only_used']} "
            f"with a live slot) {r['decode_s']:.4f} s "
            f"({1e3 * r['decode_s'] / max(r['decode_only_executed'], 1):.2f} ms per executed "
            f"step, 8 slots), TTFT mean {r['snap']['mean_ttft']:.4f} s")
    log(f"serving decode program: decode_compilations {srv['compilations']}, captured at the "
        f"first chunk in {snap['capture_s']:.4f} s (warm-up included), {srv['replays']} replays "
        f"= executed steps, launches per replay {srv['per_replay']}; the eager step's token "
        f"streams are identical")
    log(f"launches on the serving path: {srv['launches']} (replays x launches per replay, plus "
        f"the wrappers' own: prefills and the capture's warm-up)")
    prof_row = profile_serving(model, srv["workload"])
    fams = prof_row["fams"]
    busy = sum(fams.values())
    wall_ms = 1e3 * (srv["wall_s"] - snap["capture_s"])
    log("device time of the serving workload (profiler, ms; decode program captured before the "
        "profiler opened): " + ", ".join(f"{k} {v:.2f}" for k, v in fams.items())
        + f"; busy {busy:.2f} of the unprofiled wall less its capture {wall_ms:.2f} "
        f"(idle share {1 - busy / wall_ms:.3f}); K4 kernel records {prof_row['records']} = 2 x "
        f"{prof_row['executed']} executed steps x {cfg.num_layers} layers (range + merge)")

    torch.cuda.empty_cache()
    workload = paged_workload(cfg.vocab_size)
    fused = serve_paged(model, workload, "fused")
    gather = serve_paged(model, workload, "gather")
    eager = serve_paged(model, workload, "fused", eager=True)
    for name, r in (("gather", gather), ("eager step", eager)):
        if fused["tokens"] != r["tokens"]:
            diff = [i for i, (a, b) in enumerate(zip(fused["tokens"], r["tokens"])) if a != b]
            raise AssertionError(f"paged token streams differ between fused and {name}: "
                                 f"requests {diff}")
    prof = serve_paged(model, workload, "fused", profiled=True)
    if prof["tokens"] != fused["tokens"]:
        raise AssertionError("paged token streams differ between the fused run and its profiled rerun")
    chats = [len(p) for p in workload[0] if len(p) < 1000]
    docs = [len(p) for p in workload[0] if len(p) >= 1000]
    log(f"paged serving: 15 requests (12 chats of {min(chats)}..{max(chats)} tokens, 3 documents "
        f"of {min(docs)}..{max(docs)}; 32 new tokens, 2 greedy), "
        f"{PAGED_SLOTS} slots, page_size {PAGE}, pool {fused['pool_gib']:.3f} GiB "
        f"(= {ROW_SLOTS} row slots + the null page), chunk 8, conservative; fused, gather "
        f"(captured with the patch in force) and eager-step token streams identical")
    for name, r in (("fused (K5)", fused), ("gather (K4)", gather), ("fused, eager step", eager)):
        sn = r["snap"]
        log(f"paged serving {name}: wall {r['wall_s']:.3f} s (capture {sn['capture_s']:.4f} s of "
            f"it), decode_compilations {r['compilations']}, replays {r['replays']}, prefills "
            f"{sn['prefills']}, decode "
            f"steps {sn['executed_steps']} executed ({sn['executed_steps'] - sn['steps']} masked "
            f"no-ops), TTFT mean {sn['mean_ttft']:.4f} s max {sn['max_ttft']:.4f} s, decode "
            f"{sn['chunk_tokens_per_sec']:.1f} tok/s (chunk wall), {r['decode_executed']} "
            f"decode-only steps executed {r['decode_s']:.4f} s "
            f"({1e3 * r['decode_s'] / max(r['decode_executed'], 1):.2f} ms per executed step), "
            f"mean occupancy {sn['mean_occupancy']:.2f}, peak occupancy {sn['peak_occupancy']}, "
            f"peak pages mapped {sn['peak_pages_mapped']}, peak mem {r['peak_gib']:.1f} GiB")
        log(f"launches on the paged serving path ({name}): {r['launches']}")
    busy = sum(prof["fams"].values())
    wall_ms = 1e3 * (fused["wall_s"] - fused["capture_s"])
    log(f"device time of the paged serving workload, fused (profiler, ms; decode program "
        f"captured before the profiler opened, in {prof['capture_s']:.4f} s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in prof["fams"].items())
        + f"; busy {busy:.2f} of the unprofiled wall less its capture {wall_ms:.2f} "
        f"(idle share {1 - busy / wall_ms:.3f}); K5 kernel records {prof['records']} = 2 x "
        f"{prof['snap']['executed_steps']} executed steps x {cfg.num_layers} layers")

    pre = prefix_phase(model)
    spec = spec_phase(model, srv["workload"], smi)
    med = medusa_phase(model, smi)
    quant = quant_phase(model, srv, fused, gen)
    fault = fault_phase(model, srv, spec["tokens"], smi)
    slo = slo_phase(model, smi)
    tier = tier_phase(model, smi)
    weights = weights_phase(model, srv, fused, smi)
    fabric = fabric_phase(model, srv, fused, smi)
    integ = integrity_phase(model, srv, fused, smi)

    del model
    torch.cuda.empty_cache()
    moe = moe_phase(smi)
    fam = family_phase(smi)

    tvp = train_vs_plain()
    log(f"training, kernel path vs plain path (2 layers, 2 x 1024 packed, one step): loss "
        f"{tvp['loss']:.5f} rel_err {tvp['loss_rel']:.3g}, grad norm rel_err {tvp['gnorm_rel']:.3g}, "
        f"q/k/v projection grads rel_err <= {tvp['qkv_grad_rel']:.3g} ({tvp['qkv_grad_worst']})")
    tr = train_phase()
    log(f"training: llama3_8b width, 8 layers (depth cut: fp32 masters + grads + 2 AdamW moments "
        f"= 16 B/param), {tr['n_params'] / 1e9:.3f} B params, init {tr['init_s']:.1f} s; batch 2 x "
        f"4096 packed ({tr['docs']} documents, {tr['pairs']} live attention pairs per head), "
        f"remat on, AdamW lr 1e-3 wd 0.1 clip 1.0")
    log("training losses: " + ", ".join(f"{x:.5f}" for x in tr["losses"])
        + "; step walls (s): " + ", ".join(f"{x:.4f}" for x in tr["walls"]))
    log(f"training: step wall {tr['wall']:.4f} s (median of steps 2-6), {tr['tokens_per_s']:.1f} "
        f"tokens/s, model {tr['flops'] / tr['wall'] / 1e12:.1f} TFLOP/s, mfu {tr['mfu']:.4f} "
        f"(of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s), peak mem {tr['peak_gib']:.2f} GiB")
    log(f"launches on the training path (6 steps): {tr['launches']}")
    busy = sum(tr["fams"].values())
    log("device time of one training step (profiler, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in tr["fams"].items())
        + f"; busy {busy:.2f} of the unprofiled step wall {1e3 * tr['wall']:.2f} "
        f"(idle share {1 - busy / (1e3 * tr['wall']):.3f})")

    lp = loop_phase(smi)
    log_loop_phase(lp, smi)
    mt = mixtral_train_phase(smi)
    log_mixtral_train_phase(mt, smi)

    k1_main = k1[1]  # the serving prefill at S=4096
    launches = {name: srv["launches"][name] + fused["launches"][name] + pre["launches"][name]
                + spec["launches"][name] + med["launches"][name] + quant["launches"][name]
                + fault["launches"][name] + slo["launches"][name] + tier["launches"][name]
                + weights["launches"][name] + fabric["launches"][name]
                + integ["launches"][name] + moe["launches"][name] + fam["launches"][name]
                + tr["launches"][name] + lp["launches"][name] + mt["launches"][name]
                for name in tr["launches"]}
    log(f"launches on the main paths (serving, paged serving with K5, prefix-cache serving, "
        f"speculative serving row and paged, Medusa, quantized serving, the fault contract, "
        f"SLO-aware multi-tenant serving, the host page tier, weights that change, the serving "
        f"fabric, integrity and program observability, Mixtral serving, the other decoder "
        f"families, training, the training loop, Mixtral training): "
        f"{launches}; "
        f"on the multi-row path (prefix-cache serving): {pre['multi_row']}; the speculative "
        f"rounds' verify windows (s = {SPEC_GAMMA}): {spec['verify']}")
    rows_main = rows[256]  # R = 1024: phase 5c's chat turns
    k23_err = {n: max(r["err"][n] for r in k23.values()) for n in ("dk", "dv", "dq")}
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_attention.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_attention.py:199",
             launches=launches["flash_attention"],
             max_abs_err=max(r["err"] for r in k1), ms=k1_main["ms"],
             plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by=k1_main["bound_by"], library_ms=k1_main["library_ms"]),
        dict(name="flash_attention_dkdv", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_attention.py:389",
             launches=launches["flash_attention_dkdv"],
             max_abs_err=max(k23_err["dk"], k23_err["dv"]), ms=k23_main["dkdv"]["ms"],
             plain_ms=k23_main["dkdv"]["plain_ms"], bound_ms=k23_main["dkdv"]["bound_ms"],
             bound_by=k23_main["dkdv"]["bound_by"], library_ms=k23_main["library_ms"]),
        dict(name="flash_attention_dq", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_attention.py:448",
             launches=launches["flash_attention_dq"], max_abs_err=k23_err["dq"],
             ms=k23_main["dq"]["ms"], plain_ms=k23_main["dq"]["plain_ms"],
             bound_ms=k23_main["dq"]["bound_ms"], bound_by=k23_main["dq"]["bound_by"],
             library_ms=k23_main["library_ms"]),
        dict(name="flash_decode", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:301",
             launches=launches["flash_decode"], max_abs_err=k4["err"], ms=k4["ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"], bound_by=k4["bound_by"],
             library_ms=k4["library_ms"]),
        dict(name="paged_flash_decode", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:617",
             launches=launches["paged_flash_decode"], max_abs_err=k5["err"], ms=k5["ms"],
             plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"], bound_by=k5["bound_by"],
             library_ms=k5["library_ms"]),
        dict(name="flash_decode_verify", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:301",
             launches=spec["verify"]["flash_decode"], max_abs_err=k4v["err"], ms=k4v["ms"],
             plain_ms=k4v["plain_ms"], bound_ms=k4v["bound_ms"], bound_by=k4v["bound_by"],
             library_ms=k4v["library_ms"]),
        dict(name="paged_flash_decode_verify", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:617",
             launches=spec["verify"]["paged_flash_decode"], max_abs_err=k5v["err"],
             ms=k5v["ms"], plain_ms=k5v["plain_ms"], bound_ms=k5v["bound_ms"],
             bound_by=k5v["bound_by"], library_ms=k5v["library_ms"]),
        dict(name="flash_decode_multi_row", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:301",
             launches=pre["multi_row"]["flash_decode"],
             max_abs_err=max(r["err"] for r in rows.values()), ms=rows_main["ms"],
             plain_ms=rows_main["plain_ms"], bound_ms=rows_main["bound_ms"],
             bound_by=rows_main["bound_by"], library_ms=rows_main["library_ms"]),
        dict(name="paged_flash_decode_multi_row", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:617",
             launches=pre["multi_row"]["paged_flash_decode"],
             max_abs_err=max(r["err"] for r in rows.values()), ms=rows_main["paged_ms"],
             plain_ms=rows_main["plain_ms"], bound_ms=rows_main["bound_ms"],
             bound_by=rows_main["bound_by"], library_ms=rows_main["library_ms"]),
        # K5q computes what the JAX engine runs for an int8 pool: the
        # gather-dequantize (flash_decode.py:201) and K4's pallas_call
        dict(name="qpaged_flash_decode", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:301",
             launches=launches["qpaged_flash_decode"],
             max_abs_err=max(r["err"] for r in k5q.values()), ms=k5q["k4"]["ms"],
             plain_ms=k5q["k4"]["plain_ms"], bound_ms=k5q["k4"]["bound_ms"],
             bound_by=k5q["k4"]["bound_by"], library_ms=k5q["k4"]["library_ms"],
             cold_ms=k5q["k4"]["cold_ms"], serving_ms=k5q["serving"]["ms"],
             serving_cold_ms=k5q["serving"]["cold_ms"],
             serving_bound_ms=k5q["serving"]["bound_ms"],
             design="redesigned: int8 converted where the products read it, no bf16 tile"),
        # K5q with the write: the decode step's window re-quantize (which XLA
        # fuses into JAX's decode chunk, modules/attention.py:544) folded
        # into K5q, which computes the gather-dequantize and K4's pallas_call
        dict(name="qpaged_write_attend", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:301",
             launches=launches["qpaged_write_attend"],
             max_abs_err=max(r["err"] for r in wa.values()), ms=wa["decode"]["ms"],
             plain_ms=wa["decode"]["plain_ms"], bound_ms=wa["decode"]["bound_ms"],
             bound_by=wa["decode"]["bound_by"], library_ms=None, k5q_ms=wa["decode"]["k5q_ms"],
             qw_k5q_ms=wa["decode"]["qw_k5q_ms"], verify_ms=wa["verify"]["ms"],
             verify_bound_ms=wa["verify"]["bound_ms"],
             verify_launches=quant["spec"]["verify"],
             design="redesigned: QW folded into K5q's range kernel, one launch a layer"),
        # QW computes the window re-quantize XLA fuses into JAX's decode chunk
        # (on the port's main path: the prefills' writes)
        dict(name="window_requantize", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/kv_quant.cu",
             replaces="neuronx_distributed_tpu/modules/attention.py:544",
             launches=launches["window_requantize"], max_abs_err=0.0, ms=qw["decode"]["ms"],
             plain_ms=qw["decode"]["plain_ms"], bound_ms=qw["decode"]["bound_ms"],
             bound_by=qw["decode"]["bound_by"], library_ms=None, prefill_ms=qw["prefill"]["ms"],
             prefill_bound_ms=qw["prefill"]["bound_ms"]),
        # PF computes the per-page fingerprints XLA fuses into one program
        dict(name="page_fingerprint", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/page_fingerprint.cu",
             replaces="neuronx_distributed_tpu/utils/fingerprint.py:158",
             launches=launches["page_fingerprint"], max_abs_err=0.0, ms=pf["bf16"]["ms"],
             plain_ms=pf["bf16"]["plain_ms"], bound_ms=pf["bf16"]["bound_ms"],
             bound_by=pf["bf16"]["bound_by"], library_ms=None, int8_ms=pf["int8"]["ms"],
             int8_bound_ms=pf["int8"]["bound_ms"]),
        # TF computes the tree fingerprint XLA fuses into one program
        dict(name="tree_fingerprint", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/tree_fingerprint.cu",
             replaces="neuronx_distributed_tpu/utils/fingerprint.py:119",
             launches=launches["tree_fingerprint"], max_abs_err=0.0, ms=tf["bf16"]["ms"],
             plain_ms=tf["bf16"]["plain_ms"], bound_ms=tf["bf16"]["bound_ms"],
             bound_by=tf["bf16"]["bound_by"], library_ms=None, int8_ms=tf["int8"]["ms"],
             int8_bound_ms=tf["int8"]["bound_ms"], train_state_ms=lp["tf"]["ms"],
             train_state_plain_ms=lp["tf"]["plain_ms"],
             train_state_bound_ms=lp["tf"]["bound_ms"]),
        # DQ computes what XLA fuses into the quantized matmul's load
        dict(name="dequantize", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/dequantize.cu",
             replaces="neuronx_distributed_tpu/quantization/layers.py:33",
             launches=launches["dequantize"], max_abs_err=0.0, ms=dq["int8"]["ms"],
             plain_ms=dq["int8"]["plain_ms"], bound_ms=dq["bound_ms"], bound_by=dq["bound_by"],
             library_ms=dq["int8"]["library_ms"]),
        # MX/MXq compute what XLA fuses for JAX's selective expert route
        # (with the dequantize of quantized experts in the load)
        dict(name="moe_experts", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/moe_experts.cu",
             replaces="neuronx_distributed_tpu/modules/moe/expert_mlps.py:327",
             launches=launches["moe_experts"],
             max_abs_err=max(r["err"] for (k, _, _), r in mx.items() if k == "bf16"),
             ms=mx[("bf16", "random", 8)]["ms"], plain_ms=mx[("bf16", "random", 8)]["plain_ms"],
             bound_ms=mx[("bf16", "random", 8)]["bound_ms"],
             bound_by=mx[("bf16", "random", 8)]["bound_by"],
             library_ms=mx[("bf16", "random", 8)]["library_ms"]),
        dict(name="moe_experts_quantized", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/moe_experts.cu",
             replaces="neuronx_distributed_tpu/modules/moe/expert_mlps.py:327",
             launches=launches["moe_experts_quantized"],
             max_abs_err=max(r["err"] for (k, _, _), r in mx.items() if k != "bf16"),
             ms=mx[("int8", "random", 8)]["ms"], plain_ms=mx[("int8", "random", 8)]["plain_ms"],
             bound_ms=mx[("int8", "random", 8)]["bound_ms"],
             bound_by=mx[("int8", "random", 8)]["bound_by"],
             library_ms=mx[("int8", "random", 8)]["library_ms"],
             fp8_ms=mx[("fp8", "random", 8)]["ms"],
             fp8_library_ms=mx[("fp8", "random", 8)]["library_ms"]),
    ]
    # the head_dim-96 builds (GPT-NeoX-20B's), kernels of their own
    step96, verify96, rows96 = dec96["step"], dec96["verify"], dec96["multi_row"]
    kernels += [
        dict(name="flash_attention_d96", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_attention.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_attention.py:199",
             launches=launches["flash_attention_d96"], max_abs_err=k1_96["err"], ms=k1_96["ms"],
             plain_ms=k1_96["plain_ms"], bound_ms=k1_96["bound_ms"], bound_by=k1_96["bound_by"],
             library_ms=k1_96["library_ms"], build="-DNXD_HEAD_DIM=96"),
        dict(name="flash_decode_d96", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:301",
             launches=launches["flash_decode_d96"],
             max_abs_err=max(r["err"] for r in dec96.values()), ms=step96["ms"],
             plain_ms=step96["plain_ms"], bound_ms=step96["bound_ms"],
             bound_by=step96["bound_by"], library_ms=step96["library_ms"],
             verify_ms=verify96["ms"], verify_bound_ms=verify96["bound_ms"],
             multi_row_ms=rows96["ms"], multi_row_bound_ms=rows96["bound_ms"],
             build="-DNXD_HEAD_DIM=96"),
        dict(name="paged_flash_decode_d96", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:617",
             launches=launches["paged_flash_decode_d96"],
             max_abs_err=max(r["err"] for r in dec96.values()), ms=step96["paged_ms"],
             plain_ms=step96["paged_plain_ms"], bound_ms=step96["paged_bound_ms"],
             bound_by=step96["bound_by"], library_ms=step96["library_ms"],
             verify_ms=verify96["paged_ms"], multi_row_ms=rows96["paged_ms"],
             build="-DNXD_HEAD_DIM=96"),
    ]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels of the main paths never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
