#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FIER (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # the whole check, as described below
    python3 chip_smoke.py --kernels-only  # phases 1-2 only, no result line
    python3 chip_smoke.py --ssm-hybrid-encdec-only  # phases 1 and 10 only, no result line
    python3 chip_smoke.py --training-only # phases 1 and 11 only, no result line
    python3 chip_smoke.py --sharded-only  # phases 1 and 12 only, no result line
    python3 chip_smoke.py --sharded-train-only  # phases 1 and 13 only, no result line
    python3 chip_smoke.py --examples-only # phases 1 and 14 only, no result line
    python3 chip_smoke.py --any-heads-only  # phases 1 and 15 only, no result line
    python3 chip_smoke.py --wide-only     # phases 1 and 16 only, no result line
    python3 chip_smoke.py --dryrun-only   # phases 1 and 17 only, no result line
    python3 chip_smoke.py [--kernels-only] --baseline-attend OTHER/fier_attend.cu
        # phase 2 also times K2 built from another source with the earlier
        # two-launch interface (e.g. from an older commit) in turns with this one
    python3 chip_smoke.py [--kernels-only] --baseline-unfused OTHER_CSRC_DIR
        # phase 2 also builds K6 and K7 from another directory's fier_score.cu
        # and fier_topk.cu with the interfaces of the one-block-per-row K7 and
        # the many-wave K6, holds them bitwise to these and times them in turns

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. Setup: the card's name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together; phase 2's planted faults
   build in the background while its first checks run); every kernel's
   ptxas report must show a 0-byte stack frame and 0 spill bytes.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (olmo-1b: 4 slots, 16 kv heads, d_head 128, capacity 8192,
   group 32, budget 1024) and at a GQA shape (4 kv heads × 4 query heads,
   with the group sum and with the group max), with per-row lengths that
   include one row shorter than the budget; then the kernel, its plain
   version and one library call (where one computes the same function)
   timed in turns with the L2 cache flushed before every launch (an empty
   kernel timed the same way gives the floor under every time).  The paged
   kernels K3 and K4 run on a pool built by scattering the slab's blocks (bs 32) into a random
   permutation of pool blocks, with spare blocks and one table entry inside
   a row's length pointed at the null block 0 (non-zero data): K3 must equal
   K1 on the gathered slab bit for bit (idx, τ, m), K4 must equal K2 bit for
   bit, and each must agree with its own plain version.  K5 must equal its
   plain version bit for bit (the bytes where it differs from
   ``build_metadata``'s side-car are printed, on bf16 and on f32 keys), K6
   lie within the f32 summation-order bound of its plain version, K7 give
   its plain version's τ and m exactly, and K8 lie within 1e-4·max|out| of
   its plain version and equal K2 bit for bit on ``gather_kv`` of K2's
   selection; ``ops.fier_decode_two_pass`` must give
   ``ops.fier_decode_one_pass``'s idx, τ, m and output bit for bit under
   the group max, and the same index set up to near-τ ties under the sum.
   K1 and K3 also run on a ``long_500k`` row (B 1, 16 kv heads, 524,288
   tokens, budget 4096: keys beyond the CTAs' shared memory, built on the
   card from a seeded ``torch.Generator``) and on a ragged S = 8160 row whose
   length ends inside a CTA's range: K1 within ε of its plain version, K3
   bitwise K1 on a permuted pool with a null-block hole, K6 within ε of its
   plain version and K7 exactly its plain version's τ and m on the masked
   scores (at ``long_500k`` every K7 pass re-reads the row), all timed.
   K1/K3 report their bound over the valid rows (no chunk past a row's
   length is read) and over whole rows.  K6 also runs at rep 8 (within ε),
   and K7 on adversarial rows (ties, ±0.0, +inf guard rails, a −1e30 tail,
   an all-tied row) at 16 and 64 rows of S = 8192 and 16 rows of S = 8191
   (one CTA per row; rows off a 16-byte boundary), and split over a
   cluster at 64 rows of 16,384, 16 rows of 65,536 and 4 rows of 65,533,
   budgets 1, 1024 and S: τ and m exactly its plain version's.  K2, K4 and
   K8 then run at every (d_head, rep) the kernel admits (64 and 128 x 1, 2,
   4, 8, 12, 16), at the ladder's budget 512, at budget 1000
   (no multiple of the plan's 64-slot step) and at budget 8192 (a CTA finds
   its rows in two chunks): K2 within 1e-4·max|out| of its plain version,
   two K2 launches on the same inputs equal bit for bit, K4 = K2 and K8 =
   K2 bit for bit, each timed (d_head 112 at rep 1 too, budgets 1000 and
   8192).  Then K1–K8 at the kernel shapes of the family configs
   (``FAMILY_SHAPES``: granite-moe's Hkv 8 x rep 2 and minicpm's 36 x 1 at
   d_head 64, starcoder2's 2 x 12, command-r's 8 x 12 and qwen3-moe's 4 x 16
   at 128, zamba2's
   32 x 1 at 112, whisper's 12 x 1 at 64 with S 4096), with the gates and
   timings of the main path's shape, and K1/K3/K6 at d_head 112 with rep 4
   (``D112_GQA_SHAPE``; K2/K4/K8 take rep 1 only there).  Then d_head 16
   and 32 (``check_small_heads``): K1/K3/K6 at reps 1, 2 and 16 and K2/K4/K8
   at every rep of ``KERNEL_REPS`` at the main path's scale (B 4, Hkv 16,
   S 8192, g 32, budget 1024, bs 32), K5 there and at S 264, and K1–K4, K6
   and K8 at the examples' shapes (S 64, 128 and 264, g 8, bs 8, budgets
   16, 24 and 32, no sink or recent window), each under the gates above
   and timed (the plain versions and library calls over 3 launches); and a
   planted fault, K1 and K6 built with the d_head 16 lanes 16–31 scoring
   the next kv head's channels, which must read above K1's and K6's gates.
   Then the generic layout (``check_any_heads``): K1/K3/K6, K2/K4/K8 and K5
   at d_head 8, 24, 48, 80, 96, 136, 192 and 256 at reps 1 and 3 (Hkv 16),
   at reps 5, 6, 7, 9, 24, 32, 48 and 71 at d_head 64, 128 and 256 (Hkv =
   min(16, 128 / rep)), at the main path's scale, and with the 4-group
   chunk (g 8, S 264) in each layout class, under the gates above (K3 = K1,
   K4 = K2 = K8 bit for bit), each timed beside its plain version and
   library call; and two planted faults (``PLANTED_FAULTS``), the d_head 80
   idle lanes loading the next kv head's channels (K1, K6) and the last
   partial block of query heads dropped at rep 71 (K1, K6, K2), each above
   its gate.
3. The main path at full olmo-1b width (random weights from a seeded
   ``torch.Generator``): ``Engine.build`` with the default policy,
   ``generate`` of 32 greedy tokens for 4 prompts, then ``insert`` of a
   fifth prompt into a freed slot and 8 ``decode(active=...)`` steps.  Every
   slab kernel must have launched 14 × (decode steps) times (16 layers − 2
   skip layers), the paged ones never.  The same engine built with
   ``pipeline='reference'`` (no custom kernel) gives identical prefill
   logits.  The first decode step is run with the kernels, with their plain
   versions (each layer's kernel inputs compared on the way), and with two
   planted faults: its logits must lie near the plain run's and the
   reference pipeline's, and each fault's must not (``first_step_checks``).
4. Paged vs slab (``paged_vs_slab``): the same weights, four prompts
   (7900/6000/4000/1500) inserted one by one into the slab engine and into
   ``Engine.build(layout="paged")`` (bs 32, default pool), then 32 greedy
   decode steps (the paged engine calling ``advance_slot`` for every slot
   first).  Tokens and the first step's logits must be equal (max |Δ| 0);
   each run launches only its own layout's kernels, 14 per step.
5. Serving a stream (``serve_stream``): ``ContinuousScheduler`` with chunk
   2048 over a paged engine (8 slots × 8192, bs 32, a tight pool of 621
   blocks) and 12 requests: P (a 4096-token family prefix + 250 tokens),
   two exact repeats of P (full-prompt replay, shared partial tail block,
   copy-on-write), four distinct prompts (7000/5000/3000/1500) and five
   family-prefix prompts.  Every request must finish, the audit be clean
   with no block in use, prefix hits, replays and CoW copies be > 0, the
   repeats generate P's tokens, a budget downshift or a preemption occur,
   and K3/K4 launch 14 × the scheduler's decode steps.  The first decode
   step at each budget served (1024 and, after a downshift, 512; 8 slots)
   also runs K3 and K4's plain versions on the engine's own tensors, held
   to the tolerances of phase 2.
6. The two_pass pipeline at full width (``two_pass_path``): phase 3's
   weights and prompts through ``Engine.build(policy=serving_policy(
   pipeline="two_pass"))``.  The first decode step runs the pipeline's
   kernels beside K1, K8 and ``fier_decode_reference(use_kernels=True)`` on
   the engine's own tensors and must give phase 3's one_pass logits
   exactly; the unfused building blocks (``ops.pack_quantize``, K5, on a
   FIER layer's key slab, bitwise its plain version, and
   ``ops.fier_attention_decode``, K6 → sort → gather → K8, on every FIER
   layer's tensors of that step) run counted; ``generate`` of 32 greedy
   tokens must give phase 3's tokens (128/128) with K6 = K7 = K2 = 14 ×
   decode steps and no other kernel; ``count_score_bytes`` of one layer
   must read 0 for one_pass (slab and paged) and at least 2·4·Hq·S·B for
   two_pass.  two_pass and one_pass decode steps are then timed in turns and
   profiled (information, no gate).
7. The paper's baselines at full width (``baselines_path``): quest (page
   16), slm (sink 4) and FIER one_pass slab engines on phase 3's weights and
   prompts, budget 1024, skip 2.  Quest's first decode step runs every quest
   layer on the card and on a CPU copy of the same inputs (page sets equal
   up to near-ties within ε of the n_pages-th score, outputs within
   1e-4·max|out|), and its page sets equal, up to the same near-ties, a
   plain top-k over page bounds read from the keys on the card; quest and
   slm at budget = capacity give the ``full`` engine's first-step logits
   within 0.015·max|logit| (quest's reading with one page planted out of
   its choice is reported beside it); quest and slm launch
   none of K1–K8 (their first steps counted alone, then 8 steps of each
   engine in turns, timed, with only FIER's K1/K2 launched); the eviction
   family (StreamingLLM mask, SnapKV, 32 steps each of H2O and TOVA) on
   layer 2's cache of slot 0 gives equal alive sets on the card and a CPU
   copy, keeps its budget after every step, and evicts the first of tied
   minima on the card; each deprecated shim of ``kernels.ops`` warns once,
   launches its K1–K4 kernels once each and equals its CacheView call bit
   for bit (outside every counted window); a FIER plan over a card view
   without its side-car raises.  The three engines' decode steps are
   profiled (information).
8. Robustness at full width (``robustness_path``): phase 5's stream again
   with a 256-block host tier and a TTL of 4 virtual-clock units, plus one
   late family-prefix request (phase 5's order recalls nothing), must
   pass phase 5's gates, give phase 5's tokens, give the late request the
   tokens it gets alone on a fresh engine without a host tier, and recall
   blocks, each read
   back with 0 bytes changed in every pool leaf (transfer rates, recall ms
   per block and the share of it overlapping the commit into the pool from
   the tier's CUDA events); a seeded chaos run (``ServingFaultInjector.
   random(seed=0)``, five faults over the five kinds) on that engine's
   configuration with the ladder off must fire every fault, end every
   request with a structured outcome, give the requests that no fault names
   and nothing preempted the fault-free run's tokens, give the preempted
   ones that no fault names those tokens up to their first preemption, and
   audit clean; ``Observability(introspect=
   True)`` on phase 3's slab engine for 8 steps must give every
   ``ProbeRecord`` in range (mean overlap and mass reported), and K1/K3 on a
   slot that ``corrupt_slot_metadata`` scrambled must lie within ε of their
   plain versions.
9. The transformer families at full width (``families_path``), random
   weights from a seeded ``torch.Generator``, ``Engine.build``'s default
   policy (fier / one_pass / budget 1024 / skip 2), each model freed before
   the next: granite-moe-1b-a400m (24 layers, 32 experts top-8, d_head 64,
   rep 2), minicpm-2b (d_head 64, 36 kv heads; 20 of its 40 layers) and
   starcoder2-3b (30 layers, rep 12), 4 slots x 8192, prompts
   8100/6000/3000/1500, and llava-next-mistral-7b (rep 4; 16 of its 32
   layers) at 2 slots x 8192 with 576
   seeded vision embeddings before 7000/3000 text tokens.  Each: the first
   decode step with the kernels within 0.017·max|logit| of the step with
   their plain versions (``FAMILY_LOGIT_REL_TOL``, set between the sound
   and the planted faults' readings as phase 3's gates were; every
   layer's K1/K2 inputs compared on the way; granite's expert choices
   replayed from the plain run where a near-tied router swapped one, the
   unpinned gap and the swaps reported), and two planted faults (K2 fed
   idx+1; K1's first-FIER-layer selection on the next kv head) above it;
   ``generate`` of 16 (granite) or 8 greedy tokens with K1/K2 launched
   (layers − 2) x decode steps and no other FIER kernel (llava: 8
   ``decode`` steps after the bundle's ``prefill``); granite's prefill
   logits identical to the reference pipeline's, and its prompts through a
   paged engine (``paged_vs_slab``: tokens and first-step logits equal, K3/K4
   per step).  Reported, not gated: unprofiled decode ms/step (median of 4),
   TTFT, device-busy ms and launches of a step under the profiler, peak
   memory above what was allocated before the model.
10. The ssm, hybrid and encdec families at full width and depth
   (``ssm_hybrid_encdec_path``), random weights from a seeded
   ``torch.Generator``, ``Engine.build``'s default policy, 4 slots, token
   arrays padded to the capacity, each model freed before the next:
   mamba2-370m (48 layers, capacity 8192, prompts 8100/6000/3000/1500):
   the first decode step within ``SSM_STEP_REL_TOL``·max|logit| of a
   prefill of each prompt extended by the decoded token (the recurrent step
   against the chunked scan), a planted fault (each row decoding from the
   next row's state) above it, and no FIER kernel in ``generate``;
   zamba2-7b (81 layers, one shared attention block at 13 points, d_head
   112, the same prompts) and whisper-small (12+12 layers, capacity 4096,
   ``max_positions=4096``, seeded frames [4, 1500, 768] through ``extras``,
   prompts 4000/3000/2000/1000): the first decode step with the kernels vs
   their plain versions within ``PHASE10_LOGIT_REL_TOL`` and two planted
   faults above it (``family_first_step``), K1 = K2 = 13 (zamba2) or 10
   (whisper) × decode steps in ``generate`` of 6 (zamba2) or 8 greedy
   tokens and no other FIER kernel; zamba2's prefill logits identical to
   the reference pipeline's and a two_pass engine's first step equal to
   one_pass bit for bit.  (d) each of the three on a 2 x 2 (data x model) mesh with every
   shard on the card (``mesh10_decode``): ``build_model`` with a
   ``DistConfig`` (``seq_axes=("model",)``, ``batch_axes=("data",)``,
   ``mode="exact"``) decodes 4 steps from the prefill cache placed by
   ``cache_shardings`` (slabs over batch x sequence, Mamba2 states and
   cross K/V over batch, every piece on a storage of its own), teacher-
   forced with the one-device bundle's tokens (the same policy without the
   guard rails): the logits within ``MESH10_LOGIT_REL_TOL`` of the
   one-device steps' (mamba2 and zamba2 at ``SSM_STEP_REL_TOL``: cuBLAS
   gives the state readout's rows other last bits at 2 rows than at 4),
   zamba2's and whisper's every exact-mode selection equal to the plain
   top-k of the same scores up to scores within 3ε of τ and to K1's on the
   same query and side-car up to scores within 2δ + 3ε of τ; one planted
   fault per family (each batch shard stepping the next shard's state rows,
   or attending the next shard's cross K/V) above the gate, and a planted
   selection fault (each sequence shard selecting from the next shard's
   scores) outside both bands.  Reported, not
   gated: as phase 9 (only zamba2's step profiled), and (d)'s ms per step
   beside the one-device step's.
11. Training (``training_path``): (a) ``flash_attention``'s blockwise
   backward (a ``torch.autograd.Function``) against autograd through the
   dense ``attention_ref`` on bf16 inputs at olmo-1b's layer (B 4, S 2048,
   16 heads x 128, causal) and at a GQA shape (4 x 4, S 1100: three
   512-row query blocks, a padding mask, S no multiple of block_k):
   out/dq/dk/dv within ``FLASH_GRAD_REL_TOL`` of the oracle's max, a planted
   fault (Dterm dropped) above it, each path's time and peak memory
   reported; (b) olmo-1b at full width and depth (random init from a seeded
   ``torch.Generator``, remat on, B 4 x S 2048 from ``make_train_batch``,
   AdamW + cosine, 8 steps through ``make_train_step``): every loss and
   grad norm finite, the first loss within 1.5 of ln(vocab), the last below
   the first; ms/step, tokens/s and peak memory reported; (c) 6 steps at
   olmo-1b's width cut to 2 layers under
   ``torch.use_deterministic_algorithms(True)``, uninterrupted and through
   ``run_with_recovery`` with one ``FaultInjector`` fault after the step-3
   checkpoint: the final states equal bit for bit; (d) granite-moe-1b-a400m,
   mamba2-370m (2 layers each), zamba2-7b (6 layers: one application of the
   shared block) and whisper-small (2 + 2 layers, S 448) at full width, 2
   steps each: finite losses and grad norms, the moe aux loss, ms/step and
   peak memory reported; (e) tests/test_system.py's recipe at d_head 64
   (3 layers, d 256, 4 heads, vocab 256; 150 steps, lr 2e-3, warmup 10,
   B 8 x S 128, data seed 11) trained on the card, then served greedily
   through full, FIER one_pass (K1/K2), quest and slm under that test's
   gates (last loss below 0.7 x the first; FIER at budget 112 through the
   reference pipeline equal to full; at budget 24 FIER's agreement above
   quest's and slm's and >= 0.4; FIER's teacher-forced NLL gap below half
   of slm's + 0.05) and, at budget 112 through K1/K2: every valid token
   selected, K2 within ``K2_REL_TOL`` of full-KV attention with f32
   softmax weights at every call, teacher-forced logits within
   ``SERVE_LOGIT_REL_TOL`` of full-KV's with two planted K2 faults above
   it, and greedy tokens equal to the f32-weight witness's (full-KV
   rounds the weights to bf16, so its free-running agreement is reported);
   K1 = K2 = 2 x 72 FIER decode steps.
12. Mesh-sharded serving (``sharded_path``), every shard on this card.
   (a) olmo-1b at full width, phase 4's weights and prompts, paged one_pass
   (bs 32, default pool) on ``make_mesh`` meshes tp2, dp2 and tp2 x dp2
   (``Engine.build(mesh=...)``) against the one-device paged engine: the
   prefill logits bit for bit; 16 decode steps teacher-forced with the
   one-device run's tokens, bit for bit on tp2 and dp2
   (``SHARD_BITWISE``) and on tp2 x dp2 the first within
   ``SHARD_LOGIT_REL_TOL`` and every one within ``SHARD_DRIFT_REL_TOL`` of
   max|logit|, with three planted faults read at every step of tp2 x dp2
   beyond both (K4 fed idx+1, K3's last-layer selection on the next kv
   head, a DP shard reading another shard's rows).  Each shard's K3/K4
   take the unsharded call's split (``plan_rows``), so the FIER layers are
   exact; the dense skip layers' batched cuBLAS GEMMs may pick another
   kernel at a shard's batch count, and whether dense decode attention
   over a shard's rows equals those rows of the whole call is reported.
   The first step runs K3/K4's plain versions on every shard's own tensors
   (phase 2's tolerances); K3 = K4 = 14 × steps × shards and nothing else;
   clean audits; ``count_score_bytes`` of one sharded layer 0 for one_pass
   (every shard) and > 0 for the reference pipeline; decode ms/step
   (median of 4) and a profile beside the one device's.  (b)
   granite-moe-1b-a400m, depth cut to 6 layers, at tp2 (4 kv heads × rep 2
   per shard, d_head 64): prefill logits and the first decode step bit for
   bit.  (c) phase 5's 12 requests through ``ContinuousScheduler`` (chunk
   2048, 8 slots × 8192, the default pool: neither run preempts or
   downshifts, which is gated) on one device and on dp2, the dp2 run
   teacher-forced with the one-device tokens: every position's logits of
   every request within ``SHARD_DRIFT_REL_TOL``·max|logit| of the one
   device's, and a third dp2 run with a DP shard reading another shard's
   rows beyond it; clean audits, per-shard pool gauges, K3/K4 = 14 × steps ×
   shards.  (d) one layer sequence-sharded over 4 shards at
   ``long_500k``'s shape (B 1, 16 kv heads, 524,288 tokens, budget 4096;
   K, V from a seeded generator on the card): ``select_sharded`` in exact
   mode attends the single-device top-k's index set up to scores within ε
   (2× ``score_eps``) of τ, ``full_decode_sharded`` lies within
   ``LONG_FULL_REL_TOL``·max|out| of dense attention and the merge with
   the last shard dropped beyond it, local mode's overlap with the global
   top-k is reported; all timed.  (e) placed params: phase 4's weights
   placed by ``param_shardings`` (TP over 'model', FSDP over 'data') on
   tp2 x dp2, through ``Engine.build(mesh=...)`` paged one_pass, each
   (DP, TP) shard projecting its own rows and heads and launching K3/K4 on
   them (``models/placed_serving.py``), against (a)'s one-device engine:
   the prefill logits and (a)'s teacher-forced steps within
   ``PLACED_REL_TOL`` (every layer's reductions split over the model
   shards, so its bf16 roundings part from one device's in every layer;
   the gates' readings are beside them), K3 = K4 = 14 × steps × shards,
   and two planted faults read at the first ``PLACED_FAULT_STEPS`` steps
   beyond it (model shard 1's wo partial dropped; each model shard on the
   next shard's wq block); the sequence-sharded slab on tp2 x dp2: a
   placed prefill of 4 prompts (K/V handed from heads to sequence per
   layer) against the one-device prefill, one placed decode step against
   the unplaced params' sharded step, within ``PLACED_REL_TOL``, and the
   hand-off in swapped order beyond it; granite-moe (as (b)'s, 6 layers)
   with placed params on tp2 x dp2: expert-parallel prefill and masked
   expert-shard decode within ``PLACED_MOE_REL_TOL`` of the one-device
   engine, an expert shard's partial dropped beyond it.
13. Training on meshes (``sharded_train_path``), every shard on this card.
   (a) olmo-1b at full width, depth cut to 4 layers, phase 11(b)'s B 4 x
   S 2048, seed 0, AdamW + cosine (lr 1e-3, warmup 0): the one-device step
   and the steps on dp2, tp2 and tp2 x dp2 (``make_mesh``; the state placed
   by ``param_shardings`` / ``opt_shardings``, TP over 'model', FSDP over
   'data') from one initial state — the first step's loss, grad norm and
   every leaf's gathered gradient within ``TRAIN_LOSS_REL_TOL``,
   ``TRAIN_GNORM_REL_TOL`` and ``TRAIN_GRAD_REL_TOL``, the params after
   AdamW within ``TRAIN_PARAM_REL_TOL`` where the gradient is clearly
   non-zero (a near-zero gradient's sign may flip), every shard holding
   exactly tree_bytes / n of each leaf split n ways, three planted faults
   on tp2 x dp2 above every first-step gate (a DP shard fed another
   shard's rows, TP shard 1's wo partial dropped, FSDP pieces gathered in
   swapped order); then 4 more steps per mesh from the one device's state
   after its first step (AdamW with non-zero moments), each step's loss
   and grad norm within ``TRAIN_LOSS_REL_TOL`` and
   ``TRAIN_TIMED_GNORM_REL_TOL`` of the one device's steps, two planted
   optimizer faults on tp2 x dp2 above both (each split leaf's pieces
   given the next piece's first moments, or none): ms/step (median), peak
   memory and one profiled step.  (d) tp2 x dp2's state
   saved and restored onto dp2 (``restore(sharding=)``) and onto one
   device, bit for bit; 2 more steps on each within (a)'s gates; ``python
   -m repro_torch.launch.train --arch olmo-1b --reduced --model-axis 2
   --steps 6 --ckpt-every 2 --fail-at 3`` on the card: ``restarts: 1`` and
   the uninterrupted run's final loss.  (e) the restored params served by
   ``Engine.build(mesh=tp2)`` (paged one_pass, bs 32, phase 4's prompts)
   against the one-device paged engine: prefill logits and 8
   teacher-forced decode steps bit for bit, K3 = K4 = 2 FIER layers × 8 ×
   2 shards and nothing else.  (c) ``compress_grads`` on tp2 x dp2, 2
   steps: finite, each tensor's 1-bit scale within
   ``COMPRESS_SCALE_REL_TOL`` of the one device's.  (b)
   granite-moe-1b-a400m, depth cut to 2 layers, at tp2 (EP, 16 experts per
   shard) and tp2 x dp2 (EP with FSDP-stored experts): at capacity 8.0 the
   MoE output within ``MOE_Y_REL_TOL`` of ``moe_apply``'s and the first
   loss within ``TRAIN_LOSS_REL_TOL`` of the one-device step's; at the
   config's factor each shard's dropped share beside the one device's, and
   the aux equal to the per-shard estimator (``MOE_AUX_REL_TOL``).
14. The reduced configs, the serve CLI and the examples (``reduced_path``).
   (a) Every config of the registry at ``reduced_config`` (d_head 16; the
   hybrid's 32) through ``Engine.build(n_slots=2, capacity=64,
   policy=serving_policy(budget=16, group=8, skip_layers=1))``, weights
   from a seeded ``torch.Generator`` on the card and copied to a CPU engine:
   the first decode step's K1/K2 held to their plain versions on every FIER
   layer's tensors; its logits within ``REDUCED_DECODE_REL_TOL`` of the CPU
   engine's decoding from the card's prefill cache, and a planted fault
   beyond that and beyond ``reduced_tol`` (K2 fed idx+1; mamba2: each row
   from the next row's state); the prefill's logits and the first step
   from each side's own prefill within ``reduced_tol`` (0.02 only in the
   configs whose prefill rounds apart there, ``REDUCED_ROUNDED_PREFILL``
   and ``REDUCED_ROUNDED_CACHE``, else ``REDUCED_LOGIT_REL_TOL``), the
   caches' differences logged (``cache_diffs``); ``generate`` of 8 greedy
   tokens with K1/K2 launched (FIER layers) × 7 times and nothing else.
   (b) reduced olmo-1b and llava through ``ContinuousScheduler`` on a slab
   and a paged engine (bs 8): equal tokens, each run's kernels (FIER
   layers) × its steps, a clean audit.  (c) ``repro_torch.launch.serve.main`` at ``--reduced``,
   slab (the reference pipeline: no kernel) and ``--paged`` (K3/K4), 12
   requests of 16 tokens each.  (d) the four ``examples/*_torch.py`` in
   this process: quickstart (no kernel), serve_longcontext (K1/K2 per FIER
   layer and step, every request whole), passkey (600 training steps, the
   four policies' accuracies reported, and SLM's with its first layer
   evicting too) and train_tiny_lm (2 restarts, the held-out loss of the
   final checkpoint below the initial weights').
15. Every d_head and rep served (``any_heads_path``): olmo-1b at full width
   and depth (random weights, seed 0, the default policy, 4 slots × 8192,
   phase 3's prompts) with three attention geometries (``ANY_GEOMETRIES``:
   G1 8 query heads on 1 kv head of d_head 256, gemma-2b's; G2 32 on 1 of
   64, multi-query; G3 21 on 3 of 96).  For each: prefill logits equal to
   the reference pipeline's; the first decode step within 0.018 of
   max|logit| of the plain versions' step and 0.023 of the reference's
   (phase 15's gates, set as phase 3's were), the planted K2 fault (and,
   with more than one kv head, the kv-head fault) above them, and the
   plain step with K2's plain version in f64 read beside it; the two_pass
   engine's first step from the same prefill cache (K6, K7, K2 14 times
   each) within the same gates; the slab and a paged engine (bs 32) for 8
   greedy steps with equal tokens and first logits, each launching its own
   K1/K2 or K3/K4 14 × steps and nothing else, the slab's profiled
   (device-busy ms/step, K1/K2 per launch).
16. The registry's two widest configs at full width (``wide_path``),
   depth cut to 8 layers (2 dense skip layers + 6 FIER layers) to fit the
   card: command-r-plus-104b (d_model 12288, 96 heads on 8 kv heads of 128,
   d_ff 33792, a tied 256,000-word head) and qwen3-moe-235b-a22b (d_model
   4096, 64 heads on 4 kv heads of 128, 128 experts top-8, an untied
   151,936-word head), both with bf16 params, random weights from a seeded
   ``torch.Generator``, ``Engine.build``'s default policy, 4 slots x 8192,
   prompts 8100/6000/3000/1500, each freed before the next: phase 9's drive
   with every check for both (prefill logits identical to the reference
   pipeline's; the first decode step within phase 9's 0.017·max|logit| of
   the plain versions' step with its two planted faults above it, qwen3's
   expert choices replayed where a near-tied router swapped one;
   ``generate`` of 16 tokens with K1/K2 launched 6 x 15 times and nothing
   else; paged vs slab with K3/K4 6 a step), peak memory over init, the
   prefill, the checks and the decode steps, TTFT, decode ms/step, a
   profiled step and the head's device ms alone.
17. The dry run (``launch/dryrun.py``) against the card (``dryrun_path``):
   (a) olmo-1b ``long_500k`` at cost depth 2, ``decode_32k`` at cost depth
   1 with its batch cut to 32, and training at B 4 x S 2048 at cost depth
   2, each traced on
   a 1 x 1 fake mesh and run for real on a 1 x 1 mesh of the card: the
   argument bytes and the FLOPs (``FlopCounterMode`` over the real step)
   equal, the peak within ``DRYRUN_PEAK_REL_TOL`` of the card's
   ``max_memory_allocated`` with two planted faults beyond it; (b) olmo-1b
   training on tp2 x dp2 (phase 13's cell, 1 layer), a ``long_500k`` layer over 4
   sequence shards and a serving decode step on placed params on tp2 x dp2
   (1 layer, 4 rows of 8192), every shard on the card: the collective
   records equal entry for entry, the peak of the sum over devices within the same
   tolerance, the decode's merges no larger than its partial outputs; (c)
   olmo-1b ``decode_32k`` at cost depth 1 on the 16 x 16 fake mesh, its
   record and seconds.  Every trace of the phase runs on the CPU in a
   subprocess that starts before phase 2 and sees no card.
18. One JSON line ``{"kernels": [...]}`` with each kernel's check, times,
   bound and launch count (K1/K2: phase 3; K3/K4: phase 5, phase 12's
   per-shard counts, (e)'s placed runs among them, in
   ``launches_sharded`` and phase 13(e)'s in
   ``launches_sharded_train``; K6/K7: phase 6's generate; K5/K8: phase 6's
   building blocks; phases 9, 10, 11(e), 14, 15 and 16's beside them, phase
   16's with its per-launch device times; the d_head
   16 and 32 entries of phase 2 under ``small_heads``, the generic layout's
   under ``any_heads``), the card line, and
   as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

# phase 11(c) runs under torch.use_deterministic_algorithms(True), which
# needs cuBLAS's workspace fixed before CUDA starts (the size PyTorch picks
# on Hopper anyway: 8 buffers of 4 MiB)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# main-path shapes (olmo-1b, Engine.build(n_slots=4, capacity=8192) defaults)
SLOTS, CAPACITY, GROUP, BUDGET, SINK, RECENT = 4, 8192, 32, 1024, 4, 64
BLOCK_SIZE = 32
DEVICE = "cuda"
CARD = "not read"  # the nvidia-smi card line, read in main()
N_LAYERS, SKIP = 16, 2
PROMPTS = (7900, 6000, 4000, 1500)
FIFTH_PROMPT = 3000
MAX_NEW = 32
EXTRA_STEPS = 8

# tolerances
K2_REL_TOL = 1e-4          # K2 vs plain: max |Δout| <= 1e-4 · max |out| (f32 sum order, exp)
# first decode step, as fractions of max |logit| (4.716 with these seeds), each
# set between the sound run's gap and the smaller planted fault's (PERF.md):
PLAIN_LOGIT_REL_TOL = 0.015  # kernels vs their plain versions: sound 0.0384, fault 0.1136
REF_LOGIT_REL_TOL = 0.02     # vs the reference pipeline: sound 0.0642, fault 0.1208


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing

class Timer:
    """Median device time of a callable, CUDA events around each launch,
    the L2 cache (50 MB) flushed by a 256 MB write before every launch
    (``clean=True``: by a 256 MB read, which leaves no dirty line for the
    timed work to write back).
    A ~3 ms device spin after the flush lets the host enqueue the timed
    work before the start event fires, so the wrapper's host-side
    overhead (checks, allocation, the ctypes call) is not in the window."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = 15, warmup: int = 3, clean: bool = False) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            if clean:
                self.flush_buf.sum()
            else:
                self.flush_buf.zero_()
            torch.cuda._sleep(5_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def in_turns(timer, plain, kernel, library):
    """plain, kernel, library, library, kernel, plain: mean of the two
    medians of each.  ``library`` None: no single call computes the
    function, its time is None."""
    t = {"plain": [], "kernel": [], "library": []}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        fn = {"plain": plain, "kernel": kernel, "library": library}[name]
        if fn is not None:
            t[name].append(timer(fn))
    return {k: (sum(v) / len(v) if v else None) for k, v in t.items()}


def once_each(timer, plain, kernel, library):
    """The kernel timed as ``in_turns`` times it (15 launches), its plain
    version and the library call once each over 3 launches: for the shapes
    where the plain version's time is information only."""
    return {"kernel": timer(kernel),
            "plain": timer(plain, iters=3, warmup=1),
            "library": None if library is None else timer(library, iters=3, warmup=1)}


def old_new(timer, old, new):
    """old, new, new, old: (mean of old's two medians, mean of new's)."""
    t = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        t[which].append(timer(old if which == "old" else new))
    return sum(t["old"]) / 2, sum(t["new"]) / 2


def nvcc_lib(src, tag):
    """``src`` (a .cu file; its directory's headers go into the hash) built
    with the port's flags into the build directory and loaded: for the
    comparison kernels of this script, which the port does not call."""
    import ctypes
    import glob
    import hashlib

    from repro_torch.kernels import build

    src = os.path.abspath(src)
    h = hashlib.sha1(open(src, "rb").read())
    for header in sorted(glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))):
        h.update(open(header, "rb").read())
    lib = build.BUILD_DIR / f"lib{tag}-{h.hexdigest()[:12]}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not lib.exists():
        res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    return ctypes.CDLL(str(lib))


EMPTY_KERNEL = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def empty_kernel_ms(torch, timer) -> float:
    """This timer's reading for an empty kernel (one CTA, launched through
    ctypes like the port's kernels): the floor under every time it gives."""
    import ctypes

    from repro_torch.kernels import build

    src = build.BUILD_DIR / "empty_kernel.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(EMPTY_KERNEL)
    fn = nvcc_lib(str(src), "empty_kernel").empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    return timer(run)


# ------------------------------------------------------------ phase 2

def scaled_lengths(B, S):
    """The main path's lengths 8192/5003/2100/700, scaled to a row of S."""
    return ([S] + [n * S // CAPACITY for n in (5003, 2100, 700)])[:B]


def make_inputs(torch, B, Hkv, rep, D, S, seed, group=GROUP):
    import numpy as np

    from repro_torch.core.quantize import quantize

    rng = np.random.default_rng(seed)
    ch = np.exp(rng.standard_normal(D)).astype(np.float32)  # per-channel spread
    K = torch.from_numpy((rng.standard_normal((B, S, Hkv, D)) * ch).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, Hkv, rep, D)).astype(np.float32))
    K, V, q = (t.to(DEVICE, torch.bfloat16) for t in (K, V, q))
    qk = quantize(K, group)
    lengths = torch.tensor(scaled_lengths(B, S), dtype=torch.int32, device=DEVICE)
    return q, K, V, qk, lengths


def check_kernels(torch, timer, shapes, timing=in_turns):
    import torch.nn.functional as F

    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels.check import selection_agrees

    rows = {"fier_retrieve": [], "fier_attend_selected": []}
    for (B, Hkv, rep, D, S, reduce) in shapes:
        q, K, V, qk, lengths = make_inputs(torch, B, Hkv, rep, D, S, seed=rep)
        sel = dict(group=GROUP, group_reduce=reduce, sink=SINK, recent=RECENT)
        args = (q, qk.codes, qk.scale, qk.zero, lengths, BUDGET)

        # ---- K1 against its plain version
        idx_k, tau_k, m_k = fr.fier_retrieve(*args, **sel)
        idx_p, tau_p, m_p = fr.fier_retrieve_plain(*args, **sel)
        torch.cuda.synchronize()
        s = fr.retrieval_scores(q, qk.codes, qk.scale, qk.zero, group=GROUP)
        kv = fr.masked_kv(s, lengths, SINK, RECENT, reduce)
        eps = score_eps(q, qk)
        ok, ndiff = selection_agrees(
            idx_k.reshape(B * Hkv, -1), idx_p.reshape(B * Hkv, -1),
            tau_k.reshape(-1), tau_p.reshape(-1), m_k.reshape(-1), m_p.reshape(-1),
            kv.reshape(B * Hkv, S), eps,
        )
        tau_err = float(torch.where(
            tau_k == tau_p, torch.zeros_like(tau_k), (tau_k - tau_p).abs()
        ).max())
        if not ok:
            raise AssertionError(
                f"K1 disagrees with its plain version at {(B, Hkv, rep, D, S, reduce)}: "
                f"{ndiff} differing indices, eps {eps:.3g}, tau err {tau_err:.3g}"
            )
        log(f"  K1 B={B} Hkv={Hkv} rep={rep} {reduce}: index sets agree "
            f"({ndiff} near-tau swaps, eps {eps:.3g}), tau err {tau_err:.3g}, "
            f"m equal {bool((m_k == m_p).all())}")
        kv_rows = kv.reshape(B * Hkv, S)
        t = timing(
            timer,
            lambda: fr.fier_retrieve_plain(*args, **sel),
            lambda: fr.fier_retrieve(*args, **sel),
            lambda: torch.topk(kv_rows, BUDGET, dim=-1),
        )
        rows["fier_retrieve"].append(dict(
            shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], max_abs_err=tau_err,
            **retrieval_work(q, lengths, S, BUDGET),
        ))

        # ---- K2 against its plain version, on K1's selection
        out_k = sa.fier_attend_selected(q, K, V, idx_k, lengths)
        out_p = sa.fier_attend_selected_plain(q, K, V, idx_k, lengths)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not (err <= K2_REL_TOL * scale and torch.isfinite(out_k).all()):
            raise AssertionError(
                f"K2 disagrees with its plain version at {(B, Hkv, rep, D, S)}: "
                f"max err {err:.3g} > {K2_REL_TOL} · {scale:.3g}"
            )
        log(f"  K2 B={B} Hkv={Hkv} rep={rep}: max |err| {err:.3g} "
            f"(<= {K2_REL_TOL}·max|out| = {K2_REL_TOL * scale:.3g})")
        mask = (idx_k < lengths[:, None, None])[:, :, None, :].expand(B, Hkv, rep, BUDGET)

        def library():
            from repro_torch.core.retrieval import gather_kv

            ks, vs = gather_kv(K, V, idx_k)
            return F.scaled_dot_product_attention(
                q, ks.transpose(1, 2), vs.transpose(1, 2), attn_mask=mask
            )

        t = timing(
            timer,
            lambda: sa.fier_attend_selected_plain(q, K, V, idx_k, lengths),
            lambda: sa.fier_attend_selected(q, K, V, idx_k, lengths),
            library,
        )
        rows["fier_attend_selected"].append(dict(
            shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], max_abs_err=err, **attend_work(q, idx_k, lengths),
        ))
        del q, K, V, qk, lengths, s, kv
        torch.cuda.empty_cache()
    return finish_rows(rows)


def retrieval_work(q, lengths, S, budget, table=None, group=GROUP):
    """Bytes and operations of one K1/K3 call: q, lengths (and the table),
    the outputs, and the side-car of the positions below each row's length
    (the kernel reads no chunk past it); ``bytes_full``: the side-car of
    whole rows.  Operations: 2·rep·D per valid token and kv head."""
    B, Hkv, rep, D = q.shape
    lens = [int(x) for x in lengths.tolist()]
    side = lambda n: Hkv * D * (-(-n // 8) + 4 * -(-n // group))  # codes + bf16 scale/zero
    fixed = q.numel() * 2 + B * 4 + B * Hkv * (budget + 2) * 4
    fixed += 0 if table is None else table.numel() * 4
    return dict(bytes=fixed + sum(side(n) for n in lens), bytes_full=fixed + B * side(S),
                flops=2 * Hkv * rep * D * sum(lens))


def long_inputs(torch, B, Hkv, rep, D, S, seed):
    """q and the quantized keys of a long row, made on the card from a seeded
    ``torch.Generator`` (numpy at this size would cost GBs of host memory);
    K only, no V."""
    from repro_torch.core.quantize import quantize

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ch = torch.randn(D, generator=gen, device=DEVICE).exp()  # per-channel spread
    K = (torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE) * ch).to(torch.bfloat16)
    q = torch.randn((B, Hkv, rep, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    qk = quantize(K, GROUP)
    del K
    return q, qk


# long and ragged rows: name, (B, Hkv, rep, S), budget, lengths
LONG_ROWS = (
    ("long_500k", (1, 16, 1, 524288), 4096, (524288,)),  # configs/base.py long_500k
    ("ragged_8160", (4, 16, 1, 8160), BUDGET, (8160, 5003, 2100, 700)),  # S % (C·32) != 0
)


def check_long_rows(torch, timer):
    """K1 and K3 beyond one CTA's shared memory and on a ragged split: K1
    against its plain version within ε, K3 bitwise K1 on a permuted pool
    with a null-block hole, and each timed in turns with its plain version
    and ``torch.topk``.  On the same rows K6 lies within ε of its plain
    version and K7, on the masked kv scores, gives its plain version's τ
    and m exactly (``long_500k``: every pass re-reads the row), each timed.
    Returns {kernel: {row name: row}}."""
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import topk_select as tk
    from repro_torch.kernels.check import selection_agrees

    out = {"fier_retrieve": {}, "fier_retrieve_paged": {}, "fier_score": {}, "topk_threshold": {}}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (B, Hkv, rep, S), budget, lens in LONG_ROWS:
        D = 128
        q, qk = long_inputs(torch, B, Hkv, rep, D, S, seed=S)
        lengths = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        sel = dict(group=GROUP, group_reduce="max", sink=SINK, recent=RECENT)
        args = (q, qk.codes, qk.scale, qk.zero, lengths, budget)
        idx1, tau1, m1 = fr.fier_retrieve(*args, **sel)
        idx_p, tau_p, m_p = fr.fier_retrieve_plain(*args, **sel)
        torch.cuda.synchronize()
        s = fr.retrieval_scores(q, qk.codes, qk.scale, qk.zero, group=GROUP)
        kv_rows = fr.masked_kv(s, lengths, SINK, RECENT, "max").reshape(B * Hkv, S)
        eps = score_eps(q, qk)

        # ---- K6 within ε of its plain version, K7 exactly its plain version's
        sargs = (q, qk.codes, qk.scale, qk.zero)
        s_k = fs.fier_score_scan(*sargs, group=GROUP)
        tau7, m7 = tk.fier_topk_threshold(kv_rows, budget)
        tau7_p, m7_p = tk.fier_topk_threshold_plain(kv_rows, budget)
        torch.cuda.synchronize()
        err6 = float((s_k - s).abs().max())
        if not (err6 <= eps and torch.isfinite(s_k).all()):
            raise AssertionError(f"K6 disagrees with its plain version on {name}: "
                                 f"{err6:.3g} > {eps:.3g}")
        if not (torch.equal(tau7, tau7_p) and torch.equal(m7, m7_p)):
            raise AssertionError(f"K7 differs from its plain version on {name}")
        log(f"  K6 {name} ({fs.score_plan(S, B * Hkv, n_sm)}): max |Δscore| {err6:.3g} "
            f"(<= {eps:.3g}); K7 ({tk.topk_plan(S, B * Hkv, n_sm)}): tau and m equal to its "
            f"plain version")
        t6 = in_turns(timer, lambda: fs.retrieval_scores(*sargs, group=GROUP),
                      lambda: fs.fier_score_scan(*sargs, group=GROUP), None)
        t7 = in_turns(timer, lambda: tk.fier_topk_threshold_plain(kv_rows, budget),
                      lambda: tk.fier_topk_threshold(kv_rows, budget),
                      lambda: torch.topk(kv_rows, budget, dim=-1).values[:, -1])
        out["fier_score"][name] = dict(
            shape=(B, Hkv, rep, D, S), ms=t6["kernel"], plain_ms=t6["plain"], library_ms=None,
            max_abs_err=err6, **score_work(*sargs, s_k))
        out["topk_threshold"][name] = dict(
            shape=(B, Hkv, rep, D, S), ms=t7["kernel"], plain_ms=t7["plain"],
            library_ms=t7["library"], max_abs_err=0.0, **topk_work(kv_rows))
        del s, s_k
        ok, ndiff = selection_agrees(
            idx1.reshape(B * Hkv, -1), idx_p.reshape(B * Hkv, -1), tau1.reshape(-1),
            tau_p.reshape(-1), m1.reshape(-1), m_p.reshape(-1), kv_rows, eps,
        )
        tau_err = float(torch.where(tau1 == tau_p, torch.zeros_like(tau1),
                                    (tau1 - tau_p).abs()).max())
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version on {name}: {ndiff} "
                                 f"differing indices, eps {eps:.3g}")
        del idx_p, tau_p, m_p
        plan = fr.retrieval_plan(S, B * Hkv, n_sm, d_head=D, rep=rep)
        log(f"  K1 {name} B={B} Hkv={Hkv} S={S} lengths {lens} ({plan}): index sets agree "
            f"({ndiff} near-tau swaps, eps {eps:.3g}), tau err {tau_err:.3g}")

        pools, table, _, _, sqk = paged_inputs(torch, q, None, None, qk, lengths, BLOCK_SIZE,
                                               spare=64, seed=S)
        kargs = (q, pools["codes"], pools["scale"], pools["zero"], lengths, budget)
        idx3, tau3, m3 = fr.fier_retrieve(*kargs, block_table=table, **sel)
        idx1, tau1, m1 = fr.fier_retrieve(q, sqk.codes, sqk.scale, sqk.zero, lengths, budget, **sel)
        torch.cuda.synchronize()
        if not (torch.equal(idx3, idx1) and torch.equal(tau3, tau1) and torch.equal(m3, m1)):
            raise AssertionError(f"K3 differs from K1 on the gathered slab on {name}")
        log(f"  K3 {name}: idx, tau, m bitwise equal to K1 on the gathered slab "
            f"({fr.retrieval_plan(S, B * Hkv, n_sm, BLOCK_SIZE, d_head=D, rep=rep)})")
        del sqk
        topk = lambda: torch.topk(kv_rows, budget, dim=-1)
        t1 = in_turns(timer, lambda: fr.fier_retrieve_plain(*args, **sel),
                      lambda: fr.fier_retrieve(*args, **sel), topk)
        ptable = dict(sel, block_table=table)
        t3 = in_turns(
            timer,
            lambda: fr.fier_retrieve_paged_plain(
                q, pools["codes"], pools["scale"], pools["zero"], table, lengths, budget, **sel),
            lambda: fr.fier_retrieve(*kargs, **ptable), topk,
        )
        for kname, t, tab in (("fier_retrieve", t1, None), ("fier_retrieve_paged", t3, table)):
            out[kname][name] = dict(
                shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
                library_ms=t["library"], max_abs_err=tau_err,
                **retrieval_work(q, lengths, S, budget, tab),
            )
        del q, qk, pools, table, kv_rows
        torch.cuda.empty_cache()
    for kname, rs in out.items():
        finish_rows({f"{kname} {n}": [r] for n, r in rs.items()})
    return out


def topk_rows(torch, R, S, seed):
    """Score rows [R, S] on the card built like the CPU tests' K7 rows:
    quarter-step values (many exact ties), a ±0.0 mix, +inf sink and recent
    windows before a −1e30 tail past a length, an all-tied row, a row with
    fewer valid scores than the budget, alternating ±0.0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = np.round(rng.standard_normal((max(R, 5), S)) * 4) / 4
    s[0, ::7] = 0.0
    s[0, 3::7] = -0.0
    n = S - S // 5  # row 1's length
    s[1, :SINK] = np.inf
    s[1, n - RECENT:n] = np.inf
    s[1, n:] = -1e30
    s[2, :] = 1.5
    s[3, 700:] = -1e30
    s[4, ::2] = -0.0
    s[4, 1::2] = 0.0
    return torch.from_numpy(s[-R:].astype(np.float32)).to(DEVICE)  # fewer than 5 rows: the last


# K7 on adversarial rows (``topk_rows``): name, (rows, S).  One CTA per row
# at S = 8192 (16 and 64 rows) and at an odd S, whose rows start off a
# 16-byte boundary (4-byte copies at a range's ends); rows split over a
# cluster (topk_plan: C = 2 at 64 rows of 16,384, C = 8 at 16 rows of
# 65,536) with keys in shared memory, and at an odd S with a ragged last CTA.
TOPK_ROWS = (
    ("rows16_8192", (16, CAPACITY)),
    ("rows64_8192", (64, CAPACITY)),
    ("rows16_8191", (16, CAPACITY - 1)),
    ("rows64_16384", (64, 2 * CAPACITY)),
    ("rows16_65536", (16, 8 * CAPACITY)),
    ("rows4_65533", (4, 8 * CAPACITY - 3)),
)


def check_score_topk_variants(torch, timer):
    """K6 at rep 8 (the most query heads of the serving instantiation; reps
    12 and 16 run in ``FAMILY_SHAPES``) within ε of its plain version, and K7 on
    ``TOPK_ROWS`` at budgets 1, 1024 and S: τ and m exactly its plain
    version's; each timed (K7 at budget 1024).  Returns {kernel: {name: row}}."""
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import topk_select as tk

    out = {"fier_score": {}, "topk_threshold": {}}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    B, Hkv, rep, D, S = SLOTS, 2, 8, 128, CAPACITY
    q, _, _, qk, _ = make_inputs(torch, B, Hkv, rep, D, S, seed=30)
    args = (q, qk.codes, qk.scale, qk.zero)
    s_k = fs.fier_score_scan(*args, group=GROUP)
    s_p = fs.retrieval_scores(*args, group=GROUP)
    torch.cuda.synchronize()
    eps = score_eps(q, qk)
    err = float((s_k - s_p).abs().max())
    if not (err <= eps and torch.isfinite(s_k).all()):
        raise AssertionError(f"K6 disagrees with its plain version at rep {rep}: "
                             f"{err:.3g} > {eps:.3g}")
    t = in_turns(timer, lambda: fs.retrieval_scores(*args, group=GROUP),
                 lambda: fs.fier_score_scan(*args, group=GROUP), None)
    out["fier_score"]["rep8"] = dict(
        shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
        max_abs_err=err, **score_work(*args, s_k))
    log(f"  K6 rep 8 {(B, Hkv, rep, D, S)} ({fs.score_plan(S, B * Hkv, n_sm)}): "
        f"max |Δscore| {err:.3g} (<= {eps:.3g})")
    del q, qk, args, s_k, s_p

    for name, (R, S) in TOPK_ROWS:
        rows = topk_rows(torch, R, S, seed=R + S)
        for budget in (1, BUDGET, S):
            tau, m = tk.fier_topk_threshold(rows, budget)
            tau_p, m_p = tk.fier_topk_threshold_plain(rows, budget)
            torch.cuda.synchronize()
            if not (torch.equal(tau, tau_p) and torch.equal(m, m_p)):
                bad = int(((tau != tau_p) | (m != m_p)).sum())
                raise AssertionError(f"K7 differs from its plain version on {name} at budget "
                                     f"{budget}: {bad} rows")
        t = in_turns(timer, lambda: tk.fier_topk_threshold_plain(rows, BUDGET),
                     lambda: tk.fier_topk_threshold(rows, BUDGET),
                     lambda: torch.topk(rows, BUDGET, dim=-1).values[:, -1])
        out["topk_threshold"][name] = dict(
            shape=(R, S), ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
            max_abs_err=0.0, **topk_work(rows))
        log(f"  K7 {name} ({tk.topk_plan(S, R, n_sm)}): tau and m equal to its plain version "
            f"at budgets 1, {BUDGET}, {S}")
        del rows
    for kname, rs in out.items():
        finish_rows({f"{kname} {n}": [r] for n, r in rs.items()})
    return out


def paged_inputs(torch, q, K, V, qk, lengths, bs, spare, seed):
    """The slab's blocks scattered into a random permutation of pool blocks
    (with ``spare`` unused blocks), and one table entry of row 1 (row 0 when
    B = 1) inside its length pointed at the null block 0, which holds
    non-zero data.  Returns the pools, the table and the logical slabs the
    table gathers (what K1 and K2 see); K and V None: the side-car only."""
    import numpy as np

    from repro_torch.core.quantize import QuantizedKeys
    from repro_torch.kvcache.paged import gather_block_rows

    B, S = qk.codes.shape[0], qk.codes.shape[1] * 8
    nb = S // bs
    N = 1 + B * nb + spare
    rng = np.random.default_rng(seed)
    perm = 1 + rng.permutation(N - 1)[: B * nb]
    table = torch.from_numpy(perm.reshape(B, nb).astype(np.int32)).to(q.device)
    r = min(1, B - 1)
    hole = int(lengths[r]) // bs // 2  # a block well inside the row's length
    table[r, hole] = 0

    def to_pool(a, fill):
        pb = a.shape[1] // nb
        pool = torch.empty((N, pb, *a.shape[2:]), dtype=a.dtype, device=a.device)
        pool[0] = fill(pool[0])
        ids = torch.from_numpy(perm.astype(np.int64)).to(a.device)
        pool[ids] = a.reshape(B * nb, pb, *a.shape[2:])
        pool[torch.from_numpy(np.setdiff1d(np.arange(1, N), perm)).to(a.device)] = 0
        return pool

    noise = lambda t: torch.randn(t.shape, device=t.device).to(t.dtype)
    pools = {} if K is None else dict(k=to_pool(K, noise), v=to_pool(V, noise))
    pools.update(
        codes=to_pool(qk.codes, lambda t: torch.randint_like(t, 1, 256)),
        scale=to_pool(qk.scale, lambda t: noise(t).abs() + 0.5),
        zero=to_pool(qk.zero, noise),
    )
    g = lambda a: gather_block_rows(a, table)
    slab_qk = QuantizedKeys(g(pools["codes"]), g(pools["scale"]), g(pools["zero"]), qk.group)
    if K is None:
        return pools, table, None, None, slab_qk
    return pools, table, g(pools["k"]), g(pools["v"]), slab_qk


def check_paged_kernels(torch, timer, shapes, timing=in_turns):
    """K3 and K4 on a permuted pool with a null-block hole: each against its
    plain version, and bitwise against K1 / K2 on the gathered slab."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import sparse_attention as sa

    rows = {"fier_retrieve_paged": [], "fier_attend_selected_paged": []}
    for (B, Hkv, rep, D, S, reduce) in shapes:
        q, K, V, qk, lengths = make_inputs(torch, B, Hkv, rep, D, S, seed=rep + 10)
        pools, table, Ks, Vs, sqk = paged_inputs(
            torch, q, K, V, qk, lengths, BLOCK_SIZE, spare=64, seed=rep
        )
        del K, V, qk
        sel = dict(group=GROUP, group_reduce=reduce, sink=SINK, recent=RECENT)
        pargs = (q, pools["codes"], pools["scale"], pools["zero"], table, lengths, BUDGET)
        kargs = (q, pools["codes"], pools["scale"], pools["zero"], lengths, BUDGET)
        ksel = dict(sel, block_table=table)

        # ---- K3: bitwise K1 on the gathered slab, and its plain version
        idx3, tau3, m3 = fr.fier_retrieve(*kargs, **ksel)
        idx1, tau1, m1 = fr.fier_retrieve(
            q, sqk.codes, sqk.scale, sqk.zero, lengths, BUDGET, **sel
        )
        idx_p, tau_p, m_p = fr.fier_retrieve_paged_plain(*pargs, **sel)
        torch.cuda.synchronize()
        if not (torch.equal(idx3, idx1) and torch.equal(tau3, tau1) and torch.equal(m3, m1)):
            raise AssertionError(f"K3 differs from K1 on the gathered slab at "
                                 f"{(B, Hkv, rep, D, S, reduce)}")
        # K1 on the same slab passed the plain-version check in phase 2's
        # first half; K3 = K1 bitwise, so the same near-τ band applies here
        s = fr.retrieval_scores(q, sqk.codes, sqk.scale, sqk.zero, group=GROUP)
        kv = fr.masked_kv(s, lengths, SINK, RECENT, reduce)
        eps = score_eps(q, sqk)
        from repro_torch.kernels.check import selection_agrees

        ok, ndiff = selection_agrees(
            idx3.reshape(B * Hkv, -1), idx_p.reshape(B * Hkv, -1),
            tau3.reshape(-1), tau_p.reshape(-1), m3.reshape(-1), m_p.reshape(-1),
            kv.reshape(B * Hkv, S), eps,
        )
        tau_err = float(torch.where(tau3 == tau_p, torch.zeros_like(tau3),
                                    (tau3 - tau_p).abs()).max())
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version: {ndiff} indices")
        log(f"  K3 B={B} Hkv={Hkv} rep={rep} {reduce}: idx, tau, m bitwise equal to K1 on "
            f"the gathered slab; vs plain: {ndiff} near-tau swaps, tau err {tau_err:.3g}")
        kv_rows = kv.reshape(B * Hkv, S)
        t = timing(
            timer,
            lambda: fr.fier_retrieve_paged_plain(*pargs, **sel),
            lambda: fr.fier_retrieve(*kargs, **ksel),
            lambda: torch.topk(kv_rows, BUDGET, dim=-1),
        )
        rows["fier_retrieve_paged"].append(dict(
            shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], max_abs_err=tau_err,
            **retrieval_work(q, lengths, S, BUDGET, table),
        ))

        # ---- K4: bitwise K2 on the gathered slab, and its plain version
        out4 = sa.fier_attend_selected(
            q, pools["k"], pools["v"], idx3, lengths, block_table=table
        )
        out2 = sa.fier_attend_selected(q, Ks, Vs, idx3, lengths)
        out_p = sa.fier_attend_selected_paged_plain(
            q, pools["k"], pools["v"], table, idx3, lengths
        )
        torch.cuda.synchronize()
        if not torch.equal(out4, out2):
            raise AssertionError(f"K4 differs from K2 on the gathered slab: max "
                                 f"{float((out4 - out2).abs().max()):.3g}")
        err = float((out4 - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not (err <= K2_REL_TOL * scale and torch.isfinite(out4).all()):
            raise AssertionError(f"K4 disagrees with its plain version: {err:.3g} > "
                                 f"{K2_REL_TOL} · {scale:.3g}")
        log(f"  K4 B={B} Hkv={Hkv} rep={rep}: bitwise equal to K2 on the gathered slab; "
            f"vs plain max |err| {err:.3g} (<= {K2_REL_TOL * scale:.3g})")
        mask = (idx3 < lengths[:, None, None])[:, :, None, :].expand(B, Hkv, rep, BUDGET)
        kflat = pools["k"].reshape(-1, Hkv, D)
        vflat = pools["v"].reshape(-1, Hkv, D)
        heads = torch.arange(Hkv, device=q.device)[None, :, None]

        def library():
            prow = table.long().gather(1, (idx3 // BLOCK_SIZE).long().reshape(B, -1))
            prow = prow.reshape(idx3.shape) * BLOCK_SIZE + (idx3 % BLOCK_SIZE)
            ks, vs = kflat[prow, heads], vflat[prow, heads]  # [B, Hkv, budget, D]
            return F.scaled_dot_product_attention(q, ks, vs, attn_mask=mask)

        t = timing(
            timer,
            lambda: sa.fier_attend_selected_paged_plain(
                q, pools["k"], pools["v"], table, idx3, lengths),
            lambda: sa.fier_attend_selected(
                q, pools["k"], pools["v"], idx3, lengths, block_table=table),
            library,
        )
        rows["fier_attend_selected_paged"].append(dict(
            shape=(B, Hkv, rep, D, S), ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], max_abs_err=err, **attend_work(q, idx3, lengths, table),
        ))
        del q, pools, Ks, Vs, sqk, s, kv
        torch.cuda.empty_cache()
    return finish_rows(rows)


def check_scoring(torch, timer, shape, *, group=GROUP, budget=BUDGET, bs=BLOCK_SIZE, sink=SINK,
                  recent=RECENT, turns=True, make=make_inputs):
    """K1, K3 and K6 at one shape (B, Hkv, rep, D, S, group reduction):
    K1 against its plain version (index sets equal up to near-τ swaps
    within ε), K3 bitwise K1 on a permuted pool (blocks of ``bs``) with a
    null-block hole, K6 within ε of its plain version; each timed in turns
    with its plain version and, for K1/K3, ``torch.topk`` of the masked
    scores (``turns`` False: the kernel, then its plain version and the
    library call once each with fewer launches; ``make``: the inputs' maker,
    ``make_inputs`` or ``device_inputs``).  Returns {kernel name: row}."""
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels.check import selection_agrees

    B, Hkv, rep, D, S, reduce = shape
    q, K, V, qk, lengths = make(torch, B, Hkv, rep, D, S, seed=rep + 30, group=group)
    pools, table, _, _, sqk = paged_inputs(torch, q, None, None, qk, lengths, bs,
                                           spare=64, seed=rep)
    del K, V
    sel = dict(group=group, group_reduce=reduce, sink=sink, recent=recent)
    args = (q, qk.codes, qk.scale, qk.zero, lengths, budget)
    pargs = (q, pools["codes"], pools["scale"], pools["zero"], lengths, budget)
    idx_k, tau_k, m_k = fr.fier_retrieve(*args, **sel)
    idx_p, tau_p, m_p = fr.fier_retrieve_plain(*args, **sel)
    idx3, tau3, m3 = fr.fier_retrieve(*pargs, **sel, block_table=table)
    idx1, tau1, m1 = fr.fier_retrieve(q, sqk.codes, sqk.scale, sqk.zero, lengths, budget, **sel)
    s_k = fs.fier_score_scan(q, qk.codes, qk.scale, qk.zero, group=group)
    s_p = fr.retrieval_scores(q, qk.codes, qk.scale, qk.zero, group=group)
    torch.cuda.synchronize()
    eps = score_eps(q, qk)
    kv = fr.masked_kv(s_p, lengths, sink, recent, reduce).reshape(B * Hkv, S)
    ok, ndiff = selection_agrees(
        idx_k.reshape(B * Hkv, -1), idx_p.reshape(B * Hkv, -1), tau_k.reshape(-1),
        tau_p.reshape(-1), m_k.reshape(-1), m_p.reshape(-1), kv, eps,
    )
    tau_err = float(torch.where(tau_k == tau_p, torch.zeros_like(tau_k),
                                (tau_k - tau_p).abs()).max())
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at {shape}: {ndiff} indices")
    if not (torch.equal(idx3, idx1) and torch.equal(tau3, tau1) and torch.equal(m3, m1)):
        raise AssertionError(f"K3 differs from K1 on the gathered slab at {shape}")
    s_err = float((s_k - s_p).abs().max())
    if not (s_err <= eps and torch.isfinite(s_k).all()):
        raise AssertionError(f"K6 disagrees with its plain version at {shape}: "
                             f"{s_err:.3g} > {eps:.3g}")
    log(f"  K1/K3/K6 {shape} g={group} budget={budget}: K1 vs plain {ndiff} near-tau swaps "
        f"(eps {eps:.3g}), tau err {tau_err:.3g}; K3 bitwise K1 on the gathered slab (bs {bs}); "
        f"K6 max |Δscore| {s_err:.3g}")
    plain1 = lambda: fr.fier_retrieve_plain(*args, **sel)
    kernel1 = lambda: fr.fier_retrieve(*args, **sel)
    plain3 = lambda: fr.fier_retrieve_paged_plain(
        q, pools["codes"], pools["scale"], pools["zero"], table, lengths, budget, **sel)
    kernel3 = lambda: fr.fier_retrieve(*pargs, **sel, block_table=table)
    topk = lambda: torch.topk(kv, budget, dim=-1)
    plain6 = lambda: fr.retrieval_scores(q, qk.codes, qk.scale, qk.zero, group=group)
    kernel6 = lambda: fs.fier_score_scan(q, qk.codes, qk.scale, qk.zero, group=group)
    timing = in_turns if turns else once_each
    t1 = timing(timer, plain1, kernel1, topk)
    t3 = timing(timer, plain3, kernel3, topk)
    t6 = timing(timer, plain6, kernel6, None)
    sh = (B, Hkv, rep, D, S)
    rows = {
        "fier_retrieve": [dict(shape=sh, ms=t1["kernel"], plain_ms=t1["plain"],
                               library_ms=t1["library"], max_abs_err=tau_err,
                               **retrieval_work(q, lengths, S, budget, group=group))],
        "fier_retrieve_paged": [dict(shape=sh, ms=t3["kernel"], plain_ms=t3["plain"],
                                     library_ms=t3["library"], max_abs_err=tau_err,
                                     **retrieval_work(q, lengths, S, budget, table,
                                                      group=group))],
        "fier_score": [dict(shape=sh, ms=t6["kernel"], plain_ms=t6["plain"], library_ms=None,
                            max_abs_err=s_err, **score_work(q, qk.codes, qk.scale, qk.zero, s_k))],
    }
    del q, qk, pools, table, sqk, s_k, s_p, kv
    torch.cuda.empty_cache()
    return {k: v[0] for k, v in finish_rows(rows).items()}


def byte_diff(torch, a, b) -> int:
    """Bytes in which two tensors of one shape and dtype differ."""
    as_bytes = lambda t: t.contiguous().view(torch.uint8)
    return int((as_bytes(a) != as_bytes(b)).sum())


def score_work(q, codes, scale, zero, out):
    """Bytes and operations of one K6 call: its four inputs read once, the
    f32 scores written once; 2·D operations per token and query head."""
    B, Hkv, rep, D = q.shape
    nbytes = sum(a.numel() * a.element_size() for a in (q, codes, scale, zero)) + out.numel() * 4
    return dict(bytes=nbytes, flops=2 * B * Hkv * rep * out.shape[-1] * D)


def topk_work(scores):
    """Bytes of one K7 call: the f32 rows read once, τ and m written."""
    return dict(bytes=scores.numel() * 4 + scores.shape[0] * 8, flops=0)


def score_eps(q, qk):
    """ε, the bound between a kernel's scores (K1/K3/K6) and its plain
    version's: both sum the same exact f32 products (bf16 q × bf16 a) in
    other orders, so |Δscore| <= D·2^-23 · rep · max Σ_d |q_d|·|a_td|."""
    B, Hkv, rep, D = q.shape
    amax = (qk.scale.float().abs() + qk.zero.float().abs()).amax()
    return float(D * 2.0**-23 * rep * q.float().abs().sum(-1).amax() * amax)


def check_unfused_kernels(torch, timer, shapes, baseline=None, timing=in_turns):
    """K5–K8 against their plain versions, K8 bitwise against K2 on the same
    selection, and ``ops.fier_decode_two_pass`` against
    ``ops.fier_decode_one_pass``: idx, τ, m and output bit for bit under
    ``max``, the index set within ε of τ under ``sum`` (the group sum runs
    in torch's order there, in K1's inside K1).  ``baseline``
    (``baseline_unfused``): K6 and K7 of another source, held bitwise to
    these and timed in turns with them.  ``timing``: how each kernel is
    timed beside its plain version (``in_turns`` or ``once_each``)."""
    import torch.nn.functional as F

    from repro_torch.core import retrieval
    from repro_torch.core.policy import CacheView
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack_quantize as pq
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels import topk_select as tk
    from repro_torch.kernels.check import selection_agrees

    rows = {"pack_quantize": [], "fier_score": [], "topk_threshold": [], "sparse_attention": []}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for (B, Hkv, rep, D, S, reduce) in shapes:
        q, K, V, qk, lengths = make_inputs(torch, B, Hkv, rep, D, S, seed=rep + 20)
        shape = (B, Hkv, rep, D, S)
        sel = dict(group_reduce=reduce, sink=SINK, recent=RECENT)

        # ---- K5: bitwise its plain version; bytes off build_metadata's side-car
        got = pq.fier_pack_quantize(K, GROUP)
        want = pq.fier_pack_quantize_plain(K, GROUP)
        torch.cuda.synchronize()
        for name, a, b in zip(("codes", "scale", "zero"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"K5 {name} differs from its plain version at {shape}: "
                                     f"{byte_diff(torch, a, b)} bytes")
        side = (qk.codes, qk.scale, qk.zero)  # quantize(K), what build_metadata returns
        off_bf16 = [byte_diff(torch, a, b) for a, b in zip(got, side)]
        Kf = K.float()
        qf = quantize(Kf, GROUP)
        off_f32 = [byte_diff(torch, a, b) for a, b in
                   zip(pq.fier_pack_quantize(Kf, GROUP), (qf.codes, qf.scale, qf.zero))]
        del Kf, qf
        log(f"  K5 {shape}: codes/scale/zero bitwise equal to its plain version; bytes "
            f"differing from build_metadata's side-car (codes, scale, zero): bf16 keys "
            f"{off_bf16}, f32 keys {off_f32}")
        t = timing(timer, lambda: pq.fier_pack_quantize_plain(K, GROUP),
                     lambda: pq.fier_pack_quantize(K, GROUP), None)
        nbytes = K.numel() * 2 + sum(a.numel() * a.element_size() for a in got)
        rows["pack_quantize"].append(dict(
            shape=shape, ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
            bytes=nbytes, flops=0, max_abs_err=0.0, bytes_off_side_car_bf16=sum(off_bf16),
            bytes_off_side_car_f32=sum(off_f32),
        ))

        # ---- K6: within the f32 summation-order bound of its plain version
        args = (q, qk.codes, qk.scale, qk.zero)
        s_k = fs.fier_score_scan(*args, group=GROUP)
        s_p = fs.retrieval_scores(*args, group=GROUP)
        torch.cuda.synchronize()
        eps = score_eps(q, qk)
        err = float((s_k - s_p).abs().max())
        if not (err <= eps and torch.isfinite(s_k).all()):
            raise AssertionError(f"K6 disagrees with its plain version at {shape}: "
                                 f"{err:.3g} > {eps:.3g}")
        log(f"  K6 {shape} ({fs.score_plan(S, B * Hkv, n_sm)}): max |Δscore| {err:.3g} "
            f"(<= {eps:.3g})")
        t = timing(timer, lambda: fs.retrieval_scores(*args, group=GROUP),
                     lambda: fs.fier_score_scan(*args, group=GROUP), None)
        row = dict(shape=shape, ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
                   max_abs_err=err, **score_work(*args, s_k))
        if baseline is not None:
            if not torch.equal(baseline["fier_score"](*args), s_k):
                raise AssertionError(f"the baseline K6 differs from K6 at {shape}")
            row["baseline_ms"], row["ms_in_turns"] = old_new(
                timer, lambda: baseline["fier_score"](*args),
                lambda: fs.fier_score_scan(*args, group=GROUP))
            log(f"  K6 {shape} in turns with the baseline (bitwise equal): baseline "
                f"{row['baseline_ms']:.4f} ms, K6 {row['ms_in_turns']:.4f} ms")
        rows["fier_score"].append(row)

        # ---- K7: tau and m exactly its plain version's
        masked = fr.masked_kv(s_k, lengths, SINK, RECENT, reduce).reshape(B * Hkv, S)
        tau_k, m_k = tk.fier_topk_threshold(masked, BUDGET)
        tau_p, m_p = tk.fier_topk_threshold_plain(masked, BUDGET)
        torch.cuda.synchronize()
        if not (torch.equal(tau_k, tau_p) and torch.equal(m_k, m_p)):
            raise AssertionError(f"K7 differs from its plain version at {shape}")
        log(f"  K7 {shape} {reduce} ({tk.topk_plan(S, B * Hkv, n_sm)}): tau and m equal to "
            f"its plain version")
        t = timing(timer, lambda: tk.fier_topk_threshold_plain(masked, BUDGET),
                     lambda: tk.fier_topk_threshold(masked, BUDGET),
                     lambda: torch.topk(masked, BUDGET, dim=-1).values[:, -1])
        row = dict(shape=shape, ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
                   max_abs_err=0.0, **topk_work(masked))
        if baseline is not None:
            old_tau, old_m = baseline["topk_threshold"](masked, BUDGET)
            if not (torch.equal(old_tau, tau_k) and torch.equal(old_m, m_k)):
                raise AssertionError(f"the baseline K7 differs from K7 at {shape}")
            row["baseline_ms"], row["ms_in_turns"] = old_new(
                timer, lambda: baseline["topk_threshold"](masked, BUDGET),
                lambda: tk.fier_topk_threshold(masked, BUDGET))
            log(f"  K7 {shape} in turns with the baseline (equal): baseline "
                f"{row['baseline_ms']:.4f} ms, K7 {row['ms_in_turns']:.4f} ms")
        rows["topk_threshold"].append(row)

        # ---- the two pipelines on one slab view
        view = CacheView.slab(K, V, qk, lengths)
        q3 = q.reshape(B, Hkv * rep, D)
        idx1, tau1, m1 = ops.retrieve(q3, view, BUDGET, return_stats=True, **sel)
        idx2 = tk.compact_indices(masked, tau_k, m_k, BUDGET).reshape(B, Hkv, BUDGET)
        one = ops.fier_decode_one_pass(q3, view, BUDGET, **sel)
        two = ops.fier_decode_two_pass(q3, view, BUDGET, **sel)
        torch.cuda.synchronize()
        if reduce == "max":
            same = (torch.equal(idx1, idx2) and torch.equal(tau1.reshape(-1), tau_k)
                    and torch.equal(m1.reshape(-1), m_k) and torch.equal(one, two))
            if not same:
                raise AssertionError(f"two_pass differs from one_pass at {shape} (max)")
            log(f"  two_pass vs one_pass {shape} max: idx, tau, m and output bit for bit")
        else:
            ok, ndiff = selection_agrees(
                idx1.reshape(B * Hkv, -1), idx2.reshape(B * Hkv, -1), tau1.reshape(-1), tau_k,
                m1.reshape(-1), m_k, masked, eps,
            )
            if not ok:
                raise AssertionError(f"two_pass selects other tokens than one_pass at {shape}: "
                                     f"{ndiff} indices outside eps {eps:.3g}")
            log(f"  two_pass vs one_pass {shape} sum: index sets agree ({ndiff} near-tau "
                f"swaps, eps {eps:.3g}); outputs equal {torch.equal(one, two)}")

        # ---- K8: its plain version, and K2 bit for bit on the same selection
        ks, vs = retrieval.gather_kv(K, V, idx1)
        mask = (idx1 < lengths[:, None, None]).to(torch.int8)
        out8 = sa.fier_attend_gathered(q, ks, vs, mask)
        out2 = sa.fier_attend_selected(q, K, V, idx1, lengths)
        out_p = sa.fier_attend_gathered_plain(q, ks, vs, mask)
        torch.cuda.synchronize()
        if not torch.equal(out8, out2):
            raise AssertionError(f"K8 differs from K2 on the same selection at {shape}: max "
                                 f"{float((out8 - out2).abs().max()):.3g}")
        err = float((out8 - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not (err <= K2_REL_TOL * scale and torch.isfinite(out8).all()):
            raise AssertionError(f"K8 disagrees with its plain version at {shape}: "
                                 f"{err:.3g} > {K2_REL_TOL} · {scale:.3g}")
        log(f"  K8 {shape}: bitwise equal to K2 on gather_kv of its selection; vs plain "
            f"max |err| {err:.3g} (<= {K2_REL_TOL * scale:.3g})")
        amask = mask.bool()[:, :, None, :].expand(B, Hkv, rep, BUDGET)

        def library():
            ks_, vs_ = retrieval.gather_kv(K, V, idx1)
            return F.scaled_dot_product_attention(
                q, ks_.transpose(1, 2), vs_.transpose(1, 2), attn_mask=amask
            )

        t = timing(timer, lambda: sa.fier_attend_gathered_plain(q, ks, vs, mask),
                     lambda: sa.fier_attend_gathered(q, ks, vs, mask), library)
        rows["sparse_attention"].append(dict(
            shape=shape, ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
            max_abs_err=err, **attend_work(q, idx1, lengths, mask=mask),
        ))
        del q, K, V, qk, lengths, got, want, s_k, s_p, masked, ks, vs, view
        torch.cuda.empty_cache()
    return finish_rows(rows)


# K2/K4/K8 beyond the main path's shape: name, (B, Hkv, rep, D), budget.
# Every (d_head, rep) the kernel admits (sparse_attention.KERNEL_HEAD_DIMS x
# KERNEL_REPS), the ladder's budget 512, a budget no multiple of the plan's
# step (1000), and the budget of a whole row (8192: a CTA's 4096 slots exceed
# MAX_CHUNK, so it finds its rows in two chunks).
ATTEND_VARIANTS = (
    ("serving", (SLOTS, 16, 1, 128), BUDGET),
    ("budget_512", (SLOTS, 16, 1, 128), 512),
    ("budget_1000", (SLOTS, 16, 1, 128), 1000),
    ("budget_8192", (SLOTS, 16, 1, 128), CAPACITY),
    ("rep2", (SLOTS, 8, 2, 128), BUDGET),
    ("gqa_rep4", (SLOTS, 4, 4, 128), BUDGET),
    ("rep8", (SLOTS, 2, 8, 128), BUDGET),
    ("rep12", (SLOTS, 2, 12, 128), BUDGET),
    ("rep16", (SLOTS, 4, 16, 128), BUDGET),
    ("rep16_budget_8192", (SLOTS, 4, 16, 128), CAPACITY),
    ("d64_rep1", (SLOTS, 36, 1, 64), BUDGET),
    ("d64_rep2", (SLOTS, 8, 2, 64), BUDGET),
    ("d64_rep4", (SLOTS, 4, 4, 64), 1000),
    ("d64_rep8", (SLOTS, 2, 8, 64), BUDGET),
    ("d64_rep12", (SLOTS, 2, 12, 64), 512),
    ("d64_rep16", (SLOTS, 4, 16, 64), CAPACITY),
    ("d112_rep1", (SLOTS, 32, 1, 112), 1000),
    ("d112_rep1_budget_8192", (SLOTS, 32, 1, 112), CAPACITY),
)

# The kernel shapes of the configs that phases 9, 10 and 16 serve (g 32, budget
# 1024, lengths S/5003/2100/700 scaled to S): (B, Hkv, rep, D, S, group
# reduction) -> config.  Phase 2 holds K1-K8 to their plain versions at each,
# as at the main path's.  zamba2-7b's shared attention block is the d_head
# 112 shape; whisper-small's decoder self-attention runs at capacity 4096.
FAMILY_SHAPES = {
    "granite-moe-1b-a400m": (SLOTS, 8, 2, 64, CAPACITY, "max"),
    "minicpm-2b": (SLOTS, 36, 1, 64, CAPACITY, "max"),
    "starcoder2-3b": (SLOTS, 2, 12, 128, CAPACITY, "max"),
    "command-r-plus-104b": (SLOTS, 8, 12, 128, CAPACITY, "max"),
    "qwen3-moe-235b-a22b": (SLOTS, 4, 16, 128, CAPACITY, "max"),
    "zamba2-7b": (SLOTS, 32, 1, 112, CAPACITY, "max"),
    "whisper-small": (SLOTS, 12, 1, 64, 4096, "max"),
}
# K1/K3/K6 take any rep up to 16 at every d_head: one GQA rep at d_head 112
# (K2/K4/K8 take rep 1 only there), with the group sum
D112_GQA_SHAPE = (SLOTS, 8, 4, 112, CAPACITY, "sum")


def attend_inputs(torch, B, Hkv, rep, D, S, budget, seed, lens=None):
    """q, K, V, lengths (``lens``, by default S/5003/2100/700) and a
    selection for K2, made on the card from a seeded ``torch.Generator``:
    per (b, h) row ``budget`` distinct positions below max(length, budget),
    ascending (as K1 returns them, mostly), so a row shorter than the budget
    has masked slots."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ch = torch.randn(D, generator=gen, device=DEVICE).exp()  # per-channel spread
    K = (torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE) * ch).to(torch.bfloat16)
    V = torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    q = torch.randn((B, Hkv, rep, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    lens = list(lens or [S, 5003, 2100, 700])[:B]
    lengths = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    rows = []
    for n in lens:
        r = torch.rand((Hkv, max(n, budget)), generator=gen, device=DEVICE)
        rows.append(r.argsort(-1)[:, :budget].sort(-1).values)
    idx = torch.stack(rows).to(torch.int32)
    return q, K, V, lengths, idx


def attend_work(q, idx, lengths, table=None, mask=None):
    """Bytes and operations of one K2/K4/K8 call: the valid K and V rows,
    idx (K8: the mask), q, lengths (K4: the table) and the f32 output."""
    B, Hkv, rep, D = q.shape
    valid = (mask != 0) if mask is not None else idx < lengths[:, None, None]
    n_valid = int(valid.sum())
    nbytes = 2 * n_valid * D * 2 + q.numel() * 2 + B * Hkv * rep * D * 4
    nbytes += mask.numel() if mask is not None else idx.numel() * 4 + lengths.numel() * 4
    nbytes += 0 if table is None else table.numel() * 4
    return dict(bytes=nbytes, flops=4 * n_valid * rep * D)


def baseline_attend(torch, path):
    """K2 built from another source with the two-launch interface this
    kernel replaced (a partial pass into f32 scratch buffers, then a
    combine): ``fier_attend_launch(q, K, V, table, idx, lengths, part_o,
    part_md, out, B, S, bs, Hkv, rep, D, budget, scale, stream)``.  For
    timing the two side by side in one run; nothing else calls it."""
    import ctypes

    fn = nvcc_lib(path, "fier_attend_baseline").fier_attend_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tile = 64  # selected rows per block of its partial pass

    def run(q, K, V, idx, lengths):
        B, Hkv, rep, D = q.shape
        S, budget = K.shape[1], idx.shape[2]
        n_tiles = -(-budget // tile)
        part_o = torch.empty((B * Hkv, n_tiles, rep, D), dtype=torch.float32, device=q.device)
        part_md = torch.empty((B * Hkv, n_tiles, rep, 2), dtype=torch.float32, device=q.device)
        out = torch.empty((B, Hkv, rep, D), dtype=torch.float32, device=q.device)
        q32 = q.to(torch.float32).contiguous()
        err = fn(q32.data_ptr(), K.data_ptr(), V.data_ptr(), None, idx.data_ptr(),
                 lengths.data_ptr(), part_o.data_ptr(), part_md.data_ptr(), out.data_ptr(),
                 B, S, S, Hkv, rep, D, budget, 1.0 / (D ** 0.5),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline K2 launch failed: cudaError {err}")
        return out

    return run


def baseline_unfused(torch, path):
    """K6 and K7 built from another directory's ``fier_score.cu`` and
    ``fier_topk.cu`` (with their headers) with the interfaces these kernels
    replaced: ``fier_score_launch(q, codes, scale, zero, out, B, S, Hkv,
    rep, D, group, stream)`` and ``fier_topk_launch(scores, tau, m, rows, S,
    budget, stream)``.  For timing them in turns with this checkout's
    kernels; nothing else calls them.  Returns {kernel name: callable}."""
    import ctypes

    score = nvcc_lib(os.path.join(path, "fier_score.cu"), "fier_score_baseline").fier_score_launch
    score.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    topk = nvcc_lib(os.path.join(path, "fier_topk.cu"), "fier_topk_baseline").fier_topk_launch
    topk.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def run_score(q, codes, scale, zero):
        B, Hkv, rep, D = q.shape
        S = codes.shape[1] * 8
        out = torch.empty((B, Hkv, rep, S), dtype=torch.float32, device=q.device)
        if score(q.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                 out.data_ptr(), B, S, Hkv, rep, D, GROUP, stream()) != 0:
            raise RuntimeError("baseline K6 launch failed")
        return out

    def run_topk(scores, budget):
        R, S = scores.shape
        tau = torch.empty((R,), dtype=torch.float32, device=scores.device)
        m = torch.empty((R,), dtype=torch.int32, device=scores.device)
        if topk(scores.data_ptr(), tau.data_ptr(), m.data_ptr(), R, S, budget, stream()) != 0:
            raise RuntimeError("baseline K7 launch failed")
        return tau, m

    return {"fier_score": run_score, "topk_threshold": run_topk}


def check_attend_variants(torch, timer, baseline=None, variants=ATTEND_VARIANTS, S=CAPACITY,
                          bs=BLOCK_SIZE, group=GROUP, lens=None, plain=False):
    """K2, K4 and K8 at every shape of ``variants`` (rows of S tokens,
    lengths ``lens`` as ``attend_inputs`` takes them): K2 within
    K2_REL_TOL of its plain version, two K2 launches on the same inputs
    equal bit for bit (the cluster combine runs in a fixed order), K4 on a
    permuted pool with a null-block hole equal to K2 on the gathered slab
    bit for bit, K8 on ``gather_kv`` of the selection equal to K2 bit for
    bit (the pool in blocks of ``bs``); each timed (L2 flushed).  ``baseline``
    (``baseline_attend``):
    timed in turns with K2 at the serving and GQA shapes, held to the same
    tolerance.  ``plain``: K2 timed as ``once_each`` times it, beside its
    plain version and gather + ``scaled_dot_product_attention``.  Returns
    {variant name: row}."""
    import torch.nn.functional as F

    from repro_torch.core.quantize import quantize
    from repro_torch.core.retrieval import gather_kv
    from repro_torch.kernels import sparse_attention as sa

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, (B, Hkv, rep, D), budget in variants:
        q, K, V, lengths, idx = attend_inputs(torch, B, Hkv, rep, D, S, budget, seed=budget + rep,
                                              lens=lens)
        plan = sa.attend_plan(budget, B * Hkv, n_sm, rep, D)
        out2 = sa.fier_attend_selected(q, K, V, idx, lengths)
        again = sa.fier_attend_selected(q, K, V, idx, lengths)
        want = sa.fier_attend_selected_plain(q, K, V, idx, lengths)
        torch.cuda.synchronize()
        if not torch.equal(out2, again):
            raise AssertionError(f"K2 {name}: two launches on the same inputs differ (max "
                                 f"{float((out2 - again).abs().max()):.3g})")
        err = float((out2 - want).abs().max())
        scale = float(want.abs().max())
        if not (err <= K2_REL_TOL * scale and torch.isfinite(out2).all()):
            raise AssertionError(f"K2 {name} disagrees with its plain version: {err:.3g} > "
                                 f"{K2_REL_TOL} · {scale:.3g}")
        del want, again

        pools, table, Ks, Vs, _ = paged_inputs(
            torch, q, K, V, quantize(K, group), lengths, bs, spare=64, seed=rep)
        out4 = sa.fier_attend_selected(q, pools["k"], pools["v"], idx, lengths,
                                       block_table=table)
        ref4 = sa.fier_attend_selected(q, Ks, Vs, idx, lengths)
        ks, vs = gather_kv(K, V, idx)
        mask = (idx < lengths[:, None, None]).to(torch.int8)
        out8 = sa.fier_attend_gathered(q, ks, vs, mask)
        torch.cuda.synchronize()
        if not torch.equal(out4, ref4):
            raise AssertionError(f"K4 {name} differs from K2 on the gathered slab: max "
                                 f"{float((out4 - ref4).abs().max()):.3g}")
        if not torch.equal(out8, out2):
            raise AssertionError(f"K8 {name} differs from K2 on gather_kv of its selection: "
                                 f"max {float((out8 - out2).abs().max()):.3g}")
        row = dict(shape=(B, Hkv, rep, D, S), budget=budget, cluster=plan.cluster,
                   max_abs_err=err, **attend_work(q, idx, lengths))
        row["bound_ms"] = 1e3 * row["bytes"] / HBM_BYTES_PER_S
        if plain:
            def library():
                m = (idx < lengths[:, None, None])[:, :, None, :].expand(B, Hkv, rep, budget)
                return F.scaled_dot_product_attention(
                    q, ks.transpose(1, 2), vs.transpose(1, 2), attn_mask=m)

            t = once_each(timer, lambda: sa.fier_attend_selected_plain(q, K, V, idx, lengths),
                          lambda: sa.fier_attend_selected(q, K, V, idx, lengths), library)
            row.update(ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"])
        else:
            row["ms"] = timer(lambda: sa.fier_attend_selected(q, K, V, idx, lengths))
        row["k4_ms"] = timer(lambda: sa.fier_attend_selected(
            q, pools["k"], pools["v"], idx, lengths, block_table=table))
        row["k8_ms"] = timer(lambda: sa.fier_attend_gathered(q, ks, vs, mask))
        line = (f"  K2/K4/K8 {name} B={B} Hkv={Hkv} rep={rep} D={D} budget={budget} "
                f"(C={plan.cluster}): "
                f"two launches equal, K4 = K2 and K8 = K2 bit for bit, vs plain max |err| "
                f"{err:.3g} (<= {K2_REL_TOL * scale:.3g}); K2 {row['ms']:.4f} K4 "
                f"{row['k4_ms']:.4f} K8 {row['k8_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
                f"({row['bytes']} B)")
        if name == "serving":  # what this timer gives a plain read of as many bytes
            flat = torch.ones(row["bytes"] // 2, dtype=torch.bfloat16, device=DEVICE)
            row["read_floor_ms"] = timer(lambda: flat.sum())
            # the same two after a flush that leaves the L2 clean
            row["read_floor_clean_ms"] = timer(lambda: flat.sum(), clean=True)
            row["ms_clean"] = timer(lambda: sa.fier_attend_selected(q, K, V, idx, lengths),
                                    clean=True)
            line += (f"; x.sum() over {flat.numel() * 2} B: {row['read_floor_ms']:.4f} ms; "
                     f"after a read flush: K2 {row['ms_clean']:.4f}, x.sum() "
                     f"{row['read_floor_clean_ms']:.4f} ms")
            del flat
        if baseline is not None and name in ("serving", "gqa_rep4"):
            old = baseline(q, K, V, idx, lengths)
            torch.cuda.synchronize()
            old_err = float((old - out2).abs().max())
            if not old_err <= 2 * K2_REL_TOL * scale:
                raise AssertionError(f"the baseline K2 disagrees with K2 at {name}: {old_err:.3g}")
            row["baseline_ms"], row["ms_in_turns"] = old_new(
                timer, lambda: baseline(q, K, V, idx, lengths),
                lambda: sa.fier_attend_selected(q, K, V, idx, lengths))
            line += (f"; in turns with the baseline: baseline {row['baseline_ms']:.4f} ms, "
                     f"K2 {row['ms_in_turns']:.4f} ms")
        log(line)
        out[name] = row
        del q, K, V, lengths, idx, pools, table, Ks, Vs, ks, vs, mask, out2, out4, out8, ref4
        torch.cuda.empty_cache()
    return out


# d_head 16 (every reduced config) and 32 (reduced zamba2-7b, the examples'
# bench model).  K1/K3/K6 at the main path's scale (B 4, Hkv 16, S 8192,
# g 32, budget 1024, bs 32) at these reps; K2/K4/K8 there at every rep the
# kernel takes (sparse_attention.KERNEL_REPS); then all of them at the
# examples' own shapes, each at both d_heads: (name, B, Hkv, rep, S,
# budget) at g 8, bs 8 and no sink or recent window, as the examples'
# policies run (quickstart: reduced olmo-1b, 2 rows of 64;
# serve_longcontext: reduced llava, 4 slots of 128; passkey: the bench
# model at capacity SEQ + 8 = 264, no multiple of 32).
SMALL_HEADS = (16, 32)
SMALL_SCORE_REPS = ((1, "max"), (2, "sum"), (16, "max"))
SMALL_EXAMPLE_SHAPES = (
    ("quickstart", 2, 4, 1, 64, 16),
    ("serve_longcontext", 4, 2, 2, 128, 24),
    ("passkey", 4, 4, 1, 264, 32),
)
SMALL_GROUP, SMALL_BS = 8, 8


def check_pack_small(torch, timer, D):
    """K5 at d_head D, bitwise its plain version on bf16 and f32 keys, at the
    main path's slab (B 4, S 8192, Hkv 16, g 32: timed) and at the passkey
    example's (B 4, S 264, Hkv 4, g 8)."""
    from repro_torch.kernels import pack_quantize as pq

    row = None
    for B, S, H, g in ((SLOTS, CAPACITY, 16, GROUP), (4, 264, 4, SMALL_GROUP)):
        gen = torch.Generator(device=DEVICE).manual_seed(D + S)
        K = torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(torch.bfloat16)
        for k in (K, K.float()):
            got = pq.fier_pack_quantize(k, g)
            want = pq.fier_pack_quantize_plain(k, g)
            torch.cuda.synchronize()
            for name, a, b in zip(("codes", "scale", "zero"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"K5 {name} differs from its plain version at "
                                         f"{(B, S, H, D)} ({k.dtype}): "
                                         f"{byte_diff(torch, a, b)} bytes")
        log(f"  K5 {(B, H, D, S)} g={g}: codes/scale/zero bitwise equal to its plain version "
            f"(bf16 and f32 keys)")
        if row is None:
            t = once_each(timer, lambda: pq.fier_pack_quantize_plain(K, g),
                          lambda: pq.fier_pack_quantize(K, g), None)
            nbytes = K.numel() * 2 + sum(a.numel() * a.element_size() for a in got)
            row = dict(shape=(B, H, 1, D, S), ms=t["kernel"], plain_ms=t["plain"],
                       library_ms=None, bytes=nbytes, flops=0, max_abs_err=0.0)
        del K, k, got, want
    return finish_rows({"pack_quantize": [row]})["pack_quantize"][0]


# The planted faults, all in one copy of the sources (each touches only the
# shapes its check runs): {file: ((anchor, replacement), ...)}.
#   * d_head 16 (fixed layout): fier_common.cuh with the idle lanes 16-31
#     made active, scoring the next kv head's channels (their lane offset)
#     with their own head's q (lane mod 16).
#   * d_head 80 (generic layout, class 128: lanes 20-31 idle): the idle
#     lanes load the next kv head's channels, scored with their own head's
#     q (channel mod 80).
#   * rep 71 (generic layout): the last partial block of query heads is
#     dropped: K1/K3 fold no score of it into the group reduction, K6 and
#     K2 write none of its heads' outputs.
PLANTED_FAULTS = {
    "fier_common.cuh": (
        ("  return active_lanes(kD) == 32 || (int)(threadIdx.x & 31) < active_lanes(kD);",
         "  return true;"),
        ("qv[k] = on ? q_r[lane * kDPL + k] : 0.0f;",
         "qv[k] = q_r[(lane % active_lanes(kD)) * kDPL + k];"),
        ("  return lane * lane_channels(kW) < D - 128 * p;",
         "  return D == 80 || lane * lane_channels(kW) < D - 128 * p;"),
        ("qv[k] = on ? q_r[128 * p + lane * kDPL + k] : 0.0f;",
         "qv[k] = on ? q_r[(128 * p + lane * kDPL + k) % D] : 0.0f;"),
    ),
    "fier_retrieve.cuh": (
        ("    const int nr = min(hb, rep - r0);  // this block's query heads",
         "    const int nr = r0 > 0 && rep - r0 < hb ? 0 : min(hb, rep - r0);"),
    ),
    "fier_score.cu": (
        ("        const int nr = min(hb, rep - r0);  // this block's query heads",
         "        const int nr = r0 > 0 && rep - r0 < hb ? 0 : min(hb, rep - r0);"),
    ),
    "fier_attend.cuh": (
        ("    if (kAny && (hb0 + r >= rep || i - r * kD >= D)) continue;",
         "    if (kAny && (hb0 + r >= rep || (rep > kRep && hb0 + kRep > rep) || i - r * kD >= D))"
         " continue;"),
    ),
}


# the libraries built with PLANTED_FAULTS: K1/K3's fixed instantiations (the
# d_head 16 fault) and generic layout, K6, K2/K4/K8's generic layout
FAULT_LIBRARIES = ("fier_retrieve", "fier_retrieve_any", "fier_score", "fier_attend_any")


def fault_sources():
    """A copy of the kernel sources under the build directory with
    PLANTED_FAULTS planted: [(.cu path, library tag)] of FAULT_LIBRARIES."""
    import shutil

    from repro_torch.kernels import build

    src = build.BUILD_DIR / "faults"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    for name, edits in PLANTED_FAULTS.items():
        text = (src / name).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"a fault's anchor moved in {name}: {old!r}")
            text = text.replace(old, new)
        (src / name).write_text(text)
    return [(str(src / f"{n}.cu"), f"{n}_fault") for n in FAULT_LIBRARIES]


_FAULTS = {}  # library name -> the future of its build with PLANTED_FAULTS


def start_fault_builds():
    """Build FAULT_LIBRARIES (one ``nvcc`` each, all at once) in the
    background, so they compile while phase 2's first checks run on the
    card instead of beside phase 1's build; ``planted_kernels`` waits."""
    from concurrent.futures import ThreadPoolExecutor

    sources = fault_sources()
    pool = ThreadPoolExecutor(len(sources))
    for (src, tag), name in zip(sources, FAULT_LIBRARIES):
        _FAULTS[name] = pool.submit(nvcc_lib, src, tag)
    pool.shutdown(wait=False)


@contextlib.contextmanager
def planted_kernels():
    """Within it K1/K3, K6 and K2/K4/K8's generic layout launch the
    libraries built with PLANTED_FAULTS, typed as the port's."""
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import sparse_attention as sa

    if not _FAULTS:
        start_fault_builds()
    bad = {name: getattr(f.result(), f"{name}_launch") for name, f in _FAULTS.items()}
    good = {n: fr._kernel(n) for n in ("fier_retrieve", "fier_retrieve_any")}
    good["fier_score"] = fs._kernel()
    good["fier_attend_any"] = sa._kernel(96, 3)  # a shape of the generic layout
    for name, fn in bad.items():
        fn.argtypes, fn.restype = good[name].argtypes, good[name].restype
    k2 = ("fier_attend_any", "fier_attend_any_launch")
    try:
        fr._fns.update({n: bad[n] for n in ("fier_retrieve", "fier_retrieve_any")})
        fs._fn, sa._fns[k2] = bad["fier_score"], bad["fier_attend_any"]
        yield
    finally:
        fr._fns.update({n: good[n] for n in ("fier_retrieve", "fier_retrieve_any")})
        fs._fn, sa._fns[k2] = good["fier_score"], good["fier_attend_any"]


def small_head_fault(torch):
    """K1 and K6 built from a copy of the sources with SMALL_HEAD_FAULT
    planted, at d_head 16 (B 4, Hkv 16, rep 1, S 8192, g 32, budget 1024;
    the side-car in buffers padded past its end, since the last head's
    faulty lanes read beyond it): each must read above the gate its sound
    build passes (K1: the selection within ε of τ and τ within ε; K6: every
    score within ε).  Returns the readings as multiples of ε."""
    from repro_torch.core.quantize import QuantizedKeys
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels.check import selection_agrees

    B, Hkv, rep, D, S = SLOTS, 16, 1, 16, CAPACITY
    q, K, V, qk, lengths = make_inputs(torch, B, Hkv, rep, D, S, seed=61)
    del K, V

    def padded(t):
        buf = torch.zeros(t.numel() + 64, dtype=t.dtype, device=t.device)
        buf[:t.numel()].copy_(t.reshape(-1))
        return buf[:t.numel()].view(t.shape)

    qk = QuantizedKeys(padded(qk.codes), padded(qk.scale), padded(qk.zero), qk.group)
    sel = dict(group=GROUP, group_reduce="max", sink=SINK, recent=RECENT)
    args = (q, qk.codes, qk.scale, qk.zero, lengths, BUDGET)
    idx_p, tau_p, m_p = fr.fier_retrieve_plain(*args, **sel)
    s_p = fr.retrieval_scores(q, qk.codes, qk.scale, qk.zero, group=GROUP)
    with planted_kernels():
        idx_f, tau_f, m_f = fr.fier_retrieve(*args, **sel)
        s_f = fs.fier_score_scan(q, qk.codes, qk.scale, qk.zero, group=GROUP)
        torch.cuda.synchronize()
    eps = score_eps(q, qk)
    kv = fr.masked_kv(s_p, lengths, SINK, RECENT, "max").reshape(B * Hkv, S)
    ok, ndiff = selection_agrees(
        idx_f.reshape(B * Hkv, -1), idx_p.reshape(B * Hkv, -1), tau_f.reshape(-1),
        tau_p.reshape(-1), m_f.reshape(-1), m_p.reshape(-1), kv, eps)
    fin = torch.isfinite(tau_f) & torch.isfinite(tau_p)
    tau_err = float((tau_f - tau_p)[fin].abs().max())
    s_err = float((s_f - s_p).abs().max())
    out = dict(k1_tau_err_eps=tau_err / eps, k1_indices_off=ndiff, k6_err_eps=s_err / eps)
    log(f"  planted fault (d_head 16, lanes 16-31 score the next kv head's channels): K1 "
        f"{ndiff} indices outside the ε band, tau err {tau_err:.4g} = "
        f"{out['k1_tau_err_eps']:.4g} ε; K6 max |Δscore| {s_err:.4g} = "
        f"{out['k6_err_eps']:.4g} ε (gates: 0 indices and 1 ε)")
    if ok or not s_err > eps:
        raise AssertionError(f"the d_head 16 gates do not see the planted fault: {out}")
    del q, qk, idx_f, s_f, s_p, kv
    torch.cuda.empty_cache()
    return out


def check_small_heads(torch, timer):
    """Phase 2 at d_head 16 and 32: K1/K3/K6 (``check_scoring``) at
    SMALL_SCORE_REPS of the main path's shape, K2/K4/K8
    (``check_attend_variants``) at every rep of the main path's shape, K5
    (``check_pack_small``), then K1–K4/K6/K8 at the examples' shapes
    (SMALL_EXAMPLE_SHAPES), each under the gates of the main path's shape;
    and the planted fault (``small_head_fault``).  Returns ({kernel name:
    {entry: row}}, the fault's readings)."""
    from repro_torch.kernels import sparse_attention as sa

    rows = {k: {} for k in ("fier_retrieve", "fier_retrieve_paged", "fier_score",
                            "fier_attend_selected", "fier_attend_selected_paged",
                            "sparse_attention", "pack_quantize")}

    def add_attend(tag, variants):
        for v, r in variants.items():
            for name, key in (("fier_attend_selected", "ms"), ("fier_attend_selected_paged",
                                                               "k4_ms"),
                              ("sparse_attention", "k8_ms")):
                rows[name][f"{tag}{v}"] = dict(
                    shape=r["shape"], budget=r["budget"], ms=r[key], bound_ms=r["bound_ms"],
                    bound_by="bytes", max_abs_err=r["max_abs_err"])

    for D in SMALL_HEADS:
        for rep, reduce in SMALL_SCORE_REPS:
            got = check_scoring(torch, timer, (SLOTS, 16, rep, D, CAPACITY, reduce), turns=False)
            for name, r in got.items():
                rows[name][f"d{D}_rep{rep}"] = r
        add_attend("", check_attend_variants(torch, timer, variants=tuple(
            (f"d{D}_rep{rep}", (SLOTS, 16, rep, D), BUDGET) for rep in sa.KERNEL_REPS)))
        rows["pack_quantize"][f"d{D}"] = check_pack_small(torch, timer, D)
        for ex, B, Hkv, rep, S, budget in SMALL_EXAMPLE_SHAPES:
            got = check_scoring(torch, timer, (B, Hkv, rep, D, S, "max"), group=SMALL_GROUP,
                                budget=budget, bs=SMALL_BS, sink=0, recent=0, turns=False)
            for name, r in got.items():
                rows[name][f"{ex}_d{D}"] = r
            add_attend(f"{ex}_", check_attend_variants(
                torch, timer, variants=((f"d{D}", (B, Hkv, rep, D), budget),), S=S,
                bs=SMALL_BS, group=SMALL_GROUP, lens=scaled_lengths(B, S)))
    fault = small_head_fault(torch)
    return rows, fault


# Shapes outside the fixed instantiations (the generic layout): each
# d_head of ANY_HEADS at ANY_HEAD_REPS (Hkv 16), and each rep of ANY_REPS at
# the d_heads of ANY_REP_HEADS (Hkv = min(16, 128 // rep): 1 at rep 71), at
# the main path's scale (B 4, S 8192, g 32, budget 1024, bs 32; the
# 700-token row is shorter than the budget); then the 4-group chunk (g 8,
# bs 8) in each layout class at the passkey example's S 264, budget 32.
ANY_HEADS = (8, 24, 48, 80, 96, 136, 192, 256)
ANY_HEAD_REPS = (1, 3)
ANY_REPS = (5, 6, 7, 9, 24, 32, 48, 71)
ANY_REP_HEADS = (64, 128, 256)
ANY_SMALL_GROUP = ((24, 3), (48, 5), (96, 7), (192, 9))


def device_inputs(torch, B, Hkv, rep, D, S, seed, group=GROUP):
    """``make_inputs``' q, K, V, quantized K and lengths, made on the card
    from a seeded ``torch.Generator`` (the wide shapes of phase 2's generic
    layout would cost seconds of host time each through numpy)."""
    from repro_torch.core.quantize import quantize

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ch = torch.randn(D, generator=gen, device=DEVICE).exp()  # per-channel spread
    K = (torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE) * ch).to(torch.bfloat16)
    V = torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    q = torch.randn((B, Hkv, rep, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    lengths = torch.tensor(scaled_lengths(B, S), dtype=torch.int32, device=DEVICE)
    return q, K, V, quantize(K, group), lengths


def any_shapes():
    """(entry, B, Hkv, rep, D, S, group, budget, bs) of ``check_any_heads``."""
    out = [(f"d{D}_rep{rep}", SLOTS, 16, rep, D, CAPACITY, GROUP, BUDGET, BLOCK_SIZE)
           for D in ANY_HEADS for rep in ANY_HEAD_REPS]
    out += [(f"d{D}_rep{rep}", SLOTS, min(16, 128 // rep), rep, D, CAPACITY, GROUP, BUDGET,
             BLOCK_SIZE) for rep in ANY_REPS for D in ANY_REP_HEADS]
    out += [(f"g8_d{D}_rep{rep}", 4, 4, rep, D, 264, SMALL_GROUP, 32, SMALL_BS)
            for D, rep in ANY_SMALL_GROUP]
    return out


def check_any_heads(torch, timer):
    """Phase 2 at the generic layout's shapes (``any_shapes``): K1/K3/K6
    (``check_scoring``, the group max and, at odd reps, the group sum),
    K2/K4/K8 (``check_attend_variants``, with their plain versions and
    gather + ``scaled_dot_product_attention`` timed), K5 at each d_head of
    ANY_HEADS (``check_pack_small``), each under the gates of the main
    path's shape; then the planted faults (``any_head_fault``).  Returns
    ({kernel name: {entry: row}}, the faults' readings)."""
    rows = {k: {} for k in ("fier_retrieve", "fier_retrieve_paged", "fier_score",
                            "fier_attend_selected", "fier_attend_selected_paged",
                            "sparse_attention", "pack_quantize")}
    for entry, B, Hkv, rep, D, S, group, budget, bs in any_shapes():
        reduce = "sum" if rep % 2 else "max"
        small = S < CAPACITY
        got = check_scoring(torch, timer, (B, Hkv, rep, D, S, reduce), group=group, budget=budget,
                            bs=bs, sink=0 if small else SINK, recent=0 if small else RECENT,
                            turns=False, make=device_inputs)
        for name, r in got.items():
            rows[name][entry] = r
        att = check_attend_variants(torch, timer, variants=((entry, (B, Hkv, rep, D), budget),),
                                    S=S, bs=bs, group=group, lens=scaled_lengths(B, S),
                                    plain=True)[entry]
        for name, key in (("fier_attend_selected", "ms"), ("fier_attend_selected_paged", "k4_ms"),
                          ("sparse_attention", "k8_ms")):
            rows[name][entry] = dict(
                shape=att["shape"], budget=budget, ms=att[key], bound_ms=att["bound_ms"],
                bound_by="bytes", max_abs_err=att["max_abs_err"],
                plain_ms=att["plain_ms"] if name == "fier_attend_selected" else None,
                library_ms=att["library_ms"] if name == "fier_attend_selected" else None)
    for D in ANY_HEADS:
        rows["pack_quantize"][f"d{D}"] = check_pack_small(torch, timer, D)
    return rows, any_head_fault(torch)


def fault_reading(torch, shape, seed):
    """K1, K6 and K2 built with PLANTED_FAULTS at ``shape`` (B, Hkv, rep, D),
    S 8192, g 32, budget 1024, the group max, the side-car and K/V in
    buffers padded past their ends (a faulty lane may read beyond them),
    each against the gate its sound build passes: K1 the selection within
    ε of τ, K6 every score within ε, K2 within K2_REL_TOL·max|out|.
    Returns the readings (as multiples of ε, and of the K2 gate)."""
    from repro_torch.core.quantize import QuantizedKeys
    from repro_torch.kernels import fier_score as fs
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels.check import selection_agrees

    B, Hkv, rep, D = shape
    S = CAPACITY
    q, K, V, qk, lengths = device_inputs(torch, B, Hkv, rep, D, S, seed)

    def padded(t):
        buf = torch.zeros(t.numel() + 256, dtype=t.dtype, device=t.device)
        buf[:t.numel()].copy_(t.reshape(-1))
        return buf[:t.numel()].view(t.shape)

    qk = QuantizedKeys(padded(qk.codes), padded(qk.scale), padded(qk.zero), qk.group)
    sel = dict(group=GROUP, group_reduce="max", sink=SINK, recent=RECENT)
    args = (q, qk.codes, qk.scale, qk.zero, lengths, BUDGET)
    idx_p, tau_p, m_p = fr.fier_retrieve_plain(*args, **sel)
    s_p = fr.retrieval_scores(q, qk.codes, qk.scale, qk.zero, group=GROUP)
    o_p = sa.fier_attend_selected_plain(q, K, V, idx_p, lengths)
    with planted_kernels():
        idx_f, tau_f, m_f = fr.fier_retrieve(*args, **sel)
        s_f = fs.fier_score_scan(q, qk.codes, qk.scale, qk.zero, group=GROUP)
        o_f = sa.fier_attend_selected(q, K, V, idx_p, lengths)
        torch.cuda.synchronize()
    eps = score_eps(q, qk)
    kv = fr.masked_kv(s_p, lengths, SINK, RECENT, "max").reshape(B * Hkv, S)
    ok, ndiff = selection_agrees(
        idx_f.reshape(B * Hkv, -1), idx_p.reshape(B * Hkv, -1), tau_f.reshape(-1),
        tau_p.reshape(-1), m_f.reshape(-1), m_p.reshape(-1), kv, eps)
    fin = torch.isfinite(tau_f) & torch.isfinite(tau_p)
    tau_err = float((tau_f - tau_p)[fin].abs().max())
    s_err = float(torch.nan_to_num((s_f - s_p).abs(), nan=float("inf")).max())
    o_err = float(torch.nan_to_num((o_f - o_p).abs(), nan=float("inf")).max())
    o_gate = K2_REL_TOL * float(o_p.abs().max())
    out = dict(k1_selection_ok=ok, k1_indices_off=ndiff, k1_tau_err_eps=tau_err / eps,
               k6_err_eps=s_err / eps, k2_err_gates=o_err / o_gate)
    del q, K, V, qk, idx_f, s_f, s_p, o_f, o_p, kv
    torch.cuda.empty_cache()
    return out


def any_head_fault(torch):
    """The generic layout's planted faults (PLANTED_FAULTS): at d_head 80
    (B 4, Hkv 16, rep 1) K1 and K6 must read above their gates; at rep 71
    (B 4, Hkv 1, d_head 128: blocks of 32, 32 and 7 query heads in K1/K6,
    of 16 in K2) K1, K6 and K2 must.  Returns the readings."""
    out = {"d80_idle_lanes": fault_reading(torch, (SLOTS, 16, 1, 80), seed=81),
           "rep71_last_block": fault_reading(torch, (SLOTS, 1, 71, 128), seed=71)}
    for name, r in out.items():
        log(f"  planted fault {name}: K1 {r['k1_indices_off']} indices outside the ε band "
            f"(selection within the gate: {r['k1_selection_ok']}), tau err "
            f"{r['k1_tau_err_eps']:.4g} ε; K6 max |Δscore| {r['k6_err_eps']:.4g} ε; K2 max "
            f"|Δout| {r['k2_err_gates']:.4g} × its gate (gates: 0 indices, 1 ε, 1)")
    d80, r71 = out["d80_idle_lanes"], out["rep71_last_block"]
    if d80["k1_selection_ok"] or not d80["k6_err_eps"] > 1:
        raise AssertionError(f"the d_head 80 gates do not see the planted fault: {d80}")
    if r71["k1_selection_ok"] or not (r71["k6_err_eps"] > 1 and r71["k2_err_gates"] > 1):
        raise AssertionError(f"the rep 71 gates do not see the planted fault: {r71}")
    return out


def finish_rows(rows):
    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S, r["flops"] / F32_FLOPS)
            if "bytes_full" in r:  # K1/K3: whole rows read, as before the length skip
                r["bound_full_ms"] = 1e3 * r["bytes_full"] / HBM_BYTES_PER_S
            r["bound_by"] = (
                "bytes" if r["bytes"] / HBM_BYTES_PER_S >= r["flops"] / F32_FLOPS
                else "operations"
            )
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {lib}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}: {r['bytes']} B, {r['flops']} flop)")
    return rows


# ------------------------------------------------------------ phase 3

def main_path(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, serving_policy

    cfg = get_config("olmo-1b")
    eng = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY)
    pol = eng.bundle.policy
    if (pol.kind, pol.pipeline, pol.layout, pol.budget) != ("fier", "one_pass", "slab", BUDGET):
        raise AssertionError(f"Engine.build's default policy is {pol}")
    params = eng.bundle.init(torch.Generator(device="cuda").manual_seed(0))
    params = eng.compute_params(params)
    torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    S = max(PROMPTS)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (SLOTS, S))).to("cuda")
    lengths = torch.tensor(PROMPTS, dtype=torch.int32, device="cuda")
    fifth = torch.from_numpy(rng.integers(0, cfg.vocab, (1, FIFTH_PROMPT))).to("cuda")
    batch = {"tokens": prompts, "lengths": lengths}

    # ---- the reference pipeline (plain PyTorch, no custom kernel) on the same params
    ref = Engine.build(
        cfg, n_slots=SLOTS, capacity=CAPACITY,
        policy=serving_policy(budget=BUDGET, pipeline="reference"),
    )
    lg_ref, cache_ref = ref.prefill_batch(params, batch)
    tok0_ref = torch.argmax(lg_ref, -1).to(torch.int32)
    _, lg1_ref, _ = ref.decode(params, tok0_ref, cache_ref)
    del cache_ref
    toks_ref = ref.generate(params, prompts, lengths, MAX_NEW)
    del ref
    torch.cuda.empty_cache()

    # ---- time to first token of the 4-prompt batch (prefill + sample)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg_prefill, cache = eng.prefill_batch(params, batch)
    tok0 = torch.argmax(lg_prefill, -1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    if not torch.equal(lg_prefill, lg_ref):
        raise AssertionError("prefill logits differ between one_pass and reference engines")
    log("  prefill logits identical to the reference pipeline")
    engine_errs, lg1 = first_step_checks(
        torch, eng, params, tok0.to(torch.int32), cache, lg1_ref, cfg.vocab
    )
    del cache
    torch.cuda.empty_cache()

    # ---- the counted run: generate, insert, decode(active)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = eng.generate(params, prompts, lengths, MAX_NEW, return_cache=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    slot = SLOTS - 1  # the 1500-token request is done; its slot is reused
    t0 = time.perf_counter()
    lg5, cache = eng.insert(params, cache, fifth, FIFTH_PROMPT, slot)
    tok = toks[:, -1].clone()
    tok[slot] = torch.argmax(lg5, -1)[0].to(torch.int32)
    torch.cuda.synchronize()
    t_insert = time.perf_counter() - t0
    active = torch.tensor([True, True, False, True], device="cuda")
    step_ms = []
    for _ in range(EXTRA_STEPS):
        t0 = time.perf_counter()
        tok, lg, cache = eng.decode(params, tok, cache, active=active)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    profile_decode(torch, eng, params, tok, cache, active)
    steps = (MAX_NEW - 1) + EXTRA_STEPS
    check_launches(counts, SLAB_KERNELS, (N_LAYERS - SKIP) * steps)
    log(f"  launches {counts}: {N_LAYERS - SKIP} x {steps} decode steps")

    # ---- outputs are right by the repo's own means
    lens = cache["length"].tolist()
    want = [p + MAX_NEW - 1 + EXTRA_STEPS for p in PROMPTS]
    want[slot] = FIFTH_PROMPT + EXTRA_STEPS
    want[2] = PROMPTS[2] + MAX_NEW - 1  # inactive slot does not advance
    if lens != want:
        raise AssertionError(f"cache lengths {lens}, expected {want}")
    if not (toks.shape == (SLOTS, MAX_NEW) and bool(((toks >= 0) & (toks < cfg.vocab)).all())):
        raise AssertionError(f"generated tokens out of range: {toks.shape}")
    if not torch.isfinite(lg[:, : cfg.vocab]).all():
        raise AssertionError("non-finite decode logits")
    if not torch.equal(toks[:, 0], tok0.to(torch.int32)):
        raise AssertionError("generate's first token differs from prefill's argmax")
    agree = int((toks == toks_ref).sum())
    med = sorted(step_ms)[len(step_ms) // 2]
    log(f"  greedy tokens agreeing with the reference pipeline: {agree}/{toks.numel()}")
    log(f"  TTFT (4 prompts {PROMPTS}, prefill + sample) {ttft * 1e3:.1f} ms; "
        f"insert of a {FIFTH_PROMPT}-token prompt {t_insert * 1e3:.1f} ms")
    log(f"  generate {MAX_NEW} tokens (prefill + {MAX_NEW - 1} decode steps): {t_gen:.3f} s")
    log(f"  decode(active) steps: median {med:.2f} ms/step "
        f"({3 / (med / 1e3):.1f} tokens/s over 3 active slots); "
        f"peak memory {peak / 2**30:.2f} GiB")
    del cache
    p3 = dict(prompts=prompts, lengths=lengths, toks=toks, lg1=lg1)
    return counts, engine_errs, params, eng, p3


SLAB_KERNELS = ("fier_retrieve", "fier_attend_selected")
PAGED_KERNELS = ("fier_retrieve_paged", "fier_attend_selected_paged")


def check_launches(counts, path_kernels, expect):
    """Each kernel of the path launched ``expect`` times, every other 0."""
    for name, n in counts.items():
        want = expect if name in path_kernels else 0
        if n != want:
            raise AssertionError(f"{name} launched {n} times, expected {want}")


# ------------------------------------------------------------ phase 4

def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def paged_vs_slab(torch, cfg, params, slab, prompts=PROMPTS, steps=MAX_NEW, profiles=None,
                  profile_paged=True):
    """The same four prompts inserted one by one into the slab engine and
    into a paged one (bs 32, default pool), then ``steps`` greedy decode
    steps, the paged engine calling ``advance_slot`` for every slot before
    each step.  Tokens and the first step's logits must be equal; each
    engine must have run only its own layout's kernels, once per FIER layer
    (layers − skip) and step.
    ``profiles`` (a dict): each engine's launch counts, median ms/step and
    ``profile_decode`` readings (the paged engine's only with
    ``profile_paged``) go there under "slab" and "paged"."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine

    rng = np.random.default_rng(4)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab, (1, n))).to(DEVICE) for n in prompts]
    n_fier = cfg.n_layers - slab.bundle.policy.skip_layers

    def drive(eng, kernels):
        cache = eng.new_cache()
        reset_launch_counts()
        tok = torch.zeros(len(prompts), dtype=torch.int32, device=DEVICE)
        for slot, t in enumerate(toks):
            lg, cache = eng.insert(params, cache, t, t.shape[1], slot)
            tok[slot] = torch.argmax(lg, -1)[0]
        out, first, ms = [tok.clone()], None, []
        for _ in range(steps):
            sync(torch)
            t0 = time.perf_counter()
            if eng.paged:
                for slot in range(len(prompts)):
                    ok, cache = eng.advance_slot(cache, slot)
                    if not ok:
                        raise AssertionError("the default pool ran dry")
            tok, lg, cache = eng.decode(params, tok, cache)
            sync(torch)
            ms.append(1e3 * (time.perf_counter() - t0))
            if first is None:
                first = lg.clone()
            out.append(tok.clone())
        counts = launch_counts()
        check_launches(counts, kernels, n_fier * steps)
        if eng.paged:
            eng.audit()
        prof = None
        if DEVICE == "cuda" and (profile_paged or not eng.paged):
            log(f"  {'paged' if eng.paged else 'slab'} engine:")
            prof = profile_decode(torch, eng, params, tok, cache, None)
        if profiles is not None:
            profiles["paged" if eng.paged else "slab"] = dict(
                launches=counts, ms_step=median(ms), profile=prof)
        del cache
        return torch.stack(out, 1), first, median(ms), counts

    toks_s, lg_s, ms_s, _ = drive(slab, SLAB_KERNELS)
    paged = Engine.build(cfg, n_slots=len(prompts), capacity=slab.capacity,
                         layout="paged", device=DEVICE)
    pol = paged.bundle.policy
    if (pol.layout, pol.pipeline, pol.budget, pol.block_size) != (
            "paged", "one_pass", slab.bundle.policy.budget, BLOCK_SIZE):
        raise AssertionError(f"the paged engine's policy is {pol}")
    toks_p, lg_p, ms_p, counts = drive(paged, PAGED_KERNELS)
    gap = float((lg_p - lg_s).abs().max())
    agree = int((toks_p == toks_s).sum())
    log(f"  first decode step, paged vs slab: max |Δlogit| {gap:.6g} (expected 0)")
    log(f"  greedy tokens equal to the slab engine's: {agree}/{toks_s.numel()}")
    log(f"  decode ms/step (median of {steps}): slab {ms_s:.2f}, paged {ms_p:.2f} "
        f"(advance_slot included); launches {counts}")
    if gap != 0.0 or not torch.equal(toks_p, toks_s):
        raise AssertionError("the paged engine differs from the slab engine")
    return counts


# ------------------------------------------------------------ phase 5

def stream_requests(vocab, family=4096, own=(250, 256), distinct=(7000, 5000, 3000, 1500)):
    """The phase 5 trace, in submission order: P (the family prefix plus
    ``own[0]`` tokens, a partial last block), two exact repeats of P, four
    distinct prompts, five family-prefix prompts of ``own[1]`` tokens each."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(5)
    toks = lambda n: rng.integers(1, vocab, size=n).tolist()
    fam = toks(family)
    P = fam + toks(own[0])
    specs = [(P, 32), (P, 16), (P, 16)]
    specs += [(toks(n), 64) for n in distinct]
    specs += [(fam + toks(own[1]), 32) for _ in range(5)]
    return [Request(rid=i, tokens=list(t), max_new=m) for i, (t, m) in enumerate(specs)]


def serve_stream(torch, cfg, params, *, n_slots=8, capacity=CAPACITY, pool_blocks=621,
                 chunk_tokens=2048, requests=None, engine_kwargs=None, setup=None,
                 finish=None, late=()):
    """``ContinuousScheduler`` over a paged engine with a tight pool: every
    request must finish, the audit must be clean with no block in use, the
    prefix cache, the full-prompt replay and copy-on-write must all have
    fired, the repeats of P must have generated P's tokens, pressure must
    have shown as a budget downshift or a preemption, and the paged kernels
    must have launched 14 × the decode steps.  The first decode step at each
    budget the engine serves (the full one and every downshifted rung) runs
    K3 and K4 beside their plain versions on the engine's own tensors
    (``checked_kernels``; the served tokens stay the kernels').

    ``engine_kwargs`` go to ``Engine.build`` (phase 8: the host tier and a
    TTL); ``setup(eng)`` runs before the stream and ``finish(eng, sched)``
    after its gates; the ``late`` requests are submitted once the stream
    has drained.  Returns (launch counts, stats, K3/K4 errors, each
    request's tokens)."""
    import dataclasses

    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.obs import Observability
    from repro_torch.obs.tracing import PID_REQUEST
    from repro_torch.serving import ContinuousScheduler, Engine, serving_policy

    reqs = requests if requests is not None else stream_requests(cfg.vocab)
    eng = Engine.build(
        cfg, n_slots=n_slots, capacity=capacity, obs=Observability(), device=DEVICE,
        policy=dataclasses.replace(serving_policy(layout="paged"), pool_blocks=pool_blocks),
        **(engine_kwargs or {}),
    )
    if setup is not None:
        setup(eng)
    if eng.block_size != BLOCK_SIZE:
        raise AssertionError(f"the paged engine's block size is {eng.block_size}")
    sched = ContinuousScheduler(eng, params, chunk_tokens=chunk_tokens)
    dec_ms, checked_at = [], []
    errs = new_errs()
    checked = checked_kernels(torch, errs, keep_plain=False)
    decode = eng.decode

    def timed_decode(*a, **k):
        check = eng.current_budget not in checked_at
        if check:
            checked_at.append(eng.current_budget)
            ops.fier_retrieve, ops.fier_attend_selected = checked
        try:
            sync(torch)
            t0 = time.perf_counter()
            out = decode(*a, **k)
            sync(torch)
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
        if not check:  # a checked step also runs the plain versions: not timed
            dec_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    eng.decode = timed_decode
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sched.start()
    reset_launch_counts()
    wall0 = time.monotonic()
    for r in reqs:
        sched.submit(r)
    while sched.busy:
        if not sched.step():
            raise AssertionError("the scheduler stalled")
    for r in late:
        sched.submit(r)
    while sched.busy:
        if not sched.step():
            raise AssertionError("the scheduler stalled")
    reqs = list(reqs) + list(late)
    sync(torch)
    wall = time.monotonic() - wall0
    counts = launch_counts()
    n_fier = cfg.n_layers - eng.bundle.policy.skip_layers
    check_launches(counts, PAGED_KERNELS, n_fier * sched.steps)

    eng.audit()
    ps = eng.pool_stats()
    status = {oc.status for oc in sched.outcomes.values()}
    n_tok = sum(len(r.out) for r in reqs)
    first = {}
    for e in eng.obs.tracer.events:
        if e.pid == PID_REQUEST and e.name == "token" and e.tid not in first:
            first[e.tid] = e.wall_ts - wall0
    ttft = sorted(first.values())
    pct = lambda q: ttft[min(len(ttft) - 1, int(q * (len(ttft) - 1) + 0.5))]
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    stats = dict(
        requests=len(reqs), decode_steps=sched.steps, prefill_chunks=sched.prefill_chunks,
        preemptions=sched.preemptions, prefill_aborts=sched.prefill_aborts,
        budget_downshifts=eng.downshifts, budget_restores=eng.restores,
        blocks_shed=eng.blocks_shed, prefix_block_hits=ps["pool_prefix_block_hits"],
        prefix_replays=eng.prefix_hits, cow_copies=ps["pool_cow_copies"],
        peak_blocks=ps["pool_peak_in_use"], blocks_in_use_at_end=ps["pool_blocks_in_use"],
        tokens=n_tok, wall_s=round(wall, 3), tokens_per_s=round(n_tok / wall, 2),
        decode_ms_median=round(median(dec_ms), 2), wall_ttft_p50_s=round(pct(0.5), 3),
        wall_ttft_p99_s=round(pct(0.99), 3), peak_gib=round(peak / 2**30, 2),
    )
    log(f"  pool {pool_blocks} blocks ({pool_blocks - 1} usable × {BLOCK_SIZE} tokens), "
        f"{n_slots} slots × {capacity}: {json.dumps(stats)}")
    log(f"  launches {counts}: {n_fier} x {sched.steps} decode steps")
    log(f"  decode steps held against the plain versions at budgets {checked_at}, "
        f"{n_slots} slots:")
    log_errs(errs, "K3", "K4")
    reps = [r.out == reqs[0].out[: len(r.out)] for r in reqs[1:3]]
    log(f"  the repeats of P generated P's tokens: {reps}")
    checks = {
        "every request finished": status == {"finished"} and len(sched.outcomes) == len(reqs),
        "no block in use at the end": ps["pool_blocks_in_use"] == 0,
        "prefix block hits > 0": ps["pool_prefix_block_hits"] > 0,
        "prefix replays > 0": eng.prefix_hits > 0,
        "copy-on-write copies > 0": ps["pool_cow_copies"] > 0,
        "the repeats of P generated P's tokens": all(reps),
        "a budget downshift or a preemption": eng.downshifts + sched.preemptions > 0,
        "the full budget's first decode step held against the plain versions":
            eng.base_budget in checked_at and errs["calls"] == n_fier * len(checked_at),
        "every downshifted budget's first decode step held against the plain versions":
            eng.downshifts == 0 or min(checked_at) < eng.base_budget,
        "every request got max_new tokens in range": all(
            len(r.out) == r.max_new and all(0 <= t < cfg.vocab for t in r.out) for r in reqs
        ),
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"the stream's gates failed: {bad}")
    if finish is not None:
        finish(eng, sched)
    del eng, sched
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return counts, stats, errs, {r.rid: list(r.out) for r in reqs}


def clone_cache(torch, cache, device=None):
    """A copy of a decode cache (decode updates its cache in place), on
    ``device`` when given."""
    import dataclasses

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone() if device is None else x.to(device, copy=True)
        if hasattr(x, "parts"):  # a ShardedPool
            return x.clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: copy(getattr(x, f.name)) for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor) or hasattr(getattr(x, f.name),
                                                                           "parts")
            })
        return x

    return copy(cache)


def new_errs():
    return {"k1_tau": 0.0, "k1_swaps": 0, "k2": 0.0, "k2_rel": 0.0, "calls": 0}


def checked_kernels(torch, errs, *, keep_plain):
    """Stand-ins for ``ops.fier_retrieve`` / ``ops.fier_attend_selected``
    that run the kernel and its plain version on the same (the engine's
    own) tensors, either layout: K1/K3 must give the same index set up to
    near-τ ties, K2/K4 must lie within K2_REL_TOL of max|out|.  They return
    the plain result when ``keep_plain`` (it goes on down the stack), else
    the kernel's, so the served path is the one it would have been.  The
    kernel launch is the path's own; the plain version launches nothing."""
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels.check import selection_agrees
    from repro_torch.kvcache.paged import gather_block_rows

    def retrieve(q, codes, scale, zero, lengths, budget, *, block_table=None, plan_rows=None,
                 **sel):
        got = fr.fier_retrieve(q, codes, scale, zero, lengths, budget,
                               block_table=block_table, plan_rows=plan_rows, **sel)
        if block_table is not None:
            want = fr.fier_retrieve_paged_plain(
                q, codes, scale, zero, block_table, lengths, budget, **sel)
            codes, scale, zero = (gather_block_rows(a, block_table) for a in (codes, scale, zero))
        else:
            want = fr.fier_retrieve_plain(q, codes, scale, zero, lengths, budget, **sel)
        B, Hkv, rep, D = q.shape
        s = fr.retrieval_scores(q, codes, scale, zero, group=sel["group"])
        kv = fr.masked_kv(s, lengths, sel["sink"], sel["recent"], sel["group_reduce"])
        amax = (scale.float().abs() + zero.float().abs()).amax()
        eps = float(D * 2.0**-23 * rep * q.float().abs().sum(-1).amax() * amax)
        ok, ndiff = selection_agrees(
            *(x.reshape(B * Hkv, -1) for x in (got[0], want[0])),
            *(x.reshape(-1) for x in (got[1], want[1], got[2], want[2])),
            kv.reshape(B * Hkv, -1), eps,
        )
        name = "K3" if block_table is not None else "K1"
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version on the engine's "
                                 f"tensors: {ndiff} indices, eps {eps:.3g}")
        d_tau = torch.where(got[1] == want[1], 0.0, (got[1] - want[1]).abs()).max()
        errs["k1_tau"] = max(errs["k1_tau"], float(d_tau))
        errs["k1_swaps"] += ndiff
        errs["calls"] += 1
        return want if keep_plain else got

    def attend(q, K, V, idx, lengths=None, *, block_table=None, plan_rows=None):
        got = sa.fier_attend_selected(q, K, V, idx, lengths, block_table=block_table,
                                      plan_rows=plan_rows)
        if block_table is not None:
            want = sa.fier_attend_selected_paged_plain(q, K, V, block_table, idx, lengths)
        else:
            want = sa.fier_attend_selected_plain(q, K, V, idx, lengths)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not rel <= K2_REL_TOL:
            name = "K4" if block_table is not None else "K2"
            raise AssertionError(f"{name} disagrees with its plain version on the engine's "
                                 f"tensors: {err:.3g} ({rel:.3g} of max|out|)")
        errs["k2"], errs["k2_rel"] = max(errs["k2"], err), max(errs["k2_rel"], rel)
        return want if keep_plain else got

    return retrieve, attend


def log_errs(errs, retrieval, attention):
    log(f"  per layer on the engine's tensors ({errs['calls']} calls): {retrieval} index "
        f"sets agree ({errs['k1_swaps']} near-tau swaps), max tau err {errs['k1_tau']:.3g}; "
        f"{attention} max |err| {errs['k2']:.3g} ({errs['k2_rel']:.3g} of max|out|)")



def first_step_checks(torch, eng, params, tok0, cache, lg1_ref, vocab, kv_roll=True,
                      tols=None):
    """The first decode step after prefill, five ways, each from a copy of
    the same prefill cache:

    * with the kernels (the main path);
    * with each kernel's plain version on the engine's own tensors — every
      layer's K1 and K2 inputs also go through the kernel and are compared
      there (K1: same index set up to near-τ ties; K2: within K2_REL_TOL);
      the plain results go on down the stack;
    * with two planted faults: K2 given every selected index shifted by
      one token, and K1's selection of the last FIER layer handed to the
      neighbouring kv head (``kv_roll``; with one kv head there is none).
    The kernel step must lie within PLAIN_LOGIT_REL_TOL of the plain step
    and REF_LOGIT_REL_TOL of the reference pipeline (``tols``: another pair
    of fractions of max|logit|), and each planted fault
    beyond both, so the gates are shown to see a wrong kernel.  Returns the
    largest K1 τ error and K2 error of the per-layer comparisons (with the
    plain step's logits under ``lg1_plain`` and the readings under
    ``gaps``), and the kernel step's logits."""
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_attention as sa

    def step(retrieve=fr.fier_retrieve, attend=sa.fier_attend_selected):
        ops.fier_retrieve, ops.fier_attend_selected = retrieve, attend
        try:
            _, lg, _ = eng.decode(params, tok0, clone_cache(torch, cache))
            torch.cuda.synchronize()
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
        return lg[:, :vocab]

    errs = new_errs()
    checked_retrieve, checked_attend = checked_kernels(torch, errs, keep_plain=True)

    def shifted_attend(q, K, V, idx, lengths=None, **k):
        return sa.fier_attend_selected(q, K, V, (idx + 1) % K.shape[1], lengths, **k)

    n_calls = [0]

    def rolled_retrieve(*a, **k):
        idx, tau, m = fr.fier_retrieve(*a, **k)
        n_calls[0] += 1
        if n_calls[0] == N_LAYERS - SKIP:  # the last FIER layer only
            idx = torch.roll(idx, 1, dims=1)
        return idx, tau, m

    lg1 = step()
    lg1_plain = step(checked_retrieve, checked_attend)
    faults = {"K2 fed idx+1": step(attend=shifted_attend)}
    if kv_roll:
        faults["K1's last-layer selection on the next kv head"] = step(retrieve=rolled_retrieve)
    ref = lg1_ref[:, :vocab]
    s1 = float(ref.abs().max())
    gap = lambda a, b: float((a - b).abs().max())
    top1 = lambda a, b: int((a.argmax(-1) == b.argmax(-1)).sum())
    d_plain, d_ref = gap(lg1, lg1_plain), gap(lg1, ref)
    log_errs(errs, "K1", "K2")
    log(f"  first decode step (max |logit| {s1:.4g}): max |Δlogit| vs plain versions "
        f"{d_plain:.4g} (top-1 {top1(lg1, lg1_plain)}/{SLOTS}), vs reference pipeline "
        f"{d_ref:.4g} (top-1 {top1(lg1, ref)}/{SLOTS})")
    for name, lg in faults.items():
        log(f"  planted fault, {name}: max |Δlogit| vs plain versions "
            f"{gap(lg, lg1_plain):.4g}, vs reference pipeline {gap(lg, ref):.4g}")
    if not torch.isfinite(lg1).all():
        raise AssertionError("non-finite first-step logits")
    plain_tol, ref_tol = tols or (PLAIN_LOGIT_REL_TOL, REF_LOGIT_REL_TOL)
    if not d_plain <= plain_tol * s1:
        raise AssertionError(f"first step vs plain versions: {d_plain:.4g} > "
                             f"{plain_tol} · {s1:.4g}")
    if not d_ref <= ref_tol * s1:
        raise AssertionError(f"first step vs reference pipeline: {d_ref:.4g} > "
                             f"{ref_tol} · {s1:.4g}")
    for name, lg in faults.items():
        if not (gap(lg, lg1_plain) > plain_tol * s1 and gap(lg, ref) > ref_tol * s1):
            raise AssertionError(f"the first-step gates do not see the planted fault "
                                 f"({name}): {gap(lg, lg1_plain):.4g}, {gap(lg, ref):.4g}")
    errs["lg1_plain"] = lg1_plain
    errs["gaps"] = dict(plain=d_plain, ref=d_ref, max_logit=s1,
                        **{f"fault {k}": (gap(lg, lg1_plain), gap(lg, ref))
                           for k, lg in faults.items()})
    return errs, lg1


# the CUDA kernels' function names in csrc/ (profiler rows)
PORT_KERNEL_NAMES = ("fier_retrieve_kernel", "fier_attend_kernel", "fier_score_kernel",
                     "topk_threshold_kernel", "pack_quantize_kernel")


def profile_decode(torch, eng, params, tok, cache, active, steps: int = 1):
    """Device busy share of decode steps, their kernel launches and the
    kernels that fill them (torch.profiler; the profiler's own overhead
    slows the host side, so the busy share is a lower bound on an
    unprofiled step's).  Only kernel rows are summed: an operator row
    repeats its kernels' time.  A paged engine's step includes
    ``advance_slot`` for every active slot, as the scheduler runs it.  One
    step by default: the trace's events, not the step, cost the time
    (several seconds a step at olmo-1b's width)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slots = [s for s in range(eng.n_slots) if active is None or bool(active[s])]
    torch.cuda.synchronize()
    t_trace = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            if eng.paged:
                for slot in slots:
                    ok, cache = eng.advance_slot(cache, slot)
                    if not ok:
                        raise AssertionError("the pool ran dry while profiling")
            tok, _, cache = eng.decode(params, tok, cache, active=active)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    events = [
        e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev(e) > 0
    ]
    if not events:
        log("  profiled decode steps: the profiler reported no device kernels")
        return None
    busy_us = sum(dev(e) for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"  profiled {steps} decode steps: wall {wall_us / steps / 1e3:.2f} ms/step, "
        f"device busy {busy_us / steps / 1e3:.3f} ms/step "
        f"({100 * busy_us / wall_us:.1f}% busy, {100 - 100 * busy_us / wall_us:.1f}% idle), "
        f"{n_kernels // steps} kernel launches/step (profiling took "
        f"{time.perf_counter() - t_trace:.1f} s)")
    ranked = sorted(events, key=dev, reverse=True)
    # the ten largest rows, and every kernel of the port's own below them
    for i, e in enumerate(ranked):
        if i < 10 or any(k in e.key for k in PORT_KERNEL_NAMES):
            log(f"    {dev(e) / steps / 1e3:8.3f} ms/step  {e.count // steps:5d} calls/step  "
                f"{e.key[:90]}")
    # per kernel of the port: device ms per step and per launch
    port = {k: [sum(dev(e) for e in events if k in e.key) / steps / 1e3,
                sum(e.count for e in events if k in e.key) / steps] for k in PORT_KERNEL_NAMES}
    return dict(wall_ms=wall_us / steps / 1e3, busy_ms=busy_us / steps / 1e3,
                launches_per_step=n_kernels / steps,
                port={k: dict(ms_per_step=ms, ms_per_launch=ms / n)
                      for k, (ms, n) in port.items() if n})


def launch_ms(prof, kernel):
    """Device ms per launch of a port kernel in a ``profile_decode`` reading
    (None without a reading or a launch)."""
    entry = (prof or {}).get("port", {}).get(kernel)
    return entry["ms_per_launch"] if entry else None


# ------------------------------------------------------------ phase 6

TWO_PASS_KERNELS = ("fier_score", "topk_threshold", "fier_attend_selected")
UNFUSED_KERNELS = ("pack_quantize", "fier_score", "sparse_attention")


def two_pass_checks(torch, errs, calls):
    """A stand-in for ``ops.fier_decode_two_pass`` that runs the pipeline
    step by step (K6 → group reduction → K7 + ``compact_indices`` → K2, the
    pipeline's own launches) and, on the engine's own tensors, checks:
    its selection against K1's (idx, τ, m bitwise under ``max``); K8 on
    ``gather_kv`` of that selection against K2 (bitwise) and against K8's
    plain version; the selection of ``fier_decode_reference(use_kernels=True)``
    (``select_topk`` over K6's scores) against K1's, up to scores within ε
    of τ, and that pipeline's output finite.  Each call's (q, view) is kept
    in ``calls`` for the building-block run.  K1 and K8 launched here are
    comparison launches."""
    from repro_torch.core import retrieval
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kernels import topk_select as tk

    def checked(q, view, budget, *, group_reduce, sink, recent):
        B, Hq, D = q.shape
        Hkv = view.k.shape[2]
        sel = dict(sink=sink, recent=recent)
        scores = ops.fier_score(q, view.meta)
        kv = retrieval.reduce_over_query_group(scores, Hkv, group_reduce)
        masked = retrieval.masked_scores(kv, view.length, **sel).reshape(B * Hkv, -1)
        tau, m = tk.fier_topk_threshold(masked, budget)
        idx = tk.compact_indices(masked, tau, m, budget).reshape(B, Hkv, budget)
        out = ops.attend_selected(q, view, idx)
        calls.append((q, view))

        idx1, tau1, m1 = ops.retrieve(q, view, budget, group_reduce=group_reduce,
                                      return_stats=True, **sel)
        if group_reduce == "max" and not (torch.equal(idx, idx1) and torch.equal(
                tau, tau1.reshape(-1)) and torch.equal(m, m1.reshape(-1))):
            raise AssertionError("two_pass selects other tokens than K1 on the engine's tensors")
        q4 = q.reshape(B, Hkv, Hq // Hkv, D)
        ks, vs = retrieval.gather_kv(view.k, view.v, idx)
        mask = (idx < view.length[:, None, None]).to(torch.int8)
        out8 = sa.fier_attend_gathered(q4, ks, vs, mask)
        out2 = sa.fier_attend_selected(q4, view.k, view.v, idx, view.length)
        out_p = sa.fier_attend_gathered_plain(q4, ks, vs, mask)
        if not torch.equal(out8, out2):
            raise AssertionError("K8 differs from K2 on the engine's tensors")
        err = float((out8 - out_p).abs().max())
        rel = err / float(out_p.abs().max())
        if not rel <= K2_REL_TOL:
            raise AssertionError(f"K8 disagrees with its plain version on the engine's "
                                 f"tensors: {err:.3g} ({rel:.3g} of max|out|)")
        errs["k8"], errs["k8_rel"] = max(errs["k8"], err), max(errs["k8_rel"], rel)

        ref_idx = retrieval.select_topk(kv, budget, view.length, **sel)
        amax = (view.meta.scale.float().abs() + view.meta.zero.float().abs()).amax()
        eps = float(D * 2.0**-23 * (Hq // Hkv) * q.float().abs().sum(-1).amax() * amax)
        marks = lambda i: torch.zeros_like(masked, dtype=torch.bool).scatter_(
            1, i.reshape(B * Hkv, -1).long(), True)
        near = ((masked - tau[:, None]).abs() <= eps) | (masked == tau[:, None])
        n_ref = int((marks(ref_idx) ^ marks(idx1)).sum())
        if not bool((~(marks(ref_idx) ^ marks(idx1)) | near).all()):
            raise AssertionError("the reference pipeline with use_kernels selects other "
                                 "tokens than K1 on the engine's tensors")
        ref_out = retrieval.fier_decode_reference(
            q, view.k, view.v, view.meta, budget, view.length, group_reduce=group_reduce,
            use_kernels=True, **sel,
        )
        if not torch.isfinite(ref_out).all():
            raise AssertionError("non-finite output of fier_decode_reference(use_kernels=True)")
        errs["ref_swaps"] += n_ref
        errs["ref_gap"] = max(errs["ref_gap"], float((ref_out.float() - out.float()).abs().max()))
        errs["calls"] += 1
        return out

    return checked


def two_pass_path(torch, cfg, params, p3, one):
    """Phase 6: the ``two_pass`` pipeline at full width on the phase 3
    weights and prompts.  The first decode step (from a copy of the prefill
    cache) runs ``two_pass_checks`` and must give phase 3's one_pass logits
    exactly; the unfused building blocks (``ops.pack_quantize`` on the first
    FIER layer's key slab, ``ops.fier_attention_decode`` on every FIER
    layer's tensors of that step) then run counted, K5 held bitwise to its
    plain version; ``generate`` of 32 greedy tokens must give phase 3's
    tokens with K6 = K7 = K2 = 14 × decode steps and nothing else;
    ``count_score_bytes`` of one layer must read 0 for one_pass (slab and
    paged) and at least 2·4·Hq·S·B for two_pass.  Then two_pass and one_pass
    decode steps are timed in turns and profiled (information only)."""
    import dataclasses

    from repro_torch.core.policy import CacheView, DecodePlan, decode_attention
    from repro_torch.core.quantize import QuantizedKeys
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import pack_quantize as pq
    from repro_torch.obs.flopcount import count_score_bytes
    from repro_torch.serving import Engine, serving_policy

    eng = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY, device=DEVICE,
                       policy=serving_policy(budget=BUDGET, pipeline="two_pass"))
    pol = eng.bundle.policy
    if (pol.pipeline, pol.layout, pol.budget) != ("two_pass", "slab", BUDGET):
        raise AssertionError(f"the two_pass engine's policy is {pol}")
    prompts, lengths = p3["prompts"], p3["lengths"]
    lg0, cache = eng.prefill_batch(params, {"tokens": prompts, "lengths": lengths})
    tok0 = torch.argmax(lg0, -1).to(torch.int32)

    # ---- the first decode step, checked on the engine's own tensors
    errs = {"k8": 0.0, "k8_rel": 0.0, "ref_swaps": 0, "ref_gap": 0.0, "calls": 0}
    calls = []
    real = ops.fier_decode_two_pass
    ops.fier_decode_two_pass = two_pass_checks(torch, errs, calls)
    try:
        step_cache = clone_cache(torch, cache)
        _, lg1, _ = eng.decode(params, tok0, step_cache)
        sync(torch)
    finally:
        ops.fier_decode_two_pass = real
    n_fier = cfg.n_layers - pol.skip_layers
    if errs["calls"] != n_fier:
        raise AssertionError(f"the checked step ran {errs['calls']} FIER layers, not {n_fier}")
    gap = float((lg1[:, : cfg.vocab] - p3["lg1"]).abs().max())
    log(f"  first decode step: max |Δlogit| vs phase 3's one_pass step {gap:.6g} (expected 0)")
    log(f"  per layer on the engine's tensors ({errs['calls']} calls): K6+K7 selection = K1's "
        f"(idx, tau, m bitwise); K8 = K2 bitwise, vs plain max |err| {errs['k8']:.3g} "
        f"({errs['k8_rel']:.3g} of max|out|); reference+use_kernels index sets vs K1: "
        f"{errs['ref_swaps']} near-tau swaps, output max |Δ| vs two_pass {errs['ref_gap']:.3g}")
    if gap != 0.0:
        raise AssertionError("the two_pass first step differs from the one_pass step")

    # ---- the unfused building blocks, counted, on that step's tensors
    reset_launch_counts()
    q0, view0 = calls[0]
    codes, scale, zero = pq.fier_pack_quantize(view0.k, GROUP)
    outs = [ops.fier_attention_decode(q, v.k, v.v, v.meta, BUDGET, v.length)
            for q, v in calls]
    sync(torch)
    counts_bb = launch_counts()
    want = {"pack_quantize": 1, "fier_score": n_fier, "sparse_attention": n_fier}
    for name, n in counts_bb.items():
        if n != want.get(name, 0):
            raise AssertionError(f"building blocks: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    plain = pq.fier_pack_quantize_plain(view0.k, GROUP)
    side = (view0.meta.codes, view0.meta.scale, view0.meta.zero)
    if not all(torch.equal(a, b) for a, b in zip((codes, scale, zero), plain)):
        raise AssertionError("K5 differs from its plain version on the engine's key slab")
    off = [byte_diff(torch, a, b) for a, b in zip((codes, scale, zero), side)]
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("non-finite fier_attention_decode output")
    log(f"  building blocks on the step's tensors: launches {counts_bb}; K5 bitwise equal to "
        f"its plain version on the first FIER layer's key slab, bytes differing from the "
        f"engine's side-car (codes, scale, zero) {off}")
    del calls, outs, codes, scale, zero, plain, step_cache

    # ---- the counted run
    reset_launch_counts()
    sync(torch)
    t0 = time.perf_counter()
    toks, cache2 = eng.generate(params, prompts, lengths, MAX_NEW, return_cache=True)
    sync(torch)
    t_gen = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(counts, TWO_PASS_KERNELS, n_fier * (MAX_NEW - 1))
    agree = int((toks == p3["toks"]).sum())
    log(f"  launches {counts}: {n_fier} x {MAX_NEW - 1} decode steps")
    log(f"  greedy tokens equal to phase 3's one_pass tokens: {agree}/{toks.numel()}; "
        f"generate {MAX_NEW} tokens {t_gen:.3f} s")
    if agree != toks.numel():
        raise AssertionError("two_pass tokens differ from one_pass tokens")

    # ---- score bytes of one FIER layer at the main-path shape
    rest = cache2["rest"]
    meta = rest["meta"].layer(0)
    length = cache2["length"]
    B, S, Hkv, D = rest["k"][0].shape
    Hq = cfg.n_heads
    q = torch.randn((B, Hq, D), device=DEVICE).to(torch.bfloat16)
    slab = CacheView.slab(rest["k"][0], rest["v"][0], meta, length)
    nb = S // BLOCK_SIZE
    pool = lambda a: a.reshape(B * nb, a.shape[1] // nb, Hkv, D)
    table = torch.arange(B * nb, dtype=torch.int32, device=DEVICE).reshape(B, nb)
    paged = CacheView.paged(pool(slab.k), pool(slab.v), QuantizedKeys(
        pool(meta.codes), pool(meta.scale), pool(meta.zero), GROUP), table, length)
    sb = {}
    for name, view, pipeline in (("one_pass", slab, "one_pass"), ("one_pass_paged", paged, "one_pass"),
                                 ("two_pass", slab, "two_pass"), ("reference", slab, "reference")):
        plan = DecodePlan.build(dataclasses.replace(pol, pipeline=pipeline, layout=view.layout))
        sb[name] = count_score_bytes(lambda q: decode_attention(q, view, plan), S, q)
    floor = 2 * 4 * Hq * S * B
    log(f"  score bytes of one layer (B={B}, Hq={Hq}, S={S}): {sb}; two_pass floor "
        f"2·4·Hq·S·B = {floor}")
    if not (sb["one_pass"] == 0 and sb["one_pass_paged"] == 0 and sb["two_pass"] >= floor
            and sb["reference"] > 0):
        raise AssertionError(f"the score-byte contract fails: {sb}")
    del slab, paged, meta, rest

    # ---- two_pass vs one_pass decode steps in turns (unprofiled), and profiles
    _, cache1 = one.prefill_batch(params, {"tokens": prompts, "lengths": lengths})
    tok1 = tok2 = toks[:, -1].clone()
    ms = {"one_pass": [], "two_pass": []}
    for i in range(2 * EXTRA_STEPS):
        for name in (("one_pass", "two_pass") if i % 2 == 0 else ("two_pass", "one_pass")):
            sync(torch)
            t0 = time.perf_counter()
            if name == "one_pass":
                tok1, _, cache1 = one.decode(params, tok1, cache1)
            else:
                tok2, _, cache2 = eng.decode(params, tok2, cache2)
            sync(torch)
            ms[name].append(1e3 * (time.perf_counter() - t0))
    med = {k: median(v) for k, v in ms.items()}
    log(f"  decode ms/step in turns (median of {2 * EXTRA_STEPS} each, 4 slots): two_pass "
        f"{med['two_pass']:.2f}, one_pass {med['one_pass']:.2f}")
    if DEVICE == "cuda":
        log("  two_pass engine:")
        profile_decode(torch, eng, params, tok2, cache2, None)
        log("  one_pass engine:")
        profile_decode(torch, one, params, tok1, cache1, None)
    del cache, cache1, cache2, eng
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return counts, counts_bb, errs, dict(step_ms=med, score_bytes=sb)


# ------------------------------------------------------------ phase 7

QUEST_PAGE = 16
TURN_STEPS = 8              # phase 7's decode steps per engine, taken in turns
EVICT_STEPS = 32
QUEST_OUT_REL_TOL = 1e-4    # quest's f32 attention output, card vs CPU: f32 sum order
# quest and slm at budget = capacity select every valid token, as full attention
# reads it, but in another order: the f32 sums differ, each output rounds to bf16
# and the layers carry it on; the same kind of gap as phase 3's kernels vs their
# plain versions, so the same tolerance
FULL_BUDGET_LOGIT_REL_TOL = PLAIN_LOGIT_REL_TOL


def plain_quest_pages(torch, q, K, length, budget, page, group_reduce, reduce):
    """Quest's page choice written out here, apart from the port: each
    page's channel max and min read from the bf16 keys themselves, the box
    bound Σ_d max(q_d·kmax_d, q_d·kmin_d) (or its max over d) in f32, the
    max or sum over a kv head's query group, the pages that start at or past
    the length left out, and the max(budget // page, 1) highest by
    ``torch.topk``.  Returns (selected, scores), both [B, Hkv, P], the
    left-out pages scored -inf."""
    B, S, Hkv, D = K.shape
    P, rep = S // page, q.shape[1] // Hkv
    Kp = K.float().reshape(B, P, page, Hkv, D)
    hi, lo = Kp.amax(2)[:, :, :, None], Kp.amin(2)[:, :, :, None]   # [B, P, Hkv, 1, D]
    qf = q.float().reshape(B, 1, Hkv, rep, D)
    per = torch.maximum(qf * hi, qf * lo)                            # [B, P, Hkv, rep, D]
    sc = per.sum(-1) if reduce == "sum" else per.amax(-1)
    sc = (sc.amax(-1) if group_reduce == "max" else sc.sum(-1)).permute(0, 2, 1)
    first = torch.arange(P, device=K.device) * page
    sc = torch.where(first[None, None] < length[:, None, None], sc,
                     torch.full_like(sc, float("-inf")))
    top = torch.topk(sc, max(budget // page, 1), dim=-1).indices
    return torch.zeros(sc.shape, dtype=torch.bool, device=K.device).scatter_(-1, top, True), sc


def checked_quest(torch, errs):
    """A stand-in for ``quest.quest_attention_decode`` that runs it on the
    card and on a CPU copy of the same inputs (the engine's own q, cache and
    page metadata): the selected page sets must be equal except pages whose
    score lies within ε of the n_pages-th (ε = D·2^-23·rep·maxΣ|q|·max|k|,
    the f32 summation-order bound of a page score); the card's page set
    must also equal, up to the same near-ties, the one that
    ``plain_quest_pages`` picks on the card from the keys alone; and the f32 output of
    every kv head whose page set is equal within QUEST_OUT_REL_TOL·max|out|
    (compared before the cast to the activations' bf16: one bf16 rounding
    step alone is 2^-8 of a value).  The card's output goes on down the
    stack, and must be its f32 output rounded."""
    from repro_torch.core import quest, retrieval

    orig = quest.quest_attention_decode

    def pages(q, meta, budget, length, group_reduce, reduce):
        ps = quest.page_scores(q, meta, reduce=reduce)
        kv = retrieval.reduce_over_query_group(ps, meta.kmax.shape[2], group_reduce)
        idx = quest.quest_token_indices(kv, budget, meta.page, length)
        P = kv.shape[-1]
        sel = torch.zeros(kv.shape, dtype=torch.bool, device=kv.device)
        sel.scatter_(-1, (idx[..., ::meta.page] // meta.page).to(torch.int64), True)
        pos = torch.arange(P, device=kv.device) * meta.page
        masked = torch.where(pos[None, None] < length[:, None, None], kv,
                             torch.full_like(kv, retrieval.NEG_INF))
        return sel, masked

    def run(q, K, V, meta, budget, length=None, *, group_reduce="max", reduce="sum"):
        sel = dict(group_reduce=group_reduce, reduce=reduce)
        out = orig(q, K, V, meta, budget, length, **sel)
        out32 = orig(q.float(), K, V, meta, budget, length, **sel)  # the f32 output
        if not torch.equal(out, out32.to(out.dtype)):
            raise AssertionError("quest's output is not its f32 output rounded")
        c = lambda t: t.cpu()
        meta_c = quest.PageMeta(c(meta.kmax), c(meta.kmin), meta.page)
        out_c = orig(c(q).float(), c(K), c(V), meta_c, budget, c(length), **sel)
        sel, _ = pages(q, meta, budget, length, group_reduce, reduce)
        sel_c, kv_c = pages(c(q), meta_c, budget, c(length), group_reduce, reduce)
        n_pages = max(budget // meta.page, 1)
        kth = torch.sort(kv_c, dim=-1, descending=True).values[..., n_pages - 1:n_pages]
        B, Hq, D = q.shape
        Hkv = K.shape[2]
        kmax = float(torch.maximum(meta_c.kmax.float().abs(), meta_c.kmin.float().abs()).max())
        eps = D * 2.0**-23 * (Hq // Hkv) * float(c(q).float().abs().sum(-1).max()) * kmax
        diff = sel.cpu() ^ sel_c
        if bool((diff & ((kv_c - kth).abs() > eps)).any()):
            raise AssertionError("quest's page set on the card differs from the CPU copy's "
                                 f"beyond near-ties (eps {eps:.3g})")
        sel_p, kv_p = plain_quest_pages(torch, q, K, length, budget, meta.page,
                                        group_reduce, reduce)
        kth_p = torch.sort(kv_p, dim=-1, descending=True).values[..., n_pages - 1:n_pages]
        diff_p = (sel ^ sel_p) & torch.isfinite(kv_p)  # pages past the length attend nothing
        if bool((diff_p & ((kv_p - kth_p).abs() > eps)).any()):
            raise AssertionError("quest's page set on the card differs from the plain top-k "
                                 f"over the keys' page bounds beyond near-ties (eps {eps:.3g})")
        same = ~diff.any(-1)  # [B, Hkv]
        heads = same.repeat_interleave(Hq // Hkv, dim=1)
        gap = (out32.cpu() - out_c).abs()[heads]
        err = float(gap.max()) if gap.numel() else 0.0
        rel = err / float(out_c.float().abs().max())
        if not rel <= QUEST_OUT_REL_TOL:
            raise AssertionError(f"quest's output on the card differs from the CPU copy's: "
                                 f"{err:.3g} ({rel:.3g} of max|out|)")
        errs["calls"] += 1
        errs["page_swaps"] += int(diff.sum())
        errs["plain_swaps"] += int(diff_p.sum())
        errs["pages"] += int(sel.sum())
        errs["out_rel"] = max(errs["out_rel"], rel)
        errs["eps"] = max(errs["eps"], eps)
        return out

    return orig, run


def eviction_inputs(torch, K, L, seed=7):
    """Seeded CPU inputs of ``eviction_family`` for a cache K [1, S, Hkv, D]:
    a query and a new key/value row per step (keys at the cache's scale)
    and SnapKV's observation-window queries."""
    Hkv, D = K.shape[2:]
    gen = torch.Generator().manual_seed(seed)
    scale = float(K[0, :L].float().std())
    new = lambda shape, s=1.0: (s * torch.randn(shape, generator=gen)).to(torch.bfloat16)
    return dict(qs=new((EVICT_STEPS, 1, Hkv, D)), kn=new((EVICT_STEPS, Hkv, D), scale),
                vn=new((EVICT_STEPS, Hkv, D), scale), qw=new((1, Hkv, 32, D)))


def eviction_family(torch, K, V, L, inputs):
    """The eviction baselines on one slot's cache (K/V [1, S, Hkv, D] on some
    device, length L): the StreamingLLM mask, the SnapKV selection at
    BUDGET, and from it EVICT_STEPS steps of H2O and of TOVA, each appending
    one new token (``eviction_inputs``) and evicting one.  Returns the masks,
    alive sets and alive counts on the CPU."""
    from repro_torch.core import eviction as ev

    dev = K.device
    S = K.shape[1]
    qs, kn, vn, qw = (inputs[k] for k in ("qs", "kn", "vn", "qw"))
    length = torch.tensor([L], dtype=torch.int32, device=dev)
    out = {"slm": ev.streaming_llm_mask(S, length, BUDGET, SINK).cpu()}
    base = ev.snapkv_state(qw.to(dev), K, length, BUDGET, window=32)
    out["snapkv"] = base.alive.cpu()
    steps = {
        "h2o": lambda st, p, ln: ev.h2o_step(st, p, ln, BUDGET, recent=32),
        "tova": lambda st, p, ln: ev.tova_step(st, p, ln, BUDGET),
    }
    for name, step in steps.items():
        K2, V2, st, ln = K.clone(), V.clone(), base, length.clone()
        counts = []
        for i in range(EVICT_STEPS):
            K2[0, ln[0]] = kn[i].to(dev)
            V2[0, ln[0]] = vn[i].to(dev)
            st = ev.append_alive(st, ln)
            ln = ln + 1
            _, probs = ev.masked_attention_decode(qs[i].to(dev), K2, V2, st.alive)
            st = step(st, probs, ln)
            counts.append(st.alive.sum(-1).cpu())
        out[name] = st.alive.cpu()
        out[name + "_counts"] = torch.stack(counts)
    return out


def shim_checks(torch, q, K, V, qk, length):
    """Each deprecated shim of ``kernels.ops``, called once on a FIER layer's
    tensors (a paged pool built from the slab for the paged ones): it must
    warn exactly once, launch its kernels once each and nothing else, and
    equal its CacheView call bit for bit."""
    import warnings

    from repro_torch.core import policy as core_policy
    from repro_torch.core.policy import CacheView
    from repro_torch.core.quantize import QuantizedKeys
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts

    pools, table, _, _, _ = paged_inputs(torch, q, K, V, qk, length, BLOCK_SIZE, 8, 11)
    pmeta = QuantizedKeys(pools["codes"], pools["scale"], pools["zero"], qk.group)
    kp, vp = pools["k"], pools["v"]
    slab = CacheView.slab(K, V, qk, length)
    paged = CacheView.paged(kp, vp, pmeta, table, length)
    idx = ops.retrieve(q, slab, BUDGET, sink=SINK, recent=RECENT)
    sel = dict(sink=SINK, recent=RECENT)
    shims = {
        "fused_retrieve": (
            ("fier_retrieve",),
            lambda: ops.fused_retrieve(q, qk, BUDGET, length, return_stats=True, **sel),
            lambda: ops.retrieve(q, slab, BUDGET, return_stats=True, **sel)),
        "fused_sparse_attention": (
            ("fier_attend_selected",),
            lambda: ops.fused_sparse_attention(q, K, V, idx, length),
            lambda: ops.attend_selected(q, slab, idx)),
        "fused_fier_attention_decode": (
            SLAB_KERNELS,
            lambda: ops.fused_fier_attention_decode(q, K, V, qk, BUDGET, length, **sel),
            lambda: ops.fier_decode_one_pass(q, slab, BUDGET, **sel)),
        "paged_fused_retrieve": (
            ("fier_retrieve_paged",),
            lambda: ops.paged_fused_retrieve(q, pmeta, table, BUDGET, length,
                                             return_stats=True, **sel),
            lambda: ops.retrieve(q, paged, BUDGET, return_stats=True, **sel)),
        "paged_fused_sparse_attention": (
            ("fier_attend_selected_paged",),
            lambda: ops.paged_fused_sparse_attention(q, kp, vp, table, idx, length),
            lambda: ops.attend_selected(q, paged, idx)),
        "paged_fused_fier_attention_decode": (
            PAGED_KERNELS,
            lambda: ops.paged_fused_fier_attention_decode(q, kp, vp, pmeta, table, BUDGET,
                                                          length, **sel),
            lambda: ops.fier_decode_one_pass(q, paged, BUDGET, **sel)),
    }
    for name, (kernels, shim, new) in shims.items():
        core_policy._warned.discard(f"kernels.ops.{name}")
        reset_launch_counts()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = shim()
        sync(torch)
        counts = launch_counts()
        want = new()
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        n_warn = sum(issubclass(w.category, DeprecationWarning) for w in rec)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        if DEVICE == "cuda":
            check_launches(counts, kernels, 1)
        log(f"  shim {name}: {n_warn} warning, equal to its CacheView call: {same}, "
            f"launched {[k for k, n in counts.items() if n]}")
        if n_warn != 1 or not same:
            raise AssertionError(f"the deprecated shim {name} fails: {n_warn} warnings, "
                                 f"equal {same}")


def planted_page_drops(torch, wide, params, tok0, cache, ref):
    """The full-budget gate's control: quest's first step at budget =
    capacity with one page planted out of every layer's choice (its token
    indices moved to the last slot, past every length, so that they attend
    nothing): the sink page 0, or the last valid page, which holds the
    newest tokens.  Returns {fault: (max |Δlogit| against full attention,
    top-1 agreements)}."""
    from repro_torch.core import quest

    orig = quest.quest_token_indices
    out = {}
    for fault in ("sink page dropped", "last valid page dropped"):
        def planted(kv_ps, budget, page, length=None, fault=fault):
            idx = orig(kv_ps, budget, page, length)
            S = kv_ps.shape[-1] * page
            drop = (torch.zeros_like(length) if fault.startswith("sink")
                    else (length - 1) // page)
            hit = (idx // page) == drop[:, None, None]
            return torch.where(hit, torch.full_like(idx, S - 1), idx)

        quest.quest_token_indices = planted
        try:
            lg, _ = wide.decode_step(params, tok0, clone_cache(torch, cache))
        finally:
            quest.quest_token_indices = orig
        lg = lg[:, : ref.shape[-1]]
        out[fault] = (float((lg - ref).abs().max()),
                      int((lg.argmax(-1) == ref.argmax(-1)).sum()))
    return out


def baselines_path(torch, cfg, params, p3):
    """Phase 7: the paper's baselines at full width on phase 3's prompts and
    weights.  Quest (page 16), slm (sink 4) and FIER one_pass slab engines,
    budget 1024, skip 2:

    * quest's first decode step on the card against a CPU copy of every
      quest layer's inputs (``checked_quest``);
    * quest and slm at budget = capacity give the ``full`` engine's
      first-step logits within FULL_BUDGET_LOGIT_REL_TOL·max|logit|;
    * quest and slm launch none of K1–K8 (their first steps counted alone,
      then TURN_STEPS steps of each engine in turns: only FIER's 14 K1/K2
      launches per step);
    * the eviction family on layer 2's cache of slot 0, on the card and on a
      CPU copy: equal alive sets, BUDGET alive after every H2O/TOVA step,
      and the first of tied minima evicted on the card;
    * every deprecated shim (``shim_checks``), outside the counted runs.
    Reports the unprofiled ms/step of the three engines taken in turns, and
    their profiles."""
    import dataclasses

    from repro_torch.core import eviction as ev
    from repro_torch.core import quest
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, serving_policy

    prompts, lengths = p3["prompts"], p3["lengths"]
    batch = {"tokens": prompts, "lengths": lengths}
    pols = {
        "quest": PolicyConfig(kind="quest", budget=BUDGET, page=QUEST_PAGE, skip_layers=SKIP),
        "slm": PolicyConfig(kind="slm", budget=BUDGET, sink=SINK, skip_layers=SKIP),
        "fier": serving_policy(budget=BUDGET),
    }
    engines, caches, lg0 = {}, {}, None
    for name, pol in pols.items():
        engines[name] = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY, policy=pol,
                                     device=DEVICE)
        lg, caches[name] = engines[name].prefill_batch(params, batch)
        if lg0 is None:
            lg0 = lg
        elif not torch.equal(lg, lg0):
            raise AssertionError(f"{name}'s prefill logits differ from quest's")
    tok0 = torch.argmax(lg0, -1).to(torch.int32)

    # ---- full budget: quest and slm at budget = capacity vs the full engine
    full = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY, policy=PolicyConfig(kind="full"),
                        device=DEVICE)
    _, cache_full = full.prefill_batch(params, batch)
    _, lg_full, _ = full.decode(params, tok0, cache_full)
    del cache_full, full
    ref = lg_full[:, : cfg.vocab]
    s_full = float(ref.abs().max())
    reset_launch_counts()
    for name in ("quest", "slm"):
        wide = build_model(cfg, dataclasses.replace(pols[name], budget=CAPACITY), device=DEVICE)
        lg, _ = wide.decode_step(params, tok0, clone_cache(torch, caches[name]))
        gap = float((lg[:, : cfg.vocab] - ref).abs().max())
        top1 = int((lg[:, : cfg.vocab].argmax(-1) == ref.argmax(-1)).sum())
        log(f"  {name} at budget {CAPACITY} vs full attention, first step: max |Δlogit| "
            f"{gap:.4g} of max |logit| {s_full:.4g} (top-1 {top1}/{SLOTS}); tolerance "
            f"{FULL_BUDGET_LOGIT_REL_TOL}·max|logit|")
        if not gap <= FULL_BUDGET_LOGIT_REL_TOL * s_full:
            raise AssertionError(f"{name} at full budget differs from full attention: {gap:.4g}")
        if name == "quest":
            planted = planted_page_drops(torch, wide, params, tok0, caches[name], ref)
            log(f"  the same gate read with one page planted out of quest's choice at budget "
                f"{CAPACITY} (reported, not gated): " + ", ".join(
                    f"{k} max |Δlogit| {g:.4g} (top-1 {t}/{SLOTS})"
                    for k, (g, t) in planted.items()))
    sync(torch)
    check_launches(launch_counts(), (), 0)

    # ---- the first decode steps (counted: no kernel); quest's against a CPU copy
    errs = {"calls": 0, "page_swaps": 0, "plain_swaps": 0, "pages": 0, "out_rel": 0.0,
            "eps": 0.0}
    orig, checked = checked_quest(torch, errs)
    toks, step_ms = {}, {k: [] for k in engines}
    reset_launch_counts()
    for name in ("quest", "slm"):
        quest.quest_attention_decode = checked if name == "quest" else orig
        try:
            toks[name], lg, caches[name] = engines[name].decode(params, tok0, caches[name])
        finally:
            quest.quest_attention_decode = orig
        if not torch.isfinite(lg[:, : cfg.vocab]).all():
            raise AssertionError(f"{name}: non-finite first-step logits")
    sync(torch)
    check_launches(launch_counts(), (), 0)
    log(f"  quest's first step on the card vs a CPU copy, {errs['calls']} layers: "
        f"{errs['page_swaps']} near-tie page swaps (eps up to {errs['eps']:.3g}), max |Δout| "
        f"{errs['out_rel']:.3g} of max|out| (tolerance {QUEST_OUT_REL_TOL}); against the plain "
        f"top-k over the keys' page bounds on the card: {errs['plain_swaps']} near-tie swaps "
        f"of {errs['pages']} pages selected")
    if errs["calls"] != N_LAYERS - SKIP:
        raise AssertionError(f"quest ran on {errs['calls']} layers, expected {N_LAYERS - SKIP}")
    toks["fier"], _, caches["fier"] = engines["fier"].decode(params, tok0, caches["fier"])

    # ---- unprofiled decode steps in turns (quest and slm launch nothing; FIER K1/K2)
    sync(torch)
    reset_launch_counts()
    names = list(engines)
    for i in range(TURN_STEPS):
        for name in names[i % 3:] + names[: i % 3]:
            sync(torch)
            t0 = time.perf_counter()
            toks[name], _, caches[name] = engines[name].decode(params, toks[name], caches[name])
            sync(torch)
            step_ms[name].append(1e3 * (time.perf_counter() - t0))
    check_launches(launch_counts(), SLAB_KERNELS, (N_LAYERS - SKIP) * TURN_STEPS)
    med = {k: median(v) for k, v in step_ms.items()}
    log(f"  decode ms/step in turns (median of {TURN_STEPS} each, {SLOTS} slots, budget "
        f"{BUDGET}): " + ", ".join(f"{k} {v:.2f}" for k, v in med.items()) + f"; {CARD}")
    if DEVICE == "cuda":
        for name in names:
            log(f"  {name} engine:")
            profile_decode(torch, engines[name], params, toks[name], caches[name], None)

    # ---- the eviction family on layer 2's cache of slot 0, card vs a CPU copy
    L = int(lengths[0])
    K, V = caches["fier"]["rest"]["k"][0][:1], caches["fier"]["rest"]["v"][0][:1]
    inputs = eviction_inputs(torch, K.cpu(), L)
    on_dev = eviction_family(torch, K.clone(), V.clone(), L, inputs)
    on_cpu = eviction_family(torch, K.cpu(), V.cpu(), L, inputs)
    for name in on_dev:
        if not torch.equal(on_dev[name], on_cpu[name]):
            raise AssertionError(f"eviction {name}: the card's alive set differs from the CPU's")
    for name in ("h2o", "tova"):
        if not bool((on_dev[name + "_counts"] == BUDGET).all()):
            raise AssertionError(f"{name} did not keep its budget {BUDGET}")
    alive = torch.ones((1, 2, 8), dtype=torch.bool, device=DEVICE)
    probs = torch.tensor([[[3.0, 1.0, 2.0, 1.0, 1.0, 5.0, 6.0, 7.0], [0.0] * 8]],
                         device=DEVICE)
    st = ev.tova_step(ev.EvictionState(alive, torch.zeros_like(probs)), probs,
                      torch.tensor([8], device=DEVICE), 6)
    if (~st.alive).nonzero().tolist() != [[0, 0, 1], [0, 1, 0]]:
        raise AssertionError("the eviction step does not evict the first of tied minima")
    log(f"  eviction family on layer {SKIP}'s cache of slot 0 (length {L}), card vs CPU: "
        f"StreamingLLM mask, SnapKV set and {EVICT_STEPS} steps each of H2O and TOVA equal; "
        f"{BUDGET} alive after every step; ties evict the first index")

    # ---- the deprecated shims, outside every counted window
    rest = caches["fier"]["rest"]
    q = torch.randn((SLOTS, cfg.n_heads, cfg.d_head), device=DEVICE).to(torch.bfloat16)
    shim_checks(torch, q, rest["k"][0], rest["v"][0], rest["meta"].layer(0),
                caches["fier"]["length"])
    if DEVICE == "cuda":  # on the CPU such a view attends densely, as the reference's does
        from repro_torch.core.policy import CacheView, DecodePlan, UnsupportedPlanError, \
            decode_attention

        try:
            decode_attention(q, CacheView.slab(rest["k"][0], rest["v"][0], None,
                                               caches["fier"]["length"]),
                             DecodePlan.build(pols["fier"], capacity=CAPACITY))
        except UnsupportedPlanError:
            log("  a FIER plan over a card view without its side-car raises")
        else:
            raise AssertionError("a FIER plan over a card view without its side-car did not "
                                 "raise")
    del caches, engines
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return dict(step_ms=med, quest_errs=errs)


# ------------------------------------------------------------ phase 8

OFFLOAD_BLOCKS = 256
PREFIX_TTL = 4.0      # virtual-clock units (tokens prefilled or decoded)


def late_family_request(reqs, vocab):
    """Phase 8's one late request: phase 5's family prefix (P's first 4096
    tokens) + 256 tokens of its own, submitted once the stream has drained.
    Phase 5's order gives no recall (the family prefix is in use until the
    stream's end), so this request is the one that recalls it from the
    host tier, where the TTL sweep has moved it by then."""
    import numpy as np

    from repro_torch.serving import Request

    own = np.random.default_rng(12).integers(1, vocab, size=256).tolist()
    return Request(rid=len(reqs), tokens=reqs[0].tokens[:4096] + own, max_new=32)


def solo_tokens(torch, cfg, params, req):
    """``req`` served alone on a fresh paged engine of phase 5's shape with
    no host tier: its whole prompt is prefilled in the same 2048-token
    chunks as the stream's first request prefilled the family prefix.
    Returns its tokens."""
    import dataclasses
    import warnings

    from repro_torch.serving import ContinuousScheduler, Engine, Request, serving_policy

    eng = Engine.build(cfg, n_slots=8, capacity=CAPACITY, device=DEVICE, policy=dataclasses.replace(
        serving_policy(layout="paged"), pool_blocks=621))
    sched = ContinuousScheduler(eng, params, chunk_tokens=2048)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = sched.run([Request(rid=req.rid, tokens=list(req.tokens), max_new=req.max_new)])
    eng.audit()
    toks = [int(t) for t in res[req.rid]]
    del eng, sched
    return toks


def intervals_measure(xs):
    """Total length of the union of intervals [(a, b)]."""
    total, end = 0.0, None
    for a, b in sorted(xs):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def intersect_measure(xs, ys):
    """Length of (∪xs) ∩ (∪ys)."""
    return intervals_measure(xs) + intervals_measure(ys) - intervals_measure(list(xs) + list(ys))


def offload_stream(torch, cfg, params, outs_p5):
    """Phase 5's stream again with a host tier of OFFLOAD_BLOCKS blocks and
    a TTL: phase 5's gates, its tokens, blocks recalled > 0, and every block
    saved and then recalled reads back with 0 bytes changed in every pool leaf
    (K, V, codes, scale, zero); the tier's CUDA events give the transfer
    rates, the recall time per block and the share of it that overlaps the
    commit into the pool."""
    snaps, rt = {}, {"blocks": 0, "bytes_off": 0, "per_leaf": None}
    res = {}

    def setup(eng):
        tier = eng.offload
        tier.timing = DEVICE == "cuda"
        save0, recall0 = tier.save, eng._recall_extension

        def save(key, parent_key, leaves, reason="lru"):
            snap = [t.clone() for t in leaves]
            ok = save0(key, parent_key, leaves, reason)
            if ok:
                snaps[key] = snap
            return ok

        def recall(cache, keys, blocks, L, slot):
            n0 = len(blocks)
            cache = recall0(cache, keys, blocks, L, slot)
            for j in range(n0, len(blocks)):
                diffs = [byte_diff(torch, a, b) for a, b in
                         zip(eng._read_block(cache, blocks[j]), snaps.pop(keys[j]))]
                rt["per_leaf"] = diffs if rt["per_leaf"] is None else [
                    x + y for x, y in zip(rt["per_leaf"], diffs)]
                rt["bytes_off"] += sum(diffs)
                rt["blocks"] += 1
            return cache

        tier.save, eng._recall_extension = save, recall

    def finish(eng, sched):
        tier = eng.offload
        res.update(recalled=eng.blocks_recalled, tokens_recalled=eng.tokens_recalled,
                   recomputed=eng.tokens_recomputed, **tier.stats(),
                   ttl_evictions=eng.allocator.stats()["pool_ttl_evictions"])
        if DEVICE != "cuda" or tier._host is None:
            return
        per_block = tier._host.shape[1]  # one host row: every leaf of a block
        t = tier.transfer_times()
        dur = lambda xs: sum(b - a for a, b in xs)
        span = intervals_measure(t["h2d"] + t["commit"])
        res.update(
            block_bytes=per_block, d2h_copies=len(t["d2h"]), h2d_copies=len(t["h2d"]),
            d2h_gb_s=per_block * len(t["d2h"]) / dur(t["d2h"]) / 1e6 if t["d2h"] else None,
            h2d_gb_s=per_block * len(t["h2d"]) / dur(t["h2d"]) / 1e6 if t["h2d"] else None,
            recall_ms_per_block=span / len(t["h2d"]) if t["h2d"] else None,
            commit_ms_per_block=dur(t["commit"]) / len(t["commit"]) if t["commit"] else None,
            overlap_share=intersect_measure(t["h2d"], t["commit"]) / span if span else None,
        )

    late = late_family_request(stream_requests(cfg.vocab), cfg.vocab)
    counts, stats, errs, outs = serve_stream(
        torch, cfg, params, engine_kwargs=dict(offload_blocks=OFFLOAD_BLOCKS,
                                               prefix_ttl=PREFIX_TTL),
        setup=setup, finish=finish, late=[late])
    solo = solo_tokens(torch, cfg, params, late)
    same = {rid: outs[rid] == outs_p5[rid] for rid in outs_p5}
    log(f"  offload stream: {json.dumps(res)}")
    log(f"  the late request's tokens, its prefix recalled from the host tier, equal to the "
        f"same request served alone on a fresh engine without one: {outs[late.rid] == solo}")
    log(f"  round trip: {rt['blocks']} recalled blocks compared, bytes changed per leaf "
        f"(front K, V, rest K, V, codes, scale, zero) {rt['per_leaf']}; {CARD}")
    log(f"  tokens equal to phase 5's (no host tier): {sum(same.values())}/{len(same)}")
    checks = {
        "blocks recalled > 0": res["recalled"] > 0,
        "every recalled block compared": rt["blocks"] == res["recalled"],
        "0 bytes changed in the round trip": rt["bytes_off"] == 0,
        "tokens equal to phase 5's": all(same.values()),
        "the late request's tokens equal to its run without a host tier": outs[late.rid] == solo,
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"the offload stream failed: {bad}")
    return counts, stats, res


def chaos_requests(vocab):
    """Phase 8's chaos trace: a family prefix + 250 tokens and its repeat,
    3000- and 1500-token prompts, two family + 256 prompts; 16 tokens each.
    Under ``ServingFaultInjector.random(0)`` its allocation burst preempts
    two requests that no fault names (2 and 4)."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(6)
    toks = lambda n: rng.integers(1, vocab, size=n).tolist()
    fam = toks(4096)
    P = fam + toks(250)
    specs = [P, P, toks(3000), toks(1500), fam + toks(256), fam + toks(256)]
    return [Request(rid=i, tokens=list(t), max_new=16) for i, t in enumerate(specs)]


def preempt_marks(sched, reqs):
    """Hook ``sched`` so that the returned dict fills, for each request
    preempted (or whose chunked prefill was aborted), with the number of
    tokens it had generated at the first such event."""
    marks, byid, start = {}, {r.rid: r for r in reqs}, sched.start

    def start_hooked():
        start()
        record = sched.health.record_event

        def hooked(kind, **kw):
            if kind in ("preempt", "prefill_abort"):
                marks.setdefault(kw["rid"], len(byid[kw["rid"]].out))
            return record(kind, **kw)

        sched.health.record_event = hooked

    sched.start = start_hooked
    return marks


def gemm_rows_by_shape(torch, cfg):
    """Whether a row of a decode-shaped GEMM (8 rows, one per slot) equals
    the same row of a prefill-chunk GEMM (2048 rows) bit for bit, at the
    model's width in bf16: a preempted request recomputes in prefill chunks
    the K/V that decode steps first wrote, and this tells whether the GEMMs'
    rounding can be why its tokens change.  Returns (equal, max |Δ|)."""
    g = torch.Generator(device=DEVICE).manual_seed(9)
    x = torch.randn((2048, cfg.d_model), generator=g, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn((cfg.d_model, cfg.d_model), generator=g, device=DEVICE)
         / cfg.d_model ** 0.5).to(torch.bfloat16)
    small = torch.nn.functional.linear(x[:8], w)
    big = torch.nn.functional.linear(x, w)[:8]
    return torch.equal(small, big), float((small.float() - big.float()).abs().max())


def chaos_run(torch, cfg, params):
    """One seeded chaos run (``ServingFaultInjector.random(seed=0)``, five
    faults drawn over the five kinds) on the offload engine's configuration
    (8 slots × 8192, 621 blocks, OFFLOAD_BLOCKS host blocks, PREFIX_TTL) with
    the degradation ladder off (floor = budget, as the reference's chaos
    tests run it: a halved budget would change every running request's
    tokens), beside the same trace without faults: every fault fires, every
    request ends with a structured outcome, the requests that no fault
    names and nothing preempted give the fault-free tokens, the audit is
    clean with no block in use, and K3/K4 launch 14 × the decode steps.  A
    request that no fault names but that the injected allocation failures
    preempted (or whose chunked prefill they aborted) must give the
    fault-free tokens up to its first preemption.  After it, it recomputes
    its generated tokens' K/V in prefill chunks, which attend densely where
    the decode steps that first wrote them attended to the selected tokens:
    its later tokens are reported, as is whether a decode-shaped and a
    chunk-shaped GEMM agree bit for bit.
    (On the CPU, at reduced width with this trace, the JAX scheduler's own
    preempted request 2 leaves its fault-free tokens after preemption:
    ``tests/test_torch_preemption.py``.)"""
    import dataclasses
    import warnings

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import (FAULT_KINDS, ContinuousScheduler, Engine,
                                     ServingFaultInjector, serving_policy)
    from repro_torch.serving.health import STATUSES

    pol = dataclasses.replace(serving_policy(layout="paged"), pool_blocks=621)
    bundle = build_model(cfg, pol, device=DEVICE)
    n_fier = cfg.n_layers - pol.skip_layers
    runs = {}
    for name in ("fault-free", "chaos"):
        eng = Engine(bundle, n_slots=8, capacity=CAPACITY, offload_blocks=OFFLOAD_BLOCKS,
                     prefix_ttl=PREFIX_TTL, degrade_floor=BUDGET)
        reqs = chaos_requests(cfg.vocab)
        inj = None
        if name == "chaos":
            inj = ServingFaultInjector.random(0, rids=[r.rid for r in reqs], n_faults=5,
                                              step_lo=1, step_hi=8)
        sched = ContinuousScheduler(eng, params, chunk_tokens=2048, injector=inj, audit_every=4)
        marks = preempt_marks(sched, reqs)
        reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = sched.run(reqs)
        sync(torch)
        check_launches(launch_counts(), PAGED_KERNELS, n_fier * sched.steps)
        eng.audit()
        runs[name] = (res, inj, eng.allocator.n_in_use, sched.steps, marks)
        del eng, sched
    ff, _, _, _, _ = runs["fault-free"]
    res, inj, in_use, steps, marks = runs["chaos"]
    named = {s.rid for s in inj.specs}
    untargeted = sorted(set(res) - named - set(marks))
    same = {rid: list(res[rid]) == list(ff[rid]) for rid in untargeted}
    hit = sorted(set(marks) - named)
    before = {rid: list(res[rid])[: marks[rid]] == list(ff[rid])[: marks[rid]] for rid in hit}
    after = {rid: list(res[rid]) == list(ff[rid]) for rid in hit}
    gemm_equal, gemm_gap = gemm_rows_by_shape(torch, cfg)
    log(f"  chaos (seed 0): faults {[(s.kind, s.step, s.rid, s.count) for s in inj.specs]}, "
        f"fired {inj.fired_log}; outcomes "
        f"{ {rid: oc.status for rid, oc in sorted(res.outcomes.items())} }; {steps} steps; "
        f"untargeted requests {untargeted} equal to the fault-free run: {same}; "
        f"preempted or aborted with tokens generated then {marks}: those no fault names "
        f"equal to the fault-free run up to then {before}, to the end (reported) {after}")
    log(f"  rows of a decode-shaped GEMM (8 × {cfg.d_model}) equal to the same rows of a "
        f"2048-row chunk's, bf16: {gemm_equal} (max |Δ| {gemm_gap:.4g}); {CARD}")
    checks = {
        "every fault fired": inj.all_fired,
        "all five kinds drawn": {s.kind for s in inj.specs} == set(FAULT_KINDS),
        "every request has a structured outcome": sorted(res.outcomes) == sorted(res)
        and all(oc.status in STATUSES for oc in res.outcomes.values()),
        "untargeted requests give the fault-free tokens": bool(untargeted) and all(same.values()),
        "preempted requests no fault names give the fault-free tokens up to the preemption":
            all(before.values()),
        "fault-free run finished": all(oc.status == "finished" for oc in ff.outcomes.values()),
        "no block in use at the end": in_use == 0 and runs["fault-free"][2] == 0,
        "the fault-free run preempted nothing": not runs["fault-free"][4],
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"the chaos run failed: {bad}")
    return dict(marks=marks, before=before, after=after, gemm_equal=gemm_equal)


def corrupted_slot_kernels(torch, eng, cache, cfg):
    """K1 and K3 on a slot that ``corrupt_slot_metadata`` scrambled (codes ^
    0xA5, negative bf16 scales, zeros pushed far from the keys), every FIER
    layer: each within ε of its plain version (``checked_kernels``)."""
    slot = 1
    before = cache["rest"]["meta"].scale[:, slot].clone()
    ok, cache = eng.corrupt_slot_metadata(cache, slot)
    if not ok or not bool((cache["rest"]["meta"].scale[:, slot] == -before - 1).all()):
        raise AssertionError("corrupt_slot_metadata did not scramble the slot")
    errs = new_errs()
    retrieve, _ = checked_kernels(torch, errs, keep_plain=False)
    length = cache["length"]
    sel = dict(group=GROUP, group_reduce="max", sink=SINK, recent=RECENT)
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    rest = cache["rest"]
    for i in range(rest["k"].shape[0]):
        qk = rest["meta"].layer(i)
        q = torch.randn((SLOTS, cfg.n_kv_heads, 1, cfg.d_head), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        retrieve(q, qk.codes, qk.scale, qk.zero, length, BUDGET, **sel)
        pools, table, _, _, _ = paged_inputs(torch, q.reshape(SLOTS, -1, cfg.d_head), None,
                                             None, qk, length, BLOCK_SIZE, 8, 20 + i)
        retrieve(q, pools["codes"], pools["scale"], pools["zero"], length, BUDGET,
                 block_table=table, **sel)
    log(f"  K1/K3 on slot {slot} after corrupt_slot_metadata (scale min "
        f"{float(rest['meta'].scale[:, slot].float().min()):.3g}), {errs['calls']} calls, "
        f"each within eps of its plain version: {errs['k1_swaps']} near-tau swaps, max tau "
        f"err {errs['k1_tau']:.3g}")


def introspect_run(torch, cfg, params, p3):
    """``Observability(introspect=True)`` on phase 3's slab engine and prompts
    for 8 decode steps: every ``ProbeRecord`` in range (utilisation, overlap
    and mass in [0, 1], τ finite), K1/K2 launched 14 × the steps; then K1/K3
    on a corrupted slot of the same cache (``corrupted_slot_kernels``).
    Reports the mean oracle overlap and recaptured mass (random weights:
    reported, not gated)."""
    import math

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import Observability
    from repro_torch.serving import ContinuousScheduler, Engine, Request

    obs = Observability(introspect=True)
    eng = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY, obs=obs, device=DEVICE)
    prompts, lengths = p3["prompts"], p3["lengths"]
    # 9 decode steps: the introspector probes the 8 after which requests still run
    reqs = [Request(rid=i, tokens=prompts[i, : int(lengths[i])].tolist(), max_new=10)
            for i in range(SLOTS)]
    sched = ContinuousScheduler(eng, params)
    reset_launch_counts()
    sched.run(reqs)
    sync(torch)
    check_launches(launch_counts(), SLAB_KERNELS, (N_LAYERS - SKIP) * sched.steps)
    recs = obs.introspector.records
    inside = lambda v: 0.0 <= v <= 1.0
    ok = len(recs) == SLOTS * (sched.steps - 1) > 0 and all(
        inside(r.budget_utilization) and inside(r.oracle_overlap)
        and inside(r.recaptured_mass) and math.isfinite(r.tau) for r in recs)
    mean = lambda k: sum(getattr(r, k) for r in recs) / max(len(recs), 1)
    log(f"  introspector: {len(recs)} probe records over {sched.steps} decode steps x {SLOTS} "
        f"slots at budget {BUDGET}: mean oracle overlap {mean('oracle_overlap'):.4f}, "
        f"recaptured mass {mean('recaptured_mass'):.4f}, budget utilization "
        f"{mean('budget_utilization'):.3f}, tau {mean('tau'):.4g} (random weights: reported)")
    if not ok:
        raise AssertionError("a ProbeRecord lies out of range")
    corrupted_slot_kernels(torch, eng, sched._cache, cfg)
    del eng, sched
    return dict(overlap=mean("oracle_overlap"), mass=mean("recaptured_mass"))


def robustness_path(torch, cfg, params, p3, outs_p5):
    """Phase 8: the host tier, the faults and the introspector at full width."""
    counts, stats, off = offload_stream(torch, cfg, params, outs_p5)
    chaos = chaos_run(torch, cfg, params)
    intro = introspect_run(torch, cfg, params, p3)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return dict(offload=off, stream=stats, chaos=chaos, introspect=intro)


# ------------------------------------------------------------ phase 9

# The transformer-family configs served at full width: (config, slots,
# prompt lengths, greedy tokens, layers or None for the config's depth).  The
# longest prompt leaves room in the 8192-token slab for the generated, timed
# and profiled steps.  minicpm-2b (40 layers) and llava (32) run at half
# depth for the script's time limit; starcoder2-3b keeps its 30, whose
# planted faults sit nearest the gate.
FAMILY_PROMPTS = (8100, 6000, 3000, 1500)
FAMILY_RUNS = (  # granite's 16 tokens also run its paged-vs-slab comparison
    ("granite-moe-1b-a400m", SLOTS, FAMILY_PROMPTS, 16, None),
    ("minicpm-2b", SLOTS, FAMILY_PROMPTS, 8, 20),
    ("starcoder2-3b", SLOTS, FAMILY_PROMPTS, 8, None),
)
VLM = "llava-next-mistral-7b"
VLM_SLOTS, VLM_TEXT, VLM_STEPS, VLM_LAYERS = 2, (7000, 3000), 8, 16
TIMED_STEPS = 2  # timed decode steps per config (cut from 8, then 4)
# Phase 9's first-step gate as a fraction of max|logit|, set as phase 3's
# were: between the largest sound reading and the smallest planted fault's
# (PERF.md, PR 18).  Sound: minicpm-2b 0.01566 (38 FIER layers; above phase
# 3's 0.015, which olmo-1b's 14 set), llava 0.01425, starcoder2 0.01013,
# granite-moe 0.006946 with its expert choices replayed.  Faults: starcoder2
# 0.01837 and 0.02025, the rest 0.053 and above.
FAMILY_LOGIT_REL_TOL = 0.017


def family_first_step(torch, eng, params, tok0, cache, vocab, tol=FAMILY_LOGIT_REL_TOL):
    """The first decode step with the kernels and with their plain versions
    (``checked_kernels``: every layer's K1/K2 inputs also go through the
    kernel and are compared there), each from a copy of ``cache``, and with
    two planted faults (K2 fed idx+1; K1's selection of the first FIER layer
    handed to the next kv head, an error that runs through every later
    layer as the kernels' rounding does).  The kernel step's logits must
    lie within ``tol``·max|logit| of the plain step's (phase 9's
    FAMILY_LOGIT_REL_TOL unless given), and
    each fault's must not.  In a moe model a router's top-k is
    discontinuous: a last-bit difference upstream can swap a near-tied
    expert and move the logits by far more than the kernels' error.  So
    each MoE layer's expert choices are recorded in both runs; where any
    differ, the kernel step is run again with the plain run's choices
    replayed (gates from its own router logits), and that step is the one
    gated; the unpinned gap and the number of swapped choices are reported.
    Returns (errs, gap, max|logit|, unpinned gap, swapped routings)."""
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.models import moe as moe_mod

    route = moe_mod._route

    def step(retrieve=fr.fier_retrieve, attend=sa.fier_attend_selected, record=None,
             replay=None):
        calls = iter(replay) if replay is not None else None

        def routed(x, p, k):
            logits, eidx, gates = route(x, p, k)
            if calls is not None:
                eidx = next(calls)
                gates = torch.softmax(logits.gather(1, eidx), dim=-1)
            if record is not None:
                record.append(eidx)
            return logits, eidx, gates

        ops.fier_retrieve, ops.fier_attend_selected = retrieve, attend
        moe_mod._route = routed
        try:
            _, lg, _ = eng.decode(params, tok0, clone_cache(torch, cache))
            sync(torch)
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
            moe_mod._route = route
        return lg[:, :vocab]

    def shifted_attend(q, K, V, idx, lengths=None, **k):
        return sa.fier_attend_selected(q, K, V, (idx + 1) % K.shape[1], lengths, **k)

    n_calls = [0]

    def rolled_retrieve(*a, **k):
        idx, tau, m = fr.fier_retrieve(*a, **k)
        n_calls[0] += 1
        if n_calls[0] == 1:  # the first FIER layer only: its error runs through the rest
            idx = torch.roll(idx, 1, dims=1)
        return idx, tau, m

    errs = new_errs()
    plain_routes, kernel_routes = [], []
    lg1_plain = step(*checked_kernels(torch, errs, keep_plain=True), record=plain_routes)
    lg1 = step(record=kernel_routes)
    s1 = float(lg1_plain.abs().max())
    gap = unpinned = float((lg1 - lg1_plain).abs().max())
    swaps = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(plain_routes, kernel_routes))
    top1 = int((lg1.argmax(-1) == lg1_plain.argmax(-1)).sum())
    log_errs(errs, "K1", "K2")
    line = (f"  first decode step (max |logit| {s1:.4g}): max |Δlogit| vs plain versions "
            f"{gap:.4g} = {gap / s1:.4g} of max|logit| (top-1 {top1}/{lg1.shape[0]}; gate "
            f"{tol})")
    if plain_routes:
        line += (f"; expert choices swapped in {swaps} of {len(plain_routes) * lg1.shape[0]} "
                 f"(token, MoE layer) routings")
    if swaps:
        lg1 = step(replay=plain_routes)
        gap = float((lg1 - lg1_plain).abs().max())
        line += (f"; with the plain run's expert choices replayed: max |Δlogit| {gap:.4g} = "
                 f"{gap / s1:.4g} of max|logit|")
    log(line)
    faults = {"K2 fed idx+1": step(attend=shifted_attend),
              "K1's first-layer selection on the next kv head": step(retrieve=rolled_retrieve)}
    faults = {name: float((lg - lg1_plain).abs().max()) for name, lg in faults.items()}
    for name, fgap in faults.items():
        log(f"  planted fault, {name}: max |Δlogit| vs plain versions {fgap:.4g} = "
            f"{fgap / s1:.4g} of max|logit|")
    for name, fgap in faults.items():
        if not fgap > tol * s1:
            raise AssertionError(f"the first-step gate does not see the planted fault ({name}): "
                                 f"{fgap:.4g} <= {tol:.4g} · {s1:.4g}")
    if not (torch.isfinite(lg1).all() and gap <= tol * s1):
        raise AssertionError(f"first step vs plain versions: {gap:.4g} > {tol:.4g} · {s1:.4g}")
    return errs, gap, s1, unpinned, swaps


def peak_base(torch) -> int:
    """Bytes allocated before a model is built, with the peak reset: a
    model's peak memory is reported above it."""
    if DEVICE != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def timed_steps(torch, eng, params, tok, cache, steps):
    """Median host-clock ms of ``steps`` decode steps (synchronized), and
    the last token and cache."""
    ms = []
    for _ in range(steps):
        sync(torch)
        t0 = time.perf_counter()
        tok, _, cache = eng.decode(params, tok, cache)
        sync(torch)
        ms.append(1e3 * (time.perf_counter() - t0))
    return median(ms), tok, cache


def head_ms(torch, cfg, params, n_slots) -> float:
    """Device ms of one decode step's head (``_masked_logits`` over
    ``n_slots`` seeded hidden states), median of 5 CUDA-event readings."""
    from repro_torch.configs import padded_vocab
    from repro_torch.models.transformer import _masked_logits

    W = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    h = torch.randn((n_slots, cfg.d_model), generator=torch.Generator(device=DEVICE).manual_seed(3),
                    device=DEVICE).to(torch.bfloat16)
    return Timer(torch)(lambda: _masked_logits(h, W, cfg.vocab, padded_vocab(cfg)), iters=5,
                        warmup=1)


def family_drive(torch, cfg, n_slots, prompts, max_new, *, full_checks=None):
    """One config through ``Engine.build``'s default policy (fier / one_pass
    / slab / budget 1024 / skip 2), random weights from a seeded
    ``torch.Generator``: the first decode step with the kernels vs their
    plain versions (``family_first_step``), then ``generate``
    of ``max_new`` greedy tokens with K1/K2 launched (layers − 2) ×
    (max_new − 1) times and no other FIER kernel, then timed and profiled
    decode steps.  With ``full_checks`` (by default a moe config's) it also
    checks the reference pipeline's prefill logits (identical) and runs the
    same prompts through a paged engine (``paged_vs_slab``: tokens equal,
    K3/K4 per step, both engines profiled).  Peak memory is read over init,
    over the timed prefill, over the checks and ``generate`` after it, and
    over the timed decode steps (absolute), and the drive's peak above what
    was allocated before the model.
    Returns a dict of what it measured."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, serving_policy

    arch = cfg.name
    if full_checks is None:
        full_checks = cfg.family == "moe"
    cuda = DEVICE == "cuda"
    base = peak_base(torch)
    eng = Engine.build(cfg, n_slots=n_slots, capacity=CAPACITY, device=DEVICE)
    pol = eng.bundle.policy
    if (pol.kind, pol.pipeline, pol.layout, pol.budget, pol.skip_layers) != (
            "fier", "one_pass", "slab", BUDGET, SKIP):
        raise AssertionError(f"Engine.build's default policy is {pol}")
    n_fier = cfg.n_layers - SKIP
    params = eng.compute_params(eng.bundle.init(torch.Generator(device=DEVICE).manual_seed(0)))
    out = dict(arch=arch, layers=cfg.n_layers, d_head=cfg.d_head,
               rep=cfg.n_heads // cfg.n_kv_heads, kv_heads=cfg.n_kv_heads)
    memory = out["memory_gib"] = {}
    if cuda:
        sync(torch)
        memory.update(base=base / 2**30, init_peak=peak_gib(torch, 0),
                      after_init=torch.cuda.memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (n_slots, max(prompts)))).to(DEVICE)
    lengths = torch.tensor(prompts, dtype=torch.int32, device=DEVICE)
    batch = {"tokens": toks, "lengths": lengths}

    sync(torch)
    t0 = time.perf_counter()
    lg0, cache = eng.prefill_batch(params, batch)
    tok0 = torch.argmax(lg0, -1).to(torch.int32)
    sync(torch)
    out["ttft_ms"] = 1e3 * (time.perf_counter() - t0)
    if cuda:
        memory["prefill_peak"] = peak_gib(torch, 0)
    if full_checks:
        ref = Engine.build(cfg, n_slots=n_slots, capacity=CAPACITY, device=DEVICE,
                           policy=serving_policy(budget=BUDGET, pipeline="reference"))
        lg_ref, cache_ref = ref.prefill_batch(params, batch)
        if not torch.equal(lg_ref, lg0):
            raise AssertionError(f"{arch}: prefill logits differ between one_pass and reference")
        del ref, cache_ref, lg_ref
        log("  prefill logits identical to the reference pipeline")
    errs, gap, s1, unpinned, swaps = family_first_step(torch, eng, params, tok0, cache,
                                                       cfg.vocab)
    out.update(first_step_gap=gap, max_logit=s1, k1_tau_err=errs["k1_tau"],
               k1_swaps=errs["k1_swaps"], k2_err=errs["k2"], unpinned_gap=unpinned,
               expert_swaps=swaps)
    del cache

    reset_launch_counts()
    sync(torch)
    t0 = time.perf_counter()
    gen, cache = eng.generate(params, toks, lengths, max_new, return_cache=True)
    sync(torch)
    t_gen = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(counts, SLAB_KERNELS, n_fier * (max_new - 1))
    if not torch.equal(gen[:, 0], tok0):
        raise AssertionError(f"{arch}: generate's first token differs from prefill's argmax")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: generated tokens out of range")
    out["launches"] = {k: counts[k] for k in SLAB_KERNELS}
    if cuda:
        # the peak since the timed prefill (reference prefill, first steps, generate)
        memory["checks_peak"] = peak_gib(torch, 0)
        torch.cuda.reset_peak_memory_stats()
    out["ms_step"], tok, cache = timed_steps(torch, eng, params, gen[:, -1].clone(), cache,
                                             TIMED_STEPS)
    if cuda:
        memory["decode_peak"] = peak_gib(torch, 0)
    lens = cache["length"].tolist()
    want = [p + max_new - 1 + TIMED_STEPS for p in prompts]
    if lens != want:
        raise AssertionError(f"{arch}: cache lengths {lens}, expected {want}")
    log(f"  launches {out['launches']}: {n_fier} x {max_new - 1} decode steps; generate "
        f"{max_new} tokens {t_gen:.3f} s; TTFT (prefill + sample) {out['ttft_ms']:.1f} ms; "
        f"decode median {out['ms_step']:.2f} ms/step (unprofiled, {TIMED_STEPS} steps)")
    if cuda:
        if not full_checks:  # else paged_vs_slab profiles this engine below
            out["profile"] = profile_decode(torch, eng, params, tok, cache, None)
        out["head_ms"] = head_ms(torch, cfg, params, n_slots)
        log(f"  the head alone (device ms, median of 5): {out['head_ms']:.3f}")
    del cache
    if full_checks:
        log(f"  paged vs slab on the same prompts (bs {BLOCK_SIZE}, default pool)")
        profiles = {}
        out["launches_paged"] = {k: v for k, v in paged_vs_slab(
            torch, cfg, params, eng, prompts=prompts, steps=max_new, profiles=profiles).items()
            if k in PAGED_KERNELS}
        out["paged_vs_slab"] = profiles
    if cuda:
        # the whole drive's peak (the counter was reset after init and prefill)
        out["peak_gib"] = max(peak_gib(torch, 0), *(
            memory[k] for k in ("init_peak", "prefill_peak", "checks_peak"))) - memory["base"]
        log(f"  peak memory {out['peak_gib']:.2f} GiB; " + ", ".join(
            f"{k} {v:.2f}" for k, v in memory.items()) + " GiB allocated (absolute)")
    del eng, params
    return out


def vlm_drive(torch):
    """llava-next-mistral-7b at full width, 2 slots: the bundle's prefill of
    576 vision embeddings (seeded ``torch.Generator``) before the text, the
    lengths counting them; the first decode step with the kernels vs their
    plain versions; then VLM_STEPS greedy ``decode`` steps with K1/K2
    launched (layers − 2) × VLM_STEPS times."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine

    cfg = dataclasses.replace(get_config(VLM), n_layers=VLM_LAYERS)
    base = peak_base(torch)
    eng = Engine.build(cfg, n_slots=VLM_SLOTS, capacity=CAPACITY, device=DEVICE)
    n_fier = cfg.n_layers - SKIP
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = eng.compute_params(eng.bundle.init(gen))
    nv = cfg.n_vision_tokens
    vision = (torch.randn((VLM_SLOTS, nv, cfg.d_model), generator=gen, device=DEVICE)
              * cfg.d_model**-0.5).to(torch.bfloat16)
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (VLM_SLOTS, max(VLM_TEXT)))).to(DEVICE)
    lengths = torch.tensor([n + nv for n in VLM_TEXT], dtype=torch.int32, device=DEVICE)
    out = dict(arch=VLM, layers=cfg.n_layers, d_head=cfg.d_head,
               rep=cfg.n_heads // cfg.n_kv_heads, kv_heads=cfg.n_kv_heads, vision_tokens=nv)
    sync(torch)
    t0 = time.perf_counter()
    lg0, cache = eng.bundle.prefill(params, {"tokens": toks, "lengths": lengths,
                                             "vision_embeds": vision}, CAPACITY)
    tok = torch.argmax(lg0, -1).to(torch.int32)
    sync(torch)
    out["ttft_ms"] = 1e3 * (time.perf_counter() - t0)
    if cache["length"].tolist() != lengths.tolist() or not torch.isfinite(lg0).all():
        raise AssertionError(f"{VLM}: prefill lengths {cache['length'].tolist()} or logits wrong")
    errs, gap, s1, _, _ = family_first_step(torch, eng, params, tok, cache, cfg.vocab)
    out.update(first_step_gap=gap, max_logit=s1, k1_tau_err=errs["k1_tau"],
               k1_swaps=errs["k1_swaps"], k2_err=errs["k2"])
    reset_launch_counts()
    ms = []
    for _ in range(VLM_STEPS):
        sync(torch)
        t0 = time.perf_counter()
        tok, lg, cache = eng.decode(params, tok, cache)
        sync(torch)
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = launch_counts()
    check_launches(counts, SLAB_KERNELS, n_fier * VLM_STEPS)
    if cache["length"].tolist() != [n + VLM_STEPS for n in lengths.tolist()]:
        raise AssertionError(f"{VLM}: cache lengths {cache['length'].tolist()}")
    if not torch.isfinite(lg[:, :cfg.vocab]).all():
        raise AssertionError(f"{VLM}: non-finite decode logits")
    out["launches"] = {k: counts[k] for k in SLAB_KERNELS}
    out["ms_step"] = median(ms)
    log(f"  {nv} vision embeddings + text {VLM_TEXT}: TTFT {out['ttft_ms']:.1f} ms; launches "
        f"{out['launches']}: {n_fier} x {VLM_STEPS} decode steps; decode median "
        f"{out['ms_step']:.2f} ms/step")
    if DEVICE == "cuda":
        profile_decode(torch, eng, params, tok, cache, None)
        out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"  peak memory {out['peak_gib']:.2f} GiB")
    del eng, params, cache
    return out


def families_path(torch):
    """Phase 9: granite-moe-1b-a400m, minicpm-2b, starcoder2-3b and
    llava-next-mistral-7b at full width, each freed before the next."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config

    runs = {}
    for arch, n_slots, prompts, max_new, layers in FAMILY_RUNS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        log(f"  [{arch}] {cfg.n_layers} layers, {n_slots} slots x {CAPACITY}, prompts {prompts}, "
            f"{max_new} tokens")
        runs[arch] = family_drive(torch, cfg, n_slots, prompts, max_new)
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    log(f"  [{VLM}] {VLM_SLOTS} slots x {CAPACITY}")
    runs[VLM] = vlm_drive(torch)
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------ phase 10

# The ssm, hybrid and encdec configs at full width and depth: (config,
# slots, capacity, prompt lengths, greedy tokens).  Token arrays are padded
# to the capacity (a multiple of the SSM chunk, so the chunked scan runs
# whole chunks; ``lengths`` mask the rest); the longest prompt leaves room
# for the generated, timed and profiled steps.  whisper-small serves at
# capacity 4096 with a 4096-row position table (max_positions).
SSM_PROMPTS = (8100, 6000, 3000, 1500)
WHISPER_CAPACITY = 4096
# the configs whose decode step phase 10 profiles; mamba2's and whisper's
# steps read 6.198 and 5.146 ms/step device busy when last profiled
# (PERF.md §5), and their profiles went to pay for (d)'s time, as zamba2's
# last 2 generated tokens went to pay for (d)'s selection checks
PHASE10_PROFILED = ("zamba2-7b",)
PHASE10_RUNS = (
    ("mamba2-370m", SLOTS, CAPACITY, SSM_PROMPTS, 8),
    ("zamba2-7b", SLOTS, CAPACITY, SSM_PROMPTS, 6),
    ("whisper-small", SLOTS, WHISPER_CAPACITY, (4000, 3000, 2000, 1000), 8),
)
# mamba2-370m: the recurrent step's first logits vs a prefill (the chunked
# scan) of each prompt extended by the decoded token, as a fraction of
# max|logit|.  The two differ by design: prefill's conv runs in bf16 and
# keeps its silu output in f32, decode's conv runs in f32 and rounds it to
# bf16, in the reference as in the port (tests/test_torch_ssm_hybrid_encdec.py
# holds both under this gate at reduced width).  Set between the card's
# sound reading at 48 layers, 0.0259, and the planted fault's (each row
# decoding from the next row's state), 0.9931 (PERF.md §6, phase 10).
SSM_STEP_REL_TOL = 0.05
# The first decode step with the kernels vs their plain versions, set as
# phases 3 and 9 set theirs, between the largest sound reading and the
# smallest planted fault's (PERF.md §6, phase 10): zamba2-7b (13 FIER
# application points) reads 0.01448 sound, faults 0.04785 and 0.06808, so
# phase 9's 0.017 holds; whisper-small (10 FIER layers) reads 0 sound (the
# kernels' f32 differences vanish in the bf16 rounding of every layer's
# attention output) and its faults only 0.007103 and 0.00819 (the
# cross-attention carries the decoder), so its gate is 0.004.
PHASE10_LOGIT_REL_TOL = {"zamba2-7b": FAMILY_LOGIT_REL_TOL, "whisper-small": 0.004}


# (d) the three families on a (data x model) mesh with every shard on the
# card: MESH10_STEPS decode steps from phase 10's prefill cache placed by
# cache_shardings (KV slabs over batch x sequence, Mamba2 states and cross
# K/V over batch), teacher-forced with the one-device bundle's tokens.  The
# one-device steps run the same policy without the guard rails (sink 0,
# recent 0), which the sequence-sharded decode has not (the reference's
# neither).  zamba2-7b and whisper-small run in exact mode: every selection
# (kernels.check.ShardedSelections) must equal the plain top-k of the same
# scores on the joined side-car up to scores within 3ε of its τ, and K1's on
# the same inputs up to scores within 2δ + 3ε of K1's τ (ε: score_eps; δ: the
# largest gap between K1's score expression and the sharded decode's), and a
# planted selection fault (each sequence shard selecting from the next
# shard's scores) must read outside both bands.  The logits must
# lie within MESH10_LOGIT_REL_TOL of max|logit| of the one-device steps',
# set between the card's sound readings and the planted faults' (PERF.md
# §6): mamba2 0.02839 sound, fault 1.271 (not bit for bit on the
# card: cuBLAS's batched product for the state readout C·h gives a row
# other last bits at 2 rows than at 4, tools/probe_mamba_rows.py, and 48
# layers' bf16 roundings carry them as far as the recurrent step departs
# from its scan, so SSM_STEP_REL_TOL); zamba2 0.03148, fault 1.496 (the
# same readout in 81 Mamba2 layers, and the sharded attention's softmax
# weights rounded to bf16 where K2 keeps f32); whisper 0.007249, fault
# 0.05559 (the cross K/V of the other batch shard).
MESH10_SHAPE = (2, 2)
MESH10_STEPS = 4
MESH10_LOGIT_REL_TOL = {"mamba2-370m": SSM_STEP_REL_TOL, "zamba2-7b": SSM_STEP_REL_TOL,
                        "whisper-small": 0.02}


def mesh10_rotated(x):
    """``core.placement.row_blocks`` with each batch shard handed the next
    shard's pieces: the planted fault of (d)."""
    from repro_torch.core import placement

    blocks = placement.row_blocks(x)
    return [(rows, blocks[(i + 1) % len(blocks)][1]) for i, (rows, _) in enumerate(blocks)]


def mesh10_decode(torch, eng, cfg, params, tok0, cache, capacity):
    """(d): ``build_model(cfg, pol, DistConfig(mesh, seq_axes=("model",),
    batch_axes=("data",), mode="exact"))`` on a MESH10_SHAPE mesh with every
    shard on the card decodes MESH10_STEPS steps from a placed copy of
    ``cache`` (phase 10's prefill), teacher-forced with the one-device
    bundle's tokens from another copy: the gates of the comment above, the
    slab, state and cross pieces on distinct storages, the lengths equal,
    one planted fault (each batch shard stepping the next shard's state
    rows, or attending the next shard's cross K/V) beyond the gate and, in
    exact mode, one planted selection fault outside both selection bands.
    Returns what it measured, ms per step of both beside each other."""
    import dataclasses

    from repro_torch.core.placement import map_tree, place_tree
    from repro_torch.kernels.check import ShardedSelections
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import cache_batch_axes, cache_shardings
    from repro_torch.models import build_model, encdec, mamba2
    from repro_torch.models.attention import DistConfig

    t_start = time.perf_counter()
    kw = {"max_positions": capacity} if cfg.family == "encdec" else {}
    pol = eng.bundle.policy
    if pol is not None:
        pol = dataclasses.replace(pol, sink=0, recent=0)
    one = build_model(cfg, pol, device=DEVICE, **kw)
    mesh = make_mesh(MESH10_SHAPE, ("data", "model"), device=DEVICE)
    sharded = build_model(cfg, pol, DistConfig(mesh=mesh, seq_axes=("model",),
                                               batch_axes=("data",), mode="exact"),
                          device=DEVICE, **kw)
    sh = cache_shardings(cache, mesh, ("data",), ("model",),
                         cache_batch_axes(sharded.init_cache, capacity))
    placed = place_tree(cache, sh)
    pieces = []
    map_tree(lambda x: pieces.append(x) if hasattr(x, "pieces") else None, placed)
    storages = [p.untyped_storage().data_ptr() for x in pieces for p in x.pieces]
    if len(set(storages)) != len(storages):
        raise AssertionError(f"{cfg.name}: two placed cache pieces share a storage")
    sel = ShardedSelections(lambda q4, qk: 3 * score_eps(q4, qk), sync=lambda: sync(torch))
    calls = sel.calls

    def steps(bundle, c, tokens):
        lgs, fed, ms, tok = [], [], [], tok0
        for i in range(MESH10_STEPS):
            tok = tokens[i] if tokens is not None else tok
            fed.append(tok)
            sync(torch)
            t0, n0 = time.perf_counter(), len(calls)
            lg, c = bundle.decode_step(params, tok, c)
            sync(torch)
            checked = sum(r["seconds"] for r in calls[n0:])
            ms.append(1e3 * (time.perf_counter() - t0 - checked))
            lgs.append(lg[:, :cfg.vocab])
            tok = lg.argmax(-1).to(torch.int32)
        return lgs, fed, median(ms), c

    lg_one, tokens, ms_one, _ = steps(one, clone_cache(torch, cache), None)
    with sel:
        lg_sh, _, ms_sh, placed = steps(sharded, placed, tokens)
    lens = placed["length"].full().tolist()
    if lens != [n + MESH10_STEPS for n in cache["length"].tolist()]:
        raise AssertionError(f"{cfg.name}: the placed cache's lengths are {lens}")
    s1 = max(float(lg.abs().max()) for lg in lg_one)
    gap = max(float((a - b).abs().max()) for a, b in zip(lg_sh, lg_one))
    out = dict(mesh="x".join(map(str, MESH10_SHAPE)), steps=MESH10_STEPS, gap=gap,
               max_logit=s1, rel=gap / s1, ms_step_sharded=ms_sh, ms_step_one_device=ms_one)
    if cfg.family != "ssm":
        want = MESH10_STEPS * MESH10_SHAPE[0] * fier_layers(cfg, pol.skip_layers)
        if len(calls) != want:  # one call per FIER layer, step and batch shard
            raise AssertionError(f"{cfg.name} (d): {len(calls)} exact-mode FIER calls")
        out.update({f"index_{k}": v for k, v in sel.totals().items() if k != "seconds"})
        calls.clear()  # the planted selection fault: one step from a fresh placed copy
        sel.fault = True
        with sel:
            sharded.decode_step(params, tok0, place_tree(cache, sh))
        sync(torch)
        out.update({f"sel_fault_{k}": v for k, v in sel.totals().items()
                    if k in ("outside", "k1_outside")})
    del calls, placed
    # the planted fault: the first step from a fresh placed copy with each batch
    # shard's state rows or cross K/V taken from the next shard
    saved = mamba2.row_blocks, encdec.row_blocks
    mamba2.row_blocks = encdec.row_blocks = mesh10_rotated
    try:
        lg_f, _ = sharded.decode_step(params, tok0, place_tree(cache, sh))
        sync(torch)
    finally:
        mamba2.row_blocks, encdec.row_blocks = saved
    out["fault_gap"] = float((lg_f[:, :cfg.vocab] - lg_one[0]).abs().max())
    tol = MESH10_LOGIT_REL_TOL[cfg.name]
    log(f"  (d) on a {out['mesh']} mesh, {MESH10_STEPS} steps teacher-forced: max |Δlogit| vs "
        f"the one-device steps {gap:.4g} = {gap / s1:.4g} of max|logit| {s1:.4g} (gate {tol}); "
        + (f"index sets vs the plain top-k of the same scores: {out['index_diff_ref']} "
           f"positions differ ({out['index_selected']} selected), {out['index_outside']} "
           f"outside the "
           f"{out['index_near_ref']} within 3ε of τ; vs K1 on the same inputs: "
           f"{out['index_diff']} differ, {out['index_k1_outside']} outside the "
           f"{out['index_near']} of {out['index_valid']} valid positions within 2δ + 3ε of τ "
           f"(δ {out['index_delta']:.4g}, ε {out['index_eps'] / 3:.4g}); planted selection "
           f"fault: {out['sel_fault_outside']} / {out['sel_fault_k1_outside']} outside; "
           if "index_diff" in out else "")
        + f"planted fault (each batch shard on the next shard's "
        f"{'cross K/V' if cfg.family == 'encdec' else 'state rows'}): {out['fault_gap']:.4g} = "
        f"{out['fault_gap'] / s1:.4g}; ms/step sharded {ms_sh:.2f} vs one device {ms_one:.2f} "
        f"(median of {MESH10_STEPS}, the index check's seconds left out; the one-device steps "
        f"launch K1/K2); (d) took {time.perf_counter() - t_start:.1f} s")
    if not out["fault_gap"] > tol * s1:
        raise AssertionError(f"{cfg.name} (d): the gate does not see the planted fault: "
                             f"{out['fault_gap']:.4g} <= {tol} · {s1:.4g}")
    if not (all(bool(torch.isfinite(lg).all()) for lg in lg_sh) and gap <= tol * s1):
        raise AssertionError(f"{cfg.name} (d): sharded vs one-device logits {gap:.4g} > "
                             f"{tol} · {s1:.4g}")
    if out.get("index_outside") or out.get("index_k1_outside"):
        raise AssertionError(f"{cfg.name} (d): index sets differ beyond the near-τ band: {out}")
    if "index_diff" in out and not (out["sel_fault_outside"] and out["sel_fault_k1_outside"]):
        raise AssertionError(f"{cfg.name} (d): the selection check does not see the planted "
                             f"fault: {out}")
    return out


def ssm_step_check(torch, eng, params, batch, tok0, cache, vocab):
    """The first decode step of an attention-free model against a prefill of
    each prompt extended by the token decoded (the recurrent step against
    the chunked scan, both on the card), within SSM_STEP_REL_TOL·max|logit|;
    a planted fault (each row decoding from the next row's SSM state) must
    read above the gate.  Returns (gap, max|logit|, fault gap)."""
    _, lg1, _ = eng.decode(params, tok0, clone_cache(torch, cache))
    lengths = batch["lengths"]
    ext = batch["tokens"].clone()
    rows = torch.arange(ext.shape[0], device=ext.device)
    ext[rows, lengths.long()] = tok0.to(ext.dtype)
    lg_ext, c_ext = eng.prefill_batch(params, dict(batch, tokens=ext, lengths=lengths + 1))
    del c_ext
    bad = clone_cache(torch, cache)
    bad["layers"]["ssm"] = bad["layers"]["ssm"].roll(1, dims=1)
    _, lg_f, _ = eng.decode(params, tok0, bad)
    sync(torch)
    lg1, lg_ext, lg_f = (x[:, :vocab] for x in (lg1, lg_ext, lg_f))
    s1 = float(lg_ext.abs().max())
    gap = float((lg1 - lg_ext).abs().max())
    fault = float((lg_f - lg_ext).abs().max())
    top1 = int((lg1.argmax(-1) == lg_ext.argmax(-1)).sum())
    log(f"  first decode step vs a prefill of the prompts extended by its token (max |logit| "
        f"{s1:.4g}): max |Δlogit| {gap:.4g} = {gap / s1:.4g} of max|logit| (top-1 "
        f"{top1}/{lg1.shape[0]}; gate {SSM_STEP_REL_TOL}); planted fault, each row from the "
        f"next row's state: {fault:.4g} = {fault / s1:.4g}")
    if not fault > SSM_STEP_REL_TOL * s1:
        raise AssertionError(f"the step gate does not see the planted fault: {fault:.4g} <= "
                             f"{SSM_STEP_REL_TOL} · {s1:.4g}")
    if not (torch.isfinite(lg1).all() and gap <= SSM_STEP_REL_TOL * s1):
        raise AssertionError(f"decode step vs extended prefill: {gap:.4g} > "
                             f"{SSM_STEP_REL_TOL} · {s1:.4g}")
    return gap, s1, fault


def fier_layers(cfg, skip) -> int:
    """The FIER layers of ``cfg`` with ``skip`` dense skip layers: K1/K2
    launches per decode step (the hybrid's every application point of the
    shared block; an ssm none)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // max(cfg.attn_every, 1)
    return cfg.n_layers - skip


def phase10_drive(torch, arch, n_slots, capacity, prompts, max_new):
    """One config at full width and depth through ``Engine.build``'s
    default policy (fier / one_pass / slab / budget 1024 / skip 2), random
    weights from a seeded ``torch.Generator``, token arrays padded to the
    capacity (whisper's seeded frames through ``extras``).  mamba2: the step
    gate of ``ssm_step_check``, then no FIER kernel in ``generate``.  zamba2
    and whisper: the first decode step with the kernels vs their plain
    versions and two planted faults (``family_first_step``), K1/K2
    launched (FIER layers) × decode steps in ``generate`` and no other FIER
    kernel; zamba2 also gives the reference pipeline's prefill logits and,
    through a two_pass engine on the same cache, the one_pass first-step
    logits bit for bit.  Then timed and profiled decode steps.  Returns a
    dict of what it measured."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, serving_policy

    cfg = get_config(arch)
    base = peak_base(torch)
    kw = {"max_positions": capacity} if cfg.family == "encdec" else {}
    eng = Engine.build(cfg, n_slots=n_slots, capacity=capacity, device=DEVICE, **kw)
    pol = eng.bundle.policy
    if cfg.family != "ssm" and (pol.kind, pol.pipeline, pol.layout, pol.budget,
                                pol.skip_layers) != ("fier", "one_pass", "slab", BUDGET, SKIP):
        raise AssertionError(f"Engine.build's default policy is {pol}")
    n_fier = fier_layers(cfg, SKIP)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = eng.compute_params(eng.bundle.init(gen))
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (n_slots, capacity))).to(DEVICE)
    lengths = torch.tensor(prompts, dtype=torch.int32, device=DEVICE)
    extras = None
    if cfg.family == "encdec":
        extras = {"frames": torch.randn((n_slots, cfg.enc_ctx, cfg.d_model), generator=gen,
                                        device=DEVICE)}
    batch = {"tokens": toks, "lengths": lengths, **(extras or {})}
    out = dict(arch=arch, family=cfg.family, layers=cfg.n_layers, fier_layers=n_fier,
               d_head=cfg.d_head, kv_heads=cfg.n_kv_heads,
               rep=cfg.n_heads // cfg.n_kv_heads if cfg.n_kv_heads else 0)

    sync(torch)
    t0 = time.perf_counter()
    lg0, cache = eng.prefill_batch(params, batch)
    tok0 = torch.argmax(lg0, -1).to(torch.int32)
    sync(torch)
    out["ttft_ms"] = 1e3 * (time.perf_counter() - t0)
    if cache["length"].tolist() != list(prompts) or not torch.isfinite(lg0).all():
        raise AssertionError(f"{arch}: prefill lengths {cache['length'].tolist()} or logits wrong")
    if cfg.family == "ssm":
        out["step_gap"], out["max_logit"], out["fault_gap"] = ssm_step_check(
            torch, eng, params, batch, tok0, cache, cfg.vocab)
    else:
        if cfg.family == "hybrid":
            ref = Engine.build(cfg, n_slots=n_slots, capacity=capacity, device=DEVICE,
                               policy=serving_policy(budget=BUDGET, pipeline="reference"))
            lg_ref, cache_ref = ref.prefill_batch(params, batch)
            if not torch.equal(lg_ref, lg0):
                raise AssertionError(f"{arch}: prefill logits differ between one_pass and "
                                     f"reference")
            del ref, cache_ref, lg_ref
            log("  prefill logits identical to the reference pipeline")
        errs, gap, s1, _, _ = family_first_step(torch, eng, params, tok0, cache, cfg.vocab,
                                                tol=PHASE10_LOGIT_REL_TOL[arch])
        out.update(first_step_gap=gap, max_logit=s1, k1_tau_err=errs["k1_tau"],
                   k1_swaps=errs["k1_swaps"], k2_err=errs["k2"])
        if cfg.family == "hybrid":
            two = Engine.build(cfg, n_slots=n_slots, capacity=capacity, device=DEVICE,
                               policy=serving_policy(budget=BUDGET, pipeline="two_pass"))
            _, lg1, _ = eng.decode(params, tok0, clone_cache(torch, cache))
            _, lg2, _ = two.decode(params, tok0, clone_cache(torch, cache))
            sync(torch)
            if not torch.equal(lg1, lg2):
                raise AssertionError(f"{arch}: two_pass first-step logits differ from one_pass "
                                     f"(max {float((lg1 - lg2).abs().max()):.3g})")
            del two, lg1, lg2
            log("  two_pass first-step logits equal to one_pass bit for bit (group max)")
    out["mesh"] = mesh10_decode(torch, eng, cfg, params, tok0, cache, capacity)
    del cache

    reset_launch_counts()
    sync(torch)
    t0 = time.perf_counter()
    gen_toks, cache = eng.generate(params, toks, lengths, max_new, extras=extras,
                                   return_cache=True)
    sync(torch)
    t_gen = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(counts, SLAB_KERNELS if n_fier else (), n_fier * (max_new - 1))
    if not torch.equal(gen_toks[:, 0], tok0):
        raise AssertionError(f"{arch}: generate's first token differs from prefill's argmax")
    if not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: generated tokens out of range")
    out["launches"] = {k: counts[k] for k in SLAB_KERNELS}
    out["ms_step"], tok, cache = timed_steps(torch, eng, params, gen_toks[:, -1].clone(), cache,
                                             TIMED_STEPS)
    lens = cache["length"].tolist()
    want = [p + max_new - 1 + TIMED_STEPS for p in prompts]
    if lens != want:
        raise AssertionError(f"{arch}: cache lengths {lens}, expected {want}")
    log(f"  launches {out['launches']}: {n_fier} x {max_new - 1} decode steps; generate "
        f"{max_new} tokens {t_gen:.3f} s; TTFT (prefill + sample) {out['ttft_ms']:.1f} ms; "
        f"decode median {out['ms_step']:.2f} ms/step (unprofiled, {TIMED_STEPS} steps)")
    if DEVICE == "cuda":
        if arch in PHASE10_PROFILED:
            profile_decode(torch, eng, params, tok, cache, None)
        out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"  peak memory {out['peak_gib']:.2f} GiB")
    del eng, params, cache
    return out


def ssm_hybrid_encdec_path(torch):
    """Phase 10: mamba2-370m, zamba2-7b and whisper-small at full width and
    depth, each freed before the next."""
    import gc

    runs = {}
    for arch, n_slots, capacity, prompts, max_new in PHASE10_RUNS:
        log(f"  [{arch}] {n_slots} slots x {capacity}, prompts {prompts}, {max_new} tokens")
        runs[arch] = phase10_drive(torch, arch, n_slots, capacity, prompts, max_new)
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------ phase 11

# (a) the flash-attention backward: name -> (B, Sq, Sk, Hkv, rep, D, causal,
# key-padding mask).  olmo-1b's layer at the trainer's batch; a GQA shape
# with a padding mask, S no multiple of block_k (512) and three 512-row query
# blocks, the last one partial.
FLASH_SHAPES = {
    "olmo-1b layer (B 4, S 2048, 16 heads x 128, causal)": (4, 2048, 2048, 16, 1, 128, True, False),
    "GQA 4 x 4, S 1100, padding mask": (2, 1100, 1100, 4, 4, 128, True, True),
}
# dq/dk/dv (and out) of the Function vs autograd through the dense oracle
# ``attention_ref``, as a fraction of the oracle's max |.|, on bf16 inputs
# as training feeds it.  Both sum in f32 and round each result to bf16 (one
# step is 2^-8 = 0.0039 of an element); dk/dv are rounded once per 512-row
# query block before their f32 sum (the reference's design), so up to four
# roundings stack at S 2048: 0.01 leaves room for them and for f32 order,
# while a dropped softmax-backward diagonal moves dq by O(1).
FLASH_GRAD_REL_TOL = 0.01
# (b) olmo-1b at full width and depth: B x S from make_train_batch, steps,
# AdamW + cosine at this peak lr (warmup 2).  The first loss within 1.5 of
# ln(vocab) (a random tied head adds ~0.5), the last below the first.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PEAK_LR = 4, 2048, 8, 1e-3
# (c) checkpoint/restart: olmo-1b's width at this depth, steps, a checkpoint
# every RESTART_EVERY steps, one fault at RESTART_FAIL_AT (after the first).
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY, RESTART_FAIL_AT = 2, 6, 3, 4
# (d) the other families, full width, depth cut: arch -> (layers, B, S).
# zamba2-7b: 6 layers = one application of the shared block (attn_every 6);
# whisper-small: 2 encoder + 2 decoder layers, its 1500 frames, S 448 (its
# published decoder positions).
FAMILY_TRAIN = {
    "granite-moe-1b-a400m": (2, 4, 2048),
    "mamba2-370m": (2, 4, 2048),
    "zamba2-7b": (6, 2, 2048),
    "whisper-small": (2, 4, 448),
}
FAMILY_TRAIN_STEPS = 2
# (e) train, then serve (tests/test_system.py's recipe at d_head 64, which
# the CUDA kernels take): the model, the recipe, the serving budgets.
SERVE_MODEL = dict(n_layers=3, d_model=256, n_heads=4, n_kv_heads=4, d_head=64, d_ff=512,
                   vocab=256)
SERVE_TRAIN = dict(steps=150, peak_lr=2e-3, warmup=10, batch=8, seq=128, seed=11)
# At budget >= length, fed full's greedy tokens: max |Δlogit| between FIER
# through K1/K2 and full-KV, as a fraction of max |logit| over 16 steps; set
# between the sound reading, 0.002357 (full-KV rounds its softmax weights to
# bf16, K2 keeps them in f32), and the smaller planted K2 fault's, 0.0121
# (PERF.md §6, PR 20).
SERVE_LOGIT_REL_TOL = 0.006


def free(torch):
    import gc

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def peak_gib(torch, base) -> float:
    return (torch.cuda.max_memory_allocated() - base) / 2**30 if DEVICE == "cuda" else 0.0


def flash_backward_checks(torch):
    """(a): the Function's out, dq, dk, dv vs autograd through
    ``attention_ref`` on the same bf16 inputs (seeded ``torch.Generator``),
    with the gate FLASH_GRAD_REL_TOL, and a planted fault (the softmax
    backward's diagonal Dterm dropped) that must read above it.  Reports
    each path's time and peak memory."""
    from repro_torch.models import layers

    out = {}
    for name, (B, Sq, Sk, Hkv, rep, D, causal, padded) in FLASH_SHAPES.items():
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE).to(torch.bfloat16)
        q, k, v, dout = mk(B, Sq, Hkv * rep, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D), \
            mk(B, Sq, Hkv * rep, D)
        mask = None
        if padded:
            lens = torch.tensor([Sk, Sk - 77][:B], device=DEVICE)
            mask = torch.arange(Sk, device=DEVICE)[None] < lens[:, None]
        kw = dict(causal=causal, bias_mask=mask)

        def run(fn):
            args = [x.clone().requires_grad_() for x in (q, k, v)]
            free(torch)
            base = peak_base(torch)
            sync(torch)
            t0 = time.perf_counter()
            o = fn(*args, **kw)
            grads = torch.autograd.grad(o, args, dout)
            sync(torch)
            ms = 1e3 * (time.perf_counter() - t0)
            return (o.detach(),) + grads, ms, peak_gib(torch, base)

        ref, ref_ms, ref_gib = run(layers.attention_ref)
        run(layers.flash_attention)  # warm-up
        got, ms, gib = run(layers.flash_attention)
        orig = layers._flash_bwd_block
        layers._flash_bwd_block = lambda q_, k_, v_, o_, *rest: orig(q_, k_, v_,
                                                                     torch.zeros_like(o_), *rest)
        try:
            bad, _, _ = run(layers.flash_attention)
        finally:
            layers._flash_bwd_block = orig
        rel = lambda a, b: float((a.float() - b.float()).abs().max() / a.float().abs().max())
        errs = {n: rel(r, g) for n, r, g in zip(("out", "dq", "dk", "dv"), ref, got)}
        fault = max(rel(r, b) for r, b in zip(ref[1:], bad[1:]))
        log(f"  flash {name}: |Δ| / max vs attention_ref: "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f" (gate {FLASH_GRAD_REL_TOL}); planted fault (Dterm dropped) {fault:.3g}; "
            f"fwd+bwd {ms:.1f} ms, peak {gib:.2f} GiB; dense oracle {ref_ms:.1f} ms, "
            f"peak {ref_gib:.2f} GiB")
        if not all(torch.isfinite(x.float()).all() for x in got):
            raise AssertionError(f"flash {name}: non-finite output or gradient")
        if max(errs.values()) > FLASH_GRAD_REL_TOL:
            raise AssertionError(f"flash {name}: {errs} above {FLASH_GRAD_REL_TOL}")
        if not fault > FLASH_GRAD_REL_TOL:
            raise AssertionError(f"flash {name}: the gate does not see the planted fault "
                                 f"({fault:.3g})")
        out[name] = dict(errs, fault=fault, ms=ms, peak_gib=gib, oracle_ms=ref_ms,
                         oracle_peak_gib=ref_gib)
    return out


def train_run(torch, cfg, hp, shape, steps, *, seed=0, state=None, step_fn=None):
    """``steps`` steps of ``make_train_step`` from a seeded init (or
    ``state``): (state, per-step metrics as floats, per-step host ms)."""
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import build_model

    bundle = build_model(cfg, device=DEVICE, max_positions=shape.seq_len
                         if cfg.family == "encdec" else None)
    if state is None:
        state = init_train_state(bundle, torch.Generator(device=DEVICE).manual_seed(seed), hp)
    step = step_fn or make_train_step(bundle, hp)
    metrics, ms = [], []
    for s in range(steps):
        batch = make_train_batch(cfg, shape, s, seed=seed, device=DEVICE)
        sync(torch)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        sync(torch)
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append(m)
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{cfg.name} step {s}: loss {m['loss']}, grad norm "
                                 f"{m['grad_norm']}")
    return state, metrics, ms


def profile_train_step(torch, step_fn, state, batch):
    """One more train step under torch.profiler (information, no gate): its
    wall time, device busy share, launches and the ten largest kernel rows
    (kernel rows only, as ``profile_decode`` sums them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        sync(torch)
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and dev(e) > 0), key=dev, reverse=True)
    if not events:
        log("  profiled train step: the profiler reported no device kernels")
        return None
    busy_us = sum(dev(e) for e in events)
    log(f"  profiled train step: wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / wall_us:.1f}% busy), {sum(e.count for e in events)} kernel launches")
    for e in events[:10]:
        log(f"    {dev(e) / 1e3:8.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                launches=sum(e.count for e in events))


def olmo_full_train(torch):
    """(b): olmo-1b at full width and depth, remat on, TRAIN_BATCH x
    TRAIN_SEQ, AdamW + cosine, TRAIN_STEPS steps (then one profiled step,
    information only)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.launch.steps import TrainHParams, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.tree import leaves

    cfg = get_config("olmo-1b")
    hp = TrainHParams(peak_lr=TRAIN_PEAK_LR, warmup=2, total_steps=TRAIN_STEPS)
    shape = ShapeConfig("p11", TRAIN_SEQ, TRAIN_BATCH, "train")
    step_fn = make_train_step(build_model(cfg, device=DEVICE), hp)
    free(torch)
    base = peak_base(torch)
    state, ms_, ms = train_run(torch, cfg, hp, shape, TRAIN_STEPS, step_fn=step_fn)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    gib = peak_gib(torch, base)
    prof = None
    if DEVICE == "cuda":
        prof = profile_train_step(torch, step_fn, state,
                                  make_train_batch(cfg, shape, TRAIN_STEPS, device=DEVICE))
    del state
    losses = [m["loss"] for m in ms_]
    first, last = losses[0], losses[-1]
    med = median(ms[1:]) if len(ms) > 1 else ms[0]
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    log(f"  olmo-1b ({cfg.n_layers} layers, {n_params / 1e9:.3f} B params), B {TRAIN_BATCH} x "
        f"S {TRAIN_SEQ}, peak lr {TRAIN_PEAK_LR}: losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; grad norms " + " ".join(f"{m['grad_norm']:.3f}" for m in ms_)
        + f"; ln(vocab) {math.log(cfg.vocab):.4f}; median {med:.1f} ms/step (steps 2-"
        f"{TRAIN_STEPS}), {tok_s:.0f} tokens/s, first step {ms[0]:.1f} ms; peak {gib:.2f} GiB")
    if abs(first - math.log(cfg.vocab)) > 1.5:
        raise AssertionError(f"olmo-1b first loss {first} not within 1.5 of ln(vocab)")
    if not last < first:
        raise AssertionError(f"olmo-1b loss did not fall: {first} -> {last}")
    return dict(losses=losses, grad_norms=[m["grad_norm"] for m in ms_], ms_step=med,
                tokens_per_s=tok_s, peak_gib=gib, params=n_params, profile=prof)


def restart_check(torch):
    """(c): olmo-1b's width at RESTART_LAYERS layers under
    ``torch.use_deterministic_algorithms(True)`` (CUBLAS_WORKSPACE_CONFIG is
    set before CUDA starts): RESTART_STEPS steps uninterrupted, then the
    same through ``run_with_recovery`` with a ``FaultInjector`` failing once
    at RESTART_FAIL_AT, after the checkpoint of step RESTART_EVERY.  The
    final states must be equal bit for bit."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.launch.steps import TrainHParams, init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.tree import leaves
    from repro_torch.runtime import FaultInjector, run_with_recovery

    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=RESTART_LAYERS)
    hp = TrainHParams(peak_lr=TRAIN_PEAK_LR, warmup=1, total_steps=RESTART_STEPS)
    shape = ShapeConfig("p11c", TRAIN_SEQ, TRAIN_BATCH, "train")
    bundle = build_model(cfg, device=DEVICE)
    step_fn = make_train_step(bundle, hp)

    def one_step(st, s):
        return step_fn(st, make_train_batch(cfg, shape, s, seed=0, device=DEVICE))[0]

    torch.use_deterministic_algorithms(True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="p11_ckpt_", dir=os.path.join(HERE, "build"))
    try:
        init = init_train_state(bundle, torch.Generator(device=DEVICE).manual_seed(0), hp)
        t0 = time.perf_counter()
        ref = init
        for s in range(RESTART_STEPS):
            ref = one_step(ref, s)
        sync(torch)
        t_ref = time.perf_counter() - t0
        injector = FaultInjector([RESTART_FAIL_AT])

        def faulty(st, s):
            injector.maybe_fail(s)
            return one_step(st, s)

        t0 = time.perf_counter()
        out, stats = run_with_recovery(faulty, init, RESTART_STEPS,
                                       CheckpointManager(ckdir, keep_n=1),
                                       ckpt_every=RESTART_EVERY, state_like=init)
        sync(torch)
        t_rec = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckdir, ignore_errors=True)
    diff = sum(int(not torch.equal(a, b)) for a, b in zip(leaves(ref), leaves(out)))
    n = len(leaves(ref))
    log(f"  restart: olmo-1b width, {RESTART_LAYERS} layers, {RESTART_STEPS} steps, fault at "
        f"{RESTART_FAIL_AT}: {stats}; {n - diff}/{n} state leaves equal bit for bit to the "
        f"uninterrupted run; uninterrupted {t_ref:.1f} s, with recovery {t_rec:.1f} s")
    if stats["restarts"] != 1 or stats["resumed_from"] != [RESTART_EVERY] or diff:
        raise AssertionError(f"resume not bit-exact: {stats}, {diff} leaves differ")
    return dict(stats, leaves=n, t_ref_s=t_ref, t_recovery_s=t_rec)


def family_train(torch):
    """(d): each family at full width, depth cut (FAMILY_TRAIN), 2 steps,
    each model freed before the next."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import TrainHParams

    out = {}
    for arch, (layers, B, S) in FAMILY_TRAIN.items():
        cfg = get_config(arch)
        kw = dict(n_layers=layers) if cfg.family != "encdec" else dict(n_layers=layers,
                                                                       n_enc_layers=layers)
        cfg = dataclasses.replace(cfg, **kw)
        free(torch)
        base = peak_base(torch)
        hp = TrainHParams(peak_lr=TRAIN_PEAK_LR, warmup=1, total_steps=FAMILY_TRAIN_STEPS)
        state, ms_, ms = train_run(torch, cfg, hp, ShapeConfig("p11d", S, B, "train"),
                                   FAMILY_TRAIN_STEPS)
        del state
        gib = peak_gib(torch, base)
        out[arch] = dict(layers=layers, batch=B, seq=S, losses=[m["loss"] for m in ms_],
                         grad_norms=[m["grad_norm"] for m in ms_],
                         moe_aux=[m["moe_aux"] for m in ms_], ms_steps=ms, peak_gib=gib)
        log(f"  {arch} ({layers} layers{' + ' + str(layers) + ' encoder' if 'n_enc_layers' in kw else ''}"
            f", B {B} x S {S}): losses " + " ".join(f"{m['loss']:.4f}" for m in ms_)
            + "; grad norms " + " ".join(f"{m['grad_norm']:.3f}" for m in ms_)
            + "; moe aux " + " ".join(f"{m['moe_aux']:.4f}" for m in ms_)
            + "; ms/step " + " ".join(f"{x:.1f}" for x in ms) + f"; peak {gib:.2f} GiB")
    free(torch)
    return out


def _greedy(torch, bundle, params, prompt, n=16, forced=None):
    """(greedy tokens [B, n], the logits [B, n, Vp] each was taken from).
    With ``forced`` [B, n] every decode step is fed forced's token in place
    of its own argmax (teacher forcing), so two runs see the same inputs."""
    B, S = prompt.shape
    lengths = torch.full((B,), S, dtype=torch.int32, device=DEVICE)
    logits, cache = bundle.prefill(params, {"tokens": prompt, "lengths": lengths},
                                   capacity=S + n + 8)
    toks, lgs = [], []
    for i in range(n):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        lgs.append(logits)
        logits, cache = bundle.decode_step(params, tok if forced is None else forced[:, i],
                                           cache)
    return torch.stack(toks, 1), torch.stack(lgs, 1)


def _first_split(torch, a, b):
    """Where two greedy runs first part: (row, step, the first run's top-2
    logit gap there, max |Δlogit| there), or None.  Up to that step both
    runs saw the same tokens, so the logits differ by the numerics alone."""
    (ta, la), (tb, lb) = a, b
    diff = (ta != tb).to(torch.int64)
    if not bool(diff.any()):
        return None
    first = torch.where(diff.any(1), diff.argmax(1), torch.full_like(diff[:, 0], ta.shape[1]))
    r = int(first.argmin())
    t = int(first[r])
    top2 = la[r, t].topk(2).values
    return r, t, float(top2[0] - top2[1]), float((la[r, t] - lb[r, t]).abs().max())


def _teacher_forced_nll(torch, bundle, params, toks):
    lengths = torch.full((toks.shape[0],), 128, dtype=torch.int32, device=DEVICE)
    logits, cache = bundle.prefill(params, {"tokens": toks[:, :128], "lengths": lengths},
                                   capacity=160)
    tot = 0.0
    for t in range(24):
        gold = toks[:, 128 + t]
        lp = torch.log_softmax(logits, -1)
        tot += float(-lp.gather(1, gold[:, None].to(torch.int64)).mean())
        logits, cache = bundle.decode_step(params, gold, cache)
    return tot / 24


def _dense_attend(torch, q, K, V, valid, *, f32_weights):
    """Decode attention of q [B, Hkv, rep, D] over the rows of K, V
    [B, S, Hkv, D] that ``valid`` [B, Hkv or 1, S] marks: f32 scores and
    softmax, the weights rounded to V's dtype before they multiply V (as
    the port's and the reference's full-KV decode does) or kept in f32 (as
    K2 keeps them)."""
    D = q.shape[-1]
    s = torch.einsum("bhrd,bshd->bhrs", q.to(K.dtype).float(), K.float()) * D ** -0.5
    p = torch.softmax(s.masked_fill(~valid[:, :, None, :], -1e30), -1)
    if not f32_weights:
        p = p.to(V.dtype).float()
    return torch.einsum("bhrs,bshd->bhrd", p, V.float())


def train_then_serve(torch):
    """(e): tests/test_system.py's recipe on the card at d_head 64: train
    SERVE_MODEL (SERVE_TRAIN) through ``make_train_step``, then serve it
    greedily through full, FIER, quest and slm under that test's gates.

    At budget >= length (112) FIER through the kernels (one_pass: K1/K2)
    attends every valid token, so it is full-KV attention with the softmax
    weights kept in f32, where full-KV rounds them to bf16 before they
    multiply V.  Its gates: K1 selects every valid token at every call; at
    every call K2's output lies within K2_REL_TOL of full-KV attention with
    f32 weights on the same tensors (its gap to bf16 weights reported);
    fed full's greedy tokens (teacher forcing, 16 steps), its logits lie
    within SERVE_LOGIT_REL_TOL · max|logit| of full-KV's at every step, and
    two planted K2 faults (every index one token on, as phase 3; the newest
    token dropped) read above that.  The witness, full-KV with f32 weights
    at the FIER layers (the reference pipeline at budget 112 with
    ``sparse_attention``'s weights kept in f32), is fed the same tokens and
    its gaps to both are reported; free-running, K1/K2 must give the
    witness's greedy tokens exactly.  The reference pipeline at budget 112
    (as tests/test_system.py builds it: the same numerics as full-KV) must
    give full's greedy tokens exactly.  K1/K2's free-running agreement with
    full is reported, not gated: after the first near-tie the two runs see
    different tokens.  The budget-24 agreements and the NLL gap
    run through the kernels.  K1 = K2 = (layers − skip) × the kernel path's
    decode steps."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import retrieval
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.data.pipeline import lm_tokens
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.launch.steps import TrainHParams
    from repro_torch.models import build_model

    cfg = dataclasses.replace(reduced_config("olmo-1b"), **SERVE_MODEL)
    tr = SERVE_TRAIN
    hp = TrainHParams(peak_lr=tr["peak_lr"], warmup=tr["warmup"], total_steps=tr["steps"])
    t0 = time.perf_counter()
    state, ms_, ms = train_run(torch, cfg, hp, ShapeConfig("sys", tr["seq"], tr["batch"],
                                                           "train"), tr["steps"],
                               seed=tr["seed"])
    t_train = time.perf_counter() - t0
    params = state["params"]
    losses = [m["loss"] for m in ms_]
    learned = losses[-1] < 0.7 * losses[0]

    skip = 1
    fier = lambda budget, pipeline="one_pass": PolicyConfig(
        kind="fier", budget=budget, group=8, skip_layers=skip, pipeline=pipeline)
    bundle = lambda pol: build_model(cfg, pol, device=DEVICE)
    kernel_retrieve, kernel_attend = ops.fier_retrieve, ops.fier_attend_selected
    sparse_attention = retrieval.sparse_attention
    uncovered, k2_gap = [], {"f32": 0.0, "bf16": 0.0, "calls": 0}

    def covering_retrieve(q, codes, scale, zero, lengths, budget, **kw):
        """K1, and whether its selection holds every token below the length."""
        idx, tau, m = kernel_retrieve(q, codes, scale, zero, lengths, budget, **kw)
        S = codes.shape[1] * 8
        mark = torch.zeros((*idx.shape[:2], S + 1), dtype=torch.bool, device=idx.device)
        mark.scatter_(2, idx.clamp(0, S).to(torch.int64), True)
        need = torch.arange(S, device=idx.device)[None, None] < lengths[:, None, None]
        uncovered.append(int((need & ~mark[..., :S]).sum()))
        return idx, tau, m

    def witnessed_attend(q, K, V, idx, lengths=None, **kw):
        """K2, and its gaps to full-KV attention with f32 and bf16 weights."""
        out = kernel_attend(q, K, V, idx, lengths, **kw).float()
        valid = torch.arange(K.shape[1], device=K.device)[None, None] < lengths[:, None, None]
        f32w = _dense_attend(torch, q, K, V, valid, f32_weights=True)
        bf16w = _dense_attend(torch, q, K, V, valid, f32_weights=False)
        top = float(f32w.abs().max())
        k2_gap["f32"] = max(k2_gap["f32"], float((out - f32w).abs().max()) / top)
        k2_gap["bf16"] = max(k2_gap["bf16"], float((out - bf16w).abs().max()) / top)
        k2_gap["calls"] += 1
        return out

    def f32_weights_attention(q, Ksel, Vsel, idx, length=None):
        """``retrieval.sparse_attention`` with the softmax weights kept in f32."""
        B, Hq, D = q.shape
        valid = idx < length[:, None, None] if length is not None else torch.ones_like(
            idx, dtype=torch.bool)
        out = _dense_attend(torch, q.reshape(B, Ksel.shape[2], -1, D), Ksel, Vsel, valid,
                            f32_weights=True)
        return out.reshape(B, Hq, D).to(q.dtype)

    def with_kernels(retrieve, attend, fn):
        ops.fier_retrieve, ops.fier_attend_selected = retrieve, attend
        try:
            return fn()
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = kernel_retrieve, kernel_attend

    reset_launch_counts()
    with torch.no_grad():
        prompt = lm_tokens(tr["seed"], 999, 4, 96, cfg.vocab)[:, :96].to(DEVICE)
        full = _greedy(torch, bundle(PolicyConfig(kind="full")), params, prompt)
        forced = full[0]  # full's own run was fed these tokens: full[1] is its forced run
        agree = lambda a, b: float((a[0] == b[0]).float().mean())
        exact = agree(full, _greedy(torch, bundle(fier(112, "reference")), params, prompt))
        run_112, forced_112 = with_kernels(covering_retrieve, witnessed_attend, lambda: (
            _greedy(torch, bundle(fier(112)), params, prompt),
            _greedy(torch, bundle(fier(112)), params, prompt, forced=forced)))
        kernels_112, split = agree(full, run_112), _first_split(torch, full, run_112)
        agree_pol = lambda pol: agree(full, _greedy(torch, bundle(pol), params, prompt))
        a_fier = agree_pol(fier(24))
        a_quest = agree_pol(PolicyConfig(kind="quest", budget=24, page=8, skip_layers=skip))
        a_slm = agree_pol(PolicyConfig(kind="slm", budget=24, skip_layers=skip))
        toks = lm_tokens(tr["seed"], 500, 4, 160, cfg.vocab).to(DEVICE)
        nll = {"full": _teacher_forced_nll(torch, bundle(None), params, toks),
               "fier": _teacher_forced_nll(torch, bundle(fier(24)), params, toks),
               "slm": _teacher_forced_nll(torch, bundle(PolicyConfig(
                   kind="slm", budget=24, skip_layers=skip)), params, toks)}
        counts = launch_counts()
        # after the count: the witness (no kernel) and the planted K2 faults
        retrieval.sparse_attention = f32_weights_attention
        try:
            witness = _greedy(torch, bundle(fier(112, "reference")), params, prompt)
            witness_forced = _greedy(torch, bundle(fier(112, "reference")), params, prompt,
                                     forced=forced)
        finally:
            retrieval.sparse_attention = sparse_attention

        def shifted(q, K, V, idx, lengths=None, **kw):
            return kernel_attend(q, K, V, (idx + 1) % K.shape[1], lengths, **kw)

        def newest_dropped(q, K, V, idx, lengths=None, **kw):
            newest = (lengths - 1).to(idx.dtype)[:, None, None]
            return kernel_attend(q, K, V, torch.where(idx == newest, newest + 1, idx),
                                 lengths, **kw)

        faults = {name: with_kernels(kernel_retrieve, attend, lambda: _greedy(
            torch, bundle(fier(112)), params, prompt, forced=forced))[1]
            for name, attend in (("K2 fed idx+1", shifted),
                                 ("K2 without the newest token", newest_dropped))}
    V = cfg.vocab
    top = float(full[1][..., :V].abs().max())
    gap = lambda a, b: float((a[..., :V] - b[..., :V]).abs().max()) / top
    tf_full, tf_witness = gap(forced_112[1], full[1]), gap(forced_112[1], witness_forced[1])
    tf_witness_full = gap(witness_forced[1], full[1])
    fault_gaps = {name: gap(lg, full[1]) for name, lg in faults.items()}
    fier_steps = 16 + 16 + 16 + 24  # K1/K2 at budget 112 free and forced, at 24, NLL
    bound = 0.5 * max(nll["slm"] - nll["full"], 1e-9) + 0.05
    log(f"  train-then-serve ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads x "
        f"{cfg.d_head}, vocab {V}): {tr['steps']} steps in {t_train:.1f} s (median "
        f"{median(ms):.1f} ms/step), loss {losses[0]:.4f} -> {losses[-1]:.4f} (gate: below "
        f"0.7 x first)")
    log(f"  budget 112 (>= length): reference pipeline's greedy agreement with full "
        f"{exact:.4f} (gate 1); through K1/K2: K1 left {sum(uncovered)} valid tokens "
        f"unselected over {len(uncovered)} calls (gate 0); K2 vs full-KV attention over "
        f"{k2_gap['calls']} calls, max |Δout| / max|out|: f32 weights {k2_gap['f32']:.4g} "
        f"(gate {K2_REL_TOL}), bf16 weights {k2_gap['bf16']:.4g} (reported)")
    log(f"  budget 112, fed full's greedy tokens, max |Δlogit| / max|logit| ({top:.4g}) over "
        f"16 steps: K1/K2 vs full {tf_full:.4g} (gate {SERVE_LOGIT_REL_TOL}); planted faults "
        + ", ".join(f"{n} {g:.4g}" for n, g in fault_gaps.items())
        + f" (gate: above it); witness (full-KV, f32 weights at the FIER layers): K1/K2 vs "
        f"witness {tf_witness:.4g}, witness vs full {tf_witness_full:.4g} (reported)")
    a_witness = agree(witness, run_112)
    log(f"  budget 112 free-running greedy agreement: K1/K2 with the witness {a_witness:.4f} "
        f"(gate 1); reported: K1/K2 with full {kernels_112:.4f} (first parting (row, step, "
        f"full's top-2 gap, |Δlogit|) {split}), witness with full {agree(full, witness):.4f}")
    log(f"  budget 24 through K1/K2: FIER {a_fier:.4f}, quest {a_quest:.4f}, slm {a_slm:.4f} "
        f"(gates: FIER above both, >= 0.4); teacher-forced NLL full {nll['full']:.4f}, FIER "
        f"{nll['fier']:.4f}, slm {nll['slm']:.4f} (gate: FIER gap {nll['fier'] - nll['full']:.4f}"
        f" < {bound:.4f}); launches {counts}")
    check_launches(counts, SLAB_KERNELS, (cfg.n_layers - skip) * fier_steps)
    n112 = (cfg.n_layers - skip) * 32
    failed = [name for name, ok in (
        ("training learns", learned), ("budget >= length is exact (reference)", exact == 1.0),
        ("K1 keeps every valid token at budget >= length",
         len(uncovered) == n112 and sum(uncovered) == 0),
        ("K2 is full-KV attention with f32 weights at budget >= length",
         k2_gap["calls"] == n112 and k2_gap["f32"] <= K2_REL_TOL),
        ("K1/K2 logits at budget >= length near full's", tf_full <= SERVE_LOGIT_REL_TOL),
        ("K1/K2 at budget >= length gives the f32-weight witness's tokens", a_witness == 1.0),
        ("the logit gate sees the planted faults",
         min(fault_gaps.values()) > SERVE_LOGIT_REL_TOL),
        ("FIER above quest", a_fier > a_quest), ("FIER above slm", a_fier > a_slm),
        ("FIER >= 0.4", a_fier >= 0.4), ("NLL gap", nll["fier"] - nll["full"] < bound)) if not ok]
    if failed:
        raise AssertionError(f"train-then-serve gates failed: {failed}")
    return dict(losses=[losses[0], losses[-1]], exact=exact, kernels_112=kernels_112,
                witness_112=a_witness, split_112=split, k2_gap=k2_gap, tf_full=tf_full, tf_witness=tf_witness,
                tf_witness_full=tf_witness_full, faults=fault_gaps, fier=a_fier,
                quest=a_quest, slm=a_slm, nll=nll,
                launches={k: counts[k] for k in SLAB_KERNELS}, train_s=t_train)


def training_path(torch):
    """Phase 11: (a) flash backward, (b) olmo-1b full, (c) restart, (d) the
    other families, (e) train then serve through K1/K2."""
    t0 = time.perf_counter()
    out = {}
    log("  (a) flash-attention backward vs the dense oracle")
    out["flash"] = flash_backward_checks(torch)
    free(torch)
    log("  (b) olmo-1b at full width and depth")
    out["olmo"] = olmo_full_train(torch)
    free(torch)
    log("  (c) checkpoint/restart, deterministic algorithms")
    out["restart"] = restart_check(torch)
    free(torch)
    log("  (d) the other families, depth cut")
    out["families"] = family_train(torch)
    log("  (e) train, then serve through the kernels")
    out["serve"] = train_then_serve(torch)
    free(torch)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 11 wall time {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ main

# ------------------------------------------------------------ phase 12

# meshes of phase 12, every shard on the one card: name, shape, axes
SHARD_MESHES = (("tp2", (2,), ("model",)), ("dp2", (2,), ("data",)),
                ("tp2xdp2", (2, 2), ("data", "model")))
SHARD_STEPS = 8         # gated decode steps per engine in (a), cut from 32 and 16 for the time limit
SHARD_TIMED_STEPS = 2   # then timed ones (median), outside the counted window (cut from 4)
GRANITE_SHARD_LAYERS = 6  # (b): granite-moe-1b-a400m's depth cut (4 FIER layers)
LONG_SHARDS = 4
LONG_SEQ = (1, 16, 1, 128, 524288, 4096)  # B, Hkv, rep, D, S, budget: long_500k
LONG_FULL_REL_TOL = 1e-2  # full_decode_sharded vs dense attention, × max|out|
# meshes held to the one-device engine bit for bit; the others to the gates
# below.  The FIER layers are exact on every mesh (each shard's K3/K4 take the
# unsharded split), but the dense skip layers' batched cuBLAS GEMMs may pick
# another kernel at a shard's batch count: tp2 x dp2's 16 (b, h) rows do
# (PERF.md §6), and so do the stream's 4-slot shards in (c)
SHARD_BITWISE = ("tp2", "dp2")
# A sharded engine against the one-device engine, × max|logit|.  The first
# decode step's gate and the band over every teacher-forced step (the
# rounding reaches the cache and drifts) each sit between the sound reading
# and the smallest planted fault's (as phase 3's).  The faults are read at
# every one of the SHARD_STEPS steps; one present throughout is seen where
# its largest step passes the band.  Readings on one "NVIDIA H100 80GB HBM3,
# 700.00 W" over 32 steps (PERF.md §6; the faults' first / least / largest
# step):
SHARD_LOGIT_REL_TOL = 0.017   # tp2 x dp2: sound 0.01255, faults 0.0226 / 0.0886 / 1.158
SHARD_DRIFT_REL_TOL = 0.02    # sound: tp2 x dp2 0.01429, the dp2 stream 0.01431; faults
#   K3 on the next kv head 0.0226 / 0.0189 / 0.0265, K4 idx+1 0.0886 / 0.0677 / 0.0975,
#   a DP shard on another's rows 1.158 / 0.989 / 1.258 (in (c) 1.451)


def same(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a, b)


def sharded_drive(torch, cfg, params, mesh, prompts, steps, *, seed=4, forced=None,
                  check=True, faults=False, timed=SHARD_TIMED_STEPS, fault_fn=None,
                  fault_steps=None, profile=True):
    """Phase 4's four prompts inserted one by one into a paged engine (bs 32,
    the default pool) on ``mesh`` (None: one device), then ``steps`` greedy
    decode steps with ``advance_slot`` for every slot first.  With
    ``forced`` [B, steps + 1] (the one-device run's tokens) each step is fed
    those tokens instead of its own (teacher forcing), so every step's
    logits compare with the one-device run's on the same history.  The
    first step also runs K3/K4's plain versions on each shard's own tensors
    (``checked_kernels``); with ``faults`` every step (the first
    ``fault_steps`` when given) is first run again from copies of the cache
    with the planted faults of ``fault_fn`` (``sharded_faults`` by
    default).
    Counts the launches over the inserts and the steps (the faults' not),
    audits, then times ``timed`` more steps and (``profile``) profiles one.  Returns the
    prefill logits, every step's logits (and each fault's), the tokens, the
    counts and the readings."""
    import numpy as np

    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.serving import Engine

    rng = np.random.default_rng(seed)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab, (1, n))).to(DEVICE) for n in prompts]
    eng = Engine.build(cfg, n_slots=len(prompts), capacity=CAPACITY, layout="paged",
                       mesh=mesh, device=DEVICE)
    pol = eng.bundle.policy
    if (pol.pipeline, pol.budget, pol.block_size) != ("one_pass", BUDGET, BLOCK_SIZE):
        raise AssertionError(f"the paged engine's policy is {pol}")
    cache = eng.new_cache()
    errs = new_errs()
    reset_launch_counts()
    tok = torch.zeros(len(prompts), dtype=torch.int32, device=DEVICE)
    pre = []
    for slot, t in enumerate(toks):
        lg, cache = eng.insert(params, cache, t, t.shape[1], slot)
        pre.append(lg.clone())
        tok[slot] = torch.argmax(lg, -1)[0]
    out, logits = [tok.clone()], []

    def advance(cache):
        for slot in range(len(prompts)):
            ok, cache = eng.advance_slot(cache, slot)
            if not ok:
                raise AssertionError("the default pool ran dry")
        return cache

    fault_lg, fault_launches = {}, {}
    for i in range(steps):
        cache = advance(cache)
        if faults and (fault_steps is None or i < fault_steps):
            before = launch_counts()  # the planted faults' launches are not the path's
            for k, lg in (fault_fn or sharded_faults)(torch, eng, params, tok, cache).items():
                fault_lg.setdefault(k, []).append(lg)
            for k, n in launch_counts().items():
                fault_launches[k] = fault_launches.get(k, 0) + n - before.get(k, 0)
        if i == 0 and check:
            ops.fier_retrieve, ops.fier_attend_selected = checked_kernels(
                torch, errs, keep_plain=False)
        try:
            tok, lg, cache = eng.decode(params, tok, cache)
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
        logits.append(lg.clone())
        out.append(tok.clone())
        if forced is not None:
            tok = forced[:, i + 1].clone()
    sync(torch)
    counts = {k: n - fault_launches.get(k, 0) for k, n in launch_counts().items()}
    eng.audit()
    ms = []
    for _ in range(timed):
        sync(torch)
        t0 = time.perf_counter()
        cache = advance(cache)
        tok, _, cache = eng.decode(params, tok, cache)
        sync(torch)
        ms.append(1e3 * (time.perf_counter() - t0))
    if DEVICE == "cuda" and timed and profile:
        profile_decode(torch, eng, params, tok, cache, None)
    return dict(eng=eng, cache=cache, pre=torch.cat(pre), logits=torch.stack(logits),
                toks=torch.stack(out, 1), counts=counts, errs=errs,
                faults={k: torch.stack(v) for k, v in fault_lg.items()},
                ms=median(ms) if ms else None)


def sharded_faults(torch, eng, params, tok, cache):
    """One decode step of a sharded engine from copies of ``cache``
    with three planted faults: K4 fed idx+1 on every shard; K3's selection
    of the last FIER layer handed to the neighbouring kv head on every
    shard; and (DP meshes) DP shard 1 localizing its block table as shard 0
    would, so it reads another shard's rows.  Returns each fault's logits."""
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.kvcache import sharded as kvsharded

    spec = eng.shard
    n_calls = [0]
    last_layer = (eng.bundle.cfg.n_layers - SKIP - 1) * spec.n_tp * spec.n_dp

    def shifted_attend(q, K, V, idx, lengths=None, **k):
        S = k["block_table"].shape[1] * K.shape[1]  # the logical row of a pool
        return sa.fier_attend_selected(q, K, V, (idx + 1) % S, lengths, **k)

    def rolled_retrieve(*a, **k):
        idx, tau, m = fr.fier_retrieve(*a, **k)
        n_calls[0] += 1
        if n_calls[0] > last_layer:
            idx = torch.roll(idx, 1, dims=1)
        return idx, tau, m

    localize = kvsharded.localize_block_table

    def foreign(block_table, d, n_local, n_dp):
        return localize(block_table, max(d - 1, 0), n_local, n_dp)

    out = {}
    runs = [("K4 fed idx+1", dict(attend=shifted_attend)),
            ("K3's last-layer selection on the next kv head", dict(retrieve=rolled_retrieve))]
    if spec.n_dp > 1:
        runs.append(("DP shard 1 reading shard 0's rows", dict(localize=foreign)))
    for name, kw in runs:
        n_calls[0] = 0
        ops.fier_retrieve = kw.get("retrieve", fr.fier_retrieve)
        ops.fier_attend_selected = kw.get("attend", sa.fier_attend_selected)
        kvsharded.localize_block_table = kw.get("localize", localize)
        try:
            _, lg, _ = eng.decode(params, tok, clone_cache(torch, cache))
            sync(torch)
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
            kvsharded.localize_block_table = localize
        out[name] = lg.clone()
    return out


def dense_rows_equal(torch, B, shards_b, shards_h, S=CAPACITY, seed=14):
    """Whether dense decode attention (``full_attention_decode``, the skip
    layers' path) over one shard's rows equals the same rows of the whole
    call bit for bit, at B slots × 16 heads × d_head 128 split into
    ``shards_b`` slot ranges × ``shards_h`` head ranges (cuBLAS picks its
    GEMM by the batch count).  Returns (equal, max |Δ|)."""
    from repro_torch.core.retrieval import full_attention_decode

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    H, D = 16, 128
    K = torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    V = torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    q = torch.randn((B, H, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    length = torch.randint(S // 8, S, (B,), generator=gen, device=DEVICE).to(torch.int32)
    whole = full_attention_decode(q, K, V, length)
    b, h = B // shards_b, H // shards_h
    part = full_attention_decode(q[:b, :h], K[:b, :, :h].contiguous(), V[:b, :, :h].contiguous(),
                                 length[:b])
    return bool(torch.equal(part, whole[:b, :h])), float((part - whole[:b, :h]).abs().max())


def score_bytes_sharded(torch, eng, cache):
    """``count_score_bytes`` of one sharded FIER layer's decode step (every
    shard's share in one call) for one_pass and the reference pipeline."""
    import dataclasses

    from repro_torch.kvcache.sharded import sharded_paged_decode_step
    from repro_torch.obs.flopcount import count_score_bytes

    cfg, plan = eng.bundle.cfg, eng.bundle.plan
    B = eng.n_slots
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    rnd = lambda *s: torch.randn(s, generator=gen, device=DEVICE).to(torch.bfloat16)
    q = rnd(B, cfg.n_heads, cfg.d_head)
    k_new, v_new = rnd(B, 1, cfg.n_kv_heads, cfg.d_head), rnd(B, 1, cfg.n_kv_heads, cfg.d_head)
    rest = cache["rest"]
    kp, vp, meta = rest["k"][0], rest["v"][0], rest["meta"].layer(0)
    length = torch.clamp(cache["length"], max=eng.capacity - 1)
    out = {}
    for pipeline in ("one_pass", "reference"):
        pol = dataclasses.replace(plan.policy, pipeline=pipeline)
        p = dataclasses.replace(plan, policy=pol, pipeline=pipeline)
        out[pipeline] = count_score_bytes(
            lambda q: sharded_paged_decode_step(q, k_new, v_new, kp, vp, meta,
                                                cache["block_table"], length, pol, p, p.shard),
            eng.capacity, q)
    return out


def sharded_olmo(torch, cfg, params):
    """(a) olmo-1b on tp2, dp2 and tp2×dp2 against the one-device paged
    engine: prefill logits bit for bit; the 32 decode steps, teacher-forced
    with the one-device tokens, bit for bit on SHARD_BITWISE's meshes and
    on tp2×dp2 the first within SHARD_LOGIT_REL_TOL and every one within
    SHARD_DRIFT_REL_TOL of the one-device step, its planted faults (read
    at every step) beyond both; K3/K4 = 14 × steps × shards and nothing
    else; clean audits; one_pass's score bytes 0 on every shard."""
    from repro_torch.launch.mesh import make_mesh

    n_fier = cfg.n_layers - SKIP
    base = sharded_drive(torch, cfg, params, None, PROMPTS, SHARD_STEPS, check=False)
    check_launches(base["counts"], PAGED_KERNELS, n_fier * SHARD_STEPS)
    out = {"unsharded": dict(ms=base["ms"], launches=base["counts"])}
    del base["eng"], base["cache"]
    out["base"] = base  # (e) holds the placed engine to the same run
    free(torch)
    V = cfg.vocab  # the padded columns read −1e30 in every run
    scale = float(base["logits"][..., :V].abs().max())
    log(f"  one device: decode {base['ms']:.2f} ms/step (median of {SHARD_TIMED_STEPS}); "
        f"max |logit| over {SHARD_STEPS} steps {scale:.4g}")
    for name, shape, axes in SHARD_MESHES:
        mesh = make_mesh(shape, axes, device=DEVICE)
        shards = math.prod(shape)
        exact = name in SHARD_BITWISE
        # the bit-for-bit meshes' profiles went to pay for (e)'s time
        got = sharded_drive(torch, cfg, params, mesh, PROMPTS, SHARD_STEPS, forced=base["toks"],
                            faults=not exact, profile=not exact)
        spec = got["eng"].shard
        step_gap = (got["logits"][..., :V] - base["logits"][..., :V]).abs().amax(dim=(1, 2))
        gap, gap1 = float(step_gap.max()) / scale, float(step_gap[0]) / scale
        first = int(torch.nonzero(step_gap).min()) if gap else None
        top1 = int((got["logits"].argmax(-1).T == base["toks"][:, 1:]).sum())
        bitwise = same(torch, got["logits"], base["logits"])
        dense = dense_rows_equal(torch, len(PROMPTS), spec.n_dp, spec.n_tp)
        fault_gaps = {}
        for k, v in got["faults"].items():  # [steps, B, V]: each step against the one device's
            g = (v[..., :V] - base["logits"][..., :V]).abs().amax(dim=(1, 2)) / scale
            fault_gaps[k] = dict(first=float(g[0]), least=float(g.min()), most=float(g.max()))
        sb = score_bytes_sharded(torch, got["eng"], got["cache"])
        gates = ("bit for bit" if exact else
                 f"gates: first step {SHARD_LOGIT_REL_TOL}, every step {SHARD_DRIFT_REL_TOL}")
        log(f"  {name} (tp {spec.n_tp} x dp {spec.n_dp}; {gates}): prefill logits max |Δ| "
            f"{float((got['pre'] - base['pre']).abs().max()):.6g} (gate 0); first decode step "
            f"max |Δlogit| {gap1:.4g} of max|logit|; over {SHARD_STEPS} teacher-forced steps "
            f"{gap:.4g}; bit for bit {bitwise}, first differing step {first}, top-1 "
            f"{top1}/{base['toks'][:, 1:].numel()}; dense decode attention over a shard's rows "
            f"bit for bit the whole call's: {dense[0]} (max |Δ| {dense[1]:.3g}); planted faults "
            f"(first, least and largest step over {SHARD_STEPS}) {json.dumps(fault_gaps)}; "
            f"decode {got['ms']:.2f} ms/step (one device {base['ms']:.2f}); launches "
            f"{got['counts']}; score bytes of one layer {sb}")
        log_errs(got["errs"], "K3", "K4")
        check_launches(got["counts"], PAGED_KERNELS, n_fier * SHARD_STEPS * shards)
        if not same(torch, got["pre"], base["pre"]):
            raise AssertionError(f"{name}: the prefill logits differ from the one-device run's")
        if exact and not (bitwise and same(torch, got["toks"], base["toks"])):
            raise AssertionError(f"{name}: the decode steps differ from the one-device run's "
                                 f"(first at step {first}, {gap:.4g} of max|logit|)")
        if not exact and not (gap1 <= SHARD_LOGIT_REL_TOL and gap <= SHARD_DRIFT_REL_TOL):
            raise AssertionError(f"{name}: first step {gap1:.4g} (gate {SHARD_LOGIT_REL_TOL}), "
                                 f"{SHARD_STEPS} steps {gap:.4g} (band {SHARD_DRIFT_REL_TOL})")
        if not all(g["first"] > SHARD_LOGIT_REL_TOL and g["most"] > SHARD_DRIFT_REL_TOL
                   for g in fault_gaps.values()):
            raise AssertionError(f"{name}: the gates do not see a planted fault: {fault_gaps}")
        if not (sb["one_pass"] == 0 and sb["reference"] > 0):
            raise AssertionError(f"{name}: the score-byte contract fails: {sb}")
        if got["errs"]["calls"] != n_fier * shards:
            raise AssertionError(f"{name}: {got['errs']['calls']} checked K3 calls")
        out[name] = dict(ms=got["ms"], launches=got["counts"], gap=gap, gap1=gap1, bitwise=bitwise,
                         first_diff=first, top1=top1, dense_bitwise=dense[0],
                         faults=fault_gaps, score_bytes=sb, errs=got["errs"])
        del got
        free(torch)
    return out


def sharded_granite(torch):
    """(b) granite-moe-1b-a400m (depth cut to GRANITE_SHARD_LAYERS) at tp2:
    GQA under TP (4 kv heads × rep 2 per shard at d_head 64); the prefill
    logits and the first decode step's equal the one-device engine's bit
    for bit, K3/K4 per layer and shard."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import Engine

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=GRANITE_SHARD_LAYERS)
    params = Engine.build(cfg, n_slots=1, capacity=CAPACITY, device=DEVICE).bundle
    params = params.compute_params(params.init(torch.Generator(device=DEVICE).manual_seed(0)))
    n_fier = cfg.n_layers - SKIP
    base = sharded_drive(torch, cfg, params, None, FAMILY_PROMPTS, 1, seed=9, check=False,
                         timed=0)
    del base["eng"], base["cache"]
    got = sharded_drive(torch, cfg, params, make_mesh((2,), ("model",), device=DEVICE),
                        FAMILY_PROMPTS, 1, seed=9, timed=0)
    del got["eng"], got["cache"]
    V = cfg.vocab
    scale = float(base["logits"][..., :V].abs().max())
    gap = float((got["logits"][..., :V] - base["logits"][..., :V]).abs().max())
    log(f"  granite-moe ({cfg.n_layers} layers, {cfg.n_kv_heads} kv heads x rep "
        f"{cfg.n_heads // cfg.n_kv_heads}, d_head {cfg.d_head}) tp2: first decode step max "
        f"|Δlogit| {gap:.6g} ({gap / scale:.3g} of max|logit| {scale:.4g}; gate: bit for "
        f"bit); launches {got['counts']}")
    log_errs(got["errs"], "K3", "K4")
    check_launches(base["counts"], PAGED_KERNELS, n_fier)
    check_launches(got["counts"], PAGED_KERNELS, n_fier * 2)
    if not same(torch, got["pre"], base["pre"]):
        raise AssertionError("granite-moe tp2: the prefill logits differ from one device's")
    if not (same(torch, got["logits"], base["logits"]) and same(torch, got["toks"], base["toks"])):
        raise AssertionError(f"granite-moe tp2: the first decode step differs from one "
                             f"device's by {gap:.4g}")
    placed = placed_granite(torch, cfg, params, base)
    del params
    free(torch)
    return dict(launches=got["counts"], gap=gap / scale, errs=got["errs"], placed=placed)


# (e) placed params: phase 4's weights placed by param_shardings (TP over
# 'model', FSDP over 'data') on tp2 x dp2, served through Engine.build(mesh=)
# paged one_pass (every (DP, TP) shard projecting its own rows and heads and
# launching K3/K4 on them) and through the sequence-sharded slab (a placed
# prefill's cache handed from heads to sequence).  Every projection's
# reduction splits over the model shards, so every layer rounds its bf16
# activations apart from one device's, and 16 layers carry it further than
# (a)'s tp2 x dp2 (only its dense skip layers round apart): against the
# one-device engine, × max|logit|, over 8 teacher-forced steps on one
# "NVIDIA H100 80GB HBM3, 700.00 W" (tools/probe_placed.py, PERF.md §6),
# olmo-1b's prefill read 0.0131 and its steps up to 0.0206 (0.0222 with the
# column blocks summed in f32 and rounded once; the CPU at reduced width
# reads 0.004-0.01), granite-moe's prefill 0.0051 and its first step 0.0474
# (a router near-tie moves a token's experts).  The gates sit between these
# and the planted faults' (olmo-1b's 0.764 and above, the slab's hand-off
# 1.370, granite-moe's dropped expert shard 0.4019)
PLACED_REL_TOL = 0.04       # olmo-1b: prefill and every step; the slab's prefill and step
PLACED_MOE_REL_TOL = 0.1    # granite-moe: prefill and first step
PLACED_MESH = ("tp2xdp2", (2, 2), ("data", "model"))
PLACED_FAULT_STEPS = 2  # the planted faults are read at the first steps only
PLACED_SLAB_PROMPTS = (2000, 1500, 1000, 500)  # (e)'s slab: B 4, placed prefill


def placed_params(torch, params, mesh):
    from repro_torch.core import placement as pl
    from repro_torch.launch.sharding import param_shardings

    return pl.place_tree(params, param_shardings(params, mesh, ("data",)))


def placed_faults(torch, eng, params, tok, cache):
    """One decode step of an engine on placed params from copies of
    ``cache`` with two planted faults: model shard 1's wo partial dropped
    from the psum; every model shard reading the next shard's column block
    of wq (its heads' queries from another shard's weights).  Returns each
    fault's logits."""
    from repro_torch.models import tensor_parallel as tpm

    row_sum, view = tpm.row_sum, tpm.Views.tp

    def drop_wo(parts, name):
        if name == "wo":
            parts = [parts[0]] + [torch.zeros_like(p) for p in parts[1:]]
        return row_sum(parts, name)

    def next_wq(self, x, path, t, m):
        if path.endswith("attn/wq"):
            m = (m + 1) % self.shards.n_tp
        return view(self, x, path, t, m)

    out = {}
    for name, attr, fn in (("model shard 1's wo partial dropped", "row_sum", drop_wo),
                           ("each model shard on the next shard's wq block", "tp", next_wq)):
        target = tpm.Views if attr == "tp" else tpm
        orig = getattr(target, attr)
        setattr(target, attr, fn)
        try:
            _, lg, _ = eng.decode(params, tok, clone_cache(torch, cache))
            sync(torch)
        finally:
            setattr(target, attr, orig)
        out[name] = lg.clone()
    return out


def fault_gaps_of(got, base, V, scale):
    """Each planted fault's gap to the one-device steps (first, least and
    largest step), × max|logit|."""
    out = {}
    for k, v in got["faults"].items():
        n = v.shape[0]
        g = (v[..., :V] - base["logits"][:n, ..., :V]).abs().amax(dim=(1, 2)) / scale
        out[k] = dict(first=float(g[0]), least=float(g.min()), most=float(g.max()))
    return out


def placed_olmo(torch, cfg, params, base):
    """(e) olmo-1b's placed params on tp2 x dp2 through the paged engine,
    against (a)'s one-device run: the prefill logits and every
    teacher-forced step within PLACED_REL_TOL, the planted faults
    (``placed_faults``, read at the first PLACED_FAULT_STEPS steps) beyond
    it; K3/K4 = 14 × steps × shards; decode ms/step beside the one
    device's."""
    from repro_torch.launch.mesh import make_mesh

    name, shape, axes = PLACED_MESH
    mesh = make_mesh(shape, axes, device=DEVICE)
    shards = math.prod(shape)
    placed = placed_params(torch, params, mesh)
    got = sharded_drive(torch, cfg, placed, mesh, PROMPTS, SHARD_STEPS, forced=base["toks"],
                        faults=True, fault_fn=placed_faults, fault_steps=PLACED_FAULT_STEPS,
                        profile=False)
    del got["eng"], got["cache"]
    V = cfg.vocab
    scale = float(base["logits"][..., :V].abs().max())
    pre = float((got["pre"][:, :V] - base["pre"][:, :V]).abs().max()) / scale
    step_gap = (got["logits"][..., :V] - base["logits"][..., :V]).abs().amax(dim=(1, 2)) / scale
    gap, gap1 = float(step_gap.max()), float(step_gap[0])
    top1 = int((got["logits"].argmax(-1).T == base["toks"][:, 1:]).sum())
    faults = fault_gaps_of(got, base, V, scale)
    n_fier = cfg.n_layers - SKIP
    log(f"  (e) {name}, placed params (TP over 'model', FSDP over 'data'): prefill logits "
        f"{pre:.4g} of max|logit|; first decode step {gap1:.4g}; over {SHARD_STEPS} "
        f"teacher-forced steps {gap:.4g} (gate {PLACED_REL_TOL} for each); per step "
        f"{json.dumps([round(float(g), 6) for g in step_gap])}; top-1 "
        f"{top1}/{base['toks'][:, 1:].numel()}; planted faults "
        f"(first, least and largest of {PLACED_FAULT_STEPS} steps) {json.dumps(faults)}; decode "
        f"{got['ms']:.2f} ms/step (one device {base['ms']:.2f}); launches {got['counts']}")
    log_errs(got["errs"], "K3", "K4")
    check_launches(got["counts"], PAGED_KERNELS, n_fier * SHARD_STEPS * shards)
    if not (pre <= PLACED_REL_TOL and gap <= PLACED_REL_TOL):
        raise AssertionError(f"{name} placed: prefill {pre:.4g}, steps {gap:.4g} (gate "
                             f"{PLACED_REL_TOL})")
    if not all(g["least"] > PLACED_REL_TOL for g in faults.values()):
        raise AssertionError(f"{name} placed: the gate does not see a planted fault: {faults}")
    if got["errs"]["calls"] != n_fier * shards:
        raise AssertionError(f"{name} placed: {got['errs']['calls']} checked K3 calls")
    out = dict(ms=got["ms"], ms_one_device=base["ms"], launches=got["counts"], prefill=pre,
               gap=gap, gap1=gap1, top1=top1, faults=faults, errs=got["errs"])
    del got, placed
    free(torch)
    return out


def placed_slab(torch, cfg, params):
    """(e) the sequence-sharded slab on tp2 x dp2: the placed prefill of
    PLACED_SLAB_PROMPTS (its cache placed by ``cache_shardings``, K/V handed
    from heads to sequence per layer) against the one-device prefill; then
    one decode step of the placed params on that cache against the
    unplaced params' sharded step on the one-device cache placed the same
    way (both the plain sharded FIER path, exact mode), within
    PLACED_REL_TOL; the hand-off in swapped order (each shard given
    another shard's sequence block) beyond it."""
    import numpy as np

    from repro_torch.core import placement as pl
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import cache_batch_axes, cache_shardings
    from repro_torch.models import build_model
    from repro_torch.models import placed_serving as ps
    from repro_torch.models.attention import DistConfig

    name, shape, axes = PLACED_MESH
    mesh = make_mesh(shape, axes, device=DEVICE)
    pol = PolicyConfig(kind="fier", budget=BUDGET, group=GROUP, skip_layers=SKIP,
                       pipeline="one_pass")
    one = build_model(cfg, pol, device=DEVICE)
    pre_b = build_model(cfg, pol, DistConfig(mesh=mesh, batch_axes=("data",)), device=DEVICE)
    dec_b = build_model(cfg, pol, DistConfig(mesh=mesh, seq_axes=("model",),
                                             batch_axes=("data",), mode="exact"), device=DEVICE)
    rng = np.random.default_rng(21)
    S = max(PLACED_SLAB_PROMPTS)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (len(PLACED_SLAB_PROMPTS), S))).to(DEVICE)
    batch = {"tokens": toks, "lengths": torch.tensor(PLACED_SLAB_PROMPTS, dtype=torch.int32,
                                                     device=DEVICE)}
    placed = placed_params(torch, params, mesh)
    V = cfg.vocab
    with torch.no_grad():
        lg_one, c_one = one.prefill(params, batch, capacity=CAPACITY)
        tok = lg_one.argmax(-1).to(torch.int32)
        c_one = pl.place_tree(c_one, cache_shardings(c_one, mesh, ("data",), ("model",),
                                                     cache_batch_axes(dec_b.init_cache,
                                                                      CAPACITY)))
        ref, _ = dec_b.decode_step(params, tok, c_one)
        del c_one
        free(torch)
        scale = float(ref[:, :V].abs().max())
        runs = {}
        hand_off = ps.heads_to_sequence
        for run, fn in (("sound", hand_off),
                        ("hand-off swapped", lambda xs, sd, hd: hand_off(xs, sd, hd)[::-1])):
            ps.heads_to_sequence = fn
            try:
                sync(torch)
                t0 = time.perf_counter()
                lg, cache = pre_b.prefill(placed, batch, capacity=CAPACITY)
                sync(torch)
                ms = 1e3 * (time.perf_counter() - t0)
            finally:
                ps.heads_to_sequence = hand_off
            step, _ = dec_b.decode_step(placed, tok, cache)
            runs[run] = dict(prefill=float((lg[:, :V] - lg_one[:, :V]).abs().max()) / scale,
                             step=float((step[:, :V] - ref[:, :V]).abs().max()) / scale,
                             prefill_ms=ms)
            del cache
            free(torch)
    log(f"  (e) {name} slab, placed prefill of {PLACED_SLAB_PROMPTS} at capacity {CAPACITY} "
        f"and one sequence-sharded step, × max|logit| against the one-device prefill and the "
        f"unplaced params' sharded step (gate {PLACED_REL_TOL}): {json.dumps(runs)}")
    sound, fault = runs["sound"], runs["hand-off swapped"]
    if not (sound["prefill"] <= PLACED_REL_TOL and sound["step"] <= PLACED_REL_TOL):
        raise AssertionError(f"{name} placed slab: {sound} (gate {PLACED_REL_TOL})")
    if not fault["step"] > PLACED_REL_TOL:
        raise AssertionError(f"{name} placed slab: the gate does not see the swapped hand-off: "
                             f"{fault}")
    del placed, one, pre_b, dec_b
    free(torch)
    return runs


def placed_granite(torch, cfg, params, base):
    """(e) granite-moe (as (b)'s, GRANITE_SHARD_LAYERS layers) with placed
    params on tp2 x dp2 through the paged engine: expert-parallel prefill
    (one token shard per insert) and decode (each expert shard's experts
    masked, the partials summed) against (b)'s one-device run: prefill
    logits and the first step within PLACED_MOE_REL_TOL; one expert
    shard's decode partial dropped beyond it."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tensor_parallel as tpm

    name, shape, axes = PLACED_MESH
    mesh = make_mesh(shape, axes, device=DEVICE)
    placed = placed_params(torch, params, mesh)
    row_sum = tpm.row_sum

    def drop_expert_shard(torch, eng, params, tok, cache):
        def drop(parts, what):
            if what == "moe":
                parts = [parts[0]] + [torch.zeros_like(p) for p in parts[1:]]
            return row_sum(parts, what)

        tpm.row_sum = drop
        try:
            _, lg, _ = eng.decode(params, tok, clone_cache(torch, cache))
            sync(torch)
        finally:
            tpm.row_sum = row_sum
        return {"expert shard 1's partial dropped": lg.clone()}

    got = sharded_drive(torch, cfg, placed, mesh, FAMILY_PROMPTS, 1, seed=9, forced=base["toks"],
                        faults=True, fault_fn=drop_expert_shard, timed=0)
    del got["eng"], got["cache"]
    V = cfg.vocab
    scale = float(base["logits"][..., :V].abs().max())
    pre = float((got["pre"][:, :V] - base["pre"][:, :V]).abs().max()) / scale
    gap = float((got["logits"][..., :V] - base["logits"][..., :V]).abs().max()) / scale
    faults = fault_gaps_of(got, base, V, scale)
    log(f"  (e) granite-moe ({cfg.n_layers} layers, {cfg.n_experts} experts, "
        f"{cfg.n_experts // 2} per expert shard) {name}, placed params: prefill logits "
        f"{pre:.4g} of max|logit|, first decode step {gap:.4g} (gate {PLACED_MOE_REL_TOL}); "
        f"planted fault {json.dumps(faults)}; launches {got['counts']}")
    log_errs(got["errs"], "K3", "K4")
    check_launches(got["counts"], PAGED_KERNELS, (cfg.n_layers - SKIP) * math.prod(shape))
    if not (pre <= PLACED_MOE_REL_TOL and gap <= PLACED_MOE_REL_TOL):
        raise AssertionError(f"granite-moe placed: prefill {pre:.4g}, first step {gap:.4g} "
                             f"(gate {PLACED_MOE_REL_TOL})")
    if not all(g["first"] > PLACED_MOE_REL_TOL for g in faults.values()):
        raise AssertionError(f"granite-moe placed: the gate does not see the fault: {faults}")
    out = dict(launches=got["counts"], prefill=pre, gap=gap, faults=faults, errs=got["errs"])
    del placed, got
    free(torch)
    return out


def record_logits(sched, eng, reqs, vocab, forced=None):
    """Wrap the scheduler's sampling of a prefill's token and the engine's
    decode so that every request keeps the logits row (f32, ``vocab``
    wide) of each token it appends, position by position.  With ``forced``
    ({rid: tokens} of another run) every decode step is fed, at each
    running slot, that run's token at the slot's last position instead of
    the slot's own (teacher forcing), so each position's logits compare
    with that run's on the same history.  Returns {rid: [row per
    position]}."""
    rows = {r.rid: [] for r in reqs}
    pending = {}
    sample, decode = sched._sample, eng.decode

    def sample_recorded(logits):
        pending["prefill"] = logits.reshape(-1, logits.shape[-1])[0, :vocab].float()
        return sample(logits)

    def decode_recorded(params, tok, cache, **k):
        if forced is not None:
            tok = tok.clone()
            for slot, req in sched.running.items():
                tok[slot] = forced[req.rid][len(req.out) - 1]
        nxt, lg, cache = decode(params, tok, cache, **k)
        flat = lg.reshape(-1, lg.shape[-1])
        for slot, req in sched.running.items():
            pending[req.rid] = flat[slot, :vocab].float()
        return nxt, lg, cache

    class Out(list):
        def __init__(self, rid):
            super().__init__()
            self.rid = rid

        def append(self, tok):
            rows[self.rid].append(pending.pop("prefill") if not self else pending.pop(self.rid))
            super().append(tok)

    sched._sample, eng.decode = sample_recorded, decode_recorded
    for r in reqs:
        r.out = Out(r.rid)
    return rows


def stream_run(torch, cfg, params, mesh, forced=None, gated=True):
    """Phase 5's requests through ``ContinuousScheduler`` (chunk 2048, 8
    slots × 8192, the default pool) on ``mesh`` (None: one device), every
    appended token's logits recorded (``record_logits``, teacher-forced by
    ``forced``).  ``gated``: every request finishes with no preemption,
    downshift or leak, the audit is clean, K3/K4 = 14 × decode steps ×
    shards, and a mesh shows per-shard pool gauges."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import Observability
    from repro_torch.serving import ContinuousScheduler, Engine, serving_policy

    eng = Engine.build(cfg, n_slots=8, capacity=CAPACITY, policy=serving_policy(
        budget=BUDGET, layout="paged"), mesh=mesh, obs=Observability(), device=DEVICE)
    sched = ContinuousScheduler(eng, params, chunk_tokens=2048)
    reqs = stream_requests(cfg.vocab)
    rows = record_logits(sched, eng, reqs, cfg.vocab, forced)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sched.run(reqs)
    sync(torch)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    run = dict(toks={r: list(t) for r, t in res.items()}, steps=sched.steps, counts=counts,
               wall_s=wall, rows={r: torch.stack(v) for r, v in rows.items()})
    if not gated:
        return run
    eng.audit()
    eng.sample_pool_gauges()
    ps = eng.pool_stats()
    shards = 1 if mesh is None else mesh.size
    gauges = {s.labels for s in eng.obs.metrics.snapshot().series
              if s.name == "pool_blocks_in_use"}
    status = {o.status for o in res.outcomes.values()}
    log(f"    {len(reqs)} requests, pool {eng.pool_blocks} blocks, {sched.steps} decode steps, "
        f"{sched.preemptions} preemptions, {eng.downshifts} downshifts, prefix block hits "
        f"{ps['pool_prefix_block_hits']}, wall {wall:.2f} s; launches {counts}; pool gauges "
        f"{sorted(map(str, gauges))}")
    check_launches(counts, PAGED_KERNELS, (cfg.n_layers - SKIP) * sched.steps * shards)
    if sched.preemptions or eng.downshifts or ps["pool_blocks_in_use"]:
        raise AssertionError("the stream preempted, downshifted or leaked")
    if status != {"finished"}:
        raise AssertionError(f"not every request finished: {status}")
    if shards > 1 and len(gauges) < 3:
        raise AssertionError(f"no per-shard pool gauges: {gauges}")
    return run


def stream_gaps(torch, one, other):
    """Per request, the largest |Δlogit| of ``other``'s rows against
    ``one``'s over its positions, × ``one``'s max|logit|."""
    scale = max(float(v.abs().max()) for v in one["rows"].values())
    out = {}
    for rid, a in one["rows"].items():
        b = other["rows"][rid]
        if a.shape != b.shape:
            raise AssertionError(f"request {rid}: {b.shape[0]} positions, not {a.shape[0]}")
        out[rid] = float((a - b).abs().max()) / scale
    return out


def sharded_stream(torch, cfg, params):
    """(c) phase 5's requests through ``ContinuousScheduler`` on one device
    and on dp2 (``stream_run``, both gated: neither preempts or downshifts
    with the default pool, one null block per DP shard), the dp2 run
    teacher-forced with the one-device run's tokens: at every position of
    every request its logits lie within SHARD_DRIFT_REL_TOL·max|logit| of
    the one-device run's.  A third run on dp2, with DP shard 1 localizing
    its block table as shard 0 would (it reads another shard's rows), must
    lie beyond it."""
    from repro_torch.kvcache import sharded as kvsharded
    from repro_torch.launch.mesh import make_mesh

    dp2 = make_mesh((2,), ("data",), device=DEVICE)
    log("  one device:")
    one = stream_run(torch, cfg, params, None)
    free(torch)
    log("  dp2, teacher-forced with the one-device tokens:")
    dp = stream_run(torch, cfg, params, dp2, forced=one["toks"])
    free(torch)
    localize = kvsharded.localize_block_table
    kvsharded.localize_block_table = (
        lambda block_table, d, n_local, n_dp: localize(block_table, max(d - 1, 0), n_local, n_dp))
    try:
        fault = stream_run(torch, cfg, params, dp2, forced=one["toks"], gated=False)
    finally:
        kvsharded.localize_block_table = localize
    free(torch)
    gaps, fault_gaps = stream_gaps(torch, one, dp), stream_gaps(torch, one, fault)
    top1 = sum(int((dp["rows"][r].argmax(-1) == torch.tensor(t, device=DEVICE)).sum())
               for r, t in one["toks"].items())
    n = sum(len(t) for t in one["toks"].values())
    dense = dense_rows_equal(torch, 8, 2, 1)
    gap, fault_gap = max(gaps.values()), max(fault_gaps.values())
    log(f"  dp2 teacher-forced against one device, largest |Δlogit| over every position × "
        f"max|logit| (band {SHARD_DRIFT_REL_TOL}): {gap:.4g}, per request "
        f"{json.dumps({r: round(g, 6) for r, g in gaps.items()})}; top-1 {top1}/{n}; "
        f"planted fault (DP shard 1 "
        f"reading shard 0's rows) {fault_gap:.4g}, per request "
        f"{json.dumps({r: round(g, 6) for r, g in fault_gaps.items()})}; dense decode attention "
        f"over a shard's 4 slots bit for bit the 8-slot call's: {dense[0]} (max |Δ| "
        f"{dense[1]:.3g})")
    if not gap <= SHARD_DRIFT_REL_TOL:
        raise AssertionError(f"dp2's stream lies {gap:.4g} of max|logit| from one device's "
                             f"(band {SHARD_DRIFT_REL_TOL})")
    if not fault_gap > SHARD_DRIFT_REL_TOL:
        raise AssertionError(f"the band does not see the planted DP fault: {fault_gap:.4g}")
    return dict(launches=dp["counts"], steps=dp["steps"], wall_s=dp["wall_s"],
                wall_s_one_device=one["wall_s"], steps_one_device=one["steps"], gap=gap,
                fault_gap=fault_gap, top1=top1, positions=n,
                dense_bitwise=dense[0])


def sharded_long(torch):
    """(d) the sequence-sharded decode of one layer at ``long_500k``'s shape
    over LONG_SHARDS shards of 131,072 tokens (K, V on the card from a
    seeded generator): exact mode attends the single-device top-k's index
    set up to scores within ε of τ; ``full_decode_sharded`` lies within
    LONG_FULL_REL_TOL·max|out| of dense attention, and a planted fault (the
    last shard dropped from the merge) beyond it; local mode's overlap with
    the global top-k is reported; each timed (median of 3)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import retrieval as rt
    from repro_torch.core.quantize import QuantizedKeys, quantize

    B, Hkv, rep, D, S, budget = LONG_SEQ
    n = LONG_SHARDS
    S_loc = S // n
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    ch = torch.randn(D, generator=gen, device=DEVICE).exp()
    K = (torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE) * ch).to(torch.bfloat16)
    V = torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    q = torch.randn((B, Hkv * rep, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    qk = quantize(K, GROUP)
    length = torch.full((B,), S, dtype=torch.int32, device=DEVICE)
    starts = [i * S_loc for i in range(n)]
    part = lambda a, i, rows: a[:, i * rows:(i + 1) * rows]
    K_l = [part(K, i, S_loc) for i in range(n)]
    V_l = [part(V, i, S_loc) for i in range(n)]
    qk_l = [QuantizedKeys(part(qk.codes, i, S_loc // 8), part(qk.scale, i, S_loc // GROUP),
                          part(qk.zero, i, S_loc // GROUP), GROUP) for i in range(n)]

    def timed(fn):
        ms = []
        for _ in range(3):
            sync(torch)
            t0 = time.perf_counter()
            r = fn()
            sync(torch)
            ms.append(1e3 * (time.perf_counter() - t0))
        return r, median(ms)

    kv_scores = lambda q_, qk_: rt.reduce_over_query_group(rt.approx_scores(q_, qk_), Hkv)
    kv = kv_scores(q, qk)
    glob, ms_glob = timed(lambda: rt.select_topk(kv_scores(q, qk), budget, length))
    want = torch.zeros((B, Hkv, S), dtype=torch.bool, device=DEVICE).scatter_(
        2, glob.to(torch.int64), True)
    tau = torch.topk(kv, budget, dim=-1).values[..., -1:]
    eps = 2 * score_eps(q.reshape(B, Hkv, rep, D), qk)
    got, readings = {}, {"single_device_select_ms": ms_glob}
    for mode in ("exact", "local"):
        sel, ms = timed(lambda: dist.select_sharded(
            [kv_scores(q, c) for c in qk_l], budget, [length] * n, shard_start=starts,
            n_shards=n, mode=mode))
        got[mode] = dist.selected_mask(sel, starts, length, S)
        _, ms_dec = timed(lambda: dist.fier_decode_sharded(
            [q] * n, K_l, V_l, qk_l, budget, [length] * n, shard_start=starts, n_shards=n,
            mode=mode))
        readings[f"{mode}_select_ms"], readings[f"{mode}_decode_ms"] = ms, ms_dec
    diff = got["exact"] ^ want
    near = ((kv - tau).abs() <= eps) | (kv == tau)
    readings["exact_diff"] = int(diff.sum())
    readings["exact_diff_outside_eps"] = int((diff & ~near).sum())
    readings["local_overlap"] = float((got["local"] & want).sum()) / float(want.sum())
    dense, ms_dense = timed(lambda: rt.full_attention_decode(q, K, V, length))
    full, ms_full = timed(lambda: dist.full_decode_sharded(
        [q] * n, K_l, V_l, [length] * n, shard_start=starts))
    dropped = dist.full_decode_sharded([q] * (n - 1), K_l[:-1], V_l[:-1], [length] * (n - 1),
                                       shard_start=starts[:-1])
    top = float(dense.float().abs().max())
    rel = lambda a: float((a[0].float() - dense.float()).abs().max()) / top
    readings.update(dense_ms=ms_dense, full_sharded_ms=ms_full, full_rel=rel(full),
                    full_fault_rel=rel(dropped), eps=eps)
    log(f"  long_500k (B {B}, {Hkv} kv heads, S {S}, budget {budget}) over {n} shards: "
        f"{json.dumps(readings)}")
    if not all(torch.equal(o, full[0]) for o in full):
        raise AssertionError("full_decode_sharded's shards disagree")
    if readings["exact_diff_outside_eps"]:
        raise AssertionError(f"exact mode's index set differs beyond near-τ ties: {readings}")
    if not (readings["full_rel"] <= LONG_FULL_REL_TOL < readings["full_fault_rel"]):
        raise AssertionError(f"full_decode_sharded vs dense attention: {readings}")
    del K, V, qk, K_l, V_l, qk_l, kv
    free(torch)
    return readings


def sharded_path(torch):
    """Phase 12: (a) olmo-1b on three meshes, (b) granite-moe at tp2, (c)
    phase 5's stream on dp2, (d) the sequence-sharded decode at
    long_500k, (e) olmo-1b and granite-moe with placed params on tp2 x
    dp2."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine

    t0 = time.perf_counter()
    cfg = get_config("olmo-1b")
    bundle = Engine.build(cfg, n_slots=1, capacity=CAPACITY, device=DEVICE).bundle
    params = bundle.compute_params(bundle.init(torch.Generator(device=DEVICE).manual_seed(0)))
    out, walls = {}, {}

    def part(key, title, fn, *a):
        log(f"  {title}")
        t = time.perf_counter()
        out[key] = fn(torch, *a)
        walls[key] = round(time.perf_counter() - t, 1)

    part("olmo", "(a) olmo-1b, paged one_pass, on tp2, dp2 and tp2 x dp2", sharded_olmo, cfg,
         params)
    part("placed", "(e) olmo-1b with placed params on tp2 x dp2, paged one_pass",
         lambda torch, *a: placed_olmo(torch, *a, out["olmo"].pop("base")), cfg, params)
    part("placed_slab", "(e) olmo-1b with placed params on tp2 x dp2, the sequence-sharded "
         "slab", placed_slab, cfg, params)
    part("stream", "(c) phase 5's stream through the scheduler on dp2", sharded_stream, cfg,
         params)
    del params, bundle
    free(torch)
    part("granite", "(b) granite-moe-1b-a400m at tp2, then (e) placed on tp2 x dp2",
         sharded_granite)
    part("long", "(d) the sequence-sharded decode at long_500k", sharded_long)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 12 wall time {out['wall_s']:.1f} s: {walls}")
    return out


# ------------------------------------------------------------ phase 13

# (a)-(e): olmo-1b at full width, depth cut to this (2 FIER layers past
# SKIP when (e) serves it); phase 11(b)'s B x S, seed 0, AdamW + cosine
# (warmup 0, so the first step moves the params)
SHARD_TRAIN_LAYERS = 4
SHARD_TRAIN_MESHES = (("dp2", (2,), ("data",)), ("tp2", (2,), ("model",)),
                      ("tp2xdp2", (2, 2), ("data", "model")))
SHARD_TRAIN_LR = 1e-3
SHARD_TRAIN_TIMED = 2      # more steps per mesh after the first, timed (median; cut from 4)
GRANITE_TRAIN_LAYERS = 2   # (b)
NO_DROP_FACTOR = 8.0       # (b): the capacity factor at which nothing drops
EXPERT_LEAN = 0.05         # (b): the tokens' shift along expert 0's router column, × sqrt(d)
ELASTIC_STEPS = 2          # (d): steps after the restore
SERVE_TRAINED_STEPS = 8    # (e): teacher-forced decode steps
# A sharded step against the one-device step from the same state, each gate
# set between the largest sound reading and the smallest of the planted
# faults' (first step: a DP shard fed another shard's rows, TP shard 1's wo
# partial dropped, FSDP pieces gathered in swapped order, each read above
# every first-step gate; the timed steps, AdamW with non-zero moments: each
# split leaf's pieces updated with the next piece's first moment, or with
# their first moments lost, each read above the loss and timed grad-norm
# gates).  The loss gate holds the first step and every timed step.
# Readings on one "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md §6, phase 13):
TRAIN_LOSS_REL_TOL = 2e-4   # |Δloss| / loss: sound 3.93e-05 (granite 9.12e-05), faults 2.99e-04-8.20
# (over 2 timed steps the lost first moments read 3.10e-04, over 4 0.0123)
TRAIN_GNORM_REL_TOL = 1e-3  # first step |Δ grad norm| / norm: sound 1.59e-05, faults 0.0108-0.420
# the timed steps' grad norm: where the first gradient was near zero, v̂ is
# tiny and AdamW's next updates are sign-like, so summation order flips
# such elements by 2·lr and the next gradients' norm moves a little
TRAIN_TIMED_GNORM_REL_TOL = 0.01  # sound 1.86e-03, faults 0.150-817
TRAIN_GRAD_REL_TOL = 0.1    # max over leaves of max|Δg| / max|g|: sound 0.01875, faults 1.12-1.67
# AdamW's first step moves an element by lr·g/(|g| + eps) ≈ lr·sign(g), so
# where a near-zero gradient's sign flips the two runs part by up to 2·lr.
# The first step's params are held where the one device's |g| is at least
# TRAIN_GRAD_REL_TOL of its leaf's max|g| — above the gradient gate, so a
# sound run keeps the sign there — as max|Δp| / max|p| of the leaf
TRAIN_PARAM_REL_TOL = 1e-4  # sound 2.37e-07, faults 0.0302
# (d)'s two steps from a restored state with non-zero moments: every param
# within 2·lr a step (AdamW moves an element by about lr·m̂/√v̂ a step)
TRAIN_PARAM_BOUND = 2 * SHARD_TRAIN_LR * (1 + 1e-3)
MOE_Y_REL_TOL = 0.02        # (b) EP's output vs moe_apply's, × max|y|: read 8.35e-06 / 0.00214
MOE_AUX_REL_TOL = 1e-5      # (b) EP's aux vs the per-shard estimator: read 0
COMPRESS_SCALE_REL_TOL = 0.01  # (c) a tensor's 1-bit scale vs the one device's: read 4.47e-04


def mesh_dcfg(cfg, mesh):
    """The train CLI's DistConfig for ``mesh``: the batch over its batch
    axes, EP over 'model' for a MoE."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models.attention import DistConfig

    ep = "model" if cfg.family == "moe" and mesh.shape.get("model", 1) > 1 else None
    return DistConfig(mesh=mesh, batch_axes=batch_axes(mesh), ep_axis=ep)


def place_state(state, mesh):
    """``state`` placed on ``mesh`` as the train CLI places it (TP over
    'model', FSDP over 'data'); returns (placed state, its shardings)."""
    from repro_torch.core import placement as pl
    from repro_torch.launch import sharding as shard

    psh = shard.param_shardings(state["params"], mesh, ("data",))
    sh = {"params": psh, "opt": shard.opt_shardings(state["opt"], psh, mesh)}
    if "ef" in state:
        sh["ef"] = psh
    return pl.place_tree(state, sh), sh


def grads_of(torch, bundle, params, batch):
    """(loss, grad norm, the gradients as logical tensors) of one forward
    and backward of ``bundle.train_loss``."""
    from repro_torch.core import placement as pl
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.optim import clip_by_global_norm

    loss, _, grads = _loss_and_grads(bundle, params, batch)
    _, gn = clip_by_global_norm(grads, 1.0)
    return float(loss), float(gn), pl.gather_tree(grads)


def tree_gap(torch, got, ref) -> float:
    """max over leaves of max|got − ref| / max|ref| of the leaf."""
    from repro_torch.optim.tree import leaves

    return max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(leaves(got), leaves(ref)))


def abs_gap(torch, got, ref) -> float:
    from repro_torch.optim.tree import leaves

    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(leaves(got), leaves(ref)))


def masked_param_gap(torch, got, ref, grads) -> float:
    """max over leaves of max|got − ref| / max|ref| of the leaf, over the
    elements whose |grads| is at least TRAIN_GRAD_REL_TOL of the leaf's
    max (where AdamW's first step keeps its sign in a sound run)."""
    from repro_torch.optim.tree import leaves

    out = 0.0
    for a, b, g in zip(leaves(got), leaves(ref), leaves(grads)):
        g = g.float().abs()
        keep = (g >= TRAIN_GRAD_REL_TOL * g.max()) & (g > 0)
        if bool(keep.any()):
            d = (a.float() - b.float()).abs()[keep].max()
            out = max(out, float(d / b.float().abs().max().clamp_min(1e-30)))
    return out


def first_step_gaps(torch, bundle, step, placed, batch, ref, ref1) -> dict:
    """One mesh's first step against the one device's from the same state:
    loss, grad norm and every leaf's gradient against ``ref`` = (loss,
    grad norm, grads); the params after AdamW against ``ref1``'s, masked
    as ``masked_param_gap``."""
    from repro_torch.core import placement as pl

    loss, gn, g = grads_of(torch, bundle, placed["params"], batch)
    gaps = dict(loss=abs(loss - ref[0]) / ref[0], grad_norm=abs(gn - ref[1]) / ref[1],
                grad=tree_gap(torch, g, ref[2]))
    del g
    st1, _ = step(placed, batch)
    gaps["params"] = masked_param_gap(torch, pl.gather_tree(st1["params"]), ref1["params"],
                                      ref[2])
    return gaps


def metric_gaps(metrics, ref) -> dict:
    """The largest |Δloss| / loss and |Δ grad norm| / norm over the steps of
    two runs' metrics."""
    return {k: max(abs(a[k] - b[k]) / b[k] for a, b in zip(metrics, ref))
            for k in ("loss", "grad_norm")}


# planted optimizer faults: what each split leaf's AdamW update is given
# for its pieces' first moments
OPTIMIZER_FAULTS = {
    "each piece updated with the next piece's first moment": lambda mus: mus[1:] + mus[:1],
    "the first moments of split leaves lost (zero) before each update":
        lambda mus: [m.new_zeros(m.shape) for m in mus],
}


def optimizer_fault(torch, step, state, batches, ref_metrics, wrong_mu):
    """The steps over ``batches`` with a planted optimizer fault: each split
    leaf's pieces updated with ``wrong_mu(their first moments)``.  Returns
    the metric gaps against ``ref_metrics``."""
    from repro_torch.core.placement import Sharded
    from repro_torch.optim import adamw

    orig = adamw.map_leaves

    def faulty(fn, tree, *rest):
        if isinstance(tree, dict):
            return {k: faulty(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
        if isinstance(tree, Sharded) and len(tree.pieces) > 1 and len(rest) == 3:
            mu, nu, p = rest
            mus = wrong_mu(mu.pieces)
            return tree.with_pieces([fn(*a) for a in zip(tree.pieces, mus, nu.pieces, p.pieces)])
        return orig(fn, tree, *rest)

    adamw.map_leaves = faulty
    try:
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        adamw.map_leaves = orig
    del state
    return metric_gaps(metrics, ref_metrics)


def train_faults(torch, measure):
    """``measure()`` (a mesh's first-step gaps) with three planted faults:
    DP shard 1 fed shard 0's rows; TP shard 1's wo partial dropped from the
    psum; the FSDP pieces of the column-parallel weights gathered in
    swapped order.  Returns each fault's gaps."""
    from repro_torch.core import placement as pl
    from repro_torch.models import sharded_train as st
    from repro_torch.models import tensor_parallel as tpm

    split, row_sum, gather = st.split_batch, tpm.row_sum, pl._gather

    def other_rows(b, mesh, axes):
        parts = split(b, mesh, axes)
        return [parts[0]] + [{k: None if v is None else v.to(p[k].device)
                              for k, v in parts[0].items()} for p in parts[1:]]

    def drop_wo(parts, name):
        if name == "wo":
            parts = [parts[0]] + [torch.zeros_like(p) for p in parts[1:]]
        return row_sum(parts, name)

    def swapped(xs, dim, device):
        # the pieces of the column-parallel weights' contraction dim (wq, wk,
        # wv, w1, w3: dim 0 of a layer's [d, ·] leaf) in swapped order.  A
        # swap of every d-split leaf would not show: with olmo's
        # parameter-free norm it permutes d consistently from the embedding
        # to the head, a symmetry of the graph
        return gather(list(reversed(xs)) if dim == 0 else xs, dim, device)

    out = {}
    for name, mod, attr, fn in (("a DP shard fed another shard's rows", st, "split_batch",
                                 other_rows),
                                ("TP shard 1's wo partial dropped", tpm, "row_sum", drop_wo),
                                ("FSDP pieces gathered in swapped order", pl, "_gather",
                                 swapped)):
        orig = getattr(mod, attr)
        setattr(mod, attr, fn)
        try:
            out[name] = measure()
        finally:
            setattr(mod, attr, orig)
        free(torch)
    return out


def train_steps_timed(torch, step_fn, state, batches):
    """Steps over ``batches``, synchronized: (state, median ms, peak GiB
    above the state, the metrics)."""
    free(torch)
    base = peak_base(torch)
    ms, metrics = [], []
    for b in batches:
        sync(torch)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        sync(torch)
        ms.append(1e3 * (time.perf_counter() - t0))
    return state, median(ms), peak_gib(torch, base), metrics


def sharded_train_olmo(torch):
    """(a): olmo-1b (SHARD_TRAIN_LAYERS layers) on dp2, tp2 and tp2×dp2
    against the one-device step from one initial state: the first step's
    loss, grad norm and every leaf's gathered gradient within the gates,
    the params after AdamW within TRAIN_PARAM_REL_TOL where the gradient
    is clearly non-zero; each shard holds exactly tree_bytes / n of every
    leaf split n ways; the planted faults (on tp2×dp2) above the gates.
    Then SHARD_TRAIN_TIMED steps per mesh from the one device's state
    after its first step (non-zero moments), placed on the mesh: timed,
    with their peak memory and one profiled step, each step's loss and
    grad norm within the gates of the one device's steps, and the
    optimizer faults above them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import placement as pl
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.launch import sharding as shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import TrainHParams, init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.tree import leaves

    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=SHARD_TRAIN_LAYERS)
    hp = TrainHParams(peak_lr=SHARD_TRAIN_LR, warmup=0, total_steps=16)
    shape = ShapeConfig("p13", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = lambda s: make_train_batch(cfg, shape, s, seed=0, device=DEVICE)
    one = build_model(cfg, device=DEVICE)
    init = init_train_state(one, torch.Generator(device=DEVICE).manual_seed(0), hp)
    b0 = batch(0)
    timed_batches = lambda: [batch(s) for s in range(1, 1 + SHARD_TRAIN_TIMED)]
    ref = grads_of(torch, one, init["params"], b0)
    step_one = make_train_step(one, hp)
    ref1, _ = step_one(init, b0)
    _, ms_one, gib_one, metrics_one = train_steps_timed(torch, step_one, ref1, timed_batches())
    prof_one = (profile_train_step(torch, step_one, ref1, batch(9)) if DEVICE == "cuda"
                else None)
    log(f"  one device ({cfg.n_layers} layers, B {TRAIN_BATCH} x S {TRAIN_SEQ}): first loss "
        f"{ref[0]:.6f}, grad norm {ref[1]:.6f}; {ms_one:.1f} ms/step (median of "
        f"{SHARD_TRAIN_TIMED}), peak {gib_one:.2f} GiB above the state; losses "
        + " ".join(f"{m['loss']:.6f}" for m in metrics_one))
    out = {"one": dict(loss=ref[0], grad_norm=ref[1], ms=ms_one, peak_gib=gib_one,
                       profile=prof_one, losses=[m["loss"] for m in metrics_one])}
    keep = None
    for name, mshape, axes in SHARD_TRAIN_MESHES:
        mesh = make_mesh(mshape, axes, device=DEVICE)
        bundle = build_model(cfg, None, mesh_dcfg(cfg, mesh), device=DEVICE)
        placed, sh = place_state(init, mesh)
        for x in leaves(placed["params"]):
            if isinstance(x, pl.Sharded) and pl.shard_bytes(x) != [
                    shard.tree_bytes(x) // len(x.pieces)] * len(x.pieces):
                raise AssertionError(f"{name}: a shard does not hold tree_bytes / n of {x}")
        split = sum(isinstance(x, pl.Sharded) and len(x.pieces) > 1
                    for x in leaves(placed["params"]))
        step = make_train_step(bundle, hp)
        measure = lambda: first_step_gaps(torch, bundle, step, placed, b0, ref, ref1)
        gaps = measure()
        faults = train_faults(torch, measure) if name == "tp2xdp2" else {}
        start = place_state(ref1, mesh)[0]
        if name == "tp2xdp2":
            for fault, wrong_mu in OPTIMIZER_FAULTS.items():
                faults[fault] = optimizer_fault(torch, step, start, timed_batches(), metrics_one,
                                                wrong_mu)
        st, ms, gib, metrics = train_steps_timed(torch, step, start, timed_batches())
        timed = metric_gaps(metrics, metrics_one)
        # tp2 x dp2's profile only: dp2's and tp2's went to pay for phase 12(e)'s time
        prof = (profile_train_step(torch, step, st, batch(9))
                if DEVICE == "cuda" and name == "tp2xdp2" else None)
        log(f"  {name}: first step |Δloss|/loss {gaps['loss']:.3g} (gate {TRAIN_LOSS_REL_TOL}), "
            f"|Δ grad norm|/norm {gaps['grad_norm']:.3g} (gate {TRAIN_GNORM_REL_TOL}), "
            f"gradients max over leaves of max|Δg|/max|g| {gaps['grad']:.4g} (gate "
            f"{TRAIN_GRAD_REL_TOL}), params after AdamW where |g| >= {TRAIN_GRAD_REL_TOL} max|g| "
            f"max|Δp|/max|p| {gaps['params']:.3g} (gate {TRAIN_PARAM_REL_TOL}); "
            f"{SHARD_TRAIN_TIMED} timed steps from its state vs the one device's: |Δloss|/loss "
            f"{timed['loss']:.3g}, |Δ grad norm|/norm {timed['grad_norm']:.3g} (gate "
            f"{TRAIN_TIMED_GNORM_REL_TOL}); {split} leaves "
            f"split, every shard holding tree_bytes / n; planted faults {json.dumps(faults)}; "
            f"{ms:.1f} ms/step (median of {SHARD_TRAIN_TIMED}; one device {ms_one:.1f}), peak "
            f"{gib:.2f} GiB above the state; losses " + " ".join(f"{m['loss']:.6f}" for m in metrics))
        if not (gaps["loss"] <= TRAIN_LOSS_REL_TOL and gaps["grad_norm"] <= TRAIN_GNORM_REL_TOL
                and gaps["grad"] <= TRAIN_GRAD_REL_TOL and gaps["params"] <= TRAIN_PARAM_REL_TOL
                and timed["loss"] <= TRAIN_LOSS_REL_TOL
                and timed["grad_norm"] <= TRAIN_TIMED_GNORM_REL_TOL):
            raise AssertionError(f"{name}: the sharded steps leave the one device's: {gaps}, "
                                 f"timed {timed}")
        if not all(f["loss"] > TRAIN_LOSS_REL_TOL
                   and f["grad_norm"] > (TRAIN_GNORM_REL_TOL if "grad" in f
                                         else TRAIN_TIMED_GNORM_REL_TOL)
                   and f.get("grad", math.inf) > TRAIN_GRAD_REL_TOL
                   and f.get("params", math.inf) > TRAIN_PARAM_REL_TOL for f in faults.values()):
            raise AssertionError(f"{name}: a gate does not see a planted fault: {faults}")
        if not all(math.isfinite(m["loss"]) for m in metrics):
            raise AssertionError(f"{name}: a non-finite loss: {metrics}")
        out[name] = dict(gaps, timed=timed, faults=faults, ms=ms, peak_gib=gib, profile=prof,
                         losses=[m["loss"] for m in metrics], split_leaves=split)
        if name == "tp2xdp2":
            keep = dict(state=st, shardings=sh, mesh=mesh)
        del placed, start, st, bundle, measure, step
        free(torch)
    del init, ref1, ref
    free(torch)
    return out, cfg, hp, keep


def ep_drop_shares(torch, x, router, cfg, n_tok, n_model):
    """Each (token shard, expert shard)'s dropped share of its routed
    (token, k) slots at ``cfg``'s capacity, and the one device's."""
    from repro_torch.models import moe

    E, k = cfg.n_experts, cfg.topk_experts
    share = lambda keep, sel: float((~keep[sel]).sum()) / max(int(sel.sum()), 1)
    _, eidx, _ = moe._route(x, {"router": router}, k)
    _, keep = moe.dispatch_slots(eidx, E, moe.capacity(x.shape[0], cfg))
    one = share(keep, torch.ones_like(keep))
    shards = {}
    for t, xt in enumerate(x.chunk(n_tok)):
        _, e_t, _ = moe._route(xt, {"router": router}, k)
        _, keep_t = moe.dispatch_slots(e_t, E, moe.capacity(xt.shape[0], cfg))
        for m in range(n_model):
            sel = (e_t.reshape(-1) // (E // n_model)) == m
            shards[f"t{t}m{m}"] = share(keep_t, sel)
    return one, shards


def sharded_train_granite(torch):
    """(b): granite-moe-1b-a400m (GRANITE_TRAIN_LAYERS layers) at tp2 with
    EP (16 experts per shard) and at tp2×dp2 with FSDP-stored experts.  At
    capacity NO_DROP_FACTOR the MoE output within MOE_Y_REL_TOL of
    ``moe_apply``'s on layer 0's weights and the first step's loss within
    TRAIN_LOSS_REL_TOL of the one-device step's; at the config's own factor
    each shard's dropped share beside the one device's, and EP's aux equal
    to the per-shard estimator from the same routing."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import placement as pl
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.launch import sharding as shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import TrainHParams, init_train_state
    from repro_torch.models import build_model, moe

    base = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=GRANITE_TRAIN_LAYERS)
    cfg8 = dataclasses.replace(base, capacity_factor=NO_DROP_FACTOR)
    hp = TrainHParams(peak_lr=SHARD_TRAIN_LR, warmup=0, total_steps=16)
    b0 = make_train_batch(cfg8, ShapeConfig("p13b", TRAIN_SEQ, TRAIN_BATCH, "train"), 0, seed=0,
                          device=DEVICE)
    one = build_model(cfg8, device=DEVICE)
    params = init_train_state(one, torch.Generator(device=DEVICE).manual_seed(0), hp)["params"]
    ref_loss = grads_of(torch, one, params, b0)[0]
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    p0 = {k: v[0] for k, v in params["layers"]["moe"].items()}
    # tokens leaning on expert 0 (shifted along its router column), so its
    # bucket overflows at the config's factor: iid tokens load every expert
    # within 1.25x of the mean and nothing drops
    lean = p0["router"][:, 0] / p0["router"][:, 0].norm()
    x = (torch.randn((TRAIN_BATCH * TRAIN_SEQ, base.d_model), generator=gen, device=DEVICE)
         + EXPERT_LEAN * base.d_model**0.5 * lean).to(torch.bfloat16)
    with torch.no_grad():
        y_ref, _ = moe.moe_apply(x, p0, cfg8)
    scale = float(y_ref.float().abs().max())
    out = {}
    for name, mshape, axes in (("tp2", (2,), ("model",)), ("tp2xdp2", (2, 2), ("data", "model"))):
        mesh = make_mesh(mshape, axes, device=DEVICE)
        n_tok = mesh.shape.get("data", 1)
        pe = {k: pl.place(v, pl.NamedSharding(mesh, shard.param_pspec(
            f"layers/moe/{k}", v.dim(), ("data",)))) for k, v in p0.items()}
        with torch.no_grad():
            y, _ = moe.moe_apply_ep(x, pe, cfg8, mesh=mesh, token_axes=("data",),
                                    model_axis="model")
            y_gap = float((y.float() - y_ref.float()).abs().max()) / scale
            own_one, own_shards = ep_drop_shares(torch, x, p0["router"], base, n_tok,
                                                 mesh.shape["model"])
            _, aux = moe.moe_apply_ep(x, pe, base, mesh=mesh, token_axes=("data",),
                                      model_axis="model")
            est = torch.stack([moe._aux(*moe._route(xt, {"router": p0["router"]},
                                                    base.topk_experts)[:2],
                                        base.n_experts, base.topk_experts)
                               for xt in x.chunk(n_tok)]).mean()
        aux_gap = abs(float(aux) - float(est)) / float(est)
        bundle = build_model(cfg8, None, mesh_dcfg(cfg8, mesh), device=DEVICE)
        placed = pl.place_tree(params, shard.param_shardings(params, mesh, ("data",)))
        loss = grads_of(torch, bundle, placed, b0)[0]
        loss_gap = abs(loss - ref_loss) / ref_loss
        log(f"  {name} (EP, {base.n_experts // mesh.shape['model']} experts per shard"
            f"{', experts FSDP-stored over data' if n_tok > 1 else ''}): at capacity "
            f"{NO_DROP_FACTOR} the MoE output max|Δy| {y_gap:.3g} of max|y| (gate "
            f"{MOE_Y_REL_TOL}), first-step loss |Δ|/loss {loss_gap:.3g} (gate "
            f"{TRAIN_LOSS_REL_TOL}); at the config's factor {base.capacity_factor}: dropped "
            f"share one device {own_one:.4f}, per shard {json.dumps(own_shards)}; aux "
            f"{float(aux):.6f} vs the per-shard estimator {float(est):.6f} (|Δ|/est "
            f"{aux_gap:.3g}, gate {MOE_AUX_REL_TOL})")
        if not (y_gap <= MOE_Y_REL_TOL and loss_gap <= TRAIN_LOSS_REL_TOL
                and aux_gap <= MOE_AUX_REL_TOL):
            raise AssertionError(f"granite {name}: y {y_gap}, loss {loss_gap}, aux {aux_gap}")
        out[name] = dict(y_gap=y_gap, loss_gap=loss_gap, drop_one=own_one, drop_shards=own_shards,
                         aux=float(aux), aux_estimator=float(est), aux_gap=aux_gap)
        del placed, pe, bundle
        free(torch)
    del params, one
    free(torch)
    return out


def compress_run(torch, cfg, hp):
    """(c): compress_grads on tp2×dp2 for 2 steps from the one-device
    state's init: finite, each tensor's 1-bit scale within
    COMPRESS_SCALE_REL_TOL of the one-device run's at every step."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import placement as pl
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.tree import leaves

    hp = dataclasses.replace(hp, compress_grads=True)
    shape = ShapeConfig("p13c", TRAIN_SEQ, TRAIN_BATCH, "train")
    one = build_model(cfg, device=DEVICE)
    init = init_train_state(one, torch.Generator(device=DEVICE).manual_seed(0), hp)
    orig = steps_mod.compress_decompress
    scales = []

    def recorded(grads, ef):
        q, e = orig(grads, ef)
        scales.append([float(x.abs().max()) for x in leaves(pl.gather_tree(q))])
        return q, e

    steps_mod.compress_decompress = recorded
    try:
        runs = {}
        mesh = make_mesh((2, 2), ("data", "model"), device=DEVICE)
        for name, bundle, state in (
                ("one", one, init),
                ("tp2xdp2", build_model(cfg, None, mesh_dcfg(cfg, mesh), device=DEVICE),
                 place_state(init, mesh)[0])):
            scales.clear()
            step = make_train_step(bundle, hp)
            losses = []
            for s in range(2):
                state, m = step(state, make_train_batch(cfg, shape, s, seed=0, device=DEVICE))
                losses.append(float(m["loss"]))
            runs[name] = dict(scales=[list(x) for x in scales], losses=losses)
            del state
            free(torch)
    finally:
        steps_mod.compress_decompress = orig
    gap = max(abs(a - b) / b for sa, sb in zip(runs["tp2xdp2"]["scales"], runs["one"]["scales"])
              for a, b in zip(sa, sb) if b > 0)
    log(f"  compress_grads, 2 steps: losses one device {runs['one']['losses']}, tp2xdp2 "
        f"{runs['tp2xdp2']['losses']}; each tensor's scale vs the one device's max |Δ|/scale "
        f"{gap:.3g} (gate {COMPRESS_SCALE_REL_TOL}) over {len(runs['one']['scales'][0])} tensors")
    if not (all(math.isfinite(x) for x in runs["tp2xdp2"]["losses"])
            and gap <= COMPRESS_SCALE_REL_TOL):
        raise AssertionError(f"compress_grads on tp2xdp2: scale gap {gap}, {runs}")
    return dict(scale_gap=gap, losses=runs["tp2xdp2"]["losses"],
                losses_one=runs["one"]["losses"])


def elastic_run(torch, cfg, hp, keep):
    """(d): (a)'s tp2×dp2 state saved, restored onto dp2 (``sharding=``)
    and onto one device: bit for bit the saved arrays; then ELASTIC_STEPS
    steps on each, within (a)'s gates of each other; then the train CLI at
    ``--model-axis 2 --reduced --steps 6`` with one fault at step 3 (and a
    checkpoint every 2 steps, so the restart resumes from step 2 onto the
    mesh) beside an uninterrupted run: ``restarts: 1`` and the same final
    loss.  Returns (the restored one-device params, the readings)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import placement as pl
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.tree import leaves

    shape = ShapeConfig("p13d", TRAIN_SEQ, TRAIN_BATCH, "train")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="p13_ckpt_", dir=os.path.join(HERE, "build"))
    out = {}
    try:
        t0 = time.perf_counter()
        saved = pl.gather_tree(keep["state"])
        CheckpointManager(ckdir).save(1, keep["state"])
        out["save_s"] = time.perf_counter() - t0
        dp2 = make_mesh((2,), ("data",), device=DEVICE)
        like = keep["state"]
        t0 = time.perf_counter()
        on_dp2 = CheckpointManager(ckdir).restore(1, like, sharding=place_state(saved, dp2)[1])
        on_one = CheckpointManager(ckdir).restore(1, saved)
        out["restore_s"] = time.perf_counter() - t0
        diff = sum(not torch.equal(a, b) for a, b in zip(leaves(saved),
                                                         leaves(pl.gather_tree(on_dp2))))
        diff += sum(not torch.equal(a, b) for a, b in zip(leaves(saved), leaves(on_one)))
        del saved, keep["state"]
        free(torch)
        runs = {}
        for name, state, dcfg in (("dp2", on_dp2, mesh_dcfg(cfg, dp2)), ("one", on_one, None)):
            step = make_train_step(build_model(cfg, None, dcfg, device=DEVICE), hp)
            ms = []
            for s in range(ELASTIC_STEPS):
                state, m = step(state, make_train_batch(cfg, shape, 10 + s, seed=0,
                                                        device=DEVICE))
                ms.append({k: float(v) for k, v in m.items()})
            runs[name] = (pl.gather_tree(state), ms)
            del state
        del on_dp2
        (p_dp2, m_dp2), (p_one, m_one) = runs["dp2"], runs["one"]
        gaps = dict(loss=max(abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(m_dp2, m_one)),
                    grad_norm=max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                                  for a, b in zip(m_dp2, m_one)),
                    params=abs_gap(torch, p_dp2["params"], p_one["params"]))
        bound = TRAIN_PARAM_BOUND * ELASTIC_STEPS
        log(f"  elastic: saved tp2xdp2 in {out['save_s']:.1f} s, restored onto dp2 and one "
            f"device in {out['restore_s']:.1f} s, {diff} leaves differing from the saved arrays; "
            f"{ELASTIC_STEPS} more steps, dp2 vs one device: |Δloss|/loss {gaps['loss']:.3g}, "
            f"|Δ grad norm|/norm {gaps['grad_norm']:.3g}, params max|Δ| {gaps['params']:.3g} "
            f"(bound {bound:.4g})")
        if diff or not (gaps["loss"] <= TRAIN_LOSS_REL_TOL
                        and gaps["grad_norm"] <= TRAIN_GNORM_REL_TOL and gaps["params"] <= bound):
            raise AssertionError(f"elastic restore: {diff} leaves differ, gaps {gaps}")
        out.update(gaps, leaves_differing=diff)
        params_one = p_one["params"]
        del runs, p_dp2
        free(torch)
        # the CLI, on the card, in processes of their own (both at once)
        cli, procs = {}, {}
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        t0 = time.perf_counter()
        for tag, extra in (("fault", ["--fail-at", "3"]), ("clean", [])):
            d = os.path.join(ckdir, "cli_" + tag)
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
                   "--reduced", "--model-axis", "2", "--steps", "6", "--ckpt-every", "2",
                   "--log-every", "1", "--device", DEVICE, "--ckpt-dir", d] + extra
            procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True, env=env)
        for tag, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode:
                raise AssertionError(f"train CLI ({tag}) exited {proc.returncode}: "
                                     f"{stderr[-2000:]}")
            lines = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
            cli[tag] = dict(done=lines[-1], last=lines[-2], s=time.perf_counter() - t0)
        log(f"  train --model-axis 2 --reduced --steps 6 --fail-at 3: {cli['fault']['done']}, "
            f"last loss {cli['fault']['last']['loss']!r} ({cli['fault']['s']:.1f} s); "
            f"uninterrupted {cli['clean']['last']['loss']!r} ({cli['clean']['s']:.1f} s)")
        if not (cli["fault"]["done"]["restarts"] == 1 and cli["fault"]["last"]["step"] == 5
                and cli["fault"]["last"]["loss"] == cli["clean"]["last"]["loss"]):
            raise AssertionError(f"the CLI's recovery onto the mesh: {cli}")
        out["cli"] = {k: dict(v["done"], last_loss=v["last"]["loss"]) for k, v in cli.items()}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return params_one, out


def serve_trained(torch, cfg, params):
    """(e): the restored params (one device) served by the one-device paged
    engine and by ``Engine.build(mesh=tp2)`` (paged one_pass, bs 32, phase
    4's prompts): prefill logits and SERVE_TRAINED_STEPS teacher-forced
    decode steps bit for bit; K3 = K4 = FIER layers × steps × 2 shards on
    tp2, and nothing else."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    params = build_model(cfg, device=DEVICE).compute_params(params)
    n_fier = cfg.n_layers - SKIP
    base = sharded_drive(torch, cfg, params, None, PROMPTS, SERVE_TRAINED_STEPS, check=False,
                         timed=0)
    del base["eng"], base["cache"]
    got = sharded_drive(torch, cfg, params, make_mesh((2,), ("model",), device=DEVICE), PROMPTS,
                        SERVE_TRAINED_STEPS, forced=base["toks"], check=False, timed=0)
    del got["eng"], got["cache"]
    bitwise = same(torch, got["pre"], base["pre"]) and same(torch, got["logits"], base["logits"])
    gap = float((got["logits"] - base["logits"]).abs().max())
    log(f"  served on tp2 vs one device: prefill logits and {SERVE_TRAINED_STEPS} teacher-forced "
        f"decode steps bit for bit {bitwise} (max |Δlogit| {gap:.3g}); launches {got['counts']}")
    check_launches(got["counts"], PAGED_KERNELS, n_fier * SERVE_TRAINED_STEPS * 2)
    if not bitwise:
        raise AssertionError(f"the trained model served on tp2 differs: {gap}")
    return dict(bitwise=bitwise, launches=got["counts"])


def sharded_train_path(torch):
    """Phase 13: (a) olmo-1b on dp2, tp2, tp2×dp2, (d) elastic restore and
    the CLI, (e) serve what the mesh trained through K3/K4 per shard, (c)
    compress_grads, (b) granite-moe with EP."""
    t0 = time.perf_counter()
    out, walls = {}, {}

    def part(key, title, fn, *a):
        log(f"  {title}")
        t = time.perf_counter()
        res = fn(torch, *a)
        walls[key] = round(time.perf_counter() - t, 1)
        return res

    out["olmo"], cfg, hp, keep = part("olmo", "(a) olmo-1b, depth cut, on dp2, tp2 and tp2 x dp2",
                                      sharded_train_olmo)
    params, out["elastic"] = part("elastic", "(d) elastic restore and the train CLI", elastic_run,
                                  cfg, hp, keep)
    del keep
    free(torch)
    out["serve"] = part("serve", "(e) serve what the mesh trained, tp2 vs one device",
                        serve_trained, cfg, params)
    del params
    free(torch)
    out["compress"] = part("compress", "(c) compress_grads on tp2 x dp2", compress_run, cfg, hp)
    out["granite"] = part("granite", "(b) granite-moe-1b-a400m with expert parallelism",
                          sharded_train_granite)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 13 wall time {out['wall_s']:.1f} s: {walls}")
    return out


# ------------------------------------------------------------ phase 14

# Every config of the registry at ``reduced_config`` (d_head 16; the
# hybrid's 32), as the CPU parity tests drive them: 2
# slots of 64 tokens, serving_policy(budget=16, group=8, skip_layers=1)
# (sink 4, recent 64: the recent window covers the whole capacity, so K1's
# selection is the guard rails' first 16 positions and K2 attends them),
# prompts 48 and 33 tokens (llava: 8 vision embeddings before them), token
# arrays padded to the capacity (a multiple of the ssm chunk), 8 greedy
# tokens.
REDUCED_SLOTS, REDUCED_CAPACITY, REDUCED_NEW = 2, 64, 8
REDUCED_PROMPTS = (48, 33)
REDUCED_POLICY = dict(budget=16, group=8, skip_layers=1)
# Card vs CPU, as fractions of max|logit|, set as phases 3, 9 and 10 set
# theirs: between the largest sound reading and the smallest planted
# fault's (PERF.md §6).  The first decode step from one cache (the card's
# prefill cache, copied to the CPU for the CPU's step): the kernels and the
# decode's own GEMMs, and the planted faults are read here (sound: below
# 2.5e-7 in all ten configs; faults from 0.0534).
REDUCED_DECODE_REL_TOL = 1e-5
# The prefill's last logits, and the first step from each side's own
# prefill cache: REDUCED_LOGIT_REL_TOL (sound: below 2.5e-7), but
# REDUCED_ROUNDED_REL_TOL where the prefill's bf16 activations round apart
# on the card and on the CPU (sparse elements, each up to about one bf16
# step of its tensor's max where the caches first differ; PERF.md §6): at
# the last position's logits (REDUCED_ROUNDED_PREFILL; sound: 0.0027 to
# 0.0110), and in rows of the cache that the step reads
# (REDUCED_ROUNDED_CACHE: whisper-small's cross K/V and decoder K/V,
# zamba2-7b's conv and SSM states and attention K/V; sound: 0.0045 to
# 0.0051).
REDUCED_LOGIT_REL_TOL = 1e-5
REDUCED_ROUNDED_REL_TOL = 0.02
REDUCED_ROUNDED_PREFILL = ("whisper-small", "llava-next-mistral-7b", "olmo-1b", "minicpm-2b",
                           "zamba2-7b")
REDUCED_ROUNDED_CACHE = ("whisper-small", "zamba2-7b")
# (b): reduced olmo-1b and llava through ContinuousScheduler on a slab and
# a paged engine (bs 8, sink 0, recent 0, so K1/K3 select), 4 requests
REDUCED_STREAM_ARCHS = ("olmo-1b", "llava-next-mistral-7b")
# (d): the passkey example's training steps (its default, as the JAX
# example's; at 400 every policy reads 0.25)
PASSKEY_STEPS = 600


def reduced_tol(arch) -> tuple[float, float]:
    """Phase 14(a)'s gates on the prefill's logits and on the first step
    from each side's own prefill cache."""
    return tuple(REDUCED_ROUNDED_REL_TOL if arch in rounded else REDUCED_LOGIT_REL_TOL
                 for rounded in (REDUCED_ROUNDED_PREFILL, REDUCED_ROUNDED_CACHE))


def cache_diffs(torch, got, ref, lengths) -> dict:
    """Where two decode caches differ: {path: {n: elements that differ, of:
    elements, rel: max|got − ref| / max|ref|, ulp: the largest distance in
    bf16 units in the last place (bf16 tensors); for a slab's K/V [L, B,
    capacity, ...], read: of n, those at positions below the row's length
    ``lengths`` [B], and first: the lowest such position}} over the tensors
    of the two trees (dicts, and the metadata dataclasses); empty where they
    are equal bit for bit."""
    import dataclasses

    out = {}
    B = lengths.shape[0]

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}" if path else k)
        elif dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                walk(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        elif isinstance(a, torch.Tensor):
            a = a.to(b.device)
            ne = a != b
            n = int(ne.sum())
            if not n:
                return
            d = dict(n=n, of=a.numel(), rel=float(
                (a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)))
            if a.dtype == torch.bfloat16:
                d["ulp"] = int((a.view(torch.int16).int() - b.view(torch.int16).int())
                               .abs().max())
            if path.rsplit("/", 1)[-1] in ("k", "v") and a.dim() >= 3 and a.shape[1] == B:
                pos = torch.arange(a.shape[2])
                read = (pos[None, :] < lengths.cpu()[:, None]).reshape(
                    1, B, -1, *[1] * (a.dim() - 3)).to(ne.device)
                d["read"] = int((ne & read).sum())
                at = (ne & read).flatten(3).any(-1).any(0).any(0).cpu()
                d["first"] = int(pos[at][0]) if bool(at.any()) else None
            out[path] = d

    walk(got, ref, "")
    return out


def reduced_drive(torch, arch):
    """One reduced config on the card and on the CPU, the same weights
    (initialised on the card from a seeded ``torch.Generator``, copied to
    the CPU): the prefill (its last logits, and where the two caches differ,
    ``cache_diffs``) and the first decode step (every FIER layer's K1/K2
    held to their plain versions on the engine's own tensors,
    ``checked_kernels``).  The card's first-step logits against the CPU's
    fed the same token from the card's prefill cache (the decode alone,
    REDUCED_DECODE_REL_TOL) and from its own (the two paths whole,
    ``reduced_tol``), and a planted fault (K2 fed idx+1; the attention-free
    mamba2: each row decoding from the next row's SSM state) read against
    the first; then ``generate`` of REDUCED_NEW greedy tokens on the card
    with K1/K2 launched (FIER layers) x (REDUCED_NEW - 1) times and no other
    kernel.  The gates are checked last, so every reading is logged.
    Returns what it measured."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import sparse_attention as sa
    from repro_torch.models.transformer import tree_map
    from repro_torch.serving import Engine, serving_policy

    cfg = reduced_config(arch)
    pol = serving_policy(**REDUCED_POLICY)
    kw = {"max_positions": 128} if cfg.family == "encdec" else {}
    build = lambda dev: Engine.build(cfg, n_slots=REDUCED_SLOTS, capacity=REDUCED_CAPACITY,
                                     policy=pol, device=dev, **kw)
    eng, cpu = build(DEVICE), build("cpu")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    raw = eng.bundle.init(gen)
    params = eng.compute_params(raw)
    params_c = cpu.compute_params(tree_map(lambda a: a.cpu(), raw))
    n_fier = fier_layers(cfg, REDUCED_POLICY["skip_layers"])
    rng = np.random.default_rng(14)
    nv = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    width = max(REDUCED_PROMPTS) if nv else REDUCED_CAPACITY
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (REDUCED_SLOTS, width))).to(DEVICE)
    lengths = torch.tensor([n + nv for n in REDUCED_PROMPTS], dtype=torch.int32, device=DEVICE)
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = (torch.randn((REDUCED_SLOTS, nv, cfg.d_model), generator=gen,
                                               device=DEVICE) * cfg.d_model**-0.5
                                   ).to(torch.bfloat16)
    if cfg.family == "encdec":
        extras["frames"] = torch.randn((REDUCED_SLOTS, cfg.enc_ctx, cfg.d_model), generator=gen,
                                       device=DEVICE)
    batch = {"tokens": toks, "lengths": lengths, **extras}
    batch_c = {k: v.cpu() for k, v in batch.items()}
    out = dict(arch=arch, family=cfg.family, d_head=cfg.d_head, fier_layers=n_fier,
               rep=cfg.n_heads // cfg.n_kv_heads if cfg.n_kv_heads else 0)

    lg0, cache = eng.prefill_batch(params, batch)
    lg0_c, cache_c = cpu.prefill_batch(params_c, batch_c)
    diffs = cache_diffs(torch, cache, cache_c, lengths)
    cache_x = clone_cache(torch, cache, "cpu")
    tok0 = torch.argmax(lg0, -1).to(torch.int32)
    V = cfg.vocab
    errs = new_errs()
    retrieve, attend = checked_kernels(torch, errs, keep_plain=False)

    def step(retrieve_fn=None, attend_fn=None, c=None):
        saved = ops.fier_retrieve, ops.fier_attend_selected
        ops.fier_retrieve = retrieve_fn or saved[0]
        ops.fier_attend_selected = attend_fn or saved[1]
        try:
            _, lg, _ = eng.decode(params, tok0, clone_cache(torch, cache if c is None else c))
            sync(torch)
        finally:
            ops.fier_retrieve, ops.fier_attend_selected = saved
        return lg[:, :V].float().cpu()

    lg1 = step(retrieve, attend)
    _, lg1_x, _ = cpu.decode(params_c, tok0.cpu(), cache_x)
    _, lg1_c, _ = cpu.decode(params_c, tok0.cpu(), cache_c)
    lg1_x, lg1_c = lg1_x[:, :V].float(), lg1_c[:, :V].float()
    if errs["calls"] != n_fier:
        raise AssertionError(f"{arch}: the checked step ran {errs['calls']} FIER layers, "
                             f"not {n_fier}")
    if n_fier:
        shifted = lambda q, K, V_, idx, lengths=None, **k: sa.fier_attend_selected(
            q, K, V_, (idx + 1) % K.shape[1], lengths, **k)
        lg_f = step(attend_fn=shifted)
        fault_name = "K2 fed idx+1"
    else:
        bad = clone_cache(torch, cache)
        bad["layers"]["ssm"] = bad["layers"]["ssm"].roll(1, dims=1)
        lg_f = step(c=bad)
        fault_name = "each row from the next row's SSM state"
    s1 = float(lg1_c.abs().max())
    pre_tol, tol = reduced_tol(arch)
    pre_gap = float((lg0[:, :V].float().cpu() - lg0_c[:, :V].float()).abs().max())
    dec_gap = float((lg1 - lg1_x).abs().max())
    gap = float((lg1 - lg1_c).abs().max())
    fault = float((lg_f - lg1_x).abs().max())
    top1 = int((lg1.argmax(-1) == lg1_c.argmax(-1)).sum())
    out.update(prefill_gap=pre_gap / s1, decode_gap=dec_gap / s1, first_step_gap=gap / s1,
               fault_gap=fault / s1, max_logit=s1, cache_diffs=diffs, tols=(pre_tol, tol),
               k1_tau_err=errs["k1_tau"], k2_rel=errs["k2_rel"])
    if n_fier:
        log_errs(errs, "K1", "K2")
    log(f"  prefill caches: {diffs or 'equal bit for bit'}")
    log(f"  card vs CPU (max |logit| {s1:.4g}): first decode step from one cache "
        f"{dec_gap / s1:.4g} of max|logit| (gate {REDUCED_DECODE_REL_TOL}); prefill "
        f"{pre_gap / s1:.4g} (gate {pre_tol}), first decode step from each side's own "
        f"{gap / s1:.4g} (top-1 {top1}/{REDUCED_SLOTS}; gate {tol}); planted fault, "
        f"{fault_name}: {fault / s1:.4g}")
    del cache, cache_c, cache_x

    reset_launch_counts()
    gen_toks = eng.generate(params, toks, lengths, REDUCED_NEW, extras=extras or None)
    sync(torch)
    counts = launch_counts()
    out["launches"] = {k: counts[k] for k in SLAB_KERNELS}
    log(f"  generate {REDUCED_NEW} tokens: launches {out['launches']} = {n_fier} x "
        f"{REDUCED_NEW - 1} decode steps")
    check_launches(counts, SLAB_KERNELS if n_fier else (), n_fier * (REDUCED_NEW - 1))
    if not (torch.equal(gen_toks[:, 0], tok0) and bool(((gen_toks >= 0) & (gen_toks < V)).all())):
        raise AssertionError(f"{arch}: generated tokens {gen_toks.tolist()} wrong")
    if not fault > tol * s1:
        raise AssertionError(f"{arch}: the first-step gates do not see the planted fault "
                             f"({fault_name}): {fault / s1:.4g} <= {tol}")
    if not (torch.isfinite(lg1).all() and dec_gap <= REDUCED_DECODE_REL_TOL * s1):
        raise AssertionError(f"{arch}: first step from one cache, card vs CPU "
                             f"{dec_gap / s1:.4g} > {REDUCED_DECODE_REL_TOL}")
    if not (pre_gap <= pre_tol * s1 and gap <= tol * s1):
        raise AssertionError(f"{arch}: card vs CPU, prefill {pre_gap / s1:.4g} (gate "
                             f"{pre_tol}), first step from each side's own prefill "
                             f"{gap / s1:.4g} (gate {tol})")
    del eng, cpu, params, params_c, raw
    return out


def reduced_stream(torch, arch):
    """Reduced ``arch`` through ``ContinuousScheduler`` on a slab and on a
    paged engine (bs 8), 4 requests on 2 slots: the tokens equal, each run
    launching only its layout's kernels, (FIER layers) x (its decode
    steps) times; the paged engine audits clean with no block in use."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousScheduler, Engine, Request

    cfg = reduced_config(arch)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab, 20 + 7 * i).tolist() for i in range(4)]
    # a Request carries its run's state (out, done): fresh ones for each run
    new_reqs = lambda: [Request(rid=i, tokens=list(p), max_new=6 + i)
                        for i, p in enumerate(prompts)]
    params = None
    outs, counts = {}, {}
    for layout, kernels in (("slab", SLAB_KERNELS), ("paged", PAGED_KERNELS)):
        pol = PolicyConfig(kind="fier", budget=16, group=8, skip_layers=1, pipeline="one_pass",
                           layout=layout, block_size=8)
        eng = Engine(build_model(cfg, pol, device=DEVICE), n_slots=REDUCED_SLOTS,
                     capacity=REDUCED_CAPACITY)
        if params is None:
            params = eng.bundle.init(torch.Generator(device=DEVICE).manual_seed(0))
        reset_launch_counts()
        sched = ContinuousScheduler(eng, eng.compute_params(params), pad_prompt_to=16)
        outs[layout] = dict(sched.run(new_reqs()))
        sync(torch)
        got = launch_counts()
        check_launches(got, kernels, fier_layers(cfg, pol.skip_layers) * sched.steps)
        counts[layout] = {k: got[k] for k in kernels}
        if layout == "paged":
            eng.audit()
            if eng.allocator.n_in_use:
                raise AssertionError(f"{arch}: {eng.allocator.n_in_use} blocks in use at the end")
        log(f"  {layout}: {sched.steps} decode steps, launches {counts[layout]}")
    lens = [len(outs["slab"].get(i, ())) for i in range(4)]
    if outs["paged"] != outs["slab"] or lens != [6, 7, 8, 9]:
        raise AssertionError(f"{arch}: paged tokens {outs['paged']} differ from slab "
                             f"{outs['slab']}")
    log(f"  {arch}: paged tokens equal to slab for {len(prompts)} requests")
    return counts


def serve_cli(torch):
    """``repro_torch.launch.serve.main`` at ``--reduced``, slab (the
    reference pipeline, as the reference's CLI serves the slab: no kernel)
    and ``--paged`` (one_pass: K3/K4 once per FIER layer and decode step),
    on the card."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    n_fier = fier_layers(reduced_config("olmo-1b"), 1)  # the CLI's skip at --reduced
    out = {}
    for extra, kernels in (([], ()), (["--paged"], PAGED_KERNELS)):
        reset_launch_counts()
        rep = serve.main(["--arch", "olmo-1b", "--reduced", "--device", DEVICE, *extra])
        sync(torch)
        counts = launch_counts()
        check_launches(counts, kernels, n_fier * rep["decode_steps"])
        if rep["tokens"] != 12 * 16:
            raise AssertionError(f"serve {extra}: {rep['tokens']} tokens, not 12 x 16")
        out["paged" if extra else "slab"] = dict(rep, launches={k: counts[k] for k in kernels})
    return out


def load_example(name):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_on_card(torch):
    """The four ``examples/*_torch.py`` in this process on the card:
    quickstart (the reference pipeline: no kernel), serve_longcontext
    (K1/K2 once per FIER layer and decode step, every request served
    whole), passkey (PASSKEY_STEPS training steps, then the four policies'
    accuracies and SLM's at skip_layers 0, reported, not gated; reference
    pipelines: no kernel) and train_tiny_lm (its 60 steps with crashes at
    25 and 45: 2 restarts, and the final checkpoint's loss on held-out
    batches below the initial weights')."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model

    out = {}
    reset_launch_counts()
    full, fier, agree = load_example("quickstart_torch").run(DEVICE)
    sync(torch)
    check_launches(launch_counts(), (), 0)
    out["quickstart"] = dict(agreement=agree, shape=tuple(full.shape))

    ex = load_example("serve_longcontext_torch")
    reset_launch_counts()
    outs, sched, wall = ex.run(DEVICE)
    sync(torch)
    counts = launch_counts()
    bundle = sched.engine.bundle
    check_launches(counts, SLAB_KERNELS,
                   fier_layers(bundle.cfg, bundle.policy.skip_layers) * sched.steps)
    want = {r.rid: r.max_new for r in ex.requests(sched.engine.bundle.cfg.vocab)}
    if {rid: len(v) for rid, v in outs.items()} != want:
        raise AssertionError(f"serve_longcontext: outputs {outs}")
    out["serve_longcontext"] = dict(steps=sched.steps, wall_s=wall,
                                    tokens=sum(len(v) for v in outs.values()),
                                    occupancy=sched.mean_occupancy,
                                    launches={k: counts[k] for k in SLAB_KERNELS})

    ex = load_example("passkey_demo_torch")
    sync(torch)
    t0 = time.perf_counter()
    cfg, params = ex.train_tiny_lm(DEVICE, steps=PASSKEY_STEPS, cache_dir=None)
    sync(torch)
    train_s = time.perf_counter() - t0
    reset_launch_counts()
    res = ex.evaluate(cfg, params, DEVICE)
    sync(torch)
    check_launches(launch_counts(), (), 0)
    # SLM at skip_layers 0: the demo's policies leave layer 0 reading every
    # cached token (SKIP 1), through which a decode step can still reach the
    # passkey; here layer 0 evicts too (reference pipeline: no kernel)
    batch, answers = ex.make_passkey_batch(cfg, 4, ex.SEQ, seed=7, step=0, depth=0.3,
                                           device=DEVICE)
    pol = dataclasses.replace(ex.policy_bundle(cfg, "slm", DEVICE).policy, skip_layers=0)
    slm0 = build_model(cfg, pol, device=DEVICE)
    got = ex.answer(slm0, params, batch["tokens"][:, : ex.SEQ - ex.N_DIGITS])
    sync(torch)
    check_launches(launch_counts(), (), 0)
    out["passkey"] = dict(train_s=train_s, steps=PASSKEY_STEPS,
                          accuracy={k: acc for k, (_, acc) in res.items()},
                          slm_skip0_accuracy=float((got == answers).all(1).float().mean()),
                          slm_skip0_digits=got.tolist(), answers=answers.tolist())
    log(f"  passkey: {PASSKEY_STEPS} steps in {train_s:.1f} s; batch accuracy "
        f"{out['passkey']['accuracy']}; slm at skip_layers 0: "
        f"{out['passkey']['slm_skip0_accuracy']} (digits {got.tolist()}, true "
        f"{answers.tolist()})")

    ex = load_example("train_tiny_lm_torch")
    ckpt = tempfile.mkdtemp(prefix="repro_torch_example_ckpt_")
    try:
        res = ex.run(ex.command(DEVICE, ckpt))
        res["held_before"], res["held_after"] = ex.held_losses(DEVICE, ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["train_tiny_lm"] = {k: res[k] for k in ("restarts", "resumed_from", "first_loss",
                                                "last_loss", "held_before", "held_after",
                                                "wall_s")}
    log(f"  train_tiny_lm: restarts {res['restarts']} (resumed from {res['resumed_from']}), "
        f"logged loss step 0 {res['first_loss']:.4f}, last {res['last_loss']:.4f}; held-out "
        f"loss {res['held_before']:.4f} -> {res['held_after']:.4f}")
    if not (res["done"] and res["restarts"] == 2 and res["held_after"] < res["held_before"]):
        raise AssertionError(f"train_tiny_lm: {res}")
    return out


def reduced_path(torch):
    """Phase 14: (a) every config of the registry at ``reduced_config`` on
    the card against the CPU, (b) reduced olmo-1b and llava paged vs slab
    through the scheduler, (c) the serve CLI at ``--reduced``, (d) the four
    ``_torch`` examples."""
    import gc

    from repro_torch.configs import ARCHS

    t0 = time.perf_counter()
    out = {"configs": {}, "stream": {}}
    for arch in ARCHS:
        log(f"  (a) [{arch}] reduced, {REDUCED_SLOTS} slots x {REDUCED_CAPACITY}")
        out["configs"][arch] = reduced_drive(torch, arch)
        gc.collect()
    for arch in REDUCED_STREAM_ARCHS:
        log(f"  (b) [{arch}] reduced, ContinuousScheduler, slab and paged")
        out["stream"][arch] = reduced_stream(torch, arch)
    log("  (c) python -m repro_torch.launch.serve --arch olmo-1b --reduced [--paged]")
    out["serve"] = serve_cli(torch)
    log("  (d) the four examples/*_torch.py")
    out["examples"] = examples_on_card(torch)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 14 wall time {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------ phase 15

# olmo-1b at full width and depth with other attention geometries (through
# dataclasses.replace; no registry config has them): name -> (n_heads,
# n_kv_heads, d_head).  G1 is gemma-2b's attention (8 x 256 = 2048, rep 8),
# G2 multi-query (32 x 64, rep 32), G3 phi-3-mini's d_head at qwen2-7b's
# ratio (21 x 96 = 2016, rep 7).
ANY_GEOMETRIES = {"G1": (8, 1, 256), "G2": (32, 1, 64), "G3": (21, 3, 96)}
ANY_STEPS = 8
# Phase 15's first-step gates, as fractions of max|logit|, set as phase 3's
# were: between the largest sound reading and the smallest planted fault
# (PERF.md §6; "NVIDIA H100 80GB HBM3, 700.00 W").  Phase 3's
# 0.015 / 0.02 sit below these geometries' sound readings: per layer the
# kernels agree with their plain versions as at phase 3, but these models
# carry an f32 summation-order difference about twice as far
# (``f64_step_gap`` reads how far).
ANY_PLAIN_REL_TOL = 0.018  # sound G1 0.01444, G2 0.01651, G3 0.01371; faults from 0.02031
ANY_REF_REL_TOL = 0.023    # sound G1 0.01809, G2 0.02060, G3 0.02005; faults from 0.02630


def f64_step_gap(torch, eng, params, tok0, cache, lg1_plain, vocab):
    """The first decode step from a copy of ``cache`` with K1's plain
    version and K2's plain version computed in f64 (the output cast to
    f32), against ``lg1_plain``, the same step with both plain versions in
    f32: how far the model carries an f32 summation-order difference in K2
    alone through the step's bf16 roundings (no kernel launches)."""
    from repro_torch.core.retrieval import NEG_INF, gather_kv
    from repro_torch.kernels import fused_retrieval as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_attention as sa

    def retrieve(q, codes, scale, zero, lengths, budget, *, block_table=None, plan_rows=None,
                 **sel):
        return fr.fier_retrieve_plain(q, codes, scale, zero, lengths, budget, **sel)

    def attend(q, K, V, idx, lengths=None, *, block_table=None, plan_rows=None):
        ks, vs = gather_kv(K, V, idx)
        s = torch.einsum("bhrd,bkhd->bhrk", q.double(), ks.double()) / q.shape[-1] ** 0.5
        valid = (idx < lengths.to(idx.dtype)[:, None, None])[:, :, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        w = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), torch.zeros_like(s))
        out = torch.einsum("bhrk,bkhd->bhrd", w, vs.double())
        return (out / w.sum(-1, keepdim=True).clamp(min=1e-30)).to(torch.float32)

    ops.fier_retrieve, ops.fier_attend_selected = retrieve, attend
    try:
        _, lg, _ = eng.decode(params, tok0, clone_cache(torch, cache))
        sync(torch)
    finally:
        ops.fier_retrieve, ops.fier_attend_selected = fr.fier_retrieve, sa.fier_attend_selected
    return float((lg[:, :vocab] - lg1_plain).abs().max())


def any_heads_drive(torch, name, geometry):
    """One geometry of phase 15: the slab one_pass engine's first decode
    step (phase 3's prompts) within ANY_PLAIN_REL_TOL of the plain versions'
    step and ANY_REF_REL_TOL of the reference pipeline's
    (``first_step_checks``, its planted faults above them; ``f64_step_gap``
    read beside it), the two_pass engine's first step from the same
    prefill cache (K6, K7, K2 14 times each) within the same gates, then
    ``paged_vs_slab`` for ANY_STEPS greedy steps: tokens and the first
    logits equal, each engine its own kernels 14 × steps and nothing else,
    the slab engine's steps profiled."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, serving_policy

    t0 = time.perf_counter()
    n_heads, n_kv, d_head = geometry
    cfg = dataclasses.replace(get_config("olmo-1b"), n_heads=n_heads, n_kv_heads=n_kv,
                              d_head=d_head)
    log(f"  [{name}] olmo-1b, {cfg.n_layers} layers, d_model {cfg.d_model}: {n_heads} query "
        f"heads, {n_kv} kv heads, d_head {d_head} (rep {n_heads // n_kv})")
    slab = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY, device=DEVICE)
    pol = slab.bundle.policy
    if (pol.kind, pol.pipeline, pol.layout, pol.budget) != ("fier", "one_pass", "slab", BUDGET):
        raise AssertionError(f"Engine.build's default policy is {pol}")
    n_fier = cfg.n_layers - pol.skip_layers
    params = slab.bundle.init(torch.Generator(device=DEVICE).manual_seed(0))
    params = slab.compute_params(params)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (SLOTS, max(PROMPTS)))).to(DEVICE)
    lengths = torch.tensor(PROMPTS, dtype=torch.int32, device=DEVICE)
    batch = {"tokens": prompts, "lengths": lengths}

    ref = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY, device=DEVICE,
                       policy=serving_policy(budget=BUDGET, pipeline="reference"))
    lg_ref, cache = ref.prefill_batch(params, batch)
    tok0 = torch.argmax(lg_ref, -1).to(torch.int32)
    _, lg1_ref, _ = ref.decode(params, tok0, cache)
    del ref, cache
    lg0, cache = slab.prefill_batch(params, batch)
    if not torch.equal(lg0, lg_ref):
        raise AssertionError(f"{name}: prefill logits differ between one_pass and reference")
    errs, lg1 = first_step_checks(torch, slab, params, tok0, cache, lg1_ref, cfg.vocab,
                                  kv_roll=n_kv > 1, tols=(ANY_PLAIN_REL_TOL, ANY_REF_REL_TOL))
    floor = f64_step_gap(torch, slab, params, tok0, cache, errs["lg1_plain"], cfg.vocab)
    log(f"  the plain versions' step with K2's plain version in f64: max |Δlogit| "
        f"{floor:.4g} from the f32 plain step (the model's amplification of an f32 sum "
        f"order; the kernels' step reads {errs['gaps']['plain']:.4g})")
    errs["gaps"]["f64_floor"] = floor

    # the two_pass engine's first step from a copy of the same prefill cache
    two = Engine.build(cfg, n_slots=SLOTS, capacity=CAPACITY, device=DEVICE,
                       policy=serving_policy(budget=BUDGET, pipeline="two_pass"))
    reset_launch_counts()
    _, lg2, _ = two.decode(params, tok0, clone_cache(torch, cache))
    sync(torch)
    two_counts = launch_counts()
    check_launches(two_counts, TWO_PASS_KERNELS, n_fier)
    del two, cache
    s1 = float(lg1_ref[:, :cfg.vocab].abs().max())
    lg2 = lg2[:, :cfg.vocab]
    two_gaps = dict(one_pass=float((lg2 - lg1).abs().max()),
                    plain=float((lg2 - errs["lg1_plain"]).abs().max()),
                    ref=float((lg2 - lg1_ref[:, :cfg.vocab]).abs().max()))
    log(f"  two_pass first step: launches {two_counts}; max |Δlogit| vs one_pass "
        f"{two_gaps['one_pass']:.4g}, vs plain versions {two_gaps['plain']:.4g}, vs reference "
        f"{two_gaps['ref']:.4g} (gates {ANY_PLAIN_REL_TOL * s1:.4g}, "
        f"{ANY_REF_REL_TOL * s1:.4g})")
    if not (two_gaps["plain"] <= ANY_PLAIN_REL_TOL * s1
            and two_gaps["ref"] <= ANY_REF_REL_TOL * s1 and torch.isfinite(lg2).all()):
        raise AssertionError(f"{name}: the two_pass first step is outside the gates: {two_gaps}")

    runs = {}
    paged_vs_slab(torch, cfg, params, slab, prompts=PROMPTS, steps=ANY_STEPS, profiles=runs,
                  profile_paged=False)
    del slab, params, lg0, lg1, lg2, lg1_ref, lg_ref
    torch.cuda.empty_cache()
    out = dict(geometry=dict(n_heads=n_heads, n_kv_heads=n_kv, d_head=d_head),
               gaps=errs["gaps"], k1_tau_err=errs["k1_tau"], k2_err=errs["k2"],
               two_pass=dict(gaps=two_gaps, launches=two_counts), wall_s=time.perf_counter() - t0)
    for layout, r in runs.items():
        prof = r["profile"] or {}
        out[layout] = dict(launches=r["launches"], ms_step=r["ms_step"],
                           busy_ms=prof.get("busy_ms"), wall_ms=prof.get("wall_ms"),
                           kernels=prof.get("port"))
        busy = (f"device busy {prof['busy_ms']:.3f} ms/step; per launch " + ", ".join(
            f"{n} {v['ms_per_launch']:.4f} ms" for n, v in prof["port"].items())
            if prof else "not profiled")
        log(f"  [{name}] {layout}: decode {r['ms_step']:.2f} ms/step (median of {ANY_STEPS}), "
            f"{busy}")
    log(f"  [{name}] {out['wall_s']:.1f} s")
    return out


def any_heads_path(torch):
    """Phase 15: olmo-1b at full width and depth with ANY_GEOMETRIES, each
    through ``any_heads_drive``."""
    t0 = time.perf_counter()
    out = {name: any_heads_drive(torch, name, g) for name, g in ANY_GEOMETRIES.items()}
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 15 wall time {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------ phase 16

# The registry's two widest configs at full width, depth cut to fit one
# card (2 dense skip layers + 6 FIER layers; whole, they hold 208 and 470 GB
# of bf16 weights): command-r-plus-104b (d_model 12288, 96 heads on 8 kv
# heads of 128, d_ff 33792, a tied 256,000-word head) and qwen3-moe-235b-a22b
# (d_model 4096, 64 heads on 4 kv heads of 128, 128 experts top-8 of d_ff
# 1536, an untied 151,936-word head), both with bf16 params.  Their first
# steps read 0.01134 and 0.006103 of max|logit| from the plain versions',
# their planted faults 0.0760-0.1278 (PERF.md §6): phase 9's gate
# FAMILY_LOGIT_REL_TOL holds them.
WIDE_ARCHS = ("command-r-plus-104b", "qwen3-moe-235b-a22b")
WIDE_LAYERS = 8
WIDE_MAX_NEW = 16


def wide_config(arch):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=WIDE_LAYERS)


def wide_path(torch):
    """Phase 16: command-r-plus-104b and qwen3-moe-235b-a22b at full width
    and WIDE_LAYERS layers through ``family_drive`` with every check
    (reference prefill, first step, generate, paged vs slab), each freed
    before the next."""
    import gc

    runs = {}
    for arch in WIDE_ARCHS:
        cfg = wide_config(arch)
        log(f"  [{arch}] {cfg.n_layers} layers (d_model {cfg.d_model}, {cfg.n_heads} heads on "
            f"{cfg.n_kv_heads} kv heads of {cfg.d_head}, vocab {cfg.vocab}, "
            f"{cfg.param_dtype} params), {SLOTS} slots x {CAPACITY}, prompts {FAMILY_PROMPTS}, "
            f"{WIDE_MAX_NEW} tokens")
        t0 = time.perf_counter()
        runs[arch] = family_drive(torch, cfg, SLOTS, FAMILY_PROMPTS, WIDE_MAX_NEW,
                                  full_checks=True)
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        runs[arch]["seconds"] = time.perf_counter() - t0
        log(f"  [{arch}] {runs[arch]['seconds']:.1f} s")
    return runs


# ------------------------------------------------------------ phase 17

# (a) reference cells cut in depth by the reference's own --cost-depth, each
# dry-run on a 1 x 1 fake mesh and then run for real on a 1 x 1 mesh of this
# card: (arch, shape name or ShapeConfig fields, cost depth, whether the
# views-as-allocations fault is traced too).  decode_32k's batch is cut from
# 128 to 32: at 128 the plain scoring's f32 sign tensors ([B, S, Hkv, D]
# twice) alone would take 69 GB beside 41 GB of arguments.  The training
# cell is phase 11's B x S at cost depth 2 (16 layers trace in 36 s).
DRYRUN_CALIBRATION = (
    ("olmo-1b", "long_500k", 2, False),
    ("olmo-1b", ("decode_32k/32", 32768, 32, "decode"), 1, True),
    ("olmo-1b", ("train_2k/4", TRAIN_SEQ, TRAIN_BATCH, "train"), 2, False),
)
# the dry run's peak (arguments + temporaries) against the card's, as a
# fraction of the card's: on one device the card read at most 7.3e-7;
# (b)'s sum over 4 fake devices reads 8.0e-4 at 4 layers and 0.0117 at 1
# (a copy between two shards is a copy there and nothing on one card, where
# ``.to`` returns a tensor already in place); the faults 0.56-1.49 (PERF.md)
DRYRUN_PEAK_REL_TOL = 0.02
DRYRUN_TRAIN_LAYERS = 1  # (b): phase 13's tp2 x dp2 cell at this depth (4 trace in 41 s)
# (b): a serving decode step on placed params (Megatron-parallel, FSDP over
# 'data') over a cache placed over batch x sequence, tp2 x dp2, 1 layer
DRYRUN_PLACED_DECODE = ("decode_8k/4", CAPACITY, SLOTS, "decode")
DRYRUN_PRODUCTION = ("olmo-1b", "decode_32k", 1)  # (c): on the 16 x 16 fake mesh


def _cell_shape(shape):
    from repro_torch.configs.base import ShapeConfig

    return shape if isinstance(shape, str) else ShapeConfig(*shape)


def _collective_cells():
    """(b)'s cells: (name, arch, shape, mesh shape, cost depth, config)."""
    import dataclasses

    from repro_torch.configs import get_config

    train_cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=DRYRUN_TRAIN_LAYERS)
    return (("tp2xdp2 train", "olmo-1b", _cell_shape(("train_2k/4", TRAIN_SEQ, TRAIN_BATCH,
                                                          "train")), (2, 2), None, train_cfg),
            ("long_500k x 4 shards", "olmo-1b", "long_500k", (1, 4), 1, None),
            ("tp2xdp2 placed decode", "olmo-1b", _cell_shape(DRYRUN_PLACED_DECODE), (2, 2), 1,
             None))


def dry_trace(torch, arch, shape, mesh_shape, axes, cost_depth=None, cfg=None, accountant=None):
    """The dry run of a cell on a fake mesh: ``launch.dryrun.trace``'s
    figures (JSON-ready) and the seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.specs import build_cell

    t0 = time.perf_counter()
    fake = FakeTensorMode()
    fake.cache_enabled = False
    with fake:
        cell = build_cell(arch, shape, make_fake_mesh(mesh_shape, axes),
                          cost_depth=cost_depth, cfg=cfg)
        tr = dryrun.trace(cell, accountant)
    acc = tr["acc"]
    reduces = [b for k, b, *_ in tr["record"].entries if k == "all-reduce"]
    return {"args": sum(tr["args"].values()), "peak_sum": acc.total_peak,
            "peak": dict(acc.peak), "flops": sum(acc.flops.values()),
            "record": [list(e) for e in tr["record"].summary()],
            "largest_all_reduce": max(reduces, default=0),
            "other": sum(acc.other_in.values()), "kind": cell.kind,
            "seconds": time.perf_counter() - t0}


def dry_runs():
    """Every trace of phase 17, on the CPU: (a)'s cells on 1 x 1 fake meshes
    (with the views fault where asked), (b)'s, and (c) through
    ``launch.dryrun.run_cell``.  Run by ``start_dry_runs`` in a process of
    its own; prints one JSON line."""
    import torch

    from repro_torch.launch import dryrun

    views_fault = _views_allocate()
    out = {"calibration": {}, "collectives": {}}
    for arch, shape, depth, with_views_fault in DRYRUN_CALIBRATION:
        shape = _cell_shape(shape)
        r = dry_trace(torch, arch, shape, (1, 1), ("data", "model"), depth)
        if with_views_fault:
            r["views_fault_peak_sum"] = dry_trace(torch, arch, shape, (1, 1), ("data", "model"),
                                                  depth, accountant=views_fault)["peak_sum"]
        out["calibration"][repr((arch, shape, depth))] = r
    for name, arch, shape, mesh_shape, depth, cfg in _collective_cells():
        out["collectives"][name] = dry_trace(torch, arch, shape, mesh_shape, ("data", "model"),
                                             depth, cfg)
    arch, shape, depth = DRYRUN_PRODUCTION
    out["production"] = dryrun.run_cell(arch, shape, multi_pod=False, cost_depth=depth,
                                        verbose=False)
    print(json.dumps(out), flush=True)


_DRY: dict = {}  # phase 17's trace process, started beside the card's phases


def start_dry_runs():
    """``dry_runs`` in a subprocess started before phase 2, so that its
    CPU-only traces overlap the card's phases; it sees no card
    (``CUDA_VISIBLE_DEVICES`` empty).  ``stop_dry_runs`` ends it on every
    way out."""
    _DRY["t0"] = time.perf_counter()
    _DRY["proc"] = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.dry_runs()"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, os.path.join(HERE, "src")]),
                 CUDA_VISIBLE_DEVICES=""))


def stop_dry_runs():
    proc = _DRY.pop("proc", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def dry_results() -> dict:
    proc = _DRY["proc"]
    stdout, stderr = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"phase 17's dry runs failed:\n{stderr[-3000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    out["wall_s"] = time.perf_counter() - _DRY["t0"]
    return out


def real_run(torch, arch, shape, mesh_shape, axes, cost_depth=None, cfg=None):
    """The same cell on this card, every shard on it, filled with zeros (the
    lengths full): its placed arguments' bytes, the step's FLOPs by
    ``FlopCounterMode`` and its collective record (one run), then its peak
    over a second run — ``max_memory_allocated`` from a reset just before
    the step, with the arguments resident."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import distributed as dist
    from repro_torch.launch.accounting import DeviceAccountant
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import build_cell

    mesh = Mesh(mesh_shape, axes, [DEVICE] * math.prod(mesh_shape))
    cell = build_cell(arch, shape, mesh, cost_depth=cost_depth, cfg=cfg, fill=True)
    args = sum(DeviceAccountant().storage_bytes(cell.args).values())
    with FlopCounterMode(display=False) as fc, dist.recording() as rec:
        out = cell.fn(*cell.args)
    del out
    free(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = cell.fn(*cell.args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + args
    del out, cell
    free(torch)
    return {"args": args, "flops": fc.get_total_flops(),
            "record": [list(e) for e in rec.summary()], "peak": peak}


def _views_allocate():
    """A planted fault: an accountant that counts every tensor an op
    returns, views included, as an allocation of its own."""
    import weakref

    from repro_torch.launch.accounting import DeviceAccountant

    class ViewsAllocate(DeviceAccountant):
        def _track(self, t):
            key = id(t)
            if key in self._storages:
                return False
            d, n = self.dev(t.device), t.numel() * t.element_size()
            self._storages[key] = (d, n)
            weakref.finalize(t, self._release, key)
            self.live[d] += n
            self.total_live += n
            self.peak[d] = max(self.peak[d], self.live[d])
            self.total_peak = max(self.total_peak, self.total_live)
            return True

    return ViewsAllocate


def dryrun_calibration(torch, dry):
    """(a): each DRYRUN_CALIBRATION cell's dry run against the card: the
    argument bytes and the FLOPs exactly, the peak within
    DRYRUN_PEAK_REL_TOL, and two planted faults beyond it: the arguments
    reported as the peak (every cell), every view counted as an allocation
    (the decode_32k cell, whose peak holds views)."""
    out = {}
    for arch, shape, depth, _ in DRYRUN_CALIBRATION:
        shape = _cell_shape(shape)
        d = dry[repr((arch, shape, depth))]
        name = f"{arch} {shape if isinstance(shape, str) else shape.name} @ depth {depth}"
        real = real_run(torch, arch, shape, (1, 1), ("data", "model"), depth)
        rel = lambda peak: abs(peak - real["peak"]) / real["peak"]
        r = {"args_dry": d["args"], "args_card": real["args"],
             "flops_dry": d["flops"], "flops_card": real["flops"],
             "peak_dry": d["peak_sum"], "peak_card": real["peak"],
             "peak_rel": rel(d["peak_sum"]), "fault_args_only_rel": rel(d["args"]),
             "trace_s": d["seconds"], "card": CARD}
        if "views_fault_peak_sum" in d:
            r["fault_views_rel"] = rel(d["views_fault_peak_sum"])
        out[name] = r
        log(f"  (a) {name}: {json.dumps(r)}")
        if r["args_dry"] != r["args_card"]:
            raise AssertionError(f"{name}: the dry run's argument bytes are not the card's: {r}")
        if r["flops_dry"] != r["flops_card"]:
            raise AssertionError(f"{name}: the dry run's FLOPs are not FlopCounterMode's: {r}")
        if not r["peak_rel"] <= DRYRUN_PEAK_REL_TOL < r["fault_args_only_rel"]:
            raise AssertionError(f"{name}: peak gate {DRYRUN_PEAK_REL_TOL}: {r}")
    # a view counted as an allocation moves the peak where views live at it
    # (a decode step's per-layer slab views); the train step peaks after its
    # views are gone (read 1.4e-7)
    if not any(r.get("fault_views_rel", 0) > DRYRUN_PEAK_REL_TOL for r in out.values()):
        raise AssertionError(f"the views-as-allocations fault passes the peak gate: {out}")
    return out


def dryrun_collectives(torch, dry):
    """(b): olmo-1b training on tp2 x dp2 (phase 13's cell at
    DRYRUN_TRAIN_LAYERS layers), one long_500k layer over 4 sequence
    shards and a placed serving decode step on tp2 x dp2
    (DRYRUN_PLACED_DECODE), every shard on this card: the dry run's collective record
    equals the real run's entry for entry, its peak of the sum over devices
    lies within DRYRUN_PEAK_REL_TOL of the card's peak, and the decode
    moves only O(B·Hq·D) partial outputs between shards: its all-reduces
    and its other copies."""
    from repro_torch.configs import SHAPES, get_config

    out = {}
    for name, arch, shape, mesh_shape, depth, cfg in _collective_cells():
        d = dry[name]
        real = real_run(torch, arch, shape, mesh_shape, ("data", "model"), depth, cfg)
        r = {"entries": len(d["record"]), "record_equal": d["record"] == real["record"],
             "flops_equal": d["flops"] == real["flops"],
             "peak_sum_dry": d["peak_sum"], "peak_card": real["peak"],
             "peak_rel": abs(d["peak_sum"] - real["peak"]) / real["peak"],
             "per_device_peak_dry": d["peak"], "trace_s": d["seconds"], "card": CARD}
        if d["kind"] == "decode":
            cfg_ = get_config(arch)
            B = (SHAPES[shape] if isinstance(shape, str) else shape).global_batch
            r["largest_all_reduce"] = d["largest_all_reduce"]
            r["other_bytes"] = d["other"]
            r["partials_bound"] = B * cfg_.n_heads * cfg_.d_head * 4  # [B, Hq, D] f32
        out[name] = r
        log(f"  (b) {name}: {json.dumps(r)}")
        if not (r["record_equal"] and r["flops_equal"]):
            raise AssertionError(f"{name}: the dry run's record or FLOPs differ from the card's")
        if r["peak_rel"] > DRYRUN_PEAK_REL_TOL:
            raise AssertionError(f"{name}: peak gate {DRYRUN_PEAK_REL_TOL}: {r}")
        if d["kind"] == "decode" and r["largest_all_reduce"] > r["partials_bound"]:
            raise AssertionError(f"{name}: a merge moved more than the partial outputs: {r}")
    return out


def dryrun_path(torch):
    """Phase 17: the dry run (``launch/dryrun.py``) against the card: (a)
    calibration on 1 x 1 meshes, (b) collectives on one card, (c) a
    production cell on the 16 x 16 fake mesh; every trace from the process
    ``start_dry_runs`` started before phase 2."""
    from repro_torch.launch.mesh import FAKE_DEVICE_TYPES, FAKE_TYPE_SHARDS

    t0 = time.perf_counter()
    dry = dry_results()
    out = {"calibration": dryrun_calibration(torch, dry["calibration"])}
    out["collectives"] = dryrun_collectives(torch, dry["collectives"])
    arch, shape, depth = DRYRUN_PRODUCTION
    rec = out["production"] = dry["production"]
    log(f"  (c) {arch} {shape} @ depth {depth} on the 16 x 16 fake mesh (trace {rec['trace_s']} s; "
        f"every trace of the phase {dry['wall_s']:.1f} s after their process started, beside "
        f"the card's phases; {CARD}): {json.dumps(rec)}")
    log(f"  (c) the 2 x 16 x 16 mesh needs 512 fake devices; torch names "
        f"{FAKE_TYPE_SHARDS * len(FAKE_DEVICE_TYPES)} (launch/mesh.py)")
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 17 wall time {out['wall_s']:.1f} s")
    return out


def build_kernels():
    """Phase 1's build: every ``csrc/*.cu`` (one ``nvcc`` each, all at once),
    each kernel's ptxas line logged, none with a stack frame or spills."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build()
    log(f"[setup] built {sorted(built) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (secs, report) in built.items():
        log(f"[setup] {name}.cu done after {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"[setup] ptxas {name}: {line.strip()}")
            if "stack frame" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"):
                raise AssertionError(f"{name}: a kernel uses local memory: {line.strip()}")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    card = CARD = card_line()
    log(f"[setup] {card}")
    log(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_kernels()

    if "--ssm-hybrid-encdec-only" in sys.argv:  # phase 10 alone after the build; no result line
        log("[ssm / hybrid / encdec] mamba2-370m, zamba2-7b and whisper-small at full width")
        ssm_hybrid_encdec_path(torch)
        return 0
    if "--training-only" in sys.argv:  # phase 11 alone after the build; no result line
        log("[training] flash backward, olmo-1b, restart, the families, train then serve")
        training_path(torch)
        return 0
    if "--sharded-only" in sys.argv:  # phase 12 alone after the build; no result line
        log("[sharded] mesh-sharded serving, every shard on this card")
        sharded_path(torch)
        return 0
    if "--sharded-train-only" in sys.argv:  # phase 13 alone after the build; no result line
        log("[sharded training] training on meshes, every shard on this card")
        sharded_train_path(torch)
        return 0
    if "--examples-only" in sys.argv:  # phase 14 alone after the build; no result line
        log("[reduced] every reduced config, the serve CLI and the examples on the card")
        reduced_path(torch)
        return 0
    if "--any-heads-only" in sys.argv:  # phase 15 alone after the build; no result line
        log("[any heads] olmo-1b with d_head 256, 64 and 96 at rep 8, 32 and 7")
        any_heads_path(torch)
        return 0
    if "--wide-only" in sys.argv:  # phase 16 alone after the build; no result line
        log("[wide] command-r-plus-104b and qwen3-moe-235b-a22b at full width, 8 layers")
        wide_path(torch)
        return 0
    start_dry_runs()  # phase 17's traces, on the CPU beside the card's phases
    if "--dryrun-only" in sys.argv:  # phase 17 alone after the build; no result line
        log("[dry run] the dry run's figures against this card")
        dryrun_path(torch)
        return 0

    start_fault_builds()  # for phase 2's planted faults
    since = lambda: f"[{time.perf_counter() - t_start:.1f} s]"
    log(f"[kernels] each kernel against its plain version {since()}")
    timer = Timer(torch)
    empty_ms = empty_kernel_ms(torch, timer)
    log(f"  an empty kernel (one CTA, launched through ctypes) reads {empty_ms:.4f} ms in this "
        f"timer: the floor under every kernel time below")
    shapes = [
        (SLOTS, 16, 1, 128, CAPACITY, "max"),   # olmo-1b main path (MHA)
        (SLOTS, 4, 4, 128, CAPACITY, "sum"),    # GQA
        (SLOTS, 4, 4, 128, CAPACITY, "max"),    # GQA, max
    ]
    rows = check_kernels(torch, timer, shapes)
    rows.update(check_paged_kernels(torch, timer, shapes))
    log(f"[kernels] K1/K3 on long and ragged rows {since()}")
    long_rows = check_long_rows(torch, timer)
    log(f"[kernels] K5-K8 and two_pass vs one_pass {since()}")
    unfused_base = None
    if "--baseline-unfused" in sys.argv:
        unfused_base = baseline_unfused(torch, sys.argv[sys.argv.index("--baseline-unfused") + 1])
    rows.update(check_unfused_kernels(torch, timer, shapes, unfused_base))
    log(f"[kernels] K6 at rep 8, K7 on adversarial rows {since()}")
    for kname, rs in check_score_topk_variants(torch, timer).items():
        long_rows[kname].update(rs)
    log(f"[kernels] K2/K4/K8 at every admitted rep, budgets 512 and 1000, determinism "
        f"{since()}")
    baseline = None
    if "--baseline-attend" in sys.argv:
        baseline = baseline_attend(torch, sys.argv[sys.argv.index("--baseline-attend") + 1])
    attend_variants = check_attend_variants(torch, timer, baseline)
    log(f"[kernels] K1-K8 at the family shapes (d_head 64 and 112, rep 12 and 16, S 4096) "
        f"{since()}")
    family = list(FAMILY_SHAPES.values())
    # the plain versions and library calls once each here (over 3 launches)
    family_rows = check_kernels(torch, timer, family, timing=once_each)
    family_rows.update(check_paged_kernels(torch, timer, family, timing=once_each))
    family_rows.update(check_unfused_kernels(torch, timer, family, timing=once_each))
    log(f"[kernels] K1/K3/K6 at a GQA rep at d_head 112 {since()}")
    gqa_112 = check_scoring(torch, timer, D112_GQA_SHAPE)
    log("[kernels] K1-K8 at d_head 16 and 32: the main path's scale, the examples' shapes, "
        f"a planted fault {since()}")
    t_small = time.perf_counter()
    small, small_fault = check_small_heads(torch, timer)
    log(f"  d_head 16 and 32 checks: {time.perf_counter() - t_small:.1f} s")
    log(f"[kernels] K1-K8 on the generic layout: every d_head and rep, two planted faults "
        f"{since()}")
    t_any = time.perf_counter()
    any_rows, any_faults = check_any_heads(torch, timer)
    log(f"  generic layout checks: {time.perf_counter() - t_any:.1f} s")
    del timer
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv:  # a quick build-and-check call; no result line
        return 0

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[main path] olmo-1b at full width, 4 slots, capacity 8192")
    counts, engine_errs, params, slab, p3 = main_path(torch)
    cfg = slab.bundle.cfg

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[paged vs slab] the same prompts through a paged engine, bs 32, default pool")
    counts_p4 = paged_vs_slab(torch, cfg, params, slab)
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[serving] ContinuousScheduler, chunk 2048, 8 slots x 8192, pool 621 blocks")
    counts_p5, stream, errs_p5, outs_p5 = serve_stream(torch, cfg, params)
    counts.update({k: counts_p5[k] for k in PAGED_KERNELS})

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[two_pass] the two_pass pipeline at full width, the unfused building blocks")
    counts_p6, counts_bb, errs_p6, p6 = two_pass_path(torch, cfg, params, p3, slab)
    del slab
    torch.cuda.empty_cache()
    counts.update({k: counts_p6[k] for k in ("fier_score", "topk_threshold")})
    counts.update({k: counts_bb[k] for k in ("pack_quantize", "sparse_attention")})

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[baselines] quest, slm and FIER one_pass at full width; the eviction family; the "
        "deprecated shims")
    baselines_path(torch, cfg, params, p3)

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[robustness] the host tier with a TTL on phase 5's stream; a seeded chaos run; the "
        "introspector; K1/K3 on a corrupted slot")
    robustness_path(torch, cfg, params, p3, outs_p5)
    del params, p3, outs_p5
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[families] granite-moe-1b-a400m, minicpm-2b, starcoder2-3b and "
        "llava-next-mistral-7b at full width")
    fam = families_path(torch)

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[ssm / hybrid / encdec] mamba2-370m, zamba2-7b and whisper-small at full width")
    fam.update(ssm_hybrid_encdec_path(torch))

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[training] flash backward, olmo-1b, restart, the families, train then serve")
    p11 = training_path(torch)

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[sharded] mesh-sharded serving, every shard on this card")
    p12 = sharded_path(torch)

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[sharded training] training on meshes, every shard on this card")
    p13 = sharded_train_path(torch)

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[reduced] every reduced config, the serve CLI and the examples on the card")
    p14 = reduced_path(torch)

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[any heads] olmo-1b with d_head 256, 64 and 96 at rep 8, 32 and 7")
    p15 = any_heads_path(torch)

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[wide] command-r-plus-104b and qwen3-moe-235b-a22b at full width, 8 layers")
    p16 = wide_path(torch)

    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    log("[dry run] the dry run's figures against this card")
    dryrun_path(torch)
    log(f"[done] phases 1-17 in {time.perf_counter() - t_start:.1f} s")

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {
        "fier_retrieve": (csrc + "fier_retrieve.cuh", "src/repro/kernels/fused_retrieval.py:284"),
        "fier_attend_selected": (csrc + "fier_attend.cuh",
                                 "src/repro/kernels/sparse_attention.py:228"),
        "fier_retrieve_paged": (csrc + "fier_retrieve.cuh",
                                "src/repro/kernels/fused_retrieval.py:435"),
        "fier_attend_selected_paged": (csrc + "fier_attend.cuh",
                                       "src/repro/kernels/sparse_attention.py:358"),
        "pack_quantize": (csrc + "fier_pack.cu", "src/repro/kernels/pack_quantize.py:52"),
        "fier_score": (csrc + "fier_score.cu", "src/repro/kernels/fier_score.py:110"),
        "topk_threshold": (csrc + "fier_topk.cu", "src/repro/kernels/topk_select.py:101"),
        "sparse_attention": (csrc + "fier_attend.cuh",
                             "src/repro/kernels/sparse_attention.py:106"),
    }
    # where each count comes from: the run that drove the kernel's path
    launch_runs = {
        "fier_retrieve": "phase 3", "fier_attend_selected": "phase 3",
        "fier_retrieve_paged": "phase 5", "fier_attend_selected_paged": "phase 5",
        "fier_score": "phase 6 two_pass generate", "topk_threshold": "phase 6 two_pass generate",
        "pack_quantize": "phase 6 building blocks", "sparse_attention": "phase 6 building blocks",
    }
    engine_err = {
        "fier_retrieve": engine_errs["k1_tau"], "fier_attend_selected": engine_errs["k2"],
        "fier_retrieve_paged": errs_p5["k1_tau"], "fier_attend_selected_paged": errs_p5["k2"],
        "sparse_attention": errs_p6["k8"],
    }
    kernels = []
    for name, rs in rows.items():
        r = rs[0]  # the main path's shape
        row = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": counts[name],
            "max_abs_err": max([x["max_abs_err"] for x in rs] + [engine_err.get(name, 0.0)]
                               + [x["max_abs_err"] for x in long_rows.get(name, {}).values()]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "check": "pass",
            "gqa_ms": rs[1]["ms"], "gqa_bound_ms": rs[1]["bound_ms"],
            "launches_run": launch_runs[name], "empty_kernel_ms": empty_ms,
        }
        for k in ("baseline_ms", "ms_in_turns"):
            if k in r:
                row[k], row["gqa_" + k] = r[k], rs[1][k]
        if "bound_full_ms" in r:
            row["bound_full_ms"] = r["bound_full_ms"]
        for lname, lr in long_rows.get(name, {}).items():
            row[lname] = {k: lr[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by", "max_abs_err")}
        row["families"] = {
            arch: {k: fr_[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by", "max_abs_err")}
            for arch, fr_ in zip(FAMILY_SHAPES, family_rows[name])
        }
        if name in gqa_112:
            g = gqa_112[name]
            row["families"]["d112_gqa"] = {k: g[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
        # d_head 16 and 32 (phase 2): each entry's time beside its bound
        if name in small:
            row["small_heads"] = {
                entry: {k: r[k] for k in ("shape", "budget", "ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by", "max_abs_err") if k in r}
                for entry, r in small[name].items()
            }
        if name in ("fier_retrieve", "fier_score"):
            row["small_heads_fault"] = small_fault
        # the generic layout (phase 2): each entry's time beside its bound
        row["any_heads"] = {
            entry: {k: r[k] for k in ("shape", "budget", "ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "max_abs_err") if k in r}
            for entry, r in any_rows.get(name, {}).items()
        }
        if name in ("fier_retrieve", "fier_score", "fier_attend_selected"):
            row["any_heads_faults"] = any_faults
        # phase 15: each geometry's runs, counted from 0
        row["launches_any_heads"] = {
            g: {run: p15[g][run]["launches"][name] for run in ("slab", "paged")}
            | {"two_pass_first_step": p15[g]["two_pass"]["launches"][name]}
            for g in ANY_GEOMETRIES}
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [x["max_abs_err"] for x in family_rows[name]]
                                 + [g["max_abs_err"] for g in [gqa_112.get(name)] if g]
                                 + [r["max_abs_err"] for r in small.get(name, {}).values()]
                                 + [r["max_abs_err"] for r in any_rows.get(name, {}).values()])
        if name in PAGED_KERNELS:
            # launches above: the serving run (phase 5); the paged-vs-slab run too
            row["launches_paged_vs_slab"] = counts_p4[name]
            # phase 12's mesh-sharded runs, each counted from 0: one launch per
            # layer, step and shard
            row["launches_sharded"] = {
                **{m: p12["olmo"][m]["launches"][name] for m, _, _ in SHARD_MESHES},
                "granite_tp2": p12["granite"]["launches"][name],
                "stream_dp2": p12["stream"]["launches"][name],
                "placed_tp2xdp2": p12["placed"]["launches"][name],
                "placed_granite_tp2xdp2": p12["granite"]["placed"]["launches"][name],
            }
            # phase 13(e): the model trained on the meshes, served on tp2
            row["launches_sharded_train"] = p13["serve"]["launches"][name]
        # phases 9 and 10's drives, each counted from 0 (paged: granite-moe's paged engine)
        fam_key = "launches_paged" if name in PAGED_KERNELS else "launches"
        row["launches_families"] = {a: r[fam_key][name] for a, r in fam.items()
                                    if name in r.get(fam_key, {})}
        # phase 16: the wide configs' generate (slab) and paged-vs-slab runs, each
        # counted from 0, and the device ms per launch in the profiled steps of
        # the paged-vs-slab run's engine of this kernel's layout
        if name in SLAB_KERNELS + PAGED_KERNELS:
            paged = name in PAGED_KERNELS
            row["launches_wide"] = {a: r["launches_paged" if paged else "launches"][name]
                                    for a, r in p16.items()}
            row["wide_ms_per_launch"] = {
                a: launch_ms(r["paged_vs_slab"]["paged" if paged else "slab"]["profile"],
                             "fier_retrieve_kernel" if "retrieve" in name
                             else "fier_attend_kernel")
                for a, r in p16.items()}
        if name in SLAB_KERNELS:  # phase 11(e): a model trained on the card, then served
            row["launches_train_then_serve"] = p11["serve"]["launches"][name]
            # phase 14: the reduced configs' generate, the serve_longcontext example
            row["launches_reduced"] = {a: r["launches"][name]
                                       for a, r in p14["configs"].items()}
            row["launches_serve_longcontext"] = p14["examples"]["serve_longcontext"][
                "launches"][name]
        if name in PAGED_KERNELS:  # phase 14 (b) and (c): reduced models, paged
            row["launches_reduced_paged"] = {
                **{a: c["paged"][name] for a, c in p14["stream"].items()},
                "serve_cli": p14["serve"]["paged"]["launches"][name]}
        if name == "fier_attend_selected":
            row["launches_two_pass"] = counts_p6[name]
        if name in ("fier_attend_selected", "fier_attend_selected_paged", "sparse_attention"):
            ms_key = {"fier_attend_selected": "ms", "fier_attend_selected_paged": "k4_ms",
                      "sparse_attention": "k8_ms"}[name]
            row["variants"] = {
                v: dict(budget=r["budget"], shape=r["shape"], ms=r[ms_key], bound_ms=r["bound_ms"],
                        cluster=r["cluster"],
                        **{k: r[k] for k in ("read_floor_ms", "read_floor_clean_ms", "ms_clean",
                                             "baseline_ms", "ms_in_turns")
                           if k in r and name == "fier_attend_selected"})
                for v, r in attend_variants.items()
            }
        if name == "pack_quantize":
            row["bytes_off_side_car_bf16"] = r["bytes_off_side_car_bf16"]
            row["bytes_off_side_car_f32"] = r["bytes_off_side_car_f32"]
        if r["library_ms"] is None:
            row["library_note"] = "no single PyTorch call computes this function"
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    finally:
        stop_dry_runs()
    sys.exit(rc)
