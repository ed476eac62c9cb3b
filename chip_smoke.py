"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), in phases.

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), torch and CUDA versions; TF32
   off for float32 products (the reference holds the loss to rtol 1e-4).
2. Build: every CUDA source of the port with nvcc for sm_90a, at first use,
   into build/torch_kernels/, one nvcc a source, all at once. Per kernel:
   registers and spill bytes (nvcc -Xptxas -v) and the tensor-core
   instructions (HMMA/HGMMA lines) in its SASS (cuobjdump --dump-sass).
   Fails on any spill, or on a forward, dU or dV kernel without
   tensor-core instructions (HGMMA).
3. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shape (B=4096, D=128, unit-norm rows, temperature
   0.1, duplicate ids, zero-weight rows, log q) and at ragged shapes
   (B=1000; a 300-row block at offset 500 with D=96; B=4097, a ragged
   tile and slice edge; B=1000 at D=20, depth not a multiple of 8; B=600
   at D=30, rows not 16-byte aligned, so 4-byte copies; B=512 at D=256,
   deeper than one tile, unit-norm rows; B=4096 at D=64, unit-norm rows, the
   depth phase 7c trains at; a 2048-row block of B=4096 at offset 2048,
   the 2x1 mesh's block of phase 10c; B=8192 at D=128, unit-norm rows,
   config 3's batch of phase 7g, where the JAX package runs its XLA loss).
   Tolerances: forward outputs rtol 1e-4 / atol 1e-4; dU and dV rtol 5e-3
   / atol 1e-5. Two launches of the
   forward, two of dU and two of dV must give the same bits.
4. Small-input check of the whole step: three steps at embedding 32,
   towers [64,32], batch 256, float32 compute, dropout 0, from one state,
   on the card (kernels) and on the CPU (plain versions); loss and
   grad_norm rtol 1e-4, final tables and moments rtol 1e-4 / atol 1e-5.
4b. Uniform and mixed sampling, small (embedding 32, towers [64,32],
   float32, dropout 0, batch 256, 64 negatives over 500 items): three steps
   of each mode on the card against the CPU with the same negative ids
   handed to both (losses rtol 1e-4, tables and moments rtol 1e-4 / atol
   1e-5); a 9-step mixed device-loop epoch captured and replayed against
   the same epoch eager on the card with the same generator seed (metrics
   rtol 1e-4, state rtol 1e-4 / atol 1e-5), where replays 2 and 3 must
   update different sampled item rows (outside their positives), and no
   fused-loss kernel runs.
4c. The optimizers and the dense step, small (phase 4b's sizes): three
   in_batch steps of the dense step (training/loop.py::make_step_fn) with
   adam and sparse_table_updates=false, adamw with weight decay 0.01 under
   warmup 2 + cosine 5, adagrad, sgd and adam with weight decay 0.01, and
   of the dense adam step under uniform and mixed sampling with the same
   negative ids on both devices, each on the card against the CPU from one
   state (losses rtol 1e-4; state rtol 1e-4 / atol 1e-5, except elements
   whose gradient into the optimizer cancelled to under 1e-6, non-zero,
   where Adam's update turns on the last bits: held within lr a step);
   each kernel launched once an in_batch step, none under sampling. Then a
   9-step dense adamw epoch captured and replayed against it eager on the
   card (metrics rtol 1e-4, state as above, launches = steps).
4d. The hashed text tower, small (4,096 buckets, 16 tokens an item, a
   ragged PAD tail a row): three steps of the sparse text step, the dense
   text step and the sparse mixed text step, card against CPU (the same
   checks); a 9-step sparse text epoch graph against eager.
5. Main path: the default model (embedding 128, towers [512,256,128], bf16
   compute, dropout 0.1, in-batch softmax with log q, lazy-Adam tables, host
   dedup) at batch 4096 over 1M users x 500k items, through
   init_train_state and make_train_step, 5 + 20 steps. Launch counts are
   set to 0 just before and read just after; every kernel must have run.
   Then 5 more steps under torch.profiler: device time by kernel and the
   device's busy share of the window. Then the same step replayed from a
   CUDA graph: the device loop's epoch (training/device_loop.py) at the
   same shape and state over 32 x 4096 random rows on the card, one epoch
   (2 warm-up steps, the capture, the replays) whose launches must equal
   its 32 steps, 25 single replays timed by CUDA events (median) and by
   the wall clock, and 5 replays profiled (each kernel's name must count 5
   launches) with the device time by kind of kernel, printed beside the
   eager step's median and device time.
5b. Phase 5's replayed step with retrieval.candidate_sampling=mixed and
   2,048 negatives (configs/pod_571m.yaml's per-device candidate set) on
   phase 5's state: launch counts 0 over the epoch and in the profile; its
   replay ms beside the in-batch replay's, and its device time by kind.
5c. The dense step at full width: phase 5's model, batch, tables and log
   q with training.sparse_table_updates=false. From one fresh state, one
   batch and one dropout generator state, the first dense step equals the
   first sparse step (every parameter within 1e-6, the loss rtol 1e-5; one
   launch of each kernel a step); then the dense adam step and the dense
   adamw step (weight decay 0.01) replayed as in phase 5: launches = steps,
   replay ms, device ms by kind, the epoch's peak device memory.
5d. The text step at full width: phase 5's model with model.text_buckets
   65536 and model.text_tokens 32 (HashedNgramEncoder's defaults) over
   [500k, 32] item tokens drawn on the card with a ragged PAD tail a row:
   two eager sparse steps (one launch of each kernel a step), then
   replayed as in phase 5.
6. Card against CPU, small: the train-model and evaluate-model CLIs, in
   process through main(argv), at the CLI tests' sizes (200 users, 100
   items, 5000 interactions, embedding 16, towers [32,16], batch 64,
   float32 compute, dropout 0, two epochs), once with --device cuda and
   once with --device cpu: per-epoch losses rtol 1e-4; validation and test
   metrics within one rank flip (1/rows). Three runs: sparse adam,
   --synthetic-text (512 buckets, 8 tokens), and adamw with weight decay. Then topk_mips_twopass on the
   card against one full torch.topk of the whole [B, N] score matrix at
   B=4096, N=100,000, D=128, k=100: ids equal except between exactly tied
   scores, scores rtol 1e-6.
7. The slice at full width: train-model with the default model (embedding
   128, towers [512,256,128], bf16 compute, dropout 0.1, log q, lazy-Adam
   tables, host dedup), batch 4096, two epochs, validation every epoch, on
   --synthetic-users 200000 --synthetic-items 100000
   --synthetic-interactions 4000000 (the device draw), into
   build/chip_smoke_slice/; then evaluate-model on its checkpoint. Launch
   counts set to 0 just before train-model and read just after: forward,
   dU and dV each launched once a step. Checks: finite losses, best val
   recall@10 at least 10x random (10 / items), evaluate-model's test
   metrics equal to train_summary.json's within 1e-6 (when the best step
   is the last; else its val recall@10 equals the best val metric), a
   checkpoint with meta.json. Prints the Trainer's steady and train
   examples/s, and the evaluation's device ms per 4096-row batch over the
   corpus (median of 10 batches, CUDA events) beside its bound (the larger
   of the corpus bytes at 3.35 TB/s and 2*B*N*D float32 FMA at 67 TFLOP/s)
   and one float32 torch.matmul of the same shape.
7b. The device loop. (a) One epoch at a small size (embedding 32, towers
   [64,32], float32 compute, dropout 0, warmup 5 + cosine 20 steps, batch
   256, 13 steps) from one state and one permutation: captured and
   replayed on the card, eager on the card, and on the CPU; metrics rtol
   1e-4 and state rtol 1e-4 / atol 1e-5 against the captured run, whose
   launches must equal its steps. (b) Phase 7's run with train-model
   --exec device-loop, then evaluate-model on its checkpoint, with phase
   7's checks (launch counts set to 0 just before train-model and read just
   after must equal its steps); its steady and train examples/s beside the
   host loop's. (c) A draw of phase 7's density cut to 2M interactions
   (100k users x 50k items; cut in depth to make room for phase 10)
   written as parquet, prepare-data --streaming, train-model
   --prepared-dir --exec auto (it must choose, log and report
   device_loop) and evaluate-model --prepared-dir, with the same checks.
7c. Oracle parity at config2 (tools/oracle_parity.py's preset, its
   stages in process): the generator's stats, the artifact's rows, users,
   items and temporal split, and the ceiling's and plug-in's metrics and
   median ranks held to the JAX package's record (recall@k within one test
   row, 1.2e-5; ndcg@k and mrr within 1e-6; counts and median ranks
   exactly); train-model --prepared-dir on the device loop (launch counts
   set to 0 just before and read just after equal its steps); the student's
   ceiling fraction of recall@10 at least ORACLE_MIN_FRACTION. Prints every
   metric's fraction and each stage's seconds as one {"oracle_parity": ...}
   JSON line.
7d. The text tower end to end at the full model width: train-model
   --synthetic-text --override model.text_buckets=65536 on the device loop
   (--synthetic-users 50000 --synthetic-items 25000
   --synthetic-interactions 1000000: the draw makes one Python string a row,
   so its size is cut to some 30 s of host time), evaluate-model on
   its checkpoint with phase 7's checks (launches = steps), then
   RetrievalIndex.from_checkpoint over item_tokens.npz: tpu_mips_exact equal
   to the Evaluator's search (with the same tokens) bit for bit, and the
   reduced-precision corpora's recall@100 (bfloat16 at least 0.95).
7e. The transformer text encoder at bert-base-uncased's published widths
   (vocab 30,522, hidden 768, 12 layers, 12 heads, intermediate 3,072, 512
   positions) with random weights from seed 0, written as a local HF
   directory (a WordPiece vocab.txt of BERT's specials, the synthetic
   text's words and filler pieces; a config-built BertModel): train-model
   --synthetic-text on a draw of phase 7d's density cut to 500k
   interactions (25k users x 12.5k items; cut in depth to make room for
   phase 10) with model.text_encoder=transformer
   on the device loop for one epoch (the text table 30,523 buckets, padded
   to 30,592 rows x 128, initialised from the word embeddings' PCA), then
   evaluate-model, with phase 7's checks (launches = steps, recall@10 at
   least 10x random). Checks: the text table at step 0 equals
   word_embedding_init(128) bit for bit; encode_vectors over the item texts,
   called on train-model's own encoder with no device named, moves the
   host-loaded model to the card (checked) and gives the same vectors at
   batch 32 and 128 (rtol 1e-4 / atol 1e-5) and, for 256 items with
   device="cpu", the CPU's (rtol 1e-3 / atol 1e-4: 12 float32 layers
   summed in other orders). Prints the host seconds of the
   tokenizer and model load, the PCA and encode_per_item, and
   encode_vectors' items/s.
7f. orchestrate-pipeline on the card's host: an Amazon-schema raw parquet
   (user_id, parent_asin, rating, title, text, timestamp) of a 200k-row
   synthetic draw, orchestrate-pipeline --skip-download --eda (prepare,
   explore) and again (the resume skips prepare), then train-model
   --prepared-dir --exec device-loop for one epoch: launch counts set to 0
   just before and read just after equal its steps.
7g. The config-3 lifecycle at full width: configs/lifecycle_50m_1chip.yaml
   as it ships (embedding 128, towers [512,256,128], bf16 compute, batch
   8192, lazy-Adam tables, log q, segment_steps 64, async checkpoints with
   a 900 s accept interval, approx bfloat16 validation) on prepare-data
   artifacts written directly (write_artifact, shared with phase 10b) with
   the vocab of the JAX package's 50M-row lifecycle artifact, 2,499,952
   users x 1,145,145 items (a 5.3 GiB train state): 8M and 1M rows of
   config 3's corpus generator (data/synthetic_scale.py, seed 42, its
   clusters drawn on the card) over every 6th id, config 3's density of
   rows a user and an item, their ids encoded directly. (a)
   train-model --config ... --exec auto --val-rows 80000 --override
   training.epochs=2 on the 8M artifact: it must choose, log and report
   the device loop; launch counts set to 0 just before and read just after
   equal its 1,564 steps; every epoch validated by topk_mips_approx over
   the bfloat16 corpus, no other search; epoch 2 improves, its save is
   skipped by the accept interval (a spy on CheckpointManager.save waits
   for the save in flight first, so the interval is the one rule left to
   skip it) and the end-of-fit backstop persists the final state, which
   best_step() names; prints the peak device memory of each epoch with its
   validation and of each save. (b) evaluate-model with
   retrieval.eval_exact=true retrieval.eval_corpus_dtype=float32 --rows
   80000 restores best_step()'s step and searches topk_mips_twopass over
   the float32 corpus; on the 80,000 validation rows train-model scored,
   evaluate-model's approx metrics equal the last epoch's within one rank
   flip, printed beside the exact ones. (c) train-model --exec stream for
   one epoch on the 1M artifact: the stream rung, 97 steps in segments of
   64 and 33, segment_time_p50_ms in the epoch record, launches = steps.
   (d) serve-model's service (build_service) over (a)'s checkpoint in
   float32 exact and bfloat16: /recommend for 16 test users (4 alone, then
   one request of 16), k=100: the exact service equal to the exact
   evaluator's topk_mips_twopass (scores within the responses' 6
   decimals, ids equal outside tied ranks); bfloat16's recall@100 against
   it. Prints one {"lifecycle": ...} JSON line.
7h. The config-3 oracle at full width, cut in depth (ORACLE3_* constants):
   tools/oracle_parity.py's config3 preset as it stands (embedding 128,
   towers [512,256,128], batch 8192, dropout 0.25, L2 1e-5, lazy-Adam
   tables, async checkpoints, patience 3; 256 clusters, latent 16,
   within-zipf 0.5, seed 42), the generate stage through generate_parquet
   and the others through the tool's own stage argv, in process, with
   rows, users and items divided by 12 (about 4.2M rows x
   20.8k users x 100k items: the full run's 200 rows a user and 42 an
   item), the clusters drawn on the card by force, the ceiling, plug-in
   and evaluate-model capped at 100k strided test rows, and 2 epochs.
   Checks: the full-shape teacher (250k x 1.2M, drawn with 3,000 rows on
   the card's path) has the sha256 the JAX package gives
   (ORACLE3_TEACHER_SHA256); exact_ranks of 256 of its rows over all 1.2M
   items, at the chunk free memory gives and at the full run's, equal an
   unchunked brute force of the same float32 scores, and differ from a
   float64 brute force only by items tied in float32 and not in float64;
   the card's cluster draws for three users of the phase's teacher pass
   a chi-square test against P(cluster | user) at 0.999; plug-in recall@10
   at most the ceiling's plus 3 standard errors; the device loop chosen;
   launch counts set to 0 just before the train stage and read just after
   equal its steps; best val recall@10 at least 10x random;
   evaluate-model restores the step best_step() names. Prints stage
   seconds, fractions and the rest as one {"oracle_config3": ...} line.
8. Serving (serve-model: RetrievalIndex, RecommendService, MicroBatcher
   through CoalescedRoutes under asyncio; no HTTP, as the card's machine has
   no aiohttp). Launch counts set to 0 before and read after: serving runs
   none of the ported kernels. (1) Card against CPU, small (embedding 16,
   towers [32,16], float32 compute, 200 users x 3,000 items) in each corpus
   variant (float32 exact, bfloat16, int8, int8_rowscale): corpora within
   one rounding step; then on one corpus, all four index methods and 12
   coalesced requests over the three routes (exclusions, history queries):
   scores rtol 1e-5 (1e-6 absolute for the responses' 6 decimals), ids
   equal outside exactly tied scores; the search at its blocked branch the
   same way, and int8 raw integer scores equal (torch._int_mm with padded
   query rows and a ragged corpus tail). (2) The trained model: phase 7's
   checkpoint through RetrievalIndex.from_checkpoint: tpu_mips_exact equal
   to the Evaluator's topk_mips_twopass (ids, and scores bit for bit) for
   4096 test users at k=100; recall@100 of bfloat16, int8 and int8_rowscale
   against it (bfloat16 at least 0.95). (3) Full size: the default model at
   random weights (seed 42, init_params on the card) over 1M users x 10M
   items; per variant the build time, the device ms of one search at
   B=1, 64, 256, k=100 (median of 20, CUDA events) beside its bound (the
   larger of the valid corpus bytes at 3.35 TB/s and 2*B*N*D at the corpus
   dtype's dense peak: float32 67, bf16 989, int8 1979 T/s) and recall@100
   against float32 exact for 1,024 users; then the bfloat16 service (window
   2 ms): warmup, 2,000 /recommend at concurrency 1 and at 32 (p50/p99 host
   latency, QPS, device calls), and one blue-green reload with pre_swap
   warmup. torch.profiler: device time by kernel of the bfloat16 search at
   B=1 and B=256, and of 256 requests at concurrency 32 with the device's
   busy share. Prints one {"serving": ...} JSON line.
8b. The native CPU index (serving/cpu_index.py: native/flat_index.cpp built
   with g++ on the card's host; a NumPy backend fails the phase) over phase
   7's trained float32 corpus (exported by the exact index, loaded with
   from_npz) against tpu_mips_exact on the card for 256 test users' query
   embeddings at k=100: scores rtol 1e-5 plus atol 1e-5 x the largest
   |score| (a float32 dot product's rounding scales with the norms, and a
   top-100 crosses 0), ids equal outside ranks tied within that atol.
   Prints the native search's host ms and threads beside the card's device
   ms, as one {"cpu_index": ...} JSON line.
10. The mesh (parallel/; one process a rank). (a) Probe: the NCCL
   version; each of the port's four collectives by gloo on the card's
   tensors between two spawned ranks, values checked (the phase fails if
   gloo lacks one: the port calls all four on the card's tensors);
   NCCL's refusal of two ranks on one device. (b) One rank over nccl (a
   world of one) at the main path's width with dropout 0 and
   mesh.a2a_capacity_factor=2.0: three mesh steps against the one-device
   sparse step from one init and one set of batches (after one step: the
   JAX tests' rtol 1e-4 / atol 1e-6; after three: rtol 5e-3 / atol 5e-4;
   elements whose gradient was under 1e-6 within 2 lr a step, the range
   of an Adam update), each
   kernel once a step; Trainer(mesh=).fit over 20 batches (launches =
   steps); the device loop's epoch on the mesh, the step and its
   collectives captured as a CUDA graph (launches = steps by the counters
   and one of each kernel a replay by a profiler count), replay ms; then
   train-model --mesh --prepared-dir at the full model width on an
   artifact written directly (write_artifact) with the main path's 1M
   users x 500k items as its vocab and 102,400 interactions (20 steps; a
   latent-factor draw over every 50th user and item), host loop and
   --device-loop (launches = steps), each followed by evaluate-model --mesh equal to
   evaluate-model within 1e-6 and test recall@10 at least 10x random. (c) Two spawned ranks
   sharing the card over gloo, layouts 2x1 and 1x2, at the main path's
   width at float32 compute: every tensor on cuda:0, the device loop's
   refusal of the gloo mesh (naming the backend), 5 steps on 10b's
   batches,
   rank 1's blocks at row_offset 2048 (2048 x 4096), launches = steps a
   rank, dropped_ids 0, the gathered state equal to the one-device steps
   after one step (10b's rule) and after five (rtol 5e-3 / atol 5e-4), the
   median step ms. In 10b and 10c at most 1e-5 of a leaf's other elements
   may fall outside the tolerance, within 2 lr a step. Then, on each rank,
   the mesh state stays sharded: a collective save (each rank writes its
   own table rows), a restore at the same layout into a fresh template
   (each rank reads its own rows), equal to the saved state bit for bit,
   and one Evaluator(mesh=) pass over 4,096 random rows at the Evaluator's
   own batch, 4,096 (the corpus encoded from table rows looked up from
   their owners); each one's seconds and rise of the rank's peak device
   memory (max_memory_allocated after reset_peak_memory_stats, over what
   was allocated before) must stay under one full table (the user table,
   512 MB), the pass's over its own corpus shard and exact-search buffers;
   and no result of a mesh collective in the three may reach the smallest
   table's size (the item table, 256 MB). Rank 0 restores the checkpoint on one device (which assembles the
   whole tree, by design): equal to the gathered state bit for bit, and
   its one-device Evaluator equal to the mesh pass within 1e-6. (d) The
   scaling tools: scaling-bench (parallel/scaling.py::run_scaling) at the
   main path's width over nccl, one spawned process a rank, worlds 1 and 2
   (2 is skipped on a one-card machine, as JAX skips it); scaling_model's
   predictions for 2x1, 1x2, 2x2 and 4x1 at 4,096 rows a card from (d)'s
   measured step and from (b)'s replayed one (predictions, not
   measurements). Prints one {"mesh": ...} JSON line. NCCL across two or
   more ranks needs a second card and is not run.
8c. Sharded serving (after phase 10, whose checkpoint it serves): phase
   8's 10M-item model (seed 42) as RetrievalIndex(mesh=[cuda:0] * 4), one
   process over four shards, in each corpus precision: recommend for 256
   users and similar_items for 64 items equal to the single-device index's
   (scores rtol 1e-5, int8's equal; ids equal outside tied ranks); the
   sharded search's device ms at B=1, 64, 256 (median of 10) beside phase
   8's single-device figure. Then build_service(shard_corpus=True) over
   10b's train-model --mesh checkpoint: by default over every visible
   card; over [cuda:0] * 4, /recommend, /recommend_by_history and
   /similar_items through CoalescedRoutes equal to the one-device
   service's, and one reload that rebuilds the four shards. Prints one
   {"sharded_serving": ...} JSON line. python3 chip_smoke.py --mesh-only
   runs phases 1-3, 10 and 8c alone (no result line), for debugging.
9. Times: per kernel, at the main path's shape, the device time of one
   call, beside its bound, its plain version and a library yardstick (one
   torch.matmul(u, v.T) at the same shape, which the port never calls).
   "ms", "plain_ms" and "library_ms" are the median of 20 calls, each
   between its own two CUDA events (so they also count the host's gap
   before a short kernel starts); "ms_batched" and "library_ms_batched"
   are the median of 5 batches of 20 back-to-back calls, each batch
   between two events; "host_us" is the median host time of 200 calls,
   each made with the card idle, from the call to its return (the step is
   host-bound, so a wrapper's host cost counts). The bound is the larger
   of the bytes time (each input read once, each output written once, at
   3.35 TB/s) and the lesser of two operation times at float32 accuracy:
   float32 FMA at 67 TFLOP/s, or three TF32 tensor-core passes at 495
   TFLOP/s (3x the flops);
   "bound_route" names the one taken and "share_of_bound" is bound / ms
   ("share_of_bound_batched" bound / ms_batched). "at_b8192" holds the same
   timings at config 3's batch, B=8192 (phase 7g).
   Each row also carries its launches in phase 7's train-model run, in
   phase 7b(b)'s device-loop run, in phase 7c's train stage, in phase 8's
   serving (0), in phase 5c's replayed dense adam epoch, in phase 5d's
   replayed text epoch, in phase 7d's, 7e's and 7f's train-model runs, in
   phase 7g's --exec auto and --exec stream runs, in phase 7h's train
   stage (launches_oracle_config3), and in phase 10's mesh
   runs (10b's Trainer, device-loop epoch and both train-model --mesh runs;
   rank 1's in 10c's 2x1 and 1x2).
   Then one JSON line of kernels, the median step time, and the last line
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; without a GPU, or without the rest
of the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAIN_B, MAIN_D = 4096, 128
LIFECYCLE_B = 8192  # configs/lifecycle_50m_1chip.yaml's batch (phase 7g)
NUM_USERS, NUM_ITEMS = 1_000_000, 500_000
WARMUP_STEPS, MEASURE_STEPS = 5, 20
TEMP = 0.1
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 outside the
# tensor cores, TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# Kernel row name -> (CUDA function, source under twotower_tpu_torch/ops/csrc).
KERNELS = {
    "fused_loss_fwd": ("fused_loss_fwd_kernel", "fused_loss.cu"),
    # Launched by the forward's entry point, reported but not rows of their
    # own: the pass that merges the slices' row statistics, and the forward
    # for depth past 128 (phase 3 runs it at D=256; the main path never does).
    "fused_loss_fwd_merge": ("fused_loss_fwd_merge_slices", "fused_loss.cu"),
    "fused_loss_fwd_deep": ("fused_loss_fwd_deep_kernel", "fused_loss.cu"),
    "fused_loss_bwd_du": ("fused_loss_bwd_du_kernel", "fused_loss_bwd.cu"),
    "fused_loss_bwd_dv": ("fused_loss_bwd_dv_kernel", "fused_loss_bwd.cu"),
    # The backward's second pass (adds the slices' partial sums), launched by
    # the dU and dV entry points: reported, but not a row of its own.
    "fused_loss_bwd_sum_slices": ("fused_loss_bwd_sum_slices", "fused_loss_bwd.cu"),
}
TENSOR_CORE_KERNELS = ("fused_loss_fwd", "fused_loss_fwd_deep", "fused_loss_bwd_du",
                       "fused_loss_bwd_dv")
CHECK_SHAPES = [  # batch, dim, rows, row offset, unit-norm rows
    (MAIN_B, MAIN_D, MAIN_B, 0, True),
    (1000, MAIN_D, 1000, 0, False),
    (1000, 96, 300, 500, False),
    (4097, MAIN_D, 4097, 0, True),
    (1000, 20, 1000, 0, False),
    (600, 30, 600, 0, False),
    # Unit-norm rows at D=256: with raw rows the logits reach ~500, and
    # float32 itself is then at 0.8 of the tolerance against float64.
    (512, 256, 512, 0, True),
    # The oracle parity run's shape (phase 7c: config2, embedding 64).
    (MAIN_B, 64, MAIN_B, 0, True),
    # The 2x1 mesh's block on rank 1 (phase 10c): 2048 rows of 4096 columns.
    (MAIN_B, MAIN_D, MAIN_B // 2, MAIN_B // 2, True),
    # Config 3's batch (phase 7g), where the JAX package runs its XLA loss.
    (LIFECYCLE_B, MAIN_D, LIFECYCLE_B, 0, True),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device time of one call: the median of ``reps`` calls, each between
    its own two CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms_batched(fn, reps: int = 20, batches: int = 5, warm: int = 3) -> float:
    """Device time of one call: the median over ``batches`` of the mean of
    ``reps`` back-to-back calls between two CUDA events (without the host's
    gap before each call that an event pair around one call also counts)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, reps: int = 200, warm: int = 3) -> float:
    """Host time of one call in microseconds: the median of ``reps`` calls,
    each made with the card idle, from the call to its return."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def loss_inputs(batch, dim, rows, seed, *, unit=True):
    """U rows at offset 0 (rows of the block), V, int32 ids with duplicates,
    folded log-q columns with 7 zero-weight columns, and an upstream g."""
    from twotower_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(rows, dim, generator=gen, device="cuda")
    v = torch.randn(batch, dim, generator=gen, device="cuda")
    if unit:
        u = u / u.norm(dim=1, keepdim=True)
        v = v / v.norm(dim=1, keepdim=True)
    ids = torch.randint(0, max(batch // 2, 1), (batch,), generator=gen, device="cuda",
                        dtype=torch.int32)
    log_q = torch.log(torch.rand(max(batch // 2, 1), generator=gen, device="cuda") * 1e-2 + 1e-4)
    w = torch.ones(batch, device="cuda")
    w[-7:] = 0.0
    cols = kernels.logq_cols(ids, log_q, w)
    g = torch.rand(rows, generator=gen, device="cuda") / rows
    return u, v, ids, cols, g


def ptxas_report(text: str) -> dict[str, list]:
    """CUDA function (mangled) -> [registers, spill store bytes, spill load
    bytes], from nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, [None, None, None])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return out


def sass_tensor_core_counts(lib: Path) -> dict[str, int]:
    """CUDA function (mangled) -> its HMMA/HGMMA instructions in the SASS."""
    from twotower_tpu_torch.ops import build

    text = subprocess.run(
        [build.cuda_tool("cuobjdump"), "--dump-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    return counts


def build_report(paths: dict[str, Path]) -> dict[str, dict]:
    """Per kernel: registers, spill bytes and SASS tensor-core instructions.
    Fails on a spill, or on a forward, dU or dV kernel with no tensor-core
    instruction."""
    from twotower_tpu_torch.ops import build

    ptxas = {src: ptxas_report(build.build_logs[src]) for src in paths}
    sass = {src: sass_tensor_core_counts(lib) for src, lib in paths.items()}
    report = {}
    for name, (fn, src) in KERNELS.items():
        (mangled,) = [k for k in sass[src] if fn in k]
        regs, spill_st, spill_ld = ptxas[src][mangled]
        report[name] = {"registers": regs, "spill_bytes": spill_st + spill_ld,
                        "tensor_core_instructions": sass[src][mangled]}
        log(f"  {fn} ({src}): {regs} registers, spill stores {spill_st} B, spill loads "
            f"{spill_ld} B, HMMA/HGMMA instructions in SASS {sass[src][mangled]}")
    spilled = [k for k, r in report.items() if r["spill_bytes"]]
    if spilled:
        raise RuntimeError(f"kernels spill registers: {spilled}")
    no_tc = [k for k in TENSOR_CORE_KERNELS if not report[k]["tensor_core_instructions"]]
    if no_tc:
        raise RuntimeError(f"no tensor-core instruction in the SASS of {no_tc}")
    return report


def check_kernels(shape_cases):
    """Each kernel against its plain version, and each twice (the same bits
    both times); returns the max abs errors of each case by its batch, dim,
    rows and offset."""
    from twotower_tpu_torch.ops import kernels

    all_errs = {}
    for batch, dim, rows, off, unit in shape_cases:
        u, v, ids, cols, g = loss_inputs(batch, dim, rows + off, seed=batch + dim, unit=unit)
        u = u[off:].contiguous()
        g = g[off:].contiguous()
        args = (u, v, ids, cols, off)
        got = kernels.fused_fwd(*args, 1 / TEMP)
        got_again = kernels.fused_fwd(*args, 1 / TEMP)
        ref = kernels.fwd_plain(*args, 1 / TEMP)
        torch.cuda.synchronize()
        for name, a, b in zip(("loss", "lse", "correct", "pos"), got, ref):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=lambda m: f"fwd {name}: {m}")
        if not all(torch.equal(a, b) for a, b in zip(got, got_again)):
            raise RuntimeError(f"B={batch} D={dim}: two launches of the forward differ")
        # Error over live rows: a zero-weight row's pos and loss sit near
        # -1e9 / +1e9 by design, where one float32 ulp is 64.
        live = off + torch.arange(rows, device="cuda") < batch - 7
        fwd_err = max(float((a - b)[live].abs().max()) for a, b in zip(got, ref))
        lse = ref[1]
        bwd_args = (*args, lse, g, 1 / TEMP)
        du, du_ref = kernels.fused_bwd_du(*bwd_args), kernels.bwd_du_plain(*bwd_args)
        dv, dv_ref = kernels.fused_bwd_dv(*bwd_args), kernels.bwd_dv_plain(*bwd_args)
        du_again, dv_again = kernels.fused_bwd_du(*bwd_args), kernels.fused_bwd_dv(*bwd_args)
        torch.cuda.synchronize()
        torch.testing.assert_close(du, du_ref, rtol=5e-3, atol=1e-5)
        torch.testing.assert_close(dv, dv_ref, rtol=5e-3, atol=1e-5)
        if not (torch.equal(du, du_again) and torch.equal(dv, dv_again)):
            raise RuntimeError(f"B={batch} D={dim}: two launches of dU or dV differ")
        errs = {
            "fused_loss_fwd": fwd_err,
            "fused_loss_bwd_du": float((du - du_ref).abs().max()),
            "fused_loss_bwd_dv": float((dv - dv_ref).abs().max()),
        }
        log(f"  B={batch} D={dim} rows={rows} offset={off}: max abs err {errs}; "
            "forward, dU, dV bitwise equal over two launches")
        all_errs[batch, dim, rows, off] = errs
    return all_errs


def host_batches(n, batch, num_users, num_items, user_dead, item_dead, seed):
    from twotower_tpu_torch.training.host_dedup import augment_batch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {
            "user_idx": rng.integers(0, num_users, batch).astype(np.int32),
            "item_idx": rng.integers(0, num_items, batch).astype(np.int32),
            "weight": np.ones(batch, np.float32),
        }
        out.append(augment_batch(b, user_dead=user_dead, item_dead=item_dead))
    return out


def check_small_step():
    """Three steps on the card (kernels) against the CPU (plain versions)
    from one state."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.training import init_train_state, make_optimizer, make_train_step

    cfg = Config().with_overrides({
        "model.embedding_dim": 32, "model.user_tower_dims": [64, 32],
        "model.item_tower_dims": [64, 32], "model.compute_dtype": "float32",
        "model.dropout_rate": 0.0, "training.batch_size": 256,
    })
    opt = make_optimizer(cfg.training)
    start = bridge.state_to_numpy(init_train_state(cfg, opt, 1000, 500, device="cpu"))
    rows_i = start["params"]["item_embedding"].shape[0]
    log_q = np.log(np.random.default_rng(5).dirichlet(np.ones(rows_i)) + 1e-9).astype(np.float32)
    batches = host_batches(3, 256, 1000, 500, start["params"]["user_embedding"].shape[0] - 1,
                           rows_i - 1, seed=6)
    ends, metrics = {}, {}
    for dev in ("cuda", "cpu"):
        state = bridge.state_from_numpy(start, device=dev)
        step = make_train_step(cfg, make_optimizer(cfg.training), log_q, device=dev)
        metrics[dev] = []
        for b in batches:
            state, m = step(state, b, None)
            metrics[dev].append((float(m["loss"]), float(m["grad_norm"])))
        ends[dev] = bridge.state_to_numpy(state)
    np.testing.assert_allclose(metrics["cuda"], metrics["cpu"], rtol=1e-4)
    for name in ("user_embedding", "item_embedding"):
        np.testing.assert_allclose(ends["cuda"]["params"][name], ends["cpu"]["params"][name],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ends["cuda"]["table_state"][name]["moments"],
                                   ends["cpu"]["table_state"][name]["moments"],
                                   rtol=1e-4, atol=1e-5)
    log(f"  card vs CPU, 3 steps: (loss, grad_norm) cuda {metrics['cuda']} cpu {metrics['cpu']}")


SAMPLING_SMALL = {
    "model.embedding_dim": 32, "model.user_tower_dims": [64, 32],
    "model.item_tower_dims": [64, 32], "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0, "training.batch_size": 256, "retrieval.num_negatives": 64,
}


def check_sampling_small():
    """Uniform and mixed sampling at a small size: three steps of each on
    the card against the CPU from one state with the same negative ids
    handed to both (losses rtol 1e-4, tables and moments rtol 1e-4 / atol
    1e-5); then a mixed device-loop epoch captured and replayed against the
    same epoch eager on the card with the same generator seed (metrics rtol
    1e-4, state rtol 1e-4 / atol 1e-5), in which two replays draw
    different negatives (read from the item rows each replay updates,
    outside its positives), and no fused-loss kernel runs."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training import init_train_state, make_optimizer
    from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn
    from twotower_tpu_torch.training.sparse import make_sparse_step_fn

    rng = np.random.default_rng(9)
    for mode in ("uniform", "mixed"):
        cfg = Config().with_overrides({**SAMPLING_SMALL, "retrieval.candidate_sampling": mode})
        start = bridge.state_to_numpy(init_train_state(cfg, make_optimizer(cfg.training), 1000,
                                                       500, device="cpu"))
        rows_i = start["params"]["item_embedding"].shape[0]
        log_q = np.log(rng.dirichlet(np.ones(rows_i)) + 1e-9).astype(np.float32)
        batches = host_batches(3, 256, 1000, 500, start["params"]["user_embedding"].shape[0] - 1,
                               rows_i - 1, seed=10)
        negs = [rng.integers(0, 500, 64) for _ in batches]
        ends, losses = {}, {}
        for dev in ("cuda", "cpu"):
            state = bridge.state_from_numpy(start, device=dev)
            step = make_sparse_step_fn(cfg, make_optimizer(cfg.training), num_items=500)
            losses[dev] = []
            for b, neg in zip(batches, negs):
                tb = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
                state, m = step(state, tb, None, torch.as_tensor(log_q, device=dev),
                                neg_ids=torch.as_tensor(neg, device=dev))
                losses[dev].append(float(m["loss"]))
            ends[dev] = bridge.state_to_numpy(state)
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4, err_msg=mode)
        for name in ("user_embedding", "item_embedding"):
            np.testing.assert_allclose(ends["cuda"]["params"][name], ends["cpu"]["params"][name],
                                       **STATE_TOL, err_msg=f"{mode} {name}")
            np.testing.assert_allclose(ends["cuda"]["table_state"][name]["moments"],
                                       ends["cpu"]["table_state"][name]["moments"],
                                       **STATE_TOL, err_msg=f"{mode} {name} moments")
        log(f"  {mode}, 3 steps with the same negatives: loss cuda {losses['cuda']} cpu "
            f"{losses['cpu']}; card = CPU within the stated tolerances")

    cfg = Config().with_overrides({**SAMPLING_SMALL, "retrieval.candidate_sampling": "mixed",
                                   "training.warmup_steps": 3, "training.decay_steps": 10})
    start = bridge.state_to_numpy(init_train_state(cfg, make_optimizer(cfg.training), 1000, 500,
                                                   device="cpu"))
    steps = 9
    users, items = rng.integers(0, 1000, 256 * steps), rng.integers(0, 500, 256 * steps)
    log_q = np.log(rng.dirichlet(np.ones(501)) + 1e-9).astype(np.float32)
    perm = rng.permutation(256 * steps)
    runs = {}
    for capture in (True, False):
        state = bridge.state_from_numpy(start, device="cuda")
        ds = DeviceDataset(users, items, 256, device="cuda")
        prog = make_epoch_fn(cfg, make_optimizer(cfg.training), steps, num_items=500,
                             device="cuda", capture=capture)
        kernels.reset_launch_counts()
        prog.begin_epoch(state, ds.columns, 0, torch.as_tensor(log_q, device="cuda"), perm=perm)
        moments = state.table_state["item_embedding"]["moments"]
        positives = ds.columns["item_idx"].cpu().numpy()[perm].reshape(steps, 256)
        sampled = []
        for i in range(steps):
            before = moments.clone()
            prog.step()
            changed = torch.nonzero((moments != before).any(dim=1)).flatten().cpu().numpy()
            sampled.append(set(changed.tolist()) - set(positives[i].tolist()))
        state, m = prog.end_epoch()
        runs[capture] = ({k: float(v) for k, v in m.items()}, bridge.state_to_numpy(state),
                         {w.__name__: w.launches for w in kernels.WRAPPERS}, sampled)
    graph, eager = runs[True], runs[False]
    replays = graph[3][2:]  # steps 3.. are the capture's replay and the replays
    if not all(replays) or replays[1] == replays[2]:
        raise RuntimeError(f"mixed graph epoch: replays 2 and 3 sampled {replays[1:3]}")
    if any(graph[2].values()):
        raise RuntimeError(f"mixed graph epoch launched fused-loss kernels: {graph[2]}")
    np.testing.assert_allclose([graph[0][k] for k in sorted(eager[0])],
                               [eager[0][k] for k in sorted(eager[0])], rtol=1e-4,
                               err_msg="mixed graph vs eager: epoch metrics")
    for part in ("params", "table_state", "opt_state"):
        for x, y in zip(tree_leaves(graph[1][part]), tree_leaves(eager[1][part])):
            np.testing.assert_allclose(x, y, **STATE_TOL, err_msg=f"mixed graph vs eager: {part}")
    log(f"  mixed epoch ({steps} steps, 64 negatives): metrics graph {graph[0]}, eager "
        f"{eager[0]}; graph = eager within the stated tolerances; item rows sampled by "
        f"replays 2 and 3: {len(replays[1])} and {len(replays[2])}, "
        f"{len(replays[1] & replays[2])} in common; fused-loss launches {graph[2]}")


# Phase 4c: the optimizers that leave the sparse path, each on the dense step.
DENSE_VARIANTS = {
    "adam, sparse_table_updates=false": {"training.sparse_table_updates": False},
    "adamw, weight decay 0.01, warmup 2 + cosine 5": {
        "training.optimizer": "adamw", "training.weight_decay": 0.01,
        "training.warmup_steps": 2, "training.decay_steps": 5},
    "adagrad": {"training.optimizer": "adagrad"},
    "sgd": {"training.optimizer": "sgd", "training.learning_rate": 0.05},
    "adam, weight decay 0.01": {"training.weight_decay": 0.01},
}
# Phase 4d: the hashed text tower at a small size.
TEXT_SMALL = {"model.text_buckets": 4096, "model.text_tokens": 16}


def ragged_tokens(rng, items: int, buckets: int, width: int) -> np.ndarray:
    """``[items, width]`` token ids in [1, buckets) with a ragged PAD (0) tail
    a row, some rows all PAD."""
    tok = rng.integers(1, buckets, (items, width)).astype(np.int32)
    tok[np.arange(width)[None, :] >= rng.integers(0, width + 1, (items, 1))] = 0
    return tok


def cancelled_masks(opt) -> dict:
    """Per parameter (by data pointer), the elements whose gradient fed to
    the optimizer (after coupled weight decay) was non-zero but under 1e-6
    in some step. There Adam's m / (sqrt(v) + eps), eps 1e-8, is decided by
    the gradient's last float32 bits, which two devices' summation orders
    set differently: such an element's update may differ by up to lr a
    step, so it is held to that."""
    masks = {}
    coupled = opt._coupled

    def record(g, p):
        g = coupled(g, p)
        small = (g.abs() < 1e-6) & (g != 0)
        masks[p.data_ptr()] = masks.get(p.data_ptr(), torch.zeros_like(small)) | small
        return g

    opt._coupled = record
    return masks


def assert_state_close(got: dict, ref: dict, ref_state, masks: dict, lr_steps: float, what: str):
    """Two numpy train states within STATE_TOL; the params' elements in
    ``masks`` (keyed by ``ref_state``'s tensors) within ``lr_steps``."""
    ptrs = [t.data_ptr() for t in tree_leaves(ref_state.params)]
    for part in ("params", "table_state", "opt_state"):
        a, b = got[part], ref[part]
        if b is None:
            if a is not None:
                raise RuntimeError(f"{what}: {part} is None on one side only")
            continue
        for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
            mask = masks.get(ptrs[i]) if part == "params" else None
            if mask is not None and mask.any():
                mask = mask.cpu().numpy()
                np.testing.assert_allclose(x[mask], y[mask], rtol=0, atol=lr_steps,
                                           err_msg=f"{what}: {part}, cancelled gradients")
                x, y = x[~mask], y[~mask]
            np.testing.assert_allclose(x, y, **STATE_TOL, err_msg=f"{what}: {part}")


def steps_card_vs_cpu(cfg, what: str, rng, *, negs: bool = False, tokens=None) -> dict:
    """Three train steps (``make_raw_step``: sparse or dense as the config
    says) from one state on the card and on the CPU, the same batches,
    negatives (``negs``) and item tokens on both: losses rtol 1e-4, the
    state within ``assert_state_close``. Returns the card's launch counts
    over the three steps."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training import init_train_state, make_optimizer
    from twotower_tpu_torch.training.loop import make_raw_step

    start = bridge.state_to_numpy(init_train_state(cfg, make_optimizer(cfg.training), 1000, 500,
                                                   device="cpu"))
    rows_u = start["params"]["user_embedding"].shape[0]
    rows_i = start["params"]["item_embedding"].shape[0]
    log_q = np.log(rng.dirichlet(np.ones(rows_i)) + 1e-9).astype(np.float32)
    batches = host_batches(3, 256, 1000, 500, rows_u - 1, rows_i - 1, seed=int(rng.integers(99)))
    neg_ids = [rng.integers(0, 500, cfg.retrieval.num_negatives) if negs else None
               for _ in batches]
    ends, losses = {}, {}
    for dev in ("cuda", "cpu"):
        state = bridge.state_from_numpy(start, device=dev)
        opt = make_optimizer(cfg.training)
        masks = cancelled_masks(opt)
        step = make_raw_step(cfg, opt, num_items=500)
        lq = torch.as_tensor(log_q, device=dev)
        tok = None if tokens is None else torch.as_tensor(tokens, device=dev)
        kernels.reset_launch_counts()
        losses[dev] = []
        for b, neg in zip(batches, neg_ids):
            tb = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            state, m = step(state, tb, None, lq, tok,
                            neg_ids=None if neg is None else torch.as_tensor(neg, device=dev))
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
        ends[dev] = (bridge.state_to_numpy(state), state, masks)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4, err_msg=what)
    (got, _, _), (ref, ref_state, masks) = ends["cuda"], ends["cpu"]
    assert_state_close(got, ref, ref_state, masks, 3 * cfg.training.learning_rate, what)
    cancelled = sum(int(m.sum()) for m in masks.values())
    log(f"  {what}: 3 steps, loss cuda {losses['cuda']} cpu {losses['cpu']}; card = CPU within "
        f"the stated tolerances ({cancelled} elements with a cancelled gradient); launches "
        f"{launches}")
    return launches


def epoch_graph_vs_eager(cfg, what: str, rng, tokens=None) -> None:
    """A 9-step device-loop epoch captured and replayed against the same
    epoch eager on the card, one state and one permutation: metrics rtol
    1e-4, state within ``assert_state_close``; the captured run launches
    each fused-loss kernel once a step."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training import init_train_state, make_optimizer
    from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn

    start = bridge.state_to_numpy(init_train_state(cfg, make_optimizer(cfg.training), 1000, 500,
                                                   device="cpu"))
    steps = 9
    users, items = rng.integers(0, 1000, 256 * steps), rng.integers(0, 500, 256 * steps)
    log_q = torch.as_tensor(np.log(rng.dirichlet(np.ones(501)) + 1e-9).astype(np.float32),
                            device="cuda")
    perm = rng.permutation(256 * steps)
    tok = None if tokens is None else torch.as_tensor(tokens, device="cuda")
    runs = {}
    for capture in (True, False):
        state = bridge.state_from_numpy(start, device="cuda")
        opt = make_optimizer(cfg.training)
        masks = cancelled_masks(opt)
        ds = DeviceDataset(users, items, 256, device="cuda")
        prog = make_epoch_fn(cfg, opt, steps, num_items=500, device="cuda", capture=capture)
        kernels.reset_launch_counts()
        state, m = prog(state, ds.columns, 0, log_q, tok, perm=perm)
        runs[capture] = ({k: float(v) for k, v in m.items()}, bridge.state_to_numpy(state),
                         {w.__name__: w.launches for w in kernels.WRAPPERS}, state, masks)
    graph, eager = runs[True], runs[False]
    if any(v != steps for v in graph[2].values()):
        raise RuntimeError(f"{what}: graph epoch launches {graph[2]} != {steps} steps")
    np.testing.assert_allclose([graph[0][k] for k in sorted(eager[0])],
                               [eager[0][k] for k in sorted(eager[0])], rtol=1e-4,
                               err_msg=f"{what} graph vs eager: epoch metrics")
    assert_state_close(graph[1], eager[1], eager[3], eager[4],
                       steps * cfg.training.learning_rate, f"{what} graph vs eager")
    log(f"  {what}, a {steps}-step epoch: metrics graph {graph[0]}, eager {eager[0]}; graph = "
        f"eager within the stated tolerances; launches {graph[2]} (one a step)")


def check_dense_small() -> None:
    """Phase 4c: each optimizer on the dense step (in_batch), then the dense
    adam step under uniform and mixed sampling, card against CPU; then a
    dense epoch (adamw, weight decay, schedule) graph against eager."""
    from twotower_tpu_torch.config import Config

    rng = np.random.default_rng(13)
    for what, over in DENSE_VARIANTS.items():
        cfg = Config().with_overrides({**SAMPLING_SMALL, **over})
        if cfg.training.effective_sparse_updates():
            raise RuntimeError(f"{what} takes the sparse step")
        launches = steps_card_vs_cpu(cfg, f"dense {what}", rng)
        if any(v != 3 for v in launches.values()):
            raise RuntimeError(f"dense {what}: launches {launches} != 3 steps")
    for mode in ("uniform", "mixed"):
        cfg = Config().with_overrides({**SAMPLING_SMALL, "retrieval.candidate_sampling": mode,
                                       "training.sparse_table_updates": False})
        launches = steps_card_vs_cpu(cfg, f"dense adam, {mode}, the same negatives", rng,
                                     negs=True)
        if any(launches.values()):
            raise RuntimeError(f"dense {mode} launched fused-loss kernels: {launches}")
    cfg = Config().with_overrides(
        {**SAMPLING_SMALL, **DENSE_VARIANTS["adamw, weight decay 0.01, warmup 2 + cosine 5"],
         "training.decay_steps": 10})
    epoch_graph_vs_eager(cfg, "dense adamw", rng)


def check_text_small() -> None:
    """Phase 4d: the text tower's sparse and dense steps (and the sparse
    mixed step, the negatives' tokens too) card against CPU, then a sparse
    text epoch graph against eager."""
    from twotower_tpu_torch.config import Config

    rng = np.random.default_rng(14)
    tokens = ragged_tokens(rng, 500, TEXT_SMALL["model.text_buckets"],
                           TEXT_SMALL["model.text_tokens"])
    base = {**SAMPLING_SMALL, **TEXT_SMALL}
    for what, over, negs in (("text, sparse", {}, False),
                             ("text, dense", {"training.sparse_table_updates": False}, False),
                             ("text, sparse mixed", {"retrieval.candidate_sampling": "mixed"},
                              True)):
        launches = steps_card_vs_cpu(Config().with_overrides({**base, **over}), what, rng,
                                     negs=negs, tokens=tokens)
        if any(v != (0 if negs else 3) for v in launches.values()):
            raise RuntimeError(f"{what}: launches {launches}")
    cfg = Config().with_overrides({**base, "training.warmup_steps": 3, "training.decay_steps": 10})
    epoch_graph_vs_eager(cfg, "text, sparse", rng, tokens)


def run_main_path():
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.models.two_tower import dead_row
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training import init_train_state, make_optimizer, make_train_step

    cfg = Config().with_overrides({"training.batch_size": MAIN_B})
    opt = make_optimizer(cfg.training)
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt, NUM_USERS, NUM_ITEMS)
    torch.cuda.synchronize()
    log(f"  init_train_state: {time.perf_counter() - t0:.3f} s; tables "
        f"{tuple(state.params['user_embedding'].shape)} + "
        f"{tuple(state.params['item_embedding'].shape)}")
    rows_i = state.params["item_embedding"].shape[0]
    log_q = np.log(np.full(rows_i, 1.0 / NUM_ITEMS, np.float32))
    step = make_train_step(cfg, opt, log_q)
    batches = host_batches(8, MAIN_B, NUM_USERS, NUM_ITEMS, dead_row(state.params["user_embedding"]),
                           dead_row(state.params["item_embedding"]), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)

    kernels.reset_launch_counts()
    step_ms, losses = [], []
    for i in range(WARMUP_STEPS + MEASURE_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batches[i % len(batches)], gen)
        loss = float(m["loss"])  # synchronises
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    n_steps = WARMUP_STEPS + MEASURE_STEPS
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss on the main path: {losses}")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel never ran on the main path: {launches}")
    log(f"  {n_steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"grad_norm {float(m['grad_norm']):.4f}; launches {launches} "
        f"({ {k: v / n_steps for k, v in launches.items()} } per step)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    device_ms = profile_steps(step, state, batches, gen)
    return launches, statistics.median(step_ms), device_ms, (cfg, opt, state, log_q)


def profile_steps(step, state, batches, gen, n: int = 5) -> float:
    """Device time by kernel over ``n`` main-path steps; returns the device
    ms a step."""
    box = [state]

    def one(i):
        box[0], _ = step(box[0], batches[i % len(batches)], gen)

    return profile_device(one, n, "step")[0]


GRAPH_STEPS = 32  # steps of the graph-timing epochs (25 timed replays fit in one)


def time_graph_step(main, launches_a_step: int = 1, item_tokens=None, mesh=None) -> dict:
    """The main-path step replayed from a CUDA graph: the device loop's
    epoch (training/device_loop.py) at the main path's shape and state, over
    random columns on the card. Launch counts over a whole epoch (two
    warm-up steps, the capture, the replays) must equal its steps times
    ``launches_a_step`` (0 for a step that runs no fused-loss kernel); then
    the device ms of 25 single replays (CUDA events around each), the wall
    ms a step over them, and a profile of 5 replays whose kernel names must
    count ``launches_a_step`` launches of each kernel a replay, with the
    device time by kind of kernel, and the peak device memory over the
    epoch (the capture's pool included). ``item_tokens``: the text tower's
    ``[items, T]`` tokens on the card; ``mesh``: the epoch on the mesh
    (its step and collectives captured), ``state`` the rank's shard."""
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn

    cfg, opt, state, log_q = main
    rng = np.random.default_rng(11)
    n = GRAPH_STEPS * MAIN_B
    ds = DeviceDataset(rng.integers(0, NUM_USERS, n), rng.integers(0, NUM_ITEMS, n), MAIN_B,
                       device="cuda")
    lq = torch.as_tensor(log_q, device="cuda")
    prog = make_epoch_fn(cfg, opt, ds.num_steps, num_items=NUM_ITEMS, device="cuda",
                         mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, m = prog(state, ds.columns, 0, lq, item_tokens)
    loss = float(m["loss"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    want = GRAPH_STEPS * launches_a_step
    if any(v != want for v in launches.values()) or not math.isfinite(loss):
        raise RuntimeError(f"graph epoch: launches {launches} != {want} "
                           f"({GRAPH_STEPS} steps), loss {loss}")
    prog.begin_epoch(state, ds.columns, 1, lq, item_tokens)
    events = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(25):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prog.step()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / 25
    replay_ms = statistics.median(a.elapsed_time(b) for a, b in events)
    for _ in range(GRAPH_STEPS - 25):
        prog.step()
    state, _ = prog.end_epoch()
    prog.begin_epoch(state, ds.columns, 2, lq, item_tokens)
    busy_ms, counts, times = profile_device(lambda i: prog.step(), 5, "replay")
    for _ in range(GRAPH_STEPS - 5):
        prog.step()
    prog.end_epoch()
    by_kernel = {fn: sum(c for k, c in counts.items() if fn in k)
                 for fn in ("fused_loss_fwd_kernel", "fused_loss_bwd_du_kernel",
                            "fused_loss_bwd_dv_kernel")}
    if any(c != 5 * launches_a_step for c in by_kernel.values()):
        raise RuntimeError(f"profiler: kernel launches over 5 replays {by_kernel}")
    kinds = by_kind(times)
    log(f"  graph epoch: {GRAPH_STEPS} steps, loss {loss:.4f}, launches {launches} "
        f"({launches_a_step} a step); profiler over 5 replays: {by_kernel} launches")
    log(f"  replayed step: median {replay_ms:.4f} ms of 25 replays (CUDA events), wall "
        f"{wall_ms:.4f} ms a step, {MAIN_B / replay_ms * 1e3:.1f} examples/s; device ms a "
        f"replay by kind {json.dumps(kinds)}; peak device memory over the epoch "
        f"{peak_gib:.3f} GiB")
    return {"replay_ms": replay_ms, "wall_ms": wall_ms, "replay_device_ms": busy_ms,
            "launches": launches, "by_kind": kinds, "peak_gib": peak_gib}


MIXED = {"retrieval.candidate_sampling": "mixed", "retrieval.num_negatives": 2048}


def time_mixed_step(main, in_batch: dict, card: str) -> dict:
    """Phase 5's replayed step with mixed sampling (``MIXED``: the 4,096
    in-batch columns plus 2,048 shared uniform negatives, the per-device
    candidate set of configs/pod_571m.yaml), on phase 5's state: no
    fused-loss kernel runs (the counts and the profiler read 0)."""
    cfg, opt, state, log_q = main
    got = time_graph_step((cfg.with_overrides(MIXED), opt, state, log_q), launches_a_step=0)
    log(f"  mixed replay {got['replay_ms']:.4f} ms against the in-batch replay "
        f"{in_batch['replay_ms']:.4f} ms ({got['replay_ms'] / in_batch['replay_ms']:.3f}x); "
        f"fused-loss launches {got['launches']} (mixed runs none; {card})")
    return got


def run_dense_full(card: str) -> dict:
    """Phase 5c: the dense step at the main path's width (phase 5's model,
    batch, tables and log q, training.sparse_table_updates=false). From one
    fresh state (one seed) and one batch, and one generator state for the
    dropout masks, the first dense step equals the first sparse step (lazy
    Adam is dense Adam at step 1): every parameter within 1e-6, the loss
    within rtol 1e-5. Then the dense adam step, and the dense adamw step
    (weight decay 0.01), replayed (``time_graph_step``)."""
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.models.two_tower import dead_row
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training import init_train_state, make_optimizer, make_train_step

    cfg_s = Config().with_overrides({"training.batch_size": MAIN_B})
    out = {}
    firsts = {}
    for name, cfg in (("sparse", cfg_s),
                      ("dense", cfg_s.with_overrides({"training.sparse_table_updates": False}))):
        opt = make_optimizer(cfg.training)
        state = init_train_state(cfg, opt, NUM_USERS, NUM_ITEMS)
        rows_i = state.params["item_embedding"].shape[0]
        log_q = np.log(np.full(rows_i, 1.0 / NUM_ITEMS, np.float32))
        batch = host_batches(1, MAIN_B, NUM_USERS, NUM_ITEMS,
                             dead_row(state.params["user_embedding"]), rows_i - 1, seed=0)[0]
        step = make_train_step(cfg, opt, log_q)
        kernels.reset_launch_counts()
        state, m = step(state, batch, torch.Generator(device="cuda").manual_seed(5))
        loss = float(m["loss"])
        launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
        if any(v != 1 for v in launches.values()):
            raise RuntimeError(f"{name} first step: launches {launches}")
        firsts[name] = (loss, state)
        if name == "dense":
            dense = (cfg, opt, state, log_q)
    (loss_s, state_s), (loss_d, state_d) = firsts["sparse"], firsts["dense"]
    if state_d.table_state is not None or state_s.table_state is None:
        raise RuntimeError("the dense and sparse states have the wrong layouts")
    diff = max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(state_s.params), tree_leaves(state_d.params)))
    if abs(loss_s - loss_d) > 1e-5 * abs(loss_s) or diff > 1e-6:
        raise RuntimeError(f"first dense step != first sparse step: loss {loss_d} vs {loss_s}, "
                           f"params differ by up to {diff}")
    log(f"  first step from one state, batch and dropout generator: loss dense {loss_d} sparse "
        f"{loss_s}; params differ by at most {diff} (gate 1e-6); one launch of each kernel in "
        "each eager step")
    del firsts, state_s
    torch.cuda.empty_cache()
    log("  dense adam, replayed:")
    out["adam"] = time_graph_step(dense)
    del dense, state_d
    torch.cuda.empty_cache()
    cfg_w = cfg_s.with_overrides({"training.optimizer": "adamw", "training.weight_decay": 0.01})
    opt_w = make_optimizer(cfg_w.training)
    state_w = init_train_state(cfg_w, opt_w, NUM_USERS, NUM_ITEMS)
    log_q = np.log(np.full(state_w.params["item_embedding"].shape[0], 1.0 / NUM_ITEMS,
                           np.float32))
    log("  dense adamw (weight decay 0.01), replayed:")
    out["adamw"] = time_graph_step((cfg_w, opt_w, state_w, log_q))
    del state_w
    torch.cuda.empty_cache()
    log(f"  dense replay ms: adam {out['adam']['replay_ms']:.4f}, adamw "
        f"{out['adamw']['replay_ms']:.4f} ({card})")
    return out


TEXT_FULL = {"model.text_buckets": 65536, "model.text_tokens": 32}  # HashedNgramEncoder's


def run_text_full(card: str) -> dict:
    """Phase 5d: the sparse step with the hashed text tower at the main
    path's width (``TEXT_FULL``: 65,536 buckets, 32 tokens an item) over
    ``[500k, 32]`` item tokens drawn on the card with a ragged PAD tail a
    row: two eager steps (one launch of each kernel a step), then replayed
    (``time_graph_step``)."""
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.models.two_tower import dead_row
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training import init_train_state, make_optimizer, make_train_step

    cfg = Config().with_overrides({"training.batch_size": MAIN_B, **TEXT_FULL})
    opt = make_optimizer(cfg.training)
    state = init_train_state(cfg, opt, NUM_USERS, NUM_ITEMS)
    gen = torch.Generator(device="cuda").manual_seed(21)
    width = TEXT_FULL["model.text_tokens"]
    tokens = torch.randint(1, TEXT_FULL["model.text_buckets"], (NUM_ITEMS, width), generator=gen,
                           device="cuda", dtype=torch.int32)
    lengths = torch.randint(0, width + 1, (NUM_ITEMS, 1), generator=gen, device="cuda")
    tokens[torch.arange(width, device="cuda")[None, :] >= lengths] = 0
    rows_i = state.params["item_embedding"].shape[0]
    log_q = np.log(np.full(rows_i, 1.0 / NUM_ITEMS, np.float32))
    step = make_train_step(cfg, opt, log_q, item_tokens=tokens)
    batches = host_batches(2, MAIN_B, NUM_USERS, NUM_ITEMS,
                           dead_row(state.params["user_embedding"]), rows_i - 1, seed=3)
    kernels.reset_launch_counts()
    for b in batches:
        state, m = step(state, b, gen)
    loss = float(m["loss"])
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    if any(v != len(batches) for v in launches.values()) or not math.isfinite(loss):
        raise RuntimeError(f"text eager steps: launches {launches}, loss {loss}")
    log(f"  text table {tuple(state.params['text_embedding'].shape)}, tokens "
        f"{tuple(tokens.shape)} ({float((tokens != 0).float().mean()):.3f} not PAD); "
        f"{len(batches)} eager steps, loss {loss:.4f}, launches {launches} (one a step)")
    got = time_graph_step((cfg, opt, state, log_q), item_tokens=tokens)
    log(f"  text replay {got['replay_ms']:.4f} ms ({card})")
    del state, tokens
    torch.cuda.empty_cache()
    return got


def profile_device(fn, n: int, per: str) -> tuple[float, dict[str, int], dict[str, float]]:
    """Device time by kernel over ``n`` calls ``fn(i)`` (torch.profiler), and
    the device's busy share of the window's wall time (the profiler's own
    cost inflates the wall time, so the share is a lower bound). Returns the
    device ms a call, the count of each device event by name and each
    name's device ms a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Device-side events only (kernels, copies): the host ops that launched
    # them report the same time again.
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    log(f"  profile of {n} {per}s: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / wall_ms:.3f} of wall)")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"    {e.self_device_time_total / 1e3 / n:9.4f} ms/{per}  x{e.count / n:5.1f}  "
            f"{e.key[:90]}")
    return (busy_ms / n, {e.key: e.count for e in device},
            {e.key: e.self_device_time_total / 1e3 / n for e in device})


# Device time by kind: the first pattern that matches a kernel's name.
KINDS = [
    ("fused loss", r"fused_loss"),
    ("GEMM", r"gemm|xmma|cutlass|gemv|Kernel2"),
    ("sort", r"sort|radix"),
    ("reduction", r"reduce|Reduce"),
    ("gather/scatter/index", r"index|scatter|gather|Index"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
    ("copy/memset", r"Memcpy|Memset|copy"),
]


def by_kind(times: dict[str, float]) -> dict[str, float]:
    """Device ms a call summed by kind of kernel (``KINDS``, else "other")."""
    out: dict[str, float] = {}
    for name, ms in times.items():
        kind = next((k for k, pat in KINDS if re.search(pat, name)), "other")
        out[kind] = out.get(kind, 0.0) + ms
    return out


SMALL_DATA = ["--synthetic", "--synthetic-users", "200", "--synthetic-items", "100",
              "--synthetic-interactions", "5000"]
SMALL_TRAIN = [
    "--writers", "jsonl", "--override",
    "training.batch_size=64", "training.epochs=2", "model.embedding_dim=16",
    "model.user_tower_dims=[32,16]", "model.item_tower_dims=[32,16]",
    "model.compute_dtype=float32", "model.dropout_rate=0.0",
    "preprocessing.min_interactions_per_user=2",
    "preprocessing.min_interactions_per_item=2",
]
SLICE_DATA = ["--synthetic", "--synthetic-users", "200000", "--synthetic-items", "100000",
              "--synthetic-interactions", "4000000"]
SLICE_TRAIN = ["--writers", "jsonl", "--override", f"training.batch_size={MAIN_B}",
               "training.epochs=2"]
EVAL_B = 4096


def run_cli(main_fn, argv) -> dict:
    """One CLI run in process; returns the JSON it prints last."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    if rc != 0:
        raise RuntimeError(f"{main_fn.__module__} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def epoch_records(ckpt: Path) -> list[dict]:
    lines = (ckpt / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "epoch" in r]


def fresh_dir(path: Path) -> Path:
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    return path


# Phase 6's runs: (label, extra train-model flags, extra overrides).
CLI_VARIANTS = [
    ("sparse adam", [], []),
    ("--synthetic-text", ["--synthetic-text"], ["model.text_buckets=512", "model.text_tokens=8"]),
    ("adamw", [], ["training.optimizer=adamw", "training.weight_decay=0.01"]),
]


def check_cli_card_vs_cpu(label: str = "sparse adam", flags=(), overrides=()):
    """The two CLIs on the card and on the CPU at the tests' sizes: per-epoch
    losses rtol 1e-4, val and test metrics within one rank flip."""
    from twotower_tpu_torch.evaluation.evaluate import main as eval_main
    from twotower_tpu_torch.training.train import main as train_main

    got = {}
    for dev in ("cuda", "cpu"):
        ckpt = fresh_dir(ROOT / "build" / "chip_smoke_cli" / dev)
        args = ["--device", dev, "--checkpoint-dir", str(ckpt)]
        summary = run_cli(train_main, args + SMALL_DATA + list(flags) + SMALL_TRAIN
                          + list(overrides))
        evals = {sub: run_cli(eval_main, args + SMALL_DATA + ["--subset", sub])
                 for sub in ("val", "test")}
        got[dev] = (epoch_records(ckpt), summary, evals)
    (rec_g, sum_g, ev_g), (rec_c, sum_c, ev_c) = got["cuda"], got["cpu"]
    np.testing.assert_allclose([r["loss"] for r in rec_g], [r["loss"] for r in rec_c],
                               rtol=1e-4)
    val_flip, test_flip = 1.0 / ev_c["val"]["rows"], 1.0 / ev_c["test"]["rows"]
    for a, b in zip(rec_g, rec_c):
        for k in [k for k in b if k.startswith("val/")]:
            if abs(a[k] - b[k]) > val_flip:
                raise RuntimeError(f"{k}: card {a[k]} cpu {b[k]} (flip {val_flip})")
    for which, a, b, flip in (("train summary", sum_g["test"], sum_c["test"], test_flip),
                              ("evaluate test", ev_g["test"]["metrics"],
                               ev_c["test"]["metrics"], test_flip),
                              ("evaluate val", ev_g["val"]["metrics"],
                               ev_c["val"]["metrics"], val_flip)):
        bad = {k: (a[k], b[k]) for k in b if abs(a[k] - b[k]) > flip}
        if bad:
            raise RuntimeError(f"{which}: card and CPU differ past one rank flip: {bad}")
    log(f"  {label}: per-epoch loss cuda {[r['loss'] for r in rec_g]} cpu "
        f"{[r['loss'] for r in rec_c]}; test recall@10 cuda {sum_g['test']['recall@10']} cpu "
        f"{sum_c['test']['recall@10']}")


def check_twopass(b: int = 4096, n: int = 100_000, d: int = 128, k: int = 100):
    """topk_mips_twopass against one full torch.topk of the [B, N] scores."""
    from twotower_tpu_torch.ops.topk import float32_products, topk_mips_twopass

    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(b, d, generator=gen, device="cuda")
    c = torch.randn(n, d, generator=gen, device="cuda")
    vals, ids = topk_mips_twopass(q, c, k)
    with float32_products():
        ref_vals, ref_ids = torch.topk(q @ c.T, k, dim=1)
    torch.testing.assert_close(vals, ref_vals, rtol=1e-6, atol=0)
    differ = ids != ref_ids
    # Where the ids differ the scores must be tied: each id's own score.
    with float32_products():
        own = torch.einsum("bkd,bd->bk", c[ids[differ.any(1)]], q[differ.any(1)])
        own_ref = torch.einsum("bkd,bd->bk", c[ref_ids[differ.any(1)]], q[differ.any(1)])
    torch.testing.assert_close(own[differ[differ.any(1)]], own_ref[differ[differ.any(1)]],
                               rtol=1e-6, atol=0)
    rel = float(((vals - ref_vals).abs() / ref_vals.abs()).max())
    log(f"  two-pass top-{k} at B={b} N={n} D={d}: scores within rtol 1e-6 of one full "
        f"torch.topk (max relative difference {rel}); {int(differ.sum())} of "
        f"{differ.numel()} ids differ (tied scores)")


def eval_batch_times(ckpt: Path, card: str):
    """Device ms of one evaluation batch (EVAL_B rows) over the encoded
    corpus of the slice's checkpoint, beside its bound and one float32
    torch.matmul of the same shape."""
    from twotower_tpu_torch.config import load_config_for_checkpoint
    from twotower_tpu_torch.data.vocab import VocabPair
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.evaluation.evaluate import restore_params
    from twotower_tpu_torch.evaluation.metrics import metrics_at_k
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops.topk import float32_products, topk_mips_twopass

    cfg = load_config_for_checkpoint(ckpt)
    vocab = VocabPair.load(ckpt / "vocab")
    nu, ni = len(vocab.users), len(vocab.items)
    params, _ = restore_params(cfg, ckpt, nu, ni, device="cuda")
    ev = Evaluator(cfg, ni, batch_size=EVAL_B, device="cuda")
    corpus = ev._encode_corpus(params)
    gen = torch.Generator(device="cuda").manual_seed(4)
    users = torch.randint(0, nu, (EVAL_B,), generator=gen, device="cuda")
    items = torch.randint(0, ni, (EVAL_B,), generator=gen, device="cuda")

    def batch():
        u = two_tower.embed_users(params, users, cfg.model)
        _, idx = topk_mips_twopass(u, corpus, ev.max_k, chunk_size=ev.corpus_chunk_size)
        return metrics_at_k(idx, items, ev._ks_used)

    with torch.no_grad():
        ms = time_ms(batch, reps=10)
        profile_device(lambda i: batch(), 3, "batch")
        u = two_tower.embed_users(params, users, cfg.model)
        with float32_products():
            matmul_ms = time_ms(lambda: u @ corpus.T, reps=10)
    d = corpus.shape[1]
    ops_ms = 2 * EVAL_B * ni * d / PEAK_F32_FLOPS * 1e3
    bytes_ms = (ni * d + EVAL_B * d) * 4 / PEAK_BYTES * 1e3
    log(f"eval ms per {EVAL_B}-row batch over {ni} items (D={d}, k={ev.max_k}): {ms:.4f}; "
        f"bound {max(ops_ms, bytes_ms):.4f} ({'operations' if ops_ms >= bytes_ms else 'bytes'}: "
        f"f32 FMA {ops_ms:.4f}, bytes {bytes_ms:.4f}); one float32 torch.matmul "
        f"{matmul_ms:.4f} ({card})")


@contextlib.contextmanager
def evaluated_users(into: list):
    """Records the user rows of every ``Evaluator.evaluate`` call inside."""
    from twotower_tpu_torch.evaluation import Evaluator

    orig = Evaluator.evaluate

    def spy(self, params, user_idx, item_idx):
        into.append(np.asarray(user_idx))
        return orig(self, params, user_idx, item_idx)

    Evaluator.evaluate = spy
    try:
        yield
    finally:
        Evaluator.evaluate = orig


def train_and_evaluate(ckpt: Path, train_data: list, eval_data: list, what: str,
                       overrides=()):
    """train-model then evaluate-model on its checkpoint, in process, on the
    card. Launch counts set to 0 just before train-model and read just
    after must equal its steps; finite losses; best val recall@10 at least
    10x random; a checkpoint with meta.json at the best step; evaluate-model
    equal to train_summary.json within 1e-6. Returns the summary, the
    launches, the users of evaluate-model's first call and the best step."""
    from twotower_tpu_torch.evaluation.evaluate import main as eval_main
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training.train import main as train_main

    fresh_dir(ckpt)
    args = ["--device", "cuda", "--checkpoint-dir", str(ckpt)]
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    summary = run_cli(train_main, args + train_data + SLICE_TRAIN + list(overrides))
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    t_train = time.perf_counter() - t0
    records = epoch_records(ckpt)
    steps = int(records[-1]["step"])
    losses = [r["loss"] for r in records]
    step_losses = [json.loads(x).get("train/loss") for x in
                   (ckpt / "metrics.jsonl").read_text().splitlines()]
    if not all(math.isfinite(x) for x in losses + [x for x in step_losses if x is not None]):
        raise RuntimeError(f"{what}: non-finite loss in train-model: {losses}")
    if any(v != steps for v in launches.values()):
        raise RuntimeError(f"{what}: launches {launches} != {steps} steps of train-model")
    random_recall = 10 / summary["num_items"]
    if summary["best_val_metric"] < 10 * random_recall:
        raise RuntimeError(f"{what}: best val recall@10 {summary['best_val_metric']} under "
                           f"10x random ({10 * random_recall})")
    best = summary["best_step"]
    if not (ckpt / f"step_{best:010d}" / "meta.json").exists():
        raise RuntimeError(f"{what}: no checkpoint with meta.json at step {best}")
    t1 = time.perf_counter()
    seen = []
    with evaluated_users(seen):
        ev = run_cli(eval_main, args + eval_data + ["--subset", "test"])
    t_eval = time.perf_counter() - t1
    if ev["checkpoint_step"] != best:
        raise RuntimeError(f"{what}: evaluate-model restored step {ev['checkpoint_step']}, "
                           f"best {best}")
    if best == steps:  # the checkpoint is the state train-model tested
        bad = {k: (ev["metrics"][k], v) for k, v in summary["test"].items()
               if abs(ev["metrics"][k] - v) > 1e-6}
        check = "evaluate-model test metrics equal train_summary.json's within 1e-6"
    else:  # the summary's test metrics are of the last state, not the best
        val = run_cli(eval_main, args + eval_data + ["--subset", "val"])["metrics"]
        bad = ({"recall@10": (val["recall@10"], summary["best_val_metric"])}
               if abs(val["recall@10"] - summary["best_val_metric"]) > 1e-6 else {})
        check = "evaluate-model val recall@10 equals the best val metric within 1e-6"
    if bad:
        raise RuntimeError(f"{what}: evaluate-model disagrees with train-model: {bad}")
    log(f"  train-model ({summary['execution_rung']}): {len(records)} epochs, {steps} steps, "
        f"{summary['num_users']} users x {summary['num_items']} items, losses {losses}, val "
        f"recall@10 {[r.get('val/recall@10') for r in records]} (10x random "
        f"{10 * random_recall}), test recall@10 {summary['test']['recall@10']}; "
        f"{t_train:.1f} s; launches {launches} (one a step)")
    log(f"  evaluate-model: step {ev['checkpoint_step']}, {ev['rows']} rows, recall@10 "
        f"{ev['metrics']['recall@10']}; {check}; {t_eval:.1f} s")
    return summary, launches, seen[0][:EVAL_B], best


def run_slice(card: str):
    """train-model then evaluate-model at full width on the host loop;
    returns the kernels' launch counts over the train-model run, the first
    EVAL_B test rows' users of evaluate-model, the best step and the
    summary."""
    ckpt = ROOT / "build" / "chip_smoke_slice"
    summary, launches, users, best = train_and_evaluate(ckpt, SLICE_DATA, SLICE_DATA,
                                                        "host loop")
    log(f"steady_examples_per_sec {summary['steady_examples_per_sec']} ({card})")
    log(f"train_examples_per_sec {summary['train_examples_per_sec']} ({card})")
    eval_batch_times(ckpt, card)
    return row_launches(launches), users, best, summary


def row_launches(launches: dict) -> dict:
    """Wrapper launch counts under the kernel rows' names."""
    return {"fused_loss_fwd": launches["fused_fwd"],
            "fused_loss_bwd_du": launches["fused_bwd_du"],
            "fused_loss_bwd_dv": launches["fused_bwd_dv"]}


STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def check_device_loop_small():
    """One device-loop epoch at a small size, from one state and one
    permutation, with the warmup + cosine schedule on and dropout 0:
    captured and replayed on the card against the same epoch eager on the
    card (metrics rtol 1e-4, state rtol 1e-4 / atol 1e-5), and against the
    CPU (metrics rtol 1e-4, state the same). The captured run's launches
    must equal its steps."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training import init_train_state, make_optimizer
    from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn

    cfg = Config().with_overrides({
        "model.embedding_dim": 32, "model.user_tower_dims": [64, 32],
        "model.item_tower_dims": [64, 32], "model.compute_dtype": "float32",
        "model.dropout_rate": 0.0, "training.batch_size": 256,
        "training.warmup_steps": 5, "training.decay_steps": 20,
    })
    start = bridge.state_to_numpy(init_train_state(cfg, make_optimizer(cfg.training), 1000, 500,
                                                   device="cpu"))
    rng = np.random.default_rng(8)
    n = 256 * 12 + 37
    users, items = rng.integers(0, 1000, n), rng.integers(0, 500, n)
    log_q = np.log(rng.dirichlet(np.ones(500)) + 1e-9).astype(np.float32)
    perm = rng.permutation(256 * 13)
    runs = {}
    for name, dev, capture in (("graph", "cuda", True), ("eager", "cuda", False),
                               ("cpu", "cpu", False)):
        state = bridge.state_from_numpy(start, device=dev)
        ds = DeviceDataset(users, items, 256, device=dev)
        prog = make_epoch_fn(cfg, make_optimizer(cfg.training), ds.num_steps, num_items=500,
                             device=dev, capture=capture)
        kernels.reset_launch_counts()
        state, m = prog(state, ds.columns, 0, torch.as_tensor(log_q, device=dev), perm=perm)
        runs[name] = ({k: float(v) for k, v in m.items()}, bridge.state_to_numpy(state),
                      {w.__name__: w.launches for w in kernels.WRAPPERS})
    steps = 13
    if any(v != steps for v in runs["graph"][2].values()):
        raise RuntimeError(f"device loop, small: launches {runs['graph'][2]} != {steps} steps")
    for other in ("eager", "cpu"):
        a, b = runs["graph"], runs[other]
        np.testing.assert_allclose([a[0][k] for k in sorted(a[0])], [b[0][k] for k in sorted(a[0])],
                                   rtol=1e-4, err_msg=f"graph vs {other}: epoch metrics")
        for part in ("params", "table_state", "opt_state"):
            for x, y in zip(tree_leaves(a[1][part]), tree_leaves(b[1][part])):
                np.testing.assert_allclose(x, y, **STATE_TOL, err_msg=f"graph vs {other}: {part}")
    log(f"  small epoch ({steps} steps, schedule on): metrics graph {runs['graph'][0]}, eager "
        f"{runs['eager'][0]}, cpu {runs['cpu'][0]}; graph = eager = CPU within the stated "
        f"tolerances; launches {runs['graph'][2]} (one a step)")


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def run_device_loop_slice(card: str, host: dict):
    """Phase 7's run on the device-loop rung (train-model --exec
    device-loop), then evaluate-model on its checkpoint; returns the
    kernels' launch counts over train-model."""
    summary, launches, _, _ = train_and_evaluate(
        ROOT / "build" / "chip_smoke_device_loop", SLICE_DATA + ["--exec", "device-loop"],
        SLICE_DATA, "device loop")
    if summary["execution_rung"] != "device_loop":
        raise RuntimeError(f"train-model reported rung {summary['execution_rung']}")
    for key in ("steady_examples_per_sec", "train_examples_per_sec"):
        log(f"{key} device loop {summary[key]}, host loop {host[key]} "
            f"({summary[key] / host[key]:.2f}x; {card})")
    return row_launches(launches)


@contextlib.contextmanager
def logged(name: str, into: list):
    """Collects the messages of logger ``name`` inside."""
    import logging

    class Collect(logging.Handler):
        def emit(self, record):
            into.append(record.getMessage())

    handler = Collect()
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield
    finally:
        logger.removeHandler(handler)


def run_prepared_slice(card: str):
    """A synthetic draw of phase 7's density (2M interactions) written as
    parquet, prepare-data --streaming over it, train-model --prepared-dir
    --exec auto (which must choose, log and report the device loop), then
    evaluate-model --prepared-dir on its checkpoint."""
    import pandas as pd

    from twotower_tpu_torch.data import generate_interactions
    from twotower_tpu_torch.data.prepare import main as prepare_main

    base = fresh_dir(ROOT / "build" / "chip_smoke_prepared")
    raw_dir, prepared = base / "raw", base / "prepared"
    raw_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    raw = generate_interactions(num_users=100_000, num_items=50_000,
                                num_interactions=2_000_000, device="cuda")
    pd.DataFrame({"user_id": raw.user_id, "parent_asin": raw.item_id, "rating": raw.rating,
                  "timestamp": raw.timestamp}).to_parquet(raw_dir / "interactions.parquet")
    t1 = time.perf_counter()
    stats = run_cli(prepare_main, ["--streaming", "--data-dir", str(raw_dir),
                                   "--output-dir", str(prepared)])
    t2 = time.perf_counter()
    log(f"  draw + parquet {t1 - t0:.1f} s; prepare-data --streaming {t2 - t1:.1f} s: {stats}")
    messages: list[str] = []
    with logged("twotower_tpu_torch.training.train", messages):
        summary, launches, _, _ = train_and_evaluate(
            base / "ckpt", ["--prepared-dir", str(prepared), "--exec", "auto"],
            ["--prepared-dir", str(prepared)], "prepared dir")
    chosen = [m for m in messages if m.startswith("execution rung:")]
    if summary["execution_rung"] != "device_loop" or not chosen or "device_loop" not in chosen[0]:
        raise RuntimeError(f"--exec auto ran {summary['execution_rung']}, logged {chosen}")
    log(f"  {chosen[0]}")
    log(f"steady_examples_per_sec prepared dir {summary['steady_examples_per_sec']}, "
        f"train_examples_per_sec {summary['train_examples_per_sec']} ({card})")
    return row_launches(launches)


# Phase 7d: --synthetic-text at the full model width. The draw makes one
# Python string a row, so its size is cut to 1M interactions (50k users x
# 25k items, the density of phase 7's draw), some 30 s of host time.
TEXT_DATA = ["--synthetic", "--synthetic-users", "50000", "--synthetic-items", "25000",
             "--synthetic-interactions", "1000000"]
# Phase 7e: the same density at half the draw (500k interactions), cut in
# depth to keep the whole script within its earlier length with phase 10.
TRANSFORMER_DATA = ["--synthetic", "--synthetic-users", "25000", "--synthetic-items", "12500",
                    "--synthetic-interactions", "500000"]


def run_text_slice(card: str) -> dict:
    """Phase 7d: train-model --synthetic-text on the device loop with
    model.text_buckets=65536 (the default model otherwise), evaluate-model
    on its checkpoint (``train_and_evaluate``'s checks), then exact serving
    through RetrievalIndex.from_checkpoint over item_tokens.npz equal to the
    evaluation's search bit for bit (``check_serving_trained``)."""
    ckpt = ROOT / "build" / "chip_smoke_text"
    summary, launches, users, best = train_and_evaluate(
        ckpt, TEXT_DATA + ["--synthetic-text", "--exec", "device-loop"], TEXT_DATA,
        "text tower", overrides=["model.text_buckets=65536"])
    with np.load(ckpt / "item_tokens.npz") as f:
        tokens = f["tokens"]
    if summary["execution_rung"] != "device_loop" or tokens.shape != (summary["num_items"], 32):
        raise RuntimeError(f"text slice: rung {summary['execution_rung']}, tokens {tokens.shape}")
    log(f"  item_tokens.npz {tokens.shape}, {float((tokens != 0).mean()):.3f} not PAD; "
        f"steady_examples_per_sec {summary['steady_examples_per_sec']}, "
        f"train_examples_per_sec {summary['train_examples_per_sec']} ({card})")
    serving = check_serving_trained(ckpt, users, best)
    return {"launches": row_launches(launches), "summary": summary, "serving": serving}


# Phase 7e: bert-base-uncased's published widths (its config.json), random
# weights from seed 0, so nothing is downloaded.
BERT_BASE = dict(vocab_size=30_522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512)
# The words of --synthetic-text's draw (data/synthetic.py), one vocab entry each.
SYNTHETIC_WORDS = ("great", "terrible", "quality", "product", "love", "broken", "works", "fast",
                   "shipping", "recommend", "money", "waste")
# encode_vectors, card against CPU: float32 on both with TF32 off, but 12
# layers of products, softmaxes and layer norms summed in other orders (and
# SDPA's CUDA route against its CPU one) over hidden values of order 1.
VECTORS_CARD_CPU_TOL = dict(rtol=1e-3, atol=1e-4)
VECTORS_BATCH_TOL = dict(rtol=1e-4, atol=1e-5)


def write_bert_dir(path: Path) -> Path:
    """A local HF model directory at ``BERT_BASE``'s widths with random
    weights (seed 0): a WordPiece ``vocab.txt`` of BERT's specials at
    bert-base-uncased's ids, the synthetic text's words and filler pieces;
    a ``tokenizer_config.json`` naming ``BertTokenizer``; and a
    config-built ``BertModel``, saved as ``train-model``'s
    ``model.text_model_path`` loads it."""
    import transformers

    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", *SYNTHETIC_WORDS])
    vocab += [f"piece{i}" for i in range(BERT_BASE["vocab_size"] - len(vocab))]
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "BertTokenizer", "do_lower_case": True,
        "model_max_length": BERT_BASE["max_position_embeddings"]}))
    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(**BERT_BASE)).save_pretrained(path)
    return path


@contextlib.contextmanager
def spied(owner, name: str, into: list, keep=lambda out: out):
    """Wraps ``owner.name``: each call appends (positional arguments, keyword
    arguments, ``keep(result)``, host seconds) to ``into``."""
    orig = getattr(owner, name)

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        into.append((args, kwargs, keep(out), time.perf_counter() - t0))
        return out

    setattr(owner, name, spy)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def run_transformer_slice(card: str) -> dict:
    """Phase 7e: train-model with model.text_encoder=transformer at BERT-base's
    widths on phase 7d's draw (the device loop, one epoch), evaluate-model on
    its checkpoint (``train_and_evaluate``'s checks: launches = steps, recall
    at least 10x random); the text table at step 0 equal to the PCA init bit
    for bit; then encode_vectors over the item texts on the card (batch 32 =
    batch 128, and the card = the CPU for 256 items), through the encoder
    train-model built from the model directory, with no device named."""
    from twotower_tpu_torch.features import transformer_encoder as te
    from twotower_tpu_torch.features.text_encoder import select_first_item_texts
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.training import train as train_cli

    t0 = time.perf_counter()
    model_dir = write_bert_dir(fresh_dir(ROOT / "build" / "chip_smoke_bert"))
    t_write = time.perf_counter() - t0
    resolved, per_item, tables = [], [], []
    with spied(train_cli, "_resolve_text_tower", resolved), \
            spied(te.TransformerTextEncoder, "encode_per_item", per_item), \
            spied(two_tower, "init_params", tables,
                  keep=lambda p: p["text_embedding"].detach().cpu().clone()):
        summary, launches, _, _ = train_and_evaluate(
            ROOT / "build" / "chip_smoke_transformer",
            TRANSFORMER_DATA + ["--synthetic-text", "--exec", "device-loop"],
            TRANSFORMER_DATA, "transformer text tower",
            overrides=["model.text_encoder=transformer", f"model.text_model_path={model_dir}",
                       "training.epochs=1"])
    (_, _, (config, encoder, init), t_resolve) = resolved[0]
    rows = two_tower.padded_rows(BERT_BASE["vocab_size"] + 1)
    if (summary["execution_rung"] != "device_loop"
            or config.model.text_buckets != BERT_BASE["vocab_size"] + 1
            or init is None or init.shape != (rows, MAIN_D)):
        raise RuntimeError(f"transformer slice: rung {summary['execution_rung']}, buckets "
                           f"{config.model.text_buckets}, init "
                           f"{None if init is None else init.shape}")
    if not np.array_equal(tables[0][2].numpy(), init):
        raise RuntimeError("the text table at step 0 differs from word_embedding_init's")
    t1 = time.perf_counter()
    again = encoder.word_embedding_init(MAIN_D)
    t_pca = time.perf_counter() - t1
    if not np.array_equal(again, init):
        raise RuntimeError("word_embedding_init is not deterministic")
    (args, kwargs, _, t_per_item) = per_item[0]
    _, texts = select_first_item_texts(*args[1:], **kwargs)  # args[0] is the encoder
    texts = np.array(texts, dtype=object)
    log(f"  BERT-base dir written in {t_write:.1f} s; text buckets {config.model.text_buckets} "
        f"(table {init.shape}); resolve (tokenizer, model, PCA) {t_resolve:.2f} s, "
        f"word_embedding_init(128) again {t_pca:.3f} s, encode_per_item over "
        f"{len(args[1])} rows -> {len(texts)} item texts {t_per_item:.2f} s (host); text "
        "table at step 0 = init bit for bit")

    # train-model's own encoder, its model loaded from model_dir on the host:
    # encode_vectors with no device moves it to the card and runs it there.
    encoder.encode_vectors(texts[:128])  # warm-up
    model_device = next(encoder._require_model().parameters()).device
    if model_device.type != "cuda":
        raise RuntimeError(f"encode_vectors ran the model on {model_device}, not the card")
    t2 = time.perf_counter()
    vec = encoder.encode_vectors(texts, batch_size=128)
    t_vec = time.perf_counter() - t2
    vec32 = encoder.encode_vectors(texts, batch_size=32)
    vec_cpu = encoder.encode_vectors(texts[:256], batch_size=128, device="cpu")
    if vec.shape != (len(texts), BERT_BASE["hidden_size"]) or not np.isfinite(vec).all():
        raise RuntimeError(f"encode_vectors: shape {vec.shape}, finite {np.isfinite(vec).all()}")
    np.testing.assert_allclose(vec32, vec, **VECTORS_BATCH_TOL,
                               err_msg="encode_vectors batch 32 vs 128 on the card")
    np.testing.assert_allclose(vec[:256], vec_cpu, **VECTORS_CARD_CPU_TOL,
                               err_msg="encode_vectors card vs CPU")
    log(f"  encode_vectors: {len(texts)} item texts in {t_vec:.2f} s at batch 128, "
        f"{len(texts) / t_vec:.1f} items/s ({card}); "
        f"batch 32 vs 128 max abs diff {float(np.abs(vec32 - vec).max()):.3g}; card vs CPU "
        f"(256 items) max abs diff {float(np.abs(vec[:256] - vec_cpu).max()):.3g}")
    del encoder
    torch.cuda.empty_cache()
    return {"launches": row_launches(launches), "items_per_s": len(texts) / t_vec}


def run_orchestrate_slice(card: str) -> dict:
    """Phase 7f: an Amazon-schema raw parquet from the synthetic draw,
    orchestrate-pipeline --skip-download --eda twice (the second run resumes:
    prepare skipped), then train-model --prepared-dir on the device loop for
    one epoch, its launches equal to its steps."""
    import pandas as pd

    from twotower_tpu_torch.data import generate_interactions
    from twotower_tpu_torch.data.orchestrate import main as orchestrate_main
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training.train import main as train_main

    base = fresh_dir(ROOT / "build" / "chip_smoke_orchestrate")
    raw, prepared, ckpt = base / "raw", base / "prepared", base / "ckpt"
    raw.mkdir(parents=True)
    t0 = time.perf_counter()
    data = generate_interactions(num_users=20_000, num_items=10_000, num_interactions=200_000,
                                 with_text=True, device="cuda")
    pd.DataFrame({"user_id": data.user_id, "parent_asin": data.item_id, "rating": data.rating,
                  "title": data.title, "text": data.text, "timestamp": data.timestamp},
                 ).to_parquet(raw / "Synthetic_5core.parquet")
    t_raw = time.perf_counter() - t0
    argv = ["--skip-download", "--raw-dir", str(raw), "--processed-dir", str(prepared), "--eda",
            "--max-per-category", "1000000"]
    runs = [run_cli(orchestrate_main, argv) for _ in range(2)]
    status = [{k: v["status"] for k, v in r["stages"].items()} for r in runs]
    want = [{"download": "skipped", "prepare": "ok", "eda": "ok"},
            {"download": "skipped", "prepare": "skipped", "eda": "ok"}]
    if status != want or not all(r["ok"] for r in runs):
        raise RuntimeError(f"orchestrate-pipeline stages {status}, want {want}")
    kernels.reset_launch_counts()
    summary = run_cli(train_main, ["--device", "cuda", "--prepared-dir", str(prepared),
                                   "--exec", "device-loop", "--checkpoint-dir", str(ckpt),
                                   "--no-eval", "--writers", "jsonl", "--override",
                                   f"training.batch_size={MAIN_B}", "training.epochs=1"])
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    steps = int(epoch_records(ckpt)[-1]["step"])
    if summary["execution_rung"] != "device_loop" or any(v != steps for v in launches.values()):
        raise RuntimeError(f"orchestrated train-model: rung {summary['execution_rung']}, "
                           f"launches {launches}, {steps} steps")
    stats = json.loads((prepared / "dataset_stats.json").read_text())
    log(f"  raw parquet ({len(data.user_id)} rows) {t_raw:.1f} s; orchestrate-pipeline: "
        f"{runs[0]['stages']}, then (resumed) {runs[1]['stages']}; artifact "
        f"{stats['num_interactions']} rows, {stats['num_users']} users x {stats['num_items']} "
        f"items; train-model --prepared-dir (device loop, one epoch): {steps} steps, launches "
        f"{launches} (one a step), train_examples_per_sec {summary['train_examples_per_sec']} "
        f"({card})")
    return {"launches": row_launches(launches)}


# Phase 7g: BASELINE config 3 as configs/lifecycle_50m_1chip.yaml ships it
# (embedding 128, towers [512,256,128], bf16 compute, batch 8192, lazy-Adam
# tables, log q, segment_steps 64, async checkpoints 900 s apart, approx
# bfloat16 validation) over the vocab of the JAX package's 50M-row lifecycle
# artifact (benchmarks/results/lifecycle_config3_r5.json: 2,499,952 users x
# 1,145,145 items after 5-core), cut in depth to an 8M-row draw of config 3's
# own corpus generator at its density and two epochs; the stream rung on a
# 1M-row draw over the same vocab (97 steps: a segment of 64 and a short one
# of 33). Per-epoch validation and evaluate-model score LIFECYCLE_HELD
# strided rows (benchmarks/lifecycle_config3.py's --val-rows is a tenth of
# its validation split; so is this).
LIFECYCLE_CONFIG = ROOT / "configs" / "lifecycle_50m_1chip.yaml"
LIFECYCLE_USERS, LIFECYCLE_ITEMS = 2_499_952, 1_145_145
LIFECYCLE_ROWS, LIFECYCLE_STREAM_ROWS = 8_000_000, 1_000_000
LIFECYCLE_HELD = 80_000
LIFECYCLE_SERVE_USERS = 16
# The 8M rows spread over every 6th id: 19 rows a user and 42 an item, config
# 3's density (20 and 43). Over the whole vocab (3 a user) the second epoch's
# validation fell below the first's on the card; at this density it rises.
LIFECYCLE_SPREAD = 6
EXACT_EVAL = ["retrieval.eval_exact=true", "retrieval.eval_corpus_dtype=float32"]


def id_numbers(ids) -> np.ndarray:
    """The numbers of the synthetic generators' ids ("U0001234" -> 1234)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    return pc.cast(pc.utf8_slice_codeunits(pa.array(ids), 1), pa.int64()).to_numpy()


def write_artifact(out: Path, num_users: int, num_items: int, cols: dict) -> Path:
    """A prepare-data artifact written directly (phases 7g and 10b): the
    interactions ``cols`` (user_idx, item_idx, rating, timestamp, in time
    order) over a vocab of ``num_users`` x ``num_items`` (ids zero-padded, so
    their sorted order is their index), in prepare-data's layout:
    combined_interactions.parquet and vocab/, without the host
    preprocessing of a draw that touches every row."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from twotower_tpu_torch.data.vocab import VocabPair, Vocabulary

    out.mkdir(parents=True)
    pq.write_table(pa.table(cols), out / "combined_interactions.parquet")

    def vocab(prefix: str, n: int, idx: np.ndarray) -> Vocabulary:
        ids = np.char.add(prefix, np.char.zfill(np.arange(n).astype(str), 7))
        return Vocabulary(ids=ids.astype(object),
                          counts=np.bincount(idx, minlength=n).astype(np.int64))

    VocabPair(users=vocab("u", num_users, cols["user_idx"]),
              items=vocab("i", num_items, cols["item_idx"])).save(out / "vocab")
    return out


def lifecycle_artifact(out: Path, rows: int) -> Path:
    """Config 3's corpus generator (data/synthetic_scale.py, seed 42, its
    clusters drawn on the card) at ``rows`` interactions over every
    LIFECYCLE_SPREAD-th id of the LIFECYCLE_USERS x LIFECYCLE_ITEMS vocab,
    as a prepare-data artifact."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from twotower_tpu_torch.data.synthetic_scale import generate_parquet

    raw = out.parent / f"{out.name}_raw"
    generate_parquet(raw, num_interactions=rows, num_users=LIFECYCLE_USERS // LIFECYCLE_SPREAD,
                     num_items=LIFECYCLE_ITEMS // LIFECYCLE_SPREAD, use_device=True,
                     device="cuda")
    table = pa.concat_tables([pq.read_table(f) for f in sorted(raw.glob("*.parquet"))])
    return write_artifact(out, LIFECYCLE_USERS, LIFECYCLE_ITEMS, {
        "user_idx": (id_numbers(table["user_id"]) * LIFECYCLE_SPREAD).astype(np.int32),
        "item_idx": (id_numbers(table["parent_asin"]) * LIFECYCLE_SPREAD).astype(np.int32),
        "rating": table["rating"].to_numpy(), "timestamp": table["timestamp"].to_numpy()})


@contextlib.contextmanager
def saves_watched(into: list):
    """Wraps CheckpointManager.save. Before a save that may be skipped it
    waits for the save in flight to land, so that the accept interval is the
    one rule left to skip it; it records each call's step, its force flag,
    the seconds it waited, the peak device memory since the last save (the
    epoch and its validation) and the peak over the save (its snapshot)."""
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    orig = CheckpointManager.save

    def spy(self, step, state, **kwargs):
        t0 = time.perf_counter()
        if not kwargs.get("force"):
            self.flush()
        waited = time.perf_counter() - t0
        epoch_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = orig(self, step, state, **kwargs)
        into.append({"step": step, "force": bool(kwargs.get("force")),
                     "waited_s": round(waited, 2),
                     "epoch_peak_gib": round(epoch_peak / 2**30, 3),
                     "save_peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
        torch.cuda.reset_peak_memory_stats()
        return out

    CheckpointManager.save = spy
    try:
        yield
    finally:
        CheckpointManager.save = orig


@contextlib.contextmanager
def searches_watched(into: list):
    """Records (search, corpus dtype, corpus rows) of every search the
    Evaluator runs inside."""
    from twotower_tpu_torch.evaluation import evaluator

    names = ("topk_mips_approx", "topk_mips_twopass")
    origs = {n: getattr(evaluator, n) for n in names}

    def watch(name):
        def spy(query, corpus, k, **kwargs):
            into.append((name, str(corpus.dtype), corpus.shape[0]))
            return origs[name](query, corpus, k, **kwargs)
        return spy

    for n in names:
        setattr(evaluator, n, watch(n))
    try:
        yield
    finally:
        for n in names:
            setattr(evaluator, n, origs[n])


@contextlib.contextmanager
def segments_watched(into: list):
    """Records the step count of every segment the Trainer's segment runner
    steps through inside."""
    from twotower_tpu_torch.training import loop

    orig = loop.make_segment_runner

    def make(step):
        runner = orig(step)

        def watched(state, batches, rng):
            into.append(int(batches["user_idx"].shape[0]))
            return runner(state, batches, rng)
        return watched

    loop.make_segment_runner = make
    try:
        yield
    finally:
        loop.make_segment_runner = orig


def lifecycle_train(ckpt: Path, prepared: Path, rung: str, epochs: int, into: dict) -> dict:
    """train-model --config LIFECYCLE_CONFIG --exec ``rung`` in process, with
    the launch counts set to 0 just before and read just after (they must
    equal its steps), every epoch validated by the approx search over the
    bfloat16 corpus, and its log, saves, searches and segments recorded in
    ``into``. Returns its summary."""
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training.train import main as train_main

    fresh_dir(ckpt)
    for key in ("messages", "saves", "searches", "segments"):
        into[key] = []
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with logged("twotower_tpu_torch", into["messages"]), saves_watched(into["saves"]), \
            searches_watched(into["searches"]), segments_watched(into["segments"]):
        summary = run_cli(train_main, [
            "--device", "cuda", "--config", str(LIFECYCLE_CONFIG), "--prepared-dir",
            str(prepared), "--checkpoint-dir", str(ckpt), "--exec", rung, "--val-rows",
            str(LIFECYCLE_HELD), "--writers", "jsonl", "--override",
            f"training.epochs={epochs}"])
    into["seconds"] = time.perf_counter() - t
    into["launches"] = {w.__name__: w.launches for w in kernels.WRAPPERS}
    into["records"] = epoch_records(ckpt)
    into["steps"] = steps = int(into["records"][-1]["step"])
    if (summary["num_users"], summary["num_items"]) != (LIFECYCLE_USERS, LIFECYCLE_ITEMS):
        raise RuntimeError(f"lifecycle {rung}: {summary['num_users']} users x "
                           f"{summary['num_items']} items")
    if any(v != steps for v in into["launches"].values()):
        raise RuntimeError(f"lifecycle {rung}: launches {into['launches']} != {steps} steps")
    losses = [r["loss"] for r in into["records"]]
    if len(into["records"]) != epochs or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"lifecycle {rung}: epochs {into['records']}")
    searched = set(into["searches"])
    if searched != {("topk_mips_approx", "torch.bfloat16", LIFECYCLE_ITEMS)}:
        raise RuntimeError(f"lifecycle {rung}: validation searched {searched}, not the approx "
                           "search over the bfloat16 corpus")
    if not all("val/recall@10" in r for r in into["records"]):
        raise RuntimeError(f"lifecycle {rung}: an epoch without validation")
    return summary


def run_lifecycle(card: str) -> dict:
    """Phase 7g (module docstring): config 3 through train-model --exec auto,
    evaluate-model with the exact overrides, train-model --exec stream and
    serve-model's service, at the config's full width."""
    from twotower_tpu_torch.config import load_config_for_checkpoint
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.evaluation.evaluate import main as eval_main
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops.topk import topk_mips_twopass
    from twotower_tpu_torch.serving.api import build_service
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    work = fresh_dir(ROOT / "build" / "chip_smoke_lifecycle")
    t = time.perf_counter()
    prepared = lifecycle_artifact(work / "prepared", LIFECYCLE_ROWS)
    streamed = lifecycle_artifact(work / "prepared_stream", LIFECYCLE_STREAM_ROWS)
    log(f"  artifacts: {LIFECYCLE_ROWS} and {LIFECYCLE_STREAM_ROWS} interactions over "
        f"{LIFECYCLE_USERS} users x {LIFECYCLE_ITEMS} items, written in "
        f"{time.perf_counter() - t:.1f} s")

    # train-model --exec auto: the device loop, two epochs.
    ckpt, auto = work / "auto", {}
    summary = lifecycle_train(ckpt, prepared, "auto", 2, auto)
    chosen = [m for m in auto["messages"] if m.startswith("execution rung:")]
    if summary["execution_rung"] != "device_loop" or not chosen or "device_loop" not in chosen[0]:
        raise RuntimeError(f"lifecycle --exec auto ran {summary['execution_rung']}, logged "
                           f"{chosen}")
    records, steps = auto["records"], auto["steps"]
    first, second = (int(r["step"]) for r in records)
    skipped = [m for m in auto["messages"]
               if m.startswith(f"async checkpoint: skipping step {second} ")]
    backstop = [m for m in auto["messages"] if m.startswith("async checkpoint starvation")]
    manager = CheckpointManager(ckpt)
    best = manager.best_step()
    final = ckpt / f"step_{steps:010d}" / "meta.json"
    if not (len(skipped) == 1 and "accept interval" in skipped[0] and backstop
            and [s["step"] for s in auto["saves"]] == [first, second, steps]
            and [s["force"] for s in auto["saves"]] == [False, False, True]
            and manager.all_steps() == [first, steps] and final.exists()
            and json.loads(final.read_text()).get("post_starvation_final")
            and best == steps == second and summary["best_step"] == second):
        raise RuntimeError(
            f"lifecycle checkpoints: saves {auto['saves']}, skipped {skipped}, backstop "
            f"{backstop}, durable {manager.all_steps()}, best_step() {best}, summary best "
            f"{summary['best_step']} (epoch 2 must improve on epoch 1, its save be skipped "
            "by the 900 s interval and the final state persisted by the backstop)")
    log(f"  {chosen[0]}")
    log(f"  train-model --exec auto ({summary['execution_rung']}): 2 epochs, {steps} steps of "
        f"{LIFECYCLE_B}, losses {[r['loss'] for r in records]}, approx bfloat16 val recall@10 "
        f"{[r['val/recall@10'] for r in records]} over {LIFECYCLE_HELD} rows (10x random "
        f"{100 / LIFECYCLE_ITEMS:.3g}); epochs' examples/s "
        f"{[round(r['examples_per_sec']) for r in records]}; {auto['seconds']:.1f} s; launches "
        f"{auto['launches']} (one a step) ({card})")
    log(f"  saves (step, force, seconds waited for the save in flight, peak device GiB of the "
        f"epoch and its validation before the save, and over the save's snapshot): "
        f"{auto['saves']} ({card}); epoch 2's save skipped: '{skipped[0]}'; backstop: "
        f"'{backstop[0]}'; durable {manager.all_steps()}, best_step() {best}")
    if records[-1]["val/recall@10"] < 10 * 10 / LIFECYCLE_ITEMS:
        raise RuntimeError(f"lifecycle: val recall@10 {records[-1]['val/recall@10']} under 10x "
                           "random")

    # evaluate-model with the exact overrides on best_step()'s checkpoint.
    ev_args = ["--device", "cuda", "--checkpoint-dir", str(ckpt), "--prepared-dir",
               str(prepared), "--rows", str(LIFECYCLE_HELD)]
    t = time.perf_counter()
    seen, searched = [], []
    with evaluated_users(seen), searches_watched(searched):
        test = run_cli(eval_main, ev_args + ["--subset", "test", "--override", *EXACT_EVAL])
    t_eval = time.perf_counter() - t
    if test["checkpoint_step"] != best:
        raise RuntimeError(f"evaluate-model restored step {test['checkpoint_step']}, "
                           f"best_step() {best}")
    if set(searched) != {("topk_mips_twopass", "torch.float32", LIFECYCLE_ITEMS)}:
        raise RuntimeError(f"evaluate-model with the exact overrides searched {set(searched)}")
    val_approx = run_cli(eval_main, ev_args + ["--subset", "val"])["metrics"]
    val_exact = run_cli(eval_main, ev_args + ["--subset", "val", "--override",
                                              *EXACT_EVAL])["metrics"]
    if abs(val_approx["recall@10"] - records[-1]["val/recall@10"]) > 1.0 / LIFECYCLE_HELD:
        raise RuntimeError(f"evaluate-model val recall@10 {val_approx['recall@10']} != the "
                           f"last epoch's {records[-1]['val/recall@10']}")
    log(f"  evaluate-model (exact overrides): step {test['checkpoint_step']} = best_step(), "
        f"{test['rows']} test rows, recall@10 {test['metrics']['recall@10']}, ndcg@10 "
        f"{test['metrics']['ndcg@10']}; {t_eval:.1f} s ({card})")
    log(f"  the same {LIFECYCLE_HELD} val rows: recall@10 approx bfloat16 "
        f"{val_approx['recall@10']} (the last epoch's validation, within one rank flip) / "
        f"exact float32 {val_exact['recall@10']}; ndcg@10 {val_approx['ndcg@10']} / "
        f"{val_exact['ndcg@10']}")

    # train-model --exec stream: one epoch in segments of 64 and a short one.
    sckpt, stream = work / "stream", {}
    ssummary = lifecycle_train(sckpt, streamed, "stream", 1, stream)
    srec, ssteps = stream["records"][-1], stream["steps"]
    want = [64] * (ssteps // 64) + [ssteps % 64]
    if (ssummary["execution_rung"] != "stream" or ssteps % 64 == 0 or ssteps < 64
            or stream["segments"] != want or "segment_time_p50_ms" not in srec):
        raise RuntimeError(f"lifecycle --exec stream: rung {ssummary['execution_rung']}, "
                           f"{ssteps} steps in segments {stream['segments']}, record {srec}")
    log(f"  train-model --exec stream: {ssteps} steps in segments {stream['segments']}, loss "
        f"{srec['loss']}, segment_time_p50_ms {srec['segment_time_p50_ms']}, "
        f"{srec['examples_per_sec']:.0f} examples/s, val recall@10 {srec['val/recall@10']}; "
        f"{stream['seconds']:.1f} s; launches {stream['launches']} (one a step) ({card})")

    # serve-model's service over the auto run's checkpoint, exact and bfloat16.
    # The exact evaluator's reference takes each request's users as one
    # batch, as the service does: the bf16 user tower's GEMMs may round
    # otherwise at another batch size, and near-tied ranks then swap.
    users = seen[0][:LIFECYCLE_SERVE_USERS]
    requests = [users[i:i + 1] for i in range(4)] + [users]
    base = load_config_for_checkpoint(ckpt)
    served = {}
    for label, itype, dtype in SERVE_VARIANTS[:2]:
        t = time.perf_counter()
        service = build_service(serving_config(itype, dtype, base), str(ckpt), device="cuda")
        t_build = time.perf_counter() - t
        if service.index.checkpoint_step != best:
            raise RuntimeError(f"{label} service serves step {service.index.checkpoint_step}")
        rows = [r for q in requests
                for r in service.recommend({"user_idx": q.tolist(), "k": SERVE_K})["results"]]
        vals = np.array([r["scores"] for r in rows])
        ids = np.array([r["item_idx"] for r in rows])
        if vals.shape != (4 + len(users), SERVE_K) or not np.isfinite(vals).all():
            raise RuntimeError(f"{label} service: scores {vals.shape}")
        served[label] = (ids, t_build)
        if label == "float32_exact":
            params = service.index.params
            exact_cfg = base.with_overrides(dict(x.split("=") for x in EXACT_EVAL))
            ev = Evaluator(exact_cfg, LIFECYCLE_ITEMS, batch_size=EVAL_B, device="cuda")
            with torch.no_grad():
                corpus = ev._encode_corpus(params)
                ref = [topk_mips_twopass(
                    two_tower.embed_users(params, torch.as_tensor(q).cuda(), base.model),
                    corpus, SERVE_K, chunk_size=ev.corpus_chunk_size) for q in requests]
            flips = same_topk((vals, ids), (torch.cat([v for v, _ in ref]).cpu().numpy(),
                                            torch.cat([i for _, i in ref]).cpu().numpy()),
                              "lifecycle exact service", atol=1e-6)
            del ev, corpus, ref, params
        del service
        torch.cuda.empty_cache()
    bf16_recall = recall_at(served["bfloat16"][0], served["float32_exact"][0])
    log(f"  serve-model's service over step {best}: exact /recommend for {len(users)} test "
        f"users (4 alone, then one request of {len(users)}) = the exact evaluator's top-"
        f"{SERVE_K} (scores within the responses' 6 decimals, ids equal outside ties; "
        f"{flips} tied ranks with other ids); bfloat16 recall@{SERVE_K} against exact "
        f"{bf16_recall}; builds {served['float32_exact'][1]:.1f} / "
        f"{served['bfloat16'][1]:.1f} s ({card})")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 7g: {seconds:.1f} s ({card})")
    return {
        "launches_auto": row_launches(auto["launches"]),
        "launches_stream": row_launches(stream["launches"]),
        "auto": {"steps": steps, "seconds": auto["seconds"], "saves": auto["saves"],
                 "val_recall_at_10": [r["val/recall@10"] for r in records],
                 "examples_per_sec": [r["examples_per_sec"] for r in records],
                 "steady_examples_per_sec": summary["steady_examples_per_sec"]},
        "evaluate": {"step": test["checkpoint_step"], "rows": test["rows"],
                     "test": test["metrics"], "val_approx": val_approx, "val_exact": val_exact,
                     "seconds": t_eval},
        "stream": {"steps": ssteps, "segments": stream["segments"],
                   "segment_time_p50_ms": srec["segment_time_p50_ms"],
                   "seconds": stream["seconds"]},
        "serve": {"bfloat16_recall_at_100": bf16_recall, "tied_flips": flips},
        "seconds": seconds,
    }

# The config2 oracle corpus, its prepared artifact and its exact ceiling are
# deterministic numpy: the JAX package's record of its config2 run
# (benchmarks/results/oracle_parity_config2.json: the generator's stats,
# the artifact, the temporal split, the ceiling and the plug-in skyline on
# the test split), which a CPU run of the JAX package matches in every
# recall@k and median rank, and in ndcg@k and mrr within 6e-8.
ORACLE_GENERATOR = {"num_interactions": 1_000_000, "items_touched": 98_859,
                    "rating_mean": 4.230074}
ORACLE_ARTIFACT = {"num_interactions": 889_348, "num_users": 5_000, "num_items": 70_076}
ORACLE_SPLIT = (711_478, 88_934, 88_936)
ORACLE_CEILING = {
    "recall@1": 0.005329675272105784, "ndcg@1": 0.005329675272105784,
    "recall@5": 0.0187100836556625, "ndcg@5": 0.011980922999486466,
    "recall@10": 0.030021588558064225, "ndcg@10": 0.015607967808964795,
    "recall@20": 0.04657281640730413, "ndcg@20": 0.019770211604705844,
    "recall@50": 0.07994512908158675, "ndcg@50": 0.026345507469962025,
    "recall@100": 0.11882702167851039, "ndcg@100": 0.03262160028594697,
    "mrr": 0.013976229615773827,
}
ORACLE_PLUGIN = {
    "recall@1": 0.00539713951605649, "ndcg@1": 0.00539713951605649,
    "recall@5": 0.01805792929747234, "ndcg@5": 0.011689366446483072,
    "recall@10": 0.029032112980120536, "ndcg@10": 0.015206180911518874,
    "recall@20": 0.044998650715120984, "ndcg@20": 0.019224272961800213,
    "recall@50": 0.07753890438067824, "ndcg@50": 0.025648441210227885,
    "recall@100": 0.11423945308986237, "ndcg@100": 0.031573458807255726,
    "mrr": 0.01366967643753487,
}
ORACLE_MEDIAN_RANKS = (1676, 1733)  # ceiling, plug-in
# recall@k to one row of the 88,936 test rows; ndcg@k and mrr within 1e-6.
ORACLE_RECALL_TOL, ORACLE_RANK_METRIC_TOL = 1.2e-5, 1e-6
# The student's floor, on the ceiling's recall@10. The JAX package reached
# 0.895 on a TPU (its record); on this artifact on a CPU its own train-model
# and evaluate-model reach 0.8453 and 0.8315 (seeds 42 and 1), and the
# port's students on the H100 spread over 0.81-0.86 with the seed and the
# order of CUDA's atomic adds (tools/oracle_variants.py). The floor sits
# under that spread and far above what a broken student reaches in the JAX
# package's own sweep (dropout 0.1 for 0.25: 0.58; no log-Q: 0.09-0.28).
ORACLE_MIN_FRACTION = 0.75


def check_oracle_metrics(what: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], v) for k, v in want.items()
           if abs(got[k] - v) > (ORACLE_RECALL_TOL if k.startswith("recall")
                                 else ORACLE_RANK_METRIC_TOL)}
    if bad or got.keys() != want.keys():
        raise RuntimeError(f"oracle {what} off the JAX package's record: {bad}")


def run_oracle_parity(card: str) -> dict:
    """The oracle parity run at config2 on the card: the port's twin of the
    JAX benchmark (tools/oracle_parity.py) with its stages in process. The
    generator, artifact, split and ceiling are held to the JAX package's
    record; the student trained on the device loop must reach
    ``ORACLE_MIN_FRACTION`` of the ceiling's recall@10, and each fused-loss
    kernel must launch once a train step."""
    from twotower_tpu_torch.data.prepared import PreparedDataset
    from twotower_tpu_torch.tools.oracle_parity import (
        CountingRunner, in_process_runner, run_pipeline)

    work = fresh_dir(ROOT / "build" / "oracle_config2")
    runner = CountingRunner(other=in_process_runner)
    report = run_pipeline("config2", work, device="cuda", runner=runner)
    launches = runner.launches
    got_gen = {k: report["generator"][k] for k in ORACLE_GENERATOR}
    got_art = {k: report["artifact"][k] for k in ORACLE_ARTIFACT}
    rule = PreparedDataset(work / "prepared").temporal_rule(0.8, 0.1)
    split = (rule.n_train, rule.n_val, rule.n_test)
    if got_gen != ORACLE_GENERATOR or got_art != ORACLE_ARTIFACT or split != ORACLE_SPLIT:
        raise RuntimeError(f"oracle corpus: generator {got_gen}, artifact {got_art}, split "
                           f"{split}; the JAX package's record {ORACLE_GENERATOR}, "
                           f"{ORACLE_ARTIFACT}, {ORACLE_SPLIT}")
    ceiling = report["ceiling"]
    check_oracle_metrics("ceiling", ceiling["metrics"], ORACLE_CEILING)
    check_oracle_metrics("plug-in", ceiling["plugin_metrics"], ORACLE_PLUGIN)
    medians = (ceiling["median_rank"], ceiling["plugin_median_rank"])
    if ceiling["rows"] != ORACLE_SPLIT[2] or medians != ORACLE_MEDIAN_RANKS:
        raise RuntimeError(f"oracle ceiling rows {ceiling['rows']}, median ranks {medians}")
    steps = int(epoch_records(work / "ckpt")[-1]["step"])
    if report["train"]["execution_rung"] != "device_loop":
        raise RuntimeError(f"oracle train stage ran {report['train']['execution_rung']}")
    if any(v != steps for v in launches.values()):
        raise RuntimeError(f"oracle train stage: launches {launches} != {steps} steps")
    fraction = report["ceiling_fraction"]["recall@10"]
    log(f"  generator {got_gen}; artifact {got_art}; split {split}: the JAX package's record")
    log(f"  ceiling recall@10 {ceiling['metrics']['recall@10']}, plug-in "
        f"{ceiling['plugin_metrics']['recall@10']}, median ranks {medians}: within the stated "
        "tolerances of the JAX package's record")
    log(f"  train: {report['train']}; {steps} steps, launches {launches} (one a step)")
    log(f"  student recall@10 {report['student']['metrics']['recall@10']}; ceiling fraction "
        f"{json.dumps(report['ceiling_fraction'])}")
    log(f"  plug-in fraction {json.dumps(report['plugin_fraction'])}")
    log(f"  stage seconds {json.dumps({k: v['seconds'] for k, v in report['stages'].items()})} "
        f"({card})")
    if fraction < ORACLE_MIN_FRACTION:
        raise RuntimeError(f"student reaches {fraction} of the ceiling's recall@10, under "
                           f"{ORACLE_MIN_FRACTION}")
    return {"launches": row_launches(launches), "report": report}


# Phase 7h: the config-3 oracle, tools/oracle_parity.py's config3 preset as
# it stands (embedding 128, towers [512,256,128], batch 8192, dropout 0.25,
# L2 1e-5, lazy-Adam tables, async checkpoints, patience 3; 256 clusters,
# latent 16, within-zipf 0.5, seed 42), cut in depth: the generate stage's
# values through generate_parquet (to force the card's draw), the other
# stages through the tool's own argv. Cuts: rows, users and items all
# divided by ORACLE3_CUT (50M x 250k x 1.2M -> 4,166,666 rows x 20,833
# users x 100,000 items), which keeps the full run's 200 rows a user and 42
# an item, so the 5-core filter keeps nearly every item, as at full depth
# (99.4% against 99.2%); with a twelfth of the items in each cluster a
# user's draws repeat more, and the dedupe keeps 93.6% of the rows against
# 99.0% (measured on the H100); the clusters drawn on the card by force
# (use_device=True: 4.2M x 256 is under 2^31; the full run reaches the
# card's draw by itself); the ceiling, the plug-in and evaluate-model on
# ORACLE3_HELD strided test rows (the full run: 1M); 2 epochs (the full
# run: up to 16). Validation keeps the tool's --val-rows default. The full
# depth is the tool's own run (README's port section).
ORACLE3_CUT = 12
ORACLE3_HELD = 100_000
ORACLE3_EPOCHS = 2
# tools/oracle_parity.py::teacher_digest of the full-shape config-3 teacher
# (250k x 16 user latents, 256 x 16 cluster latents, the clusters and
# log-popularity of 1.2M items; seed 42), computed by the JAX package's
# generator on the CPU (tests/test_torch_oracle_config3.py recomputes it).
ORACLE3_TEACHER_SHA256 = "e90c1be3ffff0c41968b7ed9381301ffe433f5d817076049c3dab159337dcfcc"
ORACLE3_TEACHER_ROWS = 3_000  # rows drawn with it; the teacher is drawn before any row
ORACLE3_RANK_ROWS = 256
# The card's cluster draws against the teacher's P(cluster | user), the rule
# of tests/test_torch_synthetic_scale.py::test_torch_sampler_follows_the_softmax
# at the phase's size: ORACLE3_DRAWS draws for each of ORACLE3_DRAW_USERS
# users of the phase's teacher (256 clusters), the clusters expected fewer
# than 5 times pooled into one bin, and the chi-square statistic under the
# 0.999 quantile of chi2(bins - 1) (Wilson-Hilferty; Z_999 is the normal's).
ORACLE3_DRAWS = 2_000_000
ORACLE3_DRAW_USERS = (0, 1, 2)
Z_999 = 3.090232


def oracle3_preset(cut: int = ORACLE3_CUT) -> dict:
    """The tool's config3 preset with rows, users and items divided by ``cut``."""
    from twotower_tpu_torch.tools.oracle_parity import SCALES

    full = SCALES["config3"]
    return dict(full, rows=full["rows"] // cut, users=full["users"] // cut,
                items=full["items"] // cut)


def generate_oracle3(out: Path, preset: dict, rows: int) -> dict:
    """The generate stage's draw (its argv's values) with the clusters drawn
    on the card."""
    from twotower_tpu_torch.data.synthetic_scale import generate_parquet

    return generate_parquet(out, num_interactions=rows, num_users=preset["users"],
                            num_items=preset["items"], num_clusters=preset["clusters"],
                            latent_dim=preset["latent"], within_zipf=preset["zipf"], seed=42,
                            use_device=True, device="cuda", oracle=True)


def generated_rows(out: Path, stats: dict) -> tuple[np.ndarray, np.ndarray]:
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pa.concat_tables([pq.read_table(out / f) for f in stats["files"]])
    return np.array(id_numbers(table["user_id"])), np.array(id_numbers(table["parent_asin"]))


def check_oracle3_ranks(npz: Path, users: np.ndarray, items: np.ndarray) -> dict:
    """exact_ranks over every item of ``npz``'s teacher, at the chunk its
    free memory gives and at the chunk the full run's 4096-row batches get,
    against an unchunked brute force of the same float32 scores (equal) and
    a float64 one: a rank may differ from the float64 rank only by the
    items that tie the true item in float32 and not in float64."""
    from twotower_tpu_torch.evaluation import oracle

    dev = torch.device("cuda")
    teacher = oracle.OracleTeacher(npz)
    n = teacher.num_items
    run_chunk = oracle._chunk_items(4096, n, dev)
    auto = oracle.exact_ranks(teacher, users, items, device="cuda")
    chunked = oracle.exact_ranks(teacher, users, items, chunk=run_chunk, device="cuda")
    logp = torch.from_numpy(teacher.log_p_clusters(users)).to(dev)
    cluster = torch.from_numpy(teacher.item_cluster.astype(np.int64)).to(dev)
    log_pop = torch.from_numpy(teacher.log_pop).to(dev)
    true = torch.from_numpy(items.astype(np.int64)).to(dev)
    idx = torch.arange(n, device=dev)[None, :]
    r32, r64, ambiguous = [], [], []
    for s in range(0, len(users), 32):
        ti = true[s:s + 32, None]

        def rank(scores):
            t = scores.gather(1, ti)
            return ((scores > t) | ((scores == t) & (idx < ti))).sum(1), scores == t

        a, tie32 = rank(logp[s:s + 32][:, cluster] + log_pop)
        b, tie64 = rank(logp[s:s + 32].double()[:, cluster] + log_pop.double())
        r32.append(a)
        r64.append(b)
        ambiguous.append((tie32 & ~tie64).sum(1))
    r32, r64, ambiguous = (torch.cat(x).cpu().numpy() for x in (r32, r64, ambiguous))
    if not (np.array_equal(auto, r32) and np.array_equal(chunked, r32)):
        raise RuntimeError(f"oracle3 exact ranks off the brute force: {np.abs(auto - r32).max()}, "
                           f"{np.abs(chunked - r32).max()}")
    if (np.abs(r32 - r64) > ambiguous).any():
        raise RuntimeError("oracle3 exact ranks off the float64 brute force past the float32 ties")
    return {"rows": len(users), "items": n, "chunk": run_chunk,
            "equal_float64": int((r32 == r64).sum()), "median_rank": float(np.median(r32))}


def check_oracle3_sampler(npz: Path) -> list[dict]:
    """The card's cluster draws against P(cluster | user) (ORACLE3_DRAWS)."""
    from twotower_tpu_torch.data.synthetic_scale import _ClusterChoiceTorch

    with np.load(npz) as z:
        u_lat, c_lat, scale = z["u_lat"], z["c_lat"], float(z["affinity_scale"])
    pick = _ClusterChoiceTorch(u_lat, c_lat, scale, seed=11, device=torch.device("cuda"))
    out = []
    for user in ORACLE3_DRAW_USERS:
        draws = pick(np.full(ORACLE3_DRAWS, user, np.int64))
        logits = scale * (u_lat[user].astype(np.float64) @ c_lat.T.astype(np.float64))
        logits /= np.sqrt(u_lat.shape[1])
        p = np.exp(logits - logits.max())
        p /= p.sum()
        expected = p * ORACLE3_DRAWS
        observed = np.bincount(draws, minlength=len(p)).astype(np.float64)
        keep = expected >= 5
        exp_b = np.append(expected[keep], expected[~keep].sum())
        obs_b = np.append(observed[keep], observed[~keep].sum())
        chi2 = float(((obs_b - exp_b) ** 2 / exp_b).sum())
        k = len(exp_b) - 1
        bound = k * (1 - 2 / (9 * k) + Z_999 * math.sqrt(2 / (9 * k))) ** 3
        out.append({"user": user, "bins": len(exp_b), "chi2": chi2, "bound": bound})
        if chi2 >= bound:
            raise RuntimeError(f"oracle3 card draws off P(cluster | user): {out[-1]}")
    return out


def run_oracle3(card: str) -> dict:
    """Phase 7h (module docstring): the config-3 oracle at full width, cut
    in depth (ORACLE3_CUT), through tools/oracle_parity.py's stage argv."""
    from twotower_tpu_torch.tools.oracle_parity import (
        SCALES, CountingRunner, in_process_runner, last_json_line, stage_commands,
        student_report, teacher_digest)

    t_phase = time.perf_counter()
    work = fresh_dir(ROOT / "build" / "oracle_config3_cut")
    seconds = {}
    t = time.perf_counter()
    full = work / "teacher_full"
    full_stats = generate_oracle3(full, SCALES["config3"], ORACLE3_TEACHER_ROWS)
    digest = teacher_digest(full / "oracle_teacher.npz")
    if digest != ORACLE3_TEACHER_SHA256:
        raise RuntimeError(f"config-3 teacher digest {digest}, not the JAX package's "
                           f"{ORACLE3_TEACHER_SHA256}")
    users, items = generated_rows(full, full_stats)
    ranks = check_oracle3_ranks(full / "oracle_teacher.npz", users[:ORACLE3_RANK_ROWS],
                                items[:ORACLE3_RANK_ROWS])
    seconds["teacher_checks"] = time.perf_counter() - t
    log(f"  full-shape teacher digest = the JAX package's; exact ranks of {ranks['rows']} rows "
        f"over {ranks['items']} items = the brute force (chunk {ranks['chunk']}; "
        f"{ranks['equal_float64']} equal the float64 ranks, the rest within float32 ties)")

    preset = oracle3_preset()
    t = time.perf_counter()
    gen = generate_oracle3(work / "gen", preset, preset["rows"])
    seconds["generate"] = time.perf_counter() - t
    draws = check_oracle3_sampler(work / "gen" / "oracle_teacher.npz")
    log(f"  card draws against P(cluster | user): {draws}")
    runner = CountingRunner(other=in_process_runner)
    stages = {name: (module, argv) for name, module, argv in stage_commands(
        preset, work, device="cuda", epochs=ORACLE3_EPOCHS, rows_cap=ORACLE3_HELD)}
    outputs = {}
    for name in ("prepare", "ceiling", "train", "evaluate"):
        t = time.perf_counter()
        outputs[name] = runner(*stages[name])
        seconds[name] = time.perf_counter() - t
    artifact = last_json_line(outputs["prepare"])
    ceiling = last_json_line(outputs["ceiling"])
    report = student_report(outputs["train"], outputs["evaluate"], work / "ckpt", ceiling, runner)
    train, student = report["train"], report["student"]
    c10, p10 = ceiling["metrics"]["recall@10"], ceiling["plugin_metrics"]["recall@10"]
    se = math.sqrt(c10 * (1 - c10) / ceiling["rows"])
    random10 = 10 / artifact["num_items"]
    problems = []
    if ceiling["rows"] != ORACLE3_HELD or student["rows"] != ORACLE3_HELD:
        problems.append(f"rows {ceiling['rows']} / {student['rows']}")
    if p10 > c10 + 3 * se:
        problems.append(f"plug-in recall@10 {p10} over the ceiling's {c10} + 3 x {se}")
    if train["execution_rung"] != "device_loop":
        problems.append(f"rung {train['execution_rung']}")
    if any(v != train["steps"] for v in train["launches"].values()):
        problems.append(f"launches {train['launches']} != {train['steps']} steps")
    if train["best_val_metric"] < 10 * random10:
        problems.append(f"best val recall@10 {train['best_val_metric']} under 10x random")
    if student["checkpoint_step"] != train["restorable_best_step"]:
        problems.append(f"evaluate-model restored {student['checkpoint_step']}, best_step() "
                        f"{train['restorable_best_step']}")
    if not all(math.isfinite(v) for v in student["metrics"].values()):
        problems.append(f"student metrics {student['metrics']}")
    if problems:
        raise RuntimeError(f"phase 7h: {problems}")
    seconds["phase"] = time.perf_counter() - t_phase
    log(f"  generator {gen['num_interactions']} rows; artifact {artifact['num_users']} users x "
        f"{artifact['num_items']} items; ceiling recall@10 {c10}, plug-in {p10} (se {se:.2e}); "
        f"train {train}; student recall@10 {student['metrics']['recall@10']}, fraction "
        f"{report['ceiling_fraction']['recall@10']}; seconds {seconds} ({card})")
    return {
        "seconds": seconds, "teacher_sha256": digest, "ranks": ranks, "draws": draws,
        "artifact": {k: artifact[k] for k in ("num_interactions", "num_users", "num_items")},
        "ceiling": ceiling, "train": train, "student": student["metrics"],
        "checkpoint_step": student["checkpoint_step"],
        "ceiling_fraction": report["ceiling_fraction"],
        "plugin_fraction": report["plugin_fraction"],
        "launches": row_launches(train["launches"]),
    }


# Serving: (label, serving.index_type, serving.corpus_dtype) of the four
# resident corpora; the first is the float32 exact reference of the others.
SERVE_VARIANTS = [
    ("float32_exact", "tpu_mips_exact", "float32"),
    ("bfloat16", "tpu_mips", "bfloat16"),
    ("int8", "tpu_mips", "int8"),
    ("int8_rowscale", "tpu_mips", "int8_rowscale"),
]
SERVE_USERS, SERVE_ITEMS = 1_000_000, 10_000_000  # BASELINE config 5's catalogue
SERVE_BATCHES, SERVE_K = (1, 64, 256), 100
SERVE_REQUESTS, SERVE_CONCURRENCY = 2000, (1, 32)
SMALL_SERVE = {"model.embedding_dim": 16, "model.user_tower_dims": [32, 16],
               "model.item_tower_dims": [32, 16], "model.compute_dtype": "float32"}
# H100 SXM dense peaks (NVIDIA data sheet, 700 W) by the resident corpus's
# dtype: a float32 corpus is multiplied with TF32 off, outside the tensor cores.
PEAK_BY_DTYPE = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: 989e12, torch.int8: 1979e12}


def serving_config(index_type: str, corpus_dtype: str, base):
    return base.with_overrides({"serving.index_type": index_type,
                                "serving.corpus_dtype": corpus_dtype})


class IdVocab:
    """Stand-in vocab for a model without a catalogue (random weights):
    each id is its index as a string."""

    class Ids:
        def __init__(self, n: int):
            self.n = n

        def __len__(self) -> int:
            return self.n

        def decode(self, idx):
            return np.asarray(idx).astype(str)

        def encode(self, raw, missing=-1):
            return np.array([int(r) if str(r).isdigit() and int(r) < self.n else missing
                             for r in raw], np.int32)

    def __init__(self, num_users: int, num_items: int):
        self.users, self.items = self.Ids(num_users), self.Ids(num_items)


def same_topk(ours, ref, what: str, atol: float = 0.0, tie_atol: float = 0.0) -> int:
    """Scores within rtol 1e-5 (and ``atol``); ids equal outside tied scores
    (exactly tied, or within ``tie_atol`` where the two sides sum in other
    orders): where the ids differ, ours holds an id the reference ranks at a
    score tied with that rank's, or one past its list where that rank ties
    its last score. Returns the number of tied ranks whose ids differ."""
    (v, i), (rv, ri) = (np.asarray(ours[0]), np.asarray(ours[1])), (np.asarray(ref[0]),
                                                                    np.asarray(ref[1]))
    np.testing.assert_allclose(v, rv, rtol=1e-5, atol=atol, err_msg=what)
    flips = 0
    for r in range(len(i)):
        for j in np.nonzero(i[r] != ri[r])[0]:
            tied = np.abs(rv[r] - rv[r, j]) <= tie_atol
            if not (i[r, j] in ri[r][tied] or (tied[-1] and i[r, j] not in ri[r])):
                raise RuntimeError(f"{what}: row {r} rank {j}: id {i[r, j]} against "
                                   f"{ri[r, j]} outside a tie")
            flips += 1
    return flips


def run_routes(routes, payloads):
    """Each (route, payload) through the coalesced handlers, all at once."""
    import asyncio

    async def go():
        return await asyncio.gather(*(getattr(routes, name)(p) for name, p in payloads))

    return asyncio.run(go())


def response_rows(body):
    """(scores, ids) of a response; IdVocab's item names are the ids."""
    rows = body["results"]
    return (np.array([r["scores"] for r in rows]),
            np.array([[int(x) for x in r["items"]] for r in rows]))


def check_serving_card_vs_cpu():
    """Serving part 1: a tiny model (embedding 16, towers [32,16], float32
    compute; 200 users x 3,000 items) served on the card and on the CPU in
    each corpus variant, through RecommendService and CoalescedRoutes'
    MicroBatchers under asyncio (no HTTP), all three routes with exclusions
    and history queries; and the search functions at the blocked branch."""
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops import topk
    from twotower_tpu_torch.serving import RetrievalIndex
    from twotower_tpu_torch.serving.api import CoalescedRoutes, RecommendService
    from twotower_tpu_torch.training.state import tree_map

    nu, ni = 200, 3000
    base = Config().with_overrides(SMALL_SERVE)
    params = two_tower.init_params(torch.Generator().manual_seed(8), base.model, nu, ni)
    card_params = tree_map(lambda t: t.cuda(), params)
    for label, itype, dtype in SERVE_VARIANTS:
        cfg = serving_config(itype, dtype, base)
        cpu = RetrievalIndex(cfg, params, nu, ni, device="cpu")
        card = RetrievalIndex(cfg, card_params, nu, ni, device="cuda")
        a, b = card.corpus.float().cpu(), cpu.corpus.float()
        if card.quantized:  # one float32 ulp can move a value across a rounding step
            steps = int((a - b).abs().max())
            if steps > 1:
                raise RuntimeError(f"{label}: card and CPU int8 corpora {steps} steps apart")
            torch.testing.assert_close(card.corpus_scale.cpu(), cpu.corpus_scale, rtol=1e-5,
                                       atol=0)
        else:  # bf16: a float32 ulp can move a value one bf16 step (<= 2^-7 relative)
            torch.testing.assert_close(a, b, rtol=2.0**-7 if dtype == "bfloat16" else 1e-5,
                                       atol=1e-6)
        # One corpus for both searches (the card's), so what follows holds
        # the searches and the service, not the encode, card against CPU.
        cpu.corpus = card.corpus.cpu()
        cpu.corpus_scale = None if card.corpus_scale is None else card.corpus_scale.cpu()
        users = np.arange(0, 64, dtype=np.int32)
        hist = np.array([[1, 5, 9, -1], [40, -1, -1, -1], [7, 8, 2999, 1234]])
        emb = np.random.default_rng(9).normal(size=(40, 16)).astype(np.float32)
        flips = sum(same_topk(getattr(card, m)(x, 10), getattr(cpu, m)(x, 10), f"{label} {m}")
                    for m, x in (("recommend", users), ("similar_items", users[:20]),
                                 ("recommend_by_history", hist),
                                 ("recommend_by_embedding", emb)))
        excl = cpu.recommend(users[:8], 10)[1][:, :3]  # each user's top 3
        payloads = (
            [("recommend", {"user_idx": [int(u)], "k": 10, "exclude_idx": excl[u].tolist()})
             for u in range(8)]
            + [("recommend", {"user_idx": list(range(8, 40)), "k": 10}),
               ("similar_items", {"item_idx": [3, 700, 2999], "k": 10}),
               ("recommend_by_history", {"history_idx": [[1, 5, 9], [40]], "k": 10}),
               ("recommend_by_history", {"history_idx": [7, 8], "k": 10,
                                         "exclude_idx": [0, 1, 2]})])
        bodies = {}
        for name, index in (("cuda", card), ("cpu", cpu)):
            service = RecommendService(index, IdVocab(nu, ni), default_k=10)
            bodies[name] = run_routes(CoalescedRoutes(service, window_ms=2.0), payloads)
        for (route, payload), got, want in zip(payloads, bodies["cuda"], bodies["cpu"]):
            # The responses round scores to 6 decimals.
            flips += same_topk(response_rows(got), response_rows(want), f"{label} {route}",
                               atol=1e-6)
        for u in range(8):
            if set(excl[u]) & set(bodies["cuda"][u]["results"][0]["item_idx"]):
                raise RuntimeError(f"{label}: excluded ids served to user {u}")
        log(f"  {label}: card = CPU for recommend, similar_items, recommend_by_history, "
            f"recommend_by_embedding and {len(payloads)} coalesced requests (scores rtol "
            f"1e-5, ids equal outside ties; {flips} tied ranks with other ids)")
    # The search itself at the blocked branch, and int8's raw integer scores.
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(2995, 16)).astype(np.float32))
    corpora = {"float32": (c, None), "bfloat16": (c.bfloat16(), None),
               "int8": topk.quantize_corpus(c), "int8_rowscale": topk.quantize_corpus(
                   c, per_row=True)}
    for label, (corpus, scale) in corpora.items():
        card_scale = None if scale is None else scale.cuda()
        kw = dict(query_chunk=16, item_chunk=1024, num_valid=2990)
        got = topk.topk_mips_approx(q.cuda(), corpus.cuda(), 20, item_scale=card_scale, **kw)
        want = topk.topk_mips_approx(q, corpus, 20, item_scale=scale, **kw)
        same_topk([t.cpu() for t in got], want, f"{label} blocked search")
    qq, _ = topk._quantize_queries(q)
    cq = corpora["int8"][0]
    for rows in (slice(0, 2992), slice(2992, 2995)):  # _int_mm's multiple of 8, a ragged tail
        for qrows in (slice(0, 40), slice(0, 3)):  # more than 16 query rows, and padded
            got = topk._int8_scores(qq[qrows].cuda(), cq[rows].cuda()).cpu()
            if not torch.equal(got.long(), topk._int8_scores(qq[qrows], cq[rows]).long()):
                raise RuntimeError(f"int8 raw scores differ, card against CPU ({rows}, {qrows})")
    log("  search at the blocked branch (3,000 rows in 1,024-row blocks), card = CPU in "
        "every variant; int8 raw integer scores equal, card against CPU")


def check_serving_trained(ckpt: Path, users: np.ndarray, best_step: int) -> dict:
    """Serving part 2: a trained checkpoint (phase 7's; phase 7d's, with item
    tokens) through RetrievalIndex.from_checkpoint; the exact index against
    the Evaluator's own search for ``users``, then each reduced-precision
    corpus's recall."""
    from twotower_tpu_torch.config import load_config_for_checkpoint
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.evaluation.evaluate import load_item_tokens
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops.topk import topk_mips_twopass
    from twotower_tpu_torch.serving import RetrievalIndex

    base = load_config_for_checkpoint(ckpt)
    exact = RetrievalIndex.from_checkpoint(
        serving_config("tpu_mips_exact", "float32", base), ckpt, device="cuda")
    if exact.checkpoint_step != best_step:
        raise RuntimeError(f"served step {exact.checkpoint_step}, best step {best_step}")
    ev = Evaluator(base, exact.num_items, batch_size=EVAL_B,
                   item_tokens=load_item_tokens(ckpt), device="cuda")
    with torch.no_grad():
        emb = two_tower.embed_users(exact.params, torch.as_tensor(users).cuda(), base.model)
        ref_v, ref_i = topk_mips_twopass(emb, ev._encode_corpus(exact.params), SERVE_K,
                                         chunk_size=ev.corpus_chunk_size)
    vals, ids = exact.recommend(users, SERVE_K)
    if not (np.array_equal(ids, ref_i.cpu().numpy()) and np.array_equal(vals, ref_v.cpu().numpy())):
        raise RuntimeError("exact serving differs from the evaluation's search")
    log(f"  {len(users)} test users at k={SERVE_K} over {exact.num_items} items, checkpoint step "
        f"{exact.checkpoint_step}: tpu_mips_exact = Evaluator's topk_mips_twopass (ids equal, "
        "scores bit for bit)")
    params, nu, ni = exact.params, exact.num_users, exact.num_items
    del exact
    recalls = {}
    for label, itype, dtype in SERVE_VARIANTS[1:]:
        index = RetrievalIndex.from_checkpoint(serving_config(itype, dtype, base), ckpt,
                                               device="cuda")
        _, got = index.recommend(users, SERVE_K)
        recalls[label] = recall_at(got, ids)
        del index
    log(f"  recall@{SERVE_K} against exact: {recalls}")
    if recalls["bfloat16"] < 0.95:
        raise RuntimeError(f"bfloat16 recall@{SERVE_K} {recalls['bfloat16']} under 0.95")
    del params
    torch.cuda.empty_cache()
    return {"num_items": ni, "num_users": nu, "recall_at_100": recalls}


CPU_INDEX_QUERIES = 256


def check_cpu_index(ckpt: Path, users: np.ndarray, card: str) -> dict:
    """Phase 8b: the native CPU index (serving/cpu_index.py, built with g++ on
    the card's host) over a trained checkpoint's float32 corpus, exported by
    the exact index and loaded with ``from_npz``, against the card's
    tpu_mips_exact search on the same query embeddings at k=100: scores rtol
    1e-5 plus atol 1e-5 x the largest |score|, ids equal outside ranks tied
    within that atol. A NumPy backend fails the phase."""
    from twotower_tpu_torch.config import load_config_for_checkpoint
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.serving import CpuFlatIndex, RetrievalIndex

    base = load_config_for_checkpoint(ckpt)
    exact = RetrievalIndex.from_checkpoint(serving_config("tpu_mips_exact", "float32", base),
                                           ckpt, device="cuda")
    path = fresh_dir(ROOT / "build" / "chip_smoke_cpu_index") / "corpus.npz"
    exact.export_corpus(path)
    t0 = time.perf_counter()
    index = CpuFlatIndex.from_npz(path)
    t_build = time.perf_counter() - t0
    if index.backend != "native":
        raise RuntimeError(f"CpuFlatIndex took the {index.backend} backend, not the native one")
    with torch.no_grad():
        query = two_tower.embed_users(exact.params, torch.as_tensor(users[:CPU_INDEX_QUERIES])
                                      .cuda(), base.model).float()
    q = query.cpu().numpy()
    ref = exact.recommend_by_embedding(q, SERVE_K)
    got = index.search(q, SERVE_K)
    # A float32 dot product's rounding scales with |q| |c|, not with the
    # score, and a top-100 crosses 0: rtol 1e-5 of the largest score too.
    tol = 1e-5 * float(np.abs(ref[0]).max())
    flips = same_topk(got, ref, "native CPU index vs tpu_mips_exact", atol=tol, tie_atol=tol)
    native_ms = statistics.median(
        _wall_ms(lambda: index.search(q, SERVE_K)) for _ in range(5))
    card_ms = time_ms(lambda: exact._search(query, SERVE_K))
    log(f"  native index ({index.num_threads} threads, built and loaded in {t_build:.2f} s) over "
        f"{index.corpus.shape} float32, {len(q)} queries, k={SERVE_K}: scores within rtol 1e-5 "
        f"+ atol {tol:.3g} of tpu_mips_exact, max abs diff "
        f"{float(np.abs(got[0] - ref[0]).max()):.3g}, ids equal outside ties ({flips} tied "
        f"ranks differ); native {native_ms:.2f} ms (host, median of 5), card "
        f"{card_ms:.4f} ms (device, CUDA events) ({card})")
    del exact
    torch.cuda.empty_cache()
    return {"threads": index.num_threads, "native_ms": native_ms, "card_ms": card_ms,
            "tied_flips": flips}


def _wall_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def recall_at(ids: np.ndarray, exact: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, exact)]))


def search_bound_ms(index, batch: int) -> tuple[float, str]:
    """The least time of one search: the larger of its bytes (the valid
    corpus rows and their scales read once, queries read and [B, k] results
    written once) at 3.35 TB/s, and its products (2 B N D) at the corpus
    dtype's dense peak."""
    n, d = index.num_items, index.corpus.shape[1]
    nbytes = n * d * index.corpus.element_size() + batch * d * 4 + batch * SERVE_K * 12
    if index.corpus_scale is not None and index.corpus_scale.dim():
        nbytes += n * 4
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = 2 * batch * n * d / PEAK_BY_DTYPE[index.corpus.dtype] * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


async def drive_requests(routes, concurrency: int, users: np.ndarray):
    """``concurrency`` clients, each sending its next /recommend as soon as
    the last one returns, until ``users`` is used up; per-request host
    latency and the wall time."""
    feed, latencies = iter(users.tolist()), []

    async def client():
        for u in feed:
            t = time.perf_counter()
            out = await routes.recommend({"user_idx": [u], "k": SERVE_K})
            latencies.append(time.perf_counter() - t)
            if len(out["results"][0]["item_idx"]) != SERVE_K:
                raise RuntimeError(f"short answer for user {u}")

    import asyncio

    t0 = time.perf_counter()
    await asyncio.gather(*(client() for _ in range(concurrency)))
    return np.array(latencies) * 1e3, time.perf_counter() - t0


def serve_full_size(card: str) -> dict:
    """Serving part 3: the default model at random weights (seed 42) over
    1M users x 10M items; each corpus variant's build time, search ms at
    B = 1, 64, 256 beside its bound, and recall@100 against exact; then the
    bfloat16 service end to end and one blue-green reload."""
    import asyncio

    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.serving import RetrievalIndex
    from twotower_tpu_torch.serving.api import CoalescedRoutes, RecommendService

    base = Config()
    t0 = time.perf_counter()
    params = two_tower.init_params(torch.Generator(device="cuda").manual_seed(42), base.model,
                                   SERVE_USERS, SERVE_ITEMS)
    torch.cuda.synchronize()
    log(f"  init_params on the card: {time.perf_counter() - t0:.3f} s, {SERVE_USERS} users x "
        f"{SERVE_ITEMS} items, embedding {base.model.embedding_dim}, towers "
        f"{base.model.user_tower_dims}")
    rng = np.random.default_rng(43)
    recall_users = rng.integers(0, SERVE_USERS, 1024)
    queries = {b: torch.as_tensor(rng.integers(0, SERVE_USERS, b)).cuda() for b in SERVE_BATCHES}
    results, exact_ids = {}, None
    for label, itype, dtype in SERVE_VARIANTS:
        cfg = serving_config(itype, dtype, base)
        torch.cuda.synchronize()
        t = time.perf_counter()
        index = RetrievalIndex(cfg, params, SERVE_USERS, SERVE_ITEMS, device="cuda")
        torch.cuda.synchronize()
        row = {"build_s": time.perf_counter() - t,
               "resident_gb": index.corpus.numel() * index.corpus.element_size() / 1e9}
        _, ids = index.recommend(recall_users, SERVE_K)
        exact_ids = ids if exact_ids is None else exact_ids
        row["recall_at_100"] = recall_at(ids, exact_ids)
        with torch.no_grad():
            for b, users in queries.items():
                emb = two_tower.embed_users(params, users, cfg.model)
                bound, by = search_bound_ms(index, b)
                ms = time_ms(lambda: index._search(emb, SERVE_K))
                row[f"B{b}"] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                                "share_of_bound": bound / ms}
                if label == "bfloat16" and b in (1, 256):
                    log(f"  bfloat16 search at B={b}, by kernel:")
                    profile_device(lambda i: index._search(emb, SERVE_K), 3, "search")
        results[label] = row
        log(f"  {label}: build {row['build_s']:.3f} s, {row['resident_gb']:.3f} GB resident, "
            f"recall@{SERVE_K} {row['recall_at_100']:.4f}; search ms (bound ms, by) "
            + ", ".join(f"B={b} {row[f'B{b}']['ms']:.4f} ({row[f'B{b}']['bound_ms']:.4f}, "
                        f"{row[f'B{b}']['bound_by']})" for b in SERVE_BATCHES) + f" ({card})")
        del index
        torch.cuda.empty_cache()

    cfg = serving_config("tpu_mips", "bfloat16", base)

    def factory(step=None):
        return RetrievalIndex(cfg, params, SERVE_USERS, SERVE_ITEMS, device="cuda")

    service = RecommendService(
        factory(), IdVocab(SERVE_USERS, SERVE_ITEMS), default_k=SERVE_K,
        max_batch=cfg.serving.max_batch_size, index_factory=factory,
        max_exclude=cfg.serving.max_exclude, max_history=cfg.serving.max_history)
    routes = CoalescedRoutes(service, window_ms=cfg.serving.coalesce_window_ms)
    t = time.perf_counter()
    shapes = routes.warmup(service.default_k)
    log(f"  bfloat16 service: warmup of {shapes} (bucket x depth) shapes over the three "
        f"routes {time.perf_counter() - t:.3f} s")
    e2e = {}
    for c in SERVE_CONCURRENCY:
        before = routes.batchers["recommend"].batches
        lat, wall = asyncio.run(drive_requests(routes, c, rng.integers(0, SERVE_USERS,
                                                                         SERVE_REQUESTS)))
        calls = routes.batchers["recommend"].batches - before
        e2e[f"c{c}"] = {"p50_ms": float(np.percentile(lat, 50)),
                        "p99_ms": float(np.percentile(lat, 99)),
                        "qps": SERVE_REQUESTS / wall, "device_calls": calls}
        log(f"  end to end, concurrency {c}, {SERVE_REQUESTS} /recommend: p50 "
            f"{e2e[f'c{c}']['p50_ms']:.3f} ms, p99 {e2e[f'c{c}']['p99_ms']:.3f} ms, "
            f"{e2e[f'c{c}']['qps']:.1f} QPS, {calls} device calls ({card})")
    log("  end to end, concurrency 32, 256 /recommend, by kernel:")
    profile_device(lambda i: asyncio.run(drive_requests(
        routes, 32, rng.integers(0, SERVE_USERS, 256))), 1, "window")
    old = service.index
    probe = {"user_idx": [int(u) for u in recall_users[:4]], "k": SERVE_K}
    want = service.recommend(probe)
    t = time.perf_counter()
    info = service.reload(pre_swap=lambda new: routes.warmup(service.configured_k, index=new))
    routes.pin(service.index)
    reload_s = time.perf_counter() - t
    got = service.recommend(probe)
    if service.index is old or info["generation"] != 1 or [
            r["item_idx"] for r in got["results"]] != [r["item_idx"] for r in want["results"]]:
        raise RuntimeError(f"blue-green reload did not swap in an equal model: {info}")
    log(f"  blue-green reload (build + warmup of every route against the new index + swap): "
        f"{reload_s:.3f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB ({card})")
    del old, service, routes, params
    torch.cuda.empty_cache()
    return {"variants": results, "end_to_end": e2e, "reload_s": reload_s}


SHARDS_8C = 4  # phase 8c's index: four shards sharing cuda:0


def sharded_service(cfg, ckpt: Path, devices: list):
    """build_service's service over ``ckpt``, its index sharded over
    ``devices`` (which may repeat; build_service(shard_corpus=True) takes
    every visible card)."""
    from twotower_tpu_torch.serving import RetrievalIndex
    from twotower_tpu_torch.serving.api import RecommendService

    def factory(step=None):
        return RetrievalIndex.from_checkpoint(cfg, ckpt, step=step, mesh=devices)

    index = factory()
    return RecommendService(index, index.vocab, default_k=cfg.serving.top_k,
                            max_batch=cfg.serving.max_batch_size, index_factory=factory,
                            max_exclude=cfg.serving.max_exclude,
                            max_history=cfg.serving.max_history)


def serve_sharded(card: str, single: dict, ckpt: Path) -> dict:
    """Phase 8c: phase 8's 10M-item model (seed 42) served by a
    RetrievalIndex sharded over [cuda:0] * 4 in each corpus precision,
    held against the single-device index on 256 users (recommend) and 64
    items (similar_items): scores within rtol 1e-5 (the int8 corpora's
    equal), ids equal outside tied ranks; each shard's search device ms at
    B = 1, 64, 256 beside phase 8's single-device figure (``single``, None
    in a partial run). Then build_service(shard_corpus=True) on ``ckpt``
    (phase 10b's train-model --mesh checkpoint, 1M x 500k) shards over every
    visible card, and the service over [cuda:0] * 4 serves through
    CoalescedRoutes: /recommend, /recommend_by_history and /similar_items
    equal to the single-device service's, and one reload."""
    from twotower_tpu_torch.config import Config, load_config_for_checkpoint
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.serving import RetrievalIndex
    from twotower_tpu_torch.serving.api import CoalescedRoutes, build_service

    base = Config()
    params = two_tower.init_params(torch.Generator(device="cuda").manual_seed(42), base.model,
                                   SERVE_USERS, SERVE_ITEMS)
    rng = np.random.default_rng(44)
    users = rng.integers(0, SERVE_USERS, 256)
    items = rng.integers(0, SERVE_ITEMS, 64)
    queries = {b: torch.as_tensor(rng.integers(0, SERVE_USERS, b)).cuda() for b in SERVE_BATCHES}
    mesh = [torch.device("cuda", 0)] * SHARDS_8C
    out = {}
    for label, itype, dtype in SERVE_VARIANTS:
        cfg = serving_config(itype, dtype, base)
        index = RetrievalIndex(cfg, params, SERVE_USERS, SERVE_ITEMS, device="cuda")
        want = index.recommend(users, SERVE_K), index.similar_items(items, SERVE_K)
        del index
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t = time.perf_counter()
        index = RetrievalIndex(cfg, params, SERVE_USERS, SERVE_ITEMS, mesh=mesh)
        torch.cuda.synchronize()
        row = {"build_s": time.perf_counter() - t, "shards": len(index.corpus),
               "shard_rows": index.shard_rows}
        got = index.recommend(users, SERVE_K), index.similar_items(items, SERVE_K)
        flips = 0
        for name, g, w in zip(("recommend", "similar_items"), got, want):
            flips += same_topk(g, w, f"8c {label} {name}")
            if index.quantized and not np.array_equal(g[0], w[0]):
                raise RuntimeError(f"8c {label} {name}: int8 scores differ from one device")
        with torch.no_grad():
            for b, q in queries.items():
                emb = two_tower.embed_users(params, q, cfg.model)
                row[f"B{b}"] = {"ms": time_ms(lambda: index._search(emb, SERVE_K), reps=10),
                                "single_ms": None if single is None
                                else single["variants"][label][f"B{b}"]["ms"]}
        out[label] = row
        log(f"  {label}, {row['shards']} shards of {row['shard_rows']} rows on cuda:0: build "
            f"{row['build_s']:.3f} s; = one device on {len(users)} users and {len(items)} items "
            f"(scores rtol 1e-5{', int8 equal' if index.quantized else ''}, ids outside ties; "
            f"{flips} tied ranks with other ids); search ms sharded (one device) "
            + ", ".join(f"B={b} {row[f'B{b}']['ms']:.4f} ({row[f'B{b}']['single_ms']})"
                        for b in SERVE_BATCHES) + f" ({card})")
        del index
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    cfg = load_config_for_checkpoint(ckpt)
    visible = build_service(cfg, str(ckpt), device="cuda", shard_corpus=True)
    want = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if visible.index.mesh != want:
        raise RuntimeError(f"build_service(shard_corpus=True) sharded over {visible.index.mesh}")
    del visible
    one = build_service(cfg, str(ckpt), device="cuda")
    service = sharded_service(cfg, ckpt, mesh)
    routes = {name: CoalescedRoutes(svc, window_ms=cfg.serving.coalesce_window_ms)
              for name, svc in (("one", one), ("sharded", service))}
    n_users, n_items = service.index.num_users, service.index.num_items
    payloads = [("recommend", {"user_idx": rng.integers(0, n_users, 32).tolist(), "k": 20}),
                ("recommend_by_history",
                 {"history_idx": rng.integers(0, n_items, (8, 5)).tolist(), "k": 20}),
                ("similar_items", {"item_idx": rng.integers(0, n_items, 16).tolist(), "k": 20})]
    bodies = {name: run_routes(r, payloads) for name, r in routes.items()}
    vocab = service.index.vocab

    def rows(body):  # (scores, item indices) of a response, through the vocab
        return (np.array([r["scores"] for r in body["results"]]),
                np.array([vocab.items.encode(np.asarray(r["items"], object))
                          for r in body["results"]]))

    for (route, _), got, ref in zip(payloads, bodies["sharded"], bodies["one"]):
        same_topk(rows(got), rows(ref), f"8c service {route}", atol=1e-6)
    t = time.perf_counter()
    info = service.reload(release_first=True)
    reload_s = time.perf_counter() - t
    again = run_routes(CoalescedRoutes(service), payloads[:1])[0]
    if info["generation"] != 1 or len(service.index.corpus) != SHARDS_8C or (
            again["results"] != bodies["sharded"][0]["results"]):
        raise RuntimeError(f"8c: the sharded service's reload did not rebuild it: {info}")
    log(f"  build_service(shard_corpus=True) over phase 10b's checkpoint ({n_users} users x "
        f"{n_items} items): every visible card by default ({want}); over {SHARDS_8C} shards "
        "on cuda:0, /recommend, /recommend_by_history and /similar_items through "
        f"CoalescedRoutes = the one-device service; reload (release first) {reload_s:.3f} s "
        f"({card})")
    del one, service, routes
    torch.cuda.empty_cache()
    return {"variants": out, "service_reload_s": reload_s}


def run_serving(card: str, ckpt: Path, test_users: np.ndarray, best_step: int) -> dict:
    """Serving phase: returns the numbers it printed."""
    log("  part 1: card against CPU, small")
    check_serving_card_vs_cpu()
    log("  part 2: the trained model (phase 7's checkpoint)")
    trained = check_serving_trained(ckpt, test_users, best_step)
    log(f"  part 3: full size, {SERVE_USERS} users x {SERVE_ITEMS} items")
    full = serve_full_size(card)
    return {"card": card, "trained": trained, **full}


# Phase 10: the mesh. The main path's width with dropout 0 (parity with the
# one-device step) and the a2a buckets of the flagship presets.
MESH_OVER = {"training.batch_size": MAIN_B, "mesh.a2a_capacity_factor": 2.0,
             "model.dropout_rate": 0.0}
MESH_STEPS = 20
MESH_GLOO_STEPS = 5
# One-device step against the mesh step: the JAX tests' state tolerances
# after one step and over several (tests/test_sparse_spmd.py); elements
# with a cancelled gradient within the range of Adam's steps, 2 lr a step:
# an update lies in [-lr, lr], and a gradient near 0 can change its sign
# with the summation order (ROADMAP.md, Queue 3).
MESH_ONE_STEP = dict(rtol=1e-4, atol=1e-6)
MESH_MULTI_STEP = dict(rtol=5e-3, atol=5e-4)
# The share of a leaf's elements (beyond those with a cancelled gradient)
# allowed outside the tolerance, each within the Adam steps: at full width a
# gradient sums 4096 rows, and two ranks' halves summed apart move an
# element whose terms nearly cancel past rtol 1e-4 (one of 131,072 of a
# tower's Adam moments after one step on the card), and over several steps
# an element whose Adam momentum nearly cancels moves by a step.
MESH_OUTLIERS = 1e-5
PROBE_TIMEOUT_S = 90
GLOO_TIMEOUT_S = 240


def mesh_batches(n: int, seed: int = 21) -> list[dict]:
    """Random full-width batches (ids over the 1M x 500k tables, unit
    weights): the same on every rank and in every sub-phase."""
    rng = np.random.default_rng(seed)
    return [{"user_idx": rng.integers(0, NUM_USERS, MAIN_B).astype(np.int32),
             "item_idx": rng.integers(0, NUM_ITEMS, MAIN_B).astype(np.int32),
             "weight": np.ones(MAIN_B, np.float32)} for _ in range(n)]


@contextlib.contextmanager
def cancelled_rows(masks: dict):
    """While open, the lazy-Adam row updates (``training/sparse.py``) add to
    ``masks`` (by table data pointer, as ``cancelled_masks`` keys the dense
    params) the table elements whose summed row gradient was non-zero but
    under 1e-6: the rows' twin of ``cancelled_masks``."""
    from twotower_tpu_torch.training import sparse

    update = sparse.adam_row_update_packed

    def record(table, moments, targets, grads, valid, **kw):
        small = ((grads.abs() < 1e-6) & (grads != 0) & valid[:, None]).float()
        seen = masks.setdefault(table.data_ptr(), torch.zeros_like(table, dtype=torch.bool))
        hits = torch.zeros_like(table).index_add_(0, targets.long(), small)
        seen |= hits > 0
        return update(table, moments, targets, grads, valid, **kw)

    sparse.adam_row_update_packed = record
    try:
        yield masks
    finally:
        sparse.adam_row_update_packed = update


def states_close(got, ref, tol: dict, lr_steps: float, what: str, masks=None,
                 outliers: float = 0.0) -> dict:
    """Every leaf of two whole train states (params, table moments, dense
    optimizer slots) within ``tol``, on the card. ``masks``
    (``cancelled_masks`` of the optimizer that stepped ``ref``, and
    ``cancelled_rows`` around its steps) names the params' elements whose
    gradient was under 1e-6 in some step: those are held to ``lr_steps``
    instead (ROADMAP.md, Queue 3). Over several steps the towers' moved
    elements change the next steps' gradients, and an element whose Adam
    momentum nearly cancels may move by a step too: ``outliers`` is the
    share of a leaf's other elements allowed outside ``tol``, each within
    ``lr_steps``. Returns the largest difference and the counts of
    elements outside ``tol``."""
    from twotower_tpu_torch.utils.checkpoint import state_to_tree

    masks = masks or {}
    worst = {"max_abs": 0.0, "cancelled_outside_tol": 0, "others_outside_tol": 0}
    a, b = tree_leaves(state_to_tree(got)), tree_leaves(state_to_tree(ref))
    if len(a) != len(b):
        raise RuntimeError(f"{what}: {len(a)} leaves against {len(b)}")
    for x, y in zip(a, b):
        if not torch.is_tensor(x):
            if x != y:
                raise RuntimeError(f"{what}: {x} != {y}")
            continue
        y = y.to(x.device)
        diff = (x - y).abs()
        outside = ~torch.isclose(x, y, **tol)
        mask = masks.get(y.data_ptr())
        if mask is not None:
            cancelled = outside & mask
            if cancelled.any() and float(diff[cancelled].max()) > lr_steps:
                raise RuntimeError(f"{what}: a cancelled gradient's element off by "
                                   f"{float(diff[cancelled].max())} > {lr_steps}")
            worst["cancelled_outside_tol"] += int(cancelled.sum())
            outside = outside & ~mask
        n_out = int(outside.sum())
        if n_out and (n_out > outliers * x.numel()
                      or float(diff[outside].max()) > lr_steps):
            raise RuntimeError(f"{what}: {n_out} elements of a leaf {tuple(x.shape)} "
                               f"outside {tol}, up to {float(diff[outside].max())} "
                               f"(allowed: {outliers} of it within {lr_steps})")
        worst["others_outside_tol"] += n_out
        worst["max_abs"] = max(worst["max_abs"], float(diff.max()))
    return worst


GLOO_COLLECTIVES = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter")


def _probe_rank(rank: int, backend: str, store: str, out: str) -> None:
    """One rank of a two-rank probe on the one card: gloo runs each of the
    port's four collectives on CUDA tensors; nccl runs an all-reduce. Each
    outcome is written to ``out``."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    result = {}
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=2)
        x = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * rank
        both = [torch.arange(4.0) + 10 * r for r in range(2)]

        def run(op, out, want):
            op(out)
            torch.cuda.synchronize()
            return "ok" if torch.equal(out.cpu(), want) else f"wrong values {out.tolist()}"

        ops = {
            "all_reduce": lambda: run(lambda o: dist.all_reduce(o), x.clone(), sum(both)),
            "all_gather": lambda: run(lambda o: dist.all_gather_into_tensor(o, x),
                                      x.new_empty(8),
                                      torch.cat(both)),
            "all_to_all": lambda: run(lambda o: dist.all_to_all_single(o, x),
                                      torch.empty_like(x),
                                      torch.cat([b[2 * rank:2 * rank + 2] for b in both])),
            "reduce_scatter": lambda: run(lambda o: dist.reduce_scatter_tensor(o, x),
                                          x.new_empty(2),
                                          sum(both)[2 * rank:2 * rank + 2]),
        }
        for name, op in (ops.items() if backend == "gloo" else [("all_reduce",
                                                                   ops["all_reduce"])]):
            try:  # a probe: the outcome is the finding
                result[name] = op()
            except Exception as exc:  # noqa: BLE001
                result[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    except Exception as exc:  # noqa: BLE001
        result["init"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    Path(out).write_text(json.dumps(result))


def run_ranks_on_card(target, args_of, timeout: float, what: str) -> list:
    """Two spawned processes on the one card running ``target(rank,
    *args_of(rank))``; killed past ``timeout`` s. Returns their exit codes."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args_of(r))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    if hung:
        log(f"  {what}: {len(hung)} rank(s) still running after {timeout} s, killed")
    return [p.exitcode for p in procs]


def probe_backends(work: Path) -> dict:
    """Phase 10a: the NCCL version; whether gloo takes the card's tensors
    in each of the four collectives the port calls (the phase fails if one
    does not: parallel/mesh.py calls them on CUDA tensors as they are);
    whether NCCL refuses two ranks on one device."""
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    log(f"  NCCL {nccl}")
    found = {}
    for backend in ("gloo", "nccl"):
        d = fresh_dir(work / f"probe_{backend}")
        d.mkdir(parents=True)
        codes = run_ranks_on_card(
            _probe_rank, lambda r: (backend, str(d / "store"), str(d / f"rank{r}.json")),
            PROBE_TIMEOUT_S, f"probe {backend}")
        res = [json.loads((d / f"rank{r}.json").read_text())
               if (d / f"rank{r}.json").exists() else {"hung": f"exit {codes[r]}"}
               for r in range(2)]
        found[backend] = res[0]
        if backend == "gloo":
            for c in GLOO_COLLECTIVES:
                log(f"  gloo {c} on CUDA tensors: {res[0].get(c, res[0])}")
        else:
            outcome = res[0].get("all_reduce", res[0].get("init", res[0]))
            refused = outcome != "ok"
            log(f"  nccl, two ranks on one device: {'refused' if refused else 'ACCEPTED'} "
                f"({outcome})")
            found["nccl_refuses_two_ranks"] = refused
    missing = [c for c in GLOO_COLLECTIVES if found["gloo"].get(c) != "ok"]
    if missing:
        raise RuntimeError(f"gloo does not run {missing} on CUDA tensors, which the port's "
                           "two-ranks-on-one-card mesh calls on them")
    return {"nccl": nccl, **found}


def mesh_nccl_one_rank(card: str, work: Path) -> dict:
    """Phase 10b: the mesh of one rank over nccl at the main path's width.
    (1) three steps of the mesh step against the one-device sparse step
    from one init and one set of batches (after one step and after three);
    (2) Trainer(mesh=).fit over 20 batches (host loop) and the device loop's
    epoch on the mesh, captured with its collectives and replayed
    (launches = steps by the counters, and one of each kernel a replay by
    a profiler count); (3) train-model --mesh (host loop, --device-loop)
    and evaluate-model --mesh against evaluate-model."""
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.data import BatchPipeline
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.parallel import build_mesh
    from twotower_tpu_torch.training import (Trainer, init_train_state, make_optimizer,
                                             make_train_step)
    from twotower_tpu_torch.training.train import _EncodedColumns

    cfg = Config().with_overrides(MESH_OVER)
    opt = make_optimizer(cfg.training)
    mesh = build_mesh(cfg.mesh, device="cuda")
    if (mesh.world, mesh.backend) != (1, "nccl"):
        raise RuntimeError(f"phase 10b: a mesh of {mesh.world} rank(s) on {mesh.backend}")
    lr = cfg.training.learning_rate
    opt_one = make_optimizer(cfg.training)
    masks = cancelled_masks(opt_one)
    one = init_train_state(cfg, opt_one, NUM_USERS, NUM_ITEMS)
    state = init_train_state(cfg, opt, NUM_USERS, NUM_ITEMS, mesh=mesh)
    rows_i = state.params["item_embedding"].shape[0]
    log_q = np.log(np.full(rows_i, 1.0 / NUM_ITEMS, np.float32))
    step_one = make_train_step(cfg, opt_one, log_q)
    step_mesh = make_train_step(cfg, opt, log_q, mesh=mesh, state_template=state)
    batches = mesh_batches(MESH_STEPS)
    checks = {}
    first = {w.__name__: 0 for w in kernels.WRAPPERS}
    for i in range(3):
        with cancelled_rows(masks):
            one, m1 = step_one(one, batches[i], None)
        kernels.reset_launch_counts()  # the mesh step's launches alone
        state, mm = step_mesh(state, batches[i], None)
        for w in kernels.WRAPPERS:
            first[w.__name__] += w.launches
        if i == 0:
            for k, rtol in (("loss", 2e-5), ("grad_norm", 1e-4)):
                if not math.isclose(float(mm[k]), float(m1[k]), rel_tol=rtol):
                    raise RuntimeError(f"10b step 1 {k}: mesh {float(mm[k])} one-device "
                                       f"{float(m1[k])}")
            checks["after 1 step"] = states_close(state, one, MESH_ONE_STEP, 2 * lr,
                                                  "10b step 1", outliers=MESH_OUTLIERS,
                                                  masks=masks)
    checks["after 3 steps"] = states_close(state, one, MESH_MULTI_STEP, 2 * 3 * lr,
                                           "10b step 3", outliers=MESH_OUTLIERS,
                                           masks=masks)
    if any(v != 3 for v in first.values()) or float(mm["dropped_ids"]) != 0:
        raise RuntimeError(f"10b: launches {first} over 3 mesh steps, dropped "
                           f"{float(mm['dropped_ids'])}")
    log(f"  mesh step (1 rank, nccl) = one-device step: loss {float(mm['loss'])} vs "
        f"{float(m1['loss'])}; states {checks}; launches {first} over 3 steps")
    del one, step_one
    torch.cuda.empty_cache()

    cols = _EncodedColumns(np.concatenate([b["user_idx"] for b in batches]),
                           np.concatenate([b["item_idx"] for b in batches]))
    fit_cfg = cfg.with_overrides({"training.epochs": 1})
    trainer = Trainer(fit_cfg, log_q=log_q, mesh=mesh)
    kernels.reset_launch_counts()
    t = time.perf_counter()
    res = trainer.fit(state, BatchPipeline(cols, MAIN_B, seed=1))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    host = {w.__name__: w.launches for w in kernels.WRAPPERS}
    if any(v != MESH_STEPS for v in host.values()) or not math.isfinite(res.history[-1]["loss"]):
        raise RuntimeError(f"10b Trainer(mesh=): launches {host} over {MESH_STEPS} steps, "
                           f"loss {res.history[-1]['loss']}")
    log(f"  Trainer(mesh=).fit: {MESH_STEPS} steps in {fit_s:.3f} s (first step's setup "
        f"included), loss {res.history[-1]['loss']:.4f}, dropped_ids "
        f"{res.history[-1]['dropped_ids']}; launches {host} (one a step) ({card})")
    graph = time_graph_step((cfg, opt, res.state, log_q), mesh=mesh)
    out = {"launches_trainer": row_launches(host), "launches_graph": row_launches(
        graph["launches"]), "replay_ms": graph["replay_ms"], "wall_ms": graph["wall_ms"],
        "checks": checks}
    del state, res, trainer
    torch.cuda.empty_cache()
    out.update(mesh_cli(card, work))
    import torch.distributed as dist

    dist.destroy_process_group()  # the world of one this phase started
    return out


# train-model --mesh at the main path's table size: a prepare-data artifact
# written directly, whose vocab is the main path's 1M users x 500k items and
# whose 102,400 interactions give 20 train steps of 4096 at the 80/10/10
# temporal split. The interactions are a latent-factor draw
# (generate_interactions) over 20k users x 10k items spread evenly over the
# vocab (every 50th id), so the held-out users were trained on and the
# metrics that evaluate-model --mesh must match are well above random. So
# the CLI's sharded tables, a2a buckets, collective checkpoint and sharded
# evaluation run at the main path's table size, without the host
# preprocessing of a draw that touches every row (some 20M interactions at
# phase 7's density).
MESH_CLI_ROWS = 20 * MAIN_B * 10 // 8
MESH_CLI_SPREAD = 50  # vocab ids a drawn id
MESH_CLI_TRAIN = ["--writers", "jsonl", "--override", f"training.batch_size={MAIN_B}",
                  "training.epochs=1", "mesh.a2a_capacity_factor=2.0"]


def mesh_cli(card: str, work: Path) -> dict:
    """train-model --mesh --prepared-dir over write_artifact's 1M x
    500k vocab (host loop, then --device-loop), each followed by
    evaluate-model --mesh and evaluate-model on its checkpoint (equal
    within 1e-6); launches = train-model's steps."""
    from twotower_tpu_torch.data import generate_interactions
    from twotower_tpu_torch.evaluation.evaluate import main as eval_main
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training.train import main as train_main

    t = time.perf_counter()
    raw = generate_interactions(num_users=NUM_USERS // MESH_CLI_SPREAD,
                                num_items=NUM_ITEMS // MESH_CLI_SPREAD,
                                num_interactions=MESH_CLI_ROWS, device="cuda")
    data = ["--prepared-dir", str(write_artifact(work / "cli_prepared", NUM_USERS, NUM_ITEMS, {
        "user_idx": (id_numbers(raw.user_id) * MESH_CLI_SPREAD).astype(np.int32),
        "item_idx": (id_numbers(raw.item_id) * MESH_CLI_SPREAD).astype(np.int32),
        "rating": raw.rating, "timestamp": raw.timestamp}))]
    log(f"  artifact: {MESH_CLI_ROWS} interactions over {NUM_USERS} users x {NUM_ITEMS} "
        f"items written in {time.perf_counter() - t:.1f} s")
    out = {}
    for label, extra in (("host", ["--exec", "host"]), ("device_loop", ["--device-loop"])):
        ckpt = fresh_dir(work / f"cli_{label}")
        args = ["--device", "cuda", "--checkpoint-dir", str(ckpt)]
        kernels.reset_launch_counts()
        t = time.perf_counter()
        summary = run_cli(train_main, args + ["--mesh"] + extra + data + MESH_CLI_TRAIN)
        train_s = time.perf_counter() - t
        launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
        records = epoch_records(ckpt)
        steps = int(records[-1]["step"])
        if summary["mesh"] != {"data": 1, "model": 1, "rank": 0, "backend": "nccl"}:
            raise RuntimeError(f"train-model --mesh ran on {summary['mesh']}")
        if summary["execution_rung"] != label:
            raise RuntimeError(f"train-model --mesh {label} ran {summary['execution_rung']}")
        if any(v != steps for v in launches.values()):
            raise RuntimeError(f"train-model --mesh {label}: launches {launches} != {steps}")
        if (summary["num_users"], summary["num_items"]) != (NUM_USERS, NUM_ITEMS):
            raise RuntimeError(f"train-model --mesh ran on {summary['num_users']} users x "
                               f"{summary['num_items']} items")
        meshed = run_cli(eval_main, args + ["--mesh"] + data)
        plain = run_cli(eval_main, args + data)
        bad = {k: (meshed["metrics"][k], v) for k, v in plain["metrics"].items()
               if abs(meshed["metrics"][k] - v) > 1e-6}
        if bad or meshed["checkpoint_step"] != plain["checkpoint_step"]:
            raise RuntimeError(f"evaluate-model --mesh != evaluate-model: {bad}")
        if plain["metrics"]["recall@10"] < 10 * 10 / NUM_ITEMS:
            raise RuntimeError(f"train-model --mesh {label}: test recall@10 "
                               f"{plain['metrics']['recall@10']} under 10x random")
        log(f"  train-model --mesh ({summary['execution_rung']}): {steps} steps, "
            f"{summary['num_users']} users x {summary['num_items']} items, loss "
            f"{records[-1]['loss']:.4f}, {train_s:.1f} s, steady "
            f"{summary['steady_examples_per_sec']:.0f} examples/s ({card}); launches "
            f"{launches} (one a step); evaluate-model --mesh = evaluate-model within 1e-6 "
            f"(recall@10 {plain['metrics']['recall@10']})")
        out[f"launches_cli_{label}"] = row_launches(launches)
    return out


# Phase 10c's sharded state: the evaluation's rows, at the Evaluator's own
# batch (EVAL_B, evaluate-model's and the Trainer's validation batch), and
# the most each of the save, the restore at the mesh layout and the
# evaluation pass may raise a rank's peak device memory over the pass's own
# buffers: one full table (the 1M-row user table). The pass's own buffers
# (pass_buffers) are its corpus shard, as JAX holds it, and the exact
# search's: a [rows a rank, exact_scan_chunk(rows)] float32 score chunk and
# the two-pass search's top-k blocks, [rows, k, 64] float32 for the running
# set, the chunk's, the new set and twice for their concatenation. No
# collective of the three may return a table's worth of rows: the largest
# result of any Axis collective stays under the smallest table (the item
# table).
MESH_EVAL_ROWS, MESH_EVAL_B = 4096, EVAL_B
MESH_RISE_LIMIT = NUM_USERS * MAIN_D * 4
MESH_GATHER_LIMIT = NUM_ITEMS * MAIN_D * 4


def mesh_eval_rows() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(22)
    return (rng.integers(0, NUM_USERS, MESH_EVAL_ROWS).astype(np.int32),
            rng.integers(0, NUM_ITEMS, MESH_EVAL_ROWS).astype(np.int32))


def peak_rise(fn):
    """``fn()``'s result, seconds, and the rise of this process's peak
    device memory over what was allocated when it started."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, torch.cuda.max_memory_allocated() - before


@contextlib.contextmanager
def largest_collective(seen: list):
    """Within the block, the byte size of every result of the mesh's four
    collectives (``Axis.all_reduce``, ``all_gather``, ``all_to_all``,
    ``reduce_scatter``) is appended to ``seen``."""
    from twotower_tpu_torch.parallel.mesh import Axis

    names = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter")
    orig = {n: getattr(Axis, n) for n in names}

    def spy(fn):
        def call(self, t):
            out = fn(self, t)
            seen.append(out.numel() * out.element_size())
            return out
        return call

    for n in names:
        setattr(Axis, n, spy(orig[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(Axis, n, orig[n])


def pass_buffers(cfg, mesh) -> int:
    """Bytes of the mesh evaluation pass's own buffers on a rank (the
    comment above MESH_EVAL_B)."""
    from twotower_tpu_torch.ops.topk import exact_scan_chunk
    from twotower_tpu_torch.parallel.spmd import corpus_shard_rows

    rows = MESH_EVAL_B // mesh.num_data
    k = min(max(cfg.retrieval.top_k_eval), NUM_ITEMS)
    shard = corpus_shard_rows(NUM_ITEMS, mesh.num_model, cfg.retrieval.eval_exact) * MAIN_D
    shard *= getattr(torch, cfg.retrieval.eval_corpus_dtype).itemsize
    return shard + rows * exact_scan_chunk(rows) * 4 + 5 * rows * k * 64 * 4


def shard_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(
        [state.params, state.table_state, state.opt_state.mu, state.opt_state.nu]))


def sharded_state_phase(cfg, opt, mesh, state, ckpt: Path):
    """Phase 10c, on each of the two ranks: the mesh state saved (each rank
    writes its own rows), restored at the same layout into a fresh
    template (each rank reads its own rows) and held to the saved state bit
    for bit, and one Evaluator(mesh=) pass at its own batch; each one's
    seconds, peak device memory rise (under one full table over the pass's
    own buffers) and largest collective result (under the smallest table).
    Returns the numbers and the pass's metrics."""
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.training import init_train_state
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt)
    seen = {"save": [], "restore": [], "eval": []}
    with largest_collective(seen["save"]):
        _, save_s, save_rise = peak_rise(lambda: mgr.save(int(state.step), state))
    template = init_train_state(cfg, opt, NUM_USERS, NUM_ITEMS, mesh=mesh)
    with largest_collective(seen["restore"]):
        (restored, _), restore_s, restore_rise = peak_rise(lambda: mgr.restore(template))
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves([restored.params, restored.table_state, restored.opt_state.mu]),
        tree_leaves([state.params, state.table_state, state.opt_state.mu])))
    if not same or restored.opt_state.count != state.opt_state.count:
        raise RuntimeError(f"rank {mesh.rank}: the mesh restore differs from the saved state")
    del restored, template
    torch.cuda.empty_cache()
    users, items = mesh_eval_rows()
    ev = Evaluator(cfg, NUM_ITEMS, mesh=mesh)
    if ev.batch_size != MESH_EVAL_B:
        raise RuntimeError(f"10c: the Evaluator's batch is {ev.batch_size}, not {MESH_EVAL_B}")
    with largest_collective(seen["eval"]):
        metrics, eval_s, eval_rise = peak_rise(lambda: ev.evaluate(state.params, users, items))
    out = {"shard_bytes": shard_bytes(state), "save_s": save_s, "save_rise": save_rise,
           "restore_s": restore_s, "restore_rise": restore_rise, "eval_s": eval_s,
           "eval_rise": eval_rise, "eval_buffers": pass_buffers(cfg, mesh),
           **{f"{k}_largest_collective": max(v, default=0) for k, v in seen.items()}}
    over = {k: v for k, v in (("save_rise", save_rise), ("restore_rise", restore_rise),
                              ("eval_rise", eval_rise - out["eval_buffers"]))
            if v >= MESH_RISE_LIMIT}
    over.update({k: v for k, v in out.items()
                 if k.endswith("_largest_collective") and v >= MESH_GATHER_LIMIT})
    if over:
        raise RuntimeError(f"rank {mesh.rank}: a table's worth of memory or of a collective's "
                           f"result ({over} bytes; limits {MESH_RISE_LIMIT} over the pass's own "
                           f"buffers, {MESH_GATHER_LIMIT} a collective): {out}")
    return out, metrics


def restored_one(cfg, ckpt: Path, full, metrics: dict, result: dict) -> None:
    """Rank 0 of phase 10c: the mesh checkpoint restored on one device equals
    the gathered state bit for bit, and the one-device Evaluator on it
    equals the mesh pass within 1e-6."""
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.training import init_train_state, make_optimizer
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    one = init_train_state(cfg, make_optimizer(cfg.training), NUM_USERS, NUM_ITEMS)
    one, _ = CheckpointManager(ckpt).restore(one)
    pairs = zip(tree_leaves([one.params, one.table_state, one.opt_state.mu, one.opt_state.nu]),
                tree_leaves([full.params, full.table_state, full.opt_state.mu,
                             full.opt_state.nu]))
    if not all(torch.equal(a, b) for a, b in pairs):
        raise RuntimeError("10c: the mesh checkpoint on one device differs from the gathered state")
    users, items = mesh_eval_rows()
    want = Evaluator(cfg, NUM_ITEMS, device="cuda").evaluate(
        one.params, users, items)
    bad = {k: (metrics[k], v) for k, v in want.items() if abs(metrics[k] - v) > 1e-6}
    if bad or set(want) != set(metrics):
        raise RuntimeError(f"10c: the mesh evaluation != the one-device evaluation: {bad}")
    result["eval"] = want
    del one


def _gloo_rank(rank: int, num_model: int, store: str, out: str) -> None:
    """One of two ranks on the one card over gloo (phase 10c): the full-width
    mesh state, MESH_GLOO_STEPS steps on the batches of phase 10b, the
    kernels' row offsets and launches; rank 0 gathers the state and holds
    it against the one-device steps from the same init."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.parallel import build_mesh, gather_state
    from twotower_tpu_torch.parallel.sharding import data_rows
    from twotower_tpu_torch.training import init_train_state, make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    # float32 compute for the comparison: bf16 rounding of weights that two
    # summation orders moved by an ulp would amplify it (as phases 4-4d).
    cfg = Config().with_overrides({**MESH_OVER, "mesh.num_model": num_model,
                                   "model.compute_dtype": "float32"})
    opt = make_optimizer(cfg.training)
    mesh = build_mesh(cfg.mesh, device="cuda", backend="gloo")
    state = init_train_state(cfg, opt, NUM_USERS, NUM_ITEMS, mesh=mesh)
    devices = {str(t.device) for t in tree_leaves(state.params)}
    if devices != {"cuda:0"} or mesh.device != torch.device("cuda", 0):
        raise RuntimeError(f"rank {rank}: tensors on {devices}, mesh on {mesh.device}")
    from twotower_tpu_torch.models.two_tower import padded_rows

    log_q = np.log(np.full(padded_rows(NUM_ITEMS), 1.0 / NUM_ITEMS, np.float32))
    # A gloo mesh's collectives wait on the host: the device loop refuses to
    # capture them, naming the backend.
    from twotower_tpu_torch.training.device_loop import make_epoch_fn

    refusal = ""
    try:
        make_epoch_fn(cfg, opt, MESH_GLOO_STEPS, num_items=NUM_ITEMS, mesh=mesh)
    except ValueError as exc:
        refusal = str(exc)
    if "gloo" not in refusal:
        raise RuntimeError(f"rank {rank}: the device loop took a gloo mesh on the card "
                           f"({refusal or 'no error'})")
    offsets = []
    block = kernels.fused_in_batch_softmax_block

    def spy(u, v, ids, row_offset, **kw):  # the block the step hands the kernels
        offsets.append((int(row_offset), tuple(u.shape), tuple(v.shape)))
        return block(u, v, ids, row_offset, **kw)

    # ops.dispatch reads the wrapper at each call: the spy stays in place
    # over the mesh steps and comes out before the one-device steps.
    kernels.fused_in_batch_softmax_block = spy
    step = make_train_step(cfg, opt, log_q, mesh=mesh, state_template=state)
    batches = mesh_batches(MESH_GLOO_STEPS)
    times, dropped, launches = [], 0.0, {w.__name__: 0 for w in kernels.WRAPPERS}
    for i, b in enumerate(batches):
        local = {k: data_rows(mesh, torch.as_tensor(v)) for k, v in b.items()}
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, local, None)
        dropped += float(m["dropped_ids"])  # synchronises
        times.append((time.perf_counter() - t) * 1e3)
        for w in kernels.WRAPPERS:
            launches[w.__name__] += w.launches
        if i == 0:
            first = gather_state(state)  # held against one step below
    kernels.fused_in_batch_softmax_block = block
    ckpt = Path(store).parent / "ckpt"
    sharded, metrics = sharded_state_phase(cfg, opt, mesh, state, ckpt)
    full = gather_state(state)
    result = {"rank": rank, "offsets": offsets, "launches": launches, "dropped": dropped,
              "step_ms": times, "loss": float(m["loss"]), "refusal": refusal,
              "shard_rows": state.params["user_embedding"].shape[0], "sharded": sharded}
    del state
    if rank == 0:  # one device: the checkpoint assembles the whole tree, by design
        restored_one(cfg, ckpt, full, metrics, result)
    if rank == 0:
        what = f"10c {2 // num_model}x{num_model}"
        lr = cfg.training.learning_rate
        opt_one = make_optimizer(cfg.training)
        masks = cancelled_masks(opt_one)
        one = init_train_state(cfg, opt_one, NUM_USERS, NUM_ITEMS)
        step_one = make_train_step(cfg, opt_one, log_q)
        checks = {}
        with cancelled_rows(masks):
            for i, b in enumerate(batches):
                one, m1 = step_one(one, b, None)
                if i == 0:
                    checks["after 1 step"] = states_close(
                        first, one, MESH_ONE_STEP, 2 * lr, f"{what} step 1", masks,
                        outliers=MESH_OUTLIERS)
                    del first
        result["one_device_loss"] = float(m1["loss"])
        checks[f"after {MESH_GLOO_STEPS} steps"] = states_close(
            full, one, MESH_MULTI_STEP, 2 * MESH_GLOO_STEPS * lr, f"{what} step 5", masks,
            outliers=MESH_OUTLIERS)
        result["checks"] = checks
    Path(out).write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


def mesh_gloo_two_ranks(card: str, work: Path) -> dict:
    """Phase 10c: two ranks sharing the card over gloo (gloo's own CUDA
    collectives, which copy through host memory; NCCL refuses two ranks on
    one device), layouts 2x1 and 1x2, at the main path's width."""
    out = {}
    for num_model in (1, 2):
        layout = f"{2 // num_model}x{num_model}"
        d = fresh_dir(work / f"gloo_{layout}")
        d.mkdir(parents=True)
        codes = run_ranks_on_card(_gloo_rank,
                                  lambda r: (num_model, str(d / "store"), str(d / f"r{r}.json")),
                                  GLOO_TIMEOUT_S, f"10c {layout}")
        if any(codes) or not all((d / f"r{r}.json").exists() for r in range(2)):
            raise RuntimeError(f"10c {layout}: ranks exited {codes}")
        r0, r1 = (json.loads((d / f"r{r}.json").read_text()) for r in range(2))
        for r in (r0, r1):
            if any(v != MESH_GLOO_STEPS for v in r["launches"].values()) or r["dropped"]:
                raise RuntimeError(f"10c {layout} rank {r['rank']}: launches {r['launches']}, "
                                   f"dropped {r['dropped']}")
        if {o[0] for o in r1["offsets"]} != {MAIN_B // 2} or {o[0] for o in r0["offsets"]} != {0}:
            raise RuntimeError(f"10c {layout}: row offsets {r0['offsets'][0]} "
                               f"{r1['offsets'][0]}")
        step_ms = statistics.median(r0["step_ms"][1:] + r1["step_ms"][1:])
        log(f"  {layout}, gloo on the card: both ranks on cuda:0, {r0['shard_rows']} table rows "
            f"a rank; the device loop refused the mesh ({r0['refusal']}); rank 1's blocks {r1['offsets'][0][1]} rows x {r1['offsets'][0][2]} "
            f"columns at row_offset {r1['offsets'][0][0]}; launches {r1['launches']} a rank "
            f"over {MESH_GLOO_STEPS} steps; dropped_ids 0; gathered state = one-device steps "
            f"{r0['checks']} (loss {r0['loss']:.6f} vs {r0['one_device_loss']:.6f}); median "
            f"step {step_ms:.3f} ms ({card})")
        for r in (r0, r1):
            sh = r["sharded"]
            log(f"  {layout} rank {r['rank']}: live shard {sh['shard_bytes'] / 2**20:.1f} MiB; "
                f"save {sh['save_s']:.3f} s, restore at {layout} {sh['restore_s']:.3f} s, "
                f"evaluation pass ({MESH_EVAL_ROWS} rows, batch {MESH_EVAL_B}) "
                f"{sh['eval_s']:.3f} s; peak device memory rise save "
                f"{sh['save_rise'] / 2**20:.1f} MiB, restore {sh['restore_rise'] / 2**20:.1f} MiB, "
                f"evaluation {sh['eval_rise'] / 2**20:.1f} MiB, of which the pass's own "
                f"buffers {sh['eval_buffers'] / 2**20:.1f} MiB (limit: one table, "
                f"{MESH_RISE_LIMIT / 2**20:.0f} MiB, over those buffers); largest collective "
                f"result save / restore / evaluation "
                + " / ".join(f"{sh[f'{w}_largest_collective'] / 2**20:.2f}"
                             for w in ("save", "restore", "eval"))
                + f" MiB (limit: the item table, {MESH_GATHER_LIMIT / 2**20:.0f} MiB) ({card})")
        log(f"  {layout}: restored = saved bit for bit on each rank and, assembled on one "
            f"device, = the gathered state; mesh evaluation = one-device evaluation within "
            f"1e-6 ({r0['eval']})")
        out[layout] = {"step_ms": step_ms, "launches_rank1": row_launches(r1["launches"]),
                       "offsets_rank1": r1["offsets"][0], "checks": r0["checks"],
                       "sharded_state": {r["rank"]: r["sharded"] for r in (r0, r1)}}
    return out


SCALING_STEPS = 20
SCALING_LAYOUTS = [(2, 1), (1, 2), (2, 2), (4, 1)]


def scaling_tools(card: str, replay_ms: float) -> dict:
    """Phase 10d: scaling-bench (parallel/scaling.py::run_scaling) at the main
    path's width over nccl, one spawned process a rank, for worlds of 1 and
    2 (a world past the visible cards is skipped, as JAX skips it); then
    scaling_model's predictions for 2x1, 1x2, 2x2 and 4x1 at the main
    path's batch a card, from 10d's measured step and from 10b's
    replayed one."""
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.parallel import scaling
    from twotower_tpu_torch.parallel import scaling_model as sm

    cfg = Config().with_overrides(MESH_OVER)
    worlds = [1, 2]
    results = scaling.run_scaling(cfg, worlds, device="cuda", num_users=NUM_USERS,
                                  num_items=NUM_ITEMS, steps=SCALING_STEPS, warmup=5)
    measured = [r["devices"] for r in results]
    if measured != [n for n in worlds if n <= torch.cuda.device_count()] or measured[0] != 1:
        raise RuntimeError(f"scaling-bench measured worlds {measured}")
    first = results[0]
    if first["mesh"] != {"data": 1, "model": 1} or first["efficiency"] != 1.0:
        raise RuntimeError(f"scaling-bench at a world of one: {first}")
    log(f"  scaling-bench over nccl: {json.dumps(results)} (worlds past "
        f"{torch.cuda.device_count()} card(s) skipped) ({card})")
    predictions = {}
    for label, compute in (("scaling_bench_step", first["step_ms"]),
                           ("replayed_step", replay_ms)):
        for d, m in SCALING_LAYOUTS:
            layout = cfg.with_overrides({"training.batch_size": MAIN_B * d * m,
                                         "mesh.num_data": d, "mesh.num_model": m})
            rep = sm.preset_report(layout, compute_ms=compute,
                                   dense_params=sm.dense_tower_params(layout))
            predictions[f"{label}/{d}x{m}"] = {
                "compute_ms": compute, "ici_ms": rep.ici_ms, "dcn_ms": rep.dcn_ms,
                "a2a_bytes": rep.traffic.a2a_per_device,
                "ici_bytes": rep.traffic.ici_per_device,
                "efficiency_serial": rep.efficiency_serial,
                "efficiency_overlapped": rep.efficiency_overlapped}
    log("  scaling_model predictions (NVLink 4 450 GB/s a direction, batch 4096 a card; "
        "predictions, not measurements): " + "; ".join(
            f"{k}: serial {v['efficiency_serial']}, overlapped {v['efficiency_overlapped']} "
            f"(compute {v['compute_ms']:.4f} ms, links {v['ici_ms']} ms)"
            for k, v in predictions.items()))
    return {"scaling_bench": results, "predictions": predictions}


def run_mesh_phase(card: str):
    """Phase 10: the probe, one rank over nccl, two ranks over gloo, the
    scaling tools. Returns 10b's and 10c's numbers, 10d's, and 10b's
    train-model --mesh checkpoint."""
    log("phase 10: the mesh")
    work = fresh_dir(ROOT / "build" / "chip_smoke_mesh")
    work.mkdir(parents=True)
    t = time.perf_counter()
    log("phase 10a: probe")
    probe = probe_backends(work)
    log("phase 10b: one rank over nccl at full width")
    one = mesh_nccl_one_rank(card, work)
    log("phase 10c: two ranks on the card over gloo, 2x1 and 1x2, at full width")
    two = mesh_gloo_two_ranks(card, work)
    log("phase 10d: the scaling tools")
    tools = scaling_tools(card, one["replay_ms"])
    log(json.dumps({"mesh": {"probe": probe, "nccl_1_rank": one, "gloo_2_ranks": two,
                             "scaling": tools}}))
    log(f"  phase 10: {time.perf_counter() - t:.1f} s")
    return one, two, tools, work / "cli_host"


def kernel_timing(batch: int, errs: dict) -> dict:
    """Per kernel at batch x batch x MAIN_D: device ms (one call between
    two events, and back to back), its plain version's, one torch.matmul's
    of the same product, and the bound (see phase 9 in the module
    docstring); ``errs`` are phase 3's max abs errors at this shape."""
    from twotower_tpu_torch.ops import kernels

    u, v, ids, cols, g = loss_inputs(batch, MAIN_D, batch, seed=7)
    args = (u, v, ids, cols, 0)
    lse = kernels.fwd_plain(*args, 1 / TEMP)[1]
    bwd_args = (*args, lse, g, 1 / TEMP)
    r = b = batch
    d = MAIN_D
    io_in = (r + b) * d * 4 + 2 * b * 4  # U, V, ids, cols
    specs = [
        # name, wrapper, plain, arguments, flops, bytes
        ("fused_loss_fwd", kernels.fused_fwd, kernels.fwd_plain, (*args, 1 / TEMP),
         2 * r * b * d, io_in + 4 * r * 4),
        ("fused_loss_bwd_du", kernels.fused_bwd_du, kernels.bwd_du_plain, bwd_args,
         4 * r * b * d, io_in + 2 * r * 4 + r * d * 4),
        ("fused_loss_bwd_dv", kernels.fused_bwd_dv, kernels.bwd_dv_plain, bwd_args,
         4 * r * b * d, io_in + 2 * r * 4 + b * d * 4),
    ]
    library_ms = time_ms(lambda: torch.matmul(u, v.T))
    library_ms_batched = time_ms_batched(lambda: torch.matmul(u, v.T))
    out = {}
    for name, fn, plain, fargs, flops, nbytes in specs:
        ops_ms, route = min((flops / PEAK_F32_FLOPS * 1e3, "f32_fma"),
                            (3 * flops / PEAK_TF32_FLOPS * 1e3, "3xtf32"))
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        ms = time_ms(lambda: fn(*fargs))
        ms_batched = time_ms_batched(lambda: fn(*fargs))
        out[name] = {
            "max_abs_err": errs[name],
            "ms": ms,
            "ms_batched": ms_batched,
            "plain_ms": time_ms(lambda: plain(*fargs)),
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms,
            "library_ms_batched": library_ms_batched,
            "bound_route": route if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": bound_ms / ms,
            "share_of_bound_batched": bound_ms / ms_batched,
            "host_us": host_us(lambda: fn(*fargs)),
        }
    return out


def kernel_times(errs, launches, report):
    """Phase 9's rows: each kernel at the main path's shape, with its
    timing at config 3's batch (phase 7g) under ``at_b8192``."""
    from twotower_tpu_torch.ops import kernels

    wrappers = {"fused_loss_fwd": kernels.fused_fwd, "fused_loss_bwd_du": kernels.fused_bwd_du,
                "fused_loss_bwd_dv": kernels.fused_bwd_dv}
    replaces = {"fused_loss_fwd": "twotower_tpu/ops/pallas_kernels.py:132",
                "fused_loss_bwd_du": "twotower_tpu/ops/pallas_kernels.py:230",
                "fused_loss_bwd_dv": "twotower_tpu/ops/pallas_kernels.py:230"}
    main = kernel_timing(MAIN_B, errs[MAIN_B, MAIN_D, MAIN_B, 0])
    big = kernel_timing(LIFECYCLE_B, errs[LIFECYCLE_B, MAIN_D, LIFECYCLE_B, 0])
    return [{
        "name": name,
        "route": "cuda",
        "source": f"twotower_tpu_torch/ops/csrc/{KERNELS[name][1]}",
        "replaces": replaces[name],
        "launches": launches[wrappers[name].__name__],
        **main[name],
        **report[name],
        "at_b8192": big[name],
    } for name in wrappers]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "twotower_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from twotower_tpu_torch.ops import build, kernels

    log("phase 1: card")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 2: build")
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"  built {sorted(p.name for p in paths.values())} in {time.perf_counter() - t0:.1f} s")
    report = build_report(paths)

    log("phase 3: kernels against their plain versions")
    errs = check_kernels(CHECK_SHAPES)

    if sys.argv[1:] == ["--mesh-only"]:  # a partial run: phases 1-3, 10 and 8c, no result line
        *_, mesh_ckpt = run_mesh_phase(card)
        log("phase 8c: sharded serving")
        serve_sharded(card, None, mesh_ckpt)
        log("phases 1-3, 10 and 8c passed (a partial run: no result line)")
        return 0

    log("phase 4: small-input step, card against CPU")
    check_small_step()

    log("phase 4b: uniform and mixed sampling, card against CPU, graph against eager")
    check_sampling_small()

    log("phase 4c: the optimizers and the dense step, card against CPU, graph against eager")
    check_dense_small()

    log("phase 4d: the text tower, card against CPU, graph against eager")
    check_text_small()

    log("phase 5: main path")
    launches, step_ms, step_device_ms, main = run_main_path()
    graph = time_graph_step(main)
    log(f"  eager step: median {step_ms:.4f} ms, device time {step_device_ms:.4f} ms a step "
        f"({card})")

    log("phase 5b: mixed sampling at full width, replayed")
    mixed = time_mixed_step(main, graph, card)
    del main
    torch.cuda.empty_cache()

    log("phase 5c: the dense step at full width")
    dense = run_dense_full(card)

    log("phase 5d: the text step at full width")
    text = run_text_full(card)

    log("phase 6: train-model and evaluate-model, card against CPU, small")
    for variant in CLI_VARIANTS:
        check_cli_card_vs_cpu(*variant)
    check_twopass()

    log("phase 7: train-model and evaluate-model at full width")
    slice_launches, test_users, best_step, host_summary = run_slice(card)

    log("phase 7b: the device loop")
    check_device_loop_small()
    loop_launches = run_device_loop_slice(card, host_summary)
    run_prepared_slice(card)

    log("phase 7c: oracle parity at config2 (generate, prepare, ceiling, train, evaluate)")
    oracle = run_oracle_parity(card)
    log(json.dumps({"oracle_parity": {k: oracle["report"][k] for k in (
        "ceiling", "ceiling_fraction", "plugin_fraction", "stages", "train", "student")}}))

    log("phase 7d: train-model --synthetic-text, evaluate-model and exact serving")
    text_slice = run_text_slice(card)

    log("phase 7e: train-model with the transformer text encoder at BERT-base's widths")
    transformer = run_transformer_slice(card)

    log("phase 7f: orchestrate-pipeline --skip-download, then train-model --prepared-dir")
    orchestrated = run_orchestrate_slice(card)

    log("phase 7g: the config-3 lifecycle at full width")
    lifecycle = run_lifecycle(card)
    log(json.dumps({"lifecycle": {k: v for k, v in lifecycle.items()
                                  if not k.startswith("launches")}}))

    log("phase 7h: the config-3 oracle at full width, cut in depth")
    oracle3 = run_oracle3(card)
    log(json.dumps({"oracle_config3": {k: v for k, v in oracle3.items() if k != "launches"}}))

    log("phase 8: serving (serve-model's index, service and batcher)")
    kernels.reset_launch_counts()
    serving = run_serving(card, ROOT / "build" / "chip_smoke_slice", test_users, best_step)
    serve_launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
    log(f"  launches of the ported kernels while serving: {serve_launches} (serving runs none)")
    log(json.dumps({"serving": serving}))

    log("phase 8b: the native CPU index against the card's exact index")
    cpu_index = check_cpu_index(ROOT / "build" / "chip_smoke_slice", test_users, card)
    log(json.dumps({"cpu_index": cpu_index}))

    mesh_one, mesh_two, _, mesh_ckpt = run_mesh_phase(card)

    log("phase 8c: sharded serving (after phase 10, whose train-model --mesh checkpoint "
        "it serves)")
    t = time.perf_counter()
    sharded = serve_sharded(card, serving, mesh_ckpt)
    log(json.dumps({"sharded_serving": sharded}))
    log(f"  phase 8c: {time.perf_counter() - t:.1f} s")

    log("phase 9: kernel times")
    rows = kernel_times(errs, launches, report)
    names = {"fused_loss_fwd": "fused_fwd", "fused_loss_bwd_du": "fused_bwd_du",
             "fused_loss_bwd_dv": "fused_bwd_dv"}
    for row in rows:
        row["launches_train_model"] = slice_launches[row["name"]]
        row["launches_device_loop"] = loop_launches[row["name"]]
        row["launches_oracle_parity"] = oracle["launches"][row["name"]]
        row["launches_serve_model"] = serve_launches[names[row["name"]]]
        row["launches_dense_step"] = dense["adam"]["launches"][names[row["name"]]]
        row["launches_text_step"] = text["launches"][names[row["name"]]]
        row["launches_text_train_model"] = text_slice["launches"][row["name"]]
        row["launches_transformer_train_model"] = transformer["launches"][row["name"]]
        row["launches_orchestrated_train_model"] = orchestrated["launches"][row["name"]]
        row["launches_lifecycle_auto"] = lifecycle["launches_auto"][row["name"]]
        row["launches_lifecycle_stream"] = lifecycle["launches_stream"][row["name"]]
        row["launches_oracle_config3"] = oracle3["launches"][row["name"]]
        row["launches_mesh_nccl_trainer"] = mesh_one["launches_trainer"][row["name"]]
        row["launches_mesh_nccl_device_loop"] = mesh_one["launches_graph"][row["name"]]
        row["launches_mesh_nccl_train_model"] = mesh_one["launches_cli_host"][row["name"]]
        row["launches_mesh_nccl_train_model_device_loop"] = (
            mesh_one["launches_cli_device_loop"][row["name"]])
        row["launches_mesh_gloo_2x1_rank1"] = mesh_two["2x1"]["launches_rank1"][row["name"]]
        row["launches_mesh_gloo_1x2_rank1"] = mesh_two["1x2"]["launches_rank1"][row["name"]]
    log(json.dumps({"kernels": rows}))
    log(f"main path median step ms: {step_ms} ({card}); "
        f"{MAIN_B / step_ms * 1e3:.1f} examples/s; replayed from a CUDA graph: "
        f"{graph['replay_ms']} ms, {MAIN_B / graph['replay_ms'] * 1e3:.1f} examples/s; mixed "
        f"sampling replayed: {mixed['replay_ms']} ms; dense adam / adamw replayed: "
        f"{dense['adam']['replay_ms']} / {dense['adamw']['replay_ms']} ms; text replayed: "
        f"{text['replay_ms']} ms; mesh of one rank (nccl) replayed: {mesh_one['replay_ms']} "
        f"ms; two ranks over gloo, a step: 2x1 {mesh_two['2x1']['step_ms']} ms, 1x2 "
        f"{mesh_two['1x2']['step_ms']} ms")
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
