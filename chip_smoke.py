#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
check them: youtube-dnn serving and training, ptb-lstm training,
llama3-8b serving, the SoftmaxHead facade, the sparse refresh,
checkpoint/restart, the overlapped refresh island, the rest of the
sampler registry (the batch-shared sampler, tapas, the paper's oracles),
starcoder2-3b training through the flash attention's backward kernel,
served through the quantized index, falcon-mamba-7b and jamba-v0.1-52b
serving (the SSM, hybrid and MoE layers), their training with
Adafactor and remat, deepseek-v3-671b's MLA and multi-token
prediction, served and trained at 4 of its 61 layers, and
whisper-large-v3's encoder-decoder, served and trained whole, its
cross attention through both attention kernels at a key length apart
from the query length, and youtube-dnn trained and served through the
vocab-parallel head over a (data, model) mesh: NCCL at (1, 1), and four
rank processes sharing the card over gloo at (1, 4) and (2, 2), with
starcoder2-3b, falcon-mamba-7b, whisper-large-v3 and ptb-lstm trained
there by the reference's storage layouts, dbrx-132b, deepseek-v3-671b
and jamba-v0.1-52b with their experts over the model axis, and
llama3-8b and falcon-mamba-7b served there with sequence-sharded KV
caches and channel-sharded states, and jamba-v0.1-52b, dbrx-132b,
deepseek-v3-671b and whisper-large-v3 served there too.

Run from the root of a checkout:  python3 chip_smoke.py [--fresh]

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. device    — the card's name and power limit (nvidia-smi).
  2. build     — nvcc builds every CUDA source of both paths from
                 src/repro_torch/kernels/csrc/ into build/repro_torch/, one
                 nvcc per source, all started together; the tensor-core
                 flash, the zstats, the block_scores tile, the tensor-core
                 sampled_loss, the rff_features, every fused-head and the
                 attention backward's wgmma instantiations must not spill;
                 the mma.sync ones' SASS must hold HMMA, the wgmma ones'
                 HGMMA.
  3. kernels   — each kernel against its plain PyTorch version on the card,
                 with kernel / plain / library device times per call
                 (torch.profiler's device activities over 25 calls after
                 warm-up) and the kernel's per-call time as a caller sees
                 it (CUDA events around 10 back-to-back calls, median of
                 25): at the serving path's shapes (block_scores also
                 ragged: T 19 at r 200, T 257 (a partial 64-query tile),
                 r 1,100 at T 16 and 19 (ragged row and column tiles),
                 and Z's 4-byte copies: r 1,101 at T 19, and a Z not
                 16-byte aligned at T 16;
                 its times cover both its kernels), then
                 at the training path's (zstats (391, 256, 128),
                 block_scores T = 256 x 391 blocks, leaf_scores square
                 (32768, 256, 128), fused_lse / fused_lse_bwd at T = 256,
                 K = 129 over a 100,000 x 128 head, both abs modes, with
                 90% of the slots on 3 rows, in bf16, plus ragged widths;
                 every case also two calls bitwise equal, and the
                 backward's device ms split by its three kernels).
  4. serving   — youtube-dnn at full width (100,000 items, 128-wide head):
                 random seeded weights, retrieval index build, and 96
                 requests (watch history + user features -> the port's tower
                 on the card -> h) through the ServingEngine (beam 256).
  5. exact     — full-beam decode (gram bound on levels 1-9 through
                 block_scores) equals the dense top-k, ties aside; narrow-beam
                 logits equal their dense logits.
  6. training  — youtube-dnn at full width: 60 steps of fit (batch 256,
                 sync block-quadratic refresh every step, m = 128, abs-mode
                 eq. 2/3 loss through the fused head, clip + AdamW) over a
                 cycled pool of 8 batches, where the loss must fall;
                 full-softmax loss of a held-out batch before and after;
                 the fused head's kernels against its plain path (and two
                 calls bitwise equal) on a real step's inputs from the
                 initial state and from the trained one (its ids timed
                 too, as skewed_*); the trained head exported as a
                 retrieval index that decodes 16 queries.
 6b. fresh     — only with --fresh: 60 steps over fresh batches with the
                 sampled loss and with the exact full softmax, reported,
                 not gated.
  7. breakdown — host-clock times of one training step's stages, a
                 torch.profiler trace of three training steps (device time
                 by kernel, device busy share: the union of the device
                 intervals over the host wall), and host-clock times of one
                 decode's stages per bucket.
  8. hierarchical kernels — rff_features (512 leaves of 256 rows, d = 128,
                 D = 128; and 33 draws of 37 leaves of 50 rows, d 126, D
                 100, tau 0.7; each against its plain version evaluated in
                 float64, RTOL, the fp32 plain version's own distance
                 logged beside), midx_pair_masses (T = 256 x 512 lists, both
                 entries, fp32 and bf16, also at T 37, P 100, d 126; empty
                 lists exactly 0, two calls bitwise equal; timed beside
                 its ct entry, bf16 and the call with the codeword-pair
                 expansion outside the kernel) and
                 midx_member_scores (32,768 draws x 256 rows) against their
                 plain versions at the training shapes, padded rows and
                 empty lists present, with the same times as phase 3; and
                 two earlier kernels at shapes only these paths give them:
                 block_scores at T = 256 on each of the tree's nine dense
                 levels (2 to 512 nodes, true counts, alpha = 100) and
                 leaf_scores' dot mode at rff's leaf step (32768, 256, 128).
  9. hierarchical training — youtube-dnn at full width through fit with
                 sampler tree-quadratic, rff and midx in turn (60 steps each
                 on the pool of phase 6): the loss must fall, the launch
                 counts must be exact, and on 4 held-out queries the logq
                 each sampler reports for its draws must equal its
                 all_class_logq at those ids within 1e-4, no id at or past
                 n_valid; then per family the host ms of its refresh,
                 sampler and whole step and a torch.profiler trace of one
                 step.
 9b. ptb-lstm    — the paper's own language model at full width (vocab
                 10,000, 2 LSTM layers of 200, block-quadratic over 79
                 blocks of 128, m = 128, abs mode, fp32) through fit at
                 Zaremba et al.'s medium batch, 20 x 35 tokens (T = 700):
                 60 steps on a cycled pool of 8 batches with exact launch
                 counts, a finite loss at every step that falls, peak
                 memory; then one step of the trained state with each of
                 its five kernels held against its plain version on the
                 step's own inputs and timed there (zstats (79, 128, 200),
                 block_scores 700 x 79, leaf_scores (89,600, 128, 200),
                 the fused head at T 700, K 129, n 10,000, d 200, two calls
                 bitwise equal, its split lists logged), the step's loss
                 and gradients at fixed negatives through the kernels
                 against the plain path, the step's stages and a profile of
                 three steps (busy share).
 10. llama kernels — flash_attention (the tensor-core kernel) against
                 its plain version in bf16 at llama3-8b's prefill shape (B
                 4, S 512, H 32, KV 8, hd 128, causal) and at (B 1, S
                 4096), each element within one bf16 ulp (BF16_ELEM_RTOL),
                 and flash_attention_simt (the CUDA-core kernel) at the
                 prefill shape; both with ragged S 300 and 77, causal and
                 not, groups 1 and 4 and an s_valid: bf16 hd 64 and 128
                 through the tensor-core kernel, fp32 hd 33 to 256 through
                 the CUDA-core one (launch counts checked); sampled_loss at
                 (T 1024, m 512, d 128), (T 256, m 128, d 128), ragged (T
                 1000, m 500) and in bf16, and at llama3-8b's entry run
                 (T 2,176, m 512, d 4,096, bf16, timed; two calls bitwise
                 equal) with the tensor-core route at ragged T, m and d
                 and the CUDA-core route in bf16, split over m and not
                 (``sampled_loss_llama_row``); block_scores at r = 4,096 (N 8,
                 T 16 and 40; N 1), two calls bitwise equal; leaf_scores
                 at wide ragged shapes (3, 4097, 4096) and (5, 300, 4094);
                 with the times of phase 3 (library calls:
                 SDPA with is_causal and enable_gqa; logsumexp over
                 cat([pos, h w^T - logq - log m]); einsum).
 11. llama serving — llama3-8b at full width and depth (32 layers, d 4096,
                 vocab 128,256, bf16, seeded random weights): the retrieval
                 index over its head (zstats; build seconds with the eigh
                 share), prefill of 4 x 512 prompts (flash_attention once
                 per layer), 32 greedy decode steps, a top-k step through
                 the index at full beam (ids equal to the dense top-k, ties
                 aside; top-1 equal to the greedy token) and one at beam 8;
                 then, outside the counted run, prefill and each decode
                 step's h against a full forward (tolerances DECODE_RTOL
                 and DECODE_REL_RMS), zstats against its plain version on
                 the index's (32, 4096, 4096) leaf table and leaf_scores'
                 dot mode on the full-beam gather (128, 4096, 4096), both
                 timed (leaf_scores beside rows.sum(), a plain streaming
                 read of the rows), prefill / decode / top-k times,
                 tokens/s, peak memory and the device busy share of 32
                 decode steps.
 12. sampled_loss entry — ops.sampled_loss once, at llama width, on the
                 forward's hidden states with 512 shared uniform negatives,
                 held against its plain version.
 13. facade    — repro_torch.api.SoftmaxHead at youtube-dnn's full width
                 (100,000 x 128 head, batch 256, m = 128) with
                 block-quadratic, tree-quadratic, rff and midx: init and
                 refresh equal make_refresh_fn bitwise, sample's logq equals
                 all_class_logq within 1e-4, loss and dL/dw equal
                 estimators.local_sampled_loss from the same generator seed
                 bitwise, full and nce run, each call launches exactly its
                 kernels; export_index + decode_topk at full beam equal the
                 dense top-k, ties aside.
 14. sparse    — the Fig. 1b sparse refresh: the unique labels of one batch
                 get new rows; update_rows of block-quadratic,
                 tree-quadratic and rff equals a full rebuild after the same
                 write within rtol = atol = 1e-4 (wq and counts bitwise);
                 host and device ms of both, not gated.
 15. checkpoint — fit 40 steps saving every 10, the same run killed at 25
                 and relaunched: restored_from 20, the restored leaves
                 bitwise what was saved, the resumed losses equal the
                 uninterrupted run's (bitwise when the two runs' step-20
                 states are, else within 1e-3 relative);
                 serving_index_source serves step 40 with
                 export_retrieval_index's full-beam decode, a second poll
                 returns None; checkpoint bytes, save blocking and writer
                 ms; a ptb-lstm state round-trips bitwise.
 16. overlap   — refresh_mode="overlap" for block-quadratic and midx: 40
                 steps at cadence 4, k 2 give the reference's staleness
                 sawtooth and 10 swaps, finite falling losses, the step's
                 launches exact and the island's counted apart; the stats
                 swapped in at step 2 equal make_refresh_fn of the same
                 snapshots on the main stream bitwise; whether two runs are
                 bitwise equal; host and wall ms a step and the busy share
                 at cadence 1, k 1 against sync, beside the refresh alone.
 17. samplers  — (a) youtube-dnn at full width through fit, 60 steps on
                 phase 6's pool for each of block-quadratic-shared, tapas
                 (a pool of 1,024 over the shared base), quadratic-oracle,
                 softmax, abs-softmax, quartic-oracle, rff-oracle and
                 midx-oracle: falling loss, exact launches (shared: zstats
                 61 and nothing else, its (m,) negatives take the loss's
                 einsum path; tapas: zstats 61 and the fused head 60 each
                 way; each oracle the fused head only), and on 4 held-out
                 queries every draw's logq equal to the family's exact
                 all-class log q within 1e-4, no id at or past n_valid;
                 the shared family's logq and tapas' pool logq also equal
                 to a plain fp64 sum over h @ W.T of the head (tapas: at
                 tau = 1 the corrected logit o[ids] - logq constant along
                 each row, and its logq equal to a plain recomputation over
                 the pool's distinct classes); then host ms and busy share
                 of the shared step beside block-quadratic's on one state;
                 (b) the shared sampler's mega branch at m = 2,048 (>= 4 x
                 391 blocks): logq against all_class_logq(shared) and the
                 plain sum within 1e-4, ids < n_valid, and on the drawn
                 blocks its
                 within-block log-probabilities equal to the per-draw
                 branch's within 1e-5; (c) ptb-lstm at full width, 60
                 steps each of the shared family and of tapas (its pool
                 takes the mega branch over 79 blocks), the gates of (a);
                 (d) bench.bias_vs_samples.grad_bias at the reference's
                 arguments: at each m softmax < quadratic-oracle < uniform
                 and tapas < block-quadratic-shared, each row logged beside
                 BENCH_grad_bias.json's.
 18. dense     — (a) flash_attention_bwd against its plain version
                 (autograd through ref.flash_attention_ref): at
                 starcoder2-3b's training shape (B 4, S 1,024, H 24 over KV
                 2, hd 128, causal, bf16; timed beside SDPA's backward
                 alone and its forward + backward, split by its two
                 kernels; its plan splits the group), ragged S 1,000,
                 llama3-8b's (1, 2,048, 32 / 8, 128; timed), s_valid < S
                 causal and not, a group of one whose plan splits nothing,
                 every tensor-core width (hd 16-128 by 16; each case's plan
                 logged), and fp32 through the CUDA-core route (its
                 path-shape row timed): dq, dk, dv
                 within BWD_BF16_RTOL (bf16) or BWD_FP32_RTOL (fp32) x
                 max|plain|, the forward's lse within RTOL, two calls
                 bitwise equal, the route the launch counts show; then
                 ops.flash_attention on inputs that require grad returns a
                 graph whose gradients match.  (b) starcoder2-3b at full
                 width (DENSE_LAYERS = 8 of its 30 layers, d 3,072, vocab
                 49,152, bf16, seeded random
                 weights): the first fit step's gradients at its own fixed
                 shared negatives through the kernels against the plain
                 attention's, within DENSE_GRAD_FLOOR_FACTOR x the
                 difference between two plain versions; 30 steps of fit
                 with its default sampler (block-quadratic-shared, m 2,048,
                 rank 64, blocks of 512) on a cycled pool of 4 batches of 4
                 x 1,024, checkpointing the last (DENSE_CKPT_EVERY: the
                 disk cap): exact launches (flash_attention_bwd a layer a
                 step, flash_attention two: the config's remat runs each
                 layer's forward again in the backward; zstats 31), a
                 falling loss, peak memory under
                 the card's; a profile of two steps; (c)
                 serving_index_source(quantized=True) polled by an
                 IndexRefresher into a ServingEngine: the payload gauge
                 equals payload_bytes of the int8 index, which is at most
                 INT8_PAYLOAD_RATIO (0.26) x a bits-32 index; on 16 queries of the trained model
                 the bits-32 index at full beam equals the dense top-10,
                 ties aside, a beam-8 decode's logits equal their
                 dequantized dots within 1e-4 relative, served ids equal a
                 direct decode, recall@10 at beams 8, 16, 32 logged; (d)
                 prefill of 4 x 512 and 16 top-10 steps through the int8
                 index at beam 16 (agreement with the dense argmax logged),
                 and 16 through the bits-32 index at full beam equal to the
                 dense head's top-10, ties aside.  The phase must leave at
                 most LEFTOVER_GB more allocated than it found.
 19. MoE, SSM and hybrid serving — phase 11's run (4 x 512 prompts, 32
                 greedy steps, top-k through the index at full beam and
                 beam 8, timings, busy share, peak memory) for (a)
                 falcon-mamba-7b at full width and depth (64 mamba layers,
                 d 4,096, d_inner 8,192, state 16, vocab 65,024; 7.27 B
                 bf16 parameters), then (b) jamba-v0.1-52b at full width
                 and 16 of its 32 layers (attention at 4 and 12 over 8 KV
                 heads of 128, no RoPE; 16 experts top-2 at every odd
                 layer, capacity factor 1.25; mamba elsewhere; 26.05 B
                 parameters, 52 GB: the whole model fits no 80 GB card),
                 the first freed before the second is built.  Outside the
                 counted runs: falcon-mamba's decode against its forward
                 in bf16 (DECODE_RTOL, decode_rel_rms: DECODE_REL_RMS
                 scaled to 64 layers) and in fp32 compute from the same
                 weights (FP32_DECODE_*), the padded-state check in fp32
                 (a 300-token prefill's SSM states against a token-by-token
                 decode chain's, and the next h against the forward), its
                 index's zstats (16, 4,096, 4,096) and leaf_scores' full
                 beam (64, 4,096, 4,096) against their plain versions,
                 timed; jamba's prefill against its forward at capacity
                 1.25 (the same T), decode against the forward at capacity
                 factor 16 with the forward's routing imposed (``Routes``;
                 the flips it prevents logged), and its first MoE layer on
                 the prefill's and a decode step's inputs (T 2,048,
                 capacity 320; T 4, capacity 2) against a per-expert fp32
                 evaluation of the same kept assignments (MOE_RTOL), the
                 drops logged.  jamba's attention shape is phase 10's.
 20. MoE, SSM and hybrid training — (a) falcon-mamba-7b at full width and
                 FALCON_TRAIN_LAYERS = 16 of its 64 layers, then (b)
                 jamba-v0.1-52b at full width and 8 of its
                 32 layers (its first attention period: every layer kind;
                 13.30 B parameters), each through fit with its default
                 sampler (block-quadratic-shared), clip + Adafactor and the
                 config's remat (each layer's forward again in the
                 backward; the scan's chunks always) for HYBRID_STEPS
                 steps on a cycled pool of 4 batches of 512-token
                 sequences (falcon 4 in one microbatch, jamba 8 in its
                 own 8): exact launches (zstats once per refresh; jamba's
                 flash_attention twice and flash_attention_bwd once per
                 microbatch), a falling loss, peak memory under the
                 card's, Adafactor's state bytes, the MoE aux; a profile
                 of one step.  Before each fit, at a cut depth (falcon 2
                 layers, jamba 5: its attention last), the first step's
                 gradients with remat and without: bitwise equal, or
                 within REMAT_RTOL with the parameters that differ logged;
                 and jamba's attention gradients through the kernels
                 against the plain attention's (phase 18's check).
 21. deepseek-v3-671b's MLA and mtp — (a) in the kernel checks (its own
                 generator): flash_attention and flash_attention_bwd at
                 MLA's widths (q/k 192, v 128, 128 heads with no KV
                 sharing) on the tensor cores at the paths' shapes (4 x
                 512, 1 x 512, and the mtp block's 1 x 511), against their
                 plain versions, timed beside SDPA (its backend named);
                 then a group of 4, non-causal s_valid, narrower pairs
                 zero-padded to (192, 128), and the CUDA-core route at hv
                 != hd; (b) serving at full width and 4 of its 61 layers (the
                 3 dense layers and the first MoE one: 15.80 B parameters,
                 31.6 GB) through phase 11's run: prefill through
                 flash_attention at (192, 128), the absorbed decode over
                 the latent cache (its bytes a token checked), prefill and
                 decode against the forward (bf16 at capacity factor 16
                 with the forward's routing imposed; fp32 compute over the
                 dense layers); (c) training at the same 4 layers with the
                 mtp module through fit (block-quadratic-shared, clip +
                 Adafactor, its 2 microbatches of one 512-token sequence,
                 remat; HYBRID_STEPS steps on a pool of 4): the remat check
                 at 4 layers (the first gradients in host memory), the
                 attention's gradients over the dense layers and the mtp
                 block against the plain attention's, exact launches
                 (flash_attention twice a backbone layer and once for the
                 mtp block, flash_attention_bwd once each, a microbatch),
                 a falling pool loss, peak memory, a profile of one step.
 22. whisper-large-v3's encoder-decoder — (a) in the kernel checks (its
                 own generator): flash_attention and flash_attention_bwd
                 at whisper's shapes (20 heads of 64, bf16, tensor cores):
                 the encoder's (4, 1,500) and (8, 1,500) not causal, the
                 decoder's (8, 448) causal and the cross attention's (8,
                 Sq 448 over Sk 1,500) not causal, each against its plain
                 version and timed beside SDPA (its backend named) with
                 its bound; then the decode check's (4, 33 / 1,500), a
                 ragged Sk below Sq, an s_valid inside Sk, the CUDA-core
                 route (fp32) at Sk != Sq both ways, and a causal call
                 with Sk != Sq refused; (b) serving whole (32 + 32 layers,
                 d 1,280, 1.61 B parameters) through phase 11's run on 4
                 clips of 1,500 frames: the prefill encodes them (32
                 tensor-core flash launches), fills the cross K/V of every
                 decoder layer and decodes token 0; decoder context 448;
                 then decode against the teacher-forced decoder over the
                 same tokens and encoder output in bf16 (DECODE_RTOL,
                 WHISPER_DECODE_REL_RMS) and in fp32 compute
                 (FP32_DECODE_*), each check's 96 attention launches
                 exact; (c) training whole through fit (block-quadratic-
                 shared, clip + AdamW at WHISPER_LR, remat;
                 HYBRID_STEPS steps on a pool of 4 batches of 8 clips of
                 1,500 frames with 448 tokens): the remat check and the
                 attention's gradients against the plain attention's
                 (the cross attention's parameters gated on their own) on
                 4 clips, exact launches (flash_attention 192 and
                 flash_attention_bwd 96 a step), a falling pool loss,
                 peak memory, a profile of one step.
 23. mesh      — the vocab-parallel head over a (data, model) mesh at
                 youtube-dnn's full width (``phase_mesh``): (a) NCCL on a
                 (1, 1) mesh in this process, one full-softmax fit step
                 with clip + SGD equal to the unsharded one
                 (MESH_STEP_RTOL: the loss, each parameter over its own
                 max) and a block-quadratic step's launches exact; (b)
                 MESH_WORLD rank processes of this script sharing the
                 card over gloo, at (1, 4) and (2, 2): zstats,
                 block_scores and leaf_scores at the rank's shard shapes
                 against their plain versions (RTOL, as phase 3), the
                 sharded full and sampled (given negatives, the fused
                 head) losses and gradients
                 against the unsharded ones on the card, MESH_STEPS fit
                 steps (exact launches per rank, falling pool loss, step
                 ms, collectives), the trained head's sharded index
                 decoded at full beam, and the sharded top-k, each equal
                 to the dense top-k (a swap only where the dense logit
                 ties a neighbour: check_topk_ties); any
                 rank's failure fails the phase.  Since phase 24 the
                 ranks hold youtube-dnn's tables by the reference's rules
                 (the head's and the watch embedding's rows over model,
                 their features over data).  The same for
                 tree-quadratic, rff and midx (MESH_SAMPLERS): (a) one
                 fit step each on the NCCL (1, 1) mesh, launches exact,
                 its refreshed statistics bitwise build_stats on the
                 unsharded head; (b) on every rank, each family's kernels
                 at the rank's shard shapes (the tree's zstats,
                 block_scores on its dense levels and leaf_scores; rff's
                 rff_features and leaf_scores' dot mode; midx's
                 midx_pair_masses codes entry and midx_member_scores)
                 against their plain versions, MESH_STEPS fit steps
                 (exact launches, falling pool loss, step ms,
                 collectives) and the eq. 2 contract per shard (logq =
                 the shard's all_class_logq - log tp within 1e-4, no id
                 past its n_valid); at (2, 2) the overlap island
                 (MESH_OVERLAP: midx, cadence 2, k 1) beside the same
                 steps in sync mode: swaps counted, each bitwise the main
                 stream's rebuild of its snapshots, its launches apart,
                 its only collective the snapshot's all-gather over data
                 on a cadence step, each step's collectives the sync
                 step's.
 24. mesh dense — the backbone's storage layouts on the mesh
                 (``phase_mesh_layouts``), starcoder2-3b at full width and
                 MESH_DENSE_LAYERS = 2 of its 30 layers: (a) NCCL on a
                 (1, 1) mesh in this process, one fp32 full-softmax step
                 in each mode equal to the unsharded one (MESH_STEP_RTOL);
                 (b) the unsharded fp32 parity steps (KV heads padded to 4
                 and 2) saved for the ranks; (c) MESH_WORLD rank processes
                 over gloo, tp_fsdp at (1, 4) and (2, 2), pure_fsdp at
                 (2, 2): the fp32 parity step's loss, gradient shards and
                 Adafactor-updated shards against the slices of the
                 unsharded ones (MESH_RTOL of each whole tensor's max),
                 flash_attention and its backward at the rank's shard
                 shapes against their plain versions (phase 10's and 18a's
                 gates; timed on rank 0 at MESH_DENSE_TIMED_RUN's),
                 MESH_DENSE_STEPS bf16 fit steps
                 on a pool of 2 batches of 4 x 1,024 (exact launches per
                 rank, falling pool loss alike on every rank), a timed
                 step whose collectives equal the prediction from the
                 specs key for key; any rank's failure fails the phase.
 25. mesh families — the ssm, encdec and lstm families' layouts on the
                 mesh, in phase 24's rank processes after its runs
                 (``phase_mesh_layouts``): falcon-mamba-7b at full width
                 and 2 of its 64 layers (the mamba block channel-parallel
                 under tp_fsdp), whisper-large-v3 at 2 + 2 of its 32 + 32
                 (vocab padded to 51,868 at tp 4), ptb-lstm whole (its
                 embedding vocab-parallel): (a) NCCL on a (1, 1) mesh in
                 this process, each family's fp32 full-softmax step in its
                 config's mode equal to the unsharded one
                 (MESH_STEP_RTOL); (b) the ranks, falcon and whisper at
                 tp_fsdp (1, 4) and pure_fsdp (2, 2), ptb-lstm at tp_fsdp
                 (1, 4) and (2, 2) (MESH_FAMILY_RUNS): the fp32 parity
                 step on the shards against the rank's own unsharded step
                 (the loss within MESH_STEP_RTOL, each shard within
                 MESH_RTOL of its whole tensor's max), whisper's
                 attention kernels at its shard shapes (5 of 20 heads a
                 rank at tp 4; checked on rank 0, the encoder's timed
                 at tp_fsdp (1, 4)), 2 fit steps
                 (bf16; ptb-lstm fp32) with exact launches a rank, losses
                 alike on every rank, step ms, the rank's peak, and zstats
                 (ptb-lstm: the sampler's three kernels, and the fused
                 head's two in abs mode at given negatives, as phase 23
                 holds them) at the rank's shard shapes against their
                 plain versions.
 26. mesh experts — expert parallelism and the S-sharded residual
                 stream, in the same rank processes after phase 25's runs
                 (``phase_mesh_layouts``), every config at full width in
                 tp_fsdp with its own seq_residuals: (a) NCCL on a (1, 1)
                 mesh in this process, dbrx-132b at 1 layer, one fp32
                 full-softmax step equal to the unsharded one
                 (MESH_STEP_RTOL); (b) the unsharded fp32 references of
                 dbrx-132b at 1 layer (4.49 B parameters) saved for the
                 ranks: the step on the whole batch, and its MoE layer
                 alone on each (2, 2) data shard's rows (each its own
                 capacity, its drops logged); (c) the ranks
                 (MESH_EXPERT_RUNS): dbrx-132b at (1, 4) (2 layers, 4
                 experts a rank) and (2, 2) (1 layer, 8 experts a rank,
                 ZeRO-3 over data), deepseek-v3-671b's 3 dense MLA layers
                 and mtp block and jamba-v0.1-52b's first 5 layers at
                 (1, 4): dbrx's fp32 parity on the shards (drawn
                 straight into them) against the saved one (at (1, 4)
                 the step's loss and every gradient shard, at (2, 2) the
                 MoE layer's y, dL/dx and gradient shards, within
                 MESH_RTOL of each whole tensor's max); zstats at the head shard's blocks and
                 both attention kernels at the shard's shapes (12 / 2
                 heads, MLA's 32 at (192, 128), jamba's 8 / 2) against
                 their plain versions on rank 0 (timed for dbrx (1, 4),
                 deepseek and jamba); at (1, 4) MESH_EXPERT_STEPS = 2
                 bf16 fit steps with remat and Adafactor on a pool of one
                 batch (the (2, 2) run's fit is cut for the script's
                 time: its expert gathers over data move 16 GB a rank a
                 step through gloo) (exact
                 launches a rank, the loss falling, alike on every rank;
                 the first MoE dispatch's drops on the rank's experts
                 equal to the unsharded layer's on the same rows, a data
                 row's model ranks summing to its rows' total; the last
                 step's collectives by op and group; step ms; the rank's
                 peak) and zstats at the trained head shard.
 27. mesh serving — the decoder LMs' serving engine under the
                 reference's ctx_for_serve (tp: parameters replicated over
                 data; KV caches with the sequence over model, mamba
                 states with their channels over model), in the same rank
                 processes after phase 26's runs: (a) NCCL on a (1, 1)
                 mesh in this process, llama3-8b at 2 layers in bf16:
                 prefill, 4 decode steps and a top-10 step bitwise the
                 unsharded engine's; phase 11 saved its llama3-8b run
                 (32 and the first 8 layers, 16 steps, the unsharded int8
                 index's recall@10), and here the unsharded fp32 runs of
                 llama3-8b and falcon-mamba-7b at 2 layers and falcon's
                 bf16 run at 8 are saved for the ranks; (b) on the ranks
                 (MESH_SERVE_RUNS), every model drawn straight into the
                 rank's shards from the reference's seed: llama3-8b and
                 falcon-mamba-7b at full width and 2 layers in fp32 at
                 (1, 4) and (2, 2), prefill h, every cache gathered whole,
                 3 decode steps' h within MESH_RTOL of each tensor's max,
                 tokens and the top-10 equal but at ties; (c) llama3-8b in
                 bf16, 32 layers at (1, 4) and 8 at (2, 2), a 4 x 512
                 prompt and 16 decode steps fed the unsharded tokens: h
                 within phase 11's DECODE_RTOL and decode_rel_rms, tokens
                 and the top-10 equal but where the unsharded gap is
                 within twice the row's bf16 logit error, the sharded
                 RetrievalIndex at full beam = the dense top-10 but at
                 ties, the sharded int8 quantized index's recall@10 at
                 exhaustive beam within MESH_SERVE_RECALL_TOL of the
                 unsharded one's; (d) falcon-mamba-7b at 8 layers in bf16
                 at (1, 4) likewise.  Each run's main path (index build,
                 prefill, decode, top-k steps) launches exactly zstats
                 once, flash_attention (27b: flash_attention_simt) once a
                 layer and leaf_scores once a rank, and one decode step's
                 collectives equal ``predict_serve_collectives``;
                 on the world's rank 0, held against their plain versions
                 and timed at each llama3-8b run's shard shapes:
                 flash_attention_simt (27b, fp32) and flash_attention
                 (27c, bf16) at each mesh's prefill shard, and at each
                 27c mesh zstats at a shard's index blocks and
                 leaf_scores at its full beam.
 28. mesh family serving — the rest of serving under ``ctx_for_serve``
                 (jamba-v0.1-52b in tp, its experts whole on their model
                 rank; dbrx-132b and deepseek-v3-671b in tp_fsdp, their F
                 leaves gathered over data per layer, MLA's latent cache
                 with the sequence over model; whisper-large-v3's self and
                 cross caches likewise), in the same rank processes after
                 phase 27's runs: (a) NCCL on a (1, 1) mesh in this
                 process, jamba at 5 layers, deepseek at 1 and whisper at
                 2 + 2 in bf16: prefill, 4 decode steps and a top-10 step
                 bitwise the unsharded engine's; the unsharded references
                 saved for the ranks; (b) on the ranks
                 (MESH_FAMILY_SERVE_RUNS) fp32 parity at full width and
                 small depth, jamba (2 layers) and deepseek (1) and
                 whisper (2 + 2, 1,500 frames) at (1, 4) and (2, 2), dbrx
                 (1) at (1, 4), as 27b's; (c) bf16 at (1, 4): jamba's
                 first 5 layers, dbrx at 2, deepseek's 3 dense MLA layers,
                 whisper at 2 + 2, 4 prompts of 512 (clips of 1,500
                 frames) and 8 decode steps fed the unsharded tokens, the
                 MoE configs with the unsharded routing imposed
                 (``FamilyRoutes``), gated as 27c; exact launches a rank
                 (zstats once in (c), flash_attention (fp32:
                 flash_attention_simt) once an attention layer of the
                 prefill, whisper's encoder layers, leaf_scores once in
                 (c)), one decode step's collectives equal
                 ``predict_serve_collectives``; on the world's rank 0 each
                 run's attention entry at its shard shape, and (c)'s
                 zstats and leaf_scores at its index, held against their
                 plain versions and timed.
Phases 4-5, 6, each family of 9, 9b, 11, 12, 13, 15, each family of 16,
each run of 17, 18's fit, both runs of 19, both fits of 20, 21's and
22's serving runs and fits, 23's, 24's, 25's and 26's steps and fits and
27's and 28's serving runs on each rank are main paths: the kernel
launch counters are zeroed just before each and read just after; serving
must launch zstats, block_scores and leaf_scores, block-quadratic training
(youtube-dnn and ptb-lstm) and each family its own kernels exactly
(``expected_launches``), llama serving zstats once, flash_attention (the
tensor-core kernel) once per layer, flash_attention_simt never,
starcoder2-3b training flash_attention twice (remat) and
flash_attention_bwd once per layer and step and zstats once per refresh,
falcon-mamba-7b and jamba-v0.1-52b training zstats once per refresh and
jamba flash_attention twice and flash_attention_bwd once per attention
layer and microbatch, falcon-mamba-7b and
jamba-v0.1-52b serving zstats once and jamba flash_attention once per
attention layer (2, tensor-core), deepseek-v3-671b serving zstats once
and flash_attention once per layer (4, tensor-core at (192, 128)) and
its training as phase 20's with the mtp block's attention beside,
whisper-large-v3 serving zstats once and flash_attention once per
encoder layer (32) and its training zstats once per refresh,
flash_attention twice and flash_attention_bwd once per attention call
(96 a forward), and
leaf_scores once per index top-k step, the entry run sampled_loss
once, and the facade, checkpoint and overlap runs exactly what their
calls and steps need.
The line before the last is {"kernels": [...]} (training-shape numbers;
both flash kernels at the prefill shape, sampled_loss at kernel_bench's;
``launches`` summed over every path but youtube-dnn serving (whose count
follows the engine's batching), each path's count under
``launches_by_path`` (phase 19's as "falcon-mamba-7b" and
"jamba-v0.1-52b", phase 20's as "falcon-mamba-7b training" and
"jamba-v0.1-52b training", phase 21's as "deepseek-v3-671b" and
"deepseek-v3-671b training", phase 22's as "whisper-large-v3" and
"whisper-large-v3 training", phase 23's as "mesh nccl (1, 1)", "mesh gloo
(1, 4)" and "mesh gloo (2, 2)" (block-quadratic), each of those followed
by " <family>" for MESH_SAMPLERS, and "mesh gloo (2, 2) overlap midx",
phase 24's as "mesh dense tp_fsdp (1, 4)",
"mesh dense tp_fsdp (2, 2)" and "mesh dense pure_fsdp (2, 2)", phase 25's
as "mesh <config> <mode> (dp, tp)", phase 26's as "mesh experts <config>
(dp, tp)", phase 27's and 28's as "mesh serving <config> (dp, tp)
<dtype>", each gloo mesh summed over its ranks); the other shapes'
numbers under serving_*,
tree_levels_*, rff_leaf_dots_*, long_*, r4096_*, youtube_*,
llama_entry_*, llama_index_*, falcon_index_* (phase 19's index),
mla_serving_*, mla_train_*, mla_train_mtp_* (phase 21a),
whisper_enc_serving_*, whisper_enc_train_*, whisper_dec_train_*,
whisper_cross_train_* (phase 22a),
mesh_tp_fsdp_1x4_*, mesh_tp_fsdp_2x2_*, mesh_pure_fsdp_2x2_* (both
attention kernels at phase 24's shard shapes, the first timed on rank 0),
mesh_whisper_<mode>_<dp>x<tp>_<enc|dec|cross>_* (both at phase 25's
whisper shard shapes), mesh_experts_<config>_<dp>x<tp>_* (zstats and
both attention kernels at phase 26's shard shapes),
mesh_serving_<dp>x<tp>_* (flash_attention at phase 27c's prefill shard
shapes, zstats and leaf_scores at a shard's index),
mesh_serving_fp32_<dp>x<tp>_* (flash_attention_simt at 27b's),
mesh_family_serving_<config>_<dp>x<tp>_* (flash_attention at phase
28c's prefill shard shapes, zstats and leaf_scores at a shard's index),
mesh_family_serving_fp32_<config>_<dp>x<tp>_* (flash_attention_simt at
28b's),
ptb_* (the five kernels at ptb-lstm's
step), midx_ct_entry_*, midx_bf16_*, midx_expanded_* (midx_pair_masses'
ct entry, bf16, and the call with the expansion outside the kernel), and
the fused head's bf16_*, skew3_* (90% of the slots on 3 rows) and
skewed_* (the trained state's step)) and
the last is
{"ok": true, "device": {...}}.  ``[time]`` lines give the script's clock
at the end of each group of phases, so that each group's cost reads off
the differences.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path
from typing import NamedTuple

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.utils.checkpoint  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.autograd.profiler_util import Interval  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import convert, kernels  # noqa: E402
from repro_torch.api import SoftmaxHead  # noqa: E402
from repro_torch.checkpoint import manager as ckpt_manager  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    blocks,
    estimators,
    hierarchy,
    midx,
    tree,
)
from repro_torch.core.kernel_fns import (  # noqa: E402
    quadratic_kernel,
    rff_directions,
    rff_logshift_bound,
)
from repro_torch.core.sampled_softmax import (  # noqa: E402
    full_softmax_loss,
    fused_plan,
)
from repro_torch.bench import bias_vs_samples  # noqa: E402
from repro_torch.core.samplers import (  # noqa: E402
    SamplerState,
    sampler_from_config,
)
from repro_torch.data.pipeline import (  # noqa: E402
    ShardedBatchIterator,
    batch_iterator_for,
)
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, fused_head, ops, ref  # noqa: E402
from repro_torch.kernels.block_scores import block_scores  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_simt,
)
from repro_torch.kernels.leaf_scores import leaf_scores  # noqa: E402
from repro_torch.kernels.midx_scores import (  # noqa: E402
    midx_list_masses,
    midx_member_scores,
    midx_pair_masses,
)
from repro_torch.kernels.rff_features import rff_features  # noqa: E402
from repro_torch.kernels.sampled_loss import sampled_loss  # noqa: E402
from repro_torch.kernels.zstats import zstats  # noqa: E402
from repro_torch.models import (  # noqa: E402
    api,
    encdec,
    layers,
    lstm_lm,
    moe,
    transformer,
)
from repro_torch.core import distributed  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.adafactor import adafactor  # noqa: E402
from repro_torch.optim.clip import (  # noqa: E402
    ShardedGrads,
    clip_by_global_norm,
)
from repro_torch.optim.transform import (  # noqa: E402
    GradientTransform,
    apply_updates,
    chain,
)
from repro_torch.serve import engine, quantized_index, retrieval  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.serve.server import (  # noqa: E402
    IndexRefresher,
    ServingEngine,
    payload_bytes,
)
from repro_torch.train import loop, step  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the fp32
# rate outside the tensor cores (the kernels that run fp32 FMAs) and the
# dense bf16 tensor-core rate (the bound of work whose inputs are bf16).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: the dense TF32 tensor-core rate, and the rate of fp32-accurate products
#: made of three TF32 ones (3xTF32: a_hi b_hi + a_hi b_lo + a_lo b_hi)
TF32_FLOPS_PER_S = 495e12
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
#: max |kernel - plain| allowed, as a fraction of max |plain|: both sum
#: 128-term fp32 products (r^2 = 16384 terms for block_scores) in
#: different orders.
RTOL = 1e-5
REPS = 25
#: back-to-back calls per CUDA-event pair in ``event_ms``
EVENT_CALLS = 10
#: host pause (s) that sets the timed calls of a ``device_ms`` trace apart
GAP_S = 0.005

REPLACES = {
    "zstats": "src/repro/kernels/zstats.py:31",
    "block_scores": "src/repro/kernels/block_scores.py:52",
    "leaf_scores": "src/repro/kernels/leaf_scores.py:56",
    "fused_lse": "src/repro/kernels/fused_head.py:107",
    "fused_lse_bwd": "src/repro/kernels/fused_head.py:178",
    "rff_features": "src/repro/kernels/rff_features.py:69",
    "midx_pair_masses": "src/repro/kernels/midx_scores.py:63",
    "midx_member_scores": "src/repro/kernels/midx_scores.py:94",
    "sampled_loss": "src/repro/kernels/sampled_loss.py:73",
    "flash_attention": "src/repro/kernels/flash_attention.py:92",
    "flash_attention_simt": "src/repro/kernels/flash_attention.py:92",
    # the Pallas kernel has no backward: the reference differentiates its
    # pure-jnp layers.chunked_attention (src/repro/models/layers.py:169)
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:92",
    "flash_attention_bwd_simt": "src/repro/kernels/flash_attention.py:92",
}
#: kernels the serving path must launch (its counts follow the engine's
#: batching; the training paths' are exact, ``expected_launches``)
SERVING_KERNELS = ("zstats", "block_scores", "leaf_scores")
#: the hierarchical sampler families of phase 9
FAMILIES = ("tree-quadratic", "rff", "midx")
TRAIN_STEPS = 60
TRAIN_BATCH = 256
#: batches in the training phase's fixed pool, cycled for TRAIN_STEPS: at
#: 100,000 items most labels of 60 fresh batches are items no earlier
#: batch trained, and the sampled loss stays at ln(n) there (``--fresh``
#: sets it beside the exact full softmax), so the gate's falling loss is
#: shown on seen data
TRAIN_POOL = 8
#: the device of the training phases
DEV = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


class DeviceEvent(NamedTuple):
    """A device activity of a trace: its name and its interval in us, as
    a ``FunctionEvent`` has them."""

    name: str
    time_range: Interval


def device_events(prof) -> list[DeviceEvent]:
    """The device-side activities of a torch.profiler trace: kernels,
    memsets and copies (the aten ops that launch them are host events),
    read off the profiler's raw kineto events, times from the first one's
    start.  ``prof.events()`` first builds a Python ``FunctionEvent`` of
    every event the trace holds: on the H100 that took 96 of the kernel
    checks' 181 s, more than the traced calls and the profiler's start and
    stop together."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not getattr(e, "is_hidden_event", lambda: False)()]
    t0 = min((e.start_ns() for e in evs), default=0)
    return [DeviceEvent(e.name(), Interval((e.start_ns() - t0) / 1e3,
                                           (e.end_ns() - t0) / 1e3))
            for e in evs]


def busy_us(events) -> float:
    """Length of the union of the events' device intervals, in us."""
    total, end = 0.0, -math.inf
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


#: where the timing helpers spend the script's wall time, by helper:
#: calls, profiler traces taken, seconds in all, seconds inside the traces
#: (the profiler's start and stop included), seconds of the timed calls
#: themselves (warm-up, reps and brackets), seconds reading the traces'
#: events (``timing_report``)
TIMING: dict[str, dict[str, float]] = {}


def timing_add(name: str, **amounts: float) -> None:
    row = TIMING.setdefault(name, dict.fromkeys(
        ("calls", "traces", "s", "trace_s", "calls_s", "events_s"), 0.0))
    for k, v in amounts.items():
        row[k] += v


def timing_report(stage: str) -> None:
    """Log TIMING for the stage just ended, then start it afresh."""
    rows = {k: {n: round(v, 3) for n, v in row.items()}
            for k, row in TIMING.items()}
    log(f"[time] {stage}: timing helpers {rows}")
    TIMING.clear()


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: the card's busy time over ``reps`` calls
    (torch.profiler, device activities only), divided by ``reps``.

    A trace can drop an activity at its start or end (after the training
    profiles, most traces of a one-kernel call recorded 24 activities for
    25 calls), so the REPS calls are bracketed by an untimed call on each
    side, each set apart by a sync and a host pause of GAP_S; the pauses
    split the trace into stretches, and only the longest stretch, the
    ``reps`` calls, is timed.  Every timed function launches the same
    activities on each call, so a stretch whose activity count is not a
    multiple of ``reps`` lost some: the trace is taken again, up to three
    times.  If all three lose some (calls of 60 ms or more lost three of
    five activities in most traces on the H100, and one trace of 80 ms
    calls held none), the time per call is
    taken by CUDA events around single calls instead, and the log says
    so."""
    t_start = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def pause():
        torch.cuda.synchronize()
        time.sleep(GAP_S)

    for attempt in range(3):
        t_trace = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_calls = time.perf_counter()
            fn()
            pause()
            for _ in range(reps):
                fn()
            pause()
            fn()
            torch.cuda.synchronize()
            t_calls = time.perf_counter() - t_calls
        t_events = time.perf_counter()
        events = sorted(device_events(prof),
                        key=lambda e: e.time_range.start)
        t_events = time.perf_counter() - t_events
        timing_add("device_ms", traces=1,
                   trace_s=time.perf_counter() - t_trace - t_events,
                   calls_s=t_calls, events_s=t_events)
        stretches, end = [], -math.inf
        for e in events:
            if not stretches or e.time_range.start - end >= 0.8 * GAP_S * 1e6:
                stretches.append([])
            stretches[-1].append(e)
            end = max(end, e.time_range.end)
        # a trace can also come back with no device activity at all
        middle = max(stretches, key=len) if stretches else []
        if middle and len(middle) % reps == 0:
            break
        log(f"  trace {attempt + 1} recorded {len(events)} device "
            f"activities in stretches of {[len(x) for x in stretches]} "
            f"for {reps} calls")
    else:
        ms = event_ms(fn, reps, 1)
        log(f"  no whole trace in 3: {ms} ms per call by CUDA events")
        timing_add("device_ms", calls=1, s=time.perf_counter() - t_start)
        return ms
    timing_add("device_ms", calls=1, s=time.perf_counter() - t_start)
    return busy_us(middle) / reps / 1e3


def event_ms(fn, reps: int = REPS, calls: int = EVENT_CALLS) -> float:
    """Time per call as a caller sees it, host work included: CUDA events
    around ``calls`` back-to-back calls, median of ``reps``, per call."""
    t_start = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    timing_add("event_ms", calls=1, s=time.perf_counter() - t_start)
    return statistics.median(times)


def device_split(fn, reps: int = REPS) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches, by name
    (torch.profiler's device activities over ``reps`` calls, summed per
    name and divided by ``reps``): where an entry point's time goes."""
    t_start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    timing_add("device_split", calls=1, traces=1,
               s=time.perf_counter() - t_start)
    split: dict[str, float] = {}
    for e in device_events(prof):
        found = re.search(r"(\w+_kernel)\b", e.name)
        name = found[1] if found else e.name[:40]
        split[name] = split.get(name, 0.0) + (e.time_range.end
                                              - e.time_range.start)
    return {k: v / reps / 1e3 for k, v in split.items()}


def times(kernel, plain, library=None, reps: int = REPS,
          calls: int = EVENT_CALLS) -> dict[str, float | None]:
    """A kernel row's times: device ms per call of the kernel, its plain
    version and the library call, and the kernel's per-call event time
    (``reps`` and ``calls`` cut for calls that take 100 ms or more)."""
    return dict(ms=device_ms(kernel, reps),
                event_ms=event_ms(kernel, reps, calls),
                plain_ms=device_ms(plain, reps),
                library_ms=None if library is None
                else device_ms(library, reps))


def bound_ms(n_bytes: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rtol: float = RTOL, elem_rtol: float = 0.0) -> float:
    """max |got - want|, each element held to ``elem_rtol`` x |want| plus
    ``rtol`` x max |want| (in fp32)."""
    sync()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    scale = float(want.abs().max())
    rel = float((diff / (want.abs() + 1e-30)).max())
    excess = float((diff - elem_rtol * want.abs()).max())
    rule = (f"{elem_rtol} x |plain| + " if elem_rtol else "") + \
        f"{rtol} x max|plain|"
    log(f"  {name}: max_abs_err={err} max_rel_err={rel} max excess over "
        f"{elem_rtol} x |plain|={excess} (tolerance {rule}: "
        f"{rtol * scale})")
    if excess > rtol * scale:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {excess} > {rtol * scale} "
                             f"({rule})")
    return err


def rel_dist(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in want's precision."""
    want = want.detach()
    return float((got.to(want.dtype) - want).abs().max() / want.abs().max())


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return line


#: kernels whose every instantiation must compile without spills (ptxas)
NO_SPILL_KERNELS = ("flash_mma_kernel", "zstats_kernel",
                    "block_scores_tile_kernel", "sampled_loss_mma_kernel",
                    "rff_features_kernel", "fused_lse_kernel",
                    "fused_bwd_front_kernel", "fused_bwd_scan_kernel",
                    "fused_bwd_dw_kernel", "dq_wgmma_kernel",
                    "dkv_wgmma_kernel")
#: instantiations of the fused head's kernels: fused_lse_kernel and
#: fused_bwd_dw_kernel per (fp32 | bf16, vector loads or not), the front
#: kernel also per (d <= 128 or wider), one scan kernel
FUSED_HEAD_INSTANCES = 4 + 4 + 8 + 1
#: (source's kernel, function, instantiations) that must hold tensor-core
#: (HMMA) instructions in their SASS
HMMA_KERNELS = (("flash_attention", "flash_mma_kernel", 4),
                ("sampled_loss", "sampled_loss_mma_kernel",
                 len(kernels.sampled_loss.TILINGS["mma"])),
                ("rff_features", "rff_features_kernel", 1))
#: (source's kernel, function, instantiations) that must hold wgmma
#: (HGMMA) instructions in their SASS: the attention backward's, at (hd,
#: hv) compiled as (64, 64), (128, 128) and (192, 128)
HGMMA_KERNELS = (("flash_attention_bwd", "dq_wgmma_kernel", 3),
                 ("flash_attention_bwd", "dkv_wgmma_kernel", 3))


def phase_build() -> None:
    """Build every source; log each kernel instantiation's ptxas register
    and spill lines, and fail if one of NO_SPILL_KERNELS spills."""
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(_build.SIGNATURES)} kernels from {len(logs)} "
        f"sources in {time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR}")
    spills = {}
    for name, text in logs.items():
        kernel = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                # the mangled kernel name, from its own name on (template
                # arguments included), past the anonymous namespace's hash
                mangled = line.split("for", 1)[1].strip()
                kernel = mangled.split("_cu_", 1)[-1][:72]
                log(f"  {name}: {kernel}")
            if ("registers" in line or "spill" in line
                    or "wgmma" in line or "setmaxnreg" in line):
                log(f"  {name}: {line.strip()}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if found and any(k in kernel for k in NO_SPILL_KERNELS):
                spills[kernel] = int(found[1]) + int(found[2])
    if logs and not all(logs.values()):
        log("[build] some libraries came from the cache: no spill check")
    elif len(spills) < 6 + len(kernels.block_scores.TILINGS) + sum(
            n for _, f, n in HMMA_KERNELS + HGMMA_KERNELS
            if f != "flash_mma_kernel") + FUSED_HEAD_INSTANCES:
        # flash_mma_kernel at (32, 32), (64, 64), (128, 128) and (192,
        # 128), zstats<64, 128>, one block_scores tile kernel per tiling,
        # one sampled_loss_mma_kernel per tensor-core tiling,
        # rff_features_kernel, the attention backward's dq and
        # dkv_wgmma_kernel at their three width pairs, the fused head's
        raise AssertionError(f"ptxas printed spill lines for {sorted(spills)}"
                             f" only, not every instantiation of "
                             f"{NO_SPILL_KERNELS}")
    bad = {k: n for k, n in spills.items() if n}
    log(f"[build] spill bytes (stores + loads) of {NO_SPILL_KERNELS}: "
        f"{spills}")
    if bad:
        raise AssertionError(f"kernels that must not spill do: {bad}")
    for opcode, table in (("HMMA", HMMA_KERNELS), ("HGMMA", HGMMA_KERNELS)):
        for kernel, function, n in table:
            found = sass_count(kernel, function, opcode)
            log(f"[build] {opcode} instructions in the SASS of each "
                f"{function} instantiation: {found}")
            if found is not None and (len(found) != n
                                      or not all(found.values())):
                raise AssertionError(f"a tensor-core {function} has no "
                                     f"{opcode}")


def sass_count(kernel: str, function: str, opcode: str
               ) -> dict[str, int] | None:
    """How many instructions of ``opcode`` the SASS of each function whose
    name holds ``function`` has, in kernel ``kernel``'s library
    (``cuobjdump -sass``); None without cuobjdump."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")  # beside nvcc
    if not tool.exists():
        log(f"[build] no {tool}: SASS not read")
        return None
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.library_path(kernel))], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            name = name if function in name else None
            if name:
                counts[name] = 0
        elif name and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
    return counts


def phase_kernels(gen: torch.Generator) -> dict[str, dict]:
    """The three serving kernels at the serving path's shapes."""
    dev = DEV
    out = {}

    # zstats at the index build's shape: 1024 leaves of 128 rows, r = 128.
    nb, b, r = 1024, 128, 128
    w = torch.randn((nb, b, r), generator=gen, device=dev)
    z = zstats(w)
    err = compare("zstats (1024, 128, 128)", z, ref.zstats_ref(w))
    # ragged edges: rows and width off the tiles (r = 200 is ptb-lstm's
    # width); r = 130 (r % 4 != 0) takes the 4-byte copies, r = 1100 the
    # 128-wide tiles, 70,000 class blocks two launches (65,535 at most each)
    for shape in ((7, 50, 200), (3, 37, 130), (2, 70, 1100), (70000, 8, 8)):
        w2 = torch.randn(shape, generator=gen, device=dev)
        err = max(err, compare(f"zstats {shape}", zstats(w2),
                               ref.zstats_ref(w2)))
    wt = w.transpose(1, 2)
    # Z_b is symmetric, so the function needs only its r(r+1)/2 distinct
    # entries: 2 * nb * B * r(r+1)/2 flops (a SYRK, not a full GEMM).
    bms, by = bound_ms(4 * (nb * b * r + nb * r * r), nb * b * r * (r + 1))
    out["zstats"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: zstats(w), lambda: ref.zstats_ref(w),
                lambda: torch.bmm(wt, w)))

    # block_scores against every dense level's Z (levels 1-9 of the 1024-leaf
    # tree: 2..512 nodes), alpha = 1 and cnt = 0 as the gram bound calls it.
    levels = [z]
    while levels[0].shape[0] > 2:
        levels.insert(0, levels[0][0::2] + levels[0][1::2])
    levels = levels[:-1]  # drop the leaf level: levels 1..9
    err = 0.0
    for t in (1, 16):
        h = torch.randn((t, r), generator=gen, device=dev)
        for zl in levels:
            cnt = torch.zeros(zl.shape[0], device=dev)
            err = max(err, compare(
                f"block_scores T={t} N={zl.shape[0]}",
                block_scores(h, zl, cnt, alpha=1.0),
                ref.block_scores_ref(h, zl, cnt, 1.0)))
    # ragged: two query tiles (T = 19), r = 200, counts and alpha = 100
    h2 = torch.randn((19, 200), generator=gen, device=dev)
    z2 = ref.zstats_ref(torch.randn((5, 40, 200), generator=gen, device=dev))
    c2 = torch.arange(1, 6, dtype=torch.float32, device=dev)
    err = max(err, compare("block_scores T=19 N=5 r=200",
                           block_scores(h2, z2, c2, alpha=100.0),
                           ref.block_scores_ref(h2, z2, c2, 100.0)))
    err = max(err, block_scores_ragged_gates())
    # h (T = 16) from the loop above; one call below runs all 9 levels, so
    # times and bound are one decode's worth of block_scores calls.
    cnts = [torch.zeros(zl.shape[0], device=dev) for zl in levels]
    t = h.shape[0]
    n_bytes = flops = 0.0
    for zl in levels:
        n = zl.shape[0]
        n_bytes += 4 * (t * r + n * r * r + n + t * n)
        flops += 2 * t * n * (r * r + r)
    bms, by = bound_ms(n_bytes, flops)
    log_plans(f"serving levels T={t}", t, [zl.shape[0] for zl in levels], r)

    def per_level(fn):
        return lambda: [fn(zl, cnt) for zl, cnt in zip(levels, cnts)]

    out["block_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by, **times(
            per_level(lambda zl, c: block_scores(h, zl, c, alpha=1.0)),
            per_level(lambda zl, c: ref.block_scores_ref(h, zl, c, 1.0)),
            per_level(lambda zl, c: torch.einsum("nij,ti,tj->tn", zl, h,
                                                 h))))

    # leaf_scores at the decode's shape (T 16 x beam 256 = G 4096 leaves of
    # 128 rows, r = 128), both modes, plus a ragged G and a width that
    # takes the scalar (non-float4) loop.
    g, b = 4096, 128
    hg = torch.randn((g, r), generator=gen, device=dev)
    rows = torch.randn((g, b, r), generator=gen, device=dev)
    err = compare("leaf_scores dot (4096, 128, 128)",
                  leaf_scores(hg, rows, square=False),
                  ref.leaf_dots_ref(hg, rows))
    err = max(err, compare("leaf_scores square (4096, 128, 128)",
                           leaf_scores(hg, rows, alpha=100.0),
                           ref.leaf_scores_ref(hg, rows, 100.0)))
    for gg, bb, rr in ((4093, 128, 128), (37, 50, 126)):
        h2 = torch.randn((gg, rr), generator=gen, device=dev)
        r2 = torch.randn((gg, bb, rr), generator=gen, device=dev)
        err = max(err, compare(f"leaf_scores dot ({gg}, {bb}, {rr})",
                               leaf_scores(h2, r2, square=False),
                               ref.leaf_dots_ref(h2, r2)))
        err = max(err, compare(f"leaf_scores square ({gg}, {bb}, {rr})",
                               leaf_scores(h2, r2, alpha=100.0),
                               ref.leaf_scores_ref(h2, r2, 100.0)))
    h3 = hg[:, :, None]
    bms, by = bound_ms(4 * (g * r + g * b * r + g * b), 2 * g * b * r)
    out["leaf_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: leaf_scores(hg, rows, square=False),
                lambda: ref.leaf_dots_ref(hg, rows),
                lambda: torch.bmm(rows, h3)))
    log_rows("serving shapes", out)
    del w, z, levels, rows, hg
    torch.cuda.empty_cache()
    return out


def block_scores_ragged_gates() -> float:
    """block_scores at ragged shapes of its tiles, against its plain
    version (counts, alpha 100; inputs from a generator of their own): a
    partial 64-query tile (T 257, r 128) and r = 1,100, whose row tiles
    (of 96) and 128-column tiles are both ragged, at T 16 and 19; then Z's
    4-byte copies, at both query tilings: r = 1,101 (r % 4 != 0) at T 19,
    and r = 1,100 at T 16 with Z a contiguous view one float into a larger
    buffer (not 16-byte aligned).  Returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    err = 0.0
    for t, n, r, offset in ((257, 5, 128, 0), (16, 3, 1100, 0),
                            (19, 3, 1100, 0), (19, 3, 1101, 0),
                            (16, 3, 1100, 1)):
        h = torch.randn((t, r), generator=gen, device=DEV)
        z = ref.zstats_ref(torch.randn((n, 40, r), generator=gen,
                                       device=DEV))
        if offset:
            buf = torch.empty(offset + z.numel(), device=DEV)
            buf[offset:] = z.flatten()
            z = buf[offset:].view(z.shape)
            if z.data_ptr() % 16 == 0:
                raise AssertionError("block_scores: the offset Z is aligned")
        c = torch.arange(1, n + 1, dtype=torch.float32, device=DEV)
        tiles = kernels.block_scores.plan(t, n, r)
        err = max(err, compare(
            f"block_scores T={t} N={n} r={r} Z offset {offset} {tiles}",
            block_scores(h, z, c, alpha=100.0),
            ref.block_scores_ref(h, z, c, 100.0)))
    return err


def log_plans(tag: str, t: int, nodes: list[int], r: int) -> None:
    """The block_scores tiling of each call of a timed row."""
    log(f"[kernels] block_scores plans ({tag}): "
        + "; ".join(f"N={n}: {tuple(kernels.block_scores.plan(t, n, r))}"
                    for n in nodes))


def log_rows(tag: str, rows: dict[str, dict]) -> None:
    for name, row in rows.items():
        if name.startswith("block_scores"):
            log(f"[kernels] {name} ({tag}): device ms cover both its "
                "kernels (tiles, and the combine where a node has more "
                "than one tile)")
        log(f"[kernels] {name} ({tag}): device ms per call: kernel "
            f"{row['ms']}, plain {row['plain_ms']}, library "
            f"{row['library_ms']}, bound {row['bound_ms']} "
            f"({row['bound_by']}); kernel call by CUDA events "
            f"{row['event_ms']} ms")


def head_inputs(gen: torch.Generator, t: int, k: int, n: int, d: int):
    """A fused-head call shaped like the training path's: slot 0 a label,
    slots 1.. negatives drawn with replacement, corrections ln(m q), hits
    on the label and every 7th token's last slot masked with MASK_CORR,
    ids repeated within a token (slot 5 = slot 1) and across tokens (token
    i's slot 2 = token i+1's label)."""
    dev = DEV
    w = 0.05 * torch.randn((n, d), generator=gen, device=dev)
    h = torch.randn((t, d), generator=gen, device=dev)
    ids = torch.randint(0, n, (t, k), generator=gen, device=dev,
                        dtype=torch.int32)
    if k > 5:
        ids[:, 5] = ids[:, 1]
    if k > 2 and t > 1:
        ids[:-1, 2] = ids[1:, 0]
    q = torch.rand((t, k), generator=gen, device=dev) * 2.0 / n + 1e-9
    corr = torch.log((k - 1) * q)
    corr[:, 0] = 0.0
    hit = torch.zeros_like(corr, dtype=torch.bool)
    hit[:, 1:] = ids[:, 1:] == ids[:, :1]
    hit[::7, -1] = True
    corr = torch.where(hit, ops.MASK_CORR, corr)
    biasg = 0.1 * torch.randn((t, k), generator=gen, device=dev)
    return w, h, ids, corr, biasg


def check_fused(tag: str, gen: torch.Generator, w, h, ids, corr, biasg,
                abs_mode: bool) -> tuple[float, float]:
    """fused_lse and fused_lse_bwd against the plain chunked path on the
    same inputs; the backward gets the plain lse and a per-token cotangent,
    so it is held on its own.  A second call of each, back to back, must
    give bitwise the same outputs (dL/dw is summed in a fixed order)."""
    lse = fused_head.fused_lse(w, h, ids, corr, biasg, abs_mode=abs_mode)
    again = fused_head.fused_lse(w, h, ids, corr, biasg, abs_mode=abs_mode)
    lse_p = ops._chunked_lse(w, h, ids, corr, biasg, abs_mode)
    e_fwd = compare(f"fused_lse {tag}", lse, lse_p)
    gbar = torch.randn(h.shape[0], generator=gen, device=h.device)
    got = fused_head.fused_lse_bwd(w, h, ids, corr, biasg, lse_p, gbar,
                                   abs_mode=abs_mode)
    got2 = fused_head.fused_lse_bwd(w, h, ids, corr, biasg, lse_p, gbar,
                                    abs_mode=abs_mode)
    want = ops._chunked_lse_bwd(w, h, ids, corr, biasg, lse_p, gbar,
                                abs_mode)
    names = ("dw", "dh", "dcoef", "dcorr")
    e_bwd = max(compare(f"fused_lse_bwd {name} {tag}", a, b)
                for name, a, b in zip(names, got, want))
    differ = [name for name, a, b in zip(("lse",) + names, (lse,) + got,
                                         (again,) + got2)
              if not torch.equal(a, b)]
    log(f"  fused head {tag}: two calls bitwise equal: "
        f"{'no, ' + str(differ) if differ else 'yes'}")
    if differ:
        raise AssertionError(f"fused head {tag}: two calls differ in "
                             f"{differ}")
    return e_fwd, e_bwd


def fused_rows(tag: str, w, h, ids, corr, biasg, errs: tuple[float, float]
               ) -> dict[str, dict]:
    """The fused-head kernels' rows (abs mode, as training calls them) on
    these inputs: device / call / plain times and bounds, the backward's
    time by kernel and a zero fill of its dL/dw (the floor of its one
    dense write).  The bound counts the distinct rows the ids read, h, the
    (T, K) inputs and outputs, and dL/dw's write; 2 FLOPs a slot and
    column forward, 6 back."""
    t, k = ids.shape
    n, r = w.shape
    el = w.element_size()
    uniq = int(torch.unique(ids).numel())
    hits = torch.bincount(ids.reshape(-1).long(), minlength=n)
    lse = ops._chunked_lse(w, h, ids, corr, biasg, True)
    gbar = torch.full((t,), 1.0 / t, device=h.device)
    tk = t * k
    out = {}
    bms, by = bound_ms(el * (uniq * r + t * r) + 4 * (3 * tk + t), 2 * tk * r)
    out["fused_lse"] = dict(
        max_abs_err=errs[0], bound_ms=bms, bound_by=by,
        **times(lambda: fused_head.fused_lse(w, h, ids, corr, biasg,
                                             abs_mode=True),
                lambda: ops._chunked_lse(w, h, ids, corr, biasg, True)))
    bms, by = bound_ms(el * (uniq * r + t * r) + 4 * (3 * tk + 2 * t + n * r
                                                      + t * r + 2 * tk),
                       6 * tk * r)
    out["fused_lse_bwd"] = dict(
        max_abs_err=errs[1], bound_ms=bms, bound_by=by,
        **times(lambda: fused_head.fused_lse_bwd(
                    w, h, ids, corr, biasg, lse, gbar, abs_mode=True),
                lambda: ops._chunked_lse_bwd(
                    w, h, ids, corr, biasg, lse, gbar, True)))
    out["fused_lse_bwd"]["kernels_ms"] = device_split(
        lambda: fused_head.fused_lse_bwd(w, h, ids, corr, biasg, lse, gbar,
                                         abs_mode=True))
    # the floor of dL/dw's one dense write: a zero fill of the same table
    dw = torch.empty((n, r), dtype=torch.float32, device=h.device)
    out["fused_lse_bwd"]["dw_fill_ms"] = device_ms(dw.zero_)
    del dw
    log(f"[kernels] fused head {tag}: {uniq} distinct rows of {tk} slots, "
        f"most on one row {int(hits.max())}, {w.dtype}; fused_lse_bwd's "
        f"kernels, device ms per call: {out['fused_lse_bwd']['kernels_ms']}"
        f"; a zero fill of dL/dw {out['fused_lse_bwd']['dw_fill_ms']} ms")
    log_rows(tag, out)
    return out


def phase_kernels_training(gen: torch.Generator, cfg
                           ) -> tuple[dict[str, dict], dict[str, dict]]:
    """All five kernels at the training path's shapes (youtube-dnn: 100,000
    items in 391 blocks of 256 (160 real rows in the last), r = d = 128,
    T = 256, m = 128, alpha = 100); the fused head's other shapes' rows
    apart, by tag."""
    dev = DEV
    out = {}
    n, r, bsz = cfg.vocab_size, api.hidden_width(cfg), cfg.sampler_block
    t, m, alpha = TRAIN_BATCH, cfg.m_negatives, cfg.sampler_alpha
    nb = -(-n // bsz)

    # zstats: the refresh's leaf Grams, padding rows zero
    head = 0.05 * torch.randn((n, r), generator=gen, device=dev)
    stats = blocks.build(head, bsz)
    w = stats.wq
    z = zstats(w)
    err = compare(f"zstats ({nb}, {bsz}, {r})", z, ref.zstats_ref(w))
    wt = w.transpose(1, 2)
    bms, by = bound_ms(4 * (nb * bsz * r + nb * r * r), nb * bsz * r * (r + 1))
    out["zstats"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: zstats(w), lambda: ref.zstats_ref(w),
                lambda: torch.bmm(wt, w)))

    # block_scores: the sampler's root step, real counts
    hq = torch.randn((t, r), generator=gen, device=dev)
    cnt = stats.cnt
    err = compare(f"block_scores T={t} N={nb} alpha={alpha}",
                  block_scores(hq, z, cnt, alpha=alpha),
                  ref.block_scores_ref(hq, z, cnt, alpha))
    bms, by = bound_ms(4 * (t * r + nb * r * r + nb + t * nb),
                       2 * t * nb * (r * r + r))
    log_plans("training root", t, [nb], r)
    out["block_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: block_scores(hq, z, cnt, alpha=alpha),
                lambda: ref.block_scores_ref(hq, z, cnt, alpha),
                lambda: torch.einsum("nij,ti,tj->tn", z, hq, hq)))

    # leaf_scores square: the within-block step, one (B, r) block per draw
    g = t * m
    blk = torch.randint(0, nb, (g,), generator=gen, device=dev)
    rows = w[blk]
    hg = hq.repeat_interleave(m, dim=0)
    err = compare(f"leaf_scores square ({g}, {bsz}, {r})",
                  leaf_scores(hg, rows, alpha=alpha),
                  ref.leaf_scores_ref(hg, rows, alpha))
    h3 = hg[:, :, None]
    bms, by = bound_ms(4 * (g * r + g * bsz * r + g * bsz),
                       g * bsz * (2 * r + 2))
    out["leaf_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: leaf_scores(hg, rows, alpha=alpha),
                lambda: ref.leaf_scores_ref(hg, rows, alpha),
                lambda: torch.bmm(rows, h3)))
    del rows, hg, h3, stats, w, wt, z
    torch.cuda.empty_cache()

    log_rows("training shapes", out)
    del head
    torch.cuda.empty_cache()
    fused, fused_shapes = phase_kernels_fused(gen, cfg)
    out.update(fused)
    return out, fused_shapes


def phase_kernels_fused(gen: torch.Generator, cfg
                        ) -> tuple[dict[str, dict], dict[str, dict]]:
    """fused_lse / fused_lse_bwd, the loss and its VJP, at the training
    shape (T 256, K 129 over a 100,000 x 128 head) in both abs modes, with
    90% of the slots on 3 rows, at two ragged widths, and in bf16; each
    case held against the plain path and repeated bitwise.  Returns the
    fp32 rows and, by shape tag, the bf16 and the 3-row-skew rows."""
    n, r = cfg.vocab_size, api.hidden_width(cfg)
    t, k = TRAIN_BATCH, 1 + cfg.m_negatives
    w, h, ids, corr, biasg = head_inputs(gen, t, k, n, r)
    e_fwd = e_bwd = 0.0
    for abs_mode in (True, False):
        ef, eb = check_fused(f"T={t} K={k} n={n} d={r} abs={abs_mode}", gen,
                             w, h, ids, corr, biasg, abs_mode)
        e_fwd, e_bwd = max(e_fwd, ef), max(e_bwd, eb)
    for tt, kk, nn, dd in ((37, 17, 1000, 200), (37, 17, 1000, 126)):
        args = head_inputs(gen, tt, kk, nn, dd)
        ef, eb = check_fused(f"T={tt} K={kk} n={nn} d={dd} abs=True", gen,
                             *args, True)
        e_fwd, e_bwd = max(e_fwd, ef), max(e_bwd, eb)
    hot = torch.randint(0, n, (3,), generator=gen, device=ids.device,
                        dtype=torch.int32)
    on = torch.rand(ids.shape, generator=gen, device=ids.device) < 0.9
    skew = torch.where(on, hot[torch.randint(0, 3, ids.shape, generator=gen,
                                             device=ids.device)], ids)
    errs = check_fused(f"T={t} K={k} n={n} d={r} abs=True, 90% of the "
                       f"slots on 3 rows", gen, w, h, skew, corr, biasg,
                       True)
    skew3 = fused_rows("90% of the slots on 3 rows", w, h, skew, corr, biasg,
                       errs)
    rows = fused_rows("training shape", w, h, ids, corr, biasg,
                      (e_fwd, e_bwd))
    wb, hb = w.bfloat16(), h.bfloat16()
    errs = check_fused(f"T={t} K={k} n={n} d={r} abs=True bf16", gen, wb,
                       hb, ids, corr, biasg, True)
    bf16 = fused_rows("training shape, bf16", wb, hb, ids, corr, biasg, errs)
    del w, h, ids, corr, biasg, wb, hb, skew
    torch.cuda.empty_cache()
    return rows, {"bf16": bf16, "skew3": skew3}


def phase_kernels_hier(gen: torch.Generator, cfg
                       ) -> tuple[dict[str, dict], dict[str, dict]]:
    """The kernels of the hierarchical samplers at the training path's
    shapes (youtube-dnn: 100,000 items, d = 128, T = 256, m = 128, alpha =
    100), over a 512-leaf tree of 256-row leaves whose last 121 leaves are
    padding only and whose leaf 390 holds 160 real rows.

    Returns the rows of the three new kernels (rff's leaf feature sums;
    midx's stage-1 masses over 512 posting lists, 121 of them empty, and
    stage-2 scores over 32,768 drawn lists) and, by shape tag, the rows of
    two earlier kernels at shapes only these paths give them: the tree's
    ``block_scores`` on its nine dense levels and rff's leaf step through
    ``leaf_scores``' dot mode.  Bounds count the valid rows' work."""
    dev = DEV
    out = {}
    n, d, leaf = cfg.vocab_size, api.hidden_width(cfg), cfg.sampler_block
    t, m, alpha = TRAIN_BATCH, cfg.m_negatives, cfg.sampler_alpha
    g = t * m
    head = 0.05 * torch.randn((n, d), generator=gen, device=dev)
    hq = torch.randn((t, d), generator=gen, device=dev)

    # block_scores as the tree's descent calls it: every level of at most
    # dense_cap nodes (levels 1-9, 2 to 512 nodes), the level's true
    # counts, alpha = 100; one call below runs all of them
    ts = tree.build(head, quadratic_kernel(alpha), leaf)
    dense_cap = max(256, 4 * m)
    lv = [(z, c) for z, c in zip(ts.levels_z[1:], ts.levels_cnt[1:])
          if z.shape[0] <= dense_cap]
    err, n_bytes, flops = 0.0, 0.0, 0.0
    for z, c in lv:
        nodes = z.shape[0]
        err = max(err, compare(
            f"block_scores tree level T={t} N={nodes}",
            block_scores(hq, z, c, alpha=alpha),
            ref.block_scores_ref(hq, z, c, alpha)))
        n_bytes += 4 * (t * d + nodes * d * d + nodes + t * nodes)
        flops += 2 * t * nodes * (d * d + d)
    bms, by = bound_ms(n_bytes, flops)
    log_plans(f"tree levels T={t}", t, [z.shape[0] for z, _ in lv], d)

    def per_level(fn):
        return lambda: [fn(z, c) for z, c in lv]

    earlier = {"tree_levels": {"block_scores": dict(
        max_abs_err=err, bound_ms=bms, bound_by=by, **times(
            per_level(lambda z, c: block_scores(hq, z, c, alpha=alpha)),
            per_level(lambda z, c: ref.block_scores_ref(hq, z, c, alpha)),
            per_level(lambda z, c: torch.einsum("nij,ti,tj->tn", z, hq,
                                                hq))))}}
    log_rows(f"tree levels 1-{len(lv)}", earlier["tree_levels"])

    # leaf_scores' dot mode at rff's leaf step: raw queries against the
    # gathered rows of drawn leaves (the last live leaf holds padding rows)
    live = -(-n // leaf)
    leaves = torch.randint(0, live, (g,), generator=gen, device=dev)
    leaves[::97] = live - 1
    rows = ts.wq[leaves]
    hg = hq.repeat_interleave(m, dim=0)
    h3 = hg[:, :, None]
    err = compare(f"leaf_scores dot ({g}, {leaf}, {d})",
                  leaf_scores(hg, rows, square=False),
                  ref.leaf_dots_ref(hg, rows))
    bms, by = bound_ms(4 * (g * d + g * leaf * d + g * leaf), 2 * g * leaf * d)
    earlier["rff_leaf_dots"] = {"leaf_scores": dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: leaf_scores(hg, rows, square=False),
                lambda: ref.leaf_dots_ref(hg, rows),
                lambda: torch.bmm(rows, h3)))}
    log_rows("rff leaf step", earlier["rff_leaf_dots"])
    del ts, lv, rows, hg, h3
    torch.cuda.empty_cache()

    # rff_features: the rff refresh's leaf level, as build_features lays it
    # out (padding rows zero and masked out)
    n_feat, tau = cfg.rff_dim, cfg.rff_tau
    n_leaves = 1 << (-(-n // leaf) - 1).bit_length()
    pad = n_leaves * leaf - n
    wq = torch.nn.functional.pad(head, (0, 0, 0, pad))
    mask = (torch.arange(n_leaves * leaf, device=dev) < n).float().reshape(
        n_leaves, leaf)
    omega = rff_directions(gen, n_feat, d)
    shift = rff_logshift_bound(wq, omega, tau)
    wq = wq.reshape(n_leaves, leaf, d)
    # held against the float64 evaluation of the same function: two fp32
    # implementations of exponents near -50 can each be ~1e-5 off it in
    # opposite directions (one fp32 ulp of the argument is ~4e-6 of the
    # feature), so 1e-5 x max between them is not a sound gate
    f64 = torch.float64
    err = compare(f"rff_features ({n_leaves}, {leaf}, {d}) D={n_feat} "
                  f"(against float64)",
                  rff_features(wq, omega, mask, shift, tau=tau),
                  ref.rff_features_ref(wq, omega, mask, shift, tau, f64))
    plain_train = rel_dist(ref.rff_features_ref(wq, omega, mask, shift,
                                                tau),
                           ref.rff_features_ref(wq, omega, mask, shift, tau,
                                                f64))
    log(f"  rff_features training shape: the fp32 plain version's own "
        f"max|plain - float64| / max|float64| = {plain_train}")
    # the ragged case: the draw from `gen` (as before, so later data stays
    # the same) and 32 draws from a generator of its own
    rgen = torch.Generator(device=dev).manual_seed(808)
    ragged = [(gen, "gen")] + [(rgen, f"draw {i}") for i in range(32)]
    kernel_rel, plain_rel = [], []
    for g2, label in ragged:
        w2 = torch.randn((37, 50, 126), generator=g2, device=dev) * 0.3
        om2 = torch.randn((100, 126), generator=g2, device=dev)
        m2 = (torch.rand((37, 50), generator=g2, device=dev) < 0.7).float()
        s2 = rff_logshift_bound(w2.reshape(-1, 126), om2, 0.7)
        exact = ref.rff_features_ref(w2, om2, m2, s2, 0.7, f64)
        got = rff_features(w2, om2, m2, s2, tau=0.7)
        err = max(err, compare(f"rff_features (37, 50, 126) D=100 tau=0.7 "
                               f"{label} (against float64)", got, exact))
        kernel_rel.append(rel_dist(got, exact))
        plain_rel.append(rel_dist(ref.rff_features_ref(w2, om2, m2, s2, 0.7),
                                  exact))
    log(f"  rff_features ragged, {len(ragged)} draws: max|x - float64| / "
        f"max|float64| of the kernel: worst {max(kernel_rel)} median "
        f"{statistics.median(kernel_rel)}; of the fp32 plain version: worst "
        f"{max(plain_rel)} median {statistics.median(plain_rel)} (gate 1e-5)")
    # the kernel's products are 3xTF32 on the tensor cores: its operations
    # bound is the rate of fp32-accurate products made that way
    bms, by = bound_ms(4 * (n_leaves * leaf * (d + 1) + n_feat * d + 1
                            + n_leaves * n_feat),
                       n * n_feat * (2 * d + 4) + 2 * n * d,
                       TF32X3_FLOPS_PER_S)
    out["rff_features"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: rff_features(wq, omega, mask, shift, tau=tau),
                lambda: ref.rff_features_ref(wq, omega, mask, shift, tau)))
    del wq, mask

    # midx: a real index of the head (pc-bisection + two k-means), so the
    # codes, counts and empty lists are the sampler's.  Both stage-1
    # entries are held: the codes entry (the sampler's, through ops) and
    # the ct entry (the Pallas kernel's signature), in fp32 and bf16, at
    # the training shape and at a ragged one; empty lists exactly 0, two
    # calls bitwise equal.
    st = midx.build(head, codewords=cfg.midx_codewords,
                    codebooks=cfg.midx_codebooks, list_size=leaf)
    n_lists = st.num_lists
    empty = int((st.cnt == 0).sum())
    ct = st.c1[st.codes[:, 0].long()] + st.c2[st.codes[:, 1].long()]
    h2 = torch.randn((37, 126), generator=gen, device=dev)
    c12 = [torch.randn((5, 126), generator=gen, device=dev) * s
           for s in (0.1, 0.05)]
    codes2 = torch.randint(0, 5, (100, 2), generator=gen, device=dev,
                           dtype=torch.int32)
    cnt2 = torch.clamp(1000.0 - 16.0 * torch.arange(100, device=dev), 0, 16)
    ct2 = c12[0][codes2[:, 0].long()] + c12[1][codes2[:, 1].long()]
    err = 0.0
    for tag, hh, c1, c2, codes, cnt, ctt in (
            (f"T={t} P={n_lists} ({empty} empty) d={d}", hq, st.c1, st.c2,
             st.codes, st.cnt, ct),
            ("T=37 P=100 (37 empty) d=126", h2, *c12, codes2, cnt2, ct2)):
        for dt in (torch.float32, torch.bfloat16):
            hd, c1d, c2d, ctd = (x.to(dt) for x in (hh, c1, c2, ctt))
            for entry, fn, want in (
                    ("codes", lambda: ops.midx_list_masses(
                        hd, c1d, c2d, codes, cnt, alpha),
                     ref.midx_list_masses_ref(hd, c1d, c2d, codes, cnt,
                                              alpha)),
                    ("ct", lambda: midx_pair_masses(hd, ctd, cnt,
                                                    alpha=alpha),
                     ref.midx_pair_masses_ref(hd, ctd, cnt, alpha))):
                got = fn()
                name = f"midx_pair_masses {entry} entry {tag} {dt}"
                err = max(err, compare(name, got, want))
                if bool(got[:, cnt == 0].any()):
                    raise AssertionError(f"{name}: an empty list has mass")
                if not torch.equal(got, fn()):
                    raise AssertionError(f"{name}: two calls differ")
    n_codewords = st.c1.shape[0] + st.c2.shape[0]
    bms, by = bound_ms(4 * (t * d + n_codewords * d + 3 * n_lists
                            + t * n_lists),
                       t * n_lists * (2 * d + 3) + n_lists * d)
    hb, c1b, c2b, ctb = (x.bfloat16() for x in (hq, st.c1, st.c2, ct))
    out["midx_pair_masses"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: ops.midx_list_masses(hq, st.c1, st.c2, st.codes,
                                             st.cnt, alpha),
                lambda: ref.midx_list_masses_ref(hq, st.c1, st.c2, st.codes,
                                                 st.cnt, alpha),
                lambda: hq @ ct.T))
    # the ct entry, bf16, and the call with its expansion outside the
    # kernel as the sampler made it before the codes entry
    earlier["midx_ct_entry"] = {"midx_pair_masses": dict(
        ms=device_ms(lambda: midx_pair_masses(hq, ct, st.cnt, alpha=alpha)),
        event_ms=event_ms(lambda: midx_pair_masses(hq, ct, st.cnt,
                                                   alpha=alpha)))}
    earlier["midx_bf16"] = {"midx_pair_masses": dict(
        ms=device_ms(lambda: ops.midx_list_masses(hb, c1b, c2b, st.codes,
                                                  st.cnt, alpha)),
        ct_entry_ms=device_ms(lambda: midx_pair_masses(hb, ctb, st.cnt,
                                                       alpha=alpha)))}

    def expanded():
        ce = st.c1[st.codes[:, 0].long()] + st.c2[st.codes[:, 1].long()]
        return midx_pair_masses(hq, ce, st.cnt, alpha=alpha)

    earlier["midx_expanded"] = {"midx_pair_masses": dict(
        ms=device_ms(expanded), event_ms=event_ms(expanded))}
    for tag in ("midx_ct_entry", "midx_bf16", "midx_expanded"):
        log(f"[kernels] midx_pair_masses ({tag}): "
            + ", ".join(f"{k} {v}" for k, v in
                        earlier[tag]["midx_pair_masses"].items()))

    # midx_member_scores: stage 2 over lists drawn among the live ones (the
    # last live list holds padding rows)
    live = int((st.cnt > 0).sum())
    lists = torch.randint(0, live, (g,), generator=gen, device=dev)
    lists[::97] = live - 1
    rows = st.wq[lists]
    hg = hq.repeat_interleave(m, dim=0)
    err = compare(f"midx_member_scores ({g}, {leaf}, {d})",
                  midx_member_scores(hg, rows, alpha=alpha),
                  ref.midx_member_scores_ref(hg, rows, alpha))
    for gg, ll, dd in ((4093, 256, 128), (37, 50, 126)):
        h3 = torch.randn((gg, dd), generator=gen, device=dev)
        r3 = torch.randn((gg, ll, dd), generator=gen, device=dev)
        err = max(err, compare(f"midx_member_scores ({gg}, {ll}, {dd})",
                               midx_member_scores(h3, r3, alpha=alpha),
                               ref.midx_member_scores_ref(h3, r3, alpha)))
    h3 = hg[:, :, None]
    bms, by = bound_ms(4 * (g * d + g * leaf * d + g * leaf),
                       g * leaf * (2 * d + 2))
    out["midx_member_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: midx_member_scores(hg, rows, alpha=alpha),
                lambda: ref.midx_member_scores_ref(hg, rows, alpha),
                lambda: torch.bmm(rows, h3)))
    log_rows("training shapes", out)
    del rows, hg, h3, st, head
    torch.cuda.empty_cache()
    return out, earlier


def tower_queries(model, cfg, rng: np.random.Generator, n: int
                  ) -> torch.Tensor:
    """n (history, user_feats) pairs through the tower on the card."""
    history = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (n, cfg.history_len)))
    feats = torch.from_numpy(rng.normal(
        size=(n, cfg.user_feature_dim)).astype(np.float32))
    with torch.no_grad():
        return model(history.cuda(), feats.cuda())


def phase_serving(cfg, model, head, index, rng: np.random.Generator
                  ) -> None:
    k, beam, n_req = 10, 256, 96
    eng = ServingEngine(engine.make_decode_fn(cfg, None, head, k, beam=beam),
                        api.hidden_width(cfg), k, buckets=(1, 4, 16),
                        max_wait_ms=2.0, default_deadline_ms=60_000.0,
                        index=index, device="cuda")
    t0 = time.perf_counter()
    eng.start()
    log(f"[serving] warm-up of buckets (1, 4, 16): "
        f"{time.perf_counter() - t0:.3f} s; launches "
        f"{kernels.launch_counts()}")
    history = rng.integers(0, cfg.vocab_size, (n_req, cfg.history_len))
    feats = rng.normal(size=(n_req, cfg.user_feature_dim)).astype(np.float32)
    futs, hs = [], []
    t0 = time.perf_counter()
    try:
        for i in range(n_req):
            with torch.no_grad():
                h = model(torch.from_numpy(history[i:i + 1]).cuda(),
                          torch.from_numpy(feats[i:i + 1]).cuda())
            h = h.cpu().numpy()[0]
            hs.append(h)
            futs.append(eng.submit(h))
        results = [f.result_wait(120.0) for f in futs]
        wall = time.perf_counter() - t0
        c = eng.counters()  # the burst alone
        # one request at a time: the latency of an unloaded engine
        solo = []
        for h in hs[:16]:
            r = eng.decode(h, timeout=120.0)
            if not r.ok:
                raise AssertionError(f"request failed: {r.error}")
            solo.append(r.latency_ms)
    finally:
        eng.stop()
    bad = [r.error for r in results if not r.ok]
    if bad:
        raise AssertionError(f"{len(bad)} requests failed: {bad[:3]}")
    # every served logit is the exact dot of its id's head row
    hq = torch.from_numpy(np.stack(hs)).cuda()
    ids = torch.from_numpy(np.stack([r.ids for r in results])).cuda().long()
    got = torch.from_numpy(np.stack([r.logits for r in results])).cuda()
    exact = torch.einsum("tkd,td->tk", head[ids], hq)
    if not torch.allclose(got, exact, rtol=1e-5, atol=1e-5):
        raise AssertionError("served logits differ from their exact dots")
    lat = c["latency_ms"]
    log(f"[serving] burst of {n_req} requests ok in {wall:.3f} s: QPS "
        f"{n_req / wall}, latency p50 {lat['p50']} ms p99 {lat['p99']} ms "
        f"mean {lat['mean']} ms, microbatches {c['microbatches']}, "
        f"batch_occupancy {c['batch_occupancy']}; launches "
        f"{kernels.launch_counts()}")
    log(f"[serving] then 16 requests one at a time: latency median "
        f"{statistics.median(solo)} ms, max {max(solo)} ms")


def phase_exact(cfg, model, head, index, rng: np.random.Generator) -> None:
    k = 10
    h = tower_queries(model, cfg, rng, 16)
    ids, logits = retrieval.decode_topk(index, h, k, None, gram_cap=512)
    dids, dlog = retrieval.dense_topk(head, h, k + 1, n_valid=cfg.vocab_size)
    torch.cuda.synchronize()
    if not torch.allclose(logits, dlog[:, :k], rtol=1e-5, atol=0.0):
        raise AssertionError("full-beam logits differ from the dense top-k")
    near = lambda a, b: abs(a - b) <= 1e-5 * abs(b)  # noqa: E731
    ids_c, dids_c, dlog_c = ids.cpu(), dids.cpu(), dlog.cpu().tolist()
    swaps = 0
    for t in range(h.shape[0]):
        for j in range(k):
            if ids_c[t, j] == dids_c[t, j]:
                continue
            lt = dlog_c[t]
            if not (near(lt[j], lt[j - 1]) if j else False) and \
                    not near(lt[j], lt[j + 1]):
                raise AssertionError(
                    f"full beam id {int(ids_c[t, j])} != dense "
                    f"{int(dids_c[t, j])} at query {t} rank {j} without a "
                    "tie")
            swaps += 1
    log(f"[exact] full beam (gram_cap 512): ids equal dense_topk on 16 "
        f"queries ({swaps} tie swaps); launches {kernels.launch_counts()}")

    ids, logits = retrieval.decode_topk(index, h, k, 256)
    exact = torch.einsum("tkd,td->tk", head[ids.long()], h)
    if not torch.allclose(logits, exact, rtol=1e-5, atol=1e-5):
        raise AssertionError("narrow-beam logits differ from dense logits")
    if not (logits[:, :-1] >= logits[:, 1:]).all():
        raise AssertionError("narrow-beam logits are not sorted")
    rec = retrieval.recall_at_k(index, head, h, k, 256)
    log(f"[exact] beam 256: logits exact and sorted; recall@10 {rec} "
        "(random head, not gated)")


def host_ms(fn) -> float:
    """Median host-clock time of one call ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(9):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_breakdown(cfg, model, head, index, rng: np.random.Generator
                    ) -> None:
    """Where one decode's time goes, per microbatch bucket (beam 256):
    the whole decode, its beam descent, its exact leaf step (gather + leaf
    kernel + top-k) and the gather alone, beside the dense head."""
    k, beam = 10, 256
    stats = retrieval.index_stats(index)
    depth = stats.depth
    unpack = hierarchy.unpack_levels
    ball = (unpack(index.mu, depth), unpack(index.rad, depth))
    spec = (unpack(index.evecs, depth), unpack(index.evals, depth))
    for b in (1, 4, 16):
        h = tower_queries(model, cfg, rng, b)
        leaves = retrieval.beam_descent(stats, h, beam, ball=ball, spec=spec)
        row = dict(
            decode=host_ms(lambda: retrieval.decode_topk(index, h, k, beam)),
            rehydrate=host_ms(lambda: retrieval.index_stats(index)),
            descent=host_ms(lambda: retrieval.beam_descent(
                stats, h, beam, ball=ball, spec=spec)),
            leaf_topk=host_ms(lambda: retrieval.leaf_topk(stats, h, leaves,
                                                          k)),
            gather=host_ms(lambda: stats.wq[leaves]),
            dense=host_ms(lambda: retrieval.dense_topk(
                head, h, k, n_valid=cfg.vocab_size)))
        log(f"[breakdown] T={b} host ms (median of 9, synced): "
            + ", ".join(f"{name} {ms}" for name, ms in row.items()))


def eval_loss(state, cfg, batch) -> float:
    """Mean full-softmax (eq. 1, abs mode) loss of a batch: the dense head
    over all 100,000 items, no sampling."""
    with torch.no_grad():
        h, labels, _ = api.backbone_hidden(state.params, batch, cfg)
        return float(torch.mean(full_softmax_loss(
            api.head_table(state.params, cfg), h, labels,
            abs_mode=cfg.abs_softmax)))


def real_step_inputs(state, cfg, batch, gen):
    """The fused head's inputs of one training step, rebuilt from the
    trained state: tower -> h, refresh, sampled negatives, gather plan."""
    sampler = sampler_from_config(cfg)
    with torch.no_grad():
        h, labels, _ = api.backbone_hidden(state.params, batch, cfg)
        head = api.head_table(state.params, cfg).detach()
        sstate = step.make_refresh_fn(cfg)(head, state.sampler_state)
        runtime = sampler.hydrate(sstate, cfg.vocab_size)
        neg, logq = sampler.sample_batch(runtime, h, cfg.m_negatives, gen)
        ids, corr = fused_plan(labels, neg, logq)
    return head, h.contiguous(), ids.to(torch.int32), corr, neg, logq, \
        labels, runtime


def run_fit(cfg, data, tag: str, batch: str = f"batch {TRAIN_BATCH}"):
    """60 steps of ``fit`` from seed 0; logs the loss means of the first and
    last 10 steps and returns them with the result."""
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    t0 = time.perf_counter()
    res = loop.fit(cfg, None, opt, data, TRAIN_STEPS, seed=0, log_every=10,
                   device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first = statistics.mean(res.losses[:10])
    last = statistics.mean(res.losses[-10:])
    log(f"[training] {tag}: {cfg.name} {cfg.vocab_size} classes, {batch}, "
        f"m {cfg.m_negatives}, {TRAIN_STEPS} steps in "
        f"{wall:.3f} s ({wall / TRAIN_STEPS * 1e3:.3f} ms/step, first step "
        f"included); sampled loss mean of steps 0-9 {first}, of steps "
        f"{TRAIN_STEPS - 10}-{TRAIN_STEPS - 1} {last}; stragglers "
        f"{res.straggler_steps}")
    return res, first, last


def held_out_batch(cfg) -> dict[str, torch.Tensor]:
    return next(batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=1000,
                                   device=DEV))


def phase_training(cfg) -> tuple[dict[str, int], object, dict[str, dict]]:
    """youtube-dnn at full width through fit: the training main path, on a
    cycled pool of TRAIN_POOL batches."""
    dev = DEV
    held = held_out_batch(cfg)
    # fit draws its state from seed 0 exactly as this does
    init = step.init_train_state(
        torch.Generator(dev).manual_seed(0), cfg, None,
        make_optimizer("adamw", 1e-2, weight_decay=0.0), device=dev)
    before = eval_loss(init, cfg, held)
    data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=0, device=dev)
    pool = [next(data) for _ in range(TRAIN_POOL)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res, first, last = run_fit(cfg, itertools.cycle(pool),
                               f"pool of {TRAIN_POOL} batches")
    counts = kernels.launch_counts()
    log(f"[training] launches {counts}")
    want = expected_launches(cfg)
    if counts != want:
        raise AssertionError(f"training launches {counts} != {want}")
    if not all(math.isfinite(x) for x in res.losses) or not last < first:
        raise AssertionError(f"training loss did not fall: {first} -> "
                             f"{last}")
    log(f"[training] held-out full-softmax loss (batch {TRAIN_BATCH}): "
        f"before {before}, after the pool {eval_loss(res.state, cfg, held)}"
        f"; ln(n) = {math.log(cfg.vocab_size)}")

    # The fused head's kernels against its plain path on the inputs of the
    # first step fit takes (its initial state, a batch it has not seen).
    gen = torch.Generator(dev).manual_seed(7)
    head, h, ids, corr, *_ = real_step_inputs(init, cfg, held, gen)
    biasg = torch.zeros(ids.shape, device=dev)
    masked = int((corr >= ops.MASK_CORR).sum())
    uniq = int(torch.unique(ids).numel())
    check_fused(f"real step ({masked} masked slots, {uniq} distinct ids)",
                gen, head, h, ids, corr, biasg, cfg.abs_softmax)
    # ... and on a step of the trained state, whose sampler draws from the
    # pool-fitted head (the log gives the most draws one row takes; phase
    # 3's 90%-on-3-rows case is the extreme skew): held, repeated bitwise
    # and timed as a second shape of both kernels
    head, h, ids, corr, *_ = real_step_inputs(res.state, cfg, held, gen)
    errs = check_fused("trained state's step", gen, head, h, ids, corr,
                       biasg, cfg.abs_softmax)
    skewed = fused_rows("trained state's step", head, h, ids, corr, biasg,
                        errs)
    del init, head, h, ids, corr

    # the trained head served: export the index and decode 16 queries
    t0 = time.perf_counter()
    index = step.export_retrieval_index(res.state, cfg, None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        hq, _, _ = api.backbone_hidden(
            res.state.params, {k: v[:16] for k, v in held.items()}, cfg)
    ids16, logits = retrieval.decode_topk(index, hq, 10, 256)
    w = api.head_table(res.state.params, cfg).detach()
    exact = torch.einsum("tkd,td->tk", w[ids16.long()], hq)
    if not torch.allclose(logits, exact, rtol=1e-5, atol=1e-5) or \
            not (logits[:, :-1] >= logits[:, 1:]).all():
        raise AssertionError("decode from the exported index is not exact "
                             "and sorted")
    rec = retrieval.recall_at_k(index, w, hq, 10, 256)
    log(f"[training] exported index in {build_s:.3f} s; 16 held-out "
        f"queries decoded at beam 256: logits exact and sorted, recall@10 "
        f"{rec}")
    return counts, res.state, skewed


def phase_fresh(cfg) -> None:
    """``--fresh``: TRAIN_STEPS steps over fresh batches (no pool), once
    with the configured sampled loss and once with the exact full softmax
    (estimator "full": no sampler, no fused head), each reported with the
    held-out full-softmax loss.  Not gated: it asks whether this depth
    learns anything on unseen labels, and whether sampling is what stops
    it."""
    held = held_out_batch(cfg)
    for est in (cfg.estimator, "full"):
        c = dataclasses.replace(cfg, estimator=est)
        res, _, _ = run_fit(c, batch_iterator_for(
            c, None, TRAIN_BATCH, 1, seed=500, device=DEV),
            f"fresh batches, estimator {est}")
        log(f"[fresh] estimator {est}: held-out full-softmax loss after "
            f"{TRAIN_STEPS} fresh steps {eval_loss(res.state, c, held)}; "
            f"ln(n) = {math.log(cfg.vocab_size)}")


def sampler_launches(cfg, tp: int = 1
                     ) -> tuple[dict[str, int], dict[str, int]]:
    """(launches of one refresh, of one ``sample_batch``) of ``cfg``'s
    sampler at full width, on one shard of ``tp`` (its vocab / tp rows,
    m / tp draws).  The block sampler scores its root once
    (block_scores) and the drawn blocks once (leaf_scores); the tree's
    descent scores each level with at most ``dense_cap = max(256, 4m)``
    nodes through block_scores: levels 1-9 (2 to 512 nodes) of the
    512-leaf tree at full width, levels 1-7 of a tp 4 shard's 128 leaves,
    1-8 of a tp 2 shard's 256; midx rebuilds with no hand-written
    kernel.  The batch-shared family refreshes through zstats and samples
    by einsums (no kernel); tapas refreshes and draws its pool as its base
    does and resamples by a product; the oracles rebuild and score in plain
    products."""
    if cfg.sampler == "tapas":
        return sampler_launches(dataclasses.replace(cfg,
                                                    sampler=cfg.tapas_base),
                                tp)
    if cfg.sampler == "block-quadratic-shared":
        return {"zstats": 1}, {}
    if cfg.sampler in ORACLE_FAMILIES:
        return {}, {}
    if cfg.sampler == "block-quadratic":
        return {"zstats": 1}, {"block_scores": 1, "leaf_scores": 1}
    if cfg.sampler == "tree-quadratic":
        v_l = rules.vocab_shard(cfg.vocab_size, tp)
        leaves = 1 << (-(-v_l // cfg.sampler_block) - 1).bit_length()
        dense = sum(1 for lvl in range(1, leaves.bit_length())
                    if (1 << lvl) <= max(256, 4 * cfg.m_negatives // tp))
        return {"zstats": 1}, {"block_scores": dense, "leaf_scores": 1}
    if cfg.sampler == "rff":
        return {"rff_features": 1}, {"leaf_scores": 1}
    if cfg.sampler == "midx":
        return {}, {"midx_pair_masses": 1, "midx_member_scores": 1}
    raise ValueError(f"no launch plan for sampler {cfg.sampler!r}")


def expected_launches(cfg, steps: int = TRAIN_STEPS,
                      refreshes: int | None = None, tp: int = 1
                      ) -> dict[str, int]:
    """Exact launches of ``steps`` steps of ``fit`` with a kernel sampler
    (on a rank of a mesh of model width ``tp``):
    ``init_train_state`` builds the statistics once and every step
    refreshes them (refresh every step; ``refreshes`` overrides the
    count), samples once and runs the fused head forward and backward
    once (``sampler_launches``) — but for shared (m,) negatives, which take
    the loss's einsum path."""
    refresh, sample = sampler_launches(cfg, tp)
    counts = dict.fromkeys(REPLACES, 0)
    head = 0 if sampler_from_config(cfg).shares_negatives else steps
    counts.update(fused_lse=head, fused_lse_bwd=head)
    for name, n in refresh.items():
        counts[name] += n * (steps + 1 if refreshes is None else refreshes)
    for name, n in sample.items():
        counts[name] += n * steps
    return counts


def check_draw_logq(cfg, state, held, draws=None) -> None:
    """The eq. 2 exactness contract on the card: on 4 held-out queries the
    logq the sampler reports for its draws equals its ``all_class_logq``
    at the drawn ids within 1e-4, and no id is at or past n_valid.  For
    rff, also the share of live nodes whose feature mass underflows to 0.
    ``draws``: (h, ids, logq) of 4 queries drawn elsewhere (the facade's),
    in place of drawing from ``held``."""
    sampler = sampler_from_config(cfg)
    if draws is None and (sampler.shares_negatives or sampler.two_stage
                          or not sampler.carries_state):
        check_sampler_logq(cfg, state, held)
        return
    gen = torch.Generator(DEV).manual_seed(17)
    with torch.no_grad():
        runtime = sampler.hydrate(state.sampler_state, cfg.vocab_size)
        if draws is None:
            h, _, _ = api.backbone_hidden(
                state.params, {k: v[:4] for k, v in held.items()}, cfg)
            ids, logq = sampler.sample_batch(runtime, h, cfg.m_negatives,
                                             gen)
        else:
            h, ids, logq = draws
        worst, mass = 0.0, []
        for t in range(h.shape[0]):
            oracle = sampler.all_class_logq(runtime, h[t])
            worst = max(worst, float((logq[t] - oracle[ids[t]]).abs().max()))
            mass.append(float(torch.logsumexp(oracle, 0).exp()))
    top = int(ids.max())
    log(f"[{cfg.sampler}] 4 held-out queries x {cfg.m_negatives} draws: max "
        f"|logq - all_class_logq[ids]| = {worst}; oracle total mass "
        f"{mass}; max id {top} (n_valid {cfg.vocab_size})")
    if not torch.isfinite(logq).all() or top >= cfg.vocab_size:
        raise AssertionError(f"{cfg.sampler}: a draw has a non-finite logq "
                             "or an id past n_valid")
    if worst > 1e-4:
        raise AssertionError(f"{cfg.sampler}: reported logq differs from "
                             f"all_class_logq by {worst} > 1e-4")
    if cfg.sampler == "rff":
        st = runtime["stats"]
        counts = hierarchy.count_levels(st.n_valid, st.num_leaves,
                                        st.leaf_size, st.depth)
        phi_h = hierarchy._query_features(h, runtime["proj"], cfg.rff_tau)
        dead = live = dead_q = 0
        for f, c in zip(st.levels_f, counts):
            on = c > 0
            live += int(on.sum())
            dead += int((f[on].amax(dim=-1) == 0).sum())
            dead_q += int(((phi_h @ f.T)[:, on] == 0).sum())
        log(f"[rff] live nodes whose feature sum underflowed to 0: {dead} "
            f"of {live}; (query, live node) masses that are 0: {dead_q} of "
            f"{live * h.shape[0]}; logshift {float(st.logshift)}")


def phase_family(cfg, pool, held, batch: str = f"batch {TRAIN_BATCH}"
                 ) -> tuple[dict[str, int], object]:
    """One sampler family through fit at full width: the pool run, its
    exact launch counts and falling loss, then the exactness check."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res, first, last = run_fit(cfg, itertools.cycle(pool),
                               f"{cfg.sampler}, pool of {TRAIN_POOL} batches",
                               batch)
    counts = kernels.launch_counts()
    log(f"[{cfg.sampler}] launches {counts}")
    want = expected_launches(cfg)
    if counts != want:
        raise AssertionError(f"{cfg.sampler}: launches {counts} != {want}")
    if not all(math.isfinite(x) for x in res.losses) or not last < first:
        raise AssertionError(f"{cfg.sampler}: training loss did not fall: "
                             f"{first} -> {last}")
    check_draw_logq(cfg, res.state, held)
    return counts, res.state


def phase_family_breakdown(cfg, state, steps: int = 1) -> None:
    """Host ms (median of 9, synced) of one family's refresh, sampler and
    whole step at T = 256, then a torch.profiler trace of ``steps``
    steps."""
    sampler = sampler_from_config(cfg)
    refresh = step.make_refresh_fn(cfg)
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    train_step = step.make_train_step(cfg, None, opt)
    batch = next(batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=2000,
                                    device=DEV))
    gen = torch.Generator(DEV).manual_seed(11)
    head = api.head_table(state.params, cfg).detach()
    with torch.no_grad():
        h, _, _ = api.backbone_hidden(state.params, batch, cfg)
    runtime = sampler.hydrate(state.sampler_state, cfg.vocab_size)
    holder = {"state": state}

    def whole():
        holder["state"], _ = train_step(holder["state"], batch, gen)

    with torch.no_grad():
        row = dict(
            refresh=host_ms(lambda: refresh(head, state.sampler_state)),
            sampler=host_ms(lambda: sampler.sample_batch(
                runtime, h, cfg.m_negatives, gen)))
    row["step"] = host_ms(whole)
    log(f"[breakdown] {cfg.sampler} training step, T={TRAIN_BATCH}, "
        f"m={cfg.m_negatives}: host ms (median of 9, synced): "
        + ", ".join(f"{name} {ms}" for name, ms in row.items()))
    phase_profile(cfg, holder["state"], steps=steps)


def host_ms_split(setup, fn) -> float:
    """Median host-clock time of ``fn(setup())``, only ``fn`` timed."""
    times = []
    for i in range(10):
        arg = setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_training_breakdown(cfg, state, batch=None) -> None:
    """Where one training step's time goes: host ms per stage, each ending
    in a device sync, median of 9, beside the whole step and the dense
    full-softmax head's forward + backward at the same T.  The sampler is
    timed whole (``sample_batch``), with its leaf step's block gather
    alone beside it; the profile phase splits its device time by kernel.
    ``batch`` defaults to a fresh youtube-dnn batch of TRAIN_BATCH."""
    dev = DEV
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    if batch is None:
        batch = next(batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=2000,
                                        device=dev))
    gen = torch.Generator(dev).manual_seed(11)
    refresh = step.make_refresh_fn(cfg)
    head_p = api.head_table(state.params, cfg)
    head, h, ids, corr, neg, logq, labels, runtime = real_step_inputs(
        state, cfg, batch, gen)
    stats = runtime["stats"]
    m = cfg.m_negatives
    # the blocks of this step's draws: the leaf step's gather, timed alone
    blk = torch.div(neg.reshape(-1), stats.block_size, rounding_mode="floor")

    def forward(_=None):
        hh, lab, _ = api.backbone_hidden(state.params, batch, cfg)
        return torch.mean(estimators.loss_from_embeddings(
            estimator, head_p, hh, lab, neg, logq, abs_mode=cfg.abs_softmax,
            impl=cfg.head_impl))

    params = step.param_dict(state.params)
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    scratch = {k: p.detach().clone() for k, p in params.items()}

    def optimizer():
        upd, _ = opt.update(grads, state.opt_state, scratch)
        apply_updates(scratch, upd)

    def dense_setup():
        return head_p.detach().clone().requires_grad_(), h.detach()

    def dense(args):
        w_, h_ = args
        torch.mean(full_softmax_loss(w_, h_, labels,
                                     abs_mode=cfg.abs_softmax)).backward()

    train_step = step.make_train_step(cfg, None, opt)
    holder = {"state": state}

    def whole():
        holder["state"], _ = train_step(holder["state"], batch, gen)

    row = dict(
        refresh=host_ms(lambda: refresh(head_p, state.sampler_state)),
        sampler=host_ms(lambda: sampler.sample_batch(runtime, h, m, gen)),
        leaf_gather_of_sampler=host_ms(lambda: stats.wq[blk]),
        loss_forward=host_ms(forward),
        backward=host_ms_split(forward, lambda loss: loss.backward()),
        clip_adamw=host_ms(optimizer),
        step=host_ms(whole),
        dense_head_fwd_bwd=host_ms_split(dense_setup, dense))
    log(f"[breakdown] {cfg.name} training step, T={h.shape[0]}, m={m}: "
        "host ms (median of 9, synced): "
        + ", ".join(f"{name} {ms}" for name, ms in row.items()))
    log(f"[breakdown] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


#: substrings of the hand-written kernels' names in a device trace
HAND_KERNELS = ("zstats", "block_scores", "leaf_scores", "fused_lse",
                "fused_bwd", "rff_features", "pair_masses", "member_scores",
                "flash_mma", "dkv_wgmma", "dq_wgmma", "dkv_kernel", "dq_kernel")


def phase_profile(cfg, state, steps: int = 3, batches=None,
                  opt=None) -> None:
    """Device time by kernel over ``steps`` training steps (torch.profiler,
    device activities only).  The busy time is the union of the device
    intervals; the host wall of the same steps is taken once traced and
    once untraced, and the busy share is given against each.  ``batches``
    defaults to ``steps`` fresh youtube-dnn batches of TRAIN_BATCH;
    ``opt`` (the state's optimizer) to AdamW."""
    opt = opt or make_optimizer("adamw", 1e-2, weight_decay=0.0)
    train_step = step.make_train_step(cfg, None, opt)
    if batches is None:
        data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=3000,
                                  device=DEV)
        batches = [next(data) for _ in range(steps)]
    gen = torch.Generator(DEV).manual_seed(13)

    def run(st):
        t0 = time.perf_counter()
        for b in batches:
            st, _ = train_step(st, b, gen)
        torch.cuda.synchronize()
        return st, (time.perf_counter() - t0) * 1e6

    state, _ = train_step(state, batches[0], gen)
    state, untraced_us = run(state)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, wall_us = run(state)
    events = device_events(prof)
    busy = busy_us(events)
    log(f"[profile] {cfg.name} {cfg.sampler}, {len(batches)} training "
        f"step(s): device busy "
        f"{busy:.0f} us (union of {len(events)} device activities); host "
        f"wall {wall_us:.0f} us traced ({100 * busy / wall_us:.1f}% busy), "
        f"{untraced_us:.0f} us untraced ({100 * busy / untraced_us:.1f}%)")
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    hand = [kv for kv in ranked[15:]
            if any(k in kv[0] for k in HAND_KERNELS)]
    for name, durs in ranked[:15] + hand:
        log(f"[profile]   {name[:70]}: {sum(durs):.0f} us over {len(durs)} "
            "calls")


# --- ptb-lstm training (the paper's own language model) -----------------------

#: Zaremba et al. 2014's "medium" setting (batch_size 20, num_steps 35):
#: T = 700 hidden states a step
PTB_BATCH = 20
PTB_SEQ = 35


def ptb_split_lists(ids: torch.Tensor, n: int, d: int) -> str:
    """How the fused backward's plan lays out this step's slots: lists of
    rows, slots a list, and the lists longer than one run (split, then
    folded)."""
    t, k = ids.shape
    pl = fused_head.plan(t, k, d, n)
    rows = pl.q * fused_head.TILE_ROWS
    per = torch.bincount(ids.reshape(-1).long() // rows,
                         minlength=pl.n_lists)
    split = int((per > pl.run).sum())
    runs = int((-(-per // pl.run)).sum())
    return (f"{pl.n_lists} lists of {rows} rows, run {pl.run}: slots a list "
            f"mean {float(per.float().mean()):.1f}, max {int(per.max())}; "
            f"{split} lists split, {runs} runs in all")


def ptb_step_check(cfg, state, batch, gen: torch.Generator
                   ) -> dict[str, dict]:
    """One ptb-lstm step of ``state`` on ``batch``, each kernel held against
    its plain version on that step's own inputs and timed there: the
    refresh's zstats over the head's 79 blocks (the last holds 16 real
    rows), the root's block_scores (T 700 x 79), leaf_scores over the
    89,600 drawn blocks (padding rows of the last block score exactly 1),
    the fused head on the step's gather plan (two calls bitwise equal);
    then the loss and every gradient at the step's fixed negatives through
    the kernels and through the plain path, each within RTOL of its plain
    value's largest entry.  Returns the kernels' rows."""
    sampler = sampler_from_config(cfg)
    m, alpha, bsz = cfg.m_negatives, cfg.sampler_alpha, cfg.sampler_block
    n, r = cfg.vocab_size, api.hidden_width(cfg)
    head = api.head_table(state.params, cfg).detach()
    rows: dict[str, dict] = {}
    with torch.no_grad():
        sstate = step.make_refresh_fn(cfg)(head, state.sampler_state)
        runtime = sampler.hydrate(sstate, n)
        st = runtime["stats"]
        w, z, cnt = st.wq, st.z, st.cnt
        nb = w.shape[0]
        err = compare(f"ptb zstats ({nb}, {bsz}, {r}), the refresh's", z,
                      ref.zstats_ref(w))
        bms, by = bound_ms(4 * (nb * bsz * r + nb * r * r),
                           nb * bsz * r * (r + 1))
        wt = w.transpose(1, 2)
        rows["zstats"] = dict(
            max_abs_err=err, bound_ms=bms, bound_by=by,
            **times(lambda: zstats(w), lambda: ref.zstats_ref(w),
                    lambda: torch.bmm(wt, w)))

        h, labels, _ = api.backbone_hidden(state.params, batch, cfg)
        hq = hierarchy.project(h, runtime["proj"]).contiguous()
        t = hq.shape[0]
        err = compare(f"ptb block_scores root T={t} N={nb}",
                      block_scores(hq, z, cnt, alpha=alpha),
                      ref.block_scores_ref(hq, z, cnt, alpha))
        bms, by = bound_ms(4 * (t * r + nb * r * r + nb + t * nb),
                           2 * t * nb * (r * r + r))
        log_plans("ptb root", t, [nb], r)
        rows["block_scores"] = dict(
            max_abs_err=err, bound_ms=bms, bound_by=by,
            **times(lambda: block_scores(hq, z, cnt, alpha=alpha),
                    lambda: ref.block_scores_ref(hq, z, cnt, alpha),
                    lambda: torch.einsum("nij,ti,tj->tn", z, hq, hq)))

        neg, logq = sampler.sample_batch(runtime, h, m, gen)
        blk = torch.div(neg.reshape(-1), bsz, rounding_mode="floor")
        blk[::97] = nb - 1  # the last block, 16 real rows, present
        gathered = w[blk]
        hg = hq.repeat_interleave(m, dim=0)
        g = hg.shape[0]
        got = leaf_scores(hg, gathered, alpha=alpha)
        want = ref.leaf_scores_ref(hg, gathered, alpha)
        err = compare(f"ptb leaf_scores ({g}, {bsz}, {r})", got, want)
        pad = (blk[:, None] * bsz + torch.arange(bsz, device=DEV)) >= n
        if not (bool((got[pad] == 1.0).all())
                and bool((want[pad] == 1.0).all())):
            raise AssertionError("ptb leaf_scores: a padding row of the "
                                 "last block does not score exactly 1")
        log(f"  ptb leaf_scores: {int(pad.sum())} padding-row scores, all "
            "exactly 1 in both")
        del got, want, pad
        h3 = hg[:, :, None]
        bms, by = bound_ms(4 * (g * r + g * bsz * r + g * bsz),
                           g * bsz * (2 * r + 2))
        rows["leaf_scores"] = dict(
            max_abs_err=err, bound_ms=bms, bound_by=by,
            **times(lambda: leaf_scores(hg, gathered, alpha=alpha),
                    lambda: ref.leaf_scores_ref(hg, gathered, alpha),
                    lambda: torch.bmm(gathered, h3)))
        del gathered, hg, h3, wt
        torch.cuda.empty_cache()

        ids, corr = fused_plan(labels, neg, logq)
        ids = ids.to(torch.int32)
        biasg = torch.zeros(ids.shape, device=DEV)
        log(f"[ptb] fused backward's plan at T {t}, K {ids.shape[1]}, n "
            f"{n}, d {r}: {ptb_split_lists(ids, n, r)}")
        h32 = h.contiguous()
        errs = check_fused(f"ptb-lstm step T={t} K={ids.shape[1]} n={n} "
                           f"d={r}", gen, head, h32, ids, corr, biasg,
                           cfg.abs_softmax)
        rows.update(fused_rows("ptb-lstm step", head, h32, ids, corr, biasg,
                               errs))

    # the step's loss and gradients at these negatives: kernels vs plain
    est = estimators.make_estimator(cfg.estimator)
    params = dict(state.params.named_parameters())

    def loss_grads(impl):
        for p_ in params.values():
            p_.grad = None
        hh, lab, _ = api.backbone_hidden(state.params, batch, cfg)
        loss = torch.mean(estimators.loss_from_embeddings(
            est, api.head_table(state.params, cfg), hh, lab, neg, logq,
            abs_mode=cfg.abs_softmax, impl=impl))
        loss.backward()
        return loss.detach(), {k: p_.grad.clone() for k, p_ in
                               params.items()}

    before = kernels.launch_counts()
    loss_k, grads_k = loss_grads(cfg.head_impl)
    after = kernels.launch_counts()
    if (after["fused_lse"] - before["fused_lse"],
            after["fused_lse_bwd"] - before["fused_lse_bwd"]) != (1, 1):
        raise AssertionError("ptb step check: the kernel step did not "
                             "launch the fused head once each way")
    loss_p, grads_p = loss_grads("chunked")
    compare("ptb step loss at fixed negatives, kernels vs plain",
            loss_k[None], loss_p[None])
    for name in params:
        compare(f"ptb step grad {name}", grads_k[name], grads_p[name])
    for p_ in params.values():
        p_.grad = None
    log(f"[ptb] step at fixed negatives: loss {float(loss_k)} (kernels) vs "
        f"{float(loss_p)} (plain)")
    return rows


def phase_ptb(gen: torch.Generator
              ) -> tuple[dict[str, int], dict[str, dict]]:
    """ptb-lstm at full width through fit: vocab 10,000, 2 LSTM layers of
    200, block-quadratic over 79 blocks of 128, m = 128, abs mode, fp32,
    batch 20 x 35 (T = 700): TRAIN_STEPS steps on a cycled pool of
    TRAIN_POOL batches with exact launch counts, a finite loss at every
    step that falls, peak memory; then a step of the trained state held
    against its plain kernels (``ptb_step_check``), the step's stages and a
    profile of three steps.  Returns the counts and the kernels' rows at
    the ptb shapes."""
    cfg = get_config("ptb-lstm")
    data = batch_iterator_for(cfg, None, PTB_BATCH, PTB_SEQ, seed=0,
                              device=DEV)
    pool = [next(data) for _ in range(TRAIN_POOL)]
    held = next(batch_iterator_for(cfg, None, PTB_BATCH, PTB_SEQ, seed=1000,
                                   device=DEV))
    floor = SyntheticLM(cfg.vocab_size, seed=0, device=str(DEV)).chain_entropy()
    init = step.init_train_state(
        torch.Generator(DEV).manual_seed(0), cfg, None,
        make_optimizer("adamw", 1e-2, weight_decay=0.0), device=DEV)
    before = eval_loss(init, cfg, held)
    del init
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res, first, last = run_fit(cfg, itertools.cycle(pool),
                               f"pool of {TRAIN_POOL} batches",
                               f"batch {PTB_BATCH} x {PTB_SEQ}")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[ptb] launches {counts}; peak device memory of the run "
        f"{peak / 2**30:.2f} GiB")
    want = expected_launches(cfg)
    if counts != want:
        raise AssertionError(f"ptb-lstm launches {counts} != {want}")
    if not all(math.isfinite(x) for x in res.losses) or not last < first:
        raise AssertionError(f"ptb-lstm: loss not finite at every step or "
                             f"did not fall: {first} -> {last}")
    log(f"[ptb] held-out full-softmax loss (batch {PTB_BATCH} x {PTB_SEQ})"
        f": before {before}, after the pool {eval_loss(res.state, cfg, held)}"
        f"; the chain's entropy {floor}; ln(n) = {math.log(cfg.vocab_size)}")
    rows = ptb_step_check(cfg, res.state, pool[0], gen)
    phase_training_breakdown(cfg, res.state, pool[1])
    phase_profile(cfg, res.state, batches=pool[2:5])
    return counts, rows


# --- the facade, the sparse refresh, checkpoint/restart, the island ---------

#: the facade's sampler families (phase 13)
FACADE_FAMILIES = ("block-quadratic",) + FAMILIES
#: the families with a Fig. 1b sparse refresh (phase 14)
SPARSE_FAMILIES = ("block-quadratic", "tree-quadratic", "rff")
#: phase 15: runs of CKPT_STEPS steps saved every CKPT_EVERY; the second is
#: killed at CKPT_KILL and relaunched
CKPT_STEPS, CKPT_EVERY, CKPT_KILL = 40, 10, 25
#: phase 16: steps of each overlap run; the families it runs
OVERLAP_STEPS = 40
OVERLAP_FAMILIES = ("block-quadratic", "midx")
#: phase 16's timed steps per mode
OVERLAP_TIMED = 20


def counted(fn):
    """(fn(), the kernel launches it made, the nonzero counts only)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernels.launch_counts().items() if v}


def check_launches(tag: str, got: dict[str, int], want: dict[str, int]
                   ) -> None:
    want = {k: v for k, v in want.items() if v}
    if got != want:
        raise AssertionError(f"{tag}: launches {got} != {want}")


def check_bitwise(tag: str, got: dict, want: dict) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{tag}: keys {sorted(got)} != {sorted(want)}")
    for k, v in want.items():
        if not torch.equal(got[k], v):
            raise AssertionError(f"{tag}: {k} differs")


def add_counts(total: dict[str, int], got: dict[str, int]) -> None:
    for k, v in got.items():
        total[k] += v


def facade_inputs(cfg):
    """The facade's inputs at full width: a seeded youtube-dnn model, its
    head (100,000 x 128), the tower's h of one batch of TRAIN_BATCH and
    the batch's labels."""
    model = api.init_params(cfg, torch.Generator(DEV).manual_seed(3),
                            device=DEV)
    batch = next(batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=4000,
                                    device=DEV))
    with torch.no_grad():
        h, labels, _ = api.backbone_hidden(model, batch, cfg)
    return api.head_table(model, cfg).detach(), h, labels


def phase_facade(cfg) -> dict[str, int]:
    """SoftmaxHead at full width with each kernel family: init and
    refresh equal make_refresh_fn bitwise, sample's logq equals
    all_class_logq within 1e-4, loss and its backward equal
    local_sampled_loss from the same generator seed bitwise, the full and
    nce estimators run, and every call launches exactly its kernels; then
    export_index + decode_topk at full beam equal the dense top-k, ties
    aside, with the launches of the retrieval calls they wrap.  Returns
    the phase's launches."""
    w, h, labels = facade_inputs(cfg)
    total = dict.fromkeys(REPLACES, 0)
    for family in FACADE_FAMILIES:
        fcfg = dataclasses.replace(cfg, sampler=family)
        head = SoftmaxHead(fcfg)
        refresh, sample = sampler_launches(fcfg)
        fused = dict(sample, fused_lse=1, fused_lse_bwd=1)

        def gen(seed):
            return torch.Generator(DEV).manual_seed(seed)

        init, got = counted(lambda: head.init(gen(21), w))
        check_launches(f"{family} init", got, refresh)
        add_counts(total, got)
        state, got = counted(lambda: head.refresh(init, w))
        check_launches(f"{family} refresh", got, refresh)
        add_counts(total, got)
        want = step.make_refresh_fn(fcfg)(w, init)
        check_bitwise(f"{family} init", init.stats, want.stats)
        check_bitwise(f"{family} refresh", state.stats, want.stats)

        (ids, logq), got = counted(lambda: head.sample(state, h, gen(5)))
        check_launches(f"{family} sample", got, sample)
        add_counts(total, got)
        check_draw_logq(fcfg, types.SimpleNamespace(sampler_state=state),
                        None, draws=(h[:4], ids[:4], logq[:4]))

        wp = w.clone().requires_grad_()

        def loss_and_grad(fn):
            loss = fn()
            loss.mean().backward()
            grad, wp.grad = wp.grad, None
            return loss.detach(), grad

        (loss, grad), got = counted(lambda: loss_and_grad(
            lambda: head.loss(wp, h, labels, state=state, key=gen(7))))
        check_launches(f"{family} loss", got, fused)
        add_counts(total, got)
        want_loss, want_grad = loss_and_grad(
            lambda: estimators.local_sampled_loss(
                head.estimator, head.sampler, wp, h, labels, state,
                fcfg.m_negatives, gen(7), n_valid=fcfg.vocab_size,
                abs_mode=fcfg.abs_softmax, impl=fcfg.head_impl))
        check_bitwise(f"{family} loss", {"loss": loss, "dL/dw": grad},
                      {"loss": want_loss, "dL/dw": want_grad})

        others = {}
        for est, launches in (("full", {}), ("nce", sample)):
            other = SoftmaxHead(dataclasses.replace(fcfg, estimator=est))
            out, got = counted(lambda: other.loss(w, h, labels, state=state,
                                                  key=gen(9)))
            check_launches(f"{family} {est}", got, launches)
            add_counts(total, got)
            if not torch.isfinite(out).all():
                raise AssertionError(f"{family}: {est} loss not finite")
            others[est] = float(out.mean())
        log(f"[facade] {family}: init and refresh equal make_refresh_fn "
            f"bitwise; loss and dL/dw equal local_sampled_loss bitwise "
            f"(mean {float(loss.mean())}); full {others['full']}, nce "
            f"{others['nce']}; launches per call exact (refresh {refresh}, "
            f"sample {sample}, loss {fused})")

    head = SoftmaxHead(cfg)
    index, built = counted(lambda: head.export_index(w))
    direct, want = counted(lambda: retrieval.build_index(
        w, vocab_size=cfg.vocab_size))
    check_launches("export_index", built, want)
    add_counts(total, built)
    hq = h[:16]
    (ids, logits), got = counted(lambda: head.decode_topk(w, hq, 10,
                                                          index=index))
    _, want = counted(lambda: retrieval.decode_topk(direct, hq, 10))
    check_launches("decode_topk", got, want)
    add_counts(total, got)
    dids, dlog = head.decode_topk(w, hq, 11)
    if not torch.allclose(logits, dlog[:, :10], rtol=1e-5, atol=0.0):
        raise AssertionError("facade full-beam logits differ from the dense "
                             "top-k")
    swaps = check_topk_ties("facade decode_topk", ids, dids, dlog, 10)
    log(f"[facade] export_index launches {built}; full-beam decode_topk "
        f"of 16 queries equals the dense top-10 ({swaps} tie swaps), "
        f"launches {got}; phase launches "
        f"{ {k: v for k, v in total.items() if v} }")
    return total


def stats_tensors(stats) -> dict[str, torch.Tensor]:
    """Every tensor of a runtime statistics object, by field (and level)."""
    out = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, tuple):
            out.update({f"{f.name}[{i}]": x for i, x in enumerate(v)})
        elif isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


def phase_sparse(cfg) -> None:
    """The Fig. 1b sparse refresh at full width: the k unique labels of one
    batch get new rows, and each family's update_rows equals a full
    rebuild after the same write within rtol = atol = 1e-4 (wq and the
    counts bitwise; rff's features up to the rebuild's re-derived shift);
    host and device ms of both, not gated."""
    w, _, labels = facade_inputs(cfg)
    ids = torch.unique(labels)
    g = torch.Generator(DEV).manual_seed(31)
    w_new = w[ids] + 0.05 * torch.randn((ids.numel(), w.shape[1]),
                                        generator=g, device=DEV)
    w2 = w.clone()
    w2[ids] = w_new
    for family in SPARSE_FAMILIES:
        fcfg = dataclasses.replace(cfg, sampler=family)
        head = SoftmaxHead(fcfg)
        sampler = head.sampler
        state = head.init(torch.Generator(DEV).manual_seed(21), w)
        runtime = sampler.hydrate(state, cfg.vocab_size)

        def sparse():
            return sampler.update_rows(runtime, ids, w_new)

        upd = sparse()["stats"]
        full = sampler.hydrate(head.refresh(state, w2),
                               cfg.vocab_size)["stats"]
        got, want = stats_tensors(upd), stats_tensors(full)
        scale = (torch.exp(full.logshift - upd.logshift)
                 if family == "rff" else 1.0)
        worst = 0.0
        for k, v in want.items():
            if k == "logshift":
                continue
            if k == "wq" or "cnt" in k or k == "n_valid":
                if not torch.equal(got[k], v):
                    raise AssertionError(f"sparse {family}: {k} differs "
                                         "from the rebuild")
                continue
            mine = got[k] / scale if k.startswith("levels_f") else got[k]
            worst = max(worst, float((mine - v).abs().max()))
            if not torch.allclose(mine, v, rtol=1e-4, atol=1e-4):
                raise AssertionError(
                    f"sparse {family}: {k} differs from the rebuild beyond "
                    f"rtol = atol = 1e-4 (max |err| "
                    f"{float((mine - v).abs().max())})")
        row = dict(sparse_host_ms=host_ms(sparse),
                   sparse_device_ms=device_ms(sparse),
                   full_host_ms=host_ms(lambda: head.refresh(state, w2)),
                   full_device_ms=device_ms(lambda: head.refresh(state, w2)))
        log(f"[sparse] {family}: {ids.numel()} rows rewritten; update_rows "
            f"equals the full rebuild (max |err| {worst}; wq and counts "
            f"bitwise); " + ", ".join(f"{k} {v}" for k, v in row.items()))


def ckpt_bytes(state) -> int:
    """Bytes of a train state's arrays as the checkpoint stores them."""
    return sum(t.numel() * t.element_size() for _, t in
               ckpt_manager._leaves(ckpt_manager._reference_form(state)))


def phase_checkpoint(cfg) -> dict[str, int]:
    """Checkpoint/restart at full width: fit CKPT_STEPS steps saving every
    CKPT_EVERY, and the same run killed at CKPT_KILL and relaunched; the
    relaunch restores step 20, every restored leaf bitwise what was
    saved, and its losses equal the uninterrupted run's (bitwise when the
    two runs saved bitwise equal step-20 states, else within 1e-3
    relative); serving_index_source serves the last step with the
    decode of export_retrieval_index, and a second poll returns None;
    checkpoint bytes and save ms; a ptb-lstm state round-trips bitwise.
    Returns the fits' launches."""
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)

    def run(name, fail_at=None):
        data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=0,
                                  device=DEV)
        return loop.fit(cfg, None, opt, data, CKPT_STEPS,
                        checkpoint_dir=str(root / name),
                        checkpoint_every=CKPT_EVERY, fail_at_step=fail_at,
                        log_every=0, device=DEV)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res_a = run("a")
    try:
        run("b", CKPT_KILL)
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    else:
        raise AssertionError("fail_at_step did not stop the run")
    res_b = run("b")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    resumed = CKPT_STEPS - 2 * CKPT_EVERY
    steps = CKPT_STEPS + CKPT_KILL + resumed
    check_launches("checkpoint runs", {k: v for k, v in counts.items() if v},
                   expected_launches(cfg, steps, refreshes=steps + 3))
    if res_b.restored_from != 2 * CKPT_EVERY:
        raise AssertionError(f"relaunch restored {res_b.restored_from}, not "
                             f"{2 * CKPT_EVERY}")

    like = step.abstract_train_state(cfg, None, opt)
    restored, _ = CheckpointManager(str(root / "b")).restore(
        like=like, step=2 * CKPT_EVERY, device=DEV)
    got = ckpt_manager._flatten(restored)
    same_runs = True
    for run_dir, base in (("b", True), ("a", False)):
        path = root / run_dir / f"step_{2 * CKPT_EVERY:08d}" / "arrays.npz"
        with np.load(path) as saved:
            if sorted(saved.files) != sorted(got):
                raise AssertionError("restored keys differ from the saved")
            for k in saved.files:
                equal = np.array_equal(saved[k], got[k])
                if base and not equal:
                    raise AssertionError(f"restored {k} is not bitwise what "
                                         "was saved")
                same_runs &= equal
    tail = res_a.losses[-resumed:]
    diff = max(abs(a - b) / abs(a) for a, b in zip(tail, res_b.losses))
    log(f"[checkpoint] youtube-dnn {CKPT_STEPS} steps saving every "
        f"{CKPT_EVERY}, killed at {CKPT_KILL} and relaunched: "
        f"{wall:.3f} s for the three runs; restored_from "
        f"{res_b.restored_from}; restored leaves bitwise equal to the saved "
        f"({len(got)} arrays); the two runs' step-{2 * CKPT_EVERY} states "
        f"bitwise equal: {same_runs}; resumed losses vs uninterrupted: "
        f"bitwise {tail == res_b.losses}, max relative diff {diff}; "
        f"launches {counts}")
    if same_runs and tail != res_b.losses:
        raise AssertionError("deterministic runs, yet the resumed losses "
                             "differ from the uninterrupted run's")
    if diff > 1e-3:
        raise AssertionError(f"resumed losses differ by {diff} > 1e-3")

    poll = step.serving_index_source(str(root / "a"), cfg, None, opt,
                                     device=DEV)
    t0 = time.perf_counter()
    index, served = poll()
    torch.cuda.synchronize()
    poll_s = time.perf_counter() - t0
    if served != CKPT_STEPS or poll() is not None:
        raise AssertionError(f"serving_index_source served {served} then "
                             "something again")
    want = step.export_retrieval_index(res_a.state, cfg, None)
    hq = facade_inputs(cfg)[1][:16]
    ids, logits = retrieval.decode_topk(index, hq, 10)
    wids, wlogits = retrieval.decode_topk(want, hq, 10)
    if not torch.equal(ids, wids) or not torch.allclose(
            logits, wlogits, rtol=1e-6, atol=0.0):
        raise AssertionError("the served index decodes differently from "
                             "export_retrieval_index's")

    mgr = CheckpointManager(str(root / "timing"), keep=1)
    blocking, writer = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(i, res_a.state, extra={"step": i})
        t1 = time.perf_counter()
        mgr.wait()
        blocking.append((t1 - t0) * 1e3)
        writer.append((time.perf_counter() - t1) * 1e3)
    file_bytes = os.path.getsize(root / "timing" / "step_00000002" /
                                 "arrays.npz")

    pcfg = get_config("ptb-lstm")
    pstate = step.init_train_state(torch.Generator(DEV).manual_seed(0), pcfg,
                                   None, opt, device=DEV)
    pmgr = CheckpointManager(str(root / "ptb"))
    pmgr.save(0, pstate, blocking=True)
    back, _ = pmgr.restore(like=step.abstract_train_state(pcfg, None, opt),
                           device=DEV)
    pwant, pgot = ckpt_manager._flatten(pstate), ckpt_manager._flatten(back)
    if sorted(pwant) != sorted(pgot) or not all(
            np.array_equal(pwant[k], pgot[k]) for k in pwant):
        raise AssertionError("the ptb-lstm state does not round-trip")
    log(f"[checkpoint] serving_index_source served step {served} in "
        f"{poll_s:.3f} s (restore on the card + index build); its full-beam "
        f"decode of 16 queries equals export_retrieval_index's (bitwise: "
        f"{torch.equal(logits, wlogits)}); a second poll returned None")
    log(f"[checkpoint] youtube-dnn state {ckpt_bytes(res_a.state)} bytes of "
        f"arrays ({file_bytes} bytes of arrays.npz); save blocking ms "
        f"{blocking}, writer ms (npz + fsyncs + rename) {writer}; ptb-lstm "
        f"state of {ckpt_bytes(pstate)} bytes round-trips bitwise "
        f"({len(pwant)} arrays)")
    shutil.rmtree(root, ignore_errors=True)
    return counts


def sawtooth(steps: int) -> list[int]:
    """The staleness the reference's island reports at cadence 4, k 2:
    0, 1, 2, 3, then 4, 5, 2, 3 repeated."""
    return [i if i < 4 else (4, 5, 2, 3)[i % 4] for i in range(steps)]


def overlap_cfg(cfg, family: str, cadence: int, k: int):
    return dataclasses.replace(cfg, sampler=family, refresh_mode="overlap",
                               sampler_refresh_every=cadence,
                               refresh_stale_steps=k)


def check_swap(ocfg, pool) -> None:
    """Drive the island by hand: the statistics it swaps in at step 2 are
    bitwise those of make_refresh_fn on the main stream from the same
    snapshots it dispatched at step 0."""
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    state = step.init_train_state(torch.Generator(DEV).manual_seed(0), ocfg,
                                  None, opt, device=DEV)
    step_fn = step.make_train_step(ocfg, None, opt)
    island = loop.RefreshIsland(ocfg, None, DEV)
    state = island.prime(state)
    for i in range(ocfg.refresh_stale_steps + 1):
        state, _ = island.before_step(i, state)
        if i == 0:
            _, head, snap, new, _ = island._inflight
        state, _ = step_fn(state, pool[i], loop.step_generator(0, i, DEV))
    torch.cuda.synchronize()
    if state.sampler_state is not new:
        raise AssertionError("the island did not swap its rebuild in")
    want = step.make_refresh_fn(ocfg)(head, snap)
    check_bitwise(f"{ocfg.sampler} swap", new.stats, want.stats)


def overlap_timing(cfg, family: str, pool) -> dict[str, dict[str, float]]:
    """Per mode (sync, overlap) at cadence 1, k 1: host ms per step to
    enqueue OVERLAP_TIMED steps (the island's share of it apart), the wall
    ms per step once the device is done, the device busy ms per step
    (union of the device intervals, traced) and the busy share of the
    traced wall; then the refresh alone and ``thread_probe``."""
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    out = {}
    for mode in ("sync", "overlap"):
        c = dataclasses.replace(cfg, sampler=family, refresh_mode=mode,
                                sampler_refresh_every=1,
                                refresh_stale_steps=1)
        state = step.init_train_state(torch.Generator(DEV).manual_seed(0), c,
                                      None, opt, device=DEV)
        step_fn = step.make_train_step(c, None, opt)
        island = loop.RefreshIsland(c, None, DEV) if mode == "overlap" \
            else None
        if island is not None:
            state = island.prime(state)
        holder = {"state": state, "i": 0, "island_s": 0.0}
        gen = torch.Generator(DEV).manual_seed(13)

        def steps(n, rebuild=True):
            st = holder["state"]
            for _ in range(n):
                i = holder["i"]
                if island is not None and rebuild:
                    t0 = time.perf_counter()
                    st, _ = island.before_step(i, st)
                    holder["island_s"] += time.perf_counter() - t0
                st, _ = step_fn(st, pool[i % len(pool)], gen)
                holder["i"] = i + 1
            holder["state"] = st

        steps(3)
        torch.cuda.synchronize()
        holder["island_s"] = 0.0
        t0 = time.perf_counter()
        steps(OVERLAP_TIMED)
        host = (time.perf_counter() - t0) * 1e3 / OVERLAP_TIMED
        island_ms = holder["island_s"] * 1e3 / OVERLAP_TIMED
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / OVERLAP_TIMED
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(OVERLAP_TIMED)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3 / OVERLAP_TIMED
        busy = busy_us(device_events(prof)) / 1e3 / OVERLAP_TIMED
        out[mode] = dict(host_ms=host, wall_ms=wall, busy_ms=busy,
                         busy_share=busy / traced)
        if island is not None:
            out[mode]["island_host_ms"] = island_ms
    refresh = step.make_refresh_fn(c)
    head = api.head_table(holder["state"].params, c).detach().clone()
    sstate = holder["state"].sampler_state
    out["refresh"] = dict(host_ms=host_ms(lambda: refresh(head, sstate)),
                          device_ms=device_ms(lambda: refresh(head, sstate)))
    out["threads"] = thread_probe(refresh, head, sstate, steps)
    return out


def thread_probe(refresh, head, sstate, steps) -> dict[str, float]:
    """What a worker thread would hide: wall ms per step of OVERLAP_TIMED
    overlap-mode steps that rebuild nothing (``steps``), and of the same
    steps each beside one rebuild on a side stream, launched from the
    steps' thread (``inline``) or from a worker thread at the same time
    (``worker``).  A measurement for the island's design, not a path of
    the port."""
    side = torch.cuda.Stream(DEV)

    def rebuilds():
        with torch.cuda.stream(side):
            for _ in range(OVERLAP_TIMED):
                refresh(head, sstate)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / OVERLAP_TIMED

    def inline():
        for _ in range(OVERLAP_TIMED):
            with torch.cuda.stream(side):
                refresh(head, sstate)
            steps(1, rebuild=False)

    def worker():
        th = threading.Thread(target=rebuilds)
        th.start()
        steps(OVERLAP_TIMED, rebuild=False)
        th.join()

    return dict(steps=timed(lambda: steps(OVERLAP_TIMED, rebuild=False)),
                inline=timed(inline), worker=timed(worker))


def phase_overlap(cfg) -> dict[str, dict[str, int]]:
    """refresh_mode="overlap" at full width for block-quadratic and midx:
    fit OVERLAP_STEPS steps at cadence 4, k 2 with the reference's
    staleness sawtooth and swap count, finite and falling losses, the
    step's launches exact and the island's counted apart; a swap bitwise
    equal to a main-stream rebuild of the same snapshots; whether two runs
    are bitwise equal; step host ms, wall ms and busy share at cadence 1,
    k 1 against sync, beside the refresh's own host and device ms.
    Returns each run's launches."""
    data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=0, device=DEV)
    pool = [next(data) for _ in range(TRAIN_POOL)]
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    by_path = {}
    for family in OVERLAP_FAMILIES:
        ocfg = overlap_cfg(cfg, family, 4, 2)

        def run():
            return loop.fit(ocfg, None, opt, itertools.cycle(pool),
                            OVERLAP_STEPS, seed=0, log_every=0, device=DEV)

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res = run()
        counts = kernels.launch_counts()
        by_path[f"overlap {family}"] = counts
        swaps = sum(1 for i in range(OVERLAP_STEPS) if i % 4 == 2)
        if res.refresh_staleness != sawtooth(OVERLAP_STEPS) or \
                res.refresh_swaps != swaps:
            raise AssertionError(
                f"overlap {family}: staleness {res.refresh_staleness}, "
                f"swaps {res.refresh_swaps}; want {sawtooth(OVERLAP_STEPS)}"
                f", {swaps}")
        first = statistics.mean(res.losses[:10])
        last = statistics.mean(res.losses[-10:])
        if not all(math.isfinite(x) for x in res.losses) or not last < first:
            raise AssertionError(f"overlap {family}: loss did not fall: "
                                 f"{first} -> {last}")
        refresh, _ = sampler_launches(ocfg)
        dispatches = -(-OVERLAP_STEPS // 4)
        island = {k: n * (dispatches + 1) for k, n in refresh.items()}
        check_launches(f"overlap {family} island", {
            k: v for k, v in res.refresh_launches.items() if v}, island)
        check_launches(f"overlap {family} step", {
            k: v - res.refresh_launches[k] for k, v in counts.items()
            if v - res.refresh_launches[k]},
            expected_launches(ocfg, OVERLAP_STEPS, refreshes=1))
        check_swap(ocfg, pool)
        again = run()
        log(f"[overlap] {family} cadence 4, k 2, {OVERLAP_STEPS} steps: "
            f"staleness sawtooth and {swaps} swaps as the reference's; loss "
            f"mean of steps 0-9 {first}, of the last 10 {last}; island "
            f"launches {island}, step launches exact; the swap at step 2 "
            f"equals a main-stream rebuild of its snapshots bitwise; two "
            f"runs bitwise equal: {again.losses == res.losses}")
        timing = overlap_timing(cfg, family, pool)
        log(f"[overlap] {family} cadence 1, k 1, {OVERLAP_TIMED} steps: "
            + "; ".join(f"{mode} " + ", ".join(f"{k} {v}"
                                               for k, v in row.items())
                        for mode, row in timing.items()))
        hid = timing["sync"]["wall_ms"] - timing["overlap"]["wall_ms"]
        log(f"[overlap] {family}: overlap saves {hid} ms of wall a step "
            f"against sync; the refresh alone takes "
            f"{timing['refresh']['host_ms']} host ms, "
            f"{timing['refresh']['device_ms']} device ms")
    return by_path


# --- phase 17: the batch-shared sampler, tapas and the oracle samplers -------

#: phase 17's youtube-dnn families; the oracles among them
SAMPLER_FAMILIES = ("block-quadratic-shared", "tapas", "quadratic-oracle",
                    "softmax", "abs-softmax", "quartic-oracle", "rff-oracle",
                    "midx-oracle")
ORACLE_FAMILIES = SAMPLER_FAMILIES[2:]
#: phase 17's ptb-lstm families
PTB_SAMPLER_FAMILIES = ("block-quadratic-shared", "tapas")
#: the mega branch's draw count: the base config's m_negatives, past
#: 4 x 391 youtube-dnn blocks
MEGA_M = 2048
#: eq. 2 exactness of every draw's logq, and the tapas row spread
LOGQ_TOL = 1e-4


def held_queries(cfg, state, held, k: int = 4) -> torch.Tensor:
    """The hidden states of the first ``k`` held-out queries."""
    with torch.no_grad():
        h, _, _ = api.backbone_hidden(state.params, held, cfg)
    return h[:k].contiguous()


def dense_shared_logq(head, h, alpha: float, n: int, proj=None):
    """The batch-shared q in plain fp64, independent of the sampler's block
    statistics: q_i ∝ sum_p (alpha (h_p . w_i)^2 + 1) over the n live rows
    of the head, from one h @ W.T (both projected when the sampler is).
    Returns log q (n,)."""
    if proj is not None:
        h, head = h.float() @ proj.float().T, head.float() @ proj.float().T
    dots = h.double() @ head[:n].double().T
    s = torch.sum(alpha * dots.square() + 1.0, dim=0)
    return torch.log(s) - torch.log(s.sum())


def tapas_draw_check(sampler, runtime, head, h, m, gen, dense_q):
    """Tapas' draws for the queries h as ``sample_batch`` makes them (pool,
    then resample), held in fp64 against plain recomputations: the pool's
    base logq1 against ``dense_q`` (the shared base's plain log q); the
    composed logq against o_j - logsumexp over the pool's DISTINCT classes
    k of (o_k - log pi_k), with pi_k = 1 - (1 - q_k)^P from ``dense_q``;
    and, at tau = 1, o[ids] - logq constant along each row.  Returns (ids,
    logq, worst |logq - dense|, worst |logq1 - dense_q[pool]|, the largest
    row spread, the pool's top id)."""
    pool, lq1 = sampler.draw_pool(runtime, h, gen)
    ids, logq = sampler.resample_from_pool(runtime, pool, lq1, h, m, gen)
    worst_lq1 = float((lq1.double() - dense_q[pool]).abs().max())
    w64, h64 = head.double(), h.double()
    corrected = torch.einsum("td,tmd->tm", h64, w64[ids]) - logq.double()
    spread = float((corrected.amax(1) - corrected.amin(1)).max())
    distinct = torch.unique(pool)
    q = dense_q[distinct].exp()
    logpi = torch.log(-torch.expm1(sampler.pool * torch.log1p(-q)))
    lse = torch.logsumexp(h64 @ w64[distinct].T / sampler.tau - logpi,
                          dim=-1, keepdim=True)
    want = torch.einsum("td,tmd->tm", h64, w64[ids]) / sampler.tau - lse
    worst = float((logq.double() - want).abs().max())
    return ids, logq, worst, worst_lq1, spread, int(pool.max())


def check_sampler_logq(cfg, state, held) -> None:
    """The eq. 2 exactness contract for phase 17's families on 4 held-out
    queries: the logq of every draw equals the family's exact all-class
    log q at the drawn ids within LOGQ_TOL — the shared family's (m,) set
    against ``all_class_logq(shared=True)`` over the same 4 queries and
    against ``dense_shared_logq``, each oracle's (4, m) against its
    ``logq_all``, tapas by ``tapas_draw_check`` — and no id is at or past
    n_valid.  Carrying families are checked on statistics rebuilt from the
    current head, so that the plain sums read the same table."""
    sampler = sampler_from_config(cfg)
    gen = torch.Generator(DEV).manual_seed(17)
    n, m = cfg.vocab_size, cfg.m_negatives
    spread, top_pool, plain = 0.0, -1, 0.0
    with torch.no_grad():
        head = api.head_table(state.params, cfg).detach()
        h = held_queries(cfg, state, held)
        sstate = state.sampler_state
        if sampler.carries_state:
            sstate = sstate.replace_stats(
                sampler.build_stats(head, n, sstate.const))
        runtime = sampler.island_runtime(sstate, head, n)
        if sampler.shares_negatives or sampler.two_stage:
            base = sampler.base if sampler.two_stage else sampler
            base_rt = runtime["base"] if sampler.two_stage else runtime
            dense_q = dense_shared_logq(head, h, base.kernel.alpha, n,
                                        base_rt["proj"])
        if sampler.two_stage:
            ids, logq, worst, plain, spread, top_pool = tapas_draw_check(
                sampler, runtime, head, h, m, gen, dense_q)
        else:
            ids, logq = sampler.sample_batch(runtime, h, m, gen)
            if sampler.shares_negatives:
                want = sampler.all_class_logq(runtime, h)[ids]
                plain = float((logq.double() - dense_q[ids]).abs().max())
            else:
                want = torch.gather(sampler.logq_all(runtime, h), 1, ids)
            worst = float((logq - want).abs().max())
    top = max(int(ids.max()), top_pool)
    log(f"[{cfg.name} {cfg.sampler}] 4 held-out queries, draws "
        f"{tuple(ids.shape)}: max |logq - exact logq[ids]| = {worst}"
        + (f"; max |{'logq1' if sampler.two_stage else 'logq'} - plain "
           f"dense sum over h @ W.T| = {plain}"
           if sampler.shares_negatives or sampler.two_stage else "")
        + (f"; tau = 1 row spread of o - logq {spread}"
           if sampler.two_stage else "")
        + f"; max id {top} (n_valid {n})")
    if not torch.isfinite(logq).all() or top >= n:
        raise AssertionError(f"{cfg.sampler}: a draw has a non-finite logq "
                             "or an id past n_valid")
    if worst > LOGQ_TOL or plain > LOGQ_TOL or spread > LOGQ_TOL:
        raise AssertionError(f"{cfg.sampler}: logq off by {worst}, by "
                             f"{plain} from the plain dense sum, row "
                             f"spread {spread} (> {LOGQ_TOL})")


def phase_mega(cfg, state, held, gen: torch.Generator) -> None:
    """The shared sampler's mega branch at full width, on statistics rebuilt
    from the current head: MEGA_M draws for a held-out batch (391 blocks:
    mega from 1,564 draws on) against ``all_class_logq(shared=True)`` and
    ``dense_shared_logq`` within LOGQ_TOL, no id past n_valid;
    on the drawn blocks its within-block log-probabilities equal the
    per-draw branch's within RTOL; host ms of both draw counts."""
    sampler = sampler_from_config(cfg)
    n = cfg.vocab_size
    with torch.no_grad():
        head = api.head_table(state.params, cfg).detach()
        sstate = state.sampler_state.replace_stats(sampler.build_stats(
            head, n, state.sampler_state.const))
        rt = sampler.hydrate(sstate, n)
        st, proj, kernel = rt["stats"], rt["proj"], sampler.kernel
        h, _, _ = api.backbone_hidden(state.params, held, cfg)
        if not blocks.is_mega(st, MEGA_M) or blocks.is_mega(
                st, cfg.m_negatives):
            raise AssertionError("mega: the draw counts do not straddle "
                                 "the branch threshold")
        ids, logq = blocks.sample_shared(st, kernel, h, MEGA_M, gen, proj)
        oracle = blocks.all_class_logq(st, kernel, h, proj, shared=True)
        worst = float((logq - oracle[ids]).abs().max())
        plain = float((logq.double() - dense_shared_logq(
            head, h, kernel.alpha, n, proj)[ids]).abs().max())
        hh, t = blocks.shared_context(h, proj), h.shape[0]
        blk = torch.div(ids, st.block_size, rounding_mode="floor")
        mega, per = (torch.log_softmax(blocks.shared_within_logits(
            st, kernel, hh, t, blk, mega=flag), dim=-1)
            for flag in (True, False))
        same_inf = bool(torch.equal(torch.isinf(mega), torch.isinf(per)))
        live = torch.isfinite(per)
        branch = float((mega[live] - per[live]).abs().max())
        ms = {k: host_ms(lambda k=k: blocks.sample_shared(
            st, kernel, h, k, gen, proj)) for k in (cfg.m_negatives, MEGA_M)}
    log(f"[mega] shared sample at m = {MEGA_M} over {st.n_blocks} blocks, "
        f"T {t}: max |logq - all_class_logq[ids]| = {worst}, - the plain "
        f"dense sum over h @ W.T {plain}; max id "
        f"{int(ids.max())} (n_valid {n}); within-block log p, mega vs "
        f"per-draw branch on the {MEGA_M} drawn blocks: max |diff| "
        f"{branch}, -inf slots equal {same_inf}; host ms (median of 9, "
        f"synced): " + ", ".join(f"m {k} {v}" for k, v in ms.items()))
    if not torch.isfinite(logq).all() or int(ids.max()) >= n:
        raise AssertionError("mega: a non-finite logq or an id past n_valid")
    if (worst > LOGQ_TOL or plain > LOGQ_TOL or branch > RTOL
            or not same_inf):
        raise AssertionError(f"mega: logq off by {worst} (plain {plain}) "
                             f"or the branches "
                             f"differ by {branch} (-inf equal {same_inf})")


def phase_grad_bias() -> None:
    """``bench.bias_vs_samples.grad_bias`` on the card at the reference's
    arguments (n 256, d 12, 4 queries, 8,000 repetitions, m 16 and 64), its
    rows logged beside ``BENCH_grad_bias.json``'s (the reference's CPU run
    of its own draw of the problem); at each m softmax < quadratic-oracle <
    uniform and tapas < block-quadratic-shared in bias_linf."""
    t0 = time.perf_counter()
    rows = bias_vs_samples.grad_bias(device=DEV, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bench_path = Path(__file__).resolve().parent / "BENCH_grad_bias.json"
    bench = {(r["sampler"], r["m"]): r["bias_linf"]
             for r in json.loads(bench_path.read_text())["rows"]}
    for r in rows:
        log(f"[grad_bias] {r['sampler']:22s} m={r['m']:3d}: bias_linf "
            f"{r['bias_linf']} (mc se {r['mc_se_linf']}), bias_l2 "
            f"{r['bias_l2']}; BENCH_grad_bias.json's CPU row "
            f"{bench.get((r['sampler'], r['m']))}")
    log(f"[grad_bias] {len(rows)} rows in {wall:.3f} s")
    by = {(r["sampler"], r["m"]): r["bias_linf"] for r in rows}
    for m in sorted({r["m"] for r in rows}):
        if not (by[("softmax", m)] < by[("quadratic-oracle", m)]
                < by[("uniform", m)]):
            raise AssertionError(f"grad_bias m={m}: softmax < "
                                 "quadratic-oracle < uniform fails")
        if not by[("tapas", m)] < by[("block-quadratic-shared", m)]:
            raise AssertionError(f"grad_bias m={m}: tapas < "
                                 "block-quadratic-shared fails")


def phase_samplers(cfg, gen: torch.Generator) -> dict[str, dict[str, int]]:
    """Phase 17: the batch-shared sampler, tapas and the paper's oracle
    samplers through ``fit`` at full width.  (a) youtube-dnn, 60 steps on
    the pool per family in SAMPLER_FAMILIES (exact launches, falling loss,
    ``check_sampler_logq``), then host ms and busy share of the shared
    family's step beside block-quadratic's on the same state; (b) the mega
    branch (``phase_mega``); (c) ptb-lstm, 60 steps of the shared family
    and of tapas (its pool of 1,024 takes the mega branch over 79 blocks);
    (d) ``phase_grad_bias``.  Returns each run's launch counts."""
    t0 = time.perf_counter()
    by_path: dict[str, dict[str, int]] = {}
    held = held_out_batch(cfg)
    data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=0, device=DEV)
    pool = [next(data) for _ in range(TRAIN_POOL)]
    shared_state = None
    for family in SAMPLER_FAMILIES:
        fcfg = dataclasses.replace(cfg, sampler=family)
        by_path[f"samplers {family}"], fstate = phase_family(fcfg, pool,
                                                             held)
        if family == "block-quadratic-shared":
            shared_state = fstate
        del fstate
        torch.cuda.empty_cache()
    # the shared step beside the per-example one, on one state (the two
    # families carry the same block statistics)
    for family in ("block-quadratic", "block-quadratic-shared"):
        phase_family_breakdown(dataclasses.replace(cfg, sampler=family),
                               shared_state, steps=3)
    phase_mega(dataclasses.replace(cfg, sampler="block-quadratic-shared"),
               shared_state, held, gen)
    del shared_state, pool, held, data
    torch.cuda.empty_cache()

    pcfg = get_config("ptb-lstm")
    data = batch_iterator_for(pcfg, None, PTB_BATCH, PTB_SEQ, seed=0,
                              device=DEV)
    pool = [next(data) for _ in range(TRAIN_POOL)]
    held = next(batch_iterator_for(pcfg, None, PTB_BATCH, PTB_SEQ,
                                   seed=1000, device=DEV))
    for family in PTB_SAMPLER_FAMILIES:
        fcfg = dataclasses.replace(pcfg, sampler=family)
        by_path[f"ptb {family}"], fstate = phase_family(
            fcfg, pool, held, f"batch {PTB_BATCH} x {PTB_SEQ}")
        del fstate
        torch.cuda.empty_cache()
    del pool, held, data

    phase_grad_bias()
    log(f"[samplers] phase 17 in {time.perf_counter() - t0:.1f} s")
    return by_path


# --- llama3-8b serving (prefill -> KV-cache decode -> top-k) -------------------

#: the dense training path (phase 18): starcoder2-3b at full width and
#: DENSE_LAYERS of its 30 layers (since phase 24 joined the script: at 30
#: its checkpoint's save and restore, 31.8 GB, took ~150 s of the run's
#: 1,200; at 8 the whole script ran in 1,084.9 s on an H100 80GB HBM3 at
#: 700 W, and this phase took 66.2 s of it where 4 layers took 44.8 s),
#: 4 sequences of 1,024 tokens a step, a cycled pool of 4 batches
DENSE_ARCH = "starcoder2-3b"
DENSE_LAYERS = 8
DENSE_BATCH = 4
DENSE_SEQ = 1024
DENSE_STEPS = 30
DENSE_POOL = 4
#: the dense run checkpoints once, at its last step: a full-width save
#: of all 30 layers writes 31.8 GB (bf16 parameters and fp32 AdamW
#: moments; 4 layers, 6.9 GB), and the whole
#: script keeps its disk writes under 45 GiB, the most the H100 machines
#: it is run on accept (a run saving at steps 10 and 20 was ended there
#: during the second save)
DENSE_CKPT_EVERY = DENSE_STEPS
#: AdamW's learning rate of the dense run
DENSE_LR = 3e-4
#: device memory a training phase may leave allocated behind it (GB): its
#: train state, checkpoints and index must all be gone (a 3B model's
#: train state is 31.8 GB)
LEFTOVER_GB = 0.5
#: the int8 quantized index's payload over the bits-32 one's, at most: at
#: d = 3,072 a row is 3,072 int8 + a 4-byte scale + a 4-byte perm entry
#: against 4 x 3,072 + 8 bytes, 0.2505, plus the codebooks
INT8_PAYLOAD_RATIO = 0.26
LLAMA_BATCH = 4
LLAMA_PROMPT = 512
LLAMA_DECODE = 32
LLAMA_MAX_LEN = LLAMA_PROMPT + LLAMA_DECODE + 1
#: the flash kernel's bf16 tolerance, element by element: one bf16 ulp of
#: the element, at most 2^-7 x |plain|, plus RTOL x max|plain|.  Both
#: versions compute in fp32 from the same bf16 inputs and differ in
#: summation order by ~1e-6 (the fp32 cases' errors), which can move an
#: output across a bf16 rounding boundary: one ulp apart, never more.
BF16_ELEM_RTOL = 2.0 ** -7
#: decode-vs-forward tolerances on the final (RMS-normalized) hidden state
#: of llama3-8b in bf16.  The two runs multiply the same bf16 weights with
#: activations of M = 4 and M = 2,180 rows (different GEMM kernels,
#: different fp32 summation orders), so each of the 32 layers' bf16
#: outputs can round one ulp (2^-8 relative) apart, and 32 residual layers
#: carry those differences forward.  DECODE_RTOL bounds the worst element,
#: as a fraction of max |h_forward| (measured 0.125 / 4.97); DECODE_REL_RMS
#: bounds each step's RMS difference, as a fraction of h_forward's RMS,
#: at three times the 0.0175 measured on the H100.
DECODE_RTOL = 2.0 ** -3
DECODE_REL_RMS = 0.05
#: the same contract with the compute in fp32 (the bf16 weights cast per
#: use): only summation orders differ, ~2e-5 of max|h| and in relative RMS
#: through falcon-mamba-7b's 64 layers (an H100 80GB HBM3 at 700 W); 1e-3
#: keeps a 45x margin and sits far below any fault of the path (the
#: reference's padded state is 88% of max off)
FP32_DECODE_RTOL = 1e-3
FP32_DECODE_REL_RMS = 1e-3


def decode_rel_rms(cfg) -> float:
    """DECODE_REL_RMS for a model of ``cfg.n_layers`` residual layers: it
    was set for llama3-8b's 32, and each layer's one-ulp differences add
    on, so a deeper model's bound grows in proportion (falcon-mamba-7b's
    64 layers: 0.1)."""
    return DECODE_REL_RMS * max(1.0, cfg.n_layers / 32)


def attn_inputs(gen: torch.Generator, b: int, s: int, h: int, kv: int,
                hd: int, dtype: torch.dtype, hv: int | None = None,
                sk: int | None = None):
    """q (B, S, H, hd), k (B, Sk, KV, hd) and v (B, Sk, KV, hv; hv
    defaults to hd, Sk to S) of unit-variance entries, in the serving
    path's layout and dtype."""
    def draw(heads, width=hd, n=s):
        return torch.randn((b, n, heads, width), generator=gen, device=DEV
                           ).to(dtype)
    sk = sk or s
    return draw(h), draw(kv, n=sk), draw(kv, hv or hd, sk)


def flash_bound(b: int, s: int, h: int, kv: int, hd: int, causal: bool,
                dtype: torch.dtype, hv: int | None = None,
                sk: int | None = None) -> tuple[float, str, float]:
    """(bound_ms, bound_by, cuda_core_floor_ms) of one attention call:
    q, k, v read once, o written once; 2·(hd + hv) flops per (query, key)
    pair that the mask keeps (hv defaults to hd, the key length sk to s),
    at the inputs' peak rate (the bf16 tensor cores for bf16) and at the
    fp32 CUDA-core rate the kernel runs at."""
    hv, sk = hv or hd, sk or s
    esize = torch.finfo(dtype).bits // 8
    n_bytes = esize * (b * s * h * (hd + hv) + b * sk * kv * (hd + hv))
    pairs = s * (s + 1) // 2 if causal else s * sk
    flops = 2.0 * b * h * pairs * (hd + hv)
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    bms, by = bound_ms(n_bytes, flops, rate)
    return bms, by, flops / FP32_FLOPS_PER_S * 1e3


def flash_row(gen: torch.Generator, b: int, s: int,
              kernel=flash_attention, h: int = 32, kv: int = 8,
              timed: bool = True, dtype: torch.dtype = torch.bfloat16
              ) -> dict:
    """A flash kernel (the tensor-core one through ``flash_attention``'s
    dispatch, or ``flash_attention_simt``) at llama3-8b's heads (32 / 8,
    hd 128; or ``h`` / ``kv``), causal in ``dtype`` (bf16, or fp32 for
    the CUDA-core kernel): held against the plain version, then
    (``timed``) timed beside it and SDPA.  The call must launch the
    kernel's own entry point once and the other flash entry not at all."""
    hd = 128
    q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype)
    before = kernels.launch_counts()
    got = kernel(q, k, v)
    after = kernels.launch_counts()
    entry = kernel.__name__
    other = ({"flash_attention", "flash_attention_simt"} - {entry}).pop()
    if (after[entry] != before[entry] + 1
            or after[other] != before[other]):
        raise AssertionError(f"{entry} at hd {hd} in {dtype} did not "
                             f"launch its own entry point once")
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    err = compare(f"{entry} {tag} causal (B {b}, S {s}, H {h}, "
                  f"KV {kv}, hd {hd})", got,
                  ref.flash_attention_ref(q, k, v, causal=True),
                  **(dict(elem_rtol=BF16_ELEM_RTOL) if tag == "bf16"
                     else {}))
    if not timed:
        del q, k, v, got
        return {"max_abs_err": err}
    bms, by, floor = flash_bound(b, s, h, kv, hd, True, dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = dict(max_abs_err=err, bound_ms=bms, bound_by=by, **times(
        lambda: kernel(q, k, v),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))
    if kernel is flash_attention_simt:
        row["cuda_core_floor_ms"] = floor
    del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()
    return row


def flash_ragged_gates(gen: torch.Generator) -> tuple[float, float]:
    """Both flash kernels off llama's shape, causal and not, with an
    s_valid: ragged S (300 and 77), groups 1 and 4.  bf16 at hd 64 and
    128 goes through the tensor-core kernel (each element within
    BF16_ELEM_RTOL x |plain| + RTOL x max|plain|), fp32 at hd 33 to 256
    through the CUDA-core one (RTOL x max|plain|); the launch counts must
    show that.  Returns the worst bf16 and fp32 errors."""
    cases = {torch.bfloat16: ((2, 300, 4, 4, 128), (2, 300, 8, 2, 64),
                              (1, 77, 4, 1, 128), (1, 77, 2, 2, 64)),
             torch.float32: ((2, 300, 4, 4, 128), (2, 300, 8, 2, 64),
                             (1, 300, 4, 1, 256), (1, 77, 2, 2, 33))}
    errs = {}
    for dtype, shapes in cases.items():
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        rule = dict(elem_rtol=BF16_ELEM_RTOL) if tag == "bf16" else {}
        before = kernels.launch_counts()
        calls = 0
        err = 0.0
        for b, s, h, kv, hd in shapes:
            q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype)
            s_valid = 250 if s > 250 else 50
            for causal, sv in itertools.product((True, False),
                                                (None, s_valid)):
                calls += 1
                err = max(err, compare(
                    f"flash_attention {tag} causal={causal} s_valid={sv} "
                    f"(B {b}, S {s}, H {h}, KV {kv}, hd {hd})",
                    flash_attention(q, k, v, causal=causal, s_valid=sv),
                    ref.flash_attention_ref(q, k, v, causal=causal,
                                            s_valid=sv), **rule))
        after = kernels.launch_counts()
        took = {n: after[n] - before[n]
                for n in ("flash_attention", "flash_attention_simt")}
        want = ({"flash_attention": calls, "flash_attention_simt": 0}
                if tag == "bf16" else
                {"flash_attention": 0, "flash_attention_simt": calls})
        if took != want:
            raise AssertionError(f"{tag} flash launches {took} != {want}")
        errs[tag] = err
    return errs["bf16"], errs["fp32"]


def block_scores_wide_row(gen: torch.Generator) -> dict:
    """block_scores at llama3-8b's index width, r = 4,096 (past the 3,624
    its query tile once had to fit in shared memory), against its plain
    version: N = 8 Grams of 256 rows, T = 16 (one query tile) and 40 (a
    partial 64-query tile), alpha 1 and cnt 0 as the gram bound calls it,
    and alpha 100 with counts; N = 1 at T = 16 (512 row-and-column tiles
    of one node); two calls bitwise equal (no atomics: the tiles' partials
    are summed in a fixed order); timed at T = 16 beside its einsum."""
    n, r = 8, 4096
    z = ref.zstats_ref(0.05 * torch.randn((n, 256, r), generator=gen,
                                          device=DEV))
    cnt = torch.arange(1, n + 1, dtype=torch.float32, device=DEV)
    zero = torch.zeros(n, device=DEV)
    err = 0.0
    for t in (16, 40):
        h = torch.randn((t, r), generator=gen, device=DEV)
        for alpha, c in ((1.0, zero), (100.0, cnt)):
            err = max(err, compare(
                f"block_scores T={t} N={n} r={r} alpha={alpha}",
                block_scores(h, z, c, alpha=alpha),
                ref.block_scores_ref(h, z, c, alpha)))
    h = h[:16].contiguous()
    err = max(err, compare(f"block_scores T=16 N=1 r={r} alpha=100.0",
                           block_scores(h, z[:1], cnt[:1], alpha=100.0),
                           ref.block_scores_ref(h, z[:1], cnt[:1], 100.0)))
    first = block_scores(h, z, zero, alpha=1.0)
    if not torch.equal(first, block_scores(h, z, zero, alpha=1.0)):
        raise AssertionError("block_scores: two calls at r = 4,096 differ")
    log(f"[kernels] block_scores T=16 N={n} r={r}: two calls bitwise equal")
    log_plans(f"r={r} T=16", 16, [n], r)
    bms, by = bound_ms(4 * (16 * r + n * r * r + n + 16 * n),
                       2 * 16 * n * (r * r + r))
    row = dict(max_abs_err=err, bound_ms=bms, bound_by=by, **times(
        lambda: block_scores(h, z, zero, alpha=1.0),
        lambda: ref.block_scores_ref(h, z, zero, 1.0),
        lambda: torch.einsum("nij,ti,tj->tn", z, h, h)))
    del z
    torch.cuda.empty_cache()
    return row


def leaf_scores_wide_gates() -> float:
    """leaf_scores, both modes, at ragged shapes of llama3-8b's width
    against its plain version (inputs from a generator of their own): (3,
    4097, 4096) ends in a partial row chunk, and (5, 300, 4094) (r % 4 !=
    0) takes the scalar path.  Returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    err = 0.0
    for g, b, r in ((3, 4097, 4096), (5, 300, 4094)):
        h = torch.randn((g, r), generator=gen, device=DEV)
        rows = torch.randn((g, b, r), generator=gen, device=DEV)
        err = max(err, compare(f"leaf_scores dot ({g}, {b}, {r})",
                               leaf_scores(h, rows, square=False),
                               ref.leaf_dots_ref(h, rows)))
        err = max(err, compare(f"leaf_scores square ({g}, {b}, {r})",
                               leaf_scores(h, rows, alpha=100.0),
                               ref.leaf_scores_ref(h, rows, 100.0)))
    return err


def sampled_loss_inputs(gen: torch.Generator, t: int, m: int, d: int,
                        dtype: torch.dtype = torch.float32):
    """h (T, d), w_neg (m, d), logq (m,) a normalized log-proposal, and
    pos (T,) — kernel_bench.py's sampled-loss inputs, seeded."""
    h = (0.3 * torch.randn((t, d), generator=gen, device=DEV)).to(dtype)
    w = (0.3 * torch.randn((m, d), generator=gen, device=DEV)).to(dtype)
    logq = torch.log_softmax(torch.randn(m, generator=gen, device=DEV), 0)
    pos = torch.randn(t, generator=gen, device=DEV)
    return h, w, logq, pos


def sampled_loss_row(gen: torch.Generator, t: int, m: int, d: int,
                     dtype: torch.dtype = torch.float32) -> dict:
    """sampled_loss at (T, m, d) in ``dtype`` against its plain version,
    timed beside logsumexp over cat([pos, h w^T - logq - log m]); the
    bound counts bf16 work at the tensor-core rate."""
    h, w, logq, pos = sampled_loss_inputs(gen, t, m, d, dtype)
    err = compare(f"sampled_loss {str(dtype)[6:]} (T {t}, m {m}, d {d})",
                  sampled_loss(h, w, logq, pos, m_total=m),
                  ref.sampled_loss_ref(h, w, logq, pos, m))
    bms, by = bound_ms(h.element_size() * (t * d + m * d) + 4 * (m + 2 * t),
                       2.0 * t * m * d, BF16_FLOPS_PER_S
                       if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
    log_m = math.log(m)

    def library():
        return torch.logsumexp(torch.cat([pos[:, None],
                                          h @ w.T - logq - log_m], 1),
                               1) - pos

    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **times(
        lambda: sampled_loss(h, w, logq, pos, m_total=m),
        lambda: ref.sampled_loss_ref(h, w, logq, pos, m), library))


#: sampled_loss's entry run (phase 12): the hidden states of LLAMA_BATCH
#: sequences of LLAMA_PROMPT + LLAMA_DECODE tokens against 512 shared
#: negatives of llama3-8b's width
LLAMA_ENTRY = (LLAMA_BATCH * (LLAMA_PROMPT + LLAMA_DECODE), 512, 4096)


def sampled_loss_plan(t: int, m: int, d: int, dtype: torch.dtype,
                      route: str, split: bool | None = None,
                      aligned: bool = True):
    """sampled_loss's plan at (T, m, d, dtype), logged; raises unless it
    takes ``route`` and, where ``split`` is given, splits m (or not)."""
    p = kernels.sampled_loss.plan(t, m, d, dtype, aligned)
    log(f"[kernels] sampled_loss plan (T {t}, m {m}, d {d}, "
        f"{str(dtype)[6:]}{'' if aligned else ', unaligned'}): {tuple(p)}")
    if p.route != route or (split is not None and (p.splits > 1) != split):
        raise AssertionError(f"sampled_loss plan {tuple(p)}: not route "
                             f"{route}" + ("" if split is None else
                                           f" with split {split}"))
    return p


def sampled_loss_llama_row() -> dict:
    """sampled_loss at llama3-8b's width against its plain version (inputs
    from a generator of their own): timed at the entry run's shape
    (LLAMA_ENTRY, bf16, split over m) beside ``sampled_loss_row``'s
    library call, bound at the bf16 tensor-core rate; two calls there
    bitwise equal (the splits' partials are folded in a fixed order); the
    tensor-core route at ragged T and m (1,000 and 500 at d 4,096) and at
    d 136 (a partial 64-column chunk); the CUDA-core route in bf16 at d
    126 (d % 8 != 0) and at d 136 with h one element off 16-byte
    alignment; both routes unsplit at T 100, m 150 (the first kernel
    writes the loss); m_total 2,048 in these.  Each plan must take the
    route and the split named."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    t, m, d = LLAMA_ENTRY
    sampled_loss_plan(t, m, d, torch.bfloat16, "mma", split=True)
    row = sampled_loss_row(gen, t, m, d, torch.bfloat16)
    h, w, logq, pos = sampled_loss_inputs(gen, t, m, d, torch.bfloat16)
    first = sampled_loss(h, w, logq, pos, m_total=m)
    if not torch.equal(first, sampled_loss(h, w, logq, pos, m_total=m)):
        raise AssertionError("sampled_loss: two calls at llama's entry shape "
                             "differ")
    log(f"[kernels] sampled_loss (T {t}, m {m}, d {d}) bf16: two calls "
        "bitwise equal")
    err = 0.0
    for t, m, d, dtype, route, split in (
            (1000, 500, 4096, torch.bfloat16, "mma", True),
            (300, 200, 136, torch.bfloat16, "mma", True),
            (300, 200, 126, torch.bfloat16, "simt", True),
            (100, 150, 136, torch.bfloat16, "mma", False),
            (100, 150, 126, torch.bfloat16, "simt", False),
            (100, 150, 128, torch.float32, "simt", False)):
        h, w, logq, pos = sampled_loss_inputs(gen, t, m, d, dtype)
        sampled_loss_plan(t, m, d, dtype, route, split)
        err = max(err, compare(
            f"sampled_loss {str(dtype)[6:]} {route} (T {t}, m {m}, d {d}), "
            "m_total 2048", sampled_loss(h, w, logq, pos, m_total=2048),
            ref.sampled_loss_ref(h, w, logq, pos, 2048)))
    h, w, logq, pos = sampled_loss_inputs(gen, 300, 200, 136, torch.bfloat16)
    hu = torch.empty(h.numel() + 1, dtype=h.dtype, device=DEV)[1:].view(
        h.shape)
    hu.copy_(h)
    sampled_loss_plan(300, 200, 136, torch.bfloat16, "simt", aligned=False)
    err = max(err, compare(
        "sampled_loss bf16 simt (T 300, m 200, d 136), h unaligned, "
        "m_total 2048", sampled_loss(hu, w, logq, pos, m_total=2048),
        ref.sampled_loss_ref(h, w, logq, pos, 2048)))
    row["ragged_max_abs_err"] = err
    return row


def phase_kernels_llama(gen: torch.Generator
                        ) -> tuple[dict[str, dict], dict[str, dict]]:
    """flash_attention and sampled_loss against their plain versions:
    the tensor-core flash at the prefill's shape (B 4, S 512) and at (B 1,
    S 4096), both bf16 causal with llama3-8b's heads, and the CUDA-core
    flash at the prefill's shape (the kernel the tensor-core one replaced
    there); both with ragged S (``flash_ragged_gates``); sampled_loss at
    (T 1024, m 512, d 128), (T 256, m 128, d 128), ragged (T 1000, m 500)
    and in bf16, each split over m, and at llama3-8b's width
    (``sampled_loss_llama_row``); block_scores at r = 4,096; leaf_scores at
    wide ragged shapes.  Returns (rows at the prefill
    / kernel bench shapes, rows at the other shapes by tag)."""
    rows = {"flash_attention": flash_row(gen, LLAMA_BATCH, LLAMA_PROMPT),
            "flash_attention_simt": flash_row(gen, LLAMA_BATCH, LLAMA_PROMPT,
                                              flash_attention_simt)}
    shapes = {"long": {"flash_attention": flash_row(gen, 1, 4096)},
              "r4096": {"block_scores": block_scores_wide_row(gen),
                        "leaf_scores": {
                            "max_abs_err": leaf_scores_wide_gates()}}}
    err16, err32 = flash_ragged_gates(gen)
    rows["flash_attention"]["ragged_max_abs_err"] = err16
    rows["flash_attention_simt"]["fp32_max_abs_err"] = err32
    log(f"[kernels] flash_attention: max abs err bf16 "
        f"{rows['flash_attention']['max_abs_err']} (ragged {err16}); "
        f"flash_attention_simt: bf16 "
        f"{rows['flash_attention_simt']['max_abs_err']}, fp32 {err32}")

    sampled_loss_plan(1024, 512, 128, torch.float32, "simt", split=True)
    sampled_loss_plan(256, 128, 128, torch.float32, "simt", split=True)
    rows["sampled_loss"] = sampled_loss_row(gen, 1024, 512, 128)
    shapes["youtube"] = {"sampled_loss": sampled_loss_row(gen, 256, 128,
                                                          128)}
    shapes["llama_entry"] = {"sampled_loss": sampled_loss_llama_row()}
    h, w, logq, pos = sampled_loss_inputs(gen, 1000, 500, 128)
    err = compare("sampled_loss fp32 ragged (T 1000, m 500, d 128), "
                  "m_total 2048", sampled_loss(h, w, logq, pos,
                                               m_total=2048),
                  ref.sampled_loss_ref(h, w, logq, pos, 2048))
    h, w, logq, pos = sampled_loss_inputs(gen, 1024, 512, 128,
                                          torch.bfloat16)
    err = max(err, compare("sampled_loss bf16 (T 1024, m 512, d 128)",
                           sampled_loss(h, w, logq, pos, m_total=512),
                           ref.sampled_loss_ref(h, w, logq, pos, 512)))
    rows["sampled_loss"]["max_abs_err"] = max(
        err, rows["sampled_loss"]["max_abs_err"])
    log_rows("llama prefill / kernel-bench shapes", rows)
    log_rows("other shapes", {f"{n} ({t})": r for t, x in shapes.items()
                              for n, r in x.items() if "ms" in r})
    return rows, shapes


def timed_spectral(record: dict):
    """retrieval.spectral_stats wrapped to record its seconds (synced):
    the index build's eigh share."""
    inner = retrieval.spectral_stats

    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        record["spectral_s"] = time.perf_counter() - t0
        return out

    return inner, wrapped


def check_topk_ties(tag: str, ids, dids, dlog, k: int) -> int:
    """ids equal the dense top-k ids rank by rank, except where the dense
    logit at that rank ties (within 1e-5 relative) a neighbour.  Returns
    the number of tie swaps."""
    near = lambda a, b: abs(a - b) <= 1e-5 * abs(b)  # noqa: E731
    ids_c, dids_c, dlog_c = ids.cpu(), dids.cpu(), dlog.cpu().tolist()
    swaps = 0
    for t in range(ids_c.shape[0]):
        for j in range(k):
            if ids_c[t, j] == dids_c[t, j]:
                continue
            lt = dlog_c[t]
            if not (near(lt[j], lt[j - 1]) if j else False) and \
                    not near(lt[j], lt[j + 1]):
                raise AssertionError(
                    f"{tag}: id {int(ids_c[t, j])} != dense "
                    f"{int(dids_c[t, j])} at row {t} rank {j} without a tie")
            swaps += 1
    return swaps


def index_kernel_rows(index, h: torch.Tensor, tag: str = "llama3-8b"
                      ) -> dict[str, dict]:
    """zstats and leaf_scores held against their plain versions at the
    shapes an LM's serving main path gives them (llama3-8b's unless
    ``tag`` names another), and timed there: the leaf
    Grams that ``build_index`` took from zstats, and one more zstats call,
    against zstats_ref of the index's own (32, 4096, 4096) leaf table; then
    leaf_scores' dot mode on the full-beam leaf gather (every leaf for each
    of the T queries: G = 128 leaves of 4096 rows, r = 4096, h repeated per
    leaf as ``retrieval.leaf_topk`` does), at RTOL x max|plain|, and timed
    beside ``rows.sum()``, a plain streaming read of the same rows."""
    wq = index.wq
    nb, b, r = wq.shape
    want = ref.zstats_ref(wq)
    err = compare(f"zstats ({nb}, {b}, {r}) leaf Grams of build_index",
                  retrieval.index_stats(index).levels_z[-1], want)
    err = max(err, compare(f"zstats ({nb}, {b}, {r})", zstats(wq), want))
    del want
    torch.cuda.empty_cache()
    wt = wq.transpose(1, 2)
    bms, by = bound_ms(4 * (nb * b * r + nb * r * r), nb * b * r * (r + 1))
    out = {"zstats": dict(max_abs_err=err, bound_ms=bms, bound_by=by, **times(
        lambda: zstats(wq), lambda: ref.zstats_ref(wq),
        lambda: torch.bmm(wt, wq), reps=3, calls=1))}
    torch.cuda.empty_cache()

    g = h.shape[0] * nb
    rows = wq.repeat(h.shape[0], 1, 1)  # (G, leaf, r), 8.6 GB at llama
    hg = torch.repeat_interleave(h.float(), nb, dim=0)
    err = compare(f"leaf_scores dot full beam ({g}, {b}, {r})",
                  leaf_scores(hg, rows, square=False),
                  ref.leaf_dots_ref(hg, rows))
    h3 = hg[:, :, None]
    bms, by = bound_ms(4 * (g * r + g * b * r + g * b), 2 * g * b * r)
    out["leaf_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: leaf_scores(hg, rows, square=False),
                lambda: ref.leaf_dots_ref(hg, rows),
                lambda: torch.bmm(rows, h3)))
    # a yardstick of the byte bound: one plain streaming read of the rows
    out["leaf_scores"]["stream_read_ms"] = device_ms(lambda: rows.sum())
    log(f"[kernels] leaf_scores ({g}, {b}, {r}): rows.sum() over the same "
        f"{4 * g * b * r / 1e9:.2f} GB, device ms per call "
        f"{out['leaf_scores']['stream_read_ms']}")
    del rows, hg, h3
    torch.cuda.empty_cache()
    log_rows(f"{tag} index shapes", out)
    return out


def lm_serving(cfg, params, prompts: torch.Tensor, tag: str,
               want: dict[str, int], frames: torch.Tensor | None = None,
               max_len: int = LLAMA_MAX_LEN) -> types.SimpleNamespace:
    """An LM's serving main path through the port's steps, at full width:
    the retrieval index over its head (zstats), prefill of the prompts
    (an encoder-decoder's: of ``frames``, its prompt the (B, 1) token 0
    that its prefill step decodes at position 0), LLAMA_DECODE greedy
    decode steps, a top-k step through the index at full beam (equal to
    the dense top-k, ties aside, its top-1 the greedy token) and beam-8
    top-k steps; caches of ``max_len`` positions.  Launch counts are read
    around exactly that and must equal ``want`` (every other kernel 0).
    Then, outside the counted run, the checks and the timings (prefill /
    decode / top-k times, tokens/s, peak memory, the device busy share of
    a chain of decode steps).  Returns the run's counts, index, tokens,
    caches, last token and position, the last step's h and its
    timings."""
    batch = {"tokens": prompts} if frames is None else {"frames": frames}
    b, s = prompts.shape
    n_dec, k = LLAMA_DECODE, 10
    head = api.head_table(params, cfg)
    timing: dict = {}

    # -- the counted main path ---------------------------------------------
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    inner, wrapped = timed_spectral(timing)
    retrieval.spectral_stats = wrapped
    try:
        t0 = time.perf_counter()
        index = retrieval.build_index(head)
        torch.cuda.synchronize()
        timing["index_build_s"] = time.perf_counter() - t0
    finally:
        retrieval.spectral_stats = inner
    prefill = engine.make_prefill_step(cfg, None, max_len)
    decode = engine.make_decode_step(cfg, None)
    t0 = time.perf_counter()
    tok, caches = prefill(params, batch)
    torch.cuda.synchronize()
    timing["first_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(n_dec):
        pos = torch.full((b,), s + i, dtype=torch.long, device=DEV)
        tok, caches = decode(params, tok[:, None].long(), caches, pos)
        generated.append(tok)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    pos = torch.full((b,), s + n_dec, dtype=torch.long, device=DEV)
    last = tok[:, None].long()
    # every step below starts from the same caches: K/V are rewritten with
    # the same values at pos, mamba states are returned, not written
    ids, logits, _ = engine.make_topk_step(cfg, None, k, index=index)(
        params, last, caches, pos)
    dids, dlog, _ = engine.make_topk_step(cfg, None, k + 1)(
        params, last, caches, pos)
    greedy, _ = decode(params, last, caches, pos)
    beam8 = engine.make_topk_step(cfg, None, k, index=index, beam=8)
    b8_ids, b8_logits, _ = beam8(params, last, caches, pos)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[{tag}] main path launches {counts}")
    full_want = dict.fromkeys(REPLACES, 0)
    full_want.update(want)
    if counts != full_want:
        raise AssertionError(f"{tag} serving launches {counts} != "
                             f"{full_want}")

    # -- checks ---------------------------------------------------------------
    if not torch.allclose(logits, dlog[:, :k], rtol=1e-5, atol=0.0):
        raise AssertionError(f"{tag}: full-beam logits differ from the "
                             "dense top-k")
    swaps = check_topk_ties(f"{tag} full beam", ids, dids, dlog, k)
    if not torch.equal(ids[:, 0], greedy):
        swaps1 = check_topk_ties(f"{tag} top-1 vs greedy", ids[:, :1],
                                 greedy[:, None], dlog, 1)
        log(f"[{tag}] top-1 differs from greedy by {swaps1} tie(s)")
    h = _decode_h(params, cfg, last, caches, pos)
    exact8 = torch.einsum("tkd,td->tk", head.float()[b8_ids.long()], h)
    if not torch.allclose(b8_logits, exact8, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{tag}: beam-8 logits differ from their "
                             "exact dots")
    log(f"[{tag}] full beam ({index.num_leaves_shard} leaves of "
        f"{index.leaf_size}): ids equal the dense top-{k} ({swaps} tie "
        f"swaps), top-1 = greedy token {greedy.tolist()}; beam 8 logits "
        f"exact")
    tokens = torch.cat([prompts] + [g[:, None].long() for g in generated],
                       dim=1)  # (B, 512 + 33)

    # -- timings --------------------------------------------------------------
    timing["prefill_ms"] = host_ms(lambda: prefill(params, batch))
    timing["decode_ms_per_token_chain"] = chain_s / n_dec * 1e3
    timing["decode_step_ms"] = host_ms(
        lambda: decode(params, last, caches, pos))
    timing["tokens_per_s"] = b * n_dec / chain_s
    timing["topk_full_beam_step_ms"] = host_ms(
        lambda: engine.make_topk_step(cfg, None, k, index=index)(
            params, last, caches, pos))
    timing["topk_beam8_step_ms"] = host_ms(
        lambda: beam8(params, last, caches, pos))
    timing["retrieval_beam8_ms"] = host_ms(
        lambda: retrieval.decode_topk(index, h, k, 8))
    timing["retrieval_full_beam_ms"] = host_ms(
        lambda: retrieval.decode_topk(index, h, k, None))
    timing["dense_topk_ms"] = host_ms(
        lambda: retrieval.dense_topk(head, h, k, n_valid=cfg.vocab_size))
    timing["recall_at_10_beam8"] = retrieval.recall_at_k(index, head, h, k, 8)
    busy, wall = profile_busy(lambda: decode(params, last, caches, pos),
                              n_dec)
    timing["decode_chain_device_busy_share"] = busy / wall
    timing["decode_chain_device_busy_ms_per_step"] = busy / n_dec / 1e3
    timing["decode_chain_wall_ms_per_step"] = wall / n_dec / 1e3
    return types.SimpleNamespace(counts=counts, index=index, tokens=tokens,
                                 caches=caches, last=last, pos=pos, h=h,
                                 head=head, timing=timing)


def log_timing(tag: str, timing: dict) -> None:
    timing["max_memory_allocated_gb"] = (torch.cuda.max_memory_allocated()
                                         / 1e9)
    log(f"[{tag}] timings (host ms medians of 9, synced; H100 per "
        f"nvidia-smi line): " + json.dumps(timing))


def init_lm_params(cfg, gen: torch.Generator, tag: str):
    """Seeded random weights of ``cfg`` on the card, logged with their
    count and size; the peak memory statistics reset first."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers "
        f"{[kind for kind, _ in transformer.segments_of(cfg)][:8]}..., d "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, experts {cfg.n_experts} x {cfg.moe_d_ff} top-"
        f"{cfg.moe_top_k}, ssm state {cfg.ssm_state}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, init "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def phase_llama_serving(gen: torch.Generator, rng: np.random.Generator
                        ) -> tuple[dict[str, int], dict, dict[str, dict]]:
    """llama3-8b at full width and depth (seeded random bf16 weights)
    through ``lm_serving``: zstats once, flash_attention (the tensor-core
    kernel) once per layer, leaf_scores once per index top-k step; then
    decode against a full forward, and zstats and leaf_scores against their
    plain versions at the index's shapes.  Returns (the path's launch
    counts, the forward's last hidden states and their tokens for the
    sampled-loss entry run, the index-shape kernel rows)."""
    cfg = get_config("llama3-8b")
    params = init_lm_params(cfg, gen, "llama")
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_PROMPT))).to(DEV)
    run = lm_serving(cfg, params, prompts, "llama", dict(
        zstats=1, flash_attention=cfg.n_layers, leaf_scores=2))
    log(f"[llama] all {run.counts['flash_attention']} prefill attentions "
        f"went through the tensor-core flash kernel, none through the "
        f"CUDA-core one")
    h_full = check_decode_matches_forward(params, cfg, run.tokens)
    agree = _greedy_agreement(h_full, run.head, cfg, run.tokens)
    log(f"[llama] greedy tokens equal the full forward's argmax at "
        f"{agree} of {LLAMA_BATCH * (LLAMA_DECODE + 1)} positions (bf16, "
        f"not gated)")
    index_rows = index_kernel_rows(run.index, run.h)
    log_timing("llama", run.timing)
    mesh_serve_llama_reference(cfg, params, prompts)
    out = {"h": h_full[:, :-1].reshape(-1, cfg.d_model),
           "labels": run.tokens[:, 1:].reshape(-1), "head": run.head}
    counts = run.counts
    del params, run
    return counts, out, index_rows
def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _decode_h(params, cfg, token, caches, pos) -> torch.Tensor:
    """The (B, d) hidden state of one decode step, in fp32 (rewrites the
    same K/V at ``pos``)."""
    h, _ = engine._decode_step(cfg)(params, token, caches, pos, cfg)
    return h[:, 0].float()


class Routes:
    """The MoE layers' routing of a forward, recorded call by call (one
    call per MoE layer), then imposed on a prefill or a decode step at the
    same positions.  An MoE layer's top-k is discontinuous: where two
    experts' scores nearly tie, bf16 rounding differences between two
    computations of the same token (GEMMs of M = 4 and of M = 2,180) flip
    the choice and move that token's output by O(|y|), and the mamba state
    carries it on.  With the forward's routing imposed, decode = forward
    holds up to rounding; ``flips`` counts the (token, layer) pairs whose
    own top-k differed from the forward's."""

    def __init__(self) -> None:
        self.calls: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.flips = 0
        self.routed = 0

    @contextlib.contextmanager
    def recording(self, b: int, s: int):
        real = moe._route

        def spy(p, x2d, cfg):
            ids, w, aux = real(p, x2d, cfg)
            self.calls.append((ids.reshape(b, s, -1), w.reshape(b, s, -1)))
            return ids, w, aux

        moe._route = spy
        try:
            yield
        finally:
            moe._route = real

    @contextlib.contextmanager
    def imposing(self, positions: slice):
        real = moe._route
        calls = iter(self.calls)

        def spy(p, x2d, cfg):
            ids, w, aux = real(p, x2d, cfg)
            f_ids, f_w = next(calls)
            f_ids = f_ids[:, positions].reshape(ids.shape)
            self.flips += int((ids != f_ids).any(dim=-1).sum())
            self.routed += ids.shape[0]
            return f_ids, f_w[:, positions].reshape(w.shape), aux

        moe._route = spy
        try:
            yield
        finally:
            moe._route = real


def check_decode_matches_forward(params, cfg, tokens, tag: str = "llama",
                                 rtol: float = DECODE_RTOL,
                                 rel_rms: float = DECODE_REL_RMS
                                 ) -> torch.Tensor:
    """tests/test_serve.py's contract at full width on the card: prefill's
    h equals a full forward's first 512 positions and each of 32 decode
    steps' h the forward's at its position, within ``rtol`` of max
    |h_forward| element by element and within ``rel_rms`` in relative
    RMS.  An MoE model's prefill and decode take the forward's routing
    (``Routes``), its flips logged.  Returns the forward's hidden states
    (B, 545, d)."""
    b, s = tokens.shape[0], LLAMA_PROMPT
    routes = Routes()

    def routed(ctx):
        return ctx if cfg.n_experts else contextlib.nullcontext()

    with torch.no_grad(), routed(routes.recording(*tokens.shape)):
        h_full, _ = transformer.hidden_states(params, tokens, cfg)
    with routed(routes.imposing(slice(0, s))):
        h_pre, caches = transformer.prefill(params, tokens[:, :s], cfg,
                                            max_len=LLAMA_MAX_LEN)
    errs = [compare(f"{tag} prefill h vs forward", h_pre, h_full[:, :s],
                    rtol=rtol)]
    rms = [float(_rel_rms(h_pre, h_full[:, :s]))]
    for i in range(LLAMA_DECODE):
        pos = torch.full((b,), s + i, dtype=torch.long, device=DEV)
        with routed(routes.imposing(slice(s + i, s + i + 1))):
            h_dec, caches = transformer.decode_step(
                params, tokens[:, s + i:s + i + 1], caches, pos, cfg)
        want = h_full[:, s + i]
        err = float((h_dec[:, 0].float() - want.float()).abs().max())
        if err > rtol * float(want.float().abs().max()):
            compare(f"{tag} decode step {i} h vs forward", h_dec[:, 0],
                    want, rtol=rtol)
        errs.append(err)
        rms.append(float(_rel_rms(h_dec[:, 0], want)))
    flips = (f"; the forward's routing imposed: {routes.flips} of "
             f"{routes.routed} (token, MoE layer) pairs would have routed "
             f"otherwise" if cfg.n_experts else "")
    log(f"[{tag}] decode vs forward: prefill + {LLAMA_DECODE} steps, max "
        f"abs err {max(errs)} (max |h| {float(h_full.float().abs().max())}), "
        f"relative RMS err max {max(rms)} mean {statistics.mean(rms)}; "
        f"tolerances {rtol} x max|h|, relative RMS {rel_rms}{flips}")
    worst = max(range(len(rms)), key=rms.__getitem__)
    if rms[worst] > rel_rms:
        raise AssertionError(
            f"{tag} {'prefill' if worst == 0 else f'decode step {worst - 1}'}"
            f" h vs forward: relative RMS {rms[worst]} > {rel_rms}")
    return h_full


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.float() - b.float()
    return torch.sqrt(torch.mean(d * d) / torch.mean(b.float() ** 2))


def _greedy_agreement(h_full, head, cfg, tokens) -> int:
    """Positions where the generated token is the full forward's argmax."""
    s = LLAMA_PROMPT
    hs = h_full[:, s - 1:-1].reshape(-1, cfg.d_model)
    arg = engine._argmax_island(cfg, None, head, hs).reshape(
        tokens.shape[0], -1)
    return int((arg.long() == tokens[:, s:]).sum())


def profile_busy(fn, n: int) -> tuple[float, float]:
    """(device busy us, untraced host wall us) of ``n`` back-to-back calls:
    the union of the device intervals of n traced calls, and the host wall
    of n untraced calls, each chain synced at its end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return busy_us(device_events(prof)), wall


def phase_sampled_loss_entry(gen: torch.Generator, llama: dict
                             ) -> dict[str, int]:
    """sampled_loss's entry point (no reference path calls it) driven at
    llama3-8b's width: the corrected sampled-softmax loss (eq. 2-3) of the
    prompts' next tokens from the forward's bf16 hidden states, with 512
    negatives shared across tokens, drawn uniformly from the vocab (logq =
    -log n), through ``ops.sampled_loss`` once.  Counts are read around
    that one call; the result is held against the plain version and shown
    beside the exact full-softmax loss of the same tokens."""
    cfg = get_config("llama3-8b")
    h, labels, head = llama["h"], llama["labels"], llama["head"]
    m = 512
    neg = torch.randint(0, cfg.vocab_size, (m,), generator=gen, device=DEV)
    w_neg = head[neg].contiguous()
    logq = torch.full((m,), -math.log(cfg.vocab_size), device=DEV)
    pos = torch.einsum("td,td->t", h.float(), head[labels].float())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    loss = ops.sampled_loss(h, w_neg, logq, pos, m_total=m)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = dict.fromkeys(REPLACES, 0)
    want.update(sampled_loss=1)
    if counts != want:
        raise AssertionError(f"sampled_loss entry launches {counts} != {want}")
    compare(f"sampled_loss bf16 entry (T {h.shape[0]}, m {m}, d "
            f"{cfg.d_model})", loss,
            ref.sampled_loss_ref(h, w_neg, logq, pos, m))
    full = torch.logsumexp(h.float() @ head.float().T, dim=-1) - pos
    log(f"[sampled_loss] entry run at llama width: mean sampled loss "
        f"{float(loss.mean())} vs exact full softmax {float(full.mean())} "
        f"(uniform proposal, m = {m}, not gated); launches {counts}")
    return counts


# --- phase 18: starcoder2-3b training -> quantized serving -------------------

#: flash_attention_bwd's gates: each gradient element within this fraction
#: of the gradient's max |plain|.  bf16: the kernel writes bf16 gradients
#: (2^-9 relative rounding) from fp32 sums in another order than the plain
#: version's, with P and dS as bf16 hi + lo in its products; fp32:
#: summation order only.
BWD_BF16_RTOL = 2.0 ** -7
BWD_FP32_RTOL = 1e-4
#: the dense first step's gradients through the kernels against the plain
#: attention's: the worst and the median over the parameters of
#: max|diff| / max|plain| and of the relative norm, each at most this
#: multiple of the same statistic between two plain versions (128- and
#: 64-key chunks).  Through 30 bf16 layers the two plain versions already
#: differ by 1.7% of max|plain| at worst and 0.53% at the median (an H100
#: 80GB HBM3 at 700 W), so a per-element 2^-7 bound holds for no
#: implementation there; the kernels are held to it per call instead
#: (phase 18a)
DENSE_GRAD_FLOOR_FACTOR = 2.0


def kept_pairs(s: int, causal: bool, s_valid: int | None,
               sk: int | None = None) -> int:
    """(query, key) pairs the mask keeps in one (batch, head) of s
    queries over sk keys (default s)."""
    sk = sk or s
    sv = sk if s_valid is None else min(sk, s_valid)
    if not causal:
        return s * sv
    return sum(min(i + 1, sv) for i in range(s))


def flash_bwd_bound(b: int, s: int, h: int, kv: int, hd: int, causal: bool,
                    dtype: torch.dtype, s_valid: int | None = None,
                    hv: int | None = None, sk: int | None = None
                    ) -> tuple[float, str]:
    """(bound_ms, bound_by) of one backward call: q, k, v, dO and lse read
    once, dq, dk and dv written once; 2·(3 hd + 2 hv) flops per kept
    (query, key) pair (the five products QK^T, dS^T Q and dS K over hd,
    P^T dO and dO V^T over hv; hv defaults to hd, the key length sk to
    s), at the inputs' peak rate."""
    hv, sk = hv or hd, sk or s
    esize = torch.finfo(dtype).bits // 8
    n_bytes = esize * (b * s * h * (2 * hd + hv)
                       + 2 * b * sk * kv * (hd + hv)) + 4 * b * h * s
    flops = 2.0 * (3 * hd + 2 * hv) * b * h * kept_pairs(s, causal, s_valid,
                                                         sk)
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    return bound_ms(n_bytes, flops, rate)


def flash_bwd_case(gen: torch.Generator, b: int, s: int, h: int, kv: int,
                   hd: int, dtype: torch.dtype, causal: bool = True,
                   s_valid: int | None = None, timed: bool = False,
                   splits: bool | None = None, hv: int | None = None,
                   sk: int | None = None) -> dict:
    """flash_attention_bwd on random inputs against its plain version
    (autograd through ``ref.flash_attention_ref``): the forward kernel's
    lse within RTOL of the plain log-sum-exp, dq, dk and dv each within
    BWD_BF16_RTOL (bf16) or BWD_FP32_RTOL (fp32) x max|plain|,
    two calls bitwise equal, and the route the launch counts show (bf16 at
    hd and hv (default hd) multiples of 16, hd up to 192 and hv up to
    128: the tensor cores, whose plan is logged; ``splits`` asserts
    whether it splits a key tile's group).  ``sk`` gives the keys a length
    of their own (default S: a cross attention, not causal).  ``timed``
    adds the kernel, plain and library device times (the library: SDPA's
    backward alone after one forward, with enable_gqa; its forward +
    backward beside it; yardsticks only), the bound, and the device ms of
    the backward's two kernels."""
    tag = (f"flash_attention_bwd {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
           f" causal={causal} s_valid={s_valid} (B {b}, S {s}"
           + (f", Sk {sk}" if sk else "") + f", H {h}, KV {kv}, hd {hd}"
           + (f", hv {hv})" if hv else ")"))
    q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype, hv, sk)
    o, lse = flash_attention(q, k, v, causal=causal, s_valid=s_valid,
                             with_lse=True)
    dout = torch.randn(o.shape, generator=gen, device=DEV).to(dtype)
    _, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                          s_valid=s_valid, with_lse=True)
    compare(f"{tag} lse", lse, want_lse)
    tc = kernels.flash_attention.uses_tensor_cores(q, k, v)
    pl = None
    if tc:
        pl = kernels.flash_attention.plan(
            b, s, h, kv, hd, causal, hv=hv, sk=sk,
            sms=torch.cuda.get_device_properties(DEV).multi_processor_count)
        log(f"  {tag}: plan key tile {pl.key_tile}, chunk {pl.chunk}, "
            f"steps {pl.steps}, splits "
            f"{pl.splits}, dK/dV blocks {pl.blocks} ({pl.waves} waves), dQ "
            f"blocks {pl.dq_blocks}, longest {pl.longest:.2f} steps, fold "
            f"{pl.fold_bytes} bytes")
    if splits is not None and (pl is None or (max(pl.splits) > 1) != splits):
        raise AssertionError(f"{tag}: plan {pl} does not "
                             f"{'split' if splits else 'keep'} the group")

    def call():
        return flash_attention_bwd(q, k, v, dout, lse, causal=causal,
                                   s_valid=s_valid)

    before = kernels.launch_counts()
    got, again = call(), call()
    after = kernels.launch_counts()
    took = {n: after[n] - before[n]
            for n in ("flash_attention_bwd", "flash_attention_bwd_simt")}
    want_took = {"flash_attention_bwd": 2 * tc,
                 "flash_attention_bwd_simt": 2 * (not tc)}
    if took != want_took:
        raise AssertionError(f"{tag}: launches {took} != {want_took}")
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(x, y):
            raise AssertionError(f"{tag}: two calls' {name} differ")
    want = ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       s_valid=s_valid)
    rtol = BWD_BF16_RTOL if dtype == torch.bfloat16 else BWD_FP32_RTOL
    err = max(compare(f"{tag} {name}", x, y, rtol=rtol)
              for name, x, y in zip(("dq", "dk", "dv"), got, want))
    row = {"max_abs_err": err}
    if timed:
        bms, by = flash_bwd_bound(b, s, h, kv, hd, causal, dtype, s_valid,
                                  hv, sk)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = dout.transpose(1, 2)
        out_lib = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)

        def library_bwd():
            return torch.autograd.grad(out_lib, (qt, kt, vt), dot,
                                       retain_graph=True)

        def library_fwd_bwd():
            out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
            return torch.autograd.grad(out, (qt, kt, vt), dot)

        row.update(bound_ms=bms, bound_by=by, **times(
            call, lambda: ref.flash_attention_bwd_ref(
                q, k, v, dout, causal=causal, s_valid=s_valid), library_bwd))
        row["library_fwd_bwd_ms"] = device_ms(library_fwd_bwd)
        row["kernel_split_ms"] = device_split(call)
        if pl is not None:
            row["plan"] = dict(key_tile=pl.key_tile, chunk=pl.chunk,
                               splits=list(pl.splits),
                               blocks=pl.blocks, waves=pl.waves,
                               dq_blocks=pl.dq_blocks,
                               fold_bytes=pl.fold_bytes)
        log(f"  {tag}: {json.dumps(row)}")
        del out_lib, qt, kt, vt
    del q, k, v, o, lse, dout, got, again, want
    torch.cuda.empty_cache()
    return row


def check_flash_autograd(gen: torch.Generator) -> float:
    """``ops.flash_attention`` on CUDA inputs that require a gradient
    returns an output with a graph, and its gradients (the kernels' with
    lse) match the plain version's."""
    q, k, v = (x.requires_grad_(True) for x in attn_inputs(
        gen, 2, 300, 24, 2, 128, torch.bfloat16))
    out = ops.flash_attention(q, k, v, causal=True)
    if out.grad_fn is None:
        raise AssertionError("ops.flash_attention on CUDA inputs that "
                             "require grad returned no graph")
    dout = torch.randn(out.shape, generator=gen, device=DEV).to(out.dtype)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, causal=True)
    return max(compare(f"ops.flash_attention autograd d{n}", x, y,
                       rtol=BWD_BF16_RTOL)
               for n, x, y in zip("qkv", got, want))


def phase_flash_bwd(gen: torch.Generator) -> tuple[dict[str, dict],
                                                   dict[str, dict]]:
    """flash_attention_bwd against its plain version: at the dense
    training path's shape (starcoder2-3b: B 4, S 1,024, H 24 over KV 2, hd
    128, causal bf16; timed; its plan splits the group), ragged S 1,000,
    llama3-8b's (1, 2,048, 32 / 8, 128; timed), s_valid < S causal and
    not, a group of 1 whose plan splits nothing, every tensor-core width
    (hd 16-128 by 16), and fp32 (the CUDA-core route; its path-shape row
    timed); then ``ops.flash_attention``'s autograd.  Returns (rows at the
    path shape, rows at other shapes)."""
    cfg = get_config(DENSE_ARCH)
    b, s, h, kv, hd = (DENSE_BATCH, DENSE_SEQ, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim)
    bf = torch.bfloat16
    row = flash_bwd_case(gen, b, s, h, kv, hd, bf, timed=True, splits=True)
    errs = [flash_bwd_case(gen, b, 1000, h, kv, hd, bf)["max_abs_err"],
            flash_bwd_case(gen, 2, 512, 8, 2, 128, bf, causal=False,
                           s_valid=400)["max_abs_err"],
            flash_bwd_case(gen, 2, 512, 8, 2, 128, bf,
                           s_valid=400)["max_abs_err"],
            flash_bwd_case(gen, 1, 300, 4, 2, 64, bf)["max_abs_err"],
            # group 1 (MHA), one wave without a split
            flash_bwd_case(gen, 4, 512, 8, 8, 128, bf,
                           splits=False)["max_abs_err"],
            check_flash_autograd(gen)]
    # every width the tensor-core route takes (hd 16-128 by 16; 64, 96 and
    # 128 above), ragged S
    errs += [flash_bwd_case(gen, 1, 200, 4, 2, w, bf)["max_abs_err"]
             for w in (16, 32, 48, 80, 112)]
    errs.append(flash_bwd_case(gen, 2, 256, 8, 2, 32, bf, causal=False,
                               s_valid=190)["max_abs_err"])
    row["other_max_abs_err"] = max(errs)
    llama = flash_bwd_case(gen, 1, 2048, 32, 8, 128, bf, timed=True)
    f32 = torch.float32
    simt = flash_bwd_case(gen, b, s, h, kv, hd, f32, timed=True)
    simt["other_max_abs_err"] = max(
        flash_bwd_case(gen, 2, 300, 8, 2, 64, f32)["max_abs_err"],
        flash_bwd_case(gen, 2, 300, 4, 4, 33, f32, causal=False,
                       s_valid=250)["max_abs_err"],
        flash_bwd_case(gen, 1, 77, 4, 1, 256, f32,
                       s_valid=50)["max_abs_err"],
        flash_bwd_case(gen, 1, 200, 8, 2, 96, bf)["max_abs_err"])
    log_rows("dense training path's attention shape",
             {"flash_attention_bwd": row,
              "flash_attention_bwd_simt (fp32)": simt})
    return ({"flash_attention_bwd": row, "flash_attention_bwd_simt": simt},
            {"llama_prefill": {"flash_attention_bwd": llama}})


# --- phase 21a: the attention kernels at MLA's shapes ------------------------

#: deepseek-v3-671b's expanded MLA attention: 128 heads with no KV sharing,
#: a q/k width of 192 (nope 128 + rope 64) and a value width of 128
MLA_HEADS, MLA_HD, MLA_HV = 128, 192, 128
#: (B, S) of the MLA attention calls on this slice's paths: the serving
#: prefill (4 prompts of 512), the training microbatch (one sequence of
#: 512) and the mtp block's attention in training (S - 1 = 511)
MLA_SHAPES = {"mla_serving": (4, 512), "mla_train": (1, 512),
              "mla_train_mtp": (1, 511)}


def sdpa_backend(qt, kt, vt, causal: bool) -> str:
    """The backend PyTorch's SDPA dispatcher picks for these (B, H, S, *)
    inputs (``torch._fused_sdp_choice``)."""
    choice = torch._fused_sdp_choice(qt, kt, vt, None, 0.0, causal,
                                     enable_gqa=True)
    return torch.nn.attention.SDPBackend(choice).name


def flash_mla_row(gen: torch.Generator, b: int, s: int,
                  h: int = MLA_HEADS, timed: bool = True) -> dict:
    """``flash_attention`` at MLA's widths over ``h`` heads, causal bf16:
    it must take the tensor-core entry point; held against the plain
    version element by element (BF16_ELEM_RTOL), then (``timed``) timed
    beside it and SDPA (whose backend is named)."""
    hd, hv = MLA_HD, MLA_HV
    q, k, v = attn_inputs(gen, b, s, h, h, hd, torch.bfloat16, hv)
    before = kernels.launch_counts()
    got = flash_attention(q, k, v)
    after = kernels.launch_counts()
    if (after["flash_attention"] != before["flash_attention"] + 1
            or after["flash_attention_simt"]
            != before["flash_attention_simt"]):
        raise AssertionError("bf16 (192, 128) flash did not take the "
                             "tensor-core entry point")
    err = compare(f"flash_attention bf16 causal (B {b}, S {s}, H = KV {h},"
                  f" hd {hd}, hv {hv})", got,
                  ref.flash_attention_ref(q, k, v, causal=True),
                  elem_rtol=BF16_ELEM_RTOL)
    if not timed:
        del q, k, v, got
        return {"max_abs_err": err}
    bms, by, _ = flash_bound(b, s, h, h, hd, True, torch.bfloat16, hv)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = dict(max_abs_err=err, bound_ms=bms, bound_by=by,
               library=f"SDPA {sdpa_backend(qt, kt, vt, True)}", **times(
                   lambda: flash_attention(q, k, v),
                   lambda: ref.flash_attention_ref(q, k, v, causal=True),
                   lambda: sdpa(qt, kt, vt, is_causal=True)))
    log(f"  flash_attention MLA (B {b}, S {s}): {json.dumps(row)}")
    del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()
    return row


def phase_flash_mla(gen: torch.Generator) -> dict[str, dict]:
    """Phase 21a: both attention kernels at MLA's widths (hd 192, hv 128)
    on the tensor cores against their plain versions, at every MLA shape
    of this slice's paths (MLA_SHAPES; timed, with the bound and SDPA's
    time and backend); then off those shapes: the backward at a group of 4
    and not causal with s_valid, two narrower pairs zero-padded to (192,
    128) (hd 160, hv 96; hd 64, hv 32), and the CUDA-core route at hv !=
    hd (fp32 at the reduced config's (24, 16) and at (192,
    128), forward and backward).  Returns rows by shape tag."""
    bf, f32 = torch.bfloat16, torch.float32
    h, hd, hv = MLA_HEADS, MLA_HD, MLA_HV
    rows: dict[str, dict] = {}
    for tag, (b, s) in MLA_SHAPES.items():
        bwd = flash_bwd_case(gen, b, s, h, h, hd, bf, timed=True, hv=hv)
        q, k, v = attn_inputs(gen, b, s, h, h, hd, bf, hv)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bwd["library"] = f"SDPA backward {sdpa_backend(qt, kt, vt, True)}"
        del q, k, v, qt, kt, vt
        rows[tag] = {"flash_attention": flash_mla_row(gen, b, s),
                     "flash_attention_bwd": bwd}
    errs = [flash_bwd_case(gen, 2, 200, 8, 2, hd, bf, hv=hv)["max_abs_err"],
            flash_bwd_case(gen, 1, 300, 8, 8, hd, bf, causal=False,
                           s_valid=250, hv=hv)["max_abs_err"],
            flash_bwd_case(gen, 1, 200, 4, 2, 160, bf, hv=96)["max_abs_err"],
            flash_bwd_case(gen, 1, 200, 4, 2, 64, bf, hv=32)["max_abs_err"]]
    simt = [flash_bwd_case(gen, 1, 77, 4, 2, 24, f32, hv=16)["max_abs_err"],
            flash_bwd_case(gen, 1, 100, 4, 4, hd, f32, causal=False,
                           s_valid=90, hv=hv)["max_abs_err"],
            flash_bwd_case(gen, 1, 100, 4, 2, 24, bf, hv=16)["max_abs_err"]]
    for b, s, hh, kv, d, dv, dt in ((1, 77, 4, 2, 24, 16, f32),
                                    (1, 100, 4, 4, hd, hv, f32),
                                    (2, 200, 8, 2, 160, 96, bf)):
        q, k, v = attn_inputs(gen, b, s, hh, kv, d, dt, dv)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        fn = flash_attention if dt == bf else flash_attention_simt
        err = compare(f"{fn.__name__} {dt} (B {b}, S {s}, H {hh}, KV {kv}, "
                      f"hd {d}, hv {dv})", fn(q, k, v), want,
                      elem_rtol=BF16_ELEM_RTOL if dt == bf else 0.0)
        (errs if dt == bf else simt).append(err)
    log(f"[mla kernels] off the path's shapes: tensor-core max err "
        f"{max(errs)}, CUDA-core {max(simt)}")
    rows["mla_serving"]["flash_attention_bwd"]["other_max_abs_err"] = \
        max(errs)
    rows["mla_serving"]["flash_attention_bwd"]["simt_max_abs_err"] = \
        max(simt)
    return rows


# --- phase 22a: the attention kernels at whisper-large-v3's shapes -----------

#: whisper-large-v3's attention: 20 heads of 64 with no KV sharing, over
#: 1,500 audio frames (30 s) in the encoder and 448 text tokens (the
#: decoder's context) in the decoder
WHISPER_HEADS, WHISPER_HD = 20, 64
WHISPER_FRAMES, WHISPER_TEXT = 1500, 448
WHISPER_SERVE_BATCH, WHISPER_TRAIN_BATCH = 4, 8
#: (B, Sq, Sk, causal) of the attention calls on this slice's paths: the
#: encoder's self-attention in serving and in training, the decoder's
#: causal self-attention and its cross attention over the frames in
#: training
WHISPER_SHAPES = {
    "whisper_enc_serving": (WHISPER_SERVE_BATCH, WHISPER_FRAMES,
                            WHISPER_FRAMES, False),
    "whisper_enc_train": (WHISPER_TRAIN_BATCH, WHISPER_FRAMES,
                          WHISPER_FRAMES, False),
    "whisper_dec_train": (WHISPER_TRAIN_BATCH, WHISPER_TEXT, WHISPER_TEXT,
                          True),
    "whisper_cross_train": (WHISPER_TRAIN_BATCH, WHISPER_TEXT,
                            WHISPER_FRAMES, False)}


def flash_cross_row(gen: torch.Generator, b: int, s: int, sk: int,
                    causal: bool, h: int = WHISPER_HEADS,
                    kv: int = WHISPER_HEADS, hd: int = WHISPER_HD,
                    dtype: torch.dtype = torch.bfloat16,
                    s_valid: int | None = None, timed: bool = True) -> dict:
    """``flash_attention`` on s queries over sk keys: bf16 at hd 64 must
    take the tensor-core entry point (fp32 the CUDA-core one), held
    against the plain version (BF16_ELEM_RTOL element by element in bf16,
    RTOL in fp32); ``timed`` adds its times beside the plain version's and
    SDPA's (whose backend is named) and its bound."""
    q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype, sk=sk)
    tc = dtype == torch.bfloat16
    entry = "flash_attention" if tc else "flash_attention_simt"
    before = kernels.launch_counts()
    got = flash_attention(q, k, v, causal=causal, s_valid=s_valid)
    after = kernels.launch_counts()
    took = {n: after[n] - before[n]
            for n in ("flash_attention", "flash_attention_simt")}
    if took != {n: int(n == entry) for n in took}:
        raise AssertionError(f"flash (B {b}, S {s}, Sk {sk}) {dtype} took "
                             f"{took}, not {entry}")
    tag = (f"{entry} {dtype} causal={causal} s_valid={s_valid} (B {b}, "
           f"Sq {s}, Sk {sk}, H {h}, KV {kv}, hd {hd})")

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       s_valid=s_valid)

    err = compare(tag, got, plain(), elem_rtol=BF16_ELEM_RTOL if tc else 0.0)
    row = {"max_abs_err": err}
    if timed:
        bms, by, _ = flash_bound(b, s, h, kv, hd, causal, dtype, sk=sk)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row.update(bound_ms=bms, bound_by=by,
                   library=f"SDPA {sdpa_backend(qt, kt, vt, causal)}",
                   **times(lambda: flash_attention(q, k, v, causal=causal),
                           plain,
                           lambda: sdpa(qt, kt, vt, is_causal=causal)))
        log(f"  {tag}: {json.dumps(row)}")
        del qt, kt, vt
    del q, k, v, got
    torch.cuda.empty_cache()
    return row


def check_causal_cross_refused(gen: torch.Generator) -> None:
    """A causal call whose keys are not as many as its queries raises
    ``ValueError`` in the forward, the backward and ``ops``, on the card."""
    q, k, v = attn_inputs(gen, 1, 64, 4, 4, WHISPER_HD, torch.bfloat16,
                          sk=128)
    lse = torch.zeros((1, 4, 64), device=DEV)
    for name, call in (
            ("flash_attention", lambda: flash_attention(q, k, v)),
            ("flash_attention_bwd",
             lambda: flash_attention_bwd(q, k, v, torch.zeros_like(q), lse)),
            ("ops.flash_attention", lambda: ops.flash_attention(q, k, v))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"{name} took a causal call with Sq 64 and "
                             f"Sk 128")


def phase_flash_whisper(gen: torch.Generator) -> dict[str, dict]:
    """Phase 22a: both attention kernels at whisper-large-v3's shapes
    (WHISPER_SHAPES: 20 heads of 64, bf16, on the tensor cores) against
    their plain versions, each timed beside SDPA (its backend named) with
    its bound; then off those shapes: the decode check's cross attention
    (4 x 33 queries over 1,500 frames), a ragged key length below the
    query length, an s_valid inside the keys, the CUDA-core route (fp32)
    with Sk != Sq both ways, and a causal call with Sk != Sq refused.
    Returns rows by shape tag."""
    bf, f32 = torch.bfloat16, torch.float32
    h, hd = WHISPER_HEADS, WHISPER_HD
    rows: dict[str, dict] = {}
    for tag, (b, s, sk, causal) in WHISPER_SHAPES.items():
        fwd = flash_cross_row(gen, b, s, sk, causal)
        if tag == "whisper_enc_serving":  # serving runs no backward
            rows[tag] = {"flash_attention": fwd}
            continue
        bwd = flash_bwd_case(gen, b, s, h, h, hd, bf, causal=causal,
                             timed=True, sk=sk)
        q, k, v = attn_inputs(gen, 1, s, h, h, hd, bf, sk=sk)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bwd["library"] = (f"SDPA backward "
                          f"{sdpa_backend(qt, kt, vt, causal)}")
        del q, k, v, qt, kt, vt
        rows[tag] = {"flash_attention": fwd, "flash_attention_bwd": bwd}
    errs = [
        flash_cross_row(gen, WHISPER_SERVE_BATCH, 33, WHISPER_FRAMES, False,
                        timed=False)["max_abs_err"],
        flash_cross_row(gen, 2, 300, 77, False, 8, 2,
                        timed=False)["max_abs_err"],
        flash_cross_row(gen, 2, 200, 500, False, 8, 2, s_valid=300,
                        timed=False)["max_abs_err"],
        flash_bwd_case(gen, WHISPER_SERVE_BATCH, 33, h, h, hd, bf,
                       causal=False, sk=WHISPER_FRAMES)["max_abs_err"],
        flash_bwd_case(gen, 2, 300, 8, 2, hd, bf, causal=False,
                       sk=77)["max_abs_err"],
        flash_bwd_case(gen, 2, 200, 8, 2, 128, bf, causal=False, s_valid=300,
                       sk=500)["max_abs_err"]]
    simt = [
        flash_cross_row(gen, 2, 100, 300, False, 8, 2, dtype=f32,
                        timed=False)["max_abs_err"],
        flash_cross_row(gen, 1, 77, 33, False, 4, 4, 33, dtype=f32,
                        timed=False)["max_abs_err"],
        flash_bwd_case(gen, 2, 100, 8, 2, hd, f32, causal=False,
                       sk=300)["max_abs_err"],
        flash_bwd_case(gen, 1, 77, 4, 4, 33, f32, causal=False, s_valid=20,
                       sk=33)["max_abs_err"]]
    check_causal_cross_refused(gen)
    log(f"[whisper kernels] off the path's shapes: tensor-core max err "
        f"{max(errs)}, CUDA-core {max(simt)}; a causal call with Sk != Sq "
        f"raised ValueError")
    cross = rows["whisper_cross_train"]
    cross["flash_attention"]["other_max_abs_err"] = max(errs)
    cross["flash_attention"]["simt_max_abs_err"] = max(simt)
    return rows


class CycledPool:
    """A fixed pool of batches served in turn, with the iterator state that
    ``fit``'s checkpoints record (``state_dict`` / ``load_state``)."""

    def __init__(self, pool: list):
        self.pool, self.i = pool, 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        return batch

    def state_dict(self) -> dict:
        return {"step": self.i}

    def load_state(self, state: dict) -> None:
        self.i = int(state["step"])


def plain_hidden(model, batch: dict, cfg) -> torch.Tensor:
    """``api.backbone_hidden``'s rows (the mtp rows after the backbone's
    where ``cfg.mtp``) with each backbone layer checkpointed
    (``torch.utils.checkpoint``; an encoder-decoder's every encoder and
    decoder layer, by ``cfg.remat``), for the plain attention's gradients:
    its fp32 scores for 30 layers would not fit on the card beside the
    model, so each layer's are recomputed in the backward."""
    if cfg.family == "encdec":
        return api.backbone_hidden(model, batch,
                                   dataclasses.replace(cfg, remat=True))[0]
    tokens = batch["tokens"]
    top = model.tree()
    b, s = tokens.shape
    x = layers.apply_embed(top["embed"], tokens, cfg)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    for (kind, _), seg in zip(transformer.segments_of(cfg),
                              top["segments"]):
        for lp in seg:
            x, _ = torch.utils.checkpoint.checkpoint(
                transformer._apply_layer, kind, lp, x, positions, cfg,
                use_reentrant=False)
    h = layers.apply_norm(top["final_norm"], x, cfg)
    rows = h.reshape(-1, h.shape[-1])
    if cfg.mtp:
        h_mtp = transformer.mtp_hidden(model, h, tokens, cfg)
        rows = torch.cat([rows, h_mtp[:, :-1].reshape(-1, h.shape[-1])])
    return rows


def fixed_negatives(cfg, model, sstate, batch) -> tuple:
    """The first step's refresh of ``sstate`` from ``model``'s head and its
    draw of shared negatives on ``batch`` (step 0's generator): (labels,
    neg, logq), the step's loss inputs held fixed."""
    sampler = sampler_from_config(cfg)
    with torch.no_grad():
        head = api.head_table(model, cfg).detach()
        sstate = step.make_refresh_fn(cfg)(head, sstate)
        h0, labels, _ = api.backbone_hidden(model, batch, cfg)
        runtime = sampler.island_runtime(sstate, head, cfg.vocab_size)
        neg, logq = sampler.sample_batch(runtime, h0,
                                         cfg.m_negatives,
                                         loop.step_generator(0, 0, DEV))
    return labels, neg, logq


def grads_or_zeros(loss, params: dict) -> list:
    """d loss / d each parameter, zeros for an MoE router's bias (it only
    picks the top-k, so the loss does not reach it), as the train step
    takes them.  Any other parameter the loss does not reach raises."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    unused = [n for n, g in zip(params, grads) if g is None
              and not n.endswith(".moe.router_bias")]
    if unused:
        raise AssertionError(f"the loss does not reach {unused}")
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params.values(), grads)]


def dense_grad_check(cfg, batch, tag: str = "dense",
                     own_gates: tuple = ()) -> float:
    """The first step of phase 18's fit (seed 0, the pool's first batch,
    its refresh and its draw of shared negatives) differentiated at those
    fixed negatives three ways: through the flash kernels, with every
    layer's attention run by its plain version (autograd through
    ``ref.flash_attention_ref``, 128-key chunks), and by the plain version
    over 64-key chunks (another valid order of the same fp32 sums: the
    bf16 noise floor of the comparison).  The losses within 1e-3 relative;
    the kernels' gradient errors within DENSE_GRAD_FLOOR_FACTOR x the
    floor's, by worst and median parameter, max-based and by norm; each
    (label, predicate on the parameter name) of ``own_gates`` gates its
    parameters on their own the same way.  Returns the worst kernel error
    over max|plain|."""
    opt = make_optimizer("sgd", 0.0)
    state = step.init_train_state(torch.Generator(DEV).manual_seed(0), cfg,
                                  None, opt, device=DEV)
    model = state.params
    est = estimators.make_estimator(cfg.estimator)
    labels, neg, logq = fixed_negatives(cfg, model, state.sampler_state,
                                        batch)
    params = step.param_dict(model)

    def grads_of(h2d):
        loss = torch.mean(estimators.loss_from_embeddings(
            est, api.head_table(model, cfg), h2d, labels, neg, logq,
            abs_mode=cfg.abs_softmax, impl=cfg.head_impl))
        return loss.item(), grads_or_zeros(loss, params)

    def plain_grads(chunk):
        kernel_flash = ops.flash_attention
        ops.flash_attention = lambda q, k, v, *, causal=True: \
            ref.flash_attention_ref(q, k, v, causal=causal, chunk=chunk)
        try:
            hp = plain_hidden(model, batch, cfg)
            return grads_of(hp.reshape(-1, hp.shape[-1]))
        finally:
            ops.flash_attention = kernel_flash

    h, _, _ = api.backbone_hidden(model, batch, cfg)
    loss_k, grads_k = grads_of(h)
    del h
    loss_p, grads_p = plain_grads(128)
    loss_q, grads_q = plain_grads(64)

    def rel(ga, gb):
        out = {}
        for name, a, b in zip(params, ga, gb):
            a, b = a.float(), b.float()
            scale = max(float(b.abs().max()), 1e-30)
            out[name] = (float((a - b).abs().max()) / scale,
                         float(torch.linalg.vector_norm(a - b)
                               / torch.linalg.vector_norm(b).clamp(
                                   min=1e-30)))
        return out

    kern, floor = rel(grads_k, grads_p), rel(grads_q, grads_p)
    for what, errs in (("kernels", kern), ("plain over 64-key chunks",
                                           floor)):
        worst = sorted(errs.items(), key=lambda kv: -kv[1][0])
        log(f"[{tag}] first-step gradients, {what} against the plain "
            f"attention (128-key chunks), over {len(errs)} parameters: "
            f"max|diff| / max|plain| worst {worst[:4]}, median "
            f"{statistics.median(e[0] for e in errs.values())}; relative "
            f"norm worst {max(e[1] for e in errs.values())}, median "
            f"{statistics.median(e[1] for e in errs.values())}")
    log(f"[{tag}] first step at fixed shared negatives (m {neg.numel()}): "
        f"loss through the kernels {loss_k}, plain {loss_p}, plain over "
        f"64-key chunks {loss_q}")
    if abs(loss_k - loss_p) > 1e-3 * abs(loss_p):
        raise AssertionError(f"{tag} loss through the kernels {loss_k} != "
                             f"plain {loss_p}")
    for label, keep in (("all", lambda n: True),) + tuple(own_gates):
        kern_g = {n: v for n, v in kern.items() if keep(n)}
        floor_g = {n: v for n, v in floor.items() if keep(n)}
        if not kern_g:
            raise AssertionError(f"{tag}: no parameter in the {label} "
                                 "gate")
        for i, measure in enumerate(("max|diff| / max|plain|",
                                     "relative norm")):
            for stat in (max, statistics.median):
                got = stat(v[i] for v in kern_g.values())
                floor_val = stat(v[i] for v in floor_g.values())
                if label != "all":
                    log(f"[{tag}] {label} ({len(kern_g)} parameters): "
                        f"{stat.__name__} {measure} through the kernels "
                        f"{got}, between the plain versions {floor_val}")
                if got > DENSE_GRAD_FLOOR_FACTOR * floor_val:
                    raise AssertionError(
                        f"{tag} {label} gradients through the kernels: "
                        f"{stat.__name__} {measure} {got} > "
                        f"{DENSE_GRAD_FLOOR_FACTOR} x the two plain "
                        f"versions' {floor_val}")
    del state, model, params, grads_k, grads_p, grads_q
    torch.cuda.empty_cache()
    return max(v[0] for v in kern.values())


def forwards(cfg) -> int:
    """Forward runs of each layer a training step makes: 2 under
    ``cfg.remat`` (the recompute in the backward), else 1."""
    return 2 if cfg.remat else 1


def params_gb(model) -> float:
    return sum(p.nbytes for p in model.parameters()) / 1e9


def allocated_gb() -> float:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 1e9


def _holders(obj, skip, depth: int = 3) -> str:
    """Who refers to ``obj``, ``depth`` levels up: type names (a frame by
    its function), the first three referrers at each level (``skip``: the
    caller's own lists)."""
    if depth == 0:
        return ""
    out = []
    for r in [r for r in gc.get_referrers(obj) if id(r) not in skip][:3]:
        name = (f"frame {r.f_code.co_name}" if isinstance(r, types.FrameType)
                else type(r).__name__)
        out.append(name + (f" <- ({_holders(r, skip, depth - 1)})"
                           if depth > 1 else ""))
    return ", ".join(out) or "nothing in Python"


def leftover_report(tag: str, top: int = 6) -> None:
    """What a phase left allocated: the largest live CUDA tensors (type,
    storage bytes, whether a view, autograd state) and who holds them,
    then the allocation after a full collection of reference cycles (what
    only a cycle held)."""
    live = sorted((o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor) and o.is_cuda),
                  key=lambda t: -t.untyped_storage().nbytes())
    log(f"[{tag}] {len(live)} live CUDA tensors in Python, storages "
        f"{sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in live}.values()) / 1e9:.3f} GB")
    skip = {id(live)}
    for t in live[:top]:
        log(f"[{tag}] live {type(t).__name__} {tuple(t.shape)} {t.dtype}, "
            f"storage {t.untyped_storage().nbytes() / 1e9:.3f} GB, view "
            f"{t._base is not None}, requires_grad {t.requires_grad}, "
            f"grad_fn {type(t.grad_fn).__name__}, refcount "
            f"{sys.getrefcount(t) - 2}, held by {_holders(t, skip)}")
    del live
    gc.collect()
    log(f"[{tag}] {allocated_gb():.3f} GB allocated after gc.collect()")


def dense_fit(cfg, pool, ckpt: str) -> tuple[dict[str, int], object]:
    """DENSE_STEPS steps of ``fit`` on the cycled pool, saving every
    DENSE_CKPT_EVERY steps (the last step's only): exact launches
    (flash_attention once per layer and forward run (``forwards``: twice
    under remat), flash_attention_bwd once per layer and step, zstats once
    per refresh),
    a finite loss that falls (the mean of the last pass over the pool
    below the first's), peak memory under the card's.  Returns the counts
    and the final state."""
    opt = make_optimizer("adamw", DENSE_LR)
    free = shutil.disk_usage(Path(ckpt).parent).free
    log(f"[dense] {shutil.disk_usage(Path(ckpt).parent).total / 1e9:.1f} GB "
        f"disk, {free / 1e9:.1f} GB free under {Path(ckpt).parent}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = loop.fit(cfg, None, opt, CycledPool(pool), DENSE_STEPS, seed=0,
                   checkpoint_dir=ckpt, checkpoint_every=DENSE_CKPT_EVERY,
                   keep=1, log_every=10, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    n = len(pool)
    first = statistics.mean(res.losses[:n])
    last = statistics.mean(res.losses[-n:])
    log(f"[dense] {cfg.name}: {DENSE_STEPS} steps of {DENSE_BATCH} x "
        f"{DENSE_SEQ} tokens in {wall:.3f} s ({wall / DENSE_STEPS * 1e3:.1f}"
        f" ms/step, the first step and the final save included); losses {res.losses}; mean of the first pass over the "
        f"pool {first}, of the last {last}; peak device memory "
        f"{peak / 2**30:.2f} GiB of {card / 2**30:.2f}; launches {counts}")
    want = dict.fromkeys(REPLACES, 0)
    want.update(zstats=DENSE_STEPS + 1,
                flash_attention=DENSE_STEPS * cfg.n_layers * forwards(cfg),
                flash_attention_bwd=DENSE_STEPS * cfg.n_layers)
    if counts != want:
        raise AssertionError(f"dense launches {counts} != {want}")
    if not all(math.isfinite(x) for x in res.losses) or not last < first:
        raise AssertionError(f"dense loss not finite or did not fall: "
                             f"{first} -> {last}")
    if peak >= card:
        raise AssertionError(f"dense peak memory {peak} >= the card's {card}")
    mgr = CheckpointManager(ckpt)
    if mgr.all_steps() != [DENSE_STEPS]:
        raise AssertionError(f"checkpoints {mgr.all_steps()} != "
                             f"[{DENSE_STEPS}]")
    size = sum(f.stat().st_size for f in Path(ckpt).rglob("*") if f.is_file())
    log(f"[dense] checkpoint of step {DENSE_STEPS}: {size / 1e9:.3f} GB")
    return counts, res.state


def dense_index_checks(cfg, params, ckpt: str) -> tuple:
    """The train -> serve seam at full width: ``serving_index_source(
    quantized=True)`` polls the checkpoint into an ``IndexRefresher`` and a
    ``ServingEngine``; the engine's payload gauge equals ``payload_bytes``
    of the shipped int8 index, which is at most INT8_PAYLOAD_RATIO x a
    bits-32 index of the same head; on 16 queries of the trained model the bits-32 index at
    full beam equals the dense top-k (ties aside), a narrow beam's logits
    are their dequantized dots (1e-4 relative), and requests served
    through the engine equal a direct decode; recall@10 at beams 8, 16,
    32 and the build and poll times are logged.  Returns the int8 and
    the bits-32 index."""
    k = 10
    opt = make_optimizer("adamw", DENSE_LR)
    head = api.head_table(params, cfg).detach()
    shipped = []
    poll = step.serving_index_source(ckpt, cfg, None, opt, quantized=True,
                                     device=DEV)

    def poll_keep():
        got = poll()
        if got is not None:
            shipped.append(got[0])
        return got

    eng = ServingEngine(engine.make_decode_fn(cfg, None, head, k),
                        cfg.d_model, k, buckets=(1, 4, 16),
                        device=DEV).start()
    refresher = None
    t0 = time.perf_counter()
    try:
        refresher = IndexRefresher(eng, poll_keep, poll_s=0.05)
        refresher.start()
        while refresher.swaps == 0 and time.perf_counter() - t0 < 300:
            if refresher.error is not None:
                raise AssertionError(f"refresher failed: {refresher.error}")
            time.sleep(0.05)
        poll_s = time.perf_counter() - t0
        if refresher.swaps != 1:
            raise AssertionError("the checkpoint was never shipped")
        idx8 = shipped[0]
        counters = eng.counters()
        with torch.no_grad():
            tokens = next(batch_iterator_for(cfg, None, 4, 256, seed=1000,
                                             device=DEV))["tokens"]
            hq, _ = transformer.hidden_states(params, tokens, cfg)
            hq = hq[:, -4:].reshape(16, -1)
        served = [eng.decode(x) for x in hq.float().cpu().numpy()]
    finally:
        if refresher is not None:
            refresher.stop()
        eng.stop()
    t1 = time.perf_counter()
    idx32 = quantized_index.build_quantized_index(
        head, codewords=cfg.midx_codewords, codebooks=cfg.midx_codebooks,
        list_size=cfg.sampler_block, bits=32, vocab_size=cfg.vocab_size)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    p8, p32 = payload_bytes(idx8), payload_bytes(idx32)
    log(f"[dense] quantized index: {idx8.num_lists_shard} lists of "
        f"{idx8.list_size} ({int((idx8.cnt == 0).sum())} empty), int8 "
        f"payload {p8} bytes, bits-32 {p32} ({p8 / p32:.4f}); gauge "
        f"{counters['index_payload_bytes']}; poll to swap {poll_s:.3f} s "
        f"(restore + build), bits-32 build {build_s:.3f} s")
    if counters["index_payload_bytes"] != p8 or not isinstance(
            idx8, quantized_index.QuantizedRetrievalIndex) or idx8.bits != 8:
        raise AssertionError(f"payload gauge {counters['index_payload_bytes']}"
                             f" != payload_bytes {p8}")
    if p8 > INT8_PAYLOAD_RATIO * p32:
        raise AssertionError(f"int8 index {p8} > {INT8_PAYLOAD_RATIO} x "
                             f"bits-32 {p32}")
    ids32, _ = quantized_index.decode_topk(idx32, hq, k)
    dids, dlog = retrieval.dense_topk(head, hq, k, n_valid=cfg.vocab_size)
    swaps = check_topk_ties("bits-32 full beam", ids32, dids, dlog, k)
    ids8, log8 = quantized_index.decode_topk(idx8, hq, k, beam=8)
    where = torch.argsort(idx8.perm.long())
    pos = where[ids8.long()]
    rows = idx8.rows.reshape(-1, cfg.d_model)[pos].float() * \
        idx8.scale.reshape(-1)[pos][..., None]
    dots = torch.einsum("tkd,td->tk", rows, hq.float())
    rel = float(((log8 - dots).abs() / dots.abs().clamp(min=1e-30)).max())
    if rel > 1e-4:
        raise AssertionError(f"narrow-beam logits off their dequantized "
                             f"dots by {rel} relative")
    direct, _ = quantized_index.decode_topk(idx8, hq, k)
    got = np.stack([r.ids for r in served])
    if not all(r.ok for r in served) or not np.array_equal(
            got, direct.cpu().numpy()):
        raise AssertionError("served ids != a direct decode of the index")
    recall = {b: quantized_index.recall_at_k(idx8, head, hq, k, b)
              for b in (8, 16, 32)}
    log(f"[dense] bits-32 full beam = dense top-{k} on 16 queries ({swaps} "
        f"tie swaps); int8 beam 8 logits vs dequantized dots: max rel "
        f"{rel}; recall@{k} of the int8 index at beams 8 / 16 / 32: "
        f"{recall}; 16 requests served through the engine")
    return idx8, idx32


def dense_decode(cfg, params, idx8, idx32) -> None:
    """Prefill of 4 prompts of 512 (flash_attention once per layer), then
    16 top-k steps (k 10) through the int8 index at beam 16, and the same
    16 steps through the bits-32 index at full beam beside the dense head
    fed the same tokens: greedy ids equal, ties aside.  Times and the
    int8 chain's agreement with the dense argmax are logged."""
    k, steps, s = 10, 16, 512
    tokens = next(batch_iterator_for(cfg, None, 4, s, seed=77,
                                     device=DEV))["tokens"]
    max_len = s + steps + 1
    prefill = engine.make_prefill_step(cfg, None, max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, caches = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pos = torch.full((4,), s, dtype=torch.long, device=DEV)
    served = engine.make_topk_step(cfg, None, k, index=idx8, beam=16)
    t8, c8, agree8, times = tok[:, None].long(), caches, 0, []
    dense_step = engine.make_topk_step(cfg, None, k)
    for i in range(steps):
        c_dense = [{n: x.clone() for n, x in c.items()} for c in c8]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, _, c8 = served(params, t8, c8, pos + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        dids, _, _ = dense_step(params, t8, c_dense, pos + i)
        agree8 += int((ids[:, 0] == dids[:, 0]).sum())
        t8 = ids[:, :1].long()
    tok32, caches32 = prefill(params, {"tokens": tokens})
    tok_d, caches_d = tok32[:, None].long(), [
        {n: x.clone() for n, x in c.items()} for c in caches32]
    step32 = engine.make_topk_step(cfg, None, k, index=idx32)
    swaps = 0
    t32 = tok_d
    for i in range(steps):
        ids32, _, caches32 = step32(params, t32, caches32, pos + i)
        dids, dlog, caches_d = dense_step(params, t32, caches_d, pos + i)
        swaps += check_topk_ties(f"bits-32 top-k step {i}", ids32, dids,
                                 dlog, k)
        t32 = dids[:, :1].long()
    step_ms = statistics.median(times)
    log(f"[dense] prefill 4 x {s}: {prefill_ms:.2f} ms; {steps} top-{k} "
        f"steps through the int8 index at beam 16: median {step_ms:.2f} ms "
        f"({4e3 / step_ms:.1f} tokens/s), greedy ids equal to the dense "
        f"head's at {agree8} of {4 * steps}; bits-32 full-beam chain equal "
        f"to the dense top-{k} at every step ({swaps} tie swaps)")


def copy_params(model, values) -> None:
    """Each parameter of ``model`` set to its value in ``values``, in
    place.  A function of its own: a loop variable left in the caller
    would keep the last parameter, a view of its whole stacked segment,
    allocated (2.3 GB of starcoder2-3b's ``w_down``)."""
    with torch.no_grad():
        for p, v in zip(model.parameters(), values):
            p.copy_(v)


def phase_dense() -> dict[str, int]:
    """Phase 18: starcoder2-3b at full width (DENSE_LAYERS of its 30
    layers, d 3,072, 24 / 2 heads of 128, d_ff 12,288, vocab 49,152, bf16, layernorm, tanh gelu,
    QKV bias) trained through ``fit`` with its default sampler
    (block-quadratic-shared, m 2,048, rank 64, blocks of 512) on a cycled
    pool of DENSE_POOL batches of DENSE_BATCH x DENSE_SEQ, checkpointing,
    then served through the quantized index.  Returns the fit's counts."""
    cfg = dataclasses.replace(get_config(DENSE_ARCH),
                              n_layers=DENSE_LAYERS)
    torch.cuda.empty_cache()
    before = allocated_gb()
    log(f"[dense] {before:.3f} GB allocated before the phase")
    data = batch_iterator_for(cfg, None, DENSE_BATCH, DENSE_SEQ, seed=0,
                              device=DEV)
    pool = [next(data) for _ in range(DENSE_POOL)]
    err = dense_grad_check(cfg, pool[0])
    log(f"[dense] {allocated_gb():.3f} GB allocated after the gradient "
        "check")
    ckpt = str(Path(__file__).resolve().parent / "build" / "chip_smoke_dense")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        counts, state = dense_fit(cfg, pool, ckpt)
        n_params = sum(p.numel() for p in state.params.parameters())
        log(f"[dense] {n_params} parameters "
            f"({n_params * 2 / 1e9:.2f} GB in bf16)")
        params = state.params
        with torch.no_grad():  # the profile's steps move the parameters
            trained = [p.detach().clone() for p in params.parameters()]
        phase_profile(cfg, state, steps=2, batches=pool[1:3])
        del state
        copy_params(params, trained)
        del trained
        torch.cuda.empty_cache()
        log(f"[dense] {allocated_gb():.3f} GB allocated after the fit and "
            f"the profile ({params_gb(params):.3f} GB of parameters)")
        idx8, idx32 = dense_index_checks(cfg, params, ckpt)
        log(f"[dense] {allocated_gb():.3f} GB allocated after the index "
            "checks")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    dense_decode(cfg, params, idx8, idx32)
    log(f"[dense] {allocated_gb():.3f} GB allocated after the decode")
    del params, idx8, idx32, pool, data
    torch.cuda.empty_cache()
    after = allocated_gb()
    log(f"[dense] worst first-step gradient error over max|plain| {err}; "
        f"{after:.3f} GB allocated after the phase ({before:.3f} before)")
    if after - before > LEFTOVER_GB:
        leftover_report("dense")
        raise AssertionError(f"phase 18 left {after - before:.3f} GB "
                             f"allocated (over {LEFTOVER_GB})")
    return counts


# --- phase 19: the MoE, SSM and hybrid families' serving ---------------------

#: jamba-v0.1-52b's depth on one card: its first two attention periods (16
#: of 32 layers: attention at 4 and 12, MoE at every odd layer), ~26 B
#: bf16 parameters, ~52 GB; the whole model, ~105 GB, fits no 80 GB card
JAMBA_LAYERS = 16
#: decode = forward for an MoE model needs a capacity at which no
#: assignment drops at either T (the reference's tests/test_serve.py:16-23)
NO_DROP_FACTOR = 16.0
#: the MoE layer in bf16 against a plain per-expert fp32 evaluation of the
#: same kept assignments, as a fraction of max|plain|: the bf16 path
#: rounds gate, up, silu(gate), their product, the down product, its
#: weighting and the sum of the k = 2 contributions to bf16, seven
#: roundings of 2^-9 of their own values (7 x 2^-9 < 2^-6), and twice
#: that where the two contributions partly cancel
MOE_RTOL = 2.0 ** -5
#: the ragged prompt of the mamba state check: longer than the scan's
#: 256-step chunk and not a multiple of it
RAGGED_PROMPT = 300


def attn_layers(cfg) -> int:
    return sum(n for kind, n in transformer.segments_of(cfg)
               if kind.startswith("attn"))


def moe_plain(p: dict, x2d: torch.Tensor, cfg) -> tuple[torch.Tensor, int]:
    """The MoE layer (without shared experts: jamba has none) evaluated
    per expert in fp32 over the assignments that ``moe``'s own routing and
    slotting keep.  Returns (y (T, d) fp32, the dropped assignments)."""
    cap = moe.capacity(x2d.shape[0], cfg)
    ids, w, _ = moe._route(p, x2d, cfg)
    _, keep = moe._slots(ids, cfg.n_experts, cap)
    y = torch.zeros(x2d.shape, dtype=torch.float32, device=x2d.device)
    for e in range(cfg.n_experts):
        t, j = ((ids == e) & keep).nonzero(as_tuple=True)
        xe = x2d[t].float()
        h = torch.nn.functional.silu(xe @ p["w_gate"][e].float()) * (
            xe @ p["w_up"][e].float())
        y.index_add_(0, t, (h @ p["w_down"][e].float())
                     * w[t, j].float()[:, None])
    return y, int((~keep).sum())


def moe_layer_checks(cfg, params, prompts: torch.Tensor, tag: str) -> None:
    """The first MoE layer held against ``moe_plain`` on the inputs the
    path gives it: its input in a prefill of the prompts (T 2,048) and in
    the decode step after it (T 4), captured on the way."""
    seen = []
    real = moe.apply_moe

    def spy(p, x, cfg_, *args, **kwargs):
        if len(seen) < len(calls):
            seen.append((p, x.detach().clone()))
        return real(p, x, cfg_, *args, **kwargs)

    calls = []
    moe.apply_moe = spy
    try:
        calls.append("prefill")
        _, caches = transformer.prefill(params, prompts, cfg,
                                        max_len=LLAMA_MAX_LEN)
        calls.append("decode")
        pos = torch.full((prompts.shape[0],), prompts.shape[1],
                         dtype=torch.long, device=DEV)
        transformer.decode_step(params, prompts[:, -1:], caches, pos, cfg)
    finally:
        moe.apply_moe = real
    for (p, x), what in zip(seen, calls):
        x2d = x.reshape(-1, cfg.d_model)
        t = x2d.shape[0]
        y, _ = moe.apply_moe(p, x, cfg)
        want, dropped = moe_plain(p, x2d, cfg)
        compare(f"{tag} MoE layer at the {what}'s shape (T {t}, capacity "
                f"{moe.capacity(t, cfg)}; {dropped} of "
                f"{t * cfg.moe_top_k} assignments dropped)",
                y.reshape(t, -1), want, rtol=MOE_RTOL)


def mamba_state_check(cfg, params, rng: np.random.Generator, tag: str,
                      rtol: float = DECODE_RTOL,
                      rel_rms: float = DECODE_REL_RMS) -> None:
    """The reference's padded-state fault (ROADMAP.md C) on the card: after
    a RAGGED_PROMPT-token prefill, every mamba layer's SSM cache equals the
    state a token-by-token decode chain reaches over the same tokens, and
    the next decode step's h equals the forward at that position, each
    within ``rtol`` x max|want| per element and ``rel_rms`` (each layer's
    state, and h)."""
    s, b = RAGGED_PROMPT, LLAMA_BATCH
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (b, s + 1))).to(DEV)
    _, caches = transformer.prefill(params, tokens[:, :s], cfg,
                                    max_len=s + 1)
    chain = transformer.init_cache(cfg, b, s + 1, device=DEV)
    for t in range(s):
        pos = torch.full((b,), t, dtype=torch.long, device=DEV)
        _, chain = transformer.decode_step(params, tokens[:, t:t + 1], chain,
                                           pos, cfg)
    rms = []
    for got, want in zip(caches, chain):
        if "ssm" in got:
            compare(f"{tag} prefill's SSM state after {s} tokens vs the "
                    "decode chain's", got["ssm"], want["ssm"], rtol=rtol)
            rms += [float(_rel_rms(g, w))
                    for g, w in zip(got["ssm"], want["ssm"])]
    pos = torch.full((b,), s, dtype=torch.long, device=DEV)
    h_dec, _ = transformer.decode_step(params, tokens[:, s:], caches, pos,
                                       cfg)
    with torch.no_grad():
        h_full, _ = transformer.hidden_states(params, tokens, cfg)
    compare(f"{tag} decode h at position {s} vs forward", h_dec[:, 0],
            h_full[:, s], rtol=rtol)
    rms_h = float(_rel_rms(h_dec[:, 0], h_full[:, s]))
    log(f"[{tag}] padded-state check at S {s}: per-layer state relative "
        f"RMS max {max(rms)} mean {statistics.mean(rms)}, next h relative "
        f"RMS {rms_h} (tolerance {rel_rms})")
    if max(rms + [rms_h]) > rel_rms:
        raise AssertionError(f"{tag}: the state after {s} tokens or the "
                             f"next h is off by a relative RMS above "
                             f"{rel_rms}")


def phase_hybrid_serving(gen: torch.Generator, rng: np.random.Generator
                         ) -> tuple[dict[str, dict[str, int]],
                                    dict[str, dict]]:
    """Phase 19: falcon-mamba-7b at full width and depth, then
    jamba-v0.1-52b at full width and JAMBA_LAYERS of its layers, each
    through ``lm_serving`` (the first freed before the second is built):
    zstats once, leaf_scores once per index top-k step, jamba's
    flash_attention once per attention layer on the tensor-core entry.
    Then falcon-mamba's decode against its forward, the padded-state
    check and its index's kernels against their plain versions; jamba's
    prefill against its forward at its own capacity factor, decode
    against the forward at NO_DROP_FACTOR, and its MoE layer against a
    plain fp32 evaluation.  Returns (launch counts by path, falcon-mamba's
    index-shape kernel rows)."""
    by_path: dict[str, dict[str, int]] = {}

    tag = "falcon-mamba-7b"
    cfg = get_config(tag)
    params = init_lm_params(cfg, gen, tag)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_PROMPT))).to(DEV)
    run = lm_serving(cfg, params, prompts, tag,
                     dict(zstats=1, leaf_scores=2))
    by_path[tag] = run.counts
    h_full = check_decode_matches_forward(params, cfg, run.tokens, tag,
                                          rel_rms=decode_rel_rms(cfg))
    agree = _greedy_agreement(h_full, run.head, cfg, run.tokens)
    log(f"[{tag}] greedy tokens equal the full forward's argmax at {agree} "
        f"of {LLAMA_BATCH * (LLAMA_DECODE + 1)} positions (bf16, not "
        f"gated)")
    del h_full
    # the same weights computed in fp32: the path's logic, apart from bf16
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    check_decode_matches_forward(params, cfg32, run.tokens, f"{tag} fp32",
                                 rtol=FP32_DECODE_RTOL,
                                 rel_rms=FP32_DECODE_REL_RMS)
    mamba_state_check(cfg32, params, rng, f"{tag} fp32",
                      rtol=FP32_DECODE_RTOL, rel_rms=FP32_DECODE_REL_RMS)
    index_rows = index_kernel_rows(run.index, run.h, tag)
    log_timing(tag, run.timing)
    del params, run
    torch.cuda.empty_cache()

    tag = "jamba-v0.1-52b"
    cfg = dataclasses.replace(get_config(tag), n_layers=JAMBA_LAYERS)
    params = init_lm_params(cfg, gen, tag)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_PROMPT))).to(DEV)
    run = lm_serving(cfg, params, prompts, tag, dict(
        zstats=1, flash_attention=attn_layers(cfg), leaf_scores=2))
    by_path[tag] = run.counts
    log(f"[{tag}] all {run.counts['flash_attention']} prefill attentions "
        f"went through the tensor-core flash kernel, none through the "
        f"CUDA-core one")
    with torch.no_grad():
        h_full, _ = transformer.hidden_states(params, prompts, cfg)
    h_pre, _ = transformer.prefill(params, prompts, cfg)
    compare(f"{tag} prefill h vs forward at capacity factor "
            f"{cfg.capacity_factor} (the same T: the same drops)", h_pre,
            h_full, rtol=DECODE_RTOL)
    rms = float(_rel_rms(h_pre, h_full))
    if rms > DECODE_REL_RMS:
        raise AssertionError(f"{tag} prefill h vs forward: relative RMS "
                             f"{rms} > {DECODE_REL_RMS}")
    del h_full, h_pre
    check_decode_matches_forward(
        params, dataclasses.replace(cfg, capacity_factor=NO_DROP_FACTOR),
        run.tokens, f"{tag} at capacity factor {NO_DROP_FACTOR}",
        rel_rms=decode_rel_rms(cfg))
    moe_layer_checks(cfg, params, prompts, tag)
    log_timing(tag, run.timing)
    del params, run
    torch.cuda.empty_cache()
    return by_path, index_rows


# --- phase 20: training the SSM, hybrid and MoE families --------------------

#: jamba-v0.1-52b's training depth on one card: its first attention period,
#: 8 of 32 layers, the fewest that hold every layer kind (mamba+mlp,
#: mamba+moe, the attention at 4); 13.30 B parameters, 26.6 GB of bf16
#: weights and as much again of gradients
JAMBA_TRAIN_LAYERS = 8
#: falcon-mamba-7b's training depth: 16 of its 64 layers (whole until
#: phase 24 joined the script, 32 until phase 25 did; its 8 steps at 64
#: took ~56 s of the run's 1,200; phase 20 took 120.0 s at 32, 86.5 s at
#: 16 and 74.3 s at 8 on an H100 80GB HBM3 at 700 W)
FALCON_TRAIN_LAYERS = 16
#: the gradient checks' depths: falcon-mamba's first 2 layers; jamba's
#: first 5, whose last is its attention layer, so no MoE routing after the
#: attention can turn the plain attention's rounding into a routing flip
CHECK_LAYERS = {"falcon-mamba-7b": 2, "jamba-v0.1-52b": 5}
#: sequences of HYBRID_SEQ tokens a step: falcon-mamba's config trains in
#: one microbatch, jamba's in its own 8 (one sequence each)
HYBRID_BATCH = {"falcon-mamba-7b": 4, "jamba-v0.1-52b": 8}
HYBRID_SEQ = 512
HYBRID_STEPS = 8
HYBRID_POOL = 4
#: Adafactor's learning rate: its updates are clipped to an RMS of 1, so
#: each weight moves by about this much a step, ~0.6% of a bf16 weight
#: of ~1/64 at d 4,096 (at 1e-3, 6% a step, falcon-mamba's 64 layers
#: diverged within four steps on the card)
HYBRID_LR = 1e-4
#: the gradients with cfg.remat against without, where they are not
#: bitwise equal, as a fraction of max|without|: the recompute runs the
#: same kernels on the same inputs, so only a kernel that sums in an order
#: of its own choosing (atomics) can differ, by its rounding in the
#: gradient's dtype (bf16: 2^-8)
REMAT_RTOL = 2.0 ** -8


def hybrid_cfg(tag: str, layers: int | None = None):
    cfg = get_config(tag)
    cfg = dataclasses.replace(cfg, n_layers=JAMBA_TRAIN_LAYERS
                              if tag == "jamba-v0.1-52b"
                              else FALCON_TRAIN_LAYERS)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def remat_grad_check(cfg, batch, tag: str, host: bool = False) -> None:
    """The first step's loss (with the MoE aux, the step's weight 0.01) at
    its own fixed shared negatives differentiated with ``cfg.remat`` and
    without, on the same weights: the losses equal and every parameter's
    gradient bitwise equal, or within REMAT_RTOL x max|without| with the
    parameters that differ logged.  ``host`` keeps the first run's
    gradients in host memory while the second runs (a model whose two
    gradient sets and weights would not fit on the card together)."""
    opt = make_optimizer("sgd", 0.0)
    state = step.init_train_state(torch.Generator(DEV).manual_seed(0), cfg,
                                  None, opt, device=DEV)
    model = state.params
    labels, neg, logq = fixed_negatives(cfg, model, state.sampler_state,
                                        batch)
    params = step.param_dict(model)
    est = estimators.make_estimator(cfg.estimator)

    def grads(remat: bool):
        c = dataclasses.replace(cfg, remat=remat)
        h, _, aux = api.backbone_hidden(model, batch, c)
        loss = torch.mean(estimators.loss_from_embeddings(
            est, api.head_table(model, c), h, labels, neg, logq,
            abs_mode=c.abs_softmax, impl=c.head_impl)) + 0.01 * aux
        return loss.item(), grads_or_zeros(loss, params)

    def peak_over(fn):
        """fn()'s result and its peak device memory over what was
        allocated when it began (the other run's gradients aside)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        out = fn()
        return out, torch.cuda.max_memory_allocated() - start

    (loss_a, ga), peak_a = peak_over(lambda: grads(False))
    if host:
        ga = [g.cpu() for g in ga]
        torch.cuda.empty_cache()
    (loss_b, gb), peak_b = peak_over(lambda: grads(True))
    differ = {}
    for name, a, b in zip(params, ga, gb):
        a = a.to(b.device)
        if not torch.equal(a, b):
            differ[name] = float((a.float() - b.float()).abs().max()) / max(
                float(a.float().abs().max()), 1e-30)
    log(f"[{tag}] remat check at {cfg.n_layers} layers: loss without remat "
        f"{loss_a}, with {loss_b}; {len(params) - len(differ)} of "
        f"{len(params)} parameter gradients bitwise equal"
        + (f", the others within {max(differ.values())} of max|grad| "
           f"({sorted(differ.items(), key=lambda kv: -kv[1])[:6]}): a "
           "kernel summing in its own order" if differ else "")
        + f"; peak over the run's start {peak_a / 2**30:.2f} GiB without, "
        f"{peak_b / 2**30:.2f} with")
    if loss_a != loss_b and abs(loss_a - loss_b) > 1e-6 * abs(loss_a):
        raise AssertionError(f"{tag} loss with remat {loss_b} != without "
                             f"{loss_a}")
    if differ and max(differ.values()) > REMAT_RTOL:
        raise AssertionError(f"{tag} gradients with remat differ from "
                             f"without by {max(differ.values())} > "
                             f"{REMAT_RTOL} of max|grad|")
    del state, model, params, ga, gb
    torch.cuda.empty_cache()


def state_bytes(tree) -> int:
    """Bytes of every tensor in a nested optimizer state."""
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(state_bytes(v) for v in tree)
    return tree.nbytes if isinstance(tree, torch.Tensor) else 0


def attn_calls(cfg) -> int:
    """Attention calls of one forward: each attention layer's one; an
    encoder-decoder's encoder layer one, its decoder layer two (self and
    cross)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers
    return attn_layers(cfg)


def hybrid_fit(cfg, pool, tag: str, opt_name: str = "adafactor",
               lr: float = HYBRID_LR) -> tuple[dict[str, int], object]:
    """HYBRID_STEPS steps of ``fit`` with clip + Adafactor (or
    ``opt_name`` at ``lr``) on the cycled pool: exact launches (zstats
    once per refresh; each attention call's flash_attention once per
    microbatch and forward run, its flash_attention_bwd once per
    microbatch), finite losses whose mean over the last pass of the pool
    is below the first's, peak memory under the card's.  Returns the
    counts, the optimizer and the final state."""
    opt = make_optimizer(opt_name, lr)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = loop.fit(cfg, None, opt, CycledPool(pool), HYBRID_STEPS, seed=0,
                   log_every=1, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    n = len(pool)
    first = statistics.mean(res.losses[:n])
    last = statistics.mean(res.losses[-n:])
    state = res.state
    n_params = sum(p.numel() for p in state.params.parameters())
    mu = max(cfg.microbatches, 1)
    b, s = pool[0]["tokens"].shape
    log(f"[{tag} training] {cfg.n_layers} layers, {n_params} parameters "
        f"({n_params * 2 / 1e9:.2f} GB in bf16); {HYBRID_STEPS} steps of "
        f"{b} x {s} tokens in {mu} microbatch(es), clip + {opt_name} (lr "
        f"{lr}), remat {cfg.remat}: {wall:.3f} s ({wall / HYBRID_STEPS * 1e3:.1f}"
        f" ms/step, the first step included); losses {res.losses}; mean of "
        f"the first pass over the pool {first}, of the last {last}; peak "
        f"device memory {peak / 2**30:.2f} GiB of {card / 2**30:.2f}; "
        f"{opt_name} state {state_bytes(state.opt_state)} bytes; launches "
        f"{counts}")
    if cfg.family != "encdec":
        with torch.no_grad():
            _, aux = transformer.hidden_states(state.params,
                                               pool[0]["tokens"], cfg)
        log(f"[{tag} training] the MoE aux on the pool's first batch after "
            f"training: {float(aux)}")
    # the mtp block's attention runs once a microbatch (never
    # rematerialized), beside the backbone's
    attn, mtp = attn_calls(cfg), int(cfg.mtp)
    want = dict.fromkeys(REPLACES, 0)
    want.update(zstats=HYBRID_STEPS + 1,
                flash_attention=HYBRID_STEPS * mu * (attn * forwards(cfg)
                                                     + mtp),
                flash_attention_bwd=HYBRID_STEPS * mu * (attn + mtp))
    if counts != want:
        raise AssertionError(f"{tag} training launches {counts} != {want}")
    if not all(math.isfinite(x) for x in res.losses) or not last < first:
        raise AssertionError(f"{tag} training loss not finite or did not "
                             f"fall: {first} -> {last}")
    if peak >= card:
        raise AssertionError(f"{tag} training peak memory {peak} >= the "
                             f"card's {card}")
    del res
    return counts, opt, state


def phase_hybrid_train() -> dict[str, dict[str, int]]:
    """Phase 20: falcon-mamba-7b at FALCON_TRAIN_LAYERS, then
    jamba-v0.1-52b at
    JAMBA_TRAIN_LAYERS of its layers (the first freed before the second is
    built), each trained through ``fit`` with its default sampler
    (block-quadratic-shared, zstats each refresh) and clip + Adafactor,
    remat on (the configs'): first the remat check at CHECK_LAYERS (and
    jamba's attention gradients through the kernels against the plain
    attention's, ``dense_grad_check``), then ``hybrid_fit`` and a profile
    of one step.  Returns the fits' launch counts by path."""
    by_path: dict[str, dict[str, int]] = {}
    for tag in ("falcon-mamba-7b", "jamba-v0.1-52b"):
        cfg = hybrid_cfg(tag)
        data = batch_iterator_for(cfg, None, HYBRID_BATCH[tag], HYBRID_SEQ,
                                  seed=0, device=DEV)
        pool = [next(data) for _ in range(HYBRID_POOL)]
        check = hybrid_cfg(tag, CHECK_LAYERS[tag])
        probe = {k: v[:4] for k, v in pool[0].items()}
        remat_grad_check(check, probe, tag)
        if attn_layers(check):
            err = dense_grad_check(check, probe, tag=tag)
            log(f"[{tag}] worst first-step gradient error over max|plain| "
                f"{err} ({check.n_layers} layers)")
        torch.cuda.empty_cache()
        counts, opt, state = hybrid_fit(cfg, pool, tag)
        by_path[f"{tag} training"] = counts
        phase_profile(cfg, state, steps=1, batches=pool[1:2], opt=opt)
        del state, opt, pool, data
        torch.cuda.empty_cache()
        log(f"[{tag} training] {allocated_gb():.3f} GB allocated after")
    return by_path


# --- phases 21b-21c: deepseek-v3-671b's MLA and multi-token prediction ------

#: deepseek-v3-671b's depth on one card: its three dense layers and its
#: first MoE layer, the fewest that hold every layer kind, 4 of 61 layers:
#: 15.8 B parameters, 31.6 GB of bf16 weights (5 layers would take 54.6 GB
#: before the serving index, or the training gradients)
DEEPSEEK_LAYERS = 4
#: training: the config's 2 microbatches of one 512-token sequence
DEEPSEEK_BATCH = 2


def deepseek_cfg(layers: int = DEEPSEEK_LAYERS, **changes):
    return dataclasses.replace(get_config("deepseek-v3-671b"),
                               n_layers=layers, **changes)


def phase_deepseek_serving(gen: torch.Generator, rng: np.random.Generator
                           ) -> dict[str, int]:
    """Phase 21b: deepseek-v3-671b at full width and DEEPSEEK_LAYERS of
    its layers through ``lm_serving`` (zstats once, flash_attention once
    per MLA layer on the tensor-core entry at (192, 128), leaf_scores once
    per index top-k step; decode runs the absorbed form over the latent
    cache): the latent cache's bytes a token, prefill against the forward
    at the config's capacity factor, decode against the forward in bf16 at
    NO_DROP_FACTOR with the forward's routing imposed, and in fp32 compute
    over the dense layers (MLA's absorbed decode against the expanded
    forward; the MoE layer's bf16 expert stacks cast to fp32 would take 45
    GB beside the weights).  Returns the path's launch counts."""
    tag = "deepseek-v3-671b"
    cfg = deepseek_cfg()
    params = init_lm_params(cfg, gen, tag)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_PROMPT))).to(DEV)
    run = lm_serving(cfg, params, prompts, tag, dict(
        zstats=1, flash_attention=attn_layers(cfg), leaf_scores=2))
    log(f"[{tag}] all {run.counts['flash_attention']} prefill attentions "
        f"went through the tensor-core flash kernel at (hd 192, hv 128), "
        f"none through the CUDA-core one")
    # a layer's latent row against an MHA cache of the expanded form (each
    # head's key and value) and llama3-8b's GQA cache (8 KV heads of 128,
    # K and V), all bf16
    latent = cfg.kv_lora_rank + cfg.qk_rope_dim
    per_token = sum(c.nbytes for c in run.caches) / (
        LLAMA_BATCH * LLAMA_MAX_LEN)
    want = latent * 2 * attn_layers(cfg)
    mha = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim
                         + cfg.v_head_dim) * 2 * attn_layers(cfg)
    gqa = 2 * 8 * 128 * 2 * attn_layers(cfg)
    log(f"[{tag}] latent cache {per_token:.0f} bytes a token over "
        f"{attn_layers(cfg)} layers ({latent} bf16 a layer); the "
        f"expanded form's MHA cache would hold {mha} ({mha / want:.1f}x), "
        f"llama3-8b's GQA cache {gqa} ({gqa / want:.2f}x)")
    if per_token != want:
        raise AssertionError(f"{tag}: latent cache {per_token} bytes a "
                             f"token != {want}")
    with torch.no_grad():
        h_full, _ = transformer.hidden_states(params, prompts, cfg)
    h_pre, _ = transformer.prefill(params, prompts, cfg)
    compare(f"{tag} prefill h vs forward at capacity factor "
            f"{cfg.capacity_factor} (the same T: the same drops)", h_pre,
            h_full, rtol=DECODE_RTOL)
    rms = float(_rel_rms(h_pre, h_full))
    if rms > DECODE_REL_RMS:
        raise AssertionError(f"{tag} prefill h vs forward: relative RMS "
                             f"{rms} > {DECODE_REL_RMS}")
    del h_full, h_pre
    h_full = check_decode_matches_forward(
        params, dataclasses.replace(cfg, capacity_factor=NO_DROP_FACTOR),
        run.tokens, f"{tag} at capacity factor {NO_DROP_FACTOR}",
        rel_rms=decode_rel_rms(cfg))
    agree = _greedy_agreement(h_full, run.head, cfg, run.tokens)
    log(f"[{tag}] greedy tokens equal the full forward's argmax at {agree} "
        f"of {LLAMA_BATCH * (LLAMA_DECODE + 1)} positions (bf16, not "
        f"gated)")
    del h_full
    torch.cuda.empty_cache()
    # the dense layers computed in fp32 from the same bf16 weights: the
    # absorbed decode's logic against the expanded forward, apart from bf16
    cfg32 = deepseek_cfg(cfg.first_dense_layers, dtype="float32")
    dense = {**params, "segments": params["segments"][:1]}
    check_decode_matches_forward(dense, cfg32, run.tokens,
                                 f"{tag} fp32 at {cfg32.n_layers} layers",
                                 rtol=FP32_DECODE_RTOL,
                                 rel_rms=FP32_DECODE_REL_RMS)
    log_timing(tag, run.timing)
    counts = run.counts
    del params, run, dense
    torch.cuda.empty_cache()
    return counts


def phase_deepseek_train() -> dict[str, dict[str, int]]:
    """Phase 21c: deepseek-v3-671b at DEEPSEEK_LAYERS with its mtp module,
    trained through ``fit`` with the config's sampler
    (block-quadratic-shared, m 2,048), clip + Adafactor at HYBRID_LR, its
    2 microbatches of one 512-token sequence and remat: first the remat
    check at the full depth (the first run's gradients in host memory),
    then the attention's gradients through the kernels against the plain
    attention's and the mtp block's (S 511, a ragged
    S at hd 192) over the dense layers (no MoE routing follows an
    attention whose plain version rounds otherwise), then ``hybrid_fit``
    (exact launches, falling pool loss,
    peak) and a profile of one step.  Returns the fit's launch counts."""
    tag = "deepseek-v3-671b"
    cfg = deepseek_cfg()
    data = batch_iterator_for(cfg, None, DEEPSEEK_BATCH, HYBRID_SEQ, seed=0,
                              device=DEV)
    pool = [next(data) for _ in range(HYBRID_POOL)]
    remat_grad_check(cfg, pool[0], tag, host=True)
    torch.cuda.empty_cache()
    check = deepseek_cfg(cfg.first_dense_layers)
    err = dense_grad_check(check, pool[0], tag=tag)
    log(f"[{tag}] worst first-step gradient error over max|plain| {err} "
        f"({check.n_layers} layers and the mtp block)")
    torch.cuda.empty_cache()
    counts, opt, state = hybrid_fit(cfg, pool, tag)
    phase_profile(cfg, state, steps=1, batches=pool[1:2], opt=opt)
    del state, opt, pool, data
    torch.cuda.empty_cache()
    log(f"[{tag} training] {allocated_gb():.3f} GB allocated after")
    return {f"{tag} training": counts}


# --- phases 22b-22c: whisper-large-v3's encoder-decoder -----------------------

#: whisper's decoder context (448 text tokens): the self cache's positions
WHISPER_MAX_LEN = WHISPER_TEXT
#: AdamW's learning rate of the whisper run, starcoder2-3b's
WHISPER_LR = DENSE_LR
#: the decode-vs-teacher-forced RMS bound: decode_rel_rms's rule over the
#: decoder's 32 layers (the encoder's output is one tensor on both sides),
#: DECODE_REL_RMS itself
WHISPER_DECODE_REL_RMS = DECODE_REL_RMS


def whisper_frames(gen: torch.Generator, cfg, b: int) -> torch.Tensor:
    """(B, WHISPER_FRAMES, d) unit-normal frame embeddings (the frontend
    stub's output) in the compute dtype."""
    return torch.randn((b, WHISPER_FRAMES, cfg.d_model), generator=gen,
                       device=DEV).to(layers._dtype(cfg))


def init_whisper(cfg, gen: torch.Generator, tag: str):
    """Seeded random weights of the whole model on the card (position
    tables of the reference's 4,096 rows), logged with the parameters of
    an encoder layer, a decoder layer, the embedding, the head and a
    position table; the peak memory statistics reset first."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()

    def count(tree):
        return sum(t.numel() for t in _leaves(tree))

    log(f"[{tag}] {cfg.name}: {cfg.n_enc_layers} + {cfg.n_dec_layers} "
        f"layers, d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.norm}, {cfg.act}, learned positions, {cfg.dtype}: "
        f"{count(params)} parameters (an encoder layer "
        f"{count(params['enc_blocks']) // cfg.n_enc_layers}, a decoder layer "
        f"{count(params['dec_blocks']) // cfg.n_dec_layers}, the embedding "
        f"{count(params['embed'])}, the head {count(params['head'])}, a "
        f"position table {count(params['enc_pos'])}), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, init "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def check_whisper_decode(params, cfg, frames: torch.Tensor,
                         tokens: torch.Tensor, tag: str, rtol: float,
                         rel_rms: float) -> dict[str, int]:
    """The reference's ``tests/test_serve.py`` contract at full width: a
    chain of LLAMA_DECODE + 1 decode steps (the prefill's step from token
    0, then the greedy ones) from ``init_dec_cache`` against
    ``decode_train`` over the same tokens and the same encoder output,
    each step's h within ``rtol`` of max |h_forward| element by element
    and ``rel_rms`` in relative RMS.  The attention launches of the check
    (the encoder's, the teacher-forced decoder's self and cross attention
    at Sq 33, Sk 1,500) are counted apart: returned."""
    n, b = LLAMA_DECODE + 1, tokens.shape[0]
    kernels.reset_launch_counts()
    with torch.no_grad():
        enc = encdec.encode(params, frames, cfg)
        h_tf = encdec.decode_train(params, tokens[:, :n], enc, cfg)
        cache = encdec.init_dec_cache(params, cfg, b, WHISPER_MAX_LEN, enc)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    errs, rms = [], []
    for t in range(n):
        pos = torch.full((b,), t, dtype=torch.long, device=DEV)
        h_t, cache = encdec.decode_step(params, tokens[:, t:t + 1], cache,
                                        pos, cfg)
        want = h_tf[:, t]
        err = float((h_t[:, 0].float() - want.float()).abs().max())
        if err > rtol * float(want.float().abs().max()):
            compare(f"{tag} decode step {t} h vs teacher-forced", h_t[:, 0],
                    want, rtol=rtol)
        errs.append(err)
        rms.append(float(_rel_rms(h_t[:, 0], want)))
    log(f"[{tag}] decode vs teacher-forced ({cfg.dtype} compute): {n} "
        f"steps, max abs err {max(errs)} (max |h| "
        f"{float(h_tf.float().abs().max())}), relative RMS err max "
        f"{max(rms)} mean {statistics.mean(rms)}; tolerances {rtol} x "
        f"max|h|, relative RMS {rel_rms}; the check's launches {counts}")
    worst = max(range(n), key=rms.__getitem__)
    if rms[worst] > rel_rms:
        raise AssertionError(f"{tag} decode step {worst} h vs teacher-"
                             f"forced: relative RMS {rms[worst]} > "
                             f"{rel_rms}")
    del enc, h_tf, cache
    torch.cuda.empty_cache()
    return counts


def phase_whisper_serving(gen: torch.Generator) -> dict[str, int]:
    """Phase 22b: whisper-large-v3 whole (32 + 32 layers, full width)
    through ``lm_serving`` on WHISPER_SERVE_BATCH clips of WHISPER_FRAMES
    frames: the prefill encodes them (flash_attention once per encoder
    layer, tensor-core, not causal), fills every decoder layer's cross
    K/V and decodes token 0; then the greedy steps and top-k through the
    index (zstats once, leaf_scores once per index top-k step).  Outside
    the counted run: the caches' bytes, decode against the teacher-forced
    decoder in bf16 (its launches exact: every encoder and decoder
    attention on the tensor-core kernel) and in fp32 compute from the same
    weights (the CUDA-core kernel), the encoder's time.  Returns the
    path's launch counts."""
    tag = "whisper-large-v3"
    cfg = get_config(tag)
    params = init_whisper(cfg, gen, tag)
    frames = whisper_frames(gen, cfg, WHISPER_SERVE_BATCH)
    prompts = torch.zeros((WHISPER_SERVE_BATCH, 1), dtype=torch.long,
                          device=DEV)
    run = lm_serving(cfg, params, prompts, tag, dict(
        zstats=1, flash_attention=cfg.n_enc_layers, leaf_scores=2),
        frames=frames, max_len=WHISPER_MAX_LEN)
    log(f"[{tag}] all {run.counts['flash_attention']} encoder attentions "
        f"of the prefill went through the tensor-core flash kernel, none "
        f"through the CUDA-core one")
    cross = run.caches["cross_k"].nbytes + run.caches["cross_v"].nbytes
    own = run.caches["self_k"].nbytes + run.caches["self_v"].nbytes
    log(f"[{tag}] decoder cache: cross K/V {cross / 1e9:.3f} GB "
        f"({tuple(run.caches['cross_k'].shape)} each), self K/V "
        f"{own / 1e9:.3f} GB ({WHISPER_MAX_LEN} positions)")
    calls = attn_calls(cfg)
    got = check_whisper_decode(params, cfg, frames, run.tokens, tag,
                               DECODE_RTOL, WHISPER_DECODE_REL_RMS)
    check_launches(f"{tag} bf16 decode check", got, {
        **dict.fromkeys(REPLACES, 0), "flash_attention": calls})
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    got = check_whisper_decode(params, cfg32, frames.float(), run.tokens,
                               f"{tag} fp32", FP32_DECODE_RTOL,
                               FP32_DECODE_REL_RMS)
    check_launches(f"{tag} fp32 decode check", got, {
        **dict.fromkeys(REPLACES, 0), "flash_attention_simt": calls})
    with torch.no_grad():
        run.timing["encode_ms"] = host_ms(
            lambda: encdec.encode(params, frames, cfg))
    log_timing(tag, run.timing)
    counts = run.counts
    del params, run, frames
    torch.cuda.empty_cache()
    return counts


def whisper_pool(cfg, seed: int = 0, b: int = WHISPER_TRAIN_BATCH,
                 n: int = HYBRID_POOL, ctx=None) -> list[dict]:
    """``n`` training batches of ``b`` clips: frames (B, WHISPER_FRAMES,
    d) and SyntheticLM's tokens and labels (B, WHISPER_TEXT), from a
    ``ShardedBatchIterator`` over this sample function
    (``batch_iterator_for`` gives frames and tokens one length); on a mesh
    ``ctx`` the rank's rows."""
    lm = SyntheticLM(vocab_size=cfg.vocab_size, seed=seed, device=str(DEV))

    def sample(g: torch.Generator) -> dict:
        batch = lm.sample_batch(g, b, WHISPER_TEXT)
        return {"frames": whisper_frames(g, cfg, b), **batch}

    data = ShardedBatchIterator(sample, ctx, seed=seed, device=DEV)
    return [next(data) for _ in range(n)]


def phase_whisper_train() -> dict[str, dict[str, int]]:
    """Phase 22c: whisper-large-v3 whole through ``fit`` with the config's
    sampler (block-quadratic-shared, m 2,048), clip + AdamW at WHISPER_LR
    and the config's remat (every encoder and decoder layer's forward
    again in the backward), HYBRID_STEPS steps on a pool of HYBRID_POOL
    batches of 8 clips of 1,500 frames with 448 tokens: first, on the
    pool's first 4 clips, the remat check and the attention's gradients
    through the kernels against the plain attention's (the cross
    attention's parameters gated on their own), then ``hybrid_fit``
    (exact launches: 3 x 32 attention calls a forward, twice under remat,
    once each in the backward; falling pool loss; peak) and a profile of
    one step.  Returns the fit's launch counts."""
    tag = "whisper-large-v3"
    cfg = get_config(tag)
    pool = whisper_pool(cfg)
    probe = {k: v[:4] for k, v in pool[0].items()}
    remat_grad_check(cfg, probe, tag)
    torch.cuda.empty_cache()
    err = dense_grad_check(cfg, probe, tag=tag, own_gates=(
        ("cross attention", lambda n: ".xattn." in n),))
    log(f"[{tag}] worst first-step gradient error over max|plain| {err} "
        f"({cfg.n_enc_layers} + {cfg.n_dec_layers} layers)")
    torch.cuda.empty_cache()
    counts, opt, state = hybrid_fit(cfg, pool, tag, "adamw", WHISPER_LR)
    phase_profile(cfg, state, steps=1, batches=pool[1:2], opt=opt)
    del state, opt, pool, probe
    torch.cuda.empty_cache()
    log(f"[{tag} training] {allocated_gb():.3f} GB allocated after")
    return {f"{tag} training": counts}


# ---------------------------------------------------------------------------
# Phase 23: the vocab-parallel head over a (data, model) mesh
# ---------------------------------------------------------------------------

#: the gloo meshes the rank processes run, in turn, over one world of
#: MESH_WORLD ranks sharing the card
MESH_SHAPES = ((1, 4), (2, 2))
MESH_WORLD = 4
MESH_STEPS = 8
MESH_POOL = 4
#: queries per rank of the sharded index's full-beam decode: at tp 4 a
#: shard's 256 leaves of 128 rows are gathered per query (268 MB at 16)
MESH_QUERIES = 16
MESH_TOPK = 10
#: the gloo checks' tolerance (max |err| / max |want|) and the NCCL (1, 1)
#: step's against the unsharded step
MESH_RTOL = 1e-5
MESH_STEP_RTOL = 1e-6
#: seconds the parent waits for the rank processes
MESH_TIMEOUT_S = 300
#: the (1, 1) step comparison's optimizer: clip + SGD.  Its update is
#: the clipped gradient times lr, so each parameter's error over its own
#: max shows its gradient's (a bias that starts at 0 holds lr times its
#: gradient).  AdamW's first update, lr g / (|g| + eps), hides a
#: gradient's scale where |g| >> eps (a psum off by tp passes) and
#: multiplies summation-order differences by up to lr / eps where
#: |g| << eps
MESH_STEP_OPT = ("sgd", 1e-2)
#: the sampler families phase 23 trains on each mesh beside
#: block-quadratic: each rank builds, refreshes, samples and corrects from
#: its own vocab shard
MESH_SAMPLERS = FAMILIES
#: the overlap island on the mesh: (family, mesh, cadence, k); at (2, 2)
#: the head's feature dim is sharded over data, so the snapshot gathers it
MESH_OVERLAP = ("midx", (2, 2), 2, 1)
#: the directory the rank processes write their logs and results to
MESH_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
#: the command of a rank process, before its ``--mesh-*`` arguments
MESH_RANK_CMD = (sys.executable, __file__)


class GivenNegatives:
    """A sampler stub: each shard's negatives drawn once on the host,
    whatever the generator (``sample_batch`` returns ``state``'s ids and
    LOCAL log q)."""

    shares_negatives = False
    two_stage = False

    def sample_batch(self, state, h, m, gen):
        if state["ids"].shape[-1] != m:
            raise ValueError(f"{state['ids'].shape} given for m={m}")
        return state["ids"], state["logq"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.detach().float()
    return float((got.detach().float() - want).abs().max()
                 / want.abs().max())


def gate(tag: str, errs: dict[str, float], tol: float) -> None:
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{tag}: relative errors {bad} > {tol}")


def mesh_full_check(ctx, w, h, labels, abs_mode: bool) -> dict[str, float]:
    """The sharded full softmax's loss and gradients (this rank's head
    shard, its h block) against the unsharded loss on the card."""
    mg, j = ctx.model_group, ctx.model_index
    w_l = rules.shard_rows(w, ctx).requires_grad_(True)
    h_l = rules.batch_rows(h, ctx).clone().requires_grad_(True)
    lab = rules.batch_rows(labels, ctx)
    loss = distributed.sharded_full_softmax_loss(
        w_l, distributed.replicated(h_l, mg), lab, group=mg,
        abs_mode=abs_mode)
    loss.sum().backward()
    wf = w.clone().requires_grad_(True)
    hf = h_l.detach().clone().requires_grad_(True)
    want = full_softmax_loss(wf, hf, lab, abs_mode=abs_mode)
    want.sum().backward()
    v_l = w_l.shape[0]
    return {"loss": rel_err(loss, want),
            "dw": rel_err(w_l.grad, wf.grad[j * v_l:(j + 1) * v_l]),
            "dh": rel_err(h_l.grad, hf.grad)}


def mesh_sampled_check(ctx, w, h, labels, m: int, abs_mode: bool,
                       seed: int) -> dict[str, float]:
    """The sharded sampled softmax (the fused head on the card) at given
    negatives (each shard's ids and local logq drawn once on the host,
    an accidental hit on the owning shard every fifth token) against a
    one-device replay of the stratified eq. 2 over the union of the
    shards' negatives, loss and gradients."""
    tp, j, mg = ctx.tp, ctx.model_index, ctx.model_group
    v_l, m_l = w.shape[0] // tp, m // tp
    t = h.shape[0]
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v_l, size=(t, tp, m_l))
    lab = labels.cpu().numpy()
    for k in range(0, t, 5):
        ids[k, lab[k] // v_l, 0] = lab[k] % v_l
    logq = np.log(rng.uniform(1e-6, 1e-4, size=ids.shape))
    rows = rules.batch_rows(torch.arange(t, device=DEV), ctx)
    ids_t = torch.from_numpy(ids).to(DEV)[rows]
    logq_t = torch.from_numpy(logq).float().to(DEV)[rows]
    w_l = rules.shard_rows(w, ctx).requires_grad_(True)
    h_l = rules.batch_rows(h, ctx).clone().requires_grad_(True)
    lab_l = labels[rows]
    loss = distributed.sharded_sampled_softmax_loss(
        w_l, distributed.replicated(h_l, mg), lab_l, GivenNegatives(),
        {"ids": ids_t[:, j], "logq": logq_t[:, j]}, m,
        torch.Generator(DEV), group=mg, abs_mode=abs_mode)
    loss.sum().backward()
    # the replay: every shard's draws as global ids with q~ = q_local / tp
    gids = (ids_t + torch.arange(tp, device=DEV)[None, :, None] * v_l
            ).reshape(len(rows), m)
    lq = logq_t.reshape(len(rows), m) - math.log(tp)
    wf = w.clone().requires_grad_(True)
    hf = h_l.detach().clone().requires_grad_(True)
    o = torch.einsum("td,tmd->tm", hf, wf[gids])
    o = (o.abs() if abs_mode else o) - lq - math.log(m)
    o = torch.where(gids == lab_l[:, None], -math.inf, o)
    pos = torch.einsum("td,td->t", hf, wf[lab_l])
    pos = pos.abs() if abs_mode else pos
    want = torch.logsumexp(torch.cat([pos[:, None], o], dim=1), dim=1) - pos
    want.sum().backward()
    return {"loss": rel_err(loss, want),
            "dw": rel_err(w_l.grad, wf.grad[j * v_l:(j + 1) * v_l]),
            "dh": rel_err(h_l.grad, hf.grad)}


def mesh_kernel_check(ctx, cfg, w, h) -> dict[str, float]:
    """The three sampler kernels at this rank's shard shapes, each against
    its plain version within RTOL (as phase 3 holds them): zstats over the
    blocks of its head rows (its n_valid), block_scores over its data
    block's T tokens and those blocks, leaf_scores over T m/tp draws of a
    block each."""
    bsz, alpha = cfg.sampler_block, cfg.sampler_alpha
    m_l = cfg.m_negatives // ctx.tp
    stats = blocks.build(rules.shard_rows(w, ctx), bsz,
                         n_valid=step.shard_n_valid(cfg, ctx))
    wq, cnt = stats.wq, stats.cnt
    nb, r = wq.shape[0], wq.shape[2]
    hq = rules.batch_rows(h, ctx)
    t = hq.shape[0]
    tag = f"rank ({ctx.data_index}, {ctx.model_index})"
    z = zstats(wq)
    errs = {"zstats": compare(f"{tag} zstats ({nb}, {bsz}, {r})", z,
                              ref.zstats_ref(wq))}
    errs["block_scores"] = compare(
        f"{tag} block_scores T={t} N={nb}",
        block_scores(hq, z, cnt, alpha=alpha),
        ref.block_scores_ref(hq, z, cnt, alpha))
    gen = torch.Generator(DEV).manual_seed(31)
    rows = wq[torch.randint(0, nb, (t * m_l,), generator=gen, device=DEV)]
    hg = hq.repeat_interleave(m_l, dim=0)
    errs["leaf_scores"] = compare(
        f"{tag} leaf_scores ({t * m_l}, {bsz}, {r})",
        leaf_scores(hg, rows, alpha=alpha),
        ref.leaf_scores_ref(hg, rows, alpha))
    return errs


def mesh_sampler_kernel_check(ctx, cfg, w, h) -> dict[str, float]:
    """The kernels ``cfg``'s sampler (tree-quadratic, rff or midx)
    launches, at this rank's shard shapes, each against its plain version
    within MESH_RTOL (phase 3's ``compare``): the statistics are the
    sampler's own build from the rank's head rows with its n_valid
    (``build_stats``), the queries its data block's T tokens, the leaf or
    list steps T m/tp draws among the live leaves or lists (the last live
    one holds padding rows).  The tree: zstats over its leaves,
    block_scores over each level the descent scores densely (at most
    max(256, 4 m/tp) nodes), leaf_scores; rff: rff_features (against the
    float64 evaluation of its plain version, as phase 8 holds it) and
    leaf_scores' dot mode; midx: midx_pair_masses' codes entry (empty
    lists exactly 0) and midx_member_scores."""
    sampler = sampler_from_config(cfg)
    n_valid = step.shard_n_valid(cfg, ctx)
    rows = rules.shard_rows(w, ctx)
    const = sampler.init_const(torch.Generator(DEV).manual_seed(7),
                               rows.shape[1])
    st = sampler.hydrate(SamplerState(
        sampler.build_stats(rows, n_valid, const), const), n_valid)
    alpha, tp = cfg.sampler_alpha, ctx.tp
    m_l = cfg.m_negatives // tp
    hq = rules.batch_rows(h, ctx)
    t = hq.shape[0]
    hg = hq.repeat_interleave(m_l, dim=0)
    gen = torch.Generator(DEV).manual_seed(31)
    tag = f"rank ({ctx.data_index}, {ctx.model_index}) {cfg.sampler}"

    def drawn(table):
        live = -(-n_valid // table.shape[1])
        pick = torch.randint(0, live, (t * m_l,), generator=gen, device=DEV)
        pick[::97] = live - 1
        return table[pick]

    errs = {}
    if cfg.sampler == "tree-quadratic":
        ts = st["stats"]
        wq = ts.wq
        errs["zstats"] = compare(f"{tag} zstats {tuple(wq.shape)}",
                                 zstats(wq), ref.zstats_ref(wq))
        err = 0.0
        for z, c in zip(ts.levels_z[1:], ts.levels_cnt[1:]):
            if z.shape[0] <= max(256, 4 * m_l):
                err = max(err, compare(
                    f"{tag} block_scores T={t} N={z.shape[0]}",
                    block_scores(hq, z, c, alpha=alpha),
                    ref.block_scores_ref(hq, z, c, alpha)))
        errs["block_scores"] = err
        r = drawn(wq)
        errs["leaf_scores"] = compare(
            f"{tag} leaf_scores {tuple(r.shape)}",
            leaf_scores(hg, r, alpha=alpha),
            ref.leaf_scores_ref(hg, r, alpha))
    elif cfg.sampler == "rff":
        fs, omega = st["stats"], st["proj"]
        mask = (torch.arange(fs.n_pad, device=DEV) < n_valid).float(
            ).reshape(fs.num_leaves, fs.leaf_size)
        shift = fs.logshift
        errs["rff_features"] = compare(
            f"{tag} rff_features {tuple(fs.wq.shape)} D={omega.shape[0]} "
            f"(against float64)",
            rff_features(fs.wq, omega, mask, shift, tau=cfg.rff_tau),
            ref.rff_features_ref(fs.wq, omega, mask, shift, cfg.rff_tau,
                                 torch.float64), MESH_RTOL)
        r = drawn(fs.wq)
        errs["leaf_scores"] = compare(
            f"{tag} leaf_scores dot {tuple(r.shape)}",
            leaf_scores(hg, r, square=False), ref.leaf_dots_ref(hg, r),
            MESH_RTOL)
    else:
        got = midx_list_masses(hq, st.c1, st.c2, st.codes, st.cnt,
                               alpha=alpha)
        errs["midx_pair_masses"] = compare(
            f"{tag} midx_pair_masses codes entry T={t} P={st.num_lists} "
            f"({int((st.cnt == 0).sum())} empty)", got,
            ref.midx_list_masses_ref(hq, st.c1, st.c2, st.codes, st.cnt,
                                     alpha), MESH_RTOL)
        if bool(got[:, st.cnt == 0].any()):
            raise AssertionError(f"{tag}: an empty list has mass")
        r = drawn(st.wq)
        errs["midx_member_scores"] = compare(
            f"{tag} midx_member_scores {tuple(r.shape)}",
            midx_member_scores(hg, r, alpha=alpha),
            ref.midx_member_scores_ref(hg, r, alpha), MESH_RTOL)
    return errs


def mesh_draw_logq(cfg, ctx, state) -> dict:
    """The eq. 2 exactness contract on this rank (``check_draw_logq``,
    held per shard): on 4 held-out queries of its data block, each of the
    m/tp draws ``sharded_negative_sample`` returns has logq equal to its
    shard's ``all_class_logq`` at the drawn id, less log tp, within
    LOGQ_TOL, and no id is at or past the shard's n_valid."""
    sampler = sampler_from_config(cfg)
    n_valid = step.shard_n_valid(cfg, ctx)
    held = next(batch_iterator_for(cfg, ctx, 4 * ctx.dp, 1, seed=1000,
                                   device=DEV))
    gen = torch.Generator(DEV).manual_seed(17)
    with torch.no_grad():
        h, _, _ = api.backbone_hidden(state.params, held, cfg, ctx)
        head = api.head_table(state.params, cfg, ctx).detach()
        rt = sampler.island_runtime(state.sampler_state, head, n_valid)
        ids, logq = distributed.sharded_negative_sample(
            sampler, rt, h, cfg.m_negatives, gen, ctx.model_group)
        worst = 0.0
        for t in range(h.shape[0]):
            oracle = sampler.all_class_logq(rt, h[t]) - math.log(ctx.tp)
            worst = max(worst, float((logq[t] - oracle[ids[t]]).abs().max()))
    top = int(ids.max())
    if not torch.isfinite(logq).all() or top >= n_valid:
        raise AssertionError(f"{cfg.sampler}: a draw has a non-finite logq "
                             f"or an id at or past n_valid {n_valid}")
    if not worst <= LOGQ_TOL:
        raise AssertionError(f"{cfg.sampler}: logq differs from the shard's "
                             f"all_class_logq - log tp by {worst}")
    return {"queries": h.shape[0], "draws": ids.shape[1], "worst": worst,
            "max_id": top, "n_valid": n_valid}


def mesh_overlap(cfg, ctx, tag: str) -> dict:
    """The overlap island on the mesh (MESH_OVERLAP: midx at cadence 2,
    k 1), driven by hand over MESH_STEPS steps of the pool beside the same
    steps in sync mode, each step's collectives by group counted.  Gates:
    a swap one step after each dispatch (the island's count too); each
    swapped-in state bitwise equal to the main stream's rebuild
    (``make_refresh_fn``) of the snapshots it was dispatched with; the
    island's launches apart from the step's (a midx rebuild launches no
    hand-written kernel) and the step's exact; the island issues one
    all-gather over data (the snapshot's, of the head's rows) on a cadence
    step and nothing else, and each step's collectives with the island's
    equal the sync step's."""
    family, _, cadence, k = MESH_OVERLAP
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    data = batch_iterator_for(cfg, ctx, TRAIN_BATCH, 1, seed=0, device=DEV)
    pool = [next(data) for _ in range(MESH_POOL)]
    out = {}
    for mode in ("sync", "overlap"):
        c = dataclasses.replace(cfg, sampler=family, refresh_mode=mode,
                                sampler_refresh_every=cadence,
                                refresh_stale_steps=k)
        state = step.init_train_state(torch.Generator(DEV).manual_seed(0), c,
                                      ctx, opt, device=DEV)
        step_fn = step.make_train_step(c, ctx, opt)
        island = loop.RefreshIsland(c, ctx, DEV) if mode == "overlap" \
            else None
        if island is not None:
            state = island.prime(state)
        sync()
        kernels.reset_launch_counts()
        steps, block_ms, island_coll = [], [], []
        sent, swapped = {}, {}  # step -> snapshots; step -> state swapped in
        for i in range(MESH_STEPS):
            distributed.reset_collective_counts()
            if island is not None:
                before = state.sampler_state
                state, rm = island.before_step(i, state)
                island_coll.append(
                    distributed.collective_counts(by_group=True))
                distributed.reset_collective_counts()
                block_ms.append(rm["refresh_block_ms"])
                if state.sampler_state is not before:
                    swapped[i] = state.sampler_state
                if island._inflight is not None and island._inflight[0] == i:
                    sent[i] = island._inflight[1:3]
            state, metrics = step_fn(state, pool[i % MESH_POOL],
                                     loop.step_generator(0, i, DEV))
            float(metrics["loss"])
            steps.append(distributed.collective_counts(by_group=True))
        sync()
        counts = kernels.launch_counts()
        out[mode] = {"steps": steps, "counts": counts}
        if island is None:
            continue
        swaps = sorted(swapped)
        for i, got in swapped.items():  # rebuilt on the main stream
            want = step.make_refresh_fn(c, ctx)(*sent[i - k])
            check_bitwise(f"{tag} overlap swap at step {i}", got.stats,
                          want.stats)
        want_swaps = [i for i in range(MESH_STEPS) if i % cadence == k]
        if swaps != want_swaps or island.swaps != len(want_swaps):
            raise AssertionError(f"{tag} overlap: swaps at {swaps} (island "
                                 f"count {island.swaps}) != {want_swaps}")
        if any(island.launches.values()):
            raise AssertionError(f"{tag} overlap: the island launched "
                                 f"{island.launches}")
        step_counts = {n: v - island.launches[n] for n, v in counts.items()}
        want = expected_launches(c, MESH_STEPS, refreshes=0, tp=ctx.tp) \
            if DEV.type == "cuda" else dict.fromkeys(REPLACES, 0)
        if step_counts != want:
            raise AssertionError(f"{tag} overlap: step launches "
                                 f"{step_counts} != {want}")
        v_l = rules.vocab_shard(cfg.vocab_size, ctx.tp)
        gather = {"all_gather data": {
            "calls": 1, "bytes": 4 * v_l * api.hidden_width(cfg)}}
        for i, got in enumerate(island_coll):
            if got != (gather if i % cadence == 0 else {}):
                raise AssertionError(f"{tag} overlap: the island's "
                                     f"collectives at step {i}: {got}")
        for i, (got, snap) in enumerate(zip(steps, island_coll)):
            total = {key: dict(v) for key, v in got.items()}
            for key, v in snap.items():
                e = total.setdefault(key, {"calls": 0, "bytes": 0})
                e["calls"] += v["calls"]
                e["bytes"] += v["bytes"]
            if total != out["sync"]["steps"][i]:
                raise AssertionError(
                    f"{tag} overlap: step {i}'s collectives with the "
                    f"island's {total} != the sync step's "
                    f"{out['sync']['steps'][i]}")
        out["overlap"].update(swaps=swaps, block_ms=block_ms,
                              island_launches=dict(island.launches),
                              island_collectives=island_coll)
    return out


def mesh_fit(cfg, ctx, tag: str) -> dict:
    """MESH_STEPS fit steps on a pool of MESH_POOL batches (the rank's
    rows), launches exact, the pool loss falling; then the step's ms over
    5 more steps and one step's collectives."""
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    data = batch_iterator_for(cfg, ctx, TRAIN_BATCH, 1, seed=0, device=DEV)
    pool = [next(data) for _ in range(MESH_POOL)]
    sync()
    kernels.reset_launch_counts()
    distributed.reset_collective_counts()
    t0 = time.perf_counter()
    res = loop.fit(cfg, ctx, opt, itertools.cycle(pool), MESH_STEPS,
                   seed=0, log_every=0, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = expected_launches(cfg, MESH_STEPS, tp=ctx.tp) \
        if DEV.type == "cuda" else dict.fromkeys(REPLACES, 0)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    losses = res.losses
    first = statistics.mean(losses[:MESH_POOL])
    last = statistics.mean(losses[-MESH_POOL:])
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"{tag}: the pool loss did not fall: {losses}")
    fit_coll = distributed.collective_counts()
    step_fn = step.make_train_step(cfg, ctx, opt)
    state, ms = res.state, []
    for k in range(5):
        if k == 4:
            distributed.reset_collective_counts()
        sync()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, pool[k % MESH_POOL],
                                 loop.step_generator(0, 1000 + k, DEV))
        float(metrics["loss"])
        ms.append((time.perf_counter() - t1) * 1e3)
    return {"losses": losses, "first": first, "last": last,
            "fit_s": wall, "launches": counts, "fit_collectives": fit_coll,
            "step_ms": ms, "step_collectives":
                distributed.collective_counts(by_group=True),
            "state": state}


def mesh_decode(cfg, ctx, state) -> dict:
    """The trained head as a sharded index: full-beam decode through the
    engine and ``sharded_logits_topk``, each equal id for id to the dense
    top-k over the gathered head except at a tie of the dense logits
    (``check_topk_ties``), their logits within MESH_RTOL."""
    held = next(batch_iterator_for(cfg, ctx, MESH_QUERIES * ctx.dp, 1,
                                   seed=1000, device=DEV))
    with torch.no_grad():
        hq, _, _ = api.backbone_hidden(state.params, held, cfg, ctx)
        head = api.head_table(state.params, cfg, ctx).detach()
    sync()
    kernels.reset_launch_counts()
    index = step.export_retrieval_index(state, cfg, ctx)
    decode = engine.make_decode_fn(cfg, ctx, head, MESH_TOPK)
    ids_b, log_b = decode(index, hq)
    sync()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    ids_s, log_s = decode(None, hq)
    full = distributed.all_gather_tiled(head, ctx.model_group)
    # one rank more than the beam: a tie at its last rank has a neighbour
    ids_d, log_d = retrieval.dense_topk(full, hq, MESH_TOPK + 1,
                                        n_valid=cfg.vocab_size)
    err = max(rel_err(log_b, log_d[:, :MESH_TOPK]),
              rel_err(log_s, log_d[:, :MESH_TOPK]))
    if not err <= MESH_RTOL:
        raise AssertionError(f"decode logits off the dense ones by {err}")
    swaps = {tag: check_topk_ties(f"{tag} vs the dense top-k", ids, ids_d,
                                  log_d, MESH_TOPK)
             for tag, ids in (("full-beam decode", ids_b),
                              ("sharded_logits_topk", ids_s))}
    return {"index_leaves_per_shard": index.num_leaves_shard,
            "leaf": index.leaf_size, "queries": hq.shape[0],
            "logit_err": err, "tie_swaps": swaps, "launches": counts}


def sync() -> None:
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def mesh_checks(ctx) -> dict:
    """One mesh's gates on this rank (see ``phase_mesh``)."""
    cfg = get_config("youtube-dnn")
    gen = torch.Generator(DEV).manual_seed(23)  # alike on every rank
    n, d = cfg.vocab_size, cfg.tower_dims[-1]
    w = torch.randn((n, d), generator=gen, device=DEV) * 0.05
    h = torch.randn((TRAIN_BATCH, d), generator=gen, device=DEV)
    labels = torch.randint(0, n, (TRAIN_BATCH,), generator=gen, device=DEV)
    tag = f"mesh ({ctx.dp}, {ctx.tp}) rank ({ctx.data_index}, " \
          f"{ctx.model_index})"
    kern = mesh_kernel_check(ctx, cfg, w, h)
    fams = {fam: {"kernels": mesh_sampler_kernel_check(
                ctx, dataclasses.replace(cfg, sampler=fam), w, h)}
            for fam in MESH_SAMPLERS}
    full = mesh_full_check(ctx, w, h, labels, cfg.abs_softmax)
    gate(f"{tag} full softmax", full, MESH_RTOL)
    sampled = mesh_sampled_check(ctx, w, h, labels, cfg.m_negatives,
                                 cfg.abs_softmax, seed=29)
    gate(f"{tag} sampled softmax at given negatives", sampled, MESH_RTOL)
    del w, h, labels
    fit = mesh_fit(cfg, ctx, tag)
    dec = mesh_decode(cfg, ctx, fit.pop("state"))
    for fam, got in fams.items():
        fcfg = dataclasses.replace(cfg, sampler=fam)
        t0 = time.perf_counter()
        got["fit"] = mesh_fit(fcfg, ctx, f"{tag} {fam}")
        got["logq"] = mesh_draw_logq(fcfg, ctx, got["fit"].pop("state"))
        got["s"] = time.perf_counter() - t0
    out = {"kernels": kern, "full": full, "sampled": sampled, "fit": fit,
           "decode": dec, "samplers": fams,
           "v_l": rules.vocab_shard(n, ctx.tp),
           "blocks": -(-rules.vocab_shard(n, ctx.tp) // cfg.sampler_block),
           "n_valid": step.shard_n_valid(cfg, ctx)}
    if (ctx.dp, ctx.tp) == MESH_OVERLAP[1]:
        t0 = time.perf_counter()
        out["overlap"] = mesh_overlap(cfg, ctx, tag)
        out["overlap"]["s"] = time.perf_counter() - t0
    return out


def mesh_rank(rank: int, world: int, addr: str, out: Path,
              phase: str = "23") -> int:
    """One rank process of phase 23b (each of MESH_SHAPES in turn), or of
    phases 24 to 28 (``phase`` "24,25,26,27,28": each of MESH_DENSE_RUNS,
    then each of MESH_FAMILY_RUNS, then each of MESH_EXPERT_RUNS, then
    each of MESH_SERVE_RUNS, then each of MESH_FAMILY_SERVE_RUNS): the
    gloo world over the shared card; its results to
    ``out/rank<r>.json``."""
    if DEV.type == "cuda":
        torch.cuda.set_device(0)
    launch_mesh.init_distributed("gloo", init_method=addr, rank=rank,
                                 world_size=world)
    phases = phase.split(",")
    try:
        results = {}
        if "24" in phases:
            for mode, (dp, tp), opt_name, lr in MESH_DENSE_RUNS:
                ctx = rules.mesh_ctx(launch_mesh.make_debug_mesh(
                    dp, tp, device_type=DEV.type), mode=mode)
                results[f"{mode} {dp}x{tp}"] = mesh_dense_rank(
                    ctx, mode, opt_name, lr)
        if "25" in phases:
            for name, mode, (dp, tp) in MESH_FAMILY_RUNS:
                ctx = rules.mesh_ctx(launch_mesh.make_debug_mesh(
                    dp, tp, device_type=DEV.type), mode=mode)
                if DEV.type == "cuda":
                    torch.cuda.empty_cache()
                results[f"{name} {mode} {dp}x{tp}"] = mesh_family_rank(
                    ctx, name)
        if "26" in phases:
            if DEV.type == "cuda":
                # four ranks' fp32 parity steps fill the shared card at
                # (2, 2): growable segments leave no reserved block idle
                torch.cuda.memory._set_allocator_settings(
                    "expandable_segments:True")
            for name, (dp, tp), n_layers in MESH_EXPERT_RUNS:
                ctx = rules.ctx_for_train(launch_mesh.make_debug_mesh(
                    dp, tp, device_type=DEV.type),
                    mesh_expert_cfg(name, n_layers))
                if DEV.type == "cuda":
                    torch.cuda.empty_cache()
                results[f"{name} {dp}x{tp}"] = mesh_expert_rank(
                    ctx, name, n_layers)
        if "27" in phases:
            for part, name, (dp, tp), n_layers, dtype in MESH_SERVE_RUNS:
                ctx = rules.mesh_ctx(launch_mesh.make_debug_mesh(
                    dp, tp, device_type=DEV.type), mode="tp")
                results[f"{part} {name} {dp}x{tp}"] = mesh_serve_rank(
                    ctx, part, name, n_layers, dtype)
        if "28" in phases:
            for part, name, (dp, tp), n_layers, dtype in \
                    MESH_FAMILY_SERVE_RUNS:
                ctx = rules.mesh_ctx(launch_mesh.make_debug_mesh(
                    dp, tp, device_type=DEV.type), mode="tp")
                results[f"{part} {name} {dp}x{tp}"] = \
                    mesh_family_serve_rank(ctx, part, name, n_layers, dtype)
        if phases == ["23"]:
            for dp, tp in MESH_SHAPES:
                ctx = rules.mesh_ctx(launch_mesh.make_debug_mesh(
                    dp, tp, device_type=DEV.type))
                t0 = time.perf_counter()
                results[f"{dp}x{tp}"] = {**mesh_checks(ctx),
                                         "s": time.perf_counter() - t0}
        if DEV.type == "cuda":
            results["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        (out / f"rank{rank}.json").write_text(json.dumps(results))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_mesh_nccl(cfg) -> dict[str, dict[str, int]]:
    """Phase 23a: NCCL on a (1, 1) mesh in this process: one fit step with
    estimator "full" and MESH_STEP_OPT equal to the mesh=None step within
    MESH_STEP_RTOL (the loss, and every parameter on its own over its own
    max), a block-quadratic step's launches exact, and each of
    MESH_SAMPLERS (``mesh_nccl_family``).  Returns each step's launches by
    path."""
    backend = "nccl" if DEV.type == "cuda" else "gloo"
    launch_mesh.init_distributed(
        backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1)
    try:
        ctx = rules.mesh_ctx(launch_mesh.make_debug_mesh(1, 1))
        full = dataclasses.replace(cfg, estimator="full")
        res = {}
        for tag, c in (("mesh", ctx), ("unsharded", None)):
            res[tag] = loop.fit(
                full, c, make_optimizer(*MESH_STEP_OPT),
                batch_iterator_for(full, c, TRAIN_BATCH, 1, seed=0,
                                   device=DEV), 1, seed=0, log_every=0,
                device=DEV)
        want = dict(res["unsharded"].state.params.named_parameters())
        got = dict(res["mesh"].state.params.named_parameters())
        errs = {"loss": abs(res["mesh"].losses[0]
                            - res["unsharded"].losses[0])
                / abs(res["unsharded"].losses[0]),
                **{k: rel_err(p, want[k]) for k, p in got.items()}}
        log(f"[mesh] {backend} (1, 1): one full-softmax fit step "
            f"({MESH_STEP_OPT}) against the unsharded step, the loss's "
            f"relative error and each parameter's over its own max {errs}")
        gate(f"{backend} (1, 1) full step", errs, MESH_STEP_RTOL)
        del res, want
        sync()
        kernels.reset_launch_counts()
        distributed.reset_collective_counts()
        t0 = time.perf_counter()
        loop.fit(cfg, ctx, make_optimizer("adamw", 1e-2, weight_decay=0.0),
                 batch_iterator_for(cfg, ctx, TRAIN_BATCH, 1, seed=0,
                                    device=DEV), 1, seed=0, log_every=0,
                 device=DEV)
        sync()
        counts = kernels.launch_counts()
        want = expected_launches(cfg, 1) if DEV.type == "cuda" \
            else dict.fromkeys(REPLACES, 0)
        if counts != want:
            raise AssertionError(f"{backend} (1, 1) block-quadratic step: "
                                 f"launches {counts} != {want}")
        log(f"[mesh] {backend} (1, 1): a block-quadratic fit step (init "
            f"included) in {time.perf_counter() - t0:.3f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }, collectives "
            f"{distributed.collective_counts()}")
        by_path = {"mesh nccl (1, 1)": counts}
        for fam in MESH_SAMPLERS:
            by_path[f"mesh nccl (1, 1) {fam}"] = mesh_nccl_family(
                dataclasses.replace(cfg, sampler=fam), ctx, backend)
        return by_path
    finally:
        torch.distributed.destroy_process_group()


def mesh_nccl_family(cfg, ctx, backend: str) -> dict[str, int]:
    """Phase 23a for one of MESH_SAMPLERS: one fit step on the (1, 1)
    mesh, its launches exact (``expected_launches``), and the statistics
    it refreshed bitwise equal to ``build_stats`` on the unsharded head
    at the step's start (the unsharded init from the same seed) with the
    mesh state's constants, on the card.  Returns the step's launches."""
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = loop.fit(cfg, ctx, opt, batch_iterator_for(
        cfg, ctx, TRAIN_BATCH, 1, seed=0, device=DEV), 1, seed=0,
        log_every=0, device=DEV)
    sync()
    s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = expected_launches(cfg, 1) if DEV.type == "cuda" \
        else dict.fromkeys(REPLACES, 0)
    if counts != want:
        raise AssertionError(f"{backend} (1, 1) {cfg.sampler} step: "
                             f"launches {counts} != {want}")
    got = res.state.sampler_state
    init = step.init_train_state(torch.Generator(DEV).manual_seed(0), cfg,
                                 None, opt, device=DEV)
    with torch.no_grad():
        head = api.head_table(init.params, cfg).detach()
        stats = sampler_from_config(cfg).build_stats(head, cfg.vocab_size,
                                                     got.const)
    check_bitwise(f"{backend} (1, 1) {cfg.sampler} refreshed statistics",
                  got.stats, stats)
    log(f"[mesh] {backend} (1, 1): a {cfg.sampler} fit step (init "
        f"included) in {s:.3f} s, launches "
        f"{ {k: v for k, v in counts.items() if v} }; its refreshed "
        f"statistics {[(k, tuple(v.shape)) for k, v in stats.items()]} "
        f"bitwise equal to build_stats on the unsharded head")
    return counts


def run_mesh_ranks(phase: str, timeout_s: float = MESH_TIMEOUT_S
                   ) -> list[dict]:
    """MESH_WORLD rank processes of this script (``mesh_rank``) for
    ``phase``, their logs relayed: each rank's results.  A rank that fails
    or outlives ``timeout_s`` fails the phase (the others are killed)."""
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    addr = f"tcp://localhost:{free_port()}"
    logs = [open(MESH_DIR / f"rank{r}.log", "w") for r in range(MESH_WORLD)]
    procs = [subprocess.Popen(
        [*MESH_RANK_CMD, "--mesh-rank", str(r), "--mesh-addr", addr,
         "--mesh-device", DEV.type, "--mesh-phase", phase], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(MESH_WORLD)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    for r in range(MESH_WORLD):
        for line in (MESH_DIR / f"rank{r}.log").read_text().splitlines():
            log(f"  [rank {r}] {line}")
    if codes != [0] * MESH_WORLD:
        raise AssertionError(f"mesh rank processes failed or timed out: "
                             f"exit codes {codes}")
    return [json.loads((MESH_DIR / f"rank{r}.json").read_text())
            for r in range(MESH_WORLD)]


def phase_mesh() -> dict[str, dict[str, int]]:
    """Phase 23 (youtube-dnn at full width: 100,000 items, tower (256,
    128), T 256, m 128, fp32, block-quadratic in blocks of 256, and each of
    MESH_SAMPLERS, clip + AdamW): 23a over NCCL in this process
    (``phase_mesh_nccl``, ``mesh_nccl_family``); 23b MESH_WORLD rank
    processes on the card over gloo, each mesh of MESH_SHAPES in turn,
    every rank: the sampler kernels of every family at the rank's shard
    shapes against their plain versions, the full softmax's loss and
    gradients and the sampled softmax's at given negatives against the
    unsharded loss on the card (MESH_RTOL), MESH_STEPS fit steps of each
    family (exact launches, falling pool loss), step ms and collectives,
    the eq. 2 contract of each family's draws on the rank's shard, the
    trained head's sharded index decoded at full beam through the engine
    equal to the sharded and the dense top-k, and at MESH_OVERLAP's mesh
    the overlap island (``mesh_overlap``).  The kernels were built by
    phase 2,
    so the ranks only load them.  Any rank's failure or timeout fails the
    phase.  Returns the launches of each path (a mesh's summed over its
    ranks)."""
    cfg = get_config("youtube-dnn")
    t_start = time.perf_counter()
    by_path = phase_mesh_nccl(cfg)
    ranks = run_mesh_ranks("23")
    for dp, tp in MESH_SHAPES:
        key = f"{dp}x{tp}"
        total = dict.fromkeys(REPLACES, 0)
        for r, res in enumerate(ranks):
            m = res[key]
            fit = m["fit"]
            log(f"[mesh] gloo ({dp}, {tp}) rank {r} (data {r // tp}, model "
                f"{r % tp}): {m['v_l']} head rows, n_valid {m['n_valid']}, "
                f"{m['blocks']} blocks; kernels at the shard's shapes, "
                f"max abs err {m['kernels']}; "
                f"full softmax rel errors {m['full']}"
                f"; sampled at given negatives {m['sampled']}")
            log(f"[mesh] gloo ({dp}, {tp}) rank {r}: {MESH_STEPS} fit steps "
                f"in {fit['fit_s']:.3f} s, pool loss {fit['first']} -> "
                f"{fit['last']}, launches "
                f"{ {k: v for k, v in fit['launches'].items() if v} }; "
                f"step ms {[round(x, 3) for x in fit['step_ms']]} (median "
                f"{statistics.median(fit['step_ms']):.3f}); one step's "
                f"collectives {fit['step_collectives']}; the fit's "
                f"{fit['fit_collectives']}")
            log(f"[mesh] gloo ({dp}, {tp}) rank {r}: sharded index "
                f"{m['decode']['index_leaves_per_shard']} leaves of "
                f"{m['decode']['leaf']} a shard, full-beam decode of "
                f"{m['decode']['queries']} queries and sharded_logits_topk "
                f"= the dense top-{MESH_TOPK} but for ties (logit err "
                f"{m['decode']['logit_err']}; tie swaps "
                f"{m['decode']['tie_swaps']}), launches "
                f"{m['decode']['launches']}; the mesh's checks "
                f"{m['s']:.3f} s")
            add_counts(total, fit["launches"])
            for fam, got in m["samplers"].items():
                f_fit, lq = got["fit"], got["logq"]
                log(f"[mesh] gloo ({dp}, {tp}) rank {r} {fam}: kernels at "
                    f"the shard's shapes, max abs err {got['kernels']}; "
                    f"{MESH_STEPS} fit steps in {f_fit['fit_s']:.3f} s, "
                    f"pool loss {f_fit['first']} -> {f_fit['last']}, "
                    f"launches "
                    f"{ {k: v for k, v in f_fit['launches'].items() if v} }"
                    f"; step ms {[round(x, 3) for x in f_fit['step_ms']]} "
                    f"(median {statistics.median(f_fit['step_ms']):.3f}); "
                    f"one step's collectives {f_fit['step_collectives']}; "
                    f"eq. 2 on {lq['queries']} queries x {lq['draws']} "
                    f"draws: max |logq - (all_class_logq - log tp)| "
                    f"{lq['worst']}, max id {lq['max_id']} (n_valid "
                    f"{lq['n_valid']}); {got['s']:.3f} s")
                add_counts(by_path.setdefault(
                    f"mesh gloo ({dp}, {tp}) {fam}",
                    dict.fromkeys(REPLACES, 0)), f_fit["launches"])
            if "overlap" in m:
                ov = m["overlap"]
                family, _, cadence, k = MESH_OVERLAP
                log(f"[mesh] gloo ({dp}, {tp}) rank {r} overlap island "
                    f"({family}, cadence {cadence}, k {k}, {MESH_STEPS} "
                    f"steps): swaps at {ov['overlap']['swaps']}, each "
                    f"bitwise the main stream's rebuild of its snapshots; "
                    f"island launches "
                    f"{ {k: v for k, v in ov['overlap']['island_launches'].items() if v} } "
                    f"apart from the step's (exact); the island's "
                    f"collectives a step {ov['overlap']['island_collectives']}"
                    f" (the snapshot's all-gather over data on a cadence "
                    f"step), each step's with them equal to the sync "
                    f"step's; block ms {ov['overlap']['block_ms']}; "
                    f"{ov['s']:.3f} s")
                add_counts(by_path.setdefault(
                    f"mesh gloo ({dp}, {tp}) overlap {family}",
                    dict.fromkeys(REPLACES, 0)), ov["overlap"]["counts"])
        by_path[f"mesh gloo ({dp}, {tp})"] = total
    log(f"[mesh] rank peak memory GB "
        f"{[round(r.get('peak_gb', 0.0), 3) for r in ranks]}; phase 23 "
        f"{time.perf_counter() - t_start:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# Phase 24: the backbone's storage layouts on the mesh (starcoder2-3b)
# ---------------------------------------------------------------------------

#: starcoder2-3b at full width, its depth cut to this many of 30 layers
#: (4 until phase 28 needed the time: 88-123 s of ranks at 4, 58.6 s at 2;
#: PERF.md section 4)
MESH_DENSE_LAYERS = 2
#: each gloo mesh's (mode, (dp, tp), optimizer of its bf16 fit, lr)
MESH_DENSE_RUNS = (("tp_fsdp", (1, 4), "adamw", 3e-4),
                   ("tp_fsdp", (2, 2), "adafactor", 1e-4),
                   ("pure_fsdp", (2, 2), "adamw", 3e-4))
MESH_DENSE_BATCH = 4
MESH_DENSE_SEQ = 1024
MESH_DENSE_STEPS = 4
MESH_DENSE_POOL = 2
#: steps timed after the fit (the last one's collectives recorded)
MESH_DENSE_TIMED = 1
#: the run whose attention shard shapes phase 24 times on rank 0, (mode,
#: (dp, tp)); the others' are checked only (timings of all three are in
#: PERF.md row 10)
MESH_DENSE_TIMED_RUN = ("tp_fsdp", (1, 4))
#: the fp32 parity step's batch: 4 sequences of 256 tokens (T 1,024; the
#: full softmax's logits (T, 49,152))
MESH_PARITY_BATCH = 4
MESH_PARITY_SEQ = 256
#: the parity step's optimizer, after the gradients are kept: clip +
#: Adafactor at this lr (``parity_optimizer``), its eps by leaf: the
#: reference's 1e-30 on the matrices, whose row and column means of g^2
#: (psum'd where the other dim is sharded) sit far above it, and 1e-6 (a
#: floor of 1e-3 under |g|) on the vectors, whose statistics are their few
#: elements' own squares, so that at 1e-30 an element whose gradient is
#: near 0 turns a sharded sum's summation-order noise into an update of
#: lr's size (tests/test_torch_mesh_backbone.py sets the same)
MESH_PARITY_LR = 1e-4
MESH_PARITY_EPS = {"matrices": 1e-30, "vectors": 1e-6}
#: the seed of the parity step's weights and batch
MESH_DENSE_SEED = 24
#: where the parent leaves the unsharded parity step's results
MESH_DENSE_DIR = MESH_DIR.parent / "chip_smoke_mesh_dense"


def mesh_dense_cfg(mode: str, dtype: str = "bfloat16", **changes):
    """starcoder2-3b at full width and MESH_DENSE_LAYERS layers, trained
    in ``mode``, in ``dtype``."""
    return dataclasses.replace(
        get_config(DENSE_ARCH), n_layers=MESH_DENSE_LAYERS,
        train_sharding=mode, dtype=dtype, param_dtype=dtype, **changes)


def mesh_dense_model(cfg, tp_b: int):
    """The parity step's whole model from MESH_DENSE_SEED, its heads
    padded for a backbone of TP degree ``tp_b`` (``init_lm``'s rule)."""
    tree = transformer.init_lm(
        torch.Generator(DEV).manual_seed(MESH_DENSE_SEED), cfg, DEV,
        tp=tp_b)
    return transformer.StackedLM(cfg, DEV, tree=tree)


def mesh_dense_kv(cfg, tp_b: int) -> int:
    """The padded KV heads that name the parity file of ``tp_b``."""
    return layers.padded_heads(cfg, tp_b)[1]


def parity_batch(cfg) -> dict[str, torch.Tensor]:
    return next(batch_iterator_for(cfg, None, MESH_PARITY_BATCH,
                                   MESH_PARITY_SEQ, seed=MESH_DENSE_SEED,
                                   device=DEV))


def by_ndim(matrices: GradientTransform, vectors: GradientTransform
            ) -> GradientTransform:
    """``matrices`` on the leaves of two or more dims, ``vectors`` on the
    rest (a mesh rank's ``ShardedGrads`` split alike)."""
    def split(d, params):
        mat = {k: v for k, v in d.items() if params[k].dim() >= 2}
        vec = {k: v for k, v in d.items() if k not in mat}
        if isinstance(d, ShardedGrads):
            return tuple(ShardedGrads(x, d.specs, d.ctx) for x in (mat, vec))
        return mat, vec

    def init(params):
        return tuple(t.init(x) for t, x in zip((matrices, vectors),
                                               split(params, params)))

    def update(grads, state, params):
        out = [t.update(g, s, p) for t, g, s, p in zip(
            (matrices, vectors), split(grads, params), state,
            split(params, params))]
        return {**out[0][0], **out[1][0]}, (out[0][1], out[1][1])

    return GradientTransform(init, update)


def parity_optimizer() -> GradientTransform:
    """clip at global norm 1 + Adafactor at MESH_PARITY_LR, its eps by
    leaf (MESH_PARITY_EPS)."""
    return chain(clip_by_global_norm(1.0), by_ndim(
        adafactor(MESH_PARITY_LR, eps=MESH_PARITY_EPS["matrices"]),
        adafactor(MESH_PARITY_LR, eps=MESH_PARITY_EPS["vectors"])))


def keeping_grads(opt):
    """``opt`` that first keeps a copy of the gradients it is given
    (before the clip scales them in place): (transform, the copies)."""
    kept: dict[str, torch.Tensor] = {}

    def update(grads, state, params):
        kept.update({k: g.detach().clone() for k, g in grads.items()})
        return opt.update(grads, state, params)

    return GradientTransform(opt.init, update), kept


def parity_step(cfg, ctx, model, batch) -> tuple[float, dict, dict]:
    """One step with estimator "full" and ``parity_optimizer``: (the loss,
    the gradients, the updated parameters), the rank's on a mesh."""
    opt, grads = keeping_grads(parity_optimizer())
    state = step.TrainState(model, opt.init(step.param_dict(model)),
                            step.empty_state(), 0)
    _, metrics = step.make_train_step(cfg, ctx, opt)(
        state, batch, torch.Generator(DEV).manual_seed(1))
    return float(metrics["loss"]), grads, step.param_dict(model)


def mesh_dense_reference() -> dict[int, float]:
    """The unsharded fp32 parity step of each padding the meshes need (KV
    heads 4 for tp_fsdp at tp 4, 2 otherwise), saved for the ranks:
    loss, gradients, updated parameters and each tensor's max |x|.
    Returns {kv heads: seconds}."""
    shutil.rmtree(MESH_DENSE_DIR, ignore_errors=True)
    MESH_DENSE_DIR.mkdir(parents=True)
    cfg = mesh_dense_cfg("tp_fsdp", "float32", estimator="full")
    out = {}
    for tp_b in sorted({1 if mode == "pure_fsdp" else tp
                        for mode, (_, tp), _, _ in MESH_DENSE_RUNS}):
        kv = mesh_dense_kv(cfg, tp_b)
        if kv in out:
            continue
        t0 = time.perf_counter()
        loss, grads, params = parity_step(cfg, None,
                                          mesh_dense_model(cfg, tp_b),
                                          parity_batch(cfg))
        maxes = {f"{kind} {k}": float(v.abs().max())
                 for kind, d in (("grad", grads), ("param", params))
                 for k, v in d.items()}
        share = eps_floor_share(grads)
        torch.save({"loss": loss, "max": maxes,
                    "grads": {k: v.cpu() for k, v in grads.items()},
                    "params": {k: v.detach().cpu()
                               for k, v in params.items()}},
                   MESH_DENSE_DIR / f"unsharded_kv{kv}.pt")
        del grads, params
        torch.cuda.empty_cache()
        out[kv] = time.perf_counter() - t0
        log(f"[mesh dense] the unsharded fp32 parity step (KV heads {kv}): "
            f"loss {loss}, {out[kv]:.1f} s with its save; shares of its "
            f"clipped gradients above Adafactor's eps {share}")
    return out


def eps_floor_share(grads: dict[str, torch.Tensor]) -> dict[str, float]:
    """How much of the parity step's Adafactor update its statistics
    decide, after the clip at global norm 1: the share of the matrices'
    elements with g^2 above their eps (MESH_PARITY_EPS) and above the
    vectors' 1e-6; of the matrices' row and column means of g^2 (what a
    mesh psums where the other dim is sharded), the share above 1e-6; of
    the vectors' elements, the share above their eps (below it an update
    is about g / sqrt(eps)); and the global norm the clip divides by."""
    floor = MESH_PARITY_EPS["vectors"]
    norm = math.sqrt(sum(float(torch.sum(torch.square(g.float())))
                         for g in grads.values()))
    scale = min(1.0, 1.0 / max(norm, 1e-9))
    n: dict[str, int] = dict.fromkeys(
        ("mat", "mat_eps", "mat_floor", "rows", "rows_floor", "cols",
         "cols_floor", "vec", "vec_floor"), 0)
    for g in grads.values():
        g2 = torch.square(g.float() * scale)
        if g.dim() >= 2:
            n["mat"] += g.numel()
            n["mat_eps"] += int((g2 > MESH_PARITY_EPS["matrices"]).sum())
            n["mat_floor"] += int((g2 > floor).sum())
            for key, means in (("rows", g2.mean(-1)), ("cols", g2.mean(-2))):
                n[key] += means.numel()
                n[key + "_floor"] += int((means > floor).sum())
        else:
            n["vec"] += g.numel()
            n["vec_floor"] += int((g2 > floor).sum())
        del g2
    return {"matrices_above_eps": n["mat_eps"] / n["mat"],
            "matrices_above_1e-6": n["mat_floor"] / n["mat"],
            "row_means_above_1e-6": n["rows_floor"] / n["rows"],
            "col_means_above_1e-6": n["cols_floor"] / n["cols"],
            "vectors_above_1e-6": n["vec_floor"] / n["vec"],
            "grad_norm": norm}


def mesh_dense_parity(ctx) -> dict[str, float]:
    """This rank's fp32 parity step (``parity_step`` on its shards and
    batch rows) against the unsharded one the parent saved: the loss, and
    each gradient shard and updated shard against its slice, over the
    whole tensor's max (MESH_RTOL)."""
    cfg = mesh_dense_cfg(ctx.mode, "float32", estimator="full")
    tp_b = ctx.tp_backbone
    want = torch.load(MESH_DENSE_DIR /
                      f"unsharded_kv{mesh_dense_kv(cfg, tp_b)}.pt",
                      mmap=True, weights_only=True)
    model = step.shard_params(mesh_dense_model(cfg, tp_b), cfg, ctx)
    batch = {k: rules.batch_rows(v, ctx) for k, v in
             parity_batch(cfg).items()}
    loss, grads, params = parity_step(cfg, ctx, model, batch)
    specs = model.param_specs
    errs = {"loss": abs(loss - want["loss"]) / abs(want["loss"])}
    for kind, got in (("grad", grads), ("param", params)):
        for k, x in got.items():
            block = rules.shard_by_spec(want[kind + "s"][k], specs[k],
                                        ctx).to(DEV)
            scale = max(want["max"][f"{kind} {k}"], 1e-30)
            errs[f"{kind} {k}"] = float((x.detach().float()
                                         - block.float()).abs().max()
                                        / scale)
    del want, grads, params, model
    torch.cuda.empty_cache()
    return errs


def mesh_dense_kernels(ctx, timed: bool) -> dict:
    """Both attention kernels at this rank's shard shapes (its batch rows,
    its heads: nh / tp_backbone q over nkv / tp_backbone kv, hd 128,
    causal bf16) against their plain versions with phase 10's and row
    10b's gates; ``timed`` adds their device times."""
    cfg = mesh_dense_cfg(ctx.mode)
    nh, nkv = layers.padded_heads(cfg, ctx.tp_backbone)
    h, kv = nh // ctx.tp_backbone, nkv // ctx.tp_backbone
    b = MESH_DENSE_BATCH // ctx.dp
    gen = torch.Generator(DEV).manual_seed(MESH_DENSE_SEED)
    return {"shape": [b, MESH_DENSE_SEQ, h, kv, 128],
            "flash_attention": flash_row(gen, b, MESH_DENSE_SEQ, h=h, kv=kv,
                                         timed=timed),
            "flash_attention_bwd": flash_bwd_case(
                gen, b, MESH_DENSE_SEQ, h, kv, 128, torch.bfloat16,
                timed=timed)}


def _gather_calls(ctx, shape, spec, keep, esize: int
                  ) -> list[tuple[str, int, int]]:
    """(group, gathered bytes, scattered-back bytes) of each all-gather
    ``rules.gather_by_spec`` makes of a shard of ``shape``: one a dim over
    its axes unless they are kept or of one rank."""
    numel, out = math.prod(shape), []
    for entry in spec:
        axes = rules._axes(entry)
        n = ctx.axis_size(axes)
        if axes and not set(axes) <= set(keep) and n > 1:
            out.append((",".join(axes), numel * n * esize, numel * esize))
            numel *= n
    return out


def predict_dense_collectives(cfg, ctx, model, opt_name: str, rows: int
                              ) -> dict[str, dict[str, int]]:
    """One bf16 fit step's collectives on this rank ("<op> <group>":
    calls, bytes of each call's result), from the specs: the refresh's
    head gather; the embedding's ZeRO-3 gathers (and under TP its psum);
    each layer's gathers once a forward run (twice under remat) and their
    reduce-scatters once, Megatron's g psums (the attention's each forward
    run, the MLP's once) and f all-reduces once; the head island's (tp_fsdp: the
    replicated h's all-reduce; pure_fsdp: h and the labels gathered over
    model, h's reduce-scatter), the loss's two psums and one pmax of (T,)
    fp32 (batch-shared negatives: the einsum route), the loss sum's psum
    over data; each gradient replicated over a batch axis all-reduced;
    the clip's one psum per set of sharding axes; Adafactor's psums of
    the statistics whose dims are sharded and of each stack's RMS."""
    out: dict[str, dict[str, int]] = {}

    def add(op: str, group: str, nbytes: int, calls: int = 1) -> None:
        e = out.setdefault(f"{op} {group}", {"calls": 0, "bytes": 0})
        e["calls"] += calls
        e["bytes"] += calls * nbytes

    specs = model.param_specs
    params = dict(model.named_parameters())
    keep = rules.compute_axes(ctx)
    fwd = forwards(cfg)
    d, tp = cfg.d_model, ctx.tp
    act = rows * d * 2  # a bf16 (rows, d) activation

    def gathers(name, keep_axes, forward_runs, backward_runs):
        p = params[name]
        for group, got, back in _gather_calls(ctx, p.shape, specs[name],
                                              keep_axes, p.element_size()):
            add("all_gather", group, got, forward_runs)
            if backward_runs:
                add("reduce_scatter", group, back, backward_runs)

    head = api.head_name(cfg)
    gathers(head, (ctx.model_axis,), 1, 0)  # the refresh's head
    gathers(head, (ctx.model_axis,), 1, 1)  # the island's head
    gathers("embed.table", keep, 1, 1)
    tp_group = rules.tp_group(ctx) is not None
    if tp_group:
        add("all_reduce_sum", "model", act)  # the vocab-parallel lookup
    for name in params:
        if name.startswith("segments."):
            gathers(name, keep, fwd, 1)
    if tp_group:
        # attention's g each forward run; the MLP's g once (the remat
        # recompute stops early, after the last op that saved a tensor:
        # the MLP's down projection); f's backward once each
        add("all_reduce_sum", "model", act, cfg.n_layers * (fwd + 3))
    t = rows
    if ctx.mode == "pure_fsdp":
        t = rows * tp
        add("all_gather", "model", t * d * 2)
        add("all_gather", "model", t * 8)  # the labels, int64
        add("reduce_scatter", "model", act)
    else:
        add("all_reduce_sum", "model", act)  # the replicated h
    add("all_reduce_sum", "model", t * 4, 2)
    add("all_reduce_max", "model", t * 4)
    add("all_reduce_sum", "data", 4)
    for name, p in params.items():
        axes = rules.grad_reduce_axes(specs[name], ctx)
        if axes:
            add("all_reduce_sum", ",".join(axes),
                p.numel() * p.element_size())
    sg = ShardedGrads(params, specs, ctx)
    for axes in sorted({sg.leaf_axes(k) for k in params} - {()}):
        add("all_reduce_sum", ",".join(axes), 4)
    if opt_name == "adafactor":
        from repro_torch.optim.adafactor import stacks

        for key, members in stacks(params).items():
            layer = params[members[0]]
            nd = layer.dim()
            stacked = key != members[0]
            rows_ax = sg.dim_axes(members[0], nd - 2) if nd >= 2 else ()
            cols_ax = sg.dim_axes(members[0], nd - 1)
            # an unfactored leaf (1-D, unstacked) takes the RMS's only
            if nd == 1 and stacked and cols_ax:
                # a (count, d) stack: each layer's mean over its row
                add("all_reduce_sum", ",".join(cols_ax), 4, len(members))
            elif nd >= 2:  # each matrix's row and column statistics
                if cols_ax:
                    add("all_reduce_sum", ",".join(cols_ax),
                        layer.shape[-2] * 4, len(members))
                if rows_ax:
                    add("all_reduce_sum", ",".join(rows_ax),
                        layer.shape[-1] * 4, len(members))
                    add("all_reduce_sum", ",".join(rows_ax), 4,
                        len(members))
            if sg.leaf_axes(members[0]):
                add("all_reduce_sum", ",".join(sg.leaf_axes(members[0])),
                    4)
    return out


def mesh_dense_fit(ctx, opt_name: str, lr: float, tag: str) -> dict:
    """MESH_DENSE_STEPS bf16 ``fit`` steps on a pool of MESH_DENSE_POOL
    batches of the rank's rows: exact launches (zstats once a refresh,
    flash_attention once a layer and forward run, flash_attention_bwd once
    a layer and step), the pool loss falling; then MESH_DENSE_TIMED timed
    steps, the last one's collectives against
    ``predict_dense_collectives``, and the rank's peak memory."""
    cfg = mesh_dense_cfg(ctx.mode)
    opt = make_optimizer(opt_name, lr)
    data = batch_iterator_for(cfg, ctx, MESH_DENSE_BATCH, MESH_DENSE_SEQ,
                              seed=0, device=DEV)
    pool = [next(data) for _ in range(MESH_DENSE_POOL)]
    sync()
    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = loop.fit(cfg, ctx, opt, CycledPool(pool), MESH_DENSE_STEPS,
                   seed=0, log_every=0, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = dict.fromkeys(REPLACES, 0)
    if DEV.type == "cuda":
        want.update(zstats=MESH_DENSE_STEPS + 1,
                    flash_attention=MESH_DENSE_STEPS * cfg.n_layers
                    * forwards(cfg),
                    flash_attention_bwd=MESH_DENSE_STEPS * cfg.n_layers)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    losses = res.losses
    first = statistics.mean(losses[:MESH_DENSE_POOL])
    last = statistics.mean(losses[-MESH_DENSE_POOL:])
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"{tag}: the pool loss did not fall: {losses}")
    step_fn = step.make_train_step(cfg, ctx, opt)
    state, ms = res.state, []
    for k in range(MESH_DENSE_TIMED):
        if k == MESH_DENSE_TIMED - 1:
            distributed.reset_collective_counts()
        sync()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, pool[k % MESH_DENSE_POOL],
                                 loop.step_generator(0, 1000 + k, DEV))
        float(metrics["loss"])
        ms.append((time.perf_counter() - t1) * 1e3)
    got = distributed.collective_counts(by_group=True)
    predicted = predict_dense_collectives(
        cfg, ctx, state.params, opt_name,
        pool[0]["tokens"].numel())
    if got != predicted:
        raise AssertionError(f"{tag}: one step's collectives {got} != the "
                             f"prediction {predicted}")
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if DEV.type == "cuda" else 0.0
    return {"losses": losses, "first": first, "last": last, "fit_s": wall,
            "launches": counts, "step_ms": ms, "collectives": got,
            "peak_gb": peak}


def mesh_dense_rank(ctx, mode: str, opt_name: str, lr: float) -> dict:
    """One mesh of phase 24 on this rank: the fp32 parity step, both
    attention kernels at the shard's shapes (in MESH_DENSE_TIMED_RUN timed
    by the world's rank 0 while the others wait), the bf16 fit."""
    tag = (f"{mode} ({ctx.axis_size('data')}, {ctx.tp}) rank "
           f"({ctx.data_index}, {ctx.model_index})")
    t0 = time.perf_counter()
    parity = mesh_dense_parity(ctx)
    gate(f"{tag} fp32 parity step", parity, MESH_RTOL)
    first = torch.distributed.get_rank() == 0
    kern = mesh_dense_kernels(ctx, timed=False) if not first else None
    torch.distributed.barrier()
    if first:
        kern = mesh_dense_kernels(ctx, timed=(mode, (
            ctx.axis_size("data"), ctx.tp)) == MESH_DENSE_TIMED_RUN)
    torch.distributed.barrier()
    fit = mesh_dense_fit(ctx, opt_name, lr, tag)
    return {"parity": parity, "kernels": kern, "fit": fit,
            "s": time.perf_counter() - t0}


def mesh_dense_nccl() -> dict[str, float]:
    """Phase 24a: NCCL on a (1, 1) mesh in this process, in each mode: one
    fp32 fit step with estimator "full" and MESH_STEP_OPT on the parity
    batch equal to the mesh=None step within MESH_STEP_RTOL (the loss, and
    every parameter over its own max).  Returns the errors."""
    backend = "nccl" if DEV.type == "cuda" else "gloo"
    launch_mesh.init_distributed(
        backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1)
    try:
        mesh = launch_mesh.make_debug_mesh(1, 1)
        errs = {}
        for mode in ("tp_fsdp", "pure_fsdp"):
            cfg = mesh_dense_cfg(mode, "float32", estimator="full")
            res = {}
            for tag, c in (("mesh", rules.mesh_ctx(mesh, mode=mode)),
                           ("unsharded", None)):
                res[tag] = loop.fit(
                    cfg, c, make_optimizer(*MESH_STEP_OPT),
                    batch_iterator_for(cfg, c, MESH_PARITY_BATCH,
                                       MESH_PARITY_SEQ, seed=0, device=DEV),
                    1, seed=0, log_every=0, device=DEV)
            want = dict(res["unsharded"].state.params.named_parameters())
            got = dict(res["mesh"].state.params.named_parameters())
            e = {"loss": abs(res["mesh"].losses[0]
                             - res["unsharded"].losses[0])
                 / abs(res["unsharded"].losses[0]),
                 **{k: rel_err(p, want[k]) for k, p in got.items()}}
            del res, want, got
            worst = max(e, key=e.get)
            log(f"[mesh dense] {backend} (1, 1) {mode}: one fp32 "
                f"full-softmax fit step ({MESH_STEP_OPT}) against the "
                f"unsharded one: loss {e['loss']}, worst parameter "
                f"{worst} {e[worst]} over its own max")
            gate(f"{backend} (1, 1) {mode} step", e, MESH_STEP_RTOL)
            errs[mode] = e[worst]
        return errs
    finally:
        torch.distributed.destroy_process_group()


def gate_losses_alike(key: str, ranks: list[dict]) -> None:
    """Every rank's fit losses of ``key`` equal to rank 0's within
    MESH_STEP_RTOL."""
    want = ranks[0][key]["fit"]["losses"]
    for r, res in enumerate(ranks):
        got = res[key]["fit"]["losses"]
        if any(abs(a - b) > MESH_STEP_RTOL * abs(b)
               for a, b in zip(got, want)):
            raise AssertionError(f"{key}: rank {r}'s losses {got} != rank "
                                 f"0's {want}")


def mesh_dense_report(ranks: list[dict], nccl: dict, ref_s: dict
                      ) -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 24's rank results logged and gated (losses alike on every
    rank): the bf16 fits' launches of each mesh, summed over its ranks,
    and both attention kernels' rows at each mesh's shard shapes (rank
    0's; MESH_DENSE_TIMED_RUN's timed) as kernels-line shapes
    ``mesh_<mode>_<dp>x<tp>``."""
    by_path, shapes = {}, {}
    for mode, (dp, tp), opt_name, lr in MESH_DENSE_RUNS:
        key = f"{mode} {dp}x{tp}"
        kern = ranks[0][key]["kernels"]
        shapes[f"mesh_{mode}_{dp}x{tp}"] = {
            name: {**kern[name], "shape": kern["shape"]}
            for name in ("flash_attention", "flash_attention_bwd")}
        total = dict.fromkeys(REPLACES, 0)
        for r, res in enumerate(ranks):
            m, fit = res[key], res[key]["fit"]
            worst = max(m["parity"], key=m["parity"].get)
            log(f"[mesh dense] gloo {mode} ({dp}, {tp}) rank {r}: fp32 "
                f"parity loss {m['parity']['loss']}, worst {worst} "
                f"{m['parity'][worst]} (of {len(m['parity'])} tensors, "
                f"over each whole tensor's max); attention at "
                f"{m['kernels']['shape']}: flash_attention "
                f"{m['kernels']['flash_attention']}, flash_attention_bwd "
                f"{m['kernels']['flash_attention_bwd']}")
            log(f"[mesh dense] gloo {mode} ({dp}, {tp}) rank {r}: "
                f"{MESH_DENSE_STEPS} bf16 fit steps (clip + {opt_name} "
                f"{lr}) in {fit['fit_s']:.3f} s, losses {fit['losses']} "
                f"(pool {fit['first']} -> {fit['last']}), launches "
                f"{ {k: v for k, v in fit['launches'].items() if v} }; "
                f"step ms {[round(x, 3) for x in fit['step_ms']]}; peak "
                f"{fit['peak_gb']:.3f} GB; one step's collectives (= the "
                f"prediction) {fit['collectives']}; the mesh "
                f"{m['s']:.1f} s")
            add_counts(total, fit["launches"])
        gate_losses_alike(key, ranks)
        by_path[f"mesh dense {mode} ({dp}, {tp})"] = total
    secs = [round(sum(r[f"{mode} {dp}x{tp}"]["s"]
                      for mode, (dp, tp), _, _ in MESH_DENSE_RUNS), 1)
            for r in ranks]
    log(f"[mesh dense] NCCL (1, 1) worst errors {nccl}; unsharded parity "
        f"steps {ref_s} s; the ranks' phase 24 {secs} s")
    return by_path, shapes


# ---------------------------------------------------------------------------
# Phase 25: the ssm, encdec and lstm families' layouts on the mesh
# ---------------------------------------------------------------------------

#: each gloo run of phase 25, after phase 24's in the same rank processes:
#: (config, mode, (dp, tp)); falcon-mamba-7b and whisper-large-v3 in
#: tp_fsdp (the mamba block channel-parallel, whisper's self attention and
#: MLP Megatron's) and in their configs' pure_fsdp, ptb-lstm in its
#: config's tp_fsdp at both shapes
MESH_FAMILY_RUNS = (("falcon-mamba-7b", "tp_fsdp", (1, 4)),
                    ("falcon-mamba-7b", "pure_fsdp", (2, 2)),
                    ("whisper-large-v3", "tp_fsdp", (1, 4)),
                    ("whisper-large-v3", "pure_fsdp", (2, 2)),
                    ("ptb-lstm", "tp_fsdp", (1, 4)),
                    ("ptb-lstm", "tp_fsdp", (2, 2)))
MESH_FAMILIES = tuple(dict.fromkeys(name for name, _, _ in MESH_FAMILY_RUNS))
#: the depth on the mesh, full width: falcon-mamba-7b's 2 of 64 layers,
#: whisper-large-v3's 2 + 2 of 32 + 32 (ptb-lstm whole)
MESH_FAMILY_LAYERS = {"falcon-mamba-7b": 2, "whisper-large-v3": 2}
#: (sequences, tokens) of the bf16 fit's batches (whisper: clips of
#: WHISPER_FRAMES frames and WHISPER_TEXT tokens; ptb-lstm's in fp32)
MESH_FAMILY_BATCH = {"falcon-mamba-7b": (4, 512),
                     "whisper-large-v3": (4, WHISPER_TEXT),
                     "ptb-lstm": (PTB_BATCH, PTB_SEQ)}
#: the fp32 parity step's batch
MESH_FAMILY_PARITY = {"falcon-mamba-7b": (4, 256),
                      "whisper-large-v3": (4, WHISPER_TEXT),
                      "ptb-lstm": (PTB_BATCH, PTB_SEQ)}
MESH_FAMILY_STEPS = 2
#: the fit's optimizer and lr: phase 20's, phase 22c's and phase 9b's
MESH_FAMILY_OPT = {"falcon-mamba-7b": ("adafactor", HYBRID_LR),
                   "whisper-large-v3": ("adamw", WHISPER_LR),
                   "ptb-lstm": ("adamw", 1e-2)}
MESH_FAMILY_SEED = 25
#: the parity step's loss takes the plain softmax: ptb-lstm's config takes
#: the logits' absolute values (abs_softmax), whose kink at 0 turns a
#: last-bit change of h (a data block's GEMM shapes) into a flipped
#: gradient of a logit near 0; its fp32 step is off from float64 by up to
#: ~1e-4 of a gradient's max there, 5e-7 without
#: (tools/abs_softmax_fp32_floor.py), against MESH_RTOL's 1e-5
MESH_PARITY_ABS = False
#: the whisper shard shape phase 25 times, (mode, attention kind); the
#: others are checked only.  tp_fsdp's encoder, 4 clips of 5 of 20 heads
#: a rank, is the largest shape no other phase runs (the decoder's is a
#: tenth of its work; the cross attention and pure_fsdp's are phase
#: 22a's shapes at a smaller batch).  Timing all six took 90 s of the
#: script on one H100, timing three 23.5-61.5 s
MESH_WHISPER_TIMED = ("tp_fsdp", "enc")
#: seconds the parent waits for the rank processes of phases 24 to 26
MESH_LAYOUTS_TIMEOUT_S = 900


def mesh_family_cfg(name: str, mode: str, dtype: str | None = None,
                    **changes):
    """``name`` at full width and MESH_FAMILY_LAYERS, trained in ``mode``,
    in ``dtype`` (default the config's)."""
    cfg = get_config(name)
    n = MESH_FAMILY_LAYERS.get(name)
    if n and cfg.family == "encdec":
        changes.update(n_enc_layers=n, n_dec_layers=n, n_layers=2 * n)
    elif n:
        changes.update(n_layers=n)
    if dtype:
        changes.update(dtype=dtype, param_dtype=dtype)
    return dataclasses.replace(cfg, train_sharding=mode, **changes)


def mesh_family_model(cfg, ctx) -> torch.nn.Module:
    """The whole model from MESH_FAMILY_SEED, padded as the init pads it
    for this rank's mesh ``ctx`` (the vocab to the head's vocab-parallel
    degree, the heads to the backbone's TP degree; ptb-lstm's table is
    padded by ``step.shard_params``)."""
    gen = torch.Generator(DEV).manual_seed(MESH_FAMILY_SEED)
    if cfg.family == "encdec":
        return encdec.EncDec(cfg, DEV, tree=encdec.init_encdec(
            gen, cfg, DEV, ctx=ctx))
    if cfg.family == "lstm":
        return lstm_lm.init_lstm_lm(gen, cfg, DEV)
    return transformer.StackedLM(cfg, DEV, tree=transformer.init_lm(
        gen, cfg, DEV, ctx=ctx))


def mesh_family_batches(cfg, ctx, shape: tuple[int, int], n: int,
                        seed: int) -> list[dict]:
    """``n`` batches of ``shape`` (whisper's with frames; on a mesh the
    rank's rows)."""
    b, s = shape
    if cfg.family == "encdec":
        return whisper_pool(cfg, seed, b, n, ctx)
    data = batch_iterator_for(cfg, ctx, b, s, seed=seed, device=DEV)
    return [next(data) for _ in range(n)]


def mesh_family_parity(ctx, name: str) -> tuple[dict[str, float], float]:
    """This rank's fp32 parity step (``parity_step``: estimator "full" in
    plain softmax mode (MESH_PARITY_ABS), clip + Adafactor) on its shards
    and batch rows against the unsharded
    step, which the rank runs first on its own copy of the whole model:
    the loss's relative error, and each gradient shard and updated shard
    against its slice over the whole tensor's max; and the unsharded
    step's seconds."""
    t0 = time.perf_counter()
    cfg = mesh_family_cfg(name, ctx.mode, "float32", estimator="full",
                          abs_softmax=MESH_PARITY_ABS)
    batch = mesh_family_batches(cfg, None, MESH_FAMILY_PARITY[name], 1,
                                MESH_FAMILY_SEED)[0]
    model = step.shard_params(mesh_family_model(cfg, ctx), cfg, ctx)
    specs = model.param_specs
    pad = step.PADDED_TABLES.get(cfg.family, ())
    loss, grads, params = parity_step(cfg, None,
                                      mesh_family_model(cfg, ctx), batch)
    want = {}
    for kind, got in (("grad", grads), ("param", params)):
        for k, x in got.items():
            x = x.detach()
            whole = rules.pad_rows(x, ctx.tp) if k in pad else x
            want[f"{kind} {k}"] = (rules.shard_by_spec(whole, specs[k], ctx),
                                   max(float(x.abs().max()), 1e-30))
    del grads, params, got, x, whole
    sync()
    torch.cuda.empty_cache()
    unsharded_s = time.perf_counter() - t0
    got_loss, grads, params = parity_step(
        cfg, ctx, model, {k: rules.batch_rows(v, ctx)
                          for k, v in batch.items()})
    errs = {"loss": abs(got_loss - loss) / abs(loss)}
    for kind, got in (("grad", grads), ("param", params)):
        for k, x in got.items():
            block, scale = want[f"{kind} {k}"]
            errs[f"{kind} {k}"] = float((x.detach().float() - block.float())
                                        .abs().max() / scale)
    del want, grads, params, model, batch
    torch.cuda.empty_cache()
    return errs, unsharded_s


def mesh_zstats_check(ctx, cfg, head_local: torch.Tensor, tag: str
                      ) -> float:
    """zstats at this rank's head shard's blocks (projected to
    ``sampler_proj_rank`` as the shared sampler's are, by a seeded random
    projection), against its plain version."""
    r = cfg.sampler_proj_rank
    gen = torch.Generator(DEV).manual_seed(MESH_FAMILY_SEED)
    proj = None if not r else torch.randn(
        (r, head_local.shape[1]), generator=gen, device=DEV) / math.sqrt(r)
    stats = blocks.build(head_local.detach().float(), cfg.sampler_block,
                         proj=proj, n_valid=step.shard_n_valid(cfg, ctx))
    wq = stats.wq
    return compare(f"{tag} zstats {tuple(wq.shape)}", zstats(wq),
                   ref.zstats_ref(wq))


def mesh_whisper_kernels(ctx, cfg) -> dict[str, dict]:
    """Both attention kernels at whisper's shard shapes on this rank: the
    encoder's and the decoder's self attention over its heads
    (n_heads / tp_backbone) and the cross attention's whole 20 heads (its
    weights are replicated), its batch rows; against their plain versions
    with phase 22a's gates, MESH_WHISPER_TIMED's shape also timed.  Rows
    by attention kind."""
    gen = torch.Generator(DEV).manual_seed(MESH_FAMILY_SEED)
    b = MESH_FAMILY_BATCH[cfg.name][0] // ctx.dp
    own = cfg.n_heads // ctx.tp_backbone
    rows = {}
    for kind, s, sk, causal, h in (
            ("enc", WHISPER_FRAMES, WHISPER_FRAMES, False, own),
            ("dec", WHISPER_TEXT, WHISPER_TEXT, True, own),
            ("cross", WHISPER_TEXT, WHISPER_FRAMES, False, cfg.n_heads)):
        shape = [b, s, sk, h, h, WHISPER_HD]
        timed = (ctx.mode, kind) == MESH_WHISPER_TIMED
        rows[kind] = {
            "flash_attention": {**flash_cross_row(
                gen, b, s, sk, causal, h=h, kv=h, timed=timed),
                "shape": shape},
            "flash_attention_bwd": {**flash_bwd_case(
                gen, b, s, h, h, WHISPER_HD, torch.bfloat16, causal=causal,
                timed=timed, sk=sk), "shape": shape}}
    return rows


def mesh_family_fit(ctx, name: str, tag: str) -> dict:
    """MESH_FAMILY_STEPS ``fit`` steps (the config's dtype: bf16, ptb-lstm
    fp32) on a pool of MESH_DENSE_POOL batches of the rank's rows: exact
    launches (the sampler's as ``expected_launches``; whisper's attention
    twice a call under remat, its backward once), finite losses; the
    steps' ms as ``fit`` logs them, the fit's collectives and the rank's
    peak; then zstats at the trained head shard's blocks (falcon,
    whisper) or, for ptb-lstm, the sampler's three kernels at the rank's
    shard shapes (``mesh_kernel_check``) against their plain versions and
    the fused head (``fused_lse``, ``fused_lse_bwd``) at them, in the
    config's abs mode at given negatives (``mesh_sampled_check``: loss and
    gradients against a one-device replay, MESH_RTOL)."""
    cfg = mesh_family_cfg(name, ctx.mode)
    opt_name, lr = MESH_FAMILY_OPT[name]
    opt = make_optimizer(opt_name, lr)
    pool = mesh_family_batches(cfg, ctx, MESH_FAMILY_BATCH[name],
                               MESH_DENSE_POOL, seed=0)
    sync()
    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    distributed.reset_collective_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = loop.fit(cfg, ctx, opt, CycledPool(pool), MESH_FAMILY_STEPS,
                       seed=0, log_every=1, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    collectives = distributed.collective_counts(by_group=True)
    want = dict.fromkeys(REPLACES, 0)
    if DEV.type == "cuda":
        want = expected_launches(cfg, MESH_FAMILY_STEPS)
        calls = attn_calls(cfg) if cfg.family == "encdec" else 0
        want.update(flash_attention=MESH_FAMILY_STEPS * calls
                    * forwards(cfg),
                    flash_attention_bwd=MESH_FAMILY_STEPS * calls)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"{tag}: losses {res.losses}")
    step_ms = [float(x) for x in re.findall(r"\((\d+) ms\)",
                                            printed.getvalue())]
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if DEV.type == "cuda" else 0.0
    with torch.no_grad():
        head = api.head_table(res.state.params, cfg, ctx)
    sampled = None
    if cfg.family == "lstm":
        gen = torch.Generator(DEV).manual_seed(MESH_FAMILY_SEED)
        d = head.shape[1]
        w = torch.randn((cfg.vocab_size, d), generator=gen, device=DEV) * 0.05
        t = pool[0]["tokens"].numel() * ctx.dp
        h = torch.randn((t, d), generator=gen, device=DEV)
        labels = torch.randint(0, cfg.vocab_size, (t,), generator=gen,
                               device=DEV)
        kern = mesh_kernel_check(ctx, cfg, w, h)
        sampled = {"errors": mesh_sampled_check(
            ctx, w, h, labels, cfg.m_negatives, cfg.abs_softmax,
            seed=MESH_FAMILY_SEED),
            "shard (T, V, m, d)": [t // ctx.dp, cfg.vocab_size // ctx.tp,
                                   cfg.m_negatives // ctx.tp, d],
            "abs_mode": cfg.abs_softmax}
        gate(f"{tag} sampled softmax at given negatives", sampled["errors"],
             MESH_RTOL)
        del w, h, labels
    else:
        kern = {"zstats": mesh_zstats_check(ctx, cfg, head, tag)}
    losses = res.losses
    del head, res, pool
    return {"losses": losses, "fit_s": wall, "launches": counts,
            "step_ms": step_ms, "collectives": collectives, "peak_gb": peak,
            "kernels": kern, "sampled": sampled}


def mesh_family_rank(ctx, name: str) -> dict:
    """One run of phase 25 on this rank: the fp32 parity step (the loss
    within MESH_STEP_RTOL, each shard within MESH_RTOL), whisper's
    attention kernels at the shard's shapes (checked, and at
    MESH_WHISPER_TIMED's shape timed, by the world's rank 0 while the
    others wait), the fit."""
    tag = (f"{name} {ctx.mode} ({ctx.axis_size('data')}, {ctx.tp}) rank "
           f"({ctx.data_index}, {ctx.model_index})")
    t0 = time.perf_counter()
    parity, unsharded_s = mesh_family_parity(ctx, name)
    gate(f"{tag} fp32 parity loss", {"loss": parity["loss"]},
         MESH_STEP_RTOL)
    gate(f"{tag} fp32 parity step", parity, MESH_RTOL)
    secs = {"parity": time.perf_counter() - t0, "unsharded": unsharded_s}
    attn = None
    if get_config(name).family == "encdec":
        t1 = time.perf_counter()
        torch.distributed.barrier()
        if torch.distributed.get_rank() == 0:
            attn = mesh_whisper_kernels(ctx, mesh_family_cfg(name, ctx.mode))
        torch.distributed.barrier()
        secs["attention"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    fit = mesh_family_fit(ctx, name, tag)
    secs["fit"] = time.perf_counter() - t1
    secs = {k: round(v, 1) for k, v in secs.items()}
    log(f"{tag}: seconds {secs}")
    return {"parity": parity, "attention": attn, "fit": fit, "secs": secs,
            "s": time.perf_counter() - t0}


def mesh_family_nccl() -> dict[str, float]:
    """Phase 25a: NCCL on a (1, 1) mesh in this process, each family in its
    config's mode: one fp32 fit step with estimator "full" and
    MESH_STEP_OPT on its parity batch equal to the mesh=None step within
    MESH_STEP_RTOL (the loss, and every parameter over its own max).
    Returns each family's worst error."""
    backend = "nccl" if DEV.type == "cuda" else "gloo"
    launch_mesh.init_distributed(
        backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1)
    try:
        mesh = launch_mesh.make_debug_mesh(1, 1)
        errs = {}
        for name in MESH_FAMILIES:
            mode = get_config(name).train_sharding
            cfg = mesh_family_cfg(name, mode, "float32", estimator="full")
            batch = mesh_family_batches(cfg, None, MESH_FAMILY_PARITY[name],
                                        1, MESH_FAMILY_SEED)
            res = {}
            for tag, c in (("mesh", rules.mesh_ctx(mesh, mode=mode)),
                           ("unsharded", None)):
                res[tag] = loop.fit(
                    cfg, c, make_optimizer(*MESH_STEP_OPT), CycledPool(batch),
                    1, seed=0, log_every=0, device=DEV)
            want = dict(res["unsharded"].state.params.named_parameters())
            got = dict(res["mesh"].state.params.named_parameters())
            e = {"loss": abs(res["mesh"].losses[0]
                             - res["unsharded"].losses[0])
                 / abs(res["unsharded"].losses[0]),
                 **{k: rel_err(p, want[k]) for k, p in got.items()}}
            del res, want, got, batch
            sync()
            if DEV.type == "cuda":
                torch.cuda.empty_cache()
            worst = max(e, key=e.get)
            log(f"[mesh families] {backend} (1, 1) {name} {mode}: one fp32 "
                f"full-softmax fit step ({MESH_STEP_OPT}) against the "
                f"unsharded one: loss {e['loss']}, worst parameter {worst} "
                f"{e[worst]} over its own max ({len(e) - 1} parameters)")
            gate(f"{backend} (1, 1) {name} step", e, MESH_STEP_RTOL)
            errs[name] = e[worst]
        return errs
    finally:
        torch.distributed.destroy_process_group()


def mesh_family_report(ranks: list[dict], nccl: dict
                       ) -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 25's rank results logged and gated (losses alike on every
    rank): each run's launches summed over its ranks, and whisper's
    attention rows at each mesh's shard shapes (rank 0's) as kernels-line
    shapes ``mesh_whisper_<mode>_<dp>x<tp>_<enc|dec|cross>``."""
    by_path, shapes = {}, {}
    for name, mode, (dp, tp) in MESH_FAMILY_RUNS:
        key = f"{name} {mode} {dp}x{tp}"
        attn = ranks[0][key]["attention"]
        for kind, row in (attn or {}).items():
            shapes[f"mesh_whisper_{mode}_{dp}x{tp}_{kind}"] = row
            log(f"[mesh families] {key}: {kind} attention at the shard "
                f"shape {row['flash_attention']['shape']}: flash_attention "
                f"{row['flash_attention']}, flash_attention_bwd "
                f"{row['flash_attention_bwd']}")
        total = dict.fromkeys(REPLACES, 0)
        for r, res in enumerate(ranks):
            m, fit = res[key], res[key]["fit"]
            worst = max(m["parity"], key=m["parity"].get)
            log(f"[mesh families] gloo {key} rank {r}: fp32 parity loss "
                f"{m['parity']['loss']}, worst {worst} {m['parity'][worst]} "
                f"(of {len(m['parity'])} tensors, over each whole tensor's "
                f"max); {MESH_FAMILY_STEPS} fit steps (clip + "
                f"{MESH_FAMILY_OPT[name]}) in {fit['fit_s']:.3f} s, losses "
                f"{fit['losses']}, step ms {fit['step_ms']}, launches "
                f"{ {k: v for k, v in fit['launches'].items() if v} }; peak "
                f"{fit['peak_gb']:.3f} GB; kernels at the shard's shapes, "
                f"max abs err {fit['kernels']}; the sampled softmax at "
                f"given negatives (fused_lse, fused_lse_bwd) {fit['sampled']}"
                f"; the fit's collectives "
                f"{fit['collectives']}; the run {m['s']:.1f} s "
                f"({m['secs']})")
            add_counts(total, fit["launches"])
        gate_losses_alike(key, ranks)
        by_path[f"mesh {name} {mode} ({dp}, {tp})"] = total
    secs = [round(sum(r[f"{name} {mode} {dp}x{tp}"]["s"]
                      for name, mode, (dp, tp) in MESH_FAMILY_RUNS), 1)
            for r in ranks]
    log(f"[mesh families] NCCL (1, 1) worst errors {nccl}; the ranks' "
        f"phase 25 {secs} s")
    return by_path, shapes


# ---------------------------------------------------------------------------
# Phase 26: expert parallelism and the sequence-sharded residual stream
# ---------------------------------------------------------------------------

#: each gloo run of phase 26, after phase 25's in the same rank processes:
#: (config, (dp, tp), layers), tp_fsdp with the configs' seq_residuals.
#: dbrx-132b, the slice's path, at (1, 4) (4 of its 16 experts a rank,
#: 2 of its 40 layers) and at (2, 2) (8 a rank, ZeRO-3 over data: a
#: forward run gathers 3.17 GB of experts a rank, so 1 layer);
#: deepseek-v3-671b at its 3 dense MLA layers and the mtp block (its
#: 256-expert layers stay off the card: one holds 11.3 B parameters);
#: jamba-v0.1-52b at 5 of its 32 layers (mamba+mlp, mamba+moe, mamba+mlp,
#: mamba+moe, attn+mlp)
MESH_EXPERT_RUNS = (("dbrx-132b", (1, 4), 2), ("dbrx-132b", (2, 2), 1),
                    ("deepseek-v3-671b", (1, 4), 3),
                    ("jamba-v0.1-52b", (1, 4), 5))
#: (sequences, tokens) of a fit's batch, in the configs' microbatches
#: (dbrx and deepseek 2, jamba 8): tp 4 divides S, so the residual
#: stream is S-sharded (mtp's S - 1 rows stay replicated)
MESH_EXPERT_BATCH = {"dbrx-132b": (4, 1024), "deepseek-v3-671b": (4, 512),
                     "jamba-v0.1-52b": (8, 512)}
#: fit steps on a pool of one batch, the fewest a falling loss needs, by
#: mesh; the (2, 2) run takes its fp32 parity and its kernel checks and
#: no fit: its ZeRO-3 gathers of the experts over data move 16.1 GB a
#: rank a step (2 microbatches, remat) through gloo, and 2 steps took
#: 216 s of the script's 1,200 (H100 80GB HBM3, 700 W)
MESH_EXPERT_STEPS = {(1, 4): 2, (2, 2): 0}
#: Adafactor's lr of the fits: a few steps at 2 to 5 layers
MESH_EXPERT_LR = 1e-3
#: the fp32 parity step: dbrx-132b at 1 layer (4.49 B parameters, 18 GB,
#: and as much again of gradients) on 4 sequences of 256 tokens, at
#: (1, 4)
MESH_EXPERT_PARITY = ("dbrx-132b", 1, (4, 256))
#: the mesh whose fp32 parity holds dbrx's MoE layer alone (its experts
#: gathered over data, each data shard's capacity from its own rows, the
#: router's gradient summed over both axes) on the same rows: the whole
#: model's step there holds ~20 GB a rank (the gathered experts, the
#: head's and the embedding's gathers and gradients), more than a quarter
#: of the card the four ranks share: it ran out of memory on an H100
#: 80GB HBM3
MESH_EXPERT_MOE_PARITY = (2, 2)
#: the runs whose attention and zstats shard shapes rank 0 times (the
#: others are checked only)
MESH_EXPERT_TIMED = (("dbrx-132b", (1, 4)), ("deepseek-v3-671b", (1, 4)),
                     ("jamba-v0.1-52b", (1, 4)))
MESH_EXPERT_SEED = 26
#: where the parent leaves the unsharded parity step's gradients
MESH_EXPERT_DIR = MESH_DIR.parent / "chip_smoke_mesh_experts"


def mesh_expert_cfg(name: str, layers: int, dtype: str | None = None,
                    **changes):
    """``name`` at full width and ``layers`` layers in tp_fsdp (its own
    seq_residuals), in ``dtype`` (default the config's)."""
    if dtype:
        changes.update(dtype=dtype, param_dtype=dtype)
    return dataclasses.replace(get_config(name), n_layers=layers,
                               train_sharding="tp_fsdp", **changes)


def mesh_expert_parity_cfg():
    name, layers, _ = MESH_EXPERT_PARITY
    return mesh_expert_cfg(name, layers, "float32", estimator="full",
                           abs_softmax=MESH_PARITY_ABS, remat=False)


def mesh_expert_model(cfg, ctx=None) -> torch.nn.Module:
    """The model from MESH_EXPERT_SEED: whole, or on a mesh drawn straight
    into the rank's shards (the same weights)."""
    return api.init_module(cfg, torch.Generator(DEV).manual_seed(
        MESH_EXPERT_SEED), device=DEV, ctx=ctx)


def mesh_expert_batch(cfg, shape: tuple[int, int], ctx=None) -> dict:
    b, s = shape
    return next(batch_iterator_for(cfg, ctx, b, s, seed=MESH_EXPERT_SEED,
                                   device=DEV))


class DropProbe:
    """While on: the first MoE dispatch's drops on this rank's experts as
    the layer slots them (its capacity), against the unsharded layer's on
    the same rows (``moe._route`` and ``moe.capacity`` of those rows), and
    the unsharded layer's drops on all its experts.  ``rows`` keeps the
    dispatch's tokens and router for other splits of them."""

    def __init__(self):
        self.got, self.rows = None, None

    def __enter__(self):
        self._apply, self._dcc = moe.apply_moe, moe._dispatch_compute_combine
        probe = self

        def apply(p, x, cfg, *args, **kwargs):
            probe._p = p
            return probe._apply(p, x, cfg, *args, **kwargs)

        def dcc(x2d, ids, w, wg, wu, wd, cfg, cap, e_lo=0):
            if probe.got is None:
                with torch.no_grad():
                    e_l = wg.shape[0]
                    ids_u = moe._route(probe._p, x2d, cfg)[0]
                    cap_u = moe.capacity(x2d.shape[0], cfg)
                    probe.got = {
                        "rows": x2d.shape[0], "capacity": cap,
                        "unsharded_capacity": cap_u,
                        "experts": [e_lo, e_l],
                        "mesh": moe.dropped(ids, cfg, cap, e_lo, e_l),
                        "unsharded": moe.dropped(ids_u, cfg, cap_u, e_lo,
                                                 e_l),
                        "unsharded_all": moe.dropped(ids_u, cfg, cap_u)}
                    probe.rows = (x2d.detach().clone(),
                                  {k: probe._p[k] for k in
                                   ("router", "router_bias")
                                   if k in probe._p})
            return probe._dcc(x2d, ids, w, wg, wu, wd, cfg, cap, e_lo)

        moe.apply_moe, moe._dispatch_compute_combine = apply, dcc
        return self

    def __exit__(self, *exc):
        moe.apply_moe, moe._dispatch_compute_combine = self._apply, self._dcc
        self._p = None


@contextlib.contextmanager
def ranks_draw_in_turn():
    """While on, ``api.init_module`` runs on one rank of the world at a
    time (a barrier after each): the four ranks share one card, and each
    draws one layer whole before it keeps its shards of it (a dbrx-132b
    layer is 13 GB in fp32), so only one rank's layer is whole at a
    time."""
    real = api.init_module

    def init(*args, **kwargs):
        out = None
        for r in range(torch.distributed.get_world_size()):
            if torch.distributed.get_rank() == r:
                out = real(*args, **kwargs)
                sync()
                if DEV.type == "cuda":
                    torch.cuda.empty_cache()
            torch.distributed.barrier()
        return out

    api.init_module = init
    try:
        yield
    finally:
        api.init_module = real


class LastStepCollectives(CycledPool):
    """``CycledPool`` that resets the collective counts as ``fit`` draws
    its last step's batch: after the fit they hold that step's."""

    def __init__(self, pool: list, steps: int):
        super().__init__(pool)
        self.steps = steps

    def __next__(self) -> dict:
        if self.i == self.steps - 1:
            distributed.reset_collective_counts()
        return super().__next__()


def mesh_expert_nccl() -> dict[str, float]:
    """Phase 26a: NCCL on a (1, 1) mesh in this process: dbrx-132b at
    MESH_EXPERT_PARITY's 1 layer, one fp32 full-softmax fit step with
    MESH_STEP_OPT on the parity batch against the unsharded step (the
    one-rank group's collectives leave every number as it is: within
    MESH_STEP_RTOL, as phases 24a and 25a).  Returns the worst error."""
    backend = "nccl" if DEV.type == "cuda" else "gloo"
    launch_mesh.init_distributed(
        backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1)
    try:
        mesh = launch_mesh.make_debug_mesh(1, 1)
        cfg = dataclasses.replace(mesh_expert_parity_cfg(), remat=True)
        batch = mesh_expert_batch(cfg, MESH_EXPERT_PARITY[2])
        res = {}
        for tag, c in (("mesh", rules.ctx_for_train(mesh, cfg)),
                       ("unsharded", None)):
            res[tag] = loop.fit(cfg, c, make_optimizer(*MESH_STEP_OPT),
                                CycledPool([batch]), 1,
                                seed=MESH_EXPERT_SEED, log_every=0,
                                device=DEV)
            if tag == "mesh":  # keep its parameters, free the rest
                res[tag] = (res[tag].losses, dict(
                    res[tag].state.params.named_parameters()))
            sync()
        want = dict(res["unsharded"].state.params.named_parameters())
        losses, got = res["mesh"]
        e = {"loss": abs(losses[0] - res["unsharded"].losses[0])
             / abs(res["unsharded"].losses[0]),
             **{k: rel_err(p, want[k]) for k, p in got.items()}}
        exact = sum(torch.equal(p, want[k]) for k, p in got.items())
        del res, want, got, batch
        sync()
        if DEV.type == "cuda":
            torch.cuda.empty_cache()
        worst = max(e, key=e.get)
        log(f"[mesh experts] {backend} (1, 1) {cfg.name} at {cfg.n_layers} "
            f"layer(s), fp32, remat: one full-softmax fit step "
            f"({MESH_STEP_OPT}) against the unsharded one: loss "
            f"{e['loss']}, worst parameter {worst} {e[worst]} over its own "
            f"max; {exact} of {len(e) - 1} parameters bitwise equal")
        gate(f"{backend} (1, 1) {cfg.name} step", e, MESH_STEP_RTOL)
        return {"worst": e[worst], "bitwise": exact, "of": len(e) - 1}
    finally:
        torch.distributed.destroy_process_group()


def mesh_expert_reference() -> dict:
    """The unsharded fp32 parity references (``mesh_expert_parity_cfg``),
    saved for the ranks: (a) the whole model's step on the parity batch
    (the (1, 4) mesh's one data shard): its loss, each gradient and its
    max |g|; (b) its MoE layer alone on random rows x of the batch's shape
    against a random cotangent, L = sum(y * ct): for each of the
    MESH_EXPERT_MOE_PARITY mesh's data shards the mesh-free layer on that
    shard's rows (its own capacity), the experts' and the router's
    gradients summed over the shards, dL/dx and y.  Each run's drops on
    the layer are logged.  Returns its seconds, loss and drops."""
    t0 = time.perf_counter()
    shutil.rmtree(MESH_EXPERT_DIR, ignore_errors=True)
    MESH_EXPERT_DIR.mkdir(parents=True)
    cfg = mesh_expert_parity_cfg()
    for name, (_, tp), _ in MESH_EXPERT_RUNS:
        if name == MESH_EXPERT_PARITY[0] and \
                layers.padded_heads(cfg, tp) != layers.padded_heads(cfg):
            raise ValueError(f"{cfg.name}'s heads pad at tp {tp}: its "
                             "shards are not of the unsharded tree")
    model = mesh_expert_model(cfg)
    batch = mesh_expert_batch(cfg, MESH_EXPERT_PARITY[2])
    grads: dict[str, torch.Tensor] = {}

    def keep(g, state, params):
        grads.update({k: x.cpu() for k, x in g.items()})
        return {}, state

    with DropProbe() as probe:
        metrics = step.make_train_step(
            cfg, None, GradientTransform(lambda p: (), keep))(
            step.TrainState(model, (), step.empty_state(), 0), batch,
            torch.Generator(DEV).manual_seed(1))[1]
    loss, drops = float(metrics["loss"]), probe.got["unsharded_all"]
    del probe, metrics
    torch.save({"loss": loss, "grads": grads,
                "max": {k: float(g.abs().max()) for k, g in grads.items()}},
               MESH_EXPERT_DIR / "unsharded.pt")
    grads.clear()
    log(f"[mesh experts] the unsharded fp32 parity step of {cfg.name} at "
        f"{cfg.n_layers} layer(s) on {MESH_EXPERT_PARITY[2]}: loss {loss}, "
        f"the MoE layer's drops {drops} (of "
        f"{batch['tokens'].numel() * cfg.moe_top_k} assignments); saved, "
        f"{time.perf_counter() - t0:.1f} s")
    p = model.tree()["segments"][0][0]["moe"]
    x, ct = moe_parity_rows(cfg)
    dp = MESH_EXPERT_MOE_PARITY[0]
    per = x.shape[0] // dp
    moe_drops, ys, dxs = [], [], []
    for i in range(dp):
        xi = x[i * per:(i + 1) * per].clone().requires_grad_()
        with DropProbe() as probe:
            y, _ = moe.apply_moe(p, xi, cfg)
        got = torch.autograd.grad(torch.sum(y * ct[i * per:(i + 1) * per]),
                                  [xi, *p.values()])
        for k, g in zip(p, got[1:]):
            grads[k] = g if k not in grads else grads[k].add_(g)
        moe_drops.append(probe.got["unsharded_all"])
        ys.append(y.detach())
        dxs.append(got[0])
        del probe, got, y
    torch.save({"y": torch.cat(ys).cpu(), "dx": torch.cat(dxs).cpu(),
                "grads": {k: g.cpu() for k, g in grads.items()},
                "max": {k: float(g.abs().max()) for k, g in grads.items()}},
               MESH_EXPERT_DIR / "moe.pt")
    del grads, model, batch, p, ys, dxs, x, ct, xi
    sync()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[mesh experts] the mesh-free MoE layer of {cfg.name} on each of "
        f"{dp} data shards' rows of {MESH_EXPERT_PARITY[2]}: drops by shard "
        f"{moe_drops}; saved, {secs:.1f} s in all")
    return {"s": secs, "loss": loss, "drops": drops, "moe_drops": moe_drops}


def moe_parity_rows(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer parity's rows x and cotangent ct, (B, S, d) fp32 at
    MESH_EXPERT_PARITY's batch shape, from MESH_EXPERT_SEED: x shares one
    random direction (twice a row's own scale), so the router sends many
    rows to the same experts and each data shard's capacity drops some."""
    gen = torch.Generator(DEV).manual_seed(MESH_EXPERT_SEED + 1)
    b, s = MESH_EXPERT_PARITY[2]
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=DEV)
    x += 2.0 * torch.randn((cfg.d_model,), generator=gen, device=DEV)
    return x, torch.randn((b, s, cfg.d_model), generator=gen, device=DEV)


def mesh_expert_parity(ctx) -> dict[str, float]:
    """This rank's fp32 parity step on its shards (drawn from the same
    seed) and batch rows against the parent's unsharded step
    (``mesh_expert_reference``): the loss's relative error and each
    gradient shard's error over the whole gradient's max, compared leaf
    by leaf as the step hands them to the optimizer (no second copy of
    the gradients)."""
    cfg = mesh_expert_parity_cfg()
    want = torch.load(MESH_EXPERT_DIR / "unsharded.pt", mmap=True,
                      weights_only=True)
    model = mesh_expert_model(cfg, ctx)
    specs = model.param_specs
    batch = {k: rules.batch_rows(v, ctx) for k, v in
             mesh_expert_batch(cfg, MESH_EXPERT_PARITY[2]).items()}
    errs: dict[str, float] = {}

    def update(grads, state, params):
        for k, g in grads.items():
            block = rules.shard_by_spec(want["grads"][k], specs[k],
                                        ctx).to(DEV)
            errs[k] = float((g.float() - block).abs().max()) / max(
                want["max"][k], 1e-30)
            del block
        return {}, state

    metrics = step.make_train_step(
        cfg, ctx, GradientTransform(lambda p: (), update))(
        step.TrainState(model, (), step.empty_state(), 0), batch,
        torch.Generator(DEV).manual_seed(1))[1]
    errs["loss"] = abs(float(metrics["loss"]) - want["loss"]) / abs(
        want["loss"])
    del want, model, batch
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
    return errs


def mesh_expert_moe_parity(ctx) -> dict[str, float]:
    """dbrx's MoE layer alone on this rank in fp32 (``apply_moe`` on the
    mesh: its expert shards gathered over data, its data rows' S-shard in
    and out) against the parent's mesh-free layer on each data shard's
    rows: y's and dL/dx's S-shards, and each leaf's gradient shard as the
    train step reduces it (the experts' by their gather's backward, the
    router's summed over both axes: ``rules.model_partial``), each over
    the whole tensor's max."""
    cfg = mesh_expert_parity_cfg()
    want = torch.load(MESH_EXPERT_DIR / "moe.pt", mmap=True,
                      weights_only=True)
    model = mesh_expert_model(cfg, ctx)
    names = {k: f"segments.0.0.moe.{k}" for k in want["grads"]}
    p = {k: model.get_parameter(n) for k, n in names.items()}
    specs = {k: model.param_specs[n] for k, n in names.items()}
    del model
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
    x, ct = (rules.batch_rows(t, ctx) for t in moe_parity_rows(cfg))
    seq = rules.seq_sharded(ctx, x.shape[1])
    spec = (None, ctx.model_axis) if seq else (None,)
    x, ct = (rules.shard_by_spec(t, spec, ctx) for t in (x, ct))
    x.requires_grad_()
    y, _ = moe.apply_moe(rules.gather_tree(p, specs, ctx), x, cfg, ctx, seq)
    got = torch.autograd.grad(torch.sum(y * ct), [x, *p.values()])
    rows = {k: rules.shard_by_spec(rules.batch_rows(want[k], ctx), spec,
                                   ctx).to(DEV) for k in ("y", "dx")}
    errs = {"y": rel_err(y, rows["y"]), "dx": rel_err(got[0], rows["dx"])}
    for (k, leaf), g in zip(p.items(), got[1:]):
        axes = rules.grad_reduce_axes(specs[k], ctx, rules.model_partial(
            names[k], specs[k], ctx, seq))
        if axes:
            distributed.all_reduce_(g, "sum", ctx.group(axes))
        block = rules.shard_by_spec(want["grads"][k], specs[k], ctx).to(DEV)
        errs[k] = float((g - block).abs().max()) / max(want["max"][k], 1e-30)
        del block
    del want, got, y, p
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
    return errs


def zstats_row(gen: torch.Generator, nb: int, b: int, r: int,
               timed: bool) -> dict:
    """zstats on (nb, b, r) random blocks against its plain version;
    ``timed`` adds its times beside the plain version's and ``bmm``'s and
    its bound (phase 3's)."""
    w = torch.randn((nb, b, r), generator=gen, device=DEV)
    err = compare(f"zstats {(nb, b, r)}", zstats(w), ref.zstats_ref(w))
    row = {"max_abs_err": err, "shape": [nb, b, r]}
    if timed:
        wt = w.transpose(1, 2)
        bms, by = bound_ms(4 * (nb * b * r + nb * r * r), nb * b * r * (r + 1))
        row.update(bound_ms=bms, bound_by=by, **times(
            lambda: zstats(w), lambda: ref.zstats_ref(w),
            lambda: torch.bmm(wt, w)))
    return row


def mesh_expert_kernels(ctx, cfg, timed: bool) -> dict:
    """zstats at this rank's head shard's blocks (v_l / sampler_block
    blocks of sampler_block rows, its sampler's projection width) and both
    attention kernels at the shard's shapes (a microbatch's rows of the
    data shard; n_heads / tp q heads over n_kv / tp, hd 128; MLA's 128 /
    tp heads at (192, 128)), against their plain versions; ``timed`` adds
    their times (SDPA beside the attention)."""
    gen = torch.Generator(DEV).manual_seed(MESH_EXPERT_SEED)
    b, s = MESH_EXPERT_BATCH[cfg.name]
    b //= ctx.dp * max(cfg.microbatches, 1)
    v_l = rules.vocab_shard(cfg.vocab_size, ctx.tp)
    rows = {"zstats": zstats_row(
        gen, -(-v_l // cfg.sampler_block), cfg.sampler_block,
        cfg.sampler_proj_rank or cfg.d_model, timed)}
    if cfg.mla:
        h = layers.padded_heads(cfg, ctx.tp)[0] // ctx.tp
        shape = [b, s, h, h, MLA_HD, MLA_HV]
        rows["flash_attention"] = flash_mla_row(gen, b, s, h=h,
                                                timed=timed)
        rows["flash_attention_bwd"] = flash_bwd_case(
            gen, b, s, h, h, MLA_HD, torch.bfloat16, timed=timed,
            hv=MLA_HV)
    else:
        nh, nkv = layers.padded_heads(cfg, ctx.tp)
        h, kv = nh // ctx.tp, nkv // ctx.tp
        hd = cfg.resolved_head_dim
        shape = [b, s, h, kv, hd, hd]
        rows["flash_attention"] = flash_row(gen, b, s, h=h, kv=kv,
                                            timed=timed)
        rows["flash_attention_bwd"] = flash_bwd_case(
            gen, b, s, h, kv, hd, torch.bfloat16, timed=timed)
    for name in ("flash_attention", "flash_attention_bwd"):
        rows[name]["shape"] = shape
    return rows


def mesh_expert_fit(ctx, name: str, n_layers: int, tag: str) -> dict:
    """The bf16 ``fit`` of a run (remat, clip + Adafactor at
    MESH_EXPERT_LR) for MESH_EXPERT_STEPS steps on a pool of one batch of
    the rank's rows: exact launches (zstats once a refresh; each attention
    call's flash_attention once a microbatch and forward run, its backward
    once a microbatch; the mtp block's once each, never rematerialized),
    finite losses falling from the first step to the last, the first MoE
    dispatch's drops equal to the unsharded layer's on the same rows
    (``DropProbe``), the last step's collectives by op and group, the
    steps' ms as ``fit`` logs them and the rank's peak; then zstats at the
    trained head shard's blocks against its plain version."""
    cfg = mesh_expert_cfg(name, n_layers, remat=True)
    steps = MESH_EXPERT_STEPS[(ctx.axis_size("data"), ctx.tp)]
    opt = make_optimizer("adafactor", MESH_EXPERT_LR)
    pool = [mesh_expert_batch(cfg, MESH_EXPERT_BATCH[name], ctx)]
    sync()
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed), DropProbe() as probe, \
            ranks_draw_in_turn():
        res = loop.fit(cfg, ctx, opt, LastStepCollectives(pool, steps),
                       steps, seed=0, log_every=1, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    collectives = distributed.collective_counts(by_group=True)
    want = dict.fromkeys(REPLACES, 0)
    if DEV.type == "cuda":
        mu = max(cfg.microbatches, 1)
        attn, mtp = attn_layers(cfg), int(cfg.mtp)
        want = expected_launches(cfg, steps, tp=ctx.tp)
        want.update(flash_attention=steps * mu * (attn * forwards(cfg)
                                                  + mtp),
                    flash_attention_bwd=steps * mu * (attn + mtp))
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    losses = res.losses
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: the pool loss did not fall: {losses}")
    drops = probe.got
    if drops is not None and (drops["mesh"] != drops["unsharded"]
                              or drops["capacity"]
                              != drops["unsharded_capacity"]):
        raise AssertionError(f"{tag}: the MoE drops {drops}")
    step_ms = [float(x) for x in re.findall(r"\((\d+) ms\)",
                                            printed.getvalue())]
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if DEV.type == "cuda" else 0.0
    with torch.no_grad():
        head = api.head_table(res.state.params, cfg, ctx)
    kern = {"zstats": mesh_zstats_check(ctx, cfg, head, tag)}
    n_params = sum(p.numel() for p in res.state.params.parameters())
    del head, res, pool, probe
    return {"losses": losses, "fit_s": wall, "launches": counts,
            "step_ms": step_ms, "collectives": collectives,
            "peak_gb": peak, "kernels": kern, "drops": drops,
            "params": n_params}


def mesh_expert_rank(ctx, name: str, n_layers: int) -> dict:
    """One run of phase 26 on this rank: the fp32 parity (the parity
    config's runs: at (1, 4) the step's loss and each gradient shard, at
    MESH_EXPERT_MOE_PARITY the MoE layer's, within MESH_RTOL), zstats and
    the attention kernels at the shard's shapes
    (checked, MESH_EXPERT_TIMED's also timed, by the world's rank 0 while
    the others wait), the bf16 fit."""
    dp, tp = ctx.axis_size("data"), ctx.tp
    tag = f"{name} ({dp}, {tp}) rank ({ctx.data_index}, {ctx.model_index})"
    t0 = time.perf_counter()
    secs, parity = {}, None
    if name == MESH_EXPERT_PARITY[0]:
        with ranks_draw_in_turn():
            parity = (mesh_expert_moe_parity(ctx)
                      if (dp, tp) == MESH_EXPERT_MOE_PARITY
                      else mesh_expert_parity(ctx))
        gate(f"{tag} fp32 parity", parity, MESH_RTOL)
        secs["parity"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    kern = None
    torch.distributed.barrier()
    if torch.distributed.get_rank() == 0:
        kern = mesh_expert_kernels(ctx, mesh_expert_cfg(name, n_layers),
                                   (name, (dp, tp)) in MESH_EXPERT_TIMED)
    torch.distributed.barrier()
    secs["kernels"] = time.perf_counter() - t1
    fit = None
    if MESH_EXPERT_STEPS[(dp, tp)]:
        t1 = time.perf_counter()
        fit = mesh_expert_fit(ctx, name, n_layers, tag)
        secs["fit"] = time.perf_counter() - t1
    secs = {k: round(v, 1) for k, v in secs.items()}
    log(f"{tag}: seconds {secs}")
    return {"parity": parity, "kernels": kern, "fit": fit, "secs": secs,
            "s": time.perf_counter() - t0}


def mesh_expert_report(ranks: list[dict], nccl: dict, ref_run: dict
                       ) -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 26's rank results logged and gated: losses alike on every
    rank, each data row's drops over its model ranks equal to the
    unsharded layer's on its rows; each run's launches summed over its
    ranks, and rank 0's kernel rows at each run's shard shapes as
    kernels-line shapes ``mesh_experts_<config>_<dp>x<tp>``."""
    by_path, shapes = {}, {}
    for name, (dp, tp), n_layers in MESH_EXPERT_RUNS:
        key = f"{name} {dp}x{tp}"
        kern = ranks[0][key]["kernels"]
        shapes[f"mesh_experts_{name}_{dp}x{tp}"] = kern
        log(f"[mesh experts] {key}: kernels at the shard shapes {kern}")
        total = dict.fromkeys(REPLACES, 0)
        row_drops: dict[int, list] = {}
        for r, res in enumerate(ranks):
            m, fit = res[key], res[key]["fit"]
            parity = m["parity"]
            worst = max(parity, key=parity.get) if parity else None
            log(f"[mesh experts] gloo {key} rank {r}: "
                + (f"fp32 parity {parity}, worst {worst} {parity[worst]} "
                   f"(of {len(parity)}, over each whole tensor's max); "
                   if parity else "")
                + (f"{len(fit['losses'])} bf16 fit steps ({n_layers} "
                   f"layers, {fit['params']} parameters a rank; clip + "
                   f"adafactor {MESH_EXPERT_LR}, remat) in "
                   f"{fit['fit_s']:.3f} s, losses {fit['losses']}, step ms "
                   f"{fit['step_ms']}, launches "
                   f"{({k: v for k, v in fit['launches'].items() if v})}; "
                   f"peak {fit['peak_gb']:.3f} GB; the first MoE "
                   f"dispatch's drops {fit['drops']}; zstats at the head "
                   f"shard {fit['kernels']}; the last step's collectives "
                   f"{fit['collectives']}; " if fit else "no fit; ")
                + f"the run {m['s']:.1f} s ({m['secs']})")
            if fit is None:
                continue
            add_counts(total, fit["launches"])
            if fit["drops"] is not None:
                row_drops.setdefault(r // tp, []).append(fit["drops"])
        for row, got in row_drops.items():
            mesh_sum = sum(d["mesh"] for d in got)
            if mesh_sum != got[0]["unsharded_all"]:
                raise AssertionError(
                    f"{key}: data row {row}'s drops over its model ranks "
                    f"{mesh_sum} != the unsharded layer's "
                    f"{got[0]['unsharded_all']} on its rows")
        if ranks[0][key]["fit"]:
            gate_losses_alike(key, ranks)
            by_path[f"mesh experts {name} ({dp}, {tp})"] = total
    secs = [round(sum(r[f"{name} {dp}x{tp}"]["s"]
                      for name, (dp, tp), _ in MESH_EXPERT_RUNS), 1)
            for r in ranks]
    log(f"[mesh experts] NCCL (1, 1) {nccl}; the unsharded parity step "
        f"{ref_run}; the ranks' phase 26 {secs} s")
    return by_path, shapes


# --- phase 27: the decoder LMs' serving engine on the mesh -----------------

#: phase 27's rank runs in order: (part, config, mesh, layers, dtype).
#: 27b holds fp32 parity at full width; 27c llama3-8b in bf16 against
#: phase 11's run of the same weights (all 32 layers at (1, 4), the first
#: 8 at (2, 2)); 27d falcon-mamba-7b in bf16 at 8 of its 64 layers
MESH_SERVE_RUNS = (
    ("27b", "llama3-8b", (1, 4), 2, "float32"),
    ("27b", "llama3-8b", (2, 2), 2, "float32"),
    ("27b", "falcon-mamba-7b", (1, 4), 2, "float32"),
    ("27b", "falcon-mamba-7b", (2, 2), 2, "float32"),
    ("27c", "llama3-8b", (1, 4), 32, "bfloat16"),
    ("27c", "llama3-8b", (2, 2), 8, "bfloat16"),
    ("27d", "falcon-mamba-7b", (1, 4), 8, "bfloat16"),
)
#: 27b's batch, prompt, decode steps and cache length: at tp 4 a rank's
#: range of the 72 positions is 18, so the decode steps (positions 52-54)
#: cross from rank 2's range into rank 3's
MESH_SERVE_PARITY = (4, 52, 3, 72)
#: 27c's and 27d's: phase 11's 4 prompts of 512, 16 decode steps, a cache
#: of 528 positions (132 a rank at tp 4, 264 at tp 2)
MESH_SERVE_BF16 = (LLAMA_BATCH, LLAMA_PROMPT, 16, LLAMA_PROMPT + 16)
#: each part's decode steps
MESH_SERVE_STEPS = {"27b": MESH_SERVE_PARITY[2], "27c": MESH_SERVE_BF16[2],
                    "27d": MESH_SERVE_BF16[2]}
#: 27a's (NCCL (1, 1)) llama3-8b depth, batch, prompt and decode steps
MESH_SERVE_NCCL = (2, 2, 128, 4)
MESH_SERVE_TOPK = 10
#: phase 11's llama3-8b weights (its generator's seed), drawn again straight
#: into each rank's shards
MESH_SERVE_LLAMA_SEED = 15
#: 27a's, 27b's and 27d's weights and prompts
MESH_SERVE_SEED = 27
#: the sharded int8 quantized index's recall@10 at exhaustive beam against
#: the unsharded int8 index's on the same queries
MESH_SERVE_RECALL_TOL = 0.01
MESH_SERVE_DIR = MESH_DIR.parent / "chip_smoke_mesh_serving"


def serve_cfg(name: str, n_layers: int, dtype: str):
    """A phase 27 config: ``name`` at full width and ``n_layers``, its
    weights and compute in ``dtype``."""
    return dataclasses.replace(get_config(name), n_layers=n_layers,
                               dtype=dtype, param_dtype=dtype)


def serve_prompts(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s))).to(DEV)


def _host(x):
    """A copy on the host of every tensor of ``x`` (a copy on a CPU run
    too: decode writes the caches in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x


def mesh_serve_llama_reference(cfg, params, prompts: torch.Tensor) -> float:
    """27c's references from phase 11's llama3-8b weights, saved for the
    ranks: the unsharded run (``serve_reference``) at each of 27c's
    depths (``mesh_serve_llama_key``: 32 layers and the first 8, the same
    tree's views), and the unsharded int8 quantized
    index's recall@10 at exhaustive beam on the 32-layer run's decode h.
    Returns its seconds."""
    t0 = time.perf_counter()
    b, s, n_dec, max_len = MESH_SERVE_BF16
    prompts = prompts[:b, :s]
    refs = {}
    for depth in mesh_serve_llama_key()[0]:
        view = dict(params, segments=[_map_tree(lambda t: t[:depth], seg)
                                      for seg in params["segments"]])
        refs[depth] = serve_reference(
            dataclasses.replace(cfg, n_layers=depth), view, prompts, n_dec,
            max_len)
    head = api.head_table(params, cfg)
    queries = torch.cat(refs[cfg.n_layers]["h"]).to(DEV)
    idx = quantized_index.build_quantized_index(
        head, vocab_size=cfg.vocab_size, **serve_qknobs(cfg))
    recall = quantized_index.recall_at_k(idx, head, queries,
                                         MESH_SERVE_TOPK, None)
    del idx
    MESH_SERVE_DIR.mkdir(parents=True, exist_ok=True)
    torch.save({"refs": refs, "queries": queries.cpu(), "recall": recall,
                "key": mesh_serve_llama_key()},
               MESH_SERVE_DIR / "llama3-8b.pt")
    secs = time.perf_counter() - t0
    log(f"[mesh serving] 27c's references from phase 11's llama3-8b "
        f"weights (depths {sorted(refs)}, 4 prompts of {s}, {n_dec} "
        f"steps) and the unsharded int8 index's recall@"
        f"{MESH_SERVE_TOPK} at exhaustive beam on {queries.shape[0]} "
        f"queries {recall}: {secs:.1f} s")
    return secs


def mesh_serve_llama_key() -> tuple:
    """What 27c's saved llama3-8b references are drawn for: their depths
    (27c's runs'), MESH_SERVE_BF16 and the weights' seed.  A file saved
    for another key is drawn again."""
    return (tuple(sorted({n for part, _, _, n, _ in MESH_SERVE_RUNS
                          if part == "27c"})), MESH_SERVE_BF16,
            MESH_SERVE_LLAMA_SEED)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def serve_qknobs(cfg) -> dict:
    """The int8 quantized index's knobs, as ``export_quantized_index``
    takes them from the config."""
    return dict(codewords=cfg.midx_codewords, codebooks=cfg.midx_codebooks,
                list_size=cfg.sampler_block, bits=8)


def mesh_serve_references() -> dict:
    """27b's and 27d's unsharded references, saved for the ranks: each
    config of those runs drawn whole from MESH_SERVE_SEED on the card,
    its ``serve_reference`` run (27b's with the caches), then freed; and
    27c's (``mesh_serve_llama_reference``) where phase 11 left none, or
    left one for another ``mesh_serve_llama_key``.
    Returns each reference's seconds."""
    MESH_SERVE_DIR.mkdir(parents=True, exist_ok=True)
    secs = {}
    for part, name, n_layers, dtype in dict.fromkeys(
            (p, n, l, d) for p, n, _, l, d in MESH_SERVE_RUNS
            if p != "27c"):
        t0 = time.perf_counter()
        cfg = serve_cfg(name, n_layers, dtype)
        params = api.init_params(cfg, torch.Generator(DEV).manual_seed(
            MESH_SERVE_SEED), device=DEV)
        b, s, n_dec, max_len = (MESH_SERVE_PARITY if part == "27b"
                                else MESH_SERVE_BF16)
        ref = serve_reference(cfg, params, serve_prompts(
            cfg, b, s, MESH_SERVE_SEED), n_dec, max_len,
            caches=part == "27b")
        torch.save(ref, MESH_SERVE_DIR / f"{part}_{name}.pt")
        del params, ref
        sync()
        if DEV.type == "cuda":
            torch.cuda.empty_cache()
        secs[f"{part} {name}"] = round(time.perf_counter() - t0, 1)
    saved = MESH_SERVE_DIR / "llama3-8b.pt"
    if not saved.exists() or \
            torch.load(saved)["key"] != mesh_serve_llama_key():
        cfg = serve_cfg("llama3-8b", mesh_serve_llama_key()[0][-1],
                        "bfloat16")
        params = api.init_params(cfg, torch.Generator(DEV).manual_seed(
            MESH_SERVE_LLAMA_SEED), device=DEV)
        secs["27c llama3-8b"] = round(mesh_serve_llama_reference(
            cfg, params, serve_prompts(cfg, *MESH_SERVE_BF16[:2],
                                       MESH_SERVE_LLAMA_SEED)), 1)
        del params
        sync()
        if DEV.type == "cuda":
            torch.cuda.empty_cache()
    log(f"[mesh serving] unsharded references saved for the ranks, "
        f"seconds {secs}")
    return secs


@torch.no_grad()
def mesh_serve_nccl() -> dict:
    """Phase 27a: NCCL on a (1, 1) mesh in this process, llama3-8b at full
    width and MESH_SERVE_NCCL's depth in bf16 under ``ctx_for_serve``:
    prefill h and token, each decode step's h and token (on its own
    tokens) and a top-k step's ids and logits bitwise the unsharded
    engine's on the same weights (the model drawn into its (1, 1)
    shards, which are whole)."""
    backend = "nccl" if DEV.type == "cuda" else "gloo"
    launch_mesh.init_distributed(
        backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1)
    try:
        depth, b, s, n_dec = MESH_SERVE_NCCL
        cfg = serve_cfg("llama3-8b", depth, "bfloat16")
        sctx = rules.ctx_for_serve(launch_mesh.make_debug_mesh(1, 1), cfg)
        prompts = serve_prompts(cfg, b, s, MESH_SERVE_SEED)
        got = {}
        for tag, ctx in (("mesh", sctx), ("unsharded", None)):
            gen = torch.Generator(DEV).manual_seed(MESH_SERVE_SEED)
            params = (api.init_module(cfg, gen, DEV, ctx=ctx) if ctx
                      else api.init_params(cfg, gen, device=DEV))
            got[tag] = serve_steps(cfg, ctx, params, prompts, n_dec,
                                   s + n_dec)
            del params
            sync()
        diff = [k for k in got["mesh"]
                if not torch.equal(got["mesh"][k], got["unsharded"][k])]
        log(f"[mesh serving] {backend} (1, 1) llama3-8b at {depth} layers "
            f"(bf16, {b} prompts of {s}, {n_dec} steps, top-"
            f"{MESH_SERVE_TOPK}): {len(got['mesh']) - len(diff)} of "
            f"{len(got['mesh'])} tensors bitwise the unsharded engine's")
        if diff:
            raise AssertionError(f"27a: {diff} differ from the unsharded "
                                 "engine's")
        return {"bitwise": len(got["mesh"])}
    finally:
        torch.distributed.destroy_process_group()
        if DEV.type == "cuda":
            torch.cuda.empty_cache()


def predict_serve_collectives(cfg, ctx, b_l: int, seq_split: bool,
                              model=None, cross_split: bool = False,
                              batch: int | None = None
                              ) -> dict[str, dict[str, int]]:
    """One decode step's collectives on a rank (``make_decode_step``;
    "<op> <group>": calls, bytes of each call's result), from the layer
    structure: the embedding's vocab-parallel psum; per attention layer
    one all-gather of the step's q / k / v heads, where the cache's
    sequence is split the softmax merge's pmax and psum (fp32), and the
    ``wo`` psum; per MLA layer, where its latent cache's sequence is
    split, one all-gather of the heads' absorbed queries ``[q_lat |
    q_rope]`` (fp32) and the merge over the latent width, then the ``wo``
    psum; per mamba layer the ``x_proj`` and ``out_proj`` psums; per MLP
    or MoE its psum (a MoE's shared experts inside it), and in tp mode at
    dp > 1 the MoE's all-gather of its tokens over ``data``
    (``moe.moe_rows``, ``batch`` the whole batch); per encoder-decoder
    layer the self attention's, the cross attention's merge alone where
    its frames are split (``cross_split``: whole weights, no gather, no
    psum) and the MLP's; in tp_fsdp at dp > 1 one all-gather over
    ``data`` of each F-sharded leaf the step computes with (``model``'s
    specs: the embedding, every layer's, the head's feature dim); the
    greedy token's two all-gathers of (B, tp) candidates (fp32 logits,
    int32 ids)."""
    esize = torch.finfo(layers._dtype(cfg)).bits // 8
    tp, d, hd = ctx.tp, cfg.d_model, cfg.resolved_head_dim
    nh, nkv = layers.padded_heads(cfg, tp)
    want: dict[str, dict[str, int]] = {}

    def add(op: str, n_bytes: int, group: str = "model") -> None:
        got = want.setdefault(f"{op} {group}", {"calls": 0, "bytes": 0})
        got["calls"] += 1
        got["bytes"] += n_bytes

    def merge(heads: int, width: int) -> None:
        add("all_reduce_max", b_l * heads * 4)
        add("all_reduce_sum", b_l * heads * (width + 1) * 4)

    if model is not None and ctx.axis_size(ctx.data_axes) > 1:
        for name, p in model.named_parameters():
            if "data" in rules.spec_axes(model.param_specs[name]) and \
                    not name.startswith("mtp."):
                add("all_gather", p.numel() * ctx.dp * p.element_size(),
                    "data")
    add("all_reduce_sum", b_l * d * esize)
    kinds = (["self+mlp"] * cfg.n_dec_layers if cfg.family == "encdec"
             else cfg.layer_kinds())
    for kind in kinds:
        mixer, ffn = kind.split("+")
        if mixer == "attn" and cfg.mla:
            if seq_split:
                nh_m = -(-cfg.n_heads // tp) * tp
                add("all_gather",
                    b_l * nh_m * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4)
                merge(nh_m, cfg.kv_lora_rank)
        elif mixer in ("attn", "self"):
            add("all_gather", b_l * (nh + 2 * nkv) * hd * esize)
            if seq_split:
                merge(nh, hd)
        else:
            add("all_reduce_sum",
                b_l * (cfg.dt_rank + 2 * cfg.ssm_state) * esize)
        add("all_reduce_sum", b_l * d * esize)
        if mixer == "self" and cross_split:
            merge(nh, hd)
        if ffn == "moe" and moe.moe_rows(ctx, b_l, batch):
            add("all_gather", ctx.dp * b_l * d * esize, "data")
        if ffn in ("mlp", "moe"):
            add("all_reduce_sum", b_l * d * esize)
    for _ in range(2):
        add("all_gather", b_l * tp * 4)
    return want


def _logit_err(h, ref_h, ids, head_l, sctx) -> torch.Tensor:
    """Per row, max_j |<h - ref_h, w_j>| over the row's ids j: the logit
    error this rank's h carries against the unsharded h (on a mesh each
    rank dots the rows of its head shard, merged by a pmax over model)."""
    v_l = head_l.shape[0]
    off = sctx.model_index * v_l if rules.on_mesh(sctx) else 0
    own = (ids >= off) & (ids < off + v_l)
    rows = head_l[(ids - off).clamp(0, v_l - 1).long()].float()
    d = torch.einsum("tkd,td->tk", rows, h.float() - ref_h.float())
    d = torch.where(own, d.abs(), 0.0).amax(dim=-1)
    return distributed.pmax(d, sctx.model_group) \
        if rules.on_mesh(sctx) else d


def check_topk_near(tag: str, ids, dids, dlog, k: int, err) -> int:
    """``check_topk_ties`` with a row's own tolerance: ids equal the
    unsharded top-k rank by rank, except where the unsharded logit at
    that rank is within 2 ``err[t]`` (row t's logit error, bf16's) of a
    neighbour's.  Returns the swaps."""
    ids_c, dids_c = ids.cpu(), dids.cpu()
    dlog_c, err_c = dlog.cpu().tolist(), err.cpu().tolist()
    swaps = 0
    for t in range(ids_c.shape[0]):
        near = lambda a, b: abs(a - b) <= 2 * err_c[t]  # noqa: E731
        for j in range(k):
            if ids_c[t, j] == dids_c[t, j]:
                continue
            lt = dlog_c[t]
            if not (near(lt[j], lt[j - 1]) if j else False) and \
                    not near(lt[j], lt[j + 1]):
                raise AssertionError(
                    f"{tag}: id {int(ids_c[t, j])} != unsharded "
                    f"{int(dids_c[t, j])} at row {t} rank {j}, beyond the "
                    f"logit error {err_c[t]}")
            swaps += 1
    return swaps


def _tokens_gate(tag: str, got, top, h, ref_h, head, sctx, fp32: bool
                 ) -> tuple[int, float]:
    """A step's greedy tokens (B,) against the unsharded ones (``top``:
    the unsharded top-(k + 1) of the same step): fp32 through
    ``check_topk_ties`` (equal but at a tie within 1e-5), bf16 through
    ``check_topk_near`` at the row's logit error of h against the
    unsharded h (``_logit_err``), which must itself stay within
    DECODE_RTOL of the row's top logit.  Returns (swaps, the worst logit
    error over the row's top logit)."""
    ids, logits = (t.to(DEV) for t in top)
    err = _logit_err(h, ref_h, ids, head, sctx)
    worst = float((err / logits[:, 0].abs()).max())
    if fp32:
        return check_topk_ties(tag, got[:, None], ids, logits, 1), worst
    if worst > DECODE_RTOL:
        raise AssertionError(f"{tag}: logit error {worst} of the top "
                             f"logit > {DECODE_RTOL}")
    return check_topk_near(tag, got[:, None], ids, logits, 1, err), worst


@contextlib.contextmanager
def keeping_hidden(seen: dict, caches: bool = False):
    """While on, ``transformer.prefill`` keeps its h in ``seen["prefill"]``
    (and with ``caches`` a host copy of its caches in ``seen["prefill
    caches"]``), and a decode step built meanwhile by
    ``engine.make_decode_step`` (which binds ``transformer.decode_step``)
    appends each call's h (B, d) to ``seen["decode"]``: the engine's own
    steps' h, read with no second run and no launch of a hand kernel."""
    real_prefill, real_decode = transformer.prefill, transformer.decode_step

    def prefill(*args, **kwargs):
        h, got = real_prefill(*args, **kwargs)
        seen["prefill"] = h
        if caches:
            seen["prefill caches"] = _host(got)
        return h, got

    def decode_step(*args, **kwargs):
        h, got = real_decode(*args, **kwargs)
        seen["decode"].append(h[:, 0])
        return h, got

    transformer.prefill, transformer.decode_step = prefill, decode_step
    try:
        yield seen
    finally:
        transformer.prefill, transformer.decode_step = real_prefill, \
            real_decode


def mesh_serve_run(ctx, part: str, name: str, n_layers: int, dtype: str,
                   tag: str) -> tuple[dict, object, torch.Tensor]:
    """One phase 27 run on this rank: the config drawn straight into the
    rank's shards under ``ctx_for_serve`` (27c: phase 11's weights), and
    the counted main path through the engine: (27c) the sharded
    ``RetrievalIndex`` of the rank's head shard, the prefill of its rows
    of the reference's prompts, the decode steps fed the unsharded
    engine's tokens (the last one's collectives against
    ``predict_serve_collectives``), a dense top-k step and (27c) a
    full-beam index top-k step: exact launches (zstats once,
    flash_attention once a layer, leaf_scores once; 27b's fp32 attention
    through flash_attention_simt).  Then, outside the count: prefill's h
    and each decode step's h, as the engine's steps computed them
    (``keeping_hidden``), against the reference's (27b within MESH_RTOL of
    each tensor's max; bf16 within phase 11's DECODE_RTOL and
    ``decode_rel_rms``), the tokens (``_tokens_gate``), 27b's caches
    gathered whole after the prefill and after the last step, the dense
    top-k against the unsharded one, the full beam against the dense
    top-k, and (27c) the sharded int8 quantized index's recall@k at
    exhaustive beam.  Returns (the numbers, the index, the last step's
    h)."""
    cfg = serve_cfg(name, n_layers, dtype)
    sctx = rules.ctx_for_serve(ctx.mesh, cfg)
    fp32, k = dtype == "float32", MESH_SERVE_TOPK
    saved = None
    if part == "27c":
        saved = torch.load(MESH_SERVE_DIR / f"{name}.pt")
        ref, seed = saved["refs"][n_layers], MESH_SERVE_LLAMA_SEED
    else:
        ref = torch.load(MESH_SERVE_DIR / f"{part}_{name}.pt")
        seed = MESH_SERVE_SEED
    b, s, n_dec, max_len = (MESH_SERVE_PARITY if part == "27b"
                            else MESH_SERVE_BF16)
    sync()
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init_module(cfg, torch.Generator(DEV).manual_seed(seed),
                            DEV, ctx=sctx)
    sync()
    secs = {"draw": time.perf_counter() - t0}
    rows = rules.serve_rows(torch.arange(b), sctx)
    prompts = ref["prompts"][rows].to(DEV)
    fed = [f[rows].to(DEV) for f in ref["fed"]]
    b_l = prompts.shape[0]
    seen: dict = {"decode": []}
    prefill = engine.make_prefill_step(cfg, sctx, max_len)
    with keeping_hidden(seen, caches=fp32):
        decode = engine.make_decode_step(cfg, sctx, max_len)

    # -- the counted main path ---------------------------------------------
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    head = api.head_table(model, cfg, sctx)
    index = None
    if part == "27c":
        index = retrieval.build_index(head, sctx, vocab_size=cfg.vocab_size)
        sync()
        secs["index"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with keeping_hidden(seen, caches=fp32):
        tok0, caches = prefill(model, {"tokens": prompts})
    sync()
    secs["prefill"] = time.perf_counter() - t0
    toks, before, collectives = [], caches, {}
    t0 = time.perf_counter()
    for i in range(n_dec):
        pos = torch.full((b_l,), s + i, dtype=torch.long, device=DEV)
        if i == n_dec - 1:
            sync()
            distributed.reset_collective_counts()
            before = caches  # a mamba step returns new states
        nxt, caches = decode(model, fed[i][:, None].long(), caches, pos)
        if i == n_dec - 1:
            sync()
            collectives = distributed.collective_counts(by_group=True)
        toks.append(nxt)
    sync()
    secs["decode"] = time.perf_counter() - t0
    last = fed[n_dec - 1][:, None].long()
    dids, dlog, _ = engine.make_topk_step(cfg, sctx, k + 1,
                                          max_len=max_len)(
        model, last, before, pos)
    ids = logits = None
    if index is not None:
        ids, logits, _ = engine.make_topk_step(cfg, sctx, k, index=index,
                                               max_len=max_len)(
            model, last, before, pos)
    sync()
    counts = kernels.launch_counts()
    want = dict.fromkeys(REPLACES, 0)
    if DEV.type == "cuda":
        want["flash_attention_simt" if fp32 else "flash_attention"] = \
            attn_layers(cfg)
        if index is not None:
            want.update(zstats=1, leaf_scores=1)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    seq_split = "k" in caches[0] and rules.seq_shards(sctx, max_len) > 1
    predicted = predict_serve_collectives(cfg, sctx, b_l, seq_split)
    if collectives != predicted:
        raise AssertionError(f"{tag}: a decode step's collectives "
                             f"{collectives} != the prediction "
                             f"{predicted}")

    # -- checks outside the count --------------------------------------------
    errs, rms, swaps, logit_err = {}, {}, 0, 0.0
    h_pre = seen["prefill"]
    if fp32:
        errs["prefill h"] = rel_err(h_pre, ref["prefill_h"][rows].to(DEV))
        errs.update(_serve_cache_errs(seen["prefill caches"],
                                      ref["prefill_caches"], cfg, sctx, b,
                                      max_len, None, "prefill"))
    ref_h = ref["prefill_h_last"][rows].to(DEV)
    errs["prefill h last"] = rel_err(h_pre[:, -1], ref_h)
    rms["prefill"] = float(_rel_rms(h_pre[:, -1].float(), ref_h))
    got_swaps, got_err = _tokens_gate(
        f"{tag} prefill token", tok0, [t[rows] for t in ref["prefill_top"]],
        h_pre[:, -1], ref_h, head, sctx, fp32)
    swaps, logit_err = swaps + got_swaps, max(logit_err, got_err)
    del h_pre
    # the decode steps' h as the engine's steps computed them
    for i, h in enumerate(seen["decode"]):
        ref_h = ref["h"][i][rows].to(DEV)
        errs[f"decode {i} h"] = rel_err(h, ref_h)
        rms[f"decode {i}"] = float(_rel_rms(h.float(), ref_h))
        got_swaps, got_err = _tokens_gate(
            f"{tag} decode {i} token", toks[i],
            [t[rows] for t in ref["top"][i]], h, ref_h, head, sctx, fp32)
        swaps, logit_err = swaps + got_swaps, max(logit_err, got_err)
    if fp32:
        errs.update(_serve_cache_errs(caches, ref["decode_caches"], cfg,
                                      sctx, b, max_len, None, "decode"))
        gate(f"{tag} fp32 parity", errs, MESH_RTOL)
    else:
        gate(f"{tag} h", errs, DECODE_RTOL)
        gate(f"{tag} h relative RMS", rms, decode_rel_rms(cfg))
    rid, rlog = (t[rows].to(DEV) for t in ref["top"][n_dec - 1])
    if fp32:
        topk_swaps = check_topk_ties(f"{tag} dense top-{k}", dids[:, :k],
                                     rid, rlog, k)
    else:
        topk_swaps = check_topk_near(
            f"{tag} dense top-{k}", dids[:, :k], rid, rlog, k,
            _logit_err(h, ref_h, rid, head, sctx))
    out = {"secs": secs, "launches": counts, "collectives": collectives,
           "b_l": b_l, "seq_split": seq_split, "errs": errs, "rel_rms": rms,
           "token_swaps": swaps, "logit_err": logit_err,
           "topk_swaps": topk_swaps,
           "params": sum(p.numel() for p in model.parameters())}
    if index is not None:
        if not torch.allclose(logits, dlog[:, :k], rtol=1e-5, atol=0.0):
            raise AssertionError(f"{tag}: the full-beam logits differ from "
                                 "the dense top-k's")
        out["index_swaps"] = check_topk_ties(f"{tag} full beam", ids, dids,
                                             dlog, k)
        t0 = time.perf_counter()
        qidx = quantized_index.build_quantized_index(
            head, sctx, vocab_size=cfg.vocab_size, **serve_qknobs(cfg))
        sync()
        secs["quantized_index"] = time.perf_counter() - t0
        q = rules.serve_rows(saved["queries"].to(DEV), sctx)
        out.update(recall=quantized_index.recall_at_k(qidx, head, q, k,
                                                      None, sctx),
                   recall_unsharded=saved["recall"],
                   lists=qidx.num_lists_shard, queries=q.shape[0])
        del qidx
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if DEV.type == "cuda" else 0.0)
    out["secs"] = {key: round(v, 3) for key, v in secs.items()}
    return out, index, h


def mesh_serve_kernels(ctx, cfg, part: str, index, h: torch.Tensor
                       ) -> dict:
    """The attention kernel of the run's prefill at this rank's shard
    shape (its rows of the part's prompts, n_heads / tp q over n_kv / tp
    kv heads of 128): 27b's fp32 flash_attention_simt at S 52, 27c's bf16
    flash_attention at S 512; and, with the rank's index, zstats at its
    blocks and leaf_scores at its full beam (``index_kernel_rows``); each
    against its plain version and timed (SDPA beside the attention)."""
    gen = torch.Generator(DEV).manual_seed(MESH_SERVE_SEED)
    fp32 = cfg.dtype == "float32"
    b, s = (MESH_SERVE_PARITY if part == "27b" else MESH_SERVE_BF16)[:2]
    b = b // ctx.dp if b % ctx.dp == 0 else b
    nh, nkv = layers.padded_heads(cfg, ctx.tp)
    hq, kv = nh // ctx.tp, nkv // ctx.tp
    kernel = flash_attention_simt if fp32 else flash_attention
    rows = {kernel.__name__: flash_row(
        gen, b, s, kernel, h=hq, kv=kv,
        dtype=torch.float32 if fp32 else torch.bfloat16)}
    rows[kernel.__name__]["shape"] = [b, s, hq, kv, 128]
    if index is not None:
        tag = f"llama3-8b shard ({ctx.axis_size('data')}, {ctx.tp})"
        got = index_kernel_rows(index, h, tag)
        got["zstats"]["shape"] = list(index.wq.shape)
        got["leaf_scores"]["shape"] = [h.shape[0] * index.wq.shape[0],
                                       *index.wq.shape[1:]]
        rows.update(got)
    return rows


def mesh_serve_rank(ctx, part: str, name: str, n_layers: int,
                    dtype: str) -> dict:
    """One phase 27 run on this rank (``mesh_serve_run``), then, on the
    world's rank 0 while the others wait, the kernels at the run's shard
    shapes (``mesh_serve_kernels``) for each run with attention."""
    dp, tp = ctx.axis_size("data"), ctx.tp
    tag = f"{part} {name} ({dp}, {tp}) {dtype} rank ({ctx.data_index}, " \
          f"{ctx.model_index})"
    t0 = time.perf_counter()
    out, index, h = mesh_serve_run(ctx, part, name, n_layers, dtype, tag)
    t1 = time.perf_counter()
    torch.distributed.barrier()
    cfg = serve_cfg(name, n_layers, dtype)
    if torch.distributed.get_rank() == 0 and attn_layers(cfg):
        out["kernels"] = mesh_serve_kernels(ctx, cfg, part, index, h)
    torch.distributed.barrier()
    del index, h
    out["secs"]["kernels"] = round(time.perf_counter() - t1, 1)
    out["s"] = time.perf_counter() - t0
    log(f"{tag}: seconds {out['secs']}")
    return out


def mesh_serve_report(ranks: list[dict], nccl: dict, ref_s: dict
                      ) -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 27's rank results logged and gated: the quantized index's
    recall, averaged over the data rows, within MESH_SERVE_RECALL_TOL of
    the unsharded one's; each run's launches summed over its ranks, and
    rank 0's kernel rows as kernels-line shapes
    ``mesh_serving_<dp>x<tp>`` (27c) and ``mesh_serving_fp32_<dp>x<tp>``
    (27b)."""
    by_path, shapes = {}, {}
    for part, name, (dp, tp), n_layers, dtype in MESH_SERVE_RUNS:
        key = f"{part} {name} {dp}x{tp}"
        total = dict.fromkeys(REPLACES, 0)
        for r, res in enumerate(ranks):
            m = res[key]
            worst = max(m["errs"], key=m["errs"].get)
            log(f"[mesh serving] gloo {key} {dtype} rank {r} ({n_layers} "
                f"layers, {m['params']} parameters a rank, {m['b_l']} rows, "
                f"the cache's sequence "
                f"{'split' if m['seq_split'] else 'whole'}): worst h / cache "
                f"error {worst} {m['errs'][worst]} over its max, relative "
                f"RMS {max(m['rel_rms'].values())}, token swaps "
                f"{m['token_swaps']} (logit error {m['logit_err']} of the "
                f"top logit), top-{MESH_SERVE_TOPK} swaps {m['topk_swaps']}"
                + (f", full beam = dense but {m['index_swaps']} ties, int8 "
                   f"recall@{MESH_SERVE_TOPK} {m['recall']} ({m['lists']} "
                   f"lists a shard, {m['queries']} queries; unsharded "
                   f"{m['recall_unsharded']})" if "recall" in m else "")
                + f"; launches "
                f"{({k: v for k, v in m['launches'].items() if v})}, a "
                f"decode step's collectives {m['collectives']} (= the "
                f"prediction), seconds {m['secs']}, prefill "
                f"{m['secs']['prefill'] * 1e3:.1f} ms, decode "
                f"{m['secs']['decode'] / MESH_SERVE_STEPS[part] * 1e3:.1f} "
                f"ms a token, peak {m['peak_gb']:.3f} GB")
            add_counts(total, m["launches"])
        if "recall" in ranks[0][key]:
            recall = statistics.mean(res[key]["recall"] for res in ranks)
            want = ranks[0][key]["recall_unsharded"]
            if abs(recall - want) > MESH_SERVE_RECALL_TOL:
                raise AssertionError(
                    f"{key}: the sharded int8 index's recall {recall} is "
                    f"more than {MESH_SERVE_RECALL_TOL} from the unsharded "
                    f"one's {want}")
        kern = ranks[0][key].get("kernels")
        if kern:
            fp32 = "fp32_" if dtype == "float32" else ""
            shapes[f"mesh_serving_{fp32}{dp}x{tp}"] = kern
            log(f"[mesh serving] {key}: kernels at the shard shapes {kern}")
        by_path[f"mesh serving {name} ({dp}, {tp}) {dtype}"] = total
    secs = [round(sum(r[f"{p} {n} {dp}x{tp}"]["s"]
                      for p, n, (dp, tp), _, _ in MESH_SERVE_RUNS), 1)
            for r in ranks]
    log(f"[mesh serving] NCCL (1, 1) {nccl}; the unsharded references "
        f"{ref_s} s; the ranks' phase 27 {secs} s")
    return by_path, shapes


# --- phase 28: the rest of serving on the mesh ------------------------------

#: phase 28's rank runs in order: (part, config, mesh, layers, dtype);
#: whisper-large-v3's layers are its encoder's and its decoder's each.
#: 28b holds fp32 parity at full width (dbrx-132b at (1, 4) only: its (2,
#: 2) serving gathers its experts over data, ~3.2 GB a rank a forward
#: through gloo, and is held by tests/test_torch_mesh_family_serving.py);
#: 28c serves in bf16 at (1, 4) against unsharded runs of the same weights,
#: jamba at its first 5 layers (attention, 2 MoE, 4 mamba) and whisper at
#: 2 + 2, cut from 8 and 4 + 4 to fit the script's 1,200 s (PERF.md
#: section 4 gives each cut's measured saving)
MESH_FAMILY_SERVE_RUNS = (
    ("28b", "jamba-v0.1-52b", (1, 4), 2, "float32"),
    ("28b", "jamba-v0.1-52b", (2, 2), 2, "float32"),
    ("28b", "deepseek-v3-671b", (1, 4), 1, "float32"),
    ("28b", "deepseek-v3-671b", (2, 2), 1, "float32"),
    ("28b", "whisper-large-v3", (1, 4), 2, "float32"),
    ("28b", "whisper-large-v3", (2, 2), 2, "float32"),
    ("28b", "dbrx-132b", (1, 4), 1, "float32"),
    ("28c", "jamba-v0.1-52b", (1, 4), 5, "bfloat16"),
    ("28c", "dbrx-132b", (1, 4), 2, "bfloat16"),
    ("28c", "deepseek-v3-671b", (1, 4), 3, "bfloat16"),
    ("28c", "whisper-large-v3", (1, 4), 2, "bfloat16"),
)
#: 28b's batch, prompt, decode steps and cache length (phase 27b's; a
#: whisper clip is WHISPER_FRAMES frames, its prompt token 0)
FAMILY_SERVE_PARITY = MESH_SERVE_PARITY
#: 28c's: 4 prompts of 512 (4 clips of 1,500 frames), 8 decode steps, a
#: cache of 520 positions (130 a rank at tp 4)
FAMILY_SERVE_BF16 = (4, 512, 8, 520)
FAMILY_SERVE_STEPS = {"28b": FAMILY_SERVE_PARITY[2],
                      "28c": FAMILY_SERVE_BF16[2]}
#: 28a's (NCCL (1, 1)) configs and depths (jamba's first 5 layers reach
#: its attention), its batch, prompt and decode steps
FAMILY_SERVE_NCCL = ({"jamba-v0.1-52b": 5, "deepseek-v3-671b": 1,
                      "whisper-large-v3": 2}, 2, 128, 4)
MESH_FAMILY_SERVE_SEED = 28
MESH_FAMILY_SERVE_DIR = MESH_DIR.parent / "chip_smoke_mesh_family_serving"
#: the configs whose layers are drawn one rank at a time (a MoE layer is
#: 11-13 GB whole in fp32; ``ranks_draw_in_turn``)
FAMILY_DRAW_IN_TURN = ("jamba-v0.1-52b", "dbrx-132b")


class FamilyRoutes:
    """An unsharded run's MoE routing (``moe._route``'s ids and weights,
    call by call: the prefill's layers, then each decode step's),
    recorded, and imposed on a rank's run of the same tokens (28c's bf16
    MoE configs).  Where two experts' scores nearly tie, bf16 rounding
    differences between the sharded and the unsharded products flip a
    top-k choice and move that token's output by O(|y|), as ``Routes``
    says of decode against forward; with the unsharded routing imposed the
    runs differ by rounding alone.  ``flips`` counts the (token, layer)
    pairs whose own top-k differed; ``at`` is the next call imposed (the
    top-k steps replay the last decode step's calls)."""

    def __init__(self, calls=None):
        self.calls = [] if calls is None else calls
        self.flips = self.routed = self.at = 0

    @contextlib.contextmanager
    def recording(self):
        real = moe._route

        def spy(p, x2d, cfg):
            ids, w, aux = real(p, x2d, cfg)
            self.calls.append((ids.cpu(), w.cpu()))
            return ids, w, aux

        moe._route = spy
        try:
            yield self
        finally:
            moe._route = real

    @contextlib.contextmanager
    def imposing(self):
        real = moe._route

        def spy(p, x2d, cfg):
            ids, w, aux = real(p, x2d, cfg)
            f_ids, f_w = self.calls[self.at]
            self.at += 1
            f_ids = f_ids.to(ids.device)
            self.flips += int((ids != f_ids).any(dim=-1).sum())
            self.routed += ids.shape[0]
            return f_ids, f_w.to(device=w.device, dtype=w.dtype), aux

        moe._route = spy
        try:
            yield self
        finally:
            moe._route = real


def family_serve_cfg(name: str, n_layers: int, dtype: str,
                     capacity_div: int = 1):
    """A phase 28 config: ``name`` at full width and ``n_layers`` (each
    stack's for whisper), weights and compute in ``dtype``; deepseek's
    mtp trunk, which serving never runs, left out.  ``capacity_div``
    divides the capacity factor (``family_ref_variant``)."""
    cfg = get_config(name)
    depth = (dict(n_enc_layers=n_layers, n_dec_layers=n_layers,
                  n_layers=2 * n_layers) if cfg.family == "encdec"
             else dict(n_layers=n_layers, mtp=False))
    return dataclasses.replace(
        cfg, dtype=dtype, param_dtype=dtype,
        capacity_factor=cfg.capacity_factor / capacity_div, **depth)


def family_ref_variant(name: str, mesh) -> tuple[int, int]:
    """(tp, capacity divisor) of the unsharded reference a run on ``mesh``
    is held against: whisper's weights are drawn padded for the mesh's tp
    (its vocab of 51,866 to 51,868 at tp 4), as its ranks draw them; a
    MoE config in tp mode (jamba) at dp > 1 routes every data block's
    tokens with one block's capacity (the reference's tp-mode layer,
    ``moe.moe_rows``), which is the unsharded layer at the capacity
    factor over dp."""
    dp, tp = mesh
    cfg = get_config(name)
    pad = tp if cfg.family == "encdec" else 1
    div = dp if cfg.n_experts and not cfg.serve_fsdp else 1
    return pad, div


def family_ref_path(part: str, name: str, mesh) -> Path:
    pad, div = family_ref_variant(name, mesh)
    return MESH_FAMILY_SERVE_DIR / f"{part}_{name}_pad{pad}_cap{div}.pt"


def family_params(cfg, seed: int, ctx=None, tp: int = 1):
    """``cfg``'s weights from ``seed`` on the card: whole (an LM's tree;
    whisper's padded for ``tp``), or with a mesh ``ctx`` this rank's
    shards of the same draws (an LM drawn straight into them,
    ``api.init_module``; whisper drawn whole, then cut:
    ``step.shard_params``)."""
    gen = torch.Generator(DEV).manual_seed(seed)
    if cfg.family == "encdec":
        tree = encdec.init_encdec(gen, cfg, DEV, tp=tp, ctx=ctx)
        if ctx is None:
            return tree
        return step.shard_params(encdec.EncDec(cfg, DEV, tree=tree), cfg,
                                 ctx)
    if ctx is None:
        return api.init_params(cfg, gen, device=DEV)
    return api.init_module(cfg, gen, DEV, ctx=ctx)


def family_prompts(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    """An LM's (B, S) prompt ids, or whisper's (B, WHISPER_FRAMES, d)
    unit-normal frames in the compute dtype."""
    if cfg.family == "encdec":
        gen = torch.Generator(DEV).manual_seed(seed)
        return whisper_frames(gen, cfg, b)
    return serve_prompts(cfg, b, s, seed)


def _family_batch(cfg, prompt: torch.Tensor) -> dict:
    return {"frames" if cfg.family == "encdec" else "tokens": prompt}


def family_lengths(cfg, prompt: torch.Tensor) -> tuple[int, int | None]:
    """(the position of the first decode step, the cross caches' whole
    length): an LM's prompt length and None; whisper's 1 (its prefill
    step decoded token 0 at position 0) and its frames."""
    if cfg.family == "encdec":
        return 1, prompt.shape[1]
    return prompt.shape[1], None


@contextlib.contextmanager
def keeping_family_hidden(cfg, seen: dict):
    """``keeping_hidden`` for any family: an LM's through
    ``transformer``; whisper's through ``encdec.decode_step``, whose
    first call in a prefill step (position 0) is its h (B, 1, d) and whose
    later calls are the decode steps'."""
    if cfg.family != "encdec":
        with keeping_hidden(seen):
            yield seen
        return
    real = encdec.decode_step

    def decode_step(*args, **kwargs):
        h, got = real(*args, **kwargs)
        if "prefill" not in seen:
            seen["prefill"] = h
        else:
            seen["decode"].append(h[:, 0])
        return h, got

    encdec.decode_step = decode_step
    try:
        yield seen
    finally:
        encdec.decode_step = real


@torch.no_grad()
def serve_reference(cfg, params, prompt: torch.Tensor, n_dec: int,
                    max_len: int, caches: bool = False) -> dict:
    """The unsharded engine's run that phases 27's and 28's ranks are held
    against, on the host: prefill of ``prompt`` (``make_prefill_step``'s
    token, the last position's h; whisper's step from token 0 over its
    frames), then ``n_dec`` greedy steps, each step's fed token, h (B, d)
    in fp32 and the top-(k + 1) ids and logits of its h (the next fed
    token is its top-1: the greedy token, ties to the lowest id); with
    ``caches`` also prefill's whole h and the caches after the prefill
    and after the last step; in bf16 with experts its MoE routing
    (``FamilyRoutes``).  The h are the engine's own steps'
    (``keeping_family_hidden``)."""
    b = prompt.shape[0]
    s, frames = family_lengths(cfg, prompt)
    head = api.head_table(params, cfg)
    k = MESH_SERVE_TOPK + 1
    seen: dict = {"decode": []}
    routes = FamilyRoutes()

    def record():
        return routes.recording() if cfg.n_experts and \
            cfg.dtype == "bfloat16" else contextlib.nullcontext()

    with keeping_family_hidden(cfg, seen), record():
        decode = engine.make_decode_step(cfg, None, max_len)
        tok, cache = engine.make_prefill_step(cfg, None, max_len)(
            params, _family_batch(cfg, prompt))
    h = seen["prefill"]
    out = {"prompts": prompt.cpu(), "prefill_tok": tok.cpu(),
           "prefill_top": _host(retrieval.dense_topk(
               head, h[:, -1], k, n_valid=cfg.vocab_size)),
           "prefill_h_last": h[:, -1].float().cpu(), "fed": [], "h": [],
           "top": []}
    if caches:
        out["prefill_h"] = h.float().cpu()
        out["prefill_caches"] = _host(cache)
    del h
    fed = tok
    with keeping_family_hidden(cfg, seen), record():
        for i in range(n_dec):
            pos = torch.full((b,), s + i, dtype=torch.long, device=DEV)
            _, cache = decode(params, fed[:, None].long(), cache, pos)
            hi = seen["decode"][-1]
            ids, logits = retrieval.dense_topk(head, hi, k,
                                               n_valid=cfg.vocab_size)
            out["fed"].append(fed.cpu())
            out["h"].append(hi.float().cpu())
            out["top"].append((ids.cpu(), logits.cpu()))
            fed = ids[:, 0]
    if caches:
        out["decode_caches"] = _host(cache)
    out["routes"] = routes.calls
    return out


def mesh_family_serve_references() -> dict:
    """28b's and 28c's unsharded references, saved for the ranks: each
    (config, depth, dtype, ``family_ref_variant``) of
    MESH_FAMILY_SERVE_RUNS drawn whole from MESH_FAMILY_SERVE_SEED on the
    card, its ``serve_reference`` run (28b's with the caches),
    then freed.  Returns each reference's seconds."""
    MESH_FAMILY_SERVE_DIR.mkdir(parents=True, exist_ok=True)
    secs = {}
    done = set()
    for part, name, mesh, n_layers, dtype in MESH_FAMILY_SERVE_RUNS:
        path = family_ref_path(part, name, mesh)
        if path in done:
            continue
        done.add(path)
        t0 = time.perf_counter()
        pad, div = family_ref_variant(name, mesh)
        cfg = family_serve_cfg(name, n_layers, dtype, div)
        params = family_params(cfg, MESH_FAMILY_SERVE_SEED, tp=pad)
        b, s, n_dec, max_len = (FAMILY_SERVE_PARITY if part == "28b"
                                else FAMILY_SERVE_BF16)
        ref = serve_reference(
            cfg, params, family_prompts(cfg, b, s, MESH_FAMILY_SERVE_SEED),
            n_dec, max_len, caches=part == "28b")
        torch.save(ref, path)
        del params, ref
        sync()
        if DEV.type == "cuda":
            torch.cuda.empty_cache()
        secs[path.stem] = round(time.perf_counter() - t0, 1)
    log(f"[mesh family serving] unsharded references saved for the ranks, "
        f"seconds {secs}")
    return secs


def serve_steps(cfg, ctx, params, prompt, n_dec: int, max_len: int
                ) -> dict[str, torch.Tensor]:
    """27a's and 28a's run of the engine: prefill (h and token), ``n_dec``
    decode steps on their own tokens (h and token each), a top-k step;
    the h are the engine's own steps' (``keeping_family_hidden``)."""
    b = prompt.shape[0]
    s, frames = family_lengths(cfg, prompt)
    seen: dict = {"decode": []}
    with keeping_family_hidden(cfg, seen):
        prefill = engine.make_prefill_step(cfg, ctx, max_len)
        decode = engine.make_decode_step(cfg, ctx, max_len, frames=frames)
        tok, caches = prefill(params, _family_batch(cfg, prompt))
        out = {"prefill h": seen["prefill"], "prefill tok": tok}
        for i in range(n_dec):
            pos = torch.full((b,), s + i, dtype=torch.long, device=DEV)
            last = tok[:, None].long()
            tok, caches = decode(params, last, caches, pos)
            out[f"decode {i} h"] = seen["decode"][-1]
            out[f"decode {i} tok"] = tok
    ids, logits, _ = engine.make_topk_step(
        cfg, ctx, MESH_SERVE_TOPK, max_len=max_len, frames=frames)(
        params, last, caches, pos)
    out["topk ids"], out["topk logits"] = ids, logits
    return out


@torch.no_grad()
def mesh_family_serve_nccl() -> dict:
    """Phase 28a: NCCL on a (1, 1) mesh in this process, each of
    FAMILY_SERVE_NCCL's configs at full width and its depth in bf16 under
    ``ctx_for_serve``: prefill h and token, each decode step's h and token
    (on its own tokens) and a top-10 step's ids and logits bitwise the
    unsharded engine's on the same weights (the model drawn into its (1,
    1) shards, which are whole)."""
    backend = "nccl" if DEV.type == "cuda" else "gloo"
    launch_mesh.init_distributed(
        backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1)
    depths, b, s, n_dec = FAMILY_SERVE_NCCL
    out = {}
    try:
        mesh = launch_mesh.make_debug_mesh(1, 1)
        for name, depth in depths.items():
            t0 = time.perf_counter()
            cfg = family_serve_cfg(name, depth, "bfloat16")
            sctx = rules.ctx_for_serve(mesh, cfg)
            prompt = family_prompts(cfg, b, s, MESH_FAMILY_SERVE_SEED)
            max_len = s + n_dec if cfg.family != "encdec" else n_dec + 1
            got = {}
            for tag, ctx in (("mesh", sctx), ("unsharded", None)):
                params = family_params(cfg, MESH_FAMILY_SERVE_SEED, ctx)
                got[tag] = serve_steps(cfg, ctx, params, prompt,
                                              n_dec, max_len)
                del params
                sync()
                if DEV.type == "cuda":
                    torch.cuda.empty_cache()
            diff = [k for k in got["mesh"]
                    if not torch.equal(got["mesh"][k], got["unsharded"][k])]
            log(f"[mesh family serving] {backend} (1, 1) {name} at {depth} "
                f"layers{' each' if cfg.family == 'encdec' else ''} (bf16, "
                f"{b} {'clips' if cfg.family == 'encdec' else 'prompts'} of "
                f"{prompt.shape[1]}, {n_dec} steps, top-{MESH_SERVE_TOPK}): "
                f"{len(got['mesh']) - len(diff)} of {len(got['mesh'])} "
                f"tensors bitwise the unsharded engine's, "
                f"{time.perf_counter() - t0:.1f} s")
            if diff:
                raise AssertionError(f"28a {name}: {diff} differ from the "
                                     "unsharded engine's")
            out[name] = len(got["mesh"])
        return out
    finally:
        torch.distributed.destroy_process_group()
        if DEV.type == "cuda":
            torch.cuda.empty_cache()


def _serve_cache_errs(got, want, cfg, sctx, batch: int, max_len: int,
                       frames: int | None, tag: str) -> dict[str, float]:
    """Each cache leaf gathered whole from the ranks
    (``convert.caches_to_jax``: K/V, latent rows, mamba's window and
    state, whisper's self and cross K/V) against the unsharded one: max
    |diff| over its own max."""
    whole = convert.caches_to_jax(got, cfg, sctx, batch=batch,
                                  max_len=max_len, frames=frames)
    out = {}

    def walk(g, w, key):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{key} {k}")
        elif isinstance(w, (list, tuple)):
            for i, (gi, wi) in enumerate(zip(g, w)):
                walk(gi, wi, f"{key} {i}")
        else:
            wt = w.float()
            out[key] = float((torch.from_numpy(np.asarray(g)).float() - wt)
                             .abs().max() / wt.abs().max())

    walk(whole, want, f"{tag} cache")
    return out


def family_attn_shape(cfg, ctx, part: str) -> dict:
    """The shard shape of a run's prefill attention on a rank: its rows
    of the prompts (``serve_rows``), its heads (q / kv over tp), the
    widths (MLA's 192 / 128), the key length (whisper's encoder: the
    frames, not causal)."""
    b, s = (FAMILY_SERVE_PARITY if part == "28b" else FAMILY_SERVE_BF16)[:2]
    b = b // ctx.dp if b % ctx.dp == 0 else b
    if cfg.family == "encdec":
        h = cfg.n_heads // ctx.tp
        return dict(b=b, s=WHISPER_FRAMES, h=h, kv=h,
                    hd=cfg.resolved_head_dim, hv=cfg.resolved_head_dim,
                    causal=False)
    if cfg.mla:
        h = cfg.n_heads // ctx.tp
        return dict(b=b, s=s, h=h, kv=h, hd=cfg.qk_nope_dim + cfg.qk_rope_dim,
                    hv=cfg.v_head_dim, causal=True)
    nh, nkv = layers.padded_heads(cfg, ctx.tp)
    return dict(b=b, s=s, h=nh // ctx.tp, kv=nkv // ctx.tp,
                hd=cfg.resolved_head_dim, hv=cfg.resolved_head_dim,
                causal=True)


def family_flash_row(gen: torch.Generator, dtype: torch.dtype, b: int,
                     s: int, h: int, kv: int, hd: int, hv: int,
                     causal: bool) -> dict:
    """``flash_attention`` at a shard shape: bf16 must take the
    tensor-core entry point, fp32 the CUDA-core one
    (``flash_attention_simt``); held against the plain version
    (BF16_ELEM_RTOL element by element in bf16, RTOL in fp32), timed
    beside it and SDPA (its backend named), with its bound."""
    q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype, hv)
    tc = dtype == torch.bfloat16
    entry = "flash_attention" if tc else "flash_attention_simt"
    before = kernels.launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    after = kernels.launch_counts()
    took = {n: after[n] - before[n]
            for n in ("flash_attention", "flash_attention_simt")}
    if took != {n: int(n == entry) for n in took}:
        raise AssertionError(f"flash (B {b}, S {s}, H {h}, KV {kv}, hd "
                             f"{hd}, hv {hv}) {dtype} took {took}, not "
                             f"{entry}")
    tag = (f"{entry} {dtype} causal={causal} (B {b}, S {s}, H {h}, KV {kv},"
           f" hd {hd}, hv {hv})")

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=causal)

    err = compare(tag, got, plain(), elem_rtol=BF16_ELEM_RTOL if tc else 0.0)
    bms, by, floor = flash_bound(b, s, h, kv, hd, causal, dtype, hv)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = dict(max_abs_err=err, bound_ms=bms, bound_by=by,
               library=f"SDPA {sdpa_backend(qt, kt, vt, causal)}",
               shape=[b, s, h, kv, hd, hv], **times(
                   lambda: flash_attention(q, k, v, causal=causal), plain,
                   lambda: sdpa(qt, kt, vt, is_causal=causal,
                                enable_gqa=kv != h)))
    if not tc:
        row["cuda_core_floor_ms"] = floor
    log(f"  {tag}: {json.dumps(row)}")
    del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()
    return row


def mesh_family_serve_kernels(ctx, cfg, part: str, index, h: torch.Tensor
                              ) -> dict:
    """The attention kernel entry of the run's prefill at this rank's
    shard shape (``family_attn_shape``; 28b's fp32 through
    flash_attention_simt, 28c's bf16 through flash_attention), and, with
    the rank's index, zstats at its blocks and leaf_scores at its full
    beam (``index_kernel_rows``); each against its plain version and
    timed."""
    gen = torch.Generator(DEV).manual_seed(MESH_FAMILY_SERVE_SEED)
    dtype = layers._dtype(cfg)
    entry = "flash_attention" if dtype == torch.bfloat16 else \
        "flash_attention_simt"
    rows = {entry: family_flash_row(gen, dtype, **family_attn_shape(
        cfg, ctx, part))}
    if index is not None:
        tag = f"{cfg.name} shard ({ctx.axis_size('data')}, {ctx.tp})"
        got = index_kernel_rows(index, h, tag)
        got["zstats"]["shape"] = list(index.wq.shape)
        got["leaf_scores"]["shape"] = [h.shape[0] * index.wq.shape[0],
                                       *index.wq.shape[1:]]
        rows.update(got)
    return rows


def family_prefill_launches(cfg) -> int:
    """flash_attention's launches in a prefill: once an attention layer
    (whisper: once an encoder layer; its decoder's first step decodes)."""
    return cfg.n_enc_layers if cfg.family == "encdec" else attn_layers(cfg)


def mesh_family_serve_run(ctx, part: str, name: str, n_layers: int,
                          dtype: str, tag: str
                          ) -> tuple[dict, object, torch.Tensor]:
    """One phase 28 run on this rank (``mesh_serve_run`` for the moe,
    hybrid, MLA and encoder-decoder configs): the config drawn into the
    rank's shards under ``ctx_for_serve`` (tp, or tp_fsdp where
    ``serve_fsdp``), and the counted main path through the engine: (28c)
    the sharded ``RetrievalIndex`` of the rank's head shard, the prefill
    of its rows of the reference's prompts or clips, the decode steps fed
    the unsharded engine's tokens (the last one's collectives against
    ``predict_serve_collectives``), a dense top-k step and (28c) a
    full-beam index top-k step: exact launches (zstats once,
    flash_attention once an attention layer of the prefill (whisper's
    encoder layers), leaf_scores once; 28b's fp32 attention through
    flash_attention_simt).  Then, outside the count, the checks of
    ``mesh_serve_run``: prefill's and each decode step's h (28b within
    MESH_RTOL of each tensor's max, with every cache gathered whole after
    the prefill and after the last step; 28c within DECODE_RTOL and
    ``decode_rel_rms``), the tokens, the dense top-k and the full beam.
    Returns (the numbers, the index, the last step's h)."""
    dp, tp = ctx.axis_size("data"), ctx.tp
    cfg = family_serve_cfg(name, n_layers, dtype)
    sctx = rules.ctx_for_serve(ctx.mesh, cfg)
    fp32, k = dtype == "float32", MESH_SERVE_TOPK
    ref = torch.load(family_ref_path(part, name, (dp, tp)))
    b, s, n_dec, max_len = (FAMILY_SERVE_PARITY if part == "28b"
                            else FAMILY_SERVE_BF16)
    sync()
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    draw = ranks_draw_in_turn() if name in FAMILY_DRAW_IN_TURN \
        else contextlib.nullcontext()
    with draw:
        model = family_params(cfg, MESH_FAMILY_SERVE_SEED, sctx)
    sync()
    secs = {"draw": time.perf_counter() - t0}
    rows = rules.serve_rows(torch.arange(b), sctx)
    prompt = ref["prompts"][rows].to(DEV)
    s, frames = family_lengths(cfg, prompt)
    fed = [f[rows].to(DEV) for f in ref["fed"]]
    b_l = prompt.shape[0]
    seen: dict = {"decode": []}
    with keeping_family_hidden(cfg, seen):
        prefill = engine.make_prefill_step(cfg, sctx, max_len, batch=b)
        decode = engine.make_decode_step(cfg, sctx, max_len, frames=frames,
                                         batch=b)
    routes = FamilyRoutes(ref["routes"])
    impose = routes.imposing() if routes.calls else contextlib.nullcontext()
    n_moe = sum(kind.endswith("+moe") for kind in cfg.layer_kinds()) \
        if cfg.family != "encdec" else 0

    # -- the counted main path ---------------------------------------------
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    head = api.head_table(model, cfg, sctx)
    index = None
    if part == "28c":
        index = retrieval.build_index(head, sctx, vocab_size=cfg.vocab_size)
        sync()
        secs["index"] = time.perf_counter() - t0
    with impose:
        t0 = time.perf_counter()
        with keeping_family_hidden(cfg, seen):
            tok0, caches = prefill(model, _family_batch(cfg, prompt))
        sync()
        secs["prefill"] = time.perf_counter() - t0
        pre_caches = _host(caches) if fp32 else None
        toks, before, collectives = [], caches, {}
        t0 = time.perf_counter()
        with keeping_family_hidden(cfg, seen):
            for i in range(n_dec):
                pos = torch.full((b_l,), s + i, dtype=torch.long, device=DEV)
                if i == n_dec - 1:
                    sync()
                    distributed.reset_collective_counts()
                    before = caches  # a mamba step returns new states
                nxt, caches = decode(model, fed[i][:, None].long(), caches,
                                     pos)
                if i == n_dec - 1:
                    sync()
                    collectives = distributed.collective_counts(by_group=True)
                toks.append(nxt)
        sync()
        secs["decode"] = time.perf_counter() - t0
        last = fed[n_dec - 1][:, None].long()
        # each top-k step runs the last decode step again: its routes again
        routes.at = len(routes.calls) - n_moe
        dids, dlog, _ = engine.make_topk_step(
            cfg, sctx, k + 1, max_len=max_len, frames=frames, batch=b)(
            model, last, before, pos)
        ids = logits = None
        if index is not None:
            routes.at = len(routes.calls) - n_moe
            ids, logits, _ = engine.make_topk_step(
                cfg, sctx, k, index=index, max_len=max_len, frames=frames,
                batch=b)(model, last, before, pos)
        sync()
    counts = kernels.launch_counts()
    want = dict.fromkeys(REPLACES, 0)
    if DEV.type == "cuda":
        want["flash_attention_simt" if fp32 else "flash_attention"] = \
            family_prefill_launches(cfg)
        if index is not None:
            want.update(zstats=1, leaf_scores=1)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    split = tp > 1 and rules.seq_shards(sctx, max_len) > 1
    cross = tp > 1 and frames is not None and \
        rules.seq_shards(sctx, frames) > 1
    predicted = predict_serve_collectives(cfg, sctx, b_l, split, model=model,
                                          cross_split=cross, batch=b)
    if collectives != predicted:
        raise AssertionError(f"{tag}: a decode step's collectives "
                             f"{collectives} != the prediction "
                             f"{predicted}")

    # -- checks outside the count --------------------------------------------
    errs, rms, swaps, logit_err = {}, {}, 0, 0.0
    h_pre = seen["prefill"]
    if fp32:
        errs["prefill h"] = rel_err(h_pre, ref["prefill_h"][rows].to(DEV))
        errs.update(_serve_cache_errs(pre_caches, ref["prefill_caches"],
                                       cfg, sctx, b, max_len, frames,
                                       "prefill"))
    ref_h = ref["prefill_h_last"][rows].to(DEV)
    errs["prefill h last"] = rel_err(h_pre[:, -1], ref_h)
    rms["prefill"] = float(_rel_rms(h_pre[:, -1].float(), ref_h))
    got_swaps, got_err = _tokens_gate(
        f"{tag} prefill token", tok0, [t[rows] for t in ref["prefill_top"]],
        h_pre[:, -1], ref_h, head, sctx, fp32)
    swaps, logit_err = swaps + got_swaps, max(logit_err, got_err)
    del h_pre
    for i, h in enumerate(seen["decode"]):
        ref_h = ref["h"][i][rows].to(DEV)
        errs[f"decode {i} h"] = rel_err(h, ref_h)
        rms[f"decode {i}"] = float(_rel_rms(h.float(), ref_h))
        got_swaps, got_err = _tokens_gate(
            f"{tag} decode {i} token", toks[i],
            [t[rows] for t in ref["top"][i]], h, ref_h, head, sctx, fp32)
        swaps, logit_err = swaps + got_swaps, max(logit_err, got_err)
    if fp32:
        # the top-k steps wrote the same K/V at pos again
        errs.update(_serve_cache_errs(caches, ref["decode_caches"], cfg,
                                       sctx, b, max_len, frames, "decode"))
        gate(f"{tag} fp32 parity", errs, MESH_RTOL)
    else:
        gate(f"{tag} h", errs, DECODE_RTOL)
        gate(f"{tag} h relative RMS", rms, decode_rel_rms(cfg))
    rid, rlog = (t[rows].to(DEV) for t in ref["top"][n_dec - 1])
    if fp32:
        topk_swaps = check_topk_ties(f"{tag} dense top-{k}", dids[:, :k],
                                     rid, rlog, k)
    else:
        topk_swaps = check_topk_near(
            f"{tag} dense top-{k}", dids[:, :k], rid, rlog, k,
            _logit_err(h, ref_h, rid, head, sctx))
    out = {"secs": secs, "launches": counts, "collectives": collectives,
           "b_l": b_l, "seq_split": split, "cross_split": cross,
           "mode": sctx.mode, "errs": errs, "rel_rms": rms,
           "token_swaps": swaps, "logit_err": logit_err,
           "topk_swaps": topk_swaps,
           "route_flips": (routes.flips, routes.routed),
           "params": sum(p.numel() for p in model.parameters())}
    if index is not None:
        if not torch.allclose(logits, dlog[:, :k], rtol=1e-5, atol=0.0):
            raise AssertionError(f"{tag}: the full-beam logits differ from "
                                 "the dense top-k's")
        out["index_swaps"] = check_topk_ties(f"{tag} full beam", ids, dids,
                                             dlog, k)
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if DEV.type == "cuda" else 0.0)
    out["secs"] = {key: round(v, 3) for key, v in secs.items()}
    del model
    return out, index, h


def mesh_family_serve_rank(ctx, part: str, name: str, n_layers: int,
                           dtype: str) -> dict:
    """One phase 28 run on this rank (``mesh_family_serve_run``), then, on
    the world's rank 0 while the others wait, every kernel entry the run
    launched at its shard shapes (``mesh_family_serve_kernels``)."""
    dp, tp = ctx.axis_size("data"), ctx.tp
    tag = f"{part} {name} ({dp}, {tp}) {dtype} rank ({ctx.data_index}, " \
          f"{ctx.model_index})"
    t0 = time.perf_counter()
    out, index, h = mesh_family_serve_run(ctx, part, name, n_layers, dtype,
                                          tag)
    t1 = time.perf_counter()
    torch.distributed.barrier()
    cfg = family_serve_cfg(name, n_layers, dtype)
    if torch.distributed.get_rank() == 0:
        out["kernels"] = mesh_family_serve_kernels(ctx, cfg, part, index, h)
    torch.distributed.barrier()
    del index, h
    sync()
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
    out["secs"]["kernels"] = round(time.perf_counter() - t1, 1)
    out["s"] = time.perf_counter() - t0
    log(f"{tag}: seconds {out['secs']}")
    return out


def mesh_family_serve_report(ranks: list[dict], nccl: dict, ref_s: dict
                             ) -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 28's rank results logged: each run's launches summed over its
    ranks (``launches_by_path`` "mesh serving <config> (dp, tp) <dtype>"),
    and rank 0's kernel rows as kernels-line shapes
    ``mesh_family_serving_<config>_<dp>x<tp>`` (28c) and
    ``mesh_family_serving_fp32_<config>_<dp>x<tp>`` (28b)."""
    by_path, shapes = {}, {}
    for part, name, (dp, tp), n_layers, dtype in MESH_FAMILY_SERVE_RUNS:
        key = f"{part} {name} {dp}x{tp}"
        total = dict.fromkeys(REPLACES, 0)
        for r, res in enumerate(ranks):
            m = res[key]
            worst = max(m["errs"], key=m["errs"].get)
            log(f"[mesh family serving] gloo {key} {dtype} {m['mode']} rank "
                f"{r} ({n_layers} layers, {m['params']} parameters a rank, "
                f"{m['b_l']} rows, the cache's sequence "
                f"{'split' if m['seq_split'] else 'whole'}"
                + (f", the cross caches' "
                   f"{'split' if m['cross_split'] else 'whole'}"
                   if name == "whisper-large-v3" else "")
                + f"): worst h / cache error {worst} {m['errs'][worst]} "
                f"over its max, relative RMS {max(m['rel_rms'].values())}, "
                f"token swaps {m['token_swaps']} (logit error "
                f"{m['logit_err']} of the top logit), top-{MESH_SERVE_TOPK} "
                f"swaps {m['topk_swaps']}"
                + (f", full beam = dense but {m['index_swaps']} ties"
                   if "index_swaps" in m else "")
                + (f", the unsharded routing imposed (its own top-k "
                   f"differed in {m['route_flips'][0]} of "
                   f"{m['route_flips'][1]} routed tokens)"
                   if m["route_flips"][1] else "")
                + f"; launches "
                f"{({k: v for k, v in m['launches'].items() if v})}, a "
                f"decode step's collectives {m['collectives']} (= the "
                f"prediction), seconds {m['secs']}, prefill "
                f"{m['secs']['prefill'] * 1e3:.1f} ms, decode "
                f"{m['secs']['decode'] / FAMILY_SERVE_STEPS[part] * 1e3:.1f}"
                f" ms a token, peak {m['peak_gb']:.3f} GB")
            add_counts(total, m["launches"])
        kern = ranks[0][key].get("kernels")
        fp32 = "fp32_" if dtype == "float32" else ""
        shapes[f"mesh_family_serving_{fp32}{name}_{dp}x{tp}"] = kern
        log(f"[mesh family serving] {key}: kernels at the shard shapes "
            f"{kern}")
        by_path[f"mesh serving {name} ({dp}, {tp}) {dtype}"] = total
    secs = [round(sum(r[f"{p} {n} {dp}x{tp}"]["s"]
                      for p, n, (dp, tp), _, _ in MESH_FAMILY_SERVE_RUNS), 1)
            for r in ranks]
    log(f"[mesh family serving] NCCL (1, 1) {nccl}; the unsharded "
        f"references {ref_s} s; the ranks' phase 28 {secs} s")
    return by_path, shapes


def phase_mesh_layouts(phases: tuple[str, ...] = ("24", "25", "26", "27",
                                                 "28")
                       ) -> tuple[dict[str, dict[str, int]], dict]:
    """Phases 24 and 25, the backbone's storage layouts on the mesh, in
    one set of rank processes.  Phase 24 (starcoder2-3b at full width, 4
    of its 30 layers: d 3,072, 24 / 2 heads of 128, d_ff 12,288, vocab
    49,152): 24a over NCCL in this process (``mesh_dense_nccl``) and the
    unsharded fp32 parity steps saved for the ranks
    (``mesh_dense_reference``).  Phase 25 (falcon-mamba-7b at 2 of its 64
    layers, whisper-large-v3 at 2 + 2 of its 32 + 32, ptb-lstm whole, each
    at full width): 25a over NCCL in this process
    (``mesh_family_nccl``).  Then MESH_WORLD rank processes over gloo
    sharing the card run each of MESH_DENSE_RUNS (``mesh_dense_rank``:
    tp_fsdp at (1, 4) (KV heads padded 2 -> 4) and (2, 2), pure_fsdp at
    (2, 2)) and each of MESH_FAMILY_RUNS (``mesh_family_rank``).  Phase 26
    (expert parallelism and the S-sharded residual stream: dbrx-132b at
    full width, 2 of its 40 layers at (1, 4) and 1 at (2, 2);
    deepseek-v3-671b's 3 dense MLA layers and mtp block and
    jamba-v0.1-52b's first 5 layers at (1, 4)): 26a over NCCL in this
    process (``mesh_expert_nccl``) and the unsharded fp32 parity step
    saved for the ranks (``mesh_expert_reference``), then each of
    MESH_EXPERT_RUNS on the ranks after phase 25's (``mesh_expert_rank``).
    Phase 27 (the decoder LMs' serving engine under ``ctx_for_serve``):
    27a over NCCL in this process (``mesh_serve_nccl``) and the unsharded
    references saved for the ranks (``mesh_serve_references``; 27c's from
    phase 11's run), then each of MESH_SERVE_RUNS on the ranks after phase
    26's (``mesh_serve_rank``).  Phase 28 (the rest of serving: the
    moe, hybrid, MLA and encoder-decoder configs under ``ctx_for_serve``):
    28a over NCCL in this process (``mesh_family_serve_nccl``) and the
    unsharded references saved for the ranks
    (``mesh_family_serve_references``), then each of
    MESH_FAMILY_SERVE_RUNS on the ranks after phase 27's
    (``mesh_family_serve_rank``).  ``phases`` runs some of the five
    alone.
    Returns the bf16 fits' launches of each mesh, summed over its ranks,
    and the kernels' rows at the shard shapes."""
    t_start = time.perf_counter()
    t24 = t25 = t26 = t27 = t28 = 0.0
    if "24" in phases:
        nccl24 = mesh_dense_nccl()
        ref_s = mesh_dense_reference()
        t24 = time.perf_counter() - t_start
    if "25" in phases:
        t0 = time.perf_counter()
        nccl25 = mesh_family_nccl()
        t25 = time.perf_counter() - t0
    try:
        if "26" in phases:
            t0 = time.perf_counter()
            nccl26 = mesh_expert_nccl()
            ref26 = mesh_expert_reference()
            t26 = time.perf_counter() - t0
            if DEV.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
                log(f"[mesh experts] this process holds "
                    f"{torch.cuda.memory_allocated() / 1e9:.3f} GB "
                    f"({torch.cuda.memory_reserved() / 1e9:.3f} GB "
                    "reserved) as the ranks start")
        if "27" in phases:
            t0 = time.perf_counter()
            nccl27 = mesh_serve_nccl()
            ref27 = mesh_serve_references()
            t27 = time.perf_counter() - t0
        if "28" in phases:
            t0 = time.perf_counter()
            nccl28 = mesh_family_serve_nccl()
            ref28 = mesh_family_serve_references()
            t28 = time.perf_counter() - t0
        ranks = run_mesh_ranks(",".join(phases), MESH_LAYOUTS_TIMEOUT_S)
    finally:
        shutil.rmtree(MESH_DENSE_DIR, ignore_errors=True)
        shutil.rmtree(MESH_EXPERT_DIR, ignore_errors=True)
        shutil.rmtree(MESH_SERVE_DIR, ignore_errors=True)
        shutil.rmtree(MESH_FAMILY_SERVE_DIR, ignore_errors=True)
    by_path, shapes = {}, {}
    for ph, report in (("24", lambda: mesh_dense_report(ranks, nccl24,
                                                        ref_s)),
                       ("25", lambda: mesh_family_report(ranks, nccl25)),
                       ("26", lambda: mesh_expert_report(ranks, nccl26,
                                                         ref26)),
                       ("27", lambda: mesh_serve_report(ranks, nccl27,
                                                        ref27)),
                       ("28", lambda: mesh_family_serve_report(
                           ranks, nccl28, ref28))):
        if ph in phases:
            got_paths, got_shapes = report()
            by_path.update(got_paths)
            shapes.update(got_shapes)
    log(f"[mesh layouts] in this process: phase 24 {t24:.1f} s, phase 25 "
        f"{t25:.1f} s, phase 26 {t26:.1f} s, phase 27 {t27:.1f} s, phase 28 "
        f"{t28:.1f} s; phases 24 to 28 "
        f"{time.perf_counter() - t_start:.1f} s; each rank's peak memory "
        f"since its last fit began, GB "
        f"{[round(r.get('peak_gb', 0.0), 3) for r in ranks]}")
    return by_path, shapes


def kernels_line(rows: dict[str, dict], shapes: dict[str, dict[str, dict]],
                 by_path: dict[str, dict[str, int]]) -> list[dict]:
    """The kernels line: every kernel's training-shape numbers, its
    launches summed over the training paths and per path, and its numbers
    at the other shapes it was held at, each key prefixed by the shape's
    tag (``serving_ms``, ``tree_levels_ms``, ...)."""
    root = Path(__file__).resolve().parent
    line = []
    for name in REPLACES:
        launches = {path: c[name] for path, c in by_path.items()}
        entry = dict(name=name, route="cuda",
                     source=str(_build.source(name).relative_to(root)),
                     replaces=REPLACES[name],
                     launches=sum(n for path, n in launches.items()
                                  if path != "serving"),
                     launches_by_path=launches, **rows[name])
        for tag, tagged in shapes.items():
            if name in tagged:
                entry.update({f"{tag}_{k}": v
                              for k, v in tagged[name].items()})
        line.append(entry)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fresh", action="store_true",
                    help="also train on fresh batches with the sampled and "
                         "the full-softmax loss (phase 6b)")
    # phase 23's rank processes: the parent starts this script with these
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-addr", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-phase", default="23", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        global DEV
        DEV = torch.device(args.mesh_device)
        return mesh_rank(args.mesh_rank, MESH_WORLD, args.mesh_addr,
                         MESH_DIR, args.mesh_phase)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def lap(stage: str) -> None:
        log(f"[time] {stage} done at {time.perf_counter() - t_start:.1f} s")

    smi = phase_device()
    phase_build()
    lap("device and build (phases 1-2)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    serving_rows = phase_kernels(gen)
    lap("phase 3 at the serving shapes")
    cfg = get_config("youtube-dnn")
    rows, fused_shapes = phase_kernels_training(gen, cfg)
    lap("phase 3 at the training shapes")
    llama_rows, llama_shapes = phase_kernels_llama(gen)
    rows.update(llama_rows)
    lap("phase 10")
    # its own generator: the other phases draw the inputs they drew
    # before phase 18 existed
    bwd_rows, bwd_shapes = phase_flash_bwd(
        torch.Generator(device="cuda").manual_seed(18))
    rows.update(bwd_rows)
    llama_shapes.update(bwd_shapes)
    lap("phase 18a")
    llama_shapes.update(phase_flash_mla(
        torch.Generator(device="cuda").manual_seed(21)))
    lap("phase 21a")
    llama_shapes.update(phase_flash_whisper(
        torch.Generator(device="cuda").manual_seed(22)))
    lap("kernel checks (phases 3, 10, 18a, 21a, 22a)")
    timing_report("kernel checks")

    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = api.init_params(cfg, gen, device="cuda")
    head = api.head_table(model, cfg).detach()
    torch.cuda.synchronize()
    log(f"[serving] youtube-dnn: {cfg.vocab_size} items, head "
        f"{tuple(head.shape)}, init {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    index = retrieval.build_index(head)
    torch.cuda.synchronize()
    log(f"[serving] index build {time.perf_counter() - t0:.3f} s: leaf "
        f"{index.leaf_size}, {index.num_leaves_shard} leaves, payload_bytes "
        f"{payload_bytes(index)}; launches {kernels.launch_counts()}")
    phase_serving(cfg, model, head, index, rng)
    phase_exact(cfg, model, head, index, rng)
    serving_counts = kernels.launch_counts()
    missing = [k for k in SERVING_KERNELS if serving_counts[k] == 0]
    if missing:
        raise AssertionError(f"serving path never launched {missing}")
    lap("serving (phases 4-5)")

    counts, state, skewed_rows = phase_training(cfg)
    if args.fresh:
        phase_fresh(cfg)
    phase_training_breakdown(cfg, state)
    phase_profile(cfg, state)
    phase_breakdown(cfg, model, head, index, rng)
    del state, model, index
    torch.cuda.empty_cache()
    lap("block-quadratic training (phases 6-7)")

    hier_rows, shapes = phase_kernels_hier(gen, cfg)
    rows.update(hier_rows)
    shapes["serving"] = serving_rows
    shapes.update(fused_shapes)
    shapes["skewed"] = skewed_rows
    by_path = {"serving": serving_counts, "block-quadratic": counts}
    held = held_out_batch(cfg)
    data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=0, device=DEV)
    pool = [next(data) for _ in range(TRAIN_POOL)]
    for family in FAMILIES:
        fcfg = dataclasses.replace(cfg, sampler=family)
        by_path[family], fstate = phase_family(fcfg, pool, held)
        phase_family_breakdown(fcfg, fstate)
        del fstate
        torch.cuda.empty_cache()
    del pool, held, data
    torch.cuda.empty_cache()
    lap("hierarchical kernels and families (phases 8-9)")

    by_path["ptb-lstm"], shapes["ptb"] = phase_ptb(gen)
    torch.cuda.empty_cache()
    lap("ptb-lstm (phase 9b)")

    by_path["facade"] = phase_facade(cfg)
    phase_sparse(cfg)
    lap("facade and sparse refresh (phases 13-14)")
    by_path["checkpoint"] = phase_checkpoint(cfg)
    lap("checkpoint (phase 15)")
    by_path.update(phase_overlap(cfg))
    torch.cuda.empty_cache()
    lap("overlap (phase 16)")
    by_path.update(phase_samplers(cfg, gen))
    torch.cuda.empty_cache()
    lap("samplers (phase 17)")
    by_path[DENSE_ARCH] = phase_dense()
    torch.cuda.empty_cache()
    lap("dense training -> quantized serving (phase 18)")

    shapes.update(llama_shapes)
    by_path["llama3-8b"], llama, shapes["llama_index"] = phase_llama_serving(
        torch.Generator(device="cuda").manual_seed(15), rng)
    by_path["sampled_loss entry"] = phase_sampled_loss_entry(gen, llama)
    del llama
    torch.cuda.empty_cache()
    lap("llama3-8b serving (phases 11-12)")
    hybrid_paths, shapes["falcon_index"] = phase_hybrid_serving(
        torch.Generator(device="cuda").manual_seed(19),
        np.random.default_rng(19))
    by_path.update(hybrid_paths)
    lap("MoE, SSM and hybrid serving (phase 19)")
    by_path.update(phase_hybrid_train())
    lap("MoE, SSM and hybrid training (phase 20)")
    by_path["deepseek-v3-671b"] = phase_deepseek_serving(
        torch.Generator(device="cuda").manual_seed(21),
        np.random.default_rng(21))
    lap("deepseek-v3-671b serving (phase 21b)")
    by_path.update(phase_deepseek_train())
    lap("deepseek-v3-671b training (phase 21c)")
    by_path["whisper-large-v3"] = phase_whisper_serving(
        torch.Generator(device="cuda").manual_seed(22))
    lap("whisper-large-v3 serving (phase 22b)")
    by_path.update(phase_whisper_train())
    lap("whisper-large-v3 training (phase 22c)")
    torch.cuda.empty_cache()
    by_path.update(phase_mesh())
    lap("the vocab-parallel head on a mesh (phase 23)")
    torch.cuda.empty_cache()
    layout_paths, layout_shapes = phase_mesh_layouts()
    by_path.update(layout_paths)
    shapes.update(layout_shapes)
    lap("the backbone's layouts, experts and serving on a mesh (phases "
        "24-28)")

    timing_report("phases 4-28")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels_line(rows, shapes, by_path)}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
